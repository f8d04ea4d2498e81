"""The port's four other model families and ``stem_s2d`` against the JAX
package.

A Flax init of each family (with non-trivial BatchNorm statistics and
biases) is carried into the port by ``state_dict_from_flax``; the same
seeded numpy input runs through both at small widths and 64x64, and the
eval logits must agree at rtol and atol 1e-4 (tests/test_torch_parity.py).
The Predictor test serves seeded frames through both packages' Predictors
on the same weights, as tests/test_torch_port_predictor.py does.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tests.torch_ref import TorchUNet
from tpuseg.configs import ModelConfig as JaxModelConfig
from tpuseg.data.augment import normalize_images as jax_normalize
from tpuseg.infer.predictor import Predictor as JaxPredictor
from tpuseg.models.registry import build_model as jax_build_model
from tpuseg.ops.resize import resize_bilinear as jax_resize
from tpuseg.ops.resize import up_pow2_bilinear as jax_up_pow2
from tpuseg_torch.configs import ModelConfig
from tpuseg_torch.core.weights import load_pth, state_dict_from_flax
from tpuseg_torch.infer.predictor import Predictor
from tpuseg_torch.models.registry import (MODEL_REGISTRY, build_model, size_divisor,
                                          validate_input_size)
from tpuseg_torch.ops import kernels
from tpuseg_torch.ops.resize import up_pow2_bilinear

RTOL = ATOL = 1e-4
HW = (64, 64)
FAMILIES = {
    "fpn": dict(name="mobilenetv2_fpn", width_mult=0.5, base_filters=16),
    "deeplab": dict(name="mobilenetv2_deeplab", width_mult=0.5, base_filters=16),
    "unet": dict(name="unet", base_filters=8),
    "light_unet": dict(name="light_unet", base_filters=8),
    "fpn-s2d": dict(name="mobilenetv2_fpn", width_mult=0.25, base_filters=8, stem_s2d=True),
    "deeplab-s2d": dict(name="mobilenetv2_deeplab", width_mult=0.25, base_filters=8,
                        stem_s2d=True),
    "unet-flagship-s2d": dict(name="mobilenetv2_unet", width_mult=0.25, stem_s2d=True,
                              up_subpixel=False),
}


def _flax_variables(kw: dict, seed: int):
    """Flax init + seeded non-trivial BN stats, BN affine and conv biases."""
    model = jax_build_model(JaxModelConfig(**kw))
    v = jax.jit(lambda k: model.init(k, jnp.zeros((1, *HW, 3)), train=False))(
        jax.random.PRNGKey(seed))
    rng = np.random.RandomState(seed)

    def perturb(path, a):
        name = jax.tree_util.keystr(path)
        lo, hi = ((0.5, 1.5) if ("var" in name or "scale" in name)
                  else (-0.2, 0.2) if ("mean" in name or "bias" in name)
                  else (None, None))
        a = np.asarray(a)
        return a if lo is None else rng.uniform(lo, hi, a.shape).astype(np.float32)

    return model, jax.tree_util.tree_map_with_path(perturb, {
        "params": v["params"], "batch_stats": v["batch_stats"]})


def _port(kw: dict, variables) -> torch.nn.Module:
    model = build_model(ModelConfig(**kw))
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    return model.eval()


def _logits(model, x_nhwc: np.ndarray) -> np.ndarray:
    with torch.no_grad():
        return model(torch.from_numpy(x_nhwc).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()


@pytest.fixture(scope="module")
def x_nhwc():
    return np.random.RandomState(0).rand(2, *HW, 3).astype(np.float32)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_eval_logits_match_flax(family, x_nhwc):
    kw = FAMILIES[family]
    fm, v = _flax_variables(kw, 1)
    want = np.asarray(jax.jit(lambda v, x: fm.apply(v, x, train=False))(
        v, jnp.asarray(x_nhwc)))
    got = _logits(_port(kw, v), x_nhwc)
    channels = 1 if kw["name"] == "light_unet" else 10
    assert got.shape == want.shape == (2, *HW, channels)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("family", ["fpn", "deeplab", "unet-flagship-s2d"])
def test_stem_s2d_equals_the_plain_stem_on_the_same_weights(family, x_nhwc):
    kw = dict(FAMILIES[family], stem_s2d=True)
    _, v = _flax_variables(kw, 2)
    s2d = _port(kw, v)
    plain = _port(dict(kw, stem_s2d=False), v)
    assert list(s2d.state_dict()) == list(plain.state_dict())
    np.testing.assert_allclose(_logits(s2d, x_nhwc), _logits(plain, x_nhwc),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("times", [1, 2, 3])
def test_up_pow2_bilinear_matches_jax(times):
    x = np.random.RandomState(times).randn(2, 5, 3, 4).astype(np.float32)
    got = up_pow2_bilinear(torch.from_numpy(x), times).numpy()
    want = np.asarray(jax_up_pow2(jnp.asarray(x), times))
    assert got.shape == (2, 5 << times, 3 << times, 4)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_reference_unet_pth_loads_through_load_pth(tmp_path):
    """A reference-named UNet state_dict (``inc``, ``downK.mpconv.1``,
    ``sem_out``): the duplicate-key rule leaves the ``mpconv`` keys alone,
    it loads strictly, and the logits equal the reference torch model's."""
    tm = TorchUNet(output_channels=10, base_filters=8)
    g = torch.Generator().manual_seed(0)
    for k, t in tm.state_dict().items():
        if k.endswith("running_var"):
            t.uniform_(0.5, 1.5, generator=g)
        elif t.dtype.is_floating_point:
            t.uniform_(-0.2, 0.2, generator=g)
    path = tmp_path / "unet.pth"
    torch.save(tm.state_dict(), path)
    sd = load_pth(str(path))
    assert sorted(sd) == sorted(tm.state_dict())
    assert any(k.startswith("down2.mpconv.1.conv.") for k in sd)
    model = build_model(ModelConfig(name="unet", base_filters=8))
    model.load_state_dict(sd, strict=True)
    x = torch.from_numpy(np.random.RandomState(1).rand(2, 3, 32, 48).astype(np.float32))
    with torch.no_grad():
        torch.testing.assert_close(model.eval()(x), tm.eval()(x), rtol=RTOL, atol=ATOL)


def test_registry_builds_every_family_at_full_width_with_the_jax_defaults():
    assert sorted(MODEL_REGISTRY) == ["light_unet", "mobilenetv2_deeplab", "mobilenetv2_fpn",
                                      "mobilenetv2_unet", "unet"]
    fpn = build_model(ModelConfig(name="mobilenetv2_fpn"))
    assert fpn.lat5[0].out_channels == 128 and fpn.classifier.out_channels == 10
    deeplab = build_model(ModelConfig(name="mobilenetv2_deeplab"))
    assert deeplab.aspp.project[0].out_channels == 128
    assert [getattr(deeplab.aspp, f"aspp_rate{r}")[0].padding for r in (2, 4, 6)] == [
        (2, 2), (4, 4), (6, 6)]
    unet = build_model(ModelConfig(name="unet"))
    assert unet.inc.conv.conv[0].out_channels == 64
    assert unet.down3.mpconv[1].conv[0].out_channels == 256       # keeps 4F
    light = build_model(ModelConfig(name="light_unet", num_classes=10))
    assert light.sem_out.conv[3].out_channels == 1
    for name, down in (("unet", 8), ("light_unet", 8), ("mobilenetv2_fpn", 32),
                       ("mobilenetv2_deeplab", 32), ("mobilenetv2_unet", 32)):
        assert size_divisor(name) == down
    assert size_divisor(unet) == size_divisor(light) == 8 and size_divisor(fpn) == 32
    validate_input_size("unet", 40, 48)
    with pytest.raises(ValueError, match="multiples of 8"):
        validate_input_size(light, 36, 48)
    with pytest.raises(ValueError, match="multiples of 32"):
        validate_input_size(deeplab, 40, 64)


@pytest.mark.parametrize("family", ["fpn", "deeplab"])
def test_predictor_matches_jax_predictor(family, tmp_path):
    """Class maps of the port's Predictor (CPU) equal the JAX Predictor's on
    >= 99.9% of pixels and wherever JAX's top-two logit margin exceeds
    1e-3; colours equal wherever classes are."""
    kw = FAMILIES[family]
    _, v = _flax_variables(kw, 4)
    path = tmp_path / "w.pth"
    torch.save(state_dict_from_flax(v), path)
    frames = np.random.RandomState(5).randint(0, 256, (2, 90, 120, 3), np.uint8)
    jp = JaxPredictor(JaxModelConfig(**kw), input_hw=HW, batch_size=2,
                      colorize_on_device=True)
    jp.variables = jax.device_put(v)
    tp = Predictor(ModelConfig(**kw), checkpoint=str(path), input_hw=HW, batch_size=2,
                   colorize_on_device=True, device="cpu")
    before = dict(kernels.launches)
    (want, want_col), (got, got_col) = jp(frames), tp(frames)
    assert kernels.launches == before
    assert got.shape == want.shape == (2, 90, 120)
    x = jax_normalize(jax_resize(jnp.asarray(frames, jnp.float32), *HW))
    top2 = np.sort(np.asarray(jp.model.apply(v, x, train=False)), axis=-1)[..., -2:]
    confident = (top2[..., 1] - top2[..., 0]) > 1e-3
    same = got == want
    assert same.mean() >= 0.999
    rows = np.minimum(np.floor(np.arange(90) * 64 / 90), 63).astype(int)
    cols = np.minimum(np.floor(np.arange(120) * 64 / 120), 63).astype(int)
    assert same[confident[:, rows[:, None], cols[None, :]]].all()
    np.testing.assert_array_equal(got_col[same], np.asarray(want_col)[same])


def test_light_unet_serves_the_argmax_of_its_one_channel():
    """One output channel: the argmax is class 0 everywhere, as in the JAX
    Predictor, and its colour is palette entry 0."""
    tp = Predictor(ModelConfig(name="light_unet", base_filters=8), input_hw=(32, 48),
                   batch_size=1, colorize_on_device=True, device="cpu")
    classes, colors = tp(np.random.RandomState(6).randint(0, 256, (1, 40, 50, 3), np.uint8))
    assert classes.shape == (1, 40, 50) and not classes.any()
    assert len(np.unique(colors)) == 1
