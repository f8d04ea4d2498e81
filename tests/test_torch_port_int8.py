"""Parity of the port's int8 route (``ops/int8_conv.py``, ``export/int8_full.py``) with the JAX package.

The same seeded numpy weights and inputs go through the JAX package (on the
CPU) and the port (``device="cpu"``, where the int8 conv is its plain
float64 version), at small sizes (``tests/torch_port_quant_inputs.py``).
Tolerances:

- The int8 conv's int32 sums: bit-equal to an int64 numpy reference, at
  K > 1040, depthwise groups and dilation 2 (the card's ``int_mm`` route's
  im2col too, run here by the CPU's ``torch._int_mm``); a float32 conv at
  K > 1040 and ``F.conv2d`` on int8 are not.
- One int8 conv: bit-equal to the JAX ``ConvBNAct._quantized_conv`` jitted
  with ``quant`` as an argument (the Predictor's route); XLA multiplies by
  the reciprocal where ``quant`` is a constant (``quantized_apply_fn``),
  which the test shows on inputs built to tell the two apart.
- ``calibrate``: ``kernel_q``/``kernel_scale`` bit-equal, ``act_scale``
  within 4 float32 ulps (both forwards in float64, so the absmaxes
  agree: in float32 the two frameworks' convs sum in other orders and
  the deepest absmaxes part by up to ~25 ulps), the count equal to
  ``count_quantized_convs`` and to ``set_qat``'s, per family.
- The whole int8 forward on JAX's ``quant``: logits within 2e-2 of their
  largest magnitude, class maps equal on >= 99.9% of pixels and wherever
  JAX's top-two margin exceeds 1e-3, per family; in bf16 compute (ROADMAP
  C5's bf16 bounds) within 2^-4, on 98%, and equal where the margin
  exceeds twice the largest logit gap.
- A JAX ``save_quantized`` checkpoint through ``tools/orbax_to_torch.py``:
  the port's Predictor agrees with the JAX Predictor on >= 99.9%.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
import jax.tree_util as jtu

from tests.torch_port_quant_inputs import (CALIB_SEEDS, FAMILIES, HW, family, images,
                                           jax_quant, jax_tool,
                                           two_threads)  # noqa: F401 (autouse)
from tpuseg.configs import ModelConfig as JaxModelConfig
from tpuseg.export import int8_full as jax_int8
from tpuseg.infer.predictor import Predictor as JaxPredictor
from tpuseg.models.blocks import ConvBNAct as JaxConvBNAct
from tpuseg_torch.configs import ModelConfig
from tpuseg_torch.core.weights import quant_from_flax, state_dict_from_flax
from tpuseg_torch.export import int8_full, quantize
from tpuseg_torch.infer.predictor import Predictor
from tpuseg_torch.models.blocks import Conv2d
from tpuseg_torch.ops import int8_conv
from tpuseg_torch.ops.fake_quant import set_qat

AGREE, MARGIN, LOGIT_TOL, ULPS = 0.999, 1e-3, 2e-2, 4
# bf16 compute (ROADMAP C5): two bf16 forwards round at other places, so
# logits within 2^-4 of their largest magnitude, 98% of the picks, and
# equal picks where JAX's top-two margin exceeds twice the largest gap
BF16_LOGIT_TOL, BF16_AGREE = 2.0 ** -4, 0.98


# ---------------------------------------------------------------------------
# ops/int8_conv.py


def int64_conv(xq, kq, stride, padding, dilation, groups):
    """The int64 numpy reference: each output a sum of int64 products."""
    x = np.pad(xq.astype(np.int64), ((0, 0), (0, 0), (padding, padding), (padding, padding)))
    k = kq.astype(np.int64)
    b, c, h, w = x.shape
    o, cg, kh, kw = k.shape
    ho = (h - dilation * (kh - 1) - 1) // stride + 1
    wo = (w - dilation * (kw - 1) - 1) // stride + 1
    out = np.zeros((b, o, ho, wo), np.int64)
    og = o // groups
    for g in range(groups):
        xs = x[:, g * cg:(g + 1) * cg]
        for ky in range(kh):
            for kx in range(kw):
                patch = xs[:, :, ky * dilation: ky * dilation + (ho - 1) * stride + 1: stride,
                           kx * dilation: kx * dilation + (wo - 1) * stride + 1: stride]
                out[:, g * og:(g + 1) * og] += np.einsum(
                    "bchw,oc->bohw", patch, k[g * og:(g + 1) * og, :, ky, kx])
    return out


INT8_CASES = {   # (B, Cin, H, W, Cout, k, stride, padding, dilation, groups)
    "dense_K1800": (2, 200, 6, 7, 24, 3, 1, 1, 1, 1),
    "up1_K12096": (1, 1344, 4, 4, 16, 3, 1, 1, 1, 1),
    "stem_stride2": (2, 3, 9, 10, 16, 3, 2, 1, 1, 1),
    "pointwise": (2, 40, 5, 6, 20, 1, 1, 0, 1, 1),
    "depthwise": (2, 48, 7, 9, 48, 3, 1, 1, 1, 48),
    "depthwise_stride2": (2, 48, 7, 9, 48, 3, 2, 1, 1, 48),
    "dilated2": (2, 64, 8, 8, 16, 3, 1, 2, 2, 1),
}


def int8_operands(case, seed=0):
    b, cin, h, w, cout, k, _, _, _, groups = INT8_CASES[case]
    rng = np.random.RandomState(seed)
    # extreme values: every product near 127^2, the sums as large as they get
    xq = rng.choice([-127, -126, 125, 127], (b, cin, h, w)).astype(np.int8)
    kq = rng.choice([-127, 126, 127], (cout, cin // groups, k, k)).astype(np.int8)
    return xq, kq


@pytest.mark.parametrize("case", list(INT8_CASES))
def test_int8_conv_int32_sums_equal_int64_reference(case):
    *_, stride, padding, dilation, groups = INT8_CASES[case]
    xq, kq = int8_operands(case)
    want = int64_conv(xq, kq, stride, padding, dilation, groups)
    assert np.abs(want).max() < 2**31
    x, k = torch.from_numpy(xq), torch.from_numpy(kq)
    got = int8_conv.int8_conv(x, k, stride, padding, dilation, groups)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # the card's route for this shape, with the CPU's int8 GEMM standing in
    # for cuBLASLt: the im2col order and the zero padding are exact too
    route = int8_conv.card_route(kq.shape, groups)
    assert route == ("fp32" if groups > 1 else "int_mm")
    if route == "int_mm":
        xcl = x.contiguous(memory_format=torch.channels_last)
        got = int8_conv.int_mm_conv(xcl, k, stride, padding, dilation)
    else:
        got = F.conv2d(x.float(), k.float(), None, stride, padding, dilation, groups).to(
            torch.int32)
    np.testing.assert_array_equal(got.numpy(), want)


def test_fp32_route_and_int8_conv2d_are_not_exact():
    """Why the routes are what they are: F.conv2d on int8 returns int8 and
    wraps, and a float32 conv at K = 12,096 > 1040 rounds its sums."""
    rng = np.random.RandomState(1)
    # positive extremes: the sums pass 2^24 and float32 loses their low bits
    xq = rng.choice([125, 126, 127], (1, 1344, 4, 4)).astype(np.int8)
    kq = rng.choice([125, 126, 127], (16, 1344, 3, 3)).astype(np.int8)
    want = int64_conv(xq, kq, 1, 1, 1, 1)
    x, k = torch.from_numpy(xq), torch.from_numpy(kq)
    wrapped = F.conv2d(x, k, padding=1)
    assert wrapped.dtype == torch.int8 and not np.array_equal(wrapped.numpy(), want)
    f32 = F.conv2d(x.float(), k.float(), padding=1).double().numpy()
    assert np.abs(want).max() > 2**24 and not np.array_equal(f32, want)
    assert int8_conv.MAX_EXACT_FP32_K == 1040
    with pytest.raises(ValueError, match="groups=2"):
        int8_conv.card_route((8, 4, 3, 3), 2)


# ---------------------------------------------------------------------------
# the int8 conv of one ConvBNAct; the JAX route finding


def one_conv_quant(seed=0):
    """A JAX ConvBNAct (3x3, bias) with calibrated quant, its params."""
    rng = np.random.RandomState(seed)
    m = JaxConvBNAct(16)
    x = rng.randn(2, 8, 12, 24).astype(np.float32) * 2.0
    v = jax.jit(lambda k: m.init(k, jnp.asarray(x), False))(jax.random.PRNGKey(seed))
    p = jtu.tree_map(np.asarray, v["params"])
    kernel_q, scale = quantize.quantize_weight(torch.from_numpy(
        np.transpose(p["conv"]["kernel"], (3, 2, 0, 1)).copy()))
    quant = {"kernel_q": np.transpose(kernel_q.numpy(), (2, 3, 1, 0)).copy(),
             "kernel_scale": scale.numpy(), "bias": p["conv"]["bias"],
             "act_scale": np.float32(np.abs(x).max() / 127.0)}
    return m, p, quant, x


def port_conv(quant):
    conv = Conv2d(quant["kernel_q"].shape[2], quant["kernel_q"].shape[3], 3, padding=1)
    int8_full.bind_quant(torch.nn.Sequential(conv), {"0": {
        "kernel_q": torch.from_numpy(np.transpose(quant["kernel_q"], (3, 2, 0, 1)).copy()),
        "kernel_scale": torch.from_numpy(quant["kernel_scale"]),
        "act_scale": torch.tensor(quant["act_scale"]),
        "bias": torch.from_numpy(quant["bias"])}})
    return conv.eval()


def jax_quantized_conv(m, p, quant, x, as_argument=True):
    f = lambda q, xx: m.apply({"params": p, "quant": q}, xx,
                              method=JaxConvBNAct._quantized_conv)
    if as_argument:
        return np.asarray(jax.jit(f)(quant, jnp.asarray(x)))
    return np.asarray(jax.jit(lambda xx: f(quant, xx))(jnp.asarray(x)))


def test_int8_conv_of_one_convbnact_bit_equal_jax():
    m, p, quant, x = one_conv_quant()
    want = jax_quantized_conv(m, p, quant, x)
    with torch.no_grad():
        got = port_conv(quant)(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_quantized_apply_fn_multiplies_where_the_argument_route_divides():
    """``quant`` bound as constants (``quantized_apply_fn``) lets XLA turn
    ``x / act_scale`` into ``x * (1 / act_scale)``; passed as an argument
    (the Predictor, eval_quantized) it divides. Inputs one ulp around half
    steps, where the two round apart, show which route each takes; the
    port divides."""
    s = np.float32(0.055332538)
    inv = np.float32(1) / s
    cand = []
    for k in range(-120, 120):
        x = np.float32((k + 0.5) * s)
        for _ in range(3):
            cand += [x]
            x = np.nextafter(x, np.float32(np.inf))
    cand = np.asarray(cand, np.float32)
    apart = cand[np.round(cand / s) != np.round(cand * inv)]
    assert apart.size >= 4
    m = JaxConvBNAct(1, kernel=(1, 1), padding="VALID")
    p = {"conv": {"kernel": np.ones((1, 1, 1, 1), np.float32),
                  "bias": np.zeros(1, np.float32)}}
    quant = {"kernel_q": np.ones((1, 1, 1, 1), np.int8),
             "kernel_scale": np.ones(1, np.float32), "act_scale": s,
             "bias": np.zeros(1, np.float32)}
    x = apart.reshape(1, 1, -1, 1)
    steps = lambda y: np.round(y.ravel() / s)
    divided, multiplied = np.round(apart / s), np.round(apart * inv)
    np.testing.assert_array_equal(steps(jax_quantized_conv(m, p, quant, x)), divided)
    np.testing.assert_array_equal(steps(jax_quantized_conv(m, p, quant, x, False)), multiplied)
    got = int8_conv.quantize_act(torch.from_numpy(apart), torch.tensor(s))
    np.testing.assert_array_equal(got.numpy(), divided)


# ---------------------------------------------------------------------------
# export/int8_full.py


@pytest.mark.parametrize("name", list(FAMILIES))
def test_calibrate_matches_jax(name):
    jq = jax_quant(name)
    _, v, model = family(name)
    want = quant_from_flax({**v, "quant": jq})
    model.double()
    got = int8_full.calibrate(model, state_dict_from_flax(v, dtype=torch.float64),
                              [torch.from_numpy(images(s, dtype=np.float64))
                               for s in CALIB_SEEDS])
    n = int8_full.count_quantized_convs(got)
    assert n == jax_int8.count_quantized_convs(jq) == set_qat(model) == len(want)
    assert set(got) == set(want)
    bits = lambda t: int(np.array(t.item(), np.float32).view(np.int32))
    for k, w in want.items():
        g = got[k]
        assert set(g) == set(w), k
        assert g["kernel_q"].dtype == torch.int8 and torch.equal(g["kernel_q"], w["kernel_q"])
        assert torch.equal(g["kernel_scale"], w["kernel_scale"])
        assert g["act_scale"].dtype == torch.float32 and g["act_scale"].ndim == 0
        assert abs(bits(g["act_scale"]) - bits(w["act_scale"])) <= ULPS, k
        if "bias" in w:
            assert torch.equal(g["bias"], w["bias"])


def test_calibrate_refuses_a_pass_that_sees_no_conv():
    _, v, model = family("unet")
    with pytest.raises(ValueError, match="captured no conv inputs"):
        int8_full.calibrate(model, state_dict_from_flax(v), [])


@pytest.mark.parametrize("name,compute_dtype", [(n, "float32") for n in FAMILIES]
                         + [("mobilenetv2_unet", "bfloat16")])
def test_int8_forward_matches_jax(name, compute_dtype):
    """The port's int8 forward on JAX's calibrated ``quant`` against the
    JAX model applied with it (jitted, ``quant`` an argument)."""
    jm, v, model = family(name, compute_dtype=compute_dtype)
    jq = jax_quant(name)
    x = images(3)
    want = np.asarray(jax.jit(lambda vv, q, xx: jm.apply({**vv, "quant": q}, xx, train=False))(
        v, jq, jnp.asarray(x)), np.float32)
    fn = int8_full.quantized_apply_fn(model, state_dict_from_flax(v),
                                      quant_from_flax({**v, "quant": jq}))
    got = fn(torch.from_numpy(x)).float().numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    bf16 = compute_dtype == "bfloat16"
    gap = np.abs(got - want).max()
    assert gap <= (BF16_LOGIT_TOL if bf16 else LOGIT_TOL) * np.abs(want).max()
    if want.shape[-1] == 1:
        return
    agree = got.argmax(-1) == want.argmax(-1)
    top2 = np.sort(want, -1)
    assert agree.mean() >= (BF16_AGREE if bf16 else AGREE)
    assert agree[(top2[..., -1] - top2[..., -2]) > (2 * gap if bf16 else MARGIN)].all()


# ---------------------------------------------------------------------------
# serving a JAX-calibrated int8 checkpoint


def test_predictor_serves_jax_quantized_checkpoint(tmp_path):
    convert = jax_tool("orbax_to_torch").convert
    _, v, _ = family("unet")
    jq = jax_quant("unet")
    src = str(tmp_path / "jax_int8")
    jax_int8.save_quantized(src, v, jq)
    out = str(tmp_path / "torch_int8")
    convert(src, out)
    cfg = FAMILIES["unet"]
    want_p = JaxPredictor(JaxModelConfig(**cfg), checkpoint=src, input_hw=HW, batch_size=2)
    got_p = Predictor(ModelConfig(**cfg), checkpoint=out, input_hw=HW, batch_size=2,
                      device="cpu")
    assert want_p.int8 and got_p.int8
    assert sum(m.int8 is not None for m in got_p.model.modules()
               if isinstance(m, Conv2d)) == jax_int8.count_quantized_convs(jq)
    frames = np.random.RandomState(4).randint(0, 256, (2, *HW, 3), np.uint8)
    assert (got_p(frames) == want_p(frames)).mean() >= AGREE
