"""QAT in the port (tpuseg_torch/ops/fake_quant.py, the QAT route of
tpuseg_torch/models/blocks.py::Conv2d) against the JAX package's
(tpuseg/ops/fake_quant.py, tpuseg/models/blocks.py::ConvBNAct._qat_conv).

- ``fake_quant_act``/``fake_quant_kernel``: values and straight-through
  gradients bit-equal to JAX's compiled ones (``jax.jit``, as the train
  step runs them) in float32, with exact .5 ties, an all-zero tensor and
  channel, a depthwise kernel and a 1x1; float64 (rounded in float32 and
  cast back, as under x64) and bf16 inputs bit-equal too. Op by op JAX
  divides by 127 where its compiled form multiplies by float32(1/127):
  the two differ on some inputs, and the port follows the compiled form
  (ROADMAP.md C15).
- The quantized conv set: per family, the same count as
  ``count_qat_markers(build_qat_markers(params))``, and the same convs
  (each marked flax kernel mapped by ``state_dict_from_flax`` onto a
  marked port conv and nothing else).
- Eval is not quantized; under QAT a training forward takes the
  materialized decoder even with ``up_subpixel=True``.
- One float64 QAT train step (a UNet at base_filters 4, 32x64, batch 2,
  CE, Adam; the flagship's QAT convs are the mapping above, and it trains
  under QAT on the card in chip_smoke.py's train_contact phase) against
  JAX's ``make_train_step(extra_collections={"qat": ...})``: loss,
  parameters and BatchNorm statistics at rtol 1e-6 (the fake-quant rounds
  in float32 in both packages, so the gradients through it carry float32
  rounding; the parameters also at atol 1e-8).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_torch_port_distill import BF as UNET_BF, HW as UNET_HW, _flax_unet_vars
from tpuseg.configs import ModelConfig as JaxModelConfig
from tpuseg.models.unet import UNet as FlaxUNet
from tpuseg.models.registry import build_model as jax_build_model
from tpuseg.ops import fake_quant as jfq
from tpuseg.train.train_step import TrainState, make_train_step as jax_make_train_step
from tpuseg_torch.configs import ModelConfig
from tpuseg_torch.core.weights import state_dict_from_flax
from tpuseg_torch.models.registry import build_model
from tpuseg_torch.ops import fake_quant as pfq
from tpuseg_torch.train.optim import Optimizer
from tpuseg_torch.train.train_step import make_train_step

LR = 1.5e-4
FAMILIES = {"mobilenetv2_unet": dict(width_mult=0.25),
            "mobilenetv2_fpn": dict(width_mult=0.25, base_filters=16),
            "mobilenetv2_deeplab": dict(width_mult=0.25, base_filters=16),
            "unet": dict(base_filters=4), "light_unet": dict(base_filters=4)}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _act_input(case):
    rng = np.random.RandomState(0)
    if case == "random":
        return (rng.randn(2, 5, 6, 7) * 3).astype(np.float32)
    if case == "ties":         # absmax 127: scale 1, every x/scale an exact .5 tie
        x = np.arange(-127, 127, dtype=np.float32) + 0.5
        return np.concatenate([x, [127.0, -127.0]]).astype(np.float32).reshape(2, 2, 8, 8)
    return np.zeros((2, 3, 4, 4), np.float32)


def _kernel_input(case):
    """A JAX HWIO kernel: dense with one all-zero output channel, depthwise
    [3,3,1,C], 1x1 with .5 ties (absmax 127 on every channel)."""
    rng = np.random.RandomState(1)
    if case == "dense":
        k = rng.randn(3, 3, 4, 6).astype(np.float32)
        k[..., 2] = 0.0
        return k
    if case == "depthwise":
        return rng.randn(3, 3, 1, 8).astype(np.float32)
    k = np.tile((np.arange(-63, 64, 2, dtype=np.float32) + 0.5)[:, None], (1, 3))
    k[0] = 127.0
    return k.reshape(1, 1, 64, 3)


def _jax_value_grad(fn, x, r):
    """JAX's compiled ``fn(x)`` and the gradient of sum(fn(x) * r)."""
    grad = jax.jit(jax.grad(lambda v: jnp.sum(fn(v) * r)))(x)
    return np.asarray(jax.jit(fn)(x)), np.asarray(grad)


def _port_value_grad(fn, x, r):
    x = x.clone().requires_grad_(True)
    y = fn(x)
    (y * r).sum().backward()
    return y.detach(), x.grad


@pytest.mark.parametrize("case", ["random", "ties", "zeros"])
def test_fake_quant_act_bit_equal_to_jax(case):
    x = _act_input(case)
    r = np.random.RandomState(2).randn(*x.shape).astype(np.float32)
    want, want_g = _jax_value_grad(jfq.fake_quant_act, jnp.asarray(x), jnp.asarray(r))
    got, got_g = _port_value_grad(pfq.fake_quant_act, torch.from_numpy(x), torch.from_numpy(r))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got_g.numpy(), want_g)
    if case == "ties":           # half to even, in both
        assert set(np.unique(want[0, 0, 0, :4])) <= {-126.0, -124.0}


@pytest.mark.parametrize("case", ["dense", "depthwise", "1x1_ties"])
def test_fake_quant_kernel_bit_equal_to_jax(case):
    k = _kernel_input(case)
    r = np.random.RandomState(3).randn(*k.shape).astype(np.float32)
    want, want_g = _jax_value_grad(jfq.fake_quant_kernel, jnp.asarray(k), jnp.asarray(r))
    oihw = lambda a: torch.from_numpy(np.ascontiguousarray(a.transpose(3, 2, 0, 1)))
    got, got_g = _port_value_grad(pfq.fake_quant_kernel, oihw(k), oihw(r))
    np.testing.assert_array_equal(got.permute(2, 3, 1, 0).numpy(), want)
    np.testing.assert_array_equal(got_g.permute(2, 3, 1, 0).numpy(), want_g)
    if case == "dense":
        assert not want[..., 2].any()
    if case == "depthwise":      # per channel over its 9 taps
        for c in range(k.shape[-1]):
            s = np.abs(k[..., c]).max() / np.float32(127.0)
            np.testing.assert_array_equal(want[..., c],
                                          np.clip(np.round(k[..., c] / s), -127, 127) * s)


def test_the_port_follows_the_compiled_scale_where_eager_jax_differs():
    """ROADMAP.md C15: for this absmax, absmax / 127 (JAX op by op) and
    absmax * float32(1/127) (its compiled form) are one float32 step apart,
    so every quantized value moves; the port equals the compiled form."""
    x = np.random.RandomState(11).rand(2, 8, 6, 5).astype(np.float32)
    amax = np.array([1077986097], np.uint32).view(np.float32)[0]      # 3.0119135
    x[0, 0, 0, 0] = amax
    assert amax / np.float32(127) != amax * np.float32(1 / 127)
    eager = np.asarray(jfq.fake_quant_act(jnp.asarray(x)))
    compiled = np.asarray(jax.jit(jfq.fake_quant_act)(jnp.asarray(x)))
    got = pfq.fake_quant_act(torch.from_numpy(x)).numpy()
    assert not np.array_equal(eager, compiled)
    np.testing.assert_array_equal(got, compiled)


@pytest.mark.parametrize("dtype", ["float64", "bfloat16"])
def test_fake_quant_f64_and_bf16_as_jax(dtype):
    """Both round in float32 and return the input's dtype: an f64 input
    (under x64) and a bf16 one give JAX's values, bit for bit."""
    x = _act_input("random")
    k = _kernel_input("dense")
    jdt, tdt = (jnp.float64, torch.float64) if dtype == "float64" else (jnp.bfloat16,
                                                                        torch.bfloat16)
    if dtype == "float64":
        jax.config.update("jax_enable_x64", True)
    try:
        xj, kj = jnp.asarray(x, jdt) * 1.1, jnp.asarray(k, jdt) * 1.1
        want_x = np.asarray(jax.jit(jfq.fake_quant_act)(xj).astype(jnp.float64))
        want_k = np.asarray(jax.jit(jfq.fake_quant_kernel)(kj).astype(jnp.float64))
        xin = torch.from_numpy(np.asarray(xj.astype(jnp.float64))).to(tdt)
        kin = torch.from_numpy(np.asarray(kj.astype(jnp.float64))).to(tdt)
    finally:
        jax.config.update("jax_enable_x64", False)
    got_x = pfq.fake_quant_act(xin)
    got_k = pfq.fake_quant_kernel(kin.permute(3, 2, 0, 1))
    assert got_x.dtype == got_k.dtype == tdt
    np.testing.assert_array_equal(got_x.double().numpy(), want_x)
    np.testing.assert_array_equal(got_k.permute(2, 3, 1, 0).double().numpy(), want_k)


def _marker_paths(markers, prefix=()):
    for key, value in markers.items():
        if key == "on":
            yield prefix
        else:
            yield from _marker_paths(value, prefix + (key,))


@pytest.mark.parametrize("name", list(FAMILIES))
def test_qat_conv_set_equals_jax_markers(name):
    """The same count as build_qat_markers, and the same convs: with every
    marked flax kernel set to ones and the rest to zeros, the port's
    nonzero conv weights after state_dict_from_flax are its QAT convs."""
    model = jax_build_model(JaxModelConfig(name=name, **FAMILIES[name]))
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0),
                                               jnp.zeros((1, 64, 64, 3)), train=False))
    tree = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                  {"params": shapes["params"],
                                   "batch_stats": shapes["batch_stats"]})
    markers = jfq.build_qat_markers(tree["params"])
    for path in _marker_paths(markers):
        node = tree["params"]
        for p in path:
            node = node[p]
        node["conv"]["kernel"][...] = 1.0
    port = build_model(ModelConfig(name=name, **FAMILIES[name]))
    named = pfq.qat_convs(port)
    assert len(named) == jfq.count_qat_markers(markers) == pfq.set_qat(port)
    sd = state_dict_from_flax(tree)
    port_sd = port.state_dict()
    convs = {k for k, v in port_sd.items() if k.endswith(".weight") and v.ndim == 4}
    assert convs <= set(sd)
    assert {k for k in convs if sd[k].any()} == {f"{n}.weight" for n, _ in named}
    assert all(conv.qat for _, conv in named)


def test_eval_is_unquantized_and_train_mode_materializes_the_decoder(monkeypatch):
    """QAT acts in train mode only; there, up_subpixel=True takes the
    materialized up-concat (the subpixel rewrite is not called) and equals
    the materialized model bit for bit; it changes no state_dict key."""
    import tpuseg_torch.ops.subpixel as subpixel

    x = torch.from_numpy(np.random.RandomState(4).rand(2, 3, 64, 128).astype(np.float32))
    plain = build_model(ModelConfig(width_mult=0.25))
    keys = {k: v.shape for k, v in plain.state_dict().items()}
    qat = build_model(ModelConfig(width_mult=0.25))
    pfq.set_qat(qat)
    assert {k: v.shape for k, v in qat.state_dict().items()} == keys
    with torch.no_grad():
        assert torch.equal(qat.eval()(x), plain.eval()(x))
    mat = build_model(ModelConfig(width_mult=0.25, up_subpixel=False))
    pfq.set_qat(mat)
    with torch.no_grad():
        y_plain = plain.train()(x)

    def refuse(*a, **k):
        raise AssertionError("the subpixel rewrite ran under QAT")

    monkeypatch.setattr(subpixel, "up_concat_conv_subpixel", refuse)
    y_sub, y_mat = qat.train()(x), mat.train()(x)
    assert torch.equal(y_sub, y_mat) and not torch.equal(y_sub, y_plain)
    sd_q, sd_m = qat.state_dict(), mat.state_dict()
    assert all(torch.equal(sd_q[k], sd_m[k]) for k in sd_q)   # the same statistics moved


def test_f64_qat_train_step_matches_jax():
    """One step of a UNet (base_filters 4, 32x64, batch 2) with every
    conv+BatchNorm conv fake-quantized, against JAX's step with the markers."""
    variables = _flax_unet_vars(21)
    rng = np.random.RandomState(7)
    x, y = rng.rand(2, *UNET_HW, 3), rng.randint(0, 10, (2, *UNET_HW))
    jax.config.update("jax_enable_x64", True)
    try:
        fm = FlaxUNet(output_channels=10, base_filters=UNET_BF, dtype=jnp.float64)
        cast = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), t)
        state = TrainState.create(apply_fn=fm.apply, params=cast(variables["params"]),
                                  batch_stats=cast(variables["batch_stats"]),
                                  tx=optax.adam(LR, b1=0.9, b2=0.999, eps=1e-8))
        markers = jfq.build_qat_markers(state.params)
        step = jax_make_train_step(donate=False, extra_collections={"qat": markers})
        state, metrics = step(state, jnp.asarray(x), jnp.asarray(y))
        want_loss = float(metrics["loss"])
        want = state_dict_from_flax({"params": state.params, "batch_stats": state.batch_stats},
                                    dtype=torch.float64)
    finally:
        jax.config.update("jax_enable_x64", False)
    model = build_model(ModelConfig(name="unet", base_filters=UNET_BF)).to(torch.float64)
    model.load_state_dict(state_dict_from_flax(variables, dtype=torch.float64), strict=True)
    assert pfq.set_qat(model) == jfq.count_qat_markers(markers) == 15
    got_loss = float(make_train_step(model, Optimizer(model.parameters(), lr=LR))(
        torch.from_numpy(x), torch.from_numpy(y))["loss"])
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-6)
    got = model.state_dict()
    n_stats = 0
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        tol = dict(rtol=1e-6) if k.endswith(("running_mean", "running_var")) else \
            dict(rtol=1e-6, atol=1e-8)
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), err_msg=k, **tol)
        n_stats += k.endswith("running_var")
    assert n_stats == 15
