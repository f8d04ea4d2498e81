"""bf16 compute in the port (``ModelConfig.compute_dtype="bfloat16"``,
``--train.mu_dtype``, ``--train.grads_bf16``) against the JAX package's.

The same seeded numpy inputs and the same Flax init (carried over by
``state_dict_from_flax``) go through both packages on the CPU at small
widths. What each comparison can hold, measured on this CPU first:

- A convolution rounds its fp32 sum to bf16 in both packages (XLA's CPU
  conv equals the rounded fp32 conv; oneDNN's bf16 conv agrees with it on
  all but about 1e-4 of the outputs, where the two fp32 sums, taken in
  other orders, straddle a bf16 rounding boundary). So one layer, or a
  chain that rounds where flax rounds, is bit-equal but for those few
  elements (``NEAR_EXACT``), each one bf16 step off; a layer computed in
  fp32, or rounded at another place, is bit-equal nowhere.
- A whole model is not: each flipped rounding moves the next layers'
  sums, and the flips spread (a decoder stage ends 90-99.9% bit-equal).
  The logits are held at ``LOGIT_TOL`` of their largest magnitude: the
  largest gap measured here was 2.3% (the FPN, whose four heads are
  summed in bf16), against 1.5% between the JAX package's own bf16 and
  fp32 logits; the class maps agree on ``AGREE`` of the pixels.
- The kernels' plain versions widen bf16 inputs and compute in fp32, as
  the Pallas kernels do: the decoder's f32 output is held at the fp32
  parity tolerance, the class maps bit-equal but for near-ties, the block
  within one bf16 step of its rounded fp32 result.
- The optimizer's bf16 moments are deterministic roundings of the same
  fp32 values: ``mu`` is bit-equal to optax's, the parameters within
  ``MAX_ULP`` float32 steps (XLA's and torch's divisions and square roots
  round the last bit apart; plain fp32 Adam shows the same).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn as nn

from tpuseg.configs import ModelConfig as JaxModelConfig
from tpuseg.configs import load_config as jax_load_config
from tpuseg.models.blocks import Up as FlaxUp
from tpuseg.models.mobilenetv2 import MobileNetV2Encoder as FlaxEncoder
from tpuseg.models.registry import build_model as jax_build_model
from tpuseg.ops import pallas_kernels as jk
from tpuseg.ops.pallas_mbconv import fused_inverted_residual as jax_mbconv
from tpuseg.ops.resize import upsample2x_bilinear as jax_upsample2x
from tpuseg.train.loss import make_loss_fn as jax_make_loss_fn
from tpuseg.train.metrics import confusion_matrix as jax_confusion_matrix
from tpuseg.train.trainer import Trainer as JaxTrainer
from tpuseg_torch.configs import ModelConfig, load_config
from tpuseg_torch.core.dtypes import set_compute_dtype, torch_dtype
from tpuseg_torch.core.weights import state_dict_from_flax
from tpuseg_torch.data.class_maps import COLOR_MAP_BGR
from tpuseg_torch.models.blocks import Conv2d
from tpuseg_torch.models.registry import build_model
from tpuseg_torch.ops import kernels as tk
from tpuseg_torch.ops.mbconv import fused_inverted_residual
from tpuseg_torch.ops.resize import upsample2x_bilinear
from tpuseg_torch.train.loss import make_loss_fn
from tpuseg_torch.train.metrics import confusion_matrix
from tpuseg_torch.train.optim import build_optimizer

HW = (32, 64)
LOGIT_TOL = 2 ** -4          # of max |logit|: flips spread through the layers (docstring)
AGREE = 0.97                 # class maps of seeded, untrained weights: many near-ties
NEAR_EXACT = 0.99            # bit-equal share of one block's bf16 output
BF16_STEP = 2 ** -7          # one bf16 step, relative (8 significant bits)
NEAR_TIE = 1e-5
MAX_ULP = 4
BF16 = torch.bfloat16


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads (the suite runs several workers on a few cores)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _variables(kw: dict, seed: int):
    """A Flax init of ``kw``'s model with seeded BN statistics, BN affines
    and biases (fp32)."""
    model = jax_build_model(JaxModelConfig(**kw))
    v = jax.jit(lambda k: model.init(k, jnp.zeros((1, *HW, 3)), train=False))(
        jax.random.PRNGKey(seed))
    rng = np.random.RandomState(seed)

    def perturb(path, a):
        name = jax.tree_util.keystr(path)
        lo, hi = ((0.5, 1.5) if ("var" in name or "scale" in name)
                  else (-0.2, 0.2) if ("mean" in name or "bias" in name) else (None, None))
        a = np.asarray(a)
        return a if lo is None else rng.uniform(lo, hi, a.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(
        perturb, {"params": v["params"], "batch_stats": v["batch_stats"]})


def _port(kw: dict, variables) -> nn.Module:
    model = build_model(ModelConfig(**kw))
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    return model.eval()


def _bits_equal(a: np.ndarray, b: np.ndarray) -> float:
    return float((np.asarray(a, np.float32) == np.asarray(b, np.float32)).mean())


def _within_steps(got, want, steps: int = 1, atol: float = 0.0) -> bool:
    """Every element within ``steps`` bf16 steps of ``want``, plus
    ``atol``: near zero, where two fp32 sums that differ by less than a
    rounding round to values far apart relative to their size."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return bool((np.abs(got - want) <= steps * BF16_STEP * np.abs(want) + atol).all())


def _near_steps(got, want, steps: int = 4) -> bool:
    """Every element within ``steps`` bf16 steps of the tensor's largest
    magnitude: a flipped rounding in one layer moves each output of the
    next by at most about a step of that layer's values."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max()) <= steps * BF16_STEP * float(np.abs(want).max())


@pytest.fixture(scope="module")
def x_nhwc():
    return np.random.RandomState(0).rand(2, *HW, 3).astype(np.float32)


@pytest.fixture(scope="module")
def flagship_vars():
    return _variables(dict(name="mobilenetv2_unet", width_mult=0.25), 1)


# ---------------------------------------------------------------------------
# the policy


def test_every_family_builds_in_bf16_with_fp32_parameters_and_the_same_keys():
    assert torch_dtype("bfloat16") == BF16 and torch_dtype("float32") == torch.float32
    for name in ("mobilenetv2_unet", "mobilenetv2_fpn", "mobilenetv2_deeplab", "unet",
                 "light_unet"):
        kw = dict(name=name, width_mult=0.25, base_filters=8)
        m16, m32 = build_model(ModelConfig(**kw, compute_dtype="bfloat16")), \
            build_model(ModelConfig(**kw))
        assert list(m16.state_dict()) == list(m32.state_dict())
        assert {p.dtype for p in m16.parameters()} == {torch.float32}
        convs = [m for m in m16.modules() if isinstance(m, nn.Conv2d)]
        assert convs and all(isinstance(m, Conv2d) and m.compute_dtype == BF16 for m in convs)
        assert all(getattr(m, "compute_dtype", None) is None for m in m32.modules())
    # back to fp32: the parameters' dtype again
    set_compute_dtype(m16, "float32")
    assert all(getattr(m, "compute_dtype", None) is None for m in m16.modules())


# ---------------------------------------------------------------------------
# one layer at a time: rounded where flax rounds


def test_encoder_taps_are_bit_equal_to_flax(flagship_vars, x_nhwc):
    """Every conv, BatchNorm, ReLU6 and residual add of the encoder rounds
    where the flax encoder rounds: its five taps are bf16 and bit-equal
    but for the conv sums that straddle a rounding boundary."""
    v = flagship_vars
    enc = FlaxEncoder(width_mult=0.25, dtype=jnp.bfloat16)
    want = enc.apply({"params": v["params"]["backbone"],
                      "batch_stats": v["batch_stats"]["backbone"]}, jnp.asarray(x_nhwc))
    model = _port(dict(width_mult=0.25, compute_dtype="bfloat16"), v)
    with torch.no_grad():
        taps = model.backbone(torch.from_numpy(x_nhwc).permute(0, 3, 1, 2))
    for i, (t, w) in enumerate(zip(taps, want)):
        assert t.dtype == BF16 and w.dtype == jnp.bfloat16
        got, ref = t.float().permute(0, 2, 3, 1).numpy(), np.asarray(w.astype(jnp.float32))
        assert _bits_equal(got, ref) >= NEAR_EXACT, f"tap {i + 1}"
        assert _near_steps(got, ref), f"tap {i + 1}"


@pytest.mark.parametrize("impl", ["materialize", "subpixel", "pallas"])
def test_an_up_block_is_bit_equal_to_flax(flagship_vars, impl):
    """One decoder block (up3 of the flagship) on the same bf16 inputs:
    the materialized upsample + concat, the subpixel rewrite and the fused
    decoder kernel (the JAX kernel in interpret mode, the port's plain
    version) each round their fp32 result to bf16 before BatchNorm, as
    ``ConvBNAct`` does."""
    v = flagship_vars
    sub = {"params": v["params"]["up3"], "batch_stats": v["batch_stats"]["up3"]}
    cin = v["params"]["up3"]["conv"]["conv1"]["conv"]["kernel"].shape[2]
    rng = np.random.RandomState(2)             # x: up2's 128 channels; skip: the rest
    skip = rng.rand(2, 16, 32, cin - 128).astype(np.float32)
    x = rng.rand(2, 8, 16, 128).astype(np.float32)
    flax_up = FlaxUp(64, dtype=jnp.bfloat16, use_pallas=impl == "pallas",
                     subpixel=impl == "subpixel")
    want = flax_up.apply(sub, jnp.asarray(x, jnp.bfloat16), jnp.asarray(skip, jnp.bfloat16))
    model = _port(dict(width_mult=0.25, compute_dtype="bfloat16"), v)
    t = lambda a: torch.from_numpy(a).to(BF16).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = model.up3(t(x), t(skip), use_pallas=impl == "pallas",
                        subpixel=impl == "subpixel")
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    got = got.float().permute(0, 2, 3, 1).numpy()
    want = np.asarray(want.astype(jnp.float32))
    assert _bits_equal(got, want) >= NEAR_EXACT
    assert _near_steps(got, want)


def test_the_bf16_head_upsample_is_bit_equal_to_jax():
    """head_fp32=False: logits, taps and each pass rounded to bf16, as
    ``upsample2x_bilinear(compute_dtype=bf16)`` rounds them."""
    logits = np.random.RandomState(3).randn(2, 16, 32, 10).astype(np.float32)
    want = jax_upsample2x(jnp.asarray(logits), align_corners=True, compute_dtype=jnp.bfloat16)
    got = upsample2x_bilinear(torch.from_numpy(logits), align_corners=True,
                              compute_dtype=BF16)
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


# ---------------------------------------------------------------------------
# whole models


FAMILIES = {
    "flagship": dict(name="mobilenetv2_unet", width_mult=0.25),
    "flagship-pallas": dict(name="mobilenetv2_unet", width_mult=0.25, use_pallas=True,
                            up_subpixel=False),
    "flagship-bf16-head": dict(name="mobilenetv2_unet", width_mult=0.25, head_fp32=False),
    "fpn": dict(name="mobilenetv2_fpn", width_mult=0.25, base_filters=16),
    "deeplab": dict(name="mobilenetv2_deeplab", width_mult=0.25, base_filters=16),
    "unet": dict(name="unet", base_filters=8),
    "light_unet": dict(name="light_unet", base_filters=8),
}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_bf16_eval_logits_match_flax(family, flagship_vars, x_nhwc):
    """Each family's bf16 eval forward against the JAX bf16 forward (the
    flagship with use_pallas runs the JAX decoder kernel in interpret mode,
    as its block does on the CPU): fp32 logits of the right shape, within
    LOGIT_TOL of their largest magnitude, the class maps agreeing."""
    kw = dict(FAMILIES[family], compute_dtype="bfloat16")
    v = flagship_vars if kw["name"] == "mobilenetv2_unet" else _variables(kw, 4)
    fm = jax_build_model(JaxModelConfig(**kw))
    want = np.asarray(jax.jit(lambda v, x: fm.apply(v, x, train=False))(
        v, jnp.asarray(x_nhwc)))
    before = dict(tk.launches)
    with torch.no_grad():
        got = _port(kw, v)(torch.from_numpy(x_nhwc).permute(0, 3, 1, 2))
    assert tk.launches == before            # CPU tensors: the plain versions
    assert got.dtype == torch.float32 and want.dtype == np.float32
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= LOGIT_TOL * np.abs(want).max()
    if want.shape[-1] > 1:
        assert (got.argmax(-1) == want.argmax(-1)).mean() >= AGREE


# ---------------------------------------------------------------------------
# the four kernels' plain versions on bf16 inputs


def _bf16(a: np.ndarray):
    """(the JAX bf16 array, the port's bf16 tensor) of the same values."""
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(BF16)


def test_argmax_colorize_plain_on_bf16_matches_the_pallas_kernel():
    jl, tl = _bf16(np.random.RandomState(5).randn(2, 8, 128, 10).astype(np.float32))
    want_cls, want_col = jk.argmax_colorize(jl, COLOR_MAP_BGR, interpret=True)
    cls, col = tk.argmax_colorize(tl, COLOR_MAP_BGR)
    np.testing.assert_array_equal(cls.numpy(), np.asarray(want_cls))
    np.testing.assert_array_equal(col.numpy(), np.asarray(want_col))


def test_upsample2x_argmax_plain_on_bf16_matches_the_pallas_kernel():
    logits = np.random.RandomState(6).randn(2, 8, 64, 10).astype(np.float32)
    jl, tl = _bf16(logits)
    want = np.asarray(jk.upsample2x_argmax(jl, interpret=True))
    got = tk.upsample2x_argmax(tl).numpy()
    # both widen to f32; the lerps run in another order than JAX's two
    # matrix products, so picks may differ only at near-ties
    up = np.sort(np.asarray(jax_upsample2x(jl.astype(jnp.float32), align_corners=True)), -1)
    near = (up[..., -1] - up[..., -2]) < NEAR_TIE
    assert not ((got != want) & ~near).any()


def test_fused_upconcat_plain_on_bf16_matches_the_pallas_kernel():
    """The decoder's f32 output on bf16 skip and x: both widen first, so
    the fp32 parity tolerance holds (tests/test_torch_port_ops.py)."""
    rng = np.random.RandomState(7)
    skip, x = rng.randn(2, 16, 16, 24), rng.randn(2, 8, 8, 40)
    w = (rng.randn(3, 3, 64, 32) * 0.05).astype(np.float32)
    b = (rng.randn(32) * 0.1).astype(np.float32)
    (js, ts), (jx, tx) = _bf16(skip.astype(np.float32)), _bf16(x.astype(np.float32))
    want = np.asarray(jk.fused_upsample_concat_conv(js, jx, jnp.asarray(w), jnp.asarray(b),
                                                    tile=8, interpret=True))
    got = tk.fused_upsample_concat_conv(ts, tx, torch.from_numpy(w), torch.from_numpy(b))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("use_res", [False, True])
def test_fused_inverted_residual_plain_on_bf16_matches_the_pallas_kernel(use_res):
    """bf16 x in, bf16 out (``x.dtype``), the residual added in f32 from
    the widened x: within one bf16 step of the JAX kernel's output, the
    two rounded fp32 values within 1e-5 of each other (the fp32 parity
    tolerance of tests/test_torch_port_mbconv.py)."""
    rng = np.random.RandomState(8)
    c, hidden = 16, 96
    args = [rng.randn(2, 8, 16, c), rng.randn(c, hidden) * 0.2, rng.rand(hidden) + 0.5,
            rng.randn(hidden) * 0.1, rng.randn(3, 3, hidden) * 0.2, rng.rand(hidden) + 0.5,
            rng.randn(hidden) * 0.1, rng.randn(hidden, c) * 0.2, rng.rand(c) + 0.5,
            rng.randn(c) * 0.1]
    args = [a.astype(np.float32) for a in args]
    jx, tx = _bf16(args[0])
    want = jax_mbconv(jx, *map(jnp.asarray, args[1:]), stride=1, use_res=use_res,
                      interpret=True)
    got = fused_inverted_residual(tx, *map(torch.from_numpy, args[1:]), stride=1,
                                  use_res=use_res)
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    got, want = got.float().numpy(), np.asarray(want.astype(jnp.float32))
    assert _bits_equal(got, want) >= NEAR_EXACT
    assert _within_steps(got, want, 1, atol=1e-5)


# ---------------------------------------------------------------------------
# training


def _port_train_forward(kw, variables, x, y, train: bool = True):
    """The port's forward (BatchNorm on batch statistics with ``train``,
    else on its running ones), CE loss and backward: (loss, the gradients
    by parameter name, the BN statistics, moved with ``train``)."""
    model = _port(kw, variables).train(train)
    logits = model(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    loss = make_loss_fn("ce")(logits, torch.from_numpy(y))
    loss.backward()
    grads = {k: p.grad for k, p in model.named_parameters()}
    stats = {k: t for k, t in model.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    return float(loss.detach()), grads, stats


TRAIN_HW = (64, 128)


@pytest.fixture(scope="module")
def train_batch():
    rng = np.random.RandomState(9)
    return rng.rand(2, *TRAIN_HW, 3).astype(np.float32), rng.randint(0, 10, (2, *TRAIN_HW))


def test_bf16_train_step_matches_jax(flagship_vars, train_batch):
    """One train-mode forward, loss and backward of the bf16 flagship
    (subpixel decoder, CE, batch 2 at 64x128: the deepest BatchNorm sees 16
    values a channel) against the JAX bf16 one. The port's bf16 loss and
    moved BatchNorm statistics lie from JAX's bf16 ones within twice the
    distance at which bf16 puts the port's own fp32 run (measured on this
    CPU: loss 0.00127 vs 0.00159, statistics 6.7% vs 10.1% of their largest
    magnitude; statistics left where they were lie 69% away); the two
    packages' fp32 runs agree to 4.8e-7 and 1.5e-5. The gradients here are
    only held finite: a BatchNorm over 16 values turns the bf16 roundings
    into gradients that lie more than their own norm from the fp32 ones
    (111% for the JAX package, 115% for the port), so no two bf16 gradients
    are near each other in train mode at this size; the next test holds
    them on frozen statistics."""
    v = flagship_vars
    x, y = train_batch
    kw = dict(name="mobilenetv2_unet", width_mult=0.25, compute_dtype="bfloat16")
    fm = jax_build_model(JaxModelConfig(**kw))
    loss_fn = jax_make_loss_fn("ce")

    def jloss(params):
        out, new = fm.apply({"params": params, "batch_stats": v["batch_stats"]},
                            jnp.asarray(x), train=True, mutable=["batch_stats"])
        return loss_fn(out, jnp.asarray(y)), new["batch_stats"]

    (want_loss, want_stats), want_grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        v["params"])
    want = state_dict_from_flax({"params": want_grads, "batch_stats": want_stats})
    loss16, grads16, stats16 = _port_train_forward(kw, v, x, y)
    loss32, _, stats32 = _port_train_forward(dict(kw, compute_dtype="float32"), v, x, y)

    assert abs(loss16 - float(want_loss)) <= 2 * abs(loss16 - loss32)
    assert all(bool(torch.isfinite(g).all()) for g in grads16.values())

    def stats_gap(a):
        return max(float((a[k] - stats16[k]).abs().max() / stats16[k].abs().max())
                   for k in stats16)

    assert stats_gap(want) <= 2 * stats_gap(stats32)


GRAD_LEAF_TOL = 0.3     # of each leaf's norm (next test's docstring)
GRAD_TOL = 0.06         # of the whole gradient's norm


def test_bf16_gradients_match_jax_on_frozen_batchnorm_statistics(flagship_vars,
                                                                 train_batch):
    """The bf16 flagship's backward against the JAX package's bf16 one with
    BatchNorm on its running statistics (flax's ``use_running_average``,
    the port's eval mode), where the bf16 noise stays small. Measured on
    this CPU: each leaf of the port's gradient lies within 0.19 of that
    leaf's norm from JAX's (median 0.035; JAX's own bf16 gradient lies up
    to 0.18 from its fp32 one), the whole gradient within 0.027 of its
    norm; in fp32 the two agree to 1.1e-6. Held per leaf at GRAD_LEAF_TOL
    and whole at GRAD_TOL, limits that the gradient zeroed, halved, negated
    or scaled by 0.8 fails."""
    v = flagship_vars
    x, y = train_batch
    kw = dict(name="mobilenetv2_unet", width_mult=0.25, compute_dtype="bfloat16")
    fm = jax_build_model(JaxModelConfig(**kw))
    loss_fn = jax_make_loss_fn("ce")

    def jloss(params):
        out = fm.apply({"params": params, "batch_stats": v["batch_stats"]}, jnp.asarray(x),
                       train=False)
        return loss_fn(out, jnp.asarray(y))

    want_loss, want_grads = jax.jit(jax.value_and_grad(jloss))(v["params"])
    want = state_dict_from_flax({"params": want_grads, "batch_stats": v["batch_stats"]})
    loss, grads, _ = _port_train_forward(kw, v, x, y, train=False)
    assert abs(loss - float(want_loss)) <= BF16_STEP * abs(float(want_loss))
    want = {k: want[k] for k in grads}

    def close(got: dict) -> bool:
        whole = lambda d: torch.cat([t.reshape(-1) for t in d.values()])
        return (all(float((got[k] - want[k]).norm()) <= GRAD_LEAF_TOL * float(want[k].norm())
                    for k in want)
                and float((whole(got) - whole(want)).norm())
                <= GRAD_TOL * float(whole(want).norm()))

    assert all(bool(torch.isfinite(g).all()) for g in grads.values())
    assert close(grads)
    for scale in (0.0, 0.5, -1.0, 0.8):
        assert not close({k: scale * g for k, g in grads.items()}), scale


OPT_BASE = ["--train.epochs=2", "--train.steps_per_epoch=3", "--train.lr=1e-3"]
OPT_SHAPES = [(3, 3, 8, 16), (16,), (64, 10)]
OPT_CASES = {
    "adam-mu": (["--train.mu_dtype=bfloat16"], False),
    "adamw-mu": (["--train.optimizer=adamw", "--train.weight_decay=0.05",
                  "--train.mu_dtype=bfloat16"], False),
    "sgd-mu": (["--train.optimizer=sgd", "--train.momentum=0.9", "--train.lr=0.05",
                "--train.mu_dtype=bfloat16"], False),
    "cosine-mu": (["--train.lr_schedule=cosine", "--train.warmup_steps=2",
                   "--train.mu_dtype=bfloat16"], False),
    "adam-grads": ([], True),
    "adam-mu-grads": (["--train.mu_dtype=bfloat16"], True),
    "sgd-mu-grads": (["--train.optimizer=sgd", "--train.momentum=0.9", "--train.lr=0.05",
                      "--train.mu_dtype=bfloat16"], True),
    "clip-grads": (["--train.grad_clip_norm=0.05"], True),
    "sgd-clip-grads": (["--train.optimizer=sgd", "--train.momentum=0.0", "--train.lr=0.1",
                        "--train.grad_clip_norm=0.05"], True),
    "accum-grads": (["--train.grad_accum=2"], True),
}


@pytest.mark.parametrize("case", list(OPT_CASES))
def test_bf16_optimizer_trajectory_matches_optax(case):
    """5 updates from seeded fp32 gradients (cast to bf16 first under
    grads_bf16, as both train steps cast them): the JAX Trainer's optax
    chain for the same flags against the port's. mu (or the momentum
    trace) is stored bf16 and bit-equal to optax's at every step's end,
    taken after mu_hat (optax's order); the parameters within MAX_ULP."""
    flags, grads_bf16 = OPT_CASES[case]
    rng = np.random.RandomState(10)
    p0 = [(rng.randn(*s) * 0.1).astype(np.float32) for s in OPT_SHAPES]
    grads = [[(rng.randn(*s) * 10 ** rng.uniform(-4, -1)).astype(np.float32)
              for s in OPT_SHAPES] for _ in range(5)]
    cfg = jax_load_config(OPT_BASE + flags)
    fake = types.SimpleNamespace(cfg=cfg, steps_per_epoch=lambda: cfg.train.steps_per_epoch)
    tx = JaxTrainer._build_optimizer(fake) or optax.adam(cfg.train.lr)
    params = [jnp.asarray(p) for p in p0]
    state = tx.init(params)
    module = nn.Module()
    module.ps = nn.ParameterList([nn.Parameter(torch.from_numpy(p.copy())) for p in p0])
    opt = build_optimizer(module, load_config(OPT_BASE + flags).train, 6)
    for g in grads:
        jg = [jnp.asarray(a, jnp.bfloat16 if grads_bf16 else jnp.float32) for a in g]
        updates, state = tx.update(jg, state, params)
        params = optax.apply_updates(params, updates)
        tg = [torch.from_numpy(a) for a in g]
        opt.step([t.to(BF16) for t in tg] if grads_bf16 else tg)
    for want, got in zip(params, module.ps):
        np.testing.assert_array_max_ulp(got.detach().numpy(), np.asarray(want), MAX_ULP)
    want_mu = [a for a in jax.tree_util.tree_leaves(state) if a.dtype == jnp.bfloat16]
    got_mu = opt.state.get("mu", opt.state.get("trace"))
    if "--train.mu_dtype=bfloat16" in flags:
        assert len(want_mu) == len(got_mu) == len(OPT_SHAPES)
        for want, got in zip(want_mu, got_mu):
            assert got.dtype == BF16
            np.testing.assert_array_equal(got.float().numpy(),
                                          np.asarray(want.astype(jnp.float32)))
    else:
        assert not want_mu and {t.dtype for t in got_mu} == {torch.float32}


def test_mu_dtype_is_validated_at_construction():
    model = build_model(ModelConfig(name="unet", base_filters=4))
    with pytest.raises(ValueError, match="mu_dtype"):
        build_optimizer(model, load_config(["--train.mu_dtype=float16"]).train, 6)
    opt = build_optimizer(model, load_config(["--train.mu_dtype=float32"]).train, 6)
    assert {t.dtype for t in opt.state["mu"]} == {torch.float32}


def test_confusion_matrix_equals_the_bf16_one_hot_contraction():
    """The JAX confusion matrix contracts bf16 one-hots (exact 0/1) with
    f32 accumulation; the port's counts are equal."""
    rng = np.random.RandomState(11)
    preds, labels = rng.randint(0, 11, (2, 32, 64)), rng.randint(0, 11, (2, 32, 64))
    want = np.asarray(jax_confusion_matrix(jnp.asarray(preds), jnp.asarray(labels), 11))
    got = confusion_matrix(torch.from_numpy(preds), torch.from_numpy(labels), 11)
    np.testing.assert_array_equal(got.numpy(), want)


def test_main_trains_in_bf16_with_mu_dtype_and_grads_bf16(tmp_path):
    """``python -m tpuseg_torch.main --model.compute_dtype=bfloat16
    --train.mu_dtype=bfloat16 --train.grads_bf16=true`` on the CPU: the
    parameters and nu stay fp32, mu is bf16, the losses are finite, and a
    checkpoint round-trips the bf16 state."""
    from tpuseg_torch.main import main
    from tpuseg_torch.train.trainer import Trainer

    argv = ["--platform=cpu", "--model.width_mult=0.25", "--data.height=32",
            "--data.width=64", "--train.batch_size=2", "--train.epochs=1",
            "--train.steps_per_epoch=2", "--model.compute_dtype=bfloat16",
            "--train.mu_dtype=bfloat16", "--train.grads_bf16=true", "--train.loss=lovasz",
            f"--train.checkpoint_dir={tmp_path}", "--train.log_every=0"]
    tr = main(argv)
    assert tr.step == 2 and all(np.isfinite(tr.step_losses))
    assert {p.dtype for p in tr.model.parameters()} == {torch.float32}
    assert {t.dtype for t in tr.optimizer.state["mu"]} == {BF16}
    assert {t.dtype for t in tr.optimizer.state["nu"]} == {torch.float32}
    assert any(isinstance(m, Conv2d) and m.compute_dtype == BF16 for m in tr.model.modules())
    resumed = Trainer(tr.cfg, device="cpu")
    assert resumed.maybe_resume() and resumed.step == 2
    for a, b in zip(resumed.optimizer.state["mu"], tr.optimizer.state["mu"]):
        assert a.dtype == BF16 and torch.equal(a, b)
