"""The port's train step (tpuseg_torch/train/train_step.py) against the JAX
package's, on mobilenetv2_unet.

3-step trajectories in float64, after tests/test_torch_parity.py:93: the
same Flax init (with non-trivial BatchNorm statistics) goes into both
packages through ``state_dict_from_flax``, the same seeded batches go
through JAX's ``make_train_step`` with optax Adam and the port's step with
its ``Optimizer`` (optax's formulas), augment off, at width_mult 0.25,
64x128, batch 2. In f64 the summation-order noise is ~1e-13 here, so any semantic difference
(the loss, BatchNorm's train-mode statistics, the bilinear backward, Adam)
shows: losses at rtol 1e-9, parameters at rtol 1e-6 / atol 1e-8, and
BatchNorm running mean and var at rtol 1e-9 (atol 1e-10, as
tests/test_torch_parity.py:198), which pins flax's biased running variance
(torch's BatchNorm2d would be off by n/(n-1) = 16/15 at the 2x4 maps of
batch 2). At 32x64 the deepest maps are 1x2, a variance of 4 numbers, and
the noise there reached 3e-9 on a running variance (measured, with two
CPU threads): too close to the tolerance to hold it.

Two things of the JAX model are f32 by construction and are routed around
in f64: its head casts the logits to f32 (``head_fp32``), so the JAX side
here is the same module tree with the final align_corners=True upsample
kept in f64; and the subpixel decoder rewrite composes its kernel in f32 in
both packages, so the f64 runs take the materialized decoder
(``up_subpixel=False``). That final upsample contracts, in f64, with the
port's f32 taps (``1 - frac`` rounded in f32, where the JAX matrix rounds
the f64 ``1 - frac``: one f32 ulp apart on some taps, a slice-1 fact that
tests/test_torch_port_ops.py covers at f32 tolerance, and which alone
moves the f64 losses by ~3e-9). The subpixel routing, the slice's
default, is held to JAX in f32 by the last test: one step's loss and
BatchNorm statistics.
"""

import functools

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpuseg.models.blocks import OutConv, Up
from tpuseg.models.mobilenetv2 import MobileNetV2Encoder
from tpuseg.models.mobilenetv2_unet import MobileNetV2UNet as FlaxUNet
from tpuseg.train.loss import make_loss_fn as jax_make_loss_fn
from tpuseg.train.train_step import TrainState, make_train_step as jax_make_train_step
from tpuseg_torch.configs import ModelConfig
from tpuseg_torch.core.weights import state_dict_from_flax
from tpuseg_torch.models.registry import build_model
from tpuseg_torch.ops.resize import _taps64
from tpuseg_torch.train.loss import make_loss_fn
from tpuseg_torch.train.optim import Optimizer
from tpuseg_torch.train.train_step import make_train_step

WIDTH, HW, BATCH, STEPS, LR = 0.25, (64, 128), 2, 3, 1.5e-4


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs several workers on a few
    cores, and torch's default of one thread per core then oversubscribes
    them (this module ran 20x slower that way)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


class _FlaxUNetF64Head(FlaxUNet):
    """MobileNetV2UNet's module tree and arithmetic, with the final x2
    upsample in the compute dtype (the JAX head returns f32 logits)."""

    @nn.compact
    def __call__(self, x, train: bool = False):
        dt, sp = self.dtype, self.up_subpixel
        x1, x2, x3, x4, x5 = MobileNetV2Encoder(width_mult=self.width_mult, dtype=dt,
                                                name="backbone")(x, train)
        y = Up(256, dtype=dt, subpixel=sp, name="up1")(x5, x4, train)
        y = Up(128, dtype=dt, subpixel=sp, name="up2")(y, x3, train)
        y = Up(64, dtype=dt, subpixel=sp, name="up3")(y, x2, train)
        y = Up(32, dtype=dt, subpixel=sp, name="up4")(y, x1, train)
        y = OutConv(self.output_channels, dtype=dt, name="outc")(y, train)
        a_h, a_w = (jnp.asarray(_port_taps_matrix(n), dt) for n in y.shape[1:3])
        y = jnp.einsum("ih,bhwc->biwc", a_h, y)
        return jnp.einsum("jw,biwc->bijc", a_w, y)


def _port_taps_matrix(n: int) -> np.ndarray:
    """[2n, n] align_corners=True x2 matrix with the port's f32 weights."""
    lo, hi, frac = _taps64(n, 2 * n, True)
    frac = frac.astype(np.float32)
    a = np.zeros((2 * n, n), np.float64)
    np.add.at(a, (np.arange(2 * n), lo), np.float32(1.0) - frac)
    np.add.at(a, (np.arange(2 * n), hi), frac)
    return a


@functools.lru_cache(maxsize=None)
def _variables(seed=0):
    """A Flax init with seeded BN statistics, BN affine and conv biases
    (made once per seed; callers only read it)."""
    model = FlaxUNet(output_channels=10, width_mult=WIDTH)
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


def _batches(seed, dtype):
    rng = np.random.RandomState(seed)
    return [(rng.rand(BATCH, *HW, 3).astype(dtype), rng.randint(0, 10, (BATCH, *HW)))
            for _ in range(STEPS)]


# labels offset by this choose the Lovász in the shared f64 step below
LOVASZ_FLAG = 10


def _either_loss():
    """One loss for both f64 trajectories, so that JAX's step is traced and
    compiled once: labels offset by LOVASZ_FLAG take the Lovász, plain ones
    CE (``jnp.where`` passes the chosen loss's gradient alone), as
    tests/test_torch_port_mesh.py's mesh step does."""
    ce, lovasz = jax_make_loss_fn("ce"), jax_make_loss_fn("lovasz")

    def loss_fn(logits, labels):
        flag = jnp.max(labels) >= LOVASZ_FLAG
        labels = labels % LOVASZ_FLAG
        return jnp.where(flag, lovasz(logits, labels), ce(logits, labels))

    return loss_fn


@functools.lru_cache(maxsize=None)
def _jax_f64_step():
    """(model, tx, jitted step) of both f64 trajectories: one tx object, so
    both states have one tree and the step traces once."""
    fm = _FlaxUNetF64Head(output_channels=10, width_mult=WIDTH, up_subpixel=False,
                          dtype=jnp.float64)
    return (fm, optax.adam(LR, b1=0.9, b2=0.999, eps=1e-8),
            jax_make_train_step(donate=False, loss_fn=_either_loss()))


def _jax_run(variables, batches, loss, dtype, subpixel, steps):
    if dtype == jnp.float64 and not subpixel:
        fm, tx, step = _jax_f64_step()
        offset = LOVASZ_FLAG if loss == "lovasz" else 0
    else:
        fm = _FlaxUNetF64Head(output_channels=10, width_mult=WIDTH, up_subpixel=subpixel,
                              dtype=dtype)
        tx = optax.adam(LR, b1=0.9, b2=0.999, eps=1e-8)
        step, offset = jax_make_train_step(donate=False, loss_fn=jax_make_loss_fn(loss)), 0
    cast = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), t)
    state = TrainState.create(apply_fn=fm.apply, params=cast(variables["params"]),
                              batch_stats=cast(variables["batch_stats"]), tx=tx)
    losses = []
    for x, y in batches[:steps]:
        state, metrics = step(state, jnp.asarray(x), jnp.asarray(y + offset))
        losses.append(float(metrics["loss"]))
    return losses, {"params": state.params, "batch_stats": state.batch_stats}


def _port_run(variables, batches, loss, dtype, subpixel, steps):
    model = build_model(ModelConfig(width_mult=WIDTH, up_subpixel=subpixel)).to(dtype)
    model.load_state_dict(state_dict_from_flax(variables, dtype=dtype), strict=True)
    step = make_train_step(model, Optimizer(model.parameters(), lr=LR),
                           loss_fn=make_loss_fn(loss))
    losses = [float(step(torch.from_numpy(x), torch.from_numpy(y))["loss"])
              for x, y in batches[:steps]]
    return losses, model.state_dict()


@pytest.mark.parametrize("loss", ["ce", "lovasz"])
def test_f64_three_step_trajectory_matches_jax(loss):
    variables, batches = _variables(), _batches(1, np.float64)
    jax.config.update("jax_enable_x64", True)
    try:
        want_losses, want_vars = _jax_run(variables, batches, loss, jnp.float64, False, STEPS)
        want = state_dict_from_flax(want_vars, dtype=torch.float64)
    finally:
        jax.config.update("jax_enable_x64", False)
    got_losses, got = _port_run(variables, batches, loss, torch.float64, False, STEPS)
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-9)
    assert set(got) == set(want)
    n_stats = 0
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        g = got[k].numpy()
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(g, w.numpy(), rtol=1e-9, atol=1e-10, err_msg=k)
            n_stats += 1
        else:
            np.testing.assert_allclose(g, w.numpy(), rtol=1e-6, atol=1e-8, err_msg=k)
    assert n_stats > 100
    assert got["backbone.features.0.1.num_batches_tracked"] == STEPS


def test_f32_subpixel_step_matches_jax():
    """The slice's routing (subpixel decoder in train mode) in f32, one
    step: the loss at rtol 1e-5, and the BN running statistics it updates
    at rtol 1e-3 / atol 1e-4: f32 convs summed in another order through 17
    blocks move a running mean of ~0.01 by ~1e-5 (measured)."""
    variables, batches = _variables(1), _batches(2, np.float32)
    want_losses, want_vars = _jax_run(variables, batches, "lovasz", jnp.float32, True, 1)
    got_losses, got = _port_run(variables, batches, "lovasz", torch.float32, True, 1)
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-5)
    want = state_dict_from_flax(want_vars)
    for k in want:
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-3,
                                       atol=1e-4, err_msg=k)
