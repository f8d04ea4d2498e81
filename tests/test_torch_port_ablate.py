"""The port's ablation tools (``tpuseg_torch/tools/ablate_forward.py``,
``ablate_train.py``) against the JAX package's ``tools/ablate_forward.py``
and ``tools/ablate_train.py``.

The flagship at width_mult 0.25, fp32, 32x64, batch 2, with the jittered
JAX weights carried across (``tests/torch_port_quant_inputs.py``). Every
row's value is held against the same prefix of the JAX model (the JAX
tool's ``Partial``, rebuilt here at this width; its ``loss_of`` and
value_and_grad), relative to the value's magnitude:

- forward rows: the sum of the taps, of the logits and of the upsampled
  logits within 1e-4; the sum of the argmax picks equal up to 9 for each
  pixel whose top-two logits the JAX model puts within 1e-4 (none here at
  these weights, in practice);
- train rows: the loss within 1e-4 (train-mode BatchNorm over batch 2
  normalizes the 1x2 bottom grid by tiny variances, which carry fp32
  differences of ~2e-5 into the loss); the gradient sum, a sum of
  thousands of terms that cancel, against the sum of the gradients'
  magnitudes: within 1e-5 with BatchNorm in eval mode (2e-7 measured), 1e-3
  in train mode (3.1e-4 measured at 32x64, 2.3e-4 at 64x128: the batch
  statistics' backward subtracts per-channel means of large terms); the
  ``full`` row's first loss (the train step's, before its update) within
  1e-4 of JAX's train-mode loss of the same state, and the step moving the
  parameters and the BatchNorm statistics.

Both tools' ``main`` runs at a tiny size on the CPU (their ``build`` function
swapped for this width) and prints the JAX tools' lines and JSON keys.
"""

from __future__ import annotations

import json

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_quant_inputs import HW, family, two_threads  # noqa: F401
from tpuseg.models.blocks import OutConv, Up
from tpuseg.models.mobilenetv2 import MobileNetV2Encoder
from tpuseg.ops.resize import upsample2x_bilinear
from tpuseg.train.loss import cross_entropy_loss
from tpuseg_torch.core.weights import state_dict_from_flax
from tpuseg_torch.models.blocks import frozen_running_stats
from tpuseg_torch.tools import ablate_forward, ablate_train
from tpuseg_torch.train.loss import cross_entropy_loss as port_ce
from tpuseg_torch.train.train_step import forward_nhwc

WIDTH, BATCH = 0.25, 2
VALUE_RTOL, LOSS_RTOL, TIE = 1e-4, 1e-4, 1e-4
# the gradient sum against the sum of the gradients' magnitudes, by BatchNorm mode
GRAD_RTOL = {False: 1e-5, True: 1e-3}


class Prefixes(nn.Module):
    """The JAX tool's ``Partial`` at ``width_mult``, fp32, returning every
    stage's value (and the upsampled logits, for the near-tie count)."""

    width_mult: float
    subpixel: bool = True

    @nn.compact
    def __call__(self, x):
        taps = MobileNetV2Encoder(width_mult=self.width_mult, name="backbone")(x, False)
        enc = sum(jnp.sum(t.astype(jnp.float32)) for t in taps)
        x1, x2, x3, x4, x5 = taps
        sp = self.subpixel
        y = Up(256, subpixel=sp, name="up1")(x5, x4, False)
        y = Up(128, subpixel=sp, name="up2")(y, x3, False)
        y = Up(64, subpixel=sp, name="up3")(y, x2, False)
        y = Up(32, subpixel=sp, name="up4")(y, x1, False)
        y = OutConv(10, name="outc")(y, False)
        dec = jnp.sum(y.astype(jnp.float32))
        up = upsample2x_bilinear(y.astype(jnp.float32), align_corners=True)
        picks = jnp.sum(jnp.argmax(up, axis=-1)).astype(jnp.float32)
        return {"encoder": enc, "decoder": dec, "final_up": jnp.sum(up), "argmax": picks}, up


@pytest.fixture(scope="module")
def flagship():
    jm, v, pm = family("mobilenetv2_unet")
    sd = state_dict_from_flax(v)
    pm.load_state_dict(sd)
    pm.eval()
    rng = np.random.RandomState(0)
    x = rng.rand(BATCH, *HW, 3).astype(np.float32)
    y = rng.randint(0, 10, (BATCH, *HW))
    return jm, v, pm, sd, x, y


@pytest.mark.parametrize("subpixel", [True, False], ids=["subpixel", "materialized"])
def test_forward_rows_match_jax_prefixes(flagship, subpixel):
    _, v, pm, _, x, _ = flagship
    want, up = jax.jit(Prefixes(WIDTH, subpixel).apply)(v, x)
    top2 = np.sort(np.asarray(up), axis=-1)[..., -2:]
    near_ties = int(((top2[..., 1] - top2[..., 0]) < TIE).sum())
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        for stage in ablate_forward.STAGES:
            got = float(ablate_forward.prefix(pm, stage, subpixel)(xt))
            w = float(want[stage])
            if stage == "argmax":
                assert abs(got - w) <= 9 * near_ties, (got, w, near_ties)
            else:
                assert abs(got - w) <= VALUE_RTOL * abs(w), (stage, got, w)


def _jax_loss_and_grad_sum(jm, v, x, y, train):
    def loss_of(params):
        out = jm.apply({"params": params, "batch_stats": v["batch_stats"]}, x, train=train,
                       mutable=["batch_stats"] if train else False)
        return cross_entropy_loss(out[0] if train else out, y)

    loss, grads = jax.jit(jax.value_and_grad(loss_of))(v["params"])
    leaves = jax.tree_util.tree_leaves(grads)
    return (float(loss), float(sum(jnp.sum(g) for g in leaves)),
            float(sum(jnp.sum(jnp.abs(g)) for g in leaves)))


@pytest.fixture(scope="module")
def jax_rows(flagship):
    """{train: (loss, gradient sum, sum of |gradient|)} of the JAX model."""
    jm, v, _, _, x, y = flagship
    return {train: _jax_loss_and_grad_sum(jm, v, x, y, train) for train in (False, True)}


def test_train_rows_match_jax(flagship, jax_rows):
    _, _, pm, sd, x, y = flagship
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    params = list(pm.parameters())
    want = jax_rows
    for row in ablate_train.ROWS:
        train = row in ("fwd_train", "grad")
        loss, gsum, gabs = want[train]
        got = float(ablate_train.row_fn(pm, row)(xt, yt))
        assert abs(got - loss) <= LOSS_RTOL * abs(loss), (row, got, loss)
        if row.startswith("grad"):
            # the row's value hides the gradient sum under 1e-20: read it
            # from the same backward
            pm.train(train)
            with frozen_running_stats():
                grads = torch.autograd.grad(port_ce(forward_nhwc(pm, xt), yt), params)
            got_g = float(sum(g.double().sum() for g in grads))
            assert abs(got_g - gsum) <= GRAD_RTOL[train] * gabs, (row, got_g, gsum, gabs)
    # the rows leave the model as it was
    for k, t in pm.state_dict().items():
        assert torch.equal(t, sd[k]), k


def test_full_row_is_the_train_step(flagship, jax_rows):
    """``full`` is the real step: its first loss is the train-mode loss of
    the initial state (JAX's), and each call moves the parameters and the
    BatchNorm statistics."""
    _, _, pm, sd, x, y = flagship
    loss = jax_rows[True][0]
    full = ablate_train.full_step(pm)
    got = [float(full(torch.from_numpy(x), torch.from_numpy(y))["loss"]) for _ in range(2)]
    after = {k: t.clone() for k, t in pm.state_dict().items()}
    pm.load_state_dict(sd)
    assert abs(got[0] - loss) <= LOSS_RTOL * abs(loss), (got, loss)
    assert got[1] != got[0]
    for k in ("up1.conv.conv.0.weight", "outc.conv.3.weight", "backbone.features.0.1.running_var"):
        assert k in after and not torch.equal(after[k], sd[k]), k


def test_mains_print_the_jax_tools_lines(monkeypatch, capsys):
    pm = family("mobilenetv2_unet")[2]

    def forward_build(batch, size, device):
        x = torch.from_numpy(np.random.RandomState(0).rand(batch, size, size, 3)
                             .astype(np.float32))
        return pm.eval(), x.permute(0, 3, 1, 2)

    def train_build(batch, height, width, dtype, device):
        rng = np.random.RandomState(0)
        return (pm, torch.from_numpy(rng.rand(batch, height, width, 3).astype(np.float32)),
                torch.from_numpy(rng.randint(0, 10, (batch, height, width))))

    monkeypatch.setattr(ablate_forward, "build", forward_build)
    monkeypatch.setattr(ablate_train, "build", train_build)
    assert ablate_forward.main(["--batch", "1", "--size", "32", "--chain", "1",
                                "--platform", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split(":")[0] for ln in lines[:-1]] == list(ablate_forward.STAGES)
    assert all("ms/iter" in ln and "imgs/s" in ln for ln in lines[:-1])
    rec = json.loads(lines[-1])
    assert list(rec) == ["ms_per_iter", "batch"] and rec["batch"] == 1
    assert list(rec["ms_per_iter"]) == list(ablate_forward.STAGES)

    assert ablate_train.main(["--batch", "1", "--width", "64", "--height", "32", "--chain", "1",
                              "--platform", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    rows = [*ablate_train.ROWS, "full"]
    assert [ln.split(":")[0] for ln in lines[:-1]] == rows
    rec = json.loads(lines[-1])
    assert list(rec) == ["ms_per_iter", "batch", "size"] and rec["size"] == [32, 64]
    assert list(rec["ms_per_iter"]) == rows
