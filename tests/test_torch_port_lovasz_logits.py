"""The fused Lovász region's plain route (tpuseg_torch/ops/lovasz.py) against
the JAX package.

On the CPU ``lovasz_logits_histograms`` and ``lovasz_logits_grad`` run their
plain versions. They are held against the pieces of the region of
``lovasz_pallas.make_sharded_lovasz``: the planes built from the logits as
that region builds them, its Pallas kernels ``_histograms`` and ``_lookup``
in interpret mode, ``_coefficients`` and its closed-form softmax chain; then
against the whole JAX region on a one-device mesh, and the one-card loss
against ``lovasz_binned_pallas`` with autodiff through the softmax. The
tolerances are the kernel tests' (tests/test_torch_port_lovasz.py): the
value within 2e-6, the gradient within 1e-6, counts and fg sums equal,
error sums within rtol 1e-5. The JAX kernels take float32 only (interpret
mode refuses float64), so float64 logits are held against the JAX region
on the same logits in float32, at the same tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from tpuseg.ops.lovasz_pallas import (_coefficients, _histograms, _lookup,
                                      lovasz_binned_pallas)
from tpuseg.ops.lovasz_pallas import make_sharded_lovasz as jax_sharded_lovasz
from tpuseg.train.loss import make_loss_fn as jax_make_loss_fn
from tpuseg_torch.core.mesh import create_mesh
from tpuseg_torch.ops import lovasz
from tpuseg_torch.ops.kernels import launches
from tpuseg_torch.train.loss import lovasz_softmax_loss, make_loss_fn

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float64": torch.float64}
# (classes, ignore_index, logits dtype): each value of each axis, C = 5 and
# 10; then 66 with ignore 255 and on bf16 logits, past the 32 classes above
# which the card runs the class-group kernels (33 and 150 are cases of the
# tests below: each new class count costs a few seconds of JAX compiles)
CASES = [(5, None, "float32"), (5, 255, "bfloat16"), (10, None, "float64"),
         (10, 255, "float32"), (10, 255, "bfloat16"), (5, 255, "float64"),
         (66, 255, "float32"), (66, None, "bfloat16")]


def _inputs(c, ignore, dtype, seed, shape=(2, 8, 12)):
    """(torch logits of ``dtype``, torch int64 targets, the float32 numpy
    logits JAX gets: the torch logits widened). With ``ignore``, a column
    and a few scattered pixels carry it."""
    rng = np.random.RandomState(seed)
    x = torch.from_numpy((rng.randn(*shape, c) * 2).astype(np.float64)).to(DTYPES[dtype])
    t = rng.randint(0, c, shape)
    if ignore is not None:
        t[:, :, 0] = ignore
        t.reshape(-1)[rng.choice(t.size, 7, replace=False)] = ignore
    return x, torch.from_numpy(t), x.to(torch.float32).numpy()


def _jax_region(logits, targets, ignore):
    """The region of ``lovasz_pallas.make_sharded_lovasz`` on one block
    (no psum): (histograms, value, logits gradient), from its own pieces."""
    logits, targets = jnp.asarray(logits), jnp.asarray(targets)
    c = logits.shape[-1]
    probs = jnp.exp(jax.nn.log_softmax(logits, axis=-1))
    fg = jnp.reshape(jax.nn.one_hot(targets, c, dtype=logits.dtype), (-1, c)).T
    pr = jnp.reshape(probs, (-1, c)).T
    errors = jnp.abs(fg - pr)
    valid = None
    if ignore is not None:
        valid = (targets != ignore).astype(logits.dtype).reshape(1, -1)
        fg, errors = fg * valid, errors * valid
    hists = _histograms(errors, fg, interpret=True)
    coef, value = _coefficients(*hists)
    w = _lookup(errors, coef, interpret=True)
    wt = w * jnp.sign(pr - fg)
    if valid is not None:
        wt = wt * valid
    wp = jnp.reshape(wt.T, probs.shape) * probs
    grad = wp - probs * jnp.sum(wp, axis=-1, keepdims=True)
    return [np.asarray(h) for h in hists], float(value), np.asarray(grad)


@pytest.mark.parametrize("c,ignore,dtype", CASES)
def test_plain_region_matches_the_jax_region_pieces(c, ignore, dtype):
    x, t, x32 = _inputs(c, ignore, dtype, seed=c)
    hists_j, value_j, grad_j = _jax_region(x32, t.numpy(), ignore)
    before = dict(launches)
    hist = lovasz.lovasz_logits_histograms(x, t, ignore)
    value, grad = lovasz.lovasz_logits_grad(x, t, hist, ignore)
    assert launches == before          # CPU tensors run the plain versions
    want_dtype = torch.float64 if dtype == "float64" else torch.float32
    assert hist.shape == (3, c, 256) and hist.dtype == want_dtype
    assert grad.shape == x.shape and grad.dtype == want_dtype
    np.testing.assert_array_equal(hist[0].numpy(), hists_j[0])
    np.testing.assert_array_equal(hist[1].numpy(), hists_j[1])
    np.testing.assert_allclose(hist[2].numpy(), hists_j[2], rtol=1e-5, atol=1e-6)
    assert float(hist[0].sum()) == t.numel() * c
    assert float(value) == pytest.approx(value_j, abs=2e-6)
    np.testing.assert_allclose(grad.numpy(), grad_j, atol=1e-6)


@pytest.mark.parametrize("c,ignore", [
    pytest.param(10, None, id="None"), pytest.param(10, 255, id="255"),
    pytest.param(150, None, id="150-None")])
def test_region_matches_jax_make_sharded_lovasz_on_one_device(c, ignore):
    """The autograd op against the whole JAX region (shard_map over a 1x1
    mesh, interpret mode): value and d/dlogits."""
    x, t, x32 = _inputs(c, ignore, "float32", seed=20)
    mesh = JaxMesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "spatial"))
    fn = jax_sharded_lovasz(mesh, ignore_index=ignore, interpret=True)
    tj = jnp.asarray(t.numpy())
    want, g_want = jax.value_and_grad(lambda lg: fn(lg, tj))(jnp.asarray(x32))
    lg = x.clone().requires_grad_(True)
    got = lovasz.make_sharded_lovasz(create_mesh(), ignore_index=ignore)(lg, t)
    got.backward()
    assert float(got.detach()) == pytest.approx(float(want), abs=2e-6)
    np.testing.assert_allclose(lg.grad.numpy(), np.asarray(g_want), atol=1e-6)


@pytest.mark.parametrize("c,ignore,dtype", [(5, None, "float32"), (10, 255, "float32"),
                                            (10, None, "bfloat16"), (5, 255, "float64"),
                                            (33, 255, "float32"), (150, None, "float32")])
def test_one_card_loss_matches_lovasz_binned_pallas(c, ignore, dtype):
    """``lovasz_softmax_loss(bins=256)`` (the fused op, closed-form
    gradient) against ``lovasz_binned_pallas(interpret=True)`` on the
    planes of the same logits, differentiated by JAX through the softmax.
    bf16 logits go to JAX as bf16 and are widened first, as the region
    does, so both sides round the gradient to bf16 at the end."""
    x, t, x32 = _inputs(c, ignore, dtype, seed=30 + c)
    tj = jnp.asarray(t.numpy())
    xj = jnp.asarray(x32, dtype=jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)

    def jax_loss(lg):
        lg = lg.astype(jnp.float32)
        fg = jnp.reshape(jax.nn.one_hot(tj, c, dtype=lg.dtype), (-1, c)).T
        pr = jnp.reshape(jnp.exp(jax.nn.log_softmax(lg, axis=-1)), (-1, c)).T
        errors = jnp.abs(fg - pr)
        if ignore is not None:
            valid = (tj != ignore).astype(lg.dtype).reshape(1, -1)
            fg, errors = fg * valid, errors * valid
        return lovasz_binned_pallas(errors, fg, interpret=True)

    want, g_want = jax.value_and_grad(jax_loss)(xj)
    lg = x.clone().requires_grad_(True)
    got = lovasz_softmax_loss(lg, t, ignore_index=ignore, bins=256)
    got.backward()
    assert lg.grad.dtype == x.dtype
    assert float(got.detach()) == pytest.approx(float(want), abs=2e-6)
    np.testing.assert_allclose(lg.grad.to(torch.float32).numpy(),
                               np.asarray(g_want, dtype=np.float32), atol=1e-6)


@pytest.mark.parametrize("ignore", [None, 255])
def test_fused_route_equals_the_plane_composition(ignore):
    """On the CPU the fused route's plain versions are the plane route's
    steps split at the all_reduce: ``sharded_lovasz_parts`` on the plain
    plane functions gives the same value, histograms and gradient bit for
    bit, and so does the op built on the plain versions."""
    x, t, _ = _inputs(10, ignore, "float32", seed=40)
    value, hist, grad = lovasz.lovasz_logits_parts(x, t, None, False, ignore)
    value_p, coef_p, grad_p = lovasz.sharded_lovasz_parts(
        x, t, None, False, ignore, lovasz.lovasz_histograms_plain, lovasz.lovasz_lookup_plain)
    assert torch.equal(value, value_p) and torch.equal(grad, grad_p)
    assert torch.equal(lovasz.coefficients(*hist)[0], coef_p)
    a, b = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    va = lovasz.lovasz_logits_loss(a, t, ignore)
    vb = lovasz.lovasz_logits_loss_plain(b, t, ignore)
    (va + vb).backward()
    assert torch.equal(va.detach(), value) and torch.equal(a.grad, grad)
    assert torch.equal(a.grad, b.grad)


def test_strided_targets_and_wrapper_checks():
    """An H-slab of the labels (the spatial step's targets: a batch stride
    of the whole image) gives what its contiguous copy gives; the wrappers
    refuse shapes they cannot take."""
    x, t, _ = _inputs(5, 255, "float32", seed=50, shape=(2, 8, 12))
    slab_t = t[:, 2:6]                        # not contiguous: batch stride 96
    slab_x = x[:, 2:6].contiguous()
    assert not slab_t.is_contiguous()
    a = lovasz.lovasz_logits_parts(slab_x, slab_t, None, False, 255)
    b = lovasz.lovasz_logits_parts(slab_x, slab_t.contiguous(), None, False, 255)
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    with pytest.raises(ValueError, match=r"\[B, H, W, C\]"):
        lovasz.lovasz_logits_histograms(x.reshape(-1, 5), t.reshape(-1))
    with pytest.raises(ValueError, match="targets"):
        lovasz.lovasz_logits_histograms(x, t[:, :4])
    with pytest.raises(ValueError, match="hist"):
        lovasz.lovasz_logits_grad(x, t, torch.zeros(3, 4, 256))


def test_ce_plus_lovasz_matches_jax_at_66_classes():
    """The slice's loss as a whole at Mapillary Vistas' 66 classes: the
    port's ``make_loss_fn("ce+lovasz")`` (CE plus the fused op's plain
    route) against JAX's on [2, 16, 32, 66] logits, the value at rtol 1e-5 /
    abs 1e-6 and d/dlogits at atol 1e-6, as tests/test_torch_port_loss.py
    holds every loss (on the CPU JAX's Lovász at 256 bins is its XLA scan,
    which agrees with the kernels' binning where no error is exactly 1.0)."""
    x, t, x32 = _inputs(66, None, "float32", seed=60, shape=(2, 16, 32))
    tj = jnp.asarray(t.numpy())
    jfn = jax_make_loss_fn("ce+lovasz")
    want, g_want = jax.jit(jax.value_and_grad(lambda lg: jfn(lg, tj)))(jnp.asarray(x32))
    lg = x.clone().requires_grad_(True)
    got = make_loss_fn("ce+lovasz")(lg, t)
    got.backward()
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-5, abs=1e-6)
    np.testing.assert_allclose(lg.grad.numpy(), np.asarray(g_want), atol=1e-6)
