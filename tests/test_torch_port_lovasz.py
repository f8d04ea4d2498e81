"""The port's Lovász op (tpuseg_torch/ops/lovasz.py) against the JAX package.

On the CPU the port's wrappers run their plain versions; the JAX side runs
its Pallas kernels ``_histograms``/``_lookup``/``lovasz_binned_pallas`` in
interpret mode, as tests/test_loss.py does. The same seeded numpy errors go
to both. Tolerances are JAX's own for the kernels against the scan
(tests/test_loss.py: 2e-6 on the value, 1e-6 on the gradient); counts and
fg sums are sums of 0s and 1s and must be equal, and so must the looked-up
coefficients. Error sums are f32 sums in another order (rtol 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuseg.ops.lovasz_pallas import (_coefficients, _histograms, _lookup,
                                      lovasz_binned_pallas)
from tpuseg.train.loss import _binned_lovasz
from tpuseg.train.loss import lovasz_softmax_loss as jax_lovasz
from tpuseg_torch.ops import lovasz
from tpuseg_torch.ops.kernels import launches
from tpuseg_torch.train.loss import lovasz_errors, lovasz_softmax_loss

# (B, H, W, C); the second has an odd P = 111
SHAPES = [(2, 16, 24, 10), (1, 3, 37, 4)]


def _logits_targets(shape, seed):
    rng = np.random.RandomState(seed)
    b, h, w, c = shape
    return (rng.randn(b, h, w, c).astype(np.float32) * 2,
            rng.randint(0, c, (b, h, w)))


def _planes(shape, seed, saturate=0):
    """errors, fg as f32 numpy [C, P]. ``saturate`` pixels get a softmax
    that put all its mass on the next class (e = 1.0 exactly on the label
    and on that class, 0 elsewhere), and as many more put 0.999 there
    (e = 0.999, the same bin of the kernel, another level of the scan)."""
    logits, targets = _logits_targets(shape, seed)
    e, fg = lovasz_errors(torch.from_numpy(logits), torch.from_numpy(targets))
    e, fg = e.numpy().copy(), fg.numpy()
    wrong = np.roll(fg, 1, axis=0)            # the next class's one-hot
    for lo, top in ((0, 1.0), (saturate, 0.999)):
        s = slice(lo, lo + saturate)
        e[:, s] = np.float32(top) * (fg[:, s] + wrong[:, s])
    return e, fg


@pytest.mark.parametrize("shape", SHAPES)
def test_histograms_match_the_interpret_kernel(shape):
    e, fg = _planes(shape, 0)
    want = _histograms(jnp.asarray(e), jnp.asarray(fg), interpret=True)
    before = dict(launches)
    got = lovasz.lovasz_histograms(torch.from_numpy(e), torch.from_numpy(fg))
    assert launches == before          # a CPU tensor runs the plain version
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=1e-5, atol=1e-6)
    assert float(got[0].sum()) == e.size


@pytest.mark.parametrize("shape", SHAPES)
def test_coefficients_and_lookup_match_the_interpret_kernel(shape):
    e, fg = _planes(shape, 1)
    hists = _histograms(jnp.asarray(e), jnp.asarray(fg), interpret=True)
    coef_j, value_j = _coefficients(*hists)
    coef, value = lovasz.coefficients(*(torch.tensor(np.asarray(h)) for h in hists))
    np.testing.assert_allclose(coef.numpy(), np.asarray(coef_j), rtol=1e-6, atol=1e-9)
    assert float(value) == pytest.approx(float(value_j), abs=2e-6)
    w_j = _lookup(jnp.asarray(e), coef_j, interpret=True)
    w = lovasz.lovasz_lookup(torch.from_numpy(e), torch.tensor(np.asarray(coef_j)))
    np.testing.assert_array_equal(w.numpy(), np.asarray(w_j))


def _value_and_grad(e, fg):
    et = torch.from_numpy(e).requires_grad_(True)
    v = lovasz.lovasz_binned_kernel(et, torch.from_numpy(fg))
    v.backward()
    return float(v.detach()), et.grad.numpy()


@pytest.mark.parametrize("shape", SHAPES)
def test_autograd_op_matches_lovasz_binned_pallas(shape):
    e, fg = _planes(shape, 2)
    ej, fgj = jnp.asarray(e), jnp.asarray(fg)
    want = float(lovasz_binned_pallas(ej, fgj, interpret=True))
    g_want = jax.grad(lambda x: lovasz_binned_pallas(x, fgj, interpret=True))(ej)
    value, grad = _value_and_grad(e, fg)
    assert value == pytest.approx(want, abs=2e-6)
    np.testing.assert_allclose(grad, np.asarray(g_want), atol=1e-6)
    # the plain op is the same function
    ep = torch.from_numpy(e).requires_grad_(True)
    lovasz.lovasz_binned_plain(ep, torch.from_numpy(fg)).backward()
    np.testing.assert_array_equal(ep.grad.numpy(), grad)


def test_errors_of_exactly_one_follow_the_kernel_not_the_scan():
    """With errors exactly 1.0 the port follows the JAX kernel, which clips
    e = 1.0 into bin 255 (lovasz_pallas.py:60). The JAX XLA scan
    (loss.py::_binned_lovasz) gives e = 1.0 a level of its own, so there
    the two JAX paths disagree: measured on the CPU on such an input,
    by 4.6e-6 in the value and 1.0e-3 in the gradient. The port is held to
    the kernel at the kernel's own tolerances, and this input is checked to
    be one where the scan's gradient does differ."""
    e, fg = _planes((2, 16, 24, 10), 3, saturate=40)
    assert int((e == 1.0).sum()) >= 40
    ej, fgj = jnp.asarray(e), jnp.asarray(fg)
    want = float(lovasz_binned_pallas(ej, fgj, interpret=True))
    g_want = jax.grad(lambda x: lovasz_binned_pallas(x, fgj, interpret=True))(ej)
    value, grad = _value_and_grad(e, fg)
    assert value == pytest.approx(want, abs=2e-6)
    np.testing.assert_allclose(grad, np.asarray(g_want), atol=1e-6)
    g_scan = jax.grad(lambda x: _binned_lovasz(x, fgj, 256, jnp.float32))(ej)
    assert float(np.abs(np.asarray(g_scan) - grad).max()) > 1e-4


@pytest.mark.parametrize("bins,ignore", [(0, None), (0, 255), (64, None), (64, 255),
                                         (256, 255)])
def test_lovasz_softmax_loss_matches_jax(bins, ignore):
    """The loss from logits, against JAX's lovasz_softmax_loss (on the CPU
    its bins=256 path is the scan; no error is exactly 1.0 here): value at
    abs 2e-6 and d/dlogits at atol 1e-6, the same as the kernel tests."""
    logits, targets = _logits_targets((2, 16, 24, 6), 4)
    if ignore is not None:
        targets[:, :3] = ignore
    fn = lambda lg: jax_lovasz(lg, jnp.asarray(targets), ignore_index=ignore, bins=bins)
    want = float(fn(jnp.asarray(logits)))
    g_want = np.asarray(jax.grad(fn)(jnp.asarray(logits)))
    lg = torch.from_numpy(logits).requires_grad_(True)
    got = lovasz_softmax_loss(lg, torch.from_numpy(targets), ignore_index=ignore, bins=bins)
    got.backward()
    assert float(got.detach()) == pytest.approx(want, abs=2e-6)
    np.testing.assert_allclose(lg.grad.numpy(), g_want, atol=1e-6)


def test_counts_stay_exact_past_2_24_pixels():
    """A float32 sum of ones stops at 2**24. The histograms sum in float64
    and round once, so a bin of 2**24 + 3 pixels counts 2**24 + 4, the
    nearest float32, and not 2**24."""
    p = (1 << 24) + 3
    e = torch.zeros(1, p)
    n, f, _ = lovasz.lovasz_histograms(e, torch.ones_like(e))
    want = float(np.float32(p))
    assert want == 2.0**24 + 4
    assert float(n[0, 0]) == want and float(f[0, 0]) == want and float(n.sum()) == want


def test_wrappers_validate_shapes_and_the_sharded_op_runs_on_one_rank():
    e = torch.zeros(3, 5)
    with pytest.raises(ValueError, match=r"\[C, P\]"):
        lovasz.lovasz_histograms(e.reshape(-1), e.reshape(-1))
    with pytest.raises(ValueError, match="differ"):
        lovasz.lovasz_histograms(e, torch.zeros(3, 4))
    with pytest.raises(ValueError, match="coef"):
        lovasz.lovasz_lookup(e, torch.zeros(3, 128))
    # one rank: the sharded op is the binned op on the logits (the
    # multi-rank cases are in tests/test_torch_port_mesh.py)
    from tpuseg_torch.core.mesh import create_mesh
    from tpuseg_torch.train.loss import lovasz_softmax_loss

    rng = np.random.RandomState(2)
    logits = torch.from_numpy(rng.randn(2, 4, 6, 5).astype(np.float32))
    targets = torch.from_numpy(rng.randint(0, 5, (2, 4, 6)))
    a, b = logits.clone().requires_grad_(True), logits.clone().requires_grad_(True)
    v = lovasz.make_sharded_lovasz(create_mesh())(a, targets)
    w = lovasz_softmax_loss(b, targets, bins=256)
    v.backward()
    w.backward()
    assert float(v.detach()) == pytest.approx(float(w.detach()), abs=1e-6)
    torch.testing.assert_close(a.grad, b.grad, rtol=0, atol=1e-8)
    # e < 0 enters no bin and gets w = 0, as the TPU kernel's padding does
    e = torch.tensor([[-1.0, 0.5, 1.0, 2.0]])
    n, f, s = lovasz.lovasz_histograms(e, torch.ones_like(e))
    assert float(n.sum()) == 3 and float(n[0, 255]) == 2 and float(n[0, 128]) == 1
    w = lovasz.lovasz_lookup(e, torch.arange(256.0)[None])
    assert w.tolist() == [[0.0, 128.0, 255.0, 255.0]]
