"""The port's losses and metrics (tpuseg_torch/train/{loss,metrics}.py)
against the JAX package's ``make_loss_fn`` and metrics.

Every loss name of ``make_loss_fn``, with its options, on the same seeded
f32 logits and targets: the value at rtol 1e-5 / abs 1e-6 and d/dlogits
(``jax.grad`` against autograd) at atol 1e-6, f32 sums taken in another
order. On the CPU the JAX lovasz path at 256 bins is the XLA scan and the
port's is the kernels' plain versions; no error is exactly 1.0 here, where
the two agree (tests/test_torch_port_lovasz.py covers that case). The
refusals raise the same errors with the same messages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuseg.train import metrics as jmetrics
from tpuseg.train.loss import make_loss_fn as jax_make_loss_fn
from tpuseg_torch.train import metrics
from tpuseg_torch.train.loss import make_loss_fn

C = 6
WEIGHTS = (1.0, 2.0, 0.5, 3.0, 1.5, 0.25)

CASES = {
    "ce": dict(name="ce"),
    "ce-weights-smoothing-ignore": dict(name="ce", class_weights=WEIGHTS,
                                        label_smoothing=0.1, ignore_index=255),
    "ce-smoothing": dict(name="ce", label_smoothing=0.2),
    "focal": dict(name="focal"),
    "focal-weights-ignore": dict(name="focal", focal_gamma=1.5, class_weights=WEIGHTS,
                                 ignore_index=255),
    "dice": dict(name="dice"),
    "dice-ignore": dict(name="dice", ignore_index=255),
    "ce+dice": dict(name="ce+dice", dice_weight=0.3, class_weights=WEIGHTS),
    "lovasz": dict(name="lovasz"),
    "lovasz-exact-ignore": dict(name="lovasz", lovasz_bins=0, ignore_index=255),
    "lovasz-64": dict(name="lovasz", lovasz_bins=64),
    "ce+lovasz": dict(name="ce+lovasz", class_weights=WEIGHTS, label_smoothing=0.1),
}


def _inputs(seed, ignore):
    rng = np.random.RandomState(seed)
    logits = rng.randn(2, 12, 20, C).astype(np.float32) * 2
    targets = rng.randint(0, C, (2, 12, 20))
    if ignore is not None:
        targets[:, :2] = ignore
    return logits, targets


@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_loss_value_and_gradient_match_jax(case):
    kw = CASES[case]
    logits, targets = _inputs(len(case), kw.get("ignore_index"))
    jfn = jax_make_loss_fn(**kw)
    f = lambda lg: jfn(lg, jnp.asarray(targets))
    want = float(f(jnp.asarray(logits)))
    g_want = np.asarray(jax.grad(f)(jnp.asarray(logits)))
    lg = torch.from_numpy(logits).requires_grad_(True)
    got = make_loss_fn(**kw)(lg, torch.from_numpy(targets))
    got.backward()
    assert float(got.detach()) == pytest.approx(want, rel=1e-5, abs=1e-6)
    np.testing.assert_allclose(lg.grad.numpy(), g_want, atol=1e-6)


@pytest.mark.parametrize("kw", [
    dict(name="dice", class_weights=WEIGHTS), dict(name="lovasz", class_weights=WEIGHTS),
    dict(name="dice", label_smoothing=0.1), dict(name="lovasz", label_smoothing=0.1),
    dict(name="focal", label_smoothing=0.1), dict(name="nope"),
], ids=["dice-weights", "lovasz-weights", "dice-smoothing", "lovasz-smoothing",
        "focal-smoothing", "unknown"])
def test_refusals_match_jax(kw):
    with pytest.raises(ValueError) as want:
        jax_make_loss_fn(**kw)
    with pytest.raises(ValueError) as got:
        make_loss_fn(**kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name", ["ce", "dice", "lovasz", "ce+lovasz"])
def test_a_mesh_of_one_rank_is_the_single_process_loss(name):
    """A mesh of one rank (no process group) and ``spatial`` without a
    mesh give the single-process loss, as the JAX factory ignores a mesh of
    one device; the multi-rank losses are in tests/test_torch_port_mesh.py."""
    from tpuseg_torch.core.mesh import create_mesh

    logits, targets = _inputs(0, 255)
    lg, tg = torch.from_numpy(logits), torch.from_numpy(targets)
    want = make_loss_fn(name, ignore_index=255)(lg, tg)
    assert create_mesh().size == 1
    for kw in (dict(mesh=create_mesh()), dict(spatial=True)):
        assert torch.equal(make_loss_fn(name, ignore_index=255, **kw)(lg, tg), want)


def test_losses_keep_float64():
    logits, targets = _inputs(0, None)
    lg = torch.from_numpy(logits.astype(np.float64))
    for name in ("ce", "lovasz", "ce+lovasz"):
        assert make_loss_fn(name)(lg, torch.from_numpy(targets)).dtype == torch.float64


def test_metrics_match_jax():
    rng = np.random.RandomState(5)
    preds = rng.randint(0, C, (3, 8, 9))
    labels = rng.randint(0, C, (3, 8, 9))
    labels[0, :2] = 255                 # out of range: counts nowhere
    labels[1, 0] = -1
    labels[:, :, 0] = 4                 # class 5 may be absent: NaN IoU handling
    want = np.asarray(jmetrics.confusion_matrix(jnp.asarray(preds), jnp.asarray(labels), C))
    got = metrics.confusion_matrix(torch.from_numpy(preds), torch.from_numpy(labels), C)
    np.testing.assert_array_equal(got.numpy(), want)
    cm = np.zeros((C, C), np.int64)
    cm[:3, :3] = got.numpy()[:3, :3]    # classes 3..5 absent from both
    np.testing.assert_array_equal(metrics.iou_from_confusion(cm),
                                  jmetrics.iou_from_confusion(cm))
    assert metrics.mean_iou(cm) == jmetrics.mean_iou(cm)
    assert np.isnan(metrics.mean_iou(np.zeros((C, C))))
    assert metrics.pixel_accuracy_from_confusion(cm) == \
        jmetrics.pixel_accuracy_from_confusion(cm)
