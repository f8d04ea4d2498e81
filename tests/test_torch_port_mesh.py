"""The port's multi-rank path (tpuseg_torch/core/mesh.py and its users)
against the JAX package's mesh, on the CPU over gloo.

Two rank groups (world 2, data only; world 4, data 2 x spatial 2) start
once each, from a module-scoped fixture, through ``launch_local``
(spawned ranks, a FileStore; the workers live in
tests/torch_port_mesh_ranks.py, which imports no JAX). They run in their
own processes while this one computes the JAX oracles, on the 8-device
virtual CPU mesh of tests/conftest.py; the tests parametrise over the
ranks' results.

- The sharded Lovász (``ops/lovasz.py::make_sharded_lovasz``) against
  ``lovasz_pallas.make_sharded_lovasz`` (interpret=True) on a 2x2 CPU
  mesh, on tests/test_loss.py's seeded logits and targets: the port at
  world 4 (data 2 x spatial 2, spatial on and off) and world 2 (data
  only), ignore_index None and 255; value to 1e-6 and gradient to 1e-8
  abs (the JAX test's own tolerances); the gradient assembled from the
  ranks equal, to 1e-8, to one process's, whose largest entry is far above
  1e-8, so a gradient halved or doubled by the world size fails.
- Every loss name at world 2, with class weights where it takes them and
  ignore_index 255, and the Lovász at 64 and 0 bins, in float64: the value
  and the gradient assembled from the ranks equal one process's on the
  global batch (rtol 1e-6); the 64- and 0-bin Lovász also equal JAX's
  ``make_loss_fn`` over ``create_mesh(data=2)``.
- BatchNorm's global statistics (forward, input and affine gradients,
  running statistics) and the clip on the global norm, against one
  process.
- A 3-step f64 trajectory at world 2 against JAX's ``make_train_step``
  over ``create_mesh(data=2)``, at tests/test_torch_port_train.py's
  settings and tolerances (the materialized decoder and f64 head of
  ROADMAP.md C3); the parameters bit-equal across the ranks.
- QAT and distillation together: 2 f64 steps of a UNet (base_filters 4)
  with every conv+BatchNorm conv fake-quantized and a UNet teacher
  (alpha 0.5, T 2, CE with ignore_index 255) at world 2 against JAX's
  ``make_train_step`` over ``create_mesh(data=2)`` with the "qat" markers
  and the teacher: the activation ranges and the KD mean are the global
  batch's in both (losses, parameters and statistics at rtol 1e-6, the
  parameters also at atol 1e-8).
- A 2-step world-2 Trainer through ``tpuseg_torch.main`` against the JAX
  Trainer with ``--mesh.data=2`` (the same records at the same steps, as
  tests/test_torch_port_trainer.py compares one device) and against the
  port's one-process run (losses at rtol 1e-4, float32 sums over two
  halves in another order); rank 0 alone writes the checkpoints, and
  both ranks resume them.
- The spatially sharded train step at world 4 (data 2 x spatial 2):
  ``fetch_rows`` against one process's rows and gradients (halos of 1 and
  6 rows, uneven layers, the clamp); the flagship's 3-step f64
  trajectory with the image height sharded against the same JAX mesh
  step as the world-2 one; one f64 step of every family (the flagship's
  at H 32, whose 1/32 layer is one row) against the port's one-process
  step; the Trainer with ``--mesh.data=2 --mesh.spatial=2`` against the
  JAX spatial Trainer; a height of 15 refused by both.
"""

import concurrent.futures
import functools
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests import torch_port_mesh_ranks as ranks
from tests.test_torch_port_distill import BF as KD_BF, HW as KD_HW, _flax_unet_vars
from tests.test_torch_port_train import LR, WIDTH, _FlaxUNetF64Head, _batches, _variables
from tests.test_torch_port_trainer import JAX_TINY, SOURCES8, _jax_trainer
from tpuseg.core.mesh import batch_sharding as jax_batch_sharding
from tpuseg.core.mesh import create_mesh as jax_create_mesh
from tpuseg.core.mesh import replicated_sharding as jax_replicated_sharding
from tpuseg.ops.lovasz_pallas import make_sharded_lovasz as jax_sharded_lovasz
from tpuseg.train.loss import make_loss_fn as jax_make_loss_fn
from tpuseg.train.train_step import TrainState, make_train_step as jax_make_train_step
from tpuseg_torch.configs import load_config
from tpuseg_torch.core.mesh import Mesh, batch_slice, create_mesh, launch_local
from tpuseg_torch.core.weights import state_dict_from_flax
from tpuseg_torch.models.blocks import BatchNorm2d
from tpuseg_torch.train.loss import lovasz_softmax_loss, make_loss_fn
from tpuseg_torch.train.optim import Optimizer
from tpuseg_torch.train.trainer import Trainer

TIMEOUT = 300
WEIGHTS = (0.5, 1.0, 2.0, 1.5, 0.8, 1.2, 0.7, 1.1, 0.9, 1.3)
TRAINER_FLAGS = ["--train.epochs=2", "--train.steps_per_epoch=1", "--train.loss=ce+lovasz",
                 "--data.val_split=0.25"]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _lovasz_inputs():
    """tests/test_loss.py's sharded-Lovász inputs."""
    rng = np.random.RandomState(0)
    logits = rng.randn(8, 16, 32, 10).astype(np.float32) * 2
    targets = np.asarray(rng.randint(0, 10, (8, 16, 32)))
    targets[0, :3] = 255
    return logits, targets


def _loss_inputs():
    rng = np.random.RandomState(3)
    logits = rng.randn(4, 8, 12, 10) * 2
    targets = rng.randint(0, 10, (4, 8, 12))
    targets[1, :2] = 255
    targets[:, :, 0] = 4
    return logits, targets


def _bn_inputs():
    rng = np.random.RandomState(4)
    x = rng.randn(4, 6, 5, 7) * 2 + 0.5
    return x, rng.randn(*x.shape), rng.uniform(0.5, 1.5, 6), rng.uniform(-0.2, 0.2, 6)


def _clip_inputs():
    """Each rank's part has norm about 1 (under the clip of 1.5), their sum
    about 2."""
    rng = np.random.RandomState(5)
    base = [rng.randn(3, 4), rng.randn(7)]
    norm = np.sqrt(sum((b * b).sum() for b in base))
    parts = [[b / norm for b in base], [b / norm + 0.01 * rng.randn(*b.shape) for b in base]]
    return parts, 1.5, 0.1


SERVE_HW = (64, 128)


def _frames():
    return np.random.RandomState(6).randint(0, 256, (4, 90, 160, 3), dtype=np.uint8)


def _spatial_inputs():
    """tests/test_parallel.py's inputs: a row-index frame (H 16, halo 2),
    three 3x3 convs at halo 4 on [2, 64, 32, 4], one 9x9 conv at halo 1."""
    rows = np.broadcast_to(np.arange(16, dtype=np.float32).reshape(1, 16, 1, 1), (1, 16, 4, 1))
    rng = np.random.RandomState(0)
    kernels = [(rng.randn(3, 3, 4, 4) * 0.2).astype(np.float32) for _ in range(3)]
    stack = rng.rand(2, 64, 32, 4).astype(np.float32)
    rng = np.random.RandomState(1)
    wide_k = (rng.randn(9, 9, 2, 2) * 0.2).astype(np.float32)
    return np.ascontiguousarray(rows), stack, kernels, rng.rand(1, 64, 32, 2).astype(
        np.float32), wide_k


@functools.lru_cache(maxsize=None)
def _trajectory_inputs():
    """The seeded flax variables (an init of several seconds, made once),
    the f64 batches, and the variables as the port's state dict; read only."""
    variables, batches = _variables(), _batches(1, np.float64)
    state = {k: v.numpy() for k, v in state_dict_from_flax(variables,
                                                           dtype=torch.float64).items()}
    return variables, batches, state


@functools.lru_cache(maxsize=None)
def _qat_distill_inputs():
    """Student and teacher flax variables, their port state dicts (f64), and
    2 global batches of 4 with ignored pixels."""
    student, teacher = _flax_unet_vars(11), _flax_unet_vars(12)
    rng = np.random.RandomState(13)
    batches = []
    for _ in range(2):
        y = rng.randint(0, 10, (4, *KD_HW))
        y[:, :3, :5] = 255
        batches.append((rng.rand(4, *KD_HW, 3), y))
    port = lambda v: {k: t.numpy() for k, t in state_dict_from_flax(
        v, dtype=torch.float64).items()}
    return student, teacher, batches, port(student), port(teacher)


# (layer heights for the two data rows, halo, clamp): a 3x3 conv's one row
# at 8 rows a rank, the ASPP's rate 6 on 2 rows a rank (past the neighbour
# and the frame), uneven layers (3 rows: 2 and 1; 1 row: 1 and none), and
# the bilinear edge clamp
FETCH_CASES = [((16, 16), 1, False), ((4, 4), 6, False), ((3, 3), 1, False),
               ((1, 1), 1, False), ((6, 5), 2, True)]


@functools.lru_cache(maxsize=None)
def _fetch_cases():
    """Each case's f64 layers [2, h, 3, 2] (one per data row) and every
    rank's weights on its fetched rows: [data][spatial] -> [2, rows, 3, 2]."""
    from tpuseg_torch.parallel.spatial import owned

    rng = np.random.RandomState(21)
    out = []
    for heights, halo, clamp in FETCH_CASES:
        layers = [rng.randn(2, h, 3, 2) for h in heights]
        weights = []
        for h in heights:
            spans = [owned(h, 2, j) for j in range(2)]      # a rank of no rows asks none
            weights.append([rng.randn(2, stop - start + 2 * halo if stop > start else 0, 3, 2)
                            for start, stop in spans])
        out.append((layers, halo, clamp, weights))
    return out


# the five families for one spatial f64 step: (model config, H x W, loss,
# options of the step, which ride along to cover them under the spatial mode)
TEACHER = dict(name="unet", base_filters=4)
SPATIAL_FAMILIES = {
    # distilled from a UNet teacher, whose eval forward runs on the slab too
    "mobilenetv2_fpn": (dict(name="mobilenetv2_fpn", width_mult=0.25, base_filters=8),
                        (32, 64), "ce", {"teacher": TEACHER}),
    "mobilenetv2_deeplab": (dict(name="mobilenetv2_deeplab", width_mult=0.25,
                                 base_filters=8), (64, 64), "ce+lovasz", {"remat": True}),
    "unet": (dict(name="unet", base_filters=4), (32, 16), "ce+dice", {}),
    "light_unet": (dict(name="light_unet", base_filters=4), (32, 16), "mse", {}),
    # H 32: the 1/32 layer is one row, owned by the first spatial rank alone
    "mobilenetv2_unet-subpixel": (dict(width_mult=0.25, up_subpixel=True), (32, 64), "lovasz",
                                  {}),
}
# QAT's fake-quant rounds in float32 whatever the dtype (ops/fake_quant.py),
# so its gradients carry float32 rounding: held apart, at its own tolerance
SPATIAL_QAT = {"unet-qat": (dict(name="unet", base_filters=4), (32, 16), "ce", {"qat": True})}


def _seeded_state(kw: dict, seed: int) -> dict:
    """The port's seeded init in f64 with non-trivial BatchNorm affine and
    statistics and conv biases."""
    from tpuseg_torch.configs import ModelConfig
    from tpuseg_torch.models.registry import build_model

    rng = np.random.RandomState(seed)
    state = {}
    for k, v in build_model(ModelConfig(**kw), seed=seed).state_dict().items():
        v = v.to(torch.float64).numpy() if v.is_floating_point() else v.numpy()
        if k.endswith(("running_var", ".weight")) and v.ndim == 1:
            v = rng.uniform(0.5, 1.5, v.shape)
        elif k.endswith(("running_mean", ".bias")) and v.ndim == 1:
            v = rng.uniform(-0.2, 0.2, v.shape)
        state[k] = v
    return state


@functools.lru_cache(maxsize=None)
def _family_cases():
    """{name: (config, state, loss, options, images [4, H, W, 3], labels)}."""
    out = {}
    for i, (name, (kw, hw, loss, opts)) in enumerate({**SPATIAL_FAMILIES, **SPATIAL_QAT}.items()):
        if "teacher" in opts:
            opts = {"teacher": (opts["teacher"], _seeded_state(opts["teacher"], 40 + i))}
        rng = np.random.RandomState(30 + i)
        out[name] = (kw, _seeded_state(kw, 30 + i), loss, opts, rng.rand(4, *hw, 3),
                     rng.randint(0, 10, (4, *hw)))
    return out


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """The two rank groups, started at once, one after the other, on a
    thread of their own: {world: future of the ranks' results}."""
    ck = str(tmp_path_factory.mktemp("mesh_ck"))
    argv = [a for a in [*JAX_TINY, SOURCES8, *TRAINER_FLAGS, "--mesh.data=2"]
            if not a.startswith("--train.checkpoint_dir")]
    _, batches, state = _trajectory_inputs()
    w2 = {"trajectory": (state, batches, WIDTH, LR),
          "predictor": (_frames(), WIDTH, SERVE_HW),
          "sharded_lovasz": (2, 1, *_lovasz_inputs()),
          "losses": (*_loss_inputs(), WEIGHTS),
          "batchnorm": _bn_inputs(),
          "clip": _clip_inputs(),
          "trainer": (argv, ck),
          "bf16_trainer": (argv,),
          "qat_distill": (*_qat_distill_inputs()[3:], _qat_distill_inputs()[2], KD_BF, LR)}
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    w4 = {"sharded_lovasz": (2, 2, *_lovasz_inputs()), "spatial": _spatial_inputs(),
          "losses": (*_loss_inputs(), WEIGHTS, 2, 2), "fetch": (_fetch_cases(),),
          "spatial_trajectory": (state, batches, WIDTH, LR),
          "spatial_families": (_family_cases(), LR),
          "spatial_trainer": ([a for a in argv if a != "--mesh.data=2"]
                              + ["--mesh.data=2", "--mesh.spatial=2"],)}
    futures = {world: pool.submit(launch_local, ranks.suite, world, timeout_s=TIMEOUT,
                                  args=(inputs,)) for world, inputs in ((2, w2), (4, w4))}
    yield futures
    pool.shutdown(wait=True)


@pytest.fixture(autouse=True, scope="module")
def _oracles_beside_the_ranks(groups, jax_trajectories, jax_qat_distill, one_process_trainers,
                              jax_spatial_trainer, jax_lovasz):
    """The JAX oracles (and the one-process Trainer), computed in this
    process while the rank groups run in theirs: the first test that waits
    on the ranks finds them ready, and the file's time is the longer of the
    two, not their sum."""


def _ranks(groups, name, world=2):
    return [r[name] for r in groups[world].result(timeout=2 * TIMEOUT)]


def _assemble(results, shape):
    g = np.zeros(shape)
    for _, grad, index in results:
        g[index] = grad
    return g


# -- the 3-step f64 trajectory against JAX's mesh step ------------------------------


# labels offset by this choose the Lovász in the shared JAX step below
LOVASZ_FLAG = 10


def _either_loss(mesh):
    """One loss for both trajectories, so that JAX's mesh step compiles
    once: labels offset by LOVASZ_FLAG take the Lovász, plain ones CE
    (``jnp.where`` passes the chosen loss's gradient alone)."""
    ce = jax_make_loss_fn("ce", mesh=mesh)
    lovasz = jax_make_loss_fn("lovasz", mesh=mesh)

    def loss_fn(logits, labels):
        flag = jnp.max(labels) >= LOVASZ_FLAG
        labels = labels % LOVASZ_FLAG
        return jnp.where(flag, lovasz(logits, labels), ce(logits, labels))

    return loss_fn


@pytest.fixture(scope="module")
def jax_trajectories():
    """{loss: (losses, state dict)} of JAX's ``make_train_step`` over
    ``create_mesh(data=2)`` for "ce" and "lovasz", in float64."""
    variables, batches, _ = _trajectory_inputs()
    jax.config.update("jax_enable_x64", True)
    try:
        mesh = jax_create_mesh(data=2)
        fm = _FlaxUNetF64Head(output_channels=10, width_mult=WIDTH, up_subpixel=False,
                              dtype=jnp.float64)
        cast = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), t)
        step = jax_make_train_step(mesh=mesh, donate=False, loss_fn=_either_loss(mesh))
        # one tx object: both states have one tree, so the step traces once
        tx = optax.adam(LR, b1=0.9, b2=0.999, eps=1e-8)
        out = {}
        for loss, offset in (("ce", 0), ("lovasz", LOVASZ_FLAG)):
            state = TrainState.create(apply_fn=fm.apply, params=cast(variables["params"]),
                                      batch_stats=cast(variables["batch_stats"]), tx=tx)
            # replicated on the mesh, as the step returns it (and as the JAX
            # Trainer ships it): the step then compiles once, not again at
            # its second call
            state = jax.device_put(state, jax_replicated_sharding(mesh))
            losses = []
            for x, y in batches:
                state, metrics = step(state, jnp.asarray(x), jnp.asarray(y + offset))
                losses.append(float(metrics["loss"]))
            out[loss] = (losses, state_dict_from_flax(
                {"params": state.params, "batch_stats": state.batch_stats},
                dtype=torch.float64))
    finally:
        jax.config.update("jax_enable_x64", False)
    return out


@pytest.mark.parametrize("loss", ["ce", "lovasz"])
def test_world2_f64_trajectory_matches_jax_mesh_step(groups, jax_trajectories, loss):
    want_losses, want = jax_trajectories[loss]
    (losses0, got, digest0), (losses1, _, digest1) = [r[loss] for r in
                                                      _ranks(groups, "trajectory")]
    assert digest0 == digest1 and losses0 == losses1
    np.testing.assert_allclose(losses0, want_losses, rtol=1e-9)
    n_stats = 0
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got[k], w.numpy(), rtol=1e-9, atol=1e-10, err_msg=k)
            n_stats += 1
        else:
            np.testing.assert_allclose(got[k], w.numpy(), rtol=1e-6, atol=1e-8, err_msg=k)
    assert n_stats > 100 and got["backbone.features.0.1.num_batches_tracked"] == len(want_losses)


@pytest.fixture(scope="module")
def jax_qat_distill():
    """(losses, state dict) of JAX's ``make_train_step`` over
    ``create_mesh(data=2)`` with the "qat" markers and the teacher."""
    from tpuseg.models.unet import UNet as FlaxUNet
    from tpuseg.ops.fake_quant import build_qat_markers
    from tpuseg.train.distill import make_distill_loss, make_teacher_fn

    student, teacher, batches, _, _ = _qat_distill_inputs()
    jax.config.update("jax_enable_x64", True)
    try:
        mesh = jax_create_mesh(data=2)
        fm = FlaxUNet(output_channels=10, base_filters=KD_BF, dtype=jnp.float64)
        cast = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), t)
        loss = make_distill_loss(jax_make_loss_fn("ce", ignore_index=255), 0.5, 2.0, 255)
        step = jax_make_train_step(mesh=mesh, donate=False, loss_fn=loss,
                                   extra_collections={"qat": build_qat_markers(
                                       student["params"])},
                                   teacher_fn=make_teacher_fn(fm, cast(teacher)))
        state = TrainState.create(apply_fn=fm.apply, params=cast(student["params"]),
                                  batch_stats=cast(student["batch_stats"]),
                                  tx=optax.adam(LR, b1=0.9, b2=0.999, eps=1e-8))
        state = jax.device_put(state, jax_replicated_sharding(mesh))
        want_losses = []
        for x, y in batches:
            state, metrics = step(state, jnp.asarray(x), jnp.asarray(y))
            want_losses.append(float(metrics["loss"]))
        want = state_dict_from_flax({"params": state.params,
                                     "batch_stats": state.batch_stats}, dtype=torch.float64)
    finally:
        jax.config.update("jax_enable_x64", False)
    return want_losses, want


def test_world2_f64_qat_distill_step_matches_jax_mesh_step(groups, jax_qat_distill):
    want_losses, want = jax_qat_distill
    (losses0, got, digest0), (losses1, _, digest1) = _ranks(groups, "qat_distill")
    assert digest0 == digest1 and losses0 == losses1
    np.testing.assert_allclose(losses0, want_losses, rtol=1e-6)
    for k, w in want.items():
        if not k.endswith("num_batches_tracked"):
            tol = dict(rtol=1e-6) if "running" in k else dict(rtol=1e-6, atol=1e-8)
            np.testing.assert_allclose(got[k], w.numpy(), err_msg=k, **tol)


# -- the Trainer at world 2 -------------------------------------------------------


@pytest.fixture(scope="module")
def one_process_trainers():
    """The JAX Trainer over create_mesh(data=2) and the port's one-process
    Trainer, on the world-2 run's flags."""
    jt = _jax_trainer([*TRAINER_FLAGS, "--mesh.data=2"])
    jt.train()
    one = Trainer(load_config([*JAX_TINY, SOURCES8, *TRAINER_FLAGS]), device="cpu")
    one.train()
    return jt, one


def test_world2_trainer_matches_the_jax_mesh_trainer(groups, one_process_trainers):
    jt, _ = one_process_trainers
    assert jt.mesh.shape["data"] == 2
    for r in _ranks(groups, "trainer"):
        assert [h["step"] for h in r["history"]] == [h["step"] for h in jt.history] == [1, 2]
        assert r["step"] == jt.step == 2 and len(r["losses"]) == 2
        for got, want in zip(r["history"], jt.history):
            assert set(got) - {"best"} == set(want) - {"best"}
            assert 0 <= got["val_miou"] <= 1


def test_world2_trainer_equals_one_process(groups, one_process_trainers):
    _, one = one_process_trainers
    r0, r1 = _ranks(groups, "trainer")
    assert r0["trained"] == r1["trained"] and r0["losses"] == r1["losses"]
    np.testing.assert_allclose(r0["losses"], one.step_losses, rtol=1e-4)
    for a, b in zip(r0["history"], one.history):
        assert a["val_miou"] == pytest.approx(b["val_miou"], abs=1e-3)


def test_world2_trains_in_bf16_with_equal_parameters_on_both_ranks(groups):
    """bf16 compute, a bf16 mu and bf16 gradients (cast after the fp32
    all_reduce) over the mesh: finite losses, the parameters equal on both
    ranks and fp32, mu bf16."""
    r0, r1 = _ranks(groups, "bf16_trainer")
    assert r0["trained"] == r1["trained"] and r0["losses"] == r1["losses"]
    assert len(r0["losses"]) == 2 and all(np.isfinite(r0["losses"]))
    assert r0["mu"] == {"torch.bfloat16"} and r0["params"] == {"torch.float32"}


def test_world2_checkpoint_written_by_rank0_resumed_on_both(groups):
    for r in _ranks(groups, "trainer"):
        assert r["files"] == ["best", "best.json", "history.jsonl", "step_1.pt", "step_2.pt"]
        assert r["resumed"] and r["resumed_step"] == 2 and r["sampler"]
        assert r["resumed_digest"] == r["trained"]


# -- the sharded Lovász ---------------------------------------------------------


@pytest.fixture(scope="module")
def jax_lovasz():
    """JAX's sharded op on a 2x2 CPU mesh: {(spatial, ignore): (value, grad)}."""
    from jax.sharding import Mesh

    logits, targets = _lovasz_inputs()
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "spatial"))
    out = {}
    for sp in (False, True):
        for ign in (None, 255):
            fn = jax_sharded_lovasz(mesh, spatial=sp, ignore_index=ign, interpret=True)
            v, g = jax.jit(jax.value_and_grad(lambda lg: fn(lg, jnp.asarray(targets))))(
                jnp.asarray(logits))
            out[(sp, ign)] = (float(v), np.asarray(g))
    return out


LOVASZ_CASES = [(4, False, None), (4, False, 255), (4, True, None), (4, True, 255),
                (2, False, None), (2, False, 255)]


@pytest.mark.parametrize("world,spatial,ign", LOVASZ_CASES)
def test_sharded_lovasz_matches_jax_and_one_process(groups, jax_lovasz, world, spatial, ign):
    logits, targets = _lovasz_inputs()
    results = [r[(spatial, ign)] for r in _ranks(groups, "sharded_lovasz", world)]
    want_v, want_g = jax_lovasz[(spatial, ign)]
    for value, _, _ in results:
        assert value == pytest.approx(want_v, abs=1e-6)
    got = _assemble(results, logits.shape)
    np.testing.assert_allclose(got, want_g, atol=1e-8)
    lg = torch.from_numpy(logits).requires_grad_(True)
    one = lovasz_softmax_loss(lg, torch.from_numpy(targets), ignore_index=ign, bins=256)
    one.backward()
    one_g = lg.grad.numpy()
    # a world-size factor (x2, x4, /2, /4) moves some entry by more than 1e-8
    assert np.abs(one_g).max() > 1e-6
    np.testing.assert_allclose(got, one_g, atol=1e-8)
    assert results[0][0] == pytest.approx(float(one.detach()), abs=1e-6)
    assert len({r[0] for r in results}) == 1    # the same value on every rank


# -- every loss at world 2 ------------------------------------------------------


LOSS_KEYS = [*ranks.LOSS_NAMES, "lovasz@64", "lovasz@0"]


def _check_loss_against_one_process(results, key):
    logits, targets = _loss_inputs()
    name, bins = (key.split("@")[0], int(key.split("@")[1])) if "@" in key else (key, 256)
    fn = make_loss_fn(name, class_weights=WEIGHTS if name in ranks.WEIGHTED else None,
                      ignore_index=255, lovasz_bins=bins)
    lg = torch.from_numpy(logits).requires_grad_(True)
    one = fn(lg, torch.from_numpy(targets))
    one.backward()
    for value, _, _ in results:
        assert value == pytest.approx(float(one.detach()), rel=1e-6)
    got = _assemble(results, logits.shape)
    assert np.abs(lg.grad.numpy()).max() > 1e-4
    np.testing.assert_allclose(got, lg.grad.numpy(), rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("key", LOSS_KEYS)
def test_world2_loss_and_gradient_equal_one_process(groups, key):
    _check_loss_against_one_process([r[key] for r in _ranks(groups, "losses")], key)


@pytest.mark.parametrize("key", LOSS_KEYS)
def test_world4_spatial_loss_and_gradient_equal_one_process(groups, key):
    """Rows over "data" and H over "spatial" (2x2): the sums run over all
    four ranks, the 0-bin sort gathers the blocks back into the global
    planes."""
    _check_loss_against_one_process([r[key] for r in _ranks(groups, "losses", 4)], key)


@pytest.mark.parametrize("bins", [64, 0])
def test_world2_lovasz_bins_match_jax_mesh(groups, bins):
    """JAX's loss over create_mesh(data=2): the psum of its level sums at
    64 bins, the global sort (GSPMD) at 0; float64."""
    logits, targets = _loss_inputs()
    jax.config.update("jax_enable_x64", True)
    try:
        fn = jax_make_loss_fn("lovasz", ignore_index=255, lovasz_bins=bins,
                              mesh=jax_create_mesh(data=2))
        v, g = jax.jit(jax.value_and_grad(fn))(jnp.asarray(logits), jnp.asarray(targets))
        v, g = float(v), np.asarray(g)
    finally:
        jax.config.update("jax_enable_x64", False)
    results = [r[f"lovasz@{bins}"] for r in _ranks(groups, "losses")]
    assert results[0][0] == pytest.approx(v, rel=1e-6)
    np.testing.assert_allclose(_assemble(results, logits.shape), g, rtol=1e-6, atol=1e-12)


# -- BatchNorm and the clip -----------------------------------------------------


def test_batchnorm_global_statistics_equal_one_process(groups):
    x, r, weight, bias = _bn_inputs()
    out = _ranks(groups, "batchnorm")
    bn = BatchNorm2d(6).double().train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(weight))
        bn.bias.copy_(torch.from_numpy(bias))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = bn(xt)
    (y * torch.from_numpy(r)).sum().backward()
    for name, want in (("y", y.detach().numpy()), ("dx", xt.grad.numpy())):
        got = np.concatenate([o[name] for o in out])
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12, err_msg=name)
    for name, want in (("dweight", bn.weight.grad), ("dbias", bn.bias.grad)):
        np.testing.assert_allclose(out[0][name] + out[1][name], want.numpy(), rtol=1e-9,
                                   err_msg=name)
    for name in ("running_mean", "running_var"):
        np.testing.assert_array_equal(out[0][name], out[1][name])
        np.testing.assert_allclose(out[0][name], getattr(bn, name).numpy(), rtol=1e-12,
                                   err_msg=name)
    assert np.abs(xt.grad.numpy()).max() > 1e-3


def test_clip_sees_the_global_norm(groups):
    parts, clip_norm, lr = _clip_inputs()
    summed, params = zip(*_ranks(groups, "clip"))
    ps = [torch.nn.Parameter(torch.zeros(a.shape, dtype=torch.float64)) for a in parts[0]]
    for p, a, b in zip(ps, *parts):
        p.grad = torch.from_numpy(a + b)
    Optimizer(ps, optimizer="sgd", lr=lr, momentum=0.0, clip_norm=clip_norm).step()
    total = np.sqrt(sum(((a + b) ** 2).sum() for a, b in zip(*parts)))
    # clipping each rank's part would leave both untouched
    assert total > clip_norm > max(np.sqrt(sum((g * g).sum() for g in part)) for part in parts)
    for rank in range(2):
        for got, a, b in zip(summed[rank], *parts):
            np.testing.assert_array_equal(got, a + b)
        for got, p in zip(params[rank], ps):
            np.testing.assert_allclose(got, p.detach().numpy(), rtol=1e-12)


# -- the mesh itself ----------------------------------------------------------------


@pytest.mark.parametrize("spatial_dim", [None, 1, 2])
def test_batch_slice_is_the_block_batch_sharding_gives(spatial_dim):
    """Each rank's block of a [4, 6, 8, 3] batch on a 2x2 mesh is the index
    that JAX's batch_sharding gives the device at the same grid place."""
    from jax.sharding import Mesh as JaxMesh

    devices = np.array(jax.devices()[:4]).reshape(2, 2)
    shape = (4, 6, 8, 3)
    want = jax_batch_sharding(JaxMesh(devices, ("data", "spatial")),
                              spatial_dim).devices_indices_map(shape)
    for rank, device in enumerate(devices.reshape(-1)):
        got = batch_slice(Mesh(2, 2, rank, "gloo"), shape, spatial_dim)
        assert [(s.start or 0, s.stop or n) for s, n in zip(got, shape)] == \
            [(s.start or 0, s.stop or n) for s, n in zip(want[device], shape)]


def test_mesh_errors_match_jax():
    with pytest.raises(ValueError, match="spatial_dim must be >= 1") as want:
        jax_batch_sharding(jax_create_mesh(data=2), spatial_dim=0)
    with pytest.raises(ValueError) as got:
        batch_slice(Mesh(2, 1, 0, "gloo"), (4, 6), spatial_dim=0)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="not divisible"):
        batch_slice(Mesh(2, 1, 0, "gloo"), 3)
    for kw, msg in ((dict(data=2), "mesh 2x1 needs 2 devices, have 1"),
                    (dict(spatial=3), "1 devices not divisible by spatial=3")):
        with pytest.raises(ValueError, match=msg):
            create_mesh(**kw)
    one = create_mesh()
    assert (one.shape, one.size, one.coords, one.group) == (
        {"data": 1, "spatial": 1}, 1, {"data": 0, "spatial": 0}, None)


def test_launch_local_raises_a_rank_failure_and_a_hang():
    """A rank that raises fails the launch with its traceback; a rank that
    outlives the deadline fails it with TimeoutError; either way the ranks
    still blocked in a collective are killed."""
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        launch_local(ranks.fail_on_rank1, 2, timeout_s=60)
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="no result within 3"):
        launch_local(ranks.hang_on_rank1, 2, timeout_s=3, args=(120,))
    assert time.monotonic() - t0 < 30


# -- mesh serving and spatial sharding -------------------------------------------------


def test_mesh_served_class_maps_equal_one_process(groups):
    """Each rank serves its 2 rows and all-gathers: every rank returns the
    one-process Predictor's class maps and colours, bit for bit."""
    from tpuseg_torch.configs import ModelConfig
    from tpuseg_torch.infer.predictor import Predictor

    frames = _frames()
    kw = dict(input_hw=SERVE_HW, batch_size=4, device="cpu")
    plain = Predictor(ModelConfig(width_mult=WIDTH), **kw)(frames)
    classes, colours = Predictor(ModelConfig(width_mult=WIDTH), colorize_on_device=True,
                                 **kw)(frames)
    for got_plain, got_classes, got_colours in _ranks(groups, "predictor"):
        np.testing.assert_array_equal(got_plain, plain)
        np.testing.assert_array_equal(got_classes, classes)
        np.testing.assert_array_equal(got_colours, colours)
    assert len(np.unique(plain)) > 1


def test_halo_exchange_rows(groups):
    """Each slab gets exactly its spatial neighbours' boundary rows (zeros
    at the frame's edges), on both data rows of the 2x2 mesh."""
    for r in _ranks(groups, "spatial", 4):
        j, lo = r["coords"]["spatial"], r["coords"]["spatial"] * 8
        out = r["rows"][0, :, 0, 0]
        np.testing.assert_array_equal(out[:2], [0, 0] if j == 0 else [lo - 2, lo - 1])
        np.testing.assert_array_equal(out[2:10], np.arange(lo, lo + 8))
        np.testing.assert_array_equal(out[10:], [0, 0] if j == 1 else [lo + 8, lo + 9])


def _conv_nhwc(x, k):
    w = torch.from_numpy(k).permute(3, 2, 0, 1)
    return torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), w,
                                      padding=k.shape[0] // 2).permute(0, 2, 3, 1)


def test_spatial_conv_stack_exact_with_sufficient_halo(groups):
    """halo 4 over 3 convs (half receptive field 3): the sharded output is
    crop(fn(zero-padded input)) everywhere, the unsharded forward beyond
    the frame border's receptive field, and JAX's spatial_shard_apply's."""
    from jax.sharding import Mesh as JaxMesh

    from tpuseg.parallel.spatial import spatial_shard_apply as jax_spatial

    _, x, kernels, _, _ = _spatial_inputs()

    def stack(t):
        for k in kernels:
            t = torch.relu(_conv_nhwc(t, k))
        return t

    halo, rf = 4, 3
    padded = np.pad(x, ((0, 0), (halo, halo), (0, 0), (0, 0)))
    ref_padded = stack(torch.from_numpy(padded)).numpy()[:, halo:-halo]
    ref_plain = stack(torch.from_numpy(x)).numpy()

    def jax_stack(t):
        for k in kernels:
            t = jax.nn.relu(jax.lax.conv_general_dilated(
                t, jnp.asarray(k), (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC")))
        return t

    mesh = JaxMesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "spatial"))
    want = np.asarray(jax_spatial(jax_stack, mesh, halo=halo)(jnp.asarray(x)))
    for r in _ranks(groups, "spatial", 4):
        np.testing.assert_allclose(r["stack"], ref_padded, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(r["stack"][:, rf:-rf], ref_plain[:, rf:-rf], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(r["stack"], want, rtol=1e-5, atol=1e-6)


def test_spatial_insufficient_halo_detected(groups):
    """halo 1 under a 9x9 conv changes the rows at the slab boundary, so the
    test above cannot pass vacuously; the halo must divide by downscale."""
    from tpuseg_torch.parallel.spatial import spatial_shard_apply

    _, _, _, x, k = _spatial_inputs()
    ref = _conv_nhwc(torch.from_numpy(x), k).numpy()
    for r in _ranks(groups, "spatial", 4):
        assert not np.allclose(r["wide"], ref, atol=1e-4)
    with pytest.raises(ValueError, match="halo 3 not a multiple of downscale 2"):
        spatial_shard_apply(lambda t: t, Mesh(1, 2, 0, "gloo"), halo=3, downscale=2)


# -- the spatially sharded train step (world 4: data 2 x spatial 2) -------------------


@pytest.mark.parametrize("case", range(len(FETCH_CASES)),
                         ids=["halo1", "halo6", "uneven3", "uneven1", "clamp"])
def test_world4_fetch_rows_equal_one_process(groups, case):
    """Each rank's fetched rows are the global rows it asked for (zero rows,
    or the edge row under the clamp, beyond the frame), and each owned
    row's gradient is the sum over every rank that read it, f64 to 1e-12."""
    layers, halo, clamp, weights = _fetch_cases()[case]
    got = [r[case] for r in _ranks(groups, "fetch", 4)]
    for i, layer in enumerate(layers):
        h = layer.shape[1]
        grad = np.zeros_like(layer)
        for j in range(2):
            r = got[2 * i + j]
            lo, hi = r["request"]
            rows = np.arange(lo, hi)
            src, keep = np.clip(rows, 0, h - 1), (rows >= 0) & (rows < h) | clamp
            want = layer[:, src] * keep[None, :, None, None]
            np.testing.assert_allclose(r["rows"], want, rtol=0, atol=1e-12)
            np.add.at(grad, (slice(None), src[keep]), weights[i][j][:, keep])
        assembled = np.concatenate([got[2 * i + j]["grad"] for j in range(2)], axis=1)
        np.testing.assert_allclose(assembled, grad, rtol=0, atol=1e-12)
        # a rank's gradient includes the other's reads of its rows
        assert np.abs(grad).max() > 1e-3


@pytest.mark.parametrize("loss", ["ce", "lovasz"])
def test_world4_spatial_f64_trajectory_matches_jax_mesh_step(groups, jax_trajectories, loss):
    """The flagship's 3 f64 steps with the image height sharded over a 2x2
    mesh against JAX's ``make_train_step`` over ``create_mesh(data=2)``:
    GSPMD's spatial step is the same function as the data-only one (it
    only places the work), so one JAX compile is the oracle of both. The
    world-2 trajectory's tolerances; the parameters bit-equal on all four
    ranks."""
    want_losses, want = jax_trajectories[loss]
    results = [r[loss] for r in _ranks(groups, "spatial_trajectory", 4)]
    assert len({r[2] for r in results}) == 1 and len({tuple(r[0]) for r in results}) == 1
    losses, got, _ = results[0]
    np.testing.assert_allclose(losses, want_losses, rtol=1e-9)
    n_stats = 0
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got[k], w.numpy(), rtol=1e-9, atol=1e-10, err_msg=k)
            n_stats += 1
        else:
            np.testing.assert_allclose(got[k], w.numpy(), rtol=1e-6, atol=1e-8, err_msg=k)
    assert n_stats > 100 and got["backbone.features.0.1.num_batches_tracked"] == len(want_losses)


@functools.lru_cache(maxsize=None)
def _one_process_family_step(name: str):
    """The port's one-process f64 step of ``_family_cases()[name]``."""
    return ranks.family_step(*_family_cases()[name], LR)


@pytest.mark.parametrize("name", list(SPATIAL_FAMILIES))
def test_world4_spatial_family_step_equals_one_process(groups, name):
    """One f64 step of each family with the image height sharded over a
    2x2 mesh equals the port's one-process step (itself held to JAX by the
    family tests), with distillation and remat riding along on two of
    them: the loss and the summed gradients at rtol 1e-9 (atol 1e-12 of
    the largest, for the conv biases under a BatchNorm, whose gradient is
    round-off), the updated parameters and statistics at rtol 1e-6; every
    rank bit-equal."""
    want_loss, want_grads, want_state, _ = _one_process_family_step(name)
    results = [r[name] for r in _ranks(groups, "spatial_families", 4)]
    assert len({r[3] for r in results}) == 1
    loss, grads, state, _ = results[0]
    assert loss == pytest.approx(want_loss, rel=1e-9)
    scale = max(np.abs(g).max() for g in want_grads.values())
    assert scale > 1e-3
    for k, w in want_grads.items():
        np.testing.assert_allclose(grads[k], w, rtol=1e-9, atol=1e-12 * scale, err_msg=k)
    for k, w in want_state.items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_allclose(state[k], w, rtol=1e-6, atol=1e-12, err_msg=k)


def test_world4_spatial_qat_step_equals_one_process(groups):
    """QAT with the image height sharded: every conv+BatchNorm conv's
    activation range is the whole mesh's, so the fake-quantized values
    equal one process's and the loss agrees at rtol 1e-9; the gradients
    pass the straight-through estimator in float32, so they and the
    updated parameters agree at float32's rtol 1e-5 (atol 1e-7 of the
    largest gradient); every rank bit-equal."""
    want_loss, want_grads, want_state, _ = _one_process_family_step("unet-qat")
    results = [r["unet-qat"] for r in _ranks(groups, "spatial_families", 4)]
    assert len({r[3] for r in results}) == 1
    loss, grads, state, _ = results[0]
    assert loss == pytest.approx(want_loss, rel=1e-9)
    scale = max(np.abs(g).max() for g in want_grads.values())
    for k, w in want_grads.items():
        np.testing.assert_allclose(grads[k], w, rtol=1e-5, atol=1e-7 * scale, err_msg=k)
    for k, w in want_state.items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_allclose(state[k], w, rtol=1e-5, atol=1e-9, err_msg=k)


@pytest.fixture(scope="module")
def jax_spatial_trainer():
    """The JAX Trainer over create_mesh(data=2, spatial=2) on the world-4
    run's flags."""
    jt = _jax_trainer([*TRAINER_FLAGS, "--mesh.data=2", "--mesh.spatial=2"])
    jt.train()
    return jt


def test_world4_spatial_trainer_matches_the_jax_spatial_trainer(groups, jax_spatial_trainer,
                                                                 one_process_trainers):
    """``tpuseg_torch.main --mesh.data=2 --mesh.spatial=2`` on four ranks:
    the JAX spatial Trainer's records at the same steps, the losses of the
    port's one-process run at rtol 1e-4 (float32 sums in another order),
    the parameters bit-equal on every rank."""
    jt = jax_spatial_trainer
    _, one = one_process_trainers
    assert jt.mesh.shape == {"data": 2, "spatial": 2}
    results = _ranks(groups, "spatial_trainer", 4)
    assert len({r["trained"] for r in results}) == 1
    for r in results:
        assert r["spatial"] and r["step"] == jt.step == 2
        assert [h["step"] for h in r["history"]] == [h["step"] for h in jt.history] == [1, 2]
        for got, want in zip(r["history"], jt.history):
            assert set(got) - {"best"} == set(want) - {"best"}
        np.testing.assert_allclose(r["losses"], one.step_losses, rtol=1e-4)


def test_spatial_height_must_divide_in_both_packages(groups):
    """data.height 15 over a spatial axis of 2 raises a ValueError naming
    the spatial axis, before the model is built, in both packages."""
    from tpuseg.configs import DatasetSourceConfig
    from tpuseg.configs import load_config as jax_load_config
    from tpuseg.train.trainer import Trainer as JaxTrainer

    cfg = jax_load_config([*JAX_TINY, *TRAINER_FLAGS, "--mesh.data=2", "--mesh.spatial=2",
                           "--data.height=15"])
    cfg.data.sources = (DatasetSourceConfig(kind="synthetic", num_samples=16, weight=1.0),)
    with pytest.raises(ValueError, match="spatial") as want:
        JaxTrainer(cfg)
    for r in _ranks(groups, "spatial_trainer", 4):
        assert r["raised"] == str(want.value)
