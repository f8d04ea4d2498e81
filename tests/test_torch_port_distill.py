"""Distillation in the port (tpuseg_torch/train/distill.py, the teacher in
tpuseg_torch/train/train_step.py, Trainer._build_distillation) against the
JAX package's (tpuseg/train/distill.py).

- ``kd_kl_loss`` and ``make_distill_loss`` (alpha 0.25 and 1.0, with and
  without ``ignore_index``) equal to JAX's in value and in the gradient
  with respect to the student's logits, in float64 (rtol 1e-12); teacher
  == student gives exactly 0; alpha outside (0, 1] raises.
- One float64 distilled train step (a UNet student and a UNet teacher at
  base_filters 4, 32x64, batch 2, CE base with ignore_index 255, alpha
  0.5, T 2, Adam) against JAX's ``make_train_step(loss_fn=...,
  teacher_fn=make_teacher_fn(...))``: the loss, the student's parameters
  and BatchNorm statistics at rtol 1e-6 (the parameters also at atol
  1e-8); the teacher's weights and statistics do not move.
- The Trainer: alpha 0 warns and builds no teacher; a checkpoint with a
  ``quant`` tree, a teacher of the wrong width and one of another class
  count raise at build time with the JAX Trainer's messages; QAT and
  distillation together, with steps_per_dispatch 2 and bf16, train
  through ``tpuseg_torch.main`` and leave the state_dict's keys as they
  are.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpuseg.models.unet import UNet as FlaxUNet
from tpuseg.train import distill as jd
from tpuseg.train.loss import make_loss_fn as jax_make_loss_fn
from tpuseg.train.train_step import TrainState, make_train_step as jax_make_train_step
from tpuseg_torch.configs import ModelConfig, load_config
from tpuseg_torch.core.checkpoint import CheckpointManager
from tpuseg_torch.core.weights import state_dict_from_flax
from tpuseg_torch.models.registry import build_model
from tpuseg_torch.train import distill as pd
from tpuseg_torch.train.loss import make_loss_fn
from tpuseg_torch.train.optim import Optimizer
from tpuseg_torch.train.train_step import make_train_step
from tpuseg_torch.train.trainer import Trainer

HW, BF, LR = (32, 64), 4, 1e-3
TINY = ["--model.name=unet", f"--model.base_filters={BF}", "--data.height=32",
        "--data.width=64", "--train.batch_size=2", "--train.steps_per_epoch=2",
        "--train.epochs=1", "--train.checkpoint_dir=", "--data.val_split=0.25",
        '--data.sources=[{"kind":"synthetic","num_samples":12,"weight":1.0}]']


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _logits():
    rng = np.random.RandomState(0)
    s, t = rng.randn(2, 4, 6, 5) * 2, rng.randn(2, 4, 6, 5) * 2
    y = rng.randint(0, 5, (2, 4, 6))
    y[0, :2] = 255
    return s, t, y


def _both(loss_j, loss_p, s, t, y):
    """(JAX value, JAX grad, port value, port grad) in float64."""
    jax.config.update("jax_enable_x64", True)
    try:
        v, g = jax.value_and_grad(lambda a: loss_j(a, jnp.asarray(y), jnp.asarray(t)))(
            jnp.asarray(s))
        v, g = float(v), np.asarray(g)
    finally:
        jax.config.update("jax_enable_x64", False)
    sp = torch.from_numpy(s).requires_grad_(True)
    vp = loss_p(sp, torch.from_numpy(y), torch.from_numpy(t))
    vp.backward()
    return v, g, float(vp.detach()), sp.grad.numpy()


@pytest.mark.parametrize("case", ["kd", "alpha0.25", "alpha0.25_ignore", "alpha1.0_ignore"])
def test_kd_and_distill_loss_match_jax(case):
    s, t, y = _logits()
    if case == "kd":
        fns = (lambda a, _y, b: jd.kd_kl_loss(a, b, 3.0),
               lambda a, _y, b: pd.kd_kl_loss(a, b, 3.0))
    else:
        alpha = float(case.split("_")[0][5:])
        ign = 255 if case.endswith("ignore") else -1
        fns = (jd.make_distill_loss(jax_make_loss_fn("ce", ignore_index=255), alpha, 2.0, ign),
               pd.make_distill_loss(make_loss_fn("ce", ignore_index=255), alpha, 2.0, ign))
    want_v, want_g, got_v, got_g = _both(*fns, s, t, y)
    np.testing.assert_allclose(got_v, want_v, rtol=1e-12)
    np.testing.assert_allclose(got_g, want_g, rtol=1e-12, atol=1e-15)
    assert got_v > 0


def test_teacher_equal_to_student_gives_zero_and_alpha_is_checked():
    s = torch.from_numpy(_logits()[0])
    assert float(pd.kd_kl_loss(s, s.clone())) == 0.0
    pure = pd.make_distill_loss(lambda a, b: 1.0, 1.0, 2.0, ignore_index=255)
    assert float(pure(s, torch.zeros(2, 4, 6, dtype=torch.long), s)) == 0.0
    for bad in (0.0, -0.5, 1.5):
        with pytest.raises(ValueError, match="alpha"):
            pd.make_distill_loss(lambda a, b: 0.0, bad, 2.0)


def _flax_unet_vars(seed):
    """A UNet's variables (base_filters 4) drawn with numpy from ``seed`` at
    the shapes flax's init gives (traced, not run): He-normal kernels, conv
    biases and BatchNorm affine and statistics away from 0 and 1."""
    shapes = jax.eval_shape(lambda: FlaxUNet(output_channels=10, base_filters=BF).init(
        jax.random.PRNGKey(0), jnp.zeros((1, *HW, 3)), train=False))
    rng = np.random.RandomState(seed)

    def draw(path, s):
        name = jax.tree_util.keystr(path)
        if name.endswith("['kernel']"):
            return (rng.randn(*s.shape) * np.sqrt(2.0 / np.prod(s.shape[:-1]))).astype(
                np.float32)
        lo, hi = (0.5, 1.5) if ("var" in name or "scale" in name) else (-0.2, 0.2)
        return rng.uniform(lo, hi, s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(
        draw, {"params": shapes["params"], "batch_stats": shapes["batch_stats"]})


def _port_unet(variables):
    model = build_model(ModelConfig(name="unet", base_filters=BF)).to(torch.float64)
    model.load_state_dict(state_dict_from_flax(variables, dtype=torch.float64), strict=True)
    return model


def test_f64_distilled_step_matches_jax():
    student, teacher = _flax_unet_vars(1), _flax_unet_vars(2)
    rng = np.random.RandomState(3)
    x = rng.rand(2, *HW, 3)
    y = rng.randint(0, 10, (2, *HW))
    y[1, :4] = 255
    jax.config.update("jax_enable_x64", True)
    try:
        cast = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), t)
        fm = FlaxUNet(output_channels=10, base_filters=BF, dtype=jnp.float64)
        state = TrainState.create(apply_fn=fm.apply, params=cast(student["params"]),
                                  batch_stats=cast(student["batch_stats"]),
                                  tx=optax.adam(LR, b1=0.9, b2=0.999, eps=1e-8))
        loss = jd.make_distill_loss(jax_make_loss_fn("ce", ignore_index=255), 0.5, 2.0, 255)
        step = jax_make_train_step(donate=False, loss_fn=loss,
                                   teacher_fn=jd.make_teacher_fn(fm, cast(teacher)))
        state, metrics = step(state, jnp.asarray(x), jnp.asarray(y))
        want_loss = float(metrics["loss"])
        want = state_dict_from_flax({"params": state.params, "batch_stats": state.batch_stats},
                                    dtype=torch.float64)
    finally:
        jax.config.update("jax_enable_x64", False)
    model, t_model = _port_unet(student), _port_unet(teacher)
    t_before = {k: v.clone() for k, v in t_model.state_dict().items()}
    teacher_fn = pd.make_teacher_fn(t_model)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        assert torch.equal(teacher_fn(xt), t_model(xt.permute(0, 3, 1, 2)).permute(0, 2, 3, 1))
    step = make_train_step(model, Optimizer(model.parameters(), lr=LR),
                           loss_fn=pd.make_distill_loss(make_loss_fn("ce", ignore_index=255),
                                                        0.5, 2.0, 255),
                           teacher_fn=teacher_fn)
    got_loss = float(step(xt, torch.from_numpy(y))["loss"])
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-6)
    got = model.state_dict()
    for k, w in want.items():
        if not k.endswith("num_batches_tracked"):
            tol = dict(rtol=1e-6) if "running" in k else dict(rtol=1e-6, atol=1e-8)
            np.testing.assert_allclose(got[k].numpy(), w.numpy(), err_msg=k, **tol)
    assert all(torch.equal(v, t_before[k]) for k, v in t_model.state_dict().items())
    assert not t_model.training and not any(p.requires_grad for p in t_model.parameters())


@pytest.fixture(scope="module")
def teacher_dirs(tmp_path_factory):
    """Checkpoint directories of the port: a seeded UNet (base_filters 4), a
    LightUNet, and the UNet with a 'quant' tree."""
    root = tmp_path_factory.mktemp("teachers")
    out = {}
    for name, cfg, extra in (
            ("unet", ModelConfig(name="unet", base_filters=BF), {}),
            ("light_unet", ModelConfig(name="light_unet", base_filters=BF), {}),
            ("quant", ModelConfig(name="unet", base_filters=BF),
             {"quant": {"act_scale": torch.ones(1)}})):
        CheckpointManager(str(root / name)).save(
            0, {"model": build_model(cfg, seed=5).state_dict(), "step": 0, **extra})
        out[name] = str(root / name)
    return out


def test_trainer_distillation_build_paths(teacher_dirs, caplog):
    kd = lambda d, *more: load_config([*TINY, f"--train.distill_checkpoint={d}", *more])
    with caplog.at_level(logging.WARNING):
        tr = Trainer(kd(teacher_dirs["unet"], "--train.distill_alpha=0"), device="cpu")
    assert tr.teacher is None and "distill_alpha=0" in caplog.text
    with pytest.raises(ValueError, match="carries a calibrated int8 'quant' collection"):
        Trainer(kd(teacher_dirs["quant"]), device="cpu")
    with pytest.raises(ValueError, match="does not match teacher model 'unet' "
                                         r"\(base_filters=8, width_mult=0.0\)"):
        Trainer(kd(teacher_dirs["unet"], "--train.distill_base_filters=8"), device="cpu")
    with pytest.raises(ValueError, match="teacher predicts 1 classes; student has 10"):
        Trainer(kd(teacher_dirs["light_unet"], "--train.distill_model=light_unet"),
                device="cpu")
    tr = Trainer(kd(teacher_dirs["unet"]), device="cpu")
    sd = build_model(ModelConfig(name="unet", base_filters=BF), seed=5).state_dict()
    assert all(torch.equal(v, sd[k]) for k, v in tr.teacher.state_dict().items())
    assert not tr.teacher.training


def test_main_trains_with_qat_and_distillation_together(teacher_dirs):
    """--train.qat with the distill flags, 2 steps per dispatch, in bf16:
    finite losses, and the state_dict's keys those of a plain run."""
    from tpuseg_torch.main import main

    tr = main(["--platform=cpu", *TINY, "--train.qat=true",
               f"--train.distill_checkpoint={teacher_dirs['unet']}",
               "--train.distill_alpha=0.5", "--train.distill_temperature=2",
               "--train.steps_per_dispatch=2", "--model.compute_dtype=bfloat16",
               "--train.loss=lovasz"])
    assert tr.step == 2 and len(tr.step_losses) == 2 and all(np.isfinite(tr.step_losses))
    assert sum(getattr(m, "qat", False) for m in tr.model.modules()) == 15
    plain = build_model(ModelConfig(name="unet", base_filters=BF)).state_dict()
    assert {k: v.shape for k, v in tr.model.state_dict().items()} == \
        {k: v.shape for k, v in plain.items()}
    assert "val_miou" in tr.history[-1]
