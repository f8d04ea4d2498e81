"""The port's Trainer and entry point (tpuseg_torch/train/trainer.py,
tpuseg_torch/main.py) on the CPU at a tiny size: 2 epochs of 2 steps write
two history lines and checkpoints, a resume continues from the saved step
with the saved sampler, a run without a card raises unless the CPU was asked
for, and the options that are not ported raise naming their ROADMAP item.
The Trainer options held against the JAX Trainer are in
tests/test_torch_port_steps.py.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpuseg_torch.configs import load_config
from tpuseg_torch.main import main
from tpuseg_torch.train.trainer import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--model.width_mult=0.25", "--data.height=32", "--data.width=64",
        "--train.batch_size=2", "--train.steps_per_epoch=2", "--train.loss=lovasz",
        "--data.val_split=0.25", "--train.log_every=1",
        '--data.sources=[{"kind":"synthetic","num_samples":12,"weight":1.0}]']


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs several workers on a few
    cores, and torch's default of one thread per core then oversubscribes
    them (this module ran 20x slower that way)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _history(ck):
    with open(os.path.join(ck, "history.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_entry_point_trains_checkpoints_and_resumes(tmp_path):
    ck = str(tmp_path / "ck")
    out = subprocess.run(
        [sys.executable, "-m", "tpuseg_torch.main", "--platform=cpu", *TINY,
         "--train.epochs=2", f"--train.checkpoint_dir={ck}"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert out.returncode == 0, out.stderr[-3000:]
    hist = _history(ck)
    assert [h["step"] for h in hist] == [2, 4]
    assert all(0 <= h["val_miou"] <= 1 and h["train_loss"] > 0 for h in hist)
    assert sorted(os.listdir(ck)) == ["best", "best.json", "history.jsonl",
                                      "step_2.pt", "step_4.pt"]
    saved = torch.load(os.path.join(ck, "step_4.pt"), weights_only=True)
    assert (saved["step"], saved["epoch"]) == (4, 2)

    tr = main(["--platform=cpu", *TINY, "--train.epochs=3", "--train.resume=true",
               f"--train.checkpoint_dir={ck}"])
    assert tr.step == 6 and tr.epoch == 3 and len(tr.step_losses) == 2
    assert [h["step"] for h in _history(ck)] == [2, 4, 6]
    # a fresh Trainer resumes the last checkpoint: weights, step, sampler
    again = Trainer(tr.cfg, device="cpu")
    assert again.maybe_resume() and again.step == 6
    sd, got = tr.model.state_dict(), again.model.state_dict()
    assert all(torch.equal(sd[k], got[k]) for k in sd)
    assert again.pipeline.state() == tr.pipeline.state()


def test_keep_checkpoints_and_no_checkpoint_dir(tmp_path):
    ck = str(tmp_path / "ck")
    cfg = load_config([*TINY, "--train.epochs=3", "--train.keep_checkpoints=2",
                       f"--train.checkpoint_dir={ck}", "--data.val_split=0"])
    tr = Trainer(cfg, device="cpu")
    tr.train()
    assert sorted(f for f in os.listdir(ck) if f.startswith("step_")) == \
        ["step_4.pt", "step_6.pt"]
    assert tr.history[-1]["step"] == 6 and "val_miou" not in tr.history[-1]
    tr = Trainer(load_config([*TINY, "--train.epochs=1", "--train.checkpoint_dir="]),
                 device="cpu")
    assert not tr.maybe_resume()
    assert len(tr.train()) == 1


def test_without_a_card_it_raises_unless_asked_for_the_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([*TINY, "--train.epochs=1", f"--train.checkpoint_dir={tmp_path}"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(load_config(TINY))
    with pytest.raises(ValueError, match="platform"):
        main(["--platform=tpu", *TINY])
    assert Trainer(load_config([*TINY, "--train.checkpoint_dir="]),
                   device="cpu").device.type == "cpu"


@pytest.mark.parametrize("flags", [["--mesh.data=2"], ["--mesh.data=1", "--mesh.spatial=2"]],
                         ids=["data", "spatial"])
def test_a_mesh_needs_its_ranks(flags):
    """One process trains on no mesh at --mesh.data -1 or 1; a larger data
    or spatial axis needs as many ranks (torchrun) and raises as the JAX
    mesh does without the devices. World-2 and world-4 (spatial) training
    is in tests/test_torch_port_mesh.py."""
    from tpuseg.core.mesh import create_mesh as jax_create_mesh

    for data in (-1, 1):
        cfg = load_config([*TINY, f"--mesh.data={data}", "--train.checkpoint_dir="])
        assert Trainer(cfg, device="cpu").mesh is None
    cfg = load_config([*TINY, *flags, "--train.checkpoint_dir="])
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        Trainer(cfg, device="cpu")
    with pytest.raises(ValueError, match="needs 16 devices, have 8"):
        jax_create_mesh(data=16)


def test_unported_sources_raise(monkeypatch, tmp_path):
    """A directory source needs cv2 to decode: without it the Trainer
    raises at construction, naming the packed route (the port has no
    other image decoder)."""
    (tmp_path / "images").mkdir()
    (tmp_path / "masks").mkdir()
    src = json.dumps([{"kind": "bdd100k", "img_dir": str(tmp_path / "images"),
                       "mask_dir": str(tmp_path / "masks"), "weight": 1.0}])
    cfg = load_config([*TINY[:-1], f"--data.sources={src}"])
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="tpuseg_torch.tools.pack_dataset"):
        Trainer(cfg, device="cpu")


def test_a_train_step_after_inference_at_the_same_shapes():
    """Serving runs under inference_mode; the resize taps and normalize
    constants it caches must still serve a training step's backward."""
    from tpuseg_torch.configs import ModelConfig
    from tpuseg_torch.models.registry import build_model
    from tpuseg_torch.train.optim import Optimizer
    from tpuseg_torch.train.train_step import make_train_step

    model = build_model(ModelConfig(width_mult=0.25, up_subpixel=False))
    x = torch.rand(1, 32, 96, 3)
    with torch.inference_mode():
        model.eval()(x.permute(0, 3, 1, 2))
    step = make_train_step(model, Optimizer(model.parameters()))
    assert torch.isfinite(step(x, torch.zeros(1, 32, 96, dtype=torch.int64))["loss"])


# -- the Trainer's options, held against the JAX Trainer ----------------------

JAX_TINY = ["--model.name=unet", "--model.base_filters=4", "--data.width=32",
            "--data.height=16", "--train.batch_size=8", "--train.checkpoint_dir=",
            "--train.log_every=0"]
SOURCES8 = '--data.sources=[{"kind":"synthetic","num_samples":16,"weight":1.0}]'


def _jax_trainer(flags):
    from tpuseg.configs import DatasetSourceConfig
    from tpuseg.configs import load_config as jax_load_config
    from tpuseg.train.trainer import Trainer as JaxTrainer

    cfg = jax_load_config(JAX_TINY + flags)
    cfg.data.sources = (DatasetSourceConfig(kind="synthetic", num_samples=16, weight=1.0),)
    return JaxTrainer(cfg)


def _port_trainer(flags):
    return Trainer(load_config(JAX_TINY + [SOURCES8] + flags), device="cpu")


def test_steps_per_dispatch_rounds_epochs_up_to_whole_groups():
    """steps_per_epoch=5 in dispatches of 2 trains 6 steps an epoch in both
    packages, and each epoch record logs the same step."""
    flags = ["--train.epochs=2", "--train.steps_per_epoch=5", "--train.steps_per_dispatch=2",
             "--data.val_split=0"]
    jt, pt = _jax_trainer(flags), _port_trainer(flags)
    jax_hist, port_hist = jt.train(), pt.train()
    assert [h["step"] for h in port_hist] == [h["step"] for h in jax_hist] == [6, 12]
    assert pt.step == jt.step == 12 and len(pt.step_losses) == 12


def test_resume_with_different_steps_per_dispatch(tmp_path):
    """The epoch counter is checkpointed: resuming 2 finished epochs of 3
    steps with dispatches of 2 re-runs nothing (tests/test_train.py)."""
    base = ["--train.epochs=2", "--train.steps_per_epoch=3", f"--train.checkpoint_dir={tmp_path}",
            "--data.val_split=0"]
    t = _port_trainer(base)
    t.train()
    assert (t.epoch, t.step) == (2, 6)
    t2 = _port_trainer(base + ["--train.steps_per_dispatch=2", "--train.resume=true"])
    assert t2.train() == [] and (t2.epoch, t2.step) == (2, 6)
    # a mid-epoch checkpoint resumes at a whole dispatch group: at step 7,
    # 3 steps of the second 4-step epoch (3 rounded up to 2 groups of 2)
    # are done; whole groups count 2, so 2 steps run
    t2.step, t2.epoch = 7, 1
    t2.save_checkpoint()
    t3 = _port_trainer(["--train.epochs=2", "--train.steps_per_epoch=3",
                        f"--train.checkpoint_dir={tmp_path}", "--data.val_split=0",
                        "--train.steps_per_dispatch=2", "--train.resume=true"])
    hist = t3.train()
    assert t3.step == 7 + 2 and [h["step"] for h in hist] == [9]


def _event_tags(directory):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    ea = EventAccumulator(str(directory), size_guidance={"scalars": 0, "tensors": 0})
    ea.Reload()
    tags = ea.Tags()
    out = {t: [e.step for e in ea.Scalars(t)] for t in tags["scalars"]}
    out.update({t: [e.step for e in ea.Tensors(t)] for t in tags["tensors"]})
    return out


def test_tensorboard_scalars_match_the_jax_trainer(tmp_path):
    """The same tags at the same steps as the JAX Trainer's ``_tb_scalars``."""
    pytest.importorskip("tensorflow")
    flags = ["--train.epochs=2", "--train.steps_per_epoch=2", "--data.val_split=0.25"]
    _jax_trainer(flags + [f"--train.tensorboard_dir={tmp_path}/jax"]).train()
    _port_trainer(flags + [f"--train.tensorboard_dir={tmp_path}/port"]).train()
    want, got = _event_tags(tmp_path / "jax"), _event_tags(tmp_path / "port")
    assert "train_loss" in got and "val_miou" in got
    assert got == want


def test_profile_dir_writes_a_trace(tmp_path):
    import glob

    tr = _port_trainer(["--train.epochs=1", "--train.steps_per_epoch=2",
                        f"--train.profile_dir={tmp_path}/prof"])
    tr.train()
    assert glob.glob(str(tmp_path / "prof" / "**" / "*.trace.json*"), recursive=True)
    assert any(e.key.startswith("aten::") for e in tr.profiler.key_averages())


def test_ema_horizon_warning_fires_where_the_jax_one_does(caplog):
    import logging

    base = ["--train.epochs=2", "--train.steps_per_epoch=4", "--data.val_split=0.25"]

    def warned(build, logger, decay):
        with caplog.at_level(logging.WARNING, logger=logger):
            caplog.clear()
            build(base + [f"--train.ema_decay={decay}"])
        return any("time constant" in r.message for r in caplog.records)

    for decay in (0.999, 0.5):
        assert warned(_jax_trainer, "tpuseg.train.trainer", decay) == \
            warned(_port_trainer, "tpuseg_torch.train.trainer", decay) == (decay == 0.999)


def test_ema_checkpoint_round_trips_and_the_predictor_serves_it(tmp_path):
    """EMA trains, is saved under its own key, is evaluated, restored on
    resume, and served by the Predictor from the checkpoint directory
    (tests/test_train.py's test_trainer_ema_train_checkpoint_serve)."""
    from tpuseg_torch.infer.predictor import Predictor

    flags = ["--train.epochs=2", "--train.steps_per_epoch=2", "--train.lr=1e-2",
             "--train.ema_decay=0.9", "--data.val_split=0.25",
             f"--train.checkpoint_dir={tmp_path}/ck"]
    tr = _port_trainer(flags)
    tr.train()
    ema = tr.optimizer.ema_state_dict(tr.model)
    raw = dict(tr.model.named_parameters())
    name = next(iter(ema))
    assert not torch.allclose(raw[name], ema[name])
    saved = torch.load(tmp_path / "ck" / "step_4.pt", weights_only=True)
    assert set(saved["ema"]) == set(ema) and "ema" not in saved["optimizer"]
    assert torch.equal(saved["model"][name], raw[name].detach())
    for path in (tmp_path / "ck", tmp_path / "ck" / "step_4.pt"):
        served = Predictor(tr.cfg.model, checkpoint=str(path), input_hw=(16, 32),
                           batch_size=1, device="cpu").model.state_dict()
        assert all(torch.equal(served[k], ema[k]) for k in ema)
    # eval ran on the EMA weights and left the raw ones in place
    assert "val_miou" in tr.history[-1] and torch.equal(
        dict(tr.model.named_parameters())[name], raw[name])
    tr2 = _port_trainer(flags)
    assert tr2.maybe_resume()
    got = tr2.optimizer.ema_state_dict(tr2.model)
    assert all(torch.equal(got[k], ema[k]) for k in ema)


@pytest.mark.parametrize("flags", [
    ["--train.optimizer=adamw"], ["--train.optimizer=sgd"],
    ["--train.grad_accum=2", "--train.optimizer=sgd"],
    ["--train.lr_schedule=cosine", "--train.warmup_steps=1", "--train.grad_clip_norm=1.0"],
    ["--train.eval_tta=flip", "--data.val_split=0.25"], ["--train.remat=true"],
])
def test_trainer_runs_each_option(flags):
    """Each option end to end through the port's Trainer (the JAX package's
    test_optimizer_options, test_trainer_grad_accum_config, ...)."""
    hist = _port_trainer(["--train.epochs=1", "--train.steps_per_epoch=2"] + flags).train()
    assert np.isfinite(hist[0]["train_loss"])
    if "--train.eval_tta=flip" in flags:
        assert 0.0 <= hist[0]["val_miou"] <= 1.0
    with pytest.raises(ValueError, match="unknown tta"):
        _port_trainer(["--train.eval_tta=scale"])


def test_debug_nans_trainer_runs_its_steps_uncaptured():
    from tpuseg_torch.core import graphs

    tr = _port_trainer(["--train.epochs=1", "--train.steps_per_epoch=1",
                        "--train.debug_nans=true"])
    assert not isinstance(tr.train_step, graphs.Captured)
    assert isinstance(_port_trainer([]).train_step, graphs.Captured)
    assert np.isfinite(tr.train()[0]["train_loss"])
