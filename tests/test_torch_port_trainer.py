"""The port's Trainer and entry point (tpuseg_torch/train/trainer.py,
tpuseg_torch/main.py) on the CPU at a tiny size: 2 epochs of 2 steps write
two history lines and checkpoints, a resume continues from the saved step
with the saved sampler, a run without a card raises unless the CPU was asked
for, and the options that are not ported raise naming their ROADMAP item.
"""

import json
import os
import subprocess
import sys

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


@pytest.mark.parametrize("flag,item", [
    ("--train.optimizer=sgd", "A7"), ("--train.lr_schedule=cosine", "A7"),
    ("--train.ema_decay=0.99", "A7"), ("--train.grad_accum=2", "A7"),
    ("--train.grad_clip_norm=1.0", "A7"), ("--train.remat=true", "A7"),
    ("--train.eval_tta=flip", "A7"), ("--train.profile_dir=p", "A7"),
    ("--train.tensorboard_dir=t", "A7"), ("--train.qat=true", "A11"),
    ("--train.distill_checkpoint=x", "A11"), ("--train.class_weights=auto", "A8"),
    ("--mesh.data=2", "A13"), ("--mesh.spatial=2", "A13"),
    ("--data.heavy_augment=true", "A8"),
])
def test_unported_options_raise(flag, item):
    cfg = load_config([*TINY, flag, "--train.checkpoint_dir="])
    with pytest.raises(NotImplementedError, match=item):
        Trainer(cfg, device="cpu")


def test_unported_sources_raise():
    cfg = load_config([*TINY[:-1], '--data.sources=[{"kind":"bdd100k","weight":1.0}]'])
    with pytest.raises(NotImplementedError, match="A8"):
        Trainer(cfg, device="cpu")


def test_a_train_step_after_inference_at_the_same_shapes():
    """Serving runs under inference_mode; the resize taps and normalize
    constants it caches must still serve a training step's backward."""
    from tpuseg_torch.configs import ModelConfig
    from tpuseg_torch.models.registry import build_model
    from tpuseg_torch.train.train_step import create_optimizer, make_train_step

    model = build_model(ModelConfig(width_mult=0.25, up_subpixel=False))
    x = torch.rand(1, 32, 96, 3)
    with torch.inference_mode():
        model.eval()(x.permute(0, 3, 1, 2))
    step = make_train_step(model, create_optimizer(model))
    assert torch.isfinite(step(x, torch.zeros(1, 32, 96, dtype=torch.int64))["loss"])
