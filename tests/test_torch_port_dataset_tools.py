"""The port's dataset tools against the JAX package's: ``export_synthetic_dataset``,
``make_demo_video`` and the ``first_contact`` chain (``tpuseg_torch/tools``).

- ``export_synthetic_dataset``: every file byte-equal to the JAX tool's at
  the same flags (PNG and JPEG, bdd100k and carla, ``--car_prob`` and
  ``--car_scale``), ``meta.json`` equal, the printed record equal.
- ``make_demo_video``: the same frames as the JAX tool's clip (decoded
  back, equal).
- Without cv2 (the import refused) both raise naming ROADMAP.md A9.
- ``first_contact``: the chain on a port-exported set on the CPU at the
  JAX smoke test's sizes (unet, base_filters 8, 64x32, batch 8, 2 epochs,
  ``--loss ce+dice``): every step's status the one the JAX chain reaches
  on the same flags (``tests/test_tools_smoke.py``), the best checkpoint
  written; ``--apply_weights`` with the default pure Lovász loss refused
  at argument time (exit 2) with the JAX tool's guidance.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import pytest

from tests.torch_port_quant_inputs import jax_tool, two_threads  # noqa: F401
from tpuseg_torch.tools import export_synthetic_dataset, first_contact, make_demo_video

cv2 = pytest.importorskip("cv2")

# the statuses the JAX chain reaches on the smoke flags (test_tools_smoke.py)
JAX_STATUSES = {"1-reader-smoke": "PASS", "2-class-stats": "PASS", "3-import-pth": "SKIP",
                "4-train": "PASS", "5-north-star": "PASS", "6-int8-gate": "PASS",
                "7-tta": "PASS"}


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _last_json(text):
    return json.loads(text.strip().splitlines()[-1])


@pytest.mark.parametrize("flags", [
    ["--num", "6", "--width", "64", "--height", "32"],
    ["--num", "5", "--kind", "carla", "--jpeg", "--seed", "3", "--width", "96",
     "--height", "48"],
    ["--num", "6", "--car_prob", "0.12", "--car_scale", "0.45", "--width", "64",
     "--height", "32"],
], ids=["bdd100k_png", "carla_jpeg", "imbalanced"])
def test_export_synthetic_dataset_byte_equal_to_jax(flags, tmp_path, capsys):
    assert jax_tool("export_synthetic_dataset").main(["--out", str(tmp_path / "jax"), *flags]) == 0
    want = _last_json(capsys.readouterr().out)
    assert export_synthetic_dataset.main(["--out", str(tmp_path / "port"), *flags]) == 0
    got = _last_json(capsys.readouterr().out)
    assert {**got, "out": ""} == {**want, "out": ""}
    names = _files(tmp_path / "jax")
    assert names == _files(tmp_path / "port") and "meta.json" in names
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes(), \
            name


def _frames(path):
    cap = cv2.VideoCapture(str(path))
    out = []
    while True:
        ok, frame = cap.read()
        if not ok:
            return np.stack(out)
        out.append(frame)


def test_make_demo_video_frames_equal_jax(tmp_path):
    assert jax_tool("make_demo_video").main(str(tmp_path / "j" / "demo.mp4"), 6, 96, 64) == 0
    assert make_demo_video._cli([str(tmp_path / "p" / "demo.mp4"), "6", "96", "64"]) == 0
    want, got = _frames(tmp_path / "j" / "demo.mp4"), _frames(tmp_path / "p" / "demo.mp4")
    assert got.shape == want.shape == (6, 64, 96, 3)
    assert np.array_equal(got, want)


def test_without_cv2_the_writers_raise_naming_a9(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)   # import raises ImportError
    with pytest.raises(RuntimeError, match="A9"):
        export_synthetic_dataset.main(["--out", str(tmp_path / "d"), "--num", "1"])
    with pytest.raises(RuntimeError, match="A9"):
        make_demo_video.main(str(tmp_path / "v" / "demo.mp4"), 1)


def test_first_contact_chain_end_to_end(tmp_path, capsys):
    data = tmp_path / "bdd"
    assert export_synthetic_dataset.main(["--out", str(data), "--num", "24", "--width", "64",
                                          "--height", "32"]) == 0
    capsys.readouterr()
    ckpt = tmp_path / "fc_ckpt"
    rc = first_contact.main(["--data_dir", str(data), "--checkpoint_dir", str(ckpt),
                             "--model", "unet", "--base_filters", "8", "--width", "64",
                             "--height", "32", "--batch", "8", "--epochs", "2",
                             "--smoke_limit", "8", "--loss", "ce+dice", "--platform", "cpu"])
    text = capsys.readouterr().out
    rec = _last_json(text)
    assert rc == 0, text
    assert list(rec) == ["first_contact", "ok", "miou", "seconds"]
    assert list(rec["first_contact"]) == list(JAX_STATUSES)
    assert {k: s["status"] for k, s in rec["first_contact"].items()} == JAX_STATUSES
    assert rec["ok"] is True and 0.0 <= rec["miou"] <= 1.0
    assert (ckpt / "best").is_dir()


def test_first_contact_apply_weights_refuses_pure_surrogate(tmp_path, capsys):
    with pytest.raises(SystemExit) as exc:
        first_contact.main(["--data_dir", str(tmp_path), "--apply_weights"])
    assert exc.value.code == 2  # an argparse error, before any step ran
    err = capsys.readouterr().err
    assert "ce+lovasz" in err and "apply_weights" in err
