"""The port's convergence sweep (``tpuseg_torch/tools/convergence_sweep.py``)
against the JAX package's ``tools/convergence_sweep.py``.

- ``PRESETS``, ``protocol_flags`` and the ``--list`` output of both presets
  equal to the JAX tool's (loaded by file path); malformed grids refused
  (exit 2) as the JAX tool refuses them.
- A two-row grid (``ce`` and ``lovasz``) end to end on the CPU at the JAX
  smoke test's sizes (unet, base_filters 4, 32x16, batch 8, 24 scenes, one
  epoch, on the protocol's bf16 base config), with the post-eval on a
  held-out exported set, with and without flip TTA: both records ``ok``
  with the JAX tool's keys, mIoUs in [0, 1]; a second invocation skips
  both runs and appends nothing.
- Without ``--out`` the sweep writes under the temporary directory.
"""

from __future__ import annotations

import json

import pytest

from tests.torch_port_quant_inputs import jax_tool, two_threads  # noqa: F401
from tpuseg_torch.tools import convergence_sweep as port

TINY = ["--model.name=unet", "--model.base_filters=4", "--data.width=32", "--data.height=16",
        "--train.batch_size=8", "--train.log_every=0",
        '--data.sources=[{"kind":"synthetic","num_samples":24,"weight":1.0}]']
RECORD_KEYS = {"name", "flags", "ok", "seconds", "epochs", "val_miou", "car_iou",
               "holdout_miou", "holdout_car_iou", "holdout_miou_flip"}


@pytest.fixture(scope="module")
def jax_sweep():
    return jax_tool("convergence_sweep")


def test_presets_and_protocol_equal_jax(jax_sweep):
    assert port.PRESETS == jax_sweep.PRESETS
    assert (port.BAL, port.IMB) == (jax_sweep.BAL, jax_sweep.IMB)
    assert port.protocol_flags("x", 3, "/o") == jax_sweep.protocol_flags("x", 3, "/o")


@pytest.mark.parametrize("preset", ["loss_zoo", "composed_recipe"])
def test_list_equals_jax(jax_sweep, preset, capsys):
    assert jax_sweep.main(["--preset", preset, "--list"]) == 0
    want = capsys.readouterr().out
    assert port.main(["--preset", preset, "--list"]) == 0
    assert capsys.readouterr().out == want and want


@pytest.mark.parametrize("grid", ["missing", [["x", [], "not-a-dict"]], [["x"]], [[1, []]]],
                         ids=["missing_file", "bad_opts", "short", "bad_name"])
def test_bad_grid_refused_as_jax(jax_sweep, grid, tmp_path):
    path = tmp_path / "runs.json"
    if grid != "missing":
        path.write_text(json.dumps(grid))
    for tool in (jax_sweep, port):
        with pytest.raises(SystemExit) as exc:
            tool.main(["--runs", str(path), "--list"])
        assert exc.value.code == 2
    with pytest.raises(SystemExit):
        port.main([])   # neither --runs nor --preset


def test_default_out_under_tmpdir(tmp_path, monkeypatch):
    """Without --out the sweep writes under the temporary directory, so
    two checkouts with their own TMPDIR never share (and skip on) runs."""
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    runs = tmp_path / "runs.json"
    runs.write_text("[]")
    assert port.main(["--runs", str(runs), "--platform", "cpu"]) == 0
    assert (tmp_path / "convergence_sweep").is_dir()


def test_two_row_grid_end_to_end_and_idempotent(tmp_path, capsys):
    from tpuseg_torch.tools import export_synthetic_dataset

    val_dir = tmp_path / "val"
    assert export_synthetic_dataset.main(["--out", str(val_dir), "--num", "8", "--seed", "9",
                                          "--width", "32", "--height", "16"]) == 0
    runs = tmp_path / "runs.json"
    runs.write_text(json.dumps([["ce_t", TINY], ["lovasz_t", TINY + ["--train.loss=lovasz"]]]))
    out = tmp_path / "sw"
    assert port.main(["--runs", str(runs), "--out", str(out), "--epochs", "1",
                      "--eval_dir_bal", str(val_dir), "--post_eval_tta", "flip",
                      "--eval_args", "--model unet --base_filters 4 --width 32 --height 16",
                      "--platform", "cpu"]) == 0
    capsys.readouterr()
    recs = [json.loads(line) for line in (out / "sweep.jsonl").open()]
    assert [r["name"] for r in recs] == ["ce_t", "lovasz_t"]
    for r in recs:
        assert set(r) == RECORD_KEYS, r
        assert r["ok"] is True and r["epochs"] == 1
        for k in ("val_miou", "holdout_miou", "holdout_miou_flip"):
            assert 0.0 <= r[k] <= 1.0, (k, r)
    assert (out / "lovasz_t" / "history.jsonl").exists()
    assert (out / "lovasz_t" / "best").is_dir()

    # idempotent: complete runs are skipped, the summary is not appended to
    assert port.main(["--runs", str(runs), "--out", str(out), "--epochs", "1",
                      "--platform", "cpu"]) == 0
    assert capsys.readouterr().out.count("already complete, skip") == 2
    assert sum(1 for _ in (out / "sweep.jsonl").open()) == 2
