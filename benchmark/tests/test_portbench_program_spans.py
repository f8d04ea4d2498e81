"""The readers of the program's own spans (``benchmark/program_spans.py``)
in toy traced runs on the CPU: the span means are reported, the idle
shares (which need device activity) are left out, and no program span
name is taken for a device operation."""

from __future__ import annotations

import pytest

from benchmark.tests.test_portbench_drivers import toy_run

PROGRAM_LAYERS = ("train.", "data.", "graphs.", "serve.", "video.")


def _no_span_among_device_ops(line):
    ops = [name for name, _ in line["breakdown"]["device_ops"]]
    assert not [n for n in ops if n.startswith(PROGRAM_LAYERS)]


def test_traced_serve_run_reads_upload_and_fetch(toy_root, two_threads):
    line = toy_run(toy_root, "unet-serve-720p-b16", trace=1)
    for name in ("serve_upload_ms", "serve_fetch_ms"):
        assert line["metrics"][name]["value"] > 0 and line["metrics"][name]["unit"] == "ms"
    _no_span_among_device_ops(line)


@pytest.mark.parametrize("cell", ["unet-train-b64"])
def test_traced_train_run_reads_loss_read_and_assemble(toy_root, two_threads, cell):
    line = toy_run(toy_root, cell, trace=1)
    for name in ("train_loss_read_ms", "train_assemble_ms"):
        assert line["metrics"][name]["value"] > 0
    # no device on the CPU: the idle shares are left out, never 0
    assert "train_idle_input_share" not in line["metrics"]
    assert "train_idle_epoch_turn_share" not in line["metrics"]
    _no_span_among_device_ops(line)
