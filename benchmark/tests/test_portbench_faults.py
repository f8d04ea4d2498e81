"""``correct`` has to come out false when the timed path is broken under a
run, and for the control; and true for the sound program.

Each test drives a whole run at a toy size on the CPU (the program
computing in float32 so that a sound run reads near nought) with one fault
planted in the program: a step that leaves its state unchanged, half of
the batch left out (training: the loss the mean over the first half of
the rows; serving: the first half's maps served twice), and an answer
altered where it is produced (training: one leaf's gradient ten times what
the backward gave, as the optimizer gets it; serving: a frame's class map
replaced by its neighbour's); and for training a stale batch (each batch
the pipeline makes fed twice). The control is the reference one precision
below the configuration's (``reference/lowp.py``) in the program's place.
"""

from __future__ import annotations

import pytest
import torch

from benchmark import calibrate, compare, harness, run
from benchmark.tests.conftest import write_toy_root

SEED = 2 ** 31 + 777


@pytest.fixture(scope="module")
def fp32_root(tmp_path_factory):
    return write_toy_root(str(tmp_path_factory.mktemp("toy32")), compute_dtype="float32")


def toy_run(root, cell):
    return run.main(["--workload", cell, "--seed", str(SEED), "--seconds", "0.3",
                     "--trace", "0"], device="cpu", root=root)


@pytest.mark.parametrize("cell", ["unet-train-b64", "deeplab-train-c66"])
def test_sound_training_run_is_correct(fp32_root, cell, two_threads):
    assert toy_run(fp32_root, cell)["correct"]


@pytest.mark.parametrize("cell", ["unet-train-b64", "deeplab-train-c66"])
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "answer_altered",
                                   "batch_fed_twice"])
def test_training_fault_fails(fp32_root, cell, fault, monkeypatch, two_threads):
    from tpuseg_torch.data.pipeline import InputPipeline
    from tpuseg_torch.train import optim, trainer

    if fault == "batch_fed_twice":
        batches = InputPipeline.train_batches

        def stale(self, num_steps):
            inner = batches(self, (num_steps + 1) // 2)
            for i, item in zip(range(num_steps), (x for item in inner for x in (item, item))):
                yield item
            inner.close()

        monkeypatch.setattr(InputPipeline, "train_batches", stale)
    elif fault == "half_batch":
        monkeypatch.setattr(trainer, "make_loss_fn", calibrate.half_batch_loss(trainer.make_loss_fn))
    elif fault == "state_unchanged":
        monkeypatch.setattr(optim.Optimizer, "step", lambda self, grads=None: None)
    else:
        step = optim.Optimizer.step

        def altered(self, grads=None):
            grads = list(self.grads() if grads is None else grads)
            grads[0] = grads[0] * 10.0
            return step(self, grads)

        monkeypatch.setattr(optim.Optimizer, "step", altered)
    assert not toy_run(fp32_root, cell)["correct"]


def test_sound_serving_run_is_correct(fp32_root, two_threads):
    assert toy_run(fp32_root, "unet-serve-720p-b16")["correct"]


@pytest.mark.parametrize("fault", ["half_batch", "answer_altered"])
def test_serving_fault_fails(fp32_root, fault, monkeypatch, two_threads):
    from tpuseg_torch.infer.predictor import Predictor

    forward = Predictor._device_forward_eager

    def broken(self, frames, out_hw):
        if fault == "half_batch":
            half = frames[: len(frames) // 2]
            classes, packed = forward(self, torch.cat([half, half]), out_hw)
            return classes, packed
        classes, packed = forward(self, frames, out_hw)
        return torch.cat([classes[1:2], classes[1:]]), packed

    monkeypatch.setattr(Predictor, "_device_forward_eager", broken)
    assert not toy_run(fp32_root, "unet-serve-720p-b16")["correct"]


@pytest.mark.parametrize("cell", ["unet-train-b64", "deeplab-train-c66", "unet-serve-720p-b16"])
def test_control_fails(toy_root, cell, two_threads):
    bench = harness.load_json(f"{toy_root}/BENCHMARK.json")
    entry = next(w for w in bench["workloads"] if w["name"] == cell)
    workload = harness.load_json(harness.find(toy_root, "workloads", cell, ".json"))
    config = harness.load_json(harness.find(toy_root, "configs", entry["config"], ".json"))
    driver = harness.load_module(harness.find(toy_root, "drivers", workload["driver"], ".py"))
    ctx = harness.Context(name=cell, workload=workload, config=config, seed=SEED, seconds=0.3,
                          trace=False, device=torch.device("cpu"), chips=1, t0=0.0,
                          root=toy_root, notes={"keep_inputs": True})
    driver.run(ctx)
    inputs = ctx.notes["inputs"]
    if workload["driver"] == "train_loop":
        readings = calibrate.train_readings(ctx, inputs, faults=False)
    else:
        readings = calibrate.serve_readings(ctx, inputs)
    assert not compare.verdict(readings["control"], workload["limits"])
