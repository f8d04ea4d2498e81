"""The port's recorder (tpuseg_torch/core/trace.py), the spans that the
Trainer, the loader and the Predictor open, and the benchmark's readers of
them (benchmark/program_spans.py, benchmark/metrics/), on the CPU at a toy
size: spans nest on their thread; off, the shared no-op and no device call;
under a profiler, a range of the same name at the same time; the loader's
producer thread records while the driving thread does; one span per
dispatch, batch and call; each reader's answer on a synthetic trace."""

import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.trace import WINDOW, TraceReading
from tests.torch_port_quant_inputs import two_threads  # noqa: F401
from tpuseg_torch.configs import ModelConfig, load_config
from tpuseg_torch.core import trace
from tpuseg_torch.core.trace import Span
from tpuseg_torch.infer.predictor import Predictor
from tpuseg_torch.train.trainer import Trainer

TINY = ["--model.name=unet", "--model.base_filters=4", "--data.height=32", "--data.width=64",
        "--train.batch_size=2", "--train.steps_per_epoch=4", "--train.loss=ce",
        "--train.steps_per_dispatch=2", "--data.val_split=0", "--train.epochs=1",
        "--train.checkpoint_dir=", "--train.history_file=none",
        '--data.sources=[{"kind":"synthetic","num_samples":8,"weight":1.0}]']
MS = 1_000_000      # ns


def _since(mark):
    return [s for s in trace.spans() if s.start_ns >= mark]


def _names(spans):
    out = {}
    for s in spans:
        out[s.name] = out.get(s.name, 0) + 1
    return out


def test_spans_nest_on_their_thread():
    mark = time.time_ns()
    with trace.recording():
        with trace.span("serve.call"):
            with trace.span("serve.upload", n=12):
                pass
            with trace.span("serve.fetch"):
                pass
        worker = threading.Thread(target=lambda: trace.span("data.assemble").__enter__()
                                  .__exit__(None, None, None))
        worker.start()
        worker.join()
    got = {s.name: s for s in _since(mark)}
    call, up, fetch = got["serve.call"], got["serve.upload"], got["serve.fetch"]
    assert call.parent is None and up.parent == fetch.parent == call.id
    assert up.n == 12 and call.n is None
    assert call.thread == up.thread == threading.get_ident()
    assert got["data.assemble"].thread != call.thread and got["data.assemble"].parent is None
    assert call.start_ns <= up.start_ns <= up.end_ns <= fetch.start_ns <= call.end_ns


def test_threads_record_at_once():
    """Eight threads open nested spans at once, switching every microsecond:
    each span is kept once, under its own thread's parent."""
    def work():
        for _ in range(200):
            with trace.span("probe.outer"):
                with trace.span("probe.inner"):
                    pass

    mark = time.time_ns()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with trace.recording():
            threads = [threading.Thread(target=work) for _ in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    got = [s for s in _since(mark) if s.name.startswith("probe.")]
    assert len(got) == 8 * 400 and len({s.id for s in got}) == len(got)
    by_id = {s.id: s for s in got}
    for s in got:
        if s.name == "probe.inner":
            outer = by_id[s.parent]
            assert outer.name == "probe.outer" and outer.thread == s.thread
        else:
            assert s.parent is None


def test_off_records_nothing_and_touches_no_device(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the recorder called the device")

    for name in ("synchronize", "current_stream", "Event", "is_available"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    mark = time.time_ns()
    assert trace.span("train.dispatch") is trace.NOOP
    assert trace.follower().span("data.assemble", n=3) is trace.NOOP
    with trace.span("train.dispatch"):
        pass
    totals = trace.Totals("video", ("post",))
    with totals.span("post"):
        time.sleep(0.002)
    assert totals.seconds["post"] >= 0.002     # the phase is timed all the same
    with trace.recording():                    # on: still no device call
        with trace.span("train.dispatch"):
            pass
    assert [s.name for s in _since(mark)] == ["train.dispatch"]


def test_profiled_spans_carry_their_range_on_the_same_clock():
    """Each span has a host range of its name in the profile (a ``cpu_op``:
    no user annotation, which CUPTI would mirror onto the device's row)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    names = [f"train.probe{i}" for i in range(20)]
    mark = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("warm"):
            pass
        for name in names:
            with trace.span(name):
                pass
    mine = {s.name: s for s in _since(mark)}
    events = [e for e in prof.profiler.kineto_results.events() if e.name() in mine]
    kineto = {e.name(): e.start_ns() for e in events}
    assert sorted(mine) == sorted(kineto) == sorted(names)
    assert not any(e.is_user_annotation() for e in events)
    for name in names:
        assert abs(kineto[name] - mine[name].start_ns) < MS, name
    # after the profiler: off again
    assert trace.span("train.probe") is trace.NOOP


@pytest.fixture(scope="module")
def trainer(two_threads):  # noqa: F811
    return Trainer(load_config(TINY), device="cpu")


def test_trainer_records_its_phases_and_the_producer_follows(trainer):
    from torch.profiler import ProfilerActivity, profile

    mark = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]):
        trainer.train(epochs=trainer.epoch + 1)
    spans = _since(mark)
    count = _names(spans)
    dispatches, batches = 2, 4
    assert count["train.dispatch"] == count["train.loss_read"] == count["train.stack"] \
        == dispatches
    assert count["data.wait"] == batches
    assert count["train.epoch"] == count["train.epoch_end"] == count["data.stop"] == 1
    producer = [s for s in spans if s.name == "data.assemble"]
    assert len(producer) == batches
    assert all(s.thread != threading.get_ident() and s.n == 2 * 32 * 64 * 4 for s in producer)
    epoch = next(s for s in spans if s.name == "train.epoch")
    main = [s for s in spans if s.thread == threading.get_ident() and s is not epoch]
    assert all(epoch.start_ns <= s.start_ns <= s.end_ns <= epoch.end_ns for s in main)


def test_predictor_call_records_each_phase_once(two_threads):  # noqa: F811
    pred = Predictor(ModelConfig(name="unet", base_filters=4), input_hw=(32, 64),
                     batch_size=2, device="cpu")
    frames = np.random.RandomState(0).randint(0, 256, (2, 40, 72, 3), np.uint8)
    mark = time.time_ns()
    with trace.recording():
        out = pred(frames)
    count = _names(_since(mark))
    assert out.shape == (2, 40, 72)
    assert count == {"serve.call": 1, "serve.upload": 1, "serve.pass": 1, "serve.fetch": 1,
                     "serve.finish_host": 1}
    got = {s.name: s for s in _since(mark)}
    assert got["serve.upload"].n == frames.nbytes and got["serve.fetch"].n == 2 * 32 * 64


# -- the benchmark's readers on a synthetic trace ---------------------------

def _reader(name):
    return harness.load_module(os.path.join(harness.PACKAGE, "metrics", name + ".py"))


def _synthetic(thread, device=True):
    """A 100 ms window, the device busy in [10,30), [40,60) and [70,90) ms,
    and the program's spans (ms): an epoch whose wait, loss read, producer
    shutdown and epoch end each hold one idle gap, two dispatches, two
    batches assembled on another thread, two served calls, and spans
    outside the window."""
    busy = [("k", 10 * MS, 30 * MS), ("k", 40 * MS, 60 * MS), ("k", 70 * MS, 90 * MS)]
    reading = TraceReading(busy if device else [], [(WINDOW, 0, 100 * MS)])
    rows = [("train.epoch", 5, 95, None), ("data.wait", 28, 41, 1),
            ("train.dispatch", 41, 45, 1), ("train.loss_read", 45, 62, 1),
            ("train.dispatch", 63, 66, 1), ("train.loss_read", 66, 69, 1),
            ("data.stop", 88, 91, 1), ("train.epoch_end", 91, 94, 1),
            ("train.loss_read", 200, 300, None)]
    served = [("serve.call", 0, 40, None), ("serve.upload", 1, 9, 1), ("serve.fetch", 12, 38, 1),
              ("serve.call", 50, 90, None), ("serve.upload", 51, 55, 4),
              ("serve.fetch", 56, 86, 4), ("serve.upload", -50, -1, None)]
    spans = [Span(n, s * MS, e * MS, p, thread, None, i + 1)
             for i, (n, s, e, p) in enumerate(rows)]
    # the producer's batches and the served calls: threads of their own
    spans += [Span("data.assemble", s * MS, e * MS, None, thread + 1, 8, 100 + s)
              for s, e in ((0, 4), (10, 16))]
    spans += [Span(n, s * MS, e * MS, p and p + 200, thread + 2, None, i + 201)
              for i, (n, s, e, p) in enumerate(served)]
    return {"trace": reading}, spans


@pytest.mark.parametrize("name,want", [
    ("train_idle_input_share", 10.0),        # [30,40) under data.wait
    ("train_idle_epoch_turn_share", 20.0),   # [0,10) outside the epoch, [90,100) data.stop
    ("train_loss_read_ms", 10.0),            # (17 + 3) ms over 2 dispatches
    ("train_assemble_ms", 5.0),              # (4 + 6) ms over 2 batches
    ("serve_upload_ms", 6.0),                # (8 + 4) ms over 2 calls
    ("serve_fetch_ms", 28.0),                # (26 + 30) ms over 2 calls
])
def test_reader_on_a_synthetic_trace(monkeypatch, name, want):
    out, spans = _synthetic(threading.get_ident())
    monkeypatch.setattr(trace, "spans", lambda: spans)
    reader = _reader(name)
    assert reader.read(None, out) == pytest.approx(want)
    # nothing to read: no traced window, or a program that recorded nothing
    assert reader.read(None, {"trace": None}) is None
    monkeypatch.setattr(trace, "spans", lambda: [])
    assert reader.read(None, out) is None
    if name.startswith("train_idle"):
        # no device activity (the CPU): no idle share
        monkeypatch.setattr(trace, "spans", lambda: spans)
        assert reader.read(None, _synthetic(threading.get_ident(), device=False)[0]) is None
        idle = 100.0 * (1 - out["trace"].busy_s / out["trace"].window_s)
        both = (_reader("train_idle_input_share").read(None, out)
                + _reader("train_idle_epoch_turn_share").read(None, out))
        assert both <= idle
