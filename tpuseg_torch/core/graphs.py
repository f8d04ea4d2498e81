"""Captured steps: the port's counterpart of ``jax.jit``.

The JAX package never runs a step op by op: each train step, eval step and
served batch is one compiled program. Here the same work is one CUDA graph
per shape key, replayed on every later call:

    step = graphs.Captured(fn, "train_step", generators=(gen,))
    out = step(x, y)      # first call at (x, y)'s shapes: eager + capture
    out = step(x2, y2)    # later calls: copy into the static inputs, replay

``Captured(fn, ...)`` is a callable with ``fn``'s signature. Tensor
arguments are the graph's inputs: each shape key (the tensors' shapes and
dtypes plus every other argument, which must be hashable) owns one set of
static input tensors, and a call copies its tensors into them before the
replay. The first call at a key runs ``fn`` eagerly on a side stream (the
warm-up PyTorch's recipe asks for: cuDNN's plans, the kernels' builds, the
lazily made constants), returns that result, and then captures ``fn`` on
the same inputs. Capture records work without running it, so the state
that ``fn`` updates in place (parameters, optimizer state, BatchNorm
statistics) moves once per call, as in eager mode.

A replay's outputs are the graph's static tensors: the next replay at the
same key overwrites them. A caller that holds an output across the next
call copies it (or queues its read on the current stream before that call,
which stream order then keeps ahead of the overwrite).

Random draws inside ``fn`` come from the generators named in
``generators``: they are registered with the graph, so a replay draws what
the eager call would have drawn from the same generator state, and
advances the generator as far.

Launch counts: ``tpuseg_torch.core.trace.launches`` (re-exported by
``ops/kernels.py``) counts launches where the wrappers run. A capture
does not launch, so the counts it made are taken back, kept with the
graph, and added again at every replay.

Spans (``core/trace.py``): ``graphs.capture`` around a warm-up and its
capture, ``graphs.copy_in`` around a call's copies into the static inputs
and ``graphs.replay`` around the replay's enqueue.

Memory: each entry holds its graph's private memory pool (the
intermediates of ``fn``) and its static inputs and outputs. ``max_keys``
bounds the entries: past it, the least recently called key is dropped with
its graph, and a later call at that key captures it again. Outputs a caller
still holds from a dropped graph stay valid (they keep their blocks).

Garbage: the collector runs before a capture and not during it. An
earlier graph that only a reference cycle still held would otherwise be
destroyed by a collection that happens to fall inside the capture, which
CUDA refuses there, and the capture is lost.

``fn`` runs uncaptured, with no key and no static buffers, when its
tensors lie on the CPU (nothing to capture there) or inside ``eager()``
(the counterpart of ``jax.disable_jit()``). A failed capture raises; it
never falls back to eager. The warm-up has run by then, so the state that
``fn`` updates has moved once, as after one eager call, and the side
stream's work is ordered before the current stream's later work.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import threading
from typing import Any, Callable, Iterator, Optional, Sequence, Tuple

import torch

from tpuseg_torch.core import trace
from tpuseg_torch.core.trace import launches

_local = threading.local()


@contextlib.contextmanager
def eager() -> Iterator[None]:
    """Run every captured function of the port uncaptured in this thread."""
    depth = getattr(_local, "eager", 0)
    _local.eager = depth + 1
    try:
        yield
    finally:
        _local.eager = depth


def is_eager() -> bool:
    return getattr(_local, "eager", 0) > 0


def _key(args: Sequence[Any]) -> Tuple:
    return tuple(("tensor", tuple(a.shape), a.dtype, a.device) if isinstance(a, torch.Tensor)
                 else ("static", a) for a in args)


@contextlib.contextmanager
def no_collection() -> Iterator[None]:
    """Collect the garbage now, then keep the collector off until the block
    ends (around a capture: see the module)."""
    gc.collect()
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


def _close_generator_capture(generators: Sequence[torch.Generator], stream) -> None:
    """Close the generators' capture that a failed capture left open.

    When CUDA invalidates a capture, PyTorch's capture end raises before it
    takes its generators (the device's default one and ``generators``) out
    of capture mode, and every later draw from them raises. One small
    capture that succeeds, with the same generators, takes them out."""
    graph = torch.cuda.CUDAGraph()
    for g in generators:
        graph.register_generator_state(g)
    with torch.cuda.graph(graph, stream=stream):
        torch.zeros(1, device=stream.device)


class _Entry:
    def __init__(self, graph, static_args, out, counts):
        self.graph = graph
        self.static_args = static_args
        self.out = out
        self.counts = counts


class Captured:
    """``fn`` captured into one CUDA graph per shape key (see the module)."""

    def __init__(self, fn: Callable, name: str,
                 generators: Sequence[torch.Generator] = (), max_keys: Optional[int] = None):
        self.fn = fn
        self.name = name
        self.generators = tuple(generators)
        self.max_keys = max_keys
        self.entries: "collections.OrderedDict[Tuple, _Entry]" = collections.OrderedDict()
        self.captures = 0       # graphs captured, dropped ones included
        self._replays = 0
        self._side = None       # the warm-up and capture stream, made at first use

    def __call__(self, *args):
        tensors = [a for a in args if isinstance(a, torch.Tensor)]
        if is_eager() or not tensors or tensors[0].device.type != "cuda":
            return self.fn(*args)
        devices = {t.device for t in tensors}
        if len(devices) != 1:
            raise ValueError(f"{self.name}: inputs on several devices {sorted(map(str, devices))}")
        key = _key(args)
        entry = self.entries.get(key)
        if entry is None:
            with trace.span("graphs.capture"):
                return self._warm_up_and_capture(key, args, devices.pop())
        self.entries.move_to_end(key)
        with trace.span("graphs.copy_in"):
            for static, a in zip(entry.static_args, args):
                if isinstance(a, torch.Tensor) and a.data_ptr() != static.data_ptr():
                    static.copy_(a)
        with trace.span("graphs.replay"):
            entry.graph.replay()
        self._replays += 1
        for k, n in entry.counts.items():
            launches[k] += n
        return entry.out

    def _warm_up_and_capture(self, key, args, device):
        if self._side is None:
            self._side = torch.cuda.Stream(device)
        side = self._side
        current = torch.cuda.current_stream(device)
        # the static inputs: this call's tensors, copied (a caller may reuse
        # or free its own tensors after the call)
        static_args = [a.detach().clone() if isinstance(a, torch.Tensor) else a for a in args]
        side.wait_stream(current)
        with torch.cuda.stream(side):
            out = self.fn(*static_args)
        before = dict(launches)
        graph = torch.cuda.CUDAGraph()
        try:
            for g in self.generators:
                graph.register_generator_state(g)
            with no_collection(), torch.cuda.graph(graph, stream=side,
                                                   capture_error_mode="thread_local"):
                static_out = self.fn(*static_args)
        except Exception as e:
            _close_generator_capture(self.generators, side)
            raise RuntimeError(f"CUDA graph capture of {self.name} failed at "
                               f"{list(key)}: {e}") from e
        finally:
            counts = {k: launches[k] - before[k] for k in launches if launches[k] != before[k]}
            launches.update(before)
            current.wait_stream(side)
        self.entries[key] = _Entry(graph, static_args, static_out, counts)
        self.captures += 1
        while self.max_keys is not None and len(self.entries) > self.max_keys:
            self.entries.popitem(last=False)
        return out

    def replays(self) -> int:
        """Replays so far, over every key (dropped ones included)."""
        return self._replays
