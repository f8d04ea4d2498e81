"""The port's own spans and counters.

A span marks where a phase of the program's work happens on the host:

    with trace.span("serve.upload", n=x.nbytes):
        x = x.to(device)

It records the span's name, its start and end in ``time.time_ns()`` (the
clock on which ``torch.profiler`` stamps its events, so spans lie on the
same timeline as the device's kernels and copies), the enclosing span on
the same thread (its ``parent``), the thread, and an optional count ``n``
(rows or bytes moved at that boundary). Names are ``<layer>.<what>``.

When it records: while a ``torch.profiler`` records on the calling thread
(the profiler's state is per thread), and everywhere inside
``recording()``. On the profiled thread a span also opens a profiler range
of its name, so it shows in an exported trace (a ``cpu_op`` on the host's
row, on the device's clock). The range is a ``RecordFunctionFast``, not a
``record_function``: CUPTI mirrors a ``record_function``'s user annotation
onto the device's row, where a trace's reader takes it for device work
(a replay's annotation spans the whole graph, gaps included). A worker
thread's profiler state is its own and reads off, so a thread that the
program starts takes a ``follower()`` made on the thread that starts it:
the follower's spans record while that thread has a recorded span open. Recorded spans are kept in memory, the newest
``MAX_SPANS``, and read with ``spans()``; nothing is written.

Off, ``span()`` returns the one shared no-op context after a single check:
it allocates nothing and takes no lock. On or off, a span makes no device
call and never synchronizes.

``Totals`` times named phases whether or not the recorder records (the
video pipeline's phase sums), and records each as a span when it does.

Counters: ``launches`` counts the port's CUDA kernel launches per wrapper
(``ops/kernels.py``, ``ops/lovasz.py``, ``ops/mbconv.py``,
``ops/upsample.py``; a captured
graph adds its kernels' counts at every replay, ``core/graphs.py``) since
the last ``reset_launches()``. ``ops/kernels.py`` re-exports both.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import Dict, Iterator, List, NamedTuple, Optional, Sequence

import torch

# whether a torch.profiler records on the calling thread
_profiling = torch._C._autograd._profiler_enabled
# a profiler range on the host's row alone (see the module)
_host_range = torch._C._profiler._RecordFunctionFast

MAX_SPANS = 1 << 16


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[int]   # ``id`` of the enclosing span on the same thread
    thread: int             # ``threading.get_ident()`` of the recording thread
    n: Optional[int]
    id: int


_spans: "collections.deque[Span]" = collections.deque(maxlen=MAX_SPANS)
_ids = itertools.count(1)
# per thread, the ids of its recorded spans that are open, innermost last
_open: Dict[int, List[int]] = {}
_forced = 0
_forced_lock = threading.Lock()

# kernel launches per wrapper since the last reset_launches()
launches: Dict[str, int] = {
    "argmax_colorize": 0,
    "upsample2x_argmax": 0,
    "fused_upsample_concat_conv": 0,
    "lovasz_histograms": 0,     # tpuseg_torch/ops/lovasz.py
    "lovasz_lookup": 0,
    "lovasz_logits_histograms": 0,
    "lovasz_logits_grad": 0,
    "fused_inverted_residual": 0,   # tpuseg_torch/ops/mbconv.py
    "upsample_pow2": 0,             # tpuseg_torch/ops/upsample.py
    "upsample_pow2_grad": 0,
}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP = _Noop()


class _Open:
    """One span while it is open; ``record`` keeps it, ``into`` adds its
    seconds to ``into[0][into[1]]``."""

    __slots__ = ("name", "n", "record", "into", "rf", "start", "id", "parent", "stack")

    def __init__(self, name: str, n: Optional[int], annotate: bool, record: bool = True,
                 into=None):
        self.name, self.n, self.record, self.into = name, n, record, into
        self.rf = _host_range(name) if annotate else None

    def __enter__(self):
        if self.record:
            stack = _open.setdefault(threading.get_ident(), [])
            self.parent = stack[-1] if stack else None
            self.id = next(_ids)
            stack.append(self.id)
            self.stack = stack
        self.start = time.time_ns()
        if self.rf is not None:
            self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self.rf is not None:
            self.rf.__exit__(*exc)
        end = time.time_ns()
        if self.into is not None:
            seconds, key = self.into
            seconds[key] += (end - self.start) * 1e-9
        if self.record:
            self.stack.remove(self.id)
            _spans.append(Span(self.name, self.start, end, self.parent, threading.get_ident(),
                               self.n, self.id))
        return False


def span(name: str, n: Optional[int] = None):
    """A context that records ``name`` on this thread while recording is
    on (see the module), else the shared no-op."""
    if _profiling():
        return _Open(name, n, True)
    if _forced:
        return _Open(name, n, False)
    return NOOP


class Follower:
    """Spans of a worker thread, recorded while the thread that made this
    follower has a recorded span open (or inside ``recording()``)."""

    __slots__ = ("starter",)

    def __init__(self, starter: int):
        self.starter = starter

    def span(self, name: str, n: Optional[int] = None):
        if _forced or _open.get(self.starter):
            return _Open(name, n, False)
        return NOOP


def follower() -> Follower:
    """A follower of this thread, for a thread that it starts."""
    return Follower(threading.get_ident())


class Totals:
    """Seconds per phase of one layer, added by its spans whether or not
    the recorder records; recorded as ``<layer>.<phase>`` spans when it
    does."""

    def __init__(self, layer: str, phases: Sequence[str]):
        self.layer = layer
        self.seconds: Dict[str, float] = dict.fromkeys(phases, 0.0)

    def span(self, phase: str):
        profiling = _profiling()
        return _Open(f"{self.layer}.{phase}", None, profiling, bool(profiling or _forced),
                     (self.seconds, phase))


@contextlib.contextmanager
def recording() -> Iterator[None]:
    """Record spans on every thread, with or without a profiler, until the
    block ends."""
    global _forced
    with _forced_lock:
        _forced += 1
    try:
        yield
    finally:
        with _forced_lock:
            _forced -= 1


def spans() -> List[Span]:
    """The recorded spans, oldest first (at most ``MAX_SPANS``)."""
    return list(_spans)
