"""The program's own spans (``tpuseg_torch/core/trace.py``) in a traced
run's window, and the device's idle gaps put down to them.

The program records its spans while a profiler records on the thread that
drives it: in a traced run, the benchmark's profiled block. They are read
in the run's own process, from the thread that drove the run, after the
window, and only those that lie inside the window (``TraceReading.start``
to ``end``, on the same clock) count. A program without the recorder gives
nothing to read, and each reader then returns None.

An idle gap of the device belongs to the innermost program span open on the
driving thread at the gap's start, the rule that ``TraceReading.idle_gaps``
applies to the benchmark's own spans.
"""

from __future__ import annotations

import bisect
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple


def recorded() -> Optional[List]:
    """Every span the program has recorded in this process, or None for a
    program without the recorder."""
    try:
        from tpuseg_torch.core import trace
    except ImportError:
        return None
    return trace.spans()


def in_window(out: Dict) -> Optional[List]:
    """The spans that start and end inside the traced window, or None
    without a traced window or a recorder."""
    reading = out.get("trace")
    spans = recorded()
    if reading is None or spans is None:
        return None
    return [s for s in spans if s.start_ns >= reading.start and s.end_ns <= reading.end]


def mean_ms(out: Dict, name: str, per: str) -> Optional[float]:
    """Milliseconds of the ``name`` spans in the window over the number of
    ``per`` spans there (a dispatch, a call, a batch); None where either is
    missing."""
    got = in_window(out)
    if not got:
        return None
    times = [s.end_ns - s.start_ns for s in got if s.name == name]
    count = sum(s.name == per for s in got)
    return sum(times) * 1e-6 / count if times and count else None


def _gaps(reading) -> List[Tuple[int, int]]:
    """Every stretch of the window with nothing on the device."""
    edges = [reading.start] + [x for iv in reading.busy for x in iv] + [reading.end]
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]


def _open_chains(spans: Sequence, thread: int) -> Tuple[List[int], List[Tuple[str, ...]]]:
    """For the spans of ``thread``, which nest: the times at which the set
    of open spans changes, and after each the names open then, outermost
    first."""
    events = []
    for s in spans:
        if s.thread == thread:
            events.append((s.start_ns, 1, s.id, s.name))
            events.append((s.end_ns, 0, s.id, s.name))
    events.sort()
    times: List[int] = []
    chains: List[Tuple[str, ...]] = []
    stack: List[Tuple[int, str]] = []
    for t, starts, sid, name in events:
        if starts:
            stack.append((sid, name))
        else:
            stack.remove(next(x for x in stack if x[0] == sid))
        chain = tuple(n for _, n in stack)
        if times and times[-1] == t:
            chains[-1] = chain
        else:
            times.append(t)
            chains.append(chain)
    return times, chains


def idle_share(out: Dict, belongs: Callable[[Tuple[str, ...]], bool]) -> Optional[float]:
    """Percent of the traced window in which the device is idle and the
    names of the program spans open on the driving thread at the gap's
    start (outermost first) satisfy ``belongs``. None without device
    activity or without program spans in the window."""
    reading = out.get("trace")
    spans = recorded()
    if reading is None or reading.busy_s <= 0 or spans is None:
        return None
    thread = threading.get_ident()
    near = [s for s in spans if s.end_ns > reading.start and s.start_ns < reading.end]
    if not any(s.thread == thread for s in near):
        return None
    times, chains = _open_chains(near, thread)
    idle = 0
    for s, e in _gaps(reading):
        i = bisect.bisect_right(times, s) - 1
        if belongs(chains[i] if i >= 0 else ()):
            idle += e - s
    return 100.0 * idle / (reading.end - reading.start)


def input_wait(chain: Tuple[str, ...]) -> bool:
    """A gap while the loop waits for a batch."""
    return bool(chain) and chain[-1] == "data.wait"


def epoch_turn(chain: Tuple[str, ...]) -> bool:
    """A gap in the turn between epochs: under the epoch end or the
    producer's shutdown, or outside every epoch."""
    if input_wait(chain):
        return False
    return "train.epoch_end" in chain or "data.stop" in chain or "train.epoch" not in chain
