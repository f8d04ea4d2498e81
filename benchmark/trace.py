"""The traced run: ``torch.profiler`` over the measured window (at most
``TRACED_SECONDS`` of it), the benchmark's own host spans, and their reduction to device busy time, the
top device operations and the idle gaps labelled by the open host span.

Host spans are ``record_function`` ranges named ``bench.<what>``, opened
by the drivers around their calls into the program; with tracing off they
cost nothing. Device activity is every kernel, copy and set on the card;
the GPU's copies of the host ranges (user annotations) are not activity.
"""

from __future__ import annotations

import contextlib
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

WINDOW = "bench.window"
# a traced run's window: long enough for the per-layer readings to settle,
# short enough that reading the trace keeps the run well inside its limit
TRACED_SECONDS = 10.0


def _kind(event) -> str:
    kind = getattr(event, "activity_type", None)
    return str(kind() if callable(kind) else kind).lower()


class Trace:
    """The profiler, when ``enabled``, started before the window (its own
    start-up is no part of it) and stopped after; ``window()`` marks the
    window itself."""

    def __init__(self, enabled: bool, device: torch.device):
        self.enabled = enabled
        self.device = device
        self.prof = None

    def span(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)

    def __enter__(self):
        if self.enabled:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=activities)
            self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self.enabled:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.prof.__exit__(*exc)
        return False

    def window(self):
        """The measured window's span, inside the profiled block."""
        return self.span(WINDOW)

    def seconds(self, requested: float) -> float:
        """The window's length: ``requested``, at most ``TRACED_SECONDS``
        when traced."""
        return min(requested, TRACED_SECONDS) if self.enabled else requested

    def reading(self) -> Optional["TraceReading"]:
        if self.prof is None:
            return None
        device, spans = [], []
        for e in self.prof.profiler.kineto_results.events():
            name = e.name()
            start = e.start_ns()
            end = start + e.duration_ns()
            if e.device_type() == torch.autograd.DeviceType.CPU:
                if name.startswith("bench."):
                    spans.append((name, start, end))
            elif "annotation" not in _kind(e) and not name.startswith("bench."):
                device.append((name, start, end))
        return TraceReading(device, spans)


def _merge(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], e))
        else:
            merged.append((s, e))
    return merged


class TraceReading:
    """Device intervals and host spans of one traced window, in ns."""

    def __init__(self, device: List[Tuple[str, int, int]], spans: List[Tuple[str, int, int]]):
        windows = [(s, e) for n, s, e in spans if n == WINDOW]
        self.start, self.end = (windows[0] if windows
                                else (min(s for _, s, _ in spans), max(e for _, _, e in spans)))
        self.device = [(n, max(s, self.start), min(e, self.end)) for n, s, e in device
                       if e > self.start and s < self.end]
        self.spans = [x for x in spans if x[0] != WINDOW]
        self.busy = _merge([(s, e) for _, s, e in self.device])

    @property
    def window_s(self) -> float:
        return (self.end - self.start) * 1e-9

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) * 1e-9

    def device_seconds(self, match) -> float:
        """Device seconds of the operations whose name ``match`` accepts."""
        return sum(e - s for n, s, e in self.device if match(n)) * 1e-9

    def device_ops(self, top: int = 10) -> List[List]:
        total: Dict[str, int] = defaultdict(int)
        for n, s, e in self.device:
            total[n] += e - s
        ranked = sorted(total.items(), key=lambda kv: -kv[1])[:top]
        return [[n[:120], t * 1e-9] for n, t in ranked]

    def idle_gaps(self, top: int = 10) -> List[List]:
        """The longest stretches of the window with nothing on the device,
        each named by the innermost benchmark span open where it starts."""
        edges = [self.start] + [x for iv in self.busy for x in iv] + [self.end]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for s, e in gaps[:top]:
            open_spans = [(n, ss, se) for n, ss, se in self.spans if ss <= s < se]
            label = min(open_spans, key=lambda x: x[2] - x[1])[0] if open_spans else "outside spans"
            out.append([label, (e - s) * 1e-9])
        return out
