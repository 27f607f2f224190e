"""What a traced run reads: spans with their start and end, and the device
activity of torch.profiler, reduced to busy time, time by operation and idle
time by the innermost span open.

The program's spans (plonkish_tpu_torch/utils/timer.py) record a name, a
depth and a duration when they close, into the module's list ``_trace``.
``SpanLog`` takes that list's place for the traced run and stamps each
record with the host clock as it is appended, which gives the span's end and
so its start.  The harness adds spans of its own around each request (depth
-1, so that every program span nests inside one).
"""

from __future__ import annotations

import bisect
import time
from typing import Dict, List, Tuple

Span = Tuple[str, int, float, float]  # name, depth, start, end (perf_counter s)

BETWEEN = "harness (between requests)"


class SpanLog(list):
    """A stand-in for the program's span list that keeps each span's end."""

    def __init__(self):
        super().__init__()
        self.timed: List[Span] = []

    def append(self, item) -> None:
        end = time.perf_counter()
        name, depth, seconds = item
        self.timed.append((name, depth, end - seconds, end))
        super().append(item)


def attach(timer_module) -> SpanLog:
    log = SpanLog()
    timer_module._trace = log
    return log


def _merged(intervals):
    out = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


def union_seconds(intervals: List[Tuple[float, float]]) -> float:
    return sum(hi - lo for lo, hi in _merged(intervals))


def innermost_segments(spans: List[Span], lo: float, hi: float) -> List[Tuple[float, float, str]]:
    """[lo, hi) cut into pieces, each named by the deepest span open over it
    (BETWEEN where none is).  Spans nest, as a stack of calls does."""
    events = []
    for name, depth, s, e in spans:
        s, e = max(s, lo), min(e, hi)
        if e > s:
            events.append((s, 1, depth, name))
            events.append((e, 0, depth, name))
    events.sort(key=lambda ev: (ev[0], ev[1]))
    out, stack, cursor = [], [], lo
    for t, is_open, depth, name in events:
        if t > cursor:
            label = max(stack)[1] if stack else BETWEEN
            out.append((cursor, t, label))
            cursor = t
        if is_open:
            stack.append((depth, name))
        else:
            stack.remove((depth, name))
    if hi > cursor:
        out.append((cursor, hi, max(stack)[1] if stack else BETWEEN))
    return out


def idle_by_span(device: List[Tuple[float, float]], spans: List[Span], lo: float,
                 hi: float) -> Dict[str, float]:
    """Seconds of [lo, hi) in which the device ran nothing, by innermost span."""
    busy = _merged([(max(a, lo), min(b, hi)) for a, b in device if min(b, hi) > max(a, lo)])
    starts = [b[0] for b in busy]
    out: Dict[str, float] = {}
    for s, e, label in innermost_segments(spans, lo, hi):
        covered = 0.0
        i = max(bisect.bisect_right(starts, s) - 1, 0)
        while i < len(busy) and busy[i][0] < e:
            covered += max(0.0, min(e, busy[i][1]) - max(s, busy[i][0]))
            i += 1
        idle = (e - s) - covered
        if idle > 0:
            out[label] = out.get(label, 0.0) + idle
    return out


class DeviceTrace:
    """The device operations of a profiled stretch, on the host clock.

    The profiler's clock is tied to the host's by the stretch's first device
    operation, a fill of one element launched on an idle card at a known
    ``time.perf_counter()`` (``clock_mark``): it starts within the launch's
    latency, some microseconds, of that time."""

    MARK_OP = "fill"

    @staticmethod
    def clock_mark(device) -> float:
        import torch

        probe = torch.empty(1, device=device)
        torch.cuda.synchronize(device)
        t = time.perf_counter()
        probe.fill_(1.0)
        torch.cuda.synchronize(device)
        return t

    def __init__(self, prof, mark_perf_s: float):
        import torch

        ops = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA)
        if not ops or self.MARK_OP not in ops[0][2].lower():
            raise RuntimeError("the profiler's trace does not open with the clock mark")
        shift = mark_perf_s - ops[0][0] * 1e-6
        self.ops: List[Tuple[str, float, float]] = [
            (name, s * 1e-6 + shift, e * 1e-6 + shift) for s, e, name in ops[1:]
        ]

    def intervals(self):
        return [(s, e) for _, s, e in self.ops]

    def busy_seconds(self, lo: float, hi: float) -> float:
        return union_seconds([(max(s, lo), min(e, hi)) for s, e in self.intervals()
                              if min(e, hi) > max(s, lo)])

    def op_seconds(self, lo: float, hi: float) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, s, e in self.ops:
            if lo <= s < hi:
                out[name] = out.get(name, 0.0) + (e - s)
        return out

    def kernel_seconds_within(self, windows: List[Tuple[float, float]]) -> float:
        """Summed device time of the operations that start inside any of
        `windows` (the requests, each ended by a synchronisation)."""
        starts = sorted(windows)
        total = 0.0
        for _, s, e in self.ops:
            i = bisect.bisect_right(starts, (s, float("inf"))) - 1
            if i >= 0 and starts[i][0] <= s < starts[i][1]:
                total += e - s
        return total


def top(d: Dict[str, float], n: int = 10) -> List[List]:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: kv[1], reverse=True)[:n]]
