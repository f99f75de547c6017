"""Reading a ``torch.profiler`` trace: device intervals, busy time as their
union, the largest device operations and the longest idle gaps.

The traced window is the interval of the benchmark's own
``record_function(WINDOW)`` span. Busy time is the length of the union of
the device operations' intervals (kernels, copies and sets) clipped to it,
so operations that overlap on several streams count once; idle time is the
rest. An idle gap is named by the innermost host operation that covers its
middle: what the host was doing while the device waited.
"""

from __future__ import annotations

import collections
from typing import Dict, List, NamedTuple, Sequence, Tuple

WINDOW = "perfbench.window"


class Interval(NamedTuple):
    name: str
    start: float  # microseconds
    end: float


class Trace(NamedTuple):
    window: Tuple[float, float]
    device: List[Interval]
    host: List[Interval]

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6


def from_profiler(prof) -> Trace:
    """The window, device and host intervals of a finished profile."""
    from torch.autograd import DeviceType

    device, host, window = [], [], None
    for e in prof.events():
        iv = Interval(e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == DeviceType.CUDA:
            # a record_function span is mirrored on the device's timeline:
            # an annotation, not an operation
            if not getattr(e, "is_user_annotation", False) and e.name != WINDOW:
                device.append(iv)
        elif e.name == WINDOW:
            window = (iv.start, iv.end)
        else:
            host.append(iv)
    if window is None:
        raise RuntimeError(f"the trace has no {WINDOW!r} span")
    return Trace(window, device, host)


def union_s(intervals: Sequence[Interval], window: Tuple[float, float]) -> float:
    """Seconds covered by the union of ``intervals`` inside ``window``."""
    lo, hi = window
    spans = sorted((max(i.start, lo), min(i.end, hi)) for i in intervals)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e6


def gaps(trace: Trace) -> List[Tuple[float, float]]:
    """The idle intervals of the window (microseconds), longest first."""
    lo, hi = trace.window
    spans = sorted((max(i.start, lo), min(i.end, hi)) for i in trace.device)
    out, t = [], lo
    for s, e in spans:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return sorted(out, key=lambda g: g[0] - g[1])


def device_ops(trace: Trace, top: int = 10) -> List[List]:
    """[[name, seconds], ...]: the device operations that took most time."""
    by_name: Dict[str, float] = collections.defaultdict(float)
    lo, hi = trace.window
    for i in trace.device:
        by_name[i.name] += max(0.0, min(i.end, hi) - max(i.start, lo)) / 1e6
    return [[n, s] for n, s in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]]


def idle_gaps(trace: Trace, top: int = 10) -> List[List]:
    """[[what the host was doing, seconds], ...] for the longest idle gaps."""
    out = []
    for g0, g1 in gaps(trace)[:top]:
        mid = 0.5 * (g0 + g1)
        cover = [i for i in trace.host if i.start <= mid <= i.end]
        name = min(cover, key=lambda i: i.end - i.start).name if cover else "host (untraced)"
        out.append([name, (g1 - g0) / 1e6])
    return out


def kernel_seconds(trace: Trace, match) -> Tuple[float, int]:
    """(device seconds, launches) of the device operations whose name
    ``match(name)`` accepts, inside the window."""
    lo, hi = trace.window
    hits = [i for i in trace.device if match(i.name)]
    return sum(max(0.0, min(i.end, hi) - max(i.start, lo)) for i in hits) / 1e6, len(hits)
