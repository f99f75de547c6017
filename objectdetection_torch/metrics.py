"""Observability: step timing, profiler traces, debug checks, metric logs.

Port of ``objectdetection_tpu/metrics.py``:

- :class:`StepTimer`: wall-clock per-step timing, the first call (build and
  warm-up) kept apart from the steps.
- :func:`trace`: a ``torch.profiler`` context over the host and, where there
  is a card, the device; writes a Chrome trace (Perfetto opens it).
- :func:`check_finite` / :func:`check_boxes`: invariant checks, off by
  default. When on they count on the device and print the JAX module's
  messages on the host (a synchronisation); when off they return their input
  and launch nothing.
- :class:`MetricLogger`: scalar metrics in memory, optionally appended as
  jsonl.
- :func:`span` / :func:`count` / :func:`collect`: the program's own spans
  and counters, off by default (a span is then one shared null context, a
  count nothing). Under :func:`collect` a span keeps its host interval, its
  parent and its call, enters ``torch.profiler.record_function`` (so a
  profiler trace names what the program was doing) and, on a card, records
  a pair of CUDA events for its device extent; :meth:`Recording.resolve`
  reads them after one synchronisation. :func:`union_length`: the length of
  a union of intervals, a device's busy time from its kernels' intervals.

``enable_compilation_cache`` has no counterpart: it persists XLA
executables, and PyTorch runs eagerly. The port's one build product, the
CUDA kernel libraries, is cached by source hash in
``objectdetection_torch/_build/`` (``ops/cuda_build.py``).
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple

import torch


class StepTimer:
    """Tracks per-step wall time, separating the first (warm-up) step."""

    def __init__(self):
        self.compile_time: Optional[float] = None
        self.step_times: List[float] = []
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        if self.compile_time is None:
            self.compile_time = dt
        else:
            self.step_times.append(dt)

    @property
    def mean_step(self) -> float:
        return sum(self.step_times) / max(len(self.step_times), 1)

    def summary(self) -> Dict[str, float]:
        return {
            "compile_s": self.compile_time or 0.0,
            "mean_step_s": self.mean_step,
            "steps": len(self.step_times),
        }


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler over the enclosed code; writes ``log_dir/trace.json``."""
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


# --- debug-mode invariant checks (≙ the reference's DEBUG NaN handling) ----

_DEBUG_CHECKS = False


def enable_debug_checks(on: bool = True):
    """Globally toggle the invariant checks (off: they do nothing)."""
    global _DEBUG_CHECKS
    _DEBUG_CHECKS = on


def check_finite(x: torch.Tensor, name: str) -> torch.Tensor:
    """Count NaN/Inf values and print the count when enabled."""
    if not _DEBUG_CHECKS:
        return x
    bad = int((~torch.isfinite(x)).sum())
    print(f"[check_finite] {name}: {bad} non-finite of {x.numel()}", flush=True)
    return x


def check_boxes(boxes: torch.Tensor, name: str) -> torch.Tensor:
    """Count inverted (y1, x1, y2, x2) boxes and coordinates outside [0, 1]
    (by more than 1e-3) and print the counts when enabled."""
    if not _DEBUG_CHECKS:
        return boxes
    bad_order = int(((boxes[..., 2] < boxes[..., 0]) | (boxes[..., 3] < boxes[..., 1])).sum())
    oob = int(((boxes < -1e-3) | (boxes > 1 + 1e-3)).sum())
    print(f"[check_boxes] {name}: {bad_order} inverted, {oob} out-of-range", flush=True)
    return boxes


class MetricLogger:
    """Accumulates scalar metrics; optionally appends jsonl to a file."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self.history: List[Dict[str, Any]] = []

    def log(self, step: int, **metrics):
        row = {"step": step}
        row.update({k: float(v) if hasattr(v, "__float__") else v for k, v in metrics.items()})
        self.history.append(row)
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(row) + "\n")
        return row

    def latest(self) -> Dict[str, Any]:
        return self.history[-1] if self.history else {}


# --- spans and counters (off unless collected) -------------------------------


class Span:
    """One span of a :class:`Recording`: its ``name``, host ``start_ns`` and
    ``end_ns`` (``time.perf_counter_ns``), ``parent`` (the index of the
    enclosing span in ``Recording.spans``, None at the top), ``call`` (one id
    for a top-level span and everything inside it) and ``device_ms``: after
    :meth:`Recording.resolve` the device extent from its CUDA events, or the
    host extent where there are none."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "call", "device_ms", "events")

    def __init__(self, name: str, start_ns: int, parent: Optional[int], call: int, events):
        self.name, self.start_ns, self.end_ns = name, start_ns, None
        self.parent, self.call, self.device_ms, self.events = parent, call, None, events


class Recording:
    """The spans and counters recorded under one :func:`collect`. Each thread
    nests its own spans (the server calls the model on a worker thread)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.spans: List[Span] = []
        self.counters: Dict[str, Any] = {}
        self._calls = itertools.count()
        self._lock = threading.Lock()
        self._local = threading.local()

    def _stack(self) -> List[int]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def resolve(self) -> "Recording":
        """Synchronise once, then turn each finished span's events into
        ``device_ms`` and each counter into a Python number."""
        if self.device.type == "cuda" and any(s.events for s in self.spans):
            torch.cuda.synchronize(self.device)
        for s in self.spans:
            if s.end_ns is None or s.device_ms is not None:
                continue
            if s.events is None:
                s.device_ms = (s.end_ns - s.start_ns) / 1e6
            else:
                s.device_ms = s.events[0].elapsed_time(s.events[1])
                s.events = None
        self.counters = {k: v.item() if torch.is_tensor(v) else v
                         for k, v in self.counters.items()}
        return self

    def named(self, name: str) -> List[Span]:
        return [s for s in self.spans if s.name == name]


class _Open:
    """A span being recorded (the context :func:`span` returns when on)."""

    __slots__ = ("rec", "name", "fn", "span")

    def __init__(self, rec: Recording, name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        rec = self.rec
        self.fn = torch.profiler.record_function(self.name)
        self.fn.__enter__()
        events = None
        if rec.device.type == "cuda":
            events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            events[0].record(torch.cuda.current_stream(rec.device))
        stack = rec._stack()
        with rec._lock:
            parent = stack[-1] if stack else None
            call = next(rec._calls) if parent is None else rec.spans[parent].call
            self.span = Span(self.name, time.perf_counter_ns(), parent, call, events)
            rec.spans.append(self.span)
            stack.append(len(rec.spans) - 1)
        return self.span

    def __exit__(self, *exc):
        self.rec._stack().pop()
        if self.span.events is not None:
            self.span.events[1].record(torch.cuda.current_stream(self.rec.device))
        self.span.end_ns = time.perf_counter_ns()
        self.fn.__exit__(*exc)
        return False


_RECORDING: Optional[Recording] = None
_OFF = contextlib.nullcontext()


def span(name: str):
    """A context over one stage of the program, recorded under
    :func:`collect`; otherwise a shared null context that records nothing."""
    rec = _RECORDING
    if rec is None:
        return _OFF
    return _Open(rec, name)


def collecting() -> bool:
    """Whether spans and counters are being recorded (so that a caller
    computes a counter's value only then)."""
    return _RECORDING is not None


def count(name: str, value) -> None:
    """Add ``value`` (an int, or a 0-d tensor summed where it lives, with no
    synchronisation) to the counter ``name`` under :func:`collect`."""
    rec = _RECORDING
    if rec is None:
        return
    with rec._lock:
        prev = rec.counters.get(name)
        rec.counters[name] = value if prev is None else prev + value


@contextlib.contextmanager
def collect(device=None):
    """Record every span and counter of the enclosed code, on ``device``'s
    current stream (default: the card where there is one, else the CPU's
    host clock). Yields the :class:`Recording`; resolve it after the exit."""
    global _RECORDING
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    rec = Recording(torch.device(device))
    prev, _RECORDING = _RECORDING, rec
    try:
        yield rec
    finally:
        _RECORDING = prev


def union_length(intervals: Iterable[Tuple[float, float]]) -> float:
    """The length of the union of ``(start, end)`` intervals, in their unit:
    time covered by several (kernels on several streams) counts once."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
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
    return total
