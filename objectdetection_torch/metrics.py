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

``enable_compilation_cache`` has no counterpart: it persists XLA
executables, and PyTorch runs eagerly. The port's one build product, the
CUDA kernel libraries, is cached by source hash in
``objectdetection_torch/_build/`` (``ops/cuda_build.py``).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Dict, List, Optional

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
