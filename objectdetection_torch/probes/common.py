"""Pieces the probes share: the device rule, the card's name and power
limit, device timing, and the timed run of a probe entry point."""

from __future__ import annotations

import subprocess
from typing import Callable, Dict, Tuple

import torch

from objectdetection_torch.metrics import StepTimer


def resolve_device(device) -> torch.device:
    """The device a probe runs on: the card unless the caller asks for the
    CPU; raises where the card is asked for and there is none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the probes run on a CUDA card, and none is available "
                           "(pass device='cpu', or --device cpu, for the plain versions)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def card() -> str:
    """``nvidia-smi --query-gpu=name,power.limit``'s line for the first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def per_call_ms(prof, reps: int) -> Dict[str, float]:
    """Device ms per call of each kernel name in a profile of ``reps`` calls:
    the mean of the records the profiler kept, times the launches a call
    makes (its records over ``reps``, rounded). The profiler can lose a
    record (it once dropped one launch in five, which read as a time below
    the byte bound); this keeps such a loss from shrinking the time."""
    out: Dict[str, float] = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.count and e.self_device_time_total:
            launches = max(1, round(e.count / reps))
            out[e.key] = out.get(e.key, 0.0) + e.self_device_time_total / e.count * launches / 1e3
    return out


def device_ms(fn: Callable[[], object], reps: int = 20) -> float:
    """Device time per call of everything ``fn`` launches, from
    torch.profiler (CUDA events around back-to-back calls measure the host
    where a call's enqueue outlasts its kernels)."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, acc_events=True) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(per_call_ms(prof, reps).values())
    if not total > 0:
        raise RuntimeError("device_ms: the profiler saw no device time")
    return total


def timed(fn: Callable[[], object], iters: int, device: torch.device) -> Tuple[float, StepTimer]:
    """ms per call of ``fn`` over ``iters`` calls after one warm-up call
    (which builds the kernels): CUDA events on the card, the host clock
    (``StepTimer``) on the CPU. The timer keeps the warm-up apart."""
    timer = StepTimer()
    with timer:
        fn()
        if device.type == "cuda":
            torch.cuda.synchronize()
    if device.type != "cuda":
        for _ in range(iters):
            with timer:
                fn()
        return timer.mean_step * 1e3, timer
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with timer:
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
    return start.elapsed_time(end) / iters, timer


def check_flag(err: torch.Tensor, what: str, messages) -> None:
    """Raise on the kernel's error flag (bit i: ``messages[i]``); a
    synchronisation."""
    flag = int(err.item())
    if flag:
        bad = [m for i, m in enumerate(messages) if flag >> i & 1]
        raise ValueError(f"{what}: " + "; ".join(bad))
