"""Timings of the program's calls taken after a traced window, by CUDA
events of the benchmark's own on the device's clock (by the host clock on
the CPU): the whole timed call, and the backbone prefix bound as the call
binds it (the stage tool's prefix rule). Each is taken once a run and kept
in the layer context's ``memo``, so the readers that share it read the same
number."""

from __future__ import annotations

import time

import torch


def cuda_ms(fn, n: int) -> float:
    """Milliseconds a call of ``fn`` over ``n`` calls."""
    if not torch.cuda.is_available():
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t0) * 1e3 / n
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def _once(ctx, key: str, fn) -> float:
    if key not in ctx.memo:
        ctx.memo[key] = cuda_ms(fn, ctx.params["span_calls"])
        ctx.log(f"{key}: {ctx.memo[key]:.3f} ms a batch")
    return ctx.memo[key]


def call_ms(ctx) -> float:
    """ms a batch of the whole timed call."""
    return _once(ctx, "call_ms", lambda: ctx.system.call(*ctx.inputs))


def backbone_ms(ctx) -> float:
    """ms a batch of the program's ResNet-FPN alone (to P2-P6)."""
    return _once(ctx, "backbone_ms", lambda: ctx.system.backbone(ctx.inputs[0]))
