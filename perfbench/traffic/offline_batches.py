"""Offline batches: an image job that runs the program over fixed batches
as fast as the card allows and stores every batch's detections on the host.

Parameters of the mix (``perfbench/traffic/<traffic>.json``): ``batch``
images a call, ``distinct`` batches made from the seed and run in turn (so
that no call repeats the one before it), ``masks`` whether the job asks for
masks. Of the cell (its ``params``): ``sample`` answers compared with the
reference after the window, ``ref_block`` images the reference runs at
once, ``warm`` calls before the window, ``trace_batches`` calls profiled at
the start of a ``--trace 1`` window, ``span_calls`` calls timed apiece
after it (:mod:`perfbench.timing`).

Images are uniform pixels in [0, 255) less the configuration's mean pixel
(a molded image), made on the card from the seed, one generator stream a
batch; the window of real content is the whole canvas.

``images_per_s``: every image of every batch completed, over the time from
the first timed batch's start to the end of the first batch that completes
after ``--seconds`` have passed; each batch ends when its detections are on
the host, so the window ends on a batch boundary.
"""

from __future__ import annotations

import contextlib
import time
from types import SimpleNamespace

import numpy as np
import torch

from perfbench import trace as trace_lib
from perfbench.seeds import stream_seed


def images_maker(sizes: dict, seed: int, device):
    """``make(stream, n)``: n molded images of the stream ``stream``."""
    h, w = sizes["image_shape"][:2]
    mean = torch.tensor(sizes["mean_pixel"], dtype=torch.float32, device=device)

    def make(stream: str, n: int) -> torch.Tensor:
        gen = torch.Generator(device=device).manual_seed(stream_seed(seed, stream))
        return torch.rand((n, h, w, 3), generator=gen, device=device) * 255.0 - mean

    return make


def _select(outputs, rows):
    return tuple(None if o is None else o[rows] for o in outputs)


def _stack(parts):
    return tuple(None if parts[0][i] is None else np.concatenate([p[i] for p in parts])
                 for i in range(len(parts[0])))


def run(run_ctx) -> dict:
    """One run of the cell; returns the harness's result pieces."""
    p, sizes, dev, log = run_ctx.params, run_ctx.sizes, run_ctx.device, run_ctx.log
    b = p["batch"]
    make = images_maker(sizes, run_ctx.seed, dev)
    system = run_ctx.system_cls(sizes, p, stream_seed(run_ctx.seed, "weights"), dev, make, log)
    batches = [make(f"batch{i}", b) for i in range(p["distinct"])]
    h, w = sizes["image_shape"][:2]
    windows = torch.tensor([[0.0, 0.0, float(h), float(w)]], device=dev).repeat(b, 1)
    for i in range(p["warm"]):
        system.call(batches[i % len(batches)], windows)
    setup_s = time.perf_counter() - run_ctx.t_start
    log(f"set-up {setup_s:.3f} s")

    layer_ctx = SimpleNamespace(system=system, sizes=sizes, params=p, log=log, memo={},
                                batch=b, inputs=(batches[0], windows), trace=None, batches=0)
    outputs, prof, recorders, traced = [], None, None, None
    if run_ctx.trace:
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
        recorders = contextlib.ExitStack()
        for reader in run_ctx.readers.values():
            if hasattr(reader, "install"):
                recorders.enter_context(reader.install(layer_ctx))
        recorders.enter_context(torch.profiler.record_function(trace_lib.WINDOW))

    def stop_trace():
        recorders.close()
        prof.__exit__(None, None, None)
        return len(outputs)

    t0 = time.perf_counter()
    while True:
        outputs.append(system.call(batches[len(outputs) % len(batches)], windows))
        if prof is not None and traced is None and len(outputs) == p["trace_batches"]:
            traced = stop_trace()
        if time.perf_counter() - t0 >= run_ctx.seconds:
            break
    elapsed = time.perf_counter() - t0
    if prof is not None and traced is None:
        traced = stop_trace()
    n = len(outputs)
    log(f"window: {n} batches of {b} in {elapsed:.3f} s")
    res = {"attempted": n * b, "failed": 0,
           "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))
           if dev.type == "cuda" else 0,
           "metrics": {"images_per_s": n * b / elapsed, "setup_s": setup_s}}

    if run_ctx.trace:
        tr = trace_lib.from_profiler(prof)
        del prof
        res["trace"] = tr
        res["breakdown"] = {"device_ops": trace_lib.device_ops(tr),
                            "idle_gaps": trace_lib.idle_gaps(tr)}
        layer_ctx.trace, layer_ctx.batches = tr, traced
        res["layers"] = {name: reader.read(layer_ctx) for name, reader in run_ctx.readers.items()}

    # the sample of answers, drawn from the seed after the window
    rng = np.random.default_rng(stream_seed(run_ctx.seed, "sample"))
    picks = np.sort(rng.choice(n * b, size=min(p["sample"], n * b), replace=False))
    got = _stack([_select(outputs[i // b], [i % b]) for i in picks])
    which = [((i // b) % len(batches), i % b) for i in picks]
    system.release()
    del outputs
    want_parts = []
    for k in range(0, len(which), p["ref_block"]):
        block = which[k:k + p["ref_block"]]
        imgs = torch.stack([batches[j][i] for j, i in block])
        answers = _select(got, slice(k, k + len(block)))
        want_parts.append(system.reference(imgs, windows[:len(block)], answers=answers))
    res["numbers"] = system.compare(got, _stack(want_parts))
    return res
