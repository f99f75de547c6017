"""Mask R-CNN inference throughput on the card: the port of the root ``bench.py``.

    python -m objectdetection_torch.bench [--batch 96] [--iters 6] [--warmup 2] [...]
    odtorch bench [the same flags]

Prints ONE JSON line, last on stdout, with ``bench.py``'s keys and rounding:
``metric`` (``maskrcnn_r101_1024_infer_throughput`` whatever the backbone and
size, as ``bench.py`` names it), ``value`` (images/s, 2 decimals), ``unit``,
``vs_baseline`` (``value`` over :data:`BASELINE_IMAGES_PER_SEC`, 3 decimals)
and ``config`` (``int8_ptq`` or ``bf16``, ``_pc`` for per-channel int8,
``_realistic``, ``_b{batch}``). Everything else goes to stderr.

The recipe is ``bench.py``'s, step for step (:func:`main`): ``COCO_CONFIG``
with the flags' overrides (:func:`bench_config`); ``init_params`` seed 0;
with ``--realistic`` the RPN's box-delta kernels × 0.02
(:func:`temper_rpn_deltas`); every floating tensor cast to bf16 once; images
``RandomState(0).rand(B, S, S, 3) · 255 − 128``, windows the whole canvas;
for int8 (the default) a calibrated and frozen state at percentile 90 over
chunks of ``max(1, B // 16)`` images, read from or written to an artifact
(:func:`serving_state`); then the timing.

Timing. ``bench.py`` runs its iterations as one program on the device
(``fori_loop``, each output folded back into the next input) and reports
``(t(1 + iters) − t(1)) / iters``, which cancels a dispatch and a readback.
The port's loop is eager with the same fold-back, so every call depends on
the one before it; each iteration pays its host launch overhead, which is
what the port's callers pay, and the same difference is reported. The kernel
build (``ops/cuda_build``), the first call, the peak device memory of the
timed runs, and the device-busy share and largest kernels of one profiled
call go to stderr, with the card's name and power limit.

Flags: ``bench.py``'s, with the same names, defaults and meanings, plus
``--device`` (default ``cuda``; without a card the command raises unless
given ``--device cpu``). ``--pallas-align`` and ``--s2d-stage2`` set config
fields the port reads and ignores, ``--approx-topk`` sets
``use_approx_topk``, which the port reads as exact top-k, and
``--no-xla-cache`` has nothing to act on: they are accepted so that
``bench.py``'s command lines run unchanged. ``--quant-cache auto`` keys its
artifact under ``artifacts/torch_quant_*`` (the port's own format,
``checkpoint.save_quantized``, which JAX's orbax directories are not).
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import sys
import time
from typing import Dict, Optional

import numpy as np
import torch

METRIC = "maskrcnn_r101_1024_infer_throughput"
BASELINE_IMAGES_PER_SEC = 200.0  # BASELINE.json's north-star target
ARTIFACTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "artifacts")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="odtorch bench", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--batch", type=int, default=96)
    p.add_argument("--iters", type=int, default=6)
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument("--backbone", default="resnet101")
    p.add_argument("--image-size", type=int, default=1024)
    p.add_argument("--no-masks", action="store_true")
    p.add_argument("--int8", dest="int8", action="store_true", default=True,
                   help="int8 PTQ inference (quant.py, DEFAULT): calibrated on the benchmark's "
                   "images before timing")
    p.add_argument("--no-int8", dest="int8", action="store_false",
                   help="bf16 inference instead of int8 PTQ")
    p.add_argument("--quant-cache", default="auto",
                   help="directory of the calibrated and frozen int8 artifact "
                   "(checkpoint.save_quantized): 'auto' (default) keys a path under artifacts/ "
                   "by backbone and size, 'off' disables it. The first run calibrates and saves, "
                   "later runs load")
    p.add_argument("--pallas-align", choices=["all", "masks", "off"], default=None,
                   help="sets cfg.pallas_roi_align, which the port reads and ignores (one "
                   "ROIAlign route on the card); accepted for bench.py's command lines")
    p.add_argument("--s2d-stage2", dest="s2d_stage2", action="store_true", default=None,
                   help="sets cfg.s2d_stage2, a TPU layout the port reads and ignores; accepted "
                   "for bench.py's command lines")
    p.add_argument("--no-s2d-stage2", dest="s2d_stage2", action="store_false")
    p.add_argument("--per-channel", dest="per_channel", action="store_true", default=True,
                   help="per-input-channel activation scales folded into the frozen kernels "
                   "(cfg.per_channel_acts, DEFAULT)")
    p.add_argument("--no-per-channel", dest="per_channel", action="store_false")
    p.add_argument("--approx-topk", dest="approx_topk", action="store_true", default=None,
                   help="sets cfg.use_approx_topk, which the port reads as exact top-k; "
                   "accepted for bench.py's command lines")
    p.add_argument("--no-approx-topk", dest="approx_topk", action="store_false")
    p.add_argument("--fused-bottleneck", dest="fused_bottleneck", action="store_true",
                   default=None,
                   help="run int8 identity bottleneck blocks as one kernel each "
                   "(ops/fused_block.py)")
    p.add_argument("--no-fused-bottleneck", dest="fused_bottleneck", action="store_false")
    p.add_argument("--int8-align-inputs", dest="int8_align_inputs", default=None,
                   action="store_true",
                   help="feed ROIAlign the RPN's int8 P-levels (cfg.int8_align_inputs)")
    p.add_argument("--no-int8-align-inputs", dest="int8_align_inputs", action="store_false")
    p.add_argument("--int8-stem", dest="int8_stem", default=None, action="store_true",
                   help="int8 conv1 (cfg.int8_stem)")
    p.add_argument("--no-int8-stem", dest="int8_stem", action="store_false",
                   help="bf16 conv1 with the dequantized int8 kernel")
    p.add_argument("--realistic", action="store_true",
                   help="temper the RPN box-delta kernels (x0.02) so that proposals stay near "
                   "their anchors, as a trained model's do; its own artifact (suffix _rl)")
    p.add_argument("--no-xla-cache", action="store_true",
                   help="accepted for bench.py's command lines; the port has no XLA "
                   "compilation cache to disable")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; raises without a card)")
    return p


def bench_config(args):
    """``COCO_CONFIG`` at the flags' backbone, size and int8 choice, with
    each config flag that was given (``None`` keeps the config's value)."""
    from objectdetection_torch.config import COCO_CONFIG

    s = args.image_size
    cfg = COCO_CONFIG.replace(backbone=args.backbone, image_shape=(s, s, 3), image_max_dim=s,
                              quantized_inference=args.int8)
    overrides = dict(pallas_roi_align=args.pallas_align, s2d_stage2=args.s2d_stage2,
                     use_approx_topk=args.approx_topk, per_channel_acts=args.per_channel,
                     fused_bottleneck=args.fused_bottleneck,
                     int8_align_inputs=args.int8_align_inputs, int8_stem=args.int8_stem)
    return cfg.replace(**{k: v for k, v in overrides.items() if v is not None})


def temper_rpn_deltas(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``--realistic``: every ``rpn_bbox_pred`` kernel × 0.02 (its bias
    kept), so that decoded proposals stay near their anchors."""
    return {k: v * 0.02 if "rpn_bbox_pred" in k.split(".")[:-1] and k.endswith(".weight")
            else v for k, v in params.items()}


def quant_cache_path(args, cfg) -> str:
    """The artifact directory of ``--quant-cache``: 'auto' keys it by
    backbone, size, per-channel scales and ``--realistic``."""
    if args.quant_cache != "auto":
        return args.quant_cache
    pc = "_pc" if cfg.per_channel_acts else ""
    rl = "_rl" if args.realistic else ""
    return os.path.join(ARTIFACTS, f"torch_quant_{args.backbone}_{args.image_size}{pc}{rl}")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _load_artifact(path: str, cfg, dev: torch.device) -> Optional[Dict[str, torch.Tensor]]:
    """The frozen state saved at ``path`` on ``dev``, or None (logged) when
    it cannot be read, does not fit ``cfg``, or lacks the pooled-ROI scales."""
    from objectdetection_torch import checkpoint, detector

    t0 = time.perf_counter()
    try:
        state = {k: v.to(dev) for k, v in checkpoint.load_quantized(path).items()}
        if "pooled_box_scale" not in state:
            raise ValueError("stale artifact: no pooled-ROI scales")
        detector.check_state(state, cfg)
    except (OSError, RuntimeError, ValueError, EOFError, pickle.UnpicklingError) as e:
        log(f"quant cache load failed ({e}); recalibrating")
        return None
    _sync(dev)
    log(f"int8 artifact loaded from {path}: {time.perf_counter() - t0:.1f}s")
    return state


def serving_state(params: Dict[str, torch.Tensor], images: torch.Tensor, cfg, cache: str,
                  dev: torch.device) -> Dict[str, torch.Tensor]:
    """The state ``bench`` serves from the float ``params`` on ``dev``: every
    floating tensor cast to bf16 once; for an int8 ``cfg``, the artifact at
    ``cache`` where one loads, else the cast weights calibrated on ``images``
    (percentile 90 over chunks of ``max(1, len(images) // 16)``) and frozen,
    then saved to ``cache`` unless it is 'off'."""
    from objectdetection_torch import checkpoint, quant

    state = checkpoint.cast_params_for_inference(params)
    if not cfg.quantized_inference:
        return state
    if cache != "off" and os.path.isdir(cache):
        loaded = _load_artifact(cache, cfg, dev)
        if loaded is not None:
            return loaded
    t0 = time.perf_counter()
    state = quant.freeze_weights(quant.calibrate_variables(
        state, images, cfg, batch_size=max(1, images.shape[0] // 16), percentile=90.0,
        device=dev))
    _sync(dev)
    log(f"int8 calibration+freeze: {time.perf_counter() - t0:.1f}s")
    if cache != "off":
        checkpoint.save_quantized(cache, state, cfg)
        log(f"int8 artifact saved to {cache}")
    return state


def _profiled(fn, dev: torch.device, top: int = 5) -> str:
    """Host wall, device busy time (the union of the kernels' intervals) and
    its share, the ``top`` kernels by device time, and the device ms of each
    of the program's spans, of one profiled ``fn()``."""
    from objectdetection_torch import metrics

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    _sync(dev)
    with metrics.collect(dev) as rec, torch.profiler.profile(activities=acts,
                                                             acc_events=True) as prof:
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        wall = (time.perf_counter() - t0) * 1e3
    cuda = torch.autograd.DeviceType.CUDA
    # a span's record_function is mirrored on the device's timeline: not a kernel
    busy = metrics.union_length(
        (e.time_range.start, e.time_range.end) for e in prof.events()
        if e.device_type == cuda and not getattr(e, "is_user_annotation", False)) / 1e3
    if not busy > 0:
        raise RuntimeError("bench: the profiler saw no device time")
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == cuda and not getattr(e, "is_user_annotation", False)),
                     key=lambda e: e.self_device_time_total, reverse=True)
    largest = "; ".join(f"{e.self_device_time_total / 1e3:.1f} ms {e.count}x {e.key[:60]}"
                        for e in kernels[:top])
    spans = ", ".join(f"{s.name} {s.device_ms:.1f}" for s in rec.resolve().spans)
    return (f"wall {wall:.1f} ms, device busy {busy:.1f} ms ({100 * busy / wall:.1f}%), "
            f"{sum(e.count for e in kernels)} kernels; largest: {largest}; "
            f"spans (device ms): {spans}")


def main(argv=None) -> dict:
    """Parse ``argv`` (default ``sys.argv[1:]``), run the benchmark, print
    its JSON line last on stdout and return the line's dict."""
    from objectdetection_torch import detector
    from objectdetection_torch.convert import init_params, resolve_device

    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg = bench_config(args)
    b, s = args.batch, args.image_size
    if dev.type == "cuda":
        from objectdetection_torch.ops import cuda_build
        from objectdetection_torch.probes.common import card

        log(f"device: {torch.cuda.get_device_name(dev)} ({card()})")
        t0 = time.perf_counter()
        built = sorted(cuda_build.build_all())
        log(f"kernel build: {time.perf_counter() - t0:.1f}s ({built or 'cached'})")
    else:
        log(f"device: {dev}")
    params = init_params(cfg, torch.Generator().manual_seed(0), device=dev)
    if args.realistic:
        params = temper_rpn_deltas(params)

    rng = np.random.RandomState(0)
    host = rng.rand(b, s, s, 3).astype(np.float32) * 255.0 - 128.0
    t0 = time.perf_counter()
    images = torch.from_numpy(host).to(dev)
    windows = torch.tensor([[0.0, 0.0, float(s), float(s)]], device=dev).repeat(b, 1)
    _sync(dev)
    log(f"input transfer+sync: {time.perf_counter() - t0:.1f}s")
    del host

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    state = serving_state(params, images, cfg, quant_cache_path(args, cfg) if args.int8
                          else "off", dev)
    del params
    if dev.type == "cuda":
        log(f"peak device memory (set-up and calibration): "
            f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
        torch.cuda.reset_peak_memory_stats(dev)
    infer = detector.make_infer_fn(cfg, with_masks=not args.no_masks, device=dev)

    def run(n: int) -> float:
        # each output folds back into the next input, as bench.py's loop
        imgs, acc = images, torch.zeros((), device=dev)
        with torch.inference_mode():
            for _ in range(n):
                det = infer(state, imgs, windows)
                acc = acc + det.scores.float().sum()
                imgs = imgs + 1e-20 * acc
            return float(acc)  # a synchronisation

    def seconds(n: int) -> float:
        t0 = time.perf_counter()
        run(n)
        return time.perf_counter() - t0

    log(f"first run (lazy init, cuDNN heuristics, exec): {seconds(1):.1f}s")
    for _ in range(args.warmup):
        run(1)
    t_one = seconds(1)
    t_many = seconds(1 + args.iters)
    dt = max(t_many - t_one, 1e-9)
    imgs_per_sec = b * args.iters / dt
    log(f"{args.iters} iters of batch {b}: {dt:.3f}s ({1000 * dt / args.iters:.1f} ms/batch)")
    if dev.type == "cuda":
        log(f"peak device memory (timed runs): "
            f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
        log(f"profiled run(1): {_profiled(lambda: run(1), dev)}")
    line = {
        "metric": METRIC,
        "value": round(imgs_per_sec, 2),
        "unit": "images/sec/chip",
        "vs_baseline": round(imgs_per_sec / BASELINE_IMAGES_PER_SEC, 3),
        "config": ("int8_ptq" if args.int8 else "bf16")
        + ("_pc" if (args.int8 and cfg.per_channel_acts) else "")
        + ("_realistic" if args.realistic else "")
        + f"_b{b}",
    }
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
