#!/usr/bin/env python3
"""Per-stage time of the port's Mask R-CNN serving pipeline at ``bench``'s batch.

    python3 tools/torch_stage_time.py --per-channel            # bench's int8 default
    python3 tools/torch_stage_time.py --no-int8                # bf16
    python3 tools/torch_stage_time.py --fused-bottleneck       # int8-fused (per tensor)

The port of ``benchmarks/pipeline_breakdown.py`` (and of
``benchmarks/stage_bench.py``'s question): it times five cumulative
prefixes of the inference pipeline, extract (backbone + FPN + RPN head),
+proposals, +box_head (7×7 ROIAlign and the box/class head), +detection and
+masks (14×14 ROIAlign and the mask head), and prints one line each: the
prefix's ms a batch and its delta over the prefix before it, in
``pipeline_breakdown.py``'s format (``first call`` in place of its compile
seconds: lazy initialisation and cuDNN's heuristics).

The state is ``bench``'s, built by ``objectdetection_torch/bench.py``'s
own functions: ``COCO_CONFIG`` at the flags' backbone, size and int8
choices (``bench_config``), ``init_params`` seed 0, every floating tensor
cast to bf16, and for int8 calibrated at percentile 90 on the images and
frozen (``serving_state``; no artifact is read or written); images
``RandomState(0).rand(B, S, S, 3) · 255 − 128``, windows the whole canvas.
A prefix runs as ``MaskRCNN.forward`` runs those stages (the int8 P-levels
into ROIAlign where the config feeds them) after ``check_state``, and
returns the sum of its outputs, which folds into the next call's images as
in ``bench``; each prefix is timed by ``bench``'s rule ``(t(1 + iters) −
t(1)) / iters`` after a first and a warm call, with CUDA events on the card
(the host clock on the CPU), and its outputs are freed before the next.
Before timing, the full prefix's detections and masks must equal
``make_infer_fn``'s on the same state and batch.

Flags: ``pipeline_breakdown.py``'s under their names and defaults
(``--per-channel`` is off there, so ``bench``'s int8 default is
``--per-channel``), plus ``--fused-bottleneck`` and ``--device`` (default
``cuda``; without a card the tool raises unless given ``--device cpu``).
The card's name and power limit, calibration and peak memory go to stderr.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

NAMES = ("extract", "+proposals", "+box_head", "+detection", "+masks")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--batch", type=int, default=96)
    p.add_argument("--iters", type=int, default=6)
    p.add_argument("--image-size", type=int, default=1024)
    p.add_argument("--backbone", default="resnet101")
    p.add_argument("--no-int8", dest="int8", action="store_false", default=True)
    p.add_argument("--per-channel", action="store_true",
                   help="per-input-channel activation scales (bench's default recipe)")
    p.add_argument("--fused-bottleneck", action="store_true",
                   help="int8 identity bottleneck blocks as one kernel each")
    p.add_argument("--stages", default="",
                   help="comma list of prefixes to time, 0 (extract) to 4 (+masks); default all")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; raises without a card)")
    return p


def bench_args(args):
    """``bench``'s parsed flags for the same recipe."""
    from objectdetection_torch import bench

    argv = ["--batch", str(args.batch), "--image-size", str(args.image_size), "--backbone",
            args.backbone, "--per-channel" if args.per_channel else "--no-per-channel",
            "--quant-cache", "off"]
    if not args.int8:
        argv.append("--no-int8")
    if args.fused_bottleneck:
        argv.append("--fused-bottleneck")
    return bench.build_parser().parse_args(argv)


def prefix(model, images, windows, depth: int):
    """The pipeline's stages up to ``depth`` (0-4) as ``MaskRCNN.forward``
    runs them; returns the stage outputs to consume."""
    import torch

    from objectdetection_torch.anchors import config_anchors
    from objectdetection_torch.geometry import norm_boxes
    from objectdetection_torch.layers.detection import detection_layer
    from objectdetection_torch.layers.proposals import proposal_layer

    cfg = model.config
    if cfg.quantized_inference and cfg.quantize_rpn and cfg.int8_align_inputs:
        feats, _, probs, deltas, qfeats = model.extract(images, True)
    else:
        (feats, _, probs, deltas), qfeats = model.extract(images), None
    if depth == 0:
        return [*feats, probs, deltas]
    anchors = torch.from_numpy(config_anchors(cfg)).to(images.device)
    proposals = proposal_layer(probs, deltas, anchors, cfg)
    if depth == 1:
        return [*feats, proposals]
    _, (_, cls_probs, bbox) = model._classify(feats, proposals, qfeats)
    if depth == 2:
        return [*feats, cls_probs, bbox]
    det = detection_layer(proposals, cls_probs, bbox, norm_boxes(windows, cfg.image_shape[:2]),
                          cfg)
    if depth == 3:
        return [*feats, det]
    _, masks = model._masks(feats, det[..., :4], det[..., 4].to(torch.int64), qfeats)
    return [det, masks]


def run_prefix(state, cfg, images, windows, depth: int):
    """One call of the prefix on ``state``, as ``forward_inference`` binds
    it (``check_state``, then ``functional_call``)."""
    from torch.func import functional_call

    from objectdetection_torch import detector

    detector.check_state(state, cfg)
    return functional_call(detector._bound_model(cfg), state,
                           (prefix, images, windows, depth), strict=True)


def check_full_prefix(state, cfg, images, windows, dev) -> None:
    """The full prefix's detections and masks against ``make_infer_fn``'s on
    the same state and batch: equal, or raise."""
    import torch

    from objectdetection_torch import detector

    with torch.inference_mode():
        det, masks = run_prefix(state, cfg, images, windows, 4)
        want = detector.make_infer_fn(cfg, with_masks=True, device=dev)(state, images, windows)
    for name, got, ref in (("boxes", det[..., :4], want.boxes),
                           ("class ids", det[..., 4].to(torch.int32), want.class_ids),
                           ("scores", det[..., 5], want.scores), ("masks", masks, want.masks)):
        if not torch.equal(got, ref):
            raise RuntimeError(f"stage time: the full prefix's {name} differ from make_infer_fn's")
    log(f"full prefix == make_infer_fn: {int(want.valid.sum())} detections of "
        f"{want.valid.numel()} rows, masks {tuple(want.masks.shape)}")


def timer(dev):
    """``seconds(fn)``: the time ``fn()`` takes, by CUDA events on the card
    (``fn`` ends in a synchronisation either way)."""
    import torch

    if dev.type != "cuda":
        def seconds(fn):
            t0 = time.perf_counter()
            fn()
            return time.perf_counter() - t0
        return seconds

    def seconds(fn):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    return seconds


def main(argv=None) -> dict:
    """Parse ``argv`` (default ``sys.argv[1:]``), check and time the
    prefixes, print a line each; returns {"stages": [{name, cum_ms,
    delta_ms, first_s}, ...], "config": the recipe's name}."""
    import numpy as np
    import torch

    from objectdetection_torch import bench
    from objectdetection_torch.convert import init_params, resolve_device

    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    bargs = bench_args(args)
    cfg = bench.bench_config(bargs)
    b, s = args.batch, args.image_size
    recipe = ("bf16" if not args.int8 else "int8_fused" if cfg.fused_bottleneck else
              "int8_pc" if cfg.per_channel_acts else "int8") + f"_b{b}"
    if dev.type == "cuda":
        from objectdetection_torch.ops import cuda_build
        from objectdetection_torch.probes.common import card

        log(f"device: {torch.cuda.get_device_name(dev)} ({card()}); recipe {recipe}")
        cuda_build.build_all()
    params = init_params(cfg, torch.Generator().manual_seed(0), device=dev)
    images = torch.from_numpy(np.random.RandomState(0).rand(b, s, s, 3).astype(np.float32)
                              * 255.0 - 128.0).to(dev)
    windows = torch.tensor([[0.0, 0.0, float(s), float(s)]], device=dev).repeat(b, 1)
    state = bench.serving_state(params, images, cfg, "off", dev)
    del params
    check_full_prefix(state, cfg, images, windows, dev)

    seconds = timer(dev)
    wanted = [int(x) for x in args.stages.split(",")] if args.stages else range(len(NAMES))
    stages, prev = [], 0.0
    for depth in wanted:
        def run(n: int, depth=depth) -> float:
            # each call's outputs fold back into the next call's images
            imgs, acc = images, torch.zeros((), device=dev)
            with torch.inference_mode():
                for _ in range(n):
                    outs = run_prefix(state, cfg, imgs, windows, depth)
                    acc = acc + sum(o.float().sum() for o in outs)
                    del outs
                    imgs = imgs + 1e-20 * acc
                return float(acc)  # a synchronisation

        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        first = seconds(lambda: run(1))
        run(1)
        t_one = seconds(lambda: run(1))
        t_many = seconds(lambda: run(1 + args.iters))
        ms = 1000.0 * max(t_many - t_one, 0.0) / args.iters
        print(f"{NAMES[depth]:12s} cum {ms:8.2f} ms/batch  delta {ms - prev:8.2f} ms  "
              f"(first call {first:.1f}s)", flush=True)
        if dev.type == "cuda":
            log(f"{NAMES[depth]}: peak device memory "
                f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
        stages.append({"name": NAMES[depth], "cum_ms": ms, "delta_ms": ms - prev,
                       "first_s": first})
        prev = ms
    return {"stages": stages, "config": recipe}


if __name__ == "__main__":
    main()
