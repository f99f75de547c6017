#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout (``--parallel-rank`` is phase 12's own
call of its two ranks). Phases, in order; any failure exits non-zero
and prints no result:

1. card and build: the card's name and power limit, build of every kernel
   under objectdetection_torch/csrc/ (one nvcc per source, in parallel);
   TF32 is turned off for the comparisons;
2. NMS kernels against their plain version, survivor tables identical, at
   the two serving shapes (6000 -> 1000 proposals, 1000 -> 100 detections,
   summed in the kernel line), the training shape (6000 -> 2000) and a
   sparse 6000 -> 1000 whose budget stops the sweep after a few tiles;
3. ROIAlign kernel against its plain version at the COCO pyramid shapes, f32
   (bit-equal) and bf16 (stated tolerance), box stage and mask stage; then
   on boxes outside the map (a NaN box, a box left of and above image 0's P2
   whose table index wraps to the end of the table, a box above image 1's
   P4 that reads image 0's rows): the f32 kernel bit-equal, bf16 within its
   tolerance, the int8 epilogue bit-equal and the gradient within
   ``backward_tolerance``, each with NaNs in the plain version's places;
4. end to end: COCO_CONFIG (ResNet-101 + FPN, 1024², bf16) with seeded random
   weights answers 3 requests of batch 2 through ``make_infer_fn``; the kernel
   launch counters are read around that run; then where a batch's time goes
   (CUDA-event spans per stage, the entry points, one profiled batch); then
   runs at ``detection_min_threshold=0.0``, bf16 and f32, are held stage by
   stage against the plain path on the card;
5. the training kernels against their plain versions at the main path's
   shapes: anchor matching (COCO anchors × 100 GT, B=2, exact; its bound
   counts the overlapping pairs, the dense count is logged) and the
   ROIAlign gradient (7×7 and 14×14, R=200 per image, f32 and bf16, within
   the stated bound of ``roi_align.backward_tolerance``);
6. training at full width: COCO_CONFIG, batch 2, masks on (56×56
   mini-masks), the same seeded weights. (a) One f32 step through the
   kernels and through the plain path on the same batch and noise: targets
   identical, losses equal, every gradient leaf within the stated bound.
   (b) Five bf16 steps through ``make_train_step``, the launch counters read
   around them: losses finite, a nonzero FPN gradient from the second-stage
   losses alone, ms per step, device busy share, peak memory;
7. int8 serving (``quantized_inference``): (a) the fused int8 bottleneck
   kernel at the four ResNet stage shapes of a 1024² batch of 2, bit-equal
   to its plain version, with each stage's tile, blocks, conv 2a halo
   factor and device time split into the block kernel and its preparation
   kernel; (a') the fused int8 conv kernel on every conv shape and epilogue
   of the int8 call (``int8_conv.mask_rcnn_convs``) at batch 2, per channel
   and per tensor, and on a stage-2 identity block at batch 96, bit-equal to
   its plain version, each conv's ms beside the plain path's and
   ``torch._int_mm`` alone; (b) ROIAlign's int8 epilogues at the box and mask
   stages (bf16 in → int8 out, int8 in per channel and per tensor → int8
   out, int8 in → bf16 out), bit-equal; (c) two configurations, int8-default
   (``bench.py``'s recipe: per-channel act scales, percentile-90
   calibration, frozen weights) and int8-fused (per-tensor scales,
   ``fused_bottleneck``), each calibrated on the card from the seeded weights
   with every BatchNorm drawn from a seed, frozen, and answering 3 requests
   through ``make_infer_fn`` (125 int8 convs a request, 38 beside the fused
   blocks); (d) each against the plain path on the same
   frozen weights and batch: identical detections and masks; (e) int8-fused
   against the same scales unfused, in f32 compute, block by block (each of
   the 29 identity blocks fused on the unfused stream's own input): within 2
   steps, under 1e-3 of the codes more than 1 (the chained C2–C5 drift, in
   f32 and bf16, printed); (f) int8 against the bf16 float path on the same
   weights, printed, not gated;
8. the ROIAlign design probes of the TPU round (``objectdetection_torch/
   probes/``) at the TPU scripts' own sizes: P1 ``patch_dma`` (three
   (ROIs, patch) cases, within n·2^-24·Σ|x| of its plain version; the
   library yardstick is one advanced-index gather of every patch), P2
   ``roi_inner`` (all six variants) and P3 ``roi_dispatch`` (three
   variants, and 9600 ROIs over the top class and every (level, class)
   pair), bit-equal, with the P3 probe's own attribution in µs a ROI (bare
   against P2's wide2c, dispatch − bare, dispatch_small − dispatch); then
   each probe's entry point (``main``) runs every case and variant with the
   launch counters read around it;
9. the serving entry points at COCO_CONFIG R101 1024² bf16: (a) three
   seeded images (480×640, 1200×900, 333×500) written as PNG (rows
   filtered as libpng filters them) and PPM by the port's encoders and
   decoded back bit-exact, the PNG through the numpy and the C row
   unfilter (``csrc/png_unfilter.cu``, the server's on the card); molded by
   ``mold_batch_device`` on the card and on the CPU (within 1e-3), and host
   against device mold on smooth images (scale within 1e-5, window within
   1 px, mean interior gap under 6); (b) ``serve`` on 127.0.0.1 with the
   seeded init weights cast to bf16 once and warmed up: ``/healthz``, the
   three PNGs in turn and two at once from two threads, each answer equal
   to ``infer_fn`` + ``unmold_detections`` called directly on the same
   state dict (integer boxes and class ids identical, scores to 4
   decimals), then one image as a PNG tagged with EXIF orientation 6 and,
   turned upright, untagged: both unmolded at the upright shape and
   answered as the direct call on the upright image; (c) ``cli quantize
   --config coco --calib-images 2 --batch-size 1 --percentile 90`` writes an artifact, ``serve(quantized=)``
   answers the three PNGs identically to the frozen state dict still in
   memory; (d) ``cli infer`` with masks on one PNG: the ``*_det.png`` it
   writes decodes at the input's shape, ``paste_detection_masks`` gives
   [N, H, W] masks; (e) the launch counters around (b)-(d): NMS twice a
   request, the box-stage ROIAlign once, the mask stage in (d) only. Server
   latency, client wall, warm-up and peak memory are printed with the
   card's name and power limit;
10. the training and evaluation entry points: (a) ``cli train --steps 20
   --batch 8 --masks --eval-every 10 --eval-images 16 --eval-masks --ckpt D``
   at SHAPES_CONFIG (R50 128², bf16): losses finite, the launch counters
   read around it (NMS and anchor matching once a step, ROIAlign and its
   gradient twice, plus NMS and ROIAlign twice an evaluation batch), ms a
   step, the loader's ms a batch on the prefetch thread and the loop's wait
   for it, peak memory; then ``--resume D --steps 25`` starts at step 20,
   profiled for the device's busy share; (b) ``cli demo`` writes PNGs that
   decode at 128×128, and ``cli quantize --config shapes --ckpt D
   --calib-images 16`` writes an artifact that a server answers on two
   shapes PNGs identically to the frozen state dict; (c) ``cli train-coco
   --steps 3 --batch 8`` at COCO_CONFIG (R101 1024², bf16) on a seeded mini
   COCO of six PNG photos (480×640 to 1200×900, 2-5 boxes each, a crowd
   region): losses finite, each training kernel once a step (boxes only);
   (d) ``cli eval-coco`` on it: what it hands the evaluator equals
   ``make_infer_fn`` + ``unmold_detections_np`` on the same padded batch,
   NMS twice a batch and ROIAlign once, img/s; (e) int8 bias correction at
   SHAPES_CONFIG (f32) on 8 images, card against CPU within 1e-4;
11. the two other detector families, seeded weights, batch 2, each path
   driven with the launch counters set to 0 just before it and read just
   after: (a) Faster R-CNN (VGG16, ZF anchors, f32) at its config's defaults
   (224², 4 classes) through ``make_infer_fn`` with
   ``faster_rcnn_detections(score_threshold=0.0)``: NMS twice a batch; (b)
   the same at the paper's VOC test scale (600×1000, 21 classes): the
   forward and detections, then one f32 forward and one step's targets and
   losses held against the plain path (identical, losses within 1e-6), the
   class-aware NMS on full rows (the forward's proposals with seeded class
   probabilities) against the plain path, then
   3 steps of ``make_train_step`` on 2-5 GT boxes an image (NMS 12000 ->
   2000 at IoU 0.2 and anchor matching over 21,546 ZF anchors once a step);
   (c) RetinaNet at COCO_CONFIG (R101-FPN, 81 classes, 1024², bf16):
   ``make_infer_fn`` (NMS once a batch, class-aware, sorted, 1000 -> 100),
   in f32 the detections of the kernel and the plain NMS on the same logits
   identical, and 3 steps of ``make_retinanet_train_step`` (anchor matching
   over 261,888 anchors × 100 GT once a step). Every NMS and anchor-match
   call of the phase is recorded and held against its plain version on its
   own inputs (survivor tables identical, matches exact); NMS at 12000 ->
   2000 and each anchor-match shape are timed beside their bounds. ms a
   batch and a step, the device busy share of one profiled batch and step,
   and peak memory are printed with the card's name and power limit;
12. data and tensor parallelism (``parallel.py``) at COCO_CONFIG with phase
   4's weights and batch and phase 6's training batch, each path driven
   with the launch counters set to 0 just before it and read just after
   (NMS and ROIAlign twice a batch; NMS and anchor matching once a step,
   ROIAlign and its gradient twice): (a) NCCL at world 1 in this process:
   ``make_parallel_infer_fn`` equal to ``make_infer_fn``, and two bf16
   ``make_parallel_train_step`` steps (noise drawn from a generator for the
   whole batch) against ``make_train_step`` within the bound of 6(a); (b)
   two ranks on the one card over gloo, subprocesses of this script
   (``--parallel-rank``): inference one image a rank, each rank's rows equal
   to ``make_infer_fn`` on them alone and the gathered detections the ranks'
   rows in rank order; two f32 steps, 1 + 1 images, each from the state
   before it: targets equal to the single process's rows (ROIs within
   1e-6), and losses, gradient norms and each head's parameters (relative
   to its move) within the bound of 6(a) of the single process's step taken
   one image at a time (a rank's arithmetic) and of its step on the whole
   batch, the parameters there unless the one-image step itself lies
   beyond the bound (logged), equal on both ranks; (c) dp × tp = 1 × 2 on
   the same ranks:
   ``shard_state_tp(min_dim=512)`` holds ``mrcnn_class_conv1`` as [512,
   12544] a rank, and two steps' ``total_loss`` equal the replicated step's
   within rtol 1e-4. ms a batch and a step, the gradient all-reduce and
   peak memory per rank are printed with the card's name and power limit;
13. the ``bench`` entry point (``objectdetection_torch/bench.py``) and
   ``remat_backbone``, each path driven with the launch counters set to 0
   just before it and read just after (per batch: NMS twice, ROIAlign
   twice with masks or once without, in the int8 epilogues on the int8
   path, 29 fused blocks on the fused path, 125 int8 convs on the int8 path
   and 38 on the fused one; per calibration chunk NMS and
   the float ROIAlign at both stages once): (a) ``bench.main`` at its
   defaults (int8 per-channel, batch 96, R101 1024², masks) with ``--iters
   2 --warmup 1`` and an artifact directory: its one stdout line is the
   JSON it returns, with ``bench.py``'s keys and ``config``
   ``int8_ptq_pc_b96``; a second call on that directory loads the artifact,
   calibrates nothing, and the state it loads equals the state the first
   served, leaf for leaf; (b) ``--no-int8``, (c) ``--fused-bottleneck
   --no-per-channel`` and (d) ``--no-masks --no-int8`` (through
   ``cli.main(["bench", ...])``), each at batch 8; in (a)-(d) every NMS,
   ROIAlign, fused-block and int8 conv call of the last (profiled) batch
   and of the first calibration chunk is held against its plain version on
   its own inputs, the convs as they are called (bit-equal; bf16 ROIAlign
   within ``bf16_tolerance``), and the largest gap goes into the kernel
   line's ``max_abs_err``;
   (e) ``python -m objectdetection_torch.bench --batch 2`` as a
   subprocess, its last stdout line JSON; (f) ``cli train-coco --steps 3
   --batch 8`` on 10(c)'s mini COCO without and with ``--remat`` (the peak
   with remat lower; ms a step, the loop's waits for its loader), one f32
   step at COCO_CONFIG on phase 6's batch and noise (TF32 off, cuDNN
   deterministic) with and without ``remat_backbone`` (targets and losses
   identical, every gradient leaf and the updated parameters within the
   bound of 6(a)), then that step's losses and gradients timed warm twice
   a side, alternating (the peak with remat lower), and one profiled bf16
   step each (wall, device busy, kernels). images/s, calibration seconds,
   peak memory and busy share are printed with the card's name and power
   limit;
14. the last slice, each path driven with the launch counters set to 0
   just before it and read just after: (a) a seeded 333×500 PNG with an
   ``eXIf`` chunk for each EXIF orientation 1-8, decoded with the C row
   unfilter: each equal, bit for bit and in shape, to the untagged decode
   turned by the tag's numpy flip or transpose (the server's part is in
   9(b)); (b) ``cli train --steps 20 --batch 8 --masks --ckpt D``, then
   ``tools/torch_int8_accuracy.py --ckpt D --images 16 --calib-images 8``
   at its defaults (per tensor) and with ``--per-channel --percentile
   90``: ``benchmarks/int8_accuracy.py``'s JSON keys, the float mAP@0.5
   equal to ``cli.evaluate_on_shapes`` called directly, the deltas printed;
   (c) ``tools/torch_stage_time.py --batch 8 --iters 2`` for bf16,
   int8-default (``--per-channel``) and int8-fused (``--fused-bottleneck``):
   five lines each after its full prefix equals ``make_infer_fn``; in (b)
   every NMS and ROIAlign call, in (c) those of the full-prefix check and
   of the first calibration chunk (a recorded fused-block call keeps its
   input, ~134 MB at batch 8), held against the plain versions; (d)
   ``examples/torch_quickstart.py --device cuda`` prints 5 finite losses,
   and ``examples/torch_visualize_rpn_targets.py --device cuda`` writes a
   PNG that decodes at 128×128 with the counts of the same script on the
   CPU (both subprocesses).

The line before the last is the kernel table as JSON (launches counted on
the path that runs each kernel: the training paths of phases 6 and 12 and
phase 12's inference paths for the four of phases 2–6, the int8 serving paths for the fused block and the
int8 ROIAlign, the probes' entry points for the three probe kernels, and
phases 13 and 14's paths for the kernels they run; phase 11's launches are
checked and logged, not tabled); the last line is ``{"ok": true, "device":
{...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s, f32 and bf16 FLOP/s
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
PEAK_BF16 = 989e12
PEAK_INT8 = 1979e12  # int8 tensor-core operations/s
# f32 operations of one IoU test: 2 min, 2 max, 6 sub, 3 mul, 1 add, 1 div,
# 2 compares
IOU_OPS = 17
# f32 operations of one anchor-GT test: the IoU with the GT's area from
# shared memory (4 min/max, 2 sub, 2 clamps, 1 mul, 1 add, 1 sub, 1 compare,
# 1 div), the running per-anchor max (1 compare, 1 select) and the per-GT
# candidate key (1 compare, 1 pack, 2 for the warp vote and select)
MATCH_OPS = 19
BATCH = 2
REPS = 10  # batches per stage and entry-point timing
TRAIN_STEPS = 5  # bf16 training steps of phase 6
# stated bound of phase 6(a): every gradient leaf of the kernel path within
# this share of its L2 norm of the plain path's. The forward is bit-equal (the
# kernels equal their plain versions); only the f32 atomics of the ROIAlign
# gradient reorder sums, by at most 2·γ(n+4, 2^-24) of the absolute sum of
# each pyramid-gradient element, which the linear backward carries into the
# leaves at the same order (measured worst: 1.35e-5 on an H100).
GRAD_REL = 2e-4
TOP = 12  # largest device kernels listed from the profiled batch
# phase 2's NMS cases: (name, N, classes, class -1 padded rows, clusters, IoU
# threshold, budget, on the serving path). The serving path's two make the
# kernel line's record; the training shape (proposal_layer(training=True))
# and a sparse one, whose budget stops the sweep after a few tiles, are logged.
NMS_CASES = (
    ("proposals", 6000, 1, 0, 12, 0.7, 1000, True),
    ("detections", 1000, 81, 24, 12, 0.3, 100, True),
    ("training", 6000, 1, 0, 12, 0.7, 2000, False),
    ("proposals-sparse", 6000, 1, 0, 600, 0.7, 1000, False),
)
TRAIN_KERNELS = ("nms", "roi_align", "roi_align_backward", "anchor_match")
# the ResNet stages at 1024² (H, W, C3, C1) and their identity blocks in R101
STAGES = ((256, 256, 256, 64), (128, 128, 512, 128), (64, 64, 1024, 256), (32, 32, 2048, 512))
STAGE_BLOCKS = (2, 3, 22, 2)
# the stated bound of phase 7(e), in f32 compute: fused and unfused blocks fold
# the same f32 scales in other orders (tests/test_fused_block.py:178-180)
FUSED_STEPS, FUSED_SHARE = 2, 1e-3


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int = 20) -> float:
    """Device time per call of everything ``fn`` launches, from
    torch.profiler (``probes.common.device_ms``). CUDA events around
    back-to-back calls measure the host instead where a call's enqueue
    outlasts its kernels (anchor matching: ~0.13 ms of Python and ctypes per
    call around ~0.09 ms of kernels)."""
    from objectdetection_torch.probes import common

    try:
        return common.device_ms(fn, reps)
    except RuntimeError as e:
        fail(str(e))


def device_split(fn, reps: int = 20) -> dict:
    """Device ms per call of each kernel ``fn`` launches, by the profiler's
    kernel name (torch.profiler, ``probes.common.per_call_ms``)."""
    import torch

    from objectdetection_torch.probes import common

    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, acc_events=True) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    split = common.per_call_ms(prof, reps)
    if not split:
        fail("device_split: the profiler saw no device time")
    return split


def same(a, b) -> bool:
    """Bit-equal values with NaNs in the same places."""
    import torch

    nan_a, nan_b = torch.isnan(a), torch.isnan(b)
    return torch.equal(nan_a, nan_b) and torch.equal(a[~nan_a], b[~nan_b])


# ---------------------------------------------------------------- phase 1


def card_and_build():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    from objectdetection_torch.ops import cuda_build

    t0 = time.perf_counter()
    reports = cuda_build.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s for {sorted(reports) or 'nothing (cached)'}")
    for name, report in sorted(reports.items()):
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log("tf32 off for the comparisons: cudnn.allow_tf32=False, cuda.matmul.allow_tf32=False")
    return card


# ---------------------------------------------------------------- phase 2


def nms_inputs(gen, n: int, num_classes: int, pads: int, device, clusters: int = 12):
    """Score-sorted canonical boxes around ``clusters`` centres, with
    duplicates, zero-area and all-zero rows; class ids in [0, num_classes)
    and -1 on the padded tail."""
    import torch

    b = BATCH
    centers = torch.rand(b, clusters, 2, generator=gen)
    pick = torch.randint(0, clusters, (b, n), generator=gen)
    ctr = torch.gather(centers, 1, pick[..., None].expand(b, n, 2))
    ctr = ctr + 0.03 * torch.randn(b, n, 2, generator=gen)
    size = 0.02 + 0.25 * torch.rand(b, n, 2, generator=gen)
    boxes = torch.cat([ctr - size / 2, ctr + size / 2], -1).clamp(0, 1)
    dup = torch.rand(b, n, generator=gen) < 0.05  # exact duplicates of a neighbour
    boxes[:, 1:][dup[:, 1:]] = boxes[:, :-1][dup[:, 1:]]
    flat = torch.rand(b, n, generator=gen) < 0.03  # zero-area rows
    boxes[..., 2][flat] = boxes[..., 0][flat]
    zero = torch.rand(b, n, generator=gen) < 0.03  # invalid (zeroed) rows
    boxes[zero] = 0.0
    cls = torch.randint(0, num_classes, (b, n), generator=gen, dtype=torch.int32)
    if pads:
        boxes[:, n - pads:] = 0.0
        cls[:, n - pads:] = -1
    return boxes.to(device).contiguous(), cls.to(device).contiguous()


def nms_case_inputs(device):
    """The inputs of NMS_CASES, drawn in order from one seeded generator."""
    import torch

    gen = torch.Generator().manual_seed(1)
    return [nms_inputs(gen, n, k, pads, device, clusters)
            for _, n, k, pads, clusters, *_ in NMS_CASES]


def nms_ops(table: "torch.Tensor", cls: "torch.Tensor", budget_rows: int) -> float:
    """IoU tests greedy NMS needs on this data: each row up to the stop is
    tested against the same-class survivors before it."""
    import torch

    total = 0
    for b in range(table.shape[0]):
        alive = (table[b, :budget_rows] != 0).any(-1)
        c = cls[b, :budget_rows].long()
        for k in torch.unique(c).tolist():
            m = c == k
            before = torch.cumsum(alive[m].long(), 0) - alive[m].long()
            total += int(before.sum())
    return total * IOU_OPS


def stop_row(table, tile: int, budget: int) -> int:
    """Rows the kernel resolves: up to the end of the tile where the survivor
    count reaches the budget."""
    import torch

    rows = 0
    for b in range(table.shape[0]):
        live = torch.cumsum((table[b] != 0).any(-1).long(), 0)
        hit = torch.nonzero(live >= budget)
        end = table.shape[1] if hit.numel() == 0 else int(hit[0]) // tile * tile + tile
        rows = max(rows, min(end, table.shape[1]))
    return rows


def nms_phase(device):
    import torch

    from objectdetection_torch.ops import nms

    rec = {"ms": 0.0, "kernel_ms": 0.0, "plain_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0,
           "max_abs_err": 0.0, "library_ms": None}
    for (name, n, _, _, clusters, thr, budget, serving), (boxes, cls) in zip(
            NMS_CASES, nms_case_inputs(device)):
        out_k = nms.suppress(boxes, cls, thr, budget)
        out_p = nms.suppress_plain(boxes, cls, thr, budget)
        torch.cuda.synchronize()
        if not torch.equal(out_k, out_p):
            bad = int(((out_k != 0).any(-1) != (out_p != 0).any(-1)).sum())
            fail(f"nms {name}: kernel survivor table differs from plain ({bad} rows)")
        survivors = int((out_k != 0).any(-1).sum())
        rows = stop_row(out_p, nms.TILE, budget)
        ms = device_ms(lambda: nms.suppress(boxes, cls, thr, budget))
        if not serving:
            log(f"nms {name}: B={BATCH} N={n} {clusters} clusters thr={thr} budget={budget}: "
                f"kernel == plain ({survivors} survivors, {rows} rows resolved); kernel "
                f"{ms:.4f} ms device")
            continue
        rec["max_abs_err"] = max(rec["max_abs_err"], float((out_k - out_p).abs().max()))
        ev_ms = time_ms(lambda: nms.suppress(boxes, cls, thr, budget), 50)
        plain_ms = time_ms(lambda: nms.suppress_plain(boxes, cls, thr, budget), 3, warmup=1)
        bytes_ = BATCH * n * (16 + 4 + 16)
        ops = nms_ops(out_p, cls, rows)
        rec["ms"] += ms
        rec["plain_ms"] += plain_ms
        rec["bytes_ms"] += bytes_ / PEAK_BYTES * 1e3
        rec["ops_ms"] += ops / PEAK_F32 * 1e3
        log(f"nms {name}: B={BATCH} N={n} thr={thr} budget={budget}: kernel == plain "
            f"({survivors} survivors, {rows} rows resolved); kernel {ms:.4f} ms device "
            f"({ev_ms:.4f} ms between events), plain {plain_ms:.3f} ms")
    return rec


# ---------------------------------------------------------------- phase 3


def roi_boxes(gen, r: int, device):
    """Random boxes plus zero, flat (clipped), full-image and tiny boxes."""
    import torch

    y1x1 = torch.rand(BATCH, r, 2, generator=gen) * 0.8
    hw = torch.rand(BATCH, r, 2, generator=gen) ** 2 * 0.6
    boxes = torch.cat([y1x1, (y1x1 + hw).clamp(max=1.0)], -1)
    q = r // 10
    boxes[:, :q] = 0.0  # zero boxes (padding rows)
    boxes[:, q:2 * q, 2] = boxes[:, q:2 * q, 0]  # flat boxes
    boxes[:, 2 * q:2 * q + 5] = torch.tensor([0.0, 0.0, 1.0, 1.0])  # full image
    tiny = boxes[:, 3 * q:4 * q]
    tiny[..., 2:] = tiny[..., :2] + 1e-3
    return boxes.to(device).contiguous()


def roi_phase(device):
    import torch

    from objectdetection_torch.config import COCO_CONFIG
    from objectdetection_torch.ops import roi_align

    cfg = COCO_CONFIG
    gen = torch.Generator().manual_seed(2)
    image = tuple(cfg.image_shape[:2])
    c = cfg.fpn_channels
    shapes = cfg.feature_shapes()[:4]
    feats32 = [torch.randn(BATCH, h, w, c, generator=gen).to(device) for h, w in shapes]
    feats16 = [f.to(torch.bfloat16) for f in feats32]
    stages = [("box", 1000, cfg.pool_shape), ("mask", 100, cfg.mask_pool_shape)]
    rec = {"ms": 0.0, "kernel_ms": 0.0, "plain_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0,
           "max_abs_err": 0.0, "library_ms": None}
    for name, r, crop in stages:
        boxes = roi_boxes(gen, r, device)
        k32 = roi_align.batched_multilevel_roi_align(feats32, boxes, image, crop)
        p32 = roi_align.batched_multilevel_roi_align_plain(feats32, boxes, image, crop)
        torch.cuda.synchronize()
        if not torch.equal(k32, p32):
            fail(f"roi_align {name} f32: kernel not bit-equal to plain "
                 f"(max |diff| {float((k32 - p32).abs().max())})")
        k16 = roi_align.batched_multilevel_roi_align(feats16, boxes, image, crop)
        p16 = roi_align.batched_multilevel_roi_align_plain(feats16, boxes, image, crop)
        err = float((k16.float() - p16.float()).abs().max())
        tol = roi_align.bf16_tolerance(feats16)
        if not err <= tol:
            fail(f"roi_align {name} bf16: max |kernel - plain| {err} > {tol}")
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        ev_ms = time_ms(
            lambda: roi_align.batched_multilevel_roi_align(feats16, boxes, image, crop), 50)
        ms = device_ms(lambda: roi_align.batched_multilevel_roi_align(feats16, boxes, image, crop))
        plain_ms = time_ms(
            lambda: roi_align.batched_multilevel_roi_align_plain(feats16, boxes, image, crop), 5)
        ms32 = time_ms(lambda: roi_align.batched_multilevel_roi_align(feats32, boxes, image, crop), 50)
        rows = roi_align.touched_rows(feats16, boxes, image, crop)
        outs = BATCH * r * crop[0] * crop[1] * c
        bytes_ = rows * c * 2 + boxes.numel() * 4 + outs * 2
        ops = outs * 7  # 4 products + 3 sums per output
        rec["ms"] += ms
        rec["plain_ms"] += plain_ms
        rec["bytes_ms"] += bytes_ / PEAK_BYTES * 1e3
        rec["ops_ms"] += ops / PEAK_BF16 * 1e3
        log(f"roi_align {name}: B={BATCH} R={r} {crop[0]}x{crop[1]} C={c}: f32 bit-equal; "
            f"bf16 max |diff| {err:.3g} <= tol {tol:.3g}; kernel bf16 {ms:.4f} ms device "
            f"({ev_ms:.4f} ms between events; f32 {ms32:.4f}), plain bf16 {plain_ms:.3f} ms; "
            f"bound {bytes_ / PEAK_BYTES * 1e3:.4f} ms ({bytes_ / 1e6:.1f} MB)")
    out_of_map(feats32, feats16, image, cfg, device)
    return rec


def out_of_map(feats32, feats16, image, cfg, device):
    """The three ROIAlign kernels on boxes outside the map, which read what
    JAX's gather reads (a wrapped table index, NaN where it reads NaN), held
    against their plain versions."""
    import torch

    from objectdetection_torch.ops import roi_align

    nan = float("nan")
    boxes = torch.tensor([
        [[nan, nan, nan, nan], [-0.05, -0.05, 0.02, 0.02]],  # NaN; P2, wraps to the end
        [[-0.3, 0.2, -0.1, 0.4], [0.2, 0.3, 0.6, 0.7]],  # above image 1's P4; inside
    ], device=device)
    levels = roi_align.roi_levels(boxes, image[0] * image[1]).tolist()
    rows = roi_align._corners([f.shape[1:3] for f in feats32], boxes, image, cfg.pool_shape)
    table = sum(f.shape[0] * f.shape[1] * f.shape[2] for f in feats32)
    r01 = torch.stack([r for r, _ in rows]).reshape(4, 2, 2, -1)[:, 0, 1]
    if not (levels[0][1] == 2 and bool((r01 >= table - BATCH * 32 * 32).any())):
        fail(f"roi_align out of map: the wrap case does not wrap (levels {levels})")
    grad_shapes = [tuple(f.shape) for f in feats32]
    gen = torch.Generator().manual_seed(12)
    c = feats32[0].shape[-1]
    for name, crop in (("box", cfg.pool_shape), ("mask", cfg.mask_pool_shape)):
        k32 = roi_align.batched_multilevel_roi_align(feats32, boxes, image, crop)
        p32 = roi_align.batched_multilevel_roi_align_plain(feats32, boxes, image, crop)
        torch.cuda.synchronize()
        if not (same(k32, p32) and bool(torch.isnan(p32[0, 0]).all())
                and bool(torch.isfinite(p32[:, 1:]).all() and torch.isfinite(p32[1]).all())):
            fail(f"roi_align out of map {name} f32: kernel not bit-equal to plain")
        k16 = roi_align.batched_multilevel_roi_align(feats16, boxes, image, crop)
        p16 = roi_align.batched_multilevel_roi_align_plain(feats16, boxes, image, crop)
        fin = ~torch.isnan(p16)
        err16 = float((k16[fin].float() - p16[fin].float()).abs().max())
        if not (torch.equal(torch.isnan(k16), ~fin) and err16 <= roi_align.bf16_tolerance(feats16)):
            fail(f"roi_align out of map {name} bf16: max |diff| {err16}")
        s_out = (torch.rand(*crop, c, generator=gen) * 2 + 3.0).to(device)
        k8 = roi_align.batched_multilevel_roi_align(feats16, boxes, image, crop, out_quant=s_out)
        p8 = roi_align.batched_multilevel_roi_align_plain(feats16, boxes, image, crop,
                                                          out_quant=s_out)
        if not (k8.dtype == torch.int8 and torch.equal(k8, p8) and not bool(k8[0, 0].any())):
            fail(f"roi_align out of map {name} int8: kernel not bit-equal to plain")
        worst = 0.0
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.randn(BATCH, 2, *crop, c, generator=gen).to(device, dtype)
            got = roi_align.roi_align_backward(g, boxes, grad_shapes, image)
            want = roi_align.roi_align_backward_plain(g, boxes, grad_shapes, image)
            tol = roi_align.backward_tolerance(g, boxes, grad_shapes, image)
            torch.cuda.synchronize()
            for k, p, t in zip(got, want, tol):
                kd, pd = k.double(), p.double()
                fin = ~torch.isnan(pd)
                if not torch.equal(torch.isnan(kd), ~fin):
                    fail(f"roi_align out of map {name} gradient {dtype}: NaNs differ")
                d = (kd - pd).abs()[fin]
                if bool((d > t.expand_as(kd)[fin]).any()):
                    fail(f"roi_align out of map {name} gradient {dtype}: beyond the bound")
                worst = max(worst, float(d.max()) if d.numel() else 0.0)
        log(f"roi_align out of map {name} (NaN box; image 0 P2 wrapping to the table's end; "
            f"image 1 above its P4; levels {levels}): f32 bit-equal, bf16 max |diff| "
            f"{err16:.3g}, int8 bit-equal (NaN box -> code 0), gradient f32/bf16 within the "
            f"bound (max |diff| {worst:.3g}), NaNs in the plain version's places")


# ---------------------------------------------------------------- phase 4


@contextlib.contextmanager
def plain_path():
    """Route every kernel wrapper to its plain version (for comparison): the
    plain ROIAlign is differentiated by autograd, so its gradient is the
    plain backward too."""
    from objectdetection_torch.ops import anchor_match, fused_block, int8_conv, nms, roi_align

    saved = (nms.suppress, roi_align.batched_multilevel_roi_align, anchor_match.anchor_match,
             fused_block.fused_identity_block_int8, int8_conv.int8_conv_fused)
    nms.suppress = nms.suppress_plain
    roi_align.batched_multilevel_roi_align = roi_align.batched_multilevel_roi_align_plain
    anchor_match.anchor_match = anchor_match.anchor_match_plain
    fused_block.fused_identity_block_int8 = fused_block.fused_identity_block_int8_plain
    int8_conv.int8_conv_fused = int8_conv.int8_conv_fused_plain
    try:
        yield
    finally:
        (nms.suppress, roi_align.batched_multilevel_roi_align, anchor_match.anchor_match,
         fused_block.fused_identity_block_int8, int8_conv.int8_conv_fused) = saved


def launch_counts():
    from objectdetection_torch.ops import anchor_match, fused_block, int8_conv, nms, roi_align

    return {"nms": nms.launches, "roi_align": roi_align.launches,
            "roi_align_backward": roi_align.backward_launches,
            "anchor_match": anchor_match.launches,
            "roi_align_int8": roi_align.int8_launches, "fused_block": fused_block.launches,
            "int8_conv": int8_conv.launches}


def reset_launch_counts():
    from objectdetection_torch.ops import anchor_match, fused_block, int8_conv, nms, roi_align

    nms.launches = roi_align.launches = roi_align.backward_launches = 0
    anchor_match.launches = roi_align.int8_launches = fused_block.launches = 0
    int8_conv.launches = 0


def rms(a, b) -> float:
    import torch

    return float(torch.sqrt(torch.mean((a.float() - b.float()) ** 2)))


def stage_breakdown(model, params, infer, images, windows, device):
    """Where a batch's time goes: CUDA-event spans of the main path's stages
    over REPS batches; the same batch through the entry points on the host
    clock; one batch under torch.profiler for the device's busy share and its
    largest kernels."""
    import torch

    from objectdetection_torch import detector
    from objectdetection_torch.anchors import config_anchors
    from objectdetection_torch.geometry import norm_boxes
    from objectdetection_torch.layers.detection import detection_layer
    from objectdetection_torch.layers.proposals import proposal_layer

    cfg = model.config
    image = tuple(cfg.image_shape[:2])
    x = torch.as_tensor(images, device=device)
    win = torch.as_tensor(windows, device=device)
    anchors = torch.from_numpy(config_anchors(cfg)).to(device)
    spans = {}

    def stage(name, fn, *a):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*a)
        end.record()
        spans.setdefault(name, []).append((start, end))
        return out

    def run_batch():
        feats, _, probs, deltas = stage("backbone+rpn", model.extract, x)
        props = stage("proposals", proposal_layer, probs, deltas, anchors, cfg)
        _, cls_probs, bbox = stage("box stage", model.classify_rois, feats, props)
        det = stage("detection", detection_layer, props, cls_probs, bbox,
                    norm_boxes(win, image), cfg)
        stage("mask stage", model.predict_masks, feats, det[..., :4],
              det[..., 4].to(torch.int64))

    with torch.inference_mode():
        run_batch()
        torch.cuda.synchronize()
        spans.clear()
        t0 = time.perf_counter()
        for _ in range(REPS):
            run_batch()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / REPS
        ms = {k: sum(s.elapsed_time(e) for s, e in v) / len(v) for k, v in spans.items()}
        entry = {
            "module forward": lambda: model(x, win),
            "forward_inference": lambda: detector.forward_inference(params, x, win, cfg),
            "make_infer_fn": lambda: infer(params, images, windows),
        }
        entry_ms = {name: time_host_ms(fn, REPS) for name, fn in entry.items()}
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts, acc_events=True) as prof:
            t0 = time.perf_counter()
            run_batch()
            torch.cuda.synchronize()
            prof_wall = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in events) / 1e3
    if not busy > 0:
        fail("stages: the profiler saw no device time")
    log(f"stages: wall {wall:.3f} ms per batch over {REPS} batches")
    for k, v in ms.items():
        log(f"  stage {k:14s} {v:8.3f} ms ({100 * v / wall:5.1f}% of wall)")
    for k, v in entry_ms.items():
        log(f"  entry point {k:18s} {v:8.3f} ms per batch")
    log(f"  profiled batch: wall {prof_wall:.3f} ms, device busy {busy:.3f} ms "
        f"({100 * busy / prof_wall:.1f}%)")
    for e in sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:TOP]:
        log(f"  {e.self_device_time_total / 1e3:8.3f} ms {e.count:5d}x  {e.key[:80]}")


def time_host_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def kernel_vs_plain(model, params, request, device):
    """Threshold-0 runs (so that under random weights the class-aware NMS and
    the 14x14 stage carry real rows), bf16 and f32, held against the plain
    path on the card. Each kernel stage is run again in its plain version on
    the kernel path's own inputs:

    - proposals and detection rows (NMS): identical;
    - the 7x7 and 14x14 ROIAlign outputs: bit-equal in f32, within
      ``roi_align.bf16_tolerance`` in bf16;
    - class probs and masks, the heads applied to the plain pooled tensors:
      identical in f32.

    In bf16 the witness is f32: the plain ROIAlign of the same pyramid cast to
    f32, and the heads run in f32 on it. The kernel's pooled tensors must be no
    further (RMS) from it than the plain version's, since the kernel rounds
    once where the plain version rounds after every op. The heads amplify
    rounding differences, so class probs and masks are held in RMS to twice
    the plain path's own distance from the f32 heads: each path lies within
    about that distance of the f32 output, so the two lie within twice it of
    each other.
    """
    import torch

    from objectdetection_torch import detector
    from objectdetection_torch.anchors import config_anchors
    from objectdetection_torch.geometry import norm_boxes
    from objectdetection_torch.layers.detection import detection_layer
    from objectdetection_torch.layers.proposals import proposal_layer
    from objectdetection_torch.models.mask_rcnn import compute_dtype
    from objectdetection_torch.ops import roi_align

    cfg = model.config
    image = tuple(cfg.image_shape[:2])
    anchors = torch.from_numpy(config_anchors(cfg)).to(device)
    align_plain = roi_align.batched_multilevel_roi_align_plain
    for dtype in ("bfloat16", "float32"):
        cfg0 = cfg.replace(detection_min_threshold=0.0, compute_dtype=dtype)
        dt = compute_dtype(cfg0)
        images, windows = (torch.as_tensor(a, device=device) for a in request())
        with torch.inference_mode():
            res, it = detector.forward_inference(params, images, windows, cfg0,
                                                 return_intermediates=True)
            feats = [it["pyramid"][f"p{i}"] for i in range(2, 6)]
            props, det = it["proposals"], it["detections"]
            boxes, ids = det[..., :4], det[..., 4].to(torch.int64)
            before = launch_counts()
            with plain_path():
                props_p = proposal_layer(it["rpn_class_probs"], it["rpn_bbox"], anchors, cfg0)
                det_p = detection_layer(props, it["mrcnn_class_probs"], it["mrcnn_bbox"],
                                        norm_boxes(windows, image), cfg0)
            if launch_counts() != before:
                fail("e2e threshold 0: the plain path launched a kernel")
            roi_p = align_plain(feats, props, image, cfg.pool_shape)
            mask_p = align_plain(feats, boxes, image, cfg.mask_pool_shape)
            probs_p = model.mrcnn(roi_p, dt)[1]
            masks_p = model.mrcnn_mask(mask_p, ids, dt)
            if dtype == "bfloat16":
                f32 = [f.float() for f in feats]
                roi_ref = align_plain(f32, props, image, cfg.pool_shape)
                mask_ref = align_plain(f32, boxes, image, cfg.mask_pool_shape)
                probs_ref = model.mrcnn(roi_ref, torch.float32)[1]
                masks_ref = model.mrcnn_mask(mask_ref, ids, torch.float32)
        tag = f"e2e threshold 0 {dtype}"
        if not torch.equal(props_p, props):
            fail(f"{tag}: proposals differ between the NMS kernel and plain")
        if not torch.equal(det_p, det):
            bad = int((det_p != det).any(-1).sum())
            fail(f"{tag}: detection rows differ between the NMS kernel and plain ({bad} rows)")
        n_props = int((props != 0).any(-1).sum())
        n_det = int(res.valid.sum())
        log(f"{tag}: NMS kernel == plain on the path's own inputs: proposals ({n_props} rows), "
            f"detections ({n_det} rows)")
        pooled = (("ROIAlign 7x7", it["roi_pooled"], roi_p),
                  ("ROIAlign 14x14", it["mask_pooled"], mask_p))
        heads = (("class probs", it["mrcnn_class_probs"], probs_p),
                 ("masks", res.masks, masks_p))
        if dtype == "float32":
            for name, got, want in pooled + heads:
                if not torch.equal(got, want):
                    fail(f"{tag}: {name} differ between kernel and plain path "
                         f"(max |diff| {float((got - want).abs().max())})")
            log(f"{tag}: ROIAlign 7x7 and 14x14 bit-equal, class probs and masks identical "
                "between kernel and plain path")
            continue
        tol = roi_align.bf16_tolerance(feats)
        for (name, got, want), ref in zip(pooled, (roi_ref, mask_ref)):
            err = float((got.float() - want.float()).abs().max())
            err_k, err_p = rms(got, ref), rms(want, ref)
            log(f"{tag}: {name} kernel vs plain on the path's pyramid: max |diff| {err:.4g} "
                f"<= tol {tol:.4g}; RMS from f32: kernel {err_k:.6g}, plain {err_p:.6g}")
            if not (err <= tol and err_k <= err_p):
                fail(f"{tag}: {name}: kernel vs plain max |diff| {err} (tol {tol}), RMS from "
                     f"f32 kernel {err_k} vs plain {err_p}")
        for (name, got, want), ref in zip(heads, (probs_ref, masks_ref)):
            gap, err_k, err_p = rms(got, want), rms(got, ref), rms(want, ref)
            log(f"{tag}: {name}: kernel vs plain path RMS {gap:.6g} <= tol {2 * err_p:.6g} "
                f"(max |diff| {float((got - want).abs().max()):.4g}); RMS from the f32 "
                f"heads: kernel path {err_k:.6g}, plain path {err_p:.6g}")
            if not gap <= 2 * err_p:
                fail(f"{tag}: {name}: kernel vs plain path RMS {gap} > {2 * err_p}")


def random_request(rng, cfg):
    """A batch of BATCH uniform random images minus the mean, each window the
    whole canvas: phase 4's requests (phase 12 takes the first again)."""
    import numpy as np

    h, w = cfg.image_shape[:2]
    images = rng.uniform(0, 255, (BATCH, h, w, 3)).astype(np.float32) - np.asarray(
        cfg.mean_pixel, np.float32)
    return images, np.tile(np.array([[0, 0, h, w]], np.float32), (BATCH, 1))


def end_to_end(device):
    import numpy as np
    import torch

    from objectdetection_torch import convert, detector
    from objectdetection_torch.config import COCO_CONFIG
    from objectdetection_torch.models.mask_rcnn import MaskRCNN
    from objectdetection_torch.ops import nms, roi_align

    cfg = COCO_CONFIG
    t0 = time.perf_counter()
    params = convert.init_params(cfg, torch.Generator().manual_seed(0), device)
    # the same tensors in a module tree, for driving single stages
    with torch.device("meta"):
        model = MaskRCNN(cfg).eval()
    model.load_state_dict(params, assign=True)
    log(f"e2e: {cfg.backbone} FPN {cfg.fpn_channels}, {cfg.num_classes} classes, "
        f"{cfg.image_shape[0]}², {cfg.compute_dtype}; "
        f"{sum(p.numel() for p in params.values()) / 1e6:.1f}M params "
        f"(init {time.perf_counter() - t0:.1f} s)")
    rng = np.random.RandomState(0)

    def request():
        return random_request(rng, cfg)

    infer = detector.make_infer_fn(cfg)
    warm = request()
    t0 = time.perf_counter()
    infer(params, *warm)
    torch.cuda.synchronize()
    log(f"e2e warm-up call: {(time.perf_counter() - t0) * 1e3:.1f} ms")

    requests = [request() for _ in range(3)]
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    for i, (images, windows) in enumerate(requests):
        before = (nms.launches, roi_align.launches)
        t0 = time.perf_counter()
        det = infer(params, images, windows)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        step = (nms.launches - before[0], roi_align.launches - before[1])
        n = cfg.detection_post_nms_instances
        shapes = {
            "boxes": (BATCH, n, 4), "class_ids": (BATCH, n), "scores": (BATCH, n),
            "valid": (BATCH, n), "masks": (BATCH, n, *cfg.mask_shape),
        }
        for key, shape in shapes.items():
            t = getattr(det, key)
            if tuple(t.shape) != shape:
                fail(f"e2e request {i}: {key} shape {tuple(t.shape)} != {shape}")
            if t.is_floating_point() and not bool(torch.isfinite(t).all()):
                fail(f"e2e request {i}: {key} not finite")
        # one NMS launch per stage covers every image of the batch
        if step[0] < 2 or step[1] < 2:
            fail(f"e2e request {i}: kernel launches {step} (nms, roi_align); want >= 2 each")
        log(f"e2e request {i}: {ms:.1f} ms, {int(det.valid.sum())} detections, "
            f"launches nms {step[0]} roi_align {step[1]}")
    launches = launch_counts()
    log(f"e2e peak memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for name in ("nms", "roi_align"):
        if launches[name] == 0:
            fail(f"the inference path never launched the {name} kernel")
    log(f"e2e launches over 3 requests: {launches}")

    stage_breakdown(model, params, infer, *requests[0], device)
    kernel_vs_plain(model, params, request, device)
    return params


# ---------------------------------------------------------------- phase 5


def match_inputs(gen, anchors, g: int, device):
    """GT boxes [B, G, 4] of realistic sizes with padding rows, duplicated
    boxes (ties) and a share of invalid rows that still hold boxes."""
    import torch

    b = BATCH
    y1x1 = torch.rand(b, g, 2, generator=gen) * 0.8
    hw = 0.02 + torch.rand(b, g, 2, generator=gen) ** 2 * 0.5
    gt = torch.cat([y1x1, (y1x1 + hw).clamp(max=1.0)], -1)
    gt[:, 1] = gt[:, 0]  # a duplicated GT: anchor argmax ties go low
    gt[:, 2] = anchors[1000].cpu()  # an anchor exactly
    valid = torch.rand(b, g, generator=gen) > 0.2
    valid[:, :3] = True
    valid[:, g - 10:] = False
    gt[:, g - 10:] = 0.0  # zero padding rows
    return gt.to(device).contiguous(), valid.to(device).contiguous()


def match_phase(device):
    import torch

    from objectdetection_torch.anchors import config_anchors
    from objectdetection_torch.config import COCO_CONFIG
    from objectdetection_torch.geometry import iou_matrix
    from objectdetection_torch.ops import anchor_match

    cfg = COCO_CONFIG
    anchors = torch.from_numpy(config_anchors(cfg)).to(device)
    a, g = anchors.shape[0], cfg.max_gt_objects
    gt, valid = match_inputs(torch.Generator().manual_seed(5), anchors, g, device)
    got = anchor_match.anchor_match(anchors, gt, valid)
    want = anchor_match.anchor_match_plain(anchors, gt, valid)
    torch.cuda.synchronize()
    for name, k, p in zip(got._fields, got, want):
        if not torch.equal(k, p):
            bad = int((k != p).sum())
            fail(f"anchor_match: kernel {name} differs from plain in {bad} entries")
    ev_ms = time_ms(lambda: anchor_match.anchor_match(anchors, gt, valid), 50)
    ms = device_ms(lambda: anchor_match.anchor_match(anchors, gt, valid))
    plain_ms = time_ms(lambda: anchor_match.anchor_match_plain(anchors, gt, valid), 3, warmup=1)
    # the bound counts the tests no exact kernel can skip: the pairs whose
    # boxes overlap (IoU > 0 with a valid GT); the kernel culls the rest by
    # tile. The dense count (every anchor with every valid GT) is logged.
    dense = a * int(valid.sum())
    overlap = int(((iou_matrix(anchors, gt) > 0) & valid[:, None, :]).sum())
    bytes_ = a * 16 + gt.numel() * 4 + valid.numel() + BATCH * a * 8 + BATCH * g * 8
    ops = overlap * MATCH_OPS
    rec = {"ms": ms, "plain_ms": plain_ms, "bytes_ms": bytes_ / PEAK_BYTES * 1e3,
           "ops_ms": ops / PEAK_F32 * 1e3, "max_abs_err": 0.0, "library_ms": None}
    dense_ms = dense * MATCH_OPS / PEAK_F32 * 1e3
    log(f"anchor_match: B={BATCH} A={a} G={g} ({int(valid.sum())} valid): kernel == plain "
        f"(maxima bit-equal, argmaxes equal); kernel {ms:.4f} ms device ({ev_ms:.4f} ms "
        f"between events), plain {plain_ms:.3f} ms; "
        f"bound {max(rec['bytes_ms'], rec['ops_ms']):.4f} ms ({overlap} overlapping pairs, "
        f"{ops / 1e9:.4f} GFLOP f32: {rec['ops_ms']:.5f} ms; {bytes_ / 1e6:.1f} MB: "
        f"{rec['bytes_ms']:.5f} ms); dense bound {max(rec['bytes_ms'], dense_ms):.4f} ms "
        f"({dense} pairs)")
    return rec


def roi_backward_phase(device):
    """ROIAlign gradient kernel against the plain backward (autograd of the
    plain version) at the training path's shapes: 7×7 and 14×14 stages, 200
    ROIs per image (train_rois_per_image), f32 and bf16."""
    import torch

    from objectdetection_torch.config import COCO_CONFIG
    from objectdetection_torch.ops import roi_align

    cfg = COCO_CONFIG
    gen = torch.Generator().manual_seed(6)
    image = tuple(cfg.image_shape[:2])
    c = cfg.fpn_channels
    r = cfg.train_rois_per_image
    shapes = [(BATCH, h, w, c) for h, w in cfg.feature_shapes()[:4]]
    rec = {"ms": 0.0, "kernel_ms": 0.0, "plain_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0,
           "max_abs_err": 0.0, "library_ms": None}
    for name, crop in (("box", cfg.pool_shape), ("mask", cfg.mask_pool_shape)):
        boxes = roi_boxes(gen, r, device)
        g32 = torch.randn(BATCH, r, *crop, c, generator=gen).to(device)
        for dtype in (torch.float32, torch.bfloat16):
            grad_out = g32.to(dtype)
            got = roi_align.roi_align_backward(grad_out, boxes, shapes, image)
            want = roi_align.roi_align_backward_plain(grad_out, boxes, shapes, image)
            tol = roi_align.backward_tolerance(grad_out, boxes, shapes, image)
            torch.cuda.synchronize()
            err = max(float((k.double() - p.double()).abs().max()) for k, p in zip(got, want))
            over = sum(int(((k.double() - p.double()).abs() > t).sum())
                       for k, p, t in zip(got, want, tol))
            if over:
                fail(f"roi_align_backward {name} {dtype}: {over} elements beyond the stated "
                     f"bound (max |kernel - plain| {err})")
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            extra = ""
            if dtype == torch.bfloat16:
                # the same bf16 gradient values, summed in f32 with f32 weights
                ref = roi_align.roi_align_backward_plain(grad_out.float(), boxes, shapes, image)
                tol32 = roi_align.backward_tolerance(grad_out, boxes, shapes, image,
                                                     against_f32=True)
                err_k = max(float((k.double() - f.double()).abs().max()) for k, f in zip(got, ref))
                err_p = max(float((p.double() - f.double()).abs().max()) for p, f in zip(want, ref))
                over = sum(int(((k.double() - f.double()).abs() > t).sum())
                           for k, f, t in zip(got, ref, tol32))
                if over:
                    fail(f"roi_align_backward {name} bf16: {over} elements beyond the bound "
                         f"from the f32 backward (max {err_k})")
                extra = f"; from the f32 backward: kernel {err_k:.4g}, plain {err_p:.4g}"
            log(f"roi_align_backward {name} {str(dtype)[6:]}: B={BATCH} R={r} "
                f"{crop[0]}x{crop[1]} C={c}: max |kernel - plain| {err:.4g}, within the "
                f"stated bound{extra}")
        ev_ms = time_ms(lambda: roi_align.roi_align_backward(grad_out, boxes, shapes, image), 20)
        ms = device_ms(lambda: roi_align.roi_align_backward(grad_out, boxes, shapes, image))
        ms32 = time_ms(lambda: roi_align.roi_align_backward(g32, boxes, shapes, image), 20)
        plain_ms = time_ms(
            lambda: roi_align.roi_align_backward_plain(grad_out, boxes, shapes, image), 3,
            warmup=1)
        outs = grad_out.numel()
        dense = sum(BATCH * h * w * c for _, h, w, _ in shapes)
        bytes_ = outs * 2 + boxes.numel() * 4 + dense * 2
        ops = outs * 8  # 4 products + 4 sums per grad_out element
        rec["ms"] += ms
        rec["plain_ms"] += plain_ms
        rec["bytes_ms"] += bytes_ / PEAK_BYTES * 1e3
        rec["ops_ms"] += ops / PEAK_BF16 * 1e3
        log(f"roi_align_backward {name}: kernel bf16 {ms:.4f} ms device ({ev_ms:.4f} ms "
            f"between events; f32 {ms32:.4f}), plain "
            f"bf16 {plain_ms:.3f} ms; bound {bytes_ / PEAK_BYTES * 1e3:.4f} ms "
            f"({bytes_ / 1e6:.1f} MB: grad_out read, dense bf16 pyramid gradient written)")
    return rec


# ---------------------------------------------------------------- phase 6


def train_batch(cfg, device):
    """Seeded training batch: up to 100 GT per image with padding rows,
    axis-aligned boxes, mini-masks of filled rectangles, uniform pixels minus
    the mean."""
    import numpy as np
    import torch

    from objectdetection_torch.detector import TrainBatch

    rng = np.random.RandomState(11)
    h, w = cfg.image_shape[:2]
    g = cfg.max_gt_objects
    mh, mw = cfg.mini_mask_shape
    images = rng.uniform(0, 255, (BATCH, h, w, 3)).astype(np.float32) - np.asarray(
        cfg.mean_pixel, np.float32)
    y1x1 = rng.uniform(0.0, 0.85, (BATCH, g, 2))
    hw = rng.uniform(0.02, 0.4, (BATCH, g, 2))
    boxes = np.concatenate([y1x1, np.minimum(y1x1 + hw, 1.0)], -1).astype(np.float32)
    cls = rng.randint(1, cfg.num_classes, (BATCH, g)).astype(np.int32)
    masks = np.zeros((BATCH, g, mh, mw), np.float32)
    for i, n in enumerate((g - 13, g // 2)):
        cls[i, n:] = 0
        boxes[i, n:] = 0.0
        for j in range(n):
            y0, x0 = rng.randint(0, mh // 3, 2)
            y1, x1 = rng.randint(2 * mh // 3, mh + 1, 2)
            masks[i, j, y0:y1, x0:x1] = 1.0
    return TrainBatch(*(torch.from_numpy(x).to(device) for x in (images, boxes, cls, masks)))


def losses_and_grads(params, stats, batch, cfg, noise):
    import torch

    from objectdetection_torch import detector

    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    parts, targets = detector.compute_losses({**leaves, **stats}, batch, cfg, noise,
                                             with_masks=True, return_targets=True)
    grads = torch.autograd.grad(sum(parts.values()), list(leaves.values()), allow_unused=True)
    grads = {k: torch.zeros_like(v) if g is None else g
             for (k, v), g in zip(leaves.items(), grads)}
    return {k: v.detach() for k, v in parts.items()}, targets, grads


def train_f32_vs_plain(params, stats, batch, device):
    """One f32 step of the training path through the kernels and through the
    plain versions, on the same batch and noise."""
    import torch

    from objectdetection_torch import detector
    from objectdetection_torch.config import COCO_CONFIG

    cfg = COCO_CONFIG.replace(compute_dtype="float32")
    noise = detector.draw_noise(cfg, batch, torch.Generator(device=device).manual_seed(2))
    torch.backends.cudnn.deterministic = True  # leave only the atomics' order free
    try:
        t0 = time.perf_counter()
        before = launch_counts()
        parts_k, tgt_k, grads_k = losses_and_grads(params, stats, batch, cfg, noise)
        torch.cuda.synchronize()
        ms_k = (time.perf_counter() - t0) * 1e3
        launched = {k: v - before[k] for k, v in launch_counts().items()}
        t0 = time.perf_counter()
        with plain_path():
            parts_p, tgt_p, grads_p = losses_and_grads(params, stats, batch, cfg, noise)
            torch.cuda.synchronize()
        ms_p = (time.perf_counter() - t0) * 1e3
        if launch_counts() != {k: before[k] + launched[k] for k in before}:
            fail("train f32: the plain path launched a kernel")
    finally:
        torch.backends.cudnn.deterministic = False
    if min(launched[k] for k in TRAIN_KERNELS) == 0:
        fail(f"train f32: the kernel path missed a kernel: {launched}")
    (rpn_k, props_k, det_k), (rpn_p, props_p, det_p) = tgt_k, tgt_p
    for name, a, b in (("rpn target_class", rpn_k.target_class, rpn_p.target_class),
                       ("proposals", props_k, props_p),
                       ("sampled rois", det_k.rois, det_p.rois),
                       ("target_class_ids", det_k.target_class_ids, det_p.target_class_ids),
                       ("target masks", det_k.target_masks, det_p.target_masks)):
        if not torch.equal(a, b):
            fail(f"train f32: {name} differ between the kernel and the plain path")
    n_pos = int(det_k.pos_mask.sum())
    if n_pos == 0:
        fail("train f32: no positive ROI, the second stage would get no box or mask gradient")
    for k, v in parts_k.items():
        ref = float(parts_p[k])
        if not (torch.isfinite(v) and abs(float(v) - ref) <= 1e-6 * abs(ref)):
            fail(f"train f32: {k} kernel {float(v)} vs plain {ref}")
    worst, worst_name = 0.0, ""
    for k, gk in grads_k.items():
        gp = grads_p[k]
        err = float(torch.linalg.vector_norm(gk - gp))
        ref = float(torch.linalg.vector_norm(gp))
        rel = err / ref if ref > 0 else (0.0 if err == 0 else float("inf"))
        if rel > worst:
            worst, worst_name = rel, k
        if not rel <= GRAD_REL:
            fail(f"train f32: gradient of {k} differs: |kernel - plain| {err} vs |plain| {ref}")
    log(f"train f32 ({cfg.backbone} {cfg.image_shape[0]}² B={BATCH}, masks): kernel path "
        f"{ms_k:.0f} ms, plain path "
        f"{ms_p:.0f} ms; launches {launched}; targets identical "
        f"({int((rpn_k.target_class != 0).sum())} RPN anchors sampled, {n_pos} positive ROIs); "
        f"losses " + ", ".join(f"{k} {float(v):.6g}" for k, v in parts_k.items())
        + f" (equal to plain within 1e-6); {len(grads_k)} gradient leaves within "
        f"{GRAD_REL} relative, worst {worst:.3g} ({worst_name})")


def train_bf16(params, stats, batch, device):
    """Five bf16 steps through make_train_step; the launch counters are read
    around them. Returns the launches."""
    import torch

    from objectdetection_torch import detector, losses, optim
    from objectdetection_torch.config import COCO_CONFIG

    cfg = COCO_CONFIG
    gen = torch.Generator(device=device).manual_seed(1)
    step = detector.make_train_step(cfg, with_masks=True)
    state = detector.TrainState(params, stats, optim.init(params), 0)

    # the FPN's gradient from the second-stage losses alone (zero if the
    # pooled features were cut from the pyramid)
    fpn = {k: v.detach().requires_grad_(True) for k, v in params.items() if k.startswith("fpn.")}
    parts = detector.compute_losses({**params, **fpn, **stats}, batch, cfg, generator=gen,
                                    with_masks=True)
    second = parts["mrcnn_class_loss"] + parts["mrcnn_box_loss"] + parts["mask_loss"]
    fpn_norm = float(optim.global_norm([g for g in torch.autograd.grad(
        second, list(fpn.values()), allow_unused=True) if g is not None]))
    if not fpn_norm > 0:
        fail(f"train bf16: the second-stage losses give the FPN no gradient ({fpn_norm})")
    log(f"train bf16: FPN gradient norm from the second-stage losses alone {fpn_norm:.6g}")
    del parts, second, fpn

    t0 = time.perf_counter()
    state, metrics = step(state, batch, gen)
    torch.cuda.synchronize()
    log(f"train bf16: first step {(time.perf_counter() - t0) * 1e3:.0f} ms (cuDNN heuristics "
        "for the backward, lazy init)")
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(TRAIN_STEPS)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(TRAIN_STEPS)]
    history = []
    t0 = time.perf_counter()
    for i in range(TRAIN_STEPS):
        starts[i].record()
        state, metrics = step(state, batch, gen)
        ends[i].record()
        history.append(metrics)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / TRAIN_STEPS
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    for i, m in enumerate(history):
        bad = [k for k, v in m.items() if not bool(torch.isfinite(v))]
        if bad:
            fail(f"train bf16 step {i}: not finite: {bad}")
        # the heads' norms may be 0 in a step without positive ROIs; the
        # backbone and the RPN always get a gradient
        for k in ("grad_norm/fpn", "grad_norm/rpn_model"):
            if not float(m[k]) > 0:
                fail(f"train bf16 step {i}: {k} is zero")
        log(f"train bf16 step {i}: {starts[i].elapsed_time(ends[i]):.1f} ms between events; "
            + ", ".join(f"{k} {float(v):.5g}" for k, v in m.items()))
    if state.step != TRAIN_STEPS + 1:
        fail(f"train bf16: state.step {state.step}")
    if min(launches[k] for k in TRAIN_KERNELS) == 0:
        fail(f"train bf16: the training path missed a kernel: {launches}")

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, acc_events=True) as prof:
        t1 = time.perf_counter()
        state, _ = step(state, batch, gen)
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t1) * 1e3
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in events) / 1e3
    if not busy > 0:
        fail("train bf16: the profiler saw no device time")
    log(f"train bf16: {TRAIN_STEPS} steps, host wall {wall:.1f} ms per step; launches {launches}; "
        f"peak memory {peak:.2f} GiB")
    log(f"  profiled step: wall {prof_wall:.1f} ms, device busy {busy:.1f} ms "
        f"({100 * busy / prof_wall:.1f}%)")
    for e in sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:TOP]:
        log(f"  {e.self_device_time_total / 1e3:8.3f} ms {e.count:5d}x  {e.key[:80]}")
    return launches


def training(params, device):
    from objectdetection_torch.config import COCO_CONFIG
    from objectdetection_torch.convert import split_collections

    p, stats, _ = split_collections(params)
    batch = train_batch(COCO_CONFIG, device)
    log(f"train batch: {int((batch.gt_class_ids > 0).sum())} GT over {BATCH} images, "
        f"mini-masks {tuple(batch.gt_masks.shape[2:])}")
    train_f32_vs_plain(p, stats, batch, device)
    return train_bf16(p, stats, batch, device)


# ---------------------------------------------------------------- phase 7


def block_case(gen, h: int, w: int, c3: int, c1: int, device):
    """Random int8 stream and kernels with every affine nonzero (the inputs
    of tests/test_fused_block.py's make_case at a stage's shape, B=2); the
    kernels HWIO views of OIHW storage, as the backbone passes them."""
    import torch

    k = lambda *s: torch.randint(-127, 128, s, generator=gen, dtype=torch.int8).to(
        device).permute(3, 2, 0, 1).contiguous().permute(2, 3, 1, 0)
    v = lambda n, lo=0.5, hi=1.5: (lo + (hi - lo) * torch.rand(n, generator=gen)).to(device)
    f = lambda x: torch.tensor(x, dtype=torch.float32, device=device)
    x8 = torch.randint(-128, 128, (BATCH, h, w, c3), generator=gen, dtype=torch.int8).to(device)
    return (x8, f(3.0), k(1, 1, c3, c1), k(3, 3, c1, c1), k(1, 1, c1, c3),
            v(c1) * 0.01, v(c1) * 0.002, v(c3) * 0.01,
            v(c1, -0.2, 0.2), v(c1, -0.2, 0.2), v(c3, -0.2, 0.2),
            (v(c1), v(c1, -0.3, 0.3)), (v(c1), v(c1, -0.3, 0.3)), (v(c3), v(c3, -0.3, 0.3)),
            f(4.0), f(5.0), f(6.0))


def fused_block_phase(device):
    """7(a): the fused block kernel at the four stage shapes, bit-equal to
    its plain version; per batch, each stage's time counts once per identity
    block of that stage in R101 (29 launches)."""
    import torch

    from objectdetection_torch.ops import fused_block

    gen = torch.Generator().manual_seed(7)
    rec = {"ms": 0.0, "kernel_ms": 0.0, "plain_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0,
           "max_abs_err": 0.0, "library_ms": None}
    for (h, w, c3, c1), n in zip(STAGES, STAGE_BLOCKS):
        args = block_case(gen, h, w, c3, c1, device)
        got = fused_block.fused_identity_block_int8(*args)
        want = fused_block.fused_identity_block_int8_plain(*args)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            bad = int((got != want).sum())
            fail(f"fused_block {h}x{w}x{c3}/{c1}: kernel differs from plain in {bad} codes "
                 f"(max {int((got.int() - want.int()).abs().max())} steps)")
        nonzero = float((want != 0).float().mean())
        ev_ms = time_ms(lambda: fused_block.fused_identity_block_int8(*args), 20)
        split = device_split(lambda: fused_block.fused_identity_block_int8(*args))
        ms = sum(split.values())
        kernel_ms = sum(v for k, v in split.items() if "fused_block_kernel" in k)
        plan = fused_block.tile_plan(BATCH, h, w, c3, c1)
        plain_ms = time_ms(lambda: fused_block.fused_identity_block_int8_plain(*args), 3,
                           warmup=1)
        ops, bytes_ = fused_block.block_bound(BATCH, h, w, c3, c1)
        b_ms, o_ms = bytes_ / PEAK_BYTES * 1e3, ops / PEAK_INT8 * 1e3
        rec["ms"] += n * ms
        rec["plain_ms"] += n * plain_ms
        rec["bytes_ms"] += n * b_ms
        rec["ops_ms"] += n * o_ms
        rec.setdefault("bound_ms", 0.0)
        rec["bound_ms"] += n * max(b_ms, o_ms)
        rec["kernel_ms"] += n * kernel_ms
        log(f"fused_block B={BATCH} {h}x{w} C3={c3} C1={c1} (x{n} per batch): kernel == plain "
            f"({100 * nonzero:.1f}% nonzero codes); {ms:.4f} ms device: block kernel "
            f"{kernel_ms:.4f}, preparation {ms - kernel_ms:.4f} ({ev_ms:.4f} ms between "
            f"events); {plan['th']}x{plan['tw']} tiles, {plan['grid']} blocks, conv 2a at "
            f"{plan['halo']:.3f}x its MACs, {plan['smem']} B shared; plain {plain_ms:.3f} ms; "
            f"bound {max(b_ms, o_ms):.4f} ms ({ops / 1e9:.2f} GOP int8: {o_ms:.4f} ms, "
            f"{bytes_ / 1e6:.1f} MB: {b_ms:.4f} ms)")
    log(f"fused_block per batch (29 blocks): {rec['ms']:.4f} ms (block kernel "
        f"{rec['kernel_ms']:.4f}, preparation {rec['ms'] - rec['kernel_ms']:.4f}), plain "
        f"{rec['plain_ms']:.1f} ms, bound {rec['bound_ms']:.4f} ms")
    return rec


def int8_conv_launches(fused: bool) -> int:
    """The fused int8 conv's launches in one int8 Mask R-CNN call at 1024²:
    125, or 38 where the 29 identity blocks run as fused blocks."""
    from objectdetection_torch.ops import int8_conv

    n = sum(c[-1] for c in int8_conv.mask_rcnn_convs(1))
    return n - 3 * sum(STAGE_BLOCKS) if fused else n


def int8_conv_phase(device):
    """7(a'): the fused int8 conv kernel on every conv shape and epilogue of
    the int8 Mask R-CNN call (``int8_conv.mask_rcnn_convs``) at batch 2, per
    channel and per tensor, and on one stage-2 identity block at batch 96,
    bit-equal to its plain version (im2col, ``torch._int_mm`` and the
    unfused ops); the kernel line's times are one call's at batch 2 (every
    conv times its calls), beside ``torch._int_mm`` alone on the im2col
    matrix."""
    import torch

    from objectdetection_torch.ops import int8_conv

    tool = load_tool("torch_int8_conv_time")
    rec = {"ms": 0.0, "plain_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0, "bound_ms": 0.0,
           "max_abs_err": 0.0, "library_ms": 0.0}
    cases = [(c, True) for c in int8_conv.mask_rcnn_convs(BATCH)]
    cases += [(c, False) for c, _ in cases]
    cases += [((f"res2 {e} batch 96", 96, 256, 256, ci, co, k, 1, e, 0), True)
              for ci, co, k, e in ((256, 64, 1, "ab"), (64, 64, 3, "ab"), (64, 256, 1, "c_id"))]
    for conv, pc in cases:
        name, b, h, w, cin, cout, k, stride, epi, calls = conv
        x8, k8, post, bias, kw = tool.case(device, *conv[1:9], pc=pc)
        got = int8_conv.int8_conv_fused(x8, k8, post, bias, **kw)
        want = int8_conv.int8_conv_fused_plain(x8, k8, post, bias, **kw)
        torch.cuda.synchronize()
        if got.dtype != want.dtype or not torch.equal(got, want):
            fail(f"int8_conv {name} ({'per channel' if pc else 'per tensor'}): kernel differs "
                 f"from plain in {int((got != want).sum())} of {got.numel()} outputs")
        if not pc or not calls:
            continue
        row = tool.measure(conv, x8, k8, post, bias, kw)
        for key, v in (("ms", "kernel_ms"), ("plain_ms", "plain_ms"),
                       ("library_ms", "library_ms"), ("bytes_ms", "bytes_ms"),
                       ("ops_ms", "ops_ms"), ("bound_ms", "bound_ms")):
            rec[key] += calls * row[v]
        log(f"int8_conv {name} B={b} {h}x{w} {cin}->{cout} {k}x{k}/{stride} {epi} (x{calls} a "
            f"call): kernel == plain (per channel and per tensor); {row['kernel_ms']:.4f} ms, "
            f"plain {row['plain_ms']:.3f}, _int_mm alone {row['library_ms']:.3f}, bound "
            f"{row['bound_ms']:.4f} ({row['bound_by']})")
    log(f"int8_conv one call at B={BATCH} ({int8_conv_launches(False)} launches): "
        f"{rec['ms']:.3f} ms, plain {rec['plain_ms']:.2f}, _int_mm alone "
        f"{rec['library_ms']:.2f}, bound {rec['bound_ms']:.4f}; the batch-96 stage-2 block "
        "kernel == plain")
    return rec


def roi_int8_phase(device):
    """7(b): ROIAlign's int8 epilogues at the main path's shapes, each
    variant bit-equal to its plain version. The kernel line's time is the
    int8-default route (int8 P-levels, per-channel in_scale, int8 out) at
    both stages."""
    import torch

    from objectdetection_torch import quant
    from objectdetection_torch.config import COCO_CONFIG
    from objectdetection_torch.ops import roi_align

    cfg = COCO_CONFIG
    gen = torch.Generator().manual_seed(8)
    image = tuple(cfg.image_shape[:2])
    c = cfg.fpn_channels
    shapes = cfg.feature_shapes()[:4]
    f32 = [torch.randn(BATCH, h, w, c, generator=gen) for h, w in shapes]
    s_ch = (torch.rand(c, generator=gen) * 2 + 3.0).to(device)
    s_sc = torch.tensor(4.5, device=device)
    feats16 = [f.to(device, torch.bfloat16) for f in f32]
    q_ch = [quant.quantize_act(f.to(device), s_ch) for f in f32]
    q_sc = [quant.quantize_act(f.to(device), s_sc) for f in f32]
    rec = {"ms": 0.0, "kernel_ms": 0.0, "plain_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0,
           "max_abs_err": 0.0, "library_ms": None}
    for name, r, crop in (("box", 1000, cfg.pool_shape), ("mask", 100, cfg.mask_pool_shape)):
        boxes = roi_boxes(gen, r, device)
        s_out = (torch.rand(*crop, c, generator=gen) * 2 + 3.0).to(device)
        variants = (
            ("bf16 in, int8 out", feats16, dict(out_quant=s_out)),
            ("int8 in per channel, int8 out", q_ch, dict(out_quant=s_out, in_scale=s_ch)),
            ("int8 in per tensor, int8 out", q_sc, dict(out_quant=s_out, in_scale=s_sc)),
            ("int8 in per channel, bf16 out", q_ch, dict(in_scale=s_ch)),
        )
        for vname, feats, kw in variants:
            got = roi_align.batched_multilevel_roi_align(feats, boxes, image, crop, **kw)
            want = roi_align.batched_multilevel_roi_align_plain(feats, boxes, image, crop, **kw)
            torch.cuda.synchronize()
            if not (got.dtype == want.dtype and torch.equal(got, want)):
                fail(f"roi_align int8 {name} {vname}: kernel not bit-equal to plain")
            ms = device_ms(lambda: roi_align.batched_multilevel_roi_align(
                feats, boxes, image, crop, **kw))
            log(f"roi_align int8 {name} B={BATCH} R={r} {crop[0]}x{crop[1]} {vname}: "
                f"kernel == plain; {ms:.4f} ms device")
            if vname == "int8 in per channel, int8 out":
                plain_ms = time_ms(lambda: roi_align.batched_multilevel_roi_align_plain(
                    feats, boxes, image, crop, **kw), 5)
                rows = roi_align.touched_rows(feats, boxes, image, crop)
                outs = BATCH * r * crop[0] * crop[1] * c
                bytes_ = rows * c + boxes.numel() * 4 + outs + s_out.numel() * 4
                rec["ms"] += ms
                rec["plain_ms"] += plain_ms
                rec["bytes_ms"] += bytes_ / PEAK_BYTES * 1e3
                rec["ops_ms"] += outs * 8 / PEAK_F32 * 1e3  # 7 to blend + 1 for the map
                log(f"  bound {bytes_ / PEAK_BYTES * 1e3:.4f} ms ({bytes_ / 1e6:.1f} MB), "
                    f"plain {plain_ms:.3f} ms")
    return rec


def randomized_params(cfg, device):
    """init_params seed 0, every backbone BatchNorm's scale, bias, mean and
    var drawn from a seed (the zero-init bn*_branch2c scales would leave every
    residual branch, and with it the fused block's three convs, out of the
    output); the heads' BatchNorms keep their init, as in phase 4. The
    residual branches' last scales are drawn in [0.05, 0.15]: drawn near 1,
    each of the 33 blocks multiplies the stream by ~1.3 and the RPN's box
    deltas overflow exp() into NaN proposals."""
    import torch

    from objectdetection_torch import convert

    params = convert.init_params(cfg, torch.Generator().manual_seed(0), device)
    gen = torch.Generator().manual_seed(9)
    for name in sorted(params):
        mod, _, leaf = name.rpartition(".")
        if f"{mod}.var" not in params or not mod.startswith("fpn.resnet."):
            continue  # not a backbone BatchNorm
        n = params[name].shape
        lo, hi = (0.05, 0.15) if mod.rsplit(".", 1)[-1].endswith("2c") else (0.5, 1.5)
        draw = {"scale": lambda: lo + (hi - lo) * torch.rand(n, generator=gen),
                "bias": lambda: 0.1 * torch.randn(n, generator=gen),
                "mean": lambda: 0.1 * torch.randn(n, generator=gen),
                "var": lambda: 0.5 + 1.5 * torch.rand(n, generator=gen)}[leaf]
        params[name] = draw().to(device)
    return params


def backbone_codes(cfg, params, images):
    """C2..C5 of the int8 stream: (codes, scale) per stage."""
    import torch
    from torch.func import functional_call

    from objectdetection_torch.detector import build_model
    from objectdetection_torch.models.mask_rcnn import compute_dtype

    model = build_model(cfg)
    sub = {k[len("fpn.resnet."):]: v for k, v in params.items() if k.startswith("fpn.resnet.")}
    x = images.permute(0, 3, 1, 2).to(compute_dtype(cfg)).contiguous(
        memory_format=torch.channels_last)
    with torch.inference_mode():
        return functional_call(model.fpn.resnet, sub, (x,))


def block_by_block(cfg, params, images):
    """{stage: (worst steps, worst share > 1 step, blocks)} of every identity
    block that fuses, run fused on the unfused backbone's own block input."""
    import torch
    from torch.func import functional_call

    from objectdetection_torch.detector import build_model
    from objectdetection_torch.models.mask_rcnn import compute_dtype
    from objectdetection_torch.ops import fused_block

    model = build_model(cfg.replace(fused_bottleneck=False))
    worst = {}

    def hook(module, args, out):
        x = args[0]
        if module.projection or not fused_block.fused_block_supported(x[0], module.filters[0]):
            return
        y8, _ = module._fused(x)
        d = (y8.int() - out[0].int()).abs()
        stage = int(module.names[0][3])
        steps, share, n = worst.get(stage, (0, 0.0, 0))
        worst[stage] = (max(steps, int(d.max())), max(share, float((d > 1).float().mean())),
                        n + 1)

    resnet = model.fpn.resnet
    handles = [resnet._modules[name].register_forward_hook(hook)
               for names in resnet.stages for name in names]
    sub = {k[len("fpn.resnet."):]: v for k, v in params.items() if k.startswith("fpn.resnet.")}
    x = images.permute(0, 3, 1, 2).to(compute_dtype(cfg)).contiguous(
        memory_format=torch.channels_last)
    try:
        with torch.inference_mode():
            functional_call(resnet, sub, (x,))
    finally:
        for h in handles:
            h.remove()
    return worst


def same_detections(a, b) -> bool:
    import torch

    return all(torch.equal(x, y) for x, y in zip(a, b))


def int8_config(name, device, requests, warm):
    """7(c)-(d): calibrate, freeze, serve 3 requests, hold the kernel path
    against the plain path. Returns (frozen params, launches, record)."""
    import torch

    from objectdetection_torch import detector
    from objectdetection_torch.config import COCO_CONFIG
    from objectdetection_torch.quant import QUANT_LEAVES

    over = ({"per_channel_acts": True} if name == "int8-default"
            else {"per_channel_acts": False, "fused_bottleneck": True})
    cfg = COCO_CONFIG.replace(quantized_inference=True, **over)
    params = randomized_params(cfg, device)
    calib = torch.as_tensor(warm[0], device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cal = detector.calibrate_variables(params, calib, cfg, batch_size=1, percentile=90)
    frozen = detector.freeze_weights(cal)
    torch.cuda.synchronize()
    cal_s = time.perf_counter() - t0
    n_int8 = sum(v.dtype == torch.int8 for v in frozen.values())
    infer = detector.make_infer_fn(cfg)
    t0 = time.perf_counter()
    infer(frozen, *warm)
    torch.cuda.synchronize()
    log(f"{name}: calibrated on 2 images (batch 1, percentile 90) and froze {n_int8} int8 "
        f"kernels in {cal_s:.2f} s; warm-up request {(time.perf_counter() - t0) * 1e3:.1f} ms")
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    for i, (images, windows) in enumerate(requests):
        t0 = time.perf_counter()
        det = infer(frozen, images, windows)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        n = cfg.detection_post_nms_instances
        for key, shape in (("boxes", (BATCH, n, 4)), ("scores", (BATCH, n)),
                           ("masks", (BATCH, n, *cfg.mask_shape))):
            t = getattr(det, key)
            if tuple(t.shape) != shape or not bool(torch.isfinite(t).all()):
                fail(f"{name} request {i}: {key} {tuple(t.shape)} not finite or misshapen")
        per_image = det.valid.sum(1).tolist()
        if min(per_image) < 1:
            float_params = {k: v for k, v in params.items()
                            if k.rsplit(".", 1)[-1] not in QUANT_LEAVES}
            f_det = detector.make_infer_fn(COCO_CONFIG)(float_params, images, windows)
            fail(f"{name} request {i}: an image has no valid detection ({per_image}; the "
                 f"bf16 float path on the same weights: {f_det.valid.sum(1).tolist()}, top "
                 f"scores {det.scores[:, 0].tolist()} vs {f_det.scores[:, 0].tolist()})")
        log(f"{name} request {i}: {ms:.1f} ms, valid detections per image {per_image}")
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    need = ["nms", "roi_align_int8"] + (["fused_block"] if name == "int8-fused" else [])
    if min(launches[k] for k in need) == 0:
        fail(f"{name}: the serving path missed a kernel: {launches}")
    if name == "int8-fused" and launches["fused_block"] != 29 * len(requests):
        fail(f"{name}: {launches['fused_block']} fused blocks over {len(requests)} requests, "
             "want 29 per batch")
    convs = int8_conv_launches(name == "int8-fused")
    if launches["int8_conv"] != convs * len(requests):
        fail(f"{name}: {launches['int8_conv']} int8 convs over {len(requests)} requests, want "
             f"{convs} per batch")
    log(f"{name}: launches over {len(requests)} requests {launches}; peak memory {peak:.2f} GiB")

    images, windows = requests[0]
    x = torch.as_tensor(images, device=device)
    win = torch.as_tensor(windows, device=device)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, acc_events=True) as prof:
        t0 = time.perf_counter()
        infer(frozen, images, windows)
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in events) / 1e3
    if not busy > 0:
        fail(f"{name}: the profiler saw no device time")
    log(f"{name} profiled request: wall {prof_wall:.1f} ms, device busy {busy:.3f} ms "
        f"({100 * busy / prof_wall:.1f}%)")
    for e in sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:TOP]:
        log(f"  {e.self_device_time_total / 1e3:8.3f} ms {e.count:5d}x  {e.key[:80]}")

    # (d) the same frozen weights and batch through the plain versions
    torch.backends.cudnn.deterministic = True
    try:
        with torch.inference_mode():
            k_det = detector.forward_inference(frozen, x, win, cfg)
            before = launch_counts()
            with plain_path():
                p_det = detector.forward_inference(frozen, x, win, cfg)
            torch.cuda.synchronize()
            if launch_counts() != before:
                fail(f"{name}: the plain path launched a kernel")
    finally:
        torch.backends.cudnn.deterministic = False
    if not same_detections(k_det, p_det):
        bad = {f: int((a != b).sum()) for f, a, b in zip(k_det._fields, k_det, p_det)
               if a is not None and not torch.equal(a, b)}
        fail(f"{name}: kernel path and plain path differ: {bad}")
    log(f"{name}: kernel path == plain path on the same frozen weights and batch "
        f"(boxes, class ids, scores, valid, masks identical; {int(k_det.valid.sum())} "
        "detections)")
    return cfg, frozen, params, {"calib_s": cal_s, "busy": busy, "wall": prof_wall,
                                 "peak": peak, "launches": launches}


def iou(a, b) -> float:
    y1, x1 = max(a[0], b[0]), max(a[1], b[1])
    y2, x2 = min(a[2], b[2]), min(a[3], b[3])
    inter = max(y2 - y1, 0.0) * max(x2 - x1, 0.0)
    area = lambda z: (z[2] - z[0]) * (z[3] - z[1])
    union = area(a) + area(b) - inter
    return inter / union if union > 0 else 0.0


def int8_serving(device):
    """7(c)-(f)."""
    import numpy as np
    import torch

    from objectdetection_torch import detector
    from objectdetection_torch.config import COCO_CONFIG
    from objectdetection_torch.quant import QUANT_LEAVES

    rng = np.random.RandomState(3)
    mean = np.asarray(COCO_CONFIG.mean_pixel, np.float32)
    h, w = COCO_CONFIG.image_shape[:2]

    def request():
        images = rng.uniform(0, 255, (BATCH, h, w, 3)).astype(np.float32) - mean
        return images, np.tile(np.array([[0, 0, h, w]], np.float32), (BATCH, 1))

    warm = request()  # also the 2 calibration images
    requests = [request() for _ in range(3)]
    results = {}
    for name in ("int8-default", "int8-fused"):
        results[name] = int8_config(name, device, requests, warm)

    # (e) fused against unfused on the same frozen scales, block by block:
    # each identity block that fuses runs fused on the unfused stream's own
    # input, in f32 compute, where the two differ only in the order of the
    # f32 scale folds (the setting of the stated bound). The chained C2-C5
    # drift (22 fused blocks in a row in stage 4) is printed, not gated.
    cfg, frozen, params, _ = results["int8-fused"]
    x = torch.as_tensor(requests[0][0], device=device)
    worst = block_by_block(cfg.replace(compute_dtype="float32"), frozen, x)
    for stage, (steps, share, n) in sorted(worst.items()):
        log(f"int8-fused f32, stage {stage}: {n} identity blocks fused on the unfused "
            f"stream's inputs: worst {steps} steps, worst share > 1 step {share:.2e}")
        if not (steps <= FUSED_STEPS and share < FUSED_SHARE):
            fail(f"int8-fused stage {stage}: fused vs unfused block {steps} steps, share > 1 "
                 f"{share} (bound {FUSED_STEPS}, {FUSED_SHARE})")
    if sum(n for _, _, n in worst.values()) != 29:
        fail(f"int8-fused: {worst} blocks compared, want 29")
    for dtype in ("float32", "bfloat16"):
        c = cfg.replace(compute_dtype=dtype)
        fused = backbone_codes(c, frozen, x)
        unfused = backbone_codes(c.replace(fused_bottleneck=False), frozen, x)
        for i, ((a, _), (b, _)) in enumerate(zip(fused, unfused)):
            d = (a.int() - b.int()).abs()
            log(f"int8-fused {dtype} chained C{i + 2} vs unfused: max {int(d.max())} steps, "
                f"share > 1 step {float((d > 1).float().mean()):.2e}, share != "
                f"{float((d > 0).float().mean()):.2e} (not gated)")

    # (f) int8 against the bf16 float path on the same weights (printed only)
    for name in ("int8-default", "int8-fused"):
        _, frozen, params, _ = results[name]
        float_params = {k: v for k, v in params.items()
                        if k.rsplit(".", 1)[-1] not in QUANT_LEAVES}
        images, windows = requests[0]
        with torch.inference_mode():
            f_det = detector.make_infer_fn(COCO_CONFIG)(float_params, images, windows)
            q_det = detector.make_infer_fn(results[name][0])(frozen, images, windows)
        nf, nq = int(f_det.valid.sum()), int(q_det.valid.sum())
        top = iou(f_det.boxes[0, 0].tolist(), q_det.boxes[0, 0].tolist())
        log(f"{name} vs bf16 float (same weights): valid {nq} vs {nf}, drift {abs(nf - nq)} "
            f"against max(3, (n_f + n_q)/50) = {max(3, (nf + nq) // 50)}; top-box IoU "
            f"{top:.3f}; class ids of the top box {int(q_det.class_ids[0, 0])} vs "
            f"{int(f_det.class_ids[0, 0])} (not gated: random heads saturate)")
    return {k: v[3] for k, v in results.items()}


# ---------------------------------------------------------------- phase 8


def probe_phase(device):
    """8: the three probe kernels against their plain versions at the TPU
    scripts' sizes, then the probes' entry points with the launch counters
    read around them. Each kernel row sums its cases or variants."""
    import torch

    from objectdetection_torch.probes import patch_dma, roi_dispatch, roi_inner

    blank = lambda: {"ms": 0.0, "plain_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0,
                     "max_abs_err": 0.0, "library_ms": None}
    p1, p2, p3 = blank(), blank(), blank()
    p1["library_ms"] = 0.0
    src = patch_dma.make_source(device=device)
    for n, p in patch_dma.CASES:
        i, y, xq = patch_dma.make_indices(n, p, device=device)
        got = patch_dma.patch_dma(src, i, y, xq, p)
        want = patch_dma.patch_dma_plain(src, i, y, xq, p)
        tol = patch_dma.tolerance(src, i, y, xq)
        err = (got.double() - want.double()).abs()
        if not bool((err <= tol).all()):
            fail(f"patch_dma n={n} p={p}: |kernel - plain| {float(err.max())} beyond "
                 f"n·2^-24·Σ|x| ({float(tol.min())} at least)")
        ms = device_ms(lambda: patch_dma.patch_dma(src, i, y, xq, p), 10)
        plain_ms = time_ms(lambda: patch_dma.patch_dma_plain(src, i, y, xq, p), 3, warmup=1)
        lib_ms = time_ms(lambda: patch_dma.library_call(src, i, y, xq, p), 3, warmup=1)
        b_ms = patch_dma.patch_bytes(n, p, src.shape[-1]) / PEAK_BYTES * 1e3
        p1["ms"] += ms
        p1["plain_ms"] += plain_ms
        p1["library_ms"] += lib_ms
        p1["bytes_ms"] += b_ms
        p1["ops_ms"] += n * src.shape[-1] / PEAK_F32 * 1e3
        p1["max_abs_err"] = max(p1["max_abs_err"], float(err.max()))
        log(f"patch_dma rois={n} patch={p}: |kernel - plain| {float(err.max()):.3g} within "
            f"n·2^-24·Σ|x|; kernel {ms:.4f} ms device ({n * p * p * 512 / ms / 1e6:.1f} GB/s of "
            f"patches), plain {plain_ms:.3f} ms, library gather {lib_ms:.3f} ms; bound "
            f"{b_ms:.4f} ms")
    del src
    cases = ((roi_inner, p2, roi_inner.VARIANTS, lambda v: roi_inner.make_inputs(device=device),
              roi_inner.roi_inner, roi_inner.roi_inner_plain),
             (roi_dispatch, p3, roi_dispatch.VARIANTS,
              lambda v: roi_dispatch.make_inputs(v, device=device), roi_dispatch.roi_dispatch,
              roi_dispatch.roi_dispatch_plain))
    times = {}  # (probe, variant): device ms
    for mod, rec, variants, inputs, kernel, plain in cases:
        args = None
        for v in variants:
            if args is None or mod is roi_dispatch:
                args = inputs(v)
            got = kernel(*args, v)
            want = plain(*args, v)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                bad = int((got != want).sum())
                fail(f"{mod.__name__} {v}: kernel not bit-equal to plain ({bad} values)")
            del got, want
            ms = device_ms(lambda: kernel(*args, v), 5)
            plain_ms = time_ms(lambda: plain(*args, v), 1, warmup=0)
            n = args[0].shape[0]
            if mod is roi_dispatch:
                byt, f32_ops, mm_ops = mod.work(n, v, args[-1].numel())
            else:
                byt, f32_ops, mm_ops = mod.work(n, v)
            b_ms = byt / PEAK_BYTES * 1e3
            o_ms = (f32_ops / PEAK_F32 + mm_ops / PEAK_BF16) * 1e3
            times[mod.__name__.rsplit(".", 1)[-1], v] = ms
            rec["ms"] += ms
            rec["plain_ms"] += plain_ms
            rec["bytes_ms"] += b_ms
            rec["ops_ms"] += o_ms
            log(f"{mod.__name__.rsplit('.', 1)[-1]} {v} n={n}: kernel == plain; kernel {ms:.4f} ms "
                f"device ({1000 * ms / n:.4f} us/ROI), plain {plain_ms:.1f} ms; bound "
                f"{max(b_ms, o_ms):.4f} ms (bytes {b_ms:.4f}, operations {o_ms:.4f})")
        del args

    # P3 on ROIs that cycle through the top class and every (level, class)
    # pair, copies of one class in flight during another's ROI (not in the row)
    args = roi_dispatch.make_mixed_inputs(9600, device)
    got = roi_dispatch.roi_dispatch(*args, "dispatch")
    want = roi_dispatch.roi_dispatch_plain(*args, "dispatch")
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        fail(f"roi_dispatch mixed: kernel not bit-equal to plain ({int((got != want).sum())} "
             "values)")
    ms = device_ms(lambda: roi_dispatch.roi_dispatch(*args, "dispatch"), 5)
    log(f"roi_dispatch mixed n=9600 (11 kinds): kernel == plain; kernel {ms:.4f} ms device "
        f"({1000 * ms / 9600:.4f} us/ROI)")
    del args, got, want
    # the probe's own attribution (roi_dispatch_probe.py:1-21), us a ROI
    us = {k: 1000.0 * t / 96000 for k, t in times.items()}
    log(f"P3 attribution, us/ROI: bare {us['roi_dispatch', 'bare']:.4f} against P2 wide2c "
        f"{us['roi_inner', 'wide2c']:.4f}; dispatch - bare "
        f"{us['roi_dispatch', 'dispatch'] - us['roi_dispatch', 'bare']:+.4f}; dispatch_small - "
        f"dispatch {us['roi_dispatch', 'dispatch_small'] - us['roi_dispatch', 'dispatch']:+.4f}")

    # the entry points, as a user runs them, with the counters read around them
    patch_dma.launches = roi_inner.launches = roi_dispatch.launches = 0
    patch_dma.main(["--iters", "2"])
    for v in roi_inner.VARIANTS:
        roi_inner.main(["--variant", v, "--iters", "2"])
    for v in roi_dispatch.VARIANTS:
        roi_dispatch.main(["--variant", v, "--iters", "2"])
    launches = {"patch_dma_probe": patch_dma.launches, "roi_inner_probe": roi_inner.launches,
                "roi_dispatch_probe": roi_dispatch.launches}
    if min(launches.values()) == 0:
        fail(f"probe entry points missed a kernel: {launches}")
    log(f"probe entry points: launches {launches}")
    return {"patch_dma_probe": p1, "roi_inner_probe": p2, "roi_dispatch_probe": p3}, launches


# ---------------------------------------------------------------- phase 9

# phase 9's source images (H, W): a landscape photo size, one larger than the
# 1024² canvas in both sides, one small and odd
SERVE_SHAPES = ((480, 640), (1200, 900), (333, 500))


def smooth_image(h: int, w: int):
    """The smooth test image of tests/test_preprocess.py: on it the host and
    device resamplers agree to the interior gap their test states."""
    import numpy as np

    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    return np.stack([yy * 2, xx * 1.5, 100 + 50 * np.sin(yy / 9) * np.cos(xx / 11)], -1)


def decode_and_mold(device):
    """9(a): the port's PNG and PPM encoders and decoders bit-exact on three
    seeded images, the PNG (rows filtered as libpng filters them) through
    both row unfilters, numpy and the C one; the device mold on the card against the CPU's (within
    1e-3); host against device mold on smooth images (scale within 1e-5,
    window within 1 px, mean interior gap under 6)."""
    import numpy as np
    import torch

    from objectdetection_torch.config import COCO_CONFIG as cfg
    from objectdetection_torch.data import image_io
    from objectdetection_torch.data.preprocess import mold_batch_device, mold_image_host

    rng = np.random.RandomState(9)
    images = [rng.randint(0, 256, (h, w, 3)).astype(np.uint8) for h, w in SERVE_SHAPES]
    pngs = []
    for img in images:
        # PNG rows filtered as libpng filters them (encode_png's
        # default): Average and Paeth rows take the row unfilter's slow path
        png = image_io.encode_png(img)
        kinds = np.bincount(image_io.png_row_filters(png), minlength=5).tolist()
        for what, buf, native in (("png, numpy unfilter", png, False),
                                  ("png, C unfilter", png, True),
                                  ("ppm", image_io.encode_ppm(img), False)):
            t0 = time.perf_counter()
            back = image_io.decode_image(buf, native=native)
            ms = (time.perf_counter() - t0) * 1e3
            if back.shape != img.shape or not np.array_equal(back, img):
                fail(f"serving: {what} decode is not bit-exact at {img.shape}")
            log(f"serving: {what} {img.shape[0]}x{img.shape[1]}, {len(buf)} bytes"
                f"{f', rows by filter 0-4 {kinds}' if buf is png else ''}: decoded bit-exact "
                f"in {ms:.1f} ms (host)")
        pngs.append(png)
    hc = max(h for h, _ in SERVE_SHAPES)
    wc = max(w for _, w in SERVE_SHAPES)
    shapes = torch.tensor(SERVE_SHAPES, dtype=torch.int32)
    for name, make in (("random", lambda i, h, w: images[i]),
                       ("smooth", lambda i, h, w: smooth_image(h, w))):
        canvas = torch.zeros(len(SERVE_SHAPES), hc, wc, 3)
        for i, (h, w) in enumerate(SERVE_SHAPES):
            canvas[i, :h, :w] = torch.from_numpy(np.asarray(make(i, h, w), np.float32))
        cpu, cmeta = mold_batch_device(canvas, shapes, cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dev, dmeta = mold_batch_device(canvas.to(device), shapes.to(device), cfg)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        err = float((dev.cpu() - cpu).abs().max())
        if not (torch.equal(dmeta.window.cpu(), cmeta.window) and err <= 1e-3):
            fail(f"serving: device mold on the card vs CPU ({name}): windows "
                 f"{dmeta.window.tolist()} vs {cmeta.window.tolist()}, max |err| {err:.3g}")
        log(f"serving: device mold ({name}) of {len(SERVE_SHAPES)} canvases {hc}x{wc} → "
            f"{cfg.image_max_dim}², card vs CPU max |err| {err:.3g} (≤ 1e-3), {ms:.1f} ms")
        if name != "smooth":
            continue
        for i, (h, w) in enumerate(SERVE_SHAPES):
            hm, hw, hs = mold_image_host(smooth_image(h, w), cfg)
            dm, dw = dev[i].cpu().numpy(), dmeta.window[i].cpu().numpy()
            y1, x1, y2, x2 = hw
            gap = float(np.abs(dm[y1 + 2:y2 - 2, x1 + 2:x2 - 2]
                               - hm[y1 + 2:y2 - 2, x1 + 2:x2 - 2]).mean())
            ds = float(dmeta.scale[i])
            if abs(ds - hs) >= 1e-5 or np.abs(dw - hw).max() > 1.0 or not gap < 6.0:
                fail(f"serving: host vs device mold at {h}x{w}: scale {hs} / {ds}, window "
                     f"{hw.tolist()} / {dw.tolist()}, mean interior gap {gap:.3f}")
            log(f"serving: host vs device mold at {h}x{w}: scale {hs:.6f}, window "
                f"{hw.tolist()} / {dw.tolist()}, mean interior gap {gap:.3f} (< 6)")
    return images, pngs


def answers(server, image, names):
    """The detections a server must answer for ``image``: its infer_fn and
    unmold_detections called directly on its own state dict."""
    import numpy as np
    import torch

    from objectdetection_torch.data.preprocess import mold_image_host, unmold_detections

    cfg = server.config
    molded, window, _ = mold_image_host(image, cfg)
    det = server.infer_fn(server.variables, molded[None], window[None].astype(np.float32))
    rows = torch.cat([det.boxes[0], det.class_ids[0][:, None].float(), det.scores[0][:, None]], 1)
    b, c, s, v = (t.cpu().numpy() for t in unmold_detections(
        rows, window.astype(np.float32), cfg.image_shape[:2], torch.tensor(image.shape[:2])))
    if not np.isfinite(s).all():
        fail("serving: direct call gave non-finite scores")
    return [{"box_yxyx": [int(x) for x in b[i]], "class_id": int(c[i]),
             "class_name": names[int(c[i])], "score": round(float(s[i]), 4)}
            for i in np.where(v)[0]]


def drive_server(server, name, images, pngs, card, concurrent: bool):
    """Requests to a started server: /healthz, each image in turn, and with
    ``concurrent`` two at once from two threads; every answer against the
    direct call. Returns (launches, server latency ms, client wall ms)."""
    import threading
    import urllib.request

    import torch

    from objectdetection_torch.data.coco import COCO_CLASS_NAMES

    url = f"http://127.0.0.1:{server.server_address[1]}"
    with urllib.request.urlopen(f"{url}/healthz", timeout=60) as r:
        if json.loads(r.read()) != {"status": "ok"}:
            fail(f"serving ({name}): /healthz")

    def post(body):
        t0 = time.perf_counter()
        req = urllib.request.Request(f"{url}/detect", data=body, method="POST")
        with urllib.request.urlopen(req, timeout=300) as r:
            out = json.loads(r.read())
        return out, (time.perf_counter() - t0) * 1e3

    reset_launch_counts()
    got, lat, wall = [], [], []
    for body in pngs:
        out, ms = post(body)
        got.append(out["detections"])
        lat.append(out["latency_ms"])
        wall.append(ms)
    pair = {}
    if concurrent:
        go = threading.Barrier(2)

        def client(i):
            go.wait()
            try:
                pair[i] = post(pngs[i])
            except Exception as exc:  # reported by the check below
                pair[i] = exc

        threads = [threading.Thread(target=client, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for i in range(2):
            if isinstance(pair[i], Exception):
                fail(f"serving ({name}): concurrent request {i} failed: {pair[i]!r}")
    launches = launch_counts()
    for i, image in enumerate(images):
        want = answers(server, image, COCO_CLASS_NAMES)
        if got[i] != want:
            fail(f"serving ({name}) request {i}: the server's {len(got[i])} detections differ "
                 f"from the direct call's {len(want)}")
        if i in pair and pair[i][0]["detections"] != want:
            fail(f"serving ({name}): concurrent request {i} differs from the direct call")
    n = [len(g) for g in got]
    if sum(n) == 0:
        fail(f"serving ({name}): no request had a detection")
    for i, (h, w) in enumerate(SERVE_SHAPES):
        log(f"serving ({name}) request {i} ({h}x{w} PNG): {n[i]} detections == direct call; "
            f"server latency_ms {lat[i]}, client wall {wall[i]:.1f} ms [{card}]")
    for i in sorted(pair):
        log(f"serving ({name}) concurrent request {i}: == direct call; server latency_ms "
            f"{pair[i][0]['latency_ms']}, client wall {pair[i][1]:.1f} ms [{card}]")
    return launches, lat, wall


def serving_phase(device, card):
    """9: the serving entry points at COCO_CONFIG R101 1024²: (a) decode and
    mold; (b) the float server (seeded init weights cast to bf16 once,
    warmed up) answering /healthz, three requests in turn and two at once,
    each equal to the direct call on the same cast state dict; (c) the
    ``quantize`` command's artifact served, equal to the frozen state dict
    still in memory; (d) ``infer`` with masks on one PNG, its drawing read
    back and the masks pasted at the image's size; (e) the launch counters
    around (b)-(d): NMS twice a request, the box-stage ROIAlign once, the
    mask stage in (d) only."""
    import tempfile

    import numpy as np
    import torch

    from objectdetection_torch import cli, serve
    from objectdetection_torch.config import COCO_CONFIG
    from objectdetection_torch.data.image_io import decode_image
    from objectdetection_torch.data.masks import paste_detection_masks

    images, pngs = decode_and_mold(device)
    requests = len(pngs)
    servers = []
    try:
        # (b) the float server
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        server = serve.serve(config=COCO_CONFIG, port=0, block=False)
        start_s = time.perf_counter() - t0
        servers.append(server)
        threading_start(server)
        dtypes = sorted({str(v.dtype) for v in server.variables.values()})
        log(f"serving (float): started in {start_s:.2f} s (init, cast to {dtypes}, warm-up "
            f"{server.warmup_seconds:.2f} s) [{card}]")
        launches, _, _ = drive_server(server, "float", images, pngs, card, concurrent=True)
        want = {"nms": 2 * (requests + 2), "roi_align": requests + 2, "roi_align_int8": 0}
        check_launches("float", launches, want)
        tagged_requests(server, images[2], card)
        log(f"serving (float): peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
            f"[{card}]")
        stop(servers)

        with tempfile.TemporaryDirectory() as tmp:
            # (c) the int8 artifact, made by the quantize command
            art = f"{tmp}/int8"
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            frozen = cli.main(["quantize", "--out", art, "--config", "coco", "--calib-images",
                               "2", "--batch-size", "1", "--percentile", "90"])
            quant_s = time.perf_counter() - t0
            server = serve.serve(config=COCO_CONFIG, port=0, block=False, quantized=art)
            servers.append(server)
            threading_start(server)
            same = set(frozen) == set(server.variables) and all(
                torch.equal(frozen[k], server.variables[k]) for k in frozen)
            if not same or not server.config.per_channel_acts:
                fail("serving (int8): the loaded artifact differs from the frozen state dict")
            log(f"serving (int8): quantize (2 images, batch 1, percentile 90) and save "
                f"{quant_s:.2f} s; artifact loaded equal to the frozen state dict; warm-up "
                f"{server.warmup_seconds:.2f} s [{card}]")
            server.variables = frozen  # the direct calls use the state still in memory
            launches, _, _ = drive_server(server, "int8", images, pngs, card, concurrent=False)
            check_launches("int8", launches, {"nms": 2 * requests, "roi_align": 0,
                                              "roi_align_int8": requests})
            log(f"serving (int8): peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
                f"GiB [{card}]")
            stop(servers)

            # (d) infer with masks on one PNG
            path = f"{tmp}/photo.png"
            with open(path, "wb") as f:
                f.write(pngs[0])
            reset_launch_counts()
            t0 = time.perf_counter()
            (res,) = cli.main(["infer", path])
            infer_s = time.perf_counter() - t0
            check_launches("infer", launch_counts(), {"nms": 2, "roi_align": 2,
                                                      "roi_align_int8": 0})
            with open(res["out"], "rb") as f:
                drawn = decode_image(f.read())
            if drawn.shape != images[0].shape:
                fail(f"serving (infer): {res['out']} decodes at {drawn.shape}")
            n = len(res["boxes"])
            pasted = paste_detection_masks(res["masks"], res["boxes"], images[0].shape[:2])
            if pasted.shape != (n, *images[0].shape[:2]) or (n and not pasted.any()):
                fail(f"serving (infer): pasted masks {pasted.shape}, any {bool(pasted.any())}")
            if not np.isfinite(res["masks"]).all() or n == 0:
                fail(f"serving (infer): {n} detections, masks finite "
                     f"{bool(np.isfinite(res['masks']).all())}")
            log(f"serving (infer): {n} detections with masks in {infer_s:.2f} s (init, one "
                f"f32-weight call, drawing, PNG); {res['out'].rsplit('/', 1)[-1]} decodes at "
                f"{drawn.shape}; pasted masks {pasted.shape}, {int(pasted.sum())} pixels "
                f"[{card}]")
    finally:
        stop(servers)


def threading_start(server):
    import threading

    threading.Thread(target=server.serve_forever, daemon=True).start()


def stop(servers):
    while servers:
        server = servers.pop()
        server.shutdown()
        server.server_close()
        server.worker.shutdown()


def check_launches(name, launches, want):
    got = {k: launches[k] for k in want}
    if got != want:
        fail(f"serving ({name}): kernel launches {got}, want {want}")
    log(f"serving ({name}): launches {got} (NMS twice a request, ROIAlign once a stage)")



# ---------------------------------------------------------------- phase 10

# 10(c)'s mini COCO: image sizes (H, W), as photos come, and the ones phase 9
# serves
COCO_SHAPES = ((480, 640), (1200, 900), (333, 500), (640, 427), (800, 800), (1024, 768))
SHAPES_STEPS, SHAPES_RESUMED, COCO_STEPS = 20, 25, 3


def busy_ms(prof) -> float:
    import torch

    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3


def profiled_loop(cli, profiles):
    """``cli._train_loop`` under the profiler, started after the device has
    finished the command's set-up (init, checkpoint load), so that the
    profile holds the loop's device work alone (the loop's ``seconds``
    window)."""
    import torch

    real = cli._train_loop

    def loop(*args, **kwargs):
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts, acc_events=True) as prof:
            out = real(*args, **kwargs)
        profiles.append(prof)
        return out

    return loop


def after_first_ms(record, steps):
    """ms a step over the steps after the first, evaluations left out (the
    loop waits for the device after its first step and before each
    evaluation)."""
    return (record["seconds"] - record["first_seconds"] - record["eval_seconds"]) * 1e3 / (
        steps - 1)


def check_train_record(name, record, steps):
    import numpy as np

    if len(record["metrics"]) != steps:
        fail(f"{name}: {len(record['metrics'])} steps recorded, want {steps}")
    for i, m in enumerate(record["metrics"]):
        bad = [k for k, v in m.items() if not np.isfinite(v)]
        if bad:
            fail(f"{name} step {record['first_step'] + i}: not finite: {bad}")


def shapes_training(device, card, tmp):
    """10(a): ``cli train`` at SHAPES_CONFIG (R50 128², bf16), batch 8 with
    masks, evaluated every 10 steps on 16 held-out images with mask mAP, the
    checkpoint saved; the launch counters read around it; then ``--resume``
    to step 25 under the profiler. Returns the checkpoint directory."""
    import numpy as np
    import torch

    from objectdetection_torch import cli

    ckpt = f"{tmp}/shapes_ckpt"
    argv = ["train", "--steps", str(SHAPES_STEPS), "--batch", "8", "--masks", "--eval-every",
            str(SHAPES_STEPS // 2), "--eval-images", "16", "--eval-masks", "--ckpt", ckpt]
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    state, record = cli.main(argv)
    wall = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    check_train_record("shapes train", record, SHAPES_STEPS)
    evals = len(record["evals"])
    # a step: the proposal layer's NMS, one anchor match, ROIAlign and its
    # gradient at the box and mask stages; an evaluation batch of 8: NMS
    # twice (proposals, detections), ROIAlign at both stages
    eval_batches = evals * 2
    want = {"nms": SHAPES_STEPS + 2 * eval_batches, "anchor_match": SHAPES_STEPS,
            "roi_align": 2 * SHAPES_STEPS + 2 * eval_batches,
            "roi_align_backward": 2 * SHAPES_STEPS}
    got = {k: launches[k] for k in want}
    if evals != 2 or got != want or state.step != SHAPES_STEPS:
        fail(f"shapes train: {evals} evaluations, step {state.step}, launches {got}, want {want}")
    train_s = record["seconds"] - record["eval_seconds"]
    log(f"shapes train: `{' '.join(argv[:-1])} D`: {SHAPES_STEPS} steps in {train_s:.2f} s "
        f"({after_first_ms(record, SHAPES_STEPS):.1f} ms a step after the first, which took "
        f"{record['first_seconds'] * 1e3:.1f}), 2 evaluations "
        f"{record['eval_seconds']:.2f} s, command wall {wall:.2f} s; loader "
        f"{np.mean(record['loader_ms']):.2f} ms a batch of 8 on the prefetch thread (max "
        f"{np.max(record['loader_ms']):.2f}), the loop waited {np.mean(record['wait_ms'][1:]):.3f}"
        f" ms a batch after the first ({record['wait_ms'][0]:.1f}); peak memory {peak:.2f} GiB; "
        f"launches {got} [{card}]")
    for step, res in record["evals"]:
        log(f"shapes train: eval after step {step}: box mAP@0.5 {res['mAP']:.4f}, mask mAP@0.5 "
            f"{res['mask_mAP']:.4f} [{card}]")
    first, last = record["metrics"][0], record["metrics"][-1]
    log(f"shapes train: total_loss step 0 {first['total_loss']:.4f}, step {SHAPES_STEPS - 1} "
        f"{last['total_loss']:.4f}")

    # resumed to step 25, the training loop alone profiled: its busy share
    profiles = []
    real = cli._train_loop
    cli._train_loop = profiled_loop(cli, profiles)
    try:
        state, rec = cli.main(["train", "--steps", str(SHAPES_RESUMED), "--batch", "8",
                               "--masks", "--resume", ckpt, "--log-every", "100"])
    finally:
        cli._train_loop = real
    check_train_record("shapes resume", rec, SHAPES_RESUMED - SHAPES_STEPS)
    if rec["first_step"] != SHAPES_STEPS or state.step != SHAPES_RESUMED:
        fail(f"shapes resume: started at {rec['first_step']}, ended at {state.step}")
    busy = busy_ms(profiles[0])
    if not busy > 0:
        fail("shapes resume: the profiler saw no device time")
    steps = SHAPES_RESUMED - SHAPES_STEPS
    log(f"shapes train --resume D --steps {SHAPES_RESUMED}: started at step "
        f"{rec['first_step']}; {steps} profiled steps in {rec['seconds'] * 1e3:.1f} ms "
        f"({rec['seconds'] * 1e3 / steps:.1f} ms a step; after the first "
        f"{after_first_ms(rec, steps):.1f}), device busy in the loop {busy:.1f} ms "
        f"({100 * busy / (rec['seconds'] * 1e3):.1f}% of the loop's wall); loader "
        f"{np.mean(rec['loader_ms']):.2f} ms a batch [{card}]")
    return ckpt


def demo_and_quantize(device, card, tmp, ckpt):
    """10(b): ``cli demo`` writes PNGs that decode at 128×128; ``cli quantize
    --config shapes --ckpt D --calib-images 16`` writes an artifact, which a
    server answers on two shapes images (detection threshold 0) identically
    to the frozen state dict in memory."""
    import urllib.request

    import torch

    from objectdetection_torch import cli, serve
    from objectdetection_torch.config import SHAPES_CONFIG
    from objectdetection_torch.data.coco import COCO_CLASS_NAMES
    from objectdetection_torch.data.image_io import decode_image, encode_png
    from objectdetection_torch.data.shapes import ShapesDataset

    t0 = time.perf_counter()
    res = cli.main(["demo", "--out-prefix", f"{tmp}/demo_"])
    demo_s = time.perf_counter() - t0
    for r in res:
        with open(r["out"], "rb") as f:
            shape = decode_image(f.read()).shape
        if shape != (128, 128, 3):
            fail(f"demo: {r['out']} decodes at {shape}")
    log(f"demo: {len(res)} PNGs decode at 128x128, {[len(r['scores']) for r in res]} "
        f"detections, {demo_s:.2f} s [{card}]")

    art = f"{tmp}/shapes_int8"
    reset_launch_counts()
    t0 = time.perf_counter()
    frozen = cli.main(["quantize", "--out", art, "--config", "shapes", "--ckpt", ckpt,
                       "--calib-images", "16"])
    quant_s = time.perf_counter() - t0
    server = serve.serve(config=SHAPES_CONFIG.replace(detection_min_threshold=0.0), port=0,
                         block=False, quantized=art)
    servers = [server]
    try:
        threading_start(server)
        same = set(frozen) == set(server.variables) and all(
            torch.equal(frozen[k], server.variables[k]) for k in frozen)
        if not same:
            fail("shapes quantize: the loaded artifact differs from the frozen state dict")
        server.variables = frozen
        url = f"http://127.0.0.1:{server.server_address[1]}/detect"
        ds = ShapesDataset(2, 128, 128, seed=77)
        counts = []
        for i in range(2):
            image = ds.image(i)
            req = urllib.request.Request(url, data=encode_png(image), method="POST")
            with urllib.request.urlopen(req, timeout=300) as r:
                got = json.loads(r.read())["detections"]
            if got != answers(server, image, COCO_CLASS_NAMES):
                fail(f"shapes quantize: request {i} differs from the frozen state dict's answer")
            counts.append(len(got))
        if not sum(counts):
            fail("shapes quantize: no detection at threshold 0")
    finally:
        stop(servers)
    log(f"shapes quantize: --ckpt D, 16 shapes images, batch 4, percentile 90: {quant_s:.2f} s; "
        f"the artifact served 2 shapes PNGs with {counts} detections == the frozen state dict "
        f"[{card}]")


def write_mini_coco(root):
    """10(c): six seeded PNG photos of COCO_SHAPES with 2-5 boxes each (one
    image also a crowd region), in the instances_*.json layout."""
    import numpy as np

    from objectdetection_torch.data.image_io import encode_png

    rng = np.random.RandomState(10)
    images, anns = [], []
    for i, (h, w) in enumerate(COCO_SHAPES):
        img = smooth_image(h, w)
        boxes = []
        for _ in range(rng.randint(2, 6)):
            bh, bw = rng.uniform(0.1, 0.5) * h, rng.uniform(0.1, 0.5) * w
            y, x = rng.uniform(0, h - bh), rng.uniform(0, w - bw)
            img[int(y):int(y + bh), int(x):int(x + bw)] = rng.randint(0, 256, 3)
            boxes.append([x, y, bw, bh])
        with open(f"{root}/{i}.png", "wb") as f:
            f.write(encode_png(np.clip(img, 0, 255).astype(np.uint8)))
        images.append(dict(id=i + 1, file_name=f"{i}.png", height=h, width=w))
        for b in boxes:
            anns.append(dict(id=len(anns) + 1, image_id=i + 1, iscrowd=0,
                             category_id=int(rng.choice([1, 3, 18, 62])), bbox=b))
    anns.append(dict(id=len(anns) + 1, image_id=2, iscrowd=1, category_id=1,
                     bbox=[10.0, 10.0, 300.0, 200.0]))
    cats = [dict(id=c, name=n) for c, n in ((1, "person"), (3, "car"), (18, "dog"),
                                            (62, "chair"))]
    path = f"{root}/instances.json"
    with open(path, "w") as f:
        json.dump(dict(images=images, annotations=anns, categories=cats), f)
    return path, sum(not a["iscrowd"] for a in anns)


def repeat_coco(path, times):
    """The annotation file ``path`` with its images listed ``times`` times
    (new ids, the same files and boxes): an evaluation of several full
    batches from the same photos."""
    with open(path) as f:
        data = json.load(f)
    n = max(im["id"] for im in data["images"])
    images = [dict(im, id=im["id"] + k * n) for k in range(times) for im in data["images"]]
    anns = [dict(a, id=i + 1, image_id=a["image_id"] + k * n)
            for i, (k, a) in enumerate((k, a) for k in range(times)
                                       for a in data["annotations"])]
    out = path.replace(".json", f"_x{times}.json")
    with open(out, "w") as f:
        json.dump(dict(data, images=images, annotations=anns), f)
    return out, len(images)


def coco_training(device, card, ann, img_dir):
    """10(c): ``cli train-coco --steps 3 --batch 8 --ckpt C`` at COCO_CONFIG
    (R101 1024², bf16), boxes only; the launch counters read around it."""
    import numpy as np
    import torch

    from objectdetection_torch import cli

    ckpt = f"{img_dir}/coco_ckpt"
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    state, record = cli.main(["train-coco", ann, img_dir, "--steps", str(COCO_STEPS), "--batch",
                              "8", "--ckpt", ckpt, "--log-every", "1"])
    wall = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    check_train_record("coco train", record, COCO_STEPS)
    want = {"nms": COCO_STEPS, "anchor_match": COCO_STEPS, "roi_align": COCO_STEPS,
            "roi_align_backward": COCO_STEPS}
    got = {k: launches[k] for k in want}
    if got != want or state.step != COCO_STEPS:
        fail(f"coco train: step {state.step}, launches {got}, want {want}")
    log(f"coco train: `train-coco --steps {COCO_STEPS} --batch 8` (R101 1024² bf16, boxes "
        f"only): {after_first_ms(record, COCO_STEPS):.1f} ms a step after the first, which "
        f"took {record['first_seconds'] * 1e3:.1f}; command wall {wall:.2f} s; loader "
        f"{np.mean(record['loader_ms']):.1f} ms a batch of 8 (decode + host mold), the loop "
        f"waited {np.mean(record['wait_ms'][1:]):.1f} ms a batch after the first "
        f"({record['wait_ms'][0]:.1f}); "
        f"peak memory {peak:.2f} GiB; launches {got}; total_loss "
        f"{[round(m['total_loss'], 4) for m in record['metrics']]} [{card}]")


def coco_evaluation(device, card, ann, img_dir):
    """10(d): ``cli eval-coco`` on the mini COCO: what it hands the evaluator
    equals ``make_infer_fn`` + ``unmold_detections_np`` called directly on
    the same padded batch (integer boxes and class ids identical, scores to
    4 decimals); NMS twice a batch, the box-stage ROIAlign once. Then warm:
    ``eval-coco`` again on the six photos listed four times (three full
    batches of 8), for its images per second."""
    import numpy as np
    import torch

    from objectdetection_torch import cli, coco_eval, detector
    from objectdetection_torch.config import COCO_CONFIG as cfg
    from objectdetection_torch.convert import init_params
    from objectdetection_torch.data.coco import CocoDataset, eval_batch
    from objectdetection_torch.data.preprocess import unmold_detections_np

    rows = []
    base = coco_eval.DetectionEvaluator

    class Recording(base):
        def add_image(self, pred_boxes, pred_classes, pred_scores, *a, **kw):
            rows.append((np.asarray(pred_boxes), np.asarray(pred_classes),
                         np.asarray(pred_scores)))
            return super().add_image(pred_boxes, pred_classes, pred_scores, *a, **kw)

    coco_eval.DetectionEvaluator = Recording
    try:
        reset_launch_counts()
        results, ips = cli.main(["eval-coco", ann, img_dir])
        launches = launch_counts()
    finally:
        coco_eval.DetectionEvaluator = base
    want = {"nms": 2, "roi_align": 1, "roi_align_backward": 0}
    got = {k: launches[k] for k in want}
    if got != want:
        fail(f"coco eval: launches {got}, want {want} (one padded batch of 8)")
    ds = CocoDataset(ann, img_dir, native_decode=device.type == "cuda")
    images, windows, shapes = eval_batch(ds, ds.image_ids, cfg)
    pad = 8 - len(ds.image_ids)
    images = np.pad(images, ((0, pad), (0, 0), (0, 0), (0, 0)))
    windows = np.pad(windows, ((0, pad), (0, 0)), constant_values=1)
    shapes = np.pad(shapes, ((0, pad), (0, 0)), constant_values=1)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    det = detector.make_infer_fn(cfg, with_masks=False)(params, images, windows)
    boxes, cls = det.boxes.float().cpu().numpy(), det.class_ids.cpu().numpy()
    scores = det.scores.float().cpu().numpy()
    counts = []
    for i in range(len(ds.image_ids)):
        row = np.concatenate([boxes[i], cls[i][:, None].astype(np.float32), scores[i][:, None]],
                             1)
        b, c, s, v = unmold_detections_np(row, windows[i], cfg.image_shape[:2], shapes[i])
        gb, gc, gs = rows[i]
        if not (np.array_equal(gb, b[v]) and np.array_equal(gc, c[v])
                and np.array_equal(np.round(gs, 4), np.round(s[v], 4))):
            fail(f"coco eval: image {i}: the evaluator got {len(gb)} detections, the direct "
                 f"call gives {int(v.sum())}, or they differ")
        counts.append(len(gb))
    if not sum(counts) or not np.isfinite(results["mAP"]) or len(rows) != len(counts):
        fail(f"coco eval: detections {counts}, mAP {results['mAP']}")
    log(f"coco eval: `eval-coco` on {len(counts)} images (one batch of 8, padded): detections "
        f"{counts} == make_infer_fn + unmold_detections_np; mAP {results['mAP']:.4f}; "
        f"{ips:.2f} img/s of inference (cold: the first call at batch 8); launches {got} "
        f"[{card}]")
    ann4, n4 = repeat_coco(ann, 4)
    first = list(rows)
    rows.clear()
    coco_eval.DetectionEvaluator = Recording
    try:
        reset_launch_counts()
        results4, ips4 = cli.main(["eval-coco", ann4, img_dir])
        launches = launch_counts()
    finally:
        coco_eval.DetectionEvaluator = base
    want = {"nms": 2 * n4 // 8, "roi_align": n4 // 8, "roi_align_backward": 0}
    got = {k: launches[k] for k in want}
    same = len(rows) == n4 and all(
        np.array_equal(r[0], f[0]) and np.array_equal(r[1], f[1])
        and np.array_equal(np.round(r[2], 4), np.round(f[2], 4))
        for r, f in zip(rows, first * 4))
    if got != want or not same or not np.isfinite(results4["mAP"]):
        fail(f"coco eval warm: launches {got}, want {want}; {len(rows)} images, each the same "
             f"detections as in the first call: {same}; mAP {results4['mAP']}")
    log(f"coco eval: warm `eval-coco` on {n4} images (the six listed 4 times, {n4 // 8} full "
        f"batches of 8, each image's detections those of the first call): {ips4:.2f} img/s "
        f"of inference; launches {got} [{card}]")


def bias_correction(device, card):
    """10(e): int8 bias correction at SHAPES_CONFIG (f32 compute: cuDNN's and
    the CPU's bf16 convs round differently) on 8 shapes images: calibrated
    on the card, then the input means recorded and the biases corrected on
    the card and on the CPU from the same calibrated state; the corrected
    biases agree within 1e-4 of each bias tensor's largest magnitude."""
    import torch

    from objectdetection_torch import cli, quant
    from objectdetection_torch.config import SHAPES_CONFIG
    from objectdetection_torch.convert import init_params
    from objectdetection_torch.data.shapes import ShapesDataset

    cfg = cli.quantize_config(SHAPES_CONFIG.replace(compute_dtype="float32"))
    images = ShapesDataset(8, 128, 128, seed=5).load_batch(list(range(8)), cfg).images
    params = init_params(cfg, torch.Generator().manual_seed(0))
    t0 = time.perf_counter()
    cal = quant.calibrate_variables(params, images, cfg, batch_size=4, percentile=90.0)
    frozen = quant.freeze_weights(cal)
    means = quant.record_act_means(cal, images, cfg, batch_size=4)
    card_out = quant.apply_bias_correction(frozen, cal, means)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    cpu = lambda sd: {k: v.cpu() for k, v in sd.items()}
    t0 = time.perf_counter()
    cpu_means = quant.record_act_means(cpu(cal), images, cfg, batch_size=4, device="cpu")
    cpu_out = quant.apply_bias_correction(cpu(frozen), cpu(cal), cpu_means)
    cpu_s = time.perf_counter() - t0
    worst, moved = 0.0, 0
    for k, v in cpu_out.items():
        if not k.endswith(".bias") or f"{k[:-4]}kernel_scale" not in cpu_out:
            if not torch.equal(card_out[k].cpu(), v):
                fail(f"bias correction: {k} differs between the card and the CPU")
            continue
        err = float((card_out[k].cpu() - v).abs().max()) / (float(v.abs().max()) + 1e-30)
        worst = max(worst, err)
        moved += int(not torch.equal(v, frozen[k].cpu()))
    if not worst <= 1e-4 or moved < 50:
        fail(f"bias correction: card vs CPU {worst:.3g} of the largest bias, {moved} corrected")
    log(f"bias correction (SHAPES_CONFIG f32, 8 images, 2 chunks): {len(means)} input means, "
        f"{moved} biases corrected; card vs CPU within {worst:.3g} of each bias's largest "
        f"(<= 1e-4); card {card_s:.2f} s (calibrate, freeze, means, correct), CPU {cpu_s:.2f} s "
        f"(means, correct) [{card}]")


def training_phase(device, card):
    """10: the training and evaluation entry points (a)-(e)."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        ckpt = shapes_training(device, card, tmp)
        demo_and_quantize(device, card, tmp, ckpt)
        ann, n_boxes = write_mini_coco(tmp)
        log(f"mini COCO: {len(COCO_SHAPES)} PNGs {COCO_SHAPES}, {n_boxes} boxes and 1 crowd "
            "region")
        coco_training(device, card, ann, tmp)
        coco_evaluation(device, card, ann, tmp)
    bias_correction(device, card)


# ---------------------------------------------------------------- phase 11

FAMILY_STEPS = 3  # training steps of each family in phase 11
# the kernel path's losses against the plain path's (same ops, bit-equal kernels)
LOSS_RTOL = 1e-6


# the wrappers recorded_inputs can record: kind -> (module of ops/, wrapper,
# plain version)
RECORDABLE = {
    "nms": ("nms", "suppress", "suppress_plain"),
    "anchor_match": ("anchor_match", "anchor_match", "anchor_match_plain"),
    "roi_align": ("roi_align", "batched_multilevel_roi_align",
                  "batched_multilevel_roi_align_plain"),
    "fused_block": ("fused_block", "fused_identity_block_int8",
                    "fused_identity_block_int8_plain"),
    "int8_conv": ("int8_conv", "int8_conv_fused", "int8_conv_fused_plain"),
}
# kinds held against their plain version at the call itself (a batch's 125
# convs' inputs and outputs would not fit on the card together): recorded as
# (kind, a description of the shapes, whether kernel == plain)
CHECKED_AT_CALL = ("int8_conv",)


@contextlib.contextmanager
def recorded_inputs(calls, kinds=("nms", "anchor_match"), armed=lambda: True):
    """Launch as usual, and append (kind, args, a copy of the output) of
    every call of the ``kinds``' wrappers made while ``armed()``; args are
    positional, defaults filled in. The kernels are then checked on the main
    path's own inputs."""
    import importlib
    import inspect

    import torch

    def copy(out):
        if isinstance(out, torch.Tensor):
            return out.clone()
        return type(out)(*map(copy, out))  # anchor_match's named tuple

    def wrap(kind, fn, plain):
        sig = inspect.signature(fn)

        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            if armed() and kind in CHECKED_AT_CALL:
                want = plain(*args, **kwargs)
                shape = f"{tuple(args[0].shape)} -> {tuple(out.shape)} {str(out.dtype)[6:]}"
                calls.append((kind, shape, out.dtype == want.dtype and torch.equal(out, want)))
            elif armed():
                bound = sig.bind(*args, **kwargs)
                bound.apply_defaults()
                calls.append((kind, tuple(bound.arguments.values()), copy(out)))
            return out
        return call

    saved = []
    for kind in kinds:
        module, name, plain = RECORDABLE[kind]
        mod = importlib.import_module(f"objectdetection_torch.ops.{module}")
        saved.append((mod, name, getattr(mod, name)))
        setattr(mod, name, wrap(kind, saved[-1][2], getattr(mod, plain)))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def profiled_ms(fn, top: int = 6, name: str = "phase 11"):
    """(host wall ms, device busy ms, device kernels) of one call of ``fn``
    under the profiler; logs its ``top`` largest device kernels."""
    import torch

    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, acc_events=True) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = busy_ms(prof)
    if not busy > 0:
        fail(f"{name}: the profiler saw no device time")
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    for e in sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:top]:
        log(f"  {e.self_device_time_total / 1e3:8.3f} ms {e.count:5d}x  {e.key[:80]}")
    return wall, busy, sum(e.count for e in events)


def driven(name, fn, want, tally=None):
    """Run ``fn`` with the launch counters set to 0 just before it; fail
    unless they read ``want`` (kernel -> launches) just after. Adds the
    counts read to ``tally`` if given."""
    import torch

    reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    got = {k: launch_counts()[k] for k in want}
    if got != want:
        fail(f"{name}: kernel launches {got}, want {want}")
    if tally is not None:
        for k, v in got.items():
            tally[k] = tally.get(k, 0) + v
    return out


def frcnn_batch(cfg, device, seed):
    """Seeded Faster R-CNN batch: uniform pixels around 0, 2 and 5 pixel xyxy
    GT boxes of 100-500 px sides (VOC objects at this scale), zero-padded
    to 5."""
    import numpy as np
    import torch

    from objectdetection_torch.faster_rcnn_train import FasterRCNNBatch

    rng = np.random.RandomState(seed)
    h, w = cfg.image_shape[:2]
    images = rng.uniform(-128.0, 127.0, (BATCH, h, w, 3)).astype(np.float32)
    boxes = np.zeros((BATCH, 5, 4), np.float32)
    cls = np.zeros((BATCH, 5), np.int32)
    for i, n in enumerate((2, 5)):
        side = rng.uniform(min(100, h // 4), min(500, h - 1), (n, 2))
        x1 = rng.uniform(0, w - 1 - side[:, 0])
        y1 = rng.uniform(0, h - 1 - side[:, 1])
        boxes[i, :n] = np.stack([x1, y1, x1 + side[:, 0], y1 + side[:, 1]], -1)
        cls[i, :n] = rng.randint(1, cfg.num_classes, n)
    return FasterRCNNBatch(*(torch.from_numpy(x).to(device) for x in (images, boxes, cls)))


def frcnn_forward_vs_plain(params, images, cfg):
    """One f32 forward and its detections through the kernels and through
    the plain path: proposals, their valid flags and the detections equal."""
    import torch

    from objectdetection_torch.models import faster_rcnn as fr

    torch.backends.cudnn.deterministic = True
    try:
        with torch.inference_mode():
            out_k = fr.apply(params, images, cfg)
            det_k = fr.faster_rcnn_detections(out_k, cfg, score_threshold=0.0)
            with plain_path():
                out_p = fr.apply(params, images, cfg)
                det_p = fr.faster_rcnn_detections(out_p, cfg, score_threshold=0.0)
    finally:
        torch.backends.cudnn.deterministic = False
    for name, a, b in (("proposals_valid", out_k["proposals_valid"], out_p["proposals_valid"]),
                       ("proposals", out_k["proposals"], out_p["proposals"]),
                       ("detection valid", det_k.valid, det_p.valid),
                       ("detection class ids", det_k.class_ids, det_p.class_ids),
                       ("detection boxes", det_k.boxes, det_p.boxes)):
        if not torch.equal(a, b):
            fail(f"faster rcnn f32: {name} differ between the kernel and the plain path")
    return out_k, int(det_k.valid.sum())


def frcnn_full_rows(outputs, cfg, device):
    """The class-aware NMS (300 -> 50) on full rows: the forward's proposals
    and box deltas with class probabilities drawn from a seed (the random
    head gives nearly every ROI one class); the kernel's and the plain
    path's detections identical. Returns (detections, classes among them)."""
    import torch

    from objectdetection_torch.models import faster_rcnn as fr

    gen = torch.Generator(device=device).manual_seed(7)
    logits = 3.0 * torch.randn(outputs["class_probs"].shape, generator=gen, device=device)
    seeded = dict(outputs, class_probs=torch.softmax(logits, dim=-1))
    with torch.inference_mode():
        det_k = fr.faster_rcnn_detections(seeded, cfg, score_threshold=0.0)
        with plain_path():
            det_p = fr.faster_rcnn_detections(seeded, cfg, score_threshold=0.0)
    for name, a, b in zip(det_k._fields, det_k, det_p):
        if not torch.equal(a, b):
            fail(f"faster rcnn seeded class probabilities: detection {name} differ between "
                 "the kernel and the plain path")
    return int(det_k.valid.sum()), int(torch.unique(det_k.class_ids[det_k.valid]).numel())


def frcnn_step_vs_plain(params, batch, cfg, device):
    """One f32 step's losses and targets through the kernels and the plain
    path on the same batch and noise."""
    import torch

    from objectdetection_torch import faster_rcnn_train as ft

    noise = ft.draw_noise(cfg, batch, torch.Generator(device=device).manual_seed(3))
    torch.backends.cudnn.deterministic = True
    try:
        with torch.no_grad():
            parts_k, (rpn_k, props_k, det_k) = ft.compute_losses(params, batch, cfg, noise,
                                                                 return_targets=True)
            with plain_path():
                parts_p, (rpn_p, props_p, det_p) = ft.compute_losses(params, batch, cfg, noise,
                                                                     return_targets=True)
    finally:
        torch.backends.cudnn.deterministic = False
    for name, a, b in (("rpn target_class", rpn_k.target_class, rpn_p.target_class),
                       ("proposals", props_k, props_p),
                       ("sampled rois", det_k.rois, det_p.rois),
                       ("target_class_ids", det_k.target_class_ids, det_p.target_class_ids)):
        if not torch.equal(a, b):
            fail(f"faster rcnn step f32: {name} differ between the kernel and the plain path")
    for k, v in parts_k.items():
        ref = float(parts_p[k])
        if not (torch.isfinite(v) and abs(float(v) - ref) <= LOSS_RTOL * abs(ref)):
            fail(f"faster rcnn step f32: {k} kernel {float(v)} vs plain {ref}")
    return parts_k, int(det_k.pos_mask.sum())


def train_family(name, step, state, batches, card, want):
    """FAMILY_STEPS steps through ``step(state, batch)``, the launch counters
    read around them; then one profiled step. Returns the last state."""
    import torch

    state, _ = step(state, batches[0])  # cold: cuDNN heuristics, lazy init
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    history = []

    def run():
        nonlocal state
        for i in range(FAMILY_STEPS):
            state, metrics = step(state, batches[i % len(batches)])
            history.append(metrics)

    t0 = time.perf_counter()
    driven(f"{name} training", run, {k: v * FAMILY_STEPS for k, v in want.items()})
    ms = (time.perf_counter() - t0) * 1e3 / FAMILY_STEPS
    peak = torch.cuda.max_memory_allocated() / 2**30
    for i, m in enumerate(history):
        bad = [k for k, v in m.items() if not bool(torch.isfinite(v))]
        if bad:
            fail(f"{name} training step {i}: not finite: {bad}")

    def one():
        nonlocal state
        state, _ = step(state, batches[0])

    wall, busy, _ = profiled_ms(one)
    log(f"{name} training: {FAMILY_STEPS} steps, {ms:.1f} ms a step (host wall); launches "
        f"{want} a step; peak memory {peak:.2f} GiB; profiled step wall {wall:.1f} ms, device "
        f"busy {busy:.1f} ms ({100 * busy / wall:.1f}%); total_loss "
        f"{[round(float(m['total_loss']), 4) for m in history]} [{card}]")
    return state


def check_recorded(calls, card):
    """Every NMS and anchor-match call the phase recorded against its plain
    version on those inputs, logged by shape; NMS at 12000 -> 2000 and
    each anchor-match shape timed with their bounds."""
    import torch

    from objectdetection_torch.geometry import iou_matrix
    from objectdetection_torch.ops import anchor_match, nms

    groups = {}
    for kind, args, _ in calls:
        key = (kind,) + tuple(tuple(a.shape) if hasattr(a, "shape") else a for a in args)
        groups.setdefault(key, []).append(args)
    if {key[0] for key in groups} != {"nms", "anchor_match"}:
        fail(f"phase 11 recorded only {sorted({key[0] for key in groups})}")
    for key, group in groups.items():
        for args in group:
            if key[0] == "nms":
                got, want = nms.suppress(*args), nms.suppress_plain(*args)
                if not torch.equal(got, want):
                    fail(f"nms at {key[1:]}: kernel differs from plain")
            else:
                got, want = anchor_match.anchor_match(*args), anchor_match.anchor_match_plain(*args)
                for field, k, p in zip(want._fields, got, want):
                    if not torch.equal(k, p):
                        fail(f"anchor_match at {key[1:]}: kernel {field} differs")
        args = group[-1]  # got and want are this call's
        if key[0] == "nms":
            boxes, cls, thr, budget = args
            line = (f"nms B={boxes.shape[0]} N={boxes.shape[1]} -> {budget} thr={thr} classes "
                    f"{int(torch.unique(cls).numel())}: kernel == plain on {len(group)} calls "
                    f"({int((got != 0).any(-1).sum())} survivors in the last)")
            if boxes.shape[1] == 12000:
                rows = stop_row(want, nms.TILE, budget)
                ms = device_ms(lambda: nms.suppress(*args))
                plain = time_ms(lambda: nms.suppress_plain(*args), 3, warmup=1)
                bytes_ms = boxes.shape[0] * boxes.shape[1] * (16 + 4 + 16) / PEAK_BYTES * 1e3
                ops_ms = nms_ops(want, cls, rows) / PEAK_F32 * 1e3
                line += (f"; kernel {ms:.4f} ms device ({rows} rows resolved), plain {plain:.3f}"
                         f" ms, bound {max(bytes_ms, ops_ms):.5f} ms "
                         f"({'bytes' if bytes_ms >= ops_ms else 'operations'}) [{card}]")
            log(line)
        else:
            anchors, gt, valid = args
            a, g = anchors.shape[0], gt.shape[1]
            ms = device_ms(lambda: anchor_match.anchor_match(*args))
            plain = time_ms(lambda: anchor_match.anchor_match_plain(*args), 3, warmup=1)
            overlap = int(((iou_matrix(anchors, gt) > 0) & valid.bool()[:, None, :]).sum())
            bytes_ = a * 16 + gt.numel() * 4 + valid.numel() + gt.shape[0] * (a + g) * 8
            bound = max(bytes_ / PEAK_BYTES, overlap * MATCH_OPS / PEAK_F32) * 1e3
            log(f"anchor_match B={gt.shape[0]} A={a} G={g} ({int(valid.sum())} valid): kernel == "
                f"plain on {len(group)} calls; kernel {ms:.4f} ms device, plain {plain:.3f} ms, "
                f"bound {bound:.5f} ms ({overlap} overlapping pairs) [{card}]")


def frcnn_phase(device, card, calls):
    """11(a)-(b): Faster R-CNN at its defaults and at the VOC test scale."""
    import torch

    from objectdetection_torch import faster_rcnn_train as ft
    from objectdetection_torch import optim
    from objectdetection_torch.config import FasterRCNNConfig
    from objectdetection_torch.convert import init_faster_rcnn_params
    from objectdetection_torch.models import faster_rcnn as fr

    for label, cfg in (("224²", FasterRCNNConfig()),
                       ("600x1000", FasterRCNNConfig().replace(image_shape=(600, 1000, 3),
                                                               num_classes=21))):
        params = init_faster_rcnn_params(cfg, torch.Generator().manual_seed(0), device)
        batch = frcnn_batch(cfg, device, 13)
        infer = fr.make_infer_fn(cfg, score_threshold=0.0)
        t0 = time.perf_counter()
        with recorded_inputs(calls):
            outputs, det = driven(f"faster rcnn {label} forward",
                                  lambda: infer(params, batch.images), {"nms": 2})
        first = (time.perf_counter() - t0) * 1e3
        for k, v in outputs.items():
            if v.is_floating_point() and not bool(torch.isfinite(v).all()):
                fail(f"faster rcnn {label}: {k} not finite")
        h, w = fr.feature_shape(cfg.image_shape)
        ms = time_host_ms(lambda: infer(params, batch.images), REPS)
        wall, busy, _ = profiled_ms(lambda: infer(params, batch.images))
        log(f"faster rcnn {label} ({cfg.num_classes} classes, f32, B={BATCH}): {h * w * 9} "
            f"anchors, {int(outputs['proposals_valid'].sum())} proposals, "
            f"{int(det.valid.sum())} detections; first batch {first:.1f} ms, {ms:.1f} ms a "
            f"batch; profiled batch wall {wall:.1f} ms, device busy {busy:.1f} ms "
            f"({100 * busy / wall:.1f}%); launches NMS 2 a batch [{card}]")
        if label == "224²":
            continue
        out_k, n_det = frcnn_forward_vs_plain(params, batch.images, cfg)
        n_full, n_cls = frcnn_full_rows(out_k, cfg, device)
        parts, n_pos = frcnn_step_vs_plain(params, batch, cfg, device)
        log(f"faster rcnn {label} f32: forward == plain "
            f"({int(out_k['proposals_valid'].sum())} proposals, {n_det} detections "
            f"identical); with seeded class probabilities {n_full} detections of {n_cls} "
            f"classes identical; one step's targets identical ({n_pos} positive ROIs), "
            f"losses within {LOSS_RTOL} of plain: "
            + ", ".join(f"{k} {float(v):.6g}" for k, v in parts.items()))
        del out_k
        state = ft.TrainState(params, optim.init(params), 0)
        step = ft.make_train_step(cfg)
        gen = torch.Generator(device=device).manual_seed(4)
        with recorded_inputs(calls):
            state = train_family(f"faster rcnn {label}", lambda s, b: step(s, b, gen), state,
                                 [batch, frcnn_batch(cfg, device, 14)], card,
                                 {"nms": 1, "anchor_match": 1})
        if state.step != FAMILY_STEPS + 2:
            fail(f"faster rcnn training: state.step {state.step}")


def retinanet_phase(device, card, calls):
    """11(c): RetinaNet at COCO_CONFIG (R101-FPN, 81 classes, 1024², bf16)."""
    import torch

    from objectdetection_torch.config import COCO_CONFIG
    from objectdetection_torch.convert import init_retinanet_params
    from objectdetection_torch.models import retinanet as rn
    from objectdetection_torch.ops import nms

    cfg = COCO_CONFIG
    params = init_retinanet_params(cfg, torch.Generator().manual_seed(0), device)
    batch = train_batch(cfg, device)
    infer = rn.make_infer_fn(cfg, score_threshold=0.0)
    t0 = time.perf_counter()
    with recorded_inputs(calls):
        det = driven("retinanet forward", lambda: infer(params, batch.images), {"nms": 1})
    first = (time.perf_counter() - t0) * 1e3
    if det.shape != (BATCH, cfg.detection_post_nms_instances, 6) or not bool(
            torch.isfinite(det).all()):
        fail(f"retinanet detections: shape {tuple(det.shape)} or not finite")
    ms = time_host_ms(lambda: infer(params, batch.images), REPS)
    wall, busy, _ = profiled_ms(lambda: infer(params, batch.images))
    log(f"retinanet (R101-FPN 1024² bf16, B={BATCH}): {int((det[..., 5] > 0).sum())} "
        f"detections; first batch {first:.1f} ms, {ms:.1f} ms a batch; profiled batch wall "
        f"{wall:.1f} ms, device busy {busy:.1f} ms ({100 * busy / wall:.1f}%); launches NMS 1 "
        f"a batch [{card}]")

    # in f32, the detections of the kernel and the plain path on the same logits
    cfg32 = cfg.replace(compute_dtype="float32")
    with torch.inference_mode():
        logits, deltas = rn.apply(params, batch.images, cfg32)
        det_k = rn.retinanet_detections(logits, deltas, cfg32, score_threshold=0.0)
        saved, nms.suppress = nms.suppress, nms.suppress_plain
        try:
            det_p = rn.retinanet_detections(logits, deltas, cfg32, score_threshold=0.0)
        finally:
            nms.suppress = saved
    if not torch.equal(det_k, det_p):
        fail("retinanet f32: detections differ between the kernel and the plain path")
    log(f"retinanet f32: detections == plain on the same logits "
        f"({int((det_k[..., 5] > 0).sum())} rows)")
    del logits, deltas

    step, init_state = rn.make_retinanet_train_step(cfg)
    with recorded_inputs(calls):
        state = train_family("retinanet", step, init_state(params), [batch], card,
                             {"nms": 0, "anchor_match": 1})
    if state.count != FAMILY_STEPS + 2:
        fail(f"retinanet training: count {state.count}")


def families_phase(device, card):
    """11: the Faster R-CNN and RetinaNet families; then NMS and anchor
    matching against their plain versions on the inputs the phase gave them."""
    t0 = time.perf_counter()
    calls = []
    frcnn_phase(device, card, calls)
    retinanet_phase(device, card, calls)
    check_recorded(calls, card)
    log(f"phase 11: {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------- phase 12

PARALLEL_STEPS = 2  # training steps of each parallel path
# the launches of one training step with masks: NMS and anchor matching
# once, ROIAlign and its gradient at the box and the mask stage
STEP_LAUNCHES = {"nms": 1, "anchor_match": 1, "roi_align": 2, "roi_align_backward": 2}
INFER_LAUNCHES = {"nms": 2, "roi_align": 2}  # a batch with masks
TP_RTOL = 1e-4  # the TP step's total_loss: the bound of tests/test_parallel.py's TP test
NOISE_SEED = 3  # of the generator 12(b)'s target noise is drawn from
RANK_TIMEOUT = 600  # seconds for 12(b)-(c)'s two ranks
# sampled ROI coordinates of a rank against the single process's (its batch
# of 2 may take other conv algorithms than a batch of 1): the tolerance of
# tests/test_torch_train.py; the anchors' classes are held equal
ROI_ATOL = 1e-6


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rel_gap(got: float, want: float) -> float:
    return abs(got - want) / abs(want) if want else (0.0 if got == want else float("inf"))


def metrics_gap(got, want):
    """(worst relative gap, its key) of a parallel step's losses and per-head
    gradient norms from the single process's."""
    return max((rel_gap(float(got[k]), float(v)), k) for k, v in want.items())


def params_gap(got, want, base):
    """(worst gap, its head) of the parameters after a parallel step from the
    single process's: for each head (the ``grad_norm`` groups), the L2
    distance over its leaves relative to the single process's move of the
    head from ``base``."""
    import torch

    dist2, move2 = {}, {}
    for k, p in want.items():
        head = k.split(".")[0]
        dist2[head] = dist2.get(head, 0.0) + float(
            torch.linalg.vector_norm(got[k].to(p.device) - p)) ** 2
        move2[head] = move2.get(head, 0.0) + float(torch.linalg.vector_norm(p - base[k])) ** 2
    return max(((dist2[h] / move2[h]) ** 0.5 if move2[h] else (0.0 if dist2[h] == 0
                                                             else float("inf")), h)
               for h in dist2)


def leaf_gaps(got, want, base, top: int = 3):
    """The ``top`` leaves farthest from the single process's, each relative
    to its own move from ``base`` (logged: a leaf whose gradient cancels,
    such as a residual branch's last BN scale, which starts at 0, moves
    little, and its sums reassociate across ranks)."""
    import torch

    gaps = []
    for k, p in want.items():
        err = float(torch.linalg.vector_norm(got[k].to(p.device) - p))
        move = float(torch.linalg.vector_norm(p - base[k]))
        gaps.append((err / move if move else (0.0 if err == 0 else float("inf")), k))
    return sorted(gaps, reverse=True)[:top]


def run_steps(step, state, batch, noises=None, generator=None):
    """PARALLEL_STEPS steps, each given its noise or drawing from
    ``generator``: ([(state, metrics)] after each, host ms of each)."""
    import torch

    out, ms = [], []
    for i in range(PARALLEL_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch, generator, None if noises is None else noises[i])
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        out.append((state, metrics))
    return out, ms


def step_targets(state, batch, cfg, noise):
    """The targets a step from ``state`` assigns with ``noise``: the RPN's
    anchor classes and every second-stage field, on the host."""
    import torch

    from objectdetection_torch import detector

    with torch.no_grad():
        _, (rpn, _, det) = detector.compute_losses(
            {**state.params, **state.batch_stats}, batch, cfg, noise, with_masks=True,
            return_targets=True)
    return {"rpn_class": rpn.target_class.cpu(), **{k: v.cpu() for k, v in det._asdict().items()}}


def targets_gap(ranks, single):
    """How the ranks' targets (each of its own rows) differ from the single
    process's: the largest gap of the ROIs and box deltas, and the count of
    differing elements of each discrete field."""
    import torch

    gap = {}
    for k, want in single.items():
        got = torch.cat([r[k] for r in ranks])
        gap[k] = (float((got - want).abs().max()) if k in ("rois", "target_deltas")
                  else int((got != want).sum()))
    return gap


def one_image_step(state, batch, cfg, noise):
    """The single process's step on ``batch`` taken one image at a time:
    each image's losses over the whole batch's counts, their gradients
    summed by autograd, then one update. A data-parallel rank's arithmetic
    (a batch of 1), in one process and written apart from parallel.py.
    Returns (state, metrics) as ``detector.train_step`` does."""
    import torch

    from objectdetection_torch import detector, optim

    def rows(i):
        return (detector.TrainBatch(*(None if x is None else x[i:i + 1] for x in batch)),
                detector.TrainNoise(*(tuple(t[i:i + 1] for t in pair) for pair in noise)))

    images = [rows(i) for i in range(batch.images.shape[0])]
    seen = [[] for _ in images]  # each loss's count, image by image
    with torch.no_grad():
        for (b, nz), into in zip(images, seen):
            detector.compute_losses({**state.params, **state.batch_stats}, b, cfg, nz,
                                    with_masks=True, count=lambda c, into=into: into.append(c) or c)
    totals = [sum(counts) for counts in zip(*seen)]

    def losses(leaves):
        parts = [detector.compute_losses({**leaves, **state.batch_stats}, b, cfg, nz,
                                         with_masks=True, count=lambda c, it=iter(totals): next(it))
                 for b, nz in images]
        return {k: sum(p[k] for p in parts) for k in parts[0]}

    params, opt_state, metrics, grads = optim.sgd_step(state.params, losses, state.opt_state, cfg)
    for head in dict.fromkeys(k.split(".")[0] for k in grads):
        metrics[f"grad_norm/{head}"] = optim.named_norm(
            {k: g for k, g in grads.items() if k.split(".")[0] == head})
    return detector.TrainState(params, state.batch_stats, opt_state, state.step + 1), metrics


def parallel_nccl(params, card):
    """12(a): NCCL at world 1 in this process. Data-parallel inference on
    phase 4's batch equal to make_infer_fn; two bf16 data-parallel steps on
    phase 6's batch against make_train_step. Returns (the single-process
    detections, the launches of both paths as the counters read them)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from objectdetection_torch import detector, optim, parallel
    from objectdetection_torch.config import COCO_CONFIG
    from objectdetection_torch.convert import split_collections

    cfg, device = COCO_CONFIG, torch.device("cuda", 0)
    launches = {}
    parallel.initialize_multihost(f"127.0.0.1:{free_port()}", 1, 0, device=device)
    try:
        if dist.get_backend() != "nccl":
            fail(f"12(a): backend {dist.get_backend()}, want nccl")
        mesh = parallel.make_mesh()
        images, windows = (torch.as_tensor(x, device=device)
                           for x in random_request(np.random.RandomState(0), cfg))
        single = detector.make_infer_fn(cfg)
        infer = parallel.make_parallel_infer_fn(cfg, mesh)
        shard = parallel.shard_batch((images, windows), mesh)
        want = single(params, images, windows)
        got = driven("12(a) inference", lambda: infer(params, *shard), INFER_LAUNCHES, launches)
        if not same_detections(got, want):
            fail("12(a): the data-parallel detections differ from make_infer_fn's")
        ms_single = time_host_ms(lambda: single(params, images, windows), REPS)
        ms_par = time_host_ms(lambda: infer(params, *shard), REPS)

        p, stats, _ = split_collections(params)
        batch = train_batch(cfg, device)
        state0 = detector.TrainState(p, stats, optim.init(p), 0)
        torch.backends.cudnn.deterministic = True  # leave only the atomics' order free
        try:
            ref, ms_ref = run_steps(detector.make_train_step(cfg, with_masks=True), state0, batch,
                                    generator=torch.Generator(device).manual_seed(1))
            dp_step = parallel.make_parallel_train_step(cfg, mesh, with_masks=True)
            state = parallel.replicate_state(state0, mesh)
            shard_b = parallel.shard_batch(batch, mesh)
            dp, ms_dp = driven(
                "12(a) training",
                lambda: run_steps(dp_step, state, shard_b,
                                  generator=torch.Generator(device).manual_seed(1)),
                {k: v * PARALLEL_STEPS for k, v in STEP_LAUNCHES.items()}, launches)
        finally:
            torch.backends.cudnn.deterministic = False
        worst = max(gap for i in range(PARALLEL_STEPS)
                    for gap in (metrics_gap(dp[i][1], ref[i][1]),
                                params_gap(dp[i][0].params, ref[i][0].params,
                                           (ref[i - 1][0] if i else state0).params)))
        if not worst[0] <= GRAD_REL:
            fail(f"12(a): {worst[1]} lies {worst[0]:.3g} from the single process's")
    finally:
        dist.destroy_process_group()
    log(f"12(a) NCCL, world 1: data-parallel inference {ms_par:.1f} ms a batch of {BATCH} "
        f"(make_infer_fn {ms_single:.1f}), detections identical; {PARALLEL_STEPS} bf16 steps "
        f"{[round(m, 1) for m in ms_dp]} ms (make_train_step {[round(m, 1) for m in ms_ref]}), "
        f"losses, gradient norms and updates within {GRAD_REL} (worst {worst[0]:.3g}, "
        f"{worst[1]}) [{card}]")
    return detector.Detections(*(t.cpu() for t in want)), launches


def start_ranks(tmp):
    """12(b)-(c)'s two ranks: this script with --parallel-rank, each logging
    to a file in ``tmp``."""
    port, procs = free_port(), []
    for rank in range(2):
        with open(Path(tmp) / f"rank{rank}.log", "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, str(ROOT / "chip_smoke.py"), "--parallel-rank", str(rank),
                 str(port), str(tmp)], stdout=f, stderr=subprocess.STDOUT, cwd=str(ROOT)))
    return procs


def wait_ranks(procs, tmp):
    """Each rank's last line (JSON); fails if a rank failed or timed out."""
    deadline = time.perf_counter() + RANK_TIMEOUT
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.perf_counter(), 1))
    except subprocess.TimeoutExpired:
        fail(f"12(b)-(c): the ranks did not finish in {RANK_TIMEOUT} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for rank, p in enumerate(procs):
        lines = (Path(tmp) / f"rank{rank}.log").read_text().splitlines()
        if p.returncode != 0 or not lines:
            fail(f"12(b)-(c): rank {rank} exited {p.returncode}:\n" + "\n".join(lines[-30:]))
        try:
            results.append(json.loads(lines[-1]))
        except json.JSONDecodeError:
            fail(f"12(b)-(c): rank {rank}'s last line is no result: {lines[-1]}")
    return results


def parallel_ranks(params, single_det, card):
    """12(b)-(c): two ranks on the one card over gloo, subprocesses of this
    script. The single-process f32 reference is computed here first: two
    steps of make_train_step on phase 6's batch, with noise drawn once and
    handed to the ranks. Each rank's step is then held against the single
    process's steps from the same state (the first from state0, the second
    from the ranks' first). Returns the ranks' launches."""
    import tempfile

    import torch

    from objectdetection_torch import detector, optim
    from objectdetection_torch.config import COCO_CONFIG
    from objectdetection_torch.convert import split_collections

    device = torch.device("cuda", 0)
    cfg = COCO_CONFIG.replace(compute_dtype="float32")
    p, stats, _ = split_collections(params)
    batch = train_batch(COCO_CONFIG, device)
    gen = torch.Generator(device).manual_seed(NOISE_SEED)
    noises = [detector.draw_noise(cfg, batch, gen) for _ in range(PARALLEL_STEPS)]
    state0 = detector.TrainState(p, stats, optim.init(p), 0)
    torch.backends.cudnn.deterministic = True
    torch.cuda.reset_peak_memory_stats()
    try:
        ref, ms_ref = run_steps(detector.make_train_step(cfg, with_masks=True), state0, batch,
                                noises)
    finally:
        torch.backends.cudnn.deterministic = False
    peak_ref = torch.cuda.max_memory_allocated() / 2**30

    with tempfile.TemporaryDirectory() as tmp:
        torch.save([tuple(tuple(t.cpu() for t in pair) for pair in n) for n in noises],
                   Path(tmp) / "noise.pt")
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ranks = wait_ranks(start_ranks(tmp), tmp)
        wall = time.perf_counter() - t0
        dets = [torch.load(Path(tmp) / f"det_{r}.pt") for r in range(2)]
        tgts = [torch.load(Path(tmp) / f"targets_{r}.pt") for r in range(2)]
        got = [torch.load(Path(tmp) / f"params_{i}.pt") for i in range(PARALLEL_STEPS)]
        trace = torch.load(Path(tmp) / "trace.pt")

    # (b) inference: every rank holds the whole batch, each rank's own rows
    # (already held equal to make_infer_fn on them alone inside the rank)
    for f in detector.Detections._fields:
        g0, g1 = dets[0]["det"][f], dets[1]["det"][f]
        if not (torch.equal(g0, g1)
                and torch.equal(g0, torch.cat([dets[0]["alone"][f], dets[1]["alone"][f]]))):
            fail(f"12(b): the gathered {f} are not the ranks' own rows in rank order")
    batch2 = {f: float((dets[0]["det"][f].float() - getattr(single_det, f).float()).abs().max())
              for f in ("boxes", "scores", "masks")}
    faults = []
    if ranks[0]["dp_metrics"] != ranks[1]["dp_metrics"]:
        faults.append("12(b): the ranks report different metrics")
    if ranks[0]["params_sha"] != ranks[1]["params_sha"]:
        faults.append("12(b): the ranks' updated parameters differ")
    # (b) training, each step from the state before it. The ranks' targets
    # must be the single process's rows. Each step is held against two steps
    # of the single process from the same state: the whole batch's, and the
    # same step taken one image at a time (a rank's arithmetic, in one
    # process). Against the one-image step everything is held; against the
    # whole batch's, the parameters too, unless the single process's own
    # one-image step lies beyond the bound from its whole-batch step: a batch
    # of 1 runs other conv and GEMM algorithms than a batch of 2, and the
    # mask head, trained here by one positive ROI, can carry that apart.
    got = [{k: v.to(device) for k, v in g.items()} for g in got]
    states = [state0, detector.TrainState(got[0], stats, optim.OptState(
        {k: v.to(device) for k, v in trace.items()}, 1), 1)]
    whole, split = [], []
    torch.backends.cudnn.deterministic = True
    try:
        for i, state in enumerate(states):
            single = step_targets(state, batch, cfg, noises[i])
            gap = targets_gap([t[i] for t in tgts], single)
            roi_gap, delta_gap = gap.pop("rois"), gap.pop("target_deltas")
            log(f"12(b) step {i + 1}: positive ROIs by image "
                f"{single['pos_mask'].sum(dim=1).tolist()}; the ranks' targets against the "
                f"single process's rows: ROIs within {roi_gap:.3g}, box deltas within "
                f"{delta_gap:.3g}, differing elements {gap}")
            if roi_gap > ROI_ATOL or any(gap.values()):
                faults.append(f"12(b) step {i + 1}: the ranks' targets differ from the single "
                              f"process's: ROIs {roi_gap:.3g}, {gap}")
            whole.append(detector.train_step(state, batch, None, cfg, with_masks=True,
                                             noise=noises[i]))
            split.append(one_image_step(state, batch, cfg, noises[i]))
    finally:
        torch.backends.cudnn.deterministic = False
    for i, state in enumerate(states):
        mine, label = ranks[0]["dp_metrics"][i], f"step {i + 1}"
        to_whole = params_gap(got[i], whole[i][0].params, state.params)
        to_split = params_gap(got[i], split[i][0].params, state.params)
        apart = params_gap(split[i][0].params, whole[i][0].params, state.params)
        log(f"12(b) {label}: losses and gradient norms within "
            f"{metrics_gap(mine, whole[i][1])} of the whole batch's step, "
            f"{metrics_gap(mine, split[i][1])} of the one-image step; parameters by head, "
            f"against the step's move: {to_whole} from the whole batch's, {to_split} from the "
            f"one-image step, which lies {apart} from the whole batch's; leaves farthest from "
            f"the whole batch's {leaf_gaps(got[i], whole[i][0].params, state.params)}")
        for ref_metrics, name in ((whole[i][1], "whole batch's"), (split[i][1], "one-image")):
            worst = metrics_gap(mine, ref_metrics)
            if not worst[0] <= GRAD_REL:
                faults.append(f"12(b) {label}: {worst[1]} lies {worst[0]:.3g} from the "
                              f"single process's {name} step")
        if not to_split[0] <= GRAD_REL:
            faults.append(f"12(b) {label}: the {to_split[1]} parameters lie "
                          f"{to_split[0]:.3g} from the single process's one-image step")
        if not (to_whole[0] <= GRAD_REL or apart[0] > GRAD_REL):
            faults.append(f"12(b) {label}: the {to_whole[1]} parameters lie "
                          f"{to_whole[0]:.3g} from the single process's whole-batch step")
        elif not to_whole[0] <= GRAD_REL:
            log(f"12(b) {label}: the {to_whole[1]} parameters lie {to_whole[0]:.3g} from "
                f"the whole batch's step, as the single process's own one-image step does "
                f"({apart[0]:.3g}): a batch of 1's arithmetic")
    # (c) tensor parallelism
    for r in ranks:
        if r["tp_conv1"] != [512, 12544]:
            faults.append(f"12(c): rank {r['rank']} holds mrcnn_class_conv1 as {r['tp_conv1']}")
        for i in range(PARALLEL_STEPS):
            if not rel_gap(r["tp_total_loss"][i], float(ref[i][1]["total_loss"])) <= TP_RTOL:
                faults.append(f"12(c) step {i}: total_loss {r['tp_total_loss'][i]} vs "
                              f"replicated {float(ref[i][1]['total_loss'])}")

    log(f"12(b) gloo, 2 ranks on one card ({wall:.1f} s from launch to exit): inference "
        f"{[r['infer_ms'] for r in ranks]} ms a batch of 1 a rank, detections gathered in "
        f"rank order, each rank's rows equal to make_infer_fn's on them; largest gap from "
        f"phase 12(a)'s batch of {BATCH}: {batch2}")
    log(f"12(b) {PARALLEL_STEPS} f32 steps, 1 + 1 images: "
        f"{[[round(m, 1) for m in r['dp_ms']] for r in ranks]} ms a step per rank "
        f"(single process, {BATCH} images: {[round(m, 1) for m in ms_ref]}); gradient "
        f"all-reduce {[r['allreduce_ms'] for r in ranks]} ms; peak "
        f"{[r['dp_peak_gib'] for r in ranks]} GiB per rank (single process {peak_ref:.2f}); "
        f"targets identical, ROIs within {ROI_ATOL}; losses, gradient norms and each head's "
        f"parameters after each step within {GRAD_REL} of the one-image step, and of the "
        f"whole batch's where that step lies within it [{card}]")
    log(f"12(c) dp x tp = 1 x 2, gloo: {ranks[0]['tp_split']} leaves split (min_dim 512), "
        f"mrcnn_class_conv1 [512, 12544] a rank; total_loss "
        f"{[round(x, 6) for x in ranks[0]['tp_total_loss']]} (replicated "
        f"{[round(float(m['total_loss']), 6) for _, m in ref]}, within {TP_RTOL}); "
        f"{[[round(m, 1) for m in r['tp_ms']] for r in ranks]} ms a step per rank; peak "
        f"{[r['tp_peak_gib'] for r in ranks]} GiB per rank (replicated {peak_ref:.2f}) [{card}]")
    if faults:
        fail("; ".join(faults))
    launches = {}
    for r in ranks:
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    return launches


def parallel_rank(rank: int, port: int, tmp: Path) -> None:
    """One of 12(b)-(c)'s two ranks on cuda:0 over gloo. Prints a JSON
    object as its last line."""
    import hashlib

    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    from objectdetection_torch import convert, detector, optim, parallel
    from objectdetection_torch.config import COCO_CONFIG

    device = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    parallel.initialize_multihost(f"127.0.0.1:{port}", 2, rank, device=device, backend="gloo")
    mesh = parallel.make_mesh()
    out = {"rank": rank, "launches": {}}

    def count(name, fn, want):
        return driven(name, fn, want, out["launches"])

    params = convert.init_params(COCO_CONFIG, torch.Generator().manual_seed(0), device)
    # (b) inference, one image a rank
    images, windows = random_request(np.random.RandomState(0), COCO_CONFIG)
    shard = parallel.shard_batch((images, windows), mesh)
    infer = parallel.make_parallel_infer_fn(COCO_CONFIG, mesh)
    alone = detector.make_infer_fn(COCO_CONFIG)(params, *shard)
    det = count("12(b) inference", lambda: infer(params, *shard), INFER_LAUNCHES)
    mine = detector.Detections(*(t[rank:rank + 1] for t in det))
    if not same_detections(mine, alone):
        fail(f"12(b): rank {rank}'s rows differ from make_infer_fn's on them alone")
    out["infer_ms"] = round(time_host_ms(lambda: infer(params, *shard), 3), 1)
    torch.save({"det": {f: getattr(det, f).cpu() for f in detector.Detections._fields},
                "alone": {f: getattr(alone, f).cpu() for f in detector.Detections._fields}},
               tmp / f"det_{rank}.pt")

    # (b) f32 data-parallel steps, one image a rank
    cfg = COCO_CONFIG.replace(compute_dtype="float32")
    p, stats, _ = convert.split_collections(params)
    state0 = parallel.replicate_state(detector.TrainState(p, stats, optim.init(p), 0), mesh)
    batch = train_batch(COCO_CONFIG, device)
    shard_b = parallel.shard_batch(batch, mesh)
    noises = [detector.TrainNoise(*(tuple(t.to(device) for t in pair) for pair in n))
              for n in torch.load(tmp / "noise.pt")]

    def own(noise):  # this rank's rows of the whole batch's noise
        return detector.TrainNoise(*(tuple(t[rank:rank + 1] for t in pair) for pair in noise))

    targets = [step_targets(state0, shard_b, cfg, own(noises[0]))]
    torch.cuda.reset_peak_memory_stats()
    steps, out["dp_ms"] = count(
        "12(b) training",
        lambda: run_steps(parallel.make_parallel_train_step(cfg, mesh, with_masks=True), state0,
                          shard_b, noises),
        {k: v * PARALLEL_STEPS for k, v in STEP_LAUNCHES.items()})
    out["dp_peak_gib"] = round(torch.cuda.max_memory_allocated() / 2**30, 2)
    out["dp_metrics"] = [{k: float(v) for k, v in m.items()} for _, m in steps]
    # the targets of each step, from the state before it
    targets += [step_targets(steps[i - 1][0], shard_b, cfg, own(noises[i]))
                for i in range(1, PARALLEL_STEPS)]
    torch.save(targets, tmp / f"targets_{rank}.pt")
    final = steps[-1][0].params
    sha = hashlib.sha256()
    for k in sorted(final):
        sha.update(final[k].cpu().numpy().tobytes())
    out["params_sha"] = sha.hexdigest()
    if rank == 0:  # each step's parameters, and the momenta the second step starts from
        for i, (state, _) in enumerate(steps):
            torch.save({k: v.cpu() for k, v in state.params.items()}, tmp / f"params_{i}.pt")
        torch.save({k: v.cpu() for k, v in steps[0][0].opt_state.trace.items()}, tmp / "trace.pt")
    zeros = {k: torch.zeros_like(v) for k, v in final.items()}
    out["allreduce_ms"] = round(time_host_ms(
        lambda: parallel.all_reduce(zeros, mesh.get_group("data")), 3), 1)
    del steps, final, zeros

    # (c) dp x tp = 1 x 2 on the same two ranks, the whole batch on each
    mesh2 = parallel.make_dp_tp_mesh(1, 2)
    tp_state = parallel.shard_state_tp(state0, mesh2, min_dim=512)
    split = parallel.tp_split_dims(p, 2, 512)
    out["tp_split"] = len(split)
    out["tp_conv1"] = list(tp_state.params["mrcnn.mrcnn_class_conv1.weight"].shape)
    del state0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    run = parallel.make_tp_train_step(cfg, mesh2, split, with_masks=True)
    steps, out["tp_ms"] = count(
        "12(c) training",
        lambda: run_steps(run, tp_state, batch, noises),
        {k: v * PARALLEL_STEPS for k, v in STEP_LAUNCHES.items()})
    out["tp_peak_gib"] = round(torch.cuda.max_memory_allocated() / 2**30, 2)
    out["tp_total_loss"] = [float(m["total_loss"]) for _, m in steps]
    dist.destroy_process_group()
    print(json.dumps(out), flush=True)


def parallel_phase(params, card):
    """12: data and tensor parallelism (parallel.py) on the one card.
    Returns the kernels' launches of its paths as the counters read them."""
    t0 = time.perf_counter()
    single_det, launches = parallel_nccl(params, card)
    for k, v in parallel_ranks(params, single_det, card).items():
        launches[k] = launches.get(k, 0) + v
    log(f"phase 12: {time.perf_counter() - t0:.1f} s; launches {launches}")
    return launches


# ---------------------------------------------------------------- phase 13

# (name, bench's arguments, the command that runs them) of 13(b)-(d), each
# at batch 8 with (a)'s timing; (d) goes through the CLI's hand-off
BENCH_RECIPES = (
    ("13(b) bf16", ["--no-int8"], "bench"),
    ("13(c) int8-fused", ["--fused-bottleneck", "--no-per-channel", "--quant-cache", "off"],
     "bench"),
    ("13(d) bf16 boxes", ["--no-masks", "--no-int8"], "odtorch bench"),
)
BENCH_TIMING = ["--iters", "2", "--warmup", "1"]


def bench_launches(argv, calibrated: bool, recorded: bool = False):
    """The kernel launches of one ``bench.main(argv)`` on the card: the
    batches it runs (the first call, the warm-up, t(1), t(1 + iters) and
    the profiled call), each with NMS twice, ROIAlign twice with masks
    (int8 epilogues on the int8 path) or once without, 29 fused blocks on
    the fused path, the int8 conv kernel 125 times on the int8 path (38 on
    the fused one); and with ``calibrated``, each calibration chunk's
    float forward (NMS and ROIAlign at both stages once). With
    ``recorded``, those of one batch and one chunk: the calls
    :func:`run_bench` holds against the plain versions."""
    from objectdetection_torch import bench

    args = bench.build_parser().parse_args(argv)
    cfg = bench.bench_config(args)
    batches = 1 if recorded else 4 + args.warmup + args.iters
    chunks = 0 if not calibrated else 1 if recorded else -(-args.batch
                                                         // max(1, args.batch // 16))
    stages = 1 if args.no_masks else 2
    want = dict.fromkeys(("nms", "roi_align", "roi_align_int8", "fused_block", "anchor_match",
                          "roi_align_backward", "int8_conv"), 0)
    want["nms"] = 2 * batches + chunks
    want["roi_align_int8" if args.int8 else "roi_align"] = stages * batches
    want["roi_align"] += 2 * chunks
    if cfg.fused_bottleneck:
        want["fused_block"] = 29 * batches
    if args.int8:
        want["int8_conv"] = int8_conv_launches(cfg.fused_bottleneck) * batches
    return want


def nth_call_armed(fn, nth: int, flag):
    """``fn``, with ``flag[0]`` true during its ``nth`` call (from 0) only."""
    count = itertools.count()

    def call(*args, **kwargs):
        flag[0] = next(count) == nth
        try:
            return fn(*args, **kwargs)
        finally:
            flag[0] = False
    return call


@contextlib.contextmanager
def patched(owner, name, make):
    """``owner.name`` replaced by ``make(the original)`` inside the block."""
    real = getattr(owner, name)
    setattr(owner, name, make(real))
    try:
        yield
    finally:
        setattr(owner, name, real)


def roi_align_plain_by_rois(args, rois: int = 250):
    """The plain ROIAlign of a recorded call, ``rois`` ROIs an image at a
    time: a ROI's samples depend on its own box and the whole table only, so
    the pieces equal the whole call's rows bit for bit, without the f32
    gathers of 96 images' ROIs at once."""
    import torch

    from objectdetection_torch.ops import roi_align

    feats, boxes, image, crop, out_quant, in_scale = args
    return torch.cat([roi_align.batched_multilevel_roi_align_plain(
        feats, boxes[:, i:i + rois], image, crop, out_quant, in_scale)
        for i in range(0, boxes.shape[1], rois)], 1)


def check_against_plain(name, calls):
    """Every call that recorded_inputs recorded against its plain version on
    the same inputs: NMS, the fused block, f32 ROIAlign and ROIAlign's int8
    epilogues bit-equal (phases 2, 3 and 7), bf16 ROIAlign within
    ``bf16_tolerance`` (phase 3). Logs each shape; returns {kernel row:
    [calls, max |kernel - plain|]}."""
    import torch

    from objectdetection_torch.ops import fused_block, nms, roi_align

    rows, groups, tols = {}, {}, {}
    with torch.inference_mode():
        for kind, args, got in calls:
            if kind in CHECKED_AT_CALL:  # got: whether kernel == plain, at the call
                row, shape = kind, args
            elif kind == "roi_align":
                feats, boxes, _, crop, out_quant, in_scale = args
                row = "roi_align" if out_quant is None and in_scale is None else "roi_align_int8"
                want = roi_align_plain_by_rois(args)
                shape = (f"B={boxes.shape[0]} R={boxes.shape[1]} {crop[0]}x{crop[1]} "
                         f"{str(feats[0].dtype)[6:]} in, {str(got.dtype)[6:]} out")
            elif kind == "nms":
                row, want = "nms", nms.suppress_plain(*args)
                shape = f"B={args[0].shape[0]} N={args[0].shape[1]} -> {args[3]}"
            else:
                row, want = "fused_block", fused_block.fused_identity_block_int8_plain(*args)
                b, h, w, c3 = args[0].shape
                shape = f"B={b} {h}x{w} C3={c3}"
            if kind in CHECKED_AT_CALL and got:
                err = 0.0
            elif kind in CHECKED_AT_CALL:
                fail(f"{name}: {row} {shape}: kernel not bit-equal to plain")
            elif row == "roi_align" and got.dtype == torch.bfloat16:
                err = float((got.float() - want.float()).abs().max())
                tol = roi_align.bf16_tolerance(feats)
                if not err <= tol:
                    fail(f"{name}: roi_align {shape}: max |kernel - plain| {err} > {tol}")
                tols[shape] = min(tols.get(shape, tol), tol)
            elif got.dtype == want.dtype and torch.equal(got, want):
                err = 0.0
            else:
                fail(f"{name}: {row} {shape}: kernel not bit-equal to plain")
            for rec in (rows.setdefault(row, [0, 0.0]), groups.setdefault((row, shape), [0, 0.0])):
                rec[0] += 1
                rec[1] = max(rec[1], err)
    for (row, shape), (n, err) in groups.items():
        log(f"  {row} {shape}: kernel == plain on {n} calls" if err == 0 else
            f"  {row} {shape}: max |kernel - plain| {err:.3g} <= tolerance {tols[shape]:.3g} "
            f"(2^-5 of the largest feature) on {n} calls")
    return rows


def run_bench(name, argv, calibrated, card, tally, errs, states=None, command="bench"):
    """``bench.main(argv)`` (``cli.main(["bench", *argv])`` for ``command``
    'odtorch bench') with the launch counters set to 0 just before and
    checked just after; its stdout must be the one JSON line it returns.
    The kernel calls of the last batch (the profiled one, after the timed
    runs' peak memory is read) and of the first calibration chunk are
    recorded and held against the plain versions; their largest errors go
    into ``errs``. Returns (the line, bench's stderr)."""
    import io

    from objectdetection_torch import bench, cli, detector, quant

    out, err = io.StringIO(), io.StringIO()
    want = bench_launches(argv, calibrated)
    args = bench.build_parser().parse_args(argv)
    batches = 4 + args.warmup + args.iters  # the last is the profiled call
    flag, calls = [False], []
    entry = {"bench": lambda: bench.main(argv), "odtorch bench": lambda: cli.main(["bench"] + argv)}
    keep = (lambda real: lambda *a: states.append(real(*a)) or states[-1]) if states is not None \
        else (lambda real: real)
    with contextlib.ExitStack() as stack:
        stack.enter_context(patched(bench, "serving_state", keep))
        stack.enter_context(patched(detector, "make_infer_fn", lambda real: lambda *a, **k:
                                    nth_call_armed(real(*a, **k), batches - 1, flag)))
        stack.enter_context(patched(quant, "_float_pipeline",
                                    lambda real: nth_call_armed(real, 0, flag)))
        stack.enter_context(recorded_inputs(calls, ("nms", "roi_align", "fused_block",
                                                    "int8_conv"), lambda: flag[0]))
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            t0 = time.perf_counter()
            line = driven(name, entry[command], want, tally)
            wall = time.perf_counter() - t0
    lines = out.getvalue().splitlines()
    if len(lines) != 1 or json.loads(lines[0]) != line:
        fail(f"{name}: stdout {lines!r}, want the one JSON line {line}")
    want_keys = ["metric", "value", "unit", "vs_baseline", "config"]
    if list(line) != want_keys or not line["value"] > 0:
        fail(f"{name}: line {line}")
    for text in err.getvalue().splitlines():
        if "ptxas" not in text and text.strip():
            log(f"  {text}")
    log(f"{name}: `{command} {' '.join(argv)}` {line['value']} images/s ({line['config']}), "
        f"command wall {wall:.1f} s; launches as expected [{card}]")
    rows = check_against_plain(name, calls)
    recorded = {k: v for k, v in bench_launches(argv, calibrated, recorded=True).items() if v}
    if {k: n for k, (n, _) in rows.items()} != recorded:
        fail(f"{name}: recorded {rows}, want the calls {recorded}")
    for k, (_, e) in rows.items():
        errs[k] = max(errs.get(k, 0.0), e)
    return line, err.getvalue()


def bench_phase(card, tally, errs):
    """13(a)-(e): the ``bench`` entry point on the card."""
    import subprocess
    import tempfile

    import torch

    with tempfile.TemporaryDirectory() as tmp:
        cache = f"{tmp}/q"
        states = []
        argv = BENCH_TIMING + ["--quant-cache", cache]
        line, err = run_bench("13(a) int8-default", argv, True, card, tally, errs, states)
        if line["config"] != "int8_ptq_pc_b96" or "int8 artifact saved" not in err:
            fail(f"13(a): config {line['config']}, artifact not saved: {err[-300:]}")
        line, err = run_bench("13(a) again", ["--iters", "1", "--warmup", "0", "--quant-cache",
                                              cache], False, card, tally, errs, states)
        if "int8 artifact loaded from" not in err or "int8 calibration+freeze" in err:
            fail(f"13(a) again: the artifact was not loaded, or it calibrated: {err[-300:]}")
        saved, loaded = states
        if set(saved) != set(loaded) or not all(torch.equal(saved[k], loaded[k])
                                                for k in saved):
            fail("13(a) again: the loaded state differs from the saved one")
        log(f"13(a) again: the loaded state equals the saved one, {len(saved)} leaves "
            f"({sum(v.dtype == torch.int8 for v in saved.values())} int8 kernels)")
    del states, saved, loaded
    for name, extra, command in BENCH_RECIPES:
        argv = ["--batch", "8"] + BENCH_TIMING + extra
        run_bench(name, argv, "--no-int8" not in extra, card, tally, errs, command=command)
    torch.cuda.empty_cache()  # the command below is another process on the card

    cmd = [sys.executable, "-m", "objectdetection_torch.bench", "--batch", "2", "--iters", "1",
           "--warmup", "0", "--quant-cache", "off"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    try:
        line = json.loads(lines[-1]) if proc.returncode == 0 and lines else None
    except json.JSONDecodeError:
        line = None
    if line is None or line.get("config") != "int8_ptq_pc_b2":
        fail(f"13(e): `{' '.join(cmd[1:])}` exit {proc.returncode}, stdout {proc.stdout[-300:]!r}"
             f", stderr {proc.stderr[-600:]!r}")
    log(f"13(e): `python {' '.join(cmd[1:])}` exit 0 in {wall:.1f} s, last line {line}")


def remat_training(card, tally):
    """13(f) first part: ``train-coco --steps 3 --batch 8`` on 10(c)'s mini
    COCO without and with ``--remat``."""
    import tempfile

    import torch

    from objectdetection_torch import cli

    want = {"nms": COCO_STEPS, "anchor_match": COCO_STEPS, "roi_align": COCO_STEPS,
            "roi_align_backward": COCO_STEPS}
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        ann, _ = write_mini_coco(tmp)
        for remat in (False, True):
            argv = ["train-coco", ann, tmp, "--steps", str(COCO_STEPS), "--batch", "8",
                    "--log-every", "100"] + (["--remat"] if remat else [])
            torch.cuda.reset_peak_memory_stats()
            state, record = driven(f"13(f) train-coco{' --remat' if remat else ''}",
                                   lambda: cli.main(argv), want, tally)
            check_train_record("13(f) train-coco", record, COCO_STEPS)
            out[remat] = (after_first_ms(record, COCO_STEPS),
                          torch.cuda.max_memory_allocated() / 2**30,
                          [round(m["total_loss"], 4) for m in record["metrics"]],
                          [round(w, 1) for w in record["wait_ms"][1:]])
    (ms0, peak0, loss0, wait0), (ms1, peak1, loss1, wait1) = out[False], out[True]
    if not peak1 < peak0:
        fail(f"13(f): train-coco --remat peaks at {peak1:.2f} GiB, without {peak0:.2f}")
    log(f"13(f) train-coco --steps {COCO_STEPS} --batch 8 (R101 1024² bf16, boxes only): "
        f"{ms0:.1f} ms a step after the first (the loop waited {wait0} ms for the loader), "
        f"peak {peak0:.2f} GiB; with --remat {ms1:.1f} ms ({100 * (ms1 / ms0 - 1):+.1f}%; "
        f"waited {wait1}), peak {peak1:.2f} GiB ({100 * (peak1 / peak0 - 1):+.1f}%); "
        f"total_loss {loss0} and {loss1} [{card}]")


def remat_f32(params, card, tally):
    """13(f) second part: one f32 step at COCO_CONFIG on phase 6's batch and
    noise (TF32 off, cuDNN deterministic) with and without
    ``remat_backbone``: targets identical, losses equal, every gradient leaf
    and the updated parameters within 6(a)'s bound. Then, both sides warm,
    the losses and gradients timed twice a side in the order with, without,
    without, with, each with its peak above the memory live before it."""
    import torch

    from objectdetection_torch import detector, optim
    from objectdetection_torch.config import COCO_CONFIG
    from objectdetection_torch.convert import split_collections

    device = torch.device("cuda", 0)
    p, stats, _ = split_collections(params)
    batch = train_batch(COCO_CONFIG, device)
    base = COCO_CONFIG.replace(compute_dtype="float32")
    noise = detector.draw_noise(base, batch, torch.Generator(device=device).manual_seed(2))
    runs, times, peaks = {}, {False: [], True: []}, {False: [], True: []}
    torch.backends.cudnn.deterministic = True
    try:
        for remat in (False, True):
            cfg = base.replace(remat_backbone=remat)
            parts, targets, grads = driven(
                f"13(f) f32 losses and gradients{' (remat)' if remat else ''}",
                lambda: losses_and_grads(p, stats, batch, cfg, noise), STEP_LAUNCHES, tally)
            state, _ = driven(
                f"13(f) f32 make_train_step{' (remat)' if remat else ''}",
                lambda: detector.make_train_step(cfg, with_masks=True)(
                    detector.TrainState(p, stats, optim.init(p), 0), batch, noise=noise),
                STEP_LAUNCHES, tally)
            runs[remat] = (parts, targets, grads, state)
        for remat in (True, False, False, True):
            cfg = base.replace(remat_backbone=remat)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            live = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            losses_and_grads(p, stats, batch, cfg, noise)
            torch.cuda.synchronize()
            times[remat].append((time.perf_counter() - t0) * 1e3)
            peaks[remat].append((torch.cuda.max_memory_allocated() - live) / 2**30)
    finally:
        torch.backends.cudnn.deterministic = False
    (parts0, tgt0, grads0, st0), (parts1, tgt1, grads1, st1) = runs[False], runs[True]
    for name, a, b in (("rpn target_class", tgt0[0].target_class, tgt1[0].target_class),
                       ("proposals", tgt0[1], tgt1[1]), ("sampled rois", tgt0[2].rois,
                                                         tgt1[2].rois),
                       ("target_class_ids", tgt0[2].target_class_ids,
                        tgt1[2].target_class_ids),
                       ("target masks", tgt0[2].target_masks, tgt1[2].target_masks)):
        if not torch.equal(a, b):
            fail(f"13(f) f32: {name} differ with remat")
    for k, v in parts0.items():
        if not torch.equal(parts1[k], v):
            fail(f"13(f) f32: {k} {float(parts1[k])} with remat, {float(v)} without")
    worst, worst_name, n_equal = 0.0, "", 0
    for k, g0 in grads0.items():
        g1 = grads1[k]
        n_equal += torch.equal(g0, g1)
        ref = float(torch.linalg.vector_norm(g0))
        err = float(torch.linalg.vector_norm(g1 - g0))
        rel = err / ref if ref > 0 else (0.0 if err == 0 else float("inf"))
        if rel > worst:
            worst, worst_name = rel, k
        if not rel <= GRAD_REL:
            fail(f"13(f) f32: the gradient of {k} moves {rel:.3g} with remat")
    move = max(float(torch.linalg.vector_norm(st1.params[k] - st0.params[k]))
               / max(float(torch.linalg.vector_norm(st0.params[k] - p[k])), 1e-30)
               for k in p)
    if not move <= GRAD_REL:
        fail(f"13(f) f32: the updated parameters lie {move:.3g} of their move apart")
    if not max(peaks[True]) < min(peaks[False]):
        fail(f"13(f) f32: the step peaks at {peaks[True]} GiB with remat, {peaks[False]} "
             "without")
    ms = {k: ", ".join(f"{t:.1f}" for t in v) for k, v in times.items()}
    pk = {k: ", ".join(f"{g:.2f}" for g in v) for k, v in peaks.items()}
    log(f"13(f) f32 step (R101 1024² B={BATCH}, masks, TF32 off, cuDNN deterministic): targets "
        f"and losses identical with and without remat; {n_equal} of {len(grads0)} gradient "
        f"leaves bit-equal, largest gap {worst:.3g} of the leaf's norm ({worst_name or 'none'});"
        f" updated parameters within {move:.3g} of their move; losses and gradients, both sides "
        f"warm (with, without, without, with): without remat {ms[False]} ms, peak {pk[False]} "
        f"GiB above the live memory; with {ms[True]} ms, peak {pk[True]} GiB [{card}]")


def remat_profile(params, card, tally):
    """13(f) last: one bf16 step of make_train_step at COCO_CONFIG on phase
    6's batch, with and without ``remat_backbone``, profiled after a warm
    step of each: host wall, device busy, kernel launches."""
    import torch

    from objectdetection_torch import detector, optim
    from objectdetection_torch.config import COCO_CONFIG
    from objectdetection_torch.convert import split_collections

    device = torch.device("cuda", 0)
    p, stats, _ = split_collections(params)
    batch = train_batch(COCO_CONFIG, device)
    state = detector.TrainState(p, stats, optim.init(p), 0)
    steps = {remat: detector.make_train_step(COCO_CONFIG.replace(remat_backbone=remat),
                                             with_masks=True) for remat in (False, True)}
    one = lambda step: step(state, batch, torch.Generator(device).manual_seed(1))
    for step in steps.values():
        one(step)
    parts = []
    for remat, step in steps.items():
        name = f"13(f) profiled bf16 step{' (remat)' if remat else ''}"
        wall, busy, kernels = driven(name, lambda: profiled_ms(lambda: one(step), name=name),
                                     STEP_LAUNCHES, tally)
        parts.append(f"{'with' if remat else 'without'} remat: wall {wall:.1f} ms, device busy "
                     f"{busy:.1f} ms ({100 * busy / wall:.1f}%), {kernels} kernels")
    log(f"13(f) profiled bf16 step (R101 1024² B={BATCH}, masks): " + "; ".join(parts)
        + f" [{card}]")


def bench_and_remat_phase(params, card):
    """13: the ``bench`` entry point (a)-(e) and ``remat_backbone`` (f).
    Returns the kernels' launches of its paths as the counters read them,
    and each kernel's largest |kernel - plain| over the calls it recorded."""
    t0 = time.perf_counter()
    tally, errs = {}, {}
    bench_phase(card, tally, errs)
    remat_training(card, tally)
    remat_f32(params, card, tally)
    remat_profile(params, card, tally)
    log(f"phase 13: {time.perf_counter() - t0:.1f} s; launches {tally}; recorded calls' largest "
        f"|kernel - plain| {errs}")
    return tally, errs


# ---------------------------------------------------------------- phase 14

ACCURACY_STEPS = 20  # training steps of 14(b)'s checkpoint
ACCURACY_RECIPES = (("default", []), ("per-channel, percentile 90",
                                      ["--per-channel", "--percentile", "90"]))
ACCURACY_ARGV = ["--images", "16", "--calib-images", "8"]
# benchmarks/int8_accuracy.py's keys
JAX_ACCURACY_KEYS = {"float": {"box_mAP@0.5", "mask_mAP@0.5"},
                     "int8": {"box_mAP@0.5", "mask_mAP@0.5"}, "delta": {"box", "mask"}}
STAGE_RECIPES = (("bf16", ["--no-int8"]), ("int8-default", ["--per-channel"]),
                 ("int8-fused", ["--fused-bottleneck"]))
STAGE_ARGV = ["--batch", "8", "--iters", "2"]


def exif_turn(a, orientation: int):
    """``a`` [H, W, C] turned as cv2's IMREAD_COLOR turns it for EXIF
    ``orientation`` (6 is a turn of 90 degrees clockwise), written apart
    from ``image_io``'s own table."""
    import numpy as np

    return {1: lambda: a, 2: lambda: np.fliplr(a), 3: lambda: np.rot90(a, 2),
            4: lambda: np.flipud(a), 5: lambda: a.transpose(1, 0, 2),
            6: lambda: np.rot90(a, -1), 7: lambda: np.rot90(np.fliplr(a), -1),
            8: lambda: np.rot90(a, 1)}[orientation]()


def load_tool(name: str):
    """``tools/<name>.py`` as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def exif_png(png: bytes, orientation: int) -> bytes:
    """``png`` with an ``eXIf`` chunk before its first IDAT: a little-endian
    TIFF block whose IFD0 holds the Orientation tag alone."""
    import struct

    from objectdetection_torch.data import image_io

    tiff = (b"II" + struct.pack("<HIH", 42, 8, 1)
            + struct.pack("<HHIHH", 0x0112, 3, 1, orientation, 0) + bytes(4))
    at = png.index(b"IDAT") - 4
    return png[:at] + image_io._chunk(b"eXIf", tiff) + png[at:]


def post_detect(url: str, body: bytes) -> dict:
    import urllib.request

    req = urllib.request.Request(f"{url}/detect", data=body, method="POST")
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.loads(r.read())


def tagged_requests(server, image, card):
    """9(b) tagged: ``image`` sent to the float server as a PNG tagged with
    EXIF orientation 6 and, turned upright, as an untagged PNG: both
    unmolded at the upright shape (``serve.detect``'s ``image_hw``), both
    answers equal to the direct call on the upright image; NMS twice and
    the box-stage ROIAlign once a request."""
    import numpy as np

    from objectdetection_torch import serve
    from objectdetection_torch.data import image_io
    from objectdetection_torch.data.coco import COCO_CLASS_NAMES

    upright = np.ascontiguousarray(exif_turn(image, 6))
    url = f"http://127.0.0.1:{server.server_address[1]}"
    seen = []
    reset_launch_counts()
    with patched(serve, "detect", lambda real: lambda *a: seen.append(tuple(a[4])) or real(*a)):
        tagged = post_detect(url, exif_png(image_io.encode_png(image), 6))
        untagged = post_detect(url, image_io.encode_png(upright))
    check_launches("float, tagged", launch_counts(), {"nms": 4, "roi_align": 2,
                                                      "roi_align_int8": 0})
    want = answers(server, upright, COCO_CLASS_NAMES)
    if seen != [upright.shape[:2]] * 2:
        fail(f"serving (float, tagged): image_hw {seen}, want {upright.shape[:2]} twice")
    if tagged["detections"] != want or untagged["detections"] != want:
        fail("serving (float, tagged): the tagged PNG's answer, the upright PNG's and the direct "
             "call's differ")
    log(f"serving (float) request of a {image.shape[0]}x{image.shape[1]} PNG tagged with EXIF "
        f"orientation 6: image_hw {seen[0]}, {len(want)} detections == the upright image sent "
        f"untagged == direct call; server latency_ms {tagged['latency_ms']} [{card}]")


def exif_decode(card):
    """14(a): a seeded image as a PNG with an ``eXIf`` chunk for each
    orientation 1-8, decoded with the C row unfilter (``native=True``, the
    server's on the card): each equal, bit for bit and in shape, to the
    untagged decode turned by the tag's numpy flip or transpose."""
    import numpy as np

    from objectdetection_torch.data import image_io

    img = np.random.RandomState(14).randint(0, 256, (333, 500, 3)).astype(np.uint8)
    png = image_io.encode_png(img)
    plain = image_io.decode_image(png, native=True)
    if not np.array_equal(plain, img):
        fail("14(a): the untagged PNG does not decode bit-exact")
    shapes = []
    for orientation in range(1, 9):
        t0 = time.perf_counter()
        got = image_io.decode_image(exif_png(png, orientation), native=True)
        ms = (time.perf_counter() - t0) * 1e3
        want = exif_turn(plain, orientation)
        if got.shape != want.shape or not np.array_equal(got, want):
            fail(f"14(a): orientation {orientation} decodes at {got.shape}, not as the numpy "
                 f"turn of the untagged decode ({want.shape})")
        shapes.append(f"{orientation}: {got.shape[0]}x{got.shape[1]} {ms:.1f} ms")
    log(f"14(a) EXIF orientation on the card's decode path (333x500 PNG, C unfilter): every tag "
        f"== the numpy turn of the untagged decode; {'; '.join(shapes)} (host) [{card}]")


def accuracy_launches(tool, argv):
    """The kernel launches of one ``torch_int8_accuracy.main(argv)``: each
    evaluation batch of 8 NMS twice and ROIAlign at both stages (the int8
    epilogues on the int8 state), each calibration chunk of 4 NMS once and
    the float ROIAlign at both stages."""
    args = tool.build_parser().parse_args(argv)
    batches, chunks = -(-args.images // 8), -(-args.calib_images // 4)
    return {"nms": 4 * batches + chunks, "roi_align": 2 * batches + 2 * chunks,
            "roi_align_int8": 2 * batches, "fused_block": 0, "anchor_match": 0,
            "roi_align_backward": 0}


def accuracy_phase(card, tally, errs):
    """14(b): ``cli train --steps 20 --batch 8 --masks --ckpt D``, then the
    int8 accuracy tool on D at each of ACCURACY_RECIPES: JAX's JSON keys on
    its one stdout document, its float mAP@0.5 equal to
    ``cli.evaluate_on_shapes`` called directly on the checkpoint's state,
    every NMS and ROIAlign call held against its plain version. The deltas
    are printed, not gated."""
    import io
    import tempfile

    from objectdetection_torch import checkpoint, cli, detector
    from objectdetection_torch.data.shapes import ShapesDataset

    tool = load_tool("torch_int8_accuracy")
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = f"{tmp}/shapes_ckpt"
        argv = ["train", "--steps", str(ACCURACY_STEPS), "--batch", "8", "--masks", "--ckpt",
                ckpt, "--log-every", "100"]
        n = ACCURACY_STEPS
        driven("14(b) train", lambda: cli.main(argv), {
            "nms": n, "anchor_match": n, "roi_align": 2 * n, "roi_align_backward": 2 * n}, tally)
        direct = None
        for name, extra in ACCURACY_RECIPES:
            targv = ["--ckpt", ckpt, *ACCURACY_ARGV, *extra]
            calls, out, err = [], io.StringIO(), io.StringIO()
            with recorded_inputs(calls, ("nms", "roi_align")), \
                    contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
                t0 = time.perf_counter()
                res = driven(f"14(b) {name}", lambda: tool.main(targv),
                             accuracy_launches(tool, targv), tally)
                wall = time.perf_counter() - t0
            if json.loads(out.getvalue()) != res:
                fail(f"14(b) {name}: stdout {out.getvalue()[-300:]!r} is not the JSON it returned")
            if set(res) != set(JAX_ACCURACY_KEYS) or any(
                    not keys <= set(res[k]) for k, keys in JAX_ACCURACY_KEYS.items()) or \
                    set(res["delta"]) != JAX_ACCURACY_KEYS["delta"]:
                fail(f"14(b) {name}: keys {({k: sorted(v) for k, v in res.items()})}")
            if direct is None:
                args = tool.build_parser().parse_args(targv)
                cfg = tool.float_config(args)
                state = checkpoint.load_checkpoint(ckpt, detector.create_train_state(
                    cfg, device=args.device))
                ds = ShapesDataset(args.images, 128, 128, seed=args.seed + 1000)
                direct = cli.evaluate_on_shapes({**state.params, **state.batch_stats}, cfg, ds,
                                                list(range(args.images)), score_threshold=0.5,
                                                with_masks=True, device=args.device)
                del state
            if (res["float"]["box_mAP@0.5"], res["float"]["mask_mAP@0.5"]) != (
                    direct["mAP"], direct["mask_mAP"]):
                fail(f"14(b) {name}: float {res['float']}, evaluate_on_shapes called directly "
                     f"{direct['mAP']}, {direct['mask_mAP']}")
            rows = check_against_plain(f"14(b) {name}", calls)
            for k, (_, e) in rows.items():
                errs[k] = max(errs.get(k, 0.0), e)
            log(f"14(b) int8 accuracy ({name}; `tools/torch_int8_accuracy.py --ckpt D "
                f"{' '.join(ACCURACY_ARGV + extra)}` on the {n}-step checkpoint) in {wall:.1f} s: "
                f"float {res['float']}, int8 {res['int8']}, delta {res['delta']} (printed, not "
                f"gated); float == evaluate_on_shapes called directly; recorded calls "
                f"{({k: v[0] for k, v in rows.items()})} == plain [{card}]")


def stage_launches(tool, argv, recorded: bool = False):
    """The kernel launches of one ``torch_stage_time.main(argv)``: the
    full-prefix check (the prefix and ``make_infer_fn``, each NMS twice,
    ROIAlign at both stages, 29 fused blocks on the fused path), the int8
    calibration (``bench``'s chunks: NMS once and the float ROIAlign at both
    stages each), then 4 + iters calls of each prefix (NMS from
    +proposals and again from +detection, ROIAlign from +box_head and again
    at +masks, the fused blocks in every prefix). With ``recorded``, those
    of the check and of the first calibration chunk."""
    from objectdetection_torch import bench

    args = tool.build_parser().parse_args(argv)
    cfg = bench.bench_config(tool.bench_args(args))
    depths = [int(x) for x in args.stages.split(",")] if args.stages else range(5)
    calls = 0 if recorded else 4 + args.iters
    chunks = -(-args.batch // max(1, args.batch // 16)) if cfg.quantized_inference else 0
    chunks = min(chunks, 1) if recorded else chunks
    want = dict.fromkeys(("nms", "roi_align", "roi_align_int8", "fused_block", "anchor_match",
                          "roi_align_backward"), 0)
    want["nms"] = 4 + chunks + calls * sum((d >= 1) + (d >= 3) for d in depths)
    want["roi_align_int8" if cfg.quantized_inference else "roi_align"] = 4 + calls * sum(
        (d >= 2) + (d >= 4) for d in depths)
    want["roi_align"] += 2 * chunks
    if cfg.fused_bottleneck:
        want["fused_block"] = 29 * (2 + calls * len(depths))
    return want


def stage_phase(card, tally, errs):
    """14(c): the stage tool at batch 8 for each of STAGE_RECIPES: five
    lines in pipeline_breakdown.py's format after its full prefix equals
    ``make_infer_fn``; the NMS, ROIAlign and fused-block calls of that check
    and of the first calibration chunk held against the plain versions."""
    import io

    import torch

    from objectdetection_torch import quant

    tool = load_tool("torch_stage_time")
    for name, extra in STAGE_RECIPES:
        argv = STAGE_ARGV + extra
        flag, calls, out, err = [False], [], io.StringIO(), io.StringIO()
        with contextlib.ExitStack() as stack:
            stack.enter_context(patched(tool, "check_full_prefix",
                                        lambda real: nth_call_armed(real, 0, flag)))
            stack.enter_context(patched(quant, "_float_pipeline",
                                        lambda real: nth_call_armed(real, 0, flag)))
            stack.enter_context(recorded_inputs(calls, ("nms", "roi_align", "fused_block"),
                                                lambda: flag[0]))
            with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
                t0 = time.perf_counter()
                res = driven(f"14(c) {name}", lambda: tool.main(argv),
                             stage_launches(tool, argv), tally)
                wall = time.perf_counter() - t0
        lines = out.getvalue().splitlines()
        if [line.split()[0] for line in lines] != list(tool.NAMES) or len(res["stages"]) != 5 \
                or "full prefix == make_infer_fn" not in err.getvalue():
            fail(f"14(c) {name}: stdout {lines}, stderr {err.getvalue()[-400:]!r}")
        rows = check_against_plain(f"14(c) {name}", calls)
        recorded = {k: v for k, v in stage_launches(tool, argv, recorded=True).items() if v}
        if {k: n for k, (n, _) in rows.items()} != recorded:
            fail(f"14(c) {name}: recorded {rows}, want the calls {recorded}")
        for k, (_, e) in rows.items():
            errs[k] = max(errs.get(k, 0.0), e)
        for text in err.getvalue().splitlines():
            if "ptxas" not in text and text.strip():
                log(f"  {text}")
        log(f"14(c) stage time ({name}; `tools/torch_stage_time.py {' '.join(argv)}`, "
            f"{res['config']}) in {wall:.1f} s; full prefix == make_infer_fn; recorded calls "
            f"{({k: v[0] for k, v in rows.items()})} == plain [{card}]")
        for line in lines:
            log(f"  {line}")
        del calls
        torch.cuda.empty_cache()


def examples_phase(card):
    """14(d): the two examples as subprocesses with ``--device cuda``: the
    quickstart prints 5 finite losses and a line an image; the RPN-target
    PNG decodes at 128x128 and its counts equal the same script's with
    ``--device cpu``."""
    import math
    import re
    import tempfile

    import torch

    from objectdetection_torch.data.image_io import decode_image

    torch.cuda.empty_cache()  # the examples are other processes on the card

    def run(name, *args):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, str(ROOT / "examples" / name), *args], cwd=ROOT,
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            fail(f"14(d): `{name} {' '.join(args)}` exit {proc.returncode}: "
                 f"{proc.stderr[-800:]}")
        return proc.stdout.splitlines(), time.perf_counter() - t0

    lines, wall = run("torch_quickstart.py", "--device", "cuda")
    losses = [re.fullmatch(rf"step {i}: total_loss=(\S+)", line)
              for i, line in enumerate(lines[:5])]
    images = [re.fullmatch(rf"image {b}: \d+ detections, mask grid \(28, 28\) each", line)
              for b, line in enumerate(lines[5:])]
    if len(lines) != 7 or not all(losses) or not all(images) or not all(
            math.isfinite(float(m.group(1))) for m in losses):
        fail(f"14(d) quickstart: {lines}")
    log(f"14(d) `examples/torch_quickstart.py --device cuda` exit 0 in {wall:.1f} s: "
        f"{'; '.join(lines)} [{card}]")
    counts = {}
    with tempfile.TemporaryDirectory() as tmp:
        for dev in ("cuda", "cpu"):
            out = f"{tmp}/rpn_{dev}.png"
            lines, wall = run("torch_visualize_rpn_targets.py", "--device", dev, "--out", out)
            m = re.fullmatch(rf"wrote {re.escape(out)}: (\d+) positive, (\d+) negative anchors",
                             lines[-1] if lines else "")
            with open(out, "rb") as f:
                shape = decode_image(f.read()).shape
            if m is None or shape != (128, 128, 3):
                fail(f"14(d) rpn targets ({dev}): {lines}, PNG {shape}")
            counts[dev] = (int(m.group(1)), int(m.group(2)))
            log(f"14(d) `examples/torch_visualize_rpn_targets.py --device {dev}` exit 0 in "
                f"{wall:.1f} s: {counts[dev][0]} positive, {counts[dev][1]} negative anchors, "
                f"PNG {shape}")
    if counts["cuda"] != counts["cpu"]:
        fail(f"14(d) rpn targets: counts {counts['cuda']} on the card, {counts['cpu']} on the CPU")


def last_slice_phase(card):
    """14: EXIF orientation (a; its server part runs in phase 9(b)), the
    int8 accuracy tool (b), the stage tool (c) and the examples (d).
    Returns the kernels' launches of its paths as the counters read them,
    and each kernel's largest |kernel - plain| over the calls it recorded."""
    t0 = time.perf_counter()
    tally, errs = {}, {}
    exif_decode(card)
    accuracy_phase(card, tally, errs)
    stage_phase(card, tally, errs)
    examples_phase(card)
    log(f"phase 14: {time.perf_counter() - t0:.1f} s; launches {tally}; recorded calls' largest "
        f"|kernel - plain| {errs}")
    return tally, errs


# ---------------------------------------------------------------- main


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs an NVIDIA GPU")
    if not (ROOT / "objectdetection_torch" / "csrc").is_dir():
        fail(f"objectdetection_torch/ not found beside {Path(__file__).name}: "
             "run from a checkout of the repository")
    sys.path.insert(0, str(ROOT))
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    t_start = time.perf_counter()

    card = card_and_build()
    nms_rec = nms_phase(device)
    roi_rec = roi_phase(device)
    params = end_to_end(device)
    match_rec = match_phase(device)
    back_rec = roi_backward_phase(device)
    launches = training(params, device)
    block_rec = fused_block_phase(device)
    conv8_rec = int8_conv_phase(device)
    roi8_rec = roi_int8_phase(device)
    served = int8_serving(device)
    launches["fused_block"] = served["int8-fused"]["launches"]["fused_block"]
    launches["int8_conv"] = sum(v["launches"]["int8_conv"] for v in served.values())
    launches["roi_align_int8"] = served["int8-default"]["launches"]["roi_align_int8"]
    probe_recs, probe_launches = probe_phase(device)
    launches.update(probe_launches)
    serving_phase(device, card)
    training_phase(device, card)
    families_phase(device, card)
    for k, v in parallel_phase(params, card).items():
        launches[k] += v
    bench_launches_, bench_errs = bench_and_remat_phase(params, card)
    for k, v in bench_launches_.items():
        launches[k] += v
    slice_launches, slice_errs = last_slice_phase(card)
    for k, v in slice_launches.items():
        launches[k] += v
    for k, v in slice_errs.items():
        bench_errs[k] = max(bench_errs.get(k, 0.0), v)

    kernels = []
    for name, rec, source, replaces in (
        ("nms", nms_rec, "objectdetection_torch/csrc/nms.cu",
         "objectdetection_tpu/ops/nms_pallas.py:70"),
        ("roi_align", roi_rec, "objectdetection_torch/csrc/roi_align.cu",
         "objectdetection_tpu/ops/roi_align_pallas.py:104"),
        ("roi_align_backward", back_rec, "objectdetection_torch/csrc/roi_align.cu",
         "objectdetection_tpu/ops/roi_align.py:213"),
        ("anchor_match", match_rec, "objectdetection_torch/csrc/anchor_match.cu",
         "objectdetection_tpu/ops/anchor_match.py:47"),
        ("roi_align_int8", roi8_rec, "objectdetection_torch/csrc/roi_align.cu",
         "objectdetection_tpu/ops/roi_align_pallas.py:104"),
        ("fused_block", block_rec, "objectdetection_torch/csrc/fused_block.cu",
         "objectdetection_tpu/ops/fused_block.py:98"),
        ("int8_conv", conv8_rec, "objectdetection_torch/csrc/int8_conv.cu",
         "none: XLA's int8 conv (objectdetection_tpu/quant.py:15)"),
        ("patch_dma_probe", probe_recs["patch_dma_probe"],
         "objectdetection_torch/csrc/roi_probes.cu", "benchmarks/patch_dma_probe.py:30"),
        ("roi_inner_probe", probe_recs["roi_inner_probe"],
         "objectdetection_torch/csrc/roi_probes.cu", "benchmarks/roi_inner_probe.py:39"),
        ("roi_dispatch_probe", probe_recs["roi_dispatch_probe"],
         "objectdetection_torch/csrc/roi_probes.cu", "benchmarks/roi_dispatch_probe.py:61"),
    ):
        bytes_ms, ops_ms = rec["bytes_ms"], rec["ops_ms"]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": max(rec["max_abs_err"], bench_errs.get(name, 0.0)),
            "ms": rec["ms"],
            "plain_ms": rec["plain_ms"],
            "bound_ms": rec.get("bound_ms", max(bytes_ms, ops_ms)),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": rec.get("library_ms"),
        })
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--parallel-rank"]:
        parallel_rank(int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]))
    else:
        main()
