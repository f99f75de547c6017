"""Command-line interface of the port.

    python -m objectdetection_torch.cli demo [--num-images 2] [--out-prefix demo_]
    python -m objectdetection_torch.cli train [--steps 20] [--batch 2] [--masks] [...]
    python -m objectdetection_torch.cli infer IMAGE... [--weights H5] [--no-masks]
    python -m objectdetection_torch.cli train-coco ANNOTATIONS IMAGE_DIR [...]
    python -m objectdetection_torch.cli eval-coco ANNOTATIONS IMAGE_DIR [...]
    python -m objectdetection_torch.cli quantize --out DIR [--config shapes|coco] [...]
    python -m objectdetection_torch.cli serve [--port 8000] [--quant DIR]
    python -m objectdetection_torch.cli bench [--batch 96] [--no-int8] [...]

(or ``odtorch ...`` once the package is installed). The flags are those of
the JAX package's ``odtpu``, plus ``--device`` (default ``cuda``; the
commands raise without a card unless given ``--device cpu``), with two
differences: ``quantize`` takes no ``--train-steps``, ``--lr`` or
``--lr-schedule`` (JAX reads them only to rebuild the optimizer state its
checkpoint restore needs, and a port checkpoint carries its own);
``train --resume`` and ``quantize --ckpt`` read the port's own checkpoints.
``bench`` hands the rest of its line to :func:`objectdetection_torch.bench.main`
(``python -m objectdetection_torch.bench``), which takes ``bench.py``'s
flags and ``--device``. ``train-coco --remat`` recomputes the backbone's
blocks in the backward pass (``remat_backbone``). ``eval-coco
--data-parallel`` shards each batch over the processes of a launch
(``parallel.py``): ``torchrun --nproc_per_node N -m objectdetection_torch.cli
eval-coco ... --data-parallel`` spans N ranks (NCCL, one card each); a plain
run is a world of one. Each
command is a function of a config and a device (:func:`run_train`,
:func:`run_demo`, :func:`run_infer`, :func:`run_train_coco`,
:func:`run_eval_coco`, :func:`run_quantize`) wrapped by its ``cmd_*``,
which fixes the config as JAX's command does (``SHAPES_CONFIG`` for
``demo`` and ``train``, ``COCO_CONFIG`` for the rest); :func:`main` returns
what the command's function returns.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Callable, List, Optional


def _to_device(params, dev):
    return {k: v.to(dev) for k, v in params.items()}


def run_demo(config, num_images: int = 2, seed: int = 0, out_prefix: str = "demo_",
             device="cuda"):
    """Inference on ``num_images`` synthetic shapes images (``init_params``
    seed ``seed``); writes ``<out_prefix><i>.png`` with the
    detections and masks drawn. Returns one dict per image: ``out``,
    ``boxes`` (pixels), ``class_ids``, ``scores``."""
    import numpy as np
    import torch

    from objectdetection_torch import detector, viz
    from objectdetection_torch.convert import init_params, resolve_device
    from objectdetection_torch.data.image_io import encode_png
    from objectdetection_torch.data.shapes import CLASS_NAMES, ShapesDataset

    dev = resolve_device(device)
    print("initializing model (shapes config)...", file=sys.stderr)
    params = _to_device(init_params(config, torch.Generator().manual_seed(seed), device="cpu"),
                        dev)
    h, w = config.image_shape[:2]
    ds = ShapesDataset(num_images, h, w, seed=seed)
    batch = ds.load_batch(list(range(num_images)), config, with_masks=False)
    windows = np.tile(np.array([[0.0, 0.0, h, w]], np.float32), (num_images, 1))
    infer = detector.make_infer_fn(config, with_masks=True, device=dev)
    t0 = time.time()
    det = infer(params, batch.images, windows)
    boxes = det.boxes.float().cpu().numpy()
    print(f"inference: {time.time() - t0:.1f}s", file=sys.stderr)
    valid_all, cls_all = det.valid.cpu().numpy(), det.class_ids.cpu().numpy()
    scores_all, masks_all = det.scores.float().cpu().numpy(), det.masks.float().cpu().numpy()
    scale = np.array([h - 1, w - 1, h - 1, w - 1], np.float32)
    results = []
    for i in range(num_images):
        valid = valid_all[i]
        pix = boxes[i][valid] * scale + np.array([0, 0, 1, 1], np.float32)
        img = viz.draw_detections(ds.image(i), pix, cls_all[i][valid], scores_all[i][valid],
                                  class_names=CLASS_NAMES, masks=masks_all[i][valid])
        out = f"{out_prefix}{i}.png"
        with open(out, "wb") as f:
            f.write(encode_png(img))
        print(f"wrote {out} ({int(valid.sum())} detections)")
        results.append(dict(out=out, boxes=pix, class_ids=cls_all[i][valid],
                            scores=scores_all[i][valid]))
    print("demo ok")
    return results


def evaluate_on_shapes(params, cfg, ds, image_ids, score_threshold=None, with_masks=False,
                       device="cuda", iou_thresholds=(0.5,)):
    """Inference on shapes images in batches of 8: box mAP@0.5 (and mask
    mAP@0.5 with ``with_masks``, the masks pasted at the image's size); or
    each averaged over a sweep of ``iou_thresholds``, beside the box and
    mask mAP@0.5 of the same pass (``AP50``, ``mask_AP50``). ``params`` is
    the whole state dict on ``device``."""
    import numpy as np

    from objectdetection_torch import detector
    from objectdetection_torch.convert import resolve_device
    from objectdetection_torch.data.masks import paste_detection_masks
    from objectdetection_torch.evaluate import DetectionEvaluator

    dev = resolve_device(device)
    eval_cfg = cfg if score_threshold is None else cfg.replace(
        detection_min_threshold=score_threshold)
    infer = detector.make_infer_fn(eval_cfg, with_masks=with_masks, device=dev)
    ev = DetectionEvaluator(cfg.num_classes, iou_thresholds=iou_thresholds)
    ev_mask = (DetectionEvaluator(cfg.num_classes, iou_thresholds=iou_thresholds, use_masks=True)
               if with_masks else None)
    h = cfg.image_shape[0]
    scale = np.array([h - 1, h - 1, h - 1, h - 1], np.float32)
    shift = np.array([0, 0, 1, 1], np.float32)
    for start in range(0, len(image_ids), 8):
        ids = image_ids[start: start + 8]
        batch = ds.load_batch(ids, cfg, with_masks=with_masks)
        windows = np.tile(np.array([[0.0, 0.0, h, h]], np.float32), (len(ids), 1))
        det = infer(params, batch.images, windows)
        boxes, cls = det.boxes.float().cpu().numpy(), det.class_ids.cpu().numpy()
        scores, valid_all = det.scores.float().cpu().numpy(), det.valid.cpu().numpy()
        masks = det.masks.float().cpu().numpy() if with_masks else None
        for bi in range(len(ids)):
            valid = valid_all[bi]
            gt_valid = batch.gt_class_ids[bi] > 0
            ev.add_image(boxes[bi][valid], cls[bi][valid], scores[bi][valid],
                         batch.gt_boxes[bi][gt_valid], batch.gt_class_ids[bi][gt_valid])
            if ev_mask is not None:
                pix_boxes = boxes[bi][valid] * scale + shift
                pred_masks = paste_detection_masks(masks[bi][valid], pix_boxes, (h, h))
                ev_mask.add_image(
                    pix_boxes, cls[bi][valid], scores[bi][valid],
                    batch.gt_boxes[bi][gt_valid] * scale + shift,
                    batch.gt_class_ids[bi][gt_valid],
                    pred_masks=pred_masks, gt_masks=batch.gt_masks[bi][gt_valid] > 0.5)
    out = ev.evaluate()
    if ev_mask is not None:
        masks = ev_mask.evaluate()
        out["mask_mAP"] = masks["mAP"]
        if list(iou_thresholds) != [0.5] and "AP50" in masks:
            out["mask_AP50"] = masks["AP50"]
    return out


def train_config(base, steps: int, post_nms: Optional[int] = 256, lr: float = 0.001,
                 lr_schedule: str = "constant"):
    """``base`` with a run's optimizer settings: the learning rate, its
    schedule, JAX's warm-up rule ``max(steps // 20, 10)`` and ``steps``;
    and, unless ``post_nms`` is None, that post-NMS budget (the pre-NMS
    count cut to 8× it), as ``train`` sets them."""
    cfg = base.replace(learning_rate=lr, lr_schedule=lr_schedule,
                       warmup_steps=max(steps // 20, 10), total_train_steps=steps)
    if post_nms is not None:
        cfg = cfg.replace(
            post_nms_rois_training=post_nms,
            post_nms_rois_inference=min(base.post_nms_rois_inference, post_nms),
            pre_nms_rois_count=min(base.pre_nms_rois_count, 8 * post_nms),
        )
    return cfg


def _initial_state(config, seed, train_layers, dev, weights=None, resume=None,
                   strict=True):
    """A train state on ``dev``: ``init_params`` seed ``seed``, then the
    checkpoint ``resume``, then the h5 ``weights`` (the heads left random
    with ``train_layers="heads"``), as JAX orders them."""
    import torch

    from objectdetection_torch import checkpoint, detector

    state = detector.create_train_state(config, torch.Generator().manual_seed(seed),
                                        train_layers=train_layers, device=dev)
    if resume:
        state = checkpoint.load_checkpoint(resume, state)
        print(f"resumed from {resume} at step {state.step}")
    if weights:
        merged = checkpoint.load_matterport_h5(
            weights, {**state.params, **state.batch_stats},
            skip_layers=checkpoint.HEADS_LAYERS if train_layers == "heads" else None,
            strict=strict)
        state = state._replace(params={k: merged[k] for k in state.params},
                               batch_stats={k: merged[k] for k in state.batch_stats})
    return state


def _train_loop(step_fn, state, make_batch, steps: int, dev, log_every: int, noise=None,
                eval_every: int = 0, evaluate=None):
    """Steps ``state.step`` .. ``steps - 1`` on batches that ``make_batch(i)``
    builds on the host, ``i`` counted from the first step, on a
    :class:`~objectdetection_torch.data.prefetch.Prefetcher` thread; each
    batch goes to ``dev`` on this thread, inside ``step_fn``. A step's
    target noise comes from ``torch.Generator(dev).manual_seed(step)`` (JAX's
    ``PRNGKey(step)``), or from ``noise(step, host_batch)``. Every
    ``eval_every`` steps, ``evaluate(step, state)``. On a card the loop
    waits for the device after the first step and before each evaluation,
    so that ``first_seconds`` (the first step) and ``eval_seconds`` hold
    their own device work. Returns (state, the run's record)."""
    import torch

    from objectdetection_torch.data.prefetch import Prefetcher

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    start = state.step
    loader_ms: List[float] = []

    def timed(i):
        t0 = time.perf_counter()
        batch = make_batch(i)
        loader_ms.append((time.perf_counter() - t0) * 1e3)
        return batch

    sync()
    pf = Prefetcher(timed, num_steps=max(steps - start, 0), depth=2)
    raw, wait_ms, evals, eval_s, first_s = [], [], [], 0.0, 0.0
    t_start = time.perf_counter()
    try:
        for step in range(start, steps):
            t0 = time.perf_counter()
            batch = pf.get()
            wait_ms.append((time.perf_counter() - t0) * 1e3)
            if noise is None:
                state, metrics = step_fn(state, batch,
                                         torch.Generator(device=dev).manual_seed(step))
            else:
                state, metrics = step_fn(state, batch, noise=noise(step, batch))
            raw.append(metrics)
            if step % log_every == 0 or step == steps - 1:
                vals = {k: round(float(v), 4) for k, v in metrics.items()}
                print(f"step {step}: {vals}", flush=True)
            if step == start:
                sync()
                first_s = time.perf_counter() - t_start
            if evaluate is not None and eval_every and (step + 1) % eval_every == 0:
                sync()
                t0 = time.perf_counter()
                evals.append((step, evaluate(step, state)))
                eval_s += time.perf_counter() - t0
    finally:
        pf.close()
    sync()
    seconds = time.perf_counter() - t_start
    metrics = [{k: float(v) for k, v in m.items()} for m in raw]
    return state, dict(metrics=metrics, evals=evals, loader_ms=loader_ms, wait_ms=wait_ms,
                       seconds=seconds, first_seconds=first_s, eval_seconds=eval_s,
                       first_step=start)


def run_train(config, steps: int = 20, batch: int = 2, dataset_size: int = 64,
              masks: bool = False, seed: int = 0, log_every: int = 5, ckpt: str = "",
              eval_every: int = 0, eval_images: int = 16, eval_score_threshold=0.5,
              eval_masks: bool = False, train_layers: str = "all",
              weights: Optional[str] = None, resume: Optional[str] = None, device="cuda",
              noise: Optional[Callable] = None):
    """Train on the synthetic shapes dataset (images of ``config.image_shape``)
    up to step ``steps``: from ``init_params`` seed ``seed``, the checkpoint
    ``resume`` and the h5 ``weights``. Step ``step`` trains on ``batch``
    images drawn by ``RandomState(seed * 1000003 + step)`` from
    ``dataset_size``, so that a resumed run continues the same sequence.
    ``eval_every`` steps, box (and with ``eval_masks`` mask) mAP@0.5 on
    ``eval_images`` held-out images (seed ``seed + 999``). The checkpoint
    goes to ``ckpt``. ``config`` carries the optimizer settings
    (:func:`train_config`). ``noise(step, host_batch)`` replaces the step's
    generator. Returns (final state, the run's record: per-step metrics,
    evaluations, loader ms per batch on the prefetch thread, ms waited for
    each batch, the loop's seconds, those of its first step and those of
    its evaluations)."""
    import numpy as np

    from objectdetection_torch import checkpoint, detector
    from objectdetection_torch.convert import resolve_device
    from objectdetection_torch.data.shapes import ShapesDataset

    dev = resolve_device(device)
    h, w = config.image_shape[:2]
    ds = ShapesDataset(dataset_size, h, w, seed=seed)
    holdout = ShapesDataset(eval_images, h, w, seed=seed + 999)
    state = _initial_state(config, seed, train_layers, dev, weights, resume)
    step_fn = detector.make_train_step(config, with_masks=masks, train_layers=train_layers,
                                       device=dev)
    start = state.step

    def make_batch(i):
        r = np.random.RandomState(seed * 1000003 + start + i)
        ids = r.randint(0, dataset_size, batch).tolist()
        return ds.load_batch(ids, config, with_masks=masks)

    def evaluate(step, st):
        res = evaluate_on_shapes({**st.params, **st.batch_stats}, config, holdout,
                                 list(range(eval_images)), score_threshold=eval_score_threshold,
                                 with_masks=eval_masks, device=dev)
        mask_part = f" mask mAP@0.5 = {res['mask_mAP']:.4f}" if "mask_mAP" in res else ""
        print(f"step {step}: eval mAP@0.5 = {res['mAP']:.4f}{mask_part} "
              f"per-class {res['per_class']}", flush=True)
        return res

    state, record = _train_loop(step_fn, state, make_batch, steps, dev, log_every, noise,
                                eval_every, evaluate)
    if ckpt:
        checkpoint.save_checkpoint(ckpt, state)
        print(f"saved checkpoint to {ckpt}")
    return state, record


def run_infer(paths: List[str], config, device="cuda", weights: Optional[str] = None,
              with_masks: bool = True, class_names=None, params=None):
    """Detect objects in image files and write ``<name>_det.png`` beside
    each. ``params`` defaults to ``init_params`` seed 0 (or the h5
    ``weights``). Returns one dict per image read: ``path``, ``out``,
    ``boxes`` [N, 4] source pixels, ``class_ids``, ``scores`` and ``masks``
    ([N, mh, mw] soft masks, or None)."""
    import torch

    from objectdetection_torch import checkpoint, detector, viz
    from objectdetection_torch.convert import init_params, resolve_device
    from objectdetection_torch.data.coco import COCO_CLASS_NAMES
    from objectdetection_torch.data.image_io import ImageDecodeError, decode_image, encode_png
    from objectdetection_torch.data.preprocess import mold_image_host
    from objectdetection_torch.serve import detect

    dev = resolve_device(device)
    if class_names is None:
        class_names = COCO_CLASS_NAMES
    if params is None:
        params = init_params(config, torch.Generator().manual_seed(0), device="cpu")
        if weights:
            print(f"loading weights from {weights}", file=sys.stderr)
            params = checkpoint.load_matterport_h5(weights, params)
    params = {k: v.to(dev) for k, v in params.items()}
    infer = detector.make_infer_fn(config, with_masks=with_masks, device=dev)
    results = []
    for path in paths:
        try:
            with open(path, "rb") as f:
                rgb = decode_image(f.read(), native=dev.type == "cuda")
        except (OSError, ImageDecodeError) as exc:
            print(f"cannot read {path}: {exc}", file=sys.stderr)
            continue
        molded, window, _ = mold_image_host(rgb, config)
        boxes, class_ids, scores, masks = detect(infer, params, molded, window, rgb.shape[:2],
                                                 config)
        print(f"{path}: {len(scores)} detections")
        img = viz.draw_detections(rgb, boxes, class_ids, scores, class_names=class_names,
                                  masks=masks)
        out = path.rsplit(".", 1)[0] + "_det.png"
        with open(out, "wb") as f:
            f.write(encode_png(img))
        print(f"wrote {out}")
        results.append(dict(path=path, out=out, boxes=boxes, class_ids=class_ids,
                            scores=scores, masks=masks))
    return results


def quantize_config(base, per_channel: bool = True, post_nms: int = 0):
    """The quantized config ``quantize`` calibrates: ``base`` with
    ``quantized_inference`` and ``per_channel_acts``, and the post-NMS
    budget of a training run with ``post_nms``."""
    cfg = base.replace(quantized_inference=True, per_channel_acts=per_channel)
    if post_nms:
        cfg = cfg.replace(
            post_nms_rois_training=post_nms,
            post_nms_rois_inference=min(cfg.post_nms_rois_inference, post_nms),
            pre_nms_rois_count=min(cfg.pre_nms_rois_count, 8 * post_nms),
        )
    return cfg


def run_quantize(out: str, config, device="cuda", ckpt: Optional[str] = None,
                 weights: Optional[str] = None, calib_images: int = 64, batch_size: int = 4,
                 percentile: Optional[float] = 90.0, seed: int = 0,
                 calibration: str = "random"):
    """Calibrate and freeze the int8 serving state of the quantized
    ``config`` and save it to ``out`` (with ``quant_meta.json``). The float
    weights are a port checkpoint (``ckpt``), or an h5 (``weights``), or
    ``init_params`` seed 0. Calibration runs on ``calib_images`` images
    drawn from ``seed``: with ``calibration="shapes"`` the molded images of
    a shapes dataset of ``config.image_shape``, else random pixel-scale
    images ``rand·255 − 128``; in chunks of ``batch_size``, at
    ``percentile`` (negative or None: running absmax). Returns the frozen
    state dict (on ``device``)."""
    import numpy as np
    import torch

    from objectdetection_torch import checkpoint, detector, quant
    from objectdetection_torch.convert import init_params, resolve_device

    dev = resolve_device(device)
    params = init_params(config, torch.Generator().manual_seed(0), device="cpu")
    if ckpt:
        # a train checkpoint of the float config: its params and batch_stats
        # fill the quantized state (the optimizer state is not needed to serve)
        like = detector.create_train_state(config.replace(quantized_inference=False),
                                           device="cpu")
        state = checkpoint.load_checkpoint(ckpt, like)
        print(f"restored step {state.step}", file=sys.stderr)
        params = {**params, **state.params, **state.batch_stats}
    elif weights:
        params = checkpoint.load_matterport_h5(weights, params)
    params = {k: v.to(dev) for k, v in params.items()}
    h, w = config.image_shape[:2]
    if calibration == "shapes":
        from objectdetection_torch.data.shapes import ShapesDataset

        ds = ShapesDataset(calib_images, h, w, seed=seed)
        images = ds.load_batch(list(range(calib_images)), config).images
    else:
        print("calibrating on random images (pass --ckpt/--config shapes or extend with a "
              "real calibration set for production scales)", file=sys.stderr)
        rng = np.random.RandomState(seed)
        images = rng.rand(calib_images, h, w, 3).astype(np.float32) * 255.0 - 128.0
    pct = None if percentile is None or percentile < 0 else percentile
    calibrated = quant.calibrate_variables(params, images, config,
                                           batch_size=batch_size or None,
                                           percentile=pct, device=dev)
    frozen = quant.freeze_weights(calibrated)
    checkpoint.save_quantized(out, frozen, config)
    print(f"int8 artifact saved to {out}")
    return frozen


def run_train_coco(annotations: str, image_dir: str, base=None, steps: int = 1000,
                   batch: int = 8, masks: bool = False, weights: Optional[str] = None,
                   train_layers: str = "all", lr: float = 0.001,
                   lr_schedule: str = "warmup_cosine", remat: bool = False, seed: int = 0,
                   log_every: int = 20, ckpt: str = "", device="cuda"):
    """Train on a COCO-format dataset: ``base`` (default ``COCO_CONFIG``)
    with the dataset's class count and the run's optimizer settings; masks
    through ``pycocotools`` where it is installed (else boxes only, with
    JAX's notice). Batches of ``batch`` images drawn by one
    ``RandomState(seed)`` in turn. ``remat`` sets ``remat_backbone``: the
    backbone's blocks are recomputed in the backward pass, which trades
    compute for training memory. Returns (final state, the run's record, as
    :func:`run_train`'s)."""
    import numpy as np

    from objectdetection_torch import checkpoint, detector
    from objectdetection_torch.config import COCO_CONFIG
    from objectdetection_torch.convert import resolve_device
    from objectdetection_torch.data.coco import CocoDataset, train_batch

    dev = resolve_device(device)
    ds = CocoDataset(annotations, image_dir, native_decode=dev.type == "cuda")
    cfg = train_config(base or COCO_CONFIG, steps, None, lr, lr_schedule).replace(
        num_classes=ds.num_classes, remat_backbone=remat)
    with_masks = masks
    if with_masks:
        try:
            import pycocotools  # noqa: F401
        except ImportError:
            print("pycocotools unavailable — training boxes only", file=sys.stderr)
            with_masks = False
    state = _initial_state(cfg, seed, train_layers, dev, weights, strict=False)
    step_fn = detector.make_train_step(cfg, with_masks=with_masks, train_layers=train_layers,
                                       device=dev)
    rng = np.random.RandomState(seed)

    def make_batch(i):
        ids = [ds.image_ids[j] for j in rng.randint(0, len(ds.image_ids), batch)]
        return train_batch(ds, ids, cfg, with_masks=with_masks)

    state, record = _train_loop(step_fn, state, make_batch, steps, dev, log_every)
    if ckpt:
        checkpoint.save_checkpoint(ckpt, state)
        print(f"saved checkpoint to {ckpt}")
    return state, record


def run_eval_coco(annotations: str, image_dir: str, config=None, weights: Optional[str] = None,
                  batch: int = 8, max_images: int = 0, data_parallel: bool = False,
                  device="cuda"):
    """COCO mAP (0.50:0.95) of ``config`` (default ``COCO_CONFIG``) with
    ``init_params`` seed 0 or the h5 ``weights``, on a
    COCO-format dataset, through :func:`~objectdetection_torch.coco_eval.
    run_coco_eval`. ``data_parallel`` shards each batch over
    ``parallel.make_mesh()``: every process of a ``torchrun`` launch, or a
    world of one; a process group this function starts, it ends. Returns
    (results, images per second of inference)."""
    import torch
    import torch.distributed as dist

    from objectdetection_torch import checkpoint, parallel
    from objectdetection_torch.coco_eval import run_coco_eval
    from objectdetection_torch.config import COCO_CONFIG
    from objectdetection_torch.convert import init_params, resolve_device
    from objectdetection_torch.data.coco import CocoDataset

    dev = resolve_device(device)
    started = data_parallel and not dist.is_initialized()
    mesh = parallel.make_mesh(device=dev) if data_parallel else None
    try:
        cfg = config or COCO_CONFIG
        ds = CocoDataset(annotations, image_dir, native_decode=dev.type == "cuda")
        params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        if weights:
            params = checkpoint.load_matterport_h5(weights, params)
        results, ips = run_coco_eval(ds, _to_device(params, dev), cfg, batch_size=batch,
                                     max_images=max_images or None, mesh=mesh, device=dev)
        if mesh is None or parallel.is_lead():
            print(f"final: mAP={results['mAP']:.4f} @ {ips:.1f} img/s")
    finally:
        if started:
            dist.destroy_process_group()
    return results, ips


def cmd_demo(args):
    from objectdetection_torch.config import SHAPES_CONFIG

    return run_demo(SHAPES_CONFIG, args.num_images, args.seed, args.out_prefix,
                    device=args.device)


def cmd_train(args):
    from objectdetection_torch.config import SHAPES_CONFIG

    cfg = train_config(SHAPES_CONFIG, args.steps, args.post_nms, args.lr, args.lr_schedule)
    return run_train(cfg, steps=args.steps, batch=args.batch, dataset_size=args.dataset_size,
                     masks=args.masks, seed=args.seed, log_every=args.log_every, ckpt=args.ckpt,
                     eval_every=args.eval_every, eval_images=args.eval_images,
                     eval_score_threshold=args.eval_score_threshold, eval_masks=args.eval_masks,
                     train_layers=args.train_layers, weights=args.weights or None,
                     resume=args.resume or None, device=args.device)


def cmd_infer(args):
    from objectdetection_torch.config import COCO_CONFIG

    return run_infer(args.images, COCO_CONFIG, device=args.device,
                     weights=args.weights or None, with_masks=not args.no_masks)


def cmd_train_coco(args):
    return run_train_coco(args.annotations, args.image_dir, steps=args.steps, batch=args.batch,
                          masks=args.masks, weights=args.weights or None,
                          train_layers=args.train_layers, lr=args.lr,
                          lr_schedule=args.lr_schedule, remat=args.remat, seed=args.seed,
                          log_every=args.log_every, ckpt=args.ckpt, device=args.device)


def cmd_eval_coco(args):
    return run_eval_coco(args.annotations, args.image_dir, weights=args.weights or None,
                         batch=args.batch, max_images=args.max_images,
                         data_parallel=args.data_parallel, device=args.device)


def cmd_quantize(args):
    from objectdetection_torch.config import COCO_CONFIG, SHAPES_CONFIG

    shapes = args.config == "shapes"
    cfg = quantize_config(SHAPES_CONFIG if shapes else COCO_CONFIG, args.per_channel,
                          args.post_nms)
    return run_quantize(args.out, cfg, device=args.device, ckpt=args.ckpt or None,
                        weights=args.weights or None, calib_images=args.calib_images,
                        batch_size=args.batch_size, percentile=args.percentile, seed=args.seed,
                        calibration="shapes" if shapes else "random")


def cmd_serve(args):
    from objectdetection_torch.serve import serve

    return serve(port=args.port, weights=args.weights or None, host=args.host,
                 quantized=args.quant or None, device=args.device)


def cmd_bench(args):
    from objectdetection_torch import bench

    return bench.main(args.rest)


def main(argv=None):
    p = argparse.ArgumentParser(prog="odtorch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    def add_device(sp):
        sp.add_argument("--device", default="cuda",
                        help="torch device (default cuda; raises without a card)")

    d = sub.add_parser("demo", help="shapes-dataset inference demo")
    d.add_argument("--num-images", type=int, default=2)
    d.add_argument("--seed", type=int, default=0)
    d.add_argument("--out-prefix", default="demo_")
    add_device(d)
    d.set_defaults(fn=cmd_demo)

    t = sub.add_parser("train", help="train on synthetic shapes")
    t.add_argument("--steps", type=int, default=20)
    t.add_argument("--batch", type=int, default=2)
    t.add_argument("--dataset-size", type=int, default=64)
    t.add_argument("--post-nms", type=int, default=256)
    t.add_argument("--masks", action="store_true")
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--log-every", type=int, default=5)
    t.add_argument("--ckpt", default="")
    t.add_argument("--eval-every", type=int, default=0)
    t.add_argument("--eval-images", type=int, default=16)
    t.add_argument("--eval-score-threshold", type=float, default=0.5)
    t.add_argument("--train-layers", choices=["all", "heads"], default="all",
                   help="'heads' freezes the backbone (reference train_nets='heads')")
    t.add_argument("--weights", default="", help="matterport h5 to start from")
    t.add_argument("--resume", default="", help="a train checkpoint saved by the port")
    t.add_argument("--lr", type=float, default=0.001)
    t.add_argument("--lr-schedule", choices=["constant", "warmup_cosine"], default="constant")
    t.add_argument("--eval-masks", action="store_true", help="also report mask mAP")
    add_device(t)
    t.set_defaults(fn=cmd_train)

    i = sub.add_parser("infer", help="detect objects in image files")
    i.add_argument("images", nargs="+")
    i.add_argument("--weights", default="", help="matterport mask_rcnn_coco.h5")
    i.add_argument("--no-masks", action="store_true")
    add_device(i)
    i.set_defaults(fn=cmd_infer)

    tc = sub.add_parser("train-coco", help="train on a COCO-format dataset")
    tc.add_argument("annotations")
    tc.add_argument("image_dir")
    tc.add_argument("--steps", type=int, default=1000)
    tc.add_argument("--batch", type=int, default=8)
    tc.add_argument("--masks", action="store_true")
    tc.add_argument("--weights", default="")
    tc.add_argument("--train-layers", choices=["all", "heads"], default="all")
    tc.add_argument("--lr", type=float, default=0.001)
    tc.add_argument("--lr-schedule", choices=["constant", "warmup_cosine"],
                    default="warmup_cosine")
    tc.add_argument("--remat", action="store_true",
                    help="recompute the backbone's blocks in the backward pass "
                    "(remat_backbone: less training memory, more compute)")
    tc.add_argument("--seed", type=int, default=0)
    tc.add_argument("--log-every", type=int, default=20)
    tc.add_argument("--ckpt", default="")
    add_device(tc)
    tc.set_defaults(fn=cmd_train_coco)

    e = sub.add_parser("eval-coco", help="COCO mAP evaluation")
    e.add_argument("annotations", help="instances_*.json")
    e.add_argument("image_dir")
    e.add_argument("--weights", default="")
    e.add_argument("--batch", type=int, default=8)
    e.add_argument("--max-images", type=int, default=0)
    e.add_argument("--data-parallel", action="store_true",
                   help="shard each batch over the processes of a torchrun launch "
                        "(NCCL on the card, one card a process; a plain run is a world of 1)")
    add_device(e)
    e.set_defaults(fn=cmd_eval_coco)

    q = sub.add_parser("quantize", help="produce a persisted int8 serving artifact")
    q.add_argument("--out", required=True, help="artifact output dir")
    q.add_argument("--config", choices=["shapes", "coco"], default="shapes",
                   help="shapes calibrates on the shapes dataset, coco on random images")
    q.add_argument("--ckpt", default="", help="a train checkpoint saved by the port")
    q.add_argument("--weights", default="", help="matterport h5")
    q.add_argument("--calib-images", type=int, default=64)
    q.add_argument("--batch-size", type=int, default=4)
    q.add_argument("--percentile", type=float, default=90.0,
                   help="percentile of the per-chunk absmax (default 90; -1 for the "
                   "running absmax)")
    q.add_argument("--per-channel", dest="per_channel", action="store_true", default=True,
                   help="per-input-channel activation scales folded into the frozen "
                   "kernels (cfg.per_channel_acts, default)")
    q.add_argument("--no-per-channel", dest="per_channel", action="store_false")
    q.add_argument("--seed", type=int, default=0)
    q.add_argument("--post-nms", type=int, default=0,
                   help="match the post-nms budget of the train run")
    add_device(q)
    q.set_defaults(fn=cmd_quantize)

    s = sub.add_parser("serve", help="HTTP inference server")
    s.add_argument("--port", type=int, default=8000)
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--weights", default="")
    s.add_argument("--quant", default="", help="int8 artifact dir from `quantize`")
    add_device(s)
    s.set_defaults(fn=cmd_serve)

    # the rest of the line is bench's own (its --help too): with "+" as the
    # only prefix, a leading "--batch" reaches REMAINDER instead of being
    # refused as an unknown option of this parser
    b = sub.add_parser("bench", help="inference throughput (objectdetection_torch.bench)",
                       prefix_chars="+", add_help=False)
    b.add_argument("rest", nargs=argparse.REMAINDER)
    b.set_defaults(fn=cmd_bench)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
