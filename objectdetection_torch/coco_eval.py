"""Batched COCO evaluation.

Port of ``objectdetection_tpu.coco_eval``: molds each batch of a
COCO-format dataset on the host, runs ``make_infer_fn`` without masks,
unmolds the detections to each image's own pixels on the host
(``unmold_detections_np``, one device-to-host copy a batch) and accumulates
COCO-style mAP over the 0.50:0.95 IoU sweep, crowd regions ignored. With a
``mesh`` (``parallel.make_mesh``), each process molds and infers only its
rows of every batch (``parallel.make_parallel_infer_fn``); the detections,
windows and image shapes are gathered, so every process unmolds and scores
every image, and only rank 0 prints.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np

from objectdetection_torch.config import DetectorConfig
from objectdetection_torch.data.coco import CocoDataset, eval_batch
from objectdetection_torch.evaluate import DetectionEvaluator, coco_iou_thresholds


def run_coco_eval(
    dataset: CocoDataset,
    params,
    config: DetectorConfig,
    batch_size: int = 8,
    max_images: Optional[int] = None,
    mesh=None,
    iou_thresholds: Optional[Sequence[float]] = None,
    verbose: bool = True,
    device="cuda",
):
    """Evaluate the detector (state dict ``params`` on ``device``, or on this
    process's device of ``mesh``) on a COCO-style dataset. A last batch
    short of ``batch_size`` is padded with zero images, windows and shapes
    of 1, as in JAX; with a mesh, ``batch_size`` must divide by its ``data``
    axis. The inference time ends with the detections' copy to the host.
    Returns (results dict from DetectionEvaluator, images_per_sec)."""
    from objectdetection_torch import detector
    from objectdetection_torch.data.preprocess import unmold_detections_np

    image_ids = dataset.image_ids[:max_images] if max_images else dataset.image_ids
    thresholds = list(iou_thresholds or coco_iou_thresholds())
    ev = DetectionEvaluator(config.num_classes, iou_thresholds=thresholds)
    if mesh is None:
        infer = detector.make_infer_fn(config, with_masks=False, device=device)
        first, rows = 0, batch_size
    else:
        from objectdetection_torch import parallel

        ranks = parallel.data_size(mesh)
        if batch_size % ranks:
            raise ValueError(f"batch_size {batch_size} does not split over {ranks} ranks")
        infer = parallel.make_parallel_infer_fn(config, mesh, with_masks=False)
        rows = batch_size // ranks
        first = parallel.data_rank(mesh) * rows
        verbose = verbose and parallel.is_lead()

    d = config.image_max_dim
    n_done = 0
    t_infer = 0.0
    for start in range(0, len(image_ids), batch_size):
        ids = image_ids[start: start + batch_size]
        mine = ids[first: first + rows]
        pad = rows - len(mine)
        images, windows, shapes = eval_batch(dataset, mine, config)
        if pad:
            images = np.pad(images, ((0, pad), (0, 0), (0, 0), (0, 0)))
            windows = np.pad(windows, ((0, pad), (0, 0)), constant_values=1)
            shapes = np.pad(shapes, ((0, pad), (0, 0)), constant_values=1)

        t0 = time.time()
        det = infer(params, images, windows)
        if mesh is not None:
            windows, shapes = (x.cpu().numpy() for x in parallel.gather_batch((windows, shapes),
                                                                             mesh))
        det_boxes_h = det.boxes.float().cpu().numpy()  # also syncs for timing
        t_infer += time.time() - t0

        det_cls_h = det.class_ids.cpu().numpy()
        det_scores_h = det.scores.float().cpu().numpy()
        for bi, img_id in enumerate(ids):
            det_row = np.concatenate(
                [
                    det_boxes_h[bi],
                    det_cls_h[bi][:, None].astype(np.float32),
                    det_scores_h[bi][:, None],
                ],
                axis=1,
            )
            boxes_px, cls, scores_v, valid = unmold_detections_np(
                det_row, windows[bi], (d, d), shapes[bi]
            )
            gt_boxes, gt_classes = dataset.annotations(img_id)
            crowd_boxes, crowd_classes = dataset.crowd_regions(img_id)
            ev.add_image(
                np.asarray(boxes_px)[valid],
                np.asarray(cls)[valid],
                np.asarray(scores_v)[valid],
                gt_boxes,
                gt_classes,
                ignore_boxes=crowd_boxes,
                ignore_classes=crowd_classes,
            )
        n_done += len(ids)
        if verbose and (start // batch_size) % 10 == 0:
            print(f"  evaluated {n_done}/{len(image_ids)}", flush=True)

    results = ev.evaluate()
    imgs_per_sec = n_done / max(t_infer, 1e-9)
    if verbose:
        print(
            f"mAP={results['mAP']:.4f}"
            + (f" AP50={results['AP50']:.4f}" if "AP50" in results else "")
            + f"  ({imgs_per_sec:.1f} img/s inference)"
        )
    return results, imgs_per_sec
