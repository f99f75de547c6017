"""COCO-format datasets: the class names of the 81-way heads, an
annotation reader, and molded training and evaluation batches.

Port of ``objectdetection_tpu.data.coco``. :class:`CocoDataset` reads the
standard ``instances_*.json`` layout with ``json`` alone; its images are
decoded by :func:`~objectdetection_torch.data.image_io.decode_image` (PNG
and PPM by the port's own decoder, bit-exact; any other format through
Pillow where it is installed, else ``ImageDecodeError``). Instance masks
(polygons or RLE) decode through ``pycocotools`` when it is installed and
are None otherwise, as in JAX. :func:`train_batch` resizes masks with
:func:`~objectdetection_torch.data.preprocess.resize_bilinear`, the numpy
copy of the ``cv2.resize`` JAX calls. Batches are numpy arrays; moving them
to a device is the caller's job.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

# matterport/COCO 81-way head ordering: index 0 = background, then the 80
# COCO categories in ascending category-id order.
COCO_CLASS_NAMES = (
    "BG", "person", "bicycle", "car", "motorcycle", "airplane", "bus",
    "train", "truck", "boat", "traffic light", "fire hydrant", "stop sign",
    "parking meter", "bench", "bird", "cat", "dog", "horse", "sheep", "cow",
    "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella", "handbag",
    "tie", "suitcase", "frisbee", "skis", "snowboard", "sports ball", "kite",
    "baseball bat", "baseball glove", "skateboard", "surfboard",
    "tennis racket", "bottle", "wine glass", "cup", "fork", "knife", "spoon",
    "bowl", "banana", "apple", "sandwich", "orange", "broccoli", "carrot",
    "hot dog", "pizza", "donut", "cake", "chair", "couch", "potted plant",
    "bed", "dining table", "toilet", "tv", "laptop", "mouse", "remote",
    "keyboard", "cell phone", "microwave", "oven", "toaster", "sink",
    "refrigerator", "book", "clock", "vase", "scissors", "teddy bear",
    "hair drier", "toothbrush",
)


@dataclass
class CocoDataset:
    """Annotation-file-backed dataset (images read lazily from disk).
    ``native_decode`` unfilters PNG rows with the C loop built beside the
    kernels (``image_io.decode_png``'s ``native``)."""

    annotation_file: str
    image_dir: str
    native_decode: bool = False
    image_ids: List[int] = field(default_factory=list)
    _images: Dict[int, dict] = field(default_factory=dict)
    _anns: Dict[int, list] = field(default_factory=dict)
    _cat_to_class: Dict[int, int] = field(default_factory=dict)

    def __post_init__(self):
        with open(self.annotation_file) as f:
            data = json.load(f)
        cats = sorted(data["categories"], key=lambda c: c["id"])
        self._cat_to_class = {c["id"]: i + 1 for i, c in enumerate(cats)}
        self.class_names = ["BG"] + [c["name"] for c in cats]
        for img in data["images"]:
            self._images[img["id"]] = img
            self._anns[img["id"]] = []
        self._crowds: Dict[int, list] = {i: [] for i in self._images}
        for ann in data.get("annotations", []):
            if ann.get("iscrowd", 0):
                # crowd regions are ignore regions, not GT instances
                # (pycocotools semantics) — kept separately for the evaluator
                self._crowds.setdefault(ann["image_id"], []).append(ann)
            else:
                self._anns.setdefault(ann["image_id"], []).append(ann)
        self.image_ids = sorted(self._images)

    @property
    def num_classes(self) -> int:
        return len(self.class_names)

    def image_info(self, image_id: int) -> dict:
        return self._images[image_id]

    def image(self, image_id: int) -> np.ndarray:
        """The image's RGB pixels, uint8 [H, W, 3]."""
        from objectdetection_torch.data.image_io import decode_image

        info = self._images[image_id]
        path = os.path.join(self.image_dir, info["file_name"])
        with open(path, "rb") as f:
            return decode_image(f.read(), native=self.native_decode)

    def _boxes(self, anns) -> Tuple[np.ndarray, np.ndarray]:
        """(boxes [N, 4] pixel y1x1y2x2, class_ids [N]) of ``anns``, those
        of zero width or height dropped."""
        boxes, ids = [], []
        for a in anns:
            x, y, w, h = a["bbox"]
            if w <= 0 or h <= 0:
                continue
            boxes.append([y, x, y + h, x + w])
            ids.append(self._cat_to_class[a["category_id"]])
        if not boxes:
            return np.zeros((0, 4), np.float32), np.zeros((0,), np.int32)
        return np.asarray(boxes, np.float32), np.asarray(ids, np.int32)

    def annotations(self, image_id: int) -> Tuple[np.ndarray, np.ndarray]:
        """(boxes [N, 4] pixel y1x1y2x2, class_ids [N]) for one image."""
        return self._boxes(self._anns.get(image_id, []))

    def crowd_regions(self, image_id: int) -> Tuple[np.ndarray, np.ndarray]:
        """(boxes [N, 4] pixel y1x1y2x2, class_ids [N]) of iscrowd regions —
        detections matching these are ignored (not FPs) during eval."""
        return self._boxes(self._crowds.get(image_id, []))

    def masks(self, image_id: int) -> Optional[np.ndarray]:
        """[H, W, N] instance masks ALIGNED with :meth:`annotations` rows
        (same filtering; instances without a segmentation get an all-zero
        column). None only when pycocotools is unavailable."""
        try:
            from pycocotools import mask as mask_utils
        except ImportError:
            return None
        info = self._images[image_id]
        h, w = info["height"], info["width"]
        out = []
        for a in self._anns.get(image_id, []):
            bx, by, bw, bh = a["bbox"]
            if bw <= 0 or bh <= 0:  # same filter as annotations()
                continue
            seg = a.get("segmentation")
            if not seg:
                out.append(np.zeros((h, w), np.uint8))
                continue
            if isinstance(seg, list):
                rles = mask_utils.frPyObjects(seg, h, w)
                rle = mask_utils.merge(rles)
            else:
                rle = mask_utils.frPyObjects(seg, h, w)
            out.append(mask_utils.decode(rle))
        if not out:
            return np.zeros((h, w, 0), bool)
        return np.stack(out, axis=-1).astype(bool)


def train_batch(dataset: CocoDataset, image_ids, config, with_masks: bool = True):
    """Mold a COCO training batch: images + window-transformed GT (+ masks).

    GT boxes follow the image through the mold (scale + centered padding)
    and come out in the reference's normalized convention. Masks become
    mini-masks (config.mini_mask_shape) when `config.use_mini_mask` — cropped
    from the ORIGINAL-resolution mask by the original box (scale-invariant),
    the reference's memory-saving path (utils.minimize_mask) — otherwise
    full molded-frame masks.
    """
    from objectdetection_torch.data.preprocess import mold_image_host, resize_bilinear
    from objectdetection_torch.detector import TrainBatch

    b = len(image_ids)
    d = config.image_max_dim
    g = config.max_gt_objects
    mini = config.use_mini_mask
    mh, mw = config.mini_mask_shape if mini else (d, d)

    images = np.zeros((b, d, d, 3), np.float32)
    gt_boxes = np.zeros((b, g, 4), np.float32)
    gt_class_ids = np.zeros((b, g), np.int32)
    gt_masks = np.zeros((b, g, mh, mw), np.float32) if with_masks else None
    active = np.ones((b, config.num_classes), np.int32)

    for bi, img_id in enumerate(image_ids):
        rgb = dataset.image(img_id)
        molded, window, scale = mold_image_host(rgb, config)
        images[bi] = molded
        boxes, cls = dataset.annotations(img_id)
        n = min(len(cls), g)
        if n == 0:
            continue
        top, left = window[0], window[1]
        pix = boxes[:n] * scale + np.array([top, left, top, left], np.float32)
        shift = np.array([0, 0, 1, 1], np.float32)
        gt_boxes[bi, :n] = (pix - shift) / (d - 1)
        gt_class_ids[bi, :n] = cls[:n]
        if with_masks:
            masks = dataset.masks(img_id)  # [H0, W0, N] or None
            if masks is None:
                continue
            for j in range(n):
                if mini:
                    y1, x1, y2, x2 = boxes[j].astype(int)
                    crop = masks[
                        max(y1, 0) : max(y2, y1 + 1),
                        max(x1, 0) : max(x2, x1 + 1),
                        j,
                    ].astype(np.float32)
                    if crop.size == 0:
                        continue
                    gt_masks[bi, j] = np.round(resize_bilinear(crop, (mh, mw)))
                else:
                    m = masks[:, :, j].astype(np.float32)
                    if scale != 1.0:
                        m = resize_bilinear(m, (int(round(m.shape[0] * scale)),
                                                int(round(m.shape[1] * scale))))
                    h2, w2 = m.shape
                    gt_masks[bi, j, top : top + h2, left : left + w2] = np.round(
                        m[: d - top, : d - left]
                    )

    return TrainBatch(
        images=images,
        gt_boxes=gt_boxes,
        gt_class_ids=gt_class_ids,
        gt_masks=gt_masks,
        active_class_ids=active,
    )


def eval_batch(
    dataset: CocoDataset, image_ids, config
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Mold a list of images into (images [B,D,D,3], windows [B,4],
    orig_shapes [B,2]) for ``make_infer_fn``."""
    from objectdetection_torch.data.preprocess import mold_image_host

    b = len(image_ids)
    d = config.image_max_dim
    images = np.zeros((b, d, d, 3), np.float32)
    windows = np.zeros((b, 4), np.float32)
    shapes = np.zeros((b, 2), np.int32)
    for i, img_id in enumerate(image_ids):
        rgb = dataset.image(img_id)
        molded, window, _ = mold_image_host(rgb, config)
        images[i] = molded
        windows[i] = window
        shapes[i] = rgb.shape[:2]
    return images, windows, shapes
