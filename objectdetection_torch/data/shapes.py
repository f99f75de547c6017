"""Synthetic shapes dataset (procedural squares / circles / triangles).

Port of ``objectdetection_tpu.data.shapes``: a random background colour, 1-4
shapes with random colour, centre and size, heavily overlapping ground
truths pruned with NMS at IoU 0.3, occlusion-aware instance masks (later
shapes occlude earlier ones), class ids {1: square, 2: circle, 3: triangle}.
The specs are drawn with numpy ``default_rng(seed)`` in the JAX package's
order, so ``image_meta`` equals JAX's for every seed.

Every pixel comes from one rasterizer,
:mod:`~objectdetection_torch.data.shapes_raster` (the numpy port of the JAX
package's native one, bit-equal to it): :meth:`ShapesDataset.load_batch`,
:meth:`~ShapesDataset.image` and :meth:`~ShapesDataset.masks` all use it.
They return numpy arrays (a :class:`~objectdetection_torch.detector.
TrainBatch` of numpy arrays for a batch); moving them to a device is the
caller's job.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

from objectdetection_torch.config import DetectorConfig
from objectdetection_torch.data.shapes_raster import raster_image, rasterize_shapes_batch

CLASS_NAMES = ("bg", "square", "circle", "triangle")


def _np_nms_keep(boxes: np.ndarray, thresh: float) -> List[int]:
    """Greedy NMS keep-list (order = given order)."""
    keep, suppressed = [], set()
    for i in range(len(boxes)):
        if i in suppressed:
            continue
        keep.append(i)
        for j in range(i + 1, len(boxes)):
            if j in suppressed:
                continue
            y1 = max(boxes[i][0], boxes[j][0])
            x1 = max(boxes[i][1], boxes[j][1])
            y2 = min(boxes[i][2], boxes[j][2])
            x2 = min(boxes[i][3], boxes[j][3])
            inter = max(y2 - y1, 0) * max(x2 - x1, 0)
            a = (boxes[i][2] - boxes[i][0]) * (boxes[i][3] - boxes[i][1])
            b = (boxes[j][2] - boxes[j][0]) * (boxes[j][3] - boxes[j][1])
            if inter / (a + b - inter) > thresh:
                suppressed.add(j)
    return keep


@dataclass
class ShapesDataset:
    """Procedural dataset; one spec dict per image, rasterized on demand."""

    num_images: int
    height: int = 128
    width: int = 128
    seed: int = 0
    max_instances: int = 4
    image_meta: Dict[int, dict] = field(default_factory=dict)

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        for i in range(self.num_images):
            self.image_meta[i] = self._spec(rng)

    @property
    def num_classes(self) -> int:
        return len(CLASS_NAMES)

    def _spec(self, rng: np.random.Generator) -> dict:
        h, w = self.height, self.width
        bg_color = rng.integers(0, 256, 3).tolist()
        num_objects = int(rng.integers(1, self.max_instances + 1))
        # the reference's 20 px margin at 128², scaled down for smaller
        # canvases so that the sampling ranges stay valid
        buffer = min(20, max(4, h // 8))
        instances = []
        boxes = []
        for _ in range(num_objects):
            shape = CLASS_NAMES[1:][int(rng.integers(0, 3))]
            color = tuple(int(c) for c in rng.integers(0, 256, 3))
            c_y = int(rng.integers(buffer, h - buffer))
            c_x = int(rng.integers(buffer, w - buffer))
            size = int(rng.integers(buffer, h // 4 + 1))
            instances.append((shape, color, (c_y, c_x, size)))
            boxes.append([c_y - size, c_x - size, c_y + size, c_x + size])
        keep = _np_nms_keep(np.array(boxes, np.float32), 0.3)
        return dict(bg_color=bg_color, instances=[instances[i] for i in keep])

    def _spec_rows(self, image_id: int, rows: int) -> np.ndarray:
        """The rasterizer's [rows, 7] int32 spec of one image (class, cy, cx,
        size, r, g, b; zero rows after its instances)."""
        out = np.zeros((rows, 7), np.int32)
        for j, (shape, color, (cy, cx, size)) in enumerate(
                self.image_meta[image_id]["instances"][:rows]):
            out[j] = [CLASS_NAMES.index(shape), cy, cx, size, *color]
        return out

    def _raster(self, image_id: int):
        info = self.image_meta[image_id]
        spec = self._spec_rows(image_id, len(info["instances"]))
        return raster_image(spec, info["bg_color"], self.height, self.width)

    def image(self, image_id: int) -> np.ndarray:
        """The RGB image, uint8 [H, W, 3]."""
        return self._raster(image_id)[0].astype(np.uint8)

    def masks(self, image_id: int) -> Tuple[np.ndarray, np.ndarray]:
        """Occlusion-aware instance masks bool [H, W, N] + class ids [N]; a
        fully occluded instance keeps its empty mask."""
        hits = self._raster(image_id)[1]
        class_ids = np.array(
            [CLASS_NAMES.index(s[0]) for s in self.image_meta[image_id]["instances"]], np.int32)
        return np.transpose(hits, (1, 2, 0)), class_ids

    def bboxes_from_masks(self, masks: np.ndarray) -> np.ndarray:
        """Tight boxes (y1, x1, y2, x2) from instance masks [H, W, N]; empty
        (fully occluded) instances get a zero box."""
        n = masks.shape[-1]
        out = np.zeros((n, 4), np.int32)
        for i in range(n):
            ys, xs = np.where(masks[:, :, i])
            if len(ys):
                out[i] = [ys.min(), xs.min(), ys.max() + 1, xs.max() + 1]
        return out

    def load_batch(self, image_ids, config: DetectorConfig, with_masks: bool = True):
        """A fixed-shape, zero-padded training batch of numpy arrays
        (:class:`~objectdetection_torch.detector.TrainBatch`): images [B, H,
        W, 3] minus the mean pixel, normalized GT boxes [B, G, 4], class ids
        [B, G], masks [B, G, H, W] (None without ``with_masks``) and the
        active class ids; G is ``config.max_gt_objects``."""
        from objectdetection_torch.detector import TrainBatch

        b = len(image_ids)
        h, w = config.image_shape[:2]
        g = config.max_gt_objects
        max_inst = max(g, max(len(self.image_meta[i]["instances"]) for i in image_ids))
        specs = np.stack([self._spec_rows(i, max_inst) for i in image_ids])
        bg = np.array([self.image_meta[i]["bg_color"] for i in image_ids], np.int32)
        images, masks, boxes, classes = rasterize_shapes_batch(specs, bg, h, w,
                                                               config.mean_pixel)
        active = np.zeros((b, config.num_classes), np.int32)
        active[:, : self.num_classes] = 1
        return TrainBatch(
            images=images,
            gt_boxes=boxes[:, :g],
            gt_class_ids=classes[:, :g],
            gt_masks=masks[:, :g] if with_masks else None,
            active_class_ids=active,
        )
