"""The port's numpy drawing against the JAX package's ``cv2`` drawing.

- ``random_colors``: equal.
- ``draw_detections`` without labels against JAX's with ``cv2.putText``
  stubbed out: box outlines and the mask blend equal pixel for pixel,
  except where a resized soft mask lies within 1e-5 of the 0.5 threshold
  (cv2's resize may sum in another order). Labels use a built-in bitmap
  font that is not ``cv2.putText``'s; they are checked to be drawn in the
  box's colour above it.
- ``draw_anchor_assignment`` (thickness-1 outlines): equal; the 2-pixel GT
  outline is checked for its colour only.
"""

import numpy as np
import pytest
import torch

from objectdetection_tpu import viz as jviz

from objectdetection_torch import viz as tviz
from objectdetection_torch.data.preprocess import resize_bilinear

torch.set_num_threads(1)

cv2 = pytest.importorskip("cv2")

BOXES = np.array([[5, 6, 40, 50], [20, 30, 63, 79], [-3, -4, 10, 12], [30, 10, 30, 40],
                  [50, 60, 90, 120]], np.int32)


def test_random_colors_equal_jax():
    for n in (1, 5, 81):
        assert tviz.random_colors(n) == jviz.random_colors(n)
        assert tviz.random_colors(n, seed=3, bright=False) == jviz.random_colors(n, 3, False)


def near_threshold(masks, boxes, h, w):
    out = np.zeros((h, w), bool)
    for i, (y1, x1, y2, x2) in enumerate(boxes):
        y1, x1, y2, x2 = max(y1, 0), max(x1, 0), min(y2, h - 1), min(x2, w - 1)
        if y2 > y1 and x2 > x1:
            m = resize_bilinear(masks[i], (y2 - y1, x2 - x1))
            out[y1:y2, x1:x2] |= np.abs(m - 0.5) < 1e-5
    return out


@pytest.mark.parametrize("with_masks", [False, True])
def test_draw_detections_matches_jax_without_labels(monkeypatch, with_masks):
    rng = np.random.RandomState(4)
    image = rng.randint(0, 256, (64, 80, 3)).astype(np.uint8)
    masks = rng.rand(len(BOXES), 28, 28).astype(np.float32) if with_masks else None
    cls = np.array([1, 2, 3, 1, 2])
    scores = rng.rand(len(BOXES))
    monkeypatch.setattr(cv2, "putText", lambda *a, **k: None)
    want = jviz.draw_detections(image, BOXES, cls, scores, ["bg", "a", "b", "c"], masks)
    got = tviz.draw_detections(image, BOXES, cls, scores, ["bg", "a", "b", "c"], masks,
                               labels=False)
    assert got.dtype == np.uint8 and got.shape == image.shape
    free = near_threshold(masks, BOXES, 64, 80) if with_masks else np.zeros((64, 80), bool)
    np.testing.assert_array_equal(got[~free], want[~free])
    assert (got != image).any()


def test_labels_are_drawn_above_the_box_in_its_colour():
    image = np.zeros((64, 80, 3), np.uint8)
    box = np.array([[20, 10, 50, 60]])
    out = tviz.draw_detections(image, box, np.array([1]), np.array([0.87]), ["bg", "person"])
    color = np.array([int(255 * c) for c in tviz.random_colors(1)[0]], np.uint8)
    band = out[13:18, 10:60]
    assert (band == color).all(-1).sum() > 20  # "PERSON 0.87" in 3×5 glyphs
    plain = tviz.draw_detections(image, box, np.array([1]), np.array([0.87]), labels=False)
    assert not plain[13:18].any()


def test_draw_anchor_assignment_matches_jax():
    rng = np.random.RandomState(2)
    image = rng.randint(0, 256, (64, 80, 3)).astype(np.uint8)
    ctr = rng.uniform(-10, 90, (120, 2))
    size = rng.uniform(4, 40, (120, 2))
    anchors = np.concatenate([ctr - size / 2, ctr + size / 2], 1)
    target = rng.choice([-1, 0, 1], 120)
    want = jviz.draw_anchor_assignment(image, anchors, target)
    got = tviz.draw_anchor_assignment(image, anchors, target)
    np.testing.assert_array_equal(got, want)
    gt = np.array([[10, 10, 40, 50]])
    out = tviz.draw_anchor_assignment(image, anchors, target, gt_boxes=gt)
    assert (out[10, 10:51] == 255).all() and (out[10:41, 50] == 255).all()
