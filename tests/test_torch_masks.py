"""The port's mask utilities against the JAX package's.

- ``minimize_masks``: equal to JAX's (both round the same f32 crops).
- ``expand_masks`` and ``paste_detection_masks`` against JAX's ``cv2``
  versions: the soft resize within 1e-5, and the binary values equal except
  where the soft value lies within 1e-5 of 0.5 (cv2 may sum in another
  order, or take its area path at exactly 2×).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from objectdetection_tpu.data import masks as jmasks

from objectdetection_torch.data import masks as tmasks
from objectdetection_torch.data.preprocess import resize_bilinear

torch.set_num_threads(1)


def square_mask(h, w, y1, x1, y2, x2):
    m = np.zeros((h, w), np.float32)
    m[y1:y2, x1:x2] = 1.0
    return m


def blob_masks(n, h, w, seed):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:h, :w]
    out = np.zeros((n, h, w), np.float32)
    boxes = np.zeros((n, 4), np.float32)
    for i in range(n):
        cy, cx = rng.uniform(10, h - 10), rng.uniform(10, w - 10)
        ry, rx = rng.uniform(3, 12), rng.uniform(3, 12)
        out[i] = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1
        ys, xs = np.nonzero(out[i])
        boxes[i] = [ys.min(), xs.min(), ys.max() + 1, xs.max() + 1]
    return boxes, out


def test_minimize_masks_matches_jax():
    boxes, masks = blob_masks(5, 64, 64, seed=0)
    boxes = np.concatenate([boxes, [[10, 14, 40, 50]]]).astype(np.float32)
    masks = np.concatenate([masks, square_mask(64, 64, 10, 14, 40, 50)[None]])
    want = np.asarray(jmasks.minimize_masks(jnp.asarray(boxes), jnp.asarray(masks), (28, 28)))
    got = tmasks.minimize_masks(torch.from_numpy(boxes), torch.from_numpy(masks), (28, 28))
    assert got.shape == (6, 28, 28) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def near_half(soft, boxes, h, w):
    """[N, H, W] bool: pixels whose resized soft value lies within 1e-5 of 0.5."""
    out = np.zeros((len(soft), h, w), bool)
    for i, box in enumerate(boxes):
        y1, x1, y2, x2 = tmasks._box_region(box, h, w)
        if y2 > y1 and x2 > x1:
            out[i, y1:y2, x1:x2] = np.abs(resize_bilinear(soft[i], (y2 - y1, x2 - x1)) - 0.5) < 1e-5
    return out


# boxes: inside, clipped at the image's edges, degenerate, exactly 2× the
# 28² mask (56 wide), fractional
BOXES = np.array([[3, 5, 40, 31], [-4, 50, 20, 70], [10, 10, 10, 30], [0, 0, 56, 56],
                  [12.4, 7.6, 33.5, 48.5], [30, 2, 63, 11]], np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_expand_masks_matches_jax(seed):
    rng = np.random.RandomState(seed)
    mini = (rng.rand(len(BOXES), 28, 28) > 0.5).astype(np.float32)
    mini[1] = rng.rand(28, 28)  # a soft one too
    want = jmasks.expand_masks(BOXES, mini, (64, 64))
    got = tmasks.expand_masks(BOXES, mini, (64, 64))
    assert got.dtype == np.float32 and got.shape == want.shape
    free = near_half(mini, BOXES, 64, 64)
    np.testing.assert_array_equal(got[~free], want[~free])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_paste_detection_masks_matches_jax(seed):
    rng = np.random.RandomState(seed)
    soft = rng.rand(len(BOXES), 28, 28).astype(np.float32)
    want = jmasks.paste_detection_masks(soft, BOXES, (64, 72))
    got = tmasks.paste_detection_masks(soft, BOXES, (64, 72))
    assert got.dtype == bool and got.shape == (len(BOXES), 64, 72)
    free = near_half(soft, BOXES, 64, 72)
    np.testing.assert_array_equal(got[~free], want[~free])
    assert got.any() and not got[2].any()  # the degenerate box pastes nothing


def test_soft_resize_within_1e5_of_cv2_in_every_box():
    import cv2  # the test's oracle only

    soft = np.random.RandomState(3).rand(len(BOXES), 28, 28).astype(np.float32)
    for i, box in enumerate(BOXES):
        y1, x1, y2, x2 = tmasks._box_region(box, 64, 64)
        if y2 > y1 and x2 > x1:
            want = cv2.resize(soft[i], (x2 - x1, y2 - y1))
            np.testing.assert_allclose(resize_bilinear(soft[i], (y2 - y1, x2 - x1)), want,
                                       rtol=0, atol=1e-5)


def test_mini_mask_roundtrip():
    mask = square_mask(64, 64, 10, 14, 40, 50)[None]
    boxes = np.array([[10, 14, 40, 50]], np.float32)
    mini = tmasks.minimize_masks(boxes, mask, (28, 28)).numpy()
    assert mini.mean() > 0.95
    back = tmasks.expand_masks(boxes, mini, (64, 64))
    inter = ((back[0] > 0.5) & (mask[0] > 0.5)).sum()
    union = ((back[0] > 0.5) | (mask[0] > 0.5)).sum()
    assert inter / union > 0.9
