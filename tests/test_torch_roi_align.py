"""The port's ROIAlign (plain path, as the CPU runs it) against the JAX package.

Levels are held exactly. Pooled values are held at atol 1e-6 in f32: the
sample grid is the same arithmetic, but XLA on the CPU contracts
``lo*(S-1) + i*step`` into a fused multiply-add under jit, which moves a
sample coordinate by an ulp (a pooled value by ~1e-7 for unit-scale features).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from objectdetection_tpu.ops import roi_align as jroi

from objectdetection_torch.ops import roi_align as troi

torch.set_num_threads(1)

IMAGE = (1024, 1024)  # so that box sizes spread over all four levels
LEVELS = ((32, 32), (16, 16), (8, 8), (4, 4))


def special_boxes(rng, b, r):
    """Random boxes plus zero, flat (clipped), full-image and tiny boxes."""
    y1x1 = rng.uniform(0, 0.8, (b, r, 2))
    hw = rng.uniform(0, 1, (b, r, 2)) ** 2 * 0.7
    boxes = np.concatenate([y1x1, np.minimum(y1x1 + hw, 1.0)], -1).astype(np.float32)
    q = r // 8
    boxes[:, :q] = 0.0
    boxes[:, q:2 * q, 2] = boxes[:, q:2 * q, 0]  # zero height
    boxes[:, 2 * q:3 * q, 3] = 1.0
    boxes[:, 2 * q:3 * q, 1] = 1.0  # zero width on the right edge
    boxes[:, 3 * q:3 * q + 2] = [0.0, 0.0, 1.0, 1.0]
    boxes[:, 4 * q:5 * q, 2:] = boxes[:, 4 * q:5 * q, :2] + 1e-4  # tiny
    return boxes


def pyramid(rng, b, c):
    return [rng.normal(0, 1, (b, h, w, c)).astype(np.float32) for h, w in LEVELS]


def test_levels_match_jax():
    boxes = special_boxes(np.random.RandomState(0), 2, 400)
    for area in (64.0 * 64.0, 1024.0 * 1024.0, 800.0 * 1333.0):
        want = np.asarray(jroi.roi_levels(jnp.asarray(boxes), area))
        got = troi.roi_levels(torch.from_numpy(boxes), area).numpy()
        np.testing.assert_array_equal(got, want)
    assert set(np.unique(got).tolist()) == {2, 3, 4, 5}


@pytest.mark.parametrize("crop", [(7, 7), (14, 14)])
def test_pooled_matches_jax_f32(crop):
    rng = np.random.RandomState(1)
    feats = pyramid(rng, 2, 8)
    boxes = special_boxes(rng, 2, 64)
    want = np.asarray(jroi.batched_multilevel_roi_align(
        [jnp.asarray(f) for f in feats], jnp.asarray(boxes), IMAGE, crop))
    got = troi.batched_multilevel_roi_align(
        [torch.from_numpy(f) for f in feats], torch.from_numpy(boxes), IMAGE, crop)
    assert got.dtype == torch.float32 and got.shape == (2, 64, *crop, 8)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_zero_box_reads_the_p2_corner():
    rng = np.random.RandomState(2)
    feats = [torch.from_numpy(f) for f in pyramid(rng, 2, 4)]
    boxes = torch.zeros(2, 3, 4)
    out = troi.batched_multilevel_roi_align(feats, boxes, IMAGE, (7, 7))
    want = feats[0][:, 0, 0, :][:, None, None, None, :].expand_as(out)
    assert torch.equal(out, want)


def test_bf16_plain_within_stated_tolerance_of_f32():
    # the bound the card's kernel is held to against this plain version also
    # covers the plain bf16 version against exact f32 pooling of the same
    # bf16 inputs (both are within 8 roundings of the largest corner value)
    rng = np.random.RandomState(3)
    feats16 = [torch.from_numpy(f).to(torch.bfloat16) for f in pyramid(rng, 2, 16)]
    boxes = torch.from_numpy(special_boxes(rng, 2, 64))
    got = troi.batched_multilevel_roi_align(feats16, boxes, IMAGE, (7, 7))
    ref = troi.batched_multilevel_roi_align([f.float() for f in feats16], boxes, IMAGE, (7, 7))
    assert got.dtype == torch.bfloat16
    err = float((got.float() - ref).abs().max())
    assert err <= troi.bf16_tolerance(feats16)


def test_cpu_tensor_takes_plain_version_without_counting():
    rng = np.random.RandomState(4)
    feats = [torch.from_numpy(f) for f in pyramid(rng, 1, 4)]
    boxes = torch.from_numpy(special_boxes(rng, 1, 16))
    before = troi.launches
    out = troi.batched_multilevel_roi_align(feats, boxes, IMAGE, (7, 7))
    plain = troi.batched_multilevel_roi_align_plain(feats, boxes, IMAGE, (7, 7))
    assert troi.launches == before
    assert torch.equal(out, plain)


def test_touched_rows_counts_distinct_corners():
    feats = [torch.zeros(1, h, w, 2) for h, w in LEVELS]
    # the full image on P5 (4x4): a 7x7 grid touches every one of its 16 rows
    full = torch.tensor([[[0.0, 0.0, 1.0, 1.0]]])
    assert troi.roi_levels(full, IMAGE[0] * IMAGE[1]).item() == 5
    assert troi.touched_rows(feats, full, IMAGE, (7, 7)) == 16
    # a zero box reads one row (the P2 corner)
    assert troi.touched_rows(feats, torch.zeros(1, 1, 4), IMAGE, (7, 7)) == 1
