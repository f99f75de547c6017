"""The port's ROIAlign (plain path, as the CPU runs it) against the JAX package.

Levels are held exactly. Pooled values are held at atol 1e-6 in f32: the
sample grid is the same arithmetic, but XLA on the CPU contracts
``lo*(S-1) + i*step`` into a fused multiply-add under jit, which moves a
sample coordinate by an ulp (a pooled value by ~1e-7 for unit-scale features).

Boxes outside the map (a NaN box, boxes above and left of the map) read
what JAX's gather reads: a wrapped table index, NaN where JAX reads NaN. On
e2e_small's pyramid (64² input: P2..P5 of 16², 8², 4², 2²) the pooled
values are held at the same 1e-6 with NaNs in the same places, the int8
epilogue's codes exactly, and the gradient (autograd of the plain version
against ``jax.vjp``) at 1e-5: each pyramid row sums at most a few dozen
products, in another order than XLA's scatter-add.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from objectdetection_tpu import quant as jq
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


E2E_IMAGE = (64, 64)
E2E_LEVELS = ((16, 16), (8, 8), (4, 4), (2, 2))  # e2e_small's P2..P5


def out_of_map_boxes(with_nan=True):
    """B=2, R=4. Image 0: a NaN box; y1 = x1 = -0.05 (on P2's 16 rows the
    first sample sits at -0.75, inside the one-pixel margin); y1 = x1 = -0.2
    (-3: i1 = -2, the table index of image 0 at P2 wraps to the end of the
    table); a box inside. Image 1: a box inside; two boxes wholly above the
    map (their rows come from image 0); the full image."""
    nan = np.nan if with_nan else 0.5
    return np.array([
        [[nan, nan, nan, nan], [-0.05, -0.05, 0.3, 0.3], [-0.2, -0.2, 0.3, 0.4],
         [0.1, 0.2, 0.6, 0.7]],
        [[0.2, 0.1, 0.5, 0.9], [-0.6, 0.2, -0.3, 0.5], [-0.5, -0.7, -0.1, -0.2],
         [0.0, 0.0, 1.0, 1.0]],
    ], np.float32)


def test_out_of_map_corners_wrap_as_jax_take():
    boxes = torch.from_numpy(out_of_map_boxes())
    corners = troi._corners(E2E_LEVELS, boxes, E2E_IMAGE, (7, 7))
    rows = torch.stack([r for r, _ in corners]).reshape(4, 2, 4, 49)
    p2, table = 2 * 16 * 16, 2 * sum(h * w for h, w in E2E_LEVELS)
    assert int(troi.roi_levels(boxes[~torch.isnan(boxes).any(-1)], 64 * 64).max()) == 2
    assert bool((rows >= 0).all())  # nothing past the table from these boxes
    assert bool((rows[:, 0, 2] >= table - 2 * 2 * 2).any())  # image 0 wrapped into P5's end
    assert bool((rows[:, 1, 1] < p2 // 2).any())  # image 1 above its map reads image 0
    # the NaN box converts its NaN coordinates to index 0: P2's corner rows
    assert set(rows[:, 0, 0].unique().tolist()) <= {0, 1, 16, 17}


@pytest.mark.parametrize("crop", [(7, 7), (14, 14)])
def test_out_of_map_boxes_match_jax(crop):
    rng = np.random.RandomState(5)
    feats = [rng.normal(0, 1, (2, h, w, 8)).astype(np.float32) for h, w in E2E_LEVELS]
    boxes = out_of_map_boxes()
    want = np.asarray(jroi.batched_multilevel_roi_align(
        [jnp.asarray(f) for f in feats], jnp.asarray(boxes), E2E_IMAGE, crop))
    got = troi.batched_multilevel_roi_align(
        [torch.from_numpy(f) for f in feats], torch.from_numpy(boxes), E2E_IMAGE, crop)
    assert np.isnan(want[0, 0]).all() and np.isfinite(want[:, 1:]).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)  # NaNs in the same places


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_out_of_map_int8_epilogue_matches_jax_quantize(dtype):
    rng = np.random.RandomState(6)
    feats = [rng.normal(0, 1, (2, h, w, 8)).astype(np.float32) for h, w in E2E_LEVELS]
    boxes = out_of_map_boxes()
    smap = rng.uniform(0.5, 3.0, (7, 7, 8)).astype(np.float32)
    pooled = jroi.batched_multilevel_roi_align(
        [jnp.asarray(f).astype(dtype) for f in feats], jnp.asarray(boxes), E2E_IMAGE, (7, 7))
    want = np.asarray(jq.quantize_act(pooled, jnp.asarray(smap)))
    got = troi.batched_multilevel_roi_align(
        [torch.from_numpy(f).to(getattr(torch, dtype)) for f in feats],
        torch.from_numpy(boxes), E2E_IMAGE, (7, 7), out_quant=torch.from_numpy(smap))
    assert got.dtype == torch.int8
    assert not got[0, 0].any()  # NaN quantizes to code 0, as XLA converts it
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("with_nan", [True, False])
def test_out_of_map_gradient_matches_jax(with_nan):
    rng = np.random.RandomState(7)
    shapes = [(2, h, w, 8) for h, w in E2E_LEVELS]
    feats = [rng.normal(0, 1, s).astype(np.float32) for s in shapes]
    boxes = out_of_map_boxes(with_nan)
    cot = rng.normal(0, 1, (2, 4, 7, 7, 8)).astype(np.float32)
    _, vjp = jax.vjp(lambda *f: jroi.batched_multilevel_roi_align(
        list(f), jnp.asarray(boxes), E2E_IMAGE, (7, 7)), *[jnp.asarray(f) for f in feats])
    want = [np.asarray(g) for g in vjp(jnp.asarray(cot))]
    got = troi.roi_align_backward_plain(torch.from_numpy(cot), torch.from_numpy(boxes),
                                        shapes, E2E_IMAGE)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5)
    if not with_nan:
        assert all(bool(torch.isfinite(g).all()) for g in got)
        tol = troi.backward_tolerance(torch.from_numpy(cot), torch.from_numpy(boxes), shapes,
                                      E2E_IMAGE)
        assert all(bool(torch.isfinite(t).all()) for t in tol)
