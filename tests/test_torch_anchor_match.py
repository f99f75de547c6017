"""Anchor matching: the port's plain version against JAX's XLA version and
its Pallas kernel (interpret mode on the CPU).

The port's function is batched over images (shared anchors [A, 4], GT
[B, G, 4]); the JAX functions run per image. The CUDA kernel is held against
the plain version on the card (tests/test_torch_cuda.py).

Tolerances, stated: per-anchor and per-GT maxima within rtol 1e-6 (XLA on
the CPU may contract an area product and a sum into one FMA, which moves an
IoU by an ulp); argmaxes equal. Ties (duplicated GT boxes, duplicated
anchors) go to the lowest index on every side; a GT that is invalid or
overlaps no anchor comes out as (0, 0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from objectdetection_tpu.anchors import config_anchors as j_config_anchors
from objectdetection_tpu.config import SHAPES_CONFIG as J_SHAPES
from objectdetection_tpu.ops.anchor_match import anchor_match_pallas, anchor_match_xla

from objectdetection_torch.ops import anchor_match as am

torch.set_num_threads(1)


def random_boxes(rng, n):
    c = rng.rand(n, 2) * 0.8 + 0.1
    s = rng.rand(n, 2) * 0.1 + 0.02
    return np.concatenate([c - s, c + s], axis=1).astype(np.float32)


def make_case(seed, a, g, b=2):
    rng = np.random.RandomState(seed)
    anchors = random_boxes(rng, a)
    anchors[a // 2] = anchors[3]  # a duplicated anchor: GT argmax ties go low
    gt = np.stack([random_boxes(rng, g) for _ in range(b)])
    gt[:, 1] = gt[:, 0]  # a duplicated GT: anchor argmax ties go low
    gt[:, 2] = [0.95, 0.95, 0.951, 0.951]  # overlaps (almost) nothing
    gt[:, 3] = anchors[3]  # its best anchors are 3 and a // 2, equal
    valid = rng.rand(b, g) > 0.25
    valid[:, :4] = True
    valid[-1] = False  # an image whose GTs are all invalid
    return anchors, gt, valid


def check(got, want, i):
    np.testing.assert_allclose(got.anchor_max[i].numpy(), np.asarray(want.anchor_max),
                               rtol=1e-6, atol=0)
    np.testing.assert_allclose(got.gt_max[i].numpy(), np.asarray(want.gt_max), rtol=1e-6, atol=0)
    np.testing.assert_array_equal(got.anchor_argmax[i].numpy(), np.asarray(want.anchor_argmax))
    np.testing.assert_array_equal(got.gt_argmax[i].numpy(), np.asarray(want.gt_argmax))


@pytest.mark.parametrize("seed,a,g", [(0, 500, 12), (1, 1024, 7), (2, 3000, 40)])
def test_plain_matches_xla(seed, a, g):
    anchors, gt, valid = make_case(seed, a, g)
    got = am.anchor_match(*(torch.from_numpy(x) for x in (anchors, gt, valid)))
    assert got.anchor_argmax.dtype == torch.int32 and got.gt_argmax.dtype == torch.int32
    for i in range(gt.shape[0]):
        check(got, anchor_match_xla(jnp.asarray(anchors), jnp.asarray(gt[i]),
                                    jnp.asarray(valid[i])), i)
    assert int(got.gt_argmax[0, 3]) == 3  # the tie between anchors 3 and a // 2
    assert int(got.anchor_argmax[0, 3]) == 3  # an anchor matching GT 3 exactly...
    assert float(got.anchor_max[0, 3]) == 1.0
    assert (got.gt_max[-1] == 0).all() and (got.gt_argmax[-1] == 0).all()
    assert (got.anchor_max[-1] == 0).all() and (got.anchor_argmax[-1] == 0).all()


@pytest.mark.parametrize("seed,a,g,tile", [(3, 500, 12, 128), (4, 1024, 7, 256)])
def test_plain_matches_pallas_interpret(seed, a, g, tile):
    anchors, gt, valid = make_case(seed, a, g)
    got = am.anchor_match(*(torch.from_numpy(x) for x in (anchors, gt, valid)))
    for i in range(gt.shape[0]):
        check(got, anchor_match_pallas(jnp.asarray(anchors), jnp.asarray(gt[i]),
                                       jnp.asarray(valid[i]), tile_size=tile,
                                       interpret=True), i)


def test_plain_matches_xla_on_config_anchors():
    anchors = j_config_anchors(J_SHAPES)  # 128², 5 levels
    rng = np.random.RandomState(5)
    y1x1 = rng.uniform(0, 0.7, (2, 9, 2))
    gt = np.concatenate([y1x1, y1x1 + rng.uniform(0.05, 0.3, (2, 9, 2))], -1).astype(np.float32)
    valid = rng.rand(2, 9) > 0.3
    got = am.anchor_match(*(torch.from_numpy(x) for x in (anchors, gt, valid)))
    for i in range(2):
        check(got, anchor_match_xla(jnp.asarray(anchors), jnp.asarray(gt[i]),
                                    jnp.asarray(valid[i])), i)


def test_all_invalid_gt():
    rng = np.random.RandomState(6)
    anchors = random_boxes(rng, 256)
    gt = random_boxes(rng, 4)[None]
    got = am.anchor_match(torch.from_numpy(anchors), torch.from_numpy(gt),
                          torch.zeros(1, 4, dtype=torch.bool))
    want = anchor_match_pallas(jnp.asarray(anchors), jnp.asarray(gt[0]), jnp.zeros(4, bool),
                               tile_size=128, interpret=True)
    check(got, want, 0)
    assert (got.anchor_max == 0).all() and (got.gt_argmax == 0).all()


def test_kernel_wrapper_rejects_what_it_cannot_take():
    anchors = torch.rand(8, 4)
    with pytest.raises(ValueError, match="device"):
        am.anchor_match(anchors.to("meta"), torch.rand(1, 2, 4).to("meta"),
                        torch.ones(1, 2, dtype=torch.bool).to("meta"))


# ------------------------------------------------ the kernel's tile cull
#
# A model of csrc/anchor_match.cu: each tile of `tile` consecutive anchors
# (128 in the kernel) keeps, in ascending g, only the valid GTs that can
# overlap its bounding box, and each anchor walks that list with best = 0,
# best_g = 0 and a strict `>`. Held bit-equal to the plain version on the
# COCO anchors, with the IoU of each pair from geometry.iou_matrix (which
# the kernel reproduces bit for bit).

from objectdetection_torch.anchors import config_anchors  # noqa: E402
from objectdetection_torch.config import COCO_CONFIG  # noqa: E402
from objectdetection_torch.geometry import iou_matrix  # noqa: E402


def tile_boxes(anchors, tile):
    """[tiles, 4] bounding boxes (min y1, min x1, max y2, max x2) of the
    tiles, and [tiles] whether a tile holds a NaN coordinate."""
    a = anchors.shape[0]
    tiles = -(-a // tile)
    pad = tiles * tile - a
    inf = torch.full((pad, 2), float("inf"))
    lo = torch.cat([anchors[:, :2], inf]).reshape(tiles, tile, 2)
    hi = torch.cat([anchors[:, 2:], -inf]).reshape(tiles, tile, 2)
    nan = torch.cat([torch.isnan(anchors).any(1), torch.zeros(pad, dtype=torch.bool)])
    return torch.cat([lo.amin(1), hi.amax(1)], 1), nan.reshape(tiles, tile).any(1)


def tile_cull(anchors, gt, valid, tile):
    """[B, tiles, G] bool: GT g is on tile t's list. Only comparisons that
    hold cull (a NaN GT coordinate keeps it); a tile with a NaN anchor
    coordinate culls nothing."""
    box, nan = tile_boxes(anchors, tile)
    box, g = box[None, :, None, :], gt[:, None, :, :]
    miss = ((g[..., 2] <= box[..., 0]) | (g[..., 0] >= box[..., 2]) |
            (g[..., 3] <= box[..., 1]) | (g[..., 1] >= box[..., 3]))
    return valid[:, None, :].to(torch.bool) & ~(miss & ~nan[None, :, None])


def tile_walk(anchors, gt, valid, tile):
    """The kernel's answer from its lists."""
    a, gn = anchors.shape[0], gt.shape[1]
    listed = tile_cull(anchors, gt, valid, tile).repeat_interleave(tile, dim=1)[:, :a]
    iou = iou_matrix(anchors, gt)  # [B, A, G]
    best = torch.zeros(iou.shape[:2])
    best_g = torch.zeros(iou.shape[:2], dtype=torch.int32)
    for j in range(gn):  # ascending g; unlisted GTs are skipped
        upd = listed[..., j] & (iou[..., j] > best)
        best = torch.where(upd, iou[..., j], best)
        best_g = torch.where(upd, j, best_g)
    seen = torch.where(listed & (iou > 0), iou, torch.zeros(()))
    gmax = seen.amax(1)
    first = (seen == gmax[:, None, :]).to(torch.int32).argmax(1)  # the lowest anchor
    garg = torch.where(gmax > 0, first, torch.zeros_like(first)).to(torch.int32)
    culled_iou = torch.where(valid[:, None, :].to(torch.bool) & ~listed, iou, torch.zeros(()))
    return am.AnchorMatch(best, best_g, gmax, garg), listed, culled_iou


@pytest.fixture(scope="module")
def coco_anchors():
    return torch.from_numpy(config_anchors(COCO_CONFIG))


def edge_case(anchors, tile, g=24, seed=7):
    """GT boxes of realistic sizes on the COCO anchors with every case the
    cull must keep exact: ties, a GT that is an anchor, invalid rows that
    hold boxes, zero padding rows, zero-area GTs, and GTs whose edges lie
    exactly on a tile box's edges."""
    rng = np.random.RandomState(seed)
    y1x1 = rng.rand(2, g, 2) * 0.8
    hw = 0.02 + rng.rand(2, g, 2) ** 2 * 0.5
    gt = torch.from_numpy(np.concatenate([y1x1, np.minimum(y1x1 + hw, 1.0)], -1)
                          .astype(np.float32))
    valid = torch.from_numpy(rng.rand(2, g) > 0.2)
    box, _ = tile_boxes(anchors, tile)
    t = box[box.shape[0] // 3]  # a tile of P2
    gt[:, 1] = gt[:, 0]  # a duplicated GT: anchor argmax ties go low
    gt[:, 2] = anchors[1000]  # an anchor exactly
    gt[:, 3] = torch.stack([t[0] - 0.1, t[1], t[0], t[3]])  # ends on the tile's top edge
    gt[:, 4] = torch.stack([t[2], t[1], t[2] + 0.1, t[3]])  # starts on its bottom edge
    gt[:, 5] = torch.stack([t[0], t[1] - 0.1, t[2], t[1]])  # ends on its left edge
    gt[:, 6] = torch.stack([t[0], t[3], t[2], t[3] + 0.1])  # starts on its right edge
    gt[:, 7] = torch.stack([t[0], t[1], t[0], t[3]])  # zero height, on the tile
    gt[:, 8] = torch.stack([t[0], t[1], t[2], t[1]])  # zero width, on the tile
    valid[:, :9] = True
    valid[:, 9] = False  # an invalid row that holds a box over everything
    gt[:, 9] = torch.tensor([0.0, 0.0, 1.0, 1.0])
    valid[:, g - 4:] = False
    gt[:, g - 4:] = 0.0  # zero padding rows
    return gt, valid


@pytest.mark.parametrize("tile", [32, 128, 256])
def test_tile_cull_matches_plain_on_coco_anchors(coco_anchors, tile):
    gt, valid = edge_case(coco_anchors, tile)
    got, listed, culled_iou = tile_walk(coco_anchors, gt, valid, tile)
    want = am.anchor_match_plain(coco_anchors, gt, valid)
    for name, k, w in zip(want._fields, got, want):
        assert torch.equal(k, w), name
    assert not culled_iou.any()  # every pair the cull drops has IoU 0
    a = coco_anchors.shape[0]
    on_edges = listed[:, :, 3:7].reshape(2, -1, tile, 4)[:, a // 3 // tile]
    assert not on_edges.any()  # the four GTs on the tile's edges are culled there
    if tile == 128:  # the kernel's tile; the design's premise: most pairs never reach the IoU loop
        assert float(listed.float().mean()) < 0.35 * float(valid.float().mean())


def test_tile_cull_keeps_everything_beside_a_nan_anchor(coco_anchors):
    anchors = coco_anchors[:1024].clone()
    anchors[300, 2] = float("nan")
    gt, valid = edge_case(anchors, 256, g=12)
    listed = tile_cull(anchors, gt, valid, 256)
    assert torch.equal(listed[:, 1], valid)  # the NaN anchor's tile culls nothing
    assert not torch.equal(listed[:, 0], valid)
