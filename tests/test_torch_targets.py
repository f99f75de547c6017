"""Training targets, crop_and_resize and losses: the port against JAX.

Inputs are made with numpy from seeds; the target sampling noise is the
noise JAX draws from its keys (``jax.random.uniform`` after the splits each
function makes), rebuilt here and handed to the port. The JAX functions run
per image (as ``compute_losses`` vmaps them); the port's are batched.

Tolerances, stated:
- discrete targets (anchor classes, packed positives, sampled rows, class
  ids, mask targets) are equal. Seeds are chosen so that no anchor's best
  IoU lies within 1e-5 of the 0.3 / 0.7 thresholds (XLA on the CPU contracts
  multiply-adds into FMAs, which moves an IoU by an ulp; checked below);
- float targets (deltas, ROI boxes) within atol 1e-5;
- crop_and_resize within 1e-6 of JAX and 1e-5 of the TF golden (as the JAX
  package's own golden test);
- losses within rtol 1e-6 and their gradients within rtol 1e-5, atol 1e-8
  (one f32 reduction each, summed in another order).

Against the TF reference's executed graphs (``tests/golden/``, the bounds
of the JAX package's own golden tests): the detection targets' IoU within
1e-6, its sampled sets and (class, delta) assignments as sets (deltas
within 2e-5), and the four reference losses within rtol 1e-5.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from objectdetection_tpu import losses as jl
from objectdetection_tpu.anchors import config_anchors as j_config_anchors
from objectdetection_tpu.config import SHAPES_CONFIG as J_SHAPES
from objectdetection_tpu.layers import targets as jt
from objectdetection_tpu.ops.roi_align import crop_and_resize as j_crop

from objectdetection_torch import losses as tl
from objectdetection_torch.config import COCO_CONFIG as T_COCO
from objectdetection_torch.config import SHAPES_CONFIG as T_SHAPES
from objectdetection_torch.geometry import iou_matrix
from objectdetection_torch.layers import targets as tt
from objectdetection_torch.ops.roi_align import crop_and_resize

torch.set_num_threads(1)

GOLDEN = Path(__file__).parent / "golden"

SMALL = dict(image_shape=(64, 64, 3), image_min_dim=64, image_max_dim=64,
             rpn_train_anchors_per_image=64, train_rois_per_image=16, max_gt_objects=6)


def random_gt(rng, b, g, n_valid):
    y1x1 = rng.uniform(0.0, 0.6, (b, g, 2))
    hw = rng.uniform(0.08, 0.5, (b, g, 2))
    boxes = np.concatenate([y1x1, np.minimum(y1x1 + hw, 1.0)], -1).astype(np.float32)
    cls = rng.randint(1, 4, (b, g)).astype(np.int32)
    for i, n in enumerate(n_valid):
        cls[i, n:] = 0
        boxes[i, n:] = 0.0
    return boxes, cls


def split_noise(keys, n):
    """The (positives, negatives) uniform draws of a target function per key."""
    pairs = [jax.random.split(k) for k in keys]
    return tuple(np.stack([np.asarray(jax.random.uniform(p[i], (n,))) for p in pairs])
                 for i in range(2))


def as_torch(noise):
    return tuple(torch.from_numpy(x) for x in noise)


# ---------------------------------------------------------------- noise ranks


def test_rank_among_matches_jax_with_ties():
    rng = np.random.RandomState(0)
    mask = rng.rand(3, 300) < 0.6
    noise = np.round(rng.rand(3, 300) * 40).astype(np.float32) / 40  # many ties
    got = tt._rank_among(torch.from_numpy(mask), torch.from_numpy(noise)).numpy()
    want = np.stack([np.asarray(jax.vmap(lambda m, n: jnp.where(
        m, jnp.zeros(300, jnp.int32).at[jnp.argsort(jnp.where(m, n, 2.0))].set(
            jnp.arange(300, dtype=jnp.int32)), 300))(jnp.asarray(mask), jnp.asarray(noise)))])[0]
    np.testing.assert_array_equal(got, want)
    # the ranks of each row's True entries are a permutation of 0..k-1
    for m, r in zip(mask, got):
        assert sorted(r[m].tolist()) == list(range(int(m.sum())))


# ---------------------------------------------------------------- rpn targets


@pytest.mark.parametrize("seed,n_valid", [(0, (6, 3)), (1, (2, 0)), (2, (1, 6))])
def test_rpn_targets_match_jax(seed, n_valid):
    jcfg, tcfg = J_SHAPES.replace(**SMALL), T_SHAPES.replace(**SMALL)
    anchors = j_config_anchors(jcfg)
    rng = np.random.RandomState(seed)
    boxes, cls = random_gt(rng, 2, 6, n_valid)
    valid = cls > 0
    keys = jax.random.split(jax.random.PRNGKey(seed), 2)
    want = [jt.rpn_targets(jnp.asarray(anchors), jnp.asarray(boxes[i]), jnp.asarray(valid[i]),
                           jcfg, keys[i]) for i in range(2)]
    # no best IoU sits on a threshold (where an FMA could flip the class)
    best = iou_matrix(torch.from_numpy(anchors), torch.from_numpy(boxes)).where(
        torch.from_numpy(valid)[:, None, :], torch.tensor(0.0)).max(-1).values
    assert float(torch.minimum((best - 0.3).abs(), (best - 0.7).abs()).min()) > 1e-5
    got = tt.rpn_targets(torch.from_numpy(anchors), torch.from_numpy(boxes),
                         torch.from_numpy(valid), tcfg,
                         noise=as_torch(split_noise(keys, anchors.shape[0])))
    for i in range(2):
        np.testing.assert_array_equal(got.target_class[i].numpy(), np.asarray(want[i].target_class))
        np.testing.assert_allclose(got.target_deltas[i].numpy(),
                                   np.asarray(want[i].target_deltas), atol=1e-5, rtol=0)
        assert int(got.num_positives[i]) == int(want[i].num_positives)
    n_pos = got.num_positives.tolist()
    if 0 in n_valid:  # an image without GT gets no positives
        assert n_pos[n_valid.index(0)] == 0


def test_rpn_targets_force_positive_with_shared_and_invalid_argmax():
    # two GTs share their best anchor; an invalid GT's argmax is anchor 0
    jcfg, tcfg = J_SHAPES.replace(**SMALL), T_SHAPES.replace(**SMALL)
    anchors = j_config_anchors(jcfg)
    a0 = anchors[0]
    boxes = np.zeros((1, 4, 4), np.float32)
    boxes[0, 0] = anchors[700] + np.array([0.0, 0.0, 0.001, 0.0], np.float32)
    boxes[0, 1] = anchors[700] + np.array([0.0, 0.0, 0.0, 0.001], np.float32)
    boxes[0, 2] = a0  # invalid below: must not force anchor 0
    valid = np.array([[True, True, False, False]])
    key = jax.random.PRNGKey(9)
    want = jt.rpn_targets(jnp.asarray(anchors), jnp.asarray(boxes[0]), jnp.asarray(valid[0]),
                          jcfg, key)
    got = tt.rpn_targets(torch.from_numpy(anchors), torch.from_numpy(boxes),
                         torch.from_numpy(valid), tcfg,
                         noise=as_torch(split_noise(key[None], anchors.shape[0])))
    np.testing.assert_array_equal(got.target_class[0].numpy(), np.asarray(want.target_class))
    assert int(got.target_class[0, 700]) == 1
    assert int(got.target_class[0, 0]) != 1


# ---------------------------------------------------------------- detection targets


def _proposals(rng, gt, n):
    """Jittered copies of the GT boxes (positives) plus random boxes and zero
    padding rows."""
    b = gt.shape[0]
    near = gt[:, rng.randint(0, gt.shape[1], n // 2)] + rng.normal(0, 0.03, (b, n // 2, 4))
    y1x1 = rng.uniform(0, 0.8, (b, n - n // 2, 2))
    far = np.concatenate([y1x1, y1x1 + rng.uniform(0.05, 0.3, (b, n - n // 2, 2))], -1)
    props = np.clip(np.concatenate([near, far], 1), 0, 1).astype(np.float32)
    props = np.concatenate([np.minimum(props[..., :2], props[..., 2:]),
                            np.maximum(props[..., :2], props[..., 2:])], -1)
    props[:, -5:] = 0.0
    return props


@pytest.mark.parametrize("mini", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_detection_targets_match_jax(seed, mini):
    mask_hw = (24, 24) if mini else (64, 64)
    over = dict(use_mini_mask=mini, mini_mask_shape=mask_hw if mini else (0, 0))
    jcfg = J_SHAPES.replace(**SMALL, **over)
    tcfg = T_SHAPES.replace(**SMALL, **over)
    rng = np.random.RandomState(seed)
    gt, cls = random_gt(rng, 2, 6, (5, 3))
    props = _proposals(rng, gt, 60)
    masks = (rng.rand(2, 6, *mask_hw) < 0.5).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(10 + seed), 2)
    want = [jt.detection_targets(jnp.asarray(props[i]), jnp.asarray(gt[i]), jnp.asarray(cls[i]),
                                 jcfg, keys[i], gt_masks=jnp.asarray(masks[i]),
                                 masks_are_mini=mini) for i in range(2)]
    got = tt.detection_targets(torch.from_numpy(props), torch.from_numpy(gt),
                               torch.from_numpy(cls), tcfg,
                               noise=as_torch(split_noise(keys, props.shape[1])),
                               gt_masks=torch.from_numpy(masks), masks_are_mini=mini)
    for i in range(2):
        w = jax.tree.map(np.asarray, want[i])
        np.testing.assert_array_equal(got.valid_mask[i].numpy(), w.valid_mask)
        np.testing.assert_array_equal(got.pos_mask[i].numpy(), w.pos_mask)
        np.testing.assert_array_equal(got.target_class_ids[i].numpy(), w.target_class_ids)
        np.testing.assert_allclose(got.rois[i].numpy(), w.rois, atol=1e-6, rtol=0)
        np.testing.assert_allclose(got.target_deltas[i].numpy(), w.target_deltas, atol=1e-5,
                                   rtol=0)
        np.testing.assert_array_equal(got.target_masks[i].numpy(), w.target_masks)
        assert w.pos_mask.sum() > 0 and w.target_masks.sum() > 0


def test_detection_targets_pad_when_fewer_proposals_than_budget():
    jcfg = J_SHAPES.replace(**dict(SMALL, train_rois_per_image=32))
    tcfg = T_SHAPES.replace(**dict(SMALL, train_rois_per_image=32))
    rng = np.random.RandomState(4)
    gt, cls = random_gt(rng, 1, 3, (3,))
    props = _proposals(rng, gt, 20)
    key = jax.random.PRNGKey(3)
    want = jax.tree.map(np.asarray, jt.detection_targets(
        jnp.asarray(props[0]), jnp.asarray(gt[0]), jnp.asarray(cls[0]), jcfg, key))
    got = tt.detection_targets(torch.from_numpy(props), torch.from_numpy(gt),
                               torch.from_numpy(cls), tcfg,
                               noise=as_torch(split_noise(key[None], 20)))
    assert got.rois.shape == (1, 32, 4)
    np.testing.assert_array_equal(got.valid_mask[0].numpy(), want.valid_mask)
    np.testing.assert_array_equal(got.target_class_ids[0].numpy(), want.target_class_ids)
    np.testing.assert_allclose(got.rois[0].numpy(), want.rois, atol=1e-6, rtol=0)


def test_targets_draw_their_noise_from_a_generator():
    tcfg = T_SHAPES.replace(**SMALL)
    anchors = torch.from_numpy(j_config_anchors(J_SHAPES.replace(**SMALL)))
    rng = np.random.RandomState(5)
    gt, cls = (torch.from_numpy(x) for x in random_gt(rng, 2, 6, (4, 2)))
    a = tt.rpn_targets(anchors, gt, cls > 0, tcfg, generator=torch.Generator().manual_seed(1))
    b = tt.rpn_targets(anchors, gt, cls > 0, tcfg, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a.target_class, b.target_class)
    assert int((a.target_class != 0).sum()) == 2 * tcfg.rpn_train_anchors_per_image


# ---------------------------------------------------------------- crop_and_resize


def test_crop_and_resize_matches_jax_outside_the_image():
    rng = np.random.RandomState(0)
    image = rng.randn(13, 17, 3).astype(np.float32)
    y1x1 = rng.uniform(-0.5, 1.0, (40, 2))
    boxes = np.concatenate([y1x1, y1x1 + rng.uniform(-0.2, 0.9, (40, 2))], -1).astype(np.float32)
    boxes[0] = [0.0, 0.0, 1.0, 1.0]
    boxes[1] = [0.3, 0.3, 0.3, 0.3]  # a point
    for crop in ((7, 7), (14, 5), (1, 1), (1, 4)):
        want = np.asarray(j_crop(jnp.asarray(image), jnp.asarray(boxes), crop))
        got = crop_and_resize(torch.from_numpy(image), torch.from_numpy(boxes), crop).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
        assert (want == 0).any()  # some samples fall outside the image


@pytest.mark.parametrize("size", [7, 14])
def test_crop_and_resize_matches_tf_golden(size):
    g = np.load(GOLDEN / "reference_crop_resize.npz")
    fmap, boxes, box_ind = g["fmap"], g["boxes"], g["box_ind"]
    # batched form: each box with its own image
    got = crop_and_resize(torch.from_numpy(fmap[box_ind]), torch.from_numpy(boxes)[:, None],
                          (size, size))[:, 0]
    np.testing.assert_allclose(got.numpy(), g[f"crop{size}"], atol=1e-5, rtol=0)


# ---------------------------------------------------------------- losses


def _loss_inputs(seed):
    rng = np.random.RandomState(seed)
    b, a, k, t, c = 2, 50, 12, 10, 5
    d = dict(
        target_class=rng.randint(-1, 2, (b, a)).astype(np.int32),
        rpn_logits=rng.randn(b, a, 2).astype(np.float32),
        rpn_deltas=rng.randn(b, a, 4).astype(np.float32),
        rpn_target_deltas=rng.randn(b, k, 4).astype(np.float32) * 2,
        class_ids=rng.randint(0, c, (b, t)).astype(np.int32),
        cls_logits=rng.randn(b, t, c).astype(np.float32),
        active=(rng.rand(b, c) < 0.7).astype(np.int32),
        bbox=rng.randn(b, t, c, 4).astype(np.float32),
        det_deltas=rng.randn(b, t, 4).astype(np.float32),
        target_masks=(rng.rand(b, t, 6, 6) < 0.5).astype(np.float32),
        mask_probs=rng.rand(b, t, 6, 6, c).astype(np.float32),
    )
    d["target_class"][1] = np.minimum(d["target_class"][1], 0)  # image without positives
    # predictions exactly on the clip bounds and saturated at 1.0 (gradient at ties)
    mp = d["mask_probs"]
    mp[0, :, 0, 0, :] = np.float32(1e-7)
    mp[0, :, 0, 1, :] = np.float32(1 - 1e-7)
    mp[0, :, 0, 2, :] = 1.0
    mp[0, :, 0, 3, :] = 0.0
    d["compat_bbox"] = rng.uniform(-0.2, 1.2, (b, t, c, 4)).astype(np.float32)
    d["compat_bbox"][0, :, :, 0] = np.float32(1e-7)
    d["compat_targets"] = rng.rand(b, t, 4).astype(np.float32)
    return d


LOSSES = {
    "rpn_class_loss": (("target_class", "rpn_logits"), (1,), {}),
    "rpn_box_loss": (("rpn_target_deltas", "rpn_deltas", "target_class"), (0, 1), {}),
    "mrcnn_class_loss": (("class_ids", "cls_logits", "active"), (1,), {}),
    "mrcnn_box_loss": (("det_deltas", "bbox", "class_ids"), (0, 1), {}),
    "mrcnn_box_loss_compat": (("compat_targets", "compat_bbox", "class_ids"), (0, 1),
                              {"compat_reference": True}),
    "mask_loss": (("target_masks", "mask_probs", "class_ids"), (1,), {}),
}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_and_gradient_match_jax(name, seed):
    keys, diff, kw = LOSSES[name]
    fn = name.replace("_compat", "")
    d = _loss_inputs(seed)
    args = [d[k] for k in keys]
    jfn = getattr(jl, fn)

    def jloss(*floats):
        full = list(args)
        for i, x in zip(diff, floats):
            full[i] = x
        return jfn(*[jnp.asarray(x) for x in full], **kw)

    want, want_grads = jax.value_and_grad(jloss, argnums=tuple(range(len(diff))))(
        *[jnp.asarray(args[i]) for i in diff])
    targs = [torch.from_numpy(x).clone() for x in args]
    for i in diff:
        targs[i].requires_grad_(True)
    got = getattr(tl, fn)(*targs, **kw)
    got_grads = torch.autograd.grad(got, [targs[i] for i in diff])
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    assert float(want) > 0
    for g, w in zip(got_grads, want_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-8)


def test_total_loss_is_the_sum():
    parts = {"a": torch.tensor(1.5), "b": torch.tensor(0.25), "c": torch.tensor(2.0)}
    assert float(tl.total_loss(parts)) == float(jl.total_loss(
        {k: jnp.float32(float(v)) for k, v in parts.items()}))


def test_losses_are_zero_without_positives():
    z = torch.zeros
    assert float(tl.rpn_box_loss(z(1, 4, 4), z(1, 9, 4), torch.full((1, 9), -1))) == 0.0
    assert float(tl.mrcnn_box_loss(z(1, 3, 4), z(1, 3, 5, 4), z(1, 3, dtype=torch.int32))) == 0.0
    assert float(tl.mask_loss(z(1, 3, 2, 2), torch.rand(1, 3, 2, 2, 5),
                              z(1, 3, dtype=torch.int32))) == 0.0



# ---------------------------------------------------------------- TF goldens


def test_detection_targets_match_tf_golden():
    # inputs engineered so that every eligible proposal is kept: the sampled
    # sets are deterministic, only their order is random
    g = np.load(GOLDEN / "reference_detection_targets.npz")
    cfg = T_COCO.replace(train_rois_per_image=int(g["train_rois_per_image"]),
                         bbox_stddev=tuple(float(v) for v in g["bbox_stddev"]))
    n_prop, n_gt = g["iou"].shape
    iou = iou_matrix(torch.from_numpy(g["proposals"][:n_prop]),
                     torch.from_numpy(g["gt_boxes"][:n_gt])).numpy()
    np.testing.assert_allclose(iou, g["iou"], atol=1e-6)
    np.testing.assert_allclose(iou.max(axis=1), g["roi_iou_max"], atol=1e-6)
    out = tt.detection_targets(torch.from_numpy(g["proposals"])[None],
                               torch.from_numpy(g["gt_boxes"])[None],
                               torch.from_numpy(g["gt_class_ids"])[None], cfg,
                               generator=torch.Generator().manual_seed(7))
    n_pos = int(g["pos_count"])
    assert int(out.pos_mask.sum()) == n_pos

    def key(row):
        return tuple(np.round(row.astype(np.float64), 6))

    ref_rois, ref_cls, ref_deltas = g["rois"], g["roi_gt_class_ids"][0], g["roi_gt_box_deltas"]
    n_valid = int((np.abs(ref_rois).sum(1) > 0).sum())
    ref_pos = {key(ref_rois[i]): (int(ref_cls[i]), ref_deltas[i]) for i in range(n_pos)}
    ref_neg = {key(ref_rois[i]) for i in range(n_pos, n_valid)}
    rois, pos, valid = out.rois[0].numpy(), out.pos_mask[0].numpy(), out.valid_mask[0].numpy()
    my_pos = {key(rois[i]): (int(out.target_class_ids[0, i]), out.target_deltas[0, i].numpy())
              for i in range(len(rois)) if pos[i]}
    my_neg = {key(rois[i]) for i in range(len(rois)) if valid[i] and not pos[i]}
    assert set(my_pos) == set(ref_pos) and my_neg == ref_neg
    for k, (cls, deltas) in ref_pos.items():
        assert my_pos[k][0] == cls
        np.testing.assert_allclose(my_pos[k][1], deltas, atol=2e-5)


def test_losses_match_tf_golden():
    sys.path.insert(0, str(Path(__file__).parents[1] / "tools"))
    import gen_reference_goldens

    g = np.load(GOLDEN / "reference_losses.npz")
    x = {k: torch.from_numpy(v) for k, v in gen_reference_goldens.make_loss_inputs().items()}
    got = {
        "rpn_class_loss": tl.rpn_class_loss(x["target_class"], x["rpn_logits"]),
        "rpn_box_loss": tl.rpn_box_loss(x["rpn_target_bbox"], x["rpn_pred_box"],
                                        x["target_class"]),
        "mrcnn_class_loss": tl.mrcnn_class_loss(x["mrcnn_target_class"], x["mrcnn_logits"],
                                                x["active"]),
        "mrcnn_box_loss": tl.mrcnn_box_loss(x["mrcnn_target_box"], x["mrcnn_pred_box"],
                                            x["mrcnn_target_class"], compat_reference=True),
    }
    for k, v in got.items():
        np.testing.assert_allclose(float(v), float(g[k]), rtol=1e-5, err_msg=k)
