"""Slice parity: the port's forward_inference against the JAX package's.

The e2e_small config (R50, 64², f32, masks on) of test_golden_regression.py,
weights from ``init_variables(cfg, PRNGKey(42))`` converted to a state dict,
and the same numpy-seeded molded images through both. Run as configured and
with ``detection_min_threshold=0.0`` so that detections and masks carry rows.

Tolerances: every float stage is held at rtol/atol 1e-4 (f32 throughout; the
two frameworks sum convolutions in different orders, ~1e-6 relative per op,
compounded over ~50 conv layers). The discrete outputs are held exactly:
which proposals and detections exist, their class ids.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from objectdetection_tpu import detector as jdet
from objectdetection_tpu.config import SHAPES_CONFIG as J_SHAPES

from objectdetection_torch import detector as tdet
from objectdetection_torch.config import SHAPES_CONFIG as T_SHAPES
from objectdetection_torch.convert import flax_to_state_dict
from objectdetection_torch.ops.roi_align import batched_multilevel_roi_align

torch.set_num_threads(1)

SMALL = dict(
    image_shape=(64, 64, 3),
    image_min_dim=64,
    image_max_dim=64,
    pre_nms_rois_count=128,
    post_nms_rois_training=48,
    post_nms_rois_inference=32,
    train_rois_per_image=8,
    rpn_train_anchors_per_image=32,
    max_gt_objects=4,
    compute_dtype="float32",
)
TOL = dict(rtol=1e-4, atol=1e-4)


def _weights(**overrides):
    jcfg = J_SHAPES.replace(**SMALL, **overrides)
    variables = jdet.init_variables(jcfg, jax.random.PRNGKey(42))
    np_vars = jax.tree.map(np.asarray, variables)
    return variables, flax_to_state_dict(np_vars)


@pytest.fixture(scope="module")
def weights():
    return _weights()


def _images(seed=123):
    rng = np.random.RandomState(seed)
    # smooth blobs on noise, mean-subtracted scale (the shapes config
    # multiplies by input_scale 1/64 inside the model)
    img = rng.uniform(-60.0, 60.0, (2, 64, 64, 3)).astype(np.float32)
    yy, xx = np.mgrid[:64, :64]
    for b in range(2):
        for _ in range(3):
            cy, cx, r = rng.uniform(10, 54), rng.uniform(10, 54), rng.uniform(5, 14)
            img[b][(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] += rng.uniform(-80, 80, 3)
    windows = np.tile(np.array([[0.0, 0.0, 64.0, 64.0]], np.float32), (2, 1))
    return img, windows


def _run_both(weights, **overrides):
    variables, params = weights
    jcfg = J_SHAPES.replace(**SMALL, **overrides)
    tcfg = T_SHAPES.replace(**SMALL, **overrides)
    images, windows = _images()
    # jitted, as the JAX package serves it (detector.make_infer_fn)
    jfwd = jax.jit(functools.partial(
        jdet.forward_inference, config=jcfg, with_masks=True, return_intermediates=True,
    ))
    jres, jint = jfwd(variables, jnp.asarray(images), jnp.asarray(windows))
    with torch.inference_mode():
        tres, tint = tdet.forward_inference(
            params, torch.from_numpy(images), torch.from_numpy(windows), tcfg,
            with_masks=True, return_intermediates=True,
        )
    return jres, jint, tres, tint


def _check(jres, jint, tres, tint):
    for k in ("p2", "p3", "p4", "p5", "p6"):
        np.testing.assert_allclose(tint["pyramid"][k].numpy(),
                                   np.asarray(jint["pyramid"][k]), **TOL)
    for k in ("rpn_class_logits", "rpn_class_probs", "rpn_bbox"):
        np.testing.assert_allclose(tint[k].numpy(), np.asarray(jint[k]), **TOL)
    jp, tp = np.asarray(jint["proposals"]), tint["proposals"].numpy()
    np.testing.assert_array_equal((tp != 0).any(-1), (jp != 0).any(-1))
    np.testing.assert_allclose(tp, jp, **TOL)
    for k in ("mrcnn_class_probs", "mrcnn_bbox"):
        np.testing.assert_allclose(tint[k].numpy(), np.asarray(jint[k]), **TOL)
    np.testing.assert_array_equal(tres.valid.numpy(), np.asarray(jres.valid))
    np.testing.assert_array_equal(tres.class_ids.numpy(), np.asarray(jres.class_ids))
    np.testing.assert_allclose(tres.scores.numpy(), np.asarray(jres.scores), **TOL)
    np.testing.assert_allclose(tres.boxes.numpy(), np.asarray(jres.boxes), **TOL)
    assert tres.masks.shape == jres.masks.shape
    np.testing.assert_allclose(tres.masks.numpy(), np.asarray(jres.masks), **TOL)


def test_forward_inference_matches_jax(weights):
    _check(*_run_both(weights))


def test_forward_inference_matches_jax_all_detections(weights):
    jres, jint, tres, tint = _run_both(weights, detection_min_threshold=0.0)
    assert int(np.asarray(jres.valid).sum()) > 0  # detections and masks carry rows
    _check(jres, jint, tres, tint)


def _check_tight(jres, jint, tres, tint):
    """Off-default configs at the tolerances the repairs were measured to
    meet: RPN logits within 1e-5, proposals, boxes and masks within 1e-6."""
    _check(jres, jint, tres, tint)
    assert int(np.asarray(jres.valid).sum()) > 0
    np.testing.assert_allclose(tint["rpn_class_logits"].numpy(),
                               np.asarray(jint["rpn_class_logits"]), rtol=0, atol=1e-5)
    for got, want in ((tint["proposals"], jint["proposals"]), (tres.boxes, jres.boxes),
                      (tres.masks, jres.masks)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_strided_rpn_conv_matches_jax(weights):
    # the RPN's shared 3×3 conv at stride 2 pads as flax "SAME" does (the odd
    # row and column at the high end)
    jres, jint, tres, tint = _run_both(weights, rpn_anchor_stride=2,
                                       detection_min_threshold=0.0)
    assert tint["rpn_class_logits"].shape == jint["rpn_class_logits"].shape
    _check_tight(jres, jint, tres, tint)


def test_narrow_fpn_matches_jax():
    # the mask head stays 256 wide when the FPN is narrower, as in the flax model
    narrow = _weights(fpn_channels=64)
    tdet.check_state(narrow[1], T_SHAPES.replace(**SMALL, fpn_channels=64))
    assert tuple(narrow[1]["mrcnn_mask.mrcnn_mask_conv1.weight"].shape) == (256, 64, 3, 3)
    _check_tight(*_run_both(narrow, fpn_channels=64, detection_min_threshold=0.0))


def test_non_square_pool_shape_matches_jax():
    # C3: the box head's dense is ph·pw·C wide, flattened in (h, w, c) order
    wide = _weights(pool_shape=(7, 5))
    jres, jint, tres, tint = _run_both(wide, pool_shape=(7, 5), detection_min_threshold=0.0)
    assert tuple(tint["roi_pooled"].shape[2:4]) == (7, 5)
    assert int(np.asarray(jres.valid).sum()) > 0
    _check(jres, jint, tres, tint)


def test_make_infer_fn_cpu_matches_forward(weights):
    _, params = weights
    cfg = T_SHAPES.replace(**SMALL, detection_min_threshold=0.0)
    images, windows = _images()
    det = tdet.make_infer_fn(cfg, device="cpu")(params, images, windows)
    ref = tdet.forward_inference(params, torch.from_numpy(images),
                                 torch.from_numpy(windows), cfg)
    for a, b in zip(det, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_intermediates_hold_the_roi_align_outputs(weights):
    # the pooled tensors the heads consumed, as the card check reads them
    _, params = weights
    cfg = T_SHAPES.replace(**SMALL, detection_min_threshold=0.0)
    images, windows = _images()
    with torch.inference_mode():
        _, it = tdet.forward_inference(params, torch.from_numpy(images),
                                       torch.from_numpy(windows), cfg,
                                       return_intermediates=True)
    feats = [it["pyramid"][f"p{i}"] for i in range(2, 6)]
    image = cfg.image_shape[:2]
    det = it["detections"]
    assert int((det[..., 5] > 0).sum()) > 0
    roi = batched_multilevel_roi_align(feats, it["proposals"], image, cfg.pool_shape)
    mask = batched_multilevel_roi_align(feats, det[..., :4], image, cfg.mask_pool_shape)
    assert torch.equal(it["roi_pooled"], roi)
    assert torch.equal(it["mask_pooled"], mask)
