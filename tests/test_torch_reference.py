"""The port against the goldens the reference's own TF graphs computed.

``tests/golden/reference_*.npz`` hold stage outputs of the reference's code
on seeded inputs and weights (tools/gen_reference_goldens.py). Each test
builds the weights as the matching JAX test in test_reference_goldens.py
does, in the flax layout, and hands them to the port through
``flax_to_state_dict``; the tolerances are that test's. The end-to-end check
(R101 + FPN, 256², 4 classes, f32) is slow: a full R101 forward plus the flax
init of an R101 tree on the CPU.
"""

import jax
import numpy as np
import pytest
import torch

import test_reference_goldens as ref

from objectdetection_torch import detector as tdet
from objectdetection_torch.config import COCO_CONFIG
from objectdetection_torch.convert import flax_to_state_dict
from objectdetection_torch.geometry import norm_boxes
from objectdetection_torch.layers.detection import detection_layer
from objectdetection_torch.layers.proposals import proposal_layer
from objectdetection_torch.models.heads import BoxClassHead, MaskHead
from objectdetection_torch.models.rpn import RPNHead
from objectdetection_torch.ops.roi_align import batched_multilevel_roi_align

torch.set_num_threads(1)


def loaded(module, params, batch_stats=None):
    tree = {"params": params}
    if batch_stats is not None:
        tree["batch_stats"] = batch_stats
    module.load_state_dict(flax_to_state_dict(tree))
    return module.eval()


def test_proposals_match_reference():
    g = ref.load("reference_proposals.npz")
    cfg = COCO_CONFIG.replace(
        rpn_bbox_stddev=tuple(float(v) for v in g["rpn_bbox_stddev"]),
        pre_nms_rois_count=int(g["pre_nms"]),
        post_nms_rois_inference=int(g["post_nms_inference"]),
        rpn_nms_threshold=float(g["nms_threshold"]),
    )
    want = g["proposals_inference"]
    for b in range(g["probs"].shape[0]):
        got = proposal_layer(torch.from_numpy(g["probs"][b:b + 1]),
                             torch.from_numpy(g["deltas"][b:b + 1]),
                             torch.from_numpy(g["anchors"][b]), cfg)[0].numpy()
        n_want = int((np.abs(want[b]).sum(axis=1) > 0).sum())
        assert int((np.abs(got).sum(axis=1) > 0).sum()) == n_want
        np.testing.assert_allclose(got[:n_want], want[b, :n_want], atol=1e-3)


def test_detections_match_reference():
    g = ref.load("reference_detection.npz")
    cfg = COCO_CONFIG.replace(
        num_classes=int(g["probs"].shape[-1]),
        bbox_stddev=tuple(float(v) for v in g["bbox_stddev"]),
        detection_min_threshold=float(g["min_confidence"]),
        detection_nms_threshold=float(g["nms_threshold"]),
        detection_post_nms_instances=int(g["max_instances"]),
    )
    image_shape = tuple(int(v) for v in g["image_shape"][:2])
    window = norm_boxes(torch.as_tensor(g["window"], dtype=torch.float32), image_shape)
    got = detection_layer(torch.from_numpy(g["proposals"]), torch.from_numpy(g["probs"]),
                          torch.from_numpy(g["deltas"]), window, cfg)[0].numpy()
    want = g["detections"][0]
    n_want = int((np.abs(want).sum(axis=1) > 0).sum())
    assert int((np.abs(got).sum(axis=1) > 0).sum()) == n_want
    np.testing.assert_allclose(got[:n_want, :4], want[:n_want, :4], atol=1e-3)
    np.testing.assert_array_equal(got[:n_want, 4].astype(np.int32),
                                  want[:n_want, 4].astype(np.int32))
    np.testing.assert_allclose(got[:n_want, 5], want[:n_want, 5], atol=1e-4)


def test_rpn_matches_reference():
    g = ref.load("reference_rpn.npz")
    w = ref.golden_weights(g, seed=4321)
    params = {name: {"kernel": w[f"{name}/kernel:0"], "bias": w[f"{name}/bias:0"]}
              for name in ("rpn_conv_shared", "rpn_class_raw", "rpn_bbox_pred")}
    head = loaded(RPNHead(anchors_per_location=3), params)
    fmap = torch.from_numpy(ref._tools("make_rpn_input")()).permute(0, 3, 1, 2)
    with torch.inference_mode():
        logits, probs, deltas = head([fmap])
    np.testing.assert_allclose(logits.numpy(), g["logits"], atol=1e-4)
    np.testing.assert_allclose(probs.numpy(), g["probs"], atol=1e-5)
    np.testing.assert_allclose(deltas.numpy(), g["bbox"], atol=1e-4)


def test_roi_pooling_and_box_head_match_reference():
    g = ref.load("reference_mrcnn_head.npz")
    feats, proposals = ref._tools("make_mrcnn_head_inputs")()
    pooled = batched_multilevel_roi_align(
        [torch.from_numpy(f) for f in feats], torch.from_numpy(proposals), (1024, 1024), (7, 7))
    np.testing.assert_allclose(pooled.numpy(), g["pooled"], atol=1e-4)

    w = ref.golden_weights(g, seed=1234)
    nc = int(g["probs"].shape[-1])
    neutral = np.full((1024,), np.sqrt(1.0 + 1e-3), np.float32)  # the TF head has no BN
    params = {
        "mrcnn_class_conv1": {"kernel": w["mrcnn_class_conv1/kernel:0"].reshape(-1, 1024),
                              "bias": w["mrcnn_class_conv1/bias:0"]},
        "mrcnn_class_conv2": {"kernel": w["mrcnn_class_conv2/kernel:0"].reshape(1024, 1024),
                              "bias": w["mrcnn_class_conv2/bias:0"]},
        "mrcnn_class_bn1": {"scale": neutral, "bias": np.zeros(1024, np.float32)},
        "mrcnn_class_bn2": {"scale": neutral, "bias": np.zeros(1024, np.float32)},
        "mrcnn_class_logits": {
            "kernel": w["mrcnn_class_scores/mrcnn_class_logits/kernel:0"],
            "bias": w["mrcnn_class_scores/mrcnn_class_logits/bias:0"]},
        "mrcnn_bbox_fc": {"kernel": w["mrcnn_class_bbox/mrcnn_bbox/kernel:0"],
                          "bias": w["mrcnn_class_bbox/mrcnn_bbox/bias:0"]},
    }
    stats = {f"mrcnn_class_bn{i}": {"mean": np.zeros(1024, np.float32),
                                    "var": np.ones(1024, np.float32)} for i in (1, 2)}
    head = loaded(BoxClassHead(nc), params, stats)
    with torch.inference_mode():
        _, probs, bbox = head(torch.from_numpy(g["pooled"]), torch.float32)
    np.testing.assert_allclose(probs.numpy(), g["probs"], atol=1e-4)
    np.testing.assert_allclose(bbox.numpy(), g["bbox"], atol=1e-3)


def test_mask_head_matches_reference():
    g = ref.load("reference_mask_head.npz")
    w = ref.he_golden_weights(g, seed=8080)
    nc = int(g["masks"].shape[-1])
    params, stats = {}, {}
    for i in range(1, 5):
        params[f"mrcnn_mask_conv{i}"] = {"kernel": w[f"mrcnn_mask_conv{i}/kernel:0"],
                                         "bias": w[f"mrcnn_mask_conv{i}/bias:0"]}
        params[f"mrcnn_mask_bn{i}"] = {"scale": w[f"mrcnn_mask_bn{i}/gamma:0"],
                                       "bias": w[f"mrcnn_mask_bn{i}/beta:0"]}
        stats[f"mrcnn_mask_bn{i}"] = {"mean": w[f"mrcnn_mask_bn{i}/moving_mean:0"],
                                      "var": w[f"mrcnn_mask_bn{i}/moving_variance:0"]}
    # TF's conv2d_transpose filter [kh, kw, out, in] is spatially flipped
    # against the flax ConvTranspose layout [kh, kw, in, out]
    wd = w["mrcnn_mask_deconv/kernel:0"]
    params["mrcnn_mask_deconv"] = {"kernel": np.transpose(np.flip(wd, axis=(0, 1)), (0, 1, 3, 2)),
                                   "bias": w["mrcnn_mask_deconv/bias:0"]}
    params["mrcnn_mask"] = {"kernel": w["mrcnn_mask/kernel:0"], "bias": w["mrcnn_mask/bias:0"]}
    pooled = torch.from_numpy(ref._tools("make_mask_head_inputs")())[None]
    head = loaded(MaskHead(nc, cin=pooled.shape[-1]), params, stats)
    with torch.inference_mode():
        masks = head(pooled, None, torch.float32)
    np.testing.assert_allclose(masks[0].numpy(), g["masks"], atol=2e-5)


@pytest.mark.slow  # R101 f32 at 256² on the CPU, both frameworks
def test_port_matches_reference_end_to_end():
    g = ref.load("reference_end_to_end.npz")
    variables, _ = ref.TestReferenceEndToEnd()._variables_and_cfg(g)
    params = flax_to_state_dict(jax.tree.map(np.asarray, variables))
    cfg = COCO_CONFIG.replace(
        image_shape=(256, 256, 3), image_min_dim=256, image_max_dim=256,
        num_classes=4, compute_dtype="float32", use_approx_topk=False,
    )
    with torch.inference_mode():
        det, inter = tdet.forward_inference(
            params, torch.from_numpy(g["image"]), torch.from_numpy(g["window"]), cfg,
            with_masks=False, return_intermediates=True,
        )
    for i in (2, 3, 4, 5, 6):
        np.testing.assert_allclose(inter["pyramid"][f"p{i}"].numpy(), g[f"p{i}"],
                                   atol=5e-3, err_msg=f"P{i}")
    np.testing.assert_allclose(inter["rpn_class_probs"].numpy(), g["rpn_probs"], atol=2e-3)
    np.testing.assert_allclose(inter["rpn_bbox"].numpy(), g["rpn_deltas"], atol=2e-3)
    ours = inter["proposals"][0].numpy()
    assert ref._match_rate(g["proposals"][0][:500], ours, iou_thr=0.995) > 0.98

    dref = g["detections"][0]
    dours = np.concatenate([det.boxes[0].numpy(),
                            det.class_ids[0].numpy()[:, None].astype(np.float32),
                            det.scores[0].numpy()[:, None]], axis=1)
    ref_rows = dref[dref[:, 5] > 0.75]
    our_rows = dours[dours[:, 5] > 0.0]
    assert len(ref_rows) > 10
    matched = 0
    for r in ref_rows:
        linf = np.abs(our_rows[:, :4] - r[None, :4]).max(axis=1)
        box_ok = (linf <= 2e-3) | (ref._iou_one_to_many(r[:4], our_rows[:, :4]) > 0.9)
        cls_ok = our_rows[:, 4].astype(int) == int(r[4])
        score_ok = np.abs(our_rows[:, 5] - r[5]) < 0.05
        matched += bool((box_ok & cls_ok & score_ok).any())
    assert matched >= 0.9 * len(ref_rows), (matched, len(ref_rows))
