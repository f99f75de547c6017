"""The port's Hybrid Task Cascade (``config.HTCConfig``, ``models/htc.py``)
against the benchmark's plain reference ``perfbench/reference/htc.py``.

R-50 at 128², 81 classes, f32, 200 proposals and 20 detection rows an
image (counts cut so that the CPU holds the test; every width is the
configuration's), weights seeded and shaped as the benchmark shapes them
(``perfbench/htc_shaping.py``); inputs drawn from seeds. Tolerances, stated:

- proposals and the semantic feature: equal (the same f32 ops in the same
  order on the CPU);
- each stage on the program's own ROIs: class logits within 1e-5 of their
  magnitude (they reach ±100 after shaping: f32 products of 12,544 terms
  summed in another order), deltas within 1e-5 absolute (they are O(1)),
  the refined boxes within 1e-6 (coordinates in [0, 1] through one decode);
- each mask head's trunk output on the program's rows: within 1e-4 of its
  magnitude (f32 convs in another order, four deep, through ``conv_res``);
- the per-class detection layer against a plain loop of greedy NMS class by
  class: equal row for row (the same scores in, the same decisions);
- the whole call against the whole reference (``reference/compare.py``):
  every detection matched, score and box gaps under 1e-4, masks within
  1e-5.
"""

import numpy as np
import pytest
import torch

from objectdetection_torch import metrics
from objectdetection_torch.config import HTCConfig
from objectdetection_torch.convert import init_htc_params
from objectdetection_torch.detector import create_train_state, make_infer_fn, make_train_step
from objectdetection_torch.geometry import decode_box_deltas
from objectdetection_torch.layers.detection import per_class_detection_layer
from objectdetection_torch.models import htc
from objectdetection_torch.models.backbone import channels_last, prelude
from objectdetection_torch.ops import roi_align
from perfbench import htc_shaping, run, weights
from perfbench.configs.common import exact_f32
from perfbench.reference import htc as ref
from perfbench.reference.compare import compare

torch.set_num_threads(2)

B = 2
SIZES = {**run.load_json(run.HERE / "configs" / "htc_r101_fpn_1024_bf16.json"),
         "backbone": "resnet50", "image_shape": [128, 128, 3], "post_nms_rois_inference": 200,
         "detection_post_nms_instances": 20}
CFG = HTCConfig(image_shape=(128, 128, 3), image_min_dim=128, image_max_dim=128,
                backbone="resnet50", compute_dtype="float32", post_nms_rois_inference=200,
                detection_post_nms_instances=20)
WINDOWS = torch.tensor([[0.0, 0.0, 128.0, 128.0], [8.0, 0.0, 120.0, 128.0]])


def images(seed, n=B):
    return torch.from_numpy(np.random.RandomState(seed).uniform(
        -128.0, 127.0, (n, 128, 128, 3)).astype(np.float32))


@pytest.fixture(scope="module")
def shaped():
    """Seeded weights with the semantic feature, the box, class and mask
    outputs shaped on an image apart from the tested ones."""
    w = weights.make(ref.spec(SIZES), 3, torch.device("cpu"), SIZES["seeded_weights"])
    w, info = htc_shaping.htc_outputs(w, images(9, 1), SIZES, SIZES["seeded_weights"])
    assert info["over_half"] == SIZES["seeded_weights"]["over_half"]
    assert abs(info["top_score"] - 0.98) < 0.02
    return w


@pytest.fixture(scope="module")
def outputs(shaped):
    """The program's call and the reference's, with their intermediates."""
    x = images(1)
    with torch.inference_mode():
        got = htc.apply(shaped, x, WINDOWS, CFG, return_intermediates=True)
    want = {}
    with exact_f32():
        det, masks, at = ref.forward(shaped, x, WINDOWS, SIZES, at=got[0], intermediates=want)
    return x, got, (det, masks, at, want)


@pytest.fixture(scope="module")
def reference_maps(shaped, outputs):
    """The reference's P2..P5 and semantic feature, NHWC."""
    with exact_f32():
        feats, _ = ref.pyramid_and_proposals(shaped, outputs[0], SIZES)
        sem = ref.semantic_feature(shaped, feats, SIZES)
    return [f.permute(0, 2, 3, 1) for f in feats[:4]], sem.permute(0, 2, 3, 1)


@pytest.fixture(scope="module")
def served(shaped, outputs):
    """The entry point's call on the same images under ``metrics.collect``."""
    with metrics.collect("cpu") as rec:
        got = htc.make_infer_fn(CFG, device="cpu")(shaped, outputs[0], WINDOWS)
    return got, rec.resolve()


def test_state_dict_is_the_reference_spec():
    sd = htc.build_model(CFG).state_dict()
    spec = list(ref.spec(SIZES))
    assert list(sd) == [n for n, _, _ in spec]
    assert all(tuple(sd[n].shape) == s for n, s, _ in spec)
    assert sd["box_heads.2.reg.weight"].shape == (4, 1024)  # class-agnostic boxes
    assert sd["semantic_head.logits.weight"].shape == (183, 256, 1, 1)
    assert "mask_heads.0.conv_res.weight" not in sd and "mask_heads.2.conv_res.weight" in sd
    assert CFG.num_stages == 3 and CFG.score_threshold == 0.001


def test_init_htc_params_draws_the_whole_state_dict():
    sd = htc.build_model(CFG).state_dict()
    params = init_htc_params(CFG, torch.Generator().manual_seed(0), "cpu")
    assert list(params) == list(sd)
    assert all(params[k].shape == v.shape and params[k].dtype == torch.float32
               for k, v in sd.items())
    # he_normal stem, lecun_normal heads (std 1 / sqrt(fan in)), zero biases
    fc1 = params["box_heads.0.fc1.weight"]
    assert abs(float(fc1.std()) * fc1.shape[1] ** 0.5 - 1.0) < 0.05
    assert not bool(params["mask_heads.1.conv_res.bias"].any())
    assert torch.equal(params["semantic_head.convs.0.weight"],
                       init_htc_params(CFG, torch.Generator().manual_seed(0), "cpu")
                       ["semantic_head.convs.0.weight"])


def test_semantic_feature_and_stages_match_the_reference(shaped, outputs, reference_maps):
    _, (_, _, inter), (_, _, _, want) = outputs
    assert torch.equal(inter["proposals"], want["proposals"])
    assert torch.equal(inter["semantic"], want["semantic"].permute(0, 2, 3, 1))
    pyramid, sem = reference_maps
    window = (WINDOWS - torch.tensor([0.0, 0.0, 1.0, 1.0])) / 127.0
    for t, ((rois, logits, deltas, refined), stds) in enumerate(
            zip(inter["stages"], SIZES["stage_stds"])):
        with exact_f32():
            x = ref.pooled(pyramid, sem, rois, SIZES, SIZES["pool_shape"])
            _, want_logits, want_deltas = ref.box_stage(shaped, t, x)
            want_refined = ref.decode(rois, deltas, stds, SIZES, window[:, None, :])
        mag = float(want_logits.abs().max())
        assert mag > 10 and float((logits - want_logits).abs().max()) <= 1e-5 * mag, t
        assert float((deltas - want_deltas).abs().max()) <= 1e-5, t
        assert float((refined - want_refined).abs().max()) <= 1e-6, t
        moved = (refined - rois).abs().amax(-1)[(rois != 0).any(-1)]
        assert float(moved.median()) > 1e-3, t  # every stage moves its boxes
    for t in range(2):
        assert torch.equal(inter["stages"][t + 1][0], inter["stages"][t][3])


def test_mask_trunks_match_the_reference(shaped, outputs, reference_maps):
    _, (det, _, inter), _ = outputs
    pyramid, sem = reference_maps
    trunks = []
    with exact_f32():
        ref.mask_heads(shaped, pyramid, sem, det, SIZES, trunks=trunks)
    assert len(inter["trunks"]) == len(trunks) == 3
    for got, want in zip(inter["trunks"], trunks):
        mag = float(want.abs().max())
        assert mag > 0 and float((got - want).abs().max()) <= 1e-4 * mag


def test_per_class_detection_layer_equals_a_plain_loop():
    gen = torch.Generator().manual_seed(11)
    r = 200
    ctr = torch.rand(B, 12, 2, generator=gen)[:, torch.randint(0, 12, (r,), generator=gen)]
    ctr = ctr + 0.03 * torch.randn(B, r, 2, generator=gen)
    size = 0.05 + 0.3 * torch.rand(B, r, 2, generator=gen)
    boxes = torch.cat([ctr - size / 2, ctr + size / 2], -1).clamp(0, 1)
    boxes[:, -20:] = 0.0  # the proposal layer's padding
    rows_valid = (boxes != 0).any(-1)
    logits = 3 * torch.randn(B, r, 81, generator=gen)
    logits[:, :, 0] += 4.0
    logits[:, 50:60] = logits[:, 40:50]  # equal scores across ROIs
    probs = torch.softmax(logits, -1)
    sizes = {**SIZES, "detection_post_nms_instances": 30}
    got = per_class_detection_layer(boxes, probs, rows_valid, 0.001,
                                    CFG.replace(detection_post_nms_instances=30))
    want = torch.stack([ref.per_class_detections(boxes[i], probs[i], rows_valid[i], sizes)
                        for i in range(B)])
    assert torch.equal(got, want)
    assert bool((got[..., 5] > 0.001).all()) and len(torch.unique(got[..., 4])) > 5


def test_whole_call_matches_the_whole_reference(outputs, served):
    _, (det, masks, _), (want_det, _, want_at, _) = outputs
    (got_det, got_masks), _ = served
    assert torch.equal(got_det, det) and torch.equal(got_masks, masks)
    assert det.shape == (B, 20, 6) and masks.shape == (B, 20, 28, 28)
    numbers = compare(det.numpy(), want_det.numpy(), 0.001, masks.numpy(), want_at.numpy())
    assert numbers["detections_per_image"] == 20 and numbers["matched"] == 1.0
    assert numbers["score_gap"] < 1e-4 and numbers["box_gap"] < 1e-4
    assert numbers["mask_gap"] < 1e-5
    # image 1's window cuts 8 pixels off the top and bottom: its boxes stay inside
    assert bool((det[1, :, 5] > 0).all()) and float(det[1, :, 0].min()) >= 8 / 127 - 1e-6


def test_counters_and_spans_under_collect(outputs, served):
    _, (_, _, inter), _ = outputs
    _, rec = served
    assert rec.counters["htc_detection.slots"] == B * 200 * 80
    logits = sum(s[1] for s in inter["stages"]) / 3
    probs = torch.softmax(logits, -1)[..., 1:]
    valid = (probs > 0.001) & (inter["proposals"] != 0).any(-1)[..., None]
    assert rec.counters["htc_detection.candidates"] == int(valid.sum()) > 0
    names = {s.name for s in rec.spans}
    assert {"odtorch.htc_semantic", "odtorch.htc_box_stages", "odtorch.htc_detection",
            "odtorch.htc_mask_stages", "odtorch.backbone", "odtorch.infer"} <= names


def test_an_htc_config_does_not_train_nor_enter_the_mask_rcnn_path():
    with pytest.raises(NotImplementedError, match="HTCConfig"):
        make_train_step(CFG, device="cpu")
    with pytest.raises(NotImplementedError, match="does not train"):
        create_train_state(CFG, device="cpu")
    with pytest.raises(NotImplementedError, match="models.htc"):
        make_infer_fn(CFG, device="cpu")
    with pytest.raises(TypeError, match="HTCConfig"):
        htc.build_model(HTCConfig.__mro__[1]())


def test_stage_decode_clamps_the_log_sizes():
    boxes = torch.tensor([[0.2, 0.2, 0.4, 0.6]])
    deltas = torch.tensor([[1.0, -1.0, 100.0, -100.0]])
    got = decode_box_deltas(boxes, deltas, (0.1, 0.1, 0.2, 0.2), CFG.max_log_size_delta)
    h, w = 0.2 * 1000 / 16, 0.4 * 16 / 1000
    cy, cx = 0.3 + 0.1 * 0.2, 0.4 - 0.1 * 0.4
    want = torch.tensor([[cy - h / 2, cx - w / 2, cy + h / 2, cx + w / 2]])
    assert torch.allclose(got, want, atol=1e-6)


def test_roi_align_pools_one_map():
    """B1's single-map route: every box on the one map, whatever its size,
    as the reference's sampling gives it, and as ``crop_and_resize`` does
    inside the map (on its far edge a rounding past H − 1 zeroes a
    ``crop_and_resize`` sample, where the gather reads the edge)."""
    gen = torch.Generator().manual_seed(5)
    feat = torch.randn(2, 16, 16, 8, generator=gen)
    y1x1 = torch.rand(2, 40, 2, generator=gen) * 0.7
    boxes = torch.cat([y1x1, y1x1 + 0.02 + 0.28 * torch.rand(2, 40, 2, generator=gen)], -1)
    boxes[:, :10, 2:] = boxes[:, :10, :2] + 0.9  # large: the rule would name P5
    boxes = boxes.clamp(0, 1)
    got = roi_align.batched_multilevel_roi_align([feat], boxes, (128, 128), (14, 14))
    assert torch.allclose(got, ref.crop_one_map(feat, boxes, (14, 14)), atol=1e-5)
    inner = boxes.clamp(0, 0.95)
    assert torch.allclose(roi_align.batched_multilevel_roi_align([feat], inner, (128, 128),
                                                                 (14, 14)),
                          roi_align.crop_and_resize(feat, inner, (14, 14)), atol=1e-5)
    assert list(roi_align._level_dims([feat.shape])) == [16, 16, 0, 0, 0, 0, 0, 0]
    assert roi_align._level_ptrs([feat]) == [feat.data_ptr()] * 4
    with pytest.raises(ValueError, match="1 to 4 levels"):
        roi_align._check_pyramid([feat.shape] * 5, [feat.dtype] * 5, [feat.device] * 5, boxes,
                                 (7, 7))


@pytest.mark.parametrize("scale", [1.0, 1.0 / 64.0])
def test_prelude_is_the_inline_prelude_it_replaced(scale):
    x = images(4)
    want = x * scale if scale != 1.0 else x
    want = channels_last(want.permute(0, 3, 1, 2).to(torch.bfloat16))
    got = prelude(x, scale, torch.bfloat16)
    assert torch.equal(got, want) and got.stride() == want.stride()
    assert got.is_contiguous(memory_format=torch.channels_last)
