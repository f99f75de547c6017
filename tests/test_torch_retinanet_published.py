"""The port's published RetinaNet (``config.RetinaNetConfig``: P3–P7 with P6
and P7 from C5, 9 anchors a location, the per-level decode) against the
benchmark's plain reference ``perfbench/reference/retinanet.py``, and the
JAX package's RetinaNet (a ``DetectorConfig``) left as it was.

R-50 at 128² (P7 is 1×1), 81 classes (the class output 720 wide), f32,
weights seeded and shaped as the benchmark shapes them; inputs drawn from
seeds. Tolerances, stated:
- logits and deltas, the port's convs against the reference's: within
  rtol 1e-4 / atol 1e-3 (the logits reach ±10; f32 convs summed in other
  orders);
- on the same logits and deltas, each level's candidates and the final
  detections are equal row for row: indices, classes and scores exactly,
  boxes exactly;
- the whole call against the whole reference: every detection matched,
  score and box gaps under 1e-4.
"""

import numpy as np
import pytest
import torch

from objectdetection_torch.anchors import anchors_per_level_counts, config_anchors
from objectdetection_torch.config import RetinaNetConfig, SHAPES_CONFIG
from objectdetection_torch.convert import init_retinanet_params
from objectdetection_torch.detector import TrainBatch
from objectdetection_torch.geometry import apply_box_deltas, clip_boxes
from objectdetection_torch.layers.proposals import top_k_stable
from objectdetection_torch.models import retinanet as rn
from objectdetection_torch.models.backbone import ResNetFPN, upsample2x_nearest
from objectdetection_torch.ops.nms import non_max_suppression
from perfbench import run, sigmoid_shaping, weights
from perfbench.configs.common import exact_f32
from perfbench.reference import retinanet as ref
from perfbench.reference.compare import compare

torch.set_num_threads(2)

B = 2
SIZES = {**run.load_json(run.HERE / "configs" / "retinanet_r101_fpn_1024_bf16.json"),
         "backbone": "resnet50", "image_shape": [128, 128, 3]}
CFG = RetinaNetConfig(image_shape=(128, 128, 3), image_min_dim=128, image_max_dim=128,
                      backbone="resnet50", compute_dtype="float32")
FEAT_TOL = dict(rtol=1e-4, atol=1e-3)


def images(seed, hw=128):
    return torch.from_numpy(np.random.RandomState(seed).uniform(
        -128.0, 127.0, (B, hw, hw, 3)).astype(np.float32))


@pytest.fixture(scope="module")
def shaped():
    """Seeded weights with their outputs shaped on an image apart from the
    tested ones."""
    w = weights.make(ref.spec(SIZES), 3, torch.device("cpu"), {})
    w, info = sigmoid_shaping.retinanet_outputs(w, images(9)[:1], SIZES, SIZES["seeded_weights"])
    rule = SIZES["seeded_weights"]
    assert min(abs(info["top_score"] - t) for t in rule["top_scores"]) < 1e-6
    assert info["p3_over_gate"] >= rule["p3_over_gate"] and info["over_half"] >= 1
    return w


@pytest.fixture(scope="module")
def outputs(shaped):
    x = images(1)
    with torch.inference_mode():
        got = rn.apply(shaped, x, CFG)
    with exact_f32():
        want = ref.heads(shaped, x, SIZES)
    return x, got, want


def test_config_anchor_count_and_order():
    assert CFG.fpn_levels == (3, 4, 5, 6, 7) and CFG.num_anchors_per_location == 9
    assert CFG.feature_shapes() == ((16, 16), (8, 8), (4, 4), (2, 2), (1, 1))
    assert anchors_per_level_counts(CFG) == (2304, 576, 144, 36, 9)
    pix = config_anchors(CFG, normalized=False)
    assert pix.shape == (3069, 4)
    # P3 at (0, 0): sides 32 · 2^(o/3) · √r^∓1 in (ratio, octave) order, ratio outer
    want = [(32 * 2 ** (o / 3) / np.sqrt(r), 32 * 2 ** (o / 3) * np.sqrt(r))
            for r in (0.5, 1.0, 2.0) for o in range(3)]
    np.testing.assert_allclose(np.stack([pix[:9, 2] - pix[:9, 0], pix[:9, 3] - pix[:9, 1]], 1),
                               want, rtol=1e-12)
    np.testing.assert_allclose(pix[:9, :2] + pix[:9, 2:], 0.0, atol=1e-9)  # centred on (0, 0)
    np.testing.assert_allclose(pix[9:18] - pix[:9], [[0, 8, 0, 8]] * 9, atol=1e-9)  # x = 1
    # P7, one location: sides from 512
    assert (pix[-9:, 3] - pix[-9:, 1]).max() == pytest.approx(512 * 2 ** (2 / 3) * 2 ** 0.5)
    np.testing.assert_array_equal(config_anchors(CFG),
                                  torch.cat(ref.level_anchors(SIZES, "cpu")).numpy())
    with pytest.raises(ValueError, match="P3..P7"):
        RetinaNetConfig(backbone_strides=(4, 8, 16, 32, 64))


def test_state_dict_is_the_reference_spec(shaped):
    model = rn.build_model(CFG)
    assert list(model.state_dict()) == [n for n, _, _ in ref.spec(SIZES)]
    sd = init_retinanet_params(CFG, torch.Generator().manual_seed(0), "cpu")
    assert sd["class_subnet.out.weight"].shape == (720, 256, 3, 3)
    assert sd["box_subnet.out.weight"].shape == (36, 256, 3, 3)
    assert sd["fpn.fpn_p6.weight"].shape == (256, 2048, 3, 3)
    assert "fpn.fpn_p2.weight" not in sd and "fpn.fpn_c2p2.weight" not in sd
    assert torch.equal(sd["class_subnet.out.bias"], torch.full((720,), rn.PRIOR_BIAS))


def test_logits_and_deltas_match_the_reference(outputs):
    _, (logits, deltas), (want_logits, want_deltas) = outputs
    assert logits.shape == (B, 3069, 80) and deltas.shape == (B, 3069, 4)
    np.testing.assert_allclose(logits.numpy(), torch.cat(want_logits, 1).numpy(), **FEAT_TOL)
    np.testing.assert_allclose(deltas.numpy(), torch.cat(want_deltas, 1).numpy(), **FEAT_TOL)
    assert float(logits.abs().max()) > 1.0


def test_candidates_and_detections_equal_the_reference_row_for_row(outputs):
    _, (logits, deltas), _ = outputs
    counts = anchors_per_level_counts(CFG)
    split = lambda t: list(torch.split(t, counts, dim=1))
    cands = ref.level_candidates(split(logits), split(deltas), SIZES,
                                 ref.level_anchors(SIZES, "cpu"))
    boxes, scores, classes, valid = rn.decode_per_level(logits, deltas, CFG, 0.05, 1000)
    k = [min(1000, n * 80) for n in counts]
    assert boxes.shape == (B, sum(k), 4) and k == [1000, 1000, 1000, 1000, 720]
    for got, want in zip((boxes, scores, classes), zip(*cands)):
        assert torch.equal(got, torch.cat(want, 1))
    assert torch.equal(valid, scores > 0.05) and bool(valid[:, :1000].all())
    det = rn.retinanet_detections(logits, deltas, CFG)
    want = ref.detect(cands, SIZES)
    assert det.shape == (B, 100, 6)
    assert torch.equal(det, want)
    n = int((det[..., 5] > 0).sum())
    assert 20 <= n <= 2 * 100 and float(det[..., 5][det[..., 5] > 0].min()) > 0.05


def test_whole_call_matches_the_whole_reference(shaped, outputs):
    x = outputs[0]
    got = rn.make_infer_fn(CFG, device="cpu")(shaped, x)
    with exact_f32():
        want = ref.forward(shaped, x, SIZES)
    numbers = compare(got.numpy(), want.numpy(), 0.05)
    assert numbers["detections_per_image"] >= 20
    assert numbers["matched"] == 1.0
    assert numbers["score_gap"] < 1e-4 and numbers["box_gap"] < 1e-4


def test_counters_under_collect(shaped, outputs):
    from objectdetection_torch import metrics

    _, (logits, deltas), _ = outputs
    with metrics.collect("cpu") as rec:
        det = rn.retinanet_detections(logits, deltas, CFG)
    rec.resolve()
    assert rec.counters["retina_decode.slots"] == B * 4720
    valid = rn.decode_per_level(logits, deltas, CFG, 0.05, 1000)[3]
    assert rec.counters["retina_decode.candidates"] == int(valid.sum())
    assert {s.name for s in rec.spans} == {"odtorch.retina_decode", "odtorch.retina_nms"}
    assert torch.equal(det, rn.retinanet_detections(logits, deltas, CFG))


def test_training_step_runs_on_the_published_config(shaped):
    cfg = CFG.replace(max_gt_objects=2)
    step, init_state = rn.make_retinanet_train_step(cfg, device="cpu")
    state = init_state(init_retinanet_params(cfg, torch.Generator().manual_seed(1), "cpu"))
    boxes = torch.tensor([[[0.1, 0.1, 0.45, 0.5], [0.5, 0.4, 0.95, 0.9]],
                          [[0.2, 0.3, 0.6, 0.7], [0.0, 0.0, 0.0, 0.0]]])
    cls = torch.tensor([[3, 17], [80, 0]])
    batch = TrainBatch(images(4) / 64.0, boxes, cls)
    tgt = rn.retinanet_targets(torch.from_numpy(config_anchors(cfg)), boxes, cls, cfg)
    assert tgt.labels.shape == (B, 3069) and int((tgt.labels > 0).sum()) >= 3
    new, m = step(state, batch)
    assert set(m) == {"focal_loss", "box_loss", "total_loss"}
    assert all(np.isfinite(float(v)) and float(v) > 0 for v in m.values())
    assert new.count == 1
    moved = [k for k in state.params if not torch.equal(state.params[k], new.params[k])]
    assert "fpn.fpn_p7.weight" in moved and "class_subnet.out.weight" in moved


# ------------------------------------------------ the default, as before

SMALL = SHAPES_CONFIG.replace(image_shape=(64, 64, 3), image_min_dim=64, image_max_dim=64,
                              compute_dtype="float32")


def _fpn_before(fpn, x):
    """``ResNetFPN.forward`` as it was before the P3..P7 mode."""
    c2, c3, c4, c5 = fpn.resnet(x)
    m5 = fpn.fpn_c5p5(c5)
    m4 = upsample2x_nearest(m5) + fpn.fpn_c4p4(c4)
    m3 = upsample2x_nearest(m4) + fpn.fpn_c3p3(c3)
    m2 = upsample2x_nearest(m3) + fpn.fpn_c2p2(c2)
    p5 = fpn.fpn_p5(m5)
    return fpn.fpn_p2(m2), fpn.fpn_p3(m3), fpn.fpn_p4(m4), p5, p5[:, :, ::2, ::2]


def _detections_before(logits, deltas, config, score_threshold=0.3, pre_nms=1000):
    """``retinanet_detections`` as it was before the per-level decode."""
    anchors = torch.from_numpy(config_anchors(config))
    stddev = torch.tensor(config.rpn_bbox_stddev, dtype=torch.float32)
    b, a, _ = logits.shape
    probs = torch.sigmoid(logits)
    best = probs.amax(dim=-1)
    cls = torch.argmax(probs, dim=-1) + 1
    k = min(pre_nms, a)
    top, ix = top_k_stable(best, k)
    boxes = apply_box_deltas(anchors[ix],
                                torch.gather(deltas, 1, ix[..., None].expand(b, k, 4)) * stddev)
    boxes = clip_boxes(boxes, (0.0, 0.0, 1.0, 1.0))
    keep_cls = torch.gather(cls, 1, ix)
    res = non_max_suppression(boxes, top, config.detection_post_nms_instances,
                              config.detection_nms_threshold, valid=top > score_threshold,
                              class_ids=keep_cls.to(torch.int32), assume_sorted=True)
    idx = res.indices.clamp(min=0)
    out = torch.cat([torch.gather(boxes, 1, idx[..., None].expand(*idx.shape, 4)),
                     torch.gather(keep_cls, 1, idx)[..., None].to(torch.float32),
                     torch.gather(top, 1, idx)[..., None]], dim=-1)
    return torch.where(res.valid[..., None], out, torch.zeros_like(out))


def test_default_resnet_fpn_bit_equal_to_before():
    fpn = ResNetFPN("resnet50", 64, 3)
    names = [n for n in fpn.state_dict() if n.startswith("fpn_")]
    assert names == [f"fpn_{m}.{leaf}" for m in ("c5p5", "c4p4", "c3p3", "c2p2", "p2", "p3",
                                                  "p4", "p5") for leaf in ("weight", "bias")]
    gen = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for t in fpn.state_dict().values():
            if t.dim() > 1:
                t.copy_(torch.randn(t.shape, generator=gen) * 0.05)
        x = torch.randn(1, 3, 64, 64, generator=gen)
        got, want = fpn(x), _fpn_before(fpn, x)
    assert len(got) == 5 and all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("score_threshold", [None, 0.0])
def test_default_retinanet_bit_equal_to_before(score_threshold):
    sd = init_retinanet_params(SMALL, torch.Generator().manual_seed(5), "cpu")
    model = rn.RetinaNet(SMALL)
    model.load_state_dict(sd)
    x = images(6, 64)
    nc = SMALL.num_classes - 1
    with torch.inference_mode():
        feats = _fpn_before(model.fpn, (x * SMALL.input_scale).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last))
        want_logits = torch.cat([model.class_subnet(f).permute(0, 2, 3, 1).reshape(B, -1, nc)
                                 for f in feats], 1)
        want_deltas = torch.cat([model.box_subnet(f).permute(0, 2, 3, 1).reshape(B, -1, 4)
                                 for f in feats], 1)
        logits, deltas = rn.apply(sd, x, SMALL)
        det = rn.make_infer_fn(SMALL, score_threshold=score_threshold, device="cpu")(sd, x)
    assert torch.equal(logits, want_logits) and torch.equal(deltas, want_deltas)
    thr = 0.3 if score_threshold is None else score_threshold
    assert torch.equal(det, _detections_before(logits, deltas, SMALL, thr))
    assert int((det[..., 5] > 0).sum()) > 0 or thr == 0.3  # the prior scores ~0.01
