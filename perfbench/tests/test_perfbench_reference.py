"""The plain reference against the program (``objectdetection_torch``) at a
small size on the CPU, both in float32: the same detections and masks.
Also its pieces against the program's plain versions."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from perfbench import run, shaping, weights
from perfbench.configs.common import exact_f32, program_config
from perfbench.reference import layers, mask_rcnn
from perfbench.reference.compare import compare
from perfbench.tests.conftest import TINY_SIZES
from perfbench.traffic.offline_batches import images_maker

CPU = torch.device("cpu")


def sizes_of(config: str, **rule) -> dict:
    sizes = {**run.load_json(run.HERE / "configs" / f"{config}.json"), **TINY_SIZES}
    sizes["seeded_weights"] = {**sizes["seeded_weights"],
                               "heads": {**sizes["seeded_weights"]["heads"], **rule}}
    return sizes


@pytest.mark.parametrize("seed", [1, 2])
def test_mask_rcnn_matches_the_program(seed):
    from objectdetection_torch import detector

    sizes = sizes_of("maskrcnn_r101_fpn_1024_bf16", over_gate=8)
    make = images_maker(sizes, seed, CPU)
    w = shaping.mask_rcnn_heads(weights.make(mask_rcnn.spec(sizes), seed, CPU,
                                             sizes["seeded_weights"]),
                                make("shaping", 1), sizes, sizes["seeded_weights"]["heads"])
    images = make("batch0", 2)
    windows = torch.tensor([[0.0, 0.0, 64.0, 64.0]]).repeat(2, 1)
    d = detector.make_infer_fn(program_config(sizes, compute_dtype="float32"),
                               device="cpu")(w, images, windows)
    got = torch.cat([d.boxes, d.class_ids[..., None].float(), d.scores[..., None]], -1)
    with exact_f32():
        want, _, at = mask_rcnn.forward(w, images, windows, sizes, at=got)
    numbers = compare(got.numpy(), want.numpy(), 0.7, d.masks.numpy(), at.numpy())
    assert numbers["detections_per_image"] >= 1
    assert numbers["matched"] == 1.0
    assert numbers["score_gap"] < 1e-5 and numbers["box_gap"] < 1e-5
    assert numbers["mask_gap"] < 1e-5


def test_weights_fit_the_program_and_are_seeded():
    from objectdetection_torch import detector

    sizes = sizes_of("maskrcnn_r101_fpn_1024_bf16")
    a = weights.make(mask_rcnn.spec(sizes), 7, CPU, sizes["seeded_weights"])
    b = weights.make(mask_rcnn.spec(sizes), 7, CPU, sizes["seeded_weights"])
    c = weights.make(mask_rcnn.spec(sizes), 8, CPU, sizes["seeded_weights"])
    detector.check_state(a, program_config(sizes))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["fpn.resnet.conv1.weight"], c["fpn.resnet.conv1.weight"])
    scales = a["fpn.resnet.res2a.bn2a_branch2c.scale"]
    assert 0.05 <= float(scales.min()) and float(scales.max()) <= 0.15


def test_anchors_nms_and_roi_align_match_the_program_plain_versions():
    from objectdetection_torch.anchors import config_anchors
    from objectdetection_torch.ops import nms, roi_align

    sizes = run.load_json(run.HERE / "configs" / "maskrcnn_r101_fpn_1024_bf16.json")
    ours = layers.pyramid_anchors((1024, 1024), sizes["rpn_anchor_scales"],
                                  sizes["rpn_anchor_ratios"], sizes["backbone_strides"])
    assert np.array_equal(ours, config_anchors(program_config(sizes)))

    gen = torch.Generator().manual_seed(3)
    y1x1 = torch.rand(1, 300, 2, generator=gen) * 0.8
    boxes = torch.cat([y1x1, y1x1 + torch.rand(1, 300, 2, generator=gen) * 0.3], -1)
    boxes[0, :5] = 0.0
    cls = torch.randint(0, 3, (1, 300), generator=gen, dtype=torch.int32)
    want = nms.suppress_plain(boxes, cls, 0.3, budget=300)
    keep = layers.greedy_nms(boxes[0], cls[0], 0.3, 300)
    kept = np.nonzero((want[0] != 0).any(-1).numpy())[0].tolist()
    assert keep == kept

    feats = [torch.randn(2, h, w, 8, generator=gen) for h, w in ((16, 16), (8, 8), (4, 4),
                                                                  (2, 2))]
    rois = torch.rand(2, 20, 4, generator=gen)
    rois = torch.cat([rois[..., :2] * 0.5, rois[..., :2] * 0.5 + rois[..., 2:] * 0.5], -1)
    got = layers.roi_align(feats, rois, (64, 64), (7, 7))
    ref = roi_align.batched_multilevel_roi_align_plain(feats, rois, (64, 64), (7, 7))
    assert torch.allclose(got, ref, atol=1e-6, rtol=1e-6, equal_nan=True)


def test_controls_lower_the_precision_of_marked_layers_only():
    x = torch.randn(4, 8, 5, 5)
    w = torch.randn(16, 8, 3, 3)
    exact = layers.conv(x, w, None)
    for mode in ("int4", "fp8"):
        p = layers.Precision(mode)
        assert torch.equal(layers.conv(x, w, None, prec=p, low=False), exact)
        low = layers.conv(x, w, None, prec=p, low=True)
        assert 0 < float((low - exact).abs().max()) < float(exact.abs().max())
    q = layers.Precision("int4").weight(w, True)
    steps = (q / (w.abs().amax(dim=(1, 2, 3), keepdim=True) / 7)).round()
    assert steps.abs().max() <= 7 and len(torch.unique(steps)) <= 15
