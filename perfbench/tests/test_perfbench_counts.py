"""counts.py against hand counts, and the ROIAlign bound against the kernel
table's (PERF.md: 0.0343 ms for the bf16 forward at batch 2)."""

from __future__ import annotations

import pytest
import torch

from perfbench import counts, run
from perfbench.configs import maskrcnn_r101_fpn_1024 as mrcnn

SIZES = run.load_json(run.HERE / "configs" / "maskrcnn_r101_fpn_1024_bf16.json")


def by_name(ops, prefix):
    return sum(o.ops for o in ops if o.name.startswith(prefix))


def test_bottleneck_block():
    ops = counts.resnet_fpn(1, (1024, 1024), "resnet101", 256, "int8", "bf16")
    # res2b: 1x1 256->64, 3x3 64->64, 1x1 64->256 at 256x256
    assert by_name(ops, "res2b_") == 2 * 256 * 256 * (256 * 64 + 64 * 64 * 9 + 64 * 256)
    # res3a: the stride-2 projection and 2a at 128x128
    assert by_name(ops, "res3a_branch1") == 2 * 128 * 128 * 256 * 512
    assert len([o for o in ops if o.name.startswith("res4")]) == 23 * 3 + 1


def test_fpn():
    ops = counts.resnet_fpn(2, (1024, 1024), "resnet101", 256, "int8", "bf16")
    lat = 2 * 2 * 256 * (32 * 32 * 2048 + 64 * 64 * 1024 + 128 * 128 * 512 + 256 * 256 * 256)
    out = 2 * 2 * (256 ** 2 + 128 ** 2 + 64 ** 2 + 32 ** 2) * 256 * 256 * 9
    assert by_name(ops, "fpn_c") == lat
    assert by_name(ops, "fpn_p") == out


def test_mask_head():
    ops = counts.mask_rcnn(SIZES, 3, mrcnn.KINDS["int8"])
    n = 3 * 100
    head = [o for o in ops if o.layer == "mask_head"]
    want = 4 * 2 * n * 14 * 14 * 256 * 256 * 9 + 2 * n * 14 * 14 * 256 * 256 * 4 \
        + 2 * n * 28 * 28 * 256
    assert sum(o.ops for o in head) == want
    assert {o.kind for o in head} == {"int8", "bf16", "f32"}


def test_seconds_at_peak_sums_by_arithmetic():
    ops = [counts.Op("a", "x", 1979e12, "int8"), counts.Op("b", "y", 989e12, "bf16")]
    assert counts.seconds_at_peak(ops) == pytest.approx(2.0)
    assert counts.seconds_at_peak(ops, ["b"]) == pytest.approx(1.0)


def _roi_boxes(gen, batch, r):
    """The kernel table's box mix: random boxes plus zero, flat, whole-image
    and tiny ones."""
    y1x1 = torch.rand(batch, r, 2, generator=gen) * 0.8
    hw = torch.rand(batch, r, 2, generator=gen) ** 2 * 0.6
    boxes = torch.cat([y1x1, (y1x1 + hw).clamp(max=1.0)], -1)
    q = r // 10
    boxes[:, :q] = 0.0
    boxes[:, q:2 * q, 2] = boxes[:, q:2 * q, 0]
    boxes[:, 2 * q:2 * q + 5] = torch.tensor([0.0, 0.0, 1.0, 1.0])
    tiny = boxes[:, 3 * q:4 * q]
    tiny[..., 2:] = tiny[..., :2] + 1e-3
    return boxes


def test_roi_align_bound_matches_the_kernel_table():
    gen = torch.Generator().manual_seed(2)
    shapes = [(256, 256), (128, 128), (64, 64), (32, 32)]
    for h, w in shapes:  # the table's features, drawn first from the same generator
        torch.randn(2, h, w, 256, generator=gen)
    total = 0.0
    for r, crop in ((1000, (7, 7)), (100, (14, 14))):
        boxes = _roi_boxes(gen, 2, r)
        total += counts.roi_align_bound_s(shapes, 256, boxes, (1024, 1024), crop, 2, 2)
    assert round(total * 1e3, 4) == 0.0343
