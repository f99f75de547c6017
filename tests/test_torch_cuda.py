"""Kernel tests that need the card: each CUDA kernel against its plain version.

Marked ``cuda``; without a card (or without nvcc) they skip. Run on a machine
with an NVIDIA Hopper GPU, from the repository root, with
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py`` (the suite's
conftest imports JAX, which the port and these tests do not need).

NMS survivor tables are held exactly; ROIAlign is held bit-equal in f32 and
within ``roi_align.bf16_tolerance`` in bf16 (the kernel rounds once where the
plain version rounds after every op). The anchor-match kernel is held exactly
(maxima bit-equal, argmaxes equal). The ROIAlign gradient kernel sums with
f32 atomics, so it is held elementwise within
``roi_align.backward_tolerance`` of the plain backward (autograd of the plain
version), and in bf16 also within its bound of the f32 backward. The int8
serving kernels (ROIAlign's int8 epilogues, the fused int8 bottleneck block)
and the integer product (``torch._int_mm`` behind ``quant.int8_matmul``) are
held bit-equal. On boxes outside the map (a NaN box, boxes whose table
index wraps) the three ROIAlign kernels are held the same way, with NaNs in
the plain version's places. The ROIAlign design probes (P1-P3) are held at
small sizes: P1 within ``patch_dma.tolerance``, P2 and P3 bit-equal.
"""

import numpy as np
import pytest
import torch

from objectdetection_torch import quant
from objectdetection_torch.ops import anchor_match, fused_block, nms, roi_align
from objectdetection_torch.probes import patch_dma, roi_dispatch, roi_inner

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    from objectdetection_torch.ops import cuda_build

    try:
        cuda_build.nvcc_path()
    except RuntimeError:
        pytest.skip("no nvcc")
    return torch.device("cuda", 0)


def test_nms_kernel_matches_plain(cuda):
    rng = np.random.RandomState(0)
    ctr = rng.uniform(0.2, 0.8, (3, 1500, 2))
    hw = rng.uniform(0.02, 0.3, (3, 1500, 2))
    boxes = torch.tensor(np.concatenate([ctr - hw / 2, ctr + hw / 2], -1),
                         dtype=torch.float32, device=cuda)
    boxes[:, ::17] = 0.0
    cls = torch.tensor(rng.randint(-1, 4, (3, 1500)), dtype=torch.int32, device=cuda)
    for thr, budget in ((0.7, 300), (0.3, None), (0.5, 1)):
        before = nms.launches
        got = nms.suppress(boxes, cls, thr, budget)
        assert nms.launches == before + 1
        assert torch.equal(got, nms.suppress_plain(boxes, cls, thr, budget))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_roi_align_kernel_matches_plain(cuda, dtype):
    gen = torch.Generator().manual_seed(0)
    feats = [torch.randn(2, s, s, 64, generator=gen).to(cuda, dtype) for s in (64, 32, 16, 8)]
    y1x1 = torch.rand(2, 300, 2, generator=gen) * 0.8
    boxes = torch.cat([y1x1, (y1x1 + torch.rand(2, 300, 2, generator=gen)).clamp(max=1)], -1)
    boxes[:, :20] = 0.0
    boxes[:, 20:40, 2] = boxes[:, 20:40, 0]
    boxes = boxes.to(cuda)
    for crop in ((7, 7), (14, 14)):
        before = roi_align.launches
        got = roi_align.batched_multilevel_roi_align(feats, boxes, (256, 256), crop)
        assert roi_align.launches == before + 1
        want = roi_align.batched_multilevel_roi_align_plain(feats, boxes, (256, 256), crop)
        if dtype == torch.float32:
            assert torch.equal(got, want)
        else:
            err = float((got.float() - want.float()).abs().max())
            assert err <= roi_align.bf16_tolerance(feats)


def test_anchor_match_kernel_matches_plain(cuda):
    rng = np.random.RandomState(1)
    ctr = rng.uniform(0.0, 1.0, (20000, 2))
    hw = rng.uniform(0.01, 0.4, (20000, 2))
    anchors = torch.tensor(np.concatenate([ctr - hw / 2, ctr + hw / 2], -1), dtype=torch.float32)
    anchors[777] = anchors[5]  # duplicated anchors: ties go to the lower index
    gt = anchors[rng.randint(0, 20000, (3, 70))] * 0.9 + 0.05
    gt[:, 1] = gt[:, 0]  # duplicated GT
    gt[:, 2] = anchors[5]
    valid = torch.tensor(rng.rand(3, 70) > 0.2)
    valid[2] = False
    anchors, gt, valid = anchors.to(cuda), gt.to(cuda), valid.to(cuda)
    before = anchor_match.launches
    got = anchor_match.anchor_match(anchors, gt, valid)
    assert anchor_match.launches == before + 1
    want = anchor_match.anchor_match_plain(anchors, gt, valid)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(got.gt_argmax[0, 2]) == 5 and int(got.anchor_argmax[0, 5]) == 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_roi_align_backward_kernel_matches_plain(cuda, dtype):
    gen = torch.Generator().manual_seed(3)
    shapes = [(2, s, s, 64) for s in (64, 32, 16, 8)]
    y1x1 = torch.rand(2, 300, 2, generator=gen) * 0.8
    boxes = torch.cat([y1x1, (y1x1 + torch.rand(2, 300, 2, generator=gen)).clamp(max=1)], -1)
    boxes[:, :20] = 0.0
    boxes = boxes.to(cuda)
    for crop in ((7, 7), (14, 14)):
        grad_out = torch.randn(2, 300, *crop, 64, generator=gen).to(cuda, dtype)
        before = roi_align.backward_launches
        got = roi_align.roi_align_backward(grad_out, boxes, shapes, (256, 256))
        assert roi_align.backward_launches == before + 1
        want = roi_align.roi_align_backward_plain(grad_out, boxes, shapes, (256, 256))
        tol = roi_align.backward_tolerance(grad_out, boxes, shapes, (256, 256))
        for g, w, t in zip(got, want, tol):
            assert g.dtype == dtype and g.shape == w.shape
            assert bool(((g.double() - w.double()).abs() <= t).all())
        if dtype == torch.bfloat16:
            ref = roi_align.roi_align_backward_plain(grad_out.float(), boxes, shapes, (256, 256))
            tol = roi_align.backward_tolerance(grad_out, boxes, shapes, (256, 256),
                                               against_f32=True)
            for g, r, t in zip(got, ref, tol):
                assert bool(((g.double() - r.double()).abs() <= t).all())


def test_roi_align_output_carries_the_feature_gradient(cuda):
    # the kernel's output is differentiable in the features, through the
    # gradient kernel (a detached output would silently cut the FPN's gradient)
    gen = torch.Generator().manual_seed(4)
    feats = [torch.randn(1, s, s, 32, generator=gen).to(cuda).requires_grad_(True)
             for s in (32, 16, 8, 4)]
    boxes = torch.tensor([[[0.1, 0.1, 0.6, 0.7], [0.0, 0.0, 1.0, 1.0]]], device=cuda)
    out = roi_align.batched_multilevel_roi_align(feats, boxes, (128, 128), (7, 7))
    assert out.requires_grad and out.grad_fn is not None
    before = roi_align.backward_launches
    grads = torch.autograd.grad(out.square().sum(), feats, allow_unused=True)
    assert roi_align.backward_launches == before + 1
    assert any(g is not None and bool(g.abs().sum() > 0) for g in grads)
    with torch.no_grad():
        assert not roi_align.batched_multilevel_roi_align(feats, boxes, (128, 128),
                                                          (7, 7)).requires_grad


@pytest.mark.parametrize("in_kind", ["bf16", "f32", "int8_channel", "int8_scalar"])
def test_roi_align_int8_epilogues_match_plain(cuda, in_kind):
    gen = torch.Generator().manual_seed(5)
    c = 64
    f32 = [torch.randn(2, s, s, c, generator=gen) for s in (64, 32, 16, 8)]
    kw = {}
    if in_kind.startswith("int8"):
        s_in = (torch.rand(c, generator=gen) * 3 + 1) if in_kind == "int8_channel" \
            else torch.tensor(2.5)
        feats = [quant.quantize_act(f, s_in).to(cuda) for f in f32]
        kw["in_scale"] = s_in.to(cuda)
    else:
        feats = [f.to(cuda, torch.bfloat16 if in_kind == "bf16" else torch.float32)
                 for f in f32]
    y1x1 = torch.rand(2, 300, 2, generator=gen) * 0.8
    boxes = torch.cat([y1x1, (y1x1 + torch.rand(2, 300, 2, generator=gen)).clamp(max=1)], -1)
    boxes[:, :20] = 0.0
    boxes = boxes.to(cuda)
    for crop in ((7, 7), (14, 14)):
        s_out = (torch.rand(*crop, c, generator=gen) * 3 + 0.5).to(cuda)
        variants = [dict(kw, out_quant=s_out)] + ([dict(kw)] if kw else [])
        for v in variants:
            before = roi_align.int8_launches
            got = roi_align.batched_multilevel_roi_align(feats, boxes, (256, 256), crop, **v)
            assert roi_align.int8_launches == before + 1
            want = roi_align.batched_multilevel_roi_align_plain(feats, boxes, (256, 256),
                                                                crop, **v)
            assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("h,w,c3,c1", [(64, 64, 256, 64), (16, 16, 1024, 256),
                                       (16, 8, 2048, 512)])
def test_fused_block_kernel_matches_plain(cuda, h, w, c3, c1):
    rng = np.random.RandomState(6)
    t = lambda a: torch.from_numpy(np.array(a)).to(cuda)
    k = lambda *s: t(rng.randint(-127, 128, s).astype(np.int8))
    v = lambda n, lo=0.5, hi=1.5: t(rng.uniform(lo, hi, n).astype(np.float32))
    x8 = t(rng.randint(-128, 128, (2, h, w, c3)).astype(np.int8))
    args = (x8, t(np.float32(3.0)), k(1, 1, c3, c1), k(3, 3, c1, c1), k(1, 1, c1, c3),
            v(c1) * 0.01, v(c1) * 0.002, v(c3) * 0.01,
            v(c1, -0.2, 0.2), v(c1, -0.2, 0.2), v(c3, -0.2, 0.2),
            (v(c1), v(c1, -0.3, 0.3)), (v(c1), v(c1, -0.3, 0.3)), (v(c3), v(c3, -0.3, 0.3)),
            t(np.float32(4.0)), t(np.float32(5.0)), t(np.float32(6.0)))
    before = fused_block.launches
    got = fused_block.fused_identity_block_int8(*args)
    assert fused_block.launches == before + 1
    want = fused_block.fused_identity_block_int8_plain(*args)
    assert torch.equal(got, want)
    assert int((want != 0).sum()) > want.numel() // 4  # the block is not all clipped


def test_int8_matmul_is_exact_on_the_card(cuda):
    rng = np.random.RandomState(7)
    for m, k, n in ((5, 147, 64), (4000, 2304, 256), (33, 512, 18)):
        a = rng.randint(-128, 128, (m, k)).astype(np.int8)
        b = rng.randint(-127, 128, (k, n)).astype(np.int8)
        got = quant.int8_matmul(torch.from_numpy(a).to(cuda), torch.from_numpy(b).to(cuda))
        assert got.dtype == torch.int32
        want = a.astype(np.int64) @ b.astype(np.int64)
        np.testing.assert_array_equal(got.cpu().numpy(), want)


def same(a, b):
    nan_a, nan_b = torch.isnan(a), torch.isnan(b)
    return torch.equal(nan_a, nan_b) and torch.equal(a[~nan_a], b[~nan_b])


def test_roi_align_kernels_outside_the_map_match_plain(cuda):
    gen = torch.Generator().manual_seed(8)
    c = 64
    nan = float("nan")
    # a NaN box; image 0 left of and above P2 (the table index wraps to the
    # end of the table); image 1 above its map (reads image 0's rows)
    boxes = torch.tensor([[[nan] * 4, [-0.2, -0.2, 0.1, 0.1], [0.1, 0.1, 0.5, 0.6]],
                          [[-0.6, 0.2, -0.3, 0.5], [-0.5, -0.7, -0.1, -0.2],
                           [0.0, 0.0, 1.0, 1.0]]], device=cuda)
    f32 = [torch.randn(2, s, s, c, generator=gen).to(cuda) for s in (64, 32, 16, 8)]
    shapes = [tuple(f.shape) for f in f32]
    for crop in ((7, 7), (14, 14)):
        got = roi_align.batched_multilevel_roi_align(f32, boxes, (256, 256), crop)
        want = roi_align.batched_multilevel_roi_align_plain(f32, boxes, (256, 256), crop)
        assert same(got, want) and bool(torch.isnan(want[0, 0]).all())
        assert bool(torch.isfinite(want[:, 1:]).all())
        s_out = (torch.rand(*crop, c, generator=gen) * 3 + 0.5).to(cuda)
        bf = [f.to(torch.bfloat16) for f in f32]
        got = roi_align.batched_multilevel_roi_align(bf, boxes, (256, 256), crop, out_quant=s_out)
        want = roi_align.batched_multilevel_roi_align_plain(bf, boxes, (256, 256), crop,
                                                            out_quant=s_out)
        assert torch.equal(got, want) and not bool(got[0, 0].any())
        grad_out = torch.randn(2, 3, *crop, c, generator=gen).to(cuda)
        got = roi_align.roi_align_backward(grad_out, boxes, shapes, (256, 256))
        want = roi_align.roi_align_backward_plain(grad_out, boxes, shapes, (256, 256))
        tol = roi_align.backward_tolerance(grad_out, boxes, shapes, (256, 256))
        for g, w, t in zip(got, want, tol):
            fin = ~torch.isnan(w)
            assert torch.equal(torch.isnan(g), ~fin)
            assert bool(((g.double() - w.double()).abs() <= t)[fin].all())


def test_patch_dma_kernel_matches_plain(cuda):
    src = patch_dma.make_source((4, 64, 64, 256), cuda)
    for n, p in ((500, 16), (300, 8), (40, 32)):
        i, y, xq = patch_dma.make_indices(n, p, (4, 64, 64, 256), cuda)
        before = patch_dma.launches
        got = patch_dma.patch_dma(src, i, y, xq, p)
        assert patch_dma.launches == before + 1
        want = patch_dma.patch_dma_plain(src, i, y, xq, p)
        assert bool(((got - want).abs() <= patch_dma.tolerance(src, i, y, xq)).all())


@pytest.mark.parametrize("variant", roi_inner.VARIANTS)
def test_roi_inner_kernel_matches_plain(cuda, variant):
    args = roi_inner.make_inputs(320, cuda)
    before = roi_inner.launches
    got = roi_inner.roi_inner(*args, variant)
    assert roi_inner.launches == before + 1
    assert torch.equal(got, roi_inner.roi_inner_plain(*args, variant))


@pytest.mark.parametrize("variant", roi_dispatch.VARIANTS)
def test_roi_dispatch_kernel_matches_plain(cuda, variant):
    args = roi_dispatch.make_inputs(variant, 320, cuda)
    before = roi_dispatch.launches
    got = roi_dispatch.roi_dispatch(*args, variant)
    assert roi_dispatch.launches == before + 1
    assert torch.equal(got, roi_dispatch.roi_dispatch_plain(*args, variant))
    meta = args[0].clone()
    meta[3, 0, 1], meta[3, 0, 2] = 3, 1  # outside the combos
    if variant != "bare":
        with pytest.raises(ValueError, match="combos"):
            roi_dispatch.roi_dispatch(meta, *args[1:], variant)
