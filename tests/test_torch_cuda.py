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
held bit-equal; the fused block at the ResNet stage shapes, at ragged tiles,
where most codes clip at 127 or 0, with its preparation kernel's affines equal
to ``block_affines`` and two kernels launched a call. On boxes outside the
map (a NaN box, boxes whose table index wraps) the three ROIAlign kernels
are held the same way, with NaNs in the plain version's places. The ROIAlign
design probes (P1-P3) are held at small sizes: P1 within
``patch_dma.tolerance``, P2 and P3 bit-equal; P2 also at ragged ROI counts
and with taps outside its patch; P3 also at ragged ROI counts, on mixed
classes and on each class's edge taps and columns. Anchor matching is also held at G = 1,
100, 300 and 2000, with every GT invalid, and twice a shape (its per-GT
scratch is reused). The ROIAlign kernel is also held at a non-square
crop (7×5, 5×7). Faster R-CNN's shapes: NMS at 12000 -> 2000 and IoU 0.2
on the proposal layer's pixel table (+1 corners), the layer itself through
the kernel and the plain version, and anchor matching over the ZF pixel
anchors. The serving path's device mold is held within 1e-3 of the
CPU's with TF32 off, and the server's handler on the card answers two
concurrent clients as it answers them in turn.

Hybrid Task Cascade's shapes: NMS over 96 × 80 per-class problems of 1000
rows at IoU 0.5 and budget 100, the per-class detection layer on the card
equal to the CPU's, and ROIAlign on one, two or three levels (the semantic
feature's single-map route).

At the main path's own sizes, on the seeded inputs the timing tools share
(``tools/torch_kernel_cases.py``): NMS at the serving, training, sparse and
RetinaNet cases; ROIAlign, its int8 epilogues and its gradient at the COCO
pyramid (1024², B = 2, C = 256: 1000 box and 100 mask ROIs, 200 a training
image), also on boxes outside that map; anchor matching on the COCO anchors
× 1, 100 and 300 GT (on their own seeded GT); the fused block at the four
R101 stage shapes of a batch of 2; the three probes at the TPU scripts'
sizes.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from objectdetection_torch import quant
from objectdetection_torch.ops import anchor_match, cuda_build, fused_block, nms, roi_align
from objectdetection_torch.probes import patch_dma, roi_dispatch, roi_inner

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import torch_kernel_cases as cases  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    try:
        cuda_build.nvcc_path()
    except RuntimeError:
        pytest.skip("no nvcc")
    return torch.device("cuda", 0)


def nms_case(n, num_classes, seed=0):
    """Two images of n rows around a few clusters, with exact duplicates,
    zero-area rows, all-zero rows of a real class, and a class -1 all-zero
    padded tail."""
    rng = np.random.RandomState(seed)
    ctr = rng.uniform(0.2, 0.8, (2, 6, 2))
    pick = rng.randint(0, 6, (2, n))
    c = np.take_along_axis(ctr, pick[..., None].repeat(2, -1), 1)
    c = c + rng.normal(0, 0.03, (2, n, 2))
    hw = rng.uniform(0.02, 0.3, (2, n, 2))
    boxes = np.concatenate([c - hw / 2, c + hw / 2], -1).astype(np.float32)
    for i, j in zip(*np.nonzero(rng.rand(2, n) < 0.05)):
        boxes[i, j] = boxes[i, j - 1]  # an exact duplicate of the row before
    flat = rng.rand(2, n) < 0.03
    boxes[..., 2][flat] = boxes[..., 0][flat]
    boxes[:, ::17] = 0.0
    cls = rng.randint(0, num_classes, (2, n)).astype(np.int32)
    pads = n // 8
    if pads:
        boxes[:, n - pads:] = 0.0
        cls[:, n - pads:] = -1
    return torch.from_numpy(boxes), torch.from_numpy(cls)


NMS_PARAMS = [pytest.param(n, num_classes, None, id=f"{n}-{num_classes}")
              for num_classes in (1, 81) for n in (1, 63, 64, 65, 257, 1500, 6000)] + [
    pytest.param(case[1], None, i, id=case[0]) for i, case in enumerate(cases.NMS_CASES)]


@pytest.mark.parametrize("n,num_classes,path_case", NMS_PARAMS)
def test_nms_kernel_matches_plain(cuda, n, num_classes, path_case):
    """nms_case's rows at four thresholds and three budgets; the main path's
    cases (``cases.NMS_CASES``: serving, training, sparse, RetinaNet) at
    their own threshold and budget."""
    if path_case is None:
        boxes, cls = (t.to(cuda) for t in nms_case(n, num_classes))
        runs = []
        for thr in (0.0, 0.3, 0.7, -0.1):  # -0.1: kept all-zero rows kill in their tile
            # a budget the survivor count reaches in mid-tile (after row n // 2)
            full = nms.suppress_plain(boxes, cls, thr)
            mid = int((full[0, :n // 2 + 1] != 0).any(-1).sum())
            runs += [(thr, budget) for budget in (max(mid, 1), None, 1)]
    else:
        boxes, cls = cases.nms_case_inputs(cuda)[path_case]
        runs = [cases.NMS_CASES[path_case][5:7]]
    for thr, budget in runs:
        before = cuda_build.launches("nms")
        got = nms.suppress(boxes, cls, thr, budget)
        assert cuda_build.launches("nms") == before + 1
        want = nms.suppress_plain(boxes, cls, thr, budget)
        assert torch.equal(got, want), (thr, budget)
        assert path_case is None or bool((want != 0).any())


@pytest.mark.parametrize("thr", [0.3, 0.5, 0.7])
def test_nms_kernel_matches_plain_near_the_threshold(cuda, thr):
    # pairs (box, the same box narrowed to IoU ~ thr * (1 + e)), each pair its
    # own class: e spans both sides of the kernel's 2^-16 shortcut margin and
    # the last few ulps, where only the rounded division decides
    rng = np.random.RandomState(9)
    e = np.concatenate([[0.0], np.logspace(-24, -12, 97, base=2.0)])
    e = np.concatenate([e, -e, rng.uniform(-2.0 ** -15, 2.0 ** -15, 200)])
    y1x1 = rng.uniform(0.0, 0.5, (e.size, 2))
    hw = rng.uniform(0.01, 0.5, (e.size, 2))
    first = np.concatenate([y1x1, y1x1 + hw], -1)
    second = first.copy()
    second[:, 3] = second[:, 1] + hw[:, 1] * thr * (1 + e)
    boxes = torch.tensor(np.stack([first, second], 1).reshape(1, -1, 4), dtype=torch.float32)
    cls = torch.arange(e.size, dtype=torch.int32).repeat_interleave(2)[None]
    boxes, cls = boxes.to(cuda), cls.to(cuda)
    want = nms.suppress_plain(boxes, cls, thr)
    killed = int((want[0, 1::2] == 0).all(-1).sum())
    assert 0 < killed < e.size  # both sides of the threshold occur
    assert torch.equal(nms.suppress(boxes, cls, thr), want)


def test_nms_kernel_raises_above_its_row_limit(cuda):
    rows = nms.MAX_ROWS + 1
    boxes = torch.zeros(1, rows, 4, device=cuda)
    cls = torch.zeros(1, rows, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="rows"):
        nms.suppress(boxes, cls, 0.5)
    assert torch.equal(nms.suppress(boxes[:, :-1], cls[:, :-1], 0.5, 10),
                       torch.zeros(1, rows - 1, 4, device=cuda))


def test_nms_kernel_at_the_htc_per_class_shape(cuda):
    """Hybrid Task Cascade's per-class NMS: 96 images × 80 classes, each
    class its own problem over the image's 1000 shared boxes sorted by that
    class's scores (rows under 0.001 zeroed), at IoU 0.5 with a budget of
    100: one launch over 7,680 problems, the survivor tables equal to the
    plain version's (run on the CPU)."""
    gen = torch.Generator().manual_seed(26)
    boxes = torch.cat([cases.nms_inputs(gen, 1000, 1, 0, "cpu")[0] for _ in range(48)])
    scores = torch.softmax(4 * torch.randn(96, 1000, 81, generator=gen), -1)[..., 1:]
    scores = scores.transpose(1, 2).reshape(96 * 80, 1000)
    order = torch.sort(-scores, dim=1, stable=True).indices
    table = torch.gather(boxes.repeat_interleave(80, dim=0), 1, order[..., None].expand(-1, -1, 4))
    table = torch.where((torch.gather(scores, 1, order) > 0.001)[..., None], table,
                        torch.zeros_like(table))
    cls = torch.zeros(table.shape[:2], dtype=torch.int32)
    before = cuda_build.launches("nms")
    got = nms.suppress(table.to(cuda), cls.to(cuda), 0.5, 100)
    assert cuda_build.launches("nms") == before + 1
    want = nms.suppress_plain(table, cls, 0.5, 100)
    assert torch.equal(got.cpu(), want)
    kept = (want != 0).any(-1).sum(-1)
    assert int((kept >= 100).sum()) > 0.9 * kept.numel()  # the budget stops most problems
    assert bool(((table != 0).any(-1).sum(-1) < 1000).any())


def test_per_class_detection_layer_on_the_card_equals_the_cpu(cuda):
    from objectdetection_torch.config import HTCConfig
    from objectdetection_torch.layers.detection import per_class_detection_layer

    gen = torch.Generator().manual_seed(27)
    boxes = torch.cat([cases.nms_inputs(gen, 1000, 1, 0, "cpu")[0] for _ in range(2)])
    probs = torch.softmax(4 * torch.randn(4, 1000, 81, generator=gen), -1)
    rows_valid = torch.rand(4, 1000, generator=gen) > 0.1
    cfg = HTCConfig()
    got = per_class_detection_layer(boxes.to(cuda), probs.to(cuda), rows_valid.to(cuda), 0.001,
                                    cfg)
    want = per_class_detection_layer(boxes, probs, rows_valid, 0.001, cfg)
    assert torch.equal(got.cpu(), want) and bool((want[..., 5] > 0).all())


@pytest.mark.parametrize("levels", [1, 2, 3])
def test_roi_align_kernels_on_fewer_levels(cuda, levels):
    """The single-map route (the cascade's semantic feature: one map at
    stride 8) and two or three levels: the forward f32 bit-equal to the
    plain version, bf16 within its tolerance, the f32 gradient within its
    bound; a box whose rule names a later level pools the last given."""
    gen = torch.Generator().manual_seed(40 + levels)
    sizes = (128, 64, 32)[:levels]
    feats = [torch.randn(2, s, s, 256, generator=gen).to(cuda) for s in sizes]
    boxes = cases.roi_boxes(gen, 1000, cuda)
    image = (1024, 1024)
    for crop in ((7, 7), (14, 14)):
        before = cuda_build.launches("roi_align")
        got = roi_align.batched_multilevel_roi_align(feats, boxes, image, crop)
        assert cuda_build.launches("roi_align") == before + 1
        assert torch.equal(got, roi_align.batched_multilevel_roi_align_plain(
            feats, boxes, image, crop))
    bf = [f.to(torch.bfloat16) for f in feats]
    err = (roi_align.batched_multilevel_roi_align(bf, boxes, image, (14, 14)).float()
           - roi_align.batched_multilevel_roi_align_plain(bf, boxes, image, (14, 14)).float())
    assert float(err.abs().max()) <= roi_align.bf16_tolerance(bf)
    grad = torch.randn(2, 1000, 14, 14, 256, generator=gen).to(cuda)
    shapes = [tuple(f.shape) for f in feats]
    got = roi_align.roi_align_backward(grad, boxes, shapes, image)
    want = roi_align.roi_align_backward_plain(grad, boxes, shapes, image)
    for g, w, tol in zip(got, want, roi_align.backward_tolerance(grad, boxes, shapes, image)):
        assert bool(((g - w).abs() <= tol).all())
    if levels == 1:  # every box on the one map: crop_and_resize of it away from its far
        # edge (there a rounding past H - 1 zeroes a crop_and_resize sample)
        inside = (boxes.amin(-1) >= 0) & (boxes.amax(-1) <= 0.95)
        one = roi_align.crop_and_resize(feats[0], boxes, (14, 14))
        full = roi_align.batched_multilevel_roi_align(feats, boxes, image, (14, 14))
        assert torch.allclose(full[inside], one[inside], rtol=1e-5, atol=1e-5)


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
        before = cuda_build.launches("roi_align")
        got = roi_align.batched_multilevel_roi_align(feats, boxes, (256, 256), crop)
        assert cuda_build.launches("roi_align") == before + 1
        want = roi_align.batched_multilevel_roi_align_plain(feats, boxes, (256, 256), crop)
        if dtype == torch.float32:
            assert torch.equal(got, want)
        else:
            err = float((got.float() - want.float()).abs().max())
            assert err <= roi_align.bf16_tolerance(feats)


@pytest.mark.parametrize("channels", [64, 256, 20, 13])
@pytest.mark.parametrize("crop", [(1, 1), (7, 7), (14, 14), (28, 28)])
def test_roi_align_kernel_crops_and_channels(cuda, crop, channels):
    # every variant of the forward: f32 bit-equal, bf16 within its tolerance,
    # the int8 epilogues (f32 and bf16 in -> int8, int8 per channel and per
    # tensor -> int8, int8 -> bf16) bit-equal; 20 and 13 channels fill no
    # 16-byte vector of bf16 (nor, 13, of f32): one channel a thread
    gen = torch.Generator().manual_seed(13)
    f32 = [torch.randn(2, s, s, channels, generator=gen) for s in (64, 32, 16, 8)]
    y1x1 = torch.rand(2, 100, 2, generator=gen) * 0.8
    boxes = torch.cat([y1x1, (y1x1 + torch.rand(2, 100, 2, generator=gen)).clamp(max=1)], -1)
    boxes[:, :10] = 0.0
    boxes[:, 10:20, 2] = boxes[:, 10:20, 0]
    boxes = boxes.to(cuda)
    image = (256, 256)
    feats = [f.to(cuda) for f in f32]
    bf = [f.to(torch.bfloat16) for f in feats]
    before = cuda_build.launches("roi_align")
    assert torch.equal(roi_align.batched_multilevel_roi_align(feats, boxes, image, crop),
                       roi_align.batched_multilevel_roi_align_plain(feats, boxes, image, crop))
    got = roi_align.batched_multilevel_roi_align(bf, boxes, image, crop)
    want = roi_align.batched_multilevel_roi_align_plain(bf, boxes, image, crop)
    assert float((got.float() - want.float()).abs().max()) <= roi_align.bf16_tolerance(bf)
    assert cuda_build.launches("roi_align") == before + 2
    s_ch = (torch.rand(channels, generator=gen) * 3 + 1).to(cuda)
    s_sc = torch.tensor(2.5, device=cuda)
    s_out = (torch.rand(*crop, channels, generator=gen) * 3 + 0.5).to(cuda)
    q_ch = [quant.quantize_act(f, s_ch) for f in feats]
    q_sc = [quant.quantize_act(f, s_sc) for f in feats]
    for fs, kw in ((feats, dict(out_quant=s_out)), (bf, dict(out_quant=s_out)),
                   (q_ch, dict(out_quant=s_out, in_scale=s_ch)),
                   (q_sc, dict(out_quant=s_out, in_scale=s_sc)), (q_ch, dict(in_scale=s_ch))):
        before = cuda_build.launches("roi_align_int8")
        got = roi_align.batched_multilevel_roi_align(fs, boxes, image, crop, **kw)
        assert cuda_build.launches("roi_align_int8") == before + 1
        want = roi_align.batched_multilevel_roi_align_plain(fs, boxes, image, crop, **kw)
        assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("crop", [(7, 5), (5, 7)])
def test_roi_align_kernel_at_a_non_square_crop(cuda, crop):
    # C3: the box stage at pool_shape (7, 5): f32 bit-equal, bf16 within its
    # tolerance, the int8 epilogue with a per-position (ph, pw, C) map bit-equal
    gen = torch.Generator().manual_seed(75)
    feats = [torch.randn(2, s, s, 256, generator=gen).to(cuda) for s in (64, 32, 16, 8)]
    y1x1 = torch.rand(2, 200, 2, generator=gen) * 0.8
    boxes = torch.cat([y1x1, (y1x1 + torch.rand(2, 200, 2, generator=gen)).clamp(max=1)], -1)
    boxes = boxes.to(cuda)
    image = (256, 256)
    before = cuda_build.launches("roi_align")
    got = roi_align.batched_multilevel_roi_align(feats, boxes, image, crop)
    assert cuda_build.launches("roi_align") == before + 1 and tuple(got.shape[2:4]) == crop
    assert torch.equal(got, roi_align.batched_multilevel_roi_align_plain(feats, boxes, image, crop))
    bf = [f.to(torch.bfloat16) for f in feats]
    err = (roi_align.batched_multilevel_roi_align(bf, boxes, image, crop).float()
           - roi_align.batched_multilevel_roi_align_plain(bf, boxes, image, crop).float())
    assert float(err.abs().max()) <= roi_align.bf16_tolerance(bf)
    s_out = (torch.rand(*crop, 256, generator=gen) * 3 + 0.5).to(cuda)
    got8 = roi_align.batched_multilevel_roi_align(bf, boxes, image, crop, out_quant=s_out)
    want8 = roi_align.batched_multilevel_roi_align_plain(bf, boxes, image, crop, out_quant=s_out)
    assert got8.dtype == torch.int8 and torch.equal(got8, want8)


def test_device_mold_matches_the_cpu(cuda):
    # the mold's two products in f32 with TF32 off: within 1e-3 of the CPU's
    from objectdetection_torch.config import COCO_CONFIG
    from objectdetection_torch.data.preprocess import mold_batch_device

    rng = np.random.RandomState(3)
    shapes = np.array([[480, 640], [1200, 900], [333, 500]], np.int32)
    canvases = np.zeros((3, 1200, 1200, 3), np.float32)
    for i, (h, w) in enumerate(shapes):
        canvases[i, :h, :w] = rng.randint(0, 256, (h, w, 3))
    cpu, cmeta = mold_batch_device(torch.from_numpy(canvases), torch.from_numpy(shapes),
                                   COCO_CONFIG)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True  # the mold turns it off for itself
    try:
        dev, dmeta = mold_batch_device(torch.from_numpy(canvases).to(cuda),
                                       torch.from_numpy(shapes).to(cuda), COCO_CONFIG)
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert torch.equal(dmeta.window.cpu(), cmeta.window)
    assert torch.equal(dmeta.scale.cpu(), cmeta.scale)
    assert float((dev.cpu() - cpu).abs().max()) <= 1e-3


def test_handler_on_the_card_serves_concurrent_requests_as_sequential(cuda):
    import json
    import threading
    import urllib.request
    from http.server import ThreadingHTTPServer

    from objectdetection_torch import serve
    from objectdetection_torch.config import SHAPES_CONFIG
    from objectdetection_torch.convert import init_params
    from objectdetection_torch.data.image_io import encode_png
    from objectdetection_torch.detector import make_infer_fn

    cfg = SHAPES_CONFIG.replace(image_shape=(64, 64, 3), image_min_dim=64, image_max_dim=64,
                                pre_nms_rois_count=128, post_nms_rois_inference=32,
                                detection_min_threshold=0.0)
    params = init_params(cfg, torch.Generator().manual_seed(0), cuda)
    handler = serve.build_handler(make_infer_fn(cfg, with_masks=False, device=cuda), params,
                                  cfg, None, native_decode=True)
    srv = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{srv.server_address[1]}/detect"
    rng = np.random.RandomState(4)
    bodies = [encode_png(rng.randint(0, 256, (48, 80, 3)).astype(np.uint8)) for _ in range(3)]

    def post(body):
        req = urllib.request.Request(url, data=body, method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            return json.loads(r.read())["detections"]

    try:
        sequential = [post(b) for b in bodies]
        assert any(sequential)
        results, errors, go = {}, [], threading.Barrier(2)

        def client(t):
            go.wait()
            for i, b in enumerate(bodies):
                try:
                    results[t, i] = post(b)
                except Exception as exc:  # recorded: the assertion below names it
                    errors.append(repr(exc))

        threads = [threading.Thread(target=client, args=(t,)) for t in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors, errors
        assert all(results[t, i] == sequential[i] for t in range(2) for i in range(3))
    finally:
        srv.shutdown()
        srv.server_close()


@pytest.mark.parametrize("bpp", [1, 2, 3, 4, 6, 8])
def test_png_c_unfilter_matches_numpy(cuda, bpp):
    # host code built by nvcc: random filtered bytes, every filter type on
    # rows in random order, as many bytes a pixel as PNG has
    from objectdetection_torch.data import image_io

    rng = np.random.RandomState(bpp)
    h, rowbytes = 67, bpp * 45
    rows = rng.randint(0, 256, (h, rowbytes + 1)).astype(np.uint8)
    rows[:, 0] = rng.randint(0, 5, h)
    rows[:5, 0] = [0, 1, 2, 3, 4]
    got = image_io.unfilter_native(rows, bpp)
    np.testing.assert_array_equal(got, image_io.unfilter(rows[:, 1:], rows[:, 0], bpp))
    rows[40, 0] = 5
    with pytest.raises(image_io.ImageDecodeError, match="filter type 5"):
        image_io.unfilter_native(rows, bpp)


def test_png_decode_with_the_c_unfilter_is_bit_exact(cuda):
    from objectdetection_torch.data import image_io

    rng = np.random.RandomState(6)
    img = rng.randint(0, 256, (300, 410, 3)).astype(np.uint8)
    for filters in [None, (0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4)]:
        for im in (img, img[..., 0]):
            want = im if im.ndim == 3 else np.repeat(im[..., None], 3, -1)
            buf = image_io.encode_png(im, filters)
            np.testing.assert_array_equal(image_io.decode_image(buf, native=True), want)


def test_roi_align_kernel_raises_without_a_thread_layout(cuda):
    # 300 bf16 channels fill no 16-byte vector and exceed one channel a
    # thread: the kernel raises (300 f32 channels are 75 vectors: it runs)
    feats = [torch.randn(1, s, s, 300, device=cuda) for s in (16, 8, 4, 2)]
    boxes = torch.tensor([[[0.1, 0.1, 0.6, 0.7]]], device=cuda)
    with pytest.raises(ValueError, match="layout"):
        roi_align.batched_multilevel_roi_align([f.bfloat16() for f in feats], boxes, (64, 64),
                                               (7, 7))
    assert torch.equal(roi_align.batched_multilevel_roi_align(feats, boxes, (64, 64), (7, 7)),
                       roi_align.batched_multilevel_roi_align_plain(feats, boxes, (64, 64),
                                                                    (7, 7)))


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
    before = cuda_build.launches("anchor_match")
    got = anchor_match.anchor_match(anchors, gt, valid)
    assert cuda_build.launches("anchor_match") == before + 1
    want = anchor_match.anchor_match_plain(anchors, gt, valid)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(got.gt_argmax[0, 2]) == 5 and int(got.anchor_argmax[0, 5]) == 2


def coco_match_case(g, b, anchors_n, seed, all_invalid=False):
    """GT boxes of realistic sizes on the COCO anchors (the first anchors_n)
    with ties, an anchor as a GT, invalid rows holding boxes and zero
    padding rows."""
    from objectdetection_torch.anchors import config_anchors
    from objectdetection_torch.config import COCO_CONFIG

    anchors = torch.from_numpy(config_anchors(COCO_CONFIG))[:anchors_n]
    rng = np.random.RandomState(seed)
    y1x1 = rng.rand(b, g, 2) * 0.8
    hw = 0.02 + rng.rand(b, g, 2) ** 2 * 0.5
    gt = torch.from_numpy(np.concatenate([y1x1, np.minimum(y1x1 + hw, 1.0)], -1)
                          .astype(np.float32))
    valid = torch.from_numpy(rng.rand(b, g) > 0.2)
    if g >= 4:
        gt[:, 1] = gt[:, 0]
        gt[:, 2] = anchors[min(1000, anchors_n - 1)]
        gt[:, g - 2:] = 0.0
        valid[:, g - 2:] = False
    if all_invalid:
        valid[:] = False
    return anchors, gt, valid


@pytest.mark.parametrize("g,b,anchors_n", [(1, 2, 261888), (100, 2, 261888), (300, 2, 261888),
                                           (2000, 1, 65536)])
def test_anchor_match_kernel_at_gt_counts(cuda, g, b, anchors_n):
    """G = 2000 puts the kernel's GT tables (32 bytes a GT) beyond 48 KB of
    shared memory; each shape is called twice, so the second call finds the
    per-GT scratch as the first left it."""
    for seed in (2, 3):
        anchors, gt, valid = (t.to(cuda) for t in coco_match_case(g, b, anchors_n, seed))
        before = cuda_build.launches("anchor_match")
        got = anchor_match.anchor_match(anchors, gt, valid)
        assert cuda_build.launches("anchor_match") == before + 1
        want = anchor_match.anchor_match_plain(anchors, gt, valid)
        for name, k, w in zip(want._fields, got, want):
            assert torch.equal(k, w), name
        if g > 1:
            assert bool((got.gt_max > 0).any())


def test_anchor_match_kernel_with_every_gt_invalid(cuda):
    anchors, gt, valid = (t.to(cuda) for t in coco_match_case(100, 2, 261888, 4, True))
    got = anchor_match.anchor_match(anchors, gt, valid)
    for t in got:
        assert not t.any()
    anchors, gt, valid = (t.to(cuda) for t in coco_match_case(100, 2, 261888, 5))
    got = anchor_match.anchor_match(anchors, gt, valid)  # the scratch is clean after it
    for k, w in zip(got, anchor_match.anchor_match_plain(anchors, gt, valid)):
        assert torch.equal(k, w)


def zf_case(seed):
    """Faster R-CNN at 600×1000: the ZF anchor grid (38×63×9 = 21,546 pixel
    anchors) with random foreground scores and deltas."""
    from objectdetection_torch.config import FasterRCNNConfig
    from objectdetection_torch.models import faster_rcnn as fr

    cfg = FasterRCNNConfig().replace(image_shape=(600, 1000, 3), num_classes=21)
    h, w = fr.feature_shape(cfg.image_shape)
    rng = np.random.RandomState(seed)
    fg = torch.from_numpy(rng.rand(2, h, w, 9).astype(np.float32))
    deltas = torch.from_numpy((rng.randn(2, h, w, 9, 4) * 0.2).astype(np.float32))
    anchors = torch.from_numpy(fr.zf_grid_anchors((h, w), cfg.backbone_stride))
    return cfg, fg, deltas, anchors


def test_nms_kernel_at_the_faster_rcnn_training_budget(cuda, monkeypatch):
    """B2 at 12000 -> 2000, IoU 0.2, on the proposal layer's own table
    (pixel boxes, max corners shifted by +1), then the whole layer through
    the kernel and through the plain version (its top-k, decode and gathers
    run the same ops on both)."""
    from objectdetection_torch.layers.proposals import top_k_stable
    from objectdetection_torch.models import faster_rcnn as fr

    cfg, fg, deltas, anchors = zf_case(7)
    boxes = fr.clip_to_image(fr.decode_zf_deltas(anchors[None], deltas.reshape(2, -1, 4)),
                             cfg.image_shape)
    big = ((boxes[..., 2] - boxes[..., 0] + 1 >= cfg.min_box_size)
           & (boxes[..., 3] - boxes[..., 1] + 1 >= cfg.min_box_size))
    scores = torch.where(big, fg.reshape(2, -1), torch.tensor(float("-inf")))
    top, ix = top_k_stable(scores, cfg.pre_nms_top_n_train)
    table = torch.gather(boxes, 1, ix[..., None].expand(2, -1, 4)) + torch.tensor([0., 0, 1, 1])
    table = torch.where(torch.isfinite(top)[..., None], table, torch.zeros_like(table))
    assert table.shape == (2, 12000, 4)
    table, cls = table.to(cuda), torch.zeros(2, 12000, dtype=torch.int32, device=cuda)
    before = cuda_build.launches("nms")
    got = nms.suppress(table, cls, cfg.nms_threshold, cfg.post_nms_top_n_train)
    assert cuda_build.launches("nms") == before + 1
    assert torch.equal(got, nms.suppress_plain(table, cls, cfg.nms_threshold,
                                               cfg.post_nms_top_n_train))
    # ~100 survivors an image at IoU 0.2: the budget never stops the sweep,
    # which resolves all 12000 rows
    assert 0 < int((got != 0).any(-1).sum(-1).max()) < cfg.post_nms_top_n_train

    fg, deltas = fg.to(cuda), deltas.to(cuda)
    props, valid = fr.zf_proposal_layer(fg, deltas, cfg, training=True)
    monkeypatch.setattr(nms, "suppress", nms.suppress_plain)
    want_props, want_valid = fr.zf_proposal_layer(fg, deltas, cfg, training=True)
    assert torch.equal(valid, want_valid) and torch.equal(props, want_props)
    assert int(valid.sum()) > 0


def test_anchor_match_kernel_over_the_zf_anchors(cuda):
    """B3 over Faster R-CNN's pixel anchors (21,546, many reaching outside
    the image) and pixel GT boxes, with invalid rows and an anchor as a GT."""
    _, _, _, anchors = zf_case(8)
    rng = np.random.RandomState(8)
    for g in (1, 5, 64):
        xy = rng.uniform(0, 900, (2, g, 2))
        wh = rng.uniform(16, 500, (2, g, 2))
        gt = torch.from_numpy(np.concatenate([xy, np.minimum(xy + wh, [999, 599])], -1)
                              .astype(np.float32))
        valid = torch.from_numpy(rng.rand(2, g) > 0.25)
        valid[:, 0] = True
        if g > 2:
            gt[:, 1] = anchors[4321]
            gt[:, -1] = 0.0
            valid[:, -1] = False
        a, gt, valid = anchors.to(cuda), gt.to(cuda), valid.to(cuda)
        before = cuda_build.launches("anchor_match")
        got = anchor_match.anchor_match(a, gt, valid)
        assert cuda_build.launches("anchor_match") == before + 1
        want = anchor_match.anchor_match_plain(a, gt, valid)
        for name, k, w in zip(want._fields, got, want):
            assert torch.equal(k, w), (g, name)
        if g > 2:
            assert int(got.gt_argmax[0, 1]) == 4321


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
        before = cuda_build.launches("roi_align_backward")
        got = roi_align.roi_align_backward(grad_out, boxes, shapes, (256, 256))
        assert cuda_build.launches("roi_align_backward") == before + 1
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


def backward_within_bounds(grad_out, boxes, shapes, image):
    """The gradient kernels against the plain backward (and, in bf16, the f32
    backward) within ``backward_tolerance``, NaNs in the same places; in bf16
    the kernels' row marks equal ``touched_row_marks``."""
    before = cuda_build.launches("roi_align_backward")
    got, marks = roi_align._backward_kernel(grad_out, boxes, shapes, image)
    assert cuda_build.launches("roi_align_backward") == before + 1
    want = roi_align.roi_align_backward_plain(grad_out, boxes, shapes, image)
    refs = [(want, roi_align.backward_tolerance(grad_out, boxes, shapes, image))]
    if grad_out.dtype == torch.bfloat16:
        crop = tuple(grad_out.shape[2:4])
        assert torch.equal(marks.bool(), roi_align.touched_row_marks(shapes, boxes, image, crop))
        refs.append((roi_align.roi_align_backward_plain(grad_out.float(), boxes, shapes, image),
                     roi_align.backward_tolerance(grad_out, boxes, shapes, image,
                                                  against_f32=True)))
    for ref, tol in refs:
        for g, w, t in zip(got, ref, tol):
            assert g.dtype == grad_out.dtype and g.shape == w.shape
            fin = ~torch.isnan(w)
            assert torch.equal(torch.isnan(g), ~fin)
            assert bool(((g.double() - w.double()).abs() <= t)[fin].all())
    return got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_roi_align_backward_kernel_under_contention(cuda, dtype):
    # 60 zero, 60 flat and 60 tiny boxes per image at 14x14: up to 60 * 196
    # samples land on the same four rows
    gen = torch.Generator().manual_seed(10)
    shapes = [(2, s, s, 64) for s in (64, 32, 16, 8)]
    y1x1 = torch.rand(2, 200, 2, generator=gen) * 0.8
    boxes = torch.cat([y1x1, (y1x1 + torch.rand(2, 200, 2, generator=gen) * 0.3).clamp(max=1)],
                      -1)
    boxes[:, :60] = 0.0
    boxes[:, 60:120, 2] = boxes[:, 60:120, 0]
    boxes[:, 120:180, 2:] = boxes[:, 120:180, :2] + 1e-4
    boxes = boxes.to(cuda)
    grad_out = torch.randn(2, 200, 14, 14, 64, generator=gen).to(cuda, dtype)
    got = backward_within_bounds(grad_out, boxes, shapes, (256, 256))
    assert float(got[0][0, 0, 0].float().abs().sum()) > 0


def footprint_pixels(shapes, boxes, image, crop):
    """Pixels of each ROI's bounding rectangle of corners on its level."""
    corners = roi_align._corners([s[1:3] for s in shapes], boxes, image, crop)
    li = roi_align.roi_levels(boxes, image[0] * image[1]) - 2
    hs = torch.tensor([s[1] for s in shapes], device=boxes.device)
    ws = torch.tensor([s[2] for s in shapes], device=boxes.device)
    sizes = hs * ws * shapes[0][0]
    base = torch.cumsum(sizes, 0) - sizes
    b, r = boxes.shape[:2]
    rows = torch.stack([rw for rw, _ in corners]).reshape(4, b, r, -1)
    loc = rows - (base[li] + torch.arange(b, device=boxes.device)[:, None] * hs[li] * ws[li])[
        None, :, :, None]
    y, x = loc // ws[li][None, :, :, None], loc % ws[li][None, :, :, None]
    return ((y.amax((0, 3)) - y.amin((0, 3)) + 1) * (x.amax((0, 3)) - x.amin((0, 3)) + 1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_roi_align_backward_kernel_beyond_the_shared_tile(cuda, dtype):
    # full-image boxes on P5 (32 x 32 pixels) and 1.0 x 0.02 flat boxes on P3
    # (5 x 128 pixels, wide and tall) of a 1024^2 pyramid: footprints above
    # the kernel's shared tile, which take its direct global path, beside
    # boxes that fit
    gen = torch.Generator().manual_seed(11)
    image = (1024, 1024)
    shapes = [(2, s, s, 64) for s in (256, 128, 64, 32)]
    y1x1 = torch.rand(2, 40, 2, generator=gen) * 0.8
    boxes = torch.cat([y1x1, (y1x1 + torch.rand(2, 40, 2, generator=gen) * 0.2).clamp(max=1)],
                      -1)
    boxes[:, :10] = torch.tensor([0.0, 0.0, 1.0, 1.0])
    boxes[:, 10:20] = torch.tensor([0.305, 0.0, 0.325, 1.0])
    boxes[:, 20:25] = torch.tensor([0.0, 0.5, 1.0, 0.52])
    boxes = boxes.to(cuda)
    for crop in ((7, 7), (14, 14)):
        pixels = footprint_pixels(shapes, boxes, image, crop)
        assert bool((pixels[:, :25] > roi_align.SHARED_PIXELS).all())
        assert bool((pixels[:, 25:] <= roi_align.SHARED_PIXELS).any())
        grad_out = torch.randn(2, 40, *crop, 64, generator=gen).to(cuda, dtype)
        backward_within_bounds(grad_out, boxes, shapes, image)


@pytest.mark.parametrize("channels", [64, 256, 20, 13])
@pytest.mark.parametrize("crop", [(1, 1), (7, 7), (14, 14), (28, 28)])
def test_roi_align_backward_kernel_crops_and_channels(cuda, crop, channels):
    # 20: a partial 32-channel slice (4-channel flush); 13: the scalar flush
    gen = torch.Generator().manual_seed(12)
    shapes = [(2, s, s, channels) for s in (64, 32, 16, 8)]
    y1x1 = torch.rand(2, 50, 2, generator=gen) * 0.8
    boxes = torch.cat([y1x1, (y1x1 + torch.rand(2, 50, 2, generator=gen)).clamp(max=1)], -1)
    boxes[:, :5] = 0.0
    boxes = boxes.to(cuda)
    for dtype in (torch.float32, torch.bfloat16):
        grad_out = torch.randn(2, 50, *crop, channels, generator=gen).to(cuda, dtype)
        backward_within_bounds(grad_out, boxes, shapes, (256, 256))


def test_roi_align_output_carries_the_feature_gradient(cuda):
    # the kernel's output is differentiable in the features, through the
    # gradient kernel (a detached output would silently cut the FPN's gradient)
    gen = torch.Generator().manual_seed(4)
    feats = [torch.randn(1, s, s, 32, generator=gen).to(cuda).requires_grad_(True)
             for s in (32, 16, 8, 4)]
    boxes = torch.tensor([[[0.1, 0.1, 0.6, 0.7], [0.0, 0.0, 1.0, 1.0]]], device=cuda)
    out = roi_align.batched_multilevel_roi_align(feats, boxes, (128, 128), (7, 7))
    assert out.requires_grad and out.grad_fn is not None
    before = cuda_build.launches("roi_align_backward")
    grads = torch.autograd.grad(out.square().sum(), feats, allow_unused=True)
    assert cuda_build.launches("roi_align_backward") == before + 1
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
            before = cuda_build.launches("roi_align_int8")
            got = roi_align.batched_multilevel_roi_align(feats, boxes, (256, 256), crop, **v)
            assert cuda_build.launches("roi_align_int8") == before + 1
            want = roi_align.batched_multilevel_roi_align_plain(feats, boxes, (256, 256),
                                                                crop, **v)
            assert got.dtype == want.dtype and torch.equal(got, want)


def block_args(cuda, b, h, w, c3, c1, seed=6, alpha=1.0, shift=0.0, oihw=False):
    """A fused block's arguments (tests/test_fused_block.py's make_case);
    ``alpha`` scales every weight scale (most codes clip at 127), ``shift``
    moves every BatchNorm shift (below 0: most codes 0); ``oihw``: kernels
    as HWIO views of OIHW storage, as the backbone passes them."""
    rng = np.random.RandomState(seed)
    t = lambda a: torch.from_numpy(np.array(a)).to(cuda)
    k = lambda *s: t(rng.randint(-127, 128, s).astype(np.int8))
    v = lambda n, lo=0.5, hi=1.5: t(rng.uniform(lo, hi, n).astype(np.float32))
    x8 = t(rng.randint(-128, 128, (b, h, w, c3)).astype(np.int8))
    ka, kb, kc = k(1, 1, c3, c1), k(3, 3, c1, c1), k(1, 1, c1, c3)
    if oihw:
        ka, kb, kc = (q.permute(3, 2, 0, 1).contiguous().permute(2, 3, 1, 0) for q in (ka, kb, kc))
    bn = lambda n: (v(n), v(n, -0.3, 0.3) + shift)
    return (x8, t(np.float32(3.0)), ka, kb, kc,
            v(c1) * 0.01 * alpha, v(c1) * 0.002 * alpha, v(c3) * 0.01 * alpha,
            v(c1, -0.2, 0.2), v(c1, -0.2, 0.2), v(c3, -0.2, 0.2),
            bn(c1), bn(c1), bn(c3), t(np.float32(4.0)), t(np.float32(5.0)), t(np.float32(6.0)))


@pytest.mark.parametrize("b,h,w,c3,c1", [
    (2, 64, 64, 256, 64), (2, 16, 16, 1024, 256), (2, 16, 8, 2048, 512),
    # the four R101 stage shapes of a 1024² image, and of a batch of 2
    (1, 256, 256, 256, 64), (1, 128, 128, 512, 128), (1, 64, 64, 1024, 256),
    (1, 32, 32, 2048, 512), *[(2, *stage) for stage in cases.STAGES],
    # ragged: W = 3, W = 12, H = 16 over two row tiles with a ragged last
    # column tile; a batch of 3
    (1, 16, 3, 128, 64), (1, 16, 12, 32, 64), (1, 16, 2044, 64, 64), (3, 16, 16, 256, 64),
    # W·C3 = 131072: the row kernel before the tiled one refused it
    (1, 16, 512, 256, 64),
])
def test_fused_block_kernel_matches_plain(cuda, b, h, w, c3, c1):
    args = block_args(cuda, b, h, w, c3, c1)
    before = cuda_build.launches("fused_block")
    got = fused_block.fused_identity_block_int8(*args)
    assert cuda_build.launches("fused_block") == before + 1
    want = fused_block.fused_identity_block_int8_plain(*args)
    assert torch.equal(got, want)
    assert int((want != 0).sum()) > want.numel() // 4  # the block is not all clipped


@pytest.mark.parametrize("alpha,shift,code,share", [(40.0, 0.0, 127, 0.3), (1.0, -60.0, 0, 0.9)])
def test_fused_block_kernel_matches_plain_when_codes_clip(cuda, alpha, shift, code, share):
    args = block_args(cuda, 2, 16, 16, 256, 64, seed=9, alpha=alpha, shift=shift)
    got = fused_block.fused_identity_block_int8(*args)
    want = fused_block.fused_identity_block_int8_plain(*args)
    assert torch.equal(got, want)
    assert float((want == code).float().mean()) > share


def test_fused_block_preparation_matches_block_affines(cuda):
    for oihw in (False, True):
        args = block_args(cuda, 1, 16, 16, 1024, 256, seed=10, oihw=oihw)
        x8, in_scale, ka8, kb8, kc8 = args[:5]
        c1, c3, kch = 256, 1024, 128
        aff, ka, kb, kc = fused_block.prepare(cuda, kch, *args[1:])
        want = fused_block.block_affines(args[1], *args[5:])
        got = torch.split(aff, (c1, c1, c1, c1, c3, c3, 1))
        for g, w_ in zip(got, want):
            assert torch.equal(g, w_.reshape(-1).expand(g.numel()))
        assert torch.equal(ka, ka8[0, 0].t()) and torch.equal(kc, kc8[0, 0].t())
        ohwi = kb8.permute(3, 0, 1, 2).reshape(c1, 9 * c1)  # 9·c1 = 18 chunks of kch
        assert torch.equal(kb, ohwi.view(c1, 9 * c1 // kch, kch).transpose(0, 1))
        if oihw:  # the 1x1 kernels are read in place
            assert ka.data_ptr() == ka8.data_ptr() and kc.data_ptr() == kc8.data_ptr()


def test_fused_block_launches_two_kernels_per_call(cuda):
    args = block_args(cuda, 2, 16, 16, 256, 64, oihw=True)
    fused_block.fused_identity_block_int8(*args)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        before = cuda_build.launches("fused_block")
        got = fused_block.fused_identity_block_int8(*args)
        torch.cuda.synchronize()
    assert cuda_build.launches("fused_block") == before + 1
    names = [e.key for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    assert len(names) == 2, names
    assert sum("fused_block_prep_kernel" in n for n in names) == 1, names
    assert sum("fused_block_kernel" in n for n in names) == 1, names
    assert torch.equal(got, fused_block.fused_identity_block_int8_plain(*args))


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


@pytest.mark.parametrize("shape,patches", [
    ((4, 64, 64, 256), ((500, 16), (300, 8), (40, 32))),
    (patch_dma.SRC_SHAPE, patch_dma.CASES)], ids=["small", "tpu"])
def test_patch_dma_kernel_matches_plain(cuda, shape, patches):
    """At a small source, and at the TPU script's source and cases."""
    src = patch_dma.make_source(shape, cuda)
    for n, p in patches:
        i, y, xq = patch_dma.make_indices(n, p, shape, cuda)
        before = cuda_build.launches("patch_dma_probe")
        got = patch_dma.patch_dma(src, i, y, xq, p)
        assert cuda_build.launches("patch_dma_probe") == before + 1
        want = patch_dma.patch_dma_plain(src, i, y, xq, p)
        assert bool(((got - want).abs() <= patch_dma.tolerance(src, i, y, xq)).all())


@pytest.mark.parametrize("variant", roi_inner.VARIANTS)
@pytest.mark.parametrize("n", [320, 96000], ids=["small", "tpu"])
def test_roi_inner_kernel_matches_plain(cuda, n, variant):
    """At 320 ROIs, and at the TPU script's 96000."""
    args = roi_inner.make_inputs(n, cuda)
    before = cuda_build.launches("roi_inner_probe")
    got = roi_inner.roi_inner(*args, variant)
    assert cuda_build.launches("roi_inner_probe") == before + 1
    assert torch.equal(got, roi_inner.roi_inner_plain(*args, variant))


@pytest.mark.parametrize("variant", roi_inner.VARIANTS)
@pytest.mark.parametrize("n", [1, 2, 1001, 5003])
def test_roi_inner_kernel_at_ragged_counts(cuda, variant, n):
    """n = 1 and counts that are not a multiple of the kernel's walk (132
    ranges of 4 streams a slice on an H100), with rows where y0 == y1 and
    taps outside the patch."""
    xint, wx, geom, patch = roi_inner.make_inputs(5008, cuda)
    geom = geom.clone()
    geom[:, 0, 1] = geom[:, 0, 0]  # y0 == y1
    geom[0::4, 1, 0] = -1.0  # y0 below the patch
    geom[1::4, 2, 1] = 32.0  # y1 above it
    geom[2::4, 3, 0], geom[2::4, 3, 1] = 40.7, -3.0  # neither tap
    args = (xint[:n], wx[:n], geom[:n], patch)
    if variant == "pair2" and n % 2:
        with pytest.raises(ValueError, match="even"):
            roi_inner.roi_inner(*args, variant)
        return
    before = cuda_build.launches("roi_inner_probe")
    got = roi_inner.roi_inner(*args, variant)
    assert cuda_build.launches("roi_inner_probe") == before + 1
    assert torch.equal(got, roi_inner.roi_inner_plain(*args, variant))


@pytest.mark.parametrize("variant", roi_dispatch.VARIANTS)
@pytest.mark.parametrize("n", [320, 96000], ids=["small", "tpu"])
def test_roi_dispatch_kernel_matches_plain(cuda, n, variant):
    """At 320 ROIs, and at the TPU script's 96000; a ROI outside the combos
    or its source raises."""
    args = roi_dispatch.make_inputs(variant, n, cuda)
    before = cuda_build.launches("roi_dispatch_probe")
    got = roi_dispatch.roi_dispatch(*args, variant)
    assert cuda_build.launches("roi_dispatch_probe") == before + 1
    assert torch.equal(got, roi_dispatch.roi_dispatch_plain(*args, variant))
    meta = args[0].clone()
    meta[3, 0, 1], meta[3, 0, 2] = 3, 1  # outside the combos
    if variant != "bare":
        with pytest.raises(ValueError, match="combos"):
            roi_dispatch.roi_dispatch(meta, *args[1:], variant)
        meta = args[0].clone()
        meta[5, 0, 1], meta[5, 0, 2], meta[5, 0, 3] = 1, 1, 15  # rows 120-135 of 128
        with pytest.raises(ValueError, match="outside its source"):
            roi_dispatch.roi_dispatch(meta, *args[1:], variant)
    xint = args[1].clone()
    xint[7, 0, 4] = 31  # x1 = 32, past the patch
    with pytest.raises(ValueError, match="outside its source"):
        roi_dispatch.roi_dispatch(args[0], xint, *args[2:], variant)


def dispatch_edge_case(ci, device):
    """Class ci at level ci (3: the top class) with rows where y0 == y1, taps
    outside the patch's py rows or past them inside 0-31, NaN and negative
    taps, and blend columns at and past the class's last column (as the CPU
    model's edge cases in tests/test_torch_probes.py)."""
    args = list(roi_dispatch.make_mixed_inputs(64, device, seed=2 + ci, kinds=[(ci, ci)]))
    py = roi_dispatch.CLASSES[ci][0]
    geom = args[3].clone()
    geom[:, 0, 1] = geom[:, 0, 0]
    geom[0::4, 1, 0] = -1.0
    geom[1::4, 2, 1] = float(py)
    geom[2::4, 3, 0], geom[2::4, 3, 1] = py + 8.7, -3.0
    geom[3::4, 4, 0], geom[3::4, 4, 1] = -0.5, float("nan")
    geom[:, 5, 0], geom[:, 5, 1] = py - 1.0, 0.0
    if py < 32:
        geom[:, 6, 0], geom[:, 6, 1] = py + 2.0, py - 1.0
    xint = args[1].clone()
    xint[0::3, 0, 0] = min(py, 30)
    xint[1::3, 0, 1] = min(py - 1, 30)
    xint[2::3, 0, 2] = 30
    args[1], args[3] = xint, geom
    return tuple(args)


@pytest.mark.parametrize("case", [
    "bare-16", "dispatch-16", "dispatch_small-16", "bare-5008", "dispatch-5008",
    "dispatch_small-5008", "mixed-16", "mixed-5008", "mixed-9600",
    "edge-0", "edge-1", "edge-2", "edge-3"])
def test_roi_dispatch_kernel_at_ragged_counts_and_edges(cuda, case):
    """ROI counts that do not fill the persistent grid evenly (33 ranges of
    4 streams a slice on an H100), the mixed classes (every kind of
    ``mixed_kinds()`` in turn, copies of one class issued during another's
    ROI), and each class's edge taps and columns."""
    kind, arg = case.split("-")
    if kind in roi_dispatch.VARIANTS:
        args, variant = roi_dispatch.make_inputs(kind, int(arg), cuda), kind
    elif kind == "mixed":
        args, variant = roi_dispatch.make_mixed_inputs(int(arg), cuda), "dispatch"
    else:
        args, variant = dispatch_edge_case(int(arg), cuda), "dispatch"
    before = cuda_build.launches("roi_dispatch_probe")
    got = roi_dispatch.roi_dispatch(*args, variant)
    assert cuda_build.launches("roi_dispatch_probe") == before + 1
    assert torch.equal(got, roi_dispatch.roi_dispatch_plain(*args, variant))


def coco_pyramid(gen, device, dtype=torch.float32):
    """The COCO config's P2-P5 at 1024², B = 2, C = 256."""
    from objectdetection_torch.config import COCO_CONFIG as cfg

    return [torch.randn(cases.BATCH, h, w, cfg.fpn_channels, generator=gen).to(device, dtype)
            for h, w in cfg.feature_shapes()[:4]]


@pytest.mark.parametrize("stage", ["box", "mask"])
def test_roi_align_kernels_at_the_coco_pyramid(cuda, stage):
    """The serving stage's ROIs (box: 1000 an image at 7x7, mask: 100 at
    14x14): the forward bit-equal in f32 and within its tolerance in bf16,
    the four int8 epilogues bit-equal; the training stage's (200 an image):
    the gradient within its bounds in f32 and bf16."""
    from objectdetection_torch.config import COCO_CONFIG as cfg

    gen = torch.Generator().manual_seed(2)
    image = tuple(cfg.image_shape[:2])
    r, crop = (1000, cfg.pool_shape) if stage == "box" else (100, cfg.mask_pool_shape)
    f32 = coco_pyramid(gen, cuda)
    f16 = [f.to(torch.bfloat16) for f in f32]
    boxes = cases.roi_boxes(gen, r, cuda)
    assert torch.equal(roi_align.batched_multilevel_roi_align(f32, boxes, image, crop),
                       roi_align.batched_multilevel_roi_align_plain(f32, boxes, image, crop))
    err = (roi_align.batched_multilevel_roi_align(f16, boxes, image, crop).float()
           - roi_align.batched_multilevel_roi_align_plain(f16, boxes, image, crop).float())
    assert float(err.abs().max()) <= roi_align.bf16_tolerance(f16)
    c = cfg.fpn_channels
    s_ch = (torch.rand(c, generator=gen) * 2 + 3.0).to(cuda)
    s_sc = torch.tensor(4.5, device=cuda)
    s_out = (torch.rand(*crop, c, generator=gen) * 2 + 3.0).to(cuda)
    q_ch = [quant.quantize_act(f, s_ch) for f in f32]
    q_sc = [quant.quantize_act(f, s_sc) for f in f32]
    for feats, kw in ((f16, dict(out_quant=s_out)), (q_ch, dict(out_quant=s_out, in_scale=s_ch)),
                      (q_sc, dict(out_quant=s_out, in_scale=s_sc)), (q_ch, dict(in_scale=s_ch))):
        got = roi_align.batched_multilevel_roi_align(feats, boxes, image, crop, **kw)
        want = roi_align.batched_multilevel_roi_align_plain(feats, boxes, image, crop, **kw)
        assert got.dtype == want.dtype and torch.equal(got, want), sorted(kw)
    train = cases.roi_boxes(gen, cfg.train_rois_per_image, cuda)
    shapes = [tuple(f.shape) for f in f32]
    g32 = torch.randn(cases.BATCH, cfg.train_rois_per_image, *crop, c, generator=gen).to(cuda)
    for dtype in (torch.float32, torch.bfloat16):
        backward_within_bounds(g32.to(dtype), train, shapes, image)


def out_of_map_case(pyramid, device):
    """(boxes, the f32 pyramid, the image shape) of boxes outside the map.
    small: a NaN box; image 0 left of and above P2 (the table index wraps
    to the end of the table); image 1 above its map (reads image 0's rows).
    coco, at the COCO pyramid: a NaN box, a box left of and above image 0's
    P2 whose table index wraps to the end of the table, a box above image
    1's P4 that reads image 0's rows."""
    from objectdetection_torch.config import COCO_CONFIG as cfg

    nan = float("nan")
    if pyramid == "small":
        gen = torch.Generator().manual_seed(8)
        boxes = torch.tensor([[[nan] * 4, [-0.2, -0.2, 0.1, 0.1], [0.1, 0.1, 0.5, 0.6]],
                              [[-0.6, 0.2, -0.3, 0.5], [-0.5, -0.7, -0.1, -0.2],
                               [0.0, 0.0, 1.0, 1.0]]], device=device)
        f32 = [torch.randn(2, s, s, 64, generator=gen).to(device) for s in (64, 32, 16, 8)]
        return boxes, f32, (256, 256), gen
    boxes = torch.tensor([
        [[nan, nan, nan, nan], [-0.05, -0.05, 0.02, 0.02]],  # NaN; P2, wraps to the end
        [[-0.3, 0.2, -0.1, 0.4], [0.2, 0.3, 0.6, 0.7]],  # above image 1's P4; inside
    ], device=device)
    image = tuple(cfg.image_shape[:2])
    f32 = coco_pyramid(torch.Generator().manual_seed(2), device)
    levels = roi_align.roi_levels(boxes, image[0] * image[1]).tolist()
    rows = roi_align._corners([f.shape[1:3] for f in f32], boxes, image, cfg.pool_shape)
    table = sum(f.shape[0] * f.shape[1] * f.shape[2] for f in f32)
    r01 = torch.stack([r for r, _ in rows]).reshape(4, 2, 2, -1)[:, 0, 1]
    assert levels[0][1] == 2 and bool((r01 >= table - cases.BATCH * 32 * 32).any())  # it wraps
    return boxes, f32, image, torch.Generator().manual_seed(12)


@pytest.mark.parametrize("pyramid", ["small", "coco"])
def test_roi_align_kernels_outside_the_map_match_plain(cuda, pyramid):
    """At a small pyramid and at the COCO one (out_of_map_case), at both
    crops: f32 bit-equal, bf16 within its tolerance, the int8 epilogue
    bit-equal, the gradient within its bounds in f32 and bf16, each with
    NaNs in the plain version's places."""
    boxes, f32, image, gen = out_of_map_case(pyramid, cuda)
    c = f32[0].shape[-1]
    shapes = [tuple(f.shape) for f in f32]
    bf = [f.to(torch.bfloat16) for f in f32]
    for crop in ((7, 7), (14, 14)):
        got = roi_align.batched_multilevel_roi_align(f32, boxes, image, crop)
        want = roi_align.batched_multilevel_roi_align_plain(f32, boxes, image, crop)
        assert same(got, want) and bool(torch.isnan(want[0, 0]).all())
        assert bool(torch.isfinite(want[:, 1:]).all() and torch.isfinite(want[1]).all())
        got = roi_align.batched_multilevel_roi_align(bf, boxes, image, crop)
        want = roi_align.batched_multilevel_roi_align_plain(bf, boxes, image, crop)
        fin = ~torch.isnan(want)
        assert torch.equal(torch.isnan(got), ~fin)
        assert float((got[fin].float() - want[fin].float()).abs().max()) <= \
            roi_align.bf16_tolerance(bf)
        s_out = (torch.rand(*crop, c, generator=gen) * 3 + 0.5).to(cuda)
        got = roi_align.batched_multilevel_roi_align(bf, boxes, image, crop, out_quant=s_out)
        want = roi_align.batched_multilevel_roi_align_plain(bf, boxes, image, crop,
                                                            out_quant=s_out)
        assert got.dtype == torch.int8 and torch.equal(got, want) and not bool(got[0, 0].any())
        g32 = torch.randn(*boxes.shape[:2], *crop, c, generator=gen).to(cuda)
        for dtype in (torch.float32, torch.bfloat16):
            got = roi_align.roi_align_backward(g32.to(dtype), boxes, shapes, image)
            want = roi_align.roi_align_backward_plain(g32.to(dtype), boxes, shapes, image)
            tol = roi_align.backward_tolerance(g32.to(dtype), boxes, shapes, image)
            for g, w, t in zip(got, want, tol):
                fin = ~torch.isnan(w)
                assert torch.equal(torch.isnan(g), ~fin)
                assert bool(((g.double() - w.double()).abs() <= t)[fin].all())
