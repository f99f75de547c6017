"""Seeded inputs of the port's hand-written kernels, shared by the card tests,
the timing tools (``tools/torch_<kernel>_time.py``) and ``chip_smoke.py``.

Each generator draws from the generator or seed it is given, so a case is
the same tensors wherever it is drawn (the timing tools print digests that
compare checkouts on them). Also the H100 peaks and the operation counts
that the tools' bounds are worked out against. Imports nothing but ``objectdetection_torch``, torch and
the standard library; the card tests load it by path:

    spec = importlib.util.spec_from_file_location("torch_kernel_cases", PATH)
"""

from __future__ import annotations

import torch

from objectdetection_torch import quant as Q

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s, f32, bf16 and int8
# tensor-core operations/s
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
PEAK_BF16 = 989e12
PEAK_INT8 = 1979e12
BATCH = 2  # images of every case below but I1's and E1's, which take theirs

# NMS (B2): (name, N, classes, class -1 padded rows, clusters, IoU threshold,
# budget, on the serving path): the serving path's two, the training shape
# (proposal_layer(training=True)), a sparse one whose budget stops the sweep
# after a few tiles, and the published RetinaNet's
NMS_CASES = (
    ("proposals", 6000, 1, 0, 12, 0.7, 1000, True),
    ("detections", 1000, 81, 24, 12, 0.3, 100, True),
    ("training", 6000, 1, 0, 12, 0.7, 2000, False),
    ("proposals-sparse", 6000, 1, 0, 600, 0.7, 1000, False),
    ("retinanet", 5000, 80, 0, 12, 0.5, 100, False),
)
# f32 operations of one IoU test: 2 min, 2 max, 6 sub, 3 mul, 1 add, 1 div,
# 2 compares
IOU_OPS = 17
# f32 operations of one anchor-GT test: the IoU with the GT's area from
# shared memory (4 min/max, 2 sub, 2 clamps, 1 mul, 1 add, 1 sub, 1 compare,
# 1 div), the running per-anchor max (1 compare, 1 select) and the per-GT
# candidate key (1 compare, 1 pack, 2 for the warp vote and select)
MATCH_OPS = 19
# the fused block (B4): the ResNet stages at 1024² (H, W, C3, C1) and their
# identity blocks in R101
STAGES = ((256, 256, 256, 64), (128, 128, 512, 128), (64, 64, 1024, 256), (32, 32, 2048, 512))
STAGE_BLOCKS = (2, 3, 22, 2)


def nms_inputs(gen, n: int, num_classes: int, pads: int, device, clusters: int = 12):
    """Score-sorted canonical boxes around ``clusters`` centres, with
    duplicates, zero-area and all-zero rows; class ids in [0, num_classes)
    and -1 on the padded tail."""
    b = BATCH
    centers = torch.rand(b, clusters, 2, generator=gen)
    pick = torch.randint(0, clusters, (b, n), generator=gen)
    ctr = torch.gather(centers, 1, pick[..., None].expand(b, n, 2))
    ctr = ctr + 0.03 * torch.randn(b, n, 2, generator=gen)
    size = 0.02 + 0.25 * torch.rand(b, n, 2, generator=gen)
    boxes = torch.cat([ctr - size / 2, ctr + size / 2], -1).clamp(0, 1)
    dup = torch.rand(b, n, generator=gen) < 0.05  # exact duplicates of a neighbour
    boxes[:, 1:][dup[:, 1:]] = boxes[:, :-1][dup[:, 1:]]
    flat = torch.rand(b, n, generator=gen) < 0.03  # zero-area rows
    boxes[..., 2][flat] = boxes[..., 0][flat]
    zero = torch.rand(b, n, generator=gen) < 0.03  # invalid (zeroed) rows
    boxes[zero] = 0.0
    cls = torch.randint(0, num_classes, (b, n), generator=gen, dtype=torch.int32)
    if pads:
        boxes[:, n - pads:] = 0.0
        cls[:, n - pads:] = -1
    return boxes.to(device).contiguous(), cls.to(device).contiguous()


def nms_case_inputs(device):
    """The inputs of NMS_CASES, drawn in order from one seeded generator."""
    gen = torch.Generator().manual_seed(1)
    return [nms_inputs(gen, n, k, pads, device, clusters)
            for _, n, k, pads, clusters, *_ in NMS_CASES]


def stop_row(table, tile: int, budget: int) -> int:
    """Rows the kernel resolves: up to the end of the tile where the survivor
    count reaches the budget."""
    rows = 0
    for b in range(table.shape[0]):
        live = torch.cumsum((table[b] != 0).any(-1).long(), 0)
        hit = torch.nonzero(live >= budget)
        end = table.shape[1] if hit.numel() == 0 else int(hit[0]) // tile * tile + tile
        rows = max(rows, min(end, table.shape[1]))
    return rows


def nms_ops(table, cls, budget_rows: int) -> float:
    """f32 operations of the IoU tests greedy NMS needs on this data: each
    row up to the stop tested against the same-class survivors before it."""
    total = 0
    for b in range(table.shape[0]):
        alive = (table[b, :budget_rows] != 0).any(-1)
        c = cls[b, :budget_rows].long()
        for k in torch.unique(c).tolist():
            m = c == k
            before = torch.cumsum(alive[m].long(), 0) - alive[m].long()
            total += int(before.sum())
    return total * IOU_OPS


def roi_boxes(gen, r: int, device):
    """ROIAlign's boxes (B1, B1'): random boxes plus zero, flat (clipped),
    full-image and tiny boxes, [BATCH, r, 4]."""
    y1x1 = torch.rand(BATCH, r, 2, generator=gen) * 0.8
    hw = torch.rand(BATCH, r, 2, generator=gen) ** 2 * 0.6
    boxes = torch.cat([y1x1, (y1x1 + hw).clamp(max=1.0)], -1)
    q = r // 10
    boxes[:, :q] = 0.0  # zero boxes (padding rows)
    boxes[:, q:2 * q, 2] = boxes[:, q:2 * q, 0]  # flat boxes
    boxes[:, 2 * q:2 * q + 5] = torch.tensor([0.0, 0.0, 1.0, 1.0])  # full image
    tiny = boxes[:, 3 * q:4 * q]
    tiny[..., 2:] = tiny[..., :2] + 1e-3
    return boxes.to(device).contiguous()


def match_inputs(gen, anchors, g: int, device):
    """Anchor matching's GT boxes (B3) [BATCH, G, 4] of realistic sizes with
    padding rows, duplicated boxes (ties) and a share of invalid rows that
    still hold boxes."""
    b = BATCH
    y1x1 = torch.rand(b, g, 2, generator=gen) * 0.8
    hw = 0.02 + torch.rand(b, g, 2, generator=gen) ** 2 * 0.5
    gt = torch.cat([y1x1, (y1x1 + hw).clamp(max=1.0)], -1)
    gt[:, 1] = gt[:, 0]  # a duplicated GT: anchor argmax ties go low
    gt[:, 2] = anchors[1000].cpu()  # an anchor exactly
    valid = torch.rand(b, g, generator=gen) > 0.2
    valid[:, :3] = True
    valid[:, g - 10:] = False
    gt[:, g - 10:] = 0.0  # zero padding rows
    return gt.to(device).contiguous(), valid.to(device).contiguous()


def block_case(gen, h: int, w: int, c3: int, c1: int, device):
    """The fused block's arguments (B4): a random int8 stream and kernels with
    every affine nonzero (tests/test_fused_block.py's make_case at a stage's
    shape, B=BATCH); the kernels HWIO views of OIHW storage, as the backbone
    passes them."""
    k = lambda *s: torch.randint(-127, 128, s, generator=gen, dtype=torch.int8).to(
        device).permute(3, 2, 0, 1).contiguous().permute(2, 3, 1, 0)
    v = lambda n, lo=0.5, hi=1.5: (lo + (hi - lo) * torch.rand(n, generator=gen)).to(device)
    f = lambda x: torch.tensor(x, dtype=torch.float32, device=device)
    x8 = torch.randint(-128, 128, (BATCH, h, w, c3), generator=gen, dtype=torch.int8).to(device)
    return (x8, f(3.0), k(1, 1, c3, c1), k(3, 3, c1, c1), k(1, 1, c1, c3),
            v(c1) * 0.01, v(c1) * 0.002, v(c3) * 0.01,
            v(c1, -0.2, 0.2), v(c1, -0.2, 0.2), v(c3, -0.2, 0.2),
            (v(c1), v(c1, -0.3, 0.3)), (v(c1), v(c1, -0.3, 0.3)), (v(c3), v(c3, -0.3, 0.3)),
            f(4.0), f(5.0), f(6.0))


def int8_conv_case(dev, b, h, w, cin, cout, k, stride, epilogue, pc=True,
                   dtype=torch.bfloat16, padding=None, seed=0):
    """Seeded operands of one int8 conv (I1) on ``dev``: (x8, k8, post, bias,
    the keyword arguments of ``int8_conv_fused`` for ``epilogue``, one of
    ``int8_conv.EPILOGUES``); sums of ~1 after ``post``, BatchNorm near 1,
    activation scales per channel (scalars without ``pc``) that clip a few
    codes."""
    g = torch.Generator(device=dev).manual_seed(seed)
    rand = lambda *shape: torch.rand(*shape, generator=g, device=dev)
    randn = lambda *shape: torch.randn(*shape, generator=g, device=dev)
    codes = lambda lo, *shape: torch.randint(lo, 128, shape, generator=g, device=dev,
                                             dtype=torch.int8)
    x8, k8 = codes(-128, b, h, w, cin), codes(-127, cout, cin, k, k)
    post = rand(cout) * 2 / (128 * 64 * (k * k * cin) ** 0.5)
    bias = randn(cout) * 0.1
    scale = lambda: (rand(cout) + 0.5) * 3 if pc else torch.tensor(2.0, device=dev)
    kw = dict(stride=stride, padding=padding, dtype=dtype)
    if epilogue not in ("bias", "relu_q"):
        kw["bn"] = (rand(cout) + 0.5, randn(cout) * 0.1)
    if epilogue not in ("bias", "proj"):
        kw["relu"] = True
    if epilogue in ("relu_q", "ab", "c_proj", "c_id"):
        kw["out_scale"] = scale()
    t, bo, l, r = Q.conv_pads(padding, h, w, k, stride)
    ho, wo = (h + t + bo - k) // stride + 1, (w + l + r - k) // stride + 1
    if epilogue == "c_proj":
        kw["residual"] = (randn(b, ho, wo, cout) * 2).to(dtype)
    if epilogue == "c_id":
        kw["residual"] = (codes(-128, b, ho, wo, cout), scale())
    return x8, k8, post, bias, kw


def epilogue_case(site, dtype, device, gen, vec_dtype=None):
    """The float conv's epilogue (E1) at ``site`` (``resnet_fpn_sites``): a
    conv output without its bias and the epilogue's operands, (y, bias, bn,
    residual, coarse, relu); the per-channel vectors in ``vec_dtype``
    (default f32, cast by the wrapper)."""
    _, b, c, h, w, kind, _ = site
    cl = lambda t: t.to(dtype).contiguous(memory_format=torch.channels_last)
    vec = lambda t: t.to(vec_dtype or torch.float32)
    y = cl(4 * torch.randn(b, c, h, w, device=device, generator=gen))
    bias = vec(torch.randn(c, device=device, generator=gen))
    bn = None
    if kind.startswith("bn"):
        bn = (vec(0.5 + torch.rand(c, device=device, generator=gen)),
              vec(0.1 * torch.randn(c, device=device, generator=gen)))
    residual = coarse = None
    if kind == "bn_res_relu":
        residual = cl(2 * torch.randn(b, c, h, w, device=device, generator=gen))
    if kind == "top_down":
        coarse = cl(2 * torch.randn(b, c, h // 2, w // 2, device=device, generator=gen))
    return y, bias, bn, residual, coarse, kind in ("bn_relu", "bn_res_relu")


def epilogue_sites(batch: int) -> dict:
    """E1's sites of R-101's two pyramids by (B, C, H, W, kind), each with
    one of its sites and its calls in a P2-P6 and in a P3-P7 call."""
    from objectdetection_torch.models import backbone as bb
    from objectdetection_torch.ops import conv_epilogue

    sites = {}
    for levels in (bb.P2_P6, bb.P3_P7):
        for site in conv_epilogue.resnet_fpn_sites(batch, levels=levels):
            calls = sites.setdefault(site[1:6], [site, {}])[1]
            calls[levels] = calls.get(levels, 0) + site[-1]
    return sites


def seeded_fpn(levels, device, seed: int = 0):
    """R-101 ``ResNetFPN`` at ``levels`` in bf16 on ``device``: He-normal conv
    kernels, biases 0.1·N(0, 1), every BatchNorm drawn (the residual
    branches' last scales in [0.05, 0.15], as chip_smoke.py's
    ``randomized_params`` draws them)."""
    from objectdetection_torch.models import backbone as bb

    gen = torch.Generator().manual_seed(seed)
    fpn = bb.ResNetFPN("resnet101", 256, levels=levels)
    for name, mod in fpn.named_modules():
        if isinstance(mod, bb.Conv):
            fan_in = mod.weight[0].numel()
            mod.weight.data = torch.randn(mod.weight.shape, generator=gen) * (2 / fan_in) ** 0.5
            mod.bias.data = 0.1 * torch.randn(mod.bias.shape, generator=gen)
        elif isinstance(mod, bb.FrozenBatchNorm):
            n = mod.scale.numel()
            lo, hi = (0.05, 0.15) if name.endswith("2c") else (0.5, 1.5)
            mod.scale.copy_(lo + (hi - lo) * torch.rand(n, generator=gen))
            mod.bias.copy_(0.1 * torch.randn(n, generator=gen))
            mod.mean.copy_(0.1 * torch.randn(n, generator=gen))
            mod.var.copy_(0.5 + 1.5 * torch.rand(n, generator=gen))
    return fpn.to(device=device, dtype=torch.bfloat16)
