"""The float conv's epilogue (``ops/conv_epilogue.py``, ``csrc/conv_epilogue.cu``)
and its call sites in ``ResNetFPN``, on the CPU and on the card.

The plain version equals the unfused chain it replaces, bit for bit; a model
of the kernel's walk (its 16-byte vectors, the channel group a thread keeps,
the coarser level read at (h >> 1, w >> 1), a rounding after every step)
equals the plain version; ResNetFPN in inference, on its CPU path and routed
through the wrapper as on the card, equals its forward as written before the
pass, and under gradients its outputs and gradients are unchanged; the
program's counters read R-101's 112 float convs a call for both pyramids.

On the card (marked ``cuda``; they skip without a card or nvcc): the kernel
bit-equal to the plain version, in place and one launch a call, at every
distinct site of ``resnet_fpn_sites`` of both R-101 pyramids at B = 2, in
bf16 and f32 (the inputs of ``tools/torch_kernel_cases.py``, which the
timing tool ``tools/torch_conv_epilogue_time.py`` shares); a whole seeded
bf16 R-101 ``ResNetFPN`` at 1024², B = 2, in inference (112 launches)
bit-equal to the chain before the pass, for both pyramids. Run them with
``python -m pytest --noconftest -m cuda tests/test_torch_conv_epilogue.py``.
"""

import math
import sys
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from objectdetection_torch import metrics
from objectdetection_torch.models import backbone as bb
from objectdetection_torch.ops import conv_epilogue as ce
from objectdetection_torch.ops import cuda_build

DTYPES = (torch.bfloat16, torch.float32)
CASES = [(d, k, c) for d in DTYPES for k in ce.KINDS for c in (64, 256, 2048)]
THREADS = 256  # csrc/conv_epilogue.cu NT


def ids(case):
    dtype, kind, c = case
    return f"{str(dtype)[6:]}-{kind}-{c}"


def channels_last(t, dtype):
    return t.to(dtype).contiguous(memory_format=torch.channels_last)


def frozen_bn(c, g, small=False):
    bn = bb.FrozenBatchNorm(c)
    lo, hi = (0.05, 0.15) if small else (0.5, 1.5)
    bn.scale.copy_(lo + (hi - lo) * torch.rand(c, generator=g))
    bn.bias.copy_(0.1 * torch.randn(c, generator=g))
    bn.mean.copy_(0.1 * torch.randn(c, generator=g))
    bn.var.copy_(0.5 + torch.rand(c, generator=g))
    return bn


def case(dtype, kind, c, seed=0, b=2, h=6, w=4):
    """A conv output without its bias, and the epilogue's operands for ``kind``
    (``conv_epilogue.KINDS``): (y, bias, FrozenBatchNorm or None, residual,
    coarse, relu)."""
    g = torch.Generator().manual_seed(seed)
    y = channels_last(4 * torch.randn(b, c, h, w, generator=g), dtype)
    bias = torch.randn(c, generator=g)
    bn = frozen_bn(c, g) if kind.startswith("bn") else None
    residual = coarse = None
    if kind == "bn_res_relu":
        residual = channels_last(2 * torch.randn(b, c, h, w, generator=g), dtype)
    if kind == "top_down":
        coarse = channels_last(2 * torch.randn(b, c, h // 2, w // 2, generator=g), dtype)
    return y, bias, bn, residual, coarse, kind in ("bn_relu", "bn_res_relu")


def unfused_chain(y, bias, bn, residual, coarse, relu):
    """The ops the pass replaces, each apart: F.conv2d's bias as cuDNN adds it
    (an ``add_`` after the conv), FrozenBatchNorm, the residual add or the
    FPN's ``upsample2x_nearest(m) + lateral``, F.relu."""
    y = y.add_(bias.to(y.dtype).view(1, -1, 1, 1))
    if bn is not None:
        y = bn(y)
    if residual is not None:
        y = y + residual
    if coarse is not None:
        y = bb.upsample2x_nearest(coarse) + y
    return F.relu(y) if relu else y


def grid(n, groups, resident=132 * 4):
    """The kernel's grid (csrc/conv_epilogue.cu ``launch``): the blocks the
    card holds at once or fewer, rounded down to a multiple of groups /
    gcd(groups, 256)."""
    m = groups // math.gcd(groups, THREADS)
    return max(min(-(-n // THREADS), resident) // m * m, m)


def kernel_model(y, bias, bn, residual, coarse, relu, blocks=None):
    """The kernel's walk on the CPU. y's memory (NHWC) as 16-byte vectors
    (8 bf16 or 4 f32 channels of one pixel); thread t of the grid takes
    vectors t, t + S, t + 2S, ... (S = blocks × 256) and keeps the channel
    group t mod groups it loaded its bias, inv and shift for; the coarser
    level's vector is the same group's at (h >> 1, w >> 1); every step in
    f32, rounded to y's dtype; ReLU keeps NaN."""
    dtype = y.dtype
    b, c, h, w = y.shape
    v = 16 // y.element_size()
    groups = c // v
    vectors = lambda t: t.permute(0, 2, 3, 1).reshape(-1, v).float()
    flat = vectors(y)
    n = flat.shape[0]
    stride = (blocks or grid(n, groups)) * THREADS
    j = torch.arange(n)
    g = (j % stride) % groups  # the thread's channel group
    assert stride % groups == 0 and torch.equal(g, j % groups)
    lanes = g[:, None] * v + torch.arange(v)
    per_channel = lambda t: t.to(dtype).float()[lanes]
    rnd = lambda t: t.to(dtype).float()
    x = rnd(flat + per_channel(bias))
    if bn is not None:
        inv, shift = bn
        x = rnd(rnd(x * per_channel(inv)) + per_channel(shift))
    if residual is not None:
        x = rnd(x + vectors(residual)[j])
    if coarse is not None:
        p = j // groups
        col, row, img = p % w, (p // w) % h, p // (w * h)
        at = ((img * (h // 2) + (row >> 1)) * (w // 2) + (col >> 1)) * groups + g
        x = rnd(x + vectors(coarse)[at])
    if relu:
        x = torch.where(torch.isnan(x), x, torch.clamp_min(x, 0.0))
    out = x.to(dtype).reshape(b, h, w, c).permute(0, 3, 1, 2)
    return out.contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("case_", CASES, ids=ids)
def test_plain_equals_unfused_chain(case_):
    y, bias, bn, residual, coarse, relu = case(*case_)
    want = unfused_chain(y.clone(), bias, bn, residual, coarse, relu)
    folded = bn.folded() if bn is not None else None
    got = ce.conv_epilogue(y.clone(), bias, folded, residual, coarse, relu)  # plain on the CPU
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, want)
    assert torch.equal(ce.conv_epilogue_plain(y.clone(), bias, folded, residual, coarse, relu),
                       want)
    assert len(torch.unique(got)) > 50  # the values spread


@pytest.mark.parametrize("case_", CASES, ids=ids)
def test_kernel_model_equals_plain(case_):
    y, bias, bn, residual, coarse, relu = case(*case_, seed=3)
    folded = bn.folded() if bn is not None else None
    want = ce.conv_epilogue_plain(y.clone(), bias, folded, residual, coarse, relu)
    v = 16 // y.element_size()
    n, groups = y.numel() // v, y.shape[1] // v
    for blocks in (None, grid(n, groups, resident=3)):  # the card's grid, and a few blocks
        got = kernel_model(y, bias, folded, residual, coarse, relu, blocks)  # many trips each
        assert torch.equal(got, want), blocks


def test_grid_keeps_each_thread_on_one_channel_group():
    for groups in (8, 16, 32, 64, 128, 256, 512, 90, 3):
        for n in (1, 100, 10 ** 5, 10 ** 8):
            blocks = grid(n, groups)
            assert blocks >= 1 and blocks * THREADS % groups == 0
            assert blocks <= max(132 * 4, groups)


def random_fpn(model, levels, seed=0):
    """A ResNetFPN with seeded weights and BatchNorms (the residual branches'
    last scales small, as the benchmark draws them)."""
    g = torch.Generator().manual_seed(seed)
    fpn = bb.ResNetFPN(model, 256, levels=levels)
    for name, mod in fpn.named_modules():
        if isinstance(mod, bb.Conv):
            fan_in = mod.weight[0].numel()
            mod.weight.data = torch.randn(mod.weight.shape, generator=g) * (2 / fan_in) ** 0.5
            mod.bias.data = 0.1 * torch.randn(mod.bias.shape, generator=g)
        elif isinstance(mod, bb.FrozenBatchNorm):
            mod.load_state_dict(frozen_bn(mod.scale.numel(), g, small=name.endswith("2c"))
                                .state_dict())
    return fpn


def reference(fpn, x):
    """ResNetFPN's float forward as it was written before the epilogue pass:
    every conv with its bias, then each op apart."""
    r = fpn.resnet
    x = bb.max_pool_same(F.relu(r.bn_conv1(r.conv1(x))))
    outs = []
    for names in r.stages:
        for name in names:
            blk = r._modules[name]
            cn, bnn = blk.names
            m = blk._modules
            shortcut = m[bnn + "1"](m[cn + "1"](x)) if blk.projection else x
            y = F.relu(m[bnn + "2a"](m[cn + "2a"](x)))
            y = F.relu(m[bnn + "2b"](m[cn + "2b"](y)))
            y = m[bnn + "2c"](m[cn + "2c"](y))
            x = F.relu(y + shortcut)
        outs.append(x)
    c2, c3, c4, c5 = outs
    up = bb.upsample2x_nearest
    m5 = fpn.fpn_c5p5(c5)
    m4 = up(m5) + fpn.fpn_c4p4(c4)
    m3 = up(m4) + fpn.fpn_c3p3(c3)
    if fpn.levels == bb.P3_P7:
        p6 = fpn.fpn_p6(c5)
        return fpn.fpn_p3(m3), fpn.fpn_p4(m4), fpn.fpn_p5(m5), p6, fpn.fpn_p7(F.relu(p6))
    m2 = up(m3) + fpn.fpn_c2p2(c2)
    p5 = fpn.fpn_p5(m5)
    return fpn.fpn_p2(m2), fpn.fpn_p3(m3), fpn.fpn_p4(m4), p5, p5[:, :, ::2, ::2]


def images(dtype, size=64, seed=1):
    g = torch.Generator().manual_seed(seed)
    return channels_last(20 * torch.randn(2, 3, size, size, generator=g), dtype)


@pytest.fixture
def cudnn_bias(monkeypatch):
    """F.conv2d with its bias added after the conv, as PyTorch does behind
    cuDNN on the card (the CPU's conv adds it inside, rounding once in bf16)."""
    conv2d = F.conv2d

    def after(x, w, bias=None, *args, **kw):
        y = conv2d(x, w, None, *args, **kw)
        return y if bias is None else y.add_(bias.view(1, -1, 1, 1))

    monkeypatch.setattr(F, "conv2d", after)


PYRAMIDS = [(levels, dtype) for levels in (bb.P2_P6, bb.P3_P7) for dtype in DTYPES]


def pyramid_ids(p):
    return f"P{p[0][0]}-P{p[0][-1]}-{str(p[1])[6:]}"


@pytest.mark.parametrize("pyramid", PYRAMIDS, ids=pyramid_ids)
def test_inference_equals_forward_before_the_pass(pyramid, monkeypatch, cudnn_bias):
    levels, dtype = pyramid
    fpn = random_fpn("resnet50", levels)
    x = images(dtype)
    with torch.no_grad():
        want = reference(fpn, x)
        cpu_path = fpn(x)
        monkeypatch.setattr(bb, "one_pass", lambda t: True)  # the card's route, plain
        with metrics.collect("cpu") as rec:
            card_route = fpn(x)
    assert len(want) == len(cpu_path) == len(card_route) == 5
    for got_cpu, got_card, w in zip(cpu_path, card_route, want):
        assert got_cpu.dtype == w.dtype == dtype and got_cpu.shape == w.shape
        assert torch.equal(got_cpu, w) and torch.equal(got_card, w)
    assert rec.counters == {"backbone.float_convs": 61, "conv_epilogue.launches": 61}  # R50


def image_none(hw=64, seed=6):
    """A batch of one as the server makes it, ``image[None]`` of a numpy image
    (a zero batch stride), NHWC f32."""
    import numpy as np

    image = np.random.RandomState(seed).uniform(-60, 60, (hw, hw, 3)).astype(np.float32)
    x = torch.as_tensor(image[None])
    assert x.stride(0) == 0
    return x


def test_batch_of_one_takes_the_pass_from_a_channels_last_entry(monkeypatch, cudnn_bias):
    """``image[None]`` passes as channels_last contiguous, yet cuDNN answers
    it in NCHW memory; ``channels_last`` gives it the format's strides, and
    routed as on the card every epilogue then runs as the pass."""
    fpn = random_fpn("resnet50", bb.P2_P6)
    nchw = image_none().permute(0, 3, 1, 2).to(torch.bfloat16)
    assert nchw.is_contiguous(memory_format=torch.channels_last)  # strides that mislead
    x = bb.channels_last(nchw)
    assert x.stride() == (64 * 64 * 3, 1, 64 * 3, 3) and torch.equal(x, nchw)
    assert bb.channels_last(x) is x  # no copy where the strides are right
    monkeypatch.setattr(bb, "one_pass", lambda t: True)
    with torch.no_grad(), metrics.collect("cpu") as rec:
        got = fpn(x)
    with torch.no_grad():
        want = reference(fpn, nchw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(g.is_contiguous(memory_format=torch.channels_last) for g in got[:4])
    assert rec.counters == {"backbone.float_convs": 61, "conv_epilogue.launches": 61}  # R50


@pytest.mark.parametrize("family", ["mask_rcnn", "retinanet"])
def test_models_feed_a_batch_of_one_to_the_pass(family, monkeypatch, cudnn_bias):
    """Mask R-CNN's ``extract`` and RetinaNet's forward hand the backbone an
    ``image[None]`` batch the pass takes: 61 launches for R50's float convs,
    where the wrapper would refuse an NCHW conv output."""
    from objectdetection_torch import config as tconfig
    from objectdetection_torch.convert import init_params, init_retinanet_params
    from objectdetection_torch.models import mask_rcnn, retinanet

    gen = torch.Generator().manual_seed(0)
    if family == "mask_rcnn":
        cfg = tconfig.SHAPES_CONFIG.replace(image_shape=(64, 64, 3), image_min_dim=64,
                                            image_max_dim=64, backbone="resnet50")
        params = init_params(cfg, gen, device="cpu")
        with torch.device("meta"):
            model = mask_rcnn.MaskRCNN(cfg).eval()
        model.load_state_dict(params, assign=True)
        run = lambda x: model.extract(x)[0]
        hw = 64
    else:
        cfg = tconfig.RetinaNetConfig(image_shape=(128, 128, 3), image_min_dim=128,
                                      image_max_dim=128, backbone="resnet50",
                                      compute_dtype="float32")
        params = init_retinanet_params(cfg, gen, device="cpu")
        run = lambda x: retinanet.apply(params, x, cfg)
        hw = 128
    x = image_none(hw)
    with torch.no_grad():
        want = run(x)
    monkeypatch.setattr(bb, "one_pass", lambda t: True)
    with torch.no_grad(), metrics.collect("cpu") as rec:
        got = run(x)
    assert rec.counters["conv_epilogue.launches"] == rec.counters["backbone.float_convs"] == 61
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("levels", [bb.P2_P6, bb.P3_P7], ids=["P2-P6", "P3-P7"])
def test_training_outputs_and_gradients_unchanged(levels, remat):
    fpn = random_fpn("resnet50", levels, seed=2)
    fpn.resnet.remat = remat
    params = [p for p in fpn.parameters()]
    for p in params:
        p.requires_grad_(True)
    results = []
    for forward in (fpn, lambda x: reference(fpn, x)):
        x = images(torch.float32, seed=5).requires_grad_(True)
        outs = forward(x)
        weights = [torch.randn(o.shape, generator=torch.Generator().manual_seed(i))
                   for i, o in enumerate(outs)]
        loss = sum((o * w).sum() for o, w in zip(outs, weights))
        results.append((outs, torch.autograd.grad(loss, [x] + params)))
    (outs, grads), (want_outs, want_grads) = results
    assert all(torch.equal(a, b) for a, b in zip(outs, want_outs))
    assert all(torch.equal(a, b) for a, b in zip(grads, want_grads))
    assert float(grads[0].abs().sum()) > 0


def kind_of(bn, residual, coarse, relu):
    if coarse is not None:
        return "top_down"
    if bn is None:
        return "bias"
    return "bn_res_relu" if residual is not None else "bn_relu" if relu else "bn"


@pytest.mark.parametrize("levels", [bb.P2_P6, bb.P3_P7], ids=["P2-P6", "P3-P7"])
def test_counters_read_112_float_convs_a_call_for_r101(levels, monkeypatch):
    fpn = bb.ResNetFPN("resnet101", 256, levels=levels)
    x = images(torch.float32)
    with torch.no_grad(), metrics.collect("cpu") as rec:
        fpn(x)
        fpn(x)
    assert rec.counters["backbone.float_convs"] == 2 * 112
    assert "conv_epilogue.launches" not in rec.counters  # the CPU's path: no pass
    calls = []
    real = ce.conv_epilogue

    def record(y, bias, bn=None, residual=None, coarse=None, relu=False):
        calls.append((tuple(y.shape), kind_of(bn, residual, coarse, relu)))
        return real(y, bias, bn, residual, coarse, relu)

    monkeypatch.setattr(bb, "one_pass", lambda t: True)
    monkeypatch.setattr(ce, "conv_epilogue", record)
    with torch.no_grad(), metrics.collect("cpu") as rec:
        fpn(x)
    assert rec.counters == {"backbone.float_convs": 112, "conv_epilogue.launches": 112}
    sites = ce.resnet_fpn_sites(2, 64, levels=levels)
    want = sorted((s[1:5], s[5]) for s in sites for _ in range(s[-1]))
    assert sorted(calls) == want and len(calls) == 112
    with torch.enable_grad(), metrics.collect("cpu") as rec:
        fpn(x)
    assert rec.counters == {}  # gradients on: the training path counts nothing


def test_int8_network_counts_no_float_conv():
    quant = bb.Quant(per_channel=True)
    fpn = bb.ResNetFPN("resnet50", 256, quant=quant)
    assert all(not isinstance(m, bb.Conv) for n, m in fpn.named_modules()
               if n.startswith("resnet."))
    x = images(torch.float32)
    from objectdetection_torch import quant as Q

    with torch.no_grad(), Q.calibration(), metrics.collect("cpu") as rec:
        fpn(x)
    assert "backbone.float_convs" not in rec.counters


BAD = {
    "nchw": lambda: (torch.randn(2, 64, 4, 4), {}),
    "c12": lambda: (channels_last(torch.randn(2, 12, 4, 4), torch.float32), {}),
    "f16": lambda: (channels_last(torch.randn(2, 64, 4, 4), torch.float16), {}),
    "residual-shape": lambda: (channels_last(torch.randn(2, 64, 4, 4), torch.float32),
                               {"residual": channels_last(torch.randn(2, 64, 2, 2),
                                                          torch.float32)}),
    "residual-nchw": lambda: (channels_last(torch.randn(2, 64, 4, 4), torch.float32),
                              {"residual": torch.randn(2, 64, 4, 4)}),
    "coarse-odd": lambda: (channels_last(torch.randn(2, 64, 5, 4), torch.float32),
                           {"coarse": channels_last(torch.randn(2, 64, 2, 2), torch.float32)}),
    "both": lambda: (channels_last(torch.randn(2, 64, 4, 4), torch.float32),
                     {"residual": channels_last(torch.randn(2, 64, 4, 4), torch.float32),
                      "coarse": channels_last(torch.randn(2, 64, 2, 2), torch.float32)}),
}


@pytest.mark.parametrize("bad", sorted(BAD))
def test_wrapper_raises_on_what_the_kernel_does_not_take(bad):
    y, kw = BAD[bad]()
    with pytest.raises(ValueError, match="conv_epilogue"):
        ce.conv_epilogue(y, torch.zeros(y.shape[1]), **kw)


def test_sites_count_and_bytes():
    for levels in (bb.P2_P6, bb.P3_P7):
        sites = ce.resnet_fpn_sites(96, levels=levels)
        assert sum(s[-1] for s in sites) == 112
        assert {s[5] for s in sites} == set(ce.KINDS)
    sites = ce.resnet_fpn_sites(96)
    y = sum(s[1] * s[2] * s[3] * s[4] * 2 * s[-1] for s in sites)
    assert 71.5e9 < y < 71.6e9  # bf16 outputs a batch-96 call writes
    moved = sum(ce.site_bytes(s) * s[-1] for s in sites)
    assert 180.0e9 < moved < 180.1e9  # 53.7 ms at 3.35 TB/s


sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import torch_kernel_cases as cases  # noqa: E402
SITES = [site for site, _ in cases.epilogue_sites(2).values()]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    try:
        cuda_build.nvcc_path()
    except RuntimeError:
        pytest.skip("no nvcc")
    return torch.device("cuda", 0)


def same(a, b):
    """Bit-equal values with NaNs in the same places."""
    nan_a, nan_b = torch.isnan(a), torch.isnan(b)
    return torch.equal(nan_a, nan_b) and torch.equal(a[~nan_a], b[~nan_b])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("site", range(len(SITES)), ids=[
    f"{s[0].replace(' ', '_')}-{s[3]}x{s[4]}x{s[2]}" for s in SITES])
def test_kernel_equals_plain_at_every_site_on_the_card(cuda, site, dtype):
    gen = torch.Generator(device=cuda).manual_seed(15 + site)
    y, bias, bn, residual, coarse, relu = cases.epilogue_case(SITES[site], dtype, cuda, gen)
    want = ce.conv_epilogue_plain(y.clone(), bias, bn, residual, coarse, relu)
    before = cuda_build.launches("conv_epilogue")
    got = ce.conv_epilogue(y, bias, bn, residual, coarse, relu)
    assert cuda_build.launches("conv_epilogue") == before + 1
    assert got.data_ptr() == y.data_ptr()  # in place
    assert same(got, want), f"{int((got != want).sum())} of {got.numel()} outputs differ"


@pytest.mark.cuda
@pytest.mark.parametrize("levels", [bb.P2_P6, bb.P3_P7], ids=["P2-P6", "P3-P7"])
def test_r101_inference_equals_the_chain_on_the_card(cuda, levels):
    gen = torch.Generator(device=cuda).manual_seed(15)
    x = (20 * torch.randn(2, 3, 1024, 1024, device=cuda, generator=gen)).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    fpn = cases.seeded_fpn(levels, cuda)
    with torch.enable_grad():  # the chain before the pass: nothing requires a gradient
        chain = fpn(x)
    before = cuda_build.launches("conv_epilogue")
    with torch.inference_mode():
        fused = fpn(x)
    assert cuda_build.launches("conv_epilogue") - before == 112
    for i, (a, b) in enumerate(zip(fused, chain)):
        assert same(a, b), f"level {i}: {int((a != b).sum())} of {a.numel()} values differ"
