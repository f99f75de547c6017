"""The fused int8 conv kernel (``csrc/int8_conv.cu``) against its plain version.

Marked ``cuda``; without a card (or without nvcc) they skip. Run on a machine
with an NVIDIA Hopper GPU, from the repository root, with
``python -m pytest --noconftest -m cuda tests/test_torch_int8_conv.py``.

Held bit-equal to ``int8_conv_fused_plain`` (which runs ``torch._int_mm`` on
the card) on every conv shape and epilogue of the int8 Mask R-CNN call
(``int8_conv.mask_rcnn_convs``: each stage's projection, 1×1 at stride 1
and 2, 3×3 and conv 2c with both residuals, the FPN laterals and P-convs,
the RPN's shared conv and its 18-wide head, the mask head's 14×14 convs) at
batch 2, per tensor and per channel; one stage-2 identity block at batch 96;
f32 compute, the int8 stem's 3 input channels, explicit asymmetric pads. One
launch a call; what the kernel cannot take (f16, an odd N, a misshapen
residual or kernel) raises. A whole int8 call at 256² makes 125 launches and
no plain conv call, and equals the plain path.
"""

import sys
from pathlib import Path

import pytest
import torch

from objectdetection_torch import quant as Q
from objectdetection_torch.ops import cuda_build
from objectdetection_torch.ops import int8_conv as ic

pytestmark = pytest.mark.cuda

# the seeded operands the timing tool shares: x8, k8, post, bias and the
# epilogue's arguments
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import torch_kernel_cases as cases  # noqa: E402
make_case = cases.int8_conv_case


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    try:
        cuda_build.nvcc_path()
    except RuntimeError:
        pytest.skip("no nvcc")
    return torch.device("cuda", 0)


def check(dev, *shape, **over):
    x8, k8, post, bias, kw = make_case(dev, *shape, **over)
    before = cuda_build.launches("int8_conv")
    got = ic.int8_conv_fused(x8, k8, post, bias, **kw)
    assert cuda_build.launches("int8_conv") == before + 1
    want = ic.int8_conv_fused_plain(x8, k8, post, bias, **kw)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    bad = int((got != want).sum())
    assert bad == 0, f"{shape} {over}: {bad} of {got.numel()} outputs differ"
    return got


# every distinct conv of one int8 call at batch 2 (the mask head on 200 ROIs)
CELL = sorted({c[1:9] for c in ic.mask_rcnn_convs(2)})


@pytest.mark.parametrize("pc", [True, False])
@pytest.mark.parametrize("shape", CELL, ids=lambda s: "x".join(map(str, s[:7])) + "-" + s[7])
def test_kernel_matches_plain_on_the_cell_convs(cuda, shape, pc):
    got = check(cuda, *shape, pc=pc)
    if got.dtype == torch.int8:
        assert len(torch.unique(got)) > 100  # codes spread, a few clip


def test_kernel_matches_plain_on_a_stage2_block_at_batch_96(cuda):
    for shape in ((96, 256, 256, 256, 64, 1, 1, "ab"), (96, 256, 256, 64, 64, 3, 1, "ab"),
                  (96, 256, 256, 64, 256, 1, 1, "c_id")):
        check(cuda, *shape)
        torch.cuda.empty_cache()


@pytest.mark.parametrize("shape,over", [
    ((2, 64, 64, 256, 64, 1, 1, "c_id"), dict(dtype=torch.float32)),
    ((2, 33, 31, 128, 64, 3, 2, "c_proj"), dict(dtype=torch.float32)),
    ((2, 1024, 1024, 3, 64, 7, 2, "bias"), dict(padding=3, pc=False)),  # the int8 stem
    ((3, 37, 29, 80, 96, 3, 1, "ab"), dict(padding=((1, 2), (0, 1)))),
    ((1, 5, 3, 2048, 2048, 1, 2, "ab"), {}),  # fewer pixels than a tile
])
def test_kernel_matches_plain_elsewhere(cuda, shape, over):
    check(cuda, *shape, **over)


def test_wrapper_refuses_what_the_kernel_cannot_take(cuda):
    x8, k8, post, bias, kw = make_case(cuda, 1, 8, 8, 64, 64, 1, 1, "c_id")
    with pytest.raises(ValueError):
        ic.int8_conv_fused(x8, k8, post, bias, **{**kw, "dtype": torch.float16})
    with pytest.raises(ValueError):
        ic.int8_conv_fused(x8, k8, post, bias, **{**kw, "residual": (x8[:, :4], kw["residual"][1])})
    with pytest.raises(ValueError):
        ic.int8_conv_fused(x8, k8[:, :32], post, bias, **kw)
    with pytest.raises(ValueError):  # the kernel writes pairs of channels
        ic.int8_conv_fused(x8, k8[:63], post[:63], bias[:63], stride=1)


def test_int8_call_goes_through_the_kernel(cuda, monkeypatch):
    from objectdetection_torch import convert, detector
    from objectdetection_torch.config import COCO_CONFIG

    cfg = COCO_CONFIG.replace(image_shape=(256, 256, 3), image_min_dim=256, image_max_dim=256,
                              quantized_inference=True, per_channel_acts=True)
    params = convert.init_params(cfg, torch.Generator().manual_seed(0), cuda)
    g = torch.Generator().manual_seed(1)
    images = (torch.rand(2, 256, 256, 3, generator=g) * 255 - 120).to(cuda)
    windows = torch.tensor([[0.0, 0.0, 256.0, 256.0]] * 2, device=cuda)
    frozen = detector.freeze_weights(detector.calibrate_variables(params, images, cfg))
    with torch.inference_mode():
        before = cuda_build.launches("int8_conv")
        plain_convs = []
        real = Q.int8_conv
        monkeypatch.setattr(Q, "int8_conv", lambda *a, **k: plain_convs.append(1) or real(*a, **k))
        got = detector.forward_inference(frozen, images, windows, cfg)
        torch.cuda.synchronize()
        convs = ic.mask_rcnn_convs(2, 256, 22, cfg.detection_post_nms_instances)
        assert cuda_build.launches("int8_conv") - before == sum(c[-1] for c in convs) == 125
        assert not plain_convs  # no im2col, no torch._int_mm from a conv
        monkeypatch.setattr(ic, "int8_conv_fused", ic.int8_conv_fused_plain)
        want = detector.forward_inference(frozen, images, windows, cfg)
    for a, b in zip(got, want):
        assert a is None or torch.equal(a, b)
