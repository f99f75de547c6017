"""Kernel tests that need the card: each CUDA kernel against its plain version.

Marked ``cuda``; without a card (or without nvcc) they skip. Run on a machine
with an NVIDIA Hopper GPU, from the repository root, with
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py`` (the suite's
conftest imports JAX, which the port and these tests do not need).

NMS survivor tables are held exactly; ROIAlign is held bit-equal in f32 and
within ``roi_align.bf16_tolerance`` in bf16 (the kernel rounds once where the
plain version rounds after every op).
"""

import numpy as np
import pytest
import torch

from objectdetection_torch.ops import nms, roi_align

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

