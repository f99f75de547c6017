"""The launch seam of the port's hand-written kernels (``ops/cuda_build.py``), on the CPU.

A Python callback (``ctypes.CFUNCTYPE``) stands in for a library's C entry:
its symbol is resolved and typed once, a nonzero status raises and names the
symbol (a wrapper's own status check first), every launch is tallied under
the kernel's name and the plain routes tally nothing; the device rule sends
a CUDA tensor to the kernel, a CPU one to the plain version and raises for
anything else, in every wrapper.
"""

import contextlib
import ctypes
import types

import pytest
import torch

from objectdetection_torch.ops import (anchor_match, conv_epilogue, cuda_build, fused_block,
                                       int8_conv, nms, roi_align)
from objectdetection_torch.probes import patch_dma, roi_dispatch, roi_inner

PROTO = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_int, ctypes.c_void_p)


class FakeLib:
    """A loaded library whose only symbol is ``entry``; counts lookups."""

    def __init__(self, status=0):
        self.lookups = 0
        self.calls = []

        def entry(x, stream):
            self.calls.append((x, stream))
            return status

        self._entry = PROTO(entry)

    def __getattr__(self, name):
        if name != "entry":
            raise AttributeError(name)
        self.lookups += 1
        return self._entry


@pytest.fixture
def fake(monkeypatch):
    """Install a FakeLib under ``fake`` (or ``fake_bad``, status 3), and a
    card-less stand-in for the CUDA device context and its current stream."""
    libs = {"fake": FakeLib(), "fake_bad": FakeLib(status=3)}
    for name, lib in libs.items():
        monkeypatch.setitem(cuda_build._libs, name, lib)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))
    return libs


def test_entry_is_resolved_and_typed_once(fake):
    entry = cuda_build.Entry("fake", "entry", [ctypes.c_int], name="fake_kernel")
    for x in (1, 2, 3):
        entry.launch("cuda:0", x)
    assert fake["fake"].lookups == 1
    assert entry.fn.argtypes == [ctypes.c_int, ctypes.c_void_p]  # the stream appended
    assert entry.fn.restype is ctypes.c_int
    assert [x for x, _ in fake["fake"].calls] == [1, 2, 3]


def test_nonzero_status_raises_naming_the_entry(fake):
    entry = cuda_build.Entry("fake_bad", "entry", [ctypes.c_int], name="bad_kernel")
    before = cuda_build.launches("bad_kernel")
    with pytest.raises(RuntimeError, match="entry: CUDA error 3 at launch"):
        entry.launch("cuda:0", 7)
    assert cuda_build.launches("bad_kernel") == before  # a failed launch is not tallied


def test_a_wrappers_own_status_check_comes_first(fake):
    def own(status):
        if status == 3:
            raise ValueError("three: the wrapper's own message")

    entry = cuda_build.Entry("fake_bad", "entry", [ctypes.c_int])
    with pytest.raises(ValueError, match="the wrapper's own message"):
        entry.launch("cuda:0", 1, on_status=own)


def test_tally_counts_one_per_launch_by_kernel_name(fake):
    a = cuda_build.Entry("fake", "entry", [ctypes.c_int], name="tally_a")
    b = cuda_build.Entry("fake", "entry", [ctypes.c_int], name="tally_b")
    before = cuda_build.launches()
    a.launch("cuda:0", 1)
    a.launch("cuda:0", 2)
    b.launch("cuda:0", 3)
    after = cuda_build.launches()
    assert after["tally_a"] - before.get("tally_a", 0) == 2
    assert after["tally_b"] - before.get("tally_b", 0) == 1
    assert cuda_build.launches("tally_a", "tally_b") == after["tally_a"] + after["tally_b"]
    after["tally_a"] = -1  # a copy: the tally itself is untouched
    assert cuda_build.launches("tally_a") >= 2


def test_host_entry_takes_no_stream(monkeypatch):
    proto = ctypes.CFUNCTYPE(ctypes.c_int64, ctypes.c_int64)
    monkeypatch.setitem(cuda_build._libs, "fake_host",
                        types.SimpleNamespace(host=proto(lambda x: 2 * x)))
    fn = cuda_build.Entry("fake_host", "host", [ctypes.c_int64], result=ctypes.c_int64,
                          stream=False).fn
    assert fn.argtypes == [ctypes.c_int64] and fn.restype is ctypes.c_int64
    assert fn(21) == 42


def test_device_rule():
    assert cuda_build.takes_kernel(torch.zeros(1), "x") is False
    card = types.SimpleNamespace(device=torch.device("cuda", 0))
    assert cuda_build.takes_kernel(card, "x") is True
    with pytest.raises(ValueError, match="x: unsupported device meta"):
        cuda_build.takes_kernel(torch.zeros(1, device="meta"), "x")


def meta(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype, device="meta")


# every wrapper with the device rule, called on meta tensors: (name, call)
WRAPPERS = {
    "nms": lambda: nms.suppress(meta(1, 8, 4), meta(1, 8, dtype=torch.int32), 0.5),
    "anchor_match": lambda: anchor_match.anchor_match(meta(8, 4), meta(1, 2, 4),
                                                      meta(1, 2, dtype=torch.bool)),
    "roi_align": lambda: roi_align.batched_multilevel_roi_align(
        [meta(1, 8, 8, 8)] * 4, meta(1, 2, 4), (32, 32), (7, 7)),
    "roi_align_backward": lambda: roi_align.roi_align_backward(
        meta(1, 2, 7, 7, 8), meta(1, 2, 4), [(1, 8, 8, 8)] * 4, (32, 32)),
    "int8_conv": lambda: int8_conv.int8_conv_fused(
        meta(1, 4, 4, 16, dtype=torch.int8), meta(8, 16, 1, 1, dtype=torch.int8), meta(8),
        meta(8)),
    "conv_epilogue": lambda: conv_epilogue.conv_epilogue(meta(1, 8, 4, 4), meta(8)),
    "fused_block": lambda: fused_block.fused_identity_block_int8(
        meta(1, 8, 8, 64, dtype=torch.int8), *[None] * 16),
    "patch_dma": lambda: patch_dma.patch_dma(meta(1, 8, 8, 8, dtype=torch.bfloat16),
                                             *[meta(1, dtype=torch.int32)] * 3, 4),
    "roi_inner": lambda: roi_inner.roi_inner(*[meta(1)] * 4),
    "roi_dispatch": lambda: roi_dispatch.roi_dispatch(*[meta(1)] * 6),
}


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_every_wrapper_takes_the_device_rule(name):
    before = cuda_build.launches()
    with pytest.raises(ValueError, match=f"{name}: unsupported device meta"):
        WRAPPERS[name]()
    assert cuda_build.launches() == before


def test_plain_routes_tally_nothing():
    """NMS, anchor matching and ROIAlign with its gradient on CPU tensors:
    the plain versions run, and no kernel is tallied."""
    g = torch.Generator().manual_seed(0)
    before = cuda_build.launches()
    boxes = torch.rand(1, 16, 4, generator=g).sort(-1).values
    nms.suppress(boxes, torch.zeros(1, 16, dtype=torch.int32), 0.5)
    anchor_match.anchor_match(boxes[0], boxes[:, :3], torch.ones(1, 3, dtype=torch.bool))
    feats = [torch.randn(1, s, s, 8, generator=g) for s in (16, 8, 4, 2)]
    roi_align.batched_multilevel_roi_align(feats, boxes[:, :4], (64, 64), (7, 7))
    grads = roi_align.roi_align_backward(torch.randn(1, 4, 7, 7, 8, generator=g), boxes[:, :4],
                                         [tuple(f.shape) for f in feats], (64, 64))
    assert [tuple(t.shape) for t in grads] == [tuple(f.shape) for f in feats]
    assert cuda_build.launches() == before
