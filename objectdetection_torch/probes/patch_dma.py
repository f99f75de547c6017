"""P1: how fast can per-ROI feature patches be copied into on-chip memory?

Port of ``benchmarks/patch_dma_probe.py`` (``make_probe``: a Pallas kernel
that DMAs one [p, p, C] bf16 patch per ROI from a [32, 256, 256, 256] source,
double-buffered, and sums patch[0, 0, :] in f32). The kernel is
``csrc/roi_probes.cu`` ``patch_dma_probe``: every patch lands whole in shared
memory through ``cp.async``, and the output, the f32 sum over ROIs of
``src[i, y, 8·xq, :]``, is a checksum of that copy.

    python -m objectdetection_torch.probes.patch_dma [--iters 8]
    python -m objectdetection_torch.probes.patch_dma --device cpu --n 64 --images 2

prints, per (ROIs, patch) case of the TPU script, ``ms``, ``M dma/s`` and
``GB/s`` of patch bytes, and the card's name and power limit.

The kernel sums in ROI order within a block and the blocks' partial sums in
block order; the plain version sums in f64 and rounds once. Both lie within
(n-1)·2^-24·Σ|x| of the exact sum per channel, so they are held within
:func:`tolerance`, n·2^-24·Σ|x|.
"""

from __future__ import annotations

import argparse
import ctypes
import sys
from typing import Optional, Sequence

import torch

from objectdetection_torch.ops import cuda_build
from objectdetection_torch.probes import common

_PROBE = cuda_build.Entry("roi_probes", "patch_dma_probe", [ctypes.c_void_p] + [
    ctypes.c_int] * 4 + [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
    + [ctypes.c_void_p] * 3)

SRC_SHAPE = (32, 256, 256, 256)  # the TPU script's [b, h, w, c] source
CASES = ((32000, 16), (32000, 8), (3200, 32))  # (ROIs, patch)
BLOCKS_PER_SM = 3  # 64 KB of stages each


def make_source(shape=SRC_SHAPE, device="cuda", seed: int = 0) -> torch.Tensor:
    """Seeded standard-normal source, bf16 [b, h, w, c]."""
    dev = common.resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)


def make_indices(n: int, patch: int, shape=SRC_SHAPE, device="cuda", seed: int = 0):
    """Random patch origins as the TPU script draws them: image in [0, b),
    row in [0, h - p), column / 8 in [0, (w - p) // 8), int32 [n] each."""
    dev = common.resolve_device(device)
    b, h, w, _ = shape
    gen = torch.Generator().manual_seed(seed + patch * n)
    draw = lambda hi: torch.randint(0, hi, (n,), generator=gen, dtype=torch.int32).to(dev)
    return draw(b), draw(h - patch), draw((w - patch) // 8)


def _check(src, i, y, xq, patch):
    if src.dim() != 4 or src.dtype != torch.bfloat16:
        raise ValueError(f"patch_dma: src must be bf16 [b, h, w, c], got {src.dtype} "
                         f"{tuple(src.shape)}")
    n = i.shape[0]
    for t in (i, y, xq):
        if t.shape != (n,) or t.dtype != torch.int32 or t.device != src.device:
            raise ValueError("patch_dma: i, y, xq must be int32 [n] on the source's device")
    _, h, w, c = src.shape
    if not (1 <= patch <= min(h, w)):
        raise ValueError(f"patch_dma: patch {patch} does not fit the source")


def patch_dma_plain(src, i, y, xq, patch: int) -> torch.Tensor:
    """[1, C] f32: Σ_n src[i_n, y_n, 8·xq_n, :], summed in f64, rounded once."""
    _check(src, i, y, xq, patch)
    b, h, w, _ = src.shape
    ok = (i >= 0) & (i < b) & (y >= 0) & (y <= h - patch) & (xq >= 0) & (8 * xq <= w - patch)
    if not bool(ok.all()):
        raise ValueError("patch_dma: a patch lies outside the source")
    rows = src[i.long(), y.long(), 8 * xq.long()]
    return rows.double().sum(0).float()[None]


def _launch(src, i, y, xq, patch: int):
    """Launch the kernel; returns (out, error flag) without reading the
    flag, so that nothing waits for the card."""
    _check(src, i, y, xq, patch)
    b, h, w, c = src.shape
    n = i.shape[0]
    if c % 8 or c > 256 or patch * c * 2 > 32768:
        raise ValueError(f"patch_dma kernel: unsupported channels {c} or patch {patch}")
    dev = src.device
    out = torch.zeros((1, c), dtype=torch.float32, device=dev)
    err = torch.zeros(1, dtype=torch.int32, device=dev)
    if n == 0:
        return out, err
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = min(n, BLOCKS_PER_SM * sms)
    partial = torch.empty((blocks, c), dtype=torch.float32, device=dev)
    src = src.contiguous()
    _PROBE.launch(dev, src.data_ptr(), b, h, w, c, i.data_ptr(), y.data_ptr(), xq.data_ptr(), n,
                  patch, blocks, partial.data_ptr(), out.data_ptr(), err.data_ptr())
    return out, err


def _kernel(src, i, y, xq, patch: int) -> torch.Tensor:
    out, err = _launch(src, i, y, xq, patch)
    common.check_flag(err, "patch_dma", ["a patch lies outside the source"])
    return out


def patch_dma(src, i, y, xq, patch: int) -> torch.Tensor:
    """P1 on the source's device: the kernel on the card, the plain version
    for a CPU tensor."""
    if not cuda_build.takes_kernel(src, "patch_dma"):
        return patch_dma_plain(src, i, y, xq, patch)
    return _kernel(src, i, y, xq, patch)


def tolerance(src, i, y, xq) -> torch.Tensor:
    """Stated bound on |kernel - plain| per channel: n·2^-24·Σ|x|."""
    rows = src[i.long(), y.long(), 8 * xq.long()].double()
    return (i.shape[0] * 2.0**-24 * rows.abs().sum(0))[None]


def library_call(src, i, y, xq, patch: int) -> torch.Tensor:
    """The same sum by one PyTorch advanced-index gather of every patch into
    [n, p, p, C] (the same patch bytes moved), then ``[:, 0, 0]`` summed.
    A yardstick of speed only; the port never calls it."""
    ar = torch.arange(patch, device=src.device)
    ys = (y.long()[:, None] + ar)[:, :, None]
    xs = (8 * xq.long()[:, None] + ar)[:, None, :]
    patches = src[i.long()[:, None, None], ys, xs]
    return patches[:, 0, 0].float().sum(0)[None]


def patch_bytes(n: int, patch: int, c: int) -> int:
    """Bytes the probe's work moves: every patch read once (n·p²·C·2), the
    three index vectors, the [C] f32 output."""
    return n * patch * patch * c * 2 + 3 * n * 4 + c * 4


def run(iters: int = 8, n: Optional[int] = None, images: int = SRC_SHAPE[0],
        device="cuda", out=None):
    """The TPU script's run: each case timed over ``iters`` calls after a
    warm-up; ``n`` caps the ROIs per case, ``images`` the source's batch.
    Returns [(n, patch, ms)]."""
    dev = common.resolve_device(device)
    shape = (images, *SRC_SHAPE[1:])
    src = make_source(shape, dev)
    results = []
    for n_rois, patch in CASES:
        n_rois = n_rois if n is None else min(n, n_rois)
        i, y, xq = make_indices(n_rois, patch, shape, dev)
        call = lambda: patch_dma(src, i, y, xq, patch)
        if dev.type == "cuda":
            call()  # checks these inputs once; the timed launches skip the flag's sync
            call = lambda: _launch(src, i, y, xq, patch)
        ms, _ = common.timed(call, iters, dev)
        dt = ms / 1e3
        byt = n_rois * patch * patch * shape[3] * 2
        print(f"rois={n_rois:6d} patch={patch:3d}  {ms:8.2f} ms  {n_rois / dt / 1e6:6.2f} M dma/s  "
              f"{byt / dt / 1e9:6.1f} GB/s", file=out or sys.stdout, flush=True)
        results.append((n_rois, patch, ms))
    return results


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--n", type=int, default=None, help="cap on the ROIs of each case")
    ap.add_argument("--images", type=int, default=SRC_SHAPE[0], help="the source's batch")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = common.resolve_device(args.device)
    print(f"device: {common.card() if dev.type == 'cuda' else 'cpu (plain version)'}",
          flush=True)
    run(args.iters, args.n, args.images, dev)


if __name__ == "__main__":
    main()
