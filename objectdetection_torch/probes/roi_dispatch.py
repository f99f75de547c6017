"""P3: what does ROIAlign's per-ROI dispatch over (level, patch class) cost?

Port of ``benchmarks/roi_dispatch_probe.py`` (``kernel``): P2's body (7
x-blends with x1 = x0 + 1, then ``wy @ xb``) behind the Pallas ROIAlign
kernel's per-ROI dispatch. The top class (32, 32) blends a resident [32,
32·C] bf16 patch; a small class (py, px) copies its int8 [py, px·C] patch
from ``feats[img, 8·yq:, x0·C:]``, casts it to bf16 (exact) and blends the
same way. The kernel is ``csrc/roi_probes.cu`` ``roi_dispatch_probe``; the
variants are the TPU script's:

- ``bare``: every ROI takes the top class; ``meta`` is not read;
- ``dispatch``: the dispatch, every ROI of the top class (``bare``'s output);
- ``dispatch_small``: every ROI of class (16, 16) at level 1, patches copied.

Deviations, stated: the port accepts the top class at any level and a small
class only at the (level, class) pairs of the TPU script's ``_combos``; it
raises on any other pair, where the TPU kernel issues no DMA and reads a
stale buffer. Columns past the copied patch (x0 >= px - 1) read zero, where
the TPU kernel reads stale VMEM (JAX's interpreter with
``uninitialized_memory="zero"`` on one grid step reads zero too). The
``next`` table of the TPU kernel only schedules its DMAs and is not an input.

    python -m objectdetection_torch.probes.roi_dispatch [--variant dispatch] [--n 96000]
    python -m objectdetection_torch.probes.roi_dispatch --device cpu --n 64

prints ``ms for N ROIs (us/ROI)`` and the card's name and power limit.
Bit-equal to the plain version, for P2's reason.
"""

from __future__ import annotations

import argparse
import ctypes
import sys
from typing import Optional, Sequence

import numpy as np
import torch

from objectdetection_torch.ops import cuda_build
from objectdetection_torch.probes import common
from objectdetection_torch.probes.roi_inner import C, CHUNK, POOL, blend_matmul

_PROBE = cuda_build.Entry("roi_probes", "roi_dispatch_probe", [ctypes.c_void_p] * 6 + [
    ctypes.c_int] * 3 + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])

K = 16
CLASSES = ((8, 8), (16, 16), (24, 24), (32, 32))  # (py, px); the last is the top class
TOP_CI = len(CLASSES) - 1
LEVELS = ((256, 256), (128, 128), (64, 64), (32, 32))
VARIANTS = ("bare", "dispatch", "dispatch_small")
IMAGES = 4
FEAT_HW = 128  # feats [IMAGES, 128, 128·C] int8


def combos():
    """The TPU script's (level, class, py, px) pairs of the small classes:
    every class whose patch the level holds, at the top level only class 0."""
    for lvl, (h, w) in enumerate(LEVELS):
        top = lvl == len(LEVELS) - 1
        for ci, (py, px) in enumerate(CLASSES[:-1]):
            if py > h or px > w or (top and ci != 0):
                continue
            yield lvl, ci, py, px


def make_inputs(variant: str = "dispatch", n: int = 96000, device="cuda"):
    """The TPU script's inputs from ``RandomState(0)``: meta [n, 1, 8]
    (image, level, class, yq, x0), xint [n, 1, 7] int32, wx [n, 1, 7] f32,
    geom [n, 7, 4] f32, patch_top [32, 32·C] bf16, feats [4, 128, 128·C] int8;
    n rounded down to a multiple of K."""
    dev = common.resolve_device(device)
    n = (n // K) * K
    rng = np.random.RandomState(0)
    li, cls = (1, 1) if variant == "dispatch_small" else (3, TOP_CI)
    meta = np.zeros((n, 1, 8), np.int32)
    meta[:, 0, 0] = np.arange(n) * IMAGES // n
    meta[:, 0, 1] = li
    meta[:, 0, 2] = cls
    meta[:, 0, 3] = rng.randint(0, (FEAT_HW - 16) // 8, n)
    meta[:, 0, 4] = rng.randint(0, FEAT_HW - 17, n)
    py = CLASSES[cls][0]
    xint = rng.randint(0, 30, (n, 1, POOL))
    wx = rng.rand(n, 1, POOL)
    geom = np.stack([rng.randint(0, py - 1, (n, POOL)), rng.randint(0, py - 1, (n, POOL)),
                     rng.rand(n, POOL), rng.rand(n, POOL)], axis=-1)
    patch_top = rng.rand(32, 32 * C)
    feats = rng.randint(-128, 127, (IMAGES, FEAT_HW, FEAT_HW * C))
    return (torch.from_numpy(meta).to(dev), torch.from_numpy(xint.astype(np.int32)).to(dev),
            torch.from_numpy(wx.astype(np.float32)).to(dev),
            torch.from_numpy(geom.astype(np.float32)).to(dev),
            torch.from_numpy(patch_top.astype(np.float32)).to(torch.bfloat16).to(dev),
            torch.from_numpy(feats.astype(np.int8)).to(dev))


def mixed_kinds():
    """The top class (at the top level) and every (level, class) pair of
    ``combos()``: 11 kinds."""
    return [(len(LEVELS) - 1, TOP_CI)] + [(lvl, ci) for lvl, ci, _, _ in combos()]


def make_mixed_inputs(n: int = 9600, device="cuda", seed: int = 1, kinds=None):
    """Inputs of the ``dispatch`` variants whose ROIs cycle through
    ``kinds``, (level, class) pairs (default ``mixed_kinds()``), each patch
    inside ``feats``; the taps y0, y1 are drawn from 0-31 whatever the
    class, so a small class also has taps past its rows. Shapes as
    ``make_inputs``; n rounded down to a multiple of K."""
    dev = common.resolve_device(device)
    n = (n // K) * K
    rng = np.random.RandomState(seed)
    kinds = list(kinds or mixed_kinds())
    kind = np.arange(n) % len(kinds)
    py = np.array([CLASSES[ci][0] for _, ci in kinds])[kind]
    meta = np.zeros((n, 1, 8), np.int32)
    meta[:, 0, 0] = np.arange(n) * IMAGES // n
    meta[:, 0, 1] = np.array([lvl for lvl, _ in kinds])[kind]
    meta[:, 0, 2] = np.array([ci for _, ci in kinds])[kind]
    meta[:, 0, 3] = rng.randint(0, (FEAT_HW - py) // 8 + 1)
    meta[:, 0, 4] = rng.randint(0, FEAT_HW - py + 1)
    xint = rng.randint(0, 31, (n, 1, POOL))
    wx = rng.rand(n, 1, POOL)
    geom = np.stack([rng.randint(0, 32, (n, POOL)), rng.randint(0, 32, (n, POOL)),
                     rng.rand(n, POOL), rng.rand(n, POOL)], axis=-1)
    patch_top = rng.rand(32, 32 * C)
    feats = rng.randint(-128, 128, (IMAGES, FEAT_HW, FEAT_HW * C))
    return (torch.from_numpy(meta).to(dev), torch.from_numpy(xint.astype(np.int32)).to(dev),
            torch.from_numpy(wx.astype(np.float32)).to(dev),
            torch.from_numpy(geom.astype(np.float32)).to(dev),
            torch.from_numpy(patch_top.astype(np.float32)).to(torch.bfloat16).to(dev),
            torch.from_numpy(feats.astype(np.int8)).to(dev))


def _check(meta, xint, wx, geom, patch_top, feats, variant):
    if variant not in VARIANTS:
        raise ValueError(f"roi_dispatch: unknown variant {variant!r}")
    n = meta.shape[0]
    want = ((meta, (n, 1, 8), torch.int32), (xint, (n, 1, POOL), torch.int32),
            (wx, (n, 1, POOL), torch.float32), (geom, (n, POOL, 4), torch.float32),
            (patch_top, (32, 32 * C), torch.bfloat16))
    for t, shape, dtype in want:
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != meta.device:
            raise ValueError(f"roi_dispatch: want {dtype} {shape} on one device, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if feats.dim() != 3 or feats.dtype != torch.int8 or feats.shape[2] % C or \
            feats.device != meta.device:
        raise ValueError(f"roi_dispatch: feats must be int8 [b, h, w·{C}] on the same device")


def roi_dispatch_plain(meta, xint, wx, geom, patch_top, feats,
                       variant: str = "dispatch") -> torch.Tensor:
    """[n, 7, 7·C] bf16, ``CHUNK`` ROIs at a time."""
    _check(meta, xint, wx, geom, patch_top, feats, variant)
    n = meta.shape[0]
    dev = meta.device
    b, fh, fwc = feats.shape
    fw = fwc // C
    f4 = feats.reshape(b, fh, fw, C)
    x0 = xint[:, 0].long()
    if not bool(((x0 >= 0) & (x0 + 1 < 32)).all()):
        raise ValueError("roi_dispatch: a blend column lies outside the patch")
    m = meta[:, 0].long()
    cls = torch.full((n,), TOP_CI, device=dev) if variant == "bare" else m[:, 2]
    small = cls != TOP_CI
    ok = torch.zeros_like(small)
    for lvl, ci, _, _ in combos():
        ok |= (m[:, 1] == lvl) & (cls == ci)
    if bool((small & ~ok).any()):
        raise ValueError("roi_dispatch: a (level, class) pair outside the TPU's combos")
    py_all = 8 * (cls + 1)
    inside = (m[:, 0] >= 0) & (m[:, 0] < b) & (m[:, 3] >= 0) & (8 * m[:, 3] + py_all <= fh) \
        & (m[:, 4] >= 0) & (m[:, 4] + py_all <= fw)
    if bool((small & ~inside).any()):
        raise ValueError("roi_dispatch: a patch lies outside feats")
    out = torch.empty((n, POOL, POOL * C), dtype=torch.bfloat16, device=dev)
    top_src = patch_top.float().reshape(1, 32, 32, C)
    cols = torch.arange(32, device=dev)
    for ci, (py, px) in enumerate(CLASSES):
        for s in range(0, n, CHUNK):
            rows = torch.nonzero(cls[s:s + CHUNK] == ci).flatten() + s
            if rows.numel() == 0:
                continue
            if ci == TOP_CI:
                src = top_src
            else:  # the copied int8 patch; columns past it read zero
                mm = m[rows]
                r = torch.arange(py, device=dev)
                img = mm[:, 0, None, None]
                y = 8 * mm[:, 3, None, None] + r[None, :, None]
                x = mm[:, 4, None, None] + cols.clamp(max=px - 1)[None, None, :]
                src = f4[img, y, x].float() * (cols < px)[None, None, :, None]
            out[rows] = blend_matmul(src, x0[rows], x0[rows] + 1, wx[rows, 0], geom[rows],
                                     "full")
    return out


def _launch(meta, xint, wx, geom, patch_top, feats, variant: str):
    """Launch the kernel; returns (out, error flag) without reading the
    flag, so that nothing waits for the card."""
    _check(meta, xint, wx, geom, patch_top, feats, variant)
    n = meta.shape[0]
    dev = meta.device
    out = torch.empty((n, POOL, POOL * C), dtype=torch.bfloat16, device=dev)
    err = torch.zeros(1, dtype=torch.int32, device=dev)
    if n == 0:
        return out, err
    b, fh, fwc = feats.shape
    args = [t.contiguous() for t in (meta, xint, wx, geom, patch_top, feats)]
    _PROBE.launch(dev, *[t.data_ptr() for t in args], b, fh, fwc // C, out.data_ptr(), n,
                  int(variant == "bare"), err.data_ptr())
    return out, err


def _kernel(meta, xint, wx, geom, patch_top, feats, variant: str) -> torch.Tensor:
    out, err = _launch(meta, xint, wx, geom, patch_top, feats, variant)
    common.check_flag(err, "roi_dispatch", [
        "a (level, class) pair outside the TPU's combos",
        "a patch or blend column lies outside its source"])
    return out


def roi_dispatch(meta, xint, wx, geom, patch_top, feats, variant: str = "dispatch"):
    """P3 on the inputs' device: the kernel on the card, the plain version
    for CPU tensors."""
    if not cuda_build.takes_kernel(meta, "roi_dispatch"):
        return roi_dispatch_plain(meta, xint, wx, geom, patch_top, feats, variant)
    return _kernel(meta, xint, wx, geom, patch_top, feats, variant)


def work(n: int, variant: str, feats_bytes: int):
    """(bytes, f32 operations, bf16 tensor-core operations) of the function
    on n ROIs of one class: output written once, inputs read once (feats,
    16.8 MB, once for the small classes: it sits in L2, so the patch copies
    are not device-memory traffic); 3 f32 operations per xb value, 2·7·py per
    output column for the product."""
    py = 16 if variant == "dispatch_small" else 32
    byt = n * POOL * POOL * C * 2 + n * (8 + POOL + POOL + 4 * POOL) * 4 + 32 * 32 * C * 2
    if variant == "dispatch_small":
        byt += feats_bytes
    return byt, 3 * n * py * POOL * C, n * 2 * POOL * py * POOL * C


def run(variant: str = "dispatch", n: int = 96000, iters: int = 8, device="cuda",
        out=None):
    """The TPU script's run of one variant; returns ms per call."""
    dev = common.resolve_device(device)
    inputs = make_inputs(variant, n, dev)
    n = inputs[0].shape[0]
    call = lambda: roi_dispatch(*inputs, variant)
    if dev.type == "cuda":
        call()  # checks these inputs once; the timed launches skip the flag's sync
        call = lambda: _launch(*inputs, variant)
    ms, _ = common.timed(call, iters, dev)
    print(f"{variant:15s} {ms:8.2f} ms for {n} ROIs ({1000.0 * ms / n:6.3f} us/ROI)", file=out,
          flush=True)
    return ms


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", default="dispatch", choices=VARIANTS)
    ap.add_argument("--n", type=int, default=96000)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = common.resolve_device(args.device)
    print(f"device: {common.card() if dev.type == 'cuda' else 'cpu (plain version)'}",
          flush=True)
    run(args.variant, args.n, args.iters, dev)


if __name__ == "__main__":
    main()
