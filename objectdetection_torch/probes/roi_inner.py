"""P2: what does ROIAlign's per-ROI blend and matmul cost with the patch on chip?

Port of ``benchmarks/roi_inner_probe.py`` (``kernel``): per ROI, 7 x-blends
of one resident [32, 32·C] bf16 patch into xb [32, 7·C] bf16, then
``wy [7, 32] @ xb`` accumulated in f32 and rounded to bf16. The kernel is
``csrc/roi_probes.cu`` ``roi_inner_probe``; the variants are the TPU
script's:

- ``full``: columns x0, x1 of each blend from ``xint``;
- ``static_x``: x0 = 4q, x1 = 4q + 1;
- ``wide2c``: x1 = x0 + 1;
- ``nomatmul``: out = xb rows 0-6;
- ``noblend``: the matmul on an xb the blend never wrote. The TPU kernel
  reads a scratch it never writes; here xb is zero, so out is 0;
- ``pair2``: the TPU kernel's two-ROI product: out[j-1] = out[j] = ``full``'s
  out[j] for odd j.

    python -m objectdetection_torch.probes.roi_inner [--variant full] [--n 96000] [--iters 8]
    python -m objectdetection_torch.probes.roi_inner --device cpu --n 64

prints ``ms for N ROIs (us/ROI)`` and the card's name and power limit.

Exactness: xb = bf16(f32((1 - w)·v0 + w·v1)); wy has at most two nonzero
bf16 entries per row and each bf16 product is exact in f32, so every output
is one rounding of a two-term sum whatever the order of the sum: the kernel
is bit-equal to the plain version.
"""

from __future__ import annotations

import argparse
import ctypes
import sys
from typing import Optional, Sequence

import numpy as np
import torch

from objectdetection_torch.ops import cuda_build, roi_align
from objectdetection_torch.probes import common

launches = 0  # kernel launches (never counts the plain version)

C = 256
PY = 32  # resident patch rows
PX = 32  # resident patch columns
POOL = 7
K = 16  # ROIs per TPU grid step: n is a multiple
VARIANTS = ("full", "static_x", "wide2c", "nomatmul", "noblend", "pair2")
CHUNK = 512  # ROIs per step of the plain version (xb of 96000 ROIs is ~11 GB)


def make_inputs(n: int = 96000, device="cuda"):
    """The TPU script's inputs from ``RandomState(0)``: xint [n, 1, 14]
    int32, wx [n, 1, 7] f32, geom [n, 7, 4] f32, patch [32, 32·C] bf16;
    n rounded down to a multiple of K."""
    dev = common.resolve_device(device)
    n = (n // K) * K
    rng = np.random.RandomState(0)
    xint = np.concatenate([rng.randint(0, PX - 1, (n, 1, POOL)),
                           rng.randint(0, PX - 1, (n, 1, POOL))], axis=2)
    wx = rng.rand(n, 1, POOL)
    geom = np.stack([rng.randint(0, PY - 1, (n, POOL)), rng.randint(0, PY - 1, (n, POOL)),
                     rng.rand(n, POOL), rng.rand(n, POOL)], axis=-1)
    patch = rng.rand(PY, PX * C)
    return (torch.from_numpy(xint.astype(np.int32)).to(dev),
            torch.from_numpy(wx.astype(np.float32)).to(dev),
            torch.from_numpy(geom.astype(np.float32)).to(dev),
            torch.from_numpy(patch.astype(np.float32)).to(torch.bfloat16).to(dev))


def _check(xint, wx, geom, patch, variant):
    if variant not in VARIANTS:
        raise ValueError(f"roi_inner: unknown variant {variant!r}")
    n = xint.shape[0]
    want = ((xint, (n, 1, 2 * POOL), torch.int32), (wx, (n, 1, POOL), torch.float32),
            (geom, (n, POOL, 4), torch.float32), (patch, (PY, PX * C), torch.bfloat16))
    for t, shape, dtype in want:
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != xint.device:
            raise ValueError(f"roi_inner: want {dtype} {shape} on one device, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if variant == "pair2" and n % 2:
        raise ValueError("roi_inner pair2: an even number of ROIs")


def wy_rows(geom: torch.Tensor, py: int) -> torch.Tensor:
    """wy [k, 7, py] bf16: where(k == y0, 1 - w, 0) + where(k == y1, w, 0) in
    f32, y0 and y1 converted as XLA's astype(int32)."""
    y0 = roi_align.xla_to_int32(geom[..., 0])[..., None]
    y1 = roi_align.xla_to_int32(geom[..., 1])[..., None]
    w = geom[..., 2:3]
    iota = torch.arange(py, device=geom.device)
    zero = torch.zeros((), dtype=torch.float32, device=geom.device)
    return (torch.where(iota == y0, 1.0 - w, zero) + torch.where(iota == y1, w, zero)).to(
        torch.bfloat16)


def blend_matmul(src: torch.Tensor, x0, x1, wx, geom, variant: str) -> torch.Tensor:
    """The probes' shared body on k ROIs: src [k or 1, py, cols, C] f32
    patch values, x0 / x1 [k, 7] columns, wx [k, 7] → out [k, 7, 7·C] bf16."""
    k = x0.shape[0]
    py = src.shape[1]
    src = src.expand(k, *src.shape[1:])
    take = lambda x: torch.gather(src, 2, x[:, None, :, None].expand(k, py, POOL, C))
    w = wx[:, None, :, None]
    xb = ((1.0 - w) * take(x0) + w * take(x1)).to(torch.bfloat16)  # [k, py, 7, C]
    if variant == "nomatmul":
        return xb[:, :POOL].reshape(k, POOL, POOL * C)
    if variant == "noblend":
        xb = torch.zeros_like(xb)
    wy = wy_rows(geom, py).float()
    return torch.bmm(wy, xb.reshape(k, py, POOL * C).float()).to(torch.bfloat16)


def roi_inner_plain(xint, wx, geom, patch, variant: str = "full") -> torch.Tensor:
    """[n, 7, 7·C] bf16, ``CHUNK`` ROIs at a time."""
    _check(xint, wx, geom, patch, variant)
    n = xint.shape[0]
    out = torch.empty((n, POOL, POOL * C), dtype=torch.bfloat16, device=xint.device)
    src = patch.float().reshape(1, PY, PX, C)
    q = torch.arange(POOL, device=xint.device)
    for s in range(0, n, CHUNK):
        e = min(n, s + CHUNK)
        x0, x1 = xint[s:e, 0, :POOL].long(), xint[s:e, 0, POOL:].long()
        if variant == "static_x":
            x0, x1 = (4 * q).expand(e - s, POOL), (4 * q + 1).expand(e - s, POOL)
        elif variant == "wide2c":
            x1 = x0 + 1
        for x in (x0, x1):
            if variant != "noblend" and not bool(((x >= 0) & (x < PX)).all()):
                raise ValueError("roi_inner: a blend column lies outside the patch")
        out[s:e] = blend_matmul(src, x0, x1, wx[s:e, 0], geom[s:e], variant)
    if variant == "pair2":
        out[0::2] = out[1::2]
    return out


def _launch(xint, wx, geom, patch, variant: str):
    """Launch the kernel; returns (out, error flag) without reading the
    flag, so that nothing waits for the card."""
    _check(xint, wx, geom, patch, variant)
    n = xint.shape[0]
    dev = xint.device
    out = torch.empty((n, POOL, POOL * C), dtype=torch.bfloat16, device=dev)
    err = torch.zeros(1, dtype=torch.int32, device=dev)
    if n == 0:
        return out, err
    args = [t.contiguous() for t in (xint, wx, geom, patch)]
    lib = cuda_build.load("roi_probes")
    fn = lib.roi_inner_probe
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    global launches
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        status = fn(*[t.data_ptr() for t in args], out.data_ptr(), n, VARIANTS.index(variant),
                    err.data_ptr(), stream)
    cuda_build.check(status, "roi_inner")
    launches += 1
    return out, err


def _kernel(xint, wx, geom, patch, variant: str) -> torch.Tensor:
    out, err = _launch(xint, wx, geom, patch, variant)
    common.check_flag(err, "roi_inner", ["a blend column lies outside the patch"])
    return out


def roi_inner(xint, wx, geom, patch, variant: str = "full") -> torch.Tensor:
    """P2 on the inputs' device: the kernel on the card, the plain version
    for CPU tensors."""
    if xint.device.type == "cpu":
        return roi_inner_plain(xint, wx, geom, patch, variant)
    if xint.device.type != "cuda":
        raise ValueError(f"roi_inner: unsupported device {xint.device}")
    return _kernel(xint, wx, geom, patch, variant)


def work(n: int, variant: str):
    """(bytes, f32 operations, bf16 tensor-core operations) of the
    function on n ROIs: the output written once, the inputs read once;
    3 f32 operations per xb value, 2·7·32 per output column for the
    product."""
    byt = n * POOL * POOL * C * 2 + n * (2 * POOL + POOL + 4 * POOL) * 4 + PY * PX * C * 2
    blends = 0 if variant == "noblend" else n * (POOL if variant == "nomatmul" else PY) * POOL * C
    if variant == "pair2":
        blends //= 2
    mm = 0 if variant == "nomatmul" else n * 2 * POOL * PY * POOL * C
    if variant == "pair2":
        mm //= 2
    return byt, 3 * blends, mm


def run(variant: str = "full", n: int = 96000, iters: int = 8, device="cuda", out=None):
    """The TPU script's run of one variant; returns ms per call."""
    dev = common.resolve_device(device)
    xint, wx, geom, patch = make_inputs(n, dev)
    n = xint.shape[0]
    call = lambda: roi_inner(xint, wx, geom, patch, variant)
    if dev.type == "cuda":
        call()  # checks these inputs once; the timed launches skip the flag's sync
        call = lambda: _launch(xint, wx, geom, patch, variant)
    ms, _ = common.timed(call, iters, dev)
    print(f"{variant:10s} {ms:8.2f} ms for {n} ROIs ({1000.0 * ms / n:6.3f} us/ROI)", file=out,
          flush=True)
    return ms


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", default="full", choices=VARIANTS)
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
