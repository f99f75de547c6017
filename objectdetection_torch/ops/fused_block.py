"""Fused int8 ResNet identity bottleneck: plain PyTorch version and CUDA kernel.

Port of ``objectdetection_tpu/ops/fused_block.py`` (``fused_identity_block_int8``
and its Pallas ``_kernel``), whose CUDA counterpart is ``csrc/fused_block.cu``.
One call runs a whole int8 identity block on the carried stream:

    t1 = x · Ka                      (1×1, exact int32)
    m1 = min(rint(max(f32(t1)·α_a + β_a, 0)), 127)          int8
    t2 = 3×3 conv of m1 by Kb        (SAME: m1 is zero outside the image)
    m2 = min(rint(max(f32(t2)·α_b + β_b, 0)), 127)          int8
    t3 = m2 · Kc
    y  = min(rint(max(f32(t3)·α_c + β_c + f32(x)·sc, 0)), 127)   int8

with the dequant, conv bias, folded BatchNorm and the requant to the next
conv's calibrated scale folded on the host into one affine per conv
(:func:`block_affines`, in the JAX wrapper's expression order). rint rounds
half to even, as ``jnp.round``. The kernel and the plain version share those
f32 tensors and compute the same f32 operations, so they are bit-equal; the
unfused int8 block (``QuantConv`` + BatchNorm in the compute dtype) rounds
in other places and differs by up to about one int8 step.

:func:`fused_block_supported` is the JAX gate, copied with its TPU tiling
rule (``pick_tile``): it decides which blocks fuse, and fused and unfused
blocks differ in their low bits, so the port fuses exactly the blocks JAX
fuses although the CUDA kernel needs no row tiles.

On the CPU the wrapper runs the plain version; on the card it launches the
kernel or raises. Inference only.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from objectdetection_torch import quant as Q
from objectdetection_torch.ops import cuda_build

launches = 0  # kernel launches (never counts the plain version)

TH = 32  # the Pallas kernel's row-tile height (the gate's tiling rule)
SMEM_LIMIT = 232448  # dynamic shared memory a block may use on Hopper


def pick_tile(h: int) -> int:
    """Largest tile height (<= TH) giving >= 2 tiles, or 0 if unsupported."""
    for th in (TH, 16, 8):
        if h % th == 0 and h // th >= 2:
            return th
    return 0


def fused_block_supported(x8: torch.Tensor, c1: int) -> bool:
    """The JAX gate: an int8 [B, H, W, C3] input with a tileable height
    (>= 2 row tiles), a 128-multiple W·C3 and 64-multiple bottleneck width."""
    if x8.dim() != 4 or x8.dtype != torch.int8:
        return False
    _, h, w, c3 = x8.shape
    return pick_tile(h) > 0 and (w * c3) % 128 == 0 and c1 % 64 == 0 and w >= 3


def smem_bytes(w: int, c3: int, c1: int) -> int:
    """The kernel's shared memory: one input row, three m1 rows, one m2 row."""
    return w * c3 + 4 * w * c1


def block_affines(in_scale, sw_a, sw_b, sw_c, bias_a, bias_b, bias_c, bn_a, bn_b, bn_c,
                  scale_b, scale_c, out_scale) -> Tuple[torch.Tensor, ...]:
    """(α_a, β_a, α_b, β_b, α_c, β_c, sc_short), f32, in the JAX wrapper's
    order (fused_block.py:291-310): relu commutes with the positive requant
    scale, so e.g. α_a = s_x/127 · s_w · inv · 127/s_b."""
    f32 = lambda v: v.to(torch.float32)
    dev = f32(sw_a).device
    qmax = torch.tensor(Q.ACT_QMAX, dtype=torch.float32, device=dev)
    sxa = f32(in_scale) / qmax
    r_b = qmax / torch.clamp(f32(scale_b), min=1e-30)
    r_c = qmax / torch.clamp(f32(scale_c), min=1e-30)
    r_o = qmax / torch.clamp(f32(out_scale), min=1e-30)
    (inv_a, shift_a), (inv_b, shift_b), (inv_c, shift_c) = (
        (f32(i), f32(s)) for i, s in (bn_a, bn_b, bn_c))
    alpha_a = sxa * f32(sw_a) * inv_a * r_b
    beta_a = (f32(bias_a) * inv_a + shift_a) * r_b
    alpha_b = f32(scale_b) / qmax * f32(sw_b) * inv_b * r_c
    beta_b = (f32(bias_b) * inv_b + shift_b) * r_c
    alpha_c = f32(scale_c) / qmax * f32(sw_c) * inv_c * r_o
    beta_c = (f32(bias_c) * inv_c + shift_c) * r_o
    sc_short = sxa * r_o
    return alpha_a, beta_a, alpha_b, beta_b, alpha_c, beta_c, sc_short


def _requant(t: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    v = torch.clamp(t.to(torch.float32) * alpha + beta, min=0.0)
    return torch.clamp(torch.round(v), max=127.0).to(torch.int8)


def fused_identity_block_int8_plain(x8, in_scale, ka8, kb8, kc8, sw_a, sw_b, sw_c,
                                    bias_a, bias_b, bias_c, bn_a, bn_b, bn_c,
                                    scale_b, scale_c, out_scale) -> torch.Tensor:
    """The block in PyTorch: exact integer convs (``quant.int8_conv``) and
    the kernel's f32 epilogues. Arguments as :func:`fused_identity_block_int8`."""
    aa, ba, ab, bb, ac, bc, sc = block_affines(
        in_scale, sw_a, sw_b, sw_c, bias_a, bias_b, bias_c, bn_a, bn_b, bn_c,
        scale_b, scale_c, out_scale)
    oihw = lambda k: k.permute(3, 2, 0, 1)
    m1 = _requant(Q.int8_conv(x8, oihw(ka8)), aa, ba)
    m2 = _requant(Q.int8_conv(m1, oihw(kb8)), ab, bb)
    t3 = Q.int8_conv(m2, oihw(kc8))
    v = torch.clamp(t3.to(torch.float32) * ac + bc + x8.to(torch.float32) * sc, min=0.0)
    return torch.clamp(torch.round(v), max=127.0).to(torch.int8)


def _pack(k: torch.Tensor) -> torch.Tensor:
    """[K, N] int8 → [K/16, N, 16]: 16 consecutive input channels of one
    output channel are one 16-byte load, neighbouring outputs adjacent."""
    kk, n = k.shape
    return k.reshape(kk // 16, 16, n).permute(0, 2, 1).contiguous()


def fused_identity_block_int8(
    x8: torch.Tensor,  # [B, H, W, C3] int8, NHWC
    in_scale: torch.Tensor,  # the block input's scale (scalar)
    ka8: torch.Tensor,  # [1, 1, C3, C1] int8 frozen kernel (HWIO, as JAX)
    kb8: torch.Tensor,  # [3, 3, C1, C1]
    kc8: torch.Tensor,  # [1, 1, C1, C3]
    sw_a: torch.Tensor,  # [C1] per-channel weight scales
    sw_b: torch.Tensor,
    sw_c: torch.Tensor,
    bias_a: torch.Tensor,  # conv biases
    bias_b: torch.Tensor,
    bias_c: torch.Tensor,
    bn_a: tuple,  # (inv, shift) folded FrozenBatchNorm affines
    bn_b: tuple,
    bn_c: tuple,
    scale_b: torch.Tensor,  # conv 2b's calibrated input scale (m1's range)
    scale_c: torch.Tensor,  # conv 2c's calibrated input scale (m2's range)
    out_scale: torch.Tensor,  # the block's calibrated output scale
) -> torch.Tensor:
    """One int8 identity bottleneck block, fused: int8 [B, H, W, C3]
    quantized with ``out_scale`` (the carried stream of the backbone)."""
    args = (x8, in_scale, ka8, kb8, kc8, sw_a, sw_b, sw_c, bias_a, bias_b, bias_c,
            bn_a, bn_b, bn_c, scale_b, scale_c, out_scale)
    if x8.device.type == "cpu":
        return fused_identity_block_int8_plain(*args)
    if x8.device.type != "cuda":
        raise ValueError(f"fused_block: unsupported device {x8.device}")
    b, h, w, c3 = x8.shape
    c1 = ka8.shape[-1]
    if not fused_block_supported(x8, c1):
        raise ValueError(f"fused_block: unsupported input {tuple(x8.shape)}, C1={c1}")
    if (tuple(ka8.shape) != (1, 1, c3, c1) or tuple(kb8.shape) != (3, 3, c1, c1)
            or tuple(kc8.shape) != (1, 1, c1, c3)
            or any(k.dtype != torch.int8 for k in (ka8, kb8, kc8))):
        raise ValueError("fused_block: kernels must be int8 HWIO [1,1,C3,C1], "
                         "[3,3,C1,C1], [1,1,C1,C3]")
    if c3 % 16 or smem_bytes(w, c3, c1) > SMEM_LIMIT:
        raise ValueError(f"fused_block: C3={c3}, W={w} exceed the kernel's tiling")
    affines = [t.contiguous() for t in block_affines(*args[1:2], *args[5:])]
    ka = _pack(ka8.reshape(c3, c1))
    kb = _pack(kb8.reshape(9 * c1, c1))
    kc = _pack(kc8.reshape(c1, c3))
    x = x8.contiguous()
    out = torch.empty_like(x)
    if b == 0:
        return out
    global launches
    lib = cuda_build.load("fused_block")
    fn = lib.fused_block_int8
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        status = fn(x.data_ptr(), ka.data_ptr(), kb.data_ptr(), kc.data_ptr(),
                    *[t.data_ptr() for t in affines], out.data_ptr(), b, h, w, c3, c1, stream)
    cuda_build.check(status, "fused_block")
    launches += 1
    return out


def block_bound(b: int, h: int, w: int, c3: int, c1: int) -> Tuple[int, int]:
    """(operations, bytes) one call must do and move: 2 per MAC of the three
    convs, without recomputing halos; the int8 input read once, the output
    written once, the three kernels read once."""
    macs = b * h * w * (c3 * c1 + 9 * c1 * c1 + c1 * c3)
    moved = 2 * b * h * w * c3 + (2 * c3 * c1 + 9 * c1 * c1) + 4 * (4 * c1 + 2 * c3)
    return 2 * macs, moved
