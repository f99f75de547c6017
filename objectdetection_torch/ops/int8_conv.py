"""Int8 convolution with its epilogue fused: plain PyTorch version and CUDA kernel.

Replaces no TPU kernel: the JAX package leaves the int8 conv to XLA
(``objectdetection_tpu/quant.py``). The port computed each int8 conv as an
im2col matrix, ``torch._int_mm`` and an unfused elementwise chain, each pass
over device memory; ``csrc/int8_conv.cu`` computes it as one implicit GEMM
whose epilogue writes what the conv's consumer reads:

    acc = int8 conv(x8, k8)                                exact int32
    y   = (f32(acc) · post).to(dtype) + bias.to(dtype)      always
    y   = y · inv.to(dtype) + shift.to(dtype)               ``bn=(inv, shift)``
    y   = y + residual                                      a tensor, or (x8, s) as
                                                            dequantize_act(x8, s, dtype)
    y   = relu(y)                                           ``relu``
    out = y, NHWC in ``dtype``, or quantize_act(y, out_scale) int8 NHWC

:func:`int8_conv_fused_plain` composes exactly those PyTorch ops (the ones
``QuantConv``, ``FrozenBatchNorm``, the residual add, ReLU and
``quantize_nchw`` ran in turn), and every per-channel vector the kernel takes
is computed here by the very expression the plain version evaluates
(:func:`_vectors`), so kernel and plain version are bit-equal.

What bounds it on the H100, at batch 96 and 1024²: bytes in ResNet stages
2-3 (the 1×1 convs of 64 channels do ~100 int8 operations a byte moved),
operations in stages 4-5, the RPN's shared 3×3 conv and the mask head's
14×14 convs. The design (``csrc/int8_conv.cu``): no im2col matrix and no f32
or bf16 intermediate in device memory (the taps are addressed in place and
the epilogue works in registers), int8 out inside a bottleneck block; the
product on the int8 tensor cores through a four-stage ``cp.async`` ring.
The tile is chosen from the shapes alone (:func:`tile`).

On the CPU the wrapper runs the plain version; on the card it launches the
kernel or raises. Inference only.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from objectdetection_torch import metrics
from objectdetection_torch import quant as Q
from objectdetection_torch.ops import cuda_build

launches = 0  # kernel launches (never counts the plain version)

FILL = 264  # blocks that fill the card twice over (132 SMs, two blocks each)
# the epilogue's flags (csrc/int8_conv.cu)
F_BN, F_RES_FLOAT, F_RES_INT8, F_RELU, F_OUT_INT8, F_F32 = 1, 2, 4, 8, 16, 32

Residual = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


def tile(m: int, n: int) -> Tuple[int, int]:
    """The kernel's tile (pixels, channels) for M pixels and N channels: a
    warp's share 64 × 32 where N allows, as (128, 128), or (256, 64) for N
    up to 64; (128, 32) for N up to 32; (128, 64) where the larger tile
    would leave fewer than ``FILL`` blocks."""
    if n <= 32:
        return 128, 32
    blocks = lambda bm, bn: -(-m // bm) * -(-n // bn)
    big = (256, 64) if n <= 64 else (128, 128)
    return big if blocks(*big) >= FILL else (128, 64)


def int8_conv_fused_plain(x8: torch.Tensor, k8: torch.Tensor, post: torch.Tensor,
                          bias: torch.Tensor, stride: int = 1, padding=None,
                          bn: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                          residual: Optional[Residual] = None, relu: bool = False,
                          out_scale: Optional[torch.Tensor] = None,
                          dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The conv and its epilogue in PyTorch: ``quant.int8_conv`` and the
    unfused ops. Arguments as :func:`int8_conv_fused`."""
    y32 = Q.int8_conv(x8, k8, stride, padding)
    y = (y32.to(torch.float32) * post).to(dtype) + bias.to(dtype)
    if bn is not None:
        inv, shift = bn
        y = y * inv.to(dtype) + shift.to(dtype)
    if residual is not None:
        if isinstance(residual, tuple):
            residual = Q.dequantize_act(residual[0], residual[1], dtype)
        y = y + residual
    if relu:
        y = F.relu(y)
    if out_scale is not None:
        return Q.quantize_act(y, out_scale)
    return y


def _vectors(n: int, dev, dtype, post, bias, bn, residual, out_scale):
    """The kernel's six f32 [n] vectors (post, bias, inv, shift, rs, f; None
    where unused), each the plain version's own operand: a value cast to the
    compute dtype and back, s/127 of ``dequantize_act``, _inv(s)·127 of
    ``quantize_act``; a scalar broadcast."""
    f32 = torch.float32
    vec = lambda v: v.to(device=dev, dtype=f32).expand(n).contiguous()
    rs = f = inv = shift = None
    if bn is not None:
        inv, shift = (vec(v.to(dtype)) for v in bn)
    if isinstance(residual, tuple):
        s = residual[1].to(f32)
        rs = vec(s / Q._c(Q.ACT_QMAX, s))
    if out_scale is not None:
        f = vec(Q._inv(out_scale) * Q.ACT_QMAX)
    return [vec(post), vec(bias.to(dtype)), inv, shift, rs, f]


def int8_conv_fused(x8: torch.Tensor, k8: torch.Tensor, post: torch.Tensor,
                    bias: torch.Tensor, stride: int = 1, padding=None,
                    bn: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                    residual: Optional[Residual] = None, relu: bool = False,
                    out_scale: Optional[torch.Tensor] = None,
                    dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """One int8 conv and its epilogue.

    x8: int8 NHWC [B, H, W, Cin]; k8: int8 OIHW [N, Cin, kh, kw]; post: the
    f32 multiplier of the int32 sums ([N] or a scalar); bias [N]; stride and
    padding as ``quant.int8_conv`` (flax SAME, an int, or ((t, b), (l, r)));
    bn: a folded BatchNorm (inv, shift), f32 [N]; residual: [B, Ho, Wo, N] in
    ``dtype``, or (int8 [B, Ho, Wo, N], its scale) dequantized; relu;
    out_scale: quantize the result with it (a scalar or [N]), else return
    it in ``dtype`` (bfloat16 or float32). Returns NHWC [B, Ho, Wo, N].
    """
    if x8.device.type == "cpu":
        out = int8_conv_fused_plain(x8, k8, post, bias, stride, padding, bn, residual, relu,
                                    out_scale, dtype)
    elif x8.device.type != "cuda":
        raise ValueError(f"int8_conv: unsupported device {x8.device}")
    else:
        out = _launch(x8, k8, post, bias, stride, padding, bn, residual, relu, out_scale, dtype)
    metrics.count("int8_conv.launches", 1)
    if out_scale is not None:
        metrics.count("int8_conv.int8_out", 1)
    return out


def _launch(x8, k8, post, bias, stride, padding, bn, residual, relu, out_scale, dtype):
    if x8.dim() != 4 or k8.dim() != 4 or x8.dtype != torch.int8 or k8.dtype != torch.int8:
        raise ValueError("int8_conv: x8 must be int8 NHWC and k8 int8 OIHW")
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"int8_conv: compute dtype {dtype}, want bfloat16 or float32")
    b, h, w, cin = x8.shape
    n, kcin, kh, kw = k8.shape
    if kcin != cin or k8.device != x8.device:
        raise ValueError(f"int8_conv: kernel {tuple(k8.shape)} on {k8.device} for input "
                         f"{tuple(x8.shape)} on {x8.device}")
    t, bo, l, r = Q.conv_pads(padding, h, w, kh, stride)
    ho = (h + t + bo - kh) // stride + 1
    wo = (w + l + r - kw) // stride + 1
    if min(t, bo, l, r) < 0 or min(ho, wo) <= 0 or stride <= 0:
        raise ValueError(f"int8_conv: pads {(t, bo, l, r)}, stride {stride} give {ho}x{wo}")
    flags = (F_BN if bn is not None else 0) | (F_RELU if relu else 0) | (
        F_OUT_INT8 if out_scale is not None else 0) | (F_F32 if dtype == torch.float32 else 0)
    res = None
    if residual is not None:
        res, want = (residual[0], torch.int8) if isinstance(residual, tuple) else (residual, dtype)
        flags |= F_RES_INT8 if isinstance(residual, tuple) else F_RES_FLOAT
        if tuple(res.shape) != (b, ho, wo, n) or res.dtype != want or res.device != x8.device:
            raise ValueError(f"int8_conv: residual {tuple(res.shape)} {res.dtype}, want "
                             f"{(b, ho, wo, n)} {want}")
        res = res.contiguous()
        if res.data_ptr() % 16:  # the kernel copies it in 16-byte pieces
            res = res.clone()
    if n % 2:
        raise ValueError(f"int8_conv: {n} output channels; the kernel writes pairs")
    # 16 | Cin (the kernel's 16-byte copies): zero channels are exact
    pad_c = (-cin) % 16
    if pad_c:
        x8 = F.pad(x8, (0, pad_c))
        k8 = F.pad(k8, (0, 0, 0, 0, 0, pad_c))
    x = x8.contiguous()
    if x.data_ptr() % 16:  # the kernel copies it in 16-byte pieces
        x = x.clone()
    wmat = k8.permute(0, 2, 3, 1).contiguous()  # OHWI: [N][K], K = (dy, dx, ci)
    vecs = _vectors(n, x.device, dtype, post, bias, bn, residual, out_scale)
    out = torch.empty((b, ho, wo, n), dtype=torch.int8 if out_scale is not None else dtype,
                      device=x.device)
    if out.numel() == 0:
        return out
    fn = cuda_build.load("int8_conv").int8_conv
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_void_p] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    ptrs = (ctypes.c_void_p * 6)(*[None if v is None else v.data_ptr() for v in vecs])
    dims = (ctypes.c_int * 15)(b, h, w, cin + pad_c, ho, wo, n, kh, kw, stride, t, l, flags,
                               *tile(b * ho * wo, n))
    with torch.cuda.device(x.device):
        status = fn(x.data_ptr(), wmat.data_ptr(), ptrs, None if res is None else res.data_ptr(),
                    out.data_ptr(), dims, torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(status, "int8_conv")
    global launches
    launches += 1
    return out


# the epilogues of mask_rcnn_convs: bias and bf16 out (QuantConv), the
# projection (+ BatchNorm), conv 2a / 2b (+ BatchNorm, ReLU, int8 out), conv
# 2c (+ BatchNorm, the residual, ReLU, int8 out) of a projection block (a
# bf16 residual) and of an identity block (its int8 input, dequantized)
EPILOGUES = ("bias", "proj", "ab", "c_proj", "c_id")


def mask_rcnn_convs(batch: int, image: int = 1024, stage4_blocks: int = 22,
                    rois: int = 100) -> list:
    """The int8 convs of one int8 Mask R-CNN inference call that go through
    :func:`int8_conv_fused` (ResNet + FPN at image², R-101's stage 4 with
    ``stage4_blocks`` identity blocks, the RPN at P2-P6, the mask head on
    batch × ``rois`` ROIs): (name, B, H, W, Cin, Cout, k, stride, epilogue of
    ``EPILOGUES``, calls). R-101 at 1024²: 125 calls, 99 of them int8 out."""
    convs = []
    h, c = image // 4, 64  # after the stem and its max pool
    for stage, (f1, f3, stride, blocks) in enumerate(
            ((64, 256, 1, 3), (128, 512, 2, 4), (256, 1024, 2, 1 + stage4_blocks),
             (512, 2048, 2, 3)), start=2):
        ho = -(-h // stride)
        convs += [(f"res{stage}a proj", batch, h, h, c, f3, 1, stride, "proj", 1),
                  (f"res{stage}a 2a", batch, h, h, c, f1, 1, stride, "ab", 1),
                  (f"res{stage} 2b", batch, ho, ho, f1, f1, 3, 1, "ab", blocks),
                  (f"res{stage}a 2c", batch, ho, ho, f1, f3, 1, 1, "c_proj", 1),
                  (f"res{stage} 2a", batch, ho, ho, f3, f1, 1, 1, "ab", blocks - 1),
                  (f"res{stage} 2c", batch, ho, ho, f1, f3, 1, 1, "c_id", blocks - 1)]
        h, c = ho, f3
    sizes = [image // s for s in (4, 8, 16, 32)]
    for size, cin in zip(sizes, (256, 512, 1024, 2048)):
        convs.append((f"fpn lateral {size}", batch, size, size, cin, 256, 1, 1, "bias", 1))
    for size in sizes:
        convs.append((f"fpn p {size}", batch, size, size, 256, 256, 3, 1, "bias", 1))
    for size in sizes + [image // 64]:
        convs += [(f"rpn shared {size}", batch, size, size, 256, 512, 3, 1, "bias", 1),
                  (f"rpn head {size}", batch, size, size, 512, 18, 1, 1, "bias", 1)]
    convs.append(("mask", batch * rois, 14, 14, 256, 256, 3, 1, "bias", 4))
    return convs


def conv_bound(b: int, h: int, w: int, cin: int, cout: int, k: int, stride: int = 1,
               out_bytes: int = 2, residual_bytes: int = 0) -> Tuple[int, int]:
    """(operations, bytes) one SAME conv must do and move: 2 per MAC; the
    int8 input read once, the kernel once, the output (``out_bytes`` an
    element) written once and a residual of ``residual_bytes`` an element
    read once."""
    ho, wo = -(-h // stride), -(-w // stride)
    m = b * ho * wo
    ops = 2 * m * cout * k * k * cin
    moved = b * h * w * cin + cout * k * k * cin + m * cout * (out_bytes + residual_bytes)
    return ops, moved
