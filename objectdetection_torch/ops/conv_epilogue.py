"""What follows a float conv of ResNetFPN in inference: plain PyTorch version and CUDA kernel.

Replaces no TPU kernel: XLA fuses these ops into the JAX package's convs
(``objectdetection_tpu/models/backbone.py``). In PyTorch each is a pass of
its own over the conv's output: ``F.conv2d`` adds its bias after cuDNN as an
``add_``, then come BatchNorm's multiply and add, the residual or the FPN's
upsample-and-add, and ReLU. ``csrc/conv_epilogue.cu`` applies them in one
pass, in place in cuDNN's fresh output ``y``:

    y = y + bias.to(dtype)                                  always
    y = y * inv.to(dtype) + shift.to(dtype)                 ``bn=(inv, shift)``
    y = y + residual                                        a tensor of y's shape
    y = upsample2x_nearest(coarse) + y                      the coarser FPN level
    y = relu(y)                                             ``relu``

:func:`conv_epilogue_plain` composes exactly those PyTorch ops, and every
per-channel vector the kernel takes is the plain version's own operand (the
value cast to ``y``'s dtype), so kernel and plain version are bit-equal.

What bounds it on the H100: bytes, a few operations for every 2 or 4 bytes
moved. The design (``csrc/conv_epilogue.cu``): one read and one write of
``y``, one read of the residual, the coarser level read in place at
``(h >> 1, w >> 1)`` (no upsampled copy); 16-byte vectors, neighbouring
threads on neighbouring channel groups, then pixels; a grid the card holds
at once, whose stride keeps each thread on one channel group, so that its
bias, inv and shift load once into registers.

On the CPU the wrapper runs the plain version; on the card it launches the
kernel. Both check their operands first and raise on what the kernel does
not take. Inference only: the result is written into ``y``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from objectdetection_torch import metrics
from objectdetection_torch.ops import cuda_build

_EPILOGUE = cuda_build.Entry("conv_epilogue", "conv_epilogue", [ctypes.c_void_p] * 4)

# the epilogue's flags (csrc/conv_epilogue.cu)
F_BN, F_RES, F_COARSE, F_RELU, F_F32 = 1, 2, 4, 8, 16

BN = Optional[Tuple[torch.Tensor, torch.Tensor]]


def conv_epilogue_plain(y: torch.Tensor, bias: torch.Tensor, bn: BN = None,
                        residual: Optional[torch.Tensor] = None,
                        coarse: Optional[torch.Tensor] = None, relu: bool = False) -> torch.Tensor:
    """The epilogue as the PyTorch ops it replaces: ``F.conv2d``'s bias
    (cuDNN's ``add_``), ``FrozenBatchNorm``, the residual or the nearest 2×
    upsampled ``coarse`` level, ``F.relu``. Arguments as :func:`conv_epilogue`."""
    dtype = y.dtype
    y = y.add_(bias.to(dtype).view(1, -1, 1, 1))
    if bn is not None:
        inv, shift = bn
        y = y * inv.to(dtype).view(1, -1, 1, 1) + shift.to(dtype).view(1, -1, 1, 1)
    if residual is not None:
        y = y + residual
    if coarse is not None:
        y = F.interpolate(coarse, scale_factor=2, mode="nearest") + y
    if relu:
        y = F.relu(y)
    return y


def conv_epilogue(y: torch.Tensor, bias: torch.Tensor, bn: BN = None,
                  residual: Optional[torch.Tensor] = None,
                  coarse: Optional[torch.Tensor] = None, relu: bool = False) -> torch.Tensor:
    """A conv's epilogue, written into ``y``.

    y: the conv's output without its bias, [B, C, H, W] in channels_last
    memory, bfloat16 or float32, C a multiple of 8; bias [C]; bn: a folded
    BatchNorm (inv, shift), [C] each; residual: y's shape, layout and dtype;
    coarse: [B, C, H/2, W/2] in y's layout and dtype, added nearest-2×
    upsampled (not with ``residual``); relu. Returns the result (``y`` itself
    on the card).
    """
    kernel = cuda_build.takes_kernel(y, "conv_epilogue")
    _check(y, residual, coarse)
    if kernel:
        out = _launch(y, bias, bn, residual, coarse, relu)
    else:
        out = conv_epilogue_plain(y, bias, bn, residual, coarse, relu)
    if metrics.collecting():
        metrics.count("conv_epilogue.launches", 1)
    return out


def _check(y, residual, coarse):
    if y.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"conv_epilogue: dtype {y.dtype}, want bfloat16 or float32")
    if y.dim() != 4 or y.shape[1] % 8:
        raise ValueError(f"conv_epilogue: y {tuple(y.shape)}, want [B, C, H, W] with 8 | C")
    if residual is not None and coarse is not None:
        raise ValueError("conv_epilogue: a residual or a coarser level, not both")
    b, c, h, w = y.shape
    for name, t, shape in (("y", y, (b, c, h, w)), ("residual", residual, (b, c, h, w)),
                           ("coarse", coarse, (b, c, h // 2, w // 2))):
        if t is None:
            continue
        if name == "coarse" and (h % 2 or w % 2):
            raise ValueError(f"conv_epilogue: y {tuple(y.shape)} is not twice the coarser level")
        if tuple(t.shape) != shape or t.dtype != y.dtype or t.device != y.device:
            raise ValueError(f"conv_epilogue: {name} {tuple(t.shape)} {t.dtype} on {t.device}, "
                             f"want {shape} {y.dtype} on {y.device}")
        if not t.is_contiguous(memory_format=torch.channels_last):
            raise ValueError(f"conv_epilogue: {name} is not channels_last contiguous")


def _vector(v: torch.Tensor, dtype) -> torch.Tensor:
    """``v`` cast to the output dtype (the plain version's operand), on
    16 bytes (the kernel reads it in 16-byte pieces)."""
    v = v.to(dtype).contiguous()
    return v if v.data_ptr() % 16 == 0 else v.clone()


def _launch(y, bias, bn, residual, coarse, relu):
    if y.data_ptr() % 16:
        raise ValueError("conv_epilogue: y is not 16-byte aligned")
    b, c, h, w = y.shape
    dtype = y.dtype
    flags = (F_BN if bn is not None else 0) | (F_RES if residual is not None else 0) | (
        F_COARSE if coarse is not None else 0) | (F_RELU if relu else 0) | (
        F_F32 if dtype == torch.float32 else 0)
    vecs = [_vector(bias, dtype)] + ([_vector(v, dtype) for v in bn] if bn is not None else
                                     [None, None])
    if any(v.device != y.device or v.shape != (c,) for v in vecs if v is not None):
        raise ValueError(f"conv_epilogue: per-channel vectors must be [{c}] on {y.device}")
    r = residual if residual is not None else coarse
    if r is not None and r.data_ptr() % 16:
        r = r.clone(memory_format=torch.channels_last)
    if y.numel() == 0:
        return y
    ptrs = (ctypes.c_void_p * 3)(*[None if v is None else v.data_ptr() for v in vecs])
    dims = (ctypes.c_int * 5)(b, h, w, c, flags)
    _EPILOGUE.launch(y.device, y.data_ptr(), ptrs, None if r is None else r.data_ptr(), dims)
    return y


# the epilogues of resnet_fpn_sites: the FPN's output convs and RetinaNet's
# P6 / P7 (bias), a projection (+ BatchNorm), the stem and convs 2a / 2b
# (+ BatchNorm, ReLU), conv 2c (+ BatchNorm, the residual, ReLU), a lateral
# (+ the coarser level, upsampled)
KINDS = ("bias", "bn", "bn_relu", "bn_res_relu", "top_down")


def resnet_fpn_sites(batch: int, image: int = 1024,
                     levels: Tuple[int, ...] = (2, 3, 4, 5, 6)) -> list:
    """The float convs of one R-101 ResNetFPN inference call at image² (the
    pyramid ``levels``, P2..P6 or RetinaNet's P3..P7), each with its
    epilogue: (name, B, C, H, W of the output, kind of ``KINDS``, calls):
    112 calls either way."""
    sites = [("stem", batch, 64, image // 2, image // 2, "bn_relu", 1)]
    h = image // 4  # after the stem's max pool
    for stage, (f1, f3, stride, blocks) in enumerate(
            ((64, 256, 1, 3), (128, 512, 2, 4), (256, 1024, 2, 23), (512, 2048, 2, 3)),
            start=2):
        ho = -(-h // stride)
        sites += [(f"res{stage}a proj", batch, f3, ho, ho, "bn", 1),
                  (f"res{stage} 2a", batch, f1, ho, ho, "bn_relu", blocks),
                  (f"res{stage} 2b", batch, f1, ho, ho, "bn_relu", blocks),
                  (f"res{stage} 2c", batch, f3, ho, ho, "bn_res_relu", blocks)]
        h = ho
    sizes = {i: -(-image // 2 ** i) for i in range(2, 8)}
    for i in [i for i in levels if i <= 5]:
        sites += [(f"fpn lateral P{i}", batch, 256, sizes[i], sizes[i],
                   "bias" if i == 5 else "top_down", 1),
                  (f"fpn P{i}", batch, 256, sizes[i], sizes[i], "bias", 1)]
    if 7 in levels:  # RetinaNet's P6 and P7, convs on C5 and on ReLU(P6)
        sites += [(f"fpn P{i}", batch, 256, sizes[i], sizes[i], "bias", 1) for i in (6, 7)]
    return sites


def site_bytes(site, itemsize: int = 2) -> int:
    """Bytes one call of a site of :func:`resnet_fpn_sites` must move: its
    output read and written once, a residual read once (a coarser level: a
    quarter of that)."""
    _, b, c, h, w, kind, _ = site
    y = b * c * h * w * itemsize
    return 2 * y + {"bn_res_relu": y, "top_down": y // 4}.get(kind, 0)
