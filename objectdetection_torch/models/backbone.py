"""ResNet-50/101 + FPN backbone, float path.

Port of ``objectdetection_tpu.models.backbone`` (``ResNetFPN``): bottleneck
stages C2-C5 with frozen BatchNorm, 1×1 laterals + nearest 2× upsampling,
3×3 output convs P2-P5, and P6 = P5 subsampled by 2. Module names are the
flax scope names, so a converted flax tree loads by name
(:mod:`objectdetection_torch.convert`).

Tensors run NCHW inside, in channels_last memory; the weights are
kept in f32 and cast to the compute dtype at use, as the flax modules do.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

# identity blocks after the stage-4 conv block
RESNET_STAGE4_BLOCKS = {"resnet50": 5, "resnet101": 22}


class FrozenBatchNorm(nn.Module):
    """y = x * (scale / sqrt(var + eps)) + (bias - mean * inv), eps 1e-3.

    The affine is folded in f32, then cast to the activation dtype, as the
    flax module does.
    """

    def __init__(self, c: int, epsilon: float = 1e-3, zero_init: bool = False):
        super().__init__()
        self.epsilon = epsilon
        self.register_buffer("scale", torch.zeros(c) if zero_init else torch.ones(c))
        self.register_buffer("bias", torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def forward(self, x: torch.Tensor, channel_dim: int = 1) -> torch.Tensor:
        inv = self.scale / torch.sqrt(self.var + self.epsilon)
        shift = self.bias - self.mean * inv
        shape = [1] * x.dim()
        shape[channel_dim] = -1
        return x * inv.to(x.dtype).view(shape) + shift.to(x.dtype).view(shape)


class Conv(nn.Module):
    """Conv with flax ``"SAME"`` padding (or an explicit one); weight OIHW f32."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, padding=None):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin, k, k), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(cout), requires_grad=False)
        self.stride = stride
        self.padding = padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.weight.shape[-1]
        if self.padding is not None:
            pad = self.padding
        elif self.stride == 1:
            pad = (k - 1) // 2  # SAME, odd kernel, stride 1
        else:
            assert k == 1, "SAME stride-2 convs are 1×1 here (no padding)"
            pad = 0
        return F.conv2d(x, self.weight.to(x.dtype), self.bias.to(x.dtype),
                        stride=self.stride, padding=pad)


def max_pool_same(x: torch.Tensor, k: int = 3, s: int = 2) -> torch.Tensor:
    """3×3/2 max pool with flax ``"SAME"`` padding: pads (lo, hi) with -inf,
    hi getting the odd one — not ``padding=1`` (other windows on even sizes)."""
    pads = []
    for size in (x.shape[3], x.shape[2]):  # F.pad order: W then H
        out = -(-size // s)
        total = max((out - 1) * s + k - size, 0)
        pads += [total // 2, total - total // 2]
    x = F.pad(x, pads, value=float("-inf"))
    return F.max_pool2d(x, k, s)


class BottleneckBlock(nn.Module):
    def __init__(self, cin: int, filters: Tuple[int, int, int], stride: int,
                 projection: bool, stage: int, block: str):
        super().__init__()
        f1, f2, f3 = filters
        cn = f"res{stage}{block}_branch"
        bnn = f"bn{stage}{block}_branch"
        self.names = (cn, bnn)
        self.projection = projection
        if projection:
            self.add_module(cn + "1", Conv(cin, f3, 1, stride))
            self.add_module(bnn + "1", FrozenBatchNorm(f3))
        self.add_module(cn + "2a", Conv(cin, f1, 1, stride))
        self.add_module(bnn + "2a", FrozenBatchNorm(f1))
        self.add_module(cn + "2b", Conv(f1, f2, 3, 1))
        self.add_module(bnn + "2b", FrozenBatchNorm(f2))
        self.add_module(cn + "2c", Conv(f2, f3, 1, 1))
        # zero-gamma init on the residual's last BN (blocks start as identity)
        self.add_module(bnn + "2c", FrozenBatchNorm(f3, zero_init=True))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cn, bnn = self.names
        m = self._modules
        if self.projection:
            shortcut = m[bnn + "1"](m[cn + "1"](x))
        else:
            shortcut = x
        y = F.relu(m[bnn + "2a"](m[cn + "2a"](x)))
        y = F.relu(m[bnn + "2b"](m[cn + "2b"](y)))
        y = m[bnn + "2c"](m[cn + "2c"](y))
        return F.relu(y + shortcut)


class ResNetBottomUp(nn.Module):
    """C2..C5 feature extractor (stem + 4 bottleneck stages)."""

    def __init__(self, model: str = "resnet101", cin: int = 3):
        super().__init__()
        if model not in RESNET_STAGE4_BLOCKS:
            raise ValueError(f"unknown backbone {model!r}")
        self.conv1 = Conv(cin, 64, 7, stride=2, padding=3)
        self.bn_conv1 = FrozenBatchNorm(64)
        self.stages: List[List[str]] = []
        c = 64
        spec = [
            (2, (64, 64, 256), 1, 3),
            (3, (128, 128, 512), 2, 4),
            (4, (256, 256, 1024), 2, 1 + RESNET_STAGE4_BLOCKS[model]),
            (5, (512, 512, 2048), 2, 3),
        ]
        for stage, filters, stride, blocks in spec:
            names = []
            for i in range(blocks):
                blk = chr(ord("a") + i)
                name = f"res{stage}{blk}"
                self.add_module(name, BottleneckBlock(
                    c, filters, stride if i == 0 else 1, i == 0, stage, blk))
                names.append(name)
                c = filters[2]
            self.stages.append(names)

    def forward(self, x: torch.Tensor):
        x = F.relu(self.bn_conv1(self.conv1(x)))
        x = max_pool_same(x)
        outs = []
        for names in self.stages:
            for name in names:
                x = self._modules[name](x)
            outs.append(x)
        return tuple(outs)


def upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2, mode="nearest")


class ResNetFPN(nn.Module):
    """Image NCHW → (P2, P3, P4, P5, P6), each NCHW."""

    def __init__(self, model: str = "resnet101", channels: int = 256, cin: int = 3):
        super().__init__()
        self.resnet = ResNetBottomUp(model, cin)
        for name, c in (("fpn_c5p5", 2048), ("fpn_c4p4", 1024),
                        ("fpn_c3p3", 512), ("fpn_c2p2", 256)):
            self.add_module(name, Conv(c, channels, 1))
        for name in ("fpn_p2", "fpn_p3", "fpn_p4", "fpn_p5"):
            self.add_module(name, Conv(channels, channels, 3))

    def forward(self, images: torch.Tensor):
        c2, c3, c4, c5 = self.resnet(images)
        m5 = self.fpn_c5p5(c5)
        m4 = upsample2x_nearest(m5) + self.fpn_c4p4(c4)
        m3 = upsample2x_nearest(m4) + self.fpn_c3p3(c3)
        m2 = upsample2x_nearest(m3) + self.fpn_c2p2(c2)
        p2 = self.fpn_p2(m2)
        p3 = self.fpn_p3(m3)
        p4 = self.fpn_p4(m4)
        p5 = self.fpn_p5(m5)
        p6 = p5[:, :, ::2, ::2]
        return p2, p3, p4, p5, p6
