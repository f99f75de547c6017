"""ResNet-50/101 + FPN (He et al. 2016; Lin et al. 2017), float32 NCHW.

The ResNet is matterport's (the stride on the first 1×1 of a stage's
first block, frozen BatchNorm after every conv); the FPN has 1×1 laterals,
nearest 2× upsampling, 3×3 outputs P2..P5 and P6 = P5 subsampled by 2.
Parameter names are the state-dict names both sides share.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import torch
import torch.nn.functional as F

from perfbench.reference.layers import F32, Precision, conv, frozen_bn, max_pool_same

STAGE4_BLOCKS = {"resnet50": 5, "resnet101": 22}
FPN_LATERALS = (("fpn_c5p5", 2048), ("fpn_c4p4", 1024), ("fpn_c3p3", 512), ("fpn_c2p2", 256))


def stages(model: str):
    """(stage, (f1, f2, f3), stride, blocks) of the four bottleneck stages."""
    return [(2, (64, 64, 256), 1, 3), (3, (128, 128, 512), 2, 4),
            (4, (256, 256, 1024), 2, 1 + STAGE4_BLOCKS[model]), (5, (512, 512, 2048), 2, 3)]


def spec(prefix: str, model: str, channels: int, cin: int = 3
         ) -> Iterator[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, init) of every tensor. init: ``he``/``lecun`` kernels,
    ``zeros``, ``ones``, ``residual_scale`` (the last BatchNorm scale of a
    residual branch)."""
    r = prefix + "resnet."

    def conv_(name, co, ci, k):
        yield name + ".weight", (co, ci, k, k), "lecun"
        yield name + ".bias", (co,), "zeros"

    def bn(name, c, scale="ones"):
        yield name + ".scale", (c,), scale
        yield name + ".bias", (c,), "zeros"
        yield name + ".mean", (c,), "zeros"
        yield name + ".var", (c,), "ones"

    yield r + "conv1.weight", (64, cin, 7, 7), "he"
    yield r + "conv1.bias", (64,), "zeros"
    yield from bn(r + "bn_conv1", 64)
    c = 64
    for stage, (f1, f2, f3), _, blocks in stages(model):
        for i in range(blocks):
            blk = f"{stage}{chr(ord('a') + i)}"
            m = f"{r}res{blk}."
            if i == 0:
                yield from conv_(f"{m}res{blk}_branch1", f3, c, 1)
                yield from bn(f"{m}bn{blk}_branch1", f3)
            yield from conv_(f"{m}res{blk}_branch2a", f1, c, 1)
            yield from bn(f"{m}bn{blk}_branch2a", f1)
            yield from conv_(f"{m}res{blk}_branch2b", f2, f1, 3)
            yield from bn(f"{m}bn{blk}_branch2b", f2)
            yield from conv_(f"{m}res{blk}_branch2c", f3, f2, 1)
            yield from bn(f"{m}bn{blk}_branch2c", f3, "residual_scale")
            c = f3
    for name, ci in FPN_LATERALS:
        yield from conv_(prefix + name, channels, ci, 1)
    for name in ("fpn_p2", "fpn_p3", "fpn_p4", "fpn_p5"):
        yield from conv_(prefix + name, channels, channels, 3)


def resnet_fpn(p: Dict[str, torch.Tensor], x: torch.Tensor, prefix: str, model: str,
               prec: Precision = F32, low_stem: bool = True):
    """x NCHW f32 → (P2, P3, P4, P5, P6) NCHW. ``prec`` lowers every conv
    the program runs below f32; the stem's activations too unless
    ``low_stem`` is False (the int8 recipe runs its stem in bf16 on a
    quantized kernel)."""
    r = prefix + "resnet."
    x = conv(x, p[r + "conv1.weight"], p[r + "conv1.bias"], 2, (3, 3, 3, 3), prec, True,
             weight_only=not low_stem)
    x = max_pool_same(F.relu(frozen_bn(x, p, r + "bn_conv1")))
    outs = []
    for stage, _, stride, blocks in stages(model):
        for i in range(blocks):
            blk = f"{stage}{chr(ord('a') + i)}"
            m = f"{r}res{blk}."
            s = stride if i == 0 else 1

            def cbn(y, branch, st=1):
                y = conv(y, p[f"{m}res{blk}_branch{branch}.weight"],
                         p[f"{m}res{blk}_branch{branch}.bias"], st, None, prec, True)
                return frozen_bn(y, p, f"{m}bn{blk}_branch{branch}")

            short = cbn(x, "1", s) if i == 0 else x
            y = F.relu(cbn(x, "2a", s))
            y = F.relu(cbn(y, "2b"))
            x = F.relu(cbn(y, "2c") + short)
        outs.append(x)
    c2, c3, c4, c5 = outs

    def lat(name, c):
        return conv(c, p[prefix + name + ".weight"], p[prefix + name + ".bias"], 1, None,
                    prec, True)

    up = lambda t: F.interpolate(t, scale_factor=2, mode="nearest")
    m5 = lat("fpn_c5p5", c5)
    m4 = up(m5) + lat("fpn_c4p4", c4)
    m3 = up(m4) + lat("fpn_c3p3", c3)
    m2 = up(m3) + lat("fpn_c2p2", c2)
    ps = [lat(f"fpn_p{i}", m) for i, m in zip((2, 3, 4, 5), (m2, m3, m4, m5))]
    return (*ps, ps[3][:, :, ::2, ::2])
