"""ResNet-50/101 + FPN backbone: the float path and the int8 serving path.

Port of ``objectdetection_tpu.models.backbone`` (``ResNetFPN``): bottleneck
stages C2-C5 with frozen BatchNorm, 1×1 laterals + nearest 2× upsampling,
3×3 output convs P2-P5, and P6 = P5 subsampled by 2. Module names are the
flax scope names, so a converted flax tree loads by name
(:mod:`objectdetection_torch.convert`).

Float tensors run NCHW inside, in channels_last memory; the weights are
kept in f32 and cast to the compute dtype at use, as the flax modules do.

With a :class:`Quant` spec (``quantized_inference``) every conv is a
:class:`~objectdetection_torch.quant.QuantConv` and the stages carry an
int8 stream between blocks: ``(int8 NHWC tensor, scale)`` pairs, each
block's output quantized with its calibrated ``out_scale``. Identity blocks
whose shapes pass ``fused_block_supported`` run as one kernel with
``fused_bottleneck`` (:mod:`objectdetection_torch.ops.fused_block`); every
other int8 block runs as its convs with BatchNorm, ReLU, residual and
requant in their epilogues (:mod:`objectdetection_torch.ops.int8_conv`).
``bf16_stages`` serve whole stages in the compute dtype with dequantized
int8 kernels. Inside ``quant.calibration()`` every block runs the float
forward and records its ranges instead.

With ``remat`` (the Mask R-CNN family's ``remat_backbone``) each bottleneck
block run with gradients on is rematerialized: its activations are freed
after the forward and recomputed in the backward pass, as flax's
``nn.remat(BottleneckBlock)`` does; the stem is not.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from objectdetection_torch import quant as Q
from objectdetection_torch.ops import fused_block

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

    def folded(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The f32 affine (inv, shift)."""
        inv = self.scale / torch.sqrt(self.var + self.epsilon)
        return inv, self.bias - self.mean * inv

    def forward(self, x: torch.Tensor, channel_dim: int = 1) -> torch.Tensor:
        inv, shift = self.folded()
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
        t, b, l, r = Q.conv_pads(self.padding, x.shape[2], x.shape[3], k, self.stride)
        w, bias = self.weight.to(x.dtype), self.bias.to(x.dtype)
        if t == b and l == r:
            return F.conv2d(x, w, bias, stride=self.stride, padding=(t, l))
        # SAME at a stride > 1 pads the odd row and column at the high end
        return F.conv2d(F.pad(x, (l, r, t, b)), w, bias, stride=self.stride)


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


class Quant(NamedTuple):
    """The int8 serving options a quantized network is built with (the
    ``DetectorConfig`` fields of the same meaning)."""

    dtype: torch.dtype = torch.bfloat16
    per_channel: bool = False  # per_channel_acts
    fused: bool = False  # fused_bottleneck
    int8_stem: bool = False
    bf16_stages: Tuple[int, ...] = ()
    quantize_p2: bool = True  # quantize_fpn_p2


def make_conv(quant: Optional[Quant], cin: int, cout: int, k: int, stride: int = 1,
              padding=None, int8_compute: bool = True, per_channel: Optional[bool] = None):
    """A float :class:`Conv`, or a QuantConv when ``quant`` is given."""
    if quant is None:
        return Conv(cin, cout, k, stride, padding)
    pc = quant.per_channel if per_channel is None else per_channel
    return Q.QuantConv(cin, cout, k, stride, padding, per_channel=pc,
                       int8_compute=int8_compute, dtype=quant.dtype)


class BottleneckBlock(nn.Module):
    """ResNet bottleneck; float, or int8 with a :class:`Quant` spec (then it
    takes and returns the carried ``(int8 NHWC, scale)`` pair, or float
    tensors inside a bf16-served stage)."""

    def __init__(self, cin: int, filters: Tuple[int, int, int], stride: int,
                 projection: bool, stage: int, block: str, quant: Optional[Quant] = None,
                 int8_compute: bool = True, quantize_out: bool = False):
        super().__init__()
        f1, f2, f3 = filters
        cn = f"res{stage}{block}_branch"
        bnn = f"bn{stage}{block}_branch"
        self.names = (cn, bnn)
        self.filters = filters
        self.stride = stride
        self.projection = projection
        self.quant = quant
        self.int8_compute = int8_compute
        self.quantize_out = quantize_out
        conv = lambda ci, co, k, s: make_conv(quant, ci, co, k, s, int8_compute=int8_compute)
        if projection:
            self.add_module(cn + "1", conv(cin, f3, 1, stride))
            self.add_module(bnn + "1", FrozenBatchNorm(f3))
        self.add_module(cn + "2a", conv(cin, f1, 1, stride))
        self.add_module(bnn + "2a", FrozenBatchNorm(f1))
        self.add_module(cn + "2b", conv(f1, f2, 3, 1))
        self.add_module(bnn + "2b", FrozenBatchNorm(f2))
        self.add_module(cn + "2c", conv(f2, f3, 1, 1))
        # zero-gamma init on the residual's last BN (blocks start as identity)
        self.add_module(bnn + "2c", FrozenBatchNorm(f3, zero_init=True))
        if quant is not None:
            self.register_buffer("out_scale",
                                 torch.zeros(f3) if quant.per_channel else torch.zeros(()))

    def _fusable(self, x) -> bool:
        q = self.quant
        return (q.fused and self.int8_compute and not q.per_channel and not self.projection
                and self.stride == 1 and isinstance(x, tuple)
                and fused_block.fused_block_supported(x[0], self.filters[0]))

    def _fused(self, x):
        """The identity block as one kernel: frozen int8 weights (or weights
        quantized here, as QuantConv does) and the calibrated scales."""
        cn, bnn = self.names
        m = self._modules
        convs = [m[cn + s] for s in ("2a", "2b", "2c")]
        (ka, swa), (kb, swb), (kc, swc) = [c._qparams(c.act_scale) for c in convs]
        hwio = lambda k: k.permute(2, 3, 1, 0)
        x8, sx = x
        y8 = fused_block.fused_identity_block_int8(
            x8, sx, hwio(ka), hwio(kb), hwio(kc), swa, swb, swc,
            convs[0].bias, convs[1].bias, convs[2].bias,
            m[bnn + "2a"].folded(), m[bnn + "2b"].folded(), m[bnn + "2c"].folded(),
            scale_b=convs[1].act_scale, scale_c=convs[2].act_scale, out_scale=self.out_scale)
        return y8, self.out_scale

    def _int8_chain(self, x):
        """The int8 block as its three convs (and the projection), each
        with its BatchNorm, ReLU, residual and the requant to its consumer's
        scale in the conv's epilogue (``QuantConv.fused``): conv 2a's and
        2b's outputs leave as int8 at the next conv's ``act_scale``, 2c's at
        ``out_scale`` after the residual (the projection's bf16 output, or
        the block's int8 input dequantized in the epilogue). The same ops in
        the same order as BatchNorm, ReLU and ``quantize_nchw`` after each
        conv, so the codes are those of the unfused chain."""
        cn, bnn = self.names
        m = self._modules
        conv_b, conv_c = m[cn + "2b"], m[cn + "2c"]
        x8, sx = x
        if self.projection:
            shortcut = m[cn + "1"].fused(x8, sx, bn=m[bnn + "1"].folded())
        else:
            shortcut = x
        y8 = m[cn + "2a"].fused(x8, sx, bn=m[bnn + "2a"].folded(), relu=True,
                                out_scale=conv_b.act_scale)
        y8 = conv_b.fused(y8, conv_b.act_scale, bn=m[bnn + "2b"].folded(), relu=True,
                          out_scale=conv_c.act_scale)
        y8 = conv_c.fused(y8, conv_c.act_scale, bn=m[bnn + "2c"].folded(), residual=shortcut,
                          relu=True, out_scale=self.out_scale)
        return y8, self.out_scale

    def forward(self, x):
        cn, bnn = self.names
        m = self._modules
        q = self.quant
        int8_stream = q is not None and not Q.calibrating()
        bf16_serve = int8_stream and not self.int8_compute
        if bf16_serve and isinstance(x, tuple):
            x = Q.nchw(Q.dequantize_act(x[0], x[1], q.dtype))
        if int8_stream and not bf16_serve:
            if self._fusable(x):
                return self._fused(x)
            return self._int8_chain(x)
        shortcut = m[bnn + "1"](m[cn + "1"](x)) if self.projection else x
        y = F.relu(m[bnn + "2a"](m[cn + "2a"](x)))
        y = F.relu(m[bnn + "2b"](m[cn + "2b"](y)))
        y = m[bnn + "2c"](m[cn + "2c"](y))
        out = F.relu(y + shortcut)
        if q is None:
            return out
        if bf16_serve and not self.quantize_out:
            return out
        if int8_stream:  # re-enter the int8 stream
            return Q.quantize_nchw(out, self.out_scale), self.out_scale
        Q._record(self.out_scale, out, 1)  # calibration
        return out


def rematerialized(block: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``block(x)`` with its activations recomputed in the backward pass.

    The block's tensors enter the checkpoint as inputs, read while the
    caller's ``functional_call`` binds them: the training step takes its
    gradients after that binding is undone, when the module itself holds
    the meta tensors it was built with again, so a recompute through the
    module's own attributes would read those.
    """
    names, tensors = zip(*block.state_dict(keep_vars=True).items())

    def run(inp, *bound):
        return functional_call(block, dict(zip(names, bound)), (inp,))

    return checkpoint(run, x, *tensors, use_reentrant=False)


class ResNetBottomUp(nn.Module):
    """C2..C5 feature extractor (stem + 4 bottleneck stages)."""

    def __init__(self, model: str = "resnet101", cin: int = 3, quant: Optional[Quant] = None,
                 remat: bool = False):
        super().__init__()
        if model not in RESNET_STAGE4_BLOCKS:
            raise ValueError(f"unknown backbone {model!r}")
        if quant is not None and not set(quant.bf16_stages) <= {2, 3, 4, 5}:
            raise ValueError(f"bf16_stages {quant.bf16_stages}: stages are 2..5")
        self.quant = quant
        self.remat = remat
        self.conv1 = make_conv(quant, cin, 64, 7, 2, padding=3, per_channel=False,
                               int8_compute=quant is not None and quant.int8_stem)
        self.bn_conv1 = FrozenBatchNorm(64)
        if quant is not None:
            self.conv1.sows_mean = False
            self.register_buffer("c1_out_scale",
                                 torch.zeros(64) if quant.per_channel else torch.zeros(()))
        self.stages: List[List[str]] = []
        c = 64
        spec = [
            (2, (64, 64, 256), 1, 3),
            (3, (128, 128, 512), 2, 4),
            (4, (256, 256, 1024), 2, 1 + RESNET_STAGE4_BLOCKS[model]),
            (5, (512, 512, 2048), 2, 3),
        ]
        bf16 = quant.bf16_stages if quant is not None else ()
        for stage, filters, stride, blocks in spec:
            names = []
            requant = stage + 1 not in bf16  # a bf16 stage re-enters int8 at its exit
            for i in range(blocks):
                blk = chr(ord("a") + i)
                name = f"res{stage}{blk}"
                self.add_module(name, BottleneckBlock(
                    c, filters, stride if i == 0 else 1, i == 0, stage, blk, quant,
                    int8_compute=stage not in bf16,
                    quantize_out=i == blocks - 1 and requant))
                names.append(name)
                c = filters[2]
            self.stages.append(names)

    def forward(self, x: torch.Tensor):
        x = F.relu(self.bn_conv1(self.conv1(x)))
        x = max_pool_same(x)
        q = self.quant
        if q is not None:
            if Q.calibrating():
                Q._record(self.c1_out_scale, x, 1)
            elif 2 not in q.bf16_stages:  # enter the int8-carried stream
                x = (Q.quantize_nchw(x, self.c1_out_scale), self.c1_out_scale)
        remat = self.remat and torch.is_grad_enabled()
        outs = []
        for names in self.stages:
            for name in names:
                block = self._modules[name]
                x = rematerialized(block, x) if remat else block(x)
            outs.append(x)
        return tuple(outs)


def upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2, mode="nearest")


class ResNetFPN(nn.Module):
    """Image NCHW → (P2, P3, P4, P5, P6), each NCHW in the compute dtype.

    Quantized, the laterals take the stages' int8 outputs directly; with
    ``quantize_p2=False`` the finest level's two convs stay float.
    """

    def __init__(self, model: str = "resnet101", channels: int = 256, cin: int = 3,
                 quant: Optional[Quant] = None, remat: bool = False):
        super().__init__()
        self.quant = quant
        self.resnet = ResNetBottomUp(model, cin, quant, remat)
        float_p2 = quant is not None and not quant.quantize_p2
        for name, c in (("fpn_c5p5", 2048), ("fpn_c4p4", 1024),
                        ("fpn_c3p3", 512), ("fpn_c2p2", 256)):
            q = None if float_p2 and name == "fpn_c2p2" else quant
            self.add_module(name, make_conv(q, c, channels, 1))
        for name in ("fpn_p2", "fpn_p3", "fpn_p4", "fpn_p5"):
            q = None if float_p2 and name == "fpn_p2" else quant
            self.add_module(name, make_conv(q, channels, channels, 3))

    def _lat(self, name: str, c):
        conv = self._modules[name]
        if not isinstance(c, tuple):
            return conv(c)
        if isinstance(conv, Conv):  # float P2 gate on the int8 stream
            return conv(Q.nchw(Q.dequantize_act(c[0], c[1], self.quant.dtype)))
        return conv(c[0], in_scale=c[1])

    def forward(self, images: torch.Tensor):
        c2, c3, c4, c5 = self.resnet(images)
        m5 = self._lat("fpn_c5p5", c5)
        m4 = upsample2x_nearest(m5) + self._lat("fpn_c4p4", c4)
        m3 = upsample2x_nearest(m4) + self._lat("fpn_c3p3", c3)
        m2 = upsample2x_nearest(m3) + self._lat("fpn_c2p2", c2)
        p2 = self.fpn_p2(m2)
        p3 = self.fpn_p3(m3)
        p4 = self.fpn_p4(m4)
        p5 = self.fpn_p5(m5)
        p6 = p5[:, :, ::2, ::2]
        return p2, p3, p4, p5, p6
