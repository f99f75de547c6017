"""ROI heads: box/class classifier and the class-selected mask predictor.

Port of ``objectdetection_tpu.models.heads`` (``BoxClassHead``, ``MaskHead``,
``_MaskFinalConv``). The 7×7 VALID conv over a pooled ROI is a dense layer
over the ROI flattened in (ph, pw, C) order, as in the flax module.

Quantized (``quant`` given): the box head's two 1024-wide layers are
QuantDense and the mask head's four trunk convs QuantConv; both heads take
an int8 pooled tensor with its scale (``in_scale``, from ROIAlign's int8
epilogue) into their first layer. Serving, each trunk conv's epilogue
applies its BatchNorm and ReLU and, for convs 1-3, quantizes to the next
conv's scale (``QuantConv.fused``), so the trunk passes int8 between its
convs. Logits, box deltas, the deconv and the final mask conv stay float.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from objectdetection_torch import quant as Q
from objectdetection_torch.models.backbone import Conv, FrozenBatchNorm, Quant, make_conv


class Dense(nn.Module):
    """y = x @ W.T + b with W [out, in] f32, computed in the input's dtype."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(cout), requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class BoxClassHead(nn.Module):
    """Pooled ROIs [B, R, ph, pw, C] → (logits, probs [B, R, K], bbox [B, R, K, 4])."""

    def __init__(self, num_classes: int, pool_shape=(7, 7), channels: int = 256,
                 quant: Optional[Quant] = None):
        super().__init__()
        self.num_classes = num_classes
        if quant is None:
            dense = Dense
        else:
            dense = lambda ci, co: Q.QuantDense(ci, co, quant.per_channel, quant.dtype)
        ph, pw = pool_shape
        self.mrcnn_class_conv1 = dense(ph * pw * channels, 1024)
        self.mrcnn_class_bn1 = FrozenBatchNorm(1024)
        self.mrcnn_class_conv2 = dense(1024, 1024)
        self.mrcnn_class_bn2 = FrozenBatchNorm(1024)
        self.mrcnn_class_logits = Dense(1024, num_classes)
        self.mrcnn_bbox_fc = Dense(1024, num_classes * 4)

    def forward(self, pooled: torch.Tensor, dtype: torch.dtype,
                in_scale: Optional[torch.Tensor] = None):
        """pooled [B, R, ph, pw, C]: float, or int8 with its ``in_scale``."""
        b, r, ph, pw, c = pooled.shape
        x = pooled.reshape(b, r, ph * pw * c)
        if in_scale is not None:
            x = self.mrcnn_class_conv1(x, in_scale)
        else:
            x = self.mrcnn_class_conv1(x.to(dtype))
        x = F.relu(self.mrcnn_class_bn1(x, channel_dim=-1))
        x = self.mrcnn_class_conv2(x)
        shared = F.relu(self.mrcnn_class_bn2(x, channel_dim=-1)).to(torch.float32)
        logits = self.mrcnn_class_logits(shared)
        probs = torch.softmax(logits, dim=-1)
        bbox = self.mrcnn_bbox_fc(shared).reshape(b, r, self.num_classes, 4)
        return logits, probs, bbox


class MaskHead(nn.Module):
    """Pooled ROIs [B, R, 14, 14, C] → sigmoid masks.

    4× [conv3×3(256) + BN + relu] → deconv 2×2/2 + relu → 1×1 per-class conv.
    With ``class_ids`` [B, R] only each ROI's own class column is applied,
    giving [B, R, 28, 28]; without, [B, R, 28, 28, num_classes].
    """

    def __init__(self, num_classes: int, channels: int = 256, cin: int | None = None,
                 quant: Optional[Quant] = None):
        super().__init__()
        self.quant = quant
        for i in range(1, 5):
            c_in = (cin or channels) if i == 1 else channels
            self.add_module(f"mrcnn_mask_conv{i}", make_conv(quant, c_in, channels, 3))
            self.add_module(f"mrcnn_mask_bn{i}", FrozenBatchNorm(channels))
        # torch layout [in, out, kh, kw]; the converter flips the flax kernel
        self.mrcnn_mask_deconv = nn.Module()
        self.mrcnn_mask_deconv.weight = nn.Parameter(
            torch.zeros(channels, channels, 2, 2), requires_grad=False)
        self.mrcnn_mask_deconv.bias = nn.Parameter(torch.zeros(channels), requires_grad=False)
        self.mrcnn_mask = Conv(channels, num_classes, 1)

    def _int8_trunk(self, x: torch.Tensor, dtype: torch.dtype,
                    in_scale: Optional[torch.Tensor]) -> torch.Tensor:
        """The four trunk convs on int8 NHWC ``x`` (quantized with
        ``in_scale``; float ``x`` is quantized here at conv 1's scale), each
        with its BatchNorm and ReLU in the conv's epilogue; convs 1-3 write
        int8 at the next conv's ``act_scale``, conv 4 the compute dtype. The
        ops and roundings of BatchNorm, ReLU and ``quantize_nchw`` after each
        conv, so the result is the unfused chain's. Returns NCHW."""
        m = self._modules
        convs = [m[f"mrcnn_mask_conv{i}"] for i in range(1, 5)]
        scale = in_scale
        if in_scale is None:
            scale = convs[0].act_scale
            x = Q.quantize_act(x.to(dtype), scale).contiguous()
        out_scales = [conv.act_scale for conv in convs[1:]] + [None]
        for i, (conv, out_scale) in enumerate(zip(convs, out_scales), start=1):
            x = conv.fused(x, scale, bn=m[f"mrcnn_mask_bn{i}"].folded(), relu=True,
                           out_scale=out_scale)
            scale = out_scale
        return Q.nchw(x)

    def forward(self, pooled: torch.Tensor, class_ids: Optional[torch.Tensor],
                dtype: torch.dtype, in_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
        """pooled [B, R, 14, 14, C]: float, or int8 with its ``in_scale``."""
        b, r, ph, pw, c = pooled.shape
        x = pooled.reshape(b * r, ph, pw, c)
        if self.quant is not None and not Q.calibrating():
            x = self._int8_trunk(x, dtype, in_scale)
        else:  # float, or calibrating (a float pooled tensor)
            x = x.permute(0, 3, 1, 2).to(dtype).contiguous(memory_format=torch.channels_last)
            for i in range(1, 5):
                x = self._modules[f"mrcnn_mask_conv{i}"](x)
                x = F.relu(self._modules[f"mrcnn_mask_bn{i}"](x))
        d = self.mrcnn_mask_deconv
        x = F.relu(F.conv_transpose2d(x, d.weight.to(dtype), d.bias.to(dtype), stride=2))
        x = x.to(torch.float32)
        kernel = self.mrcnn_mask.weight[:, :, 0, 0].to(x.dtype)  # [K, C]
        bias = self.mrcnn_mask.bias
        if class_ids is None:
            logits = torch.einsum("nchw,kc->nhwk", x, kernel) + bias
            return torch.sigmoid(logits).reshape(b, r, 2 * ph, 2 * pw, -1)
        ids = class_ids.reshape(b * r).to(torch.int64)
        logits = torch.einsum("nchw,nc->nhw", x, kernel[ids]) + bias[ids][:, None, None]
        return torch.sigmoid(logits).reshape(b, r, 2 * ph, 2 * pw)
