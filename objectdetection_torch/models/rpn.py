"""Region Proposal Network head, float and int8.

Port of ``objectdetection_tpu.models.rpn.RPNHead``: a shared 3×3 conv(512) +
relu, then 1×1 convs giving 2·k class logits and 4·k box deltas per location.
Each level's output is permuted to NHWC before the reshape, so rows follow
the (level, y, x, anchor) order of ``anchors.config_anchors``.

Quantized (``quant`` given), every conv is a QuantConv. One activation scale
serves the shared conv's input over all levels, and ``shared_scale``
quantizes its relu'd output once per level for both 1×1 heads, which run
as one int8 conv of 2k + 4k outputs (``ops.int8_conv``): their kernels,
per-channel scales and biases concatenate on the output axis, so the sums
are those of two convs.
``return_quantized_inputs`` also returns the int8 P-levels the shared conv
quantized (with its input ``act_scale``), which ROIAlign can read
(``int8_align_inputs``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from objectdetection_torch import quant as Q
from objectdetection_torch.models.backbone import Quant, make_conv
from objectdetection_torch.ops import int8_conv


class RPNHead(nn.Module):
    def __init__(self, anchors_per_location: int = 3, anchor_stride: int = 1,
                 cin: int = 256, channels: int = 512, quant: Optional[Quant] = None):
        super().__init__()
        k = anchors_per_location
        self.k = k
        self.quant = quant
        self.rpn_conv_shared = make_conv(quant, cin, channels, 3, stride=anchor_stride)
        self.rpn_class_raw = make_conv(quant, channels, 2 * k, 1)
        self.rpn_bbox_pred = make_conv(quant, channels, 4 * k, 1)
        if quant is not None:
            self.register_buffer("shared_scale", torch.zeros(channels) if quant.per_channel
                                 else torch.zeros(()))

    def _fused_head(self):
        """(int8 kernel [6k, C, 1, 1], post-scale [6k], bias [6k]) of the two
        1×1 heads as one conv on the int8 shared tensor."""
        s = self.shared_scale
        heads = (self.rpn_class_raw, self.rpn_bbox_pred)
        parts = [c._qparams(s) for c in heads]
        k8 = torch.cat([p[0] for p in parts])
        post = heads[0]._post(s, torch.cat([p[1] for p in parts]))
        bias = torch.cat([c.bias for c in heads])
        return k8, post, bias

    def forward(self, feature_maps: Sequence[torch.Tensor],
                return_quantized_inputs: bool = False):
        """NCHW levels → logits [B, A, 2], probs [B, A, 2], deltas [B, A, 4]
        (f32), plus ``(int8 NHWC levels, scale)`` (None off the int8 path)
        with ``return_quantized_inputs``."""
        q = self.quant
        int8_infer = q is not None and not Q.calibrating()
        if int8_infer:
            k8f, post, bias_f = self._fused_head()
        logits_all, deltas_all, x8_levels = [], [], []
        in_scale = None
        for fm in feature_maps:
            if int8_infer and return_quantized_inputs:
                y, (x8, in_scale) = self.rpn_conv_shared(fm, return_x8=True)
                x8_levels.append(x8)
            else:
                y = self.rpn_conv_shared(fm)
            shared = F.relu(y)
            b = shared.shape[0]
            if int8_infer:
                s8 = Q.quantize_nchw(shared, self.shared_scale)
                y = int8_conv.int8_conv_fused(s8, k8f, post, bias_f, dtype=q.dtype)
                logits, deltas = y[..., : 2 * self.k], y[..., 2 * self.k:]
            else:
                if q is not None:  # calibration: one range over all levels
                    Q._record(self.shared_scale, shared, 1)
                logits = self.rpn_class_raw(shared).permute(0, 2, 3, 1)
                deltas = self.rpn_bbox_pred(shared).permute(0, 2, 3, 1)
            logits_all.append(logits.reshape(b, -1, 2))
            deltas_all.append(deltas.reshape(b, -1, 4))
        logits = torch.cat(logits_all, dim=1).to(torch.float32)
        deltas = torch.cat(deltas_all, dim=1).to(torch.float32)
        probs = torch.softmax(logits, dim=-1)
        if return_quantized_inputs:
            return logits, probs, deltas, ((x8_levels, in_scale) if int8_infer else None)
        return logits, probs, deltas
