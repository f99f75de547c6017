"""Region Proposal Network head, float path.

Port of ``objectdetection_tpu.models.rpn.RPNHead``: a shared 3×3 conv(512) +
relu, then 1×1 convs giving 2·k class logits and 4·k box deltas per location.
Each level's output is permuted to NHWC before the reshape, so rows follow
the (level, y, x, anchor) order of ``anchors.config_anchors``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from objectdetection_torch.models.backbone import Conv


class RPNHead(nn.Module):
    def __init__(self, anchors_per_location: int = 3, anchor_stride: int = 1,
                 cin: int = 256, channels: int = 512):
        super().__init__()
        k = anchors_per_location
        self.rpn_conv_shared = Conv(cin, channels, 3, stride=anchor_stride)
        self.rpn_class_raw = Conv(channels, 2 * k, 1)
        self.rpn_bbox_pred = Conv(channels, 4 * k, 1)

    def forward(self, feature_maps: Sequence[torch.Tensor]):
        """NCHW levels → logits [B, A, 2], probs [B, A, 2], deltas [B, A, 4] (f32)."""
        logits_all, deltas_all = [], []
        for fm in feature_maps:
            shared = F.relu(self.rpn_conv_shared(fm))
            b = shared.shape[0]
            logits = self.rpn_class_raw(shared).permute(0, 2, 3, 1)
            deltas = self.rpn_bbox_pred(shared).permute(0, 2, 3, 1)
            logits_all.append(logits.reshape(b, -1, 2))
            deltas_all.append(deltas.reshape(b, -1, 4))
        logits = torch.cat(logits_all, dim=1).to(torch.float32)
        deltas = torch.cat(deltas_all, dim=1).to(torch.float32)
        probs = torch.softmax(logits, dim=-1)
        return logits, probs, deltas
