"""VGG16 convolutional backbone of the Faster R-CNN family.

Port of ``objectdetection_tpu.models.vgg16``: conv1_1..conv5_3 (3×3, flax
``"SAME"``, relu) with a 2×2/2 max pool after each of the first four blocks
and none after conv5, giving a stride-16 map ([B, 512, 14, 14] from 224²).
Pools pad as flax's ``"SAME"`` does: an odd side gets one row or column of
-inf on its high end (75 → 38 at 600×1000). Module names are the flax scope
names (``conv1_1`` ...), so a converted flax tree loads by name.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from objectdetection_torch.models.backbone import Conv, max_pool_same

VGG16_LAYOUT = (
    ("conv1", (64, 64)),
    ("conv2", (128, 128)),
    ("conv3", (256, 256, 256)),
    ("conv4", (512, 512, 512)),
    ("conv5", (512, 512, 512)),
)


class VGG16(nn.Module):
    """NCHW images → NCHW stride-16 features, computed in ``dtype``."""

    def __init__(self, dtype: torch.dtype = torch.float32, cin: int = 3):
        super().__init__()
        self.dtype = dtype
        for block, widths in VGG16_LAYOUT:
            for ci, width in enumerate(widths):
                self.add_module(f"{block}_{ci + 1}", Conv(cin, width, 3))
                cin = width

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        for bi, (block, widths) in enumerate(VGG16_LAYOUT):
            for ci in range(len(widths)):
                x = F.relu(self._modules[f"{block}_{ci + 1}"](x))
            if bi < 4:  # no pool after conv5
                x = max_pool_same(x, k=2, s=2)
        return x


def load_vgg_imagenet_npy(npy_path: str,
                          state_dict: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Fill the VGG16 leaves of ``state_dict`` from a ``VGG_imagenet.npy``
    (a pickled dict keyed ``conv1_1_W`` / ``conv1_1_b``, HWIO kernels).

    ``state_dict`` is a :class:`VGG16`'s or a whole Faster R-CNN's (its
    leaves under ``vgg16.``). The leaves of each layer the file names are
    replaced (kernels relaid to OIHW, f32, on the leaf's device); every other
    leaf is kept. Returns a new dict.
    """
    weights = np.load(npy_path, encoding="latin1", allow_pickle=True).item()
    prefix = "vgg16." if any(k.startswith("vgg16.") for k in state_dict) else ""
    out = dict(state_dict)
    for block, widths in VGG16_LAYOUT:
        for ci in range(len(widths)):
            name = f"{block}_{ci + 1}"
            kernel = weights.get(f"{name}_W")
            if kernel is None:
                continue
            w_key, b_key = f"{prefix}{name}.weight", f"{prefix}{name}.bias"
            dev = out[w_key].device
            out[w_key] = torch.from_numpy(np.ascontiguousarray(
                np.asarray(kernel, np.float32).transpose(3, 2, 0, 1))).to(dev)
            out[b_key] = torch.from_numpy(np.asarray(weights[f"{name}_b"], np.float32)).to(dev)
    return out
