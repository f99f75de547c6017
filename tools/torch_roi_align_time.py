"""Device time of the port's float ROIAlign kernels in one checkout.

Times ``batched_multilevel_roi_align`` (bf16 and f32) and
``roi_align_backward`` (bf16) at the COCO pyramid (B = 2, C = 256) for the
box stage (1000 ROIs, 7x7) and the mask stage (100 ROIs, 14x14), with
``chip_smoke.device_ms`` (torch.profiler), and prints one line of JSON.
The checkout is the one at ROOT (default: this repository), so two versions
of the kernels are compared on one card by running this script on each in
turns, in one command:

    for r in OLD . . OLD; do python3 tools/torch_roi_align_time.py $r; done

Needs a CUDA card.
"""

import json
import sys
from pathlib import Path

ROOT = sys.argv[1] if len(sys.argv) > 1 else str(Path(__file__).resolve().parents[1])
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from chip_smoke import device_ms, roi_boxes  # noqa: E402
from objectdetection_torch.config import COCO_CONFIG as cfg  # noqa: E402
from objectdetection_torch.ops import roi_align  # noqa: E402


def main():
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(2)
    image = tuple(cfg.image_shape[:2])
    f32 = [torch.randn(2, h, w, cfg.fpn_channels, generator=gen).to(dev)
           for h, w in cfg.feature_shapes()[:4]]
    f16 = [f.to(torch.bfloat16) for f in f32]
    res = {}
    for name, r, crop in (("box", 1000, cfg.pool_shape), ("mask", 100, cfg.mask_pool_shape)):
        boxes = roi_boxes(gen, r, dev)
        for tag, feats in (("bf16", f16), ("f32", f32)):
            res[f"{name} {tag}"] = device_ms(
                lambda: roi_align.batched_multilevel_roi_align(feats, boxes, image, crop), 50)
        g = torch.randn(2, r, *crop, cfg.fpn_channels, generator=gen).to(dev, torch.bfloat16)
        shapes = [tuple(f.shape) for f in f16]
        res[f"{name} grad bf16"] = device_ms(
            lambda: roi_align.roi_align_backward(g, boxes, shapes, image), 20)
    print(json.dumps({"root": ROOT, "card": torch.cuda.get_device_name(0), **res}))


if __name__ == "__main__":
    main()
