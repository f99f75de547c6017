"""Visualize RPN anchor assignment on synthetic shapes, with the PyTorch port.

    python examples/torch_visualize_rpn_targets.py --out /tmp/rpn_targets.png
    python examples/torch_visualize_rpn_targets.py --device cpu --out /tmp/rpn_targets.png

The port of ``examples/visualize_rpn_targets.py``: GT boxes against the
positive and negative anchors that ``layers.targets.rpn_targets`` (the
anchor-match kernel on the card) chooses for one shapes image, drawn by
``viz.draw_anchor_assignment`` and written as PNG by ``image_io.encode_png``.
The balancing subsample draws from ``torch.Generator(device).manual_seed(0)``.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from objectdetection_torch import viz  # noqa: E402
from objectdetection_torch.anchors import config_anchors  # noqa: E402
from objectdetection_torch.config import SHAPES_CONFIG  # noqa: E402
from objectdetection_torch.convert import resolve_device  # noqa: E402
from objectdetection_torch.data.image_io import encode_png  # noqa: E402
from objectdetection_torch.data.shapes import ShapesDataset  # noqa: E402
from objectdetection_torch.layers.targets import rpn_targets  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out", default="rpn_targets.png")
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; raises without a card)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = SHAPES_CONFIG
    ds = ShapesDataset(1, 128, 128, seed=args.seed)
    batch = ds.load_batch([0], cfg, with_masks=False)

    anchors_norm = config_anchors(cfg)
    gt_valid = batch.gt_class_ids[0] > 0
    tgt = rpn_targets(
        torch.from_numpy(anchors_norm).to(dev),
        torch.from_numpy(batch.gt_boxes[:1]).to(dev),
        torch.from_numpy(gt_valid[None]).to(dev),
        cfg,
        generator=torch.Generator(device=dev).manual_seed(0),
    )
    target_class = tgt.target_class[0].cpu().numpy()

    h = cfg.image_shape[0]
    scale = np.array([h - 1, h - 1, h - 1, h - 1], np.float32)
    shift = np.array([0, 0, 1, 1], np.float32)
    anchors_pix = anchors_norm * scale + shift
    gt_pix = batch.gt_boxes[0][gt_valid] * scale + shift

    img = viz.draw_anchor_assignment(ds.image(0), anchors_pix, target_class, gt_pix)
    with open(args.out, "wb") as f:
        f.write(encode_png(img))
    n_pos = int(np.sum(target_class == 1))
    n_neg = int(np.sum(target_class == -1))
    print(f"wrote {args.out}: {n_pos} positive, {n_neg} negative anchors")


if __name__ == "__main__":
    main()
