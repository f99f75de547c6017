"""Library quickstart of the PyTorch port: train briefly on shapes, then run
inference.

    python examples/torch_quickstart.py                # on the card
    python examples/torch_quickstart.py --device cpu   # on the CPU (~1 min)

The port of ``examples/quickstart.py``: five training steps of
``SHAPES_CONFIG`` with masks (the budgets cut to 512 → 128 proposals, 16
sampled ROIs an image), then inference with masks on two held-out images.
The step's target noise comes from ``torch.Generator(device).manual_seed(i)``.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from objectdetection_torch import detector  # noqa: E402
from objectdetection_torch.config import SHAPES_CONFIG  # noqa: E402
from objectdetection_torch.convert import resolve_device  # noqa: E402
from objectdetection_torch.data.shapes import ShapesDataset  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; raises without a card)")
    dev = resolve_device(p.parse_args(argv).device)
    cfg = SHAPES_CONFIG.replace(
        pre_nms_rois_count=512, post_nms_rois_training=128,
        post_nms_rois_inference=64, train_rois_per_image=16,
    )

    # --- training: five steps, optimizer included ---------------------------
    ds = ShapesDataset(16, 128, 128, seed=0)
    state = detector.create_train_state(cfg, torch.Generator().manual_seed(0), device=dev)
    step = detector.make_train_step(cfg, with_masks=True, device=dev)
    for i in range(5):
        batch = ds.load_batch([2 * i, 2 * i + 1], cfg, with_masks=True)
        state, metrics = step(state, batch, torch.Generator(device=dev).manual_seed(i))
        print(f"step {i}: total_loss={float(metrics['total_loss']):.3f}")

    # --- inference: boxes + classes + masks ---------------------------------
    params = {**state.params, **state.batch_stats}
    infer = detector.make_infer_fn(cfg, with_masks=True, device=dev)
    batch = ds.load_batch([10, 11], cfg, with_masks=False)
    windows = np.tile(np.asarray([[0.0, 0.0, 128.0, 128.0]], np.float32), (2, 1))
    det = infer(params, batch.images, windows)
    for b in range(2):
        n = int(det.valid[b].sum())
        print(f"image {b}: {n} detections, mask grid {tuple(det.masks.shape[2:])} each")


if __name__ == "__main__":
    main()
