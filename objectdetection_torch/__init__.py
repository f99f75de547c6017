"""PyTorch/CUDA port of the detectors in ``objectdetection_tpu``.

Four families on an NVIDIA Hopper card, three of them served and trained:

- Mask R-CNN (ResNet + FPN): ``detector.make_infer_fn`` and
  ``detector.make_train_step``, the server (``serve``) and the commands
  (``cli``);
- Faster R-CNN (VGG16, ZF anchors): ``models.faster_rcnn.make_infer_fn``
  and ``faster_rcnn_train.make_train_step``;
- RetinaNet (ResNet + FPN): ``models.retinanet.make_infer_fn`` and
  ``models.retinanet.make_retinanet_train_step``; the JAX package's head
  on a ``DetectorConfig``, the published one (P3–P7, 9 anchors a location,
  the per-level decode) on a ``RetinaNetConfig``;
- Hybrid Task Cascade (ResNet + FPN, three box and mask stages, the
  semantic branch): ``models.htc.make_infer_fn`` on an ``HTCConfig``,
  served only.

Mask R-CNN also runs data- and tensor-parallel on ``torch.distributed``
(``parallel``: one process a device, NCCL on the card), and ``cli
eval-coco --data-parallel`` evaluates that way.
``bench`` (``python -m objectdetection_torch.bench``, ``cli bench``) is
the root ``bench.py``'s inference-throughput recipe on the card.

The NMS, ROIAlign, anchor-matching and fused int8 kernels are hand-written
CUDA under ``csrc/``, built on first use (``ops/cuda_build.py``). The
package imports torch and numpy only.
"""

__version__ = "0.1.0"

from objectdetection_torch.config import (  # noqa: F401
    COCO_CONFIG,
    SHAPES_CONFIG,
    DetectorConfig,
    FasterRCNNConfig,
    HTCConfig,
    RetinaNetConfig,
)
