"""PyTorch/CUDA port of the detectors in ``objectdetection_tpu``.

Three families on an NVIDIA Hopper card, each served and trained:

- Mask R-CNN (ResNet + FPN): ``detector.make_infer_fn`` and
  ``detector.make_train_step``, the server (``serve``) and the commands
  (``cli``);
- Faster R-CNN (VGG16, ZF anchors): ``models.faster_rcnn.make_infer_fn``
  and ``faster_rcnn_train.make_train_step``;
- RetinaNet (ResNet + FPN): ``models.retinanet.make_infer_fn`` and
  ``models.retinanet.make_retinanet_train_step``.

Mask R-CNN also runs data- and tensor-parallel on ``torch.distributed``
(``parallel``: one process a device, NCCL on the card), and ``cli
eval-coco --data-parallel`` evaluates that way.

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
)
