"""Data of the serving path: image decoding, molding and unmolding, masks,
and the COCO class names."""

from objectdetection_torch.data.preprocess import (  # noqa: F401
    ImageMeta,
    mold_image_device,
    mold_image_host,
    unmold_detections,
)
