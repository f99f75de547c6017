"""Data of the port: image decoding, molding and unmolding, masks, the
synthetic shapes dataset and its rasterizer, the COCO reader, and the
batch prefetcher."""

from objectdetection_torch.data.preprocess import (  # noqa: F401
    ImageMeta,
    mold_image_device,
    mold_image_host,
    unmold_detections,
)
