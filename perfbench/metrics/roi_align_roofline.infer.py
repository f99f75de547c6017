"""Share of its roofline that the forward ROIAlign kernel of
``csrc/roi_align.cu`` reaches: the byte bound of each call the traced
window made (perfbench/counts.py ``roi_align_bound_s``, at the boxes the
program passed), over the device seconds of the ``roi_align_kernel``
launches in the trace. Nothing to read where no such kernel ran.

:func:`install` records each pyramid ROIAlign call of the traced window:
it wraps the program's ``batched_multilevel_roi_align`` while the window
lasts and keeps the call's shapes and a copy of its boxes."""

import contextlib

from perfbench.counts import roi_align_bound_s
from perfbench.trace import kernel_seconds

LAYER = "kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "images_per_s"


@contextlib.contextmanager
def install(ctx):
    from objectdetection_torch.ops import roi_align

    calls = ctx.memo.setdefault("roi_align_calls", [])
    original = roi_align.batched_multilevel_roi_align

    def recorded(features, boxes, image_shape, crop_size, out_quant=None, in_scale=None):
        out = original(features, boxes, image_shape, crop_size, out_quant, in_scale)
        calls.append({
            "level_hw": [tuple(f.shape[1:3]) for f in list(features)[:4]],
            "channels": int(features[0].shape[-1]), "boxes": boxes.detach().clone(),
            "image_hw": tuple(image_shape), "crop": tuple(crop_size),
            "in_bytes": features[0].element_size(), "out_bytes": out.element_size(),
            "map_bytes": 0 if out_quant is None else out_quant.numel() * 4})
        return out

    roi_align.batched_multilevel_roi_align = recorded
    try:
        yield
    finally:
        roi_align.batched_multilevel_roi_align = original


def read(ctx):
    calls = ctx.memo.get("roi_align_calls")
    device_s, launches = kernel_seconds(ctx.trace, lambda n: "roi_align_kernel" in n)
    if not calls or not launches or device_s <= 0:
        return None
    bound = sum(roi_align_bound_s(c["level_hw"], c["channels"], c["boxes"], c["image_hw"],
                                  c["crop"], c["in_bytes"], c["out_bytes"], c["map_bytes"])
                for c in calls)
    return 100.0 * bound / device_s
