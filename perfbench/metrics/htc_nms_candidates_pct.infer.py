"""Share of Hybrid Task Cascade's (ROI, class) pairs that enter its
per-class NMS: 100 × the program's counter ``htc_detection.candidates``
(the pairs of a proposal over the score threshold, 0.001) over
``htc_detection.slots`` (B × 1000 ROIs × 80 classes), summed over the
traced calls. A program without the counters leaves the metric out."""

from perfbench.spans import counter, install  # noqa: F401  (install: the recorder)

LAYER = "heads"
UNIT = "%"
SOURCE = "program_counter"
MOVES = "images_per_s"


def read(ctx):
    slots, found = counter(ctx, "htc_detection.slots"), counter(ctx, "htc_detection.candidates")
    if not slots or found is None:
        return None
    return 100.0 * found / slots
