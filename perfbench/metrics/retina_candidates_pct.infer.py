"""Share of RetinaNet's decode slots that hold a candidate: 100 × the
program's counter ``retina_decode.candidates`` (the (anchor, class) pairs
over the score threshold within each level's top 1000, kept into NMS) over
``retina_decode.slots`` (B × the levels' caps, 5 × 1000), summed over the
traced calls. A program without the counters leaves the metric out."""

from perfbench.spans import counter, install  # noqa: F401  (install: the recorder)

LAYER = "heads"
UNIT = "%"
SOURCE = "program_counter"
MOVES = "images_per_s"


def read(ctx):
    slots, found = counter(ctx, "retina_decode.slots"), counter(ctx, "retina_decode.candidates")
    if not slots or found is None:
        return None
    return 100.0 * found / slots
