"""ms a batch of the program's span ``odtorch.retina_nms`` (RetinaNet's
class-aware NMS over the merged levels and the gather of the output rows):
the mean device extent over the traced calls."""

from perfbench.spans import install, span_ms  # noqa: F401  (install: the recorder)

LAYER = "heads"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "images_per_s"


def read(ctx):
    return span_ms(ctx, "odtorch.retina_nms")
