"""ms a batch of the program's span ``odtorch.box_stage`` (ROIAlign 7² and the
box/class head): the mean device extent over the traced calls."""

from perfbench.spans import install, span_ms  # noqa: F401  (install: the recorder)

LAYER = "heads"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "images_per_s"


def read(ctx):
    return span_ms(ctx, "odtorch.box_stage")
