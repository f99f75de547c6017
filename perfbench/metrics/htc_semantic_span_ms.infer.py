"""ms a batch of the program's span ``odtorch.htc_semantic`` (Hybrid Task
Cascade's semantic branch: P2, P4, P5 and P6 resized to P3's size, the five 1×1
laterals, the four 3×3 convs and the 1×1 embedding): the mean device extent
over the traced calls."""

from perfbench.spans import install, span_ms  # noqa: F401  (install: the recorder)

LAYER = "heads"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "images_per_s"


def read(ctx):
    return span_ms(ctx, "odtorch.htc_semantic")
