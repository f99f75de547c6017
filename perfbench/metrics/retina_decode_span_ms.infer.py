"""ms a batch of the program's span ``odtorch.retina_decode`` (RetinaNet's
sigmoid, each level's pairs over the score threshold and their top 1000,
the box decode and clip, the levels merged): the mean device extent over
the traced calls."""

from perfbench.spans import install, span_ms  # noqa: F401  (install: the recorder)

LAYER = "heads"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "images_per_s"


def read(ctx):
    return span_ms(ctx, "odtorch.retina_decode")
