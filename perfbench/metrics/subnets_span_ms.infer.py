"""ms a batch of the program's span ``odtorch.retina_subnets`` (RetinaNet's
class and box subnets on every level P3..P7, their f32 output convs, and
the outputs laid out as [B, A, C − 1] and [B, A, 4] rows): the mean device
extent over the traced calls."""

from perfbench.spans import install, span_ms  # noqa: F401  (install: the recorder)

LAYER = "heads"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "images_per_s"


def read(ctx):
    return span_ms(ctx, "odtorch.retina_subnets")
