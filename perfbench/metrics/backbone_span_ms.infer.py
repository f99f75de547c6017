"""ms a batch of the program's own span ``odtorch.backbone`` (input scale and
cast, the ResNet-FPN to P2-P6, the NHWC views): the mean device extent of
its CUDA events over the traced calls."""

from perfbench.spans import install, span_ms  # noqa: F401  (install: the recorder)

LAYER = "backbone"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "images_per_s"


def read(ctx):
    return span_ms(ctx, "odtorch.backbone")
