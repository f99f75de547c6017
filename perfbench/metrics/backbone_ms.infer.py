"""ms a batch of the program's ResNet-FPN alone (to P2-P6): CUDA events of
the benchmark's own around the backbone prefix, bound as the full call
binds it, after the window (the stage tool's prefix rule)."""

from perfbench.timing import backbone_ms

LAYER = "backbone"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "images_per_s"


def read(ctx):
    return backbone_ms(ctx)
