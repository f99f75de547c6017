"""ms a batch of everything after P2-P6 (the RPN head, proposals, box
stage, detections, mask stage): the full timed call less the backbone
prefix, both by CUDA events of the benchmark's own after the window."""

from perfbench.timing import backbone_ms, call_ms

LAYER = "heads"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "images_per_s"


def read(ctx):
    return call_ms(ctx) - backbone_ms(ctx)
