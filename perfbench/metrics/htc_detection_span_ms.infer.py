"""ms a batch of the program's span ``odtorch.htc_detection`` (Hybrid Task
Cascade's detection: the stages' mean logits and softmax, the per-class NMS
over B × 80 problems of 1000 rows on B2, the best 100 an image): the mean
device extent over the traced calls."""

from perfbench.spans import install, span_ms  # noqa: F401  (install: the recorder)

LAYER = "heads"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "images_per_s"


def read(ctx):
    return span_ms(ctx, "odtorch.htc_detection")
