"""ms a batch of the program's span ``odtorch.htc_box_stages`` (Hybrid Task
Cascade's three box stages: each stage's ROIAlign 7² over P2..P5 and 14² over
the semantic feature, the average pool, the box head, and the decode and clip
that give the next stage its ROIs): the mean device extent over the traced
calls."""

from perfbench.spans import install, span_ms  # noqa: F401  (install: the recorder)

LAYER = "heads"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "images_per_s"


def read(ctx):
    return span_ms(ctx, "odtorch.htc_box_stages")
