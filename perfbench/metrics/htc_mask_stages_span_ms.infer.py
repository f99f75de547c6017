"""ms a batch of the program's span ``odtorch.htc_mask_stages`` (Hybrid Task
Cascade's mask stage: ROIAlign 14² over P2..P5 and the semantic feature on the
detections, the three mask heads with their information flow, the mean of their
sigmoids): the mean device extent over the traced calls."""

from perfbench.spans import install, span_ms  # noqa: F401  (install: the recorder)

LAYER = "heads"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "images_per_s"


def read(ctx):
    return span_ms(ctx, "odtorch.htc_mask_stages")
