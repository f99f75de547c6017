"""Share of their roofline that Hybrid Task Cascade's three mask heads
reach: the counted operations of the heads (the system's ``counts``, layer
``mask_heads``: each head's ``conv_res``, four 3×3 convs and transposed
conv in bf16, the detected class's output in f32), each at the peak of its
arithmetic, over ``htc_mask_stages_span_ms.infer``, the device ms of the
program's span ``odtorch.htc_mask_stages`` (which also holds the stage's
ROIAlign and the sigmoid mean). Nothing to read without that span."""

from perfbench.counts import seconds_at_peak
from perfbench.spans import install, span_ms  # noqa: F401  (install: the recorder)

LAYER = "heads"
UNIT = "%"
SOURCE = "program_span"
MOVES = "images_per_s"


def read(ctx):
    ms = span_ms(ctx, "odtorch.htc_mask_stages")
    if not ms:
        return None
    return 100.0 * seconds_at_peak(ctx.system.counts(ctx.batch), ["mask_heads"]) * 1e3 / ms
