"""Share of their roofline that RetinaNet's subnets reach: the counted
operations of their convs (the system's ``counts``, layer ``subnets``: the
3×3 convs in bf16, the output convs in TF32), each at the peak of its
arithmetic, over ``subnets_span_ms.infer``, the device ms of the program's
span ``odtorch.retina_subnets``. Nothing to read without that span."""

from perfbench.counts import seconds_at_peak
from perfbench.spans import install, span_ms  # noqa: F401  (install: the recorder)

LAYER = "heads"
UNIT = "%"
SOURCE = "program_span"
MOVES = "images_per_s"


def read(ctx):
    ms = span_ms(ctx, "odtorch.retina_subnets")
    if not ms:
        return None
    return 100.0 * seconds_at_peak(ctx.system.counts(ctx.batch), ["subnets"]) * 1e3 / ms
