"""Share of its roofline that the backbone reaches: the necessary
operations of the ResNet-FPN's convolutions (perfbench/counts.py, from
shapes), each at the peak of the arithmetic it runs in, over
``backbone_ms.infer``. It reads the same work whatever kernel runs the
convolutions."""

from perfbench.counts import seconds_at_peak
from perfbench.timing import backbone_ms

LAYER = "backbone"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "images_per_s"


def read(ctx):
    at_peak = seconds_at_peak(ctx.system.counts(ctx.batch), ["backbone"])
    return 100.0 * at_peak * 1e3 / backbone_ms(ctx)
