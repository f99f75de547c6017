"""Share of the traced window in which no device operation ran: one minus
the union of the kernels', copies' and sets' intervals over the window."""

from perfbench.trace import union_s

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "images_per_s"


def read(ctx):
    tr = ctx.trace
    return 100.0 * (1.0 - union_s(tr.device, tr.window) / tr.window_s)
