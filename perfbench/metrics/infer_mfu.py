"""Share of the card's peak that a whole inference call reaches: every
counted operation of the call (perfbench/counts.py: backbone, FPN, RPN
head, box and mask heads) at its arithmetic's peak, over the traced
seconds a batch."""

from perfbench.counts import seconds_at_peak

LAYER = "whole call"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "images_per_s"


def read(ctx):
    at_peak = seconds_at_peak(ctx.system.counts(ctx.batch))
    return 100.0 * at_peak / (ctx.trace.window_s / ctx.batches)
