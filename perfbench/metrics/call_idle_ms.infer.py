"""Device-idle ms a batch inside the program's call: the idle gaps of the
traced window (``perfbench.trace.gaps``) intersected with the host
intervals of the program's span ``odtorch.infer`` on the profiler's
timeline, over the traced calls. The idle that the program's own host work
causes, apart from the caller's (the copy of the outputs, the loop)."""

from perfbench.spans import install  # noqa: F401  (the recorder: turns the spans on)
from perfbench.trace import gaps

LAYER = "whole call"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "images_per_s"


def read(ctx):
    calls = [(i.start, i.end) for i in ctx.trace.host if i.name == "odtorch.infer"]
    if not calls or not ctx.batches:
        return None
    idle_us = sum(max(0.0, min(g1, c1) - max(g0, c0)) for g0, g1 in gaps(ctx.trace)
                  for c0, c1 in calls)
    return idle_us / 1e3 / ctx.batches
