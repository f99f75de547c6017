"""ms a batch of the program's span ``odtorch.mask_stage`` (ROIAlign 14² and the
mask head on every detection row): the mean device extent over the traced
calls. Nothing to read where the job asks for no masks."""

from perfbench.spans import install, span_ms  # noqa: F401  (install: the recorder)

LAYER = "heads"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "images_per_s"


def read(ctx):
    return span_ms(ctx, "odtorch.mask_stage")
