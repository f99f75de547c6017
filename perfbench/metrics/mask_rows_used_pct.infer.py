"""Share of the mask stage's rows that hold a detection: 100 × the
program's counter ``mask_stage.valid`` (scores above 0) over
``mask_stage.rows`` (every detection slot the stage ran), summed over the
traced calls."""

from perfbench.spans import counter, install  # noqa: F401  (install: the recorder)

LAYER = "heads"
UNIT = "%"
SOURCE = "program_counter"
MOVES = "images_per_s"


def read(ctx):
    rows, valid = counter(ctx, "mask_stage.rows"), counter(ctx, "mask_stage.valid")
    if not rows or valid is None:
        return None
    return 100.0 * valid / rows
