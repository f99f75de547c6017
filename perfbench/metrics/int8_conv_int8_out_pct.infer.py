"""Share of the int8 conv kernel's launches whose epilogue wrote int8: 100 ×
the program's counter ``int8_conv.int8_out`` over ``int8_conv.launches``
(``ops/int8_conv.py``), summed over the traced calls. A program without the
kernel records neither, and the metric is left out."""

from perfbench.spans import counter, install  # noqa: F401  (install: the recorder)

LAYER = "backbone"
UNIT = "%"
SOURCE = "program_counter"
MOVES = "images_per_s"


def read(ctx):
    launches = counter(ctx, "int8_conv.launches")
    if not launches:
        return None
    return 100.0 * (counter(ctx, "int8_conv.int8_out") or 0) / launches
