"""Share of the backbone's float convs whose epilogue ran as one pass: 100 ×
the program's counter ``conv_epilogue.launches`` (``ops/conv_epilogue.py``)
over ``backbone.float_convs`` (every float conv of ResNetFPN in inference,
``models/backbone.float_conv``), summed over the traced calls. A program
that records no float convs (the int8 network, or a program without the
counter) leaves the metric out."""

from perfbench.spans import counter, install  # noqa: F401  (install: the recorder)

LAYER = "backbone"
UNIT = "%"
SOURCE = "program_counter"
MOVES = "images_per_s"


def read(ctx):
    convs = counter(ctx, "backbone.float_convs")
    if not convs:
        return None
    return 100.0 * (counter(ctx, "conv_epilogue.launches") or 0) / convs
