"""Per-layer metric readers, one file a metric: ``<metric name>.py``
declares ``LAYER``, ``UNIT``, ``SOURCE`` and ``MOVES`` and has
``read(ctx) -> float | None``. It may also have ``install(ctx)``, which
returns a context manager that the traffic enters over the traced window:
a recorder of what the program does there, kept in ``ctx.memo``.

``ctx`` is the traffic's layer context: ``system`` (the program under test,
still live), ``sizes``, ``params``, ``log``, ``memo`` (a dict the readers
share), and what the traffic kind adds (``offline_batches``: ``batch``,
``inputs`` — one timed batch and its windows — ``trace`` and ``batches``,
the traced calls). A reader that finds nothing to read returns None, and
the metric is left out of the line."""
