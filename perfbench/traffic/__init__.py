"""Traffic: a mix ``<traffic>.json`` holds its parameters and the ``kind``
of generator that reads them; ``<kind>.py`` has ``run(run_ctx) -> dict``,
and reads the mix's parameters, with the cell's ``params`` over them, from
``run_ctx.params``."""
