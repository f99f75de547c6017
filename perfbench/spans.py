"""The program's own spans and counters over the traced window, for the
readers that read them (``objectdetection_torch.metrics``: ``span``,
``count``, ``collect``).

Each such reader takes :func:`install` as its recorder. The first install
of a run enters the program's ``metrics.collect()`` over the traced window
and keeps its recording in the layer context's ``memo``; the others do
nothing. A program without ``metrics.collect`` (one that records no spans)
leaves nothing to read, and every such reader returns None.
"""

from __future__ import annotations

import contextlib

KEY = "program_spans"


def install(ctx):
    if KEY in ctx.memo:
        return contextlib.nullcontext()
    from objectdetection_torch import metrics

    collect = getattr(metrics, "collect", None)
    ctx.memo[KEY] = None
    if collect is None:
        return contextlib.nullcontext()
    return _collecting(ctx, collect)


@contextlib.contextmanager
def _collecting(ctx, collect):
    with collect(ctx.inputs[0].device) as rec:
        ctx.memo[KEY] = rec
        yield


def recording(ctx):
    """The program's resolved recording, or None where it recorded nothing."""
    rec = ctx.memo.get(KEY)
    return None if rec is None or not rec.spans else rec.resolve()


def span_ms(ctx, name: str):
    """Mean device ms of the spans ``name`` over the traced calls, or None."""
    rec = recording(ctx)
    ms = [s.device_ms for s in rec.named(name)] if rec is not None else []
    return sum(ms) / len(ms) if ms else None


def counter(ctx, name: str):
    """The counter ``name`` summed over the traced calls, or None."""
    rec = recording(ctx)
    return None if rec is None else rec.counters.get(name)
