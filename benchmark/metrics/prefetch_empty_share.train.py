"""Share of the traced stretch's takes from ``device_prefetch`` that found
no batch queued, %: the program's counters ``prefetch.empty`` over
``prefetch.takes`` (``data/prefetch.py``, counted by the consumer)."""

from benchmark import program_spans


def read(ctx):
    c = program_spans.counters(ctx) if ctx.train else None
    if not c or not c.get("prefetch.takes"):
        return None
    return 100.0 * c.get("prefetch.empty", 0) / c["prefetch.takes"]
