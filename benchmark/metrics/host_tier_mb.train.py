"""MB a traced step that the host tier's kernels move over PCIe, from
the program's counters ``host_tier.gather_bytes`` and
``host_tier.update_bytes`` (``parallel/host_tier.py``: a row a hit, an
update's row read and written back; tables and accumulator)."""

from benchmark import program_spans


def read(ctx):
    if not ctx.train:
        return None
    b = program_spans.counter_sum(ctx, ("host_tier.gather_bytes",
                                        "host_tier.update_bytes"))
    return None if b is None else b / 1e6
