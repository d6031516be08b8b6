"""Share of a traced stretch's device-table hits that the sorted segment sum
takes, %: the program's counters ``sparse_update.fused_hits`` over
``sparse_update.hits`` (``train/optim.py``: every hit of the device tables
that reaches an update on the card, and those that ``csrc/sparse_adagrad.cu``
updates).  None where the program counts no hits: an older program, a CPU
run, a scoring run."""

from benchmark import program_spans


def read(ctx):
    c = program_spans.counters(ctx) if ctx.train else None
    if not c or not c.get("sparse_update.hits"):
        return None
    return 100.0 * c.get("sparse_update.fused_hits", 0) / \
        c["sparse_update.hits"]
