"""Device-idle ms a traced step in the gaps the program names
``sparse_update``: the device tables' updates (``train/train.py``, the
small tables' and the deferred big tables'), their dedup left out."""

from benchmark import program_spans


def read(ctx):
    if not ctx.train:
        return None
    return program_spans.idle_ms(ctx, program_spans.named(["sparse_update"]))
