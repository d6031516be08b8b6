"""Device-idle ms a traced step in the gaps the program names
``dense_apply``: the dense parameters' optimizer (``train/optim.py``
``apply_dense``), launched from the host one elementwise op at a time."""

from benchmark import program_spans


def read(ctx):
    if not ctx.train:
        return None
    return program_spans.idle_ms(ctx, program_spans.named(["dense_apply"]))
