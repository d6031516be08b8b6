"""Kernel launches a traced step of the dense parameters' optimizer, from
the program's counter ``dense_apply.launches`` (``train/optim.py``
``apply_dense``: one a launch of the multi-tensor kernel, ten a leaf of the
per-leaf loop, two a leaf of SGD; only what runs on the card counts)."""

from benchmark import program_spans


def read(ctx):
    if not ctx.train:
        return None
    return program_spans.counter_sum(ctx, ("dense_apply.launches",))
