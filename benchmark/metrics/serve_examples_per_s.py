"""Scoring throughput: every example scored in the window over all of
its time, host to host."""

from benchmark import readers


def read(ctx):
    return None if ctx.train else readers.rate(ctx)
