"""Training throughput: every example of the window over all of its
time, host clock."""

from benchmark import readers


def read(ctx):
    return readers.rate(ctx) if ctx.train else None
