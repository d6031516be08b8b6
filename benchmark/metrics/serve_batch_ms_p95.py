"""95th percentile of every scored batch's host-to-host time, ms."""

from benchmark import readers


def read(ctx):
    if ctx.train:
        return None
    v = readers.p95(ctx.window["batch_s"])
    return None if v is None else 1e3 * v
