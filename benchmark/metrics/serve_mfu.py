"""The whole scoring forward's share of the f32 peak, %: model FLOPs of a
batch times the window's batches over its time."""

from benchmark import readers


def read(ctx):
    return None if ctx.train else readers.mfu(ctx)
