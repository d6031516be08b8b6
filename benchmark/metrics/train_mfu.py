"""The whole training step's share of the f32 peak, %: model FLOPs of a step
(forward, backward at twice it) times the window's steps over its time."""

from benchmark import readers


def read(ctx):
    return readers.mfu(ctx) if ctx.train else None
