"""The interaction kernels (``csrc/interaction_{fwd,bwd}.cu``): the sum
of their bounds (``counts.interaction_bound_s``) over their time, %."""

from benchmark import readers


def read(ctx):
    return readers.interaction(ctx) if not ctx.train else None
