"""Device-idle ms a traced step in the gaps the backward names: any
``*.bwd`` span, the stages' (``loss.bwd``, ``top_mlp.bwd``,
``interaction.bwd``, ``bottom_mlp.bwd``, ``models/dlrm.py``) on the thread
that runs them, and the caller's ``autograd.bwd`` around the engine."""

from benchmark import program_spans


def read(ctx):
    if not ctx.train:
        return None
    return program_spans.idle_ms(ctx, lambda s: s.endswith(".bwd"))
