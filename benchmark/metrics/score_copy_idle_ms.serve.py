"""Device-idle ms a traced batch in the gaps the program names
``score_batch.h2d`` (the batch's two copies to the card) or
``score_batch.readback`` (the scores' copy back), ``run.score_batch``."""

from benchmark import program_spans


def read(ctx):
    if ctx.train:
        return None
    return program_spans.idle_ms(ctx, program_spans.named(
        ["score_batch.h2d", "score_batch.readback"]))
