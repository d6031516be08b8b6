"""Process start to the first timed step, s: loading, drawing the weights
and the pool, building the kernels, the check's first steps, warm-up."""


def read(ctx):
    return ctx.setup_s
