"""Host ms a traced step inside the program's span ``prefetch.take``
(``data/prefetch.py``): the consumer's wait for the next batch and its
take of it."""

from benchmark import program_spans


def read(ctx):
    return program_spans.host_ms(ctx, "prefetch.take") if ctx.train else None
