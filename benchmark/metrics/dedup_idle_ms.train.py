"""Device-idle ms a traced step in the gaps the program names ``dedup``:
``ops/embedding.sum_duplicates`` (``unique``, which reads its length back to
the host, and the duplicates' sum), for every table and both tiers."""

from benchmark import program_spans


def read(ctx):
    if not ctx.train:
        return None
    return program_spans.idle_ms(ctx, program_spans.named(["dedup"]))
