"""The device tables' lookup and update (``ops/embedding.py``): the bytes
these ids need (``counts.table_bytes``) at the HBM rate over the time of
the index operations on the tables and their accumulators, %."""

from benchmark import readers


def read(ctx):
    return readers.embedding(ctx) if not ctx.train else None
