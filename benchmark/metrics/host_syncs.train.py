"""The CUDA runtime's synchronizing calls (stream, device, event) a
traced step, the benchmark's own read of the loss and closing synchronize
left out: each blocks the host until the device drains (the dedup's
``unique`` reads its length back, ``ops/embedding.py``)."""

from benchmark import program_spans


def read(ctx):
    return program_spans.host_syncs(ctx) if ctx.train else None
