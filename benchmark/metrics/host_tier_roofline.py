"""The host tier's kernels (``csrc/host_tier.cu``): the host rows' bytes
these ids need at 64 GB/s each way (``counts.host_tier_bound_s``) over the
time of ``host_gather`` and ``host_update_rows``, %."""

from benchmark import readers


def read(ctx):
    return readers.host_tier(ctx)
