"""What the metric readers (``metrics/<name>.py``) share.  A reader's
``read(ctx)`` returns a number, or None when its cell gives it nothing to
read; ``ctx`` is the namespace an entry returns (``entries/*.py``)."""

from __future__ import annotations

import math
from typing import Optional, Sequence

from benchmark import counts, tracing


def p95(values: Sequence[float]) -> Optional[float]:
    """The 95th percentile, nearest rank."""
    if not values:
        return None
    s = sorted(values)
    return s[max(math.ceil(0.95 * len(s)) - 1, 0)]


def rate(ctx) -> Optional[float]:
    w = ctx.window
    return w["examples"] / w["seconds"] if w["steps"] else None


def mfu(ctx) -> Optional[float]:
    """The window's model FLOPs over its time, as % of the f32 peak."""
    w = ctx.window
    if not w["steps"] or not ctx.trace:
        return None
    flops = counts.model_flops(ctx.cfg, ctx.batch, ctx.train) * w["steps"]
    return 100.0 * flops / w["seconds"] / counts.F32_FLOPS


def idle_share(ctx) -> Optional[float]:
    """One less the device's busy time a traced step (the union of its
    activity) over the untraced window's time a step, %.  The profiler
    slows the host's launches, not the device's work, so the traced
    stretch gives the busy time a step and the window the time a step."""
    t, w = ctx.trace, ctx.window
    if t is None or not t.device or not ctx.traced or not w["steps"]:
        return None
    busy = tracing.busy_s(t) / len(ctx.traced)
    return 100.0 * (1.0 - busy / (w["seconds"] / w["steps"]))


def named_seconds(ctx, keys) -> float:
    return ctx.trace.seconds(lambda d: any(k in d.name for k in keys))


def roofline(need_s: float, took_s: float) -> Optional[float]:
    """A share of the roofline, %, or None when nothing ran."""
    if took_s <= 0 or need_s <= 0:
        return None
    return 100.0 * need_s / took_s


def gemm(ctx) -> Optional[float]:
    if ctx.trace is None:
        return None
    need = counts.gemm_bound_s(ctx.cfg, ctx.batch, ctx.train) * len(ctx.traced)
    return roofline(need, named_seconds(ctx, tracing.GEMM_KEYS))


def interaction(ctx) -> Optional[float]:
    if ctx.trace is None:
        return None
    need = counts.interaction_bound_s(ctx.cfg, ctx.batch, ctx.train) \
        * len(ctx.traced)
    keys = ("interaction_fwd_kernel", "interaction_bwd_kernel")
    return roofline(need, named_seconds(ctx, keys))


TABLE_OPS = ("aten::index_select", "aten::index_add_")


def embedding(ctx) -> Optional[float]:
    """The device tables' gathers and updates (the index operations on the
    table, or on its row-wise accumulator, of ``device_rows`` rows)."""
    t = ctx.trace
    if t is None:
        return None
    rows = ctx.device_rows
    took = tracing.op_seconds(t, TABLE_OPS,
                              lambda s: bool(s) and s[0] == rows)
    need = sum(counts.table_bytes(ctx.cfg, ctx.job, ctx.batch, ids,
                                  ctx.device_tables, ctx.train)
               for ids in ctx.traced) / counts.HBM_BYTES_PER_S
    return roofline(need, took)


def host_tier(ctx) -> Optional[float]:
    if ctx.trace is None or not ctx.host_tables:
        return None
    need = sum(counts.host_tier_bound_s(ctx.cfg, ctx.job, ids,
                                        ctx.host_tables, ctx.train)
               for ids in ctx.traced)
    keys = ("host_gather_kernel", "host_update_rows_kernel")
    return roofline(need, named_seconds(ctx, keys))
