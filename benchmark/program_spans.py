"""What the readers of the program's own spans and counters share: device
idle time in the gaps that a given span names, a span's host time, the
runtime's synchronizing calls, and the program's counters.

Spans are the program's ``utils/telemetry.phase_scope`` s (and its backward
stages' spans), read from the traced run's ``tracing.Trace``; a gap is
named by the innermost span the host had open at its middle
(``tracing.gap_names``).  Counters are read from the program's telemetry
module in this process (``telemetry.counters()``): they add up only while a
profiler records, so in a run of the harness they are the traced
stretch's.  Every value is a traced step's (or batch's): over
``len(ctx.traced)``.

A reader returns None, never 0 and never an exception, when the program
under it has no such span or counter (an older program has neither); a
span that appears with no idle gap under it reads 0.
"""

from __future__ import annotations

import sys
from typing import Callable, Dict, Iterable, Optional

from benchmark import tracing

TELEMETRY = "dlrm_tpu_torch.utils.telemetry"
# the CUDA runtime's calls that block the host until the device is done
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")
# the benchmark's own synchronizing spans: its read of the loss, and the
# traced stretch's closing synchronize (``bench.traced`` innermost)
OWN_SYNC_SPANS = ("bench.loss_read", "bench.traced")


def _steps(ctx) -> int:
    return len(ctx.traced) if ctx.trace is not None and ctx.traced else 0


def _device_trace(ctx) -> bool:
    """A traced run whose trace saw the device (a CPU trace has no device
    activity and no runtime calls)."""
    return _steps(ctx) > 0 and bool(ctx.trace.device)


def span_of(gap_name: str) -> str:
    """The span part of a ``tracing.gap_names`` name (``<span>: <op>``)."""
    return gap_name.split(": ", 1)[0]


def _has_span(trace: tracing.Trace, match: Callable[[str], bool]) -> bool:
    return any(e.annotation and match(e.name) for e in trace.cpu)


def idle_ms(ctx, match: Callable[[str], bool]) -> Optional[float]:
    """Device-idle ms a traced step in the gaps whose innermost host span
    passes ``match``; None when no such span is in the trace."""
    if not _device_trace(ctx) or not _has_span(ctx.trace, match):
        return None
    t = ctx.trace
    gaps = tracing.idle_gaps(t)
    us = sum(b - a for (a, b), name in zip(gaps, tracing.gap_names(t, gaps))
             if match(span_of(name)))
    return us / 1e3 / _steps(ctx)


def named(names: Iterable[str]) -> Callable[[str], bool]:
    names = frozenset(names)
    return lambda s: s in names


def host_ms(ctx, name: str) -> Optional[float]:
    """Host ms a traced step inside the span ``name`` (clipped to the
    traced window); None when the span is not in the trace."""
    if not _steps(ctx):
        return None
    lo, hi = ctx.trace.window
    spans = [e for e in ctx.trace.cpu if e.annotation and e.name == name]
    if not spans:
        return None
    us = sum(max(0.0, min(e.end, hi) - max(e.start, lo)) for e in spans)
    return us / 1e3 / _steps(ctx)


def _innermost_span(events, e) -> Optional[str]:
    """The innermost span open on ``e``'s thread around ``e``."""
    best = None
    for s in events:
        if s.annotation and s.start <= e.start and e.end <= s.end and \
                (best is None or s.start >= best.start):
            best = s
    return None if best is None else best.name


def host_syncs(ctx) -> Optional[float]:
    """The runtime's synchronizing calls a traced step (in the traced
    window), less the benchmark's own (``OWN_SYNC_SPANS``)."""
    if not _device_trace(ctx):
        return None
    lo, hi = ctx.trace.window
    by_thread: Dict[int, list] = {}
    for e in ctx.trace.cpu:
        if e.annotation:
            by_thread.setdefault(e.thread, []).append(e)
    n = sum(1 for e in ctx.trace.cpu if e.name in SYNC_CALLS and
            lo <= e.start and e.end <= hi and
            _innermost_span(by_thread.get(e.thread, []), e)
            not in OWN_SYNC_SPANS)
    return n / _steps(ctx)


def counters(ctx) -> Optional[Dict[str, int]]:
    """The program's counters of the traced stretch, or None (no traced
    stretch, or a program without counters)."""
    if not _steps(ctx):
        return None
    read = getattr(sys.modules.get(TELEMETRY), "counters", None)
    return None if read is None else dict(read())


def counter_sum(ctx, names: Iterable[str]) -> Optional[float]:
    """The sum of the counters ``names`` a traced step; None when none of
    them counted."""
    c = counters(ctx)
    if c is None:
        return None
    got = [c[k] for k in names if k in c]
    return sum(got) / _steps(ctx) if got else None
