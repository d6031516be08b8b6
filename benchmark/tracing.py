"""Reduce a ``torch.profiler`` trace of the traced stretch to what the
per-layer metrics and the result line's ``breakdown`` read.

* Device time by group: ``PROFILE_GROUPS``, copied from ``chip_smoke.py``
  (``_PROFILE_GROUPS``, first match wins), after one group of the host-tier
  kernels, which the smoke's two-tier phases add the same way.
* Busy time: the union of the device's activity intervals over all streams,
  so that a copy on the prefetch stream under a kernel is not counted twice
  (``chip_smoke._profile_steps`` summed self times instead).
* Idle gaps: the stretches of the traced window with no device activity,
  each named by what the host was doing at its middle: the innermost span
  open (the program's ``phase_scope`` s or the benchmark's ``bench.*``) and
  the innermost operation running, on the thread that began its operation
  last.

The profiler's events are first turned into plain records (``CpuEvent``,
``DeviceEvent``), so that tests can build a trace by hand.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

# (group, substrings of a device activity's name); the first match wins
PROFILE_GROUPS = (
    ("host-tier kernels (host_gather, host_update_rows)",
     ("host_gather_kernel", "host_update_rows_kernel")),
    ("dedup: sort, unique, scan (cub and thrust kernels)",
     ("cub::", "thrust::")),
    ("MLP GEMMs (gemm, gemv, split-K reduce)",
     ("gemm", "gemv", "splitKreduce")),
    ("sparse update (index_add_)", ("indexFuncLargeIndex",
                                    "indexFuncSmallIndex")),
    ("embedding gather (index_select)", ("gather_kernel", "indexSelect")),
    ("host-to-device copies", ("Memcpy HtoD",)),
    ("interaction_bwd kernel", ("interaction_bwd_kernel",)),
    ("interaction_fwd kernel", ("interaction_fwd_kernel",)),
    ("torch.cat (none on the fused path)", ("CatArrayBatched",)),
    ("device copies (direct_copy_kernel)", ("direct_copy",)),
)
OTHER = "elementwise and reductions (all else)"
# the program's spans (``utils/telemetry.phase_scope``); a profiler that
# does not flag user annotations still shows them as spans
PROGRAM_SPANS = ("lookup", "bottom_mlp", "interaction", "top_mlp",
                 "lookup_host_tier", "host_tier_update",
                 "host_tier_prefetch_next")
GEMM_KEYS = PROFILE_GROUPS[2][1]


def span(name: str):
    """A span of the benchmark's own (``bench.*``) while a profiler
    records, else nothing."""
    import torch
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


@dataclasses.dataclass
class CpuEvent:
    id: int
    name: str
    thread: int
    start: float            # microseconds, the trace's clock
    end: float
    parent: Optional[int]   # id of the enclosing event on its thread
    shapes: list
    annotation: bool        # a span (record_function), not an operation
    kernels: float = 0.0    # seconds of the device work it launched itself


@dataclasses.dataclass
class DeviceEvent:
    name: str
    start: float
    end: float


@dataclasses.dataclass
class Trace:
    cpu: List[CpuEvent]
    device: List[DeviceEvent]
    window: Tuple[float, float]   # the traced stretch, microseconds

    def __post_init__(self):
        self.by_id = {e.id: e for e in self.cpu}

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def seconds(self, pred: Callable[[DeviceEvent], bool]) -> float:
        return sum(d.end - d.start for d in self.device if pred(d)) / 1e6


def from_profiler(prof, window_span: str) -> Trace:
    """Plain records of a finished ``torch.profiler.profile``; the window is
    the CPU span named ``window_span``."""
    import torch

    cpu_t = torch.autograd.DeviceType.CPU
    events = list(prof.events())
    cpu, device = [], []
    ann_names = set()
    for e in events:
        if e.device_type == cpu_t:
            ann = bool(getattr(e, "is_user_annotation", False)) or \
                e.name in PROGRAM_SPANS or e.name.startswith("bench.")
            if ann:
                ann_names.add(e.name)
    uid = 0
    ids = {}
    for e in events:
        if e.device_type != cpu_t:
            continue
        uid += 1
        ids[id(e)] = uid
    for e in events:
        if e.device_type == cpu_t:
            parent = e.cpu_parent
            cpu.append(CpuEvent(
                id=ids[id(e)], name=e.name, thread=e.thread,
                start=e.time_range.start, end=e.time_range.end,
                parent=None if parent is None else ids.get(id(parent)),
                shapes=list(getattr(e, "input_shapes", None) or []),
                annotation=e.name in ann_names,
                kernels=sum(k.duration for k in getattr(e, "kernels", []))
                / 1e6))
    for e in events:
        if e.device_type == cpu_t or e.name in ann_names \
                or getattr(e, "is_user_annotation", False):
            continue
        device.append(DeviceEvent(e.name, e.time_range.start,
                                  e.time_range.end))
    spans = [c for c in cpu if c.name == window_span]
    if not spans:
        raise RuntimeError(f"the trace holds no span {window_span!r}")
    return Trace(cpu, device, (spans[0].start, spans[-1].end))


def busy_intervals(trace: Trace) -> List[Tuple[float, float]]:
    """The union of the device's activity, clipped to the window."""
    lo, hi = trace.window
    spans = sorted((max(d.start, lo), min(d.end, hi)) for d in trace.device
                   if d.end > lo and d.start < hi)
    merged: List[List[float]] = []
    for a, b in spans:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def busy_s(trace: Trace) -> float:
    return sum(b - a for a, b in busy_intervals(trace)) / 1e6


def group_of(name: str) -> str:
    for group, keys in PROFILE_GROUPS:
        if any(k in name for k in keys):
            return group
    return OTHER


def device_groups(trace: Trace) -> Dict[str, float]:
    """Seconds of device activity by group, largest first."""
    out: Dict[str, float] = {}
    for d in trace.device:
        g = group_of(d.name)
        out[g] = out.get(g, 0.0) + (d.end - d.start) / 1e6
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def idle_gaps(trace: Trace) -> List[Tuple[float, float]]:
    lo, hi = trace.window
    gaps, t = [], lo
    for a, b in busy_intervals(trace):
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    return gaps


def _open_at(events: Sequence[CpuEvent], points: Sequence[float]):
    """For each sorted point, the events of one thread open there,
    outermost first (a thread's events nest)."""
    order = sorted(events, key=lambda e: (e.start, -e.end))
    out, stack, i = [], [], 0
    for p in points:
        while i < len(order) and order[i].start <= p:
            e = order[i]
            while stack and stack[-1].end <= e.start:
                stack.pop()
            stack.append(e)
            i += 1
        while stack and stack[-1].end < p:
            stack.pop()
        out.append([e for e in stack if e.start <= p <= e.end])
    return out


def gap_names(trace: Trace, gaps: List[Tuple[float, float]]) -> List[str]:
    """What the host was doing at the middle of each gap: ``<span>: <op>``
    from the thread whose innermost open event began last."""
    mids = [(a + b) / 2 for a, b in gaps]
    order = sorted(range(len(mids)), key=lambda i: mids[i])
    pts = [mids[i] for i in order]
    threads: Dict[int, List[CpuEvent]] = {}
    for e in trace.cpu:
        threads.setdefault(e.thread, []).append(e)
    best: List[Optional[Tuple[float, str, str]]] = [None] * len(pts)
    for events in threads.values():
        for k, stack in enumerate(_open_at(events, pts)):
            if not stack:
                continue
            span = next((e.name for e in reversed(stack) if e.annotation),
                        "")
            op = next((e.name for e in reversed(stack) if not e.annotation),
                      "")
            key = (stack[-1].start, span, op)
            if best[k] is None or key[0] > best[k][0]:
                best[k] = key
    names = [""] * len(mids)
    for k, i in enumerate(order):
        b = best[k]
        names[i] = "no host span open" if b is None else \
            f"{b[1] or 'no span'}: {b[2] or 'no operation'}"
    return names


def idle_by_span(trace: Trace) -> Dict[str, float]:
    """Idle seconds summed by what the host was doing, largest first."""
    gaps = idle_gaps(trace)
    out: Dict[str, float] = {}
    for (a, b), name in zip(gaps, gap_names(trace, gaps)):
        out[name] = out.get(name, 0.0) + (b - a) / 1e6
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def op_seconds(trace: Trace, names: Sequence[str],
               first_shape: Callable[[list], bool]) -> float:
    """Device seconds launched by the CPU operations named one of ``names``
    whose first input's shape passes ``first_shape``, and by the
    operations inside them."""
    def hit(e: CpuEvent) -> bool:
        while e is not None:
            if e.name in names and e.shapes and \
                    first_shape(list(e.shapes[0])):
                return True
            e = trace.by_id.get(e.parent)
        return False
    return sum(e.kernels for e in trace.cpu if e.kernels and hit(e))


def breakdown(trace: Trace, top: int = 10) -> dict:
    return {"device_ops": [[k, v] for k, v in
                           list(device_groups(trace).items())[:top]],
            "idle_gaps": [[k, v] for k, v in
                          list(idle_by_span(trace).items())[:top]]}

