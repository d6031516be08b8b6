"""Run one cell of the benchmark once.

    python3 benchmark/harness.py --workload <cell> --seed <n> \\
        --seconds <run_seconds> --trace <0|1>

The cell's files are found by name (``spec.py``).  The run draws the
weights and the traffic pool on the card from ``--seed``, warms up the
cell's shapes, measures for ``--seconds``, and with ``--trace 1`` then
records a ``torch.profiler`` trace of a further stretch.  After the window
the program's state is freed and the plain reference checks what the timed
path produced.  The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device`` and, when
traced, ``breakdown``; its last key, ``checks``, gives each compared number
beside its limit, as the last lines of standard error do.

Without a CUDA card, or with fewer cards than the cell asks for, the run
prints no result and exits non-zero.
"""

from __future__ import annotations

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Callable, List, Optional  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# module names that no process of the benchmark may hold (whole top-level
# names: the program's own name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "dlrm_tpu")


def say(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def forbidden_modules() -> List[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


@dataclasses.dataclass
class Run:
    """One run of a cell, as the entry sees it."""

    cell: object                 # spec.Cell
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: object               # torch.device
    tiny: bool
    say: Callable = say
    keep: Optional[dict] = None   # the check's inputs, for the calibration

    def sync(self) -> None:
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def profile(self, body: Callable[[], None]):
        """``body`` under ``torch.profiler`` (CPU, and CUDA on a card, with
        the operations' input shapes), inside the span ``bench.traced``;
        returns the reduced trace (``tracing.Trace``)."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        from benchmark import tracing

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.sync()
        with profile(activities=acts, record_shapes=True) as prof:
            with torch.profiler.record_function("bench.traced"):
                body()
                self.sync()
        t0 = time.perf_counter()
        out = tracing.from_profiler(prof, "bench.traced")
        self.say(f"trace: {len(out.cpu)} host and {len(out.device)} device "
                 f"events read in {time.perf_counter() - t0:.2f} s")
        return out


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             tiny: bool = False, start: float = PROCESS_START,
             keep: Optional[dict] = None) -> dict:
    """Run ``cell`` once; returns the result line as a dict.  ``tiny``: the
    CPU dry path's sizes (``program.tiny``).  ``keep``: a dict the entry
    fills with the check's inputs and the program's readings."""
    import torch

    from benchmark import check, program, spec

    device = torch.device(device)
    config, mix = cell.config, cell.traffic
    if tiny:
        config, mix = program.tiny(config, mix)
    run = Run(cell=cell, config=config, traffic=mix, seed=int(seed),
              seconds=float(seconds), trace=bool(trace), device=device,
              tiny=tiny, keep=keep)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    entry = spec.load_module("entries", cell.entry)
    out = entry.run(run, start)
    metrics_defs = cell.per_layer if trace else cell.end_to_end
    readers = spec.metric_readers(metrics_defs)
    ctx = out["context"]
    metrics = {}
    for m in metrics_defs:
        value = readers[m["name"]].read(ctx)
        if value is None:
            continue
        metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    numbers = out["numbers"]
    limits = dict(cell.limits)
    correct = check.verdict(numbers, limits) and out["failed"] == 0
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device)
           if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(out["memory_peak_bytes"])}
    result = {"correct": bool(correct), "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics,
              "device": dev}
    if trace and ctx.trace is not None:
        from benchmark import tracing
        dev["busy_s"] = tracing.busy_s(ctx.trace)
        dev["window_s"] = ctx.trace.window_s
        result["breakdown"] = tracing.breakdown(ctx.trace)
    result["checks"] = check.report(numbers, limits)
    return result


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from benchmark import spec

    cell = spec.load_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        say(f"no run: this cell needs {cell.chips} CUDA card(s), "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            f" visible")
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda")
    found = forbidden_modules()
    if found:
        say(f"no result: the process holds the modules {found}")
        return 3
    for name, c in result["checks"].items():
        say(f"check {name}: {c['value']!r} against the limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
