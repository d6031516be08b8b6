"""Two-tier step times of the port in a given checkout, on one CUDA card.

    python3 probes/two_tier_steps.py [--repo DIR] [--label NAME]

Imports ``dlrm_tpu_torch`` from ``--repo`` (default: this checkout), so
that two checkouts can be timed in turns within one run on one card (A,
B, B, A: a process each).  At Kaggle fs=128 f32, fused, B=32768, under
``--hbm-budget-gb 4`` (tables 2, 11 and 20 pinned on the host, the rest on
the card), drawn from the config's seed, it measures:
  * ``host_gather`` into the pooled columns of one batch's 98,304 host ids
    and ``host_update_rows`` on its 98,117 distinct rows (adding zeros),
    CUDA events, median of 7 windows of 10 calls;
  * the host-to-host ms of a two-tier step (the median of 10 after 3) for
    SGD (lr 0.1), row-wise Adagrad and Adagrad (lr 0.001, accumulators
    from 1e-6);
  * in 5 profiled steps of each optimizer (``torch.profiler``): the device
    ms a step, the device's idle share of the steps' host-to-host time, and
    the device ms a step of each host-tier kernel (CUDA rows whose name
    holds the kernel's).
Prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

DEV = torch.device("cuda:0")
BATCH = 32768
# the port's phase scopes: the profiler lists each as a CUDA annotation
# spanning its kernels as well, which is not a kernel of its own
SCOPES = ("lookup", "bottom_mlp", "interaction", "top_mlp",
          "lookup_host_tier", "host_tier_update", "host_tier_prefetch_next")


def _ms(fn, reps: int = 7, inner: int = 10) -> float:
    for _ in range(3):
        fn()
    out = []
    for _ in range(reps):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        for _ in range(inner):
            fn()
        e.record()
        e.synchronize()
        out.append(s.elapsed_time(e) / inner)
    return statistics.median(out)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repo", default=str(Path(__file__).resolve().parent
                                          .parent))
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("two_tier_steps: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.repo).resolve()))
    from dlrm_tpu_torch import kaggle_config
    from dlrm_tpu_torch.data.synthetic import batch_stream
    from dlrm_tpu_torch.parallel import host_tier as H

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    config = kaggle_config(feature_size=128, interaction_impl="fused")
    plan = H.plan_tiers(config, 4 * H.GIB)
    tiered = H.draw_tiered_params(
        torch.Generator(DEV).manual_seed(config.seed), plan, config, DEV)
    batches = [[torch.from_numpy(b[k]).to(DEV)
                for k in ("dense", "sparse", "labels")]
               for b in batch_stream(config, BATCH, 8, seed=61)]
    emb = tiered["emb"]
    offs = torch.tensor(plan.host_offsets, dtype=batches[0][1].dtype,
                        device=DEV)
    ids = batches[0][1][:, list(plan.host_tables)] + offs
    uniq = torch.unique(ids.long())
    pooled = torch.zeros((BATCH, config.num_tables, config.feature_size),
                         device=DEV)
    zeros = torch.zeros((uniq.numel(), config.feature_size), device=DEV)
    out = {"label": args.label,
           "host_gather_ms": _ms(lambda: H.host_gather(
               emb.host, ids, out=pooled, cols=plan.host_tables)),
           "host_update_rows_ms": _ms(lambda: H.host_update_rows(
               emb.host, uniq, zeros))}

    def steps(fn) -> float:
        times = []
        for i in range(13):
            t0 = time.perf_counter()
            float(fn(*batches[i % len(batches)]))
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times[3:])

    def profiled(name: str, fn) -> None:
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for b in batches[:5]:
                float(fn(*b))
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / 5
        rows = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and e.key not in SCOPES]
        device = sum(e.self_device_time_total for e in rows) / 5 / 1e3
        out[f"{name} profiled device ms a step"] = device
        out[f"{name} profiled idle share"] = 1 - device / wall
        for k in ("host_gather_kernel", "host_update_rows_kernel"):
            out[f"{name} profiled {k} ms a step"] = sum(
                e.self_device_time_total for e in rows if k in e.key) / 5e3

    sgd = lambda *b: H.tiered_train_step(tiered, *b, config=config, lr=0.1)
    out["sgd_ms"] = steps(sgd)
    profiled("sgd", sgd)
    for opt in ("rowwise_adagrad", "adagrad"):
        state = H.init_tiered_opt_state(tiered, config=config, optimizer=opt)
        for a in (state["dev_acc"], state["host_acc"]):
            a.fill_(1e-6)
        fn = lambda *b: H.tiered_train_step_opt(  # noqa: E731
            tiered, state, *b, config=config, optimizer=opt, lr=0.001)
        out[f"{opt}_ms"] = steps(fn)
        profiled(opt, fn)
        del state, fn
        torch.cuda.synchronize()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
