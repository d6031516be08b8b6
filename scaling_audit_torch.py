"""Collective audit of the port's sharded train step, and a projection of
weak scaling from it: the twin of ``scaling_audit.py`` for
``dlrm_tpu_torch``.

One card cannot measure how the sharded step scales, but it can be
counted exactly what each step puts on the links.  This script runs one
step of ``train.make_sharded_train_step`` in a gloo gang of N processes
on the CPU (one process a rank, as NCCL runs one a card) and records
every collective the step issues (``parallel/audit.py``: the op, its
dtype, its result bytes, its group's size and the mesh axis it rides:
``d`` the table axis, ICI in the JAX audit's words, ``h`` the data-only
axis, DCN, ``mesh`` the whole gang).  It prices each with the ring / edge
cost model (all-gather and all-to-all (N-1)/N of the result a rank,
reduce-scatter (N-1) shards, all-reduce 2(N-1)/N), and projects the
weak-scaling efficiency ``t_comp / (t_comp + t_comm)`` with zero overlap.

The byte counts are counted facts of what the step issued.  The link rate
is a PARAMETER: 100, 200 and 400 GB/s as in the JAX audit, and the
published 450 GB/s each way of an H100 SXM's NVLink 4 (a datasheet
number, not a reading).  The compute side is the card's own step time
(``--step-ms``), scaled to the batch a rank.

The volumes depend on the batch a rank, the feature size and the number
of tables, not on table rows, so the tables have ``AUDIT_ROWS`` rows with
the production batch, feature size and MLP shapes.  Every table is on
the gather path; ``--row-shard`` splits each over every rank.

Run (CPU; the processes and their store stay in ``$TMPDIR``)::

    python scaling_audit_torch.py [--mesh 2 4 8] [--feature-size 16]
        [--batch-per-chip 4096] [--row-shard] [--exchange-dtype bf16]
        [--hybrid DCN ICI] [--step-ms 16.325] [--out FILE]
    python scaling_audit_torch.py --all --out SCALING_torch.json
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import multiprocessing
import os
import queue
import sys
import tempfile
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

from dlrm_tpu_torch.config import DLRMConfig
from dlrm_tpu_torch.parallel import audit
from dlrm_tpu_torch.parallel import mesh as pmesh
from dlrm_tpu_torch.parallel.placement import plan_placement

AUDIT_ROWS = 4000   # volumes do not depend on rows
NUM_TABLES = 26
REFERENCE_BATCH = 32768
# the card's own sharded SGD step: Kaggle fs=128, f32, fused, B=32768,
# NCCL at world size 1, device time a step (PERF.md section 5)
STEP_MS = 16.325
STEP_SOURCE = ("device time of the sharded SGD step, Kaggle fs=128, f32, "
               "fused, B=32768, NCCL at world size 1, on an NVIDIA H100 "
               "80GB HBM3 at 700 W (PERF.md section 5: chip_smoke.py's "
               "profile, NCCL's ranges not counted as work of their own)")
# GB/s a rank, each a PARAMETER of the projection, never a reading
RATES = {100: "parameter", 200: "parameter", 400: "parameter",
         450: "parameter: the published NVLink 4 rate of an H100 SXM, "
              "each way (datasheet, not measured here)"}
# what SCALING_torch.json holds
ALL = ([dict(mesh=(n,), feature_size=fs, exchange_dtype=xd)
        for fs in (16, 128) for xd in (None, "bf16") for n in (2, 4, 8)]
       + [dict(mesh=(8,), feature_size=16, exchange_dtype=xd,
               row_shard=True) for xd in (None, "bf16")]
       + [dict(mesh=(2, 4), feature_size=fs, exchange_dtype=xd)
          for fs in (16, 128) for xd in (None, "bf16")])
AXIS_NAMES = {"d": "d: the table axis (ICI)", "h": "h: the data axis (DCN)",
              "mesh": "mesh: the whole gang"}


def audit_config(feature_size: int, exchange_dtype=None):
    """The audit's model: production MLPs and feature size, 26 tables of
    ``AUDIT_ROWS`` rows, every table on the gather path."""
    return DLRMConfig(
        bottom_mlp_sizes=(13, 512, 256, feature_size),
        top_mlp_sizes=(1024, 1024, 512, 256, 1),
        feature_size=feature_size,
        table_sizes=(AUDIT_ROWS,) * NUM_TABLES,
        small_table_threshold=0,
        exchange_dtype={None: None, "bf16": torch.bfloat16}[exchange_dtype])


def _case_records(case: dict, meshes: dict) -> list:
    """One case's collectives on this rank, as lists."""
    shape = tuple(case["mesh"])
    if shape not in meshes:
        meshes[shape] = (pmesh.make_mesh() if len(shape) == 1
                         else pmesh.make_mesh_2d(*shape))
    placement = plan_placement(
        (AUDIT_ROWS,) * NUM_TABLES, shape[-1],
        max_rows_per_shard=AUDIT_ROWS // 2 if case.get("row_shard")
        else None)
    records = audit.audit_step(
        audit_config(case["feature_size"], case.get("exchange_dtype")),
        placement, meshes[shape], case["batch_per_chip"])
    return [list(dataclasses.astuple(c)) for c in records]


def _rank(rank: int, world: int, store: str, cases: list, threads: int,
          results) -> None:
    """One rank of the gang: every case's collectives onto ``results``,
    or the traceback."""
    torch.set_num_threads(threads)
    try:
        pmesh.init_distributed(f"file://{store}", world, rank, device="cpu")
        meshes = {}
        results.put((rank, [_case_records(c, meshes) for c in cases]))
    except Exception:
        results.put((rank, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_gang(world: int, cases: list, timeout: float = 1800.0) -> list:
    """Run ``cases`` (each a dict of ``mesh``, ``feature_size``,
    ``exchange_dtype``, ``row_shard``, ``batch_per_chip``) in one gloo gang
    of ``world`` processes; every rank must issue the same collectives.
    Returns each case's records ``[kind, dtype, result bytes, group size,
    axis]``."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    threads = max(1, (os.cpu_count() or 1) // world)
    got = {}
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_rank, args=(
            r, world, str(Path(tmp) / "store"), cases, threads, results))
            for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while len(got) < world:
                rank, out = results.get(
                    timeout=max(1.0, deadline - time.monotonic()))
                if isinstance(out, str):
                    raise RuntimeError(f"rank {rank} failed:\n{out}")
                got[rank] = out
        except queue.Empty:
            raise TimeoutError(f"the gang of {world} did not finish within "
                               f"{timeout} s") from None
        finally:
            for p in procs:  # a gang that failed may wait on a dead rank
                p.join(timeout=60 if len(got) == world else 0)
                if p.is_alive():
                    p.kill()
                    p.join()
    for r in range(1, world):
        if got[r] != got[0]:
            raise RuntimeError(f"rank {r} issued other collectives than "
                               f"rank 0")
    return got[0]


def summarize(case: dict, records: list, step_ms: float) -> dict:
    """The JSON record of one case: the collectives, link bytes a rank by
    op kind (and by axis on a 2-D mesh), and the projected efficiency at
    each rate of ``RATES`` (1-D meshes)."""
    cols = [audit.Collective(*r) for r in records]
    link = sum(c.link_bytes for c in cols)
    out = {"mesh": list(case["mesh"]),
           "feature_size": case["feature_size"],
           "exchange_dtype": case.get("exchange_dtype") or "f32",
           "row_shard": bool(case.get("row_shard")),
           "batch_per_chip": case["batch_per_chip"],
           "collectives": records,
           "link_mb_per_chip": link / 1e6,
           "by_kind": {k: {"count": n, "link_mb_per_chip": b / 1e6}
                       for k, (n, b) in audit.by_kind(cols).items()}}
    if len(case["mesh"]) > 1:
        out["by_axis"] = {
            axis: {k: {"count": n, "link_mb_per_chip": b / 1e6}
                   for k, (n, b) in kinds.items()}
            for axis, kinds in audit.by_axis(cols).items()}
    else:
        t_comp = step_ms * case["batch_per_chip"] / REFERENCE_BATCH
        out["projected_efficiency"] = {
            str(rate): t_comp / (t_comp + link / (rate * 1e9) * 1e3)
            for rate in RATES}
    return out


def report(s: dict, step_ms: float) -> None:
    """Print one case as ``scaling_audit.py`` prints its meshes."""
    mesh = "x".join(map(str, s["mesh"]))
    what = (f"mesh={mesh} fs={s['feature_size']} "
            f"{s['exchange_dtype']} exchange"
            + (", every table row-sharded" if s["row_shard"] else ""))
    print(f"\n{what}: {len(s['collectives'])} collectives, "
          f"{s['link_mb_per_chip']:.2f} MB/chip/step link traffic")
    for kind, v in s["by_kind"].items():
        print(f"  {kind:20s} x{v['count']:3d}  "
              f"{v['link_mb_per_chip']:8.2f} MB/chip")
    for kind, dtype, nbytes, group, axis in s["collectives"]:
        print(f"    issued: {kind} {dtype} {nbytes} B, group of {group} "
              f"on {axis}")
    for axis, kinds in s.get("by_axis", {}).items():
        total = sum(v["link_mb_per_chip"] for v in kinds.values())
        print(f"  [{AXIS_NAMES[axis]}] {total:.2f} MB/chip/step")
        for kind, v in kinds.items():
            print(f"    {kind:20s} x{v['count']:3d}  "
                  f"{v['link_mb_per_chip']:8.2f} MB/chip")
    t_comp = step_ms * s["batch_per_chip"] / REFERENCE_BATCH
    for rate, eff in s.get("projected_efficiency", {}).items():
        t_comm = s["link_mb_per_chip"] * 1e6 / (int(rate) * 1e9) * 1e3
        print(f"  projected weak-scaling eff @ {int(rate):3d} GB/s link "
              f"(a parameter): {eff * 100:.1f}%  (comm {t_comm:.3f} ms vs "
              f"comp {t_comp:.3f} ms, zero overlap assumed)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch-per-chip", type=int, default=4096)
    ap.add_argument("--feature-size", type=int, default=16)
    ap.add_argument("--mesh", type=int, nargs="*", default=[2, 4, 8])
    ap.add_argument("--hybrid", type=int, nargs=2, metavar=("DCN", "ICI"),
                    default=None, help="audit the 2-D (h, d) mesh instead, "
                    "the tables sharded over d, its traffic by mesh axis")
    ap.add_argument("--row-shard", action="store_true",
                    help="row-shard every table over every rank")
    ap.add_argument("--exchange-dtype", default=None, choices=["bf16"],
                    help="carry the embedding exchanges in bf16 "
                    "(DLRMConfig.exchange_dtype); gloo moves them as issued")
    ap.add_argument("--step-ms", type=float, default=STEP_MS,
                    help="compute side of the projection, ms a step at "
                    f"B={REFERENCE_BATCH}, scaled to the batch a rank "
                    f"(default {STEP_MS}: the {STEP_SOURCE})")
    ap.add_argument("--all", action="store_true",
                    help="every audit SCALING_torch.json holds (fs=16 and "
                    "128, mesh 2, 4 and 8, f32 and bf16 exchange, fs=16 "
                    "row-sharded at mesh 8, hybrid 2x4) at "
                    "--batch-per-chip; the other audit flags are ignored")
    ap.add_argument("--out", default=None,
                    help="also write the audits as JSON to this file")
    args = ap.parse_args(argv)

    if args.all:
        cases = [dict(c) for c in ALL]
    elif args.hybrid:
        cases = [dict(mesh=tuple(args.hybrid))]
    else:
        cases = [dict(mesh=(n,), row_shard=args.row_shard) for n in args.mesh]
    for c in cases:
        c["batch_per_chip"] = args.batch_per_chip
        c.setdefault("feature_size", args.feature_size)
        c.setdefault("exchange_dtype", args.exchange_dtype)
    source = STEP_SOURCE if args.step_ms == STEP_MS else "--step-ms"
    print(f"batch/chip={args.batch_per_chip} (26 tables of {AUDIT_ROWS} "
          f"rows, production MLP shapes, gloo gangs on the CPU); compute "
          f"side assumes {args.step_ms} ms/step at B={REFERENCE_BATCH} "
          f"({source})")
    worlds = {}
    for i, c in enumerate(cases):
        worlds.setdefault(math.prod(c["mesh"]), []).append(i)
    records = [None] * len(cases)
    for world, idx in sorted(worlds.items()):
        t0 = time.perf_counter()
        for i, recs in zip(idx, run_gang(world, [cases[i] for i in idx])):
            records[i] = recs
        print(f"(gang of {world}: {len(idx)} audit(s) in "
              f"{time.perf_counter() - t0:.1f} s)", file=sys.stderr)
    audits = [summarize(c, r, args.step_ms) for c, r in zip(cases, records)]
    for s in audits:
        report(s, args.step_ms)
    if args.out:
        payload = {
            "tool": "scaling_audit_torch.py",
            "argv": sys.argv[1:] if argv is None else list(argv),
            "counted_on": f"CPU, gloo, one process a rank, torch "
                          f"{torch.__version__}",
            "model": f"{NUM_TABLES} tables of {AUDIT_ROWS} rows, bottom MLP "
                     f"(13, 512, 256, D), top MLP (1024, 1024, 512, 256, "
                     f"1), every table on the gather path",
            "step_ms": args.step_ms, "step_ms_source": source,
            "rates_gb_s": {str(k): v for k, v in RATES.items()},
            "projection": "t_comp / (t_comp + link bytes a chip / rate), "
                          "zero overlap; t_comp = step_ms * batch_per_chip "
                          f"/ {REFERENCE_BATCH}, the same step_ms for every "
                          "audit (other feature sizes' sharded steps are "
                          "not measured on the card)",
            "audits": audits}
        Path(args.out).write_text(json.dumps(payload, indent=1) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
