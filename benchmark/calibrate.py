"""Readings that the limits of ``correct`` are set from, on the card at the
cell's own size (not run by the benchmark's runs):

    python3 benchmark/calibrate.py --workload <cell> --seeds 11,12,13 \\
        [--seconds 2] [--out readings.jsonl]

For each seed, one run of the cell through the harness (a short window)
gives the program's numbers; from the same inputs the reference is then
put in the program's place as the control, computed in TF32, and with the
faults planted: half of the batch left out and the mean taken over the
rest, and an answer altered where it is produced (training: the first
step's loss off by one part in the batch size, one example's worth;
scoring: one score off by 1e-3).  A state left unchanged reads 1 by the
training measure and needs no run.  One JSON line a seed, with each side's
first-step loss and every leaf's gap of the first gradient, for the look
at which leaf carries a gap.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import check, harness, program, spec  # noqa: E402


def train_readings(keep: dict, cfg: dict, job: dict, batch: int,
                   device) -> dict:
    from benchmark.entries.train import reference_readings

    args = (cfg, keep["dense0"], keep["ids"], keep["rows0"], keep["batches"],
            job, device)
    ref = keep["ref"]
    ctl = reference_readings(*args, tf32=True)
    half = reference_readings(*args, half_batch=True)
    altered = {**ref, "losses": list(ref["losses"])}
    altered["losses"][0] *= 1.0 + 1.0 / batch
    keep_all = [True] * len(ref["grad_norms"])
    return {"control_tf32": check.train_numbers(ctl, ref),
            "half_batch": check.train_numbers(half, ref),
            "answer_altered": check.train_numbers(altered, ref),
            "losses_all": {"program": keep["prog"]["losses"],
                           "reference": ref["losses"],
                           "control": ctl["losses"]},
            "grad_leaf_gaps": {
                who: [float("%.3g" % g) for g in check.leaf_gaps(
                    r["grad_norms"], ref["grad_norms"], keep_all)]
                for who, r in (("program", keep["prog"]),
                               ("control", ctl))}}


def serve_readings(keep: dict, cfg: dict, device) -> dict:
    ref = spec.model(cfg)
    pairs_ctl, pairs_half, pairs_alt = [], [], []
    for i in keep["picked"]:
        params = {tw: [{k: v.to(device) for k, v in layer.items()}
                       for layer in layers]
                  for tw, layers in keep["dense0"].items()}
        rows = ref.pool(keep["rows"][i].to(device), keep["hot"])
        dense = keep["dense"][i].to(device)
        want = ref.score(params, rows, dense).cpu()
        with ref.precision(True):
            ctl = ref.score(params, rows, dense).cpu()
        h = dense.shape[0] // 2
        half = ref.score(params, rows[:h], dense[:h]).cpu()
        alt = want.clone()
        alt[h] += 1e-3
        pairs_ctl.append((ctl, want))
        pairs_half.append((half, want))
        pairs_alt.append((alt, want))
    return {"control_tf32": check.serve_numbers(pairs_ctl),
            "half_batch": check.serve_numbers(pairs_half),
            "answer_altered": check.serve_numbers(pairs_alt)}


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out", default=None)
    args = p.parse_args()
    cell = spec.load_cell(args.workload)
    out = open(args.out, "a") if args.out else None
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        keep: dict = {}
        res = harness.run_cell(cell, seed, args.seconds, False, "cuda",
                               start=time.perf_counter(), keep=keep)
        line = {"workload": cell.name, "seed": seed,
                "program": {k: v["value"] for k, v in res["checks"].items()},
                "correct": res["correct"]}
        if cell.entry == "train":
            line.update(train_readings(keep, cell.config, cell.traffic,
                                       cell.traffic["batch"], "cuda"))
        else:
            line.update(serve_readings(keep, cell.config, "cuda"))
        line["seconds"] = time.perf_counter() - t0
        keep.clear()
        program.free_device_memory()
        text = json.dumps(line)
        print(text, flush=True)
        if out:
            out.write(text + "\n")
            out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
