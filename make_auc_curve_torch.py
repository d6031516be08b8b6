"""Time-to-AUC curve of dlrm_tpu_torch on the planted-truth synthetic task,
on the GPU: the twin of ``make_auc_curve.py``.

The task is the Kaggle-scale skewed synthetic with a planted Zipf CTR
ground truth (``data/synthetic.ClickthroughModel``, seed 12345); training
batches come from its stream with seed 1 and every evaluation reads the
same batches, drawn from seed 777.  The defaults are those of
``make_auc_curve.py``: row-wise Adagrad, lr 0.002 and bf16 tables at
fs >= 128, else Adagrad and lr 0.005.  The interaction follows the CLI's
rule: on CUDA ``config.auto_interaction_impl`` (fused at fs=128, so both
hand-written interaction kernels run in every step), gram on the CPU;
``--interaction`` overrides it.  ``--update-interval K`` trains in
coalesced K-step blocks, and each evaluation then falls on the first block
boundary at or after each multiple of ``--eval-every``.

Each curve point records held-out accuracy, AUC and loss, the examples and
steps consumed and the wall seconds since the start (set-up included).
``--against FILE`` holds the curve against a committed one at equal
examples (the point at step 0 is never compared: the initial weights come
from other random bits) and exits 1 when a point misses its tolerance.

Run on the GPU:
    python3 make_auc_curve_torch.py --feature-size 128 --steps 1800 \\
        --eval-every 150 --against AUC_CURVE_fs128.json \\
        --out AUC_CURVE_torch_fs128.json
    python3 make_auc_curve_torch.py --feature-size 16 --steps 600 \\
        --eval-every 50 --update-interval 4 --against AUC_CURVE.json \\
        --out AUC_CURVE_torch_fs16.json
On the CPU, at the tiny config:
    python3 make_auc_curve_torch.py --tiny --device cpu --feature-size 16 \\
        --batch-size 256 --steps 40 --eval-every 20 --eval-batches 2
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import List, Optional, Tuple

import torch

REPO = Path(__file__).resolve().parent
TASK = ("kaggle-scale skewed synthetic (planted Zipf CTR ground truth; real "
        "Criteo DAC unavailable: zero-egress environment)")
TRUTH_SEED = 12345
TRAIN_SEED = 1
EVAL_SEED = 777
# --against: the largest |AUC difference| from the committed curve at equal
# examples, at the curve's second point, at every later one, and at its last
TOL_SECOND = 0.01
TOL_LATER = 0.005
TOL_FINAL = 0.003


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def defaults(feature_size: int) -> Tuple[str, float]:
    """(optimizer, lr) of ``make_auc_curve.py`` at this feature size."""
    if feature_size >= 128:
        return "rowwise_adagrad", 0.002
    return "adagrad", 0.005


def build_config(feature_size: int, *, tiny: bool = False,
                 interaction: Optional[str] = None,
                 device=torch.device("cpu")):
    """Kaggle at ``feature_size`` (or ``make_auc_curve.py``'s tiny config),
    bf16 tables at fs >= 128, with the interaction of the CLI's rule."""
    from dlrm_tpu_torch import kaggle_config, tiny_config
    from dlrm_tpu_torch.run import _interaction

    kw = {}
    if feature_size >= 128:
        kw["embedding_dtype"] = torch.bfloat16
    if tiny:
        config = dataclasses.replace(
            tiny_config(num_tables=6, rows=512, feature_size=feature_size),
            table_sizes=(512, 2000, 64, 4096, 256, 1024), **kw)
    else:
        config = kaggle_config(feature_size=feature_size, **kw)
    return _interaction(config, argparse.Namespace(interaction=interaction),
                        torch.device(device))


def curve(config, params: dict, opt_state: dict, truth, *, optimizer: str,
          lr: float, batch: int, steps: int, eval_every: int,
          eval_batches: int, update_interval: int = 1, device,
          t0: Optional[float] = None) -> List[dict]:
    """Train ``params`` and ``opt_state`` in place on ``truth``'s stream
    (seed 1) for ``steps`` steps of ``batch`` examples and evaluate them
    (``train.metrics.evaluate`` over ``eval_batches`` batches of the stream
    with seed 777) at step 0, at every ``eval_every`` steps (with K-step
    blocks: at the first block boundary at or after each multiple) and at
    the end.  Returns the points ``{accuracy, auc, loss, examples, step,
    wall_s}``; ``wall_s`` counts from ``t0`` (default: now).

    Training batches reach ``device`` through ``device_prefetch``: one
    producer draws and copies them, in the stream's order, while the
    previous step runs.  Blocks take ``adagrad`` or ``rowwise_adagrad``
    (``train.make_train_block_opt``)."""
    from dlrm_tpu_torch.data.prefetch import device_prefetch
    from dlrm_tpu_torch.run import _block_iter, _crossed
    from dlrm_tpu_torch.train.metrics import evaluate
    from dlrm_tpu_torch.train.train import (batch_to_device,
                                            make_train_block_opt,
                                            make_train_step_opt)

    t0 = time.time() if t0 is None else t0
    k = max(update_interval, 1)
    step_fn = (make_train_step_opt if k == 1 else make_train_block_opt)(
        config, optimizer=optimizer, lr=lr)
    eval_set = list(truth.stream(batch, steps=eval_batches, seed=EVAL_SEED))
    points: List[dict] = []

    def eval_point(n: int) -> None:
        m = evaluate(params, eval_set, config)
        m["examples"] = n * batch
        m["step"] = n
        m["wall_s"] = round(time.time() - t0, 1)
        points.append({key: (round(float(v), 6) if isinstance(v, float)
                             else v) for key, v in m.items()})
        log(f"step {n}: acc={m['accuracy']:.4f} auc={m['auc']:.4f} "
            f"loss={m['loss']:.5f} wall={m['wall_s']}s")

    eval_point(0)
    source = truth.stream(batch, steps=steps, seed=TRAIN_SEED)
    if k > 1:
        source = _block_iter(source, k)
    n = 0
    for b in device_prefetch(source, size=2, device=device):
        b = batch_to_device(b, device)
        step_fn(params, opt_state, b["dense"], b["sparse"], b["labels"])
        prev, n = n, n + (b["labels"].shape[0] if k > 1 else 1)
        if _crossed(prev, n, eval_every):
            eval_point(n)
    if points[-1]["step"] != n:
        eval_point(n)
    return points


def compare(points: List[dict], reference: List[dict]
            ) -> Tuple[List[str], bool]:
    """Each point's AUC against the reference point at equal examples:
    (report lines, every compared point within its tolerance).  Point 0 is
    not compared; the last point must have a counterpart."""
    ref = {}
    for p in reference:
        ref.setdefault(p["examples"], p)
    lines = []
    ok = points[-1]["examples"] > 0 and points[-1]["examples"] in ref
    if not ok:
        lines.append(f"no reference point at the last point's "
                     f"{points[-1]['examples']} examples")
    for i, p in enumerate(points):
        if p["examples"] == 0:
            continue
        r = ref.get(p["examples"])
        if r is None:
            lines.append(f"step {p['step']}: no reference point at "
                         f"{p['examples']} examples")
            continue
        tol = (TOL_SECOND if i == 1 else TOL_FINAL if i == len(points) - 1
               else TOL_LATER)
        delta = p["auc"] - r["auc"]
        hit = abs(delta) <= tol
        ok = ok and hit
        lines.append(f"step {p['step']} ({p['examples']} examples): auc "
                     f"{p['auc']:.6f} against {r['auc']:.6f}, delta "
                     f"{delta:+.6f} (tolerance {tol}) "
                     f"{'ok' if hit else 'MISS'}")
    return lines, ok


def device_name(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, or
    ``cpu``."""
    if device.type != "cuda":
        return "cpu"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", f"--id={device.index or 0}"],
        capture_output=True, text=True, timeout=60, check=True)
    return smi.stdout.strip()


def commit() -> Optional[str]:
    """The checkout's commit (``-dirty`` when tracked files differ from
    it), else ``$GIT_COMMIT``, else None."""
    try:
        head = subprocess.run(["git", "rev-parse", "HEAD"], cwd=REPO,
                              capture_output=True, text=True, timeout=30)
        if head.returncode == 0:
            dirty = subprocess.run(
                ["git", "status", "--porcelain", "--untracked-files=no"],
                cwd=REPO, capture_output=True, text=True, timeout=30)
            return head.stdout.strip() + ("-dirty" if dirty.stdout.strip()
                                          else "")
    except (OSError, subprocess.SubprocessError):
        pass
    return os.environ.get("GIT_COMMIT")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--feature-size", type=int, default=128)
    ap.add_argument("--batch-size", type=int, default=32768)
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--eval-every", type=int, default=50)
    ap.add_argument("--eval-batches", type=int, default=4)
    ap.add_argument("--lr", type=float, default=None,
                    help="default: 0.002 at fs>=128, 0.005 below")
    ap.add_argument("--optimizer", default=None,
                    choices=("sgd", "adagrad", "rowwise_adagrad"),
                    help="default: rowwise_adagrad at fs>=128, adagrad "
                         "below")
    ap.add_argument("--update-interval", type=int, default=1,
                    help="K > 1: coalesced K-step blocks")
    ap.add_argument("--interaction", default=None,
                    choices=("gram", "pairwise", "fused"),
                    help="default: the CLI's rule (fused at fs=128 on "
                         "cuda, gram elsewhere)")
    ap.add_argument("--device", default=None,
                    help="default cuda; without a GPU the script stops "
                         "unless given cpu")
    ap.add_argument("--params", default=None,
                    help="start from this .npz (io/convert.save_npz) "
                         "instead of parameters drawn from the config's "
                         "seed")
    ap.add_argument("--against", default=None,
                    help="a committed curve to hold this one against at "
                         "equal examples")
    ap.add_argument("--out", default=None,
                    help="default AUC_CURVE_torch_fs{fs}.json")
    ap.add_argument("--tiny", action="store_true",
                    help="tiny config (CPU run of the script itself)")
    args = ap.parse_args(argv)

    from dlrm_tpu_torch import init_params
    from dlrm_tpu_torch.data.synthetic import ClickthroughModel
    from dlrm_tpu_torch.io.convert import load_npz, params_from_numpy
    from dlrm_tpu_torch.run import _device
    from dlrm_tpu_torch.train.train import init_opt_state

    device = _device(args)
    fs = args.feature_size
    optimizer, lr = defaults(fs)
    optimizer = args.optimizer or optimizer
    lr = args.lr if args.lr is not None else lr
    out_path = args.out or f"AUC_CURVE_torch_fs{fs}.json"
    k = max(args.update_interval, 1)
    B = args.batch_size
    config = build_config(fs, tiny=args.tiny, interaction=args.interaction,
                          device=device)
    log(f"config: {'tiny' if args.tiny else 'kaggle'} fs={fs} "
        f"{config.total_rows:,} rows, optimizer={optimizer} lr={lr} B={B} "
        f"K={k}, {config.interaction_impl} interaction, device {device}")

    card = device_name(device)
    t0 = time.time()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    truth = ClickthroughModel(config, seed=TRUTH_SEED)
    if args.params:
        params = params_from_numpy(load_npz(args.params), config, device)
    else:
        params = init_params(
            torch.Generator(device).manual_seed(config.seed), config, device)
    opt_state = init_opt_state(params, config=config, optimizer=optimizer)
    points = curve(config, params, opt_state, truth, optimizer=optimizer,
                   lr=lr, batch=B, steps=args.steps,
                   eval_every=args.eval_every,
                   eval_batches=args.eval_batches, update_interval=k,
                   device=device, t0=t0)

    payload = {
        "task": TASK,
        "config": f"{'tiny' if args.tiny else 'kaggle'} fs={fs} B={B} "
                  f"{optimizer} lr={lr}"
                  + (" bf16-tables" if fs >= 128 else "")
                  + (f" --update-interval {k}" if k > 1 else "")
                  + f" {config.interaction_impl} interaction",
        "budget_examples": args.steps * B,
        "seed": TRUTH_SEED,
        "curve": points,
        "device": card,
        "commit": commit(),
    }
    if device.type == "cuda":
        payload["device_peak_gb"] = round(
            torch.cuda.max_memory_allocated(device) / 1e9, 3)
    with open(out_path, "w") as f:
        json.dump(payload, f, indent=1)
    log(f"wrote {out_path} ({len(points)} points, final auc "
        f"{points[-1]['auc']:.4f})")
    ok = True
    if args.against:
        with open(args.against) as f:
            lines, ok = compare(points, json.load(f)["curve"])
        for line in lines:
            log(f"against {args.against}: {line}")
        log(f"against {args.against}: {'within' if ok else 'OUTSIDE'} the "
            f"tolerances")
    print(json.dumps({"metric": f"auc_curve_fs{fs}",
                      "value": points[-1]["auc"], "unit": "auc",
                      "points": len(points)}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
