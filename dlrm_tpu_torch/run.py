"""Command-line entry point: the single-device subset of ``dlrm_tpu/run.py``.

  train     exact-SGD training on one device (synthetic or Criteo data)
  predict   batch CTR scoring of a binarized dataset -> .npy

Run as ``python -m dlrm_tpu_torch <subcommand> ...``.  ``predict`` reads
parameters from an .npz written by ``dlrm_tpu_torch.io.convert.save_npz``.
Every flag of the JAX package's CLI is parsed; one this package does not
serve yet exits non-zero, naming the ROADMAP.md item that brings it, unless
it is left at its default.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import List, Optional

import numpy as np
import torch

_Q = "ROADMAP.md queue 1, "
_CKPT = _Q + "item 7, 'Checkpoints, telemetry and CLI'"
_MULTI = _Q + "item 9, 'Multi-GPU'"
_TPU_LAYOUT = ("is TPU storage layout, which the port does not carry over "
               "(ROADMAP.md, north star)")

# Flags of the JAX package's CLI that this package does not serve yet:
# flag -> (default, why).  A flag at its default passes.
_NOT_YET = {
    "ckpt_dir": (None, f"--ckpt-dir needs checkpoints ({_CKPT}: "
                       "io/checkpoint.py); predict takes --params params.npz"),
    "save_interval": (1000, f"--save-interval needs checkpoints ({_CKPT})"),
    "max_to_keep": (3, f"--max-to-keep needs checkpoints ({_CKPT})"),
    "profile_dir": (None, f"--profile-dir needs the telemetry port ({_CKPT}: "
                          "utils/telemetry.py)"),
    "hdf5": (None, f"--hdf5 needs the HDF5 interop ({_Q}item 1, 'HDF5 "
                   "interop and validation': io/hdf5.py); pass --params "
                   "params.npz"),
    "validate_data": (False, f"--validate-data needs the rest of the data "
                             f"port ({_Q}item 2, 'Data, rest')"),
    "eval_data": (None, f"--eval-data needs the metrics port ({_Q}item 3, "
                        "'Metrics')"),
    "eval_after": (False, f"--eval-after needs the metrics port ({_Q}item "
                          "3, 'Metrics')"),
    "eval_every": (None, f"--eval-every needs the metrics port ({_Q}item 3, "
                         "'Metrics')"),
    "eval_steps": (None, f"--eval-steps needs the metrics port ({_Q}item 3, "
                         "'Metrics')"),
    "optimizer": ("sgd", f"--optimizer other than sgd needs the optimizer "
                         f"port ({_Q}item 4, 'Optimizers')"),
    "grad_clip_norm": (None, f"--grad-clip-norm needs the optimizer port "
                             f"({_Q}item 4, 'Optimizers')"),
    "adagrad_impl": ("hybrid", f"--adagrad-impl needs the optimizer port "
                               f"({_Q}item 4, 'Optimizers')"),
    "update_interval": (1, f"--update-interval > 1 needs block mode ({_Q}"
                           "item 5, 'Block mode')"),
    "block_scan": (False, f"--block-scan needs block mode ({_Q}item 5, "
                          "'Block mode')"),
    "quantize_tables": (None, f"--quantize-tables needs int8 serving ({_Q}"
                              "item 6, 'Int8 serving': ops/quant.py)"),
    "hbm_budget_gb": (None, f"--hbm-budget-gb needs two-tier tables ({_Q}"
                            "item 8, 'Two-tier tables')"),
    "host_prefetch": (False, f"--host-prefetch needs two-tier tables ({_Q}"
                             "item 8, 'Two-tier tables')"),
    "sharded": (None, f"--sharded needs the multi-GPU port ({_MULTI}); this "
                      "package trains on one device"),
    "mesh_shape": (None, f"--mesh-shape needs the multi-GPU port ({_MULTI})"),
    "paranoid": (None, f"--paranoid needs the multi-GPU port ({_MULTI})"),
    "max_rows_per_shard": (None, f"--max-rows-per-shard needs the multi-GPU "
                                 f"port ({_MULTI})"),
    "col_sharded_tables": (None, f"--col-sharded-tables needs the multi-GPU "
                                 f"port ({_MULTI})"),
    "host_tables": (None, f"--host-tables needs the multi-GPU port "
                          f"({_MULTI})"),
    "exchange_dtype": (None, f"--exchange-dtype needs the multi-GPU port "
                             f"({_MULTI})"),
    "distributed": (False, f"--distributed needs the multi-GPU port "
                           f"({_MULTI})"),
    "coordinator": (None, f"--coordinator needs the multi-GPU port "
                          f"({_MULTI})"),
    "num_processes": (None, f"--num-processes needs the multi-GPU port "
                            f"({_MULTI})"),
    "process_id": (None, f"--process-id needs the multi-GPU port "
                         f"({_MULTI})"),
    "chunk_budget_mb": (None, f"--chunk-budget-mb {_TPU_LAYOUT}"),
    "platform": (None, "--platform selects a JAX backend; pass --device"),
}


def _refuse_unported(args) -> None:
    for flag, (default, why) in _NOT_YET.items():
        if getattr(args, flag, default) != default:
            raise SystemExit(why)


# -- config plumbing -----------------------------------------------------------

def _build_config(args, device: torch.device):
    from dlrm_tpu_torch import config as cfg

    presets = {
        "kaggle": cfg.kaggle_config,
        "terabyte": cfg.terabyte_config,
        "fixture": cfg.fixture_config,
        "tiny": cfg.tiny_config,
    }
    if args.config not in presets:
        raise SystemExit(f"unknown --config {args.config!r}; "
                         f"choose from {sorted(presets)}")
    kw = {}
    if args.config in ("kaggle", "terabyte"):
        kw["feature_size"] = args.feature_size
    c = presets[args.config](**kw)
    over = {}
    if args.interaction:
        over["interaction_impl"] = args.interaction
    elif device.type == "cuda":
        # feature-size-keyed default, carried over from the JAX package's
        # accelerator-only rule (config.auto_interaction_impl); CPU runs
        # keep the gram path
        auto_impl = cfg.auto_interaction_impl(c.feature_size)
        if auto_impl != c.interaction_impl:
            over["interaction_impl"] = auto_impl
    if args.n_hot is not None:
        over["n_hot"] = args.n_hot
    if args.bf16:
        over["compute_dtype"] = torch.bfloat16
    if args.bf16_tables:
        over["embedding_dtype"] = torch.bfloat16
    if args.pad_to is not None:
        over["interaction_pad_to"] = args.pad_to
    if args.remat:
        over["remat"] = True
    if args.table_sizes:
        over["table_sizes"] = tuple(
            int(s) for s in args.table_sizes.split(","))
    return dataclasses.replace(c, **over) if over else c


def _add_config_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--config", default="kaggle",
                   help="preset: kaggle|terabyte|fixture|tiny")
    p.add_argument("--feature-size", type=int, default=16,
                   help="embedding dim (kaggle/terabyte presets)")
    p.add_argument("--interaction", default=None,
                   choices=["gram", "pairwise", "fused"],
                   help="interaction impl (default: fused at fs=128 on "
                   "CUDA, gram otherwise)")
    p.add_argument("--n-hot", type=int, default=None,
                   help="multi-hot lookups per table (default preset)")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute dtype for MLPs/interaction")
    p.add_argument("--bf16-tables", action="store_true",
                   help="bfloat16 embedding-table storage")
    p.add_argument("--pad-to", type=int, default=None,
                   help="pad interaction output width to a multiple")
    p.add_argument("--table-sizes", default=None,
                   help="comma-separated table row counts (overrides preset)")
    p.add_argument("--remat", action="store_true",
                   help="recompute the dense tower on backward "
                   "(torch.utils.checkpoint): fewer stored activations")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda when available, "
                   "else cpu)")
    p.add_argument("--chunk-budget-mb", type=int, default=None,
                   help="not served (TPU storage layout)")
    p.add_argument("--validate-data", action="store_true",
                   help="not served yet")
    p.add_argument("--exchange-dtype", default=None, choices=["f32", "bf16"],
                   help="not served yet (multi-GPU)")
    p.add_argument("--platform", default=None,
                   help="not served (a JAX backend); use --device")


def _add_dist_flags(p: argparse.ArgumentParser) -> None:
    for flag, kw in (("--distributed", {"action": "store_true"}),
                     ("--coordinator", {}),
                     ("--num-processes", {"type": int}),
                     ("--process-id", {"type": int})):
        p.add_argument(flag, help="not served yet (multi-GPU)", **kw)


def _strict_bool(s: str) -> bool:
    v = s.lower()
    if v not in ("true", "false"):
        raise argparse.ArgumentTypeError(f"expected true|false, got {s!r}")
    return v == "true"


def _device(args) -> torch.device:
    if args.device:
        return torch.device(args.device)
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def _data_iter(args):
    """One epoch of ``--data`` in file order, the ragged tail included
    (serving must score every row)."""
    from dlrm_tpu_torch.data.criteo import DACLoader, load

    return iter(DACLoader(load(args.data), args.batch_size,
                          drop_remainder=False))


def _train_data_iter(args, config, steps: Optional[int]):
    """Training batches: ``--data`` (full batches, epoch after epoch with
    the loader's shuffles until ``steps``, one epoch without it), or the
    synthetic stream of ``--synthetic`` from ``--seed``.  The same batches
    as the JAX package's ``train`` for the same flags."""
    from dlrm_tpu_torch.data import synthetic
    from dlrm_tpu_torch.data.criteo import DACLoader, load

    if args.data:
        loader = DACLoader(load(args.data), args.batch_size,
                           shuffle=args.shuffle,
                           shuffle_rows=args.shuffle_rows,
                           shuffle_window=args.shuffle_window,
                           seed=args.seed)
        if len(loader) == 0:
            raise SystemExit(
                f"dataset {args.data} has fewer records than one batch "
                f"({args.batch_size}); lower --batch-size")

        def gen():
            count = 0
            while True:
                for batch in loader:
                    yield batch
                    count += 1
                    if steps is not None and count >= steps:
                        return
                if steps is None:
                    return

        return gen()
    if args.synthetic == "skewed":
        truth = synthetic.ClickthroughModel(config, seed=12345)
        return truth.stream(args.batch_size, steps, args.seed + 1)
    return synthetic.batch_stream(config, args.batch_size, steps, args.seed)


def score_batch(params: dict, batch: dict, config,
                device: torch.device) -> np.ndarray:
    """CTR scores (B,) f32 of one numpy batch: the scoring step of
    ``predict``."""
    from dlrm_tpu_torch.models.dlrm import forward

    dense = torch.from_numpy(batch["dense"]).to(device)
    sparse = torch.from_numpy(batch["sparse"]).to(device)
    with torch.inference_mode():
        return forward(params, dense, sparse, config).float().cpu().numpy()


# -- subcommands ---------------------------------------------------------------

def cmd_predict(args) -> int:
    """Batch serving: write CTR scores for every row of a dataset to a
    .npy, in input order, and print one JSON line."""
    from dlrm_tpu_torch.io.convert import load_npz, params_from_numpy

    _refuse_unported(args)
    if args.data is None:
        raise SystemExit("predict needs --data")
    if args.params is None:
        raise SystemExit("predict needs --params (an .npz from "
                         "dlrm_tpu_torch.io.convert.save_npz)")
    device = _device(args)
    config = _build_config(args, device)
    t0 = time.time()
    params = params_from_numpy(load_npz(args.params), config, device)
    scores = [score_batch(params, batch, config, device)
              for batch in _data_iter(args)]
    out = np.concatenate(scores) if scores else np.zeros((0,), np.float32)
    n = out.shape[0]
    np.save(args.out, out)
    print(json.dumps({"examples": int(n), "out": args.out,
                      "seconds": round(time.time() - t0, 2),
                      "mean_score": float(out.mean()) if n else None,
                      "device": device.type}))
    return 0


def _train_lr(args):
    """``--lr``, or the schedule of ``--lr-schedule`` over it; resolves
    ``--epochs`` into ``args.steps``."""
    if args.data is None and args.steps is None:
        raise SystemExit("synthetic training needs --steps")
    if args.epochs:
        if args.data is None:
            raise SystemExit("--epochs needs --data")
        if args.steps is not None:
            raise SystemExit("pass --steps or --epochs, not both")
        from dlrm_tpu_torch.data.criteo import load
        per_epoch = len(load(args.data)) // args.batch_size
        if per_epoch == 0:
            raise SystemExit("dataset smaller than one batch")
        args.steps = args.epochs * per_epoch
    if args.lr_schedule == "constant":
        return args.lr
    from dlrm_tpu_torch.train.optim import make_schedule
    return make_schedule(args.lr, schedule=args.lr_schedule,
                         warmup_steps=args.warmup_steps,
                         decay_start=args.decay_start,
                         decay_steps=args.decay_steps)


def cmd_train(args) -> int:
    """Exact-SGD training on one device from parameters drawn from the
    config's seed; prints a status line every ``--log-every`` steps to
    stderr and one JSON line at the end."""
    from dlrm_tpu_torch.models.dlrm import init_params
    from dlrm_tpu_torch.train.train import train

    _refuse_unported(args)
    lr = _train_lr(args)
    device = _device(args)
    config = _build_config(args, device)
    print(f"device: {device} ({config.interaction_impl} interaction)",
          file=sys.stderr)
    params = init_params(torch.Generator(device).manual_seed(config.seed),
                         config, device)
    t_start = time.time()
    done = [0]  # steps taken; train() syncs on the last step too

    def log(step, loss):
        done[0] = step + 1
        eps = done[0] * args.batch_size / max(time.time() - t_start, 1e-9)
        print(f"step {done[0]} loss {loss:.5f} ({eps:,.0f} examples/s)",
              file=sys.stderr)

    res = train(params, _train_data_iter(args, config, args.steps),
                config=config, lr=lr, callback=log,
                sync_every=max(args.log_every, 1))
    print(json.dumps({"steps": done[0],
                      "final_loss": res["losses"][-1] if res["losses"]
                      else None,
                      "seconds": round(time.time() - t_start, 2),
                      "device": device.type}))
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="dlrm_tpu_torch", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    tr = sub.add_parser("train", help="train a DLRM with exact SGD on one "
                        "device")
    _add_config_flags(tr)
    tr.add_argument("--data", default=None, help="binarized dataset "
                    "(default: synthetic)")
    tr.add_argument("--synthetic", default="uniform",
                    choices=["uniform", "skewed"],
                    help="uniform ids, or skewed: learnable Zipf-id CTR "
                    "with a planted ground truth")
    tr.add_argument("--shuffle", action="store_true",
                    help="shuffle the batch order each epoch")
    tr.add_argument("--shuffle-rows", action="store_true",
                    help="permute rows within windows of --shuffle-window "
                    "batches, and the window order, each epoch")
    tr.add_argument("--shuffle-window", type=int, default=8,
                    help="row-shuffle window size in batches")
    tr.add_argument("--batch-size", type=int, default=2048)
    tr.add_argument("--lr", type=float, default=0.1)
    tr.add_argument("--lr-schedule", default="constant",
                    choices=["constant", "warmup_poly_decay"])
    tr.add_argument("--warmup-steps", type=int, default=0)
    tr.add_argument("--decay-start", type=int, default=0)
    tr.add_argument("--decay-steps", type=int, default=0)
    tr.add_argument("--steps", type=int, default=None)
    tr.add_argument("--epochs", type=int, default=None,
                    help="train for N epochs over --data (instead of "
                    "--steps)")
    tr.add_argument("--seed", type=int, default=0,
                    help="data seed (synthetic stream, shuffles)")
    tr.add_argument("--log-every", type=int, default=100,
                    help="read the loss (a host sync) every N steps")
    tr.add_argument("--prefetch", type=int, default=2,
                    help="accepted; batches are copied to the device "
                    "plainly, one at a time, until data/prefetch.py is "
                    "ported")
    for flag, kw in (
            ("--optimizer", {"default": "sgd"}),
            ("--grad-clip-norm", {"type": float}),
            ("--adagrad-impl", {"default": "hybrid"}),
            ("--update-interval", {"type": int, "default": 1}),
            ("--block-scan", {"action": "store_true"}),
            ("--eval-data", {}),
            ("--eval-after", {"action": "store_true"}),
            ("--eval-every", {"type": int}),
            ("--eval-steps", {"type": int}),
            ("--profile-dir", {}),
            ("--host-prefetch", {"action": "store_true"}),
            ("--hbm-budget-gb", {"type": float}),
            ("--ckpt-dir", {}),
            ("--save-interval", {"type": int, "default": 1000}),
            ("--max-to-keep", {"type": int, "default": 3}),
            ("--sharded", {"type": _strict_bool}),
            ("--paranoid", {"type": int}),
            ("--mesh-shape", {}),
            ("--max-rows-per-shard", {"type": int}),
            ("--col-sharded-tables", {}),
            ("--host-tables", {})):
        tr.add_argument(flag, help="not served yet", **kw)
    _add_dist_flags(tr)
    tr.set_defaults(fn=cmd_train)

    pr = sub.add_parser("predict", help="batch CTR scoring -> .npy")
    _add_config_flags(pr)
    pr.add_argument("--data", default=None, help="binarized dataset")
    pr.add_argument("--params", default=None,
                    help="parameters .npz (io/convert.save_npz)")
    pr.add_argument("--ckpt-dir", default=None, help="not served yet")
    pr.add_argument("--hdf5", default=None, help="not served yet")
    pr.add_argument("--batch-size", type=int, default=16384)
    pr.add_argument("--out", required=True, help="output .npy path")
    pr.add_argument("--quantize-tables", default=None, choices=["int8"],
                    help="not served yet")
    pr.set_defaults(fn=cmd_predict)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
