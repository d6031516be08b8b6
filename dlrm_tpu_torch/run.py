"""Command-line entry point: the serving subset of ``dlrm_tpu/run.py``.

  predict   batch CTR scoring of a binarized dataset -> .npy

Run as ``python -m dlrm_tpu_torch predict ...``.  Parameters come from an
.npz written by ``dlrm_tpu_torch.io.convert.save_npz``.
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

# Flags of the JAX package's predict that this package does not serve yet,
# with the ROADMAP.md item that brings each.
_NOT_YET = {
    "ckpt_dir": "--ckpt-dir needs checkpoints (ROADMAP.md queue 1, item 8, "
                "'Checkpoints, telemetry and CLI': io/checkpoint.py); pass "
                "--params params.npz",
    "hdf5": "--hdf5 needs the HDF5 interop (ROADMAP.md queue 1, item 2, "
            "'HDF5 interop and validation': io/hdf5.py); pass --params "
            "params.npz",
    "quantize_tables": "--quantize-tables needs int8 serving (ROADMAP.md "
                       "queue 1, item 7, 'Int8 serving': ops/quant.py)",
}


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
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda when available, "
                   "else cpu)")


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

    for flag, why in _NOT_YET.items():
        if getattr(args, flag):
            raise SystemExit(why)
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
                      "mean_score": float(out.mean()) if n else None}))
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="dlrm_tpu_torch", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

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
