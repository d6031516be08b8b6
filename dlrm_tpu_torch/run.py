"""Command-line entry point: the single-device subset of ``dlrm_tpu/run.py``.

  train     training on one device (synthetic or Criteo data): SGD, Adagrad
            or row-wise Adagrad, gradient clipping, coalesced K-step blocks,
            evaluation during and after
  eval      accuracy / AUC / loss of saved parameters
  predict   batch CTR scoring of a binarized dataset -> .npy

Run as ``python -m dlrm_tpu_torch <subcommand> ...``.  ``eval`` and
``predict`` read parameters from an .npz written by
``dlrm_tpu_torch.io.convert.save_npz``.
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
_DATA = _Q + "item 1, 'Data, HDF5 interop and validation'"
_CKPT = _Q + "item 3, 'Checkpoints, telemetry and CLI'"
_MULTI = _Q + "item 5, 'Multi-GPU'"
_TPU_LAYOUT = ("is TPU storage layout, which the port does not carry over "
               "(ROADMAP.md, north star)")

# Flags of the JAX package's CLI that this package does not serve yet:
# flag -> (default, why).  A flag at its default passes.
_NOT_YET = {
    "ckpt_dir": (None, f"--ckpt-dir needs checkpoints ({_CKPT}: "
                       "io/checkpoint.py); eval and predict take --params "
                       "params.npz"),
    "save_interval": (1000, f"--save-interval needs checkpoints ({_CKPT})"),
    "max_to_keep": (3, f"--max-to-keep needs checkpoints ({_CKPT})"),
    "profile_dir": (None, f"--profile-dir needs the telemetry port ({_CKPT}: "
                          "utils/telemetry.py)"),
    "hdf5": (None, f"--hdf5 needs the HDF5 interop ({_DATA}: io/hdf5.py); "
                   "pass --params params.npz"),
    "validate_data": (False, f"--validate-data needs the rest of the data "
                             f"port ({_DATA})"),
    "quantize_tables": (None, f"--quantize-tables needs int8 serving ({_Q}"
                              "item 2, 'Int8 serving': ops/quant.py)"),
    "hbm_budget_gb": (None, f"--hbm-budget-gb needs two-tier tables ({_Q}"
                            "item 4, 'Two-tier tables')"),
    "host_prefetch": (False, f"--host-prefetch needs two-tier tables ({_Q}"
                             "item 4, 'Two-tier tables')"),
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


def _batch_iter(config, *, data: Optional[str], batch_size: int,
                steps: Optional[int], seed: int = 0,
                synthetic: str = "uniform", keep_remainder: bool = False,
                **shuffle):
    """The batch stream of a subcommand, the same batches as the JAX
    package's for the same flags: ``data`` (epoch after epoch with the
    loader's shuffles until ``steps``, one epoch without it; the ragged
    tail batch included with ``keep_remainder``), or the synthetic stream
    ``synthetic`` from ``seed``."""
    from dlrm_tpu_torch.data import synthetic as synth
    from dlrm_tpu_torch.data.criteo import DACLoader, load

    if data:
        loader = DACLoader(load(data), batch_size,
                           drop_remainder=not keep_remainder, seed=seed,
                           **shuffle)
        if len(loader) == 0:
            raise SystemExit(
                f"dataset {data} has fewer records than one batch "
                f"({batch_size}); lower --batch-size")

        def gen():
            count = 0
            while steps is None or count < steps:
                for batch in loader:
                    yield batch
                    count += 1
                    if steps is not None and count >= steps:
                        return
                if steps is None:
                    return

        return gen()
    if synthetic == "skewed":
        truth = synth.ClickthroughModel(config, seed=12345)
        return truth.stream(batch_size, steps, seed + 1)
    return synth.batch_stream(config, batch_size, steps, seed)


def _block_iter(source, k: int):
    """Stack K consecutive batches on the host for a coalesced block step;
    a remainder shorter than K at the end of the stream is stacked as a
    shorter block."""
    buf = []

    def flush(buf):
        return {key: np.stack([np.asarray(x[key]) for x in buf])
                for key in buf[0]}

    for b in source:
        buf.append(b)
        if len(buf) == k:
            yield flush(buf)
            buf = []
    if buf:
        yield flush(buf)


def _crossed(prev: int, cur: int, every: Optional[int]) -> bool:
    """True when the steps (prev, cur] hold a multiple of ``every`` (a
    block advances the step counter by K at a time)."""
    return bool(every) and (cur // every) > (prev // every)


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
    # one epoch in file order, the ragged tail included: every row scored
    scores = [score_batch(params, batch, config, device)
              for batch in _batch_iter(config, data=args.data,
                                       batch_size=args.batch_size,
                                       steps=None, keep_remainder=True)]
    out = np.concatenate(scores) if scores else np.zeros((0,), np.float32)
    n = out.shape[0]
    np.save(args.out, out)
    print(json.dumps({"examples": int(n), "out": args.out,
                      "seconds": round(time.time() - t0, 2),
                      "mean_score": float(out.mean()) if n else None,
                      "device": device.type}))
    return 0


def _train_plan(args) -> argparse.Namespace:
    """Check the train flags against each other and derive the plan: the
    learning rate (``--lr``, or the schedule of ``--lr-schedule`` over it),
    the block size and the clip; resolves ``--epochs`` into
    ``args.steps``."""
    from dlrm_tpu_torch.train import optim

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
    if args.optimizer not in optim.OPTIMIZERS:
        raise SystemExit(f"--optimizer {args.optimizer!r}: choose from "
                         f"{', '.join(optim.OPTIMIZERS)}")
    try:
        optim.check_emb_impl(args.adagrad_impl)
    except ValueError:
        raise SystemExit(f"--adagrad-impl {args.adagrad_impl!r}: want "
                         "hybrid, hybrid:<MB>, dedup or dense_g") from None
    lr = args.lr
    if args.lr_schedule != "constant":
        lr = optim.make_schedule(args.lr, schedule=args.lr_schedule,
                                 warmup_steps=args.warmup_steps,
                                 decay_start=args.decay_start,
                                 decay_steps=args.decay_steps)
    return argparse.Namespace(lr=lr, block=max(args.update_interval or 1, 1),
                              clip=args.grad_clip_norm)


def _build_step(args, config, plan, params: dict):
    """The step of a training run as ``step(batch) -> (loss, steps
    advanced)`` on tensors of the parameters' device, and ``align(step)``
    (or None) that keeps a scheduled block step's count on the loop's.

    As in the JAX package: plain SGD takes the SGD step, or the SGD block
    (which carries the clip itself) under ``--update-interval``; any other
    optimizer, or a clip at K=1, takes the optimizer-state step or block.
    A block's ``--adagrad-impl hybrid`` reads as ``dense_g`` there; in this
    package every value runs the one implementation."""
    from dlrm_tpu_torch.train import train as T

    lr, block, clip = plan.lr, plan.block, plan.clip
    keys = ("dense", "sparse", "labels")
    align = None
    if args.optimizer == "sgd" and (clip is None or block > 1):
        if block > 1:
            fn = T.make_train_block(config, lr, grad_clip_norm=clip)
            if hasattr(fn, "step"):
                align = lambda s: setattr(fn, "step", s)
        else:
            fn = T.make_train_step(config, lr)
        call = lambda b: fn(params, *(b[k] for k in keys))
    else:
        opt_state = T.init_opt_state(params, config=config,
                                     optimizer=args.optimizer)
        if block > 1:
            impl = args.adagrad_impl
            fn = T.make_train_block_opt(
                config, optimizer=args.optimizer, lr=lr,
                adagrad_impl="dense_g" if impl.startswith("hybrid") else impl,
                unroll=not args.block_scan, grad_clip_norm=clip)
        else:
            fn = T.make_train_step_opt(
                config, optimizer=args.optimizer, lr=lr,
                emb_impl=args.adagrad_impl, grad_clip_norm=clip)
        call = lambda b: fn(params, opt_state, *(b[k] for k in keys))
    if block > 1:
        return (lambda b: (call(b)[-1], int(b["dense"].shape[0]))), align
    return (lambda b: (call(b), 1)), align


def run_training(args, config, params: dict, say=lambda *a: None) -> dict:
    """The loop of ``train`` on ``params`` (in place, on their device):
    steps or blocks over the batch stream, a status line through ``say``
    every ``--log-every`` steps, evaluation every ``--eval-every`` steps
    and at the end; returns the result line's dict (without ``device``)."""
    from dlrm_tpu_torch.train.metrics import evaluate
    from dlrm_tpu_torch.train.train import batch_to_device

    plan = _train_plan(args)
    device = params["emb"].device
    step_fn, align = _build_step(args, config, plan, params)

    def run_eval():
        # the training file when there is no --eval-data; an all-synthetic
        # evaluation needs a bound: 10 batches, from a seed of its own
        eval_data = args.eval_data or args.data
        eval_steps = args.eval_steps
        if eval_data is None and eval_steps is None:
            eval_steps = 10
        return evaluate(params, _batch_iter(
            config, data=eval_data, batch_size=args.batch_size,
            steps=eval_steps, seed=10_000, synthetic=args.synthetic,
            keep_remainder=True), config)

    eval_record: List[dict] = []
    losses: List[float] = []
    t_start = time.time()
    step = prev = 0
    loss = None
    source = _batch_iter(
        config, data=args.data, batch_size=args.batch_size, steps=args.steps,
        seed=args.seed, synthetic=args.synthetic, shuffle=args.shuffle,
        shuffle_rows=args.shuffle_rows, shuffle_window=args.shuffle_window)
    if plan.block > 1:
        source = _block_iter(source, plan.block)
    for batch in source:
        prev = step
        if align is not None:
            align(step)
        loss, advanced = step_fn(batch_to_device(batch, device))
        step += advanced
        if _crossed(prev, step, args.log_every):
            loss = float(loss)  # a host sync
            losses.append(loss)
            eps = step * args.batch_size / max(time.time() - t_start, 1e-9)
            say(f"step {step} loss {loss:.5f} ({eps:,.0f} examples/s)")
        if _crossed(prev, step, args.eval_every):
            m = run_eval()
            m["step"] = step
            eval_record.append(m)
            say(f"eval @ step {step}: acc={m['accuracy']:.4f} "
                f"auc={m['auc']:.4f} loss={m['loss']:.5f}")
    # a run shorter than --log-every still reports its final loss
    if step > 0 and not _crossed(prev, step, args.log_every):
        losses.append(float(loss))
    result = {"steps": step,
              "final_loss": losses[-1] if losses else None,
              "seconds": round(time.time() - t_start, 2)}
    if eval_record:
        result["eval_record"] = eval_record
    if args.eval_data or args.eval_after:
        result["eval"] = run_eval()
    return result


def cmd_train(args) -> int:
    """Training on one device from parameters drawn from the config's
    seed; prints status lines to stderr and one JSON line at the end."""
    from dlrm_tpu_torch.models.dlrm import init_params

    _refuse_unported(args)
    device = _device(args)
    config = _build_config(args, device)
    print(f"device: {device} ({config.interaction_impl} interaction)",
          file=sys.stderr)
    params = init_params(torch.Generator(device).manual_seed(config.seed),
                         config, device)
    result = run_training(args, config, params,
                          say=lambda *a: print(*a, file=sys.stderr))
    print(json.dumps({**result, "device": device.type}))
    return 0


def cmd_eval(args) -> int:
    """Accuracy, AUC and mean loss of saved parameters over ``--data``
    (every row: the ragged tail batch counts), or over 10 synthetic batches
    without it; prints one JSON line."""
    from dlrm_tpu_torch.io.convert import load_npz, params_from_numpy
    from dlrm_tpu_torch.train.metrics import evaluate

    _refuse_unported(args)
    if args.params is None:
        raise SystemExit("eval needs --params (an .npz from "
                         "dlrm_tpu_torch.io.convert.save_npz)")
    device = _device(args)
    config = _build_config(args, device)
    params = params_from_numpy(load_npz(args.params), config, device)
    eval_steps = args.eval_steps or (None if args.data else 10)
    data = _batch_iter(config, data=args.data, batch_size=args.batch_size,
                       steps=eval_steps, keep_remainder=True)
    print(json.dumps({**evaluate(params, data, config),
                      "device": device.type}))
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="dlrm_tpu_torch", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    tr = sub.add_parser("train", help="train a DLRM on one device")
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
    tr.add_argument("--optimizer", default="sgd",
                    help="sgd | adagrad | rowwise_adagrad (one f32 "
                    "accumulator scalar per embedding row; the dense "
                    "parameters take elementwise Adagrad)")
    tr.add_argument("--grad-clip-norm", type=float, default=None,
                    help="global-norm gradient clipping over the step's "
                    "full gradient (dense towers and embedding rows); in a "
                    "block, each micro-step is clipped")
    tr.add_argument("--update-interval", type=int, default=1,
                    help="K: coalesce the big-table embedding updates of K "
                    "consecutive steps into one update (big-table rows are "
                    "read as of block entry: stale by fewer than K steps).  "
                    "Kept for the bounded-staleness semantics: on one GPU "
                    "a block is no faster than K steps, and an SGD block "
                    "is slower (it splits every micro-step's gradient rows "
                    "into big and small tables, which the SGD step need "
                    "not)")
    tr.add_argument("--adagrad-impl", default="hybrid",
                    help="hybrid | hybrid:<MB> | dedup | dense_g: the JAX "
                    "package's three exact-Adagrad implementations, which "
                    "give the same results at different TPU cost.  This "
                    "package has one implementation (dedup then apply) and "
                    "runs it for every accepted value")
    tr.add_argument("--block-scan", action="store_true",
                    help="accepted: a compile-time choice of the JAX "
                    "package; blocks here run one Python loop either way")
    tr.add_argument("--eval-data", default=None,
                    help="binarized dataset to evaluate on (default: "
                    "--data, else 10 synthetic batches)")
    tr.add_argument("--eval-after", action="store_true",
                    help="evaluate after the last step")
    tr.add_argument("--eval-every", type=int, default=None,
                    help="evaluate every N steps")
    tr.add_argument("--eval-steps", type=int, default=None,
                    help="evaluate on this many batches")
    for flag, kw in (
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

    ev = sub.add_parser("eval", help="accuracy / AUC / loss")
    _add_config_flags(ev)
    ev.add_argument("--data", default=None, help="binarized dataset "
                    "(default: 10 synthetic batches)")
    ev.add_argument("--params", default=None,
                    help="parameters .npz (io/convert.save_npz)")
    ev.add_argument("--ckpt-dir", default=None, help="not served yet")
    ev.add_argument("--hdf5", default=None, help="not served yet")
    ev.add_argument("--batch-size", type=int, default=16384)
    ev.add_argument("--eval-steps", type=int, default=None,
                    help="evaluate on this many batches")
    ev.add_argument("--quantize-tables", default=None, choices=["int8"],
                    help="not served yet")
    _add_dist_flags(ev)
    ev.set_defaults(fn=cmd_eval)

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
