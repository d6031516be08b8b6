"""Command-line entry point: the single-device subset of ``dlrm_tpu/run.py``.

  preprocess  Criteo text (.txt or .gz) -> binary records + vocabulary
  train       training on one device (synthetic or Criteo data): SGD,
              Adagrad or row-wise Adagrad, gradient clipping, coalesced
              K-step blocks, evaluation during and after, batches copied to
              the device ahead of the step (``--prefetch``), checkpoints
              and resume (``--ckpt-dir``), a profiler trace of three steps
              (``--profile-dir``)
  eval        accuracy / AUC / loss of saved parameters
  predict     batch CTR scoring of a binarized dataset -> .npy
  export      saved parameters -> PyTorch-layout HDF5, or a ready-to-serve
              int8 checkpoint (``--quantize int8``)
  validate    parity against PyTorch-exported HDF5 fixtures
  instrument  one SGD step's time by phase (``utils/telemetry.py``)
  bench       synthetic SGD step time and examples/s

Run as ``python -m dlrm_tpu_torch <subcommand> ...``.  ``eval``,
``predict`` and ``export`` read parameters from a checkpoint directory of
``train --ckpt-dir`` or ``export --quantize int8`` (``--ckpt-dir``), an .npz
written by ``dlrm_tpu_torch.io.convert.save_npz`` (``--params``) or a
PyTorch-layout HDF5 model (``--hdf5``); ``eval`` and ``predict`` serve int8
tables with ``--quantize-tables int8``.  Every flag of the JAX package's CLI
is parsed; one this package does not serve yet exits non-zero, naming the
ROADMAP.md item that brings it, unless it is left at its default.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
from typing import List, Optional

import numpy as np
import torch

_Q = "ROADMAP.md queue 1, "
_TWO_TIER = _Q + "item 2, 'Two-tier tables'"
_MULTI = _Q + "item 3, 'Multi-GPU'"
_TPU_LAYOUT = ("is TPU storage layout, which the port does not carry over "
               "(ROADMAP.md, north star)")

# Flags of the JAX package's CLI that this package does not serve yet:
# flag -> (default, why).  A flag at its default passes.
_NOT_YET = {
    "hbm_budget_gb": (None, f"--hbm-budget-gb needs two-tier tables "
                            f"({_TWO_TIER})"),
    "host_prefetch": (False, f"--host-prefetch needs two-tier tables "
                             f"({_TWO_TIER})"),
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
    # --sharded auto or false passes: one device is what this package
    # trains on
    if getattr(args, "sharded", None):
        raise SystemExit(f"--sharded true needs the multi-GPU port "
                         f"({_MULTI}); this package trains on one device "
                         "(--sharded false)")


# -- config plumbing -----------------------------------------------------------

def _interaction(config, args, device: torch.device):
    """``config`` with ``--interaction``, or on CUDA the feature-size-keyed
    default, carried over from the JAX package's accelerator-only rule
    (config.auto_interaction_impl); CPU runs keep the gram path."""
    from dlrm_tpu_torch import config as cfg

    impl = args.interaction
    if impl is None and device.type == "cuda":
        impl = cfg.auto_interaction_impl(config.feature_size)
    if impl is None or impl == config.interaction_impl:
        return config
    return dataclasses.replace(config, interaction_impl=impl)


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
    return _interaction(dataclasses.replace(c, **over) if over else c, args,
                        device)


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
                   help="torch device (default: cuda; without a GPU the "
                   "command exits unless --device cpu is given)")
    p.add_argument("--chunk-budget-mb", type=int, default=None,
                   help="not served (TPU storage layout)")
    p.add_argument("--validate-data", action="store_true",
                   help="scan every id of --data (and --eval-data) against "
                   "its table's size before the run, and stop naming the "
                   "first record and column outside it")
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
    """``--device``, else the GPU; without one the run stops rather than
    move to the CPU unasked."""
    if args.device:
        return torch.device(args.device)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device found: this command runs on the GPU "
                         "unless asked otherwise; pass --device cpu to run "
                         "it on the CPU")
    return torch.device("cuda")


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


def _check_data(args, config) -> None:
    """``--validate-data``: every id of ``--data`` (and ``--eval-data``)
    inside its table, checked before any parameter reaches the device."""
    from dlrm_tpu_torch.data.criteo import load, validate_ids

    if getattr(args, "validate_data", False):
        for path in (args.data, getattr(args, "eval_data", None)):
            if path:
                validate_ids(load(path), config.table_sizes)


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


def _read_run_meta(ckpt_dir) -> dict:
    path = os.path.join(os.path.abspath(ckpt_dir), "run_meta.json")
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {}


def _check_meta_sizes(meta, config):
    meta_sizes = tuple(meta.get("table_sizes", config.table_sizes))
    if meta_sizes != config.table_sizes:
        raise SystemExit(
            f"checkpoint was trained with table sizes {list(meta_sizes)} "
            f"but the eval config has {list(config.table_sizes)}; pass "
            "the training run's --table-sizes/--config to eval")
    return meta_sizes


def _open_ckpt(args, config):
    """(the parameters' tree of ``checkpoint.Leaf`` s, config, run
    metadata) of the latest checkpoint of ``--ckpt-dir``: the run's
    ``bf16_tables`` applied, its ``table_sizes`` checked, an optimizer
    state's wrapping taken off."""
    from dlrm_tpu_torch.io.checkpoint import open_checkpoint

    meta = _read_run_meta(args.ckpt_dir)
    if meta.get("two_tier"):
        raise SystemExit(f"{args.ckpt_dir} holds a two-tier run's "
                         f"checkpoint, which needs two-tier tables "
                         f"({_TWO_TIER})")
    if meta.get("sharded"):
        raise SystemExit(f"{args.ckpt_dir} holds a sharded run's "
                         f"checkpoint, which needs the multi-GPU port "
                         f"({_MULTI})")
    if meta.get("bf16_tables"):
        config = dataclasses.replace(config, embedding_dtype=torch.bfloat16)
    _check_meta_sizes(meta, config)
    tree, _ = open_checkpoint(args.ckpt_dir)
    if isinstance(tree, dict) and "opt" in tree:
        tree = tree["params"]
    return tree, config, meta


def _file_params(args, device: torch.device):
    """(numpy parameter pytree, config) from ``--hdf5`` (the file's model;
    the flags choose only the interaction), ``--params`` (under the config
    of the flags) or ``--ckpt-dir`` (leaves read a slice of rows at a time; an
    int8 artifact is refused)."""
    from dlrm_tpu_torch.io.convert import load_npz

    if args.ckpt_dir:
        tree, config, meta = _open_ckpt(args, _build_config(args, device))
        if meta.get("quantized"):
            raise SystemExit(f"{args.ckpt_dir} is already an int8 serving "
                             "artifact (export --quantize int8)")
        return {"bottom": [{k: v.array() for k, v in l.items()}
                           for l in tree["bottom"]],
                "emb": tree["emb"].array(),
                "top": [{k: v.array() for k, v in l.items()}
                        for l in tree["top"]]}, config
    if args.hdf5:
        from dlrm_tpu_torch.io.hdf5 import load_params
        np_params, config = load_params(args.hdf5)
        return np_params, _interaction(config, args, device)
    if args.params:
        return load_npz(args.params), _build_config(args, device)
    raise SystemExit(f"{args.cmd} needs --params (an .npz from "
                     "dlrm_tpu_torch.io.convert.save_npz), --ckpt-dir or "
                     "--hdf5")


def _serving_params(args, device: torch.device):
    """(parameters on ``device``, config) for ``eval`` and ``predict``
    (see :func:`_file_params`), after ``--validate-data``.  A checkpoint's
    tensors go to the device chunk by chunk, an int8 artifact's codes and
    scales as they are.  With ``--quantize-tables int8`` the tables are
    quantized on the host (from the checkpoint's files, chunk by
    chunk), and only the int8 codes, their scales and the dense towers
    reach the device."""
    from dlrm_tpu_torch.io.checkpoint import read_tree
    from dlrm_tpu_torch.io.convert import (check_dense, dense_from_numpy,
                                           params_from_numpy)
    from dlrm_tpu_torch.ops.quant import (QuantEmb, check_quant_storage,
                                          quantize_emb_host)

    quantize = args.quantize_tables == "int8"
    if args.ckpt_dir:
        tree, config, meta = _open_ckpt(args, _build_config(args, device))
        if meta.get("quantized") or not quantize:
            _check_data(args, config)
            check_dense(tree, config)
            p = read_tree(tree, device)
            if meta.get("quantized"):  # ready to serve: no quantization
                emb = QuantEmb(p["emb_q"]["codes"], p["emb_q"]["scales"])
                check_quant_storage(emb, config)
            else:
                emb = p["emb"]
                want = (config.total_rows, config.feature_size)
                if tuple(emb.shape) != want or \
                        emb.dtype != config.embedding_dtype:
                    raise SystemExit(
                        f"checkpoint tables {tuple(emb.shape)} {emb.dtype}; "
                        f"the config needs {want} {config.embedding_dtype}")
            return {"bottom": p["bottom"], "emb": emb, "top": p["top"]}, \
                config
    np_params, config = _file_params(args, device)
    _check_data(args, config)
    if quantize:
        qemb = quantize_emb_host(np_params["emb"], config)
        return {**dense_from_numpy(np_params, config, device),
                "emb": qemb.to(device)}, config
    return params_from_numpy(np_params, config, device), config


# -- subcommands ---------------------------------------------------------------

def cmd_preprocess(args) -> int:
    """Criteo text shards -> one binary file (and a vocabulary .npz);
    prints one JSON line, with ``native``: whether the C++ engine ran."""
    from dlrm_tpu_torch.data import criteo, native

    t0 = time.time()
    data = criteo.process(args.inputs, binpath=args.out,
                          vocab_path=args.vocab)
    vocab_sizes = None
    if args.vocab:
        vocab_sizes = criteo.Vocabulary.load(
            args.vocab if args.vocab.endswith(".npz")
            else args.vocab + ".npz").sizes
    print(json.dumps({"records": int(len(data)), "out": args.out,
                      "vocab_sizes": vocab_sizes,
                      "seconds": round(time.time() - t0, 2),
                      "native": native.available()}))
    return 0


def cmd_validate(args) -> int:
    """Each fixture through ``validation.validate``: one JSON line each;
    exits 1 when any fails."""
    from dlrm_tpu_torch.validation import validate

    device = _device(args)
    ok = True
    for path in args.fixtures:
        try:
            report = validate(path, learning_rate=args.lr, device=device)
            worst = max(v["max_abs_err"] for v in report.values())
            print(json.dumps({"fixture": path, "ok": True,
                              "checks": len(report), "worst_abs_err": worst,
                              "device": device.type}))
        except AssertionError as e:
            ok = False
            print(json.dumps({"fixture": path, "ok": False,
                              "error": str(e), "device": device.type}))
    return 0 if ok else 1


def cmd_predict(args) -> int:
    """Batch serving: write CTR scores for every row of a dataset to a
    .npy, in input order, and print one JSON line."""
    _refuse_unported(args)
    if args.data is None:
        raise SystemExit("predict needs --data")
    device = _device(args)
    t0 = time.time()
    params, config = _serving_params(args, device)
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


def _resume(mgr, say, state: dict):
    """The newest checkpoint of ``mgr`` read into the tensors of ``state``
    in place; returns (the restored payload, its step), or (None, 0)
    without a checkpoint (or a manager)."""
    restored = mgr.restore_latest(out=state) if mgr is not None else None
    if restored is None:
        return None, 0
    say(f"resumed from step {restored[1]}")
    return restored


def _build_step(args, config, plan, params: dict, mgr=None,
                say=lambda *a: None) -> argparse.Namespace:
    """The step of a training run, from the newest checkpoint of ``mgr``
    when there is one.  Returns a namespace: ``step(batch) -> (loss, steps
    advanced)`` on tensors of the parameters' device, ``align(step)`` (or
    None) that keeps a scheduled block step's count on the loop's,
    ``start_step``, ``payload()`` (what a checkpoint holds) and
    ``uses_opt``.

    As in the JAX package: plain SGD takes the SGD step, or the SGD block
    (which carries the clip itself) under ``--update-interval``; any other
    optimizer, or a clip at K=1, takes the optimizer-state step or block,
    whose checkpoints hold ``{"params", "opt"}``.  A resumed scheduled SGD
    step starts its count at the checkpoint's step, a scheduled SGD block
    is aligned before each block, and the optimizer-state paths read the
    restored ``opt["count"]``.  A block's ``--adagrad-impl hybrid`` reads
    as ``dense_g`` there; in this package every value runs the one
    implementation."""
    from dlrm_tpu_torch.train import train as T

    lr, block, clip = plan.lr, plan.block, plan.clip
    keys = ("dense", "sparse", "labels")
    v = argparse.Namespace(align=None, uses_opt=(
        args.optimizer != "sgd" or (clip is not None and block == 1)))
    if not v.uses_opt:
        _, v.start_step = _resume(mgr, say, params)
        v.payload = lambda: params
        if block > 1:
            fn = T.make_train_block(config, lr, grad_clip_norm=clip)
            if hasattr(fn, "step"):
                v.align = lambda s: setattr(fn, "step", s)
        else:
            fn = T.make_train_step(config, lr)
            if hasattr(fn, "step"):
                fn.step = v.start_step
        call = lambda b: fn(params, *(b[k] for k in keys))
    else:
        state = {"params": params, "opt": T.init_opt_state(
            params, config=config, optimizer=args.optimizer)}
        restored, v.start_step = _resume(mgr, say, state)
        if restored is not None:
            state["opt"]["count"] = restored["opt"]["count"]
        opt_state = state["opt"]
        v.payload = lambda: state
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
        v.step = lambda b: (call(b)[-1], int(b["dense"].shape[0]))
    else:
        v.step = lambda b: (call(b), 1)
    return v


def _write_run_meta(args, config, v) -> None:
    """``run_meta.json`` beside the checkpoints: the JAX package's keys
    that mean something on one device, so that ``eval``, ``predict`` and
    ``export --ckpt-dir`` rebuild the run's model."""
    meta = {"sharded": False, "optimizer": args.optimizer,
            "two_tier": False, "hbm_budget_gb": None,
            "wrapped_opt": bool(v.uses_opt),
            "table_sizes": list(config.table_sizes),
            "bf16_tables": config.embedding_dtype == torch.bfloat16}
    path = os.path.join(os.path.abspath(args.ckpt_dir), "run_meta.json")
    with open(path, "w") as f:
        json.dump(meta, f)


def run_training(args, config, params: dict, say=lambda *a: None) -> dict:
    """The loop of ``train`` on ``params`` (in place, on their device):
    steps or blocks over the batch stream, a status line through ``say``
    every ``--log-every`` steps, evaluation every ``--eval-every`` steps
    and at the end; returns the result line's dict (without ``device``).
    Batches (K-step blocks: stacked on the host) reach the device through
    ``device_prefetch``, ``--prefetch`` of them ahead of the step.

    With ``--ckpt-dir`` the run resumes from the newest checkpoint there
    (``steps`` then counts this run's steps, and the batch stream restarts
    from ``--seed`` for the ``--steps`` still to go), saves every
    ``--save-interval`` steps and at the end, keeping ``--max-to-keep``.
    With ``--profile-dir`` a ``torch.profiler`` trace of the steps from the
    run's third to its sixth is written there."""
    from dlrm_tpu_torch.data.prefetch import device_prefetch
    from dlrm_tpu_torch.io.checkpoint import CheckpointManager
    from dlrm_tpu_torch.train.metrics import evaluate
    from dlrm_tpu_torch.train.train import batch_to_device
    from dlrm_tpu_torch.utils.telemetry import trace

    plan = _train_plan(args)
    device = params["emb"].device
    mgr = None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir,
                                save_interval=args.save_interval,
                                max_to_keep=args.max_to_keep)
    v = _build_step(args, config, plan, params, mgr, say)
    if mgr is not None:
        _write_run_meta(args, config, v)

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
    step = prev = start_step = v.start_step
    loss = None
    remaining = None if args.steps is None else max(args.steps - start_step,
                                                     0)
    source = _batch_iter(
        config, data=args.data, batch_size=args.batch_size, steps=remaining,
        seed=args.seed, synthetic=args.synthetic, shuffle=args.shuffle,
        shuffle_rows=args.shuffle_rows, shuffle_window=args.shuffle_window)
    if plan.block > 1:
        source = _block_iter(source, plan.block)
    profile_dir = args.profile_dir
    capture, capturing = contextlib.ExitStack(), False
    with capture:
        for batch in device_prefetch(source, size=args.prefetch,
                                     device=device):
            if profile_dir is not None:
                # the steps from start + 3 to start + 6, after warm-up
                if not capturing and step >= start_step + 3:
                    capture.enter_context(trace(profile_dir))
                    capturing = True
                elif capturing and step >= start_step + 6:
                    capture.close()
                    capturing, profile_dir = False, None
                    say("profile written")
            prev = step
            if v.align is not None:
                v.align(step)
            loss, advanced = v.step(batch_to_device(batch, device))
            step += advanced
            if _crossed(prev, step, args.log_every):
                loss = float(loss)  # a host sync
                losses.append(loss)
                eps = ((step - start_step) * args.batch_size
                       / max(time.time() - t_start, 1e-9))
                say(f"step {step} loss {loss:.5f} ({eps:,.0f} examples/s)")
            if _crossed(prev, step, args.eval_every):
                m = run_eval()
                m["step"] = step
                eval_record.append(m)
                say(f"eval @ step {step}: acc={m['accuracy']:.4f} "
                    f"auc={m['auc']:.4f} loss={m['loss']:.5f}")
            if mgr is not None and _crossed(prev, step, mgr.save_interval):
                mgr.save(step, v.payload())
        if capturing:
            capture.close()
            say("profile written (stream ended mid-capture)")
    if mgr is not None:
        if mgr.latest_step() != step:
            mgr.save(step, v.payload(), force=True)
        mgr.close()
    # a run shorter than --log-every still reports its final loss
    if step > start_step and not _crossed(prev, step, args.log_every):
        losses.append(float(loss))
    result = {"steps": step - start_step,
              "final_loss": losses[-1] if losses else None,
              "seconds": round(time.time() - t_start, 2)}
    if eval_record:
        result["eval_record"] = eval_record
    if args.eval_data or args.eval_after:
        result["eval"] = run_eval()
    return result


def cmd_train(args) -> int:
    """Training on one device from parameters drawn from the config's
    seed, or resumed from ``--ckpt-dir``; prints status lines to stderr and
    one JSON line at the end."""
    from dlrm_tpu_torch.models.dlrm import init_params

    _refuse_unported(args)
    device = _device(args)
    config = _build_config(args, device)
    _check_data(args, config)
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
    from dlrm_tpu_torch.train.metrics import evaluate

    _refuse_unported(args)
    device = _device(args)
    params, config = _serving_params(args, device)
    eval_steps = args.eval_steps or (None if args.data else 10)
    data = _batch_iter(config, data=args.data, batch_size=args.batch_size,
                       steps=eval_steps, keep_remainder=True)
    print(json.dumps({**evaluate(params, data, config),
                      "device": device.type}))
    return 0


def cmd_export(args) -> int:
    """Saved parameters (``--ckpt-dir``, ``--hdf5`` or ``--params``) ->
    the PyTorch-layout HDF5 file ``--out`` (``io/hdf5.save_params``).

    ``--quantize int8``: instead a ready-to-serve checkpoint directory
    ``--out`` holding the int8 codes, their scales and the dense towers,
    with ``run_meta.json`` saying ``"quantized": "int8"``; the tables are
    quantized on the host, chunk by chunk from the checkpoint's
    files.  ``eval`` and ``predict --ckpt-dir`` serve it with no
    quantization pass.  Runs on the host; prints one JSON line."""
    from dlrm_tpu_torch.io.checkpoint import save_checkpoint
    from dlrm_tpu_torch.io.convert import dense_from_numpy
    from dlrm_tpu_torch.ops.quant import quantize_emb_host, table_bytes

    _refuse_unported(args)
    np_params, config = _file_params(args, torch.device("cpu"))
    head = {"out": args.out, "tables": config.num_tables,
            "total_rows": config.total_rows}
    if args.quantize == "int8":
        qemb = quantize_emb_host(np_params["emb"], config)
        dense = dense_from_numpy(np_params, config)
        save_checkpoint(args.out, 0, {
            "bottom": dense["bottom"], "top": dense["top"],
            "emb_q": {"codes": qemb.codes, "scales": qemb.scales}})
        meta = {"quantized": "int8", "table_sizes": list(config.table_sizes),
                "bf16_tables": config.embedding_dtype == torch.bfloat16}
        with open(os.path.join(os.path.abspath(args.out), "run_meta.json"),
                  "w") as f:
            json.dump(meta, f)
        print(json.dumps({**head, "table_bytes": table_bytes(qemb),
                          "quantized": "int8"}))
        return 0
    from dlrm_tpu_torch.io.hdf5 import save_params

    save_params(args.out, np_params, config)
    print(json.dumps({**head, "bytes": os.path.getsize(args.out)}))
    return 0


def cmd_instrument(args) -> int:
    """``--steps`` instrumented SGD steps on synthetic batches (the first
    with the no-op callback: its one-time costs stay out); prints the mean
    ms of every phase and the last loss."""
    from dlrm_tpu_torch.data.synthetic import random_batch
    from dlrm_tpu_torch.models.dlrm import init_params
    from dlrm_tpu_torch.utils.telemetry import (InstrumentedTrainer,
                                                Recorder, donothing)

    _refuse_unported(args)
    device = _device(args)
    config = _build_config(args, device)
    params = init_params(torch.Generator(device).manual_seed(config.seed),
                         config, device)
    trainer = InstrumentedTrainer(config, args.lr)
    rec = Recorder()
    rng = np.random.default_rng(args.seed)
    for i in range(args.steps or 10):
        batch = random_batch(rng, config, args.batch_size)
        loss = trainer.step(params, batch, rec if i > 0 else donothing)
    print(json.dumps({"phase_ms": rec.summary(), "loss": loss,
                      "device": device.type}))
    return 0


def cmd_bench(args) -> int:
    """Synthetic SGD throughput: 5 warm-up steps on one batch already on
    the device, then ``--steps`` steps ended by one synchronize; prints ms
    a step and examples/s."""
    from dlrm_tpu_torch.data.synthetic import random_batch
    from dlrm_tpu_torch.models.dlrm import init_params
    from dlrm_tpu_torch.train.train import batch_to_device, make_train_step

    _refuse_unported(args)
    device = _device(args)
    config = _build_config(args, device)
    params = init_params(torch.Generator(device).manual_seed(config.seed),
                         config, device)
    batch = batch_to_device(random_batch(np.random.default_rng(0), config,
                                         args.batch_size), device)
    step = make_train_step(config, args.lr)
    args_ = (batch["dense"], batch["sparse"], batch["labels"])

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    for _ in range(5):
        step(params, *args_)
    sync()
    iters = args.steps or 20
    t0 = time.perf_counter()
    for _ in range(iters):
        step(params, *args_)
    sync()
    dt = (time.perf_counter() - t0) / iters
    print(json.dumps({"step_ms": round(dt * 1e3, 3),
                      "examples_per_s": round(args.batch_size / dt, 1),
                      "device": device.type}))
    return 0


_HDF5_HELP = ("PyTorch-layout HDF5 model (io/hdf5.py), instead of --params; "
              "the model is the file's, the flags choose only the "
              "interaction")
_CKPT_HELP = ("checkpoint directory of train --ckpt-dir (its newest "
              "checkpoint, under the run's run_meta.json) or of export "
              "--quantize int8, instead of --params")
_QUANT_HELP = ("post-training table quantization for serving (symmetric "
               "per-row int8, quantized on the host: about 4x smaller than "
               "f32 on the device)")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="dlrm_tpu_torch", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    pp = sub.add_parser("preprocess", help="Criteo text -> binary + vocab")
    pp.add_argument("inputs", nargs="+", help="text shards (.txt or .gz)")
    pp.add_argument("--out", required=True, help="output binary path")
    pp.add_argument("--vocab", default=None, help="output vocab .npz path")
    pp.set_defaults(fn=cmd_preprocess)

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
                    help="batches (or K-step blocks) marshalled and copied "
                    "to the device ahead of the step: on CUDA from pinned "
                    "host memory on a side stream")
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
    tr.add_argument("--profile-dir", default=None,
                    help="write a torch.profiler trace (Chrome JSON) of the "
                    "run's steps 3 to 6 here; the phase scopes lookup, "
                    "bottom_mlp, interaction and top_mlp show in it")
    tr.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory: resume from its newest "
                    "checkpoint, save into it (io/checkpoint.py)")
    tr.add_argument("--save-interval", type=int, default=1000,
                    help="save a checkpoint every N steps (and at the end)")
    tr.add_argument("--max-to-keep", type=int, default=3,
                    help="checkpoints kept, the newest")
    tr.add_argument("--sharded", type=_strict_bool, default=None,
                    help="false: one device, what this package trains on "
                    "(true is not served yet: multi-GPU)")
    for flag, kw in (
            ("--host-prefetch", {"action": "store_true"}),
            ("--hbm-budget-gb", {"type": float}),
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
    ev.add_argument("--ckpt-dir", default=None, help=_CKPT_HELP)
    ev.add_argument("--hdf5", default=None, help=_HDF5_HELP)
    ev.add_argument("--batch-size", type=int, default=16384)
    ev.add_argument("--eval-steps", type=int, default=None,
                    help="evaluate on this many batches")
    ev.add_argument("--quantize-tables", default=None, choices=["int8"],
                    help=_QUANT_HELP)
    _add_dist_flags(ev)
    ev.set_defaults(fn=cmd_eval)

    pr = sub.add_parser("predict", help="batch CTR scoring -> .npy")
    _add_config_flags(pr)
    pr.add_argument("--data", default=None, help="binarized dataset")
    pr.add_argument("--params", default=None,
                    help="parameters .npz (io/convert.save_npz)")
    pr.add_argument("--ckpt-dir", default=None, help=_CKPT_HELP)
    pr.add_argument("--hdf5", default=None, help=_HDF5_HELP)
    pr.add_argument("--batch-size", type=int, default=16384)
    pr.add_argument("--out", required=True, help="output .npy path")
    pr.add_argument("--quantize-tables", default=None, choices=["int8"],
                    help=_QUANT_HELP)
    pr.set_defaults(fn=cmd_predict)

    ex = sub.add_parser("export", help="parameters -> PyTorch-interop HDF5 "
                        "or an int8 serving checkpoint")
    _add_config_flags(ex)
    ex.add_argument("--ckpt-dir", default=None, help=_CKPT_HELP)
    ex.add_argument("--hdf5", default=None,
                    help="re-export from an HDF5 model instead")
    ex.add_argument("--params", default=None,
                    help="parameters .npz (io/convert.save_npz) instead")
    ex.add_argument("--out", required=True,
                    help="output .hdf5 path (or directory with --quantize)")
    ex.add_argument("--quantize", default=None, choices=["int8"],
                    help="write a ready-to-serve int8 checkpoint directory "
                    "instead of HDF5 (eval/predict serve it directly, no "
                    "per-start quantization pass)")
    ex.set_defaults(fn=cmd_export)

    va = sub.add_parser("validate", help="PyTorch-fixture parity")
    va.add_argument("fixtures", nargs="+")
    va.add_argument("--lr", type=float, default=10.0)
    va.add_argument("--device", default=None,
                    help="torch device (default: cuda; without a GPU the "
                    "command exits unless --device cpu is given)")
    va.set_defaults(fn=cmd_validate)

    ins = sub.add_parser("instrument", help="per-phase step breakdown")
    _add_config_flags(ins)
    ins.add_argument("--batch-size", type=int, default=2048)
    ins.add_argument("--lr", type=float, default=0.1)
    ins.add_argument("--steps", type=int, default=10)
    ins.add_argument("--seed", type=int, default=0)
    ins.set_defaults(fn=cmd_instrument)

    be = sub.add_parser("bench", help="synthetic throughput")
    _add_config_flags(be)
    be.add_argument("--batch-size", type=int, default=32768)
    be.add_argument("--lr", type=float, default=0.1)
    be.add_argument("--steps", type=int, default=20)
    be.set_defaults(fn=cmd_bench)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
