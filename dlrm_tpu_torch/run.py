"""Command-line entry point: the counterpart of ``dlrm_tpu/run.py``.

  preprocess  Criteo text (.txt or .gz) -> binary records + vocabulary
  train       training (synthetic or Criteo data): SGD, Adagrad or row-wise
              Adagrad, gradient clipping, coalesced K-step blocks,
              evaluation during and after, batches copied to the device
              ahead of the step (``--prefetch``), checkpoints and resume
              (``--ckpt-dir``), a profiler trace of three steps
              (``--profile-dir``), two-tier tables with the biggest in
              pinned host memory (``--hbm-budget-gb``, ``--host-prefetch``);
              the tables sharded over a gang of processes, one a device
              (``--sharded``, ``--distributed``, ``--mesh-shape``,
              ``--max-rows-per-shard``, ``--col-sharded-tables``,
              ``--host-tables``, ``--exchange-dtype``, ``--paranoid``)
  eval        accuracy / AUC / loss of saved parameters (a sharded run's
              on the gang's mesh with ``--sharded true`` or
              ``--distributed``)
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
is parsed; the two that select TPU layout or a JAX backend exit non-zero
unless left at their default.

A sharded run is one process a device: ``--distributed`` joins a gang
(``--coordinator host:port --num-processes N --process-id R``, or the
``torchrun`` environment), and ``--sharded true`` alone makes a gang of
this one process.  The backend follows ``--device``: NCCL on ``cuda``,
gloo on ``cpu``; one never stands in for the other.  Only the lead process
(rank 0) prints status lines and the result line.  A sharded run's
checkpoint serves in one process, its tables unsharded onto the device a
table at a time, or on a gang's mesh (``--sharded true`` / ``--distributed``
of ``eval`` and ``predict``), restored onto that gang's number of ranks.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import os
import sys
import time
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from dlrm_tpu_torch.parallel.placement import _TPU_LAYOUT

# Flags of the JAX package's CLI that this package does not serve: flag ->
# (default, why).  A flag at its default passes.
_NOT_YET = {
    "chunk_budget_mb": (None, f"--chunk-budget-mb {_TPU_LAYOUT}"),
    "platform": (None, "--platform selects a JAX backend; pass --device"),
}


def _refuse_unported(args) -> None:
    for flag, (default, why) in _NOT_YET.items():
        if getattr(args, flag, default) != default:
            raise SystemExit(why)


# -- the gang ------------------------------------------------------------------

class _Gang(NamedTuple):
    """The process group a run joined: its size, this process's rank, and
    the device this rank drives."""

    world: int
    rank: int
    device: torch.device

    @property
    def lead(self) -> bool:
        return self.rank == 0


@contextlib.contextmanager
def _process_group(args, device: torch.device, join: bool):
    """The run's gang: ``--distributed`` joins one (``parallel.mesh
    .init_distributed``, from ``--coordinator``, ``--num-processes`` and
    ``--process-id``, or the ``torchrun`` environment), ``join`` alone
    makes a gang of this process (``init_single_process``); NCCL on
    ``cuda``, gloo on the CPU.  Yields a :class:`_Gang`, or None without
    either; the group made here is destroyed on the way out."""
    import torch.distributed as dist
    from dlrm_tpu_torch.parallel import mesh as pmesh

    if not (getattr(args, "distributed", False) or join):
        yield None
        return
    made = not dist.is_initialized()
    try:
        if args.distributed:
            dev = pmesh.init_distributed(args.coordinator, args.num_processes,
                                         args.process_id, device=device)
        else:
            dev = pmesh.init_single_process(device)
    except ValueError as e:  # flags that do not make a gang
        raise SystemExit(f"--distributed: {e}") from None
    try:
        yield _Gang(dist.get_world_size(), dist.get_rank(), dev)
    finally:
        if made and dist.is_initialized():
            dist.destroy_process_group()


def _say_for(lead: bool):
    """Status lines to stderr, from the lead process only."""
    if lead:
        return lambda *a: print(*a, file=sys.stderr)
    return lambda *a: None


def _tables(flag: Optional[str]) -> tuple:
    return tuple(int(x) for x in flag.split(",")) if flag else ()


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
    if getattr(args, "exchange_dtype", None) == "bf16":
        over["exchange_dtype"] = torch.bfloat16
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
                   help="wire dtype of the sharded embedding exchanges: "
                   "bf16 halves their bytes at one rounding an exchange")
    p.add_argument("--platform", default=None,
                   help="not served (a JAX backend); use --device")


def _add_dist_flags(p: argparse.ArgumentParser) -> None:
    for flag, kw, what in (
            ("--distributed", {"action": "store_true"},
             "join a gang of processes, one a device (NCCL on cuda, gloo "
             "on the CPU); the run is sharded over it"),
            ("--coordinator", {}, "host:port (or a tcp:// or file:// URL) "
             "of rank 0's store; without it --distributed reads the "
             "torchrun environment"),
            ("--num-processes", {"type": int}, "the gang's size"),
            ("--process-id", {"type": int}, "this process's rank")):
        p.add_argument(flag, help=what, **kw)


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
                rows=None, **shuffle):
    """The batch stream of a subcommand, the same batches as the JAX
    package's for the same flags: ``data`` (epoch after epoch with the
    loader's shuffles until ``steps``, one epoch without it; the ragged
    tail batch included with ``keep_remainder``), or the synthetic stream
    ``synthetic`` from ``seed``.  ``rows=(lo, hi)``: only this process's
    rows of every batch (a gang's feeding, ``parallel.mesh
    .local_batch_rows``), the batches' cadence and contents those of the
    whole stream."""
    from dlrm_tpu_torch.data import synthetic as synth
    from dlrm_tpu_torch.data.criteo import DACLoader, load

    if data:
        loader = DACLoader(load(data), batch_size,
                           drop_remainder=not keep_remainder, seed=seed,
                           local_rows=rows, **shuffle)
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
        return truth.stream(batch_size, steps, seed + 1, rows=rows)
    return synth.batch_stream(config, batch_size, steps, seed, rows=rows)


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


def _with_lookahead(source):
    """One-batch lookahead for the pipelined two-tier step: each batch
    carries the next batch's ids as ``sparse_next``; the last one carries
    its own."""
    prev = None
    for b in source:
        if prev is not None:
            yield {**prev, "sparse_next": b["sparse"]}
        prev = b
    if prev is not None:
        yield {**prev, "sparse_next": prev["sparse"]}


def _crossed(prev: int, cur: int, every: Optional[int]) -> bool:
    """True when the steps (prev, cur] hold a multiple of ``every`` (a
    block advances the step counter by K at a time)."""
    return bool(every) and (cur // every) > (prev // every)


def score_batch(params: dict, batch: dict, config,
                device: torch.device) -> np.ndarray:
    """CTR scores (B,) f32 of one numpy batch: the scoring step of
    ``predict``.  The copies to the device run under the span
    ``score_batch.h2d``, the scores' copy back under
    ``score_batch.readback``."""
    from dlrm_tpu_torch.models.dlrm import forward
    from dlrm_tpu_torch.utils.telemetry import phase_scope

    with phase_scope("score_batch.h2d"):
        dense = torch.from_numpy(batch["dense"]).to(device)
        sparse = torch.from_numpy(batch["sparse"]).to(device)
    with torch.inference_mode():
        scores = forward(params, dense, sparse, config)
        with phase_scope("score_batch.readback"):
            return scores.float().cpu().numpy()


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


def _tier_plan(meta, config):
    """The tier plan of a two-tier run's checkpoint, from its
    ``hbm_budget_gb``."""
    from dlrm_tpu_torch.parallel.host_tier import GIB, plan_tiers

    return plan_tiers(config, int(meta["hbm_budget_gb"] * GIB))


def _open_ckpt(args, config):
    """(the parameters' tree of ``checkpoint.Leaf`` s, config, run
    metadata) of the latest checkpoint of ``--ckpt-dir``: the run's
    ``bf16_tables`` applied, its ``table_sizes`` checked, an optimizer
    state's wrapping taken off.  A two-tier run's tree holds ``emb_dev``
    and ``emb_host`` in place of ``emb``; a sharded run's its per-shard
    stacks (``emb``, ``emb_cs``, ``emb_h``: :func:`_saved_placement`)."""
    from dlrm_tpu_torch.io.checkpoint import open_checkpoint

    meta = _read_run_meta(args.ckpt_dir)
    if meta.get("bf16_tables"):
        config = dataclasses.replace(config, embedding_dtype=torch.bfloat16)
    _check_meta_sizes(meta, config)
    tree, _ = open_checkpoint(args.ckpt_dir)
    if isinstance(tree, dict) and "opt" in tree:
        tree = tree["params"]
    return tree, config, meta


def _saved_placement(ckpt_dir):
    """(placement record, ``TablePlacement``) of the latest checkpoint of
    a sharded run."""
    from dlrm_tpu_torch.io.checkpoint import checkpoint_placement
    from dlrm_tpu_torch.parallel.placement import plan_placement

    record = checkpoint_placement(ckpt_dir)
    if record is None:
        raise SystemExit(f"{ckpt_dir}: run_meta.json says sharded, but its "
                         "checkpoint holds no placement")
    return record, plan_placement(**record)


def _saved_tables(tree) -> dict:
    """A sharded checkpoint's table leaves as arrays read a slice at a
    time (``parallel.embedding.table_rows`` takes them)."""
    return {"emb": tree["emb"].array(),
            "emb_h": tree["emb_h"].array() if "emb_h" in tree else None,
            "emb_cs": [leaf.array() for leaf in tree.get("emb_cs", ())]}


def _logical_chunks(tree, placement, config):
    """(first row in the logical stack, rows ``(n, D)`` numpy) of a sharded
    checkpoint's tables, table by table, ``models.dlrm.INIT_CHUNK_ROWS``
    rows at a time: the unshard that never holds more than a chunk."""
    from dlrm_tpu_torch.models.dlrm import INIT_CHUNK_ROWS
    from dlrm_tpu_torch.parallel.embedding import table_rows

    src = _saved_tables(tree)
    for t, rows in enumerate(config.table_sizes):
        off = config.table_offsets[t]
        for a in range(0, rows, INIT_CHUNK_ROWS):
            b = min(a + INIT_CHUNK_ROWS, rows)
            yield off + a, table_rows(src, placement, t, a, b)


def _file_params(args, device: torch.device):
    """(numpy parameter pytree, config) from ``--hdf5`` (the file's model;
    the flags choose only the interaction), ``--params`` (under the config
    of the flags) or ``--ckpt-dir`` (leaves read a slice of rows at a time, a
    two-tier run's tiers merged on the host a table at a time, a sharded
    run's tables unsharded a chunk at a time; an int8 artifact is
    refused)."""
    from dlrm_tpu_torch.io.convert import load_npz

    if args.ckpt_dir:
        tree, config, meta = _open_ckpt(args, _build_config(args, device))
        if meta.get("quantized"):
            raise SystemExit(f"{args.ckpt_dir} is already an int8 serving "
                             "artifact (export --quantize int8)")
        if meta.get("two_tier"):
            from dlrm_tpu_torch.parallel.host_tier import merge_tiers
            emb = merge_tiers(tree["emb_dev"].array(),
                              tree["emb_host"].array(),
                              _tier_plan(meta, config), config).numpy()
        elif meta.get("sharded"):
            emb = np.empty((config.total_rows, config.feature_size),
                           np.float32)
            for lo, rows in _logical_chunks(
                    tree, _saved_placement(args.ckpt_dir)[1], config):
                emb[lo:lo + rows.shape[0]] = rows
        else:
            emb = tree["emb"].array()
        return {"bottom": [{k: v.array() for k, v in l.items()}
                           for l in tree["bottom"]],
                "emb": emb,
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
    scales as they are, a two-tier run's device tier to the device and its
    host tier into pinned host memory (``TieredEmb``).  With
    ``--quantize-tables int8`` the tables are quantized on the host (from
    the checkpoint's files, chunk by chunk), and only the int8 codes, their
    scales and the dense towers reach the device."""
    from dlrm_tpu_torch.io.checkpoint import read_tree
    from dlrm_tpu_torch.io.convert import (check_dense, dense_from_numpy,
                                           params_from_numpy)
    from dlrm_tpu_torch.ops.quant import (QuantEmb, check_quant_storage,
                                          quantize_emb_host)

    quantize = args.quantize_tables == "int8"
    if args.ckpt_dir:
        tree, config, meta = _open_ckpt(args, _build_config(args, device))
        if meta.get("sharded"):
            return _unsharded_params(args, tree, config, device,
                                     quantize), config
        if meta.get("quantized") or not quantize:
            _check_data(args, config)
            check_dense(tree, config)
            if meta.get("two_tier"):
                from dlrm_tpu_torch.parallel.host_tier import place_tiered
                return place_tiered(tree, _tier_plan(meta, config), config,
                                    device), config
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


def _unsharded_params(args, tree, config, device, quantize: bool) -> dict:
    """A sharded run's checkpoint served by one process: the tables
    unsharded straight into the one-device stack on ``device``, a chunk
    at a time (with ``quantize``, each chunk quantized on the host: only
    codes and scales reach the device)."""
    from dlrm_tpu_torch.io.checkpoint import read_tree
    from dlrm_tpu_torch.io.convert import check_dense
    from dlrm_tpu_torch.ops.quant import (QuantEmb, check_quant_storage,
                                          quantize_rows_host)

    _check_data(args, config)
    check_dense(tree, config)
    dense = read_tree({"bottom": tree["bottom"], "top": tree["top"]},
                      device)
    shape = (config.total_rows, config.feature_size)
    if quantize:
        emb = QuantEmb(torch.empty(shape, dtype=torch.int8, device=device),
                       torch.empty(shape[0], dtype=torch.float32,
                                   device=device))
    else:
        emb = torch.empty(shape, dtype=config.embedding_dtype, device=device)
    placement = _saved_placement(args.ckpt_dir)[1]
    for lo, rows in _logical_chunks(tree, placement, config):
        hi = lo + rows.shape[0]
        if quantize:
            codes, scales = quantize_rows_host(rows)
            emb.codes[lo:hi] = torch.from_numpy(codes).to(device)
            emb.scales[lo:hi] = torch.from_numpy(scales).to(device)
        else:
            emb[lo:hi] = torch.from_numpy(rows).to(device, emb.dtype)
    if quantize:
        check_quant_storage(emb, config)
    return {**dense, "emb": emb}


def _mesh_params(args, config, gang: _Gang, quantize: bool):
    """A sharded run's checkpoint restored onto this gang (its world size
    the number of table shards; the run's placement flags kept) for
    serving on the mesh.  Returns (this rank's parameters, mesh,
    placement, config).  f32: ``io.checkpoint.read_sharded``, a rank's
    slabs straight into its tensors under the saved placement, table by
    table under another.  ``quantize``: each rank reads its tables a chunk
    at a time on the host and quantizes them there (a logical row's codes
    and scale, a column shard's lanes their own), so only the int8 codes,
    their scales and the dense towers reach the device; host-resident
    tables stay in full precision, in host memory."""
    from dlrm_tpu_torch.io.checkpoint import (Shard, ShardGroup, read_sharded,
                                              read_tree)
    from dlrm_tpu_torch.models.dlrm import INIT_CHUNK_ROWS
    from dlrm_tpu_torch.ops.quant import quantize_rows_host
    from dlrm_tpu_torch.parallel import embedding as pemb
    from dlrm_tpu_torch.parallel.mesh import make_mesh
    from dlrm_tpu_torch.parallel.placement import plan_placement

    tree, config, meta = _open_ckpt(args, config)
    if not meta.get("sharded"):
        raise SystemExit(
            f"{args.cmd} on a mesh (--sharded true / --distributed) serves "
            "a SHARDED run's checkpoint (--ckpt-dir of train --sharded "
            "true); serve this one in one process")
    _check_data(args, config)
    saved, old = _saved_placement(args.ckpt_dir)
    record = {**saved, "num_shards": gang.world}
    placement = plan_placement(**record)
    mesh = make_mesh()
    index, device = mesh.get_local_rank("d"), gang.device
    d = config.feature_size
    dense = read_tree({"bottom": tree["bottom"], "top": tree["top"]},
                      device)
    if not quantize:
        out = pemb.empty_shard(placement, index, d, config.embedding_dtype,
                               device)
        state = {**dense, "emb": Shard(out["emb"]),
                 "emb_cs": tuple(Shard(c) for c in out["emb_cs"])}
        if out["emb_h"] is not None:
            state["emb_h"] = Shard(out["emb_h"])
        read_sharded(tree, saved, ShardGroup(index, gang.world, False,
                                             gang.lead, record), state)
        params = {**dense, "emb": out["emb"], "emb_cs": out["emb_cs"]}
        if out["emb_h"] is not None:
            params["emb_h"] = out["emb_h"]
        return params, mesh, placement, config
    codes = pemb.empty_shard(placement, index, d, torch.int8, device,
                             host=False)
    host = None
    if placement.host_row_sharded:
        host = pemb.empty_shard(placement, index, d, config.embedding_dtype,
                                device)["emb_h"]
    scales = {"emb": torch.ones((placement.local_rows, 1),
                                dtype=torch.float32, device=device),
              "emb_h": None,
              "emb_cs": tuple(torch.ones(placement.table_sizes[t],
                                         dtype=torch.float32, device=device)
                              for t in placement.col_sharded)}
    src, wc = _saved_tables(tree), d // placement.num_shards
    for t, rows in enumerate(config.table_sizes):
        on_host = t in placement.host_row_sharded
        for a in range(0, rows, INIT_CHUNK_ROWS):
            x = pemb.table_rows(src, old, t, a, min(a + INIT_CHUNK_ROWS, rows))
            if on_host:  # full precision, in host memory
                pemb.place_rows(x, t, a, placement, index,
                                {"emb": None, "emb_h": host, "emb_cs": ()})
                continue
            if t in placement.col_sharded:  # a scale for this rank's lanes
                x = x[:, index * wc:(index + 1) * wc]
            q, sc = quantize_rows_host(x)
            pemb.place_rows(q, t, a, placement, index, codes)
            pemb.place_rows(sc[:, None], t, a, placement, index, scales)
    params = {**dense, "emb": codes["emb"], "emb_cs": codes["emb_cs"],
              "emb_scales": scales["emb"].view(-1),
              "emb_cs_scales": scales["emb_cs"]}
    if host is not None:
        params["emb_h"] = host
    return params, mesh, placement, config


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


def _mesh_scorer(params: dict, mesh, placement, config, device):
    """``score(batch) -> (B,) f32 numpy`` on a mesh of one rank: a ragged
    batch padded to the mesh's ranks by repeating its last row, the
    padded scores dropped."""
    from dlrm_tpu_torch.train.metrics import make_sharded_eval_forward

    fwd = make_sharded_eval_forward(config, mesh, placement)
    dense_params = {"bottom": params["bottom"], "top": params["top"]}
    ranks = mesh.mesh.numel()

    def score(batch):
        dense, sparse = (torch.as_tensor(batch[k]) for k in
                         ("dense", "sparse"))
        b = dense.shape[0]
        pad = -b % ranks
        if pad:
            dense = torch.cat([dense, dense[-1:].expand(pad, -1)])
            sparse = torch.cat([sparse, sparse[-1:].expand(
                pad, *sparse.shape[1:])])
        with torch.inference_mode():
            preds = fwd(dense_params, params["emb"],
                        tuple(params.get("emb_cs", ())), dense.to(device),
                        sparse.to(device), params.get("emb_h"),
                        params.get("emb_scales"),
                        tuple(params.get("emb_cs_scales", ())))
        return preds[:b].float().cpu().numpy()

    return score


def cmd_predict(args) -> int:
    """Batch serving: write CTR scores for every row of a dataset to a
    .npy, in input order, and print one JSON line.  ``--sharded true``
    (or ``--distributed`` of one process) serves a sharded run's
    checkpoint on a mesh of this process; the scores go to one file, so a
    gang of more processes is refused, as in the JAX package."""
    _refuse_unported(args)
    if args.data is None:
        raise SystemExit("predict needs --data")
    device = _device(args)
    t0 = time.time()
    with _process_group(args, device, join=bool(args.sharded)) as gang:
        if gang is not None:
            if gang.world > 1:
                raise SystemExit(
                    "predict is single-process (scores stream to one "
                    ".npy); run it on one host — a sharded checkpoint "
                    "still serves on-mesh there")
            device = gang.device
            params, mesh, placement, config = _mesh_params(
                args, _build_config(args, device), gang,
                args.quantize_tables == "int8")
            score = _mesh_scorer(params, mesh, placement, config, device)
        else:
            params, config = _serving_params(args, device)
            score = functools.partial(score_batch, params, config=config,
                                      device=device)
        # one epoch in file order, the ragged tail included: every row
        # scored
        scores = [score(batch)
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


def _train_plan(args, world: int = 1) -> argparse.Namespace:
    """Check the train flags against each other and derive the plan: the
    learning rate (``--lr``, or the schedule of ``--lr-schedule`` over it),
    the block size, the clip and the sharding (``sharded``; the 2-D mesh's
    ``dcn_n`` x ``ici_n``, or None; ``n_shards``, the table group's size);
    resolves ``--epochs`` into ``args.steps``.  ``world``: the gang's
    size, which plays the JAX package's device count (one process drives
    one device)."""
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
    block = max(args.update_interval or 1, 1)
    tiered = args.hbm_budget_gb is not None
    # the JAX package's refusals of two-tier runs
    if args.grad_clip_norm is not None and tiered:
        raise SystemExit("--grad-clip-norm supports the per-step and block "
                         "paths only; drop --hbm-budget-gb")
    sharded = args.sharded if args.sharded is not None else world > 1
    if tiered and sharded:
        raise SystemExit(
            "--hbm-budget-gb is the single-chip two-tier layout and does "
            "not compose with the sharded path (auto-enabled here: "
            f"{world} devices). Pass --sharded false for two-tier on one "
            "device, or use --host-tables N,M for host-resident tables "
            "under sharding")
    if world > 1:
        if not sharded:
            raise SystemExit("--distributed (multi-process) requires the "
                             "sharded path; drop --sharded=false")
        if args.batch_size % world:
            raise SystemExit(f"--batch-size {args.batch_size} must divide "
                             f"evenly over the {world}-device global mesh")
    dcn_n = ici_n = None
    if args.mesh_shape:
        if not sharded:
            raise SystemExit("--mesh-shape requires the sharded path")
        try:
            dcn_n, ici_n = (int(x) for x in
                            args.mesh_shape.lower().split("x"))
        except ValueError:
            raise SystemExit(f"--mesh-shape {args.mesh_shape!r}: want "
                             "DCNxICI, e.g. 2x4") from None
        if dcn_n < 1 or ici_n < 1:
            raise SystemExit(f"--mesh-shape {args.mesh_shape}: both "
                             "dimensions must be >= 1")
        # one process a device: the mesh takes every rank of the gang
        if dcn_n * ici_n != world:
            raise SystemExit(f"--mesh-shape {args.mesh_shape} needs "
                             f"{dcn_n * ici_n} devices, have {world}")
        if args.batch_size % (dcn_n * ici_n):
            raise SystemExit(
                f"--batch-size {args.batch_size} must divide evenly over "
                f"the {dcn_n * ici_n}-device hybrid mesh")
    if args.paranoid and not (sharded and ici_n):
        raise SystemExit("--paranoid guards the hybrid (DCNxICI) mesh; it "
                         "needs --mesh-shape")
    if args.host_prefetch:
        if not tiered:
            raise SystemExit("--host-prefetch is a two-tier feature; it needs "
                             "--hbm-budget-gb")
        if args.optimizer != "sgd" or callable(lr):
            raise SystemExit("--host-prefetch currently supports sgd with a "
                             "constant lr")
    if block > 1 and tiered:
        if callable(lr):
            raise SystemExit("--update-interval > 1 with --hbm-budget-gb "
                             "supports a constant lr only")
        if args.host_prefetch:
            raise SystemExit("--host-prefetch does not compose with "
                             "--update-interval > 1 (the block is the "
                             "prefetch batching)")
    return argparse.Namespace(lr=lr, block=block, clip=args.grad_clip_norm,
                              sharded=sharded, dcn_n=dcn_n, ici_n=ici_n,
                              n_shards=ici_n if ici_n else world)


def _rate(nbytes: int, seconds: float) -> str:
    return (f"{nbytes / 1e9:.2f} GB in {seconds:.2f} s "
            f"({nbytes / 1e9 / max(seconds, 1e-9):.2f} GB/s)")


def _resume(mgr, say, state: dict):
    """The newest checkpoint of ``mgr`` read into the tensors of ``state``
    in place; returns (the restored payload, its step), or (None, 0)
    without a checkpoint (or a manager).  Says how long it took."""
    from dlrm_tpu_torch.io.checkpoint import payload_bytes

    t0 = time.perf_counter()
    restored = mgr.restore_latest(out=state) if mgr is not None else None
    if restored is None:
        return None, 0
    say(f"resumed from step {restored[1]}: this process's "
        f"{_rate(payload_bytes(state), time.perf_counter() - t0)}")
    return restored


def _build_step(args, config, plan, params: dict, mgr=None,
                say=lambda *a: None, shard=None) -> argparse.Namespace:
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
    from dlrm_tpu_torch.parallel.host_tier import TieredEmb
    from dlrm_tpu_torch.train import train as T

    if isinstance(params["emb"], TieredEmb):
        return _build_tiered_step(args, config, plan, params, mgr, say)
    if shard is not None:
        return _build_sharded_step(args, config, plan, params, shard, mgr,
                                   say)
    lr, block, clip = plan.lr, plan.block, plan.clip
    keys = ("dense", "sparse", "labels")
    v = argparse.Namespace(align=None, lookahead=False, uses_opt=(
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


def _build_tiered_step(args, config, plan, params: dict, mgr=None,
                       say=lambda *a: None) -> argparse.Namespace:
    """:func:`_build_step` for two-tier parameters, as the JAX package
    picks: SGD at a constant lr takes the tiered step, block
    (``--update-interval``) or pipelined step (``--host-prefetch``: the
    batches then carry the next batch's ids, ``v.lookahead``); any other
    optimizer or a schedule takes the optimizer-state step or block.
    Checkpoints hold ``host_tier.tiered_payload`` (and ``{"params",
    "opt"}``), restored into the live tensors, the host tier's straight
    into pinned memory."""
    from dlrm_tpu_torch.parallel import host_tier as ht

    lr, block = plan.lr, plan.block
    keys = ("dense", "sparse", "labels")
    payload = ht.tiered_payload(params)
    v = argparse.Namespace(align=None, lookahead=False, uses_opt=(
        args.optimizer != "sgd" or callable(lr)))
    if not v.uses_opt:
        _, v.start_step = _resume(mgr, say, payload)
        v.payload = lambda: payload
        if block > 1:
            fn = ht.tiered_train_block
        elif args.host_prefetch:
            v.lookahead, box = True, {"rows": None}

            def fn(p, dense, sparse, labels, sparse_next, config, lr):
                if box["rows"] is None:  # the pipeline's first gather
                    box["rows"] = ht.prime_host_prefetch(p["emb"], sparse)
                box["rows"], loss = ht.tiered_train_step_pipelined(
                    p, box["rows"], dense, sparse, labels, sparse_next,
                    config=config, lr=lr)
                return loss
            keys += ("sparse_next",)
        else:
            fn = ht.tiered_train_step
        call = lambda b: fn(params, *(b[k] for k in keys), config=config,
                            lr=lr)
    else:
        state = {"params": payload, "opt": ht.init_tiered_opt_state(
            params, config=config, optimizer=args.optimizer)}
        restored, v.start_step = _resume(mgr, say, state)
        if restored is not None:
            state["opt"]["count"] = restored["opt"]["count"]
        v.payload = lambda: state
        fn = ht.tiered_train_block_opt if block > 1 \
            else ht.tiered_train_step_opt
        call = lambda b: fn(params, state["opt"], *(b[k] for k in keys),
                            config=config, optimizer=args.optimizer, lr=lr)
    if block > 1:
        v.step = lambda b: (call(b)[-1], int(b["dense"].shape[0]))
    else:
        v.step = lambda b: (call(b), 1)
    return v


def _build_sharded_step(args, config, plan, params: dict, shard, mgr=None,
                        say=lambda *a: None) -> argparse.Namespace:
    """:func:`_build_step` for a rank's sharded parameters on the mesh of
    ``shard`` (:func:`_shard_setup`), as the JAX package picks: SGD at a
    constant lr takes the sharded step, or the sharded block (which
    carries the clip and a schedule itself, aligned to the loop's step)
    under ``--update-interval``; any other optimizer, or a clip or a
    schedule at K=1, takes the optimizer-state step or block, whose
    checkpoints hold ``{"params", "opt"}``.  Batches are this rank's rows
    (``local_batch``).  Checkpoints are sharded
    (``io.checkpoint.sharded_payload``): the resume reads each rank's
    slabs into the live tensors, and the optimizer state's ``count``."""
    from dlrm_tpu_torch.io.checkpoint import sharded_payload
    from dlrm_tpu_torch.train import train as T

    lr, block, clip = plan.lr, plan.block, plan.clip
    keys = ("dense", "sparse", "labels")
    kw = {"mesh": shard.mesh, "placement": shard.placement,
          "local_batch": True}
    v = argparse.Namespace(align=None, lookahead=False, uses_opt=(
        args.optimizer != "sgd"
        or (block == 1 and (callable(lr) or clip is not None))))
    if not v.uses_opt:
        v.payload = lambda: sharded_payload(params)
        _, v.start_step = _resume(mgr, say, v.payload())
        if block > 1:
            fn = T.make_sharded_train_block(config, lr, grad_clip_norm=clip,
                                            **kw)
            if hasattr(fn, "step"):
                v.align = lambda s: setattr(fn, "step", s)
        else:
            fn = T.make_sharded_train_step(config, lr, **kw)
        call = lambda b: fn(params, *(b[k] for k in keys))
    else:
        opt = T.init_sharded_opt_state(params, config=config,
                                       optimizer=args.optimizer)
        v.payload = lambda: sharded_payload(params, opt)
        restored, v.start_step = _resume(mgr, say, v.payload())
        if restored is not None:
            opt["count"] = restored["opt"]["count"]
        if block > 1:
            fn = T.make_sharded_train_block_opt(
                config, optimizer=args.optimizer, lr=lr,
                unroll=not args.block_scan, grad_clip_norm=clip, **kw)
        else:
            fn = T.make_sharded_train_step_opt(
                config, optimizer=args.optimizer, lr=lr,
                grad_clip_norm=clip, **kw)
        call = lambda b: fn(params, opt, *(b[k] for k in keys))
    if block > 1:
        v.step = lambda b: (call(b)[-1], int(b["dense"].shape[0]))
    else:
        v.step = lambda b: (call(b), 1)
    return v


def _shard_setup(args, config, plan, gang: _Gang,
                 say) -> argparse.Namespace:
    """The sharded layout of a training run: the mesh (``--mesh-shape``'s
    2-D DCN x ICI, else 1-D over the gang), the placement of
    ``--max-rows-per-shard``, ``--col-sharded-tables`` and
    ``--host-tables`` (lane packing is TPU layout: always 1), announced;
    this rank's table shard, the rows of each global batch it is fed
    (None for one process) and its part in sharded checkpoints."""
    from dlrm_tpu_torch.io.checkpoint import ShardGroup
    from dlrm_tpu_torch.parallel import mesh as pmesh
    from dlrm_tpu_torch.parallel.placement import plan_placement

    mesh = (pmesh.make_mesh_2d(plan.dcn_n, plan.ici_n) if plan.ici_n
            else pmesh.make_mesh())
    record = {"table_sizes": list(config.table_sizes),
              "num_shards": plan.n_shards,
              "max_rows_per_shard": args.max_rows_per_shard,
              "col_sharded_tables": list(_tables(args.col_sharded_tables)),
              "host_tables": list(_tables(args.host_tables))}
    try:
        placement = plan_placement(**record)
    except ValueError as e:
        raise SystemExit(str(e)) from None
    if placement.row_sharded:
        say(f"row-sharded tables: {list(placement.row_sharded)}")
    if placement.host_row_sharded:
        say("host-resident row-sharded tables: "
            f"{list(placement.host_row_sharded)} "
            f"({placement.host_local_rows:,} rows a shard in host memory)")
    if placement.col_sharded:
        say(f"column-sharded tables: {list(placement.col_sharded)}")
    index = mesh.get_local_rank("d")
    dcn = pmesh.dcn_axis_of(mesh)
    writes = dcn is None or mesh.get_local_rank(dcn) == 0
    rows = (pmesh.local_batch_rows(mesh, args.batch_size)
            if gang.world > 1 else None)
    return argparse.Namespace(
        mesh=mesh, placement=placement, index=index, rows=rows,
        group=ShardGroup(index, plan.n_shards, writes, gang.lead, record))


def _shard_params(config, shard, generator, device) -> dict:
    """This rank's sharded parameters drawn straight into their places
    (``parallel.embedding.draw_sharded_params``: the bits of
    ``init_params``, no card holding the whole stack), the dense towers
    then broadcast from rank 0."""
    from dlrm_tpu_torch.parallel.embedding import draw_sharded_params
    from dlrm_tpu_torch.train.train import broadcast_dense

    params = draw_sharded_params(generator, shard.placement, config,
                                 shard.index, device)
    broadcast_dense(params)
    return params


def _tier_params(args, config, generator, device, say) -> dict:
    """``--hbm-budget-gb``: the run's tier plan, announced; the parameters
    drawn straight into their tiers (the host tier into pinned host
    memory), the bits ``init_params`` would draw, with no full stack on
    the card."""
    from dlrm_tpu_torch.parallel import host_tier as ht

    tiers = ht.plan_tiers(config, int(args.hbm_budget_gb * ht.GIB))
    say(f"host-tier tables: {list(tiers.host_tables)} "
        f"({tiers.host_rows:,} rows)")
    if args.ckpt_dir and 0 in (tiers.device_rows, tiers.host_rows):
        raise SystemExit("--ckpt-dir with --hbm-budget-gb needs both tiers "
                         "non-empty (adjust the budget so at least one table "
                         "stays on device and one spills)")
    if args.host_prefetch and not tiers.host_tables:
        raise SystemExit("--host-prefetch needs a host tier (lower "
                         "--hbm-budget-gb)")
    return ht.draw_tiered_params(generator, tiers, config, device)


def _write_run_meta(args, config, v, plan=None) -> None:
    """``run_meta.json`` beside the checkpoints: the JAX package's keys
    that mean something in this package, so that ``eval``, ``predict`` and
    ``export --ckpt-dir`` rebuild the run's model (a two-tier run's tier
    plan from its ``hbm_budget_gb``; a sharded run's placement, ``pack``
    always 1).  The lead process writes it."""
    meta = {"sharded": False, "optimizer": args.optimizer,
            "two_tier": args.hbm_budget_gb is not None,
            "hbm_budget_gb": args.hbm_budget_gb,
            "wrapped_opt": bool(v.uses_opt),
            "table_sizes": list(config.table_sizes),
            "bf16_tables": config.embedding_dtype == torch.bfloat16}
    if plan is not None and plan.sharded:
        meta.update(
            sharded=True, num_shards=plan.n_shards,
            mesh_shape=[plan.dcn_n, plan.ici_n] if plan.ici_n else None,
            pack=1, max_rows_per_shard=args.max_rows_per_shard,
            col_sharded_tables=list(_tables(args.col_sharded_tables)),
            host_tables=list(_tables(args.host_tables)),
            exchange_dtype=None if config.exchange_dtype is None
            else str(config.exchange_dtype).removeprefix("torch."))
    path = os.path.join(os.path.abspath(args.ckpt_dir), "run_meta.json")
    with open(path, "w") as f:
        json.dump(meta, f)


def run_training(args, config, params: dict, say=lambda *a: None,
                 plan: Optional[argparse.Namespace] = None,
                 shard: Optional[argparse.Namespace] = None) -> dict:
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
    run's third to its sixth is written there.  Two-tier parameters
    (``params["emb"]`` a ``TieredEmb``) take the tiered steps, and
    evaluation reads both tiers in place.  ``plan``: the run's
    :func:`_train_plan`, when the caller made it already.

    ``shard`` (:func:`_shard_setup`): ``params`` are this rank's sharded
    parameters; every rank of the gang runs the loop on its rows of each
    batch, saves and restores its slabs of the sharded checkpoints,
    evaluates on the mesh (``sharded_evaluate``; a gang of more than one
    process on full batches only) and, under ``--paranoid N``, checks
    every N steps that the DCN replicas hold the same tables."""
    from dlrm_tpu_torch.data.prefetch import device_prefetch
    from dlrm_tpu_torch.io.checkpoint import CheckpointManager
    from dlrm_tpu_torch.train.metrics import evaluate, sharded_evaluate
    from dlrm_tpu_torch.train.train import batch_to_device
    from dlrm_tpu_torch.utils.telemetry import trace

    plan = _train_plan(args) if plan is None else plan
    device = params["emb"].device
    rows = None if shard is None else shard.rows
    mgr = None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir,
                                save_interval=args.save_interval,
                                max_to_keep=args.max_to_keep,
                                shards=None if shard is None
                                else shard.group)
    v = _build_step(args, config, plan, params, mgr, say, shard)
    if mgr is not None and (shard is None or shard.group.lead):
        _write_run_meta(args, config, v, plan)
    replica_check = None
    if shard is not None and args.paranoid:
        from dlrm_tpu_torch.parallel.embedding import make_dcn_replica_check
        replica_check = make_dcn_replica_check(shard.mesh)

    def run_eval():
        # the training file when there is no --eval-data; an all-synthetic
        # evaluation needs a bound: 10 batches, from a seed of its own.  A
        # gang's ranks are fed their rows of full batches
        eval_data = args.eval_data or args.data
        eval_steps = args.eval_steps
        if eval_data is None and eval_steps is None:
            eval_steps = 10
        data = _batch_iter(
            config, data=eval_data, batch_size=args.batch_size,
            steps=eval_steps, seed=10_000, synthetic=args.synthetic,
            keep_remainder=rows is None, rows=rows)
        if shard is not None:
            return sharded_evaluate(params, data, config, mesh=shard.mesh,
                                    placement=shard.placement,
                                    local_batch=rows is not None)
        return evaluate(params, data, config)

    def save(at: int) -> None:
        from dlrm_tpu_torch.io.checkpoint import payload_bytes

        t0 = time.perf_counter()
        payload = v.payload()
        mgr.save(at, payload, force=True)
        say(f"saved step {at}: this process's "
            f"{_rate(payload_bytes(payload), time.perf_counter() - t0)}")

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
        shuffle_rows=args.shuffle_rows, shuffle_window=args.shuffle_window,
        rows=rows)
    if plan.block > 1:
        source = _block_iter(source, plan.block)
    if v.lookahead:
        source = _with_lookahead(source)
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
            if replica_check is not None and _crossed(prev, step,
                                                      args.paranoid):
                if not replica_check(params):
                    raise RuntimeError(
                        f"--paranoid: DCN table replicas DIVERGED at step "
                        f"{step} — a sparse update was not DCN-invariant "
                        "(see parallel/embedding._dcn_fold)")
                say(f"--paranoid: the DCN table replicas agree at step "
                    f"{step}")
            if mgr is not None and _crossed(prev, step, mgr.save_interval):
                save(step)
        if capturing:
            capture.close()
            say("profile written (stream ended mid-capture)")
    if mgr is not None:
        if mgr.latest_step() != step:
            save(step)
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
    """Training from parameters drawn from the config's seed (split into
    two tiers under ``--hbm-budget-gb``; drawn straight into this rank's
    shard on the sharded path), or resumed from ``--ckpt-dir``; prints
    status lines to stderr and one JSON line at the end (a gang's lead
    process only)."""
    from dlrm_tpu_torch.models.dlrm import init_params

    _refuse_unported(args)
    device = _device(args)
    with _process_group(args, device, join=bool(args.sharded)) as gang:
        plan = _train_plan(args, 1 if gang is None else gang.world)
        if gang is not None:
            device = gang.device
        config = _build_config(args, device)
        _check_data(args, config)
        say = _say_for(gang is None or gang.lead)
        say(f"device: {device} ({config.interaction_impl} interaction)"
            + (f", sharded over {gang.world} process(es)"
               + (f", mesh {plan.dcn_n}x{plan.ici_n} (dcn x ici)"
                  if plan.ici_n else "") if plan.sharded else ""))
        generator = torch.Generator(device).manual_seed(config.seed)
        shard = None
        t0 = time.perf_counter()
        if plan.sharded:
            shard = _shard_setup(args, config, plan, gang, say)
            params = _shard_params(config, shard, generator, device)
        elif args.hbm_budget_gb is not None:
            params = _tier_params(args, config, generator, device, say)
        else:
            params = init_params(generator, config, device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        say(f"parameters drawn in {time.perf_counter() - t0:.2f} s")
        result = run_training(args, config, params, say=say, plan=plan,
                              shard=shard)
        if gang is None or gang.lead:
            print(json.dumps({**result, "device": device.type}))
    return 0


def cmd_eval(args) -> int:
    """Accuracy, AUC and mean loss of saved parameters over ``--data``
    (every row: the ragged tail batch counts), or over 10 synthetic batches
    without it; prints one JSON line.  ``--sharded true`` or
    ``--distributed``: a sharded run's checkpoint restored onto the gang
    and evaluated on its mesh (``sharded_evaluate``; int8 too), the
    metrics of every row printed by the lead process."""
    from dlrm_tpu_torch.train.metrics import evaluate

    _refuse_unported(args)
    device = _device(args)
    eval_steps = args.eval_steps or (None if args.data else 10)
    with _process_group(args, device, join=bool(args.sharded)) as gang:
        if gang is None:
            params, config = _serving_params(args, device)
            data = _batch_iter(config, data=args.data,
                               batch_size=args.batch_size, steps=eval_steps,
                               keep_remainder=True)
            print(json.dumps({**evaluate(params, data, config),
                              "device": device.type}))
            return 0
        from dlrm_tpu_torch.parallel.mesh import local_batch_rows
        from dlrm_tpu_torch.train.metrics import sharded_evaluate

        device = gang.device
        params, mesh, placement, config = _mesh_params(
            args, _build_config(args, device), gang,
            args.quantize_tables == "int8")
        rows = None
        if gang.world > 1:
            if args.batch_size % gang.world:
                raise SystemExit(f"--distributed eval: --batch-size "
                                 f"{args.batch_size} must be divisible by "
                                 f"the {gang.world}-device mesh")
            rows = local_batch_rows(mesh, args.batch_size)
        # one process pads a ragged tail batch to the mesh; a gang feeds
        # each rank its rows of full batches
        data = _batch_iter(config, data=args.data, batch_size=args.batch_size,
                           steps=eval_steps, keep_remainder=rows is None,
                           rows=rows)
        m = sharded_evaluate(params, data, config, mesh=mesh,
                             placement=placement, local_batch=rows is not None)
        if gang.lead:
            print(json.dumps({**m, "device": device.type}))
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
_SHARDED_SERVE_HELP = (
    "true: serve a sharded run's --ckpt-dir on a mesh of this process "
    "(with --distributed, of the gang), restored onto its ranks; else it "
    "is unsharded onto one device")
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
                    help="true: shard the tables over the gang's processes "
                    "(a gang of this one process without --distributed); "
                    "false: one device.  Default: sharded over a gang of "
                    "more than one process")
    tr.add_argument("--hbm-budget-gb", type=float, default=None,
                    help="two-tier tables: keep the smallest tables on the "
                    "device within this many GiB and the rest in pinned "
                    "host memory, which the card reads and updates in "
                    "place (only the rows a batch touches cross PCIe)")
    tr.add_argument("--host-prefetch", action="store_true",
                    help="two-tier SGD at a constant lr: gather the next "
                    "batch's host-tier rows right after this step's "
                    "host-tier update")
    tr.add_argument("--paranoid", type=int, default=None,
                    help="every N steps, check that the DCN replicas of a "
                    "--mesh-shape run hold the same tables, bit for bit")
    tr.add_argument("--mesh-shape", default=None,
                    help="DCNxICI 2-D mesh over the gang (e.g. 2x4): the "
                    "tables shard over ICI, the batch over both")
    tr.add_argument("--max-rows-per-shard", type=int, default=None,
                    help="row-shard tables with more rows over every shard")
    tr.add_argument("--col-sharded-tables", default=None,
                    help="comma-separated tables split by features over "
                    "the shards")
    tr.add_argument("--host-tables", default=None,
                    help="comma-separated tables row-sharded into host "
                    "memory, read and updated in place by the card")
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
    ev.add_argument("--sharded", type=_strict_bool, default=None,
                    help=_SHARDED_SERVE_HELP)
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
    pr.add_argument("--sharded", type=_strict_bool, default=None,
                    help=_SHARDED_SERVE_HELP)
    _add_dist_flags(pr)
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
