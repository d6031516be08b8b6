"""One rank of a gloo gang that drives dlrm_tpu_torch's sharded path, and
the launcher the gang tests call (``run_gang``).

A rank imports torch, numpy and the port only (never JAX), joins the gang
through a ``file://`` store, builds its mesh and its shard of the
parameters (``io.convert.sharded_params_from_numpy``), runs the task of
the spec and writes its results to ``<out>/rank<r>.npz``: results never
travel through stdout, where gloo's log lines interleave.

    python tests/torch_gang_worker.py --rank R --world N --store FILE \\
        --spec spec.json --out DIR

The spec (JSON): ``config`` (DLRMConfig fields; ``exchange_dtype`` "bf16"
or null), ``placement`` (``plan_placement`` keywords), ``mesh`` (null for
1-D, ``[dcn, ici]`` for 2-D), ``arrays`` (an .npz with the JAX package's
sharded parameters under ``emb``, ``emb_cs.<j>``, ``emb_h`` (host tables),
``bottom.<i>.<w|b>``, ``top.<i>.<w|b>``, its sharded optimizer state under
``opt.*`` (:func:`jax_opt_arrays`), and the task's inputs), ``task`` and
its fields:

* ``lookup``: ``cases``, names of global id arrays; each rank writes its
  pooled rows under ``<case>`` (f32) and ``<case>.bf16`` (bf16 exchange);
  with ``int8`` also under ``<case>.int8``, from the JAX package's int8
  shard stacks ``q.emb``, ``q.scales``, ``q.cs.<j>``, ``q.cs_scales.<j>``
  (``io.convert.sharded_quant_from_numpy``).
* ``train``: ``lr`` and ``steps``; global batches ``dense.<s>``,
  ``sparse.<s>``, ``labels.<s>``.  Ranks other than 0 first add 1 to their
  dense parameters, which ``broadcast_dense`` must undo; each rank writes
  ``losses``, its ``emb``, ``emb_cs.<j>``, ``emb_h`` and dense leaves, and
  ``refused`` if a global batch of ``world + 1`` rows was refused.
* ``eval``: batches ``dense.<s>`` ... (``batches`` of them, the last may
  be ragged); each rank writes its metrics, and the sums of a few large
  counters over the gang (``big``).
* ``train_opt``: ``optimizer``, ``lr`` (a number, or ``{"base",
  "schedule"}`` for ``make_schedule``), ``clip`` (null or a norm) and
  ``steps`` of ``make_sharded_train_step_opt`` from the optimizer state
  of the arrays; each rank writes what ``train`` writes and its optimizer
  state (``opt.*``).
* ``block``: ``lr`` and ``blocks`` of ``make_sharded_train_block`` over
  stacked global batches ``dense.<s>`` (K, B, 13) ...; ``losses`` (blocks
  x K) and the parameters.
* ``block_opt``: ``optimizer``, ``lr``, ``clip`` and ``blocks`` of
  ``make_sharded_train_block_opt``; the parameters and optimizer state.
* ``dcn_check`` (2-D mesh): ``train_opt`` first, then
  ``make_dcn_replica_check`` on the trained parameters (``agree``), again
  after the rank at ``(h, d) = (1, 0)`` flips the lowest bit of the first
  element of its ``emb_h`` (``agree_flipped``), and after it flips it back
  (``agree_restored``).
* ``save``: ``optimizer`` and ``ckpt``: the parameters and optimizer state
  of the arrays saved as sharded checkpoint ``step`` of ``ckpt``
  (``CheckpointManager(shards=)``, ``max_to_keep``).
* ``restore``: ``optimizer`` and ``ckpt``: a zero state of this gang's
  placement restored from the latest checkpoint of ``ckpt``; each rank
  writes what ``train_opt`` writes (``opt.*`` too) and ``step``.
* ``hybrid``: every rank names the host ``host<rank // per_host>`` and
  writes the ranks of ``make_hybrid_mesh`` and of ``make_mesh_2d``.
* ``audit``: ``cases``, each ``{"config", "placement", "mesh", "batch"}``
  (``mesh`` null for 1-D, ``[dcn, ici]``; ``batch`` rows a rank): one step
  of ``make_sharded_train_step`` under ``parallel.audit``'s collective
  counter (``audit.audit_step``); each rank writes, per case ``i``, the
  collectives in issue order under ``<i>.kind``, ``<i>.dtype``,
  ``<i>.bytes``, ``<i>.group`` and ``<i>.axis``.

:func:`run_cli_gang` starts ``python -m dlrm_tpu_torch`` itself as a gang
(``--distributed``) and returns each rank's output.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
REPO = HERE.parent


def run_gang(tmp: Path, world: int, spec: dict, arrays: dict,
             timeout: float = 240.0) -> list:
    """Start ``world`` ranks on ``spec`` and ``arrays``, wait for all of
    them (each within ``timeout`` seconds) and return each rank's results
    as a dict of arrays."""
    tmp = Path(tmp)
    out = tmp / "out"
    out.mkdir(parents=True, exist_ok=True)
    np.savez(tmp / "arrays.npz", **arrays)
    spec = {**spec, "arrays": str(tmp / "arrays.npz")}
    (tmp / "spec.json").write_text(json.dumps(spec))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX", "XLA"))}
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "2"
    procs = [subprocess.Popen(
        [sys.executable, str(HERE / "torch_gang_worker.py"), "--rank",
         str(r), "--world", str(world), "--store", str(tmp / "store"),
         "--spec", str(tmp / "spec.json"), "--out", str(out)],
        cwd=REPO, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True) for r in range(world)]
    errs = []
    try:
        for p in procs:
            errs.append(p.communicate(timeout=timeout)[1])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, err) in enumerate(zip(procs, errs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n" \
                                  f"{err[-4000:]}"
    results = []
    for r in range(world):
        with np.load(out / f"rank{r}.npz") as z:
            results.append({k: z[k] for k in z.files})
    return results


def run_cli_gang(tmp: Path, world: int, argv: list,
                 timeout: float = 240.0) -> list:
    """``python -m dlrm_tpu_torch *argv --device cpu --distributed ...`` as
    a gang of ``world`` processes through a ``file://`` store in ``tmp``;
    waits for all (each within ``timeout`` seconds), asserts that each
    exited 0 and returns each rank's (stdout, stderr)."""
    tmp = Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    store = tmp / "cli_store"
    if store.exists():
        store.unlink()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX", "XLA"))}
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "2"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "dlrm_tpu_torch", *argv, "--device", "cpu",
         "--distributed", "--coordinator", f"file://{store}",
         "--num-processes", str(world), "--process-id", str(r)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} of {argv[0]} exited " \
                                  f"{p.returncode}:\n{err[-4000:]}"
    return outs


def lead_line(outs: list) -> dict:
    """The result line of a CLI gang: the lead's only stdout line that
    starts with ``{``; the other ranks print none."""
    lines = [l for l in outs[0][0].splitlines() if l.startswith("{")]
    assert len(lines) == 1, outs[0][0]
    for out, _ in outs[1:]:
        assert not any(l.startswith("{") for l in out.splitlines()), out
    return json.loads(lines[0])


def jax_sharded_arrays(sh_params: dict) -> dict:
    """The JAX package's sharded parameters (numpy) as the arrays of a
    spec."""
    arrays = {"emb": np.asarray(sh_params["emb"])}
    if sh_params.get("emb_h") is not None:
        arrays["emb_h"] = np.asarray(sh_params["emb_h"])
    for j, a in enumerate(sh_params.get("emb_cs", ())):
        arrays[f"emb_cs.{j}"] = np.asarray(a)
    for part in ("bottom", "top"):
        for i, layer in enumerate(sh_params[part]):
            for k in ("w", "b"):
                arrays[f"{part}.{i}.{k}"] = np.asarray(layer[k])
    return arrays


def jax_opt_arrays(np_opt: dict) -> dict:
    """A sharded optimizer state as numpy (the layout
    ``sharded_opt_state_from_numpy`` takes) as the arrays of a spec."""
    arrays = {"opt.count": np.int64(np_opt["count"])}
    if np_opt.get("dense") is not None:
        for part in ("bottom", "top"):
            for i, layer in enumerate(np_opt["dense"][part]):
                for k in ("w", "b"):
                    arrays[f"opt.dense.{part}.{i}.{k}"] = np.asarray(
                        layer[k])
    for key in ("emb_acc", "emb_acc_h"):
        a = np_opt.get(key)
        if a is not None and not isinstance(a, tuple):
            arrays[f"opt.{key}"] = np.asarray(a)
    for j, a in enumerate(np_opt.get("emb_acc_cs", ())):
        arrays[f"opt.emb_acc_cs.{j}"] = np.asarray(a)
    return arrays


def opt_from_arrays(arrays) -> dict:
    """Inverse of :func:`jax_opt_arrays` (a dict or an ``np.load``)."""
    keys = list(arrays.keys())

    def mlp(part):
        n = sum(1 for k in keys if k.startswith(f"opt.dense.{part}.")
                and k.endswith(".w"))
        return [{k: arrays[f"opt.dense.{part}.{i}.{k}"] for k in ("w", "b")}
                for i in range(n)]

    dense = None
    if any(k.startswith("opt.dense.") for k in keys):
        dense = {"bottom": mlp("bottom"), "top": mlp("top")}
    n_cs = sum(1 for k in keys if k.startswith("opt.emb_acc_cs."))
    return {"dense": dense,
            "count": int(arrays["opt.count"]) if "opt.count" in keys else 0,
            "emb_acc": arrays["opt.emb_acc"] if "opt.emb_acc" in keys
            else None,
            "emb_acc_cs": tuple(arrays[f"opt.emb_acc_cs.{j}"]
                                for j in range(n_cs)),
            "emb_acc_h": arrays["opt.emb_acc_h"] if "opt.emb_acc_h" in keys
            else None}


# -- one rank ---------------------------------------------------------------------

def _config(spec: dict):
    import torch
    from dlrm_tpu_torch.config import DLRMConfig

    kw = dict(spec)
    kw["exchange_dtype"] = {None: None, "bf16": torch.bfloat16}[
        kw.get("exchange_dtype")]
    return DLRMConfig(**kw)


def _params(arrays, placement, rank: int) -> dict:
    from dlrm_tpu_torch.io.convert import sharded_params_from_numpy

    def mlp(part):
        n = sum(1 for k in arrays.files if k.startswith(part + ".")
                and k.endswith(".w"))
        return [{k: arrays[f"{part}.{i}.{k}"] for k in ("w", "b")}
                for i in range(n)]

    np_params = {"bottom": mlp("bottom"), "top": mlp("top"),
                 "emb": arrays["emb"],
                 "emb_cs": tuple(arrays[f"emb_cs.{j}"] for j in
                                 range(len(placement.col_sharded))),
                 "emb_h": arrays["emb_h"] if "emb_h" in arrays.files
                 else None}
    return sharded_params_from_numpy(np_params, placement, rank)


def _lr(spec_lr):
    """A spec's ``lr``: a number, or a schedule."""
    from dlrm_tpu_torch.train.optim import make_schedule

    if isinstance(spec_lr, dict):
        return make_schedule(spec_lr["base"], **spec_lr["schedule"])
    return spec_lr


def _opt_arrays(opt_state: dict) -> dict:
    from dlrm_tpu_torch.io.convert import sharded_opt_state_to_numpy

    return jax_opt_arrays(sharded_opt_state_to_numpy([opt_state]))


def _batch(arrays, s: int):
    import torch
    return [torch.as_tensor(arrays[f"{k}.{s}"])
            for k in ("dense", "sparse", "labels")]


def _audit(spec: dict) -> dict:
    """The ``audit`` task: each case's collectives as arrays."""
    from dlrm_tpu_torch.parallel import audit
    from dlrm_tpu_torch.parallel import mesh as pmesh
    from dlrm_tpu_torch.parallel.placement import plan_placement

    meshes, out = {}, {}
    for i, case in enumerate(spec["cases"]):
        shape = case.get("mesh")
        key = tuple(shape or ())
        if key not in meshes:
            meshes[key] = (pmesh.make_mesh() if shape is None
                           else pmesh.make_mesh_2d(*shape))
        mesh = meshes[key]
        config = _config(case["config"])
        placement = plan_placement(config.table_sizes,
                                   mesh.size(mesh.mesh_dim_names.index("d")),
                                   **case.get("placement", {}))
        records = audit.audit_step(config, placement, mesh, case["batch"])
        for field, kind in (("kind", "kind"), ("dtype", "dtype"),
                            ("bytes", "result_bytes"),
                            ("group", "group_size"), ("axis", "axis")):
            out[f"{i}.{field}"] = np.asarray(
                [getattr(c, kind) for c in records])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--store", required=True)
    ap.add_argument("--spec", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist
    from dlrm_tpu_torch.parallel import mesh as pmesh
    from dlrm_tpu_torch.parallel.embedding import (make_dcn_replica_check,
                                                   sharded_lookup)
    from dlrm_tpu_torch.parallel.placement import plan_placement

    torch.set_num_threads(2)
    spec = json.loads(Path(args.spec).read_text())
    pmesh.init_distributed(f"file://{args.store}", args.world, args.rank,
                           device="cpu")
    if spec["task"] == "hybrid":
        per = spec["per_host"]
        hybrid = pmesh.make_hybrid_mesh(host=f"host{args.rank // per}")
        plain = pmesh.make_mesh_2d(args.world // per, per)
        out = {"hybrid": hybrid.mesh.numpy(), "plain": plain.mesh.numpy(),
               "names": np.asarray(hybrid.mesh_dim_names),
               "rows": np.asarray(pmesh.local_batch_rows(hybrid, 8 * args.world))}
        np.savez(Path(args.out) / f"rank{args.rank}.npz", **out)
        dist.destroy_process_group()
        return 0
    if spec["task"] == "audit":
        np.savez(Path(args.out) / f"rank{args.rank}.npz", **_audit(spec))
        dist.destroy_process_group()
        return 0
    mesh = (pmesh.make_mesh() if spec.get("mesh") is None
            else pmesh.make_mesh_2d(*spec["mesh"]))
    config = _config(spec["config"])
    shard = mesh.get_local_rank("d")
    placement = plan_placement(config.table_sizes, mesh.size(
        mesh.mesh_dim_names.index("d")), **spec.get("placement", {}))
    arrays = np.load(spec["arrays"])
    task = spec["task"]
    if task == "restore":  # a zero state, filled by the restore
        import torch
        from dlrm_tpu_torch.models.dlrm import init_dense
        from dlrm_tpu_torch.parallel.embedding import empty_shard

        z = empty_shard(placement, shard, config.feature_size,
                        config.embedding_dtype, "cpu")
        params = init_dense(torch.Generator(), config, "cpu")
        params.update(emb=z["emb"], emb_cs=z["emb_cs"])
        if z["emb_h"] is not None:
            params["emb_h"] = z["emb_h"]
    else:
        params = _params(arrays, placement, shard)
    out = {}
    if task == "lookup":
        lo, hi = pmesh.local_batch_rows(mesh, arrays[spec["cases"][0]]
                                        .shape[0])
        q = None
        if spec.get("int8"):
            from dlrm_tpu_torch.io.convert import sharded_quant_from_numpy

            n_cs = len(placement.col_sharded)
            q = sharded_quant_from_numpy(
                arrays["q.emb"], arrays["q.scales"],
                [arrays[f"q.cs.{j}"] for j in range(n_cs)],
                [arrays[f"q.cs_scales.{j}"] for j in range(n_cs)],
                placement=placement, rank=shard)
        for case in spec["cases"]:
            ids = torch.as_tensor(arrays[case][lo:hi])
            for suffix, xd in (("", None), (".bf16", torch.bfloat16)):
                out[case + suffix] = sharded_lookup(
                    params["emb"], ids, mesh=mesh, placement=placement,
                    cs=params["emb_cs"], emb_h=params.get("emb_h"),
                    exchange_dtype=xd).float().numpy()
            if q is not None:
                out[case + ".int8"] = sharded_lookup(
                    q["emb"], ids, mesh=mesh, placement=placement,
                    cs=q["emb_cs"], emb_h=params.get("emb_h"),
                    scales=q["emb_scales"],
                    cs_scales=q["emb_cs_scales"]).numpy()
    elif task == "train":
        from dlrm_tpu_torch.ops.embedding import tree_leaves
        from dlrm_tpu_torch.train.train import (broadcast_dense,
                                                make_sharded_train_step)

        if args.rank:  # rank 0's dense parameters must reach every rank
            for leaf in tree_leaves({k: params[k] for k in ("bottom",
                                                            "top")}):
                leaf.add_(1.0)
        broadcast_dense(params)
        try:
            pmesh.local_batch_rows(mesh, args.world + 1)
        except ValueError:
            out["refused"] = np.int64(1)
        step = make_sharded_train_step(config, spec["lr"], mesh, placement)
        out["losses"] = np.asarray([
            float(step(params, *_batch(arrays, s)))
            for s in range(spec["steps"])], np.float32)
    elif task == "eval":
        from dlrm_tpu_torch.train.metrics import (StreamingAUC,
                                                  _reduce_counts,
                                                  sharded_evaluate)

        batches = [dict(zip(("dense", "sparse", "labels"),
                            _batch(arrays, s)))
                   for s in range(spec["batches"])]
        m = sharded_evaluate(params, batches, config, mesh=mesh,
                             placement=placement)
        out.update({k: np.float64(v) for k, v in m.items()})
        auc = StreamingAUC(4)
        auc.pos[:] = 2.0 ** 40 + args.rank
        big = _reduce_counts(2 ** 60 + args.rank, 2 ** 61 + 1, auc, 0.1)
        out["big"] = np.asarray(big[:2] + (auc.pos[0],), np.int64)
    elif task in ("train_opt", "block", "block_opt", "dcn_check"):
        from dlrm_tpu_torch.io.convert import sharded_opt_state_from_numpy
        from dlrm_tpu_torch.train import train as T

        optimizer = spec.get("optimizer", "sgd")
        opt_state = sharded_opt_state_from_numpy(
            opt_from_arrays(arrays), placement, optimizer, shard)
        lr, clip = _lr(spec["lr"]), spec.get("clip")
        if task == "block":
            step = T.make_sharded_train_block(config, lr, mesh, placement,
                                              grad_clip_norm=clip)
            run = lambda b: step(params, *b)  # noqa: E731
        elif task == "block_opt":
            step = T.make_sharded_train_block_opt(
                config, optimizer=optimizer, lr=lr, mesh=mesh,
                placement=placement, grad_clip_norm=clip)
            run = lambda b: step(params, opt_state, *b)  # noqa: E731
        else:
            step = T.make_sharded_train_step_opt(
                config, optimizer=optimizer, lr=lr, mesh=mesh,
                placement=placement, grad_clip_norm=clip)
            run = lambda b: step(params, opt_state, *b)  # noqa: E731
        n = spec.get("blocks", spec.get("steps"))
        out["losses"] = np.asarray([
            run(_batch(arrays, s)).detach().reshape(-1).numpy()
            for s in range(n)], np.float32).reshape(-1)
        out.update(_opt_arrays(opt_state))
        if task == "dcn_check":
            check = make_dcn_replica_check(mesh)
            out["agree"] = np.int64(check(params))
            me = (mesh.get_local_rank("h"), shard)
            bits = params["emb_h"].view(torch.int32).view(-1)
            for key in ("agree_flipped", "agree_restored"):
                if me == (1, 0):
                    bits[0] ^= 1
                out[key] = np.int64(check(params))
    elif task in ("save", "restore"):
        from dlrm_tpu_torch.io.checkpoint import (CheckpointManager,
                                                  ShardGroup,
                                                  sharded_payload)
        from dlrm_tpu_torch.io.convert import sharded_opt_state_from_numpy
        from dlrm_tpu_torch.train.train import init_sharded_opt_state

        optimizer = spec["optimizer"]
        opt_state = None
        if optimizer != "sgd":
            opt_state = (init_sharded_opt_state(params, config=config,
                                                optimizer=optimizer)
                         if task == "restore" else
                         sharded_opt_state_from_numpy(
                             opt_from_arrays(arrays), placement, optimizer,
                             shard))
        dcn = pmesh.dcn_axis_of(mesh)
        record = {"table_sizes": list(config.table_sizes),
                  "num_shards": placement.num_shards,
                  **{k: list(v) if isinstance(v, (list, tuple)) else v
                     for k, v in spec.get("placement", {}).items()}}
        mgr = CheckpointManager(spec["ckpt"], max_to_keep=spec.get(
            "max_to_keep"), shards=ShardGroup(
                shard, placement.num_shards,
                dcn is None or mesh.get_local_rank(dcn) == 0,
                args.rank == 0, record))
        payload = sharded_payload(params, opt_state)
        if task == "save":
            mgr.save(spec["step"], payload)
        else:
            restored, step = mgr.restore_latest(out=payload)
            out["step"] = np.int64(step)
            if opt_state is not None:
                opt_state["count"] = restored["opt"]["count"]
                out.update(_opt_arrays(opt_state))
    if task in ("train", "train_opt", "block", "block_opt", "dcn_check",
                "restore"):
        out["emb"] = params["emb"].numpy()
        if params.get("emb_h") is not None:
            out["emb_h"] = params["emb_h"].numpy()
        for j, a in enumerate(params["emb_cs"]):
            out[f"emb_cs.{j}"] = a.numpy()
        for part in ("bottom", "top"):
            for i, layer in enumerate(params[part]):
                for k in ("w", "b"):
                    out[f"{part}.{i}.{k}"] = layer[k].numpy()
    np.savez(Path(args.out) / f"rank{args.rank}.npz", **out)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
