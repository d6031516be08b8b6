"""A dry run of the hybrid training step on a gang of CPU processes: the
counterpart of the JAX package's ``__graft_entry__.dryrun_multichip``.

    python -c "from dlrm_tpu_torch.parallel.dryrun import dryrun_multichip;
               print(dryrun_multichip(2))"

:func:`dryrun_multichip` starts ``n`` processes, one a rank, that join a
gloo gang through a file store.  Each draws its shard of the dry run's
model (26 small tables, multi-hot, D=8; the three biggest row-sharded
over every rank, the biggest of all in host memory) straight from the
initialiser, takes its rows of one global batch and runs one sharded SGD
step: the data-parallel MLPs with their all-reduce, the table-sharded
lookup and update with their exchanges.  Rank 0 holds the loss and the
tables after the step against the single-device step on the same draw and
batch.  Results travel in a JSON file, never through stdout.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

# rows above which a table is row-sharded: tables 23, 24 and 25
MAX_ROWS = 70
HOST_TABLES = (25,)
LR = 0.1


def _config():
    from dlrm_tpu_torch.config import DLRMConfig

    return DLRMConfig(bottom_mlp_sizes=(13, 32, 8), top_mlp_sizes=(32, 1),
                      feature_size=8,
                      table_sizes=tuple(4 + 3 * i for i in range(26)),
                      n_hot=2)


def _batch(config, n: int) -> dict:
    rng = np.random.default_rng(0)
    b = 8 * n
    return {"dense": rng.normal(size=(b, 13)).astype(np.float32),
            "sparse": np.stack([rng.integers(0, s, size=(b, config.n_hot))
                                for s in config.table_sizes],
                               axis=1).astype(np.int32),
            "labels": (rng.random(b) > 0.5).astype(np.float32)}


def _rank(rank: int, world: int, store: str, out: str) -> None:
    """One rank of the dry run."""
    import torch
    import torch.distributed as dist
    from dlrm_tpu_torch import init_params
    from dlrm_tpu_torch.parallel import embedding as pemb
    from dlrm_tpu_torch.parallel import mesh as pmesh
    from dlrm_tpu_torch.parallel.placement import plan_placement
    from dlrm_tpu_torch.train.train import (broadcast_dense,
                                            make_sharded_train_step,
                                            train_step)

    torch.set_num_threads(1)
    pmesh.init_distributed(f"file://{store}", world, rank, device="cpu")
    try:
        config = _config()
        mesh = pmesh.make_mesh()
        placement = plan_placement(config.table_sizes, world,
                                   max_rows_per_shard=MAX_ROWS,
                                   host_tables=HOST_TABLES)
        if not placement.row_sharded or not placement.host_row_sharded:
            raise RuntimeError(f"the dry run must row-shard, on the card "
                               f"and in host memory: {placement}")
        index = mesh.get_local_rank("d")
        params = pemb.draw_sharded_params(
            torch.Generator().manual_seed(config.seed), placement, config,
            index)
        broadcast_dense(params)
        batch = {k: torch.from_numpy(v) for k, v in
                 _batch(config, world).items()}
        lo, hi = pmesh.local_batch_rows(mesh, batch["dense"].shape[0])
        step = make_sharded_train_step(config, LR, mesh, placement,
                                       local_batch=True)
        loss = float(step(params, *(batch[k][lo:hi] for k in
                                    ("dense", "sparse", "labels"))))
        shards = [None] * world
        dist.all_gather_object(shards, {
            "emb": params["emb"].numpy(),
            "emb_h": params["emb_h"].numpy()})
        if rank == 0:
            full = init_params(torch.Generator().manual_seed(config.seed),
                               config)
            want = float(train_step(full, batch["dense"], batch["sparse"],
                                    batch["labels"], config=config, lr=LR))
            got = pemb.unshard_tables(
                np.stack([s["emb"] for s in shards]), placement, config,
                host=np.stack([s["emb_h"] for s in shards]))
            result = {"world": world, "loss": loss, "single_device_loss": want,
                      "max_table_diff": float(np.abs(
                          got - full["emb"].numpy()).max()),
                      "row_sharded": list(placement.row_sharded),
                      "host_tables": list(placement.host_row_sharded)}
            Path(out).write_text(json.dumps(result))
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, timeout: float = 240.0) -> dict:
    """Run one hybrid SGD step on an ``n_devices``-rank gloo gang of CPU
    processes (see the module's docstring) and return rank 0's report:
    the loss, the single-device step's loss on the same draw and batch,
    and the largest difference of any table row after the step.  Raises
    if a rank fails or the step disagrees with the single-device one (loss
    and tables within 1e-5).  Every process it starts is ended."""
    repo = Path(__file__).resolve().parents[2]
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": str(repo) + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "result.json")
        procs = [subprocess.Popen(
            [sys.executable, "-m", "dlrm_tpu_torch.parallel.dryrun",
             "--rank", str(r), "--world", str(n_devices), "--store",
             os.path.join(tmp, "store"), "--out", out],
            cwd=repo, env=env, stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE, text=True) for r in range(n_devices)]
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
            if p.returncode:
                raise RuntimeError(f"dry run rank {r} exited {p.returncode}:"
                                   f"\n{err[-3000:]}")
        result = json.loads(Path(out).read_text())
    if not np.isfinite(result["loss"]) or abs(
            result["loss"] - result["single_device_loss"]) > 1e-5 or \
            result["max_table_diff"] > 1e-5:
        raise RuntimeError(f"the sharded step disagrees with the "
                           f"single-device one: {result}")
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--store", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    _rank(args.rank, args.world, args.store, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
