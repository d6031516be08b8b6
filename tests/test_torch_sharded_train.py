"""dlrm_tpu_torch's sharded SGD step (``train.sharded_train_step``) against
the single-device port and against dlrm_tpu's ``make_sharded_train_step``
on the CPU.

A process group of one rank (gloo, in this process) holds the step against
the port's ``train_step``.  Gloo gangs (``torch_gang_worker.py``) hold 3
steps against the JAX package's on its 8-device CPU mesh: 1-D with 2 ranks
against ``make_mesh(2)`` (one-hot, a batch with repeated ids), and 2-D
``(h, d) = (2, 2)`` with 4 ranks against ``make_mesh_2d(2, 2)``
(multi-hot), from the same JAX-initialised parameters and batches, every
placement kind of the slice in the plan.  Tolerance 1e-5 on the losses,
the tables (through ``unshard_tables``) and the dense parameters; the
trash row stays exactly 0, and on the 2-D mesh the DCN replicas' tables
are equal bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from dlrm_tpu.parallel.mesh import (batch_sharding, make_mesh, make_mesh_2d,
                                    param_shardings)
from dlrm_tpu.parallel.placement import plan_placement as jax_plan
from dlrm_tpu.train.train import make_sharded_train_step as jax_step
from dlrm_tpu_torch.data.synthetic import random_batch
from dlrm_tpu_torch.io import convert
from dlrm_tpu_torch.models import dlrm as tmodel
from dlrm_tpu_torch.parallel import embedding as pemb
from dlrm_tpu_torch.parallel import mesh as pmesh
from dlrm_tpu_torch.parallel.placement import plan_placement
from dlrm_tpu_torch.train import train as ttrain
from test_torch_sharded_lookup import (KINDS, SIZES, jax_sharded, jax_start,
                                       spec_config, tiny)
from torch_gang_worker import jax_sharded_arrays, run_gang

LR = 0.5
STEPS = 3
KEYS = ("dense", "sparse", "labels")


def logical_tables(emb, cs, p, config) -> np.ndarray:
    """The logical stack of per-shard stacks and column shards."""
    out = pemb.unshard_tables(emb, p, config)
    for j, t in enumerate(p.col_sharded):
        go = config.table_offsets[t]
        out[go:go + config.table_sizes[t]] = pemb.unshard_col_tables(
            [cs[j]], p)[0]
    return out


def _copy(params: dict) -> dict:
    return {**{part: [{k: v.clone() for k, v in layer.items()}
                      for layer in params[part]]
               for part in ("bottom", "top")},
            "emb": params["emb"].clone()}


@pytest.mark.parametrize("n_hot", [1, 2])
def test_world_size_one_is_the_single_device_step(tmp_path, n_hot, rng):
    config = tiny(n_hot)
    p = plan_placement(SIZES, 1, **KINDS)
    params = tmodel.init_params(torch.Generator().manual_seed(3), config)
    ref = _copy(params)
    sh = {**_copy(params), "emb": pemb.shard_tables(params["emb"], p,
                                                    config)[0],
          "emb_cs": tuple(c[0] for c in pemb.shard_col_tables(
              params["emb"], p, config))}
    pmesh.init_distributed(f"file://{tmp_path / 'store'}", 1, 0,
                           device="cpu")
    try:
        mesh = pmesh.make_mesh()
        step = ttrain.make_sharded_train_step(config, LR, mesh, p)
        for _ in range(STEPS):
            b = [torch.as_tensor(v) for v in
                 (random_batch(rng, config, 32)[k] for k in KEYS)]
            got = step(sh, *b)
            want = ttrain.train_step(ref, *b, config=config, lr=LR)
            torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
    finally:
        dist.destroy_process_group()
    tables = logical_tables(sh["emb"][None], [c[None] for c in sh["emb_cs"]],
                            p, config)
    torch.testing.assert_close(tables, ref["emb"], atol=1e-6, rtol=0)
    assert not sh["emb"][p.trash_row].any()
    for part in ("bottom", "top"):
        for a, b in zip(sh[part], ref[part]):
            torch.testing.assert_close(a["w"], b["w"], atol=1e-6, rtol=0)


MESHES = {"1d": (2, None, 1), "2d": (4, (2, 2), 2)}  # ranks, mesh, n_hot


@pytest.fixture(scope="module", params=sorted(MESHES))
def gang(request, tmp_path_factory):
    """3 steps of one gang and of the JAX package's sharded step from one
    state, on one mesh shape."""
    world, mesh_shape, n_hot = MESHES[request.param]
    rng = np.random.default_rng(11)
    tcfg = tiny(n_hot)
    jcfg, _, np_params = jax_start(tcfg, seed=3)
    jp = jax_plan(SIZES, 2, pack=1, **KINDS)
    sh = jax_sharded(np_params, jcfg, jp)
    batches = [random_batch(rng, tcfg, 16) for _ in range(STEPS)]
    batches[0]["sparse"][1] = batches[0]["sparse"][0]  # repeated ids
    arrays = {**jax_sharded_arrays(sh),
              **{f"{k}.{s}": b[k] for s, b in enumerate(batches)
                 for k in KEYS}}
    ranks = run_gang(tmp_path_factory.mktemp(f"train{request.param}"),
                     world, {"config": spec_config(tcfg), "placement": KINDS,
                             "mesh": mesh_shape, "task": "train",
                             "lr": LR, "steps": STEPS}, arrays)

    mesh = make_mesh(2) if mesh_shape is None else make_mesh_2d(*mesh_shape)
    params = {k: jax.tree.map(jnp.asarray, sh[k])
              for k in ("bottom", "top", "emb", "emb_cs")}
    params = jax.device_put(params, param_shardings(mesh, params))
    step = jax_step(jcfg, LR, mesh, jp)
    bs = batch_sharding(mesh)
    losses = []
    for b in batches:
        params, loss = step(params, *(jax.device_put(jnp.asarray(b[k]), bs)
                                      for k in KEYS))
        losses.append(float(loss))
    want = {"losses": np.asarray(losses),
            "tables": logical_tables(np.asarray(params["emb"]),
                                     [np.asarray(c) for c in
                                      params["emb_cs"]], jp, jcfg),
            "dense": jax.tree.map(np.asarray, {k: params[k] for k in
                                               ("bottom", "top")})}
    return ranks, want, jp, tcfg


def _ranks_params(ranks, parts=("bottom", "top")) -> list:
    out = []
    for r in ranks:
        d = {part: [{k: r[f"{part}.{i}.{k}"] for k in ("w", "b")}
                    for i in range(sum(1 for key in r if key.startswith(
                        part + ".") and key.endswith(".w")))]
             for part in parts}
        d["emb"] = r["emb"]
        d["emb_cs"] = tuple(r[f"emb_cs.{j}"] for j in range(sum(
            1 for key in r if key.startswith("emb_cs."))))
        out.append(d)
    return out


CHECKS = ("losses", "tables", "dense", "trash row", "replicas", "refusal")


@pytest.mark.parametrize("what", CHECKS)
def test_gang_step_matches_jax(gang, what):
    ranks, want, jp, tcfg = gang
    shards = jp.num_shards
    params = _ranks_params(ranks)
    if what == "losses":
        for r in ranks:  # every rank returns the global loss
            np.testing.assert_allclose(r["losses"], want["losses"],
                                       atol=1e-5, rtol=0)
    elif what == "tables":
        sh = convert.sharded_params_to_numpy(params[:shards])
        got = logical_tables(sh["emb"], sh["emb_cs"], jp, tcfg)
        np.testing.assert_allclose(got, want["tables"], atol=1e-5, rtol=0)
    elif what == "dense":
        for p in params:  # replicated, and the JAX package's
            for part in ("bottom", "top"):
                for a, b in zip(p[part], want["dense"][part]):
                    for k in ("w", "b"):
                        np.testing.assert_allclose(a[k], b[k], atol=1e-5,
                                                   rtol=0)
    elif what == "trash row":
        for p in params:
            assert not p["emb"][jp.trash_row].any()
    elif what == "replicas":  # the DCN replicas hold the same tables
        for r, p in enumerate(params):
            q = params[r % shards]
            np.testing.assert_array_equal(p["emb"], q["emb"])
            for a, b in zip(p["emb_cs"], q["emb_cs"]):
                np.testing.assert_array_equal(a, b)
    else:
        assert all(r["refused"] == 1 for r in ranks)


@pytest.mark.parametrize("n_hot", [1, 3])
def test_bf16_exchange_update_is_the_prerounded_gradient(tmp_path, n_hot,
                                                         rng):
    """The bf16 exchange only moves the gradient: the update equals the f32
    one of the gradient rounded once to bf16, bit for bit, on every
    placement kind (tests/test_exchange_dtype.py's contract)."""
    config = tiny(n_hot)
    p = plan_placement(SIZES, 1, **KINDS)
    emb = torch.from_numpy(rng.normal(size=(config.total_rows, 8)).astype(
        np.float32))
    ids = torch.as_tensor(random_batch(rng, config, 32)["sparse"])
    d_pooled = torch.from_numpy(rng.normal(size=(32, 6, 8)).astype(
        np.float32))
    rounded = d_pooled.to(torch.bfloat16).float()
    pmesh.init_distributed(f"file://{tmp_path / 'store'}", 1, 0,
                           device="cpu")
    try:
        mesh = pmesh.make_mesh()
        out = []
        for grad, xd in ((d_pooled, torch.bfloat16), (rounded, None)):
            sh = pemb.shard_tables(emb, p, config)[0]
            cs = tuple(c[0] for c in pemb.shard_col_tables(emb, p, config))
            pemb.sharded_update_sgd(sh, ids, grad, 0.37, mesh=mesh,
                                    placement=p, cs=cs, exchange_dtype=xd)
            out.append(logical_tables(sh[None], [c[None] for c in cs], p,
                                      config))
    finally:
        dist.destroy_process_group()
    assert torch.equal(out[0], out[1])
    assert not torch.equal(out[0], emb)
