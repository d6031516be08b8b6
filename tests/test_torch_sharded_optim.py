"""dlrm_tpu_torch's sharded Adagrad and row-wise Adagrad
(``parallel.embedding.sharded_update_adagrad``,
``train.sharded_train_step_opt``, ``init_sharded_opt_state``) against the
single-device port and against dlrm_tpu's ``make_sharded_train_step_opt``
on the CPU.

The placement has every kind: slot tables (0, 2, 4), a device row-sharded
table (1: 400 rows > 350), a host-resident row-sharded one (5) and a
column-sharded one (3).  Both packages start from one state made with
numpy: the JAX package's parameters, warm accumulators drawn from a seed
(the trash rows' kept 0).

A process group of one rank (gloo, in this process) holds three steps
against the port's single-device ``train_step_opt``; gloo gangs of 2 ranks
(``torch_gang_worker.py``) hold three steps against the JAX package's on
``make_mesh(2)``: Adagrad one-hot under a warm-up schedule and a clip that
binds, row-wise Adagrad multi-hot with a repeated id.  Tolerances (from
warm accumulators, ``ROADMAP.md`` §3): 1e-5 on losses, tables and dense
parameters, 1e-6 on every accumulator; the trash rows of both stacks and
their accumulators stay exactly 0.  The bf16 exchange only moves the
gradient: its update is the f32 update of the gradient rounded once, bit
for bit.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from dlrm_tpu.parallel import embedding as jpemb
from dlrm_tpu.parallel.mesh import batch_sharding, make_mesh, param_shardings
from dlrm_tpu.parallel.placement import plan_placement as jax_plan
from dlrm_tpu.train import train as jtrain
from dlrm_tpu.train.optim import make_schedule as jax_make_schedule
from dlrm_tpu_torch.data.synthetic import random_batch
from dlrm_tpu_torch.io import convert
from dlrm_tpu_torch.models import dlrm as tmodel
from dlrm_tpu_torch.parallel import embedding as pemb
from dlrm_tpu_torch.parallel import mesh as pmesh
from dlrm_tpu_torch.parallel.placement import plan_placement
from dlrm_tpu_torch.train import train as ttrain
from test_torch_sharded_lookup import SIZES, jax_start, spec_config, tiny
from torch_gang_worker import (jax_opt_arrays, jax_sharded_arrays,
                               opt_from_arrays, run_gang)

KINDS_H = dict(max_rows_per_shard=350, col_sharded_tables=(3,),
               host_tables=(5,))
KEYS = ("dense", "sparse", "labels")
WARMUP = {"schedule": "warmup_poly_decay", "warmup_steps": 2,
          "decay_start": 3, "decay_steps": 6}
STEPS = 3


# -- shared with test_torch_sharded_block.py and test_torch_sharded_host.py ----

def jax_sharded_h(np_params, jcfg, jp) -> dict:
    """The JAX package's sharded parameters (numpy), host stacks
    included."""
    out = {"bottom": np_params["bottom"], "top": np_params["top"],
           "emb": jpemb.shard_tables(np_params["emb"], jp, jcfg),
           "emb_cs": jpemb.shard_col_tables(np_params["emb"], jp, jcfg)}
    if jp.host_row_sharded:
        out["emb_h"] = jpemb.shard_host_tables(np_params["emb"], jp, jcfg)
    return out


def warm_state(rng, sh: dict, jp, optimizer: str) -> dict:
    """A sharded optimizer state of the JAX package's layout (numpy) with
    every accumulator drawn from [0.01, 0.02), the trash rows' 0; count
    0."""
    if optimizer == "sgd":
        return {"dense": None, "count": 0, "emb_acc": (), "emb_acc_cs": (),
                "emb_acc_h": ()}
    rowwise = optimizer == "rowwise_adagrad"

    def draw(shape):
        return rng.uniform(0.01, 0.02, size=shape).astype(np.float32)

    def stack(a):  # (N, rows, D) -> the accumulator of its layout
        acc = draw(a.shape[:2] + ((1,) if rowwise else a.shape[2:]))
        acc[:, -1] = 0.0  # the trash row
        return acc

    out = {"dense": {part: [{k: draw(np.shape(layer[k])) for k in ("w", "b")}
                            for layer in sh[part]]
                     for part in ("bottom", "top")},
           "count": 0, "emb_acc": stack(sh["emb"]),
           "emb_acc_cs": tuple(draw(c.shape[1:2]) if rowwise else draw(c.shape)
                               for c in sh["emb_cs"]),
           "emb_acc_h": stack(sh["emb_h"]) if "emb_h" in sh else ()}
    return out


def jax_device_params(sh: dict, mesh):
    params = {k: jax.tree.map(jnp.asarray, v) for k, v in sh.items()}
    return jax.device_put(params, param_shardings(mesh, params))


def jax_opt_state(np_opt: dict, jparams, jcfg, optimizer: str, lr, mesh):
    """The JAX package's ``init_sharded_opt_state`` with ``np_opt``'s
    accumulators put in."""
    st = jtrain.init_sharded_opt_state(jparams, config=jcfg,
                                       optimizer=optimizer, lr=lr, mesh=mesh)
    if optimizer == "sgd":
        return st
    rss = st["dense"][0]
    st["dense"] = (rss._replace(sum_of_squares=jax.tree.map(
        jnp.asarray, np_opt["dense"])),) + tuple(st["dense"][1:])
    st["emb_acc"] = jax.device_put(np_opt["emb_acc"], st["emb_acc"].sharding)
    st["emb_acc_cs"] = tuple(jax.device_put(a, b.sharding) for a, b in
                             zip(np_opt["emb_acc_cs"], st["emb_acc_cs"]))
    if not isinstance(st["emb_acc_h"], tuple):
        st["emb_acc_h"] = jax.device_put(np_opt["emb_acc_h"],
                                         st["emb_acc_h"].sharding)
    return st


def jax_opt_to_numpy(st: dict) -> dict:
    """The JAX package's sharded optimizer state -> numpy, the layout of
    ``opt_from_arrays``."""
    def arr(x):
        return None if isinstance(x, tuple) else np.asarray(x)

    dense = None
    if st["dense"] is not None and hasattr(st["dense"][0], "sum_of_squares"):
        dense = jax.tree.map(np.asarray, st["dense"][0].sum_of_squares)
    return {"dense": dense, "count": int(st["count"]),
            "emb_acc": arr(st["emb_acc"]),
            "emb_acc_cs": tuple(np.asarray(a) for a in st["emb_acc_cs"]),
            "emb_acc_h": arr(st["emb_acc_h"])}


def logical(sh: dict, p, config) -> np.ndarray:
    """The logical stack of sharded parameters (numpy, the JAX layout):
    per-shard stacks, host stacks and column shards."""
    out = pemb.unshard_tables(np.asarray(sh["emb"]), p, config,
                              host=None if sh.get("emb_h") is None
                              else np.asarray(sh["emb_h"]))
    for j, t in enumerate(p.col_sharded):
        go = config.table_offsets[t]
        out[go:go + config.table_sizes[t]] = pemb.unshard_col_tables(
            [np.asarray(sh["emb_cs"][j])], p)[0]
    return out


def jax_result(params, st, jp, jcfg, losses) -> dict:
    sh = {k: jax.tree.map(np.asarray, params[k]) for k in params}
    return {"losses": np.asarray(losses, np.float32),
            "tables": logical(sh, jp, jcfg),
            "dense": {k: sh[k] for k in ("bottom", "top")},
            "opt": None if st is None else jax_opt_to_numpy(st)}


def gang_result(ranks, jp, tcfg) -> dict:
    """The gang's parameters and optimizer state in the JAX layout (every
    rank's stacks side by side; dense parameters from rank 0)."""
    def mlp(r, part):
        n = sum(1 for k in r if k.startswith(part + ".") and k.endswith(".w"))
        return [{k: r[f"{part}.{i}.{k}"] for k in ("w", "b")}
                for i in range(n)]

    rows = ranks[:jp.num_shards]
    sh = {"emb": np.stack([r["emb"] for r in rows]),
          "emb_cs": tuple(np.stack([r[f"emb_cs.{j}"] for r in rows])
                          for j in range(len(jp.col_sharded))),
          "emb_h": np.stack([r["emb_h"] for r in rows]) if "emb_h" in
          rows[0] else None}
    out = {"losses": ranks[0]["losses"], "tables": logical(sh, jp, tcfg),
           "dense": {part: mlp(ranks[0], part) for part in ("bottom", "top")},
           "opt": None}
    if "opt.emb_acc" in rows[0] or "opt.count" in rows[0]:
        per = [opt_from_arrays(r) for r in rows]
        opt = dict(per[0])
        for key in ("emb_acc", "emb_acc_h"):
            if per[0][key] is not None:
                opt[key] = np.concatenate([o[key] for o in per])
        opt["emb_acc_cs"] = tuple(
            a if a.ndim == 1 else np.concatenate(
                [o["emb_acc_cs"][j] for o in per])
            for j, a in enumerate(per[0]["emb_acc_cs"]))
        out["opt"] = opt
    return out


def compare(got: dict, want: dict, what: str, ranks=None, jp=None) -> None:
    """One check of a gang against the JAX package (tolerances: the module
    docstring)."""
    if what == "losses":
        for r in ranks:  # every rank returns the global losses
            np.testing.assert_allclose(r["losses"], want["losses"],
                                       atol=1e-5, rtol=0)
    elif what == "tables":
        np.testing.assert_allclose(got["tables"], want["tables"], atol=1e-5,
                                   rtol=0)
    elif what == "dense":
        for part in ("bottom", "top"):
            for a, b in zip(got["dense"][part], want["dense"][part]):
                for k in ("w", "b"):
                    np.testing.assert_allclose(a[k], b[k], atol=1e-5,
                                               rtol=0)
    elif what == "accumulators":
        g, w = got["opt"], want["opt"]
        assert g["count"] == w["count"]
        if w["emb_acc"] is None:
            assert g["emb_acc"] is None and g["dense"] is None
            return
        for key in ("emb_acc", "emb_acc_h"):
            if w[key] is not None:
                np.testing.assert_allclose(g[key], w[key], atol=1e-6, rtol=0)
        for a, b in zip(g["emb_acc_cs"], w["emb_acc_cs"]):
            np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
        for part in ("bottom", "top"):
            for a, b in zip(g["dense"][part], w["dense"][part]):
                for k in ("w", "b"):
                    np.testing.assert_allclose(a[k], b[k], atol=1e-6,
                                               rtol=0)
    elif what == "trash rows":
        for r in ranks:
            assert not r["emb"][jp.trash_row].any()
            if "emb_h" in r:
                assert not r["emb_h"][-1].any()
            for key in ("opt.emb_acc", "opt.emb_acc_h"):
                if key in r:
                    assert not r[key][0, -1].any()
    else:
        raise ValueError(what)


CHECKS = ("losses", "tables", "dense", "accumulators", "trash rows")


def batches_for(rng, tcfg, n: int, b: int = 16) -> list:
    out = [random_batch(rng, tcfg, b) for _ in range(n)]
    out[0]["sparse"][1] = out[0]["sparse"][0]  # repeated ids
    return out


def jax_lr(lr):
    return (jax_make_schedule(lr["base"], **lr["schedule"])
            if isinstance(lr, dict) else lr)


# -- world size 1: the single-device step --------------------------------------

def shard_state(np_full: dict, p, config, optimizer: str) -> dict:
    """A single-device logical optimizer state (numpy) in the JAX
    package's sharded layout for one shard."""
    rowwise = optimizer == "rowwise_adagrad"
    acc = np_full["emb"][:, None] if rowwise else np_full["emb"]
    cs = pemb.shard_col_tables(
        np.repeat(acc, config.feature_size, 1) if rowwise else acc, p, config)
    return {"dense": np_full["dense"], "count": np_full["count"],
            "emb_acc": pemb.shard_tables(acc, p, config),
            "emb_acc_cs": tuple(c[0, :, 0] if rowwise else c for c in cs),
            "emb_acc_h": pemb.shard_host_tables(acc, p, config)}


@pytest.fixture
def solo(tmp_path):
    pmesh.init_distributed(f"file://{tmp_path / 'store'}", 1, 0,
                           device="cpu")
    try:
        yield pmesh.make_mesh()
    finally:
        dist.destroy_process_group()


def sharded_copy(params: dict, p, config) -> dict:
    """One rank's sharded parameters (world size 1) of single-device
    ones, every tensor a copy."""
    return {**{part: [{k: v.clone() for k, v in layer.items()}
                      for layer in params[part]]
               for part in ("bottom", "top")},
            "emb": pemb.shard_tables(params["emb"], p, config)[0],
            "emb_cs": tuple(c[0] for c in pemb.shard_col_tables(
                params["emb"], p, config)),
            "emb_h": pemb.shard_host_tables(params["emb"], p, config,
                                            shard=0)}


@pytest.mark.parametrize("n_hot", [1, 2])
@pytest.mark.parametrize("optimizer", ["adagrad", "rowwise_adagrad"])
def test_world_size_one_is_the_single_device_step(solo, optimizer, n_hot,
                                                  rng):
    config = tiny(n_hot)
    p = plan_placement(SIZES, 1, **KINDS_H)
    params = tmodel.init_params(torch.Generator().manual_seed(4), config)
    sh = sharded_copy(params, p, config)
    state = ttrain.init_opt_state(params, config=config, optimizer=optimizer)
    gen = torch.Generator().manual_seed(5)
    for a in [state["emb"]] + [layer[k] for part in ("bottom", "top")
                               for layer in state["dense"][part]
                               for k in ("w", "b")]:
        a.uniform_(0.01, 0.02, generator=gen)
    # a copy: on the CPU, tensors share memory with their numpy source
    np_full = copy.deepcopy(convert.opt_state_to_numpy(state))
    sh_state = convert.sharded_opt_state_from_numpy(
        shard_state(np_full, p, config, optimizer), p, optimizer, 0)
    step = ttrain.make_sharded_train_step_opt(
        config, optimizer=optimizer, lr=0.2, mesh=solo, placement=p)
    for _ in range(STEPS):
        b = [torch.as_tensor(v) for v in
             (random_batch(rng, config, 32)[k] for k in KEYS)]
        got = step(sh, sh_state, *b)
        want = ttrain.train_step_opt(params, state, *b, config=config,
                                     optimizer=optimizer, lr=0.2)
        torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
    np_sh = convert.sharded_params_to_numpy([sh])
    torch.testing.assert_close(torch.from_numpy(logical(np_sh, p, config)),
                               params["emb"], atol=1e-5, rtol=0)
    got_opt = convert.sharded_opt_state_to_numpy([sh_state])
    want_opt = shard_state(convert.opt_state_to_numpy(state), p, config,
                           optimizer)
    for key in ("emb_acc", "emb_acc_h"):
        np.testing.assert_allclose(got_opt[key], want_opt[key], atol=1e-6,
                                   rtol=0)
    for a, b in zip(got_opt["emb_acc_cs"], want_opt["emb_acc_cs"]):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
    assert got_opt["count"] == STEPS
    assert not sh["emb"][p.trash_row].any() and not sh["emb_h"][-1].any()


@pytest.mark.parametrize("n_hot", [1, 3])
@pytest.mark.parametrize("rowwise", [False, True])
def test_bf16_exchange_update_is_the_prerounded_gradient(solo, rowwise,
                                                         n_hot, rng):
    """Adagrad's exchanges only move the gradient: with the bf16 exchange
    the update equals the f32 one of the gradient rounded once to bf16,
    bit for bit, on every placement kind (the column-sharded row-wise sum
    of squares is reduced in f32 either way)."""
    config = tiny(n_hot)
    p = plan_placement(SIZES, 1, **KINDS_H)
    emb = torch.from_numpy(rng.normal(size=(config.total_rows, 8)).astype(
        np.float32))
    ids = torch.as_tensor(random_batch(rng, config, 32)["sparse"])
    d_pooled = torch.from_numpy(rng.normal(size=(32, 6, 8)).astype(
        np.float32))
    rounded = d_pooled.to(torch.bfloat16).float()
    out = []
    for grad, xd in ((d_pooled, torch.bfloat16), (rounded, None)):
        sh = sharded_copy({"bottom": [], "top": [], "emb": emb}, p, config)
        st = ttrain.init_sharded_opt_state(
            {**sh, "bottom": [], "top": []}, config=config,
            optimizer="rowwise_adagrad" if rowwise else "adagrad")
        pemb.sharded_update_adagrad(
            sh["emb"], st["emb_acc"], ids, grad, 0.37, mesh=solo,
            placement=p, cs=sh["emb_cs"], acc_cs=st["emb_acc_cs"],
            emb_h=sh["emb_h"], acc_h=st["emb_acc_h"], rowwise=rowwise,
            exchange_dtype=xd)
        out.append((logical(convert.sharded_params_to_numpy(
            [{**sh, "bottom": [], "top": []}]), p, config),
            convert.sharded_opt_state_to_numpy([{**st, "dense": None}])))
    np.testing.assert_array_equal(out[0][0], out[1][0])
    for key in ("emb_acc", "emb_acc_h"):
        np.testing.assert_array_equal(out[0][1][key], out[1][1][key])
    for a, b in zip(out[0][1]["emb_acc_cs"], out[1][1]["emb_acc_cs"]):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(out[0][0], emb.numpy())


def test_init_sharded_opt_state_layout(rng):
    config = tiny()
    p = plan_placement(SIZES, 1, **KINDS_H)
    params = tmodel.init_params(torch.Generator().manual_seed(6), config)
    sh = sharded_copy(params, p, config)
    wc = config.feature_size
    for optimizer, tail in (("adagrad", (wc,)), ("rowwise_adagrad", ())):
        st = ttrain.init_sharded_opt_state(sh, config=config,
                                           optimizer=optimizer)
        assert st["count"] == 0 and st["dense"] is not None
        assert tuple(st["emb_acc"].shape) == (p.local_rows, *tail)
        assert tuple(st["emb_acc_h"].shape) == (p.host_local_rows, *tail)
        assert [tuple(a.shape) for a in st["emb_acc_cs"]] == \
            [(300, *tail)]
        assert not any(a.any() for a in (st["emb_acc"], st["emb_acc_h"],
                                         *st["emb_acc_cs"]))
    st = ttrain.init_sharded_opt_state(sh, config=config, optimizer="sgd")
    assert st == {"dense": None, "count": 0, "emb_acc": None,
                  "emb_acc_cs": (), "emb_acc_h": None}


# -- gangs of 2 against the JAX package -----------------------------------------

GANGS = {  # optimizer, n_hot, lr, clip
    "adagrad": ("adagrad", 1, {"base": 0.1, "schedule": WARMUP}, 0.01),
    "rowwise": ("rowwise_adagrad", 2, 0.2, None),
}


@pytest.fixture(scope="module", params=sorted(GANGS))
def gang(request, tmp_path_factory):
    """3 steps of one gang and of the JAX package's sharded step from one
    state."""
    optimizer, n_hot, lr, clip = GANGS[request.param]
    rng = np.random.default_rng(13)
    tcfg = tiny(n_hot)
    jcfg, _, np_params = jax_start(tcfg, seed=5)
    jp = jax_plan(SIZES, 2, pack=1, **KINDS_H)
    sh = jax_sharded_h(np_params, jcfg, jp)
    np_opt = warm_state(rng, sh, jp, optimizer)
    batches = batches_for(rng, tcfg, STEPS)
    arrays = {**jax_sharded_arrays(sh), **jax_opt_arrays(np_opt),
              **{f"{k}.{s}": b[k] for s, b in enumerate(batches)
                 for k in KEYS}}
    ranks = run_gang(tmp_path_factory.mktemp(f"opt{request.param}"), 2,
                     {"config": spec_config(tcfg), "placement": KINDS_H,
                      "mesh": None, "task": "train_opt",
                      "optimizer": optimizer, "lr": lr, "clip": clip,
                      "steps": STEPS}, arrays)

    mesh = make_mesh(2)
    params = jax_device_params(sh, mesh)
    st = jax_opt_state(np_opt, params, jcfg, optimizer, jax_lr(lr), mesh)
    step = jtrain.make_sharded_train_step_opt(
        jcfg, optimizer=optimizer, lr=jax_lr(lr), mesh=mesh, placement=jp,
        grad_clip_norm=clip)
    bs = batch_sharding(mesh)
    losses = []
    for b in batches:
        (params, st), loss = step(params, st, *(jax.device_put(
            jnp.asarray(b[k]), bs) for k in KEYS))
        losses.append(float(loss))
    return ranks, jax_result(params, st, jp, jcfg, losses), jp, tcfg


@pytest.mark.parametrize("what", CHECKS)
def test_gang_step_opt_matches_jax(gang, what):
    ranks, want, jp, tcfg = gang
    compare(gang_result(ranks, jp, tcfg), want, what, ranks, jp)
    assert len(ranks[0]["losses"]) == STEPS


def test_state_round_trip(rng):
    """``sharded_opt_state_from_numpy`` and ``_to_numpy`` are inverses on
    every rank's share, for both optimizers."""
    jp = plan_placement(SIZES, 2, **KINDS_H)
    sh = {"bottom": [{"w": np.zeros((2, 2), np.float32),
                      "b": np.zeros(2, np.float32)}], "top": [],
          "emb": np.zeros((2, jp.local_rows, 8), np.float32),
          "emb_cs": (np.zeros((2, 300, 4), np.float32),),
          "emb_h": np.zeros((2, jp.host_local_rows, 8), np.float32)}
    for optimizer in ("adagrad", "rowwise_adagrad"):
        np_opt = warm_state(rng, sh, jp, optimizer)
        back = convert.sharded_opt_state_to_numpy([
            convert.sharded_opt_state_from_numpy(np_opt, jp, optimizer, r)
            for r in range(2)])
        for key in ("emb_acc", "emb_acc_h"):
            np.testing.assert_array_equal(back[key], np_opt[key])
        for a, b in zip(back["emb_acc_cs"], np_opt["emb_acc_cs"]):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(back["dense"]["bottom"][0]["w"],
                                      np_opt["dense"]["bottom"][0]["w"])
