"""dlrm_tpu_torch's sharded lookup (parallel/embedding.py) against the
single-device port and against dlrm_tpu's ``sharded_lookup`` on the CPU.

A process group of one rank (gloo, in this process) holds the lookup
against the port's ``ops.embedding.lookup``; gloo gangs of 2 and 4 ranks
(``torch_gang_worker.py``, one process a rank) against the JAX package's
on ``make_mesh(2)`` / ``make_mesh(4)`` of the 8-device CPU mesh, from the
same JAX-initialised tables.  The placement has every kind the slice
serves: slot tables, row-sharded tables (rows > 350) and a column-sharded
table.  Tolerances: 1e-6 on f32 (the pools sum in another order); the
bf16 exchange of a one-hot lookup is the f32 lookup rounded once, bit for
bit (as the JAX package's is, tests/test_exchange_dtype.py), and a
multi-hot one is held to that file's bound.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import dlrm_tpu
from dlrm_tpu.parallel import embedding as jpemb
from dlrm_tpu.parallel.mesh import batch_sharding, make_mesh
from dlrm_tpu.parallel.placement import plan_placement as jax_plan
from dlrm_tpu_torch import config as tc
from dlrm_tpu_torch.ops import embedding as temb
from dlrm_tpu_torch.parallel import embedding as pemb
from dlrm_tpu_torch.parallel import mesh as pmesh
from dlrm_tpu_torch.parallel.placement import plan_placement
from test_torch_model import jax_config, jax_params_to_numpy
from torch_gang_worker import jax_sharded_arrays, run_gang

SIZES = (64, 400, 12, 300, 64, 500)
KINDS = dict(max_rows_per_shard=350, col_sharded_tables=(3,))
BATCH = 32


def tiny(n_hot=1, **kw) -> tc.DLRMConfig:
    """6 tables of 12 to 500 rows, D=8: under KINDS tables 1 and 5 are
    row-sharded, table 3 column-sharded, the rest take slots."""
    return dataclasses.replace(tc.tiny_config(num_tables=6, feature_size=8,
                                              n_hot=n_hot),
                               table_sizes=SIZES, **kw)


def jax_start(tcfg, seed=7):
    """(JAX config, JAX params, the logical stack as numpy) from one JAX
    init."""
    jcfg = dataclasses.replace(jax_config(tcfg), packed_tables=False)
    jparams = dlrm_tpu.init_params(jax.random.key(seed), jcfg)
    return jcfg, jparams, jax_params_to_numpy(jparams, jcfg)


def jax_sharded(np_params, jcfg, jp) -> dict:
    """The JAX package's sharded parameters (numpy) for plan ``jp``."""
    return {"bottom": np_params["bottom"], "top": np_params["top"],
            "emb": jpemb.shard_tables(np_params["emb"], jp, jcfg),
            "emb_cs": jpemb.shard_col_tables(np_params["emb"], jp, jcfg)}


def ids_for(rng, config, n_hot, b=BATCH) -> np.ndarray:
    shape = (b,) if n_hot == 1 else (b, n_hot)
    return np.stack([rng.integers(0, s, size=shape)
                     for s in config.table_sizes], axis=1).astype(np.int32)


def spec_config(tcfg, **kw) -> dict:
    return {"bottom_mlp_sizes": list(tcfg.bottom_mlp_sizes),
            "top_mlp_sizes": list(tcfg.top_mlp_sizes),
            "feature_size": tcfg.feature_size,
            "table_sizes": list(tcfg.table_sizes), "n_hot": tcfg.n_hot,
            **kw}


def bf16_bound(emb: np.ndarray, ids: np.ndarray, config, n_hot: int):
    """tests/test_exchange_dtype.py's bound on a multi-hot bf16 exchange:
    (H roundings + straddled partial sums) * 2^-8 * the pooled absolute
    row mass, + 1e-6."""
    mass = temb.lookup(torch.from_numpy(np.abs(emb)), torch.from_numpy(ids),
                       config.table_offsets).numpy()
    return mass * 2.0 ** -8 * (n_hot + 2) + 1e-6


@pytest.fixture
def solo(tmp_path):
    """A process group of one rank (gloo) in this process, and its mesh."""
    pmesh.init_distributed(f"file://{tmp_path / 'store'}", 1, 0,
                           device="cpu")
    try:
        yield pmesh.make_mesh()
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("xd", [None, torch.bfloat16])
@pytest.mark.parametrize("n_hot", [1, 3])
def test_world_size_one_is_the_single_device_lookup(solo, n_hot, xd, rng):
    config = tiny(n_hot)
    p = plan_placement(SIZES, 1, **KINDS)
    emb = torch.from_numpy(rng.normal(size=(config.total_rows, 8)).astype(
        np.float32))
    ids = torch.from_numpy(ids_for(rng, config, n_hot))
    got = pemb.sharded_lookup(
        pemb.shard_tables(emb, p, config)[0], ids, mesh=solo, placement=p,
        cs=tuple(c[0] for c in pemb.shard_col_tables(emb, p, config)),
        exchange_dtype=xd)
    want = temb.lookup(emb, ids, config.table_offsets)
    if xd is None or n_hot == 1:
        if xd is not None:
            want = want.to(xd).float()
        torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
    else:
        bound = bf16_bound(emb.numpy(), ids.numpy(), config, n_hot)
        assert (np.abs(got.numpy() - want.numpy()) <= bound).all()


def test_refusals(solo, rng):
    """Int8 scales go with int8 tables only (int8 serving:
    test_torch_sharded_quant.py); a plan for another number of shards
    does not fit the group.  Host-resident tables, refused before they
    were served, now serve and train: the lookup with the host stack is
    the plain one, and the update moves the host rows."""
    config = tiny()
    emb = torch.zeros((config.total_rows, 8))
    ids = torch.from_numpy(ids_for(rng, config, 1))
    host = plan_placement(SIZES, 1, host_tables=(1,))
    full = torch.from_numpy(rng.normal(size=(config.total_rows, 8)).astype(
        np.float32))
    sh = pemb.shard_tables(full, host, config)[0]
    emb_h = pemb.shard_host_tables(full, host, config, shard=0)
    torch.testing.assert_close(
        pemb.sharded_lookup(sh, ids, mesh=solo, placement=host, emb_h=emb_h),
        temb.lookup(full, ids, config.table_offsets), atol=1e-6, rtol=0)
    before = emb_h.clone()
    pemb.sharded_update_sgd(sh, ids, torch.ones(BATCH, 6, 8), 0.1,
                            mesh=solo, placement=host, emb_h=emb_h)
    assert not torch.equal(emb_h, before) and not emb_h[-1].any()
    p = plan_placement(SIZES, 1)
    with pytest.raises(ValueError, match="scales go with int8 tables"):
        pemb.sharded_lookup(emb, ids, mesh=solo, placement=p,
                            scales=torch.ones(1))
    with pytest.raises(ValueError, match="2 shards"):
        pemb.sharded_lookup(emb, ids, mesh=solo,
                            placement=plan_placement(SIZES, 2))


CASES = ("onehot", "multihot")


@pytest.fixture(scope="module", params=[2, 4])
def gang(request, tmp_path_factory):
    """One gang of N ranks looking up both cases, f32 and bf16 exchange,
    and the JAX package's sharded lookups of the same."""
    n = request.param
    rng = np.random.default_rng(5 + n)
    tcfg = tiny()
    jcfg, _, np_params = jax_start(tcfg)
    jp = jax_plan(SIZES, n, pack=1, **KINDS)
    sh = jax_sharded(np_params, jcfg, jp)
    ids = {"onehot": ids_for(rng, tcfg, 1), "multihot": ids_for(rng, tcfg, 3)}
    ranks = run_gang(tmp_path_factory.mktemp(f"lookup{n}"), n, {
        "config": spec_config(tcfg), "placement": KINDS, "mesh": None,
        "task": "lookup", "cases": list(CASES)},
        {**jax_sharded_arrays(sh), **ids})
    mesh = make_mesh(n)
    bs = batch_sharding(mesh)
    want = {case: np.asarray(jpemb.sharded_lookup(
        jnp.asarray(sh["emb"]), jax.device_put(jnp.asarray(ids[case]), bs),
        mesh=mesh, placement=jp,
        cs=tuple(jnp.asarray(c) for c in sh["emb_cs"]))) for case in CASES}
    return ranks, want, ids, np_params["emb"], tcfg


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_gang_lookup_matches_jax(gang, case, bf16):
    ranks, want, ids, emb, tcfg = gang
    got = np.concatenate([r[case + (".bf16" if bf16 else "")]
                          for r in ranks])
    f32 = np.concatenate([r[case] for r in ranks])
    np.testing.assert_allclose(f32, want[case], atol=1e-6, rtol=0)
    if not bf16:
        return
    if case == "onehot":  # the f32 lookup rounded once
        rounded = torch.from_numpy(f32).to(torch.bfloat16).float().numpy()
        np.testing.assert_array_equal(got, rounded)
    else:
        assert (np.abs(got - f32) <= bf16_bound(emb, ids[case], tcfg,
                                                3)).all()
