"""dlrm_tpu_torch's sharded serving (``train.metrics.sharded_evaluate``,
``make_sharded_eval_forward``) against the port's ``evaluate`` and
``forward`` and against dlrm_tpu's ``sharded_evaluate`` on the CPU.

83 rows in batches of 32 leave a ragged tail of 19, which does not split
over 2 ranks: it is padded by one repeated row, whose prediction is
dropped, so every row counts once (tests/test_sharding.py:405).  A gloo
gang of 2 ranks is held to the JAX package's ``sharded_evaluate`` on
``make_mesh(2)`` (the tolerances of tests/test_sharding.py: loss 1e-5
relative, one flipped prediction, AUC 2e-2 across a bucket edge) and to
the port's ``evaluate`` on the unsharded tables (the same accuracy and
AUC, the loss within 1e-6 relative: its means are summed in another
order); the counters it sums stay exact as int64 past 2^53.  A process group of
one rank holds ``sharded_evaluate`` to ``evaluate`` exactly and the
sharded forward to ``forward`` within 1e-6.
"""

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from dlrm_tpu.parallel.mesh import make_mesh, param_shardings
from dlrm_tpu.parallel.placement import plan_placement as jax_plan
from dlrm_tpu.train.metrics import sharded_evaluate as jax_sharded_evaluate
from dlrm_tpu_torch.data.synthetic import random_batch
from dlrm_tpu_torch.io.convert import params_from_numpy
from dlrm_tpu_torch.models import dlrm as tmodel
from dlrm_tpu_torch.parallel import embedding as pemb
from dlrm_tpu_torch.parallel import mesh as pmesh
from dlrm_tpu_torch.parallel.placement import plan_placement
from dlrm_tpu_torch.train.metrics import (evaluate, make_sharded_eval_forward,
                                          sharded_evaluate)
from test_torch_sharded_lookup import (KINDS, SIZES, jax_sharded, jax_start,
                                       spec_config, tiny)
from torch_gang_worker import jax_sharded_arrays, run_gang

KEYS = ("dense", "sparse", "labels")


def ragged_batches(rng, config, n=83, b=32) -> list:
    full = random_batch(rng, config, n)
    return [{k: full[k][i:i + b] for k in KEYS} for i in range(0, n, b)]


def test_world_size_one_is_evaluate(tmp_path, rng):
    config = tiny(2)
    p = plan_placement(SIZES, 1, **KINDS)
    params = tmodel.init_params(torch.Generator().manual_seed(5), config)
    sh = {"bottom": params["bottom"], "top": params["top"],
          "emb": pemb.shard_tables(params["emb"], p, config)[0],
          "emb_cs": tuple(c[0] for c in pemb.shard_col_tables(
              params["emb"], p, config))}
    batches = ragged_batches(rng, config)
    pmesh.init_distributed(f"file://{tmp_path / 'store'}", 1, 0,
                           device="cpu")
    try:
        mesh = pmesh.make_mesh()
        fwd = make_sharded_eval_forward(config, mesh, p)
        dense, sparse = (torch.as_tensor(batches[0][k]) for k in KEYS[:2])
        torch.testing.assert_close(
            fwd(sh, sh["emb"], sh["emb_cs"], dense, sparse),
            tmodel.forward(params, dense, sparse, config), atol=1e-6, rtol=0)
        record = []
        got = sharded_evaluate(sh, batches, config, mesh=mesh, placement=p,
                               record=record)
    finally:
        dist.destroy_process_group()
    assert got == evaluate(params, batches, config)
    assert got["examples"] == 83 and record == [got["accuracy"]]


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    rng = np.random.default_rng(21)
    tcfg = tiny()
    jcfg, _, np_params = jax_start(tcfg, seed=9)
    jp = jax_plan(SIZES, 2, pack=1, **KINDS)
    sh = jax_sharded(np_params, jcfg, jp)
    batches = ragged_batches(rng, tcfg)
    assert batches[-1]["dense"].shape[0] == 19
    ranks = run_gang(tmp_path_factory.mktemp("eval"), 2, {
        "config": spec_config(tcfg), "placement": KINDS, "mesh": None,
        "task": "eval", "batches": len(batches)},
        {**jax_sharded_arrays(sh),
         **{f"{k}.{s}": b[k] for s, b in enumerate(batches) for k in KEYS}})
    mesh = make_mesh(2)
    jparams = {k: sh[k] for k in ("bottom", "top", "emb", "emb_cs")}
    jparams = jax.device_put(jparams, param_shardings(mesh, jparams))
    want_jax = jax_sharded_evaluate(jparams, batches, jcfg, mesh=mesh,
                                    placement=jp)
    want_port = evaluate(params_from_numpy(np_params, tcfg), batches, tcfg)
    return ranks, want_jax, want_port


@pytest.mark.parametrize("against", ["jax", "port"])
def test_gang_evaluate_counts_every_row(gang, against):
    ranks, want_jax, want_port = gang
    want = want_jax if against == "jax" else want_port
    for r in ranks:  # every rank reports the metrics of every row
        assert int(r["examples"]) == 83 == want["examples"]
        if against == "jax":
            np.testing.assert_allclose(r["loss"], want["loss"], rtol=1e-5)
            assert abs(r["accuracy"] - want["accuracy"]) <= 1 / 83 + 1e-9
            np.testing.assert_allclose(r["auc"], want["auc"], atol=2e-2)
        else:  # the same scores: a loss summed in another order
            np.testing.assert_allclose(r["loss"], want["loss"], rtol=1e-6)
            assert r["accuracy"] == want["accuracy"]
            assert r["auc"] == want["auc"]
        for key in ("loss", "accuracy", "auc"):
            assert r[key] == ranks[0][key]


def test_gang_counts_stay_exact(gang):
    """int64 sums over the ranks: of 2^60 + r and of 2^61 + 1, which no f64
    sum keeps, and of an AUC bucket of 2^40 + r, which no f32 sum keeps."""
    ranks, _, _ = gang
    for r in ranks:
        np.testing.assert_array_equal(
            r["big"], [2 ** 61 + 1, 2 ** 62 + 2, 2 ** 41 + 1])
