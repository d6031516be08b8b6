"""Host-resident row-sharded tables on dlrm_tpu_torch's sharded path
(``emb_h`` through ``sharded_lookup``, ``sharded_update_sgd``,
``sharded_train_step`` and ``sharded_evaluate``) and the DCN replica check
(``parallel.embedding.make_dcn_replica_check``), on the CPU.

The host stack lives in the host tier (``parallel.host_tier._host_empty``;
on the CPU a plain tensor) and is read and written by the host-tier
kernels' plain versions here (``host_gather``, ``host_update_rows``).  A
process group of one rank holds the lookup (1e-6), serving and
``sharded_evaluate`` (exact) and the SGD step (1e-5: host rows sum a row's
hits before their one add, where the JAX package adds every hit) to the
single-device port.  Gloo gangs of 2 ranks (``torch_gang_worker.py``) hold
the lookup (1e-6), three SGD steps (1e-5) and ``sharded_evaluate`` (the
tolerances of ``test_torch_sharded_eval.py``) against the JAX package on
``make_mesh(2)`` with its host stack in ``pinned_host`` memory.  One gang
of 2 x 2 ranks runs three Adagrad steps on ``make_mesh_2d(2, 2)`` (the DCN
fold: 1e-5 and 1e-6 against the JAX package) and the replica check: True
on the trained replicas, False after one rank flips one bit of its host
stack, True again once it flips it back.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrm_tpu.parallel import embedding as jpemb
from dlrm_tpu.parallel.mesh import batch_sharding, make_mesh, make_mesh_2d
from dlrm_tpu.parallel.placement import plan_placement as jax_plan
from dlrm_tpu.train import train as jtrain
from dlrm_tpu.train.metrics import sharded_evaluate as jax_sharded_evaluate
from dlrm_tpu_torch.data.synthetic import random_batch
from dlrm_tpu_torch.io.convert import params_from_numpy
from dlrm_tpu_torch.models import dlrm as tmodel
from dlrm_tpu_torch.ops import embedding as temb
from dlrm_tpu_torch.parallel import embedding as pemb
from dlrm_tpu_torch.parallel import host_tier
from dlrm_tpu_torch.parallel.placement import plan_placement
from dlrm_tpu_torch.train import train as ttrain
from dlrm_tpu_torch.train.metrics import (evaluate, make_sharded_eval_forward,
                                          sharded_evaluate)
from test_torch_sharded_eval import ragged_batches
from test_torch_sharded_lookup import (SIZES, ids_for, jax_start,
                                       spec_config, tiny)
from test_torch_sharded_optim import (CHECKS, KEYS, KINDS_H, batches_for,
                                      compare, gang_result,
                                      jax_device_params, jax_opt_state,
                                      jax_result, jax_sharded_h,
                                      sharded_copy, solo,
                                      warm_state)  # noqa: F401
from torch_gang_worker import jax_opt_arrays, jax_sharded_arrays, run_gang

# tables 1 and 5 host-resident, 3 column-sharded, 0, 2, 4 in slots
HOST = dict(col_sharded_tables=(3,), host_tables=(1, 5))


# -- one rank ------------------------------------------------------------------

@pytest.mark.parametrize("n_hot", [1, 3])
def test_world_size_one_host_lookup_and_serving(solo, n_hot, rng):
    config = tiny(n_hot)
    p = plan_placement(SIZES, 1, **HOST)
    params = tmodel.init_params(torch.Generator().manual_seed(2), config)
    sh = sharded_copy(params, p, config)
    ids = torch.from_numpy(ids_for(rng, config, n_hot))
    got = pemb.sharded_lookup(sh["emb"], ids, mesh=solo, placement=p,
                              cs=sh["emb_cs"], emb_h=sh["emb_h"])
    torch.testing.assert_close(
        got, temb.lookup(params["emb"], ids, config.table_offsets),
        atol=1e-6, rtol=0)
    fwd = make_sharded_eval_forward(config, solo, p)
    batches = ragged_batches(rng, config)
    dense, sparse = (torch.as_tensor(batches[0][k]) for k in KEYS[:2])
    torch.testing.assert_close(
        fwd(sh, sh["emb"], sh["emb_cs"], dense, sparse, sh["emb_h"]),
        tmodel.forward(params, dense, sparse, config), atol=1e-6, rtol=0)
    assert sharded_evaluate(sh, batches, config, mesh=solo, placement=p) \
        == evaluate(params, batches, config)


@pytest.mark.parametrize("n_hot", [1, 2])
def test_world_size_one_host_sgd_step(solo, n_hot, rng):
    config = tiny(n_hot)
    p = plan_placement(SIZES, 1, **HOST)
    params = tmodel.init_params(torch.Generator().manual_seed(3), config)
    sh = sharded_copy(params, p, config)
    before = sh["emb_h"].clone()
    step = ttrain.make_sharded_train_step(config, 0.5, solo, p)
    for _ in range(3):
        b = [torch.as_tensor(v) for v in
             (random_batch(rng, config, 32)[k] for k in KEYS)]
        b[1][1] = b[1][0]  # repeated ids
        torch.testing.assert_close(
            step(sh, *b), ttrain.train_step(params, *b, config=config,
                                            lr=0.5), atol=1e-6, rtol=0)
    full = pemb.unshard_tables(sh["emb"][None], p, config,
                               host=sh["emb_h"][None])
    rows = [r for t in (1, 5) for r in range(config.table_offsets[t],
                                             config.table_offsets[t]
                                             + SIZES[t])]
    torch.testing.assert_close(full[rows], params["emb"][rows], atol=1e-5,
                               rtol=0)
    assert not torch.equal(sh["emb_h"], before)
    assert not sh["emb_h"][-1].any() and not sh["emb"][p.trash_row].any()


def test_host_tables_need_emb_h(solo, rng):
    """Without its host stack a placement with host tables is refused, by
    the lookup and both updates; a stack of the wrong shape too."""
    config = tiny()
    p = plan_placement(SIZES, 1, **HOST)
    emb = torch.zeros((p.local_rows, 8))
    ids = torch.from_numpy(ids_for(rng, config, 1))
    d = torch.zeros(32, 6, 8)
    for call in (
            lambda h: pemb.sharded_lookup(emb, ids, mesh=solo, placement=p,
                                          emb_h=h),
            lambda h: pemb.sharded_update_sgd(emb, ids, d, 0.1, mesh=solo,
                                              placement=p, emb_h=h),
            lambda h: pemb.sharded_update_adagrad(
                emb, torch.zeros_like(emb), ids, d, 0.1, mesh=solo,
                placement=p, emb_h=h)):
        with pytest.raises(ValueError, match="no emb_h"):
            call(None)
        with pytest.raises(ValueError, match="host stack"):
            call(torch.zeros(3, 8))


def test_shard_host_tables_into_a_host_tier(rng):
    """One shard's host stack written into a host-tier tensor is that
    shard of the full layout; padding and the trash row are zeroed."""
    config = tiny()
    p = plan_placement(SIZES, 2, **HOST)
    emb = torch.from_numpy(rng.normal(size=(config.total_rows, 8)).astype(
        np.float32))
    full = pemb.shard_host_tables(emb, p, config)
    for shard in range(2):
        out = host_tier._host_empty((p.host_local_rows, 8), torch.float32,
                                    "cpu").fill_(7.0)
        got = pemb.shard_host_tables(emb, p, config, shard=shard, out=out)
        assert got is out and torch.equal(out, full[shard])
    assert not full[:, -1].any()
    with pytest.raises(ValueError, match="host stack"):
        pemb.shard_host_tables(emb, p, config, shard=0,
                               out=torch.empty(3, 8))


def test_xor_fold(monkeypatch, rng):
    """The fold is the XOR of every f32 word, in chunks or not, of any
    length (odd ones too); a one-bit change changes it."""
    bits = rng.integers(-2 ** 31, 2 ** 31, size=1001).astype(np.int32)
    x = torch.from_numpy(bits.view(np.float32).copy())
    want = np.bitwise_xor.reduce(bits)
    for chunk in (1 << 26, 64, 7, 1):
        monkeypatch.setattr(pemb, "FOLD_CHUNK", chunk)
        assert int(pemb._xor_fold(x, torch.device("cpu"))) == want
        assert int(pemb._xor_fold(x[:1], torch.device("cpu"))) == bits[0]
    y = x.clone()
    y.view(torch.int32)[500] ^= 1 << 7
    assert int(pemb._xor_fold(y, torch.device("cpu"))) != want
    assert int(pemb._xor_fold(torch.zeros(0), torch.device("cpu"))) == 0


def test_replica_check_is_none_on_one_axis(solo):
    assert pemb.make_dcn_replica_check(solo) is None


# -- gangs of 2 against the JAX package -----------------------------------------

@pytest.fixture(scope="module")
def start():
    tcfg = tiny()
    jcfg, _, np_params = jax_start(tcfg, seed=12)
    jp = jax_plan(SIZES, 2, pack=1, **HOST)
    return tcfg, jcfg, np_params, jp, jax_sharded_h(np_params, jcfg, jp)


@pytest.fixture(scope="module")
def lookup_gang(start, tmp_path_factory):
    tcfg, jcfg, np_params, jp, sh = start
    rng = np.random.default_rng(31)
    ids = {"onehot": ids_for(rng, tcfg, 1), "multihot": ids_for(rng, tcfg, 3)}
    ranks = run_gang(tmp_path_factory.mktemp("hostlookup"), 2, {
        "config": spec_config(tcfg), "placement": HOST, "mesh": None,
        "task": "lookup", "cases": sorted(ids)},
        {**jax_sharded_arrays(sh), **ids})
    mesh = make_mesh(2)
    params = jax_device_params(sh, mesh)
    # jitted: the JAX package's host gather places its operands, which it
    # may only do under a trace
    lookup = jax.jit(lambda p, ids: jpemb.sharded_lookup(
        p["emb"], ids, mesh=mesh, placement=jp, cs=p["emb_cs"],
        emb_h=p["emb_h"]))
    want = {case: np.asarray(lookup(params, jax.device_put(
        jnp.asarray(v), batch_sharding(mesh)))) for case, v in ids.items()}
    return ranks, want


@pytest.mark.parametrize("case", ["onehot", "multihot"])
def test_gang_host_lookup_matches_jax(lookup_gang, case):
    ranks, want = lookup_gang
    got = np.concatenate([r[case] for r in ranks])
    np.testing.assert_allclose(got, want[case], atol=1e-6, rtol=0)


@pytest.fixture(scope="module")
def sgd_gang(start, tmp_path_factory):
    tcfg, jcfg, np_params, jp, sh = start
    rng = np.random.default_rng(32)
    batches = batches_for(rng, tcfg, 3)
    ranks = run_gang(tmp_path_factory.mktemp("hostsgd"), 2, {
        "config": spec_config(tcfg), "placement": HOST, "mesh": None,
        "task": "train", "lr": 0.5, "steps": 3},
        {**jax_sharded_arrays(sh),
         **{f"{k}.{s}": b[k] for s, b in enumerate(batches) for k in KEYS}})
    mesh = make_mesh(2)
    params = jax_device_params(sh, mesh)
    step = jtrain.make_sharded_train_step(jcfg, 0.5, mesh, jp)
    bs = batch_sharding(mesh)
    losses = []
    for b in batches:
        params, loss = step(params, *(jax.device_put(jnp.asarray(b[k]), bs)
                                      for k in KEYS))
        losses.append(float(loss))
    return ranks, jax_result(params, None, jp, jcfg, losses), jp, tcfg


@pytest.mark.parametrize("what", ("losses", "tables", "dense", "trash rows"))
def test_gang_host_sgd_matches_jax(sgd_gang, what):
    ranks, want, jp, tcfg = sgd_gang
    compare(gang_result(ranks, jp, tcfg), want, what, ranks, jp)


@pytest.fixture(scope="module")
def eval_gang(start, tmp_path_factory):
    tcfg, jcfg, np_params, jp, sh = start
    batches = ragged_batches(np.random.default_rng(33), tcfg)
    ranks = run_gang(tmp_path_factory.mktemp("hosteval"), 2, {
        "config": spec_config(tcfg), "placement": HOST, "mesh": None,
        "task": "eval", "batches": len(batches)},
        {**jax_sharded_arrays(sh),
         **{f"{k}.{s}": b[k] for s, b in enumerate(batches) for k in KEYS}})
    mesh = make_mesh(2)
    want_jax = jax_sharded_evaluate(jax_device_params(sh, mesh), batches,
                                    jcfg, mesh=mesh, placement=jp)
    want_port = evaluate(params_from_numpy(np_params, tcfg), batches, tcfg)
    return ranks, want_jax, want_port


@pytest.mark.parametrize("against", ["jax", "port"])
def test_gang_host_evaluate(eval_gang, against):
    ranks, want_jax, want_port = eval_gang
    for r in ranks:
        assert int(r["examples"]) == 83
        if against == "jax":
            np.testing.assert_allclose(r["loss"], want_jax["loss"], rtol=1e-5)
            assert abs(r["accuracy"] - want_jax["accuracy"]) <= 1 / 83 + 1e-9
            np.testing.assert_allclose(r["auc"], want_jax["auc"], atol=2e-2)
        else:
            np.testing.assert_allclose(r["loss"], want_port["loss"],
                                       rtol=1e-6)
            assert r["accuracy"] == want_port["accuracy"]
            assert r["auc"] == want_port["auc"]


# -- 2 x 2: the DCN fold and the replica check ---------------------------------

@pytest.fixture(scope="module")
def dcn_gang(tmp_path_factory):
    """Three Adagrad steps of a 2 x 2 gang (multi-hot, host tables) and of
    the JAX package on make_mesh_2d(2, 2), then the replica check."""
    rng = np.random.default_rng(34)
    tcfg = tiny(2)
    jcfg, _, np_params = jax_start(tcfg, seed=14)
    jp = jax_plan(SIZES, 2, pack=1, **KINDS_H)
    sh = jax_sharded_h(np_params, jcfg, jp)
    np_opt = warm_state(rng, sh, jp, "adagrad")
    batches = batches_for(rng, tcfg, 3)
    ranks = run_gang(tmp_path_factory.mktemp("dcn"), 4, {
        "config": spec_config(tcfg), "placement": KINDS_H, "mesh": [2, 2],
        "task": "dcn_check", "optimizer": "adagrad", "lr": 0.2,
        "clip": None, "steps": 3},
        {**jax_sharded_arrays(sh), **jax_opt_arrays(np_opt),
         **{f"{k}.{s}": b[k] for s, b in enumerate(batches) for k in KEYS}})
    mesh = make_mesh_2d(2, 2)
    params = jax_device_params(sh, mesh)
    st = jax_opt_state(np_opt, params, jcfg, "adagrad", 0.2, mesh)
    step = jtrain.make_sharded_train_step_opt(jcfg, optimizer="adagrad",
                                              lr=0.2, mesh=mesh, placement=jp)
    bs = batch_sharding(mesh)
    losses = []
    for b in batches:
        (params, st), loss = step(params, st, *(jax.device_put(
            jnp.asarray(b[k]), bs) for k in KEYS))
        losses.append(float(loss))
    return ranks, jax_result(params, st, jp, jcfg, losses), jp, tcfg


@pytest.mark.parametrize("what", CHECKS + ("replicas", "replica check"))
def test_dcn_gang(dcn_gang, what):
    ranks, want, jp, tcfg = dcn_gang
    if what == "replicas":  # rank h * 2 + d holds shard d: bits equal
        for r in range(2, 4):
            for key in ranks[r]:
                if key.startswith(("emb", "opt.emb_acc")):
                    np.testing.assert_array_equal(ranks[r][key],
                                                  ranks[r - 2][key])
    elif what == "replica check":
        for r in ranks:
            assert (int(r["agree"]), int(r["agree_flipped"]),
                    int(r["agree_restored"])) == (1, 0, 1)
    else:
        compare(gang_result(ranks, jp, tcfg), want, what, ranks, jp)
