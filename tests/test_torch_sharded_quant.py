"""Int8 sharded serving of dlrm_tpu_torch against dlrm_tpu on the CPU, and
the hybrid mesh.

* ``ops.quant.quantize_sharded_stack`` and ``quantize_col_shards`` give the
  JAX package's codes and scales bit for bit (numpy and CPU tensors; trash
  and padding rows at scale 1).
* ``parallel.embedding.sharded_lookup(scales=, cs_scales=)`` on a gloo gang
  of 2 ranks (``torch_gang_worker.py``), fed the JAX package's int8 shard
  stacks (``io.convert.sharded_quant_from_numpy``), matches the JAX
  package's int8 ``sharded_lookup`` on its mesh within 1e-6: slot,
  row-sharded and column-sharded tables dequantized on their ranks, the
  host-resident table in full precision.
* ``predict --quantize-tables int8 --ckpt-dir`` on a sharded run (the
  JAX package's layout saved by a 2-rank gang) on a mesh of one
  (``--sharded true``) matches the JAX CLI's quantized sharded serving
  (``_try_load_quantized_sharded_ctx``) from the same tables within 1e-6:
  a row's codes do not depend on the shard count, and the host-resident
  table stays in full precision on both sides.  In one process the port
  unshards and quantizes every table, as the JAX CLI does where it has
  too few devices for the checkpoint's shards; held against that path.
* ``parallel.mesh.make_hybrid_mesh`` on a gang of 2 x 2 ranks, two to a
  host, is ``make_mesh_2d(2, 2)``; with every rank on a host of its own,
  ``make_mesh_2d(4, 1)``.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from dlrm_tpu import run as jrun
from dlrm_tpu.io import checkpoint as jck
from dlrm_tpu.ops import quant as jquant
from dlrm_tpu.parallel import embedding as jpemb
from dlrm_tpu.parallel.mesh import batch_sharding, make_mesh
from dlrm_tpu.parallel.placement import plan_placement as jax_plan
from dlrm_tpu_torch.ops import quant as tquant
from dlrm_tpu_torch.parallel import embedding as pemb
from dlrm_tpu_torch.parallel.placement import plan_placement
from dlrm_tpu_torch.run import main
from test_torch_cli import TINY26, _cfg
from test_torch_model import jax_config, jax_params_to_numpy
from test_torch_predict import TABLES, _write_dac
from test_torch_sharded_lookup import SIZES, ids_for, jax_start, spec_config, tiny
from test_torch_sharded_optim import KINDS_H, jax_device_params, jax_sharded_h
from torch_gang_worker import jax_sharded_arrays, run_gang


@pytest.fixture(scope="module")
def start():
    tcfg = tiny()
    jcfg, _, np_params = jax_start(tcfg, seed=21)
    jp = jax_plan(SIZES, 2, pack=1, **KINDS_H)
    return tcfg, jcfg, jp, jax_sharded_h(np_params, jcfg, jp)


@pytest.mark.parametrize("as_tensor", [False, True])
def test_quantizers_match_jax_bit_for_bit(start, as_tensor):
    tcfg, _, jp, sh = start
    wq, ws = jquant.quantize_sharded_stack(sh["emb"], 1, tcfg.feature_size)
    wcq, wcs = jquant.quantize_col_shards(sh["emb_cs"])
    conv = torch.from_numpy if as_tensor else (lambda a: a)
    q, s = tquant.quantize_sharded_stack(conv(sh["emb"]))
    cq, cs = tquant.quantize_col_shards([conv(a) for a in sh["emb_cs"]])
    np.testing.assert_array_equal(np.asarray(q), wq)
    np.testing.assert_array_equal(np.asarray(s), ws[..., 0])
    assert np.asarray(q).dtype == np.int8 and np.asarray(s).dtype == np.float32
    assert (np.asarray(s)[:, jp.trash_row] == 1).all()  # zero rows: scale 1
    for a, b in zip(cq, wcq):
        np.testing.assert_array_equal(np.asarray(a), b)
    for a, b in zip(cs, wcs):
        np.testing.assert_array_equal(np.asarray(a), b)
    # one rank's slab alone gives that slab's codes
    q1, s1 = tquant.quantize_sharded_stack(conv(sh["emb"][1]))
    np.testing.assert_array_equal(np.asarray(q1), wq[1])
    np.testing.assert_array_equal(np.asarray(s1), ws[1, :, 0])


@pytest.fixture(scope="module")
def int8_gang(start, tmp_path_factory):
    tcfg, jcfg, jp, sh = start
    rng = np.random.default_rng(41)
    ids = {"onehot": ids_for(rng, tcfg, 1), "multihot": ids_for(rng, tcfg, 3)}
    q, s = jquant.quantize_sharded_stack(sh["emb"], 1, tcfg.feature_size)
    cq, cs = jquant.quantize_col_shards(sh["emb_cs"])
    arrays = {**jax_sharded_arrays(sh), **ids, "q.emb": q, "q.scales": s,
              **{f"q.cs.{j}": a for j, a in enumerate(cq)},
              **{f"q.cs_scales.{j}": a for j, a in enumerate(cs)}}
    ranks = run_gang(tmp_path_factory.mktemp("int8lookup"), 2, {
        "config": spec_config(tcfg), "placement": KINDS_H, "mesh": None,
        "task": "lookup", "cases": sorted(ids), "int8": True}, arrays)
    mesh = make_mesh(2)
    params = jax_device_params(sh, mesh)
    shd = NamedSharding(mesh, P("d"))
    put = lambda a: jax.device_put(jnp.asarray(a), shd)  # noqa: E731
    # jitted: the JAX package's host gather places its operands under a
    # trace only
    lookup = jax.jit(lambda qe, qcs, emb_h, se, scs, ids: jpemb.sharded_lookup(
        qe, ids, mesh=mesh, placement=jp, cs=qcs, emb_h=emb_h, scales=se,
        cs_scales=scs))
    want = {case: np.asarray(lookup(
        put(q), tuple(put(a) for a in cq), params["emb_h"], put(s),
        tuple(put(a) for a in cs),
        jax.device_put(jnp.asarray(v), batch_sharding(mesh))))
        for case, v in ids.items()}
    return ranks, want


@pytest.mark.parametrize("case", ["onehot", "multihot"])
def test_gang_int8_lookup_matches_jax(int8_gang, case):
    ranks, want = int8_gang
    got = np.concatenate([r[case + ".int8"] for r in ranks])
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want[case], atol=1e-6, rtol=0)
    f32 = np.concatenate([r[case] for r in ranks])
    # int8 is within max|row| / 254 an element of each pooled hit
    assert np.abs(got - f32).max() <= 3 * np.abs(f32).max() / 254 + 1e-6


def test_int8_scales_are_checked(start, tmp_path):
    import torch.distributed as dist
    from dlrm_tpu_torch.parallel import mesh as pmesh

    tcfg, _, _, sh = start
    p1 = plan_placement(SIZES, 1, **KINDS_H)
    pmesh.init_distributed(f"file://{tmp_path / 'store'}", 1, 0,
                           device="cpu")
    try:
        mesh = pmesh.make_mesh()
        emb = torch.zeros((p1.local_rows, 8), dtype=torch.int8)
        ids = torch.zeros((4, 6), dtype=torch.int64)
        with pytest.raises(ValueError, match="without scales"):
            pemb.sharded_lookup(emb, ids, mesh=mesh, placement=p1)
        with pytest.raises(ValueError, match="scales"):
            pemb.sharded_lookup(emb, ids, mesh=mesh, placement=p1,
                                scales=torch.ones(3))
        with pytest.raises(ValueError, match="inference-only"):
            pemb.sharded_update_sgd(emb, ids, torch.zeros(4, 6, 8), 0.1,
                                    mesh=mesh, placement=p1)
    finally:
        dist.destroy_process_group()


# -- predict --quantize-tables int8 --ckpt-dir on a sharded run ----------------

PLACE26 = {"max_rows_per_shard": 1000, "host_tables": [9]}


@pytest.fixture(scope="module")
def planted(tmp_path_factory):
    """The same sharded checkpoint (2 shards, tables 3, 15 and 21
    row-sharded on the card and 9 in host memory) for both CLIs, and a
    dataset with a ragged tail."""
    tmp = tmp_path_factory.mktemp("int8predict")
    cfg = _cfg()
    jcfg = jax_config(cfg)
    import dlrm_tpu
    jparams = dlrm_tpu.init_params(jax.random.key(5), jcfg)
    np_params = jax_params_to_numpy(jparams, jcfg)
    jp = jax_plan(TABLES, 2, pack=1, **PLACE26)
    assert jp.row_sharded == (3, 9, 15, 21) and jp.host_row_sharded == (9,)
    sh = jax_sharded_h(np_params, jcfg, jp)
    meta = {"sharded": True, "num_shards": 2, "mesh_shape": None, "pack": 1,
            "max_rows_per_shard": 1000, "col_sharded_tables": [],
            "host_tables": [9], "optimizer": "sgd", "two_tier": False,
            "hbm_budget_gb": None, "wrapped_opt": False,
            "table_sizes": list(TABLES), "bf16_tables": False}
    jdir, tdir = tmp / "jax", tmp / "torch"
    jpay = {"bottom": np_params["bottom"], "top": np_params["top"],
            "emb": sh["emb"], "emb_h": sh["emb_h"]}
    with jck.CheckpointManager(str(jdir)) as mgr:
        mgr.save(0, jpay)
    run_gang(tmp / "save", 2, {
        "config": spec_config(cfg), "placement": PLACE26, "mesh": None,
        "task": "save", "optimizer": "sgd", "ckpt": str(tdir), "step": 0},
        jax_sharded_arrays(sh))
    for d in (jdir, tdir):
        Path(d, "run_meta.json").write_text(json.dumps(meta))
    data = str(tmp / "d.bin")
    _write_dac(data, 150, np.random.default_rng(17))
    return tmp, jdir, tdir, data


@pytest.mark.parametrize("sharded", ["false", "true"])
def test_int8_predict_on_a_sharded_run_matches_jax(planted, sharded, capsys,
                                                   monkeypatch):
    tmp, jdir, tdir, data = planted
    jout, tout = str(tmp / f"j{sharded}.npy"), str(tmp / f"t{sharded}.npy")
    if sharded == "false":  # the JAX CLI's path without enough devices
        monkeypatch.setattr(jrun, "_try_load_quantized_sharded_ctx",
                            lambda *a, **k: None)
    assert jrun.main(["predict", *TINY26[:4], "--batch-size", "32",
                      "--ckpt-dir", str(jdir), "--data", data, "--out", jout,
                      "--quantize-tables", "int8"]) == 0
    capsys.readouterr()
    assert main(["predict", *TINY26, "--ckpt-dir", str(tdir), "--data", data,
                 "--out", tout, "--quantize-tables", "int8", "--sharded",
                 sharded]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["examples"] == 150 and line["device"] == "cpu"
    got, want = np.load(tout), np.load(jout)
    assert got.shape == want.shape == (150,)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


# -- the hybrid mesh -------------------------------------------------------------

@pytest.mark.parametrize("per_host", [2, 1])
def test_hybrid_mesh_groups_ranks_by_host(per_host, tmp_path):
    ranks = run_gang(tmp_path, 4, {"config": spec_config(tiny()),
                                   "task": "hybrid", "per_host": per_host},
                     {})
    want = np.arange(4).reshape(4 // per_host, per_host)
    for r, out in enumerate(ranks):
        np.testing.assert_array_equal(out["hybrid"], want)
        np.testing.assert_array_equal(out["plain"], want)
        assert list(out["names"]) == ["h", "d"]
        np.testing.assert_array_equal(out["rows"], [8 * r, 8 * r + 8])
