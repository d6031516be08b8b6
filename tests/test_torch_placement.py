"""dlrm_tpu_torch.parallel.placement, the layout half of
parallel/embedding.py, parallel/mesh.py and the sharded parameter
converters, against dlrm_tpu.parallel on the CPU (no gang).

``plan_placement`` must give the JAX package's plan at ``pack=1`` field for
field, and every layout function the JAX package's arrays bit for bit,
from numpy and from tensors.  The mesh cases run in a process group of
one rank (gloo) in this process.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

import dlrm_tpu
from dlrm_tpu.parallel import embedding as jpemb
from dlrm_tpu.parallel.placement import plan_placement as jax_plan
from dlrm_tpu_torch import config as tc
from dlrm_tpu_torch.io import convert
from dlrm_tpu_torch.parallel import embedding as pemb
from dlrm_tpu_torch.parallel import mesh as pmesh
from dlrm_tpu_torch.parallel.placement import TablePlacement, plan_placement

FIELDS = [f.name for f in dataclasses.fields(TablePlacement)]


def assert_same_plan(got, want) -> None:
    """Every field of the port's plan equals the JAX package's."""
    for name in FIELDS:
        a, b = getattr(got, name), getattr(want, name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            assert a == b, name
    assert got.slot_table_list == want.slot_table_list
    assert got.host_row_sharded == want.host_row_sharded
    assert got.trash_row == want.trash_row
    np.testing.assert_array_equal(got.out_column(), want.out_column())
    np.testing.assert_array_equal(got.output_order(), want.output_order())


# (max_rows_per_shard, col_sharded_tables, host_tables)
KINDS = {"slots": (None, (), ()), "row": (350, (), ()),
         "col": (None, (3, 3), ()), "host": (None, (), (5,)),
         "all": (350, (3,), (6,))}


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("shards", range(1, 9))
def test_plan_matches_jax(shards, kind, rng):
    sizes = [64, 400, 12, 300, 64, 500, 450] + [
        int(x) for x in rng.integers(1, 700, size=5)]
    rows, cols, host = KINDS[kind]
    kw = dict(max_rows_per_shard=rows, col_sharded_tables=cols,
              host_tables=host)
    assert_same_plan(plan_placement(sizes, shards, **kw),
                     jax_plan(sizes, shards, pack=1, **kw))


def test_terabyte_plan_matches_jax():
    """The Terabyte-scale plan of tests/test_sharding.py (64 shards, the
    biggest tables on the host, the rest row-sharded above 8M rows)."""
    sizes = tc.TERABYTE_TABLE_SIZES
    biggest = tuple(sorted(range(len(sizes)), key=lambda t: -sizes[t])[:4])
    kw = dict(max_rows_per_shard=8_000_000, host_tables=biggest)
    got = plan_placement(sizes, 64, **kw)
    assert_same_plan(got, jax_plan(sizes, 64, pack=1, **kw))
    assert set(got.host_row_sharded) == set(biggest)
    for k, t in enumerate(got.row_sharded):
        assert got.rs_rows_per_shard[k] * 64 >= sizes[t]


@pytest.mark.parametrize("kw,match", [
    (dict(col_sharded_tables=(7,)), "out of range"),
    (dict(host_tables=(-1,)), "out of range"),
    (dict(col_sharded_tables=(1,), host_tables=(1,)), "both"),
    (dict(pack=4), "TPU storage layout"),
])
def test_plan_refuses_what_jax_refuses(kw, match):
    with pytest.raises(ValueError, match=match):
        plan_placement([10] * 7, 2, **kw)
    if "pack" not in kw:
        with pytest.raises(ValueError, match=match):
            jax_plan([10] * 7, 2, **kw)


def _config(sizes=(64, 400, 12, 300, 64, 500, 450), d=8):
    return dataclasses.replace(tc.tiny_config(num_tables=len(sizes),
                                              feature_size=d),
                               table_sizes=tuple(sizes))


@pytest.mark.parametrize("as_tensor", [False, True])
@pytest.mark.parametrize("shards", [1, 2, 3, 4])
def test_layout_matches_jax_bit_for_bit(shards, as_tensor, rng):
    """shard_tables, shard_host_tables, shard_col_tables and their
    inverses, and placement_arrays, from numpy or from a tensor."""
    config = _config(d=12)
    jcfg = dlrm_tpu.tiny_config(num_tables=7, feature_size=12)
    jcfg = dataclasses.replace(jcfg, table_sizes=config.table_sizes)
    kw = dict(max_rows_per_shard=350, col_sharded_tables=(3,),
              host_tables=(6,))
    p = plan_placement(config.table_sizes, shards, **kw)
    jp = jax_plan(config.table_sizes, shards, pack=1, **kw)
    stacked = rng.normal(size=(config.total_rows, 12)).astype(np.float32)
    src = torch.from_numpy(stacked.copy()) if as_tensor else stacked

    def arr(x):
        return x.numpy() if isinstance(x, torch.Tensor) else x

    sh = pemb.shard_tables(src, p, config)
    host = pemb.shard_host_tables(src, p, config)
    cs = pemb.shard_col_tables(src, p, config)
    assert isinstance(sh, torch.Tensor) == as_tensor
    np.testing.assert_array_equal(arr(sh),
                                  jpemb.shard_tables(stacked, jp, jcfg))
    np.testing.assert_array_equal(arr(host),
                                  jpemb.shard_host_tables(stacked, jp, jcfg))
    for a, b in zip(cs, jpemb.shard_col_tables(stacked, jp, jcfg)):
        np.testing.assert_array_equal(arr(a), b)
    back = arr(pemb.unshard_tables(sh, p, config, host=host))
    np.testing.assert_array_equal(
        back, jpemb.unshard_tables(arr(sh), jp, jcfg, host=arr(host)))
    for a, b in zip(pemb.unshard_col_tables(cs, p),
                    jpemb.unshard_col_tables([arr(c) for c in cs], jp)):
        np.testing.assert_array_equal(arr(a), b)
    # with the column-sharded tables put back, the round trip is exact
    for j, t in enumerate(p.col_sharded):
        go = config.table_offsets[t]
        back[go:go + config.table_sizes[t]] = arr(
            pemb.unshard_col_tables(cs, p)[j])
    np.testing.assert_array_equal(back, stacked)
    assert not arr(sh)[:, p.trash_row].any()
    jmeta = jpemb.placement_arrays(jp)
    for r in range(shards):
        meta = pemb.placement_arrays(p, r)
        for name in ("slot_tables", "slot_valid", "slot_offsets"):
            assert meta[name].dtype == torch.int64
            np.testing.assert_array_equal(meta[name].numpy(),
                                          np.asarray(jmeta[name])[r])


def test_sharded_params_round_trip_and_shape_checks(rng):
    config = _config()
    p = plan_placement(config.table_sizes, 2, max_rows_per_shard=350,
                       col_sharded_tables=(3,))
    stacked = rng.normal(size=(config.total_rows, 8)).astype(np.float32)
    dense = {part: [{"w": rng.normal(size=(3, 2)).astype(np.float32),
                     "b": rng.normal(size=2).astype(np.float32)}]
             for part in ("bottom", "top")}
    np_params = {**dense, "emb": pemb.shard_tables(stacked, p, config),
                 "emb_cs": pemb.shard_col_tables(stacked, p, config)}
    ranks = [convert.sharded_params_from_numpy(np_params, p, r)
             for r in range(2)]
    assert ranks[1]["emb"].shape == (p.local_rows, 8)
    assert ranks[1]["emb_cs"][0].shape == (300, 4)
    back = convert.sharded_params_to_numpy(ranks)
    np.testing.assert_array_equal(back["emb"], np_params["emb"])
    np.testing.assert_array_equal(back["emb_cs"][0], np_params["emb_cs"][0])
    np.testing.assert_array_equal(back["top"][0]["w"], dense["top"][0]["w"])
    with pytest.raises(ValueError, match="placement needs"):
        convert.sharded_params_from_numpy(
            {**np_params, "emb": np_params["emb"][:1]}, p, 0)
    with pytest.raises(ValueError, match="column-sharded"):
        convert.sharded_params_from_numpy({**np_params, "emb_cs": ()}, p, 0)


@pytest.fixture
def solo(tmp_path):
    """A process group of one rank (gloo) in this process."""
    pmesh.init_distributed(f"file://{tmp_path / 'store'}", 1, 0,
                           device="cpu")
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_mesh_of_one_rank(solo):
    assert dist.get_backend() == "gloo" and pmesh.is_lead_process()
    mesh = pmesh.make_mesh()
    assert mesh.mesh_dim_names == ("d",)
    assert pmesh.dcn_axis_of(mesh) is None
    assert pmesh.local_batch_rows(mesh, 10) == (0, 10)
    mesh2 = pmesh.make_mesh_2d(1, 1)
    assert mesh2.mesh_dim_names == ("h", "d")
    assert pmesh.dcn_axis_of(mesh2) == "h"
    assert pmesh.mesh_rank(mesh2) == 0
    with pytest.raises(ValueError, match="gang has 1"):
        pmesh.make_mesh(2)
    with pytest.raises(ValueError, match="gang has 1"):
        pmesh.make_mesh_2d(2, 1)
    # a second call checks the backend and keeps the group
    assert pmesh.init_distributed(device="cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="needs nccl"):
        pmesh.init_distributed(device="cuda")


def test_init_distributed_reads_the_torchrun_environment(monkeypatch,
                                                         tmp_path):
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    for k, v in (("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", str(port)),
                 ("WORLD_SIZE", "1"), ("RANK", "0")):
        monkeypatch.setenv(k, v)
    assert pmesh.is_lead_process()  # no group yet
    try:
        assert pmesh.init_distributed(device="cpu") == torch.device("cpu")
        assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
    finally:
        dist.destroy_process_group()
    with pytest.raises(ValueError, match="need a coordinator_address"):
        pmesh.init_distributed(num_processes=2, device="cpu")
    with pytest.raises(ValueError, match="needs num_processes"):
        pmesh.init_distributed("127.0.0.1:1", device="cpu")
