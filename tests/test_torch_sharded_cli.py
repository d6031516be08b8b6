"""``python -m dlrm_tpu_torch train`` on the sharded path against the JAX
package's CLI on the CPU.

Both CLIs resume from a step-0 checkpoint that holds the same
JAX-initialised parameters (and, for row-wise Adagrad, the same warm
accumulators): the JAX package's in its own layout on its 8 virtual
devices (lane-packed unless a table is column-sharded), the port's in its
sharded checkpoint format on 2 shards, saved by a 2-rank gang
(``torch_gang_worker.py``, task ``save``).  Then ``train --sharded true
--ckpt-dir --steps 4`` and its resume to ``--steps 6 --eval-after`` run in
the JAX package's CLI in process and in the port's as a 2-rank
``--distributed`` gloo gang.  Results are read from the checkpoints and
from the lead's one JSON line (no other rank prints one).  The logical
tables (each side unsharded through its own placement) and the dense
parameters agree within 1e-5, the losses within 1e-5, the accumulators
within 1e-6, the evaluation's metrics within 2e-5.  The two sides shard
over 8 and 2: training does not depend on the topology.  Cases: SGD with
row-sharded tables, and row-wise Adagrad with slot, row-sharded,
host-resident and column-sharded tables.
"""

import json
from pathlib import Path

import jax
import numpy as np
import pytest

import dlrm_tpu
from dlrm_tpu import run as jrun
from dlrm_tpu.io import checkpoint as jck
from dlrm_tpu.parallel import embedding as jpemb
from dlrm_tpu.parallel.mesh import make_mesh
from dlrm_tpu.parallel.placement import plan_placement as jax_plan
from dlrm_tpu_torch.io import checkpoint as ck
from dlrm_tpu_torch.parallel import embedding as pemb
from dlrm_tpu_torch.parallel.placement import plan_placement
from test_torch_cli import _cfg
from test_torch_model import jax_params_to_numpy
from test_torch_predict import TABLES
from test_torch_sharded_ckpt import logical_acc
from test_torch_sharded_lookup import spec_config
from test_torch_sharded_optim import (jax_device_params, jax_opt_state,
                                      logical)
from torch_gang_worker import (jax_opt_arrays, jax_sharded_arrays, lead_line,
                               run_cli_gang, run_gang)

TRAIN = ["train", "--config", "tiny", "--table-sizes",
         ",".join(map(str, TABLES)), "--batch-size", "32",
         "--save-interval", "2"]
# tables 3, 9, 15 and 21 (2000 rows) row-sharded; rowwise: table 9 in host
# memory, table 1 column-sharded
CASES = {
    "sgd": dict(optimizer="sgd", max_rows_per_shard=1000,
                col_sharded_tables=[], host_tables=[]),
    "rowwise": dict(optimizer="rowwise_adagrad", max_rows_per_shard=1000,
                    col_sharded_tables=[1], host_tables=[9]),
}


def _flags(case: dict) -> list:
    out = ["--optimizer", case["optimizer"]]
    if case["max_rows_per_shard"] is not None:
        out += ["--max-rows-per-shard", str(case["max_rows_per_shard"])]
    if case["col_sharded_tables"]:
        out += ["--col-sharded-tables",
                ",".join(map(str, case["col_sharded_tables"]))]
    if case["host_tables"]:
        out += ["--host-tables", ",".join(map(str, case["host_tables"]))]
    return out


def _places(case: dict) -> dict:
    return {k: case[k] for k in ("max_rows_per_shard", "col_sharded_tables",
                                 "host_tables")}


def _plant(case: dict, jdir: Path, tmp: Path, train=TRAIN, cfg=None,
           shards: int = 2, jflags=()) -> dict:
    """The same step-0 state in both CLIs' checkpoints: the JAX CLI's on
    8 devices, the port's on ``shards`` (``train``: the model's flags,
    ``cfg``: the port's config of them, default the tiny one; ``jflags``:
    the JAX CLI's own); returns what the comparison needs."""
    flags = [*train, *_flags(case)]
    jcfg = jrun._build_config(jrun.build_parser().parse_args(
        [*flags, *jflags]))
    cfg = _cfg() if cfg is None else cfg
    tables = cfg.table_sizes
    places = _places(case)
    cs = tuple(case["col_sharded_tables"])
    jp = jax_plan(jcfg.table_sizes, 8, pack=jcfg.pack if not cs else 1,
                  max_rows_per_shard=places["max_rows_per_shard"],
                  col_sharded_tables=cs,
                  host_tables=tuple(case["host_tables"]))
    jparams = dlrm_tpu.init_params(jax.random.key(jcfg.seed), jcfg)
    # the JAX CLI's own layout of its draw (run._build_sharded_variant)
    jsh = {"bottom": jparams["bottom"], "top": jparams["top"],
           "emb": jpemb.shard_tables(jparams["emb"], jp, jcfg)}
    if jp.col_sharded:
        jsh["emb_cs"] = jpemb.shard_col_tables(jparams["emb"], jp, jcfg)
    if jp.host_row_sharded:
        jsh["emb_h"] = jpemb.shard_host_tables(jparams["emb"], jp, jcfg)
    np_params = jax_params_to_numpy(jparams, jcfg)
    p2 = plan_placement(tables, shards, **places)
    sh2 = {"bottom": np_params["bottom"], "top": np_params["top"],
           "emb": pemb.shard_tables(np_params["emb"], p2, cfg),
           "emb_cs": pemb.shard_col_tables(np_params["emb"], p2, cfg)}
    if p2.host_row_sharded:
        sh2["emb_h"] = pemb.shard_host_tables(np_params["emb"], p2, cfg)
    mesh = make_mesh(8)
    jdev = jax_device_params({k: v for k, v in jsh.items()}, mesh)
    opt2 = None
    if case["optimizer"] == "sgd":
        jpay = jdev
    else:  # warm accumulators, the same for every logical row
        rng = np.random.default_rng(23)
        acc = rng.uniform(0.01, 0.02, cfg.total_rows).astype(np.float32)
        dense = {part: [{k: rng.uniform(0.01, 0.02, np.shape(layer[k])
                                        ).astype(np.float32)
                         for k in ("w", "b")} for layer in sh2[part]]
                 for part in ("bottom", "top")}

        def layout(p, pemb=pemb, cfg=cfg):  # ``acc`` under plan p
            return {"dense": dense, "count": 0,
                    "emb_acc": pemb.shard_tables(acc[:, None], p, cfg),
                    "emb_acc_cs": tuple(
                        acc[cfg.table_offsets[t]:cfg.table_offsets[t]
                            + cfg.table_sizes[t]] for t in p.col_sharded),
                    "emb_acc_h": pemb.shard_host_tables(acc[:, None], p, cfg)
                    if p.host_row_sharded else ()}

        # the JAX package's own layout of a row-wise accumulator: one scalar
        # a logical row, (N, local_rows, pack), pack lanes of width 1
        jopt = jax_opt_state(layout(jp, jpemb, jcfg), jdev, jcfg,
                             case["optimizer"], 0.1, mesh)
        jpay = {"params": jdev, "opt": jopt}
        opt2 = layout(p2)
    with jck.CheckpointManager(str(jdir)) as mgr:
        mgr.save(0, jpay)
    tdir = tmp / "torch"
    arrays = jax_sharded_arrays(sh2)
    if opt2 is not None:
        arrays.update(jax_opt_arrays(opt2))
    run_gang(tmp / "plant", shards, {
        "config": spec_config(cfg), "placement": places, "mesh": None,
        "task": "save", "optimizer": case["optimizer"], "ckpt": str(tdir),
        "step": 0}, arrays)
    return {"flags": flags, "jcfg": jcfg, "jp": jp, "p2": p2, "tdir": tdir,
            "cfg": cfg, "places": places}


def _jax_state(jdir: Path, jp, jcfg, optimizer: str) -> tuple:
    """(logical tables, dense parameters, logical accumulators, dense
    accumulators, count) of the newest JAX checkpoint."""
    payload, _ = jck.restore_checkpoint(str(jdir))
    prm = payload["params"] if "opt" in payload else payload
    logical_t = jpemb.unshard_tables(
        np.asarray(prm["emb"]), jp, jcfg,
        host=np.asarray(prm["emb_h"]) if "emb_h" in prm else None)
    for j, t in enumerate(jp.col_sharded):
        go = jcfg.table_offsets[t]
        logical_t[go:go + jcfg.table_sizes[t]] = jpemb.unshard_col_tables(
            [np.asarray(prm["emb_cs"][j])], jp)[0]
    dense = {part: [{k: np.asarray(l[k]) for k in ("w", "b")}
                    for l in prm[part]] for part in ("bottom", "top")}
    if optimizer == "sgd":
        return logical_t, dense, None, None, None
    o = payload["opt"]
    # the JAX package's placement unshards its (N, local_rows, pack)
    # row-wise accumulators as a stack of width 1
    acc = logical_acc({"emb_acc": np.asarray(o["emb_acc"]),
                       "emb_acc_h": np.asarray(o["emb_acc_h"])
                       if jp.host_row_sharded else None,
                       "emb_acc_cs": tuple(np.asarray(a)
                                           for a in o["emb_acc_cs"])},
                      jp, jcfg, jpemb)
    rss = o["dense"][0]
    rss = rss["sum_of_squares"] if isinstance(rss, dict) \
        else rss.sum_of_squares
    dacc = {part: [{k: np.asarray(l[k]) for k in ("w", "b")}
                   for l in rss[part]] for part in ("bottom", "top")}
    return logical_t, dense, acc, dacc, int(np.asarray(o["count"]))


def _torch_state(tdir: Path, p2, optimizer: str, cfg=None) -> tuple:
    cfg = _cfg() if cfg is None else cfg
    got, _ = ck.restore_checkpoint(str(tdir))
    prm = got["params"] if "opt" in got else got
    sh = {"emb": prm["emb"].numpy(),
          "emb_h": prm["emb_h"].numpy() if "emb_h" in prm else None,
          "emb_cs": tuple(c.numpy() for c in prm["emb_cs"])}
    dense = {part: [{k: v.numpy() for k, v in l.items()} for l in prm[part]]
             for part in ("bottom", "top")}
    if optimizer == "sgd":
        return logical(sh, p2, cfg), dense, None, None, None
    o = got["opt"]
    acc = logical_acc({"emb_acc": o["emb_acc"].numpy(),
                       "emb_acc_h": o["emb_acc_h"].numpy()
                       if o["emb_acc_h"] is not None else None,
                       "emb_acc_cs": tuple(a.numpy()
                                           for a in o["emb_acc_cs"])},
                      p2, cfg)
    dacc = {part: [{k: v.numpy() for k, v in l.items()}
                   for l in o["dense"][part]] for part in ("bottom", "top")}
    return logical(sh, p2, cfg), dense, acc, dacc, o["count"]


@pytest.fixture(scope="module", params=sorted(CASES))
def runs(request, tmp_path_factory):
    """Both CLIs from the planted step 0 to step 4, then resumed to 6 with
    an evaluation after."""
    case = CASES[request.param]
    tmp = tmp_path_factory.mktemp(f"cli_{request.param}")
    jdir = tmp / "jax"
    plant = _plant(case, jdir, tmp)
    lines = []
    for steps, extra in (("4", []), ("6", ["--eval-after"])):
        jline = _jax_cli(plant["flags"], steps, jdir, extra)
        tline = lead_line(run_cli_gang(
            tmp, 2, [*plant["flags"], "--steps", steps, "--sharded", "true",
                     "--ckpt-dir", str(plant["tdir"]), *extra]))
        lines.append((jline, tline))
    return request.param, case, plant, jdir, lines


def _jax_cli(flags, steps, jdir, extra=()) -> dict:
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert jrun.main([*flags, "--steps", steps, "--ckpt-dir", str(jdir),
                          "--sharded", "true", *extra]) == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("what", ["losses", "tables", "dense",
                                  "accumulators", "eval", "checkpoints"])
def test_sharded_cli_matches_the_jax_cli(runs, what):
    name, case, plant, jdir, lines = runs
    opt = case["optimizer"]
    if what == "losses":
        for (jline, tline), done in zip(lines, (4, 2)):
            assert jline["steps"] == tline["steps"] == done
            assert tline["device"] == "cpu"
            assert abs(jline["final_loss"] - tline["final_loss"]) <= 1e-5
        return
    if what == "checkpoints":
        assert ck.all_steps(plant["tdir"]) == [2, 4, 6]
        record = ck.checkpoint_placement(plant["tdir"])
        assert record == {"table_sizes": list(TABLES), "num_shards": 2,
                          **_places(case)}
        metas = [json.loads(Path(d, "run_meta.json").read_text())
                 for d in (jdir, plant["tdir"])]
        assert metas[1]["sharded"] and metas[1]["pack"] == 1
        assert metas[0]["num_shards"] == 8 and metas[1]["num_shards"] == 2
        same = set(metas[1]) - {"num_shards", "pack"}
        assert same <= set(metas[0]) and len(same) == 12
        assert {k: metas[0][k] for k in same} == {k: metas[1][k]
                                                  for k in same}
        return
    if what == "eval":
        jm, tm = lines[1][0]["eval"], lines[1][1]["eval"]
        assert jm["examples"] == tm["examples"] == 320
        for k in ("accuracy", "auc", "loss"):
            assert abs(jm[k] - tm[k]) <= 2e-5, (k, jm[k], tm[k])
        return
    want = _jax_state(jdir, plant["jp"], plant["jcfg"], opt)
    got = _torch_state(plant["tdir"], plant["p2"], opt)
    if what == "tables":
        np.testing.assert_allclose(got[0], want[0], atol=1e-5, rtol=0)
    elif what == "dense":
        for part in ("bottom", "top"):
            for a, b in zip(got[1][part], want[1][part]):
                for k in ("w", "b"):
                    np.testing.assert_allclose(a[k], b[k], atol=1e-5,
                                               rtol=0)
    elif opt == "sgd":
        assert got[2] is None and want[2] is None
    else:
        assert got[4] == want[4] == 6
        np.testing.assert_allclose(got[2], want[2], atol=1e-6, rtol=0)
        for part in ("bottom", "top"):
            for a, b in zip(got[3][part], want[3][part]):
                for k in ("w", "b"):
                    np.testing.assert_allclose(a[k], b[k], atol=1e-6,
                                               rtol=0)
