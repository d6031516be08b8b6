"""Sharded checkpoints of dlrm_tpu_torch (``io/checkpoint.py``) across world
sizes, the sharded CLI's resume and retention, serving a sharded run's
checkpoint in one process, and the dry run of the hybrid step.

A gloo gang of 2 ranks (``torch_gang_worker.py``, task ``save``) saves the
JAX package's sharded layout of one state: JAX-initialised tables with
every placement kind (slot, row-sharded on the card and in host memory,
column-sharded) and warm accumulators.  Every file must hold the ranks'
``sharded_params_to_numpy`` / ``sharded_opt_state_to_numpy`` bit for bit.
Gangs of 1, 2 and 4 ranks (task ``restore``) restore it: the unsharded
state (tables, accumulators, dense parameters, count) equals the saved one
bit for bit.  ``python -m dlrm_tpu_torch train --distributed`` saves at 2
ranks; the run resumed at 2 and at 1 (``--sharded true``) agree within
1e-5 (1e-6 on accumulators); ``eval`` and ``predict --ckpt-dir`` of its
checkpoint in one process equal ``evaluate`` and ``score_batch`` on the
unsharded parameters within 1e-6.
"""

import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from dlrm_tpu_torch.data.synthetic import batch_stream
from dlrm_tpu_torch.io import checkpoint as ck
from dlrm_tpu_torch.io import convert
from dlrm_tpu_torch.parallel import embedding as pemb
from dlrm_tpu_torch.parallel.placement import plan_placement
from dlrm_tpu_torch.run import main, score_batch
from dlrm_tpu_torch.train.metrics import evaluate
from test_torch_cli import TINY26, _cfg
from test_torch_predict import TABLES, _write_dac
from test_torch_sharded_lookup import SIZES, jax_start, spec_config, tiny
from test_torch_sharded_optim import (KINDS_H, jax_sharded_h, logical,
                                      warm_state)
from torch_gang_worker import (jax_opt_arrays, jax_sharded_arrays, lead_line,
                               opt_from_arrays, run_cli_gang, run_gang)

OPTIMIZERS = ("adagrad", "rowwise_adagrad")


def logical_acc(opt: dict, p, config, emb=pemb) -> np.ndarray:
    """The logical accumulator stack of a sharded optimizer state (the JAX
    layout, numpy): ``(R, D)``, or ``(R, 1)`` row-wise; ``emb``: the
    package whose ``unshard_tables`` and ``unshard_col_tables`` read it
    (the placement ``p`` is that package's)."""
    out = emb.unshard_tables(opt["emb_acc"], p, config,
                             host=opt.get("emb_acc_h"))
    for j, t in enumerate(p.col_sharded):
        c = opt["emb_acc_cs"][j]
        go = config.table_offsets[t]
        out[go:go + config.table_sizes[t]] = (
            c[:, None] if c.ndim == 1 else emb.unshard_col_tables([c], p)[0])
    return out


def gang_state(ranks, p) -> tuple:
    """(parameters in the JAX layout, optimizer state in the JAX layout) of
    a gang's results: every rank's stacks side by side, dense parts from
    rank 0."""
    def mlp(r, part):
        n = sum(1 for k in r if k.startswith(part + ".") and k.endswith(".w"))
        return [{k: r[f"{part}.{i}.{k}"] for k in ("w", "b")}
                for i in range(n)]

    sh = {"emb": np.stack([r["emb"] for r in ranks]),
          "emb_cs": tuple(np.stack([r[f"emb_cs.{j}"] for r in ranks])
                          for j in range(len(p.col_sharded))),
          "emb_h": np.stack([r["emb_h"] for r in ranks])
          if "emb_h" in ranks[0] else None,
          "bottom": mlp(ranks[0], "bottom"), "top": mlp(ranks[0], "top")}
    per = [opt_from_arrays(r) for r in ranks]
    opt = dict(per[0])
    for key in ("emb_acc", "emb_acc_h"):
        if per[0][key] is not None:
            opt[key] = np.concatenate([o[key] for o in per])
    opt["emb_acc_cs"] = tuple(
        a if a.ndim == 1 else np.concatenate([o["emb_acc_cs"][j] for o in per])
        for j, a in enumerate(per[0]["emb_acc_cs"]))
    return sh, opt


@pytest.fixture(scope="module", params=OPTIMIZERS)
def saved(request, tmp_path_factory):
    """A 2-rank gang's sharded checkpoint of one JAX-initialised state with
    warm accumulators, and gangs of 1, 2 and 4 ranks restoring it."""
    optimizer = request.param
    tmp = tmp_path_factory.mktemp(f"ckpt_{optimizer}")
    tcfg = tiny()
    jcfg, _, np_params = jax_start(tcfg)
    p2 = plan_placement(SIZES, 2, **KINDS_H)
    assert p2.row_sharded and p2.host_row_sharded and p2.col_sharded
    sh = jax_sharded_h(np_params, jcfg, p2)  # pack 1: the port's layout
    opt = warm_state(np.random.default_rng(3), sh, p2, optimizer)
    spec = {"config": spec_config(tcfg), "placement": KINDS_H, "mesh": None,
            "optimizer": optimizer, "ckpt": str(tmp / "ck"), "step": 7}
    run_gang(tmp / "save", 2, {**spec, "task": "save"},
             {**jax_sharded_arrays(sh), **jax_opt_arrays(opt)})
    restored = {n: run_gang(tmp / f"restore{n}", n,
                            {**spec, "task": "restore"}, {})
                for n in (1, 2, 4)}
    return tcfg, p2, sh, opt, optimizer, restored, tmp / "ck"


def test_saved_leaves_are_the_ranks_in_the_jax_layout(saved):
    tcfg, p2, sh, opt, optimizer, _, ckdir = saved
    assert ck.all_steps(ckdir) == [7]
    tree, step = ck.open_checkpoint(ckdir)
    assert step == 7
    assert ck.checkpoint_placement(ckdir) == {
        "table_sizes": list(SIZES), "num_shards": 2,
        "max_rows_per_shard": 350, "col_sharded_tables": [3],
        "host_tables": [5]}
    rank_params = [convert.sharded_params_from_numpy(sh, p2, r)
                   for r in range(2)]
    want_p = convert.sharded_params_to_numpy(rank_params)
    rank_opt = [convert.sharded_opt_state_from_numpy(
        opt_from_arrays(jax_opt_arrays(opt)), p2, optimizer, r)
        for r in range(2)]
    want_o = convert.sharded_opt_state_to_numpy(rank_opt)
    got = ck.read_tree(tree)
    p, o = got["params"], got["opt"]
    assert p["emb"].dtype == torch.float32 and tree["params"]["emb"].sharded
    np.testing.assert_array_equal(p["emb"].numpy(), want_p["emb"])
    np.testing.assert_array_equal(p["emb_h"].numpy(), want_p["emb_h"])
    for a, b in zip(p["emb_cs"], want_p["emb_cs"]):
        np.testing.assert_array_equal(a.numpy(), b)
    for part in ("bottom", "top"):
        for a, b in zip(p[part], want_p[part]):
            for k in ("w", "b"):
                np.testing.assert_array_equal(a[k].numpy(), b[k])
    assert o["count"] == want_o["count"] == 0
    np.testing.assert_array_equal(o["emb_acc"].numpy(), want_o["emb_acc"])
    np.testing.assert_array_equal(o["emb_acc_h"].numpy(), want_o["emb_acc_h"])
    for a, b in zip(o["emb_acc_cs"], want_o["emb_acc_cs"]):
        np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize("world", [1, 2, 4])
def test_restore_at_world_size_is_bit_for_bit(saved, world):
    """Slot, row-sharded, host and column-sharded tables and their
    accumulators come back unsharded to the saved bits, whatever the
    gang's size (2: each rank's slabs; 1 and 4: table by table)."""
    tcfg, p2, sh, opt, _, restored, _ = saved
    ranks = restored[world]
    pn = plan_placement(SIZES, world, **KINDS_H)
    got_sh, got_opt = gang_state(ranks, pn)
    assert all(int(r["step"]) == 7 for r in ranks)
    np.testing.assert_array_equal(logical(got_sh, pn, tcfg),
                                  logical(sh, p2, tcfg))
    np.testing.assert_array_equal(logical_acc(got_opt, pn, tcfg),
                                  logical_acc(opt, p2, tcfg))
    assert got_opt["count"] == 0
    for part in ("bottom", "top"):
        for a, b in zip(got_sh[part], sh[part]):
            for k in ("w", "b"):
                np.testing.assert_array_equal(a[k], b[k])
        for a, b in zip(got_opt["dense"][part], opt["dense"][part]):
            for k in ("w", "b"):
                np.testing.assert_array_equal(a[k], b[k])
    for r in ranks:  # trash rows stay 0
        assert not r["emb"][pn.trash_row].any()
        assert not r["opt.emb_acc"][0, -1].any()


# -- the CLI: retention, a resume at another world size, serving -------------

SHARDED26 = ["--max-rows-per-shard", "1000", "--col-sharded-tables", "1",
             "--host-tables", "9"]


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """``train --distributed`` at 2 ranks (row-wise Adagrad, every
    placement kind) to step 3, saving every step and keeping 2; the run
    resumed to step 5 at 2 ranks, and a copy of it at 1 (``--sharded
    true`` in this process)."""
    tmp = tmp_path_factory.mktemp("cli")
    a, b = tmp / "a", tmp / "b"
    train = ["train", *TINY26[:4], "--batch-size", "32",
             "--optimizer", "rowwise_adagrad", *SHARDED26,
             "--save-interval", "1", "--max-to-keep", "2"]
    first = lead_line(run_cli_gang(tmp, 2, [*train, "--steps", "3",
                                            "--ckpt-dir", str(a)]))
    steps_after_first = ck.all_steps(a)
    shutil.copytree(a, b)
    two = lead_line(run_cli_gang(tmp, 2, [*train, "--steps", "5",
                                          "--ckpt-dir", str(a)]))
    return {"a": a, "b": b, "train": train, "first": first, "two": two,
            "steps_after_first": steps_after_first, "tmp": tmp}


def _unsharded(ckdir) -> tuple:
    """(logical numpy parameters, the optimizer state) of the newest
    checkpoint of a sharded run."""
    record = ck.checkpoint_placement(ckdir)
    p = plan_placement(**record)
    got, _ = ck.restore_checkpoint(ckdir)
    prm = {k: v for k, v in got["params"].items()}
    sh = {"emb": prm["emb"].numpy(),
          "emb_h": prm["emb_h"].numpy() if "emb_h" in prm else None,
          "emb_cs": tuple(c.numpy() for c in prm["emb_cs"])}
    np_params = {part: [{k: v.numpy() for k, v in layer.items()}
                        for layer in prm[part]] for part in ("bottom", "top")}
    np_params["emb"] = logical(sh, p, _cfg())
    o = got["opt"]
    opt = {"emb_acc": o["emb_acc"].numpy(),
           "emb_acc_h": o["emb_acc_h"].numpy(),
           "emb_acc_cs": tuple(c.numpy() for c in o["emb_acc_cs"])}
    return np_params, logical_acc(opt, p, _cfg()), o["count"]


def test_cli_retention_keeps_the_newest(cli_runs):
    assert cli_runs["first"]["steps"] == 3
    assert cli_runs["steps_after_first"] == [2, 3]
    assert ck.all_steps(cli_runs["a"]) == [4, 5]
    meta = json.loads(Path(cli_runs["a"], "run_meta.json").read_text())
    assert meta["sharded"] and meta["num_shards"] == 2 and meta["pack"] == 1
    assert meta["host_tables"] == [9] and meta["col_sharded_tables"] == [1]


def test_cli_resume_at_one_process_matches_two(cli_runs, capsys):
    line = _line(capsys, [*cli_runs["train"], "--device", "cpu",
                          "--sharded", "true", "--steps", "5",
                          "--ckpt-dir", str(cli_runs["b"])])
    two = cli_runs["two"]
    assert line["steps"] == two["steps"] == 2
    assert abs(line["final_loss"] - two["final_loss"]) <= 1e-5
    pa, acc_a, count_a = _unsharded(cli_runs["a"])
    pb, acc_b, count_b = _unsharded(cli_runs["b"])
    assert count_a == count_b == 5
    assert ck.checkpoint_placement(cli_runs["b"])["num_shards"] == 1
    np.testing.assert_allclose(pb["emb"], pa["emb"], atol=1e-5, rtol=0)
    np.testing.assert_allclose(acc_b, acc_a, atol=1e-6, rtol=0)
    for part in ("bottom", "top"):
        for x, y in zip(pa[part], pb[part]):
            for k in ("w", "b"):
                np.testing.assert_allclose(x[k], y[k], atol=1e-5, rtol=0)


def _line(capsys, argv):
    assert main(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("cmd", ["eval", "predict"])
def test_serving_a_sharded_checkpoint_in_one_process(cli_runs, cmd, capsys):
    """The unshard path: the tables unsharded onto one device, a chunk at
    a time; the metrics and scores of the unsharded parameters."""
    rng = np.random.default_rng(11)
    data = str(cli_runs["tmp"] / "d.bin")
    _write_dac(data, 150, rng)
    np_params, _, _ = _unsharded(cli_runs["a"])
    cfg = _cfg()
    params = convert.params_from_numpy(np_params, cfg)
    argv = [cmd, *TINY26, "--ckpt-dir", str(cli_runs["a"]), "--data", data]
    if cmd == "eval":
        got = _line(capsys, argv)
        from dlrm_tpu_torch.data.criteo import DACLoader, load
        want = evaluate(params, DACLoader(load(data), 32,
                                          drop_remainder=False), cfg)
        for k in ("accuracy", "auc", "examples"):
            assert got[k] == pytest.approx(want[k], abs=1e-6)
        assert abs(got["loss"] - want["loss"]) <= 1e-6
        return
    out = str(cli_runs["tmp"] / "s.npy")
    got = _line(capsys, [*argv, "--out", out])
    from dlrm_tpu_torch.data.criteo import DACLoader, load
    want = np.concatenate([score_batch(params, b, cfg, torch.device("cpu"))
                           for b in DACLoader(load(data), 32,
                                              drop_remainder=False)])
    assert got["examples"] == 150
    np.testing.assert_allclose(np.load(out), want, atol=1e-6, rtol=0)


def test_dryrun_multichip_runs_the_hybrid_step_on_two_ranks():
    from dlrm_tpu_torch.parallel.dryrun import dryrun_multichip

    report = dryrun_multichip(2)
    assert report["world"] == 2 and report["row_sharded"] == [23, 24, 25]
    assert report["host_tables"] == [25]
    assert abs(report["loss"] - report["single_device_loss"]) <= 1e-5
    assert report["max_table_diff"] <= 1e-5


def test_synthetic_eval_of_a_sharded_checkpoint_in_one_process(cli_runs,
                                                               capsys):
    """Without --data: 10 synthetic batches, as for any checkpoint."""
    np_params, _, _ = _unsharded(cli_runs["a"])
    cfg = _cfg()
    got = _line(capsys, ["eval", *TINY26, "--ckpt-dir", str(cli_runs["a"])])
    want = evaluate(convert.params_from_numpy(np_params, cfg),
                    batch_stream(cfg, 32, 10, 0), cfg)
    assert got.pop("device") == "cpu"
    assert got == pytest.approx(want, abs=1e-6)
