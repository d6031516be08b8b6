"""The Criteo Terabyte model with its tables beyond the card, on the CPU.

At full size (``terabyte_config(feature_size=32)``, f32, ``--hbm-budget-gb
64``) the port's tier plan is held against the JAX package's by arithmetic
alone.  The steps run on a scaled Terabyte model: the 13 tables of at most
8192 rows whole, every larger table cut to ``max(8193, rows * 1e-4)`` rows
so that it stays big (177,181 rows, D=32), under a budget that puts tables
0 and 19 in the host tier, as 64 GiB does at full size.  On it:

* the port's two-tier SGD step, row-wise Adagrad step from warm
  accumulators and K=4 row-wise block (the fused interaction's plain
  version) against the JAX package's tiered steps from one JAX-initialised
  state: losses and weights 1e-5, accumulators 1e-6;
* the same steps against the touched-rows model of ``chip_smoke.py`` (the
  card's reference for tables it cannot hold twice) at the same bounds,
  each tier tensor's change against the reference's change within 1e-3
  beyond rounding (a block 1e-2), and its XOR identity exact; a tier's
  update scaled or dropped breaks the change's bound, one bit flipped in
  an untouched row of either tier the identity;
* ``train --config terabyte --feature-size 32 --hbm-budget-gb``
  (row-wise Adagrad, K=4 blocks) against the JAX package's CLI from one
  planted step-0 checkpoint.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

import chip_smoke as smoke
import dlrm_tpu
from dlrm_tpu.data import synthetic as jsynth
from dlrm_tpu.parallel import host_tier as jht
from dlrm_tpu_torch import config as tc
from dlrm_tpu_torch.data.synthetic import batch_stream
from dlrm_tpu_torch.io import convert
from dlrm_tpu_torch.parallel import host_tier as ht
from dlrm_tpu_torch.run import main
from test_torch_host_tier import (_diffs, _jax_opt_np, _jax_tiered_np, _j,
                                  _opt_states, _t, _warm_jax)
from test_torch_model import jax_config

CPU = torch.device("cpu")
SCALED = tuple(s if s <= 8192 else max(8193, int(s * 1e-4))
               for s in tc.TERABYTE_TABLE_SIZES)
BUDGET_GB = 0.015             # the scaled model's tables 0 and 19 spill
BUDGET = int(BUDGET_GB * ht.GIB)
BATCH = 64
LR = 0.1


def _cfg(**kw):
    """The scaled Terabyte model at fs=32 on the fused interaction."""
    return dataclasses.replace(tc.terabyte_config(feature_size=32),
                               table_sizes=SCALED, interaction_impl="fused",
                               **kw)


def _jcfg(tcfg):
    """The JAX package's config of it, on the gram interaction (the same
    math; the Pallas kernel's interpret mode only costs time here)."""
    return dataclasses.replace(jax_config(tcfg), interaction_impl="gram")


# -- the plan at full size ----------------------------------------------------

@pytest.mark.parametrize("budget_gib", [40, 64])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("fs", [32, 64, 128])
def test_plan_tiers_matches_jax(fs, dtype, budget_gib):
    """Arithmetic only: nothing is allocated."""
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    tcfg = tc.terabyte_config(feature_size=fs, embedding_dtype=tdt)
    budget = int(budget_gib * ht.GIB)
    got = ht.plan_tiers(tcfg, budget)
    want = jht.plan_tiers(jax_config(tcfg), budget)
    assert (got.device_tables, got.host_tables, got.device_offsets,
            got.host_offsets, got.device_rows, got.host_rows) == (
        want.device_tables, want.host_tables, want.device_offsets,
        want.host_offsets, want.device_rows, want.host_rows)
    assert got.device_rows * fs * tdt.itemsize <= budget
    if (fs, dtype, budget_gib) == (32, "f32", 64):
        assert got.host_tables == (0, 19)
        assert got.host_rows == 520_381_046
        assert got.host_rows * 32 * 4 == 66_608_773_888
        assert got.device_rows == 362_393_513


def test_scaled_model_keeps_the_table_classes_and_the_split():
    tcfg = _cfg()
    assert tcfg.total_rows == 177_181
    small = [s <= tcfg.small_table_threshold for s in SCALED]
    assert small == [s <= 8192 for s in tc.TERABYTE_TABLE_SIZES]
    assert sum(small) == 13
    plan = ht.plan_tiers(tcfg, BUDGET)
    assert plan.host_tables == (0, 19)
    assert plan.host_tables == ht.plan_tiers(
        tc.terabyte_config(feature_size=32), 64 * ht.GIB).host_tables


# -- the steps against the JAX package ----------------------------------------

def _start(seed=0):
    """(JAX config, JAX plan, JAX tiered params, the port's) from one JAX
    init of the scaled model."""
    tcfg = _cfg()
    jcfg = _jcfg(tcfg)
    jparams = dlrm_tpu.init_params(jax.random.key(seed), jcfg)
    jplan = jht.plan_tiers(jcfg, BUDGET)
    jt = jht.init_tiered_params(jax.tree.map(np.asarray, jparams), jplan,
                                jcfg)
    tp = convert.tiered_params_from_numpy(_jax_tiered_np(jt, jplan, jcfg),
                                          ht.plan_tiers(tcfg, BUDGET), tcfg)
    return tcfg, jcfg, jplan, jt, tp


def _batches(tcfg, n, seed):
    """Random batches, a host row and a device row hit twice in each."""
    rng = np.random.default_rng(seed)
    out = [jsynth.random_batch(rng, tcfg, BATCH) for _ in range(n)]
    for b in out:
        b["sparse"][1] = b["sparse"][0]
    return out


@pytest.mark.parametrize("kind", ["sgd", "rowwise_adagrad",
                                  "rowwise_block"])
def test_tiered_steps_match_jax(kind):
    """2 SGD steps, 2 row-wise Adagrad steps from accumulators warmed to
    0.01, or one K=4 row-wise block, against the JAX package's tiered
    functions from one state."""
    tcfg, jcfg, jplan, jt, tp = _start()
    batches = _batches(tcfg, 4 if kind == "rowwise_block" else 2, 7)
    topt = jopt = None
    if kind == "sgd":
        jstep = jht.make_tiered_train_step(jcfg, LR, jplan)
        jl = []
        for b in batches:
            jt, loss = jstep(jt, *_j(b))
            jl.append(float(loss))
        tl = [float(ht.tiered_train_step(tp, *_t(b), config=tcfg, lr=LR))
              for b in batches]
    else:
        opt = "rowwise_adagrad"
        jopt, topt = _opt_states(tcfg, jcfg, jplan, jt, tp, opt, True, LR)
        if kind == "rowwise_block":
            blk = {k: np.stack([b[k] for b in batches])
                   for k in ("dense", "sparse", "labels")}
            (jt, jopt), jl = jht.make_tiered_train_block_opt(
                jcfg, optimizer=opt, lr=LR, plan=jplan)(jt, jopt, *_j(blk))
            jl = np.asarray(jl).tolist()
            tl = ht.tiered_train_block_opt(tp, topt, *_t(blk), config=tcfg,
                                           optimizer=opt, lr=LR).tolist()
        else:
            jstep = jht.make_tiered_train_step_opt(jcfg, optimizer=opt,
                                                   lr=LR, plan=jplan)
            jl, tl = [], []
            for b in batches:
                (jt, jopt), loss = jstep(jt, jopt, *_j(b))
                jl.append(float(loss))
                tl.append(float(ht.tiered_train_step_opt(
                    tp, topt, *_t(b), config=tcfg, optimizer=opt, lr=LR)))
    np.testing.assert_allclose(tl, jl, atol=1e-5, rtol=0)
    d = _diffs(tp, jt, jplan, jcfg, topt, jopt,
               "sgd" if kind == "sgd" else "rowwise_adagrad")
    assert d["emb"] <= 1e-5 and d["dense"] <= 1e-5, d
    assert max(d.get(k, 0) for k in ("dev_acc", "host_acc",
                                     "dense_acc")) <= 1e-6, d


# -- the touched-rows model ---------------------------------------------------

def _tiered(optimizer="rowwise_adagrad", seed=3):
    """The port's tiered parameters drawn into their tiers on the CPU and
    a row-wise state with warm accumulators."""
    tcfg = _cfg()
    plan = ht.plan_tiers(tcfg, BUDGET)
    tiered = ht.draw_tiered_params(torch.Generator().manual_seed(seed), plan,
                                   tcfg)
    state = ht.init_tiered_opt_state(tiered, config=tcfg,
                                     optimizer=optimizer)
    for a in [state["dev_acc"], state["host_acc"]] + smoke._tensors(
            state["dense"]):
        a.fill_(0.01)
    return tcfg, tiered, state


@pytest.mark.parametrize("kind", ["sgd", "rowwise_adagrad",
                                  "rowwise_block"])
def test_touched_rows_model_matches_the_tiered_step(kind):
    """The card's reference on the CPU: the step (or K=4 block) of the two
    tiers against the port's single-device step on the compact model of
    the touched rows, 1e-5 (accumulators 1e-6), and the XOR identity over
    every whole tier tensor exact."""
    tcfg, tiered, state = _tiered()
    block = kind == "rowwise_block"
    batches = list(batch_stream(tcfg, BATCH, 4 if block else 1, seed=11))
    res = smoke.touched_rows_check(
        tiered, state, batches, tcfg,
        optimizer="sgd" if kind == "sgd" else "rowwise_adagrad", lr=LR,
        block=block, device=CPU)
    assert res["ok"], (res["diffs"], res["rel"], res["xor"])
    keys = {f"{t}-tier {n}" for t in ("device", "host")
            for n in ("tables", "accumulators")}
    assert set(res["xor"]) == set(res["rel"]) == keys
    assert all(res["xor"].values())
    assert max(res["rel"].values()) <= res["rel_bound"] == (
        smoke.TOUCHED_REL_BLOCK if block else smoke.TOUCHED_REL)
    # tables move under every optimizer, accumulators under Adagrad only
    assert set(res["moved"]) == {k for k in keys if "tables" in k
                                 or kind != "sgd"}
    assert min(res["moved"].values()) > 0
    model = res["model"]
    # every table keeps its treatment in the compact model: a block defers
    # the big tables (SGD) or the host tier (Adagrad), a step none
    frozen = [t in tiered["emb"].plan.host_tables if block
              else s > tcfg.small_table_threshold
              for t, s in enumerate(tcfg.table_sizes)]
    cthr = model.config.small_table_threshold
    assert [s > cthr for s in model.config.table_sizes] == frozen \
        or not block
    assert model.config.total_rows < tcfg.total_rows


@pytest.mark.parametrize("kind,key,factor", [
    ("sgd", "host-tier tables", 2.0),
    ("sgd", "device-tier tables", 2.0),
    ("rowwise_adagrad", "host-tier tables", 1.1),
    ("rowwise_adagrad", "host-tier accumulators", 0.0),
    ("rowwise_adagrad", "device-tier accumulators", 0.0),
    ("rowwise_block", "host-tier tables", 1.1),
])
def test_touched_rows_check_catches_a_wrong_update(monkeypatch, kind, key,
                                                   factor):
    """The two-tier step's change to one tier tensor scaled by ``factor``
    (0: the update dropped) after the step fails the change's bound, and
    only there; the accumulators' changes (about 3e-8 here) lie far below
    their absolute bound, which cannot see it."""
    tcfg, tiered, state = _tiered()
    emb = tiered["emb"]
    stack = {"device-tier tables": emb.dev, "host-tier tables": emb.host,
             "device-tier accumulators": state["dev_acc"],
             "host-tier accumulators": state["host_acc"]}[key]
    name = {"sgd": "tiered_train_step",
            "rowwise_adagrad": "tiered_train_step_opt",
            "rowwise_block": "tiered_train_block_opt"}[kind]
    step = getattr(ht, name)

    def wrong(*a, **kw):
        before = stack.clone()
        loss = step(*a, **kw)
        stack.copy_(before + factor * (stack - before))
        return loss

    monkeypatch.setattr(ht, name, wrong)
    block = kind == "rowwise_block"
    batches = list(batch_stream(tcfg, BATCH, 4 if block else 1, seed=13))
    res = smoke.touched_rows_check(
        tiered, state, batches, tcfg,
        optimizer="sgd" if kind == "sgd" else "rowwise_adagrad", lr=LR,
        block=block, device=CPU)
    assert not res["ok"]
    assert res["rel"][key] > res["rel_bound"]
    assert all(v <= res["rel_bound"] for k, v in res["rel"].items()
               if k != key)
    assert all(res["xor"].values())


@pytest.mark.parametrize("tensor", ["tables", "accumulators"])
@pytest.mark.parametrize("tier", ["device", "host"])
def test_xor_identity_catches_one_flipped_bit(tier, tensor):
    """After a row-wise step, one bit flipped in a row of the tier that the
    step did not touch: the identity of that tensor fails, the others
    hold."""
    tcfg, tiered, state = _tiered()
    batches = list(batch_stream(tcfg, BATCH, 1, seed=12))
    res = smoke.touched_rows_check(tiered, state, batches, tcfg,
                                   optimizer="rowwise_adagrad", lr=LR,
                                   block=False, device=CPU)
    assert res["ok"]
    model = res["model"]
    emb = tiered["emb"]
    stack = {("device", "tables"): emb.dev, ("host", "tables"): emb.host,
             ("device", "accumulators"): state["dev_acc"],
             ("host", "accumulators"): state["host_acc"]}[(tier, tensor)]
    touched = set(model._tier[0 if tier == "device" else 1].tolist())
    row = next(r for r in range(stack.shape[0] - 1, -1, -1)
               if r not in touched)
    bits = stack.view(torch.int32)
    bits.view(-1)[row * (stack.numel() // stack.shape[0])] ^= 1 << 7
    key = f"{tier}-tier {tensor}"
    after = model.folds()
    xor = smoke.xor_identity(res["folds_before"], after, model.before,
                             model.tier_rows(), CPU)
    assert xor[key] is False
    assert all(v for k, v in xor.items() if k != key)


# -- the CLI against the JAX package's ----------------------------------------

TB_FLAGS = ["train", "--config", "terabyte", "--feature-size", "32",
            "--table-sizes", ",".join(map(str, SCALED)), "--hbm-budget-gb",
            str(BUDGET_GB), "--optimizer", "rowwise_adagrad",
            "--update-interval", "4", "--batch-size", "32",
            "--save-interval", "4"]


def test_terabyte_cli_matches_the_jax_cli(tmp_path, capsys):
    """``train --config terabyte --feature-size 32 --table-sizes <scaled>
    --interaction fused --hbm-budget-gb 0.015 --optimizer rowwise_adagrad
    --update-interval 4``, 8 steps (two K=4 blocks), against the JAX
    package's CLI (``--interaction gram --sharded false``) from one planted
    step-0 two-tier checkpoint with accumulators warmed to 0.01: losses and
    weights 1e-5, accumulators 1e-6."""
    from dlrm_tpu import run as jrun
    from dlrm_tpu.io import checkpoint as jck
    from dlrm_tpu_torch.io import checkpoint as ck

    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jflags = [*TB_FLAGS, "--interaction", "gram"]
    jcfg = jrun._build_config(jrun.build_parser().parse_args(jflags))
    tcfg = _cfg()
    jplan, plan = jht.plan_tiers(jcfg, BUDGET), ht.plan_tiers(tcfg, BUDGET)
    assert plan.host_tables == jplan.host_tables == (0, 19)
    jparams = dlrm_tpu.init_params(jax.random.key(jcfg.seed), jcfg)
    jt = jht.init_tiered_params(jax.tree.map(np.asarray, jparams), jplan,
                                jcfg)
    tp = convert.tiered_params_from_numpy(_jax_tiered_np(jt, jplan, jcfg),
                                          plan, tcfg)
    jopt = _warm_jax(jht.init_tiered_opt_state(
        jt, config=jcfg, optimizer="rowwise_adagrad", lr=LR, plan=jplan))
    topt = convert.tiered_opt_state_from_numpy(
        _jax_opt_np(jopt, jplan, jcfg, "rowwise_adagrad"), plan, tcfg,
        "rowwise_adagrad")
    with jck.CheckpointManager(jdir) as mgr:
        mgr.save(0, {"params": jt, "opt": jopt})
    ck.save_checkpoint(tdir, 0, {"params": ht.tiered_payload(tp),
                                 "opt": topt})

    assert jrun.main([*jflags, "--steps", "8", "--ckpt-dir", jdir,
                      "--sharded", "false"]) == 0
    jline = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert main([*TB_FLAGS, "--interaction", "fused", "--device", "cpu",
                 "--steps", "8", "--ckpt-dir", tdir]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert jline["steps"] == line["steps"] == 8
    assert abs(jline["final_loss"] - line["final_loss"]) <= 1e-5

    jpay, jstep = jck.restore_checkpoint(jdir)
    tpay, step = ck.restore_checkpoint(tdir)
    assert step == jstep == 8 and ck.all_steps(tdir) == [0, 4, 8]
    got = ht.merge_tiers(tpay["params"]["emb_dev"],
                         tpay["params"]["emb_host"], plan, tcfg)
    want = jht.merge_tiers(tuple(jpay["params"]["emb_dev"]),
                           np.asarray(jpay["params"]["emb_host"]), jplan,
                           jcfg)
    assert float(np.abs(got.numpy() - want).max()) <= 1e-5
    assert max(float(np.abs(l[k].numpy() - np.asarray(jl[k])).max())
               for part in ("bottom", "top")
               for l, jl in zip(tpay["params"][part], jpay["params"][part])
               for k in ("w", "b")) <= 1e-5
    from types import SimpleNamespace

    o = jpay["opt"]
    want_opt = _jax_opt_np({**o, "dense": [SimpleNamespace(**o["dense"][0])],
                            "dev_acc": tuple(o["dev_acc"])}, jplan, jcfg,
                           "rowwise_adagrad")
    got_opt = tpay["opt"]
    assert got_opt["count"] == want_opt["count"] == 8
    assert float(np.abs(got_opt["dev_acc"].numpy()
                        - want_opt["dev_acc"]).max()) <= 1e-6
    assert float(np.abs(got_opt["host_acc"].numpy().reshape(-1)
                        - want_opt["host_acc"]).max()) <= 1e-6
