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
  state: losses and weights 1e-5, accumulators 1e-6, and each tier's
  change to its tables against JAX's within 1e-3 (a block 1e-2) beyond
  one ulp of a row's value for each time either side rounds it; a
  doubled or dropped host-tier update breaks it;
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

import copy
import dataclasses
import functools
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
                                  _t, _warm_jax)
from test_torch_model import jax_config

CPU = torch.device("cpu")
SCALED = tuple(s if s <= 8192 else max(8193, int(s * 1e-4))
               for s in tc.TERABYTE_TABLE_SIZES)
BUDGET_GB = 0.015             # the scaled model's tables 0 and 19 spill
BUDGET = int(BUDGET_GB * ht.GIB)
BATCH = 64
LR = 0.1
F32, BF16 = torch.float32, torch.bfloat16
# the steps against the JAX package's, by table dtype: losses, tables,
# dense parameters, accumulators (bf16:
# ``test_torch_host_tier.test_bf16_tables_match_jax``'s bounds; the port
# rounds a host row's summed update once, JAX each rounded update)
BOUNDS = {F32: {"loss": 1e-5, "emb": 1e-5, "dense": 1e-5, "acc": 1e-6},
          BF16: {"loss": 1e-3, "emb": 1e-2, "dense": 2e-3, "acc": 1e-6}}


def _cfg(fs=32, dtype=F32, **kw):
    """The scaled Terabyte model at ``fs`` with ``dtype`` tables on the
    fused interaction (f32 compute)."""
    return dataclasses.replace(
        tc.terabyte_config(feature_size=fs, embedding_dtype=dtype),
        table_sizes=SCALED, interaction_impl="fused", **kw)


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

def _start(seed=0, fs=32, dtype=F32):
    """(JAX config, JAX plan, JAX tiered params, the port's) from one JAX
    init of the scaled model."""
    tcfg = _cfg(fs, dtype)
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


OPT = "rowwise_adagrad"
STEPS = {"sgd": "tiered_train_step", "rowwise_adagrad":
         "tiered_train_step_opt", "rowwise_block": "tiered_train_block_opt"}


@functools.lru_cache(maxsize=None)
def _jax_run(kind, fs, dtype):
    """The JAX package's side of :func:`check_tiered_steps`, once a case:
    2 SGD steps, 2 row-wise Adagrad steps from accumulators warmed to 0.01,
    or one K=4 row-wise block, from one JAX-initialised state.  Returns
    the scaled config, the JAX config and plan, the batches, the start
    state as numpy (params, optimizer state or None), the state after
    (``jt``, ``jopt``) and the losses."""
    tcfg, jcfg, jplan, jt, _ = _start(fs=fs, dtype=dtype)
    batches = _batches(tcfg, 4 if kind == "rowwise_block" else 2, 7)
    np_params, np_opt, jopt = _jax_tiered_np(jt, jplan, jcfg), None, None
    if kind == "sgd":
        jstep = jht.make_tiered_train_step(jcfg, LR, jplan)
        jl = []
        for b in batches:
            jt, loss = jstep(jt, *_j(b))
            jl.append(float(loss))
    else:
        jopt = _warm_jax(jht.init_tiered_opt_state(
            jt, config=jcfg, optimizer=OPT, lr=LR, plan=jplan))
        np_opt = _jax_opt_np(jopt, jplan, jcfg, OPT)
        if kind == "rowwise_block":
            blk = {k: np.stack([b[k] for b in batches])
                   for k in ("dense", "sparse", "labels")}
            (jt, jopt), jl = jht.make_tiered_train_block_opt(
                jcfg, optimizer=OPT, lr=LR, plan=jplan)(jt, jopt, *_j(blk))
            jl = np.asarray(jl).tolist()
        else:
            jstep = jht.make_tiered_train_step_opt(jcfg, optimizer=OPT,
                                                   lr=LR, plan=jplan)
            jl = []
            for b in batches:
                (jt, jopt), loss = jstep(jt, jopt, *_j(b))
                jl.append(float(loss))
    return tcfg, jcfg, jplan, batches, np_params, np_opt, jt, jopt, jl


def _tier_changes(tp, jt, jplan, jcfg, before, batches, kind):
    """Each tier's change to its tables against the JAX package's from the
    same start (``before``, the merged tables), beyond rounding: the
    ``rel`` of ``chip_smoke._change_error`` over every row of the tier,
    keyed "device-tier tables" and "host-tier tables".  A row is allowed
    one unit in the last place of its value for each time either side
    rounds it: SGD rewrites a row once a hit on the JAX side (each hit's
    update rounded to the table's dtype first), once a hit on the port's
    device tier and once on its host tier (the hits' f32 sum); row-wise
    Adagrad once a step, or a hit, whichever is fewer.  So each touched
    row may move ``rewrites + 1`` ulps apart, where ``rewrites`` are its
    hits (SGD) or its hits capped at the steps; a row no batch touches
    none."""
    emb = tp["emb"]
    got = ht.merge_tiers(emb.dev, emb.host, emb.plan, jcfg)
    want = torch.from_numpy(np.asarray(jht.merge_tiers(
        jt["emb_dev"], jt["emb_host"], jplan, jcfg), np.float32))
    sizes = np.asarray(jcfg.table_sizes)
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    hits = np.zeros(int(sizes.sum()), np.int64)
    for b in batches:
        for t, lo in enumerate(offsets):
            np.add.at(hits, lo + np.asarray(b["sparse"])[:, t].reshape(-1),
                      1)
    rewrites = hits if kind == "sgd" else np.minimum(hits, len(batches))
    updates = torch.from_numpy(np.where(hits > 0, rewrites + 1, 0))
    out = {}
    for tier, tables in (("device", emb.plan.device_tables),
                         ("host", emb.plan.host_tables)):
        rows = torch.from_numpy(np.concatenate(
            [np.arange(offsets[t], offsets[t] + sizes[t]) for t in tables]))
        out[f"{tier}-tier tables"] = smoke._change_error(
            got[rows], want[rows], before[rows], updates[rows])["rel"]
    return out


def _port_run(kind, fs, dtype):
    """The port's side of :func:`check_tiered_steps` from the same start
    and batches (``ht``'s steps looked up at the call, so that a test may
    plant a wrong one); returns (losses, the diffs of ``_diffs`` and the
    tiers' changes of :func:`_tier_changes` against the JAX package's)."""
    (tcfg, jcfg, jplan, batches, np_params, np_opt, jt, jopt,
     jl) = _jax_run(kind, fs, dtype)
    plan = ht.plan_tiers(tcfg, BUDGET)
    # a tensor made from numpy shares its memory: copy the start first
    tp = convert.tiered_params_from_numpy(copy.deepcopy(np_params), plan,
                                          tcfg)
    assert tp["emb"].host.dtype == dtype
    emb = tp["emb"]
    before = ht.merge_tiers(emb.dev, emb.host, plan, tcfg).float()
    step = getattr(ht, STEPS[kind])
    topt = None
    if kind == "sgd":
        tl = [float(step(tp, *_t(b), config=tcfg, lr=LR)) for b in batches]
    else:
        topt = convert.tiered_opt_state_from_numpy(copy.deepcopy(np_opt),
                                                   plan, tcfg, OPT)
        kw = {"config": tcfg, "optimizer": OPT, "lr": LR}
        if kind == "rowwise_block":
            blk = {k: np.stack([b[k] for b in batches])
                   for k in ("dense", "sparse", "labels")}
            tl = step(tp, topt, *_t(blk), **kw).tolist()
        else:
            tl = [float(step(tp, topt, *_t(b), **kw)) for b in batches]
    d = _diffs(tp, jt, jplan, jcfg, topt, jopt,
               "sgd" if kind == "sgd" else OPT)
    return tl, jl, d, _tier_changes(tp, jt, jplan, jcfg, before, batches,
                                    kind)


def _rel_bound(kind):
    return smoke.TOUCHED_REL_BLOCK if kind == "rowwise_block" \
        else smoke.TOUCHED_REL


def check_tiered_steps(kind, fs=32, dtype=F32):
    """2 SGD steps, 2 row-wise Adagrad steps from accumulators warmed to
    0.01, or one K=4 row-wise block, against the JAX package's tiered
    functions from one state: losses, tables, dense parameters and
    accumulators within ``BOUNDS[dtype]``, and each tier's change to its
    tables against the JAX package's change within ``chip_smoke``'s
    ``TOUCHED_REL`` (a block ``TOUCHED_REL_BLOCK``) beyond rounding
    (:func:`_tier_changes`): the absolute bound on bf16 tables lies above
    the host tier's values and cannot see a wrong update."""
    tl, jl, d, rel = _port_run(kind, fs, dtype)
    bound = BOUNDS[dtype]
    np.testing.assert_allclose(tl, jl, atol=bound["loss"], rtol=0)
    assert d["emb"] <= bound["emb"] and d["dense"] <= bound["dense"], d
    assert max(d.get(k, 0) for k in ("dev_acc", "host_acc",
                                     "dense_acc")) <= bound["acc"], d
    assert max(rel.values()) <= _rel_bound(kind), rel


@pytest.mark.parametrize("kind", ["sgd", "rowwise_adagrad",
                                  "rowwise_block"])
def test_tiered_steps_match_jax(kind):
    check_tiered_steps(kind)


def check_jax_catches_a_wrong_host_update(monkeypatch, kind, factor, fs=32,
                                          dtype=F32):
    """The port's two-tier step with its change to the host tier's tables
    scaled by ``factor`` (0: the update dropped), against the JAX
    package's steps: the host tier's change breaks its bound, the device
    tier's holds."""
    name = STEPS[kind]
    step = getattr(ht, name)

    def wrong(params, *a, **kw):
        host = params["emb"].host
        before = host.clone()
        loss = step(params, *a, **kw)
        host.copy_(before + factor * (host - before))
        return loss

    monkeypatch.setattr(ht, name, wrong)
    _, _, _, rel = _port_run(kind, fs, dtype)
    assert rel["host-tier tables"] > _rel_bound(kind), rel
    assert rel["device-tier tables"] <= _rel_bound(kind), rel


@pytest.mark.parametrize("factor", [2.0, 0.0])
@pytest.mark.parametrize("kind", ["sgd", "rowwise_adagrad",
                                  "rowwise_block"])
def test_jax_comparison_catches_a_wrong_host_update(monkeypatch, kind,
                                                    factor):
    check_jax_catches_a_wrong_host_update(monkeypatch, kind, factor)


# -- the touched-rows model ---------------------------------------------------

def _tiered(optimizer="rowwise_adagrad", seed=3, fs=32, dtype=F32):
    """The port's tiered parameters drawn into their tiers on the CPU and
    a row-wise state with warm accumulators."""
    tcfg = _cfg(fs, dtype)
    plan = ht.plan_tiers(tcfg, BUDGET)
    tiered = ht.draw_tiered_params(torch.Generator().manual_seed(seed), plan,
                                   tcfg)
    state = ht.init_tiered_opt_state(tiered, config=tcfg,
                                     optimizer=optimizer)
    for a in [state["dev_acc"], state["host_acc"]] + smoke._tensors(
            state["dense"]):
        a.fill_(0.01)
    return tcfg, tiered, state


def check_touched_rows_model(kind, fs=32, dtype=F32):
    """The card's reference on the CPU: the step (or K=4 block) of the two
    tiers against the port's single-device step on the compact model of
    the touched rows, within its bounds for ``dtype`` (f32: 1e-5,
    accumulators 1e-6), and the XOR identity over every whole tier tensor
    exact."""
    tcfg, tiered, state = _tiered(fs=fs, dtype=dtype)
    assert tiered["emb"].host.dtype == dtype
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
    # hot device rows (their allowance a sixteenth of their value): bf16
    # SGD's only, the most-hit rows of the small tables
    assert (set(res["hot"]) == {"device-tier tables"}) == (
        dtype == torch.bfloat16 and kind == "sgd"), res["hot"]
    assert all(v <= smoke.TOUCHED_HOT_REL for v in res["hot"].values())
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
    assert model.params["emb"].dtype == dtype
    assert set(res["diffs"]) <= set(res["bounds"])


@pytest.mark.parametrize("kind", ["sgd", "rowwise_adagrad",
                                  "rowwise_block"])
def test_touched_rows_model_matches_the_tiered_step(kind):
    check_touched_rows_model(kind)


WRONG_UPDATES = [
    ("sgd", "host-tier tables", 2.0),
    ("sgd", "device-tier tables", 2.0),
    ("rowwise_adagrad", "host-tier tables", 1.1),
    ("rowwise_adagrad", "host-tier accumulators", 0.0),
    ("rowwise_adagrad", "device-tier accumulators", 0.0),
    ("rowwise_block", "host-tier tables", 1.1),
]


def check_catches_a_wrong_update(monkeypatch, kind, key, factor, fs=32,
                                 dtype=F32):
    """The two-tier step's change to one tier tensor scaled by ``factor``
    (0: the update dropped) after the step fails the change's bound, and
    only there; the accumulators' changes (about 3e-8 here) lie far below
    their absolute bound, which cannot see it."""
    tcfg, tiered, state = _tiered(fs=fs, dtype=dtype)
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


@pytest.mark.parametrize("kind,key,factor", WRONG_UPDATES)
def test_touched_rows_check_catches_a_wrong_update(monkeypatch, kind, key,
                                                   factor):
    check_catches_a_wrong_update(monkeypatch, kind, key, factor)


def check_catches_a_wrong_hot_update(monkeypatch, factor, fs=32,
                                     dtype=F32):
    """The two-tier SGD step's change to the device-tier rows that the
    touched-rows check calls hot (their rounding allowance at least
    ``chip_smoke.TOUCHED_HOT`` of their value) scaled by ``factor``, and
    nothing else: the hot rows' change breaks its bound, which the
    per-element allowance alone could not see."""
    tcfg, tiered, state = _tiered(fs=fs, dtype=dtype)
    plan = tiered["emb"].plan
    eps = torch.finfo(dtype).eps
    step = ht.tiered_train_step
    scaled = []

    def wrong(params, dense, sparse, labels, **kw):
        dev = params["emb"].dev
        rows = []
        for t, lo in zip(plan.device_tables, plan.device_offsets):
            ids, hits = np.unique(sparse[:, t].numpy(), return_counts=True)
            rows.append(lo + ids[hits * eps >= smoke.TOUCHED_HOT])
        rows = torch.from_numpy(np.concatenate(rows))
        before = dev[rows].clone()
        loss = step(params, dense, sparse, labels, **kw)
        dev[rows] = before + factor * (dev[rows] - before)
        scaled.append(rows.numel())
        return loss

    monkeypatch.setattr(ht, "tiered_train_step", wrong)
    batches = list(batch_stream(tcfg, BATCH, 1, seed=13))
    res = smoke.touched_rows_check(tiered, state, batches, tcfg,
                                   optimizer="sgd", lr=LR, block=False,
                                   device=CPU)
    assert scaled[0] > 0
    assert not res["ok"]
    assert res["hot"]["device-tier tables"] > smoke.TOUCHED_HOT_REL, res
    assert all(res["xor"].values())


def check_flipped_bit(tier, tensor, fs=32, dtype=F32):
    """After a row-wise step, one bit flipped in a row of the tier that the
    step did not touch: the identity of that tensor fails, the others
    hold."""
    tcfg, tiered, state = _tiered(fs=fs, dtype=dtype)
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
    # bit 7 of the row's first word: an f32's mantissa, the first bf16's
    # lowest exponent bit
    stack.view(torch.int32).view(stack.shape[0], -1)[row, 0] ^= 1 << 7
    key = f"{tier}-tier {tensor}"
    after = model.folds()
    xor = smoke.xor_identity(res["folds_before"], after, model.before,
                             model.tier_rows(), CPU)
    assert xor[key] is False
    assert all(v for k, v in xor.items() if k != key)


@pytest.mark.parametrize("tensor", ["tables", "accumulators"])
@pytest.mark.parametrize("tier", ["device", "host"])
def test_xor_identity_catches_one_flipped_bit(tier, tensor):
    check_flipped_bit(tier, tensor)


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
