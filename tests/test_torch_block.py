"""dlrm_tpu_torch's coalesced K-step blocks against dlrm_tpu's:
``train_block`` (SGD) and ``train_block_opt`` (Adagrad, row-wise Adagrad)
against ``make_jit_train_block`` and ``make_jit_train_block_opt``, the
latter under both ``unroll`` values and both ``adagrad_impl`` values.

The same stacked numpy batches and the same JAX-initialised parameters go
through both packages, from zero accumulators and from warm ones.  f32
tolerance after two blocks: 1e-5 on losses, dense parameters and logical
tables, 1e-6 on both accumulators (``test_torch_optim.check_against_jax``
says what holds for Adagrad's weights from a zero accumulator).  Small tables (three
of the five) repeat ids in every micro-batch and must update every
micro-step; big-table ids are drawn either without any repeat across the
block (then the block equals K sequential steps) or with repeats (then a
row takes one update with the summed gradient).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dlrm_tpu
from dlrm_tpu.train.train import (make_jit_train_block,
                                  make_jit_train_block_opt)
import dlrm_tpu_torch
from dlrm_tpu_torch.data.synthetic import random_batch
from dlrm_tpu_torch.ops import embedding as temb
from dlrm_tpu_torch.train import train as ttrain
from test_torch_optim import (BATCH_KEYS, WARM, WARMUP, check_against_jax,
                              lrs, max_diffs, setup, small_config,
                              warm_accumulators)

BATCH = 16


def block_batch(rng, tcfg, k, *, repeats):
    """K stacked batches.  ``repeats`` False: no big-table id occurs twice
    in the block; True: a big-table id of micro-batch 0 comes back in every
    later micro-batch (and twice within micro-batch 0)."""
    bs = [random_batch(rng, tcfg, BATCH) for _ in range(k)]
    out = {key: np.stack([b[key] for b in bs]) for key in BATCH_KEYS}
    _, big = temb.partition_tables(tcfg.table_sizes,
                                   tcfg.small_table_threshold)
    for t in big:
        n = k * BATCH * tcfg.n_hot
        if repeats and tcfg.table_sizes[t] < n:
            continue  # a table this short repeats ids by itself
        ids = rng.permutation(tcfg.table_sizes[t])[:n].astype(np.int32)
        out["sparse"][:, :, t] = ids.reshape(out["sparse"][:, :, t].shape)
        if repeats:
            first = out["sparse"][0, 0, t]
            out["sparse"][0, 1, t] = first
            out["sparse"][1:, 0, t] = first
    return out


def _blocks_both(tcfg, optimizer, *, ks=(2, 2), repeats=True, schedule=None,
                 clip=None, adagrad_impl="dense_g", unroll=True):
    """Blocks of ``ks`` micro-steps through both packages from the same
    start, from zero accumulators and (the Adagrads) from warm ones;
    returns a list of (port losses, JAX losses, max_diffs)."""
    jcfg = setup(tcfg)[0]
    jlr, tlr = lrs(schedule)
    if optimizer == "sgd":
        jblock = make_jit_train_block(jcfg, jlr, grad_clip_norm=clip)
    else:
        kw = dict(optimizer=optimizer, adagrad_impl=adagrad_impl,
                  unroll=unroll, grad_clip_norm=clip)
        jblock = make_jit_train_block_opt(jcfg, lr=jlr, **kw)
        tblock = ttrain.make_train_block_opt(tcfg, lr=tlr, **kw)
    runs = []
    for init_acc in ((0.0,) if optimizer == "sgd" else (0.0, WARM)):
        _, jparams, tparams = setup(tcfg)
        jopt = topt = None
        if optimizer == "sgd":  # a scheduled SGD block counts its own steps
            jblock.step = 0
            tblock = ttrain.make_train_block(tcfg, tlr, grad_clip_norm=clip)
        else:
            jopt = dlrm_tpu.init_opt_state(jparams, config=jcfg,
                                           optimizer=optimizer, lr=jlr)
            topt = ttrain.init_opt_state(tparams, config=tcfg,
                                         optimizer=optimizer)
            if init_acc:
                warm_accumulators(jopt, topt, jcfg, jparams, optimizer,
                                  init_acc)
        rng = np.random.default_rng(0)
        tl, jl = [], []
        for k in ks:
            b = block_batch(rng, tcfg, k, repeats=repeats)
            jb = [jnp.asarray(b[key]) for key in BATCH_KEYS]
            tb = [torch.from_numpy(b[key]) for key in BATCH_KEYS]
            if optimizer == "sgd":
                jparams, losses = jblock(jparams, *jb)
                got = tblock(tparams, *tb)
            else:
                (jparams, jopt), losses = jblock(jparams, jopt, *jb)
                got = tblock(tparams, topt, *tb)
            assert got.shape == (k,) and got.dtype == torch.float32
            jl += [float(x) for x in losses]
            tl += got.tolist()
        runs.append((tl, jl, max_diffs(tparams, topt, jparams, jopt, jcfg,
                                       optimizer)))
    return runs


# the gradient's norm is about 0.26 here, so a clip at 0.05 or 0.1 bites
CASES = {
    # name: (optimizer, config overrides, kwargs of _blocks_both)
    "sgd_disjoint": ("sgd", {}, {"repeats": False}),
    "sgd_repeats_remainder": ("sgd", {}, {"ks": (3, 2)}),
    "sgd_sched": ("sgd", {}, {"schedule": WARMUP}),
    "sgd_clip": ("sgd", {}, {"clip": 0.05}),
    "sgd_3hot_sched_clip": ("sgd", {"n_hot": 3}, {"schedule": WARMUP,
                                                  "clip": 0.05}),
    "adagrad_dense_g_unroll_disjoint": ("adagrad", {}, {"repeats": False}),
    "adagrad_dedup_scan_repeats": ("adagrad", {}, {
        "adagrad_impl": "dedup", "unroll": False}),
    "adagrad_dense_g_scan_sched": ("adagrad", {}, {
        "unroll": False, "schedule": WARMUP}),
    "adagrad_dedup_unroll_clip_remainder": ("adagrad", {}, {
        "adagrad_impl": "dedup", "clip": 0.1, "ks": (3, 2)}),
    "rowwise_dense_g_unroll_repeats": ("rowwise_adagrad", {}, {}),
    "rowwise_dedup_scan_sched_clip": ("rowwise_adagrad", {}, {
        "adagrad_impl": "dedup", "unroll": False, "schedule": WARMUP,
        "clip": 0.1, "repeats": False}),
    "rowwise_dedup_unroll_3hot_sched": ("rowwise_adagrad", {"n_hot": 3}, {
        "adagrad_impl": "dedup", "schedule": WARMUP}),
    "adagrad_all_big": ("adagrad", {"small_table_threshold": 0}, {}),
    "sgd_all_small": ("sgd", {"small_table_threshold": 1 << 20}, {}),
}


@pytest.mark.parametrize("name", list(CASES))
def test_train_block_f32_matches_jax(name):
    optimizer, over, kw = CASES[name]
    check_against_jax(_blocks_both(small_config(**over), optimizer, **kw),
                      optimizer)


def _clone(params):
    return {"bottom": [{k: v.clone() for k, v in l.items()}
                       for l in params["bottom"]],
            "emb": params["emb"].clone(),
            "top": [{k: v.clone() for k, v in l.items()}
                    for l in params["top"]]}


def _block_vs_steps(tcfg, optimizer, k, *, repeats, clip=None, schedule=None):
    """One block of K on one copy, K sequential steps on another; returns
    (block losses, step losses, max |diff| of tables, of dense params, of
    the table accumulator)."""
    _, _, a = setup(tcfg)
    b = _clone(a)
    _, tlr = lrs(schedule)
    data = block_batch(np.random.default_rng(4), tcfg, k, repeats=repeats)
    stacked = [torch.from_numpy(data[key]) for key in BATCH_KEYS]
    oa = ttrain.init_opt_state(a, config=tcfg, optimizer=optimizer)
    ob = ttrain.init_opt_state(b, config=tcfg, optimizer=optimizer)
    if optimizer == "sgd":
        blk = ttrain.make_train_block(tcfg, tlr, grad_clip_norm=clip)(
            a, *stacked)
    else:
        blk = ttrain.train_block_opt(a, oa, *stacked, config=tcfg, lr=tlr,
                                     optimizer=optimizer, grad_clip_norm=clip)
    seq = [float(ttrain.train_step_opt(
        b, ob, *(x[i] for x in stacked), config=tcfg, optimizer=optimizer,
        lr=tlr, grad_clip_norm=clip)) for i in range(k)]
    dense = max((x[key] - y[key]).abs().max().item()
                for part in ("bottom", "top")
                for x, y in zip(a[part], b[part]) for key in ("w", "b"))
    acc = 0.0 if optimizer == "sgd" else \
        (oa["emb"] - ob["emb"]).abs().max().item()
    if optimizer != "sgd":
        assert oa["count"] == ob["count"] == k
    return blk.tolist(), seq, (a["emb"] - b["emb"]).abs().max().item(), \
        dense, acc


@pytest.mark.parametrize("optimizer", ["sgd", "adagrad", "rowwise_adagrad"])
@pytest.mark.parametrize("variant", ["plain", "clip", "sched"])
def test_block_without_repeats_equals_sequential_steps(optimizer, variant):
    """No big-table id repeats across the block: the block is K sequential
    steps (small tables, which do repeat, update every micro-step), up to
    the order of the scatter-adds: 1e-6."""
    kw = {"plain": {}, "clip": {"clip": 0.05},
          "sched": {"schedule": WARMUP}}[variant]
    blk, seq, emb, dense, acc = _block_vs_steps(small_config(), optimizer, 3,
                                                repeats=False, **kw)
    np.testing.assert_allclose(blk, seq, atol=1e-6, rtol=0)
    assert emb <= 1e-6 and dense <= 1e-6 and acc <= 1e-6, (emb, dense, acc)


@pytest.mark.parametrize("optimizer", ["sgd", "adagrad", "rowwise_adagrad"])
def test_block_with_a_repeated_big_id_is_stale(optimizer):
    """A big-table row hit in every micro-batch is read as of block entry:
    later micro-steps see another loss than sequential steps do, and
    Adagrad gives the row one accumulator update with the summed gradient
    ((sum g)^2, not the sum of g^2)."""
    blk, seq, emb, _, acc = _block_vs_steps(small_config(), optimizer, 3,
                                            repeats=True)
    assert blk[0] == seq[0]
    assert abs(blk[2] - seq[2]) > 1e-7
    assert emb > 1e-6
    if optimizer != "sgd":
        assert acc > 1e-8


@pytest.mark.parametrize("optimizer", ["sgd", "adagrad", "rowwise_adagrad"])
def test_block_of_one_equals_the_step_exactly(optimizer):
    blk, seq, emb, dense, acc = _block_vs_steps(small_config(), optimizer, 1,
                                                repeats=True)
    assert blk == seq and emb == dense == acc == 0.0


def test_sgd_block_of_one_equals_train_step_exactly():
    tcfg = small_config()
    _, _, a = setup(tcfg)
    b = _clone(a)
    data = block_batch(np.random.default_rng(5), tcfg, 1, repeats=True)
    la = ttrain.train_block(a, *(torch.from_numpy(data[k])
                                 for k in BATCH_KEYS), config=tcfg, lr=0.1)
    lb = dlrm_tpu_torch.train_step(b, *(torch.from_numpy(data[k][0])
                                        for k in BATCH_KEYS), config=tcfg,
                                   lr=0.1)
    assert float(la[0]) == float(lb) and torch.equal(a["emb"], b["emb"])


def test_scheduled_sgd_block_keeps_and_resumes_its_step():
    tcfg = small_config()
    _, tlr = lrs(WARMUP)
    blk = ttrain.make_train_block(tcfg, tlr)
    assert blk.step == 0
    _, _, p = setup(tcfg)
    data = block_batch(np.random.default_rng(6), tcfg, 3, repeats=False)
    blk(p, *(torch.from_numpy(data[k]) for k in BATCH_KEYS))
    assert blk.step == 3
    blk.step = 10  # resuming
    blk(p, *(torch.from_numpy(data[k][:2]) for k in BATCH_KEYS))
    assert blk.step == 12
    assert not hasattr(ttrain.make_train_block(tcfg, 0.1), "step")


def test_block_opt_refuses_sgd_and_unknown_impls():
    tcfg = small_config()
    _, _, p = setup(tcfg)
    data = block_batch(np.random.default_rng(7), tcfg, 2, repeats=False)
    args = [torch.from_numpy(data[k]) for k in BATCH_KEYS]
    opt = ttrain.init_opt_state(p, config=tcfg, optimizer="adagrad")
    with pytest.raises(ValueError, match="SGD blocks use train_block"):
        ttrain.train_block_opt(p, opt, *args, config=tcfg, lr=0.1,
                               optimizer="sgd")
    with pytest.raises(ValueError, match="unknown adagrad_impl"):
        ttrain.train_block_opt(p, opt, *args, config=tcfg, lr=0.1,
                               adagrad_impl="hybrid")
    assert opt["count"] == 0
