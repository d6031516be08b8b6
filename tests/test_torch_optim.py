"""dlrm_tpu_torch's optimizers against dlrm_tpu's: ``train_step_opt`` under
SGD, Adagrad and row-wise Adagrad, global-norm clipping, schedules, and the
optimizer state carried across by ``io/convert``.

The same numpy batches and the same JAX-initialised parameters go through
both packages; JAX runs on the CPU at ``highest`` matmul precision.  f32
tolerance after 3 steps: 1e-5 on losses, dense parameters and logical
tables, 1e-6 on both accumulators (sums taken in another order; the JAX
package updates small tables through a dense slice, the port through their
hit rows); ``check_against_jax`` says where Adagrad from a zero accumulator
allows no such bound on the weights and what is held there.

Also home of the optimizer-state helpers that test_torch_block.py imports.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dlrm_tpu
from dlrm_tpu.ops.embedding import unpack_tables
from dlrm_tpu.train import optim as joptim
from dlrm_tpu.train.optim import make_schedule as jax_make_schedule
import dlrm_tpu_torch
from dlrm_tpu_torch import config as tc
from dlrm_tpu_torch.data.synthetic import random_batch
from dlrm_tpu_torch.io.convert import (opt_state_from_numpy,
                                       opt_state_to_numpy, params_from_numpy)
from dlrm_tpu_torch.ops import embedding as temb
from dlrm_tpu_torch.train import optim as toptim
from dlrm_tpu_torch.train import train as ttrain
from dlrm_tpu_torch.train.optim import make_schedule
from test_torch_model import jax_config, jax_params_to_numpy

BATCH_KEYS = ("dense", "sparse", "labels")
OPTIMIZERS = ("sgd", "adagrad", "rowwise_adagrad")
WARMUP = {"schedule": "warmup_poly_decay", "warmup_steps": 2,
          "decay_start": 3, "decay_steps": 6}


def small_config(**over) -> tc.DLRMConfig:
    """5 tables, D=8: three small ones (6, 9 and 40 rows, so ids repeat in
    any batch) and two big ones under a threshold of 50."""
    return dataclasses.replace(
        tc.tiny_config(feature_size=8), table_sizes=(6, 300, 9, 2000, 40),
        **{"small_table_threshold": 50, **over})


def setup(tcfg):
    """(JAX config, JAX params, the port's params) from one JAX init."""
    jcfg = jax_config(tcfg)
    jparams = dlrm_tpu.init_params(jax.random.key(7), jcfg)
    tparams = params_from_numpy(jax_params_to_numpy(jparams, jcfg), tcfg)
    return jcfg, jparams, tparams


def lrs(schedule):
    """(JAX lr, port lr): 0.1, or the same schedule over it in both."""
    if schedule is None:
        return 0.1, 0.1
    return (jax_make_schedule(0.1, **schedule),
            make_schedule(0.1, **schedule))


def batch_with_repeats(rng, tcfg, batch):
    """A random batch in which a big-table id surely repeats (the small
    tables' ids repeat by their size)."""
    b = random_batch(rng, tcfg, batch)
    b["sparse"][1, 1] = b["sparse"][0, 1]
    b["sparse"][2, 3] = b["sparse"][0, 3]
    return b


def jax_opt_to_numpy(jopt, jcfg, optimizer) -> dict:
    """The JAX package's optimizer state -> the logical numpy view that
    ``opt_state_from_numpy`` takes."""
    if optimizer == "sgd":
        return {"dense": None, "emb": None, "count": int(jopt["count"])}
    sos = jopt["dense"][0].sum_of_squares
    dense = {part: [{k: np.asarray(layer[k]) for k in ("w", "b")}
                    for layer in sos[part]] for part in ("bottom", "top")}
    acc = jopt["emb"].acc
    if optimizer == "adagrad":
        emb = np.asarray(unpack_tables(acc, jcfg))
    else:  # (chunk_rows, pack) per chunk: one scalar per logical row
        emb = np.concatenate([
            np.asarray(acc[jcfg.table_chunk[t]])[
                jcfg.chunk_table_offsets[t]:jcfg.chunk_table_offsets[t]
                + jcfg.packed_table_rows[t]].reshape(-1)[:jcfg.table_sizes[t]]
            for t in range(jcfg.num_tables)])
    return {"dense": dense, "emb": emb, "count": int(jopt["count"])}


def max_diffs(tparams, topt, jparams, jopt, jcfg, optimizer) -> dict:
    """Max |diff| of logical tables, dense parameters and accumulators."""
    jp = jax_params_to_numpy(jparams, jcfg)
    out = {"emb": np.abs(tparams["emb"].float().numpy()
                         - jp["emb"].astype(np.float32)).max(),
           "dense": max(np.abs(layer[k].numpy() - jl[k]).max()
                        for part in ("bottom", "top")
                        for layer, jl in zip(tparams[part], jp[part])
                        for k in ("w", "b"))}
    if topt is not None:
        want = jax_opt_to_numpy(jopt, jcfg, optimizer)
        got = opt_state_to_numpy(topt)
        assert got["count"] == want["count"]
        if optimizer != "sgd":
            out["emb_acc"] = np.abs(got["emb"] - want["emb"]).max()
            out["dense_acc"] = max(
                np.abs(layer[k] - jl[k]).max()
                for part in ("bottom", "top")
                for layer, jl in zip(got["dense"][part], want["dense"][part])
                for k in ("w", "b"))
    return out


def warm_accumulators(jopt, topt, jcfg, jparams, optimizer, init_acc):
    """Set every accumulator of both states to ``init_acc``."""
    jopt["emb"] = joptim.init_emb_state(jcfg, optimizer, jparams["emb"],
                                        init_acc)
    rss = jopt["dense"][0]
    jopt["dense"] = (rss._replace(sum_of_squares=jax.tree.map(
        lambda a: jnp.full_like(a, init_acc), rss.sum_of_squares)),
        *jopt["dense"][1:])
    for a in [topt["emb"], *temb.tree_leaves(topt["dense"])]:
        a.fill_(init_acc)


def check_against_jax(runs, optimizer):
    """``runs``: the (port losses, JAX losses, max_diffs) of a run from
    zero accumulators and, for the Adagrads, of one from accumulators
    warmed to WARM.

    Losses within 1e-5 and accumulators within 1e-6 always; weights within
    1e-5 under SGD and from warm accumulators.  From a zero accumulator the
    Adagrad step ``lr * g * rsqrt(g^2 + eps)`` turns a difference dg between
    the two packages' f32 gradients into up to ``lr / sqrt(eps) = 1e4 * dg``
    where |g| is near sqrt(eps) = 1e-5: with dg up to 1e-7 the weights are
    held to 1e-3 there (read: up to 1e-4)."""
    for i, (tl, jl, diffs) in enumerate(runs):
        np.testing.assert_allclose(tl, jl, atol=1e-5, rtol=0)
        cold = optimizer != "sgd" and i == 0
        for key, d in diffs.items():
            tol = 1e-6 if key.endswith("_acc") else 1e-3 if cold else 1e-5
            assert d <= tol, (i, key, diffs)


WARM = 0.01


def _steps_both(tcfg, optimizer, *, emb_impl="dedup", clip=None,
                schedule=None, steps=3, batch=32, init_accs=None):
    """``steps`` steps through both packages from the same start, once
    for each initial accumulator value (default: 0, and WARM for the
    Adagrads); returns a list of (port losses, JAX losses, max_diffs)."""
    if init_accs is None:
        init_accs = (0.0,) if optimizer == "sgd" else (0.0, WARM)
    jcfg = jax_config(tcfg)
    jlr, tlr = lrs(schedule)
    jstep = dlrm_tpu.make_jit_train_step_opt(
        jcfg, optimizer=optimizer, lr=jlr, emb_impl=emb_impl,
        grad_clip_norm=clip)
    tstep = dlrm_tpu_torch.make_train_step_opt(
        tcfg, optimizer=optimizer, lr=tlr, emb_impl=emb_impl,
        grad_clip_norm=clip)
    runs = []
    for init_acc in init_accs:
        _, jparams, tparams = setup(tcfg)
        jopt = dlrm_tpu.init_opt_state(jparams, config=jcfg,
                                       optimizer=optimizer, lr=jlr)
        topt = ttrain.init_opt_state(tparams, config=tcfg,
                                     optimizer=optimizer)
        if init_acc:
            warm_accumulators(jopt, topt, jcfg, jparams, optimizer, init_acc)
        rng = np.random.default_rng(0)
        tl, jl = [], []
        for _ in range(steps):
            b = batch_with_repeats(rng, tcfg, batch)
            (jparams, jopt), loss = jstep(jparams, jopt,
                                          *(jnp.asarray(b[k])
                                            for k in BATCH_KEYS))
            jl.append(float(loss))
            tl.append(float(tstep(tparams, topt, *(torch.from_numpy(b[k])
                                                   for k in BATCH_KEYS))))
        runs.append((tl, jl, max_diffs(tparams, topt, jparams, jopt, jcfg,
                                       optimizer)))
    return runs


CASES = {
    # name: (optimizer, config overrides, kwargs of _steps_both)
    "sgd": ("sgd", {}, {}),
    "adagrad_dedup": ("adagrad", {}, {"emb_impl": "dedup"}),
    "adagrad_dense_g": ("adagrad", {}, {"emb_impl": "dense_g"}),
    "adagrad_hybrid": ("adagrad", {}, {"emb_impl": "hybrid"}),
    "rowwise_dedup": ("rowwise_adagrad", {}, {"emb_impl": "dedup"}),
    "rowwise_dense_g": ("rowwise_adagrad", {}, {"emb_impl": "dense_g"}),
    "rowwise_hybrid": ("rowwise_adagrad", {}, {"emb_impl": "hybrid:1"}),
    "sgd_3hot": ("sgd", {"n_hot": 3}, {}),
    "adagrad_3hot": ("adagrad", {"n_hot": 3}, {"emb_impl": "hybrid"}),
    "rowwise_3hot": ("rowwise_adagrad", {"n_hot": 3}, {}),
    "sgd_clip_tight": ("sgd", {}, {"clip": 0.05}),
    "sgd_clip_huge": ("sgd", {}, {"clip": 1e6}),
    "adagrad_clip_tight": ("adagrad", {}, {"clip": 0.05}),
    "adagrad_clip_huge": ("adagrad", {}, {"clip": 1e6}),
    "rowwise_clip_tight": ("rowwise_adagrad", {}, {"clip": 0.05,
                                                   "emb_impl": "dense_g"}),
    "rowwise_clip_huge_3hot": ("rowwise_adagrad", {"n_hot": 3},
                               {"clip": 1e6}),
    "sgd_sched": ("sgd", {}, {"schedule": WARMUP}),
    "adagrad_sched_clip": ("adagrad", {}, {"schedule": WARMUP,
                                           "clip": 0.05}),
    "rowwise_sched": ("rowwise_adagrad", {}, {"schedule": WARMUP}),
    "adagrad_all_big": ("adagrad", {"small_table_threshold": 0},
                        {"clip": 0.05}),
    "rowwise_all_small": ("rowwise_adagrad",
                          {"small_table_threshold": 1 << 20}, {}),
    "adagrad_fused": ("adagrad", {"interaction_impl": "fused"}, {}),
}


@pytest.mark.parametrize("name", list(CASES))
def test_train_step_opt_f32_matches_jax(name):
    """3 steps at B=32 with ids repeating in a big and in every small
    table: losses, tables, dense parameters and both accumulators within
    the limits of ``check_against_jax``.  The port's one Adagrad is held
    to each of the JAX package's three implementations."""
    optimizer, over, kw = CASES[name]
    runs = _steps_both(small_config(**over), optimizer, **kw)
    check_against_jax(runs, optimizer)
    if "clip_tight" in name:  # the clip did bite: see the unclipped losses
        free = _steps_both(small_config(**over), optimizer,
                           **{**kw, "clip": None}, init_accs=(0.0,))
        assert abs(free[0][0][-1] - runs[0][0][-1]) > 1e-4


@pytest.mark.parametrize("optimizer", ["adagrad", "rowwise_adagrad"])
def test_train_step_opt_bf16_tables(optimizer):
    """bf16 tables and compute, from accumulators warmed to 1 on both
    sides (from 0 the first Adagrad step is ``lr * sign(g)``, so a gradient
    entry whose sign is not settled at bf16 precision moves its weight by
    2 * lr: no bound on the weights then).  Both packages round at the same
    places, except that the JAX package subtracts a small table's step as a
    whole slice (``table - lr * step.astype(bf16)``) where the port adds
    ``(-lr * step).astype(bf16)`` on the hit rows, and an activation may
    round to its neighbouring bf16 value.  A table entry may land a bf16
    step or two away (2^-8 relative, entries up to 1/sqrt(6)): tables
    within 1e-2, dense parameters within 2e-3, losses within 1e-3, the
    f32 accumulators within 1e-3."""
    (tl, jl, diffs), = _steps_both(
        small_config(compute_dtype=torch.bfloat16,
                     embedding_dtype=torch.bfloat16), optimizer,
        init_accs=(1.0,))
    np.testing.assert_allclose(tl, jl, atol=1e-3, rtol=0)
    assert diffs["emb"] <= 1e-2 and diffs["dense"] <= 2e-3, diffs
    assert diffs["emb_acc"] <= 1e-3 and diffs["dense_acc"] <= 1e-3, diffs


@pytest.mark.parametrize("n_hot", [1, 3])
def test_sgd_opt_step_equals_train_step_exactly(n_hot):
    tcfg = small_config(n_hot=n_hot)
    _, _, a = setup(tcfg)
    _, _, b = setup(tcfg)
    opt = ttrain.init_opt_state(b, config=tcfg, optimizer="sgd")
    assert opt == {"dense": None, "emb": None, "count": 0}
    rng = np.random.default_rng(3)
    for i in range(3):
        batch = [torch.from_numpy(v) for v in
                 (batch_with_repeats(rng, tcfg, 32)[k] for k in BATCH_KEYS)]
        la = dlrm_tpu_torch.train_step(a, *batch, config=tcfg, lr=0.1)
        lb = dlrm_tpu_torch.train_step_opt(b, opt, *batch, config=tcfg,
                                           optimizer="sgd", lr=0.1)
        assert float(la) == float(lb) and opt["count"] == i + 1
    assert torch.equal(a["emb"], b["emb"])
    for part in ("bottom", "top"):
        for x, y in zip(a[part], b[part]):
            assert torch.equal(x["w"], y["w"]) and torch.equal(x["b"], y["b"])


def test_clip_norm_counts_small_tables_per_row_and_big_per_hit(rng):
    """One row hit twice with gradients g1, g2: a small table adds
    |g1 + g2|^2 to the squared norm, a big table |g1|^2 + |g2|^2."""
    tcfg = small_config()
    jcfg, jparams, tparams = setup(tcfg)
    b = batch_with_repeats(rng, tcfg, 16)
    dp, emb = {"bottom": tparams["bottom"], "top": tparams["top"]}, \
        tparams["emb"]
    _, (dg, sg) = temb.sparse_value_and_grad(
        functools.partial(ttrain._loss, config=tcfg))(
        dp, emb, torch.from_numpy(b["sparse"]), tcfg.table_offsets,
        torch.from_numpy(b["dense"]), torch.from_numpy(b["labels"]))
    small, big = temb.partition_tables(tcfg.table_sizes, 50)
    g_big = temb.split_by_tables(sg, 16, 5, big)
    g_small = temb.sum_duplicates(temb.split_by_tables(sg, 16, 5, small))
    assert g_small.ids.unique().numel() == g_small.ids.numel() < 16 * 3
    want = np.sqrt(sum(float(g.square().sum()) for g in temb.tree_leaves(dg))
                   + float(g_big.rows.square().sum())
                   + float(g_small.rows.square().sum()))
    clipped, gnorm = toptim.clip_by_global_norm(
        0.5 * want, temb.tree_leaves(dg) + [g_big.rows, g_small.rows])
    np.testing.assert_allclose(float(gnorm), want, rtol=1e-6)
    np.testing.assert_allclose(clipped[-1].numpy(),
                               0.5 * g_small.rows.numpy(), rtol=1e-6)
    # and against the JAX package's clip over its own pytree
    from dlrm_tpu.train.optim import clip_by_global_norm as jclip
    dense_small = temb.uncompress(g_small, tcfg.total_rows, 8).numpy()
    _, jnorm = jclip(0.5 * want, ([jnp.asarray(g.numpy())
                                   for g in temb.tree_leaves(dg)],
                                  jnp.asarray(g_big.rows.numpy()),
                                  jnp.asarray(dense_small)))
    np.testing.assert_allclose(float(gnorm), float(jnorm), rtol=1e-6)
    # a norm below max_norm leaves the gradients alone
    same, _ = toptim.clip_by_global_norm(2 * want, [g_big.rows])
    assert torch.equal(same[0], g_big.rows)


@pytest.mark.parametrize("rowwise", [False, True])
def test_small_table_adagrad_bf16_rounding_bound(rowwise, rng):
    """The same f32 gradient into the JAX package's dense small-table
    Adagrad and the port's update of the hit rows, on a bf16 table: the JAX
    side rounds the step to bf16, multiplies by lr in bf16 and subtracts;
    the port rounds ``-lr * step`` once and adds.  The updates differ by at
    most 2 bf16 steps of an update (|update| <= lr = 0.1: 2 * 2^-11), and
    the sum rounds once on both sides (entries below 0.5: 2^-9), so entries
    agree within 3e-3.  Rows without a hit keep their bits."""
    table = (rng.uniform(-0.4, 0.4, size=(6, 8))).astype(np.float32)
    g = rng.normal(size=(6, 8)).astype(np.float32) * 0.05
    g[[1, 4]] = 0.0
    acc = np.abs(rng.normal(size=(6,) if rowwise else (6, 8))
                 ).astype(np.float32) * 0.01
    jfn = (joptim.apply_rowwise_adagrad_dense_table if rowwise
           else joptim.apply_adagrad_dense_table)
    jt, jacc = jfn(jnp.asarray(table, jnp.bfloat16), jnp.asarray(acc),
                   jnp.asarray(g), jnp.float32(0.1))
    emb = torch.from_numpy(table).bfloat16()
    tacc = torch.from_numpy(acc.copy())
    hit = torch.tensor([0, 2, 3, 5], dtype=torch.int32)
    toptim.apply_adagrad_rows(emb, tacc, hit, torch.from_numpy(g)[hit.long()],
                              0.1, rowwise=rowwise)
    np.testing.assert_allclose(tacc.numpy(), np.asarray(jacc), rtol=1e-6)
    got = emb.float().numpy()
    assert np.abs(got - np.asarray(jt).astype(np.float32)).max() <= 3e-3
    start = torch.from_numpy(table).bfloat16().float().numpy()
    assert (got[[1, 4]] == start[[1, 4]]).all()
    assert np.abs(got[[0, 2]] - start[[0, 2]]).max() > 1e-2


def test_dense_adagrad_is_rsqrt_of_acc_plus_eps():
    """optax.scale_by_rss: ``g * rsqrt(acc + eps)`` with eps 1e-10 inside
    the root, and a zero step where the accumulator is zero."""
    import optax
    g = np.array([0.0, 1e-6, -3e-5, 0.5], np.float32)
    p = torch.zeros(4)
    acc = torch.zeros(4)
    toptim.apply_dense("adagrad", [p], [torch.from_numpy(g)], [acc], 0.1)
    tx = optax.adagrad(0.1, initial_accumulator_value=0.0, eps=1e-10)
    upd, state = tx.update(jnp.asarray(g), tx.init(jnp.zeros(4)))
    np.testing.assert_allclose(p.numpy(), np.asarray(upd), rtol=1e-6, atol=0)
    np.testing.assert_allclose(acc.numpy(),
                               np.asarray(state[0].sum_of_squares), rtol=1e-7)
    assert p[0] == 0 and acc[0] == 0
    # 1 / (sqrt(acc) + eps) would give -0.1 exactly at g = 1e-6
    assert abs(float(p[1]) + 0.1) > 1e-4


@pytest.mark.parametrize("rowwise", [False, True])
def test_apply_sparse_adagrad_dedups_then_applies(rowwise, rng):
    """A row hit three times: one accumulator update with the summed
    gradient; untouched rows and their accumulators keep their bits."""
    emb0 = rng.normal(size=(9, 4)).astype(np.float32)
    acc0 = np.abs(rng.normal(size=(9, 4) if not rowwise else (9,))
                  ).astype(np.float32)
    ids = np.array([2, 7, 2, 2, 5], np.int32)
    g = rng.normal(size=(5, 4)).astype(np.float32)
    emb, acc = torch.from_numpy(emb0.copy()), torch.from_numpy(acc0.copy())
    toptim.apply_sparse_adagrad(
        emb, acc, temb.SparseGrad(torch.from_numpy(ids), torch.from_numpy(g)),
        0.3, rowwise=rowwise)
    for r in range(9):
        gs = g[ids == r].sum(axis=0)
        if not (ids == r).any():
            assert (emb[r].numpy() == emb0[r]).all()
            assert (acc[r].numpy() == acc0[r]).all()
            continue
        a = acc0[r] + (np.mean(gs * gs) if rowwise else gs * gs)
        np.testing.assert_allclose(acc[r].numpy(), a, rtol=1e-6)
        np.testing.assert_allclose(emb[r].numpy(),
                                   emb0[r] - 0.3 * gs / np.sqrt(a + 1e-10),
                                   rtol=1e-5, atol=1e-7)


def test_apply_sparse_adagrad_twin_payload(rng):
    """``scaled_rows``: the accumulator takes (sum g)^2, the weights take
    sum(lr_k g) * rsqrt(...), and lr is not used."""
    ids = torch.tensor([1, 3, 1])
    g = torch.from_numpy(rng.normal(size=(3, 4)).astype(np.float32))
    lr_k = torch.tensor([0.5, 0.2, 0.1])[:, None]
    emb, acc = torch.zeros(5, 4), torch.zeros(5, 4)
    toptim.apply_sparse_adagrad(emb, acc, temb.SparseGrad(ids, g), 123.0,
                                rowwise=False, scaled_rows=g * lr_k)
    gs = g[0] + g[2]
    torch.testing.assert_close(acc[1], gs * gs)
    torch.testing.assert_close(
        emb[1], -(0.5 * g[0] + 0.1 * g[2]) * torch.rsqrt(gs * gs + 1e-10))
    torch.testing.assert_close(emb[3], -0.2 * g[1] / g[1].abs(), rtol=1e-5,
                               atol=1e-6)


def test_init_state_shapes_and_checks():
    tcfg = small_config()
    _, _, p = setup(tcfg)
    for optimizer, shape in (("adagrad", (tcfg.total_rows, 8)),
                             ("rowwise_adagrad", (tcfg.total_rows,))):
        st = dlrm_tpu_torch.init_opt_state(p, config=tcfg,
                                           optimizer=optimizer)
        assert st["emb"].shape == shape and st["emb"].dtype == torch.float32
        assert st["count"] == 0 and not st["emb"].any()
        assert [a.shape for a in temb.tree_leaves(st["dense"])] == \
            [q.shape for q in temb.tree_leaves({"bottom": p["bottom"],
                                                "top": p["top"]})]
    with pytest.raises(ValueError, match="unknown optimizer"):
        dlrm_tpu_torch.init_opt_state(p, config=tcfg, optimizer="adam")
    for ok in ("dedup", "dense_g", "hybrid", "hybrid:150"):
        toptim.check_emb_impl(ok)
    for bad in ("sorted", "hybrid:", "hybrid:x", "dense"):
        with pytest.raises(ValueError, match="unknown emb_impl"):
            toptim.check_emb_impl(bad)


@pytest.mark.parametrize("optimizer", OPTIMIZERS)
def test_opt_state_round_trip_and_handoff_from_jax(optimizer):
    """A state taken from the JAX package after 2 steps continues in the
    port to the same third step; from_numpy / to_numpy round-trip."""
    tcfg = small_config()
    jcfg, jparams, _ = setup(tcfg)
    jlr, tlr = lrs(WARMUP)
    jopt = dlrm_tpu.init_opt_state(jparams, config=jcfg, optimizer=optimizer,
                                   lr=jlr)
    jstep = dlrm_tpu.make_jit_train_step_opt(jcfg, optimizer=optimizer,
                                             lr=jlr, emb_impl="hybrid")
    rng = np.random.default_rng(1)
    batches = [batch_with_repeats(rng, tcfg, 32) for _ in range(3)]
    for b in batches[:2]:
        (jparams, jopt), _ = jstep(jparams, jopt, *(jnp.asarray(b[k])
                                                    for k in BATCH_KEYS))
    np_opt = jax_opt_to_numpy(jopt, jcfg, optimizer)
    tparams = params_from_numpy(jax_params_to_numpy(jparams, jcfg), tcfg)
    topt = opt_state_from_numpy(np_opt, tcfg, optimizer)
    assert topt["count"] == 2
    back = opt_state_to_numpy(topt)
    assert back["count"] == 2
    if optimizer != "sgd":
        np.testing.assert_array_equal(back["emb"], np_opt["emb"])
        for part in ("bottom", "top"):
            for x, y in zip(back["dense"][part], np_opt["dense"][part]):
                np.testing.assert_array_equal(x["w"], y["w"])
                np.testing.assert_array_equal(x["b"], y["b"])
    else:
        assert back["dense"] is None and back["emb"] is None
    b = batches[2]
    (jparams, jopt), jloss = jstep(jparams, jopt, *(jnp.asarray(b[k])
                                                    for k in BATCH_KEYS))
    tloss = dlrm_tpu_torch.train_step_opt(
        tparams, topt, *(torch.from_numpy(b[k]) for k in BATCH_KEYS),
        config=tcfg, optimizer=optimizer, lr=tlr)
    np.testing.assert_allclose(float(tloss), float(jloss), atol=1e-6)
    diffs = max_diffs(tparams, topt, jparams, jopt, jcfg, optimizer)
    assert all(d <= 1e-5 for d in diffs.values()), diffs


def test_opt_state_from_numpy_checks_shapes():
    tcfg = small_config()
    _, _, p = setup(tcfg)
    good = opt_state_to_numpy(ttrain.init_opt_state(
        p, config=tcfg, optimizer="rowwise_adagrad"))
    with pytest.raises(ValueError, match="emb accumulator"):
        opt_state_from_numpy(good, tcfg, "adagrad")
    bad = {**good, "dense": {"bottom": good["dense"]["bottom"][:1],
                             "top": good["dense"]["top"]}}
    with pytest.raises(ValueError, match="dense.bottom"):
        opt_state_from_numpy(bad, tcfg, "rowwise_adagrad")
