"""dlrm_tpu_torch.parallel.host_tier against dlrm_tpu.parallel.host_tier on
the CPU: the tier plan, the split and merge, the lookup and forward, the SGD
step, blocks and the pipelined step, Adagrad and row-wise Adagrad steps and
blocks, remat, an all-host plan and bf16 tables.

Both packages start from one JAX-initialised state: the JAX package's
tiered parameters and optimizer state (its device tier unpacked to the
logical stack) carried over by ``io/convert``.  The port keeps its host
tier in plain host memory here, and its kernels' plain versions run.
Tolerances: losses and weights 1e-5, accumulators 1e-6 (weights 1e-3 from
a zero Adagrad accumulator, ROADMAP.md §3); the lookup 1e-6.  The port
sums a host row's hits in f32 and adds them once where JAX scatter-adds
each hit, which moves the last bits only.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dlrm_tpu
from dlrm_tpu.data import synthetic as jsynth
from dlrm_tpu.ops import embedding as jemb
from dlrm_tpu.parallel import host_tier as jht
import dlrm_tpu_torch
from dlrm_tpu_torch import config as tc
from dlrm_tpu_torch.io import convert
from dlrm_tpu_torch.parallel import host_tier as ht
from test_torch_model import jax_config

KEYS = ("dense", "sparse", "labels")
SIZES = (64, 1000, 16, 2048, 128, 512)
BUDGET = 210 * 8 * 4          # tables 0, 2 and 4 on the device (f32)
WARM = 0.01


def _cfg(n_hot=1, **kw):
    """The JAX package's two-tier test model: 6 tables of 16 to 2048 rows,
    D=8; under a threshold of 100 the device tier has small and big
    tables."""
    return dataclasses.replace(tc.tiny_config(num_tables=6, feature_size=8,
                                              n_hot=n_hot),
                               table_sizes=SIZES, small_table_threshold=100,
                               **kw)


def _start(tcfg, budget=BUDGET, seed=0):
    """(JAX config, JAX plan, JAX tiered params, the port's tiered params)
    from one JAX init."""
    jcfg = dataclasses.replace(jax_config(tcfg), remat=tcfg.remat)
    jparams = dlrm_tpu.init_params(jax.random.key(seed), jcfg)
    jplan = jht.plan_tiers(jcfg, budget)
    jt = jht.init_tiered_params(jax.tree.map(np.asarray, jparams), jplan,
                                jcfg)
    plan = ht.plan_tiers(tcfg, budget)
    tp = convert.tiered_params_from_numpy(_jax_tiered_np(jt, jplan, jcfg),
                                          plan, tcfg)
    return jcfg, jplan, jt, tp


def _jax_dev_logical(chunks, jplan, jcfg, rowwise=False):
    """The JAX device tier's engine chunks (or per-chunk accumulators) as
    the logical (R_dev, D) stack (row-wise: (R_dev,))."""
    dev_cfg = jht.device_subconfig(jplan, jcfg)
    if dev_cfg is None:
        return np.zeros((0,) if rowwise else (0, jcfg.feature_size),
                        np.float32)
    chunks = tuple(np.asarray(c) for c in chunks)
    if not rowwise:
        return np.asarray(jemb.unpack_tables(chunks, dev_cfg), np.float32)
    return np.concatenate([
        chunks[dev_cfg.table_chunk[t]][
            dev_cfg.chunk_table_offsets[t]:dev_cfg.chunk_table_offsets[t]
            + dev_cfg.packed_table_rows[t]].reshape(-1)[
                :dev_cfg.table_sizes[t]]
        for t in range(dev_cfg.num_tables)])


def _jax_tiered_np(jt, jplan, jcfg) -> dict:
    mlp = lambda ls: [{k: np.asarray(l[k]) for k in ("w", "b")} for l in ls]
    return {"bottom": mlp(jt["bottom"]), "top": mlp(jt["top"]),
            "emb_dev": _jax_dev_logical(jt["emb_dev"], jplan, jcfg),
            "emb_host": np.asarray(jt["emb_host"], np.float32)}


def _jax_opt_np(jopt, jplan, jcfg, optimizer) -> dict:
    out = {"count": int(jopt["count"]), "dense": None, "dev_acc": None,
           "host_acc": None}
    if optimizer != "sgd":
        sos = jopt["dense"][0].sum_of_squares
        out["dense"] = {p: [{k: np.asarray(l[k]) for k in ("w", "b")}
                            for l in sos[p]] for p in ("bottom", "top")}
        out["dev_acc"] = _jax_dev_logical(jopt["dev_acc"], jplan, jcfg,
                                          optimizer == "rowwise_adagrad")
        out["host_acc"] = np.asarray(jopt["host_acc"])
    return out


def _warm_jax(jopt):
    """Every accumulator WARM, each left in its memory space (the host
    tier's in pinned host memory)."""
    return jax.tree.map(
        lambda a: (jax.device_put(np.full(a.shape, WARM, np.float32),
                                  a.sharding)
                   if jnp.issubdtype(a.dtype, jnp.floating) else a), jopt)


def _opt_states(tcfg, jcfg, jplan, jt, tp, optimizer, warm, jlr=0.1):
    jopt = jht.init_tiered_opt_state(jt, config=jcfg, optimizer=optimizer,
                                     lr=jlr, plan=jplan)
    if warm:
        jopt = _warm_jax(jopt)
    topt = convert.tiered_opt_state_from_numpy(
        _jax_opt_np(jopt, jplan, jcfg, optimizer), tp["emb"].plan, tcfg,
        optimizer)
    return jopt, topt


def _diffs(tp, jt, jplan, jcfg, topt=None, jopt=None, optimizer="sgd"):
    """Max |diff| of the merged tables, the dense parameters and (with an
    optimizer state) the accumulators of both tiers."""
    emb = tp["emb"]
    got = ht.merge_tiers(emb.dev, emb.host, emb.plan, jcfg)
    want = jht.merge_tiers(jt["emb_dev"], jt["emb_host"], jplan, jcfg)
    out = {"emb": float(np.abs(got.float().numpy()
                               - np.asarray(want, np.float32)).max()),
           "dense": max(float(np.abs(l[k].float().numpy()
                                     - np.asarray(jl[k], np.float32)).max())
                        for p in ("bottom", "top")
                        for l, jl in zip(tp[p], jt[p]) for k in ("w", "b"))}
    if topt is not None and optimizer != "sgd":
        want = _jax_opt_np(jopt, jplan, jcfg, optimizer)
        assert topt["count"] == want["count"]
        out["dev_acc"] = float(np.abs(topt["dev_acc"].numpy()
                                      - want["dev_acc"]).max(initial=0))
        out["host_acc"] = float(np.abs(topt["host_acc"].numpy().reshape(-1)
                                       - want["host_acc"]).max(initial=0))
        out["dense_acc"] = max(
            float(np.abs(l[k].numpy() - jl[k]).max())
            for p in ("bottom", "top")
            for l, jl in zip(topt["dense"][p], want["dense"][p])
            for k in ("w", "b"))
    return out


def _batches(tcfg, n, rng, b=32, repeats=True):
    out = [jsynth.random_batch(rng, tcfg, b) for _ in range(n)]
    if repeats:  # a host row and a device row hit twice in every batch
        for x in out:
            x["sparse"][1] = x["sparse"][0]
    return out


def _disjoint(tcfg, k, rng, b=32):
    """K micro-batches in which no table's id occurs in two of them."""
    sparse = np.stack([np.stack(
        [rng.integers(i * (s // k), (i + 1) * (s // k),
                      size=(b,) if tcfg.n_hot == 1 else (b, tcfg.n_hot))
         for s in tcfg.table_sizes], axis=1)
        for i in range(k)]).astype(np.int32)
    return {"dense": rng.normal(size=(k, b, 13)).astype(np.float32),
            "sparse": sparse,
            "labels": (rng.random((k, b)) > 0.5).astype(np.float32)}


def _j(b):
    return [jnp.asarray(b[k]) for k in KEYS]


def _t(b):
    return [torch.from_numpy(np.asarray(b[k])) for k in KEYS]


# -- the plan, the split, the lookup ------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_plan_tiers_matches_jax(dtype):
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    tcfg = _cfg(embedding_dtype=tdt)
    jcfg = jax_config(tcfg)
    row = 8 * tdt.itemsize
    budgets = [None, 0, 1, 16 * row, 79 * row, 80 * row, 208 * row,
               210 * row, 1000 * row, sum(SIZES) * row, 10 ** 9]
    for budget in budgets:
        want, got = jht.plan_tiers(jcfg, budget), ht.plan_tiers(tcfg, budget)
        assert (got.device_tables, got.host_tables, got.device_offsets,
                got.host_offsets, got.device_rows, got.host_rows) == (
            want.device_tables, want.host_tables, want.device_offsets,
            want.host_offsets, want.device_rows, want.host_rows), budget
    kaggle = tc.kaggle_config(feature_size=128, embedding_dtype=tdt)
    plan = ht.plan_tiers(kaggle, 4 * ht.GIB)
    assert plan.host_tables == jht.plan_tiers(jax_config(kaggle),
                                              4 * ht.GIB).host_tables
    if dtype == "f32":
        assert plan.host_tables == (2, 11, 20)
        assert plan.host_rows == 25_529_367


def test_split_merge_round_trip_and_subconfig():
    tcfg = _cfg()
    emb = dlrm_tpu_torch.init_params(torch.Generator().manual_seed(1),
                                     tcfg)["emb"]
    plan = ht.plan_tiers(tcfg, BUDGET)
    dev, host = ht.split_tiers(emb, plan, tcfg)
    assert dev.shape == (plan.device_rows, 8) and host.shape == (
        plan.host_rows, 8)
    assert torch.equal(ht.merge_tiers(dev, host, plan, tcfg), emb)
    sub = ht.device_subconfig(plan, tcfg)
    assert sub.table_sizes == (64, 16, 128)
    assert ht.device_subconfig(ht.plan_tiers(tcfg, 0), tcfg) is None
    jcfg = jax_config(tcfg)
    jplan = jht.plan_tiers(jcfg, BUDGET)
    assert jht.device_subconfig(jplan, jcfg).table_sizes == sub.table_sizes


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("chunk", [7, 1 << 20])
def test_init_draws_the_whole_stack_bits(monkeypatch, dtype, chunk):
    """init_params draws its tables a chunk at a time: the same bits as one
    U(-1, 1) draw of the whole stack scaled table by table, at any chunk
    size (the CPU generator draws element by element)."""
    from dlrm_tpu_torch.models import dlrm as model

    monkeypatch.setattr(model, "INIT_CHUNK_ROWS", chunk)
    tcfg = _cfg(embedding_dtype=dtype)
    got = dlrm_tpu_torch.init_params(torch.Generator().manual_seed(5), tcfg)
    g = torch.Generator().manual_seed(5)
    model.init_dense(g, tcfg, torch.device("cpu"))
    want = torch.empty((tcfg.total_rows, 8), dtype=dtype)
    want.uniform_(-1.0, 1.0, generator=g)
    for t, n in enumerate(tcfg.table_sizes):
        want[tcfg.table_offsets[t]:tcfg.table_offsets[t] + n].mul_(n ** -0.5)
    assert torch.equal(got["emb"], want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("budget", [0, BUDGET, 10 ** 9])
def test_draw_tiered_params_is_the_split_init(monkeypatch, dtype, budget):
    """Tiered parameters drawn straight into their tiers (all-host, mixed,
    all-device) equal the all-device init split into them, bit for bit,
    and take the zeros init too."""
    from dlrm_tpu_torch.models import dlrm as model

    monkeypatch.setattr(model, "INIT_CHUNK_ROWS", 100)
    tcfg = _cfg(embedding_dtype=dtype)
    plan = ht.plan_tiers(tcfg, budget)
    for init in ("scaled_uniform", "zeros"):
        got = ht.draw_tiered_params(torch.Generator().manual_seed(3), plan,
                                    tcfg, emb_init=init)
        want = ht.init_tiered_params(dlrm_tpu_torch.init_params(
            torch.Generator().manual_seed(3), tcfg, emb_init=init), plan,
            tcfg)
        ht.check_tiered_storage(got["emb"], tcfg)
        for a, b in ((got["emb"].dev, want["emb"].dev),
                     (got["emb"].host, want["emb"].host)):
            assert a.dtype == dtype and torch.equal(a, b)
        for p in ("bottom", "top"):
            for a, b in zip(got[p], want[p]):
                assert torch.equal(a["w"], b["w"])
                assert torch.equal(a["b"], b["b"])


@pytest.mark.parametrize("n_hot", [1, 3])
def test_tiered_lookup_and_forward_match_jax(n_hot):
    tcfg = _cfg(n_hot=n_hot)
    jcfg, jplan, jt, tp = _start(tcfg)
    b = jsynth.random_batch(np.random.default_rng(2), jcfg, 32)
    want = jax.jit(lambda d, h, s: jht.tiered_lookup(d, h, s, jplan, jcfg))(
        jt["emb_dev"], jt["emb_host"], jnp.asarray(b["sparse"]))
    got = ht.tiered_lookup(tp["emb"], torch.from_numpy(b["sparse"]), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)
    # the forward on TieredEmb against JAX's forward of the merged tables
    merged = jht.merge_tiers(jt["emb_dev"], jt["emb_host"], jplan, jcfg)
    jparams = {"bottom": jt["bottom"], "top": jt["top"],
               "emb": jax.tree.map(jnp.asarray,
                                   jemb.pack_tables(merged, jcfg))}
    want = dlrm_tpu.forward(jparams, jnp.asarray(b["dense"]),
                            jnp.asarray(b["sparse"]), jcfg)
    with torch.inference_mode():
        got = dlrm_tpu_torch.forward(tp, torch.from_numpy(b["dense"]),
                                     torch.from_numpy(b["sparse"]), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)


# -- SGD ----------------------------------------------------------------------

@pytest.mark.parametrize("n_hot", [1, 2])
def test_tiered_train_step_matches_jax(n_hot):
    """3 SGD steps, duplicate ids in both tiers in every batch."""
    tcfg = _cfg(n_hot=n_hot)
    jcfg, jplan, jt, tp = _start(tcfg)
    jstep = jht.make_tiered_train_step(jcfg, 0.1, jplan)
    tl, jl = [], []
    for b in _batches(tcfg, 3, np.random.default_rng(3)):
        jt, loss = jstep(jt, *_j(b))
        jl.append(float(loss))
        tl.append(float(ht.tiered_train_step(tp, *_t(b), config=tcfg,
                                             lr=0.1)))
    np.testing.assert_allclose(tl, jl, atol=1e-5, rtol=0)
    d = _diffs(tp, jt, jplan, jcfg)
    assert max(d.values()) <= 1e-5, d


@pytest.mark.parametrize("k", [1, 2, 4])
def test_tiered_block_matches_jax_and_steps(k):
    """A K-step block on micro-batches with no id repeated across them
    against the JAX package's block and against K of the port's steps."""
    tcfg = _cfg()
    jcfg, jplan, jt, tp = _start(tcfg)
    blk = _disjoint(tcfg, k, np.random.default_rng(8))
    jt, jlosses = jht.make_tiered_train_block(jcfg, 0.1, jplan)(jt, *_j(blk))
    seq = _start(tcfg)[3]
    losses = ht.tiered_train_block(tp, *_t(blk), config=tcfg, lr=0.1)
    seq_losses = [float(ht.tiered_train_step(
        seq, *(t[i] for t in _t(blk)), config=tcfg, lr=0.1))
        for i in range(k)]
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(losses.numpy(), seq_losses, atol=1e-6, rtol=0)
    d = _diffs(tp, jt, jplan, jcfg)
    assert max(d.values()) <= 1e-5, d
    for a, b in ((tp["emb"].dev, seq["emb"].dev),
                 (tp["emb"].host, seq["emb"].host)):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


def test_pipelined_matches_jax_and_the_inline_step():
    """5 pipelined steps, each batch re-reading rows the previous step
    updated: equal bits to the port's inline steps (the CPU sums in one
    order), and the JAX package's pipelined steps within 1e-5."""
    tcfg = _cfg()
    jcfg, jplan, jt, tp = _start(tcfg, seed=13)
    inline = _start(tcfg, seed=13)[3]
    batches = _batches(tcfg, 5, np.random.default_rng(17), repeats=False)
    for a, b in zip(batches, batches[1:]):
        b["sparse"][:4] = a["sparse"][:4]
    pstep = jht.make_tiered_pipelined_step(jcfg, 0.4, jplan)
    jpref = jht.prime_host_prefetch(jt["emb_host"],
                                    jnp.asarray(batches[0]["sparse"]), jplan)
    pref = ht.prime_host_prefetch(tp["emb"],
                                  torch.from_numpy(batches[0]["sparse"]))
    tl, jl, il = [], [], []
    for i, b in enumerate(batches):
        nxt = batches[min(i + 1, len(batches) - 1)]["sparse"]
        (jt, jpref), loss = pstep(jt, jpref, *_j(b), jnp.asarray(nxt))
        jl.append(float(loss))
        pref, loss = ht.tiered_train_step_pipelined(
            tp, pref, *_t(b), torch.from_numpy(nxt), config=tcfg, lr=0.4)
        tl.append(float(loss))
        il.append(float(ht.tiered_train_step(inline, *_t(b), config=tcfg,
                                             lr=0.4)))
    assert tl == il
    assert torch.equal(tp["emb"].dev, inline["emb"].dev)
    assert torch.equal(tp["emb"].host, inline["emb"].host)
    for p in ("bottom", "top"):
        for a, b in zip(tp[p], inline[p]):
            assert torch.equal(a["w"], b["w"]) and torch.equal(a["b"], b["b"])
    np.testing.assert_allclose(tl, jl, atol=1e-5, rtol=0)
    d = _diffs(tp, jt, jplan, jcfg)
    assert max(d.values()) <= 1e-5, d


def test_remat_is_the_same_step():
    """config.remat covers the tiered step too: the same loss and tables,
    bit for bit."""
    runs = []
    for remat in (False, True):
        tcfg = _cfg(remat=remat)
        tp = _start(tcfg)[3]
        b = _batches(tcfg, 1, np.random.default_rng(4))[0]
        loss = ht.tiered_train_step(tp, *_t(b), config=tcfg, lr=0.1)
        runs.append((float(loss), tp["emb"].dev.clone(),
                     tp["emb"].host.clone()))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1:], runs[1][1:]))


def test_all_host_plan_matches_jax():
    """Every table in the host tier: 3 steps against the JAX package's, the
    host tier moved."""
    tcfg = _cfg()
    jcfg, jplan, jt, tp = _start(tcfg, budget=0)
    assert tp["emb"].plan.device_tables == () and tp["emb"].dev.shape[0] == 0
    host0 = tp["emb"].host.clone()
    jstep = jht.make_tiered_train_step(jcfg, 0.1, jplan)
    tl, jl = [], []
    for b in _batches(tcfg, 3, np.random.default_rng(5)):
        jt, loss = jstep(jt, *_j(b))
        jl.append(float(loss))
        tl.append(float(ht.tiered_train_step(tp, *_t(b), config=tcfg,
                                             lr=0.1)))
    np.testing.assert_allclose(tl, jl, atol=1e-5, rtol=0)
    assert not torch.equal(tp["emb"].host, host0)
    d = _diffs(tp, jt, jplan, jcfg)
    assert max(d.values()) <= 1e-5, d


def test_bf16_tables_match_jax():
    """bf16 tables and compute, 3 steps: the bound of
    ``test_torch_train.test_train_step_bf16_matches_jax`` (a host row's
    update is rounded once here, per hit there)."""
    tcfg = _cfg(embedding_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)
    budget = 210 * 8 * 2
    jcfg, jplan, jt, tp = _start(tcfg, budget=budget)
    assert tp["emb"].host.dtype == torch.bfloat16
    assert tp["emb"].plan.host_tables
    jstep = jht.make_tiered_train_step(jcfg, 0.1, jplan)
    tl, jl = [], []
    for b in _batches(tcfg, 3, np.random.default_rng(6)):
        jt, loss = jstep(jt, *_j(b))
        jl.append(float(loss))
        tl.append(float(ht.tiered_train_step(tp, *_t(b), config=tcfg,
                                             lr=0.1)))
    np.testing.assert_allclose(tl, jl, atol=1e-3, rtol=0)
    d = _diffs(tp, jt, jplan, jcfg)
    assert d["emb"] <= 1e-2 and d["dense"] <= 2e-3, d


# -- Adagrad and row-wise Adagrad ---------------------------------------------

@pytest.mark.parametrize("n_hot", [1, 2])
@pytest.mark.parametrize("optimizer", ["adagrad", "rowwise_adagrad"])
def test_tiered_step_opt_matches_jax(optimizer, n_hot):
    """3 steps from zero accumulators and 3 from accumulators warmed to
    0.01, duplicate ids in both tiers."""
    for warm in (False, True):
        tcfg = _cfg(n_hot=n_hot)
        jcfg, jplan, jt, tp = _start(tcfg)
        jopt, topt = _opt_states(tcfg, jcfg, jplan, jt, tp, optimizer, warm)
        jstep = jht.make_tiered_train_step_opt(jcfg, optimizer=optimizer,
                                               lr=0.1, plan=jplan)
        tl, jl = [], []
        for b in _batches(tcfg, 3, np.random.default_rng(9)):
            (jt, jopt), loss = jstep(jt, jopt, *_j(b))
            jl.append(float(loss))
            tl.append(float(ht.tiered_train_step_opt(
                tp, topt, *_t(b), config=tcfg, optimizer=optimizer,
                lr=0.1)))
        np.testing.assert_allclose(tl, jl, atol=1e-5, rtol=0)
        d = _diffs(tp, jt, jplan, jcfg, topt, jopt, optimizer)
        weights = 1e-5 if warm else 1e-3
        assert d["emb"] <= weights and d["dense"] <= weights, (warm, d)
        assert max(d["dev_acc"], d["host_acc"], d["dense_acc"]) <= 1e-6, d


@pytest.mark.parametrize("optimizer", ["adagrad", "rowwise_adagrad"])
def test_tiered_block_opt_matches_jax_and_steps(optimizer):
    """A K=2 block from warm accumulators on micro-batches with no id
    repeated across them: the JAX package's block, and 2 of the port's
    steps."""
    tcfg = _cfg()
    jcfg, jplan, jt, tp = _start(tcfg)
    jopt, topt = _opt_states(tcfg, jcfg, jplan, jt, tp, optimizer, True)
    _, _, _, seq = _start(tcfg)
    seq_opt = _opt_states(tcfg, jcfg, jplan, jt, seq, optimizer, True)[1]
    blk = _disjoint(tcfg, 2, np.random.default_rng(10))
    (jt, jopt), jlosses = jht.make_tiered_train_block_opt(
        jcfg, optimizer=optimizer, lr=0.1, plan=jplan)(jt, jopt, *_j(blk))
    losses = ht.tiered_train_block_opt(tp, topt, *_t(blk), config=tcfg,
                                       optimizer=optimizer, lr=0.1)
    seq_losses = [float(ht.tiered_train_step_opt(
        seq, seq_opt, *(t[i] for t in _t(blk)), config=tcfg,
        optimizer=optimizer, lr=0.1)) for i in range(2)]
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(losses.numpy(), seq_losses, atol=1e-6, rtol=0)
    assert topt["count"] == seq_opt["count"] == 2
    d = _diffs(tp, jt, jplan, jcfg, topt, jopt, optimizer)
    assert max(d["emb"], d["dense"]) <= 1e-5, d
    assert max(d["dev_acc"], d["host_acc"], d["dense_acc"]) <= 1e-6, d
    torch.testing.assert_close(tp["emb"].host, seq["emb"].host, atol=1e-6,
                               rtol=0)
    torch.testing.assert_close(topt["host_acc"], seq_opt["host_acc"],
                               atol=1e-6, rtol=0)


def test_scheduled_sgd_takes_the_opt_step():
    """SGD under a schedule goes through ``tiered_train_step_opt``, as the
    JAX package's CLI sends it: 3 steps against JAX's."""
    from dlrm_tpu.train.optim import make_schedule as jsched
    from dlrm_tpu_torch.train.optim import make_schedule

    sched = {"schedule": "warmup_poly_decay", "warmup_steps": 2,
             "decay_start": 2, "decay_steps": 4}
    tcfg = _cfg()
    jcfg, jplan, jt, tp = _start(tcfg)
    jlr = jsched(0.1, **sched)
    jopt, topt = _opt_states(tcfg, jcfg, jplan, jt, tp, "sgd", False, jlr)
    jstep = jht.make_tiered_train_step_opt(jcfg, optimizer="sgd", lr=jlr,
                                           plan=jplan)
    tl, jl = [], []
    for b in _batches(tcfg, 3, np.random.default_rng(12)):
        (jt, jopt), loss = jstep(jt, jopt, *_j(b))
        jl.append(float(loss))
        tl.append(float(ht.tiered_train_step_opt(
            tp, topt, *_t(b), config=tcfg, optimizer="sgd",
            lr=make_schedule(0.1, **sched))))
    np.testing.assert_allclose(tl, jl, atol=1e-5, rtol=0)
    assert topt["count"] == 3
    d = _diffs(tp, jt, jplan, jcfg)
    assert max(d.values()) <= 1e-5, d


# -- the kernels' plain versions, storage, evaluation -------------------------

def test_plain_kernel_versions():
    """The CPU path: rows into their columns and contiguous; distinct-row
    updates, f32 as ``index_add_`` and bf16 rounded once; no launch."""
    g = torch.Generator().manual_seed(0)
    table = torch.randn((50, 8), generator=g)
    ids = torch.randint(0, 50, (4, 2, 3), generator=g)
    out = torch.zeros((4, 5, 3, 8))
    ht.host_gather(table, ids, out=out, cols=(1, 3))
    assert torch.equal(out[:, [1, 3]], table[ids])
    assert not out[:, [0, 2, 4]].any()
    assert torch.equal(ht.host_gather(table, ids), table[ids])
    uniq = torch.tensor([3, 7, 49])
    upd = torch.randn((3, 8), generator=g)
    want = table.clone()
    want[uniq] += upd
    ht.host_update_rows(table, uniq, upd)
    assert torch.equal(table, want)
    tb = torch.randn((10, 8), generator=g).bfloat16()
    want = tb.clone()
    want[uniq[:2]] = (want[uniq[:2]].float() + upd[:2]).bfloat16()
    ht.host_update_rows(tb, uniq[:2], upd[:2])
    assert torch.equal(tb, want)
    acc = torch.zeros(20)
    ht.host_tier_scatter_add(acc, torch.tensor([2, 5, 2]),
                             torch.tensor([1.0, 2.0, 3.0]))
    assert acc[2] == 4.0 and acc[5] == 2.0
    assert torch.equal(ht.host_tier_gather(acc, torch.tensor([5, 2])),
                       torch.tensor([2.0, 4.0]))
    assert ht.host_gather.launches == 0 and ht.host_update_rows.launches == 0


def _kernel_walk(n_rows, units, blocks):
    """The (row, unit) pairs that the kernels of csrc/host_tier.cu visit,
    by its ``Rounds`` arithmetic: thread t's slots start at units t, t +
    step, ... (step = blocks x threads), each advancing ``_IN_FLIGHT``
    steps a round, a row and unit carried by addition, until its first
    slot passes the last row."""
    step = blocks * ht._THREADS
    step_i, step_c = divmod(step, units)
    round_i, round_c = divmod(step * ht._IN_FLIGHT, units)

    def advance(i, c, di, dc):
        c = c + dc
        return i + di + (c >= units), np.where(c >= units, c - units, c)

    first = np.arange(step, dtype=np.int64)
    slots = [(first // units, first % units)]
    for _ in range(1, ht._IN_FLIGHT):
        slots.append(advance(*slots[-1], step_i, step_c))
    rows, cols = [], []
    while (slots[0][0] < n_rows).any():
        for i, c in slots:   # a slot past the last row is not visited
            rows.append(i[i < n_rows])
            cols.append(c[i < n_rows])
        slots = [advance(i, c, round_i, round_c) for i, c in slots]
    return np.concatenate(rows), np.concatenate(cols)


def _bytes(t):
    """A contiguous tensor's bytes as a writable numpy view."""
    return t.view(torch.uint8).reshape(-1).numpy()


def _emulate_gather(table, plan, out):
    """The gather kernel's copies, unit by unit along its walk."""
    row_bytes = table.shape[1] * table.element_size()
    units = row_bytes // plan.unit
    i, c = _kernel_walk(plan.ids.numel(), units, plan.blocks)
    q = np.sort(i * units + c)
    assert np.array_equal(q, np.arange(plan.ids.numel() * units)), \
        "the walk must visit every unit once"
    src = plan.ids.numpy().astype(np.int64)[i] * row_bytes + c * plan.unit
    dst = plan.dst.numpy()[i] + c * plan.unit
    tb, ob = _bytes(table), _bytes(out)
    for b in range(plan.unit):
        ob[dst + b] = tb[src + b]


def _emulate_update(table, ids, upd, plan):
    """The update kernel along its walk: each unit's elements summed in f32
    with the update and rounded once to the table's dtype."""
    w = table.shape[1]
    vec = 16 // table.element_size() if plan.vec else 1
    i, c = _kernel_walk(ids.numel(), w // vec, plan.blocks)
    assert np.array_equal(np.sort(i * (w // vec) + c),
                          np.arange(ids.numel() * (w // vec)))
    rows = torch.from_numpy(ids.numpy().astype(np.int64)[i])
    for e in range(vec):
        col = torch.from_numpy(c * vec + e)
        table[rows, col] = (table[rows, col].float()
                            + upd[torch.from_numpy(i), col]).to(table.dtype)


_LAYOUTS = ("pooled", "pooled_multi_hot", "contiguous")
# (dtype, width): 16-byte units, bf16, width 1 (4-byte rows), 8- and
# 2-byte units
_ROWS = ((torch.float32, 8), (torch.bfloat16, 8), (torch.float32, 1),
         (torch.float32, 2), (torch.bfloat16, 3))


@pytest.mark.parametrize("id_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("rows", _ROWS, ids=lambda r: f"{r[0]}-w{r[1]}")
@pytest.mark.parametrize("layout", _LAYOUTS)
def test_gather_plan_emulated_is_the_gather(layout, rows, id_dtype):
    """``gather_plan`` and the kernel's walk over it, emulated in numpy,
    give the plain gather's bytes and the JAX package's rows: ids sorted
    with their positions, duplicates, every output layout, id dtype, row
    width and unit."""
    dtype, w = rows
    rng = np.random.default_rng(5)
    table = torch.from_numpy(rng.normal(size=(3000, w)).astype(np.float32)
                             ).to(dtype)
    b, cols, t = 300, (1, 3), 5
    shape = {"pooled": (b, len(cols)), "pooled_multi_hot": (b, len(cols), 3),
             "contiguous": (b, 7)}[layout]
    ids = torch.from_numpy(rng.integers(0, 3000, size=shape)).to(id_dtype)
    ids.view(-1)[:50] = ids.view(-1)[50:100]        # duplicates
    ids.view(-1)[100:150] = 2999                    # the last row, repeated
    if layout == "contiguous":
        out = torch.empty((*shape, w), dtype=dtype)
        want = ht.host_gather_reference(table, ids)
        plan = ht.gather_plan(table, ids, out)
    else:
        out = torch.zeros((b, t, *shape[2:], w), dtype=dtype)
        want = ht.host_gather_reference(table, ids, out.clone(), cols)
        plan = ht.gather_plan(table, ids, out, cols)
    assert torch.equal(plan.ids, torch.sort(ids.reshape(-1)).values)
    assert plan.ids.dtype == id_dtype and plan.dst.dtype == torch.int64
    assert plan.unit == next(u for u in (16, 8, 4, 2, 1)
                             if w * table.element_size() % u == 0)
    assert 1 <= plan.blocks * ht._THREADS * ht._IN_FLIGHT * plan.unit \
        <= max(ht.WINDOW,
               ht._THREADS * ht._IN_FLIGHT * plan.unit)
    _emulate_gather(table, plan, out)
    assert torch.equal(out, want)
    jrows = jax.jit(functools.partial(jht.host_tier_gather, width=w))(
        jax.device_put(jnp.asarray(table.float().numpy().reshape(-1)),
                       jax.memory.Space.Host), jnp.asarray(ids.numpy()))
    got = out if layout == "contiguous" else out[:, list(cols)]
    assert np.array_equal(got.float().numpy(), np.asarray(jrows))


@pytest.mark.parametrize("id_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("rows", ((torch.float32, 8), (torch.bfloat16, 8),
                                  (torch.float32, 1), (torch.float32, 3),
                                  (torch.bfloat16, 16)),
                         ids=lambda r: f"{r[0]}-w{r[1]}")
@pytest.mark.parametrize("order", ["sorted", "shuffled"])
def test_update_plan_emulated_is_the_update(order, rows, id_dtype):
    """``update_plan`` and the kernel's walk, emulated: the plain update's
    bits (f32: the JAX package's scatter-add on distinct ids) in 16-byte
    units and in the element-wise branch (width 1, 4-byte rows)."""
    dtype, w = rows
    rng = np.random.default_rng(6)
    table = torch.from_numpy(rng.normal(size=(3000, w)).astype(np.float32)
                             ).to(dtype)
    ids = np.sort(rng.choice(3000, size=700, replace=False))
    ids[-1] = 2999
    if order == "shuffled":
        rng.shuffle(ids)
    ids = torch.from_numpy(ids).to(id_dtype)
    upd = torch.from_numpy(rng.normal(size=(700, w)).astype(np.float32))
    plan = ht.update_plan(table, ids, upd)
    assert plan.vec == (w * table.element_size() % 16 == 0)
    want = table.clone()
    ht.host_update_rows_reference(want, ids, upd)
    jtable = table.float().numpy().reshape(-1).copy()
    _emulate_update(table, ids, upd, plan)
    assert torch.equal(table, want)
    if dtype == torch.float32:
        jnew = jax.jit(functools.partial(jht.host_tier_scatter_add,
                                         width=w))(
            jax.device_put(jnp.asarray(jtable), jax.memory.Space.Host),
            jnp.asarray(ids.numpy()), jnp.asarray(upd.numpy()))
        assert np.array_equal(table.numpy().reshape(-1), np.asarray(jnew))


def test_tiered_storage_serves_evaluate_and_refuses_plain_training():
    """``evaluate`` and ``score_batch`` take tiered parameters as they are,
    with the results of the merged tables; the plain training step refuses
    them."""
    from dlrm_tpu_torch.run import score_batch
    from dlrm_tpu_torch.train.metrics import evaluate

    tcfg = _cfg()
    _, _, _, tp = _start(tcfg)
    emb = tp["emb"]
    merged = {"bottom": tp["bottom"], "top": tp["top"],
              "emb": ht.merge_tiers(emb.dev, emb.host, emb.plan, tcfg)}
    from dlrm_tpu_torch.data.synthetic import batch_stream

    data = list(batch_stream(tcfg, 32, 3, 0))
    assert evaluate(tp, data, tcfg) == evaluate(merged, data, tcfg)
    np.testing.assert_array_equal(
        score_batch(tp, data[0], tcfg, torch.device("cpu")),
        score_batch(merged, data[0], tcfg, torch.device("cpu")))
    with pytest.raises(TypeError, match="two-tier"):
        dlrm_tpu_torch.train_step(tp, *_t(data[0]), config=tcfg, lr=0.1)
    bad = ht.TieredEmb(emb.dev[:-1], emb.host, emb.plan)
    with pytest.raises(ValueError, match="the plan needs"):
        dlrm_tpu_torch.forward({**tp, "emb": bad}, *_t(data[0])[:2], tcfg)


def test_opt_state_and_converters():
    tcfg = _cfg()
    jcfg, jplan, jt, tp = _start(tcfg)
    for optimizer, shape in (("adagrad", (3560, 8)),
                             ("rowwise_adagrad", (3560,))):
        st = ht.init_tiered_opt_state(tp, config=tcfg, optimizer=optimizer)
        assert tuple(st["host_acc"].shape) == shape and st["count"] == 0
        assert st["dev_acc"].shape[0] == 208 and not st["host_acc"].any()
        jopt, topt = _opt_states(tcfg, jcfg, jplan, jt, tp, optimizer, True)
        assert tuple(topt["host_acc"].shape) == shape
        assert bool((topt["dev_acc"] == WARM).all())
    st = ht.init_tiered_opt_state(tp, config=tcfg, optimizer="sgd")
    assert st["dev_acc"] is None and st["host_acc"] is None
    with pytest.raises(ValueError, match="tiers"):
        convert.tiered_params_from_numpy(
            {**_jax_tiered_np(jt, jplan, jcfg)}, ht.plan_tiers(tcfg, 0), tcfg)


@pytest.mark.parametrize("shape,dtype", [((25_529, 128), torch.float32),
                                         ((3, 1000, 7), torch.bfloat16),
                                         ((5_000_003,), torch.float32)])
def test_cuda_host_tier_takes_its_exact_size(monkeypatch, shape, dtype):
    """The host tier for a CUDA device: exactly prod(shape) * itemsize
    bytes (no power-of-two block) at a page-aligned address, registered
    once with exactly that address and size, and unregistered when the
    last view of it dies.  The registration is recorded, not made: there
    is no card here."""
    import gc
    import mmap

    calls = []
    monkeypatch.setattr(ht, "_cuda_host_register",
                        lambda ptr, n: calls.append(("register", ptr, n)))
    monkeypatch.setattr(ht, "_cuda_host_unregister",
                        lambda ptr: calls.append(("unregister", ptr)))
    t = ht._host_empty(shape, dtype, "cuda")
    nbytes = int(np.prod(shape)) * t.element_size()
    assert t.shape == shape and t.dtype == dtype and t.device.type == "cpu"
    assert t.is_contiguous()
    assert t.untyped_storage().nbytes() == nbytes
    assert t.data_ptr() == t.untyped_storage().data_ptr()
    assert t.data_ptr() % mmap.PAGESIZE == 0
    assert calls == [("register", t.data_ptr(), nbytes)]
    t.fill_(1)  # the whole range is writable memory
    ptr, view = t.data_ptr(), t[1:]
    del t
    gc.collect()
    assert len(calls) == 1  # a view still holds the mapping
    del view
    gc.collect()
    assert calls == [("register", ptr, nbytes), ("unregister", ptr)]


def test_cpu_host_tier_is_plain_memory(monkeypatch):
    """For the CPU the host tier is plain host memory of the exact shape
    and dtype, with nothing registered."""
    monkeypatch.setattr(ht, "_cuda_host_register", None)
    for dtype in (torch.float32, torch.bfloat16):
        t = ht._host_empty((1000, 3), dtype, "cpu")
        assert t.shape == (1000, 3) and t.dtype == dtype
        assert t.device.type == "cpu" and not t.is_pinned()
        assert t.untyped_storage().nbytes() == 3000 * t.element_size()
    assert ht._host_empty((0, 8), torch.float32, "cuda").numel() == 0
