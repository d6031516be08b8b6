"""The device tables' row-wise Adagrad as one sorted segment sum
(``ops/embedding.py`` ``sort_hits`` / ``sorted_rowwise_adagrad``,
``csrc/sparse_adagrad.cu``), the steps' route to it, and ``translate_ids``'
cached offsets.

The CUDA kernel runs only on the card (``chip_smoke.py``
``sparse_adagrad_kernel``).  Here :func:`_kernel_walk` replays its
algorithm in numpy f32: the stable sort, fixed chunks of sorted hits, a
warp's sums of the runs in its chunk in order, head and tail partials for
the runs that cross a chunk border, their combination in chunk order by the
chunk where the run began, and one update a distinct row (the sum of
squares in the kernel's lane order, each op rounded to f32).  It is held
against ``optim.apply_sparse_adagrad`` (``unique``, then ``index_add_`` in
hit order).  Tolerance: the two sum a row's hits in another order (partials
of 128 hits, or of a handful in the border cases, added chunk by chunk,
against one running sum), so the summed rows differ by f32 rounding, at
most ``n * eps * sum|g|`` for a row of ``n`` hits, which is what
:func:`_summed_rows_agree` holds them to; the accumulators then agree to
1e-5 and the weights to 1e-5 relative (an update is ``lr * g / sqrt(acc)``,
of the rounding's relative size in ``g``).
"""

import collections
import dataclasses
import functools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import dlrm_tpu_torch
from dlrm_tpu_torch import config as tc
from dlrm_tpu_torch.data.synthetic import random_batch
from dlrm_tpu_torch.ops import embedding as temb
from dlrm_tpu_torch.parallel import host_tier as ht
from dlrm_tpu_torch.train import optim as toptim
from dlrm_tpu_torch.train import train as ttrain
from dlrm_tpu_torch.utils import telemetry

F32 = np.float32
EPS = F32(1e-10)
LANES = 32
CU = (Path(dlrm_tpu_torch.__file__).resolve().parent / "csrc"
      / "sparse_adagrad.cu")


# -- the kernel's algorithm, replayed -----------------------------------------

def _lane_sumsq(g: np.ndarray) -> F32:
    """The kernel's sum of squares of a row: each lane adds the squares of
    its units' floats in order (16-byte units where D is a multiple of 4),
    then a butterfly over 32 lanes (``__shfl_xor_sync``, 16 down to 1)."""
    d = g.shape[0]
    vec = 4 if d % 4 == 0 else 1
    units = d // vec
    lane = np.zeros(LANES, F32)
    for l in range(LANES):
        for unit in range(l, units, LANES):
            for x in g[unit * vec:(unit + 1) * vec]:
                lane[l] = F32(lane[l] + F32(x * x))
    off = 16
    while off:
        lane = (lane + lane[np.arange(LANES) ^ off]).astype(F32)
        off //= 2
    return lane[0]


def _update(emb, acc, row, g, lr, updates) -> None:
    """One distinct row's row-wise Adagrad, op by op in f32."""
    updates[row] += 1
    a = F32(acc[row] + F32(_lane_sumsq(g) * F32(F32(1) / F32(g.shape[0]))))
    rs = F32(1) / np.sqrt(F32(a + EPS)) if a > 0 else F32(0)
    emb[row] = (emb[row] - ((g * F32(rs)).astype(F32) * F32(lr))
                .astype(F32)).astype(F32)
    acc[row] = a


def _kernel_walk(emb, acc, ids, rows, lr, chunk=temb.SORTED_CHUNK):
    """The kernel's two launches over ``ids`` (n,) and per-hit ``rows`` (n,
    D) on numpy ``emb`` / ``acc``, in place; returns (each updated row's
    count of updates, the summed row each update applied)."""
    pos = np.argsort(ids, kind="stable")
    sid = ids[pos]
    n, d = sid.shape[0], rows.shape[1]
    chunks = -(-n // chunk)
    head, tail = {}, {}
    updates, summed = collections.Counter(), {}

    def apply(row, g):
        summed[row] = g
        _update(emb, acc, row, g, lr, updates)

    for c in range(chunks):                   # launch one
        lo, hi = c * chunk, min((c + 1) * chunk, n)
        before = lo > 0 and sid[lo - 1] == sid[lo]
        after = hi < n and sid[hi] == sid[hi - 1]
        s, cur, first = np.zeros(d, F32), sid[lo], True
        for i in range(lo, hi):
            if sid[i] != cur:
                if first and before:
                    head[c] = s
                else:
                    apply(int(cur), s)
                s, cur, first = np.zeros(d, F32), sid[i], False
            s = (s + rows[pos[i]]).astype(F32)
        if first and before:
            head[c] = s
        elif after:
            tail[c] = s
        else:
            apply(int(cur), s)
    for c in range(chunks):                   # launch two
        lo, hi = c * chunk, (c + 1) * chunk
        if hi >= n or sid[hi] != sid[hi - 1] or (lo > 0 and
                                                  sid[lo - 1] == sid[hi - 1]):
            continue
        end = hi
        while end < n and sid[end] == sid[hi - 1]:
            end += 1
        s = tail[c]
        for k in range(c + 1, (end - 1) // chunk + 1):
            s = (s + head[k]).astype(F32)
        apply(int(sid[hi - 1]), s)
    return updates, summed


def _summed_rows_agree(ids, rows, summed) -> None:
    """Each summed row within ``n * eps * sum|g|`` of its float64 sum."""
    for r, g in summed.items():
        hit = rows[ids == r].astype(np.float64)
        bound = hit.shape[0] * np.finfo(F32).eps * np.abs(hit).sum(axis=0)
        assert (np.abs(g - hit.sum(axis=0)) <= bound).all(), r


def _zipf_ids(rng, sizes, hits_per_table, a=1.2) -> np.ndarray:
    """Zipf(a) ranks clipped to each table, stacked as one batch's ids in
    (B, T) order, offsets added."""
    offs = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    cols = [np.minimum(rng.zipf(a, hits_per_table) - 1, s - 1) + o
            for s, o in zip(sizes, offs)]
    return np.stack(cols, axis=1).reshape(-1).astype(np.int64)


def _straddling_ids(chunk) -> np.ndarray:
    """Runs that end one before, at and one after a chunk border, one that
    spans three chunks, and singletons between, shuffled into hit order."""
    runs = [chunk - 1, 1, chunk, chunk + 1, 3 * chunk + 2, 1, 1, 2, chunk - 2]
    ids = np.repeat(np.arange(len(runs)) * 3, runs)
    return np.random.default_rng(3).permutation(ids)


CASES = {
    "3 rows, 24000 hits": (lambda rng: rng.integers(0, 3, 24000), 3, 128),
    "runs straddle chunk borders": (lambda rng: _straddling_ids(8), 30, 8),
    "runs straddle 128-hit chunks": (lambda rng: _straddling_ids(128), 30,
                                     128),
    "zipf over several tables": (
        lambda rng: _zipf_ids(rng, (3, 24, 1000, 50000), 3000), 51027, 128),
    "one hit": (lambda rng: np.array([5]), 9, 128),
    "no hits": (lambda rng: np.zeros(0, np.int64), 9, 128),
}


@pytest.mark.parametrize("name", list(CASES))
def test_kernel_walk_is_apply_sparse_adagrad(name, rng):
    """The kernel's algorithm gives ``apply_sparse_adagrad``'s row-wise
    update: every hit row updated once, untouched rows keep their bits,
    the rest within the tolerance of the module docstring."""
    make, n_rows, chunk = CASES[name]
    d = 8
    ids = np.asarray(make(rng), np.int64)
    rows = rng.normal(size=(ids.shape[0], d)).astype(F32)
    emb0 = rng.normal(size=(n_rows, d)).astype(F32)
    acc0 = np.where(rng.random(n_rows) < 0.5, 0,
                    rng.random(n_rows)).astype(F32)
    lr = 0.05
    emb, acc = emb0.copy(), acc0.copy()
    updates, summed = _kernel_walk(emb, acc, ids, rows, lr, chunk)
    assert set(updates) == set(ids.tolist())
    assert set(updates.values()) <= {1}
    _summed_rows_agree(ids, rows, summed)
    t_emb, t_acc = torch.from_numpy(emb0.copy()), torch.from_numpy(acc0.copy())
    toptim.apply_sparse_adagrad(
        t_emb, t_acc, temb.SparseGrad(torch.from_numpy(ids),
                                      torch.from_numpy(rows)),
        lr, rowwise=True)
    untouched = np.setdiff1d(np.arange(n_rows), ids)
    assert (emb[untouched] == emb0[untouched]).all()
    assert (acc[untouched] == acc0[untouched]).all()
    np.testing.assert_allclose(acc, t_acc.numpy(), rtol=1e-5, atol=0)
    np.testing.assert_allclose(emb, t_emb.numpy(), rtol=1e-5, atol=1e-7)


def test_chunk_mirrors_the_kernel():
    """``SORTED_CHUNK`` is the kernel's ``kChunk``: the partials' scratch
    is sized from it."""
    src = CU.read_text()
    assert int(re.search(r"kChunk = (\d+);", src).group(1)) == \
        temb.SORTED_CHUNK


def test_sort_hits_is_stable_and_carries_positions():
    ids = torch.tensor([4, 1, 4, 0, 1, 4], dtype=torch.int32)
    hits = temb.sort_hits(ids)
    assert hits.ids.tolist() == [0, 1, 1, 4, 4, 4]
    assert hits.positions.tolist() == [3, 1, 4, 0, 2, 5]
    assert hits.positions.dtype == torch.int64


@pytest.mark.parametrize("id_dtype", [torch.int32, torch.int64])
def test_plain_version_is_apply_sparse_adagrad_bit_for_bit(id_dtype, rng):
    """On the CPU the plain version sums each row's hits in hit order (the
    sort is stable), as ``index_add_`` does after ``unique``: the same
    bits."""
    ids = torch.from_numpy(_zipf_ids(rng, (3, 40, 700), 500)).to(id_dtype)
    rows = torch.from_numpy(rng.normal(size=(ids.numel(), 8)).astype(F32))
    emb0 = torch.from_numpy(rng.normal(size=(743, 8)).astype(F32))
    acc0 = torch.from_numpy(rng.random(743).astype(F32))
    got_e, got_a = emb0.clone(), acc0.clone()
    temb.sorted_rowwise_adagrad(got_e, got_a, temb.sort_hits(ids), rows, 0.1)
    want_e, want_a = emb0.clone(), acc0.clone()
    toptim.apply_sparse_adagrad(want_e, want_a, temb.SparseGrad(ids, rows),
                                0.1, rowwise=True)
    assert torch.equal(got_e, want_e) and torch.equal(got_a, want_a)


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _meta_hits(n, dtype=torch.int64):
    return temb.SortedHits(_meta(n, dtype), _meta(n, torch.int64))


@pytest.mark.parametrize("args,err,msg", [
    ((_meta((9, 8)), _meta(9), _meta_hits(4), torch.zeros(4, 8)),
     ValueError, "not all on"),
    ((_meta((9, 8), torch.bfloat16), _meta(9), _meta_hits(4), _meta((4, 8))),
     TypeError, "f32"),
    ((_meta((9, 8)), _meta(9), _meta_hits(4, torch.int16), _meta((4, 8))),
     TypeError, "int32/int64"),
    ((_meta((9, 8)), _meta((9, 8)), _meta_hits(4), _meta((4, 8))),
     ValueError, "accumulator"),
    ((_meta((9, 8)), _meta(9), _meta_hits(4), _meta((5, 8))),
     ValueError, "positions"),
    ((_meta((9, 8)), _meta(9), _meta_hits(4), _meta((8, 4)).t()),
     ValueError, "contiguous"),
    ((_meta((9, 130)), _meta(9), _meta_hits(4), _meta((4, 130))),
     ValueError, "D <= 512"),
])
def test_sorted_rowwise_adagrad_refuses_what_the_kernel_does_not_take(
        args, err, msg):
    with pytest.raises(err, match=msg):
        temb.sorted_rowwise_adagrad(*args, 0.1)


@pytest.mark.parametrize("dim,takes", [
    (128, True), (8, True), (6, True), (130, False), (512, True),
    (516, False), (0, False)])
def test_sorted_update_takes(dim, takes):
    assert temb.sorted_update_takes(dim) is takes


# -- the route: which steps take the sorted segment sum -----------------------

SIZES = (6, 300, 9, 2000, 40)
BATCH = 16
TIER_BUDGET = (6 + 300 + 9 + 40) * 8 * 4   # the 2000-row table on the host


def _cfg(**over):
    """5 tables, D=8: small ones (6, 9 and 40 rows) and big ones under a
    threshold of 50, so today's path splits the gradient."""
    return dataclasses.replace(tc.tiny_config(feature_size=8),
                               table_sizes=SIZES, small_table_threshold=50,
                               **over)


def _state(cfg, optimizer, seed=0):
    params = dlrm_tpu_torch.init_params(torch.Generator().manual_seed(seed),
                                        cfg)
    opt = ttrain.init_opt_state(params, config=cfg, optimizer=optimizer)
    return params, opt


def _batch(cfg, k=None, seed=1):
    rng = np.random.default_rng(seed)
    bs = [random_batch(rng, cfg, BATCH) for _ in range(k or 1)]
    out = [torch.from_numpy(np.stack([b[key] for b in bs]))
           for key in ("dense", "sparse", "labels")]
    return out if k else [t[0] for t in out]


def _single(cfg, optimizer, clip=None):
    params, opt = _state(cfg, optimizer)
    return lambda: ttrain.train_step_opt(
        params, opt, *_batch(cfg), config=cfg, optimizer=optimizer, lr=0.1,
        grad_clip_norm=clip)


def _block(cfg, optimizer):
    params, opt = _state(cfg, optimizer)
    return lambda: ttrain.train_block_opt(
        params, opt, *_batch(cfg, k=2), config=cfg, lr=0.1,
        optimizer=optimizer)


def _sgd(cfg):
    params, _ = _state(cfg, "sgd")
    return lambda: ttrain.train_step(params, *_batch(cfg), config=cfg, lr=0.1)


def _tiered(cfg, optimizer, block=False):
    params, _ = _state(cfg, "sgd")
    plan = ht.plan_tiers(cfg, TIER_BUDGET)
    assert plan.host_tables == (3,)
    tp = ht.init_tiered_params(params, plan, cfg)
    opt = ht.init_tiered_opt_state(tp, config=cfg, optimizer=optimizer)
    if block:
        return lambda: ht.tiered_train_block_opt(
            tp, opt, *_batch(cfg, k=2), config=cfg, optimizer=optimizer,
            lr=0.1)
    return lambda: ht.tiered_train_step_opt(
        tp, opt, *_batch(cfg), config=cfg, optimizer=optimizer, lr=0.1)


HITS = BATCH * len(SIZES)
DEVICE_HITS = BATCH * 4            # the tiered plan's device tables
ROUTES = {
    # name: (step maker, device-table hits counted, all of them sorted)
    "row-wise step": (lambda: _single(_cfg(), "rowwise_adagrad"), HITS, True),
    "row-wise two-tier step": (
        lambda: _tiered(_cfg(), "rowwise_adagrad"), DEVICE_HITS, True),
    "row-wise two-tier K=2 block": (
        lambda: _tiered(_cfg(), "rowwise_adagrad", block=True),
        2 * DEVICE_HITS, True),
    "row-wise clipped step": (
        lambda: _single(_cfg(), "rowwise_adagrad", clip=1.0), HITS, False),
    "row-wise K=2 block": (lambda: _block(_cfg(), "rowwise_adagrad"),
                           2 * HITS, False),
    "row-wise bf16 tables": (
        lambda: _single(_cfg(embedding_dtype=torch.bfloat16),
                        "rowwise_adagrad"), HITS, False),
    "adagrad step": (lambda: _single(_cfg(), "adagrad"), HITS, False),
    "sgd opt step": (lambda: _single(_cfg(), "sgd"), HITS, False),
    "sgd step": (lambda: _sgd(_cfg()), HITS, False),
    "adagrad two-tier step": (lambda: _tiered(_cfg(), "adagrad"),
                              DEVICE_HITS, False),
}


def _traced(step):
    """(counters, span names) of one call of ``step`` under a profiler."""
    telemetry.reset_counters()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            step()
        return telemetry.counters(), {e.name for e in prof.events()}
    finally:
        telemetry.reset_counters()


@pytest.mark.parametrize("name", list(ROUTES))
def test_route_through_the_counters(name, monkeypatch):
    """With the CPU standing in for the card (``CARD_DEVICES``), only a
    row-wise Adagrad update of f32 tables without a clip, applied in the
    step that made it, takes the sorted segment sum: there every device
    hit is a fused hit, the hits are sorted under ``dedup`` and updated
    under ``sparse_update``, and nothing is split by table group;
    everything else keeps today's path and counts its hits only."""
    make, hits, fused = ROUTES[name]
    step = make()
    monkeypatch.setattr(toptim, "CARD_DEVICES", ("cuda", "cpu"))
    counts, spans = _traced(step)
    want = {"sparse_update.hits": hits}
    if fused:
        want["sparse_update.fused_hits"] = hits
    assert {k: v for k, v in counts.items()
            if k.startswith("sparse_update.")} == want
    if fused:
        assert {"dedup", "sparse_update", "aten::sort"} <= spans
        if "two-tier" not in name:  # the tiers' split and host dedup stay
            assert not spans & {"grad_split", "aten::_unique2"}
    elif name == "row-wise clipped step":
        assert {"grad_split", "aten::_unique2"} <= spans


@pytest.mark.parametrize("name", ["row-wise step", "row-wise two-tier step"])
def test_the_cpu_counts_nothing_and_keeps_todays_path(name):
    counts, spans = _traced(ROUTES[name][0]())
    assert not any(k.startswith("sparse_update.") for k in counts)
    assert {"grad_split", "aten::_unique2"} <= spans


def _run(make, steps, monkeypatch=None):
    if monkeypatch is not None:
        monkeypatch.setattr(toptim, "CARD_DEVICES", ("cuda", "cpu"))
    step = make()
    for _ in range(steps):
        step()
    return step


@pytest.mark.parametrize("tiered", [False, True])
def test_the_sorted_route_gives_todays_steps(tiered, monkeypatch):
    """Three row-wise steps through the sorted segment sum and through
    today's split, dedup and apply, from one state: on the CPU both sum a
    row's hits in hit order, so they agree to the bit."""
    cfg = _cfg()
    out = []
    for patch in (None, monkeypatch):
        params, opt = _state(cfg, "rowwise_adagrad")
        if tiered:
            plan = ht.plan_tiers(cfg, TIER_BUDGET)
            params = ht.init_tiered_params(params, plan, cfg)
            opt = ht.init_tiered_opt_state(params, config=cfg,
                                           optimizer="rowwise_adagrad")
            fn = functools.partial(ht.tiered_train_step_opt, params, opt,
                                   config=cfg, optimizer="rowwise_adagrad",
                                   lr=0.1)
        else:
            fn = functools.partial(ttrain.train_step_opt, params, opt,
                                   config=cfg, optimizer="rowwise_adagrad",
                                   lr=0.1)
        if patch is not None:
            patch.setattr(toptim, "CARD_DEVICES", ("cuda", "cpu"))
        losses = [fn(*_batch(cfg, seed=s)) for s in range(3)]
        emb = params["emb"]
        tables = [emb.dev, emb.host] if tiered else [emb]
        accs = [opt["dev_acc"], opt["host_acc"]] if tiered else [opt["emb"]]
        out.append((losses, tables, accs))
    for a, b in zip(*out):
        assert all(torch.equal(x, y) for x, y in zip(a, b))


# -- translate_ids' cached offsets --------------------------------------------

def test_translate_ids_caches_one_offsets_tensor_per_key():
    """Equal results whatever form the offsets take, and one device tensor
    per (offsets, device, dtype), made at the first call."""
    temb.offsets_tensor.cache_clear()
    offs = (0, 10, 30)
    ids32 = torch.tensor([[1, 2, 3], [4, 5, 6]], dtype=torch.int32)
    want = ids32 + torch.tensor(offs, dtype=torch.int32)
    for form in (offs, list(offs), offs):
        got = temb.translate_ids(ids32, form)
        assert torch.equal(got, want) and got.dtype == torch.int32
    assert temb.offsets_tensor.cache_info().currsize == 1
    got64 = temb.translate_ids(ids32.long(), offs)
    assert torch.equal(got64, want.long())
    hot = temb.translate_ids(ids32[:, :, None].expand(2, 3, 2), offs)
    assert torch.equal(hot, want[:, :, None].expand(2, 3, 2))
    info = temb.offsets_tensor.cache_info()
    assert (info.currsize, info.misses) == (2, 2)
    assert temb.offsets_tensor(offs, torch.device("cpu"), torch.int32) is \
        temb.offsets_tensor(offs, torch.device("cpu"), torch.int32)
