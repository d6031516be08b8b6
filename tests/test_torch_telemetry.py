"""dlrm_tpu_torch.utils.telemetry against dlrm_tpu.utils.telemetry: the
``Recorder`` on a scripted event list, ``InstrumentedTrainer.step``
against the JAX one (the same JAX-initialised parameters and numpy batch;
parameters and loss within 1e-5, one-hot and multi-hot, gram, pairwise and
fused, the last through the kernels' plain versions here and through the
JAX package's Pallas kernels in interpret mode), the same step against the
port's ``train_step`` within 1e-6 (the bound of the JAX package's own test,
``tests/test_metrics_telemetry.py``), the symbols in the JAX order, and the
phase scopes in a ``trace``.
"""

import dataclasses
import glob
import json

import jax
import numpy as np
import pytest
import torch

import dlrm_tpu
from dlrm_tpu.utils import telemetry as jtel
import dlrm_tpu_torch
from dlrm_tpu_torch import config as tc
from dlrm_tpu_torch.data.synthetic import random_batch
from dlrm_tpu_torch.io.convert import params_from_numpy
from dlrm_tpu_torch.utils import telemetry as ttel
from test_torch_model import jax_config, jax_params_to_numpy

SYMBOLS = ["start", "lookup", "bottom_mlp", "interaction", "top_mlp", "loss",
           "loss_back", "top_mlp_back", "interaction_back", "bottom_mlp_back",
           "lookup_back", "grads_done", "weight_update_done",
           "embedding_update_done", "update_done"]


def test_recorder_matches_jax_on_a_scripted_event_list():
    rng = np.random.default_rng(2)
    events, t = [], 1_000
    for _ in range(3):  # three steps, "start" opening each
        for sym in SYMBOLS:
            t += int(rng.integers(1, 5_000_000))
            events.append((sym, t))
    ours, theirs = ttel.Recorder(), jtel.Recorder()
    ours.events, theirs.events = list(events), list(events)
    assert ours.phase_durations() == theirs.phase_durations()
    assert ours.summary() == theirs.summary()
    assert "start" not in ours.summary()
    assert len(ours.phase_durations()["lookup"]) == 3
    # timestamps in order, one per call
    rec = ttel.Recorder()
    for sym in SYMBOLS:
        rec(sym)
    assert [s for s, _ in rec.events] == SYMBOLS
    assert all(a[1] <= b[1] for a, b in zip(rec.events, rec.events[1:]))
    ttel.donothing("lookup")


def _cfg(impl, n_hot):
    return dataclasses.replace(tc.tiny_config(feature_size=8),
                               table_sizes=(6, 300, 9, 2000, 40),
                               small_table_threshold=50, n_hot=n_hot,
                               interaction_impl=impl)


def _max_diff(tparams, jnp_params):
    return max(
        [np.abs(tparams["emb"].numpy() - jnp_params["emb"]).max()]
        + [np.abs(layer[k].numpy() - jl[k]).max()
           for part in ("bottom", "top")
           for layer, jl in zip(tparams[part], jnp_params[part])
           for k in ("w", "b")])


@pytest.mark.parametrize("n_hot", [1, 3], ids=["onehot", "3hot"])
@pytest.mark.parametrize("impl", ["gram", "pairwise", "fused"])
def test_instrumented_step_matches_jax_and_train_step(impl, n_hot):
    tcfg = _cfg(impl, n_hot)
    jcfg = jax_config(tcfg)
    jparams = dlrm_tpu.init_params(jax.random.key(5), jcfg)
    start = jax_params_to_numpy(jparams, jcfg)
    batch = random_batch(np.random.default_rng(1), tcfg, 48)

    jrec, trec = jtel.Recorder(), ttel.Recorder()
    jnew, jloss = jtel.InstrumentedTrainer(jcfg, lr=0.3).step(
        jparams, batch, cb=jrec)
    ours = params_from_numpy(start, tcfg)
    loss = ttel.InstrumentedTrainer(tcfg, lr=0.3).step(ours, batch, cb=trec)

    assert [s for s, _ in trec.events] == [s for s, _ in jrec.events]
    assert [s for s, _ in trec.events] == SYMBOLS
    assert isinstance(loss, float)
    assert abs(loss - jloss) <= 1e-5
    assert _max_diff(ours, jax_params_to_numpy(jnew, jcfg)) <= 1e-5

    # the port's own train_step from the same start
    ref = params_from_numpy(start, tcfg)
    ref_loss = dlrm_tpu_torch.train_step(
        ref, *(torch.from_numpy(batch[k]) for k in ("dense", "sparse",
                                                      "labels")),
        config=tcfg, lr=0.3)
    assert abs(loss - float(ref_loss)) <= 1e-6
    assert _max_diff(ours, {k: (v.numpy() if k == "emb" else
                                [{n: t.numpy() for n, t in l.items()}
                                 for l in v])
                            for k, v in ref.items()}) <= 1e-6
    moved = np.abs(ours["emb"].numpy() - start["emb"]).max()
    assert moved > 0


def test_instrumented_step_updates_in_place():
    tcfg = _cfg("gram", 1)
    params = dlrm_tpu_torch.init_params(torch.Generator().manual_seed(1),
                                        tcfg)
    emb, w = params["emb"], params["top"][0]["w"]
    before = emb.clone()
    trainer = ttel.InstrumentedTrainer(tcfg, lr=0.1)
    rng = np.random.default_rng(0)
    losses = [trainer.step(params, random_batch(rng, tcfg, 32))
              for _ in range(3)]
    assert params["emb"] is emb and params["top"][0]["w"] is w
    assert not torch.equal(emb, before)
    assert all(np.isfinite(losses))
    assert not w.requires_grad and not emb.requires_grad


def test_trace_shows_the_phase_scopes(tmp_path):
    """The forward's and the training step's phase scopes in a trace
    written by ``trace``."""
    tcfg = _cfg("fused", 1)
    params = dlrm_tpu_torch.init_params(torch.Generator().manual_seed(1),
                                        tcfg)
    b = random_batch(np.random.default_rng(0), tcfg, 16)
    d, s, l = (torch.from_numpy(b[k]) for k in ("dense", "sparse", "labels"))
    want = dlrm_tpu_torch.forward(params, d, s, tcfg)
    with ttel.trace(str(tmp_path)):
        got = dlrm_tpu_torch.forward(params, d, s, tcfg)
        dlrm_tpu_torch.train_step(params, d, s, l, config=tcfg, lr=0.1)
    assert torch.equal(got, want)  # the scopes change no number
    (path,) = glob.glob(str(tmp_path / "*.json"))
    with open(path) as f:
        names = [e.get("name") for e in json.load(f)["traceEvents"]]
    for scope in ("lookup", "bottom_mlp", "interaction", "top_mlp"):
        assert names.count(scope) == 2, scope


# -- spans and counters inside the step ---------------------------------------

STEP_SPANS = ("dense_apply", "sparse_update", "dedup", "autograd.bwd",
              "loss.bwd", "top_mlp.bwd", "interaction.bwd", "bottom_mlp.bwd")
KEYS = ("dense", "sparse", "labels")


def _profiled(fn):
    """(fn's result, the user spans of a CPU profile of it, by name:
    [(start, end, thread)])."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = {}
    for e in prof.events():
        if getattr(e, "is_user_annotation", False):
            spans.setdefault(e.name, []).append(
                (e.time_range.start, e.time_range.end, e.thread))
    return out, spans


def test_counters_add_only_while_a_profiler_records():
    ttel.reset_counters()
    ttel.count("x", 5)
    assert ttel.counters() == {}
    _profiled(lambda: (ttel.count("x", 5), ttel.count("x"),
                       ttel.count("y", True)))
    assert ttel.counters() == {"x": 6, "y": 1}
    snap = ttel.counters()
    snap["x"] = 0  # a snapshot, not the counters
    assert ttel.counters()["x"] == 6
    ttel.reset_counters()
    assert ttel.counters() == {}


def test_counters_lose_no_update_across_threads(monkeypatch):
    """Counts from many threads at once (recording forced on: a profiler
    records only on its own thread and the autograd engine's) add up."""
    import sys
    import threading

    monkeypatch.setattr(ttel, "recording", lambda: True)
    ttel.reset_counters()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [ttel.count("n", 3)
                                                    for _ in range(2000)])
                   for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert ttel.counters() == {"n": 16 * 2000 * 3}
    ttel.reset_counters()


def _step_cfg(impl="fused", **kw):
    return dataclasses.replace(_cfg(impl, 1), **kw)


def _batch(tcfg, seed=0, b=32):
    batch = random_batch(np.random.default_rng(seed), tcfg, b)
    return [torch.from_numpy(batch[k]) for k in KEYS]


def test_traced_rowwise_step_shows_the_step_spans():
    """A row-wise step traced on the CPU: the optimizer's, the update's and
    the dedup's spans, and the backward's stages in their order, one after
    the other, each around its own matrix products."""
    from dlrm_tpu_torch.train import train as ttrain

    tcfg = _step_cfg()
    params = dlrm_tpu_torch.init_params(torch.Generator().manual_seed(1),
                                        tcfg)
    state = ttrain.init_opt_state(params, config=tcfg,
                                  optimizer="rowwise_adagrad")
    b = _batch(tcfg)
    _, spans = _profiled(lambda: ttrain.train_step_opt(
        params, state, *b, config=tcfg, optimizer="rowwise_adagrad",
        lr=0.1))
    assert set(STEP_SPANS) <= set(spans), sorted(spans)
    # small and big tables updated together: no split, one dedup, one
    # update, the dedup inside it
    assert "grad_split" not in spans
    for name in ("dedup", "sparse_update"):
        assert len(spans[name]) == 1, name
    (upd,), (dedup,) = spans["sparse_update"], spans["dedup"]
    assert upd[0] <= dedup[0] and dedup[1] <= upd[1]
    assert len(spans["loss"]) == 1 and len(spans["dense_apply"]) == 1
    bwd = [spans[n][0] for n in ("loss.bwd", "top_mlp.bwd",
                                 "interaction.bwd", "bottom_mlp.bwd")]
    assert all(a[1] <= b[0] for a, b in zip(bwd, bwd[1:])), bwd
    (call,) = spans["autograd.bwd"]  # the caller's, around the stages
    assert call[0] <= bwd[0][0] and bwd[-1][1] <= call[1]
    assert call[1] <= spans["dense_apply"][0][0]


def test_gram_interaction_backward_is_named_by_the_marks():
    tcfg = _step_cfg("gram")
    params = dlrm_tpu_torch.init_params(torch.Generator().manual_seed(1),
                                        tcfg)
    _, spans = _profiled(lambda: dlrm_tpu_torch.train_step(
        params, *_batch(tcfg), config=tcfg, lr=0.1))
    for name in STEP_SPANS:  # SGD: no dedup
        assert len(spans.get(name, ())) == (name != "dedup"), name


def _flat(params):
    from dlrm_tpu_torch.parallel.host_tier import TieredEmb

    emb = params["emb"]
    tables = [emb.dev, emb.host] if isinstance(emb, TieredEmb) else [emb]
    return tables + [layer[k] for part in ("bottom", "top")
                     for layer in params[part] for k in ("w", "b")]


def _two_steps(kind, traced):
    """Two row-wise steps (``rowwise``, ``gram``, ``remat`` or ``two_tier``)
    from one start, under a profiler or not; every tensor of the state."""
    from dlrm_tpu_torch.parallel import host_tier as ht
    from dlrm_tpu_torch.train import train as ttrain

    tcfg = _step_cfg("gram" if kind == "gram" else "fused",
                     remat=kind == "remat")
    params = dlrm_tpu_torch.init_params(torch.Generator().manual_seed(3),
                                        tcfg)
    if kind == "two_tier":
        plan = ht.plan_tiers(tcfg, 400 * 8 * 4)
        assert plan.host_tables and plan.device_tables
        params = ht.init_tiered_params(params, plan, tcfg)
        state = ht.init_tiered_opt_state(params, config=tcfg,
                                         optimizer="rowwise_adagrad")
        step = ht.tiered_train_step_opt
    else:
        state = ttrain.init_opt_state(params, config=tcfg,
                                      optimizer="rowwise_adagrad")
        step = ttrain.train_step_opt

    def run():
        return [step(params, state, *_batch(tcfg, seed), config=tcfg,
                     optimizer="rowwise_adagrad", lr=0.1) for seed in (0, 1)]

    losses = _profiled(run)[0] if traced else run()
    accs = [v for k, v in state.items() if k != "count" and v is not None
            and not isinstance(v, dict)]
    dense_accs = [layer[k] for part in ("bottom", "top")
                  for layer in state["dense"][part] for k in ("w", "b")]
    return losses + _flat(params) + accs + dense_accs


@pytest.mark.parametrize("kind", ["rowwise", "gram", "remat", "two_tier"])
def test_parameters_are_bit_identical_with_tracing_on_and_off(kind):
    off, on = _two_steps(kind, False), _two_steps(kind, True)
    assert len(off) == len(on)
    for a, b in zip(off, on):
        assert torch.equal(a, b)


def test_backward_marks_only_while_a_profiler_records():
    from dlrm_tpu_torch.models.dlrm import loss_from_pooled

    tcfg = _step_cfg()
    params = dlrm_tpu_torch.init_params(torch.Generator().manual_seed(1),
                                        tcfg)
    dense_params = {k: [{n: t.detach().requires_grad_() for n, t in
                         layer.items()} for layer in params[k]]
                    for k in ("bottom", "top")}
    d, s, l = _batch(tcfg, b=8)
    pooled = dlrm_tpu_torch.ops.embedding.lookup(
        params["emb"], s, tcfg.table_offsets).requires_grad_()
    mark = "_BackwardMarkBackward"
    plain = loss_from_pooled(dense_params, pooled, d, l, tcfg)
    assert type(plain.grad_fn).__name__ != mark
    marked, _ = _profiled(lambda: loss_from_pooled(dense_params, pooled, d,
                                                   l, tcfg))
    assert type(marked.grad_fn).__name__ == mark
    with torch.no_grad():
        assert not _profiled(ttel.backward_spans)[0].active


def test_spans_left_open_close_when_the_backward_ends():
    """A stage whose closing mark the backward never reaches (its input
    takes no gradient) still ends with the backward."""
    x = torch.randn(4, 3, requires_grad=True)

    def run():
        spans = ttel.backward_spans()
        y = spans.mark((spans.mark(x, close="a") * 2).sum(), open="a")
        y2 = spans.mark(x.sum(), open="b")
        torch.autograd.grad(y + y2, [x])
        return spans

    spans, got = _profiled(run)
    assert not spans.open
    assert len(got["a"]) == 1 and len(got["b"]) == 1
    assert got["b"][0][1] >= got["a"][0][0]


def test_host_tier_counts_a_row_a_hit():
    """A two-tier row-wise step counts the host tier's bytes from the
    shapes: the table rows of every hit gathered, each distinct row's
    accumulator gathered, then rows and accumulators read and written
    back."""
    from dlrm_tpu_torch.parallel import host_tier as ht

    tcfg = _step_cfg()
    plan = ht.plan_tiers(tcfg, 400 * 8 * 4)
    params = ht.init_tiered_params(dlrm_tpu_torch.init_params(
        torch.Generator().manual_seed(3), tcfg), plan, tcfg)
    state = ht.init_tiered_opt_state(params, config=tcfg,
                                     optimizer="rowwise_adagrad")
    d, s, l = _batch(tcfg)
    ids = s[:, list(plan.host_tables)] + torch.tensor(plan.host_offsets)
    hits, distinct = ids.numel(), torch.unique(ids).numel()
    row = tcfg.feature_size * 4
    ttel.reset_counters()
    _profiled(lambda: ht.tiered_train_step_opt(
        params, state, d, s, l, config=tcfg, optimizer="rowwise_adagrad",
        lr=0.1))
    assert ttel.counters() == {
        "host_tier.gather_bytes": hits * row + distinct * 4,
        "host_tier.update_bytes": 2 * distinct * (row + 4)}
    ttel.reset_counters()


def test_prefetch_counts_the_takes_that_found_no_batch():
    """``_ahead``'s consumer, with CPU put / take: a slow source leaves the
    queue empty at every take; a fast one, behind a slow consumer, never
    past the first."""
    import time

    from dlrm_tpu_torch.data.prefetch import _ahead

    def slow(n):
        for i in range(n):
            time.sleep(0.02)
            yield i

    def consume(source, pause):
        out = []
        for b in _ahead(source, 2, lambda x: x, lambda x: x):
            out.append(b)
            time.sleep(pause)
        return out

    for source, pause, empty in ((slow(5), 0, (5, 6)),
                                 (iter(range(5)), 0.05, (0, 1))):
        ttel.reset_counters()
        got, spans = _profiled(lambda: consume(source, pause))
        c = ttel.counters()
        assert got == list(range(5))
        assert c["prefetch.takes"] == 6  # five batches and the end
        assert empty[0] <= c.get("prefetch.empty", 0) <= empty[1], c
        assert len(spans["prefetch.take"]) == 6
    ttel.reset_counters()


def test_score_batch_names_its_copies():
    from dlrm_tpu_torch.run import score_batch

    tcfg = _step_cfg()
    params = dlrm_tpu_torch.init_params(torch.Generator().manual_seed(1),
                                        tcfg)
    batch = random_batch(np.random.default_rng(0), tcfg, 16)
    want = score_batch(params, batch, tcfg, torch.device("cpu"))
    got, spans = _profiled(lambda: score_batch(params, batch, tcfg,
                                               torch.device("cpu")))
    np.testing.assert_array_equal(got, want)
    assert len(spans["score_batch.h2d"]) == 1
    assert len(spans["score_batch.readback"]) == 1
    assert not any(n.endswith(".bwd") for n in spans)
