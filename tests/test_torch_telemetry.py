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
