"""dlrm_tpu_torch.train.metrics against dlrm_tpu.train.metrics: accuracy,
exact AUC, the streaming AUC's buckets, ``Every`` and ``evaluate``.

The host-side metrics get the same numpy predictions on both sides and
agree to 1e-12 (the same f64 arithmetic).  ``evaluate`` runs the same
JAX-initialised parameters over the same batches: the example count and
the accuracy are equal, AUC and loss agree within 1e-6 (f32 scores that
differ by sums in another order)."""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrm_tpu.train import metrics as jmetrics
from dlrm_tpu_torch import config as tc
from dlrm_tpu_torch.data.synthetic import ClickthroughModel, random_batch
from dlrm_tpu_torch.train import metrics as tmetrics
from test_torch_optim import setup


def _preds(rng, n, kind):
    """Scores in [0, 1] with exact 0s and 1s; ``ties``: few distinct
    values."""
    p = rng.random(n).astype(np.float32)
    if kind == "ties":
        p = np.round(p * 7) / 7
    p[:3] = 0.0
    p[3:6] = 1.0
    labels = (rng.random(n) < 0.3 + 0.4 * p).astype(np.float32)
    return p.astype(np.float32), labels


@pytest.mark.parametrize("kind", ["distinct", "ties"])
def test_auc_roc_and_accuracy_match_jax(kind, rng):
    p, y = _preds(rng, 500, kind)
    assert abs(tmetrics.auc_roc(p, y) - jmetrics.auc_roc(p, y)) <= 1e-12
    assert tmetrics.binary_accuracy(p, y) == jmetrics.binary_accuracy(p, y)
    assert 0.5 < tmetrics.auc_roc(p, y) < 1.0


def test_auc_roc_small_cases():
    assert tmetrics.auc_roc([0.1, 0.4, 0.35, 0.8], [0, 0, 1, 1]) == 0.75
    assert tmetrics.auc_roc([0.5, 0.5, 0.5], [0, 1, 1]) == 0.5  # all tied
    assert tmetrics.auc_roc([0.2, 0.9], [0, 1]) == 1.0
    for one_class in ([0, 0, 0], [1, 1, 1]):
        assert math.isnan(tmetrics.auc_roc([0.1, 0.5, 0.9], one_class))
        assert math.isnan(jmetrics.auc_roc([0.1, 0.5, 0.9], one_class))


@pytest.mark.parametrize("buckets", [1 << 14, 64])
def test_streaming_auc_buckets_match_jax(buckets, rng):
    """The same bucket of every prediction (the f32 product truncated
    toward zero, ``p == 1.0`` clipped into the last bucket), the same
    counts, the same AUC to 1e-12; tensors and arrays both go in."""
    ours, theirs = tmetrics.StreamingAUC(buckets), \
        jmetrics.StreamingAUC(buckets)
    for i, n in enumerate((300, 1, 257)):
        p, y = _preds(rng, max(n, 6), "ties" if i else "distinct")
        # values on and next to bucket edges
        edges = (np.arange(1, 40, dtype=np.float32) / buckets)
        p = np.concatenate([p, edges, np.nextafter(edges, np.float32(0))])
        y = np.concatenate([y, np.ones(39, np.float32),
                            np.zeros(39, np.float32)])
        if i % 2:
            ours.update(torch.from_numpy(p), torch.from_numpy(y))
        else:
            ours.update(p, y)
        theirs.update(jnp.asarray(p), jnp.asarray(y))
    np.testing.assert_array_equal(ours.pos, theirs.pos)
    np.testing.assert_array_equal(ours.neg, theirs.neg)
    assert ours.pos[-1] >= 3 or ours.neg[-1] >= 3  # the exact 1.0s
    assert abs(ours.compute() - theirs.compute()) <= 1e-12
    ours.reset()
    assert not ours.pos.any() and not ours.neg.any()
    assert math.isnan(ours.compute())


def test_streaming_auc_close_to_exact(rng):
    p, y = _preds(rng, 4000, "distinct")
    s = tmetrics.StreamingAUC()
    s.update(p[:1500], y[:1500])
    s.update(p[1500:], y[1500:])
    assert abs(s.compute() - tmetrics.auc_roc(p, y)) <= 1e-3
    one = tmetrics.StreamingAUC(16)
    one.update(p, np.ones_like(y))
    assert math.isnan(one.compute())


def test_every():
    calls = []
    ours = tmetrics.Every(lambda: calls.append("t"), 3)
    theirs = jmetrics.Every(lambda: calls.append("j"), 3)
    for _ in range(7):
        ours()
        theirs()
    assert calls == ["t", "j", "t", "j"] and ours.count == theirs.count == 7


@pytest.mark.parametrize("name,over", [
    ("gram", {}),
    ("fused_3hot", {"interaction_impl": "fused", "n_hot": 3}),
])
def test_evaluate_matches_jax(name, over):
    """Four batches of 48 and a ragged tail of 11 (every row counts)."""
    tcfg = dataclasses.replace(
        tc.tiny_config(feature_size=8), table_sizes=(6, 300, 9, 2000, 40),
        small_table_threshold=50, **over)
    jcfg, jparams, tparams = setup(tcfg)
    truth = ClickthroughModel(tcfg, seed=3)
    data = list(truth.stream(48, 4, seed=2))
    data.append(truth.batch(np.random.default_rng(9), 11))
    trec, jrec = [0.25], [0.25]
    got = tmetrics.evaluate(tparams, data, tcfg, record=trec)
    want = jmetrics.evaluate(jparams, data, jcfg, record=jrec)
    assert set(got) == set(want) == {"accuracy", "auc", "loss", "examples"}
    assert got["examples"] == want["examples"] == 4 * 48 + 11
    assert got["accuracy"] == want["accuracy"]
    assert trec == jrec == [0.25, got["accuracy"]]
    assert abs(got["auc"] - want["auc"]) <= 1e-6
    assert abs(got["loss"] - want["loss"]) <= 1e-6
    assert all(isinstance(v, (int, float)) for v in got.values())
    # tensors go in as well as arrays, and fewer buckets change only AUC
    as_tensors = [{k: torch.from_numpy(v) for k, v in b.items()}
                  for b in data]
    coarse = tmetrics.evaluate(tparams, as_tensors, tcfg, auc_buckets=32)
    assert coarse["loss"] == got["loss"]
    assert coarse["accuracy"] == got["accuracy"]
    assert abs(coarse["auc"] - got["auc"]) <= 0.05


def test_evaluate_of_nothing_and_against_scores():
    tcfg = tc.tiny_config()
    _, _, params = setup(tcfg)
    empty = tmetrics.evaluate(params, [], tcfg)
    assert empty["examples"] == 0 and empty["accuracy"] == 0.0
    assert math.isnan(empty["auc"]) and empty["loss"] == 0.0
    # the metrics of the scores that `predict` would write
    from dlrm_tpu_torch.run import score_batch
    rng = np.random.default_rng(0)
    data = [random_batch(rng, tcfg, n) for n in (32, 32, 5)]
    m = tmetrics.evaluate(params, data, tcfg)
    scores = np.concatenate([score_batch(params, b, tcfg,
                                         torch.device("cpu")) for b in data])
    labels = np.concatenate([b["labels"] for b in data])
    assert m["accuracy"] == tmetrics.binary_accuracy(scores, labels)
    assert abs(m["auc"] - tmetrics.auc_roc(scores, labels)) <= 1e-3
    assert not params["emb"].requires_grad
