"""Evaluation metrics: accuracy, ROC AUC (exact on the host, and
histogram-bucketed streaming on the device), the ``Every`` periodic-callback
combinator and ``evaluate`` -- the single-device part of
``dlrm_tpu/train/metrics.py``."""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch


def binary_accuracy(preds, labels) -> float:
    """Fraction of ``round(pred) == label``."""
    preds = np.asarray(preds).ravel()
    labels = np.asarray(labels).ravel()
    return float(np.mean((preds >= 0.5) == (labels >= 0.5)))


def auc_roc(preds, labels) -> float:
    """Exact ROC AUC via the rank statistic (Mann-Whitney U), with average
    ranks for ties.  Host-side numpy in f64; for streaming on the device use
    :class:`StreamingAUC`.  NaN when only one class is present."""
    preds = np.asarray(preds, np.float64).ravel()
    labels = np.asarray(labels).ravel() >= 0.5
    pos = labels.sum()
    neg = labels.size - pos
    if pos == 0 or neg == 0:
        return float("nan")
    order = np.argsort(preds, kind="mergesort")
    sorted_preds = preds[order]
    # a tie group spanning sorted positions i..j takes the average rank
    # (i + j) / 2 + 1
    new_group = np.r_[True, sorted_preds[1:] != sorted_preds[:-1]]
    starts = np.flatnonzero(new_group)
    ends = np.r_[starts[1:], labels.size] - 1
    group = np.cumsum(new_group) - 1
    ranks = np.empty(labels.size, np.float64)
    ranks[order] = 0.5 * (starts[group] + ends[group]) + 1.0
    pos_rank_sum = ranks[labels].sum()
    return float((pos_rank_sum - pos * (pos + 1) / 2) / (pos * neg))


class StreamingAUC:
    """Histogram-bucketed streaming AUC for large eval sets: O(buckets)
    memory, the bucket counts taken on the predictions' device, one small
    transfer a batch, the running sums kept on the host in f64.

    Predictions are sigmoid outputs in [0, 1], bucketed uniformly
    (``p == 1.0`` falls into the last bucket).  AUC is computed from the
    per-bucket positive/negative counts with the trapezoid (tie-averaged)
    correction: exact up to bucket resolution.
    """

    def __init__(self, num_buckets: int = 1 << 14):
        self.num_buckets = num_buckets
        self.pos = np.zeros(num_buckets, np.float64)
        self.neg = np.zeros(num_buckets, np.float64)

    def update(self, preds, labels) -> None:
        """``preds`` and ``labels``: tensors (any device) or arrays, (n,)."""
        n = self.num_buckets
        preds = torch.as_tensor(preds)
        labels = torch.as_tensor(labels).to(preds.device)
        # the f32 product truncated toward zero, then clipped
        b = (preds.float() * n).to(torch.int32).clamp_(0, n - 1).long()
        counts = torch.bincount(b + n * (labels >= 0.5), minlength=2 * n)
        counts = counts.cpu().numpy().astype(np.float64)
        self.neg += counts[:n]
        self.pos += counts[n:]

    def compute(self) -> float:
        pos, neg = self.pos, self.neg
        p, n = pos.sum(), neg.sum()
        if p == 0 or n == 0:
            return float("nan")
        # P(score_pos > score_neg) + 0.5 P(equal), bucket-resolution exact
        neg_below = np.concatenate([[0.0], np.cumsum(neg)[:-1]])
        u = (pos * (neg_below + 0.5 * neg)).sum()
        return float(u / (p * n))

    def reset(self) -> None:
        self.pos[:] = 0
        self.neg[:] = 0


class Every:
    """Run ``fn`` every ``n`` calls."""

    def __init__(self, fn: Callable[[], None], n: int):
        self.fn = fn
        self.n = int(n)
        self.count = 0

    def __call__(self) -> None:
        self.count += 1
        if self.count % self.n == 0:
            self.fn()


def _accumulate(data: Iterable, predict_batch: Callable, *,
                record: Optional[List[float]], auc_buckets: int
                ) -> Dict[str, float]:
    """The metric loop: accuracy, streaming AUC and mean loss over batches
    scored by ``predict_batch(batch) -> preds`` (a (b,) tensor)."""
    from dlrm_tpu_torch.ops.loss import bce_loss

    auc = StreamingAUC(auc_buckets)
    correct = 0
    total = 0
    loss_sum = 0.0
    for batch in data:
        preds = predict_batch(batch)
        host_labels = torch.as_tensor(batch["labels"])
        labels = host_labels.to(preds.device)
        auc.update(preds, labels)
        loss_sum += float(bce_loss(preds, labels)) * labels.shape[0]
        # one device-to-host copy of the predictions a batch
        p = preds.float().cpu().numpy()
        l = host_labels.cpu().numpy()
        correct += int(((p >= 0.5) == (l >= 0.5)).sum())
        total += l.shape[0]
    acc = correct / max(total, 1)
    if record is not None:
        record.append(acc)
    return {"accuracy": acc, "auc": auc.compute(),
            "loss": loss_sum / max(total, 1), "examples": total}


def evaluate(params: dict, data: Iterable, config, *,
             record: Optional[List[float]] = None,
             auc_buckets: int = 1 << 14) -> Dict[str, float]:
    """Full-dataset evaluation on the device of ``params``: accuracy,
    streaming AUC and mean loss over ``data`` (dicts with dense / sparse /
    labels, numpy or tensors; batches may differ in size, so a ragged tail
    counts).  ``record``, when given, gets the accuracy appended."""
    from dlrm_tpu_torch.models.dlrm import forward

    device = params["emb"].device

    def predict_batch(batch):
        dense = torch.as_tensor(batch["dense"]).to(device)
        sparse = torch.as_tensor(batch["sparse"]).to(device)
        with torch.inference_mode():
            return forward(params, dense, sparse, config)

    return _accumulate(data, predict_batch, record=record,
                       auc_buckets=auc_buckets)
