"""Evaluation metrics: accuracy, ROC AUC (exact on the host, and
histogram-bucketed streaming on the device), the ``Every`` periodic-callback
combinator, ``evaluate`` and its sharded twin ``sharded_evaluate`` -- the
counterpart of ``dlrm_tpu/train/metrics.py``."""

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
                record: Optional[List[float]], auc_buckets: int,
                mp_reduce: bool = False) -> Dict[str, float]:
    """The metric loop: accuracy, streaming AUC and mean loss over batches
    scored by ``predict_batch(batch) -> preds`` (a (b,) tensor; a batch
    with no labels adds nothing).

    ``mp_reduce``: every rank of the process group scores its own rows,
    and the counts (correct, total, the AUC histograms) and the loss sum
    are summed over the ranks at the end (:func:`_reduce_counts`), so each
    reports the metrics of every row."""
    from dlrm_tpu_torch.ops.loss import bce_loss

    auc = StreamingAUC(auc_buckets)
    correct = 0
    total = 0
    loss_sum = 0.0
    for batch in data:
        preds = predict_batch(batch)
        host_labels = torch.as_tensor(batch["labels"])
        if host_labels.shape[0] == 0:
            continue
        labels = host_labels.to(preds.device)
        auc.update(preds, labels)
        loss_sum += float(bce_loss(preds, labels)) * labels.shape[0]
        # one device-to-host copy of the predictions a batch
        p = preds.float().cpu().numpy()
        l = host_labels.cpu().numpy()
        correct += int(((p >= 0.5) == (l >= 0.5)).sum())
        total += l.shape[0]
    if mp_reduce:
        correct, total, loss_sum = _reduce_counts(correct, total, auc,
                                                  loss_sum)
    acc = correct / max(total, 1)
    if record is not None:
        record.append(acc)
    return {"accuracy": acc, "auc": auc.compute(),
            "loss": loss_sum / max(total, 1), "examples": total}


def _reduce_counts(correct: int, total: int, auc: StreamingAUC,
                   loss_sum: float):
    """Sum the counters over every rank of the default process group: the
    counts as int64 (exact at any size), the loss sum in f64; ``auc``'s
    histograms in place.  Returns (correct, total, loss_sum)."""
    import torch.distributed as dist

    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend() == "nccl" else torch.device("cpu"))
    counts = torch.as_tensor(np.concatenate(
        [np.asarray([correct, total], np.int64), auc.pos.astype(np.int64),
         auc.neg.astype(np.int64)]), device=device)
    loss = torch.tensor([loss_sum], dtype=torch.float64, device=device)
    dist.all_reduce(counts)
    dist.all_reduce(loss)
    counts = counts.cpu().numpy()
    n = auc.num_buckets
    auc.pos = counts[2:2 + n].astype(np.float64)
    auc.neg = counts[2 + n:].astype(np.float64)
    return int(counts[0]), int(counts[1]), float(loss.item())


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


def make_sharded_eval_forward(config, mesh, placement, axis: str = "d"
                              ) -> Callable:
    """The sharded forward of this rank's rows: ``fwd(dense_params, emb,
    cs, dense, sparse, emb_h=None, scales=None, cs_scales=()) -> (b,)
    predictions``, the sharded lookup (``parallel/embedding
    .sharded_lookup``; ``emb_h`` the host stack of host-resident tables;
    ``scales`` and ``cs_scales`` those of int8 tables) then the model's
    ``forward_from_pooled``.  Every rank of the mesh calls it with the
    same number of rows."""
    from dlrm_tpu_torch.models.dlrm import forward_from_pooled
    from dlrm_tpu_torch.parallel.embedding import sharded_lookup
    from dlrm_tpu_torch.utils.telemetry import phase_scope

    def fwd(dense_params, emb, cs, dense, sparse, emb_h=None, scales=None,
            cs_scales=()):
        with torch.no_grad():
            with phase_scope("lookup"):
                pooled = sharded_lookup(
                    emb, sparse, mesh=mesh, placement=placement, axis=axis,
                    cs=cs, emb_h=emb_h, exchange_dtype=config.exchange_dtype,
                    scales=scales, cs_scales=cs_scales)
            return forward_from_pooled(dense_params, pooled, dense, config)

    return fwd


def sharded_evaluate(params: dict, data: Iterable, config, *, mesh,
                     placement, axis: str = "d",
                     record: Optional[List[float]] = None,
                     auc_buckets: int = 1 << 14,
                     local_batch: bool = False) -> Dict[str, float]:
    """:func:`evaluate` on this rank's sharded parameters (as
    ``train.sharded_train_step`` takes them; int8 tables with their
    ``emb_scales`` and ``emb_cs_scales``); every rank of the mesh calls it
    with the same global batches and gets the metrics of every row.

    A rank scores its rows of each batch (``parallel.mesh
    .local_batch_rows``).  A batch that does not divide by the mesh's
    ranks (a ragged tail) is padded by repeating its last row and the
    padded predictions are dropped, so every row counts once.
    ``local_batch``: each rank is fed its own rows of every batch (the
    same number on every rank: full batches only), taken as they come."""
    from dlrm_tpu_torch.parallel.mesh import local_batch_rows

    fwd = make_sharded_eval_forward(config, mesh, placement, axis)
    dense_params = {"bottom": params["bottom"], "top": params["top"]}
    emb, cs = params["emb"], tuple(params.get("emb_cs", ()))
    emb_h = params.get("emb_h")
    scales = params.get("emb_scales")
    cs_scales = tuple(params.get("emb_cs_scales", ()))
    ranks = mesh.mesh.numel()

    def local_batches():
        if local_batch:
            for batch in data:
                yield {k: torch.as_tensor(batch[k])
                       for k in ("dense", "sparse", "labels")}
            return
        for batch in data:
            dense, sparse, labels = (torch.as_tensor(batch[k]) for k in
                                     ("dense", "sparse", "labels"))
            b = dense.shape[0]
            pad = -b % ranks
            if pad:
                dense = torch.cat([dense, dense[-1:].expand(
                    pad, *dense.shape[1:])])
                sparse = torch.cat([sparse, sparse[-1:].expand(
                    pad, *sparse.shape[1:])])
            lo, hi = local_batch_rows(mesh, b + pad)
            yield {"dense": dense[lo:hi], "sparse": sparse[lo:hi],
                   "labels": labels[lo:max(lo, min(hi, b))]}

    def predict_batch(batch):
        preds = fwd(dense_params, emb, cs, batch["dense"].to(emb.device),
                    batch["sparse"].to(emb.device), emb_h, scales,
                    cs_scales)
        return preds[:batch["labels"].shape[0]]

    return _accumulate(local_batches(), predict_batch, record=record,
                       auc_buckets=auc_buckets, mp_reduce=True)
