"""Single-device training: the counterpart of the single-device part of
``dlrm_tpu/train/train.py`` (``train_step``, ``train_step_opt``,
``train_block``, ``train_block_opt``, their makers, and ``train``).

One step: gather every table's rows outside autograd, take the gradients
of the loss with respect to the dense parameters and the gathered rows
(``torch.autograd.grad``; nothing is accumulated in ``.grad``), apply dense
SGD ``p -= lr * g``, then sparse SGD as one ``index_add_`` that sums
duplicate ids.  Table gradients are never densified.  The parameters (and
the optimizer state) are updated in place, which stands in for the JAX
package's buffer donation.

``train_step_opt`` adds the optimizers of ``train/optim.py`` and global-norm
clipping.  ``train_block`` / ``train_block_opt`` fuse K micro-steps: the
dense parameters and the small tables update every micro-step, the big
tables' gradients are taken at their block-entry rows and applied once at
block end.
"""

from __future__ import annotations

import functools
import time
from typing import Any, Callable, Dict, Iterable, NamedTuple, Optional

import numpy as np
import torch

from dlrm_tpu_torch.config import DLRMConfig
from dlrm_tpu_torch.models import dlrm as model_lib
from dlrm_tpu_torch.ops import embedding as emb_ops
from dlrm_tpu_torch.train import optim


class TrainState(NamedTuple):
    params: dict
    step: torch.Tensor


def init_train_state(generator: torch.Generator, config: DLRMConfig,
                     device: Optional[torch.device] = None) -> TrainState:
    params = model_lib.init_params(generator, config, device)
    return TrainState(params=params,
                      step=torch.zeros((), dtype=torch.int32,
                                       device=params["emb"].device))


def train_step(params: dict, dense: torch.Tensor, sparse: torch.Tensor,
               labels: torch.Tensor, *, config: DLRMConfig,
               lr: float) -> torch.Tensor:
    """One SGD step on ``params``, in place; returns the loss as a 0-d
    tensor (no host sync).  ``dense``, ``sparse`` and ``labels`` lie on the
    parameters' device.

    The JAX package takes small tables through a one-hot matmul whose
    gradient is a dense slice; here every table is gathered and updated by
    the scatter-add, with the same pooled values (``mixed_pool``) and the
    same per-row sums.
    """
    dense_params, emb = model_lib.split_params(params)
    value_and_grad = emb_ops.sparse_value_and_grad(
        functools.partial(_loss, config=config),
        pool_fn=functools.partial(emb_ops.mixed_pool, config=config))
    loss, (dgrads, sgrad) = value_and_grad(
        dense_params, emb, sparse, config.table_offsets, dense, labels)
    with torch.no_grad():
        for p, g in zip(emb_ops.tree_leaves(dense_params),
                        emb_ops.tree_leaves(dgrads)):
            p.sub_(g * lr)
        emb_ops.apply_sparse_sgd(emb, sgrad, lr)
    return loss


def _loss(dense_params, pooled, dense, labels, *, config):
    return model_lib.loss_from_pooled(dense_params, pooled, dense, labels,
                                      config)


def make_train_step(config: DLRMConfig, lr) -> Callable:
    """``step(params, dense, sparse, labels) -> loss``.  ``lr`` is a float
    or a schedule (step -> lr, ``train.optim.make_schedule``); a schedule
    is read at ``step.step``, which counts calls (set it to resume)."""
    if not callable(lr):
        lr32 = float(np.float32(lr))  # the JAX package's f32 learning rate
        return lambda p, d, s, l: train_step(p, d, s, l, config=config,
                                             lr=lr32)

    def run(p, d, s, l):
        lr_val = float(np.float32(lr(run.step)))
        run.step += 1
        return train_step(p, d, s, l, config=config, lr=lr_val)

    run.step = 0
    return run


# -- pluggable optimizer, clipping, coalesced blocks ---------------------------

def _f32(x) -> float:
    """A learning rate as the f32 value the JAX package computes with."""
    return float(np.float32(x))


def init_opt_state(params: dict, *, config: DLRMConfig, optimizer: str
                   ) -> dict:
    """Optimizer state: ``dense`` (None for sgd, else an accumulator per
    dense parameter, in the parameter tree's shape), ``emb`` (None, or the
    accumulator of ``optim.init_emb_state``) and ``count``, the number of
    steps taken (an int; a schedule is read at it)."""
    dense_params, emb = model_lib.split_params(params)
    return {"dense": optim.init_dense_state(optimizer, dense_params),
            "emb": optim.init_emb_state(config, optimizer, emb),
            "count": 0}


def _micro_step(params: dict, opt_state: Optional[dict], dense, sparse,
                labels, *, config: DLRMConfig, optimizer: str, lr: float,
                grad_clip_norm) -> tuple:
    """Gradients at the current parameters, the optional clip, then the
    updates that are never deferred: the dense parameters and the small
    tables (``config.small_table_threshold``), in place.  Returns (loss,
    the big tables' per-hit SparseGrad or None), clipped but not applied.

    The clip's norm counts what the JAX package's counts: dense gradients,
    big-table rows once per hit, and small-table rows with a row's hits
    summed first."""
    dense_params, emb = model_lib.split_params(params)
    value_and_grad = emb_ops.sparse_value_and_grad(
        functools.partial(_loss, config=config),
        pool_fn=functools.partial(emb_ops.mixed_pool, config=config))
    loss, (dgrads, sgrad) = value_and_grad(
        dense_params, emb, sparse, config.table_offsets, dense, labels)
    small_t, big_t = emb_ops.partition_tables(config.table_sizes,
                                              config.small_table_threshold)
    batch, tables = sparse.shape[0], config.num_tables
    big = small = small_sum = None
    if big_t:
        big = sgrad if not small_t else emb_ops.split_by_tables(
            sgrad, batch, tables, big_t)
    if small_t:
        small = sgrad if not big_t else emb_ops.split_by_tables(
            sgrad, batch, tables, small_t)
    adagrad = optimizer != "sgd"
    with torch.no_grad():
        if small is not None and (adagrad or grad_clip_norm is not None):
            small_sum = emb_ops.sum_duplicates(small)
            small_sum = small_sum._replace(
                rows=small_sum.rows.to(small.rows.dtype))
        grads = emb_ops.tree_leaves(dgrads)
        if grad_clip_norm is not None:
            sparse_parts = [g for g in (big, small_sum) if g is not None]
            clipped, _ = optim.clip_by_global_norm(
                grad_clip_norm, grads + [g.rows for g in sparse_parts])
            grads = clipped[:len(grads)]
            scaled = iter(clipped[len(grads):])
            if big is not None:
                big = big._replace(rows=next(scaled))
            if small_sum is not None:
                small_sum = small_sum._replace(rows=next(scaled))
        optim.apply_dense(
            optimizer, emb_ops.tree_leaves(dense_params), grads,
            emb_ops.tree_leaves(opt_state["dense"]) if adagrad else None, lr)
        if adagrad:
            if small_sum is not None:
                optim.apply_adagrad_rows(
                    emb, opt_state["emb"], small_sum.ids,
                    small_sum.rows.float(), lr,
                    rowwise=optimizer == "rowwise_adagrad")
        elif small is not None:
            emb_ops.apply_sparse_sgd(
                emb, small if small_sum is None else small_sum, lr)
    return loss, big


def _apply_big(emb, opt_state, big: emb_ops.SparseGrad, *, optimizer: str,
               lr: float, scaled_rows=None) -> None:
    """The deferred big-table update.  With ``scaled_rows`` (rows already
    multiplied by their own micro-step's lr) the update applies with lr 1."""
    with torch.no_grad():
        if optimizer == "sgd":
            if scaled_rows is not None:
                big, lr = big._replace(rows=scaled_rows), 1.0
            emb_ops.apply_sparse_sgd(emb, big, lr)
        else:
            optim.apply_sparse_adagrad(
                emb, opt_state["emb"], big, lr,
                rowwise=optimizer == "rowwise_adagrad",
                scaled_rows=scaled_rows)


def train_step_opt(params: dict, opt_state: dict, dense, sparse, labels, *,
                   config: DLRMConfig, optimizer: str, lr,
                   emb_impl: str = "dedup", grad_clip_norm=None
                   ) -> torch.Tensor:
    """One step with a pluggable optimizer (``sgd``, ``adagrad``,
    ``rowwise_adagrad``) on ``params`` and ``opt_state``, both in place;
    returns the loss (0-d, no host sync).

    ``optimizer='sgd'`` without a clip gives :func:`train_step`'s result.
    ``lr``: a float, or a schedule read at ``opt_state['count']``.
    ``grad_clip_norm``: global-norm clip over everything autograd produced
    (``optim.clip_by_global_norm``) before the updates.  ``emb_impl`` takes
    the JAX package's names and every one runs ``optim.apply_sparse_adagrad``
    (see ``optim.check_emb_impl``).
    """
    optim.check_optimizer(optimizer)
    optim.check_emb_impl(emb_impl)
    lr_t = _f32(lr(opt_state["count"]) if callable(lr) else lr)
    loss, big = _micro_step(params, opt_state, dense, sparse, labels,
                            config=config, optimizer=optimizer, lr=lr_t,
                            grad_clip_norm=grad_clip_norm)
    if big is not None:
        _apply_big(params["emb"], opt_state, big, optimizer=optimizer,
                   lr=lr_t)
    opt_state["count"] += 1
    return loss


def make_train_step_opt(config: DLRMConfig, *, optimizer: str = "sgd",
                        lr=0.1, emb_impl: str = "dedup",
                        grad_clip_norm=None) -> Callable:
    """``step(params, opt_state, dense, sparse, labels) -> loss``."""
    return functools.partial(train_step_opt, config=config,
                             optimizer=optimizer, lr=lr, emb_impl=emb_impl,
                             grad_clip_norm=grad_clip_norm)


def _run_block(params: dict, opt_state: Optional[dict], dense, sparse,
               labels, *, config: DLRMConfig, optimizer: str, lrs,
               scheduled: bool, grad_clip_norm) -> torch.Tensor:
    """K micro-steps (K is the batch's leading dimension), then one
    coalesced big-table update.  ``lrs``: the K f32 learning rates; with
    ``scheduled`` each micro-step's big-table rows are scaled by its own lr
    and the coalesced update applies with lr 1."""
    losses, ids, rows, scaled = [], [], [], []
    for k in range(dense.shape[0]):
        loss, big = _micro_step(params, opt_state, dense[k], sparse[k],
                                labels[k], config=config,
                                optimizer=optimizer, lr=lrs[k],
                                grad_clip_norm=grad_clip_norm)
        losses.append(loss)
        if big is not None:
            ids.append(big.ids)
            rows.append(big.rows)
            if scheduled:
                scaled.append(big.rows.float() * lrs[k])
    if ids:
        _apply_big(params["emb"], opt_state,
                   emb_ops.SparseGrad(torch.cat(ids), torch.cat(rows)),
                   optimizer=optimizer, lr=lrs[0],
                   scaled_rows=torch.cat(scaled) if scheduled else None)
    return torch.stack(losses)


def train_block(params: dict, dense, sparse, labels, *, config: DLRMConfig,
                lr, grad_clip_norm=None) -> torch.Tensor:
    """K SGD micro-steps on ``params``, in place, with the
    big-table updates coalesced into one ``index_add_`` at block end;
    returns the K losses (a (K,) tensor, no host sync).

    ``dense`` (K, B, 13), ``sparse`` (K, B, T[, H]), ``labels`` (K, B).
    ``lr``: a float, or K per-micro-step values (a schedule).

    The forward of micro-step k reads big-table rows as of block entry
    (stale by fewer than K steps).  Dense parameters and small
    tables update every micro-step.  The big tables' scatter-adds commute,
    so when no big-table id repeats across the micro-batches the block
    equals K sequential :func:`train_step` calls, and K=1 always does.  ``grad_clip_norm`` clips each micro-step as
    :func:`train_step_opt` does.
    """
    scheduled = np.ndim(lr) != 0
    lrs = ([_f32(x) for x in lr] if scheduled
           else [_f32(lr)] * dense.shape[0])
    return _run_block(params, None, dense, sparse, labels, config=config,
                      optimizer="sgd", lrs=lrs, scheduled=scheduled,
                      grad_clip_norm=grad_clip_norm)


def make_train_block(config: DLRMConfig, lr, grad_clip_norm=None
                     ) -> Callable:
    """``step(params, (K,B,13), (K,B,T[,H]), (K,B)) -> (K,) losses``; K is
    the batch's leading dimension.  ``lr`` is a float or a schedule; a
    schedule is read at ``step.step + k``, and ``step.step`` advances by K
    a call (set it to resume)."""
    if not callable(lr):
        return functools.partial(train_block, config=config, lr=lr,
                                 grad_clip_norm=grad_clip_norm)

    def run(p, d, s, l):
        k = d.shape[0]
        lrs = [lr(run.step + i) for i in range(k)]
        run.step += k
        return train_block(p, d, s, l, config=config, lr=lrs,
                           grad_clip_norm=grad_clip_norm)

    run.step = 0
    return run


def train_block_opt(params: dict, opt_state: dict, dense, sparse, labels, *,
                    config: DLRMConfig, lr,
                    adagrad_impl: str = "dense_g", unroll: bool = True,
                    optimizer: str = "adagrad", grad_clip_norm=None
                    ) -> torch.Tensor:
    """Coalesced K-step block with sparse Adagrad or row-wise Adagrad on
    ``params`` and ``opt_state``, in place (see :func:`train_block` for
    the staleness contract; SGD blocks go there).  Returns the K losses.

    Dense parameters and small tables get a true per-micro-step Adagrad.
    Big-table gradients are taken at block-entry rows and applied at block
    end with one dedup-then-apply Adagrad: when no big-table id repeats
    across the micro-batches the block equals K sequential
    :func:`train_step_opt` calls; a repeated row gets one accumulator
    update with the summed gradient.

    ``lr``: a float, or a schedule read at ``opt_state['count'] + k`` (the
    big-table update then carries the twin payload ``(g, lr_k * g)``).
    ``adagrad_impl`` (``dedup`` or ``dense_g``) and ``unroll`` are the JAX
    package's cost knobs: both values of each run the same Python loop and
    the same ``optim.apply_sparse_adagrad``.
    """
    del unroll
    if optimizer not in ("adagrad", "rowwise_adagrad"):
        raise ValueError(f"train_block_opt runs adagrad or rowwise_adagrad, "
                         f"got {optimizer!r}; SGD blocks use train_block")
    if adagrad_impl not in ("dedup", "dense_g"):
        raise ValueError(f"unknown adagrad_impl {adagrad_impl!r}")
    k = dense.shape[0]
    count = opt_state["count"]
    scheduled = callable(lr)
    lrs = [_f32(lr(count + i) if scheduled else lr) for i in range(k)]
    losses = _run_block(params, opt_state, dense, sparse, labels,
                        config=config, optimizer=optimizer, lrs=lrs,
                        scheduled=scheduled, grad_clip_norm=grad_clip_norm)
    opt_state["count"] = count + k
    return losses


def make_train_block_opt(config: DLRMConfig, *, optimizer: str, lr,
                         adagrad_impl: str = "dense_g", unroll: bool = True,
                         grad_clip_norm=None) -> Callable:
    """``step(params, opt_state, (K,B,13), (K,B,T[,H]), (K,B)) -> (K,)
    losses``; K is the batch's leading dimension.  The schedule's count
    lives in ``opt_state``."""
    return functools.partial(train_block_opt, config=config, lr=lr,
                             adagrad_impl=adagrad_impl, unroll=unroll,
                             optimizer=optimizer,
                             grad_clip_norm=grad_clip_norm)


def batch_to_device(batch: Dict[str, Any], device: torch.device
                    ) -> Dict[str, torch.Tensor]:
    """A batch dict of numpy arrays or tensors -> tensors on ``device``
    (plain copies)."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def train(params: dict, data: Iterable, *, config: DLRMConfig, lr,
          maxiters: Optional[int] = None,
          callback: Optional[Callable[[int, float], None]] = None,
          sync_every: int = 1) -> Dict[str, Any]:
    """Host loop over batches (dicts with dense/sparse/labels, numpy or
    tensors), on the device of ``params``, which it updates in place.

    Returns ``{"params", "losses", "iteration_times"}`` as the JAX package's
    ``train`` does.  ``sync_every``: read the loss (a host sync) every N
    steps; with N > 1, ``losses`` and ``iteration_times`` (mean ns per step
    over the window) hold one entry per synced step, and ``callback(step,
    loss)`` fires on those steps only.
    """
    if sync_every < 1:
        raise ValueError(f"sync_every must be >= 1, got {sync_every}")
    device = params["emb"].device
    step_fn = make_train_step(config, lr)
    losses, iteration_times = [], []
    count = 0
    pending = None
    start = time.perf_counter_ns()

    def sync(loss, window):
        nonlocal start
        loss = float(loss)
        now = time.perf_counter_ns()
        iteration_times.append((now - start) // window)
        start = now
        losses.append(loss)
        if callback is not None:
            callback(count - 1, loss)

    for batch in data:
        b = batch_to_device(batch, device)
        loss = step_fn(params, b["dense"], b["sparse"], b["labels"])
        count += 1
        if count % sync_every == 0:
            sync(loss, sync_every)
            pending = None
        else:
            pending = loss
        if maxiters is not None and count >= maxiters:
            break
    if pending is not None:  # the stream ended between sync points
        sync(pending, count % sync_every)
    return {"params": params, "losses": losses,
            "iteration_times": iteration_times}
