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

``sharded_train_step``, ``sharded_train_step_opt``, ``sharded_train_block``
and ``sharded_train_block_opt`` are the hybrid-parallel steps of one rank
of a gang (``parallel/embedding.py``, ``parallel/mesh.py``), with the
optimizer state of ``init_sharded_opt_state``.

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
from dlrm_tpu_torch.ops.quant import QuantEmb
from dlrm_tpu_torch.train import optim
from dlrm_tpu_torch.utils.telemetry import phase_scope


def _split_trainable(params: dict):
    """(dense_params, emb) of parameters that can be trained: int8 tables
    are post-training serving storage; two-tier tables train through
    ``parallel/host_tier.py``."""
    from dlrm_tpu_torch.parallel.host_tier import TieredEmb

    if isinstance(params["emb"], TieredEmb):
        raise TypeError("the embedding tables are two-tier (TieredEmb): "
                        "train them with parallel.host_tier's "
                        "tiered_train_* steps")
    if isinstance(params["emb"], QuantEmb):
        raise TypeError("the embedding tables are int8 (QuantEmb): "
                        "quantized tables serve (forward, evaluate, "
                        "predict) and cannot be trained; train the f32 or "
                        "bf16 tables and quantize afterwards")
    return model_lib.split_params(params)


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
    dense_params, emb = _split_trainable(params)
    value_and_grad = emb_ops.sparse_value_and_grad(
        functools.partial(_loss, config=config),
        pool_fn=functools.partial(emb_ops.mixed_pool, config=config))
    loss, (dgrads, sgrad) = value_and_grad(
        dense_params, emb, sparse, config.table_offsets, dense, labels)
    with torch.no_grad():
        optim.apply_dense("sgd", emb_ops.tree_leaves(dense_params),
                          emb_ops.tree_leaves(dgrads), None, lr)
        with phase_scope("sparse_update"):
            emb_ops.apply_sparse_sgd(emb, sgrad, lr)
    optim.count_hits(emb, sgrad.ids.numel())
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
    dense_params, emb = _split_trainable(params)
    return {"dense": optim.init_dense_state(optimizer, dense_params),
            "emb": optim.init_emb_state(config, optimizer, emb),
            "count": 0}


def _micro_step(params: dict, opt_state: Optional[dict], dense, sparse,
                labels, *, config: DLRMConfig, optimizer: str, lr: float,
                grad_clip_norm, value_and_grad: Optional[Callable] = None,
                apply_big: bool = False) -> tuple:
    """Gradients at the current parameters, the optional clip, then the
    updates that are never deferred: the dense parameters and the small
    tables (``config.small_table_threshold``), in place.  Returns (loss,
    the big tables' per-hit SparseGrad or None), clipped but not applied.
    With ``apply_big`` the big tables are updated here as well and None
    takes their place; where ``optim.takes_sorted_update`` says so, every
    table is then updated in one sorted segment sum, with no split by
    table group.

    The clip's norm counts what the JAX package's counts: dense gradients,
    big-table rows once per hit, and small-table rows with a row's hits
    summed first.

    ``value_and_grad``: a function of the form that
    :func:`emb_ops.sparse_value_and_grad` returns (default: that one over
    ``params["emb"]``); the two-tier steps pass one over both tiers that
    hands back the device tier's gradient."""
    dense_params, emb = _split_trainable(params)
    if value_and_grad is None:
        value_and_grad = emb_ops.sparse_value_and_grad(
            functools.partial(_loss, config=config),
            pool_fn=functools.partial(emb_ops.mixed_pool, config=config))
    loss, (dgrads, sgrad) = value_and_grad(
        dense_params, emb, sparse, config.table_offsets, dense, labels)
    if apply_big and optim.takes_sorted_update(optimizer, emb,
                                               grad_clip_norm):
        with torch.no_grad():
            optim.apply_dense(optimizer, emb_ops.tree_leaves(dense_params),
                              emb_ops.tree_leaves(dgrads),
                              emb_ops.tree_leaves(opt_state["dense"]), lr)
            optim.apply_sorted_rowwise(emb, opt_state["emb"], sgrad, lr)
        return loss, None
    optim.count_hits(emb, sgrad.ids.numel())
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
        with phase_scope("sparse_update"):
            if adagrad:
                if small_sum is not None:
                    optim.apply_adagrad_rows(
                        emb, opt_state["emb"], small_sum.ids,
                        small_sum.rows.float(), lr,
                        rowwise=optimizer == "rowwise_adagrad")
            elif small is not None:
                emb_ops.apply_sparse_sgd(
                    emb, small if small_sum is None else small_sum, lr)
    if apply_big and big is not None:
        _apply_big(emb, opt_state, big, optimizer=optimizer, lr=lr)
        big = None
    return loss, big


def _apply_big(emb, opt_state, big: emb_ops.SparseGrad, *, optimizer: str,
               lr: float, scaled_rows=None) -> None:
    """The deferred big-table update.  With ``scaled_rows`` (rows already
    multiplied by their own micro-step's lr) the update applies with lr 1."""
    with torch.no_grad(), phase_scope("sparse_update"):
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
    the JAX package's names and every one runs the same update (see
    ``optim.check_emb_impl``): row-wise Adagrad without a clip on f32
    tables on the card, one sorted segment sum over every table
    (``optim.apply_sorted_rowwise``); anything else
    ``optim.apply_sparse_adagrad``.
    """
    optim.check_optimizer(optimizer)
    optim.check_emb_impl(emb_impl)
    lr_t = _f32(lr(opt_state["count"]) if callable(lr) else lr)
    loss, _ = _micro_step(params, opt_state, dense, sparse, labels,
                          config=config, optimizer=optimizer, lr=lr_t,
                          grad_clip_norm=grad_clip_norm, apply_big=True)
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
               scheduled: bool, grad_clip_norm,
               value_and_grad: Optional[Callable] = None) -> torch.Tensor:
    """K micro-steps (K is the batch's leading dimension), then one
    coalesced big-table update.  ``lrs``: the K f32 learning rates; with
    ``scheduled`` each micro-step's big-table rows are scaled by its own lr
    and the coalesced update applies with lr 1.  ``value_and_grad``: see
    :func:`_micro_step`."""
    losses, ids, rows, scaled = [], [], [], []
    for k in range(dense.shape[0]):
        loss, big = _micro_step(params, opt_state, dense[k], sparse[k],
                                labels[k], config=config,
                                optimizer=optimizer, lr=lrs[k],
                                grad_clip_norm=grad_clip_norm,
                                value_and_grad=value_and_grad)
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


# -- the sharded step (parallel/embedding.py) -----------------------------------

def broadcast_dense(params: dict) -> None:
    """Give every rank rank 0's dense parameters, in place (one flat
    buffer): the sharded step keeps them replicated from there on, so they
    are never drawn per rank."""
    import torch.distributed as dist

    leaves = emb_ops.tree_leaves(model_lib.split_params(params)[0])
    flat = torch.cat([p.reshape(-1) for p in leaves])
    dist.broadcast(flat, src=0)
    for p, q in zip(leaves, torch.split(flat, [p.numel() for p in leaves])):
        p.copy_(q.view_as(p))


def _sharded_parts(params: dict):
    """(dense parameters, local stack, column shards, host stack or None)
    of a rank's sharded parameters."""
    dense_params, emb = _split_trainable(params)
    return (dense_params, emb, tuple(params.get("emb_cs", ())),
            params.get("emb_h"))


def _local_rows(mesh, emb, *batch, leading: int = 0,
                local_batch: bool = False):
    """This rank's rows of a global batch (axis ``leading``: 1 for a
    block's (K, B, ...)) on the tables' device; ``local_batch``: the batch
    holds only this rank's rows already (each rank fed its own,
    ``run._batch_iter(rows=)``), taken as it is."""
    from dlrm_tpu_torch.parallel.mesh import local_batch_rows

    if local_batch:
        return [t.to(emb.device) for t in batch]
    lo, hi = local_batch_rows(mesh, batch[0].shape[leading])
    return [t.narrow(leading, lo, hi - lo).to(emb.device) for t in batch]


def _sharded_grads(params: dict, dense, sparse, labels, *,
                   config: DLRMConfig, mesh, placement, axis: str,
                   grad_clip_norm=None):
    """One rank's share of a sharded step's gradients, on its local rows
    (``dense``, ``sparse``, ``labels`` on the tables' device): (the global
    loss, the dense gradients summed over every rank, as one flat buffer,
    ``d_pooled`` (b, T, D) of this rank's rows).

    The loss and the gradients are those of the global mean: the local
    backward carries ``1 / ranks``, so ``d_pooled`` carries ``1 / B``, and
    the dense gradients and the loss are summed over every rank in one
    all-reduce of one flat buffer.  The lookup runs outside autograd, as
    of the tables now.

    ``grad_clip_norm``: the global norm is the JAX package's sharded one,
    over the dense gradients and ``d_pooled`` (pooled rows, not hits): the
    squares of ``d_pooled`` ride in the same all-reduce, and both are
    scaled after it."""
    import torch.distributed as dist
    from dlrm_tpu_torch.parallel import embedding as pemb

    dense_params, emb, cs, emb_h = _sharded_parts(params)
    with phase_scope("lookup"):
        pooled = pemb.sharded_lookup(
            emb, sparse, mesh=mesh, placement=placement, axis=axis, cs=cs,
            emb_h=emb_h, exchange_dtype=config.exchange_dtype)
    pooled.requires_grad_()
    live = emb_ops.tree_map(lambda p: p.detach().requires_grad_(),
                            dense_params)
    loss = _loss(live, pooled, dense, labels, config=config)
    leaves = emb_ops.tree_leaves(live)
    share = torch.full((), 1.0 / mesh.mesh.numel(), dtype=loss.dtype,
                       device=loss.device)
    with phase_scope("autograd.bwd"):
        grads = torch.autograd.grad(loss, leaves + [pooled],
                                    grad_outputs=share)
    d_pooled = grads[-1]
    with torch.no_grad():
        tail = [(loss * share).reshape(1)]
        if grad_clip_norm is not None:
            tail.append(d_pooled.float().square().sum().reshape(1))
        flat = torch.cat([g.reshape(-1) for g in grads[:-1]] + tail)
        with phase_scope("dense_allreduce"):
            dist.all_reduce(flat)
        n_dense = flat.numel() - len(tail)
        if grad_clip_norm is not None:
            with phase_scope("grad_clip"):
                scale, _ = optim.clip_scale(
                    grad_clip_norm,
                    flat[:n_dense].float().square().sum() + flat[-1])
                flat[:n_dense] = flat[:n_dense] * scale
                d_pooled = (d_pooled.float() * scale).to(d_pooled.dtype)
    return flat[n_dense], flat[:n_dense], d_pooled


def _dense_apply(params: dict, flat, optimizer: str, accs, lr: float
                 ) -> None:
    """The dense step from the flat all-reduced gradient, in place."""
    leaves = emb_ops.tree_leaves(model_lib.split_params(params)[0])
    grads = [g.view_as(p) for p, g in zip(
        leaves, torch.split(flat, [p.numel() for p in leaves]))]
    with torch.no_grad():
        optim.apply_dense(optimizer, leaves, grads,
                          None if accs is None else emb_ops.tree_leaves(accs),
                          lr)


def sharded_train_step(params: dict, dense, sparse, labels, *,
                       config: DLRMConfig, lr: float, mesh, placement,
                       axis: str = "d", local_batch: bool = False
                       ) -> torch.Tensor:
    """One hybrid-parallel SGD step on this rank's parameters, in place;
    returns the global batch's loss (0-d, no host sync).

    ``params``: ``{"bottom", "top", "emb": (local_rows, D), "emb_cs":
    ((R_t, D/N), ...), "emb_h": (host_local_rows, D)}`` (``emb_cs`` and
    ``emb_h`` where the placement has such tables), the rank's shard
    (``parallel.embedding``), the dense parameters the same on every rank
    (:func:`broadcast_dense`).  ``dense`` / ``sparse`` / ``labels`` are
    the global batch, the same on every rank, which takes its rows
    (``parallel.mesh.local_batch_rows``; the batch must divide by the
    mesh's ranks) to the parameters' device; with ``local_batch`` they are
    this rank's rows of it already (every rank's the same number).  The
    gradients are those of the global mean (:func:`_sharded_grads`)."""
    from dlrm_tpu_torch.parallel import embedding as pemb

    _, emb, cs, emb_h = _sharded_parts(params)
    dense, sparse, labels = _local_rows(mesh, emb, dense, sparse, labels,
                                        local_batch=local_batch)
    loss, flat, d_pooled = _sharded_grads(
        params, dense, sparse, labels, config=config, mesh=mesh,
        placement=placement, axis=axis)
    _dense_apply(params, flat, "sgd", None, lr)
    with phase_scope("sparse_update"):
        pemb.sharded_update_sgd(emb, sparse, d_pooled, lr, mesh=mesh,
                                placement=placement, axis=axis, cs=cs,
                                emb_h=emb_h,
                                exchange_dtype=config.exchange_dtype)
    optim.count_hits(emb, sparse.numel())  # the rank's hits
    return loss


def make_sharded_train_step(config: DLRMConfig, lr: float, mesh, placement,
                            axis: str = "d", local_batch: bool = False
                            ) -> Callable:
    """``step(params, dense, sparse, labels) -> loss`` of
    :func:`sharded_train_step` at the f32 learning rate."""
    return functools.partial(sharded_train_step, config=config,
                             lr=_f32(lr), mesh=mesh, placement=placement,
                             axis=axis, local_batch=local_batch)


def init_sharded_opt_state(params: dict, *, config: DLRMConfig,
                           optimizer: str) -> dict:
    """Optimizer state of a rank's sharded parameters:

    * ``dense``: None (sgd) or an accumulator per dense parameter, as
      :func:`init_opt_state`'s;
    * ``count``: the steps taken (an int; a schedule is read at it);
    * ``emb_acc``: None (sgd); ``(local_rows, D)`` f32 (adagrad) or
      ``(local_rows,)`` (rowwise_adagrad) beside the local stack;
    * ``emb_acc_cs``: one per column shard, ``(R_t, D/N)`` (adagrad: lane
      slices accumulate on their own) or ``(R_t,)`` (rowwise_adagrad: a
      row's mean over every lane, the same on every rank); ``()`` for sgd;
    * ``emb_acc_h``: None, or the host stack's, ``(host_local_rows, D)``
      or ``(host_local_rows,)``, in host memory registered with the card
      (``parallel.host_tier._host_empty``) when the tables are on CUDA.

    The JAX package's ``sharded_opt_shardings`` (its sharding tree) is
    this layout: every tensor here is this rank's."""
    from dlrm_tpu_torch.parallel.host_tier import _host_empty

    optim.check_optimizer(optimizer)
    dense_params, emb, cs, emb_h = _sharded_parts(params)
    state = {"dense": optim.init_dense_state(optimizer, dense_params),
             "count": 0, "emb_acc": None, "emb_acc_cs": (),
             "emb_acc_h": None}
    if optimizer == "sgd":
        return state
    rowwise = optimizer == "rowwise_adagrad"

    def zeros(t, full):
        return torch.zeros(t.shape[:1] if rowwise else full,
                           dtype=torch.float32, device=t.device)

    state["emb_acc"] = zeros(emb, emb.shape)
    state["emb_acc_cs"] = tuple(zeros(c, c.shape) for c in cs)
    if emb_h is not None:
        state["emb_acc_h"] = _host_empty(
            emb_h.shape[:1] if rowwise else emb_h.shape, torch.float32,
            emb.device).zero_()
    return state


def _sharded_sparse_apply(params: dict, opt_state: dict, sparse, d_pooled,
                          lr: float, *, config: DLRMConfig, optimizer: str,
                          mesh, placement, axis: str,
                          block_leading: bool = False,
                          d_pooled_scaled=None) -> None:
    from dlrm_tpu_torch.parallel import embedding as pemb

    _, emb, cs, emb_h = _sharded_parts(params)
    with phase_scope("sparse_update"):
        if optimizer == "sgd":
            pemb.sharded_update_sgd(
                emb, sparse, d_pooled, lr, mesh=mesh, placement=placement,
                axis=axis, cs=cs, emb_h=emb_h, block_leading=block_leading,
                exchange_dtype=config.exchange_dtype)
        else:
            pemb.sharded_update_adagrad(
                emb, opt_state["emb_acc"], sparse, d_pooled, lr, mesh=mesh,
                placement=placement, axis=axis, cs=cs,
                acc_cs=opt_state["emb_acc_cs"], emb_h=emb_h,
                acc_h=opt_state["emb_acc_h"], block_leading=block_leading,
                d_pooled_scaled=d_pooled_scaled,
                rowwise=optimizer == "rowwise_adagrad",
                exchange_dtype=config.exchange_dtype)
    optim.count_hits(emb, sparse.numel())  # the rank's hits


def sharded_train_step_opt(params: dict, opt_state: dict, dense, sparse,
                           labels, *, config: DLRMConfig, optimizer: str,
                           lr, mesh, placement, axis: str = "d",
                           grad_clip_norm=None, local_batch: bool = False
                           ) -> torch.Tensor:
    """One hybrid-parallel step with ``sgd``, ``adagrad`` or
    ``rowwise_adagrad`` on this rank's parameters and optimizer state
    (:func:`init_sharded_opt_state`), both in place; the global batch as
    :func:`sharded_train_step` takes it; returns the global loss.

    ``lr``: a float, or a schedule read at ``opt_state['count']``.
    ``grad_clip_norm``: the JAX package's sharded clip, over the dense
    gradients and the pooled rows' gradient (:func:`_sharded_grads`).  The
    tables take ``parallel.embedding``'s exact dedup-then-apply update on
    every rank's rows."""
    optim.check_optimizer(optimizer)
    lr_t = _f32(lr(opt_state["count"]) if callable(lr) else lr)
    _, emb, _, _ = _sharded_parts(params)
    dense, sparse, labels = _local_rows(mesh, emb, dense, sparse, labels,
                                        local_batch=local_batch)
    loss, flat, d_pooled = _sharded_grads(
        params, dense, sparse, labels, config=config, mesh=mesh,
        placement=placement, axis=axis, grad_clip_norm=grad_clip_norm)
    _dense_apply(params, flat, optimizer, opt_state["dense"], lr_t)
    _sharded_sparse_apply(params, opt_state, sparse, d_pooled, lr_t,
                          config=config, optimizer=optimizer, mesh=mesh,
                          placement=placement, axis=axis)
    opt_state["count"] += 1
    return loss


def make_sharded_train_step_opt(config: DLRMConfig, *, optimizer: str, lr,
                                mesh, placement, axis: str = "d",
                                grad_clip_norm=None,
                                local_batch: bool = False) -> Callable:
    """``step(params, opt_state, dense, sparse, labels) -> loss`` of
    :func:`sharded_train_step_opt`."""
    return functools.partial(sharded_train_step_opt, config=config,
                             optimizer=optimizer, lr=lr, mesh=mesh,
                             placement=placement, axis=axis,
                             grad_clip_norm=grad_clip_norm,
                             local_batch=local_batch)


def _sharded_block(params: dict, opt_state: Optional[dict], dense, sparse,
                   labels, *, config: DLRMConfig, optimizer: str, lrs,
                   scheduled: bool, mesh, placement, axis: str,
                   grad_clip_norm, local_batch: bool) -> torch.Tensor:
    """K sharded micro-steps (K: the leading axis of the global batches),
    every table read as of block entry, the dense parameters updated every
    micro-step at ``lrs[k]``; the K pooled gradients then applied in one
    sparse update (scheduled: each scaled by its micro-step's lr, applied
    with lr 1; Adagrad: as the twin payload)."""
    _, emb, _, _ = _sharded_parts(params)
    dense, sparse, labels = _local_rows(mesh, emb, dense, sparse, labels,
                                        leading=1, local_batch=local_batch)
    losses, d_all, scaled = [], [], []
    accs = None if opt_state is None else opt_state["dense"]
    for k in range(dense.shape[0]):
        loss, flat, d_pooled = _sharded_grads(
            params, dense[k], sparse[k], labels[k], config=config,
            mesh=mesh, placement=placement, axis=axis,
            grad_clip_norm=grad_clip_norm)
        _dense_apply(params, flat, optimizer, accs, lrs[k])
        losses.append(loss)
        d_all.append(d_pooled)
        if scheduled:
            scaled.append(d_pooled * lrs[k])
    if optimizer == "sgd":
        d_stack, lr, twin = torch.stack(scaled if scheduled else d_all), \
            (1.0 if scheduled else lrs[0]), None
    else:
        d_stack, lr = torch.stack(d_all), lrs[0]
        twin = torch.stack(scaled) if scheduled else None
    _sharded_sparse_apply(params, opt_state, sparse, d_stack, lr,
                          config=config, optimizer=optimizer, mesh=mesh,
                          placement=placement, axis=axis, block_leading=True,
                          d_pooled_scaled=twin)
    return torch.stack(losses)


def sharded_train_block(params: dict, dense, sparse, labels, *,
                        config: DLRMConfig, lr, mesh, placement,
                        axis: str = "d", grad_clip_norm=None,
                        local_batch: bool = False) -> torch.Tensor:
    """K hybrid-parallel SGD micro-steps on this rank's parameters, in
    place, with one coalesced sparse update at block end; returns the K
    global losses.  ``dense`` (K, B, 13), ``sparse`` (K, B, T[, H]),
    ``labels`` (K, B): global batches, as :func:`sharded_train_step` takes
    them (``local_batch``: (K, b, ...), this rank's rows).  ``lr``: a
    float, or K per-micro-step values.

    Every micro-step's lookup reads EVERY table as of block entry (the
    single-device :func:`train_block` freezes only its big tables), the
    dense parameters take a step every micro-step, and the K gradients of
    the pooled rows are applied in one pass; K=1 is
    :func:`sharded_train_step`.  ``grad_clip_norm`` clips each micro-step
    as :func:`sharded_train_step_opt` does."""
    scheduled = np.ndim(lr) != 0
    lrs = ([_f32(x) for x in lr] if scheduled
           else [_f32(lr)] * dense.shape[0])
    return _sharded_block(params, None, dense, sparse, labels, config=config,
                          optimizer="sgd", lrs=lrs, scheduled=scheduled,
                          mesh=mesh, placement=placement, axis=axis,
                          grad_clip_norm=grad_clip_norm,
                          local_batch=local_batch)


def make_sharded_train_block(config: DLRMConfig, lr, mesh, placement,
                             axis: str = "d", grad_clip_norm=None,
                             local_batch: bool = False) -> Callable:
    """``step(params, (K,B,13), (K,B,T[,H]), (K,B)) -> (K,) losses`` of
    :func:`sharded_train_block`.  A schedule ``lr`` is read at ``step.step
    + k`` for micro-step k, and ``step.step`` advances by K a call (set it
    to resume)."""
    if not callable(lr):
        return functools.partial(sharded_train_block, config=config, lr=lr,
                                 mesh=mesh, placement=placement, axis=axis,
                                 grad_clip_norm=grad_clip_norm,
                                 local_batch=local_batch)

    def run(p, d, s, l):
        k = d.shape[0]
        lrs = [lr(run.step + i) for i in range(k)]
        run.step += k
        return sharded_train_block(p, d, s, l, config=config, lr=lrs,
                                   mesh=mesh, placement=placement, axis=axis,
                                   grad_clip_norm=grad_clip_norm,
                                   local_batch=local_batch)

    run.step = 0
    return run


def sharded_train_block_opt(params: dict, opt_state: dict, dense, sparse,
                            labels, *, config: DLRMConfig, lr, mesh,
                            placement, axis: str = "d", unroll: bool = True,
                            optimizer: str = "adagrad", grad_clip_norm=None,
                            local_batch: bool = False) -> torch.Tensor:
    """K hybrid-parallel micro-steps with Adagrad or row-wise Adagrad on
    this rank's parameters and optimizer state, in place (see
    :func:`sharded_train_block`; SGD blocks go there); returns the K
    losses.  The dense parameters take a true Adagrad step every
    micro-step; the tables one dedup-then-apply update at block end, in
    which a key's gradients from every micro-step and every rank are
    summed before the accumulator's update.

    ``lr``: a float, or a schedule read at ``opt_state['count'] + k`` (the
    update then carries the twin payload ``(g, lr_k * g)``).  ``unroll``
    is the JAX package's compile knob and selects nothing here."""
    del unroll
    if optimizer not in ("adagrad", "rowwise_adagrad"):
        raise ValueError(f"sharded_train_block_opt runs adagrad or "
                         f"rowwise_adagrad, got {optimizer!r}; SGD blocks "
                         f"use sharded_train_block")
    k = dense.shape[0]
    count = opt_state["count"]
    scheduled = callable(lr)
    lrs = [_f32(lr(count + i) if scheduled else lr) for i in range(k)]
    losses = _sharded_block(params, opt_state, dense, sparse, labels,
                            config=config, optimizer=optimizer, lrs=lrs,
                            scheduled=scheduled, mesh=mesh,
                            placement=placement, axis=axis,
                            grad_clip_norm=grad_clip_norm,
                            local_batch=local_batch)
    opt_state["count"] = count + k
    return losses


def make_sharded_train_block_opt(config: DLRMConfig, *, optimizer: str, lr,
                                 mesh, placement, axis: str = "d",
                                 unroll: bool = True, grad_clip_norm=None,
                                 local_batch: bool = False) -> Callable:
    """``step(params, opt_state, (K,B,13), (K,B,T[,H]), (K,B)) -> (K,)
    losses`` of :func:`sharded_train_block_opt`; the schedule's count
    lives in ``opt_state``."""
    return functools.partial(sharded_train_block_opt, config=config, lr=lr,
                             mesh=mesh, placement=placement, axis=axis,
                             unroll=unroll, optimizer=optimizer,
                             grad_clip_norm=grad_clip_norm,
                             local_batch=local_batch)


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
