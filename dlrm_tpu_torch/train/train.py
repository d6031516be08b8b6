"""Single-device exact-SGD training step and loop: the counterpart of
``dlrm_tpu/train/train.py``'s ``train_step``, ``make_jit_train_step`` and
``train``.

One step: gather every table's rows outside autograd, take the gradients
of the loss with respect to the dense parameters and the gathered rows
(``torch.autograd.grad``; nothing is accumulated in ``.grad``), apply dense
SGD ``p -= lr * g``, then sparse SGD as one ``index_add_`` that sums
duplicate ids.  Table gradients are never densified.  The parameters are
updated in place, which stands in for the JAX package's buffer donation.
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
