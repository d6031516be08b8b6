"""Optimizers and learning-rate schedules: the single-device part of
``dlrm_tpu/train/optim.py``, without optax.

SGD, Adagrad and row-wise Adagrad.  Dense parameters take the elementwise
update of ``optax.sgd`` / ``optax.adagrad(initial_accumulator_value=0,
eps=1e-10)``.  Embedding rows follow the dedup-then-apply contract: the
gradient contributions of a row hit several times are summed first and the
optimizer is applied once with the sum, touching only the hit rows.  The
Adagrad accumulator of the stacked ``(total_rows, D)`` table is one
``(total_rows, D)`` f32 tensor; the row-wise one, ``(total_rows,)`` f32,
holds one scalar per row (``acc[r] += mean_D(g_r^2)``).

The JAX package has three implementations of the exact sparse Adagrad
(``dedup``, ``dense_g``, ``hybrid[:MB]``) that differ in TPU cost, not in
result.  This package has one, :func:`apply_sparse_adagrad`; the names are
still accepted where the JAX package takes them (:func:`check_emb_impl`).

``make_schedule`` returns a plain step -> lr function with optax's values
(``constant_schedule``, ``linear_schedule``, ``polynomial_schedule`` and
``join_schedules``, as the JAX package composes them), computed in float32
as optax computes them.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from dlrm_tpu_torch.ops import embedding as emb_ops

OPTIMIZERS = ("sgd", "adagrad", "rowwise_adagrad")
ADAGRAD_EPS = 1e-10


def check_optimizer(optimizer: str) -> None:
    if optimizer not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer {optimizer!r}")


def check_emb_impl(emb_impl: str) -> None:
    """The JAX package's names for its exact-Adagrad implementations:
    ``dedup``, ``dense_g``, ``hybrid`` or ``hybrid:<MB>``.  Every one runs
    this package's single implementation; anything else is refused as the
    JAX package refuses it."""
    if emb_impl in ("dedup", "dense_g", "hybrid"):
        return
    head, sep, mb = emb_impl.partition(":")
    if head == "hybrid" and sep and mb.isdigit():
        return
    raise ValueError(f"unknown emb_impl {emb_impl!r}")


def init_emb_state(config, optimizer: str, emb: torch.Tensor
                   ) -> Optional[torch.Tensor]:
    """The embedding optimizer state for the stacked table ``emb``: None
    (sgd), a zero ``(total_rows, D)`` f32 accumulator (adagrad) or a zero
    ``(total_rows,)`` f32 one (rowwise_adagrad), on the table's device."""
    check_optimizer(optimizer)
    if optimizer == "sgd":
        return None
    shape = emb.shape if optimizer == "adagrad" else emb.shape[:1]
    return torch.zeros(shape, dtype=torch.float32, device=emb.device)


def clip_by_global_norm(max_norm: float, grads: Sequence[torch.Tensor]
                        ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Scale every tensor of ``grads`` by ``min(1, max_norm / ||grads||_2)``;
    returns (clipped grads, the norm as a 0-d f32 tensor; no host sync).

    The norm is taken in f32 over everything given.  The training steps
    pass what the JAX package's steps pass: the dense parameters'
    gradients, the big tables' gathered-row gradients (one entry per hit)
    and the small tables' gradient with the hits of a row already summed
    (there it is a dense ``(rows, D)`` slice; rows without a hit add 0)."""
    sq = sum(g.float().square().sum() for g in grads)
    scale, gnorm = clip_scale(max_norm, sq)
    return [(g.float() * scale).to(g.dtype) for g in grads], gnorm


def clip_scale(max_norm: float, sq: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(``min(1, max_norm / norm)``, the norm) of a global norm given as its
    f32 sum of squares ``sq``, 0-d (the sharded step sums it over ranks)."""
    gnorm = torch.sqrt(sq)
    return torch.clamp(max_norm / torch.clamp(gnorm, min=1e-12),
                       max=1.0), gnorm


def _rss_scale(acc_new: torch.Tensor) -> torch.Tensor:
    """optax.scale_by_rss: ``rsqrt(acc + eps)``, and 0 where acc == 0."""
    return torch.where(acc_new > 0, torch.rsqrt(acc_new + ADAGRAD_EPS),
                       torch.zeros_like(acc_new))


def init_dense_state(optimizer: str, dense_params: dict) -> Optional[dict]:
    """Dense optimizer state: None for sgd, else a zero accumulator per
    parameter, in the parameter tree's shape."""
    check_optimizer(optimizer)
    if optimizer == "sgd":
        return None
    return emb_ops.tree_map(torch.zeros_like, dense_params)


def apply_dense(optimizer: str, params: Sequence[torch.Tensor],
                grads: Sequence[torch.Tensor],
                accs: Optional[Sequence[torch.Tensor]], lr: float) -> None:
    """One dense step in place on the leaves ``params`` (and ``accs``):
    sgd ``p -= lr * g``; adagrad and rowwise_adagrad (which is row-wise on
    embedding rows only) ``acc += g^2; p -= lr * g * rsqrt(acc + eps)``."""
    if optimizer == "sgd":
        for p, g in zip(params, grads):
            p.sub_(g * lr)
        return
    for p, g, acc in zip(params, grads, accs):
        acc.add_(g * g)
        p.sub_((g * _rss_scale(acc) * lr).to(p.dtype))


def apply_adagrad_rows(emb: torch.Tensor, acc: torch.Tensor,
                       ids: torch.Tensor, g: torch.Tensor, lr, *,
                       rowwise: bool,
                       scaled: Optional[torch.Tensor] = None) -> None:
    """Adagrad on the rows ``ids`` of the stacked table, in place.  Every
    id appears once and ``g`` (n, D) f32 is its summed gradient:
    ``acc[r] += g^2`` (row-wise: ``mean_D(g^2)``), then
    ``emb[r] -= lr * g * rsqrt(acc[r] + eps)``, 0 where ``acc[r] == 0``.
    With ``scaled`` (the per-row sum of ``lr_k * g``) the weight step is
    ``scaled * rsqrt(...)`` and ``lr`` is not used."""
    g2 = (g * g).mean(dim=1) if rowwise else g * g
    acc_new = acc.index_select(0, ids) + g2
    acc.index_add_(0, ids, g2)
    rs = _rss_scale(acc_new)
    if rowwise:
        rs = rs[:, None]
    step = scaled * rs if scaled is not None else g * rs * lr
    emb.index_add_(0, ids, (-step).to(emb.dtype))


def apply_sparse_adagrad(emb: torch.Tensor, acc: torch.Tensor,
                         grad: emb_ops.SparseGrad, lr, *, rowwise: bool,
                         scaled_rows: Optional[torch.Tensor] = None) -> None:
    """Exact sparse Adagrad, dedup then apply, in place: the rows of
    duplicate ids are summed in f32 (one ``unique`` and one ``index_add_``),
    then :func:`apply_adagrad_rows` runs on the distinct rows.

    ``scaled_rows``: the gradient rows already scaled by their own
    micro-step's lr, for a coalesced block under a schedule.  They ride
    through the same dedup as a twin payload ``(g, lr_k * g)``: the
    accumulator folds in ``(sum g)^2`` and the weight step is
    ``sum(lr_k * g) * rsqrt(...)``; for a row hit in one micro-step only
    that is that step's exact update."""
    d = grad.rows.shape[1]
    rows = grad.rows.float()
    if scaled_rows is not None:
        rows = torch.cat([rows, scaled_rows.float()], dim=1)
    u = emb_ops.sum_duplicates(emb_ops.SparseGrad(grad.ids, rows))
    apply_adagrad_rows(emb, acc, u.ids, u.rows[:, :d], lr, rowwise=rowwise,
                       scaled=None if scaled_rows is None else u.rows[:, d:])


def _constant(value: float) -> Callable[[int], float]:
    return lambda count: float(np.float32(value))


def _polynomial(init_value: float, end_value: float, power: int,
                transition_steps: int) -> Callable[[int], float]:
    """optax.polynomial_schedule (transition_begin 0), in float32."""
    if transition_steps <= 0:
        return _constant(init_value)
    steps = np.float32(transition_steps)
    span = np.float32(init_value - end_value)
    end = np.float32(end_value)

    def schedule(count: int) -> float:
        c = np.float32(min(max(count, 0), transition_steps))
        frac = np.float32(1.0) - c / steps
        p = frac
        for _ in range(power - 1):  # integer power: repeated products
            p = p * frac
        return float(span * p + end)

    return schedule


def _join(schedules, boundaries) -> Callable[[int], float]:
    """optax.join_schedules: schedule k runs on ``step - boundary[k-1]``
    from its boundary on."""
    def schedule(step: int) -> float:
        out = schedules[0](step)
        for boundary, fn in zip(boundaries, schedules[1:]):
            if step >= boundary:
                out = fn(step - boundary)
        return out

    return schedule


def make_schedule(base_lr: float, *, schedule: str = "constant",
                  warmup_steps: int = 0, decay_start: int = 0,
                  decay_steps: int = 0, end_lr_scale: float = 0.0
                  ) -> Callable[[int], float]:
    """Learning-rate schedule (step -> lr): ``constant``, or
    ``warmup_poly_decay`` (MLPerf DLRM): linear warmup from 0 over
    ``warmup_steps``, hold until ``decay_start``, then power-2 decay to
    ``base_lr * end_lr_scale`` over ``decay_steps``."""
    if schedule == "constant":
        return _constant(base_lr)
    if schedule == "warmup_poly_decay":
        fns, bounds = [], []
        if warmup_steps > 0:
            fns.append(_polynomial(0.0, base_lr, 1, warmup_steps))
            bounds.append(warmup_steps)
        if decay_start - warmup_steps > 0:
            fns.append(_constant(base_lr))
            bounds.append(decay_start)
        fns.append(_polynomial(base_lr, base_lr * end_lr_scale, 2,
                               max(decay_steps, 1)))
        return fns[0] if len(fns) == 1 else _join(fns, bounds)
    raise ValueError(f"unknown schedule {schedule!r}")
