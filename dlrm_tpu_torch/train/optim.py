"""Optimizers and learning-rate schedules: the single-device part of
``dlrm_tpu/train/optim.py``, without optax.

SGD, Adagrad and row-wise Adagrad.  Dense parameters take the elementwise
update of ``optax.sgd`` / ``optax.adagrad(initial_accumulator_value=0,
eps=1e-10)``.  The table-update rules live in ``ops/embedding.py``
(``apply_sparse_sgd``, ``adagrad_rows`` and the device stack's
``apply_adagrad_rows`` / ``apply_sparse_adagrad``): Adagrad follows the
dedup-then-apply contract, a row's hits summed first and the optimizer
applied once with the sum, touching only the hit rows.  The Adagrad
accumulator of the stacked ``(total_rows, D)`` table is one ``(total_rows,
D)`` f32 tensor; the row-wise one, ``(total_rows,)`` f32, holds one scalar
per row (``acc[r] += mean_D(g_r^2)``).  This module keeps the dense
optimizer, the state, the clip, the schedules and the route: which rule a
step's device tables take (:func:`apply_sparse_update`).

The JAX package has three implementations of the exact sparse Adagrad
(``dedup``, ``dense_g``, ``hybrid[:MB]``) that differ in TPU cost, not in
result.  This package has one, ``ops.embedding.apply_sparse_adagrad``; the
names are still accepted where the JAX package takes them
(:func:`check_emb_impl`).

``make_schedule`` returns a plain step -> lr function with optax's values
(``constant_schedule``, ``linear_schedule``, ``polynomial_schedule`` and
``join_schedules``, as the JAX package composes them), computed in float32
as optax computes them.
"""

from __future__ import annotations

import ctypes
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from dlrm_tpu_torch.ops import embedding as emb_ops
from dlrm_tpu_torch.utils.telemetry import count, phase_scope

OPTIMIZERS = ("sgd", "adagrad", "rowwise_adagrad")


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
    embedding rows only) ``acc += g^2; p -= lr * g * rsqrt(acc + eps)``.

    Adagrad on f32 leaves takes :func:`dense_adagrad` (on the card one
    kernel for every ``MAX_LEAVES`` leaves; on the CPU the plain version).
    Runs under the span ``dense_apply``; while a profiler records, the
    counter ``dense_apply.launches`` adds the kernels launched on the card
    (the CPU launches none)."""
    with phase_scope("dense_apply"):
        if optimizer == "sgd":
            for p, g in zip(params, grads):
                p.sub_(g * lr)
            launches = 2 * len(params)
        elif all(t.dtype is torch.float32
                 for t in (*params, *grads, *accs)):
            launches = dense_adagrad(params, grads, accs, lr)
        else:
            # The kernel is f32 only.  Leaves of another dtype (a model
            # built with weight_dtype=torch.bfloat16) keep the per-leaf
            # loop, whose every op rounds to that dtype.
            dense_adagrad_reference(params, grads, accs, lr)
            launches = LOOP_LAUNCHES * len(params)
        if params and params[0].device.type != "cpu":
            count("dense_apply.launches", launches)


# -- the dense Adagrad: one kernel over many leaves, and its plain version ---

# csrc/dense_adagrad.cu's kMaxLeaves: leaves a launch.
MAX_LEAVES = 64
# Kernels the plain version launches a leaf on the card: g * g, add_, the
# compare, add, rsqrt, zeros_like and where of _rss_scale, two products
# and sub_.
LOOP_LAUNCHES = 10
_P = ctypes.c_void_p


def dense_adagrad_groups(numels: Sequence[int]) -> List[Tuple[int, ...]]:
    """The leaves of each launch of the dense Adagrad kernel, for leaves of
    ``numels`` elements: ``MAX_LEAVES`` a launch in call order, empty
    leaves left out.  The kernel's C entry cuts each leaf into blocks."""
    work = [i for i, n in enumerate(numels) if n > 0]
    return [tuple(work[at:at + MAX_LEAVES])
            for at in range(0, len(work), MAX_LEAVES)]


def dense_adagrad_reference(params: Sequence[torch.Tensor],
                            grads: Sequence[torch.Tensor],
                            accs: Sequence[torch.Tensor], lr: float) -> None:
    """Plain version of :func:`dense_adagrad`, a leaf at a time:
    ``acc += g * g; p -= (g * rsqrt(acc + eps)) * lr``, 0 where acc == 0,
    each op rounded to the leaves' dtype."""
    for p, g, acc in zip(params, grads, accs):
        acc.add_(g * g)
        p.sub_((g * emb_ops._rss_scale(acc) * lr).to(p.dtype))


def _checked_leaves(params, grads, accs
                    ) -> Tuple[List[int], List[Tuple[int, int, int]]]:
    """(numels, (p, g, acc) addresses) of the leaves, after checking that
    the kernel takes them: one CUDA device, f32, each leaf's parameter,
    gradient and accumulator of one shape and contiguous.  One pass, a few
    attribute reads a tensor: this runs every step."""
    if not len(params) == len(grads) == len(accs):
        raise ValueError(f"dense_adagrad: {len(params)} parameters, "
                         f"{len(grads)} gradients, {len(accs)} accumulators")
    device, f32 = params[0].device, torch.float32
    numels, addresses = [], []
    for i, (p, g, a) in enumerate(zip(params, grads, accs)):
        if not p.device == g.device == a.device == device:
            raise ValueError(f"dense_adagrad: leaf {i} lies on "
                             f"{[str(t.device) for t in (p, g, a)]}, not all "
                             f"on {device}")
        if not (p.dtype is f32 and g.dtype is f32 and a.dtype is f32):
            raise TypeError(f"dense_adagrad: the kernel takes float32 "
                            f"leaves, leaf {i} is "
                            f"{[t.dtype for t in (p, g, a)]}")
        if not (p.shape == g.shape == a.shape and p.is_contiguous()
                and g.is_contiguous() and a.is_contiguous()):
            raise ValueError(f"dense_adagrad: leaf {i}'s parameter, gradient "
                             f"and accumulator must be contiguous and of one "
                             f"shape, got "
                             f"{[tuple(t.shape) for t in (p, g, a)]}")
        numels.append(p.numel())
        addresses.append((p.data_ptr(), g.data_ptr(), a.data_ptr()))
    if device.type != "cuda":
        raise ValueError(f"dense_adagrad: leaves on {device}; the kernel "
                         f"takes CPU or CUDA tensors")
    return numels, addresses


def _launch_args(numels: Sequence[int],
                 addresses: Sequence[Tuple[int, int, int]]) -> list:
    """The C entry's arguments for each launch, as ctypes arrays: the
    pointers (parameters, gradients, then accumulators), the lengths, and
    the leaf count."""
    out = []
    for leaves in dense_adagrad_groups(numels):
        k = len(leaves)
        out.append(((_P * (3 * k))(*(addresses[i][j] for j in range(3)
                                     for i in leaves)),
                    (ctypes.c_longlong * k)(*(numels[i] for i in leaves)),
                    k))
    return out


def dense_adagrad(params: Sequence[torch.Tensor],
                  grads: Sequence[torch.Tensor],
                  accs: Sequence[torch.Tensor], lr: float) -> int:
    """Adagrad in place on every leaf: ``acc += g * g; p -= (g * rsqrt(acc
    + eps)) * lr``, 0 where acc == 0, in f32.  Returns the kernels
    launched.

    CPU leaves: the plain version (0 launches).  CUDA leaves: one launch of
    ``csrc/dense_adagrad.cu`` for every ``MAX_LEAVES`` leaves, on the
    current stream, with no copy, allocation or sync, or an error;
    ``dense_adagrad.launches`` counts launches.  ``lr`` is a host float."""
    if not params:
        return 0
    if params[0].device.type == "cpu" and all(
            t.device.type == "cpu" for t in (*params, *grads, *accs)):
        dense_adagrad_reference(params, grads, accs, lr)
        return 0
    launches = _launch_args(*_checked_leaves(params, grads, accs))
    fn = _kernel()
    device = params[0].device
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        for ptrs, n, k in launches:
            rc = fn(ptrs, n, k, lr, stream)
            if rc != 0:
                raise RuntimeError(f"dense_adagrad kernel launch failed: "
                                   f"CUDA error {rc} for {k} leaves of "
                                   f"{sum(n)} elements")
            dense_adagrad.launches += 1
    return len(launches)


dense_adagrad.launches = 0


def _kernel():
    """The C entry point of ``csrc/dense_adagrad.cu``."""
    from dlrm_tpu_torch.ops.cuda_build import kernel
    return kernel("dense_adagrad", (_P, _P, ctypes.c_int, ctypes.c_float,
                                    _P))


# -- which update a step's device tables take -----------------------------------

# Devices whose f32 tables take the sorted segment sum for row-wise Adagrad
# applied in the step that made the gradient, and on which the counters
# below count.
CARD_DEVICES = ("cuda",)


def takes_sorted_update(optimizer: str, emb: torch.Tensor,
                        grad_clip_norm) -> bool:
    """Whether a step's device-table update, applied in that same step,
    takes :func:`apply_sorted_rowwise`: row-wise Adagrad, no clip, f32
    tables on the card, of a width the kernel takes.  Everything else
    (SGD, Adagrad, bf16 tables, the CPU, the clip, deferred blocks) keeps
    the dedup and apply of ``ops.embedding``."""
    return (optimizer == "rowwise_adagrad" and grad_clip_norm is None
            and emb.dtype is torch.float32
            and emb.device.type in CARD_DEVICES
            and emb_ops.sorted_update_takes(emb.shape[1]))


def count_hits(emb: torch.Tensor, hits: int, sorted_update: bool = False
               ) -> None:
    """The counters ``sparse_update.hits`` (every hit of the device tables
    that reaches an update on the card) and ``sparse_update.fused_hits``
    (those the sorted segment sum takes); the CPU counts nothing."""
    if emb.device.type in CARD_DEVICES:
        count("sparse_update.hits", hits)
        if sorted_update:
            count("sparse_update.fused_hits", hits)


def apply_sorted_rowwise(emb: torch.Tensor, acc: torch.Tensor,
                         grad: emb_ops.SparseGrad, lr: float) -> None:
    """Row-wise Adagrad of every device table in one pass, in place: the
    hits sorted (span ``dedup``), then the sorted segment sum (span
    ``sparse_update``).  The same arithmetic as
    ``ops.embedding.apply_sparse_adagrad``, with the hits of a row summed
    in another order."""
    hits = emb_ops.sort_hits(grad.ids)
    with phase_scope("sparse_update"):
        emb_ops.sorted_rowwise_adagrad(emb, acc, hits,
                                       grad.rows.contiguous(), lr)
    count_hits(emb, grad.ids.numel(), sorted_update=True)


def apply_sparse_update(optimizer: str, emb: torch.Tensor,
                        acc: Optional[torch.Tensor],
                        grad: emb_ops.SparseGrad, lr: float, *,
                        grad_clip_norm=None) -> None:
    """The route: the device stack's update from the per-hit gradient
    ``grad``, applied in the step that made it, in place.  The sorted
    segment sum where :func:`takes_sorted_update` says so; otherwise
    ``ops.embedding.apply_sparse_adagrad`` (``acc`` the stack's
    accumulator) or ``apply_sparse_sgd``, under the span
    ``sparse_update``.  Counts the hits (:func:`count_hits`)."""
    if takes_sorted_update(optimizer, emb, grad_clip_norm):
        return apply_sorted_rowwise(emb, acc, grad, lr)
    with phase_scope("sparse_update"):
        if optimizer == "sgd":
            emb_ops.apply_sparse_sgd(emb, grad, lr)
        else:
            emb_ops.apply_sparse_adagrad(
                emb, acc, grad, lr, rowwise=optimizer == "rowwise_adagrad")
    count_hits(emb, grad.ids.numel())


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
