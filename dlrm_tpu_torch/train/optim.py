"""Learning-rate schedules: the schedule part of ``dlrm_tpu/train/optim.py``.

``make_schedule`` returns a plain step -> lr function with optax's values
(``constant_schedule``, ``linear_schedule``, ``polynomial_schedule`` and
``join_schedules``, as the JAX package composes them), computed in float32
as optax computes them.  The optimizers (Adagrad, clipping) come later.
"""

from __future__ import annotations

from typing import Callable

import numpy as np


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
