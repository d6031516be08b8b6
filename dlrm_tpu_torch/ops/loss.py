"""Binary cross-entropy with clamped logs: the counterpart of
``dlrm_tpu/ops/loss.py``.

Forward::

    L = mean_i[ -y_i * max(log(x_i), -100) + (y_i - 1) * max(log(1 - x_i), -100) ]

Backward: the reference's epsilon-regularised quotient, not autograd of the
clamped forward (eps = float32 machine epsilon)::

    dx_i = g/B * ((1 - y_i) / (1 - x_i + eps) - y_i / (x_i + eps))

The labels get no gradient.
"""

from __future__ import annotations

import torch

_EPS = torch.finfo(torch.float32).eps


class _BCE(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, y):
        ctx.save_for_backward(x, y)
        xf, yf = x.float(), y.float()
        terms = (-yf * torch.clamp(torch.log(xf), min=-100.0)
                 + (yf - 1.0) * torch.clamp(torch.log1p(-xf), min=-100.0))
        return terms.mean()

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        xf, yf = x.float(), y.float()
        scale = g / x.numel()
        dx = scale * ((1.0 - yf) / (1.0 - xf + _EPS) - yf / (xf + _EPS))
        return dx.to(x.dtype), None


def bce_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Clamped-log binary cross entropy (0-d f32); ``x`` = predictions,
    ``y`` = labels."""
    return _BCE.apply(x, y)
