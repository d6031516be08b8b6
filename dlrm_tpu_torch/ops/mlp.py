"""MLP forward: the counterpart of ``dlrm_tpu/ops/mlp.py``.

Weights are stored (in, out), so a layer is ``x @ w + b``.  The bottom MLP
is ReLU on every layer; the top MLP is ReLU on all but the last, which is
linear followed by sigmoid.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch


def init_mlp(generator: torch.Generator, sizes: Sequence[int],
             dtype: torch.dtype = torch.float32,
             device: Optional[torch.device] = None) -> List[dict]:
    """Glorot-normal weights (std = sqrt(2 / (fan_in + fan_out))), zero
    biases, drawn in f32 from ``generator`` and stored in ``dtype``."""
    device = generator.device if device is None else device
    layers = []
    for i in range(len(sizes) - 1):
        fan_in, fan_out = sizes[i], sizes[i + 1]
        std = (2.0 / (fan_in + fan_out)) ** 0.5
        w = torch.randn((fan_in, fan_out), generator=generator,
                        dtype=torch.float32, device=device) * std
        layers.append({"w": w.to(dtype),
                       "b": torch.zeros((fan_out,), dtype=dtype,
                                        device=device)})
    return layers


def mlp_apply(layers, x: torch.Tensor, *, final: str,
              compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Apply a dense stack.  ``final`` is the last layer's activation:
    'relu' (bottom MLP) or 'sigmoid' (top MLP).

    Casts as the JAX package does: inputs, weights and biases are cast to
    ``compute_dtype``; the product accumulates in f32 and the bias is added
    in f32, before any rounding; every layer but the last is cast back to
    ``compute_dtype``.  ``torch.matmul`` on bf16 operands would round its
    result to bf16 before the bias add, so the operands are widened to f32
    instead: a product of two bf16 values is exact in f32, which leaves
    only the order of the f32 sums to differ from the JAX package.
    """
    n = len(layers)
    if compute_dtype is not None:
        x = x.to(compute_dtype)
    for i, layer in enumerate(layers):
        w, b = layer["w"], layer["b"]
        if compute_dtype is not None:
            w = w.to(compute_dtype)
            b = b.to(compute_dtype)
        y = torch.matmul(x.float(), w.float()) + b.float()
        last = i == n - 1
        if not last or final == "relu":
            y = torch.relu(y)
        else:
            y = torch.sigmoid(y)
        if compute_dtype is not None and not last:
            y = y.to(compute_dtype)
        x = y
    return x
