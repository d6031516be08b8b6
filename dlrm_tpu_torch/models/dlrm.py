"""The DLRM model: parameters, initialization, forward pass — the
counterpart of ``dlrm_tpu/models/dlrm.py``.

    dense (B,13) ──► bottom MLP ──┐
                                  ├─► dot interaction ─► top MLP ─► sigmoid
    sparse ids (B,T[,H]) ─ lookup ┘

Parameters are a plain dict with the JAX package's pytree shape::

    {"bottom": [{"w","b"}...], "emb": Tensor(total_rows, D), "top": [...]}

with weights stored (in, out) and every table stacked into one tensor.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from dlrm_tpu_torch.config import DLRMConfig
from dlrm_tpu_torch.ops import embedding as emb_ops
from dlrm_tpu_torch.ops.interaction import (dot_interaction,
                                            dot_interaction_pairwise)
from dlrm_tpu_torch.ops.interaction_fused import fused_dot_interaction
from dlrm_tpu_torch.ops.loss import bce_loss
from dlrm_tpu_torch.ops.mlp import init_mlp, mlp_apply
from dlrm_tpu_torch.ops.quant import QuantEmb, check_quant_storage
from dlrm_tpu_torch.utils.telemetry import phase_scope

_INTERACTIONS = {
    "gram": dot_interaction,
    "pairwise": dot_interaction_pairwise,
    "fused": fused_dot_interaction,
}


def init_params(generator: torch.Generator, config: DLRMConfig,
                device: Optional[torch.device] = None,
                emb_init: str = "scaled_uniform") -> dict:
    """Initialize the parameter dict on ``device`` (default: the
    generator's device).

    MLP weights: Glorot normal, zero bias.  Embeddings (``scaled_uniform``):
    U(-1/sqrt(rows), 1/sqrt(rows)) per table.  The stack is drawn in place
    on the device, in its storage dtype, as U(-1, 1) and then scaled table
    by table, so no host copy and no full-size f32 temporary is made (Kaggle
    fs=128 is 17.3 GB in f32).
    """
    device = generator.device if device is None else torch.device(device)
    bottom = init_mlp(generator, config.bottom_mlp_sizes,
                      config.weight_dtype, device)
    top = init_mlp(generator, config.full_top_mlp_sizes, config.weight_dtype,
                   device)
    shape = (config.total_rows, config.feature_size)
    if emb_init == "scaled_uniform":
        emb = torch.empty(shape, dtype=config.embedding_dtype, device=device)
        emb.uniform_(-1.0, 1.0, generator=generator)
        for t, n in enumerate(config.table_sizes):
            emb_ops.get_logical_table(emb, config, t).mul_(n ** -0.5)
    elif emb_init == "zeros":
        emb = torch.zeros(shape, dtype=config.embedding_dtype, device=device)
    else:
        raise ValueError(emb_init)
    return {"bottom": bottom, "emb": emb, "top": top}


def forward_from_pooled(dense_params: dict, pooled: torch.Tensor,
                        dense: torch.Tensor, config: DLRMConfig
                        ) -> torch.Tensor:
    """Forward pass given already-pooled embedding vectors (B, T, D).  The
    stages run under the phase scopes ``bottom_mlp``, ``interaction`` and
    ``top_mlp`` (``utils/telemetry.phase_scope``)."""
    cd = config.compute_dtype
    cd = None if cd == dense_params["bottom"][0]["w"].dtype else cd
    with phase_scope("bottom_mlp"):
        x = mlp_apply(dense_params["bottom"], dense, final="relu",
                      compute_dtype=cd)
    with phase_scope("interaction"):
        z = _INTERACTIONS[config.interaction_impl](
            x, pooled.to(x.dtype), pad_to=config.interaction_pad_to)
    with phase_scope("top_mlp"):
        out = mlp_apply(dense_params["top"], z, final="sigmoid",
                        compute_dtype=cd)
    return out[:, 0]


def loss_from_pooled(dense_params: dict, pooled: torch.Tensor,
                     dense: torch.Tensor, labels: torch.Tensor,
                     config: DLRMConfig) -> torch.Tensor:
    """BCE loss of the dense tower given pooled embeddings: the one loss
    closure of every training path.  With ``config.remat`` the dense tower
    runs under ``torch.utils.checkpoint`` and is recomputed on backward
    (the counterpart of ``jax.checkpoint``); the gradients are the same."""
    if config.remat:
        out = checkpoint(forward_from_pooled, dense_params, pooled, dense,
                         config, use_reentrant=False)
    else:
        out = forward_from_pooled(dense_params, pooled, dense, config)
    return bce_loss(out, labels)


def forward(params: dict, dense: torch.Tensor, sparse: torch.Tensor,
            config: DLRMConfig) -> torch.Tensor:
    """Full forward: (dense (B,13), sparse ids (B,T[,H])) -> CTR (B,).
    ``params["emb"]`` is the ``(total_rows, D)`` stack or its int8
    ``QuantEmb`` (``ops/quant.py``).  The lookup runs under the phase
    scope ``lookup``."""
    emb = params["emb"]
    if isinstance(emb, QuantEmb):
        check_quant_storage(emb, config)
    elif tuple(emb.shape) != (config.total_rows, config.feature_size):
        raise ValueError(f"params['emb'] has shape {tuple(emb.shape)}, the "
                         f"config needs ({config.total_rows}, "
                         f"{config.feature_size})")
    with phase_scope("lookup"):
        pooled = emb_ops.mixed_lookup(emb, sparse, config)
    dense_params, _ = split_params(params)
    return forward_from_pooled(dense_params, pooled, dense, config)


def split_params(params: dict):
    """(dense_params, emb)."""
    return {"bottom": params["bottom"], "top": params["top"]}, params["emb"]


def merge_params(dense_params: dict, emb: torch.Tensor) -> dict:
    return {"bottom": dense_params["bottom"], "emb": emb,
            "top": dense_params["top"]}


def get_table(params_or_emb, config: DLRMConfig, i: int) -> torch.Tensor:
    """Table ``i`` as a (rows, D) view."""
    emb = params_or_emb["emb"] if isinstance(params_or_emb, dict) \
        else params_or_emb
    return emb_ops.get_logical_table(emb, config, i)
