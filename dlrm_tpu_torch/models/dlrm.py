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


INIT_CHUNK_ROWS = 1 << 20


def init_dense(generator: torch.Generator, config: DLRMConfig,
               device: torch.device) -> dict:
    """The bottom and top MLPs (Glorot normal, zero bias), drawn in this
    order before the tables."""
    return {"bottom": init_mlp(generator, config.bottom_mlp_sizes,
                               config.weight_dtype, device),
            "top": init_mlp(generator, config.full_top_mlp_sizes,
                            config.weight_dtype, device)}


def init_tables(generator: torch.Generator, config: DLRMConfig,
                tables: list, emb_init: str = "scaled_uniform") -> None:
    """Fill ``tables[t]``, table ``t``'s (rows, D) destination, in place.

    ``scaled_uniform``: U(-1/sqrt(rows), 1/sqrt(rows)), drawn as U(-1, 1)
    in the storage dtype and then scaled.  The draws go table by table in
    global order, in chunks of ``INIT_CHUNK_ROWS`` rows, so the bits do not
    depend on where each table lives: a destination on the generator's
    device is drawn in place, any other (a pinned host tier) through one
    chunk-sized staging buffer on that device.  No full-size temporary is
    made on either side (Kaggle fs=128 is 17.3 GB in f32)."""
    if emb_init not in ("scaled_uniform", "zeros"):
        raise ValueError(emb_init)
    staging = None
    for t, dst in enumerate(tables):
        if emb_init == "zeros":
            dst.zero_()
            continue
        scale = config.table_sizes[t] ** -0.5
        for lo in range(0, dst.shape[0], INIT_CHUNK_ROWS):
            part = dst[lo:lo + INIT_CHUNK_ROWS]
            buf = part
            if part.device.type != generator.device.type:
                if staging is None:
                    staging = torch.empty(
                        (INIT_CHUNK_ROWS, *dst.shape[1:]), dtype=dst.dtype,
                        device=generator.device)
                buf = staging[:part.shape[0]]
            buf.uniform_(-1.0, 1.0, generator=generator).mul_(scale)
            if buf is not part:  # stream-ordered before the next draw
                part.copy_(buf, non_blocking=True)
    if staging is not None and staging.is_cuda:
        torch.cuda.synchronize(staging.device)


def init_params(generator: torch.Generator, config: DLRMConfig,
                device: Optional[torch.device] = None,
                emb_init: str = "scaled_uniform") -> dict:
    """Initialize the parameter dict on ``device`` (default: the
    generator's device): :func:`init_dense`, then the stacked tables
    through :func:`init_tables`."""
    device = generator.device if device is None else torch.device(device)
    params = init_dense(generator, config, device)
    emb = torch.empty((config.total_rows, config.feature_size),
                      dtype=config.embedding_dtype, device=device)
    init_tables(generator, config,
                [emb_ops.get_logical_table(emb, config, t)
                 for t in range(config.num_tables)], emb_init)
    return {"bottom": params["bottom"], "emb": emb, "top": params["top"]}


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
    ``params["emb"]`` is the ``(total_rows, D)`` stack, its int8
    ``QuantEmb`` (``ops/quant.py``) or its two tiers (``TieredEmb``,
    ``parallel/host_tier.py``).  The lookup runs under the phase scope
    ``lookup``."""
    from dlrm_tpu_torch.parallel.host_tier import (TieredEmb,
                                                   check_tiered_storage)

    emb = params["emb"]
    if isinstance(emb, QuantEmb):
        check_quant_storage(emb, config)
    elif isinstance(emb, TieredEmb):
        check_tiered_storage(emb, config)
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
