"""Dot-product feature interaction in plain torch: the counterpart of
``dlrm_tpu/ops/interaction.py``.

Stack the bottom-MLP output with the pooled embeddings into T = (B, F, d),
form the Gram matrix Z = T Tᵀ, take its strictly-lower triangle in row-major
(i, j), i > j order, and concatenate it after the bottom-MLP output,
zero-padding the width up to a multiple of ``pad_to``.  The fused CUDA kernel
in ``interaction_fused.py`` computes the same thing without writing Z.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=None)
def _tril_pairs(f: int):
    li, lj = torch.tril_indices(f, f, offset=-1)
    return li, lj


def tril_flat_indices(f: int) -> torch.Tensor:
    """Flattened indices of the strictly-lower triangle of an (f, f) matrix,
    ordered (1,0), (2,0), (2,1), (3,0), ... — the DLRM pair order."""
    li, lj = _tril_pairs(f)
    return li * f + lj


def stack_features(x: torch.Tensor, feats: torch.Tensor) -> torch.Tensor:
    """Build the interaction input T = (B, F, d).

    ``x``: bottom-MLP output (B, d).  ``feats``: pooled embeddings
    (B, T, fs); when fs != d the embedding block is re-chunked into d-wide
    features (``DLRMConfig`` guarantees T*fs % d == 0).
    """
    b, d = x.shape
    emb = feats.reshape(b, -1, d)
    return torch.cat([x[:, None, :], emb], dim=1)


def _pad_width(out: torch.Tensor, pad_to: int) -> torch.Tensor:
    width = out.shape[1]
    padded = pad_to * ((width + pad_to - 1) // pad_to)
    if padded != width:
        out = F.pad(out, (0, padded - width))
    return out


def dot_interaction(x: torch.Tensor, feats: torch.Tensor, pad_to: int = 1
                    ) -> torch.Tensor:
    """Interaction output (B, d + F(F-1)/2 + padding), Gram formulation:
    a batched matmul in f32, then the triangular index."""
    t = stack_features(x, feats)
    b, f, _ = t.shape
    tf = t.float()
    z = torch.bmm(tf, tf.transpose(1, 2)).to(t.dtype)
    zflat = z.reshape(b, f * f)[:, tril_flat_indices(f).to(z.device)]
    return _pad_width(torch.cat([x, zflat], dim=1), pad_to)


def dot_interaction_pairwise(x: torch.Tensor, feats: torch.Tensor,
                             pad_to: int = 1) -> torch.Tensor:
    """Only the P needed pair dots: elementwise products summed over d,
    in f32 (no F x F Gram matrix)."""
    t = stack_features(x, feats)
    li, lj = _tril_pairs(t.shape[1])
    li, lj = li.to(t.device), lj.to(t.device)
    prod = t[:, li, :].float() * t[:, lj, :].float()
    zflat = prod.sum(dim=-1).to(t.dtype)
    return _pad_width(torch.cat([x, zflat], dim=1), pad_to)
