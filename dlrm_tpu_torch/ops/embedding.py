"""Embedding lookup: the lookup subset of ``dlrm_tpu/ops/embedding.py``.

All tables share one embedding dimension and are stacked row-wise into one
logical ``(total_rows, D)`` tensor, so a batch's lookups over every table
are one gather; per-table ids are translated by the tables' row offsets.
Multi-hot lookups are gathered as (B, T, H, D) and sum-pooled over H.

The JAX package's lane packing, chunking and one-hot matmul path for small
tables are TPU layout and are not carried over; ``mixed_lookup`` gives the
results of the JAX package's ``mixed_lookup`` from a plain gather.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def translate_ids(ids: torch.Tensor, offsets: Sequence[int]) -> torch.Tensor:
    """Per-table ids -> stacked-table row indices.

    ``ids``: (T,), (B, T) or (B, T, H) integer, 0-based per table.  The
    table axis is told by RANK, never by axis length: when ``n_hot`` equals
    the table count, a test on the last axis would add the offsets along
    the hot axis.
    """
    offs = torch.as_tensor(offsets, dtype=ids.dtype, device=ids.device)
    table_axis = 1 if ids.dim() == 3 else ids.dim() - 1
    if ids.shape[table_axis] != len(offsets):
        raise ValueError(f"ids of shape {tuple(ids.shape)} do not match "
                         f"{len(offsets)} tables")
    if ids.dim() == 3:  # (B, T, H): broadcast offsets over the hot axis
        return ids + offs[:, None]
    return ids + offs


def gather_rows(emb: torch.Tensor, flat_ids: torch.Tensor) -> torch.Tensor:
    """One gather of all lookups: ``(R, D)[ids] -> ids.shape + (D,)``."""
    rows = torch.index_select(emb, 0, flat_ids.reshape(-1))
    return rows.reshape(*flat_ids.shape, emb.shape[1])


def pool(rows: torch.Tensor) -> torch.Tensor:
    """Sum-pool the hot axis: (B, T, H, D) -> (B, T, D); identity for
    one-hot (B, T, D) input."""
    if rows.dim() == 4:
        return rows.sum(dim=2)
    return rows


def lookup(emb: torch.Tensor, ids: torch.Tensor, offsets) -> torch.Tensor:
    """Per-table ids -> pooled per-table embedding vectors."""
    return pool(gather_rows(emb, translate_ids(ids, offsets)))


def partition_tables(table_sizes, threshold: int
                     ) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """Split table indices into (small, big) by row count."""
    small = [i for i, s in enumerate(table_sizes) if s <= threshold]
    big = [i for i, s in enumerate(table_sizes) if s > threshold]
    return tuple(small), tuple(big)


def get_logical_table(emb: torch.Tensor, config, t: int) -> torch.Tensor:
    """Table ``t`` as a (rows, D) view of the stacked tensor."""
    off = config.table_offsets[t]
    return emb[off:off + config.table_sizes[t]]


def mixed_lookup(emb: torch.Tensor, ids: torch.Tensor, config
                 ) -> torch.Tensor:
    """Pooled lookup with the results of the JAX package's ``mixed_lookup``.

    There, tables of at most ``config.small_table_threshold`` rows are
    looked up by a one-hot matmul whose table operand is cast to
    ``config.compute_dtype`` and whose sums run in f32, cast back to the
    table dtype at the end.  Here every table is gathered; for the small
    tables the gathered rows take the same rounding and f32 pooling.  Where
    the compute dtype holds the table dtype exactly (f32, or the table
    dtype itself) that is the plain lookup.
    """
    rows = gather_rows(emb, translate_ids(ids, config.table_offsets))
    small, _ = partition_tables(config.table_sizes,
                                config.small_table_threshold)
    cd = config.compute_dtype
    if not small or cd in (torch.float32, emb.dtype):
        return pool(rows)
    idx = torch.as_tensor(small, device=rows.device)
    small_rows = rows.index_select(1, idx).to(cd).float()
    pooled = pool(rows)
    return pooled.index_copy(1, idx, pool(small_rows).to(pooled.dtype))
