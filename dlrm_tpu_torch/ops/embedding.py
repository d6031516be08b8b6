"""Embedding lookup and compressed sparse gradients: the counterpart of
``dlrm_tpu/ops/embedding.py``.

All tables share one embedding dimension and are stacked row-wise into one
logical ``(total_rows, D)`` tensor, so a batch's lookups over every table
are one gather; per-table ids are translated by the tables' row offsets.
Multi-hot lookups are gathered as (B, T, H, D) and sum-pooled over H.

Training never densifies a table gradient: ``sparse_value_and_grad`` runs
the gather outside autograd, so the gradient comes back per gathered row
(``SparseGrad``), and ``apply_sparse_sgd`` applies it with one
``index_add_``, which sums duplicate ids.

The JAX package's lane packing, chunking and one-hot matmul path for small
tables are TPU layout and are not carried over; ``mixed_lookup`` gives the
results of the JAX package's ``mixed_lookup`` from a plain gather.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import torch

from dlrm_tpu_torch.utils.telemetry import phase_scope


class SparseGrad(NamedTuple):
    """Compressed embedding gradient: ``rows[i]`` is the gradient with
    respect to the stacked-table row ``ids[i]``.  Duplicate ids are
    contributions to be summed."""

    ids: torch.Tensor   # (n,) integer, rows of the stacked table
    rows: torch.Tensor  # (n, D)


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


def mixed_pool(rows: torch.Tensor, config, small=None) -> torch.Tensor:
    """Pool gathered rows (B, T[, H], D) of every table with the results
    of the JAX package's ``mixed_lookup``.

    There, tables of at most ``config.small_table_threshold`` rows are
    looked up by a one-hot matmul whose table operand is cast to
    ``config.compute_dtype`` and whose sums run in f32, cast back to the
    table dtype at the end.  Here every table is gathered; for the small
    tables the gathered rows take the same rounding and f32 pooling.  Where
    the compute dtype holds the table dtype exactly (f32, or the table
    dtype itself) that is the plain pool.  Differentiable in ``rows``.
    ``small``: the columns that take that rounding (default: the config's
    small tables).
    """
    if small is None:
        small, _ = partition_tables(config.table_sizes,
                                    config.small_table_threshold)
    cd = config.compute_dtype
    if not small or cd in (torch.float32, rows.dtype):
        return pool(rows)
    idx = torch.as_tensor(small, device=rows.device)
    small_rows = rows.index_select(1, idx).to(cd).float()
    pooled = pool(rows)
    return pooled.index_copy(1, idx, pool(small_rows).to(pooled.dtype))


def mixed_lookup(emb, ids: torch.Tensor, config) -> torch.Tensor:
    """Pooled lookup with the results of the JAX package's
    ``mixed_lookup`` (see :func:`mixed_pool`).  An int8 ``QuantEmb``
    (``ops/quant.py``) takes the dequantizing lookup, two-tier tables
    (``parallel/host_tier.TieredEmb``) the lookup across both tiers."""
    from dlrm_tpu_torch.ops import quant
    from dlrm_tpu_torch.parallel import host_tier

    if isinstance(emb, quant.QuantEmb):
        return quant.quant_mixed_lookup(emb, ids, config)
    if isinstance(emb, host_tier.TieredEmb):
        return host_tier.tiered_lookup(emb, ids, config)
    return mixed_pool(gather_rows(emb, translate_ids(ids, config.table_offsets)),
                      config)


def tree_map(fn, dense_params: dict) -> dict:
    """Map over the leaves of a dense parameter dict
    ``{part: [{name: Tensor}]}`` (the model's ``bottom`` / ``top``)."""
    return {part: [{k: fn(v) for k, v in layer.items()} for layer in layers]
            for part, layers in dense_params.items()}


def tree_leaves(dense_params: dict) -> list:
    """The leaves of a dense parameter dict, in :func:`tree_map` order."""
    return [v for layers in dense_params.values() for layer in layers
            for v in layer.values()]


def sparse_value_and_grad(loss_fn: Callable, *,
                          pool_fn: Optional[Callable] = None) -> Callable:
    """Like the JAX package's ``sparse_value_and_grad``: value and
    gradients with a compressed embedding gradient.

    ``loss_fn(dense_params, pooled, *args)`` consumes the pooled lookup
    (B, T, D) and returns a 0-d loss.  The returned function::

        f(dense_params, emb, ids, offsets, *args) ->
            (value, (dense_grads, SparseGrad))

    gathers the rows outside autograd, so autograd yields d(loss)/d(rows)
    of shape (B, T[, H], D), returned flat with the stacked-table ids.
    ``dense_grads`` mirrors ``dense_params``; nothing is accumulated in
    ``.grad``.  ``pool_fn(rows)`` replaces the plain sum-pool (training
    passes :func:`mixed_pool`).  ``value`` is detached.  The gather and
    the pool run under the phase scope ``lookup``.
    """
    pool_fn = pool if pool_fn is None else pool_fn

    def wrapped(dense_params, emb, ids, offsets, *args):
        with phase_scope("lookup"):
            flat = translate_ids(ids, offsets)
            rows = gather_rows(emb, flat).detach().requires_grad_()
            pooled = pool_fn(rows)
        live = tree_map(lambda p: p.detach().requires_grad_(), dense_params)
        loss = loss_fn(live, pooled, *args)
        leaves = tree_leaves(live)
        grads = torch.autograd.grad(loss, leaves + [rows])
        it = iter(grads)
        dgrads = tree_map(lambda _: next(it), live)
        drows = grads[-1]
        sparse = SparseGrad(ids=flat.reshape(-1),
                            rows=drows.reshape(-1, drows.shape[-1]))
        return loss.detach(), (dgrads, sparse)

    return wrapped


def apply_sparse_sgd(emb: torch.Tensor, grad: SparseGrad, lr) -> torch.Tensor:
    """SGD step on the stacked table, in place: ``emb[ids] -= lr * rows``
    with duplicate ids summed (``index_add_``), the sum of per-hit
    gradients applied once as in the reference.

    ``-lr * rows`` is an f32 product cast to the table's dtype, as the JAX
    package's f32 learning rate makes it.  Every id must be a row of
    ``emb`` (trim the ``-1`` slots of :func:`dedup_sparse_grad` first).
    On CUDA the duplicate sums run in another order than on the CPU.
    Returns ``emb``.
    """
    upd = (grad.rows.float() * -lr).to(emb.dtype)
    return emb.index_add_(0, grad.ids, upd)


def sum_duplicates(grad: SparseGrad) -> SparseGrad:
    """The distinct ids in ascending order with the f32 sum of each one's
    rows (no padding slots, so the length depends on the data; on CUDA
    ``unique`` reads it back, a host sync, and the sums run in a changing
    order)."""
    uniq, inverse = torch.unique(grad.ids, sorted=True, return_inverse=True)
    rows = torch.zeros((uniq.shape[0], grad.rows.shape[1]),
                       dtype=torch.float32, device=grad.rows.device)
    rows.index_add_(0, inverse, grad.rows.float())
    return SparseGrad(ids=uniq, rows=rows)


def dedup_sparse_grad(grad: SparseGrad, *,
                      max_unique: Optional[int] = None) -> SparseGrad:
    """:func:`sum_duplicates` in the JAX package's fixed-size form (the
    reference's ``SparseIndexer``): ``max_unique`` slots (default: the
    input length), the distinct ids in ascending order first, then id
    ``-1`` with zero rows, in the gradient's dtype.  Ids past
    ``max_unique`` distinct ones are dropped.
    """
    max_unique = grad.ids.shape[0] if max_unique is None else max_unique
    u = sum_duplicates(grad)
    k = min(u.ids.shape[0], max_unique)
    ids = torch.full((max_unique,), -1, dtype=grad.ids.dtype,
                     device=grad.ids.device)
    rows = torch.zeros((max_unique, grad.rows.shape[1]),
                       dtype=grad.rows.dtype, device=grad.rows.device)
    ids[:k] = u.ids[:k]
    rows[:k] = u.rows[:k].to(grad.rows.dtype)
    return SparseGrad(ids=ids, rows=rows)


def split_by_tables(grad: SparseGrad, batch: int, num_tables: int,
                    tables: Sequence[int]) -> SparseGrad:
    """The entries of a per-hit gradient over all tables (as
    :func:`sparse_value_and_grad` returns it, flattened from (B, T[, H]))
    that belong to ``tables``, in their original order."""
    idx = torch.as_tensor(tables, device=grad.ids.device)
    ids = grad.ids.reshape(batch, num_tables, -1).index_select(1, idx)
    rows = grad.rows.reshape(batch, num_tables, -1, grad.rows.shape[-1]
                             ).index_select(1, idx)
    return SparseGrad(ids=ids.reshape(-1),
                      rows=rows.reshape(-1, rows.shape[-1]))


def uncompress(grad: SparseGrad, total_rows: int, dim: int) -> torch.Tensor:
    """Densify a SparseGrad (a test oracle); ids outside the table (the
    ``-1`` slots of :func:`dedup_sparse_grad`) are dropped."""
    dense = torch.zeros((total_rows, dim), dtype=grad.rows.dtype,
                        device=grad.rows.device)
    ok = (grad.ids >= 0) & (grad.ids < total_rows)
    return dense.index_add_(0, grad.ids[ok], grad.rows[ok])
