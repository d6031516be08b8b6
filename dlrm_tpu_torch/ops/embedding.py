"""Embedding lookup and compressed sparse gradients: the counterpart of
``dlrm_tpu/ops/embedding.py``.

All tables share one embedding dimension and are stacked row-wise into one
logical ``(total_rows, D)`` tensor, so a batch's lookups over every table
are one gather; per-table ids are translated by the tables' row offsets.
Multi-hot lookups are gathered as (B, T, H, D) and sum-pooled over H.

Training never densifies a table gradient: ``sparse_value_and_grad`` runs
the gather outside autograd, so the gradient comes back per gathered row
(``SparseGrad``).  The table-update rules live here and every store (the
device stack, the host tier, the shards) calls them: SGD's
:func:`apply_sparse_sgd` and Adagrad's :func:`adagrad_rows`, which
:func:`apply_adagrad_rows` / :func:`apply_sparse_adagrad` apply to the
device stack.  Row-wise Adagrad on f32 tables on the card takes one sorted
segment sum instead (:func:`sort_hits`, then :func:`sorted_rowwise_adagrad`,
``csrc/sparse_adagrad.cu``): no ``unique``, no ``index_add_`` and no host
sync.  ``train/optim.py`` decides which update a step takes.

The JAX package's lane packing, chunking and one-hot matmul path for small
tables are TPU layout and are not carried over; ``mixed_lookup`` gives the
results of the JAX package's ``mixed_lookup`` from a plain gather.
"""

from __future__ import annotations

import ctypes
import functools
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
    the hot axis.  The offsets come from a device tensor made once per
    (offsets, device, dtype) (:func:`offsets_tensor`), so no call after
    the first copies them from the host.
    """
    offs = offsets_tensor(tuple(offsets), ids.device, ids.dtype)
    table_axis = 1 if ids.dim() == 3 else ids.dim() - 1
    if ids.shape[table_axis] != len(offsets):
        raise ValueError(f"ids of shape {tuple(ids.shape)} do not match "
                         f"{len(offsets)} tables")
    if ids.dim() == 3:  # (B, T, H): broadcast offsets over the hot axis
        return ids + offs[:, None]
    return ids + offs


@functools.lru_cache(maxsize=None)
def offsets_tensor(offsets: Tuple[int, ...], device: torch.device,
                   dtype: torch.dtype) -> torch.Tensor:
    """The tables' row offsets (or any tuple of ints, such as table
    indices) as a tensor on ``device``, one per (offsets, device, dtype):
    callers only read it."""
    return torch.as_tensor(offsets, dtype=dtype, device=device)


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
    the pool run under the phase scope ``lookup``, the backward's call
    under ``autograd.bwd``.
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
        with phase_scope("autograd.bwd"):
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
    by one ``index_add_`` in which each hit's ``-lr * g`` is added on its
    own, as the JAX package's scatter-add adds it: a row hit n times takes
    n adds in the table's dtype, not one add of its hits' sum.

    ``-lr * rows`` is an f32 product cast to the table's dtype, as the JAX
    package's f32 learning rate makes it.  ``ids`` and ``rows`` may keep
    the hits' layout, ``(...)`` and ``(..., D)``.  Every id must be a row
    of ``emb`` (trim the ``-1`` slots of :func:`dedup_sparse_grad` first).
    On CUDA the duplicate sums run in another order than on the CPU.
    Returns ``emb``.
    """
    upd = (grad.rows.float() * -lr).to(emb.dtype)
    return emb.index_add_(0, grad.ids.reshape(-1),
                          upd.reshape(-1, upd.shape[-1]))


def sum_duplicates(grad: SparseGrad) -> SparseGrad:
    """The distinct ids in ascending order with the f32 sum of each one's
    rows (no padding slots, so the length depends on the data; on CUDA
    ``unique`` reads it back, a host sync, and the sums run in a changing
    order), under the span ``dedup``."""
    with phase_scope("dedup"):
        uniq, inverse = torch.unique(grad.ids, sorted=True,
                                     return_inverse=True)
        rows = torch.zeros((uniq.shape[0], grad.rows.shape[1]),
                           dtype=torch.float32, device=grad.rows.device)
        rows.index_add_(0, inverse, grad.rows.float())
    return SparseGrad(ids=uniq, rows=rows)


# -- Adagrad on distinct rows -------------------------------------------------

ADAGRAD_EPS = 1e-10


def _rss_scale(acc_new: torch.Tensor) -> torch.Tensor:
    """optax.scale_by_rss: ``rsqrt(acc + eps)``, and 0 where acc == 0."""
    return torch.where(acc_new > 0, torch.rsqrt(acc_new + ADAGRAD_EPS),
                       torch.zeros_like(acc_new))


def adagrad_rows(acc_rows: torch.Tensor, g: torch.Tensor, lr, *,
                 rowwise: bool, scaled: Optional[torch.Tensor] = None,
                 g2: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Adagrad rule on distinct rows, wherever they are stored:
    ``acc_rows`` their accumulator, (n, D) or row-wise (n,), ``g`` (n, D)
    f32 their summed gradients.  Returns (the accumulator's f32 delta
    ``g2``: ``g^2``, row-wise ``mean_D(g^2)``, or as given where the caller
    sums the squares itself; the rows' f32 update ``g * rs * -lr``, ``rs =
    rsqrt(acc_rows + g2 + eps)``, 0 where that sum is 0).  With ``scaled``
    (the per-row sum of ``lr_k * g``, a scheduled block's twin payload) the
    update is ``-(scaled * rs)`` and ``lr`` is not used.  The caller adds
    both, the update cast to the table's dtype last."""
    if g2 is None:
        g2 = (g * g).mean(dim=1) if rowwise else g * g
    rs = _rss_scale(acc_rows + g2)
    if rowwise:
        rs = rs[:, None]
    if scaled is not None:
        g, lr = scaled, 1.0
    return g2, g * rs * -lr


def apply_adagrad_rows(emb: torch.Tensor, acc: torch.Tensor,
                       ids: torch.Tensor, g: torch.Tensor, lr, *,
                       rowwise: bool,
                       scaled: Optional[torch.Tensor] = None) -> None:
    """:func:`adagrad_rows` on the rows ``ids`` of the stacked table and its
    accumulator, in place.  Every id appears once and ``g`` (n, D) f32 is
    its summed gradient."""
    g2, upd = adagrad_rows(acc.index_select(0, ids), g, lr, rowwise=rowwise,
                           scaled=scaled)
    acc.index_add_(0, ids, g2)
    emb.index_add_(0, ids, upd.to(emb.dtype))


def apply_sparse_adagrad(emb: torch.Tensor, acc: torch.Tensor,
                         grad: SparseGrad, lr, *, rowwise: bool,
                         scaled_rows: Optional[torch.Tensor] = None) -> None:
    """Exact sparse Adagrad, dedup then apply, in place: the rows of
    duplicate ids are summed in f32 (:func:`sum_duplicates`: one ``unique``
    and one ``index_add_``), then :func:`apply_adagrad_rows` runs on the
    distinct rows.

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
    u = sum_duplicates(SparseGrad(grad.ids, rows))
    apply_adagrad_rows(emb, acc, u.ids, u.rows[:, :d], lr, rowwise=rowwise,
                       scaled=None if scaled_rows is None else u.rows[:, d:])


# -- the sorted segment sum: row-wise Adagrad with no unique and no sync -----

# csrc/sparse_adagrad.cu's kChunk: sorted hits a warp walks; the kernel
# leaves a head and a tail partial row a chunk.
SORTED_CHUNK = 128
_P = ctypes.c_void_p


class SortedHits(NamedTuple):
    """A step's hits in ascending stacked id, ties in hit order."""

    ids: torch.Tensor        # (n,) the ids, sorted
    positions: torch.Tensor  # (n,) int64: each sorted hit's place in the
                             # per-hit gradient


def sort_hits(ids: torch.Tensor) -> SortedHits:
    """A stable sort of a step's stacked ids carrying their hit positions
    (``torch.sort(stable=True)``: no host sync), under the span
    ``dedup``."""
    with phase_scope("dedup"):
        values, positions = torch.sort(ids, stable=True)
    return SortedHits(values, positions)


def sorted_update_takes(dim: int) -> bool:
    """Whether ``csrc/sparse_adagrad.cu`` takes rows of ``dim`` floats: up
    to 512 in 16-byte units (``dim`` a multiple of 4), or 128."""
    return 1 <= dim <= (512 if dim % 4 == 0 else 128)


def sorted_rowwise_adagrad_reference(emb: torch.Tensor, acc: torch.Tensor,
                                     hits: SortedHits, rows: torch.Tensor,
                                     lr: float) -> None:
    """Plain version of :func:`sorted_rowwise_adagrad`: each distinct id's
    rows summed in f32 by ``index_add_``, then :func:`apply_adagrad_rows`."""
    ids, counts = torch.unique_consecutive(hits.ids, return_counts=True)
    seg = torch.repeat_interleave(
        torch.arange(ids.numel(), device=ids.device), counts)
    g = torch.zeros((ids.numel(), rows.shape[1]), dtype=torch.float32,
                    device=rows.device)
    g.index_add_(0, seg, rows.index_select(0, hits.positions).float())
    apply_adagrad_rows(emb, acc, ids.long(), g, lr, rowwise=True)


def sorted_rowwise_adagrad(emb: torch.Tensor, acc: torch.Tensor,
                           hits: SortedHits, rows: torch.Tensor,
                           lr: float) -> None:
    """Row-wise Adagrad in place on the rows of the stacked table that the
    sorted hits name: each distinct row's per-hit gradients ``rows`` (n, D)
    summed in f32, then ``acc[r] += mean_D(g^2)`` and ``emb[r] -= lr * g *
    rsqrt(acc[r] + eps)``, 0 where ``acc[r] == 0``.

    CPU tensors: the plain version.  CUDA tensors: ``csrc/sparse_adagrad.cu``
    (two launches on the current stream, with a scratch of partial rows
    sized from the hit count; no host sync), or an error;
    ``sorted_rowwise_adagrad.launches`` counts calls that launched.
    ``lr`` is a host float."""
    tensors = (emb, acc, hits.ids, hits.positions, rows)
    if all(t.device.type == "cpu" for t in tensors):
        return sorted_rowwise_adagrad_reference(emb, acc, hits, rows, lr)
    device, n = emb.device, hits.ids.numel()
    d = emb.shape[1] if emb.dim() == 2 else 0
    if any(t.device != device for t in tensors):
        raise ValueError(f"sorted_rowwise_adagrad: tensors on "
                         f"{[str(t.device) for t in tensors]}, not all on "
                         f"{device}")
    if not (emb.dtype is acc.dtype is rows.dtype is torch.float32
            and hits.ids.dtype in (torch.int32, torch.int64)
            and hits.positions.dtype is torch.int64):
        raise TypeError(f"sorted_rowwise_adagrad: the kernel takes f32 "
                        f"table, accumulator and rows with int32/int64 ids "
                        f"and int64 positions, got "
                        f"{[t.dtype for t in tensors]}")
    if not (sorted_update_takes(d) and tuple(acc.shape) == emb.shape[:1]
            and tuple(rows.shape) == (n, d)
            and tuple(hits.positions.shape) == (n,)
            and hits.ids.dim() == 1
            and all(t.is_contiguous() for t in tensors)):
        raise ValueError(f"sorted_rowwise_adagrad: needs a contiguous "
                         f"(rows, D) table with D <= 512 (128 if D % 4), a "
                         f"(rows,) accumulator, (n, D) rows and (n,) ids "
                         f"and positions, got "
                         f"{[tuple(t.shape) for t in tensors]}")
    if n == 0:
        return
    chunks = -(-n // SORTED_CHUNK)
    partials = torch.empty((2 * chunks, d), dtype=torch.float32,
                           device=device)
    with torch.cuda.device(device):
        rc = _sorted_kernel()(
            hits.ids.data_ptr(), hits.ids.element_size(),
            hits.positions.data_ptr(), rows.data_ptr(), emb.data_ptr(),
            acc.data_ptr(), partials.data_ptr(), n, emb.shape[0], d, lr,
            torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sparse_adagrad kernel launch failed: CUDA error "
                           f"{rc} for {n} hits of {d} floats")
    sorted_rowwise_adagrad.launches += 1


sorted_rowwise_adagrad.launches = 0


def _sorted_kernel():
    """The C entry point of ``csrc/sparse_adagrad.cu``."""
    from dlrm_tpu_torch.ops.cuda_build import kernel
    return kernel("sparse_adagrad", (
        _P, ctypes.c_int, _P, _P, _P, _P, _P, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_float, _P),
        "sparse_adagrad_rowwise")


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
    that belong to ``tables``, in their original order; under the span
    ``grad_split``.  The table indices come from a device tensor made once
    per (tables, device) (:func:`offsets_tensor`)."""
    with phase_scope("grad_split"):
        idx = offsets_tensor(tuple(tables), grad.ids.device, torch.int64)
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
