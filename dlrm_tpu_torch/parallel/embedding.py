"""Model-parallel embedding lookup and SGD update over a process group: the
counterpart of ``dlrm_tpu/parallel/embedding.py``.

The DLRM hybrid: the embedding tables are sharded over the ranks of the
table group (``parallel/placement.py``) while the batch is data-parallel
over the same ranks.  Rank r holds its local stack ``(local_rows, D)``
(the JAX package's ``(1, R, W)`` shard), the blocks of its row-sharded
tables inside it, and its ``(R_t, D / N)`` column shards.  One lookup::

    ids (b, T)  --all_gather_into_tensor-->  ids (N*b, T)   [ints: cheap]
    gather of the owned slots  -->  (N*b, K, D)
    --all_to_all_single-->  (N, b, K, D)   [batch-split, slot-concat]
    row-sharded tables: masked gather  --reduce_scatter_tensor-->  (b, n_rs, D)
    column-sharded tables: lane gather  --all_to_all_single-->  (N, b, D/N)
    one index_select of all three  -->  pooled (b, T, D), global table order

and the SGD update routes the gradient back with the inverse exchanges
(``all_to_all_single``; an ``all_gather_into_tensor`` of the row-sharded
columns, applied where the rank owns the row) and applies it with a local
``index_add_``: embedding gradients are never densified.  On a 2-D mesh
the DCN replicas' gradients are gathered first (:func:`_dcn_fold`), so
every replica applies the same update.

JAX's tiled ``all_to_all(split_axis=0, concat_axis=1)`` turns ``(B, K, D)``
into ``(B/N, N*K, D)``; ``all_to_all_single`` stacks along dim 0 instead.
The receive buffer is ``(N, b, K, D)``, and the transpose to ``(b, N*K,
D)``, the JAX package's ``out_column`` take and its ``output_order`` take
are one ``index_select`` (:func:`_exchange_index`) over one buffer that
every collective writes into.

Functions take and return this rank's rows: ``ids`` are its ``b`` rows of
the global batch (``parallel/mesh.local_batch_rows``), and the pooled rows
are those same ``b`` rows.  The layout functions (:func:`shard_tables`
and the rest) take numpy arrays or tensors, on any device.

Host-resident row-sharded tables (``placement.rs_host``) live in a second
per-rank stack ``emb_h`` ``(host_local_rows, D)`` in host memory registered
with the card (``parallel/host_tier._host_empty``).  Their rows are read
and written in place over PCIe by the host-tier kernels
(``host_tier.host_gather`` into their columns of the row-sharded exchange,
``host_tier.host_update_rows`` on distinct rows, a row's hits summed on the
card first); they join the same reduce-scatter and all-gather as the
device row shards.  A placement with host tables and no ``emb_h`` is
refused.

``sharded_update_adagrad`` is the exact dedup-then-apply Adagrad (and
row-wise Adagrad) on every kind: the routed rows of a key are summed --
over every rank's batch rows, every micro-step of a block and every DCN
replica -- before ``acc += g^2``.  Padding slots and ids a rank does not
own carry zero rows to the trash row of their stack, which stays 0.
:func:`make_dcn_replica_check` checks that the DCN replicas of a 2-D mesh
hold the same bits.

Int8 serving: ``sharded_lookup(scales=, cs_scales=)`` takes int8 stacks
(``ops/quant.quantize_sharded_stack`` and ``quantize_col_shards``) and
dequantizes every gathered row on its owning rank, before pooling, masking
and the exchange, which then carries f32 (or ``exchange_dtype``); the host
stack stays in full precision, as in the JAX package.

The layout also crosses files a table at a time: :func:`table_rows` reads
rows of one logical table out of the per-shard arrays of any placement
(numpy, or a checkpoint's leaves read a slice at a time), and
:func:`place_rows` writes them into one rank's tensors of another, so a
rank never holds more than one table's rows on the host.
:func:`draw_sharded_params` draws a rank's shard straight from the
initialiser's stream, the bits ``shard_tables(init_params(...))`` gives.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.distributed as dist

from dlrm_tpu_torch.config import DLRMConfig
from dlrm_tpu_torch.ops import embedding as emb_ops
from dlrm_tpu_torch.parallel import host_tier
from dlrm_tpu_torch.parallel.mesh import dcn_axis_of
from dlrm_tpu_torch.parallel.placement import TablePlacement
from dlrm_tpu_torch.utils.telemetry import phase_scope

# all_gather_into_tensor / reduce_scatter_tensor under their newer names
# where torch has them (the old ones warn there)
_all_gather = getattr(dist, "all_gather_single",
                      dist.all_gather_into_tensor)
_reduce_scatter = getattr(dist, "reduce_scatter_single",
                          dist.reduce_scatter_tensor)

# -- layout: the stack <-> per-shard stacks ------------------------------------

def _zeros(like, shape):
    if isinstance(like, torch.Tensor):
        return torch.zeros(shape, dtype=like.dtype, device=like.device)
    return np.zeros(shape, dtype=like.dtype)


def _empty(like, shape):
    if isinstance(like, torch.Tensor):
        return torch.empty(shape, dtype=like.dtype, device=like.device)
    return np.empty(shape, dtype=like.dtype)


def _blocks(placement: TablePlacement, k: int):
    """(shard, first row, end row) of row-sharded table k's blocks, the
    empty ones left out."""
    rows = placement.table_sizes[placement.row_sharded[k]]
    chunk = placement.rs_rows_per_shard[k]
    for shard in range(placement.num_shards):
        a, b = shard * chunk, min((shard + 1) * chunk, rows)
        if b > a:
            yield shard, a, b


def shard_tables(stacked, placement: TablePlacement, config: DLRMConfig):
    """The logical ``(R, D)`` stack -> the ``(N, local_rows, D)`` per-shard
    stacks (padding and the trash row zero).  Host-resident row-sharded
    tables are left out (:func:`shard_host_tables`), column-sharded ones
    too (:func:`shard_col_tables`)."""
    out = _zeros(stacked, (placement.num_shards, placement.local_rows,
                           stacked.shape[1]))
    for t in placement.slot_table_list:
        rows, go = config.table_sizes[t], config.table_offsets[t]
        lo = int(placement.table_local_offsets[t])
        out[int(placement.table_shard[t]), lo:lo + rows] = \
            stacked[go:go + rows]
    for k, t in enumerate(placement.row_sharded):
        if placement.rs_host[k]:
            continue
        lo, go = placement.rs_local_offsets[k], config.table_offsets[t]
        for shard, a, b in _blocks(placement, k):
            out[shard, lo:lo + b - a] = stacked[go + a:go + b]
    return out


def shard_host_tables(stacked, placement: TablePlacement,
                      config: DLRMConfig, shard=None, out=None):
    """The per-shard host stacks ``(N, host_local_rows, D)`` of the
    host-resident row-sharded tables (``placement.rs_host``), padding and
    the trash row zero.  ``shard``: only that shard's ``(host_local_rows,
    D)`` stack, written into ``out`` when given (a host tensor, e.g. from
    ``parallel.host_tier._host_empty``, so a stack on the card reaches
    registered host memory with no other copy)."""
    shape = (placement.host_local_rows, stacked.shape[1])
    if shard is None:
        out = _zeros(stacked, (placement.num_shards, *shape))
    elif out is None:
        out = _zeros(stacked, shape)
    elif tuple(out.shape) != shape:
        raise ValueError(f"out {tuple(out.shape)}: shard {shard}'s host "
                         f"stack is {shape}")
    else:
        out.zero_()
    for k, t in enumerate(placement.row_sharded):
        if not placement.rs_host[k]:
            continue
        lo, go = placement.rs_local_offsets[k], config.table_offsets[t]
        for s, a, b in _blocks(placement, k):
            if shard is None:
                out[s, lo:lo + b - a] = stacked[go + a:go + b]
            elif s == shard:
                out[lo:lo + b - a] = stacked[go + a:go + b]
    return out


def unshard_tables(sharded, placement: TablePlacement, config: DLRMConfig,
                   host=None):
    """Inverse of :func:`shard_tables`: the logical ``(R, D)`` stack.
    ``host``: the ``(N, host_local_rows, D)`` host stacks when the placement
    has host-resident tables (their rows stay zero without it).  Rows of
    column-sharded tables stay zero (:func:`unshard_col_tables`)."""
    out = _zeros(sharded, (config.total_rows, sharded.shape[-1]))
    for t in placement.slot_table_list:
        rows, go = config.table_sizes[t], config.table_offsets[t]
        lo = int(placement.table_local_offsets[t])
        out[go:go + rows] = sharded[int(placement.table_shard[t]),
                                    lo:lo + rows]
    for k, t in enumerate(placement.row_sharded):
        src = sharded
        if placement.rs_host[k]:
            if host is None:
                continue
            src = host
        lo, go = placement.rs_local_offsets[k], config.table_offsets[t]
        for shard, a, b in _blocks(placement, k):
            out[go + a:go + b] = src[shard, lo:lo + b - a]
    return out


def shard_col_tables(stacked, placement: TablePlacement,
                     config: DLRMConfig) -> tuple:
    """Column-sharded tables: the ``(R, D)`` stack -> one ``(N, R_t, D/N)``
    array per table (a copy), in ``placement.col_sharded`` order; shard s
    holds features ``[s * D/N, (s + 1) * D/N)``."""
    n, d = placement.num_shards, stacked.shape[1]
    if d % n:
        raise ValueError(f"column sharding splits D={d} over {n} shards")
    out = []
    for t in placement.col_sharded:
        go, rows = config.table_offsets[t], config.table_sizes[t]
        tab = stacked[go:go + rows].reshape(rows, n, d // n)
        shards = _empty(stacked, (n, rows, d // n))
        shards[...] = tab.transpose(0, 1) if isinstance(tab, torch.Tensor) \
            else tab.transpose(1, 0, 2)
        out.append(shards)
    return tuple(out)


def unshard_col_tables(cs_arrays, placement: TablePlacement) -> list:
    """Inverse of :func:`shard_col_tables`: the per-table ``(N, R_t,
    D/N)`` arrays -> the logical ``(R_t, D)`` tables (copies), in
    ``placement.col_sharded`` order."""
    out = []
    for arr in cs_arrays:
        n, rows, wc = arr.shape
        tab = _empty(arr, (rows, n * wc))
        tab.reshape(rows, n, wc)[...] = arr.transpose(0, 1) \
            if isinstance(arr, torch.Tensor) else arr.transpose(1, 0, 2)
        out.append(tab)
    return out


def placement_arrays(placement: TablePlacement, rank: int,
                     device="cpu") -> dict:
    """Rank ``rank``'s row of the slot metadata as ``(K,)`` int64 tensors
    on ``device``: ``slot_tables`` (global table per slot),
    ``slot_valid`` (1 for real slots) and ``slot_offsets`` (each slot's
    first row in the local stack; padding slots point at the trash
    row).  Made once a device: the tensors are shared, not to be
    written."""
    device = torch.device(device)
    return {name: _index_tensor(tuple(int(x) for x in a[rank]), device)
            for name, a in (("slot_tables", placement.slot_tables),
                            ("slot_valid", placement.slot_valid),
                            ("slot_offsets", placement.slot_local_offsets))}


def _as_rows(t):
    """A tensor of one value a row ``(rows,)`` as ``(rows, 1)``: a row-wise
    accumulator placed like its table."""
    return t.unsqueeze(-1) if t.dim() == 1 else t


def table_rows(arrays: dict, placement: TablePlacement, t: int, a: int,
               b: int) -> np.ndarray:
    """Rows ``[a, b)`` of logical table ``t`` as a numpy ``(b - a, W)``
    array, read out of the per-shard arrays of ``placement``: ``arrays``
    holds ``emb`` ``(N, local_rows, W)``, ``emb_h`` ``(N, host_local_rows,
    W)`` (host-resident tables; None without) and ``emb_cs`` one ``(N,
    R_t, W/N)`` array per column-sharded table, or ``(R_t,)`` (a row-wise
    accumulator, the same on every rank).  Any array that takes
    ``[shard, rows]`` indices serves: numpy, or ``io.checkpoint.Leaf
    .array()``, which reads only the rows asked for."""
    ks = placement.row_sharded
    if t in placement.col_sharded:
        arr = arrays["emb_cs"][placement.col_sharded.index(t)]
        if len(arr.shape) == 1:
            return np.asarray(arr[a:b])[:, None]
        x = np.asarray(arr[:, a:b])                # (N, b - a, W/N)
        return x.transpose(1, 0, 2).reshape(b - a, -1)
    if t not in ks:
        lo = int(placement.table_local_offsets[t])
        return np.asarray(arrays["emb"][int(placement.table_shard[t]),
                                        lo + a:lo + b])
    k = ks.index(t)
    src = arrays["emb_h"] if placement.rs_host[k] else arrays["emb"]
    lo, parts = placement.rs_local_offsets[k], []
    for shard, ba, bb in _blocks(placement, k):
        i0, i1 = max(a, ba), min(b, bb)
        if i1 > i0:
            parts.append(np.asarray(src[shard, lo + i0 - ba:lo + i1 - ba]))
    return np.concatenate(parts)


def place_rows(rows, t: int, a: int, placement: TablePlacement, index: int,
               out: dict) -> None:
    """Write rows ``[a, a + n)`` of logical table ``t`` (``rows`` ``(n,
    W)``, numpy or a tensor) into shard ``index``'s tensors of
    ``placement``, those of its rows that shard holds: ``out`` has ``emb``
    ``(local_rows, W)``, ``emb_h`` ``(host_local_rows, W)`` or None, and
    ``emb_cs``, per column-sharded table ``(R_t, W/N)`` (its lanes) or
    ``(R_t,)`` (every rank's copy).  A tensor ``(rows,)`` takes ``W =
    1``."""
    n = rows.shape[0]

    def put(dst, lo, part):  # one copy, across devices and dtypes
        part = torch.as_tensor(part)
        _as_rows(dst)[lo:lo + part.shape[0]].copy_(part)

    if t in placement.col_sharded:
        dst = out["emb_cs"][placement.col_sharded.index(t)]
        wc = _as_rows(dst).shape[1]
        lanes = slice(None) if rows.shape[1] == wc \
            else slice(index * wc, (index + 1) * wc)
        put(dst, a, rows[:, lanes])
        return
    if t not in placement.row_sharded:
        if int(placement.table_shard[t]) == index:
            put(out["emb"], int(placement.table_local_offsets[t]) + a, rows)
        return
    k = placement.row_sharded.index(t)
    chunk = placement.rs_rows_per_shard[k]
    ba, bb = index * chunk, min((index + 1) * chunk, placement.table_sizes[t])
    i0, i1 = max(a, ba), min(a + n, bb)
    if i1 > i0:
        dst = out["emb_h"] if placement.rs_host[k] else out["emb"]
        put(dst, placement.rs_local_offsets[k] + i0 - ba, rows[i0 - a:i1 - a])


def empty_shard(placement: TablePlacement, index: int, width: int, dtype,
                device, cs_width=None, host: bool = True) -> dict:
    """Zero tensors of shard ``index`` of ``placement``: ``emb``
    ``(local_rows, width)`` on ``device``, ``emb_h`` ``(host_local_rows,
    width)`` in host memory (registered with the card for a CUDA
    ``device``; None without host tables, or ``host`` false) and
    ``emb_cs``, one ``(R_t, cs_width)`` per column-sharded table (default
    ``width / N``)."""
    device = torch.device(device)
    cs_width = width // placement.num_shards if cs_width is None \
        else cs_width
    out = {"emb": torch.zeros((placement.local_rows, width), dtype=dtype,
                              device=device),
           "emb_h": None,
           "emb_cs": tuple(torch.zeros((placement.table_sizes[t], cs_width),
                                       dtype=dtype, device=device)
                           for t in placement.col_sharded)}
    if placement.host_row_sharded and host:
        out["emb_h"] = host_tier._host_empty(
            (placement.host_local_rows, width), dtype, device).zero_()
    return out


def draw_sharded_params(generator: torch.Generator,
                        placement: TablePlacement, config: DLRMConfig,
                        index: int, device=None) -> dict:
    """Shard ``index``'s parameters drawn straight from the initialiser:
    the dense towers (``models.dlrm.init_dense``), then every table's
    draws, table by table in chunks of ``models.dlrm.INIT_CHUNK_ROWS``
    rows, as ``models.dlrm.init_tables`` draws them (so the bits equal
    ``shard_tables(init_params(...))``'s), each chunk drawn into one
    staging buffer on the generator's device and only the rows this shard
    holds kept (host-resident ones in registered host memory).  No device
    ever holds the whole stack.  Returns ``{"bottom", "top", "emb",
    "emb_cs"}`` and ``"emb_h"`` with host tables, as
    ``train.sharded_train_step`` takes them."""
    from dlrm_tpu_torch.models.dlrm import INIT_CHUNK_ROWS, init_dense

    device = generator.device if device is None else torch.device(device)
    params = init_dense(generator, config, device)
    out = empty_shard(placement, index, config.feature_size,
                      config.embedding_dtype, device)
    staging = torch.empty((INIT_CHUNK_ROWS, config.feature_size),
                          dtype=config.embedding_dtype,
                          device=generator.device)
    for t, rows in enumerate(config.table_sizes):
        scale = rows ** -0.5
        for lo in range(0, rows, INIT_CHUNK_ROWS):
            buf = staging[:min(INIT_CHUNK_ROWS, rows - lo)]
            buf.uniform_(-1.0, 1.0, generator=generator).mul_(scale)
            place_rows(buf, t, lo, placement, index, out)
    if staging.is_cuda:
        torch.cuda.synchronize(staging.device)
    params.update(emb=out["emb"], emb_cs=out["emb_cs"])
    if out["emb_h"] is not None:
        params["emb_h"] = out["emb_h"]
    return params


# -- the exchange ---------------------------------------------------------------

def _xc(x: torch.Tensor, exchange_dtype) -> torch.Tensor:
    """A collective operand in the wire dtype (``exchange_dtype``, e.g.
    bf16: half the bytes); None keeps it.  Exactly one rounding at the
    exchange boundary: the collectives only move data, or add partials of
    which at most one is nonzero for a one-hot row-sharded lookup
    (multi-hot ones take one rounding more per owning shard)."""
    return x if exchange_dtype is None else x.to(exchange_dtype)


def _gather_rows_of(ids: torch.Tensor, group) -> torch.Tensor:
    """This rank's ids (b, ...) -> every rank's, rank-major (N*b, ...)."""
    n = dist.get_world_size(group)
    out = torch.empty((n * ids.shape[0], *ids.shape[1:]), dtype=ids.dtype,
                      device=ids.device)
    _all_gather(out, ids.contiguous(), group=group)
    return out


def _layout(placement: TablePlacement) -> tuple:
    """The placement as the hashable key of :func:`_exchange_index`: each
    table's (kind, position) -- (0, exchanged column) for a slot table,
    (1, k) for row-sharded table k, (2, k) for column-sharded table k --
    then N, K, and the row- and column-sharded counts."""
    col = dict(zip(placement.slot_table_list,
                   placement.out_column().tolist()))
    kinds = []
    for t in range(placement.num_tables):
        if t in col:
            kinds.append((0, col[t]))
        elif t in placement.row_sharded:
            kinds.append((1, placement.row_sharded.index(t)))
        else:
            kinds.append((2, placement.col_sharded.index(t)))
    return (tuple(kinds), placement.num_shards, placement.slots_per_shard,
            len(placement.row_sharded), len(placement.col_sharded))


def _regions(layout: tuple, b: int) -> Tuple[int, int, int]:
    """Rows of D of the exchange buffer's three regions (slot, row-sharded,
    column-sharded) for ``b`` rows a rank."""
    kinds, n, k, n_rs, n_cs = layout
    slot = n * b * k if any(kind == 0 for kind, _ in kinds) else 0
    return slot, n_rs * b, n_cs * b


@functools.lru_cache(maxsize=64)
def _exchange_index(layout: tuple, b: int, device: torch.device):
    """(the pooled index, the slot index) of the exchange buffer for ``b``
    rows a rank.

    The buffer holds, in rows of D: the slot all-to-all's receive buffer
    ``(N, b, K)``; the row-sharded reduce-scatter's ``(b, n_rs)``; each
    column-sharded table's all-to-all receive buffer ``(N, b, D/N)``, b
    rows of D.  The pooled index picks ``(b, T)`` rows of D in global table
    order -- with column-sharded tables, ``(b, T, N)`` pieces of D/N --
    so one ``index_select`` composes the transpose and both of the JAX
    package's takes.  The slot index is the slot tables' ``(b, T_slot)``
    rows of D, the rows the backward's send buffer fills."""
    kinds, n, k, n_rs, n_cs = layout
    slot_rows, rs_rows, _ = _regions(layout, b)
    bb = np.arange(b, dtype=np.int64)[:, None]
    rows = np.zeros((b, len(kinds)), np.int64)
    for t, (kind, pos) in enumerate(kinds):
        if kind == 0:    # receive buffer (N, b, K): shard-major
            rows[:, t:t + 1] = (pos // k) * b * k + pos % k + bb * k
        elif kind == 1:  # reduce-scatter output (b, n_rs)
            rows[:, t:t + 1] = slot_rows + bb * n_rs + pos
    slot_cols = [t for t, (kind, _) in enumerate(kinds) if kind == 0]
    slot_index = rows[:, slot_cols].reshape(-1)
    if not n_cs:
        pooled = rows.reshape(-1)
    else:            # pieces of D/N: N of them a row of D
        p = np.arange(n, dtype=np.int64)[None, :]
        pieces = rows[:, :, None] * n + p[None]
        for t, (kind, pos) in enumerate(kinds):
            if kind == 2:  # receive buffer (N, b, D/N)
                start = (slot_rows + rs_rows + pos * b) * n
                pieces[:, t, :] = start + p * b + bb
        pooled = pieces.reshape(-1)
    return (torch.as_tensor(pooled, device=device),
            torch.as_tensor(slot_index, device=device))


@functools.lru_cache(maxsize=64)
def _index_tensor(values: tuple, device: torch.device) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.int64, device=device)


def _local_rows_for_slots(ids_all: torch.Tensor, meta: dict) -> torch.Tensor:
    """This rank's local rows for its slots: global ids (B, T[, H]) ->
    (B, K[, H]) int64; padding slots resolve to the trash row."""
    own = ids_all.index_select(1, meta["slot_tables"])
    valid, offs = meta["slot_valid"], meta["slot_offsets"]
    if own.dim() == 3:
        valid, offs = valid[:, None], offs[:, None]
    return own * valid + offs


def _rs_trash(placement: TablePlacement) -> tuple:
    """The trash row of the stack each row-sharded table lives in."""
    return tuple(placement.host_local_rows - 1 if host
                 else placement.trash_row for host in placement.rs_host)


def _rs_split(placement: TablePlacement) -> Tuple[tuple, tuple]:
    """(positions k of the device row-sharded tables, of the host ones)."""
    dev = tuple(k for k, h in enumerate(placement.rs_host) if not h)
    host = tuple(k for k, h in enumerate(placement.rs_host) if h)
    return dev, host


def _rs_translate(ids_rs: torch.Tensor, placement: TablePlacement,
                  my_idx: int):
    """Row-sharded tables: global ids (B, n_rs[, H]) -> (local row, owned)
    for this rank's contiguous blocks, rows of the stack each table lives
    in (the device stack, or the host stack for ``rs_host`` tables); ids it
    does not own go to that stack's trash row."""
    dev = ids_rs.device
    chunk = _index_tensor(placement.rs_rows_per_shard, dev)
    lo = _index_tensor(placement.rs_local_offsets, dev)
    trash = _index_tensor(_rs_trash(placement), dev)
    if ids_rs.dim() == 3:
        chunk, lo, trash = chunk[:, None], lo[:, None], trash[:, None]
    owned = ids_rs // chunk == my_idx
    local = torch.where(owned, lo + ids_rs - my_idx * chunk, trash)
    return local, owned


def _columns(x: torch.Tensor, ks: tuple) -> torch.Tensor:
    """Columns ``ks`` of axis 1 (a copy)."""
    return x.index_select(1, _index_tensor(ks, x.device))


def _check_quant(placement: TablePlacement, emb, cs, scales,
                 cs_scales) -> None:
    """int8 stacks go with their scales, one f32 a logical row."""
    if scales is None:
        if emb.dtype == torch.int8:
            raise ValueError("int8 table stack without scales: pass the "
                             "scales of ops.quant.quantize_sharded_stack")
        return
    if emb.dtype != torch.int8 or any(c.dtype != torch.int8 for c in cs):
        raise ValueError(f"scales go with int8 tables (ops.quant"
                         f".quantize_sharded_stack), not {emb.dtype}")
    want = [(placement.local_rows,)] + [(placement.table_sizes[t],)
                                        for t in placement.col_sharded]
    got = [tuple(scales.shape)] + [tuple(c.shape) for c in cs_scales]
    if got != want or scales.dtype != torch.float32:
        raise ValueError(f"scales {got} {scales.dtype}: the placement needs "
                         f"{want} float32, one a logical row")


def _check_served(placement: TablePlacement, emb, emb_h=None) -> None:
    if not placement.host_row_sharded:
        return
    if emb_h is None:
        raise ValueError(
            f"placement has host-resident tables "
            f"{list(placement.host_row_sharded)} but no emb_h stack was "
            f"passed: the parameters are missing the host tier")
    float_emb = emb_h.dtype if emb.dtype == torch.int8 else emb.dtype
    if tuple(emb_h.shape) != (placement.host_local_rows, emb.shape[1]) \
            or emb_h.dtype != float_emb or emb_h.device.type != "cpu":
        raise ValueError(f"emb_h {tuple(emb_h.shape)} {emb_h.dtype} on "
                         f"{emb_h.device}: the placement needs the host "
                         f"stack ({placement.host_local_rows}, "
                         f"{emb.shape[1]}) {emb.dtype} in host memory")


def _table_group(mesh, axis: str, placement: TablePlacement):
    group = mesh.get_group(axis)
    n = dist.get_world_size(group)
    if n != placement.num_shards:
        raise ValueError(f"the placement has {placement.num_shards} shards, "
                         f"the mesh's {axis!r} axis {n} ranks")
    return group, mesh.get_local_rank(axis)


def _deq(rows: torch.Tensor, scales, idx: torch.Tensor) -> torch.Tensor:
    """Gathered rows ``(n, W)`` at local rows ``idx`` (n,), dequantized
    with their scales when ``scales`` is given (int8 serving); else as
    they are.  The int8 operand widens inside the multiply, exactly."""
    if scales is None:
        return rows
    return rows * scales.index_select(0, idx)[:, None]


def _lookup_body(emb, emb_h, cs, ids, meta, *, group, my_idx: int,
                 placement: TablePlacement, exchange_dtype=None,
                 scales=None, cs_scales=()):
    """This rank's local stack ``emb`` (local_rows, D), host stack
    ``emb_h`` (host_local_rows, D) or None, column shards ``cs`` (R_t,
    D/N), ids (b, T[, H]) -> pooled (b, T, D) in global table order.
    ``scales`` / ``cs_scales``: int8 ``emb`` and ``cs``, dequantized as
    they are gathered; the pooled rows are then f32."""
    b, d = ids.shape[0], emb.shape[1]
    layout = _layout(placement)
    n = placement.num_shards
    slot_rows, rs_rows, cs_rows = _regions(layout, b)
    val = torch.float32 if scales is not None else emb.dtype
    wire = val if exchange_dtype is None else exchange_dtype
    buf = torch.empty((slot_rows + rs_rows + cs_rows, d), dtype=wire,
                      device=emb.device)
    ids_all = _gather_rows_of(ids, group).long()
    if slot_rows:
        phys = _local_rows_for_slots(ids_all, meta)
        flat = phys.reshape(-1)
        rows = _deq(emb.index_select(0, flat), scales, flat)
        if phys.dim() == 3:  # pool the hot axis before the exchange
            rows = rows.view(*phys.shape, d).sum(dim=2)
        with phase_scope("a2a_fwd"):
            dist.all_to_all_single(buf[:slot_rows],
                                   _xc(rows, exchange_dtype).view(-1, d),
                                   group=group)
    if rs_rows:
        rs = _index_tensor(placement.row_sharded, emb.device)
        local, owned = _rs_translate(ids_all.index_select(1, rs), placement,
                                     my_idx)
        dev_k, host_k = _rs_split(placement)
        if dev_k:
            # host tables' columns read device row 0 here, then the host
            # gather writes them
            on_dev = local.index_fill(1, _index_tensor(host_k, emb.device),
                                      0) if host_k else local
            flat = on_dev.reshape(-1)
            rows = _deq(emb.index_select(0, flat), scales, flat).view(
                *local.shape, d)
        else:
            rows = torch.empty((*local.shape, d), dtype=val,
                               device=emb.device)
        if host_k:
            with phase_scope("host_rs_gather"):
                # the host stack stays in full precision: under int8 its
                # rows land in f32 columns, through a buffer of its dtype
                # when that differs
                into = rows if rows.dtype == emb_h.dtype else \
                    torch.empty(rows.shape, dtype=emb_h.dtype,
                                device=emb.device)
                host_tier.host_gather(emb_h, _columns(local, host_k),
                                      out=into, cols=host_k)
                if into is not rows:
                    cols = _index_tensor(host_k, emb.device)
                    rows.index_copy_(1, cols, into.index_select(
                        1, cols).to(rows.dtype))
        rows = rows * owned[..., None].to(rows.dtype)
        if rows.dim() == 4:
            rows = rows.sum(dim=2)
        with phase_scope("rs_reduce_scatter"):
            # each id is owned by one rank: the partials sum over ranks
            # and the batch splits in one collective
            _reduce_scatter(buf[slot_rows:slot_rows + rs_rows],
                            _xc(rows, exchange_dtype).view(-1, d),
                            group=group)
    for j, t in enumerate(placement.col_sharded):
        ids_t = ids_all[:, t]
        flat = ids_t.reshape(-1)
        rows = _deq(cs[j].index_select(0, flat),
                    cs_scales[j] if scales is not None else None, flat)
        if ids_t.dim() == 2:
            rows = rows.view(*ids_t.shape, -1).sum(dim=1)
        start = slot_rows + rs_rows + j * b
        with phase_scope("cs_a2a_fwd"):
            dist.all_to_all_single(
                buf[start:start + b].view(n * b, d // n),
                _xc(rows, exchange_dtype).contiguous(), group=group)
    with phase_scope("pooled_permute"):
        pooled_index, _ = _exchange_index(layout, b, emb.device)
        pieces = buf.view(-1, d // n) if cs_rows else buf
        pooled = pieces.index_select(0, pooled_index).view(
            b, placement.num_tables, d)
    return pooled.to(val)


def sharded_lookup(emb: torch.Tensor, ids: torch.Tensor, *, mesh,
                   placement: TablePlacement, axis: str = "d", cs=(),
                   emb_h=None, exchange_dtype=None,
                   scales=None, cs_scales=()) -> torch.Tensor:
    """Pooled lookup of this rank's ``b`` batch rows: ``emb`` its local
    stack ``(local_rows, D)``, ``cs`` its column shards ``(R_t, D/N)`` in
    ``placement.col_sharded`` order, ``emb_h`` its host stack
    ``(host_local_rows, D)`` when the placement has host-resident tables
    (read by ``host_tier.host_gather``), ``ids`` (b, T[, H]) -> (b, T,
    D).  Every rank of the mesh's ``axis`` group calls it with the same
    ``b``.  Runs outside autograd.

    ``exchange_dtype`` (e.g. ``torch.bfloat16``) carries the exchanges in
    that dtype: the result is the f32 lookup rounded once (one-hot).

    ``scales`` ``(local_rows,)`` and ``cs_scales`` (per column shard
    ``(R_t,)``): int8 serving.  ``emb`` and ``cs`` hold int8 codes
    (``ops.quant.quantize_sharded_stack``, ``quantize_col_shards``); each
    gathered row is multiplied by its scale on this rank before pooling
    and the exchange, and the result is f32.  ``emb_h`` stays in full
    precision."""
    if ids.dim() < 2 or ids.shape[1] != placement.num_tables:
        raise ValueError(f"ids of shape {tuple(ids.shape)} do not match "
                         f"{placement.num_tables} tables")
    _check_quant(placement, emb, tuple(cs), scales, tuple(cs_scales))
    _check_served(placement, emb, emb_h)
    group, my_idx = _table_group(mesh, axis, placement)
    meta = placement_arrays(placement, my_idx, emb.device)
    with torch.no_grad():
        return _lookup_body(emb, emb_h, cs, ids, meta, group=group,
                            my_idx=my_idx, placement=placement,
                            exchange_dtype=exchange_dtype, scales=scales,
                            cs_scales=tuple(cs_scales))


def _dcn_fold(ids, d_pooled, group, exchange_dtype=None):
    """Fold the DCN axis into the local batch for the update: gather the
    ids and the pooled gradients of every DCN replica, so that each applies
    the same global sparse update and the tables stay replicated across
    the axis (the compressed gradient moves, never a dense one)."""
    with phase_scope("dcn_grad_allgather"):
        ids = _gather_rows_of(ids, group)
        d = _gather_rows_of(_xc(d_pooled, exchange_dtype), group)
    return ids, d.to(d_pooled.dtype)


# -- the gradient routed back to the owners ------------------------------------

def _slot_grads(ids_all, d_pooled, meta, *, group, placement: TablePlacement,
                exchange_dtype=None):
    """Slot tables: (local rows (N*b, K[, H]), gradient rows (N*b, K[, H],
    W)) of this rank's slots, routed back by the inverse all-to-all; a
    padding slot is the trash row with zero rows.  ``d_pooled`` (b, T, W):
    W is D, or 2D for the twin payload."""
    b, w = d_pooled.shape[0], d_pooled.shape[-1]
    n, k = placement.num_shards, placement.slots_per_shard
    dt = d_pooled.dtype
    layout = _layout(placement)
    slot_rows = _regions(layout, b)[0]
    wire = dt if exchange_dtype is None else exchange_dtype
    _, slot_index = _exchange_index(layout, b, d_pooled.device)
    slots = _index_tensor(placement.slot_table_list, d_pooled.device)
    padded = bool((placement.slot_valid == 0).any())
    with phase_scope("a2a_bwd"):
        # the forward's receive layout is this send layout: row (shard,
        # batch row, slot); padding slots send zeros
        send = (torch.zeros if padded else torch.empty)(
            (slot_rows, w), dtype=wire, device=d_pooled.device)
        send.index_copy_(0, slot_index, _xc(
            d_pooled.index_select(1, slots), exchange_dtype).view(-1, w))
        back = torch.empty_like(send)
        dist.all_to_all_single(back, send, group=group)
    phys = _local_rows_for_slots(ids_all, meta)
    back = back.view(n * b, k, w).to(dt)
    if phys.dim() == 3:  # sum-pooled multi-hot: each hit gets it
        back = back[:, :, None, :].expand(*phys.shape, w)
    return phys, back


def _rs_grads(ids_all, d_pooled, *, group, my_idx: int,
              placement: TablePlacement, exchange_dtype=None):
    """Row-sharded tables: (local rows (N*b, n_rs[, H]) in each table's
    stack, gradient rows (N*b, n_rs[, H], W)) after the all-gather of
    their columns; ids this rank does not own are its trash rows with
    zero rows."""
    w, dt = d_pooled.shape[-1], d_pooled.dtype
    rs = _index_tensor(placement.row_sharded, d_pooled.device)
    with phase_scope("rs_allgather_bwd"):
        g = _gather_rows_of(_xc(d_pooled.index_select(1, rs),
                                exchange_dtype), group).to(dt)
    ids_rs = ids_all.index_select(1, rs)
    local, owned = _rs_translate(ids_rs, placement, my_idx)
    if ids_rs.dim() == 3:
        g = g[:, :, None, :].expand(*ids_rs.shape, w)
    return local, g * owned[..., None].to(dt)


def _cs_grads(ids_all, cols, t: int, *, group, n: int, exchange_dtype=None):
    """Column-sharded table t: (ids (N*b[, H]), this rank's lanes of their
    gradient (N*b[, H], W/N)), routed by the inverse of the forward's
    all-to-all from ``cols`` (b, W)."""
    b, w = cols.shape
    with phase_scope("cs_a2a_bwd"):
        send = _xc(cols, exchange_dtype).reshape(b, n, w // n).transpose(
            0, 1).contiguous()
        g = torch.empty((n * b, w // n), dtype=send.dtype,
                        device=cols.device)
        dist.all_to_all_single(g, send.view(n * b, w // n), group=group)
    ids_t = ids_all[:, t]
    g = g.to(cols.dtype)
    if ids_t.dim() == 2:
        g = g[:, None, :].expand(*ids_t.shape, w // n)
    return ids_t, g


def _update_body(emb, emb_h, cs, ids, d_pooled, lr: float, meta, *, group,
                 my_idx: int, placement: TablePlacement,
                 exchange_dtype=None) -> None:
    """SGD on this rank's tables, in place: ``d_pooled`` (b, T, D) is the
    gradient of the pooled rows of its ``ids`` (b, T[, H]).  Slot tables
    take the inverse all-to-all, row-sharded tables all-gather their
    gradient columns and add the rows the rank owns, column-sharded tables
    take the inverse of their all-to-all; each then one ``index_add_``
    (host rows: one add a distinct row): ``ops.embedding.apply_sparse_sgd``
    and ``host_tier._host_sgd``."""
    slot_rows, rs_rows, _ = _regions(_layout(placement), d_pooled.shape[0])
    ids_all = _gather_rows_of(ids, group).long()
    if slot_rows:
        phys, back = _slot_grads(ids_all, d_pooled, meta, group=group,
                                 placement=placement,
                                 exchange_dtype=exchange_dtype)
        emb_ops.apply_sparse_sgd(emb, emb_ops.SparseGrad(phys, back), lr)
    if rs_rows:
        local, g = _rs_grads(ids_all, d_pooled, group=group, my_idx=my_idx,
                             placement=placement,
                             exchange_dtype=exchange_dtype)
        dev_k, host_k = _rs_split(placement)
        if host_k:
            with phase_scope("host_rs_update"):
                host_tier._host_sgd(emb_h, _columns(local, host_k),
                                    _columns(g, host_k), lr)
            if dev_k:
                local, g = _columns(local, dev_k), _columns(g, dev_k)
        if dev_k:
            emb_ops.apply_sparse_sgd(emb, emb_ops.SparseGrad(local, g), lr)
    for j, t in enumerate(placement.col_sharded):
        ids_t, g = _cs_grads(ids_all, d_pooled[:, t], t, group=group,
                             n=placement.num_shards,
                             exchange_dtype=exchange_dtype)
        emb_ops.apply_sparse_sgd(cs[j], emb_ops.SparseGrad(ids_t, g), lr)


def _fold_batch(ids, d_pooled, block_leading: bool, mesh, axis: str,
                exchange_dtype):
    """The update's batch: a block's leading micro-step axis folded into
    the rows, then (2-D mesh) every DCN replica's rows gathered."""
    if block_leading:
        ids = ids.reshape(-1, *ids.shape[2:])
        d_pooled = d_pooled.reshape(-1, *d_pooled.shape[2:])
    dcn = dcn_axis_of(mesh, axis)
    if dcn is not None:
        ids, d_pooled = _dcn_fold(ids, d_pooled, mesh.get_group(dcn),
                                  exchange_dtype)
    return ids, d_pooled


def _check_trainable(emb) -> None:
    if emb.dtype == torch.int8:
        raise ValueError("int8 tables are inference-only; train f32 or bf16 "
                         "tables and quantize after")


def sharded_update_sgd(emb: torch.Tensor, ids: torch.Tensor,
                       d_pooled: torch.Tensor, lr, *, mesh,
                       placement: TablePlacement, axis: str = "d", cs=(),
                       emb_h=None, block_leading: bool = False,
                       exchange_dtype=None) -> None:
    """Apply the compressed embedding gradient ``d_pooled`` (b, T, D) of
    this rank's batch rows ``ids`` (b, T[, H]) to the sharded tables with
    SGD, in place: ``emb`` the local stack, ``cs`` the column shards,
    ``emb_h`` the host stack (host-resident tables).  On a 2-D mesh the
    DCN replicas' gradients are folded in first.  ``block_leading``: ids
    and ``d_pooled`` are (K, b, ...), K micro-steps' gradients applied in
    one pass.  ``lr`` is taken as the f32 value the JAX package computes
    with; padding slots and ids a rank does not own add zeros to the trash
    row of their stack.  Host rows sum their hits in f32 on the card and
    take one add each, where the JAX package adds every hit."""
    _check_trainable(emb)
    _check_served(placement, emb, emb_h)
    group, my_idx = _table_group(mesh, axis, placement)
    ids, d_pooled = _fold_batch(ids, d_pooled, block_leading, mesh, axis,
                                exchange_dtype)
    meta = placement_arrays(placement, my_idx, emb.device)
    with torch.no_grad():
        _update_body(emb, emb_h, cs, ids, d_pooled, float(np.float32(lr)),
                     meta, group=group, my_idx=my_idx, placement=placement,
                     exchange_dtype=exchange_dtype)


# -- Adagrad ----------------------------------------------------------------

def _cs_rowwise(cs_t, acc_t, u: emb_ops.SparseGrad, wc: int, dim: int,
                lr: float, group, twin: bool) -> None:
    """Row-wise Adagrad on one column-sharded table, sparse form: every
    rank holds the same ids after the all-gather, so the same distinct ids
    ``u.ids`` (U,) in the same order; one all-reduce of their lanes' sum
    of squares (U,) completes the full-D sum, and every rank folds the
    same row means into its copy of the ``(R_t,)`` accumulator
    (``ops.embedding.adagrad_rows`` with that mean as its delta)."""
    g = u.rows[:, :wc]
    s2 = (g * g).sum(dim=1)
    dist.all_reduce(s2, group=group)
    g2, upd = emb_ops.adagrad_rows(
        acc_t.index_select(0, u.ids), g, lr, rowwise=True,
        scaled=u.rows[:, wc:] if twin else None, g2=s2 / dim)
    acc_t.index_add_(0, u.ids, g2)
    cs_t.index_add_(0, u.ids, upd.to(cs_t.dtype))


def _update_body_adagrad(emb, acc, emb_h, acc_h, cs, acc_cs, ids, d_pooled,
                         lr: float, meta, *, group, my_idx: int,
                         placement: TablePlacement, twin: bool,
                         rowwise: bool, exchange_dtype=None) -> None:
    """Adagrad (``rowwise``: row-wise Adagrad) on this rank's tables, in
    place, with :func:`_update_body`'s routing.  The device stack's keys
    (slot and device row-shard rows) are deduplicated together, the host
    stack's and each column shard's on their own; then one exact
    dedup-then-apply step each.  ``twin``: ``d_pooled`` carries ``(g,
    lr_k * g)`` on its feature axis; the accumulator takes the raw half,
    the weights the scaled one with lr 1."""
    width = d_pooled.shape[-1]
    dim = width // 2 if twin else width
    opt = "rowwise_adagrad" if rowwise else "adagrad"
    slot_rows, rs_rows, _ = _regions(_layout(placement), d_pooled.shape[0])
    ids_all = _gather_rows_of(ids, group).long()
    keys, grads = [], []
    if slot_rows:
        phys, back = _slot_grads(ids_all, d_pooled, meta, group=group,
                                 placement=placement,
                                 exchange_dtype=exchange_dtype)
        keys.append(phys.reshape(-1))
        grads.append(back.reshape(-1, width))
    if rs_rows:
        local, g = _rs_grads(ids_all, d_pooled, group=group, my_idx=my_idx,
                             placement=placement,
                             exchange_dtype=exchange_dtype)
        dev_k, host_k = _rs_split(placement)
        if host_k:
            hg = _columns(g, host_k).reshape(-1, width).float()
            host_tier._host_tier_opt_apply(
                emb_h, acc_h, _columns(local, host_k).reshape(-1),
                hg[:, :dim], optimizer=opt, lr=lr,
                scaled=hg[:, dim:] if twin else None)
        if dev_k:
            if host_k:
                local, g = _columns(local, dev_k), _columns(g, dev_k)
            keys.append(local.reshape(-1))
            grads.append(g.reshape(-1, width))
    if keys:
        with phase_scope("adagrad_dedup"):
            u = emb_ops.sum_duplicates(emb_ops.SparseGrad(
                torch.cat(keys), torch.cat(grads).float()))
        emb_ops.apply_adagrad_rows(emb, acc, u.ids, u.rows[:, :dim], lr,
                                   rowwise=rowwise,
                                   scaled=u.rows[:, dim:] if twin else None)
    n = placement.num_shards
    for j, t in enumerate(placement.col_sharded):
        # the all-to-all splits the feature axis over the ranks: the twin
        # halves take separate exchanges (one would interleave their lanes)
        ids_t, g = _cs_grads(ids_all, d_pooled[:, t, :dim], t, group=group,
                             n=n, exchange_dtype=exchange_dtype)
        if twin:
            _, gs = _cs_grads(ids_all, d_pooled[:, t, dim:], t, group=group,
                              n=n, exchange_dtype=exchange_dtype)
            g = torch.cat([g, gs], dim=-1)
        wc = dim // n
        with phase_scope("cs_adagrad"):
            u = emb_ops.sum_duplicates(emb_ops.SparseGrad(
                ids_t.reshape(-1), g.reshape(-1, g.shape[-1]).float()))
            if rowwise:
                _cs_rowwise(cs[j], acc_cs[j], u, wc, dim, lr, group, twin)
            else:
                emb_ops.apply_adagrad_rows(
                    cs[j], acc_cs[j], u.ids, u.rows[:, :wc], lr,
                    rowwise=False, scaled=u.rows[:, wc:] if twin else None)


def sharded_update_adagrad(emb: torch.Tensor, acc: torch.Tensor,
                           ids: torch.Tensor, d_pooled: torch.Tensor, lr, *,
                           mesh, placement: TablePlacement, axis: str = "d",
                           cs=(), acc_cs=(), emb_h=None, acc_h=None,
                           block_leading: bool = False,
                           d_pooled_scaled=None, rowwise: bool = False,
                           exchange_dtype=None) -> None:
    """Sparse Adagrad (``rowwise``: row-wise Adagrad) on the sharded tables
    -- slot, device row-sharded, host row-sharded and column-sharded -- in
    place.  The accumulators (``train.init_sharded_opt_state``) lie beside
    their tables: ``acc`` ``(local_rows, D)`` or ``(local_rows,)``,
    ``acc_h`` the host stack's in host memory, ``acc_cs`` per column
    shard ``(R_t, D/N)`` (Adagrad is elementwise, so lane slices
    accumulate on their own) or the full table's ``(R_t,)``, the same on
    every rank (row-wise: the row mean needs every lane).

    ``block_leading``: ids and ``d_pooled`` are (K, b, ...).  The K
    micro-steps and (2-D mesh) the DCN replicas are folded into the batch
    first, so a key's every contribution is summed before the
    accumulator's update.  ``d_pooled_scaled``: each micro-step's gradient
    times its own lr (a scheduled block); it rides beside ``d_pooled`` as
    the twin payload, and the step applies it with lr 1."""
    _check_trainable(emb)
    _check_served(placement, emb, emb_h)
    group, my_idx = _table_group(mesh, axis, placement)
    twin = d_pooled_scaled is not None
    if twin:
        d_pooled = torch.cat([d_pooled, d_pooled_scaled.to(d_pooled.dtype)],
                             dim=-1)
        lr = 1.0
    ids, d_pooled = _fold_batch(ids, d_pooled, block_leading, mesh, axis,
                                exchange_dtype)
    meta = placement_arrays(placement, my_idx, emb.device)
    with torch.no_grad():
        _update_body_adagrad(emb, acc, emb_h, acc_h, cs, acc_cs, ids,
                             d_pooled, float(np.float32(lr)), meta,
                             group=group, my_idx=my_idx, placement=placement,
                             twin=twin, rowwise=rowwise,
                             exchange_dtype=exchange_dtype)


# -- the DCN replica check -------------------------------------------------------

FOLD_CHUNK = 1 << 26  # elements folded at a time (256 MiB of f32)


def _xor_fold(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """The XOR of every element's f32 bits, as a 0-d int32 tensor on
    ``device``.  A chunk of ``FOLD_CHUNK`` elements at a time (a host
    tensor's chunks are copied to ``device`` in their own dtype first, and
    widened to f32 there: a bf16 chunk widened on the host would cost the
    host CPU a pass over it), each folded by halving: torch has no XOR
    reduction."""
    flat = x.detach().reshape(-1)
    word = torch.zeros((), dtype=torch.int32, device=device)
    for lo in range(0, flat.numel(), FOLD_CHUNK):
        bits = flat[lo:lo + FOLD_CHUNK].to(device).to(torch.float32).view(
            torch.int32)
        while bits.numel() > 1:
            half = bits.numel() // 2
            odd = bits[2 * half:]
            bits = bits[:half] ^ bits[half:2 * half]
            if odd.numel():
                bits[:1] ^= odd
        if bits.numel():
            word ^= bits[0]
    return word


def make_dcn_replica_check(mesh, axis: str = "d"):
    """A check that the DCN replicas of a 2-D mesh hold the same tables,
    bit for bit (every replica applies the same folded update, so they
    must); None on a 1-D mesh.

    ``check(params) -> bool``: each rank XOR-folds the f32 bits of its
    ``emb``, every ``emb_cs`` and its ``emb_h`` (host rows pass through
    the card a chunk at a time) into one word, the words are all-gathered
    over the DCN group and compared, and the verdicts of the table group
    combined: every rank returns True only if every replica agrees.  The
    fold is one pass over the rank's tables."""
    dcn = dcn_axis_of(mesh, axis)
    if dcn is None:
        return None
    dcn_group, table_group = mesh.get_group(dcn), mesh.get_group(axis)

    def check(params) -> bool:
        emb = params["emb"]
        with torch.no_grad(), phase_scope("dcn_replica_check"):
            word = _xor_fold(emb, emb.device)
            for t in params.get("emb_cs", ()):
                word ^= _xor_fold(t, emb.device)
            if params.get("emb_h") is not None:
                word ^= _xor_fold(params["emb_h"], emb.device)
            words = _gather_rows_of(word.view(1), dcn_group)
            agree = (words == words[0]).all().to(torch.int32).view(1)
            dist.all_reduce(agree, op=dist.ReduceOp.MIN, group=table_group)
        return bool(agree.item())

    return check
