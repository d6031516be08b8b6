"""Embedding-table placement across the ranks of a table group: the
counterpart of ``dlrm_tpu/parallel/placement.py``.

Each rank owns a subset of whole tables, chosen by greedy balanced
bin-packing on row counts; tables above ``max_rows_per_shard`` are split
into contiguous row blocks over every rank; column-sharded tables keep
every row and ``D / N`` of the features on each rank.  This module
computes the static plan (numpy only); the exchange lives in
``parallel/embedding.py``.

Every rank gets exactly ``slots_per_shard`` table slots (unused slots point
at a reserved trash row) and every local stack is padded to the same
``local_rows``, so every rank's exchange moves tensors of one shape.

The plan is field for field the JAX package's at ``pack=1``: lane packing
is TPU storage layout, and the port stores one logical row per row.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np

# what the port says of the JAX package's TPU storage knobs (run.py refuses
# --chunk-budget-mb with it too)
_TPU_LAYOUT = ("is TPU storage layout, which the port does not carry over "
               "(ROADMAP.md, north star)")


@dataclasses.dataclass(frozen=True)
class TablePlacement:
    """Static plan mapping tables -> (shard, slot) plus local row layout.

    Attributes:
      table_sizes: rows per table (global order).
      num_shards: number of ranks in the table group.
      slots_per_shard: K = max tables owned by any shard; all shards are
        padded to K slots.
      slot_tables: (N, K) global table index per slot (0 for padding
        slots, never dereferenced thanks to ``slot_valid``).
      slot_valid: (N, K) 1 for real slots, 0 for padding.
      slot_local_offsets: (N, K) row offset of each slot's table inside the
        shard's local stack; padding slots point at the trash row.
      local_rows: rows per local stack (max over shards, + 1 trash row).
      table_shard: (T,) owning shard per table (-1: row- or column-sharded).
      table_slot: (T,) slot index within the owning shard.
      table_local_offsets: (T,) local row offset of each table in its
        owner's stack.
      pack: always 1 (the JAX package's lane packing is not carried over).
      row_sharded: tables split into contiguous blocks of
        ``rs_rows_per_shard`` rows, block r on shard r, each at offset
        ``rs_local_offsets`` of its stack (at the top of the device stack,
        before the slot tables).
      rs_host: which row-sharded tables live in a second, host-resident
        stack of ``host_local_rows`` rows (its own trash row included).
      col_sharded: tables stored whole on every shard, ``D / N`` features
        each, as separate ``(R, D / N)`` tensors.
    """

    table_sizes: Tuple[int, ...]
    num_shards: int
    slots_per_shard: int
    slot_tables: np.ndarray
    slot_valid: np.ndarray
    slot_local_offsets: np.ndarray
    local_rows: int
    table_shard: np.ndarray
    table_slot: np.ndarray
    table_local_offsets: np.ndarray
    pack: int = 1
    row_sharded: Tuple[int, ...] = ()
    rs_rows_per_shard: Tuple[int, ...] = ()
    rs_local_offsets: Tuple[int, ...] = ()
    rs_host: Tuple[bool, ...] = ()
    host_local_rows: int = 0
    col_sharded: Tuple[int, ...] = ()

    @property
    def num_tables(self) -> int:
        return len(self.table_sizes)

    @property
    def trash_row(self) -> int:
        return self.local_rows - 1

    @property
    def host_row_sharded(self) -> Tuple[int, ...]:
        """Row-sharded tables whose blocks live in the host stack."""
        return tuple(t for t, host in zip(self.row_sharded, self.rs_host)
                     if host)

    @property
    def slot_table_list(self) -> Tuple[int, ...]:
        """Slot-placed (whole-table) tables, ascending global order."""
        return tuple(t for t in range(self.num_tables)
                     if t not in self.row_sharded
                     and t not in self.col_sharded)

    def out_column(self) -> np.ndarray:
        """(T_slot,) column of each slot table (in slot_table_list order)
        inside the (N*K)-wide exchanged layout (shard-major, slot-minor)."""
        return np.asarray(
            [self.table_shard[t] * self.slots_per_shard + self.table_slot[t]
             for t in self.slot_table_list], dtype=np.int32)

    def output_order(self) -> np.ndarray:
        """(T,) permutation restoring global table order from the
        [slot_table_list..., row_sharded..., col_sharded...] assembly
        order."""
        order = (list(self.slot_table_list) + list(self.row_sharded)
                 + list(self.col_sharded))
        inv = np.zeros(self.num_tables, dtype=np.int32)
        for pos, t in enumerate(order):
            inv[t] = pos
        return inv


def plan_placement(table_sizes: Sequence[int], num_shards: int,
                   pack: int = 1,
                   max_rows_per_shard: int = None,
                   col_sharded_tables: Sequence[int] = (),
                   host_tables: Sequence[int] = ()) -> TablePlacement:
    """Greedy balanced assignment: biggest table to the lightest shard.

    ``max_rows_per_shard``: tables with more rows are row-sharded (their
    rows split contiguously across all shards) instead of placed whole.
    Default: no row sharding.  ``col_sharded_tables``: tables split by
    features.  ``host_tables``: tables kept row-sharded in host memory
    (always row-sharded, whatever ``max_rows_per_shard``).  ``pack`` must
    be 1.
    """
    if pack != 1:
        raise ValueError(f"pack={pack} {_TPU_LAYOUT}")
    table_sizes = tuple(int(s) for s in table_sizes)
    t = len(table_sizes)

    # the index lists come from the command line: an out-of-range index
    # must not pass silently, nor a duplicate build two replicas
    col_sharded = tuple(sorted(set(int(x) for x in col_sharded_tables)))
    host_set = set(int(x) for x in host_tables)
    for name, idxs in (("col_sharded_tables", col_sharded),
                       ("host_tables", host_set)):
        bad = [x for x in idxs if not 0 <= x < t]
        if bad:
            raise ValueError(f"{name} indices {sorted(bad)} out of range "
                             f"for {t} tables")
    if host_set & set(col_sharded):
        raise ValueError("a table cannot be both host-resident and "
                         "column-sharded")
    row_sharded = tuple(
        ti for ti in range(t)
        if ti in host_set
        or (max_rows_per_shard is not None
            and table_sizes[ti] > max_rows_per_shard
            and ti not in col_sharded))
    slot_set = [ti for ti in range(t)
                if ti not in row_sharded and ti not in col_sharded]
    rs_rows_per_shard = tuple(-(-table_sizes[ti] // num_shards)
                              for ti in row_sharded)
    rs_host = tuple(ti in host_set for ti in row_sharded)
    rs_local_offsets = []
    off = 0        # device-stack rs region
    host_off = 0   # host-stack rs region
    for rows, is_host in zip(rs_rows_per_shard, rs_host):
        if is_host:
            rs_local_offsets.append(host_off)
            host_off += rows
        else:
            rs_local_offsets.append(off)
            off += rows
    rs_total = off
    host_local_rows = host_off + 1 if host_off else 0  # + trash row

    order = [ti for ti in np.argsort(-np.asarray(table_sizes),
                                     kind="stable") if ti in slot_set]
    loads = np.zeros(num_shards, dtype=np.int64)
    counts = np.zeros(num_shards, dtype=np.int64)
    table_shard = np.zeros(t, dtype=np.int32)
    n_slot = len(slot_set)
    k = -(-n_slot // num_shards) if n_slot else 1  # ceil; >=1 non-empty
    for ti in order:
        # lightest shard with a free slot
        candidates = np.flatnonzero(counts < k)
        d = candidates[np.argmin(loads[candidates])]
        table_shard[ti] = d
        loads[d] += table_sizes[ti]
        counts[d] += 1

    slot_tables = np.zeros((num_shards, k), dtype=np.int32)
    slot_valid = np.zeros((num_shards, k), dtype=np.int32)
    slot_local_offsets = np.zeros((num_shards, k), dtype=np.int32)
    table_slot = np.zeros(t, dtype=np.int32)
    table_local_offsets = np.zeros(t, dtype=np.int32)
    max_rows = 0
    for d in range(num_shards):
        tables = [ti for ti in slot_set if table_shard[ti] == d]
        # slot tables live above the row-sharded blocks (fixed offsets)
        off = rs_total
        for s, ti in enumerate(tables):
            slot_tables[d, s] = ti
            slot_valid[d, s] = 1
            slot_local_offsets[d, s] = off
            table_slot[ti] = s
            table_local_offsets[ti] = off
            off += table_sizes[ti]
        max_rows = max(max_rows, off)
    for ti in (*row_sharded, *col_sharded):  # sentinels; resolved elsewhere
        table_shard[ti] = -1
        table_slot[ti] = -1
        table_local_offsets[ti] = -1
    local_rows = max_rows + 1  # + trash row for padding slots
    slot_local_offsets[slot_valid == 0] = local_rows - 1

    return TablePlacement(
        table_sizes=table_sizes,
        num_shards=num_shards,
        slots_per_shard=k,
        slot_tables=slot_tables,
        slot_valid=slot_valid,
        slot_local_offsets=slot_local_offsets,
        local_rows=local_rows,
        table_shard=table_shard,
        table_slot=table_slot,
        table_local_offsets=table_local_offsets,
        row_sharded=row_sharded,
        rs_rows_per_shard=rs_rows_per_shard,
        rs_local_offsets=tuple(rs_local_offsets),
        col_sharded=col_sharded,
        rs_host=rs_host,
        host_local_rows=host_local_rows,
    )
