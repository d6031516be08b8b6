"""Two-tier embedding tables: a device tier on the card and a host tier in
pinned host memory -- the counterpart of ``dlrm_tpu/parallel/host_tier.py``.

The reference trains with tables larger than fast memory by keeping its big
tables in a slow tier (SURVEY.md §2.2).  Here ``plan_tiers`` keeps the
smallest tables on the device under a byte budget and spills the rest:

* **Device tier**: the device tables as one plain ``(R_dev, D)`` stack, the
  port's own storage under the device sub-config (``device_subconfig``).
* **Host tier**: the spilled tables as one ``(R_host, D)`` tensor in pinned
  host memory (plain host memory when the tiers serve the CPU).  The JAX
  package carries it flat (1-D) only to dodge a TPU layout conversion at
  its jit boundary; that is not carried over.

Only the rows a batch touches cross PCIe, through two hand-written CUDA
kernels (``csrc/host_tier.cu``) that the card runs on the pinned stack in
place: ``host_gather`` writes the rows straight into their table columns of
the pooled rows on the card, ``host_update_rows`` adds updates into
distinct rows (duplicates are summed on the card first, in f32).  Both
visit their host rows in ascending order, a narrow window of rows in flight
at a time, so that neighbouring rows share the card's translations of the
mapped tier: the gather sorts its ids on the card with their positions
(``gather_plan``), the update takes the sorted ids that ``sum_duplicates``
gives (``update_plan``).  Each wrapper takes its plain torch version for
CPU tensors (``index_select`` / ``index_add_`` on the host) and launches its
kernel, or raises, for CUDA ones.

Tiered parameters are ``{"bottom", "top", "emb": TieredEmb}``: the model's
forward, ``train.metrics.evaluate`` and ``run.score_batch`` take them as
they take plain ones (``ops.embedding.mixed_lookup`` dispatches on the
storage).  A batch's lookup writes every table's rows into one ``(B, T[,
H], D)`` buffer in global table order -- the device tier by one gather, the
host tier into its columns -- so no concatenation or permutation of the
tiers is ever made.

The steps update in place: SGD (``tiered_train_step``), coalesced K-step
blocks with one host gather at block entry and one host update at block end
(``tiered_train_block``, ``tiered_train_block_opt``), the pipelined step
that gathers batch N+1's rows right after step N's updates, into the buffer
that step N+1's lookup would fill (``tiered_train_step_pipelined``), and Adagrad / row-wise Adagrad with
tier-matched accumulators (``tiered_train_step_opt``).  The device tier
goes through ``train.train._micro_step`` on the device sub-config; the host
tier takes the same rules (``ops.embedding.adagrad_rows``, and SGD's sum of
``-lr * g``) through its own gather and update kernels.  Host-tier
work runs under the phase scopes ``lookup_host_tier``, ``host_tier_update``
and ``host_tier_prefetch_next``.  Every kernel runs on the current stream,
so a step's host update is ordered before the next gather; whoever reads the
pinned stack on the host (``merge_tiers``, a checkpoint) synchronizes
first.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import mmap
from typing import List, NamedTuple, Optional, Tuple

import torch

from dlrm_tpu_torch.config import DLRMConfig
from dlrm_tpu_torch.ops import embedding as emb_ops
from dlrm_tpu_torch.train import optim
from dlrm_tpu_torch.train import train as train_lib
from dlrm_tpu_torch.utils.telemetry import count, phase_scope

GIB = 1 << 30


# -- tier planning ------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TierPlan:
    """Which tables live in which tier.  ``device_tables`` / ``host_tables``
    are global table indices in ascending order; each tier stacks its tables
    row-wise, and ``*_offsets`` are the tables' first rows in their tier's
    stack."""

    table_sizes: Tuple[int, ...]
    feature_size: int
    device_tables: Tuple[int, ...]
    host_tables: Tuple[int, ...]

    @property
    def device_offsets(self) -> Tuple[int, ...]:
        return self._offsets(self.device_tables)

    @property
    def host_offsets(self) -> Tuple[int, ...]:
        return self._offsets(self.host_tables)

    def _offsets(self, tables) -> Tuple[int, ...]:
        off, out = 0, []
        for t in tables:
            out.append(off)
            off += self.table_sizes[t]
        return tuple(out)

    @property
    def device_rows(self) -> int:
        return sum(self.table_sizes[t] for t in self.device_tables)

    @property
    def host_rows(self) -> int:
        return sum(self.table_sizes[t] for t in self.host_tables)


def plan_tiers(config: DLRMConfig, hbm_budget_bytes: Optional[int],
               bytes_per_elem: Optional[int] = None) -> TierPlan:
    """Tables to tiers under a device byte budget: the smallest tables stay
    on the device while they fit, the rest spill to the host (the reference
    evicts its big tables).  ``None``: everything on the device.  The CLI's
    ``--hbm-budget-gb G`` is ``int(G * GIB)`` bytes."""
    if bytes_per_elem is None:
        bytes_per_elem = config.embedding_dtype.itemsize
    row_bytes = config.feature_size * bytes_per_elem
    sizes = config.table_sizes
    if hbm_budget_bytes is None:
        return TierPlan(sizes, config.feature_size, tuple(range(len(sizes))),
                        ())
    used, device, host = 0, [], []
    for t in sorted(range(len(sizes)), key=lambda t: sizes[t]):
        b = sizes[t] * row_bytes
        if used + b <= hbm_budget_bytes:
            device.append(t)
            used += b
        else:
            host.append(t)
    return TierPlan(sizes, config.feature_size, tuple(sorted(device)),
                    tuple(sorted(host)))


def device_subconfig(plan: TierPlan, config: DLRMConfig
                     ) -> Optional[DLRMConfig]:
    """The config of the device tier's tables alone (in global order), or
    None when no table lives on the device."""
    if not plan.device_tables:
        return None
    return _tier_config(plan, config)


def _tier_config(plan: TierPlan, config: DLRMConfig) -> DLRMConfig:
    """:func:`device_subconfig`, with no tables for an all-host plan (the
    device-tier steps then update the dense parameters only)."""
    return dataclasses.replace(config, table_sizes=tuple(
        config.table_sizes[t] for t in plan.device_tables))


def _host_empty(shape, dtype: torch.dtype, device) -> torch.Tensor:
    """A host-tier tensor: for a CUDA device, exactly ``prod(shape) *
    itemsize`` bytes of page-aligned host memory registered with the card
    (the kernels read and write it in place); plain host memory for the
    CPU.  PyTorch's pinned allocator would round the tier up to a power of
    two (13.07 GB into a 16 GiB block), so the tier is mapped and
    registered here instead."""
    if torch.device(device).type != "cuda":
        return torch.empty(shape, dtype=dtype)
    out, mapping = _page_aligned_empty(shape, dtype)
    if mapping is not None:
        ptr = out.untyped_storage().data_ptr()
        _cuda_host_register(ptr, out.untyped_storage().nbytes())
        mapping.registered = ptr
    return out


class _HostMap(mmap.mmap):
    """An anonymous mapping that unregisters itself from CUDA before it is
    unmapped.  The tensors viewing it keep it alive (``torch.frombuffer``
    holds its buffer), so that runs when the last of them dies."""

    registered = 0  # the address given to cudaHostRegister, or 0

    def __del__(self):
        if self.registered:
            _cuda_host_unregister(self.registered)
            self.registered = 0


def _page_aligned_empty(shape, dtype: torch.dtype):
    """(an uninitialised host tensor of exactly ``prod(shape) * itemsize``
    bytes at the start of an anonymous mapping, which is page-aligned and
    that size rounded up to a page; the mapping, None for 0 bytes)."""
    numel = 1
    for s in shape:
        numel *= int(s)
    if numel == 0:
        return torch.empty(shape, dtype=dtype), None
    itemsize = torch.empty((), dtype=dtype).element_size()
    mapping = _HostMap(-1, numel * itemsize)
    out = torch.frombuffer(mapping, dtype=dtype, count=numel)
    return out.view(tuple(shape)), mapping


_CUDA_HOST_REGISTER_PORTABLE = 1
_CUDA_HOST_REGISTER_MAPPED = 2


def _cuda_host_register(ptr: int, nbytes: int) -> None:
    """``cudaHostRegister`` with the portable and mapped flags: every
    context may use the range, at its host address under unified
    addressing."""
    rc = torch.cuda.cudart().cudaHostRegister(
        ptr, nbytes,
        _CUDA_HOST_REGISTER_PORTABLE | _CUDA_HOST_REGISTER_MAPPED)
    if int(rc) != 0:
        raise RuntimeError(f"cudaHostRegister of {nbytes} B at {ptr:#x}: "
                           f"CUDA error {int(rc)}")


def _cuda_host_unregister(ptr: int) -> None:
    """``cudaHostUnregister``, after the card has finished every kernel
    that may still read or write the range."""
    torch.cuda.synchronize()
    rc = torch.cuda.cudart().cudaHostUnregister(ptr)
    if int(rc) != 0:
        raise RuntimeError(f"cudaHostUnregister at {ptr:#x}: CUDA error "
                           f"{int(rc)}")


def split_tiers(emb: torch.Tensor, plan: TierPlan, config: DLRMConfig,
                device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The logical ``(R, D)`` stack -> (device tier ``(R_dev, D)`` on
    ``device`` (default: the stack's), host tier ``(R_host, D)`` in pinned
    host memory).  Each table is copied straight into its tier, so a stack
    on the card reaches the host with no other host copy."""
    device = emb.device if device is None else torch.device(device)
    d = emb.shape[1]
    dev = torch.empty((plan.device_rows, d), dtype=emb.dtype, device=device)
    host = _host_empty((plan.host_rows, d), emb.dtype, device)
    for tables, offsets, out in ((plan.device_tables, plan.device_offsets,
                                  dev),
                                 (plan.host_tables, plan.host_offsets, host)):
        for t, lo in zip(tables, offsets):
            n, go = config.table_sizes[t], config.table_offsets[t]
            out[lo:lo + n].copy_(emb[go:go + n])
    return dev, host


def merge_tiers(emb_dev, emb_host, plan: TierPlan, config: DLRMConfig
                ) -> torch.Tensor:
    """The inverse of :func:`split_tiers`: the logical ``(R, D)`` stack as
    a new host tensor, built a table at a time.  The tiers may be tensors
    or anything that gives rows by slicing (a checkpoint ``Leaf.array()``).
    Synchronizes with the card first: its kernels write the pinned stack
    asynchronously."""
    if isinstance(emb_dev, torch.Tensor) and emb_dev.is_cuda:
        torch.cuda.synchronize(emb_dev.device)
    out = None
    for tables, offsets, stack in ((plan.device_tables, plan.device_offsets,
                                    emb_dev),
                                   (plan.host_tables, plan.host_offsets,
                                    emb_host)):
        for t, lo in zip(tables, offsets):
            n, go = config.table_sizes[t], config.table_offsets[t]
            part = torch.as_tensor(stack[lo:lo + n])
            if out is None:
                out = torch.empty((config.total_rows, part.shape[1]),
                                  dtype=part.dtype)
            out[go:go + n].copy_(part)
    return out


# -- the two host-tier kernels and their plain versions -----------------------

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_GATHER_ARGS = (_P, _L, _L, _L, _P, _I, _P, _L, _P, _I, _I, _P)
_UPDATE_ARGS = (_P, _L, _I, _L, _I, _P, _I, _L, _P, _I, _I, _P)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# Mirrors of csrc/host_tier.cu's kThreads and kInFlight: threads a block,
# units a thread moves a round.
_THREADS = 256
_IN_FLIGHT = 2
# Bytes of host rows the grid moves a round: a narrow window of the
# visiting order, which keeps the rows in flight within the card's cached
# translations of the mapped host tier while covering the link's latency.
# On an H100, of 64 KiB to 1 MiB, 256 KiB gave the fastest update and a
# gather within 2% of the fastest; 64 KiB is 65-95% slower
# (probes/host_tier_probe.py, PERF.md §6).
WINDOW = 256 << 10


class GatherPlan(NamedTuple):
    """What ``host_gather``'s kernel is handed: the ids in the order it
    visits them (ascending, so that neighbouring host rows share their
    address translations), each visited row's byte offset in the output,
    the bytes a thread copies at once, and the grid."""

    ids: torch.Tensor    # (n,) int32 or int64, ascending
    dst: torch.Tensor    # (n,) int64 byte offsets into the output
    unit: int            # 16, 8, 4, 2 or 1
    blocks: int


class UpdatePlan(NamedTuple):
    """What ``host_update_rows``'s kernel is handed besides the tensors:
    16-byte units (else the element-wise branch) and the grid."""

    vec: bool
    blocks: int


def _grid(n_units: int, unit: int) -> int:
    """Blocks whose round moves :data:`WINDOW` bytes of ``unit``-byte
    units, at least 1 and no more than ``n_units`` take."""
    per_block = _THREADS * _IN_FLIGHT
    want = max(1, WINDOW // (per_block * unit))
    return max(1, min(want, -(-n_units // per_block)))


@functools.lru_cache(maxsize=32)
def _column_offsets(batch: int, cols: Tuple[int, ...], n_hot: int,
                    strides: Tuple[int, int, int], device: torch.device
                    ) -> torch.Tensor:
    """Byte offsets in a pooled (B, T[, H], W) output of the rows of ids
    (B, len(cols)[, H]) in their natural order (made once a shape)."""
    s_row, s_col, s_hot = strides
    r = torch.arange(batch, dtype=torch.int64, device=device) * s_row
    c = torch.tensor(cols, dtype=torch.int64, device=device) * s_col
    h = torch.arange(n_hot, dtype=torch.int64, device=device) * s_hot
    return (r[:, None, None] + c[None, :, None] + h[None, None, :]).reshape(-1)


def gather_plan(table: torch.Tensor, ids: torch.Tensor, out: torch.Tensor,
                cols: Optional[Tuple[int, ...]] = None) -> GatherPlan:
    """The plan of ``host_gather(table, ids, out, cols)`` (``cols`` None: a
    contiguous ``ids.shape + (W,)`` output): the ids sorted on their
    device together with their positions (no host sync), the positions
    turned into byte offsets in ``out``, the widest copy unit that the row
    bytes, both tensors' addresses and the output's strides allow, and the
    grid for :data:`WINDOW`."""
    row_bytes = table.shape[1] * table.element_size()
    esize = out.element_size()
    flat = ids.reshape(-1)
    order, perm = torch.sort(flat)
    if cols is None:
        strides = (row_bytes,)
        dst = perm * row_bytes
    else:
        strides = (out.stride(0) * esize, out.stride(1) * esize,
                   out.stride(2) * esize if ids.dim() == 3 else 0)
        n_hot = ids.shape[2] if ids.dim() == 3 else 1
        dst = _column_offsets(ids.shape[0], tuple(cols), n_hot, strides,
                              ids.device).index_select(0, perm)
    unit = next(v for v in (16, 8, 4, 2, 1)
                if all(x % v == 0 for x in (row_bytes, table.data_ptr(),
                                            out.data_ptr(), *strides)))
    return GatherPlan(order, dst, unit,
                      _grid(flat.numel() * row_bytes // unit, unit))


def update_plan(table: torch.Tensor, ids: torch.Tensor, upd: torch.Tensor
                ) -> UpdatePlan:
    """The plan of ``host_update_rows(table, ids, upd)``: 16-byte units
    where the row's bytes and both tensors' addresses allow it, else the
    element-wise branch (the row-wise accumulator, 4 bytes a row); the grid
    for :data:`WINDOW`.  The ids keep their order: they come sorted
    from ``sum_duplicates``."""
    row_bytes = table.shape[1] * table.element_size()
    vec = (row_bytes % 16 == 0 and table.data_ptr() % 16 == 0
           and upd.data_ptr() % 16 == 0)
    unit = 16 if vec else table.element_size()
    return UpdatePlan(vec, _grid(ids.numel() * row_bytes // unit, unit))


def _base(t: torch.Tensor) -> Tuple[int, int]:
    """(the pinned allocation's address, the tensor's byte offset in it)."""
    base = t.untyped_storage().data_ptr()
    return base, t.data_ptr() - base


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


@functools.lru_cache(maxsize=None)
def _index(tables: Tuple[int, ...], device: torch.device,
           dtype: torch.dtype = torch.int64) -> torch.Tensor:
    """Table indices as a tensor on ``device`` (made once)."""
    return torch.tensor(tables, dtype=dtype, device=device)


def _check_table(table: torch.Tensor, name: str) -> None:
    if table.dim() != 2 or not table.is_contiguous():
        raise ValueError(f"{name}: the host stack must be a contiguous (R, W) "
                         f"tensor, got {tuple(table.shape)}")
    if table.device.type != "cpu" or not table.is_pinned():
        pinned = table.device.type == "cpu" and table.is_pinned()
        raise ValueError(f"{name}: the host stack must lie in pinned host "
                         f"memory for the card to map it (device "
                         f"{table.device}, pinned {pinned})")


def _check_ids(ids: torch.Tensor, name: str) -> None:
    if ids.dtype not in (torch.int32, torch.int64) or not ids.is_contiguous():
        raise TypeError(f"{name}: ids must be a contiguous int32 or int64 "
                        f"tensor, got {ids.dtype}")


def host_gather_reference(table: torch.Tensor, ids: torch.Tensor,
                          out: Optional[torch.Tensor] = None,
                          cols: Optional[Tuple[int, ...]] = None
                          ) -> torch.Tensor:
    """Plain version of ``host_gather``: ``index_select`` on the host
    stack, then a copy to the output's device (into the columns ``cols``
    of ``out`` when given)."""
    rows = table.index_select(0, ids.reshape(-1).cpu())
    if out is None:
        return rows.reshape(*ids.shape, table.shape[1]).to(ids.device)
    out.index_copy_(1, _index(tuple(cols), out.device),
                    rows.reshape(*ids.shape, table.shape[1]).to(out.device))
    return out


def host_gather(table: torch.Tensor, ids: torch.Tensor,
                out: Optional[torch.Tensor] = None,
                cols: Optional[Tuple[int, ...]] = None) -> torch.Tensor:
    """Rows of the host stack ``table`` (R, W) at ``ids``.

    Without ``out``: a new tensor ``ids.shape + (W,)`` on the ids' device.
    With ``out`` (B, T, W) or (B, T, H, W) and ``cols`` (the table columns
    of ids' axis 1): ``out[:, cols[j]] = table[ids[:, j]]`` for ids (B,
    len(cols)[, H]), written in place; returns ``out``.

    CPU ids: the plain version.  CUDA ids: the kernel on the pinned stack
    (visiting the ids in the order of :func:`gather_plan`), or an error;
    ``host_gather.launches`` counts launches.  The counter
    ``host_tier.gather_bytes`` adds the bytes moved: a row a hit."""
    count("host_tier.gather_bytes",
          ids.numel() * table.shape[1] * table.element_size())
    if ids.device.type == "cpu":
        return host_gather_reference(table, ids, out, cols)
    _check_table(table, "host_gather")
    _check_ids(ids, "host_gather")
    w = table.shape[1]
    if out is None:
        out = torch.empty((*ids.shape, w), dtype=table.dtype,
                          device=ids.device)
        cols = None
    elif out.dtype != table.dtype or out.device != ids.device \
            or out.dim() != ids.dim() + 1 or out.shape[-1] != w \
            or out.stride(-1) != 1 or cols is None \
            or ids.shape[1] != len(cols) or ids.shape[0] != out.shape[0] \
            or tuple(ids.shape[2:]) != tuple(out.shape[2:-1]):
        raise ValueError(f"host_gather: out {tuple(out.shape)} {out.dtype} "
                         f"on {out.device} does not take ids "
                         f"{tuple(ids.shape)} into columns {cols}")
    n = ids.numel()
    if n == 0:
        return out
    plan = gather_plan(table, ids, out, cols)
    row_bytes = w * table.element_size()
    base, offset = _base(table)
    with torch.cuda.device(ids.device):
        rc = _kernel("host_gather", _GATHER_ARGS)(
            base, offset, table.shape[0], row_bytes, plan.ids.data_ptr(),
            int(ids.dtype == torch.int64), plan.dst.data_ptr(), n,
            out.data_ptr(), plan.unit, plan.blocks, _stream(ids))
    if rc != 0:
        raise RuntimeError(f"host_gather kernel launch failed: CUDA error "
                           f"{rc} for {n} rows of {row_bytes} B")
    host_gather.launches += 1
    return out


host_gather.launches = 0


def host_update_rows_reference(table: torch.Tensor, ids: torch.Tensor,
                               upd: torch.Tensor) -> None:
    """Plain version of ``host_update_rows``: the update copied to the host,
    then ``index_add_`` on the stack (f32); for bf16 the same f32 sum,
    rounded once (``index_add_`` in bf16 would round the update first)."""
    ids, upd = ids.cpu().long(), upd.cpu().float()
    if table.dtype == torch.float32:
        table.index_add_(0, ids, upd)
    else:
        table.index_copy_(0, ids, (table.index_select(0, ids).float()
                                   + upd).to(table.dtype))


def host_update_rows(table: torch.Tensor, ids: torch.Tensor,
                     upd: torch.Tensor) -> None:
    """``table[ids[i]] += upd[i]`` in place, for DISTINCT ids: f32
    arithmetic on the f32 update (n, W), one rounding to the stack's dtype
    (f32 or bf16).

    CPU ids: the plain version.  CUDA ids: the kernel on the pinned stack,
    or an error; ``host_update_rows.launches`` counts launches.  The
    counter ``host_tier.update_bytes`` adds the bytes moved: each row read
    and written back."""
    count("host_tier.update_bytes",
          2 * ids.numel() * table.shape[1] * table.element_size())
    if ids.device.type == "cpu":
        return host_update_rows_reference(table, ids, upd)
    _check_table(table, "host_update_rows")
    _check_ids(ids, "host_update_rows")
    if table.dtype not in _DTYPE_CODES:
        raise TypeError(f"host_update_rows: the stack must be float32 or "
                        f"bfloat16, not {table.dtype}")
    n, w = ids.numel(), table.shape[1]
    if upd.dtype != torch.float32 or upd.device != ids.device \
            or tuple(upd.shape) != (n, w) or not upd.is_contiguous():
        raise ValueError(f"host_update_rows: upd must be a contiguous f32 "
                         f"({n}, {w}) tensor on {ids.device}, got "
                         f"{tuple(upd.shape)} {upd.dtype} on {upd.device}")
    if n == 0:
        return
    plan = update_plan(table, ids, upd)
    base, offset = _base(table)
    with torch.cuda.device(ids.device):
        rc = _kernel("host_update_rows", _UPDATE_ARGS)(
            base, offset, _DTYPE_CODES[table.dtype], table.shape[0], w,
            ids.data_ptr(), int(ids.dtype == torch.int64), n, upd.data_ptr(),
            int(plan.vec), plan.blocks, _stream(ids))
    if rc != 0:
        raise RuntimeError(f"host_update_rows kernel launch failed: CUDA "
                           f"error {rc} for {n} rows of {w} {table.dtype}")
    host_update_rows.launches += 1


host_update_rows.launches = 0


def _kernel(entry: str, argtypes: tuple):
    """The C entry point ``entry`` of ``csrc/host_tier.cu``."""
    from dlrm_tpu_torch.ops.cuda_build import kernel
    return kernel("host_tier", argtypes, entry)


def device_attrs(device=None) -> dict:
    """What the card offers host memory (CUDA device attributes):
    unified addressing, mapping host memory, native atomics to host memory,
    pageable memory access."""
    device = torch.device("cuda" if device is None else device)
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    out = (ctypes.c_int * 4)()
    rc = _kernel("host_tier_device_attrs", (_I, ctypes.POINTER(ctypes.c_int)))(
        idx, out)
    if rc != 0:
        raise RuntimeError(f"host_tier_device_attrs: CUDA error {rc}")
    return dict(zip(("unified_addressing", "can_map_host_memory",
                     "host_native_atomics", "pageable_memory_access"),
                    (int(x) for x in out)))


def _as_rows(stack: torch.Tensor) -> torch.Tensor:
    """A tier stack as (R, W): a 1-D one (the row-wise accumulator) is
    (R, 1)."""
    return stack.view(-1, 1) if stack.dim() == 1 else stack


def host_tier_gather(emb_host: torch.Tensor, flat_ids: torch.Tensor,
                     out: Optional[torch.Tensor] = None,
                     cols: Optional[Tuple[int, ...]] = None) -> torch.Tensor:
    """Rows of a host-tier stack (tables, or an accumulator; 1-D gives
    scalars) at ``flat_ids``, on the ids' device: :func:`host_gather`."""
    rows = host_gather(_as_rows(emb_host), flat_ids, out, cols)
    return rows.squeeze(-1) if emb_host.dim() == 1 and out is None else rows


def _host_update(stack: torch.Tensor, ids: torch.Tensor,
                 upd: torch.Tensor) -> None:
    """:func:`host_update_rows` on a tier stack (1-D: scalars), distinct
    ids."""
    host_update_rows(_as_rows(stack), ids, upd.reshape(ids.shape[0], -1))


def host_tier_scatter_add(emb_host: torch.Tensor, flat_ids: torch.Tensor,
                          updates: torch.Tensor) -> None:
    """``emb_host[ids] += updates`` in place, duplicate ids summed in f32 on
    the ids' device first (``ops.embedding.sum_duplicates``: on CUDA one
    host sync), then one add a distinct row: :func:`host_update_rows`."""
    width = 1 if emb_host.dim() == 1 else emb_host.shape[1]
    u = emb_ops.sum_duplicates(emb_ops.SparseGrad(
        flat_ids.reshape(-1), updates.reshape(-1, width)))
    _host_update(emb_host, u.ids, u.rows)


# -- two-tier storage and lookup ----------------------------------------------

class TieredEmb(NamedTuple):
    """Two-tier table storage: ``params["emb"]`` of tiered parameters."""

    dev: torch.Tensor    # (R_dev, D) on the device
    host: torch.Tensor   # (R_host, D) in pinned host memory
    plan: TierPlan

    @property
    def device(self) -> torch.device:
        return self.dev.device


def check_tiered_storage(emb: TieredEmb, config: DLRMConfig) -> None:
    """The tiers' shapes and dtype against the plan and the config."""
    plan, d = emb.plan, config.feature_size
    if plan.table_sizes != config.table_sizes or plan.feature_size != d:
        raise ValueError(f"tier plan of tables {plan.table_sizes} x "
                         f"{plan.feature_size}; the config has "
                         f"{config.table_sizes} x {d}")
    if tuple(emb.dev.shape) != (plan.device_rows, d) \
            or tuple(emb.host.shape) != (plan.host_rows, d) \
            or emb.dev.dtype != emb.host.dtype \
            or emb.host.device.type != "cpu":
        raise ValueError(f"tiers {tuple(emb.dev.shape)} {emb.dev.dtype} on "
                         f"{emb.dev.device} and {tuple(emb.host.shape)} "
                         f"{emb.host.dtype} on {emb.host.device}; the plan "
                         f"needs ({plan.device_rows}, {d}) and host "
                         f"({plan.host_rows}, {d})")


def _tier_ids(sparse: torch.Tensor, tables: Tuple[int, ...],
              offsets: Tuple[int, ...], table_axis: int = 1) -> torch.Tensor:
    """Per-table ids (..., T[, H]) of the given tables -> rows of their tier
    stack (..., len(tables)[, H]); ``table_axis`` 2 for (K, B, T[, H])."""
    ids = sparse.index_select(table_axis, _index(tables, sparse.device))
    offs = _index(offsets, sparse.device, ids.dtype)
    return ids + (offs if ids.dim() == table_axis + 1 else offs[:, None])


@functools.lru_cache(maxsize=None)
def _device_columns(plan: TierPlan, device: torch.device, dtype: torch.dtype):
    """(row offset of every table in the device stack, 0 for host tables;
    whether each table is a host table), for a gather of all T columns."""
    offs = [0] * len(plan.table_sizes)
    for t, lo in zip(plan.device_tables, plan.device_offsets):
        offs[t] = lo
    host = [t in plan.host_tables for t in range(len(plan.table_sizes))]
    return (torch.tensor(offs, dtype=dtype, device=device),
            torch.tensor(host, dtype=torch.bool, device=device))


def _gather(emb: TieredEmb, sparse: torch.Tensor,
            host_rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Every table's rows of a batch, (B, T[, H], D) in global table order:
    one gather from the device stack writes all T columns (the host
    columns read device row 0), then the host tier's rows go into their
    columns -- gathered there by the kernel, or copied from ``host_rows``
    (B, T_host[, H], D) gathered at a block's entry."""
    plan = emb.plan
    if plan.device_tables:
        offs, is_host = _device_columns(plan, sparse.device, sparse.dtype)
        if sparse.dim() == 3:
            offs, is_host = offs[:, None], is_host[:, None]
        ids = sparse + offs
        if plan.host_tables:
            ids = ids.masked_fill(is_host, 0)
        rows = emb_ops.gather_rows(emb.dev, ids)
    else:
        rows = torch.empty((*sparse.shape, emb.host.shape[1]),
                           dtype=emb.host.dtype, device=sparse.device)
    if plan.host_tables:
        if host_rows is None:
            with phase_scope("lookup_host_tier"):
                host_gather(emb.host, _tier_ids(sparse, plan.host_tables,
                                                plan.host_offsets),
                            out=rows, cols=plan.host_tables)
        else:
            rows.index_copy_(1, _index(plan.host_tables, rows.device),
                             host_rows)
    return rows


def _pool(rows: torch.Tensor, plan: TierPlan, config: DLRMConfig
          ) -> torch.Tensor:
    """The pooled (B, T, D) with the JAX package's rounding of the device
    tier's small tables (``ops.embedding.mixed_pool``); host tables pool
    plainly, as the JAX package gathers them."""
    small = tuple(t for t in plan.device_tables
                  if config.table_sizes[t] <= config.small_table_threshold)
    return emb_ops.mixed_pool(rows, config, small=small)


def tiered_lookup(emb: TieredEmb, sparse: torch.Tensor, config: DLRMConfig
                  ) -> torch.Tensor:
    """Pooled (B, T, D) lookup across both tiers, in global table order."""
    return _pool(_gather(emb, sparse), emb.plan, config)


# -- gradients ----------------------------------------------------------------

def _tier_forward_backward(dense_params: dict, emb: TieredEmb, dense, sparse,
                           labels, *, config: DLRMConfig, rows=None,
                           host_out=None):
    """The two-tier lookup, loss and backward that every tiered step shares.

    Both tiers' rows are gathered outside autograd into one (B, T[, H], D)
    buffer, which is the leaf: its gradient comes back per hit, and each
    tier takes its columns of it.  ``rows``: that buffer, gathered ahead
    (the pipelined step, a block's micro-step); ``host_out``: a (B *
    T_host[* H], D) tensor to take the host tier's gradient rows into.

    Returns (loss, dense grads, the device tier's per-hit SparseGrad (ids
    of the device stack) or None, the host tier's or None); the tiers'
    split runs under the span ``grad_split``."""
    from dlrm_tpu_torch.models.dlrm import loss_from_pooled

    plan = emb.plan
    with phase_scope("lookup"):
        if rows is None:
            rows = _gather(emb, sparse)
        rows.requires_grad_()
        pooled = _pool(rows, plan, config)
    live = emb_ops.tree_map(lambda p: p.detach().requires_grad_(),
                            dense_params)
    loss = loss_from_pooled(live, pooled, dense, labels, config)
    leaves = emb_ops.tree_leaves(live)
    with phase_scope("autograd.bwd"):
        grads = torch.autograd.grad(loss, leaves + [rows])
    it = iter(grads)
    dgrads = emb_ops.tree_map(lambda _: next(it), live)
    drows = grads[-1]
    d = drows.shape[-1]
    tiers = []
    with phase_scope("grad_split"):
        for tables, offsets, out in (
                (plan.device_tables, plan.device_offsets, None),
                (plan.host_tables, plan.host_offsets, host_out)):
            if not tables:
                tiers.append(None)
                continue
            ids = _tier_ids(sparse, tables, offsets).reshape(-1)
            if len(tables) == len(plan.table_sizes):
                g = drows.reshape(-1, d)
            elif out is not None:
                g = torch.index_select(
                    drows, 1, _index(tables, drows.device),
                    out=out.view(drows.shape[0], len(tables),
                                 *drows.shape[2:]))
                g = out
            else:
                g = drows.index_select(1, _index(tables, drows.device))
            tiers.append(emb_ops.SparseGrad(ids=ids, rows=g.reshape(-1, d)))
    return loss.detach(), dgrads, tiers[0], tiers[1]


class _TierGrads:
    """The ``value_and_grad`` of ``train.train._micro_step`` for the device
    sub-config: each call runs :func:`_tier_forward_backward` on the next
    micro-batch, hands back the device tier's gradient and keeps the host
    tier's (``host``: one SparseGrad a micro-step, rows into
    ``host_out[k]`` when given).  ``rows``: the first call's rows of both
    tiers, gathered ahead (the pipelined step)."""

    def __init__(self, emb: TieredEmb, config: DLRMConfig, host_rows=None,
                 host_out=None, rows=None):
        self.emb, self.config, self.rows = emb, config, rows
        self.host_rows, self.host_out = host_rows, host_out
        self.host: List[Optional[emb_ops.SparseGrad]] = []

    def __call__(self, dense_params, emb_dev, sparse, offsets, dense, labels):
        del emb_dev, offsets  # the device tier is self.emb.dev
        k = len(self.host)
        rows = self.rows  # set for the first call only; dropped after it
        self.rows = None
        if self.host_rows is not None:
            with phase_scope("lookup"):
                rows = _gather(self.emb, sparse, self.host_rows[k])
        loss, dgrads, dev, host = _tier_forward_backward(
            dense_params, self.emb, dense, sparse, labels, config=self.config,
            rows=rows,
            host_out=None if self.host_out is None else self.host_out[k])
        self.host.append(host)
        if dev is None:  # an all-host plan: the device sub-config is empty
            dev = emb_ops.SparseGrad(
                sparse.new_zeros((0,)),
                self.emb.dev.new_zeros((0, self.emb.dev.shape[1])))
        return loss, (dgrads, dev)


# -- the SGD steps ------------------------------------------------------------

def _tiered(params: dict) -> TieredEmb:
    emb = params["emb"]
    if not isinstance(emb, TieredEmb):
        raise TypeError(f"tiered steps take params['emb'] as TieredEmb "
                        f"(init_tiered_params), not {type(emb).__name__}")
    return emb


def _dense(params: dict) -> dict:
    return {"bottom": params["bottom"], "top": params["top"]}


def _device_view(params: dict) -> dict:
    """The parameters as ``train.train`` sees them on the device
    sub-config: the dense towers and the device stack."""
    return {**_dense(params), "emb": params["emb"].dev}


def _host_sgd(stack: torch.Tensor, ids: torch.Tensor, rows: torch.Tensor,
              lr: float) -> None:
    """SGD on a host stack: each distinct row of ``ids`` gets the f32 sum
    of its hits' ``-lr * g`` (``rows`` (..., D), in the ids' layout) in one
    add (:func:`host_tier_scatter_add`).  The caller opens the span."""
    host_tier_scatter_add(stack, ids, rows.float() * -lr)


def _tiered_step(params: dict, opt_state: Optional[dict], dense, sparse,
                 labels, *, config: DLRMConfig, optimizer: str, lr: float,
                 rows=None) -> torch.Tensor:
    """One two-tier step, in place: the dense parameters and the device
    tier through ``train.train._micro_step`` on the device sub-config (its
    one route for the device stack), then the host tier's update.
    ``opt_state``: None for SGD; ``rows``: the step's rows, gathered
    ahead."""
    emb = _tiered(params)
    grads = _TierGrads(emb, config, rows=rows)
    loss, _ = train_lib._micro_step(
        _device_view(params),
        None if opt_state is None else _device_state(opt_state), dense,
        sparse, labels, config=_tier_config(emb.plan, config),
        optimizer=optimizer, lr=lr, grad_clip_norm=None,
        value_and_grad=grads, apply_big=True)
    if grads.host[0] is not None:
        _host_opt(emb, opt_state, grads.host[0], optimizer=optimizer, lr=lr)
    return loss


def tiered_train_step(params: dict, dense, sparse, labels, *,
                      config: DLRMConfig, lr: float) -> torch.Tensor:
    """One SGD step with two-tier tables, in place (``params["emb"]`` a
    :class:`TieredEmb`); returns the loss (0-d, no host sync of its own:
    the host tier's duplicate sum syncs once).  Both tiers' gradients stay
    per hit; the device tier takes one ``index_add_``, the host tier one
    add a distinct row.  :func:`tiered_train_step_opt` with
    ``optimizer='sgd'``."""
    return _tiered_step(params, None, dense, sparse, labels, config=config,
                        optimizer="sgd", lr=train_lib._f32(lr))


def _block_host_rows(emb: TieredEmb, sparse):
    """A block's host-tier work at entry: (the host ids (K, B, T_host[,
    H]), their rows gathered in one call, a (K, B * T_host[* H], D) buffer
    for their gradients), or Nones without a host tier."""
    plan = emb.plan
    if not plan.host_tables:
        return None, None, None
    ids = _tier_ids(sparse, plan.host_tables, plan.host_offsets,
                    table_axis=2)
    with phase_scope("lookup_host_tier"):
        rows = host_tier_gather(emb.host, ids)
    out = torch.empty((ids.shape[0], ids[0].numel(), emb.host.shape[1]),
                      dtype=emb.host.dtype, device=rows.device)
    return ids, rows, out


def tiered_train_block(params: dict, dense, sparse, labels, *,
                       config: DLRMConfig, lr: float) -> torch.Tensor:
    """K SGD micro-steps (K: the batches' leading dimension) with the
    host-tier work coalesced: one gather of all K micro-batches' host rows
    at block entry, one update at block end.  The device tier runs
    ``train.train._run_block`` on the device sub-config: dense parameters
    and small tables update every micro-step, big tables at block end.
    Host and big device rows are read as of block entry (stale by fewer
    than K steps); with no such row repeated across the micro-batches the
    block equals K :func:`tiered_train_step` calls.  Returns the K
    losses."""
    lr = train_lib._f32(lr)
    emb = _tiered(params)
    plan, k = emb.plan, dense.shape[0]
    ids, rows, out = _block_host_rows(emb, sparse)
    losses = train_lib._run_block(
        _device_view(params), None, dense, sparse, labels,
        config=_tier_config(plan, config), optimizer="sgd", lrs=[lr] * k,
        scheduled=False, grad_clip_norm=None,
        value_and_grad=_TierGrads(emb, config, rows, out))
    if plan.host_tables:
        with torch.no_grad(), phase_scope("host_tier_update"):
            _host_sgd(emb.host, ids, out, lr)
    return losses


def tiered_train_step_pipelined(params: dict, pref_rows, dense, sparse,
                                labels, sparse_next, *, config: DLRMConfig,
                                lr: float):
    """:func:`tiered_train_step` with this batch's rows gathered ahead
    (``pref_rows``, from :func:`prime_host_prefetch` or the previous call)
    and taken as the step's lookup; after this step's updates, the rows of
    the next batch ``sparse_next`` gathered on the same stream: they read
    the updated tiers, so they are exact.  Returns (the next batch's rows,
    loss)."""
    loss = _tiered_step(params, None, dense, sparse, labels, config=config,
                        optimizer="sgd", lr=train_lib._f32(lr),
                        rows=pref_rows)
    with phase_scope("host_tier_prefetch_next"):
        nxt = prime_host_prefetch(params["emb"], sparse_next)
    return nxt, loss


def prime_host_prefetch(emb: TieredEmb, sparse) -> torch.Tensor:
    """The rows (B, T[, H], D) of the batch ``sparse`` from both tiers, in
    the buffer the step's own lookup fills (the host tier's straight into
    their columns): the pipeline's first gather."""
    return _gather(emb, sparse)


# -- the optimizers -----------------------------------------------------------

def _host_tier_opt_apply(emb_host, acc, flat_ids, g, *, optimizer: str,
                         lr: float, scaled=None) -> None:
    """Dedup-then-apply Adagrad on the host tier, in place: the hits of a
    row summed in f32 on the card, the distinct rows' accumulator gathered,
    the update computed on the card (``ops.embedding.adagrad_rows``), then
    the accumulator and the table updated by ``host_update_rows`` (the
    accumulator's ``acc + g^2`` is the same f32 sum the step used).
    ``scaled`` (n, D): each hit's gradient times its own micro-step's lr,
    summed beside ``g`` (the twin payload of a scheduled block); the
    weights then take its sum and ``lr`` is not used."""
    with phase_scope("host_tier_update"):
        d = g.shape[1]
        rows = g if scaled is None else torch.cat([g, scaled], dim=1)
        u = emb_ops.sum_duplicates(emb_ops.SparseGrad(flat_ids, rows))
        d_acc, upd = emb_ops.adagrad_rows(
            host_tier_gather(acc, u.ids), u.rows[:, :d], lr,
            rowwise=optimizer == "rowwise_adagrad",
            scaled=None if scaled is None else u.rows[:, d:])
        _host_update(acc, u.ids, d_acc)
        _host_update(emb_host, u.ids, upd)


def _host_opt(emb: TieredEmb, opt_state: dict, grad, *, optimizer: str,
              lr: float) -> None:
    with torch.no_grad():
        if optimizer == "sgd":
            with phase_scope("host_tier_update"):
                _host_sgd(emb.host, grad.ids, grad.rows, lr)
        else:
            _host_tier_opt_apply(emb.host, opt_state["host_acc"], grad.ids,
                                 grad.rows.float(), optimizer=optimizer,
                                 lr=lr)


def _device_state(opt_state: dict) -> dict:
    """The optimizer state as ``train.train`` sees it on the device
    sub-config."""
    return {"dense": opt_state["dense"], "emb": opt_state["dev_acc"],
            "count": opt_state["count"]}


def tiered_train_step_opt(params: dict, opt_state: dict, dense, sparse,
                          labels, *, config: DLRMConfig, optimizer: str,
                          lr) -> torch.Tensor:
    """One two-tier step with ``sgd``, ``adagrad`` or ``rowwise_adagrad``,
    ``params`` and ``opt_state`` (:func:`init_tiered_opt_state`) in place.
    ``lr``: a float or a schedule read at ``opt_state['count']``.  The
    device tier takes ``train.train``'s dedup-then-apply step on the
    device sub-config; the host tier its own on the pinned accumulator.
    Returns the loss."""
    optim.check_optimizer(optimizer)
    loss = _tiered_step(
        params, opt_state, dense, sparse, labels, config=config,
        optimizer=optimizer,
        lr=train_lib._f32(lr(opt_state["count"]) if callable(lr) else lr))
    opt_state["count"] += 1
    return loss


def tiered_train_block_opt(params: dict, opt_state: dict, dense, sparse,
                           labels, *, config: DLRMConfig, optimizer: str,
                           lr: float) -> torch.Tensor:
    """K two-tier micro-steps with Adagrad or row-wise Adagrad, in place.
    The dense parameters and the device tier take a full step every
    micro-step; the host tier's rows of all K micro-batches are gathered at
    block entry, and their gradients deduplicated across the whole block
    and applied once at block end (a row hit in two micro-steps gets one
    accumulator update with the summed gradient).  With no host row
    repeated across the micro-batches the block equals K
    :func:`tiered_train_step_opt` calls.  ``lr`` is a constant.  Returns
    the K losses."""
    if optimizer not in ("adagrad", "rowwise_adagrad"):
        raise ValueError(f"tiered_train_block_opt runs adagrad or "
                         f"rowwise_adagrad, got {optimizer!r}; SGD blocks "
                         f"use tiered_train_block")
    if callable(lr):
        raise ValueError("scheduled tiered blocks are not built: pass a "
                         "constant lr")
    lr = train_lib._f32(lr)
    emb = _tiered(params)
    plan, k, d = emb.plan, dense.shape[0], config.feature_size
    ids, rows, out = _block_host_rows(emb, sparse)
    grads = _TierGrads(emb, config, rows, out)
    dev_state = _device_state(opt_state)
    dev_cfg = _tier_config(plan, config)
    losses = []
    for i in range(k):
        loss, _ = train_lib._micro_step(
            _device_view(params), dev_state, dense[i], sparse[i], labels[i],
            config=dev_cfg, optimizer=optimizer, lr=lr, grad_clip_norm=None,
            value_and_grad=grads, apply_big=True)
        losses.append(loss)
    if plan.host_tables:
        _host_opt(emb, opt_state, emb_ops.SparseGrad(ids.reshape(-1),
                                                     out.reshape(-1, d)),
                  optimizer=optimizer, lr=lr)
    opt_state["count"] += k
    return torch.stack(losses)


def init_tiered_opt_state(params: dict, *, config: DLRMConfig,
                          optimizer: str) -> dict:
    """Optimizer state with tier-matched accumulators: ``dense`` (as
    ``train.init_opt_state``), ``dev_acc`` (``optim.init_emb_state`` of the
    device stack, on the device), ``host_acc`` (zeros in pinned host
    memory: ``(R_host, D)`` for adagrad, ``(R_host,)`` for
    rowwise_adagrad), both None for sgd, and ``count``."""
    optim.check_optimizer(optimizer)
    emb = _tiered(params)
    state = {"dense": optim.init_dense_state(optimizer, _dense(params)),
             "count": 0, "dev_acc": None, "host_acc": None}
    if optimizer != "sgd":
        state["dev_acc"] = optim.init_emb_state(
            _tier_config(emb.plan, config), optimizer, emb.dev)
        shape = emb.host.shape if optimizer == "adagrad" \
            else emb.host.shape[:1]
        state["host_acc"] = _host_empty(shape, torch.float32,
                                        emb.device).zero_()
    return state


# -- placement and checkpoints ------------------------------------------------

def init_tiered_params(params: dict, plan: TierPlan, config: DLRMConfig,
                       device=None) -> dict:
    """``{bottom, emb, top}`` -> ``{bottom, top, emb: TieredEmb}`` on
    ``device`` (default: the tables'), the host tier pinned
    (:func:`split_tiers`); every tensor a copy.  The caller drops the full
    stack."""
    device = params["emb"].device if device is None else torch.device(device)
    dev, host = split_tiers(params["emb"], plan, config, device)
    dense = emb_ops.tree_map(lambda t: t.to(device, copy=True),
                             _dense(params))
    return {**dense, "emb": TieredEmb(dev, host, plan)}


def draw_tiered_params(generator: torch.Generator, plan: TierPlan,
                       config: DLRMConfig, device=None,
                       emb_init: str = "scaled_uniform",
                       out: Optional[TieredEmb] = None) -> dict:
    """Tiered parameters drawn straight into their tiers: the same bits as
    :func:`init_tiered_params` of ``models.dlrm.init_params`` from the same
    generator, with no full stack anywhere (the card holds the device tier
    and one staging chunk of the draws, ``models.dlrm.init_tables``).

    ``out``: tiers to draw into in place, of the plan's shapes in the
    config's dtype (the device tier on ``device``, the host tier in host
    memory), e.g. another model's tiers of the same bytes viewed in this
    dtype; nothing is then allocated or registered for the tables."""
    from dlrm_tpu_torch.models.dlrm import init_dense, init_tables

    device = generator.device if device is None else torch.device(device)
    d = config.feature_size
    if out is None:
        dev = torch.empty((plan.device_rows, d),
                          dtype=config.embedding_dtype, device=device)
        host = _host_empty((plan.host_rows, d), config.embedding_dtype,
                           device)
    else:
        dev, host = out.dev, out.host
        check_tiered_storage(TieredEmb(dev, host, plan), config)
        if dev.dtype != config.embedding_dtype \
                or dev.device.type != device.type:
            raise ValueError(f"out= tiers of {dev.dtype} on {dev.device}; "
                             f"the draw makes {config.embedding_dtype} on "
                             f"{device}")
    dense = init_dense(generator, config, device)
    dst = [None] * config.num_tables
    for tables, offsets, stack in ((plan.device_tables, plan.device_offsets,
                                    dev),
                                   (plan.host_tables, plan.host_offsets,
                                    host)):
        for t, lo in zip(tables, offsets):
            dst[t] = stack[lo:lo + config.table_sizes[t]]
    init_tables(generator, config, dst, emb_init)
    return {**dense, "emb": TieredEmb(dev, host, plan)}


def tiered_payload(params: dict) -> dict:
    """What a checkpoint holds of tiered parameters (the JAX package's
    tree): ``{bottom, top, emb_dev, emb_host}``, the live tensors, so a
    restore with ``out=`` fills them in place."""
    emb = _tiered(params)
    return {**_dense(params), "emb_dev": emb.dev, "emb_host": emb.host}


def place_tiered(tree: dict, plan: TierPlan, config: DLRMConfig,
                 device) -> dict:
    """Tiered parameters from an opened checkpoint (``io.checkpoint``
    leaves of :func:`tiered_payload`): the dense towers and the device tier
    read to ``device``, the host tier read straight into pinned host
    memory."""
    from dlrm_tpu_torch.io.checkpoint import read_tree

    device = torch.device(device)
    dense = read_tree({"bottom": tree["bottom"], "top": tree["top"]}, device)
    leaf_d, leaf_h = tree["emb_dev"], tree["emb_host"]
    dev = torch.empty(leaf_d.shape, dtype=leaf_d.dtype, device=device)
    host = _host_empty(leaf_h.shape, leaf_h.dtype, device)
    read_tree(leaf_d, device, out=dev)
    read_tree(leaf_h, out=host)
    emb = TieredEmb(dev, host, plan)
    check_tiered_storage(emb, config)
    return {**dense, "emb": emb}


def place_tiered_opt(tree: dict, device) -> dict:
    """A tiered optimizer state from an opened checkpoint: the host
    accumulator read into pinned host memory, everything else to
    ``device``."""
    from dlrm_tpu_torch.io.checkpoint import read_tree

    device = torch.device(device)
    out = read_tree({k: v for k, v in tree.items() if k != "host_acc"},
                    device)
    leaf = tree["host_acc"]
    out["host_acc"] = None
    if leaf is not None:
        out["host_acc"] = _host_empty(leaf.shape, leaf.dtype, device)
        read_tree(leaf, out=out["host_acc"])
    return out
