"""Checkpoints and resume: the counterpart of ``dlrm_tpu/io/checkpoint.py``,
in plain files instead of orbax.

A checkpoint is one directory ``<ckpt_dir>/<step>/`` holding one ``.npy``
file per tensor leaf of the payload and ``checkpoint.json``, which names
the step and the payload's tree: dicts, lists and tuples, ``None``, plain
numbers (an optimizer state's ``count``) and, for each tensor, its file,
dtype and shape.  Payloads are those of the JAX package's CLI: the
parameter dict, or ``{"params": ..., "opt": ...}`` with the optimizer state
of ``train.init_opt_state``.

* **Atomic.**  A checkpoint is written under a temporary name (a leading
  dot, so no step), every file ``fsync``ed, then ``os.replace``d into
  place; :func:`latest_step` never sees a partial one.
* **bf16** leaves are stored as their uint16 bits (numpy has no bf16), the
  dtype in the JSON; a restore gives the same bits.
* **Bounded host memory.**  Tensors move between the device and the file
  in row chunks through one host buffer of ``BUFFER_BYTES`` (pinned for a
  CUDA device), never as one host copy of a table stack (17.29 GB at
  Kaggle fs=128).  ``restore_checkpoint(out=...)`` fills existing tensors
  in place, so a restore needs no second copy of the tables on the device;
  for host-side consumers a leaf reads a slice of rows at a time
  (``Leaf.array``: the int8 export quantizes chunk by chunk from it).
* **Synchronous.**  ``save`` returns once the files are on disk.  A save
  and a restore wait for the card first, so host tensors that its kernels
  write (a two-tier host stack in pinned memory) are read and filled in
  place, with no temporary copy.

**Sharded checkpoints.**  A sharded run's payload (:func:`sharded_payload`)
marks each rank's part of a table stack as a :class:`Shard`; its file holds
the JAX package's global layout, every rank's slab stacked, ``(N, *slab)``
(``emb`` ``(N, local_rows, D)``, a column shard ``(N, R_t, D/N)``, a
row-wise accumulator ``(N, local_rows, 1)``).  The lead process creates
each such file at its full size and writes the dense leaves; then each
rank of the first data-parallel replica writes its slab at its offset and
fsyncs it; then the lead writes ``checkpoint.json``, which also records
the placement (``plan_placement``'s arguments), and renames the directory
into place.  Each phase ends with every rank learning whether all
succeeded (:func:`_all_ok`).  The lead decides the latest step and the
retention.  A restore under the same placement reads each rank's slab
straight into its live tensors; under another (another number of ranks,
1 included) it goes table by table through both placements
(:func:`_restore_resharded`), a chunk of rows on the host at a time.

Reading a checkpoint that the JAX package wrote needs orbax; parameters
cross between the two packages through HDF5 (``io/hdf5.py``) instead.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Iterator, NamedTuple, Optional, Tuple

import numpy as np
import torch

META = "checkpoint.json"
# the host buffer a tensor crosses in: 64 MB, 131,072 rows of 128 f32
BUFFER_BYTES = 1 << 26

_DTYPES = {str(d).removeprefix("torch."): d for d in (
    torch.float32, torch.float64, torch.float16, torch.bfloat16, torch.int8,
    torch.uint8, torch.int16, torch.int32, torch.int64, torch.bool)}
# what a dtype is stored as: bf16 as its bits
_STORED = {torch.bfloat16: (np.dtype(np.uint16), torch.int16)}


class Leaf(NamedTuple):
    """A tensor of a checkpoint on disk: its ``.npy`` file, shape and
    dtype, known without reading the array; ``sharded``: the file stacks
    the slabs of every rank (``shape[0]`` of them)."""

    file: str
    shape: Tuple[int, ...]
    dtype: torch.dtype
    sharded: bool = False

    def array(self):
        """The array, read a row slice at a time (bf16 as f32): see
        :class:`_Rows`."""
        return _Rows(self.file, self.dtype == torch.bfloat16)


class _Rows:
    """A leaf's ``.npy`` file as an array of rows that are read on
    indexing: a slice of rows maps only those rows, copies them out and
    unmaps them, so a consumer that reads chunk by chunk keeps no more of
    the file resident than one chunk (a mapping of the whole file would
    hold every page it had touched).  So do ``[i, a:b]`` and ``[:, a:b]``
    of a sharded leaf (slab i's rows, every slab's).  bf16 bits come out
    as f32."""

    def __init__(self, file: str, bf16: bool):
        mm = np.load(file, mmap_mode="r")
        self.file, self.bf16 = file, bf16
        self.stored, self.offset, self.shape = mm.dtype, mm.offset, mm.shape
        self.dtype = np.dtype(np.float32) if bf16 else mm.dtype
        self.ndim = len(self.shape)
        del mm

    def __len__(self) -> int:
        return self.shape[0]

    def _span(self, start: int, n: int, row: tuple) -> np.ndarray:
        """``n`` rows of shape ``row`` from row ``start`` of the file's
        array taken as rows of that shape: mapped, copied, unmapped."""
        if n <= 0 or 0 in row:
            return np.empty((max(n, 0), *row), self.stored)
        nbytes = int(np.prod(row, dtype=np.int64)) * self.stored.itemsize
        return np.array(np.memmap(self.file, self.stored, "r",
                                  self.offset + start * nbytes, (n, *row)))

    def _read(self, idx) -> np.ndarray:
        contiguous = lambda i: isinstance(i, slice) and i.step in (None, 1)
        if contiguous(idx) and self.ndim:
            start, stop, _ = idx.indices(self.shape[0])
            return self._span(start, stop - start, self.shape[1:])
        if isinstance(idx, int) and self.ndim:
            return self._span(idx % self.shape[0], 1, self.shape[1:])[0]
        if isinstance(idx, tuple) and len(idx) == 2 and self.ndim >= 2 \
                and contiguous(idx[1]) and (isinstance(idx[0], int)
                                            or idx[0] == slice(None)):
            per = self.shape[1]
            a, b, _ = idx[1].indices(per)
            slabs = [idx[0] % self.shape[0]] if isinstance(idx[0], int) \
                else range(self.shape[0])
            parts = [self._span(i * per + a, b - a, self.shape[2:])
                     for i in slabs]
            return parts[0] if isinstance(idx[0], int) else np.stack(parts)
        return np.array(np.load(self.file, mmap_mode="r")[idx])

    def __getitem__(self, idx) -> np.ndarray:
        out = self._read(idx)
        return (out.astype(np.uint32) << 16).view(np.float32) if self.bf16 \
            else out

    def __array__(self, dtype=None, copy=None):
        out = self[...]
        return out if dtype is None else out.astype(dtype)


class Shard(NamedTuple):
    """A leaf of a sharded payload: this rank's slab of an array that the
    checkpoint stores stacked over the table group's ranks, ``(N,
    *tensor.shape)``, slab ``i`` of rank ``i``."""

    tensor: torch.Tensor


class ShardGroup(NamedTuple):
    """How a process takes part in a sharded checkpoint: ``index``, its
    slab (its rank in the table group) of ``count``; ``writes``: it writes
    its slabs (the first replica of the data-only axis does); ``lead``: it
    writes the dense leaves and ``checkpoint.json`` and decides the latest
    step and the retention; ``placement``: ``plan_placement``'s keyword
    arguments (``table_sizes``, ``num_shards``, ``max_rows_per_shard``,
    ``col_sharded_tables``, ``host_tables``), recorded in the checkpoint
    and compared on restore."""

    index: int
    count: int
    writes: bool
    lead: bool
    placement: dict


def _as_rows(t: torch.Tensor) -> torch.Tensor:
    return t.unsqueeze(-1) if t.dim() == 1 else t


def sharded_payload(params: dict, opt_state: Optional[dict] = None) -> dict:
    """What a checkpoint holds of a rank's sharded state, the live tensors
    (so a restore with ``out=`` fills them in place): the parameters of
    ``train.sharded_train_step`` (``{"bottom", "top", "emb", "emb_cs"}``,
    ``"emb_h"`` with host tables) with each table tensor a :class:`Shard`,
    and with an optimizer state (``train.init_sharded_opt_state``)
    ``{"params", "opt"}``: the accumulators beside their tables are
    Shards too (a row-wise one as ``(rows, 1)``), a row-wise column
    shard's ``(R_t,)``, the same on every rank, a plain leaf."""
    p = {"bottom": params["bottom"], "top": params["top"],
         "emb": Shard(params["emb"]),
         "emb_cs": tuple(Shard(c) for c in params.get("emb_cs", ()))}
    if params.get("emb_h") is not None:
        p["emb_h"] = Shard(params["emb_h"])
    if opt_state is None:
        return p
    o = {"dense": opt_state["dense"], "count": opt_state["count"],
         "emb_acc": None, "emb_acc_cs": (), "emb_acc_h": None}
    if opt_state["emb_acc"] is not None:
        o["emb_acc"] = Shard(_as_rows(opt_state["emb_acc"]))
        o["emb_acc_cs"] = tuple(a if a.dim() == 1 else Shard(a)
                                for a in opt_state["emb_acc_cs"])
        if opt_state["emb_acc_h"] is not None:
            o["emb_acc_h"] = Shard(_as_rows(opt_state["emb_acc_h"]))
    return {"params": p, "opt": o}


def payload_bytes(payload: Any) -> int:
    """Bytes of the tensors of a payload (a :class:`Shard` counts this
    rank's slab): what this process writes or reads of a checkpoint."""
    if isinstance(payload, Shard):
        payload = payload.tensor
    if isinstance(payload, torch.Tensor):
        return payload.numel() * payload.element_size()
    if isinstance(payload, dict):
        payload = list(payload.values())
    if isinstance(payload, (list, tuple)):
        return sum(payload_bytes(x) for x in payload)
    return 0


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    if dtype in _STORED:
        return _STORED[dtype][0]
    return torch.empty((), dtype=dtype).numpy().dtype


def _bits(t: torch.Tensor) -> torch.Tensor:
    """``t`` with a dtype numpy can hold (bf16 as int16 bits)."""
    return t.view(_STORED[t.dtype][1]) if t.dtype in _STORED else t


def _step_dir(ckpt_dir, step: int) -> str:
    return os.path.join(os.path.abspath(ckpt_dir), str(int(step)))


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _chunks(shape: tuple, itemsize: int) -> Iterator[Tuple[int, int]]:
    """(first, last) rows of the chunks of a tensor of ``shape``, each at
    most ``BUFFER_BYTES`` (at least one row); one chunk for a 0-d tensor."""
    if not shape:
        yield 0, 1
        return
    row = itemsize * int(np.prod(shape[1:], dtype=np.int64))
    per = max(1, BUFFER_BYTES // max(row, 1))
    for s in range(0, shape[0], per):
        yield s, min(s + per, shape[0])


class _Buffer:
    """One reusable pinned host buffer of ``BUFFER_BYTES`` that device
    tensors cross in; made at first use (CPU tensors need none)."""

    def __init__(self):
        self.t = None

    def view(self, dtype: torch.dtype, shape: tuple) -> torch.Tensor:
        if self.t is None:
            self.t = torch.empty(BUFFER_BYTES, dtype=torch.uint8,
                                 pin_memory=True)
        n = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        return self.t[:n].view(dtype).view(shape)


def _header(f, shape: tuple, dtype: torch.dtype) -> None:
    np.lib.format.write_array_header_1_0(f, {
        "descr": np.lib.format.dtype_to_descr(_np_dtype(dtype)),
        "fortran_order": False, "shape": tuple(shape)})


def _write_rows(f, t: torch.Tensor, buf: _Buffer) -> None:
    """``t``'s bytes at the file's position, chunk by chunk through
    ``buf``; then flushed and fsynced."""
    flat = _bits(t.detach().reshape(1) if t.dim() == 0 else t.detach())
    for s, e in _chunks(tuple(t.shape), t.element_size()):
        part = flat[s:e]
        if part.device.type == "cpu":
            host = part.contiguous()
        else:
            host = buf.view(part.dtype, tuple(part.shape))
            host.copy_(part)
        f.write(memoryview(host.numpy()).cast("B"))
    f.flush()
    os.fsync(f.fileno())


def _write_tensor(path: str, t: torch.Tensor, buf: _Buffer) -> None:
    with open(path, "wb") as f:
        _header(f, tuple(t.shape), t.dtype)
        _write_rows(f, t, buf)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _name(path: Tuple[str, ...]) -> str:
    return ".".join(path) + ".npy"


def _encode(node, path: Tuple[str, ...], stage: str, buf: _Buffer,
            shards: Optional[ShardGroup] = None):
    if isinstance(node, Shard):
        t = node.tensor
        with open(os.path.join(stage, _name(path)), "wb") as f:
            _header(f, (shards.count, *t.shape), t.dtype)
            f.truncate(f.tell() + shards.count * _nbytes(t))
        return {"tensor": _name(path), "shape": [shards.count, *t.shape],
                "dtype": str(t.dtype).removeprefix("torch."),
                "sharded": True}
    if isinstance(node, torch.Tensor):
        name = _name(path)
        _write_tensor(os.path.join(stage, name), node, buf)
        return {"tensor": name, "shape": list(node.shape),
                "dtype": str(node.dtype).removeprefix("torch.")}
    if isinstance(node, dict):
        return {"dict": {str(k): _encode(v, path + (str(k),), stage, buf,
                                         shards)
                         for k, v in node.items()}}
    if isinstance(node, (list, tuple)):
        kind = "list" if isinstance(node, list) else "tuple"
        return {kind: [_encode(v, path + (str(i),), stage, buf, shards)
                       for i, v in enumerate(node)]}
    if node is None:
        return None
    if isinstance(node, (int, float)):
        return {"value": node}
    raise TypeError(f"checkpoint payload leaf {'.'.join(path)} is a "
                    f"{type(node).__name__}; payloads hold tensors, numbers, "
                    "None, dicts, lists and tuples")


def _sync() -> None:
    """Wait for the card: its kernels read and write pinned host tensors
    (a two-tier host stack) asynchronously, and a checkpoint reads or
    fills them on the host."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def save_checkpoint(ckpt_dir, step: int, payload: Any) -> str:
    """Write one checkpoint at ``ckpt_dir/<step>``; returns its path.  A
    checkpoint already at that step is replaced."""
    _sync()
    root = os.path.abspath(ckpt_dir)
    os.makedirs(root, exist_ok=True)
    stage = tempfile.mkdtemp(prefix=f".tmp-{int(step)}-", dir=root)
    try:
        tree = _encode(payload, (), stage, _Buffer())
        with open(os.path.join(stage, META), "w") as f:
            json.dump({"step": int(step), "tree": tree}, f)
            f.flush()
            os.fsync(f.fileno())
        _fsync_dir(stage)
        final = _step_dir(root, step)
        if os.path.exists(final):
            old = tempfile.mkdtemp(prefix=f".old-{int(step)}-", dir=root)
            os.replace(final, os.path.join(old, "ckpt"))
            os.replace(stage, final)
            shutil.rmtree(old)
        else:
            os.replace(stage, final)
        _fsync_dir(root)
    except BaseException:
        shutil.rmtree(stage, ignore_errors=True)
        raise
    return final


def _shards(node, path: Tuple[str, ...] = ()):
    """(file name, :class:`Shard`) of every Shard of a payload, in the
    order :func:`_encode` names them."""
    if isinstance(node, Shard):
        yield _name(path), node
    elif isinstance(node, dict):
        for k, v in node.items():
            yield from _shards(v, path + (str(k),))
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            yield from _shards(v, path + (str(i),))


def _data_offset(f) -> int:
    """The byte where an ``.npy`` file's array starts (``f`` just
    opened)."""
    version = np.lib.format.read_magic(f)
    (np.lib.format.read_array_header_1_0 if version == (1, 0)
     else np.lib.format.read_array_header_2_0)(f)
    return f.tell()


def _all_ok(error: Optional[str]) -> None:
    """Every rank's outcome of a phase gathered, so that all go on or all
    raise (a rank that failed alone would leave the others waiting)."""
    import torch.distributed as dist

    errors = [None] * dist.get_world_size()
    dist.all_gather_object(errors, error)
    failed = [f"rank {r}: {e}" for r, e in enumerate(errors) if e]
    if failed:
        raise RuntimeError("sharded checkpoint: " + "; ".join(failed))


def _phase(run, go: bool) -> None:
    """``run()`` where ``go``, then :func:`_all_ok` on every rank."""
    error = None
    if go:
        try:
            run()
        except Exception as e:  # every rank learns of it below
            error = f"{type(e).__name__}: {e}"
    _all_ok(error)


def _record(placement: dict) -> dict:
    """A placement record as JSON gives it back (lists, not tuples)."""
    return json.loads(json.dumps(placement))


def save_sharded_checkpoint(ckpt_dir, step: int, payload: Any,
                            group: ShardGroup) -> str:
    """Write one sharded checkpoint at ``ckpt_dir/<step>``; every rank of
    the gang calls it with its payload (:func:`sharded_payload`).  See the
    module's docstring for the phases; returns the checkpoint's path once
    it is in place on every rank."""
    _sync()
    root = os.path.abspath(ckpt_dir)
    stage = os.path.join(root, f".tmp-{int(step)}-sharded")
    final = _step_dir(root, step)
    box = {}

    def create():
        os.makedirs(root, exist_ok=True)
        shutil.rmtree(stage, ignore_errors=True)
        os.mkdir(stage)
        box["tree"] = _encode(payload, (), stage, _Buffer(), group)

    def write_slabs():
        buf = _Buffer()
        for name, shard in _shards(payload):
            with open(os.path.join(stage, name), "r+b") as f:
                f.seek(_data_offset(f) + group.index * _nbytes(shard.tensor))
                _write_rows(f, shard.tensor, buf)

    def finish():
        with open(os.path.join(stage, META), "w") as f:
            json.dump({"step": int(step), "tree": box["tree"],
                       "placement": _record(group.placement)}, f)
            f.flush()
            os.fsync(f.fileno())
        _fsync_dir(stage)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(stage, final)
        _fsync_dir(root)

    try:
        _phase(create, group.lead)
        _phase(write_slabs, group.writes)
        _phase(finish, group.lead)
    except BaseException:
        if group.lead:
            shutil.rmtree(stage, ignore_errors=True)
        raise
    return final


def all_steps(ckpt_dir) -> list:
    """The steps of the complete checkpoints under ``ckpt_dir``, in
    ascending order."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(d) for d in os.listdir(ckpt_dir) if d.isdigit()
                  and os.path.isfile(os.path.join(ckpt_dir, d, META)))


def latest_step(ckpt_dir) -> Optional[int]:
    """Largest integer-named subdirectory holding a complete checkpoint."""
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def _decode(node, stage: str):
    if node is None:
        return None
    if "tensor" in node:
        return Leaf(os.path.join(stage, node["tensor"]),
                    tuple(node["shape"]), _DTYPES[node["dtype"]],
                    bool(node.get("sharded")))
    if "dict" in node:
        return {k: _decode(v, stage) for k, v in node["dict"].items()}
    if "list" in node:
        return [_decode(v, stage) for v in node["list"]]
    if "tuple" in node:
        return tuple(_decode(v, stage) for v in node["tuple"])
    return node["value"]


def open_checkpoint(ckpt_dir, step: Optional[int] = None):
    """(payload with a :class:`Leaf` for every tensor, step): the tree
    read from the checkpoint's JSON, no array read.  Default: the latest
    step."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    path = _step_dir(ckpt_dir, step)
    with open(os.path.join(path, META)) as f:
        meta = json.load(f)
    return _decode(meta["tree"], path), int(meta["step"])


def checkpoint_placement(ckpt_dir, step: Optional[int] = None
                         ) -> Optional[dict]:
    """The placement record of a sharded checkpoint (:class:`ShardGroup`'s
    ``placement``), None for another; default: the latest step."""
    if step is None:
        step = latest_step(ckpt_dir)
    with open(os.path.join(_step_dir(ckpt_dir, step), META)) as f:
        return json.load(f).get("placement")


def checkpoint_metadata(ckpt_dir, step: Optional[int] = None):
    """The payload's tree with the shape and dtype of every tensor
    (:class:`Leaf`), read without reading any array."""
    return open_checkpoint(ckpt_dir, step)[0]


def _read_exact(f, mv: memoryview) -> None:
    while len(mv):
        n = f.readinto(mv)
        if not n:
            raise EOFError(f"{f.name}: the file ends early")
        mv = mv[n:]


def _read_tensor(leaf: Leaf, device, out: Optional[torch.Tensor],
                 buf: _Buffer, slab: Optional[int] = None) -> torch.Tensor:
    """The leaf's array into ``out`` (or a new tensor on ``device``);
    ``slab``: only that slab of a sharded leaf."""
    shape = leaf.shape if slab is None else leaf.shape[1:]
    if out is None:
        out = torch.empty(shape, dtype=leaf.dtype, device=device)
    elif tuple(out.shape) != shape or out.dtype != leaf.dtype \
            or not out.is_contiguous():
        raise ValueError(f"{leaf.file} holds {shape} {leaf.dtype}"
                         f"{'' if slab is None else ' a slab'}; cannot fill "
                         f"a {tuple(out.shape)} {out.dtype} tensor "
                         f"(contiguous: {out.is_contiguous()})")
    with open(leaf.file, "rb", buffering=0) as f:
        read_header = (np.lib.format.read_array_header_1_0
                       if np.lib.format.read_magic(f) == (1, 0)
                       else np.lib.format.read_array_header_2_0)
        stored, fortran, dtype = read_header(f)
        if tuple(stored) != leaf.shape or fortran \
                or dtype != _np_dtype(leaf.dtype):
            raise ValueError(f"{leaf.file}: header {stored} {dtype} does not "
                             f"match the checkpoint's {leaf.shape} "
                             f"{leaf.dtype}")
        if slab is not None:
            f.seek(f.tell() + slab * _nbytes(out))
        flat = _bits(out.reshape(1) if out.dim() == 0 else out)
        for s, e in _chunks(shape, out.element_size()):
            part = flat[s:e]
            if part.device.type == "cpu":
                _read_exact(f, memoryview(part.numpy()).cast("B"))
            else:
                host = buf.view(part.dtype, tuple(part.shape))
                _read_exact(f, memoryview(host.numpy()).cast("B"))
                part.copy_(host)
    return out


def read_tree(tree, device="cpu", out=None, slab: Optional[int] = None):
    """The payload of an opened checkpoint with every :class:`Leaf` read
    into a new tensor on ``device``, chunk by chunk through one host
    buffer.  With ``out`` (a payload of the same tree) each leaf is read
    into the tensor at its place, in place; a tree that differs (another
    optimizer's state, a missing tensor) raises.  A sharded leaf fills the
    :class:`Shard` at its place with slab ``slab``."""
    buf = _Buffer()
    device = torch.device(device)
    _sync()

    def mismatch(path, what):
        return ValueError(f"checkpoint does not match the state to fill at "
                          f"{'.'.join(map(str, path)) or 'the root'}: "
                          f"{what}")

    def walk(node, into, path):
        strict = out is not None
        if isinstance(node, Leaf):
            if strict and node.sharded:
                if not isinstance(into, Shard) or slab is None:
                    raise mismatch(path, "a sharded leaf: the state needs a "
                                   "Shard there, and a slab to read")
                return _read_tensor(node, device, into.tensor, buf, slab)
            if strict and not isinstance(into, torch.Tensor):
                raise mismatch(path, f"a tensor, not {type(into).__name__}")
            return _read_tensor(node, device, into if strict else None, buf)
        if strict and isinstance(into, torch.Tensor):
            raise mismatch(path, "the state has a tensor there")
        if isinstance(node, dict):
            if strict and (not isinstance(into, dict)
                           or set(into) != set(node)):
                have = sorted(into) if isinstance(into, dict) else into
                raise mismatch(path, f"keys {sorted(node)}, not {have}")
            return {k: walk(v, into[k] if strict else None, path + (k,))
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            if strict and (not isinstance(into, (list, tuple))
                           or len(into) != len(node)):
                raise mismatch(path, f"{len(node)} entries")
            got = [walk(v, into[i] if strict else None, path + (i,))
                   for i, v in enumerate(node)]
            return got if isinstance(node, list) else tuple(got)
        if strict and (node is None) != (into is None):
            raise mismatch(path, f"{node!r}, not {type(into).__name__}")
        return node

    return walk(tree, out, ())


_TABLE_KEYS = (("emb", "emb_h", "emb_cs"),
               ("emb_acc", "emb_acc_h", "emb_acc_cs"))


def _unshard(x):
    return x.tensor if isinstance(x, Shard) else x


def _restore_resharded(tree, saved: dict, group: ShardGroup, out):
    """Restore a sharded checkpoint saved under the placement ``saved``
    into a rank's live state ``out`` (:func:`sharded_payload`) under
    ``group.placement``: the dense leaves as they are, then every table
    and its accumulator table by table, ``models.dlrm.INIT_CHUNK_ROWS``
    rows at a time, read from the saved slabs
    (``parallel.embedding.table_rows``) and written into this rank's
    tensors (``place_rows``; host stacks in place)."""
    from dlrm_tpu_torch.models.dlrm import INIT_CHUNK_ROWS
    from dlrm_tpu_torch.parallel.embedding import place_rows, table_rows
    from dlrm_tpu_torch.parallel.placement import plan_placement

    old, new = plan_placement(**saved), plan_placement(**group.placement)
    if old.table_sizes != new.table_sizes:
        raise ValueError(f"checkpoint tables {list(old.table_sizes)}, the "
                         f"run's {list(new.table_sizes)}")
    wrapped = "opt" in tree
    parts = [(tree["params"], out["params"], _TABLE_KEYS[0]),
             (tree["opt"], out["opt"], _TABLE_KEYS[1])] if wrapped \
        else [(tree, out, _TABLE_KEYS[0])]
    cut_tree, cut_out = ({"params": {}, "opt": {}}, {"params": {}, "opt": {}}
                         ) if wrapped else ({}, {})
    for (node, into, keys), name in zip(parts, ("params", "opt")):
        dst_t = cut_tree[name] if wrapped else cut_tree
        dst_o = cut_out[name] if wrapped else cut_out
        for k in node:
            if k not in keys:
                dst_t[k], dst_o[k] = node[k], into[k]
    result = read_tree(cut_tree, out=cut_out)
    for node, into, (stack, host, cols) in parts:
        if node.get(stack) is None:
            continue
        src = {"emb": node[stack].array(),
               "emb_h": node[host].array() if node.get(host) else None,
               "emb_cs": [leaf.array() for leaf in node[cols]]}
        dst = {"emb": _unshard(into[stack]),
               "emb_h": _unshard(into.get(host)),
               "emb_cs": [_unshard(c) for c in into[cols]]}
        for t, rows in enumerate(new.table_sizes):
            for a in range(0, rows, INIT_CHUNK_ROWS):
                b = min(a + INIT_CHUNK_ROWS, rows)
                place_rows(table_rows(src, old, t, a, b), t, a, new,
                           group.index, dst)
        sub = result[name] if wrapped else result
        for k in (stack, host, cols):
            if k in into:
                sub[k] = into[k]
    return result


def read_sharded(tree, saved: dict, group: ShardGroup, out):
    """An opened sharded checkpoint's ``tree`` (or its parameters' subtree)
    saved under the placement record ``saved``, read into this rank's live
    state ``out`` (:func:`sharded_payload`, or its parameters): under the
    same placement each rank reads its own slabs straight into its
    tensors; under another, table by table (:func:`_restore_resharded`).
    Returns the payload read."""
    _sync()
    if saved == _record(group.placement):
        return read_tree(tree, out=out, slab=group.index)
    return _restore_resharded(tree, saved, group, out)


def restore_sharded(ckpt_dir, step: Optional[int] = None, *,
                    group: ShardGroup, out):
    """Restore (payload, step) of a sharded checkpoint into this rank's
    live state ``out`` (:func:`read_sharded`); default: the latest step.
    Every rank calls it."""
    tree, step = open_checkpoint(ckpt_dir, step)
    saved = checkpoint_placement(ckpt_dir, step)
    if saved is None:
        raise ValueError(f"{_step_dir(ckpt_dir, step)} is not a sharded "
                         f"run's checkpoint")
    return read_sharded(tree, saved, group, out), step


def restore_checkpoint(ckpt_dir, step: Optional[int] = None, *,
                       device="cpu", out=None):
    """Restore (payload, step) from ``ckpt_dir``; default: the latest step.

    Tensors come back on ``device`` in their saved dtype, or fill the
    tensors at the same places of ``out`` in place (shapes and dtypes must
    match); numbers come from the checkpoint.
    """
    tree, step = open_checkpoint(ckpt_dir, step)
    return read_tree(tree, device, out), step


class CheckpointManager:
    """Periodic save, bounded retention, resume.

    >>> mgr = CheckpointManager(dir, save_interval=1000, max_to_keep=3)
    >>> restored = mgr.restore_latest(out=state)   # None without one
    >>> mgr.maybe_save(step, state)   # saves when step % interval == 0
    """

    def __init__(self, ckpt_dir, *, save_interval: int = 1000,
                 max_to_keep: Optional[int] = 3,
                 shards: Optional[ShardGroup] = None):
        self.ckpt_dir = os.path.abspath(ckpt_dir)
        self.save_interval = int(save_interval)
        self.max_to_keep = max_to_keep
        self.shards = shards
        os.makedirs(self.ckpt_dir, exist_ok=True)

    def _drop_old(self) -> None:
        if self.max_to_keep:
            for old in all_steps(self.ckpt_dir)[:-self.max_to_keep]:
                shutil.rmtree(_step_dir(self.ckpt_dir, old))

    def save(self, step: int, payload: Any, *, force: bool = False) -> bool:
        """Write the checkpoint of ``step``, then drop the oldest beyond
        ``max_to_keep``.  Every call saves (``force`` is the JAX
        package's argument; its manager saves every step it is given).
        With ``shards`` every rank of the gang calls it with its payload,
        and the lead drops the old ones."""
        del force
        if self.shards is None:
            save_checkpoint(self.ckpt_dir, step, payload)
            self._drop_old()
            return True
        save_sharded_checkpoint(self.ckpt_dir, step, payload, self.shards)
        _phase(self._drop_old, self.shards.lead)
        return True

    def maybe_save(self, step: int, payload: Any) -> bool:
        if self.save_interval and step % self.save_interval == 0:
            return self.save(step, payload)
        return False

    def latest_step(self) -> Optional[int]:
        """The newest complete checkpoint's step; with ``shards``, the
        lead's reading, which every rank gets."""
        if self.shards is None:
            return latest_step(self.ckpt_dir)
        import torch.distributed as dist

        box = [latest_step(self.ckpt_dir) if self.shards.lead else None]
        dist.broadcast_object_list(box, src=0)
        return box[0]

    def restore_latest(self, *, device="cpu", out=None):
        """(payload, step) of the newest checkpoint, or None if none
        exists; with ``shards``, :func:`restore_sharded` into ``out``."""
        step = self.latest_step()
        if step is None:
            return None
        if self.shards is not None:
            return restore_sharded(self.ckpt_dir, step, group=self.shards,
                                   out=out)
        return restore_checkpoint(self.ckpt_dir, step, device=device,
                                  out=out)

    def wait_until_finished(self) -> None:
        """Saves are synchronous: nothing is in flight."""

    def close(self) -> None:
        self.wait_until_finished()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
