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
* **Synchronous.**  ``save`` returns once the files are on disk.

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
    dtype, known without reading the array."""

    file: str
    shape: Tuple[int, ...]
    dtype: torch.dtype

    def array(self):
        """The array, read a row slice at a time (bf16 as f32): see
        :class:`_Rows`."""
        return _Rows(self.file, self.dtype == torch.bfloat16)


class _Rows:
    """A leaf's ``.npy`` file as an array of rows that are read on
    indexing: a slice of rows maps only those rows, copies them out and
    unmaps them, so a consumer that reads chunk by chunk keeps no more of
    the file resident than one chunk (a mapping of the whole file would
    hold every page it had touched).  bf16 bits come out as f32."""

    def __init__(self, file: str, bf16: bool):
        mm = np.load(file, mmap_mode="r")
        self.file, self.bf16 = file, bf16
        self.stored, self.offset, self.shape = mm.dtype, mm.offset, mm.shape
        self.dtype = np.dtype(np.float32) if bf16 else mm.dtype
        self.ndim = len(self.shape)
        del mm

    def __len__(self) -> int:
        return self.shape[0]

    def _read(self, idx) -> np.ndarray:
        if isinstance(idx, slice) and idx.step in (None, 1) and self.ndim:
            start, stop, _ = idx.indices(self.shape[0])
            n, row = max(stop - start, 0), self.shape[1:]
            if n == 0 or 0 in row:
                return np.empty((n, *row), self.stored)
            nbytes = int(np.prod(row, dtype=np.int64)) * self.stored.itemsize
            return np.array(np.memmap(self.file, self.stored, "r",
                                      self.offset + start * nbytes,
                                      (n, *row)))
        return np.array(np.load(self.file, mmap_mode="r")[idx])

    def __getitem__(self, idx) -> np.ndarray:
        out = self._read(idx)
        return (out.astype(np.uint32) << 16).view(np.float32) if self.bf16 \
            else out

    def __array__(self, dtype=None, copy=None):
        out = self[...]
        return out if dtype is None else out.astype(dtype)


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


def _write_tensor(path: str, t: torch.Tensor, buf: _Buffer) -> None:
    stored = _np_dtype(t.dtype)
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(f, {
            "descr": np.lib.format.dtype_to_descr(stored),
            "fortran_order": False, "shape": tuple(t.shape)})
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


def _encode(node, path: Tuple[str, ...], stage: str, buf: _Buffer):
    if isinstance(node, torch.Tensor):
        name = ".".join(path) + ".npy"
        _write_tensor(os.path.join(stage, name), node, buf)
        return {"tensor": name, "shape": list(node.shape),
                "dtype": str(node.dtype).removeprefix("torch.")}
    if isinstance(node, dict):
        return {"dict": {str(k): _encode(v, path + (str(k),), stage, buf)
                         for k, v in node.items()}}
    if isinstance(node, (list, tuple)):
        kind = "list" if isinstance(node, list) else "tuple"
        return {kind: [_encode(v, path + (str(i),), stage, buf)
                       for i, v in enumerate(node)]}
    if node is None:
        return None
    if isinstance(node, (int, float)):
        return {"value": node}
    raise TypeError(f"checkpoint payload leaf {'.'.join(path)} is a "
                    f"{type(node).__name__}; payloads hold tensors, numbers, "
                    "None, dicts, lists and tuples")


def save_checkpoint(ckpt_dir, step: int, payload: Any) -> str:
    """Write one checkpoint at ``ckpt_dir/<step>``; returns its path.  A
    checkpoint already at that step is replaced."""
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
                    tuple(node["shape"]), _DTYPES[node["dtype"]])
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
                 buf: _Buffer) -> torch.Tensor:
    if out is None:
        out = torch.empty(leaf.shape, dtype=leaf.dtype, device=device)
    elif tuple(out.shape) != leaf.shape or out.dtype != leaf.dtype \
            or not out.is_contiguous():
        raise ValueError(f"{leaf.file} holds {leaf.shape} {leaf.dtype}; "
                         f"cannot fill a {tuple(out.shape)} {out.dtype} "
                         f"tensor (contiguous: {out.is_contiguous()})")
    with open(leaf.file, "rb", buffering=0) as f:
        read_header = (np.lib.format.read_array_header_1_0
                       if np.lib.format.read_magic(f) == (1, 0)
                       else np.lib.format.read_array_header_2_0)
        shape, fortran, dtype = read_header(f)
        if tuple(shape) != leaf.shape or fortran \
                or dtype != _np_dtype(leaf.dtype):
            raise ValueError(f"{leaf.file}: header {shape} {dtype} does not "
                             f"match the checkpoint's {leaf.shape} "
                             f"{leaf.dtype}")
        flat = _bits(out.reshape(1) if out.dim() == 0 else out)
        for s, e in _chunks(leaf.shape, out.element_size()):
            part = flat[s:e]
            if part.device.type == "cpu":
                _read_exact(f, memoryview(part.numpy()).cast("B"))
            else:
                host = buf.view(part.dtype, tuple(part.shape))
                _read_exact(f, memoryview(host.numpy()).cast("B"))
                part.copy_(host)
    return out


def read_tree(tree, device="cpu", out=None):
    """The payload of an opened checkpoint with every :class:`Leaf` read
    into a new tensor on ``device``, chunk by chunk through one host
    buffer.  With ``out`` (a payload of the same tree) each leaf is read
    into the tensor at its place, in place; a tree that differs (another
    optimizer's state, a missing tensor) raises."""
    buf = _Buffer()
    device = torch.device(device)

    def mismatch(path, what):
        return ValueError(f"checkpoint does not match the state to fill at "
                          f"{'.'.join(map(str, path)) or 'the root'}: "
                          f"{what}")

    def walk(node, into, path):
        strict = out is not None
        if isinstance(node, Leaf):
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
                 max_to_keep: Optional[int] = 3):
        self.ckpt_dir = os.path.abspath(ckpt_dir)
        self.save_interval = int(save_interval)
        self.max_to_keep = max_to_keep
        os.makedirs(self.ckpt_dir, exist_ok=True)

    def save(self, step: int, payload: Any, *, force: bool = False) -> bool:
        """Write the checkpoint of ``step``, then drop the oldest beyond
        ``max_to_keep``.  Every call saves (``force`` is the JAX
        package's argument; its manager saves every step it is given)."""
        del force
        save_checkpoint(self.ckpt_dir, step, payload)
        if self.max_to_keep:
            for old in all_steps(self.ckpt_dir)[:-self.max_to_keep]:
                shutil.rmtree(_step_dir(self.ckpt_dir, old))
        return True

    def maybe_save(self, step: int, payload: Any) -> bool:
        if self.save_interval and step % self.save_interval == 0:
            return self.save(step, payload)
        return False

    def latest_step(self) -> Optional[int]:
        return latest_step(self.ckpt_dir)

    def restore_latest(self, *, device="cpu", out=None):
        """(payload, step) of the newest checkpoint, or None if none
        exists."""
        if self.latest_step() is None:
            return None
        return restore_checkpoint(self.ckpt_dir, device=device, out=out)

    def wait_until_finished(self) -> None:
        """Saves are synchronous: nothing is in flight."""

    def close(self) -> None:
        self.wait_until_finished()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
