"""ctypes bindings for the native (C++) Criteo data engine: the counterpart
of ``dlrm_tpu/data/native.py``.

The library is built from the repository's ``native/dlrm_data.cpp`` at
first use, with ``g++`` and the flags of ``native/Makefile``, into
``dlrm_tpu_torch/_build/`` (ignored by git).  Its file name carries a hash
of the source and the flags, so an edited source is rebuilt and an
unchanged one reused, and it is linked to a temporary file and renamed, so
a process that has it loaded never sees it rewritten.  The committed
``native/libdlrm_data.so`` is never loaded or rebuilt here.

Without a compiler, or when the build fails (the compiler's message goes to
stderr once), :func:`available` is False and ``data/criteo.py`` takes its
numpy path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import threading
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from dlrm_tpu_torch.data.criteo import DAC_DTYPE

SOURCE = Path(__file__).resolve().parents[2] / "native" / "dlrm_data.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX = "g++"
# native/Makefile's CXXFLAGS and LDFLAGS
CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra")
LDFLAGS = ("-shared", "-pthread")

_lock = threading.Lock()
_state: Dict[str, Optional[ctypes.CDLL]] = {}


def lib_path() -> Path:
    """Where this source and these flags build to."""
    h = hashlib.sha256(SOURCE.read_bytes()
                       + " ".join((CXX,) + CXXFLAGS + LDFLAGS).encode())
    return BUILD_DIR / f"libdlrm_data-{h.hexdigest()[:16]}.so"


def _build(lib: Path) -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    try:
        res = subprocess.run([CXX, *CXXFLAGS, str(SOURCE), "-o", str(tmp),
                              *LDFLAGS], capture_output=True, text=True)
    except FileNotFoundError:
        print(f"native data engine not built: {CXX} not found; the numpy "
              "path is used", file=sys.stderr)
        return False
    if res.returncode != 0:
        print(f"native data engine build failed ({CXX} exited "
              f"{res.returncode}); the numpy path is used:\n{res.stderr}",
              file=sys.stderr)
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, lib)
    return True


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    P, I32, I64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    sig = {
        "dlrm_parse_buffer": (I64, [ctypes.c_char_p, I64, P, I64, I32,
                                    ctypes.POINTER(I64)]),
        "dlrm_marshal_batch": (None, [P, I64, I64, P, P, P, I32]),
        "dlrm_vocab_build": (P, [P, I64, I32]),
        "dlrm_vocab_size": (I64, [P, I32]),
        "dlrm_vocab_export": (None, [P, I32, P]),
        "dlrm_vocab_reindex": (I32, [P, P, I64, I32]),
        "dlrm_vocab_free": (None, [P]),
    }
    for name, (restype, argtypes) in sig.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def _load() -> Optional[ctypes.CDLL]:
    """The bound library, built on the first call; None (after one message
    on stderr) when it cannot be built."""
    with _lock:
        if "lib" not in _state:
            lib = lib_path()
            ok = lib.exists() or _build(lib)
            _state["lib"] = _bind(ctypes.CDLL(str(lib))) if ok else None
        return _state["lib"]


def available() -> bool:
    return _load() is not None


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    return lib


def _check_records(records: np.ndarray) -> None:
    # the C++ side walks len(records) x 160-byte records from the base
    # pointer: another dtype or a strided view would read past the array
    if records.dtype != DAC_DTYPE:
        raise ValueError(f"records must be DAC_DTYPE, got {records.dtype}")
    if not records.flags["C_CONTIGUOUS"]:
        raise ValueError("records must be C-contiguous")


def parse_buffer(text: bytes, num_threads: int = 0) -> np.ndarray:
    """Parse raw Criteo text bytes into a DAC record array (C++ path)."""
    lib = _require()
    if num_threads <= 0:
        num_threads = min(os.cpu_count() or 1, 16)
    capacity = text.count(b"\n") + 2
    out = np.zeros(capacity, dtype=DAC_DTYPE)
    err_off = ctypes.c_int64(-1)
    n = lib.dlrm_parse_buffer(
        text, len(text), out.ctypes.data_as(ctypes.c_void_p), capacity,
        num_threads, ctypes.byref(err_off))
    if n < 0:
        if err_off.value >= 0:
            line_no = text.count(b"\n", 0, err_off.value) + 1
            snippet = text[err_off.value:err_off.value + 80]
            raise ValueError(
                f"native parser: malformed Criteo line {line_no} "
                f"(byte offset {err_off.value} of this chunk): "
                f"{snippet!r}")
        raise ValueError("native parser: malformed Criteo line")
    return out[:n]  # a view: a copy would add a pass over the chunk


def build_vocab_and_reindex(records: np.ndarray, *, reindex: bool = True,
                            num_threads: int = 0) -> List[np.ndarray]:
    """One C++ pass: the 26 columns' values in first-appearance order
    (returned), and with ``reindex`` the categorical columns rewritten in
    place to dense 1-based ids.  ``records`` must be a contiguous DAC
    record array, writable when reindexing."""
    lib = _require()
    _check_records(records)
    if reindex and not records.flags["WRITEABLE"]:
        raise ValueError("records must be writable to reindex in place")
    cpus = os.cpu_count() or 1
    build_threads = num_threads if num_threads > 0 else min(cpus, 26)
    reindex_threads = num_threads if num_threads > 0 else cpus
    n = len(records)
    handle = lib.dlrm_vocab_build(
        records.ctypes.data_as(ctypes.c_void_p), n, build_threads)
    if not handle:
        raise RuntimeError("dlrm_vocab_build returned NULL")
    try:
        appear = []
        for j in range(26):
            out = np.empty(lib.dlrm_vocab_size(handle, j), np.uint32)
            lib.dlrm_vocab_export(handle, j,
                                  out.ctypes.data_as(ctypes.c_void_p))
            appear.append(out)
        if reindex and lib.dlrm_vocab_reindex(
                handle, records.ctypes.data_as(ctypes.c_void_p), n,
                reindex_threads) != 0:
            raise RuntimeError(
                "reindex hit a value missing from the vocabulary; the "
                "records are partially rewritten and must be rebuilt")
    finally:
        lib.dlrm_vocab_free(handle)
    return appear


def marshal_batch(records: np.ndarray, start: int, count: int,
                  id_shift: int = 1) -> Dict[str, np.ndarray]:
    """C++ batch marshal: ``records[start:start+count]`` -> labels (B,)
    f32, dense (B, 13) f32, sparse (B, 26) int32 shifted by ``id_shift``."""
    lib = _require()
    _check_records(records)
    if start < 0 or count < 0 or start + count > len(records):
        raise ValueError(f"marshal_batch range [{start}, {start + count}) "
                         f"outside records[0, {len(records)})")
    labels = np.empty(count, np.float32)
    dense = np.empty((count, 13), np.float32)
    sparse = np.empty((count, 26), np.int32)
    lib.dlrm_marshal_batch(
        records.ctypes.data_as(ctypes.c_void_p), start, count,
        labels.ctypes.data_as(ctypes.c_void_p),
        dense.ctypes.data_as(ctypes.c_void_p),
        sparse.ctypes.data_as(ctypes.c_void_p), id_shift)
    return {"labels": labels, "dense": dense, "sparse": sparse}
