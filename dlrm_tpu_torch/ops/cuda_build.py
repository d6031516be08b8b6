"""Build and load the package's hand-written CUDA kernels.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes``.  Builds
happen at first use, into ``dlrm_tpu_torch/_build/`` (ignored by git), one
``nvcc`` process per source, all started together.  A library's file name
carries a hash of its source and flags, so an edited source is rebuilt and
an unchanged one is reused.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                           "the CUDA kernels are built from csrc/ at first use")
    return found


def _lib_path(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=None)
def load_kernels() -> Dict[str, ctypes.CDLL]:
    """Build every ``csrc/*.cu`` not yet built (in parallel) and load them
    all; returns ``{source stem: CDLL}``.  Raises with nvcc's output when a
    build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    sources = sorted(CSRC.glob("*.cu"))
    procs = []
    for src in sources:
        lib = _lib_path(src)
        if lib.exists():
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((src, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for src, lib, tmp, proc in procs:
        log, _ = proc.communicate()
        (BUILD_DIR / f"{src.stem}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{log}")
            continue
        os.replace(tmp, lib)  # atomic: a concurrent loader never sees half
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {src.stem: ctypes.CDLL(str(_lib_path(src))) for src in sources}


@functools.lru_cache(maxsize=None)
def kernel(stem: str, argtypes: tuple, name: Optional[str] = None):
    """The C entry point ``name`` (default: ``stem``) of ``csrc/<stem>.cu``
    (built at first use), returning a C ``int`` (a CUDA error code)."""
    fn = getattr(load_kernels()[stem], name or stem)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def build_log(stem: str) -> str:
    """nvcc's output (``-Xptxas -v`` register and shared-memory report) for
    the last build of ``csrc/<stem>.cu`` in this build directory."""
    path = BUILD_DIR / f"{stem}.log"
    return path.read_text() if path.exists() else ""
