"""dlrm_tpu_torch.ops.cuda_build without a CUDA toolkit: a stand-in nvcc
script shows that every source is built once, keyed by a hash of its
source and flags, moved into place whole, and that failures raise."""

import os
import stat
from pathlib import Path

import pytest

from dlrm_tpu_torch.ops import cuda_build

REPO = Path(__file__).resolve().parent.parent
# any loadable shared library stands in for a built kernel
STAND_IN_LIB = REPO / "native" / "libdlrm_data.so"


def _fake_toolkit(tmp_path, monkeypatch, *, fail=False):
    """CUDA_HOME with a bin/nvcc that logs its call and copies a shared
    library to its -o path (or fails); csrc/ and the build dir in tmp."""
    home = tmp_path / "cuda"
    (home / "bin").mkdir(parents=True)
    log = tmp_path / "calls.log"
    nvcc = home / "bin" / "nvcc"
    body = ('echo "nvcc: error" >&2; exit 1' if fail else
            f'out=""; while [ $# -gt 0 ]; do [ "$1" = "-o" ] && out="$2"; '
            f'shift; done; cp "{STAND_IN_LIB}" "$out"')
    nvcc.write_text(f'#!/bin/sh\necho "$@" >> "{log}"\n{body}\n')
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("a", "b"):
        (csrc / f"{name}.cu").write_text(f"// kernel {name}\n")
    monkeypatch.setenv("CUDA_HOME", str(home))
    monkeypatch.setattr(cuda_build, "CSRC", csrc)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    return csrc, log


def test_builds_each_source_once_and_reuses_it(tmp_path, monkeypatch):
    csrc, log = _fake_toolkit(tmp_path, monkeypatch)
    libs = cuda_build.load_kernels.__wrapped__()
    assert sorted(libs) == ["a", "b"]
    calls = log.read_text().splitlines()
    assert len(calls) == 2
    assert all("-gencode=arch=compute_90a,code=sm_90a" in c for c in calls)
    built = sorted(p.name for p in (tmp_path / "build").glob("*.so"))
    assert len(built) == 2 and not list((tmp_path / "build").glob("*.tmp"))
    cuda_build.load_kernels.__wrapped__()          # unchanged: no rebuild
    assert len(log.read_text().splitlines()) == 2
    (csrc / "a.cu").write_text("// kernel a, edited\n")
    cuda_build.load_kernels.__wrapped__()          # edited: one rebuild
    assert len(log.read_text().splitlines()) == 3


def test_failed_build_raises_with_log(tmp_path, monkeypatch):
    _fake_toolkit(tmp_path, monkeypatch, fail=True)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        cuda_build.load_kernels.__wrapped__()
    assert "nvcc: error" in cuda_build.build_log("a")


def test_missing_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "nowhere"))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.nvcc_path()


def test_package_has_the_kernel_source():
    assert (cuda_build.CSRC / "interaction_fwd.cu").is_file()
    assert os.path.basename(cuda_build.BUILD_DIR) == "_build"
