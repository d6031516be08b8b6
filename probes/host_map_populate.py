"""Where a fresh host tier's draw spends its time: an anonymous mapping of
8 GiB made ready for the card's copies in three ways, in turns (plain,
populated, huge pages advised, populated, plain), each timed host to host.

    python3 probes/host_map_populate.py      # needs one CUDA card, ~25 s

  * ``plain``: ``mmap`` as ``parallel/host_tier._page_aligned_empty`` makes
    it, then ``cudaHostRegister`` (portable | mapped) faults in and pins
    every page;
  * ``populate``: the mapping made with ``MAP_POPULATE`` (every page
    committed by ``mmap``), then registered;
  * ``hugepage``: ``MADV_HUGEPAGE`` advised before the registration.

Then 64 copies of 128 MiB from the card fill it (the draw's shape), and
the same again into pages already present.  Prints the card's name and
power limit, then a line a case: the seconds of the mapping, the
registration, the first copies and the second.
"""

from __future__ import annotations

import ctypes
import mmap
import subprocess
import time

import torch

NBYTES = 8 << 30
CHUNK = 128 << 20
_PORTABLE_MAPPED = 3


def _ready(kind: str) -> tuple:
    """(mapping, its address, seconds of mmap, seconds of registration)."""
    t0 = time.perf_counter()
    if kind == "populate":
        m = mmap.mmap(-1, NBYTES, flags=mmap.MAP_PRIVATE | mmap.MAP_ANONYMOUS
                      | mmap.MAP_POPULATE)
    else:
        m = mmap.mmap(-1, NBYTES)
    if kind == "hugepage":
        m.madvise(mmap.MADV_HUGEPAGE)
    t1 = time.perf_counter()
    ptr = ctypes.addressof(ctypes.c_char.from_buffer(m))
    rc = torch.cuda.cudart().cudaHostRegister(ptr, NBYTES, _PORTABLE_MAPPED)
    if int(rc) != 0:
        raise RuntimeError(f"cudaHostRegister: CUDA error {int(rc)}")
    return m, ptr, t1 - t0, time.perf_counter() - t1


def _fill(host: torch.Tensor, src: torch.Tensor) -> float:
    t0 = time.perf_counter()
    for lo in range(0, NBYTES, CHUNK):
        host[lo:lo + CHUNK].copy_(src)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("host_map_populate: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    src = torch.empty(CHUNK, dtype=torch.uint8, device="cuda")
    for kind in ("plain", "populate", "hugepage", "populate", "plain"):
        m, ptr, map_s, reg_s = _ready(kind)
        host = torch.frombuffer(m, dtype=torch.uint8, count=NBYTES)
        first, again = _fill(host, src), _fill(host, src)
        del host
        torch.cuda.synchronize()
        torch.cuda.cudart().cudaHostUnregister(ptr)
        m.close()
        print(f"{kind}: mmap {map_s:.2f} s, register {reg_s:.2f} s, first "
              f"copies {first:.2f} s, again {again:.2f} s; ready and filled "
              f"in {map_s + reg_s + first:.2f} s", flush=True)


if __name__ == "__main__":
    main()
