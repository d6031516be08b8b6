"""What limits the host-tier kernels on an NVIDIA GPU: reads and writes that
the SMs issue to a pinned host tier mapped into the card's address space.

    python3 probes/host_tier_probe.py        # needs one CUDA card, ~1 min

At the smoke's training shape (Kaggle fs=128 f32 under --hbm-budget-gb 4:
tables 2, 11 and 20, 25,529,367 rows of 512 B, 13.07 GB pinned; one batch
of 32,768 samples gives 98,304 host ids, 98,117 distinct), with CUDA
events, in this order (the host CPU touches no row of the tier before the
timings: a row it has just read or written may be read faster):
  1. the port's host_gather and host_update_rows
     (dlrm_tpu_torch/parallel/host_tier.py) against the first design
     (probes/host_tier_probe.cu, g_first / u_first), in turns;
  2. the port's kernels with the window of rows in flight from 64 KiB to
     1 MiB (host_tier.WINDOW), up and down;
  3. the gather by id order (sequential, uniform, uniform sorted, uniform
     within windows of the tier) and design (the first one; 1 to 16 rows in
     flight a warp; bulk copies through shared memory; the port's);
  4. the update by id order (sequential, sorted, shuffled) and design, and
     writes alone;
  5. the copy-engine route's parts: the host CPU's gather into a pinned
     stage, one copy of the rows each way;
  6. the tier in an anonymous mapping with and without transparent huge
     pages, registered with cudaHostRegister: the gather again.
Each kernel's result is checked bit for bit against index_select on the
host.  Prints a table a section, then all the numbers as one JSON line.
"""

from __future__ import annotations

import ctypes
import json
import mmap
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from dlrm_tpu_torch import kaggle_config  # noqa: E402
from dlrm_tpu_torch.data.synthetic import batch_stream  # noqa: E402
from dlrm_tpu_torch.ops import cuda_build  # noqa: E402
from dlrm_tpu_torch.parallel import host_tier as H  # noqa: E402

DEV = torch.device("cuda:0")
ROW = 512
def tms(fn, reps: int = 7, inner: int = 10) -> float:
    """Median ms a call over ``reps`` windows of ``inner`` calls."""
    for _ in range(3):
        fn()
    out = []
    for _ in range(reps):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        for _ in range(inner):
            fn()
        e.record()
        e.synchronize()
        out.append(s.elapsed_time(e) / inner)
    return statistics.median(out)


def build():
    lib = cuda_build.BUILD_DIR / "libhost_tier_probe.so"
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS[:-2], "-o",
           str(lib), str(Path(__file__).with_suffix(".cu"))]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    cuda_build.load_kernels()
    out = ctypes.CDLL(str(lib))
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    for f in (out.probe_gather, out.probe_update):
        f.argtypes = [p, ll, ll, p, ll, p, i, p]
        f.restype = i
    out.probe_register.argtypes = [p, ll]
    out.probe_unregister.argtypes = [p]
    return out


def fill(table: torch.Tensor) -> None:
    g = torch.Generator(DEV).manual_seed(5)
    for a in range(0, table.shape[0], 1 << 21):
        c = min(1 << 21, table.shape[0] - a)
        table[a:a + c].copy_(torch.randn((c, table.shape[1]), generator=g,
                                         device=DEV))
    torch.cuda.synchronize()


class Tier:
    """A (rows, 128) f32 host tier and its mapped base for the probe's
    kernels."""

    def __init__(self, lib, table: torch.Tensor, base: int):
        self.lib, self.t, self.base = lib, table, base
        self.off = table.data_ptr() - base
        self.rows = table.shape[0]
        self.stream = torch.cuda.current_stream().cuda_stream

    def gather(self, variant: int, ids: torch.Tensor, out: torch.Tensor):
        return lambda: self.lib.probe_gather(
            self.base, self.off, self.rows, ids.data_ptr(), ids.numel(),
            out.data_ptr(), variant, self.stream)

    def update(self, variant: int, ids: torch.Tensor, upd: torch.Tensor):
        return lambda: self.lib.probe_update(
            self.base, self.off, self.rows, ids.data_ptr(), ids.numel(),
            upd.data_ptr(), variant, self.stream)


def gb_s(nbytes: int, ms: float) -> float:
    return nbytes / ms / 1e6


def in_turns(res: dict, tier, ids, uniq) -> None:
    """Section 1: the port's kernels against the first design, in turns
    (first, port, port, first)."""
    n, m = ids.numel(), uniq.numel()
    out = torch.empty((n, 128), device=DEV)
    zeros = torch.zeros((m, 128), device=DEV)
    pooled_ids = ids.view(-1, 3)
    pooled = torch.zeros((pooled_ids.shape[0], 26, 128), device=DEV)
    cols = (2, 11, 20)
    u32 = uniq.int()
    pairs = {
        "gather": (tier.gather(0, ids, out),
                   lambda: H.host_gather(tier.t, pooled_ids, out=pooled,
                                         cols=cols), n),
        "update": (tier.update(0, u32, zeros),
                   lambda: H.host_update_rows(tier.t, uniq, zeros), m)}
    print("1. the port's kernels against the first design, in turns "
          "(first, port, port, first), ms")
    for name, (first, port, rows) in pairs.items():
        t = [tms(first), tms(port), tms(port), tms(first)]
        res[f"turns {name}"] = t
        print(f"   {name}: {t[0]:.4f} {t[1]:.4f} {t[2]:.4f} {t[3]:.4f}; "
              f"port {gb_s(rows * ROW, min(t[1:3])):.1f} GB/s of rows")
    print(f"   the gather's plan (sort and offsets) "
          f"{tms(lambda: H.gather_plan(tier.t, pooled_ids, pooled, cols)):.4f}"
          f" ms of it")
    print("2. the port's kernels by window of rows in flight, ms")
    seq = torch.arange(n, device=DEV)
    keep = H.WINDOW
    for kib in (64, 128, 256, 512, 1024, 512, 256, 128, 64):
        H.WINDOW = kib << 10
        t = [tms(pairs["gather"][1]), tms(lambda: H.host_gather(tier.t, seq)),
             tms(pairs["update"][1])]
        res[f"window {kib} KiB"] = res.get(f"window {kib} KiB",
                                                   []) + [t]
        print(f"   {kib:5d} KiB: gather {t[0]:.4f}, sequential ids "
              f"{t[1]:.4f}, update {t[2]:.4f}", flush=True)
    H.WINDOW = keep


def by_order(res: dict, tier, ids, label: str, windows, variants
             ) -> None:
    """Sections 3 and 6: the gather by id order and design."""
    n = ids.numel()
    out = torch.empty((n, 128), device=DEV)
    orders = {"sequential": torch.arange(n, dtype=torch.int32, device=DEV),
              "uniform": ids, "uniform, sorted": torch.sort(ids).values}
    for w in windows:
        orders[f"uniform within {w >> 20} MB"] = ids % (w // ROW)
    print(f"   {'ids':24s}" + "".join(f"{v:>17s}" for v in variants))
    for oname, oid in orders.items():
        want = tier.t.index_select(0, oid.long().cpu()).to(DEV)
        line = f"   {oname:24s}"
        for vname, v in variants.items():
            out.zero_()
            fn = (lambda: H.host_gather(tier.t, oid, out=None)) if v is None \
                else tier.gather(v, oid, out)
            got = fn()
            torch.cuda.synchronize()
            got = got if v is None else out
            if not isinstance(got, torch.Tensor) or not torch.equal(got,
                                                                     want):
                raise RuntimeError(f"{label} {oname} {vname}: differs")
            ms = tms(fn, reps=5, inner=5)
            res[f"{label} gather {oname} {vname}"] = ms
            line += f"{ms:9.4f} {gb_s(n * ROW, ms):5.1f}".rjust(17)
        print(line, flush=True)


def updates(res: dict, tier, uniq) -> None:
    """Section 4: the update by id order and design, and writes alone."""
    m = uniq.numel()
    zeros = torch.zeros((m, 128), device=DEV)
    orders = {"sequential": torch.arange(m, dtype=torch.int32, device=DEV),
              "distinct, sorted": uniq.int(),
              "distinct, shuffled": uniq[torch.randperm(
                  m, device=DEV)].int().contiguous()}
    variants = {"first design": 0, "1 row a warp": 1, "4 rows a warp": 4,
                "8 rows a warp": 8, "port": None, "writes alone": 204}
    print(f"   {'ids':24s}" + "".join(f"{v:>17s}" for v in variants))
    for oname, oid in orders.items():
        cur = tier.t.index_select(0, oid.long().cpu()).to(DEV)
        line = f"   {oname:24s}"
        for vname, v in variants.items():
            src = cur if v == 204 else zeros
            fn = (lambda: H.host_update_rows(tier.t, oid, zeros)) \
                if v is None else tier.update(v, oid, src)
            ms = tms(fn, reps=5, inner=5)
            res[f"update {oname} {vname}"] = ms
            line += f"{ms:9.4f} {gb_s(m * ROW, ms):5.1f}".rjust(17)
        torch.cuda.synchronize()
        if not torch.equal(tier.t.index_select(0, oid.long().cpu()).to(DEV),
                           cur):
            raise RuntimeError(f"update {oname}: the tier changed")
        print(line, flush=True)


def copy_engine(res: dict, tier, ids) -> None:
    """Section 5: the parts of the copy-engine route."""
    n = ids.numel()
    cpu_ids = ids.long().cpu()
    stage = torch.empty((n, 128), pin_memory=True)
    card = torch.empty((n, 128), device=DEV)
    threads = torch.get_num_threads()
    for th in sorted({threads, 4}):
        torch.set_num_threads(th)
        t = []
        for _ in range(5):
            t0 = time.perf_counter()
            torch.index_select(tier.t, 0, cpu_ids, out=stage)
            t.append((time.perf_counter() - t0) * 1e3)
        res[f"host gather into a pinned stage, {th} threads"] = \
            statistics.median(t)
        print(f"   the host CPU's index_select of the rows into a pinned "
              f"stage, {th} threads: {statistics.median(t):.4f} ms")
    torch.set_num_threads(threads)
    h2d = tms(lambda: card.copy_(stage, non_blocking=True))
    d2h = tms(lambda: stage.copy_(card, non_blocking=True))
    res["copy engine h2d"], res["copy engine d2h"] = h2d, d2h
    print(f"   one copy of the {n * ROW} B of rows: to the card {h2d:.4f} ms "
          f"({gb_s(n * ROW, h2d):.1f} GB/s), from it {d2h:.4f} ms "
          f"({gb_s(n * ROW, d2h):.1f} GB/s)")


def registered(res: dict, lib, rows: int, ids, huge: bool) -> None:
    """Section 6: the tier in an anonymous mapping (huge pages advised, or
    refused), page-locked with cudaHostRegister."""
    nbytes = rows * ROW
    mm = mmap.mmap(-1, nbytes, flags=mmap.MAP_PRIVATE | mmap.MAP_ANONYMOUS)
    mm.madvise(mmap.MADV_HUGEPAGE if huge else mmap.MADV_NOHUGEPAGE)
    raw = torch.frombuffer(mm, dtype=torch.uint8)
    table = raw.view(torch.float32).view(rows, 128)
    fill(table)
    t0 = time.perf_counter()
    rc = lib.probe_register(raw.data_ptr(), nbytes)
    label = "huge pages" if huge else "4 KiB pages"
    print(f"   {label}: cudaHostRegister rc {rc} in "
          f"{time.perf_counter() - t0:.2f} s, is_pinned "
          f"{table.is_pinned() if rc == 0 else None}")
    if rc == 0:
        by_order(res, Tier(lib, table, raw.data_ptr()), ids, label,
                 (512 << 20, 4 << 30), {"first design": 0, "port": None})
        torch.cuda.synchronize()
        lib.probe_unregister(raw.data_ptr())
    del table, raw
    mm.close()


def main() -> int:
    if not torch.cuda.is_available():
        print("host_tier_probe: needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    lib = build()
    config = kaggle_config(feature_size=128, interaction_impl="fused")
    plan = H.plan_tiers(config, 4 * H.GIB)
    rows = plan.host_rows
    t0 = time.perf_counter()
    table = torch.empty((rows, 128), pin_memory=True)
    fill(table)
    print(f"{rows} rows x {ROW} B pinned and filled in "
          f"{time.perf_counter() - t0:.2f} s")
    batch = next(iter(batch_stream(config, 32768, 1, seed=61)))
    sparse = torch.from_numpy(batch["sparse"]).to(DEV)
    offs = torch.tensor(plan.host_offsets, dtype=sparse.dtype, device=DEV)
    ids = (sparse[:, list(plan.host_tables)] + offs).reshape(-1).int() \
        .contiguous()
    uniq = torch.unique(ids.long())
    print(f"{ids.numel()} host ids, {uniq.numel()} distinct; ms and GB/s "
          f"of rows a call")
    tier = Tier(lib, table, table.untyped_storage().data_ptr())
    res: dict = {}
    in_turns(res, tier, ids, uniq)
    print("3. the gather by id order and design, ms and GB/s")
    by_order(res, tier, ids, "pinned", (64 << 20, 512 << 20, 1 << 30,
                                         4 << 30),
             {"first design": 0, "1 row a warp": 1, "4 rows a warp": 4,
              "8 rows a warp": 8, "16 rows a warp": 16, "bulk, 2 stages": 102,
              "bulk, 8 stages": 108, "port": None})
    print("4. the update by id order and design (each row read and written)")
    updates(res, tier, uniq)
    print("5. the copy-engine route's parts")
    copy_engine(res, tier, ids)
    del tier, table
    torch.cuda.synchronize()
    torch._C._host_emptyCache()
    print("6. the tier page-locked by cudaHostRegister")
    for huge in (True, False):
        registered(res, lib, rows, ids, huge)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
