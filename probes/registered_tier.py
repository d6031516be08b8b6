"""The host tier in the block PyTorch's pinned allocator gives against the
same tier at its exact size, registered with the card, in turns on one
card: what the exact-size host tier (``parallel/host_tier._host_empty``)
costs the host-tier kernels.

    python3 probes/registered_tier.py        # needs one CUDA card, ~2 min

At the smoke's training shape (Kaggle fs=128 f32 under --hbm-budget-gb 4:
25,529,367 rows of 512 B, 13.07 GB; one batch of 32,768 samples gives
98,304 host ids, 98,117 distinct) three tiers hold the same rows, each
filled from the card in the same order:
  * ``pinned``: ``torch.empty(..., pin_memory=True)`` (a 16 GiB block);
  * ``registered``: ``host_tier._host_empty`` (an anonymous mapping of
    exactly the tier's bytes, registered with cudaHostRegister);
  * ``registered, huge pages advised``: the same mapping with
    ``MADV_HUGEPAGE`` before the registration.
The port's host_gather on the batch's ids, on sequential ids 0..n-1 and
on skewed ids (half from 1,000 hot rows), and host_update_rows on the
distinct ids, each timed with CUDA events (median of 7 windows of 10
calls) in turns: pinned, registered, huge, huge, registered, pinned.  The
three tiers' gathers are checked equal.  Prints a line a case, then the
numbers as one JSON line.
"""

from __future__ import annotations

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
from dlrm_tpu_torch.parallel import host_tier as H  # noqa: E402

DEV = torch.device("cuda:0")


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


def fill(table: torch.Tensor) -> None:
    g = torch.Generator(DEV).manual_seed(5)
    for a in range(0, table.shape[0], 1 << 21):
        c = min(1 << 21, table.shape[0] - a)
        table[a:a + c].copy_(torch.randn((c, table.shape[1]), generator=g,
                                         device=DEV))
    torch.cuda.synchronize()


def huge_registered(shape) -> torch.Tensor:
    """``_host_empty``'s tier with transparent huge pages advised before
    the registration."""
    out, mapping = H._page_aligned_empty(shape, torch.float32)
    mapping.madvise(mmap.MADV_HUGEPAGE)
    ptr = out.untyped_storage().data_ptr()
    H._cuda_host_register(ptr, out.untyped_storage().nbytes())
    mapping.registered = ptr
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("registered_tier: needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    config = kaggle_config(feature_size=128, interaction_impl="fused")
    plan = H.plan_tiers(config, 4 * H.GIB)
    shape = (plan.host_rows, 128)
    tiers = {}
    for name, make in (("pinned", lambda: torch.empty(shape,
                                                      pin_memory=True)),
                       ("registered", lambda: H._host_empty(
                           shape, torch.float32, DEV)),
                       ("registered, huge pages advised",
                        lambda: huge_registered(shape))):
        t0 = time.perf_counter()
        tiers[name] = make()
        alloc = time.perf_counter() - t0
        fill(tiers[name])
        print(f"{name}: {tiers[name].untyped_storage().nbytes()} B, "
              f"allocated in {alloc:.2f} s, is_pinned "
              f"{tiers[name].is_pinned()}")
    batch = next(iter(batch_stream(config, 32768, 1, seed=61)))
    sparse = torch.from_numpy(batch["sparse"]).to(DEV)
    offs = torch.tensor(plan.host_offsets, dtype=sparse.dtype, device=DEV)
    ids = (sparse[:, list(plan.host_tables)] + offs).reshape(-1).int() \
        .contiguous()
    n = ids.numel()
    seq = torch.arange(n, dtype=torch.int32, device=DEV)
    hot = torch.randint(0, 1000, (n // 2,), dtype=torch.int32, device=DEV)
    skewed = torch.cat([hot, ids[n // 2:]])[torch.randperm(n, device=DEV)]
    uniq = torch.unique(ids.long())
    upd = torch.full((uniq.numel(), 128), 1e-30, device=DEV)
    outs = [H.host_gather(t, ids) for t in tiers.values()]
    same = all(torch.equal(outs[0], o) for o in outs[1:])
    print(f"{n} host ids, {uniq.numel()} distinct; the three tiers' gathers "
          f"equal: {same}")
    if not same:
        return 1
    cases = {"gather, the batch's ids": lambda t: H.host_gather(t, ids),
             "gather, sequential ids": lambda t: H.host_gather(t, seq),
             "gather, skewed ids": lambda t: H.host_gather(t, skewed),
             "update, distinct ids": lambda t: H.host_update_rows(
                 t, uniq, upd)}
    order = list(tiers) + list(tiers)[::-1]
    res = {}
    for case, fn in cases.items():
        ms = {name: [] for name in tiers}
        for name in order:
            ms[name].append(tms(lambda: fn(tiers[name])))
        res[case] = ms
        print(f"{case} (ms, in turns "
              f"{' / '.join(n[:10] for n in order)}): " + ", ".join(
                  f"{name} {' / '.join(f'{x:.4f}' for x in v)}"
                  for name, v in ms.items()))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
