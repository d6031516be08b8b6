"""Smoke run of dlrm_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero, printing no
result):
  1. the card (nvidia-smi name and power limit) and the kernel build;
  2. the dense Adagrad kernel (one launch over every dense leaf) against
     the per-leaf loop, bit for bit, on the Kaggle fs=128 model's 16 f32
     leaves (three steps from zero accumulators), on gradients that are
     views of one flat buffer (aligned, and 4 bytes off), on 70 leaves (two
     launches); bf16 leaves keep the loop; the `dense_apply.launches`
     counter; its device time beside its bound and the loop's, after an L2
     flush, and the host's time a call of each;
     then every other hand-written kernel against its plain torch version,
     at the main paths' shapes (D=128, and Terabyte's D=32 and D=64) and
     at ragged / padded ones, f32 and bf16,
     on the two sources (x, feats) the model hands over, timed with CUDA
     events; both interaction kernels on the stacked T's views give the
     same bits, and take their bulk-copy paths wherever the rows allow it;
     the fused interaction's autograd gradient against autograd through
     the gram interaction; the backward with its cotangent a view 4 bytes
     into its storage, ending at the storage's last byte, with a ragged
     last group;
  3. serving: Kaggle fs=128 at full width (26 tables, 33.76 M rows x 128 in
     f32, random weights from a seed) scoring batches of 16384 through the
     scoring function of `predict`, with the kernels' launch counts (and
     the interaction kernels' bulk-copy launches) read around it, then a
     `torch.profiler` breakdown of a served batch that must show no cat
     and no full-size copy of the pooled rows;
  4. training: the same model, 8 exact-SGD steps at B=32768 through
     `dlrm_tpu_torch.train`, launch counts read around them; 4 steps from a
     copy of the same start under the gram interaction give the same
     losses, dense parameters and touched table rows; then the step time
     under fused and gram in turns, and a `torch.profiler` breakdown of
     the fused step by kernel group with the device's idle share, which
     must show no cat and no full-size copy of the embedding gradient;
  5. evaluation: the same model, `evaluate` over 8 batches of 16384 and a
     ragged one of 107, against the metrics of `score_batch`'s scores;
  6. the sharded path at full width under NCCL at world size 1, in this
     process: the placement (tables 2, 11 and 20 row-sharded, 15
     column-sharded, 22 in slots) laid out on the card; the sharded lookup
     against the plain one at B=16384 (f32 within 1e-6; the bf16 exchange
     the f32 lookup rounded once); sharded serving against `forward` and
     timed against it in turns; `sharded_evaluate` against `evaluate` with
     a ragged tail; one sharded SGD step at B=32768 against `train_step`
     from one state under deterministic sums, bit for bit (loss, every
     row through `unshard_tables` with the touched slot, row-sharded and
     column-sharded rows each seen to move, dense parameters, the trash
     row); the two steps'
     times in turns and device peaks, and a profile of the sharded step
     with NCCL's kernels and the time under each exchange scope; one more
     step under the collective counter (`parallel/audit.py`): every
     collective it issued (op, dtype, payload bytes) printed beside the
     profile's NCCL kernel and device-to-device copy times, and held to
     what the placement says a step issues at world size 1;
  7. the sharded optimizers at full width under NCCL at world size 1:
     row-wise Adagrad on phase 6's placement, one step from warm
     accumulators against `train_step_opt` from one state under
     deterministic sums, bit for bit (every kind of touched row and its
     accumulator seen to move, loss, dense parameters and accumulators,
     trash rows 0), a K=1 block bit for bit against the step, step times
     and device peaks in turns, a profile (the column shard's update
     beside the bytes its dense form would move), K=4 blocks against 4
     steps in turns, the
     replica check (`make_dcn_replica_check` on a 1 x 1 2-D mesh) over the
     17.29 GB; then elementwise Adagrad with tables 2, 11 and 20 (13.07 GB,
     and their accumulators) in registered host memory and table 3
     row-sharded on the card: the lookup with host rows against the plain
     one, one step against `train_step_opt` as above (slot, row-sharded,
     host row-sharded and column-sharded rows), times and peaks in turns, a
     profile (the host-tier kernels, NCCL, dedup, idle share), the replica
     check with the host stack passing through the card;
  8. the sharded CLI at full width under NCCL at world size 1, through
     `python -m dlrm_tpu_torch` subprocesses held against the same work in
     this process: `train --sharded true` (row-wise Adagrad, tables 2, 11
     and 20 row-sharded, 15 column-sharded) for 2 steps and a resume to 4
     against 4 sharded steps from the same draw, the checkpoint's
     placement; the checkpoint restored in process (GB/s); `eval
     --ckpt-dir` on the mesh and unsharded against `sharded_evaluate`;
     `predict --sharded true` in f32 and int8 against sharded serving on
     the same codes, the int8 serving's device peak; `train --distributed
     --mesh-shape 1x1 --paranoid 1 --host-tables 2,11,20 --exchange-dtype
     bf16`: the replica check's lines and the host tier's exact size; each
     process's wall time and peak resident set, the save and restore
     rates;
  9. the optimizers at full width: 4 Adagrad and 4 row-wise Adagrad steps at
     B=32768 with a step of each held against the plain formula on the rows
     it touched, row-wise fused against gram from a clone, a clipped SGD
     step, K=4 blocks of each optimizer against 4 sequential steps, then
     the step times of the three optimizers at K=1 and K=4 in turns, a
     `torch.profiler` breakdown of the Adagrad step and the time of an
     `evaluate` batch;
 10. checkpoints at full width: row-wise Adagrad at B=32768, 2 steps, a
     save through `CheckpointManager`, 2 more steps, a restore (the page
     cache dropped where the kernel shows it dropped) into the same tensors,
     which must give back the whole saved state, and the same 2 steps
     again, all under deterministic sums: the same loss bits and the same
     bits of every tensor; bytes, seconds, GB/s and the host's peak
     resident set of the save and of the restore;
 11. telemetry at full width: the instrumented SGD step against
     `train_step` from the same state (1e-5), the ms of every phase beside
     the unprofiled step, and the CUDA time under each phase scope of a
     profiled step;
 12. int8 serving at full width: the serving phase's tables (the same
     seed) quantized on the card, codes and scales held bit for bit to the
     host quantizer on the first and last 4096 rows of every table, the
     footprint read; 8 batches of 16384 through `score_batch` on the int8
     tables (launch counts read around them), held to the f32 scores
     within 5e-3; int8 against f32 serving times in turns, a
     `torch.profiler` breakdown of an int8 batch, and `predict
     --quantize-tables int8` in a subprocess against the port in process;
 13. data: Criteo text written from a seed at the full Kaggle table sizes,
     `python -m dlrm_tpu_torch preprocess` (the native engine) against the
     numpy path byte for byte, `train --data --validate-data --prefetch 2`
     at full width in a subprocess against the same steps in process with
     plain copies (and through `device_prefetch`, launch counts read
     around both), `--validate-data` refusing a file that does not fit
     the tables, then the SGD step fed from `DACLoader` through
     `device_prefetch` and through plain copies, in turns, and a profile of
     each (host-to-device copy time, its stream, idle share);
 14. two-tier tables at full width (Kaggle fs=128 f32 under
     `--hbm-budget-gb 4`: tables 2, 11 and 20, 13.07 GB, in host memory
     registered with the card at its exact size, which is checked, the
     budget checked against MemAvailable): the host-tier
     kernels timed with their bounds (before the host CPU touches a row),
     with sequential, skewed and pre-sorted ids and an update on shuffled
     ids read beside them, then against their plain versions bit for bit
     (the gather into the pooled columns of a training batch, int64 ids,
     skewed ids, ids unsorted and sorted beforehand, edge rows, bf16, width
     1; the update on sorted and shuffled distinct rows, edge rows, bf16,
     width 1); 8 two-tier SGD steps, 4 Adagrad and 4 row-wise Adagrad from
     warm accumulators, each against the all-device steps from one state
     under deterministic sums (1e-5); K=4 two-tier blocks against 4 steps;
     pipelined against inline under deterministic sums (equal bits); the
     device peaks of both steps, step times in turns, a profile (the
     host-tier kernels named, no cat, no pooled-size copy); `train
     --hbm-budget-gb 4` (row-wise Adagrad, a resume), `eval --ckpt-dir` on
     its checkpoint and `train --hbm-budget-gb 4 --host-prefetch` in
     subprocesses against the same work in process, with peak VmRSS;
 15. small inputs: the forward, and 3 training steps, on the card against
     the same on the CPU for every interaction, f32, bf16 and multi-hot;
     3 steps and a K=3 block of every optimizer likewise;
 16. the entry points: `python -m dlrm_tpu_torch predict`, `train` and
     `eval` in subprocesses on the card, held against the port in
     process; `train --ckpt-dir` and its resume, `eval --ckpt-dir`,
     `export --quantize int8` with `predict --ckpt-dir` on the artifact
     likewise, at the tiny config's widths (scheduled SGD) and at full
     width (Kaggle fs=128, row-wise Adagrad, B=32768), each full-width
     process's peak resident set read and bounded far below the tables'
     bytes; `instrument`, `train --profile-dir` and `bench` at full width;
 17. the time-to-AUC curve's first leg (`make_auc_curve_torch.curve`) at
     Kaggle fs=128 full width: bf16 tables, row-wise Adagrad, fused,
     B=32768 on the planted-truth task, 150 steps, evaluated at steps 0
     and 150 over 4 batches, launch counts read around it; the AUC at 150
     within 0.01 of the committed `AUC_CURVE_fs128.json` and 0.25 above
     the start;
 18. the Criteo Terabyte model with its tables beyond the card (fs=32,
     f32, fused, `--hbm-budget-gb 64`: 112.99 GB of tables, tables 0 and
     19, 66.61 GB, in host memory registered at its exact size; the
     host's MemAvailable checked first, with no smaller fallback): the
     draw straight into the tiers (seconds, resident-set growth equal to
     the registered bytes, device peak), the host-tier kernels timed at a
     training batch's host ids against their plain versions and bounds,
     and held against them there bit for bit (a random update to the
     batch's host rows, put back after), an SGD step, a row-wise Adagrad
     step and a K=4 row-wise block, each held against the touched-rows
     model (the touched rows of both tiers gathered into a compact
     single-device model in which every table keeps its treatment --
     updated every micro-step or at a block's end -- run by the port's
     single-device steps: 1e-5, accumulators 1e-6, and each tier tensor's
     change against the reference's change, beyond one f32 ulp a rewrite,
     within 1e-3 of its norm, a block's 1e-2) and the XOR identity over
     every whole tier (nothing else
     moved), serving at B=16384 and evaluation through TieredEmb against
     the same model, step times, fused against gram at fs=32 in turns, a
     profile; the free disk a checkpoint would use beside what a save
     needs (nothing saved); then the model at fs=64 with bf16 tables drawn
     into the same two allocations (its plan has their bytes; nothing is
     registered again), an SGD step and a row-wise Adagrad step against
     the touched-rows model in its bf16 form (one bf16 ulp a rewrite) with
     the XOR identity, serving, evaluation, step times and a profile that
     names the pooled rows' cast; the tiers released (the host tier's
     mapping unregistered once, when its last view dies), then `train
     --config terabyte --feature-size 32 --hbm-budget-gb 64` in a
     subprocess, its loss lines against the same two steps in process, and,
     once the host's MemAvailable is back, `train --sharded true
     --host-tables 0,19` (the host stack of 66.6 GB in registered host
     memory) against it, each one's resident set sampled, draw and wall
     seconds printed;
 19. a `{"kernels": [...]}` line (the two interaction kernels and the two
     host-tier kernels), then the result line.
Where a phase runs CLI subprocesses that depend on none of each other's
results, some run together, beside the work in process they are held to
(each phase's docstring says which), so that the whole run keeps inside
its time limit; their wall times are then times beside one another.
It needs a CUDA device and the repository around it; without either it
fails.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
DEV = torch.device("cuda:0")
BATCH = 16384          # serving batch
TRAIN_BATCH = 32768    # the reference experiment's training batch
CLIP_BATCH = 8192      # below every big Kaggle table's rows: ids need not repeat
MAIN_BATCHES = 8
TRAIN_STEPS = 8
OPT_STEPS = 4
BLOCK = 4
TABLES = (5, 300, 17, 2000, 3, 60) * 4 + (9, 700)  # 26 small tables
OPTIMIZERS = ("sgd", "adagrad", "rowwise_adagrad")
KEYS = ("dense", "sparse", "labels")
# published peaks of one H100 SXM: HBM3 bytes/s, f32 FLOP/s outside the
# tensor cores (both kernels multiply in f32 FMAs)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# the card's host link, PCIe Gen5 x16: 128 GB/s both ways together on the
# H100 data sheet, so 64 GB/s each way; it bounds the host-tier kernels
PCIE_BYTES_PER_S = 64e9
# launches of [interaction_fwd, interaction_bwd, host_gather,
# host_update_rows, dense_adagrad, sparse_adagrad] summed over the main
# paths
LAUNCHES = [0, 0, 0, 0, 0, 0]


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def time_ms(fn, warmup: int = 3, reps: int = 7, inner: int = 10) -> list:
    """Per-call times (ms) of ``fn`` from CUDA events, ``reps`` windows of
    ``inner`` calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / inner)
    return out


def timed_pair(kernel, plain):
    """(kernel ms, plain ms): medians over windows taken in turns (plain,
    kernel, kernel, plain) within this call."""
    p = time_ms(plain)
    k = time_ms(kernel)
    k += time_ms(kernel)
    p += time_ms(plain)
    return statistics.median(k), statistics.median(p)


def phase_card():
    from dlrm_tpu_torch.ops import cuda_build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device 0: {torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} visible")
    t0 = time.perf_counter()
    cuda_build.load_kernels()
    print(f"kernel build + load: {time.perf_counter() - t0:.2f} s")
    for stem in ("interaction_fwd", "interaction_bwd", "host_tier",
                 "dense_adagrad", "sparse_adagrad"):
        for line in cuda_build.build_log(stem).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {stem}:", line.strip())
    from dlrm_tpu_torch.parallel.host_tier import device_attrs
    print(f"the card and host memory: {device_attrs(DEV)} (no native "
          f"atomics to host memory: the host-tier update takes distinct "
          f"rows)")


def _bound(kname: str, inputs: list, outputs: list, b: int, f: int,
           d: int) -> dict:
    """The least time the card could take for one call: every input read
    once and every output written once at the HBM rate, against the f32
    multiply-adds the function needs at the f32 peak.  Forward: the P pair
    dots of D products per sample.  Backward: dT = (dZ + dZ^T) T, F * F * D
    products per sample; of its cotangent the caller passes only the D + P
    columns the function reads (not the padding).  The byte count does not
    depend on how the inputs are laid out (one T, or x and feats apart)."""
    nbytes = sum(x.numel() * x.element_size() for x in inputs + outputs)
    flops = 2 * b * d * (f * (f - 1) // 2 if kname == "interaction_fwd"
                         else f * f)
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return {"bound_ms": max(by_bytes, by_ops) * 1e3,
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bytes": nbytes, "flops": flops}


def _fwd_views_agree(F, t, pad_to: int, out) -> bool:
    """Checks that the forward on the T-view form (t[:, 0], t[:, 1:])
    gives the bits of the two-source form's ``out``; returns whether that
    launch took the bulk-copy path."""
    before = F.interaction_fwd.bulk_launches
    tview = F.interaction_fwd(t[:, 0], t[:, 1:], pad_to)
    torch.cuda.synchronize()
    check(torch.equal(tview, out), f"interaction_fwd: T-view and two-source "
          f"forms differ at {tuple(t.shape)} {t.dtype}")
    return F.interaction_fwd.bulk_launches > before


def _bwd_views_agree(F, t, cot, got) -> bool:
    """Checks that the backward on the T-view form (t[:, 0], t[:, 1:], dT
    written through dt[:, 0] and dt[:, 1:], sample stride F * D) gives the
    bits of the two-source form's dT ``got``; returns whether that launch
    took the bulk-copy path."""
    before = F.interaction_bwd.bulk_launches
    dt = torch.full_like(t, float("nan"))
    F.interaction_bwd(cot, t[:, 0], t[:, 1:], out=(dt[:, 0], dt[:, 1:]))
    torch.cuda.synchronize()
    check(torch.equal(dt, got), f"interaction_bwd: T-view and two-source "
          f"forms differ at {tuple(t.shape)} {t.dtype}")
    return F.interaction_bwd.bulk_launches > before


def _bwd_g_views(F) -> None:
    """The backward with its cotangent g a view that starts 4 bytes into
    its storage and ends at the storage's last byte, so that no row of g is
    16-byte aligned where the batch's rows are: every group's g run is
    staged in place (its aligned inside by a bulk copy, its head and tail
    by plain loads), and the last group's run ends at g's last byte.  At
    (16384, 27, 128), at Terabyte's D=32 with a batch of 32767 (the last
    group ragged, 3 of 4 samples) and at (107, 27, 128) (the last group 1
    of 2); f32 and bf16, against the plain version and the T-view form."""
    g = torch.Generator(DEV).manual_seed(1)
    for b, f, d in [(BATCH, 27, 128), (TRAIN_BATCH - 1, 27, TB_FEATURE),
                    (107, 27, 128)]:
        for dtype in (torch.float32, torch.bfloat16):
            t = torch.randn((b, f, d), generator=g, device=DEV).to(dtype)
            x, feats = t[:, 0].contiguous(), t[:, 1:].contiguous()
            w = F.output_width(f, d, 1)
            skip = 4 // t.element_size()
            storage = torch.randn((skip + b * w,), generator=g, device=DEV
                                  ).to(dtype)
            cot = storage[skip:].view(b, w)
            check(cot.data_ptr() - storage.data_ptr() == 4,
                  "g view offset")
            got = torch.cat([y.reshape(b, -1, d) for y in
                             F.interaction_bwd(cot, x, feats)], 1)
            ref = torch.cat([y.reshape(b, -1, d) for y in
                             F.fused_interaction_bwd_reference(cot, x,
                                                               feats)], 1)
            torch.cuda.synchronize()
            rtol = 1e-5 if dtype == torch.float32 else 1e-2
            torch.testing.assert_close(got.float(), ref.float(), atol=1e-4,
                                       rtol=rtol)
            check(_bwd_views_agree(F, t, cot, got),
                  f"interaction_bwd at {(b, f, d)} {dtype}: not bulk")
            err = (got.float() - ref.float()).abs().max().item()
            print(f"  interaction_bwd ({b}, {f}, {d}, 1, {dtype}) with g "
                  f"4 bytes into its storage, ending at its last byte: "
                  f"{err:.3g}")


def _cold_ms(fn, reps: int = 21) -> list:
    """Per-call device times (ms) of ``fn`` from CUDA events, each call
    after a 256 MB write that evicts the 50 MB L2, as a step finds the
    dense leaves (written long before, by the optimizer's last call).  The
    card first sleeps while the host enqueues every call, so the times are
    the card's work alone, not the host's pace of launching it."""
    flush = torch.empty(64 << 20, device=DEV)
    fn()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    for start, end in events:
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return [start.elapsed_time(end) for start, end in events]


def _host_us(fn, reps: int = 200) -> float:
    """Median host microseconds of a call of ``fn`` (its Python and its
    launches; the card may still be busy when it returns)."""
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e6)
        if len(out) % 20 == 0:
            torch.cuda.synchronize()
    torch.cuda.synchronize()
    return statistics.median(out)


def _ulps(a: list, b: list) -> int:
    """The largest distance in f32 ulps between two lists of tensors
    (values of one sign)."""
    return max(int((x.view(torch.int32).long() - y.view(torch.int32).long())
                   .abs().max()) for x, y in zip(a, b))


def dense_adagrad_kernel() -> dict:
    """The dense Adagrad kernel (``csrc/dense_adagrad.cu``) against the
    per-leaf loop (``optim.dense_adagrad_reference``) on the card, bit for
    bit: the Kaggle fs=128 model's 16 dense leaves (the MLPerf towers,
    2,368,897 f32 parameters), three steps from zero accumulators on
    gradients with zeros, values below sqrt(eps) and normal ones; the same
    on gradients that are views of one flat buffer as the sharded step
    gives them, aligned and 4 bytes off (every leaf element by element); 70
    leaves (two launches a step).  bf16 leaves keep the loop; the counter
    ``dense_apply.launches`` reads 1 for the kernel, 160 for the loop.  Then
    the kernel's device time beside its bound (20 bytes a parameter at the
    HBM rate) and the loop's, each call after an L2 flush, in turns, and
    the host's time a call of each."""
    from dlrm_tpu_torch import kaggle_config
    from dlrm_tpu_torch.models.dlrm import init_dense
    from dlrm_tpu_torch.ops import cuda_build
    from dlrm_tpu_torch.ops.embedding import tree_leaves
    from dlrm_tpu_torch.train import optim as O
    from dlrm_tpu_torch.utils import telemetry

    for line in cuda_build.build_log("dense_adagrad").splitlines():
        if "registers" in line or "spill" in line or "bytes cmem" in line:
            print("  ptxas dense_adagrad:", line.strip())
    gen = torch.Generator(DEV).manual_seed(5)
    params = tree_leaves(init_dense(gen, kaggle_config(feature_size=128),
                                    DEV))
    numels = [p.numel() for p in params]
    n = sum(numels)
    check(len(params) == 16 and n == 2_368_897,
          f"dense leaves: {len(params)}, {n} parameters")
    lr = 0.001

    def grads(leaves, steps: int = 3) -> list:
        scales = torch.tensor([0.0, 1e-7, 1e-3, 1.0], device=DEV)
        return [[torch.randn(p.shape, generator=gen, device=DEV)
                 * scales[torch.randint(0, 4, p.shape, generator=gen,
                                        device=DEV)]
                 for p in leaves] for _ in range(steps)]

    def run(fn, leaves, steps) -> list:
        p = [x.clone() for x in leaves]
        acc = [torch.zeros_like(x) for x in leaves]
        for g in steps:
            fn(p, g, acc, lr)
        torch.cuda.synchronize()
        return p + acc

    def agree(what: str, leaves, steps, launches: int) -> None:
        before = O.dense_adagrad.launches
        got = run(O.dense_adagrad, leaves, steps)
        check(O.dense_adagrad.launches - before == launches * len(steps),
              f"dense_adagrad {what}: "
              f"{O.dense_adagrad.launches - before} launches")
        want = run(O.dense_adagrad_reference, leaves, steps)
        ulps = _ulps(got, want)
        moved = max((a - b).abs().max().item()
                    for a, b in zip(got, leaves))
        check(ulps == 0 and moved > 0, f"dense_adagrad {what}: "
              f"{ulps} ulps from the per-leaf loop (moved {moved:.3g})")
        print(f"  dense_adagrad {what}: the loop's bits after "
              f"{len(steps)} steps ({launches} launch(es) a step; weights "
              f"moved up to {moved:.3g})")

    steps = grads(params)
    agree("16 leaves", params, steps, 1)
    # the sharded step's gradients: views of one flat buffer with the loss
    # after them (train._dense_apply), and the same 4 bytes into it
    for skip in (0, 1):
        flats = [torch.cat([torch.zeros(skip, device=DEV)]
                           + [g.reshape(-1) for g in step]
                           + [torch.zeros(1, device=DEV)]) for step in steps]
        views = [[v.view_as(p) for v, p in zip(
            torch.split(flat[skip:skip + n], numels), params)]
            for flat in flats]
        # every view 16-byte aligned (the leaves' lengths are multiples of
        # 4 floats but the last); 4 bytes in, none is
        odd = sum(g.data_ptr() % 16 != 0 for g in views[0])
        check(odd == 16 * skip, f"flat views {skip * 4} bytes in: {odd} "
              f"of 16 off 16 bytes")
        agree(f"on flat views {skip * 4} bytes into their buffer",
              params, views, 1)
    many = [torch.randn(int(k), generator=gen, device=DEV) for k in
            torch.randint(1, 9000, (70,), generator=gen,
                          device=DEV).tolist()]
    agree("70 leaves", many, grads(many), 2)

    half = [p.bfloat16() for p in params]
    before = O.dense_adagrad.launches
    got = run(functools.partial(O.apply_dense, "adagrad"), half,
              [[g.bfloat16() for g in s] for s in steps])
    want = run(O.dense_adagrad_reference, half,
               [[g.bfloat16() for g in s] for s in steps])
    check(O.dense_adagrad.launches == before and
          all(torch.equal(a, b) for a, b in zip(got, want)),
          "bf16 dense leaves: not the per-leaf loop's bits")
    counts = {}
    for what, opt, leaves in (("f32", "adagrad", params),
                              ("bf16", "adagrad", half),
                              ("sgd", "sgd", params)):
        p = [x.clone() for x in leaves]
        acc = [torch.zeros_like(x) for x in leaves]
        telemetry.reset_counters()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            O.apply_dense(opt, p, [g.to(x.dtype) for g, x in
                                   zip(steps[0], leaves)], acc, lr)
        counts[what] = telemetry.counters().get("dense_apply.launches")
    telemetry.reset_counters()
    check(counts == {"f32": 1, "bf16": 160, "sgd": 32},
          f"dense_apply.launches: {counts}")
    print(f"  dense_apply.launches under a profiler: {counts}")

    p = [x.clone() for x in params]
    acc = [torch.zeros_like(x) for x in params]
    p2 = [x.clone() for x in params]
    acc2 = [torch.zeros_like(x) for x in params]

    def kern():
        O.dense_adagrad(p, steps[0], acc, lr)

    def plain():
        O.dense_adagrad_reference(p2, steps[0], acc2, lr)

    # the loop: 5 calls (800 launches) a window, so that the launches wait
    # in the card's queue behind the sleep; a fuller queue blocks the host,
    # whose pace would then be timed again
    plain_ms = _cold_ms(plain, 5)
    ms = _cold_ms(kern)
    ms += _cold_ms(kern)
    plain_ms += _cold_ms(plain, 5)
    ms, plain_ms = statistics.median(ms), statistics.median(plain_ms)
    host_us, plain_host_us = _host_us(kern), _host_us(plain)
    nbytes = 20 * n
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"  dense_adagrad, 16 leaves, {n} f32 parameters, device time "
          f"after an L2 flush: kernel {ms:.4f} ms ({bound_ms / ms:.0%} of "
          f"the {bound_ms:.4f} ms bound, {nbytes / 1e6:.1f} MB), per-leaf "
          f"loop {plain_ms:.4f} ms; host time a call: {host_us:.1f} / "
          f"{plain_host_us:.1f} us")
    return {"dense_adagrad": {
        "max_ulps": 0, "ms": ms, "plain_ms": plain_ms, "host_us": host_us,
        "plain_host_us": plain_host_us, "bound_ms": bound_ms,
        "bound_by": "bytes", "bytes": nbytes,
        # no single PyTorch call computes optax's rsqrt(acc + eps) with
        # its zero rule
        "library_ms": None}}


def _zipf_hits(gen: np.random.Generator, sizes, batch: int,
               dtype=torch.int32) -> torch.Tensor:
    """One batch's stacked ids on the card, (B * T,) in (B, T) order: each
    table's Zipf(1.2) ranks clipped to its rows, plus its offset."""
    offs = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    ids = np.minimum(gen.zipf(1.2, (batch, len(sizes))) - 1,
                     np.asarray(sizes) - 1) + offs
    return torch.from_numpy(ids.reshape(-1)).to(DEV, dtype)


def _sorted_update_agrees(what: str, emb, acc, ids, rows, lr) -> dict:
    """The sorted segment sum (``optim.apply_sorted_rowwise``) against
    today's split-free dedup and apply (``optim.apply_sparse_adagrad``)
    and the plain version on the rows ``ids`` touch, each from the same
    state (touched rows saved and put back): the kernel twice to the bit,
    nothing else moved, and the largest differences of the touched rows
    and their accumulators."""
    from dlrm_tpu_torch.ops import embedding as E
    from dlrm_tpu_torch.train import optim as O

    touched = torch.unique(ids.long())
    e0, a0 = emb[touched].clone(), acc[touched].clone()
    grad = E.SparseGrad(ids, rows)

    def run(fn) -> tuple:
        emb[touched], acc[touched] = e0, a0
        fn()
        torch.cuda.synchronize()
        return emb[touched].clone(), acc[touched].clone()

    before = E.sorted_rowwise_adagrad.launches
    kern = run(lambda: O.apply_sorted_rowwise(emb, acc, grad, lr))
    again = run(lambda: O.apply_sorted_rowwise(emb, acc, grad, lr))
    check(E.sorted_rowwise_adagrad.launches - before == 2,
          f"sparse_adagrad {what}: "
          f"{E.sorted_rowwise_adagrad.launches - before} launches, not 2")
    check(torch.equal(kern[0], again[0]) and torch.equal(kern[1], again[1]),
          f"sparse_adagrad {what}: two runs differ")
    today = run(lambda: O.apply_sparse_adagrad(emb, acc, grad, lr,
                                               rowwise=True))
    plain = run(lambda: E.sorted_rowwise_adagrad_reference(
        emb, acc, E.sort_hits(ids), rows, lr))
    emb[touched], acc[touched] = e0, a0
    step = (today[0] - e0).abs().max().item()
    scale = e0.abs().max().item()
    out = {"hits": ids.numel(), "distinct": touched.numel(), "step": step}
    for name, (e, a) in (("today", today), ("plain", plain)):
        out[f"emb_vs_{name}"] = (kern[0] - e).abs().max().item()
        out[f"acc_vs_{name}"] = ((kern[1] - a).abs()
                                 / a.abs().clamp(min=1e-30)).max().item()
        # the hits of a row are summed in another order: f32 rounding of
        # the row's sum (relative ~1e-6 at 24,000 hits), carried into its
        # step and its accumulator
        # and one rounding of the weight's subtraction
        check(out[f"acc_vs_{name}"] <= 1e-5
              and out[f"emb_vs_{name}"] <= 1e-4 * step + 2.5e-7 * scale,
              f"sparse_adagrad {what} vs {name}: {out}")
    print(f"  sparse_adagrad {what}: {out['hits']} hits of "
          f"{out['distinct']} rows, the same bits twice; vs today's path "
          f"tables {out['emb_vs_today']:.3g} (steps up to {step:.3g}), "
          f"accumulators {out['acc_vs_today']:.3g} relative; vs the plain "
          f"version {out['emb_vs_plain']:.3g} / {out['acc_vs_plain']:.3g}")
    return out


def sparse_adagrad_kernel() -> dict:
    """The sorted segment sum (``csrc/sparse_adagrad.cu``) on the card: at
    the Kaggle cell's shapes (B=32768 x 26 tables of the full Kaggle stack,
    Zipf(1.2) ids, f32, D=128, int32 ids) against today's path
    (``optim.apply_sparse_adagrad``) and the plain version, bit for bit
    from run to run, with nothing outside the touched rows moved; the same
    at D=32 with int64 ids (the Terabyte model's width), D=256, D=6 (single
    floats) and one hit; given distinct ids, the update of
    ``optim.apply_adagrad_rows`` to the bit wherever the D-term sum of
    squares came out the same.  Then the times after an L2 flush of the
    sort, the kernel, both, today's path (its two syncs' idle included) and
    the plain version, beside the bound: the per-hit rows and ids read
    once, each distinct row and accumulator read and written once."""
    from dlrm_tpu_torch import kaggle_config
    from dlrm_tpu_torch.ops import cuda_build
    from dlrm_tpu_torch.ops import embedding as E
    from dlrm_tpu_torch.train import optim as O

    for line in cuda_build.build_log("sparse_adagrad").splitlines():
        if "registers" in line or "spill" in line or "bytes cmem" in line:
            print("  ptxas sparse_adagrad:", line.strip())
    config = kaggle_config(feature_size=128)
    sizes, d = config.table_sizes, config.feature_size
    gen = np.random.default_rng(2025)
    tgen = torch.Generator(DEV).manual_seed(7)
    emb = torch.empty((sum(sizes), d), device=DEV).uniform_(
        -0.05, 0.05, generator=tgen)
    acc = torch.rand(sum(sizes), device=DEV, generator=tgen) * 1e-2
    acc[torch.rand(sum(sizes), device=DEV, generator=tgen) < 0.5] = 0
    ids = _zipf_hits(gen, sizes, TRAIN_BATCH)
    rows = torch.randn((ids.numel(), d), device=DEV, generator=tgen) * 1e-3
    lr = 0.1
    whole = emb.clone()
    main = _sorted_update_agrees("Kaggle B=32768 x 26, D=128", emb, acc,
                                 ids, rows, lr)
    check(torch.equal(emb, whole), "sparse_adagrad: rows outside the hits "
          "moved")
    del whole
    runs = torch.unique_consecutive(torch.sort(ids).values,
                                    return_counts=True)[1]
    main["longest_run"] = int(runs.max())
    print(f"  the batch's longest run: {main['longest_run']} hits of one row")

    for what, dd, n_rows, n, dtype in (
            ("D=32, int64 ids", 32, 200_000, 400_000, torch.int64),
            ("D=256", 256, 5000, 60_000, torch.int32),
            ("D=6, single floats", 6, 3000, 50_000, torch.int64),
            ("one hit", 128, 10, 1, torch.int32)):
        e = torch.randn((n_rows, dd), device=DEV, generator=tgen)
        a = torch.rand(n_rows, device=DEV, generator=tgen)
        h = torch.from_numpy(np.minimum(gen.zipf(1.2, n) - 1, n_rows - 1)
                             ).to(DEV, dtype)
        _sorted_update_agrees(what, e, a, h, torch.randn(
            (n, dd), device=DEV, generator=tgen) * 1e-3, lr)

    # distinct ids: the summed row is the hit's row, so only the sum of
    # squares' order can differ from apply_adagrad_rows
    pick = torch.randperm(emb.shape[0], device=DEV, generator=tgen)[:400_000]
    g = torch.randn((pick.numel(), d), device=DEV, generator=tgen) * 1e-3
    e0, a0 = emb[pick].clone(), acc[pick].clone()
    O.apply_sorted_rowwise(emb, acc, E.SparseGrad(pick, g), lr)
    k_e, k_a = emb[pick].clone(), acc[pick].clone()
    emb[pick], acc[pick] = e0, a0
    O.apply_adagrad_rows(emb, acc, pick, g, lr, rowwise=True)
    t_e, t_a = emb[pick].clone(), acc[pick].clone()
    emb[pick], acc[pick] = e0, a0
    same = k_a.view(torch.int32) == t_a.view(torch.int32)
    acc_ulps = _ulps([k_a], [t_a])
    check(acc_ulps <= 2 and torch.equal(k_e[same], t_e[same]),
          f"sparse_adagrad on distinct ids: accumulators {acc_ulps} ulps "
          f"from apply_adagrad_rows, rows with equal accumulators "
          f"{'differ' if not torch.equal(k_e[same], t_e[same]) else 'agree'}")
    print(f"  sparse_adagrad on {pick.numel()} distinct ids: "
          f"apply_adagrad_rows' bits on {int(same.sum())} rows whose sum of "
          f"squares came out the same; accumulators within {acc_ulps} ulp(s) "
          f"elsewhere")

    grad = E.SparseGrad(ids, rows)
    hits = E.sort_hits(ids)
    t = {}
    t["sort_ms"] = _cold_ms(lambda: E.sort_hits(ids))
    t["kernel_ms"] = _cold_ms(
        lambda: E.sorted_rowwise_adagrad(emb, acc, hits, rows, lr))
    t["ms"] = _cold_ms(lambda: O.apply_sorted_rowwise(emb, acc, grad, lr))
    t["today_ms"] = _cold_ms(lambda: O.apply_sparse_adagrad(
        emb, acc, grad, lr, rowwise=True), 7)
    t["plain_ms"] = _cold_ms(lambda: E.sorted_rowwise_adagrad_reference(
        emb, acc, hits, rows, lr), 7)
    t["kernel_ms"] += _cold_ms(
        lambda: E.sorted_rowwise_adagrad(emb, acc, hits, rows, lr))
    t["ms"] += _cold_ms(lambda: O.apply_sorted_rowwise(emb, acc, grad, lr))
    t = {k: statistics.median(v) for k, v in t.items()}
    host_us = _host_us(lambda: O.apply_sorted_rowwise(emb, acc, grad, lr))
    sort_host_us = _host_us(lambda: E.sort_hits(ids))
    n, u = ids.numel(), main["distinct"]
    nbytes = n * d * 4 + n * ids.element_size() + 2 * u * (d * 4 + 4)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"  sparse_adagrad, {n} hits of {u} rows at D={d}, device time "
          f"after an L2 flush: sort {t['sort_ms']:.4f} ms, kernel "
          f"{t['kernel_ms']:.4f} ms ({bound_ms / t['kernel_ms']:.0%} of the "
          f"{bound_ms:.4f} ms bound, {nbytes / 1e6:.1f} MB), both "
          f"{t['ms']:.4f} ms; today's unique + index_add_ path "
          f"{t['today_ms']:.4f} ms, the plain version {t['plain_ms']:.4f} "
          f"ms; host time a call {host_us:.1f} us, of it the sort's "
          f"{sort_host_us:.1f} us")
    del emb, acc
    torch.cuda.empty_cache()
    return {"sparse_adagrad": {
        "max_abs_err": main["emb_vs_today"],
        "acc_rel_err": main["acc_vs_today"], **t, "host_us": host_us,
        "sort_host_us": sort_host_us,
        "bound_ms": bound_ms, "bound_by": "bytes", "bytes": nbytes,
        "hits": n, "distinct": u, "longest_run": main["longest_run"],
        # no single PyTorch call computes a row-wise Adagrad update
        "library_ms": None}}


def phase_kernels() -> dict:
    """Both kernels against their plain versions at every shape a main
    path gives them ((16384, 27, 128) serving and evaluation, (32768, 27,
    128) training steps and blocks, (8192, 27, 128) the clipped step,
    Terabyte's (32768, 27, 32) and (16384, 27, 32), and its bf16 fs=64
    model's (32768, 27, 64) and (16384, 27, 64), f32 after the pooled
    rows' cast) and at narrow and ragged ones, on the two sources x =
    T[:, 0] and feats = T[:, 1:] as the model hands them over; both also
    on the T-view form, which must give the same bits.  Rows of 16-byte
    multiples take both kernels' bulk-copy paths, the rows of (13, 5, 6)
    their plain-load paths; then the backward with g a view off 16-byte
    alignment (``_bwd_g_views``).  Each case prints its bound beside its
    time.  Returns the numbers at (16384, 27, 128) f32, per kernel, and
    each kernel's at the Terabyte shapes in f32 (``at_d32``,
    ``at_d64``)."""
    from dlrm_tpu_torch.ops import interaction_fused as F
    from dlrm_tpu_torch.ops.interaction import dot_interaction

    main = dense_adagrad_kernel()
    main.update(sparse_adagrad_kernel())
    g = torch.Generator(DEV).manual_seed(0)
    narrow = {k: {f"at_d{d}": [] for d in (TB_FEATURE, TB64_FEATURE)}
              for k in ("interaction_fwd", "interaction_bwd")}
    print("kernel vs plain (B, F, D, pad_to, dtype): max_abs_err, kernel ms, "
          "plain ms, bound ms")
    for b, f, d in [(BATCH, 27, 128), (TRAIN_BATCH, 27, 128),
                    (CLIP_BATCH, 27, 128), (TRAIN_BATCH, 27, TB_FEATURE),
                    (BATCH, 27, TB_FEATURE), (TRAIN_BATCH, 27, TB64_FEATURE),
                    (BATCH, 27, TB64_FEATURE), (BATCH, 27, 16),
                    (107, 27, 128), (13, 4, 8), (13, 5, 6)]:
        for pad_to in (1, 128):
            for dtype in (torch.float32, torch.bfloat16):
                t = torch.randn((b, f, d), generator=g, device=DEV
                                ).to(dtype)
                x, feats = t[:, 0].contiguous(), t[:, 1:].contiguous()
                width = F.output_width(f, d, pad_to)
                # nonzero padding columns: the backward must ignore them
                cot = torch.randn((b, width), generator=g, device=DEV
                                  ).to(dtype)
                # f32: sums in another order; bf16: plus one rounding of
                # the output
                rtol = 1e-5 if dtype == torch.float32 else 1e-2
                cases = {
                    "interaction_fwd": (
                        lambda: F.interaction_fwd(x, feats, pad_to),
                        lambda: F.fused_interaction_reference(x, feats,
                                                              pad_to)),
                    "interaction_bwd": (
                        lambda: F.interaction_bwd(cot, x, feats),
                        lambda: F.fused_interaction_bwd_reference(cot, x,
                                                                  feats)),
                }
                name = "f32" if dtype == torch.float32 else "bf16"
                for kname, (kern, plain) in cases.items():
                    got, ref = kern(), plain()
                    if kname == "interaction_bwd":  # (dx, dfeats) as one dT
                        got, ref = (torch.cat([y[0][:, None], y[1]], dim=1)
                                    for y in (got, ref))
                    torch.cuda.synchronize()
                    check(got.shape == ref.shape and got.dtype == dtype,
                          f"{kname}: shape/dtype {tuple(got.shape)} "
                          f"{got.dtype}")
                    p = f * (f - 1) // 2
                    if kname == "interaction_fwd":
                        check(bool((got[:, d + p:] == 0).all()),
                              "padding columns not zero")
                        bulk = _fwd_views_agree(F, t, pad_to, got)
                    else:
                        bulk = _bwd_views_agree(F, t, cot, got)
                    check(bulk == ((d * t.element_size()) % 16 == 0),
                          f"{kname} at {(b, f, d)} {name}: bulk path "
                          f"{bulk}")
                    torch.testing.assert_close(got.float(), ref.float(),
                                               atol=1e-4, rtol=rtol)
                    err = (got.float() - ref.float()).abs().max().item()
                    ms, plain_ms = timed_pair(kern, plain)
                    if kname == "interaction_fwd":
                        ins, outs = [x, feats], [got]
                    else:  # dx and dfeats have the sizes of x, feats; of
                        # the cotangent only the D + P columns are read
                        ins, outs = [cot[:, :d + p], x, feats], [x, feats]
                    bound = _bound(kname, ins, outs, b, f, d)
                    print(f"  {kname} ({b}, {f}, {d}, {pad_to}, {name}): "
                          f"{err:.3g}, {ms:.4f}, {plain_ms:.4f}, "
                          f"{bound['bound_ms']:.4f} "
                          f"({bound['bound_ms'] / ms:.0%} of the bound)")
                    if (d in (TB_FEATURE, TB64_FEATURE)
                            and (pad_to, dtype) == (1, torch.float32)):
                        narrow[kname][f"at_d{d}"].append({
                            "shape": [b, f, d], "ms": ms,
                            "plain_ms": plain_ms,
                            "bound_ms": bound["bound_ms"],
                            "bytes": bound["bytes"],
                            "share": bound["bound_ms"] / ms})
                    if (b, d, pad_to, dtype) == (BATCH, 128, 1,
                                                 torch.float32):
                        main[kname] = {
                            "max_abs_err": err, "ms": ms,
                            "plain_ms": plain_ms, **bound,
                            # no single PyTorch call computes either
                            # function (plain: bmm + triangular index + cat;
                            # index_put + symmetrise + bmm + add)
                            "library_ms": None}

    # autograd through the fused Function against autograd through gram,
    # at the main shape: (x, feats) = T's row 0 and rows 1.. (fs = D)
    t = torch.randn((BATCH, 27, 128), generator=g, device=DEV)
    cot = torch.randn((BATCH, F.output_width(27, 128, 1)), generator=g,
                      device=DEV)
    grads = []
    for fn in (F.fused_dot_interaction, dot_interaction):
        x = t[:, 0].clone().requires_grad_()
        feats = t[:, 1:].clone().requires_grad_()
        grads.append(torch.autograd.grad(fn(x, feats, 1), (x, feats), cot))
    # sums of 27 products of unit normals in another order (f32)
    err = max((a - b).abs().max().item() for a, b in zip(*grads))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-5)
    print(f"fused vs gram autograd gradient at ({BATCH}, 27, 128) f32: max "
          f"|diff| {err:.3g}")
    _bwd_g_views(F)
    for kname, at in narrow.items():
        main[kname].update(at)
    return main


def _wrappers() -> list:
    """The six kernels' wrappers, in LAUNCHES order."""
    from dlrm_tpu_torch.ops import embedding as E
    from dlrm_tpu_torch.ops import interaction_fused as F
    from dlrm_tpu_torch.parallel import host_tier as H
    from dlrm_tpu_torch.train import optim as O

    return [F.interaction_fwd, F.interaction_bwd, H.host_gather,
            H.host_update_rows, O.dense_adagrad, E.sorted_rowwise_adagrad]


def _adagrad(optimizer: str, steps: int) -> int:
    """dense_adagrad's launches over ``steps`` steps or micro-steps of
    ``optimizer`` on the 16 f32 dense leaves: one a step for Adagrad, none
    for SGD."""
    return 0 if optimizer == "sgd" else steps


def _sorted(optimizer: str, steps: int) -> int:
    """sparse_adagrad's launches over ``steps`` steps that apply every
    device table's update in the step (``train_step_opt``, the two-tier
    step and the two-tier block's micro-steps) on f32 tables without a
    clip: one a step for row-wise Adagrad, none for the others."""
    return steps if optimizer == "rowwise_adagrad" else 0


@contextlib.contextmanager
def counted(what: str, fwd: int, bwd: int, gather: int = 0,
            update: int = 0, dense: int = 0, sparse: int = 0):
    """A main path: every kernel's count is set to 0 before it and read
    after it; it must have launched interaction_fwd, interaction_bwd,
    host_gather, host_update_rows, dense_adagrad and sparse_adagrad
    ``fwd``, ``bwd``, ``gather``, ``update``, ``dense`` and ``sparse``
    times, every forward and every backward on the bulk-copy path.  The
    counts are added to LAUNCHES."""
    wrappers = _wrappers()
    for w in wrappers:
        w.launches = 0
    wrappers[0].bulk_launches = wrappers[1].bulk_launches = 0
    yield
    want = (fwd, bwd, gather, update, dense, sparse)
    got = tuple(w.launches for w in wrappers)
    check(got == want, f"{what} launched interaction_fwd, interaction_bwd, "
          f"host_gather, host_update_rows, dense_adagrad, sparse_adagrad "
          f"{got} times, not {want}")
    for w, n in zip(wrappers[:2], (fwd, bwd)):
        check(w.bulk_launches == n,
              f"{what}: {n - w.bulk_launches} of {n} {w.__name__} "
              f"launches did not take the bulk-copy path")
    for i, n in enumerate(want):
        LAUNCHES[i] += n


def phase_serving() -> None:
    """Kaggle fs=128 at full width, scoring through `predict`'s scoring
    function."""
    from dlrm_tpu_torch import init_params, kaggle_config
    from dlrm_tpu_torch.data.synthetic import batch_stream
    from dlrm_tpu_torch.run import score_batch

    dev = DEV
    config = kaggle_config(feature_size=128, interaction_impl="fused")
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = init_params(torch.Generator(dev).manual_seed(config.seed),
                         config, dev)
    torch.cuda.synchronize(dev)
    print(f"Kaggle fs=128: {config.total_rows} rows x 128, "
          f"{params['emb'].numel() * 4 / 1e9:.2f} GB of tables, init "
          f"{time.perf_counter() - t0:.2f} s on the card")
    batches = list(batch_stream(config, BATCH, MAIN_BATCHES, seed=0))

    scores, secs = [], []
    with counted("serving", len(batches), 0):
        for batch in batches:
            t0 = time.perf_counter()
            scores.append(score_batch(params, batch, config, dev))
            secs.append(time.perf_counter() - t0)
    fwd = len(batches)
    for s in scores:
        check(s.shape == (BATCH,) and s.dtype == np.float32,
              f"scores {s.shape} {s.dtype}")
        check(bool(np.isfinite(s).all()), "non-finite score")
        check(bool(((s > 0) & (s < 1)).all()), "score outside (0, 1)")
    gram = dataclasses.replace(config, interaction_impl="gram")
    diff = float(np.abs(score_batch(params, batches[0], gram, dev)
                        - scores[0]).max())
    check(diff <= 1e-5, f"fused vs gram scores differ by {diff}")
    steady = secs[1:]
    print(f"serving: {len(batches)} batches of {BATCH}, interaction_fwd "
          f"launched {fwd} times, first {secs[0] * 1e3:.1f} ms, then median "
          f"{statistics.median(steady) * 1e3:.2f} ms/batch = "
          f"{BATCH / statistics.median(steady):.0f} examples/s (host to "
          f"host, inputs copied in, scores copied out); fused vs gram max "
          f"|diff| {diff:.3g}; mean score {np.mean(scores):.6f}")
    print(f"peak device memory: "
          f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB")

    def serve(data):
        for batch in data:
            score_batch(params, batch, config, dev)

    _profile_steps("served batches", serve, batches,
                   pooled_bytes=BATCH * len(config.table_sizes)
                   * config.feature_size * 4)
    del params
    torch.cuda.empty_cache()


def _clone_dense(params: dict, device=None) -> dict:
    return {part: [{k: v.to(device, copy=True) for k, v in layer.items()}
                   for layer in params[part]] for part in ("bottom", "top")}


def _clone_params(params: dict, device=None) -> dict:
    return {**_clone_dense(params, device),
            "emb": params["emb"].to(device, copy=True)}


def _max_dense_diff(a: dict, b: dict) -> float:
    return max((x.float().cpu() - y.float().cpu()).abs().max().item()
               for part in ("bottom", "top")
               for la, lb in zip(a[part], b[part])
               for x, y in ((la["w"], lb["w"]), (la["b"], lb["b"])))


def phase_training() -> None:
    """Kaggle fs=128 at full width, 8 SGD steps at B=32768 through
    `dlrm_tpu_torch.train`."""
    from dlrm_tpu_torch import init_params, kaggle_config, train
    from dlrm_tpu_torch.data.synthetic import batch_stream
    from dlrm_tpu_torch.ops.embedding import translate_ids

    dev = DEV
    config = kaggle_config(feature_size=128, interaction_impl="fused")
    torch.cuda.reset_peak_memory_stats(dev)
    params = init_params(torch.Generator(dev).manual_seed(config.seed),
                         config, dev)
    start = _clone_params(params)  # for the gram run: 17.3 GB more
    batches = list(batch_stream(config, TRAIN_BATCH, TRAIN_STEPS, seed=0))
    half = TRAIN_STEPS // 2
    touched = torch.unique(torch.cat([
        translate_ids(torch.from_numpy(b["sparse"]).to(dev),
                      config.table_offsets).reshape(-1)
        for b in batches[:half]])).long()
    torch.cuda.synchronize(dev)

    with counted("SGD training", TRAIN_STEPS, TRAIN_STEPS):
        first = train(params, batches[:half], config=config, lr=0.1)
        mid_rows = params["emb"][touched].clone()
        mid_dense = _clone_dense(params)
        second = train(params, batches[half:], config=config, lr=0.1)
        torch.cuda.synchronize(dev)
    fwd = bwd = TRAIN_STEPS
    losses = first["losses"] + second["losses"]
    check(len(losses) == TRAIN_STEPS and all(np.isfinite(losses)),
          f"losses {losses}")
    secs = [ns / 1e9 for ns in first["iteration_times"]
            + second["iteration_times"]]
    peak = torch.cuda.max_memory_allocated(dev) / 1e9

    gram_cfg = dataclasses.replace(config, interaction_impl="gram")
    gram = train(start, batches[:half], config=gram_cfg, lr=0.1)
    # f32 throughout; the two interactions sum in another order (scores
    # agree to ~1e-7), and 4 steps at lr 0.1 keep the drift below 1e-5
    loss_diff = float(np.abs(np.subtract(gram["losses"],
                                         losses[:half])).max())
    row_diff = (start["emb"][touched] - mid_rows).abs().max().item()
    dense_diff = _max_dense_diff(start, mid_dense)
    check(loss_diff <= 1e-5, f"fused vs gram training losses: {loss_diff}")
    check(row_diff <= 1e-5, f"fused vs gram touched rows: {row_diff}")
    check(dense_diff <= 1e-5, f"fused vs gram dense params: {dense_diff}")
    steady = statistics.median(secs[1:])
    print(f"training: Kaggle fs=128, {TRAIN_STEPS} SGD steps at B="
          f"{TRAIN_BATCH}, lr 0.1, f32, fused; interaction_fwd launched "
          f"{fwd}, interaction_bwd {bwd} times; losses "
          f"{[round(x, 6) for x in losses]}")
    print(f"training step host to host (batch copied in, loss read back): "
          f"first {secs[0] * 1e3:.1f} ms, then median {steady * 1e3:.2f} ms "
          f"(min {min(secs[1:]) * 1e3:.2f}, max {max(secs[1:]) * 1e3:.2f}) "
          f"= {TRAIN_BATCH / steady:.0f} examples/s; peak device memory "
          f"{peak:.2f} GB (two copies of the tables)")
    print(f"fused vs gram after {half} steps: losses {loss_diff:.3g}, "
          f"{touched.numel()} touched rows {row_diff:.3g}, dense params "
          f"{dense_diff:.3g}")
    _fused_vs_gram_steps(params, start, batches, config)
    _profile_steps("fused SGD steps", lambda data: train(
        params, data, config=config, lr=0.1), batches,
        pooled_bytes=TRAIN_BATCH * len(config.table_sizes)
        * config.feature_size * 4)
    del params, start, mid_rows
    torch.cuda.empty_cache()


def _step_ms(params, batches, config, steps: int, warmup: int = 3) -> float:
    """Median host-to-host step time (ms) of ``steps`` steps through
    `train` after ``warmup`` steps, cycling over ``batches``."""
    from dlrm_tpu_torch import train

    train(params, batches[:warmup], config=config, lr=0.1)
    res = train(params, (batches[i % len(batches)] for i in range(steps)),
                config=config, lr=0.1)
    return statistics.median(res["iteration_times"]) / 1e6


def _fused_vs_gram_steps(fused_params, gram_params, batches, config,
                         steps: int = 10) -> None:
    """Training step time under the fused and the gram interaction, in
    turns (fused, gram, gram, fused) within this call, each on its own
    copy of the parameters."""
    gram_cfg = dataclasses.replace(config, interaction_impl="gram")
    order = [("fused", fused_params, config), ("gram", gram_params, gram_cfg)]
    order += order[::-1]
    ms = {"fused": [], "gram": []}
    for name, params, cfg in order:
        ms[name].append(_step_ms(params, batches, cfg, steps))
    fused, gram = (statistics.mean(ms[k]) for k in ("fused", "gram"))
    print(f"training step, fused vs gram in turns (fused, gram, gram, fused;"
          f" median of {steps} steps each after 3): "
          f"{ms['fused'][0]:.3f} / {ms['gram'][0]:.3f} / {ms['gram'][1]:.3f}"
          f" / {ms['fused'][1]:.3f} ms; fused {TRAIN_BATCH / fused * 1e3:.0f}"
          f" vs gram {TRAIN_BATCH / gram * 1e3:.0f} examples/s")


# the phase scopes (record_function) of the forward and the training
# gather, and of the two-tier steps' host-tier work; the profiler lists each
# also as a CUDA annotation spanning its kernels, which is not a kernel of
# its own
_SCOPES = ("lookup", "bottom_mlp", "interaction", "top_mlp")
_TIER_SCOPES = ("lookup_host_tier", "host_tier_update",
                "host_tier_prefetch_next")
# the step's own spans (utils/telemetry.py): the loss, the gradient's split,
# the dense optimizer, the dedup, the backward's stages, the prefetch's take,
# scoring's copies
_STEP_SCOPES = ("loss", "grad_split", "dense_apply", "dedup", "autograd.bwd",
                "loss.bwd", "top_mlp.bwd", "interaction.bwd",
                "bottom_mlp.bwd", "prefetch.take", "score_batch.h2d",
                "score_batch.readback")
# the sharded path's scopes (parallel/embedding.py, the sharded step): the
# profile prints the CUDA time under each
_SHARD_SCOPES = ("a2a_fwd", "rs_reduce_scatter", "cs_a2a_fwd",
                 "pooled_permute", "a2a_bwd", "rs_allgather_bwd",
                 "cs_a2a_bwd", "dcn_grad_allgather", "dense_allreduce",
                 "sparse_update", "host_rs_gather", "host_rs_update",
                 "adagrad_dedup", "cs_adagrad", "grad_clip",
                 "dcn_replica_check")
# ProcessGroupNCCL's range around each collective ("nccl:all_to_all"),
# mirrored on the device over the copies or kernels that do the work: a
# span like the scopes, not work of its own
_NCCL_RANGE = "nccl:"
# (group, substrings of a CUDA activity's name); the first match wins
_PROFILE_GROUPS = (
    ("dedup: sort, unique, scan (cub and thrust kernels)",
     ("cub::", "thrust::")),
    ("MLP GEMMs (gemm, gemv, split-K reduce)",
     ("gemm", "gemv", "splitKreduce")),
    ("sparse update (index_add_)", ("indexFuncLargeIndex",
                                    "indexFuncSmallIndex")),
    ("sparse update (sparse_adagrad kernels)", ("sparse_adagrad_",)),
    ("embedding gather (index_select)", ("gather_kernel", "indexSelect")),
    ("host-to-device copies", ("Memcpy HtoD",)),
    ("interaction_bwd kernel", ("interaction_bwd_kernel",)),
    ("interaction_fwd kernel", ("interaction_fwd_kernel",)),
    ("torch.cat (none on the fused path)", ("CatArrayBatched",)),
    ("device copies (direct_copy_kernel)", ("direct_copy",)),
)


def _profile_steps(what: str, run, batches, steps: int = 5,
                   pooled_bytes: int = 0, groups=(), scopes=()) -> None:
    """`torch.profiler` over ``steps`` steps (or served batches) after 3
    warm-up ones: device time a step by group, and the device's idle share
    of the host-to-host window; returns the groups' device microseconds
    (None when the profiler saw no device time).  ``run(data)`` takes one
    step a batch of ``data``, reading each result back.

    With ``pooled_bytes`` (the size of the pooled embeddings, or of their
    gradient) the fused path is held to what it promises: no `torch.cat`
    kernel (T is never stacked) and no copy kernel as long as copying that
    many bytes takes at the HBM rate (the embedding gradient reaches the
    update as a view).  ``groups`` are matched before the common ones.
    The host-to-device copies are listed by kind and CUDA stream, beside
    the stream the forward kernel ran on.  ``scopes``: phase scopes whose
    kernels (those launched by a host op inside one of the scope's spans)
    are listed by name, returned as ``groups["kernels under <scope>"]``
    ({name: device microseconds})."""
    from torch.profiler import ProfilerActivity, profile

    run(batches[:3])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(batches[i % len(batches)] for i in range(steps))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    table = tuple(groups) + _PROFILE_GROUPS
    groups = {name: 0.0 for name, _ in table}
    other, scoped = {}, {}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if evt.key in _SHARD_SCOPES or evt.key.startswith(_NCCL_RANGE):
            scoped[evt.key] = evt.device_time_total
        if evt.key in _SCOPES + _TIER_SCOPES + _SHARD_SCOPES + _STEP_SCOPES \
                or evt.key.startswith(_NCCL_RANGE):
            continue
        us = evt.self_device_time_total
        for name, keys in table:
            if any(k in evt.key for k in keys):
                groups[name] += us
                break
        else:
            other[evt.key] = other.get(evt.key, 0.0) + us
    groups["elementwise and reductions (all else)"] = sum(other.values())
    busy_ms = sum(groups.values()) / 1e3
    if busy_ms == 0:
        print(f"profile, {what}: the profiler recorded no device time (not "
              f"measured)")
        return None
    print(f"profile, {steps} {what} after 3: {busy_ms / steps:.3f} ms of "
          f"device time a step, {wall_ms / steps:.3f} ms host to host a "
          f"step, device idle {100 * (1 - busy_ms / wall_ms):.1f}%")
    for name, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {name}: {us / 1e3 / steps:.3f} ms a step "
              f"({100 * us / 1e3 / busy_ms:.1f}%)")
    for key, us in sorted(other.items(), key=lambda kv: -kv[1])[:6]:
        print(f"    of all else: {us / 1e3 / steps:.3f} ms a step: "
              f"{key[:110]}")
    for key, us in sorted(scoped.items(), key=lambda kv: -kv[1]):
        print(f"  under the scope {key}: {us / 1e3 / steps:.3f} ms a step "
              f"of device time")
    copies, fwd_streams = {}, set()
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if "Memcpy HtoD" in e.name:
            k = (e.name, getattr(e, "device_resource_id", None))
            copies[k] = copies.get(k, 0.0) + e.time_range.elapsed_us()
        elif "interaction_fwd_kernel" in e.name:
            fwd_streams.add(getattr(e, "device_resource_id", None))
    for (name, stream), us in sorted(copies.items()):
        print(f"  {name} on stream {stream}: {us / 1e3 / steps:.3f} ms a "
              f"step (the forward kernel ran on stream(s) "
              f"{sorted(fwd_streams)})")
    cpu = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CPU] if scopes else []
    for scope in scopes:
        spans = [(e.thread, e.time_range.start, e.time_range.end)
                 for e in cpu if e.name == scope]
        under = {}
        for e in cpu:
            if any(e.thread == th and a <= e.time_range.start
                   and e.time_range.end <= b for th, a, b in spans):
                for k in e.kernels:
                    under[k.name] = under.get(k.name, 0.0) + k.duration
        groups[f"kernels under {scope}"] = under
        for name, us in sorted(under.items(), key=lambda kv: -kv[1]):
            print(f"  kernel under the scope {scope}: {us / 1e3 / steps:.3f}"
                  f" ms a step: {name[:110]}")
    if pooled_bytes:
        full_copy_us = 2 * pooled_bytes / HBM_BYTES_PER_S * 1e6
        kernels = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        cats = [n for n, _ in kernels if "CatArrayBatched" in n]
        copies = [us for n, us in kernels if "direct_copy" in n]
        longest = max(copies, default=0.0)
        check(not cats, f"{what}: {len(cats)} cat kernels on the fused path")
        check(longest < full_copy_us, f"{what}: a copy kernel of "
              f"{longest:.1f} us, as long as a copy of the {pooled_bytes} B "
              f"of pooled rows ({full_copy_us:.1f} us at the HBM rate)")
        print(f"  fused path: no cat kernel; the longest of "
              f"{len(copies)} copy kernels {longest:.1f} us, below the "
              f"{full_copy_us:.1f} us a copy of the {pooled_bytes / 1e6:.1f} "
              f"MB of pooled rows takes at the HBM rate")
    return groups


def _to_dev(batch: dict, device=None) -> list:
    """(dense, sparse, labels) of a numpy batch as tensors on ``device``
    (default: the card)."""
    return [torch.as_tensor(batch[k]).to(DEV if device is None else device)
            for k in KEYS]


def _stack(batches: list) -> dict:
    return {k: np.stack([b[k] for b in batches]) for k in KEYS}


def _all_ids(batches: list, config) -> torch.Tensor:
    """The distinct stacked-table rows that ``batches`` touch (int64)."""
    from dlrm_tpu_torch.ops.embedding import translate_ids

    return torch.unique(torch.cat([
        translate_ids(torch.from_numpy(b["sparse"]).to(DEV),
                      config.table_offsets).reshape(-1)
        for b in batches])).long()


def _touched_by_kind(rows: torch.Tensor, placement, config) -> dict:
    """``rows`` (stacked-table rows) split by the placement kind of their
    table: slot, row-sharded and column-sharded; every kind must hold
    some."""
    starts = torch.tensor(config.table_offsets, device=rows.device)
    table = torch.searchsorted(starts, rows, right=True) - 1
    out = {}
    for kind, tables in (("slot", placement.slot_table_list),
                         ("row-sharded", placement.row_sharded),
                         ("column-sharded", placement.col_sharded)):
        mask = torch.isin(table, torch.tensor(tables, device=rows.device))
        out[kind] = rows[mask]
        check(out[kind].numel() > 0, f"the batch touches no {kind} row")
    return out


def phase_evaluation() -> None:
    """Kaggle fs=128 at full width: `evaluate` over 8 batches of 16384 and
    a ragged one of 107, against the metrics of `score_batch`'s scores."""
    from dlrm_tpu_torch import bce_loss, init_params, kaggle_config
    from dlrm_tpu_torch.data.synthetic import batch_stream, random_batch
    from dlrm_tpu_torch.run import score_batch
    from dlrm_tpu_torch.train.metrics import (auc_roc, binary_accuracy,
                                              evaluate)

    config = kaggle_config(feature_size=128, interaction_impl="fused")
    params = init_params(torch.Generator(DEV).manual_seed(config.seed),
                         config, DEV)
    batches = list(batch_stream(config, BATCH, MAIN_BATCHES, seed=3))
    batches.append(random_batch(np.random.default_rng(4), config, 107))
    total = MAIN_BATCHES * BATCH + 107
    with counted("evaluation", len(batches), 0):
        m = evaluate(params, batches, config)
    scores = np.concatenate([score_batch(params, b, config, DEV)
                             for b in batches])
    labels = np.concatenate([b["labels"] for b in batches])
    acc = binary_accuracy(scores, labels)
    loss = float(bce_loss(torch.from_numpy(scores), torch.from_numpy(labels)))
    exact = auc_roc(scores, labels)
    check(m["examples"] == total, f"evaluate counted {m['examples']} rows")
    check(abs(m["accuracy"] - acc) <= 1e-5, f"accuracy {m['accuracy']} vs "
          f"{acc} from score_batch's scores")
    # the mean over batch means (f32 each) against one f32 mean
    check(abs(m["loss"] - loss) <= 1e-6, f"loss {m['loss']} vs {loss}")
    check(abs(m["auc"] - exact) <= 1e-3,
          f"streaming AUC {m['auc']} vs exact {exact}")
    secs = []
    for _ in range(4):
        t0 = time.perf_counter()
        evaluate(params, batches[:MAIN_BATCHES], config)
        secs.append((time.perf_counter() - t0) / MAIN_BATCHES)
    ms = statistics.median(secs[1:]) * 1e3
    print(f"evaluation: {total} rows in {len(batches)} batches (ragged tail "
          f"of 107), interaction_fwd launched {len(batches)} times; accuracy "
          f"{m['accuracy']:.6f}, loss {m['loss']:.6f} (|diff| to the scores' "
          f"{abs(m['loss'] - loss):.3g}), streaming AUC {m['auc']:.6f} vs "
          f"exact {exact:.6f}")
    print(f"evaluate: {ms:.2f} ms a batch of {BATCH} host to host = "
          f"{BATCH / ms * 1e3:.0f} examples/s (median of 3 passes over "
          f"{MAIN_BATCHES} batches after 1; inputs copied in, predictions, "
          f"loss and bucket counts copied out)")
    del params
    torch.cuda.empty_cache()


def _batches_without_repeats(config, k: int, batch: int, rng,
                             within: bool) -> list:
    """``k`` random batches in which no big-table id occurs in two of
    them: batch j draws a big table's ids from the j-th of ``k`` equal
    ranges of its rows (``within``: nor twice inside a batch)."""
    from dlrm_tpu_torch.data.synthetic import random_batch
    from dlrm_tpu_torch.ops.embedding import partition_tables

    out = [random_batch(rng, config, batch) for _ in range(k)]
    _, big = partition_tables(config.table_sizes,
                              config.small_table_threshold)
    for t in big:
        span = config.table_sizes[t] // k
        for j, b in enumerate(out):
            ids = (rng.choice(span, size=batch, replace=False) if within
                   else rng.integers(0, span, size=batch))
            b["sparse"][:, t] = j * span + ids
    return out


class _Snapshot:
    """The rows ``ids`` of the tables and of their accumulator, the dense
    parameters and their accumulators, and the step count, to read again
    and to put back: two runs from one state without a second copy of the
    tables."""

    def __init__(self, params: dict, opt_state, ids: torch.Tensor):
        self.params, self.opt_state, self.ids = params, opt_state, ids
        self.saved = self.read()
        self.count = opt_state["count"] if opt_state else None

    def _tensors(self) -> tuple:
        """(tensors read by row: the tables and their accumulator; tensors
        read whole: the dense parameters and their accumulators)"""
        from dlrm_tpu_torch.ops.embedding import tree_leaves

        by_row = [self.params["emb"]]
        whole = tree_leaves({"bottom": self.params["bottom"],
                             "top": self.params["top"]})
        if self.opt_state and self.opt_state["emb"] is not None:
            by_row.append(self.opt_state["emb"])
            whole += tree_leaves(self.opt_state["dense"])
        return by_row, whole

    def read(self) -> list:
        by_row, whole = self._tensors()
        return ([t.index_select(0, self.ids) for t in by_row]
                + [t.clone() for t in whole])

    def restore(self) -> None:
        by_row, whole = self._tensors()
        for t, old in zip(by_row, self.saved):
            t.index_copy_(0, self.ids, old)
        for t, old in zip(whole, self.saved[len(by_row):]):
            t.copy_(old)
        if self.opt_state:
            self.opt_state["count"] = self.count


def _max_diff(a: list, b: list) -> float:
    return max((x.float() - y.float()).abs().max().item()
               for x, y in zip(a, b))


def _step_fns(config, optimizer: str, lr: float, params, state):
    """(step(dense, sparse, labels) -> loss, block(...) -> losses) of
    ``optimizer`` through the functions the CLI selects for it."""
    from dlrm_tpu_torch.train import train as T

    if optimizer == "sgd":
        step = T.make_train_step(config, lr)
        block = T.make_train_block(config, lr)
        return (lambda *b: step(params, *b)), (lambda *b: block(params, *b))
    step = T.make_train_step_opt(config, optimizer=optimizer, lr=lr)
    block = T.make_train_block_opt(config, optimizer=optimizer, lr=lr)
    return ((lambda *b: step(params, state, *b)),
            (lambda *b: block(params, state, *b)))


def _check_adagrad_formula(params, state, batch, config, optimizer: str,
                           lr: float, step) -> str:
    """One step held against the plain formula on the rows it touches:
    the per-row summed gradient g from the port's own gradient function,
    ``acc += g^2`` (row-wise: ``mean_D(g^2)``), ``w -= lr * g * rsqrt(acc +
    1e-10)``; and a sample of rows it does not touch keeps its bits."""
    from dlrm_tpu_torch.models.dlrm import loss_from_pooled, split_params
    from dlrm_tpu_torch.ops import embedding as E

    dense, sparse, labels = _to_dev(batch)
    dense_params, emb = split_params(params)
    acc = state["emb"]
    _, (_, sg) = E.sparse_value_and_grad(
        functools.partial(loss_from_pooled, config=config),
        pool_fn=functools.partial(E.mixed_pool, config=config))(
        dense_params, emb, sparse, config.table_offsets, dense, labels)
    uniq, inverse = torch.unique(sg.ids, return_inverse=True)
    uniq = uniq.long()
    g = torch.zeros((uniq.shape[0], emb.shape[1]), device=DEV)
    g.index_add_(0, inverse, sg.rows.float())
    del sg
    sample = torch.randint(0, emb.shape[0], (200_000,), device=DEV,
                           generator=torch.Generator(DEV).manual_seed(1))
    sample = sample[~torch.isin(sample, uniq)]
    w0, a0 = emb[uniq], acc[uniq]
    idle = emb[sample], acc[sample]
    float(step(dense, sparse, labels))
    a_want = a0 + ((g * g).mean(dim=1) if optimizer == "rowwise_adagrad"
                   else g * g)
    rs = torch.where(a_want > 0, torch.rsqrt(a_want + 1e-10),
                     torch.zeros_like(a_want))
    w_want = w0 - lr * g * (rs[:, None] if rs.dim() == 1 else rs)
    w_err = (emb[uniq] - w_want).abs().max().item()
    a_err = ((acc[uniq] - a_want).abs().max() / a_want.max()).item()
    moved = (emb[uniq] - w0).abs().max().item()
    check(w_err <= 1e-5 and a_err <= 1e-5,
          f"{optimizer}: touched rows off the plain formula by {w_err} "
          f"(tables) and {a_err} (accumulator)")
    check(moved > 1e-5, f"{optimizer}: the step moved no row ({moved})")
    check(torch.equal(emb[sample], idle[0]) and
          torch.equal(acc[sample], idle[1]),
          f"{optimizer}: a row that was not hit changed")
    return (f"{uniq.numel()} touched rows within {w_err:.3g} (tables, moved "
            f"by up to {moved:.3g}) and {a_err:.3g} (accumulator) of the "
            f"plain formula, {sample.numel()} sampled idle rows unchanged")


def _check_clip(params, config) -> None:
    """SGD at B=8192 on a batch in which no big-table id repeats, so the
    applied update's norm is lr times the norm the clip counts (big tables
    per hit, small tables per row).  lr is 1: the update is read as a
    difference of f32 weights, and a larger one loses less to their
    rounding."""
    from dlrm_tpu_torch.train.train import init_opt_state, train_step_opt

    rng = np.random.default_rng(21)
    (batch,) = _batches_without_repeats(config, 1, CLIP_BATCH, rng,
                                        within=True)
    dev_batch = _to_dev(batch)
    state = init_opt_state(params, config=config, optimizer="sgd")
    snap = _Snapshot(params, state, _all_ids([batch], config))

    def update(clip):
        loss = float(train_step_opt(params, state, *dev_batch, config=config,
                                    optimizer="sgd", lr=1.0,
                                    grad_clip_norm=clip))
        after = snap.read()
        snap.restore()
        return loss, [a.double() - b.double()
                      for a, b in zip(after, snap.saved)]

    def norm(upd):
        return float(torch.sqrt(sum((u * u).sum() for u in upd)))

    loss, free = update(None)
    gnorm = norm(free)
    largest = max(u.abs().max().item() for u in free)
    _, huge = update(1e9)
    # Without a clip each hit of a small table is added into the f32 weight
    # on its own (thousands of adds into weights of up to 0.58, each rounded
    # at 6e-8); under a clip the hits are summed first and added once.  So
    # the two differ by a random walk of those roundings, read here at
    # about 2e-6: held to the 1e-5 of every other f32 comparison.
    same = _max_diff(free, huge)
    check(same <= 1e-5, f"a clip of 1e9 changed the step by {same}")
    max_norm = gnorm / 4
    _, tight = update(max_norm)
    got = norm(tight)
    check(got <= max_norm * (1 + 1e-4) and got >= max_norm * (1 - 1e-3),
          f"clipped update has norm {got}, lr * max_norm is {max_norm}")
    ratio = _max_diff(tight, [u / 4 for u in free]) / largest
    check(ratio <= 1e-3, f"clipped update is not the free one / 4: {ratio}")
    print(f"clip: SGD step at B={CLIP_BATCH}, lr 1, loss {loss:.6f}; "
          f"unclipped update norm {gnorm:.6g}; grad_clip_norm 1e9 changes it "
          f"by {same:.3g} (largest entry {largest:.3g}); grad_clip_norm {max_norm:.6g} gives an update of "
          f"norm {got:.6g} ({got / max_norm - 1:+.2e} relative), the "
          f"unclipped update / 4 within {ratio:.3g} of its largest entry")


def _check_block(params, state, config, optimizer: str, lr: float) -> None:
    """A K=4 block at B=32768 against 4 sequential steps from the same
    state, on batches in which no big-table id occurs in two of them."""
    rng = np.random.default_rng(31)
    batches = _batches_without_repeats(config, BLOCK, TRAIN_BATCH, rng,
                                       within=False)
    step, block = _step_fns(config, optimizer, lr, params, state)
    snap = _Snapshot(params, state, _all_ids(batches, config))
    stacked = _to_dev(_stack(batches))
    with counted(f"{optimizer} block", BLOCK, BLOCK,
                 dense=_adagrad(optimizer, BLOCK)):
        blk_losses = block(*stacked).tolist()
    del stacked
    got = snap.read()
    snap.restore()
    seq_losses = [float(step(*_to_dev(b))) for b in batches]
    want = snap.read()
    loss_diff = float(np.abs(np.subtract(blk_losses, seq_losses)).max())
    diff = _max_diff(got, want)
    check(all(np.isfinite(blk_losses)), f"block losses {blk_losses}")
    check(loss_diff <= 1e-5 and diff <= 1e-5,
          f"{optimizer} K={BLOCK} block vs {BLOCK} steps: losses "
          f"{loss_diff}, state {diff}")
    moved = _max_diff(got[:1], snap.saved[:1])
    check(moved > 0, f"{optimizer} block moved no row")
    print(f"block: {optimizer} K={BLOCK} at B={TRAIN_BATCH} vs {BLOCK} "
          f"sequential steps from the same state: losses {loss_diff:.3g}, "
          f"{snap.ids.numel()} touched rows, dense parameters and "
          f"accumulators {diff:.3g} (rows moved by up to {moved:.3g}); "
          f"losses {[round(x, 6) for x in blk_losses]}")


@contextlib.contextmanager
def _deterministic():
    """PyTorch's deterministic kernels (``index_add_`` as a sorted
    ``index_put_``) for the duration; warn where there is none."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def _warm(state: dict) -> None:
    """Raise every accumulator of ``state`` to at least 1e-6.  From a zero
    accumulator an Adagrad step is lr * g * rsqrt(g^2 + 1e-10): lr * 1e5 * g
    where |g| << 1e-5, which amplifies the last-bit differences between two
    runs' gradients (another order of the atomic sums, another interaction)
    a thousandfold over SGD's.  From 1e-6 a step is at most lr * g / 1e-3,
    and two runs can be held to SGD's 1e-5."""
    from dlrm_tpu_torch.ops.embedding import tree_leaves

    for a in [state["emb"]] + tree_leaves(state["dense"]):
        a.clamp_(min=1e-6)


def _check_fused_vs_gram(params, state, batches, config, optimizer: str,
                         lr: float) -> None:
    """OPT_STEPS steps under the fused interaction against the same steps
    under gram from a clone of parameters and state, from warm
    accumulators (:func:`_warm`): losses, touched rows and dense parameters
    within 1e-5, the touched rows' accumulator within 1e-5 of its largest
    entry."""
    from dlrm_tpu_torch.train.train import make_train_step_opt

    batches = batches[:OPT_STEPS]
    _warm(state)
    start = _clone_params(params)
    gram_state = _clone_state(state, DEV)
    touched = _all_ids(batches, config)
    before = params["emb"][touched]
    runs = []
    for cfg, p, st in ((config, params, state),
                       (dataclasses.replace(config, interaction_impl="gram"),
                        start, gram_state)):
        step = make_train_step_opt(cfg, optimizer=optimizer, lr=lr)
        fused = cfg is config
        with counted(f"{optimizer} warm steps", OPT_STEPS * fused,
                     OPT_STEPS * fused,
                     dense=_adagrad(optimizer, OPT_STEPS),
                     sparse=_sorted(optimizer, OPT_STEPS)):
            runs.append([float(step(p, st, *_to_dev(b))) for b in batches])
    loss_diff = float(np.abs(np.subtract(*runs)).max())
    rows = params["emb"][touched]
    row_diff = (start["emb"][touched] - rows).abs().max().item()
    moved = (rows - before).abs().max().item()
    acc = state["emb"][touched]
    acc_diff = ((gram_state["emb"][touched] - acc).abs().max()
                / acc.max()).item()
    dense_diff = _max_dense_diff(start, params)
    check(moved > 1e-5, f"{optimizer} warm steps moved no row ({moved})")
    check(max(loss_diff, row_diff, dense_diff, acc_diff) <= 1e-5,
          f"{optimizer} fused vs gram: losses {loss_diff}, rows {row_diff}, "
          f"accumulator {acc_diff}, dense {dense_diff}")
    print(f"{optimizer} fused vs gram, {OPT_STEPS} more steps from "
          f"accumulators of at least 1e-6: losses {loss_diff:.3g}, "
          f"{touched.numel()} touched rows {row_diff:.3g} (moved by up to "
          f"{moved:.3g}), their accumulator {acc_diff:.3g} of its largest "
          f"entry, dense parameters {dense_diff:.3g}")


def _times(params, states, config, lrs, batches) -> None:
    """Host-to-host ms a step of every optimizer at K=1 and in K=4 blocks,
    in turns within this call (sgd, adagrad, rowwise, rowwise, adagrad,
    sgd): the batch (K=4: the stacked block) copied in, the last loss read
    back; median of 10 steps (K=4: 5 blocks, over 4) after 3 (2)."""
    blocks = [_stack(batches[:BLOCK]), _stack(batches[BLOCK:2 * BLOCK])]
    for k in (1, BLOCK):
        ms = {o: [] for o in OPTIMIZERS}
        for opt in OPTIMIZERS + OPTIMIZERS[::-1]:
            step, block = _step_fns(config, opt, lrs[opt], params,
                                    states[opt])
            n, warm = (13, 3) if k == 1 else (7, 2)
            times = []
            for i in range(n):
                t0 = time.perf_counter()
                if k == 1:
                    float(step(*_to_dev(batches[i % len(batches)])))
                else:
                    float(block(*_to_dev(blocks[i % 2]))[-1])
                times.append((time.perf_counter() - t0) * 1e3 / k)
            ms[opt].append(statistics.median(times[warm:]))
        print(f"step times, K={k}, in turns (ms a step host to host): "
              + "; ".join(f"{o} {ms[o][0]:.3f} / {ms[o][1]:.3f} = "
                          f"{TRAIN_BATCH / statistics.mean(ms[o]) * 1e3:.0f} "
                          f"examples/s" for o in OPTIMIZERS))


def phase_optimizers() -> None:
    """Kaggle fs=128 at full width, f32, fused: Adagrad and row-wise
    Adagrad steps, the clip, K=4 blocks, and the times."""
    from dlrm_tpu_torch import init_params, kaggle_config
    from dlrm_tpu_torch.data.synthetic import batch_stream
    from dlrm_tpu_torch.train.train import init_opt_state, make_train_step_opt

    config = kaggle_config(feature_size=128, interaction_impl="fused")
    torch.cuda.reset_peak_memory_stats(DEV)
    params = init_params(torch.Generator(DEV).manual_seed(config.seed),
                         config, DEV)
    batches = list(batch_stream(config, TRAIN_BATCH, 2 * BLOCK, seed=11))
    # from a zero accumulator Adagrad's first step moves every dense weight
    # by lr (g * rsqrt(g^2) is a sign) and a table row by about lr * g * 1e5
    # (eps = 1e-10 carries the root while g^2 is below it): 0.001 keeps
    # both well under the weights' own size, and the runs that are compared
    # on one trajectory
    lrs = {"sgd": 0.1, "adagrad": 0.001, "rowwise_adagrad": 0.001}
    states = {"sgd": init_opt_state(params, config=config, optimizer="sgd")}

    # row-wise Adagrad first: its state is small, so a clone of the tables
    # fits beside it for the run under the gram interaction
    for opt in ("rowwise_adagrad", "adagrad"):
        states[opt] = init_opt_state(params, config=config, optimizer=opt)
        step = make_train_step_opt(config, optimizer=opt, lr=lrs[opt])
        # the cold steps sum duplicate ids without atomics: from zero
        # accumulators Adagrad turns the atomics' run-to-run order into
        # weight differences of up to 1e-4 (ROADMAP.md §3), and the checks
        # below must start from the same state in every run
        with counted(f"{opt} steps", OPT_STEPS, OPT_STEPS,
                     dense=OPT_STEPS, sparse=_sorted(opt, OPT_STEPS)), \
                _deterministic():
            losses = [float(step(params, states[opt], *_to_dev(b)))
                      for b in batches[:OPT_STEPS]]
        check(all(np.isfinite(losses)) and states[opt]["count"] == OPT_STEPS,
              f"{opt} losses {losses}")
        print(f"{opt}: {OPT_STEPS} steps at B={TRAIN_BATCH}, lr {lrs[opt]}, "
              f"from zero accumulators, both kernels launched {OPT_STEPS} "
              f"times; losses {[round(x, 6) for x in losses]}")
        if opt == "rowwise_adagrad":
            _check_fused_vs_gram(params, states[opt], batches[OPT_STEPS:],
                                 config, opt, lrs[opt])
            torch.cuda.empty_cache()
        print(f"{opt}: " + _check_adagrad_formula(
            params, states[opt], batches[OPT_STEPS], config, opt, lrs[opt],
            lambda *b: step(params, states[opt], *b)))

    _check_clip(params, config)
    # warm accumulators (see _warm), so that block and steps can be held
    # to 1e-5 like SGD's; from zero this check read 8e-5
    _warm(states["adagrad"])
    for opt in OPTIMIZERS:
        _check_block(params, states[opt], config, opt, lrs[opt])
    torch.cuda.empty_cache()
    _times(params, states, config, lrs, batches)

    ada_step = make_train_step_opt(config, optimizer="adagrad",
                                   lr=lrs["adagrad"])

    def adagrad_steps(data):
        for b in data:
            float(ada_step(params, states["adagrad"], *_to_dev(b)))

    _profile_steps("fused Adagrad steps", adagrad_steps, batches)
    print(f"optimizer phases: peak device memory "
          f"{torch.cuda.max_memory_allocated(DEV) / 1e9:.2f} GB (tables, the "
          f"Adagrad accumulator, and for a while a clone of the tables)")
    del params, states
    torch.cuda.empty_cache()


def _rss() -> int:
    """Bytes of the host's resident set (VmRSS)."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("no VmRSS in /proc/self/status")


class _PeakRss:
    """The host's peak resident set over the body, from VmRSS read every
    2 ms by a thread (the card's machine keeps no VmHWM)."""

    def __enter__(self):
        self.peak, self._stop = _rss(), threading.Event()

        def sample():
            while not self._stop.wait(0.002):
                self.peak = max(self.peak, _rss())

        self._thread = threading.Thread(target=sample, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=10)
        check(not self._thread.is_alive(), "RSS sampler did not stop")
        self.peak = max(self.peak, _rss())


def _cached() -> int:
    """Bytes of the page cache (``Cached`` of /proc/meminfo)."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("Cached:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("no Cached in /proc/meminfo")


def _evict(path: Path) -> str:
    """Asks the kernel to drop the file ``path``, or the files under it,
    from the page cache (they are on disk: the save fsyncs them), so that
    a read goes to the disk; returns what a read of them then measures, as
    a label: the page cache dropped only where ``Cached`` fell by at least
    90% of their bytes."""
    files = [path] if path.is_file() else [f for f in path.rglob("*")
                                           if f.is_file()]
    nbytes, before = 0, _cached()
    for f in files:
        nbytes += f.stat().st_size
        fd = os.open(f, os.O_RDONLY)
        try:
            os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
        finally:
            os.close(fd)
    fell = before - _cached()
    state = "page cache dropped" if fell >= 0.9 * nbytes else \
        "page cache state unknown"
    return f"{state}: Cached fell by {fell} B for {nbytes} B of files"


def phase_checkpoint() -> None:
    """Kaggle fs=128 at full width, f32, fused, B=32768, row-wise Adagrad:
    2 steps, a save through `CheckpointManager`, 2 more steps; a restore
    into the same tensors, which must give back every saved tensor, and the
    same 2 steps again, every step under `_deterministic()`: equal bits of
    the losses and of every tensor.  Bytes, seconds, GB/s and the host's
    peak resident set of the save and of the restore (after `_evict`)."""
    from dlrm_tpu_torch import init_params, kaggle_config
    from dlrm_tpu_torch.data.synthetic import batch_stream
    from dlrm_tpu_torch.io.checkpoint import BUFFER_BYTES, CheckpointManager
    from dlrm_tpu_torch.train.train import init_opt_state, make_train_step_opt

    config = kaggle_config(feature_size=128, interaction_impl="fused")
    torch.cuda.reset_peak_memory_stats(DEV)
    params = init_params(torch.Generator(DEV).manual_seed(config.seed),
                         config, DEV)
    state = {"params": params, "opt": init_opt_state(
        params, config=config, optimizer="rowwise_adagrad")}
    tensors = _tensors(state)
    step = make_train_step_opt(config, optimizer="rowwise_adagrad", lr=0.001)
    batches = list(batch_stream(config, TRAIN_BATCH, 4, seed=41))
    nbytes = _tensor_bytes(state)

    def run(data):
        with _deterministic():
            return [float(step(params, state["opt"], *_to_dev(b)))
                    for b in data]

    with _scratch() as tmp:
        free = shutil.disk_usage(tmp).free
        check(free > nbytes + (1 << 30), f"checkpoint phase: {free} B free "
              f"under {tmp}, the checkpoint needs {nbytes} B (and 1 GiB to "
              f"spare)")
        with counted("checkpoint and resume", 6, 6, dense=6, sparse=6):
            first = run(batches[:2])
            # the whole state as saved, on the card beside it
            saved = [t.clone() for t in tensors]
            mgr = CheckpointManager(tmp / "ck", save_interval=2,
                                    max_to_keep=1)
            rss0 = _rss()
            torch.cuda.synchronize()
            with _PeakRss() as save_rss:
                t0 = time.perf_counter()
                check(mgr.maybe_save(2, state), "maybe_save(2) did not save")
                save_s = time.perf_counter() - t0
            written = sum(f.stat().st_size for f in (tmp / "ck").rglob("*")
                          if f.is_file())
            want = run(batches[2:])
            after = [t.clone() for t in tensors]
            cache = _evict(tmp / "ck")
            with _PeakRss() as restore_rss:
                t0 = time.perf_counter()
                restored, at = mgr.restore_latest(out=state)
                torch.cuda.synchronize()
                restore_s = time.perf_counter() - t0
            state["opt"]["count"] = restored["opt"]["count"]
            check(at == 2 and restored["params"]["emb"] is params["emb"]
                  and state["opt"]["count"] == 2,
                  f"restored step {at}, count {state['opt']['count']}")
            back = [i for i, (t, s) in enumerate(zip(tensors, saved))
                    if not torch.equal(t, s)]
            check(not back, f"restored tensors {back} of {len(tensors)} "
                  f"differ from the saved ones")
            del saved
            got = run(batches[2:])
            mgr.close()
        disk = _io_rates(tmp)
    again = [i for i, (t, a) in enumerate(zip(tensors, after))
             if not torch.equal(t, a)]
    check(got == want and not again, f"resume: losses {got} vs {want}, "
          f"tensors {again} of {len(tensors)} differ")
    print(f"checkpoint: Kaggle fs=128, f32, row-wise Adagrad at B="
          f"{TRAIN_BATCH} under deterministic sums; losses {first + want}; "
          f"the restore gave back every saved tensor bit for bit (the "
          f"{config.total_rows} rows of the tables and of their "
          f"accumulator, the dense state), and resumed at step 2 the 2 "
          f"steps give the same loss bits and the same bits of every "
          f"tensor; interaction_fwd and interaction_bwd launched 6 times "
          f"each")
    print(f"checkpoint save: {written} B in {save_s:.2f} s = "
          f"{written / save_s / 1e9:.3f} GB/s (fsynced; {free} B were free); "
          f"restore ({cache}) into the same tensors "
          f"{restore_s:.2f} s = {written / restore_s / 1e9:.3f} GB/s; host "
          f"buffer {BUFFER_BYTES} B; host resident set before "
          f"{rss0 / 1e9:.3f} GB, peak during the save "
          f"{save_rss.peak / 1e9:.3f} GB, during the restore "
          f"{restore_rss.peak / 1e9:.3f} GB; peak device memory "
          f"{torch.cuda.max_memory_allocated(DEV) / 1e9:.2f} GB")
    print(f"the same disk alone, {disk['bytes']} B through one "
          f"{BUFFER_BYTES} B host buffer: write and fsync "
          f"{disk['write']:.3f} GB/s, read ({disk['cache']}) "
          f"{disk['read']:.3f} GB/s; the buffer pinned, copies from the card "
          f"{disk['d2h']:.2f} GB/s, to the card {disk['h2d']:.2f} GB/s; the "
          f"save ran at {written / save_s / 1e9 / disk['write']:.0%} of the "
          f"disk's write rate, the restore at "
          f"{written / restore_s / 1e9 / disk['read']:.0%} of its read rate")
    grew = max(save_rss.peak, restore_rss.peak) - rss0
    check(grew < 1 << 30, f"the host resident set grew by {grew} B during "
          f"the save or the restore")
    del params, state, tensors, after
    torch.cuda.empty_cache()


def _io_rates(tmp: Path, chunks: int = 64) -> dict:
    """GB/s of what a checkpoint rides on, without it: ``chunks`` writes
    of one ``BUFFER_BYTES`` host buffer to a file under ``tmp`` and an
    fsync, the file read back after `_evict` (``cache``: its label), and
    as many copies between the card and the buffer pinned."""
    from dlrm_tpu_torch.io.checkpoint import BUFFER_BYTES

    host = torch.randint(0, 255, (BUFFER_BYTES,), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(0))
    mv = memoryview(host.numpy())
    path = tmp / "io_rates.bin"
    nbytes = chunks * BUFFER_BYTES
    t0 = time.perf_counter()
    with open(path, "wb") as f:
        for _ in range(chunks):
            f.write(mv)
        f.flush()
        os.fsync(f.fileno())
    write_s = time.perf_counter() - t0
    cache = _evict(path)
    t0 = time.perf_counter()
    with open(path, "rb", buffering=0) as f:
        for _ in range(chunks):
            view = mv
            while len(view):
                view = view[f.readinto(view):]
    read_s = time.perf_counter() - t0
    path.unlink()
    pinned = host.pin_memory()
    card = torch.empty_like(pinned, device=DEV)
    out = {"bytes": nbytes, "write": nbytes / write_s / 1e9,
           "read": nbytes / read_s / 1e9, "cache": cache}
    for name, copy in (("d2h", lambda: pinned.copy_(card)),
                       ("h2d", lambda: card.copy_(pinned))):
        copy()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(chunks):
            copy()
        torch.cuda.synchronize()
        out[name] = nbytes / (time.perf_counter() - t0) / 1e9
    return out


def _tensors(tree) -> list:
    """Every tensor of a payload, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    return []


def _tensor_bytes(tree) -> int:
    """Bytes of every tensor in a payload."""
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def _scope_ms(run, batches, steps: int = 5) -> dict:
    """CUDA ms a step under each phase scope (``record_function``) of a
    `torch.profiler` run of ``steps`` steps after 3."""
    from torch.profiler import ProfilerActivity, profile

    run(batches[:3])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(batches[i % len(batches)] for i in range(steps))
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        if evt.key in _SCOPES \
                and evt.device_type == torch.autograd.DeviceType.CPU:
            out[evt.key] = evt.device_time_total / 1e3 / steps
    return out


def phase_telemetry() -> None:
    """Kaggle fs=128 at full width, SGD at B=32768, fused: the instrumented
    step against `train_step` from the same state (within 1e-5), the mean
    ms of every phase beside the unprofiled step, and the CUDA time under
    each phase scope of the profiled step."""
    from dlrm_tpu_torch import init_params, kaggle_config
    from dlrm_tpu_torch.data.synthetic import batch_stream
    from dlrm_tpu_torch.train.train import make_train_step
    from dlrm_tpu_torch.utils.telemetry import (InstrumentedTrainer,
                                                Recorder, donothing)

    config = kaggle_config(feature_size=128, interaction_impl="fused")
    params = init_params(torch.Generator(DEV).manual_seed(config.seed),
                         config, DEV)
    batches = list(batch_stream(config, TRAIN_BATCH, 6, seed=51))
    trainer = InstrumentedTrainer(config, 0.1)
    step = make_train_step(config, 0.1)
    snap = _Snapshot(params, None, _all_ids(batches[:1], config))
    with counted("instrumented step", 1, 1):
        got_loss = trainer.step(params, batches[0])
    got = snap.read()
    snap.restore()
    want_loss = float(step(params, *_to_dev(batches[0])))
    diff = max(_max_diff(got, snap.read()), abs(got_loss - want_loss))
    check(diff <= 1e-5, f"instrumented step vs train_step: {diff}")
    rec = Recorder()
    with counted("instrumented steps", 5, 5):
        for i, b in enumerate(batches[1:]):
            trainer.step(params, b, rec if i else donothing)
    plain = []
    for b in batches[1:] * 2:
        dev_b = _to_dev(b)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        float(step(params, *dev_b))
        plain.append((time.perf_counter() - t0) * 1e3)
    phases = rec.summary()
    print(f"instrumented SGD step at B={TRAIN_BATCH} vs train_step from the "
          f"same state: loss, touched rows and dense parameters within "
          f"{diff:.3g}; phase ms (mean of 4 steps after 1): "
          + ", ".join(f"{k} {v:.3f}" for k, v in phases.items())
          + f"; sum {sum(phases.values()):.3f} ms against the unprofiled "
          f"train_step's median {statistics.median(plain[2:]):.3f} ms (batch "
          f"on the card, loss read back)")

    def sgd(data):
        for b in data:
            float(step(params, *_to_dev(b)))

    scopes = _scope_ms(sgd, batches)
    check(set(scopes) == set(_SCOPES),
          f"profiled SGD step: phase scopes {sorted(scopes)}")
    print("profiled SGD step, CUDA ms a step under each phase scope "
          "(forward kernels; the backward runs outside them): "
          + ", ".join(f"{k} {v:.3f}" for k, v in scopes.items()))
    del params, snap
    torch.cuda.empty_cache()


# -- the sharded path --------------------------------------------------------

SHARD_MAX_ROWS = 6_000_000  # row-shards tables 2, 11 and 20
SHARD_COLS = (15,)          # 5,461,306 rows, column-sharded
SHARD_STEPS = 10


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _host_step_ms(step, batches, steps: int = SHARD_STEPS,
                  warmup: int = 3) -> float:
    """Median host-to-host ms of ``steps`` steps after ``warmup``: the
    batch copied in, ``step(dense, sparse, labels)``, its loss read
    back."""
    secs = []
    for i in range(warmup + steps):
        t0 = time.perf_counter()
        float(step(*_to_dev(batches[i % len(batches)])))
        secs.append(time.perf_counter() - t0)
    return statistics.median(secs[warmup:]) * 1e3


def _sharded_serving(params, sh, mesh, p, config) -> None:
    """The sharded forward against `forward`, then `sharded_evaluate`
    against `evaluate` with a ragged tail."""
    from dlrm_tpu_torch.data.synthetic import batch_stream, random_batch
    from dlrm_tpu_torch.models.dlrm import forward
    from dlrm_tpu_torch.train.metrics import (evaluate,
                                              make_sharded_eval_forward,
                                              sharded_evaluate)

    fwd = make_sharded_eval_forward(config, mesh, p)
    batches = list(batch_stream(config, BATCH, MAIN_BATCHES, seed=71))

    def sharded(dense, sparse):
        return fwd(sh, sh["emb"], sh["emb_cs"], dense, sparse)

    def single(dense, sparse):
        with torch.no_grad():
            return forward(params, dense, sparse, config)

    def scores(serve, batch):
        dense, sparse, _ = _to_dev(batch)
        return serve(dense, sparse).cpu()

    with counted("sharded serving", len(batches), 0):
        preds = [scores(sharded, b) for b in batches]
    diff = max((got - scores(single, b)).abs().max().item()
               for b, got in zip(batches, preds))
    check(diff <= 1e-6, f"sharded serving vs forward: {diff}")
    ms = {"single-device": [], "sharded": []}
    for name, serve in (("single-device", single), ("sharded", sharded),
                        ("sharded", sharded), ("single-device", single)):
        secs = []
        for b in batches:
            t0 = time.perf_counter()
            scores(serve, b)
            secs.append(time.perf_counter() - t0)
        ms[name].append(statistics.median(secs[1:]) * 1e3)
    print(f"sharded serving: {len(batches)} batches of {BATCH}, "
          f"interaction_fwd launched {len(batches)} times; against forward "
          f"on the unsharded tables max |diff| {diff:.3g}; ms a batch host "
          f"to host (ids and dense copied in, scores out; median of "
          f"{len(batches) - 1} after 1) in turns, single-device / sharded / "
          f"sharded / single-device: {ms['single-device'][0]:.3f} / "
          f"{ms['sharded'][0]:.3f} / {ms['sharded'][1]:.3f} / "
          f"{ms['single-device'][1]:.3f}")
    data = batches[:4] + [random_batch(np.random.default_rng(72), config,
                                       107)]
    with counted("sharded evaluation", len(data), 0):
        got = sharded_evaluate(sh, data, config, mesh=mesh, placement=p)
    want = evaluate(params, data, config)
    check(got["examples"] == want["examples"]
          == sum(len(b["labels"]) for b in data)
          and got["accuracy"] == want["accuracy"]
          and got["auc"] == want["auc"]
          and abs(got["loss"] - want["loss"]) <= 1e-6,
          f"sharded_evaluate {got} vs evaluate {want}")
    print(f"sharded_evaluate over {got['examples']} rows (a ragged tail of "
          f"107) against evaluate: accuracy {got['accuracy']:.6f} and AUC "
          f"{got['auc']:.6f} the same, loss {got['loss']:.6f} (|diff| "
          f"{abs(got['loss'] - want['loss']):.3g})")


def phase_sharded() -> None:
    """The sharded path at full width (Kaggle fs=128, f32, fused) under
    NCCL at world size 1, in this process: the placement (tables 2, 11 and
    20 row-sharded, 15 column-sharded, 22 in slots), the tables laid out by
    shard on the card; the sharded lookup against the plain one at
    B=16384, f32 and bf16 exchange; sharded serving and `sharded_evaluate`
    against `forward` and `evaluate`; one sharded SGD step at B=32768
    against `train_step` from one state under deterministic sums, bit for
    bit (loss, rows of each placement kind, each seen to move, dense
    parameters, trash row); step times and device
    peaks in turns with the single-device step, and a profile of the
    sharded step."""
    import torch.distributed as dist
    from dlrm_tpu_torch import kaggle_config
    from dlrm_tpu_torch.parallel import mesh as pmesh

    dev = pmesh.init_distributed(f"127.0.0.1:{_free_port()}", 1, 0,
                                 device=DEV)
    check(dist.get_backend() == "nccl" and dist.get_world_size() == 1
          and dev == DEV, f"process group {dist.get_backend()} of "
          f"{dist.get_world_size()} on {dev}")
    try:
        _sharded(pmesh.make_mesh(), kaggle_config(
            feature_size=128, interaction_impl="fused"))
    finally:
        dist.destroy_process_group()
        torch.cuda.empty_cache()


def _sharded(mesh, config) -> None:
    """The body of :func:`phase_sharded` on ``mesh``."""
    from dlrm_tpu_torch import init_params
    from dlrm_tpu_torch.data.synthetic import batch_stream
    from dlrm_tpu_torch.ops.embedding import lookup
    from dlrm_tpu_torch.parallel import embedding as pemb
    from dlrm_tpu_torch.parallel.placement import plan_placement
    from dlrm_tpu_torch.train.train import (broadcast_dense,
                                            make_sharded_train_step,
                                            train_step)

    p = plan_placement(config.table_sizes, 1,
                       max_rows_per_shard=SHARD_MAX_ROWS,
                       col_sharded_tables=SHARD_COLS)
    check(p.row_sharded == (2, 11, 20) and p.col_sharded == SHARD_COLS
          and len(p.slot_table_list) == 22, f"placement {p}")
    params = init_params(torch.Generator(DEV).manual_seed(config.seed),
                         config, DEV)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sh = {**_clone_dense(params),
          "emb": pemb.shard_tables(params["emb"], p, config)[0],
          "emb_cs": tuple(c[0] for c in pemb.shard_col_tables(
              params["emb"], p, config))}
    broadcast_dense(sh)
    torch.cuda.synchronize()
    print(f"sharded, NCCL world size 1 on {torch.cuda.get_device_name(0)}: "
          f"{len(p.slot_table_list)} slot tables, row-sharded "
          f"{list(p.row_sharded)}, column-sharded {list(p.col_sharded)}; "
          f"local stack {p.local_rows} rows "
          f"({sh['emb'].numel() * 4 / 1e9:.2f} GB) + column shards "
          f"{sum(c.numel() for c in sh['emb_cs']) * 4 / 1e9:.2f} GB, laid "
          f"out on the card in {time.perf_counter() - t0:.2f} s")

    ids = torch.from_numpy(next(batch_stream(config, BATCH, 1, seed=70))[
        "sparse"]).to(DEV)
    want = lookup(params["emb"], ids, config.table_offsets)
    got = pemb.sharded_lookup(sh["emb"], ids, mesh=mesh, placement=p,
                              cs=sh["emb_cs"])
    diff = (got - want).abs().max().item()
    bf16 = pemb.sharded_lookup(sh["emb"], ids, mesh=mesh, placement=p,
                               cs=sh["emb_cs"],
                               exchange_dtype=torch.bfloat16)
    rounded = want.to(torch.bfloat16).float()
    # one-hot: the bf16 exchange is the f32 lookup rounded once
    check(diff <= 1e-6 and torch.equal(bf16, rounded),
          f"sharded lookup vs lookup {diff}; bf16 exchange vs the rounded "
          f"lookup {(bf16 - rounded).abs().max().item()}")
    rel = ((bf16 - want).abs() / want.abs().clamp_min(1e-30)).max().item()
    print(f"sharded lookup at B={BATCH} against ops.embedding.lookup: max "
          f"|diff| {diff:.3g}; bf16 exchange equal to the f32 lookup "
          f"rounded once to bf16 (relative error up to {rel:.3g}, bound "
          f"2^-8 = {2 ** -8:.3g})")
    del want, got, bf16, rounded

    _sharded_serving(params, sh, mesh, p, config)

    batches = list(batch_stream(config, TRAIN_BATCH, 4, seed=73))
    b = _to_dev(batches[0])
    touched = _touched_by_kind(_all_ids(batches[:1], config), p, config)
    before = {kind: params["emb"][rows] for kind, rows in touched.items()}
    step = make_sharded_train_step(config, 0.1, mesh, p)
    with _deterministic():
        with counted("sharded SGD step", 1, 1):
            loss_s = float(step(sh, *b))
        loss_1 = float(train_step(params, *b, config=config, lr=0.1))
    torch.cuda.synchronize()
    loss_diff = abs(loss_s - loss_1)
    dense_diff = _max_dense_diff(sh, params)
    full = pemb.unshard_tables(sh["emb"][None], p, config)
    for j, t in enumerate(p.col_sharded):
        go = config.table_offsets[t]
        full[go:go + config.table_sizes[t]] = pemb.unshard_col_tables(
            [sh["emb_cs"][j][None]], p)[0]
    # per placement kind: how far train_step moved its touched rows, and
    # how far the sharded step's rows are from train_step's
    moved, row_diff = {}, {}
    for kind, rows in touched.items():
        want = params["emb"][rows]
        moved[kind] = (want - before[kind]).abs().max().item()
        row_diff[kind] = (full[rows] - want).abs().max().item()
    all_diff = _chunked_max_diff(full, params["emb"])
    trash = sh["emb"][p.trash_row].abs().max().item()
    del full, before
    torch.cuda.empty_cache()
    # an update moves a row of a 10M-row table by about 1e-7, under any
    # float tolerance, so the step is held to the single-device bits
    # (both sides run the same kernels in the same order under
    # deterministic sums), and every kind's rows must have moved
    check(loss_diff == 0.0 and dense_diff == 0.0 and all_diff == 0.0
          and trash == 0.0 and all(d == 0.0 for d in row_diff.values())
          and all(m > 0.0 for m in moved.values()),
          f"sharded vs single-device step: loss {loss_diff}, dense "
          f"{dense_diff}, touched rows {row_diff} (moved {moved}), all "
          f"rows {all_diff}, trash row {trash}")
    print(f"sharded SGD step at B={TRAIN_BATCH} against train_step from one "
          f"state (deterministic sums, held bit for bit): loss {loss_s:.6f} "
          f"(|diff| {loss_diff:.3g}), dense parameters {dense_diff:.3g}, "
          f"all rows {all_diff:.3g} through unshard_tables, trash row "
          f"{trash}; touched rows by kind: " + ", ".join(
              f"{kind} {touched[kind].numel()} moved up to {moved[kind]:.3g}"
              f" (|diff| {row_diff[kind]:.3g})" for kind in touched))

    single = functools.partial(train_step, params, config=config, lr=0.1)
    sharded = functools.partial(step, sh)
    resident = torch.cuda.memory_allocated(DEV)
    peaks = {}
    for name, fn in (("single-device", single), ("sharded", sharded)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(DEV)
        for batch in batches[:2]:
            float(fn(*_to_dev(batch)))
        peaks[name] = torch.cuda.max_memory_allocated(DEV) - resident
    ms = {"single-device": [], "sharded": []}
    for name, fn in (("single-device", single), ("sharded", sharded),
                     ("sharded", sharded), ("single-device", single)):
        ms[name].append(_host_step_ms(fn, batches))
    print(f"SGD step at B={TRAIN_BATCH}, ms host to host in turns "
          f"(single-device, sharded, sharded, single-device; median of "
          f"{SHARD_STEPS} after 3): {ms['single-device'][0]:.3f} / "
          f"{ms['sharded'][0]:.3f} / {ms['sharded'][1]:.3f} / "
          f"{ms['single-device'][1]:.3f}; device peak net of both resident "
          f"copies of the tables ({resident / 1e9:.2f} GB): single-device "
          f"{peaks['single-device'] / 1e9:.3f} GB, sharded "
          f"{peaks['sharded'] / 1e9:.3f} GB")
    groups = _profile_steps("sharded SGD steps", lambda data: [
        float(sharded(*_to_dev(batch))) for batch in data], batches,
        groups=(("NCCL kernels", ("ncclDevKernel", "ncclKernel")),
                ("device-to-device copies (Memcpy DtoD)",
                 ("Memcpy DtoD",))))
    check(groups is not None and groups["interaction_fwd kernel"] > 0
          and groups["interaction_bwd kernel"] > 0,
          f"the sharded step's profile names no interaction kernel: "
          f"{groups}")
    _count_collectives(sharded, b, mesh, p, config, groups)
    del params, sh


def _world1_collectives(config, p, rows: int) -> list:
    """What placement ``p`` says one sharded SGD step of ``rows`` rows
    issues at world size 1, in issue order, as (kind, dtype, payload
    bytes): the ids' all-gather, the slot all-to-all, the row shards'
    reduce-scatter and an all-to-all a column shard; the all-reduce of the
    dense gradients and the loss; the update's ids all-gather, the slot
    all-to-all, the row shards' all-gather and an all-to-all a column
    shard.  f32 exchange, int32 ids, one-hot."""
    t, d = config.num_tables, config.feature_size
    k, n_rs = p.slots_per_shard, len(p.row_sharded)
    dense = sum(a * b + b for s in (config.bottom_mlp_sizes,
                                    config.full_top_mlp_sizes)
                for a, b in zip(s[:-1], s[1:]))
    ids = ("all-gather", "s32", rows * t * 4)
    slots = [("all-to-all", "f32", rows * k * d * 4)] * bool(
        p.slot_table_list)
    cols = [("all-to-all", "f32", rows * d * 4)] * len(p.col_sharded)
    return ([ids] + slots + [("reduce-scatter", "f32", rows * n_rs * d * 4)]
            * bool(n_rs) + cols
            + [("all-reduce", "f32", (dense + 1) * 4)]
            + [ids] + slots + [("all-gather", "f32", rows * n_rs * d * 4)]
            * bool(n_rs) + cols)


def _count_collectives(sharded, batch, mesh, p, config, groups) -> None:
    """One more sharded step under ``parallel/audit.py``'s counter and the
    profiler: its collectives, counted as the step issued them, must be
    what the placement says (world size 1: every group of 1, no link
    bytes); they are printed beside the profile's NCCL kernel and
    device-to-device copy times a step (``groups``: device us over
    `_profile_steps`'s 5 steps), and this step's own copies and NCCL
    kernels are listed under the NCCL range (``nccl:<op>``) that spans
    each, in the order they ran."""
    from torch.profiler import ProfilerActivity, profile

    from dlrm_tpu_torch.parallel import audit

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with counted("sharded SGD step under the collective counter", 1, 1):
            loss, records = audit.count_collectives(
                mesh, lambda: float(sharded(*batch)))
        torch.cuda.synchronize()
    got = [(c.kind, c.dtype, c.result_bytes) for c in records]
    want = _world1_collectives(config, p, TRAIN_BATCH)
    check(got == want and all(c.group_size == 1 for c in records)
          and sum(c.link_bytes for c in records) == 0.0
          and np.isfinite(loss),
          f"the sharded step issued "
          f"{[dataclasses.astuple(c) for c in records]} (loss {loss}); the "
          f"placement says {want}")
    print(f"sharded SGD step's collectives as issued, counted by "
          f"parallel/audit.py (NCCL, world size 1; op dtype payload bytes, "
          f"as the placement says): " + ", ".join(
              f"{k} {dt} {nb}" for k, dt, nb in got)
          + f"; {len(got)} collectives, "
          f"{sum(nb for _, _, nb in got) / 1e6:.3f} MB of payload, 0 link "
          f"bytes at N=1; beside them the profile's NCCL kernels "
          f"{groups['NCCL kernels'] / 5e3:.3f} ms and device-to-device "
          f"copies "
          f"{groups['device-to-device copies (Memcpy DtoD)'] / 5e3:.3f} ms "
          f"a step")
    cuda = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    ranges = sorted((e.time_range.start, e.time_range.end, e.name)
                    for e in cuda if e.name.startswith(_NCCL_RANGE))
    work = sorted((e.time_range.start, e.time_range.end, e.name.split("(")[0],
                   e.time_range.elapsed_us()) for e in cuda
                  if "Memcpy DtoD" in e.name or "ncclDevKernel" in e.name
                  or "ncclKernel" in e.name)
    if not ranges:
        print("the counted step's NCCL ranges: the profiler recorded none "
              "(not measured)")
        return
    # each copy or NCCL kernel under the NCCL range that spans it
    under = {}
    for a, b, name, us in work:
        owner = next((r for r in ranges if r[0] <= a and b <= r[1]), None)
        under.setdefault(owner, []).append((name, us))
    a2a = sum(nb for k, _, nb in got if k == "all-to-all")
    us_of = {k: sum(us for r, items in under.items()
                    if r is not None and ("all_to_all" in r[2]) == k
                    for _, us in items) for k in (True, False)}
    rate = a2a / max(us_of[True], 1e-9) / 1e6
    print("the counted step's device work under NCCL's ranges, in the order "
          "it ran (us): " + "; ".join(
              f"{r[2]}: " + ", ".join(f"{n.strip()} {us:.1f}"
                                      for n, us in under.get(r, []))
              for r in ranges)
          + "; outside them: " + (", ".join(
              f"{n.strip()} {us:.1f}" for n, us in under.get(None, []))
              or "nothing")
          + f". The all-to-alls' {a2a / 1e6:.3f} MB took "
          f"{us_of[True] / 1e3:.3f} ms ({rate:.3f} TB/s copied), the other "
          f"collectives' "
          f"{(sum(nb for _, _, nb in got) - a2a) / 1e6:.3f} MB "
          f"{us_of[False] / 1e3:.3f} ms")


# -- sharded optimizers, blocks, host rows and the replica check -------------

SHARD_OPT_LR = 0.01
SHARD_HOST_TABLES = (2, 11, 20)   # 25,529,367 rows, 13.07 GB, on the host
SHARD_HOST_MAX_ROWS = 2_000_000   # row-shards table 3 (2,202,608 rows)
SHARD_KINDS = ("slot", "row-sharded", "host row-sharded", "column-sharded")


def _placed(p, config, rows: torch.Tensor) -> list:
    """Where the stacked-table ``rows`` live at world size 1: (kind, the
    positions in ``rows``, the tensor key ``emb`` / ``cs<j>`` / ``h``, the
    local rows of that tensor), a table at a time."""
    starts = torch.tensor(config.table_offsets, device=rows.device)
    table = torch.searchsorted(starts, rows, right=True) - 1
    out = []
    for t in range(config.num_tables):
        sel = (table == t).nonzero()[:, 0]
        if not sel.numel():
            continue
        local = rows[sel] - config.table_offsets[t]
        if t in p.col_sharded:
            out.append(("column-sharded", sel,
                        f"cs{p.col_sharded.index(t)}", local))
        elif t in p.row_sharded:
            k = p.row_sharded.index(t)
            out.append(("host row-sharded" if p.rs_host[k] else
                        "row-sharded", sel, "h" if p.rs_host[k] else "emb",
                        local + p.rs_local_offsets[k]))
        else:
            out.append(("slot", sel, "emb",
                        local + int(p.table_local_offsets[t])))
    return out


def _shard_tensors(emb, cs, h) -> dict:
    """A rank's stacks (tables, or their accumulators) by the keys of
    :func:`_placed`."""
    return {"emb": emb, "h": h, **{f"cs{j}": c for j, c in enumerate(cs)}}


def _read_placed(placed: list, tensors: dict, n: int) -> torch.Tensor:
    """The values of the rows of :func:`_placed` (host rows copied to the
    card), in the order of the rows it was given."""
    first = tensors["emb"]
    out = torch.empty((n, *first.shape[1:]), dtype=torch.float32, device=DEV)
    for _, sel, key, local in placed:
        src = tensors[key]
        out[sel] = src.index_select(0, local.to(src.device)).to(DEV).float()
    return out


def _shard_params(params, p, config) -> dict:
    """Rank 0's sharded copy of single-device parameters at world size 1:
    the stacks on the card, the host stack written into registered host
    memory."""
    from dlrm_tpu_torch.parallel import embedding as pemb
    from dlrm_tpu_torch.parallel.host_tier import _host_empty

    sh = {**_clone_dense(params),
          "emb": pemb.shard_tables(params["emb"], p, config)[0],
          "emb_cs": tuple(c[0] for c in pemb.shard_col_tables(
              params["emb"], p, config))}
    if p.host_row_sharded:
        sh["emb_h"] = pemb.shard_host_tables(
            params["emb"], p, config, shard=0, out=_host_empty(
                (p.host_local_rows, config.feature_size), torch.float32,
                DEV))
    return sh


def _shard_state(state, p, config, optimizer: str) -> dict:
    """The sharded optimizer state (``init_sharded_opt_state``'s layout)
    holding a single-device state's accumulators, at world size 1."""
    from dlrm_tpu_torch.ops.embedding import tree_map
    from dlrm_tpu_torch.parallel import embedding as pemb
    from dlrm_tpu_torch.parallel.host_tier import _host_empty

    rowwise = optimizer == "rowwise_adagrad"
    acc = state["emb"][:, None] if rowwise else state["emb"]
    out = {"dense": tree_map(lambda t: t.clone(), state["dense"]),
           "count": state["count"],
           "emb_acc": pemb.shard_tables(acc, p, config)[0],
           "emb_acc_h": None}
    if rowwise:  # a column-sharded table's: its rows' scalars, whole
        out["emb_acc"] = out["emb_acc"][:, 0].contiguous()
        out["emb_acc_cs"] = tuple(
            state["emb"][config.table_offsets[t]:config.table_offsets[t]
                         + config.table_sizes[t]].clone()
            for t in p.col_sharded)
    else:
        out["emb_acc_cs"] = tuple(
            c[0] for c in pemb.shard_col_tables(acc, p, config))
    if p.host_row_sharded:
        host = _host_empty((p.host_local_rows, *acc.shape[1:]),
                           torch.float32, DEV)
        pemb.shard_host_tables(acc, p, config, shard=0, out=host)
        out["emb_acc_h"] = host[:, 0] if rowwise else host
    return out


def _warm_opt(state: dict, seed: int) -> None:
    """Accumulators drawn from [1e-6, 2e-6): a step is well conditioned
    (its move lr * g / 1e-3), and a hit's g^2 (1e-11 to 1e-9 at B=32768)
    moves an accumulator by hundreds of its f32 spacings, so a dropped
    or doubled update shows."""
    from dlrm_tpu_torch.ops.embedding import tree_leaves

    gen = torch.Generator(DEV).manual_seed(seed)
    for a in [state["emb"]] + tree_leaves(state["dense"]):
        a.uniform_(1e-6, 2e-6, generator=gen)


def _moves_agree(before, single, sharded, placed, what: str) -> dict:
    """Each kind's touched rows: both steps run the same sums in the same
    order (deterministic sums), so the sharded rows must hold the
    single-device bits; an update moves a row by as little as 2e-13 (an
    accumulator), under any float tolerance, so every kind must also have
    moved.  Returns the print-out per kind: rows, largest move, largest
    |diff|."""
    out = {}
    for kind in SHARD_KINDS:
        if not any(k == kind for k, _, _, _ in placed):
            continue
        sel = torch.cat([s for k, s, _, _ in placed if k == kind])
        w1, ws = single[sel], sharded[sel]
        largest = (w1 - before[sel]).abs().max().item()
        err = (ws - w1).abs().max().item()
        out[kind] = (sel.numel(), largest, err)
        check(largest > 0 and torch.equal(ws, w1),
              f"{what}, {kind} rows: moved up to {largest}, off the "
              f"single-device rows by up to {err}")
    return out


def _report(what: str, kinds: dict) -> str:
    return f"{what}: " + "; ".join(
        f"{kind} {n} rows moved up to {m:.3g} (|diff| {e:.3g})"
        for kind, (n, m, e) in kinds.items())


@contextlib.contextmanager
def _split_dedup_apply():
    """Single-device steps on the split, dedup and apply of
    ``optim.apply_sparse_adagrad`` for the duration (the sorted segment
    sum's route off): the sums the sharded steps run, in their order."""
    from dlrm_tpu_torch.train import optim as O

    devices = O.CARD_DEVICES
    O.CARD_DEVICES = ()
    try:
        yield
    finally:
        O.CARD_DEVICES = devices


def _sharded_vs_single(params, state, sh, st, p, mesh, config,
                       optimizer: str, batch, gather: int,
                       update: int) -> None:
    """One sharded step against one single-device step from the same
    state, under deterministic sums, bit for bit: each kind's rows and
    accumulators (``_moves_agree``), the loss, the dense parameters and
    their accumulators; the trash rows of both stacks and their
    accumulators 0.  The single-device step takes the split, dedup and
    apply that the sharded step runs (``_split_dedup_apply``); the sorted
    segment sum is held to that path in ``sparse_adagrad_kernel``."""
    from dlrm_tpu_torch.ops.embedding import tree_leaves
    from dlrm_tpu_torch.train.train import (sharded_train_step_opt,
                                            train_step_opt)

    rows = _all_ids([batch], config)
    placed = _placed(p, config, rows)
    w0, a0 = params["emb"][rows], state["emb"][rows]
    b = _to_dev(batch)
    with _deterministic():
        with counted(f"sharded {optimizer} step", 1, 1, gather, update,
                     _adagrad(optimizer, 1)):
            loss_s = float(sharded_train_step_opt(
                sh, st, *b, config=config, optimizer=optimizer,
                lr=SHARD_OPT_LR, mesh=mesh, placement=p))
        with _split_dedup_apply():
            loss_1 = float(train_step_opt(params, state, *b, config=config,
                                          optimizer=optimizer,
                                          lr=SHARD_OPT_LR))
    torch.cuda.synchronize()
    tables = _shard_tensors(sh["emb"], sh["emb_cs"], sh.get("emb_h"))
    accs = _shard_tensors(st["emb_acc"], st["emb_acc_cs"], st["emb_acc_h"])
    w = _moves_agree(w0, params["emb"][rows],
                     _read_placed(placed, tables, rows.numel()), placed,
                     f"sharded {optimizer} tables")
    a = _moves_agree(a0, state["emb"][rows],
                     _read_placed(placed, accs, rows.numel()), placed,
                     f"sharded {optimizer} accumulators")
    dense = _max_dense_diff(sh, params)
    dense_acc = max((x - y).abs().max().item() for x, y in zip(
        tree_leaves(st["dense"]), tree_leaves(state["dense"])))
    trash = [sh["emb"][p.trash_row], st["emb_acc"][p.trash_row]]
    if p.host_row_sharded:
        trash += [sh["emb_h"][-1], st["emb_acc_h"][-1]]
    check(loss_s == loss_1 and dense == 0.0 and dense_acc == 0.0
          and not any(bool(t.any()) for t in trash),
          f"sharded {optimizer} vs single-device: loss {loss_s} / {loss_1}, "
          f"dense {dense}, dense accumulators {dense_acc}, trash rows "
          f"{[t.abs().max().item() for t in trash]}")
    print(f"sharded {optimizer} step at B={TRAIN_BATCH} against "
          f"train_step_opt from one state (accumulators warm, deterministic "
          f"sums, held bit for bit): loss {loss_s:.6f} (|diff| {abs(loss_s - loss_1):.3g}), "
          f"dense parameters {dense:.3g}, their accumulators "
          f"{dense_acc:.3g}, trash rows and their accumulators 0")
    print("  " + _report("tables", w))
    print("  " + _report("accumulators", a))


class _ShardSnap:
    """The rows ``rows`` of every sharded stack and accumulator, the dense
    parameters and their accumulators, and the count, to read again and
    to put back."""

    def __init__(self, sh, st, p, config, rows):
        from dlrm_tpu_torch.ops.embedding import tree_leaves

        self.placed = _placed(p, config, rows)
        self.tensors = [_shard_tensors(sh["emb"], sh["emb_cs"],
                                       sh.get("emb_h")),
                        _shard_tensors(st["emb_acc"], st["emb_acc_cs"],
                                       st["emb_acc_h"])]
        self.whole = tree_leaves({"bottom": sh["bottom"],
                                  "top": sh["top"]}) + tree_leaves(
                                      st["dense"])
        self.st, self.count = st, st["count"]
        self.saved = self.read()

    def read(self) -> list:
        torch.cuda.synchronize()  # the card writes host rows in place
        out = []
        for tensors in self.tensors:
            for _, _, key, local in self.placed:
                src = tensors[key]
                out.append(src.index_select(0, local.to(src.device)))
        return out + [t.clone() for t in self.whole]

    def restore(self) -> None:
        torch.cuda.synchronize()
        it = iter(self.saved)
        for tensors in self.tensors:
            for _, _, key, local in self.placed:
                src = tensors[key]
                src.index_copy_(0, local.to(src.device), next(it))
        for t in self.whole:
            t.copy_(next(it))
        self.st["count"] = self.count


def _check_k1_block(sh, st, p, mesh, config, optimizer: str,
                    batch) -> None:
    """A K=1 sharded block against the sharded step from the same state:
    the same loss and the same bits everywhere."""
    from dlrm_tpu_torch.train.train import (sharded_train_block_opt,
                                            sharded_train_step_opt)

    snap = _ShardSnap(sh, st, p, config, _all_ids([batch], config))
    b = _to_dev(batch)
    kw = dict(config=config, optimizer=optimizer, lr=SHARD_OPT_LR,
              mesh=mesh, placement=p)
    with _deterministic():
        loss = float(sharded_train_step_opt(sh, st, *b, **kw))
        after_step = snap.read()
        snap.restore()
        with counted("sharded K=1 block", 1, 1,
                     dense=_adagrad(optimizer, 1)):
            loss_b = float(sharded_train_block_opt(
                sh, st, *(t[None] for t in b), **kw)[0])
    after_block = snap.read()
    same = loss == loss_b and all(torch.equal(x, y) for x, y in
                                  zip(after_step, after_block))
    moved = any(not torch.equal(x, y) for x, y in
                zip(after_block, snap.saved))
    check(same and moved, f"sharded K=1 {optimizer} block vs step: loss "
          f"{loss_b} / {loss}, bits {'equal' if same else 'differ'}, moved "
          f"{moved}")
    print(f"sharded K=1 {optimizer} block against the sharded step from one "
          f"state: the same loss ({loss:.6f}) and the same bits in "
          f"{len(after_step)} tensors of touched rows, dense parameters and "
          f"accumulators")


def _replica_check_s(sh, what: str) -> None:
    """make_dcn_replica_check on a 1 x 1 2-D mesh over ``sh``: True, its
    seconds, and the card's fold of a slice against the CPU's."""
    from dlrm_tpu_torch.parallel import embedding as pemb
    from dlrm_tpu_torch.parallel import mesh as pmesh

    check_fn = pemb.make_dcn_replica_check(pmesh.make_mesh_2d(1, 1))
    nbytes = sum(t.numel() * t.element_size() for t in
                 [sh["emb"], *sh["emb_cs"]]
                 + ([sh["emb_h"]] if sh.get("emb_h") is not None else []))
    check_fn(sh)  # the groups' first collectives
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ok = check_fn(sh)
    secs = time.perf_counter() - t0
    part = sh["emb"][:1 << 16]
    card = int(pemb._xor_fold(part, DEV))
    host = int(pemb._xor_fold(part.cpu(), torch.device("cpu")))
    check(ok and card == host, f"replica check {ok}; fold of a slice on "
          f"the card {card} against the CPU's {host}")
    print(f"replica check ({what}, 1 x 1 2-D mesh): True over "
          f"{nbytes / 1e9:.2f} GB in {secs:.3f} s ({nbytes / secs / 1e9:.1f} "
          f"GB/s); the card's fold of 2^16 rows equals the CPU's")


def _in_turns(single, sharded, batches, what: str) -> None:
    """Device peaks net of the resident tensors, then single-device,
    sharded, sharded, single-device ms a step host to host."""
    resident = torch.cuda.memory_allocated(DEV)
    peaks = {}
    for name, fn in (("single-device", single), ("sharded", sharded)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(DEV)
        for batch in batches[:2]:
            float(fn(*_to_dev(batch)))
        peaks[name] = torch.cuda.max_memory_allocated(DEV) - resident
    ms = {"single-device": [], "sharded": []}
    for name, fn in (("single-device", single), ("sharded", sharded),
                     ("sharded", sharded), ("single-device", single)):
        ms[name].append(_host_step_ms(fn, batches))
    print(f"{what} at B={TRAIN_BATCH}, ms host to host in turns "
          f"(single-device, sharded, sharded, single-device; median of "
          f"{SHARD_STEPS} after 3): {ms['single-device'][0]:.3f} / "
          f"{ms['sharded'][0]:.3f} / {ms['sharded'][1]:.3f} / "
          f"{ms['single-device'][1]:.3f}; device peak net of the resident "
          f"{resident / 1e9:.2f} GB: single-device "
          f"{peaks['single-device'] / 1e9:.3f} GB, sharded "
          f"{peaks['sharded'] / 1e9:.3f} GB")


def _block_turns(sh, st, p, mesh, config, optimizer: str,
                 batches) -> None:
    """K=4 sharded blocks against 4 sharded steps, in turns (steps,
    blocks, blocks, steps): ms a step host to host, median of 5 blocks (20
    steps) after 2."""
    from dlrm_tpu_torch.train.train import (make_sharded_train_block_opt,
                                            make_sharded_train_step_opt)

    kw = dict(optimizer=optimizer, lr=SHARD_OPT_LR, mesh=mesh, placement=p)
    step = make_sharded_train_step_opt(config, **kw)
    block = make_sharded_train_block_opt(config, **kw)
    stacked = [_stack(batches[i:i + BLOCK])
               for i in range(0, len(batches), BLOCK)]

    def run(k):
        secs = []
        for i in range(7):
            t0 = time.perf_counter()
            if k == 1:
                for b in batches[:BLOCK]:
                    loss = step(sh, st, *_to_dev(b))
            else:
                loss = block(sh, st, *_to_dev(stacked[i % len(stacked)]))[-1]
            float(loss)
            secs.append((time.perf_counter() - t0) * 1e3 / BLOCK)
        return statistics.median(secs[2:])

    ms = [run(k) for k in (1, BLOCK, BLOCK, 1)]
    print(f"sharded {optimizer}, K=1 steps against K={BLOCK} blocks in "
          f"turns (ms a step host to host): {ms[0]:.3f} / {ms[1]:.3f} / "
          f"{ms[2]:.3f} / {ms[3]:.3f}")


def phase_sharded_optim() -> None:
    """The sharded optimizers at full width (Kaggle fs=128, f32, fused)
    under NCCL at world size 1, in this process.  Row-wise Adagrad on
    phase 6's placement (tables on the card): one step from warm
    accumulators against `train_step_opt` from one state (each kind of
    touched row and its accumulator seen to move as the single-device one,
    trash rows 0), a K=1 block bit for bit against the step, the steps'
    times and device peaks in turns, K=4 blocks against 4 steps in turns,
    the replica check on a 1 x 1 2-D mesh.  Then elementwise Adagrad with
    tables 2, 11 and 20 in registered host memory (26.1 GB of tables and
    accumulators on the host; MemAvailable checked) and table 3
    row-sharded on the card: the lookup with host rows against the plain
    one, one step against `train_step_opt` as above (host_gather and
    host_update_rows launches counted), times and peaks in turns, a
    profile, the replica check over both stacks."""
    import torch.distributed as dist
    from dlrm_tpu_torch import init_params, kaggle_config
    from dlrm_tpu_torch.parallel import mesh as pmesh

    dev = pmesh.init_distributed(f"127.0.0.1:{_free_port()}", 1, 0,
                                 device=DEV)
    check(dist.get_backend() == "nccl" and dev == DEV,
          f"process group {dist.get_backend()} on {dev}")
    try:
        config = kaggle_config(feature_size=128, interaction_impl="fused")
        mesh = pmesh.make_mesh()
        params = init_params(torch.Generator(DEV).manual_seed(config.seed),
                             config, DEV)
        _sharded_rowwise(mesh, config, params)
        _release_pinned()
        _sharded_host_adagrad(mesh, config, params)
        del params
    finally:
        dist.destroy_process_group()
        _release_pinned()
        torch.cuda.empty_cache()


def _sharded_rowwise(mesh, config, params) -> None:
    from dlrm_tpu_torch.data.synthetic import batch_stream
    from dlrm_tpu_torch.parallel.placement import plan_placement
    from dlrm_tpu_torch.train.train import (init_opt_state,
                                            make_sharded_train_step_opt,
                                            make_train_step_opt)

    opt = "rowwise_adagrad"
    p = plan_placement(config.table_sizes, 1,
                       max_rows_per_shard=SHARD_MAX_ROWS,
                       col_sharded_tables=SHARD_COLS)
    state = init_opt_state(params, config=config, optimizer=opt)
    _warm_opt(state, 81)
    sh = _shard_params(params, p, config)
    st = _shard_state(state, p, config, opt)
    batches = list(batch_stream(config, TRAIN_BATCH, 2 * BLOCK, seed=83))
    _sharded_vs_single(params, state, sh, st, p, mesh, config, opt,
                       batches[0], 0, 0)
    _check_k1_block(sh, st, p, mesh, config, opt, batches[1])
    single = make_train_step_opt(config, optimizer=opt, lr=SHARD_OPT_LR)
    sharded = make_sharded_train_step_opt(config, optimizer=opt,
                                          lr=SHARD_OPT_LR, mesh=mesh,
                                          placement=p)
    _in_turns(functools.partial(single, params, state),
              functools.partial(sharded, sh, st), batches,
              "row-wise Adagrad step")
    groups = _profile_steps("sharded row-wise Adagrad steps",
                            lambda data: [float(sharded(sh, st, *_to_dev(b)))
                                          for b in data], batches,
                            groups=(("NCCL kernels", ("ncclDevKernel", "ncclKernel")),
                                    ("device-to-device copies (Memcpy DtoD)",
                                     ("Memcpy DtoD",))))
    check(groups is not None and groups["interaction_fwd kernel"] > 0,
          f"the sharded row-wise profile names no interaction kernel: "
          f"{groups}")
    # what the dense form of the column shards' row-wise update (a zeroed
    # (R_t, D/N) buffer a step, scattered into and read back) would at
    # least move: the buffer written twice and read twice
    dense_bytes = 4 * sum(config.table_sizes[t] * config.feature_size * 4
                          for t in p.col_sharded)
    print(f"  the column shards' row-wise update in the sparse form is under "
          f"the scope cs_adagrad above; the dense form would move at least "
          f"{dense_bytes / 1e9:.2f} GB a step, "
          f"{dense_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms at the HBM rate")
    _block_turns(sh, st, p, mesh, config, opt, batches)
    _replica_check_s(sh, "row-wise placement, tables on the card")
    del sh, st, state


def _sharded_host_adagrad(mesh, config, params) -> None:
    from dlrm_tpu_torch.data.synthetic import batch_stream
    from dlrm_tpu_torch.ops.embedding import lookup
    from dlrm_tpu_torch.parallel import embedding as pemb
    from dlrm_tpu_torch.parallel.placement import plan_placement
    from dlrm_tpu_torch.train.train import (init_opt_state,
                                            make_sharded_train_step_opt,
                                            make_train_step_opt)

    opt = "adagrad"
    p = plan_placement(config.table_sizes, 1,
                       max_rows_per_shard=SHARD_HOST_MAX_ROWS,
                       col_sharded_tables=SHARD_COLS,
                       host_tables=SHARD_HOST_TABLES)
    check(p.host_row_sharded == SHARD_HOST_TABLES
          and p.row_sharded == (2, 3, 11, 20), f"placement {p}")
    host_bytes = (p.host_local_rows * config.feature_size * 4)
    mem = _meminfo()
    print(f"sharded Adagrad with host rows: tables {list(p.host_row_sharded)}"
          f" ({host_bytes / 1e9:.2f} GB) and their accumulators "
          f"({host_bytes / 1e9:.2f} GB) in host memory; MemAvailable "
          f"{mem['MemAvailable']} B of MemTotal {mem['MemTotal']} B")
    check(mem["MemAvailable"] > 2 * host_bytes + 4 * GIB,
          f"the host cannot hold {2 * host_bytes} B of host stacks: "
          f"MemAvailable {mem['MemAvailable']} B")
    state = init_opt_state(params, config=config, optimizer=opt)
    _warm_opt(state, 85)
    t0 = time.perf_counter()
    sh = _shard_params(params, p, config)
    st = _shard_state(state, p, config, opt)
    torch.cuda.synchronize()
    print(f"  laid out in {time.perf_counter() - t0:.2f} s: local stack "
          f"{p.local_rows} rows ({sh['emb'].numel() * 4 / 1e9:.2f} GB), "
          f"column shards {sum(c.numel() for c in sh['emb_cs']) * 4 / 1e9:.2f}"
          f" GB, host stack {p.host_local_rows} rows, is_pinned() "
          f"{sh['emb_h'].is_pinned()}; the accumulators beside each")
    ids = torch.from_numpy(next(batch_stream(config, BATCH, 1, seed=86))[
        "sparse"]).to(DEV)
    with counted("sharded lookup with host rows", 0, 0, 1, 0):
        got = pemb.sharded_lookup(sh["emb"], ids, mesh=mesh, placement=p,
                                  cs=sh["emb_cs"], emb_h=sh["emb_h"])
    diff = (got - lookup(params["emb"], ids, config.table_offsets)).abs() \
        .max().item()
    check(diff == 0.0, f"sharded lookup with host rows vs lookup: {diff}")
    print(f"sharded lookup with host rows at B={BATCH} against "
          f"ops.embedding.lookup: max |diff| {diff} (host_gather launched "
          f"once)")
    del got
    batches = list(batch_stream(config, TRAIN_BATCH, 4, seed=87))
    _sharded_vs_single(params, state, sh, st, p, mesh, config, opt,
                       batches[0], 2, 2)
    single = make_train_step_opt(config, optimizer=opt, lr=SHARD_OPT_LR)
    sharded = functools.partial(make_sharded_train_step_opt(
        config, optimizer=opt, lr=SHARD_OPT_LR, mesh=mesh, placement=p),
        sh, st)
    _in_turns(functools.partial(single, params, state), sharded, batches,
              "Adagrad step, host rows")
    groups = _profile_steps("sharded Adagrad steps with host rows",
                            lambda data: [float(sharded(*_to_dev(b)))
                                          for b in data], batches,
                            groups=(("host_gather kernel",
                                     ("host_gather_kernel",)),
                                    ("host_update_rows kernel",
                                     ("host_update_rows_kernel",)),
                                    ("NCCL kernels", ("ncclDevKernel",
                                                      "ncclKernel")),
                                    ("device-to-device copies (Memcpy DtoD)",
                                     ("Memcpy DtoD",))))
    check(groups is not None and groups["host_gather kernel"] > 0
          and groups["host_update_rows kernel"] > 0
          and groups["interaction_fwd kernel"] > 0,
          f"the sharded Adagrad profile names no host-tier or interaction "
          f"kernel: {groups}")
    _replica_check_s(sh, "Adagrad placement, host rows through the card")
    del sh, st, state


# -- two-tier tables ---------------------------------------------------------

TIER_BUDGET_GB = 4        # Kaggle fs=128 f32: tables 2, 11 and 20 spill
TIER_HOST_ROWS = 25_529_367
TIER_STEPS = 8


def _meminfo() -> dict:
    """Bytes of every /proc/meminfo entry."""
    out = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, value = line.split(":", 1)
            out[key] = int(value.split()[0]) * 1024
    return out


def _pinned_rates(nbytes: int = 1 << 30) -> dict:
    """GB/s of one copy of ``nbytes`` between the card and a pinned host
    buffer, each way (CUDA events, median of 5 after 1): what the link
    gives a copy engine, printed beside the host-tier kernels' rates."""
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    card = torch.empty(nbytes, dtype=torch.uint8, device=DEV)
    out = {}
    for name, fn in (("h2d", lambda: card.copy_(host, non_blocking=True)),
                     ("d2h", lambda: host.copy_(card, non_blocking=True))):
        ms = statistics.median(time_ms(fn, warmup=1, reps=5, inner=1))
        out[name] = nbytes / ms / 1e6
    return out


# what a host tier's draw may add to the host's resident set besides the
# tier: far below the 4.11 GB by which a 16 GiB block exceeds the 13.07 GB
# tier
TIER_RSS_SLACK = 1 << 30


def _check_host_tier_size(host: torch.Tensor, host_bytes: int,
                          rss_grew: int) -> None:
    """The host tier takes its exact size: its storage is ``host_bytes``
    (the mapping under it rounds that up to a page, not to a power of
    two), it is registered with the card, and drawing it grew the host's
    resident set by its size."""
    import mmap

    nbytes = host.untyped_storage().nbytes()
    check(nbytes == host_bytes and host.data_ptr() % mmap.PAGESIZE == 0,
          f"host tier of {nbytes} B at {host.data_ptr():#x}, not "
          f"{host_bytes} B page-aligned")
    check(host.is_pinned(), "the registered host tier does not read as "
          "pinned (is_pinned() False)")
    check(host_bytes - TIER_RSS_SLACK <= rss_grew
          <= host_bytes + TIER_RSS_SLACK,
          f"drawing the {host_bytes} B host tier grew the host's resident "
          f"set by {rss_grew} B")
    block = 1 << (host_bytes - 1).bit_length()
    stats = {k: v for k, v in torch.cuda.host_memory_stats().items()
             if "reserved" in k and "current" in k} \
        if hasattr(torch.cuda, "host_memory_stats") else "not available"
    print(f"host tier: {nbytes} B registered at its exact size (a mapping "
          f"of {-(-nbytes // mmap.PAGESIZE) * mmap.PAGESIZE} B, pages of "
          f"{mmap.PAGESIZE} B; PyTorch's pinned allocator would reserve a "
          f"{block} B block), is_pinned() True; the draw grew the host's "
          f"resident set by {rss_grew} B; the pinned allocator's "
          f"reserved bytes {stats}")


def _release_pinned() -> None:
    """Hand host memory pinned for the card back to the system: the
    registered host tiers whose tensors the caller dropped (collected here,
    so that each unregisters and unmaps) and the blocks PyTorch's pinned
    allocator caches."""
    torch.cuda.synchronize()
    gc.collect()
    torch._C._host_emptyCache()


class _TierMap:
    """Rows of the logical stack -> rows of the two tiers' stacks."""

    def __init__(self, plan, config):
        offs, is_host = [0] * config.num_tables, [False] * config.num_tables
        for tables, offsets, host in ((plan.device_tables,
                                       plan.device_offsets, False),
                                      (plan.host_tables, plan.host_offsets,
                                       True)):
            for t, lo in zip(tables, offsets):
                offs[t], is_host[t] = lo, host
        self.starts = torch.tensor(config.table_offsets, device=DEV)
        self.offs = torch.tensor(offs, device=DEV)
        self.is_host = torch.tensor(is_host, device=DEV)

    def split(self, rows: torch.Tensor):
        """(whether each row is a host-tier row, its row in its tier)."""
        t = torch.searchsorted(self.starts, rows, right=True) - 1
        return self.is_host[t], rows - self.starts[t] + self.offs[t]


def _stack_rows(dev, host, tmap, rows) -> torch.Tensor:
    """Logical rows ``rows`` of a two-tier stack (tables or an
    accumulator) read from both tiers, on the card."""
    h, local = tmap.split(rows)
    out = torch.empty((rows.numel(), *dev.shape[1:]), dtype=dev.dtype,
                      device=DEV)
    out[~h] = dev[local[~h]]
    torch.cuda.synchronize()
    out[h] = host[local[h].cpu()].to(DEV)
    return out


class _TieredSnapshot:
    """The logical rows ``ids`` of both tiers (and of their accumulators),
    the dense parameters and their accumulators, and the step count: to
    read again and put back, so that two runs start from one state."""

    def __init__(self, params, opt_state, tmap, ids):
        self.params, self.opt = params, opt_state
        h, local = tmap.split(ids)
        self.dev_rows, self.host_rows = local[~h], local[h].cpu()
        self.saved = self.read()
        self.count = opt_state["count"] if opt_state else None

    def _tensors(self):
        from dlrm_tpu_torch.ops.embedding import tree_leaves

        emb = self.params["emb"]
        pairs = [(emb.dev, emb.host)]
        whole = tree_leaves({"bottom": self.params["bottom"],
                             "top": self.params["top"]})
        if self.opt and self.opt["dev_acc"] is not None:
            pairs.append((self.opt["dev_acc"], self.opt["host_acc"]))
            whole += tree_leaves(self.opt["dense"])
        return pairs, whole

    def read(self) -> list:
        torch.cuda.synchronize()
        pairs, whole = self._tensors()
        out = []
        for dev, host in pairs:
            out += [dev.index_select(0, self.dev_rows),
                    host.index_select(0, self.host_rows).to(DEV)]
        return out + [t.clone() for t in whole]

    def restore(self) -> None:
        torch.cuda.synchronize()
        pairs, whole = self._tensors()
        for i, (dev, host) in enumerate(pairs):
            dev.index_copy_(0, self.dev_rows, self.saved[2 * i])
            host.index_copy_(0, self.host_rows, self.saved[2 * i + 1].cpu())
        for t, old in zip(whole, self.saved[2 * len(pairs):]):
            t.copy_(old)
        if self.opt:
            self.opt["count"] = self.count


def _retier(tiered: dict, params: dict, config) -> None:
    """Copy all-device parameters into two-tier ones, table by table."""
    from dlrm_tpu_torch.ops.embedding import tree_leaves

    emb = tiered["emb"]
    plan = emb.plan
    for tables, offsets, stack in ((plan.device_tables, plan.device_offsets,
                                    emb.dev),
                                   (plan.host_tables, plan.host_offsets,
                                    emb.host)):
        for t, lo in zip(tables, offsets):
            n, go = config.table_sizes[t], config.table_offsets[t]
            stack[lo:lo + n].copy_(params["emb"][go:go + n])
    for a, b in zip(tree_leaves({"bottom": tiered["bottom"],
                                 "top": tiered["top"]}),
                    tree_leaves({"bottom": params["bottom"],
                                 "top": params["top"]})):
        a.copy_(b)


def _check_drawn_tiers(tiered: dict, params: dict, config) -> None:
    """Two-tier parameters drawn into their tiers hold the bits of the
    all-device ones drawn from the same seed: the dense towers and every
    table (host tables compared on the card a draw chunk at a time)."""
    from dlrm_tpu_torch.models.dlrm import INIT_CHUNK_ROWS

    emb = tiered["emb"]
    plan = emb.plan
    same = _max_dense_diff(tiered, params) == 0
    for tables, offsets, stack in ((plan.device_tables, plan.device_offsets,
                                    emb.dev),
                                   (plan.host_tables, plan.host_offsets,
                                    emb.host)):
        for t, lo in zip(tables, offsets):
            n, go = config.table_sizes[t], config.table_offsets[t]
            for a in range(0, n, INIT_CHUNK_ROWS):
                c = min(INIT_CHUNK_ROWS, n - a)
                same &= torch.equal(stack[lo + a:lo + a + c].to(DEV),
                                    params["emb"][go + a:go + a + c])
    check(same, "two-tier parameters drawn into their tiers differ from "
          "the all-device init of the same seed")


def _host_ids(plan, sparse: torch.Tensor) -> torch.Tensor:
    """The host tier's rows of a batch's ids (B, T): (B, T_host) int32."""
    offs = torch.tensor(plan.host_offsets, dtype=sparse.dtype, device=DEV)
    return sparse[:, list(plan.host_tables)] + offs


def _host_kernel_times(H, host, ids, uniq, pooled, ref, cols, rates
                       ) -> dict:
    """The host-tier kernels' times at the main path's shapes, taken before
    the host CPU touches any row of the tier (a row it has just read or
    written can read faster over PCIe): both kernels, then readings beside
    them (sequential ids: what such reads reach on this card and host;
    skewed ids; ids sorted beforehand; an update on shuffled ids), then
    the plain versions and one PyTorch call on the host each."""
    d = host.shape[1]
    rb = d * host.element_size()
    zeros = torch.zeros((uniq.numel(), d), device=DEV)  # adding 0 keeps bits
    kernels = {"host_gather": lambda: H.host_gather(host, ids, out=pooled,
                                                    cols=cols),
               "host_update_rows": lambda: H.host_update_rows(host, uniq,
                                                              zeros)}
    ms = {name: [] for name in kernels}
    for _ in range(2):
        for name, kern in kernels.items():
            ms[name] += time_ms(kern, warmup=2, reps=5, inner=10)
    flat = ids.reshape(-1)
    g = torch.Generator(DEV).manual_seed(73)
    hot = torch.randint(0, host.shape[0], (1000,), generator=g, device=DEV)
    skew = flat.clone()
    skew[::2] = hot[torch.randint(0, 1000, (skew[::2].numel(),), generator=g,
                                  device=DEV)].to(skew.dtype)
    shuffled = uniq[torch.randperm(uniq.numel(), generator=g, device=DEV)]
    readings = {
        "sequential ids 0..n-1": (torch.arange(flat.numel(), device=DEV),
                                  H.host_gather),
        "skewed ids (half from 1,000 hot rows)": (skew, H.host_gather),
        "ids sorted beforehand": (torch.sort(flat).values, H.host_gather),
        "update on shuffled ids": (shuffled, lambda t, i: H.host_update_rows(
            t, i, zeros))}
    read_ms = {}
    for name, (i, fn) in readings.items():
        read_ms[name] = statistics.median(time_ms(
            lambda: fn(host, i), warmup=2, reps=5, inner=10))
    zeros_host, uniq_host = zeros.cpu(), uniq.cpu()
    ids_host = flat.cpu()
    plains = {"host_gather": lambda: H.host_gather_reference(host, ids, ref,
                                                             cols),
              "host_update_rows": lambda: H.host_update_rows_reference(
                  host, uniq, zeros)}
    library = {"host_gather": lambda: host.index_select(0, ids_host),
               "host_update_rows": lambda: host.index_add_(0, uniq_host,
                                                           zeros_host)}
    out = {}
    for name in kernels:
        kern_ms = statistics.median(ms[name])
        plain_ms = statistics.median(time_ms(plains[name], warmup=1, reps=5,
                                             inner=3))
        # the gather reads its rows over PCIe and writes them to HBM with
        # the ids; the update reads and writes its rows over PCIe (each way
        # at the link's rate) and reads the ids and f32 updates from HBM
        n = flat.numel() if name == "host_gather" else uniq.numel()
        pcie_s = n * rb / PCIE_BYTES_PER_S
        hbm = n * (ids.element_size() + rb) if name == "host_gather" \
            else n * (uniq.element_size() + d * 4)
        bound_ms = max(pcie_s, hbm / HBM_BYTES_PER_S) * 1e3
        lib = []   # one PyTorch call on the host, its inputs already there
        for _ in range(5):
            t0 = time.perf_counter()
            library[name]()
            lib.append((time.perf_counter() - t0) * 1e3)
        library_ms = statistics.median(lib)
        out[name] = {"ms": kern_ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": "bytes",
                     "library_ms": library_ms}
        call = "index_select" if name == "host_gather" else "index_add_"
        print(f"  {name}: {n} rows of {rb} B, kernel {kern_ms:.4f} ms "
              f"({n * rb / kern_ms / 1e6:.2f} GB/s of rows; pinned copies "
              f"{rates['h2d']:.2f} / {rates['d2h']:.2f} GB/s to / from the "
              f"card), plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms at "
              f"{PCIE_BYTES_PER_S / 1e9:.0f} GB/s each way "
              f"({bound_ms / kern_ms:.0%} of it reached); {call} on the host "
              f"{library_ms:.4f} ms")
    for name, t in read_ms.items():
        n = readings[name][0].numel()
        print(f"  beside them, {name}: {n} rows, {t:.4f} ms "
              f"({n * rb / t / 1e6:.2f} GB/s of rows)")
    return out


def _update_pair(table: torch.Tensor, rows: torch.Tensor,
                 upd: torch.Tensor) -> float:
    """``host_update_rows`` and its plain version on the host stack
    ``table`` from the same distinct rows ``rows`` (on the card), each read
    back: equal bits, and (f32) equal to the f32 sum; the rows put back.
    Only the touched rows are copied.  Returns the largest |difference|."""
    from dlrm_tpu_torch.parallel import host_tier as H

    torch.cuda.synchronize()
    cpu_rows = rows.cpu().long()
    before = table.index_select(0, cpu_rows)
    H.host_update_rows(table, rows, upd)
    torch.cuda.synchronize()
    got = table.index_select(0, cpu_rows)
    table.index_copy_(0, cpu_rows, before)
    H.host_update_rows_reference(table, rows, upd)
    want = table.index_select(0, cpu_rows)
    table.index_copy_(0, cpu_rows, before)
    check(torch.equal(got, want), f"host_update_rows ({table.dtype}, "
          f"{tuple(table.shape)}) differs from its plain version")
    if table.dtype == torch.float32:
        check(torch.equal(got, before + upd.cpu().reshape(got.shape)),
              "host_update_rows is not the f32 sum")
    return (got.float() - want.float()).abs().max().item()


def _host_kernel_checks(emb, config, batch, rates) -> dict:
    """host_gather and host_update_rows at the main path's shapes (one
    training batch's host rows, f32): timed first (``_host_kernel_times``),
    then held against their plain versions bit for bit, into the pooled
    columns and contiguous, on skewed ids, ids sorted beforehand, the
    table's first and last rows, in bf16 and on a width-1 stack; the update
    on sorted and shuffled distinct rows as well.  Every row the update
    checks touch is put back."""
    from dlrm_tpu_torch.parallel import host_tier as H

    plan, host, d = emb.plan, emb.host, config.feature_size
    g = torch.Generator(DEV).manual_seed(71)
    ids = _host_ids(plan, torch.from_numpy(batch["sparse"]).to(DEV))
    b, t = ids.shape[0], config.num_tables
    pooled = torch.zeros((b, t, d), device=DEV)
    ref = torch.zeros_like(pooled)
    uniq = torch.unique(ids.long())
    out = _host_kernel_times(H, host, ids, uniq, pooled, ref,
                             plan.host_tables, rates)
    errs = {"host_gather": [], "host_update_rows": []}

    def gather_pair(name, got, want) -> None:
        errs["host_gather"].append((got.float() - want.float()).abs().max()
                                   .item())
        check(torch.equal(got, want),
              f"host_gather ({name}) differs from its plain version")

    H.host_gather(host, ids, out=pooled, cols=plan.host_tables)
    H.host_gather_reference(host, ids, ref, plan.host_tables)
    torch.cuda.synchronize()
    gather_pair("into the pooled columns", pooled, ref)
    edges = torch.cat([torch.arange(lo + a, lo + a + 4096)
                       for tab, lo in zip(plan.host_tables, plan.host_offsets)
                       for a in (0, config.table_sizes[tab] - 4096)]).to(DEV)
    flat = ids.reshape(-1)
    hot = torch.randint(0, plan.host_rows, (1000,), generator=g, device=DEV)
    skew = flat.clone()
    skew[::2] = hot[torch.randint(0, 1000, (skew[::2].numel(),), generator=g,
                                  device=DEV)].to(skew.dtype)
    for name, i in (("int64 ids, contiguous out", ids.long().reshape(-1)),
                    ("skewed: half the ids from 1,000 hot rows", skew),
                    ("unsorted ids", flat),
                    ("the same ids sorted beforehand",
                     torch.sort(flat).values),
                    ("edge rows", edges)):
        gather_pair(name, H.host_gather(host, i),
                    H.host_gather_reference(host, i))

    def update_pair(table, rows, upd) -> None:
        errs["host_update_rows"].append(_update_pair(table, rows, upd))

    upd = torch.randn((uniq.numel(), d), generator=g, device=DEV)
    update_pair(host, uniq, upd)
    update_pair(host, uniq[torch.randperm(uniq.numel(), generator=g,
                                          device=DEV)].int(), upd)
    update_pair(host, edges, torch.randn((edges.numel(), d), generator=g,
                                         device=DEV))
    small = torch.empty((1 << 21, d), dtype=torch.bfloat16, pin_memory=True)
    small.copy_(torch.randn((1 << 21, d), generator=g, device=DEV))
    rows = torch.randint(0, 1 << 21, (b,), generator=g, device=DEV)
    gather_pair("bf16", H.host_gather(small, rows),
                H.host_gather_reference(small, rows))
    rows = torch.unique(rows)
    update_pair(small, rows, torch.randn((rows.numel(), d), generator=g,
                                         device=DEV))
    scalars = torch.zeros((plan.host_rows, 1), pin_memory=True)
    update_pair(scalars, uniq, torch.rand((uniq.numel(), 1), generator=g,
                                          device=DEV))
    gather_pair("width 1", H.host_gather(scalars, edges),
                H.host_gather_reference(scalars, edges))
    print(f"host-tier kernels vs plain: host_gather bit for bit into the "
          f"pooled columns of ({b}, {t}, {d}) from {ids.numel()} host ids, "
          f"contiguous with int64 ids, on skewed ids (half from 1,000 hot "
          f"rows), on the ids unsorted and sorted beforehand, on the "
          f"{edges.numel()} first and last rows of the host tables, in bf16 "
          f"and at width 1; host_update_rows bit for bit on {uniq.numel()} "
          f"distinct rows sorted and shuffled (the f32 sum), on the edge "
          f"rows, in bf16 and at width 1")
    for name, v in out.items():
        v["max_abs_err"] = max(errs[name])
    del small, scalars
    return out


def _tier_fns(tiered, state, config, optimizer: str, lr: float):
    """(step(dense, sparse, labels) -> loss, block(...) -> losses) of the
    two-tier path the CLI selects for ``optimizer``."""
    from dlrm_tpu_torch.parallel import host_tier as H

    if optimizer == "sgd":
        return ((lambda *b: H.tiered_train_step(tiered, *b, config=config,
                                                lr=lr)),
                (lambda *b: H.tiered_train_block(tiered, *b, config=config,
                                                 lr=lr)))
    kw = {"config": config, "optimizer": optimizer, "lr": lr}
    return ((lambda *b: H.tiered_train_step_opt(tiered, state, *b, **kw)),
            (lambda *b: H.tiered_train_block_opt(tiered, state, *b, **kw)))


def _tier_calls(optimizer: str) -> tuple:
    """(host_gather, host_update_rows) launches of one two-tier step or
    block: the rows' gather and one update; Adagrad adds the accumulator's
    gather and update."""
    return (1, 1) if optimizer == "sgd" else (2, 2)


def _check_tier_block(tiered, state, tmap, config, optimizer, lr) -> None:
    """A K=4 two-tier block at B=32768 against 4 two-tier steps from the
    same state, on batches in which no big-table id occurs in two of
    them."""
    rng = np.random.default_rng(63)
    batches = _batches_without_repeats(config, BLOCK, TRAIN_BATCH, rng,
                                       within=False)
    step, block = _tier_fns(tiered, state, config, optimizer, lr)
    snap = _TieredSnapshot(tiered, state, tmap, _all_ids(batches, config))
    stacked = _to_dev(_stack(batches))
    with counted(f"two-tier {optimizer} block", BLOCK, BLOCK,
                 *_tier_calls(optimizer), _adagrad(optimizer, BLOCK),
                 _sorted(optimizer, BLOCK)):
        blk_losses = block(*stacked).tolist()
    del stacked
    got = snap.read()
    snap.restore()
    seq_losses = [float(step(*_to_dev(b))) for b in batches]
    want = snap.read()
    loss_diff = float(np.abs(np.subtract(blk_losses, seq_losses)).max())
    diff = _max_diff(got, want)
    moved = _max_diff(got[:2], snap.saved[:2])
    check(loss_diff <= 1e-5 and diff <= 1e-5 and moved > 0,
          f"two-tier {optimizer} K={BLOCK} block vs {BLOCK} steps: losses "
          f"{loss_diff}, state {diff}, moved {moved}")
    print(f"two-tier block: {optimizer} K={BLOCK} at B={TRAIN_BATCH} vs "
          f"{BLOCK} two-tier steps from the same state: losses "
          f"{loss_diff:.3g}, {snap.dev_rows.numel()} device-tier and "
          f"{snap.host_rows.numel()} host-tier touched rows, dense "
          f"parameters and accumulators {diff:.3g} (moved by up to "
          f"{moved:.3g})")


def _check_tier_pipeline(tiered, tmap, config, batches) -> None:
    """4 pipelined two-tier SGD steps against 4 inline ones from the same
    state, under deterministic sums: equal bits of the losses and of every
    touched row and dense parameter."""
    from dlrm_tpu_torch.parallel import host_tier as H

    data = batches[:4]
    snap = _TieredSnapshot(tiered, None, tmap, _all_ids(data, config))
    with _deterministic():
        inline = [float(H.tiered_train_step(tiered, *_to_dev(b),
                                            config=config, lr=0.1))
                  for b in data]
        want = snap.read()
        snap.restore()
        sparse = [_to_dev(b)[1] for b in data]
        with counted("pipelined two-tier SGD steps", len(data), len(data),
                     len(data) + 1, len(data)):
            rows = H.prime_host_prefetch(tiered["emb"], sparse[0])
            piped = []
            for b, nxt in zip(data, sparse[1:] + sparse[-1:]):
                rows, loss = H.tiered_train_step_pipelined(
                    tiered, rows, *_to_dev(b), nxt, config=config, lr=0.1)
                piped.append(float(loss))
        got = snap.read()
    same = piped == inline and all(torch.equal(a, b)
                                   for a, b in zip(got, want))
    check(same, f"pipelined vs inline two-tier steps: losses {piped} vs "
          f"{inline}, state diff {_max_diff(got, want)}")
    print(f"pipelined (--host-prefetch) vs inline two-tier SGD, {len(data)} "
          f"steps under deterministic sums: the same loss bits and the same "
          f"bits of {snap.dev_rows.numel() + snap.host_rows.numel()} touched "
          f"rows and the dense parameters")


def _tier_times(params, tiered, state_all, state_t, config, optimizer: str,
                lr: float, batches) -> dict:
    """Host-to-host ms a step, all-device against two-tier, in turns (all,
    tiered, tiered, all) within this call, at K=1 and in K=4 blocks (and
    for SGD the pipelined two-tier step too): the batch (or stacked block)
    copied in, the last loss read back; median of 10 steps (K=4: 5 blocks,
    over 4) after 3 (2)."""
    from dlrm_tpu_torch.parallel import host_tier as H

    blocks = [_stack(batches[:BLOCK]), _stack(batches[BLOCK:2 * BLOCK])]
    fns = {"all-device": _step_fns(config, optimizer, lr, params, state_all),
           "two-tier": _tier_fns(tiered, state_t, config, optimizer, lr)}
    out = {}
    for k in (1, BLOCK):
        ms = {name: [] for name in fns}
        for name in ("all-device", "two-tier", "two-tier", "all-device"):
            step, block = fns[name]
            n, warm = (13, 3) if k == 1 else (7, 2)
            times = []
            for i in range(n):
                t0 = time.perf_counter()
                if k == 1:
                    float(step(*_to_dev(batches[i % len(batches)])))
                else:
                    float(block(*_to_dev(blocks[i % 2]))[-1])
                times.append((time.perf_counter() - t0) * 1e3 / k)
            ms[name].append(statistics.median(times[warm:]))
        out[k] = ms
    if optimizer == "sgd":
        # each timed step copies one batch in: the pipelined one, the next
        # batch (whose ids it gathers ahead)
        step = fns["two-tier"][0]
        ms = {"inline": [], "pipelined": []}
        for name in ("inline", "pipelined", "pipelined", "inline"):
            times, rows, cur = [], None, _to_dev(batches[0])
            for i in range(13):
                t0 = time.perf_counter()
                if name == "inline":
                    float(step(*_to_dev(batches[i % len(batches)])))
                else:
                    nxt = _to_dev(batches[(i + 1) % len(batches)])
                    if rows is None:
                        rows = H.prime_host_prefetch(tiered["emb"], cur[1])
                    rows, loss = H.tiered_train_step_pipelined(
                        tiered, rows, *cur, nxt[1], config=config, lr=lr)
                    float(loss)
                    cur = nxt
                times.append((time.perf_counter() - t0) * 1e3)
            ms[name].append(statistics.median(times[3:]))
        out["prefetch"] = ms
    for k, ms in out.items():
        what = f"K={k}" if k != "prefetch" else "two-tier K=1"
        print(f"step times, {optimizer}, {what}, in turns (ms a step host to "
              f"host): " + "; ".join(
                  f"{name} {v[0]:.3f} / {v[1]:.3f} = "
                  f"{TRAIN_BATCH / statistics.mean(v) * 1e3:.0f} examples/s"
                  for name, v in ms.items()))
    return out


def _tiered_vs_all(tiered, state_t, params, state_all, tmap, config,
                   optimizer: str, lr: float, batches) -> None:
    """``len(batches)`` two-tier steps against as many all-device ones from
    the same state, both under deterministic sums: losses, dense parameters
    and touched rows within 1e-5; the touched rows' accumulators within
    1e-5 of their largest entry."""
    from dlrm_tpu_torch.parallel import host_tier as H

    n = len(batches)
    touched = _all_ids(batches, config)
    emb = tiered["emb"]
    before = _stack_rows(emb.dev, emb.host, tmap, touched)
    step_t = _tier_fns(tiered, state_t, config, optimizer, lr)[0]
    step_a = _step_fns(config, optimizer, lr, params, state_all)[0]
    gather, update = _tier_calls(optimizer)
    # deterministic sums on both sides: the atomics' order otherwise moves
    # the accumulators by up to 1.01e-5 of their largest from run to run
    with counted(f"two-tier {optimizer} steps", n, n, gather * n,
                 update * n, _adagrad(optimizer, n),
                 _sorted(optimizer, n)), _deterministic():
        tiered_losses = [float(step_t(*_to_dev(b))) for b in batches]
    with counted(f"all-device {optimizer} steps", n, n,
                 dense=_adagrad(optimizer, n),
                 sparse=_sorted(optimizer, n)), _deterministic():
        all_losses = [float(step_a(*_to_dev(b))) for b in batches]
    rows = _stack_rows(emb.dev, emb.host, tmap, touched)
    diffs = {"losses": float(np.abs(np.subtract(tiered_losses,
                                                all_losses)).max()),
             "touched rows": (rows - params["emb"][touched]).abs().max()
             .item(),
             "dense": _max_dense_diff(tiered, params)}
    if optimizer != "sgd":
        acc = _stack_rows(state_t["dev_acc"], state_t["host_acc"], tmap,
                          touched)
        want = state_all["emb"][touched]
        diffs["accumulators (relative)"] = ((acc - want).abs().max()
                                            / want.max()).item()
    moved = (rows - before).abs().max().item()
    check(max(diffs.values()) <= 1e-5 and moved > 1e-5,
          f"two-tier vs all-device {optimizer}: {diffs}, moved {moved}")
    print(f"two-tier vs all-device {optimizer}, {n} steps at B="
          f"{TRAIN_BATCH}, lr {lr}: losses "
          f"{[round(x, 6) for x in tiered_losses]}; "
          + ", ".join(f"{k} {v:.3g}" for k, v in diffs.items())
          + f" ({touched.numel()} touched rows, moved by up to {moved:.3g})")


def phase_two_tier() -> dict:
    """Kaggle fs=128 at full width, f32, fused, B=32768, two-tier under
    ``--hbm-budget-gb 4``: the host-tier kernels against their plain
    versions; SGD, Adagrad and row-wise Adagrad two-tier steps against
    all-device ones from one state; K=4 blocks against steps; pipelined
    against inline; device peaks, step times and a profile; then `train
    --hbm-budget-gb` (with a resume and `--host-prefetch`) and `eval
    --ckpt-dir` on its checkpoint in subprocesses.  Returns the kernels'
    numbers."""
    from dlrm_tpu_torch import init_params, kaggle_config
    from dlrm_tpu_torch.data.synthetic import batch_stream
    from dlrm_tpu_torch.parallel import host_tier as H
    from dlrm_tpu_torch.train.train import init_opt_state

    config = kaggle_config(feature_size=128, interaction_impl="fused")
    plan = H.plan_tiers(config, int(TIER_BUDGET_GB * H.GIB))
    host_bytes = plan.host_rows * config.feature_size * 4
    check(plan.host_tables == (2, 11, 20)
          and plan.host_rows == TIER_HOST_ROWS, f"tier plan {plan}")
    # the host tier and an Adagrad accumulator of its size, each registered
    # at its exact size, and 8 GiB to spare
    mem = _meminfo()
    check(mem["MemAvailable"] > 2 * host_bytes + 8 * GIB, f"two-tier phase: "
          f"{mem['MemAvailable']} B of host memory available, it pins up to "
          f"{2 * host_bytes} B")
    print(f"two-tier, Kaggle fs=128 f32 under --hbm-budget-gb "
          f"{TIER_BUDGET_GB}: host tier tables {list(plan.host_tables)}, "
          f"{plan.host_rows} rows = {host_bytes} B pinned; "
          f"{len(plan.device_tables)} tables, {plan.device_rows} rows on "
          f"the card; host MemTotal {mem['MemTotal']} B, MemAvailable "
          f"{mem['MemAvailable']} B")
    rates = _pinned_rates()
    print(f"pinned copies of 1 GiB: to the card {rates['h2d']:.2f} GB/s, "
          f"from it {rates['d2h']:.2f} GB/s")
    params = init_params(torch.Generator(DEV).manual_seed(config.seed),
                         config, DEV)
    rss0 = _rss()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(DEV)
    resident = torch.cuda.memory_allocated(DEV)
    t0 = time.perf_counter()
    tiered = H.draw_tiered_params(
        torch.Generator(DEV).manual_seed(config.seed), plan, config, DEV)
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    draw_peak = torch.cuda.max_memory_allocated(DEV) - resident
    emb = tiered["emb"]
    rss1 = _rss()
    _check_host_tier_size(emb.host, host_bytes, rss1 - rss0)
    _check_drawn_tiers(tiered, params, config)
    print(f"drawn straight into the tiers (pinning the host tier included) "
          f"in {draw_s:.2f} s, device peak {draw_peak / 1e9:.3f} GB (the "
          f"device tier {emb.dev.numel() * 4 / 1e9:.3f} GB and one staging "
          f"chunk of the draws); the same bits, table by table, as the "
          f"all-device init from the same seed; host resident set "
          f"{rss0 / 1e9:.3f} -> {_rss() / 1e9:.3f} GB; MemAvailable "
          f"{_meminfo()['MemAvailable']} B")
    tmap = _TierMap(plan, config)
    batches = list(batch_stream(config, TRAIN_BATCH, TIER_STEPS, seed=61))
    kern = _host_kernel_checks(emb, config, batches[0], rates)

    all_bytes = params["emb"].numel() * 4
    dev_bytes = emb.dev.numel() * 4
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(DEV)
    step = H.tiered_train_step
    for b in batches[:2]:
        float(step(tiered, *_to_dev(b), config=config, lr=0.1))
    peak_t = torch.cuda.max_memory_allocated(DEV) - all_bytes
    _retier(tiered, params, config)
    torch.cuda.reset_peak_memory_stats(DEV)
    _tiered_vs_all(tiered, None, params, None, tmap, config, "sgd", 0.1,
                   batches)
    peak_both = torch.cuda.max_memory_allocated(DEV)
    torch.cuda.reset_peak_memory_stats(DEV)
    sgd = _step_fns(config, "sgd", 0.1, params, None)[0]
    for b in batches[:2]:
        float(sgd(*_to_dev(b)))
    peak_a = torch.cuda.max_memory_allocated(DEV) - dev_bytes
    print(f"device peak memory of an SGD step at B={TRAIN_BATCH}: two-tier "
          f"{peak_t / 1e9:.2f} GB, all-device {peak_a / 1e9:.2f} GB (each "
          f"net of the other's tables, resident beside it: "
          f"{all_bytes / 1e9:.2f} and {dev_bytes / 1e9:.2f} GB; "
          f"{peak_both / 1e9:.2f} GB with both)")
    _check_tier_block(tiered, None, tmap, config, "sgd", 0.1)
    _check_tier_pipeline(tiered, tmap, config, batches)
    _tier_times(params, tiered, None, None, config, "sgd", 0.1, batches)
    host_groups = (("host_gather kernel (host tier, over PCIe)",
                    ("host_gather_kernel",)),
                   ("host_update_rows kernel (host tier, over PCIe)",
                    ("host_update_rows_kernel",)))
    groups = _profile_steps("two-tier SGD steps", lambda data: [
        float(step(tiered, *_to_dev(b), config=config, lr=0.1))
        for b in data], batches,
        pooled_bytes=TRAIN_BATCH * config.num_tables * config.feature_size
        * 4, groups=host_groups)
    check(groups is None or all(groups[name] > 0 for name, _ in host_groups),
          f"the two-tier step's profile lacks a host-tier kernel: {groups}")

    for opt in ("rowwise_adagrad", "adagrad"):
        _retier(tiered, params, config)
        state_all = init_opt_state(params, config=config, optimizer=opt)
        state_t = H.init_tiered_opt_state(tiered, config=config,
                                          optimizer=opt)
        _warm(state_all)
        for a in (state_t["dev_acc"], state_t["host_acc"]):
            a.fill_(1e-6)
        for a, w in zip(_tensors(state_t["dense"]),
                        _tensors(state_all["dense"])):
            a.copy_(w)
        lr = 0.001
        _tiered_vs_all(tiered, state_t, params, state_all, tmap, config,
                       opt, lr, batches[:OPT_STEPS])
        _check_tier_block(tiered, state_t, tmap, config, opt, lr)
        _tier_times(params, tiered, state_all, state_t, config, opt, lr,
                    batches)
        del state_all, state_t
        torch.cuda.empty_cache()
    rss2 = _rss()
    del params, tiered, emb
    torch.cuda.empty_cache()
    _release_pinned()
    rss3 = _rss()
    check(rss2 - rss3 >= host_bytes - TIER_RSS_SLACK, f"dropping the "
          f"two-tier tables gave back {rss2 - rss3} B of the host's resident "
          f"set, not the {host_bytes} B tier")
    print(f"two-tier tables dropped and the host tier unregistered: host "
          f"resident set {rss2 / 1e9:.3f} -> {rss3 / 1e9:.3f} GB")
    _tier_entry_points(config, plan, tmap)
    _release_pinned()
    return kern


def _tier_entry_points(config, plan, tmap) -> None:
    """At full width through the CLI on the card: `train --hbm-budget-gb 4
    --optimizer rowwise_adagrad --ckpt-dir`, 2 steps and a resume to 4,
    held to the same 4 two-tier steps in process (loss 1e-5, touched
    accumulator rows 1e-6, touched table rows and dense parameters 1e-3:
    Adagrad from zero, ROADMAP.md §3); `eval --ckpt-dir` on the two-tier
    checkpoint held to `evaluate` of it placed in process (1e-6); `train
    --hbm-budget-gb 4 --host-prefetch` held to inline two-tier steps in
    process (these two run together, beside the work in process); each
    process's peak resident set, which holds the pinned host tier."""
    from dlrm_tpu_torch.data.criteo import DACLoader, load
    from dlrm_tpu_torch.data.synthetic import batch_stream
    from dlrm_tpu_torch.io.checkpoint import (all_steps, open_checkpoint,
                                              read_tree)
    from dlrm_tpu_torch.parallel import host_tier as H
    from dlrm_tpu_torch.train.metrics import evaluate

    model = ["--config", "kaggle", "--feature-size", "128", "--interaction",
             "fused", "--device", DEV.type, "--hbm-budget-gb",
             str(TIER_BUDGET_GB)]
    bsz = str(TRAIN_BATCH)
    n = TRAIN_BATCH + 4464
    table_bytes = config.total_rows * config.feature_size * 4
    rss = {}

    def tiered_start():
        return H.draw_tiered_params(
            torch.Generator(DEV).manual_seed(config.seed), plan, config, DEV)

    with _scratch() as tmp:
        d, data = str(tmp / "ck"), str(tmp / "data.bin")
        need = 2 * (table_bytes + config.total_rows * 4) + GIB
        free = shutil.disk_usage(tmp).free
        check(free > need, f"two-tier CLI: {free} B free under {tmp}, the "
              f"run needs {need} B")
        _write_dac(data, n, np.random.default_rng(19), config.table_sizes)
        train = ["train", *model, "--batch-size", bsz, "--optimizer",
                 "rowwise_adagrad", "--lr", str(FULL_LR), "--ckpt-dir", d,
                 "--save-interval", "2", "--max-to-keep", "1"]
        lines = []
        for steps in (2, 4):
            res = _cli(train + ["--steps", str(steps)])
            lines.append(_line(train, res))
            rss[f"train --hbm-budget-gb --steps {steps}"] = res
        check(lines[0]["steps"] == 2 and lines[1]["steps"] == 2
              and "resumed from step 2" in res.stderr
              and f"host-tier tables: [2, 11, 20] ({TIER_HOST_ROWS:,} rows)"
              in res.stderr and all_steps(d) == [4],
              f"train --hbm-budget-gb --ckpt-dir: {lines}, checkpoints "
              f"{all_steps(d)}, {res.stderr[-600:]}")
        # eval of the step-4 checkpoint and the pipelined run, together,
        # beside the steps in process
        ev_args = ["eval", *model[:-2], "--data", data, "--ckpt-dir", d,
                   "--batch-size", bsz]
        pf_args = ["train", *model, "--host-prefetch", "--steps", "3",
                   "--batch-size", bsz, "--log-every", "1"]
        ev_cli, pf_cli = _Cli(ev_args), _Cli(pf_args)
        tiered = tiered_start()
        state = H.init_tiered_opt_state(tiered, config=config,
                                        optimizer="rowwise_adagrad")
        stream = list(batch_stream(config, TRAIN_BATCH, 2, seed=0))
        for b in stream + stream:
            loss = float(H.tiered_train_step_opt(
                tiered, state, *_to_dev(b), config=config,
                optimizer="rowwise_adagrad", lr=FULL_LR))
        tree, at = open_checkpoint(d)
        touched = _all_ids(stream, config)
        h, local = tmap.split(touched)
        order_d = np.sort(local[~h].cpu().numpy())
        order_h = np.sort(local[h].cpu().numpy())
        on_card_d = torch.from_numpy(order_d).to(DEV)
        on_host_h = torch.from_numpy(order_h)

        def saved(leaf, order) -> torch.Tensor:
            return torch.from_numpy(leaf.array()[order])

        emb, p = tiered["emb"], tree["params"]
        torch.cuda.synchronize()
        dense = read_tree({"bottom": p["bottom"], "top": p["top"]}, DEV)
        diffs = {
            "loss": abs(loss - lines[1]["final_loss"]),
            "tables": max(
                (saved(p["emb_dev"], order_d) - emb.dev[on_card_d].cpu())
                .abs().max().item(),
                (saved(p["emb_host"], order_h) - emb.host[on_host_h]).abs()
                .max().item()),
            "dense": _max_dense_diff(dense, tiered),
            "accumulators": max(
                (saved(tree["opt"]["dev_acc"], order_d)
                 - state["dev_acc"][on_card_d].cpu()).abs().max().item(),
                (saved(tree["opt"]["host_acc"], order_h)
                 - state["host_acc"][on_host_h]).abs().max().item())}
        check(at == 4 and tree["opt"]["count"] == 4
              and diffs["loss"] <= 1e-5 and diffs["accumulators"] <= 1e-6
              and max(diffs["tables"], diffs["dense"]) <= 1e-3,
              f"train --hbm-budget-gb at full width vs in process: step {at}, "
              f"{diffs}")
        print(f"train --hbm-budget-gb {TIER_BUDGET_GB} --ckpt-dir at full "
              f"width (row-wise Adagrad, lr {FULL_LR}), 2 steps then a resume "
              f"to 4: checkpoints {all_steps(d)}; vs in process over "
              f"{touched.numel()} touched rows |diff| "
              + ", ".join(f"{k} {v:.3g}" for k, v in diffs.items()))
        del tiered, state
        torch.cuda.empty_cache()

        placed = H.place_tiered(tree["params"], plan, config, DEV)
        batches = -(-n // TRAIN_BATCH)
        with counted("two-tier evaluation", batches, 0, batches, 0):
            want = evaluate(placed, DACLoader(load(data), TRAIN_BATCH,
                                              drop_remainder=False), config)
        res = ev_cli.wait()
        line, rss["eval --ckpt-dir (two-tier)"] = _line(ev_args, res), res
        ediff = [abs(line[k] - want[k]) for k in ("loss", "auc", "accuracy")]
        check(line["examples"] == n and max(ediff) <= 1e-6,
              f"eval --ckpt-dir (two-tier) vs in process: {line}, {want}")
        print(f"eval --ckpt-dir on the two-tier checkpoint (device tier to "
              f"the card, host tier into pinned memory) vs evaluate of it in "
              f"process over {n} rows: loss, AUC, accuracy |diff| "
              f"{[f'{x:.3g}' for x in ediff]}")
        del placed
        torch.cuda.empty_cache()

        tiered = tiered_start()
        losses = [float(H.tiered_train_step(tiered, *_to_dev(b),
                                            config=config, lr=0.1))
                  for b in batch_stream(config, TRAIN_BATCH, 3, seed=0)]
        res = pf_cli.wait()
        line = _line(pf_args, res)
        rss["train --hbm-budget-gb --host-prefetch"] = res
        cli_losses = _loss_lines(res.stderr)
        diff = float(np.abs(np.subtract(cli_losses, losses)).max())
        # atomics sum duplicate ids in another order a run; the status lines
        # print 5 decimals
        check(line["steps"] == 3 and len(cli_losses) == 3
              and abs(line["final_loss"] - losses[-1]) <= 1e-5
              and diff <= 1e-5 + 5e-6,
              f"train --host-prefetch: {cli_losses} (final "
              f"{line['final_loss']}) vs inline in process {losses}")
        print(f"train --hbm-budget-gb {TIER_BUDGET_GB} --host-prefetch, 3 SGD "
              f"steps at full width vs inline two-tier steps in process: "
              f"final "
              f"loss |diff| {abs(line['final_loss'] - losses[-1]):.3g}, "
              f"status lines {diff:.3g}")
        del tiered
        torch.cuda.empty_cache()
    print("two-tier CLI, each process's wall time and peak resident set (GB;"
          " sampled every 2 ms; eval and --host-prefetch ran together beside "
          "the steps in process), the pinned host tier being "
          f"{TIER_HOST_ROWS * 512 / 1e9:.2f} GB: " + "; ".join(
              f"{k} {r.seconds:.2f} s, " + ", ".join(
                  f"{m} {v / 1e9:.3f}" for m, v in r.peak_rss.items())
              for k, r in rss.items()))
    for k, r in rss.items():
        # the pinned host tier is resident, rounded up to a power of two
        bound = 2 * TIER_HOST_ROWS * 512 + 8 * GIB
        check(0 < r.peak_rss.get("VmRSS", 0) < bound, f"{k}: peak resident "
              f"set {r.peak_rss}, more than {bound} B")


# -- the touched-rows model: a reference that does not hold the stack --------

def _fold(x: torch.Tensor, device) -> int:
    """The XOR of every element's f32 bits (``parallel.embedding
    ._xor_fold``; a host tensor passes through ``device`` a chunk at a
    time)."""
    from dlrm_tpu_torch.parallel.embedding import _xor_fold

    return int(_xor_fold(x, torch.device(device)).item())


class TouchedRows:
    """The touched-rows model of two-tier parameters for the steps over
    ``batches`` (numpy batches (B, T[, H])): a step reads and writes only
    the rows that its batches' ids touch, so a single-device model of those
    rows alone takes the same step as the two tiers, and neither side holds
    the whole stack.

    Built from the state before the steps: each table's touched ids in
    ascending order (``ids``); a compact config (``config``) whose table
    ``t`` is the whole table when it is small (at most
    ``small_table_threshold`` rows) and otherwise the table's touched rows
    (ids remapped in order); the compact parameters and optimizer state on
    ``device`` (``params``, ``state``: the accumulators, when
    ``tier_state`` has them, gathered beside their rows); the touched rows
    of each tier as they were (``before``); each touched row's hits over
    the batches, per tier in the order of its rows (``hits``, on the
    host).  Host rows are read on the
    host and copied to ``device``: no host-tier kernel serves the
    reference.

    The single-device step treats a table by its class: a K-step block
    updates tables of at most the threshold every micro-step and defers
    the bigger ones to its end.  ``frozen``: the tables the two-tier block
    defers (None: the big ones, as the two-tier SGD block does; the
    two-tier Adagrad block defers the host tier alone).  The compact
    threshold is the largest compact table that is not frozen (at least
    the model's), and each frozen table is padded with zero rows, which no
    id reaches, to more than it, so that every table keeps its treatment
    and the compact model computes the same step."""

    def __init__(self, tiered: dict, tier_state, batches: list, config,
                 device, frozen=None):
        from dlrm_tpu_torch.ops.embedding import tree_map

        self.tiered, self.tier_state = tiered, tier_state
        self.device = torch.device(device)
        emb = tiered["emb"]
        plan = emb.plan
        where = {}
        for k, (tables, offsets) in enumerate((
                (plan.device_tables, plan.device_offsets),
                (plan.host_tables, plan.host_offsets))):
            for t, lo in zip(tables, offsets):
                where[t] = (k, lo)
        thr = config.small_table_threshold
        if frozen is None:
            frozen = [t for t, n in enumerate(config.table_sizes)
                      if n > thr]
        ids_hits = [np.unique(np.concatenate([
            np.asarray(b["sparse"])[:, t].reshape(-1) for b in batches
        ]).astype(np.int64), return_counts=True)
            for t in range(config.num_tables)]
        self.ids = [u for u, _ in ids_hits]
        # big tables keep their touched rows only; small ones stay whole
        self.big = [n > thr for n in config.table_sizes]
        sizes = [u.size if big else n for u, big, n in
                 zip(self.ids, self.big, config.table_sizes)]
        thr_c = max([thr] + [c for t, c in enumerate(sizes)
                             if t not in frozen])
        parts = {name: ([], []) for name in ("src", "dst", "tier", "cmp",
                                             "hits")}
        off = 0
        for t, (u, big) in enumerate(zip(self.ids, self.big)):
            k, lo = where[t]
            copied = u if big else np.arange(sizes[t])
            parts["src"][k].append(lo + copied)
            parts["dst"][k].append(off + np.arange(copied.size))
            parts["tier"][k].append(lo + u)
            parts["cmp"][k].append(off + (np.arange(u.size) if big else u))
            parts["hits"][k].append(ids_hits[t][1])
            if t in frozen:
                sizes[t] = max(sizes[t], thr_c + 1)
            off += sizes[t]
        idx = {name: [torch.from_numpy(np.concatenate(p) if p else
                                       np.zeros(0, np.int64))
                      for p in pair] for name, pair in parts.items()}
        self._src, self._dst = idx["src"], idx["dst"]
        self._tier, self._cmp = idx["tier"], idx["cmp"]
        # each touched row's hits over the batches, in the order of _tier
        self.hits = {tier: h for tier, h in zip(("device", "host"),
                                                 idx["hits"])}
        self.config = dataclasses.replace(config, table_sizes=tuple(sizes),
                                          small_table_threshold=thr_c)
        self._sync()
        pairs = self._pairs()
        compact = {}
        for name, dev, host in pairs:
            out = torch.zeros((off, *dev.shape[1:]), dtype=dev.dtype,
                              device=self.device)
            for stack, src, dst in zip((dev, host), self._src, self._dst):
                out[dst.to(self.device)] = self._read(stack, src)
            compact[name] = out
        self.params = {**tree_map(lambda p: p.to(self.device, copy=True),
                                  {"bottom": tiered["bottom"],
                                   "top": tiered["top"]}),
                       "emb": compact["tables"]}
        self.state = None
        if "accumulators" in compact:
            dense = tier_state["dense"]
            self.state = {"dense": None if dense is None else tree_map(
                lambda a: a.to(self.device, copy=True), dense),
                "emb": compact["accumulators"],
                "count": tier_state["count"]}
        self.before = self.tier_rows()

    def _pairs(self) -> list:
        """(name, device-tier tensor, host-tier tensor): the tables, and
        the accumulators when the state has them."""
        emb = self.tiered["emb"]
        out = [("tables", emb.dev, emb.host)]
        st = self.tier_state
        if st is not None and st.get("dev_acc") is not None:
            out.append(("accumulators", st["dev_acc"], st["host_acc"]))
        return out

    def _sync(self) -> None:
        """The card's kernels write the host tier asynchronously: finish
        them before the host reads it."""
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    def _read(self, stack: torch.Tensor, rows: torch.Tensor
              ) -> torch.Tensor:
        return stack.index_select(0, rows.to(stack.device)).to(self.device)

    def remap(self, batch: dict) -> dict:
        """A numpy batch (B, T[, H]) with each big table's ids turned into
        their rows of the compact table (ascending ids stay ascending)."""
        sparse = np.array(batch["sparse"], copy=True)
        for t, (u, big) in enumerate(zip(self.ids, self.big)):
            if big:
                sparse[:, t] = np.searchsorted(u, sparse[:, t])
        return {**batch, "sparse": sparse}

    def tier_rows(self) -> dict:
        """The touched rows of each tier's tables (and accumulators), on
        ``device``, keyed ``"<device|host>-tier <tables|accumulators>"``."""
        self._sync()
        out = {}
        for name, dev, host in self._pairs():
            for tier, stack, rows in (("device", dev, self._tier[0]),
                                      ("host", host, self._tier[1])):
                out[f"{tier}-tier {name}"] = self._read(stack, rows)
        return out

    def compact_rows(self) -> dict:
        """:meth:`tier_rows` of the compact model, in the same order."""
        out = {}
        tensors = {"tables": self.params["emb"]}
        if self.state is not None:
            tensors["accumulators"] = self.state["emb"]
        for name, t in tensors.items():
            for tier, rows in (("device", self._cmp[0]),
                               ("host", self._cmp[1])):
                out[f"{tier}-tier {name}"] = t.index_select(
                    0, rows.to(self.device))
        return out

    def folds(self) -> dict:
        """The XOR fold of each whole tier tensor, keyed as
        :meth:`tier_rows`."""
        self._sync()
        out = {}
        for name, dev, host in self._pairs():
            for tier, stack in (("device", dev), ("host", host)):
                out[f"{tier}-tier {name}"] = _fold(stack, self.device)
        return out


def xor_identity(folds_before: dict, folds_after: dict, rows_before: dict,
                 rows_after: dict, device) -> dict:
    """Whether only the touched rows of each tier tensor moved, exactly:
    fold(after) == fold(before) ^ fold(touched rows before) ^ fold(touched
    rows after) (the touched rows are distinct), a verdict a tensor."""
    return {k: folds_after[k] == (folds_before[k]
                                  ^ _fold(rows_before[k], device)
                                  ^ _fold(rows_after[k], device))
            for k in folds_before}


# losses, dense parameters and table rows; accumulators (phase_two_tier's)
TOUCHED_TOL = 1e-5
TOUCHED_ACC_TOL = 1e-6
# bf16 tables round a row at every rewrite, in another order on each side:
# losses and dense parameters as f32's; a table row may part by one bf16
# ulp of its value, 2^-8 of it, where f32's parts by 2^-24 (Terabyte fs=64
# read at most 4.8e-7 on the card, the scaled model 7.6e-6 on the CPU);
# the accumulators stay f32
TOUCHED_BF16 = {"losses": 1e-5, "dense": 1e-5, "tables": 1e-4}
# each tier tensor's change against the reference's change: the norm of
# what lies beyond the rounding allowance over the norm of the change; a
# block's micro-steps after the first read states that the device tier's
# sum order has moved apart, and a ReLU near its kink changes a hit's
# gradient (Terabyte: steps 0 to 2.9e-10, a K=4 block 2.4e-4 and 3.6e-4)
TOUCHED_REL = 1e-3
TOUCHED_REL_BLOCK = 1e-2
# a hot row, whose rounding allowance reaches a sixteenth of its value
# (bf16: 8 rewrites; f32: 2^19), is held by its change as well: the hot
# rows' norm of the change's difference over the norm of the reference's
# change, with no allowance; a doubled or dropped update reads 1 there
TOUCHED_HOT = 1 / 16
TOUCHED_HOT_REL = 0.5


def _change_error(got: torch.Tensor, want: torch.Tensor,
                  before: torch.Tensor, updates: torch.Tensor) -> dict:
    """One tier tensor's touched rows after the two-tier step (``got``) and
    after the reference's (``want``), from the same rows ``before``, each
    row rewritten ``updates`` times at most (n,).  Each rewrite rounds to
    the nearest value of the tensor's dtype, so two orders of the same
    adds may part by up to one unit in the last place a rewrite, ``updates
    * eps * |w|`` (``eps`` 2**-23 for f32, 2**-7 for bf16; ``|w|`` the
    largest of the three values).  ``rel``: the norm of each difference's
    part beyond that allowance over the norm of the reference's change (0
    when both are 0, inf when only the difference is); ``hot``: over the
    rows whose allowance reaches ``TOUCHED_HOT`` of their value, the norm
    of the whole difference over the norm of the reference's change (None
    when there is no such row); ``change``: the reference's largest
    change; ``moved``: the two-tier step's."""
    def ratio(num, den):
        return num / den if den else (0.0 if num == 0 else float("inf"))

    eps = torch.finfo(got.dtype).eps
    got, want, before = got.float(), want.float(), before.float()
    m = updates.to(got.device, torch.float32).reshape(
        -1, *[1] * (got.dim() - 1))
    w = torch.maximum(torch.maximum(got.abs(), want.abs()), before.abs())
    beyond = ((got - want).abs() - m * eps * w).clamp(min=0)
    change = want - before
    hot = (m * eps >= TOUCHED_HOT).reshape(-1)
    return {"rel": ratio(beyond.norm().item(), change.norm().item()),
            "hot": ratio((got - want)[hot].norm().item(),
                         change[hot].norm().item()) if hot.any() else None,
            "change": change.abs().max().item() if change.numel() else 0.0,
            "moved": (got - before).abs().max().item()
            if got.numel() else 0.0}


def touched_rows_check(tiered: dict, state, batches: list, config, *,
                       optimizer: str, lr: float, block: bool, device,
                       folds=None, main_path=contextlib.nullcontext
                       ) -> dict:
    """Two-tier steps held against the touched-rows model.

    One two-tier step a batch of ``batches`` (``block``: one K-step block
    of them), ``tiered`` and ``state`` (``init_tiered_opt_state``; for
    ``sgd`` it may hold a row-wise state's accumulators, which must not
    move) in place, inside ``main_path()``; then the same steps of the
    port's single-device functions (``train_step``, ``train_block``,
    ``train_step_opt``, ``train_block_opt``) on the :class:`TouchedRows`
    model under deterministic sums (an Adagrad block's model freezes the
    host tier's tables, as the two-tier block does).  Held:

    * the losses, the dense parameters and every touched table row of both
      tiers within ``TOUCHED_TOL`` (bf16 tables: ``TOUCHED_BF16``), the
      touched accumulator rows (and dense accumulators) within
      ``TOUCHED_ACC_TOL``;
    * each tier tensor's change against the reference's change, which
      those bounds alone cannot do where a step moves a row by less than
      them: ``rel`` of :func:`_change_error` at most ``TOUCHED_REL``
      (a block: ``TOUCHED_REL_BLOCK``), and the device tier's hot rows'
      ``hot`` at most ``TOUCHED_HOT_REL``.  A
      row's rewrites: SGD adds each hit to the table on its own (the host
      tier adds their sum; the reference each hit), so as many as its
      hits; Adagrad rewrites a row and its accumulator once a step, so as
      many as its hits or the steps, whichever is fewer;
    * every touched table tensor, and under Adagrad every accumulator
      tensor, seen to move on both sides; under SGD the touched
      accumulator rows unchanged, bit for bit;
    * the XOR identity (:func:`xor_identity`) of every tier tensor, from
      ``folds`` (the tiers' folds before, when the caller has them).

    Returns {"ok", "losses", "diffs", "bounds" (each diff's), "rel",
    "rel_bound", "hot", "moved", "change", "xor", "folds_before", "folds" (the
    tiers' folds after), "model"}."""
    from dlrm_tpu_torch.parallel import host_tier as H
    from dlrm_tpu_torch.train import train as T

    frozen = tiered["emb"].plan.host_tables \
        if block and optimizer != "sgd" else None
    model = TouchedRows(tiered, state, batches, config, device, frozen)
    folds = model.folds() if folds is None else folds
    stacked = _stack(batches)
    kw = {"config": config, "lr": lr}
    okw = {**kw, "optimizer": optimizer}
    ck = {**okw, "config": model.config}
    cp, cs = model.params, model.state
    with main_path():
        if optimizer == "sgd" and block:
            got = H.tiered_train_block(tiered, *_to_dev(stacked, device),
                                       **kw).tolist()
        elif optimizer == "sgd":
            got = [float(H.tiered_train_step(tiered, *_to_dev(b, device),
                                             **kw)) for b in batches]
        elif block:
            got = H.tiered_train_block_opt(
                tiered, state, *_to_dev(stacked, device), **okw).tolist()
        else:
            got = [float(H.tiered_train_step_opt(
                tiered, state, *_to_dev(b, device), **okw))
                for b in batches]
    remapped = [model.remap(b) for b in batches]
    with _deterministic():
        if optimizer == "sgd" and block:
            want = T.train_block(cp, *_to_dev(_stack(remapped), device),
                                 config=model.config, lr=lr).tolist()
        elif optimizer == "sgd":
            want = [float(T.train_step(cp, *_to_dev(b, device),
                                       config=model.config, lr=lr))
                    for b in remapped]
        elif block:
            want = T.train_block_opt(
                cp, cs, *_to_dev(_stack(remapped), device), **ck).tolist()
        else:
            want = [float(T.train_step_opt(cp, cs, *_to_dev(b, device),
                                           **ck)) for b in remapped]
    after, ref = model.tier_rows(), model.compact_rows()
    diffs = {"losses": float(np.abs(np.subtract(got, want)).max()),
             "dense": _max_dense_diff(tiered, cp)}
    for k, rows in after.items():
        diffs[k] = (rows.float() - ref[k].float()).abs().max(
        ).item() if rows.numel() else 0.0
    if cs is not None and cs["dense"] is not None:
        diffs["dense accumulators"] = max(
            (a.float().cpu() - b.float().cpu()).abs().max().item()
            for a, b in zip(_tensors(state["dense"]), _tensors(cs["dense"])))
    bf16 = config.embedding_dtype == torch.bfloat16
    bounds = {k: TOUCHED_ACC_TOL if "accumulators" in k
              else TOUCHED_BF16["tables" if "tables" in k else k] if bf16
              else TOUCHED_TOL for k in diffs}
    errs = {}
    for k in after:
        hits = model.hits[k.split("-")[0]]
        updates = hits if optimizer == "sgd" else hits.clamp(
            max=len(batches))
        errs[k] = _change_error(after[k], ref[k], model.before[k], updates)
    rel = {k: e["rel"] for k, e in errs.items()}
    rel_bound = TOUCHED_REL_BLOCK if block else TOUCHED_REL
    # the host tier adds a row's summed hits once, the reference each hit:
    # only the device tier's hot rows are rounded alike on both sides
    hot = {k: e["hot"] for k, e in errs.items()
           if e["hot"] is not None and k.startswith("device")}
    # what must move, on both sides; under SGD the accumulators must not
    must_move = [k for k in after if after[k].numel()
                 and ("tables" in k or optimizer != "sgd")]
    moved = {k: errs[k]["moved"] for k in must_move}
    change = {k: errs[k]["change"] for k in must_move}
    still = all(torch.equal(after[k], model.before[k]) for k in after
                if "accumulators" in k and optimizer == "sgd")
    folds_after = model.folds()
    xor = xor_identity(folds, folds_after, model.before, after, device)
    ok = (all(v <= bounds[k] for k, v in diffs.items())
          and all(v <= rel_bound for v in rel.values())
          and all(v <= TOUCHED_HOT_REL for v in hot.values())
          and all(v > 0 for v in moved.values())
          and all(v > 0 for v in change.values())
          and still and all(xor.values()))
    return {"ok": ok, "losses": got, "diffs": diffs, "bounds": bounds,
            "rel": rel, "rel_bound": rel_bound, "hot": hot,
            "moved": moved, "change": change,
            "xor": xor,
            "folds_before": folds, "folds": folds_after, "model": model}


# -- the Criteo Terabyte model, its tables beyond the card ---------------------

AUC_STEPS = 150         # AUC_CURVE_fs128.json's first trained point
AUC_EVAL_BATCHES = 4
AUC_RISE = 0.25         # the least gain over the step-0 AUC


def phase_auc_curve() -> None:
    """The first leg of the time-to-AUC curve (`make_auc_curve_torch
    .curve`) at Kaggle fs=128 full width: bf16 tables, row-wise Adagrad,
    lr 0.002, fused, B=32768 on the planted-truth task, 150 steps from
    parameters drawn from the config's seed, evaluated at steps 0 and 150
    over 4 batches.  The AUC at 150 must lie within 0.01 of the committed
    `AUC_CURVE_fs128.json` at equal examples (`--against`'s tolerance for a
    curve's second point) and 0.25 above the AUC at step 0."""
    import make_auc_curve_torch as mac
    from dlrm_tpu_torch import init_params
    from dlrm_tpu_torch.data.synthetic import ClickthroughModel
    from dlrm_tpu_torch.train.train import init_opt_state

    optimizer, lr = mac.defaults(128)
    config = mac.build_config(128, device=DEV)
    check(config.interaction_impl == "fused"
          and config.embedding_dtype == torch.bfloat16,
          f"the fs=128 curve runs {config.interaction_impl} on "
          f"{config.embedding_dtype} tables")
    torch.cuda.reset_peak_memory_stats(DEV)
    t0 = time.time()
    truth = ClickthroughModel(config, seed=mac.TRUTH_SEED)
    params = init_params(torch.Generator(DEV).manual_seed(config.seed),
                         config, DEV)
    state = init_opt_state(params, config=config, optimizer=optimizer)
    setup = time.time() - t0
    with counted("the AUC curve", AUC_STEPS + 2 * AUC_EVAL_BATCHES,
                 AUC_STEPS, dense=_adagrad(optimizer, AUC_STEPS)):
        points = mac.curve(config, params, state, truth,
                           optimizer=optimizer, lr=lr, batch=TRAIN_BATCH,
                           steps=AUC_STEPS, eval_every=AUC_STEPS,
                           eval_batches=AUC_EVAL_BATCHES, device=DEV, t0=t0)
    check([p["step"] for p in points] == [0, AUC_STEPS],
          f"curve points at steps {[p['step'] for p in points]}")
    for p in points:
        check(all(np.isfinite(p[k]) for k in ("accuracy", "auc", "loss")),
              f"non-finite metrics {p}")
    with open(REPO / "AUC_CURVE_fs128.json") as f:
        lines, ok = mac.compare(points, json.load(f)["curve"])
    first, last = points
    print(f"AUC curve, Kaggle fs=128 bf16 tables, {optimizer} lr {lr}, "
          f"fused, B={TRAIN_BATCH}: step 0 auc {first['auc']:.6f} loss "
          f"{first['loss']:.6f}; step {AUC_STEPS} auc {last['auc']:.6f} "
          f"accuracy {last['accuracy']:.6f} loss {last['loss']:.6f}; "
          f"against AUC_CURVE_fs128.json: {'; '.join(lines)}; set-up "
          f"{setup:.1f} s (truth and tables), {last['wall_s'] - setup:.1f} s "
          f"for {AUC_STEPS} steps and 2 evaluations; device peak "
          f"{torch.cuda.max_memory_allocated(DEV) / 1e9:.2f} GB")
    check(ok, f"the AUC at step {AUC_STEPS} misses the committed curve: "
          f"{lines}")
    check(last["auc"] >= first["auc"] + AUC_RISE,
          f"the AUC rose from {first['auc']} to {last['auc']}, under "
          f"{AUC_RISE}")
    del params, state
    torch.cuda.empty_cache()


TB_FEATURE = 32           # Terabyte fs=32 f32: 112.99 GB of tables
TB64_FEATURE = 64         # Terabyte fs=64 bf16: the same bytes
TB_BUDGET_GB = 64         # tables 0 and 19 spill: 66.61 GB of them
TB_HOST_TABLES = (0, 19)
TB_HOST_ROWS = 520_381_046
TB_DEVICE_ROWS = 362_393_513
TB_HOST_BYTES = 66_608_773_888
TB_LR = 0.001             # the touched-rows checks' Adagrad lr
TB_CLI_STEPS = 6          # the Terabyte CLIs' steps: `--profile-dir`
TB_CLI_PROFILED = 3       # traces the 4th to the 6th
TB_EVAL_BATCHES = 4
TB_TIMED = 5              # timed steps, after 2


def _warm_tier_acc(state: dict, res: dict) -> dict:
    """Every accumulator of a two-tier row-wise state raised to at least
    1e-6 (warm, as ``_warm``) after the SGD check ``res``; returns the
    tiers' folds now: the tables' as ``res`` left them, the accumulators'
    folded again."""
    torch.cuda.synchronize()
    for a in [state["dev_acc"], state["host_acc"]] + _tensors(
            state["dense"]):
        a.clamp_(min=1e-6)
    return {**res["folds"],
            "device-tier accumulators": _fold(state["dev_acc"], DEV),
            "host-tier accumulators": _fold(state["host_acc"], DEV)}


def _tb_report(what: str, res: dict) -> None:
    model = res["model"]
    print(f"Terabyte {what} vs the touched-rows model ({len(model.ids)} "
          f"tables, {model.config.total_rows} compact rows; "
          f"{model._tier[0].numel()} device-tier and {model._tier[1].numel()}"
          f" host-tier touched rows): losses {res['losses']}; |diff| "
          + ", ".join(f"{k} {v:.3g} (bound {res['bounds'][k]:g})"
                      for k, v in res["diffs"].items())
          + f"; change against the reference's, beyond rounding (norm "
          f"ratio, bound {res['rel_bound']:g}): " + ", ".join(
              f"{k} {v:.3g}" for k, v in res["rel"].items())
          + f"; hot rows' change (norm ratio, bound {TOUCHED_HOT_REL:g}): "
          + (", ".join(f"{k} {v:.3g}" for k, v in res["hot"].items())
             or "none")
          + "; moved by up to " + ", ".join(
              f"{k} {v:.3g} (reference {res['change'][k]:.3g})"
              for k, v in res["moved"].items())
          + "; XOR identity over every whole tier tensor: "
          + ", ".join(f"{k} {v}" for k, v in res["xor"].items()))
    check(res["ok"], f"Terabyte {what} vs the touched-rows model failed "
          f"(the line above)")


def _tb_serving(tiered, config, plan) -> None:
    """Serving at B=16384 through `score_batch` and `evaluate` of a few
    batches through TieredEmb, each against the touched-rows model's
    forward of the same batches (1e-6), launch counts read around them;
    then both timed."""
    from dlrm_tpu_torch.data.synthetic import batch_stream
    from dlrm_tpu_torch.models.dlrm import forward
    from dlrm_tpu_torch.run import score_batch
    from dlrm_tpu_torch.train.metrics import evaluate

    batches = list(batch_stream(config, BATCH, TB_EVAL_BATCHES, seed=85))
    model = TouchedRows(tiered, None, batches, config, DEV)
    n = len(batches)
    with counted("Terabyte serving", n, 0, n, 0):
        scores = [score_batch(tiered, b, config, DEV) for b in batches]
    with counted("Terabyte evaluation", n, 0, n, 0):
        m = evaluate(tiered, batches, config)
    with torch.inference_mode():
        want = [forward(model.params, *_to_dev(model.remap(b))[:2],
                        model.config).cpu().numpy() for b in batches]
    m_want = evaluate(model.params, [model.remap(b) for b in batches],
                      model.config)
    sdiff = max(float(np.abs(a - b).max()) for a, b in zip(scores, want))
    mdiff = max(abs(m[k] - m_want[k]) for k in ("loss", "auc", "accuracy"))
    check(sdiff <= 1e-6 and mdiff <= 1e-6 and m["examples"] == n * BATCH,
          f"Terabyte serving / evaluation vs the touched-rows model: scores "
          f"{sdiff}, metrics {m} vs {m_want}")
    serve, ev = [], []
    for i in range(2 + TB_TIMED):
        t0 = time.perf_counter()
        score_batch(tiered, batches[i % n], config, DEV)
        serve.append(time.perf_counter() - t0)
    for _ in range(3):
        t0 = time.perf_counter()
        evaluate(tiered, batches, config)
        ev.append((time.perf_counter() - t0) / n)
    s_ms = statistics.median(serve[2:]) * 1e3
    e_ms = statistics.median(ev[1:]) * 1e3
    print(f"{_tb_what(config)} serving at B={BATCH} through TieredEmb ({n} "
          f"batches, "
          f"tables {list(plan.host_tables)} read from host memory): scores "
          f"vs the touched-rows model |diff| {sdiff:.3g}, evaluate's loss, "
          f"AUC, accuracy |diff| {mdiff:.3g}; score_batch {s_ms:.3f} ms a "
          f"batch host to host = {BATCH / s_ms * 1e3:.0f} examples/s "
          f"(median of {TB_TIMED} after 2); evaluate {e_ms:.3f} ms a batch "
          f"(median of 2 passes over {n} batches after 1)")


def _tb_what(config) -> str:
    return (f"Terabyte fs={config.feature_size} "
            f"{str(config.embedding_dtype).removeprefix('torch.')}")


def _tb_times(tiered, state, config, batches, block: bool = True) -> None:
    """Host-to-host ms a step: SGD, row-wise Adagrad, a K=4 row-wise block
    (per step; ``block``); then fused against gram, one SGD step each in
    turns."""
    from dlrm_tpu_torch.parallel import host_tier as H

    kw = {"optimizer": "rowwise_adagrad", "lr": TB_LR, "config": config}
    timed = {"steps": TB_TIMED, "warmup": 2}
    ms = {
        "SGD step": _host_step_ms(lambda *b: H.tiered_train_step(
            tiered, *b, config=config, lr=0.1), batches, **timed),
        "row-wise Adagrad step": _host_step_ms(
            lambda *b: H.tiered_train_step_opt(tiered, state, *b, **kw),
            batches, **timed)}
    if block:
        blocks = [_stack(batches[:BLOCK]), _stack(batches[BLOCK:2 * BLOCK])]
        ms[f"row-wise Adagrad K={BLOCK} block, a step"] = _host_step_ms(
            lambda *b: H.tiered_train_block_opt(tiered, state, *b,
                                                **kw)[-1],
            blocks, **timed) / BLOCK
    print(f"{_tb_what(config)} two-tier step times at B={TRAIN_BATCH} (ms "
          f"host to host, median of {TB_TIMED} after 2): " + "; ".join(
              f"{k} {v:.3f} = {TRAIN_BATCH / v * 1e3:.0f} examples/s"
              for k, v in ms.items()))
    gram = dataclasses.replace(config, interaction_impl="gram")
    turns = {"fused": [], "gram": []}
    order = ("fused", "gram", "gram", "fused") * 4
    for i, name in enumerate(["fused", "gram"] + list(order)):
        cfg = config if name == "fused" else gram
        t0 = time.perf_counter()
        float(H.tiered_train_step(tiered, *_to_dev(batches[i % len(batches)]),
                                  config=cfg, lr=0.1))
        if i >= 2:
            turns[name].append((time.perf_counter() - t0) * 1e3)
    print(f"{_tb_what(config)} SGD step, fused against gram, one step "
          f"each in turns ({len(order) // 2} each after one of each): fused "
          f"median {statistics.median(turns['fused']):.3f} ms, gram "
          f"{statistics.median(turns['gram']):.3f} ms (recorded only: the "
          f"auto rule keeps gram at fs != 128)")

def _tb_disk(config) -> None:
    """The free bytes of the filesystem that a checkpoint directory of this
    run would use (``_scratch``'s) beside what a row-wise save of the
    Terabyte model needs; nothing is saved."""
    build = REPO / "dlrm_tpu_torch" / "_build"
    build.mkdir(parents=True, exist_ok=True)
    st = os.statvfs(build)
    free = st.f_bavail * st.f_frsize
    tables = config.total_rows * config.feature_size * 4
    accs = config.total_rows * 4
    fits = "it would fit" if free >= tables + accs else "it does not fit"
    print(f"Terabyte checkpoint's disk: {free} B free on the filesystem of "
          f"{build} (statvfs: {st.f_bavail} blocks of {st.f_frsize} B); a save"
          f" needs {tables} B of tables (+ {accs} B of row-wise accumulators"
          f" = {tables + accs} B): {fits}; not saved")


def _tb_bf16(dev32: torch.Tensor, host32: torch.Tensor, plan32) -> dict:
    """The Terabyte model at fs=64 with bf16 tables (f32 compute after the
    pooled rows' cast, fused, ``--hbm-budget-gb 64``) drawn into the fs=32
    tiers' allocations (``dev32``, ``host32``, f32), viewed as bf16: its plan has the fs=32 plan's tables, rows and bytes,
    so nothing is allocated or registered for its tables.  Then an SGD step
    and a row-wise Adagrad step from warm accumulators against the
    touched-rows model in its bf16 form, serving and evaluation, step times
    and a profile that names the pooled rows' cast.  Returns ``{"tiered",
    "state"}``, views of the same allocations and a new row-wise state."""
    from dlrm_tpu_torch import terabyte_config
    from dlrm_tpu_torch.data.synthetic import batch_stream
    from dlrm_tpu_torch.parallel import host_tier as H

    config = terabyte_config(feature_size=TB64_FEATURE,
                             embedding_dtype=torch.bfloat16,
                             interaction_impl="fused")
    plan = H.plan_tiers(config, int(TB_BUDGET_GB * H.GIB))
    row = TB64_FEATURE * 2
    got = (plan.host_tables, plan.device_tables, plan.host_rows,
           plan.device_rows, plan.host_rows * row, plan.device_rows * row)
    want = (plan32.host_tables, plan32.device_tables, plan32.host_rows,
            plan32.device_rows, TB_HOST_BYTES,
            plan32.device_rows * TB_FEATURE * 4)
    check(got == want, f"Terabyte fs=64 bf16 tier plan {got}, not the fs=32 "
          f"f32 plan's {want}")
    ptrs = (dev32.data_ptr(), host32.data_ptr())
    out = H.TieredEmb(dev32.view(torch.bfloat16), host32.view(torch.bfloat16),
                      plan)
    registered = []
    register = H._cuda_host_register
    H._cuda_host_register = lambda ptr, n: (registered.append((ptr, n)),
                                            register(ptr, n))
    try:
        rss0 = _rss()
        torch.cuda.reset_peak_memory_stats(DEV)
        resident = torch.cuda.memory_allocated(DEV)
        t0 = time.perf_counter()
        tiered = H.draw_tiered_params(
            torch.Generator(DEV).manual_seed(config.seed), plan, config, DEV,
            out=out)
        torch.cuda.synchronize()
        draw_s = time.perf_counter() - t0
    finally:
        H._cuda_host_register = register
    del out
    emb = tiered["emb"]
    peak = torch.cuda.max_memory_allocated(DEV) - resident
    check(not registered and (emb.dev.data_ptr(), emb.host.data_ptr()) == ptrs
          and emb.host.dtype == torch.bfloat16
          and tuple(emb.host.shape) == (TB_HOST_ROWS, TB64_FEATURE),
          f"fs=64 bf16 draw: registered {registered}, tiers at "
          f"{(emb.dev.data_ptr(), emb.host.data_ptr())} (fs=32: {ptrs})")
    # the draw's range in each tier's largest table: U(-1/sqrt(rows),
    # 1/sqrt(rows)) rounded to bf16, over its first 2^20 rows
    for name, stack, tables, offsets in (
            ("host", emb.host, plan.host_tables, plan.host_offsets),
            ("device", emb.dev, plan.device_tables, plan.device_offsets)):
        t, lo = max(zip(tables, offsets),
                    key=lambda to: config.table_sizes[to[0]])
        lim = config.table_sizes[t] ** -0.5
        n = min(1 << 20, config.table_sizes[t])
        top = stack[lo:lo + n].float().abs().max().item()
        check(0.9 * lim <= top <= lim * (1 + 2 ** -8), f"fs=64 bf16 draw: "
              f"the {name} tier's first rows reach {top}, the table's "
              f"bound is {lim}")
    print(f"{_tb_what(config)} (f32 compute) under --hbm-budget-gb "
          f"{TB_BUDGET_GB}: the plan's tables {list(plan.host_tables)} on the "
          f"host, {plan.host_rows} rows x {row} B = {plan.host_rows * row} B, "
          f"and {plan.device_rows} rows x {row} B on the card, the fs=32 f32 "
          f"plan's to the byte; drawn into the fs=32 allocations in "
          f"{draw_s:.2f} s (no registration; the same device and host "
          f"addresses), device peak {peak / 1e9:.3f} GB above the resident "
          f"tiers, host resident set {rss0 / 1e9:.3f} -> {_rss() / 1e9:.3f} "
          f"GB")

    state = H.init_tiered_opt_state(tiered, config=config,
                                    optimizer="rowwise_adagrad")
    batches = list(batch_stream(config, TRAIN_BATCH, 2, seed=91))
    res = touched_rows_check(
        tiered, state, batches[:1], config, optimizer="sgd", lr=0.1,
        block=False, device=DEV, main_path=lambda: counted(
            "Terabyte fs=64 bf16 two-tier SGD step", 1, 1, 1, 1))
    _tb_report("fs=64 bf16 SGD step", res)
    res = touched_rows_check(
        tiered, state, batches[1:], config, optimizer="rowwise_adagrad",
        lr=TB_LR, block=False, device=DEV, folds=_warm_tier_acc(state, res),
        main_path=lambda: counted(
            "Terabyte fs=64 bf16 two-tier row-wise step", 1, 1, 2, 2, 1))
    _tb_report("fs=64 bf16 row-wise Adagrad step (warm accumulators)", res)
    del res
    torch.cuda.empty_cache()

    _tb_serving(tiered, config, plan)
    _tb_times(tiered, state, config, batches, block=False)
    host_groups = (("host_gather kernel (host tier, over PCIe)",
                    ("host_gather_kernel",)),
                   ("host_update_rows kernel (host tier, over PCIe)",
                    ("host_update_rows_kernel",)))
    groups = _profile_steps(f"{_tb_what(config)} two-tier SGD steps",
                            lambda data: [float(H.tiered_train_step(
                                tiered, *_to_dev(b), config=config, lr=0.1))
                                for b in data], batches, groups=host_groups,
                            scopes=("interaction",))
    if groups is not None:
        check(all(groups[name] > 0 for name, _ in host_groups),
              f"the fs=64 bf16 step's profile lacks a host-tier kernel: "
              f"{groups}")
        under = groups["kernels under interaction"]
        cast = {k: us for k, us in under.items() if "copy" in k}
        nbytes = TRAIN_BATCH * config.num_tables * TB64_FEATURE * (2 + 4)
        cast_ms = sum(cast.values()) / 1e3 / 5
        check(cast and any("interaction_fwd" in k for k in under),
              f"the fs=64 bf16 step's interaction scope ran {under}: no copy "
              f"(the pooled rows' cast) beside the forward kernel")
        print(f"the pooled rows' cast bf16 -> f32 (models/dlrm.py "
              f"forward_from_pooled, pooled.to(x.dtype)): {cast_ms:.3f} ms a "
              f"step in {len(cast)} copy kernel(s) under the interaction "
              f"scope, against {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms for "
              f"its {nbytes} B (read bf16, write f32) at the HBM rate")
    return {"tiered": tiered, "state": state}


TB_MEM_WAIT_S = 240   # the most the sharded CLI waits for MemAvailable


def _wait_mem_available(need: int, deadline_s: float) -> tuple:
    """Waits until the host's MemAvailable reaches ``need`` bytes, reading
    it every 0.5 s; fails past ``deadline_s``.  Returns (MemAvailable at
    the start, at the end, seconds waited)."""
    t0 = time.perf_counter()
    first = now = _meminfo()["MemAvailable"]
    while now < need:
        check(time.perf_counter() - t0 <= deadline_s,
              f"MemAvailable {now} B after {deadline_s} s of waiting (from "
              f"{first} B): the run needs {need} B")
        time.sleep(0.5)
        now = _meminfo()["MemAvailable"]
    return first, now, time.perf_counter() - t0


def _drawn_s(stderr: str) -> float:
    """The seconds of `train`'s "parameters drawn in" status line."""
    lines = [line for line in stderr.splitlines()
             if line.startswith("parameters drawn in ")]
    check(len(lines) == 1, f"train printed {lines} for its draw")
    return float(lines[0].split()[3])


_CLI_GROUPS = (
    ("host_gather kernel (host tier, over PCIe)", ("host_gather_kernel",)),
    ("host_update_rows kernel (host tier, over PCIe)",
     ("host_update_rows_kernel",)),
    ("device-to-host copies", ("Memcpy DtoH",)),
    ("device-to-device copies (NCCL at world size 1)", ("Memcpy DtoD",)),
    ("memsets", ("Memset",)),
)


def _cli_profile(what: str, prof_dir: Path):
    """The Chrome trace that `train --profile-dir` wrote into ``prof_dir``
    (``TB_CLI_PROFILED`` steps): device time a step by group
    (``_CLI_GROUPS``, then ``_PROFILE_GROUPS``), the trace's span a step
    and the device's idle share of it, and the longest kernels of all else.
    Returns {group: device microseconds a step} (None when the trace holds
    no device activity)."""
    (trace,) = prof_dir.glob("*.json")
    events = [e for e in json.loads(trace.read_text())["traceEvents"]
              if e.get("ph") == "X" and "dur" in e]
    table = _CLI_GROUPS + _PROFILE_GROUPS
    groups = {name: 0.0 for name, _ in table}
    other = {}
    for e in events:
        if e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        for name, keys in table:
            if any(k in e["name"] for k in keys):
                groups[name] += e["dur"]
                break
        else:
            other[e["name"]] = other.get(e["name"], 0.0) + e["dur"]
    groups["elementwise and reductions (all else)"] = sum(other.values())
    n = TB_CLI_PROFILED
    groups = {k: us / n for k, us in groups.items()}
    busy = sum(groups.values())
    if busy == 0:
        print(f"profile, {what}: the trace holds no device time (not "
              f"measured)")
        return None
    span = (max(e["ts"] + e["dur"] for e in events)
            - min(e["ts"] for e in events)) / n
    print(f"profile, {what} (train --profile-dir, {n} steps after 3): "
          f"{busy / 1e3:.3f} ms of device time a step, {span / 1e3:.3f} ms "
          f"a step of trace, device idle {100 * (1 - busy / span):.1f}%")
    for name, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        if us:
            print(f"  {name}: {us / 1e3:.3f} ms a step "
                  f"({100 * us / busy:.1f}%)")
    for key, us in sorted(other.items(), key=lambda kv: -kv[1])[:6]:
        print(f"    of all else: {us / 1e3 / n:.3f} ms a step: {key[:110]}")
    return groups


def _tb_sharded_cli(tier_res, tier_line: dict, tier_lines: list,
                    need: int, prof_dir: Path, tier_prof) -> None:
    """`train --sharded true --host-tables 0,19` at Terabyte fs=32 (a gang
    of this one process under NCCL: tables 0 and 19 the rank's host stack,
    520,381,047 rows with its trash row, in registered host memory; the
    other 24 in slots on the card), ``TB_CLI_STEPS`` row-wise steps from
    the seed's draw, after the host's MemAvailable has come back to
    ``need``: its loss lines and final loss against the two-tier CLI's
    (``tier_lines``, ``tier_line``, 1e-5), its peak VmRSS bounded as the
    two-tier CLI's, its wall time, draw, training loop and placement line
    beside the two-tier CLI's, and the profile of its steps
    (``--profile-dir``) beside theirs (``tier_prof``)."""
    first, avail, waited = _wait_mem_available(need, TB_MEM_WAIT_S)
    print(f"MemAvailable after the two-tier CLI exited: {first} B, {avail} B "
          f"after {waited:.1f} s of waiting (the sharded CLI needs {need} B)")
    args = ["train", "--config", "terabyte", "--feature-size",
            str(TB_FEATURE), "--interaction", "fused", "--sharded", "true",
            "--host-tables", ",".join(map(str, TB_HOST_TABLES)),
            "--optimizer", "rowwise_adagrad", "--lr", str(FULL_LR),
            "--steps", str(TB_CLI_STEPS), "--batch-size", str(TRAIN_BATCH),
            "--log-every", "1", "--device", DEV.type, "--profile-dir",
            str(prof_dir)]
    res = _cli(args)
    line = _line(args, res)
    lines = _loss_lines(res.stderr)
    diff = max(abs(a - b) for a, b in zip(lines, tier_lines)) \
        if len(lines) == len(tier_lines) == TB_CLI_STEPS else float("inf")
    tier_final = tier_line["final_loss"]
    final = abs(line["final_loss"] - tier_final)
    host_rows = TB_HOST_ROWS + 1      # the host stack's trash row
    placed = [ln for ln in res.stderr.splitlines()
              if ln.startswith("host-resident row-sharded tables:")]
    check(line["steps"] == TB_CLI_STEPS and diff <= 1e-5 and final <= 1e-5
          and placed == [f"host-resident row-sharded tables: "
                         f"{list(TB_HOST_TABLES)} ({host_rows:,} rows a "
                         f"shard in host memory)"]
          and "sharded over 1 process(es)" in res.stderr,
          f"train --sharded true --host-tables: {lines} (final "
          f"{line['final_loss']}) vs the two-tier CLI's {tier_lines} (final "
          f"{tier_final}); {res.stderr[-800:]}")
    host = host_rows * TB_FEATURE * 4 + host_rows * 4  # rows, accumulator
    peak = res.peak_rss.get("VmRSS", 0)
    check(host <= peak < host + 16 * GIB, f"train --sharded true "
          f"--host-tables: peak resident set {res.peak_rss}, the host stack "
          f"and its accumulator are {host} B")
    print(f"train --config terabyte --feature-size {TB_FEATURE} --sharded "
          f"true --host-tables {','.join(map(str, TB_HOST_TABLES))} "
          f"--optimizer rowwise_adagrad --lr {FULL_LR} --profile-dir, "
          f"{TB_CLI_STEPS} steps at B={TRAIN_BATCH}: {placed[0]!r}; loss "
          f"lines {lines} vs the two-tier CLI's {tier_lines} (|diff| "
          f"{diff:.3g}; final loss {final:.3g}); wall time {res.seconds:.2f}"
          f" s (two-tier {tier_res.seconds:.2f} s), draw "
          f"{_drawn_s(res.stderr):.2f} s (two-tier "
          f"{_drawn_s(tier_res.stderr):.2f} s), training loop "
          f"{line['seconds']} s (two-tier {tier_line['seconds']} s; s at "
          f"each step's line {_loop_seconds(res.stderr, TRAIN_BATCH)}, "
          f"two-tier {_loop_seconds(tier_res.stderr, TRAIN_BATCH)}), peak "
          f"resident set " + ", ".join(f"{k} {v / 1e9:.3f} GB" for k, v in
                                       res.peak_rss.items()))
    prof = _cli_profile("sharded CLI's row-wise steps with host rows",
                        prof_dir)
    if prof is not None and tier_prof is not None:
        print("the sharded step against the two-tier one, device ms a step "
              "(two-tier -> sharded): " + "; ".join(
                  f"{k} {tier_prof[k] / 1e3:.3f} -> {prof[k] / 1e3:.3f}"
                  for k in prof if max(prof[k], tier_prof[k]) > 0))


def phase_terabyte() -> None:
    """The Criteo Terabyte model at fs=32, f32, fused, under
    ``--hbm-budget-gb 64``: 112.99 GB of tables, tables 0 and 19 (66.61 GB)
    in host memory registered at its exact size, the rest (46.39 GB) on the
    card.  The host's memory checked first; the tiers drawn (seconds,
    resident-set growth, device peak); the host-tier kernels timed at a
    training batch's host ids against their plain versions and bounds;
    the CLI's two row-wise steps in process; an SGD step, a row-wise
    Adagrad step from warm accumulators and a K=4 row-wise block, each
    against the touched-rows model with the XOR identity over every whole
    tier; serving and evaluation; step times, fused against gram in turns,
    a profile; the checkpoint's disk read; the bf16 fs=64 model in the same
    allocations (``_tb_bf16``); the tiers released; then `train --config
    terabyte` in a subprocess against the in-process losses, and `train
    --sharded true --host-tables 0,19` against it (``_tb_sharded_cli``)."""
    from dlrm_tpu_torch import terabyte_config
    from dlrm_tpu_torch.data.synthetic import batch_stream
    from dlrm_tpu_torch.parallel import host_tier as H

    config = terabyte_config(feature_size=TB_FEATURE,
                             interaction_impl="fused")
    plan = H.plan_tiers(config, int(TB_BUDGET_GB * H.GIB))
    row = config.feature_size * 4
    host_bytes, acc_bytes = plan.host_rows * row, plan.host_rows * 4
    dev_bytes = plan.device_rows * row
    check(plan.host_tables == TB_HOST_TABLES
          and plan.host_rows == TB_HOST_ROWS
          and plan.device_rows == TB_DEVICE_ROWS
          and host_bytes == TB_HOST_BYTES, f"Terabyte tier plan {plan}")
    need = host_bytes + acc_bytes + 16 * GIB
    mem = _meminfo()
    print(f"Terabyte fs={TB_FEATURE} f32 under --hbm-budget-gb "
          f"{TB_BUDGET_GB}: {config.total_rows} rows = "
          f"{config.total_rows * row} B of tables; card: "
          f"{len(plan.device_tables)} tables, {plan.device_rows} rows = "
          f"{dev_bytes} B (+ {plan.device_rows * 4} B row-wise "
          f"accumulator); host: tables {list(plan.host_tables)}, "
          f"{plan.host_rows} rows = {host_bytes} B (+ {acc_bytes} B "
          f"accumulator); host MemTotal {mem['MemTotal']} B, MemAvailable "
          f"{mem['MemAvailable']} B, needed {need} B")
    check(mem["MemAvailable"] >= need, f"Terabyte phase: MemAvailable "
          f"{mem['MemAvailable']} B, it needs the host tier, its "
          f"accumulator and 16 GiB: {need} B")
    rates = _pinned_rates()
    _release_pinned()
    rss0 = _rss()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(DEV)
    resident = torch.cuda.memory_allocated(DEV)
    t0 = time.perf_counter()
    tiered = H.draw_tiered_params(
        torch.Generator(DEV).manual_seed(config.seed), plan, config, DEV)
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    draw_peak = torch.cuda.max_memory_allocated(DEV) - resident
    emb = tiered["emb"]
    rss1 = _rss()
    check(emb.dev.numel() * 4 == dev_bytes, f"device tier {emb.dev.shape}")
    _check_host_tier_size(emb.host, host_bytes, rss1 - rss0)
    print(f"Terabyte drawn straight into the tiers (registering the host "
          f"tier included) in {draw_s:.2f} s: device tier "
          f"{dev_bytes / 1e9:.2f} GB, device peak {draw_peak / 1e9:.3f} GB, "
          f"host resident set {rss0 / 1e9:.3f} -> {rss1 / 1e9:.3f} GB; "
          f"MemAvailable {_meminfo()['MemAvailable']} B")

    stream = list(batch_stream(config, TRAIN_BATCH, TB_CLI_STEPS,
                               seed=0))  # the CLI's
    ids = _host_ids(plan, torch.from_numpy(stream[0]["sparse"]).to(DEV))
    pooled = torch.zeros((TRAIN_BATCH, config.num_tables, TB_FEATURE),
                         device=DEV)
    ref = torch.zeros_like(pooled)
    uniq = torch.unique(ids.long())
    print(f"host-tier kernels at a Terabyte training batch's "
          f"{ids.numel()} host ids ({uniq.numel()} distinct) of {row} B rows "
          f"on the {host_bytes / 1e9:.2f} GB mapping (before the host CPU "
          f"touches a row):")
    _host_kernel_times(H, emb.host, ids, uniq, pooled, ref, plan.host_tables,
                       rates)
    H.host_gather(emb.host, ids, out=pooled, cols=plan.host_tables)
    H.host_gather_reference(emb.host, ids, ref, plan.host_tables)
    torch.cuda.synchronize()
    check(torch.equal(pooled, ref), "host_gather at Terabyte's host ids "
          "differs from its plain version")
    del pooled, ref
    upd = torch.randn((uniq.numel(), TB_FEATURE),
                      generator=torch.Generator(DEV).manual_seed(79),
                      device=DEV)
    for rows in (uniq, uniq[torch.randperm(
            uniq.numel(), generator=torch.Generator(DEV).manual_seed(83),
            device=DEV)].int()):
        _update_pair(emb.host, rows, upd)
    print(f"host-tier kernels vs plain at Terabyte's host ids: host_gather "
          f"bit for bit into the pooled columns; host_update_rows of a "
          f"random N(0, 1) update to the {uniq.numel()} distinct rows, sorted"
          f" and shuffled, bit for bit and the f32 sum (the rows put back)")

    rss1 = _rss()
    state = H.init_tiered_opt_state(tiered, config=config,
                                    optimizer="rowwise_adagrad")
    acc = state["host_acc"]
    grew = _rss() - rss1
    check(acc.untyped_storage().nbytes() == acc_bytes and acc.is_pinned()
          and acc_bytes - TIER_RSS_SLACK <= grew <= acc_bytes
          + TIER_RSS_SLACK, f"host accumulator of "
          f"{acc.untyped_storage().nbytes()} B (pinned {acc.is_pinned()}) "
          f"grew the resident set by {grew} B, not {acc_bytes} B")
    print(f"row-wise Adagrad state: host accumulator {acc_bytes} B "
          f"registered at its exact size (resident set +{grew} B), device "
          f"accumulator {state['dev_acc'].numel() * 4} B")
    # the CLI's run in process: its stream and zero accumulators, at the
    # full-width CLI runs' lr (from zero accumulators the default 0.1 moves
    # every touched weight by about 0.1 and saturates the loss)
    n = TB_CLI_STEPS
    with counted("Terabyte row-wise steps (the CLI's)", n, n, 2 * n, 2 * n,
                 n, n):
        cli_losses = [float(H.tiered_train_step_opt(
            tiered, state, *_to_dev(b), config=config,
            optimizer="rowwise_adagrad", lr=FULL_LR)) for b in stream]
    print(f"the CLI's {n} row-wise steps in process: losses {cli_losses}")

    batches = list(batch_stream(config, TRAIN_BATCH, 2 + BLOCK, seed=81))
    res = touched_rows_check(
        tiered, state, batches[:1], config, optimizer="sgd", lr=0.1,
        block=False, device=DEV,
        main_path=lambda: counted("Terabyte two-tier SGD step", 1, 1, 1, 1))
    _tb_report("SGD step", res)
    res = touched_rows_check(
        tiered, state, batches[1:2], config, optimizer="rowwise_adagrad",
        lr=TB_LR, block=False, device=DEV, folds=_warm_tier_acc(state, res),
        main_path=lambda: counted(
            "Terabyte two-tier row-wise step", 1, 1, 2, 2, 1, 1))
    _tb_report("row-wise Adagrad step (warm accumulators)", res)
    res = touched_rows_check(
        tiered, state, batches[2:], config, optimizer="rowwise_adagrad",
        lr=TB_LR, block=True, device=DEV, folds=res["folds"],
        main_path=lambda: counted(f"Terabyte two-tier row-wise K={BLOCK} "
                                  f"block", BLOCK, BLOCK, 2, 2, BLOCK,
                                  BLOCK))
    _tb_report(f"row-wise Adagrad K={BLOCK} block", res)
    del res
    torch.cuda.empty_cache()

    _tb_serving(tiered, config, plan)
    _tb_times(tiered, state, config, batches + stream)
    host_groups = (("host_gather kernel (host tier, over PCIe)",
                    ("host_gather_kernel",)),
                   ("host_update_rows kernel (host tier, over PCIe)",
                    ("host_update_rows_kernel",)))
    groups = _profile_steps("Terabyte two-tier SGD steps", lambda data: [
        float(H.tiered_train_step(tiered, *_to_dev(b), config=config,
                                  lr=0.1)) for b in data], batches,
        pooled_bytes=TRAIN_BATCH * config.num_tables * TB_FEATURE * 4,
        groups=host_groups)
    check(groups is None or all(groups[name] > 0 for name, _ in host_groups),
          f"the Terabyte step's profile lacks a host-tier kernel: {groups}")
    print(f"Terabyte device peak memory over the phase: "
          f"{torch.cuda.max_memory_allocated(DEV) / 1e9:.3f} GB (the device "
          f"tier {dev_bytes / 1e9:.2f} GB and its accumulator "
          f"{plan.device_rows * 4 / 1e9:.2f} GB resident)")
    _tb_disk(config)

    # the bf16 fs=64 model in the same two allocations: the fs=32 names
    # dropped first, so that the views passed on hold them alone
    dev, host = emb.dev, emb.host
    host_ptr = host.data_ptr()
    del tiered, emb, state, acc, ids, uniq
    torch.cuda.empty_cache()
    bf16 = _tb_bf16(dev, host, plan)
    del dev, host

    rss2 = _rss()
    unregistered = []
    unregister = H._cuda_host_unregister
    H._cuda_host_unregister = lambda ptr: (unregistered.append(ptr),
                                           unregister(ptr))
    try:
        del bf16
        gc.collect()
        torch.cuda.empty_cache()
        _release_pinned()
    finally:
        H._cuda_host_unregister = unregister
    rss3 = _rss()
    check(rss2 - rss3 >= host_bytes + acc_bytes - TIER_RSS_SLACK
          and unregistered.count(host_ptr) == 1,
          f"releasing the Terabyte tiers gave back {rss2 - rss3} B of the "
          f"host's resident set, not {host_bytes + acc_bytes} B; "
          f"unregistered {unregistered} (the host tier at {host_ptr})")
    print(f"Terabyte tiers released and unregistered (the host tier's "
          f"mapping once, when its last view died: {len(unregistered)} "
          f"unregistrations, the tier and the accumulator): host resident "
          f"set {rss2 / 1e9:.3f} -> {rss3 / 1e9:.3f} GB, MemAvailable "
          f"{_meminfo()['MemAvailable']} B, device memory allocated "
          f"{torch.cuda.memory_allocated(DEV) / 1e9:.3f} GB")

    with _scratch() as tmp:
        args = ["train", "--config", "terabyte", "--feature-size",
                str(TB_FEATURE), "--interaction", "fused", "--hbm-budget-gb",
                str(TB_BUDGET_GB), "--optimizer", "rowwise_adagrad", "--lr",
                str(FULL_LR), "--steps", str(n), "--batch-size",
                str(TRAIN_BATCH), "--log-every", "1", "--device", DEV.type,
                "--profile-dir", str(tmp / "two-tier")]
        res = _cli(args)
        line = _line(args, res)
        lines = _loss_lines(res.stderr)
        # the status lines print 5 decimals: held against the in-process
        # losses rounded alike
        diff = max(abs(a - round(b, 5)) for a, b in zip(lines, cli_losses)) \
            if len(lines) == n else float("inf")
        final = abs(line["final_loss"] - cli_losses[-1])
        check(line["steps"] == n and diff <= 1e-5 and final <= 1e-5
              and f"host-tier tables: {list(TB_HOST_TABLES)} "
              f"({TB_HOST_ROWS:,} rows)" in res.stderr,
              f"train --config terabyte: {lines} (final "
              f"{line['final_loss']}) vs in process {cli_losses}; "
              f"{res.stderr[-800:]}")
        peak = res.peak_rss.get("VmRSS", 0)
        check(host_bytes + acc_bytes <= peak
              < host_bytes + acc_bytes + 16 * GIB,
              f"train --config terabyte: peak resident set {res.peak_rss}")
        print(f"train --config terabyte --feature-size {TB_FEATURE} "
              f"--interaction fused --hbm-budget-gb {TB_BUDGET_GB} "
              f"--optimizer rowwise_adagrad --lr {FULL_LR} --profile-dir, "
              f"{n} steps at B={TRAIN_BATCH}: loss lines {lines} vs in "
              f"process {[round(x, 7) for x in cli_losses]} (|diff| "
              f"{diff:.3g}; final loss {final:.3g}); wall time "
              f"{res.seconds:.2f} s, draw {_drawn_s(res.stderr):.2f} s, "
              f"training loop {line['seconds']} s (s at each step's line: "
              f"{_loop_seconds(res.stderr, TRAIN_BATCH)}), peak resident set "
              + ", ".join(f"{k} {v / 1e9:.3f} GB"
                          for k, v in res.peak_rss.items()))
        tier_prof = _cli_profile("two-tier CLI's row-wise steps",
                                 tmp / "two-tier")
        _tb_sharded_cli(res, line, lines, need, tmp / "sharded", tier_prof)


# -- the sharded CLI -----------------------------------------------------------

SHARD_CLI_TAIL = 107  # a ragged last batch for eval and predict


def _shard_local(p, config, rows: torch.Tensor) -> tuple:
    """Logical rows ``rows`` (on the card) of a one-shard placement ->
    (their rows in the local stack, those rows, and per column-sharded
    table the table's own row ids)."""
    starts = torch.tensor(config.table_offsets, device=rows.device)
    table = torch.searchsorted(starts, rows, right=True) - 1
    first = torch.zeros(config.num_tables, dtype=torch.int64)
    for t in p.slot_table_list:
        first[t] = int(p.table_local_offsets[t])
    for k, t in enumerate(p.row_sharded):
        first[t] = p.rs_local_offsets[k]
    cs = torch.isin(table, torch.tensor(p.col_sharded, device=rows.device))
    local = (rows - starts[table] + first.to(rows.device)[table])[~cs]
    per_cs = [(rows - starts[table])[table == t] for t in p.col_sharded]
    return local, per_cs


def _rate_lines(stderr: str) -> list:
    """The CLI's save and restore status lines."""
    return [line for line in stderr.splitlines()
            if line.startswith(("saved step", "resumed from step"))]


def phase_sharded_cli() -> None:
    """The sharded CLI at full width (Kaggle fs=128, f32, fused) on the
    card under NCCL at world size 1, through `python -m dlrm_tpu_torch`
    subprocesses, each held against the same work in this process: `train
    --sharded true` (tables 2, 11 and 20 row-sharded, 15 column-sharded,
    row-wise Adagrad, B=32768) for 2 steps and a resume to 4 against 4
    sharded steps in process from the same draw (loss 1e-5, accumulators
    1e-6, touched and edge rows and dense parameters 1e-3: Adagrad from
    zero, ROADMAP.md §3), the checkpoint's placement; the step-4 checkpoint
    restored in process (GB/s); then together, beside the evaluation in
    process: `eval --ckpt-dir` on the mesh and unsharded in one process
    against `sharded_evaluate` (1e-6), and `train --distributed
    --mesh-shape 1x1 --paranoid 1 --host-tables 2,11,20 --exchange-dtype
    bf16` (SGD): the replica check's status lines, the host tier's rows
    and the peak resident set of its exact size; then together, beside
    the serving in process, `predict --sharded true` in f32 and with
    `--quantize-tables int8` against sharded serving in process on the
    same codes (1e-6), the int8 serving's device peak below the codes'
    bytes plus 1 GiB.  Each process's wall time and peak resident set,
    and the CLI's save and restore rates."""
    import torch.distributed as dist
    from dlrm_tpu_torch import kaggle_config
    from dlrm_tpu_torch.data.criteo import DACLoader, load
    from dlrm_tpu_torch.data.synthetic import batch_stream
    from dlrm_tpu_torch.io import checkpoint as ck
    from dlrm_tpu_torch.ops.quant import _quant_rows
    from dlrm_tpu_torch.parallel import embedding as pemb
    from dlrm_tpu_torch.parallel import mesh as pmesh
    from dlrm_tpu_torch.parallel.placement import plan_placement
    from dlrm_tpu_torch.train import train as T
    from dlrm_tpu_torch.train.metrics import (make_sharded_eval_forward,
                                              sharded_evaluate)

    config = kaggle_config(feature_size=128, interaction_impl="fused")
    record = {"table_sizes": list(config.table_sizes), "num_shards": 1,
              "max_rows_per_shard": SHARD_MAX_ROWS,
              "col_sharded_tables": list(SHARD_COLS), "host_tables": []}
    p = plan_placement(**record)
    check(p.row_sharded == (2, 11, 20) and p.col_sharded == SHARD_COLS,
          f"placement {p}")
    model = ["--config", "kaggle", "--feature-size", "128", "--interaction",
             "fused", "--device", DEV.type]
    shards = ["--sharded", "true", "--max-rows-per-shard",
              str(SHARD_MAX_ROWS), "--col-sharded-tables",
              ",".join(map(str, SHARD_COLS))]
    bsz, n = str(TRAIN_BATCH), BATCH + SHARD_CLI_TAIL
    table_bytes = config.total_rows * config.feature_size * 4
    rss, rates = {}, []
    host = plan_placement(config.table_sizes, 1, host_tables=(2, 11, 20))
    host_bytes = host.host_local_rows * config.feature_size * 4
    host_args = ["train", *model, "--distributed", "--coordinator",
                 f"127.0.0.1:{_free_port()}", "--num-processes", "1",
                 "--process-id", "0", "--sharded", "true", "--mesh-shape",
                 "1x1", "--paranoid", "1", "--host-tables", "2,11,20",
                 "--exchange-dtype", "bf16", "--steps", "2", "--batch-size",
                 bsz, "--log-every", "1"]
    dev = pmesh.init_distributed(f"127.0.0.1:{_free_port()}", 1, 0,
                                 device=DEV)
    check(dist.get_backend() == ("nccl" if DEV.type == "cuda" else "gloo"),
          f"process group {dist.get_backend()} on {dev}")
    try:
        mesh = pmesh.make_mesh()
        with _scratch() as tmp:
            d, data = str(tmp / "ck"), str(tmp / "data.bin")
            need = 2 * table_bytes + 2 * GIB
            free = shutil.disk_usage(tmp).free
            check(free > need, f"sharded CLI: {free} B free under {tmp}, "
                  f"the run needs {need} B")
            _write_dac(data, n, np.random.default_rng(29), config.table_sizes)
            train = ["train", *model, *shards, "--batch-size", bsz,
                     "--optimizer", "rowwise_adagrad", "--lr", str(FULL_LR),
                     "--ckpt-dir", d, "--save-interval", "2",
                     "--max-to-keep", "1"]
            lines = []
            for steps in (2, 4):
                res = _cli(train + ["--steps", str(steps)])
                lines.append(_line(train, res))
                rss[f"train --sharded true --steps {steps}"] = res
                rates += _rate_lines(res.stderr)
            check(lines[0]["steps"] == 2 and lines[1]["steps"] == 2
                  and "resumed from step 2" in res.stderr
                  and "row-sharded tables: [2, 11, 20]" in res.stderr
                  and "column-sharded tables: [15]" in res.stderr
                  and ck.all_steps(d) == [4]
                  and ck.checkpoint_placement(d) == record,
                  f"train --sharded true --ckpt-dir: {lines}, checkpoints "
                  f"{ck.all_steps(d)}, {res.stderr[-800:]}")

            params = pemb.draw_sharded_params(
                torch.Generator(DEV).manual_seed(config.seed), p, config, 0,
                DEV)
            T.broadcast_dense(params)
            opt = T.init_sharded_opt_state(params, config=config,
                                           optimizer="rowwise_adagrad")
            step = T.make_sharded_train_step_opt(
                config, optimizer="rowwise_adagrad", lr=FULL_LR, mesh=mesh,
                placement=p, local_batch=True)
            stream = list(batch_stream(config, TRAIN_BATCH, 2, seed=0))
            with counted("the CLI's 4 sharded steps in process", 4, 4,
                         dense=4):
                for b in stream + stream:
                    loss = float(step(params, opt, *_to_dev(b)))
            tree, at = ck.open_checkpoint(d)
            rows = torch.unique(torch.cat([_all_ids(stream, config),
                                           _edge_rows(config).to(DEV)]))
            local, per_cs = _shard_local(p, config, rows)
            sp, so = tree["params"], tree["opt"]
            order = local.cpu().numpy()
            diffs = {
                "loss": abs(loss - lines[1]["final_loss"]),
                "tables": max([(torch.from_numpy(sp["emb"].array()[0, order])
                                - params["emb"][local].cpu()).abs().max()
                               .item()] + [
                    (torch.from_numpy(leaf.array()[0, ids.cpu().numpy()])
                     - cs[ids].cpu()).abs().max().item()
                    for leaf, cs, ids in zip(sp["emb_cs"], params["emb_cs"],
                                             per_cs)]),
                "dense": _max_dense_diff(ck.read_tree(
                    {"bottom": sp["bottom"], "top": sp["top"]}), params),
                "accumulators": max(
                    [(torch.from_numpy(so["emb_acc"].array()[0][:, 0])
                      - opt["emb_acc"].cpu()).abs().max().item()] + [
                        (torch.from_numpy(leaf.array()[:]) - a.cpu()).abs()
                        .max().item()
                        for leaf, a in zip(so["emb_acc_cs"],
                                           opt["emb_acc_cs"])])}
            check(at == 4 and so["count"] == 4 and diffs["loss"] <= 1e-5
                  and diffs["accumulators"] <= 1e-6
                  and max(diffs["tables"], diffs["dense"]) <= 1e-3,
                  f"train --sharded true at full width vs in process: step "
                  f"{at}, {diffs}")
            print(f"train --sharded true --ckpt-dir at full width (row-wise "
                  f"Adagrad, lr {FULL_LR}, NCCL world size 1), 2 steps then "
                  f"a resume to 4, vs 4 sharded steps in process from the "
                  f"same draw over {rows.numel()} touched and edge rows "
                  f"|diff| " + ", ".join(f"{k} {v:.3g}"
                                         for k, v in diffs.items()))

            group = ck.ShardGroup(0, 1, True, True, record)
            payload = ck.sharded_payload(params, opt)
            with _PeakRss() as peak:
                t0 = time.perf_counter()
                ck.restore_sharded(d, group=group, out=payload)
                torch.cuda.synchronize()
                restore_s = time.perf_counter() - t0
            nbytes = ck.payload_bytes(payload)
            got = torch.from_numpy(sp["emb"].array()[0, order])
            check(torch.equal(got, params["emb"][local].cpu()),
                  "the restored stack differs from the checkpoint's rows")
            print(f"sharded restore in process (each slab straight into its "
                  f"tensor): {nbytes} B in {restore_s:.2f} s = "
                  f"{nbytes / restore_s / 1e9:.2f} GB/s; host resident set "
                  f"peak {peak.peak / 1e9:.2f} GB")
            del opt, payload
            torch.cuda.empty_cache()

            # the two evals and the host-table run, together, beside the
            # evaluation in process (the restore above was timed alone)
            ev = ["eval", *model, "--ckpt-dir", d, "--data", data,
                  "--batch-size", str(BATCH)]
            evals = [(what, _Cli(ev + extra)) for what, extra in (
                ("on the mesh", ["--sharded", "true"]),
                ("unsharded in one process", []))]
            host_cli = _Cli(host_args)
            batches = -(-n // BATCH)
            with counted("sharded_evaluate of the checkpoint", batches, 0):
                want = sharded_evaluate(
                    params, DACLoader(load(data), BATCH,
                                      drop_remainder=False),
                    config, mesh=mesh, placement=p)
            for what, cli in evals:
                res = cli.wait()
                line = _line(ev, res)
                rss[f"eval --ckpt-dir {what}"] = res
                ediff = max(abs(line[k] - want[k])
                            for k in ("loss", "auc", "accuracy"))
                check(line["examples"] == n and ediff <= 1e-6,
                      f"eval --ckpt-dir {what}: {line} vs sharded_evaluate "
                      f"{want}")
                print(f"eval --ckpt-dir {what} vs sharded_evaluate in "
                      f"process over {n} rows: |diff| {ediff:.3g}")

            res = host_cli.wait()
            line = _line(host_args, res)
            rss["train --distributed --mesh-shape 1x1 --host-tables"] = res
            vm = res.peak_rss.get("VmRSS", 0)
            check(line["steps"] == 2 and np.isfinite(line["final_loss"])
                  and len(_loss_lines(res.stderr)) == 2
                  and "--paranoid: the DCN table replicas agree at step 1"
                  in res.stderr and "replicas agree at step 2" in res.stderr
                  and f"host-resident row-sharded tables: [2, 11, 20] "
                  f"({host.host_local_rows:,} rows a shard in host memory)"
                  in res.stderr and host_bytes <= vm <= host_bytes + 7 * GIB,
                  f"train --distributed --paranoid --host-tables: {line}, "
                  f"peak VmRSS {vm} B for a {host_bytes} B host tier, "
                  f"{res.stderr[-800:]}")
            print(f"train --distributed --mesh-shape 1x1 --paranoid 1 "
                  f"--host-tables 2,11,20 --exchange-dtype bf16 (SGD, 2 "
                  f"steps): losses {_loss_lines(res.stderr)}, the replica "
                  f"check at each step, a {host_bytes} B host tier of "
                  f"{host.host_local_rows:,} rows, peak VmRSS {vm} B")

            pr = ["predict", *model, "--ckpt-dir", d, "--data", data,
                  "--batch-size", str(BATCH), "--sharded", "true"]
            predicts = [(what, extra, str(tmp / f"scores_{what}.npy"))
                        for what, extra in (
                            ("f32", []),
                            ("int8", ["--quantize-tables", "int8"]))]
            # both predicts together, beside the serving in process (the
            # host-table run has left the card)
            predicts = [(what, out, _Cli(pr + extra + ["--out", out]))
                        for what, extra, out in predicts]
            fwd = make_sharded_eval_forward(config, mesh, p)
            dense = {"bottom": params["bottom"], "top": params["top"]}
            loader = list(DACLoader(load(data), BATCH, drop_remainder=False))

            def serve(emb, cs, scales=None, cs_scales=()):
                with torch.no_grad():
                    return np.concatenate([fwd(
                        dense, emb, cs, *_to_dev(b)[:2], None, scales,
                        cs_scales).float().cpu().numpy() for b in loader])

            with counted("sharded serving (f32) in process", batches, 0):
                want_f32 = serve(params["emb"], params["emb_cs"])
            codes = torch.empty(params["emb"].shape, dtype=torch.int8,
                                device=DEV)
            scales = torch.empty(params["emb"].shape[0], device=DEV)
            cs_codes, cs_scales = [], []
            with torch.no_grad():
                for c in range(0, codes.shape[0], 1 << 20):
                    codes[c:c + (1 << 20)], scales[c:c + (1 << 20)] = \
                        _quant_rows(params["emb"][c:c + (1 << 20)])
                for q, s in map(_quant_rows, params["emb_cs"]):
                    cs_codes.append(q)
                    cs_scales.append(s)
            # the f32 tables leave the card: only codes, scales and the
            # dense towers serve (the collection drops what reference
            # cycles, such as a restore's recursive reader, still hold)
            del params["emb"], params["emb_cs"], q, s
            gc.collect()
            torch.cuda.empty_cache()
            int8_bytes = sum(x.numel() * x.element_size() for x in
                             [codes, scales, *cs_codes, *cs_scales])
            torch.cuda.reset_peak_memory_stats(DEV)
            with counted("sharded serving (int8) in process", batches, 0):
                want_q = serve(codes, tuple(cs_codes), scales,
                               tuple(cs_scales))
            q_peak = torch.cuda.max_memory_allocated(DEV)
            check(q_peak < int8_bytes + GIB, f"int8 sharded serving: device "
                  f"peak {q_peak} B, codes and scales {int8_bytes} B")
            for (what, out, cli), want_s in zip(predicts, (want_f32, want_q)):
                res = cli.wait()
                line = _line(pr, res)
                rss[f"predict --sharded true ({what})"] = res
                sdiff = float(np.abs(np.load(out) - want_s).max())
                check(line["examples"] == n and sdiff <= 1e-6,
                      f"predict --sharded true ({what}): {line}, |diff| "
                      f"{sdiff}")
                print(f"predict --sharded true ({what}) vs sharded serving "
                      f"in process on the same codes over {n} rows: |diff| "
                      f"{sdiff:.3g}")
            print(f"int8 sharded serving in process: device peak {q_peak} B "
                  f"(codes and scales {int8_bytes} B); int8 vs f32 scores "
                  f"|diff| {float(np.abs(want_q - want_f32).max()):.3g}")
            del codes, scales, cs_codes, cs_scales, params, dense
            torch.cuda.empty_cache()

    finally:
        dist.destroy_process_group()
        torch.cuda.empty_cache()
    print("sharded CLI's save and restore (one process, all its state): "
          + "; ".join(rates))
    print("sharded CLI, each process's wall time and peak resident set (GB;"
          " sampled every 2 ms; the two evals and the host-table run ran "
          "together, then the two predicts): " + "; ".join(
              f"{k} {r.seconds:.2f} s, " + ", ".join(
                  f"{m} {v / 1e9:.3f}" for m, v in r.peak_rss.items())
              for k, r in rss.items()))
    for k, r in rss.items():
        if "--host-tables" not in k:
            check(0 < r.peak_rss.get("VmRSS", 0) < table_bytes / 2,
                  f"{k}: peak resident set {r.peak_rss}, the tables are "
                  f"{table_bytes} B")


INT8_BYTES = 4_456_660_164    # Kaggle fs=128: 33,762,577 rows x (128 + 4) B
INT8_BOUND = 5e-3             # the JAX package's bound (tests/test_quant.py)


def _edge_rows(config, n: int = 4096) -> torch.Tensor:
    """The first and last ``n`` rows of every table, as stacked-table
    rows."""
    out = []
    for off, size in zip(config.table_offsets, config.table_sizes):
        k = min(size, n)
        out += [torch.arange(off, off + k),
                torch.arange(off + size - k, off + size)]
    return torch.unique(torch.cat(out))


def _serve_ms(params, batches, config) -> float:
    """Median host-to-host ms of `score_batch` over ``batches``."""
    from dlrm_tpu_torch.run import score_batch

    secs = []
    for b in batches:
        t0 = time.perf_counter()
        score_batch(params, b, config, DEV)
        secs.append(time.perf_counter() - t0)
    return statistics.median(secs) * 1e3


def phase_int8_serving() -> None:
    """Kaggle fs=128 at full width with int8 tables: the card's quantizer
    against the host's, the footprint, 8 scored batches against f32, the
    times, a profile, and `predict --quantize-tables int8`."""
    from dlrm_tpu_torch import init_params, kaggle_config
    from dlrm_tpu_torch.data.criteo import DACLoader, load
    from dlrm_tpu_torch.data.synthetic import batch_stream
    from dlrm_tpu_torch.io.convert import params_to_numpy, save_npz
    from dlrm_tpu_torch.ops import quant
    from dlrm_tpu_torch.run import score_batch

    config = kaggle_config(feature_size=128, interaction_impl="fused")
    torch.cuda.reset_peak_memory_stats(DEV)
    params = init_params(torch.Generator(DEV).manual_seed(config.seed),
                         config, DEV)
    torch.cuda.synchronize(DEV)
    t0 = time.perf_counter()
    qemb = quant.quantize_emb(params["emb"], config)
    torch.cuda.synchronize(DEV)
    q_s = time.perf_counter() - t0
    rows = _edge_rows(config).to(DEV)
    sub = dataclasses.replace(config, table_sizes=(rows.numel(),))
    host = quant.quantize_emb_host(params["emb"][rows].cpu().numpy(), sub)
    check(torch.equal(qemb.codes[rows].cpu(), host.codes) and
          torch.equal(qemb.scales[rows].cpu(), host.scales),
          "int8 codes or scales on the card differ from the host's")
    nbytes = quant.table_bytes(qemb)
    f32_bytes = params["emb"].numel() * params["emb"].element_size()
    check(nbytes == INT8_BYTES, f"int8 tables take {nbytes} B")
    print(f"int8 quantization on the card: {q_s:.2f} s for "
          f"{config.total_rows} rows; codes and scales of {rows.numel()} "
          f"rows (the first and last 4096 of every table) equal the host "
          f"quantizer's bit for bit; {nbytes} B of int8 tables and scales "
          f"against {f32_bytes} B in f32")

    qparams = {"bottom": params["bottom"], "emb": qemb,
               "top": params["top"]}
    batches = list(batch_stream(config, BATCH, MAIN_BATCHES, seed=0))
    with counted("int8 serving", len(batches), 0):
        scores = [score_batch(qparams, b, config, DEV) for b in batches]
    f32 = [score_batch(params, b, config, DEV) for b in batches]
    diff = max(float(np.abs(q - f).max()) for q, f in zip(scores, f32))
    for s in scores:
        check(s.shape == (BATCH,) and bool(np.isfinite(s).all())
              and bool(((s > 0) & (s < 1)).all()), f"int8 scores {s}")
    check(diff <= INT8_BOUND, f"int8 vs f32 scores differ by {diff}")
    ms = {"f32": [], "int8": []}
    for name, p in (("f32", params), ("int8", qparams),
                    ("int8", qparams), ("f32", params)):
        ms[name].append(_serve_ms(p, batches, config))
    print(f"int8 serving: {len(batches)} batches of {BATCH}, interaction_fwd "
          f"launched {len(batches)} times on the bulk-copy path; int8 vs f32 "
          f"scores max |diff| {diff:.3g} (bound {INT8_BOUND}); ms a batch "
          f"host to host in turns (f32, int8, int8, f32): {ms['f32'][0]:.3f}"
          f" / {ms['int8'][0]:.3f} / {ms['int8'][1]:.3f} / "
          f"{ms['f32'][1]:.3f}; peak device memory "
          f"{torch.cuda.max_memory_allocated(DEV) / 1e9:.2f} GB")

    def serve(data):
        for b in data:
            score_batch(qparams, b, config, DEV)

    _profile_steps("int8 served batches", serve, batches,
                   pooled_bytes=BATCH * config.num_tables
                   * config.feature_size * 4,
                   groups=(("int8 dequantize (int8 x f32 scale multiply)",
                            ("MulFunctor",)),))
    del params, qparams, qemb
    torch.cuda.empty_cache()

    # the CLI: full widths, the small tables of the entry-point phase
    small = dataclasses.replace(config, table_sizes=TABLES)
    n = 1000
    with _scratch() as tmp:
        data, pz, out = (str(tmp / f)
                         for f in ("data.bin", "params.npz", "s.npy"))
        _write_dac(data, n, np.random.default_rng(8))
        p = init_params(torch.Generator().manual_seed(12), small)
        save_npz(pz, params_to_numpy(p))
        line = _run_cli(["predict", "--config", "kaggle", "--feature-size",
                         "128", "--table-sizes", ",".join(map(str, TABLES)),
                         "--data", data, "--params", pz, "--out", out,
                         "--quantize-tables", "int8", "--device", DEV.type])
        check(line["examples"] == n, f"predict line {line}")
        on_card = {"bottom": [{k: v.to(DEV) for k, v in l.items()}
                              for l in p["bottom"]],
                   "top": [{k: v.to(DEV) for k, v in l.items()}
                           for l in p["top"]],
                   "emb": quant.quantize_emb(p["emb"].to(DEV), small)}
        want = score_batch(on_card, DACLoader(load(data), n)[0], small, DEV)
        diff = float(np.abs(np.load(out) - want).max())
        check(diff <= 1e-6, f"predict --quantize-tables int8 vs in process: "
              f"{diff}")
        print(f"predict --quantize-tables int8 (quantized on the host) vs "
              f"the card's quantizer in process: max |diff| {diff:.3g} over "
              f"{n} rows")


@contextlib.contextmanager
def _scratch():
    """A temporary directory inside the package's (gitignored) build
    directory."""
    build = REPO / "dlrm_tpu_torch" / "_build"
    build.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        yield Path(tmp)


def _criteo_text(path: Path, n: int, sizes, rng) -> None:
    """``n`` Criteo text lines: 0/1 labels, 13 base-10 ints in [-5, 10000)
    and 26 base-16 ids, column j's drawn from 1 .. sizes[j] - 1, so that
    with the missing field (10% of fields are empty; empty parses as 0, an
    id of its own) column j has at most sizes[j] distinct values."""
    cols = [rng.integers(0, 2, size=n).astype(str)]
    for _ in range(13):
        v = rng.integers(-5, 10000, size=n).astype(str)
        v[rng.random(n) < 0.1] = ""
        cols.append(v)
    for size in sizes:
        v = np.char.mod("%x", rng.integers(1, max(size, 2), size=n))
        v[rng.random(n) < 0.1] = ""
        cols.append(v)
    with open(path, "w") as f:
        f.writelines("\t".join(r) + "\n" for r in zip(*cols))


def _loss_lines(stderr: str) -> list:
    """The per-step losses of `train --log-every 1`'s status lines."""
    return [float(line.split()[3]) for line in stderr.splitlines()
            if line.startswith("step ")]


def _loop_seconds(stderr: str, batch: int) -> list:
    """The seconds from the training loop's start to each status line of
    `train --log-every 1` at ``batch`` examples a step (from the examples/s
    the line prints over the steps so far), to 3 decimals."""
    out = []
    for line in stderr.splitlines():
        if line.startswith("step "):
            f = line.split()
            eps = float(f[4].lstrip("(").replace(",", ""))
            out.append(round(int(f[1]) * batch / eps, 3))
    return out


def phase_data() -> None:
    """The Criteo pipeline at full Kaggle fs=128 width: preprocess, train
    from the file with prefetch, --validate-data, and the step fed from
    the loader through prefetch against plain copies."""
    from dlrm_tpu_torch import init_params, kaggle_config
    from dlrm_tpu_torch.data import criteo
    from dlrm_tpu_torch.data.prefetch import device_prefetch
    from dlrm_tpu_torch.data.synthetic import criteo_text_lines
    from dlrm_tpu_torch.train.train import make_train_step

    config = kaggle_config(feature_size=128, interaction_impl="fused")
    sizes = ",".join(map(str, config.table_sizes))
    steps = 4
    n = steps * TRAIN_BATCH + 107
    with _scratch() as tmp:
        txt, binp, vocab = tmp / "day.txt", tmp / "day.bin", tmp / "v.npz"
        t0 = time.perf_counter()
        _criteo_text(txt, n, config.table_sizes, np.random.default_rng(17))
        gen_s = time.perf_counter() - t0
        line = _run_cli(["preprocess", str(txt), "--out", str(binp),
                         "--vocab", str(vocab)], on_device=False)
        check(line["native"] is True and line["records"] == n,
              f"preprocess line {line}")
        t0 = time.perf_counter()
        criteo.process(str(txt), binpath=str(tmp / "np.bin"),
                       vocab_path=str(tmp / "np.npz"), use_native=False)
        numpy_s = time.perf_counter() - t0
        same = (binp.read_bytes() == (tmp / "np.bin").read_bytes() and
                vocab.read_bytes() == (tmp / "np.npz").read_bytes())
        check(same, "preprocess (native) and process(use_native=False) "
              "wrote different files")
        check(all(s <= t for s, t in zip(line["vocab_sizes"],
                                          config.table_sizes)),
              f"vocabulary {line['vocab_sizes']} exceeds the tables")
        print(f"data: {n} Criteo text lines ({txt.stat().st_size} B, "
              f"written in {gen_s:.2f} s); preprocess with the native "
              f"engine {line['seconds']} s, the numpy path {numpy_s:.2f} s, "
              f"the same binary ({binp.stat().st_size} B) and vocabulary "
              f"bytes")

        res = _cli(["train", "--config", "kaggle", "--feature-size", "128",
                    "--table-sizes", sizes, "--data", str(binp),
                    "--validate-data", "--prefetch", "2", "--steps",
                    str(steps), "--batch-size", str(TRAIN_BATCH),
                    "--log-every", "1", "--device", DEV.type])
        cli = json.loads(res.stdout.strip().splitlines()[-1])
        cli_losses = _loss_lines(res.stderr)
        check(cli["device"] == DEV.type and cli["steps"] == steps and
              len(cli_losses) == steps, f"train line {cli}")

        loader = criteo.DACLoader(criteo.load(str(binp)), TRAIN_BATCH)
        step = make_train_step(config, 0.1)
        runs = {}
        for mode in ("plain", "prefetch"):
            params = init_params(torch.Generator(DEV).manual_seed(
                config.seed), config, DEV)
            with counted(f"training from the file ({mode} copies)", steps,
                         steps):
                feed = loader if mode == "plain" else device_prefetch(
                    loader, size=2, device=DEV)
                # _to_dev: a plain copy, or nothing for prefetched tensors
                runs[mode] = [float(step(params, *_to_dev(b)))
                              for b in feed]
            if mode == "plain":
                del params
                torch.cuda.empty_cache()
        plain = runs["plain"]
        diffs = [float(np.abs(np.subtract(runs["prefetch"], plain)).max()),
                 abs(cli["final_loss"] - plain[-1]),
                 float(np.abs(np.subtract(cli_losses, plain)).max())]
        # atomics sum duplicate ids in another order a run; the status
        # lines print 5 decimals
        check(diffs[0] <= 1e-5 and diffs[1] <= 1e-5
              and diffs[2] <= 1e-5 + 5e-6,
              f"losses: prefetch {runs['prefetch']}, CLI {cli_losses} "
              f"(final {cli['final_loss']}), plain copies {plain}")
        print(f"train from the file, {steps} SGD steps at B={TRAIN_BATCH}: "
              f"plain copies {[round(x, 6) for x in plain]}; through "
              f"device_prefetch in process |diff| {diffs[0]:.3g}; the CLI "
              f"(--validate-data --prefetch 2) final loss |diff| "
              f"{diffs[1]:.3g}, status lines |diff| {diffs[2]:.3g}")

        bad_txt = tmp / "bad.txt"
        bad_txt.write_text("".join(criteo_text_lines(2000, seed=1)))
        criteo.process(str(bad_txt), binpath=str(tmp / "bad.bin"))
        res = _cli(["train", "--config", "kaggle", "--feature-size", "128",
                    "--table-sizes", sizes, "--data", str(tmp / "bad.bin"),
                    "--validate-data", "--steps", "1", "--batch-size", "64",
                    "--device", DEV.type], ok=False)
        msg = [l for l in res.stderr.splitlines() if "outside [1," in l]
        check(len(msg) == 1 and "record " in msg[0] and "column " in msg[0],
              f"--validate-data on a file with vocab 1000: {res.stderr[-800:]}")
        print(f"--validate-data refused a file with 1000 ids a column: "
              f"{msg[0].strip()[:160]}")

        _prefetch_times(params, loader, step)
        del params
        torch.cuda.empty_cache()


def _prefetch_times(params, loader, step, passes: int = 4) -> None:
    """The SGD step fed from ``loader``, its batches marshalled and copied
    through `device_prefetch(size=2)` or plainly (pageable copies on the
    step's stream), in turns (plain, prefetch, prefetch, plain): ms between
    consecutive loss reads, median over ``passes`` epochs after the first
    two steps; then a profile of each."""
    from dlrm_tpu_torch.data.prefetch import device_prefetch

    def feed(indices, prefetch):
        src = (loader[i] for i in indices)
        return device_prefetch(src, size=2, device=DEV) if prefetch else src

    def run(indices, prefetch):
        for b in feed(indices, prefetch):
            float(step(params, *_to_dev(b)))

    order = list(range(len(loader))) * passes
    ms = {False: [], True: []}
    for prefetch in (False, True, True, False):
        times, t0 = [], time.perf_counter()
        for b in feed(order, prefetch):
            float(step(params, *_to_dev(b)))
            t1 = time.perf_counter()
            times.append((t1 - t0) * 1e3)
            t0 = t1
        ms[prefetch].append(statistics.median(times[2:]))
    print(f"SGD step at B={TRAIN_BATCH} fed from DACLoader over the file, "
          f"host to host (loss read every step), in turns: plain copies "
          f"{ms[False][0]:.3f} / {ms[False][1]:.3f} ms, device_prefetch"
          f"(size=2) {ms[True][0]:.3f} / {ms[True][1]:.3f} ms")
    for prefetch in (False, True):
        _profile_steps(f"SGD steps from the file, "
                       f"{'device_prefetch' if prefetch else 'plain copies'}",
                       lambda data: run(list(data), prefetch),
                       list(range(len(loader))))


def _small_config(**kw):
    from dlrm_tpu_torch import tiny_config
    # ids of the small tables repeat within a batch
    return dataclasses.replace(tiny_config(feature_size=16),
                               table_sizes=TABLES, small_table_threshold=100,
                               **kw)


_VARIANTS = {
    "f32": {},
    "bf16": {"compute_dtype": torch.bfloat16,
             "embedding_dtype": torch.bfloat16},
    "multihot": {"n_hot": 3, "interaction_pad_to": 64},
}


def phase_small_inputs() -> None:
    """The port on the card against the port on the CPU (which the tests
    hold against dlrm_tpu), for every interaction and the dtype / multi-hot
    options, on small inputs: the forward, and 3 training steps from the
    same copied parameters."""
    from dlrm_tpu_torch import forward, init_params, make_train_step
    from dlrm_tpu_torch.data.synthetic import random_batch

    cuda, cpu = DEV, torch.device("cpu")
    for impl in ("gram", "pairwise", "fused"):
        for name, kw in _VARIANTS.items():
            config = _small_config(interaction_impl=impl, **kw)
            params = init_params(torch.Generator().manual_seed(3), config)
            on_card = _clone_params(params, cuda)
            rng = np.random.default_rng(5)
            batch = random_batch(rng, config, 333)
            dense = torch.from_numpy(batch["dense"])
            sparse = torch.from_numpy(batch["sparse"])
            with torch.inference_mode():
                want = forward(params, dense, sparse, config)
                got = forward(on_card, dense.to(cuda), sparse.to(cuda),
                              config).cpu()
            # f32: sums in another order; bf16: an activation may round to
            # its neighbouring bf16 value
            atol = 1e-5 if name != "bf16" else 1e-3
            diff = float((got - want).abs().max())
            check(diff <= atol, f"{impl}/{name}: card vs CPU {diff}")

            sides = [(dev, p, make_train_step(config, 0.1))
                     for dev, p in ((cpu, params), (cuda, on_card))]
            loss_diff = 0.0
            for batch in [batch] + [random_batch(rng, config, 333)
                                    for _ in range(2)]:
                losses = [float(step(p, *(
                    torch.from_numpy(batch[k]).to(dev)
                    for k in ("dense", "sparse", "labels"))))
                    for dev, p, step in sides]
                loss_diff = max(loss_diff, abs(losses[0] - losses[1]))
            emb_diff = (on_card["emb"].cpu().float()
                        - params["emb"].float()).abs().max().item()
            dense_diff = _max_dense_diff(on_card, params)
            # f32: sums (and duplicate-id sums by atomics) in another
            # order.  bf16: an activation that rounds to its neighbouring
            # bf16 value moves a gradient by one bf16 step of it.  Read on
            # the card: losses <= 4.5e-6, tables <= 6.1e-5, dense <= 3.9e-6;
            # on the CPU with the dense parameters perturbed by 1e-6
            # (relative): losses <= 7.9e-6, tables <= 3.1e-5, dense
            # <= 9.2e-5.  The limits sit about ten times above both.
            tol = ((1e-5, 1e-5, 1e-5) if name != "bf16"
                   else (1e-4, 1e-3, 1e-3))
            check(all(d <= t for d, t in zip(
                (loss_diff, emb_diff, dense_diff), tol)),
                  f"{impl}/{name}: 3 steps card vs CPU: loss {loss_diff}, "
                  f"tables {emb_diff}, dense {dense_diff}")
            print(f"small inputs, {impl}/{name}: forward card vs CPU max "
                  f"|diff| {diff:.3g}; 3 steps: loss {loss_diff:.3g}, tables "
                  f"{emb_diff:.3g}, dense {dense_diff:.3g}")


def _clone_state(state: dict, device) -> dict:
    from dlrm_tpu_torch.ops.embedding import tree_map

    return {"dense": None if state["dense"] is None else tree_map(
                lambda t: t.to(device, copy=True), state["dense"]),
            "emb": None if state["emb"] is None
            else state["emb"].to(device, copy=True),
            "count": state["count"]}


def phase_small_optimizers() -> None:
    """Every optimizer on the card against the CPU on small inputs, from
    the same copied parameters and state: 3 clipped steps, then one K=3
    block, under the fused interaction.

    f32 from zero accumulators: losses and weights within 1e-5 (Adagrad
    weights 1e-3: from a zero accumulator its step turns a gradient
    difference dg into up to lr / sqrt(eps) = 1e4 * dg), accumulators 1e-6;
    f32 from accumulators warmed to 0.01: all within 1e-5.  bf16 from
    accumulators warmed to 1 (from zero the first step is lr * sign(g), and
    a sign not settled at bf16 precision moves a weight by 2 * lr): the
    limits of the SGD phase, accumulators 1e-3."""
    from dlrm_tpu_torch import init_params
    from dlrm_tpu_torch.data.synthetic import random_batch
    from dlrm_tpu_torch.ops.embedding import tree_leaves
    from dlrm_tpu_torch.train import train as T

    cpu = torch.device("cpu")
    cases = [("f32 cold", {}, 0.0), ("f32 warm", {}, 0.01),
             ("bf16 warm", _VARIANTS["bf16"], 1.0)]
    for opt in OPTIMIZERS:
        for name, kw, init_acc in cases:
            if opt == "sgd" and name == "f32 warm":
                continue
            config = _small_config(interaction_impl="fused", **kw)
            params = init_params(torch.Generator().manual_seed(3), config)
            state = T.init_opt_state(params, config=config, optimizer=opt)
            if opt != "sgd":
                for a in [state["emb"]] + tree_leaves(state["dense"]):
                    a.fill_(init_acc)
            sides = [(cpu, params, state),
                     (DEV, _clone_params(params, DEV),
                      _clone_state(state, DEV))]
            rng = np.random.default_rng(5)
            steps = [random_batch(rng, config, 333) for _ in range(3)]
            block = _stack([random_batch(rng, config, 333)
                            for _ in range(3)])
            losses = []
            for dev, p, st in sides:
                out = [float(T.train_step_opt(
                    p, st, *(torch.from_numpy(b[k]).to(dev) for k in KEYS),
                    config=config, optimizer=opt, lr=0.1,
                    grad_clip_norm=0.5)) for b in steps]
                stacked = [torch.from_numpy(block[k]).to(dev) for k in KEYS]
                if opt == "sgd":
                    blk = T.train_block(p, *stacked, config=config, lr=0.1)
                else:
                    blk = T.train_block_opt(p, st, *stacked, config=config,
                                            lr=0.1, optimizer=opt)
                losses.append(out + blk.tolist())
            (_, p0, s0), (_, p1, s1) = sides
            loss_diff = float(np.abs(np.subtract(*losses)).max())
            emb_diff = (p1["emb"].cpu().float() - p0["emb"].float()
                        ).abs().max().item()
            dense_diff = _max_dense_diff(p1, p0)
            acc_diff = 0.0 if opt == "sgd" else max(
                (a.cpu() - b).abs().max().item() for a, b in zip(
                    [s1["emb"]] + tree_leaves(s1["dense"]),
                    [s0["emb"]] + tree_leaves(s0["dense"])))
            if name.startswith("bf16"):
                tol = (1e-4, 1e-3, 1e-3, 1e-3)
            else:
                w = 1e-3 if (opt != "sgd" and name == "f32 cold") else 1e-5
                tol = (1e-5, w, w, 1e-6)
            diffs = (loss_diff, emb_diff, dense_diff, acc_diff)
            check(all(d <= t for d, t in zip(diffs, tol)) and
                  s1["count"] == s0["count"] == (3 if opt == "sgd" else 6),
                  f"{opt}/{name}: 3 steps + K=3 block card vs CPU: loss, "
                  f"tables, dense, accumulators {diffs} over {tol}")
            print(f"small inputs, {opt}/{name}: 3 clipped steps + K=3 block "
                  f"card vs CPU: loss {loss_diff:.3g}, tables {emb_diff:.3g},"
                  f" dense {dense_diff:.3g}, accumulators {acc_diff:.3g}")


_RSS_KEYS = ("VmRSS", "RssAnon", "RssFile")


def _status(pid: int) -> dict:
    """Bytes of ``_RSS_KEYS`` in /proc/<pid>/status (those it has)."""
    out = {}
    with open(f"/proc/{pid}/status") as f:
        for line in f:
            key = line.split(":", 1)[0]
            if key in _RSS_KEYS:
                out[key] = int(line.split()[1]) * 1024
    return out


_RUNNING = []   # the _Cli processes not yet waited for
# a _Cli starts under _START; once main's cleanup has set _STOPPING under
# it, none starts (a _CliChain's thread may be about to start one)
_START = threading.Lock()
_STOPPING = threading.Event()


class _Cli:
    """``python -m dlrm_tpu_torch *args``, started now, beside whatever
    this process does next; :meth:`wait` ends it.  A thread reads its
    output as it comes and notes its wall time; another samples its peak
    of each of ``_RSS_KEYS`` that its /proc status shows, every 2 ms."""

    def __init__(self, args: list):
        self.args, self.peak, self.seconds = args, {}, None
        self.out = self.err = ""
        self._done = threading.Event()
        self.t0 = time.perf_counter()
        with _START:
            check(not _STOPPING.is_set(), f"{args[0]} not started: the "
                  f"run is stopping")
            self.proc = subprocess.Popen(
                [sys.executable, "-m", "dlrm_tpu_torch", *args], cwd=REPO,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            _RUNNING.append(self)
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._sampler = threading.Thread(target=self._sample, daemon=True)
        self._reader.start()
        self._sampler.start()

    def _read(self) -> None:
        self.out, self.err = self.proc.communicate()
        self.seconds = time.perf_counter() - self.t0
        self._done.set()

    def _sample(self) -> None:
        while not self._done.wait(0.002):
            try:
                now = _status(self.proc.pid)
            except OSError:
                return
            for k, v in now.items():
                self.peak[k] = max(self.peak.get(k, 0), v)

    def stop(self) -> None:
        """Kill the process if it still runs, and reap it."""
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()
        self._reader.join(timeout=10)
        self._sampler.join(timeout=10)
        if self in _RUNNING:
            _RUNNING.remove(self)

    def wait(self, ok: bool = True) -> subprocess.CompletedProcess:
        """The process ended (killed 600 s after its start); it must have
        exited 0 (``ok``) or not.  ``.peak_rss``: its peaks; ``.seconds``:
        its wall time."""
        self._done.wait(max(0.0, 600 - (time.perf_counter() - self.t0)))
        self.stop()
        res = subprocess.CompletedProcess(self.proc.args,
                                          self.proc.returncode, self.out,
                                          self.err)
        res.peak_rss = self.peak
        res.seconds = self.seconds or time.perf_counter() - self.t0
        check((res.returncode == 0) == ok,
              f"{self.args[0]} exited {res.returncode}: "
              f"{res.stderr[-2000:]}")
        return res


class _CliChain:
    """:class:`_Cli` runs one after another, each started when the one
    before has exited 0, in a thread beside whatever this process does
    next; :meth:`wait` returns their results in order, or raises what
    stopped the chain."""

    def __init__(self, runs: list):
        self.results, self.error = [], None
        self._thread = threading.Thread(target=self._run, args=(runs,),
                                        daemon=True)
        self._thread.start()

    def _run(self, runs: list) -> None:
        try:
            for args in runs:
                self.results.append(_Cli(args).wait())
        except Exception as e:     # raised again by wait()
            self.error = e

    def wait(self) -> list:
        self._thread.join()
        if self.error is not None:
            raise self.error
        return self.results


def _cli(args: list, ok: bool = True) -> subprocess.CompletedProcess:
    """:class:`_Cli` of ``args``, waited for."""
    return _Cli(args).wait(ok)


def _line(args: list, res: subprocess.CompletedProcess,
          on_device: bool = True) -> dict:
    """The JSON line a subcommand printed last (``args[0]`` run on the card
    unless ``on_device`` is false)."""
    line = json.loads(res.stdout.strip().splitlines()[-1])
    print(f"{args[0]}: {line}")
    check(not on_device or line.get("device") == DEV.type,
          f"{args[0]} ran on {line}")
    return line


def _run_cli(args: list, on_device: bool = True) -> dict:
    return _line(args, _cli(args), on_device)


def _write_dac(path: str, n: int, rng, sizes=TABLES) -> None:
    from dlrm_tpu_torch.data.criteo import DAC_DTYPE

    rec = np.zeros(n, dtype=DAC_DTYPE)
    rec["label"] = rng.integers(0, 2, size=n)
    rec["dense"] = np.log1p(rng.integers(0, 1000, size=(n, 13)))
    rec["cat"] = np.stack([rng.integers(1, s + 1, size=n) for s in sizes],
                          axis=1)
    rec.tofile(path)


def phase_entry_points() -> None:
    """`python -m dlrm_tpu_torch predict`, `train` and `eval` on the
    card.  At the tiny config's widths the CLI processes that need none of
    each other's results run together (predict, the three trains and the
    first checkpointed train; then eval beside the checkpoint chain), each
    held to the same work in process once it has ended; all of it beside
    the full-width checkpoint chain (`_full_width_chain`), which
    `_full_width_entry_points` then takes up.  The processes run together
    (`_Cli`, `_CliChain`) only to keep the whole smoke under 1100 s: one
    after another, this phase took 264 s on the H100 where it now takes
    196 s."""
    from dlrm_tpu_torch import init_params, tiny_config, train
    from dlrm_tpu_torch.data.criteo import DACLoader, load
    from dlrm_tpu_torch.data.synthetic import ClickthroughModel
    from dlrm_tpu_torch.io.convert import params_to_numpy, save_npz
    from dlrm_tpu_torch.run import score_batch
    from dlrm_tpu_torch.train.metrics import evaluate
    from dlrm_tpu_torch.train.train import init_opt_state, train_block_opt

    n = 1000
    config = dataclasses.replace(tiny_config(), table_sizes=TABLES,
                                 interaction_impl="fused")
    tables = ",".join(map(str, TABLES))
    rng = np.random.default_rng(7)
    cuda = DEV
    with _scratch() as fw_tmp, _scratch() as tmp:
        chain = _full_width_chain(fw_tmp)
        data, pz, out = (str(tmp / f)
                         for f in ("data.bin", "params.npz", "scores.npy"))
        _write_dac(data, n, rng)
        params = init_params(torch.Generator().manual_seed(11), config)
        save_npz(pz, params_to_numpy(params))
        model = ["--config", "tiny", "--table-sizes", tables,
                 "--interaction", "fused", "--device", DEV.type]
        predict = ["predict", *model, "--data", data, "--params", pz,
                   "--out", out, "--batch-size", "256"]
        runs = {
            "skewed": (["--synthetic", "skewed", "--steps", "20",
                        "--batch-size", "128"],
                       lambda: ClickthroughModel(config, seed=12345).stream(
                           128, 20, seed=1)),
            "data": (["--data", data, "--shuffle-rows", "--shuffle-window",
                      "2", "--epochs", "2", "--batch-size", "128"],
                     lambda: _two_epochs(DACLoader(
                         load(data), 128, shuffle_rows=True,
                         shuffle_window=2, seed=0))),
        }
        # the full recipe: row-wise Adagrad in blocks of 4 (10 steps: 4, 4
        # and a remainder of 2), evaluated after
        rowwise = ["train", *model, "--optimizer", "rowwise_adagrad",
                   "--update-interval", "4", "--eval-after", "--synthetic",
                   "skewed", "--steps", "10", "--batch-size", "128"]
        started = {"predict": _Cli(predict), "rowwise": _Cli(rowwise),
                   **{name: _Cli(["train", *model, *flags])
                      for name, (flags, _) in runs.items()},
                   "ckpt": _ckpt_first(tmp, model)}
        line = _line(predict, started["predict"].wait())
        check(line["examples"] == n and line["out"] == out,
              f"predict line {line}")
        got = np.load(out)
        check(got.shape == (n,), f"scores shape {got.shape}")
        want = score_batch(params, DACLoader(load(data), n)[0], config,
                           torch.device("cpu"))
        diff = float(np.abs(got - want).max())
        check(diff <= 1e-5, f"predict on the card vs CPU forward: {diff}")
        print(f"predict on the card vs the port's CPU forward: max |diff| "
              f"{diff:.3g} over {n} rows (ragged tail of {n % 256})")

        def in_process(data_iter):
            p = init_params(torch.Generator(cuda).manual_seed(config.seed),
                            config, cuda)
            return train(p, data_iter, config=config, lr=0.1)["losses"][-1]

        for name, (flags, stream) in runs.items():
            line = _line(["train"], started[name].wait())
            want_steps = 20 if name == "skewed" else 2 * (n // 128)
            check(line["steps"] == want_steps and
                  np.isfinite(line["final_loss"]), f"train line {line}")
            loss = in_process(stream())
            # duplicate ids are summed by atomics in another order per run
            diff = abs(loss - line["final_loss"])
            check(diff <= 1e-5, f"train {name}: CLI {line['final_loss']} "
                  f"vs in process {loss}")
            print(f"train {name}: CLI vs in-process final loss |diff| "
                  f"{diff:.3g}")

        line = _line(rowwise, started["rowwise"].wait())
        p = init_params(torch.Generator(cuda).manual_seed(config.seed),
                        config, cuda)
        state = init_opt_state(p, config=config, optimizer="rowwise_adagrad")
        stream = list(ClickthroughModel(config, seed=12345).stream(
            128, 10, seed=1))
        for i in (0, 4, 8):
            losses = train_block_opt(
                p, state, *_to_dev(_stack(stream[i:i + 4])), config=config,
                lr=0.1, optimizer="rowwise_adagrad")
        want = evaluate(p, ClickthroughModel(config, seed=12345).stream(
            128, 10, seed=10_001), config)
        got = line.get("eval", {})
        # duplicate ids are summed by atomics in another order per run; one
        # of 1280 examples may cross 0.5
        diffs = [abs(line["final_loss"] - float(losses[-1]))] + [
            abs(got.get(k, np.inf) - want[k]) for k in ("loss", "auc")]
        check(line["steps"] == 10 and got.get("examples") == 1280
              and max(diffs) <= 1e-5
              and abs(got["accuracy"] - want["accuracy"]) <= 1 / 1280 + 1e-9,
              f"train rowwise blocks: CLI {line} vs in process "
              f"{float(losses[-1])}, {want}")
        print(f"train rowwise_adagrad K=4 + eval: CLI vs in process: final "
              f"loss, eval loss, AUC |diff| {[f'{d:.3g}' for d in diffs]}")

        pz = str(tmp / "trained.npz")
        save_npz(pz, params_to_numpy(p))
        ev_args = ["eval", *model, "--data", data, "--params", pz,
                   "--batch-size", "256"]
        ev = _Cli(ev_args)
        _ckpt_entry_points(tmp, config, data, model, started["ckpt"])
        line = _line(ev_args, ev.wait())
        want = evaluate(p, DACLoader(load(data), 256, drop_remainder=False),
                        config)
        diffs = [abs(line[k] - want[k]) for k in ("loss", "auc", "accuracy")]
        check(line["examples"] == n and max(diffs) <= 1e-6,
              f"eval: CLI {line} vs in process {want}")
        print(f"eval --params: CLI vs in process over {n} rows (ragged tail "
              f"of {n % 256}): loss, AUC, accuracy |diff| "
              f"{[f'{d:.3g}' for d in diffs]}")
        _full_width_entry_points(fw_tmp, chain)


_CKPT_SCHED = ["--lr-schedule", "warmup_poly_decay", "--warmup-steps", "2",
               "--decay-start", "3", "--decay-steps", "4"]


def _ckpt_train(tmp: Path, model: list) -> list:
    """`train --ckpt-dir` at the tiny config's widths, scheduled SGD, a save
    every 2 steps (``--steps`` to add)."""
    return ["train", *model, "--synthetic", "skewed", "--batch-size", "128",
            "--save-interval", "2", "--ckpt-dir", str(tmp / "ck"),
            *_CKPT_SCHED]


def _ckpt_first(tmp: Path, model: list) -> _Cli:
    """The checkpoint chain's first run, 4 steps, started now."""
    return _Cli(_ckpt_train(tmp, model) + ["--steps", "4"])


def _ckpt_entry_points(tmp: Path, config, data: str, model: list,
                       first: _Cli) -> None:
    """At the tiny config's widths, scheduled SGD: `train --ckpt-dir`
    (``first``, already started) and its resume, `eval --ckpt-dir`,
    `export --quantize int8` with `predict --ckpt-dir` on the artifact, in
    subprocesses on the card, held against the port in process."""
    from dlrm_tpu_torch import init_params
    from dlrm_tpu_torch.data.criteo import DACLoader, load
    from dlrm_tpu_torch.data.synthetic import ClickthroughModel
    from dlrm_tpu_torch.io.checkpoint import all_steps, restore_checkpoint
    from dlrm_tpu_torch.ops.quant import quantize_params
    from dlrm_tpu_torch.run import score_batch
    from dlrm_tpu_torch.train.metrics import evaluate
    from dlrm_tpu_torch.train.optim import make_schedule
    from dlrm_tpu_torch.train.train import make_train_step

    d, q = str(tmp / "ck"), str(tmp / "q")
    train = _ckpt_train(tmp, model)
    first = _line(train, first.wait())
    second = _run_cli(train + ["--steps", "6"])
    check(first["steps"] == 4 and second["steps"] == 2
          and all_steps(d) == [2, 4, 6], f"train --ckpt-dir: {first}, "
          f"{second}, checkpoints {all_steps(d)}")
    # in process: the same init, 4 steps of the stream, then (the resumed
    # run restarts the stream from --seed) its first 2 batches again, the
    # schedule read at steps 4 and 5
    p = init_params(torch.Generator(DEV).manual_seed(config.seed), config,
                    DEV)
    step = make_train_step(config, make_schedule(
        0.1, schedule="warmup_poly_decay", warmup_steps=2, decay_start=3,
        decay_steps=4))
    stream = list(ClickthroughModel(config, seed=12345).stream(128, 4,
                                                                 seed=1))
    for b in stream + stream[:2]:
        loss = float(step(p, *_to_dev(b)))
    saved, at = restore_checkpoint(d, device=DEV)
    diffs = [abs(loss - second["final_loss"]),
             (saved["emb"] - p["emb"]).abs().max().item(),
             _max_dense_diff(saved, p)]
    # duplicate ids are summed by atomics in another order a run
    check(at == 6 and max(diffs) <= 1e-5, f"train --ckpt-dir resume vs in "
          f"process: final loss, tables, dense {diffs}")
    print(f"train --ckpt-dir, 4 scheduled SGD steps then a resume to 6: "
          f"checkpoints {all_steps(d)}; vs in process: final loss, tables, "
          f"dense parameters |diff| {[f'{x:.3g}' for x in diffs]}")

    ev_args = ["eval", *model, "--data", data, "--ckpt-dir", d,
               "--batch-size", "256"]
    ex_args = ["export", *model[:4], "--ckpt-dir", d, "--out", q,
               "--quantize", "int8"]
    ev, ex = _Cli(ev_args), _Cli(ex_args)   # both read the checkpoint only
    line = _line(ev_args, ev.wait())
    want = evaluate(saved, DACLoader(load(data), 256, drop_remainder=False),
                    config)
    ediff = [abs(line[k] - want[k]) for k in ("loss", "auc", "accuracy")]
    check(line["examples"] == want["examples"] and max(ediff) <= 1e-6,
          f"eval --ckpt-dir: {line} vs in process {want}")
    line = _line(ex_args, ex.wait(), on_device=False)
    check(line["quantized"] == "int8", f"export line {line}")
    out = str(tmp / "q.npy")
    _run_cli(["predict", *model, "--data", data, "--ckpt-dir", q, "--out",
              out])
    n = len(load(data))
    qwant = score_batch(quantize_params(saved, config),
                        DACLoader(load(data), n)[0], config, DEV)
    qdiff = float(np.abs(np.load(out) - qwant).max())
    check(qdiff <= 1e-6, f"predict on the int8 artifact vs in process: "
          f"{qdiff}")
    print(f"eval --ckpt-dir vs in process: loss, AUC, accuracy |diff| "
          f"{[f'{x:.3g}' for x in ediff]}; export --quantize int8 "
          f"({line['table_bytes']} B of tables), then predict --ckpt-dir "
          f"on the artifact vs the card's quantizer in process: {qdiff:.3g}")


# row-wise Adagrad's lr in the full-width CLI run: at 0.01 its first step
# from zero accumulators (lr * sign(g) on every dense weight) sent the loss
# to 22.5 and magnified the atomics' last bits to 8e-4 in the weights
FULL_LR = 0.001
GIB = 1 << 30


def _chunked_max_diff(a: torch.Tensor, b: torch.Tensor,
                      rows: int = 1 << 20) -> float:
    """max |a - b| over ``rows`` rows at a time (no full-size temporary)."""
    return max(((a[i:i + rows].float() - b[i:i + rows].float()).abs().max()
                .item() for i in range(0, a.shape[0], rows)), default=0.0)


def _fw_model() -> list:
    """The model flags of the full-width entry points."""
    return ["--config", "kaggle", "--feature-size", "128", "--interaction",
            "fused", "--device", DEV.type]


def _fw_train(tmp: Path) -> list:
    return ["train", *_fw_model(), "--batch-size", str(TRAIN_BATCH),
            "--optimizer", "rowwise_adagrad", "--lr", str(FULL_LR),
            "--ckpt-dir", str(tmp / "ck"), "--save-interval", "2",
            "--max-to-keep", "1"]


def _full_width_chain(tmp: Path) -> _CliChain:
    """`train --ckpt-dir` at full width (row-wise Adagrad) for 2 steps,
    then its resume to 4, in ``tmp`` (its free space checked first),
    started now one after the other in a thread."""
    from dlrm_tpu_torch import kaggle_config

    config = kaggle_config(feature_size=128)
    table_bytes = config.total_rows * config.feature_size * 4
    # two checkpoints while the older is retired, and the artifact
    need = 2 * (table_bytes + config.total_rows * 4) + INT8_BYTES + GIB
    free = shutil.disk_usage(tmp).free
    check(free > need, f"full-width CLI: {free} B free under {tmp}, the "
          f"run needs {need} B")
    return _CliChain([_fw_train(tmp) + ["--steps", steps]
                      for steps in ("2", "4")])


def _full_width_entry_points(tmp: Path, chain: _CliChain) -> None:
    """Kaggle fs=128 at full width (f32, fused, B=32768) through the CLI on
    the card, in ``tmp``: `train --ckpt-dir` with row-wise Adagrad, 2
    steps and a resume to 4 (``chain``, `_full_width_chain`, started
    earlier), held to the same 4 steps in process; `eval --ckpt-dir`
    held to `evaluate` of the checkpoint; `export --quantize int8` (these
    two run together, beside the steps in process), then
    `predict --ckpt-dir` on the artifact held to the card's quantizer in
    process; each process's peak resident set, which must stay far below
    the tables' bytes; `instrument` and `train --profile-dir` (started
    together once the eval has ended, beside the export, which works on
    the host) held to the instrumented step in process and to the
    trace's names; then `bench` alone."""
    from dlrm_tpu_torch import init_params, kaggle_config
    from dlrm_tpu_torch.data.criteo import DACLoader, load
    from dlrm_tpu_torch.data.synthetic import batch_stream, random_batch
    from dlrm_tpu_torch.io.checkpoint import all_steps, restore_checkpoint
    from dlrm_tpu_torch.ops.quant import quantize_params
    from dlrm_tpu_torch.run import score_batch
    from dlrm_tpu_torch.train.metrics import evaluate
    from dlrm_tpu_torch.train.train import init_opt_state, make_train_step_opt
    from dlrm_tpu_torch.utils.telemetry import InstrumentedTrainer, donothing

    config = kaggle_config(feature_size=128, interaction_impl="fused")
    model = _fw_model()
    bsz = str(TRAIN_BATCH)
    n = 2 * TRAIN_BATCH + 4464          # two batches and a ragged tail
    table_bytes = config.total_rows * config.feature_size * 4
    rss = {}
    d, q, data, out = (str(tmp / f) for f in ("ck", "q", "data.bin",
                                               "scores.npy"))
    _write_dac(data, n, np.random.default_rng(9), config.table_sizes)
    train = _fw_train(tmp)
    lines = []
    for steps, res in zip((2, 4), chain.wait()):
        lines.append(_line(train, res))
        rss[f"train --steps {steps}"] = res
    check(lines[0]["steps"] == 2 and lines[1]["steps"] == 2
          and "resumed from step 2" in res.stderr
          and all_steps(d) == [4], f"train --ckpt-dir at full width: "
          f"{lines}, checkpoints {all_steps(d)}")
    # eval (on the card) and export (on the host) read the step-4
    # checkpoint beside the steps in process
    ev_args = ["eval", *model, "--data", data, "--ckpt-dir", d,
               "--batch-size", bsz]
    ex_args = ["export", *model[:4], "--ckpt-dir", d, "--out", q,
               "--quantize", "int8"]
    ev_cli, ex_cli = _Cli(ev_args), _Cli(ex_args)
    # in process: the same init and 2 steps, then (the resumed run
    # restarts the stream from --seed) the same 2 batches again
    p = init_params(torch.Generator(DEV).manual_seed(config.seed),
                    config, DEV)
    state = init_opt_state(p, config=config, optimizer="rowwise_adagrad")
    step = make_train_step_opt(config, optimizer="rowwise_adagrad",
                               lr=FULL_LR)
    stream = list(batch_stream(config, TRAIN_BATCH, 2, seed=0))
    for b in stream + stream:
        loss = float(step(p, state, *_to_dev(b)))
    saved, at = restore_checkpoint(d, device=DEV)
    diffs = {"loss": abs(loss - lines[1]["final_loss"]),
             "tables": _chunked_max_diff(saved["params"]["emb"],
                                         p["emb"]),
             "dense": _max_dense_diff(saved["params"], p),
             "accumulators": _max_diff(_tensors(saved["opt"]),
                                       _tensors(state))}
    # duplicate ids are summed by atomics in another order a run, and
    # Adagrad from a zero accumulator magnifies that in the weights
    # (ROADMAP.md section 3: 1e-3 from zero)
    check(at == 4 and saved["opt"]["count"] == 4
          and diffs["loss"] <= 1e-5 and diffs["accumulators"] <= 1e-6
          and max(diffs["tables"], diffs["dense"]) <= 1e-3,
          f"train --ckpt-dir at full width vs in process: step {at}, "
          f"count {saved['opt']['count']}, {diffs}")
    print(f"train --ckpt-dir at full width (Kaggle fs=128, row-wise "
          f"Adagrad, lr {FULL_LR}, B={TRAIN_BATCH}), 2 steps then a "
          f"resume to 4: checkpoints {all_steps(d)}; vs in process |diff| "
          + ", ".join(f"{k} {v:.3g}" for k, v in diffs.items()))
    saved = saved["params"]
    del p, state
    torch.cuda.empty_cache()

    want = evaluate(saved, DACLoader(load(data), TRAIN_BATCH,
                                     drop_remainder=False), config)
    res = ev_cli.wait()
    line, rss["eval --ckpt-dir"] = _line(ev_args, res), res
    ediff = [abs(line[k] - want[k]) for k in ("loss", "auc", "accuracy")]
    check(line["examples"] == n and max(ediff) <= 1e-6,
          f"eval --ckpt-dir at full width: {line} vs in process {want}")
    # two SGD processes of one table copy each, beside the export
    inst_args = ["instrument", *model, "--batch-size", bsz, "--steps",
                 "3"]
    prof = tmp / "prof"
    inst_cli, prof_cli = _Cli(inst_args), _Cli([
        "train", *model, "--steps", "8", "--batch-size", bsz,
        "--profile-dir", str(prof)])
    res = ex_cli.wait()
    line = _line(ex_args, res, on_device=False)
    rss["export --quantize int8"] = res
    check(line["quantized"] == "int8" and line["table_bytes"] ==
          INT8_BYTES and line["total_rows"] == config.total_rows,
          f"export line {line}")
    args = ["predict", *model, "--data", data, "--ckpt-dir", q, "--out",
            out, "--batch-size", bsz]
    res = _cli(args)
    line, rss["predict --ckpt-dir (int8)"] = _line(args, res), res
    qp = quantize_params(saved, config)
    want = np.concatenate([
        score_batch(qp, b, config, DEV) for b in DACLoader(
            load(data), TRAIN_BATCH, drop_remainder=False)])
    qdiff = float(np.abs(np.load(out) - want).max())
    check(line["examples"] == n and qdiff <= 1e-6,
          f"predict on the full-width int8 artifact vs in process: "
          f"{qdiff}")
    print(f"at full width: eval --ckpt-dir vs in process over {n} rows "
          f"(ragged tail of {n % TRAIN_BATCH}): loss, AUC, accuracy "
          f"|diff| {[f'{x:.3g}' for x in ediff]}; export --quantize "
          f"int8 ({line['examples']} rows scored; {INT8_BYTES} B of "
          f"int8 tables), then predict --ckpt-dir on the artifact vs "
          f"the card's quantizer in process: {qdiff:.3g}")
    del saved, qp
    torch.cuda.empty_cache()

    line = _line(inst_args, inst_cli.wait())
    p = init_params(torch.Generator(DEV).manual_seed(config.seed),
                    config, DEV)
    rng = np.random.default_rng(0)
    trainer = InstrumentedTrainer(config, 0.1)
    for _ in range(3):
        loss = trainer.step(p, random_batch(rng, config, TRAIN_BATCH),
                            donothing)
    del p
    torch.cuda.empty_cache()
    check(len(line["phase_ms"]) == 14 and abs(line["loss"] - loss) <= 1e-5,
          f"instrument: {line} vs in process loss {loss}")
    res = prof_cli.wait()
    (trace,) = prof.glob("*.json")
    size = trace.stat().st_size
    names = {e.get("name") for e in json.loads(trace.read_text())[
        "traceEvents"]}
    print(f"full-width CLI, each process's wall time and peak resident set "
          f"(GB; sampled every 2 ms from /proc/<pid>/status; eval and export"
          f" ran together beside the steps in process), the f32 "
          f"tables being {table_bytes / 1e9:.2f} GB and the int8 ones "
          f"{INT8_BYTES / 1e9:.2f} GB: " + "; ".join(
              f"{k} {r.seconds:.2f} s, " + ", ".join(
                  f"{m} {v / 1e9:.3f}" for m, v in r.peak_rss.items())
              for k, r in rss.items()))
    for k, r in rss.items():
        # the export holds the int8 codes and scales on the host
        bound = (INT8_BYTES if k.startswith("export") else 0) + 8 * GIB
        check(0 < r.peak_rss.get("VmRSS", 0) < bound, f"{k}: peak resident "
              f"set {r.peak_rss}, more than {bound} B")

    kernels = {k for k in ("interaction_fwd_kernel", "interaction_bwd_kernel")
               if any(k in m for m in names if m)}
    check(set(_SCOPES) <= names and len(kernels) == 2
          and "profile written" in res.stderr,
          f"train --profile-dir: scopes {set(_SCOPES) & names}, kernels "
          f"{kernels}")
    print(f"at full width (both beside the export): instrument vs in "
          f"process: loss |diff| {abs(line['loss'] - loss):.3g} (instrument "
          f"{inst_cli.seconds:.2f} s); train --profile-dir "
          f"({prof_cli.seconds:.2f} s) wrote "
          f"{size} B of trace naming the four phase scopes "
          f"and {sorted(kernels)}")
    line = _run_cli(["bench", "--config", "kaggle", "--feature-size", "128",
                     "--batch-size", bsz, "--device", DEV.type])
    check(line["step_ms"] > 0 and line["examples_per_s"] > 0,
          f"bench line {line}")


def _two_epochs(loader):
    for _ in range(2):
        yield from loader


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script drives the port on "
              "the GPU and has nothing to run without one", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    kern = {}
    try:
        for phase in (phase_card, phase_kernels, phase_serving,
                      phase_training, phase_evaluation, phase_sharded,
                      phase_sharded_optim, phase_sharded_cli,
                      phase_optimizers, phase_checkpoint, phase_telemetry,
                      phase_int8_serving, phase_data, phase_two_tier,
                      phase_small_inputs, phase_small_optimizers,
                      phase_entry_points, phase_auc_curve,
                      phase_terabyte):
            t0 = time.perf_counter()
            kern.update(phase() or {})
            print(f"{phase.__name__}: {time.perf_counter() - t0:.1f} s")
    finally:
        with _START:
            _STOPPING.set()
        for c in list(_RUNNING):    # a phase failed with a CLI running
            c.stop()
    rows = []
    for (name, source, replaces), n in zip((
            ("interaction_fwd", "interaction_fwd.cu",
             "ops/interaction_pallas.py:47"),
            ("interaction_bwd", "interaction_bwd.cu",
             "ops/interaction_pallas.py:67"),
            ("host_gather", "host_tier.cu", "parallel/host_tier.py:279"),
            ("host_update_rows", "host_tier.cu",
             "parallel/host_tier.py:297")), LAUNCHES[:4]):
        rows.append({"name": name, "route": "cuda",
                     "source": f"dlrm_tpu_torch/csrc/{source}",
                     "replaces": f"dlrm_tpu/{replaces}",
                     "launches": n, **kern[name]})
    rows.append({"name": "dense_adagrad", "route": "cuda",
                 "source": "dlrm_tpu_torch/csrc/dense_adagrad.cu",
                 "replaces": "dlrm_tpu/train/optim.py:110 (optax.adagrad, "
                             "fused by XLA; no Pallas kernel)",
                 "launches": LAUNCHES[4], **kern["dense_adagrad"]})
    rows.append({"name": "sparse_adagrad", "route": "cuda",
                 "source": "dlrm_tpu_torch/csrc/sparse_adagrad.cu",
                 "replaces": "dlrm_tpu/train/optim.py (the dedup-then-apply "
                             "row-wise Adagrad, lowered by XLA; no Pallas "
                             "kernel)",
                 "launches": LAUNCHES[5], **kern["sparse_adagrad"]})
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
