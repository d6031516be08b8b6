"""Smoke run of dlrm_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero, printing no
result):
  1. the card (nvidia-smi name and power limit) and the kernel build;
  2. every hand-written kernel against its plain torch version on the card,
     at the main paths' shapes and at ragged / padded ones, f32 and bf16,
     on the two sources (x, feats) the model hands over, timed with CUDA
     events; the forward on the stacked T's views gives the same bits, and
     takes the bulk-copy path wherever the rows allow it; the fused
     interaction's autograd gradient against autograd through the gram
     interaction;
  3. serving: Kaggle fs=128 at full width (26 tables, 33.76 M rows x 128 in
     f32, random weights from a seed) scoring batches of 16384 through the
     scoring function of `predict`, with the kernels' launch counts (and
     the forward's bulk-copy launches) read around it, then a
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
  6. the optimizers at full width: 4 Adagrad and 4 row-wise Adagrad steps at
     B=32768 with a step of each held against the plain formula on the rows
     it touched, row-wise fused against gram from a clone, a clipped SGD
     step, K=4 blocks of each optimizer against 4 sequential steps, then
     the step times of the three optimizers at K=1 and K=4 in turns, a
     `torch.profiler` breakdown of the Adagrad step and the time of an
     `evaluate` batch;
  7. int8 serving at full width: the serving phase's tables (the same
     seed) quantized on the card, codes and scales held bit for bit to the
     host quantizer on the first and last 4096 rows of every table, the
     footprint read; 8 batches of 16384 through `score_batch` on the int8
     tables (launch counts read around them), held to the f32 scores
     within 5e-3; int8 against f32 serving times in turns, a
     `torch.profiler` breakdown of an int8 batch, and `predict
     --quantize-tables int8` in a subprocess against the port in process;
  8. data: Criteo text written from a seed at the full Kaggle table sizes,
     `python -m dlrm_tpu_torch preprocess` (the native engine) against the
     numpy path byte for byte, `train --data --validate-data --prefetch 2`
     at full width in a subprocess against the same steps in process with
     plain copies (and through `device_prefetch`, launch counts read
     around both), `--validate-data` refusing a file that does not fit
     the tables, then the SGD step fed from `DACLoader` through
     `device_prefetch` and through plain copies, in turns, and a profile of
     each (host-to-device copy time, its stream, idle share);
  9. small inputs: the forward, and 3 training steps, on the card against
     the same on the CPU for every interaction, f32, bf16 and multi-hot;
     3 steps and a K=3 block of every optimizer likewise;
 10. the entry points: `python -m dlrm_tpu_torch predict`, `train` and
     `eval` in subprocesses on the card, held against the port in process;
 11. a `{"kernels": [...]}` line, then the result line.
It needs a CUDA device and the repository around it; without either it
fails.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import statistics
import subprocess
import sys
import tempfile
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
# launches of [interaction_fwd, interaction_bwd] summed over the main paths
LAUNCHES = [0, 0]


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
    for stem in ("interaction_fwd", "interaction_bwd"):
        for line in cuda_build.build_log(stem).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {stem}:", line.strip())


def _bound(kname: str, inputs: list, outputs: list, b: int, f: int,
           d: int) -> dict:
    """The least time the card could take for one call: every input read
    once and every output written once at the HBM rate, against the f32
    multiply-adds the function needs at the f32 peak.  Forward: the P pair
    dots of D products per sample.  Backward: dT = (dZ + dZ^T) T, F * F * D
    products per sample.  The byte count does not depend on how the
    inputs are laid out (one T, or x and feats apart)."""
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


def phase_kernels() -> dict:
    """Both kernels against their plain versions at every shape a main
    path gives them ((16384, 27, 128) serving and evaluation, (32768, 27,
    128) training steps and blocks, (8192, 27, 128) the clipped step) and
    at narrow and ragged ones, on the two sources x = T[:, 0] and feats =
    T[:, 1:] as the model hands them over; the forward also on the T-view
    form, which must give the same bits.  Rows of 16-byte multiples take
    the forward's bulk-copy path, the rows of (13, 5, 6) its plain-load
    path.  Returns the numbers at (16384, 27, 128) f32, per kernel."""
    from dlrm_tpu_torch.ops import interaction_fused as F
    from dlrm_tpu_torch.ops.interaction import dot_interaction

    g = torch.Generator(DEV).manual_seed(0)
    main = {}
    print("kernel vs plain (B, F, D, pad_to, dtype): max_abs_err, kernel ms, "
          "plain ms")
    for b, f, d in [(BATCH, 27, 128), (TRAIN_BATCH, 27, 128),
                    (CLIP_BATCH, 27, 128), (BATCH, 27, 16), (107, 27, 128),
                    (13, 4, 8), (13, 5, 6)]:
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
                    if kname == "interaction_fwd":
                        p = f * (f - 1) // 2
                        check(bool((got[:, d + p:] == 0).all()),
                              "padding columns not zero")
                        bulk = _fwd_views_agree(F, t, pad_to, got)
                        check(bulk == ((d * t.element_size()) % 16 == 0),
                              f"interaction_fwd at {(b, f, d)} {name}: bulk "
                              f"path {bulk}")
                    torch.testing.assert_close(got.float(), ref.float(),
                                               atol=1e-4, rtol=rtol)
                    err = (got.float() - ref.float()).abs().max().item()
                    ms, plain_ms = timed_pair(kern, plain)
                    print(f"  {kname} ({b}, {f}, {d}, {pad_to}, {name}): "
                          f"{err:.3g}, {ms:.4f}, {plain_ms:.4f}")
                    if (b, d, pad_to, dtype) == (BATCH, 128, 1,
                                                 torch.float32):
                        if kname == "interaction_fwd":
                            ins, outs = [x, feats], [got]
                        else:  # dx and dfeats have the sizes of x, feats
                            ins, outs = [cot, x, feats], [x, feats]
                        main[kname] = {
                            "max_abs_err": err, "ms": ms,
                            "plain_ms": plain_ms,
                            **_bound(kname, ins, outs, b, f, d),
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
    return main


@contextlib.contextmanager
def counted(what: str, fwd: int, bwd: int):
    """A main path: both kernels' counts are set to 0 before it and read
    after it; it must have launched them ``fwd`` and ``bwd`` times, every
    forward on the bulk-copy path.  The counts are added to LAUNCHES."""
    from dlrm_tpu_torch.ops import interaction_fused as F

    F.interaction_fwd.launches = 0
    F.interaction_fwd.bulk_launches = 0
    F.interaction_bwd.launches = 0
    yield
    got = (F.interaction_fwd.launches, F.interaction_bwd.launches)
    check(got == (fwd, bwd), f"{what} launched interaction_fwd {got[0]} and "
          f"interaction_bwd {got[1]} times, not {fwd} and {bwd}")
    check(F.interaction_fwd.bulk_launches == fwd,
          f"{what}: {fwd - F.interaction_fwd.bulk_launches} of {fwd} "
          f"interaction_fwd launches did not take the bulk-copy path")
    LAUNCHES[0] += fwd
    LAUNCHES[1] += bwd


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


# (group, substrings of a CUDA activity's name); the first match wins
_PROFILE_GROUPS = (
    ("dedup: sort, unique, scan (cub and thrust kernels)",
     ("cub::", "thrust::")),
    ("MLP GEMMs (gemm, gemv, split-K reduce)",
     ("gemm", "gemv", "splitKreduce")),
    ("sparse update (index_add_)", ("indexFuncLargeIndex",
                                    "indexFuncSmallIndex")),
    ("embedding gather (index_select)", ("gather_kernel", "indexSelect")),
    ("host-to-device copies", ("Memcpy HtoD",)),
    ("interaction_bwd kernel", ("interaction_bwd_kernel",)),
    ("interaction_fwd kernel", ("interaction_fwd_kernel",)),
    ("torch.cat (none on the fused path)", ("CatArrayBatched",)),
    ("device copies (direct_copy_kernel)", ("direct_copy",)),
)


def _profile_steps(what: str, run, batches, steps: int = 5,
                   pooled_bytes: int = 0, groups=()) -> None:
    """`torch.profiler` over ``steps`` steps (or served batches) after 3
    warm-up ones: device time a step by group, and the device's idle share
    of the host-to-host window.  ``run(data)`` takes one step a batch of
    ``data``, reading each result back.

    With ``pooled_bytes`` (the size of the pooled embeddings, or of their
    gradient) the fused path is held to what it promises: no `torch.cat`
    kernel (T is never stacked) and no copy kernel as long as copying that
    many bytes takes at the HBM rate (the embedding gradient reaches the
    update as a view).  ``groups`` are matched before the common ones.
    The host-to-device copies are listed by kind and CUDA stream, beside
    the stream the forward kernel ran on."""
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
    other = {}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
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
        return
    print(f"profile, {steps} {what} after 3: {busy_ms / steps:.3f} ms of "
          f"device time a step, {wall_ms / steps:.3f} ms host to host a "
          f"step, device idle {100 * (1 - busy_ms / wall_ms):.1f}%")
    for name, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {name}: {us / 1e3 / steps:.3f} ms a step "
              f"({100 * us / 1e3 / busy_ms:.1f}%)")
    for key, us in sorted(other.items(), key=lambda kv: -kv[1])[:6]:
        print(f"    of all else: {us / 1e3 / steps:.3f} ms a step: "
              f"{key[:110]}")
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


def _to_dev(batch: dict) -> list:
    return [torch.as_tensor(batch[k]).to(DEV) for k in KEYS]


def _stack(batches: list) -> dict:
    return {k: np.stack([b[k] for b in batches]) for k in KEYS}


def _all_ids(batches: list, config) -> torch.Tensor:
    """The distinct stacked-table rows that ``batches`` touch (int64)."""
    from dlrm_tpu_torch.ops.embedding import translate_ids

    return torch.unique(torch.cat([
        translate_ids(torch.from_numpy(b["sparse"]).to(DEV),
                      config.table_offsets).reshape(-1)
        for b in batches])).long()


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
    with counted(f"{optimizer} block", BLOCK, BLOCK):
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
                     OPT_STEPS * fused):
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
        with counted(f"{opt} steps", OPT_STEPS, OPT_STEPS), _deterministic():
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


def _cli(args: list, ok: bool = True) -> subprocess.CompletedProcess:
    """``python -m dlrm_tpu_torch *args``; it must exit 0 (``ok``) or not."""
    res = subprocess.run([sys.executable, "-m", "dlrm_tpu_torch", *args],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=600)
    check((res.returncode == 0) == ok,
          f"{args[0]} exited {res.returncode}: {res.stderr[-2000:]}")
    return res


def _run_cli(args: list, on_device: bool = True) -> dict:
    line = json.loads(_cli(args).stdout.strip().splitlines()[-1])
    print(f"{args[0]}: {line}")
    check(not on_device or line.get("device") == DEV.type,
          f"{args[0]} ran on {line}")
    return line


def _write_dac(path: str, n: int, rng) -> None:
    from dlrm_tpu_torch.data.criteo import DAC_DTYPE

    rec = np.zeros(n, dtype=DAC_DTYPE)
    rec["label"] = rng.integers(0, 2, size=n)
    rec["dense"] = np.log1p(rng.integers(0, 1000, size=(n, 13)))
    rec["cat"] = np.stack([rng.integers(1, s + 1, size=n) for s in TABLES],
                          axis=1)
    rec.tofile(path)


def phase_entry_points() -> None:
    """`python -m dlrm_tpu_torch predict`, `train` and `eval` on the
    card."""
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
    with _scratch() as tmp:
        data, pz, out = (str(tmp / f)
                         for f in ("data.bin", "params.npz", "scores.npy"))
        _write_dac(data, n, rng)
        params = init_params(torch.Generator().manual_seed(11), config)
        save_npz(pz, params_to_numpy(params))
        line = _run_cli(["predict", "--config", "tiny", "--table-sizes",
                         tables, "--data", data, "--params", pz, "--out",
                         out, "--batch-size", "256", "--interaction", "fused",
                         "--device", DEV.type])
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
        for name, (flags, stream) in runs.items():
            line = _run_cli(["train", "--config", "tiny", "--table-sizes",
                             tables, "--interaction", "fused", "--device",
                             DEV.type, *flags])
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

        # the full recipe: row-wise Adagrad in blocks of 4 (10 steps: 4, 4
        # and a remainder of 2), evaluated after
        line = _run_cli(["train", "--config", "tiny", "--table-sizes", tables,
                         "--interaction", "fused", "--device", DEV.type,
                         "--optimizer", "rowwise_adagrad",
                         "--update-interval", "4", "--eval-after",
                         "--synthetic", "skewed", "--steps", "10",
                         "--batch-size", "128"])
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

        save_npz(pz, params_to_numpy(p))
        line = _run_cli(["eval", "--config", "tiny", "--table-sizes", tables,
                         "--interaction", "fused", "--device", DEV.type,
                         "--data", data, "--params", pz, "--batch-size",
                         "256"])
        want = evaluate(p, DACLoader(load(data), 256, drop_remainder=False),
                        config)
        diffs = [abs(line[k] - want[k]) for k in ("loss", "auc", "accuracy")]
        check(line["examples"] == n and max(diffs) <= 1e-6,
              f"eval: CLI {line} vs in process {want}")
        print(f"eval --params: CLI vs in process over {n} rows (ragged tail "
              f"of {n % 256}): loss, AUC, accuracy |diff| "
              f"{[f'{d:.3g}' for d in diffs]}")


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

    phase_card()
    kern = phase_kernels()
    phase_serving()
    phase_training()
    phase_evaluation()
    phase_optimizers()
    phase_int8_serving()
    phase_data()
    phase_small_inputs()
    phase_small_optimizers()
    phase_entry_points()
    rows = []
    for (name, line), n in zip((("interaction_fwd", 47),
                                ("interaction_bwd", 67)), LAUNCHES):
        rows.append({"name": name, "route": "cuda",
                     "source": f"dlrm_tpu_torch/csrc/{name}.cu",
                     "replaces": f"dlrm_tpu/ops/interaction_pallas.py:{line}",
                     "launches": n, **kern[name]})
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
