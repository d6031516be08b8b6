"""Smoke run of dlrm_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero, printing no
result):
  1. the card (nvidia-smi name and power limit) and the kernel build;
  2. every hand-written kernel against its plain torch version on the card,
     at the main paths' shapes and at ragged / padded ones, f32 and bf16,
     timed with CUDA events; the fused interaction's autograd gradient
     against autograd through the gram interaction;
  3. serving: Kaggle fs=128 at full width (26 tables, 33.76 M rows x 128 in
     f32, random weights from a seed) scoring batches of 16384 through the
     scoring function of `predict`, with the kernels' launch counts read
     around it;
  4. training: the same model, 8 exact-SGD steps at B=32768 through
     `dlrm_tpu_torch.train`, launch counts read around them; 4 steps from a
     copy of the same start under the gram interaction give the same
     losses, dense parameters and touched table rows; then the step time
     under fused and gram in turns, and a `torch.profiler` breakdown of
     the fused step by kernel group with the device's idle share;
  5. small inputs: the forward, and 3 training steps, on the card against
     the same on the CPU for every interaction, f32, bf16 and multi-hot;
  6. the entry points: `python -m dlrm_tpu_torch predict` and `train` in
     subprocesses on the card, held against the port in process;
  7. a `{"kernels": [...]}` line, then the result line.
It needs a CUDA device and the repository around it; without either it
fails.
"""

from __future__ import annotations

import dataclasses
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
BATCH = 16384          # serving batch
TRAIN_BATCH = 32768    # the reference experiment's training batch
MAIN_BATCHES = 8
TRAIN_STEPS = 8
TABLES = (5, 300, 17, 2000, 3, 60) * 4 + (9, 700)  # 26 small tables


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


def phase_kernels() -> dict:
    """Both kernels against their plain versions; returns the numbers at
    the main shape, (16384, 27, 128) f32, per kernel."""
    from dlrm_tpu_torch.ops import interaction_fused as F
    from dlrm_tpu_torch.ops.interaction import dot_interaction

    g = torch.Generator("cuda").manual_seed(0)
    main = {}
    print("kernel vs plain (B, F, D, pad_to, dtype): max_abs_err, kernel ms, "
          "plain ms")
    for b, f, d in [(BATCH, 27, 128), (BATCH, 27, 16), (107, 27, 128),
                    (13, 4, 8)]:
        for pad_to in (1, 128):
            for dtype in (torch.float32, torch.bfloat16):
                t = torch.randn((b, f, d), generator=g, device="cuda"
                                ).to(dtype)
                width = F.output_width(f, d, pad_to)
                # nonzero padding columns: the backward must ignore them
                cot = torch.randn((b, width), generator=g, device="cuda"
                                  ).to(dtype)
                # f32: sums in another order; bf16: plus one rounding of
                # the output
                rtol = 1e-5 if dtype == torch.float32 else 1e-2
                cases = {
                    "interaction_fwd": (
                        lambda: F.interaction_fwd(t, pad_to),
                        lambda: F.fused_interaction_t_reference(t, pad_to)),
                    "interaction_bwd": (
                        lambda: F.interaction_bwd(cot, t),
                        lambda: F.fused_interaction_t_bwd_reference(cot, t)),
                }
                name = "f32" if dtype == torch.float32 else "bf16"
                for kname, (kern, plain) in cases.items():
                    got, ref = kern(), plain()
                    torch.cuda.synchronize()
                    check(got.shape == ref.shape and got.dtype == dtype,
                          f"{kname}: shape/dtype {tuple(got.shape)} "
                          f"{got.dtype}")
                    if kname == "interaction_fwd":
                        p = f * (f - 1) // 2
                        check(bool((got[:, d + p:] == 0).all()),
                              "padding columns not zero")
                    torch.testing.assert_close(got.float(), ref.float(),
                                               atol=1e-4, rtol=rtol)
                    err = (got.float() - ref.float()).abs().max().item()
                    ms, plain_ms = timed_pair(kern, plain)
                    print(f"  {kname} ({b}, {f}, {d}, {pad_to}, {name}): "
                          f"{err:.3g}, {ms:.4f}, {plain_ms:.4f}")
                    if (b, d, pad_to, dtype) == (BATCH, 128, 1,
                                                 torch.float32):
                        main[kname] = {"max_abs_err": err, "ms": ms,
                                       "plain_ms": plain_ms}

    # autograd through the fused Function against autograd through gram,
    # at the main shape: (x, feats) = T's row 0 and rows 1.. (fs = D)
    t = torch.randn((BATCH, 27, 128), generator=g, device="cuda")
    cot = torch.randn((BATCH, F.output_width(27, 128, 1)), generator=g,
                      device="cuda")
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


def _reset_counts():
    from dlrm_tpu_torch.ops import interaction_fused as F
    F.interaction_fwd.launches = 0
    F.interaction_bwd.launches = 0


def _counts():
    from dlrm_tpu_torch.ops import interaction_fused as F
    return F.interaction_fwd.launches, F.interaction_bwd.launches


def phase_serving() -> None:
    """Kaggle fs=128 at full width, scoring through `predict`'s scoring
    function."""
    from dlrm_tpu_torch import init_params, kaggle_config
    from dlrm_tpu_torch.data.synthetic import batch_stream
    from dlrm_tpu_torch.run import score_batch

    dev = torch.device("cuda:0")
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

    _reset_counts()
    scores, secs = [], []
    for batch in batches:
        t0 = time.perf_counter()
        scores.append(score_batch(params, batch, config, dev))
        secs.append(time.perf_counter() - t0)
    fwd, bwd = _counts()

    check((fwd, bwd) == (len(batches), 0),
          f"serving launched interaction_fwd {fwd} and interaction_bwd {bwd} "
          f"times for {len(batches)} batches")
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


def phase_training() -> tuple:
    """Kaggle fs=128 at full width, 8 SGD steps at B=32768 through
    `dlrm_tpu_torch.train`; returns the kernels' launches in that run."""
    from dlrm_tpu_torch import init_params, kaggle_config, train
    from dlrm_tpu_torch.data.synthetic import batch_stream
    from dlrm_tpu_torch.ops.embedding import translate_ids

    dev = torch.device("cuda:0")
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

    _reset_counts()
    first = train(params, batches[:half], config=config, lr=0.1)
    mid_rows = params["emb"][touched].clone()
    mid_dense = _clone_dense(params)
    second = train(params, batches[half:], config=config, lr=0.1)
    torch.cuda.synchronize(dev)
    fwd, bwd = _counts()

    check((fwd, bwd) == (TRAIN_STEPS, TRAIN_STEPS),
          f"training launched interaction_fwd {fwd} and interaction_bwd "
          f"{bwd} times for {TRAIN_STEPS} steps")
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
    _profile_steps(params, batches, config)
    del params, start, mid_rows
    torch.cuda.empty_cache()
    return fwd, bwd


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
    ("MLP GEMMs (gemm, gemv, split-K reduce)",
     ("gemm", "gemv", "splitKreduce")),
    ("sparse update (index_add_)", ("indexFuncLargeIndex",
                                    "indexFuncSmallIndex")),
    ("embedding gather (index_select)", ("gather_kernel", "indexSelect")),
    ("host-to-device copies", ("Memcpy HtoD",)),
    ("interaction_bwd kernel", ("interaction_bwd_kernel",)),
    ("interaction_fwd kernel", ("interaction_fwd_kernel",)),
    ("torch.cat in stack_features (builds T)", ("CatArrayBatched",)),
    ("device copies (direct_copy_kernel)", ("direct_copy",)),
)


def _profile_steps(params, batches, config, steps: int = 5) -> None:
    """`torch.profiler` over ``steps`` training steps through `train` after
    3 warm-up steps: device time a step by group, and the device's idle
    share of the host-to-host window."""
    from torch.profiler import ProfilerActivity, profile

    from dlrm_tpu_torch import train

    train(params, batches[:3], config=config, lr=0.1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train(params, (batches[i % len(batches)] for i in range(steps)),
              config=config, lr=0.1)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    groups = {name: 0.0 for name, _ in _PROFILE_GROUPS}
    other = 0.0
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = evt.self_device_time_total
        for name, keys in _PROFILE_GROUPS:
            if any(k in evt.key for k in keys):
                groups[name] += us
                break
        else:
            other += us
    groups["elementwise and reductions (all else)"] = other
    busy_ms = sum(groups.values()) / 1e3
    if busy_ms == 0:
        print("training profile: the profiler recorded no device time "
              "(not measured)")
        return
    print(f"training profile, {steps} fused steps after 3: "
          f"{busy_ms / steps:.3f} ms of device time a step, "
          f"{wall_ms / steps:.3f} ms host to host a step, device idle "
          f"{100 * (1 - busy_ms / wall_ms):.1f}%")
    for name, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {name}: {us / 1e3 / steps:.3f} ms a step "
              f"({100 * us / 1e3 / busy_ms:.1f}%)")


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

    cuda, cpu = torch.device("cuda"), torch.device("cpu")
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


def _run_cli(args: list) -> dict:
    res = subprocess.run([sys.executable, "-m", "dlrm_tpu_torch", *args],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=600)
    check(res.returncode == 0,
          f"{args[0]} exited {res.returncode}: {res.stderr[-2000:]}")
    line = json.loads(res.stdout.strip().splitlines()[-1])
    print(f"{args[0]}: {line}")
    check(line.get("device") == "cuda", f"{args[0]} ran on {line}")
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
    """`python -m dlrm_tpu_torch predict` and `train` on the card."""
    from dlrm_tpu_torch import init_params, tiny_config, train
    from dlrm_tpu_torch.data.criteo import DACLoader, load
    from dlrm_tpu_torch.data.synthetic import ClickthroughModel
    from dlrm_tpu_torch.io.convert import params_to_numpy, save_npz
    from dlrm_tpu_torch.run import score_batch

    n = 1000
    config = dataclasses.replace(tiny_config(), table_sizes=TABLES,
                                 interaction_impl="fused")
    tables = ",".join(map(str, TABLES))
    rng = np.random.default_rng(7)
    cuda = torch.device("cuda")
    build = REPO / "dlrm_tpu_torch" / "_build"
    build.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        data, pz, out = (str(Path(tmp) / f)
                         for f in ("data.bin", "params.npz", "scores.npy"))
        _write_dac(data, n, rng)
        params = init_params(torch.Generator().manual_seed(11), config)
        save_npz(pz, params_to_numpy(params))
        line = _run_cli(["predict", "--config", "tiny", "--table-sizes",
                         tables, "--data", data, "--params", pz, "--out",
                         out, "--batch-size", "256", "--interaction", "fused",
                         "--device", "cuda"])
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
                             "cuda", *flags])
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
    launches = phase_training()
    phase_small_inputs()
    phase_entry_points()
    rows = []
    for (name, line), n in zip((("interaction_fwd", 47),
                                ("interaction_bwd", 67)), launches):
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
