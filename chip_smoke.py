"""Smoke run of dlrm_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero, printing no
result):
  1. the card (nvidia-smi name and power limit) and the kernel build;
  2. every hand-written kernel against its plain torch version on the card,
     at the main path's shapes and at ragged / padded ones, f32 and bf16,
     timed with CUDA events;
  3. the main path: Kaggle fs=128 at full width (26 tables, 33.76 M rows x
     128 in f32, random weights from a seed) scoring batches of 16384
     through the scoring function of `predict`, with the kernels' launch
     counts read around it;
  4. small inputs: the forward on the card against the forward on the CPU
     for every interaction, f32, bf16 and multi-hot;
  5. the entry point: `python -m dlrm_tpu_torch predict` on a small
     binarized file, its scores held against the port's CPU forward;
  6. a `{"kernels": [...]}` line, then the result line.
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
BATCH = 16384
MAIN_BATCHES = 8


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
    for line in cuda_build.build_log("interaction_fwd").splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())


def phase_kernels() -> dict:
    """Kernel against plain version; returns the main-path-shape numbers."""
    from dlrm_tpu_torch.ops.interaction_fused import (
        fused_interaction_t, fused_interaction_t_reference)

    g = torch.Generator("cuda").manual_seed(0)
    main = {}
    print("interaction_fwd vs plain (B, F, D, pad_to, dtype): max_abs_err, "
          "kernel ms, plain ms")
    for b, f, d in [(BATCH, 27, 128), (BATCH, 27, 16), (107, 27, 128),
                    (13, 4, 8)]:
        for pad_to in (1, 128):
            for dtype in (torch.float32, torch.bfloat16):
                t = torch.randn((b, f, d), generator=g, device="cuda"
                                ).to(dtype)
                got = fused_interaction_t(t, pad_to)
                ref = fused_interaction_t_reference(t, pad_to)
                torch.cuda.synchronize()
                check(got.shape == ref.shape and got.dtype == dtype,
                      f"shape/dtype {tuple(got.shape)} {got.dtype}")
                p = f * (f - 1) // 2
                check(bool((got[:, d + p:] == 0).all()),
                      "padding columns not zero")
                # f32: sums over D in another order; bf16: plus one
                # rounding of the output
                rtol = 1e-5 if dtype == torch.float32 else 1e-2
                torch.testing.assert_close(got.float(), ref.float(),
                                           atol=1e-4, rtol=rtol)
                err = (got.float() - ref.float()).abs().max().item()
                plain = time_ms(lambda: fused_interaction_t_reference(
                    t, pad_to))
                kern = time_ms(lambda: fused_interaction_t(t, pad_to))
                kern += time_ms(lambda: fused_interaction_t(t, pad_to))
                plain += time_ms(lambda: fused_interaction_t_reference(
                    t, pad_to))
                ms, plain_ms = statistics.median(kern), statistics.median(plain)
                name = "f32" if dtype == torch.float32 else "bf16"
                print(f"  ({b}, {f}, {d}, {pad_to}, {name}): {err:.3g}, "
                      f"{ms:.4f}, {plain_ms:.4f}")
                if (b, f, d, pad_to, dtype) == (BATCH, 27, 128, 1,
                                                torch.float32):
                    main = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
    t = torch.randn((8, 27, 128), device="cuda", requires_grad=True)
    try:
        fused_interaction_t(t)
    except NotImplementedError:
        pass
    else:
        raise RuntimeError("chip_smoke: the CUDA path accepted a tensor that "
                           "needs a gradient")
    return main


def phase_main_path() -> int:
    """Kaggle fs=128 at full width; returns the kernel's launches."""
    from dlrm_tpu_torch import init_params, kaggle_config
    from dlrm_tpu_torch.data.synthetic import batch_stream
    from dlrm_tpu_torch.ops.interaction_fused import fused_interaction_t
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

    fused_interaction_t.launches = 0
    scores, secs = [], []
    for batch in batches:
        t0 = time.perf_counter()
        scores.append(score_batch(params, batch, config, dev))
        secs.append(time.perf_counter() - t0)
    launches = fused_interaction_t.launches

    check(launches == len(batches),
          f"interaction_fwd launched {launches} times for {len(batches)} "
          "batches")
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
    print(f"main path: {len(batches)} batches of {BATCH}, first "
          f"{secs[0] * 1e3:.1f} ms, then median "
          f"{statistics.median(steady) * 1e3:.2f} ms/batch = "
          f"{BATCH / statistics.median(steady):.0f} examples/s (host to "
          f"host, inputs copied in, scores copied out); fused vs gram max "
          f"|diff| {diff:.3g}; mean score {np.mean(scores):.6f}")
    print(f"peak device memory: "
          f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB")
    del params
    torch.cuda.empty_cache()
    return launches


def phase_small_inputs() -> None:
    """The port on the card against the port on the CPU (which the tests
    hold against dlrm_tpu), for every interaction and the dtype / multi-hot
    options, on small inputs."""
    from dlrm_tpu_torch import forward, init_params, tiny_config
    from dlrm_tpu_torch.data.synthetic import random_batch

    base = dataclasses.replace(tiny_config(feature_size=16),
                               table_sizes=(5, 300, 17, 2000, 3, 60) * 4
                               + (9, 700), small_table_threshold=100)
    variants = {
        "f32": {},
        "bf16": {"compute_dtype": torch.bfloat16,
                 "embedding_dtype": torch.bfloat16},
        "multihot": {"n_hot": 3, "interaction_pad_to": 64},
    }
    cuda = torch.device("cuda")
    for impl in ("gram", "pairwise", "fused"):
        for name, kw in variants.items():
            config = dataclasses.replace(base, interaction_impl=impl, **kw)
            params = init_params(torch.Generator().manual_seed(3), config)
            on_card = {k: ([{n: v.to(cuda) for n, v in layer.items()}
                            for layer in p] if k != "emb" else p.to(cuda))
                       for k, p in params.items()}
            batch = random_batch(np.random.default_rng(5), config, 333)
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
            print(f"small inputs, {impl}/{name}: card vs CPU max |diff| "
                  f"{diff:.3g}")


def phase_entry_point() -> None:
    """`python -m dlrm_tpu_torch predict` on a small binarized file."""
    from dlrm_tpu_torch import init_params, tiny_config
    from dlrm_tpu_torch.data.criteo import DAC_DTYPE, DACLoader, load
    from dlrm_tpu_torch.io.convert import params_to_numpy, save_npz
    from dlrm_tpu_torch.run import score_batch

    tables = (5, 300, 17, 2000, 3, 60) * 4 + (9, 700)
    n = 1000
    config = dataclasses.replace(tiny_config(), table_sizes=tables,
                                 interaction_impl="fused")
    rng = np.random.default_rng(7)
    build = REPO / "dlrm_tpu_torch" / "_build"
    build.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        data, pz, out = (str(Path(tmp) / f)
                         for f in ("data.bin", "params.npz", "scores.npy"))
        rec = np.zeros(n, dtype=DAC_DTYPE)
        rec["label"] = rng.integers(0, 2, size=n)
        rec["dense"] = np.log1p(rng.integers(0, 1000, size=(n, 13)))
        rec["cat"] = np.stack([rng.integers(1, s + 1, size=n)
                               for s in tables], axis=1)
        rec.tofile(data)
        params = init_params(torch.Generator().manual_seed(11), config)
        save_npz(pz, params_to_numpy(params))
        cmd = [sys.executable, "-m", "dlrm_tpu_torch", "predict",
               "--config", "tiny", "--table-sizes", ",".join(map(str, tables)),
               "--data", data, "--params", pz, "--out", out,
               "--batch-size", "256", "--interaction", "fused"]
        res = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                             timeout=600)
        check(res.returncode == 0,
              f"predict exited {res.returncode}: {res.stderr[-2000:]}")
        line = json.loads(res.stdout.strip().splitlines()[-1])
        print(f"predict: {line}")
        check(line["examples"] == n and line["out"] == out,
              f"predict line {line}")
        got = np.load(out)
        check(got.shape == (n,), f"scores shape {got.shape}")
        cpu = torch.device("cpu")
        want = score_batch(params, DACLoader(load(data), n)[0], config, cpu)
        diff = float(np.abs(got - want).max())
        check(diff <= 1e-5, f"predict on the card vs CPU forward: {diff}")
        print(f"predict on the card vs the port's CPU forward: max |diff| "
              f"{diff:.3g} over {n} rows (ragged tail of {n % 256})")


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
    launches = phase_main_path()
    phase_small_inputs()
    phase_entry_point()
    print(json.dumps({"kernels": [{
        "name": "interaction_fwd", "route": "cuda",
        "source": "dlrm_tpu_torch/csrc/interaction_fwd.cu",
        "replaces": "dlrm_tpu/ops/interaction_pallas.py:47",
        "launches": launches, **kern}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
