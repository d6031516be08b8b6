"""The fused interaction backward on an NVIDIA GPU: the port's kernel
(dlrm_tpu_torch/csrc/interaction_bwd.cu) against the first design
(probes/interaction_bwd_probe.cu: the one-shot grid that stages its
samples synchronously, with 4x4 register tiles, on the same two sources).

    python3 probes/interaction_bwd_probe.py        # needs one CUDA card, ~1 min

At the five shapes the main paths give the backward ((16384, 27, 128)
serving-size steps, (32768, 27, 128) training steps and blocks, (8192, 27,
128) the clipped step, Terabyte's (32768, 27, 32) and (16384, 27, 32)), f32
and bf16, with the cotangent's width D + P (``pad_to=1``, as on the main
paths):
  1. both kernels against the plain version
     (``fused_interaction_bwd_reference``): f32 atol 1e-4 / rtol 1e-5 (sums
     in another order), bf16 rtol 1e-2 (plus one rounding of the output);
  2. their times from CUDA events, in turns (first, port, port, first),
     medians, beside the bound: x, feats and the cotangent's D + P columns
     read once, dx and dfeats written once, at 3.35 TB/s (or the f32 FMAs
     at 67 TFLOP/s, whichever is longer);
  3. what the card's copy of the same T bytes takes (``dt.copy_(t)``: T
     read once and written once), the rate a kernel that only moves those
     bytes reaches on this card;
  4. the port's kernel with its persistent grid capped at one and two
     blocks an SM, and the first design's ptxas report beside the port's.
Prints the card's name and power limit first and all numbers as one JSON
line last.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from dlrm_tpu_torch.ops import cuda_build  # noqa: E402
from dlrm_tpu_torch.ops import interaction_fused as F  # noqa: E402

DEV = torch.device("cuda:0")
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
SHAPES = ((16384, 27, 128), (32768, 27, 128), (8192, 27, 128),
          (32768, 27, 32), (16384, 27, 32))
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def tms(fn, reps: int = 7, inner: int = 10) -> list:
    """Per-call ms of ``fn`` over ``reps`` windows of ``inner`` calls."""
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
    return out


def build():
    """The first design's library, and the ptxas lines of both builds."""
    lib = cuda_build.BUILD_DIR / "libinteraction_bwd_probe.so"
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o", str(lib),
           str(Path(__file__).with_suffix(".cu"))]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    cuda_build.load_kernels()
    out = ctypes.CDLL(str(lib))
    out.probe_bwd_first.argtypes = [_P, _P, _L, _P, _L, _P, _L, _P, _L, _I,
                                    _L, _I, _I, _I, _I, _I, _I, _P]
    out.probe_bwd_first.restype = _I

    def regs(log):
        return [line.strip() for line in log.splitlines()
                if "registers" in line or "spill" in line]

    return out, {"first": regs(proc.stdout + proc.stderr),
                 "port": regs(cuda_build.build_log("interaction_bwd"))}


def first_samples(b: int, f: int, d: int) -> int:
    """Samples a block of the first design: of the counts whose staging
    (T at round_up(D, 4) floats a row, S at round_up(F, 4)) fits 48 KiB,
    the one whose 4x4 tiles fill 256-thread passes best."""
    r4 = lambda v: -(-v // 4) * 4  # noqa: E731
    per_sample = (f * r4(d) + f * r4(f)) * 4
    tiles = r4(f) // 4 * (r4(d) // 4)
    most = max(1, min(b, 48 * 1024 // per_sample))

    def fill(s):
        return s * tiles / (-(-s * tiles // 256) * 256), s

    return max(range(1, most + 1), key=fill)


def first(lib, cot, x, feats, dx, dfeats):
    """A call of the first design (every row 16-byte aligned here)."""
    b, d = x.shape
    f = 1 + feats.shape[1] * feats.shape[2] // d
    esize = x.element_size()
    args = (cot.data_ptr(), x.data_ptr(), x.stride(0), feats.data_ptr(),
            feats.stride(0), dx.data_ptr(), dx.stride(0), dfeats.data_ptr(),
            dfeats.stride(0), F._DTYPE_CODES[x.dtype], b, f, d, cot.shape[1],
            first_samples(b, f, d), int(d * esize % 16 == 0),
            int(d % 4 == 0), torch.cuda.current_stream().cuda_stream)

    def run():
        rc = lib.probe_bwd_first(*args)
        if rc:
            raise RuntimeError(f"probe_bwd_first: CUDA error {rc}")

    return run


def capped(cot, x, feats, dx, dfeats, per_sm: int):
    """The port's kernel with its grid capped at ``per_sm`` blocks an SM."""
    b, d = x.shape
    f = 1 + feats.shape[1] * feats.shape[2] // d
    geometry = F._bwd_launch_geometry(b, f, d, x.element_size())
    group, stages, pitch, threads = geometry
    sms = torch.cuda.get_device_properties(DEV).multi_processor_count
    blocks = min(-(-b // group), per_sm * sms)
    fn = F._kernel("interaction_bwd", F._BWD_ARGS)
    args = (cot.data_ptr(), cot.shape[1], x.data_ptr(), x.stride(0),
            feats.data_ptr(), feats.stride(0), dx.data_ptr(), dx.stride(0),
            dfeats.data_ptr(), dfeats.stride(0), F._DTYPE_CODES[x.dtype], b,
            f, d, pitch, group, stages, threads, blocks, 1, 1,
            torch.cuda.current_stream().cuda_stream)

    def run():
        rc = fn(*args)
        if rc:
            raise RuntimeError(f"interaction_bwd: CUDA error {rc}")

    return run


def bound_ms(b: int, f: int, d: int, esize: int) -> float:
    p = f * (f - 1) // 2
    nbytes = (b * (d + p) + 2 * b * f * d) * esize
    return max(nbytes / HBM_BYTES_PER_S, 2 * b * f * f * d / F32_FLOPS) * 1e3


def shape_case(lib, b: int, f: int, d: int, dtype) -> dict:
    gen = torch.Generator(DEV).manual_seed(b + d)
    t = torch.randn((b, f, d), generator=gen, device=DEV).to(dtype)
    x, feats = t[:, 0].contiguous(), t[:, 1:].contiguous()
    cot = torch.randn((b, F.output_width(f, d, 1)), generator=gen,
                      device=DEV).to(dtype)
    ref = torch.cat([y.reshape(b, -1, d) for y in
                     F.fused_interaction_bwd_reference(cot, x, feats)], 1)
    rtol = 1e-5 if dtype == torch.float32 else 1e-2
    outs = {}
    for name in ("first", "port"):
        dx, dfeats = torch.empty_like(x), torch.empty_like(feats)
        outs[name] = (first(lib, cot, x, feats, dx, dfeats) if name == "first"
                      else lambda dx=dx, dfeats=dfeats: F.interaction_bwd(
                          cot, x, feats, out=(dx, dfeats)))
        outs[name]()
        torch.cuda.synchronize()
        got = torch.cat([dx[:, None], dfeats], 1)
        torch.testing.assert_close(got.float(), ref.float(), atol=1e-4,
                                   rtol=rtol)
        outs[name + "_err"] = (got.float() - ref.float()).abs().max().item()
    times = {"first": [], "port": []}
    for name in ("first", "port", "port", "first"):
        times[name] += tms(outs[name])
    dt = torch.empty_like(t)
    copy = statistics.median(tms(lambda: dt.copy_(t)))
    dx, dfeats = torch.empty_like(x), torch.empty_like(feats)
    caps = {n: statistics.median(tms(capped(cot, x, feats, dx, dfeats, n)))
            for n in (1, 2)}
    bound = bound_ms(b, f, d, t.element_size())
    copy_bound = 2 * t.numel() * t.element_size() / HBM_BYTES_PER_S * 1e3
    return {"first_ms": statistics.median(times["first"]),
            "port_ms": statistics.median(times["port"]),
            "first_err": outs["first_err"], "port_err": outs["port_err"],
            "bound_ms": bound, "copy_ms": copy, "copy_bound_ms": copy_bound,
            "cap1_ms": caps[1], "cap2_ms": caps[2],
            "geometry": F._bwd_launch_geometry(b, f, d, t.element_size())}


def main() -> int:
    if not torch.cuda.is_available():
        print("interaction_bwd_probe: needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    lib, regs = build()
    for name, lines in regs.items():
        print(f"ptxas {name}: {lines}")
    res = {"ptxas": regs}
    print("(B, F, D) dtype: first design ms, port ms (share of the bound), "
          "bound ms; the T copy ms (share of its bound); port capped at 1 "
          "and 2 blocks an SM ms; max |err| first, port")
    for b, f, d in SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            r = shape_case(lib, b, f, d, dtype)
            name = "f32" if dtype == torch.float32 else "bf16"
            res[f"{b}x{f}x{d}_{name}"] = r
            print(f"  ({b}, {f}, {d}) {name}: {r['first_ms']:.4f} "
                  f"({r['bound_ms'] / r['first_ms']:.0%}), "
                  f"{r['port_ms']:.4f} ({r['bound_ms'] / r['port_ms']:.0%}), "
                  f"{r['bound_ms']:.4f}; copy {r['copy_ms']:.4f} "
                  f"({r['copy_bound_ms'] / r['copy_ms']:.0%}); capped "
                  f"{r['cap1_ms']:.4f}, {r['cap2_ms']:.4f}; "
                  f"{r['first_err']:.3g}, {r['port_err']:.3g}; geometry "
                  f"{r['geometry']}", flush=True)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
