"""Fused dot interaction: the counterpart of
``dlrm_tpu/ops/interaction_pallas.py``.

``fused_interaction_t`` launches the hand-written CUDA kernel
``csrc/interaction_fwd.cu`` for a CUDA tensor and takes the plain torch
version ``fused_interaction_t_reference`` for a CPU tensor.  Output:
``[T[:,0,:] | strictly-lower Z = T Tᵀ in (1,0),(2,0),(2,1),... order |
zeros up to a multiple of pad_to]``, accumulated in f32, in T's dtype.

Forward only: the backward kernel comes with the training slice, so the
CUDA path refuses a tensor that would need a gradient.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from dlrm_tpu_torch.ops.interaction import (_pad_width, stack_features,
                                            tril_flat_indices)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_TARGET = 32 * 1024          # bytes of staging a block aims for
_SMEM_MAX = 227 * 1024            # what one Hopper block may use
_THREADS = 256                    # threads per block (kThreads in the .cu)


def output_width(f: int, d: int, pad_to: int) -> int:
    p = f * (f - 1) // 2
    return pad_to * ((d + p + pad_to - 1) // pad_to)


def fused_interaction_t_reference(t: torch.Tensor, pad_to: int = 1
                                  ) -> torch.Tensor:
    """Plain torch version of the kernel: f32 ``bmm``, triangular index,
    concat and pad, then a cast to T's dtype."""
    b, f, _ = t.shape
    tf = t.float()
    z = torch.bmm(tf, tf.transpose(1, 2))
    zflat = z.reshape(b, f * f)[:, tril_flat_indices(f).to(t.device)]
    out = _pad_width(torch.cat([tf[:, 0, :], zflat], dim=1), pad_to)
    return out.to(t.dtype)


def _launch_geometry(b: int, f: int, d: int, esize: int):
    """(samples per block, lanes per 4x4 tile, 16-byte row loads?) for the
    kernel; mirrors its shared-memory layout (rows padded to a multiple of
    4, columns to a multiple of 4 plus 4 floats of stride padding)."""
    rows4, cols4 = -(-f // 4), -(-d // 4)
    per_sample = (4 * rows4 * (4 * cols4 + 4) + f * (f - 1) // 2) * 4
    if per_sample > _SMEM_MAX:
        raise ValueError(f"T of shape (*, {f}, {d}) needs {per_sample} B of "
                         f"shared memory per sample; the kernel takes at most "
                         f"{_SMEM_MAX}")
    kparts = 1  # split D into about 8 groups of 4 columns per lane
    while kparts < 32 and kparts * 2 <= cols4 // 8:
        kparts *= 2
    lanes = rows4 * (rows4 + 1) // 2 * kparts  # one sample's tiles
    samples = max(1, min(b, _SMEM_TARGET // per_sample,
                         _THREADS // lanes))
    return samples, kparts, (d * esize) % 16 == 0


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry point of ``csrc/interaction_fwd.cu`` (built at first
    use)."""
    from dlrm_tpu_torch.ops.cuda_build import load_kernels
    fn = load_kernels()["interaction_fwd"].interaction_fwd
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fused_interaction_t(t: torch.Tensor, pad_to: int = 1) -> torch.Tensor:
    """Fused interaction on the stacked features T (B, F, D) -> (B, W),
    W = round_up(D + F(F-1)/2, pad_to).

    CPU tensor: the plain version.  CUDA tensor: the kernel, or an error;
    there is no fallback.  ``fused_interaction_t.launches`` counts kernel
    launches.
    """
    if t.device.type == "cpu":
        return fused_interaction_t_reference(t, pad_to)
    if t.device.type != "cuda":
        raise ValueError(f"fused_interaction_t takes a CPU or CUDA tensor, "
                         f"not {t.device}")
    if t.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError(
            "the fused interaction has no backward kernel yet; it comes with "
            "the training slice (ROADMAP.md queue 2: _bwd_kernel). Run the "
            "forward under torch.inference_mode() or torch.no_grad(), or use "
            "interaction_impl='gram' to train")
    if t.dim() != 3:
        raise ValueError(f"T must be (B, F, D), got shape {tuple(t.shape)}")
    if t.dtype not in _DTYPE_CODES:
        raise TypeError(f"T must be float32 or bfloat16, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError("T must be contiguous")
    if pad_to < 1:
        raise ValueError(f"pad_to must be >= 1, got {pad_to}")
    b, f, d = t.shape
    if f < 1 or d < 1:
        raise ValueError(f"T must have F >= 1 and D >= 1, got {tuple(t.shape)}")
    width = output_width(f, d, pad_to)
    out = torch.empty((b, width), dtype=t.dtype, device=t.device)
    if b == 0:
        return out
    samples, kparts, vec = _launch_geometry(b, f, d, t.element_size())
    vec = vec and t.data_ptr() % 16 == 0
    with torch.cuda.device(t.device):
        stream = torch.cuda.current_stream(t.device).cuda_stream
        rc = _kernel()(t.data_ptr(), out.data_ptr(), _DTYPE_CODES[t.dtype],
                       b, f, d, width, samples, kparts, int(vec), stream)
    if rc != 0:
        raise RuntimeError(f"interaction_fwd kernel launch failed: CUDA error "
                           f"{rc} for T {tuple(t.shape)} {t.dtype}")
    fused_interaction_t.launches += 1
    return out


fused_interaction_t.launches = 0


def fused_dot_interaction(x: torch.Tensor, feats: torch.Tensor,
                          pad_to: int = 1) -> torch.Tensor:
    """Drop-in fused replacement for ``ops.interaction.dot_interaction``."""
    return fused_interaction_t(stack_features(x, feats), pad_to)
