"""Fused dot interaction, forward and backward: the counterpart of
``dlrm_tpu/ops/interaction_pallas.py``.

``fused_interaction_t`` is a ``torch.autograd.Function`` over two
hand-written CUDA kernels: ``interaction_fwd`` (``csrc/interaction_fwd.cu``)
and ``interaction_bwd`` (``csrc/interaction_bwd.cu``).  Each wrapper
launches its kernel for a CUDA tensor and takes its plain torch version
(``fused_interaction_t_reference``, ``fused_interaction_t_bwd_reference``)
for a CPU tensor; there is no fallback from one to the other.

Forward output: ``[T[:,0,:] | strictly-lower Z = T Tᵀ in (1,0),(2,0),(2,1),...
order | zeros up to a multiple of pad_to]``, accumulated in f32, in T's
dtype.  Backward: ``dT = (dZ + dZᵀ) T`` in f32 with dZ rebuilt from the
cotangent's pair columns, plus the cotangent's first D columns on row 0;
its padding columns are ignored.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from dlrm_tpu_torch.ops.interaction import (_pad_width, stack_features,
                                            tril_flat_indices)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_TARGET = 32 * 1024          # bytes of staging a forward block aims for
_BWD_SMEM_TARGET = 48 * 1024      # the same for a backward block
_SMEM_MAX = 227 * 1024            # what one Hopper block may use
_THREADS = 256                    # threads per block (kThreads in the .cu)


def output_width(f: int, d: int, pad_to: int) -> int:
    p = f * (f - 1) // 2
    return pad_to * ((d + p + pad_to - 1) // pad_to)


def _round_up4(x: int) -> int:
    return -(-x // 4) * 4


def fused_interaction_t_reference(t: torch.Tensor, pad_to: int = 1
                                  ) -> torch.Tensor:
    """Plain torch version of the forward kernel: f32 ``bmm``, triangular
    index, concat and pad, then a cast to T's dtype."""
    b, f, _ = t.shape
    tf = t.float()
    z = torch.bmm(tf, tf.transpose(1, 2))
    zflat = z.reshape(b, f * f)[:, tril_flat_indices(f).to(t.device)]
    out = _pad_width(torch.cat([tf[:, 0, :], zflat], dim=1), pad_to)
    return out.to(t.dtype)


def fused_interaction_t_bwd_reference(g: torch.Tensor, t: torch.Tensor
                                      ) -> torch.Tensor:
    """Plain torch version of the backward kernel: the pair columns of the
    cotangent ``g`` (B, W) ``index_put`` into a strictly-lower (B, F, F) dZ,
    symmetrised, an f32 ``bmm`` with T, ``g[:, :D]`` added to row 0, then a
    cast to T's dtype.  Columns of g past D + P are ignored."""
    b, f, d = t.shape
    p = f * (f - 1) // 2
    gf = g.float()
    dz = torch.zeros((b, f * f), dtype=torch.float32, device=t.device)
    dz[:, tril_flat_indices(f).to(t.device)] = gf[:, d:d + p]
    dz = dz.reshape(b, f, f)
    dt = torch.bmm(dz + dz.transpose(1, 2), t.float())
    dt[:, 0, :] += gf[:, :d]
    return dt.to(t.dtype)


def _launch_geometry(b: int, f: int, d: int, esize: int):
    """(samples per block, lanes per 4x4 tile, 16-byte row loads?) for the
    forward kernel; mirrors its shared-memory layout (rows padded to a
    multiple of 4, columns to a multiple of 4 plus 4 floats of stride
    padding)."""
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


def _bwd_launch_geometry(b: int, f: int, d: int, esize: int):
    """(samples per block, 16-byte row loads?, vector stores?) for the
    backward kernel; mirrors its shared-memory layout (T rows at a stride
    of round_up(D, 4) floats, then S as F rows of round_up(F, 4) floats).

    Of the sample counts whose staging fits ``_BWD_SMEM_TARGET``, it takes
    the one whose 4x4 tiles fill the block's passes best (the larger on a
    tie)."""
    per_sample = (f * _round_up4(d) + f * _round_up4(f)) * 4
    if per_sample > _SMEM_MAX:
        raise ValueError(f"T of shape (*, {f}, {d}) needs {per_sample} B of "
                         f"shared memory per sample in the backward kernel; "
                         f"a block takes at most {_SMEM_MAX}")
    tiles = _round_up4(f) // 4 * (_round_up4(d) // 4)
    most = max(1, min(b, _BWD_SMEM_TARGET // per_sample))

    def fill(s):
        items = s * tiles
        return items / (-(-items // _THREADS) * _THREADS), s

    samples = max(range(1, most + 1), key=fill)
    return samples, (d * esize) % 16 == 0, d % 4 == 0


@functools.lru_cache(maxsize=None)
def _kernel(stem: str, argtypes: tuple):
    """The C entry point ``stem`` of ``csrc/<stem>.cu`` (built at first
    use)."""
    from dlrm_tpu_torch.ops.cuda_build import load_kernels
    fn = getattr(load_kernels()[stem], stem)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_FWD_ARGS = (_P, _P, _I, _L, _I, _I, _I, _I, _I, _I, _P)
_BWD_ARGS = (_P, _P, _P, _I, _L, _I, _I, _I, _I, _I, _I, _P)


def _check_t(t: torch.Tensor, name: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} takes a CPU or CUDA tensor, not {t.device}")
    if t.dim() != 3:
        raise ValueError(f"T must be (B, F, D), got shape {tuple(t.shape)}")
    if t.dtype not in _DTYPE_CODES:
        raise TypeError(f"T must be float32 or bfloat16, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError("T must be contiguous")
    if t.shape[1] < 1 or t.shape[2] < 1:
        raise ValueError(f"T must have F >= 1 and D >= 1, got {tuple(t.shape)}")


def interaction_fwd(t: torch.Tensor, pad_to: int = 1) -> torch.Tensor:
    """Forward on T (B, F, D) -> (B, W), W = round_up(D + F(F-1)/2, pad_to).

    CPU tensor: the plain version.  CUDA tensor: the kernel, or an error.
    ``interaction_fwd.launches`` counts kernel launches.
    """
    if t.device.type == "cpu":
        return fused_interaction_t_reference(t, pad_to)
    _check_t(t, "interaction_fwd")
    if pad_to < 1:
        raise ValueError(f"pad_to must be >= 1, got {pad_to}")
    b, f, d = t.shape
    width = output_width(f, d, pad_to)
    out = torch.empty((b, width), dtype=t.dtype, device=t.device)
    if b == 0:
        return out
    samples, kparts, vec = _launch_geometry(b, f, d, t.element_size())
    vec = vec and t.data_ptr() % 16 == 0
    with torch.cuda.device(t.device):
        stream = torch.cuda.current_stream(t.device).cuda_stream
        rc = _kernel("interaction_fwd", _FWD_ARGS)(
            t.data_ptr(), out.data_ptr(), _DTYPE_CODES[t.dtype], b, f, d,
            width, samples, kparts, int(vec), stream)
    if rc != 0:
        raise RuntimeError(f"interaction_fwd kernel launch failed: CUDA error "
                           f"{rc} for T {tuple(t.shape)} {t.dtype}")
    interaction_fwd.launches += 1
    return out


interaction_fwd.launches = 0


def interaction_bwd(g: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Backward: the cotangent g (B, W) of the forward's output and T
    (B, F, D) -> dT (B, F, D) in T's dtype.

    CPU tensors: the plain version.  CUDA tensors: the kernel, or an error.
    g is cast to T's dtype (autograd hands it over in that dtype already)
    and made contiguous.  ``interaction_bwd.launches`` counts kernel
    launches.
    """
    if t.device.type == "cpu":
        return fused_interaction_t_bwd_reference(g, t)
    _check_t(t, "interaction_bwd")
    b, f, d = t.shape
    p = f * (f - 1) // 2
    if g.device != t.device or g.dim() != 2 or g.shape[0] != b \
            or g.shape[1] < d + p:
        raise ValueError(f"g must be (B, >= D + P) = ({b}, >= {d + p}) on "
                         f"{t.device}, got {tuple(g.shape)} on {g.device}")
    g = g.to(t.dtype).contiguous()
    dt = torch.empty_like(t)
    if b == 0:
        return dt
    samples, vec_loads, vec_stores = _bwd_launch_geometry(
        b, f, d, t.element_size())
    vec_loads = vec_loads and t.data_ptr() % 16 == 0
    vec_stores = vec_stores and dt.data_ptr() % 16 == 0
    with torch.cuda.device(t.device):
        stream = torch.cuda.current_stream(t.device).cuda_stream
        rc = _kernel("interaction_bwd", _BWD_ARGS)(
            g.data_ptr(), t.data_ptr(), dt.data_ptr(), _DTYPE_CODES[t.dtype],
            b, f, d, g.shape[1], samples, int(vec_loads), int(vec_stores),
            stream)
    if rc != 0:
        raise RuntimeError(f"interaction_bwd kernel launch failed: CUDA error "
                           f"{rc} for T {tuple(t.shape)} {t.dtype}")
    interaction_bwd.launches += 1
    return dt


interaction_bwd.launches = 0


class _FusedInteraction(torch.autograd.Function):
    """The custom VJP of the JAX package's ``fused_interaction_t``: the
    forward kernel, T saved, the backward kernel."""

    @staticmethod
    def forward(ctx, t, pad_to):
        ctx.save_for_backward(t)
        return interaction_fwd(t, pad_to)

    @staticmethod
    def backward(ctx, g):
        (t,) = ctx.saved_tensors
        return interaction_bwd(g, t), None


def fused_interaction_t(t: torch.Tensor, pad_to: int = 1) -> torch.Tensor:
    """Fused interaction on the stacked features T (B, F, D) -> (B, W),
    differentiable in T through the two kernels (CUDA) or their plain
    versions (CPU)."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_interaction_t takes a CPU or CUDA tensor, "
                         f"not {t.device}")
    return _FusedInteraction.apply(t, pad_to)


def fused_dot_interaction(x: torch.Tensor, feats: torch.Tensor,
                          pad_to: int = 1) -> torch.Tensor:
    """Drop-in fused replacement for ``ops.interaction.dot_interaction``."""
    return fused_interaction_t(stack_features(x, feats), pad_to)
