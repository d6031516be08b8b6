"""Fused dot interaction, forward and backward: the counterpart of
``dlrm_tpu/ops/interaction_pallas.py``.

Two hand-written CUDA kernels, ``interaction_fwd`` (``csrc/interaction_fwd.cu``)
and ``interaction_bwd`` (``csrc/interaction_bwd.cu``), take the interaction
input T (B, F, D) as two sources: the dense row ``x`` (B, D) and the feature
rows ``feats`` (B, F-1, D) (or (B, tables, fs) re-chunked into D-wide rows),
each with its own sample stride.  ``fused_dot_interaction(x, feats)`` hands
over the two tensors as they lie, so no stacked T is ever written;
``fused_interaction_t(t)`` hands over the views ``t[:, 0]`` and ``t[:, 1:]``.
Each wrapper launches its kernel for CUDA tensors and takes its plain torch
version (``fused_interaction_reference``, ``fused_interaction_bwd_reference``
and their stacked forms ``fused_interaction_t_reference``,
``fused_interaction_t_bwd_reference``) for CPU tensors; there is no fallback
from one to the other.

Forward output: ``[T[:,0,:] | strictly-lower Z = T Tᵀ in (1,0),(2,0),(2,1),...
order | zeros up to a multiple of pad_to]``, accumulated in f32, in T's
dtype.  Backward: ``dT = (dZ + dZᵀ) T`` in f32 with dZ rebuilt from the
cotangent's pair columns, plus the cotangent's first D columns on row 0;
its padding columns are ignored.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from dlrm_tpu_torch.ops.interaction import (_pad_width, stack_features,
                                            tril_flat_indices)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_FWD_SMEM_TARGET = 75 * 1024      # a forward block's shared memory: three an SM
_BWD_SMEM_TARGET = 75 * 1024      # a backward block's shared memory
_SMEM_MAX = 227 * 1024            # what one Hopper block may use
_THREADS = 256                    # threads per block at most
_TILE = 7                         # forward: 7x7 tiles of Z (kTile)
_BARRIER_BYTES = 64               # room for the stages' mbarriers
_MAX_GROUP = 32                   # samples a stage holds at most
_BWD_ROWS = 9                     # backward: rows of dT a lane holds (kRows)
_BWD_S_ROW = 12                   # backward: floats of S a row block (kSRow)


def output_width(f: int, d: int, pad_to: int) -> int:
    p = f * (f - 1) // 2
    return pad_to * ((d + p + pad_to - 1) // pad_to)


def _round_up4(x: int) -> int:
    return -(-x // 4) * 4


def fused_interaction_t_reference(t: torch.Tensor, pad_to: int = 1
                                  ) -> torch.Tensor:
    """Plain torch version of the forward kernel on the stacked T: f32
    ``bmm``, triangular index, concat and pad, then a cast to T's dtype."""
    b, f, _ = t.shape
    tf = t.float()
    z = torch.bmm(tf, tf.transpose(1, 2))
    zflat = z.reshape(b, f * f)[:, tril_flat_indices(f).to(t.device)]
    out = _pad_width(torch.cat([tf[:, 0, :], zflat], dim=1), pad_to)
    return out.to(t.dtype)


def fused_interaction_reference(x: torch.Tensor, feats: torch.Tensor,
                                pad_to: int = 1) -> torch.Tensor:
    """Plain torch version of the forward kernel on its two sources."""
    return fused_interaction_t_reference(stack_features(x, feats), pad_to)


def fused_interaction_t_bwd_reference(g: torch.Tensor, t: torch.Tensor
                                      ) -> torch.Tensor:
    """Plain torch version of the backward kernel on the stacked T: the
    pair columns of the cotangent ``g`` (B, W) ``index_put`` into a
    strictly-lower (B, F, F) dZ, symmetrised, an f32 ``bmm`` with T,
    ``g[:, :D]`` added to row 0, then a cast to T's dtype.  Columns of g
    past D + P are ignored."""
    b, f, d = t.shape
    p = f * (f - 1) // 2
    gf = g.float()
    dz = torch.zeros((b, f * f), dtype=torch.float32, device=t.device)
    dz[:, tril_flat_indices(f).to(t.device)] = gf[:, d:d + p]
    dz = dz.reshape(b, f, f)
    dt = torch.bmm(dz + dz.transpose(1, 2), t.float())
    dt[:, 0, :] += gf[:, :d]
    return dt.to(t.dtype)


def fused_interaction_bwd_reference(g: torch.Tensor, x: torch.Tensor,
                                    feats: torch.Tensor
                                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of the backward kernel on its two sources:
    (dx, dfeats) in the shapes of x and feats."""
    dt = fused_interaction_t_bwd_reference(g, stack_features(x, feats))
    return dt[:, 0], dt[:, 1:].reshape(feats.shape)


@functools.lru_cache(maxsize=None)
def _launch_geometry(b: int, f: int, d: int, esize: int):
    """(lanes an item, samples a group, stages, row pitch in elements,
    threads) of the forward kernel; mirrors its shared-memory layout: 64
    bytes of mbarriers; ``stages`` stages of ``group`` samples of F rows
    each, plus the rows a last 7x7 tile reads past row F, at a pitch of D
    rounded up to 16 bytes; two f32 areas of ``group`` x P pairs.

    A sample is nb(nb-1)/2 off-diagonal tiles and ceil(nb/2) pairs of
    diagonal ones (nb = ceil(F / 7)), 8 lanes an item (4 where a row is at
    most 4 chunks of 4 elements), whole warps, at most 256 threads.  Two
    stages where two fit, so that one group's copies overlap the previous
    group's work.  Of the group sizes whose block fits
    ``_FWD_SMEM_TARGET`` (three blocks an SM: more, smaller blocks overlap
    one another's barriers), the one whose items fill the block's passes
    best (the larger on a tie).  The persistent grid is sized by the
    wrapper (``_resident_blocks``)."""
    pitch = -(-d * esize // 16) * 16 // esize
    lanes = 4 if pitch // 4 <= 4 else 8
    nb = -(-f // _TILE)
    p = f * (f - 1) // 2
    n_items = nb * (nb - 1) // 2 + (nb + 1) // 2

    def smem(group, stages):
        return (_BARRIER_BYTES
                + stages * (group * f + nb * _TILE - f) * pitch * esize
                + 2 * group * p * 4)

    stages = 2 if smem(1, 2) <= _SMEM_MAX else 1
    if smem(1, stages) > _SMEM_MAX:
        raise ValueError(f"T of shape (*, {f}, {d}) needs {smem(1, 1)} B of "
                         f"shared memory per sample; the kernel takes at most "
                         f"{_SMEM_MAX}")
    budget = max(_FWD_SMEM_TARGET, smem(1, stages))
    most = 1
    while most < min(b, _MAX_GROUP) and smem(most + 1, stages) <= budget:
        most += 1
    per_warp = 32 // lanes

    def slots(group):  # items a pass: whole warps, at most 256 threads
        return min(_THREADS // lanes,
                   -(-group * n_items // per_warp) * per_warp)

    def fill(group):
        items = group * n_items
        return items / (-(-items // slots(group)) * slots(group)), group

    group = max(range(1, most + 1), key=fill)
    return lanes, group, stages, pitch, slots(group) * lanes


@functools.lru_cache(maxsize=None)
def _resident_blocks(stem: str, device: int, *geometry: int) -> int:
    """Blocks of one geometry (the arguments of ``<stem>_blocks_per_sm``
    before its result pointer) that ``device`` holds at once: its SM count
    times the blocks an SM holds, as the CUDA runtime counts them
    (registers and shared memory)."""
    per_sm = ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = _kernel(stem, _OCC_ARGS, f"{stem}_blocks_per_sm")(
            *geometry, ctypes.byref(per_sm))
    if rc != 0 or per_sm.value < 1:
        raise RuntimeError(f"{stem}: no block of {geometry} fits an SM "
                           f"(CUDA error {rc})")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return per_sm.value * sms


def _bwd_smem(f: int, d: int, pitch: int, group: int, stages: int,
              esize: int) -> int:
    """Bytes of shared memory a backward block takes; mirrors the kernel's
    ``Layout``: 64 bytes of mbarriers; ``stages`` stages of ``group``
    samples, each its F rows of T at ``pitch`` elements and a g slot of D+P
    elements rounded up to 16 bytes plus 16; S in f32, F rows of
    ceil(F / 9) row blocks of 12 floats a sample; the pair table (4 bytes a
    pair, rounded up to 16); 32 samples' g offsets."""
    nrb = -(-f // _BWD_ROWS)
    pairs = f * (f - 1) // 2
    slot = -(-(d + pairs) * esize // 16) * 16 + 16
    stage = group * (f * pitch * esize + slot)
    return (_BARRIER_BYTES + stages * stage + group * f * nrb * _BWD_S_ROW * 4
            + -(-pairs * 4 // 16) * 16 + _MAX_GROUP * 4)


@functools.lru_cache(maxsize=None)
def _bwd_launch_geometry(b: int, f: int, d: int, esize: int):
    """(samples a group, stages, row pitch in elements, threads) of the
    backward kernel.

    A sample is ceil(F / 9) x ceil(D / 4) items (a 9x4 tile of dT each),
    one thread an item, whole warps, at most 256 threads.  Two stages
    where two fit, so that one group's copies overlap the previous
    group's work.  Of the group sizes whose block fits
    ``_BWD_SMEM_TARGET`` (shared memory for three blocks an SM at D=128,
    four at D=32 in f32), the one whose items fill the block's passes best
    (the larger on a tie).  The persistent grid is sized by the wrapper
    (``_resident_blocks``)."""
    pitch = -(-d * esize // 16) * 16 // esize
    n_items = -(-f // _BWD_ROWS) * -(-d // 4)
    if f * -(-f // _BWD_ROWS) * _BWD_S_ROW >= 1 << 16:
        raise ValueError(f"F = {f} is too many features for the backward "
                         f"kernel's pair table")

    def smem(group, stages):
        return _bwd_smem(f, d, pitch, group, stages, esize)

    stages = 2 if smem(1, 2) <= _SMEM_MAX else 1
    if smem(1, stages) > _SMEM_MAX:
        raise ValueError(f"T of shape (*, {f}, {d}) needs {smem(1, 1)} B of "
                         f"shared memory per sample in the backward kernel; "
                         f"a block takes at most {_SMEM_MAX}")
    budget = max(_BWD_SMEM_TARGET, smem(1, stages))
    most = 1
    while most < min(b, _MAX_GROUP) and smem(most + 1, stages) <= budget:
        most += 1

    def slots(group):  # items a pass: whole warps, at most 256 threads
        return min(_THREADS, -(-group * n_items // 32) * 32)

    def fill(group):
        items = group * n_items
        return items / (-(-items // slots(group)) * slots(group)), group

    group = max(range(1, most + 1), key=fill)
    return group, stages, pitch, slots(group)


def _kernel(stem: str, argtypes: tuple, name: Optional[str] = None):
    from dlrm_tpu_torch.ops.cuda_build import kernel
    return kernel(stem, argtypes, name)


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_FWD_ARGS = (_P, _L, _P, _L, _P, _I, _L, _I, _I, _I, _I, _I, _I, _I, _I, _I,
             _I, _P)
_OCC_ARGS = (_I, _I, _I, _I, _I, _I, _I, ctypes.POINTER(ctypes.c_int))
_BWD_ARGS = (_P, _L, _P, _L, _P, _L, _P, _L, _P, _L, _I, _L, _I, _I, _I, _I,
             _I, _I, _I, _I, _I, _P)


def _check_sources(x: torch.Tensor, feats: torch.Tensor, name: str):
    """(B, F, D) of the two sources, or an error for what the kernels do
    not take: x (B, D) with unit column stride; feats (B, tables, fs) with
    the rows of a sample contiguous and tables * fs a multiple of D; both
    float32 or both bfloat16, on one CUDA device."""
    if x.dim() != 2 or feats.dim() != 3:
        raise ValueError(f"x must be (B, D) and feats (B, tables, fs), got "
                         f"{tuple(x.shape)} and {tuple(feats.shape)}")
    b, d = x.shape
    _, n, fs = feats.shape
    if feats.shape[0] != b:
        raise ValueError(f"x has {b} samples and feats {feats.shape[0]}")
    if d < 1 or (n * fs) % d:
        raise ValueError(f"feats of shape {tuple(feats.shape)} do not "
                         f"re-chunk into rows of D = {d}")
    if (d > 1 and x.stride(1) != 1) or (fs > 1 and feats.stride(2) != 1) \
            or (n > 1 and feats.stride(1) != fs):
        raise ValueError(f"the rows of a sample must be contiguous: x "
                         f"strides {x.stride()}, feats strides "
                         f"{feats.stride()}")
    if x.dtype not in _DTYPE_CODES or feats.dtype != x.dtype:
        raise TypeError(f"x and feats must be both float32 or both bfloat16, "
                        f"got {x.dtype} and {feats.dtype}")
    if x.device.type != "cuda" or feats.device != x.device:
        raise ValueError(f"{name} takes CPU or CUDA tensors on one device, "
                         f"not x on {x.device} and feats on {feats.device}")
    return b, 1 + n * fs // d, d


def _aligned(t: torch.Tensor, stride: int, nbytes: int) -> bool:
    """Whether every sample of ``t`` starts on an ``nbytes`` boundary."""
    esize = t.element_size()
    return t.data_ptr() % nbytes == 0 and (stride * esize) % nbytes == 0


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def interaction_fwd(x: torch.Tensor, feats: torch.Tensor, pad_to: int = 1
                    ) -> torch.Tensor:
    """Forward on the two sources x (B, D) and feats (B, tables, fs) ->
    (B, W), W = round_up(D + F(F-1)/2, pad_to), F = 1 + tables * fs / D.

    CPU tensors: the plain version.  CUDA tensors: the kernel, or an error;
    nothing is copied.  ``interaction_fwd.launches`` counts kernel launches,
    ``interaction_fwd.bulk_launches`` those that filled shared memory with
    bulk asynchronous copies (every row 16-byte aligned and a 16-byte
    multiple); the others stage with plain loads.
    """
    if x.device.type == "cpu" and feats.device.type == "cpu":
        return fused_interaction_reference(x, feats, pad_to)
    b, f, d = _check_sources(x, feats, "interaction_fwd")
    if pad_to < 1:
        raise ValueError(f"pad_to must be >= 1, got {pad_to}")
    width = output_width(f, d, pad_to)
    out = torch.empty((b, width), dtype=x.dtype, device=x.device)
    if b == 0:
        return out
    esize = x.element_size()
    lanes, group, stages, pitch, threads = _launch_geometry(b, f, d, esize)
    dev = x.device.index if x.device.index is not None \
        else torch.cuda.current_device()
    blocks = min(-(-b // group), _resident_blocks(
        "interaction_fwd", dev, _DTYPE_CODES[x.dtype], f, pitch, lanes,
        group, stages, threads))
    sx, sf = x.stride(0), feats.stride(0)
    bulk = ((d * esize) % 16 == 0 and _aligned(x, sx, 16)
            and _aligned(feats, sf, 16))
    with torch.cuda.device(x.device):
        rc = _kernel("interaction_fwd", _FWD_ARGS)(
            x.data_ptr(), sx, feats.data_ptr(), sf, out.data_ptr(),
            _DTYPE_CODES[x.dtype], b, f, d, width, pitch, lanes, group,
            stages, threads, blocks, int(bulk), _stream(x))
    if rc != 0:
        raise RuntimeError(f"interaction_fwd kernel launch failed: CUDA error "
                           f"{rc} for x {tuple(x.shape)}, feats "
                           f"{tuple(feats.shape)} {x.dtype}")
    interaction_fwd.launches += 1
    interaction_fwd.bulk_launches += int(bulk)
    return out


interaction_fwd.launches = 0
interaction_fwd.bulk_launches = 0


def interaction_bwd(g: torch.Tensor, x: torch.Tensor, feats: torch.Tensor,
                    out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backward: the cotangent g (B, W) of the forward's output and its two
    sources -> (dx, dfeats) in their shapes and dtype, written into ``out``
    when given (any sample strides, rows of a sample contiguous: the
    stacked form passes ``dt[:, 0]`` and ``dt[:, 1:]``), else into new
    contiguous tensors.

    CPU tensors: the plain version.  CUDA tensors: the kernel, or an error.
    g is cast to x's dtype (autograd hands it over in that dtype already)
    and made contiguous; it may start anywhere in its storage.
    ``interaction_bwd.launches`` counts kernel launches,
    ``interaction_bwd.bulk_launches`` those that filled shared memory with
    bulk asynchronous copies (every row of x and feats 16-byte aligned and
    a 16-byte multiple); the others stage with plain loads.
    """
    if x.device.type == "cpu" and feats.device.type == "cpu":
        dx, dfeats = fused_interaction_bwd_reference(g, x, feats)
        if out is None:
            return dx, dfeats
        out[0].copy_(dx)
        out[1].copy_(dfeats)
        return out
    if out is not None and (out[0].shape != x.shape
                            or out[1].shape != feats.shape
                            or out[0].dtype != x.dtype):
        raise ValueError(f"out must have the shapes and dtype of x and "
                         f"feats, got {tuple(out[0].shape)} and "
                         f"{tuple(out[1].shape)} {out[0].dtype}")
    b, f, d = _check_sources(x, feats, "interaction_bwd")
    p = f * (f - 1) // 2
    if g.device != x.device or g.dim() != 2 or g.shape[0] != b \
            or g.shape[1] < d + p:
        raise ValueError(f"g must be (B, >= D + P) = ({b}, >= {d + p}) on "
                         f"{x.device}, got {tuple(g.shape)} on {g.device}")
    if out is None:
        out = (torch.empty(x.shape, dtype=x.dtype, device=x.device),
               torch.empty(feats.shape, dtype=x.dtype, device=x.device))
    dx, dfeats = out
    _check_sources(dx, dfeats, "interaction_bwd")
    g = g.to(x.dtype).contiguous()
    if b == 0:
        return dx, dfeats
    esize = x.element_size()
    group, stages, pitch, threads = _bwd_launch_geometry(b, f, d, esize)
    dev = x.device.index if x.device.index is not None \
        else torch.cuda.current_device()
    blocks = min(-(-b // group), _resident_blocks(
        "interaction_bwd", dev, _DTYPE_CODES[x.dtype], f, d, pitch, group,
        stages, threads))
    sx, sf, sdx, sdf = (x.stride(0), feats.stride(0), dx.stride(0),
                        dfeats.stride(0))
    bulk = ((d * esize) % 16 == 0 and _aligned(x, sx, 16)
            and _aligned(feats, sf, 16))
    vec_stores = (d % 4 == 0 and _aligned(dx, sdx, 4 * esize)
                  and _aligned(dfeats, sdf, 4 * esize))
    with torch.cuda.device(x.device):
        rc = _kernel("interaction_bwd", _BWD_ARGS)(
            g.data_ptr(), g.shape[1], x.data_ptr(), sx, feats.data_ptr(), sf,
            dx.data_ptr(), sdx, dfeats.data_ptr(), sdf, _DTYPE_CODES[x.dtype],
            b, f, d, pitch, group, stages, threads, blocks, int(bulk),
            int(vec_stores), _stream(x))
    if rc != 0:
        raise RuntimeError(f"interaction_bwd kernel launch failed: CUDA error "
                           f"{rc} for x {tuple(x.shape)}, feats "
                           f"{tuple(feats.shape)} {x.dtype}")
    interaction_bwd.launches += 1
    interaction_bwd.bulk_launches += int(bulk)
    return dx, dfeats


interaction_bwd.launches = 0
interaction_bwd.bulk_launches = 0


class _FusedInteraction(torch.autograd.Function):
    """The custom VJP of the JAX package's ``fused_dot_interaction``: the
    forward kernel on (x, feats), both saved, the backward kernel."""

    @staticmethod
    def forward(ctx, x, feats, pad_to):
        ctx.save_for_backward(x, feats)
        return interaction_fwd(x, feats, pad_to)

    @staticmethod
    def backward(ctx, g):
        x, feats = ctx.saved_tensors
        dx, dfeats = interaction_bwd(g, x, feats)
        return dx, dfeats, None


class _FusedInteractionT(torch.autograd.Function):
    """The custom VJP of the JAX package's ``fused_interaction_t``: the
    same kernels on the views T[:, 0] and T[:, 1:], dT written through the
    same two views."""

    @staticmethod
    def forward(ctx, t, pad_to):
        ctx.save_for_backward(t)
        return interaction_fwd(t[:, 0], t[:, 1:], pad_to)

    @staticmethod
    def backward(ctx, g):
        (t,) = ctx.saved_tensors
        dt = torch.empty_like(t, memory_format=torch.contiguous_format)
        interaction_bwd(g, t[:, 0], t[:, 1:], out=(dt[:, 0], dt[:, 1:]))
        return dt, None


def _check_device(t: torch.Tensor, name: str) -> None:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} takes a CPU or CUDA tensor, not {t.device}")


def fused_interaction_t(t: torch.Tensor, pad_to: int = 1) -> torch.Tensor:
    """Fused interaction on the stacked features T (B, F, D) -> (B, W),
    differentiable in T through the two kernels (CUDA) or their plain
    versions (CPU)."""
    _check_device(t, "fused_interaction_t")
    if t.dim() != 3 or t.shape[1] < 1:
        raise ValueError(f"T must be (B, F, D) with F >= 1, got "
                         f"{tuple(t.shape)}")
    return _FusedInteractionT.apply(t, pad_to)


def fused_dot_interaction(x: torch.Tensor, feats: torch.Tensor,
                          pad_to: int = 1) -> torch.Tensor:
    """Drop-in fused replacement for ``ops.interaction.dot_interaction``:
    the bottom output x (B, D) and the pooled features feats (B, tables,
    fs) go to the kernels as they lie, differentiable in both."""
    _check_device(x, "fused_dot_interaction")
    return _FusedInteraction.apply(x, feats, pad_to)
