"""int8 post-training quantization of the embedding tables, for serving: the
counterpart of ``dlrm_tpu/ops/quant.py`` without the lane packing.

Symmetric scales, one per logical row: ``scale = max|row| * (1/127)``, a
product with the pre-rounded f32 reciprocal (never a division by 127: the
JAX package's quantizers multiply, and a division gives other bits), then
``q = round(row / scale)`` (ties to even) clamped to [-127, 127].  An
all-zero row gets scale 1.  Codes and scales equal the JAX package's bit
for bit; the worst elementwise error is ``max|row| / 254``.

``QuantEmb`` holds one ``(total_rows, D)`` int8 tensor and one
``(total_rows,)`` f32 scale tensor.  The sharded tables quantize on the
host too (:func:`quantize_sharded_stack`, :func:`quantize_col_shards`), a
row at a time, so a logical row gets the same codes and scale wherever its
shard keeps it; ``parallel.embedding.sharded_lookup(scales=, cs_scales=)``
serves them.  ``ops.embedding.mixed_lookup`` and
``models.dlrm.forward`` dispatch on it, so ``evaluate`` and
``run.score_batch`` serve a quantized model with no other change.  Training
refuses it.
"""

from __future__ import annotations

import numpy as np
import torch

from dlrm_tpu_torch.ops import embedding as emb_ops

# pre-rounded f32 reciprocal of 127; both quantizers multiply by it
_INV127 = np.float32(1.0) / np.float32(127.0)
# rows a quantizer takes at a time: its f32 temporaries stay at this many
# rows (64 MB each at D = 128), never the full stack (17.3 GB at Kaggle
# fs=128)
CHUNK_ROWS = 1 << 17


class QuantEmb:
    """Quantized stand-in for the ``(total_rows, D)`` embedding stack:
    ``codes`` int8 ``(total_rows, D)`` and ``scales`` f32 ``(total_rows,)``,
    on one device."""

    __slots__ = ("codes", "scales")

    def __init__(self, codes: torch.Tensor, scales: torch.Tensor):
        self.codes = codes
        self.scales = scales

    @property
    def device(self) -> torch.device:
        return self.codes.device

    def to(self, device) -> "QuantEmb":
        return QuantEmb(self.codes.to(device), self.scales.to(device))

    def __repr__(self):
        return (f"QuantEmb({tuple(self.codes.shape)} int8 on {self.device}, "
                f"{table_bytes(self)} bytes)")


def _quant_rows(x: torch.Tensor):
    """(n, D) float -> (int8 codes, (n,) f32 scales)."""
    x = x.float()
    amax = x.abs().amax(dim=1)
    scale = torch.where(amax > 0, amax * float(_INV127),
                        torch.ones_like(amax))
    q = torch.round(x / scale[:, None]).clamp_(-127, 127)
    return q.to(torch.int8), scale


def _quant_rows_np(x: np.ndarray):
    """numpy twin of :func:`_quant_rows`: the same f32 arithmetic and the
    same round-half-to-even."""
    x = np.asarray(x, dtype=np.float32)
    amax = np.max(np.abs(x), axis=-1)
    scale = np.where(amax > 0, amax * _INV127,
                     np.float32(1.0)).astype(np.float32)
    q = np.clip(np.round(x / scale[..., None]), -127, 127)
    return q.astype(np.int8), scale


def quantize_rows_host(x):
    """Quantize every row (the last axis) of a host array: ``x`` numpy, or
    a CPU tensor, which gives tensors back -> (int8 codes of ``x``'s
    shape, f32 scales of ``x.shape[:-1]``), ``CHUNK_ROWS`` rows at a time.
    The arithmetic of :func:`_quant_rows` on the host's cores (torch's CPU
    kernels use every core; numpy one), the bits of
    :func:`_quant_rows_np`."""
    tensor = isinstance(x, torch.Tensor)
    shape = tuple(x.shape)
    flat = x.reshape(-1, shape[-1])
    codes = torch.empty(flat.shape, dtype=torch.int8)
    scales = torch.empty(flat.shape[0], dtype=torch.float32)
    for s in range(0, flat.shape[0], CHUNK_ROWS):
        part = flat[s:s + CHUNK_ROWS]
        part = part if tensor else torch.from_numpy(np.ascontiguousarray(
            part, dtype=np.float32))
        codes[s:s + CHUNK_ROWS], scales[s:s + CHUNK_ROWS] = _quant_rows(part)
    codes, scales = codes.view(shape), scales.view(shape[:-1])
    return (codes, scales) if tensor else (codes.numpy(), scales.numpy())


def quantize_sharded_stack(sharded):
    """Quantize per-shard table stacks on the host: ``(N, local_rows, D)``
    (or one rank's ``(local_rows, D)``) -> (int8 codes of the same shape,
    f32 scales ``(N, local_rows)``), one scale a logical row, so a row gets
    the codes it gets unsharded; padding and trash rows are zero and get
    scale 1.  The JAX package's function at ``pack=1`` without its scales'
    last axis.  Numpy or CPU tensors, chunk by chunk: no f32 temporary of
    the stack's size."""
    return quantize_rows_host(sharded)


def quantize_col_shards(cs_arrays) -> tuple:
    """Quantize column shards on the host: one ``(N, R_t, D/N)`` array (or
    one rank's ``(R_t, D/N)``) a table -> (the int8 codes, the ``(N,
    R_t)`` scales), one pair a table.  A scale covers one shard's lanes of
    a row, as in the JAX package: finer than the whole row's."""
    pairs = [quantize_rows_host(a) for a in cs_arrays]
    return tuple(q for q, _ in pairs), tuple(s for _, s in pairs)


def _check_stack(emb, config) -> None:
    want = (config.total_rows, config.feature_size)
    if tuple(emb.shape) != want:
        raise ValueError(f"embedding stack {tuple(emb.shape)}, the config "
                         f"needs {want}")


def quantize_emb(emb: torch.Tensor, config) -> QuantEmb:
    """Quantize the stack on its own device, ``CHUNK_ROWS`` rows at a
    time (no full-size f32 temporary is made)."""
    _check_stack(emb, config)
    codes = torch.empty(emb.shape, dtype=torch.int8, device=emb.device)
    scales = torch.empty(emb.shape[0], dtype=torch.float32,
                         device=emb.device)
    with torch.no_grad():
        for s in range(0, emb.shape[0], CHUNK_ROWS):
            codes[s:s + CHUNK_ROWS], scales[s:s + CHUNK_ROWS] = _quant_rows(
                emb[s:s + CHUNK_ROWS])
    return QuantEmb(codes, scales)


def quantize_emb_host(emb, config) -> QuantEmb:
    """Quantize a host stack (numpy, any float dtype) with numpy, chunk by
    chunk; bit-identical to :func:`quantize_emb`.  The serving load path:
    only the codes and scales need ever reach the device."""
    _check_stack(emb, config)
    codes = np.empty(emb.shape, dtype=np.int8)
    scales = np.empty(emb.shape[0], dtype=np.float32)
    for s in range(0, emb.shape[0], CHUNK_ROWS):
        codes[s:s + CHUNK_ROWS], scales[s:s + CHUNK_ROWS] = _quant_rows_np(
            emb[s:s + CHUNK_ROWS])
    out = QuantEmb(torch.from_numpy(codes), torch.from_numpy(scales))
    check_quant_storage(out, config)
    return out


def quantize_params(params: dict, config) -> dict:
    """``params`` with ``emb`` replaced by its int8 quantization."""
    return {"bottom": params["bottom"],
            "emb": quantize_emb(params["emb"], config),
            "top": params["top"]}


def check_quant_storage(qemb: QuantEmb, config) -> None:
    """Shapes and dtypes of a :class:`QuantEmb` against the config."""
    rows, d = config.total_rows, config.feature_size
    if tuple(qemb.codes.shape) != (rows, d) or qemb.codes.dtype != torch.int8:
        raise ValueError(f"quantized codes {tuple(qemb.codes.shape)} "
                         f"{qemb.codes.dtype}; the config needs ({rows}, "
                         f"{d}) int8")
    if tuple(qemb.scales.shape) != (rows,) or \
            qemb.scales.dtype != torch.float32:
        raise ValueError(f"scales {tuple(qemb.scales.shape)} "
                         f"{qemb.scales.dtype}; scales are per logical row: "
                         f"({rows},) float32")
    if qemb.scales.device != qemb.codes.device:
        raise ValueError(f"codes on {qemb.codes.device}, scales on "
                         f"{qemb.scales.device}")


def _dequant(codes: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    # one pass: the int8 operand widens to f32 inside the multiply (exact)
    return codes * scales[..., None]


def dequantize_emb(qemb: QuantEmb) -> torch.Tensor:
    """The whole stack dequantized to f32 (a test oracle; serving never
    makes it)."""
    return _dequant(qemb.codes, qemb.scales)


def quant_get_logical_table(qemb: QuantEmb, config, t: int) -> torch.Tensor:
    """Table ``t`` dequantized to (rows, D) f32."""
    off, n = config.table_offsets[t], config.table_sizes[t]
    return _dequant(qemb.codes[off:off + n], qemb.scales[off:off + n])


def quant_gather_tables(qemb: QuantEmb, ids: torch.Tensor, config
                        ) -> torch.Tensor:
    """Un-pooled dequantizing gather: ids (B, T[, H]) -> ids.shape + (D,)
    f32.  One int8 gather and one scale gather, then the scale multiply in
    f32."""
    flat = emb_ops.translate_ids(ids, config.table_offsets)
    return _dequant(emb_ops.gather_rows(qemb.codes, flat),
                    torch.index_select(qemb.scales, 0, flat.reshape(-1)
                                       ).reshape(flat.shape))


def quant_mixed_lookup(qemb: QuantEmb, ids: torch.Tensor, config
                       ) -> torch.Tensor:
    """Pooled lookup from quantized storage, (B, T, D) f32: every table
    gathered and dequantized, then sum-pooled in f32 (the JAX package's
    one-hot path for small tables gives the same values)."""
    return emb_ops.pool(quant_gather_tables(qemb, ids, config))


def table_bytes(qemb: QuantEmb) -> int:
    """Storage footprint (codes and scales) in bytes."""
    return sum(t.numel() * t.element_size()
               for t in (qemb.codes, qemb.scales))
