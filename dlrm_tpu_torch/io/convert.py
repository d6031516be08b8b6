"""Carry parameters and optimizer state between numpy and this package.

``np_params`` is the JAX package's parameter pytree as numpy arrays, with
``emb`` as the logical ``(total_rows, D)`` stack (the JAX package's
``ops.embedding.unpack_tables`` gives it from its packed storage)::

    {"bottom": [{"w", "b"}...], "emb": (total_rows, D), "top": [...]}

``np_opt`` is an optimizer state in the same logical view::

    {"dense": None | {"bottom": [{"w", "b"}...], "top": [...]},
     "emb": None | (total_rows, D) | (total_rows,), "count": int}

``dense`` holds the Adagrad accumulator of every dense parameter (optax's
``ScaleByRssState.sum_of_squares``), ``emb`` the logical view of the JAX
package's chunked lane-packed accumulators (``unpack_tables`` of the
elementwise ones; each chunk's ``(rows, pack)`` flattened and cut to the
tables' rows for the row-wise ones), ``count`` the steps taken.  SGD has
neither accumulator.

``quant_from_numpy`` takes the JAX package's int8 ``QuantEmb`` as numpy
(lane-packed int8 chunks and ``(rows, pack)`` scales) to this package's
logical ``QuantEmb``.

Numpy has no bfloat16 of its own: bf16 tensors leave as f32 (exact), and
arrays arrive in whatever float dtype they have and are cast to the
config's dtypes.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from dlrm_tpu_torch.config import DLRMConfig


def _to_torch(a, dtype: torch.dtype, device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:  # torch.from_numpy wants a writable buffer
        a = a.copy()
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: reinterpret bits
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def _check_mlp(layers, sizes, name):
    """Layer count and shapes of an MLP's leaves (arrays, tensors or
    checkpoint leaves: anything with a ``shape``) against the config."""
    if len(layers) != len(sizes) - 1:
        raise ValueError(f"{name}: {len(layers)} layers, the config has "
                         f"{len(sizes) - 1}")
    for i, layer in enumerate(layers):
        want = (sizes[i], sizes[i + 1])
        w, b = tuple(layer["w"].shape), tuple(layer["b"].shape)
        if w != want or b != want[1:]:
            raise ValueError(f"{name}[{i}]: w {w} / b {b}, the config needs "
                             f"{want} / {want[1:]}")


def check_dense(params, config: DLRMConfig) -> None:
    """Shapes of the ``bottom`` and ``top`` MLPs of a parameter tree
    against the config."""
    _check_mlp(params["bottom"], config.bottom_mlp_sizes, "bottom")
    _check_mlp(params["top"], config.full_top_mlp_sizes, "top")


def dense_from_numpy(np_params: dict, config: DLRMConfig,
                     device="cpu") -> dict:
    """The ``bottom`` and ``top`` MLPs of a numpy pytree as tensors on
    ``device``, in the config's weight dtype; shapes are checked."""
    check_dense(np_params, config)
    return {part: [{k: _to_torch(layer[k], config.weight_dtype, device)
                    for k in ("w", "b")} for layer in np_params[part]]
            for part in ("bottom", "top")}


def params_from_numpy(np_params: dict, config: DLRMConfig,
                      device="cpu") -> dict:
    """numpy pytree -> parameter dict of tensors on ``device``, in the
    config's dtypes; shapes are checked against the config."""
    dense = dense_from_numpy(np_params, config, device)
    emb_shape = (config.total_rows, config.feature_size)
    if tuple(np.shape(np_params["emb"])) != emb_shape:
        raise ValueError(f"emb {np.shape(np_params['emb'])}, the config "
                         f"needs the logical stack {emb_shape}")
    return {"bottom": dense["bottom"],
            "emb": _to_torch(np_params["emb"], config.embedding_dtype,
                             device),
            "top": dense["top"]}


def params_to_numpy(params: dict) -> dict:
    """Parameter dict -> numpy pytree (bf16 widened to f32)."""
    def mlp(layers):
        return [{k: _to_numpy(layer[k]) for k in ("w", "b")}
                for layer in layers]

    return {"bottom": mlp(params["bottom"]), "emb": _to_numpy(params["emb"]),
            "top": mlp(params["top"])}


def opt_state_from_numpy(np_opt: dict, config: DLRMConfig, optimizer: str,
                         device="cpu") -> dict:
    """numpy optimizer state -> the state ``train.init_opt_state`` makes
    for ``optimizer``, on ``device`` (f32 accumulators; shapes checked
    against the config)."""
    dense = emb = None
    if optimizer != "sgd":
        for part, sizes in (("bottom", config.bottom_mlp_sizes),
                            ("top", config.full_top_mlp_sizes)):
            _check_mlp(np_opt["dense"][part], sizes, f"dense.{part}")
        dense = {part: [{k: _to_torch(layer[k], config.weight_dtype, device)
                         for k in ("w", "b")}
                        for layer in np_opt["dense"][part]]
                 for part in ("bottom", "top")}
        want = ((config.total_rows, config.feature_size)
                if optimizer == "adagrad" else (config.total_rows,))
        if tuple(np.shape(np_opt["emb"])) != want:
            raise ValueError(f"emb accumulator {np.shape(np_opt['emb'])}, "
                             f"{optimizer} on this config needs {want}")
        emb = _to_torch(np_opt["emb"], torch.float32, device)
    return {"dense": dense, "emb": emb, "count": int(np_opt["count"])}


def opt_state_to_numpy(opt_state: dict) -> dict:
    """Optimizer state -> numpy, the inverse of
    :func:`opt_state_from_numpy`."""
    dense, emb = opt_state["dense"], opt_state["emb"]
    return {"dense": None if dense is None else {
                part: [{k: _to_numpy(layer[k]) for k in ("w", "b")}
                       for layer in dense[part]]
                for part in ("bottom", "top")},
            "emb": None if emb is None else _to_numpy(emb),
            "count": int(opt_state["count"])}


def save_npz(path: str, np_params: dict) -> None:
    """Write a numpy pytree as one .npz (keys ``bottom.{i}.w``, ``emb``,
    ...); bf16 arrays are widened to f32."""
    flat: Dict[str, np.ndarray] = {}
    for part in ("bottom", "top"):
        for i, layer in enumerate(np_params[part]):
            for k in ("w", "b"):
                flat[f"{part}.{i}.{k}"] = np.asarray(layer[k])
    flat["emb"] = np.asarray(np_params["emb"])
    flat = {k: a.astype(np.float32) if a.dtype.name == "bfloat16" else a
            for k, a in flat.items()}
    with open(path, "wb") as f:
        np.savez(f, **flat)


def load_npz(path: str) -> dict:
    """Read a .npz written by :func:`save_npz` back into a numpy pytree."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}

    def mlp(part):
        n = sum(1 for k in flat if k.startswith(part + ".") and k.endswith(".w"))
        return [{"w": flat[f"{part}.{i}.w"], "b": flat[f"{part}.{i}.b"]}
                for i in range(n)]

    return {"bottom": mlp("bottom"), "emb": flat["emb"], "top": mlp("top")}


def quant_from_numpy(chunks: Sequence[np.ndarray], scales: Sequence[np.ndarray],
                     config: DLRMConfig,
                     placement: Sequence[Tuple[int, int]]):
    """The JAX package's ``QuantEmb`` (as numpy) -> this package's
    ``QuantEmb`` on the CPU: logical ``(total_rows, D)`` int8 codes and
    ``(total_rows,)`` f32 scales.

    ``chunks[c]`` is int8 ``(rows, pack * D)``, ``scales[c]`` ``(rows,
    pack)``: physical row r of a chunk holds logical rows ``r * pack ..
    r * pack + pack - 1`` of its tables, each with its own scale.
    ``placement[t] = (chunk, first physical row)`` of table t (the JAX
    config's ``table_chunk`` and ``chunk_table_offsets``; for plain
    storage, chunk 0 and the table's row offset); a table's rows are
    padded to a multiple of ``pack``.
    """
    from dlrm_tpu_torch.ops.quant import QuantEmb, check_quant_storage

    d = config.feature_size
    codes, scl = [], []
    for n, (c, first) in zip(config.table_sizes, placement):
        pack = chunks[c].shape[1] // d
        rows = -(-n // pack)
        codes.append(np.asarray(chunks[c][first:first + rows]
                                ).reshape(rows * pack, d)[:n])
        scl.append(np.asarray(scales[c][first:first + rows], np.float32
                              ).reshape(rows * pack)[:n])
    out = QuantEmb(torch.from_numpy(np.concatenate(codes).astype(np.int8)),
                   torch.from_numpy(np.concatenate(scl)))
    check_quant_storage(out, config)
    return out
