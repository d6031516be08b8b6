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

``tiered_params_from_numpy`` and ``tiered_opt_state_from_numpy`` take the
JAX package's two-tier parameters and optimizer state (device tier as its
logical stack, flat host stacks) to this package's two tiers.

``sharded_params_from_numpy`` takes the JAX package's sharded parameters
(the per-shard stacks, column shards and host stacks) to one rank's
tensors, and ``sharded_params_to_numpy`` gathers every rank's back;
``sharded_opt_state_from_numpy`` / ``_to_numpy`` do the same for the JAX
package's sharded optimizer state.

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


def _dense_acc_from_numpy(np_dense: dict, config: DLRMConfig,
                          device) -> dict:
    for part, sizes in (("bottom", config.bottom_mlp_sizes),
                        ("top", config.full_top_mlp_sizes)):
        _check_mlp(np_dense[part], sizes, f"dense.{part}")
    return {part: [{k: _to_torch(layer[k], config.weight_dtype, device)
                    for k in ("w", "b")} for layer in np_dense[part]]
            for part in ("bottom", "top")}


def opt_state_from_numpy(np_opt: dict, config: DLRMConfig, optimizer: str,
                         device="cpu") -> dict:
    """numpy optimizer state -> the state ``train.init_opt_state`` makes
    for ``optimizer``, on ``device`` (f32 accumulators; shapes checked
    against the config)."""
    dense = emb = None
    if optimizer != "sgd":
        dense = _dense_acc_from_numpy(np_opt["dense"], config, device)
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


def _host_tier(a, shape, dtype: torch.dtype, device) -> torch.Tensor:
    """A host-tier tensor (pinned for a CUDA ``device``) holding ``a``
    reshaped to ``shape``."""
    from dlrm_tpu_torch.parallel.host_tier import _host_empty

    a = np.reshape(a, shape)
    out = _host_empty(a.shape, dtype, device)
    out.copy_(_to_torch(a, dtype, "cpu"))
    return out


def tiered_params_from_numpy(np_tiered: dict, plan, config: DLRMConfig,
                             device="cpu") -> dict:
    """The JAX package's two-tier parameters as numpy -> this package's
    ``{"bottom", "top", "emb": TieredEmb}``: the device tier on ``device``
    and the host tier in host memory (pinned for a CUDA device).

    ``np_tiered``: ``{"bottom", "top", "emb_dev", "emb_host"}`` with
    ``emb_dev`` the device tier as its logical ``(R_dev, D)`` stack (the
    JAX package's ``unpack_tables`` of its engine chunks under the device
    sub-config) and ``emb_host`` the host stack, flat or ``(R_host, D)``;
    ``plan`` the ``parallel.host_tier.TierPlan`` of both."""
    from dlrm_tpu_torch.parallel.host_tier import (TieredEmb,
                                                   check_tiered_storage)

    d, dtype = config.feature_size, config.embedding_dtype
    dev = _to_torch(np.reshape(np_tiered["emb_dev"], (-1, d)), dtype, device)
    host = _host_tier(np_tiered["emb_host"], (-1, d), dtype, device)
    emb = TieredEmb(dev, host, plan)
    check_tiered_storage(emb, config)
    return {**dense_from_numpy(np_tiered, config, device), "emb": emb}


def tiered_opt_state_from_numpy(np_opt: dict, plan, config: DLRMConfig,
                                optimizer: str, device="cpu") -> dict:
    """The JAX package's two-tier optimizer state as numpy -> the state
    ``parallel.host_tier.init_tiered_opt_state`` makes: ``dense`` and
    ``count`` as in :func:`opt_state_from_numpy`, ``dev_acc`` the device
    tier's logical accumulator (``(R_dev, D)``, or ``(R_dev,)`` row-wise:
    the view ``opt_state_from_numpy`` takes, under the device sub-config)
    on ``device``, ``host_acc`` the JAX package's flat host accumulator
    in host memory (pinned for a CUDA device)."""
    state = {"dense": None, "count": int(np_opt["count"]), "dev_acc": None,
             "host_acc": None}
    if optimizer != "sgd":
        tail = (config.feature_size,) if optimizer == "adagrad" else ()
        state["dense"] = _dense_acc_from_numpy(np_opt["dense"], config,
                                               device)
        state["dev_acc"] = _to_torch(np.reshape(
            np_opt["dev_acc"], (plan.device_rows, *tail)), torch.float32,
            device)
        state["host_acc"] = _host_tier(np_opt["host_acc"],
                                       (plan.host_rows, *tail),
                                       torch.float32, device)
    return state


def _keep_dtype(a, device) -> torch.Tensor:
    """An array as a tensor of its own dtype (bfloat16 kept) on
    ``device``."""
    a = np.asarray(a)
    dtype = torch.bfloat16 if a.dtype.name == "bfloat16" \
        else torch.from_numpy(np.zeros(0, a.dtype)).dtype
    return _to_torch(a, dtype, device)


def _host_keep_dtype(a, device) -> torch.Tensor:
    """An array as a host tensor of its own dtype, in host memory
    registered with the card for a CUDA ``device``."""
    from dlrm_tpu_torch.parallel.host_tier import _host_empty

    t = _keep_dtype(a, "cpu")
    out = _host_empty(t.shape, t.dtype, device)
    return out.copy_(t)


def _check_stacked(a, n: int, want: tuple, name: str) -> np.ndarray:
    """``a`` as an array, checked to hold every shard's stack: ``(n,
    *want, ...)``."""
    a = np.asarray(a)
    if tuple(a.shape[:1 + len(want)]) != (n, *want):
        raise ValueError(f"{name} {a.shape}, the placement needs "
                         f"({n}, {', '.join(map(str, want))}, ...)")
    return a


def sharded_params_from_numpy(np_params: dict, placement, rank: int,
                              device="cpu") -> dict:
    """The JAX package's sharded parameters as numpy -> rank ``rank``'s
    tensors on ``device``, in their own dtypes.

    ``np_params``: ``{"bottom", "top", "emb", "emb_cs", "emb_h"}`` with
    ``emb`` the ``(N, local_rows, D)`` per-shard stacks (``parallel
    .embedding.shard_tables``), ``emb_cs`` the ``(N, R_t, D/N)`` column
    shards of ``placement.col_sharded`` (absent or empty without them) and
    ``emb_h`` the ``(N, host_local_rows, D)`` host stacks
    (``shard_host_tables``; needed when the placement has host-resident
    tables).  Returns ``{"bottom", "top", "emb": (local_rows, D),
    "emb_cs": ((R_t, D/N), ...)}`` and, with host tables, ``"emb_h":
    (host_local_rows, D)`` in host memory (registered with the card for a
    CUDA ``device``)."""
    n = placement.num_shards
    emb = _check_stacked(np_params["emb"], n, (placement.local_rows,), "emb")
    cs = tuple(np_params.get("emb_cs", ()))
    if len(cs) != len(placement.col_sharded):
        raise ValueError(f"{len(cs)} column-sharded tables, the placement "
                         f"has {len(placement.col_sharded)}")
    for a, t in zip(cs, placement.col_sharded):
        want = (n, placement.table_sizes[t], np.shape(emb)[2] // n)
        if tuple(np.shape(a)) != want:
            raise ValueError(f"column shards of table {t}: {np.shape(a)}, "
                             f"the placement needs {want}")
    dense = {part: [{k: _keep_dtype(layer[k], device) for k in ("w", "b")}
                    for layer in np_params[part]]
             for part in ("bottom", "top")}
    out = {**dense, "emb": _keep_dtype(emb[rank], device),
           "emb_cs": tuple(_keep_dtype(np.asarray(a)[rank], device)
                           for a in cs)}
    if placement.host_row_sharded:
        if np_params.get("emb_h") is None:
            raise ValueError(f"the placement has host-resident tables "
                             f"{list(placement.host_row_sharded)}: emb_h "
                             f"is needed")
        emb_h = _check_stacked(np_params["emb_h"], n,
                            (placement.host_local_rows, emb.shape[2]),
                            "emb_h")
        out["emb_h"] = _host_keep_dtype(emb_h[rank], device)
    return out


def _arr(x) -> np.ndarray:
    return _to_numpy(x) if isinstance(x, torch.Tensor) else np.asarray(x)


def sharded_params_to_numpy(rank_params: Sequence[dict]) -> dict:
    """Inverse of :func:`sharded_params_from_numpy` over every rank: the
    ranks' parameter dicts (tensors or arrays, rank order) -> the JAX
    package's sharded layout as numpy (dense parameters from rank 0; bf16
    widened to f32)."""
    first = rank_params[0]
    out = {part: [{k: _arr(layer[k]) for k in ("w", "b")}
                  for layer in first[part]] for part in ("bottom", "top")}
    out["emb"] = np.stack([_arr(p["emb"]) for p in rank_params])
    out["emb_cs"] = tuple(
        np.stack([_arr(p["emb_cs"][j]) for p in rank_params])
        for j in range(len(first.get("emb_cs", ()))))
    if first.get("emb_h") is not None:
        out["emb_h"] = np.stack([_arr(p["emb_h"]) for p in rank_params])
    return out


def sharded_opt_state_from_numpy(np_opt: dict, placement, optimizer: str,
                                 rank: int, device="cpu") -> dict:
    """The JAX package's sharded optimizer state as numpy -> rank
    ``rank``'s, as ``train.init_sharded_opt_state`` lays it out, on
    ``device`` (f32; the host accumulator in host memory, registered with
    the card for a CUDA ``device``).

    ``np_opt``: ``dense`` (as :func:`opt_state_from_numpy` takes it, None
    for sgd), ``count``, and for adagrad / rowwise_adagrad ``emb_acc``
    ``(N, local_rows, D)`` / ``(N, local_rows, 1)`` (the JAX package's
    row-wise ``(N, local_rows, pack)`` at pack 1), ``emb_acc_cs`` one per
    column-sharded table, ``(N, R_t, D/N)`` / ``(R_t,)``, and ``emb_acc_h``
    ``(N, host_local_rows, D)`` / ``(N, host_local_rows, 1)`` with host
    tables (``()`` or None without)."""
    from dlrm_tpu_torch.train.optim import check_optimizer

    check_optimizer(optimizer)
    n = placement.num_shards
    out = {"dense": None, "count": int(np_opt["count"]), "emb_acc": None,
           "emb_acc_cs": (), "emb_acc_h": None}
    if optimizer == "sgd":
        return out
    rowwise = optimizer == "rowwise_adagrad"

    def rank_acc(a, rows, name):
        a = _check_stacked(a, n, (rows,), name)[rank]
        return a.reshape(rows) if rowwise else a

    dense = np_opt["dense"]
    out["dense"] = {part: [{k: _to_torch(layer[k], torch.float32, device)
                            for k in ("w", "b")} for layer in dense[part]]
                    for part in ("bottom", "top")}
    out["emb_acc"] = _to_torch(rank_acc(np_opt["emb_acc"],
                                        placement.local_rows, "emb_acc"),
                               torch.float32, device)
    accs = tuple(np_opt.get("emb_acc_cs", ()))
    if len(accs) != len(placement.col_sharded):
        raise ValueError(f"{len(accs)} column-shard accumulators, the "
                         f"placement has {len(placement.col_sharded)} "
                         f"column-sharded tables")
    out["emb_acc_cs"] = tuple(_to_torch(
        a if rowwise else _check_stacked(a, n, (placement.table_sizes[t],),
                                      "emb_acc_cs")[rank],
        torch.float32, device) for a, t in zip(accs, placement.col_sharded))
    if placement.host_row_sharded:
        acc_h = rank_acc(np_opt["emb_acc_h"], placement.host_local_rows,
                         "emb_acc_h")
        out["emb_acc_h"] = _host_tier(acc_h, acc_h.shape, torch.float32,
                                      device)
    return out


def sharded_opt_state_to_numpy(rank_states: Sequence[dict]) -> dict:
    """Inverse of :func:`sharded_opt_state_from_numpy` over every rank
    (rank order): the JAX package's layout as numpy, the dense
    accumulators and the row-wise column-shard ones from rank 0."""
    first = rank_states[0]
    out = {"dense": None if first["dense"] is None else {
               part: [{k: _arr(layer[k]) for k in ("w", "b")}
                      for layer in first["dense"][part]]
               for part in ("bottom", "top")},
           "count": int(first["count"]), "emb_acc": (), "emb_acc_cs": (),
           "emb_acc_h": ()}
    if first["emb_acc"] is None:
        return out

    def stack(key):
        a = np.stack([_arr(s[key]) for s in rank_states])
        return a[..., None] if a.ndim == 2 else a

    out["emb_acc"] = stack("emb_acc")
    out["emb_acc_cs"] = tuple(
        _arr(a) if a.dim() == 1 else np.stack(
            [_arr(s["emb_acc_cs"][j]) for s in rank_states])
        for j, a in enumerate(first["emb_acc_cs"]))
    if first["emb_acc_h"] is not None:
        out["emb_acc_h"] = stack("emb_acc_h")
    return out


def sharded_quant_from_numpy(codes, scales, cs_codes=(), cs_scales=(), *,
                             placement, rank: int, device="cpu") -> dict:
    """The JAX package's int8 shard stacks (numpy, ``pack=1``) -> rank
    ``rank``'s, as ``parallel.embedding.sharded_lookup`` serves them.

    ``codes`` ``(N, local_rows, D)`` int8 and ``scales`` ``(N,
    local_rows, 1)`` (its ``quantize_sharded_stack``), ``cs_codes`` one
    ``(N, R_t, D/N)`` per column-sharded table and ``cs_scales`` their
    ``(N, R_t)`` (its ``quantize_col_shards``).  Returns ``{"emb":
    (local_rows, D) int8, "emb_scales": (local_rows,), "emb_cs": ((R_t,
    D/N) int8, ...), "emb_cs_scales": ((R_t,), ...)}`` on ``device``."""
    n, rows = placement.num_shards, placement.local_rows
    codes = _check_stacked(codes, n, (rows,), "codes")
    scales = _check_stacked(scales, n, (rows, 1), "scales")
    if len(cs_codes) != len(placement.col_sharded) or \
            len(cs_scales) != len(cs_codes):
        raise ValueError(f"{len(cs_codes)} column-shard codes and "
                         f"{len(cs_scales)} scales, the placement has "
                         f"{len(placement.col_sharded)} column-sharded "
                         f"tables")
    return {"emb": _to_torch(codes[rank], torch.int8, device),
            "emb_scales": _to_torch(scales[rank, :, 0], torch.float32,
                                    device),
            "emb_cs": tuple(_to_torch(np.asarray(c)[rank], torch.int8, device)
                            for c in cs_codes),
            "emb_cs_scales": tuple(_to_torch(np.asarray(c)[rank],
                                             torch.float32, device)
                                   for c in cs_scales)}


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
