"""PyTorch-exported HDF5 models and fixtures: the counterpart of
``dlrm_tpu/io/hdf5.py``, in this package's layout (one logical
``(total_rows, D)`` stack; MLP weights stored (in, out), transposed once on
the way in and once on the way out).

The file layout:
  * ``emb_{i}``: (rows, D) tables, in natural-sort order of the names;
  * ``bot_l.{j}.weight/bias``, ``top_l.{j}.weight/bias``: PyTorch
    ``(out, in)`` weights;
  * ``input_bot`` (B, 13), ``input_emb_{i}`` ((B,) one-hot or (B*H,)
    multi-hot, grouped per sample, 0-based), ``labels`` (B, 1);
  * the reference's intermediates (``mlp_bottom``, ``output_interaction``,
    ``mlp_top``, ``loss``) and its weights after one SGD step
    (``update_*``);
  * attribute ``n_hot``, which :func:`save_params` writes.

Parameters travel as the numpy pytree of ``io/convert.py``.  ``h5py`` is
imported by the functions that need it: the machine with the GPU has none.
"""

from __future__ import annotations

import re
from typing import Dict, Tuple

import numpy as np

from dlrm_tpu_torch.config import DLRMConfig


def _natural_key(s: str):
    return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", s)]


def _mlp_from_file(f, prefix: str) -> list:
    names = sorted((k for k in f.keys() if k.startswith(prefix)),
                   key=_natural_key)
    prefixes = []
    for n in names:
        p = n.rsplit(".", 1)[0]
        if p not in prefixes:
            prefixes.append(p)
    return [{"w": np.asarray(f[f"{p}.weight"]).T.copy(),  # (out,in)->(in,out)
             "b": np.asarray(f[f"{p}.bias"])} for p in prefixes]


def load_params(path: str) -> Tuple[dict, DLRMConfig]:
    """A PyTorch-exported model -> (numpy parameter pytree with the logical
    stack, config).  ``n_hot`` comes from the attribute, or for a fixture
    from its input shapes; a top MLP wider than the interaction's output
    gives the config that padding."""
    import h5py

    with h5py.File(path, "r") as f:
        emb_names = sorted((k for k in f.keys() if k.startswith("emb")),
                           key=_natural_key)
        tables = [np.asarray(f[n]) for n in emb_names]
        bottom = _mlp_from_file(f, "bot_")
        top = _mlp_from_file(f, "top_")
        h = int(f.attrs.get("n_hot", 1))
        if "input_emb_0" in f and "labels" in f:
            h = np.asarray(f["input_emb_0"]).shape[0] \
                // np.asarray(f["labels"]).shape[0]

    feature_size = tables[0].shape[1]
    num_tables = len(tables)
    raw_top_in = feature_size + (num_tables + 1) * num_tables // 2
    file_top_in = top[0]["w"].shape[0]
    if file_top_in < raw_top_in:
        raise ValueError(
            f"top MLP input width {file_top_in} is smaller than the "
            f"interaction output {raw_top_in} implied by {num_tables} "
            "tables — not a DLRM export this loader understands")
    config = DLRMConfig(
        bottom_mlp_sizes=tuple(l["w"].shape[0] for l in bottom)
        + (bottom[-1]["w"].shape[1],),
        top_mlp_sizes=tuple(l["w"].shape[1] for l in top),
        feature_size=feature_size,
        table_sizes=tuple(t.shape[0] for t in tables),
        n_hot=h,
        # rounding the raw width up to the file's width W gives W for any
        # W >= raw, so W serves as the multiple
        interaction_pad_to=file_top_in if file_top_in > raw_top_in else 1,
    )
    return {"bottom": bottom, "emb": np.concatenate(tables, axis=0),
            "top": top}, config


def load_inputs(path: str) -> Dict[str, np.ndarray]:
    """Fixture inputs: labels (B,), dense (B, 13), sparse ids (B, T) one-hot
    or (B, T, H) multi-hot, 0-based."""
    import h5py

    with h5py.File(path, "r") as f:
        labels = np.asarray(f["labels"]).reshape(-1).astype(np.float32)
        dense = np.asarray(f["input_bot"]).astype(np.float32)
        names = sorted((k for k in f.keys() if k.startswith("input_emb")),
                       key=_natural_key)
        b = labels.shape[0]
        cols = [np.asarray(f[n]).astype(np.int32).reshape(b, -1)
                for n in names]  # sample b owns ids[b*H:(b+1)*H]
    sparse = np.stack(cols, axis=1)  # (B, T, H)
    if all(c.shape[1] == 1 for c in cols):
        sparse = sparse[:, :, 0]
    return {"labels": labels, "dense": dense, "sparse": sparse}


def load_reference_outputs(path: str) -> Dict[str, np.ndarray]:
    """The reference's intermediates and post-step weights."""
    import h5py

    out = {}
    with h5py.File(path, "r") as f:
        for k in ("mlp_bottom", "output_interaction", "mlp_top", "loss",
                  "zflat", "concatenated_result"):
            if k in f:
                out[k] = np.asarray(f[k])
        for k in f.keys():
            if k.startswith("update_"):
                out[k] = np.asarray(f[k])
    return out


def save_params(path: str, np_params: dict, config: DLRMConfig) -> None:
    """Write a numpy parameter pytree in the PyTorch layout (f32; the
    inverse of :func:`load_params`, and the same bytes as the JAX
    package's ``save_params`` for the same parameters)."""
    import h5py

    emb = np_params["emb"]  # read a table at a time
    with h5py.File(path, "w") as f:
        # the datasets alone do not say the lookups are multi-hot
        f.attrs["n_hot"] = config.n_hot
        for i, (off, n) in enumerate(zip(config.table_offsets,
                                         config.table_sizes)):
            f[f"emb_{i}"] = np.asarray(emb[off:off + n], dtype=np.float32)
        for prefix, layers in (("bot_l", np_params["bottom"]),
                               ("top_l", np_params["top"])):
            for j, layer in enumerate(layers):
                f[f"{prefix}.{j}.weight"] = np.asarray(
                    layer["w"]).astype(np.float32).T
                f[f"{prefix}.{j}.bias"] = np.asarray(
                    layer["b"]).astype(np.float32)
