"""Operations and bytes a cell's work needs, from its shapes and from the
distinct ids of its batches, and the peaks of the card they are held to.
Nothing here is read from the program.  A model's multiply-adds and matrix
products are its reference module's (``reference/__init__.py``); a batch's
id columns are the traffic's (``traffic.table_columns``).

The peaks and :func:`bound` are copied from ``chip_smoke.py`` (its
``HBM_BYTES_PER_S``, ``F32_FLOPS``, ``PCIE_BYTES_PER_S`` and ``_bound``):
every input byte read once and every output byte written once, against the
published peaks of one H100 SXM.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from benchmark import spec, traffic

# published peaks of one H100 SXM: HBM3 bytes/s, f32 FLOP/s outside the
# tensor cores (the configurations compute in f32 with TF32 off)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# the card's host link, PCIe Gen5 x16: 128 GB/s both ways together, so
# 64 GB/s each way
PCIE_BYTES_PER_S = 64e9
F32 = 4


def bound(kname: str, nbytes: int, b: int, f: int, d: int) -> float:
    """The least seconds one interaction call could take: its bytes at the
    HBM rate against the f32 multiply-adds it needs at the f32 peak.
    Forward: the P pair dots of D products a sample; backward: dT = (dZ +
    dZ^T) T, F * F * D products a sample."""
    flops = 2 * b * d * (f * (f - 1) // 2 if kname == "interaction_fwd"
                         else f * f)
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS)


# -- the model's counts --------------------------------------------------------

def forward_macs(cfg: dict) -> int:
    """Multiply-adds of one example's forward."""
    return spec.model(cfg).forward_macs(cfg)


def model_flops(cfg: dict, batch: int, train: bool) -> float:
    """Model FLOPs of one step (forward, and backward at twice the
    forward) or of one scored batch."""
    return 2.0 * forward_macs(cfg) * batch * (3 if train else 1)


def gemms(cfg: dict, batch: int, train: bool) -> List[Tuple[int, int, int]]:
    """(m, k, n) of every matrix product of a step or scored batch."""
    return spec.model(cfg).gemms(cfg, batch, train)


def gemm_bound_s(cfg: dict, batch: int, train: bool) -> float:
    """The least seconds of a step's matrix products: each at the larger
    of its FLOPs at the f32 peak and its operands and result at the HBM
    rate."""
    total = 0.0
    for m, k, n in gemms(cfg, batch, train):
        flops = 2.0 * m * k * n
        nbytes = F32 * (m * k + k * n + m * n)
        total += max(flops / F32_FLOPS, nbytes / HBM_BYTES_PER_S)
    return total


def interaction_bound_s(cfg: dict, batch: int, train: bool) -> float:
    """:func:`bound` of the forward call, and in training of the backward:
    x (B, d) and the pooled rows (B, T, D) read, the (B, d + P) output
    written; the backward reads both and the cotangent's d + P columns and
    writes dx and the rows' gradient.  For a model with the dot
    interaction only: its module gives ``interaction_features`` and
    ``num_pairs`` (``reference/__init__.py``)."""
    dot = spec.model(cfg)
    d = cfg["bottom_mlp"][-1]
    f, p = dot.interaction_features(cfg), dot.num_pairs(cfg)
    x = batch * d * F32
    feats = batch * len(cfg["table_sizes"]) * cfg["feature_size"] * F32
    out = batch * (d + p) * F32
    s = bound("interaction_fwd", x + feats + out, batch, f, d)
    if train:
        s += bound("interaction_bwd", x + feats + out + x + feats, batch, f,
                   d)
    return s


# -- the tables ----------------------------------------------------------------

def _hotness(cfg: dict) -> List[int]:
    """The configuration's lookups an example, table by table."""
    return traffic.hotness(cfg["n_hot"], len(cfg["table_sizes"]))


def distinct_rows(sparse: torch.Tensor, tables: Sequence[int],
                  hot: Optional[Sequence[int]] = None) -> int:
    """Distinct (table, row) pairs among the ids (B, sum H) of ``tables``,
    over each table's ``hot[t]`` columns (``hot`` None: one a table)."""
    if not tables:
        return 0
    if hot is None:
        hot = [1] * sparse.shape[1]
    cols = traffic.table_columns(tables, hot)
    which = [k for k, t in enumerate(tables) for _ in range(hot[t])]
    ids = sparse.index_select(
        1, torch.as_tensor(cols, device=sparse.device)).to(torch.int64)
    key = ids * len(tables) + torch.as_tensor(which, device=sparse.device)
    return int(torch.unique(key).numel())


def table_bytes(cfg: dict, job: dict, batch: int, sparse: torch.Tensor,
                device_tables: Sequence[int], train: bool) -> int:
    """Bytes the lookup and the update of the device tables need for these
    ids: the gather reads each distinct row once, its ids once, and writes
    one row a hit; SGD's scatter-add reads one update a hit and its id, and
    reads and writes each distinct row once; row-wise Adagrad reads and
    writes each distinct row and its accumulator once, and reads one
    summed gradient row and one id a distinct row.  A table's hits are
    those of all its ``hot[t]`` columns."""
    row = cfg["feature_size"] * F32
    hot = _hotness(cfg)
    hits = batch * sum(hot[t] for t in device_tables)
    u = distinct_rows(sparse, device_tables, hot)
    idx = 4
    nbytes = u * row + hits * (row + idx)
    if not train:
        return nbytes
    opt = job["sparse_optimizer"]
    if opt == "sgd":
        return nbytes + hits * (row + idx) + 2 * u * row
    if opt == "rowwise_adagrad":
        return nbytes + u * (3 * row + idx + 2 * F32 + idx)
    raise ValueError(f"no byte count for the sparse optimizer {opt!r}")


def host_tier_bound_s(cfg: dict, job: dict, sparse: torch.Tensor,
                      host_tables: Sequence[int], train: bool) -> float:
    """The least seconds of the host tier's work over PCIe for these ids,
    at 64 GB/s each way: the lookup brings each distinct host row to the
    card once; row-wise Adagrad brings each distinct row's accumulator
    too, and writes back each row and its accumulator once.  The two
    directions run at once, so the larger of them bounds the time."""
    u = distinct_rows(sparse, host_tables, _hotness(cfg))
    row = cfg["feature_size"] * F32
    to_card = u * row
    to_host = 0
    if train:
        opt = job["sparse_optimizer"]
        if opt == "rowwise_adagrad":
            to_card += u * F32
            to_host = u * (row + F32)
        elif opt == "sgd":
            to_host = u * row
        else:
            raise ValueError(f"no byte count for {opt!r}")
    return max(to_card, to_host) / PCIE_BYTES_PER_S

