"""Operations and bytes a cell's work needs, from its shapes and from the
distinct ids of its batches, and the peaks of the card they are held to.
Nothing here is read from the program.

The peaks and :func:`bound` are copied from ``chip_smoke.py`` (its
``HBM_BYTES_PER_S``, ``F32_FLOPS``, ``PCIE_BYTES_PER_S`` and ``_bound``):
every input byte read once and every output byte written once, against the
published peaks of one H100 SXM.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

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


# -- the model's shapes --------------------------------------------------------

def interaction_features(cfg: dict) -> int:
    """F: the bottom MLP's output and the tables' rows re-chunked to its
    width."""
    d = cfg["bottom_mlp"][-1]
    return len(cfg["table_sizes"]) * cfg["feature_size"] // d + 1


def num_pairs(cfg: dict) -> int:
    f = interaction_features(cfg)
    return f * (f - 1) // 2


def mlp_layers(cfg: dict) -> List[Tuple[str, int, int]]:
    """(tower, in, out) of every dense layer; the top tower's input is the
    bottom output and the pairs."""
    bottom = cfg["bottom_mlp"]
    top = [bottom[-1] + num_pairs(cfg)] + list(cfg["top_mlp"])
    return ([("bottom", a, b) for a, b in zip(bottom, bottom[1:])]
            + [("top", a, b) for a, b in zip(top, top[1:])])


def forward_macs(cfg: dict) -> int:
    """Multiply-adds of one example's forward: the MLPs and the pair dots."""
    return (sum(a * b for _, a, b in mlp_layers(cfg))
            + num_pairs(cfg) * cfg["bottom_mlp"][-1])


def model_flops(cfg: dict, batch: int, train: bool) -> float:
    """Model FLOPs of one step (forward, and backward at twice the
    forward) or of one scored batch."""
    return 2.0 * forward_macs(cfg) * batch * (3 if train else 1)


def gemms(cfg: dict, batch: int, train: bool) -> List[Tuple[int, int, int]]:
    """(m, k, n) of every matrix product the step needs: each layer's
    forward; in training each weight's gradient and each layer's input
    gradient but the first bottom layer's (the dense features take none)."""
    out = []
    for i, (_, a, b) in enumerate(mlp_layers(cfg)):
        out.append((batch, a, b))
        if train:
            out.append((a, batch, b))       # dW = x^T dy
            if i:
                out.append((batch, b, a))   # dx = dy W^T
    return out


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
    writes dx and the rows' gradient."""
    d, f, p = cfg["bottom_mlp"][-1], interaction_features(cfg), num_pairs(cfg)
    x = batch * d * F32
    feats = batch * len(cfg["table_sizes"]) * cfg["feature_size"] * F32
    out = batch * (d + p) * F32
    s = bound("interaction_fwd", x + feats + out, batch, f, d)
    if train:
        s += bound("interaction_bwd", x + feats + out + x + feats, batch, f,
                   d)
    return s


# -- the tables ----------------------------------------------------------------

def distinct_rows(sparse: torch.Tensor, tables: Sequence[int]) -> int:
    """Distinct (table, row) pairs among the ids (B, T) of ``tables``."""
    if not tables:
        return 0
    cols = torch.as_tensor(list(tables), device=sparse.device)
    ids = sparse.index_select(1, cols).to(torch.int64)
    key = ids * len(tables) + torch.arange(len(tables), device=sparse.device)
    return int(torch.unique(key).numel())


def table_bytes(cfg: dict, job: dict, batch: int, sparse: torch.Tensor,
                device_tables: Sequence[int], train: bool) -> int:
    """Bytes the lookup and the update of the device tables need for these
    ids: the gather reads each distinct row once, its ids once, and writes
    one row a hit; SGD's scatter-add reads one update a hit and its id, and
    reads and writes each distinct row once; row-wise Adagrad reads and
    writes each distinct row and its accumulator once, and reads one
    summed gradient row and one id a distinct row."""
    row = cfg["feature_size"] * F32
    hits = batch * len(device_tables)
    u = distinct_rows(sparse, device_tables)
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
    u = distinct_rows(sparse, host_tables)
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

