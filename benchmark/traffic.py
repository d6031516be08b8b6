"""The one generator of every traffic mix: a pool of batches made on the
device from ``--seed`` in set-up and held in host memory, which the window
then cycles through.

The id law is ``ClickthroughModel``'s (``dlrm_tpu_torch/data/synthetic.py``)
without its stored tables: per table, a rank is drawn from Zipf(a) (numpy's
``random_zipf`` rejection sampler, vectorised) and clamped at the table's
last row, then scattered over the rows by a seeded affine bijection
``row = (a * rank + c) mod n`` with ``gcd(a, n) = 1``, computed rather than
stored (a stored permutation is 8 B a row: 1.6 GB at Terabyte's sizes).
Dense features are N(0, 1).  Labels are Bernoulli over a planted logit: a
linear term on the dense features, one affinity a table hashed from the
id's rank, and N(0, NOISE) noise, at ClickthroughModel's constants.  A
``uniform`` law draws every row with equal chance (``random_batch``'s law).

A configuration's ``n_hot`` gives each table its number of lookups an
example, sum pooled: one int H for every table, or a list of one hotness
H_t a table (:func:`hotness`).  The ids follow MLPerf DLRM-DCNv2's
multi-hot law (``mlcommons/training``, ``recommendation_v2/torchrec_dlrm``:
``materialize_synthetic_multihot_dataset.py --multi_hot_distribution_type
uniform``, its ``multi_hot.py``): a table's one-hot id, drawn as above,
comes first, then H_t - 1 ids, column ``j`` a fixed function of (table,
id, j), uniform over the table's rows.  That script stores the function as
a table of ``randint(0, rows)``; here it is hashed (:func:`multi_hot`),
since a stored table is 8 B an id and slot.  So a table's columns at H_t
are the first H_t of its columns at any larger hotness, and an all-equal
list is its int.  The labels read the one-hot ids alone, so every hotness
draws the same dense features, one-hot ids and labels.  A batch's ids are
(B, sum H_t), each table's H_t columns side by side in table order
(:func:`table_columns`).

A mix file gives ``batch``, ``pool_batches`` and ``ids`` (``law``, ``a``).
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Dict, List, Sequence

import numpy as np
import torch

MASK64 = (1 << 64) - 1
M31 = (1 << 31) - 1
RAND_INT_MAX = (1 << 63) - 1

# the planted logit's constants, ClickthroughModel's: its ``noise`` default,
# the dense weights' N(0, 0.3), and a table's affinity spread 1.5/sqrt(T)
NOISE = 0.5
DENSE_W_STD = 0.3
AFFINITY = 1.5


def hotness(n_hot, tables: int) -> List[int]:
    """A configuration's ``n_hot`` as the lookups an example of each of its
    ``tables`` tables: one whole number >= 1 for every table, or a list of
    ``tables`` of them."""
    hot = list(n_hot) if isinstance(n_hot, (list, tuple)) \
        else [n_hot] * tables
    if len(hot) != tables or any(isinstance(h, bool) or not isinstance(h, int)
                                 or h < 1 for h in hot):
        raise ValueError(f"n_hot {n_hot!r}: one whole number >= 1 for every "
                         f"table, or a list of {tables} of them")
    return hot


def table_columns(tables: Sequence[int], hot: Sequence[int]) -> List[int]:
    """The columns of ``tables`` in a batch's ids (B, sum H), table by
    table: table ``t``'s are ``sum(hot[:t]) .. sum(hot[:t + 1]) - 1``."""
    starts = [0, *itertools.accumulate(hot)]
    return [c for t in tables for c in range(starts[t], starts[t + 1])]


def splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & MASK64
    return x ^ (x >> 31)


def stream_seed(seed: int, stream: int) -> int:
    """A generator seed for one stream of a run (weights, traffic, ...),
    from ``--seed``, which may exceed 32 bits."""
    return splitmix64(splitmix64(int(seed) & MASK64) ^ stream) & (MASK64 >> 1)


def bijection(seed: int, table: int, n: int):
    """(a, c) of the table's rank-to-row bijection ``(a * r + c) mod n``."""
    h1 = splitmix64(stream_seed(seed, 2) ^ (table * 0x9E37))
    h2 = splitmix64(h1)
    if n <= 2:
        return 1, h2 % n
    a = h1 % (n - 1) + 1
    while math.gcd(a, n) != 1:
        a = a % (n - 1) + 1
    return a, h2 % n


def scatter(ranks: torch.Tensor, a: torch.Tensor, c: torch.Tensor,
            n: torch.Tensor) -> torch.Tensor:
    """Rows of int64 ranks under the bijections (a, c, n broadcast)."""
    return (ranks * a + c) % n


def zipf_ranks(gen: torch.Generator, n: torch.Tensor, a: float
               ) -> torch.Tensor:
    """0-based Zipf(a) ranks, one for each entry of ``n`` (int64, the
    table's rows), clamped at ``n - 1``: numpy's ``random_zipf``, drawn
    in float64 on the generator's device until every entry is accepted."""
    am1 = a - 1.0
    b = 2.0 ** am1
    umin = float(RAND_INT_MAX) ** -am1
    dev = n.device
    out = torch.empty(n.shape, dtype=torch.float64, device=dev)
    flat = out.view(-1)
    pending = torch.arange(flat.numel(), device=dev)
    while pending.numel():
        m = pending.numel()
        u01 = torch.rand(m, dtype=torch.float64, generator=gen, device=dev)
        v = torch.rand(m, dtype=torch.float64, generator=gen, device=dev)
        u = u01 * umin + (1.0 - u01)
        x = torch.floor(u.pow(-1.0 / am1))
        ok = (x <= float(RAND_INT_MAX)) & (x >= 1.0)
        t = (1.0 + 1.0 / x).pow(am1)
        ok &= v * x * (t - 1.0) / (b - 1.0) <= t / b
        flat[pending[ok]] = x[ok]
        pending = pending[~ok]
    last = (n - 1).to(torch.float64)
    return torch.minimum(out - 1.0, last).to(torch.int64)


def hash31(x: torch.Tensor) -> torch.Tensor:
    """A bijection of int64 values in [0, 2**31)."""
    for k in (0x2C1B3C6D, 0x297A2D39):
        x = ((x ^ (x >> 15)) * k) & M31
    return x ^ (x >> 16)


def hash_unit(x: torch.Tensor) -> torch.Tensor:
    """Non-negative int64 values below 2**31 -> float64 in [0, 1)."""
    return hash31(x).to(torch.float64) / float(1 << 31)


def multi_hot(rows: torch.Tensor, n: torch.Tensor, seed: int, n_hot
              ) -> torch.Tensor:
    """One-hot ids (B, T), int64 below 2**31, -> (B, sum H_t), H the
    per-table :func:`hotness` of ``n_hot``: each table's id, then H_t - 1
    more of its table, column ``j`` a fixed function of (table, id, j)
    uniform over the table's ``n`` rows (62 hashed bits mod n)."""
    t = rows.shape[1]
    hot = hotness(n_hot, t)
    base = stream_seed(seed, 5)
    owner = [k for k in range(t) for _ in range(1, hot[k])]
    if not owner:
        return rows
    salts = torch.tensor(
        [[splitmix64(base ^ (k << 20 | j << 1 | half)) & M31
          for half in (0, 1)] for k in range(t) for j in range(1, hot[k])],
        dtype=torch.int64, device=rows.device)
    idx = torch.tensor(owner, dtype=torch.int64, device=rows.device)
    r = rows.index_select(1, idx)
    hi, lo = hash31(r ^ salts[:, 0]), hash31(r ^ salts[:, 1])
    extra = ((hi << 31) | lo) % n.index_select(0, idx)
    # table k's one-hot id (column k), then its extra ids (after the T)
    order, e = [], t
    for k in range(t):
        order += [k, *range(e, e + hot[k] - 1)]
        e += hot[k] - 1
    return torch.cat([rows, extra], dim=1).index_select(
        1, torch.tensor(order, dtype=torch.int64, device=rows.device))


@dataclasses.dataclass
class Pool:
    """``n`` batches of ``batch`` examples in host memory: ``dense`` (n, B,
    13) f32, ``sparse`` (n, B, sum H) int32 per-table ids, each table's
    ``hot[t]`` columns side by side, ``labels`` (n, B) f32; pinned for a
    mix that feeds ``device_prefetch``."""

    dense: torch.Tensor
    sparse: torch.Tensor
    labels: torch.Tensor
    hot: List[int]              # the per-table hotness
    seconds: float = 0.0

    def __len__(self) -> int:
        return self.dense.shape[0]

    def batch(self, i: int) -> Dict[str, torch.Tensor]:
        """Batch ``i`` as the program takes it: ids (B, T) one-hot, (B, T,
        H) (``--n-hot``) at one hotness H > 1 for every table, and the flat
        (B, sum H) at mixed hotness, each table's bag side by side."""
        i %= len(self)
        sparse = self.sparse[i]
        if len(set(self.hot)) == 1 and self.hot[0] > 1:
            sparse = sparse.view(sparse.shape[0], -1, self.hot[0])
        return {"dense": self.dense[i], "sparse": sparse,
                "labels": self.labels[i]}

    def numpy_batch(self, i: int) -> Dict[str, np.ndarray]:
        return {k: v.numpy() for k, v in self.batch(i).items()}


def draw(traffic: dict, table_sizes: Sequence[int], num_dense: int,
         seed: int, n_batches: int, batch: int, device,
         first: int = 0, n_hot=1) -> Dict[str, torch.Tensor]:
    """Batches ``first .. first + n_batches - 1`` of the mix on ``device``:
    (dense, sparse, labels), each table's ``n_hot`` ids (:func:`multi_hot`).
    Batch ``i`` is the same whatever chunk it is drawn in: each batch has a
    generator of its own."""
    device = torch.device(device)
    ids = traffic["ids"]
    law = ids["law"]
    if law not in ("zipf", "uniform"):
        raise ValueError(f"unknown id law {law!r}")
    hot = hotness(n_hot, len(table_sizes))
    if max(table_sizes) >= 1 << 31:
        raise ValueError("ids are int32: a table of 2**31 rows or more")
    t = len(table_sizes)
    n = torch.tensor(table_sizes, dtype=torch.int64, device=device)
    ac = [bijection(seed, k, s) for k, s in enumerate(table_sizes)]
    a = torch.tensor([x for x, _ in ac], dtype=torch.int64, device=device)
    c = torch.tensor([y for _, y in ac], dtype=torch.int64, device=device)
    g = torch.Generator(device).manual_seed(stream_seed(seed, 3))
    dense_w = torch.randn(num_dense, generator=g, device=device,
                          dtype=torch.float32) * DENSE_W_STD
    scale = AFFINITY / math.sqrt(t)
    salt = stream_seed(seed, 4) & M31
    cols = torch.arange(t, device=device, dtype=torch.int64)
    dense_out, sparse_out, label_out = [], [], []
    for i in range(first, first + n_batches):
        gi = torch.Generator(device).manual_seed(stream_seed(seed, 1000 + i))
        dense = torch.randn((batch, num_dense), generator=gi, device=device,
                            dtype=torch.float32)
        shape_n = n.expand(batch, t)
        if law == "zipf":
            ranks = zipf_ranks(gi, shape_n, float(ids["a"]))
            rows = scatter(ranks, a, c, n)
        else:
            u = torch.rand((batch, t), dtype=torch.float64, generator=gi,
                           device=device)
            rows = torch.minimum((u * n).to(torch.int64), n - 1)
            ranks = rows
        aff = hash_unit((ranks * 0x9E37 + cols * 0x85EB + salt) & M31)
        logit = (dense @ dense_w).double() + (
            (2.0 * aff - 1.0) * (scale * math.sqrt(3.0))).sum(dim=1)
        logit += torch.randn(batch, generator=gi, device=device,
                             dtype=torch.float64) * NOISE
        p = torch.sigmoid(logit)
        labels = (torch.rand(batch, generator=gi, device=device,
                             dtype=torch.float64) < p).to(torch.float32)
        rows = multi_hot(rows, n, seed, hot)
        dense_out.append(dense)
        sparse_out.append(rows.to(torch.int32))
        label_out.append(labels)
    return {"dense": torch.stack(dense_out), "sparse": torch.stack(sparse_out),
            "labels": torch.stack(label_out)}


def make_pool(traffic: dict, table_sizes: Sequence[int], num_dense: int,
              seed: int, device, *, batch: int, n_batches: int,
              pinned: bool, chunk: int = 8, n_hot=1) -> Pool:
    """The mix's pool, drawn on ``device`` ``chunk`` batches at a time into
    host tensors (pinned when ``pinned``)."""
    import time

    t0 = time.perf_counter()
    hot = hotness(n_hot, len(table_sizes))
    pin = pinned and torch.device(device).type == "cuda"
    pool = Pool(
        dense=torch.empty((n_batches, batch, num_dense), dtype=torch.float32,
                          pin_memory=pin),
        sparse=torch.empty((n_batches, batch, sum(hot)), dtype=torch.int32,
                           pin_memory=pin),
        labels=torch.empty((n_batches, batch), dtype=torch.float32,
                           pin_memory=pin),
        hot=hot)
    for lo in range(0, n_batches, chunk):
        k = min(chunk, n_batches - lo)
        part = draw(traffic, table_sizes, num_dense, seed, k, batch, device,
                    first=lo, n_hot=n_hot)
        for key in ("dense", "sparse", "labels"):
            getattr(pool, key)[lo:lo + k].copy_(part[key], non_blocking=pin)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    pool.seconds = time.perf_counter() - t0
    return pool
