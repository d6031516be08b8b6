"""Synthetic data from a numpy seed: the counterpart of
``dlrm_tpu/data/synthetic.py``.  Criteo-format text lines (with missing
fields), uniform random batches, and the Zipf-skewed ``ClickthroughModel``.
The same seed gives the same lines and batches as the JAX package."""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np

from dlrm_tpu_torch.config import DLRMConfig
from dlrm_tpu_torch.data.criteo import NUM_DENSE, NUM_SPARSE


def criteo_text_lines(n: int, seed: int = 0, missing_prob: float = 0.1,
                      vocab: int = 1000) -> list:
    """``n`` Criteo-format text lines: a 0/1 label, 13 base-10 ints in
    [-5, 10000) and 26 base-16 ids in [0, vocab), each field empty with
    probability ``missing_prob``."""
    rng = np.random.default_rng(seed)
    lines = []
    for _ in range(n):
        fields = [str(int(rng.integers(0, 2)))]
        for _ in range(NUM_DENSE):
            if rng.random() < missing_prob:
                fields.append("")
            else:
                fields.append(str(int(rng.integers(-5, 10000))))
        for _ in range(NUM_SPARSE):
            if rng.random() < missing_prob:
                fields.append("")
            else:
                fields.append(format(int(rng.integers(0, vocab)), "x"))
        lines.append("\t".join(fields) + "\n")
    return lines


def random_batch(rng: np.random.Generator, config: DLRMConfig, batch: int,
                 ) -> Dict[str, np.ndarray]:
    """One random batch for the given model config."""
    dense = rng.normal(size=(batch, config.num_dense)).astype(np.float32)
    if config.n_hot == 1:
        sparse = np.stack([rng.integers(0, s, size=batch)
                           for s in config.table_sizes], axis=1)
    else:
        sparse = np.stack([rng.integers(0, s, size=(batch, config.n_hot))
                           for s in config.table_sizes], axis=1)
    labels = (rng.random(batch) > 0.5).astype(np.float32)
    return {"dense": dense, "sparse": sparse.astype(np.int32),
            "labels": labels}


def _slice_rows(batch: Dict[str, np.ndarray], rows) -> Dict[str, np.ndarray]:
    """Rows ``[lo, hi)`` of a batch (``rows=None``: all).  A process that
    feeds its stripe of a global batch draws the whole batch from the
    shared seed and keeps its rows, so the stripes make up the global
    stream exactly."""
    if rows is None:
        return batch
    lo, hi = rows
    return {k: v[lo:hi] for k, v in batch.items()}


def batch_stream(config: DLRMConfig, batch: int, steps: Optional[int] = None,
                 seed: int = 0, rows=None) -> Iterator[Dict[str, np.ndarray]]:
    rng = np.random.default_rng(seed)
    i = 0
    while steps is None or i < steps:
        yield _slice_rows(random_batch(rng, config, batch), rows)
        i += 1


class ClickthroughModel:
    """Learnable synthetic CTR ground truth with Zipf-skewed ids (the JAX
    package's ``ClickthroughModel``; the same seed gives the same batches).

    Per-table ids are drawn from Zipf(a), rank-permuted per table so the hot
    rows are scattered, so batches repeat ids as real Criteo traffic does.
    Labels are Bernoulli over a planted logit: a scalar affinity per table
    row plus a linear dense term, so a DLRM can learn them.
    """

    def __init__(self, config: DLRMConfig, seed: int = 0,
                 zipf_a: float = 1.2, noise: float = 0.5):
        self.config = config
        self.zipf_a = zipf_a
        self.noise = noise
        root = np.random.default_rng(seed)
        scale = 1.5 / np.sqrt(config.num_tables * max(config.n_hot, 1))
        self.row_affinity = [
            root.normal(0.0, scale, size=s).astype(np.float32)
            for s in config.table_sizes]
        self.perms = [root.permutation(s).astype(np.int64)
                      for s in config.table_sizes]
        self.dense_w = root.normal(0.0, 0.3, size=config.num_dense
                                   ).astype(np.float32)

    def _zipf_ids(self, rng, size, table: int):
        n = self.config.table_sizes[table]
        ranks = rng.zipf(self.zipf_a, size=size) - 1
        return self.perms[table][np.minimum(ranks, n - 1)].astype(np.int32)

    def batch(self, rng: np.random.Generator, batch: int
              ) -> Dict[str, np.ndarray]:
        c = self.config
        dense = rng.normal(size=(batch, c.num_dense)).astype(np.float32)
        shape = (batch,) if c.n_hot == 1 else (batch, c.n_hot)
        cols = [self._zipf_ids(rng, shape, t) for t in range(c.num_tables)]
        sparse = np.stack(cols, axis=1).astype(np.int32)
        logit = dense @ self.dense_w
        for t in range(c.num_tables):
            aff = self.row_affinity[t][cols[t]]
            logit = logit + (aff if c.n_hot == 1 else aff.sum(axis=1))
        logit = logit + rng.normal(0.0, self.noise, size=batch)
        labels = (rng.random(batch) < 1.0 / (1.0 + np.exp(-logit))
                  ).astype(np.float32)
        return {"dense": dense, "sparse": sparse, "labels": labels}

    def stream(self, batch: int, steps: Optional[int] = None, seed: int = 1,
               rows=None) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.default_rng(seed)
        i = 0
        while steps is None or i < steps:
            yield _slice_rows(self.batch(rng, batch), rows)
            i += 1
