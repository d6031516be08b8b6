"""Random batches from a numpy seed: the batch generators of
``dlrm_tpu/data/synthetic.py`` (uniform ids, and the Zipf-skewed
``ClickthroughModel``).  The same seed gives the same batches as the JAX
package."""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np

from dlrm_tpu_torch.config import DLRMConfig


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


def batch_stream(config: DLRMConfig, batch: int, steps: Optional[int] = None,
                 seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    rng = np.random.default_rng(seed)
    i = 0
    while steps is None or i < steps:
        yield random_batch(rng, config, batch)
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

    def stream(self, batch: int, steps: Optional[int] = None, seed: int = 1
               ) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.default_rng(seed)
        i = 0
        while steps is None or i < steps:
            yield self.batch(rng, batch)
            i += 1
