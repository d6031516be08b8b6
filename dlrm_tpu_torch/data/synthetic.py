"""Random batches from a numpy seed: the batch subset of
``dlrm_tpu/data/synthetic.py``.  The same seed gives the same batches as
the JAX package."""

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
