"""Criteo DAC binary format and batch loader: the loading subset of
``dlrm_tpu/data/criteo.py``.

A record is a little-endian packed 160-byte struct: int32 label, 13 float32
log-transformed dense features, 26 uint32 categorical ids, 1-based in the
file.  Files are memory-mapped; ``DACLoader`` marshals batches with numpy
and shifts the ids to 0-based.
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np

NUM_DENSE = 13
NUM_SPARSE = 26

DAC_DTYPE = np.dtype([
    ("label", "<i4"),
    ("dense", "<f4", (NUM_DENSE,)),
    ("cat", "<u4", (NUM_SPARSE,)),
])
if DAC_DTYPE.itemsize != 160:
    raise ImportError(f"DAC_DTYPE is {DAC_DTYPE.itemsize} bytes, not 160")


def load(path: str, writable: bool = False) -> np.ndarray:
    """Memory-map a binarized dataset."""
    return np.memmap(path, dtype=DAC_DTYPE, mode="r+" if writable else "r")


class DACLoader:
    """Batched iterator over a binarized dataset, in file order.

    Yields dicts of numpy arrays: labels (B,) f32, dense (B,13) f32,
    sparse (B,26) int32, 0-based.  With ``drop_remainder=False`` the last,
    shorter batch is kept.
    """

    def __init__(self, dataset: np.ndarray, batch_size: int, *,
                 drop_remainder: bool = True, zero_based_file: bool = False):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.drop_remainder = drop_remainder
        self._shift = 0 if zero_based_file else 1

    def __len__(self) -> int:
        n = len(self.dataset) // self.batch_size
        if not self.drop_remainder and len(self.dataset) % self.batch_size:
            n += 1
        return n

    def _marshal(self, start: int, count: int) -> Dict[str, np.ndarray]:
        window = self.dataset[start:start + count]
        return {
            "labels": window["label"].astype(np.float32),
            "dense": np.ascontiguousarray(window["dense"]),
            "sparse": (window["cat"].astype(np.int64)
                       - self._shift).astype(np.int32),
        }

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        """Batch ``i`` in file order (negative indices count from the end)."""
        n = len(self)
        if i < 0:
            i += n
        if not 0 <= i < n:
            raise IndexError(f"batch index {i} out of range for {n} batches")
        b = self.batch_size
        return self._marshal(i * b, min(b, len(self.dataset) - i * b))

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        for i in range(len(self)):
            yield self[i]
