"""Criteo DAC binary format and batch loader: the loading subset of
``dlrm_tpu/data/criteo.py``.

A record is a little-endian packed 160-byte struct: int32 label, 13 float32
log-transformed dense features, 26 uint32 categorical ids, 1-based in the
file.  Files are memory-mapped; ``DACLoader`` marshals batches with numpy
and shifts the ids to 0-based, in file order or in the JAX loader's epoch
shuffles (the same batches for the same seed and epoch).
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
    """Batched iterator over a binarized dataset.

    Yields dicts of numpy arrays: labels (B,) f32, dense (B,13) f32,
    sparse (B,26) int32, 0-based.  With ``drop_remainder=False`` the last,
    shorter batch is kept.

    Iteration order, drawn anew each epoch from ``(seed, epoch)`` exactly as
    the JAX package's loader draws it:
      * default: file order;
      * ``shuffle``: the batches in a permuted order, each batch's rows
        still consecutive in the file;
      * ``shuffle_rows``: windows of ``shuffle_window`` consecutive batches
        in a permuted order, the rows permuted within each window.
    Indexing (``loader[i]``) is always in file order.
    """

    def __init__(self, dataset: np.ndarray, batch_size: int, *,
                 drop_remainder: bool = True, zero_based_file: bool = False,
                 shuffle: bool = False, shuffle_rows: bool = False,
                 shuffle_window: int = 8, seed: int = 0):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.drop_remainder = drop_remainder
        self.shuffle = shuffle
        self.shuffle_rows = shuffle_rows
        self.shuffle_window = max(int(shuffle_window), 1)
        self.seed = seed
        self._epoch = 0
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

    def _iter_shuffled_rows(self, epoch: int
                            ) -> Iterator[Dict[str, np.ndarray]]:
        """Windows of ``shuffle_window`` batches in a permuted order; each
        window's rows marshalled at once and permuted."""
        b, w = self.batch_size, self.shuffle_window
        n_batches = len(self)
        n_windows = -(-n_batches // w)
        order = np.random.default_rng((self.seed, 1, epoch)
                                      ).permutation(n_windows)
        for wi in (int(x) for x in order):
            first = wi * w
            n_here = min(n_batches - first, w)
            count = min(n_here * b, len(self.dataset) - first * b)
            window = self._marshal(first * b, count)
            perm = np.random.default_rng((self.seed, 2, epoch, wi)
                                         ).permutation(count)
            for k in range(n_here):
                rows = perm[k * b:min((k + 1) * b, count)]
                yield {key: v[rows] for key, v in window.items()}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        # the epoch advances when iteration starts, so a consumer that stops
        # mid-epoch and iterates again gets a fresh order
        epoch = self._epoch
        if self.shuffle_rows:
            self._epoch += 1
            yield from self._iter_shuffled_rows(epoch)
            return
        order = range(len(self))
        if self.shuffle:
            order = np.random.default_rng((self.seed, epoch)
                                          ).permutation(len(self))
            self._epoch += 1
        for i in order:
            yield self[int(i)]
