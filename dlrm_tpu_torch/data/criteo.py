"""Criteo DAC preprocessing and the binary format's batch loader: the
counterpart of ``dlrm_tpu/data/criteo.py``.

A record is a little-endian packed 160-byte struct: int32 label, 13 float32
log-transformed dense features, 26 uint32 categorical ids, 1-based in the
file.  ``binarize`` parses tab-separated text (plain or ``.gz``): dense
fields as base-10 ints (empty -> 0) through ``log(max(x, 0) + 1)``,
categorical fields as base-16 (empty -> 0).  ``process`` builds the
per-column vocabulary in first-appearance order and rewrites the ids to
dense 1-based ones in the file.  The files this module writes are
byte-identical to the JAX package's for the same text, with or without the
native library (``data/native.py``), which does the parsing, the vocabulary
and the marshal when it builds; ``use_native=False`` forces numpy.

Files are memory-mapped; ``DACLoader`` marshals batches and shifts the ids
to 0-based, in file order or in the JAX loader's epoch shuffles (the same
batches for the same seed and epoch).
"""

from __future__ import annotations

import gzip
from typing import Dict, Iterable, Iterator, List, Optional, Sequence

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


def log_transform(x: np.ndarray) -> np.ndarray:
    """log(max(x, 0) + 1), computed in float64 and rounded once to float32,
    so the numpy and C++ parsers give the same bits."""
    return np.log1p(np.maximum(x.astype(np.float64), 0.0)).astype(np.float32)


def parse_lines(lines: Iterable[str]) -> np.ndarray:
    """Parse Criteo text lines into a DAC_DTYPE record array (numpy path)."""
    rows = []
    for line in lines:
        line = line.rstrip("\n")
        if not line:
            continue
        f = line.split("\t")
        if len(f) != 1 + NUM_DENSE + NUM_SPARSE:
            raise ValueError(
                f"expected {1 + NUM_DENSE + NUM_SPARSE} tab-separated "
                f"fields, got {len(f)}")
        label = int(f[0])
        dense = [int(v) if v else 0 for v in f[1:1 + NUM_DENSE]]
        cat = [int(v, 16) if v else 0 for v in f[1 + NUM_DENSE:]]
        rows.append((label, dense, cat))
    out = np.zeros(len(rows), dtype=DAC_DTYPE)
    if rows:
        out["label"] = [r[0] for r in rows]
        out["dense"] = log_transform(np.asarray([r[1] for r in rows],
                                                dtype=np.int64))
        out["cat"] = np.asarray([r[2] for r in rows], dtype=np.uint32)
    return out


def _native_parse_stream(fobj, chunk_bytes: int = 256 << 20
                         ) -> List[np.ndarray]:
    """Stream a (possibly gzip-wrapped) binary file object through the C++
    parser in text chunks cut at line ends: the peak memory is about one
    chunk and its records, never the whole decompressed file."""
    from dlrm_tpu_torch.data import native

    chunks: List[np.ndarray] = []
    buf = b""
    while True:
        block = fobj.read(chunk_bytes)
        if not block:
            break
        buf += block
        cut = buf.rfind(b"\n")
        if cut < 0:
            continue
        chunks.append(native.parse_buffer(buf[:cut + 1]))
        buf = buf[cut + 1:]
    if buf.strip():
        chunks.append(native.parse_buffer(buf))
    return chunks


def _use_native(use_native: Optional[bool]) -> bool:
    from dlrm_tpu_torch.data import native

    return use_native is not False and native.available()


def binarize(src: str, dst: Optional[str] = None,
             chunk_lines: int = 1 << 18,
             use_native: Optional[bool] = None) -> np.ndarray:
    """Text (optionally .gz) -> binary records; returns the record array,
    memory-mapped onto ``dst`` when it is given.  The C++ parser streams
    the file when the native library is available, unless ``use_native``
    is False."""
    gz = src.endswith(".gz")
    if _use_native(use_native):
        with (gzip.open(src, "rb") if gz else open(src, "rb")) as f:
            chunks = _native_parse_stream(f)
    else:
        chunks = []
        with (gzip.open(src, "rt") if gz else open(src, "r")) as f:
            batch: List[str] = []
            for line in f:
                batch.append(line)
                if len(batch) >= chunk_lines:
                    chunks.append(parse_lines(batch))
                    batch = []
            if batch:
                chunks.append(parse_lines(batch))
    data = (np.concatenate(chunks) if chunks
            else np.zeros(0, dtype=DAC_DTYPE))
    if dst is not None:
        mm = np.memmap(dst, dtype=DAC_DTYPE, mode="w+", shape=(len(data),))
        mm[:] = data
        mm.flush()
        return mm
    return data


def load(path: str, writable: bool = False) -> np.ndarray:
    """Memory-map a binarized dataset."""
    return np.memmap(path, dtype=DAC_DTYPE, mode="r+" if writable else "r")


class Vocabulary:
    """Per-column value -> dense-id maps in first-appearance order.

    Column j sends raw uint32 values to ids 1..N_j (1-based in the file;
    the loader shifts to 0-based).  Each column keeps (sorted values, rank)
    so that a remap is a ``searchsorted``.
    """

    def __init__(self):
        self.sorted_values: List[np.ndarray] = [
            np.zeros(0, np.uint32) for _ in range(NUM_SPARSE)]
        self.ranks: List[np.ndarray] = [
            np.zeros(0, np.uint32) for _ in range(NUM_SPARSE)]

    @property
    def sizes(self) -> List[int]:
        return [len(v) for v in self.sorted_values]

    def update(self, data: np.ndarray) -> "Vocabulary":
        """Fold one shard's values in, keeping first-appearance order
        across shards (a serial merge, for determinism)."""
        cat = np.asarray(data["cat"])
        for j in range(NUM_SPARSE):
            uniq, first_idx = np.unique(cat[:, j], return_index=True)
            appear = uniq[np.argsort(first_idx, kind="stable")]
            known = self.sorted_values[j]
            fresh = appear[~_is_member(appear, known)] if len(known) \
                else appear
            if len(fresh):
                n0 = len(known)
                merged = np.concatenate([known, fresh])
                merged_ranks = np.concatenate([
                    self.ranks[j],
                    np.arange(n0, n0 + len(fresh), dtype=np.uint32)])
                srt = np.argsort(merged, kind="stable")
                self.sorted_values[j] = merged[srt]
                self.ranks[j] = merged_ranks[srt]
        return self

    def remap_column(self, j: int, values: np.ndarray) -> np.ndarray:
        """values -> 1-based dense ids."""
        pos = np.searchsorted(self.sorted_values[j], values)
        if np.any(pos >= len(self.sorted_values[j])) or np.any(
                self.sorted_values[j][pos] != values):
            raise KeyError(f"column {j}: value not in vocabulary")
        return (self.ranks[j][pos] + 1).astype(np.uint32)

    def save(self, path: str) -> None:
        np.savez(path, **{
            f"v{j}": self.sorted_values[j] for j in range(NUM_SPARSE)
        }, **{f"r{j}": self.ranks[j] for j in range(NUM_SPARSE)})

    @classmethod
    def load(cls, path: str) -> "Vocabulary":
        z = np.load(path)
        v = cls()
        v.sorted_values = [z[f"v{j}"] for j in range(NUM_SPARSE)]
        v.ranks = [z[f"r{j}"] for j in range(NUM_SPARSE)]
        return v

    @classmethod
    def from_appearance(cls, appear: Sequence[np.ndarray]) -> "Vocabulary":
        """From per-column values in first-appearance order (what
        ``native.build_vocab_and_reindex`` returns)."""
        v = cls()
        for j, a in enumerate(appear):
            a = np.asarray(a, np.uint32)
            srt = np.argsort(a, kind="stable")
            v.sorted_values[j] = a[srt]
            v.ranks[j] = srt.astype(np.uint32)
        return v


def _is_member(a: np.ndarray, sorted_b: np.ndarray) -> np.ndarray:
    pos = np.minimum(np.searchsorted(sorted_b, a), len(sorted_b) - 1)
    return sorted_b[pos] == a


def build_vocabulary(shards: Sequence[np.ndarray]) -> Vocabulary:
    """A serial fold over the shards (deterministic)."""
    vocab = Vocabulary()
    for data in shards:
        vocab.update(data)
    return vocab


def reindex(data: np.ndarray, vocab: Vocabulary) -> None:
    """Rewrite the categorical columns in place to dense 1-based ids."""
    cat = data["cat"]
    for j in range(NUM_SPARSE):
        cat[:, j] = vocab.remap_column(j, np.asarray(cat[:, j]))
    data["cat"] = cat  # write-back for memmap structured views


def process(paths, binpath: Optional[str] = None,
            vocab_path: Optional[str] = None,
            use_native: Optional[bool] = None) -> np.ndarray:
    """The whole pipeline: binarize every shard into one record array
    (memory-mapped onto ``binpath`` when given), build the vocabulary in
    first-appearance order over the concatenation, reindex in place, and
    save the vocabulary to ``vocab_path``.

    The C++ engine builds the vocabulary and reindexes in one pass (the
    same result as the numpy per-shard fold); ``use_native=False`` forces
    numpy throughout.
    """
    from dlrm_tpu_torch.data import native

    if isinstance(paths, str):
        paths = [paths]
    shards = [binarize(p, use_native=use_native) for p in paths]
    data = (np.concatenate([np.asarray(s) for s in shards])
            if len(shards) > 1 else np.asarray(shards[0]))
    if binpath is not None:
        mm = np.memmap(binpath, dtype=DAC_DTYPE, mode="w+",
                       shape=(len(data),))
        mm[:] = data
        data = mm
    if (_use_native(use_native) and data.flags["C_CONTIGUOUS"]
            and data.flags["WRITEABLE"]):
        vocab = Vocabulary.from_appearance(
            native.build_vocab_and_reindex(data, reindex=True))
    else:
        vocab = build_vocabulary(shards)
        reindex(data, vocab)
    if isinstance(data, np.memmap):
        data.flush()
    if vocab_path is not None:
        vocab.save(vocab_path)
    return data


def validate_ids(data: np.ndarray, table_sizes: Sequence[int], *,
                 chunk: int = 1 << 20, one_based: bool = True) -> None:
    """Check every categorical id against its table size, in chunks of
    ``chunk`` records (a file of any size streams through).

    The lookup has no bound check of its own: an id past its table's rows
    reads (and trains) a row of the next table.  This scan is the guard for
    a dataset that does not match the config (``--validate-data``).
    """
    sizes = np.asarray(table_sizes, np.int64)
    if sizes.shape[0] != NUM_SPARSE:
        raise ValueError(f"expected {NUM_SPARSE} table sizes, got "
                         f"{sizes.shape[0]}")
    lo = 1 if one_based else 0
    for start in range(0, len(data), chunk):
        cat = data["cat"][start:start + chunk].astype(np.int64)
        bad = (cat < lo) | (cat >= sizes[None, :] + lo)
        if bad.any():
            i, j = map(int, np.argwhere(bad)[0])
            raise ValueError(
                f"record {start + i}, column {j}: id {int(cat[i, j])} "
                f"outside [{lo}, {int(sizes[j]) + lo}) — the dataset does "
                "not match this config's table sizes (wrong --table-sizes/"
                "--config, or the file was never vocab-reindexed)")


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

    ``local_rows=(lo, hi)`` keeps only rows ``[lo, hi)`` of every batch (a
    process's stripe of a global batch; the order stays global), and needs
    full batches.  Batches are marshalled by the native library when it is
    available and the dataset is one contiguous record array, unless
    ``use_native`` is False; both give the same arrays.
    """

    def __init__(self, dataset: np.ndarray, batch_size: int, *,
                 drop_remainder: bool = True, zero_based_file: bool = False,
                 shuffle: bool = False, shuffle_rows: bool = False,
                 shuffle_window: int = 8, seed: int = 0,
                 use_native: Optional[bool] = None,
                 local_rows: Optional[tuple] = None):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.drop_remainder = drop_remainder
        self.shuffle = shuffle
        self.shuffle_rows = shuffle_rows
        self.shuffle_window = max(int(shuffle_window), 1)
        self.seed = seed
        self._epoch = 0
        self._shift = 0 if zero_based_file else 1
        self.use_native = use_native
        if local_rows is not None:
            lo, hi = local_rows
            if not (0 <= lo < hi <= self.batch_size):
                raise ValueError(f"local_rows {local_rows} outside batch "
                                 f"size {self.batch_size}")
            if not drop_remainder and len(dataset) % self.batch_size:
                raise ValueError("local_rows needs drop_remainder=True "
                                 "(a ragged tail batch has no well-defined "
                                 "per-process stripe)")
        self.local_rows = local_rows

    def __len__(self) -> int:
        n = len(self.dataset) // self.batch_size
        if not self.drop_remainder and len(self.dataset) % self.batch_size:
            n += 1
        return n

    def _native(self) -> bool:
        d = self.dataset
        return (d.dtype == DAC_DTYPE and d.flags["C_CONTIGUOUS"]
                and _use_native(self.use_native))

    def _marshal(self, start: int, count: int) -> Dict[str, np.ndarray]:
        if self._native():
            from dlrm_tpu_torch.data import native

            return native.marshal_batch(self.dataset, start, count,
                                        self._shift)
        window = self.dataset[start:start + count]
        return {
            "labels": window["label"].astype(np.float32),
            "dense": np.ascontiguousarray(window["dense"]),
            "sparse": (window["cat"].astype(np.int64)
                       - self._shift).astype(np.int32),
        }

    def _stripe(self, i: int) -> Dict[str, np.ndarray]:
        """Batch ``i`` in file order, cut to ``local_rows``."""
        b = self.batch_size
        count = min(b, len(self.dataset) - i * b)
        lo, hi = self.local_rows if self.local_rows is not None else (0, b)
        return self._marshal(i * b + min(lo, count),
                             min(hi, count) - min(lo, count))

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        """Batch ``i`` in file order (negative indices count from the end)."""
        n = len(self)
        if i < 0:
            i += n
        if not 0 <= i < n:
            raise IndexError(f"batch index {i} out of range for {n} batches")
        return self._stripe(i)

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
                if self.local_rows is not None:
                    rows = rows[self.local_rows[0]:self.local_rows[1]]
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
            yield self._stripe(int(i))
