"""Model configuration: the counterpart of ``dlrm_tpu/config.py``.

Only the model math is carried over (``pre_triangle``, ``num_pairs``, the
interaction padding, ``top_input``, table offsets).  The lane-pack and chunk
geometry of the JAX package exists for the TPU's tiled layouts and XLA's
TPU scatter; this package stores the tables as one logical
``(total_rows, D)`` tensor instead.
"""

from __future__ import annotations

import dataclasses
from functools import cached_property
from typing import Tuple

import torch

NUM_DENSE_FEATURES = 13
NUM_SPARSE_FEATURES = 26

# Criteo Kaggle DAC vocabulary sizes.
KAGGLE_TABLE_SIZES: Tuple[int, ...] = (
    1460, 583, 10131227, 2202608, 305, 24, 12517, 633, 3, 93145, 5683,
    8351593, 3194, 27, 14992, 5461306, 10, 5652, 2173, 4, 7046547, 18, 15,
    286181, 105, 142572,
)

# Criteo Terabyte vocabulary sizes.
TERABYTE_TABLE_SIZES: Tuple[int, ...] = (
    227605432, 39060, 17295, 7424, 20265, 3, 7122, 1543, 63, 130229467,
    3067956, 405282, 10, 2209, 11938, 155, 4, 976, 14, 292775614, 40790948,
    187188510, 590152, 12973, 108, 36,
)

INTERACTION_IMPLS = ("gram", "pairwise", "fused")


def _round_up(x: int, m: int) -> int:
    return m * ((x + m - 1) // m)


@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    """Static description of one DLRM topology.

    Attributes:
      bottom_mlp_sizes: bottom MLP widths *including* the input width,
        e.g. ``(13, 512, 256, 16)``; ReLU on every layer.
      top_mlp_sizes: top MLP widths *excluding* the (derived) input width;
        the last layer is linear + sigmoid, the others ReLU.
      feature_size: embedding dimension shared by all tables.
      table_sizes: rows per embedding table.
      n_hot: lookups per sample per table (sum-pooled when > 1).
      interaction_pad_to: pad the interaction output width up to a multiple
        of this with zeros; the top MLP input width includes the padding.
      weight_dtype / embedding_dtype: parameter storage dtypes.
      compute_dtype: dtype of the MLP and interaction math.
      interaction_impl: ``"gram"`` (batched matmul + triangular index),
        ``"pairwise"`` (only the P pair dots) or ``"fused"`` (the
        hand-written CUDA kernel of ``ops/interaction_fused.py``; the
        counterpart of the JAX package's ``"pallas"``).
      small_table_threshold: tables with at most this many rows are looked
        up as the JAX package's one-hot matmul path would: under a bf16
        ``compute_dtype`` their rows are rounded to bf16 before pooling.
      remat: recompute the dense tower (interaction and MLP activations)
        on backward instead of storing them (``torch.utils.checkpoint``);
        the same gradients, fewer stored activations.
    """

    bottom_mlp_sizes: Tuple[int, ...]
    top_mlp_sizes: Tuple[int, ...]
    feature_size: int
    table_sizes: Tuple[int, ...]
    n_hot: int = 1
    interaction_pad_to: int = 1
    remat: bool = False
    weight_dtype: torch.dtype = torch.float32
    embedding_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    seed: int = 51234
    interaction_impl: str = "gram"
    small_table_threshold: int = 8192

    def __post_init__(self):
        object.__setattr__(self, "bottom_mlp_sizes", tuple(self.bottom_mlp_sizes))
        object.__setattr__(self, "top_mlp_sizes", tuple(self.top_mlp_sizes))
        object.__setattr__(self, "table_sizes", tuple(self.table_sizes))
        if (self.feature_size * self.num_tables) % self.bottom_out != 0:
            raise ValueError(
                "feature_size * num_tables must be divisible by the bottom MLP "
                f"output width (got {self.feature_size} * {self.num_tables} "
                f"vs {self.bottom_out})")
        if self.interaction_impl not in INTERACTION_IMPLS:
            raise ValueError(
                f"interaction_impl {self.interaction_impl!r} is not one of "
                f"{INTERACTION_IMPLS}")

    # -- derived sizes ------------------------------------------------------
    @property
    def num_dense(self) -> int:
        return self.bottom_mlp_sizes[0]

    @property
    def num_tables(self) -> int:
        return len(self.table_sizes)

    @property
    def bottom_out(self) -> int:
        return self.bottom_mlp_sizes[-1]

    @property
    def pre_triangle(self) -> int:
        """Feature count entering the pairwise interaction."""
        return self.feature_size * self.num_tables // self.bottom_out + 1

    @property
    def num_pairs(self) -> int:
        p = self.pre_triangle
        return (p * p - p) // 2

    @property
    def interaction_padding(self) -> int:
        raw = self.num_pairs + self.bottom_out
        return _round_up(raw, self.interaction_pad_to) - raw

    @property
    def top_input(self) -> int:
        """Top-MLP input width, padding included."""
        return self.num_pairs + self.bottom_out + self.interaction_padding

    @property
    def full_top_mlp_sizes(self) -> Tuple[int, ...]:
        return (self.top_input,) + self.top_mlp_sizes

    @cached_property
    def table_offsets(self) -> Tuple[int, ...]:
        """Row offset of each table inside the stacked embedding tensor."""
        off, out = 0, []
        for n in self.table_sizes:
            out.append(off)
            off += n
        return tuple(out)

    @property
    def total_rows(self) -> int:
        return sum(self.table_sizes)


def auto_interaction_impl(feature_size: int) -> str:
    """Feature-size-keyed interaction implementation: ``"fused"`` at
    fs=128, ``"gram"`` elsewhere.

    Carried over from the JAX package's rule, which rests on a TPU
    measurement; it has not been measured on a GPU.  ``run.py`` applies it
    on CUDA when ``--interaction`` is not given.
    """
    return "fused" if feature_size == 128 else "gram"


# -- presets -----------------------------------------------------------------

def fixture_config() -> DLRMConfig:
    """Topology of the single-hot PyTorch reference fixture (7 tables of
    1000 x 16)."""
    return DLRMConfig(
        bottom_mlp_sizes=(13, 512, 256, 64, 16),
        top_mlp_sizes=(512, 256, 1),
        feature_size=16,
        table_sizes=(1000,) * 7,
    )


def multi_fixture_config() -> DLRMConfig:
    """Topology of the 10-hot PyTorch reference fixture."""
    return dataclasses.replace(fixture_config(), n_hot=10)


def kaggle_config(feature_size: int = 16, **kw) -> DLRMConfig:
    """Criteo Kaggle DLRM: bottom [13,512,256,fs], top [.,1024,1024,512,256,1],
    26 tables, ~33.8M rows in all."""
    return DLRMConfig(
        bottom_mlp_sizes=(13, 512, 256, feature_size),
        top_mlp_sizes=(1024, 1024, 512, 256, 1),
        feature_size=feature_size,
        table_sizes=KAGGLE_TABLE_SIZES,
        **kw,
    )


def terabyte_config(feature_size: int = 128, **kw) -> DLRMConfig:
    """Criteo Terabyte / MLPerf-scale DLRM."""
    return DLRMConfig(
        bottom_mlp_sizes=(13, 512, 256, feature_size),
        top_mlp_sizes=(1024, 1024, 512, 256, 1),
        feature_size=feature_size,
        table_sizes=TERABYTE_TABLE_SIZES,
        **kw,
    )


def tiny_config(num_tables: int = 4, rows: int = 32, feature_size: int = 8,
                n_hot: int = 1) -> DLRMConfig:
    """Small config for unit tests and smoke runs."""
    return DLRMConfig(
        bottom_mlp_sizes=(13, 16, feature_size),
        top_mlp_sizes=(16, 1),
        feature_size=feature_size,
        table_sizes=(rows,) * num_tables,
        n_hot=n_hot,
    )
