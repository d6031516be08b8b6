"""dlrm_tpu_torch.config against dlrm_tpu.config: derived sizes of every
preset, the interaction auto rule, and the validation."""

import dataclasses

import jax.numpy as jnp
import pytest
import torch

from dlrm_tpu import config as jc
from dlrm_tpu_torch import config as tc

PRESETS = {
    "fixture": lambda m: m.fixture_config(),
    "multi_fixture": lambda m: m.multi_fixture_config(),
    "kaggle16": lambda m: m.kaggle_config(16),
    "kaggle128": lambda m: m.kaggle_config(feature_size=128),
    "kaggle128_pad128": lambda m: m.kaggle_config(128, interaction_pad_to=128),
    "terabyte": lambda m: m.terabyte_config(),
    "terabyte64": lambda m: m.terabyte_config(64),
    "tiny": lambda m: m.tiny_config(),
    "tiny_multihot": lambda m: m.tiny_config(num_tables=6, rows=50,
                                             feature_size=16, n_hot=3),
}

DERIVED = ("num_dense", "num_tables", "bottom_out", "pre_triangle",
           "num_pairs", "interaction_padding", "top_input",
           "full_top_mlp_sizes", "table_offsets", "total_rows",
           "bottom_mlp_sizes", "top_mlp_sizes", "feature_size",
           "table_sizes", "n_hot", "interaction_pad_to", "seed",
           "small_table_threshold")


@pytest.mark.parametrize("preset", list(PRESETS))
def test_derived_sizes_match(preset):
    j = PRESETS[preset](jc)
    t = PRESETS[preset](tc)
    for name in DERIVED:
        assert getattr(t, name) == getattr(j, name), name


@pytest.mark.parametrize("preset", list(PRESETS))
def test_dtypes_and_impl_defaults_match(preset):
    j = PRESETS[preset](jc)
    t = PRESETS[preset](tc)
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
    for name in ("weight_dtype", "embedding_dtype", "compute_dtype"):
        assert jnp.dtype(jdt[getattr(t, name)]) == jnp.dtype(getattr(j, name))
    assert t.interaction_impl == j.interaction_impl == "gram"


@pytest.mark.parametrize("fs", [4, 8, 16, 32, 64, 128, 256])
def test_auto_interaction_rule_matches(fs):
    renamed = {"pallas": "fused"}
    want = jc.auto_interaction_impl(fs)
    assert tc.auto_interaction_impl(fs) == renamed.get(want, want)


def test_table_constants_match():
    assert tc.KAGGLE_TABLE_SIZES == jc.KAGGLE_TABLE_SIZES
    assert tc.TERABYTE_TABLE_SIZES == jc.TERABYTE_TABLE_SIZES
    assert tc.NUM_DENSE_FEATURES == jc.NUM_DENSE_FEATURES
    assert tc.NUM_SPARSE_FEATURES == jc.NUM_SPARSE_FEATURES


def test_validation():
    bad = dict(bottom_mlp_sizes=(13, 16, 6), top_mlp_sizes=(8, 1),
               feature_size=8, table_sizes=(10,) * 4)
    with pytest.raises(ValueError):
        jc.DLRMConfig(**bad)
    with pytest.raises(ValueError):
        tc.DLRMConfig(**bad)
    with pytest.raises(ValueError, match="fused"):
        dataclasses.replace(tc.tiny_config(), interaction_impl="pallas")
