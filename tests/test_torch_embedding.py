"""dlrm_tpu_torch.ops.embedding against dlrm_tpu.ops.embedding: the
port's plain gather on the logical stack against the JAX package's
mixed_lookup on its default packed storage (gather for big tables, one-hot
matmul for small ones).

Tolerances: one-hot lookups are exact; multi-hot pools sum H rows in
another order than the one-hot matmul, atol 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dlrm_tpu
from dlrm_tpu.ops import embedding as jemb
from dlrm_tpu_torch import config as tc
from dlrm_tpu_torch.io.convert import params_from_numpy
from dlrm_tpu_torch.ops import embedding as temb
from test_torch_model import jax_config, jax_params_to_numpy

CASES = {
    # name: (table_sizes, n_hot, small_table_threshold)
    "onehot_small": ((40, 50, 60, 70), 1, 8192),
    "onehot_big": ((40, 50, 60, 70), 1, 0),
    "multihot_small": ((40, 50, 60, 70), 3, 8192),
    "multihot_big": ((40, 50, 60, 70), 3, 0),
    "nhot_eq_tables": ((40, 50, 60, 70), 4, 0),
    "mixed_onehot": ((30, 64, 65, 200), 1, 64),
    "mixed_multihot": ((30, 64, 65, 200), 2, 64),
}


def _lookup_both(name, rng, compute_dtype=torch.float32, batch=16):
    sizes, n_hot, thr = CASES[name]
    tcfg = dataclasses.replace(
        tc.tiny_config(num_tables=len(sizes), feature_size=16),
        table_sizes=sizes, n_hot=n_hot, small_table_threshold=thr,
        compute_dtype=compute_dtype)
    jcfg = jax_config(tcfg)
    jparams = dlrm_tpu.init_params(jax.random.key(1), jcfg)
    emb = params_from_numpy(jax_params_to_numpy(jparams, jcfg), tcfg)["emb"]
    shape = (batch,) if n_hot == 1 else (batch, n_hot)
    ids = np.stack([rng.integers(0, s, size=shape) for s in sizes],
                   axis=1).astype(np.int32)
    want = np.asarray(jemb.mixed_lookup(jparams["emb"], jnp.asarray(ids),
                                        jcfg))
    got = temb.mixed_lookup(emb, torch.from_numpy(ids), tcfg)
    assert got.shape == want.shape == (batch, len(sizes), 16)
    return got.numpy(), want, n_hot


@pytest.mark.parametrize("name", list(CASES))
def test_mixed_lookup_matches_jax(name, rng):
    got, want, n_hot = _lookup_both(name, rng)
    if n_hot == 1:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("name", ["onehot_small", "mixed_onehot",
                                  "mixed_multihot"])
def test_mixed_lookup_bf16_rounds_small_tables(name, rng):
    """Under compute_dtype=bf16 the JAX one-hot path rounds small-table
    rows to bf16 before pooling; the port must too (and leave big tables
    unrounded)."""
    got, want, n_hot = _lookup_both(name, rng, torch.bfloat16)
    if n_hot == 1:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    sizes, _, thr = CASES[name]
    small = [t for t, s in enumerate(sizes) if s <= thr]
    rounded = got[:, small].astype(jnp.bfloat16).astype(np.float32)
    if n_hot == 1:
        np.testing.assert_array_equal(got[:, small], rounded)


def test_translate_ids_by_rank_not_length():
    """n_hot == num_tables: the offsets go along the TABLE axis."""
    offs = (0, 10, 20)
    ids = torch.arange(18, dtype=torch.int32).reshape(2, 3, 3) % 5
    want = np.asarray(jemb.translate_ids(jnp.asarray(ids.numpy()), offs))
    got = temb.translate_ids(ids, offs)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[:, 1] - ids[:, 1] == 10).all()
    ids2 = torch.tensor([[1, 2, 3]], dtype=torch.int32)
    np.testing.assert_array_equal(
        temb.translate_ids(ids2, offs).numpy(),
        np.asarray(jemb.translate_ids(jnp.asarray(ids2.numpy()), offs)))
    with pytest.raises(ValueError, match="3 tables"):
        temb.translate_ids(torch.zeros((2, 4), dtype=torch.int32), offs)


def test_lookup_and_tables_match_jax(rng):
    emb = rng.normal(size=(150, 8)).astype(np.float32)
    offs = (0, 40, 90)
    ids = np.stack([rng.integers(0, n, size=(6, 2)) for n in (40, 50, 60)],
                   axis=1).astype(np.int32)
    want = np.asarray(jemb.lookup(jnp.asarray(emb), jnp.asarray(ids), offs))
    got = temb.lookup(torch.from_numpy(emb), torch.from_numpy(ids), offs)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    assert temb.partition_tables((5, 100, 7, 8), 7) == \
        jemb.partition_tables((5, 100, 7, 8), 7)
    cfg = dataclasses.replace(tc.tiny_config(num_tables=3, feature_size=8),
                              table_sizes=(40, 50, 60))
    np.testing.assert_array_equal(
        temb.get_logical_table(torch.from_numpy(emb), cfg, 1).numpy(),
        emb[40:90])
