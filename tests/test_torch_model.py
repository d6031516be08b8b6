"""dlrm_tpu_torch.forward against dlrm_tpu.forward, with JAX-initialised
weights carried across by dlrm_tpu_torch.io.convert, and a distribution
check of dlrm_tpu_torch.init_params.

Also home of the JAX <-> torch config and parameter helpers that the other
test_torch_* files import.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dlrm_tpu
from dlrm_tpu import config as jc
from dlrm_tpu.ops.embedding import unpack_tables
import dlrm_tpu_torch
from dlrm_tpu_torch import config as tc
from dlrm_tpu_torch.io.convert import params_from_numpy
from dlrm_tpu_torch.ops.mlp import mlp_apply

_JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
_JIMPL = {"fused": "pallas"}


def jax_config(t: tc.DLRMConfig) -> jc.DLRMConfig:
    """The JAX package's config for a port config (default packed
    storage)."""
    return jc.DLRMConfig(
        bottom_mlp_sizes=t.bottom_mlp_sizes, top_mlp_sizes=t.top_mlp_sizes,
        feature_size=t.feature_size, table_sizes=t.table_sizes,
        n_hot=t.n_hot, interaction_pad_to=t.interaction_pad_to,
        weight_dtype=_JDT[t.weight_dtype],
        embedding_dtype=_JDT[t.embedding_dtype],
        compute_dtype=_JDT[t.compute_dtype],
        interaction_impl=_JIMPL.get(t.interaction_impl, t.interaction_impl),
        small_table_threshold=t.small_table_threshold)


def jax_params_to_numpy(params, jcfg) -> dict:
    """JAX params (any storage) -> numpy pytree with the logical stack."""
    def mlp(layers):
        return [{k: np.asarray(layer[k]) for k in ("w", "b")}
                for layer in layers]

    return {"bottom": mlp(params["bottom"]),
            "emb": np.asarray(unpack_tables(params["emb"], jcfg)),
            "top": mlp(params["top"])}


def kaggle_narrow(**kw) -> tc.DLRMConfig:
    """26 tables with Kaggle's sizes clipped to 2000 rows (small and big
    around a threshold of 100), F = 27, narrow MLPs."""
    return tc.DLRMConfig(
        bottom_mlp_sizes=(13, 32, 16), top_mlp_sizes=(64, 32, 1),
        feature_size=16,
        table_sizes=tuple(min(s, 2000) for s in tc.KAGGLE_TABLE_SIZES),
        small_table_threshold=100, **kw)


CONFIGS = {
    "tiny": lambda **kw: dataclasses.replace(tc.tiny_config(), **kw),
    "fixture": lambda **kw: dataclasses.replace(tc.fixture_config(), **kw),
    "kaggle_narrow": kaggle_narrow,
}


def _run_both(tcfg, rng, batch=24):
    jcfg = jax_config(tcfg)
    jparams = dlrm_tpu.init_params(jax.random.key(7), jcfg)
    params = params_from_numpy(jax_params_to_numpy(jparams, jcfg), tcfg)
    dense = rng.normal(size=(batch, tcfg.num_dense)).astype(np.float32)
    shape = (batch,) if tcfg.n_hot == 1 else (batch, tcfg.n_hot)
    sparse = np.stack([rng.integers(0, s, size=shape)
                       for s in tcfg.table_sizes], axis=1).astype(np.int32)
    want = np.asarray(dlrm_tpu.forward(jparams, jnp.asarray(dense),
                                       jnp.asarray(sparse), jcfg))
    got = dlrm_tpu_torch.forward(params, torch.from_numpy(dense),
                                 torch.from_numpy(sparse), tcfg)
    assert got.shape == (batch,) and got.dtype == torch.float32
    return got.numpy(), want


@pytest.mark.parametrize("impl", ["gram", "pairwise", "fused"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_f32_matches_jax(name, impl, rng):
    """f32: atol 1e-6 on the scores (sums in another order only)."""
    got, want = _run_both(CONFIGS[name](interaction_impl=impl), rng)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("impl", ["gram", "pairwise", "fused"])
def test_forward_bf16_matches_jax(impl, rng):
    """--bf16 (compute in bf16, f32 accumulation, bias added in f32):
    the two packages round at the same places and agree to ~1e-7 here,
    but an f32 sum taken in another order can round to the neighbouring
    bf16 value (2^-8 relative) in a hidden unit and carry on through the
    layers, so the scores are held to atol 1e-3."""
    tcfg = kaggle_narrow(interaction_impl=impl,
                         compute_dtype=torch.bfloat16, n_hot=2)
    got, want = _run_both(tcfg, rng)
    np.testing.assert_allclose(got, want, atol=1e-3)


def test_mlp_bf16_adds_bias_before_rounding(rng):
    """The trap of a bf16 torch.matmul: it rounds before the bias add.
    mlp_apply must round only after it, as the JAX package does."""
    from dlrm_tpu.ops.mlp import mlp_apply as jmlp
    x = rng.normal(size=(32, 24)).astype(np.float32)
    layers = [{"w": rng.normal(size=(24, 16)).astype(np.float32),
               "b": rng.normal(size=(16,)).astype(np.float32)},
              {"w": rng.normal(size=(16, 1)).astype(np.float32),
               "b": rng.normal(size=(1,)).astype(np.float32)}]
    want = np.asarray(jmlp(jax.tree.map(jnp.asarray, layers), jnp.asarray(x),
                           final="sigmoid", compute_dtype=jnp.bfloat16))
    tl = [{k: torch.from_numpy(v) for k, v in layer.items()}
          for layer in layers]
    got = mlp_apply(tl, torch.from_numpy(x), final="sigmoid",
                    compute_dtype=torch.bfloat16)
    assert got.dtype == torch.float32  # the last layer is not cast back
    np.testing.assert_allclose(got.numpy(), want, atol=1e-2)


def test_init_params_distribution():
    cfg = tc.DLRMConfig(bottom_mlp_sizes=(13, 256, 64),
                        top_mlp_sizes=(128, 1), feature_size=64,
                        table_sizes=(50, 4000, 20000))
    p = dlrm_tpu_torch.init_params(torch.Generator().manual_seed(3), cfg)
    assert p["emb"].shape == (cfg.total_rows, 64)
    assert p["emb"].dtype == torch.float32
    for t, n in enumerate(cfg.table_sizes):
        tab = p["emb"][cfg.table_offsets[t]:cfg.table_offsets[t] + n]
        bound = n ** -0.5
        assert tab.abs().max() <= bound
        # U(-a, a): mean 0, variance a^2/3
        assert abs(tab.mean().item()) < 0.05 * bound
        assert tab.var().item() == pytest.approx(bound ** 2 / 3, rel=0.05)
    for layer, (fi, fo) in zip(p["bottom"] + p["top"],
                               [(13, 256), (256, 64), (cfg.top_input, 128),
                                (128, 1)]):
        assert layer["w"].shape == (fi, fo)
        assert torch.count_nonzero(layer["b"]) == 0
        if fi * fo >= 4096:
            std = (2.0 / (fi + fo)) ** 0.5
            assert layer["w"].std().item() == pytest.approx(std, rel=0.05)


def test_init_params_bf16_tables_and_zeros():
    cfg = dataclasses.replace(tc.tiny_config(),
                              embedding_dtype=torch.bfloat16)
    p = dlrm_tpu_torch.init_params(torch.Generator().manual_seed(0), cfg)
    assert p["emb"].dtype == torch.bfloat16
    assert p["emb"].float().abs().max() <= cfg.table_sizes[0] ** -0.5
    z = dlrm_tpu_torch.init_params(torch.Generator().manual_seed(0), cfg,
                                   emb_init="zeros")
    assert torch.count_nonzero(z["emb"]) == 0


def test_forward_rejects_wrong_table_stack():
    cfg = tc.tiny_config()
    p = dlrm_tpu_torch.init_params(torch.Generator().manual_seed(0), cfg)
    p["emb"] = p["emb"][:-1]
    with pytest.raises(ValueError, match="emb"):
        dlrm_tpu_torch.forward(p, torch.zeros(2, 13),
                               torch.zeros(2, 4, dtype=torch.int32), cfg)
