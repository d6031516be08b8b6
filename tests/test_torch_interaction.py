"""dlrm_tpu_torch.ops.interaction{,_fused} against dlrm_tpu.ops.interaction
{,_pallas}: the same numpy inputs through both packages.

The JAX fused path runs its Pallas kernel in interpret mode on the CPU; the
port's fused path takes its plain torch version for a CPU tensor.  f32
tolerance: atol/rtol 1e-5 (sums of D products in another order).
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from dlrm_tpu.ops import interaction as jint
from dlrm_tpu.ops import interaction_pallas as jpal
from dlrm_tpu_torch.ops import interaction as tint
from dlrm_tpu_torch.ops import interaction_fused as tfused

IMPLS = {
    "gram": (jint.dot_interaction, tint.dot_interaction),
    "pairwise": (jint.dot_interaction_pairwise, tint.dot_interaction_pairwise),
    "fused": (jpal.fused_dot_interaction, tfused.fused_dot_interaction),
}


def _both(impl, x, feats, pad_to):
    jfn, tfn = IMPLS[impl]
    want = np.asarray(jfn(jnp.asarray(x), jnp.asarray(feats), pad_to))
    got = tfn(torch.from_numpy(x), torch.from_numpy(feats), pad_to).numpy()
    return got, want


def _inputs(rng, b, t, fs, d=None):
    d = fs if d is None else d
    x = rng.normal(size=(b, d)).astype(np.float32)
    feats = rng.normal(size=(b, t, fs)).astype(np.float32)
    return x, feats


def test_tril_order_matches():
    for f in (2, 4, 27):
        np.testing.assert_array_equal(tint.tril_flat_indices(f).numpy(),
                                      jint.tril_flat_indices(f))


@pytest.mark.parametrize("impl", list(IMPLS))
@pytest.mark.parametrize("shape", [
    (16, 4, 8, 1),     # b, tables, d, pad_to
    (32, 7, 16, 1),
    (8, 26, 16, 1),
    (16, 3, 8, 128),
])
def test_forward_matches_jax(impl, shape, rng):
    b, t, d, pad_to = shape
    got, want = _both(impl, *_inputs(rng, b, t, d), pad_to)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("impl", list(IMPLS))
@pytest.mark.parametrize("batch", [7, 13, 107])
@pytest.mark.parametrize("pad_to", [1, 64, 128])
def test_ragged_and_padded_match_jax(impl, batch, pad_to, rng):
    got, want = _both(impl, *_inputs(rng, batch, 3, 8), pad_to)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("impl", list(IMPLS))
@pytest.mark.parametrize("d", [16, 128])
def test_kaggle_feature_count_matches_jax(impl, d, rng):
    """F = 27 (26 tables + the bottom output), P = 351."""
    got, want = _both(impl, *_inputs(rng, 12, 26, d), 1)
    assert got.shape == (12, d + 351)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("impl", list(IMPLS))
def test_rechunked_features_match_jax(impl, rng):
    """fs != d: 4 tables of fs=16 re-chunked into 8 features of d=8."""
    got, want = _both(impl, *_inputs(rng, 16, 4, 16, d=8), 1)
    assert got.shape == (16, 8 + 36)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("impl", ["gram", "fused"])
def test_bf16_matches_jax(impl, rng):
    """bf16 inputs, f32 accumulation, one rounding of the output: the two
    may differ by one bf16 rounding (rtol 1e-2), plus atol 1e-5 for
    values that round from f32 sums taken in another order."""
    x, feats = _inputs(rng, 16, 5, 8)
    x = x.astype(ml_dtypes.bfloat16)
    feats = feats.astype(ml_dtypes.bfloat16)
    jfn, tfn = IMPLS[impl]
    want = np.asarray(jfn(jnp.asarray(x), jnp.asarray(feats), 1)
                      ).astype(np.float32)
    tx = torch.from_numpy(x.astype(np.float32)).bfloat16()
    tf = torch.from_numpy(feats.astype(np.float32)).bfloat16()
    got = tfn(tx, tf, 1)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=1e-5,
                               rtol=1e-2)


def test_fused_cpu_path_is_the_plain_version(rng):
    """A CPU tensor takes the plain version (no launch is counted), and
    that version is differentiable on the CPU."""
    t = torch.from_numpy(rng.normal(size=(9, 5, 8)).astype(np.float32))
    before = (tfused.interaction_fwd.launches,
              tfused.interaction_bwd.launches)
    out = tfused.fused_interaction_t(t, 16)
    assert tfused.interaction_fwd.launches == before[0]
    torch.testing.assert_close(
        out, tfused.fused_interaction_t_reference(t, 16), rtol=0, atol=0)
    assert out.shape == (9, tfused.output_width(5, 8, 16)) == (9, 32)
    tg = t.clone().requires_grad_(True)
    tfused.fused_interaction_t(tg, 1).sum().backward()
    assert tg.grad is not None and torch.isfinite(tg.grad).all()
    assert (tfused.interaction_fwd.launches,
            tfused.interaction_bwd.launches) == before


def test_fused_rejects_other_devices():
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tfused.fused_interaction_t(torch.empty((2, 3, 4), device="meta"))


@pytest.mark.parametrize("shape,esize,want", [
    ((16384, 27, 128), 4, (2, 4, True)),     # Kaggle fs=128, f32
    ((16384, 27, 16), 2, (8, 1, True)),      # Kaggle fs=16, bf16
    ((13, 4, 8), 4, (13, 1, True)),          # whole batch in one block
    ((5, 3, 3), 4, (5, 1, False)),           # rows not 16-byte multiples
    ((64, 27, 512), 4, (1, 16, True)),       # wide rows: one sample a block
])
def test_launch_geometry(shape, esize, want):
    assert tfused._launch_geometry(*shape, esize) == want


def test_launch_geometry_rejects_oversized_samples():
    with pytest.raises(ValueError, match="shared memory"):
        tfused._launch_geometry(4, 64, 1024, 4)


def _vjp_both(rng, b, f, d, pad_to, dtype=np.float32):
    """The port's plain backward and jax.vjp of the JAX package's fused
    interaction (its Pallas backward, in interpret mode on the CPU), on the
    same T and cotangent.  The cotangent's padding columns are nonzero: the
    backward must ignore them."""
    import jax
    t = rng.normal(size=(b, f, d)).astype(np.float32)
    g = rng.normal(size=(b, tfused.output_width(f, d, pad_to))
                   ).astype(np.float32)
    if dtype != np.float32:
        t, g = t.astype(dtype), g.astype(dtype)
    _, vjp = jax.vjp(lambda x: jpal.fused_interaction_t(x, pad_to),
                     jnp.asarray(t))
    (want,) = vjp(jnp.asarray(g))
    tt = torch.from_numpy(t.astype(np.float32))
    tg = torch.from_numpy(g.astype(np.float32))
    if dtype != np.float32:
        tt, tg = tt.bfloat16(), tg.bfloat16()
    got = tfused.fused_interaction_t_bwd_reference(tg, tt)
    assert got.shape == (b, f, d) and got.dtype == tt.dtype
    return got.float().numpy(), np.asarray(want).astype(np.float32)


@pytest.mark.parametrize("shape", [
    (16, 5, 8),      # b, f, d
    (9, 27, 16),     # Kaggle F
    (12, 27, 128),   # Kaggle fs=128
    (6, 4, 20),      # D not a multiple of 8
    (5, 2, 3),
])
@pytest.mark.parametrize("pad_to", [1, 64, 128])
def test_fused_vjp_matches_jax(shape, pad_to, rng):
    """f32: dT sums F products in another order, atol/rtol 1e-5."""
    got, want = _vjp_both(rng, *shape, pad_to)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("batch", [7, 13, 107])
@pytest.mark.parametrize("pad_to", [1, 64, 128])
def test_fused_vjp_ragged_matches_jax(batch, pad_to, rng):
    got, want = _vjp_both(rng, batch, 4, 8, pad_to)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("pad_to", [1, 128])
def test_fused_vjp_bf16_matches_jax(pad_to, rng):
    """bf16 T and cotangent, f32 sums, one rounding of dT: the two may
    differ by one bf16 rounding (rtol 1e-2) plus atol 1e-5 for f32 sums
    taken in another order."""
    got, want = _vjp_both(rng, 13, 6, 16, pad_to, ml_dtypes.bfloat16)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-2)


def test_fused_autograd_matches_jax_grad(rng):
    """Autograd through the port's fused Function (plain versions on the
    CPU) gives jax.grad through the JAX package's fused interaction, for
    both the bottom output and the pooled features."""
    import jax
    x = rng.normal(size=(11, 8)).astype(np.float32)
    feats = rng.normal(size=(11, 5, 8)).astype(np.float32)

    def jloss(x, feats):
        return jnp.sum(jnp.sin(jpal.fused_dot_interaction(x, feats, 64)))

    want = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(feats))
    tx = torch.from_numpy(x).requires_grad_()
    tf = torch.from_numpy(feats).requires_grad_()
    loss = torch.sin(tfused.fused_dot_interaction(tx, tf, 64)).sum()
    got = torch.autograd.grad(loss, (tx, tf))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   rtol=1e-5)


def test_fused_bwd_rejects_bad_cotangent():
    t = torch.zeros((4, 3, 8), device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tfused.interaction_bwd(torch.zeros((4, 11), device="meta"), t)


@pytest.mark.parametrize("shape,esize,want", [
    ((16384, 27, 128), 4, (2, True, True)),   # Kaggle fs=128, f32
    ((16384, 27, 16), 2, (9, True, True)),    # Kaggle fs=16, bf16
    ((13, 4, 8), 4, (13, True, True)),        # whole batch in one block
    ((5, 3, 3), 4, (5, False, False)),        # rows not 16-byte multiples
    ((64, 27, 512), 4, (1, True, True)),      # wide rows: one sample a block
])
def test_bwd_launch_geometry(shape, esize, want):
    assert tfused._bwd_launch_geometry(*shape, esize) == want


def test_bwd_launch_geometry_rejects_oversized_samples():
    with pytest.raises(ValueError, match="shared memory"):
        tfused._bwd_launch_geometry(4, 64, 1024, 4)
