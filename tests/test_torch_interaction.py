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
    # (lanes an item, samples a group, stages, row pitch, threads)
    ((16384, 27, 128), 4, (8, 2, 2, 128, 128)),   # Kaggle fs=128, f32
    ((16384, 27, 16), 2, (4, 16, 2, 16, 256)),    # Kaggle fs=16, bf16
    ((16384, 27, 16), 4, (4, 8, 2, 16, 256)),     # Kaggle fs=16, f32
    ((13, 4, 8), 4, (4, 8, 2, 8, 32)),            # 8 items: one warp
    ((5, 3, 3), 4, (4, 5, 2, 4, 32)),             # rows padded to 16 bytes
    ((64, 27, 512), 4, (8, 1, 2, 512, 64)),       # wide rows: one a group
    ((32768, 27, 128), 4, (8, 2, 2, 128, 128)),   # training step
    ((8192, 27, 128), 4, (8, 2, 2, 128, 128)),    # clipped step
    ((1, 27, 128), 4, (8, 1, 2, 128, 64)),        # one sample
    ((4, 40, 1024), 4, (8, 1, 1, 1024, 160)),     # one stage fits, not two
    ((9, 5, 6), 2, (4, 8, 2, 8, 32)),             # bf16 rows of 12 bytes
    ((16384, 27, 64), 4, (8, 4, 2, 64, 256)),     # fs=64: 32 items a pass
    ((256, 8, 128), 4, (8, 8, 2, 128, 128)),      # F=8: two row blocks
    ((256, 7, 128), 4, (8, 8, 2, 128, 64)),       # F=7: one diagonal tile
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
        tfused.interaction_bwd(torch.zeros((4, 11), device="meta"), t[:, 0],
                               t[:, 1:])


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


def _meta(shape, stride=None):
    if stride is None:
        return torch.empty(shape, device="meta")
    return torch.empty_strided(shape, stride, device="meta")


@pytest.mark.parametrize("x,feats,err,msg", [
    (_meta((4, 8)), _meta((5, 3, 8)), ValueError, "4 samples and feats 5"),
    (_meta((4, 8)), _meta((4, 3, 5)), ValueError, "re-chunk"),
    (_meta((4, 8), (1, 4)), _meta((4, 3, 8)), ValueError, "contiguous"),
    (_meta((4, 8)), _meta((4, 3, 8), (24, 1, 3)), ValueError, "contiguous"),
    (_meta((4, 8)), _meta((4, 3, 8), (24, 8, 2)), ValueError, "contiguous"),
    (_meta((4, 8)), _meta((4, 24)), ValueError, "must be"),
    (_meta((4, 8)), _meta((4, 3, 8)).half(), TypeError, "float32"),
    (_meta((4, 8)), _meta((4, 3, 8)), ValueError, "CPU or CUDA"),
    (torch.zeros((4, 8)), _meta((4, 3, 8)), ValueError, "CPU or CUDA"),
])
def test_wrappers_refuse_what_the_kernels_do_not_take(x, feats, err, msg):
    """Both wrappers raise on a layout, dtype or device the kernels do not
    take, before anything is launched or copied: the sample strides may
    be anything, the rows of a sample must be contiguous."""
    with pytest.raises(err, match=msg):
        tfused.interaction_fwd(x, feats, 1)
    g = _meta((4, tfused.output_width(4, 8, 1)))
    with pytest.raises(err, match=msg):
        tfused.interaction_bwd(g, x, feats)


@pytest.mark.parametrize("out", [
    (_meta((4, 8)), _meta((4, 2, 8))),
    (_meta((4, 9)), _meta((4, 3, 8))),
    (_meta((4, 8)).half(), _meta((4, 3, 8)).half()),
])
def test_bwd_refuses_outputs_of_other_shapes(out):
    x, feats = _meta((4, 8)), _meta((4, 3, 8))
    g = _meta((4, tfused.output_width(4, 8, 1)))
    with pytest.raises(ValueError, match="shapes and dtype of x and feats"):
        tfused.interaction_bwd(g, x, feats, out=out)


_TWO_SOURCE_CASES = [
    # b, tables, fs, d, pad_to
    (7, 3, 8, 8, 1),       # ragged batches
    (13, 3, 8, 8, 64),
    (107, 3, 8, 8, 128),
    (12, 26, 16, 16, 1),   # Kaggle F = 27
    (16, 4, 16, 8, 64),    # re-chunked: fs = 16 into rows of d = 8
    (9, 5, 12, 6, 128),    # rows of 6: not a 16-byte multiple on the card
]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", _TWO_SOURCE_CASES)
def test_two_source_forward_and_grads_match_jax(case, dtype, rng):
    """fused_dot_interaction(x, feats) and its gradients in x and in feats
    separately, against the JAX package's fused_dot_interaction and its
    VJP (Pallas kernels in interpret mode), on the same inputs and
    cotangent (nonzero in the padding columns, which the backward must
    ignore).  f32: atol/rtol 1e-5 (sums in another order); bf16: one
    bf16 rounding apart (rtol 1e-2) plus atol 1e-5."""
    import jax
    b, n, fs, d, pad_to = case
    x, feats = _inputs(rng, b, n, fs, d)
    f = 1 + n * fs // d
    cot = rng.normal(size=(b, tfused.output_width(f, d, pad_to))
                     ).astype(np.float32)
    tol = (dict(atol=1e-5, rtol=1e-5) if dtype == "f32"
           else dict(atol=1e-5, rtol=1e-2))
    if dtype == "bf16":
        x, feats, cot = (a.astype(ml_dtypes.bfloat16) for a in (x, feats, cot))
    want, vjp = jax.vjp(
        lambda a, c: jpal.fused_dot_interaction(a, c, pad_to),
        jnp.asarray(x), jnp.asarray(feats))
    want_dx, want_dfeats = vjp(jnp.asarray(cot))

    def torch_of(a):
        t = torch.from_numpy(np.asarray(a, dtype=np.float32))
        return t.bfloat16() if dtype == "bf16" else t

    tx = torch_of(x).requires_grad_()
    tf = torch_of(feats).requires_grad_()
    out = tfused.fused_dot_interaction(tx, tf, pad_to)
    dx, dfeats = torch.autograd.grad(out, (tx, tf), torch_of(cot))
    assert out.dtype == dx.dtype == dfeats.dtype == tx.dtype
    assert dx.shape == tx.shape and dfeats.shape == tf.shape
    for got, ref in ((out, want), (dx, want_dx), (dfeats, want_dfeats)):
        np.testing.assert_allclose(got.detach().float().numpy(),
                                   np.asarray(ref).astype(np.float32), **tol)


@pytest.mark.parametrize("case", _TWO_SOURCE_CASES)
def test_t_view_form_equals_two_source_form(case, rng):
    """fused_interaction_t(T), which hands the kernels the views T[:, 0]
    and T[:, 1:], gives the bits of fused_dot_interaction on the two
    sources, forward and gradient."""
    b, n, fs, d, pad_to = case
    f = 1 + n * fs // d
    t = torch.from_numpy(rng.normal(size=(b, f, d)).astype(np.float32))
    cot = torch.from_numpy(rng.normal(
        size=(b, tfused.output_width(f, d, pad_to))).astype(np.float32))
    tt = t.clone().requires_grad_()
    out_t = tfused.fused_interaction_t(tt, pad_to)
    (dt,) = torch.autograd.grad(out_t, (tt,), cot)
    x = t[:, 0].clone().requires_grad_()
    feats = t[:, 1:].reshape(b, n, fs).clone().requires_grad_()
    out = tfused.fused_dot_interaction(x, feats, pad_to)
    dx, dfeats = torch.autograd.grad(out, (x, feats), cot)
    assert torch.equal(out_t, out)
    assert torch.equal(dt[:, 0], dx)
    assert torch.equal(dt[:, 1:].reshape(b, n, fs), dfeats)


def test_bwd_writes_into_given_views(rng):
    """interaction_bwd(..., out=(dt[:, 0], dt[:, 1:])) fills one dT through
    the two views, as the stacked form's backward uses it."""
    t = torch.from_numpy(rng.normal(size=(5, 4, 8)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(5, 14)).astype(np.float32))
    dt = torch.full_like(t, float("nan"))
    got = tfused.interaction_bwd(g, t[:, 0], t[:, 1:],
                                 out=(dt[:, 0], dt[:, 1:]))
    assert got[0].data_ptr() == dt.data_ptr()
    torch.testing.assert_close(
        dt, tfused.fused_interaction_t_bwd_reference(g, t), rtol=0, atol=0)
