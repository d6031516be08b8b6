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


def _vjp_inputs(rng, b, f, d, pad_to, dtype=np.float32):
    """T, a cotangent (nonzero in its padding columns, which the backward
    must ignore) and jax.vjp of the JAX package's fused interaction (its
    Pallas backward, in interpret mode on the CPU) there, all as numpy."""
    import jax
    t = rng.normal(size=(b, f, d)).astype(np.float32)
    g = rng.normal(size=(b, tfused.output_width(f, d, pad_to))
                   ).astype(np.float32)
    if dtype != np.float32:
        t, g = t.astype(dtype), g.astype(dtype)
    _, vjp = jax.vjp(lambda x: jpal.fused_interaction_t(x, pad_to),
                     jnp.asarray(t))
    (want,) = vjp(jnp.asarray(g))
    return t, g, np.asarray(want).astype(np.float32)


def _torch_of(a, dtype=np.float32):
    t = torch.from_numpy(np.asarray(a, dtype=np.float32))
    return t if dtype == np.float32 else t.bfloat16()


def _vjp_both(rng, b, f, d, pad_to, dtype=np.float32):
    """The port's plain backward and jax.vjp of the JAX package's fused
    interaction, on the same T and cotangent."""
    t, g, want = _vjp_inputs(rng, b, f, d, pad_to, dtype)
    tt, tg = _torch_of(t, dtype), _torch_of(g, dtype)
    got = tfused.fused_interaction_t_bwd_reference(tg, tt)
    assert got.shape == (b, f, d) and got.dtype == tt.dtype
    return got.float().numpy(), want


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
    # (samples a group, stages, row pitch, threads)
    ((16384, 27, 128), 4, (2, 2, 128, 192)),   # Kaggle fs=128, f32
    ((16384, 27, 16), 2, (8, 2, 16, 96)),      # Kaggle fs=16, bf16
    ((13, 4, 8), 4, (13, 2, 8, 32)),           # whole batch in one group
    ((5, 3, 3), 4, (5, 2, 4, 32)),             # rows padded to 16 bytes
    ((64, 27, 512), 4, (1, 2, 512, 256)),      # wide rows: 384 items, 2 passes
    ((32768, 27, 128), 4, (2, 2, 128, 192)),   # training step
    ((8192, 27, 128), 4, (2, 2, 128, 192)),    # clipped step
    ((32768, 27, 32), 4, (4, 2, 32, 96)),      # Terabyte fs=32, training
    ((16384, 27, 32), 4, (4, 2, 32, 96)),      # Terabyte fs=32, serving
    ((16384, 27, 32), 2, (8, 2, 32, 192)),     # Terabyte fs=32, bf16
    ((16384, 27, 128), 2, (2, 2, 128, 192)),   # Kaggle fs=128, bf16
    ((1, 27, 128), 4, (1, 2, 128, 96)),        # one sample
    ((9, 5, 6), 2, (9, 2, 8, 32)),             # bf16 rows of 12 bytes
])
def test_bwd_launch_geometry(shape, esize, want):
    """One pass covers a group: at F=27 a sample is 3 x D/4 items, 96 at
    D=128 (G=2: 192 threads) and 24 at D=32 (G=4: 96 threads)."""
    got = tfused._bwd_launch_geometry(*shape, esize)
    assert got == want
    group, stages, pitch, threads = got
    assert tfused._bwd_smem(shape[1], shape[2], pitch, group, stages,
                            esize) <= tfused._SMEM_MAX


def test_bwd_launch_geometry_rejects_oversized_samples():
    with pytest.raises(ValueError, match="shared memory"):
        tfused._bwd_launch_geometry(4, 64, 1024, 4)


_ROWS, _S_ROW, _CHUNK = tfused._BWD_ROWS, tfused._BWD_S_ROW, 4


def _bwd_runs(gaddr, b, width, gu, esize, group, samples):
    """The g runs that the groups of ``samples`` (first samples of groups,
    or every sample) stage, by csrc/interaction_bwd.cu's run_of, as arrays:
    first byte's address, bytes, byte in the stage's g area, bulk [lo, hi)
    relative to the first byte (lo == hi: no bulk copy)."""
    slot = -(-gu * esize // 16) * 16 + 16
    b0 = np.asarray(samples, np.int64)
    if width == gu:   # one run a group: its rows
        start = gaddr + b0 * width * esize
        nbytes = np.minimum(group, b - b0) * gu * esize
        dst = start % 16
    else:             # one run a sample: its D+P used columns
        start = gaddr + b0 * width * esize
        nbytes = np.full_like(b0, gu * esize)
        dst = b0 % group * slot + start % 16
    lo = -(-start // 16) * 16
    hi = (start + nbytes) // 16 * 16
    bulk = lo < hi
    plain = np.minimum(nbytes, 16)
    return (start, nbytes, dst, np.where(bulk, lo - start, plain),
            np.where(bulk, hi - start, plain))


def _check_runs(runs, gaddr, b, width, gu, esize, group):
    """What the kernel's staging of g must keep: a bulk copy 16-byte
    aligned at both ends in device memory and in the stage; the plain
    pieces before and after it each within the 16 bytes a thread group
    loads; every byte inside g's B x W elements, in used columns only (a
    run starts at a row's column 0 and ends at or before its column D+P);
    the stage's g area never overrun."""
    start, nbytes, dst, lo, hi = runs
    slot = -(-gu * esize // 16) * 16 + 16
    bulk = lo < hi
    assert ((start + lo)[bulk] % 16 == 0).all()
    assert ((start + hi)[bulk] % 16 == 0).all()
    assert ((dst + lo)[bulk] % 16 == 0).all()
    assert (lo <= 16).all() and (nbytes - hi <= 16).all() and (lo >= 0).all()
    assert (start >= gaddr).all()
    assert (start + nbytes <= gaddr + b * width * esize).all()
    first = (start - gaddr) // esize
    last = (start + nbytes - gaddr) // esize - 1
    assert (first % width == 0).all() and (last % width < gu).all()
    assert (dst + nbytes <= group * slot).all()


def _bwd_replay(gaddr, b, f, d, width, esize, resident, gbytes=None,
                gbase=0, t=None):
    """The backward kernel's walk, replayed in numpy: the persistent grid
    (``resident`` blocks) over groups, each group's bulk copies and plain
    loads of g (checked by ``_check_runs``), S built from the staged bytes
    through the pair table, the 9x4 items and their stores.  Checks that
    every dT element is stored exactly once: the walk visits every group
    once, and a group's items store each element of its samples once (the
    ragged last group's samples are a prefix of a whole group's).  Given
    g's storage bytes (``gbytes`` from address ``gbase``) and T (B, F, D)
    in f32, returns dT in f32 as the kernel sums it."""
    group, stages, pitch, threads = tfused._bwd_launch_geometry(b, f, d,
                                                                esize)
    gu = d + f * (f - 1) // 2
    nrb, nchunks = -(-f // _ROWS), -(-d // _CHUNK)
    n_items = nrb * nchunks
    n_groups = -(-b // group)
    blocks = min(n_groups, resident)
    visits = np.concatenate([np.arange(blk, n_groups, blocks)
                             for blk in range(blocks)])
    seen = np.bincount(visits, minlength=n_groups)
    # the stores of one whole group's items, (sample, row, column)
    s_of, rest = np.divmod(np.arange(group * n_items), n_items)
    rb, c = np.divmod(rest, nchunks)
    r, q = np.meshgrid(np.arange(_ROWS), np.arange(_CHUNK), indexing="ij")
    i = rb[:, None, None] * _ROWS + r
    k = c[:, None, None] * _CHUNK + q
    s3 = np.broadcast_to(s_of[:, None, None], i.shape)
    keep = (i < f) & (k < d)
    per_group = np.bincount(((s3 * f + i) * d + k)[keep],
                            minlength=group * f * d).reshape(group, f, d)
    assert (seen == 1).all() and (per_group == 1).all()
    samples = visits * group if width == gu else np.arange(b)
    _check_runs(_bwd_runs(gaddr, b, width, gu, esize, group, samples),
                gaddr, b, width, gu, esize, group)
    if gbytes is None:
        return None
    slot = -(-gu * esize // 16) * 16 + 16
    pairs = [(i_, j_) for i_ in range(1, f) for j_ in range(i_)]

    def at(jj, ii):   # S[ii][jj]'s place in a sample's S
        return jj * nrb * _S_ROW + ii // _ROWS * _S_ROW + ii % _ROWS

    dt = np.zeros((b, f, d), np.float32)
    for grp in visits:
        b0 = int(grp) * group
        ns = min(group, b - b0)
        area = np.zeros(group * slot, np.uint8)
        first = [b0] if width == gu else range(b0, b0 + ns)
        runs = _bwd_runs(gaddr, b, width, gu, esize, group, first)
        for start, nbytes, dst, lo, hi in zip(*runs):
            src = start - gbase   # plain head, bulk middle, plain tail
            for p0, p1 in ((0, lo), (lo, hi), (hi, nbytes)):
                area[dst + p0:dst + p1] = gbytes[src + p0:src + p1]
        for s in range(ns):
            gofs = (runs[2][0] + s * gu * esize if width == gu
                    else runs[2][s])
            raw = area[gofs:gofs + gu * esize]
            gs = (raw.view(np.float32) if esize == 4 else
                  (raw.view(np.uint16).astype(np.uint32) << 16
                   ).view(np.float32))
            sym = np.zeros(f * nrb * _S_ROW, np.float32)
            for p, (i_, j_) in enumerate(pairs):
                sym[at(j_, i_)] = sym[at(i_, j_)] = gs[d + p]
            sym = sym.reshape(f, nrb, _S_ROW)[:, :, :_ROWS]
            tp = np.zeros((f, nchunks * _CHUNK), np.float32)
            tp[:, :d] = t[b0 + s]
            acc = np.einsum("jbr,jk->brk", sym, tp).reshape(nrb * _ROWS, -1)
            acc[0, :d] += gs[:d]
            dt[b0 + s] = acc[:f, :d]
    return dt


_WALK_SHAPES = [(16384, 27, 128), (32768, 27, 128), (8192, 27, 128),
                (32768, 27, 32), (16384, 27, 32)]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("pad_to", [1, 128])
@pytest.mark.parametrize("shape", _WALK_SHAPES)
def test_bwd_walk_stores_once_and_stages_only_g(shape, pad_to, dtype):
    """At every main path's shape: the walk stores every dT element
    exactly once, and every span it stages lies inside g (B x W elements)
    and off its padding, with g aligned and starting 4 bytes (f32) or 2
    (bf16) into its storage; the last group's span ends at g's last
    byte; 396 resident blocks (three an SM) and 264 (two)."""
    b, f, d = shape
    esize = 4 if dtype == "f32" else 2
    width = tfused.output_width(f, d, pad_to)
    for base in (1 << 40, (1 << 40) + esize):
        for resident in (396, 264):
            _bwd_replay(base, b, f, d, width, esize, resident)


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("pad_to", [1, 128])
@pytest.mark.parametrize("shape", [(37, 27, 128), (23, 27, 128),
                                   (45, 27, 32), (27, 27, 32),
                                   (13, 5, 6), (9, 4, 8)])
def test_bwd_walk_matches_reference_and_jax(shape, pad_to, dtype, rng):
    """dT by the replayed walk (the main paths' geometries at a few groups a
    block, ragged last groups, g a view 4 or 2 bytes into its storage)
    against fused_interaction_t_bwd_reference and the JAX package's VJP
    (Pallas in interpret mode).  f32: atol/rtol 1e-5 (sums in another
    order); bf16: one bf16 rounding apart (rtol 1e-2) plus atol 1e-5."""
    b, f, d = shape
    t, g, want = _vjp_inputs(rng, b, f, d, pad_to, dtype)
    tt, tg = _torch_of(t, dtype), _torch_of(g, dtype)
    storage = torch.zeros(g.size + 1, dtype=tg.dtype)
    view = storage[1:].view(g.shape)
    view.copy_(tg)
    dt = _bwd_replay(view.data_ptr(), b, f, d, g.shape[1],
                     tg.element_size(), 3, storage.view(torch.uint8).numpy(),
                     storage.data_ptr(), tt.float().numpy())
    got = torch.from_numpy(dt).to(tt.dtype).float().numpy()
    ref = tfused.fused_interaction_t_bwd_reference(tg, tt).float().numpy()
    tol = (dict(atol=1e-5, rtol=1e-5) if dtype == np.float32
           else dict(atol=1e-5, rtol=1e-2))
    np.testing.assert_allclose(got, ref, **tol)
    np.testing.assert_allclose(got, want, **tol)


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
