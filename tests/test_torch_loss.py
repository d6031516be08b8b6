"""dlrm_tpu_torch.ops.loss.bce_loss against dlrm_tpu.ops.loss.bce_loss:
the clamped-log forward and the reference's eps-regularised backward (not
autograd of the clamped forward), on the same numpy inputs.

Tolerance: f32, rtol 1e-6 (a mean of B terms summed in another order);
at x = 0 or 1 the clamped logs and the eps quotients are held exactly.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from dlrm_tpu.ops.loss import bce_loss as jbce
from dlrm_tpu_torch.ops.loss import bce_loss


def _inputs(rng, n, edges):
    x = rng.uniform(0.01, 0.99, size=n).astype(np.float32)
    y = rng.integers(0, 2, size=n).astype(np.float32)
    if edges:  # predictions at 0 and 1 against both labels
        x[:4] = [0.0, 0.0, 1.0, 1.0]
        y[:4] = [0.0, 1.0, 0.0, 1.0]
    return x, y


def _both(x, y, g=1.0):
    jl, jvjp = jax.vjp(jbce, jnp.asarray(x), jnp.asarray(y))
    jdx, _ = jvjp(jnp.float32(g))
    tx = torch.from_numpy(x).requires_grad_()
    tl = bce_loss(tx, torch.from_numpy(y))
    (tdx,) = torch.autograd.grad(tl, tx, torch.tensor(g))
    return (tl.item(), tdx.numpy()), (float(jl), np.asarray(jdx))


@pytest.mark.parametrize("n,edges", [(1, False), (7, False), (64, True),
                                     (333, True)])
def test_bce_matches_jax(n, edges, rng):
    x, y = _inputs(rng, n, edges)
    (loss, dx), (jloss, jdx) = _both(x, y)
    np.testing.assert_allclose(loss, jloss, rtol=1e-6)
    np.testing.assert_allclose(dx, jdx, rtol=1e-6, atol=0)
    if edges:
        # the clamp caps a wrong certain prediction at 100 per example, and
        # the eps quotient keeps its gradient finite
        assert np.isfinite(dx).all()
        np.testing.assert_array_equal(dx[:4], jdx[:4])


def test_bce_upstream_scale_and_no_label_grad(rng):
    x, y = _inputs(rng, 16, False)
    (_, dx), (_, jdx) = _both(x, y, g=2.5)
    np.testing.assert_allclose(dx, jdx, rtol=1e-6)
    tx = torch.from_numpy(x).requires_grad_()
    ty = torch.from_numpy(y).requires_grad_()
    loss = bce_loss(tx, ty)
    gx, gy = torch.autograd.grad(loss, (tx, ty), allow_unused=True)
    assert gy is None and gx.shape == tx.shape
    assert loss.dtype == torch.float32 and loss.dim() == 0


def test_bce_backward_is_not_autograd_of_clamped_forward():
    """At x = 1 with label 0 the clamped forward is flat (log(1 - x) is
    clamped at -100); the reference's gradient is (1 / eps) / B."""
    x = torch.tensor([1.0, 0.5], requires_grad=True)
    y = torch.tensor([0.0, 1.0])
    (dx,) = torch.autograd.grad(bce_loss(x, y), x)
    eps = np.finfo(np.float32).eps
    assert dx[0].item() == pytest.approx((1.0 / eps) / 2, rel=1e-6)


def test_bce_bf16_predictions_match_jax(rng):
    """bf16 predictions are widened to f32 in both packages; the gradient
    is rounded back to bf16 (the input's dtype) by the port and by JAX."""
    x, y = _inputs(rng, 32, False)
    xb = x.astype(ml_dtypes.bfloat16)
    jl, jvjp = jax.vjp(jbce, jnp.asarray(xb), jnp.asarray(y))
    (jdx, _) = jvjp(jnp.float32(1.0))
    tx = torch.from_numpy(xb.astype(np.float32)).bfloat16().requires_grad_()
    tl = bce_loss(tx, torch.from_numpy(y))
    (tdx,) = torch.autograd.grad(tl, tx)
    assert tdx.dtype == torch.bfloat16
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-6)
    np.testing.assert_allclose(tdx.float().numpy(),
                               np.asarray(jdx).astype(np.float32), rtol=1e-2)
