"""The port's path-space losses against pspde's (CPU).

The same numpy-made Y, g(X) and Z_sum (K=64) go through
``pspde.losses.pathspace`` and ``pspde_torch.losses.pathspace``; the
value and its gradients with respect to Y and Z_sum must agree to rtol
1e-5 (float32 means of 64 terms in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pspde.losses.pathspace as jl
import pspde_torch.losses.pathspace as tl

RTOL, ATOL = 1e-5, 1e-7

# (method, adaptive, phase): every method of HJB_LOSS_METHODS, with both
# phases of the scheduled ones and both cross-entropy weights;
# 'log-variance-y_0' is the split that the solver pulls back separately
CASES = [(m, True, 0) for m in tl.HJB_LOSS_METHODS] + [
    ("log-variance-repa", True, 1),
    ("relative_entropy_log-variance", True, 1),
    ("cross_entropy", False, 0),
]


def _inputs(K=64, seed=0):
    rng = np.random.default_rng(seed)
    Y = (0.3 * rng.standard_normal(K) + 0.5).astype(np.float32)
    gX = (0.3 * rng.standard_normal(K)).astype(np.float32)
    Z_sum = rng.standard_normal(K).astype(np.float32)
    return Y, gX, Z_sum


def test_methods_are_the_same():
    assert tl.HJB_LOSS_METHODS == jl.HJB_LOSS_METHODS
    assert len(tl.HJB_LOSS_METHODS) == 10


@pytest.mark.parametrize("method,adaptive,phase", CASES)
def test_loss_matches_jax(method, adaptive, phase):
    Y, gX, Z_sum = _inputs()
    if method == "log-variance-y_0":
        def j_fn(y, z):
            return jl.log_variance_y0_losses(y, jnp.asarray(gX))

        def t_fn(y, z):
            return tl.log_variance_y0_losses(y, torch.from_numpy(gX))
        with pytest.raises(ValueError):
            tl.hjb_loss(method, torch.from_numpy(Y), torch.from_numpy(gX),
                        torch.from_numpy(Z_sum))
    else:
        def j_fn(y, z):
            return (jl.hjb_loss(method, y, jnp.asarray(gX), z,
                                adaptive=adaptive, phase=phase),)

        def t_fn(y, z):
            return (tl.hjb_loss(method, y, torch.from_numpy(gX), z,
                                adaptive=adaptive, phase=phase),)

    j_vals = j_fn(jnp.asarray(Y), jnp.asarray(Z_sum))
    y = torch.from_numpy(Y).requires_grad_(True)
    z = torch.from_numpy(Z_sum).requires_grad_(True)
    t_vals = t_fn(y, z)
    for i, (jv, tv) in enumerate(zip(j_vals, t_vals)):
        np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=RTOL,
                                   atol=ATOL)
        j_gy, j_gz = jax.grad(lambda a, b: j_fn(a, b)[i], argnums=(0, 1))(
            jnp.asarray(Y), jnp.asarray(Z_sum))
        t_gy, t_gz = torch.autograd.grad(tv, [y, z], retain_graph=True,
                                         allow_unused=True)
        for tg, jg in ((t_gy, j_gy), (t_gz, j_gz)):
            tg = np.zeros_like(Y) if tg is None else tg.numpy()
            np.testing.assert_allclose(tg, np.asarray(jg), rtol=RTOL,
                                       atol=ATOL)


def test_unknown_method_raises():
    Y, gX, Z_sum = (torch.from_numpy(a) for a in _inputs())
    with pytest.raises(ValueError, match="unknown loss method"):
        tl.hjb_loss("nope", Y, gX, Z_sum)
