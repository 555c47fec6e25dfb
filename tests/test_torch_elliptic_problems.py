"""The port's elliptic problems against pspde's (CPU): g, h, v_ref,
u_ref and the coefficients on the same numpy inputs, and the stopped
kernels' h_family / v_ref_family against the problems' own h and v_ref.

Tolerance: rtol 1e-6, with an absolute floor of 1e-6 of the largest
entry (float32 elementwise math; exp and sin agree to a few ulp between
XLA and PyTorch, and h's terms cancel in places: measured 1.3e-6 relative
on one entry of 128 whose value is a fifth of the largest)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pspde.problems as jp
import pspde_torch.problems as tp

RTOL = 1e-6

CASES = {
    "sphere": ("ExponentialOnSphere", dict(d=5, alpha=0.7)),
    "nonlinear": ("ExponentialOnBallNonlinear", dict(d=6, alpha=0.3)),
    "nonlinear_neumann": ("ExponentialOnBallNonlinear",
                          dict(d=6, alpha=0.3, boundary_type="Neumann")),
    "sin": ("ExponentialOnBallNonlinearSin", dict(d=50, alpha=0.1)),
}


def _pair(case):
    cls, kw = CASES[case]
    return getattr(jp, cls)(**kw), getattr(tp, cls)(**kw, device="cpu")


def _inputs(d, K=128, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((K, d)) / np.sqrt(d)).astype(np.float32)
    y = rng.standard_normal((K,)).astype(np.float32)
    z = rng.standard_normal((K, d)).astype(np.float32)
    return x, y, z


def _close(a, b):
    a = np.asarray(a)
    np.testing.assert_allclose(b.detach().cpu().numpy(), a, rtol=RTOL,
                               atol=RTOL * float(np.abs(a).max()))


@pytest.mark.parametrize("case", list(CASES))
def test_elliptic_problem_matches_jax(case):
    pj, pt = _pair(case)
    x, y, z = _inputs(pj.d)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    yj, yt, zj, zt = (jnp.asarray(y), torch.from_numpy(y), jnp.asarray(z),
                      torch.from_numpy(z))
    _close(pj.g(xj), pt.g(xt))
    _close(pj.h(xj, yj, zj), pt.h(xt, yt, zt))
    _close(pj.v_ref(xj), pt.v_ref(xt))
    _close(pj.b(xj), pt.b(xt))
    _close(pj.f(xj), pt.f(xt))
    if hasattr(pj, "u_ref"):
        _close(pj.u_ref(xj), pt.u_ref(xt))
    sj, st = pj.sigma_struct, pt.sigma_struct
    assert st.kind == sj.kind == "scalar" and st.scale == sj.scale
    assert pt.geometry.kind == pj.geometry.kind == "sphere"
    assert pt.geometry.boundary_distance == pj.geometry.boundary_distance
    assert pt.boundary_type == pj.boundary_type
    assert pt.T is None and pt.has_v_ref and pt.d == pj.d


@pytest.mark.parametrize("case", list(CASES))
def test_h_family_states_h(case):
    """('ball_exp', c_y, c_yr2, k, phi) evaluates to the JAX problem's h;
    ('exp_r2', a) to its v_ref; the drift is zero."""
    pj, pt = _pair(case)
    x, y, z = _inputs(pj.d, seed=1)
    kind, c_y, c_yr2, k, phi = pt.h_family()
    assert kind == "ball_exp"
    r2 = np.sum(x.astype(np.float64) ** 2, axis=-1)
    y64 = y.astype(np.float64)
    u = np.exp(k * r2) - y64 ** 2
    h = y64 * (c_y + c_yr2 * r2) + {"none": 0.0, "identity": u,
                                    "sin": np.sin(u)}[phi]
    want = np.asarray(pj.h(jnp.asarray(x), jnp.asarray(y), jnp.asarray(z)))
    np.testing.assert_allclose(h, want, rtol=1e-5, atol=1e-6)
    kind, a = pt.v_ref_family()
    assert kind == "exp_r2"
    np.testing.assert_allclose(np.exp(a * r2), np.asarray(
        pj.v_ref(jnp.asarray(x))), rtol=1e-6)
    assert pt.drift_family() == ("zero", None)
    assert tp.LLGC(d=3, device="cpu").v_ref_family() is None
