"""The port's parabolic problems against pspde's (CPU).

``HeatEquation``, ``AllenCahn``, ``ExponentialOnSphereParabolic`` and
``ExponentialOnSphereNonlinearParabolic`` (Dirichlet and Neumann): ``h``,
``g``, ``f_terminal`` and ``v_ref`` on the same numpy inputs in the unit
ball, rtol 1e-6 (float32 reorderings of one exp and one sum; ``h`` also atol
4e-6: its sin() reads exp(2 alpha |x|^2 + 2 t) <= 9, where one ulp of the
argument is 1e-6); the geometry, the horizon and sigma; and the stopped
kernels' ``h_family`` (with its time coefficient k_t) against the problem's
own ``h``.  Sizes: d = 3 and 5, K = 64.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import pspde.problems as jp
import pspde_torch.problems as tp

K = 64
RTOL = 1e-6

CASES = {
    "heat": ("HeatEquation", dict(T=0.7)),
    "allen_cahn": ("AllenCahn", dict(T=0.3)),
    "linear": ("ExponentialOnSphereParabolic", dict(T=0.5, alpha=0.6)),
    "nonlinear": ("ExponentialOnSphereNonlinearParabolic",
                  dict(T=0.5, alpha=0.6)),
    "nonlinear_neumann": ("ExponentialOnSphereNonlinearParabolic",
                          dict(T=0.5, alpha=0.6, boundary_type="Neumann")),
}


def _pair(case, d):
    cls, kw = CASES[case]
    return getattr(jp, cls)(d=d, **kw), getattr(tp, cls)(d=d, device="cpu",
                                                          **kw)


def _inputs(d, T, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((K, d))
    x *= rng.uniform(size=(K, 1)) ** (1.0 / d) / np.linalg.norm(
        x, axis=1, keepdims=True)
    x = x.astype(np.float32)
    t = (T * rng.uniform(size=K)).astype(np.float32)
    y = rng.standard_normal(K).astype(np.float32)
    z = rng.standard_normal((K, d)).astype(np.float32)
    return x, t, y, z


@pytest.mark.parametrize("d", [3, 5])
@pytest.mark.parametrize("case", sorted(CASES))
def test_problem_functions_match_jax(case, d):
    pj, pt = _pair(case, d)
    x, t, y, z = _inputs(d, pj.T)
    xt, tt, yt, zt = (torch.from_numpy(a) for a in (x, t, y, z))
    np.testing.assert_allclose(pt.h(tt, xt, yt, zt).numpy(),
                               np.asarray(pj.h(jnp.asarray(t), x, y, z)),
                               rtol=RTOL, atol=4e-6)
    np.testing.assert_allclose(pt.f_terminal(xt).numpy(),
                               np.asarray(pj.f_terminal(x)), rtol=RTOL)
    np.testing.assert_allclose(pt.b(xt).numpy(), np.asarray(pj.b(x)))
    if hasattr(pj, "g"):
        g = pt.g(xt, tt)
        assert g.shape == ((K, d) if pt.boundary_type == "Neumann" else (K,))
        np.testing.assert_allclose(g.numpy(), np.asarray(pj.g(x, t)),
                                   rtol=RTOL)
    assert pt.has_v_ref == hasattr(pj, "v_ref")
    if pt.has_v_ref:
        np.testing.assert_allclose(pt.v_ref(xt, tt).numpy(),
                                   np.asarray(pj.v_ref(x, t)), rtol=RTOL)
    assert (pt.T, pt.d, pt.boundary_type) == (pj.T, pj.d, pj.boundary_type)
    assert pt.geometry.kind == pj.geometry.kind
    assert pt.geometry.boundary_distance == pj.geometry.boundary_distance
    assert pt.geometry.bounded == pj.geometry.bounded
    assert pt.sigma_struct.kind == "scalar"
    np.testing.assert_allclose(pt.sigma_struct.mat.numpy(),
                               np.asarray(pj.sigma_struct.mat), rtol=RTOL)
    assert pt.drift_family() == ("zero", None)
    assert pt.h_is_y_free == getattr(pj, "h_is_y_free", False)


@pytest.mark.parametrize("d", [3, 5])
@pytest.mark.parametrize("case", ["heat", "linear", "nonlinear",
                                  "nonlinear_neumann"])
def test_h_family_states_h(case, d):
    """h = y (c_y + c_yr2 |x|^2) + phi(exp(k |x|^2 + k_t t) - y^2), the form
    the stopped kernels evaluate, is the problem's h."""
    _, pt = _pair(case, d)
    x, t, y, z = (torch.from_numpy(a) for a in _inputs(d, pt.T, seed=1))
    kind, c_y, c_yr2, k, phi, k_t = pt.h_family()
    assert kind == "ball_exp"
    r2 = torch.sum(x * x, dim=-1)
    h = y * (c_y + c_yr2 * r2)
    if phi != "none":
        u = torch.exp(k * r2 + k_t * t) - y * y
        h = h + (torch.sin(u) if phi == "sin" else u)
    np.testing.assert_allclose(h.numpy(), pt.h(t, x, y, z).numpy(),
                               rtol=2e-6, atol=4e-6)
    assert pt.v_ref_family() is None


def test_allen_cahn_is_outside_the_kernels_family():
    """AllenCahn's cubic h is the 'ball_exp' family's y (c_y + c_yr2 |x|^2)
    with c_y3 y^3 (the eighth entry), which the kernels take with the clock
    only: without time_stopping (JAX's elliptic "ac100" form) it stays
    outside their family, as the whole space does."""
    pt = tp.AllenCahn(d=3, device="cpu")
    hfam = pt.h_family()
    assert hfam == ("ball_exp", 1.0, 0.0, 0.0, "none", 0.0, 0.0, -1.0)
    x, t, y, z = (torch.from_numpy(a) for a in _inputs(3, pt.T, seed=2))
    _, c_y, c_yr2, _, _, _, _, c_y3 = hfam
    h = y * (c_y + c_yr2 * torch.sum(x * x, dim=-1)) + c_y3 * y ** 3
    torch.testing.assert_close(h, pt.h(t, x, y, z))
    assert not pt.has_v_ref and pt.V0_LITERATURE == 0.052802
