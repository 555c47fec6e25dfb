"""The port's eigenvalue problems against pspde's (CPU).

``FokkerPlanckEigen`` and ``SchrodingerEigen``: b, g, h, v_ref, X_0,
lambda_true, sigma and the geometry on the same numpy-seeded points of the
torus [0, 2 pi]^d, rtol 1e-6 (atol 1e-7 for entries near 0); Schrodinger's
normalization constant c from the same quadrature; the stopped kernels'
family hooks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pspde.problems as jp
import pspde_torch.problems as tp

RTOL, ATOL = 1e-6, 1e-7


def _points(d, K=257, seed=0):
    rng = np.random.default_rng(seed + d)
    x = rng.uniform(0.0, 2.0 * np.pi, (K, d)).astype(np.float32)
    y = rng.standard_normal(K).astype(np.float32)
    z = rng.standard_normal((K, d)).astype(np.float32)
    return x, y, z


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a.detach().cpu().numpy()),
                               np.asarray(b), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("cls", ["FokkerPlanckEigen", "SchrodingerEigen"])
@pytest.mark.parametrize("d", [1, 5, 10])
def test_coefficients_match_jax(cls, d):
    pj = getattr(jp, cls)(d=d)
    pt = getattr(tp, cls)(d=d, device="cpu")
    x, y, z = _points(d)
    xt, yt, zt = (torch.from_numpy(a) for a in (x, y, z))
    _close(pt.b(xt), pj.b(jnp.asarray(x)))
    _close(pt.g(xt), pj.g(jnp.asarray(x)))
    _close(pt.h(xt, yt, zt), pj.h(jnp.asarray(x), jnp.asarray(y),
                                  jnp.asarray(z)))
    _close(pt.v_ref(xt), pj.v_ref(jnp.asarray(x)))
    _close(pt.X_0, pj.X_0)
    _close(pt.sigma_struct.mat, pj.sigma_struct.mat)
    assert pt.sigma_struct.kind == "scalar"
    assert pt.sigma_struct.scale == pytest.approx(np.sqrt(2.0), rel=1e-7)
    assert pt.lambda_true == pj.lambda_true
    assert pt.T is None and pt.geometry.kind == "square"
    assert (pt.geometry.X_l, pt.geometry.X_r) == (pj.geometry.X_l,
                                                  pj.geometry.X_r)
    assert not pt.geometry.one_boundary


@pytest.mark.parametrize("d,c", [(5, 1.1040855), (10, 1.0511402)])
def test_schrodinger_normalization_constant(d, c):
    pt = tp.SchrodingerEigen(d=d, device="cpu")
    assert pt.c == pytest.approx(jp.SchrodingerEigen(d=d).c, rel=1e-12)
    assert pt.c == pytest.approx(c, abs=1e-7)   # the notebooks print 7 digits


def test_family_hooks():
    """FokkerPlanckEigen states its drift, h and reference in the stopped
    kernels' torus family with its uniform c (0.1 in float32); a
    non-uniform c is outside it.  SchrodingerEigen has zero drift and
    states its cubic h and its reference in the kernels' Schroedinger
    family with its c."""
    fp = tp.FokkerPlanckEigen(d=5, device="cpu")
    c = float(np.float32(0.1))
    assert fp.drift_family() == ("torus_cos", c)
    assert fp.h_family() == ("torus_fp", c)
    assert fp.v_ref_family() == ("torus_fp", c)
    # h is linear in y: the family's bracket is h(x, 1)
    x, y, z = (torch.from_numpy(a) for a in _points(5))
    torch.testing.assert_close(fp.h(x, y, z),
                               y * fp.h(x, torch.ones_like(y), z))
    fp.c = torch.linspace(0.1, 0.2, 5)
    assert (fp.drift_family(), fp.h_family(), fp.v_ref_family()) == (
        None, None, None)
    sch = tp.SchrodingerEigen(d=10, device="cpu")
    assert sch.drift_family() == ("zero", None)
    assert sch.h_family() == sch.v_ref_family() == ("schrodinger", sch.c)
    assert sch.has_v_ref and fp.has_v_ref
