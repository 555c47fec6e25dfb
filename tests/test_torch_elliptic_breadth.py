"""The rest of the port's elliptic problems against pspde's (CPU):
``ExponentialOnBallNonlinearSinHessian`` and ``Committor`` (in the stopped
kernels' family) and ``QuadraticGradient``, ``Helmholtz``,
``Oscillations`` and ``SinNorm2`` (the scan only).  On the same numpy
inputs: the diffusion matrix and its ``apply`` / ``apply_T``, ``g``,
``h``, ``v_ref``, the drift, the geometry, its domain test and its
samplers; the family hooks against the problems' own h and v_ref; and the
kernels' family check, which takes the first two and refuses the others,
naming STOPPED_KERNEL_FAMILY.

Tolerance: rtol 1e-6 with an absolute floor of 1e-6 of the largest entry
(float32 elementwise math, as tests/test_torch_elliptic_problems.py);
sigma bitwise (its square root is taken in float32 of float32(2/d), as
XLA takes it); the family hooks in float64 against the float32 problem,
rtol 1e-5 and atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pspde.problems as jp
from pspde.rollout.sampling import inside_fn as j_inside
import pspde_torch.problems as tp
from pspde_torch.ansatz import DenseNet
from pspde_torch.rollout import kernels as tk
from pspde_torch.rollout.sampling import (inside_fn, sample_boundary,
                                          sample_domain)

RTOL = 1e-6

CASES = {
    "hessian": ("ExponentialOnBallNonlinearSinHessian", dict(d=6, alpha=0.7)),
    "hessian_neumann": ("ExponentialOnBallNonlinearSinHessian",
                        dict(d=5, alpha=0.4, boundary_type="Neumann")),
    "committor": ("Committor", dict(d=7)),
    "quadratic": ("QuadraticGradient", dict(d=4)),
    "helmholtz": ("Helmholtz", dict(d=2)),
    "oscillations": ("Oscillations", dict(d=1)),
    "sinnorm2": ("SinNorm2", dict(d=5, alpha=0.8)),
    "sinnorm2_nonlinear": ("SinNorm2", dict(d=3, linear=False)),
}
IN_FAMILY = ("hessian", "hessian_neumann", "committor")


def _pair(case):
    cls, kw = CASES[case]
    return getattr(jp, cls)(**kw), getattr(tp, cls)(**kw, device="cpu")


def _inputs(pj, K=128, seed=0):
    """Points of the problem's domain (made by pspde's sampler), y and z."""
    d = pj.d
    from pspde.rollout.sampling import sample_domain as j_domain
    x = np.array(j_domain(jax.random.PRNGKey(seed), pj.geometry, K, d))
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((K,)).astype(np.float32)
    z = rng.standard_normal((K, d)).astype(np.float32)
    return x, y, z


def _close(a, b):
    a = np.asarray(a)
    np.testing.assert_allclose(b.detach().cpu().numpy(), a, rtol=RTOL,
                               atol=RTOL * float(np.abs(a).max()) + 1e-30)


@pytest.mark.parametrize("case", list(CASES))
def test_problem_matches_jax(case):
    pj, pt = _pair(case)
    x, y, z = _inputs(pj)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    yj, yt, zj, zt = (jnp.asarray(y), torch.from_numpy(y), jnp.asarray(z),
                      torch.from_numpy(z))
    _close(pj.g(xj), pt.g(xt))
    _close(pj.h(xj, yj, zj), pt.h(xt, yt, zt))
    _close(pj.v_ref(xj), pt.v_ref(xt))
    _close(pj.b(xj), pt.b(xt))
    _close(pj.f(xj), pt.f(xt))
    np.testing.assert_array_equal(np.asarray(pj.X_0), pt.X_0.numpy())
    sj, st = pj.sigma_struct, pt.sigma_struct
    assert st.kind == sj.kind and st.scale == sj.scale
    np.testing.assert_array_equal(np.asarray(sj.mat), st.mat.numpy())
    _close(sj.apply(zj), st.apply(zt))
    _close(sj.apply_T(zj), st.apply_T(zt))
    assert pt.geometry == tp.Geometry(**vars(pj.geometry))
    assert pt.boundary_type == pj.boundary_type
    assert pt.T is None and pt.has_v_ref and pt.d == pj.d
    assert pt.has_u_ref == pj.has_u_ref


@pytest.mark.parametrize("case", ["hessian", "committor", "helmholtz",
                                  "oscillations", "sinnorm2"])
def test_geometry_test_and_samplers(case):
    """The domain test agrees with pspde's on points inside, outside and
    across the boundary; the port's samplers land in the domain and on its
    boundary, as pspde's do."""
    pj, pt = _pair(case)
    d, geom = pj.d, pj.geometry
    rng = np.random.default_rng(3)
    dirs = rng.standard_normal((256, d))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    X = (dirs * rng.uniform(0.0, 2.5, (256, 1))).astype(np.float32)
    P = (X + rng.normal(0.0, 0.3, X.shape)).astype(np.float32)
    want = np.asarray(j_inside(geom)(jnp.asarray(X), jnp.asarray(P)))
    got = inside_fn(pt.geometry)(torch.from_numpy(X), torch.from_numpy(P))
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < int(want.sum()) < 256
    gen = torch.Generator().manual_seed(4)
    Xd = sample_domain(gen, pt.geometry, 512, d)
    Xb = sample_boundary(gen, pt.geometry, 512, d)
    r = torch.linalg.norm(Xd, dim=-1)
    rb = torch.linalg.norm(Xb, dim=-1)
    if geom.kind == "two_spheres":
        assert bool(((r >= 1.0 - 1e-5) & (r <= 2.0 + 1e-5)).all())
        torch.testing.assert_close(rb[:256], torch.ones(256))
        torch.testing.assert_close(rb[256:], torch.full((256,), 2.0))
    elif geom.kind == "sphere":
        assert bool((r <= 1.0 + 1e-6).all())
        torch.testing.assert_close(rb, torch.ones(512))
    else:
        assert bool(((Xd >= geom.X_l) & (Xd <= geom.X_r)).all())
        on_face = ((Xb == geom.X_l) | (Xb == geom.X_r)).any(dim=-1)
        assert bool(on_face.all())


@pytest.mark.parametrize("case", IN_FAMILY)
def test_family_hooks_state_h_and_v_ref(case):
    """('ball_exp', c_y, c_yr2, k, phi, k_t, c_ys1) evaluates to the JAX
    problem's h, ('exp_r2', a) or ('committor', a, c, d) to its v_ref;
    the drift is zero; the kernels' family check takes the problem with a
    DenseNet and pads h's family to eight entries (c_y3, the cubic's, 0
    here)."""
    pj, pt = _pair(case)
    x, y, z = _inputs(pj, seed=1)
    fam = tuple(pt.h_family()) + (0.0,) * (8 - len(pt.h_family()))
    kind, c_y, c_yr2, k, phi, k_t, c_ys1, c_y3 = fam
    assert kind == "ball_exp" and k_t == 0.0 and c_y3 == 0.0
    x64, y64 = x.astype(np.float64), y.astype(np.float64)
    r2 = np.sum(x64 ** 2, axis=-1)
    s1 = np.sum(x64, axis=-1)
    u = np.exp(k * r2) - y64 ** 2
    h = y64 * (c_y + c_yr2 * r2 + c_ys1 * s1 ** 2) + {
        "none": 0.0, "identity": u, "sin": np.sin(u)}[phi]
    want = np.asarray(pj.h(jnp.asarray(x), jnp.asarray(y), jnp.asarray(z)))
    np.testing.assert_allclose(h, want, rtol=1e-5,
                               atol=1e-6 * float(np.abs(want).max()) + 1e-7)
    vfam = pt.v_ref_family()
    if vfam[0] == "exp_r2":
        v = np.exp(vfam[1] * r2)
    else:
        assert vfam[0] == "committor" and vfam[3] == pt.d
        a, c, dd = vfam[1:]
        r = np.sqrt(r2)
        v = (a ** 2 - r ** (2 - dd) * a ** dd) / (a ** 2 - c ** (2 - dd)
                                                   * a ** dd)
    np.testing.assert_allclose(v, np.asarray(pj.v_ref(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-6)
    assert pt.drift_family() == ("zero", None)
    net = DenseNet(1, (4,), d_in=pt.d, device="cpu")
    hfam, vf = tk._check_stopped_family(pt, net, "erfinv")
    assert hfam == fam and vf == vfam


@pytest.mark.parametrize("case,match", [
    ("quadratic", "h of QuadraticGradient"),
    ("helmholtz", "geometry of Helmholtz"),
    ("oscillations", "geometry of Oscillations"),
    ("sinnorm2", "h of SinNorm2"),
])
def test_scan_only_problems_are_refused(case, match):
    """The JAX package gives these no transposed h, so they run on the scan
    only: the kernels' check refuses each, naming the family."""
    _, pt = _pair(case)
    net = DenseNet(1, (4,), d_in=pt.d, device="cpu")
    assert pt.h_family() is None and pt.v_ref_family() is None
    with pytest.raises(ValueError, match="STOPPED_KERNEL_FAMILY") as e:
        tk._check_stopped_family(pt, net, "erfinv")
    assert match in str(e.value)


def test_breadth_family_edges():
    """A dense sigma or the two spheres with a clock, and a (sum x)^2 term
    with a clock, stay outside the family."""
    net = DenseNet(1, (4,), d_in=5, device="cpu")
    hes = tp.ExponentialOnBallNonlinearSinHessian(d=4, device="cpu")
    hes.T = 1.0
    with pytest.raises(ValueError, match="not scalar"):
        tk._check_stopped_family(hes, net, "erfinv", time_stopping=True)
    com = tp.Committor(d=4, device="cpu")
    com.T = 1.0
    with pytest.raises(ValueError, match="two_spheres"):
        tk._check_stopped_family(com, net, "erfinv", time_stopping=True)

    class _S1Clock(tp.ExponentialOnSphereNonlinearParabolic):
        def h_family(self):
            return super().h_family() + (0.5,)

    with pytest.raises(ValueError, match="sum_j x_j"):
        tk._check_stopped_family(_S1Clock(d=4, device="cpu"), net,
                                 "erfinv", time_stopping=True)


def test_helmholtz_and_oscillations_note_their_dimension(capsys):
    tp.Helmholtz(d=3, device="cpu")
    tp.Oscillations(d=2, device="cpu")
    out = capsys.readouterr().out
    assert "d = 2" in out and "d = 1" in out
