"""The port's double-well problems and FD oracle against pspde's (CPU).

* ``pspde_torch.problems.fd_oracles.parabolic_log_transform_reference``
  (the port's own copy, SciPy's banded solver) against pspde's: bitwise
  against pspde's SciPy sweep, and within rtol 1e-10 on psi and on u (atol
  1e-10 of max |u|: u is a difference of logs, so where it is near 0 its
  relative error means nothing) against pspde's native C++ sweep, which
  pspde takes where its library is built; float64.
* ``DoubleWell`` and ``DoubleWell_multidim``: V, grad V, b, f, h, g and
  the reference lookups ``u_ref_fn`` / ``v_ref_fn`` (device gathers of the
  FD tables, clipped to the grid) on the same numpy inputs, rtol 1e-6;
  the kernel-family hooks.
* the JAX suite's training-and-IS workflow of
  tests/test_double_well_is.py::test_double_well_training_and_is on the
  port, with the variance pair of ``do_importance_sampling_Wei``.
"""

import numpy as np
import pytest
import torch

import pspde.problems as jp
from pspde.native import fd_native
from pspde.problems import fd_oracles as jfd
import pspde_torch.problems as tp
from pspde_torch.eval import (do_importance_sampling,
                              do_importance_sampling_Wei)
from pspde_torch.problems import fd_oracles as tfd
from pspde_torch.solvers import HJBSolver

RTOL = 1e-6


def _wells(eta, kappa):
    return (lambda x: kappa * (x ** 2 - 1.0) ** 2,
            lambda x: eta * (x - 1.0) ** 2)


@pytest.mark.parametrize("eta,kappa,T,dt,nx", [
    (3.0, 5.0, 1.0, 0.005, 1000),   # the high-metastability notebook
    (1.0, 1.0, 1.0, 0.01, 500),     # tests/test_double_well_is.py
    (1.0, 1.0, 0.5, 0.01, 400),
])
def test_fd_oracle_matches_pspde(eta, kappa, T, dt, nx, monkeypatch):
    V, g = _wells(eta, kappa)
    port = tfd.parabolic_log_transform_reference(V, g, T, delta_t=dt, nx=nx)
    native = jfd.parabolic_log_transform_reference(V, g, T, delta_t=dt,
                                                   nx=nx)
    monkeypatch.setattr(fd_native, "available", lambda: False)
    scipy_path = jfd.parabolic_log_transform_reference(V, g, T, delta_t=dt,
                                                       nx=nx)
    xvec, psi, u, dx = port
    assert psi.shape == (int(T / dt) + 1, nx) and u.shape == (psi.shape[0],
                                                              nx - 1)
    assert psi.dtype == np.float64 and u.dtype == np.float64
    for a, b in zip(port, scipy_path):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(xvec, native[0])
    assert dx == native[3]
    np.testing.assert_allclose(psi, native[1], rtol=1e-10, atol=0)
    np.testing.assert_allclose(u, native[2], rtol=1e-10,
                               atol=1e-10 * np.abs(native[2]).max())


def _problems(kind):
    if kind == "dw1":
        kw = dict(d=1, T=1.0, eta=3.0, kappa=5.0)
        return jp.DoubleWell(**kw), tp.DoubleWell(device="cpu", **kw)
    kw = dict(d=10, d_1=3, d_2=7, T=1.0, eta=3.0, kappa=5.0)
    return (jp.DoubleWell_multidim(**kw),
            tp.DoubleWell_multidim(device="cpu", **kw))


def _x(d, K=257, seed=0, scale=1.4):
    return (scale * np.random.default_rng(seed).standard_normal(
        (K, d))).astype(np.float32)


@pytest.mark.parametrize("kind", ["dw1", "dw10"])
def test_coefficients_match(kind):
    pj, pt = _problems(kind)
    x = _x(pj.d)
    xt = torch.from_numpy(x)
    z = _x(pj.d, seed=1)
    np.testing.assert_array_equal(pt.X_0.numpy(), np.asarray(pj.X_0))
    for name in ("grad_V", "b", "g"):
        np.testing.assert_allclose(getattr(pt, name)(xt).numpy(),
                                   np.asarray(getattr(pj, name)(x)),
                                   rtol=RTOL, atol=1e-6, err_msg=name)
    if kind == "dw1":
        np.testing.assert_allclose(pt.V(xt).numpy(), np.asarray(pj.V(x)),
                                   rtol=RTOL)
    np.testing.assert_array_equal(pt.f(xt, 0.3).numpy(),
                                  np.asarray(pj.f(x, 0.3)))
    np.testing.assert_allclose(
        pt.h(0.3, xt, None, torch.from_numpy(z)).numpy(),
        np.asarray(pj.h(0.3, x, None, z)), rtol=RTOL)
    np.testing.assert_allclose(pt.sigma_struct.mat.numpy(),
                               np.asarray(pj.sigma_struct.mat))


@pytest.mark.parametrize("kind", ["dw1", "dw10"])
def test_reference_lookups_match(kind):
    """u_ref_fn and v_ref_fn at steps 0, 1, the middle and the last, on
    states that reach past the table's grid on both sides (the clip)."""
    pj, pt = _problems(kind)
    pj.compute_reference_solution(delta_t=0.01, nx=500)
    pt.compute_reference_solution(delta_t=0.01, nx=500)
    N = 100
    ts = np.arange(N) * 0.01
    u_j, u_t = pj.u_ref_fn(ts), pt.u_ref_fn(ts)
    v_j, v_t = pj.v_ref_fn(ts), pt.v_ref_fn(ts)
    x = _x(pj.d, scale=1.6)
    x[:3] = [[-3.0], [2.6], [2.5]] if pj.d == 1 else x[:3]
    xt = torch.from_numpy(x)
    for n in (0, 1, N // 2, N - 1):
        ut = u_t(xt, n)
        assert ut.shape == (x.shape[0], pj.d) and ut.device == xt.device
        np.testing.assert_allclose(ut.numpy(), np.asarray(u_j(x, n)),
                                   rtol=RTOL, atol=1e-6)
        np.testing.assert_allclose(v_t(xt, n).numpy(),
                                   np.asarray(v_j(x, n)), rtol=RTOL)
    assert pt.ref_sol_is_defined and pt.dx == pj.dx


def test_kernel_family_hooks():
    """The double well's drift is stated for the serve kernel (4 kappa is
    packed by the kernel's front end), f is zero and h the quadratic-in-Z
    form of LLGC; kappa per dimension for the mixed wells."""
    _, pt1 = _problems("dw1")
    _, pt10 = _problems("dw10")
    kind, kappa = pt1.drift_family()
    assert kind == "double_well" and kappa.tolist() == [5.0]
    kind, kappa = pt10.drift_family()
    assert kind == "double_well"
    assert kappa.tolist() == [5.0] * 3 + [1.0] * 7
    for p in (pt1, pt10):
        assert p.running_cost_family() == ("zero", None)
        assert p.h_family() == ("quadratic_z", -1.0, 0.0)
        assert p.sigma_struct.kind == "scalar" and p.h_is_y_free
    assert pt10.geometry.kind == "unbounded"


def test_double_well_training_and_is():
    """tests/test_double_well_is.py's recipe on the port: 400 steps of
    the 'inner' control under log-variance bring u_L2 below 0.3 x its
    first value, the metastable fraction is logged every step, and the
    learned control beats naive MC as an IS proposal."""
    torch.manual_seed(0)
    dw = tp.DoubleWell(d=1, T=1.0, eta=1.0, kappa=1.0, device="cpu")
    dw.compute_reference_solution(delta_t=0.01, nx=500)
    s = HJBSolver("dw", dw, lr=5e-3, L=400, K=1024, delta_t=0.01,
                  time_approx="inner", loss_method="log-variance",
                  detach_forward=True, verbose=False,
                  metastability_logs=(np.ones(1), 0.5),
                  early_stopping_time=None, device="cpu")
    s.train()
    assert s.u_L2_loss[-1] < 0.3 * s.u_L2_loss[0]
    out = do_importance_sampling(dw, s, K=20000, verbose=False,
                                 generator=torch.Generator().manual_seed(1))
    rel_naive, rel_is = out[2], out[5]
    assert rel_is < rel_naive
    assert len(s.particles_close_to_target) == len(s.loss_log)
    # the variance pair of the same run
    assert do_importance_sampling_Wei(
        dw, s, K=20000, verbose=False,
        generator=torch.Generator().manual_seed(1)) == (out[1], out[4])
