"""The port's PINN residuals and PINN training steps against pspde's (CPU).

* ``elliptic_pinn_residual`` and ``parabolic_pinn_residual``
  (``pspde_torch/losses/pinn.py``) against ``pspde/losses/pinn.py`` on the
  same DenseNet (converted from the Flax tree) and the same in-domain
  points, with the second-order term contracted by B_00^2 Tr H and by
  Tr(B B^T H) (``full_hessian``), for a scalar, a diagonal and a full
  sigma: ``ExponentialOnBallNonlinearSin``,
  ``ExponentialOnBallNonlinearSinHessian``, ``Committor`` and
  ``HeatEquation`` (parabolic, dV/dt in the residual).
* 20 PINN steps of ``EllipticSolver`` (with and without
  ``PINN_log_variance`` and ``full_hessian``) and of ``GeneralSolver``
  against pspde's ``_build_pinn_step``, each port step fed the JAX step's
  own draws (elliptic: kb, kd = split(key); general: kb, kbt, kd, kt =
  split(key, 4)), from JAX's initial net: loss, domain and V_L2
  trajectories and the parameters after 20 steps.

Tolerances: residuals rtol 1e-5 with an absolute floor of 1e-6 of the
largest entry (float32: the Hessians' sums and h's exp and sin in another
order); trajectories rtol 2e-4; parameters atol 2e-5 after 20 steps.
Sizes: d=5 (residuals), d=4 and d=3 (steps), K=64, K_boundary=16,
DenseNet (8, 8).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pspde.problems as jp
from pspde.ansatz import DenseNet as JDenseNet
from pspde.losses.pinn import elliptic_pinn_residual as j_elliptic
from pspde.losses.pinn import parabolic_pinn_residual as j_parabolic
from pspde.problems.base import DiffusionMatrix as JDiffusionMatrix
from pspde.rollout.sampling import sample_boundary as j_boundary
from pspde.rollout.sampling import sample_domain as j_domain
from pspde.solvers import EllipticSolver as JElliptic
from pspde.solvers import GeneralSolver as JGeneral
import pspde_torch.problems as tp
from pspde_torch.losses import elliptic_pinn_residual, parabolic_pinn_residual
from pspde_torch.solvers import EllipticSolver as TElliptic
from pspde_torch.solvers import GeneralSolver as TGeneral
from pspde_torch.utils.convert import dense_net_from_flax, dense_net_to_flax

RTOL = 1e-5
K, KB, STEPS = 64, 16, 20
TRAJ_RTOL, PARAM_ATOL = 2e-4, 2e-5
DIAG = np.array([1.2, 0.8, 1.5, 1.0, 0.6], np.float32)


def _diag_sigma(pj, pt):
    """Both problems with the diagonal sigma DIAG."""
    pj._sigma = JDiffusionMatrix(np.diag(DIAG))
    pt._sigma = tp.DiffusionMatrix(np.diag(DIAG), device="cpu")
    return pj, pt


CASES = {
    "sin": lambda: (jp.ExponentialOnBallNonlinearSin(d=5, alpha=0.5),
                    tp.ExponentialOnBallNonlinearSin(d=5, alpha=0.5,
                                                     device="cpu")),
    "sin_diag": lambda: _diag_sigma(
        jp.ExponentialOnBallNonlinearSin(d=5, alpha=0.5),
        tp.ExponentialOnBallNonlinearSin(d=5, alpha=0.5, device="cpu")),
    "hessian": lambda: (
        jp.ExponentialOnBallNonlinearSinHessian(d=5, alpha=0.5),
        tp.ExponentialOnBallNonlinearSinHessian(d=5, alpha=0.5,
                                                device="cpu")),
    "committor": lambda: (jp.Committor(d=5), tp.Committor(d=5,
                                                          device="cpu")),
}


def _net(d_in, seed=0):
    net = JDenseNet(d_out=1, arch=(8, 8))
    prm = net.init(jax.random.PRNGKey(seed), jnp.zeros((1, d_in)))
    return net, prm, dense_net_from_flax(jax.device_get(prm), device="cpu")


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL,
                               atol=RTOL * 0.1 * float(np.abs(want).max()))


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("full_hessian", [False, True])
def test_elliptic_residual_matches_jax(case, full_hessian):
    pj, pt = CASES[case]()
    net, prm, tnet = _net(pj.d)
    X = np.array(j_domain(jax.random.PRNGKey(1), pj.geometry, 48, pj.d))
    want = j_elliptic(pj, lambda x: net.apply(prm, x)[:, 0], jnp.asarray(X),
                      full_hessian)
    got = elliptic_pinn_residual(pt, lambda x: tnet(x)[:, 0],
                                 torch.from_numpy(X), full_hessian)
    _close(got, want)
    # the residual is differentiable in the net's parameters
    (g,) = torch.autograd.grad(torch.mean(got ** 2),
                               [tnet.layers[0].weight])
    assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0


@pytest.mark.parametrize("full_hessian", [False, True])
def test_parabolic_residual_matches_jax(full_hessian):
    d = 5
    pj = jp.HeatEquation(d=d, T=0.3)
    pt = tp.HeatEquation(d=d, T=0.3, device="cpu")
    net, prm, tnet = _net(d + 1)
    rng = np.random.default_rng(2)
    X = rng.standard_normal((48, d)).astype(np.float32)
    t = (rng.uniform(size=48) * 0.3).astype(np.float32)
    want = j_parabolic(pj, lambda xt: net.apply(prm, xt)[:, 0],
                       jnp.asarray(X), jnp.asarray(t), full_hessian)
    got = parabolic_pinn_residual(pt, lambda xt: tnet(xt)[:, 0],
                                  torch.from_numpy(X), torch.from_numpy(t),
                                  full_hessian)
    _close(got, want)


def _params_close(ts, params):
    got = dense_net_to_flax(list(ts.V_net.parameters()))
    for a, b in zip(jax.tree.leaves(got),
                    jax.tree.leaves(jax.device_get(params))):
        np.testing.assert_allclose(a, b, rtol=0, atol=PARAM_ATOL)


@pytest.mark.parametrize("case,opts", [
    ("sin", {}),
    ("sin", dict(PINN_log_variance=True)),
    ("hessian", dict(full_hessian=True)),
    ("hessian", dict(full_hessian=True, PINN_log_variance=True,
                     alpha=(0.5, 2.0))),
    ("committor", dict(alpha=(1e-3, 1.0), boundary_loss=False)),
])
def test_twenty_elliptic_pinn_steps_match_jax(case, opts):
    """The committor runs without its boundary term: g = 1[|x| > a] jumps
    on the inner sphere, where half the boundary samples lie, so float32
    roundoff of |x| sets g there."""
    d = 4
    pj, pt = {"sin": (jp.ExponentialOnBallNonlinearSin(d=d, alpha=0.5),
                      tp.ExponentialOnBallNonlinearSin(d=d, alpha=0.5,
                                                       device="cpu")),
              "hessian": (jp.ExponentialOnBallNonlinearSinHessian(
                  d=d, alpha=0.5), tp.ExponentialOnBallNonlinearSinHessian(
                      d=d, alpha=0.5, device="cpu")),
              "committor": (jp.Committor(d=d), tp.Committor(
                  d=d, device="cpu"))}[case]
    kw = dict(dict(delta_t=0.01, N=8, lr=1e-3, L=STEPS, K=K, K_boundary=KB,
                   loss_method="PINN", log_loss_parts=True, verbose=False),
              **opts)
    js = JElliptic(pj, "j", value_net=JDenseNet(d_out=1, arch=(8, 8)), **kw)
    step = jax.jit(js._build_pinn_step())
    ts = TElliptic(pt, "t", device="cpu", **kw)
    ts.load_jax_params(jax.device_get(js.params))
    params, opt = js.params, js.opt_state
    key = jax.random.PRNGKey(21)
    j_loss, j_dom, j_vl2 = [], [], []
    for _ in range(STEPS):
        key, sub = jax.random.split(key)
        kb, kd = jax.random.split(sub)
        X = torch.tensor(np.asarray(j_domain(kd, pj.geometry, K, d)))
        Xb = torch.tensor(np.asarray(j_boundary(kb, pj.geometry, KB, d)))
        params, opt, aux = step(params, opt, sub)
        j_loss.append(float(aux["loss"]))
        j_dom.append(float(aux["domain"]))
        j_vl2.append(float(aux["V_L2"]))
        out = ts.step(X0=X, Xb=Xb)
        assert float(out["K_count"]) == K and bool(out["all_stopped"])
    np.testing.assert_allclose(ts.loss_log, j_loss, rtol=TRAJ_RTOL)
    np.testing.assert_allclose(ts.loss_log_domain, j_dom, rtol=TRAJ_RTOL)
    np.testing.assert_allclose(ts.V_L2_log, j_vl2, rtol=TRAJ_RTOL)
    assert ts.iteration == STEPS
    _params_close(ts, params)


@pytest.mark.parametrize("case,opts", [
    ("ball", {}),
    ("ball", dict(PINN_log_variance=True, full_hessian=True)),
    ("heat", dict(alpha=(1.0, 0.5, 1.0))),
])
def test_twenty_general_pinn_steps_match_jax(case, opts):
    d, T = 3, 0.15
    if case == "ball":
        pj = jp.ExponentialOnSphereNonlinearParabolic(d=d, alpha=0.5, T=T)
        pt = tp.ExponentialOnSphereNonlinearParabolic(d=d, alpha=0.5, T=T,
                                                      device="cpu")
    else:
        pj = jp.HeatEquation(d=d, T=T)
        pt = tp.HeatEquation(d=d, T=T, device="cpu")
    kw = dict(dict(delta_t=0.01, N=8, lr=1e-3, L=STEPS, K=K, K_boundary=KB,
                   loss_method="PINN", log_loss_parts=True, verbose=False),
              **opts)
    js = JGeneral(pj, "j", value_net=JDenseNet(d_out=1, arch=(6, 5)), **kw)
    step = jax.jit(js._build_pinn_step())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ts = TGeneral(pt, "t", device="cpu", **kw)
    ts.load_jax_params(jax.device_get(js.params))
    params, opt = js.params, js.opt_state
    key = jax.random.PRNGKey(22)
    j_loss, j_dom = [], []
    for _ in range(STEPS):
        key, sub = jax.random.split(key)
        kb, kbt, kd, kt = jax.random.split(sub, 4)
        X = torch.tensor(np.asarray(j_domain(kd, pj.geometry, K, d)))
        t = torch.tensor(np.asarray(jax.random.uniform(kt, (K,)) * T))
        Xb = tb = None
        if pj.geometry.bounded:
            Xb = torch.tensor(np.asarray(j_boundary(kb, pj.geometry, KB, d)))
            tb = torch.tensor(np.asarray(jax.random.uniform(kbt, (KB,))
                                         * T))
        params, opt, aux = step(params, opt, sub)
        j_loss.append(float(aux["loss"]))
        j_dom.append(float(aux["domain"]))
        out = ts.step(X0=X, t0=t, Xb=Xb, tb=tb)
        assert float(out["V_L2"]) == 0.0
    np.testing.assert_allclose(ts.loss_log, j_loss, rtol=TRAJ_RTOL)
    np.testing.assert_allclose(ts.loss_log_domain, j_dom, rtol=TRAJ_RTOL)
    _params_close(ts, params)
