"""The three notebook recipes of ``chip_smoke.py`` phase 39 against pspde
(CPU), at the scripts' widths, from the same initial net, for 20 steps:

* ``experiments/parabolic_neumann.py``: ``GeneralSolver`` on
  ``ExponentialOnSphereNonlinearParabolic(d=20)`` with Neumann data, N=20,
  dt 1e-3, K=200, K_boundary=50, alpha (1, 1, 10);
* ``experiments/ou_moment_initializations.py``: ``HJBSolver`` on
  ``LLGC(d=20, T=1)``, the moment loss with ``learn_Y_0``, K=500, N=100,
  after the notebook's override of Y_0 (to 10, and to the exact v(x_0,
  0)): JAX replaces ``y0_net`` and re-initialises Adam, the port sets
  ``y0_net.Y_0`` in place before its first step;
* ``experiments/trajectory_length_study.py``: ``EllipticSolver`` on
  ``ExponentialOnBallNonlinearSin(d=10, alpha=1)``, K=200, K_boundary=50,
  at N=1 and N=5, on the scan and on 'fused_train' (on the CPU the
  stopped kernels' plain versions with the hand backward: the family gate
  takes N=1).

Each port step is fed the JAX step's own draws.  Loss, u_L2 and Y_0
trajectories rtol 2e-4; parameters after 20 steps atol 2e-5.  The assets
that phase 39 loads hold JAX's seed-42 initial nets of the three scripts
(``experiments/notebooks_11a_reference.py`` wrote them).
"""

import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pspde.problems as jp
import pspde_torch.problems as tp
from pspde.ansatz import ScalarParam as JScalarParam
from pspde.rollout.sampling import sample_boundary as j_boundary
from pspde.rollout.sampling import sample_domain as j_domain
from pspde.solvers import EllipticSolver as JElliptic
from pspde.solvers import GeneralSolver as JGeneral
from pspde.solvers import HJBSolver as JHJB
from pspde_torch.solvers import EllipticSolver as TElliptic
from pspde_torch.solvers import GeneralSolver as TGeneral
from pspde_torch.solvers import HJBSolver as THJB
from pspde_torch.utils.convert import dense_net_to_flax, load_control_npz
from tests.torch_correctors import one_thread  # noqa: F401
from tests.test_torch_hjb_outer_value import (_assert_tree_close,
                                              _port_state, _template)

STEPS, TRAJ_RTOL, PARAM_ATOL = 20, 2e-4, 2e-5
ASSETS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "pspde_torch", "assets")


def _noise(key, K, d, N):
    return torch.from_numpy(np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(key, n), (K, d), dtype=jnp.float32))
        for n in range(N)]))


def _assert_params(net, jax_tree):
    got = dense_net_to_flax(list(net.parameters()))
    for a, b in zip(jax.tree.leaves(got),
                    jax.tree.leaves(jax.device_get(jax_tree))):
        np.testing.assert_allclose(a, b, rtol=0, atol=PARAM_ATOL)


def _assert_asset(name, tree):
    """The committed asset is JAX's initial net, leaf for leaf."""
    flat = load_control_npz(os.path.join(ASSETS, name))[0]
    got = jax.tree.leaves(flat)
    want = jax.tree.leaves(jax.device_get(tree))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def _neumann(m, **kw):
    p = m.ExponentialOnSphereNonlinearParabolic(d=20, T=1.0, alpha=1.0,
                                                **kw)
    p.boundary_type = "Neumann"
    return p


def test_parabolic_neumann_twenty_steps_match_jax():
    K, KB, N, D = 200, 50, 20, 20
    kw = dict(delta_t=1e-3, N=N, lr=1e-3, L=STEPS, K=K, K_boundary=KB,
              alpha=(1.0, 1.0, 10.0), loss_method="diffusion", seed=42,
              verbose=False)
    pj, pt = _neumann(jp), _neumann(tp, device="cpu")
    js = JGeneral(pj, "j", **kw)
    _assert_asset("parabolic_neumann_d20_densenet.npz", js.params)
    ts = TGeneral(pt, "t", device="cpu", **kw)
    ts.load_jax_params(jax.device_get(js.params))
    assert ts.boundary_type == "Neumann" and ts.alpha == (1.0, 1.0, 10.0)
    step = jax.jit(js._build_step())
    params, opt = js.params, js.opt_state
    key = jax.random.PRNGKey(21)
    j_loss = []
    for _ in range(STEPS):
        key, sub = jax.random.split(key)
        kb, kbt, kd, kt, kr = jax.random.split(sub, 5)
        X0, t0, Xb, tb = (torch.from_numpy(np.array(a)) for a in (
            j_domain(kd, pj.geometry, K, D),
            jax.random.uniform(kt, (K,)) * pj.T,
            j_boundary(kb, pj.geometry, KB, D),
            jax.random.uniform(kbt, (KB,)) * pj.T))
        params, opt, aux = step(params, opt, sub)
        j_loss.append(float(aux["loss"]))
        ts.step(X0=X0, t0=t0, Xb=Xb, tb=tb, host_noise=_noise(kr, K, D, N))
    np.testing.assert_allclose(ts.loss_log, j_loss, rtol=TRAJ_RTOL)
    _assert_params(ts.V_net, params)


@pytest.mark.parametrize("init", ["10", "exact"])
def test_moment_initialisation_twenty_steps_match_jax(init):
    K, D = 500, 20
    kw = dict(L=STEPS, lr=1e-3, seed=42, delta_t=0.01, K=K,
              time_approx="inner", loss_method="moment", learn_Y_0=True,
              detach_forward=True, early_stopping_time=None, verbose=False)
    pj = jp.LLGC(d=D, T=1.0, seed=42)
    pt = tp.LLGC(d=D, T=1.0, seed=42, device="cpu")
    v0 = float(pj.v_ref(jnp.zeros((1, D)), 0.0)[0])
    assert float(pt.v_ref(torch.zeros((1, D)), 0.0)[0]) == pytest.approx(
        v0, rel=1e-6)
    y0 = 10.0 if init == "10" else v0
    js = JHJB("j", pj, **kw)
    _assert_asset("llgc_d20_tanhmlp.npz", {"z": js.params["z"]})
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ts = THJB("t", pt, device="cpu", **kw)
    ts.load_jax_params({"z": jax.device_get(js.params["z"])})
    # JAX: the notebook's override after construction; the port: in place
    js.y0_net = JScalarParam(initial=y0)
    js.params = dict(js.params, y0=js.y0_net.init(jax.random.PRNGKey(42),
                                                  jnp.zeros((1, 1))))
    js.opt_state = js.tx.init(js.params)
    with torch.no_grad():
        ts.y0_net.Y_0.fill_(y0)
    step = jax.jit(js._build_step(0))
    params, opt = js.params, js.opt_state
    key = jax.random.PRNGKey(11)
    j_loss, j_ul2, j_y0 = [], [], []
    for _ in range(STEPS):
        key, sub = jax.random.split(key)
        _, kr = jax.random.split(sub)
        noise = _noise(kr, K, D, js.N)
        params, opt, m = step(params, opt, sub)
        j_loss.append(float(m["loss"]))
        j_ul2.append(float(m["u_l2"]))
        j_y0.append(float(params["y0"]["params"]["Y_0"][0]))
        ts.step(host_noise=noise)
    assert ts.Y_0_log[0] == pytest.approx(y0, abs=2e-3)
    np.testing.assert_allclose(ts.loss_log, j_loss, rtol=TRAJ_RTOL)
    np.testing.assert_allclose(ts.u_L2_loss, j_ul2, rtol=TRAJ_RTOL)
    np.testing.assert_allclose(float(ts.y0_net.Y_0.detach()), j_y0[-1],
                               rtol=0, atol=PARAM_ATOL)
    _assert_tree_close(_port_state(ts._net), _template(ts._net),
                       params["z"], 0, PARAM_ATOL, "parameter")


@pytest.mark.parametrize("N,engine", [(1, "scan"), (1, "fused_train"),
                                      (5, "scan"), (5, "fused_train")])
def test_trajectory_length_twenty_steps_match_jax(N, engine):
    K, KB, D, dt = 200, 50, 10, 1e-3
    kw = dict(delta_t=dt, N=N, lr=1e-3, L=STEPS, K=K, K_boundary=KB,
              loss_method="diffusion", seed=42, verbose=False)
    pj = jp.ExponentialOnBallNonlinearSin(d=D, alpha=1.0)
    pt = tp.ExponentialOnBallNonlinearSin(d=D, alpha=1.0, device="cpu")
    js = JElliptic(pj, "j", **kw)
    _assert_asset("trajectory_length_d10_densenet.npz", js.params)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ts = TElliptic(pt, "t", rollout_mode=engine, device="cpu", **kw)
        ts.load_jax_params(jax.device_get(js.params))
    # off the card every gate but the device passes, N=1 included; drive
    # the fused step through the kernels' plain versions
    if engine == "fused_train":
        assert ts._fused_train_gates() == ["problem on a CUDA device"]
    ts.resolved_rollout_mode = engine
    step = jax.jit(js._build_step())
    params, opt = js.params, js.opt_state
    key = jax.random.PRNGKey(21)
    j_loss, j_vl2 = [], []
    for _ in range(STEPS):
        key, sub = jax.random.split(key)
        kb, kd, kr = jax.random.split(sub, 3)
        Xb = torch.from_numpy(np.array(j_boundary(kb, pj.geometry, KB, D)))
        X0 = torch.from_numpy(np.array(j_domain(kd, pj.geometry, K, D)))
        params, opt, aux = step(params, opt, sub)
        j_loss.append(float(aux["loss"]))
        j_vl2.append(float(aux["V_L2"]))
        ts.step(X0=X0, Xb=Xb, host_noise=_noise(kr, K, D, N))
    np.testing.assert_allclose(ts.loss_log, j_loss, rtol=TRAJ_RTOL)
    np.testing.assert_allclose(ts.V_L2_log, j_vl2, rtol=TRAJ_RTOL)
    assert max(ts.K_log) <= K * N
    _assert_params(ts.V_net, params)
