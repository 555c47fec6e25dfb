"""The port's 'outer' time approximation, value mode, random X_0, the
metastability log and the LQ controls against pspde's (CPU).

* ``LinearLQ`` and ``LinearLQTime`` on parameters converted from a Flax
  tree against the Flax modules: rtol 1e-6.
* value-mode ``hjb_rollout`` (Z = sigma^T grad_x V by autograd, Y_0 =
  V(X_0, 0), the consistency penalty (V(X_n) - Y_n)^2 in add_loss) against
  pspde's on the JAX noise stream, injected, for the 'inner' DenseNet on
  [t, X] and the 'outer' stacked DenseNets on X, with and without a
  detached forward: X 2e-5, Y, u_l2 and add_loss 2e-4, the parameter
  gradients of log-variance + mean(add_loss) rtol 5e-3 (atol 5e-6), the
  JAX suite's kernel-vs-scan tolerances (tests/test_fused_training.py).
* 20 ``HJBSolver`` steps against 20 JAX ``_build_step(0)`` steps fed each
  step's noise and, with ``random_X_0``, its X_0, as
  tests/test_torch_hjb_train.py does: 'outer' with the default DenseNet
  control and with ``LinearLQ``, value mode 'inner' and 'outer',
  ``random_X_0``, and ``DoubleWell`` with ``metastability_logs``.  Loss,
  u_L2 and the metastable fraction rtol 1e-3 per step; parameters atol
  2e-5.  The value cases train a DenseNet (16, 16) under the moment loss
  (tests/test_hjb_solver.py's value-mode loss).  With the default (30, 30)
  some relu^2 units sit at their kink (X_0 = 0, zero biases), and their
  gradient entries are float32 roundoff, which Adam turns into steps of
  up to +-lr whose signs depend on the summation order, as Y_0's under
  log-variance (tests/test_torch_hjb_train.py): single entries then drift
  apart by 1.5e-4 ('inner') to 4e-3 ('outer') within 20 steps while the
  loss agrees within 1e-5; under log-variance the value net's output bias
  is such an entry from the first step (Y_0 = V(X_0, 0) is a constant
  shift, which the loss ignores).  The rollout test above holds the
  default net's gradients.
* tests/test_hjb_solver.py's 'outer', value-mode, random-X_0 and LinearLQ
  convergence cases on the port, from its own init.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pspde.ansatz as ja
import pspde.problems as jp
from pspde.losses.pathspace import log_variance_loss as j_logvar
from pspde.rollout import sde as jsde
from pspde.solvers import HJBSolver as JSolver
import pspde_torch.problems as tp
from pspde_torch.ansatz import DenseNet, LinearLQ, LinearLQTime, TanhMLP
from pspde_torch.losses import log_variance_loss as t_logvar
from pspde_torch.rollout import sde as tsde
from pspde_torch.solvers import HJBSolver as TSolver
from pspde_torch.solvers.hjb import StackedNet
from pspde_torch.utils.convert import (flax_state_dict, linear_lq_from_flax,
                                       linear_lq_time_from_flax)

X_TOL, Y_TOL, G_RTOL, G_ATOL = 2e-5, 2e-4, 5e-3, 5e-6
TRAJ_RTOL, PARAM_ATOL = 1e-3, 2e-5
STEPS = 20


@pytest.mark.parametrize("d", [1, 4])
def test_linear_lq_matches_flax(d):
    rng = np.random.default_rng(d)
    B = (np.eye(d) + 0.2 * rng.standard_normal((d, d))).astype(np.float32)
    Q = (np.eye(d) + 0.1 * np.diag(rng.random(d))).astype(np.float32)
    x = rng.standard_normal((33, d)).astype(np.float32)
    F = rng.standard_normal((d, d)).astype(np.float32)
    net_j = ja.LinearLQ(B=jnp.asarray(B), Q=jnp.asarray(Q))
    want = net_j.apply({"params": {"F": F}}, x)
    net_t = linear_lq_from_flax({"params": {"F": F}}, B, Q, device="cpu")
    np.testing.assert_allclose(net_t(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(want), rtol=1e-6, atol=1e-6)
    # LinearLQTime on [t, x], a Chebyshev basis of degree 5 over T = 0.5
    Fs = rng.standard_normal((6, d, d)).astype(np.float32)
    tx = np.concatenate([rng.random((33, 1)).astype(np.float32) * 0.5, x],
                        axis=1)
    net_j = ja.LinearLQTime(B=jnp.asarray(B), Q=jnp.asarray(Q), T=0.5,
                            degree=5)
    want = net_j.apply({"params": {"F": Fs}}, tx)
    net_t = linear_lq_time_from_flax({"params": {"F": Fs}}, B, Q, 0.5,
                                     device="cpu")
    assert net_t.degree == 5
    np.testing.assert_allclose(net_t(torch.from_numpy(tx)).detach().numpy(),
                               np.asarray(want), rtol=1e-6, atol=1e-6)


def test_lq_inits():
    """LinearLQ's F is N(0, init_scale^2) from the generator, LinearLQTime's
    zero, as the Flax inits."""
    p = tp.LQGC(d=3, T=0.5, delta_t=0.05, device="cpu")
    a = LinearLQ(p.B, p.Q, generator=torch.Generator().manual_seed(1),
                 device="cpu")
    b = LinearLQ(p.B, p.Q, generator=torch.Generator().manual_seed(1),
                 device="cpu")
    assert torch.equal(a.F, b.F) and float(a.F.detach().std()) > 0.3
    assert float(LinearLQ(p.B, p.Q, init_scale=0.0, device="cpu")
                 .F.abs().max()) == 0.0
    from pspde_torch.ansatz import DenseNet, LinearLQTime
    assert float(LinearLQTime(p.B, p.Q, 0.5, device="cpu").F.abs().max()) \
        == 0.0
    assert [n for n, _ in a.named_parameters()] == ["F"]


def _jax_noise(key, K, d, N):
    return np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(key, n), (K, d), dtype=jnp.float32))
        for n in range(N)])


def _port_state(net):
    """The port net's parameters by state_dict name (stacked or not)."""
    if isinstance(net, StackedNet):
        return dict(zip(net._names, net.stacked))
    return dict(net.named_parameters())


def _assert_tree_close(got: dict, module, jax_tree, rtol, atol, what):
    want = flax_state_dict(module, jax.device_get(jax_tree))
    for name, val in got.items():
        np.testing.assert_allclose(val.detach().numpy(), want[name].numpy(),
                                   rtol=rtol, atol=atol,
                                   err_msg=f"{what} {name}")


def _template(net):
    return net.template if isinstance(net, StackedNet) else net


def _pair(problem_fn, **kw):
    """A JAX solver and the port's on the same parameters."""
    js = JSolver("j", problem_fn(jp), **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ts = TSolver("t", problem_fn(tp, device="cpu"), device="cpu", **kw)
    ts.load_jax_params(jax.device_get(js.params))
    return js, ts


def _llgc(m, **kw):
    return m.LLGC(d=3, T=1.0, **kw)


@pytest.mark.parametrize("time_approx,detach", [
    ("inner", True), ("inner", False), ("outer", True), ("outer", False)])
def test_value_mode_rollout_matches_jax(time_approx, detach):
    K, dt = 48, 0.1
    js, ts = _pair(_llgc, K=K, delta_t=dt, approx_method="value_function",
                   time_approx=time_approx, detach_forward=detach,
                   verbose=False, early_stopping_time=None)
    N, d = js.N, 3
    cfg_kw = dict(N=N, delta_t=dt, detach_forward=detach, value_mode=True)
    key = jax.random.PRNGKey(5)
    noise = _jax_noise(key, K, d, N)
    ts_ = np.arange(N) * dt
    u_ref_j, u_ref_t = js.problem.u_ref_fn(ts_), ts.problem.u_ref_fn(ts_)
    X0 = (0.5 * np.random.default_rng(3).standard_normal((K, d))).astype(
        np.float32)
    ctrl_j, y_init = js._control_fn(), js._y_init_fn()

    def run_j(params):
        out = jsde.hjb_rollout(jsde.HJBRolloutConfig(**cfg_kw), js.problem,
                               ctrl_j, params, jnp.asarray(X0),
                               y_init(params, jnp.asarray(X0)), key,
                               u_ref=u_ref_j)
        loss = (j_logvar(out.Y, js.problem.g(out.X))
                + jnp.mean(out.add_loss))
        return loss, out

    (_, out_j), g_j = jax.value_and_grad(run_j, has_aux=True)(js.params)
    X0_t, Y0_t = ts._initial_state(torch.from_numpy(X0))
    out_t = tsde.hjb_rollout(tsde.HJBRolloutConfig(**cfg_kw), ts.problem,
                             ts._control_fn(), X0_t, Y0_t, u_ref=u_ref_t,
                             host_noise=torch.from_numpy(noise))
    np.testing.assert_allclose(out_t.X.detach(), out_j.X, rtol=X_TOL,
                               atol=X_TOL)
    for name in ("Y", "u_l2", "add_loss"):
        np.testing.assert_allclose(getattr(out_t, name).detach(),
                                   getattr(out_j, name), rtol=Y_TOL,
                                   atol=Y_TOL, err_msg=name)
    assert float(out_t.add_loss.min()) > 0.0
    loss_t = (t_logvar(out_t.Y, ts.problem.g(out_t.X))
              + torch.mean(out_t.add_loss))
    params = _port_state(ts.y_net)
    grads = torch.autograd.grad(loss_t, list(params.values()))
    _assert_tree_close(dict(zip(params, grads)), _template(ts.y_net),
                       g_j["y"], G_RTOL, G_ATOL, "gradient")


def _lqgc(m, **kw):
    return m.LQGC(d=3, T=0.5, delta_t=0.05, **kw)


def _dw(m, **kw):
    p = m.DoubleWell(d=1, T=0.5, eta=1.0, kappa=1.0, **kw)
    p.compute_reference_solution(delta_t=0.05, nx=400)
    return p


def _lq_net(m, p, **kw):
    return m.LinearLQ(B=p.B, Q=p.Q, **kw)


CASES = {
    # problem, solver kwargs
    "outer_dense_control": (_llgc, dict(time_approx="outer", learn_Y_0=True)),
    "outer_linear_lq": (_lqgc, dict(time_approx="outer")),
    "value_inner": (_llgc, dict(time_approx="inner",
                                approx_method="value_function",
                                loss_method="moment")),
    "value_outer": (_llgc, dict(time_approx="outer",
                                approx_method="value_function",
                                loss_method="moment")),
    "random_x0": (_llgc, dict(time_approx="inner", random_X_0=True,
                              learn_Y_0=True)),
    "double_well_meta": (_dw, dict(time_approx="inner",
                                   metastability_logs=(np.ones(1), 0.5))),
}


@pytest.mark.parametrize("case", list(CASES))
def test_twenty_steps_match_jax(case):
    problem_fn, extra = CASES[case]
    K, dt = 64, 0.05
    kw = dict(lr=1e-2, L=STEPS, K=K, delta_t=dt,
              loss_method="log-variance", detach_forward=True,
              verbose=False, early_stopping_time=None)
    kw.update(extra)
    pj = problem_fn(jp)
    pt = problem_fn(tp, device="cpu")
    if case == "outer_linear_lq":
        kw_j = dict(kw, control_net=_lq_net(ja, pj))
        kw_t = dict(kw, control_net=LinearLQ(pt.B, pt.Q, device="cpu"))
    elif case.startswith("value"):
        d_in = pt.d + (kw["time_approx"] == "inner")
        kw_j = dict(kw, value_net=ja.DenseNet(d_out=1, arch=(16, 16)))
        kw_t = dict(kw, value_net=DenseNet(1, (16, 16), d_in=d_in,
                                           device="cpu"))
    else:
        kw_j = kw_t = kw
    js = JSolver("j", pj, **kw_j)
    ts = TSolver("t", pt, device="cpu", **kw_t)
    ts.load_jax_params(jax.device_get(js.params))
    step = jax.jit(js._build_step(0))
    params, opt = js.params, js.opt_state
    key = jax.random.PRNGKey(11)
    j_loss, j_ul2, j_meta = [], [], []
    for _ in range(STEPS):
        key, sub = jax.random.split(key)
        kx, kr = jax.random.split(sub)
        noise = _jax_noise(kr, K, pj.d, js.N)
        X0 = None
        if kw.get("random_X_0"):
            X0 = torch.from_numpy(np.array(jax.random.normal(
                kx, (K, pj.d), dtype=jnp.float32)))
        params, opt, m = step(params, opt, sub)
        j_loss.append(float(m["loss"]))
        j_ul2.append(float(m["u_l2"]))
        if "meta_frac" in m:
            j_meta.append(float(m["meta_frac"]))
        ts.step(host_noise=torch.from_numpy(noise), X0=X0)
    np.testing.assert_allclose(ts.loss_log, j_loss, rtol=TRAJ_RTOL)
    np.testing.assert_allclose(ts.u_L2_loss, j_ul2, rtol=TRAJ_RTOL)
    np.testing.assert_allclose(ts.particles_close_to_target, j_meta,
                               rtol=TRAJ_RTOL)
    if case == "double_well_meta":
        assert len(j_meta) == STEPS and max(j_meta) > 0.0
    key_ = "z" if ts.approx_method == "control" else "y"
    _assert_tree_close(_port_state(ts._net), _template(ts._net),
                       params[key_], 0, PARAM_ATOL, "parameter")


def test_outer_and_value_model_structure():
    """'outer' holds N control sets (N + 1 value sets) stacked, each step
    its own draw by default; Z_n, u and Y_n evaluate step ceil(t / dt);
    the fused gate names what 'outer', value mode and random_X_0 fail."""
    pt = tp.LLGC(d=2, T=1.0, device="cpu")
    s = TSolver("o", pt, K=16, delta_t=0.1, device="cpu", verbose=False)
    assert isinstance(s.z_net, StackedNet) and s.z_net.n_copies == 10
    w = s.z_net.stacked[0]
    assert w.shape[0] == 10 and not torch.equal(w[0], w[1])
    X = torch.randn(5, 2)
    np.testing.assert_array_equal(s.Z_n(X, 0.25).numpy(),
                                  s.z_net(X, 3).detach().numpy())
    # past the last step the last set answers, as select_step clips
    np.testing.assert_array_equal(s.z_net(X, 99).detach().numpy(),
                                  s.z_net(X, 9).detach().numpy())
    v = TSolver("v", pt, K=16, delta_t=0.1, approx_method="value_function",
                device="cpu", verbose=False)
    assert v.y_net.n_copies == 11
    np.testing.assert_array_equal(v.Y_n(X, 1.0).numpy(),
                                  v.y_net(X, 10)[:, 0].detach().numpy())
    Z = v.Z_n(X, 0.25)
    Xg = X.clone().requires_grad_(True)
    (gX,) = torch.autograd.grad(v.y_net(Xg, 3)[:, 0].sum(), Xg)
    np.testing.assert_allclose(Z.numpy(), gX.numpy(), rtol=1e-6)
    with pytest.warns(UserWarning, match="fell back"):
        f = TSolver("f", pt, K=16, delta_t=0.1, approx_method="value_function",
                    random_X_0=True, rollout_mode="fused_train",
                    detach_forward=True, device="cpu")
    gates = f._fused_train_gates()
    for gate in ("approx_method='control'", "time_approx='inner'",
                 "random_X_0=False"):
        assert gate in gates
    with pytest.raises(ValueError, match="time_approx"):
        TSolver("x", pt, time_approx="middle", device="cpu")
    # IS_variance_K is ported; plot_trajectories is not and raises
    assert TSolver("x", pt, IS_variance_K=10, device="cpu").IS_variance_K \
        == 10
    with pytest.raises(NotImplementedError, match="plot_trajectories"):
        TSolver("x", pt, plot_trajectories=10, device="cpu")


@pytest.mark.parametrize("kind", ["dense", "linear_lq", "tanh_mlp",
                                  "linear_lq_time"])
def test_outer_given_net_draws_each_step(kind):
    """A control net given for 'outer' keeps its parameters at step 0 and
    every other step is its own draw of the net's configuration from the
    solver's generator, as init_stacked draws N sets of the module (zero
    for LinearLQTime, whose init is zero); the same seed draws the same
    sets."""
    pt = tp.LQGC(d=2, T=0.5, delta_t=0.1, device="cpu")
    g = torch.Generator().manual_seed(7)

    def net():
        return {"dense": lambda: DenseNet(d_out=2, arch=(8,), d_in=2,
                                          weight_scale=0.3, generator=g,
                                          device="cpu"),
                "linear_lq": lambda: LinearLQ(pt.B, pt.Q, generator=g,
                                              device="cpu"),
                "tanh_mlp": lambda: TanhMLP(2, 2, hidden=(8,), generator=g,
                                            device="cpu"),
                "linear_lq_time": lambda: LinearLQTime(pt.B, pt.Q, 0.5,
                                                       degree=3,
                                                       device="cpu")}[kind]()

    given = net()
    s = TSolver("o", pt, K=16, delta_t=0.1, control_net=given, seed=3,
                device="cpu", verbose=False)
    again = TSolver("o", pt, K=16, delta_t=0.1, control_net=given, seed=3,
                    device="cpu", verbose=False)
    assert s.z_net.n_copies == 5
    for (name, p), leaf, twin in zip(given.named_parameters(),
                                     s.z_net.stacked, again.z_net.stacked):
        assert leaf.shape == (5,) + tuple(p.shape)
        torch.testing.assert_close(leaf[0], p.detach(), rtol=0, atol=0)
        torch.testing.assert_close(leaf, twin, rtol=0, atol=0)
        for n in range(1, 5):
            if kind == "linear_lq_time":
                assert not torch.any(leaf[n])
            elif name.endswith("weight") or name == "F":
                assert not torch.equal(leaf[n], leaf[0]), (name, n)
                assert not torch.equal(leaf[n], leaf[n - 1]), (name, n)


# -- tests/test_hjb_solver.py's cases on the port ---------------------------

def _solver(loss_method="log-variance", **kw):
    defaults = dict(lr=1e-2, L=150, K=256, delta_t=0.05,
                    time_approx="inner", learn_Y_0=True, print_every=1000,
                    early_stopping_time=None, verbose=False, device="cpu")
    defaults.update(kw)
    p = defaults.pop("problem", None) or tp.LLGC(d=1, T=1.0, device="cpu")
    return TSolver("t", p, loss_method=loss_method, **defaults)


def test_outer_time_approx():
    torch.manual_seed(0)
    s = _solver("log-variance", time_approx="outer", delta_t=0.1, L=150)
    s.train()
    assert s.u_L2_loss[-1] < 0.1


def test_value_function_mode():
    torch.manual_seed(0)
    s = _solver("moment", approx_method="value_function", learn_Y_0=False,
                delta_t=0.1, L=150, lr=3e-3)
    s.train()
    assert np.isfinite(s.loss_log[-1])
    assert s.loss_log[-1] < s.loss_log[0]


def test_detach_forward_and_random_x0():
    torch.manual_seed(0)
    s = _solver("log-variance", detach_forward=True, random_X_0=True, L=80)
    s.train()
    assert np.isfinite(s.loss_log[-1])


def test_lqgc_linear_ansatz_converges():
    torch.manual_seed(0)
    p = tp.LQGC(d=2, T=0.5, delta_t=0.05, device="cpu")
    net = LinearLQ(B=p.B, Q=p.Q, device="cpu",
                   generator=torch.Generator().manual_seed(0))
    s = TSolver("lq", p, lr=1e-2, L=400, K=512, delta_t=0.05,
                time_approx="outer", loss_method="log-variance",
                control_net=net, learn_Y_0=False, verbose=False,
                detach_forward=True, early_stopping_time=None, device="cpu")
    s.train()
    assert s.u_L2_loss[-1] < 0.3 * s.u_L2_loss[0]
