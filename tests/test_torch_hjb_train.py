"""The port's HJBSolver training step against pspde's (CPU).

Both solvers start from the same parameters (the JAX solver's init,
carried over with ``load_jax_params``) and take 20 steps; each JAX step
runs ``_build_step(0)`` on a fresh key, and the port's step gets that
key's rollout noise ``normal(fold_in(kr, n), (K_draw, d))`` as host noise.
The loss and u_L2 trajectories and the control net's parameters must
agree.  Y_0 is not compared: under log-variance its gradient is float32
roundoff (~1e-9), which Adam normalises to steps of +-lr whose signs
depend on the summation order, while the loss does not see Y_0.

The same holds for any z entry whose gradient is roundoff: an antithetic
batch under the moment loss cancels some exactly, and those entries
drift apart by ~1e-4 in 20 steps in the scan engine as in the fused one,
so antithetic pairs are checked under log-variance.

Tolerances: loss and u_L2 rtol 1e-3 per step (measured ~6e-5 after 20
steps: float32 reordering, amplified by Adam's normalisation); z
parameters atol 2e-5 (measured <= 6e-6, against moves of up to 20 lr =
0.2).  Sizes as tests/test_fused_training.py: d=6, K=64, N=12.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pspde.problems as jp
import pspde_torch.problems as tp
from pspde.solvers import HJBSolver as JSolver
from pspde_torch.solvers import HJBSolver as TSolver
from pspde_torch.utils.convert import tanh_mlp_state_dict

K, D, DT, STEPS = 64, 6, 1.0 / 12, 20
N = 12
TRAJ_RTOL, PARAM_ATOL = 1e-3, 2e-5


def _solver_kw(loss_method, antithetic):
    return dict(lr=1e-2, L=STEPS, K=K, delta_t=DT, time_approx="inner",
                loss_method=loss_method, detach_forward=True,
                learn_Y_0=True, verbose=False, early_stopping_time=None,
                antithetic=antithetic)


def _port_solver(engine, jax_params=None, **kw):
    """A port solver on the CPU driving ``engine``, from ``jax_params`` if
    given.  The CPU has no kernels, so 'fused_train' resolves to 'scan'
    (with a warning, as the JAX solver off the TPU); setting the resolved
    engine back drives the solver's fused step - per-step seeds, the fused
    wrapper, antithetic halves - through the wrapper's plain version."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        solver = TSolver("t", tp.LLGC(d=D, T=1.0, device="cpu"),
                         rollout_mode=engine, device="cpu", **kw)
        if jax_params is not None:
            solver.load_jax_params(jax_params)
    solver.resolved_rollout_mode = engine
    return solver


@pytest.mark.parametrize("engine,loss_method,antithetic", [
    ("scan", "log-variance", False),
    ("fused_train", "log-variance", False),
    ("fused_train", "log-variance-y_0", False),
    ("fused_train", "log-variance", True),
    ("scan", "moment", False),
])
def test_twenty_steps_match_jax(engine, loss_method, antithetic):
    kw = _solver_kw(loss_method, antithetic)
    js = JSolver("j", jp.LLGC(d=D, T=1.0), **kw)
    step = jax.jit(js._build_step(0))
    ts = _port_solver(engine, jax.device_get(js.params), **kw)
    params, opt = js.params, js.opt_state
    key = jax.random.PRNGKey(11)
    k_draw = K // 2 if antithetic else K
    j_loss, j_ul2 = [], []
    for _ in range(STEPS):
        key, sub = jax.random.split(key)
        _, kr = jax.random.split(sub)
        noise = np.stack([np.asarray(jax.random.normal(
            jax.random.fold_in(kr, n), (k_draw, D), dtype=jnp.float32))
            for n in range(N)])
        params, opt, m = step(params, opt, sub)
        j_loss.append(float(m["loss"]))
        j_ul2.append(float(m["u_l2"]))
        ts.step(host_noise=torch.from_numpy(noise))
    np.testing.assert_allclose(ts.loss_log, j_loss, rtol=TRAJ_RTOL)
    np.testing.assert_allclose(ts.u_L2_loss, j_ul2, rtol=TRAJ_RTOL)
    assert len(ts.Y_0_log) == STEPS
    want = tanh_mlp_state_dict(jax.device_get(params["z"]))
    got = ts.z_net.state_dict()
    for name, val in want.items():
        np.testing.assert_allclose(got[name].numpy(), val.numpy(), rtol=0,
                                   atol=PARAM_ATOL, err_msg=name)


def test_fused_train_gates_on_cpu():
    """Off CUDA every gate but the device passes for the bench recipe and
    'fused_train' resolves to 'scan' with a warning naming the device;
    LQGC (no u_ref_table) needs u_l2_error_flag=False."""
    kw = _solver_kw("log-variance", False)
    with pytest.warns(UserWarning, match="problem on a CUDA device"):
        s = TSolver("t", tp.LLGC(d=D, T=1.0, device="cpu"),
                    rollout_mode="fused_train", device="cpu", **kw)
    assert s.resolved_rollout_mode == "scan"
    assert s._fused_train_gates() == ["problem on a CUDA device"]
    lqgc = tp.LQGC(d=D, T=1.0, device="cpu")
    with pytest.warns(UserWarning, match="u_l2_error_flag=False"):
        TSolver("t", lqgc, rollout_mode="fused_train", device="cpu",
                **kw)
    s2 = TSolver("t", lqgc, rollout_mode="scan", u_l2_error_flag=False,
                 device="cpu", **kw)
    assert s2._fused_train_gates() == ["problem on a CUDA device"]
    with pytest.warns(UserWarning, match="detach_forward=True"):
        TSolver("t", tp.LLGC(d=D, T=1.0, device="cpu"),
                rollout_mode="fused_train", device="cpu",
                **dict(kw, detach_forward=False))


def test_fused_steps_draw_seeds_from_the_solver_generator():
    """Two solvers with one seed take identical fused steps (the kernels'
    per-step seeds come from the solver's torch.Generator); another seed
    gives another trajectory."""
    def run(seed):
        s = _port_solver("fused_train",
                         **dict(_solver_kw("log-variance", False), L=6,
                                seed=seed))
        s.train()
        return s

    a, b, c = run(3), run(3), run(4)
    assert a.loss_log == b.loss_log and a.u_L2_loss == b.u_L2_loss
    assert a.loss_log != c.loss_log
    assert len(a.loss_log) == 6 and all(np.isfinite(a.loss_log))


def test_early_stopping_rule():
    """pspde's rule: past early_stopping_time steps, stop once the last
    early_stopping_time u_L2 values spread by less than 2% of the last."""
    s = _port_solver("scan", **dict(_solver_kw("log-variance", False),
                                    early_stopping_time=3))
    s.u_L2_loss = [5.0, 1.0, 1.0, 1.01, 1.0]
    assert not s._early_stop(3) and s._early_stop(4)
    s.u_L2_loss = [5.0, 1.0, 1.5, 1.0, 1.2]
    assert not s._early_stop(4)
    s.early_stopping_time = None
    s.u_L2_loss = [1.0] * 5
    assert not s._early_stop(4)
