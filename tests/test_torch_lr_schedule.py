"""Learning-rate schedules in the port's solvers against pspde's (CPU).

``cosine_decay_schedule`` against optax's (rtol 1e-6: optax evaluates it
in float32); 20 ``HJBSolver`` steps under the cosine schedule against
pspde's ``_build_step(0)`` under ``optax.cosine_decay_schedule`` on each
step's own noise, the control net's parameters within 2e-5 (a constant lr
at the schedule's first or last value moves them apart by more than 1e-3);
and ``EllipticSolver`` and ``GeneralSolver`` stepping at lr(i) on update i.
Sizes: d=6, K=64, N=12 (HJB); d=3, K=32, N=6 (the stopped solvers).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import pspde.problems as jp
import pspde_torch.problems as tp
from pspde.solvers import HJBSolver as JSolver
from pspde_torch.solvers import EllipticSolver, GeneralSolver
from pspde_torch.solvers import HJBSolver as TSolver
from pspde_torch.utils import cosine_decay_schedule
from pspde_torch.utils.convert import tanh_mlp_state_dict
from pspde_torch.utils.schedule import apply_lr, lr_at, lr_text

K, D, DT, N, STEPS = 64, 6, 1.0 / 12, 12, 20
PARAM_ATOL = 2e-5


@pytest.mark.parametrize("init,steps,alpha", [(1e-2, 20, 1e-2),
                                              (1e-2, 3000, 3e-4),
                                              (5e-3, 7, 0.0)])
def test_cosine_decay_schedule_matches_optax(init, steps, alpha):
    ours = cosine_decay_schedule(init, steps, alpha)
    theirs = optax.cosine_decay_schedule(init, steps, alpha=alpha)
    for step in [0, 1, steps // 3, steps // 2, steps - 1, steps, steps + 5]:
        np.testing.assert_allclose(ours(step), float(theirs(step)),
                                   rtol=1e-6, atol=1e-10)
    assert ours(0) == init
    np.testing.assert_allclose(ours(10 * steps), init * alpha, atol=1e-12)
    with pytest.raises(ValueError, match="decay_steps"):
        cosine_decay_schedule(1e-2, 0)


def _hjb_kw(lr, lr_y0=None):
    return dict(lr=lr, lr_y0=lr_y0, L=STEPS, K=K, delta_t=DT,
                time_approx="inner", loss_method="log-variance",
                detach_forward=True, learn_Y_0=True, verbose=False,
                early_stopping_time=None)


def _port_hjb(engine, jax_params, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        s = TSolver("t", tp.LLGC(d=D, T=1.0, device="cpu"),
                    rollout_mode=engine, device="cpu", **kw)
        s.load_jax_params(jax_params)
    s.resolved_rollout_mode = engine
    return s


@pytest.mark.parametrize("engine,own_y0", [("scan", False),
                                           ("fused_train", False),
                                           ("scan", True)])
def test_twenty_hjb_steps_under_cosine_match_jax(engine, own_y0):
    alpha = 1e-2
    lr_y0 = 3e-2 if own_y0 else None
    js = JSolver("j", jp.LLGC(d=D, T=1.0), **_hjb_kw(
        optax.cosine_decay_schedule(1e-2, STEPS, alpha=alpha), lr_y0))
    step = jax.jit(js._build_step(0))
    sched = cosine_decay_schedule(1e-2, STEPS, alpha)
    ts = _port_hjb(engine, jax.device_get(js.params),
                   **_hjb_kw(sched, lr_y0))
    const = _port_hjb(engine, jax.device_get(js.params), **_hjb_kw(1e-2))
    params, opt = js.params, js.opt_state
    key = jax.random.PRNGKey(11)
    for i in range(STEPS):
        key, sub = jax.random.split(key)
        _, kr = jax.random.split(sub)
        noise = torch.from_numpy(np.stack([np.asarray(jax.random.normal(
            jax.random.fold_in(kr, n), (K, D), dtype=jnp.float32))
            for n in range(N)]))
        params, opt, _ = step(params, opt, sub)
        ts.step(host_noise=noise)
        const.step(host_noise=noise)
        lrs = [g["lr"] for g in ts.optimizer.param_groups]
        assert lrs[0] == sched(i)
        assert lrs[1] == (3e-2 if own_y0 else sched(i))
    want = tanh_mlp_state_dict(jax.device_get(params["z"]))
    got, off = ts.z_net.state_dict(), const.z_net.state_dict()
    apart = 0.0
    for name, val in want.items():
        np.testing.assert_allclose(got[name].numpy(), val.numpy(), rtol=0,
                                   atol=PARAM_ATOL, err_msg=name)
        apart = max(apart, float((off[name] - val).abs().max()))
    assert apart > 1e-3     # the schedule is what the comparison sees


@pytest.mark.parametrize("cls", [EllipticSolver, GeneralSolver])
def test_stopped_solvers_step_at_the_schedules_lr(cls):
    if cls is EllipticSolver:
        prob = tp.ExponentialOnSphere(d=3, alpha=0.5, device="cpu")
    else:
        prob = tp.ExponentialOnSphereParabolic(d=3, T=0.2, device="cpu")
    sched = cosine_decay_schedule(1e-2, 4, 0.1)
    kw = dict(K=32, K_boundary=8, N=6, delta_t=0.01, L=4, verbose=False,
              device="cpu")
    a, b = cls(prob, "a", lr=sched, **kw), cls(prob, "b", lr=1e-2, **kw)
    assert a.optimizer.param_groups[0]["lr"] == sched(0)
    before = [p.detach().clone() for p in a.V_net.parameters()]
    for i in range(4):
        a.step()
        b.step()
        assert a.optimizer.param_groups[0]["lr"] == sched(i)
        assert b.optimizer.param_groups[0]["lr"] == 1e-2
    # same seed, same draws: the first update is the same, later ones not
    moved = [float((p.detach() - q).abs().max())
             for p, q in zip(a.V_net.parameters(), before)]
    assert max(moved) > 0
    assert a.loss_log[:2] == b.loss_log[:2] and a.loss_log[2:] != \
        b.loss_log[2:]


def test_schedule_helpers():
    assert lr_at(1e-3, 5) == 1e-3 and lr_at(lambda s: 0.5 ** s, 2) == 0.25
    assert lr_text(1e-2) == "1.00e-02" and lr_text(lambda s: 1.0) == \
        "schedule"
    p = torch.nn.Parameter(torch.zeros(2))
    q = torch.nn.Parameter(torch.zeros(2))
    opt = torch.optim.Adam([{"params": [p], "lr": 1.0},
                            {"params": [q], "lr": 2.0}], lr=1.0)
    apply_lr(opt, [lambda s: 10.0 + s, 2.0], 3)
    assert [g["lr"] for g in opt.param_groups] == [13.0, 2.0]
