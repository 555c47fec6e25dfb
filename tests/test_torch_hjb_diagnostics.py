"""The rest of the port's HJB training loop and the loss-study
diagnostics against pspde's (CPU).

* ``hjb_rollout``'s repa phases, reparametrization sum and Burgers drift
  against pspde's scan on JAX's noise stream, injected: X rtol 2e-5, Y and
  Z_sum 2e-4, the loss gradients rtol 5e-3 (atol 5e-6), the JAX suite's
  kernel-vs-scan tolerances (tests/test_fused_training.py).
* The sqrt schedule of ``_remat_scan``: outputs, gradients and the
  generator's state bitwise those of the per-step schedule, engaged by
  the threshold and by the byte budget, for ``hjb_rollout`` and
  ``stopped_rollout``, and in solver steps of both approximations.
* 20 ``HJBSolver`` steps against JAX's ``_build_step(phase)`` on each
  step's JAX noise, for 'log-variance-repa', 'reparametrization', the
  Burgers drift and 'relative_entropy_log-variance' in its phase 1: loss
  and u_L2 rtol 2e-4, the net's parameters atol 2e-5.
* ``train_LSE_with_reference`` against JAX (losses rtol 1e-3: 300 Adam
  steps on float32 sums in another order) and the JAX suite's own check.
* ``log_gradient``'s flat gradient, mapped to JAX's leaf order through
  the converter, rtol 1e-3 over 5 steps (atol 1e-6).
* ``gradient_variances`` (moment, log-variance) on JAX's noise, rtol 5e-3
  where JAX's mean gradient stands clear of 0 (elsewhere a ratio of two
  roundoff-sized numbers).
* The diagnostics leave the training trajectory exactly as it is.
* The IS runner against ``importance_sampling`` on the same generator
  state (exact); ``_qmc_noise`` bitwise pspde's, ``importance_sampling(qmc
  =True)`` within rtol 1e-5 of pspde's at the same scramble seed.
* ``loss_estimator_statistics`` on JAX's noise: means and variances rtol
  1e-4, ``var_var`` rtol 1e-3 (a fourth central moment from raw moments:
  c4 - var^2 cancels ~3 digits of float32 column sums); and
  tests/test_eval_diagnostics.py's cases on the port.

Sizes: d <= 4, K <= 64, N <= 12 (the dimension-scaling case: K=200000).
"""

import dataclasses
import functools
import importlib
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pspde.ansatz as ja
import pspde.problems as jp
from pspde.eval import estimator_stats as jes
from pspde.eval import gradient_variance as jgv
from pspde.losses.pathspace import hjb_loss as j_hjb_loss
from pspde.rollout import sde as jsde
from pspde.solvers import HJBSolver as JSolver
import pspde_torch.problems as tp
from pspde_torch.ansatz import DenseNet as TDenseNet
from pspde_torch.eval import estimator_stats as tes
from pspde_torch.eval import gradient_variance as tgv
from pspde_torch.losses.pathspace import hjb_loss as t_hjb_loss
from pspde_torch.rollout import sde as tsde
from pspde_torch.solvers import HJBSolver as TSolver
from pspde_torch.utils.convert import (flax_state_dict, tanh_mlp_from_flax,
                                       tanh_mlp_state_dict)

# the modules (the packages' __init__ binds the names to the functions)
jis = importlib.import_module("pspde.eval.importance_sampling")
tis = importlib.import_module("pspde_torch.eval.importance_sampling")

D, K, N, DT = 4, 64, 12, 1.0 / 12
X_TOL, Y_TOL, G_RTOL, G_ATOL = 2e-5, 2e-4, 5e-3, 5e-6
TRAJ_RTOL, PARAM_ATOL = 2e-4, 2e-5


def _tree(d=D, seed=0, hidden=(30, 30), scale=0.3):
    """A TanhMLP parameter tree on [t, x] with N(0, scale^2 / fan_in)
    entries."""
    rng = np.random.default_rng(seed)
    widths = (d + 1,) + hidden + (d,)
    return {"params": {f"Dense_{i}": {
        "kernel": (scale * rng.standard_normal((a, b)) / np.sqrt(a)).astype(
            np.float32),
        "bias": (scale * rng.standard_normal(b)).astype(np.float32)}
        for i, (a, b) in enumerate(zip(widths[:-1], widths[1:]))}}


def _jax_noise(key, k, n=N, d=D):
    return np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(key, i), (k, d), dtype=jnp.float32))
        for i in range(n)])


def _close(a, b, rtol, atol, msg=""):
    np.testing.assert_allclose(np.asarray(a, dtype=np.float64),
                               np.asarray(b, dtype=np.float64), rtol=rtol,
                               atol=atol, err_msg=msg)


# -- the rollout's new options -------------------------------------------------

ROLLOUTS = {
    # name: (config fields, loss method, phase)
    "repa_phase0": (dict(repa_phase=0), "log-variance-repa", 0),
    "repa_phase1": (dict(repa_phase=1), "log-variance-repa", 1),
    "reparametrization": (dict(reparametrization=True),
                          "reparametrization", 0),
    "burgers": (dict(burgers_drift=True), "log-variance", 0),
    "burgers_detached": (dict(burgers_drift=True, detach_forward=True),
                         "moment", 0),
}


@pytest.mark.parametrize("name", sorted(ROLLOUTS))
def test_rollout_options_match_jax(name):
    fields, loss, phase = ROLLOUTS[name]
    pj, pt = jp.LLGC(d=D, T=1.0), tp.LLGC(d=D, T=1.0, device="cpu")
    tree = _tree()
    net_j, net_t = ja.TanhMLP(d_out=D), tanh_mlp_from_flax(tree,
                                                           device="cpu")
    cfg_kw = dict(N=N, delta_t=DT, **fields)
    cfg_j, cfg_t = (jsde.HJBRolloutConfig(**cfg_kw),
                    tsde.HJBRolloutConfig(**cfg_kw))
    key = jax.random.PRNGKey(3)
    noise = torch.from_numpy(_jax_noise(key, K))
    Y0 = np.full((K,), 0.3, np.float32)

    def ctrl_j(params, X, n, t):
        tX = jnp.concatenate([jnp.zeros((X.shape[0], 1)) + t, X], axis=1)
        return net_j.apply(params, tX), None

    def run_j(params):
        out = jsde.hjb_rollout(cfg_j, pj, ctrl_j, params,
                               jnp.broadcast_to(pj.X_0, (K, D)),
                               jnp.asarray(Y0), key)
        return j_hjb_loss(loss, out.Y, pj.g(out.X), out.Z_sum,
                          phase=phase), out

    def ctrl_t(X, n, t):
        return net_t(torch.cat([torch.full((X.shape[0], 1), t), X],
                               dim=1)), None

    (_, out_j), g_j = jax.value_and_grad(run_j, has_aux=True)(tree)
    out_t = tsde.hjb_rollout(cfg_t, pt, ctrl_t, pt.X_0.expand(K, D),
                             torch.from_numpy(Y0), host_noise=noise)
    _close(out_t.X.detach(), out_j.X, X_TOL, X_TOL, "X")
    for f in ("Y", "Z_sum"):
        _close(getattr(out_t, f).detach(), getattr(out_j, f), Y_TOL, Y_TOL,
               f)
    if fields.get("reparametrization"):
        assert float(out_t.Z_sum.abs().max()) > 0.0
    g_t = torch.autograd.grad(
        t_hjb_loss(loss, out_t.Y, pt.g(out_t.X), out_t.Z_sum, phase=phase),
        list(net_t.parameters()))
    want = tanh_mlp_state_dict(jax.device_get(g_j))
    for (pname, _), g in zip(net_t.named_parameters(), g_t):
        _close(g, want[pname].numpy(), G_RTOL, G_ATOL, pname)


# -- the sqrt schedule ---------------------------------------------------------

def _hjb_run(remat, gen_seed, **kw):
    """Outputs, loss gradients and the generator's state after a
    differentiated hjb_rollout on generator noise (LLGC d=3, K=16, N=30,
    the value of Y differentiated through an adaptive, undetached
    forward process)."""
    pt = tp.LLGC(d=3, T=1.0, device="cpu")
    net = tanh_mlp_from_flax(_tree(d=3, seed=5), device="cpu")
    cfg = tsde.HJBRolloutConfig(N=30, delta_t=1 / 30, remat=remat,
                                accumulate_kl=True)
    gen = torch.Generator().manual_seed(gen_seed)

    def ctrl(X, n, t):
        return net(torch.cat([torch.full((X.shape[0], 1), t), X],
                             dim=1)), None

    out = tsde.hjb_rollout(cfg, pt, ctrl, pt.X_0.expand(16, 3),
                           torch.zeros(16), generator=gen, **kw)
    loss = torch.mean((out.Y - pt.g(out.X)) ** 2) + torch.mean(out.Z_sum)
    grads = torch.autograd.grad(loss, list(net.parameters()))
    return [t.detach() for t in out] + list(grads), gen.get_state()


def _stopped_run(remat, **kw):
    """The same for stopped_rollout (ExponentialOnBallNonlinearSin d=3,
    K=16, N=25, the diffusion loss through the second-order Z)."""
    pt = tp.ExponentialOnBallNonlinearSin(d=3, alpha=0.1, device="cpu")
    net = TDenseNet(d_out=1, d_in=3, generator=torch.Generator()
                    .manual_seed(2), device="cpu")
    cfg = tsde.StoppedRolloutConfig(N=25, delta_t=0.01, remat=remat,
                                    adaptive_forward=True)
    from pspde_torch.rollout.sampling import inside_fn, sample_domain
    gen = torch.Generator().manual_seed(9)
    X0 = sample_domain(torch.Generator().manual_seed(1), pt.geometry, 16, 3)
    vz = tsde.value_and_z(net, pt.sigma_struct)
    out = tsde.stopped_rollout(cfg, pt, vz, X0, net(X0)[:, 0],
                               torch.zeros(16),
                               inside_fn(pt.geometry),
                               generator=gen, **kw)
    loss = torch.mean((net(out.X)[:, 0] - out.Y) ** 2)
    grads = torch.autograd.grad(loss, list(net.parameters()))
    return [t.detach() for t in out] + list(grads), gen.get_state()


@pytest.mark.parametrize("kind,engage", [
    ("hjb", dict(remat_threshold=4)),
    ("hjb", dict(remat_threshold=29)),
    ("hjb", dict(carry_budget_bytes=30 * 4 * 16 * 7 - 1)),
    ("stopped", dict(remat_threshold=3)),
    ("stopped", dict(carry_budget_bytes=1)),
])
def test_sqrt_schedule_bitwise_per_step(kind, engage, monkeypatch):
    """The chunked schedule (engaged by the threshold, or by the byte
    budget: 30 steps of a 16 x (3 + 4)-float carry pass a budget one byte
    short of them) gives bitwise the outputs, gradients and generator
    state of the per-step schedule and of no recomputation; a chunk's
    recomputation draws its noise from a replica of the generator."""
    run = _hjb_run if kind == "hjb" else _stopped_run
    args = (0,) if kind == "hjb" else ()
    made = []
    real = tsde._replica
    monkeypatch.setattr(tsde, "_replica",
                        lambda g, s: made.append(1) or real(g, s))
    want, state = run(False, *args)
    per_step, state_p = run(True, *args, carry_budget_bytes=1 << 40)
    assert not made
    got, state_c = run(True, *args, **engage)
    assert made, "the chunked schedule did not engage"
    for a, b, c in zip(want, per_step, got):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert torch.equal(state, state_p) and torch.equal(state, state_c)


@pytest.mark.parametrize("approx", ["control", "value_function"])
def test_sqrt_schedule_in_solver_steps(approx, monkeypatch):
    """Three HJBSolver steps with the schedule engaged (the rollout's
    threshold 4, N=20: 4 chunks) give bitwise the losses and parameters of
    the per-step schedule; value mode differentiates V inside its step, and
    its chunks are recomputed several times, each from a new replica.
    Engagement is read from the replicas made, not predicted."""
    import pspde_torch.solvers.hjb as thjb
    made = []
    real = tsde._replica
    monkeypatch.setattr(tsde, "_replica",
                        lambda g, s: made.append(1) or real(g, s))

    def run(threshold):
        monkeypatch.setattr(thjb, "hjb_rollout", functools.partial(
            tsde.hjb_rollout, remat_threshold=threshold))
        made.clear()
        s = TSolver("v", tp.LLGC(d=3, T=1.0, device="cpu"), K=16,
                    delta_t=1 / 20, time_approx="inner", approx_method=approx,
                    remat=True, L=3, detach_forward=False, verbose=False,
                    early_stopping_time=None, device="cpu")
        s.train()
        return s, len(made)

    (a, made_a), (b, made_b) = run(2048), run(4)
    assert made_b and not made_a
    assert a.loss_log == b.loss_log
    for p, q in zip(a._net.parameters(), b._net.parameters()):
        assert torch.equal(p, q)


def test_sqrt_schedule_threshold_rule():
    """N > threshold engages it and N <= threshold does not (the budget
    open), as JAX's rule."""
    made = []
    real = tsde._replica
    try:
        tsde._replica = lambda g, s: made.append(1) or real(g, s)
        _hjb_run(True, 0, remat_threshold=30, carry_budget_bytes=1 << 40)
        assert not made
        _hjb_run(True, 0, remat_threshold=29, carry_budget_bytes=1 << 40)
        assert made
    finally:
        tsde._replica = real


# -- 20 solver steps -----------------------------------------------------------

SOLVER_CASES = {
    "log-variance-repa": dict(loss_method="log-variance-repa",
                              detach_forward=False),
    "reparametrization": dict(loss_method="reparametrization",
                              detach_forward=False),
    "burgers": dict(loss_method="log-variance", burgers_drift=True,
                    detach_forward=False),
    "relative_entropy_log-variance": dict(
        loss_method="relative_entropy_log-variance", detach_forward=False),
}


@pytest.mark.parametrize("case", sorted(SOLVER_CASES))
def test_twenty_solver_steps_match_jax(case):
    """Both solvers from JAX's init; each JAX step is ``_build_step(phase)``
    on a fresh key and the port's step takes that key's rollout noise.
    'relative_entropy_log-variance' starts at iteration 1000, its phase
    1."""
    kw = dict(lr=1e-3, L=20, K=K, delta_t=DT, time_approx="inner",
              learn_Y_0=False, verbose=False, early_stopping_time=None,
              **SOLVER_CASES[case])
    js = JSolver("j", jp.LLGC(d=D, T=1.0), **kw)
    ts = TSolver("t", tp.LLGC(d=D, T=1.0, device="cpu"), device="cpu", **kw)
    ts.load_jax_params(jax.device_get(js.params))
    start = 1000 if case == "relative_entropy_log-variance" else 0
    ts.iteration = start
    steps = {}
    params, opt = js.params, js.opt_state
    key = jax.random.PRNGKey(13)
    j_loss, j_ul2 = [], []
    for i in range(20):
        phase = js._phase(start + i)
        if phase not in steps:
            steps[phase] = jax.jit(js._build_step(phase))
        key, sub = jax.random.split(key)
        _, kr = jax.random.split(sub)
        noise = _jax_noise(kr, K)
        params, opt, m = steps[phase](params, opt, sub)
        j_loss.append(float(m["loss"]))
        j_ul2.append(float(m["u_l2"]))
        ts.step(host_noise=torch.from_numpy(noise))
    _close(ts.loss_log, j_loss, TRAJ_RTOL, 1e-7, "loss")
    _close(ts.u_L2_loss, j_ul2, TRAJ_RTOL, 1e-7, "u_L2")
    want = tanh_mlp_state_dict(jax.device_get(params["z"]))
    for name, val in ts.z_net.state_dict().items():
        _close(val, want[name].numpy(), 0.0, PARAM_ATOL, name)


def test_reparametrization_detached_has_zero_gradient():
    """With detach_forward the reparametrization loss reaches no parameter:
    JAX's gradient is zero and Adam leaves the net as it is; the port
    steps on zero gradients alike instead of raising."""
    s = TSolver("r", tp.LLGC(d=2, T=0.5, device="cpu"), K=16, delta_t=0.1,
                time_approx="inner", loss_method="reparametrization",
                detach_forward=True, learn_Y_0=True, L=3, verbose=False,
                early_stopping_time=None, device="cpu")
    before = [p.detach().clone() for p in s.z_net.parameters()]
    s.train()
    assert len(s.loss_log) == 3 and all(np.isfinite(s.loss_log))
    for p, q in zip(before, s.z_net.parameters()):
        assert torch.equal(p, q)


# -- train_LSE_with_reference --------------------------------------------------

def test_train_lse_with_reference_matches_jax():
    """The supervised fit against JAX's from one init (losses rtol 1e-3),
    and tests/test_misc_coverage.py:14-26's own check on the port."""
    kw = dict(L=300, lr=1e-2, K=32, delta_t=0.05, time_approx="inner",
              verbose=False, early_stopping_time=None)
    js = JSolver("lse", jp.LLGC(d=1, T=0.5), **kw)
    ts = TSolver("lse", tp.LLGC(d=1, T=0.5, device="cpu"), device="cpu",
                 **kw)
    ts.load_jax_params(jax.device_get(js.params))
    js.train_LSE_with_reference(xb=2.0, n_grid=100)
    ts.train_LSE_with_reference(xb=2.0, n_grid=100)
    _close(ts.loss_log, js.loss_log, 1e-3, 1e-6, "LSE loss")
    assert ts.loss_log[-1] < 0.05 * ts.loss_log[0]
    X = torch.linspace(-1.0, 1.0, 21)[:, None]
    u_fit = -ts.Z_n(X, 0.1).numpy()
    u_true = ts._u_ref(X, 3).numpy()
    np.testing.assert_allclose(u_fit, u_true, atol=0.15)


# -- log_gradient ---------------------------------------------------------------

def test_log_gradient_matches_jax():
    """gradient_log against JAX's grad_flat, five steps: JAX's flat vector
    unflattened to its tree, mapped to the port's parameters by the
    converter, flattened in their order."""
    kw = dict(lr=1e-2, L=5, K=K, delta_t=DT, time_approx="inner",
              loss_method="log-variance", detach_forward=True,
              learn_Y_0=True, verbose=False, early_stopping_time=None,
              log_gradient=True)
    js = JSolver("j", jp.LLGC(d=D, T=1.0), **kw)
    ts = TSolver("t", tp.LLGC(d=D, T=1.0, device="cpu"), device="cpu", **kw)
    ts.load_jax_params(jax.device_get(js.params))
    step = jax.jit(js._build_step(0))
    params, opt = js.params, js.opt_state
    treedef = jax.tree.structure(params["z"])
    shapes = [np.shape(x) for x in jax.tree.leaves(params["z"])]
    key = jax.random.PRNGKey(21)
    for _ in range(5):
        key, sub = jax.random.split(key)
        _, kr = jax.random.split(sub)
        params, opt, m = step(params, opt, sub)
        ts.step(host_noise=torch.from_numpy(_jax_noise(kr, K)))
        flat = np.asarray(m["grad_flat"])
        leaves, i = [], 0
        for shp in shapes:
            n = int(np.prod(shp))
            leaves.append(flat[i:i + n].reshape(shp))
            i += n
        want = tanh_mlp_state_dict(jax.tree.unflatten(treedef, leaves))
        want = np.concatenate([want[name].numpy().ravel() for name, _ in
                               ts.z_net.named_parameters()])
        got = ts.gradient_log[-1]
        assert got.dtype == np.float32 and got.shape == want.shape
        _close(got, want, 1e-3, 1e-6, "grad_flat")
    assert len(ts.gradient_log) == 5


# -- gradient_variances -----------------------------------------------------------

def _outer_pair(loss, d=2, T=0.4, dt=0.1, k=64):
    kw = dict(L=1, K=k, delta_t=dt, time_approx="outer", loss_method=loss,
              verbose=False, early_stopping_time=None)
    js = JSolver("g", jp.LLGC(d=d, T=T), **kw)
    ts = TSolver("g", tp.LLGC(d=d, T=T, device="cpu"), device="cpu", **kw)
    ts.load_jax_params(jax.device_get(js.params))
    return js, ts


def _column_map(ts, js):
    """Port column j of the (N, p) matrix -> JAX's column: JAX's leaves
    filled with their flat indices, converted to the port's template."""
    leaves = jax.tree.leaves(js.params["z"])
    sizes = [int(np.prod(np.shape(x)[1:])) for x in leaves]
    ids, start = [], 0
    for x, n in zip(leaves, sizes):
        ids.append(np.arange(start, start + n, dtype=np.float64)
                   .reshape(np.shape(x)[1:]))
        start += n
    tree = jax.tree.unflatten(jax.tree.structure(js.params["z"]), ids)
    sd = flax_state_dict(ts.z_net.template, tree)
    return np.concatenate([sd[name].numpy().ravel().astype(np.int64)
                           for name in ts.z_net._names])


@pytest.mark.parametrize("loss", ["moment", "log-variance"])
def test_gradient_variances_match_jax(loss):
    js, ts = _outer_pair(loss)
    key = jax.random.PRNGKey(4)
    rel_j = np.asarray(jgv.gradient_variances(js, key))
    noise = torch.from_numpy(_jax_noise(key, 64, n=ts.N, d=2))
    rel_t = tgv.gradient_variances(ts, host_noise=noise).numpy()
    rel_j = rel_j[:, _column_map(ts, js)]
    assert rel_t.shape == rel_j.shape == (ts.N, rel_t.shape[1])
    # the mean gradient of each column, to leave out ratios of roundoff
    clear = np.abs(rel_j) < 1e3
    assert clear.mean() > 0.5
    _close(rel_t[clear], rel_j[clear], G_RTOL, 1e-6)


def test_gradient_variances_shape_and_finite():
    """tests/test_eval_diagnostics.py:16-27 on the port."""
    _, ts = _outer_pair("log-variance")
    rel = tgv.gradient_variances(ts, torch.Generator().manual_seed(0))
    assert rel.shape[0] == ts.N and torch.isfinite(rel).all()
    rel_m = tgv.gradient_variances(ts, torch.Generator().manual_seed(0),
                                   loss_method="moment")
    assert rel_m.shape == rel.shape


def test_gradient_variance_hook_in_solver():
    """tests/test_eval_diagnostics.py:30-39 on the port."""
    s = TSolver("g", tp.LLGC(d=1, T=0.4, device="cpu"), L=6, K=64,
                delta_t=0.1, time_approx="outer", loss_method="log-variance",
                verbose=False, compute_gradient_variance=2,
                log_gradient=True, early_stopping_time=None, device="cpu")
    s.train()
    assert s.resolved_steps_per_call == 1
    assert len(s.grads_rel_error_log) == 3
    assert len(s.gradient_log) == 6
    assert all(np.isfinite(g).all() for g in s.gradient_log)


# -- the diagnostics leave training as it is -------------------------------------

@pytest.mark.parametrize("approx", ["outer", "inner"])
def test_diagnostics_leave_training_unchanged(approx):
    kw = dict(L=8, K=32, delta_t=0.1, time_approx=approx,
              loss_method="log-variance", detach_forward=True,
              verbose=False, early_stopping_time=None, device="cpu")
    diag = dict(IS_variance_K=128, IS_variance_iter=3, log_gradient=True)
    if approx == "outer":
        diag["compute_gradient_variance"] = 2
    a = TSolver("a", tp.LLGC(d=2, T=0.5, device="cpu"), **kw)
    b = TSolver("b", tp.LLGC(d=2, T=0.5, device="cpu"), **kw, **diag)
    a.train()
    b.train()
    assert a.loss_log == b.loss_log and a.u_L2_loss == b.u_L2_loss
    for p, q in zip(a.z_net.parameters(), b.z_net.parameters()):
        assert torch.equal(p, q)
    assert torch.equal(a._noise_gen.get_state(), b._noise_gen.get_state())
    assert len(b.IS_rel_log) == 3 and all(np.isfinite(b.IS_rel_log))
    assert a.resolved_steps_per_call > 1 and b.resolved_steps_per_call == 1


# -- importance sampling -----------------------------------------------------------

def test_is_runner_equals_importance_sampling():
    pt = tp.LLGC(d=2, T=0.5, device="cpu")
    s = TSolver("r", pt, L=1, K=16, delta_t=0.05, time_approx="inner",
                verbose=False, early_stopping_time=None, device="cpu")
    run = tis.make_is_runner(pt, s, K=2048, delta_t=0.05)
    mean1, var1, rel1 = run(torch.Generator().manual_seed(5))
    mean2, var2, rel2 = tis.importance_sampling(
        pt, s, K=2048, delta_t=0.05, generator=torch.Generator()
        .manual_seed(5))
    assert (float(mean1), float(var1), float(rel1)) == (mean2, var2, rel2)


@pytest.mark.parametrize("bridge", [True, False])
def test_qmc_noise_bitwise(bridge):
    want = np.asarray(jis._qmc_noise(64, 16, 3, 1234, bridge=bridge))
    got = tis._qmc_noise(64, 16, 3, 1234, bridge=bridge)
    assert got.dtype == np.float32 and np.array_equal(got, want)


@pytest.mark.parametrize("qmc", [True, "natural"])
def test_importance_sampling_qmc_matches_jax(qmc, monkeypatch):
    """Both packages at JAX's scramble seed for its key (the port draws
    its seed from the generator: set to JAX's here), rtol 1e-5."""
    pj = jp.LLGC(d=2, T=0.5)
    pt = tp.LLGC(d=2, T=0.5, device="cpu")
    js = JSolver("q", pj, L=1, K=16, delta_t=0.05, time_approx="inner",
                 verbose=False, early_stopping_time=None)
    ts = TSolver("q", pt, L=1, K=16, delta_t=0.05, time_approx="inner",
                 verbose=False, early_stopping_time=None, device="cpu")
    ts.load_jax_params(jax.device_get(js.params))
    key = jax.random.PRNGKey(8)
    seed = int(jax.random.randint(key, (), 0, 2 ** 31 - 1))
    monkeypatch.setattr(tis, "_qmc_seed", lambda gen: seed)
    want = jis.importance_sampling(pj, js, 512, delta_t=0.05, key=key,
                                   qmc=qmc)
    got = tis.importance_sampling(pt, ts, 512, delta_t=0.05, qmc=qmc)
    _close(got, [float(v) for v in want], 1e-5, 0.0, "IS with QMC")
    with pytest.raises(ValueError, match="mutually exclusive"):
        tis.importance_sampling(pt, ts, 512, qmc=True, antithetic=True)


# -- loss-estimator statistics ------------------------------------------------------

def _estimator_net(d, key):
    net = ja.TanhMLP(d_out=d)
    params = {"z": net.init(key, jnp.zeros((1, d + 1)))}
    return net, params


def test_loss_estimator_statistics_matches_jax():
    d, k, dt = 3, 4096, 0.05
    key = jax.random.PRNGKey(2)
    pj = jp.LLGC(d=d, T=1.0, off_diag=0.1, h_sign=+1.0)
    pt = tp.LLGC(d=d, T=1.0, off_diag=0.1, h_sign=+1.0, device="cpu")
    net, params = _estimator_net(d, key)
    net_t = tanh_mlp_from_flax(jax.device_get(params["z"]), device="cpu")

    def ctrl_j(prm, X, n, t):
        tX = jnp.concatenate([jnp.full((X.shape[0], 1), 0.0) + t, X], axis=1)
        return net.apply(prm["z"], tX), None

    def ctrl_t(X, n, t):
        return net_t(torch.cat([torch.full((X.shape[0], 1), t), X],
                               dim=1)), None

    n_steps = int(np.floor(1.0 / dt))
    noise = {c: _jax_noise(jax.random.fold_in(key, c), k // 2, n=n_steps,
                           d=d) for c in range(2)}
    want = jes.loss_estimator_statistics(pj, ctrl_j, params, K=k,
                                         delta_t=dt, key=key, n_chunks=2)
    got = tes.loss_estimator_statistics(
        pt, ctrl_t, K=k, delta_t=dt, n_chunks=2,
        noise_fn=lambda c, n: torch.from_numpy(noise[c][n]))
    assert sorted(got) == sorted(want)
    for name in want:
        tol = 1e-3 if name == "var_var" else 1e-4
        _close(got[name], want[name], tol, 0.0, name)
    for which in ("CE_detach", "var", "g", "CE"):
        _close(tes.relative_error(got, which),
               jes.relative_error(want, which), 1e-3, 0.0, which)


def test_estimator_statistics_dimension_scaling():
    """tests/test_eval_diagnostics.py:42-61 on the port: the cross-entropy
    estimator's relative error grows with d much faster than the
    log-variance estimator's (JAX's initial nets)."""
    key = jax.random.PRNGKey(0)
    rel_ce, rel_lv = [], []
    for d in [1, 6]:
        pt = tp.LLGC(d=d, T=1.0, off_diag=0.1, h_sign=+1.0, device="cpu")
        _, params = _estimator_net(d, key)
        net_t = tanh_mlp_from_flax(jax.device_get(params["z"]),
                                   device="cpu")

        def ctrl_t(X, n, t, net_t=net_t):
            return net_t(torch.cat([torch.full((X.shape[0], 1), t), X],
                                   dim=1)), None

        stats = tes.loss_estimator_statistics(
            pt, ctrl_t, K=200_000, delta_t=0.01,
            generator=torch.Generator().manual_seed(0))
        rel_ce.append(tes.relative_error(stats, "CE_detach"))
        rel_lv.append(tes.relative_error(stats, "var"))
    assert rel_ce[1] / rel_ce[0] > 2.0 * (rel_lv[1] / max(rel_lv[0], 1e-9))


def test_solver_options_accepted():
    """The options this slice ports are accepted; the two left raise."""
    pt = tp.LLGC(d=2, T=0.5, device="cpu")
    s = TSolver("x", pt, IS_variance_K=10, IS_variance_iter=5,
                compute_gradient_variance=3, log_gradient=True,
                save_results=False, rng_impl="rbg", device="cpu")
    assert (s.IS_variance_K, s.IS_variance_iter) == (10, 5)
    for bad in (dict(plot_trajectories=10), dict(mesh=object())):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            TSolver("x", pt, device="cpu", **bad)
    cfg = dataclasses.replace(s._rollout_cfg(0), remat=True)
    assert cfg.remat
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        TSolver("x", pt, device="cpu")
