"""The port's EigenSolver against pspde's (CPU).

Both solvers start from the same parameters (the JAX solver's init, the
DenseNet and lambda carried over with ``load_jax_params``) and take 20
steps.  Each JAX step runs ``_build_step()`` on a fresh key; the port's
step is fed that key's own draws, made as pspde/solvers/eigen.py:253-305
makes them: kb, kd, kr, kn = split(key, 4), the reflected boundary pair of
kb, the domain points of kd, the 'l2_penalty' points of kn and the noise
normal(fold_in(kr, n), (K, d)).  The 'scan' engine and the 'fused_train'
engine (on the CPU: the kernels' plain versions with the hand-written
backward, lambda a leaf) are both held to pspde's scan, for both
normalizations and for a separate lambda learning rate.

Tolerances: the loss, lambda and V_L2 trajectories rtol 2e-4 per step;
parameters after 20 steps atol 2e-5 (Adam moves each by up to 20 lr_lambda
= 0.2).  ``estimate_lambda`` on the same batches: rtol 1e-3, atol 1e-6.
Sizes: d=5, K=64, K_boundary=16, N=16, dt=0.01, DenseNet (8, 8).
"""

import tempfile
import warnings

import jax
import numpy as np
import pytest
import torch

import pspde.problems as jp
from pspde.ansatz import DenseNet as JDenseNet
from pspde.rollout.sampling import sample_boundary_reflected as j_reflected
from pspde.rollout.sampling import sample_domain as j_domain
from pspde.solvers import EigenSolver as JSolver
from pspde.solvers._chunk import resolve_steps_per_call as j_resolve
import pspde_torch.problems as tp
from pspde_torch.ansatz import DenseNet
from pspde_torch.solvers import EigenSolver as TSolver
from pspde_torch.solvers._chunk import resolve_steps_per_call as t_resolve
from pspde_torch.solvers.eigen import hat_function
from pspde_torch.utils.convert import eigen_params_to_flax

D, K, KB, N, DT, STEPS = 5, 64, 16, 16, 0.01, 20
TRAJ_RTOL, PARAM_ATOL = 2e-4, 2e-5


def _draws(key, geom):
    """The JAX step's reflected boundary pair, domain points, penalty
    points and noise."""
    kb, kd, kr, kn = jax.random.split(key, 4)
    Xb, Xb_r = (np.asarray(a) for a in j_reflected(kb, geom, KB, D))
    X0 = np.asarray(j_domain(kd, geom, K, D))
    X2 = np.asarray(j_domain(kn, geom, K, D))
    noise = np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(kr, n), (K, D))) for n in range(N)])
    t = [torch.tensor(a) for a in (X0, Xb, Xb_r, X2, noise)]
    return t[0], (t[1], t[2]), t[3], t[4]


def _solvers(engine, net_kw, **kw):
    kw = dict(delta_t=DT, N=N, L=STEPS, K=K, K_boundary=KB, verbose=False,
              **kw)
    pj = jp.FokkerPlanckEigen(d=D)
    pt = tp.FokkerPlanckEigen(d=D, device="cpu")
    js = JSolver(pj, "j", value_net=JDenseNet(d_out=1, arch=(8, 8),
                                              **net_kw), **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ts = TSolver(pt, "t", rollout_mode=engine, device="cpu",
                     value_net=DenseNet(1, (8, 8), d_in=D, device="cpu",
                                        **net_kw), **kw)
        ts.load_jax_params(jax.device_get(js.params))
    # the CPU has no kernels: drive the fused step through its plain
    # versions
    ts.resolved_rollout_mode = engine
    return pj, js, ts


@pytest.mark.parametrize("engine,normalization,lr_lambda,net_kw", [
    ("scan", "center", None, dict(bias_init_value=0.8, output_relu=True)),
    ("fused_train", "center", 0.01, dict(bias_init_value=0.8,
                                         output_relu=True)),
    ("fused_train", "center", 0.01, dict()),
    ("scan", "l2_penalty", 0.01, dict()),
    ("fused_train", "l2_penalty", None, dict(bias_init_value=0.8,
                                             output_relu=True)),
])
def test_twenty_steps_match_jax(engine, normalization, lr_lambda, net_kw):
    pj, js, ts = _solvers(engine, net_kw, lr=1e-3, lr_lambda=lr_lambda,
                          normalization=normalization)
    step = jax.jit(js._build_step())
    params, opt = js.params, js.opt_state
    key = jax.random.PRNGKey(21)
    logs = {k: [] for k in ("loss", "lambda", "V_L2", "domain", "center")}
    for _ in range(STEPS):
        key, sub = jax.random.split(key)
        X0, Xb, X2, noise = _draws(sub, pj.geometry)
        params, opt, aux = step(params, opt, sub)
        for k in logs:
            logs[k].append(float(aux[k]))
        ts.step(X0=X0, Xb=Xb, X2=X2, host_noise=noise)
    for k, port in (("loss", ts.loss_log), ("lambda", ts.lambda_log),
                    ("V_L2", ts.V_L2_log), ("domain", ts.loss_log_domain),
                    ("center", ts.loss_log_center)):
        np.testing.assert_allclose(port, logs[k], rtol=TRAJ_RTOL, err_msg=k)
    assert len(ts.loss_log_boundary) == len(
        ts.loss_log_derivative_boundary) == STEPS
    # lambda moved, and by its own learning rate
    assert abs(ts.lambda_log[-1] - ts.lambda_log[0]) > 1e-3
    got = eigen_params_to_flax(list(ts.V_net.parameters()), ts.lam_net.Y_0)
    for a, b in zip(jax.tree.leaves(got),
                    jax.tree.leaves(jax.device_get(params))):
        np.testing.assert_allclose(a, b, rtol=0, atol=PARAM_ATOL)


@pytest.mark.parametrize("engine", ["scan", "fused_train"])
def test_estimate_lambda_matches_jax(engine):
    """The frozen-V regression readout on JAX's own batches (pspde's
    fold_in(key, i) -> split -> kd, kr draws): lambda_hat and its error
    bar (lambda_hat ~7e-4 here: rtol 1e-3 with atol 1e-6, the float32
    sums' reach).  On 'fused_train' both rollouts (lambda 0 and 1) run
    the kernels' plain versions on the batch's host noise."""
    pj, js, ts = _solvers(engine, dict(bias_init_value=0.8,
                                       output_relu=True), lambda_init=0.2)
    Kq, n_batches = 128, 3
    key = jax.random.PRNGKey(7)
    lam_j, se_j = js.estimate_lambda(K=Kq, n_batches=n_batches, key=key)
    batches = []
    for i in range(n_batches):
        kd, kr = jax.random.split(jax.random.fold_in(key, i))
        X0 = np.asarray(j_domain(kd, pj.geometry, Kq, D))
        noise = np.stack([np.asarray(jax.random.normal(
            jax.random.fold_in(kr, n), (Kq, D))) for n in range(N)])
        batches.append((torch.tensor(X0), torch.tensor(noise)))
    lam_t, se_t = ts.estimate_lambda(batches=batches)
    # lambda_hat = -sum(r S) / sum(S S) over float32 sums of 3 x 128 paths:
    # about 1e-7 apart at lambda_hat ~ 7e-4 here
    np.testing.assert_allclose(lam_t, lam_j, rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(se_t, se_j, rtol=1e-3, atol=1e-6)
    # the solver's own draws run, and the Richardson readout combines two
    lam_s, se_s = ts.estimate_lambda(K=Kq, n_batches=2)
    lam_r, se_r = ts.estimate_lambda_richardson(K=Kq, n_batches=2)
    assert all(np.isfinite([lam_s, se_s, lam_r, se_r]))


def test_lambda_tail_mean_and_hat_function():
    """lambda_tail_mean over the last 10% (or a window) as pspde's;
    hat_function is exp(-200 x^2) on (-0.2, 0.2)."""
    pt = tp.FokkerPlanckEigen(d=2, device="cpu")
    ts = TSolver(pt, "t", K=16, K_boundary=4, N=4, L=3, verbose=False,
                 device="cpu")
    js = JSolver(jp.FokkerPlanckEigen(d=2), "j", K=16, K_boundary=4, N=4,
                 L=3, verbose=False)
    assert ts.lambda_tail_mean() is None is js.lambda_tail_mean()
    trace = list(np.random.default_rng(0).standard_normal(57))
    ts.lambda_log = js.lambda_log = trace
    for window in (None, 5, 100):
        assert ts.lambda_tail_mean(window) == pytest.approx(
            js.lambda_tail_mean(window), rel=1e-12)
    x = torch.tensor([-0.3, -0.2, -0.1, 0.0, 0.05, 0.2, 0.25])
    want = torch.exp(-200.0 * x ** 2) * (x.abs() < 0.2)
    torch.testing.assert_close(hat_function(x), want)
    ts.train()
    assert len(ts.loss_log) == len(ts.times) == ts.iteration == 3
    assert float(ts.lam()) == pytest.approx(ts.lambda_log[-1], abs=0.01)


def test_gates_and_not_ported_options():
    """Off CUDA the FP recipe fails only the device gate and resolves to
    'scan' with a warning; the Schrodinger problem is outside the stopped
    kernels' family; what is not ported raises, naming ROADMAP.md."""
    fp = tp.FokkerPlanckEigen(d=5, device="cpu")
    kw = dict(K=32, N=4, verbose=False, device="cpu")
    with pytest.warns(UserWarning, match="problem on a CUDA device"):
        s = TSolver(fp, "t", rollout_mode="fused_train", **kw)
    assert s.resolved_rollout_mode == "scan"
    assert s._fused_train_gates() == ["problem on a CUDA device"]
    with pytest.warns(UserWarning, match="STOPPED_KERNEL_FAMILY"):
        sch = TSolver(tp.SchrodingerEigen(d=10, device="cpu"), "s",
                      rollout_mode="fused_train",
                      normalization="l2_penalty", **kw)
    assert any("family" in g for g in sch._fused_train_gates())
    with pytest.warns(UserWarning, match="detach_forward=True"):
        TSolver(fp, "t", detach_forward=False, rollout_mode="fused_train",
                **kw)
    for bad, match in ((dict(mesh=object()), "mesh"),
                       (dict(layout="dk"), "dk"),
                       (dict(rng_impl="rbg"), "rng_impl")):
        with pytest.raises(NotImplementedError, match=match):
            TSolver(fp, "t", **bad, **kw)
    # steps_per_call is ported: accepted, and resolved as pspde resolves it
    chunked = TSolver(fp, "t", steps_per_call=50, **kw)
    assert t_resolve(chunked) == j_resolve(chunked) == 50
    with pytest.raises(ValueError, match="normalization"):
        TSolver(fp, "t", normalization="l1", **kw)
    # save/load are ported (utils/checkpoint.py): the saved state loads
    # back into the solver, and a missing file raises
    with tempfile.TemporaryDirectory() as tmp:
        s.load_networks(s.save_networks(out_dir=tmp))
        s.load_training_state(s.save_training_state(out_dir=tmp))
    assert s.iteration == 0 and s.loss_log == []
    with pytest.raises(FileNotFoundError):
        s.load_training_state("x")
