"""The port's EllipticSolver training step against pspde's (CPU).

Both solvers start from the same DenseNet (8, 8) parameters (the JAX
solver's init, carried over with ``load_jax_params``) and take 20 steps.
Each JAX step runs ``_build_step()`` on a fresh key; the port's step is
fed that key's own draws, made as pspde/solvers/elliptic.py:407-447 makes
them: kb, kd, kr = split(key, 3), the boundary points of kb, the domain
points of kd and the noise normal(fold_in(kr, n), (K, d)).  The 'scan'
engine and the 'fused_train' engine (on the CPU: the kernels' plain
versions with the hand-written backward) are both held to pspde's scan.

Tolerances: loss and V_L2 trajectories rtol 2e-4 per step; parameters
after 20 steps atol 1e-5 (Adam moves each by up to 20 lr = 0.02).
Sizes: d=4, K=64, K_boundary=16, N=16, dt=0.01.
"""

import tempfile
import warnings

import jax
import numpy as np
import pytest
import torch

import pspde.problems as jp
from pspde.ansatz import DenseNet as JDenseNet
from pspde.rollout.sampling import sample_boundary as j_boundary
from pspde.rollout.sampling import sample_domain as j_domain
from pspde.solvers import EllipticSolver as JSolver
from pspde.solvers._chunk import resolve_steps_per_call as j_resolve
import pspde_torch.problems as tp
from pspde_torch.eval import compute_test_error
from pspde_torch.solvers import EllipticSolver as TSolver
from pspde_torch.solvers._chunk import resolve_steps_per_call as t_resolve
from pspde_torch.utils.convert import dense_net_to_flax

D, K, KB, N, DT, STEPS = 4, 64, 16, 16, 0.01, 20
TRAJ_RTOL, PARAM_ATOL = 2e-4, 1e-5


def _draws(key, geom):
    """The JAX step's boundary points, domain points and noise."""
    kb, kd, kr = jax.random.split(key, 3)
    Xb = np.asarray(j_boundary(kb, geom, KB, D))
    X0 = np.asarray(j_domain(kd, geom, K, D))
    noise = np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(kr, n), (K, D))) for n in range(N)])
    return [torch.tensor(a) for a in (X0, Xb, noise)]


@pytest.mark.parametrize("engine,loss_method,opts", [
    ("scan", "diffusion", {}),
    ("fused_train", "diffusion", {}),
    ("fused_train", "diffusion", dict(adaptive_forward_process=True)),
    ("scan", "diffusion", dict(variance_moment_split=True,
                               boundary_type="Neumann")),
    ("scan", "BSDE-2", dict(log_loss_parts=True)),
    ("fused_train", "BSDE", dict(loss_with_stopped=True)),
])
def test_twenty_steps_match_jax(engine, loss_method, opts):
    opts = dict(opts)
    btype = opts.pop("boundary_type", "Dirichlet")
    kw = dict(delta_t=DT, N=N, lr=1e-3, L=STEPS, K=K, K_boundary=KB,
              loss_method=loss_method, verbose=False, **opts)
    pj = jp.ExponentialOnBallNonlinearSin(d=D, alpha=0.5,
                                          boundary_type=btype)
    pt = tp.ExponentialOnBallNonlinearSin(d=D, alpha=0.5,
                                          boundary_type=btype, device="cpu")
    js = JSolver(pj, "j", value_net=JDenseNet(d_out=1, arch=(8, 8)),
                 boundary_type=btype, **kw)
    step = jax.jit(js._build_step())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ts = TSolver(pt, "t", boundary_type=btype, rollout_mode=engine,
                     device="cpu", **kw)
        ts.load_jax_params(jax.device_get(js.params))
    # the CPU has no kernels: drive the fused step through its plain
    # versions
    ts.resolved_rollout_mode = engine
    params, opt = js.params, js.opt_state
    key = jax.random.PRNGKey(21)
    j_loss, j_vl2, j_dom = [], [], []
    for _ in range(STEPS):
        key, sub = jax.random.split(key)
        X0, Xb, noise = _draws(sub, pj.geometry)
        params, opt, aux = step(params, opt, sub)
        j_loss.append(float(aux["loss"]))
        j_vl2.append(float(aux["V_L2"]))
        j_dom.append(float(aux["domain"]))
        ts.step(X0=X0, Xb=Xb, host_noise=noise)
    np.testing.assert_allclose(ts.loss_log, j_loss, rtol=TRAJ_RTOL)
    np.testing.assert_allclose(ts.V_L2_log, j_vl2, rtol=TRAJ_RTOL)
    if opts.get("log_loss_parts"):
        np.testing.assert_allclose(ts.loss_log_domain, j_dom, rtol=TRAJ_RTOL)
    assert len(ts.K_log) == STEPS and ts.K_log[0] > 0
    got = dense_net_to_flax(list(ts.V_net.parameters()))
    for a, b in zip(jax.tree.leaves(got),
                    jax.tree.leaves(jax.device_get(params))):
        np.testing.assert_allclose(a, b, rtol=0, atol=PARAM_ATOL)


def test_fused_train_gates_and_not_ported_options():
    """Off CUDA every gate but the device passes for the slice's recipe and
    'fused_train' resolves to 'scan' with a warning; a loss outside the
    family names it; what is not ported raises, naming ROADMAP.md."""
    pt = tp.ExponentialOnBallNonlinearSin(d=D, alpha=0.1, device="cpu")
    kw = dict(K=32, N=4, delta_t=1e-3, verbose=False, device="cpu")
    with pytest.warns(UserWarning, match="problem on a CUDA device"):
        s = TSolver(pt, "t", loss_method="diffusion",
                    rollout_mode="fused_train", **kw)
    assert s.resolved_rollout_mode == "scan"
    assert s._fused_train_gates() == ["problem on a CUDA device"]
    with pytest.warns(UserWarning, match="loss_method 'diffusion' or"):
        TSolver(pt, "t", loss_method="BSDE-3", rollout_mode="fused_train",
                **kw)
    with pytest.warns(UserWarning, match="detach_forward=True"):
        TSolver(pt, "t", detach_forward=False, rollout_mode="fused_train",
                **kw)
    # PINN is ported; with 'fused_train' it fails the loss gate
    with pytest.warns(UserWarning, match="loss_method 'diffusion' or"):
        TSolver(pt, "t", loss_method="PINN", rollout_mode="fused_train",
                **kw)
    for bad, match in ((dict(layout="dk"), "dk"),
                       (dict(rng_impl="rbg"), "rng_impl"),
                       (dict(mesh=object()), "mesh")):
        with pytest.raises(NotImplementedError, match=match):
            TSolver(pt, "t", **bad, **kw)
    # steps_per_call is ported: accepted, and resolved as pspde resolves it
    chunked = TSolver(pt, "t", steps_per_call=50, **kw)
    assert t_resolve(chunked) == j_resolve(chunked) == 50
    with pytest.raises(ValueError, match="approx_method"):
        TSolver(pt, "t", approx_method="Z", **kw)
    # save/load are ported (utils/checkpoint.py): a round trip
    with tempfile.TemporaryDirectory() as tmp:
        s.load_networks(s.save_networks(out_dir=tmp))
    with pytest.raises(ValueError, match="one device"):
        TSolver(pt, "t", **dict(kw, device="meta"))


def test_train_logs_and_test_error():
    """train() runs L steps with the reference's log names; K_test_log
    computes compute_test_error after each update."""
    pt = tp.ExponentialOnSphere(d=3, alpha=0.5, device="cpu")
    s = TSolver(pt, "t", K=64, K_boundary=16, N=8, delta_t=0.01, L=5,
                K_test_log=256, log_loss_parts=True, verbose=False,
                device="cpu")
    s.train()
    for name in ("loss_log", "V_L2_log", "K_log", "V_test_L2", "V_test_abs",
                 "V_test_rel_abs", "loss_log_domain", "loss_log_boundary",
                 "times"):
        assert len(getattr(s, name)) == 5 and all(
            np.isfinite(getattr(s, name))), name
    assert s.iteration == 5
    gen = torch.Generator().manual_seed(3)
    L2, mae, mre = compute_test_error(s.V, pt, 512, gen)
    from pspde_torch.rollout.sampling import sample_domain
    X = sample_domain(torch.Generator().manual_seed(3), pt.geometry, 512, 3)
    with torch.no_grad():
        diff = pt.v_ref(X) - s.V(X)
    torch.testing.assert_close(L2, torch.mean(diff ** 2))
    torch.testing.assert_close(mae, torch.mean(diff.abs()))
    torch.testing.assert_close(mre, torch.mean(diff.abs() / pt.v_ref(X)))
    with pytest.raises(ValueError, match="modus"):
        compute_test_error(s.V, pt, 8, gen, modus="hyperbolic")
