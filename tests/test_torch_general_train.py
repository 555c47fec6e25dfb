"""The port's GeneralSolver training step against pspde's (CPU).

Both solvers start from the same DenseNet (6, 5) parameters of input width
d + 1 (the JAX solver's init, carried over with ``load_jax_params``) and
take 20 steps.  Each JAX step runs ``_build_step()`` on a fresh key; the
port's step is fed that key's own draws, made as
pspde/solvers/general.py:286-308 makes them: kb, kbt, kd, kt, kr =
split(key, 5), the boundary points of kb at the times of kbt, the domain
points of kd at the start times of kt, and the noise
normal(fold_in(kr, n), (K, d)).  The 'scan' engine and the 'fused_train'
engine (on the CPU: the kernels' plain versions with the hand-written
backward) are both held to pspde's scan, for the Dirichlet and the Neumann
ball and the unbounded heat problem.

Tolerances: loss trajectories rtol 2e-4 per step; parameters after 20
steps atol 1e-5 (Adam moves each by up to 20 lr = 0.02).
Sizes: d=3, K=64, K_boundary=16, N=12, dt=0.01, T=0.15.

The last test walks every file of the port and ``chip_smoke.py`` for an
import of jax or of the JAX package.
"""

import ast
import pathlib
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
from pspde.solvers import GeneralSolver as JSolver
from pspde.solvers._chunk import resolve_steps_per_call as j_resolve
import pspde_torch.problems as tp
from pspde_torch.eval import compute_test_error
from pspde_torch.rollout import kernels as tk
from pspde_torch.solvers import EllipticSolver, GeneralSolver as TSolver
from pspde_torch.solvers._chunk import resolve_steps_per_call as t_resolve
from pspde_torch.utils.convert import dense_net_to_flax
from tests.torch_outside_family import _TanhH

D, K, KB, N, DT, T_END, STEPS = 3, 64, 16, 12, 0.01, 0.15, 20
TRAJ_RTOL, PARAM_ATOL = 2e-4, 1e-5

PROBLEMS = {
    "dirichlet": ("ExponentialOnSphereNonlinearParabolic",
                  dict(alpha=0.5, T=T_END)),
    "neumann": ("ExponentialOnSphereNonlinearParabolic",
                dict(alpha=0.5, T=T_END, boundary_type="Neumann")),
    "linear": ("ExponentialOnSphereParabolic", dict(alpha=0.5, T=T_END)),
    "heat": ("HeatEquation", dict(T=T_END)),
}


def _problems(case):
    cls, kw = PROBLEMS[case]
    return getattr(jp, cls)(d=D, **kw), getattr(tp, cls)(d=D, device="cpu",
                                                          **kw)


def _draws(key, pj):
    """The JAX step's domain points and start times, boundary points and
    times, and noise."""
    geom = pj.geometry
    kb, kbt, kd, kt, kr = jax.random.split(key, 5)
    X0 = j_domain(kd, geom, K, D)
    t0 = jax.random.uniform(kt, (K,)) * pj.T
    Xb = j_boundary(kb, geom, KB, D)
    tb = jax.random.uniform(kbt, (KB,)) * pj.T
    noise = np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(kr, n), (K, D))) for n in range(N)])
    return [torch.tensor(np.asarray(a)) for a in (X0, t0, Xb, tb, noise)]


@pytest.mark.parametrize("case,engine,loss_method,opts", [
    ("dirichlet", "scan", "diffusion", {}),
    ("dirichlet", "fused_train", "diffusion", {}),
    ("dirichlet", "fused_train", "diffusion",
     dict(adaptive_forward_process=True)),
    ("neumann", "fused_train", "diffusion", dict(log_loss_parts=True)),
    ("neumann", "scan", "BSDE", {}),
    ("neumann", "fused_train", "BSDE", dict(loss_with_stopped=True)),
    ("heat", "scan", "diffusion", {}),
    ("heat", "fused_train", "diffusion", {}),
    ("heat", "fused_train", "BSDE", {}),
    ("linear", "scan", "BSDE-3", {}),
    ("linear", "scan", "BSDE-2", dict(alpha=(0.7, 1.3, 0.4))),
    ("heat", "scan", "diffusion", dict(solve_linear_L2_projection=True)),
])
def test_twenty_steps_match_jax(case, engine, loss_method, opts):
    kw = dict(delta_t=DT, N=N, lr=1e-3, L=STEPS, K=K, K_boundary=KB,
              loss_method=loss_method, verbose=False, **opts)
    pj, pt = _problems(case)
    js = JSolver(pj, "j", value_net=JDenseNet(d_out=1, arch=(6, 5)), **kw)
    step = jax.jit(js._build_step())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ts = TSolver(pt, "t", rollout_mode=engine, device="cpu", **kw)
        ts.load_jax_params(jax.device_get(js.params))
    assert ts.V_net.d_in == D + 1 and ts.V_net.arch == (6, 5)
    # the CPU has no kernels: drive the fused step through its plain
    # versions
    ts.resolved_rollout_mode = engine
    params, opt = js.params, js.opt_state
    key = jax.random.PRNGKey(21)
    j_loss, j_dom, j_k = [], [], []
    for _ in range(STEPS):
        key, sub = jax.random.split(key)
        X0, t0, Xb, tb, noise = _draws(sub, pj)
        params, opt, aux = step(params, opt, sub)
        j_loss.append(float(aux["loss"]))
        j_dom.append(float(aux["domain"]))
        j_k.append(float(aux["K_count"]))
        ts.step(X0=X0, t0=t0, Xb=Xb, tb=tb, host_noise=noise)
    np.testing.assert_allclose(ts.loss_log, j_loss, rtol=TRAJ_RTOL)
    assert ts.K_log == j_k and 0 < j_k[0] < K * N
    if opts.get("log_loss_parts"):
        np.testing.assert_allclose(ts.loss_log_domain, j_dom, rtol=TRAJ_RTOL)
        assert min(ts.loss_log_boundary) > 0
    # no reference under time_stopping: NaN from the kernels' path, 0 from
    # the scan, as pspde
    assert (np.isnan(ts.V_L2_log).all() if engine == "fused_train"
            else ts.V_L2_log == [0.0] * STEPS)
    got = dense_net_to_flax(list(ts.V_net.parameters()))
    for a, b in zip(jax.tree.leaves(got),
                    jax.tree.leaves(jax.device_get(params))):
        np.testing.assert_allclose(a, b, rtol=0, atol=PARAM_ATOL)


def test_fused_train_gates_and_not_ported_options():
    """Off CUDA every gate but the device passes for the slice's recipe and
    'fused_train' resolves to 'scan' with a warning; an h outside the
    'ball_exp' family (tanh y) fails the family gate, which names
    STOPPED_KERNEL_FAMILY, and the kernels' wrapper raises on it; what is not ported raises, naming ROADMAP.md;
    without a card device=None raises."""
    _, pt = _problems("dirichlet")
    kw = dict(K=32, K_boundary=8, N=4, delta_t=1e-3, verbose=False,
              device="cpu")
    with pytest.warns(UserWarning, match="problem on a CUDA device"):
        s = TSolver(pt, "t", loss_method="diffusion",
                    rollout_mode="fused_train", **kw)
    assert s.resolved_rollout_mode == "scan"
    assert s._fused_train_gates() == ["problem on a CUDA device"]
    assert isinstance(s, EllipticSolver)
    for name in ("_fused_train_gates", "_resolve_engine", "_rollout",
                 "_record", "train"):
        assert getattr(TSolver, name) is getattr(EllipticSolver, name), name
    with pytest.warns(UserWarning, match="loss_method 'diffusion' or"):
        TSolver(pt, "t", loss_method="BSDE-4", rollout_mode="fused_train",
                **kw)
    with pytest.warns(UserWarning, match="solve_linear_L2_projection=False"):
        TSolver(pt, "t", solve_linear_L2_projection=True,
                rollout_mode="fused_train", **kw)
    ac = _TanhH(d=D, device="cpu")
    with pytest.warns(UserWarning, match="STOPPED_KERNEL_FAMILY"):
        a = TSolver(ac, "t", rollout_mode="fused_train", **kw)
    assert a.resolved_rollout_mode == "scan"
    a.step()
    assert np.isfinite(a.loss_log[0]) and a.loss_log_boundary == []
    with pytest.raises(ValueError, match="STOPPED_KERNEL_FAMILY"):
        tk.fused_stopped_train_rollout(
            ac, a.V_net, torch.zeros(4, D), torch.zeros(4), 4, 1e-3,
            time_stopping=True)
    with pytest.raises(ValueError, match="need 4, 1, False"):
        tk._check_stopped_family(
            pt, EllipticSolver(tp.ExponentialOnSphere(d=D, device="cpu"),
                               "e", device="cpu").V_net, "erfinv",
            time_stopping=True)
    # PINN is ported; with 'fused_train' it fails the loss gate
    with pytest.warns(UserWarning, match="loss_method 'diffusion' or"):
        TSolver(pt, "t", loss_method="PINN", rollout_mode="fused_train",
                **kw)
    for bad, match in ((dict(layout="dk"), "dk"),
                       (dict(rng_impl="rbg"), "rng_impl"),
                       (dict(mesh=object()), "mesh")):
        with pytest.raises(NotImplementedError,
                           match="GeneralSolver") as e:
            TSolver(pt, "t", **bad, **kw)
        assert match in str(e.value) and "ROADMAP.md" in str(e.value)
    # steps_per_call is ported: accepted, and resolved as pspde resolves it
    chunked = TSolver(pt, "t", steps_per_call=50, **kw)
    assert t_resolve(chunked) == j_resolve(chunked) == 50
    # save/load are ported (utils/checkpoint.py): a round trip
    with tempfile.TemporaryDirectory() as tmp:
        s.load_training_state(s.save_training_state(out_dir=tmp))
    assert s.iteration == 0
    with pytest.raises(ValueError, match="horizon"):
        TSolver(tp.ExponentialOnSphere(d=D, device="cpu"), "t", **kw)
    with pytest.raises(ValueError, match="K_boundary"):
        TSolver(pt, "t", **dict(kw, K_boundary=64))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TSolver(pt, "t", **dict(kw, device=None))


@pytest.mark.parametrize("case", ["dirichlet", "heat"])
def test_train_logs_and_parabolic_test_error(case, capsys):
    """train() runs L steps with the reference's log names; K_test_log
    computes compute_test_error(modus='parabolic') after each update: X,
    then t ~ U(0, T), the net on [X, t] against v_ref(X, t).  On the
    unbounded heat problem the constructor warns where the diffusion
    spread leaves the sampling radius."""
    _, pt = _problems(case)
    s = TSolver(pt, "t", K=64, K_boundary=16, N=8, delta_t=0.01, L=5,
                K_test_log=256, log_loss_parts=True, verbose=False,
                device="cpu")
    s.train()
    for name in ("loss_log", "K_log", "V_test_L2", "V_test_abs",
                 "V_test_rel_abs", "loss_log_domain", "loss_log_boundary",
                 "times"):
        assert len(getattr(s, name)) == 5 and all(
            np.isfinite(getattr(s, name))), name
    assert s.iteration == 5
    assert (min(s.loss_log_boundary) > 0) == pt.geometry.bounded
    v_fn = lambda XT: s.V_net(XT)[:, 0]
    L2, mae, mre = compute_test_error(v_fn, pt, 512,
                                      torch.Generator().manual_seed(3),
                                      modus="parabolic")
    from pspde_torch.rollout.sampling import sample_domain
    gen = torch.Generator().manual_seed(3)
    X = sample_domain(gen, pt.geometry, 512, D)
    t = torch.rand(512, generator=gen) * pt.T
    with torch.no_grad():
        diff = pt.v_ref(X, t) - s.V(X, t)
    torch.testing.assert_close(L2, torch.mean(diff ** 2))
    torch.testing.assert_close(mae, torch.mean(diff.abs()))
    torch.testing.assert_close(mre, torch.mean(diff.abs() / pt.v_ref(X, t)))
    assert float(t.max()) <= pt.T and float(t.min()) >= 0.0
    capsys.readouterr()
    wide = tp.HeatEquation(d=50, T=1.0, device="cpu")
    TSolver(wide, "t", K=8, K_boundary=4, N=2, verbose=True, device="cpu")
    assert "exceeds the sampling radius" in capsys.readouterr().out


def test_the_port_imports_no_jax():
    """No module of pspde_torch, and not chip_smoke.py, imports jax or the
    JAX package."""
    root = pathlib.Path(__file__).resolve().parents[1]
    files = sorted((root / "pspde_torch").rglob("*.py")) + [
        root / "chip_smoke.py"]
    assert len(files) > 20
    banned = {"jax", "jaxlib", "flax", "optax", "pspde"}
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for name in names:
                assert name.split(".")[0] not in banned, (
                    f"{path.relative_to(root)} imports {name}")
