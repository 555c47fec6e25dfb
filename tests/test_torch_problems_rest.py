"""The rest of ``problems/`` against pspde (CPU): the double-well variants
(``DoubleWellGeneral`` in both modi, ``DoubleWell_multidim_2``,
``DoubleWell_multidim_3``, ``DoubleWell_OU``), the first-exit problems
(``DoubleWell_stopping``, ``DoubleWell_stopping_linear``,
``DoubleWell_expectation_hitting_time``), ``Committor_DoubleWell``,
``LLGC_general_f`` and the FD oracle ``elliptic_generator_reference``.

* Coefficients: X_0, the geometry, sigma, b, f, g, h (the first-exit
  problems' three-argument h(x, y, z)), f_terminal and the references
  (v_ref / u_ref / v_ref_fn / u_ref_fn) on seeded numpy inputs, rtol 1e-6.
* The FD tables bitwise equal to pspde's SciPy / numpy solves (pspde's
  native C++ solver switched off; against it within 1e-10 of the table's
  largest entry).
* One solver per family for 20 steps against pspde's ``_build_step`` on
  the scan, each port step fed the JAX step's own draws: ``GeneralSolver``
  on ``DoubleWellGeneral(modus='linear')`` and on ``Committor_DoubleWell``
  (tests/test_misc_coverage.py's settings), ``EllipticSolver`` on
  ``DoubleWell_stopping`` (its h(x, y, z) through the scan, V_L2 against
  the FD table), ``HJBSolver`` on ``DoubleWell_OU`` (u_L2 against the FD
  and closed-form control) and on ``LLGC_general_f``.  Loss, V_L2 and u_L2
  trajectories rtol 2e-4; parameters after 20 steps atol 2e-5.
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pspde.problems as jp
import pspde_torch.problems as tp
from pspde.ansatz import DenseNet as JDenseNet
from pspde.native import fd_native
from pspde.problems import fd_oracles as jfd
from pspde.rollout.sampling import sample_boundary as j_boundary
from pspde.rollout.sampling import sample_domain as j_domain
from pspde.solvers import EllipticSolver as JElliptic
from pspde.solvers import GeneralSolver as JGeneral
from pspde.solvers import HJBSolver as JHJB
from pspde_torch.problems import fd_oracles as tfd
from pspde_torch.solvers import EllipticSolver as TElliptic
from pspde_torch.solvers import GeneralSolver as TGeneral
from pspde_torch.solvers import HJBSolver as THJB
from pspde_torch.utils.convert import dense_net_to_flax
from tests.torch_correctors import one_thread  # noqa: F401

RTOL = 1e-6
STEPS, TRAJ_RTOL, PARAM_ATOL = 20, 2e-4, 2e-5


@pytest.fixture
def no_native(monkeypatch):
    """pspde's FD oracles on their SciPy / numpy path."""
    monkeypatch.setattr(fd_native, "available", lambda: False)


def _grad_v(x):
    return 4.0 * 1.5 * x * (x ** 2 - 1.0)


@pytest.mark.parametrize("kw", [
    dict(sigma=1.0, f=1.0, rhs=0.0, bc_value=1.0),
    dict(sigma=2.0, f=0.0, rhs=-1.0, bc_value=0.0, bc_lo=300, bc_hi=330),
    dict(sigma=0.7, f=0.5, rhs=0.2, bc_value=1.0, bc_lo=100, bc_hi=120,
         xr=(-1.5, 1.0), dx=0.02),
])
def test_elliptic_generator_reference_matches_pspde(kw, monkeypatch):
    """Bitwise pspde's numpy solve; within 1e-10 of the largest entry of
    its native one (partial pivoting in another order), the control table
    where psi is not near the pinned zeros (its logarithm magnifies the
    solves' last bits there)."""
    native = jfd.elliptic_generator_reference(_grad_v, **kw)
    monkeypatch.setattr(fd_native, "available", lambda: False)
    want = jfd.elliptic_generator_reference(_grad_v, **kw)
    got = tfd.elliptic_generator_reference(_grad_v, **kw)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[0], native[0])
    np.testing.assert_allclose(got[1], native[1], rtol=0,
                               atol=1e-10 * np.abs(native[1]).max())
    psi = native[1]
    away = np.minimum(psi[:-1], psi[1:]) > 1e-6 * psi.max()
    np.testing.assert_allclose(got[2][away], native[2][away], rtol=0,
                               atol=1e-10 * np.abs(native[2][away]).max())

# name: (constructor kwargs, reference-solution kwargs or None)
CASES = {
    "general_hjb": ("DoubleWellGeneral", dict(d=3, d_1=2, d_2=1, T=0.5,
                                              eta=2.0, kappa=1.5),
                    dict(delta_t=0.01, nx=300)),
    "general_linear": ("DoubleWellGeneral",
                       dict(d=2, d_1=1, d_2=1, T=0.5, eta=1.0, kappa=1.0,
                            modus="linear"), dict(delta_t=0.01, nx=300)),
    "multidim_2": ("DoubleWell_multidim_2", dict(d=4, T=0.7, alpha=1.5,
                                                 kappa=2.0), None),
    "multidim_3": ("DoubleWell_multidim_3", dict(d=3, T=0.5, eta=2.0,
                                                 kappa=3.0), {}),
    "ou": ("DoubleWell_OU", dict(d=4, T=0.5, alpha=2.0, kappa=1.5), {}),
    "stopping": ("DoubleWell_stopping", dict(d=1, beta=1.5), {}),
    "stopping_linear": ("DoubleWell_stopping_linear", dict(d=1, beta=2.0),
                        {}),
    "hitting_time": ("DoubleWell_expectation_hitting_time",
                     dict(d=1, beta=1.0, dx=0.01, eta=2.0), {}),
    "committor": ("Committor_DoubleWell", dict(d=1, beta=1.0, eta=2.0,
                                               T=0.5), None),
    "llgc_general_f": ("LLGC_general_f", dict(d=3, off_diag=0.2, T=0.5,
                                              seed=7), None),
}

TABLES = ("_psi_np", "_u_np", "_psi1", "_u1", "_psi2", "_u2")


def _pair(case):
    cls, kw, ref = CASES[case]
    pj = getattr(jp, cls)(**kw)
    pt = getattr(tp, cls)(device="cpu", **kw)
    if ref is not None:
        pj.compute_reference_solution(**ref)
        pt.compute_reference_solution(**ref)
    return pj, pt


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(
        got, torch.Tensor) else got), np.asarray(want), rtol=RTOL,
        atol=RTOL, err_msg=what)


@pytest.mark.parametrize("case", list(CASES))
def test_coefficients_and_references_match_pspde(case, no_native):
    pj, pt = _pair(case)
    d = pj.d
    rng = np.random.default_rng(3)
    K = 64
    x = (1.2 * rng.standard_normal((K, d))).astype(np.float32)
    if pt.geometry is not None and pt.geometry.kind == "square":
        # inside the first-exit problems' one-sided square [-2, X_r]
        x = rng.uniform(-2.2, pt.geometry.X_r + 0.2, (K, d)).astype(
            np.float32)
    y = rng.standard_normal(K).astype(np.float32)
    z = rng.standard_normal((K, d)).astype(np.float32)
    t = np.float32(0.2)
    xj, yj, zj = jnp.asarray(x), jnp.asarray(y), jnp.asarray(z)
    xt, yt, zt = (torch.from_numpy(a) for a in (x, y, z))
    assert pt.d == pj.d and pt.T == pj.T and pt.name == pj.name
    assert pt.h_is_y_free == pj.h_is_y_free
    _close(pt.X_0, pj.X_0, "X_0")
    if pj.geometry is None:
        assert pt.geometry is None
    else:
        assert dataclasses.asdict(pt.geometry) == dataclasses.asdict(
            pj.geometry)
    assert pt.boundary_type == pj.boundary_type
    sj, st = pj.sigma_struct, pt.sigma_struct
    assert st.kind == sj.kind and st.scale == sj.scale
    _close(st.mat, sj.mat, "sigma")
    _close(pt.B, pj.B, "B")
    _close(pt.b(xt), pj.b(xj), "b")
    _close(pt.f(xt, 0.2), pj.f(xj, t), "f")
    if case == "committor":
        _close(pt.g(xt, 0.2), pj.g(xj, t), "g")
    else:
        _close(pt.g(xt), pj.g(xj), "g")
    if pj.T is None:
        _close(pt.h(xt, yt, zt), pj.h(xj, yj, zj), "h(x, y, z)")
    else:
        _close(pt.h(0.2, xt, yt, zt), pj.h(t, xj, yj, zj), "h")
    if hasattr(pj, "f_terminal"):
        _close(pt.f_terminal(xt), pj.f_terminal(xj), "f_terminal")
    for name in TABLES:
        if hasattr(pj, name):
            np.testing.assert_array_equal(getattr(pt, name),
                                          getattr(pj, name), err_msg=name)
    if hasattr(pj, "v_ref"):
        _close(pt.v_ref(xt), pj.v_ref(xj), "v_ref")
    if hasattr(pj, "u_ref"):
        _close(pt.u_ref(xt), pj.u_ref(xj), "u_ref")
    ts = np.arange(6) * 0.05
    for fn in ("v_ref_fn", "u_ref_fn"):
        if hasattr(pj, fn) and (case != "ou" or fn == "u_ref_fn"):
            fj, ft = getattr(pj, fn)(ts), getattr(pt, fn)(ts)
            for i in range(len(ts)):
                _close(ft(xt, i), fj(xj, i), f"{fn} at {i}")
    assert hasattr(pt, "v_ref_fn") == hasattr(pj, "v_ref_fn")
    assert hasattr(pt, "u_ref_fn") == hasattr(pj, "u_ref_fn")
    assert pt.has_v_ref == pj.has_v_ref and pt.has_u_ref == pj.has_u_ref


def test_exports_match_pspde():
    """``pspde_torch.problems`` exports every name ``pspde.problems``
    does, the alias and the registry's classes included, and none of the
    new problems claims a kernel family for what the kernels do not run."""
    assert sorted(tp.__all__) == sorted(jp.__all__)
    assert sorted(tp.REGISTRY) == sorted(jp.REGISTRY)
    assert tp.DoubleWell_multidim_for_general_solver is tp.DoubleWellGeneral
    for case in ("multidim_2", "ou", "stopping", "stopping_linear",
                 "hitting_time", "committor", "llgc_general_f"):
        _, pt = _pair(case)
        assert pt.drift_family() is None and pt.h_family() is None, case
    lin = tp.DoubleWellGeneral(d=2, modus="linear", device="cpu")
    assert lin.h_family() is None
    assert tp.DoubleWellGeneral(d=2, device="cpu").h_family() == (
        "quadratic_z", -1.0, 0.0)


# -- 20 steps against JAX on the scan ----------------------------------------

def _jax_noise(key, K, d, N):
    return np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(key, n), (K, d), dtype=jnp.float32))
        for n in range(N)])


def _assert_params(ts_net, jax_tree):
    got = dense_net_to_flax(list(ts_net.parameters()))
    for a, b in zip(jax.tree.leaves(got),
                    jax.tree.leaves(jax.device_get(jax_tree))):
        np.testing.assert_allclose(a, b, rtol=0, atol=PARAM_ATOL)


@pytest.mark.parametrize("case", ["general_linear", "committor"])
def test_general_solver_twenty_steps_match_jax(case, no_native):
    """tests/test_misc_coverage.py's GeneralSolver legs: diffusion, N=10,
    dt 0.01, K=64, K_boundary=16; each port step on the JAX step's draws
    (kb, kbt, kd, kt, kr = split(key, 5))."""
    pj, pt = _pair(case)
    K, KB, N = 64, 16, 10
    kw = dict(loss_method="diffusion", L=STEPS, N=N, delta_t=0.01, K=K,
              K_boundary=KB, lr=1e-3, verbose=False)
    js = JGeneral(pj, "j", value_net=JDenseNet(d_out=1, arch=(8, 8)), **kw)
    step = jax.jit(js._build_step())
    ts = TGeneral(pt, "t", device="cpu", **kw)
    ts.load_jax_params(jax.device_get(js.params))
    params, opt = js.params, js.opt_state
    key = jax.random.PRNGKey(21)
    j_loss = []
    for _ in range(STEPS):
        key, sub = jax.random.split(key)
        kb, kbt, kd, kt, kr = jax.random.split(sub, 5)
        draws = [np.array(a) for a in (
            j_domain(kd, pj.geometry, K, pj.d),
            jax.random.uniform(kt, (K,)) * pj.T,
            j_boundary(kb, pj.geometry, KB, pj.d),
            jax.random.uniform(kbt, (KB,)) * pj.T)]
        noise = _jax_noise(kr, K, pj.d, N)
        params, opt, aux = step(params, opt, sub)
        j_loss.append(float(aux["loss"]))
        X0, t0, Xb, tb = (torch.from_numpy(a) for a in draws)
        ts.step(X0=X0, t0=t0, Xb=Xb, tb=tb,
                host_noise=torch.from_numpy(noise))
    np.testing.assert_allclose(ts.loss_log, j_loss, rtol=TRAJ_RTOL)
    assert np.isfinite(ts.loss_log).all()
    _assert_params(ts.V_net, params)


def test_elliptic_solver_on_stopping_matches_jax(no_native):
    """``EllipticSolver`` on ``DoubleWell_stopping`` (d=1, the one-sided
    square [-2, 1], h(x, y, z) = -|z|^2/2 + 1): loss and V_L2 (against
    the FD table) for 20 steps on the JAX step's draws (kb, kd, kr)."""
    pj, pt = _pair("stopping")
    K, KB, N = 64, 16, 20
    kw = dict(loss_method="diffusion", L=STEPS, N=N, delta_t=0.01, K=K,
              K_boundary=KB, lr=1e-3, verbose=False)
    js = JElliptic(pj, "j", value_net=JDenseNet(d_out=1, arch=(8, 8)), **kw)
    step = jax.jit(js._build_step())
    ts = TElliptic(pt, "t", device="cpu", **kw)
    ts.load_jax_params(jax.device_get(js.params))
    params, opt = js.params, js.opt_state
    key = jax.random.PRNGKey(21)
    j_loss, j_vl2 = [], []
    for _ in range(STEPS):
        key, sub = jax.random.split(key)
        kb, kd, kr = jax.random.split(sub, 3)
        Xb = torch.from_numpy(np.asarray(j_boundary(kb, pj.geometry, KB, 1)))
        X0 = torch.from_numpy(np.asarray(j_domain(kd, pj.geometry, K, 1)))
        noise = torch.from_numpy(_jax_noise(kr, K, 1, N))
        params, opt, aux = step(params, opt, sub)
        j_loss.append(float(aux["loss"]))
        j_vl2.append(float(aux["V_L2"]))
        ts.step(X0=X0, Xb=Xb, host_noise=noise)
    np.testing.assert_allclose(ts.loss_log, j_loss, rtol=TRAJ_RTOL)
    np.testing.assert_allclose(ts.V_L2_log, j_vl2, rtol=TRAJ_RTOL)
    assert min(j_vl2) > 0 and min(ts.K_log) > 0
    _assert_params(ts.V_net, params)


@pytest.mark.parametrize("case", ["ou", "llgc_general_f"])
def test_hjb_solver_twenty_steps_match_jax(case, no_native):
    """``HJBSolver`` ('inner' control, log-variance, K=64, dt 0.05) on
    ``DoubleWell_OU`` (u_L2 against the FD table beside the OU block's
    closed form) and on ``LLGC_general_f`` (its non-quadratic h):
    loss and u_L2 for 20 steps on the JAX step's noise (kx, kr)."""
    from tests.test_torch_hjb_outer_value import (_assert_tree_close,
                                                  _port_state, _template)
    pj, pt = _pair(case)
    K, dt = 64, 0.05
    kw = dict(lr=1e-2, L=STEPS, K=K, delta_t=dt, time_approx="inner",
              loss_method="log-variance", detach_forward=True,
              verbose=False, early_stopping_time=None)
    js = JHJB("j", pj, **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ts = THJB("t", pt, device="cpu", **kw)
    ts.load_jax_params(jax.device_get(js.params))
    step = jax.jit(js._build_step(0))
    params, opt = js.params, js.opt_state
    key = jax.random.PRNGKey(11)
    j_loss, j_ul2 = [], []
    for _ in range(STEPS):
        key, sub = jax.random.split(key)
        _, kr = jax.random.split(sub)
        noise = _jax_noise(kr, K, pj.d, js.N)
        params, opt, m = step(params, opt, sub)
        j_loss.append(float(m["loss"]))
        j_ul2.append(float(m["u_l2"]))
        ts.step(host_noise=torch.from_numpy(noise))
    np.testing.assert_allclose(ts.loss_log, j_loss, rtol=TRAJ_RTOL)
    np.testing.assert_allclose(ts.u_L2_loss, j_ul2, rtol=TRAJ_RTOL)
    assert min(j_ul2) > 0
    _assert_tree_close(_port_state(ts._net), _template(ts._net),
                       params["z"], 0, PARAM_ATOL, "parameter")


def test_chip_smoke_fd_fingerprints_are_the_cpu_tables(no_native):
    """Phase 39 (d) holds the FD tables that the card's host builds to
    ``chip_smoke.NB_FD_PRINTS``: these are the fingerprints of the port's
    tables here, which are bitwise pspde's (the coefficient test above)."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_fd", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    probs = cs.nb_problems(torch.device("cpu"))
    assert sorted(probs) == sorted(cs.NB_FD_PRINTS)
    jax_tables = {"stopping": jp.DoubleWell_stopping(d=1),
                  "ou": jp.DoubleWell_OU(d=3)}
    for name, prob in jax_tables.items():
        prob.compute_reference_solution()
        for attr, table in zip(("_psi_np", "_u_np"), probs[name][1]):
            np.testing.assert_array_equal(table, getattr(prob, attr))
    for name, (_, tables) in probs.items():
        np.testing.assert_allclose(cs.fd_fingerprint(*tables),
                                   cs.NB_FD_PRINTS[name], rtol=1e-12,
                                   atol=0, err_msg=name)


def test_chip_smoke_general_linear_witness_matches_jax(no_native):
    """Phase 39 (d)'s general_linear reading, the RMS of V against the
    product of the 1-d psi (``chip_smoke.general_err``), on JAX's seed-42
    initial net (``pspde_torch/assets/dw_general_linear_d2_densenet.npz``):
    the port's equals JAX's at the same points
    (``experiments/notebooks_11a_reference.py``'s ``general_points``) and
    the untrained reading that the card is held to."""
    import importlib.util
    import pathlib

    from experiments.notebooks_11a_reference import general_points
    from pspde_torch.utils.convert import load_control_npz
    root = pathlib.Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke_gl",
                                                  root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    tree = load_control_npz(str(root / "pspde_torch" / "assets"
                                / "dw_general_linear_d2_densenet.npz"))[0]
    kw = dict(N=10, delta_t=0.01, K=64, K_boundary=16, verbose=False)
    jprob = jp.DoubleWellGeneral(d=2, d_1=1, d_2=1, T=0.5, modus="linear")
    jprob.compute_reference_solution(delta_t=0.01, nx=300)
    js = JGeneral(jprob, "lin", loss_method="diffusion", L=1, **kw)
    init = jax.device_get(js.params)
    tprob = tp.DoubleWellGeneral(d=2, d_1=1, d_2=1, T=0.5, modus="linear",
                                 device="cpu")
    tprob.compute_reference_solution(delta_t=0.01, nx=300)
    ts = TGeneral(tprob, "lin", loss_method="diffusion", L=1, device="cpu",
                  **kw)
    ts.load_jax_params(tree)
    # the asset is JAX's seed-42 initial net
    flat = jax.tree_util.tree_leaves(init)
    assert len(flat) == len(jax.tree_util.tree_leaves(tree))
    for a, b in zip(flat, jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    X = jnp.asarray(general_points(2))
    np.testing.assert_array_equal(
        np.asarray(X), np.random.default_rng(393).uniform(
            -2.5, 2.5, (4096, 2)).astype(np.float32))
    times = np.arange(js.N + 1) * js.delta_t
    v_ref, v = jprob.v_ref_fn(times), js._v_fn(init)
    j_err = float(jnp.sqrt(jnp.mean(jnp.stack([
        jnp.mean((v(X, jnp.full((4096,), float(t), dtype=X.dtype))
                  - v_ref(X, i)) ** 2) for i, t in enumerate(times)]))))
    t_err = cs.general_err(ts, tprob, torch.device("cpu"))
    np.testing.assert_allclose(t_err, j_err, rtol=1e-5)
    np.testing.assert_allclose(t_err, cs.NB_D_BEFORE_JAX, rtol=1e-5)
