"""The port's semigroup power iteration (``pspde_torch/eval/
eigen_power.py``) and its FD oracle (``pspde_torch/problems/fd_oracles.py:
generator_spectrum_periodic_1d``) against pspde's (CPU).

The periodic wrap against ``lo + jnp.mod(X - lo, width)`` bitwise on
points that straddle both faces; on JAX's own draws, handed in through the
hooks (the anchors from pspde's key splits, each step's normals
``jax.random.normal(fold_in(k, n), (R, d))``) and the same nets:
``fk_semigroup_targets`` with the linear W and the SCF W_of, path by path
(K_inner = 1, rtol 2e-5) and averaged (rtol 2e-4, with a floor of 1e-6
of the largest for an average that cancels to near 0); the stage loops of
``eigen_power_refine`` ('linear' with 'center', 'scf' with 'l2') and of
``eigen_subspace_refine`` (the Ritz values), stage by stage from the
port's parameters (tests/test_torch_picard.py says why): refit parameters
atol 2e-5 against optax.adam, lambda_growth, reg_loss and the Ritz values
rtol 2e-4; each loop bitwise against its chained single stages; the FD
spectrum bitwise.  Then pspde's own oracle tests (tests/test_picard.py's
power-iteration cases, tests/test_eigen_solver.py's subspace case) on the
port: at their sizes, except ``test_eigen_power_refine_contracts``, whose
K_inner is cut from 256 to 64 to run in ~10 s here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pspde.problems as jp
from pspde.ansatz import DenseNet as JDenseNet
from pspde.ansatz import DenseNetTanh as JDenseNetTanh
from pspde.eval import eigen_power_refine as j_power
from pspde.eval import eigen_subspace_refine as j_subspace
from pspde.eval import fk_semigroup_targets as j_targets
from pspde.problems.fd_oracles import \
    generator_spectrum_periodic_1d as j_spectrum
import pspde_torch.problems as tp
from pspde_torch.ansatz import DenseNet, DenseNetTanh
from pspde_torch.eval import (eigen_power_refine, eigen_subspace_refine,
                              fk_semigroup_targets)
from pspde_torch.eval.eigen_power import wrap
from pspde_torch.problems.fd_oracles import generator_spectrum_periodic_1d
from pspde_torch.utils.convert import dense_net_to_flax
from tests.torch_correctors import one_thread  # noqa: F401
from tests.torch_correctors import (close, jax_noise, means_close,
                                    params_close, paths_close, to_torch_net,
                                    tt)

TWO_PI = 2.0 * np.pi


def _pair(name, d):
    return getattr(jp, name)(d=d), getattr(tp, name)(d=d, device="cpu")


def _net(cls_j, cls_t, d, seed, arch=(12, 8)):
    net = cls_j(d_out=1, arch=arch)
    params = net.init(jax.random.PRNGKey(seed), jnp.zeros((1, d)))
    return net, params, to_torch_net(net, params, cls_t)


def test_wrap_matches_jnp_mod_bitwise():
    rng = np.random.default_rng(0)
    eps = np.float32(TWO_PI) * np.float32(2.0 ** -23)
    faces = np.array([0.0, TWO_PI, -TWO_PI, 2 * TWO_PI], np.float32)
    X = np.concatenate([
        (faces[:, None] + np.linspace(-64, 64, 129)[None, :] * eps).ravel(),
        rng.uniform(-3 * TWO_PI, 4 * TWO_PI, 4096),
        [-1e-30, -0.0, 1e-30, -TWO_PI * (1 + 1e-7)]]).astype(np.float32)
    X = X.reshape(-1, 2)
    want = np.asarray(0.0 + jnp.mod(jnp.asarray(X) - 0.0, TWO_PI - 0.0))
    got = wrap(torch.from_numpy(X), 0.0, TWO_PI).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 0.0 and got.max() <= np.float32(TWO_PI)


def _scf_W(h, v_fn, lib):
    def W_of(X):
        v = lib.maximum(v_fn(X), 1e-3) if lib is jnp else torch.clamp_min(
            v_fn(X), 1e-3)
        return h(X, v, None) / v
    return W_of


@pytest.mark.parametrize("case,K_inner", [("linear", 1), ("linear", 16),
                                          ("scf", 1)])
def test_fk_semigroup_targets_match_jax(case, K_inner):
    name = "FokkerPlanckEigen" if case == "linear" else "SchrodingerEigen"
    pj, pt = _pair(name, 2)
    net, params, tnet = _net(JDenseNetTanh, DenseNetTanh, 2, 1)

    def vj(X):
        return net.apply(params, X)[:, 0]

    def vt(X):
        return tnet(X)[:, 0]

    M = 1024 if K_inner == 1 else 128
    Xs = TWO_PI * jax.random.uniform(jax.random.PRNGKey(2), (M, 2))
    key = jax.random.PRNGKey(7)
    Wj = Wt = None
    if case == "scf":
        Wj, Wt = _scf_W(pj.h, vj, jnp), _scf_W(pt.h, vt, torch)
    # T_horizon 0.3 at dt 0.01: N = round(30.000000000000004) = 30, each
    # path crossing the faces of the box several times
    want = j_targets(pj, vj, Xs, K_inner, 0.3, 0.01, key, W_of=Wj)
    got = fk_semigroup_targets(pt, vt, tt(Xs), K_inner, 0.3, 0.01, W_of=Wt,
                               noise_fn=jax_noise(key, M * K_inner, 2))
    (paths_close if K_inner == 1 else means_close)(got, want)


def _key_chain(key, n, parts):
    keys = [key]
    for _ in range(n):
        keys.append(jax.random.split(keys[-1], parts)[0])
    return keys


def _power_draws(pj, key, M, K_inner, K_center):
    """pspde's eigen_power_refine draws of one stage, as the hook takes
    them."""
    _, ka, kr, kc = jax.random.split(key, 4)
    lo, hi = pj.geometry.X_l, pj.geometry.X_r
    Xs = lo + (hi - lo) * jax.random.uniform(ka, (M, pj.d))
    stage = {"Xs": tt(Xs), "noise": jax_noise(kr, M * K_inner, pj.d),
             "center_noise": jax_noise(kc, K_center, pj.d)}
    return stage


@pytest.mark.parametrize("mode,normalization,name", [
    ("linear", "center", "FokkerPlanckEigen"),
    ("scf", "l2", "SchrodingerEigen")])
def test_eigen_power_refine_stages_match_jax(mode, normalization, name,
                                             capsys):
    pj, pt = _pair(name, 2)
    net, params, tnet = _net(JDenseNet, DenseNet, 2, 5)
    kw = dict(T_horizon=0.2, M=64, K_inner=16, delta_t=0.01, reg_steps=100,
              reg_lr=3e-3, K_center=512, mode=mode,
              normalization=normalization)
    keys = _key_chain(jax.random.PRNGKey(10), 2, 4)
    stages, p_t, hist = [], tnet, []
    for s in range(2):
        stage = _power_draws(pj, keys[s], 64, 16, 512)
        stages.append(stage)
        start = dense_net_to_flax(list(p_t.parameters()))
        p_j, hist_j = j_power(pj, net, start, n_stages=1, key=keys[s], **kw)
        p_t, hist_t = eigen_power_refine(pt, p_t, n_stages=1, verbose=True,
                                         draws=lambda _, st=stage: st, **kw)
        params_close(p_t, p_j)
        for k in ("lambda_growth", "reg_loss"):
            close(hist_t[0][k], hist_j[0][k])
        hist += hist_t
    assert capsys.readouterr().out.count("power stage") == 2
    p2, hist2 = eigen_power_refine(pt, tnet, n_stages=2,
                                   draws=lambda s: stages[s], **kw)
    assert hist2 == hist and all(torch.equal(a, b) for a, b in zip(
        p2.parameters(), p_t.parameters()))


def test_eigen_subspace_refine_stages_match_jax():
    pj, pt = _pair("FokkerPlanckEigen", 1)
    # two nets, as pspde's oracle test: a third would split the nearly
    # degenerate sin/cos pair, whose Ritz vectors float32 rounding turns
    nets = [_net(JDenseNetTanh, DenseNetTanh, 1, j) for j in range(2)]
    net = nets[0][0]
    kw = dict(T_horizon=0.3, M=128, K_inner=16, delta_t=0.01, reg_steps=100,
              reg_lr=3e-3)
    keys = _key_chain(jax.random.PRNGKey(1), 2, 4)
    ps_t, stages, hist = [n[2] for n in nets], [], []
    for s in range(2):
        _, ka, *kts = jax.random.split(keys[s], 4)
        Xs = TWO_PI * jax.random.uniform(ka, (128, 1))
        stage = {"Xs": tt(Xs),
                 "noise": [jax_noise(k, 128 * 16, 1) for k in kts]}
        stages.append(stage)
        starts = [dense_net_to_flax(list(q.parameters())) for q in ps_t]
        ps_j, hist_j = j_subspace(pj, net, starts, n_stages=1, key=keys[s],
                                  **kw)
        ps_t, hist_t = eigen_subspace_refine(
            pt, ps_t, n_stages=1, draws=lambda _, st=stage: st, **kw)
        for q_t, q_j in zip(ps_t, ps_j):
            params_close(q_t, q_j)
        close(hist_t[0]["lambdas"], hist_j[0]["lambdas"], atol=2e-4)
        close(hist_t[0]["reg_loss"], hist_j[0]["reg_loss"])
        hist += hist_t
    ps2, hist2 = eigen_subspace_refine(pt, [n[2] for n in nets], n_stages=2,
                                       draws=lambda s: stages[s], **kw)
    assert hist2 == hist and all(
        torch.equal(a, b) for q2, q in zip(ps2, ps_t)
        for a, b in zip(q2.parameters(), q.parameters()))


def _fp_coefficients_1d(p, lib):
    def b1(x):
        return np.asarray(p.b(lib(np.asarray(x, np.float32)[:, None])))[:, 0]

    def W1(x):
        xj = lib(np.asarray(x, np.float32)[:, None])
        return np.asarray(p.h(xj, lib(np.ones(len(x), np.float32)), None))

    return b1, W1


@pytest.mark.parametrize("n,k", [(64, 4), (256, 3)])
def test_generator_spectrum_periodic_1d_bitwise(n, k):
    pj, _ = _pair("FokkerPlanckEigen", 1)
    b1, W1 = _fp_coefficients_1d(pj, jnp.asarray)
    want = j_spectrum(b1, W1, n=n, k=k)
    got = generator_spectrum_periodic_1d(b1, W1, n=n, k=k)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# -- pspde's oracle tests on the port ----------------------------------------

def test_fk_semigroup_fixes_eigenfunction():
    p = tp.FokkerPlanckEigen(d=2, device="cpu")
    g = torch.Generator().manual_seed(4)
    Xs = TWO_PI * torch.rand((32, 2), generator=g)
    t = fk_semigroup_targets(p, p.v_ref, Xs, K_inner=512, T_horizon=0.5,
                             delta_t=2e-3, generator=g)
    rel = torch.abs(t - p.v_ref(Xs)) / p.v_ref(Xs)
    assert float(torch.mean(rel)) < 0.02, float(torch.mean(rel))


def _fit(net, X, targets, steps, lr):
    opt = torch.optim.Adam(net.parameters(), lr=lr)
    for _ in range(steps):
        opt.zero_grad()
        torch.mean((net(X)[:, 0] - targets) ** 2).backward()
        opt.step()


def test_eigen_power_refine_contracts():
    p = tp.FokkerPlanckEigen(d=2, device="cpu")
    g = torch.Generator().manual_seed(8)
    net = DenseNet(1, (12, 12), d_in=2, generator=g, device="cpu")
    Xf = TWO_PI * torch.rand((2048, 2), generator=g)
    _fit(net, Xf, p.v_ref(Xf) * (1.0 + 0.2 * torch.sin(Xf[:, 0])), 1200,
         1e-2)
    Xt = TWO_PI * torch.rand((4096, 2), generator=torch.Generator()
                             .manual_seed(9))
    vr = p.v_ref(Xt)
    with torch.no_grad():
        mse0 = float(torch.mean((net(Xt)[:, 0] - vr) ** 2))
    assert mse0 > 2e-3
    refined, hist = eigen_power_refine(
        p, net, n_stages=2, T_horizon=1.5, M=1024, K_inner=64,
        delta_t=2e-3, reg_steps=4000, K_center=8192, generator=10)
    with torch.no_grad():
        mse1 = float(torch.mean((refined(Xt)[:, 0] - vr) ** 2))
    assert mse1 < mse0 / 4, (mse0, mse1, hist)


def test_eigen_power_scf_schrodinger():
    p = tp.SchrodingerEigen(d=2, device="cpu")
    g = torch.Generator().manual_seed(12)
    Xs = TWO_PI * torch.rand((32, 2), generator=g)
    T = 0.3
    t = fk_semigroup_targets(p, p.v_ref, Xs, K_inner=1024, T_horizon=T,
                             delta_t=2e-3, generator=g,
                             W_of=_scf_W(p.h, p.v_ref, torch))
    lam_hat = float(-torch.log(torch.mean(t / p.v_ref(Xs))) / T)
    assert abs(lam_hat - p.lambda_true) < 0.15, lam_hat


def test_eigen_subspace_spectral_gap_matches_fd_oracle():
    p = tp.FokkerPlanckEigen(d=1, device="cpu")
    b1, W1 = _fp_coefficients_1d(p, torch.from_numpy)
    _, lam_fd, _ = generator_spectrum_periodic_1d(b1, W1, n=256)
    assert abs(lam_fd[0]) < 1e-4
    assert abs(lam_fd[1] - 1.0) < 0.05
    Xs = TWO_PI * torch.rand((1024, 1),
                             generator=torch.Generator().manual_seed(7))
    inits = [torch.ones(1024), torch.sin(Xs[:, 0])]
    nets = []
    for j, target in enumerate(inits):
        net = DenseNetTanh(1, (20, 20), d_in=1, device="cpu",
                           generator=torch.Generator().manual_seed(j))
        _fit(net, Xs, target, 1500, 3e-3)
        nets.append(net)
    _, hist = eigen_subspace_refine(
        p, nets, n_stages=3, T_horizon=0.5, M=1024, K_inner=32,
        delta_t=0.01, reg_steps=1500, reg_lr=3e-3, generator=1)
    lams = hist[-1]["lambdas"]
    assert abs(lams[0] - lam_fd[0]) < 0.05
    assert abs(lams[1] - lam_fd[1]) < 0.15
