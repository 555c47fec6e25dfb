"""The port's Picard refinement (``pspde_torch/eval/picard.py``) against
pspde's (CPU).

On JAX's own draws, handed in through the hooks (each stage's anchors
from pspde's key splits, each step's normals ``jax.random.normal(
fold_in(k, n), (R, d))``, a slice's key ``fold_in(kr, j)``) and the same
net (a Flax DenseNet and its conversion): ``_mc_targets`` with a per-row
clock, path by path (K_inner = 1, rtol 2e-5) and averaged (rtol 2e-4);
``mc_targets_elliptic`` likewise, with cap_frac exact; the stage loops of
``picard_refine`` ('tube' with the diffusion spread and with an
anchor_radius, 'domain' with x0=None) and of ``picard_refine_elliptic``
(several slices, damping, uniform_square), stage by stage from the port's
parameters: the refit parameters atol 2e-5 against optax.adam, reg_loss
and the readout rtol 2e-4; and each multi-stage loop bitwise against its
chained single stages.  The committor's
spheres carry a continuous g here (tests/test_torch_refine.py says why).
Then pspde's own oracle tests (tests/test_picard.py, parabolic and
elliptic) on the port at their sizes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pspde.problems as jp
from pspde.ansatz import DenseNet as JDenseNet
from pspde.ansatz import DenseNetTanh2 as JDenseNetTanh2
from pspde.eval import picard_refine as j_picard
from pspde.eval import picard_refine_elliptic as j_picard_ell
from pspde.eval.picard import _mc_targets as j_mc_targets
from pspde.eval.picard import mc_targets_elliptic as j_mc_ell
from pspde.rollout.sampling import sample_domain as j_sample_domain
import pspde_torch.problems as tp
from pspde_torch.ansatz import DenseNet, DenseNetTanh2
from pspde_torch.eval import (compute_test_error, picard_refine,
                              picard_refine_elliptic)
from pspde_torch.eval.picard import _mc_targets, mc_targets_elliptic
from pspde_torch.rollout.sampling import sample_domain
from pspde_torch.utils.convert import dense_net_to_flax
from tests.torch_correctors import one_thread  # noqa: F401
from tests.torch_correctors import (ELLIPTIC, JaxZH, LinearH, TorchZH,
                                    ball_net, close, jax_noise, means_close,
                                    params_close, paths_close,
                                    space_time_net, to_torch_net, tt)

PARABOLIC = {
    "allen_cahn": lambda: (jp.AllenCahn(d=3, T=0.2),
                           tp.AllenCahn(d=3, T=0.2, device="cpu")),
    "zh": lambda: (JaxZH(d=3), TorchZH(d=3)),
    "heat": lambda: (jp.HeatEquation(d=3, T=0.2),
                     tp.HeatEquation(d=3, T=0.2, device="cpu")),
}


def _anchors(pj, M, seed=1):
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    ts = jax.random.uniform(k1, (M,), minval=0.0, maxval=pj.T)
    Xs = 0.5 * jax.random.normal(k2, (M, pj.d))
    return ts, Xs


@pytest.mark.parametrize("case,K_inner", [("zh", 1), ("allen_cahn", 1),
                                          ("allen_cahn", 16)])
def test_mc_targets_match_jax(case, K_inner):
    pj, pt = PARABOLIC[case]()
    vj, vt = space_time_net(3)
    M = 1024 if K_inner == 1 else 128
    ts, Xs = _anchors(pj, M)
    key = jax.random.PRNGKey(9)
    dt = 0.007   # N_max = ceil(0.2 / 0.007) = 29, the last step partial
    want = j_mc_targets(pj, vj, ts, Xs, K_inner, dt, key)
    got = _mc_targets(pt, vt, tt(ts), tt(Xs), K_inner, dt,
                      noise_fn=jax_noise(key, M * K_inner, 3))
    assert got.shape == (M,)
    (paths_close if K_inner == 1 else means_close)(got, want)


@pytest.mark.parametrize("case,K_inner,N_cap", [("committor", 1, 640),
                                                ("ball_sin", 1, 256),
                                                ("ball_sin", 16, 40)])
def test_mc_targets_elliptic_match_jax(case, K_inner, N_cap):
    pj, pt = ELLIPTIC[case]()
    vj, vt = ball_net(3)
    M = 1024 if K_inner == 1 else 128
    Xs = j_sample_domain(jax.random.PRNGKey(2), pj.geometry, M, 3)
    key = jax.random.PRNGKey(6)
    want, cf_j = j_mc_ell(pj, vj, Xs, K_inner, N_cap, 5e-3, key)
    got, cf_t = mc_targets_elliptic(pt, vt, tt(Xs), K_inner, N_cap, 5e-3,
                                    noise_fn=jax_noise(key, M * K_inner, 3))
    (paths_close if K_inner == 1 else means_close)(got, want)
    assert float(cf_t) == float(cf_j)
    assert (float(cf_t) > 0) == (N_cap == 40)


def _jax_picard_draws(pj, key, n_stages, M, K_inner, readout_K, x0,
                      anchors, anchor_radius):
    """pspde's picard_refine draws, stage by stage, as the hook takes them."""
    sig = np.asarray(pj.sigma_struct.mat)
    spread = float(np.sqrt(np.trace(sig @ sig.T) / pj.d))
    stages = []
    for _ in range(n_stages):
        key, ka, kt, kr, ku = jax.random.split(key, 5)
        ts = jax.random.uniform(kt, (M,), minval=0.0, maxval=pj.T)
        if anchors == "domain":
            Xs = j_sample_domain(ka, pj.geometry, M, pj.d)
        else:
            z = jax.random.normal(ka, (M, pj.d))
            scale = (jnp.sqrt(ts)[:, None] * spread if anchor_radius is None
                     else anchor_radius * jax.random.uniform(ku, (M, 1)))
            Xs = x0[None, :] + scale * z
        stages.append({"ts": tt(ts), "Xs": tt(Xs),
                       "noise": jax_noise(kr, M * K_inner, pj.d)})
    readout = {"noise": jax_noise(key, readout_K, pj.d)}
    return lambda s: readout if s == "readout" else stages[s]


def _key_chain(key, n, parts):
    """The key each stage of a pspde driver starts from (its loop splits
    ``key`` into ``parts`` and keeps the first)."""
    keys = [key]
    for _ in range(n):
        keys.append(jax.random.split(keys[-1], parts)[0])
    return keys


@pytest.mark.parametrize("case,anchors,anchor_radius", [
    ("allen_cahn", "tube", None), ("zh", "tube", 0.5),
    ("heat", "domain", None)])
def test_picard_refine_stages_match_jax(case, anchors, anchor_radius,
                                        capsys):
    """Stage by stage from the port's own parameters (Adam's first step
    moves every parameter by ~lr whatever its gradient's size, so two
    stages compound float32 rounding: the refits are held one stage at a
    time), then the two-stage loop against the chained stages, bitwise."""
    pj, pt = PARABOLIC[case]()
    net = JDenseNet(d_out=1, arch=(12, 8))
    params = net.init(jax.random.PRNGKey(4), jnp.zeros((1, 4)))
    tnet = to_torch_net(net, params, DenseNet)
    before = [q.detach().clone() for q in tnet.parameters()]
    x0 = None if anchors == "domain" else jnp.asarray([0.3, -0.2, 0.1])
    x0t = None if x0 is None else tt(x0)
    kw = dict(M=64, K_inner=16, delta_t=0.01, reg_steps=100, reg_lr=3e-3,
              readout_K=2048, anchors=anchors, anchor_radius=anchor_radius)
    keys = _key_chain(jax.random.PRNGKey(8), 2, 5)
    p_t = tnet
    for s in range(2):
        start = dense_net_to_flax(list(p_t.parameters()))
        val_j, se_j, p_j = j_picard(pj, net, start, x0, n_stages=1,
                                    key=keys[s], **kw)
        val_t, se_t, p_t = picard_refine(
            pt, p_t, x0t, n_stages=1, verbose=True, draws=_jax_picard_draws(
                pj, keys[s], 1, 64, 16, 2048, x0, anchors, anchor_radius),
            **kw)
        params_close(p_t, p_j)
        if x0 is None:
            assert val_j is None and val_t is None and se_t is None
        else:
            close(val_t, val_j)
            close(se_t, se_j)
    assert capsys.readouterr().out.count("picard stage") == 2
    val2, se2, p2 = picard_refine(pt, tnet, x0t, n_stages=2, draws=(
        _jax_picard_draws(pj, keys[0], 2, 64, 16, 2048, x0, anchors,
                          anchor_radius)), **kw)
    assert all(torch.equal(a, b) for a, b in zip(p2.parameters(),
                                                 p_t.parameters()))
    assert (val2 is None) == (x0 is None)
    if x0 is not None:
        assert torch.equal(val2, val_t) and torch.equal(se2, se_t)
    # the caller's net is left as it was
    assert all(torch.equal(a, b) for a, b in zip(before, tnet.parameters()))


def _jax_elliptic_draws(pj, key, n_stages, M, K_inner, per_slice,
                        uniform_square):
    stages = []
    for _ in range(n_stages):
        key, ka, kr = jax.random.split(key, 3)
        Xs = j_sample_domain(ka, pj.geometry, M, pj.d,
                             uniform_square=uniform_square)
        sizes = [min(per_slice, M - j) for j in range(0, M, per_slice)]
        noises = [jax_noise(jax.random.fold_in(kr, j), s * K_inner, pj.d)
                  for j, s in enumerate(sizes)]
        stages.append({"Xs": tt(Xs),
                       "noise": lambda j, n, nz=noises: nz[j](n)})
    return lambda s: stages[s]


@pytest.mark.parametrize("case,damping,uniform_square,max_paths", [
    ("ball_sin", 0.5, True, 300), ("committor", 1.0, False, 1 << 20)])
def test_picard_refine_elliptic_stages_match_jax(case, damping,
                                                 uniform_square, max_paths):
    """Stage by stage, then the loop against the chained stages bitwise
    (test_picard_refine_stages_match_jax says why)."""
    pj, pt = ELLIPTIC[case]()
    # the committor notebook's tanh^2 net there: a relu^2 feature at 0 on
    # every anchor has a gradient of 0 in one and ~1e-11 in the other, and
    # Adam's step divides it by sqrt(v) + 1e-8
    jcls, tcls = ((JDenseNetTanh2, DenseNetTanh2) if case == "committor"
                  else (JDenseNet, DenseNet))
    net = jcls(d_out=1, arch=(12, 8))
    params = net.init(jax.random.PRNGKey(3), jnp.zeros((1, 3)))
    tnet = to_torch_net(net, params, tcls)
    M, K_inner = 64, 16
    kw = dict(M=M, K_inner=K_inner, N_cap=64, delta_t=5e-3, reg_steps=100,
              reg_lr=3e-3, damping=damping, uniform_square=uniform_square,
              max_paths_per_call=max_paths)
    per_slice = max(1, min(M, max_paths // K_inner))
    keys = _key_chain(jax.random.PRNGKey(12), 2, 3)
    p_t, hist = tnet, []
    for s in range(2):
        start = dense_net_to_flax(list(p_t.parameters()))
        p_j, hist_j = j_picard_ell(pj, net, start, n_stages=1, key=keys[s],
                                   **kw)
        p_t, hist_t = picard_refine_elliptic(
            pt, p_t, n_stages=1, draws=_jax_elliptic_draws(
                pj, keys[s], 1, M, K_inner, per_slice, uniform_square),
            **kw)
        params_close(p_t, p_j)
        close(hist_t[0]["reg_loss"], hist_j[0]["reg_loss"])
        assert hist_t[0]["cap_frac"] == hist_j[0]["cap_frac"]
        hist += hist_t
    assert all(h["cap_frac"] > 0 for h in hist)
    p2, hist2 = picard_refine_elliptic(pt, tnet, n_stages=2, draws=(
        _jax_elliptic_draws(pj, keys[0], 2, M, K_inner, per_slice,
                            uniform_square)), **kw)
    assert hist2 == hist and all(torch.equal(a, b) for a, b in zip(
        p2.parameters(), p_t.parameters()))


def test_picard_refine_elliptic_own_slices_are_seeded_per_slice():
    """Without the hook: one slice or four give targets of one law, and a
    seed repeats the run."""
    _, pt = ELLIPTIC["ball_sin"]()
    net = DenseNet(1, (8,), d_in=3, generator=torch.Generator().manual_seed(0),
                   device="cpu")
    kw = dict(n_stages=1, M=64, K_inner=32, N_cap=600, delta_t=5e-3,
              reg_steps=20, generator=5)
    a, ha = picard_refine_elliptic(pt, net, **kw)
    b, hb = picard_refine_elliptic(pt, net, **kw)
    c, hc = picard_refine_elliptic(pt, net, max_paths_per_call=512, **kw)
    assert ha == hb and all(torch.equal(x, y) for x, y in
                            zip(a.parameters(), b.parameters()))
    assert ha[0]["cap_frac"] == hc[0]["cap_frac"] == 0.0


# -- pspde's oracle tests (tests/test_picard.py) on the port ----------------

def test_picard_converges_from_crude_net():
    p = LinearH(d=3, T=0.25)
    x0 = torch.tensor([0.3, -0.2, 0.1])
    true0 = float(p.v_true(x0[None], torch.zeros(1))[0])
    net = DenseNet(1, (24, 24), d_in=4, device="cpu",
                   generator=torch.Generator().manual_seed(0))
    val, stderr, _ = picard_refine(p, net, x0, n_stages=3, M=512,
                                   K_inner=128, delta_t=5e-3, reg_steps=1500,
                                   readout_K=100_000, generator=0)
    rel = abs(float(val) - true0) / true0
    assert rel < 0.02, (float(val), true0, rel, float(stderr))


def _fit(net, X, targets, steps, lr):
    opt = torch.optim.Adam(net.parameters(), lr=lr)
    for _ in range(steps):
        opt.zero_grad()
        torch.mean((net(X)[:, 0] - targets) ** 2).backward()
        opt.step()


def test_picard_elliptic_contracts_committor():
    p = tp.Committor(d=3, device="cpu")
    net = DenseNetTanh2(1, (16, 8, 8), d_in=3, device="cpu",
                        generator=torch.Generator().manual_seed(7))
    Xfit = sample_domain(torch.Generator().manual_seed(1), p.geometry, 2048,
                         3)
    _fit(net, Xfit, 0.7 * p.v_ref(Xfit) + 0.15, 800, 1e-2)
    Xtest = sample_domain(torch.Generator().manual_seed(2), p.geometry, 4096,
                          3)
    vr = p.v_ref(Xtest)
    with torch.no_grad():
        mse_before = float(torch.mean((net(Xtest)[:, 0] - vr) ** 2))
    assert mse_before > 5e-3
    refined, hist = picard_refine_elliptic(
        p, net, n_stages=1, M=512, K_inner=256, N_cap=512, delta_t=5e-3,
        reg_steps=2000, reg_lr=3e-3, generator=3)
    with torch.no_grad():
        mse_after = float(torch.mean((refined(Xtest)[:, 0] - vr) ** 2))
    assert hist[0]["cap_frac"] < 1e-3, hist
    assert mse_after < mse_before / 5.0, (mse_before, mse_after)


def test_mc_targets_elliptic_exact_model():
    p = tp.Committor(d=3, device="cpu")
    Xs = sample_domain(torch.Generator().manual_seed(5), p.geometry, 64, 3)
    targets, cap_frac = mc_targets_elliptic(p, p.v_ref, Xs, K_inner=512,
                                            N_cap=512, delta_t=5e-3,
                                            generator=6)
    assert float(cap_frac) < 1e-3
    assert float(torch.mean(torch.abs(targets - p.v_ref(Xs)))) < 0.03


def test_picard_domain_anchors_refine_function_wide():
    p = tp.HeatEquation(d=5, T=0.2, device="cpu")
    p.geometry = tp.Geometry(kind="unbounded", boundary_distance=2.0)
    net = DenseNet(1, (25, 10, 10), d_in=6, device="cpu",
                   generator=torch.Generator().manual_seed(3))

    def mre(q):
        with torch.no_grad():
            return float(compute_test_error(
                lambda XT: q(XT)[:, 0], p, 8192,
                torch.Generator().manual_seed(9), modus="parabolic")[2])

    mre0 = mre(net)
    val, stderr, refined = picard_refine(
        p, net, x0=None, anchors="domain", n_stages=1, M=1024, K_inner=256,
        delta_t=4e-3, reg_steps=3000, generator=3)
    assert val is None and stderr is None
    mre1 = mre(refined)
    assert mre1 < 0.05, (mre0, mre1)
    assert mre1 < 0.2 * mre0
    with pytest.raises(ValueError, match="x0"):
        picard_refine(p, net, x0=None, anchors="tube")
    with pytest.raises(ValueError, match="anchors"):
        picard_refine(p, net, x0=None, anchors="sphere")
