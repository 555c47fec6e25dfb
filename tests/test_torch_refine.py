"""The port's Feynman-Kac refinement (``pspde_torch/eval/refine.py``)
against pspde's (CPU).

On JAX's own normals (``jax.random.normal(fold_in(key, n), (K, d))``,
handed in through ``noise_fn``) and the same net (a Flax DenseNet and its
conversion): ``feynman_kac_refine`` with and without z on HeatEquation,
AllenCahn and a test problem whose h reads t, y and z (drift -x/2, a
diagonal sigma), at t0 = 0 and 0.05; ``bgk_closures`` on points that
straddle the shifted spheres; ``feynman_kac_refine_elliptic`` on the
committor's spheres (with a continuous g) and the sin-nonlinear ball, where every path exits long before
N_cap (the port's chain ends there, JAX scans all N_cap steps) and where
paths reach N_cap (cap_frac and its warning).  Values and stderr rtol
2e-4, cap_frac exact, the BGK projection rtol 2e-5; on the committor's
own indicator g the port's projection reads each exit's sphere, where
pspde's reads the wrong one for a few per cent of the inner exits.  Then pspde's own
oracle tests (tests/test_refine.py) on the port at their sizes, and the
port's parabolic h on a per-row time vector, as ``_mc_targets`` calls it.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pspde.problems as jp
from pspde.eval import feynman_kac_refine as j_refine
from pspde.eval import feynman_kac_refine_elliptic as j_refine_ell
from pspde.eval.refine import bgk_closures as j_bgk
import pspde_torch.problems as tp
from pspde_torch.eval import feynman_kac_refine, feynman_kac_refine_elliptic
from pspde_torch.eval.refine import bgk_closures
from tests.torch_correctors import one_thread  # noqa: F401
from tests.torch_correctors import (ELLIPTIC, JaxZH, TorchZH, LinearH,
                                    ball_net, close, jax_noise, paths_close,
                                    space_time_net, tt)

PARABOLIC = {
    "heat": lambda: (jp.HeatEquation(d=3, T=0.2),
                     tp.HeatEquation(d=3, T=0.2, device="cpu")),
    "allen_cahn": lambda: (jp.AllenCahn(d=3, T=0.2),
                           tp.AllenCahn(d=3, T=0.2, device="cpu")),
    "zh": lambda: (JaxZH(d=3), TorchZH(d=3)),
}


@pytest.mark.parametrize("t0", [0.0, 0.05])
@pytest.mark.parametrize("case,with_z", [("heat", False),
                                         ("allen_cahn", False),
                                         ("zh", False), ("zh", True)])
def test_feynman_kac_refine_matches_jax(case, with_z, t0):
    pj, pt = PARABOLIC[case]()
    vj, vt = space_time_net(3)
    x0 = np.array([0.3, -0.2, 0.1], np.float32)
    K, dt = 2048, 5e-3
    key = jax.random.PRNGKey(11)
    want = j_refine(pj, vj, jnp.asarray(x0), t0=t0, K=K, delta_t=dt,
                    key=key, with_z=with_z)
    got = feynman_kac_refine(pt, vt, torch.from_numpy(x0), t0=t0, K=K,
                             delta_t=dt, with_z=with_z,
                             noise_fn=jax_noise(key, K, 3))
    for g, w in zip(got[:3], want[:3]):
        close(g, w)
    assert got.cap_frac == 0.0
    assert float(got.stderr) > 0.0


def test_feynman_kac_refine_own_draws_run_and_differ_by_seed():
    _, pt = PARABOLIC["zh"]()
    _, vt = space_time_net(3)
    x0 = torch.tensor([0.3, -0.2, 0.1])
    a = feynman_kac_refine(pt, vt, x0, K=4096, delta_t=0.01, generator=1)
    b = feynman_kac_refine(pt, vt, x0, K=4096, delta_t=0.01,
                           generator=torch.Generator().manual_seed(1))
    c = feynman_kac_refine(pt, vt, x0, K=4096, delta_t=0.01, generator=2)
    assert torch.equal(a.value, b.value) and not torch.equal(a.value,
                                                             c.value)
    assert abs(float(a.value - c.value)) < 6 * float(a.stderr)


@pytest.mark.parametrize("case", list(ELLIPTIC))
def test_bgk_closures_match_jax(case):
    pj, pt = ELLIPTIC[case]()
    dt = 5e-3
    ins_j, proj_j = j_bgk(pj, dt)
    ins_t, proj_t = bgk_closures(pt, dt)
    sig_radial = float(np.max(np.diag(np.asarray(pj.sigma_struct.mat))))
    shift = 0.5826 * sig_radial * np.sqrt(dt)
    radii = [1.0, 2.0] if case == "committor" else [1.0]
    # radii on both sides of every shifted sphere, some within an ulp of it
    r = np.concatenate([np.concatenate([
        R + s * shift + np.linspace(-2e-3, 2e-3, 64),
        R + s * shift + np.linspace(-1e-6, 1e-6, 64)])
        for R in radii for s in (-1, 1)]).astype(np.float32)
    dirs = np.random.default_rng(4).standard_normal((len(r), 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    X = (dirs * r[:, None]).astype(np.float32)
    np.testing.assert_array_equal(ins_t(torch.from_numpy(X)).numpy(),
                                  np.asarray(ins_j(jnp.asarray(X))))
    paths_close(proj_t(torch.from_numpy(X)), proj_j(jnp.asarray(X)))


@pytest.mark.parametrize("d", [3, 10])
def test_projection_reads_its_exit_sphere(d):
    """The committor's own g on projected exits reads the sphere each exit
    point was projected onto: 0 on the inner, 1 on the outer (pspde reads
    1 on the inner sphere for a few per cent of them, ``bgk_closures``)."""
    p = tp.Committor(d=d, device="cpu")
    _, project = bgk_closures(p, 1e-3)
    rng = np.random.default_rng(d)
    X = rng.standard_normal((200_000, d))
    r = np.concatenate([rng.uniform(0.97, 1.05, 100_000),
                        rng.uniform(1.95, 2.03, 100_000)])
    X = (X / np.linalg.norm(X, axis=1, keepdims=True) * r[:, None])
    P = project(torch.from_numpy(X.astype(np.float32)))
    np.testing.assert_array_equal(p.g(P).numpy(), (r > 1.5).astype(
        np.float32))
    paths_close(torch.sqrt(torch.sum(P * P, dim=-1)), np.where(r > 1.5, 2.0,
                                                                1.0))


@pytest.mark.parametrize("case,N_cap,x0", [
    ("committor", 1024, [1.1, 0.4, -0.3]),
    ("ball_sin", 512, [0.2, -0.1, 0.3]),
    ("ball_sin", 24, [0.1, -0.1, 0.1]),
])
def test_feynman_kac_refine_elliptic_matches_jax(case, N_cap, x0):
    pj, pt = ELLIPTIC[case]()
    vj, vt = ball_net(3)
    x0 = np.array(x0, np.float32)
    K, dt = 2048, 5e-3
    key = jax.random.PRNGKey(5)
    with warnings.catch_warnings(record=True) as wj:
        warnings.simplefilter("always")
        want = j_refine_ell(pj, vj, jnp.asarray(x0), K=K, N_cap=N_cap,
                            delta_t=dt, key=key)
    steps = []
    noise = jax_noise(key, K, 3)

    def counting(n):
        steps.append(n)
        return noise(n)

    with warnings.catch_warnings(record=True) as wt:
        warnings.simplefilter("always")
        got = feynman_kac_refine_elliptic(pt, vt, torch.from_numpy(x0), K=K,
                                          N_cap=N_cap, delta_t=dt,
                                          noise_fn=counting)
    for g, w in zip(got[:3], want[:3]):
        close(g, w)
    assert got.cap_frac == float(want.cap_frac)
    assert len(wt) == len(wj) == (1 if want.cap_frac > 1e-3 else 0)
    if N_cap >= 512:
        # every path exits long before N_cap: the port's chain ended there
        # and gives JAX's full scan
        assert got.cap_frac == 0.0 and len(steps) < N_cap // 2, len(steps)
    else:
        assert got.cap_frac > 1e-3 and len(steps) == N_cap


# -- pspde's oracle tests (tests/test_refine.py) on the port ----------------

def test_refinement_contracts_model_error():
    p = LinearH(d=3, T=0.25)
    x0 = torch.tensor([0.3, -0.2, 0.1])
    true0 = float(p.v_true(x0[None], torch.zeros(1))[0])
    out = feynman_kac_refine(p, lambda X, t: 1.05 * p.v_true(X, t), x0,
                             K=200_000, delta_t=1e-3, generator=0)
    direct_err = abs(float(out.direct) - true0) / true0
    refined_err = abs(float(out.value) - true0) / true0
    assert abs(direct_err - 0.05) < 1e-3
    assert refined_err < 0.02, (refined_err, float(out.stderr))
    out2 = feynman_kac_refine(p, p.v_true, x0, K=200_000, delta_t=1e-3,
                              generator=0)
    assert abs(float(out2.value) - true0) / true0 < 5e-3


def test_elliptic_refinement_oracle():
    p = tp.ExponentialOnBallNonlinearSin(d=4, alpha=1.0, device="cpu")
    x0 = torch.tensor([0.2, -0.1, 0.3, 0.1])
    true0 = float(p.v_ref(x0[None])[0])
    out = feynman_kac_refine_elliptic(p, p.v_ref, x0, K=20_000, N_cap=2048,
                                      delta_t=1e-3, generator=0)
    assert abs(float(out.value) - true0) / true0 < 0.012, float(out.value)


def test_committor_hitting_probability_oracle():
    p = tp.Committor(d=6, device="cpu")
    x0 = torch.full((6,), 1.5 / np.sqrt(6.0))
    exact = float(p.v_ref(x0[None])[0])
    out = feynman_kac_refine_elliptic(p, lambda X: torch.zeros(X.shape[0]),
                                      x0, K=20_000, N_cap=4096,
                                      delta_t=1e-3, generator=0)
    assert abs(float(out.value) - exact) < 0.02, (float(out.value), exact)
    assert out.cap_frac == 0.0


def test_refine_guards():
    _, pt = ELLIPTIC["committor"]()
    with pytest.raises(ValueError, match="bounded"):
        feynman_kac_refine(tp.ExponentialOnSphereParabolic(d=2,
                                                           device="cpu"),
                           lambda X, t: X[:, 0], torch.zeros(2), K=8)
    sq = tp.FokkerPlanckEigen(d=2, device="cpu")
    with pytest.raises(ValueError, match="two_spheres"):
        bgk_closures(sq, 1e-3)
    with pytest.raises(ValueError, match="bounded"):
        bgk_closures(tp.HeatEquation(d=2, device="cpu"), 1e-3)


@pytest.mark.parametrize("cls,kw", [
    ("HeatEquation", dict(d=4, T=0.3)),
    ("AllenCahn", dict(d=4, T=0.3)),
    ("ExponentialOnSphereParabolic", dict(d=4)),
    ("ExponentialOnSphereNonlinearParabolic", dict(d=4)),
])
def test_parabolic_h_takes_a_per_row_time(cls, kw):
    """``_mc_targets`` calls h with a time vector (K,) and z = None."""
    pj, pt = getattr(jp, cls)(**kw), getattr(tp, cls)(**kw, device="cpu")
    rng = np.random.default_rng(2)
    x = (0.4 * rng.standard_normal((64, 4))).astype(np.float32)
    y = rng.standard_normal(64).astype(np.float32)
    t = rng.uniform(0.0, pj.T, 64).astype(np.float32)
    got = pt.h(tt(t), tt(x), tt(y), None)
    assert got.shape == (64,)
    paths_close(got, pj.h(jnp.asarray(t), jnp.asarray(x), jnp.asarray(y),
                          None))
