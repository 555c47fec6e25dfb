"""The port's serve path against pspde's (CPU): log-space statistics, the
plain IS simulation on shared host noise, and the slice as a whole - a
JAX-trained control, converted, served by ``importance_sampling_fused``
(the plain rollout on CPU) against JAX's Pallas kernel in interpret mode
on the same noise."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pspde.problems as jp
import pspde_torch.problems as tp
from pspde.solvers import HJBSolver as JHJBSolver
from pspde_torch.eval import (control_test_error, importance_sampling,
                              importance_sampling_fused)
from pspde_torch.eval.importance_sampling import (_stats_from_logw,
                                                  make_is_runner)
from pspde_torch.solvers import HJBSolver

jis = importlib.import_module("pspde.eval.importance_sampling")
jkern = importlib.import_module("pspde.rollout.kernels")


@pytest.mark.parametrize("antithetic", [False, True])
def test_stats_from_logw_matches_jax(antithetic):
    logw = (20.0 + 3.0 * np.random.default_rng(0).standard_normal(1000)
            ).astype(np.float32)
    want = jis._stats_from_logw(jnp.asarray(logw), antithetic=antithetic)
    got = _stats_from_logw(torch.from_numpy(logw), antithetic=antithetic)
    for w, g in zip(want, got):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-6)


def _models(jprob, tprob, delta_t, seed=0):
    """A JAX HJBSolver with O(1) control weights and the port's solver
    holding the same parameters."""
    js = JHJBSolver("is", jprob, L=1, K=32, delta_t=delta_t,
                    time_approx="inner", learn_Y_0=True, verbose=False,
                    early_stopping_time=None)
    rng = np.random.default_rng(seed)
    js.params = jax.tree.map(
        lambda a: (0.3 * rng.standard_normal(a.shape)).astype(np.float32),
        jax.device_get(js.params))
    ts = HJBSolver("is", tprob, K=32, delta_t=delta_t, time_approx="inner",
                   learn_Y_0=True, device="cpu")
    ts.load_jax_params(js.params)
    return js, ts


@pytest.mark.parametrize("case,control", [("llgc", "approx"),
                                          ("llgc", "true"),
                                          ("lqgc", "approx")])
def test_importance_sampling_matches_jax_on_host_noise(case, control,
                                                        monkeypatch):
    """JAX's importance_sampling is driven with the same (N, K, d) noise
    through its QMC noise hook; the port takes it as host_noise."""
    kw = dict(d=3, T=1.0, off_diag=0.1)
    if case == "llgc":
        pj, pt = jp.LLGC(**kw), tp.LLGC(**kw, device="cpu")
    else:
        pj, pt = jp.LQGC(**kw), tp.LQGC(**kw, device="cpu")
    K, delta_t = 256, 0.05
    N = int(np.ceil(pj.T / delta_t))
    noise = np.random.default_rng(5).standard_normal((N, K, pj.d)).astype(
        np.float32)
    js, ts = _models(pj, pt, delta_t=0.1)
    monkeypatch.setattr(jis, "_qmc_noise",
                        lambda K, N, d, seed, bridge=True: jnp.asarray(noise))
    want = jis.importance_sampling(pj, js, K, control=control,
                                   simulate_naive=True, delta_t=delta_t,
                                   qmc=True)
    got = importance_sampling(pt, ts, K, control=control,
                              simulate_naive=True, delta_t=delta_t,
                              host_noise=torch.from_numpy(noise))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_importance_sampling_generator_and_guards():
    pt = tp.LLGC(d=2, T=0.5, device="cpu")
    ts = HJBSolver("g", pt, K=32, delta_t=0.05, time_approx="inner",
                   device="cpu")
    a = importance_sampling(pt, ts, 512, delta_t=0.05,
                            generator=torch.Generator().manual_seed(1))
    b = importance_sampling(pt, ts, 512, delta_t=0.05,
                            generator=torch.Generator().manual_seed(1))
    assert a == b and all(np.isfinite(a))
    m, v, r = importance_sampling(pt, ts, 512, delta_t=0.05, antithetic=True,
                                  generator=torch.Generator().manual_seed(1))
    np.testing.assert_allclose(m, a[0], rtol=0.1)
    with pytest.raises(ValueError, match="even K"):
        importance_sampling(pt, ts, 511, antithetic=True)
    # QMC is ported: one scramble seed a generator state, finite
    q = importance_sampling(pt, ts, 512, delta_t=0.05, qmc=True,
                            generator=torch.Generator().manual_seed(1))
    assert q == importance_sampling(
        pt, ts, 512, delta_t=0.05, qmc=True,
        generator=torch.Generator().manual_seed(1)) and all(np.isfinite(q))
    with pytest.raises(NotImplementedError, match="mesh"):
        importance_sampling_fused(pt, ts, 512, mesh=object())
    # make_is_runner is ported: the generator's run of importance_sampling
    run = make_is_runner(pt, ts, 512, delta_t=0.05)
    assert tuple(float(v) for v in run(
        torch.Generator().manual_seed(1))) == a
    with pytest.raises(ValueError, match="approx_method"):
        HJBSolver("v", pt, approx_method="value", device="cpu")
    # 'outer' (the constructor's default) is ported; fused IS needs 'inner'
    outer = HJBSolver("o", pt, time_approx="outer", device="cpu")
    with pytest.raises(ValueError, match="'inner' control"):
        importance_sampling_fused(pt, outer, 512)


@pytest.fixture(scope="module")
def trained_d8():
    """JAX HJBSolver on LLGC d=8 after 50 training iterations, and the
    port's solver holding the converted parameters."""
    pj, pt = jp.LLGC(d=8, T=1.0), tp.LLGC(d=8, T=1.0, device="cpu")
    js = JHJBSolver("slice", pj, lr=1e-2, L=50, K=256, delta_t=0.05,
                    time_approx="inner", loss_method="log-variance",
                    detach_forward=True, learn_Y_0=True, verbose=False,
                    early_stopping_time=None)
    js.train()
    ts = HJBSolver("slice", pt, lr=1e-2, L=50, K=256, delta_t=0.05,
                   time_approx="inner", learn_Y_0=True, device="cpu")
    ts.load_jax_params(jax.device_get(js.params))
    return pj, pt, js, ts


@pytest.mark.parametrize("antithetic", [False, True])
def test_serve_slice_matches_jax_pallas(trained_d8, antithetic,
                                        monkeypatch):
    """The whole serve path: converted JAX-trained control, port's
    importance_sampling_fused against JAX's (Pallas interpret mode) on the
    same host noise; mean, var and RE at rtol 1e-4."""
    pj, pt, js, ts = trained_d8
    K = 1024
    K_run = K // 2 if antithetic else K
    N = 100
    noise = np.random.default_rng(11).standard_normal(
        (N, K_run, pj.d)).astype(np.float32)
    orig = jkern.fused_controlled_rollout

    def patched(problem, u_apply, leaves, K, N, dt, seed, **kw):
        kw.update(interpret=True, host_noise=jnp.asarray(noise))
        return orig(problem, u_apply, leaves, K, N, dt, seed, **kw)

    monkeypatch.setattr(jkern, "fused_controlled_rollout", patched)
    want = jis.importance_sampling_fused(pj, js, K, seed=0, tile=512,
                                         antithetic=antithetic)
    got = importance_sampling_fused(pt, ts, K, seed=0, antithetic=antithetic,
                                    host_noise=torch.from_numpy(noise))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    # the fused path also agrees with the plain simulation on that noise
    if not antithetic:
        plain = importance_sampling(pt, ts, K,
                                    host_noise=torch.from_numpy(noise))
        np.testing.assert_allclose(plain, got, rtol=1e-4)


def test_control_test_error_agrees_with_jax(trained_d8):
    """Same metric, independent noise streams (K=4096 each): the readings
    agree to a few percent."""
    from pspde.eval.test_error import control_test_error as jcte
    pj, pt, js, ts = trained_d8
    want = jcte(pj, js, K=4096, key=jax.random.PRNGKey(0))
    got = control_test_error(pt, ts, K=4096,
                             generator=torch.Generator().manual_seed(0))
    assert 0.0 < got < 1.0
    np.testing.assert_allclose(got, want, rtol=0.05)
