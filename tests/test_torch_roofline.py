"""The port's roofline (``pspde_torch/utils/roofline.py``) against pspde's
(CPU).

* ``_marginal_rate``: both estimators, fed one scripted clock, return the
  same rate.
* ``count_vpu_work`` on a hand-countable aten graph.
* ``fused_train_vpu_roofline`` with injected rates at d=100 and d=1000:
  normals per path-step equal to JAX's, matmul FLOPs equal to a hand
  count, elementwise work within 2x of JAX's weighted count, the ceiling
  formula, no unknown op.
* each ablation stage's plain version against the same stage written with
  JAX's building blocks (``make_transposed_apply``, ``b_T``,
  ``apply_cols``, ``h_T``: the math of ``pspde/utils/roofline.py:271-325``)
  on numpy noise and converted parameters.  The Pallas ladder itself needs
  the TPU's PRNG and has no interpret-mode test in ``pspde``.
* ``reference_normals_sum`` against the sum of ``train_normals``, and the
  kernel wrappers' CPU paths against their plain versions.

Tolerances: the ladder's output acc + sum_j X_j, atol 2e-4 (the JAX
suite's Y tolerance) and rtol 2e-5 (its X tolerance); counts exact.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.fx.experimental.proxy_tensor import make_fx

import pspde.problems as jp
import pspde.utils.roofline as jr
from pspde.ansatz.transposed import make_transposed_apply
from pspde.solvers import HJBSolver as JSolver
import pspde_torch.problems as tp
import pspde_torch.utils.roofline as rf
from pspde_torch.rollout import kernels as tk
from pspde_torch.solvers import HJBSolver as TSolver

LADDER_ATOL, LADDER_RTOL = 2e-4, 2e-5


def _solvers(d, T=1.0, dt=1.0 / 32):
    """A JAX solver and the port's twin with its parameters."""
    kw = dict(lr=1e-3, L=1, K=64, delta_t=dt, time_approx="inner",
              loss_method="log-variance", detach_forward=True,
              learn_Y_0=True, verbose=False, early_stopping_time=None,
              u_l2_error_flag=False)
    js = JSolver("j", jp.LLGC(d=d, T=T), **kw)
    ts = TSolver("t", tp.LLGC(d=d, T=T, device="cpu"), device="cpu", **kw)
    ts.load_jax_params(jax.device_get(js.params))
    return js, ts


def _clock(times, monkeypatch):
    it = iter(times)
    monkeypatch.setattr(time, "perf_counter", lambda: next(it))


def test_marginal_rate_matches_jax(monkeypatch):
    # per round: P passes start, stop, then 2P passes start, stop; the
    # second round's t2 < t1 is skipped by both
    times = [0.0, 0.5, 1.0, 1.8, 2.0, 2.3, 3.0, 3.2, 4.0, 4.4, 5.0, 5.7]
    P, work = 64, 3.0e6
    _clock(times, monkeypatch)
    j = jr._marginal_rate(lambda p: (lambda a: jnp.zeros(())), 0, P, work,
                          reps=1)
    _clock(times, monkeypatch)
    t = rf._marginal_rate(lambda p: (lambda a: torch.zeros(())), 0, P, work,
                          reps=1)
    assert j == t == pytest.approx(P * work / 0.3)


def test_count_vpu_work_hand_count():
    """The twin of tests/test_misc_coverage.py's count: elementwise ops
    count their output elements (tanh once, and once more as sfu), the
    reduction its input, the matmul 2 k per output element."""
    def f(x, w):
        y = x * 2.0 + 1.0          # 2 elementwise ops on (8, 16)
        z = torch.tanh(y)          # 1 more, transcendental
        s = torch.sum(z, dim=0)    # reduce of 128
        m = z @ w                  # 2 * 8 * 16 * 4 flops
        return s, m

    out = rf.count_vpu_work(make_fx(f)(torch.zeros(8, 16),
                                       torch.zeros(16, 4)))
    assert out["elem"] == 3 * 128, out
    assert out["sfu"] == 128, out
    assert out["reduce"] == 128, out
    assert out["mm_flops"] == 2 * 8 * 16 * 4, out
    assert not out["unknown"], out


@pytest.mark.parametrize("d", [100, 1000])
def test_fused_train_roofline_model(d):
    js, ts = _solvers(d)
    rates = dict(fma_rate=4e12, normals_rate=2e12)
    j = jr.fused_train_vpu_roofline(js.problem, js, **rates)
    t = rf.fused_train_vpu_roofline(ts.problem, ts, **rates)
    assert t["normals_per_path_step"] == j["normals_per_path_step"] == 2 * d
    # TanhMLP [d+1, 30, 30, d]: the forward's three products F, the
    # backward's replay F, its weight gradients F and its input gradients
    # through the two upper layers (the input X carries no gradient)
    F = 2 * ((d + 1) * 30 + 30 * 30 + 30 * d)
    assert t["mm_flops_per_path_step"] == 3 * F + 2 * (30 * d + 30 * 30)
    # JAX's count weights tanh as 8, the port counts every op once
    assert 0.5 <= t["elem_ops_per_path_step"] / j["elem_ops_per_path_step"] \
        <= 2.0, (t["elem_ops_per_path_step"], j["elem_ops_per_path_step"])
    t_ps = (2 * d / 2e12 + t["elem_ops_per_path_step"] / 2e12
            + t["mm_flops_per_path_step"] / 4e12)
    assert t["roofline_path_steps_per_sec"] == pytest.approx(1 / t_ps,
                                                             rel=1e-6)
    assert t["unknown_prims"] == {}
    assert t["sfu_per_path_step"] == 4 * 30   # tanh forward, twice


def test_fused_train_roofline_measures_at_timeable_passes(monkeypatch):
    """Without injected rates the model measures both on the card, each at
    its own pass count (``FMA_P``, ``NORMALS_P``; JAX's P=512 is too short
    to time on an H100) and the solver's noise map; ``micro_kw`` goes to
    both and overrides them."""
    seen = []
    monkeypatch.setattr(rf, "vpu_fma_rate",
                        lambda **kw: seen.append(("fma", kw)) or 4e12)
    monkeypatch.setattr(rf, "prng_normals_rate",
                        lambda **kw: seen.append(("normals", kw)) or 2e12)
    _, ts = _solvers(6)
    ts.fused_rng = "erfinv"
    out = rf.fused_train_vpu_roofline(ts.problem, ts)
    assert seen == [("fma", {"P": rf.FMA_P}),
                    ("normals", {"P": rf.NORMALS_P, "rng": "erfinv"})]
    assert out["vpu_fma_flops_per_sec"] == 4e12
    assert out["prng_normals_per_sec"] == 2e12
    seen.clear()
    rf.fused_train_vpu_roofline(ts.problem, ts, fma_rate=1e12,
                                micro_kw={"P": 64, "reps": 2})
    assert seen == [("normals", {"P": 64, "rng": "erfinv", "reps": 2})]


def _jax_stage(stage, problem, solver, noise, K, N):
    """The stage of pspde/utils/roofline.py:271-325 on injected noise,
    column layout, acc + sum_j X_j."""
    d = problem.d
    leaves, apply_T = make_transposed_apply(solver.z_net,
                                            solver.params["z"])
    dt = np.float32(solver.delta_t)
    sq_dt = np.float32(np.sqrt(solver.delta_t))
    sig = problem.sigma_struct
    X = jnp.zeros((d, K), jnp.float32) + 0.1
    acc = jnp.zeros((1, K), jnp.float32)
    for n in range(N):
        t = jnp.float32(n) * dt
        if stage == "full_nonoise":
            xi = jnp.full((d, K), 0.01, jnp.float32) * (
                1.0 + 1e-6 * jnp.float32(n))
        else:
            xi = jnp.asarray(noise[n].T)
        if stage == "noise":
            acc = acc + jnp.sum(xi, axis=0, keepdims=True)
            continue
        c, Z = jnp.zeros((d, K), jnp.float32), None
        if stage != "euler":
            tX = jnp.concatenate([jnp.zeros((1, K), jnp.float32) + t, X],
                                 axis=0)
            Z = apply_T(leaves, tX)
            c = -Z
        X = (X + (problem.b_T(X) + sig.apply_cols(c)) * dt
             + sig.apply_cols(xi) * sq_dt)
        if stage == "net":
            acc = acc + jnp.sum(Z * xi, axis=0, keepdims=True)
        elif stage != "euler":
            Zc = jnp.sum(Z * c, axis=0, keepdims=True)
            Zxi = jnp.sum(Z * xi, axis=0, keepdims=True)
            hv = problem.h_T(t, X, jnp.zeros((K,), jnp.float32),
                             Z).reshape(1, K)
            acc = acc + (-hv + Zc) * dt + Zxi * sq_dt
    return np.asarray(acc + jnp.sum(X, axis=0, keepdims=True))[0]


@pytest.mark.parametrize("d", [6, 100])
def test_ladder_stages_match_jax(d):
    K, N = 64, 4
    js, ts = _solvers(d)
    noise = np.random.default_rng(d).standard_normal((N, K, d)).astype(
        np.float32)
    for stage in rf.ABLATION_STAGES:
        want = _jax_stage(stage, js.problem, js, noise, K, N)
        got = rf.reference_ablation(stage, ts.problem, ts.z_net, K, N,
                                    ts.delta_t,
                                    host_noise=torch.from_numpy(noise))
        np.testing.assert_allclose(got.numpy(), want, rtol=LADDER_RTOL,
                                   atol=LADDER_ATOL, err_msg=stage)


def test_ablation_wrapper_on_cpu_is_the_plain_version():
    _, ts = _solvers(6)
    for stage in rf.ABLATION_STAGES:
        a = rf.ablation(stage, ts.problem, ts.z_net, 40, 3, ts.delta_t,
                        seed=5)
        b = rf.reference_ablation(stage, ts.problem, ts.z_net, 40, 3,
                                  ts.delta_t, seed=5)
        assert torch.equal(a, b), stage
        assert torch.isfinite(a).all()
    # only a kernel launch counts
    assert rf.ablation.launches == 0
    assert rf.ablation.launches_by_plan == {"shared": 0, "device": 0}
    with pytest.raises(ValueError, match="stage="):
        rf.ablation("fast", ts.problem, ts.z_net, 4, 1, ts.delta_t)
    relu = torch.nn.Sequential(torch.nn.Linear(7, 6))
    with pytest.raises(ValueError, match="not a TanhMLP"):
        rf.ablation("full", ts.problem, relu, 4, 1, ts.delta_t)
    with pytest.raises(ValueError, match="CUDA card"):
        rf.fused_ablation_rates(ts.problem, ts, K=64)
    # the stages' noise: raw bits lie in [-0.5, 0.5), the rest are the
    # training streams
    xi = rf._stage_noise("full_rawbits", 3, 16, 0, 6, "cpu", None)
    assert float(xi.min()) >= -0.5 and float(xi.max()) < 0.5
    torch.testing.assert_close(
        rf._stage_noise("full_binom", 3, 16, 2, 6, "cpu", None),
        tk.train_normals(3, 16, 2, 6, "binom"), rtol=0, atol=0)


@pytest.mark.parametrize("rng", ["erfinv", "binom"])
def test_normals_sum_is_the_training_stream(rng):
    seed, d, tile, P = 11, 7, 33, 5
    want = np.zeros(tile)
    for p in range(P):
        want += tk.train_normals(seed, tile, p, d, rng).double().sum(
            dim=1).numpy()
    got = rf.reference_normals_sum(seed, d, tile, P, rng)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    assert torch.equal(rf.normals_sum(seed, d, tile, P, rng, "cpu"), got)
    with pytest.raises(ValueError, match="rng="):
        rf.normals_sum(seed, d, tile, P, "boxmuller", "cpu")


def test_fma_chain_plain_version():
    """x <- x^2 + c_j stays in the map's invariant interval
    |x| <= (1 + sqrt(8)) / 2 over many passes; P = 0 is the identity."""
    x = torch.linspace(-1.9, 1.9, 64)
    y = rf.fma_chain(x.clone(), 0, 16)
    assert torch.equal(y, x)
    z = rf.fma_chain(x.clone(), 20, 16)
    assert float(z.abs().max()) <= 1.92
    c = rf._chain_consts(4)
    want = x.clone()
    for cj in c:
        want = want * want + float(cj)
    assert torch.equal(rf.reference_fma_chain(x.clone(), 1, 4), want)
    # P passes of chain 1: the same links, one per pass
    want = x.clone()
    for _ in range(4):
        want = want * want + float(c[0])
    assert torch.equal(rf.fma_chain(x.clone(), 4, 1), want)
    for chain in (3, 8):
        with pytest.raises(ValueError, match="chain="):
            rf.fma_chain(x.clone(), 1, chain)
    with pytest.raises(ValueError, match="CUDA card"):
        rf.vpu_fma_rate(device="cpu")
    with pytest.raises(ValueError, match="CUDA card"):
        rf.prng_normals_rate(device="cpu")
