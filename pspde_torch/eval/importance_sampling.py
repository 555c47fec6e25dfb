"""Importance sampling with a learned control - the serve path
(counterpart of ``pspde/eval/importance_sampling.py``).

Simulate the controlled process X_u on a delta_t = 0.01 grid, accumulate
the Ito and Riemann integrals of the control, weight each path by the
Girsanov factor exp(-int u dW - 1/2 int |u|^2 dt), and report the mean,
variance and relative error of E[exp(-int f - g(X_T))].  The statistics
are computed from the log-weights shifted by their maximum, so the
exponentials cannot overflow.

``importance_sampling`` is the plain tensor version (any control, or
the problem's reference control with ``control='true'``, e.g. the FD
table of the double-well problems; scrambled-Sobol noise with ``qmc``);
``make_is_runner`` is the training loop's per-iteration IS hook over the
same simulation; ``importance_sampling_fused`` runs the whole simulation
in the rollout kernel (``rollout/kernels.py``) on a CUDA problem, and its
plain version on a CPU one; ``do_importance_sampling`` and
``do_importance_sampling_Wei`` are the reference's names for the
naive-and-IS comparison.  Multi-device meshes are not ported yet.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch


def _not_ported(what: str):
    return NotImplementedError(
        f"{what} is not ported to pspde_torch yet (ROADMAP.md, Queue 1)")


def make_is_runner(problem, model, K: int, delta_t: float = 0.01):
    """The training loop's per-iteration IS hook (pspde's ``make_is_runner``
    over its ``_is_scan``): returns ``run(generator) -> (mean, var, rel)``,
    0-d tensors, of K controlled paths on the delta_t grid with the
    model's control as it is at each call (its live modules), the noise
    drawn from ``generator``.  Built once and cached by the solver."""
    N = int(np.ceil(problem.T / delta_t))

    def run(generator: Optional[torch.Generator] = None):
        u_fn = _control_closure(model, delta_t, N)
        _, X_u, ito, riem, _, f_int_u = _is_scan(
            problem, u_fn, K, N, delta_t, generator, False, None)
        return _stats_from_logw(-f_int_u - problem.g(X_u) - ito - 0.5 * riem)

    return run


def _qmc_seed(generator: Optional[torch.Generator]) -> int:
    """The scramble seed of a QMC run, drawn from ``generator`` (a CPU
    generator seeded 0 where none is given, as pspde's default key), so
    that independent generators give independent replicates."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return int(torch.randint(0, 2 ** 31 - 1, (1,), generator=generator,
                             device=generator.device))


def _qmc_noise(K: int, N: int, d: int, seed: int, bridge: bool = True):
    """(N, K, d) float32 standard normals from a scrambled Sobol sequence
    (pspde's ``_qmc_noise``, host NumPy and SciPy): each path one
    Owen-scrambled Sobol point of dimension N d, mapped to normals by the
    erfinv quantile; with ``bridge`` the path is assembled by
    Brownian-bridge bisection (Sobol dimension 0 sets W_N, the next ones
    the midpoints coarse to fine) and the increments returned.  A NumPy
    array; the caller moves it to its device."""
    import warnings
    from collections import deque

    from scipy.special import erfinv
    from scipy.stats import qmc

    eng = qmc.Sobol(d=N * d, scramble=True, seed=int(seed))
    with warnings.catch_warnings():
        # scipy warns when K is not a power of two; Owen scrambling keeps
        # the estimator unbiased at any K
        warnings.simplefilter("ignore", UserWarning)
        u = eng.random(K).astype(np.float64)
    eps = 1e-12
    u = np.clip(u, eps, 1.0 - eps)
    z = (erfinv(2.0 * u - 1.0) * np.sqrt(2.0)).reshape(K, N, d)
    if not bridge:
        return z.transpose(1, 0, 2).astype(np.float32)
    W = np.zeros((K, N + 1, d))
    W[:, N] = np.sqrt(N) * z[:, 0]
    q = deque([(0, N)])
    k = 1
    while q:  # breadth first: coarse levels take the lowest dimensions
        a, b = q.popleft()
        if b - a < 2:
            continue
        m = (a + b) // 2
        s = np.sqrt((m - a) * (b - m) / (b - a))
        W[:, m] = ((b - m) * W[:, a] + (m - a) * W[:, b]) / (b - a) \
            + s * z[:, k]
        k += 1
        q.append((a, m))
        q.append((m, b))
    assert k == N, (k, N)
    return np.diff(W, axis=1).transpose(1, 0, 2).astype(np.float32)


def _control_closure(model, delta_t: float, N: int):
    """The model's control u = -Z on the IS grid: IS step n maps to the
    model's time index ceil(t / model.delta_t)."""
    control_fn = model._control_fn()
    idx = np.ceil(np.arange(N) * delta_t / model.delta_t - 1e-9).astype(int)

    def u(X, n):
        t = float(np.float32(n) * np.float32(delta_t))
        Z, _ = control_fn(X, int(idx[n]), t)
        return -Z

    return u


@torch.no_grad()
def _is_scan(problem, u_fn, K: int, N: int, delta_t: float,
             generator: Optional[torch.Generator], simulate_naive: bool,
             u_true_fn=None, antithetic: bool = False, host_noise=None):
    """Step the naive and the controlled chain together on shared noise:
    ``host_noise`` (N, K, d) when given, else normals from ``generator``
    (mirrored pairs (xi, -xi) across the two halves with ``antithetic``)."""
    d = problem.d
    dev = problem.X_0.device
    dt = float(np.float32(delta_t))
    sq_dt = float(np.sqrt(np.float32(delta_t)))
    sig = problem.sigma_struct
    X0 = problem.X_0.to(torch.float32).expand(K, d)
    X = X_u = X0
    zeros = torch.zeros(K, dtype=torch.float32, device=dev)
    ito = riem = f_int = f_int_u = zeros
    for n in range(N):
        t = float(np.float32(n) * np.float32(dt))
        if host_noise is not None:
            xi = host_noise[n]
        elif antithetic:
            xi_h = torch.randn((K // 2, d), generator=generator, device=dev)
            xi = torch.cat([xi_h, -xi_h], dim=0)
        else:
            xi = torch.randn((K, d), generator=generator, device=dev)
        if simulate_naive:
            X = X + problem.b(X) * dt + sig.apply(xi) * sq_dt
            f_int = f_int + problem.running_cost(X, t) * dt
        ut = u_true_fn(X_u, n) if u_true_fn is not None else u_fn(X_u, n)
        X_u = (X_u + (problem.b(X_u) + sig.apply(ut)) * dt
               + sig.apply(xi) * sq_dt)
        ito = ito + torch.sum(ut * xi, dim=-1) * sq_dt
        riem = riem + torch.sum(ut * ut, dim=-1) * dt
        f_int_u = f_int_u + problem.running_cost(X_u, t) * dt
    return X, X_u, ito, riem, f_int, f_int_u


def _stats_from_logw(logw: torch.Tensor, antithetic: bool = False):
    """Stable mean / variance / relative error of exp(logw).  With
    ``antithetic`` the iid unit is the pair (i, i + K/2): the statistics
    are those of the K/2 pair means, logaddexp(logw_i, logw_j) - log 2."""
    if antithetic:
        half = logw.shape[0] // 2
        logw = torch.logaddexp(logw[:half], logw[half:]) - math.log(2.0)
    m = torch.max(logw)
    w = torch.exp(logw - m)
    mean_s = torch.mean(w)
    n = logw.shape[0]
    var_s = torch.var(w, correction=0) * n / max(n - 1, 1)
    mean = mean_s * torch.exp(m)
    var = var_s * torch.exp(2.0 * m)
    rel = torch.sqrt(var_s) / mean_s
    return mean, var, rel


def importance_sampling(problem, model, K: int, control: str = "approx",
                        simulate_naive: bool = False, delta_t: float = 0.01,
                        generator: Optional[torch.Generator] = None,
                        verbose: bool = False,
                        cross_statistics: Optional[float] = None,
                        mesh=None, antithetic: bool = False,
                        qmc: bool = False, host_noise=None):
    """IS diagnostics with the model's control (``control='approx'``) or
    the problem's closed-form one (``'true'``).  Returns (mean, var, RE),
    or the 6-tuple with the naive statistics first when
    ``simulate_naive``.  ``host_noise`` (N, K, d) replaces the generator's
    normals; ``qmc`` replaces them with scrambled-Sobol normals
    (``_qmc_noise``, Brownian bridge; ``qmc='natural'``: the increments in
    their natural order), scrambled with a seed drawn from ``generator``.
    The reported variance and RE are the integrand's spread under one
    scramble, not the QMC error."""
    if mesh is not None:
        raise _not_ported("importance_sampling(mesh=...)")
    if antithetic and K % 2:
        raise ValueError("antithetic importance sampling needs even K")
    if qmc and antithetic:
        raise ValueError("qmc and antithetic are mutually exclusive")
    N = int(np.ceil(problem.T / delta_t))
    if qmc:
        host_noise = torch.as_tensor(
            _qmc_noise(K, N, problem.d, _qmc_seed(generator),
                       bridge=(qmc != "natural")),
            device=problem.X_0.device)
    u_fn = u_true_fn = None
    if control == "true":
        u_true_fn = problem.u_ref_fn(np.arange(N) * delta_t)
    else:
        u_fn = _control_closure(model, delta_t, N)

    X, X_u, ito, riem, f_int, f_int_u = _is_scan(
        problem, u_fn, K, N, delta_t, generator, simulate_naive, u_true_fn,
        antithetic=antithetic, host_noise=host_noise)
    logw_is = -f_int_u - problem.g(X_u) - ito - 0.5 * riem
    mean_IS, var_IS, rel_IS = (float(v) for v in
                               _stats_from_logw(logw_is, antithetic))
    if simulate_naive:
        mn, vn, rn = (float(v) for v in
                      _stats_from_logw(-f_int - problem.g(X), antithetic))

    if verbose:
        s = ""
        if simulate_naive:
            s += ("naive mean: %.4e, naive variance: %.4e, naive RE %.4e"
                  % (mn, vn, rn))
            if cross_statistics is not None:
                s += ", crossed: %d/%d" % (int(torch.sum(
                    X > cross_statistics)), K)
            s += "\n"
        s += ("IS mean: %.4e, IS variance: %.4e, IS RE %.4e"
              % (mean_IS, var_IS, rel_IS))
        if cross_statistics is not None:
            s += ", crossed: %d/%d" % (int(torch.sum(
                X_u > cross_statistics)), K)
        print(s)

    if simulate_naive:
        return mn, vn, rn, mean_IS, var_IS, rel_IS
    return mean_IS, var_IS, rel_IS


def importance_sampling_fused(problem, model, K: int, delta_t: float = 0.01,
                              seed: int = 0, tile: Optional[int] = None,
                              verbose: bool = False, mesh=None,
                              host_noise=None, antithetic: bool = False):
    """IS with the whole N-step simulation in the rollout kernel
    (``rollout.kernels.fused_controlled_rollout``) - the kernel on a CUDA
    problem, its plain version on a CPU one.  Returns (mean, var, RE).

    The model must use the 'inner' TanhMLP control, and the problem a
    drift of the kernel's family (-x, A x, or the double well's).
    ``antithetic`` runs
    two rollouts of K/2 paths with the same seed and noise signs +1/-1
    (elementwise mirrored pairs) and reports the pair-averaged estimator
    at total path count K.  ``host_noise`` (N, K_run, d) replaces the
    Philox stream (test mode)."""
    if model.time_approx != "inner":
        raise ValueError("fused IS requires the 'inner' control")
    if mesh is not None:
        raise _not_ported("importance_sampling_fused(mesh=...)")
    from ..rollout.kernels import fused_controlled_rollout
    if antithetic and K % 2:
        raise ValueError("antithetic importance sampling needs even K")
    K_run = K // 2 if antithetic else K
    N = int(np.ceil(problem.T / delta_t))

    def run(sign):
        out = fused_controlled_rollout(problem, model.z_net, K_run, N,
                                       delta_t, seed=seed, tile=tile,
                                       host_noise=host_noise,
                                       noise_sign=sign)
        return -out.f_int - problem.g(out.X) - out.ito - 0.5 * out.riemann

    logw = run(1.0)
    if antithetic:
        logw = torch.logaddexp(logw, run(-1.0)) - math.log(2.0)
    mean_IS, var_IS, rel_IS = (float(v) for v in _stats_from_logw(logw))
    if verbose:
        print("IS mean: %.4e, IS variance: %.4e, IS RE %.4e"
              % (mean_IS, var_IS, rel_IS))
    return mean_IS, var_IS, rel_IS



def do_importance_sampling(problem, model, K, control="approx", verbose=True,
                           delta_t=0.01, generator=None):
    """The full 6-tuple (naive mean, var, RE, then IS mean, var, RE): the
    naive chain is always simulated beside the controlled one."""
    return importance_sampling(problem, model, K, control=control,
                               simulate_naive=True, delta_t=delta_t,
                               generator=generator, verbose=verbose)


def do_importance_sampling_Wei(problem, model, K, control="approx",
                               verbose=True, delta_t=0.01, generator=None):
    """(variance_naive, variance_IS) of the estimator."""
    out = importance_sampling(problem, model, K, control=control,
                              simulate_naive=True, delta_t=delta_t,
                              generator=generator)
    mean_naive, var_naive, _, mean_IS, var_IS, _ = out
    if verbose:
        print("\n(mean, variance) of naive estimator: (%.4e, %.4e)"
              % (mean_naive, var_naive))
        print("(mean, variance) of importance sampling estimator: "
              "(%.4e, %.4e)" % (mean_IS, var_IS))
    return var_naive, var_IS
