"""Feynman-Kac semigroup power iteration for generator eigenproblems
(counterpart of ``pspde/eval/eigen_power.py``).

For A = L + W, W(x) the potential of an h linear in y (h(x, y, .) =
y W(x)), the semigroup is (e^{T A} f)(x) = E[f(X_T) exp(int_0^T W(X_s)
ds)] along dX = b dt + sigma dW, and the eigenpair with a positive
eigenfunction dominates, so V <- normalize(e^{T A} V) contracts every
other eigencomponent by e^{-(lambda_1 - lambda_0) T} a stage.
``eigen_power_refine`` runs that on a copy of a trained eigenfunction net
('scf' mode: h nonlinear in y, linearized at the current net);
``eigen_subspace_refine`` runs the block version with a Rayleigh-Ritz
step on several nets, whose Ritz values read the leading eigenvalues and
the spectral gap (held against ``problems/fd_oracles.py:
generator_spectrum_periodic_1d``).

The coefficients are 2 pi-periodic: paths are wrapped into the box
[X_l, X_r]^d each step (``wrap``, Python's modulo, as ``jnp.mod``).
Randomness comes from ``generator`` (a ``torch.Generator`` or an int seed,
0 when None) in JAX's order of draws; ``noise_fn`` and ``draws(stage)``
replace them (the hook through which a test hands in JAX's draws).
"""

from __future__ import annotations

import copy
from typing import Callable, Optional

import numpy as np
import torch

from .refine import Seed, _normals, reg_fit, rng


def wrap(X: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """lo + ((X - lo) mod (hi - lo)), the remainder with the divisor's sign
    (``jnp.mod``'s), in float32."""
    return lo + torch.remainder(X - lo, hi - lo)


def fk_semigroup_targets(problem, v_fn, Xs, K_inner, T_horizon, delta_t,
                         generator: Seed = None, W_of=None,
                         noise_fn: Optional[Callable] = None):
    """Per-anchor MC estimate of (e^{T A} V)(x_i) over N =
    round(T_horizon / delta_t) steps.  W(x) = problem.h(x, 1, None) unless
    ``W_of`` gives it (e.g. 'scf''s h(x, V, .) / V).  The geometry must be
    a periodic 'square' box."""
    M, d = Xs.shape
    geom = problem.geometry
    lo, hi = geom.X_l, geom.X_r
    dev = Xs.device
    gen = None if noise_fn is not None else rng(generator, dev)
    dt = np.float32(delta_t)
    sq_dt = float(np.sqrt(dt))
    sig = problem.sigma_struct
    N = int(np.round(T_horizon / delta_t))

    if W_of is None:
        def W_of(X):
            return problem.h(X, torch.ones(X.shape[0], dtype=X.dtype,
                                           device=X.device), None)

    with torch.no_grad():
        X = torch.repeat_interleave(Xs, K_inner, dim=0)
        R = X.shape[0]
        logw = torch.zeros(R, device=dev)
        for n in range(N):
            logw = logw + W_of(X) * float(dt)
            xi = _normals(noise_fn, gen, n, (R, d), dev)
            X = X + problem.b(X) * float(dt) + sig.apply(xi) * sq_dt
            X = wrap(X, lo, hi)
        vals = v_fn(X) * torch.exp(logw)
        return torch.mean(vals.reshape(M, K_inner), dim=1)


def _box(gen, M, d, lo, hi, dev):
    return lo + (hi - lo) * torch.rand((M, d), generator=gen, device=dev)


def eigen_power_refine(problem, net: torch.nn.Module, n_stages: int = 3,
                       T_horizon: float = 1.0, M: int = 4096,
                       K_inner: int = 128, delta_t: float = 2e-3,
                       reg_steps: int = 4000, reg_lr: float = 1e-3,
                       K_center: int = 65536, generator: Seed = None,
                       verbose: bool = False, mode: str = "linear",
                       normalization: str = "center",
                       draws: Optional[Callable] = None):
    """``n_stages`` Feynman-Kac power-iteration stages on a copy of a
    trained eigenfunction net (input x).  Each stage: M anchors uniform in
    the box, semigroup targets with the current net, normalized by
    pinning the center value to ``problem.v_ref(X_0)`` ('center', its
    semigroup image from K_center paths) or to a box-uniform E[V^2] = 1
    ('l2'), then a refit.  ``mode='scf'`` freezes W_eff(x) = h(x, V(x), .)
    / V(x) at the current net (V clipped at 1e-3 from below).  Returns
    (refined net, history), a dict per stage with lambda_growth
    (-log(t_norm / v_norm) / T_horizon) and reg_loss; read lambda off the
    refined net with ``EigenSolver.estimate_lambda``.

    ``draws(stage)`` replaces the stage's draws by a dict with 'Xs'
    (M, d), 'noise' (n -> (M K_inner, d)) and, for 'center',
    'center_noise' (n -> (K_center, d))."""
    if mode not in ("linear", "scf"):
        raise ValueError(f"mode must be 'linear' or 'scf': {mode!r}")
    if normalization not in ("center", "l2"):
        raise ValueError(f"normalization must be 'center' or 'l2': "
                         f"{normalization!r}")
    dev = problem.X_0.device
    gen = rng(generator, dev)
    d = problem.d
    lo, hi = problem.geometry.X_l, problem.geometry.X_r
    center = problem.X_0[None, :].to(torch.float32)
    with torch.no_grad():
        v_center_true = (float(problem.v_ref(center)[0])
                         if normalization == "center" else None)
    p = copy.deepcopy(net)

    def v_fn(X):
        return p(X)[:, 0]

    def W_of(X):
        v = torch.clamp_min(v_fn(X), 1e-3)
        return problem.h(X, v, None) / v

    W = W_of if mode == "scf" else None
    history = []
    for stage in range(n_stages):
        if draws is not None:
            dr = draws(stage)
            Xs, noise = dr["Xs"], dr["noise"]
            c_noise = dr.get("center_noise")
        else:
            Xs = _box(gen, M, d, lo, hi, dev)
            noise = c_noise = None
        targets = fk_semigroup_targets(problem, v_fn, Xs, K_inner,
                                       T_horizon, delta_t, gen, W, noise)
        with torch.no_grad():
            if normalization == "center":
                t_norm = fk_semigroup_targets(
                    problem, v_fn, center, K_center, T_horizon, delta_t,
                    gen, W, c_noise)[0]
                v_norm_now = v_fn(center)[0]
                scale = v_center_true / t_norm
            else:
                t_norm = torch.sqrt(torch.mean(targets ** 2))
                v_norm_now = torch.sqrt(torch.mean(v_fn(Xs) ** 2))
                scale = 1.0 / t_norm
            lam_growth = float(-torch.log(t_norm / v_norm_now) / T_horizon)
        p, reg_loss = reg_fit(p, Xs, targets * scale, reg_steps, reg_lr)
        rec = {"lambda_growth": lam_growth, "reg_loss": float(reg_loss)}
        history.append(rec)
        if verbose:
            print(f"  power stage {stage}: lambda_growth "
                  f"{lam_growth:+.2e}, reg_loss {rec['reg_loss']:.3e}")
    return p, history


def _gram(A: torch.Tensor, B: torch.Tensor) -> np.ndarray:
    """A^T B for (M, n) float32 columns, summed in float32 on their device
    (elementwise products: no TF32 whatever the matmul setting), returned
    as float64 on the host."""
    return torch.sum(A[:, :, None] * B[:, None, :], dim=0).cpu().numpy(
        ).astype(np.float64)


def eigen_subspace_refine(problem, nets, n_stages: int = 3,
                          T_horizon: float = 0.5, M: int = 4096,
                          K_inner: int = 64, delta_t: float = 2e-3,
                          reg_steps: int = 2000, reg_lr: float = 1e-3,
                          generator: Seed = None, verbose: bool = False,
                          draws: Optional[Callable] = None):
    """Block Feynman-Kac power iteration on copies of ``nets`` (one net per
    eigenfunction, input x): the leading len(nets) eigenpairs of
    A = L + W.  Each stage applies e^{T A} to every net by Monte Carlo at
    M uniform anchors, forms S = Vm^T Vm / M and H = Vm^T Tm / M (float32
    products on the device, then float64), solves the Ritz problem
    S^{-1} H c = theta c in float64 NumPy (theta_k ~ e^{-lambda_k T}),
    rotates the images onto the Ritz directions, normalizes them to unit
    anchor-RMS with signs aligned to the current nets, and refits each
    net.  h must be linear in y and the geometry a periodic 'square'.
    Returns (refined nets, history), a dict per stage with 'lambdas' (the
    Ritz readouts, ascending) and the per-net 'reg_loss'.

    ``draws(stage)`` replaces the stage's draws by a dict with 'Xs'
    (M, d) and 'noise', a list of one n -> (M K_inner, d) per net."""
    dev = problem.X_0.device
    gen = rng(generator, dev)
    d = problem.d
    lo, hi = problem.geometry.X_l, problem.geometry.X_r
    ps = [copy.deepcopy(q) for q in nets]

    def v_of(q):
        return lambda X: q(X)[:, 0]

    history = []
    for stage in range(n_stages):
        if draws is not None:
            dr = draws(stage)
            Xs, noises = dr["Xs"], dr["noise"]
        else:
            Xs = _box(gen, M, d, lo, hi, dev)
            noises = [None] * len(ps)
        with torch.no_grad():
            Vm = torch.stack([v_of(q)(Xs) for q in ps], dim=1)     # (M, n)
        Tm = torch.stack([fk_semigroup_targets(
            problem, v_of(q), Xs, K_inner, T_horizon, delta_t, gen,
            noise_fn=nz) for q, nz in zip(ps, noises)], dim=1)      # (M, n)
        S = _gram(Vm, Vm) / M
        H = _gram(Vm, Tm) / M
        theta, C = np.linalg.eig(np.linalg.solve(S, H))
        order = np.argsort(-theta.real)
        theta = theta.real[order]
        C = C[:, order].real
        lams = (-np.log(np.maximum(theta, 1e-12)) / T_horizon).tolist()
        with torch.no_grad():
            Cd = torch.as_tensor(C.astype(np.float32), device=dev)
            U = torch.sum(Tm[:, :, None] * Cd[None, :, :], dim=1)
            U = U / torch.sqrt(torch.mean(U ** 2, dim=0, keepdim=True))
            sgn = torch.sign(torch.sum(U * Vm, dim=0))
            U = U * torch.where(sgn == 0, 1.0, sgn)
        reg_losses, new_ps = [], []
        for j, q in enumerate(ps):
            qj, rl = reg_fit(q, Xs, U[:, j], reg_steps, reg_lr)
            new_ps.append(qj)
            reg_losses.append(float(rl))
        ps = new_ps
        history.append({"lambdas": lams, "reg_loss": reg_losses})
        if verbose:
            print(f"  subspace stage {stage}: lambdas "
                  + ", ".join(f"{v:+.4f}" for v in lams)
                  + f", reg_loss {max(reg_losses):.3e}")
    return ps, history
