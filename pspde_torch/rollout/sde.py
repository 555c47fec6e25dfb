"""Euler-Maruyama rollouts as plain autograd loops (counterpart of
``pspde/rollout/sde.py``): ``hjb_rollout`` for the HJB/parabolic solver
and ``stopped_rollout`` for the stopped-path (first-exit) family.

This is the scan engine of ``HJBSolver`` and the plain version of the
training kernels (``kernels.py:reference_train_rollout`` calls it on the
kernels' noise stream), so the step math exists once.  One step, in the
JAX package's order (h, the accumulators and u_L2 see the post-step state
X' with time t_n):

    Z   = control(X_n, n, t_n)            # pre-step state
    c   = -Z if adaptive else 0           # detached if detach_forward
    X'  = X + (b(X) + sigma c) dt + sigma xi sqrt(dt)
    Y  += (-h(t_n, X', Y, Z) + <Z, c>) dt + <Z, xi> sqrt(dt)
    Z_sum, u_L2 accumulate at X'

Ported: control mode with adaptive or fixed forward process, value mode
(the consistency penalty (V(X_n, t_n) - Y_n)^2 for n > 0 in ``add_loss``),
``detach_forward``, the KL accumulator (with or without its Ito term),
the even/odd phases of 'log-variance-repa' (phase 0: Z frozen, the
gradient flows through the forward process; phase 1: the control c
frozen), the reparametrization accumulator, the Burgers drift c = Y - (2 +
d) / (2 d), the u_L2 diagnostic, antithetic pairs and recomputation
(``remat``): per step (``torch.utils.checkpoint``), or, for long horizons
or carry stacks past a byte budget, JAX's sqrt schedule (``_remat_scan``).

``stopped_rollout`` (``sde.py:536``) is the scan engine of
``EllipticSolver`` and the plain version of the stopped training kernels
(``kernels.py:reference_stopped_train_rollout``).  Its masking algebra is
the JAX package's step for step: the exit test gives ``new_sel``, Y
advances on ``adv = new_sel & active``, X freezes once a path has left,
``hitting`` counts the active steps.  Z = sigma^T grad V comes from
``value_and_z`` (autograd with ``create_graph``, so the loss is
differentiable through Z: the second-order path).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint


class HJBRolloutOut(NamedTuple):
    X: torch.Tensor         # (K, d) terminal state
    Y: torch.Tensor         # (K,) accumulated value process
    Z_sum: torch.Tensor     # (K,) KL / Ito accumulator
    u_l2: torch.Tensor      # (K,) control L2 error accumulator
    add_loss: torch.Tensor  # (K,) value-mode consistency penalty


@dataclasses.dataclass(frozen=True)
class HJBRolloutConfig:
    N: int
    delta_t: float
    adaptive_forward: bool = True
    detach_forward: bool = False
    accumulate_kl: bool = False       # 'relative_entropy*' losses
    kl_ito_term: bool = False         # 'relative_entropy_BSDE'
    reparametrization: bool = False   # 'reparametrization' loss
    repa_phase: Optional[int] = None  # 'log-variance-repa': l % 2
    burgers_drift: bool = False
    value_mode: bool = False
    track_u_l2: bool = True
    remat: bool = False
    antithetic: bool = False          # mirrored noise pairs (K even)


def step_constants(delta_t: float):
    """(dt, sqrt(dt)) as float32 values, the kernels' constants."""
    return float(np.float32(delta_t)), float(np.float32(np.sqrt(delta_t)))


def step_time(n: int, dt: float) -> float:
    """t_n = n dt in float32 arithmetic, as the kernels compute it."""
    return float(np.float32(n) * np.float32(dt))


def default_carry_budget(device) -> int:
    """The byte budget of ``_remat_scan``'s stored carries on ``device``:
    half of the card's memory (JAX's 8 GiB of a 16 GB v5e, the same
    share; 40 GiB of an 80 GB H100), half of the host's physical memory
    for a CPU tensor."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).total_memory // 2
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES") // 2


def _replica(generator: torch.Generator, state) -> torch.Generator:
    """A new generator on ``generator``'s device at ``state``."""
    g = torch.Generator(device=generator.device)
    g.set_state(state)
    return g


def replicas(generator: torch.Generator) -> Callable:
    """A callable giving, at each call, a new generator at the state that
    ``generator`` has now."""
    state = generator.get_state()
    return lambda: _replica(generator, state)


# Where a chunk of the sqrt schedule takes the generators its
# recomputations draw from: ``replicas``, or a callable generator ->
# callable installed by ``chunk_forks`` (``solvers/_chunk.py``: in a CUDA
# graph's capture, generators registered with the graph that each replay
# sets to the chunk's start).
_CHUNK_FORK: Optional[Callable] = None


@contextlib.contextmanager
def chunk_forks(fork: Optional[Callable]):
    """Let ``fork(generator)`` give each sqrt-schedule chunk started inside
    the block the source of its recomputations' generators: a callable
    whose every call gives a generator positioned at the chunk's start (a
    recomputation of a step that differentiates inside it, as the value
    mode and the stopped rollout do, can run more than once)."""
    global _CHUNK_FORK
    old, _CHUNK_FORK = _CHUNK_FORK, fork
    try:
        yield
    finally:
        _CHUNK_FORK = old


def _remat_scan(step: Callable, carry: tuple, N: int, remat: bool,
                draw: Callable, generator: Optional[torch.Generator] = None,
                threshold: int = 2048,
                carry_budget_bytes: Optional[int] = None) -> tuple:
    """``carry = step(n, *carry, draw(n, generator))`` for n < N (counterpart
    of ``pspde/rollout/sde.py:_remat_scan``), with recomputation under
    ``remat`` while grad mode is on.

    Backward through N steps stores every step's carry (N K d floats of X
    alone) whatever is recomputed within a step.  So where the horizon is
    long (N > ``threshold``) or the stored carries would pass
    ``carry_budget_bytes`` (default ``default_carry_budget``: half of the
    card's memory), the steps run in chunks of ~sqrt(N), each chunk
    recomputed as a whole on the backward pass: the ~sqrt(N) chunk carries
    are stored, and one chunk's steps at a time; compute ~2x the forward.
    Else each step is recomputed on its own, on the noise drawn outside it
    (stored: N K d floats).

    The chunked schedule stores no noise: a chunk draws its noise inside,
    from ``generator`` on the forward pass, and its recomputation draws it
    again from a generator at the state ``generator`` had at the chunk's
    start, kept beside the chunk's carry (``generator`` itself is not
    moved back): a replica made from its saved state, or, inside a CUDA
    graph's capture, where no state can be read or set, a generator that
    ``chunk_forks`` gives (``solvers/_chunk.py`` registers them with the
    graph and sets them before each replay).  Outputs and gradients are
    bitwise those of the per-step schedule: the same ops on the same
    numbers, the same autograd graph."""
    grad = torch.is_grad_enabled()
    if not (remat and grad):
        for n in range(N):
            carry = step(n, *carry, draw(n, generator))
        return carry
    if carry_budget_bytes is None:
        carry_budget_bytes = default_carry_budget(carry[0].device)
    carry_bytes = sum(x.numel() * x.element_size() for x in carry)
    if N <= threshold and N * carry_bytes <= carry_budget_bytes:
        for n in range(N):
            # the noise is drawn outside, so recomputation sees the same xi
            # (and draws nothing: no generator state to keep, which a CUDA
            # graph's capture could not restore)
            carry = checkpoint(step, n, *carry, draw(n, generator),
                               use_reentrant=False, preserve_rng_state=False)
        return carry
    fork = _CHUNK_FORK
    if (fork is None and generator is not None
            and generator.device.type == "cuda"
            and torch.cuda.is_current_stream_capturing()):
        raise RuntimeError(
            "the sqrt-schedule rollout draws each chunk's noise again on "
            "its recomputation: inside a CUDA graph's capture it needs the "
            "generators that solvers/_chunk.py registers (chunk_forks)")
    fork = fork or replicas
    inner = math.isqrt(N - 1) + 1

    def chunk(start: int, stop: int) -> Callable:
        # the generators of the chunk's recomputations, at its start
        again = None if generator is None else fork(generator)
        runs = []

        def run(*c):
            gen = again() if runs and again is not None else generator
            runs.append(1)
            for n in range(start, stop):
                c = step(n, *c, draw(n, gen))
            return c

        return run

    for start in range(0, N, inner):
        carry = checkpoint(chunk(start, min(start + inner, N)), *carry,
                           use_reentrant=False, preserve_rng_state=False)
    return tuple(carry)


def hjb_rollout(
    cfg: HJBRolloutConfig,
    problem,
    control_fn: Callable,      # (X, n, t) -> (Z, V_or_None)
    X0: torch.Tensor,          # (K, d)
    Y0: torch.Tensor,          # (K,)
    generator: Optional[torch.Generator] = None,
    u_ref: Optional[Callable] = None,          # (X, n) -> (K, d)
    host_noise: Optional[torch.Tensor] = None,  # (N, K_draw, d)
    noise_fn: Optional[Callable] = None,        # n -> (K_draw, d)
    remat_threshold: int = 2048,
    carry_budget_bytes: Optional[int] = None,
) -> HJBRolloutOut:
    """Forward ensemble rollout with the value accumulation, differentiable
    in the parameters ``control_fn`` closes over.

    The noise of step n is ``host_noise[n]``, else ``noise_fn(n)``, else
    ``torch.randn`` from ``generator`` on X0's device; it has K_draw = K
    rows, or K/2 with ``cfg.antithetic``, whose rows i and i + K/2 are
    then (xi, -xi).  Y, Z_sum, u_l2 and add_loss accumulate in float32;
    with ``cfg.value_mode`` the second output of ``control_fn`` is
    V(X_n, t_n), and add_loss sums (V - Y_n)^2 over the steps n > 0.
    ``remat_threshold`` and ``carry_budget_bytes`` decide where
    ``cfg.remat`` takes the sqrt schedule (``_remat_scan``)."""
    K, d = X0.shape
    K_draw = K // 2 if cfg.antithetic else K
    if cfg.antithetic and K % 2:
        raise ValueError("antithetic rollout needs even K")
    if host_noise is not None and tuple(host_noise.shape) != (cfg.N, K_draw,
                                                              d):
        raise ValueError(f"host_noise has shape {tuple(host_noise.shape)}, "
                         f"expected {(cfg.N, K_draw, d)}")
    dt, sq_dt = step_constants(cfg.delta_t)
    sig = problem.sigma_struct
    f32 = torch.float32
    track_u = cfg.track_u_l2 and u_ref is not None
    burgers_c = (2.0 + d) / (2.0 * d)

    def draw(n, gen):
        if host_noise is not None:
            xi = host_noise[n]
        elif noise_fn is not None:
            xi = noise_fn(n)
        else:
            xi = torch.randn((K_draw, d), generator=gen, dtype=f32,
                             device=X0.device)
        if cfg.antithetic:
            xi = torch.cat([xi, -xi], dim=0)
        return xi

    def step(n, X, Y, Z_sum, u_l2, add_loss, xi):
        t = step_time(n, dt)
        Z, V_here = control_fn(X, n, t)
        if cfg.value_mode and n > 0:
            add_loss = add_loss + (V_here.to(f32) - Y) ** 2
        # the even phase of 'log-variance-repa': Z frozen, the gradient
        # flows through the forward process only
        Z_used = Z.detach() if cfg.repa_phase == 0 else Z
        if not cfg.adaptive_forward:
            c = torch.zeros_like(X)
        elif cfg.burgers_drift:
            c = torch.ones_like(X) * (Y[:, None] - burgers_c)
        else:
            c = -Z
        if cfg.detach_forward or cfg.repa_phase == 1:
            c = c.detach()
        X_new = X + (problem.b(X) + sig.apply(c)) * dt + sig.apply(xi) * sq_dt
        if cfg.detach_forward:
            X_new = X_new.detach()
        Z32 = Z_used.to(f32)
        Zc = torch.sum(Z32 * c.to(f32), dim=-1)
        Zxi = torch.sum(Z32 * xi, dim=-1)
        Y = (Y + (-problem.h(t, X_new, Y, Z_used).to(f32) + Zc) * dt
             + Zxi * sq_dt)
        if cfg.reparametrization:
            # v from a frozen copy of the net
            v = (-Z).detach().to(f32)
            Z_sum = Z_sum + (-0.5 * torch.sum(v * v, dim=-1) * dt
                             + torch.sum(v * c.to(f32), dim=-1) * dt
                             + torch.sum(v * xi, dim=-1) * sq_dt)
        if cfg.accumulate_kl:
            Z_sum = Z_sum + (0.5 * torch.sum(Z32 * Z32, dim=-1)
                             + problem.running_cost(X_new, t).to(f32)) * dt
            if cfg.kl_ito_term:
                Z_sum = Z_sum - Zxi * sq_dt
        if track_u:
            err = -Z32.detach() - u_ref(X_new, n).to(f32)
            u_l2 = u_l2 + torch.sum(err * err, dim=-1) * dt
        return X_new, Y, Z_sum, u_l2, add_loss

    zeros = torch.zeros((K,), dtype=f32, device=X0.device)
    carry = (X0, Y0.to(f32), zeros, zeros, zeros)
    return HJBRolloutOut(*_remat_scan(
        step, carry, cfg.N, cfg.remat, draw, generator,
        threshold=remat_threshold, carry_budget_bytes=carry_budget_bytes))


# -- stopped-path (first-exit) rollout ---------------------------------------

class StoppedRolloutOut(NamedTuple):
    X: torch.Tensor          # (K, d) state at stopping (or final) time
    Y: torch.Tensor          # (K,) accumulated value increments
    t: torch.Tensor          # (K,) per-path elapsed time (general solver)
    stopped: torch.Tensor    # (K,) bool
    hitting: torch.Tensor    # (K,) number of active steps taken
    v_l2: torch.Tensor       # (K,) accumulated V-vs-reference L2 error
    step_loss: torch.Tensor  # () accumulated per-step losses (BSDE-2/3)
    active_count: torch.Tensor  # () total advancing path-steps (K_log)


@dataclasses.dataclass(frozen=True)
class StoppedRolloutConfig:
    N: int
    delta_t: float
    adaptive_forward: bool = False
    detach_forward: bool = True
    recursive_y_in_h: bool = False   # BSDE-2 / BSDE-4: h sees recursive Y
    step_loss: Optional[str] = None  # None | 'BSDE-2' | 'BSDE-3'
    time_stopping: bool = False      # general solver: stop when t + dt > T
    no_y_update: bool = False        # solve_linear_L2_projection flag
    remat: bool = False
    alpha0: float = 1.0


def value_and_z(net, sigma, space_time: bool = False,
                z_free: bool = False) -> Callable:
    """(X, t) -> (V, Z) with V = net(X)[:, 0] and Z = sigma^T grad_x V.
    ``space_time``: the net reads [X, t] (t last) and Z is the gradient in
    the first d inputs only.  ``z_free``: Z = 0 and no gradient is taken
    (``solve_linear_L2_projection``).  With grad mode on, Z keeps its graph
    (``create_graph``), so a loss of Z is differentiable in the net's
    parameters."""

    def inputs(X, t):
        return torch.cat([X, t[:, None]], dim=-1) if space_time else X

    def fn(X, t):
        if z_free:
            return net(inputs(X, t))[:, 0], torch.zeros_like(X)
        graph = torch.is_grad_enabled()
        with torch.enable_grad():
            Xg = X if X.requires_grad else X.detach().requires_grad_(True)
            V = net(inputs(Xg, t))[:, 0]
            (gX,) = torch.autograd.grad(V.sum(), Xg, create_graph=graph)
        return (V if graph else V.detach()), sigma.apply_T(gX)

    return fn


def _call_h(problem, t, x, y, z):
    """The reference's two h signatures: elliptic h(x, y, z)
    (problems.py:985), parabolic h(t, x, y, z) (problems.py:45)."""
    if getattr(problem, "T", None) is None:
        return problem.h(x, y, z)
    return problem.h(t, x, y, z)


class LambdaShiftedProblem:
    """Problem shim adding the eigenvalue term of the eigen solver:
    h_eff(x, y, z) = h(x, y, z) + lam y, so the rollout's -h_eff is the
    notebooks' (-h - lambda V) (``pspde/solvers/eigen.py:
    _LambdaShiftedProblem``).  ``lam`` is a one-element tensor; the shim
    is differentiable in it."""

    T = None   # the elliptic h signature

    def __init__(self, problem, lam: torch.Tensor):
        self._p = problem
        self._lam = lam.reshape(())
        self.sigma_struct = problem.sigma_struct

    def b(self, x):
        return self._p.b(x)

    def h(self, x, y, z):
        return self._p.h(x, y, z) + self._lam * y


def stopped_rollout(
    cfg: StoppedRolloutConfig,
    problem,
    value_grad_fn: Callable,   # (X, t) -> (V, Z), Z = sigma^T grad V
    X0: torch.Tensor,          # (K, d)
    Y0: torch.Tensor,          # (K,)
    t0: torch.Tensor,          # (K,) start times (zeros for elliptic)
    inside_fn: Callable,       # (X, X_prop) -> (K,) bool domain test
    generator: Optional[torch.Generator] = None,
    v_ref: Optional[Callable] = None,           # (X,) -> (K,)
    host_noise: Optional[torch.Tensor] = None,  # (N, K, d)
    noise_fn: Optional[Callable] = None,        # n -> (K, d)
    remat_threshold: int = 2048,
    carry_budget_bytes: Optional[int] = None,
) -> StoppedRolloutOut:
    """Fixed-length rollout with stopped-path masking (solver.py:723-785),
    differentiable in the parameters ``value_grad_fn`` closes over.  The
    noise of step n is ``host_noise[n]``, else ``noise_fn(n)``, else
    ``torch.randn`` from ``generator`` on X0's device.  ``cfg.remat``
    recomputes as ``_remat_scan`` decides."""
    K, d = X0.shape
    f32 = torch.float32
    dt, sq_dt = step_constants(cfg.delta_t)
    sig = problem.sigma_struct
    T = problem.T if cfg.time_stopping else None
    if host_noise is not None and tuple(host_noise.shape) != (cfg.N, K, d):
        raise ValueError(f"host_noise has shape {tuple(host_noise.shape)}, "
                         f"expected {(cfg.N, K, d)}")

    def draw(n, gen):
        if host_noise is not None:
            return host_noise[n]
        if noise_fn is not None:
            return noise_fn(n)
        return torch.randn((K, d), generator=gen, dtype=f32,
                           device=X0.device)

    def step(n, X, Y, t, stopped, hitting, v_l2, step_loss, active_count,
             xi):
        active = ~stopped
        V_here, Z = value_grad_fn(X, t)
        if v_ref is not None:
            err = (V_here.detach() - v_ref(X)) ** 2
            v_l2 = v_l2 + torch.where(active, err, 0.0) * dt
        c = -Z if cfg.adaptive_forward else torch.zeros_like(X)
        if cfg.detach_forward:
            c = c.detach()
        drift = (problem.b(X) + sig.apply(c)) * dt + sig.apply(xi) * sq_dt
        X_prop = X + drift * active[:, None].to(X.dtype)
        new_sel = inside_fn(X, X_prop)
        if cfg.time_stopping:
            new_sel = new_sel & ((t + dt) <= T)
        adv = new_sel & active
        advf = adv.to(X.dtype)
        hitting = hitting + active.to(X.dtype)
        if cfg.step_loss == "BSDE-2":
            # solver.py:762-763
            step_loss = step_loss + cfg.alpha0 * torch.mean(
                (V_here - Y) ** 2 * advf)
        if cfg.no_y_update:
            # solve_linear_L2_projection (solver.py:1099, 1136): Y stays at
            # its initial value V(X_0, t_0)
            Y_new = Y
            h_val = torch.zeros_like(Y)
        else:
            y_in_h = Y if cfg.recursive_y_in_h else V_here
            h_val = _call_h(problem, t, X, y_in_h, Z)
            dY = ((-h_val + torch.sum(Z * c, dim=-1)) * dt
                  + torch.sum(Z * xi, dim=-1) * sq_dt)
            Y_new = Y + dY * advf
        X_new = torch.where(adv[:, None], X_prop, X)
        t_new = t + dt * advf if cfg.time_stopping else t
        if cfg.step_loss == "BSDE-3":
            # one-step residual, solver.py:782-785
            V_next, _ = value_grad_fn(X_new, t_new)
            resid = (V_next - V_here
                     + (h_val - torch.sum(Z * c, dim=-1)) * dt
                     - torch.sum(Z * xi, dim=-1) * sq_dt)
            step_loss = step_loss + cfg.alpha0 * torch.mean(resid ** 2 * advf)
        active_count = active_count + torch.sum(advf)
        stopped_new = stopped | ~new_sel
        return (X_new, Y_new, t_new, stopped_new, hitting, v_l2, step_loss,
                active_count)

    zeros = torch.zeros((K,), dtype=f32, device=X0.device)
    scalar = torch.zeros((), dtype=f32, device=X0.device)
    carry = (X0, Y0.to(f32), t0.to(f32),
             torch.zeros((K,), dtype=torch.bool, device=X0.device), zeros,
             zeros, scalar, scalar)
    return StoppedRolloutOut(*_remat_scan(
        step, carry, cfg.N, cfg.remat, draw, generator,
        threshold=remat_threshold, carry_budget_bytes=carry_budget_bytes))
