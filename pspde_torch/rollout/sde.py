"""Euler-Maruyama rollout of the HJB/parabolic solver as a plain autograd
loop (counterpart of ``pspde/rollout/sde.py:hjb_rollout``).

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

Ported: control mode with adaptive or fixed forward process,
``detach_forward``, the KL accumulator (with or without its Ito term),
the u_L2 diagnostic, antithetic pairs and per-step recomputation
(``remat``, ``torch.utils.checkpoint``).  Value mode, the repa phases,
the reparametrization accumulator and the Burgers drift raise.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint


class HJBRolloutOut(NamedTuple):
    X: torch.Tensor         # (K, d) terminal state
    Y: torch.Tensor         # (K,) accumulated value process
    Z_sum: torch.Tensor     # (K,) KL / Ito accumulator
    u_l2: torch.Tensor      # (K,) control L2 error accumulator
    add_loss: torch.Tensor  # (K,) value-mode consistency penalty (zeros)


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


def _not_ported(cfg: HJBRolloutConfig):
    for flag, name in ((cfg.value_mode, "value_mode"),
                       (cfg.repa_phase is not None, "repa_phase"),
                       (cfg.reparametrization, "reparametrization"),
                       (cfg.burgers_drift, "burgers_drift")):
        if flag:
            raise NotImplementedError(
                f"hjb_rollout: {name} is not ported to pspde_torch yet "
                "(ROADMAP.md, Queue 1 item 4)")


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
) -> HJBRolloutOut:
    """Forward ensemble rollout with the value accumulation, differentiable
    in the parameters ``control_fn`` closes over.

    The noise of step n is ``host_noise[n]``, else ``noise_fn(n)``, else
    ``torch.randn`` from ``generator`` on X0's device; it has K_draw = K
    rows, or K/2 with ``cfg.antithetic``, whose rows i and i + K/2 are
    then (xi, -xi).  Y, Z_sum and u_l2 accumulate in float32."""
    _not_ported(cfg)
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

    def draw(n):
        if host_noise is not None:
            xi = host_noise[n]
        elif noise_fn is not None:
            xi = noise_fn(n)
        else:
            xi = torch.randn((K_draw, d), generator=generator, dtype=f32,
                             device=X0.device)
        if cfg.antithetic:
            xi = torch.cat([xi, -xi], dim=0)
        return xi

    def step(n, t, X, Y, Z_sum, u_l2, xi):
        Z, _ = control_fn(X, n, t)
        c = -Z if cfg.adaptive_forward else torch.zeros_like(X)
        if cfg.detach_forward:
            c = c.detach()
        X_new = X + (problem.b(X) + sig.apply(c)) * dt + sig.apply(xi) * sq_dt
        if cfg.detach_forward:
            X_new = X_new.detach()
        Z32 = Z.to(f32)
        Zc = torch.sum(Z32 * c.to(f32), dim=-1)
        Zxi = torch.sum(Z32 * xi, dim=-1)
        Y = Y + (-problem.h(t, X_new, Y, Z).to(f32) + Zc) * dt + Zxi * sq_dt
        if cfg.accumulate_kl:
            Z_sum = Z_sum + (0.5 * torch.sum(Z32 * Z32, dim=-1)
                             + problem.running_cost(X_new, t).to(f32)) * dt
            if cfg.kl_ito_term:
                Z_sum = Z_sum - Zxi * sq_dt
        if track_u:
            err = -Z32.detach() - u_ref(X_new, n).to(f32)
            u_l2 = u_l2 + torch.sum(err * err, dim=-1) * dt
        return X_new, Y, Z_sum, u_l2

    zeros = torch.zeros((K,), dtype=f32, device=X0.device)
    X, Y, Z_sum, u_l2 = X0, Y0.to(f32), zeros, zeros
    for n in range(cfg.N):
        t = step_time(n, dt)
        xi = draw(n)
        if cfg.remat and torch.is_grad_enabled():
            # the noise is drawn outside, so recomputation sees the same xi
            X, Y, Z_sum, u_l2 = checkpoint(step, n, t, X, Y, Z_sum, u_l2,
                                           xi, use_reentrant=False)
        else:
            X, Y, Z_sum, u_l2 = step(n, t, X, Y, Z_sum, u_l2, xi)
    return HJBRolloutOut(X, Y, Z_sum, u_l2, torch.zeros_like(Y))
