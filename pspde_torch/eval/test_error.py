"""Test errors (counterpart of ``pspde/eval/test_error.py``): the value
error ``compute_test_error`` on fresh in-domain samples and the same-state
control error ``control_test_error``."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..rollout.sampling import sample_domain


@torch.no_grad()
def compute_test_error(v_fn, problem, K: int,
                       generator: Optional[torch.Generator] = None,
                       modus: str = "elliptic"):
    """(L2 error, mean absolute error, mean relative error) of the value
    approximation ``v_fn`` against ``problem.v_ref`` on K fresh uniform
    samples of the domain (utilities.py:440-472), as 0-d tensors on the
    problem's device.  ``modus='elliptic'``: ``v_fn`` maps X (K, d) ->
    (K,).  ``modus='parabolic'``: t ~ U(0, T) is drawn after X, ``v_fn``
    maps [X, t] (K, d + 1) -> (K,) and the reference is ``v_ref(X, t)``
    (utilities.py:456-464)."""
    if modus not in ("elliptic", "parabolic"):
        raise ValueError(f"modus={modus!r} must be 'elliptic' or "
                         "'parabolic'")
    dev = problem.X_0.device
    X = sample_domain(generator, problem.geometry, K, problem.d, device=dev)
    if modus == "parabolic":
        t = torch.rand((K,), generator=generator, device=dev) * problem.T
        v_true = problem.v_ref(X, t)
        v_est = v_fn(torch.cat([X, t[:, None]], dim=-1))
    else:
        v_true = problem.v_ref(X)
        v_est = v_fn(X)
    diff = v_true - v_est
    return (torch.mean(diff ** 2), torch.mean(torch.abs(diff)),
            torch.mean(torch.abs(diff) / v_true))


@torch.no_grad()
def control_test_error(problem, model, K: int = 4096,
                       generator: Optional[torch.Generator] = None) -> float:
    """Relative control L2 error sqrt(E int |u_hat - u*|^2 dt /
    E int |u*|^2 dt), both evaluated at the SAME state X_n along paths
    driven by the learned control, on the model's own time grid."""
    dev = problem.X_0.device
    control_fn = model._control_fn()
    N, dt = model.N, model.delta_t
    sq_dt = float(np.sqrt(dt))
    sig = problem.sigma_struct
    u_ref = problem.u_ref_fn(np.arange(N) * dt)
    X = problem.X_0.to(torch.float32).expand(K, problem.d)
    num = torch.zeros(K, dtype=torch.float32, device=dev)
    den = torch.zeros_like(num)
    for n in range(N):
        t = float(np.float32(n) * np.float32(dt))
        Z, _ = control_fn(X, n, t)
        u_hat = -Z
        u_star = u_ref(X, n)
        num = num + torch.sum((u_hat - u_star) ** 2, dim=-1) * dt
        den = den + torch.sum(u_star ** 2, dim=-1) * dt
        xi = torch.randn(X.shape, generator=generator, device=dev)
        X = X + (problem.b(X) + sig.apply(u_hat)) * dt + sig.apply(xi) * sq_dt
    return float(torch.sqrt(torch.mean(num) / torch.mean(den)))
