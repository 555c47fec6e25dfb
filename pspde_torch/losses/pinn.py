"""PINN residuals (counterpart of ``pspde/losses/pinn.py``; elliptic:
solver.py:828-931, parabolic: solver.py:1208-1323).

The second-order term is one batched Hessian, ``torch.func.vmap`` over
``torch.func.hessian`` of the value net at each point (forward over
reverse, as ``jax.hessian``), contracted per the diffusion structure:
B_00^2 Tr(H) without ``full_hessian`` (solver.py:896-899), Tr(B B^T H)
with it (solver.py:891-894).  Plain PyTorch on the problem's device: the
JAX package computes these outside any Pallas kernel.  The residual stays
differentiable in the net's parameters, which the transforms capture.
"""

from __future__ import annotations

import torch
from torch.func import grad, hessian, vmap


def _second_order(problem, H: torch.Tensor, full_hessian: bool):
    """1/2 of the generator's second-order term from the Hessians H
    (K, d, d): Tr(B B^T H) or B_00^2 Tr(H)."""
    B = problem.sigma_struct.mat
    if full_hessian:
        return torch.einsum("ij,kji->k", B @ B.T, H)
    return B[0, 0] ** 2 * torch.diagonal(H, dim1=-2, dim2=-1).sum(dim=-1)


def elliptic_pinn_residual(problem, v_fn, X: torch.Tensor,
                           full_hessian: bool) -> torch.Tensor:
    """Residual of the generator: 1/2 tr(sigma sigma^T H) + b . grad V
    + h(x, V, B grad V)  (solver.py:901-906), (K,) for X (K, d); ``v_fn``
    maps (K, d) -> (K,)."""
    def v_scalar(x):
        return v_fn(x[None, :])[0]

    g = vmap(grad(v_scalar))(X)
    H = vmap(hessian(v_scalar))(X)
    second = _second_order(problem, H, full_hessian)
    V = v_fn(X)
    Z = problem.sigma_struct.apply(g)
    return (0.5 * second + torch.sum(problem.b(X) * g, dim=-1)
            + problem.h(X, V, Z))


def parabolic_pinn_residual(problem, v_fn_xt, X: torch.Tensor,
                            t: torch.Tensor,
                            full_hessian: bool) -> torch.Tensor:
    """Parabolic residual: dV/dt + 1/2 tr(sigma sigma^T H_x) + b . grad_x V
    + h(t, x, V, B grad_x V)  (solver.py:1284-1285); ``v_fn_xt`` maps
    [X, t] (K, d + 1) -> (K,)."""
    d = X.shape[-1]

    def v_scalar(xt):
        return v_fn_xt(xt[None, :])[0]

    XT = torch.cat([X, t[:, None]], dim=-1)
    g = vmap(grad(v_scalar))(XT)
    grad_x, dVdt = g[:, :d], g[:, d]
    H = vmap(hessian(v_scalar))(XT)
    second = _second_order(problem, H[:, :d, :d], full_hessian)
    V = v_fn_xt(XT)
    Z = problem.sigma_struct.apply(grad_x)
    return (dVdt + 0.5 * second + torch.sum(problem.b(X) * grad_x, dim=-1)
            + problem.h(t, X, V, Z))
