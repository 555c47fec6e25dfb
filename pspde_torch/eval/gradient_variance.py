"""Per-step gradient-variance diagnostics (counterpart of
``pspde/eval/gradient_variance.py``, the "Relative errors of gradients"
notebook; the reference's ``Solver.get_gradient_variances``,
solver.py:234-281).

For the per-step ('outer') control of an ``HJBSolver``, the per-sample
gradients of the terminal value Y_k and of g(X_T^k) with respect to each
step's parameters give per-sample estimates of the moment or
log-variance loss gradient; the diagnostic is their componentwise
relative statistical error sqrt(Var) / Mean over the K samples, an (N, p)
matrix with NaNs and infinities set to 0.

The rollout couples no two paths, so the (K, N, p) per-sample gradients
are ``torch.func.vmap`` over the paths of ``jacrev`` of a one-path
rollout, on the noise of the whole ensemble drawn first: one batched
computation in place of the reference's K N backward passes.  Columns run
in the order of the net's parameters (``named_parameters``), each leaf
flattened row-major.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..rollout.sde import hjb_rollout


def gradient_variances(solver, generator: Optional[torch.Generator] = None,
                       loss_method: Optional[str] = None,
                       host_noise: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """The (N, p) relative gradient errors of an 'outer' control-mode
    ``HJBSolver``'s ``loss_method`` (its own by default; 'moment' or
    'log-variance').  The rollout's noise is ``host_noise`` (N, K_draw,
    d; K_draw = K/2 with antithetic pairs) or drawn from ``generator``."""
    if solver.time_approx != "outer" or solver.approx_method != "control":
        raise ValueError("per-step gradient variances need the 'outer' "
                         "control approximation")
    loss_method = loss_method or solver.loss_method
    if loss_method not in ("moment", "log-variance"):
        raise ValueError(f"loss_method={loss_method!r}: 'moment' or "
                         "'log-variance'")
    problem, net = solver.problem, solver.z_net
    K, d, N = solver.K, solver.d, solver.N
    cfg = dataclasses.replace(solver._rollout_cfg(0), remat=False,
                              antithetic=False, track_u_l2=False)
    if host_noise is None:
        K_draw = K // 2 if solver.antithetic else K
        host_noise = torch.randn((N, K_draw, d), generator=generator,
                                 dtype=torch.float32, device=solver.device)
    if solver.antithetic:
        host_noise = torch.cat([host_noise, -host_noise], dim=1)
    with torch.no_grad():
        X0, Y0 = solver._initial_state(
            problem.X_0.to(torch.float32).expand(K, d))
    params = {name: p.detach() for name, p in net.named_parameters()}

    def one_path(prm, x0, y0, xi):
        def control(X, n, t):
            return torch.func.functional_call(net, prm, (X, n)), None

        out = hjb_rollout(cfg, problem, control, x0[None], y0[None],
                          host_noise=xi[:, None])
        return out.Y[0], problem.g(out.X)[0]

    jac_Y, jac_g = torch.func.vmap(
        torch.func.jacrev(one_path), in_dims=(None, 0, 0, 1))(
        params, X0, Y0, host_noise)
    with torch.no_grad():
        out = hjb_rollout(cfg, problem, lambda X, n, t: (net(X, n), None),
                          X0, Y0, host_noise=host_noise)
        Y, gX = out.Y, problem.g(out.X)

    def flat(jac):
        return torch.cat([jac[name].reshape(K, N, -1) for name in params],
                         dim=-1)

    gY = flat(jac_Y)
    gG = flat(jac_g) if solver.adaptive_forward_process \
        else torch.zeros_like(gY)
    r = (Y - gX)[:, None, None]
    if loss_method == "moment":
        grads = 2.0 * r * (gY - gG)
    else:
        diff = gY - gG
        grads = 2.0 * ((r - torch.mean(r, dim=0, keepdim=True))
                       * (diff - torch.mean(diff, dim=0, keepdim=True)))
    mean = torch.mean(grads, dim=0)
    n = grads.shape[0]
    var = torch.var(grads, dim=0, correction=0) * n / max(n - 1, 1)
    rel = torch.sqrt(var) / mean
    return torch.nan_to_num(rel, nan=0.0, posinf=0.0, neginf=0.0)


__all__ = ["gradient_variances"]
