"""Path-space loss zoo of the HJB/parabolic solver (counterpart of
``pspde/losses/pathspace.py``).

Pure functions of the rollout outputs; every reduction is a mean over the
path axis.  Conventions as in the JAX package: ``log-variance`` is the
biased mean-of-squares minus squared-mean form, ``variance`` and the
variance part of ``log-variance-y_0`` are Bessel-corrected, and the
stop-gradient of the adaptive ``cross_entropy`` weight is ``.detach()``.
"""

from __future__ import annotations

import torch

HJB_LOSS_METHODS = (
    "moment", "log-variance", "log-variance-repa", "variance",
    "relative_entropy", "relative_entropy_BSDE", "cross_entropy",
    "relative_entropy_log-variance", "reparametrization", "log-variance-y_0",
)


def _unbiased_var(x: torch.Tensor) -> torch.Tensor:
    n = x.shape[0]
    return torch.var(x, correction=0) * n / max(n - 1, 1)


def log_variance_loss(Y, gX):
    """E[(Y - g)^2] - E[Y - g]^2."""
    r = Y - gX
    return torch.mean(r ** 2) - torch.mean(r) ** 2


def moment_loss(Y, gX):
    """E[(Y - g)^2]."""
    return torch.mean((Y - gX) ** 2)


def variance_loss(Y, gX):
    """Var[exp(-g + Y)], Bessel-corrected."""
    return _unbiased_var(torch.exp(-gX + Y))


def relative_entropy_loss(Z_sum, gX):
    """E[Z_sum + g]."""
    return torch.mean(Z_sum + gX)


def cross_entropy_loss(Y, gX, adaptive: bool):
    """E[Y exp(-g + sg(Y))] (adaptive) or E[Y exp(-g)]."""
    if adaptive:
        return torch.mean(Y * torch.exp(-gX + Y.detach()))
    return torch.mean(Y * torch.exp(-gX))


def hjb_loss(method: str, Y, gX, Z_sum, *, adaptive: bool = True,
             phase: int = 0):
    """Dispatch; ``phase`` is the iteration tag of the alternating and
    scheduled losses (the repa parity l % 2; for
    'relative_entropy_log-variance' 0 while l < 1000, then 1)."""
    if method == "moment":
        return moment_loss(Y, gX)
    if method == "log-variance":
        return log_variance_loss(Y, gX)
    if method == "log-variance-repa":
        return float(phase * 2 - 1) * log_variance_loss(Y, gX)
    if method == "variance":
        return variance_loss(Y, gX)
    if method in ("relative_entropy", "relative_entropy_BSDE",
                  "reparametrization"):
        return relative_entropy_loss(Z_sum, gX)
    if method == "cross_entropy":
        return cross_entropy_loss(Y, gX, adaptive)
    if method == "relative_entropy_log-variance":
        if phase == 0:
            return relative_entropy_loss(Z_sum, gX)
        return log_variance_loss(Y, gX)
    raise ValueError(f"unknown loss method: {method}")


def log_variance_y0_losses(Y, gX):
    """The 'log-variance-y_0' split: the (Bessel-corrected) variance part
    updates the control net, the squared-mean part updates y_0.  Returns
    (var_part, mean_sq_part)."""
    r = Y - gX
    return _unbiased_var(r), torch.mean(r) ** 2
