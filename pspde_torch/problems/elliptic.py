"""Elliptic boundary-value problems, first-exit formulations (counterpart
of ``pspde/problems/elliptic.py``).

Ported: ``ExponentialOnSphere``, ``ExponentialOnBallNonlinear`` (Dirichlet
and Neumann ``g``) and ``ExponentialOnBallNonlinearSin``, each with ``g``,
``h(x, y, z)``, ``v_ref`` and the stopped kernels' ``h_family`` /
``v_ref_family``.  Zero drift, sigma = sqrt(2) I, the unit ball.  The
dense-sigma ``ExponentialOnBallNonlinearSinHessian`` and ``Committor`` ...
``SinNorm2`` wait for their slices (ROADMAP.md, Queue 1 item 7).
"""

from __future__ import annotations

import numpy as np
import torch

from .base import DiffusionMatrix, Geometry, Problem


def _r2(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(x * x, dim=-1)


class _ZeroDriftBall(Problem):
    """Shared scaffolding: zero drift, constant sigma, unit-ball geometry."""

    def __init__(self, d, B, boundary_distance=1.0, boundary_type="Dirichlet",
                 device=None):
        super().__init__(d=d, device=device)
        self._sigma = DiffusionMatrix(B, device=self.device)
        self.B = self._sigma.mat
        self.geometry = Geometry(kind="sphere",
                                 boundary_distance=boundary_distance)
        self.boundary_type = boundary_type

    @property
    def sigma_struct(self):
        return self._sigma

    def b(self, x):
        return torch.zeros_like(x)

    def f(self, x, t=None):
        return torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)

    def drift_family(self):
        return ("zero", None)


def _sqrt2_eye(d: int) -> np.ndarray:
    return np.float32(np.sqrt(2.0)) * np.eye(d, dtype=np.float32)


class ExponentialOnSphere(_ZeroDriftBall):
    """Linear elliptic on the unit ball, manufactured v = exp(alpha |x|^2)."""

    def __init__(self, name="Exponential on sphere", d=2, alpha=1.0,
                 device=None):
        super().__init__(d=d, B=_sqrt2_eye(d), device=device)
        self.name = name
        self.alpha = float(alpha)

    def g(self, x):
        return torch.exp(self.alpha * _r2(x))

    def h(self, x, y, z):
        return -self.alpha * y * (self.alpha * 4.0 * _r2(x) + 2.0 * self.d)

    def u_ref(self, x):
        return (-2.0 * float(np.sqrt(2.0)) * self.alpha * x
                * torch.exp(self.alpha * _r2(x))[:, None])

    def v_ref(self, x):
        return torch.exp(self.alpha * _r2(x))

    def h_family(self):
        a = self.alpha
        return ("ball_exp", -2.0 * a * self.d, -4.0 * a * a, 0.0, "none")

    def v_ref_family(self):
        return ("exp_r2", self.alpha)


class ExponentialOnBallNonlinear(_ZeroDriftBall):
    """Nonlinear elliptic (h contains -y^2); Dirichlet or Neumann
    (g returns gradient data for Neumann, problems.py:1017-1019)."""

    _phi = "identity"

    def __init__(self, name="Exponential on ball nonlinear", d=2, alpha=1.0,
                 boundary_type="Dirichlet", device=None):
        super().__init__(d=d, B=_sqrt2_eye(d), boundary_type=boundary_type,
                         device=device)
        self.name = name
        self.alpha = float(alpha)

    def g(self, x):
        r2 = _r2(x)
        if self.boundary_type == "Neumann":
            return 2.0 * self.alpha * x * torch.exp(self.alpha * r2)[:, None]
        return torch.exp(self.alpha * r2)

    def h(self, x, y, z):
        r2 = _r2(x)
        return (-2.0 * self.alpha * y * (self.alpha * 2.0 * r2 + self.d)
                + torch.exp(2.0 * self.alpha * r2) - y ** 2)

    def v_ref(self, x):
        return torch.exp(self.alpha * _r2(x))

    def h_family(self):
        a = self.alpha
        return ("ball_exp", -2.0 * a * self.d, -4.0 * a * a, 2.0 * a,
                self._phi)

    def v_ref_family(self):
        return ("exp_r2", self.alpha)


class ExponentialOnBallNonlinearSin(ExponentialOnBallNonlinear):
    """sin() nonlinearity - the d=10/50 workhorse (problems.py:1031-1064)."""

    _phi = "sin"

    def h(self, x, y, z):
        r2 = _r2(x)
        return (-2.0 * self.alpha * y * (self.alpha * 2.0 * r2 + self.d)
                + torch.sin(torch.exp(2.0 * self.alpha * r2) - y ** 2))
