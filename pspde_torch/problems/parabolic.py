"""Parabolic problems for the general (space-time) solver (counterpart of
``pspde/problems/parabolic.py``).

``HeatEquation``, ``AllenCahn``, ``ExponentialOnSphereParabolic`` and
``ExponentialOnSphereNonlinearParabolic`` (Dirichlet and Neumann ``g``),
each with the GeneralSolver protocol: ``f_terminal(x)`` the terminal
condition V(x, T), ``g(x, t)`` the spatial boundary data, ``h(t, x, y, z)``
the nonlinearity and, where there is one, ``v_ref(x, t)``.  Zero drift,
sigma = sqrt(2) I.  ``h_family`` states h in the stopped kernels' form with
the time coefficient k_t; ``AllenCahn``'s cubic h with the coefficient
c_y3 of y^3 (the tuple's eighth entry).
"""

from __future__ import annotations

import torch

from .base import DiffusionMatrix, Geometry, Problem
from .elliptic import _r2, _sqrt2_eye


class _ZeroDriftParabolic(Problem):
    """Shared scaffolding: zero drift, sigma = sqrt(2) I, a horizon T."""

    def __init__(self, d, T, geometry, boundary_type="Dirichlet",
                 device=None):
        super().__init__(d=d, T=float(T), device=device)
        self._sigma = DiffusionMatrix(_sqrt2_eye(d), device=self.device)
        self.B = self._sigma.mat
        self.geometry = geometry
        self.boundary_type = boundary_type

    @property
    def sigma_struct(self):
        return self._sigma

    def b(self, x):
        return torch.zeros_like(x)

    def drift_family(self):
        return ("zero", None)


class HeatEquation(_ZeroDriftParabolic):
    """d-dimensional heat equation on the whole space, v = |x|^2 +
    2 (T - t) d."""

    h_is_y_free = True

    def __init__(self, name="Heat equation", d=1, T=1.0, seed=42,
                 device=None):
        super().__init__(d, T, Geometry(kind="unbounded",
                                        boundary_distance=1.0),
                         device=device)
        self.name = name

    def g(self, x, t=None):
        return torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)

    def h(self, t, x, y, z):
        return torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)

    def f_terminal(self, x):
        return _r2(x)

    def v_ref(self, x, t):
        return _r2(x) + 2.0 * (self.T - t) * self.d

    def h_family(self):
        return ("ball_exp", 0.0, 0.0, 0.0, "none", 0.0)


class AllenCahn(_ZeroDriftParabolic):
    """Allen-Cahn with the cubic nonlinearity h = y - y^3 and the terminal
    condition f = 1 / (2 + 0.4 |x|^2); v(0, 0) = 0.052802 at d=100 in the
    literature."""

    V0_LITERATURE = 0.052802

    def __init__(self, name="Allen-Cahn", d=1, T=0.3, seed=42, device=None):
        super().__init__(d, T, Geometry(kind="unbounded",
                                        boundary_distance=2.0),
                         device=device)
        self.name = name

    def h(self, t, x, y, z):
        return y - y ** 3

    def f_terminal(self, x):
        return 1.0 / (2.0 + 0.4 * _r2(x))

    def h_family(self):
        # ('ball_exp', c_y, c_yr2, k, phi, k_t, c_ys1, c_y3): y - y^3
        return ("ball_exp", 1.0, 0.0, 0.0, "none", 0.0, 0.0, -1.0)


class ExponentialOnSphereParabolic(_ZeroDriftParabolic):
    """Manufactured linear parabolic problem on the unit ball, v =
    exp(alpha |x|^2 + t)."""

    def __init__(self, name="Exponential on sphere", d=2, T=1.0, alpha=1.0,
                 device=None):
        super().__init__(d, T, Geometry(kind="sphere",
                                        boundary_distance=1.0),
                         device=device)
        self.name = name
        self.alpha = float(alpha)

    def f_terminal(self, x):
        return torch.exp(self.alpha * _r2(x) + self.T)

    def g(self, x, t):
        return torch.exp(self.alpha * _r2(x) + t)

    def h(self, t, x, y, z):
        return -y * (2.0 * self.alpha
                     * (self.alpha * 2.0 * _r2(x) + self.d) + 1.0)

    def v_ref(self, x, t):
        return torch.exp(self.alpha * _r2(x) + t)

    def h_family(self):
        a = self.alpha
        return ("ball_exp", -(2.0 * a * self.d + 1.0), -4.0 * a * a, 0.0,
                "none", 0.0)


class ExponentialOnSphereNonlinearParabolic(_ZeroDriftParabolic):
    """Nonlinear parabolic variant with a sin() nonlinearity; Dirichlet, or
    Neumann (``g`` then returns the gradient data (K, d))."""

    def __init__(self, name="Exponential on ball", d=2, T=1.0, alpha=1.0,
                 boundary_type="Dirichlet", device=None):
        super().__init__(d, T, Geometry(kind="sphere",
                                        boundary_distance=1.0),
                         boundary_type=boundary_type, device=device)
        self.name = name
        self.alpha = float(alpha)

    def f_terminal(self, x):
        return torch.exp(self.alpha * _r2(x) + self.T)

    def g(self, x, t):
        e = torch.exp(self.alpha * _r2(x) + t)
        if self.boundary_type == "Neumann":
            return 2.0 * self.alpha * x * e[:, None]
        return e

    def h(self, t, x, y, z):
        r2 = _r2(x)
        return (-2.0 * self.alpha * y * (self.alpha * 2.0 * r2 + self.d) - y
                + torch.sin(torch.exp(2.0 * self.alpha * r2 + 2.0 * t)
                            - y ** 2))

    def v_ref(self, x, t):
        return torch.exp(self.alpha * _r2(x) + t)

    def h_family(self):
        a = self.alpha
        return ("ball_exp", -(2.0 * a * self.d + 1.0), -4.0 * a * a,
                2.0 * a, "sin", 2.0)
