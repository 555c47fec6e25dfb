"""Elliptic boundary-value problems, first-exit formulations (counterpart
of ``pspde/problems/elliptic.py``).

Every problem of the module, with ``g``, ``h(x, y, z)`` and ``v_ref``
(``u_ref`` where the JAX package has it):

  * in the stopped kernels' family (``h_family`` / ``v_ref_family``):
    ``ExponentialOnSphere``, ``ExponentialOnBallNonlinear`` (Dirichlet and
    Neumann ``g``) and ``ExponentialOnBallNonlinearSin`` (sigma = sqrt(2)
    I on the unit ball), ``ExponentialOnBallNonlinearSinHessian`` (the
    dense sigma = sqrt(2/d) ones(d, d), h with (sum_j x_j)^2) and
    ``Committor`` (sigma = I between the spheres of radii 1 and 2, h = 0,
    the radial closed form as reference);
  * on the scan only, as in the JAX package, which gives them no
    transposed h: ``QuadraticGradient`` (h reads z), ``Helmholtz`` and
    ``Oscillations`` (squares), ``SinNorm2``.
"""

from __future__ import annotations

import numpy as np
import torch

from .base import DiffusionMatrix, Geometry, Problem


def _r2(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(x * x, dim=-1)


class _ZeroDriftBall(Problem):
    """Shared scaffolding: zero drift, no running cost, constant sigma; the
    ball of radius ``boundary_distance`` unless a ``geometry`` is given."""

    def __init__(self, d, B, boundary_distance=1.0, boundary_type="Dirichlet",
                 geometry=None, device=None):
        super().__init__(d=d, device=device)
        self._sigma = DiffusionMatrix(B, device=self.device)
        self.B = self._sigma.mat
        self.geometry = geometry or Geometry(
            kind="sphere", boundary_distance=boundary_distance)
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


def _sqrt_2_over_d_ones(d: int, scale: float = 1.0) -> np.ndarray:
    """scale sqrt(2/d) ones(d, d) rounded as the JAX package rounds it:
    the square root taken in float32 of float32(2/d)."""
    s = np.float32(scale) * np.sqrt(np.float32(2.0 / d))
    return s * np.ones((d, d), dtype=np.float32)


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


class ExponentialOnBallNonlinearSinHessian(_ZeroDriftBall):
    """Same as ...Sin but with non-diagonal sigma B = sqrt(2/d) ones(d, d)
    (problems.py:1072), forcing full-Hessian treatment in PINN mode."""

    def __init__(self, name="Exponential on ball nonlinear", d=2, alpha=1.0,
                 boundary_type="Dirichlet", device=None):
        super().__init__(d=d, B=_sqrt_2_over_d_ones(d),
                         boundary_type=boundary_type, device=device)
        self.name = name
        self.alpha = float(alpha)

    def g(self, x):
        r2 = _r2(x)
        if self.boundary_type == "Neumann":
            return 2.0 * self.alpha * x * torch.exp(self.alpha * r2)[:, None]
        return torch.exp(self.alpha * r2)

    def h(self, x, y, z):
        # problems.py:1094: sum over x x^T outer products == (sum_i x_i)^2
        outer = torch.sum(x, dim=-1) ** 2
        r2 = _r2(x)
        return (-2.0 * self.alpha * y * (self.alpha * 2.0 * outer + self.d)
                + torch.sin(torch.exp(2.0 * self.alpha * r2) - y ** 2))

    def v_ref(self, x):
        return torch.exp(self.alpha * _r2(x))

    def h_family(self):
        a = self.alpha
        return ("ball_exp", -2.0 * a * self.d, 0.0, 2.0 * a, "sin", 0.0,
                -4.0 * a * a)

    def v_ref_family(self):
        return ("exp_r2", self.alpha)


class Committor(_ZeroDriftBall):
    """Committor function between spheres of radii a=1 and c=2
    (problems.py:1546-1579), exact radial solution problems.py:1577-1579."""

    def __init__(self, name="Committor", d=2, alpha=1.0, device=None):
        self.a = 1.0
        self.c = 2.0
        super().__init__(d, np.eye(d, dtype=np.float32), geometry=Geometry(
            kind="two_spheres", boundary_distance_1=self.a,
            boundary_distance_2=self.c), device=device)
        self.name = name

    def g(self, x):
        return (torch.sqrt(_r2(x)) > self.a).to(x.dtype)

    def h(self, x, y, z):
        return torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)

    def v_ref(self, x):
        r = torch.sqrt(_r2(x))
        a, c, d = self.a, self.c, self.d
        return ((a ** 2 - r ** (2 - d) * a ** d)
                / (a ** 2 - c ** (2 - d) * a ** d))

    def h_family(self):
        return ("ball_exp", 0.0, 0.0, 0.0, "none")

    def v_ref_family(self):
        return ("committor", self.a, self.c, self.d)


class QuadraticGradient(_ZeroDriftBall):
    """Elliptic with |z|^2 gradient nonlinearity, v = log((|x|^2 + 1)/d)
    (problems.py:1582-1611).  h reads z: the scan only."""

    def __init__(self, name="Quadratic Gradient", d=1, r=1.0, device=None):
        super().__init__(d=d, B=_sqrt2_eye(d), boundary_distance=r,
                         device=device)
        self.name = name
        self.X_0 = -torch.ones((d,), dtype=torch.float32, device=self.device)

    def g(self, x):
        return torch.log((_r2(x) + 1.0) / self.d)

    def h(self, x, y, z):
        return torch.sum(z * z, dim=-1) / 2.0 - 2.0 * torch.exp(-y)

    def v_ref(self, x):
        return torch.log((_r2(x) + 1.0) / self.d)


class Helmholtz(_ZeroDriftBall):
    """2-d Helmholtz with manufactured sin*sin solution
    (problems.py:1614-1654)."""

    def __init__(self, name="Helmholtz", d=2, r=1.0, device=None):
        super().__init__(d, _sqrt2_eye(d), geometry=Geometry(
            kind="square", X_l=-1.0, X_r=1.0), device=device)
        self.name = name
        self.X_0 = -torch.ones((d,), dtype=torch.float32, device=self.device)
        self.a_1, self.a_2, self.k = 1.0, 4.0, 1.0
        if d != 2:
            print("Only implemented for d = 2.")

    def _sinsin(self, x):
        return (torch.sin(self.a_1 * np.pi * x[:, 0])
                * torch.sin(self.a_2 * np.pi * x[:, 1]))

    def g(self, x):
        return self._sinsin(x)

    def h(self, x, y, z):
        s = self._sinsin(x)
        return (self.k ** 2 * y + (self.a_1 * np.pi) ** 2 * s
                + (self.a_2 * np.pi) ** 2 * s - self.k ** 2 * s)

    def v_ref(self, x):
        return self._sinsin(x)


class Oscillations(_ZeroDriftBall):
    """1-d multiscale oscillatory Poisson problem (problems.py:1657-1693)."""

    def __init__(self, name="Oscillations", d=1, r=1.0, device=None):
        super().__init__(d, _sqrt2_eye(d), geometry=Geometry(
            kind="square", X_l=0.0, X_r=1.0), device=device)
        self.name = name
        self.X_0 = -torch.ones((d,), dtype=torch.float32, device=self.device)
        self.a = 5.0
        if d != 1:
            print("Only implemented for d = 1.")

    def g(self, x):
        return torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)

    def h(self, x, y, z):
        pi = np.pi
        return ((2.0 * pi) ** 2 * torch.sin(2.0 * pi * x[:, 0])
                + (self.a * pi) ** 2 * 0.1 * torch.sin(self.a * pi * x[:, 0]))

    def v_ref(self, x):
        pi = np.pi
        return (torch.sin(2.0 * pi * x[:, 0])
                + 0.1 * torch.sin(self.a * pi * x[:, 0]))


class SinNorm2(_ZeroDriftBall):
    """v = sin(pi |x|^2) with linear/nonlinear switch and non-diagonal sigma
    (problems.py:1696-1730)."""

    def __init__(self, name="SinNorm2", d=1, r=1.0, linear=True, alpha=1.0,
                 device=None):
        self.alpha = float(alpha)
        super().__init__(d, _sqrt_2_over_d_ones(d, self.alpha), device=device)
        self.name = name
        self.X_0 = -torch.ones((d,), dtype=torch.float32, device=self.device)
        self.linear = linear

    def g(self, x):
        return torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)

    def h(self, x, y, z):
        pi = np.pi
        r2 = _r2(x)
        s1 = torch.sum(x, dim=-1) ** 2
        if self.linear:
            return self.alpha ** 2 * (4.0 * pi ** 2 * torch.sin(pi * r2) * s1
                                      - 2.0 * self.d * pi
                                      * torch.cos(pi * r2))
        return self.alpha ** 2 * (4.0 * pi ** 2 * y * s1
                                  - 2.0 * self.d * pi * torch.cos(pi * r2)
                                  + torch.sin(pi * r2) ** 2 - y ** 2)

    def v_ref(self, x):
        return torch.sin(np.pi * _r2(x))
