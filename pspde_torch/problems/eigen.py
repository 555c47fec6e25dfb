"""Eigenvalue problems on the torus [0, 2 pi]^d (counterpart of
``pspde/problems/eigen.py``).

  * ``FokkerPlanckEigen``: the generator eigenproblem of the Fokker-Planck
    notebook, drift b = -cos(s) c sin(x) with s = sum_j c_j cos x_j,
    h = y (-sum_j c_j^2 sin^2 x_j sin(s) - cos(s) s), lambda_true = 0,
    eigenfunction exp(-sin(s));
  * ``SchrodingerEigen``: the nonlinear Schroedinger eigenproblem, zero
    drift, cubic h = -y^3 - y pot(x), lambda_true = -3, eigenfunction
    (1/c) exp((1/d) sum cos x) with c from the same quadrature as pspde
    (1.1040855 at d=5, 1.0511402 at d=10).

Both have sigma = sqrt(2) I and the square geometry [0, 2 pi]^d, whose
exit test reads the proposal (``rollout/sampling.py:inside_fn``); periodic
boundary conditions are the solver's value and gradient matching
(``solvers/eigen.py``).  ``FokkerPlanckEigen`` states its drift, h and
reference in the stopped kernels' torus family (``drift_family``,
``h_family``, ``v_ref_family``: ('torus_cos', c) and ('torus_fp', c) for a
uniform c); ``SchrodingerEigen`` states its zero drift, its cubic h and
its reference in the kernels' Schroedinger family (('zero', None),
('schrodinger', c) and ('schrodinger', c)), which the kernels take with a
``DenseNetTanh`` value net.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy import integrate

from .base import DiffusionMatrix, Geometry, Problem


class _Torus(Problem):
    """Shared scaffolding: sigma = sqrt(2) I, the box [0, 2 pi]^d, g = 0,
    X_0 = (pi, ..., pi)."""

    def __init__(self, name, d, device=None):
        super().__init__(d=d, device=device)
        self.name = name
        self._sigma = DiffusionMatrix(np.float32(np.sqrt(2.0))
                                      * np.eye(d, dtype=np.float32),
                                      device=self.device)
        self.B = self._sigma.mat
        self.X_0 = self._t(np.full((d,), np.pi))
        self.geometry = Geometry(kind="square", X_l=0.0, X_r=2.0 * np.pi)

    @property
    def sigma_struct(self):
        return self._sigma

    def g(self, x):
        return torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)


class FokkerPlanckEigen(_Torus):
    """Fokker-Planck generator eigenproblem (FP eigenvalue notebook
    cell 2)."""

    def __init__(self, name="Eigenvalue", d=1, device=None):
        super().__init__(name, d, device=device)
        self.c = np.full((d,), 0.1)
        self.lambda_true = 0.0

    @property
    def c(self) -> torch.Tensor:
        return self._c

    @c.setter
    def c(self, value):
        # a host copy, so that the family hooks read c without a device sync
        self._c_host = np.asarray(
            value.cpu() if torch.is_tensor(value) else value,
            dtype=np.float32)
        self._c = self._t(self._c_host)

    def _s(self, x):
        return torch.sum(self.c * torch.cos(x), dim=-1)

    def b(self, x):
        s = self._s(x)[:, None]
        return -torch.cos(s) * self.c * torch.sin(x)

    def h(self, x, y, z):
        s = self._s(x)
        return y * (-torch.sum(self.c ** 2 * torch.sin(x) ** 2, dim=-1)
                    * torch.sin(s) - torch.cos(s) * s)

    def v_ref(self, x):
        return torch.exp(-torch.sin(self._s(x)))

    def _uniform_c(self):
        c = self._c_host
        return float(c[0]) if np.all(c == c[0]) else None

    def drift_family(self):
        c = self._uniform_c()
        return None if c is None else ("torus_cos", c)

    def h_family(self):
        c = self._uniform_c()
        return None if c is None else ("torus_fp", c)

    def v_ref_family(self):
        return self.h_family()


def schrodinger_pot(x: torch.Tensor, c: float, d: int) -> torch.Tensor:
    """The Schroedinger notebooks' potential, one value per row of x,
    term by term as pspde's ``SchrodingerEigen.h`` (float32, the Python
    floats -1/c^2 and 2/d rounded to float32 as JAX's weak types round
    them; sin^2 divided by d^2 and cos by d):

        pot(x) = -(1/c^2) exp((2/d) sum_j cos x_j)
                 + sum_j (sin^2 x_j / d^2 - cos x_j / d) - 3."""
    return (-1.0 / c ** 2 * torch.exp(2.0 / d * torch.sum(torch.cos(x),
                                                            dim=-1))
            + torch.sum(torch.sin(x) ** 2 / d ** 2 - torch.cos(x) / d,
                        dim=-1) - 3.0)


class SchrodingerEigen(_Torus):
    """Nonlinear Schroedinger eigenproblem (Schroedinger notebooks cell 5).

    The normalization constant c solves ||(1/c) exp((1/d) sum cos x)||_L2
    = 1 and comes from quadrature (notebook cell 1), as in pspde."""

    def __init__(self, name="Eigenvalue", d=1, device=None):
        super().__init__(name, d, device=device)
        self.lambda_true = -3.0
        val = integrate.quad(lambda x: np.exp(2.0 / d * np.cos(x)),
                             0.0, 2.0 * np.pi)[0]
        self.c = float(np.sqrt(val ** d / (2.0 * np.pi) ** d))

    def b(self, x):
        return torch.zeros_like(x)

    def pot(self, x):
        return schrodinger_pot(x, self.c, self.d)

    def h(self, x, y, z):
        return -y ** 3 - y * self.pot(x)

    def v_ref(self, x):
        return (1.0 / self.c
                * torch.exp(1.0 / self.d * torch.sum(torch.cos(x), dim=-1)))

    def drift_family(self):
        return ("zero", None)

    def h_family(self):
        """('schrodinger', c): h = -y^3 - y pot(x) (``schrodinger_pot``),
        dh/dy = -3 y^2 - pot(x)."""
        return ("schrodinger", self.c)

    def v_ref_family(self):
        """('schrodinger', c): v_ref(x) = (1/c) exp((1/d) sum_j cos x_j)."""
        return self.h_family()
