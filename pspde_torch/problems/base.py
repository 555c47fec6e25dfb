"""Problem protocol for the port (counterpart of ``pspde/problems/base.py``).

Same duck-typed protocol as the JAX package, with every method a torch
function over batched inputs ``x: (K, d)``.  A problem lives on one
device, chosen at construction (``device=``, the CUDA card when None:
``utils/device.py``); its constant tensors and ``X_0`` are created there.

The hand-written rollout kernels cover one family of coefficients, and a
problem states whether it belongs to it through ``drift_family``,
``running_cost_family`` and, for the training kernels, ``h_family``
(``None`` means outside the family).  The stopped-path problems
(``problems/elliptic.py``, ``problems/parabolic.py``) state their h through
``h_family`` too, in the stopped kernels' form, and the elliptic ones their
closed-form reference through ``v_ref_family``; ``FokkerPlanckEigen``
(``problems/eigen.py``) states its drift, h and reference in the stopped
kernels' torus family.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Geometry:
    """Spatial domain metadata for elliptic / general solvers.

    kind: one of 'sphere', 'two_spheres', 'square', 'square-corner',
          'unbounded', 'unbounded_square'.
    """

    kind: str
    boundary_distance: float = 1.0
    boundary_distance_1: float = 1.0
    boundary_distance_2: float = 2.0
    X_l: float = -1.0
    X_r: float = 1.0
    X_corner: float = 0.0
    one_boundary: bool = False

    @property
    def bounded(self) -> bool:
        return "unbounded" not in self.kind


class DiffusionMatrix:
    """Structured (d, d) diffusion matrix: 'scalar', 'diag' or 'full'.

    The kind is detected on the host exactly as in the JAX package, so the
    hot loop uses a broadcasted multiply unless sigma is genuinely dense.
    """

    def __init__(self, mat, device=None):
        device = resolve_device(device)
        host = np.asarray(mat, dtype=np.float32)
        if host.ndim != 2 or host.shape[0] != host.shape[1]:
            raise ValueError(f"diffusion matrix must be square, got shape "
                             f"{host.shape}")
        self.mat = torch.as_tensor(host, device=device)
        d = host.shape[0]
        if np.allclose(host, host[0, 0] * np.eye(d)):
            self.kind = "scalar"
            self.scale = float(host[0, 0])
            self.diag = None
        elif np.allclose(host, np.diag(np.diagonal(host))):
            self.kind = "diag"
            self.scale = None
            self.diag = torch.as_tensor(
                np.ascontiguousarray(np.diagonal(host)), device=device)
        else:
            self.kind = "full"
            self.scale = None
            self.diag = None
        self._inv_mat = None

    @property
    def d(self) -> int:
        return self.mat.shape[0]

    def apply(self, v: torch.Tensor) -> torch.Tensor:
        """sigma @ v per batch row: v (..., d) -> (..., d)."""
        if self.kind == "scalar":
            return self.scale * v
        if self.kind == "diag":
            return self.diag * v
        return v @ self.mat.T

    def apply_T(self, v: torch.Tensor) -> torch.Tensor:
        """sigma^T @ v per batch row (Z = sigma^T grad V)."""
        if self.kind == "scalar":
            return self.scale * v
        if self.kind == "diag":
            return self.diag * v
        return v @ self.mat

    def apply_cols(self, v: torch.Tensor) -> torch.Tensor:
        """sigma @ v in column layout: v (d, K) -> (d, K)."""
        if self.kind == "scalar":
            return self.scale * v
        if self.kind == "diag":
            return self.diag[:, None] * v
        return self.mat @ v

    def inv_apply(self, v: torch.Tensor) -> torch.Tensor:
        """sigma^{-1} @ v per batch row."""
        if self.kind == "scalar":
            return v / self.scale
        if self.kind == "diag":
            return v / self.diag
        if self._inv_mat is None:
            inv = np.linalg.inv(self.mat.cpu().numpy()).astype(np.float32)
            self._inv_mat = torch.as_tensor(inv, device=self.mat.device)
        return v @ self._inv_mat.T


class Problem:
    """Base class: common metadata; subclasses define the physics."""

    # True when h(t, x, y, z) ignores y
    h_is_y_free: bool = False

    name: str = "problem"
    d: int
    T: Optional[float] = None
    geometry: Optional[Geometry] = None
    boundary_type: str = "Dirichlet"

    def __init__(self, d: int, T: Optional[float] = None, device=None):
        self.d = d
        self.T = T
        self.device = resolve_device(device)
        self.X_0 = torch.zeros((d,), dtype=torch.float32, device=self.device)

    def _t(self, a) -> torch.Tensor:
        """Host array -> float32 tensor on the problem's device."""
        return torch.as_tensor(np.asarray(a, dtype=np.float32),
                               device=self.device)

    # -- diffusion ---------------------------------------------------------
    def sigma(self, x: torch.Tensor) -> torch.Tensor:
        return self.sigma_struct.mat

    @property
    def sigma_struct(self) -> DiffusionMatrix:
        raise NotImplementedError

    def b(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    # -- rollout-kernel family ---------------------------------------------
    def drift_family(self):
        """('neg_identity', None) for b(x) = -x, ('matrix', A) for
        b(x) = A x, ('zero', None) for b = 0, ('torus_cos', c) for
        b(x) = -cos(s) c sin(x) with s = c sum_j cos x_j and a uniform
        scalar c (the stopped kernels' torus family), ('double_well',
        kappa) for b_j(x) = -4 kappa_j x_j (x_j^2 - 1) (the serve kernel
        only), or None when the drift is outside every kernel's family."""
        return None

    def running_cost_family(self):
        """('zero', None) for f = 0, ('quadratic', P) for f = x^T P x, or
        None when f is outside the kernel family."""
        return None

    def h_family(self):
        """The family of h that a training kernel covers, or None when h is
        outside every kernel's family:

        * ('quadratic_z', c_h, f_coef): the Y-free HJB
          h(t, x, y, z) = c_h |z|^2 / 2 + f_coef f(x, t) (the HJB
          training kernels);
        * ('ball_exp', c_y, c_yr2, k, phi[, k_t[, c_ys1]]): the z-free
          h = y (c_y + c_yr2 |x|^2 + c_ys1 (sum_j x_j)^2)
          + phi(exp(k |x|^2 + k_t t) - y^2) with phi in ('none',
          'identity', 'sin') (the stopped kernels); k_t and c_ys1 are 0
          where left out: the parabolic problems (``problems/
          parabolic.py``) state k_t, the full-Hessian elliptic problem
          c_ys1;
        * ('torus_fp', c): the z-free, linear in y
          h = y (-c^2 sum_j sin^2 x_j sin(s) - cos(s) s) with
          s = c sum_j cos x_j (``FokkerPlanckEigen``; the stopped kernels'
          torus family);
        * ('schrodinger', c): the z-free h = -y^3 - y pot(x)
          (``SchrodingerEigen``; the stopped kernels' Schroedinger family,
          ``problems/eigen.py:schrodinger_pot``).
        """
        return None

    def v_ref_family(self):
        """('exp_r2', a) for the closed form v_ref(x) = exp(a |x|^2),
        ('committor', a, c, d) for (a^2 - r^(2-d) a^d) / (a^2 - c^(2-d) a^d)
        with r = |x|, ('torus_fp', c) for v_ref(x) = exp(-sin(s)), s =
        c sum_j cos x_j, or ('schrodinger', c) for (1/c) exp((1/d) sum_j
        cos x_j), which the stopped kernels evaluate in-kernel, or None."""
        return None

    def running_cost(self, x: torch.Tensor, t: float) -> torch.Tensor:
        """f(x, t), or zeros when the problem has no running cost."""
        f = getattr(self, "f", None)
        if f is None:
            return torch.zeros(x.shape[0], dtype=torch.float32,
                               device=x.device)
        return f(x, t)

    # -- optional reference solutions -------------------------------------
    @property
    def has_u_ref(self) -> bool:
        return hasattr(self, "u_ref")

    @property
    def has_v_ref(self) -> bool:
        return hasattr(self, "v_ref")
