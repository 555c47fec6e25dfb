"""Double-well metastability problems with their FD reference (counterpart
of ``pspde/problems/double_well.py``): ``DoubleWell`` (1-d) and
``DoubleWell_multidim`` (a product of 1-d wells with mixed
metastabilities).

The reference solution comes from the port's own host oracle
(``problems/fd_oracles.py``), solved once per problem in float64; the
tables move to the problem's device and the lookups are gathers
(``_TableLookup1D``), so the training loop never leaves the device.

Both problems state their drift b(x) = -4 kappa x (x^2 - 1), kappa per
dimension, as ('double_well', kappa) (``drift_family``), which the serve
kernel covers (``rollout/kernels.py``); the training kernels do not.
"""

from __future__ import annotations

import numpy as np
import torch

from .base import DiffusionMatrix, Geometry, Problem
from .fd_oracles import parabolic_log_transform_reference


def _t_to_index(ts: np.ndarray, delta_t: float, nmax: int) -> np.ndarray:
    return np.minimum(np.ceil(np.asarray(ts) / delta_t - 1e-9).astype(int),
                      nmax)


class _TableLookup1D:
    """Gathers a per-time 1-d table at the grid index floor((x + xb) / dx),
    clipped to the table's range, on the table's device."""

    def __init__(self, table: np.ndarray, xb: float, dx: float, device):
        self.table = torch.as_tensor(np.asarray(table, dtype=np.float32),
                                     device=device)   # (n_times, nx_t)
        self.xb = float(xb)
        self.dx = float(dx)
        self.nmax = table.shape[1] - 1

    def __call__(self, x1d: torch.Tensor, i) -> torch.Tensor:
        idx = torch.clamp(torch.floor((x1d + self.xb) / self.dx).to(
            torch.int64), 0, self.nmax)
        return self.table[i][idx]


def _neglog(psi: np.ndarray) -> np.ndarray:
    return -np.log(np.maximum(psi, 1e-300))


class _WellFamily(Problem):
    """The hooks both problems share: sigma = I, f = 0, h = -1/2 |z|^2,
    X_0 = (-1, ..., -1)."""

    h_is_y_free = True

    def __init__(self, name, d, T, device):
        super().__init__(d=d, T=float(T), device=device)
        self.name = name
        self.B = self._t(np.eye(d))
        self._sigma = DiffusionMatrix(np.eye(d, dtype=np.float32),
                                      device=self.device)
        self.X_0 = self._t(-np.ones((d,)))
        self.ref_sol_is_defined = False

    @property
    def sigma_struct(self):
        return self._sigma

    def b(self, x):
        return -self.grad_V(x)

    def f(self, x, t):
        return torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)

    def h(self, t, x, y, z):
        return -0.5 * torch.sum(z * z, dim=-1)

    def drift_family(self):
        return ("double_well", self._kappa_vec)

    def running_cost_family(self):
        return ("zero", None)

    def h_family(self):
        return ("quadratic_z", -1.0, 0.0)


class DoubleWell(_WellFamily):
    """1-d double-well potential kappa (x^2 - 1)^2, terminal cost
    eta (x - 1)^2, h = -1/2 |z|^2; the FD oracle solves the log-transformed
    linear backward PDE."""

    def __init__(self, name="Double well", d=1, T=1.0, eta=1.0, kappa=1.0,
                 device=None):
        super().__init__(name, d, T, device)
        self.eta = float(eta)
        self.kappa = float(kappa)
        self._kappa_vec = self._t(np.full((d,), self.kappa))
        if d != 1:
            print("The double well example is only implemented for d = 1.")

    def V(self, x):
        return self.kappa * (x ** 2 - 1.0) ** 2

    def grad_V(self, x):
        return 4.0 * self.kappa * x * (x ** 2 - 1.0)

    def g(self, x):
        return torch.squeeze(self.eta * (x - 1.0) ** 2, dim=-1)

    # -- FD oracle ---------------------------------------------------------
    def compute_reference_solution(self, delta_t=0.005, xb=2.5, nx=1000):
        Vnp = lambda x: self.kappa * (x ** 2 - 1.0) ** 2
        gnp = lambda x: self.eta * (x - 1.0) ** 2
        xvec, psi, u, dx = parabolic_log_transform_reference(
            Vnp, gnp, self.T, delta_t=delta_t, xb=xb, nx=nx, B00=1.0)
        self.ref_delta_t, self.xb, self.dx = delta_t, xb, dx
        self._psi_np, self._u_np, self.xvec = psi, u, xvec
        self.ref_sol_is_defined = True

    def u_ref_fn(self, ts: np.ndarray):
        assert self.ref_sol_is_defined
        idx = _t_to_index(ts, self.ref_delta_t, self._u_np.shape[0] - 1)
        lut = _TableLookup1D(self._u_np[idx], self.xb, self.dx, self.device)

        def u_ref(x, i):
            return lut(x[:, 0], i)[:, None]

        return u_ref

    def v_ref_fn(self, ts: np.ndarray):
        assert self.ref_sol_is_defined
        idx = _t_to_index(ts, self.ref_delta_t, self._psi_np.shape[0] - 1)
        lut = _TableLookup1D(_neglog(self._psi_np[idx]), self.xb, self.dx,
                             self.device)

        def v_ref(x, i):
            return lut(x[:, 0], i)

        return v_ref


class DoubleWell_multidim(_WellFamily):
    """Product of 1-d double wells: dimensions 0..d_1-1 carry (eta, kappa),
    dimensions d_1..d-1 carry (1, 1): mixed metastabilities."""

    def __init__(self, name="Double well", d=1, d_1=1, d_2=0, T=1.0, eta=1.0,
                 kappa=1.0, device=None):
        super().__init__(name, d, T, device)
        self.d_1, self.d_2 = d_1, d_2
        self.eta, self.kappa = float(eta), float(kappa)
        self.eta_ = self._t([eta] * d_1 + [1.0] * d_2)
        self.kappa_ = self._t([kappa] * d_1 + [1.0] * d_2)
        self._kappa_vec = self.kappa_
        self.geometry = Geometry(kind="unbounded", boundary_distance=2.0)

    def grad_V(self, x):
        return 4.0 * self.kappa_ * x * (x ** 2 - 1.0)

    def g(self, x):
        return torch.sum(self.eta_ * (x - 1.0) ** 2, dim=-1)

    def compute_reference_solution(self, delta_t=0.005, xb=2.5, nx=1000):
        """Two 1-d FD solves: the (eta, kappa) wells and the unit wells."""
        self.ref_delta_t, self.xb = delta_t, xb
        _, psi1, u1, dx = parabolic_log_transform_reference(
            lambda x: self.kappa * (x ** 2 - 1.0) ** 2,
            lambda x: self.eta * (x - 1.0) ** 2,
            self.T, delta_t=delta_t, xb=xb, nx=nx, B00=1.0)
        _, psi2, u2, _ = parabolic_log_transform_reference(
            lambda x: (x ** 2 - 1.0) ** 2,
            lambda x: (x - 1.0) ** 2,
            self.T, delta_t=delta_t, xb=xb, nx=nx, B00=1.0)
        self.dx = dx
        self._psi1, self._u1 = psi1, u1
        self._psi2, self._u2 = psi2, u2
        self.ref_sol_is_defined = True

    def u_ref_fn(self, ts: np.ndarray):
        """The per-dimension 1-d controls side by side."""
        assert self.ref_sol_is_defined
        idx = _t_to_index(ts, self.ref_delta_t, self._u1.shape[0] - 1)
        lut1 = _TableLookup1D(self._u1[idx], self.xb, self.dx, self.device)
        lut2 = _TableLookup1D(self._u2[idx], self.xb, self.dx, self.device)
        d_1 = self.d_1

        def u_ref(x, i):
            u_a = lut1(x[:, :d_1], i) if d_1 > 0 else x[:, :0]
            u_b = lut2(x[:, d_1:], i) if d_1 < x.shape[1] else x[:, :0]
            return torch.cat([u_a, u_b], dim=-1)

        return u_ref

    def v_ref_fn(self, ts: np.ndarray):
        """The sum of the per-dimension 1-d values -log psi."""
        assert self.ref_sol_is_defined
        idx = _t_to_index(ts, self.ref_delta_t, self._psi1.shape[0] - 1)
        lut1 = _TableLookup1D(_neglog(self._psi1[idx]), self.xb, self.dx,
                              self.device)
        lut2 = _TableLookup1D(_neglog(self._psi2[idx]), self.xb, self.dx,
                              self.device)
        d_1 = self.d_1

        def v_ref(x, i):
            v = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
            if d_1 > 0:
                v = v + torch.sum(lut1(x[:, :d_1], i), dim=-1)
            if d_1 < x.shape[1]:
                v = v + torch.sum(lut2(x[:, d_1:], i), dim=-1)
            return v

        return v_ref
