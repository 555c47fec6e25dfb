"""Double-well metastability problems with their FD reference (counterpart
of ``pspde/problems/double_well.py``): ``DoubleWell`` (1-d),
``DoubleWell_multidim`` (a product of 1-d wells with mixed
metastabilities) and its variants ``DoubleWellGeneral`` (for
``GeneralSolver``, modus 'HJB' or 'linear'), ``DoubleWell_multidim_2``
(radial), ``DoubleWell_multidim_3`` (isotropic) and ``DoubleWell_OU`` (one
well beside an OU block); the first-exit problems ``DoubleWell_stopping``,
``DoubleWell_stopping_linear`` and ``DoubleWell_expectation_hitting_time``
(elliptic: no horizon, h(x, y, z)); and the parabolic
``Committor_DoubleWell``.

The reference solutions come from the port's own host oracles
(``problems/fd_oracles.py``), solved once per problem in float64; the
tables move to the problem's device and the lookups are gathers
(``_TableLookup1D``, ``_DoubleWellStoppingBase._lookup``), so the training
loop never leaves the device.

The product wells state their drift b(x) = -4 kappa x (x^2 - 1), kappa per
dimension, as ('double_well', kappa) (``drift_family``), which the serve
kernel covers (``rollout/kernels.py``); the training kernels do not, and
the other problems here lie outside every kernel's family: the JAX package
runs them on the scan only.
"""

from __future__ import annotations

import numpy as np
import torch

from .base import DiffusionMatrix, Geometry, Problem
from .fd_oracles import (elliptic_generator_reference,
                         parabolic_log_transform_reference)


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


class DoubleWellGeneral(DoubleWell_multidim):
    """``DoubleWell_multidim`` for the general solver: the square
    [-2.5, 2.5]^d (unbounded flavour), modus 'HJB' (h = -1/2 |z|^2,
    terminal sum eta (x - 1)^2) or 'linear' (h = 0, terminal exp(-g):
    psi itself)."""

    def __init__(self, name="Double well", d=1, d_1=1, d_2=0, T=1.0, eta=1.0,
                 kappa=1.0, modus="HJB", device=None):
        super().__init__(name=name, d=d, d_1=d_1, d_2=d_2, T=T, eta=eta,
                         kappa=kappa, device=device)
        self.modus = modus
        self.geometry = Geometry(kind="unbounded_square", X_l=-2.5, X_r=2.5)

    def h(self, t, x, y, z):
        if self.modus == "linear":
            return torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
        return -0.5 * torch.sum(z * z, dim=-1)

    def h_family(self):
        return None if self.modus == "linear" else super().h_family()

    def f_terminal(self, x):
        g = torch.sum(self.eta_ * (x - 1.0) ** 2, dim=-1)
        if self.modus == "linear":
            return torch.exp(-g)
        return g

    def v_ref_fn(self, ts: np.ndarray):
        """The product of the 1-d psi (linear modus) or the sum of the 1-d
        -log psi."""
        assert self.ref_sol_is_defined
        if self.modus != "linear":
            return super().v_ref_fn(ts)
        idx = _t_to_index(ts, self.ref_delta_t, self._psi1.shape[0] - 1)
        lut1 = _TableLookup1D(self._psi1[idx], self.xb, self.dx, self.device)
        lut2 = _TableLookup1D(self._psi2[idx], self.xb, self.dx, self.device)
        d_1 = self.d_1

        def v_ref(x, i):
            v = torch.ones(x.shape[0], dtype=x.dtype, device=x.device)
            if d_1 > 0:
                v = v * torch.prod(lut1(x[:, :d_1], i), dim=-1)
            if d_1 < x.shape[1]:
                v = v * torch.prod(lut2(x[:, d_1:], i), dim=-1)
            return v

        return v_ref


class DoubleWell_multidim_2(Problem):
    """Radial double well kappa ((|x| - 3)^2 - 1)^2, terminal cost
    alpha (|x| - 2)^2, h = -1/2 |z|^2; no reference solution."""

    h_is_y_free = True

    def __init__(self, name="Double well", d=1, T=1.0, alpha=1.0, kappa=1.0,
                 device=None):
        super().__init__(d=d, T=float(T), device=device)
        self.name = name
        self.alpha, self.kappa = float(alpha), float(kappa)
        self.B = self._t(np.eye(d))
        self._sigma = DiffusionMatrix(np.eye(d, dtype=np.float32),
                                      device=self.device)
        self.X_0 = self._t(np.ones((d,)) / np.sqrt(float(d)))

    @property
    def sigma_struct(self):
        return self._sigma

    def grad_V(self, x):
        r = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
        return 4.0 * self.kappa * (r - 3.0) * ((r - 3.0) ** 2 - 1.0) * x / r

    def b(self, x):
        return -self.grad_V(x)

    def f(self, x, t):
        return torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)

    def h(self, t, x, y, z):
        return -0.5 * torch.sum(z * z, dim=-1)

    def g(self, x):
        r = torch.sqrt(torch.sum(x * x, dim=-1))
        return self.alpha * (r - 2.0) ** 2


class DoubleWell_multidim_3(DoubleWell_multidim):
    """The isotropic product double well: every dimension carries (eta,
    kappa), i.e. ``DoubleWell_multidim`` with d_1 = d, without a
    geometry."""

    def __init__(self, name="Double well", d=1, T=1.0, eta=1.0, kappa=1.0,
                 device=None):
        super().__init__(name=name, d=d, d_1=d, d_2=0, T=T, eta=eta,
                         kappa=kappa, device=device)
        self.geometry = None


class DoubleWell_OU(Problem):
    """Dimension 0 a double well, dimensions 1..d-1 OU with rate a = 5;
    g = alpha (x_0 - 1)^2 + gamma . x_{1:}, h = -1/2 |z|^2.  The reference
    control: dimension 0 from the FD table, the OU block in closed form
    -e^{a (t - T)} gamma."""

    h_is_y_free = True

    def __init__(self, name="Double well", d=1, T=1.0, alpha=1.0, kappa=1.0,
                 device=None):
        super().__init__(d=d, T=float(T), device=device)
        self.name = name
        self.alpha, self.kappa = float(alpha), float(kappa)
        self.gamma = self._t(np.ones((d - 1,)))
        self.a = 5.0
        self.B = self._t(np.eye(d))
        self._sigma = DiffusionMatrix(np.eye(d, dtype=np.float32),
                                      device=self.device)
        self.X_0 = self._t([-1.0] + [0.0] * (d - 1))
        self.ref_sol_is_defined = False

    @property
    def sigma_struct(self):
        return self._sigma

    def b(self, x):
        dw = -4.0 * self.kappa * x[:, :1] * (x[:, :1] ** 2 - 1.0)
        return torch.cat([dw, -self.a * x[:, 1:]], dim=-1)

    def f(self, x, t):
        return torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)

    def h(self, t, x, y, z):
        return -0.5 * torch.sum(z * z, dim=-1)

    def g(self, x):
        return self.alpha * (x[:, 0] - 1.0) ** 2 + x[:, 1:] @ self.gamma

    def compute_reference_solution(self, delta_t=0.005, xb=2.5, nx=1000):
        _, psi, u, dx = parabolic_log_transform_reference(
            lambda x: self.kappa * (x ** 2 - 1.0) ** 2,
            lambda x: self.alpha * (x - 1.0) ** 2,
            self.T, delta_t=delta_t, xb=xb, nx=nx, B00=1.0)
        self.ref_delta_t, self.xb, self.dx = delta_t, xb, dx
        self._psi_np, self._u_np = psi, u
        self.ref_sol_is_defined = True

    def u_ref_fn(self, ts: np.ndarray):
        assert self.ref_sol_is_defined
        idx = _t_to_index(ts, self.ref_delta_t, self._u_np.shape[0] - 1)
        lut = _TableLookup1D(self._u_np[idx], self.xb, self.dx, self.device)
        ou_scale = self._t(-np.exp(self.a * (np.asarray(ts) - self.T)))
        gamma = self.gamma

        def u_ref(x, i):
            u0 = lut(x[:, :1], i)
            u_ou = (ou_scale[i] * gamma).expand(x[:, 1:].shape)
            return torch.cat([u0, u_ou], dim=-1)

        return u_ref


class _DoubleWellStoppingBase(Problem):
    """What the first-exit double-well problems share: the drift
    -4 beta x (x^2 - 1), sigma = eta_B I, X_0 = -1, the one-sided square
    [-2, X_r] (a path stops once it passes X_r), no horizon (h(x, y, z)),
    and the lookup of a stationary FD table at floor((x_0 + 2) / dx)."""

    def __init__(self, d=1, beta=1.0, eta_B=1.0, dx=0.01, X_r=1.0,
                 device=None):
        super().__init__(d=d, device=device)
        self.beta = float(beta)
        self.B = self._t(eta_B * np.eye(d))
        self._sigma = DiffusionMatrix(eta_B * np.eye(d, dtype=np.float32),
                                      device=self.device)
        self.X_0 = self._t(-np.ones((d,)))
        self.geometry = Geometry(kind="square", X_l=-2.0, X_r=X_r,
                                 one_boundary=True)
        self.dx_ref = float(dx)
        self.ref_sol_is_defined = False
        if d != 1:
            print("The double well example is only implemented for d = 1.")

    @property
    def sigma_struct(self):
        return self._sigma

    def grad_V_np(self, x):
        return 4.0 * self.beta * x * (x ** 2 - 1.0)

    def b(self, x):
        return -4.0 * self.beta * x * (x ** 2 - 1.0)

    def _lookup(self, table: torch.Tensor, x, clip_hi):
        idx = torch.clamp(torch.floor((x[:, 0] + 2.0) / self.dx_ref).to(
            torch.int64), 0, clip_hi)
        return table[idx]

    def _solve(self, **kw):
        _, psi, u = elliptic_generator_reference(
            self.grad_V_np, dx=self.dx_ref, **kw)
        self._psi_np, self._u_np = psi, u
        self.ref_sol_is_defined = True


class DoubleWell_stopping(_DoubleWellStoppingBase):
    """First-exit HJB: h = -1/2 |z|^2 + 1, f = 1, g = 0, exit at x = 1."""

    def __init__(self, name="Double well", d=1, beta=1.0, device=None):
        super().__init__(d=d, beta=beta, device=device)
        self.name = name

    def f(self, x, t=None):
        return torch.ones(x.shape[0], dtype=x.dtype, device=x.device)

    def g(self, x):
        return torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)

    def h(self, x, y, z):
        return -0.5 * torch.sum(z * z, dim=-1) + 1.0

    def compute_reference_solution(self):
        self._solve(sigma=1.0, f=1.0, rhs=0.0, bc_value=1.0)
        self._v_tab = self._t(_neglog(self._psi_np))
        self._u_tab = self._t(self._u_np)

    def v_ref(self, x):
        return self._lookup(self._v_tab, x, 298)

    def u_ref(self, x, t=None):
        return self._lookup(self._u_tab, x, 298)[:, None]


class DoubleWell_stopping_linear(_DoubleWellStoppingBase):
    """The linearised variant: h = -y (f y with f = 1), g = 1: psi
    itself."""

    def __init__(self, name="Double well", d=1, beta=1.0, device=None):
        super().__init__(d=d, beta=beta, device=device)
        self.name = name

    def f(self, x, t=None):
        return torch.ones(x.shape[0], dtype=x.dtype, device=x.device)

    def g(self, x):
        return torch.ones(x.shape[0], dtype=x.dtype, device=x.device)

    def h(self, x, y, z):
        return -y

    def compute_reference_solution(self):
        self._solve(sigma=1.0, f=1.0, rhs=0.0, bc_value=1.0)
        self._v_tab = self._t(self._psi_np)

    def v_ref(self, x):
        return self._lookup(self._v_tab, x, 298)


class DoubleWell_expectation_hitting_time(_DoubleWellStoppingBase):
    """The expected hitting time: (L psi) = -1 with psi = 0 at the barrier,
    h = 1, sigma = eta I."""

    def __init__(self, name="Double well", d=1, beta=1.0, dx=0.01, eta=2.0,
                 device=None):
        super().__init__(d=d, beta=beta, eta_B=eta, dx=dx, device=device)
        self.name = name

    def f(self, x, t=None):
        return torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)

    def g(self, x):
        return torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)

    def h(self, x, y, z):
        return torch.ones(y.shape[0], dtype=y.dtype, device=y.device)

    def compute_reference_solution(self):
        index_r = int((self.geometry.X_r - self.geometry.X_l) / self.dx_ref)
        self._solve(sigma=float(self.B[0, 0]), f=0.0, rhs=-1.0,
                    bc_value=0.0, bc_lo=index_r, bc_hi=int(index_r * 1.1))
        self._index_r = index_r
        self._v_tab = self._t(self._psi_np)

    def v_ref(self, x):
        return self._lookup(self._v_tab, x, self._index_r)


class Committor_DoubleWell(Problem):
    """The 1-d committor, parabolic variant: zero data on the horizon, one
    on the barrier x = 0 of the one-sided square [-2, 0], h = 0, sigma =
    sqrt(eta) I."""

    def __init__(self, name="Double well", d=1, beta=1.0, dx=0.01, eta=2.0,
                 T=1.0, device=None):
        super().__init__(d=d, T=float(T), device=device)
        self.name = name
        self.beta = float(beta)
        B = np.float32(np.sqrt(eta)) * np.eye(d, dtype=np.float32)
        self.B = self._t(B)
        self._sigma = DiffusionMatrix(B, device=self.device)
        self.X_0 = self._t(-np.ones((d,)))
        self.geometry = Geometry(kind="square", X_l=-2.0, X_r=0.0,
                                 one_boundary=True)
        self.boundary_type = "Dirichlet"

    @property
    def sigma_struct(self):
        return self._sigma

    def b(self, x):
        return -4.0 * self.beta * x * (x ** 2 - 1.0)

    def f(self, x, t=None):
        return torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)

    def g(self, x, t=None):
        return torch.ones(x.shape[0], dtype=x.dtype, device=x.device)

    def h(self, t, x, y, z):
        return torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)

    def f_terminal(self, x):
        return torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
