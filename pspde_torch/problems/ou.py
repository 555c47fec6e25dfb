"""Ornstein-Uhlenbeck / linear-quadratic control problems (counterpart of
``pspde/problems/ou.py``): ``LLGC``, ``LLGC_general_f`` (a control cost
that is not quadratic) and ``LQGC``.

The closed forms (matrix exponentials, the Riccati recursion) are computed
on the host with numpy/scipy exactly as in the JAX package and then moved
to the problem's device as tables; the hot paths index the tables.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.linalg import expm

from .base import DiffusionMatrix, Geometry, Problem


def _randn(rng: np.random.Generator, *shape):
    return rng.standard_normal(shape).astype(np.float32)


class LLGC(Problem):
    """OU process with linear terminal cost g(x) = alpha^T x.

    dX = A X dt + B dW,  f = 0,  h(t,x,y,z) = h_sign * 1/2 |z|^2.
    """

    h_is_y_free = True

    def __init__(self, name="LLGC", d=1, off_diag=0.0, T=5.0, seed=42,
                 h_sign=-1.0, device=None):
        super().__init__(d=d, T=float(T), device=device)
        self.name = name
        rng = np.random.default_rng(seed)
        A = -np.eye(d, dtype=np.float32) + off_diag * _randn(rng, d, d)
        B = np.eye(d, dtype=np.float32) + off_diag * _randn(rng, d, d)
        self._A_np, self._B_np = A.astype(np.float64), B.astype(np.float64)
        self.A = self._t(A)
        self.B = self._t(B)
        self.alpha = torch.ones((d,), dtype=torch.float32, device=self.device)
        self.h_sign = float(h_sign)
        self.geometry = Geometry(kind="square", X_l=-2.0, X_r=2.0)
        self._sigma = DiffusionMatrix(B, device=self.device)
        # A = -I when off_diag == 0: elementwise drift instead of a matmul
        self._A_is_neg_identity = (off_diag == 0.0)
        if not np.all(np.linalg.eigvals(self._A_np).real < 0):
            print("not all EV of A are negative")

    @property
    def sigma_struct(self):
        return self._sigma

    def b(self, x):
        if self._A_is_neg_identity:
            return -x
        return x @ self.A.T

    def f(self, x, t):
        return torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)

    def h(self, t, x, y, z):
        return self.h_sign * 0.5 * torch.sum(z * z, dim=-1)

    def g(self, x):
        return x @ self.alpha

    def drift_family(self):
        if self._A_is_neg_identity:
            return ("neg_identity", None)
        return ("matrix", self.A)

    def running_cost_family(self):
        return ("zero", None)

    def h_family(self):
        return ("quadratic_z", self.h_sign, 0.0)

    # -- reference solution ------------------------------------------------
    def _expm_AT(self, tau: float) -> np.ndarray:
        return expm(self._A_np.T * tau)

    def u_ref_table(self, ts: np.ndarray) -> torch.Tensor:
        """(len(ts), d) table of the state-independent optimal control
        u*(x, t) = -B^T e^{A^T (T - t)} alpha."""
        alpha = np.ones((self.d,), dtype=np.float64)
        if self._A_is_neg_identity:
            # e^{-I tau} alpha = e^{-tau} alpha without a d x d exponential
            # a time (12 s at d=1000, N=200; the same float32 table)
            tab = np.stack([-self._B_np.T @ (np.exp(-(self.T - t)) * alpha)
                            for t in np.asarray(ts)])
        else:
            tab = np.stack([-self._B_np.T @ self._expm_AT(self.T - t)
                            @ alpha for t in np.asarray(ts)])
        return self._t(tab)

    def u_ref_fn(self, ts: np.ndarray):
        tab = self.u_ref_table(ts)

        def u_ref(x, i):
            return tab[i].expand(x.shape)

        return u_ref

    def _Sigma_int(self, t: float, quad_dt: float = 1e-3) -> np.ndarray:
        """Sigma(t) = int_t^T e^{A(T-s)} B B^T e^{A^T(T-s)} ds."""
        N = int(np.floor((self.T - t) / quad_dt)) + 1
        S = np.zeros((self.d, self.d))
        for s in np.linspace(t, self.T, N):
            E = expm(self._A_np * (self.T - s))
            S += E @ self._B_np @ self._B_np.T @ E.T * quad_dt
        return S

    def v_ref(self, x, t: float):
        """v(x,t) = alpha^T e^{A(T-t)} x - 1/2 alpha^T Sigma(t) alpha."""
        alpha = np.ones((self.d,), dtype=np.float64)
        lin = self._t(self._expm_AT(self.T - t) @ alpha)
        const = float(0.5 * alpha @ self._Sigma_int(t) @ alpha)
        return x @ lin - const

    def v_ref_fn(self, ts: np.ndarray):
        alpha = np.ones((self.d,), dtype=np.float64)
        lins = self._t(np.stack([self._expm_AT(self.T - t) @ alpha
                                 for t in ts]))
        consts = self._t(np.array([0.5 * alpha @ self._Sigma_int(t) @ alpha
                                   for t in ts]))

        def v_ref(x, i):
            return x @ lins[i] - consts[i]

        return v_ref


class LLGC_general_f(Problem):
    """Brownian motion (A = 0) with a control cost that is not quadratic:
    h(t, x, y, z) = -(0.8 ((-z)^2)^0.625 + x e^{T-t}
    - 0.8 e^{1.25 (T-t)})[:, 0], g(x) = -sum x; the reference control
    -B^T e^{B^T (T - t)} alpha is state-independent."""

    h_is_y_free = True

    def __init__(self, name="LLGC", d=1, off_diag=0.0, T=5.0, seed=42,
                 device=None):
        super().__init__(d=d, T=float(T), device=device)
        self.name = name
        rng = np.random.default_rng(seed)
        self.A = self._t(np.zeros((d, d)))
        B = np.eye(d, dtype=np.float32) + off_diag * _randn(rng, d, d)
        self._B_np = B.astype(np.float64)
        self.B = self._t(B)
        self.alpha = -torch.ones((d,), dtype=torch.float32,
                                 device=self.device)
        self._sigma = DiffusionMatrix(B, device=self.device)

    @property
    def sigma_struct(self):
        return self._sigma

    def b(self, x):
        return torch.zeros_like(x)

    def f(self, x, t):
        return torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)

    def h(self, t, x, y, z):
        tau = torch.as_tensor(self.T - t, dtype=x.dtype, device=x.device)
        return -(0.8 * ((-z) ** 2) ** 0.625 + x * torch.exp(tau)
                 - 0.8 * torch.exp(1.25 * tau))[:, 0]

    def g(self, x):
        return x @ self.alpha

    def u_ref_fn(self, ts: np.ndarray):
        alpha = -np.ones((self.d,), dtype=np.float64)
        tab = self._t(np.stack([-self._B_np.T @ expm(self._B_np.T
                                                     * (self.T - t)) @ alpha
                                for t in np.asarray(ts)]))

        def u_ref(x, i):
            return tab[i].expand(x.shape)

        return u_ref


class LQGC(Problem):
    """Linear-quadratic Gaussian control.

    f(x) = x^T P x, g(x) = x^T R x, h = -1/2 |z|^2 - f.  Reference solution
    from the time-discretized Riccati recursion on the problem's own
    ``delta_t`` grid; ``v_ref`` keeps the JAX package's sign fix
    (``x^T F_n x + G_n``).
    """

    h_is_y_free = True

    def __init__(self, name="LQGC", delta_t=0.05, d=1, off_diag=0.0, T=5.0,
                 seed=42, device=None):
        super().__init__(d=d, T=float(T), device=device)
        self.name = name
        rng = np.random.default_rng(seed)
        A = -np.eye(d) + off_diag * _randn(rng, d, d).astype(np.float64)
        B = np.eye(d) + off_diag * _randn(rng, d, d).astype(np.float64)
        self._A_np, self._B_np = A, B
        self.A = self._t(A)
        self.B = self._t(B)
        self.delta_t = float(delta_t)
        self.N = int(np.floor(self.T / self.delta_t))
        P = 0.5 * np.eye(d)
        Q = 0.5 * np.eye(d)
        R = np.eye(d)
        self.P = self._t(P)
        self.Q = self._t(Q)
        self.R = self._t(R)
        # Riccati recursion, backward Euler
        F = np.zeros((self.N + 1, d, d))
        F[self.N] = R
        Qinv = np.linalg.inv(Q)
        for n in range(self.N, 0, -1):
            F[n - 1] = F[n] + (A.T @ F[n] + F[n] @ A
                               - F[n] @ B @ Qinv @ B.T @ F[n]
                               + P) * self.delta_t
        G = np.zeros(self.N + 1)
        for n in range(self.N, 0, -1):
            G[n - 1] = G[n] + np.trace(B @ B.T @ F[n]) * self.delta_t
        self._F_np, self._G_np = F, G
        self.F = self._t(F)
        self.G = self._t(G)
        self._sigma = DiffusionMatrix(B, device=self.device)

    @property
    def sigma_struct(self):
        return self._sigma

    def b(self, x):
        return x @ self.A.T

    def f(self, x, t):
        return torch.einsum("kd,de,ke->k", x, self.P, x)

    def g(self, x):
        return torch.einsum("kd,de,ke->k", x, self.R, x)

    def h(self, t, x, y, z):
        return -0.5 * torch.sum(z * z, dim=-1) - self.f(x, t)

    def drift_family(self):
        return ("matrix", self.A)

    def running_cost_family(self):
        return ("quadratic", self.P)

    def h_family(self):
        return ("quadratic_z", -1.0, -1.0)

    def u_ref_fn(self, ts: np.ndarray):
        """u*(x, t) = -Q^{-1} B^T F_n x with n = ceil(t/dt)."""
        idx = np.minimum(np.ceil(np.asarray(ts) / self.delta_t).astype(int),
                         self.N)
        Qinv = np.linalg.inv(self.Q.cpu().numpy().astype(np.float64))
        gains = self._t(np.stack([-Qinv @ self._B_np.T @ self._F_np[n]
                                  for n in idx]))

        def u_ref(x, i):
            return x @ gains[i].T

        return u_ref

    def v_ref_fn(self, ts: np.ndarray):
        idx = np.minimum(np.ceil(np.asarray(ts) / self.delta_t).astype(int),
                         self.N)
        Fs = self._t(self._F_np[idx])
        Gs = self._t(self._G_np[idx])

        def v_ref(x, i):
            return torch.einsum("kd,de,ke->k", x, Fs[i], x) + Gs[i]

        return v_ref
