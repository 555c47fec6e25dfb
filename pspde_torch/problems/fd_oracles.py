"""Host-side finite-difference references (the port's own copies of
``pspde/problems/fd_oracles.py:parabolic_log_transform_reference``,
``elliptic_generator_reference`` and ``generator_spectrum_periodic_1d``).

The 1-d backward PDE for psi = e^{-v} is solved once per problem on the
host in float64 with NumPy and SciPy (implicit Euler on a symmetrised
banded generator, ``scipy.linalg.solve_banded`` each step); the problems
move the resulting tables to their device, so that the training loop's
reference lookups are gathers.  The JAX package can also run the sweep in
its native C++ library; the port keeps the SciPy sweep only.

``elliptic_generator_reference`` is the stationary solve (L - f) psi = rhs
of the first-exit double-well problems (``problems/double_well.py``): a
dense float64 system solved once with ``numpy.linalg.solve``, the JAX
package's fallback to its native solver.

``generator_spectrum_periodic_1d`` is the dense float64 spectrum of the
periodic 1-d Feynman-Kac generator, the oracle of ``eval/eigen_power.py:
eigen_subspace_refine``.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
from scipy.linalg import solve_banded


def parabolic_log_transform_reference(
    V: Callable[[np.ndarray], np.ndarray],
    g: Callable[[np.ndarray], np.ndarray],
    T: float,
    delta_t: float = 0.005,
    xb: float = 2.5,
    nx: int = 1000,
    beta: float = 2.0,
    B00: float = 1.0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, float]:
    """Solve the linear backward PDE for psi(t, x) on [-xb, xb].

    The generator is discretised in the symmetrised form A = D^{-1} L D
    with Neumann boundary conditions; the hopping rates use the potential
    at the cell centres c_i = -xb + (i + 1/2) dx and edges e_i = -xb + i dx.
    Backward implicit-Euler steps psi_n = D (I - dt A)^{-1} D^{-1}
    psi_{n+1} from psi_N = exp(-g) on the linspace grid.

    Returns (xvec, psi (N+1, nx), u (N+1, nx-1), dx) with the control table
    u = -(2/beta) B00 (log psi_i - log psi_{i+1}) / dx.
    """
    dx = 2.0 * xb / nx
    xvec = np.linspace(-xb, xb, nx, endpoint=True)
    centers = -xb + (np.arange(nx) + 0.5) * dx
    edges = -xb + np.arange(nx + 1) * dx

    Vc = V(centers)
    Ve = V(edges)

    # the symmetric tridiagonal hopping matrix, rows scaled by 1/dx^2
    off = -np.exp(beta * 0.5 * (Vc[:-1] + Vc[1:] - 2.0 * Ve[1:-1])) / dx ** 2
    diag = np.zeros(nx)
    diag[1:] += np.exp(beta * (Vc[1:] - Ve[1:-1])) / dx ** 2
    diag[:-1] += np.exp(beta * (Vc[:-1] - Ve[1:-1])) / dx ** 2
    # A = -A_hops / beta
    off = -off / beta
    diag = -diag / beta

    N = int(T / delta_t)
    Dv = np.exp(beta * V(xvec) / 2.0)
    Dv_inv = np.exp(-beta * V(xvec) / 2.0)

    # banded form of (I - dt A): ab[0] upper, ab[1] main, ab[2] lower
    ab = np.zeros((3, nx))
    ab[0, 1:] = -delta_t * off
    ab[1, :] = 1.0 - delta_t * diag
    ab[2, :-1] = -delta_t * off
    psi = np.zeros((N + 1, nx))
    psi[N] = np.exp(-g(xvec))
    for n in range(N - 1, -1, -1):
        psi[n] = Dv * solve_banded((1, 1), ab, Dv_inv * psi[n + 1])

    logpsi = np.log(np.maximum(psi, 1e-300))
    u = -(2.0 / beta) * B00 * (logpsi[:, :-1] - logpsi[:, 1:]) / dx
    return xvec, psi, u, dx


def elliptic_generator_reference(
    grad_V: Callable[[np.ndarray], np.ndarray],
    sigma: float,
    f: float,
    rhs: float,
    bc_value: float,
    bc_lo: int = 300,
    bc_hi: int = 310,
    xr: Tuple[float, float] = (-2.0, 2.0),
    dx: float = 0.01,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Stationary solve (L - f) psi = rhs with pinned interior boundary rows.

    The generator L = (sigma^2/2) d_xx - grad_V(x) d_x on the linspace grid
    of [xr[0], xr[1]] with step ~dx, its first-order terms upwinded; rows
    ``bc_lo:bc_hi`` pinned to ``bc_value``, and flat-psi Neumann rows at
    both ends.  Returns (x_val, psi, u) with the control table
    u = sigma (log psi_{i+1} - log psi_i) / dx.
    """
    Nx = int(np.ceil((xr[1] - xr[0]) / dx))
    x_val = np.linspace(xr[0], xr[1], Nx)

    L = np.zeros((Nx, Nx))
    gv = grad_V(x_val)
    L[0, 0] = -2 * sigma ** 2 / 2 / dx ** 2 - gv[0] / dx - f
    L[0, 1] = sigma ** 2 / dx
    L[Nx - 1, Nx - 2] = sigma ** 2 / 2 / dx ** 2 + gv[Nx - 1] / dx
    L[Nx - 1, Nx - 1] = -sigma ** 2 / dx ** 2 - sigma * gv[Nx - 1] / dx - f
    i = np.arange(1, Nx - 1)
    L[i, i - 1] = sigma ** 2 / 2 / dx ** 2 + gv[i] / dx
    L[i, i] = -sigma ** 2 / dx ** 2 - gv[i] / dx - f
    L[i, i + 1] = sigma ** 2 / 2 / dx ** 2

    d = np.full(Nx, rhs)

    L[bc_lo:bc_hi, :] = 0.0
    L[np.arange(bc_lo, bc_hi), np.arange(bc_lo, bc_hi)] = 1.0
    d[bc_lo:bc_hi] = bc_value

    L[0, :] = 0.0
    L[0, 0], L[0, 1] = 1.0, -1.0
    d[0] = 0.0
    L[Nx - 1, :] = 0.0
    L[Nx - 1, Nx - 1], L[Nx - 1, Nx - 2] = 1.0, -1.0
    d[Nx - 1] = 0.0

    psi = np.linalg.solve(L, d)
    with np.errstate(divide="ignore", invalid="ignore"):
        u = sigma * (np.log(psi[1:]) - np.log(psi[:-1])) / dx
    return x_val, psi, u


def generator_spectrum_periodic_1d(
    b: Callable[[np.ndarray], np.ndarray],
    W: Callable[[np.ndarray], np.ndarray],
    n: int = 512,
    X_l: float = 0.0,
    X_r: float = 2.0 * np.pi,
    half_sigma2: float = 1.0,
    k: int = 4,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Top-``k`` spectrum of A f = half_sigma2 f'' + b f' + W f, periodic.

    Dense central-difference discretization on a periodic 1-d grid of n
    points, eigendecomposed with numpy.  Returns ``(x, lam, vecs)`` where
    ``A vecs[:, j] = -lam[j] vecs[:, j]`` and ``lam`` is sorted ascending
    (``lam[0]`` the Perron-Frobenius eigenvalue of the semigroup,
    ``lam[1] - lam[0]`` the spectral gap); the eigenvectors have unit
    grid-RMS, the dominant one positive.
    """
    x = np.linspace(X_l, X_r, n, endpoint=False)
    dx = (X_r - X_l) / n
    bv = np.asarray(b(x), dtype=np.float64)
    Wv = np.asarray(W(x), dtype=np.float64)
    A = np.zeros((n, n))
    i = np.arange(n)
    up, dn = (i + 1) % n, (i - 1) % n
    A[i, i] = -2.0 * half_sigma2 / dx ** 2 + Wv
    A[i, up] += half_sigma2 / dx ** 2 + bv / (2.0 * dx)
    A[i, dn] += half_sigma2 / dx ** 2 - bv / (2.0 * dx)
    w, V = np.linalg.eig(A)
    order = np.argsort(-w.real)[:k]
    lam = -w.real[order]
    vecs = V[:, order].real
    vecs /= np.sqrt(np.mean(vecs ** 2, axis=0, keepdims=True))
    if vecs[np.argmax(np.abs(vecs[:, 0])), 0] < 0:
        vecs[:, 0] *= -1.0
    return x, lam, vecs
