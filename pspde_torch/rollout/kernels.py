"""The controlled-rollout kernel of the serve path (counterpart of
``pspde/rollout/kernels.py:fused_controlled_rollout``) and its plain
PyTorch version.

``fused_controlled_rollout`` simulates the controlled Euler-Maruyama chain

    t = n dt,  u = -Z(t, X) with Z = net([t, X]),
    X <- X + (b(X) + sigma u) dt + sigma xi sqrt(dt),
    ito += (u . xi) sqrt(dt),  riem += |u|^2 dt,  f_int += f(X_new, t) dt

for N steps and returns the final state and the three integrals.  On a
CUDA tensor it launches the hand-written kernel in
``pspde_torch/csrc/controlled_rollout.cu`` (built on first use by
``_build.py``); on a CPU tensor it runs ``reference_controlled_rollout``.
There is no fallback from CUDA to the plain version: a CUDA call either
launches the kernel or raises.

Noise is either given (``host_noise``, (N, K, d)) or drawn from a
counter-based Philox4x32-10 stream keyed by (seed, path k, step n,
dimension group j // 4), mapped to normals with the erfinv map of
``pspde``'s ``_normals_from_bits_erfinv``.  The plain version draws the
same stream (``philox_normals``), so kernel and plain version can be
compared elementwise on the card.  ``noise_sign`` multiplies every draw,
host noise included; two calls with the same seed and signs +1/-1 give
mirrored (antithetic) pairs path by path.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ansatz import TanhMLP


class ISRolloutOut(NamedTuple):
    X: torch.Tensor         # (K, d) final controlled state
    ito: torch.Tensor       # (K,) int u . dW
    riemann: torch.Tensor   # (K,) int |u|^2 dt
    f_int: torch.Tensor     # (K,) int f dt along the controlled path


# -- Philox4x32-10 in int64 tensor arithmetic ------------------------------

_M32 = 0xFFFFFFFF
_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85


def _mulhilo32(m: int, x: torch.Tensor):
    """(hi, lo) 32-bit halves of the 64-bit product m * x, for a 32-bit
    constant m and int64 x in [0, 2^32), without int64 overflow."""
    p_lo = x * (m & 0xFFFF)                # < 2^48
    p_hi = x * (m >> 16)                   # < 2^48
    s = p_lo + ((p_hi & 0xFFFF) << 16)     # < 2^49
    return (p_hi >> 16) + (s >> 32), s & _M32


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 (Salmon et al., Random123) on int64 tensors holding
    unsigned 32-bit counter words; returns the four output words."""
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W0) & _M32
            k1 = (k1 + _PHILOX_W1) & _M32
        hi0, lo0 = _mulhilo32(_PHILOX_M0, c0)
        hi1, lo1 = _mulhilo32(_PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


_SQRT2 = float(np.float32(np.sqrt(2.0)))
_CLIP = float(np.float32(1.0 - 1e-7))


def normals_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """uint32 bits (held in int64) -> standard normals, float32:
    ``(bits >> 9) | 0x3F800000`` is a float in [1, 2); subtract 1, map to
    2u - 1, clip to +-(1 - 1e-7) and return sqrt(2) erfinv."""
    u01 = (((bits >> 9) | 0x3F800000).to(torch.int32)
           .view(torch.float32) - 1.0)
    u = torch.clamp(2.0 * u01 - 1.0, -_CLIP, _CLIP)
    return _SQRT2 * torch.erfinv(u)


def philox_normals(seed: int, K: int, n: int, d: int,
                   device=None) -> torch.Tensor:
    """(K, d) float32 normals of step n: path k, dimensions 4g..4g+3 come
    from Philox4x32-10 with counter (k, n, g, 0) and key (seed mod 2^32,
    seed >> 32) - the kernel's stream, independent of its tile size."""
    G = -(-d // 4)
    k = torch.arange(K, dtype=torch.int64, device=device)[:, None]
    g = torch.arange(G, dtype=torch.int64, device=device)[None, :]
    c0 = k.expand(K, G)
    c1 = torch.full((K, G), int(n) & _M32, dtype=torch.int64, device=device)
    c2 = g.expand(K, G)
    c3 = torch.zeros((K, G), dtype=torch.int64, device=device)
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    words = philox4x32_10(c0, c1, c2, c3, seed & _M32, seed >> 32)
    bits = torch.stack(words, dim=-1).reshape(K, 4 * G)[:, :d]
    return normals_from_bits(bits)


# -- plain version ---------------------------------------------------------

def _step_constants(delta_t: float):
    return float(np.float32(delta_t)), float(np.float32(np.sqrt(delta_t)))


@torch.no_grad()
def reference_controlled_rollout(problem, z_net, K: int, N: int,
                                 delta_t: float, seed: int = 0,
                                 with_f: bool = True,
                                 host_noise: Optional[torch.Tensor] = None,
                                 noise_sign: float = 1.0) -> ISRolloutOut:
    """Plain PyTorch controlled rollout with the kernel's semantics; any
    callable ``z_net`` (tX (K, d+1) -> Z (K, d)) is accepted, u = -Z.
    Without ``host_noise`` it draws ``philox_normals(seed, K, n, d)``."""
    d = problem.d
    dev = problem.X_0.device
    sig = problem.sigma_struct
    dt, sq_dt = _step_constants(delta_t)
    X = problem.X_0.to(torch.float32).expand(K, d)
    ito = torch.zeros(K, dtype=torch.float32, device=dev)
    riem = torch.zeros_like(ito)
    fint = torch.zeros_like(ito)
    for n in range(N):
        t = float(np.float32(n) * np.float32(dt))
        if host_noise is not None:
            xi = host_noise[n]
        else:
            xi = philox_normals(seed, K, n, d, device=dev)
        if noise_sign != 1.0:
            xi = float(noise_sign) * xi
        tX = torch.cat([torch.full((K, 1), t, dtype=torch.float32,
                                   device=dev), X], dim=1)
        u = -z_net(tX)
        X = X + (problem.b(X) + sig.apply(u)) * dt + sig.apply(xi) * sq_dt
        ito = ito + torch.sum(u * xi, dim=-1) * sq_dt
        riem = riem + torch.sum(u * u, dim=-1) * dt
        if with_f:
            fint = fint + problem.running_cost(X, t) * dt
    return ISRolloutOut(X, ito, riem, fint)


# -- the CUDA kernel's front end -------------------------------------------

KERNEL_FAMILY = ("drift -x or A x; sigma scalar, diag or full (constant); "
                 "f zero or x^T P x; a TanhMLP control of input width d+1 "
                 "and output width d with at most 8 layers; noise_sign +1 "
                 "or -1")

_CHUNK = 8                 # output widths are padded to this (csrc kChunk)
_MAX_LAYERS = 8            # csrc kMaxLayers
_MAX_TILE = 128            # csrc __launch_bounds__
_SMEM_LIMIT = 232_448      # bytes of shared memory one block may use (sm_90)
_SIG_KIND = {"scalar": 0, "diag": 1, "full": 2}


def _ceil_to(n: int, m: int) -> int:
    return -(-n // m) * m


def _outside(msg: str):
    return ValueError(f"fused_controlled_rollout: {msg}; the kernel covers "
                      f"{KERNEL_FAMILY}")


def _check_family(problem, z_net, with_f, noise_sign):
    d = problem.d
    if not isinstance(z_net, TanhMLP):
        raise _outside(f"control net {type(z_net).__name__} is not a TanhMLP")
    if z_net.d_in != d + 1 or z_net.d_out != d:
        raise _outside(f"TanhMLP widths {z_net.d_in}->{z_net.d_out} do not "
                       f"match d={d} (need {d + 1}->{d})")
    if len(z_net.layers) > _MAX_LAYERS:
        raise _outside(f"TanhMLP has {len(z_net.layers)} layers")
    drift = problem.drift_family()
    if drift is None:
        raise _outside(f"drift of {type(problem).__name__} is not linear")
    cost = problem.running_cost_family() if with_f else ("zero", None)
    if cost is None:
        raise _outside(f"running cost f of {type(problem).__name__} is not "
                       "zero or quadratic")
    if float(noise_sign) not in (1.0, -1.0):
        raise _outside(f"noise_sign={noise_sign}")
    return drift, cost


class _Packed(NamedTuple):
    params: torch.Tensor   # one flat float32 buffer, staged in shared memory
    iargs: list
    fargs: list


def _pack(problem, z_net, drift, cost, K, N, delta_t, tile, host_noise,
          noise_sign) -> _Packed:
    """Lay the net (last layer negated, so the kernel's output is u = -Z),
    X_0 and the constant matrices out in one buffer, every width padded to
    _CHUNK and every section aligned to 4 floats (float4 loads).  Matrices
    are stored transposed, M^T (d, dp), so a chunk of outputs is
    contiguous.  ``tile`` None picks the tile from the shared memory the
    block needs."""
    d = problem.d
    dp = _ceil_to(d, _CHUNK)
    dev = problem.X_0.device
    parts, off = [], 0

    def add(t):
        nonlocal off
        t = t.reshape(-1).to(torch.float32)
        at = off
        parts.append(t)
        pad = _ceil_to(t.numel(), 4) - t.numel()
        if pad:
            parts.append(torch.zeros(pad, dtype=torch.float32, device=dev))
        off += t.numel() + pad
        return at

    def padded(m, rows, cols):
        out = torch.zeros((rows, cols), dtype=torch.float32, device=dev)
        out[:m.shape[0], :m.shape[1]] = m
        return out

    rows, cols, w_off, b_off = [], [], [], []
    n_layers = len(z_net.layers)
    rows_in = d + 1
    for l, lin in enumerate(z_net.layers):
        W = lin.weight.detach().to(torch.float32).T      # (in, out)
        b = lin.bias.detach().to(torch.float32)
        if l == n_layers - 1:
            W, b = -W, -b
        c = _ceil_to(W.shape[1], _CHUNK)
        w_off.append(add(padded(W, rows_in, c)))
        b_off.append(add(padded(b[None, :], 1, c)))
        rows.append(rows_in)
        cols.append(c)
        rows_in = c
    hmax = max(cols[:-1], default=0)
    x0_off = add(padded(problem.X_0.to(torch.float32)[None, :], 1, dp))

    def add_T(m):
        return add(padded(m.to(torch.float32).T, d, dp))

    drift_kind, a_off = (0, 0) if drift[0] == "neg_identity" else (
        1, add_T(drift[1]))
    sig = problem.sigma_struct
    sig_kind, sig_off, sig_scale = _SIG_KIND[sig.kind], 0, 0.0
    if sig.kind == "scalar":
        sig_scale = sig.scale
    elif sig.kind == "diag":
        sig_off = add(padded(sig.diag[None, :], 1, dp))
    else:
        sig_off = add_T(sig.mat)
    f_kind, p_off = (0, 0) if cost[0] == "zero" else (1, add_T(cost[1]))

    dense = drift_kind == 1 or sig_kind == 2
    tile = _choose_tile(off, dp * (3 if dense else 2) + 2 * hmax, tile)
    iargs = [K, N, d, dp, n_layers, hmax, tile, drift_kind, a_off, sig_kind,
             sig_off, f_kind, p_off, x0_off, off,
             int(host_noise is not None)]
    for per_layer in (rows, cols, w_off, b_off):
        iargs += per_layer + [0] * (_MAX_LAYERS - n_layers)
    dt, sq_dt = _step_constants(delta_t)
    fargs = [dt, sq_dt, float(noise_sign), sig_scale]
    return _Packed(torch.cat(parts), iargs, fargs)


def _smem_bytes(n_params: int, per_path: int, tile: int) -> int:
    """Shared memory of one block: the packed buffer plus, per path, the
    state X (and X_new when the update is dense), u and two hidden
    activation buffers, each [row][tile] - the formula of the .cu
    launcher."""
    return 4 * (n_params + per_path * tile)


def _choose_tile(n_params: int, per_path: int, tile: Optional[int]) -> int:
    if tile is not None:
        if not (0 < tile <= _MAX_TILE and tile % 32 == 0):
            raise ValueError(f"tile={tile} must be a multiple of 32 "
                             f"in [32, {_MAX_TILE}]")
        candidates = (tile,)
    else:
        candidates = (64, 32)
    for t in candidates:
        if _smem_bytes(n_params, per_path, t) <= _SMEM_LIMIT:
            return t
    need = _smem_bytes(n_params, per_path, candidates[-1])
    raise _outside(f"{need} bytes of shared memory at tile={candidates[-1]} "
                   f"exceed the {_SMEM_LIMIT}-byte limit of one block")


def _check_tensor(name, t, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} has dtype {t.dtype}, expected float32")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


@torch.no_grad()
def fused_controlled_rollout(problem, z_net, K: int, N: int, delta_t: float,
                             seed: int = 0, with_f: bool = True,
                             host_noise: Optional[torch.Tensor] = None,
                             noise_sign: float = 1.0,
                             tile: Optional[int] = None) -> ISRolloutOut:
    """Controlled rollout of K paths over N steps, u = -z_net([t, X]).

    The device is the problem's (``problem.X_0.device``): the net and
    ``host_noise`` must live there too.  CPU: the plain version.  CUDA:
    the kernel, one block per ``tile`` paths (auto: 64, or 32 when the
    shared memory demands it); ``fused_controlled_rollout.launches``
    counts its launches.  Raises ValueError outside ``KERNEL_FAMILY``."""
    drift, cost = _check_family(problem, z_net, with_f, noise_sign)
    d = problem.d
    dev = problem.X_0.device
    for name, p in z_net.named_parameters():
        _check_tensor(f"z_net.{name}", p, p.shape, dev)
    if host_noise is not None:
        _check_tensor("host_noise", host_noise, (N, K, d), dev)
    if dev.type == "cpu":
        return reference_controlled_rollout(
            problem, z_net, K, N, delta_t, seed=seed, with_f=with_f,
            host_noise=host_noise, noise_sign=noise_sign)
    if dev.type != "cuda":
        raise ValueError(f"fused_controlled_rollout: no kernel for device "
                         f"{dev}")

    from ._build import library
    lib = library()
    packed = _pack(problem, z_net, drift, cost, K, N, delta_t, tile,
                   host_noise, noise_sign)
    out = torch.empty((K, d + 3), dtype=torch.float32, device=dev)
    iargs = (ctypes.c_int * len(packed.iargs))(*packed.iargs)
    fargs = (ctypes.c_float * len(packed.fargs))(*packed.fargs)
    noise_ptr = 0 if host_noise is None else host_noise.data_ptr()
    dev_index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    err = lib.pspde_controlled_rollout(
        packed.params.data_ptr(), noise_ptr, out.data_ptr(), iargs, fargs,
        int(seed) & 0xFFFFFFFFFFFFFFFF, dev_index,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            "fused_controlled_rollout: kernel launch failed: "
            + lib.pspde_cuda_error_string(err).decode())
    fused_controlled_rollout.launches += 1
    return ISRolloutOut(out[:, :d], out[:, d], out[:, d + 1], out[:, d + 2])


fused_controlled_rollout.launches = 0
