"""The port's rollout kernels and their plain PyTorch versions
(counterparts of ``pspde/rollout/kernels.py``): the controlled rollout of
the serve path (``fused_controlled_rollout``), the HJB training rollout
(``fused_train_rollout``) and the stopped-path training rollout
(``fused_stopped_train_rollout``).

``fused_controlled_rollout`` simulates the controlled Euler-Maruyama chain

    t = n dt,  u = -Z(t, X) with Z = net([t, X]),
    X <- X + (b(X) + sigma u) dt + sigma xi sqrt(dt),
    ito += (u . xi) sqrt(dt),  riem += |u|^2 dt,  f_int += f(X_new, t) dt

for N steps and returns the final state and the three integrals, for a
drift b(X) = -X, A X or the double well's -4 kappa X (X^2 - 1)
(``KERNEL_FAMILY``; the training kernels take the first two).  On a
CUDA tensor it launches the hand-written kernel in
``pspde_torch/csrc/controlled_rollout.cu`` (built on first use by
``_build.py``); on a CPU tensor it runs ``reference_controlled_rollout``.
There is no fallback from CUDA to the plain version: a CUDA call either
launches the kernel or raises.  The serve and HJB training kernels have
two memory plans (``_choose_plan``): the net staged in each block's shared
memory beside its paths' arrays where that fits, else read from device
memory with the arrays in a [row][K] workspace (d=1000).  The stopped
backward has two too (``_stopped_bwd_plan``): one thread a path with its
arrays in shared memory where a tile fits, else lanes of several threads a
path whose arrays sit in shared memory or in a [row][grid x tile]
workspace (``_stopped_bwd_lane_layout``; the Allen-Cahn notebook's net at
d=100).

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
from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from ..ansatz import ConcatSkipNet, TanhMLP
from ..problems.eigen import schrodinger_pot
from .sampling import inside_fn
from .sde import (HJBRolloutConfig, LambdaShiftedProblem,
                  StoppedRolloutConfig, hjb_rollout, step_constants,
                  step_time, stopped_rollout, value_and_z)


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


_BINOM_SCALE = float(np.float32(1.0 / np.sqrt(8.0 + 1.0 / 12.0)))


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word held in int64 (SWAR popcount)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & _M32) >> 24


def normals_from_bits_binom(b1: torch.Tensor,
                            b2: torch.Tensor) -> torch.Tensor:
    """Moment-matched cheap normals of two uint32 words (in int64):
    z = (popcount(b1) - 16 + (b2 & 0x7FFF) 2^-15 - 1/2) / sqrt(8 + 1/12),
    with pspde's float32 operation order, so the kernel's values agree
    bitwise.  Mean, variance and skewness are exact; |z| <= 5.8."""
    pc = (popcount32(b1) - 16).to(torch.float32)
    u = (b2 & 0x7FFF).to(torch.float32) * (2.0 ** -15)
    return ((pc + u) - 0.5) * _BINOM_SCALE


def philox_bits(seed: int, K: int, n: int, d: int, c3: int = 0,
                device=None) -> torch.Tensor:
    """(K, d) uint32 words (in int64) of step n: path k, dimensions
    4g..4g+3 are the four words of Philox4x32-10 at counter (k, n, g, c3)
    with key (seed mod 2^32, seed >> 32) - the kernels' stream,
    independent of their tile size."""
    G = -(-d // 4)
    k = torch.arange(K, dtype=torch.int64, device=device)[:, None]
    g = torch.arange(G, dtype=torch.int64, device=device)[None, :]
    c0 = k.expand(K, G)
    c1 = torch.full((K, G), int(n) & _M32, dtype=torch.int64, device=device)
    c2 = g.expand(K, G)
    c3 = torch.full((K, G), int(c3) & _M32, dtype=torch.int64, device=device)
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    words = philox4x32_10(c0, c1, c2, c3, seed & _M32, seed >> 32)
    return torch.stack(words, dim=-1).reshape(K, 4 * G)[:, :d]


def philox_normals(seed: int, K: int, n: int, d: int,
                   device=None) -> torch.Tensor:
    """(K, d) float32 normals of step n: the erfinv map of the words at
    counter (k, n, g, 0)."""
    return normals_from_bits(philox_bits(seed, K, n, d, 0, device))


RNG_MAPS = ("erfinv", "binom")


def train_normals(seed: int, K: int, n: int, d: int, rng: str = "binom",
                  device=None) -> torch.Tensor:
    """(K, d) normals of step n of the training kernels: 'erfinv' is
    ``philox_normals``; 'binom' maps b1 from counter (k, n, g, 0) and b2
    from (k, n, g, 1) through ``normals_from_bits_binom``."""
    if rng == "erfinv":
        return philox_normals(seed, K, n, d, device)
    if rng == "binom":
        return normals_from_bits_binom(philox_bits(seed, K, n, d, 0, device),
                                       philox_bits(seed, K, n, d, 1, device))
    raise ValueError(f"rng={rng!r} must be one of {RNG_MAPS}")


# -- plain version ---------------------------------------------------------

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
    dt, sq_dt = step_constants(delta_t)
    X = problem.X_0.to(torch.float32).expand(K, d)
    ito = torch.zeros(K, dtype=torch.float32, device=dev)
    riem = torch.zeros_like(ito)
    fint = torch.zeros_like(ito)
    for n in range(N):
        t = step_time(n, dt)
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

_FAMILY_NET = ("a TanhMLP control of input width d+1 and output width d "
               "with at most 8 layers; noise_sign +1 or -1")
KERNEL_FAMILY = ("drift -x or A x with sigma scalar, diag or full (constant) "
                 "and f zero or x^T P x, or the double well's drift "
                 "-4 kappa x (x^2 - 1) with sigma scalar and f zero; "
                 + _FAMILY_NET)

_CHUNK = 8                 # output widths are padded to this (csrc kChunk)
_MAX_LAYERS = 8            # csrc kMaxLayers
_MAX_TILE = 128            # csrc kMaxTile
_FWD_THREADS = 256         # csrc kFwdThreads: the training forward's block
# threads per path of the training forward, per memory plan: the fastest
# on an H100 at the bench shape (shared) and at config 5 (device), by
# experiments/torch_kernel_times.py --layouts
_FWD_TPP = {"shared": 4, "device": 2}
_SUM_CLASSES = 4           # csrc kSumClasses: the forward's classes of sums
# the blocks below which the serve kernel takes 4 threads a path in both
# plans, where the card would otherwise idle: 4 blocks of 64 x 2 threads
# (the register cap of 128 a thread) on each of an H100's 132 SMs.  By
# experiments/torch_kernel_times.py --layouts serve (d=1000: K=8192 64 x 4
# 65.9 ms against 64 x 2 111.0; K=65536 64 x 2 278.5 against 64 x 4 304.8)
_SERVE_SPREAD = 4 * 132
_SMEM_LIMIT = 232_448      # bytes of shared memory one block may use (sm_90)
_SIG_KIND = {"scalar": 0, "diag": 1, "full": 2}
# where a block keeps the net and its paths' arrays (csrc/train_step.cuh)
PLANS = ("shared", "device")


def _ceil_to(n: int, m: int) -> int:
    return -(-n // m) * m


def _outside(msg: str):
    return ValueError(f"fused_controlled_rollout: {msg}; the kernel covers "
                      f"{KERNEL_FAMILY}")


def _check_family(problem, z_net, with_f, noise_sign, outside=_outside,
                  double_well=True):
    """(drift, cost) of a problem and net inside the serve kernel's family,
    or ``outside``'s ValueError; ``double_well`` False (the training
    kernels) refuses the double well's drift."""
    d = problem.d
    if not isinstance(z_net, TanhMLP):
        raise outside(f"control net {type(z_net).__name__} is not a TanhMLP")
    if z_net.d_in != d + 1 or z_net.d_out != d:
        raise outside(f"TanhMLP widths {z_net.d_in}->{z_net.d_out} do not "
                      f"match d={d} (need {d + 1}->{d})")
    if len(z_net.layers) > _MAX_LAYERS:
        raise outside(f"TanhMLP has {len(z_net.layers)} layers")
    drift = problem.drift_family()
    name = type(problem).__name__
    kinds = ("neg_identity", "matrix") + (("double_well",) if double_well
                                          else ())
    if drift is None or drift[0] not in kinds:
        raise outside(f"drift of {name} is not -x or A x"
                      + (" or the double well's" if double_well else
                         " (the double well's drift runs in the serve "
                         "kernel only)"))
    cost = problem.running_cost_family() if with_f else ("zero", None)
    if cost is None:
        raise outside(f"running cost f of {name} is not zero or quadratic")
    if drift[0] == "double_well":
        if problem.sigma_struct.kind != "scalar" or cost[0] != "zero":
            raise outside(f"the double well's drift of {name} needs sigma "
                          "scalar and f zero")
    if float(noise_sign) not in (1.0, -1.0):
        raise outside(f"noise_sign={noise_sign}")
    return drift, cost


class _Packed(NamedTuple):
    params: torch.Tensor   # one flat float32 buffer, staged in shared memory
                           # in the shared plan
    iargs: list
    fargs: list
    ws_floats: int = 0     # the device plan's workspace; 0: shared plan
    layout: tuple = ()     # the stopped forward's _FwdLayout


class _Layout(NamedTuple):
    buf: torch.Tensor      # the flat float32 buffer
    n_layers: int
    rows: list             # per layer: input rows (layer 0: d + 1)
    cols: list             # per layer: output width padded to _CHUNK
    w_off: list            # per layer: offset of W (rows, cols)
    b_off: list            # per layer: offset of b (cols,)
    x0_off: int            # X_0 padded to dp; the staged prefix ends here
    drift_kind: int
    a_off: int
    sig_kind: int
    sig_off: int
    sig_scale: float
    f_kind: int
    p_off: int
    u_off: int             # (N, dp) reference-control table, or 0


def _layout(problem, z_net, drift, cost,
            u_tab: Optional[torch.Tensor] = None) -> _Layout:
    """Lay the net, X_0, the constant matrices and the u_tab table out in
    one buffer, every width padded to _CHUNK and every section aligned to
    4 floats (float4 loads).  Weights are stored (in, out), matrices
    transposed, M^T (d, dp), so a chunk of outputs is contiguous.  The net
    and X_0 come first: the training kernels stage only that prefix in
    shared memory and read the rest from device memory."""
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
        c = _ceil_to(W.shape[1], _CHUNK)
        w_off.append(add(padded(W, rows_in, c)))
        b_off.append(add(padded(b[None, :], 1, c)))
        rows.append(rows_in)
        cols.append(c)
        rows_in = c
    x0_off = add(padded(problem.X_0.to(torch.float32)[None, :], 1, dp))

    def add_T(m):
        return add(padded(m.to(torch.float32).T, d, dp))

    if drift[0] == "neg_identity":
        drift_kind, a_off = 0, 0
    elif drift[0] == "double_well":
        # 4 kappa, exact in float32 as the plain version's 4.0 * kappa
        drift_kind = 2
        a_off = add(padded(4.0 * drift[1].to(torch.float32)[None, :], 1, dp))
    else:
        drift_kind, a_off = 1, add_T(drift[1])
    sig = problem.sigma_struct
    sig_kind, sig_off, sig_scale = _SIG_KIND[sig.kind], 0, 0.0
    if sig.kind == "scalar":
        sig_scale = sig.scale
    elif sig.kind == "diag":
        sig_off = add(padded(sig.diag[None, :], 1, dp))
    else:
        sig_off = add_T(sig.mat)
    f_kind, p_off = (0, 0) if cost[0] == "zero" else (1, add_T(cost[1]))
    u_off = 0 if u_tab is None else add(padded(u_tab, u_tab.shape[0], dp))
    return _Layout(torch.cat(parts), n_layers, rows, cols, w_off, b_off,
                   x0_off, drift_kind, a_off, sig_kind, sig_off,
                   sig_scale, f_kind, p_off, u_off)


def _pack(problem, z_net, drift, cost, K, N, delta_t, tile, host_noise,
          noise_sign, plan=None, tpp=None) -> _Packed:
    """The serve kernel's arguments (train_step.cuh: TrainArgs): the serve
    kernel runs the HJB training forward's step, so these are the
    forward's (``_pack_train``) with the serve's flags: the adaptive update
    (its control c = -Z is the serve's u), the erfinv map, no u_tab, f
    where the cost has one (c_h 0 and f_coef 1: the serve reads f unscaled
    and no h), and the serve's threads per path (``_serve_tpp``; ``tpp``
    forces them)."""
    return _pack_train(problem, z_net, drift, cost, ("quadratic_z", 0.0, 1.0),
                       K, N, delta_t, tile, backward=False,
                       host_noise=host_noise, noise_sign=noise_sign,
                       adaptive_forward=True, accumulate_kl=False,
                       kl_ito_term=False, u_tab=None, rng="erfinv",
                       plan=plan, serve=True, tpp=tpp)


def _per_layer_args(lay: _Layout) -> list:
    out = []
    for per_layer in (lay.rows, lay.cols, lay.w_off, lay.b_off):
        out += per_layer + [0] * (_MAX_LAYERS - lay.n_layers)
    return out


def _choose_plan(smem_bytes, per_path: int, K: int, tile: Optional[int],
                 plan: Optional[str], outside=_outside):
    """(tile, plan, ws_stride) of a launch.

    The shared plan stages the packed net in shared memory beside each
    path's arrays: ``tile``, or the largest of 64 and 32 whose block fits,
    ``smem_bytes(tile)`` bytes.  Where no tile fits (or ``plan='device'``),
    the device plan reads the net from device memory and keeps each path's
    ``per_path`` floats in a [row][ws_stride] workspace, ws_stride = K
    rounded up to the tile (64 unless given); its indices are 32-bit, so
    ``per_path * ws_stride`` must stay below 2^31.  ``plan='shared'`` where
    no tile fits, or a workspace past that, raises ``outside``'s
    ValueError."""
    _check_plan(plan)
    if tile is not None and not (0 < tile <= _MAX_TILE and tile % 32 == 0):
        raise ValueError(f"tile={tile} must be a multiple of 32 "
                         f"in [32, {_MAX_TILE}]")
    if plan != "device":
        candidates = (tile,) if tile is not None else (64, 32)
        for t in candidates:
            if smem_bytes(t) <= _SMEM_LIMIT:
                return t, "shared", 0
        if plan == "shared":
            raise outside(f"{smem_bytes(candidates[-1])} bytes of shared "
                          f"memory at tile={candidates[-1]} exceed the "
                          f"{_SMEM_LIMIT}-byte limit of one block "
                          "(plan='shared')")
    t = 64 if tile is None else tile
    stride = _ceil_to(K, t)
    if per_path * stride >= 2 ** 31:
        raise outside(f"the device plan's workspace of {per_path} x {stride}"
                      " floats exceeds the kernels' 32-bit indices")
    return t, "device", stride


def _check_plan(plan):
    if plan not in (None,) + PLANS:
        raise ValueError(f"plan={plan!r} must be None or one of {PLANS}")


def _workspace(packed: _Packed, dev) -> Optional[torch.Tensor]:
    """The device plan's per-path workspace, or None (shared plan)."""
    if not packed.ws_floats:
        return None
    return torch.empty(packed.ws_floats, dtype=torch.float32, device=dev)


def _plan_of(packed: _Packed) -> str:
    return PLANS[packed.iargs[-2]]


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


Seed = Union[int, torch.Tensor]

_M64 = 0xFFFFFFFFFFFFFFFF
# the C entries that read their seed from a device word (the training
# kernels); the serve kernel takes it by value
_DEVICE_SEED_ENTRIES = ("pspde_train_rollout_fwd", "pspde_train_rollout_bwd",
                        "pspde_stopped_rollout_fwd",
                        "pspde_stopped_rollout_fwd_block",
                        "pspde_stopped_rollout_bwd")


def device_seed(seed: Seed, dev: torch.device) -> torch.Tensor:
    """The training kernels' seed as they read it: a 0-d int64 tensor on
    ``dev`` whose 64 bits are seed mod 2^64 (the Philox key (low word, high
    word)).  A tensor is checked and returned as it is, so that a caller
    (a captured CUDA graph's step) can write a new seed into it before each
    run; an int is written into a new one."""
    if torch.is_tensor(seed):
        if seed.dtype != torch.int64 or seed.dim() != 0:
            raise ValueError(f"seed has dtype {seed.dtype} and shape "
                             f"{tuple(seed.shape)}, expected a 0-d int64 "
                             "tensor")
        if seed.device != torch.device(dev):
            raise ValueError(f"seed is on {seed.device}, expected {dev}")
        return seed
    s = int(seed) & _M64
    return torch.full((), s - (1 << 64) if s >> 63 else s, dtype=torch.int64,
                      device=dev)


def host_seed(seed: Seed) -> int:
    """The seed as the plain versions take it: an int (a tensor's value,
    read back to the host)."""
    return int(seed.item()) if torch.is_tensor(seed) else int(seed)


def _launch(fn_name: str, who: str, packed: _Packed, tensors, seed: Seed,
            dev: torch.device):
    """Call the library's C entry ``fn_name`` with the tensors' pointers
    (None -> null), the packed arguments, the seed, the device and its
    current stream; raise if the launch is refused.  The training entries
    (``_DEVICE_SEED_ENTRIES``) take the pointer of the seed's device word
    (``device_seed``), the serve its value, and then the pointer of their
    launch count's device word (``_count_word``)."""
    from ._build import library
    lib = library()
    iargs = (ctypes.c_int * len(packed.iargs))(*packed.iargs)
    fargs = (ctypes.c_float * len(packed.fargs))(*packed.fargs)
    ptrs = [0 if t is None else t.data_ptr() for t in tensors]
    dev_index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    if fn_name in _DEVICE_SEED_ENTRIES:
        # kept referenced until the launch is queued; a temporary's memory
        # is reused only by later work on the same stream
        seed_word = device_seed(seed, dev)
        seed_args = (seed_word.data_ptr(), _count_word(fn_name, packed, dev))
    else:
        seed_args = (int(seed) & _M64,)
    err = getattr(lib, fn_name)(
        *ptrs, iargs, fargs, *seed_args, dev_index,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{who}: kernel launch failed: "
                           + lib.pspde_cuda_error_string(err).decode())


@torch.no_grad()
def fused_controlled_rollout(problem, z_net, K: int, N: int, delta_t: float,
                             seed: int = 0, with_f: bool = True,
                             host_noise: Optional[torch.Tensor] = None,
                             noise_sign: float = 1.0,
                             tile: Optional[int] = None,
                             plan: Optional[str] = None) -> ISRolloutOut:
    """Controlled rollout of K paths over N steps, u = -z_net([t, X]).

    The device is the problem's (``problem.X_0.device``): the net and
    ``host_noise`` must live there too.  CPU: the plain version.  CUDA:
    the kernel, one block of ``tile`` x threads-per-path threads per
    ``tile`` paths (auto: 64, or 32 when the shared memory demands it;
    threads per path ``_serve_tpp``), in the shared plan where a block
    fits and else the device plan (``plan`` forces one: ``_choose_plan``);
    ``fused_controlled_rollout.launches`` counts its launches and
    ``.launches_by_plan`` them per plan.  Raises ValueError outside
    ``KERNEL_FAMILY``."""
    drift, cost = _check_family(problem, z_net, with_f, noise_sign)
    d = problem.d
    dev = problem.X_0.device
    for name, p in z_net.named_parameters():
        _check_tensor(f"z_net.{name}", p, p.shape, dev)
    if host_noise is not None:
        _check_tensor("host_noise", host_noise, (N, K, d), dev)
    _check_plan(plan)
    if dev.type == "cpu":
        return reference_controlled_rollout(
            problem, z_net, K, N, delta_t, seed=seed, with_f=with_f,
            host_noise=host_noise, noise_sign=noise_sign)
    if dev.type != "cuda":
        raise ValueError(f"fused_controlled_rollout: no kernel for device "
                         f"{dev}")

    return _serve_kernel(
        _pack(problem, z_net, drift, cost, K, N, delta_t, tile, host_noise,
              noise_sign, plan), host_noise, seed, dev)


def _serve_kernel(packed: _Packed, host_noise, seed: int,
                  dev: torch.device) -> ISRolloutOut:
    """One launch of the serve kernel for a packed call (``_pack``; a
    forced ``tpp`` there gives the same bits), counted by
    ``fused_controlled_rollout``."""
    K, d = packed.iargs[0], packed.iargs[2]
    out = torch.empty((K, d + 3), dtype=torch.float32, device=dev)
    _launch("pspde_controlled_rollout", "fused_controlled_rollout", packed,
            [packed.params, host_noise, out, _workspace(packed, dev)], seed,
            dev)
    fused_controlled_rollout.launches += 1
    fused_controlled_rollout.launches_by_plan[_plan_of(packed)] += 1
    return ISRolloutOut(out[:, :d], out[:, d], out[:, d + 1], out[:, d + 2])


fused_controlled_rollout.launches = 0
fused_controlled_rollout.launches_by_plan = dict.fromkeys(PLANS, 0)


# -- the training rollout (counterpart of make_fused_train_rollout) --------

class FusedTrainOut(NamedTuple):
    X: torch.Tensor       # (K, d) final state, no gradient
    Y: torch.Tensor       # (K,) accumulated value increments (Y_0 excluded)
    Z_sum: torch.Tensor   # (K,) KL / Ito accumulator
    u_l2: torch.Tensor    # (K,) control-error accumulator, no gradient


TRAIN_KERNEL_FAMILY = ("drift -x or A x; sigma scalar, diag or full "
                       "(constant); f zero or x^T P x; " + _FAMILY_NET
                       + "; h = c_h |z|^2/2 + f_coef f "
                       "(Problem.h_family); u_tab only for a problem with a "
                       "state-independent reference control (u_ref_table); "
                       "rng 'erfinv' or 'binom'")


def _train_outside(msg: str):
    return ValueError(f"fused_train_rollout: {msg}; the kernel covers "
                      f"{TRAIN_KERNEL_FAMILY}")


def reference_train_rollout(problem, z_net, K: int, N: int, delta_t: float,
                            seed: int = 0, *, adaptive_forward: bool = True,
                            accumulate_kl: bool = False,
                            kl_ito_term: bool = False,
                            u_tab: Optional[torch.Tensor] = None,
                            rng: str = "binom", noise_sign: float = 1.0,
                            host_noise: Optional[torch.Tensor] = None
                            ) -> FusedTrainOut:
    """Plain version of the training kernels: ``hjb_rollout`` with a
    detached forward on the kernels' noise stream (``host_noise`` (N, K, d)
    or ``train_normals(seed, ...)``, times ``noise_sign``), from X_0 with
    Y_0 = 0.  Differentiable in ``z_net``'s parameters by autograd; any
    callable ``z_net`` (tX (K, d+1) -> Z (K, d)) is accepted."""
    d = problem.d
    dev = problem.X_0.device
    sign = float(noise_sign)

    def noise_fn(n):
        xi = (host_noise[n] if host_noise is not None
              else train_normals(seed, K, n, d, rng, dev))
        return xi if sign == 1.0 else sign * xi

    def control(X, n, t):
        tX = torch.cat([torch.full((K, 1), t, dtype=torch.float32,
                                   device=dev), X], dim=1)
        return z_net(tX), None

    u_ref = None if u_tab is None else (lambda X, n: u_tab[n].expand(K, d))
    cfg = HJBRolloutConfig(N=N, delta_t=delta_t,
                           adaptive_forward=adaptive_forward,
                           detach_forward=True, accumulate_kl=accumulate_kl,
                           kl_ito_term=kl_ito_term,
                           track_u_l2=u_tab is not None)
    out = hjb_rollout(cfg, problem, control,
                      problem.X_0.to(torch.float32).expand(K, d),
                      torch.zeros((K,), dtype=torch.float32, device=dev),
                      u_ref=u_ref, noise_fn=noise_fn)
    return FusedTrainOut(out.X, out.Y, out.Z_sum, out.u_l2)


def _check_train_family(problem, z_net, N, noise_sign, u_tab, rng):
    drift, cost = _check_family(problem, z_net, True, noise_sign,
                                outside=_train_outside, double_well=False)
    hfam = problem.h_family()
    if hfam is None or hfam[0] != "quadratic_z":
        raise _train_outside(f"h of {type(problem).__name__} is not "
                             "c_h |z|^2/2 + f_coef f")
    if u_tab is not None:
        if not hasattr(problem, "u_ref_table"):
            raise _train_outside(
                f"u_tab given for {type(problem).__name__}, whose reference "
                "control is state-dependent (no u_ref_table)")
        if tuple(u_tab.shape) != (N, problem.d):
            raise _train_outside(f"u_tab has shape {tuple(u_tab.shape)}, "
                                 f"expected {(N, problem.d)}")
    if rng not in RNG_MAPS:
        raise _train_outside(f"rng={rng!r}")
    return drift, cost, hfam


def _train_smem_bytes(fixed: int, per_path: int, tile: int) -> int:
    """Shared memory of one training block in the shared plan: ``fixed``
    floats (the staged net, plus the gradient buffer in the backward or
    the exchange of the sums' classes in the forward) and ``per_path``
    floats per path at the row stride tile + 4, where the mma fragment
    loads of both kernels' products are free of bank conflicts - the
    formula of train_step.cuh:train_smem_floats and train_stride."""
    return 4 * (fixed + per_path * (tile + 4))


def _train_fwd_tpp(tile: int, plan: str) -> int:
    """Threads per path of the forward's block at ``tile`` paths."""
    return max(1, min(_FWD_TPP[plan], _FWD_THREADS // tile))


def _serve_tpp(tile: int, plan: str, K: int) -> int:
    """Threads per path of the serve's block at ``tile`` paths: the
    training forward's (_FWD_TPP of the plan) where K gives _SERVE_SPREAD
    blocks or more, else as many as the classes of sums allow (4: more
    warps where the card is idle); tile x tpp at most _FWD_THREADS."""
    full = -(-K // tile) >= _SERVE_SPREAD
    want = _FWD_TPP[plan] if full else _SUM_CLASSES
    return max(1, min(want, _FWD_THREADS // tile))


def _train_fwd_net_floats(lay: _Layout, dp: int) -> int:
    """The forward's staged net (train_step.cuh:train_stage_net): layer
    0's t row, each layer's bias, each layer's weights as mma fragments
    (layer 0's k rows are X's dp)."""
    k_rows = [dp] + lay.rows[1:]
    return lay.cols[0] + sum(c + k * c for k, c in zip(k_rows, lay.cols))


def _pack_train(problem, z_net, drift, cost, hfam, K, N, delta_t, tile, *,
                backward, host_noise, noise_sign, adaptive_forward,
                accumulate_kl, kl_ito_term, u_tab, rng,
                plan=None, serve=False, tpp=None) -> _Packed:
    """The training kernels' arguments (train_step.cuh: TrainArgs): the
    buffer of ``_layout`` with the net as it is (the kernel's net returns
    Z) and the u_tab table, the per-layer offsets of one block's gradient
    buffer, [W (rows, cols); b (1, cols)] per layer, the direction, the
    forward's threads per path (``_train_fwd_tpp``; 1 in the backward)
    and the memory plan (``_choose_plan``).  ``serve``: the serve kernel's
    forward (``_pack``), with its threads per path (``_serve_tpp``) and its
    errors.  ``tpp`` forces the forward's threads per path: a divisor of
    _SUM_CLASSES with tile x tpp <= _FWD_THREADS (every tpp gives the same
    bits)."""
    d = problem.d
    dp = _ceil_to(d, _CHUNK)
    lay = _layout(problem, z_net, drift, cost, u_tab=u_tab)
    _, c_h, f_coef = hfam
    need_f = lay.f_kind == 1 and (f_coef != 0.0 or accumulate_kl)
    dense = lay.drift_kind == 1 or lay.sig_kind == 2
    hidden = sum(lay.cols[:-1])
    g_off, n_grad = [], 0
    for rows, cols in zip(lay.rows, lay.cols):
        g_off.append(n_grad)
        n_grad += (rows + 1) * cols
    n_stage = lay.x0_off + dp
    if backward:
        per_path = dp * (4 if dense else 3) + 2 * hidden
    else:
        per_path = dp * (3 if dense else 2) + hidden
    net = _train_fwd_net_floats(lay, dp)

    def smem_bytes(t):
        fixed = n_stage + n_grad if backward else net + 3 * _SUM_CLASSES * t
        return _train_smem_bytes(fixed, per_path, t)

    tile, plan, stride = _choose_plan(smem_bytes, per_path, K, tile, plan,
                                      _outside if serve else _train_outside)
    if backward:
        tpp = 1
    elif tpp is not None:
        if _SUM_CLASSES % tpp or tile * tpp > _FWD_THREADS:
            raise ValueError(f"tpp={tpp} must divide {_SUM_CLASSES} with "
                             f"tile x tpp <= {_FWD_THREADS} (tile {tile})")
    else:
        tpp = _serve_tpp(tile, plan, K) if serve else _train_fwd_tpp(tile,
                                                                     plan)
    iargs = [K, N, d, dp, lay.n_layers, tile, lay.drift_kind, lay.a_off,
             lay.sig_kind, lay.sig_off, int(need_f), lay.p_off, lay.x0_off,
             n_stage, lay.u_off, int(u_tab is not None),
             int(host_noise is not None), int(adaptive_forward),
             int(accumulate_kl), int(kl_ito_term), RNG_MAPS.index(rng),
             n_grad]
    iargs += _per_layer_args(lay) + g_off + [0] * (_MAX_LAYERS - lay.n_layers)
    iargs += [int(backward), tpp, PLANS.index(plan), stride]
    dt, sq_dt = step_constants(delta_t)
    fargs = [dt, sq_dt, float(noise_sign), lay.sig_scale, float(c_h),
             float(f_coef)]
    return _Packed(lay.buf, iargs, fargs, per_path * stride)


class _TrainCall(NamedTuple):
    """One ``fused_train_rollout`` call: what the backward replays."""
    problem: object
    z_net: torch.nn.Module
    K: int
    N: int
    delta_t: float
    seed: Seed               # CUDA: the 0-d int64 device word both kernels
                             # read (device_seed); CPU: an int
    families: tuple          # (drift, cost, hfam) of the family check
    opts: dict               # adaptive_forward, accumulate_kl, kl_ito_term,
                             # u_tab, rng, noise_sign, host_noise
    tile: Optional[int]
    plan: Optional[str] = None

    def plain(self) -> FusedTrainOut:
        return reference_train_rollout(self.problem, self.z_net, self.K,
                                       self.N, self.delta_t,
                                       host_seed(self.seed), **self.opts)

    def pack(self, backward: bool) -> _Packed:
        o = self.opts
        return _pack_train(
            self.problem, self.z_net, *self.families, self.K, self.N,
            self.delta_t, self.tile, backward=backward,
            host_noise=o["host_noise"], noise_sign=o["noise_sign"],
            adaptive_forward=o["adaptive_forward"],
            accumulate_kl=o["accumulate_kl"], kl_ito_term=o["kl_ito_term"],
            u_tab=o["u_tab"], rng=o["rng"], plan=self.plan)


def _train_forward_kernel(call: _TrainCall) -> FusedTrainOut:
    dev = call.problem.X_0.device
    K, d = call.K, call.problem.d
    packed = call.pack(backward=False)
    X = torch.empty((K, d), dtype=torch.float32, device=dev)
    acc = [torch.empty((K,), dtype=torch.float32, device=dev)
           for _ in range(3)]
    _launch("pspde_train_rollout_fwd", "fused_train_rollout", packed,
            [packed.params, call.opts["host_noise"], X, *acc,
             _workspace(packed, dev)], call.seed, dev)
    if not _capturing(dev):
        fused_train_rollout.launches += 1
        fused_train_rollout.launches_by_plan[_plan_of(packed)] += 1
    return FusedTrainOut(X, *acc)


def _train_fwd_occupancy(packed: _Packed, dev: torch.device,
                        entry: str = "pspde_train_fwd_occupancy") -> dict:
    """The forward's launch on CUDA device ``dev`` for one packed call:
    its blocks resident on one SM (train_rollout.cu:
    pspde_train_fwd_occupancy; the serve kernel's with ``entry``
    'pspde_serve_occupancy', controlled_rollout.cu), threads and warps a
    block and an SM, and its bytes of dynamic shared memory.  The
    runtime's theoretical residency, for the reports (chip_smoke.py,
    experiments/torch_kernel_times.py --layouts); no solver path calls
    it."""
    from ._build import library
    lib = library()
    out = (ctypes.c_int * 3)()
    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    err = getattr(lib, entry)(
        (ctypes.c_int * len(packed.iargs))(*packed.iargs),
        (ctypes.c_float * len(packed.fargs))(*packed.fargs), index, out)
    if err != 0:
        raise RuntimeError(f"{entry}: occupancy query failed: "
                           + lib.pspde_cuda_error_string(err).decode())
    blocks, threads, smem = list(out)
    return {"blocks_per_sm": blocks, "threads": threads,
            "warps_per_sm": blocks * threads // 32, "smem_bytes": smem,
            "tile": packed.iargs[5], "threads_per_path": packed.iargs[-3],
            "plan": _plan_of(packed)}


def _train_backward_kernel(call: _TrainCall, gY, gKL) -> list:
    dev = call.problem.X_0.device
    packed = call.pack(backward=True)
    ia = packed.iargs
    tile, n_grad = ia[5], ia[21]
    n_layers = ia[4]
    n_blocks = -(-call.K // tile)
    part = torch.empty((n_blocks, n_grad), dtype=torch.float32, device=dev)
    _launch("pspde_train_rollout_bwd", "fused_train_rollout", packed,
            [packed.params, call.opts["host_noise"], gY.contiguous(),
             gKL.contiguous(), part, _workspace(packed, dev)], call.seed,
            dev)
    if not _capturing(dev):
        fused_train_rollout.backward_launches += 1
        fused_train_rollout.backward_launches_by_plan[_plan_of(packed)] += 1
    total = part.sum(dim=0)
    rows = ia[22:22 + n_layers]
    cols = ia[22 + _MAX_LAYERS:22 + _MAX_LAYERS + n_layers]
    g_off = ia[22 + 4 * _MAX_LAYERS:22 + 4 * _MAX_LAYERS + n_layers]
    grads = []
    for l, lin in enumerate(call.z_net.layers):
        G = total[g_off[l]:g_off[l] + (rows[l] + 1) * cols[l]].reshape(
            rows[l] + 1, cols[l])
        grads.append(G[:lin.in_features, :lin.out_features].T.contiguous())
        grads.append(G[rows[l], :lin.out_features].contiguous())
    return grads


def _reference_train_backward(call: _TrainCall, gY, gKL) -> list:
    """Plain version of the backward kernel: replay the plain forward with
    autograd and pull (gY, gKL) back to the net's parameters."""
    params = list(call.z_net.parameters())
    with torch.enable_grad():
        out = call.plain()
        pairs = [(o, g) for o, g in ((out.Y, gY), (out.Z_sum, gKL))
                 if o.requires_grad]
        if not pairs:
            return [torch.zeros_like(p) for p in params]
        grads = torch.autograd.grad([o for o, _ in pairs],
                                    params, [g for _, g in pairs],
                                    allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(params, grads)]


class _FusedTrainFn(torch.autograd.Function):
    """Forward and replay backward of one call.  The forward saves only
    the parameters (and the call, which holds the seed); X and u_l2 carry
    no gradient; a None cotangent of Y or Z_sum counts as zeros."""

    @staticmethod
    def forward(ctx, call: _TrainCall, *params):
        ctx.call = call
        ctx.save_for_backward(*params)
        ctx.set_materialize_grads(False)
        if call.problem.X_0.device.type == "cpu":
            out = call.plain()
        else:
            out = _train_forward_kernel(call)
        ctx.mark_non_differentiable(out.X, out.u_l2)
        return tuple(out)

    @staticmethod
    def backward(ctx, gX, gY, gKL, gU):
        call = ctx.call
        params = ctx.saved_tensors
        if gY is None and gKL is None:
            return (None,) + tuple(torch.zeros_like(p) for p in params)
        like = gY if gY is not None else gKL
        gY = torch.zeros_like(like) if gY is None else gY
        gKL = torch.zeros_like(like) if gKL is None else gKL
        if call.problem.X_0.device.type == "cpu":
            grads = _reference_train_backward(call, gY, gKL)
        else:
            grads = _train_backward_kernel(call, gY, gKL)
        return (None,) + tuple(grads)


def fused_train_rollout(problem, z_net, K: int, N: int, delta_t: float,
                        seed: Seed = 0, *, adaptive_forward: bool = True,
                        accumulate_kl: bool = False,
                        kl_ito_term: bool = False,
                        u_tab: Optional[torch.Tensor] = None,
                        rng: str = "binom", noise_sign: float = 1.0,
                        host_noise: Optional[torch.Tensor] = None,
                        tile: Optional[int] = None,
                        plan: Optional[str] = None) -> FusedTrainOut:
    """Training rollout of K paths over N steps with a detached forward,
    Z = z_net([t, X]): X (K, d), Y, Z_sum and u_l2 (K,), differentiable in
    z_net's parameters through Y and Z_sum (a ``torch.autograd.Function``
    whose backward replays the forward on the same noise).

    The device is the problem's: the net, ``u_tab`` (N, d) and
    ``host_noise`` (N, K, d) must live there.  CPU: the plain version
    (forward, and an autograd replay as the backward).  CUDA: the forward
    and backward kernels of ``csrc/train_rollout.cu``, counted by
    ``fused_train_rollout.launches`` and ``.backward_launches`` (per plan:
    ``.launches_by_plan``, ``.backward_launches_by_plan``); ``tile`` and
    ``plan`` as ``fused_controlled_rollout`` takes them.  Noise is
    ``host_noise`` or the Philox stream of ``seed`` through ``rng``
    ('binom', the default, or 'erfinv'), times ``noise_sign``; antithetic
    training is two calls over K/2 paths with one seed and signs +1, -1.
    On CUDA both kernels read the seed from one 0-d int64 device tensor
    when they run (``device_seed``: a tensor given is that word, an int is
    written into one), so a captured CUDA graph takes the seed written
    there before each replay.  Raises ValueError outside
    ``TRAIN_KERNEL_FAMILY``."""
    families = _check_train_family(problem, z_net, N, noise_sign, u_tab, rng)
    d = problem.d
    dev = problem.X_0.device
    for name, p in z_net.named_parameters():
        _check_tensor(f"z_net.{name}", p, p.shape, dev)
    if u_tab is not None:
        _check_tensor("u_tab", u_tab, (N, d), dev)
    if host_noise is not None:
        _check_tensor("host_noise", host_noise, (N, K, d), dev)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_train_rollout: no kernel for device {dev}")
    _check_plan(plan)
    seed = (device_seed(seed, dev) if dev.type == "cuda"
            else host_seed(seed))
    call = _TrainCall(problem, z_net, K, N, delta_t, seed, families,
                      dict(adaptive_forward=adaptive_forward,
                           accumulate_kl=accumulate_kl,
                           kl_ito_term=kl_ito_term, u_tab=u_tab, rng=rng,
                           noise_sign=noise_sign, host_noise=host_noise),
                      tile, plan)
    return FusedTrainOut(*_FusedTrainFn.apply(call, *z_net.parameters()))


fused_train_rollout.launches = 0
fused_train_rollout.backward_launches = 0
fused_train_rollout.launches_by_plan = dict.fromkeys(PLANS, 0)
fused_train_rollout.backward_launches_by_plan = dict.fromkeys(PLANS, 0)


# -- the stopped training rollout (make_fused_stopped_train_rollout) -------

class FusedStoppedOut(NamedTuple):
    X: torch.Tensor          # (K, d) state at stopping (or final) time
    Y: torch.Tensor          # (K,) accumulated masked value increments
    t: torch.Tensor          # (K,) per-path clock: t0 plus dt per
                             # advanced step with time_stopping, else t0
    stopped: torch.Tensor    # (K,) float 0/1
    hitting: torch.Tensor    # (K,) number of active steps
    v_l2: torch.Tensor       # (K,) accumulated V-vs-reference L2 error
    adv_steps: torch.Tensor  # (K,) advanced steps (the K_log numerator)


STOPPED_KERNEL_FAMILY = (
    "zero drift with sigma scalar on the geometry 'sphere' (exit tested on "
    "the current state) or, with time_stopping, 'unbounded', h = y (c_y + "
    "c_yr2 |x|^2) + phi(exp(k |x|^2 + k_t t) - y^2) with phi none, "
    "identity or sin (Problem.h_family 'ball_exp') and v_ref exp(a |x|^2) or "
    "none (Problem.v_ref_family; no in-kernel reference with "
    "time_stopping), with time_stopping h gaining c_y3 y^3 (AllenCahn's y "
    "- y^3); without time_stopping also sigma 'diag' or 'full' (a "
    "d x d matrix), the geometry 'two_spheres' (a < |x| < c, tested on the "
    "current state), h gaining c_ys1 y (sum_j x_j)^2 and the committor's "
    "reference (a^2 - r^(2-d) a^d) / (a^2 - c^(2-d) a^d) ('committor'); "
    "or the torus family without time_stopping: the "
    "two-sided 'square' (exit tested on the proposal), drift -cos(s) c "
    "sin(x) with s = c sum cos x_j and a uniform c ('torus_cos'), sigma "
    "scalar, h = y "
    "(-c^2 sum sin^2 x_j sin(s) - cos(s) s) and v_ref exp(-sin(s)) or none "
    "('torus_fp'), with an optional lambda leaf (a one-element tensor: h + "
    "lambda y, the EigenSolver's); or the Schroedinger family without "
    "time_stopping: zero drift with sigma scalar on the two-sided square "
    "(exit tested on the proposal), h = -y^3 - y pot(x) with pot(x) = "
    "-(1/c^2) exp((2/d) sum cos x_j) + sum (sin^2 x_j / d^2 - cos x_j / d) "
    "- 3 and v_ref (1/c) exp((1/d) sum cos x_j) or none ('schrodinger'), "
    "with the lambda leaf; a concat-skip value net with d_out=1, "
    "output_relu or not, 1-4 hidden layers and input width d, or d + 1 "
    "reading [x, t] with time_stopping (a step advances while t + dt <= "
    "T): a DenseNet (relu^2 features) with every family but the "
    "Schroedinger one, a DenseNetTanh (tanh features) with the "
    "Schroedinger family; rng 'erfinv' or 'binom'")
_MAX_HIDDEN = 4            # csrc/stopped_rollout.cu kMaxHidden
_STOPPED_TILES = (64, 32)  # csrc kStoppedTile bounds the backward's block
# The forward's block: `tile` lanes of `tpp` threads, tile x tpp a multiple
# of 32 up to _STOPPED_FWD_THREADS (csrc kFwdMaxTile, kFwdThreads)
_STOPPED_FWD_TILES = (64, 32, 16, 8, 4)
_STOPPED_FWD_TPP = (1, 2, 4, 8, 16)
_STOPPED_FWD_THREADS = 256
_STOPPED_ROW_PAD = 4       # csrc kRowPad: the forward's staged W rows
# the SMs of an H100: a small K is spread over them (the forward's tile
# halved while K leaves fewer blocks), with at least _STOPPED_FWD_SM_THREADS
# threads of its lanes on each (more threads a lane)
_STOPPED_FWD_SPREAD = 132
_STOPPED_FWD_SM_THREADS = 256
_PHI = ("none", "identity", "sin")
# csrc StoppedArgs.geom
_GEOMETRIES = ("sphere", "unbounded", "square", "two_spheres")
_EXITS = ("sphere", "two_spheres")    # paths leave after a few steps
_VREFS = ("exp_r2", "committor")                   # csrc StoppedExt.vref
# csrc StoppedExt.feat: the value net's feature map, and the families' h
# (StoppedExt.hfam: 0 the ball, the torus and the breadth families by
# their other fields, 1 the Schroedinger family)
_FEATURES = ("relu2", "tanh")
_SQUARE_FAMILIES = ("torus_fp", "schrodinger")


def _stopped_outside(msg: str):
    return ValueError(f"fused_stopped_train_rollout: {msg}; the kernels "
                      f"cover STOPPED_KERNEL_FAMILY: {STOPPED_KERNEL_FAMILY}")


def _check_stopped_family(problem, v_net, rng, time_stopping=False,
                          lam=None):
    """(h_family, v_ref_family) of a problem and net inside the stopped
    kernels' family: ('ball_exp', c_y, c_yr2, k, phi, k_t, c_ys1, c_y3)
    (a shorter tuple padded with 0.0) with its reference ('exp_r2', a),
    ('committor', a, c, d) or None, or on the square ('torus_fp', c) with
    ('torus_fp', c) or None, or ('schrodinger', c) with ('schrodinger', c)
    or None; raises ValueError naming STOPPED_KERNEL_FAMILY outside it.
    With ``time_stopping`` the net reads [x, t] and there is no in-kernel
    reference (v_ref_family None).  A lambda leaf ``lam`` belongs to the
    square's families.  The value net is a concat-skip net whose feature
    map the family takes: relu^2 (``DenseNet``), or tanh
    (``DenseNetTanh``) with the Schroedinger family only."""
    name = type(problem).__name__
    if time_stopping and getattr(problem, "T", None) is None:
        raise _stopped_outside(f"time_stopping needs a horizon, and {name} "
                               "has T=None")
    drift = problem.drift_family()
    if drift is None or drift[0] not in ("zero", "torus_cos"):
        raise _stopped_outside(f"drift of {name} is neither zero nor "
                               "'torus_cos'")
    torus = drift[0] == "torus_cos"
    hfam = problem.h_family()
    sch = (drift[0] == "zero" and hfam is not None
           and hfam[0] == "schrodinger")
    square = torus or sch
    geom = problem.geometry
    kind = getattr(geom, "kind", None)
    sig_kind = problem.sigma_struct.kind
    if sig_kind != "scalar" and (square or time_stopping or kind not in (
            "sphere", "two_spheres")):
        raise _stopped_outside(
            f"sigma of {name} is {sig_kind}, not scalar: a diag or full "
            "sigma goes with zero drift on 'sphere' or 'two_spheres' "
            "without time_stopping")
    if kind not in _GEOMETRIES:
        raise _stopped_outside(f"geometry of {name} is {kind!r}")
    if (kind == "square") != square:
        raise _stopped_outside(
            f"geometry of {name} is {kind!r} with drift {drift[0]!r}: the "
            "kernels test the square only with the torus family "
            "('torus_cos' drift, 'torus_fp' h) and the Schroedinger family "
            "(zero drift, 'schrodinger' h)")
    if square and (geom.one_boundary or time_stopping):
        raise _stopped_outside(f"geometry of {name} is a one-sided square or "
                               "runs with time_stopping (ROADMAP.md Queue 2 "
                               "item 4(b))")
    if kind == "unbounded" and not time_stopping:
        raise _stopped_outside(f"geometry of {name} is 'unbounded' and "
                               "without time_stopping no path would stop")
    if kind == "two_spheres" and time_stopping:
        raise _stopped_outside(f"geometry of {name} is 'two_spheres', which "
                               "the kernels take without time_stopping")
    if lam is not None and not square:
        raise _stopped_outside("a lambda leaf (the EigenSolver's h + lambda "
                               "y) goes with the square's families only (the "
                               "torus and the Schroedinger family)")
    vfam = None if time_stopping else problem.v_ref_family()
    if sch:
        hfam = ("schrodinger", float(hfam[1]))
        if vfam is not None and tuple(vfam) != hfam:
            raise _stopped_outside(f"v_ref of {name} is not (1/c) exp((1/d) "
                                   "sum cos x_j) of its h's c")
    elif torus:
        if hfam is None or tuple(hfam) != ("torus_fp", drift[1]):
            raise _stopped_outside(f"h of {name} is not in the 'torus_fp' "
                                   "family of its drift's c")
        hfam = tuple(hfam)
        if vfam is not None and tuple(vfam) != hfam:
            raise _stopped_outside(f"v_ref of {name} is not exp(-sin(s))")
    else:
        if hfam is None or hfam[0] != "ball_exp" or hfam[4] not in _PHI:
            raise _stopped_outside(f"h of {name} is not in the 'ball_exp' "
                                   "family")
        hfam = tuple(hfam) + (0.0,) * (8 - len(hfam))
        if hfam[6] != 0.0 and time_stopping:
            raise _stopped_outside(f"h of {name} has a (sum_j x_j)^2 term, "
                                   "which the kernels take without "
                                   "time_stopping")
        if hfam[7] != 0.0 and not time_stopping:
            raise _stopped_outside(f"h of {name} has a y^3 term, which the "
                                   "kernels take with time_stopping (the "
                                   "clock's instantiations)")
        if vfam is not None and (vfam[0] not in _VREFS or (
                vfam[0] == "committor" and tuple(vfam[3:]) != (problem.d,))):
            raise _stopped_outside(f"v_ref of {name} is neither exp(a "
                                   "|x|^2) nor the committor's")
    want = "tanh" if sch else "relu2"
    if not isinstance(v_net, ConcatSkipNet):
        raise _stopped_outside(f"value net {type(v_net).__name__} is not a "
                               "DenseNet (nor another concat-skip net)")
    if v_net.feature != want:
        raise _stopped_outside(
            f"value net {type(v_net).__name__} has {v_net.feature} "
            f"features: the {hfam[0]!r} family takes {want} features "
            f"({'DenseNetTanh' if sch else 'DenseNet'}); the other pairs "
            "stay on the scan (ROADMAP.md Queue 2 item 4(g))")
    d_in = problem.d + int(bool(time_stopping))
    if v_net.d_in != d_in or v_net.d_out != 1:
        raise _stopped_outside(
            f"{type(v_net).__name__} d_in={v_net.d_in}, "
            f"d_out={v_net.d_out}, "
            f"output_relu={v_net.output_relu} (need {d_in}, 1, "
            f"{v_net.output_relu} with time_stopping={bool(time_stopping)})")
    if not 1 <= len(v_net.arch) <= _MAX_HIDDEN:
        raise _stopped_outside(f"{type(v_net).__name__} has "
                               f"{len(v_net.arch)} hidden layers")
    if rng not in RNG_MAPS:
        raise _stopped_outside(f"rng={rng!r}")
    return hfam, vfam


def reference_stopped_train_rollout(problem, v_net, X0: torch.Tensor,
                                    t0: torch.Tensor, N: int, delta_t: float,
                                    seed: int = 0, *,
                                    adaptive_forward: bool = False,
                                    rng: str = "erfinv",
                                    host_noise: Optional[torch.Tensor] = None,
                                    with_v_ref: bool = True,
                                    time_stopping: bool = False,
                                    lam: Optional[torch.Tensor] = None
                                    ) -> FusedStoppedOut:
    """Plain version of the stopped training kernels: ``stopped_rollout``
    with a detached forward from (X0, t0) with Y_0 = 0, on the kernels'
    noise stream (``host_noise`` (N, K, d) or ``train_normals(seed, ...)``
    through ``rng``), v_l2 against ``problem.v_ref`` when ``with_v_ref``
    and not ``time_stopping`` (then the net reads [x, t] and each path's
    clock stops it at the horizon).  With ``lam`` it runs the lambda-shifted
    problem, h + lam y (``sde.LambdaShiftedProblem``).  Differentiable in
    ``v_net``'s parameters and ``lam`` by autograd (second order through
    Z = sigma^T grad V); any problem and value net are accepted."""
    K, d = X0.shape
    dev = X0.device
    cfg = StoppedRolloutConfig(N=N, delta_t=delta_t,
                               adaptive_forward=adaptive_forward,
                               detach_forward=True,
                               time_stopping=time_stopping)
    with_v_ref = with_v_ref and problem.has_v_ref and not time_stopping
    out = stopped_rollout(
        cfg, problem if lam is None else LambdaShiftedProblem(problem, lam),
        value_and_z(v_net, problem.sigma_struct, space_time=time_stopping),
        X0.to(torch.float32), torch.zeros((K,), dtype=torch.float32,
                                          device=dev),
        t0, inside_fn(problem.geometry),
        v_ref=problem.v_ref if with_v_ref else None,
        host_noise=host_noise,
        noise_fn=lambda n: train_normals(seed, K, n, d, rng, dev))
    stopped = out.stopped.to(torch.float32)
    return FusedStoppedOut(out.X, out.Y, out.t, stopped, out.hitting,
                           out.v_l2, out.hitting - stopped)


_STOPPED_BALLOT_WORDS = 4   # csrc kBallotWords: the backward's lane ballots
# the device plan's lanes kernel (csrc stopped_bwd_lane_kernel)
_STOPPED_LANE_BALLOT_WORDS = 16   # csrc kLaneBallotWords
_STOPPED_LANE_THREADS = 256       # csrc kLaneThreads: tile x tpp at most
_STOPPED_LANE_TILES = (64, 32, 16, 8)
_STOPPED_LANE_TPP = (2, 4, 8, 16, 32)
_STOPPED_LANE_SPREAD = 132        # blocks below which the tile halves
_STOPPED_LANE_FILL = 2 ** 16      # lanes' threads that fill the card


def _stopped_smem_bytes(n_stage: int, per_path: int, tile: int,
                        backward: bool = False,
                        stride: Optional[int] = None) -> int:
    """Shared memory of one stopped block: ``n_stage`` floats of staged net
    and ``per_path`` floats per path (``_stopped_per_path``) at stride tile
    + 1 (forward), or the lane ballots and the arrays at ``stride``
    (backward; default tile + 4, the stride of its mma fragments) - the
    formula of stopped_rollout.cu:smem_floats."""
    if backward:
        return 4 * (_STOPPED_BALLOT_WORDS + n_stage
                    + per_path * (stride or tile + 4))
    return 4 * (n_stage + per_path * (tile + 1))


def _stopped_bwd_stride(n_stage: int, per_path: int, tile: int) -> int:
    """The backward's stride: tile + 4 (conflict-free mma fragments) where
    the block fits, else the forward's tile + 1 (the same sums, with bank
    conflicts in the products), so that every net the forward takes the
    backward takes too."""
    fits = _stopped_smem_bytes(n_stage, per_path, tile, True) <= _SMEM_LIMIT
    return tile + 4 if fits else tile + 1


def _stopped_fwd_net_floats(n_params: int, widths, d_in: int) -> int:
    """The forward's staged net (stopped_rollout.cu: FwdNet): the packed
    buffer and _STOPPED_ROW_PAD floats after each row of each W."""
    n_in = [d_in + sum(widths[:l]) for l in range(len(widths))]
    return n_params + _STOPPED_ROW_PAD * sum(n_in)


def _stopped_per_path(F: int, H: int, d: int, backward: bool,
                      full: bool = False) -> int:
    """Floats of one path's shared arrays: the backward's 3 F + 3 H + 1,
    the forward's features, relu values and gradient (2 F + H) and the
    step's d normals; with a dense sigma (``full``) the rows of its
    products: Z in the forward (d), the normals and Z in the backward
    (2 d)."""
    if backward:
        return 3 * F + 3 * H + 1 + (2 * d if full else 0)
    return 2 * F + H + d + (d if full else 0)


def _stopped_tile(n_params: int, per_path: int, tile: Optional[int],
                  backward: bool = False, tiles: tuple = _STOPPED_TILES):
    """(tile, stage): the largest tile of ``tiles`` (or the given one)
    whose per-path arrays fit, with the net staged in shared memory when it
    fits beside them, else read from device memory; the backward tries
    every tile at stride tile + 4 first, then at tile + 1."""
    if tile is not None and tile not in tiles:
        raise ValueError(f"tile={tile} must be one of {tiles}")
    for pad in ((4, 1) if backward else (1,)):
        for t in ((tile,) if tile is not None else tiles):
            for stage in (True, False):
                if _stopped_smem_bytes(n_params if stage else 0, per_path,
                                       t, backward, t + pad) <= _SMEM_LIMIT:
                    return t, stage
    t = min(tiles)
    least = _stopped_smem_bytes(0, per_path, t, backward, t + 1)
    raise _stopped_outside(f"{least} bytes of per-path shared memory at "
                           f"tile={t} exceed the {_SMEM_LIMIT}-byte limit of "
                           "one block")


class _BwdLayout(NamedTuple):
    """The device plan's launch (csrc stopped_bwd_lane_kernel): blocks of
    ``tile`` lanes of ``tpp`` threads (a lane carries one path at a time,
    its threads split the replay's sweeps), the lanes' arrays in shared
    memory at stride tile + 4 (``smem``) or in a workspace of device
    memory, and the net staged in shared memory (``stage``, the forward's
    padded rows) or read from device memory."""
    tile: int
    tpp: int
    smem: bool
    stage: bool


def _stopped_bwd_lane_bytes(n_stage: int, per_path: int,
                            lay: _BwdLayout) -> int:
    """Shared memory of one block of the lanes kernel: the ballots, the
    ``n_stage`` floats of the staged net (``_stopped_fwd_net_floats``)
    where it is staged and the lanes' ``per_path`` floats at stride tile +
    4 where they sit in shared memory - the formula of
    stopped_bwd_lanes.cu:lane_smem_floats."""
    return 4 * (_STOPPED_LANE_BALLOT_WORDS + (n_stage if lay.stage else 0)
                + (per_path * (lay.tile + 4) if lay.smem else 0))


def _stopped_bwd_lane_layout(n_stage: int, per_path: int, K: int,
                             tile: Optional[int] = None,
                             layout: Optional[tuple] = None) -> _BwdLayout:
    """The device plan's layout (``_BwdLayout``): ``layout`` where given (a
    forced one), else the fastest by device time, or within 7% of it, at
    the cells of experiments/torch_bwd_layouts.py (the notebook's
    Allen-Cahn net at K = 200, 8192 and 65536, DenseNet (30, 30) at the
    elliptic cell at K = 8192 and 65536; the Schroedinger and committor
    notebooks' nets at their K, 500 and 200; PERF.md section 6):
    - threads a lane: the fewest of 4, 8, 16 whose K x tpp threads reach
      _STOPPED_LANE_FILL (the card holds 132 x 512 at 16 warps an SM), so
      that each path's chain is split only as far as K leaves the card
      idle;
    - the largest tile of _STOPPED_LANE_TILES (``tile`` where given) whose
      block stays within _STOPPED_LANE_THREADS, halved while K gives fewer
      than _STOPPED_LANE_SPREAD blocks;
    - the lanes' arrays in shared memory where they fit, and the net (its
      ``n_stage`` floats, padded) staged beside them where it fits too;
      with the arrays in the workspace the net is read from device memory
      (staged alone it leaves one block an SM, and read slower).
    Raises ValueError on a forced layout the kernel does not take or whose
    block does not fit."""
    if layout is not None:
        lay = _BwdLayout(*layout)
        if (lay.tile not in _STOPPED_LANE_TILES
                or lay.tpp not in _STOPPED_LANE_TPP
                or lay.tile * lay.tpp % 32
                or lay.tile * lay.tpp > _STOPPED_LANE_THREADS
                or _stopped_bwd_lane_bytes(n_stage, per_path, lay)
                > _SMEM_LIMIT):
            raise ValueError(
                f"backward layout {lay}: tile in {_STOPPED_LANE_TILES}, tpp "
                f"in {_STOPPED_LANE_TPP}, tile x tpp a multiple of 32 up to "
                f"{_STOPPED_LANE_THREADS}, a block within {_SMEM_LIMIT} "
                "bytes")
        return lay
    if tile is not None and tile not in _STOPPED_LANE_TILES:
        raise ValueError(f"tile={tile} must be one of {_STOPPED_LANE_TILES}")
    tpp = next((p for p in (4, 8) if K * p >= _STOPPED_LANE_FILL), 16)
    if tile is not None:
        tpp = min(tpp, _STOPPED_LANE_THREADS // tile)
    tiles = [t for t in _STOPPED_LANE_TILES
             if t * tpp <= _STOPPED_LANE_THREADS
             and (tile is None or t == tile)]
    while len(tiles) > 1 and -(-K // tiles[0]) < _STOPPED_LANE_SPREAD:
        tiles = tiles[1:]
    lay = _BwdLayout(tiles[0], tpp, True, True)
    if _stopped_bwd_lane_bytes(n_stage, per_path, lay) <= _SMEM_LIMIT:
        return lay
    lay = lay._replace(stage=False)
    return lay._replace(smem=_stopped_bwd_lane_bytes(0, per_path, lay)
                        <= _SMEM_LIMIT)


def _stopped_bwd_plan(n_params: int, per_path: int, tile: Optional[int],
                      plan: Optional[str], device_ok: bool = True, *,
                      n_stage: int = 0, K: int = 0,
                      layout: Optional[tuple] = None,
                      lanes_first: bool = False):
    """(tile, stage, layout) of the backward: ``layout`` ("shared",) or
    ("device", tpp, smem).

    The shared plan keeps each lane's ``per_path`` floats in shared memory
    (``_stopped_tile``: the tile, the stride and the staged net as before),
    one thread a path.  It runs wherever a tile fits, but for the families
    whose backward takes the device plan first (``lanes_first``).  Where no
    tile fits (or ``plan='device'``, or ``lanes_first``), the device plan
    runs the lanes kernel at ``_stopped_bwd_lane_layout`` of the net's
    staged floats ``n_stage`` and K (``layout`` forces one).
    ``plan='shared'`` where no tile fits raises the family's ValueError;
    the device plan for an instantiation that lacks it (``device_ok``
    False: a dense sigma's) raises, naming ROADMAP.md."""
    _check_plan(plan)
    if plan == "shared":
        return (*_stopped_tile(n_params, per_path, tile, True), ("shared",))
    if plan is None and layout is None and not lanes_first:
        try:
            return (*_stopped_tile(n_params, per_path, tile, True),
                    ("shared",))
        except ValueError:
            pass
    if not device_ok:
        raise _stopped_outside(
            "the backward's device plan (the lanes kernel) is not "
            "instantiated for a dense sigma (diag or full: its normals and Z "
            "in 2 d more rows a path); ROADMAP.md Queue 2 item 4(f)")
    lay = _stopped_bwd_lane_layout(n_stage, per_path, K, tile, layout)
    return lay.tile, lay.stage, ("device", lay.tpp, int(lay.smem))


def _stopped_bwd_ws(per_path: int, tile: int, grid: int) -> int:
    """The device plan's workspace stride where the lanes' arrays are not
    in shared memory: one column a lane, grid x tile (the backward refills
    its lanes, so the arrays belong to a lane, not to a path); its per_path
    x stride floats are indexed with 32-bit ints, so they must stay below
    2^31."""
    stride = grid * tile
    if per_path * stride >= 2 ** 31:
        raise _stopped_outside(
            f"the backward's device-plan workspace of {per_path} x {stride} "
            "floats exceeds the kernels' 32-bit indices")
    return stride


class _FwdLayout(NamedTuple):
    """The stopped forward's launch: blocks of ``tile`` lanes of ``tpp``
    threads (a lane carries one path at a time, its threads split the
    net), and with ``refill`` a grid of at most the blocks the card holds at
    once whose lanes take the next path of one queue as theirs end, else
    one block per ``tile`` paths."""
    tile: int
    tpp: int
    refill: bool


def _stopped_fwd_tpp(widths, K: int) -> int:
    """Threads a lane: the widest hidden layer's output chunks rounded up to
    a power of two (2 at width 10, 4 at 30, 16 at 70: a thread a chunk), or
    more where K paths leave the card idle, up to the power of two that puts
    _STOPPED_FWD_SM_THREADS of their threads on each SM; at most 16."""
    chunks = max(-(-w // _CHUNK) for w in widths)
    fill = _STOPPED_FWD_SPREAD * _STOPPED_FWD_SM_THREADS // K
    return min(16, max(1 << (chunks - 1).bit_length(),
                       1 << max(fill.bit_length() - 1, 0)))


def _stopped_fwd_layout(widths, geom: str, K: int, n_stage: int,
                        per_path: int, tile: Optional[int] = None,
                        layout: Optional[_FwdLayout] = None):
    """(layout, stage) of the forward: ``layout`` where given (a forced
    layout, e.g. the one-thread-a-path, one-tile-a-block schedule), else
    ``_stopped_fwd_tpp`` threads a lane, the largest tile (``tile`` where
    given: a caller's block of the pair) that keeps the block within
    _STOPPED_FWD_THREADS and halved while K leaves fewer than
    _STOPPED_FWD_SPREAD blocks, refilled lanes on the sphere and one block
    per tile on the whole space and the torus, whose paths run all N steps
    (the fastest layouts by device time at the cells of
    experiments/torch_kernel_times.py --layouts stopped; the two spheres
    refill as the sphere does).
    The tile shrinks further where its arrays (``per_path`` floats a path,
    beside the ``n_stage`` floats of the staged net where they fit) do not
    fit one block (``_stopped_tile``); past the smallest, raises."""
    if layout is not None:
        layout = _FwdLayout(*layout)
        tiles, tpp = (layout.tile,), layout.tpp
        if (layout.tile not in _STOPPED_FWD_TILES
                or tpp not in _STOPPED_FWD_TPP or layout.tile * tpp % 32
                or layout.tile * tpp > _STOPPED_FWD_THREADS):
            raise ValueError(
                f"forward layout {layout}: tile in {_STOPPED_FWD_TILES}, "
                f"tpp in {_STOPPED_FWD_TPP}, tile x tpp a multiple of 32 "
                f"up to {_STOPPED_FWD_THREADS}")
        refill = layout.refill
    else:
        tpp = _stopped_fwd_tpp(widths, K)
        if tile is not None:
            tpp = min(tpp, _STOPPED_FWD_THREADS // tile)
        tiles = tuple(t for t in _STOPPED_FWD_TILES
                      if t * tpp % 32 == 0 and t * tpp <= _STOPPED_FWD_THREADS
                      and (tile is None or t <= tile))
        while len(tiles) > 1 and -(-K // tiles[0]) < _STOPPED_FWD_SPREAD:
            tiles = tiles[1:]
        refill = geom in _EXITS
    t, stage = _stopped_tile(n_stage, per_path, None, tiles=tiles)
    return _FwdLayout(t, tpp, refill), stage


# the forward for nets that no block stages (csrc stopped_fwd_block_kernel):
# blocks of `tile` paths (a power of two up to csrc kBlockMaxTile) on
# `threads` threads (a multiple of 32 up to _STOPPED_BLOCK_THREADS)
STOPPED_FWD_KERNELS = ("lanes", "block")
_STOPPED_BLOCK_THREADS = 256      # csrc kBlockThreads
_STOPPED_BLOCK_TILES = (32, 16, 8, 4, 2, 1)
# the chosen layouts by K (the fastest of experiments/torch_fwd_layouts.py at
# the Allen-Cahn net, PERF.md section 6): up to the first K, tiles of 2
# paths on 128 threads; up to the second, 32 on 256; past it, 16 on 128
_STOPPED_BLOCK_BY_K = ((2048, (2, 128, 16, 3)), (32768, (32, 256, 16, 3)),
                       (None, (16, 128, 8, 2)))


class _FwdBlockLayout(NamedTuple):
    """The block forward's launch (csrc stopped_fwd_block_kernel): one block
    of ``threads`` threads per ``tile`` paths, which step together; each
    layer's weights stream through a ring of ``stages`` buffers of
    ``rows`` rows of the widest matrix (the net's W_l and W_l^T)."""
    tile: int
    threads: int
    rows: int
    stages: int


def _stopped_block_cols(widths, d_in: int) -> int:
    """The widest row of the block forward's matrices: padded(w) of each
    W_l and padded(n_in) of each W_l^T."""
    n_in = [d_in + sum(widths[:l]) for l in range(len(widths))]
    return max(_ceil_to(v, _CHUNK) for v in list(widths) + n_in)


def _stopped_fwd_block_bytes(widths, d_in: int, d: int,
                             lay: _FwdBlockLayout, cols: int) -> int:
    """Shared memory of one block of the block forward: the step's flags
    (2 words a path), the output row wL (F floats), the tile's F + H + d_in
    + d rows and the ring of ``stages`` x ``rows`` x ``cols`` floats, each
    part rounded up to 4 floats - the formula of
    stopped_rollout.cu:block_smem_floats."""
    T, H = lay.tile, sum(widths)
    F = d_in + H
    return 4 * (_ceil_to(2 * T, 4) + _ceil_to(F, 4)
                + _ceil_to((F + H + d_in + d) * T, 4)
                + lay.stages * lay.rows * cols)


def _stopped_fwd_block_layout(widths, d_in: int, d: int, K: int,
                              layout: Optional[tuple] = None
                              ) -> _FwdBlockLayout:
    """The block forward's layout: ``layout`` where given (a forced one),
    else _STOPPED_BLOCK_BY_K's at K, the fastest by device time at the
    Allen-Cahn net's K = 200, 8192 and 65536: at the notebook's K=200,
    100 blocks of 2 paths (a step is a latency chain, and 4 warps a block
    spread it; 1 path a block reads 1.4x slower); at K=8192 tiles of 32 on
    256 threads, slices of 16 rows; at K=65536 tiles of 16 on 128 threads,
    3 blocks an SM (12 warps, 8 at tile 32), slices of 8 rows in 2
    buffers.  The tile halves while a block does not fit.  Raises
    ValueError on a forced layout the kernel does not take or whose block
    does not fit."""
    cols = _stopped_block_cols(widths, d_in)

    def fits(lay):
        return (_stopped_fwd_block_bytes(widths, d_in, d, lay, cols)
                <= _SMEM_LIMIT)

    if layout is not None:
        lay = _FwdBlockLayout(*layout)
        if (lay.tile not in _STOPPED_BLOCK_TILES
                or lay.threads % 32 or not 32 <= lay.threads
                <= _STOPPED_BLOCK_THREADS or lay.rows < 1
                or lay.stages not in (2, 3) or not fits(lay)):
            raise ValueError(
                f"block forward layout {lay}: tile in "
                f"{_STOPPED_BLOCK_TILES}, threads a multiple of 32 up to "
                f"{_STOPPED_BLOCK_THREADS}, rows >= 1, stages 2 or 3, a "
                f"block within {_SMEM_LIMIT} bytes")
        return lay
    lay = _FwdBlockLayout(*next(v for k, v in _STOPPED_BLOCK_BY_K
                                if k is None or K <= k))
    for t in _STOPPED_BLOCK_TILES:
        if t <= lay.tile and fits(lay._replace(tile=t)):
            return lay._replace(tile=t)
    raise _stopped_outside(
        f"{_stopped_fwd_block_bytes(widths, d_in, d, lay, cols)} bytes of the "
        f"block forward at tile 1 exceed the {_SMEM_LIMIT}-byte limit of "
        "one block")


def _stopped_wt(v_net: ConcatSkipNet) -> torch.Tensor:
    """The block forward's transposed net: per hidden layer W_l^T (width x
    padded(n_in), row-major: the nn.Linear weight, its columns padded to
    _CHUNK), one layer after the other."""
    parts, n_in = [], v_net.d_in
    for lin in v_net.layers[:-1]:
        w = lin.out_features
        WT = torch.zeros((w, _ceil_to(n_in, _CHUNK)), dtype=torch.float32,
                         device=lin.weight.device)
        WT[:, :n_in] = lin.weight.detach()
        parts.append(WT.reshape(-1))
        n_in += w
    return torch.cat(parts)


def _stopped_grid(K: int, tile: int, slots: int) -> int:
    """The backward's grid: one block per ``tile`` paths, at most ``slots``
    blocks (what the card holds at once), at least one."""
    return max(1, min(-(-K // tile), slots))


def _stopped_ranges(K: int, tile: int, grid: int) -> list:
    """The paths [lo, hi) of each of the backward's ``grid`` blocks:
    contiguous ranges of whole tiles, tiles floor(b T / grid) .. floor((b +
    1) T / grid) of the T = ceil(K / tile), the last cut at K - the formula
    of stopped_rollout.cu:range_start."""
    T = -(-K // tile)
    return [(min(K, tile * (b * T // grid)), min(K, tile * ((b + 1) * T
                                                          // grid)))
            for b in range(grid)]


class _StoppedLayout(NamedTuple):
    buf: torch.Tensor      # the packed net [+ lambda]
    widths: list           # hidden widths
    w_off: list            # per hidden layer: offset of W (n_in, padded w)
    b_off: list
    g_off: list            # per hidden layer: offset of its gradient block
    wL_off: int
    bL_off: int
    gL_off: int
    n_grad: int
    F: int                 # d_in + sum(widths)
    lam_off: int           # lambda's offset in buf, -1 without it
    g_lam: int             # its gradient entry (the last), -1 without it
    sig_off: int = -1      # a dense sigma's offset in buf, -1 without it


def _stopped_layout(v_net: ConcatSkipNet,
                    lam: Optional[torch.Tensor] = None,
                    sigma: Optional[torch.Tensor] = None) -> _StoppedLayout:
    """The concat-skip net in one buffer: per hidden layer W (n_in, width
    padded to _CHUNK) as (in, out) and its bias, then the output row and
    bias and, with ``lam``, lambda after them, and with ``sigma`` the (d, d)
    matrix row-major (no gradient); sections aligned to 4 floats.  And the layout
    of one block's gradient row: per hidden layer [W (n_in, width); b (1,
    width)], then [wL (F); bL] and, with ``lam``, d/dlambda."""
    dev = v_net.layers[0].weight.device
    parts, off = [], 0

    def add(t):
        nonlocal off
        t = t.detach().reshape(-1).to(torch.float32)
        at = off
        pad = _ceil_to(t.numel(), 4) - t.numel()
        parts.extend([t, torch.zeros(pad, dtype=torch.float32, device=dev)])
        off += t.numel() + pad
        return at

    widths, w_off, b_off, g_off = [], [], [], []
    n_in, n_grad = v_net.d_in, 0
    for lin in v_net.layers[:-1]:
        w = lin.out_features
        wp = _ceil_to(w, _CHUNK)
        W = torch.zeros((n_in, wp), dtype=torch.float32, device=dev)
        W[:, :w] = lin.weight.detach().T
        bias = torch.zeros(wp, dtype=torch.float32, device=dev)
        bias[:w] = lin.bias.detach()
        widths.append(w)
        w_off.append(add(W))
        b_off.append(add(bias))
        g_off.append(n_grad)
        n_grad += (n_in + 1) * w
        n_in += w
    out = v_net.layers[-1]
    wL_off, bL_off = add(out.weight[0]), add(out.bias)
    gL_off = n_grad
    n_grad += n_in + 1
    lam_off = g_lam = -1
    if lam is not None:
        lam_off, g_lam = add(lam), n_grad
        n_grad += 1
    sig_off = -1 if sigma is None else add(sigma)
    return _StoppedLayout(torch.cat(parts), widths, w_off, b_off, g_off,
                          wL_off, bL_off, gL_off, n_grad, n_in, lam_off,
                          g_lam, sig_off)


def _pad_hidden(vals: list) -> list:
    return vals + [0] * (_MAX_HIDDEN - len(vals))


# StoppedArgs' ints; then StoppedExt's (sig_off, vref, feat, hfam) from
# _STOPPED_N_INTS, and the launch's ints after them; StoppedArgs' floats,
# then StoppedExt's
_STOPPED_N_INTS = 16 + 4 * _MAX_HIDDEN + 6
_STOPPED_N_FLOATS = 13
_STOPPED_N_EXT_INTS, _STOPPED_N_EXT_FLOATS = 4, 10
_STOPPED_N_PACKED_INTS = _STOPPED_N_INTS + _STOPPED_N_EXT_INTS


def _stopped_full(packed: _Packed) -> bool:
    """A dense sigma in the packed net (StoppedExt.sig_off >= 0)."""
    return packed.iargs[_STOPPED_N_INTS] >= 0


def _stopped_unclocked(geom: str, sig_off: int, vref: str, c_ys1) -> bool:
    """Whether a call carries a breadth term that goes without the clock
    (csrc unclocked): the two spheres, a dense sigma, the committor's
    reference, c_ys1.  Their instantiations have no block forward
    (ROADMAP.md Queue 2 item 4(f)); the backward's lanes kernel takes them
    on a scalar sigma."""
    return (geom == "two_spheres" or sig_off >= 0 or vref != "exp_r2"
            or c_ys1 != 0.0)


def _stopped_instance(packed: _Packed) -> tuple:
    """What picks the kernels' instantiation of a packed call (csrc
    with_family): the clock, the geometry, the output clamp, and the
    breadth terms (StoppedExt: the dense sigma, the reference, c_ys1,
    c_y3), then the feature map and the Schroedinger family."""
    ia, fa = packed.iargs, packed.fargs
    return (ia[14], ia[15], ia[16 + 4 * _MAX_HIDDEN + 3],
            *ia[_STOPPED_N_INTS:_STOPPED_N_INTS + 2],
            fa[_STOPPED_N_FLOATS + 1] != 0.0,
            fa[_STOPPED_N_FLOATS + 5] != 0.0,
            *ia[_STOPPED_N_INTS + 2:_STOPPED_N_PACKED_INTS])


def _pack_stopped(problem, v_net, hfam, vfam, K, N, delta_t, tile, *,
                  backward, host_noise, adaptive_forward, rng,
                  time_stopping=False, lam=None, fwd_layout=None,
                  plan=None, bwd_layout=None, fwd_kernel=None,
                  fwd_block=None) -> _Packed:
    """The stopped kernels' arguments (stopped_rollout.cu: StoppedArgs,
    then StoppedExt: ints [sig_off, vref, feat, hfam], floats [r_in, c_ys1,
    the committor's a^2, a^d, a^2 - c^(2-d) a^d, c_y3, and the
    Schroedinger family's -1/c^2, 1/c, 2/d and 1/d, Python floats that
    the float32 arguments round as JAX's weak types round them]).  The
    state has d rows and the net d_in = d (+ 1 with time_stopping) input
    rows; F and the hidden rows H count from d_in.  The square's families
    (the torus and the Schroedinger family) always carry lambda in the
    packed net (``lam``, or 0 without it) and its gradient entry; a diag
    or full sigma is packed after the net as a (d, d) matrix.  The
    forward's
    ``layout`` is ``_stopped_fwd_layout``'s ``_FwdLayout`` (the lanes
    kernel, ``fwd_layout`` where given) where its net is staged, else
    ``_stopped_fwd_block_layout``'s ``_FwdBlockLayout`` (the block
    kernel; ``fwd_block`` forces a layout); ``fwd_kernel`` ('lanes' or
    'block') forces the kernel; the block kernel outside its families
    (the ball, the clock's families and the torus) raises.  The backward's
    is ``_stopped_bwd_plan``'s, ("shared",) or ("device", tpp, smem), the
    device plan first for the Schroedinger family and the breadth families
    without the clock on a scalar sigma (the committor's) (``plan`` forces
    a plan, ``bwd_layout`` a device-plan ``_BwdLayout``)."""
    d = problem.d
    geom = problem.geometry
    square = hfam[0] in _SQUARE_FAMILIES
    sch = hfam[0] == "schrodinger"
    if square and lam is None:
        lam = torch.zeros(1, dtype=torch.float32, device=problem.X_0.device)
    sig = problem.sigma_struct
    full = sig.kind != "scalar"
    lay = _stopped_layout(v_net, lam if square else None,
                          sig.mat if full else None)
    H = lay.F - v_net.d_in
    per_path = _stopped_per_path(lay.F, H, d, backward, full)
    n_params = lay.buf.numel()
    c_ys1 = c_y3 = 0.0
    if square:
        c_y = c_yr2 = k_exp = k_t = 0.0
        phi, c_tor = "none", 0.0 if sch else float(hfam[1])
    else:
        _, c_y, c_yr2, k_exp, phi, k_t, c_ys1, c_y3 = hfam
        c_tor = 0.0
    # the ball's reference exp(a_vref |x|^2), or the committor's constants
    vref, a_vref, vr = "exp_r2", 0.0, [0.0, 0.0, 0.0]
    if vfam is not None and not square:
        vref = vfam[0]
        if vref == "exp_r2":
            a_vref = float(vfam[1])
        else:
            a, c, dv = (float(v) for v in vfam[1:])
            vr = [a ** 2, a ** dv, a ** 2 - c ** (2 - dv) * a ** dv]
    # the block forward's families; the backward's lanes kernel takes every
    # family but a dense sigma, and two of them first: their notebooks' K
    # leave the shared plan's one-thread paths on a few SMs (PERF.md
    # section 6, rows 5s and 5c)
    unclocked = _stopped_unclocked(geom.kind, lay.sig_off, vref, c_ys1)
    block_family = not (sch or unclocked)
    n_stage = _stopped_fwd_net_floats(n_params, lay.widths, v_net.d_in)
    if backward:
        tile, stage, fwd = _stopped_bwd_plan(
            n_params, per_path, tile, plan, device_ok=not full,
            n_stage=n_stage, K=K, layout=bwd_layout,
            lanes_first=sch or (unclocked and not full))
    else:
        if fwd_kernel not in (None, *STOPPED_FWD_KERNELS):
            raise ValueError(f"fwd_kernel={fwd_kernel!r} must be one of "
                             f"{STOPPED_FWD_KERNELS}")
        kernel = ("lanes" if fwd_layout is not None
                  else "block" if fwd_block is not None else fwd_kernel)
        if kernel != "block":
            try:
                fwd, stage = _stopped_fwd_layout(
                    lay.widths, geom.kind, K, n_stage, per_path, tile,
                    fwd_layout)
            except ValueError:
                if kernel == "lanes" or not block_family:
                    raise
                stage = False
            if kernel is None and not stage:
                kernel = "block"
        if kernel == "block":
            if not block_family:
                raise _stopped_outside(
                    "the block forward (the forward of nets that no block "
                    "stages) is not instantiated for the breadth families "
                    "without time_stopping (the two spheres, a dense sigma, "
                    "the committor's reference, c_ys1) and the Schroedinger "
                    "family; ROADMAP.md Queue 2 item 4(f)")
            fwd = _stopped_fwd_block_layout(lay.widths, v_net.d_in, d, K,
                                            fwd_block)
            stage = False
        tile = fwd.tile
    two = geom.kind == "two_spheres"
    iargs = [K, N, d, len(lay.widths), lay.F, tile, int(stage), n_params,
             int(host_noise is not None), int(adaptive_forward),
             RNG_MAPS.index(rng), _PHI.index(phi), int(vfam is not None),
             lay.n_grad, int(time_stopping), _GEOMETRIES.index(geom.kind)]
    iargs += (_pad_hidden(lay.widths) + _pad_hidden(lay.w_off)
              + _pad_hidden(lay.b_off) + _pad_hidden(lay.g_off))
    iargs += [lay.wL_off, lay.bL_off, lay.gL_off, int(v_net.output_relu),
              lay.lam_off, lay.g_lam]
    iargs += [lay.sig_off, _VREFS.index(vref),
              _FEATURES.index(v_net.feature), int(sch)]
    dt, sq_dt = step_constants(delta_t)
    fargs = [dt, sq_dt, 0.0 if full else sig.scale,
             float(geom.boundary_distance_2 if two
                   else geom.boundary_distance), float(c_y), float(c_yr2),
             float(k_exp), a_vref,
             float(problem.T) if time_stopping else 0.0, float(k_t),
             float(geom.X_l) if square else 0.0,
             float(geom.X_r) if square else 0.0, c_tor]
    fargs += [float(geom.boundary_distance_1) if two else 0.0,
              float(c_ys1)] + vr + [float(c_y3)]
    fargs += ([-1.0 / hfam[1] ** 2, 1.0 / hfam[1], 2.0 / d, 1.0 / d] if sch
              else [0.0] * 4)
    return _Packed(lay.buf, iargs, fargs, layout=fwd)


class _StoppedCall(NamedTuple):
    """One ``fused_stopped_train_rollout`` call: what the backward
    replays."""
    problem: object
    v_net: torch.nn.Module
    X0: torch.Tensor
    t0: torch.Tensor
    N: int
    delta_t: float
    seed: Seed               # as _TrainCall's
    families: tuple          # (h_family, v_ref_family)
    opts: dict               # adaptive_forward, rng, host_noise and,
                             # where set, time_stopping
    tile: Optional[int]
    lam: Optional[torch.Tensor] = None   # the torus family's lambda leaf
    fwd_layout: Optional[tuple] = None   # a forced _FwdLayout of the forward
    plan: Optional[str] = None           # a forced plan of the backward
    bwd_layout: Optional[tuple] = None   # a forced _BwdLayout (device plan)
    fwd_kernel: Optional[str] = None     # a forced forward: 'lanes', 'block'
    fwd_block: Optional[tuple] = None    # a forced _FwdBlockLayout

    def plain(self) -> FusedStoppedOut:
        return reference_stopped_train_rollout(
            self.problem, self.v_net, self.X0, self.t0, self.N, self.delta_t,
            host_seed(self.seed), with_v_ref=self.families[1] is not None,
            lam=self.lam, **self.opts)

    def pack(self, backward: bool) -> _Packed:
        o = self.opts
        return _pack_stopped(
            self.problem, self.v_net, *self.families, self.X0.shape[0],
            self.N, self.delta_t, self.tile, backward=backward,
            host_noise=o["host_noise"],
            adaptive_forward=o["adaptive_forward"], rng=o["rng"],
            time_stopping=o.get("time_stopping", False), lam=self.lam,
            fwd_layout=self.fwd_layout, plan=self.plan,
            bwd_layout=self.bwd_layout, fwd_kernel=self.fwd_kernel,
            fwd_block=self.fwd_block)


# the forward's occupancy per (device, tile, tpp, shared bytes,
# instantiation): asked of the library once
_STOPPED_FWD_OCC: dict = {}


def _stopped_fwd_block_of(packed: _Packed) -> Optional[_FwdBlockLayout]:
    """The block forward's ``_FwdBlockLayout`` of a packed forward call;
    None where it runs the lanes kernel."""
    return (packed.layout if isinstance(packed.layout, _FwdBlockLayout)
            else None)


def _stopped_fwd_block_ints(packed: _Packed, grid: int) -> list:
    """The ints a block forward's launch (or its occupancy query) takes
    after the packed ones: [threads, cap, stages, grid], the ring's cap the
    layout's rows of the widest matrix (stopped_rollout.cu:
    unpack_block_layout)."""
    ia = packed.iargs
    lay = _stopped_fwd_block_of(packed)
    cols = _stopped_block_cols(ia[16:16 + ia[3]], ia[2] + ia[14])
    return [lay.threads, lay.rows * cols, lay.stages, grid]


def _stopped_fwd_smem_bytes(packed: _Packed) -> int:
    """Shared memory of one forward block of a packed call (the formula of
    stopped_rollout.cu:smem_floats, or of block_smem_floats for the block
    forward)."""
    ia = packed.iargs
    d, L, F, tile, stage, n_params = ia[2], ia[3], ia[4], ia[5], ia[6], ia[7]
    d_in = d + ia[14]
    block = _stopped_fwd_block_of(packed)
    if block is not None:
        return _stopped_fwd_block_bytes(
            ia[16:16 + L], d_in, d, block,
            _stopped_block_cols(ia[16:16 + L], d_in))
    n_stage = _stopped_fwd_net_floats(n_params, ia[16:16 + L], d_in)
    return _stopped_smem_bytes(
        n_stage if stage else 0,
        _stopped_per_path(F, F - d_in, d, False, _stopped_full(packed)),
        tile)


def _stopped_fwd_occupancy(packed: _Packed, dev: torch.device) -> dict:
    """The forward's launch for one packed call on CUDA device ``dev``: its
    blocks resident on one SM (stopped_rollout.cu:
    pspde_stopped_fwd_occupancy, or pspde_stopped_fwd_block_occupancy for
    the block forward: the runtime's theoretical residency), threads a
    block, warps an SM, bytes of shared memory a block, the SMs, and the
    layout."""
    ia = packed.iargs
    block = _stopped_fwd_block_of(packed)
    lay = block if block is not None else _FwdLayout(*packed.layout)
    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    key = (index, type(lay).__name__, *lay, _stopped_fwd_smem_bytes(packed),
           _stopped_instance(packed))
    if key not in _STOPPED_FWD_OCC:
        from ._build import library
        lib = library()
        out = (ctypes.c_int * 4)()
        if block is not None:
            entry = lib.pspde_stopped_fwd_block_occupancy
            iargs = ia + _stopped_fwd_block_ints(packed, 0)
        else:
            entry = lib.pspde_stopped_fwd_occupancy
            iargs = ia + [lay.tpp]
        err = entry((ctypes.c_int * len(iargs))(*iargs),
                    (ctypes.c_float * len(packed.fargs))(*packed.fargs),
                    index, out)
        if err != 0 or out[0] < 1:
            raise RuntimeError(
                "fused_stopped_train_rollout: the forward kernel fits no "
                f"block of layout {lay} on the card: "
                + lib.pspde_cuda_error_string(err).decode())
        _STOPPED_FWD_OCC[key] = list(out)
    blocks, threads, smem, sms = _STOPPED_FWD_OCC[key]
    return {"blocks_per_sm": blocks, "threads": threads,
            "warps_per_sm": blocks * threads // 32, "smem_bytes": smem,
            "sms": sms, **lay._asdict()}


def _stopped_fwd_grid(packed: _Packed, dev: torch.device) -> int:
    """The forward's grid: with refilled lanes ``_stopped_grid`` of the
    blocks the card holds at once, else (and in the block forward) one
    block per tile paths."""
    K = packed.iargs[0]
    if _stopped_fwd_block_of(packed) is not None:
        return -(-K // packed.iargs[5])
    lay = _FwdLayout(*packed.layout)
    if not lay.refill:
        return -(-K // lay.tile)
    occ = _stopped_fwd_occupancy(packed, dev)
    return _stopped_grid(K, lay.tile, occ["blocks_per_sm"] * occ["sms"])


def _stopped_forward_launch(call: _StoppedCall):
    """The forward kernel's outputs and what its lanes ran: (grid, tile)
    int32, each lane's trips (the steps of all the paths it carried; in
    the block forward each path's steps).  Counted in
    ``fused_stopped_train_rollout.launches`` and, per kernel,
    ``.launches_by_kernel``."""
    X0 = call.X0
    K, d = X0.shape
    packed = call.pack(backward=False)
    block = _stopped_fwd_block_of(packed)
    tile = packed.iargs[5]
    grid = _stopped_fwd_grid(packed, X0.device)
    X = torch.empty((K, d), dtype=torch.float32, device=X0.device)
    acc = torch.empty((6, K), dtype=torch.float32, device=X0.device)
    # the queue's path counter (0), then each lane's trips
    queue = torch.zeros(1 + grid * tile, dtype=torch.int32,
                        device=X0.device)
    if block is not None:
        _launch("pspde_stopped_rollout_fwd_block",
                "fused_stopped_train_rollout",
                packed._replace(iargs=packed.iargs
                                + _stopped_fwd_block_ints(packed, grid)),
                [packed.params, _stopped_wt(call.v_net),
                 call.opts["host_noise"], X0, call.t0, X, acc, queue],
                call.seed, X0.device)
    else:
        _launch("pspde_stopped_rollout_fwd", "fused_stopped_train_rollout",
                packed._replace(iargs=packed.iargs
                                + [_FwdLayout(*packed.layout).tpp, grid]),
                [packed.params, call.opts["host_noise"], X0, call.t0, X, acc,
                 queue], call.seed, X0.device)
    if not _capturing(X0.device):
        fst = fused_stopped_train_rollout
        fst.launches += 1
        fst.launches_by_kernel["lanes" if block is None else "block"] += 1
    return (FusedStoppedOut(X, acc[0], acc[5], *acc[1:5]),
            queue[1:].view(grid, tile))


def _stopped_forward_kernel(call: _StoppedCall) -> FusedStoppedOut:
    return _stopped_forward_launch(call)[0]


def _stopped_grads_from_row(v_net: ConcatSkipNet, lay: _StoppedLayout,
                            total: torch.Tensor) -> list:
    """One summed gradient row -> the gradients of ``v_net.parameters()``
    (weight (out, in) and bias per layer)."""
    grads, n_in = [], v_net.d_in
    for w, g0 in zip(lay.widths, lay.g_off):
        G = total[g0:g0 + (n_in + 1) * w].reshape(n_in + 1, w)
        grads += [G[:n_in].T.contiguous(), G[n_in].contiguous()]
        n_in += w
    grads += [total[lay.gL_off:lay.gL_off + lay.F][None].contiguous(),
              total[lay.gL_off + lay.F:lay.gL_off + lay.F + 1].contiguous()]
    return grads


# blocks of the backward the card holds at once, per (device, tile, shared
# bytes, instantiation): asked of the library once
_STOPPED_BWD_SLOTS: dict = {}


def _stopped_bwd_per_path(packed: _Packed) -> int:
    """The backward's per-path floats of one packed call."""
    ia = packed.iargs
    d, F = ia[2], ia[4]
    return _stopped_per_path(F, F - d - ia[14], d, True,
                             _stopped_full(packed))


def _stopped_bwd_lane_of(packed: _Packed) -> Optional[_BwdLayout]:
    """The device plan's ``_BwdLayout`` of a packed backward call; None in
    the shared plan."""
    if packed.layout[0] != "device":
        return None
    ia = packed.iargs
    return _BwdLayout(ia[5], packed.layout[1], bool(packed.layout[2]),
                      bool(ia[6]))


def _stopped_bwd_ts(packed: _Packed, grid: Optional[int] = None) -> int:
    """The backward's stride for one packed call: in the shared plan
    ``_stopped_bwd_stride`` of its tile, staged net and per-path floats; in
    the device plan tile + 4 where the lanes' arrays sit in shared memory,
    else the workspace's, grid x tile (``_stopped_bwd_ws``)."""
    ia = packed.iargs
    tile, stage, n_params = ia[5], ia[6], ia[7]
    lay = _stopped_bwd_lane_of(packed)
    if lay is not None:
        return (tile + 4 if lay.smem else
                _stopped_bwd_ws(_stopped_bwd_per_path(packed), tile, grid))
    return _stopped_bwd_stride(n_params if stage else 0,
                               _stopped_bwd_per_path(packed), tile)


def _stopped_bwd_smem(packed: _Packed, ts: int) -> int:
    """Shared bytes of one backward block (stopped_rollout.cu:smem_floats,
    stopped_bwd_lanes.cu:lane_smem_floats): in the shared plan the ballots,
    the staged net and the per-path arrays at stride ``ts``; in the device
    plan ``_stopped_bwd_lane_bytes``."""
    ia = packed.iargs
    tile, stage, n_params = ia[5], ia[6], ia[7]
    lay = _stopped_bwd_lane_of(packed)
    if lay is not None:
        d_in = ia[2] + ia[14]
        return _stopped_bwd_lane_bytes(
            _stopped_fwd_net_floats(n_params, ia[16:16 + ia[3]], d_in),
            _stopped_bwd_per_path(packed), lay)
    return _stopped_smem_bytes(n_params if stage else 0,
                               _stopped_bwd_per_path(packed), tile, True, ts)


def _stopped_bwd_layout_ints(packed: _Packed, ts: int, grid: int) -> list:
    """The ints a backward launch (or its slots' query) takes after the
    packed ones: [ts, grid, plan], and in the device plan tpp and whether
    the lanes' arrays sit in shared memory after them
    (stopped_rollout.cu:unpack_bwd_layout, stopped_bwd_lanes.cu:
    unpack_lane_layout)."""
    plan = packed.layout[0]
    return [ts, grid, PLANS.index(plan)] + list(packed.layout[1:])


def _stopped_bwd_slots(packed: _Packed, dev: torch.device) -> int:
    """The backward's blocks that CUDA device ``dev`` holds at once for one
    packed call (stopped_rollout.cu: pspde_stopped_bwd_slots, asked once
    per device, layout, shared memory and instantiation)."""
    ia = packed.iargs
    tile = ia[5]
    # the workspace's stride waits for the grid: the query reads none
    lay = _stopped_bwd_lane_of(packed)
    ts = (_stopped_bwd_ts(packed) if lay is None or lay.smem else tile)
    smem = _stopped_bwd_smem(packed, ts)
    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    key = (index, tile, smem, _stopped_instance(packed), packed.layout)
    if key not in _STOPPED_BWD_SLOTS:
        from ._build import library
        lib = library()
        slots = ctypes.c_int(0)
        ia = ia + _stopped_bwd_layout_ints(packed, ts, 0)
        err = lib.pspde_stopped_bwd_slots(
            (ctypes.c_int * len(ia))(*ia),
            (ctypes.c_float * len(packed.fargs))(*packed.fargs), index,
            ctypes.byref(slots))
        if err != 0 or slots.value < 1:
            raise RuntimeError(
                "fused_stopped_train_rollout: the backward kernel fits no "
                "block on the card: "
                + lib.pspde_cuda_error_string(err).decode())
        _STOPPED_BWD_SLOTS[key] = slots.value
    return _STOPPED_BWD_SLOTS[key]


def _stopped_bwd_grid(packed: _Packed, dev: torch.device) -> int:
    """The backward's grid for one packed call on CUDA device ``dev``: on
    the sphere and the two spheres ``_stopped_grid`` of the blocks its
    kernel keeps resident on the card (``_stopped_bwd_slots``), whose lanes
    are refilled as paths exit; on the whole space and the torus, where
    paths run their N steps and a refill gains nothing, one block per tile
    paths (the block scheduler balances the SMs)."""
    ia = packed.iargs
    K, tile = ia[0], ia[5]
    if _GEOMETRIES[ia[15]] not in _EXITS:
        return -(-K // tile)
    return _stopped_grid(K, tile, _stopped_bwd_slots(packed, dev))


def _stopped_backward_rows(call: _StoppedCall, gY,
                           grid: Optional[int] = None):
    """The backward kernel's per-block gradient rows (grid, n_grad) and
    what each block ran, (grid, 2) int32: its block-steps and its busy
    lanes summed over them.  Each block replays its range of paths
    (``_stopped_ranges``) and writes the sums of their steps.  In the
    device plan the lanes' arrays sit in shared memory or in a workspace
    of per-path rows x grid x tile floats (``_stopped_bwd_ws``), which the
    kernel zeroes a lane's rows of as it takes a path.
    ``grid`` forces the grid (1 .. ceil(K / tile)), so that two plans can
    be held to each other's rows."""
    X0 = call.X0
    packed = call.pack(backward=True)
    plan = packed.layout[0]
    if grid is None:
        grid = _stopped_bwd_grid(packed, X0.device)
    ts = _stopped_bwd_ts(packed, grid)
    lay = _stopped_bwd_lane_of(packed)
    part = torch.empty((grid, packed.iargs[13]), dtype=torch.float32,
                       device=X0.device)
    ws = (torch.empty(_stopped_bwd_per_path(packed) * ts,
                      dtype=torch.float32, device=X0.device)
          if lay is not None and not lay.smem else None)
    counts = torch.empty((grid, 2), dtype=torch.int32, device=X0.device)
    _launch("pspde_stopped_rollout_bwd", "fused_stopped_train_rollout",
            packed._replace(iargs=packed.iargs
                            + _stopped_bwd_layout_ints(packed, ts, grid)),
            [packed.params, call.opts["host_noise"], X0, call.t0,
             gY.contiguous(), part, counts, ws], call.seed, X0.device)
    if not _capturing(X0.device):
        fused_stopped_train_rollout.backward_launches += 1
        fused_stopped_train_rollout.backward_launches_by_plan[plan] += 1
    return part, counts


def _stopped_backward_kernel(call: _StoppedCall, gY) -> list:
    """The parameters' gradients (and lambda's last, with ``call.lam``)."""
    total = _stopped_backward_rows(call, gY)[0].sum(dim=0)
    lay = _stopped_layout(call.v_net, call.lam)
    grads = _stopped_grads_from_row(call.v_net, lay, total)
    if call.lam is not None:
        grads.append(total[lay.n_grad - 1:].reshape(call.lam.shape))
    return grads


@torch.no_grad()
def _reference_stopped_backward(call: _StoppedCall, gY) -> list:
    """Plain version of the backward kernel, its math in batched torch:
    replay the plain forward's X chain and masks, and accumulate per step
    d/dtheta [alpha V(X) + w^T grad V(X)] with alpha = gY adv (-dh/dy) dt
    and w = gY adv s (xi sqrt(dt) + c dt), by one tangent sweep through the
    net in direction w and one reverse sweep over the pair; dh/dy of
    the 'ball_exp' family c_y + c_yr2 |X|^2 + c_ys1 (sum_j X_j)^2 + 3 c_y3
    V^2 - 2 V phi'(u), of the 'schrodinger' family -3 V^2 - pot(X).  The
    features are relu(h)^2 (f' = 2 relu(h) h', f'' = 2 [h > 0]) or, for a
    tanh net, tanh(h) (f' = (1 - f^2) h', f'' = -2 f (1 - f^2)).  With
    ``time_stopping`` the primal sweep starts from [X, t] and the tangent
    has a zero in the t slot (Z is the gradient in x only).  With the
    output clamp both terms carry the mask 1[V > 0].  With ``call.lam``
    dh/dy gains lambda, and d/dlambda = sum -gY adv V dt comes last."""
    problem, net = call.problem, call.v_net
    seed = None if call.opts["host_noise"] is not None else host_seed(
        call.seed)
    X = call.X0.to(torch.float32)
    t = call.t0.to(torch.float32)
    K, d = X.shape
    sig = problem.sigma_struct
    dt, sq_dt = step_constants(call.delta_t)
    hfam = call.families[0]
    o = call.opts
    timed = o.get("time_stopping", False)
    vg = value_and_z(net, sig, space_time=timed)
    ins = inside_fn(problem.geometry)
    hidden, out = list(net.layers[:-1]), net.layers[-1]
    wL = out.weight[0]
    tanh = net.feature == "tanh"
    grads = [torch.zeros_like(p) for p in net.parameters()]
    lam = None if call.lam is None else call.lam.detach().reshape(())
    g_lam = torch.zeros((), dtype=torch.float32, device=X.device)
    stopped = torch.zeros((K,), dtype=torch.bool, device=X.device)
    for n in range(call.N):
        xi = (o["host_noise"][n] if o["host_noise"] is not None
              else train_normals(seed, K, n, d, o["rng"], X.device))
        active = ~stopped
        # the X chain and the masks, as the plain forward computes them
        V, Z = vg(X, t)
        c = -Z if o["adaptive_forward"] else torch.zeros_like(X)
        drift = (problem.b(X) + sig.apply(c)) * dt + sig.apply(xi) * sq_dt
        X_prop = X + drift * active[:, None].to(X.dtype)
        new_sel = ins(X, X_prop)
        if timed:
            new_sel = new_sel & ((t + dt) <= problem.T)
        adv = new_sel & active
        # this step's cotangents
        if hfam[0] == "torus_fp":
            # h is linear in y: dh/dy = h(x, 1)
            dh_dy = problem.h(X, torch.ones_like(V), Z)
        elif hfam[0] == "schrodinger":
            dh_dy = -3.0 * V * V - schrodinger_pot(X, hfam[1], d)
        else:
            _, c_y, c_yr2, k_exp, phi, k_t, c_ys1, c_y3 = hfam
            r2 = torch.sum(X * X, dim=-1)
            dh_dy = c_y + c_yr2 * r2
            if c_ys1 != 0.0:
                dh_dy = dh_dy + c_ys1 * torch.sum(X, dim=-1) ** 2
            if c_y3 != 0.0:
                dh_dy = dh_dy + 3.0 * c_y3 * V * V
            if phi != "none":
                u = torch.exp(k_exp * r2 + k_t * t) - V * V
                dh_dy = dh_dy - 2.0 * V * (1.0 if phi == "identity"
                                           else torch.cos(u))
        g = gY * adv.to(torch.float32)
        if lam is not None:
            dh_dy = dh_dy + lam
            g_lam += torch.sum(-g * V) * dt
        if net.output_relu:
            g = g * (V > 0).to(torch.float32)
        alpha = -g * dh_dy * dt
        w = g[:, None] * sig.apply(xi * sq_dt + c * dt)
        # primal and tangent sweeps
        f, fd, pre, hds = X, w, [], []
        if timed:
            f = torch.cat([X, t[:, None]], dim=-1)
            fd = torch.cat([w, torch.zeros_like(t)[:, None]], dim=-1)
        for lin in hidden:
            h = lin(f)
            hd = fd @ lin.weight.T
            pre.append(h)
            hds.append(hd)
            if tanh:
                th = torch.tanh(h)
                f = torch.cat([f, th], dim=-1)
                fd = torch.cat([fd, (1.0 - th * th) * hd], dim=-1)
            else:
                r = torch.relu(h)
                f = torch.cat([f, r * r], dim=-1)
                fd = torch.cat([fd, 2.0 * r * hd], dim=-1)
        # reverse sweep over the pair
        grads[-2] += (alpha[:, None] * f + fd).sum(dim=0)[None]
        grads[-1] += alpha.sum()[None]
        fb = alpha[:, None] * wL
        fdb = wL.expand(K, -1).clone()
        o_end = f.shape[1]
        for l in range(len(hidden) - 1, -1, -1):
            lin = hidden[l]
            w_l = lin.out_features
            o_l = o_end - w_l
            ab, adb = fb[:, o_l:o_end], fdb[:, o_l:o_end]
            if tanh:
                th = f[:, o_l:o_end]
                slope = 1.0 - th * th
                hb = slope * ab + (-2.0 * th * slope) * hds[l] * adb
                hdb = slope * adb
            else:
                r = torch.relu(pre[l])
                hb = (pre[l] > 0).to(torch.float32) * (2.0 * r * ab
                                                       + 2.0 * hds[l] * adb)
                hdb = 2.0 * r * adb
            grads[2 * l] += hb.T @ f[:, :o_l] + hdb.T @ fd[:, :o_l]
            grads[2 * l + 1] += hb.sum(dim=0)
            fb = fb[:, :o_l] + hb @ lin.weight
            fdb = fdb[:, :o_l] + hdb @ lin.weight
            o_end = o_l
        X = torch.where(adv[:, None], X_prop, X)
        if timed:
            t = t + dt * adv.to(torch.float32)
        stopped = stopped | ~new_sel
    if lam is not None:
        grads.append(g_lam.reshape(call.lam.shape))
    return grads


class _FusedStoppedFn(torch.autograd.Function):
    """Forward and replay backward of one stopped call.  Only Y carries a
    gradient (X chain and masks are parameter-free; X0 and t0 are sampled
    data); a None cotangent of Y counts as zeros.  The inputs are the net's
    parameters and, with ``call.lam``, lambda last."""

    @staticmethod
    def forward(ctx, call: _StoppedCall, *params):
        ctx.call = call
        ctx.set_materialize_grads(False)
        if call.X0.device.type == "cpu":
            out = call.plain()
            out = out._replace(t=out.t.clone())
        else:
            out = _stopped_forward_kernel(call)
        ctx.mark_non_differentiable(*(v for k, v in out._asdict().items()
                                      if k != "Y"))
        return tuple(out)

    @staticmethod
    def backward(ctx, gX, gY, *rest):
        call = ctx.call
        leaves = list(call.v_net.parameters())
        if call.lam is not None:
            leaves.append(call.lam)
        if gY is None:
            return (None,) + tuple(torch.zeros_like(p) for p in leaves)
        if call.X0.device.type == "cpu":
            grads = _reference_stopped_backward(call, gY)
        else:
            grads = _stopped_backward_kernel(call, gY)
        return (None,) + tuple(grads)


def fused_stopped_train_rollout(problem, v_net, X0: torch.Tensor,
                                t0: torch.Tensor, N: int, delta_t: float,
                                seed: Seed = 0, *,
                                adaptive_forward: bool = False,
                                rng: str = "erfinv",
                                host_noise: Optional[torch.Tensor] = None,
                                tile: Optional[int] = None,
                                time_stopping: bool = False,
                                lam: Optional[torch.Tensor] = None,
                                plan: Optional[str] = None
                                ) -> FusedStoppedOut:
    """Stopped training rollout of the K paths starting at X0 (K, d), t0
    (K,), over at most N steps with a detached forward: ``FusedStoppedOut``,
    differentiable in v_net's parameters (and ``lam``) through Y (a
    ``torch.autograd.Function`` whose backward replays the forward on the
    same noise).  Y_0 = V(X_0) and the terminal V(X_tau) stay with the
    caller.

    The device is the problem's: the net, X0, t0, ``lam`` and
    ``host_noise`` (N, K, d) must live there.  CPU: the plain version
    (forward, and ``_reference_stopped_backward``).  CUDA: the kernels of
    ``csrc/stopped_rollout.cu`` (the forward's lanes kernel where its net
    is staged, else the block kernel; the backward's shared plan) and
    ``csrc/stopped_bwd_lanes.cu`` (the backward's device plan), counted by
    ``fused_stopped_train_rollout.launches`` (per forward kernel:
    ``.launches_by_kernel``) and ``.backward_launches`` (per memory plan
    of the backward: ``.backward_launches_by_plan``).
    ``plan`` forces the backward's plan, 'shared' or 'device'
    (``_stopped_bwd_plan``; None: the Schroedinger family and the
    committor's device plan, the others shared where a block fits).
    Noise is ``host_noise`` or the Philox stream of ``seed`` through
    ``rng`` ('erfinv', the default, or 'binom'); on CUDA the seed is a
    device word as in ``fused_train_rollout``.  ``time_stopping`` (the
    general, space-time solver): the net reads [x, t], each path's clock
    starts at its t0, a step advances only while t + dt <= problem.T, and
    ``t`` returns the clock.  ``lam`` (the eigen solver, torus family): a
    one-element float32 tensor, the running cost h + lam y.  Raises
    ValueError outside ``STOPPED_KERNEL_FAMILY``, on the CPU and on CUDA
    alike."""
    families = _check_stopped_family(problem, v_net, rng, time_stopping,
                                     lam)
    _check_plan(plan)
    dev = problem.X_0.device
    K, d = X0.shape
    if d != problem.d:
        raise ValueError(f"X0 has {d} columns, the problem d={problem.d}")
    for name, p in v_net.named_parameters():
        _check_tensor(f"v_net.{name}", p, p.shape, dev)
    _check_tensor("X0", X0, (K, d), dev)
    _check_tensor("t0", t0, (K,), dev)
    if lam is not None:
        if lam.numel() != 1:
            raise ValueError(f"lam has {lam.numel()} elements, expected 1")
        _check_tensor("lam", lam, lam.shape, dev)
    if host_noise is not None:
        _check_tensor("host_noise", host_noise, (N, K, d), dev)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_stopped_train_rollout: no kernel for device "
                         f"{dev}")
    seed = (device_seed(seed, dev) if dev.type == "cuda"
            else host_seed(seed))
    call = _StoppedCall(problem, v_net, X0, t0, N, float(delta_t),
                        seed, families,
                        dict(adaptive_forward=adaptive_forward, rng=rng,
                             host_noise=host_noise,
                             time_stopping=bool(time_stopping)), tile, lam,
                        plan=plan)
    leaves = list(v_net.parameters()) + ([lam] if lam is not None else [])
    return FusedStoppedOut(*_FusedStoppedFn.apply(call, *leaves))


fused_stopped_train_rollout.launches = 0
fused_stopped_train_rollout.launches_by_kernel = dict.fromkeys(
    STOPPED_FWD_KERNELS, 0)
fused_stopped_train_rollout.backward_launches = 0
fused_stopped_train_rollout.backward_launches_by_plan = dict.fromkeys(PLANS,
                                                                      0)


# -- launch counts ----------------------------------------------------------
#
# Each wrapper counts the launches it makes (``.launches``,
# ``.backward_launches``, per plan ``.launches_by_plan``,
# ``.backward_launches_by_plan``, per kernel the stopped forward's
# ``.launches_by_kernel``).  The training kernels also count their own
# launches on the device: each launch gets the pointer of one 64-bit word
# of its device's count words (its count's, and its plan's or kernel's),
# to which its block 0's thread 0 adds one as it runs (csrc/common.cuh:
# count_launch).  A launch recorded in a CUDA graph's capture is made by the
# graph, at each replay: the wrapper counts none at capture, and the word
# counts each replay's (``kernel_launch_counts``).

# each C entry's (wrapper, count, what the count is kept by: 'plan' or
# 'kernel'), and the values of each
_COUNT_OF_ENTRY = {
    "pspde_train_rollout_fwd": ("fused_train_rollout", "launches", "plan"),
    "pspde_train_rollout_bwd": ("fused_train_rollout", "backward_launches",
                                "plan"),
    "pspde_stopped_rollout_fwd": ("fused_stopped_train_rollout", "launches",
                                  "kernel"),
    "pspde_stopped_rollout_fwd_block": ("fused_stopped_train_rollout",
                                        "launches", "kernel"),
    "pspde_stopped_rollout_bwd": ("fused_stopped_train_rollout",
                                  "backward_launches", "plan")}
_COUNT_BY = {"plan": PLANS, "kernel": STOPPED_FWD_KERNELS}
# the count words of a device, in this order: (wrapper, count, plan or
# kernel)
_COUNT_KEYS = list(dict.fromkeys(
    (fn, count, v) for fn, count, by in _COUNT_OF_ENTRY.values()
    for v in _COUNT_BY[by]))
_COUNT_WORDS: dict = {}   # device -> int64 tensor (len(_COUNT_KEYS),)


def _capturing(dev: torch.device) -> bool:
    """Whether work queued on ``dev``'s current stream is being captured in
    a CUDA graph (and so recorded, not run)."""
    return dev.type == "cuda" and torch.cuda.is_current_stream_capturing()


def _count_word(fn_name: str, packed: _Packed, dev: torch.device) -> int:
    """The pointer of the count word of a launch of the training entry
    ``fn_name`` with ``packed`` (its plan: the train entries' iargs[-2],
    the stopped backward's third after the packed ints; the stopped
    forward's kernel: its entry's) on ``dev``.  A device's words are made
    at its first launch, which comes before any capture (the chunk's
    warm-up step): made in a capture, they would be zeroed at each
    replay."""
    fn, count, by = _COUNT_OF_ENTRY[fn_name]
    if by == "kernel":
        sub = "block" if fn_name.endswith("_block") else "lanes"
    else:
        sub = PLANS[packed.iargs[_STOPPED_N_PACKED_INTS + 2]
                    if fn_name == "pspde_stopped_rollout_bwd"
                    else packed.iargs[-2]]
    words = _COUNT_WORDS.get(dev)
    if words is None:
        if _capturing(dev):
            raise RuntimeError(
                f"{fn}: the first launch on {dev} is inside a CUDA graph's "
                "capture: launch the step once eagerly first")
        words = _COUNT_WORDS[dev] = torch.zeros(
            len(_COUNT_KEYS), dtype=torch.int64, device=dev)
    return (words.data_ptr()
            + words.element_size() * _COUNT_KEYS.index((fn, count, sub)))


def _counted():
    return (fused_controlled_rollout, fused_train_rollout,
            fused_stopped_train_rollout)


def launch_counts() -> dict:
    """The kernel wrappers' counts of the launches they made, flat:
    {(wrapper, count): n} and {(wrapper, count_by_plan, plan): n},
    {(wrapper, count_by_kernel, kernel): n}."""
    out = {}
    for fn in _counted():
        for name, val in vars(fn).items():
            if name.endswith("launches"):
                out[(fn.__name__, name)] = val
            elif name.endswith(("launches_by_plan", "launches_by_kernel")):
                out.update(((fn.__name__, name, sub), v)
                           for sub, v in val.items())
    return out


def kernel_launch_counts() -> dict:
    """The training kernels' launches as they counted them on the device,
    summed over the devices (one read of each device's words): {(wrapper,
    count): n} and {(wrapper, count + '_by_plan', plan): n} (the stopped
    forward's {(wrapper, 'launches_by_kernel', kernel): n}), keyed as
    ``launch_counts``.  Every launch that ran is counted, a CUDA graph's
    replays' too."""
    totals = dict.fromkeys(_COUNT_KEYS, 0)
    for words in _COUNT_WORDS.values():
        for key, n in zip(_COUNT_KEYS, words.tolist()):
            totals[key] += n
    by = {(fn, count): b for fn, count, b in _COUNT_OF_ENTRY.values()}
    out = {}
    for (fn, count, sub), n in totals.items():
        out[(fn, count)] = out.get((fn, count), 0) + n
        out[(fn, f"{count}_by_{by[(fn, count)]}", sub)] = n
    return out


def reset_launch_counts() -> None:
    """Set every wrapper's counts and the kernels' count words to 0."""
    for fn in _counted():
        for name, val in list(vars(fn).items()):
            if name.endswith("launches"):
                setattr(fn, name, 0)
            elif name.endswith(("launches_by_plan", "launches_by_kernel")):
                setattr(fn, name, dict.fromkeys(val, 0))
    for words in _COUNT_WORDS.values():
        words.zero_()
