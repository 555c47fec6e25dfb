"""A-posteriori Monte-Carlo refinement of pointwise values (counterpart of
``pspde/eval/refine.py``).

For the GeneralSolver PDE family dv/dt + L v + h(t, x, v, sigma^T grad v)
= 0, v(T, .) = f_terminal, the value at (t0, x0) is
E[f(X_T) + int_t0^T h ds] along the UNCONTROLLED dynamics
dX = b dt + sigma dW; ``feynman_kac_refine`` re-estimates it by plain
Monte Carlo with the learned value plugged into h only, so the net's
systematic error contracts by ~ (T - t0) sup|dh/dy| while the MC error
falls as K^{-1/2}.  ``feynman_kac_refine_elliptic`` is the stopped-domain
variant for Dirichlet elliptic problems, with the Broadie-Glasserman-Kou
continuity correction of ``bgk_closures``.

Every function draws from a ``torch.Generator`` (or an int seed, 0 when
None) on the problem's device, or takes its normals from ``noise_fn(n)``
(the (K, d) normals of step n), the hook through which a test hands in
JAX's own draws.  The chains run on the problem's device in float32 under
``torch.no_grad`` (``with_z`` differentiates the net in x only).  A chain
whose rows stop (the stopped chain, ``picard._mc_targets``'s clock) drops
them from its working set and ends when none is left, which leaves every
output as a scan over all steps and rows gives it: the hook's normals are
indexed by the rows left, and the generator draws normals for these rows
only.

``reg_fit`` and ``rng`` are the correctors' shared parts
(``eval/picard.py``, ``eval/eigen_power.py``): the supervised refit with a
fresh Adam, as optax's ``adam`` from ``init``, and the generator
resolution.  The drivers refit a copy of the caller's net and return it;
load it into a trained solver's net with ``load_state_dict``, which copies
into the existing tensors, as a solver whose chunks run as captured CUDA
graphs needs.
"""

from __future__ import annotations

import warnings
from typing import Callable, NamedTuple, Optional, Union

import numpy as np
import torch

from ..utils.capture import gc_held

Seed = Union[None, int, torch.Generator]

# steps between the chains' checks of the rows still live: a chain ends
# when none is, and drops the others once half of its rows are
_STOP_CHECK_EVERY = 16
# eager Adam steps of a fit on CUDA before its step is captured (reg_fit)
_GRAPH_WARMUP = 3
# the relative move that puts a projected exit point on the far side of its
# sphere (bgk_closures)
_SNAP = 2.0 ** -21


class RefinedValue(NamedTuple):
    value: torch.Tensor    # () refined v(t0, x0)
    stderr: torch.Tensor   # () Monte-Carlo standard error
    direct: torch.Tensor   # () the raw net readout v_fn(x0, t0)
    # fraction of paths still inside the domain at N_cap (elliptic variant
    # only; such paths are force-projected onto the boundary)
    cap_frac: float = 0.0


def rng(generator: Seed, device) -> torch.Generator:
    """``generator`` itself, or a generator on ``device`` seeded with the
    int ``generator`` (0 when None, as JAX's default ``PRNGKey(0)``)."""
    if isinstance(generator, torch.Generator):
        return generator
    return torch.Generator(device=device).manual_seed(
        0 if generator is None else int(generator))


def _normals(noise_fn, gen, n, shape, device):
    if noise_fn is not None:
        return noise_fn(n)
    return torch.randn(shape, generator=gen, device=device)


def reg_fit(net: torch.nn.Module, inputs: torch.Tensor,
            targets: torch.Tensor, steps: int, lr: float):
    """Fit ``net`` in place to ``targets`` by ``steps`` full-batch Adam
    steps on mean((net(inputs)[:, 0] - targets)^2), from a fresh Adam at
    ``lr``.  Returns (net, the loss before the last update) as JAX's
    ``reg_fit`` returns ``ls[-1]``.  On CUDA the Adam is ``capturable``
    (its bias corrections in float32 on the device, as optax's) and the
    steps after the first ``_GRAPH_WARMUP`` replay one captured CUDA graph
    of a step, whose launches would otherwise take most of a small net's
    fit."""
    inputs, targets = inputs.detach(), targets.detach()
    cuda = inputs.device.type == "cuda"
    opt = torch.optim.Adam(net.parameters(), lr=lr, capturable=cuda)

    def step():
        opt.zero_grad(set_to_none=True)
        loss = torch.mean((net(inputs)[:, 0] - targets) ** 2)
        loss.backward()
        opt.step()
        return loss

    if not cuda or steps <= _GRAPH_WARMUP + 1:
        loss = torch.zeros(())
        for _ in range(steps):
            loss = step()
        return net, loss.detach()
    side = torch.cuda.Stream(device=inputs.device)
    side.wait_stream(torch.cuda.current_stream(inputs.device))
    with torch.cuda.stream(side):
        for _ in range(_GRAPH_WARMUP):
            step()
    torch.cuda.current_stream(inputs.device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with gc_held(), torch.cuda.graph(graph):
        loss = step()
    for _ in range(steps - _GRAPH_WARMUP):
        graph.replay()
    return net, loss.detach().clone()


def _f32(x) -> float:
    """A Python float holding the float32 value of ``x``."""
    return float(np.float32(x))


def feynman_kac_refine(problem, v_fn: Callable, x0: torch.Tensor,
                       t0: float = 0.0, K: int = 1_000_000,
                       delta_t: float = 1e-3, generator: Seed = None,
                       with_z: bool = False,
                       noise_fn: Optional[Callable] = None) -> RefinedValue:
    """One-shot Picard/Feynman-Kac refinement of v(t0, x0).  ``v_fn`` maps
    (X (K, d), t (K,)) to (K,); ``with_z`` passes z = sigma^T grad_x V to
    h.  N = ceil((T - t0) / delta_t) steps of dt = float32((T - t0) / N),
    t = t0 + n dt in float32; h gets the scalar t."""
    geom = problem.geometry
    if geom is not None and geom.bounded:
        raise ValueError("feynman_kac_refine: bounded domains need exit "
                         "stopping; use feynman_kac_refine_elliptic")
    dev = problem.X_0.device
    gen = None if noise_fn is not None else rng(generator, dev)
    d, T = problem.d, problem.T
    N = int(np.ceil((T - t0) / delta_t))
    dt = np.float32((T - t0) / N)
    sq_dt = float(np.sqrt(dt))
    sig = problem.sigma_struct

    def h_eval(t, X):
        ts = torch.full((K,), t, dtype=torch.float32, device=dev)
        if not with_z:
            return problem.h(t, X, v_fn(X, ts), None)
        with torch.enable_grad():
            Xg = X.detach().requires_grad_(True)
            V = v_fn(Xg, ts)
            (gX,) = torch.autograd.grad(V.sum(), Xg)
        return problem.h(t, X, V.detach(), sig.apply_T(gX))

    with torch.no_grad():
        X0 = x0.to(device=dev, dtype=torch.float32).expand(K, d)
        X, acc = X0, torch.zeros(K, device=dev)
        for n in range(N):
            t = float(np.float32(t0) + np.float32(n) * dt)
            acc = acc + h_eval(t, X) * float(dt)
            xi = _normals(noise_fn, gen, n, (K, d), dev)
            X = X + problem.b(X) * float(dt) + sig.apply(xi) * sq_dt
        per_path = problem.f_terminal(X) + acc
        mean = torch.mean(per_path)
        stderr = torch.std(per_path, correction=0) / _f32(np.sqrt(
            np.float32(K)))
        direct = torch.mean(v_fn(X0[:1], torch.full(
            (1,), _f32(t0), device=dev)))
    return RefinedValue(mean, stderr, direct)


def bgk_closures(problem, delta_t: float):
    """(inside, project) closures for discretely-monitored first-exit MC
    with the Broadie-Glasserman-Kou continuity correction: the stopping
    test runs against the domain SHRUNK by 0.5826 sigma_radial sqrt(dt) and
    exit states are radially projected onto the TRUE boundary.  'sphere'
    and 'two_spheres' Dirichlet geometries.

    One departure from pspde: a projected point whose rounded radius lies
    inside the domain (by an ulp) is moved out by 2^-21 of its radius, so
    that it reads its exit sphere's side in g.  pspde evaluates g at the
    point as rounded, where the committor's indicator g = (|x| > 1) reads 1
    for some of the exits onto the inner sphere
    (experiments/refine_reference.py --part committor_g counts them)."""
    geom = problem.geometry
    if geom is None or not geom.bounded:
        raise ValueError("bgk_closures needs a bounded Dirichlet geometry")
    if geom.kind not in ("sphere", "two_spheres"):
        raise ValueError(f"bgk_closures supports 'sphere' and "
                         f"'two_spheres', not {geom.kind!r}")
    sig_mat = problem.sigma_struct.mat.cpu().numpy()
    sig_radial = float(np.sqrt(np.max(np.diag(sig_mat @ sig_mat.T))))
    shift = 0.5826 * sig_radial * float(np.sqrt(delta_t))
    if geom.kind == "sphere":
        R_out, R_in = geom.boundary_distance, None
    else:
        R_out = geom.boundary_distance_2
        R_in = geom.boundary_distance_1

    def inside(X):
        r = torch.sqrt(torch.sum(X * X, dim=-1))
        ok = r < (R_out - shift)
        if R_in is not None:
            ok = ok & (r > (R_in + shift))
        return ok

    def project(X):
        r = torch.sqrt(torch.sum(X * X, dim=-1, keepdim=True))
        outer = (r > 0.5 * (R_in + R_out) if R_in is not None
                 else torch.ones_like(r, dtype=torch.bool))
        tgt = torch.where(outer, _f32(R_out), _f32(R_in or R_out))
        P = X * (tgt / torch.clamp_min(r, 1e-12))
        # the rounded point can land an ulp on the domain's side of its
        # sphere, where an indicator g (the committor's |x| > 1) reads the
        # other side; move such points off by 4 ulps of the radius
        rp = torch.sqrt(torch.sum(P * P, dim=-1, keepdim=True))
        wrong = torch.where(outer, rp < tgt, rp > tgt)
        return torch.where(wrong, P * torch.where(
            outer, 1.0 + _SNAP, 1.0 - _SNAP), P)

    return inside, project


def compact(rows, live, full, work):
    """Write the chain's working rows back into the full arrays and keep
    the live ones: (their indices, their working arrays).  A row that is no
    longer live never changes again, so the chain runs on without it."""
    for f, w in zip(full, work):
        f[rows] = w
    keep = torch.nonzero(live)[:, 0]
    return rows[keep], [w[keep] for w in work]


def stopped_chain(problem, v_fn, X0, N_cap, delta_t, gen, noise_fn):
    """The stopped Feynman-Kac chain of both elliptic correctors
    (``mc_targets_elliptic`` too): (X, acc, stopped) after N_cap steps,
    h accumulated only strictly inside the BGK-shrunk domain.  Every
    ``_STOP_CHECK_EVERY`` steps the stopped rows leave the working set once
    they are half of it (the hook's normals are indexed by the rows left),
    and the chain ends when no row is left: as a scan over all N_cap steps
    leaves every row."""
    dt = np.float32(delta_t)
    sq_dt = float(np.sqrt(dt))
    sig = problem.sigma_struct
    inside, _ = bgk_closures(problem, delta_t)
    R, d = X0.shape
    dev = X0.device
    full = [X0.clone(), torch.zeros(R, device=dev),
            torch.zeros(R, dtype=torch.bool, device=dev)]
    rows, (X, acc, stopped) = torch.arange(R, device=dev), list(full)
    for n in range(N_cap):
        ins = inside(X)
        active = ~stopped & ins
        h = problem.h(X, v_fn(X), None)
        acc = acc + torch.where(active, h, 0.0) * float(dt)
        if noise_fn is not None:
            xi = noise_fn(n)
            xi = xi if len(rows) == R else xi[rows]
        else:
            xi = torch.randn((len(rows), d), generator=gen, device=dev)
        Xp = X + problem.b(X) * float(dt) + sig.apply(xi) * sq_dt
        X = torch.where(active[:, None], Xp, X)
        stopped = stopped | ~ins
        if n % _STOP_CHECK_EVERY == _STOP_CHECK_EVERY - 1:
            n_live = int(torch.sum(~stopped))
            if n_live <= len(rows) // 2:
                rows, (X, acc, stopped) = compact(rows, ~stopped, full,
                                                  (X, acc, stopped))
            if n_live == 0:
                break
    for f, w in zip(full, (X, acc, stopped)):
        f[rows] = w
    return tuple(full)


def feynman_kac_refine_elliptic(problem, v_fn: Callable, x0: torch.Tensor,
                                K: int = 262_144, N_cap: int = 4096,
                                delta_t: float = 1e-3,
                                generator: Seed = None,
                                noise_fn: Optional[Callable] = None
                                ) -> RefinedValue:
    """Stopped-domain variant for Dirichlet elliptic problems:
    v(x0) = E[g(X_tau) + int_0^tau h(X_s, v(X_s), .) ds], tau the first
    exit time of the BGK-shrunk domain, g read at the radial projection of
    the exit state onto the true boundary.  ``v_fn`` maps X (K, d) to (K,).
    The Picard map contracts only when sup|dh/dy| E[tau] < 1 (pspde's
    docstring); with an accurate model the readout is an oracle.  Warns
    when more than 0.1% of the paths had not exited at N_cap."""
    dev = problem.X_0.device
    gen = None if noise_fn is not None else rng(generator, dev)
    inside, project = bgk_closures(problem, delta_t)
    with torch.no_grad():
        X0 = x0.to(device=dev, dtype=torch.float32).expand(K, problem.d)
        X, acc, stopped = stopped_chain(problem, v_fn, X0, N_cap, delta_t,
                                        gen, noise_fn)
        per_path = problem.g(project(X)) + acc
        mean = torch.mean(per_path)
        stderr = torch.std(per_path, correction=0) / _f32(np.sqrt(
            np.float32(K)))
        direct = torch.mean(v_fn(X0[:1]))
        cap_frac = float(torch.mean((~stopped & inside(X)).to(
            torch.float32)))
    if cap_frac > 1e-3:
        warnings.warn(
            "feynman_kac_refine_elliptic: %.2f%% of paths had not exited "
            "at N_cap=%d and were projected onto the boundary - the "
            "estimate is biased; raise N_cap" % (100 * cap_frac, N_cap),
            stacklevel=2)
    return RefinedValue(mean, stderr, direct, cap_frac)
