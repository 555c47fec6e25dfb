"""Multi-stage Picard refinement of a learned value function (counterpart
of ``pspde/eval/picard.py``).

Iterates the Feynman-Kac fixed point v(t, x) = E[f(X_T) + int_t^T
h(s, X_s, v(s, X_s), .) ds] around a trained net: each stage estimates the
right-hand side by Monte Carlo at M anchors with the CURRENT net inside h
(K_inner paths each, one flat ensemble) and refits a copy of the net to
these targets (``refine.reg_fit``: reg_steps full-batch Adam steps from a
fresh Adam).  The systematic error contracts by ~ (T - t) sup|dh/dy| a
stage, while the anchors' MC noise averages out in the regression.
``picard_refine_elliptic`` is the stopped-domain counterpart for the
EllipticSolver family, with the BGK exit correction (``refine.
bgk_closures``) and the anchors in slices of at most ``max_paths_per_call``
paths, each slice from its own generator.

The nets are ``nn.Module``s; a driver refines a copy and returns it.
Randomness comes from ``generator`` (a ``torch.Generator`` or an int seed,
0 when None) in JAX's order of draws: each stage's anchors, then its
targets' normals, then the readout's.  ``draws(stage)`` replaces them (the
hook through which a test hands in JAX's draws), as documented per
driver.
"""

from __future__ import annotations

import copy
import warnings
from typing import Callable, Optional

import numpy as np
import torch

from ..rollout.sampling import sample_domain
from .refine import (_STOP_CHECK_EVERY, Seed, bgk_closures, compact,
                     feynman_kac_refine, reg_fit, rng,
                     stopped_chain)


def _mc_targets(problem, v_fn, ts, Xs, K_inner, delta_t,
                generator: Seed = None,
                noise_fn: Optional[Callable] = None):
    """MC estimate of E[f(X_T) + int h ds] from each anchor (ts_i, Xs_i),
    as one flat (M K_inner, d) ensemble over N_max = ceil(T / delta_t)
    steps of dt = float32(delta_t); a row is active while t + 0.5 dt < T,
    and the rows past it leave the working set (``refine.compact``).
    ``problem.h`` gets the per-row time vector t (R,) and z = None."""
    M, d = Xs.shape
    T = problem.T
    dev = Xs.device
    gen = None if noise_fn is not None else rng(generator, dev)
    dt = np.float32(delta_t)
    half = float(np.float32(0.5) * dt)
    sq_dt = float(np.sqrt(dt))
    T32 = float(np.float32(T))
    sig = problem.sigma_struct
    N_max = int(np.ceil(T / delta_t))
    with torch.no_grad():
        X0 = torch.repeat_interleave(Xs, K_inner, dim=0)
        R = X0.shape[0]
        full = [X0.clone(), torch.repeat_interleave(ts, K_inner),
                torch.zeros(R, device=dev)]
        rows, (X, t, acc) = torch.arange(R, device=dev), list(full)
        for n in range(N_max):
            active = (t + half) < T32
            h = problem.h(t, X, v_fn(X, t), None)
            acc = acc + torch.where(active, h, 0.0) * float(dt)
            if noise_fn is not None:
                xi = noise_fn(n)
                xi = xi if len(rows) == R else xi[rows]
            else:
                xi = torch.randn((len(rows), d), generator=gen, device=dev)
            drift = problem.b(X) * float(dt) + sig.apply(xi) * sq_dt
            X = torch.where(active[:, None], X + drift, X)
            t = torch.where(active, t + float(dt), t)
            if n % _STOP_CHECK_EVERY == _STOP_CHECK_EVERY - 1:
                live = (t + half) < T32
                if int(torch.sum(live)) <= len(rows) // 2:
                    rows, (X, t, acc) = compact(rows, live, full, (X, t, acc))
        for f, w in zip(full, (X, t, acc)):
            f[rows] = w
        vals = problem.f_terminal(full[0]) + full[2]
        return torch.mean(vals.reshape(M, K_inner), dim=1)


def _tx(Xs, ts):
    return torch.cat([Xs, ts[:, None]], dim=-1)


def picard_refine(problem, net: torch.nn.Module,
                  x0: Optional[torch.Tensor] = None, n_stages: int = 2,
                  M: int = 4096, K_inner: int = 1024, delta_t: float = 1e-3,
                  anchor_radius: Optional[float] = None,
                  reg_steps: int = 3000, reg_lr: float = 1e-3,
                  generator: Seed = None, readout_K: int = 1_000_000,
                  verbose: bool = False, anchors: str = "tube",
                  draws: Optional[Callable] = None):
    """Run ``n_stages`` Picard stages on a copy of ``net`` (input [x, t]),
    then a ``readout_K``-path pointwise readout at x0
    (``feynman_kac_refine``).  Returns (value, stderr, refined net), or
    (None, None, refined net) when x0 is None.

    ``anchors='tube'``: t ~ U(0, T), x ~ x0 + sqrt(tr(sigma sigma^T) / d
    t) z (z standard normal; ``anchor_radius`` r instead scales z by
    r U(0, 1)).  ``anchors='domain'``: x ~ sample_domain(geometry),
    t ~ U(0, T) (the 'parabolic' test measure).

    ``draws(stage)`` replaces stage ``stage``'s draws by a dict with 'ts'
    (M,), 'Xs' (M, d) and 'noise' (n -> (M K_inner, d)); ``draws(
    'readout')`` gives the readouts' {'noise': n -> (readout_K, d)}."""
    if anchors not in ("tube", "domain"):
        raise ValueError(f"anchors must be 'tube' or 'domain': {anchors!r}")
    if anchors == "tube" and x0 is None:
        raise ValueError("anchors='tube' needs an x0 to draw the tube from")
    dev = problem.X_0.device
    gen = rng(generator, dev)
    d, T = problem.d, problem.T
    if x0 is not None:
        x0 = x0.to(device=dev, dtype=torch.float32)
    sig_mat = problem.sigma_struct.mat.cpu().numpy()
    spread = float(np.sqrt(np.trace(sig_mat @ sig_mat.T) / d))
    p = copy.deepcopy(net)

    def v_of(q):
        return lambda X, t: q(_tx(X, t))[:, 0]

    def readout():
        noise = None if draws is None else draws("readout")["noise"]
        return feynman_kac_refine(problem, v_of(p), x0, K=readout_K,
                                  delta_t=delta_t, generator=gen,
                                  noise_fn=noise)

    for stage in range(n_stages):
        if draws is not None:
            dr = draws(stage)
            ts, Xs, noise = dr["ts"], dr["Xs"], dr["noise"]
        else:
            noise = None
            ts = torch.rand((M,), generator=gen, device=dev) * T
            if anchors == "domain":
                Xs = sample_domain(gen, problem.geometry, M, d, device=dev)
            else:
                z = torch.randn((M, d), generator=gen, device=dev)
                if anchor_radius is None:
                    scale = torch.sqrt(ts)[:, None] * spread
                else:
                    scale = anchor_radius * torch.rand(
                        (M, 1), generator=gen, device=dev)
                Xs = x0[None, :] + scale * z
        targets = _mc_targets(problem, v_of(p), ts, Xs, K_inner, delta_t,
                              gen, noise)
        p, reg_loss = reg_fit(p, _tx(Xs, ts), targets, reg_steps, reg_lr)
        if verbose and x0 is not None:
            out = readout()
            print(f"  picard stage {stage}: reg_loss {float(reg_loss):.3e}"
                  f", refined v = {float(out.value):.6f}")
        elif verbose:
            print(f"  picard stage {stage}: reg_loss {float(reg_loss):.3e}")

    if x0 is None:
        return None, None, p
    out = readout()
    return out.value, out.stderr, p


def mc_targets_elliptic(problem, v_fn, Xs, K_inner, N_cap, delta_t,
                        generator: Seed = None,
                        noise_fn: Optional[Callable] = None):
    """Stopped Feynman-Kac MC targets at the anchors Xs (M, d):
    target_i = E[g(X_tau) + int_0^tau h(X_s, v(X_s), .) ds], X_0 = x_i,
    BGK-corrected (``refine.bgk_closures``).  Returns (targets (M,),
    cap_frac), cap_frac the fraction of paths force-projected at N_cap.
    h is called as h(x, y, None)."""
    M, d = Xs.shape
    dev = Xs.device
    gen = None if noise_fn is not None else rng(generator, dev)
    inside, project = bgk_closures(problem, delta_t)
    with torch.no_grad():
        X0 = torch.repeat_interleave(Xs, K_inner, dim=0)
        X, acc, stopped = stopped_chain(problem, v_fn, X0, N_cap, delta_t,
                                        gen, noise_fn)
        vals = problem.g(project(X)) + acc
        cap_frac = torch.mean((~stopped & inside(X)).to(torch.float32))
        return torch.mean(vals.reshape(M, K_inner), dim=1), cap_frac


def picard_refine_elliptic(problem, net: torch.nn.Module, n_stages: int = 2,
                           M: int = 4096, K_inner: int = 512,
                           N_cap: int = 4096, delta_t: float = 1e-3,
                           reg_steps: int = 3000, reg_lr: float = 1e-3,
                           damping: float = 1.0,
                           uniform_square: bool = False,
                           generator: Seed = None, verbose: bool = False,
                           max_paths_per_call: int = 1_048_576,
                           draws: Optional[Callable] = None):
    """Multi-stage Picard refinement of a copy of a trained ELLIPTIC value
    net (input x).  Each stage draws M anchors uniformly in the domain
    (``sample_domain``, ``uniform_square`` as there), estimates the
    stopped Feynman-Kac targets with the CURRENT net in h, in slices of
    max(1, min(M, max_paths_per_call // K_inner)) anchors, and refits the
    net.  ``damping`` < 1 averages the targets with the current net
    (Krasnoselskij).  Returns (refined net, history), a dict per stage
    with reg_loss and cap_frac (the slices' weighted by their sizes).

    Slice j of a stage draws from a generator of its own, seeded from the
    stage's draw of the main generator plus j (JAX's fold_in(kr, j)), so
    the targets do not depend on how far another slice's chain ran.
    ``draws(stage)`` replaces the stage's draws by a dict with 'Xs' (M, d)
    and 'noise' ((j, n) -> (slice rows K_inner, d))."""
    dev = problem.X_0.device
    gen = rng(generator, dev)
    d = problem.d
    p = copy.deepcopy(net)

    def v_of(q):
        return lambda X: q(X)[:, 0]

    per_slice = max(1, min(M, max_paths_per_call // max(K_inner, 1)))
    n_slices = -(-M // per_slice)

    def targets_chunked(Xs, kr, noise):
        ts, cf = [], 0.0
        for j in range(n_slices):
            sl = Xs[j * per_slice:(j + 1) * per_slice]
            if noise is not None:
                t, c = mc_targets_elliptic(
                    problem, v_of(p), sl, K_inner, N_cap, delta_t,
                    noise_fn=lambda n, j=j: noise(j, n))
            else:
                t, c = mc_targets_elliptic(problem, v_of(p), sl, K_inner,
                                           N_cap, delta_t, kr + j)
            ts.append(t)
            cf += float(c) * sl.shape[0]
        return torch.cat(ts), cf / M

    history = []
    for stage in range(n_stages):
        if draws is not None:
            dr = draws(stage)
            Xs, noise, kr = dr["Xs"], dr["noise"], None
        else:
            Xs = sample_domain(gen, problem.geometry, M, d,
                               uniform_square=uniform_square, device=dev)
            noise = None
            kr = int(torch.randint(0, 2 ** 62, (1,), generator=gen,
                                   device=dev))
        targets, cap_frac = targets_chunked(Xs, kr, noise)
        if damping < 1.0:
            with torch.no_grad():
                targets = ((1.0 - damping) * v_of(p)(Xs)
                           + damping * targets)
        p, reg_loss = reg_fit(p, Xs, targets, reg_steps, reg_lr)
        rec = {"reg_loss": float(reg_loss), "cap_frac": float(cap_frac)}
        history.append(rec)
        if verbose:
            print(f"  elliptic picard stage {stage}: "
                  f"reg_loss {rec['reg_loss']:.3e}, "
                  f"cap_frac {rec['cap_frac']:.2e}")
        if rec["cap_frac"] > 1e-3:
            warnings.warn(
                "picard_refine_elliptic: %.2f%% of target paths hit "
                "N_cap=%d - targets are biased; raise N_cap"
                % (100 * rec["cap_frac"], N_cap), stacklevel=2)
    return p, history
