"""The JAX package's bands for the three notebook recipes that
``chip_smoke.py`` phase 39 runs with the port.

Runs ``pspde`` on the CPU, each recipe at its script's widths and
settings, cut only in its step count:

  (a) ``experiments/parabolic_neumann.py``: ``GeneralSolver`` on
      ``ExponentialOnSphereNonlinearParabolic(d=20, T=1, alpha=1)`` with
      Neumann data, diffusion, N=20, delta_t 1e-3, K=200, K_boundary=50,
      alpha (1, 1, a2) for a2 in {0.1, 1, 10, 100}, lr 1e-3,
      K_test_log 10000, 100 steps a call; the readings V_test_rel_abs[-1]
      and V_test_L2[-1];
  (b) ``experiments/ou_moment_initializations.py``: ``HJBSolver`` on
      ``LLGC(d=20, T=1, seed=42)``, moment loss, 'inner', delta_t 0.01,
      K=500, lr 1e-3, ``learn_Y_0``, ``detach_forward``, no early stopping,
      with Y_0 set to 0, to 10 and to the exact v(x_0, 0) after
      construction; the readings Y_0_log[-1] and u_L2's last value;
  (c) ``experiments/trajectory_length_study.py``: ``EllipticSolver`` on
      ``ExponentialOnBallNonlinearSin(d=10, alpha=1)``, diffusion, K=200,
      K_boundary=50, lr 1e-3, K_test_log 10000, 100 steps a call, on the
      grid N in {1, 2, 5, 10, 20, 50, 100} x delta_t in {1e-3, 5e-4}; the
      reading V_test_L2[-1];
  (d) the witness of phase 39 (d)'s general_linear leg: ``GeneralSolver``
      on ``DoubleWellGeneral(d=2, d_1=1, d_2=1, T=0.5, modus='linear')``
      (tests/test_misc_coverage.py's settings: diffusion, N=10, delta_t
      0.01, K=64, K_boundary=16) for 150 steps; the reading is the RMS of
      V against the product of the 1-d psi over the grid times on 4096
      points of the square drawn with numpy (``general_points``), before
      and after training.

Every leg of a recipe starts from that recipe's seed-42 initial net and
draws its samples and noise under its own seed (42, 43, 44), so that the
spread of the three shows what the sampling alone moves.  It writes the
initial nets (flat Flax trees) to ``pspde_torch/assets/``:
``parabolic_neumann_d20_densenet.npz``, ``llgc_d20_tanhmlp.npz`` ({'z':
...}), ``trajectory_length_d10_densenet.npz`` and
``dw_general_linear_d2_densenet.npz``, and refuses to overwrite
an asset that holds another net.  It prints one JSON line per leg and a
summary line per recipe: the readings of the three seeds, which
``chip_smoke.py`` holds the card to as [min - w, max + w] with
w = max(max - min, 0.1 |mean|).

    JAX_PLATFORMS=cpu python experiments/notebooks_11a_reference.py \
        [--part a b c d] [--L-a 100] [--L-b 50] [--L-c 15] [--L-d 150]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from experiments.allen_cahn_reference import flatten_tree  # noqa: E402
from pspde.ansatz import ScalarParam  # noqa: E402
from pspde.problems import (LLGC, DoubleWellGeneral,  # noqa: E402
                            ExponentialOnBallNonlinearSin,
                            ExponentialOnSphereNonlinearParabolic)
from pspde.solvers import (EllipticSolver, GeneralSolver,  # noqa: E402
                           HJBSolver)

ASSETS = os.path.join(ROOT, "pspde_torch", "assets")
ASSET_A = os.path.join(ASSETS, "parabolic_neumann_d20_densenet.npz")
ASSET_B = os.path.join(ASSETS, "llgc_d20_tanhmlp.npz")
ASSET_C = os.path.join(ASSETS, "trajectory_length_d10_densenet.npz")
ASSET_D = os.path.join(ASSETS, "dw_general_linear_d2_densenet.npz")
INIT_SEED = 42
SEEDS = (42, 43, 44)
A2S = (0.1, 1.0, 10.0, 100.0)
GRID_N = (1, 2, 5, 10, 20, 50, 100)
GRID_DT = (1e-3, 5e-4)


def write_asset(path, tree):
    flat = flatten_tree(tree)
    if os.path.exists(path):
        with np.load(path) as z:
            same = sorted(z.files) == sorted(flat) and all(
                np.array_equal(z[k], v) for k, v in flat.items())
        if not same:
            raise SystemExit(f"{path} holds another initial net")
    else:
        np.savez(path, **flat)


def neumann_problem():
    p = ExponentialOnSphereNonlinearParabolic(d=20, T=1.0, alpha=1.0)
    p.boundary_type = "Neumann"
    return p


def neumann_solver(p, a2, seed, L):
    return GeneralSolver(p, f"diffusion a2={a2:g}", seed=seed, delta_t=1e-3,
                         N=20, lr=1e-3, L=L, K=200, K_boundary=50,
                         alpha=(1.0, 1.0, a2), loss_method="diffusion",
                         K_test_log=10000, steps_per_call=100,
                         print_every=max(L // 20, 1), verbose=False)


def moment_solver(p, name, seed, L):
    return HJBSolver(name, p, L=L, lr=1e-3, seed=seed, delta_t=0.01, K=500,
                     time_approx="inner", loss_method="moment",
                     learn_Y_0=True, detach_forward=True,
                     print_every=max(L // 10, 1), early_stopping_time=None,
                     verbose=False)


def length_solver(p, N, dt, seed, L):
    return EllipticSolver(p, f"N={N} dt={dt:g}", seed=seed, delta_t=dt, N=N,
                          lr=1e-3, L=L, K=200, K_boundary=50,
                          loss_method="diffusion", K_test_log=10000,
                          steps_per_call=100, verbose=False)


def run(s, init, **leg):
    s.params = init
    s.opt_state = s.tx.init(s.params)
    t0 = time.perf_counter()
    s.train()
    leg["seconds"] = time.perf_counter() - t0
    return leg


def part_a(L):
    p = neumann_problem()
    init = jax.device_get(neumann_solver(p, 1.0, INIT_SEED, L).params)
    write_asset(ASSET_A, init)
    out = {}
    for a2 in A2S:
        rel, l2 = [], []
        for seed in SEEDS:
            s = neumann_solver(p, a2, seed, L)
            leg = run(s, init, recipe="a", a2=a2, seed=seed)
            leg.update(steps=len(s.loss_log),
                       rel_abs=float(s.V_test_rel_abs[-1]),
                       test_L2=float(s.V_test_L2[-1]),
                       test_L2_first=float(s.V_test_L2[0]))
            rel.append(leg["rel_abs"])
            l2.append(leg["test_L2"])
            print(json.dumps(leg), flush=True)
        out[f"{a2:g}"] = {"rel_abs": rel, "test_L2": l2}
    print(json.dumps({"recipe": "a", "L": L, "readings": out}), flush=True)


def part_b(L):
    p = LLGC(d=20, T=1.0, seed=INIT_SEED)
    v0 = float(p.v_ref(jnp.zeros((1, 20)), 0.0)[0])
    base = moment_solver(p, "init", INIT_SEED, L)
    write_asset(ASSET_B, {"z": jax.device_get(base.params["z"])})
    out = {}
    for name, y0 in (("y0 = 0", 0.0), ("y0 = 10", 10.0), ("y0 exact", v0)):
        Y0, ul2 = [], []
        for seed in SEEDS:
            s = moment_solver(p, name, seed, L)
            # the notebook's override of the y_0 ansatz (notebook cell 1)
            s.y0_net = ScalarParam(initial=y0)
            init = dict(jax.device_get(base.params),
                        y0=s.y0_net.init(jax.random.PRNGKey(seed),
                                         jnp.zeros((1, 1))))
            leg = run(s, init, recipe="b", start=name, y0=y0, seed=seed)
            leg.update(steps=len(s.loss_log), Y_0=float(s.Y_0_log[-1]),
                       u_L2=float(s.u_L2_loss[-1]),
                       u_L2_first=float(s.u_L2_loss[0]))
            Y0.append(leg["Y_0"])
            ul2.append(leg["u_L2"])
            print(json.dumps(leg), flush=True)
        out[name] = {"y0": y0, "Y_0": Y0, "u_L2": ul2}
    print(json.dumps({"recipe": "b", "L": L, "v0": v0, "readings": out}),
          flush=True)


def part_c(L):
    p = ExponentialOnBallNonlinearSin(d=10, alpha=1.0)
    init = jax.device_get(length_solver(p, 1, 1e-3, INIT_SEED, L).params)
    write_asset(ASSET_C, init)
    out = {}
    for dt in GRID_DT:
        for N in GRID_N:
            l2 = []
            for seed in SEEDS:
                s = length_solver(p, N, dt, seed, L)
                leg = run(s, init, recipe="c", N=N, dt=dt, seed=seed)
                leg.update(steps=len(s.loss_log),
                           test_L2=float(s.V_test_L2[-1]),
                           test_L2_first=float(s.V_test_L2[0]))
                l2.append(leg["test_L2"])
                print(json.dumps(leg), flush=True)
            out[f"{N} {dt:g}"] = l2
    print(json.dumps({"recipe": "c", "L": L, "readings": out}), flush=True)


def general_points(d, n=4096):
    """The 4096 points of [-2.5, 2.5]^d at which part (d) reads V; the card
    draws the same ones (``chip_smoke.py``'s ``general_err``)."""
    return np.random.default_rng(393).uniform(-2.5, 2.5, (n, d)).astype(
        np.float32)


def part_d(L):
    p = DoubleWellGeneral(d=2, d_1=1, d_2=1, T=0.5, eta=1.0, kappa=1.0,
                          modus="linear")
    p.compute_reference_solution(delta_t=0.01, nx=300)

    def solver(seed):
        return GeneralSolver(p, "dw-linear", seed=seed,
                             loss_method="diffusion", L=L, N=10,
                             delta_t=0.01, K=64, K_boundary=16,
                             verbose=False)

    X = jnp.asarray(general_points(p.d))

    def general_err(s):
        ts = np.arange(s.N + 1) * s.delta_t
        v_ref, v = p.v_ref_fn(ts), s._v_fn(s.params)
        err = [jnp.mean((v(X, jnp.full((X.shape[0],), float(t),
                                        dtype=X.dtype)) - v_ref(X, i)) ** 2)
               for i, t in enumerate(ts)]
        return float(jnp.sqrt(jnp.mean(jnp.stack(err))))

    init = jax.device_get(solver(INIT_SEED).params)
    write_asset(ASSET_D, init)
    before, after = [], []
    for seed in SEEDS:
        s = solver(seed)
        s.params = init
        s.opt_state = s.tx.init(s.params)
        before.append(general_err(s))
        leg = run(s, init, recipe="d", seed=seed)
        after.append(general_err(s))
        leg.update(steps=len(s.loss_log), before=before[-1],
                   after=after[-1], loss_first=float(s.loss_log[0]),
                   loss_last=float(s.loss_log[-1]))
        print(json.dumps(leg), flush=True)
    print(json.dumps({"recipe": "d", "L": L, "before": before,
                      "after": after}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--part", nargs="*", default=["a", "b", "c", "d"])
    ap.add_argument("--L-a", type=int, default=100)
    ap.add_argument("--L-b", type=int, default=50)
    ap.add_argument("--L-c", type=int, default=15)
    ap.add_argument("--L-d", type=int, default=150)
    args = ap.parse_args()
    if "a" in args.part:
        part_a(args.L_a)
    if "b" in args.part:
        part_b(args.L_b)
    if "c" in args.part:
        part_c(args.L_c)
    if "d" in args.part:
        part_d(args.L_d)


if __name__ == "__main__":
    main()
