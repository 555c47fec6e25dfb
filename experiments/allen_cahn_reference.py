"""The JAX package's numbers for the Allen-Cahn diffusion leg that
``chip_smoke.py`` (phase 32) trains with the port.

Trains ``pspde.solvers.GeneralSolver`` on the CPU (the scan engine) on the
diffusion leg of ``experiments/allen_cahn.py`` (the notebook's alpha0 = 10
model), cut to a step count: ``AllenCahn(d=100, T=0.3)`` sampled on the
ball of radius 7 with ``uniform_square=True``, DenseNet (110, 110, 50) on
[x, t], N=25, delta_t 1e-3, K=200, K_boundary=50, lr 1e-3, alpha (10, 1, 1),
``loss_with_stopped=False``, 2000 steps.  Every leg starts from the
seed-42 initial net and draws its samples and noise under its own seed
(42, 43, 44), so that the spread of the three shows what the sampling
alone moves.  It prints one JSON line per leg (v(0, 0) before and after,
the first loss, the mean of the last 50 losses, the seconds) and a summary
line, and writes the initial net, which the port loads so that both start
from the same net, to ``pspde_torch/assets/allen_cahn_d100_densenet.npz``
(the flat Flax tree, as ``experiments/stopped_breadth_reference.py``
writes its nets).

    JAX_PLATFORMS=cpu python experiments/allen_cahn_reference.py [--L 2000]
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

from pspde.ansatz import DenseNet  # noqa: E402
from pspde.problems import AllenCahn  # noqa: E402
from pspde.problems.base import Geometry  # noqa: E402
from pspde.solvers import GeneralSolver  # noqa: E402

ASSET = os.path.join(ROOT, "pspde_torch", "assets",
                     "allen_cahn_d100_densenet.npz")
INIT_SEED = 42          # the seed of the committed initial net
SEEDS = (42, 43, 44)    # the legs' sampling seeds
D, RADIUS = 100, 7.0
LEG = dict(loss_method="diffusion", N=25, delta_t=1e-3, K=200, K_boundary=50,
           lr=1e-3, alpha=(10.0, 1.0, 1.0), uniform_square=True,
           loss_with_stopped=False, steps_per_call=100, verbose=False)


def flatten_tree(tree, prefix=""):
    """Nested dict of arrays -> {'a/b/c': np.ndarray}."""
    flat = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            flat.update(flatten_tree(v, name))
        else:
            flat[name] = np.asarray(v, dtype=np.float32)
    return flat


def problem():
    p = AllenCahn(d=D, T=0.3)
    # the notebook's sampling ball (experiments/allen_cahn.py)
    p.geometry = Geometry(kind="unbounded", boundary_distance=RADIUS)
    return p


def solver(seed, L):
    return GeneralSolver(problem(), f"allen_cahn_diffusion_{seed}",
                         seed=seed, L=L,
                         value_net=DenseNet(d_out=1, arch=(110, 110, 50)),
                         **LEG)


def v_at_origin(s):
    return float(s._v_fn(s.params)(jnp.zeros((1, D)), jnp.zeros((1,)))[0])


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--L", type=int, default=2000)
    args = ap.parse_args()
    init = jax.device_get(solver(INIT_SEED, args.L).params)
    flat = flatten_tree(init)
    if os.path.exists(ASSET):
        with np.load(ASSET) as z:
            same = sorted(z.files) == sorted(flat) and all(
                np.array_equal(z[k], v) for k, v in flat.items())
        if not same:
            raise SystemExit(f"{ASSET} holds another initial net")
    else:
        np.savez(ASSET, **flat)
    legs = []
    for seed in SEEDS:
        s = solver(seed, args.L)
        s.params = init
        s.opt_state = s.tx.init(s.params)
        v_init = v_at_origin(s)
        t0 = time.perf_counter()
        s.train()
        leg = {"seed": seed, "init_seed": INIT_SEED,
               "steps": len(s.loss_log), "v00_init": v_init,
               "v00": v_at_origin(s), "loss_first": float(s.loss_log[0]),
               "loss_tail50": float(np.mean(s.loss_log[-50:])),
               "seconds": time.perf_counter() - t0}
        legs.append(leg)
        print(json.dumps(leg), flush=True)
    v = [leg["v00"] for leg in legs]
    print(json.dumps({
        "v00": v, "v00_mean": float(np.mean(v)),
        "v00_init": legs[0]["v00_init"],
        "loss_tail50": [leg["loss_tail50"] for leg in legs],
        "loss_tail50_mean": float(np.mean([leg["loss_tail50"]
                                           for leg in legs])),
        "loss_first": [leg["loss_first"] for leg in legs],
        "v00_literature": AllenCahn.V0_LITERATURE}), flush=True)


if __name__ == "__main__":
    main()
