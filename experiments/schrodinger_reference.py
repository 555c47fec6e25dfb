"""The JAX package's numbers for the Schroedinger eigen recipe that
``chip_smoke.py`` (phase 35) trains with the port.

Trains ``pspde.solvers.EigenSolver`` on the CPU (the scan engine) on the
d=10 recipe of ``experiments/eigenvalue_schroedinger.py``, cut to a step
count: ``SchrodingerEigen(d=10)``, ``DenseNetTanh(d_out=1, arch=(15, 15,
15, 15), output_relu=True)``, delta_t 1e-3, N=20, lr 1e-3, lambda_init -2,
K=500, K_boundary=50, alpha (50, 1), normalization 'l2_penalty', 2000
steps.  Every run starts from the seed-44 initial net and draws its samples
and noise under its own seed (42, 43, 44), so that the spread of the three
shows what the sampling alone moves.  It prints one JSON line per run
(lambda's first value and its mean over the last 10% of the steps, V_L2's
first value and its mean over the last 100, the seconds) and a summary
line, and writes the initial parameters {'V': the net, 'lam': lambda},
which the port loads so that both start from the same net, to
``pspde_torch/assets/schrodinger_d10_densenet_tanh.npz`` (the flat Flax
tree, as ``experiments/allen_cahn_reference.py`` writes its net).

The initial net is the first from seed 42 up that is open (V > 0, the
output clamp) on at least a quarter of the square: the seed-42 net is open
on 4.6% of it (seed 43's on none, seed 44's on 44.8%, by 4096 uniform
points), and from it the clamp shut everywhere within ~50 steps under the
sampling seeds 43 and 44 (V = 0, the loss held at the hat barrier's 1.01,
lambda at -2.008 and -2.011 after 2000 steps) while under seed 42 lambda
reached -3.11; from the seed-44 net all three move alike (lambda -2.28 at
step 250 under each).  A check that the port trains as JAX does needs a
start from which JAX's runs agree.

    JAX_PLATFORMS=cpu python experiments/schrodinger_reference.py [--L 2000]
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
import numpy as np  # noqa: E402

from experiments.allen_cahn_reference import flatten_tree  # noqa: E402
from pspde.ansatz import DenseNetTanh  # noqa: E402
from pspde.problems import SchrodingerEigen  # noqa: E402
from pspde.solvers import EigenSolver  # noqa: E402

ASSET = os.path.join(ROOT, "pspde_torch", "assets",
                     "schrodinger_d10_densenet_tanh.npz")
INIT_SEED = 44          # the seed of the committed initial net
SEEDS = (42, 43, 44)    # the runs' sampling seeds
D, ARCH = 10, (15, 15, 15, 15)
RECIPE = dict(delta_t=1e-3, N=20, lr=1e-3, lambda_init=-2.0, K=500,
              K_boundary=50, alpha=(50.0, 1.0), normalization="l2_penalty",
              steps_per_call=100, verbose=False)


def solver(seed, L):
    return EigenSolver(SchrodingerEigen(d=D), f"schroedinger_{seed}",
                       seed=seed, L=L,
                       value_net=DenseNetTanh(d_out=1, arch=ARCH,
                                              output_relu=True), **RECIPE)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--L", type=int, default=2000)
    args = ap.parse_args()
    init = jax.device_get(solver(INIT_SEED, args.L).params)
    X = np.random.default_rng(0).uniform(0.0, 2.0 * np.pi, (4096, D))
    V = np.asarray(solver(INIT_SEED, 1).V_net.apply(
        init["V"], X.astype(np.float32)))[:, 0]
    print(json.dumps({"init_seed": INIT_SEED,
                      "open_fraction": float((V > 0).mean())}), flush=True)
    flat = flatten_tree(init)
    if os.path.exists(ASSET):
        with np.load(ASSET) as z:
            same = sorted(z.files) == sorted(flat) and all(
                np.array_equal(z[k], v) for k, v in flat.items())
        if not same:
            raise SystemExit(f"{ASSET} holds another initial net")
    else:
        np.savez(ASSET, **flat)
    runs = []
    for seed in SEEDS:
        s = solver(seed, args.L)
        s.params = init
        s.opt_state = s.tx.init(s.params)
        t0 = time.perf_counter()
        s.train()
        run = {"seed": seed, "init_seed": INIT_SEED,
               "steps": len(s.lambda_log),
               "lambda_first": float(s.lambda_log[0]),
               "lambda_tail": float(s.lambda_tail_mean()),
               "v_l2_first": float(s.V_L2_log[0]),
               "v_l2_tail100": float(np.mean(s.V_L2_log[-100:])),
               "seconds": time.perf_counter() - t0}
        runs.append(run)
        print(json.dumps(run), flush=True)
    lam = [r["lambda_tail"] for r in runs]
    v = [r["v_l2_tail100"] for r in runs]
    print(json.dumps({
        "lambda_tail": lam, "lambda_tail_mean": float(np.mean(lam)),
        "lambda_first": runs[0]["lambda_first"],
        "v_l2_tail100": v, "v_l2_tail100_mean": float(np.mean(v)),
        "v_l2_first": [r["v_l2_first"] for r in runs],
        "lambda_true": SchrodingerEigen(d=D).lambda_true}), flush=True)


if __name__ == "__main__":
    main()
