"""The JAX package's numbers for the double-well recipe that ``chip_smoke.py``
trains and serves with the port.

Trains ``pspde.solvers.HJBSolver`` on ``DoubleWell(d=1, T=1, eta=1,
kappa=1)`` with the recipe of ``tests/test_double_well_is.py`` (FD reference
at delta_t 0.01, nx 500; 'inner' TanhMLP control, log-variance,
detach_forward, lr 5e-3, K=1024, delta_t 0.01, ``--L`` steps, seed 42, the
scan), then runs ``importance_sampling`` of the learned control with the
naive chain beside it at ``--K`` paths (delta_t 0.01) for a few keys, and
the FD table's own control (``control='true'``).  It prints one JSON line:
the u_L2 trajectory's ends, the final metastable fraction, and for each
key log(IS mean), naive and IS RE, and -v_ref(X_0, 0) read off the FD
table: the IS log-mean estimates -v(X_0, 0), and the distance between the
two is the time-discretisation bias of the Euler chain plus Monte-Carlo
error.

Run on the CPU (about four minutes):

    JAX_PLATFORMS=cpu python experiments/double_well_is_reference.py
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from pspde.eval import importance_sampling  # noqa: E402
from pspde.problems import DoubleWell  # noqa: E402
from pspde.solvers import HJBSolver  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--L", type=int, default=400)
    ap.add_argument("--K", type=int, default=2 ** 18)
    ap.add_argument("--keys", type=int, default=3)
    ap.add_argument("--seed", type=int, default=42)
    args = ap.parse_args()
    t0 = time.perf_counter()
    dw = DoubleWell(d=1, T=1.0, eta=1.0, kappa=1.0)
    dw.compute_reference_solution(delta_t=0.01, nx=500)
    s = HJBSolver("dw", dw, lr=5e-3, L=args.L, K=1024, delta_t=0.01,
                  time_approx="inner", loss_method="log-variance",
                  detach_forward=True, verbose=False, seed=args.seed,
                  metastability_logs=(jnp.ones(1), 0.5),
                  early_stopping_time=None, steps_per_call=1)
    s.train()
    v0 = float(dw.v_ref_fn(np.zeros(1))(dw.X_0[None, :], 0)[0])
    runs = []
    for key in range(args.keys):
        mn, vn, rn, mi, vi, ri = importance_sampling(
            dw, s, args.K, simulate_naive=True, delta_t=0.01,
            key=jax.random.PRNGKey(100 + key))
        runs.append({"key": 100 + key, "log_mean_is": math.log(mi),
                     "log_mean_naive": math.log(mn), "re_is": ri,
                     "re_naive": rn})
    mt, _, rt = importance_sampling(dw, s, args.K, control="true",
                                    delta_t=0.01, key=jax.random.PRNGKey(7))
    print(json.dumps({
        "steps": len(s.u_L2_loss), "seed": args.seed, "K": args.K,
        "u_l2_first": s.u_L2_loss[0], "u_l2_last": s.u_L2_loss[-1],
        "meta_frac_last": s.particles_close_to_target[-1],
        "minus_v_ref_x0": -v0, "runs": runs,
        "true_control": {"log_mean": math.log(mt), "re": rt},
        "seconds": time.perf_counter() - t0}))


if __name__ == "__main__":
    main()
