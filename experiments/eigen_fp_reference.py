"""The JAX package's numbers for the Fokker-Planck eigen recipe that
``chip_smoke.py`` (phase 21) trains with the port.

Trains ``pspde.solvers.EigenSolver`` on ``FokkerPlanckEigen(d=5)`` with the
recipe of ``experiments/eigenvalue_fokker_planck.py``: DenseNet
(10, 10, 10, 10), lr 1e-3, lr_lambda 0.01, lambda_init 0.5, K=500,
K_boundary=50, alpha (50, 1), normalization 'center', N=20, delta_t=1e-3,
on the scan engine, for ``--L`` steps (seed 42), and prints one JSON line:
the mean of the last 100 entries of ``V_L2_log``, ``lambda_tail_mean()``
(the last 10% of ``lambda_log``) and the first and last V_L2.

Run on the CPU (about two minutes for 4000 steps):

    JAX_PLATFORMS=cpu python experiments/eigen_fp_reference.py --L 4000
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

from pspde.ansatz import DenseNet  # noqa: E402
from pspde.problems import FokkerPlanckEigen  # noqa: E402
from pspde.solvers import EigenSolver  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--L", type=int, default=4000)
    ap.add_argument("--seed", type=int, default=42)
    args = ap.parse_args()
    s = EigenSolver(FokkerPlanckEigen(d=5), "fp-eigen-ref", seed=args.seed,
                    delta_t=1e-3, N=20, lr=1e-3, lr_lambda=0.01,
                    lambda_init=0.5, L=args.L, K=500, K_boundary=50,
                    alpha=(50.0, 1.0), normalization="center",
                    value_net=DenseNet(d_out=1, arch=(10, 10, 10, 10)),
                    steps_per_call=100, verbose=False)
    t0 = time.perf_counter()
    s.train()
    print(json.dumps({
        "steps": len(s.V_L2_log), "seed": args.seed,
        "V_L2_tail100": float(np.mean(s.V_L2_log[-100:])),
        "V_L2_first": s.V_L2_log[0], "V_L2_last": s.V_L2_log[-1],
        "lambda_tail_mean": s.lambda_tail_mean(),
        "lambda_last": s.lambda_log[-1],
        "seconds": time.perf_counter() - t0}))


if __name__ == "__main__":
    main()
