"""Train the LLGC d=100 control with the JAX package and export it as the
asset that ``pspde_torch`` serves.

Trains ``HJBSolver`` on ``LLGC(d=100, T=1)`` with the 'inner' TanhMLP
control [101 -> 30 -> 30 -> 100] (log-variance loss, ``detach_forward``,
``learn_Y_0``, lr 1e-2, K=1024, delta_t=1/32), prints the final u_L2 and
``control_test_error``, and writes
``pspde_torch/assets/llgc_d100_tanhmlp.npz``: the flat Flax parameter
tree (keys like ``z/params/Dense_0/kernel``) plus a JSON metadata string
under ``__meta__``.  Read it back with
``pspde_torch.utils.convert.load_control_npz``.

Run on the CPU (about a minute):

    JAX_PLATFORMS=cpu python experiments/export_llgc_control.py
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

from pspde.eval.test_error import control_test_error  # noqa: E402
from pspde.problems import LLGC  # noqa: E402
from pspde.solvers import HJBSolver  # noqa: E402

DEFAULT_OUT = os.path.join(ROOT, "pspde_torch", "assets",
                           "llgc_d100_tanhmlp.npz")


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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--L", type=int, default=600, help="training iterations")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args()

    d, T, delta_t, K, lr = 100, 1.0, 1 / 32, 1024, 1e-2
    problem = LLGC(d=d, T=T)
    solver = HJBSolver("llgc_d100_export", problem, lr=lr, L=args.L, K=K,
                       delta_t=delta_t, time_approx="inner",
                       loss_method="log-variance", detach_forward=True,
                       learn_Y_0=True, seed=args.seed, verbose=False,
                       early_stopping_time=None)
    t0 = time.time()
    solver.train()
    train_s = time.time() - t0
    u_l2 = float(solver.u_L2_loss[-1])
    cte = control_test_error(problem, solver, K=4096,
                             key=jax.random.PRNGKey(1))
    print(f"trained {args.L} iterations in {train_s:.1f} s: "
          f"u_L2 {u_l2:.4f}, control_test_error {cte:.4f}")

    meta = {"problem": "LLGC", "d": d, "T": T, "delta_t": delta_t,
            "iterations": args.L, "K": K, "lr": lr, "seed": args.seed,
            "loss_method": "log-variance", "time_approx": "inner",
            "hidden": [30, 30], "u_L2": u_l2, "control_test_error": cte}
    flat = flatten_tree(jax.device_get(solver.params))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez(args.out, __meta__=np.array(json.dumps(meta)), **flat)
    print(f"wrote {args.out} ({os.path.getsize(args.out)} bytes): "
          + ", ".join(f"{k} {v.shape}" for k, v in flat.items()))


if __name__ == "__main__":
    main()
