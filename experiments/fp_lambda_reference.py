"""The JAX package's eigenvalue readout on the port's refined
Fokker-Planck net.

``chip_smoke.py`` phase 38 (e) refines phase 21's 4000-step net (the
``FokkerPlanckEigen(d=5)`` recipe of ``experiments/eigenvalue_fokker_
planck.py``: DenseNet (10, 10, 10, 10), N=20, delta_t 1e-3) by three
stages of ``eigen_power_refine`` and reads ``estimate_lambda`` (K=8192, 16
batches) on the card; ``experiments/torch_fp_refined_net.py`` wrote that
refined net to ``pspde_torch/assets/fp_d5_refined_densenet.npz``.  This
script loads it into ``pspde.solvers.EigenSolver`` on the CPU and reads
the JAX package's ``estimate_lambda`` at the same K and batch count under
three keys (fold_in(PRNGKey(0), 0x1a) and PRNGKey(1), PRNGKey(2)), one
JSON line each, then their mean: whether the gap between the card's
readout and JAX's refinements of its own net lies in the net or in the
readout.

    JAX_PLATFORMS=cpu python experiments/fp_lambda_reference.py
"""

from __future__ import annotations

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
from pspde.problems import FokkerPlanckEigen  # noqa: E402
from pspde.solvers import EigenSolver  # noqa: E402

ASSET = os.path.join(ROOT, "pspde_torch", "assets",
                     "fp_d5_refined_densenet.npz")
K, N_BATCHES = 8192, 16


def unflatten(flat):
    tree = {}
    for key, val in flat.items():
        node = tree
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(val)
    return tree


def solver():
    """The recipe's solver (experiments/eigenvalue_fokker_planck.py, as
    chip_smoke.py phase 21 runs it) holding the asset's net."""
    s = EigenSolver(FokkerPlanckEigen(d=5), "fp", seed=42, delta_t=1e-3,
                    N=20, lr=1e-3, lr_lambda=0.01, lambda_init=0.5, K=500,
                    K_boundary=50, alpha=(50.0, 1.0), normalization="center",
                    value_net=DenseNet(d_out=1, arch=(10, 10, 10, 10)),
                    verbose=False)
    with np.load(ASSET) as z:
        s.params = unflatten({k: z[k] for k in z.files})
    return s


def main():
    s = solver()
    keys = {"fold_in(PRNGKey(0), 0x1a)": jax.random.fold_in(
        jax.random.PRNGKey(0), 0x1a), "PRNGKey(1)": jax.random.PRNGKey(1),
        "PRNGKey(2)": jax.random.PRNGKey(2)}
    lams = []
    for name, key in keys.items():
        t0 = time.perf_counter()
        lam, se = s.estimate_lambda(K=K, n_batches=N_BATCHES, key=key)
        lams.append((lam, se))
        print(json.dumps({"key": name, "K": K, "n_batches": N_BATCHES,
                          "lambda": lam, "stderr": se,
                          "seconds": time.perf_counter() - t0}), flush=True)
    print(json.dumps({"lambda": [v for v, _ in lams],
                      "stderr": [e for _, e in lams],
                      "mean": float(np.mean([v for v, _ in lams])),
                      "lam_leaf": float(np.asarray(
                          s.params["lam"]["params"]["Y_0"])[0])}),
          flush=True)


if __name__ == "__main__":
    main()
