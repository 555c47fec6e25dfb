"""The JAX package's numbers for the committor and full-Hessian recipes that
``chip_smoke.py`` (phases 27-29) trains with the port.

Trains ``pspde.solvers.EllipticSolver`` on the CPU (seed 42, the scan
engine) on four legs of ``experiments/committor.py`` and
``experiments/elliptic_full_hessian.py``, cut to a step count:

  * committor diffusion: ``Committor(d=10)``, N=50, delta_t 1e-3, K=200,
    K_boundary=50, lr 1e-3, alpha (10, 1), ``loss_with_stopped=False``,
    1000 steps;
  * full-Hessian diffusion: ``ExponentialOnBallNonlinearSinHessian(d=20,
    alpha=1)``, N=20, delta_t 1e-3, K=200, K_boundary=50, lr 1e-3, 1000
    steps;
  * committor PINN: as its diffusion leg with alpha (1e-3, 1), 500 steps;
  * full-Hessian PINN: ``full_hessian=True``, 500 steps;

each with the solver's default DenseNet (30, 30) and K_test_log=10000.
It prints one JSON line per leg (the mean of the last 50 entries of
``V_test_L2``, the first and last entries, the seconds) and writes the
value nets' initial parameters, which the port loads so that both start
from the same net, to ``pspde_torch/assets/committor_d10_densenet.npz``
and ``hessian_d20_densenet.npz`` (the flat Flax tree, as
``experiments/export_llgc_control.py`` writes it).

    JAX_PLATFORMS=cpu python experiments/stopped_breadth_reference.py
"""

from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import numpy as np  # noqa: E402

from pspde.problems import (Committor,  # noqa: E402
                            ExponentialOnBallNonlinearSinHessian)
from pspde.solvers import EllipticSolver  # noqa: E402

ASSETS = os.path.join(ROOT, "pspde_torch", "assets")
SEED = 42   # the seed of the committed initial nets
COMMON = dict(delta_t=1e-3, lr=1e-3, K=200, K_boundary=50,
              K_test_log=10000, steps_per_call=100, verbose=False)
# leg: (problem, asset, steps, solver keywords)
LEGS = {
    "committor_diffusion": ("committor", 1000, dict(
        N=50, alpha=(10.0, 1.0), loss_method="diffusion",
        loss_with_stopped=False)),
    "hessian_diffusion": ("hessian", 1000, dict(
        N=20, loss_method="diffusion")),
    "committor_pinn": ("committor", 500, dict(
        N=50, alpha=(1e-3, 1.0), loss_method="PINN",
        loss_with_stopped=False)),
    "hessian_pinn": ("hessian", 500, dict(
        N=20, loss_method="PINN", full_hessian=True)),
}


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
    problems = {"committor": Committor(d=10),
                "hessian": ExponentialOnBallNonlinearSinHessian(d=20,
                                                                alpha=1.0)}
    assets = {"committor": "committor_d10_densenet.npz",
              "hessian": "hessian_d20_densenet.npz"}
    for leg, (which, L, kw) in LEGS.items():
        s = EllipticSolver(problems[which], leg, seed=SEED, L=L,
                           **COMMON, **kw)
        flat = flatten_tree(jax.device_get(s.params))
        path = os.path.join(ASSETS, assets[which])
        if os.path.exists(path):
            with np.load(path) as z:
                same = sorted(z.files) == sorted(flat) and all(
                    np.array_equal(z[k], v) for k, v in flat.items())
            if not same:
                raise SystemExit(f"{path} holds another initial net")
        else:
            np.savez(path, **flat)
        t0 = time.perf_counter()
        s.train()
        print(json.dumps({
            "leg": leg, "steps": len(s.V_test_L2), "seed": SEED,
            "test_L2_tail50": float(np.mean(s.V_test_L2[-50:])),
            "test_L2_first": s.V_test_L2[0], "test_L2_last": s.V_test_L2[-1],
            "seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
