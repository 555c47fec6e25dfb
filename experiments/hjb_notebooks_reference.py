"""The JAX package's initial nets and figures for the HJB loss-study legs
that ``chip_smoke.py`` (phase 37) drives with the port.

Runs ``pspde`` on the CPU.  It writes

  * JAX's seed-42 initial control of ``experiments/ou_linear_costs.py``'s
    d=40 cell (``LLGC(d=40, T=1, off_diag=0.1, seed=42)``, 'inner'
    ``TanhMLP``, the same for each of the five losses) to
    ``pspde_torch/assets/llgc_d40_tanhmlp.npz``, and
  * JAX's seed-42 initial per-step control of
    ``experiments/gradient_relative_errors.py`` (``DoubleWell(d=1, T=1,
    eta=3, kappa=5)``, 'outer' ``DenseNet``, delta_t 0.02, N=50 stacked
    parameter sets) to ``pspde_torch/assets/double_well_d1_outer_densenet
    .npz``,

both as flat Flax trees {'z': ...} (``experiments/allen_cahn_reference.py:
flatten_tree``), and refuses to overwrite an asset that holds another
net.  It writes the rollout noise of ``gradient_variances(solver,
PRNGKey(3))`` (normal(fold_in(key, n), (500, 1)) for n < 50) to
``pspde_torch/assets/double_well_d1_gv_noise.npz`` and prints the mean of
|rel| over that call's (N, p) matrix at the initial net for both losses:
the port's diagnostic on the card reads the same number on that noise.
Then
it trains the gradient notebook's two legs (moment and log-variance,
K=500, lr 1e-3, ``detach_forward``, 200 steps,
``compute_gradient_variance`` every 20) from that initial net under the
sampling seeds 42 to 51, and prints one JSON line per run (the mean of
``grads_rel_error_log``, its entries, u_L2's first and last value, the
seconds) and a summary line: per loss the means, and the median,
interquartile range and number of the runs' readings pooled, the figures
that phase 37 (b) holds the port to.  The notebook's reading is a mean
of ratios sqrt(Var)/Mean over 54,100 entries, a few hundred of them above
1e3 where a mean gradient passes near 0: its spread over runs has a long
upper tail, which three runs do not show (42, 43, 44 read 48.6 to 59.7 under
the moment loss; the port on the card 104.1 and 46.4 under two seeds).

    JAX_PLATFORMS=cpu python experiments/hjb_notebooks_reference.py [--L 200]
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
from pspde.problems import LLGC, DoubleWell  # noqa: E402
from pspde.solvers import HJBSolver  # noqa: E402

ASSETS = os.path.join(ROOT, "pspde_torch", "assets")
OU_ASSET = os.path.join(ASSETS, "llgc_d40_tanhmlp.npz")
DW_ASSET = os.path.join(ASSETS, "double_well_d1_outer_densenet.npz")
NOISE_ASSET = os.path.join(ASSETS, "double_well_d1_gv_noise.npz")
NOISE_KEY = 3
SEEDS = tuple(range(42, 52))
LOSSES = ("moment", "log-variance")


def ou_solver():
    return HJBSolver("log-variance", LLGC(d=40, T=1.0, off_diag=0.1,
                                          seed=42),
                     L=1, lr=1e-3, seed=42, delta_t=0.01, K=500,
                     time_approx="inner", loss_method="log-variance",
                     detach_forward=True, verbose=False,
                     early_stopping_time=None)


def dw_solver(loss, seed, L, problem):
    return HJBSolver(loss, problem, L=L, lr=1e-3, seed=seed, delta_t=0.02,
                     K=500, time_approx="outer", loss_method=loss,
                     detach_forward=True,
                     compute_gradient_variance=max(L // 10, 1),
                     print_every=max(L // 10, 1), early_stopping_time=None,
                     verbose=False)


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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--L", type=int, default=200)
    args = ap.parse_args()
    write_asset(OU_ASSET, {"z": jax.device_get(ou_solver().params["z"])})
    dw = DoubleWell(d=1, T=1.0, eta=3.0, kappa=5.0)
    dw.compute_reference_solution()
    init = {"z": jax.device_get(dw_solver("moment", 42, args.L,
                                          dw).params["z"])}
    write_asset(DW_ASSET, init)
    from pspde.eval.gradient_variance import gradient_variances
    key = jax.random.PRNGKey(NOISE_KEY)
    s = dw_solver("moment", 42, args.L, dw)
    noise = np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(key, n), (s.K, 1), dtype=jax.numpy.float32))
        for n in range(s.N)])
    write_asset(NOISE_ASSET, {"noise": noise})
    fixed = {}
    for loss in LOSSES:
        s = dw_solver(loss, 42, args.L, dw)
        s.params = dict(s.params, z=jax.tree.map(jax.numpy.asarray,
                                                 init["z"]))
        rel = np.asarray(gradient_variances(s, key))
        fixed[loss] = float(np.mean(np.abs(rel)))
    print(json.dumps({"fixed_noise_mean_abs_rel": fixed}), flush=True)
    summary, pooled = {}, {}
    for loss in LOSSES:
        means, readings = [], []
        for seed in SEEDS:
            s = dw_solver(loss, seed, args.L, dw)
            s.params = dict(s.params, z=init["z"])
            s.opt_state = s.tx.init(s.params)
            t0 = time.perf_counter()
            s.train()
            log = [float(v) for v in s.grads_rel_error_log]
            means.append(float(np.mean(log)))
            readings += log
            print(json.dumps({"loss": loss, "seed": seed, "steps":
                              len(s.loss_log), "mean_rel_grad_error":
                              means[-1], "grads_rel_error_log": log,
                              "u_l2_first": float(s.u_L2_loss[0]),
                              "u_l2_last": float(s.u_L2_loss[-1]),
                              "seconds": time.perf_counter() - t0}),
                  flush=True)
        summary[loss] = means
        q1, med, q3 = np.percentile(readings, [25, 50, 75])
        pooled[loss] = {"median": float(med), "iqr": float(q3 - q1),
                        "n": len(readings)}
    print(json.dumps({"mean_rel_grad_error": summary,
                      "pooled_readings": pooled}), flush=True)


if __name__ == "__main__":
    main()
