"""The upper tail of the gradient-error readings: JAX's runs on the CPU over
many sampling seeds, and the rank test against the port's.

The notebook's legs of ``experiments/gradient_relative_errors.py``
(``DoubleWell(d=1, T=1, eta=3, kappa=5)``, 'outer' ``DenseNet``, dt 0.02,
K=500, lr 1e-3, ``detach_forward``, 200 steps, a reading every 20) from
JAX's seed-42 initial net (``pspde_torch/assets/
double_well_d1_outer_densenet.npz``, written by
``experiments/hjb_notebooks_reference.py``) under each of ``--seeds``,
one JSON line a run, as ``experiments/torch_gradient_variance_probe.py``
prints the port's:

    JAX_PLATFORMS=cpu python experiments/gradient_error_tail.py \\
        --seeds $(seq 42 71) > jax.jsonl
    python experiments/torch_gradient_variance_probe.py --device cpu \\
        --seeds $(seq 42 71) > port.jsonl

``--compare jax.jsonl port.jsonl`` reads both files (lines that are not
a run's JSON are skipped) and prints, per loss, each package's per-run
counts of readings above ``--above`` (default 100), their sums, and the
two-sided Mann-Whitney U test of the two sets of counts (and of the
runs' median readings): a p-value below 0.05 says the two laws of the
tail differ.
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

ASSET = os.path.join(ROOT, "pspde_torch", "assets",
                     "double_well_d1_outer_densenet.npz")
LOSSES = ("moment", "log-variance")


def runs(path):
    """{loss: [readings of each run, in file order]} of a JSON-lines file."""
    out = {}
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line.startswith("{"):
                continue
            rec = json.loads(line)
            if "grads_rel_error_log" not in rec or "loss" not in rec:
                continue
            out.setdefault(rec["loss"], []).append(
                [float(v) for v in rec["grads_rel_error_log"]])
    return out


def compare(path_a, path_b, above):
    from scipy.stats import mannwhitneyu
    a, b = runs(path_a), runs(path_b)
    result = {}
    for loss in sorted(set(a) & set(b)):
        ca = [int(np.sum(np.asarray(r) > above)) for r in a[loss]]
        cb = [int(np.sum(np.asarray(r) > above)) for r in b[loss]]
        ma = [float(np.median(r)) for r in a[loss]]
        mb = [float(np.median(r)) for r in b[loss]]
        result[loss] = {
            "runs": [len(ca), len(cb)],
            "counts": [ca, cb],
            "sums": [int(sum(ca)), int(sum(cb))],
            "readings": [sum(map(len, a[loss])), sum(map(len, b[loss]))],
            "p_counts": float(mannwhitneyu(ca, cb,
                                           alternative="two-sided").pvalue),
            "p_run_medians": float(mannwhitneyu(
                ma, mb, alternative="two-sided").pvalue)}
    print(json.dumps({"above": above, "files": [path_a, path_b],
                      "by_loss": result}), flush=True)


def unflatten(tree, flat, prefix):
    """``tree`` (nested dicts of arrays) with each leaf replaced by the
    asset's array of the same '/'-joined name and shape."""
    import jax.numpy as jnp
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}"
        if isinstance(v, dict):
            out[k] = unflatten(v, flat, name)
        else:
            if flat[name].shape != np.shape(v):
                raise SystemExit(f"{name}: asset {flat[name].shape}, "
                                 f"solver {np.shape(v)}")
            out[k] = jnp.asarray(flat[name])
    return out


def train(seeds, losses, L):
    from pspde.problems import DoubleWell
    from pspde.solvers import HJBSolver
    with np.load(ASSET) as z:
        flat = {k: z[k] for k in z.files}
    dw = DoubleWell(d=1, T=1.0, eta=3.0, kappa=5.0)
    dw.compute_reference_solution()
    for loss in losses:
        for seed in seeds:
            s = HJBSolver(loss, dw, L=L, lr=1e-3, seed=seed, delta_t=0.02,
                          K=500, time_approx="outer", loss_method=loss,
                          detach_forward=True,
                          compute_gradient_variance=max(L // 10, 1),
                          print_every=max(L // 10, 1),
                          early_stopping_time=None, verbose=False)
            s.params = dict(s.params, z=unflatten(s.params["z"], flat, "z"))
            s.opt_state = s.tx.init(s.params)
            t0 = time.perf_counter()
            s.train()
            log = [float(v) for v in s.grads_rel_error_log]
            print(json.dumps({
                "loss": loss, "seed": seed, "device": "cpu",
                "package": "pspde",
                "mean_rel_grad_error": float(np.mean(log)),
                "grads_rel_error_log": log,
                "u_l2_first": float(s.u_L2_loss[0]),
                "u_l2_last": float(s.u_L2_loss[-1]),
                "seconds": time.perf_counter() - t0}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="*",
                    default=list(range(42, 72)))
    ap.add_argument("--losses", nargs="*", default=list(LOSSES))
    ap.add_argument("--L", type=int, default=200)
    ap.add_argument("--compare", nargs=2, metavar=("A", "B"))
    ap.add_argument("--above", type=float, default=100.0)
    args = ap.parse_args()
    if args.compare:
        compare(*args.compare, args.above)
    else:
        train(args.seeds, args.losses, args.L)


if __name__ == "__main__":
    main()
