"""The relative gradient errors of experiments/gradient_relative_errors.py
on the card against the same computation on the CPU.

``pspde_torch.eval.gradient_variances`` of the notebook's 'outer' DoubleWell
solver (d=1, eta=3, kappa=5, dt 0.02, K=500, JAX's initial net from
``pspde_torch/assets/double_well_d1_outer_densenet.npz``) on one (N, K, 1)
noise tensor drawn on the host, once on the card and once on the CPU, for
both losses: the mean of |rel| over the (N, p) matrix (the notebook's
reading), the entries above 1e3 and equal to 0, and the largest
differences (on the card only); then the notebook's 200-step legs from
the asset under --seeds sampling seeds on --device (default the card),
one JSON line a leg: the mean of its ten readings (the notebook's
figure) and the readings.

    python3 experiments/torch_gradient_variance_probe.py [--seeds 42 43 44]
    python3 experiments/torch_gradient_variance_probe.py --device cpu \
        --losses moment --seeds 42
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
import torch  # noqa: E402

from pspde_torch.eval import gradient_variances  # noqa: E402
from pspde_torch.problems import DoubleWell  # noqa: E402
from pspde_torch.solvers import HJBSolver  # noqa: E402

ASSET = os.path.join(ROOT, "pspde_torch", "assets",
                     "double_well_d1_outer_densenet.npz")


def solver(loss, dev, seed=42, L=1, cgv=0):
    dw = DoubleWell(d=1, T=1.0, eta=3.0, kappa=5.0, device=dev)
    dw.compute_reference_solution()
    s = HJBSolver(loss, dw, L=L, lr=1e-3, seed=seed, delta_t=0.02, K=500,
                  time_approx="outer", loss_method=loss, detach_forward=True,
                  compute_gradient_variance=cgv, print_every=20,
                  early_stopping_time=None, verbose=False, device=dev)
    s.load_jax_params(ASSET)
    return s


def summary(rel):
    a = np.abs(rel)
    return (f"mean|rel| {a.mean():.4f}, {int((a > 1e3).sum())} entries "
            f"> 1e3, {int((rel == 0).sum())} = 0, max {a.max():.1f}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="*", default=[42, 43, 44])
    ap.add_argument("--losses", nargs="*", default=["moment", "log-variance"])
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args()
    dev = torch.device(args.device)
    noise = torch.randn((50, 500, 1), generator=torch.Generator()
                        .manual_seed(3))
    for loss in args.losses if dev.type == "cuda" else ():
        rels = {}
        for d in (dev, torch.device("cpu")):
            rels[d.type] = gradient_variances(
                solver(loss, d), host_noise=noise.to(d)).cpu().numpy()
            print(f"[{loss}] {d.type}: {summary(rels[d.type])}", flush=True)
        diff = np.abs(rels["cuda"] - rels["cpu"])
        small = np.abs(rels["cpu"]) < 1e3
        print(f"[{loss}] card - CPU: max |diff| {diff.max():.3e} overall, "
              f"{(diff[small] / np.maximum(np.abs(rels['cpu'][small]), 1e-30)).max():.3e} "
              f"relative where |rel| < 1e3; entries 0 on one side only "
              f"{int(((rels['cuda'] == 0) != (rels['cpu'] == 0)).sum())}",
              flush=True)
    for loss in args.losses:
        for seed in args.seeds:
            s = solver(loss, dev, seed=seed, L=200, cgv=20)
            t0 = time.perf_counter()
            s.train()
            print(json.dumps({
                "loss": loss, "seed": seed, "device": dev.type,
                "mean_rel_grad_error": float(np.mean(s.grads_rel_error_log)),
                "grads_rel_error_log": s.grads_rel_error_log,
                "u_l2_first": s.u_L2_loss[0], "u_l2_last": s.u_L2_loss[-1],
                "seconds": time.perf_counter() - t0}), flush=True)
    if dev.type == "cuda":
        print(f"card: {torch.cuda.get_device_name(0)}")


if __name__ == "__main__":
    main()
