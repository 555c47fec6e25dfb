#!/usr/bin/env python3
"""The general-parabolic convergence leg on the PyTorch port: the twin of
the ``conv_general_*`` leg of ``experiments/proto_fused_stopped_breadth.py``
(the JAX script, which stays as it is).

    python3 experiments/torch_parabolic.py [--smoke] [--cpu] [--L N]

Trains ``GeneralSolver(ExponentialOnSphereNonlinearParabolic(d=50),
loss_method='diffusion', K=8192, N=20, delta_t=1e-3, lr=1e-3,
K_test_log=4096)`` for 2000 iterations on each engine, 'scan' and
'fused_train' (the time_stopping branch of the stopped kernels), and prints
one JSON line per engine with the mean test L2 of the last 50 iterations,
the wall time, the card and its power limit.  The JAX package reads 0.0579
on both engines with this recipe (RESULTS.md).

It runs on the CUDA card; ``--cpu`` runs the scan engine on the CPU (there
are no kernels there), and ``--smoke`` shrinks the run to K=512 and 100
iterations.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--L", type=int, default=None)
    ap.add_argument("--seed", type=int, default=42)
    args = ap.parse_args()

    from pspde_torch.problems import ExponentialOnSphereNonlinearParabolic
    from pspde_torch.solvers import GeneralSolver

    dev = torch.device("cpu" if args.cpu else "cuda:0")
    card = "cpu"
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
    L = args.L if args.L is not None else (100 if args.smoke else 2000)
    K = 512 if args.smoke else 8192
    problem = ExponentialOnSphereNonlinearParabolic(d=50, device=dev)
    engines = ("scan",) if args.cpu else ("scan", "fused_train")
    for mode in engines:
        s = GeneralSolver(problem, f"conv-gen-{mode}",
                          loss_method="diffusion", K=K, N=20, delta_t=1e-3,
                          lr=1e-3, L=L, K_test_log=4096, verbose=False,
                          seed=args.seed, rollout_mode=mode, device=dev)
        t0 = time.perf_counter()
        s.train()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        print(json.dumps({f"conv_general_{mode}": {
            "resolved": s.resolved_rollout_mode, "iterations": L, "K": K,
            "test_L2_tail": float(np.mean(s.V_test_L2[-50:])),
            "loss_last": s.loss_log[-1],
            "wall_s": round(time.perf_counter() - t0, 1),
            "device": card}}), flush=True)


if __name__ == "__main__":
    main()
