"""The Fokker-Planck eigen leg of ``chip_smoke.py`` on the card, alone:
phase 21's 4000-step net (``chip_smoke.eigen_phases``, phases 20-22) and
phase 38 (e) on it (``chip_smoke.fp_power_leg``): three stages of
``eigen_power_refine``, then ``estimate_lambda`` (K=8192, 16 batches) on
'fused_train' (kernel 4) and on the scan under one seed, both engines on
one set of host-noise batches, and the torus kernels against their plain
version on the refined net.  It writes the refined net as a flat Flax tree
({'V': ..., 'lam': ...}) to ``--out``, the file that
``pspde_torch/assets/fp_d5_refined_densenet.npz`` was copied from and that
``experiments/fp_lambda_reference.py`` reads with the JAX package.

    python3 experiments/torch_fp_refined_net.py \
        [--out build/fp_d5_refined_densenet.npz]
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from pspde_torch.rollout import _build  # noqa: E402
from pspde_torch.utils.convert import (eigen_params_to_flax,  # noqa: E402
                                       flatten_tree)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(
        "build", "fp_d5_refined_densenet.npz"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_fp_refined_net: this script needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"card: {smi}")
    _build.library()
    _, fp_leg = cs.eigen_phases(dev, smi)
    fp_leg.release_graph()
    walls = {}

    def leg_run(tag, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls[tag] = time.perf_counter() - t0
        print(f"  [{tag}] {walls[tag]:.2f} s")
        return out

    cs.fp_power_leg(dev, fp_leg, leg_run)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez(args.out, **flatten_tree(eigen_params_to_flax(
        list(fp_leg.V_net.parameters()), fp_leg.lam_net.Y_0)))
    print(f"the refined net written to {args.out}")
    print(f"card: {smi}")


if __name__ == "__main__":
    main()
