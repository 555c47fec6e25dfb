#!/usr/bin/env python3
"""Time the stopped backward's device plan (the lanes kernel) at each
layout, on one CUDA card, and print one JSON line.

    python3 experiments/torch_bwd_layouts.py [--root DIR]

``--root`` names the checkout whose ``pspde_torch`` is timed (default: the
one this script lives in), so that copies of the tree with a constant of
``csrc/stopped_rollout.cu`` changed (its register cap, its products' unit
width) can be timed in one call.  Cells: the Allen-Cahn notebook's net
(AllenCahn d=100, T=0.3, the sampling ball of radius 7, DenseNet (110,
110, 50) on [x, t] at weight scale 0.05, N=25, erfinv Philox noise) at
K=200 (the notebook's), 8192 and 65536; DenseNet (30, 30) at the elliptic
cell (ExponentialOnBallNonlinearSin d=50, N=20) with the device plan
forced, at K=8192 and 65536.  For each layout (tile, threads a lane, the
lanes' arrays in shared memory, the net staged) of LAYOUTS that the cell's
net fits: the device ms a launch (``torch.profiler``, over ``reps``
launches; up to three runs where the profiler drops them) and the warps
per SM (the occupancy API's theoretical residency); the layout the wrapper
chooses; and the tree's lanes-kernel registers and spill bytes from its
``-Xptxas -v`` report.
"""

import argparse
import json
import os
import subprocess
import sys

import torch

# (tile, threads a lane); each with the arrays in shared memory or the
# workspace and the net staged or not, where the block fits
LAYOUTS = ((64, 2), (64, 4), (32, 2), (32, 4), (32, 8), (16, 4), (16, 8),
           (16, 16), (8, 16), (8, 32))


def main():
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=here,
                    help="checkout whose pspde_torch is timed")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_bwd_layouts: this script needs one CUDA card")
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    sys.path.insert(1, os.path.join(here, "experiments"))
    sys.path.insert(2, here)
    from pspde_torch.ansatz import DenseNet
    from pspde_torch.problems import (AllenCahn,
                                      ExponentialOnBallNonlinearSin, Geometry)
    from pspde_torch.rollout import _build
    from pspde_torch.rollout import kernels as km
    from pspde_torch.rollout.sampling import sample_domain
    from torch_kernel_times import device_ms
    from chip_smoke import ptxas_usage

    dev = torch.device("cuda:0")
    _build.library()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(30)
    ac = AllenCahn(d=100, T=0.3, device=dev)
    ac.geometry = Geometry(kind="unbounded", boundary_distance=7.0)
    ac_net = DenseNet(1, (110, 110, 50), d_in=101, weight_scale=0.05,
                      device=dev,
                      generator=torch.Generator(dev).manual_seed(5))
    ball = ExponentialOnBallNonlinearSin(d=50, alpha=0.1, device=dev)
    e_net = DenseNet(1, (30, 30), d_in=50, device=dev,
                     generator=torch.Generator(dev).manual_seed(5))

    def ac_call(K):
        X0 = sample_domain(gen, ac.geometry, K, 100, uniform_square=True)
        t0 = torch.rand(K, generator=gen, device=dev) * ac.T
        return km._StoppedCall(
            ac, ac_net, X0, t0, 25, 1e-3, 17,
            km._check_stopped_family(ac, ac_net, "erfinv",
                                     time_stopping=True),
            dict(adaptive_forward=False, rng="erfinv", host_noise=None,
                 time_stopping=True), None)

    def e_call(K):
        X0 = sample_domain(gen, ball.geometry, K, 50)
        return km._StoppedCall(
            ball, e_net, X0, torch.zeros(K, device=dev), 20, 1e-3, 17,
            km._check_stopped_family(ball, e_net, "erfinv"),
            dict(adaptive_forward=False, rng="erfinv", host_noise=None),
            None, plan="device")

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    regs = sorted(ptxas_usage(_build.build_info["log"],
                              "stopped_bwd_lane_kernel").values())
    out = {"root": os.path.relpath(root, here), "card": card,
           "lane_kernel_registers_spills": regs, "cells": {}}
    for tag, call, reps in (("allen_cahn_200", ac_call(200), 5),
                            ("allen_cahn_8192", ac_call(8192), 3),
                            ("allen_cahn_65536", ac_call(65536), 2),
                            ("elliptic_8192", e_call(8192), 5),
                            ("elliptic_65536", e_call(65536), 5)):
        K = call.X0.shape[0]
        gY = torch.randn(K, generator=gen, device=dev) / K
        cell = out["cells"][tag] = {
            "chosen": list(km._stopped_bwd_lane_of(
                call.pack(backward=True))), "layouts": {}}
        for tile, tpp in LAYOUTS:
            for smem in (False, True):
                for stage in (False, True):
                    lay = (tile, tpp, smem, stage)
                    c = call._replace(bwd_layout=lay)
                    try:
                        packed = c.pack(backward=True)
                    except ValueError:
                        continue
                    warps = (km._stopped_bwd_slots(packed, dev) // sms
                             * tile * tpp // 32)
                    dms = None
                    for _ in range(3):
                        dms, _ = device_ms(
                            lambda c=c: km._stopped_backward_kernel(c, gY),
                            reps, "stopped_bwd")
                        if dms is not None:
                            break
                    cell["layouts"][str(lay)] = [dms, warps]
        best = sorted(cell["layouts"].items(),
                      key=lambda kv: float("inf") if kv[1][0] is None
                      else kv[1][0])
        print(f"{tag}: chosen {cell['chosen']}; " + "; ".join(
            f"{k} {v[0]:.3f} ({v[1]} warps)" for k, v in best
            if v[0] is not None), file=sys.stderr, flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
