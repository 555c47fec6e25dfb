#!/usr/bin/env python3
"""Time the stopped backward's device plan (the lanes kernel) at each
layout, beside the shared plan, on one CUDA card, and print one JSON line.

    python3 experiments/torch_bwd_layouts.py [--root DIR]
        [--cells allen_cahn,elliptic,schrodinger,committor]

``--root`` names the checkout whose ``pspde_torch`` is timed (default: the
one this script lives in), so that copies of the tree with a constant of
the lanes kernel changed (its register cap, its products' unit width) can
be timed in one call.  Cells (``--cells`` picks some; default all): the
Allen-Cahn notebook's net (AllenCahn d=100, T=0.3, the sampling ball of
radius 7, DenseNet (110, 110, 50) on [x, t] at weight scale 0.05, N=25,
erfinv Philox noise) at K=200 (the notebook's), 8192 and 65536;
DenseNet (30, 30) at the elliptic cell (ExponentialOnBallNonlinearSin
d=50, N=20) with the device plan forced, at K=8192 and 65536; the
Schroedinger notebook's (SchrodingerEigen d=10, JAX's initial
DenseNetTanh (15, 15, 15, 15) with the clamp from
``pspde_torch/assets/schrodinger_d10_densenet_tanh.npz``, lambda -2, N=20,
dt 1e-3) and the committor notebook's (Committor d=10 between the spheres
1 and 2, JAX's initial DenseNet (30, 30) from
``committor_d10_densenet.npz``, N=50, dt 1e-3) at their notebooks' K (500,
200), at chip_smoke.py's check K (8192) and at 65536.  For each layout
(tile, threads a lane, the lanes' arrays in shared memory, the net staged)
of the cell's candidates that its net fits: the device ms a launch
(``torch.profiler``, over ``reps`` launches; up to three runs where the
profiler drops them) and the warps per SM (the occupancy API's
theoretical residency); the shared plan's device ms at the same inputs;
the layout and plan the wrapper chooses; and the tree's lanes-kernel
registers and spill bytes from its ``-Xptxas -v`` report.  At the
Schroedinger and committor cells the gradient rows of every layout of one
tile must be bitwise equal, and at tile 64 bitwise the shared plan's on
its grid (``bitwise`` in the JSON; the run fails where they are not).
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
# the Schroedinger and committor cells: tiles 8-64 at 2-16 threads a lane
# (the width-15 layers give the value and tangent sweeps 2 chunks of 8
# outputs, DenseNet (30, 30) 4, so fewer threads may win there)
SMALL_NET_LAYOUTS = ((64, 2), (64, 4), (32, 2), (32, 4), (32, 8), (16, 2),
                     (16, 4), (16, 8), (16, 16), (8, 4), (8, 8), (8, 16))
CELLS = ("allen_cahn", "elliptic", "schrodinger", "committor")


def main():
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=here,
                    help="checkout whose pspde_torch is timed")
    ap.add_argument("--cells", default=",".join(CELLS),
                    help="comma-separated cells of " + ", ".join(CELLS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_bwd_layouts: this script needs one CUDA card")
    cells = args.cells.split(",")
    if not set(cells) <= set(CELLS):
        sys.exit(f"torch_bwd_layouts: --cells takes {', '.join(CELLS)}")
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    sys.path.insert(1, os.path.join(here, "experiments"))
    sys.path.insert(2, here)
    from pspde_torch.ansatz import DenseNet, DenseNetTanh
    from pspde_torch.problems import (AllenCahn, Committor,
                                      ExponentialOnBallNonlinearSin, Geometry,
                                      SchrodingerEigen)
    from pspde_torch.rollout import _build
    from pspde_torch.rollout import kernels as km
    from pspde_torch.rollout.sampling import sample_domain
    from pspde_torch.utils.convert import (dense_net_from_flax,
                                           eigen_params_from_flax,
                                           load_control_npz)
    from torch_kernel_times import device_ms
    from chip_smoke import ptxas_usage

    dev = torch.device("cuda:0")
    _build.library()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(30)
    assets = os.path.join(here, "pspde_torch", "assets")

    def opts(**kw):
        return dict(dict(adaptive_forward=False, rng="erfinv",
                         host_noise=None), **kw)

    def ac_call(K):
        ac = AllenCahn(d=100, T=0.3, device=dev)
        ac.geometry = Geometry(kind="unbounded", boundary_distance=7.0)
        net = DenseNet(1, (110, 110, 50), d_in=101, weight_scale=0.05,
                       device=dev,
                       generator=torch.Generator(dev).manual_seed(5))
        X0 = sample_domain(gen, ac.geometry, K, 100, uniform_square=True)
        t0 = torch.rand(K, generator=gen, device=dev) * ac.T
        return km._StoppedCall(
            ac, net, X0, t0, 25, 1e-3, 17,
            km._check_stopped_family(ac, net, "erfinv", time_stopping=True),
            opts(time_stopping=True), None)

    def e_call(K):
        ball = ExponentialOnBallNonlinearSin(d=50, alpha=0.1, device=dev)
        net = DenseNet(1, (30, 30), d_in=50, device=dev,
                       generator=torch.Generator(dev).manual_seed(5))
        X0 = sample_domain(gen, ball.geometry, K, 50)
        return km._StoppedCall(
            ball, net, X0, torch.zeros(K, device=dev), 20, 1e-3, 17,
            km._check_stopped_family(ball, net, "erfinv"), opts(), None,
            plan="device")

    def sch_call(K):
        sch = SchrodingerEigen(d=10, device=dev)
        tree, _ = load_control_npz(os.path.join(
            assets, "schrodinger_d10_densenet_tanh.npz"))
        net, _ = eigen_params_from_flax(tree, output_relu=True, device=dev,
                                        cls=DenseNetTanh)
        lam = torch.full((1,), -2.0, device=dev)
        X0 = sample_domain(gen, sch.geometry, K, 10)
        return km._StoppedCall(
            sch, net, X0, torch.zeros(K, device=dev), 20, 1e-3, 17,
            km._check_stopped_family(sch, net, "erfinv", lam=lam),
            opts(time_stopping=False), None, lam)

    def com_call(K):
        com = Committor(d=10, device=dev)
        tree, _ = load_control_npz(os.path.join(assets,
                                                "committor_d10_densenet.npz"))
        net = dense_net_from_flax(tree, device=dev)
        X0 = sample_domain(gen, com.geometry, K, 10)
        return km._StoppedCall(
            com, net, X0, torch.zeros(K, device=dev), 50, 1e-3, 17,
            km._check_stopped_family(com, net, "erfinv"), opts(), None)

    plan = []
    if "allen_cahn" in cells:
        plan += [("allen_cahn_200", ac_call(200), 5, LAYOUTS),
                 ("allen_cahn_8192", ac_call(8192), 3, LAYOUTS),
                 ("allen_cahn_65536", ac_call(65536), 2, LAYOUTS)]
    if "elliptic" in cells:
        plan += [("elliptic_8192", e_call(8192), 5, LAYOUTS),
                 ("elliptic_65536", e_call(65536), 5, LAYOUTS)]
    if "schrodinger" in cells:
        plan += [(f"schrodinger_{K}", sch_call(K), reps, SMALL_NET_LAYOUTS)
                 for K, reps in ((500, 20), (8192, 10), (65536, 5))]
    if "committor" in cells:
        plan += [(f"committor_{K}", com_call(K), reps, SMALL_NET_LAYOUTS)
                 for K, reps in ((200, 20), (8192, 10), (65536, 5))]

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    regs = sorted(ptxas_usage(_build.build_info["log"],
                              "stopped_bwd_lane_kernel").values())
    out = {"root": os.path.relpath(root, here), "card": card,
           "lane_kernel_registers_spills": regs, "cells": {}}
    failed = []

    def timed(c, gY, reps):
        dms = None
        for _ in range(3):
            dms, _ = device_ms(lambda: km._stopped_backward_kernel(c, gY),
                               reps, "stopped_bwd")
            if dms is not None:
                break
        return dms

    for tag, call, reps, layouts in plan:
        K = call.X0.shape[0]
        gY = torch.randn(K, generator=gen, device=dev) / K
        packed = call.pack(backward=True)
        chosen = km._stopped_bwd_lane_of(packed)
        cell = out["cells"][tag] = {
            "chosen": (["shared"] if chosen is None else list(chosen)),
            "layouts": {}}
        new_family = tag.startswith(("schrodinger", "committor"))
        shared = call._replace(plan="shared", bwd_layout=None)
        try:
            shared_packed = shared.pack(backward=True)
        except ValueError:
            shared_packed = None
        if shared_packed is not None:
            cell["shared"] = timed(shared, gY, reps)
        rows = {}
        for tile, tpp in layouts:
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
                    cell["layouts"][str(lay)] = [timed(c, gY, reps), warps]
                    if new_family and shared_packed is not None:
                        # on the shared plan's grid, so that the rows of
                        # one tile, and at tile 64 the shared plan's, are
                        # the same blocks' sums
                        rows[lay] = km._stopped_backward_rows(
                            c, gY, km._stopped_bwd_grid(shared_packed, dev))
        if new_family and shared_packed is not None:
            grid = km._stopped_bwd_grid(shared_packed, dev)
            ref = km._stopped_backward_rows(shared, gY, grid)
            torch.cuda.synchronize()
            same_tile = all(
                torch.equal(r[0], rows[next(k for k in rows
                                            if k[0] == lay[0])][0])
                for lay, r in rows.items())
            vs_shared = all(torch.equal(r[0], ref[0])
                            and torch.equal(r[1], ref[1])
                            for lay, r in rows.items() if lay[0] == 64)
            cell["bitwise"] = {"every_layout_of_a_tile": same_tile,
                               "tile_64_against_shared": vs_shared,
                               "grid": grid}
            if not (same_tile and vs_shared):
                failed.append(tag)
        best = sorted(cell["layouts"].items(),
                      key=lambda kv: float("inf") if kv[1][0] is None
                      else kv[1][0])
        print(f"{tag}: chosen {cell['chosen']}; shared "
              f"{cell.get('shared')}; " + "; ".join(
                  f"{k} {v[0]:.4f} ({v[1]} warps)" for k, v in best
                  if v[0] is not None)
              + (f"; bitwise {cell['bitwise']}" if "bitwise" in cell
                 else ""), file=sys.stderr, flush=True)
    print(json.dumps(out))
    if failed:
        sys.exit(f"torch_bwd_layouts: gradient rows not bitwise at {failed}")


if __name__ == "__main__":
    main()
