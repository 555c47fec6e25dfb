#!/usr/bin/env python3
"""The stopped forward for nets that no block stages (the block kernel,
``stopped_fwd_block_kernel``): bitwise against the lanes kernel, and its
device time at each layout, on one CUDA card; prints one JSON line.

    python3 experiments/torch_fwd_layouts.py [--root DIR] [--no-sweep]

``--root`` names the checkout whose ``pspde_torch`` is timed (default: the
one this script lives in).  First the checks: the block kernel's seven
outputs (X, Y, t, stopped, hitting, v_l2, adv_steps) against the lanes
kernel's (``stopped_fwd_kernel`` forced at its own layout, and at one
thread a path where that fits), bitwise, on the Allen-Cahn notebook's net
(AllenCahn d=100, T=0.3, the sampling ball of radius 7, DenseNet (110,
110, 50) on [x, t] at weight scale 0.05, N=25) at K=200 and 8192 with
erfinv, binom and host noise, the adaptive drift and the output clamp, and
forced on DenseNet (30, 30) at the elliptic (d=50, K=8192, N=20), gen50
(d=50, [x, t]), heat (d=50, the whole space, K=4096, N=100) and torus
(FokkerPlanckEigen d=5, lambda 0.3, K=8192, N=20) cells, adaptive or not;
the run fails on the first difference.  Then (unless ``--no-sweep``) the
sweep: at the Allen-Cahn cell at K=200, 8192 and 65536, for each layout
(tile, threads, slice rows, ring buffers) of BLOCKS x ROWS x STAGES whose
block fits, the device ms a launch (``torch.profiler``; up to three runs
where the profiler drops a launch) and the warps per SM (the occupancy
API's theoretical residency), beside the lanes kernel's and the chosen
layout's; and the block kernel's registers and spill bytes from the
tree's ``-Xptxas -v`` report.  ``--only NAME`` runs the checks whose name holds
NAME (e.g. ``torus``, ``allen_cahn``).
"""

import argparse
import json
import os
import subprocess
import sys

import torch

# (tile, threads) of the sweep, each with slices of 4, 8 or 16 rows of the
# widest matrix in 2 or 3 buffers; tiles below MIN_TILE_LARGE_K are left
# out at K=65536, where they run tens of thousands of blocks
BLOCKS = ((1, 32), (1, 64), (1, 128), (2, 64), (2, 128), (4, 128), (4, 256),
          (8, 128), (8, 256), (16, 128), (16, 256), (32, 256))
ROWS = (4, 8, 16)
STAGES = (2, 3)
MIN_TILE_LARGE_K = 8


def main():
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=here,
                    help="checkout whose pspde_torch is timed")
    ap.add_argument("--no-sweep", action="store_true",
                    help="run the bitwise checks only")
    ap.add_argument("--only", default="",
                    help="run only the checks whose name holds this")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_fwd_layouts: this script needs one CUDA card")
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    sys.path.insert(1, os.path.join(here, "experiments"))
    sys.path.insert(2, here)
    from pspde_torch.ansatz import DenseNet
    from pspde_torch.problems import (AllenCahn, ExponentialOnBallNonlinearSin,
                                      ExponentialOnSphereNonlinearParabolic,
                                      FokkerPlanckEigen, Geometry,
                                      HeatEquation)
    from pspde_torch.rollout import _build
    from pspde_torch.rollout import kernels as km
    from pspde_torch.rollout.sampling import sample_domain
    from torch_kernel_times import device_ms
    from chip_smoke import ptxas_usage

    dev = torch.device("cuda:0")
    _build.library()
    gen = torch.Generator(device=dev).manual_seed(30)
    ac = AllenCahn(d=100, T=0.3, device=dev)
    ac.geometry = Geometry(kind="unbounded", boundary_distance=7.0)

    def ac_net(seed, relu=False):
        return DenseNet(1, (110, 110, 50), d_in=101, output_relu=relu,
                        weight_scale=0.05, device=dev,
                        generator=torch.Generator(dev).manual_seed(seed))

    def call_of(prob, net, K, N, dt, clock=False, lam=None, square=False,
                **opts):
        X0 = sample_domain(gen, prob.geometry, K, prob.d,
                           uniform_square=square)
        t0 = (torch.rand(K, generator=gen, device=dev) * prob.T if clock
              else torch.zeros(K, device=dev))
        o = dict(adaptive_forward=False, rng="erfinv", host_noise=None,
                 time_stopping=clock)
        o.update(opts)
        if o["host_noise"] is True:
            o["host_noise"] = torch.randn((N, K, prob.d), generator=gen,
                                          device=dev)
        return km._StoppedCall(
            prob, net, X0, t0, N, dt, 4321,
            km._check_stopped_family(prob, net, o["rng"], clock, lam), o,
            None, lam)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    regs = sorted(ptxas_usage(_build.build_info["log"],
                              "stopped_fwd_block_kernel").values())
    print(f"card: {card}; the block kernel's registers and spill bytes: "
          f"{regs}", file=sys.stderr, flush=True)
    out = {"root": os.path.relpath(root, here), "card": card,
           "block_kernel_registers_spills": regs, "checks": {},
           "cells": {}}

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    # -- the checks -----------------------------------------------------------
    ball = ExponentialOnBallNonlinearSin(d=50, alpha=0.1, device=dev)
    gen50 = ExponentialOnSphereNonlinearParabolic(d=50, device=dev)
    heat = HeatEquation(d=50, T=0.2, device=dev)
    heat.geometry = Geometry(kind="unbounded", boundary_distance=6.0)
    torus = FokkerPlanckEigen(d=5, device=dev)
    lam = torch.full((1,), 0.3, device=dev)
    cases = {}
    for K in (200, 8192):
        for tag, relu, opts in (("erfinv", False, {}),
                                ("binom", False, dict(rng="binom")),
                                ("host noise", False,
                                 dict(host_noise=True)),
                                ("adaptive", False,
                                 dict(adaptive_forward=True)),
                                ("clamp", True, {}),
                                ("clamp, adaptive, binom", True,
                                 dict(adaptive_forward=True, rng="binom"))):
            cases[f"allen_cahn K={K} {tag}"] = call_of(
                ac, ac_net(1 + relu, relu), K, 25, 1e-3, clock=True,
                square=True, **opts)
    for adaptive in (False, True):
        a = ", adaptive" if adaptive else ""
        net = DenseNet(1, (30, 30), d_in=50, device=dev,
                       generator=torch.Generator(dev).manual_seed(31))
        cases[f"elliptic{a}"] = call_of(ball, net, 8192, 20, 1e-3,
                                        adaptive_forward=adaptive)
        net = DenseNet(1, (30, 30), d_in=51, device=dev,
                       generator=torch.Generator(dev).manual_seed(31))
        cases[f"gen50{a}"] = call_of(gen50, net, 8192, 20, 1e-3, clock=True,
                                     adaptive_forward=adaptive)
        net = DenseNet(1, (30, 30), d_in=51, output_relu=True, device=dev,
                       generator=torch.Generator(dev).manual_seed(31))
        cases[f"heat{a}"] = call_of(heat, net, 4096, 100, 2e-3, clock=True,
                                    adaptive_forward=adaptive)
        net = DenseNet(1, (10, 10, 10, 10), d_in=5, output_relu=True,
                       device=dev,
                       generator=torch.Generator(dev).manual_seed(31))
        cases[f"torus{a}"] = call_of(torus, net, 8192, 20, 1e-3, lam=lam,
                                     adaptive_forward=adaptive)
    for tag, call in cases.items():
        if args.only not in tag:
            continue
        block = call._replace(fwd_kernel="block")
        lanes = call._replace(fwd_kernel="lanes")
        b = km._stopped_forward_kernel(block)
        b2 = km._stopped_forward_kernel(block)
        ln = km._stopped_forward_kernel(lanes)
        others = []
        for lay in ((32, 1, False), (64, 1, False)):
            try:
                others.append(km._stopped_forward_kernel(
                    call._replace(fwd_layout=lay)))
                break
            except ValueError:
                continue
        torch.cuda.synchronize()
        ok = same(b, ln) and same(b, b2) and all(same(b, o) for o in others)
        diff = {name: int((getattr(b, name) != getattr(ln, name)).sum())
                for name in b._fields}
        out["checks"][tag] = {
            "bitwise": ok,
            "block": list(call._replace(fwd_kernel="block").pack(False)
                          .layout),
            "lanes": list(lanes.pack(False).layout),
            "adv_steps": float(b.adv_steps.sum()),
            "finite": bool(torch.isfinite(b.Y).all()),
            "differing": {k: v for k, v in diff.items() if v}}
        print(f"{tag}: bitwise {ok} {out['checks'][tag]}", file=sys.stderr,
              flush=True)
    bad = [t for t, c in out["checks"].items() if not c["bitwise"]]
    if bad:
        print(json.dumps(out))
        sys.exit(f"torch_fwd_layouts: the block kernel differs from the "
                 f"lanes kernel at {bad}")
    if args.no_sweep:
        print(json.dumps(out))
        return

    # -- the sweep --------------------------------------------------------------
    net = ac_net(5)
    for K, reps in ((200, 10), (8192, 5), (65536, 3)):
        call = call_of(ac, net, K, 25, 1e-3, clock=True, square=True)
        packed = call.pack(False)
        chosen = list(packed.layout)
        cell = out["cells"][f"allen_cahn_{K}"] = {"chosen": chosen,
                                                  "layouts": {}}

        def timed(c):
            for _ in range(3):
                dms, _ = device_ms(lambda: km._stopped_forward_kernel(c),
                                   reps, "stopped_fwd")
                if dms is not None:
                    return dms
            return None

        lanes = call._replace(fwd_kernel="lanes")
        cell["lanes"] = [list(lanes.pack(False).layout), timed(lanes)]
        ref = km._stopped_forward_kernel(lanes)
        for tile, threads in BLOCKS:
            if K >= 65536 and tile < MIN_TILE_LARGE_K:
                continue
            for rows in ROWS:
                for stages in STAGES:
                    lay = (tile, threads, rows, stages)
                    c = call._replace(fwd_block=lay)
                    try:
                        p = c.pack(False)
                    except ValueError:
                        continue
                    occ = km._stopped_fwd_occupancy(p, dev)
                    warps = occ["warps_per_sm"]
                    got = km._stopped_forward_kernel(c)
                    torch.cuda.synchronize()
                    if not same(got, ref):
                        print(json.dumps(out))
                        sys.exit(f"torch_fwd_layouts: layout {lay} at K={K} "
                                 "differs from the lanes kernel")
                    cell["layouts"][str(lay)] = [timed(c), warps,
                                                 occ["smem_bytes"]]
        best = sorted(((k, v) for k, v in cell["layouts"].items()
                       if v[0] is not None), key=lambda kv: kv[1][0])
        ch = cell["layouts"].get(str(tuple(chosen)))
        print(f"allen_cahn K={K}: lanes {cell['lanes']}; chosen {chosen} "
              f"{ch}; fastest: " + "; ".join(
                  f"{k} {v[0]:.3f} ({v[1]} warps)" for k, v in best[:8]),
              file=sys.stderr, flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
