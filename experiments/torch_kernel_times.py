#!/usr/bin/env python3
"""Time the PyTorch port's serve, HJB training and stopped training
kernels at the bench shapes on one CUDA card, and print one JSON line.

    python3 experiments/torch_kernel_times.py [--root DIR] [--hjb-only]
        [--stopped-only] [--serve-only] [--layouts [hjb|stopped|serve]]
        [--fwd-bwd] [--allen-cahn] [--sch-committor]

``--root`` names the checkout whose ``pspde_torch`` is timed (default:
the one this script lives in).  Two trees are compared on one card in one
command: unpack the other with ``git archive`` into a directory that
``.gitignore`` lists and run parent, change, change, parent, e.g.

    for r in build/parent . . build/parent; do
        python3 experiments/torch_kernel_times.py --root $r; done

Each kernel is timed with CUDA events, best of two rounds: the serve
kernel at LLGC d=100 with the exported control, K=2^20, N=100, Philox
noise, and at LLGC d=1000, T=2, N=200, K=8192 (BASELINE config 5's width,
TanhMLP [1001, 30, 30, 1000] from a seed; ``--serve-only`` times these two
alone); the training forward and replay backward at K=131072, N=32, binom
and erfinv noise, u_tab, and one ``HJBSolver.step()`` at that shape for
each map; the ablation ladder's stages there; BASELINE config 5 (LLGC
d=1000, T=2, N=200, K=98304: forward, backward, one step, the ladder's
stages) and its step at K=8192 against the plain (scan) step.  Where the
tree's kernels take ``plan=``, the three kernels are timed again with the
device memory plan forced (the net read from device memory, each path's
arrays in a [row][K] workspace), against the shared plan they choose at
d=100.  The stopped forward and replay backward are timed at the elliptic
cell (ExponentialOnBallNonlinearSin d=50, K=65536, N=20, erfinv noise) for
DenseNet (30, 30) and the notebook net (70, 50, 50, 50), with one
``EllipticSolver.step()``, and with ``time_stopping`` at the gen50 cell
(ExponentialOnSphereNonlinearParabolic d=50, K=65536, N=20) and at the
heat cell (HeatEquation d=50, T=0.2, the whole space, K=4096, N=100),
DenseNet (30, 30) on [x, t], and on the torus (FokkerPlanckEigen d=5,
N=20, the notebook's DenseNet (10, 10, 10, 10), lambda = 0.3) at K=500 and
K=65536; the forward's device time per launch is also read from
``torch.profiler`` at every cell, the backward's on the torus (``*_device``
keys: at K=500 the events time the host's launches as much as the
kernel).  ``--hjb-only`` leaves out the
serve and stopped kernels; ``--stopped-only`` times only the stopped
kernels and their solvers' steps: the elliptic step for both nets, the
gen50 and config-2 ``GeneralSolver`` steps and the ``EigenSolver`` step of
the notebook recipe at K=500 and 65536.  ``--layouts`` (a tree whose
forward has threads per path) times the HJB forward at the bench shape
and at config 5 for each tile and threads-per-path layout, with the
blocks per SM of each, and the stopped forward (a tree with forced
layouts) at the elliptic cell for both nets, gen50, heat and the torus at
K=500 and 65536 for each tile, threads per lane and grid (refilled lanes
or one block per tile), with the warps per SM and bytes a block of each,
whether its outputs are bitwise those of one thread a path at one tile a
block, and its device time from ``torch.profiler`` beside the events'
(which time the host's launches too where a launch is short);
``--layouts serve`` times the serve kernel at each tile, threads per path
and memory plan whose block fits, at K=2^20 and K=8192 (d=100) and at
d=1000, K=8192, with the warps per SM and bytes a block of each and
whether its outputs are bitwise those of the layout the wrapper chooses
(how the serve's layout rule was settled); ``--layouts hjb`` or
``--layouts stopped`` times one of the forwards, ``--layouts`` all
three.
``--fwd-bwd`` times only the HJB forward and backward kernels, at the
bench shape (binom) and at config 5.  ``--allen-cahn`` times the stopped
kernels at their cells (as ``--stopped-only``, without the steps) and,
where the tree has them, the Allen-Cahn pair (AllenCahn d=100, T=0.3, the
notebook's DenseNet (110, 110, 50) on [x, t] and sampling ball of radius
7, N=25, at K=65536 and at the notebook's K=200; its backward on the
device plan) and the stopped
backward's device plan forced at the elliptic (DenseNet (30, 30)) and
heat cells beside the shared plan, with the profiler's device time; a
tree without them reads None there.  ``--sch-committor`` times only the
stopped pair of the Schroedinger notebook (SchrodingerEigen d=10, JAX's
initial DenseNetTanh (15, 15, 15, 15) with the clamp, lambda -2.5, N=20)
at its K=500 and at K=65536, and of the committor notebook (Committor
d=10, JAX's initial DenseNet (30, 30)) at its K=200, N=50 and at JAX's
'com10' cell, K=65536, N=25: CUDA events and the profiler's device ms a
launch of either forward and either backward kernel, and the backward's
plan and layout as the tree chooses them.
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

D, N_SERVE, DT_SERVE, K_SERVE = 100, 100, 0.01, 2 ** 20
N_TRAIN, K_TRAIN = 32, 131072
D_ELL, N_ELL, DT_ELL, K_ELL = 50, 20, 1e-3, 65536
NETS_ELL = {"30_30": (30, 30), "notebook": (70, 50, 50, 50)}


def timed(fn, reps, rounds=2):
    """Best ms per call of ``fn`` over ``rounds`` rounds of ``reps`` calls,
    after one warm-up call."""
    fn()
    best = float("inf")
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(stop) / reps)
    return best


def device_ms(fn, reps, kernel):
    """(device ms a launch, launches seen) of the CUDA kernels whose name
    holds ``kernel`` over ``reps`` calls of ``fn``, from torch.profiler;
    (None, 0) where the profiler saw no such kernel.  The time is averaged
    over the launches the profiler recorded, which can be fewer than
    ``reps``."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    def device_us(e):
        us = getattr(e, "device_time_total", None)
        return e.cuda_time_total if us is None else us

    rows = [e for e in prof.key_averages() if kernel in e.key]
    us = sum(device_us(e) for e in rows)
    seen = sum(e.count for e in rows)
    return (us / 1e3 / seen if us else None), seen


def main():
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=here,
                    help="checkout whose pspde_torch is timed")
    ap.add_argument("--hjb-only", action="store_true",
                    help="time the HJB training kernels only")
    ap.add_argument("--layouts", nargs="?", const="all",
                    choices=("all", "hjb", "stopped", "serve"),
                    help="time the forwards' layouts (tile, threads per "
                         "path; the stopped forward's grid)")
    ap.add_argument("--stopped-only", action="store_true",
                    help="time the stopped kernels and steps only")
    ap.add_argument("--serve-only", action="store_true",
                    help="time the serve kernel only, at both of its shapes")
    ap.add_argument("--fwd-bwd", action="store_true",
                    help="time the HJB forward and backward kernels only")
    ap.add_argument("--allen-cahn", action="store_true",
                    help="time the stopped kernels, the Allen-Cahn pair and "
                         "the stopped backward's forced device plan only")
    ap.add_argument("--sch-committor", action="store_true",
                    help="time the Schroedinger and committor notebooks' "
                         "stopped pairs only")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_kernel_times: this script needs one CUDA card")
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from pspde_torch.problems import LLGC
    from pspde_torch.rollout import kernels as km
    from pspde_torch.solvers import HJBSolver

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    llgc = LLGC(d=D, T=1.0, device=dev)
    solver = HJBSolver("llgc_d100", llgc, K=1024, delta_t=1 / 32,
                       time_approx="inner", learn_Y_0=True, device=dev)
    solver.load_jax_params(os.path.join(root, "pspde_torch", "assets",
                                        "llgc_d100_tanhmlp.npz"))
    bench = HJBSolver("llgc_d100_bench", llgc, lr=1e-3, L=1, K=K_TRAIN,
                      delta_t=1 / N_TRAIN, time_approx="inner",
                      loss_method="log-variance", detach_forward=True,
                      learn_Y_0=True, verbose=False, early_stopping_time=None,
                      rollout_mode="fused_train", device=dev)
    bench.fused_rng = "binom"
    net, dt = bench.z_net, 1.0 / N_TRAIN
    u_tab = llgc.u_ref_table(np.arange(N_TRAIN) * dt)
    gen = torch.Generator(device=dev).manual_seed(17)
    gY = torch.randn(K_TRAIN, generator=gen, device=dev)
    gKL = torch.zeros(K_TRAIN, device=dev)
    call = km._TrainCall(
        llgc, net, K_TRAIN, N_TRAIN, dt, 17,
        km._check_train_family(llgc, net, N_TRAIN, 1.0, u_tab, "binom"),
        dict(adaptive_forward=True, accumulate_kl=False, kl_ito_term=False,
             u_tab=u_tab, rng="binom", noise_sign=1.0, host_noise=None),
        None)
    has_plans = "plan" in km._TrainCall._fields

    def kernels(plan):
        kw = {} if plan is None else {"plan": plan}
        c = call if plan is None else call._replace(plan=plan)

        def serve():
            km.fused_controlled_rollout(llgc, solver.z_net, K_SERVE, N_SERVE,
                                        DT_SERVE, seed=5, **kw)

        def fwd():
            km.fused_train_rollout(llgc, net, K_TRAIN, N_TRAIN, dt, 17,
                                   u_tab=u_tab, rng="binom", **kw)

        with torch.no_grad():
            # the serve's own layout at K=2^20 is serve_d100 (serve_times)
            times = {} if plan is None else {"serve": timed(serve, 5)}
            return dict(times, fwd=timed(fwd, 10),
                        bwd=timed(lambda: km._train_backward_kernel(c, gY,
                                                                    gKL), 5))

    out = {"root": os.path.relpath(root, here), "card": card}
    if args.serve_only:
        out.update(serve_times(llgc, solver.z_net, dev))
        print(json.dumps(out))
        return
    if args.sch_committor:
        out.update(sch_committor_times(root, dev, gen))
        print(json.dumps(out))
        return
    if args.allen_cahn:
        out.update(stopped_times(dev, gen, step=False))
        out.update(allen_cahn_times(dev, gen))
        print(json.dumps(out))
        return
    if args.stopped_only:
        out.update(stopped_times(dev, gen))
        out.update(stopped_steps(dev))
        print(json.dumps(out))
        return
    if args.layouts or args.fwd_bwd:
        if args.fwd_bwd:
            out.update(fwd_bwd_times(llgc, net, u_tab, dev, gen))
        if args.layouts in ("all", "hjb"):
            out.update(layout_times(llgc, net, u_tab, dev))
        if args.layouts in ("all", "stopped"):
            out.update(stopped_layout_times(dev, gen))
        if args.layouts in ("all", "serve"):
            out.update(serve_layout_times(llgc, solver.z_net, dev))
        print(json.dumps(out))
        return
    if not args.hjb_only:
        out.update(serve_times(llgc, solver.z_net, dev))
        out.update({f"{k}_default": v for k, v in kernels(None).items()})
        if has_plans:
            out.update({f"{k}_device": v
                        for k, v in kernels("device").items()})
    out["step"] = timed(bench.step, 5)
    out.update(hjb_times(llgc, bench, net, u_tab, dev, gen))
    if not args.hjb_only:
        out.update(stopped_times(dev, gen))
    print(json.dumps(out))


def serve_cells(llgc, z_net, dev):
    """{cell: (problem, net, K, N, dt, reps)}: the serve kernel's shapes,
    LLGC d=100 with the exported control at K=2^20 (and at K=8192, the
    size of chip_smoke.py's checks) and LLGC d=1000 at K=8192, N=200 with a
    TanhMLP [1001, 30, 30, 1000] from a seed (and at K=65536, where the
    device plan's blocks fill the card)."""
    from pspde_torch.ansatz import TanhMLP
    from pspde_torch.problems import LLGC

    llgc5 = LLGC(d=1000, T=2.0, device=dev)
    net5 = TanhMLP(1001, 1000, init_scale=0.1, device=dev,
                   generator=torch.Generator(dev).manual_seed(5))
    return {"d100": (llgc, z_net, K_SERVE, N_SERVE, DT_SERVE, 3),
            "d100_k8192": (llgc, z_net, 8192, N_SERVE, DT_SERVE, 20),
            "d1000": (llgc5, net5, 8192, 200, 0.01, 2),
            "d1000_k65536": (llgc5, net5, 65536, 200, 0.01, 1)}


def serve_times(llgc, z_net, dev):
    """ms of the serve kernel at K=2^20, d=100 and at d=1000, K=8192, as
    the wrapper chooses its layout (the tree's own)."""
    from pspde_torch.rollout import kernels as km

    out = {}
    for tag, (prob, net, K, N, dt, reps) in serve_cells(llgc, z_net,
                                                        dev).items():
        if tag in ("d100", "d1000"):
            out[f"serve_{tag}"] = timed(lambda: km.fused_controlled_rollout(
                prob, net, K, N, dt, seed=5), reps)
    return out


def serve_layout_times(llgc, z_net, dev):
    """ms of the serve kernel at each cell of ``serve_cells`` for each
    (tile, threads per path, plan) layout whose block fits, with the
    occupancy API's warps per SM and bytes a block and whether its outputs
    are bitwise those of the wrapper's chosen layout."""
    from pspde_torch.rollout import kernels as km

    if not hasattr(km, "_serve_kernel"):
        return {}
    out = {}
    for tag, (prob, net, K, N, dt, reps) in serve_cells(llgc, z_net,
                                                        dev).items():
        drift, cost = km._check_family(prob, net, True, 1.0)
        chosen = km._pack(prob, net, drift, cost, K, N, dt, None, None, 1.0)
        out[f"serve_{tag}_chosen"] = "%dx%d %s" % (
            chosen.iargs[5], chosen.iargs[-3], km._plan_of(chosen))
        with torch.no_grad():
            ref = km._serve_kernel(chosen, None, 5, dev)
            for tile in (32, 64, 96, 128):
                for tpp in (1, 2, 4):
                    for plan in km.PLANS:
                        try:
                            packed = km._pack(prob, net, drift, cost, K, N,
                                              dt, tile, None, 1.0, plan, tpp)
                        except ValueError:
                            continue   # no block of this layout fits
                        occ = km._train_fwd_occupancy(
                            packed, dev, "pspde_serve_occupancy")
                        got = km._serve_kernel(packed, None, 5, dev)
                        same = all(torch.equal(a, b)
                                   for a, b in zip(got, ref))
                        out[f"serve_{tag}_t{tile}_p{tpp}_{plan}"] = {
                            "ms": timed(lambda: km._serve_kernel(
                                packed, None, 5, dev), reps),
                            "warps_per_sm": occ["warps_per_sm"],
                            "smem_bytes": occ["smem_bytes"],
                            "bitwise": same}
                        del got
    return out


def _ablation_stages(problem, net, K, N, dt, reps):
    """ms per launch of each ladder stage (the tree's own stages)."""
    from pspde_torch.utils import roofline as rf
    return {stage: timed(lambda: rf.ablation(stage, problem, net, K, N, dt,
                                             seed=3), reps)
            for stage in rf.ABLATION_STAGES}


def hjb_times(llgc, bench, net, u_tab, dev, gen):
    """The HJB training kernels beyond the binom bench row: the forward,
    the backward and the step on the erfinv map at the bench shape; the
    ladder's stages there; config 5's kernels, step and ladder; and config
    5's step at K=8192 against the plain (scan) step."""
    from pspde_torch.problems import LLGC
    from pspde_torch.rollout import kernels as km
    from pspde_torch.solvers import HJBSolver
    from pspde_torch.utils import cosine_decay_schedule

    out = {}
    dt = 1.0 / N_TRAIN
    gY = torch.randn(K_TRAIN, generator=gen, device=dev)
    gKL = torch.zeros(K_TRAIN, device=dev)
    for rng in ("binom", "erfinv"):
        call = km._TrainCall(
            llgc, net, K_TRAIN, N_TRAIN, dt, 17,
            km._check_train_family(llgc, net, N_TRAIN, 1.0, u_tab, rng),
            dict(adaptive_forward=True, accumulate_kl=False,
                 kl_ito_term=False, u_tab=u_tab, rng=rng, noise_sign=1.0,
                 host_noise=None), None)
        with torch.no_grad():
            out[f"fwd_{rng}"] = timed(lambda: km.fused_train_rollout(
                llgc, net, K_TRAIN, N_TRAIN, dt, 17, u_tab=u_tab, rng=rng),
                10)
        out[f"bwd_{rng}"] = timed(
            lambda: km._train_backward_kernel(call, gY, gKL), 5)
        bench.fused_rng = rng
        out[f"step_{rng}"] = timed(bench.step, 5)
    bench.fused_rng = "binom"
    out.update({f"ladder_{k}": v for k, v in _ablation_stages(
        llgc, net, K_TRAIN, N_TRAIN, dt, 5).items()})

    d5, N5, dt5, K5 = 1000, 200, 0.01, 98304
    llgc5 = LLGC(d=d5, T=2.0, device=dev)

    def solver5(K, mode):
        return HJBSolver("config5", llgc5,
                         lr=cosine_decay_schedule(1e-2, 20000, alpha=1e-2),
                         L=20000, K=K, delta_t=dt5, time_approx="inner",
                         loss_method="log-variance", detach_forward=True,
                         learn_Y_0=True, verbose=False,
                         early_stopping_time=None, seed=5,
                         rollout_mode=mode, fused_rng="binom", device=dev)

    s5 = solver5(K5, "fused_train")
    u5 = s5._u_tab
    call5 = km._TrainCall(
        llgc5, s5.z_net, K5, N5, dt5, 3,
        km._check_train_family(llgc5, s5.z_net, N5, 1.0, u5, "binom"),
        dict(adaptive_forward=True, accumulate_kl=False, kl_ito_term=False,
             u_tab=u5, rng="binom", noise_sign=1.0, host_noise=None), None)
    gY5 = torch.randn(K5, generator=gen, device=dev) / K5
    with torch.no_grad():
        out["c5_fwd"] = timed(lambda: km.fused_train_rollout(
            llgc5, s5.z_net, K5, N5, dt5, 3, u_tab=u5), 1)
    out["c5_bwd"] = timed(lambda: km._train_backward_kernel(
        call5, gY5, torch.zeros_like(gY5)), 1)
    out["c5_step"] = timed(s5.step, 1)
    out.update({f"c5_ladder_{k}": v for k, v in _ablation_stages(
        llgc5, s5.z_net, K5, N5, dt5, 1).items()})
    del s5, call5
    torch.cuda.empty_cache()
    out["c5_k8192_fused_step"] = timed(solver5(8192, "fused_train").step, 2)
    out["c5_k8192_plain_step"] = timed(solver5(8192, "scan").step, 2)
    return out


def fwd_bwd_times(llgc, net, u_tab, dev, gen):
    """ms of the HJB forward (binom) and backward kernels at the bench
    shape and at config 5 (the kernels of hjb_times, alone)."""
    from pspde_torch.ansatz import TanhMLP
    from pspde_torch.problems import LLGC
    from pspde_torch.rollout import kernels as km

    llgc5 = LLGC(d=1000, T=2.0, device=dev)
    net5 = TanhMLP(1001, 1000, init_scale=0.1, device=dev,
                   generator=torch.Generator(dev).manual_seed(5))
    u5 = llgc5.u_ref_table(np.arange(200) * 0.01)
    out = {}
    for tag, (prob, z, K, N, dt, u, reps) in {
            "": (llgc, net, K_TRAIN, N_TRAIN, 1.0 / N_TRAIN, u_tab, 10),
            "c5_": (llgc5, net5, 98304, 200, 0.01, u5, 1)}.items():
        call = km._TrainCall(
            prob, z, K, N, dt, 17,
            km._check_train_family(prob, z, N, 1.0, u, "binom"),
            dict(adaptive_forward=True, accumulate_kl=False,
                 kl_ito_term=False, u_tab=u, rng="binom", noise_sign=1.0,
                 host_noise=None), None)
        gY = torch.randn(K, generator=gen, device=dev) / K
        with torch.no_grad():
            out[f"{tag}fwd"] = timed(lambda: km.fused_train_rollout(
                prob, z, K, N, dt, 17, u_tab=u), reps)
        out[f"{tag}bwd"] = timed(lambda: km._train_backward_kernel(
            call, gY, torch.zeros_like(gY)), max(1, reps // 2))
    return out


def layout_times(llgc, net, u_tab, dev):
    """ms of the forward at the bench shape (binom) and at config 5 for each
    (tile, threads per path) layout, and its blocks per SM."""
    from pspde_torch.problems import LLGC
    from pspde_torch.rollout import kernels as km
    from pspde_torch.ansatz import TanhMLP

    if not hasattr(km, "_FWD_TPP"):
        return {}
    llgc5 = LLGC(d=1000, T=2.0, device=dev)
    net5 = TanhMLP(1001, 1000, init_scale=0.1, device=dev,
                   generator=torch.Generator(dev).manual_seed(5))
    u5 = llgc5.u_ref_table(np.arange(200) * 0.01)
    cases = {"bench": (llgc, net, K_TRAIN, N_TRAIN, 1.0 / N_TRAIN, u_tab, 10),
             "c5": (llgc5, net5, 98304, 200, 0.01, u5, 1)}
    layouts = [(tag, tile, tpp) for tag in cases for tile in (32, 64, 128)
               for tpp in (1, 2, 4) if tile * tpp <= km._FWD_THREADS]
    out, default = {}, dict(km._FWD_TPP)
    try:
        for tag, tile, tpp in layouts:
            prob, z, K, N, dt, u, reps = cases[tag]
            # the wrapper reads its threads per path from this private table
            # at each launch: patched here, for this experiment only, and
            # restored at the end
            km._FWD_TPP = dict.fromkeys(default, tpp)
            try:
                call = km._TrainCall(
                    prob, z, K, N, dt, 17,
                    km._check_train_family(prob, z, N, 1.0, u, "binom"),
                    dict(adaptive_forward=True, accumulate_kl=False,
                         kl_ito_term=False, u_tab=u, rng="binom",
                         noise_sign=1.0, host_noise=None), tile)
                occ = km._train_fwd_occupancy(call.pack(False), dev)
            except ValueError:
                continue   # no block of this tile fits
            with torch.no_grad():
                ms = timed(lambda: km.fused_train_rollout(
                    prob, z, K, N, dt, 17, u_tab=u, tile=tile), reps)
            out[f"{tag}_t{tile}_p{tpp}"] = {
                "ms": ms, "plan": occ["plan"],
                "warps_per_sm": occ["warps_per_sm"],
                "smem_bytes": occ["smem_bytes"]}
    finally:
        km._FWD_TPP = default
    return out


def stopped_cells(dev, gen):
    """{cell: (problem, net, X0, t0, N, dt, lam, time_stopping)}: the stopped
    kernels' cells of chip_smoke.py (phases 12, 17, 19, 22)."""
    from pspde_torch.ansatz import DenseNet
    from pspde_torch.problems import (ExponentialOnBallNonlinearSin,
                                      ExponentialOnSphereNonlinearParabolic,
                                      FokkerPlanckEigen, Geometry,
                                      HeatEquation)
    from pspde_torch.rollout.sampling import sample_domain

    def net(arch, d_in):
        return DenseNet(1, arch, d_in=d_in, device=dev,
                        generator=torch.Generator(dev).manual_seed(5))

    sin = ExponentialOnBallNonlinearSin(d=D_ELL, alpha=0.1, device=dev)
    X0 = sample_domain(gen, sin.geometry, K_ELL, D_ELL)
    zeros = torch.zeros(K_ELL, device=dev)
    cells = {f"ell_{tag}": (sin, net(arch, D_ELL), X0, zeros, N_ELL, DT_ELL,
                            None, False)
             for tag, arch in NETS_ELL.items()}
    heat = HeatEquation(d=D_ELL, T=0.2, device=dev)
    heat.geometry = Geometry(kind="unbounded", boundary_distance=6.0)
    for tag, prob, K, N, dt in (
            ("gen50", ExponentialOnSphereNonlinearParabolic(d=D_ELL,
                                                            device=dev),
             K_ELL, N_ELL, DT_ELL),
            ("heat", heat, 4096, 100, 2e-3)):
        cells[tag] = (prob, net((30, 30), D_ELL + 1),
                      sample_domain(gen, prob.geometry, K, D_ELL),
                      torch.rand(K, generator=gen, device=dev) * prob.T, N,
                      dt, None, True)
    fp = FokkerPlanckEigen(d=5, device=dev)
    for K in (500, 65536):
        cells[f"torus_{K}"] = (fp, net((10, 10, 10, 10), 5),
                               sample_domain(gen, fp.geometry, K, 5),
                               torch.zeros(K, device=dev), 20, 1e-3,
                               torch.full((1,), 0.3, device=dev), False)
    return cells


def stopped_call(km, cell, **kw):
    """The kernels' call at one cell of ``stopped_cells``: seed 17, erfinv
    noise, not adaptive; ``kw`` more fields (a forced ``fwd_layout``)."""
    prob, net, X0, t0, N, dt, lam, timed = cell
    return km._StoppedCall(
        prob, net, X0, t0, N, dt, 17,
        km._check_stopped_family(prob, net, "erfinv", timed, lam),
        dict(adaptive_forward=False, rng="erfinv", host_noise=None,
             time_stopping=timed), None, lam, **kw)


def stopped_layout_times(dev, gen):
    """ms of the stopped forward at each cell of ``stopped_cells`` for each
    layout (tile, threads per lane, refilled lanes or one block per tile)
    whose block fits, with its warps per SM and bytes a block (the
    occupancy API's) and whether its outputs are bitwise those of one thread
    a path at one tile a block (64, or 32 where 64 does not fit)."""
    from pspde_torch.rollout import kernels as km

    if not hasattr(km, "_FwdLayout"):
        return {}
    out = {}
    for tag, cell in stopped_cells(dev, gen).items():
        call = stopped_call(km, cell)
        K = cell[2].shape[0]
        reps = 20 if K <= 4096 else 10
        chosen = km._FwdLayout(*call.pack(False).layout)
        out[f"stopped_{tag}_chosen"] = "%dx%d%s" % (
            chosen.tile, chosen.tpp, "r" if chosen.refill else "")
        ref = None
        for tile in (64, 32):
            try:
                ref = km._stopped_forward_kernel(
                    call._replace(fwd_layout=(tile, 1, False)))
                break
            except ValueError:
                continue
        for tile in km._STOPPED_FWD_TILES:
            for tpp in km._STOPPED_FWD_TPP:
                for refill in (True, False):
                    c = call._replace(fwd_layout=(tile, tpp, refill))
                    try:
                        packed = c.pack(False)
                    except ValueError:
                        continue   # not a layout, or no block fits
                    occ = km._stopped_fwd_occupancy(packed, dev)
                    got = km._stopped_forward_kernel(c)
                    same = all(torch.equal(a, b) for a, b in zip(got, ref))
                    # the events time the host's launches too where a
                    # launch is short: the choice reads the device time
                    row = {"ms": timed(lambda: km._stopped_forward_kernel(c),
                                       reps),
                           "device_ms": device_ms(
                               lambda: km._stopped_forward_kernel(c), reps,
                               "stopped_fwd_kernel")[0],
                           "grid": km._stopped_fwd_grid(packed, dev),
                           "warps_per_sm": occ["warps_per_sm"],
                           "smem_bytes": occ["smem_bytes"], "bitwise": same}
                    out[f"stopped_{tag}_t{tile}_p{tpp}"
                        f"{'_r' if refill else ''}"] = row
    return out


def stopped_times(dev, gen, step=True):
    """ms of the stopped kernels at each cell of ``stopped_cells`` (the
    forward's device time too, from ``torch.profiler``; on the torus the
    backward's as well), and with ``step`` of one elliptic solver step."""
    from pspde_torch.problems import ExponentialOnBallNonlinearSin
    from pspde_torch.rollout import kernels as km
    from pspde_torch.solvers import EllipticSolver

    out = {}
    for tag, cell in stopped_cells(dev, gen).items():
        call = stopped_call(km, cell)
        K = cell[2].shape[0]
        gY = torch.randn(K, generator=gen, device=dev) / K
        reps = 20 if K <= 4096 else 10
        name = tag.replace("ell_", "")

        def fwd():
            km._stopped_forward_kernel(call)

        def bwd():
            km._stopped_backward_kernel(call, gY)

        out[f"stopped_fwd_{name}"] = timed(fwd, reps)
        out[f"stopped_fwd_{name}_device"] = device_ms(
            fwd, reps, "stopped_fwd_kernel")[0]
        out[f"stopped_bwd_{name}"] = timed(bwd, reps // 2)
        if name.startswith("torus"):
            out[f"stopped_bwd_{name}_device"] = device_ms(
                bwd, reps // 2, "stopped_bwd_kernel")[0]
    if not step:
        return out
    sin = ExponentialOnBallNonlinearSin(d=D_ELL, alpha=0.1, device=dev)
    ell = EllipticSolver(sin, "bench", loss_method="diffusion", K=K_ELL,
                         N=N_ELL, delta_t=DT_ELL, lr=1e-3, L=1,
                         K_test_log=4096, verbose=False,
                         rollout_mode="fused_train", device=dev)
    out["elliptic_step"] = timed(ell.step, 10)
    return out


def allen_cahn_times(dev, gen):
    """ms (CUDA events) and device ms a launch (``torch.profiler``, either
    forward kernel and either backward kernel) of the Allen-Cahn pair at
    the notebook's width, N=25, at K=65536 and at the notebook's K=200
    (``_k200`` keys; ``_fwd_layout`` names the forward's kernel and
    layout), and of the
    stopped backward with its plan forced, shared and device, at the
    elliptic (DenseNet (30, 30)) and heat cells of ``stopped_cells``; None
    where the tree has no backward plans (its family refuses the cubic)."""
    from pspde_torch.ansatz import DenseNet
    from pspde_torch.problems import AllenCahn, Geometry
    from pspde_torch.rollout import kernels as km
    from pspde_torch.rollout.sampling import sample_domain

    if "plan" not in km._StoppedCall._fields:
        return {"allen_cahn": None, "device_plan": None}
    out = {}
    cells = stopped_cells(dev, gen)
    for tag in ("ell_30_30", "heat"):
        call = stopped_call(km, cells[tag])
        K = cells[tag][2].shape[0]
        gY = torch.randn(K, generator=gen, device=dev) / K
        for plan in ("shared", "device"):
            c = call._replace(plan=plan)

            def bwd():
                km._stopped_backward_kernel(c, gY)

            name = f"stopped_bwd_{tag.replace('ell_', '')}_{plan}_plan"
            out[name] = timed(bwd, 5)
            out[f"{name}_device"] = device_ms(bwd, 5, "stopped_bwd")[0]
    ac = AllenCahn(d=100, T=0.3, device=dev)
    ac.geometry = Geometry(kind="unbounded", boundary_distance=7.0)
    net = DenseNet(1, (110, 110, 50), d_in=101, device=dev,
                   generator=torch.Generator(dev).manual_seed(5))
    for K, reps, tag in ((65536, 3, ""), (200, 10, "_k200")):
        X0 = sample_domain(gen, ac.geometry, K, 100, uniform_square=True)
        call = stopped_call(km, (ac, net, X0, torch.rand(
            K, generator=gen, device=dev) * ac.T, 25, 1e-3, None, True))
        gY = torch.randn(K, generator=gen, device=dev) / K

        def fwd(call=call):
            km._stopped_forward_kernel(call)

        def bwd(call=call, gY=gY):
            km._stopped_backward_kernel(call, gY)

        out[f"allen_cahn{tag}_fwd"] = timed(fwd, reps)
        # either forward: the lanes kernel (stopped_fwd_kernel) or, where
        # the tree has it, the block kernel (stopped_fwd_block_kernel)
        out[f"allen_cahn{tag}_fwd_device"] = device_ms(
            fwd, reps, "stopped_fwd")[0]
        out[f"allen_cahn{tag}_fwd_layout"] = [
            type(call.pack(backward=False).layout).__name__,
            *call.pack(backward=False).layout]
        out[f"allen_cahn{tag}_bwd"] = timed(bwd, reps)
        out[f"allen_cahn{tag}_bwd_device"] = device_ms(bwd, reps,
                                                       "stopped_bwd")[0]
        out[f"allen_cahn{tag}_bwd_layout"] = list(
            call.pack(backward=True).layout)
    return out


def sch_committor_times(root, dev, gen):
    """ms (CUDA events) and device ms a launch (``torch.profiler``) of the
    Schroedinger and committor notebooks' stopped pairs, JAX's initial nets
    from ``root``'s assets, at the notebooks' K and at K=65536 (keys
    ``sch_k500_*``, ``com_k200_*``, ...; ``*_bwd_layout`` the backward's
    plan, and its (tile, threads a lane, arrays in shared memory, net
    staged) on the device plan)."""
    from pspde_torch.ansatz import DenseNetTanh
    from pspde_torch.problems import Committor, SchrodingerEigen
    from pspde_torch.rollout import kernels as km
    from pspde_torch.rollout.sampling import sample_domain
    from pspde_torch.utils.convert import (dense_net_from_flax,
                                           eigen_params_from_flax,
                                           load_control_npz)

    assets = os.path.join(root, "pspde_torch", "assets")
    sch = SchrodingerEigen(d=10, device=dev)
    tree, _ = load_control_npz(os.path.join(
        assets, "schrodinger_d10_densenet_tanh.npz"))
    sch_net, _ = eigen_params_from_flax(tree, output_relu=True, device=dev,
                                        cls=DenseNetTanh)
    com = Committor(d=10, device=dev)
    tree, _ = load_control_npz(os.path.join(assets,
                                            "committor_d10_densenet.npz"))
    com_net = dense_net_from_flax(tree, device=dev)
    out = {}
    for tag, prob, net, K, N, lam, reps in (
            ("sch_k500", sch, sch_net, 500, 20, -2.5, 20),
            ("sch_k65536", sch, sch_net, 65536, 20, -2.5, 5),
            ("com_k200", com, com_net, 200, 50, None, 20),
            ("com_k65536", com, com_net, 65536, 25, None, 5)):
        lam_t = None if lam is None else torch.full((1,), lam, device=dev)
        X0 = sample_domain(gen, prob.geometry, K, 10)
        call = km._StoppedCall(
            prob, net, X0, torch.zeros(K, device=dev), N, 1e-3, 17,
            km._check_stopped_family(prob, net, "erfinv", lam=lam_t),
            dict(adaptive_forward=False, rng="erfinv", host_noise=None),
            None, lam_t)
        gY = torch.randn(K, generator=gen, device=dev) / K

        def fwd(call=call):
            km._stopped_forward_kernel(call)

        def bwd(call=call, gY=gY):
            km._stopped_backward_kernel(call, gY)

        packed = call.pack(backward=True)
        out[f"{tag}_fwd"] = timed(fwd, reps)
        out[f"{tag}_fwd_device"] = device_ms(fwd, reps, "stopped_fwd")[0]
        out[f"{tag}_bwd"] = timed(bwd, reps)
        out[f"{tag}_bwd_device"] = device_ms(bwd, reps, "stopped_bwd")[0]
        out[f"{tag}_bwd_layout"] = (
            list(packed.layout) + [packed.iargs[5], packed.iargs[6]])
    return out


def stopped_steps(dev):
    """ms of one solver step on the stopped kernels at the cells of
    chip_smoke.py: EllipticSolver (d=50, K=65536) with the notebook net
    (DenseNet (30, 30) is ``elliptic_step``), GeneralSolver at gen50 and at
    config 2 (its cosine schedule), EigenSolver on the notebook recipe at
    K=500 and 65536."""
    from pspde_torch.ansatz import DenseNet
    from pspde_torch.problems import (ExponentialOnBallNonlinearSin,
                                      ExponentialOnSphereNonlinearParabolic,
                                      FokkerPlanckEigen, Geometry,
                                      HeatEquation)
    from pspde_torch.solvers import EigenSolver, EllipticSolver, GeneralSolver
    from pspde_torch.utils import cosine_decay_schedule

    sin = ExponentialOnBallNonlinearSin(d=D_ELL, alpha=0.1, device=dev)
    heat = HeatEquation(d=D_ELL, T=0.2, device=dev)
    heat.geometry = Geometry(kind="unbounded", boundary_distance=6.0)
    fp = FokkerPlanckEigen(d=5, device=dev)
    steppers = {
        "elliptic_step_notebook": EllipticSolver(
            sin, "bench", loss_method="diffusion", K=K_ELL, N=N_ELL,
            delta_t=DT_ELL, lr=1e-3, L=1, K_test_log=4096, verbose=False,
            rollout_mode="fused_train", device=dev,
            value_net=DenseNet(1, NETS_ELL["notebook"], d_in=D_ELL,
                               device=dev)),
        "gen50_step": GeneralSolver(
            ExponentialOnSphereNonlinearParabolic(d=D_ELL, device=dev),
            "gen50", loss_method="diffusion", K=K_ELL, N=N_ELL,
            delta_t=DT_ELL, lr=1e-3, L=5, verbose=False,
            rollout_mode="fused_train", device=dev),
        "config2_step": GeneralSolver(
            heat, "config2", seed=2, L=3000,
            lr=cosine_decay_schedule(1e-2, 3000, alpha=3e-4),
            delta_t=2e-3, N=100, K=4096, K_boundary=2048, K_test_log=16384,
            loss_method="diffusion", verbose=False,
            rollout_mode="fused_train", device=dev)}
    for K in (500, 65536):
        steppers[f"eigen_step_{K}"] = EigenSolver(
            fp, "fp-eigen", seed=42, delta_t=1e-3, N=20, lr=1e-3,
            lr_lambda=0.01, lambda_init=0.5, L=1, K=K, K_boundary=50,
            alpha=(50.0, 1.0), normalization="center",
            value_net=DenseNet(1, (10, 10, 10, 10), d_in=5, device=dev),
            rollout_mode="fused_train", verbose=False, device=dev)
    return {tag: timed(s.step, 5) for tag, s in steppers.items()}


if __name__ == "__main__":
    main()
