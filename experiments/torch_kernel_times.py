#!/usr/bin/env python3
"""Time the PyTorch port's serve, HJB training and stopped training
kernels at the bench shapes on one CUDA card, and print one JSON line.

    python3 experiments/torch_kernel_times.py [--root DIR]

``--root`` names the checkout whose ``pspde_torch`` is timed (default:
the one this script lives in).  Two trees are compared on one card in one
command: unpack the other with ``git archive`` into a directory that
``.gitignore`` lists and run parent, change, change, parent, e.g.

    for r in build/parent . . build/parent; do
        python3 experiments/torch_kernel_times.py --root $r; done

Each kernel is timed with CUDA events, best of two rounds: the serve
kernel at LLGC d=100 with the exported control, K=2^20, N=100, Philox
noise; the training forward and replay backward at K=131072, N=32, binom
noise, u_tab; and one ``HJBSolver.step()`` at that shape.  Where the
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
K=65536, where the backward kernel's device time per launch is also read
from ``torch.profiler`` (``*_device`` keys: at K=500 the events time the
host's launches as much as the kernel).
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
    """Device ms per call of the CUDA kernels whose name holds ``kernel``
    over ``reps`` calls of ``fn``, from torch.profiler; None where the
    profiler saw no such kernel."""
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

    us = sum(device_us(e) for e in prof.key_averages() if kernel in e.key)
    return us / 1e3 / reps if us else None


def main():
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=here,
                    help="checkout whose pspde_torch is timed")
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
            return {"serve": timed(serve, 5), "fwd": timed(fwd, 10),
                    "bwd": timed(lambda: km._train_backward_kernel(c, gY,
                                                                   gKL), 5)}

    out = {"root": os.path.relpath(root, here), "card": card}
    out.update({f"{k}_default": v for k, v in kernels(None).items()})
    if has_plans:
        out.update({f"{k}_device": v for k, v in kernels("device").items()})
    out["step"] = timed(bench.step, 5)
    out.update(stopped_times(dev, gen))
    print(json.dumps(out))


def stopped_times(dev, gen):
    """ms of the stopped kernels and of one elliptic solver step."""
    from pspde_torch.ansatz import DenseNet
    from pspde_torch.problems import ExponentialOnBallNonlinearSin
    from pspde_torch.rollout import kernels as km
    from pspde_torch.rollout.sampling import sample_domain
    from pspde_torch.solvers import EllipticSolver

    sin = ExponentialOnBallNonlinearSin(d=D_ELL, alpha=0.1, device=dev)
    X0 = sample_domain(gen, sin.geometry, K_ELL, D_ELL)
    t0 = torch.zeros(K_ELL, device=dev)
    gY = torch.randn(K_ELL, generator=gen, device=dev) / K_ELL
    out = {}
    for tag, arch in NETS_ELL.items():
        net = DenseNet(1, arch, d_in=D_ELL, device=dev,
                       generator=torch.Generator(dev).manual_seed(5))
        call = km._StoppedCall(
            sin, net, X0, t0, N_ELL, DT_ELL, 17,
            km._check_stopped_family(sin, net, "erfinv"),
            dict(adaptive_forward=False, rng="erfinv", host_noise=None), None)
        out[f"stopped_fwd_{tag}"] = timed(
            lambda: km._stopped_forward_kernel(call), 10)
        out[f"stopped_bwd_{tag}"] = timed(
            lambda: km._stopped_backward_kernel(call, gY), 5)
    ell = EllipticSolver(sin, "bench", loss_method="diffusion", K=K_ELL,
                         N=N_ELL, delta_t=DT_ELL, lr=1e-3, L=1,
                         K_test_log=4096, verbose=False,
                         rollout_mode="fused_train", device=dev)
    out["elliptic_step"] = timed(ell.step, 10)
    out.update(time_stopping_times(dev, gen))
    out.update(torus_times(dev, gen))
    return out


def torus_times(dev, gen):
    """ms of the stopped kernels' torus instantiation (the eigen solver's
    domain leg) at K=500 and 65536, the cells of chip_smoke.py phase 22."""
    from pspde_torch.ansatz import DenseNet
    from pspde_torch.problems import FokkerPlanckEigen
    from pspde_torch.rollout import kernels as km
    from pspde_torch.rollout.sampling import sample_domain

    fp = FokkerPlanckEigen(d=5, device=dev)
    out = {}
    for K in (500, 65536):
        net = DenseNet(1, (10, 10, 10, 10), d_in=5, device=dev,
                       generator=torch.Generator(dev).manual_seed(5))
        X0 = sample_domain(gen, fp.geometry, K, 5)
        lam = torch.full((1,), 0.3, device=dev)
        gY = torch.randn(K, generator=gen, device=dev) / K
        call = km._StoppedCall(
            fp, net, X0, torch.zeros(K, device=dev), 20, 1e-3, 17,
            km._check_stopped_family(fp, net, "erfinv", lam=lam),
            dict(adaptive_forward=False, rng="erfinv", host_noise=None,
                 time_stopping=False), None, lam)
        out[f"stopped_fwd_torus_{K}"] = timed(
            lambda: km._stopped_forward_kernel(call), 20)
        out[f"stopped_bwd_torus_{K}"] = timed(
            lambda: km._stopped_backward_kernel(call, gY), 10)
        out[f"stopped_bwd_torus_{K}_device"] = device_ms(
            lambda: km._stopped_backward_kernel(call, gY), 10,
            "stopped_bwd_kernel")
    return out


def time_stopping_times(dev, gen):
    """ms of the stopped kernels' time_stopping instantiation at the gen50
    and heat cells of chip_smoke.py (phases 16-19)."""
    from pspde_torch.ansatz import DenseNet
    from pspde_torch.problems import (ExponentialOnSphereNonlinearParabolic,
                                      Geometry, HeatEquation)
    from pspde_torch.rollout import kernels as km
    from pspde_torch.rollout.sampling import sample_domain

    heat = HeatEquation(d=D_ELL, T=0.2, device=dev)
    heat.geometry = Geometry(kind="unbounded", boundary_distance=6.0)
    out = {}
    for tag, prob, K, N, dt in (
            ("gen50", ExponentialOnSphereNonlinearParabolic(d=D_ELL,
                                                            device=dev),
             K_ELL, N_ELL, DT_ELL),
            ("heat", heat, 4096, 100, 2e-3)):
        net = DenseNet(1, (30, 30), d_in=D_ELL + 1, device=dev,
                       generator=torch.Generator(dev).manual_seed(5))
        X0 = sample_domain(gen, prob.geometry, K, D_ELL)
        t0 = torch.rand(K, generator=gen, device=dev) * prob.T
        gY = torch.randn(K, generator=gen, device=dev) / K
        call = km._StoppedCall(
            prob, net, X0, t0, N, dt, 17,
            km._check_stopped_family(prob, net, "erfinv",
                                     time_stopping=True),
            dict(adaptive_forward=False, rng="erfinv", host_noise=None,
                 time_stopping=True), None)
        out[f"stopped_fwd_{tag}"] = timed(
            lambda: km._stopped_forward_kernel(call), 10)
        out[f"stopped_bwd_{tag}"] = timed(
            lambda: km._stopped_backward_kernel(call, gY), 5)
    return out


if __name__ == "__main__":
    main()
