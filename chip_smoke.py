#!/usr/bin/env python3
"""Drive the PyTorch port's serve path once on one CUDA card.

Importance sampling (IS) with the learned LLGC d=100 control is how a user
reads the PDE solution off a trained model.  This script

  1. builds the rollout kernel from pspde_torch/csrc (nvcc, sm_90a);
  2. compares the kernel with its plain PyTorch version on host noise, on
     LLGC d=100 with the exported control and on LQGC d=100 (dense A and
     sigma, f != 0), at K=8192 and N=100;
  3. does the same on the kernel's own Philox stream, which the plain
     version draws too, elementwise;
  4. serves IS through pspde_torch.eval.importance_sampling_fused at
     K=2^20 (plain and antithetic) and holds the estimate against the
     exact value log E = 1/2 d dt sum_{j<N} (1 - dt)^{2j} = 21.759305 of
     the Euler-Maruyama chain (discrete Girsanov is exact for additive
     noise, so only Monte-Carlo error remains);
  5. times the kernel and the plain version at K=2^20, N=100 with CUDA
     events, both drawing the same Philox stream.

Any failure exits nonzero.  The last line is one JSON object naming the
device.  Run from the repository root:

    python3 chip_smoke.py
"""

import json
import math
import os
import subprocess
import sys
import time

import torch

D, T_END, DT_IS = 100, 1.0, 0.01
N_STEPS = 100
K_CHECK, K_SERVE = 8192, 2 ** 20
LOG_E_EXACT = 21.759305
# Kernel vs plain version, per output: max |kernel - plain| <= REL_TOL *
# (1 + max |plain|).  Both run in float32 on the card but sum in another
# order (cuBLAS GEMMs and reductions against the kernel's FMA chains over
# 101, 30 and 100 terms), and tanhf / erfinvf differ from PyTorch's tanh /
# erfinv by a few ulp; over 100 steps of a stable linear SDE these stay
# near 1e-6 relative, 100x under the bound.
REL_TOL = 1e-4
KERNEL_SOURCE = "pspde_torch/csrc/controlled_rollout.cu"
KERNEL_REPLACES = "pspde/rollout/kernels.py:339"


def check(ok, what):
    if not ok:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this "
                 "script needs one CUDA card")
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from pspde_torch.eval import (control_test_error,
                                  importance_sampling_fused)
    from pspde_torch.problems import LLGC, LQGC
    from pspde_torch.ansatz import TanhMLP
    from pspde_torch.rollout import _build
    from pspde_torch.rollout import kernels as km
    from pspde_torch.solvers import HJBSolver

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"card: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    # -- phase 1: build ------------------------------------------------------
    t0 = time.perf_counter()
    _build.library()
    info = _build.build_info
    print(f"phase 1: built {os.path.relpath(info['path'], root)} from "
          f"{[os.path.relpath(s, root) for s in info['sources']]} in "
          f"{info['seconds']:.1f} s of nvcc ({time.perf_counter() - t0:.1f} s"
          " with loading)")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    llgc = LLGC(d=D, T=T_END, device=dev)
    solver = HJBSolver("llgc_d100", llgc, K=1024, delta_t=1 / 32,
                       time_approx="inner", learn_Y_0=True, device=dev)
    meta = solver.load_jax_params(
        os.path.join(root, "pspde_torch", "assets", "llgc_d100_tanhmlp.npz"))
    print(f"control: {meta}")
    lqgc = LQGC(d=D, T=T_END, off_diag=0.05, device=dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    lqgc_net = TanhMLP(D + 1, D, hidden=(50, 37), init_scale=0.1,
                       generator=gen, device=dev)
    cases = [("LLGC d=100, exported control", llgc, solver.z_net),
             ("LQGC d=100 off_diag=0.05, TanhMLP [101,50,37,100]", lqgc,
              lqgc_net)]
    worst_abs = 0.0

    def compare(tag, kern, plain):
        nonlocal worst_abs
        torch.cuda.synchronize()
        for name in ("X", "ito", "riemann", "f_int"):
            a, b = getattr(kern, name), getattr(plain, name)
            check(a.shape == b.shape,
                  f"{tag} {name} shape {a.shape} vs {b.shape}")
            check(bool(torch.isfinite(a).all()), f"{tag} {name} not finite")
            err = float((a - b).abs().max())
            scale = float(b.abs().max())
            rel = err / (1.0 + scale)
            worst_abs = max(worst_abs, err)
            print(f"  {tag} {name:8s} max_abs {err:.3e} max|plain| "
                  f"{scale:.3e} rel {rel:.3e}")
            check(rel <= REL_TOL, f"{tag} {name} rel {rel:.3e} > {REL_TOL}")

    # -- phase 2: kernel vs plain on host noise ------------------------------
    print(f"phase 2: kernel vs plain on host noise, K={K_CHECK}, "
          f"N={N_STEPS}, tolerance rel {REL_TOL:g}")
    for tag, prob, net in cases:
        noise = torch.randn((N_STEPS, K_CHECK, D), generator=gen, device=dev)
        kern = km.fused_controlled_rollout(prob, net, K_CHECK, N_STEPS,
                                           DT_IS, host_noise=noise)
        plain = km.reference_controlled_rollout(prob, net, K_CHECK, N_STEPS,
                                                DT_IS, host_noise=noise)
        compare(f"[{tag}]", kern, plain)
        del noise

    # -- phase 3: kernel vs plain on the Philox stream -----------------------
    print(f"phase 3: kernel vs plain on the Philox stream, K={K_CHECK}")
    for tag, prob, net in cases:
        for sign in (1.0, -1.0):
            kern = km.fused_controlled_rollout(prob, net, K_CHECK, N_STEPS,
                                               DT_IS, seed=1234,
                                               noise_sign=sign)
            plain = km.reference_controlled_rollout(prob, net, K_CHECK,
                                                    N_STEPS, DT_IS,
                                                    seed=1234,
                                                    noise_sign=sign)
            compare(f"[{tag}, sign {sign:+.0f}]", kern, plain)

    # -- phase 4: the serve run ----------------------------------------------
    print(f"phase 4: importance_sampling_fused, LLGC d=100, K={K_SERVE}, "
          f"N={N_STEPS}; exact log E = {LOG_E_EXACT}")
    km.fused_controlled_rollout.launches = 0
    serve = {}
    for antithetic in (False, True):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mean, var, rel = importance_sampling_fused(
            llgc, solver, K_SERVE, delta_t=DT_IS, seed=2026,
            antithetic=antithetic)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        serve[antithetic] = (mean, var, rel, wall)
    launches = km.fused_controlled_rollout.launches
    print(f"  kernel launches during the serve runs: {launches}")
    check(launches >= 1, "the serve path launched the kernel")
    cte = control_test_error(llgc, solver, K=16384,
                             generator=torch.Generator(dev).manual_seed(3))
    for antithetic, (mean, var, rel, wall) in serve.items():
        # RE is per iid unit: a path, or a mirrored pair with antithetic
        units = K_SERVE // 2 if antithetic else K_SERVE
        err = abs(math.log(mean) - LOG_E_EXACT)
        bound = 5.0 * rel / math.sqrt(units)
        print(f"  antithetic={antithetic}: mean {mean:.6e} var {var:.4e} "
              f"RE {rel:.4f} |log mean - exact| {err:.3e} (5 SE "
              f"{bound:.3e}), {wall:.3f} s wall")
        check(math.isfinite(mean) and mean > 0, f"IS mean {mean}")
        check(err <= bound, f"|log mean - exact| {err:.3e} > {bound:.3e}")
    print(f"  control_test_error {cte:.4f} (K=16384)")
    check(0.0 < cte < 0.2, f"control_test_error {cte}")

    # -- phase 5: timing -----------------------------------------------------
    print(f"phase 5: kernel vs plain, LLGC d=100, K={K_SERVE}, N={N_STEPS}, "
          "Philox noise, CUDA events")

    def timed(fn, reps):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / reps

    def kern():
        return km.fused_controlled_rollout(llgc, solver.z_net, K_SERVE,
                                           N_STEPS, DT_IS, seed=5)

    def plain():
        return km.reference_controlled_rollout(llgc, solver.z_net, K_SERVE,
                                               N_STEPS, DT_IS, seed=5)

    plain_ms = [timed(plain, 2)]
    kern_ms = [timed(kern, 10), timed(kern, 10)]
    plain_ms.append(timed(plain, 2))
    ms, p_ms = min(kern_ms), min(plain_ms)
    steps = K_SERVE * N_STEPS
    print(f"  kernel {kern_ms} ms -> {steps / ms * 1e3:.4e} path-steps/s")
    print(f"  plain  {plain_ms} ms -> {steps / p_ms * 1e3:.4e} path-steps/s")
    print(f"  card: {smi}")

    print(json.dumps({"kernels": [{
        "name": "fused_controlled_rollout", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": KERNEL_REPLACES,
        "launches": launches, "max_abs_err": worst_abs, "ms": ms,
        "plain_ms": p_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
