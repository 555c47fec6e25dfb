#!/usr/bin/env python3
"""Drive the PyTorch port's serve and training paths on one CUDA card.

Importance sampling (IS) with a learned control is how a user reads the
PDE solution off a trained model, and ``HJBSolver.train()`` is how the
control is learned.  This script

  1. builds the kernels from pspde_torch/csrc (nvcc, sm_90a, one process
     per source);
  2. compares the serve kernel with its plain PyTorch version on host
     noise, on LLGC d=100 with the exported control and on LQGC d=100
     (dense A and sigma, f != 0), at K=8192 and N=100;
  3. does the same on the kernel's own Philox stream, which the plain
     version draws too, elementwise;
  4. serves IS through pspde_torch.eval.importance_sampling_fused at
     K=2^20 (plain and antithetic) and holds the estimate against the
     exact value log E = 1/2 d dt sum_{j<N} (1 - dt)^{2j} = 21.759305 of
     the Euler-Maruyama chain (discrete Girsanov is exact for additive
     noise, so only Monte-Carlo error remains);
  5. times the serve kernel and the plain version at K=2^20, N=100 with
     CUDA events, both drawing the same Philox stream;
  6. compares the training kernels (forward and replay backward) with
     their plain version on host noise at K=8192, N=32: forward outputs
     and per-leaf gradients of a log-variance (+ KL) loss, on LLGC d=100
     with the exported control and u_tab, and on dense LQGC d=100;
  7. does the same on the Philox stream, for the binom and erfinv maps and
     noise signs +1 and -1;
  8. trains HJBSolver(rollout_mode='fused_train') from the port's own init
     (600 steps, lr 1e-2, K=1024, N=32: the recipe that made the exported
     control), checks the final u_L2, and serves IS with the result;
  9. times the training kernels, the training step and the plain step at
     the bench shape K=131072, N=32, for both noise maps, and profiles a
     few training steps;
 10. compares the stopped-path training kernels (forward and replay
     backward) with their plain version at K=8192, N=20, d=50: on
     ExponentialOnBallNonlinearSin(alpha=0.1) with DenseNet (30, 30),
     adaptive and not, on ExponentialOnSphere, and with the notebook net
     DenseNet (70, 50, 50, 50); host noise and the Philox stream (erfinv,
     binom).  Outputs on the paths whose exit step agrees, the count of
     paths whose exit step differs (at most 1e-3 K: |X|^2 is summed in
     another order), and per-leaf diffusion-loss gradients;
 11. trains EllipticSolver(rollout_mode='fused_train') on the slice's
     recipe (d=50, N=20, dt=1e-3, lr=1e-3, K=8192, 2000 iterations,
     K_test_log=4096): 2000 launches of each kernel, tail-50 test L2
     <= 1e-3;
 12. times both stopped kernels, one solver step and the plain versions
     at K=65536, N=20 for both nets, and profiles three solver steps.

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
# Training kernels vs plain version, per gradient leaf: max |kernel - plain|
# <= GRAD_TOL * max |plain|.  The kernel sums each leaf over the 64 (or 32)
# paths of a block, the N steps and then the blocks; the plain version's
# autograd sums in cuBLAS GEMM order.  The log-variance gradient is a sum
# of 2.6e5 path-step terms of both signs, so float32 reordering moves it by
# ~1e-6..1e-5 of its largest entry (1.1e-6 in a CPU emulation of the
# kernel); 1e-3 leaves two decades of room and still catches any wrong
# term, which moves a leaf by O(1) of its size.
GRAD_TOL = 1e-3
SERVE_SOURCE = "pspde_torch/csrc/controlled_rollout.cu"
TRAIN_SOURCE = "pspde_torch/csrc/train_rollout.cu"
STOPPED_SOURCE = "pspde_torch/csrc/stopped_rollout.cu"
N_TRAIN, DT_TRAIN = 32, 1.0 / 32
K_TRAIN_CHECK, K_BENCH = 8192, 131072
# the stopped slice (experiments/proto_fused_stopped.py:27-42)
D_ELL, N_ELL, DT_ELL, ALPHA_ELL = 50, 20, 1e-3, 0.1
K_ELL_CHECK, K_ELL_TRAIN, K_ELL_BENCH, L_ELL = 8192, 8192, 65536, 2000
NETS_ELL = {"DenseNet (30, 30)": (30, 30),
            "notebook DenseNet (70, 50, 50, 50)": (70, 50, 50, 50)}
# paths whose exit step may differ between kernel and plain: |X|^2 sums in
# another order, so a path within ~1e-7 of the sphere can leave one step
# apart
MASK_TOL = 1e-3
TEST_L2_BOUND = 1e-3
# The least time of a kernel's work: the larger of its FP32 operations over
# the H100 SXM's 67 TFLOP/s and its bytes (each input read once, each output
# written once) over 3.35 TB/s: NVIDIA's data sheet for the H100 SXM at
# 700 W.  Operations count the FP32 arithmetic of the net and the step,
# not the noise generation.
PEAK_FLOPS, PEAK_BYTES = 67e12, 3.35e12


def roofline(flops, nbytes):
    t_op, t_b = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return {"bound_ms": 1e3 * max(t_op, t_b),
            "bound_by": "operations" if t_op >= t_b else "bytes",
            "library_ms": None}


def mlp_flops(widths):
    """Multiply-adds of a dense stack (2 per weight) and its activations."""
    prod = sum(a * b for a, b in zip(widths[:-1], widths[1:]))
    return 2 * prod + sum(widths[1:-1])


def check(ok, what):
    if not ok:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this "
                 "script needs one CUDA card")
    t_start = time.perf_counter()
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
        if "entry function" in line or "registers" in line or "spill" in line:
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

    # per path-step: the TanhMLP [101, 30, 30, 100] and 10 operations per
    # dimension (the Euler step, the Ito and Riemann sums)
    n_par = sum(p.numel() for p in solver.z_net.parameters())
    serve_row = {"name": "fused_controlled_rollout", "route": "cuda",
                 "source": SERVE_SOURCE,
                 "replaces": "pspde/rollout/kernels.py:339",
                 "launches": launches, "max_abs_err": worst_abs, "ms": ms,
                 "plain_ms": p_ms,
                 **roofline(steps * (mlp_flops([D + 1, 30, 30, D])
                                     + 10 * D),
                            4 * (n_par + K_SERVE * (D + 3)))}
    print(f"  bound {serve_row['bound_ms']:.3f} ms "
          f"({serve_row['bound_by']})")
    train_rows = train_phases(dev, smi, llgc, solver, lqgc, gen, timed)
    stopped_rows = stopped_phases(dev, smi, timed)

    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [serve_row] + train_rows + stopped_rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def train_phases(dev, smi, llgc, solver, lqgc, gen, timed):
    """Phases 6-9: the training kernels against their plain version, the
    training run, and the timings.  Returns the kernels' JSON rows."""
    import numpy as np
    from pspde_torch.ansatz import TanhMLP
    from pspde_torch.eval import importance_sampling_fused
    from pspde_torch.losses import log_variance_loss
    from pspde_torch.rollout import kernels as km
    from pspde_torch.solvers import HJBSolver

    N, dt, Kc = N_TRAIN, DT_TRAIN, K_TRAIN_CHECK
    u_tab = llgc.u_ref_table(np.arange(N) * dt)
    lqgc_net = TanhMLP(D + 1, D, hidden=(50, 37), init_scale=0.1,
                       generator=gen, device=dev)
    cases = [("LLGC d=100, exported control, u_tab", llgc, solver.z_net,
              dict(u_tab=u_tab)),
             ("LQGC d=100 off_diag=0.05, TanhMLP [101,50,37,100], KL+Ito, "
              "no u_tab", lqgc, lqgc_net,
              dict(accumulate_kl=True, kl_ito_term=True))]
    worst = {"out": 0.0, "grad": 0.0}

    def loss_of(prob, out, kw):
        gX = prob.g(out.X)
        loss = log_variance_loss(out.Y, gX)
        if kw.get("accumulate_kl"):
            loss = loss + torch.mean(out.Z_sum + gX)
        return loss

    def compare(tag, prob, net, kw):
        params = list(net.parameters())
        kern = km.fused_train_rollout(prob, net, Kc, N, dt, **kw)
        g_kern = torch.autograd.grad(loss_of(prob, kern, kw), params)
        plain = km.reference_train_rollout(prob, net, Kc, N, dt, **kw)
        g_plain = torch.autograd.grad(loss_of(prob, plain, kw), params)
        torch.cuda.synchronize()
        for name in ("X", "Y", "Z_sum", "u_l2"):
            a, b = getattr(kern, name).detach(), getattr(plain, name).detach()
            check(a.shape == b.shape, f"{tag} {name} shape")
            check(bool(torch.isfinite(a).all()), f"{tag} {name} not finite")
            err = float((a - b).abs().max())
            rel = err / (1.0 + float(b.abs().max()))
            worst["out"] = max(worst["out"], err)
            check(rel <= REL_TOL, f"{tag} {name} rel {rel:.3e} > {REL_TOL}")
        rels = []
        for (pname, _), a, b in zip(net.named_parameters(), g_kern, g_plain):
            err = float((a - b).abs().max())
            scale = float(b.abs().max())
            worst["grad"] = max(worst["grad"], err)
            rels.append(err / scale)
            check(scale > 0 and err <= GRAD_TOL * scale,
                  f"{tag} grad {pname} max_abs {err:.3e} > {GRAD_TOL} * "
                  f"{scale:.3e}")
        print(f"  {tag}: outputs ok; grad max|kern-plain|/max|plain| per "
              f"leaf {['%.1e' % r for r in rels]}")

    # -- phase 6: training kernels vs plain on host noise --------------------
    print(f"phase 6: training kernels vs plain on host noise, K={Kc}, N={N}, "
          f"outputs rel {REL_TOL:g}, gradients {GRAD_TOL:g} x max|plain|")
    for tag, prob, net, kw in cases:
        noise = torch.randn((N, Kc, D), generator=gen, device=dev)
        compare(f"[{tag}]", prob, net, dict(kw, host_noise=noise))
        del noise

    # -- phase 7: the same on the Philox stream -----------------------------
    print(f"phase 7: training kernels vs plain on the Philox stream, K={Kc}")
    for tag, prob, net, kw in cases:
        for rng in ("binom", "erfinv"):
            for sign in (1.0, -1.0):
                compare(f"[{tag}, {rng}, sign {sign:+.0f}]", prob, net,
                        dict(kw, seed=4321, rng=rng, noise_sign=sign))

    # -- phase 8: the training run ------------------------------------------
    print("phase 8: HJBSolver(rollout_mode='fused_train').train(), LLGC "
          "d=100, 600 steps, lr 1e-2, K=1024, N=32, the port's own init")
    trainer = HJBSolver("llgc_d100_train", llgc, lr=1e-2, L=600, K=1024,
                        delta_t=dt, time_approx="inner",
                        loss_method="log-variance", detach_forward=True,
                        learn_Y_0=True, verbose=False,
                        early_stopping_time=None, seed=42,
                        rollout_mode="fused_train", device=dev)
    check(trainer.resolved_rollout_mode == "fused_train",
          f"engine {trainer.resolved_rollout_mode}")
    km.fused_train_rollout.launches = 0
    km.fused_train_rollout.backward_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fwd_launches = km.fused_train_rollout.launches
    bwd_launches = km.fused_train_rollout.backward_launches
    u0, u_end = trainer.u_L2_loss[0], trainer.u_L2_loss[-1]
    print(f"  {len(trainer.u_L2_loss)} steps in {wall:.2f} s; kernel "
          f"launches: forward {fwd_launches}, backward {bwd_launches}")
    print(f"  u_L2 {u0:.4f} -> {u_end:.4f} (every 100: "
          f"{['%.4f' % u for u in trainer.u_L2_loss[::100]]}); loss "
          f"{trainer.loss_log[-1]:.4e}; Y_0 {trainer.Y_0_log[-1]:.4f}")
    check(fwd_launches >= 600 and bwd_launches >= 600,
          "the training path launched both training kernels every step")
    check(all(math.isfinite(v) for v in trainer.loss_log), "finite losses")
    check(u_end <= 0.1, f"final u_L2 {u_end:.4f} > 0.1")
    mean, var, rel = importance_sampling_fused(llgc, trainer, 2 ** 18,
                                               delta_t=DT_IS, seed=99)
    err = abs(math.log(mean) - LOG_E_EXACT)
    bound = 5.0 * rel / math.sqrt(2 ** 18)
    print(f"  IS with the trained control, K=2^18: RE {rel:.4f}, "
          f"|log mean - exact| {err:.3e} (5 SE {bound:.3e})")
    check(err <= bound, f"IS error {err:.3e} > {bound:.3e}")

    # -- phase 9: timing ------------------------------------------------------
    Kb = K_BENCH
    steps = Kb * N
    print(f"phase 9: timing at the bench shape, LLGC d=100, K={Kb}, N={N}, "
          "Philox noise, CUDA events")
    bench = HJBSolver("llgc_d100_bench", llgc, lr=1e-3, L=1, K=Kb,
                      delta_t=dt, time_approx="inner",
                      loss_method="log-variance", detach_forward=True,
                      learn_Y_0=True, verbose=False, early_stopping_time=None,
                      rollout_mode="fused_train", device=dev)
    net, X0 = bench.z_net, llgc.X_0.expand(Kb, D)
    gY = torch.randn(Kb, generator=gen, device=dev)
    gKL = torch.zeros(Kb, device=dev)
    times = {}
    for rng in ("binom", "erfinv"):
        bench.fused_rng = rng
        kw = dict(u_tab=u_tab, rng=rng)
        call = km._TrainCall(
            llgc, net, Kb, N, dt, 17,
            km._check_train_family(llgc, net, N, 1.0, u_tab, rng),
            dict(adaptive_forward=True, accumulate_kl=False,
                 kl_ito_term=False, u_tab=u_tab, rng=rng, noise_sign=1.0,
                 host_noise=None), None)

        def fwd():
            with torch.no_grad():
                km.fused_train_rollout(llgc, net, Kb, N, dt, 17, **kw)

        def plain_fwd():
            with torch.no_grad():
                km.reference_train_rollout(llgc, net, Kb, N, dt, 17, **kw)

        def bwd():
            km._train_backward_kernel(call, gY, gKL)

        def plain_bwd():
            km._reference_train_backward(call, gY, gKL)

        def step():
            bench.step()

        def plain_step():
            out = km.reference_train_rollout(llgc, net, Kb, N, dt, 17, **kw)
            Y = bench.y0_net(X0[:, :1]) + out.Y
            loss = log_variance_loss(Y, llgc.g(out.X))
            bench.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            bench.optimizer.step()
            float(loss.detach())

        r = {}
        for name, kern_fn, plain_fn, reps in (
                ("forward", fwd, plain_fwd, 5), ("backward", bwd, plain_bwd, 5),
                ("step", step, plain_step, 5)):
            p1 = timed(plain_fn, 1)
            k = [timed(kern_fn, reps), timed(kern_fn, reps)]
            p2 = timed(plain_fn, 1)
            r[name] = (min(k), min(p1, p2))
            print(f"  {rng:6s} {name:8s} kernel {k[0]:.3f}, {k[1]:.3f} ms; "
                  f"plain {p1:.3f}, {p2:.3f} ms")
        ms_step, p_step = r["step"]
        print(f"  {rng:6s} training step {ms_step:.3f} ms -> "
              f"{steps / ms_step * 1e3:.4e} path-steps/s; plain step "
              f"{p_step:.3f} ms -> {steps / p_step * 1e3:.4e} path-steps/s")
        times[rng] = r
    print(f"  card: {smi}")

    bench.fused_rng = "binom"
    profile_steps("3 binom training steps", bench.step)

    # per path-step: the forward is the net plus 15 operations per dimension
    # (Euler step, the Z.c, Z.xi, |Z|^2 and u_L2 sums); the backward replays
    # it, backpropagates dZ through the hidden layers and forms the weight
    # outer products (2 operations per weight and bias)
    widths = [D + 1, 30, 30, D]
    n_par = sum(p.numel() for p in net.parameters())
    fwd_flops = mlp_flops(widths) + 15 * D
    bwd_flops = (fwd_flops + 2 * sum(a * b for a, b in zip(widths[1:-1],
                                                          widths[2:]))
                 + 3 * sum(widths[1:-1]) + 2 * n_par)
    row = {"route": "cuda", "source": TRAIN_SOURCE}
    rows = [
        dict(row, name="fused_train_rollout.forward",
             replaces="pspde/rollout/kernels.py:696", launches=fwd_launches,
             max_abs_err=worst["out"], ms=times["binom"]["forward"][0],
             plain_ms=times["binom"]["forward"][1],
             **roofline(steps * fwd_flops,
                        4 * (n_par + N * D + Kb * (D + 3)))),
        dict(row, name="fused_train_rollout.backward",
             replaces="pspde/rollout/kernels.py:788", launches=bwd_launches,
             max_abs_err=worst["grad"], ms=times["binom"]["backward"][0],
             plain_ms=times["binom"]["backward"][1],
             **roofline(steps * bwd_flops,
                        4 * (2 * n_par + N * D + 2 * Kb))),
    ]
    for r in rows:
        print(f"  {r['name']} bound {r['bound_ms']:.3f} ms ({r['bound_by']})")
    return rows


def profile_steps(what, step):
    """Device time and idle share of three calls of ``step`` under
    torch.profiler, and the kernels that took most of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device rows only: a CPU op's row repeats the time of the kernels it
    # launched
    dev_time = {}
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total",
                    getattr(ev, "self_cuda_time_total", 0.0))
        if ev.device_type == DeviceType.CUDA and t > 0:
            dev_time[ev.key] = t
    total = sum(dev_time.values())
    print(f"  profiler, {what}: device time {total / 1e3:.3f} ms of "
          f"{wall * 1e3:.3f} ms wall (device idle "
          f"{100 * max(0.0, 1 - total / 1e6 / wall):.2f}%)")
    for key, t in sorted(dev_time.items(), key=lambda kv: -kv[1])[:8]:
        print(f"    {100 * t / max(total, 1e-9):6.2f}%  {t / 1e3:9.3f} ms  "
              f"{key[:90]}")


def stopped_flops(v_net, d, adaptive):
    """FP32 operations of one advancing path-step of the stopped kernels,
    counted from their code (csrc/stopped_rollout.cu): (V only, forward,
    backward).  V: the dense products, bias, relu and square of each
    hidden layer, the output dot; grad V: the transposed products and
    2 relu(h) g; the step: 9 per dimension.  The backward replays V (and
    grad V when adaptive), the tangent sweep, the pair sweep and the weight
    outer products (4 per weight: two terms)."""
    widths = list(v_net.arch)
    ins = [d + sum(widths[:l]) for l in range(len(widths))]
    F = d + sum(widths)
    v = sum(2 * n * w + 3 * w for n, w in zip(ins, widths)) + 2 * F
    grad = sum(2 * n * w + 2 * w for n, w in zip(ins, widths))
    fwd = v + grad + 9 * d
    bwd = (v + (grad if adaptive else 0) + 8 * d
           + sum(2 * n * w + 2 * w for n, w in zip(ins, widths))
           + sum(6 * w + 4 * (n - d) * w for n, w in zip(ins, widths))
           + sum(4 * (n + 1) * w for n, w in zip(ins, widths)) + 4 * F + 2)
    return v, fwd, bwd


def stopped_phases(dev, smi, timed):
    """Phases 10-12: the stopped-path training kernels against their plain
    version, the elliptic training run, and the timings.  Returns the
    kernels' JSON rows."""
    import numpy as np
    from pspde_torch.ansatz import DenseNet
    from pspde_torch.problems import (ExponentialOnBallNonlinearSin,
                                      ExponentialOnSphere)
    from pspde_torch.rollout import kernels as km
    from pspde_torch.rollout.sampling import sample_domain
    from pspde_torch.solvers import EllipticSolver

    t_phases = time.perf_counter()
    d, N, dt, Kc = D_ELL, N_ELL, DT_ELL, K_ELL_CHECK
    sin = ExponentialOnBallNonlinearSin(d=d, alpha=ALPHA_ELL, device=dev)
    sphere = ExponentialOnSphere(d=d, alpha=ALPHA_ELL, device=dev)
    gen = torch.Generator(device=dev).manual_seed(11)

    def net_of(arch, seed):
        return DenseNet(1, arch, d_in=d, device=dev,
                        generator=torch.Generator(dev).manual_seed(seed))

    cases = [("Sin, DenseNet (30, 30)", sin, net_of((30, 30), 1), False),
             ("Sin, DenseNet (30, 30), adaptive", sin, net_of((30, 30), 2),
              True),
             ("ExponentialOnSphere, DenseNet (30, 30)", sphere,
              net_of((30, 30), 3), False),
             ("Sin, notebook DenseNet (70, 50, 50, 50), adaptive", sin,
              net_of((70, 50, 50, 50), 4), True)]
    worst = {"out": 0.0, "grad": 0.0}

    def diffusion_loss(net, X0, out):
        return torch.mean((net(out.X)[:, 0] - net(X0)[:, 0] - out.Y) ** 2)

    def compare(tag, prob, net, adaptive, X0, kw):
        params = list(net.parameters())
        t0 = torch.zeros(X0.shape[0], device=dev)
        kern = km.fused_stopped_train_rollout(
            prob, net, X0, t0, N, dt, adaptive_forward=adaptive, **kw)
        g_kern = torch.autograd.grad(diffusion_loss(net, X0, kern), params)
        plain = km.reference_stopped_train_rollout(
            prob, net, X0, t0, N, dt, adaptive_forward=adaptive, **kw)
        g_plain = torch.autograd.grad(diffusion_loss(net, X0, plain), params)
        torch.cuda.synchronize()
        agree = (kern.hitting == plain.hitting) & (kern.stopped
                                                   == plain.stopped)
        n_dis = int((~agree).sum())
        check(n_dis <= MASK_TOL * X0.shape[0],
              f"{tag}: {n_dis} paths exit at another step")
        for name in ("X", "Y", "v_l2", "adv_steps"):
            a = getattr(kern, name).detach()[agree]
            b = getattr(plain, name).detach()[agree]
            check(bool(torch.isfinite(a).all()), f"{tag} {name} not finite")
            err = float((a - b).abs().max())
            rel = err / (1.0 + float(b.abs().max()))
            worst["out"] = max(worst["out"], err)
            check(rel <= REL_TOL, f"{tag} {name} rel {rel:.3e} > {REL_TOL}")
        rels = []
        for (pname, _), a, b in zip(net.named_parameters(), g_kern, g_plain):
            err = float((a - b).abs().max())
            scale = float(b.abs().max())
            worst["grad"] = max(worst["grad"], err)
            rels.append(err / scale)
            check(scale > 0 and err <= GRAD_TOL * scale,
                  f"{tag} grad {pname} max_abs {err:.3e} > {GRAD_TOL} * "
                  f"{scale:.3e}")
        print(f"  {tag}: exit step differs on {n_dis} of {X0.shape[0]} "
              f"paths; advancing steps {float(plain.adv_steps.sum()):.0f}; "
              f"outputs ok; grad max|kern-plain|/max|plain| per leaf "
              f"{['%.1e' % r for r in rels]}")

    # -- phase 10: stopped kernels vs plain ----------------------------------
    print(f"phase 10: stopped kernels vs plain, K={Kc}, N={N}, d={d}, "
          f"outputs rel {REL_TOL:g} on agreeing paths, exit-step "
          f"disagreements <= {MASK_TOL:g} K, diffusion-loss gradients "
          f"{GRAD_TOL:g} x max|plain|")
    for tag, prob, net, adaptive in cases:
        X0 = sample_domain(gen, prob.geometry, Kc, d)
        noise = torch.randn((N, Kc, d), generator=gen, device=dev)
        compare(f"[{tag}, host noise]", prob, net, adaptive, X0,
                dict(host_noise=noise))
        del noise
        for rng in ("erfinv", "binom"):
            compare(f"[{tag}, {rng}]", prob, net, adaptive, X0,
                    dict(seed=4321, rng=rng))

    # -- phase 11: the training run -------------------------------------------
    print(f"phase 11: EllipticSolver(rollout_mode='fused_train').train(), "
          f"ExponentialOnBallNonlinearSin d={d} alpha={ALPHA_ELL}, diffusion, "
          f"N={N}, dt={dt}, lr 1e-3, K={K_ELL_TRAIN}, {L_ELL} iterations, "
          f"K_test_log=4096, DenseNet (30, 30)")
    trainer = EllipticSolver(sin, "elliptic_d50", loss_method="diffusion",
                             K=K_ELL_TRAIN, N=N, delta_t=dt, lr=1e-3,
                             L=L_ELL, K_test_log=4096, verbose=False,
                             rollout_mode="fused_train", device=dev)
    check(trainer.resolved_rollout_mode == "fused_train",
          f"engine {trainer.resolved_rollout_mode}")
    km.fused_stopped_train_rollout.launches = 0
    km.fused_stopped_train_rollout.backward_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fwd_launches = km.fused_stopped_train_rollout.launches
    bwd_launches = km.fused_stopped_train_rollout.backward_launches
    tail = float(np.mean(trainer.V_test_L2[-50:]))
    print(f"  {len(trainer.loss_log)} steps in {wall:.2f} s; kernel "
          f"launches: forward {fwd_launches}, backward {bwd_launches}")
    print(f"  test L2 every 250: "
          f"{['%.3e' % v for v in trainer.V_test_L2[::250]]}; loss "
          f"{trainer.loss_log[0]:.4e} -> {trainer.loss_log[-1]:.4e}; "
          f"advancing path-steps per step {np.mean(trainer.K_log):.0f}; "
          f"tail-50 test L2 {tail:.4e} (bound {TEST_L2_BOUND:g})")
    check(fwd_launches == L_ELL and bwd_launches == L_ELL,
          "the training path launched both stopped kernels every step")
    check(all(math.isfinite(v) for v in trainer.loss_log), "finite losses")
    check(tail <= TEST_L2_BOUND, f"tail-50 test L2 {tail:.4e}")

    # -- phase 12: timing -----------------------------------------------------
    Kb = K_ELL_BENCH
    print(f"phase 12: timing at K={Kb}, N={N}, d={d}, erfinv Philox noise, "
          "CUDA events")
    X0 = sample_domain(gen, sin.geometry, Kb, d)
    t0b = torch.zeros(Kb, device=dev)
    gY = torch.randn(Kb, generator=gen, device=dev) / Kb
    times = {}
    for tag, arch in NETS_ELL.items():
        net = net_of(arch, 5)
        call = km._StoppedCall(
            sin, net, X0, t0b, N, dt, 17,
            km._check_stopped_family(sin, net, "erfinv"),
            dict(adaptive_forward=False, rng="erfinv", host_noise=None), None)
        probe = km._stopped_forward_kernel(call)
        hit = float(probe.hitting.sum())
        adv = float(probe.adv_steps.sum())
        n_par = sum(p.numel() for p in net.parameters())
        v_f, fwd_f, bwd_f = stopped_flops(net, d, adaptive=False)
        b_fwd = roofline((hit - adv) * v_f + adv * fwd_f,
                      4 * (n_par + Kb * (2 * d + 5)))
        b_bwd = roofline(adv * bwd_f, 4 * (2 * n_par + Kb * (d + 1)))
        steppers = {}
        for mode in ("fused_train", "scan"):
            steppers[mode] = EllipticSolver(
                sin, "bench", loss_method="diffusion", K=Kb, N=N,
                delta_t=dt, lr=1e-3, L=1, K_test_log=4096, verbose=False,
                rollout_mode=mode, value_net=net_of(arch, 6), device=dev)

        def fwd():
            km._stopped_forward_kernel(call)

        def plain_fwd():
            with torch.no_grad():
                call.plain()

        def bwd():
            km._stopped_backward_kernel(call, gY)

        def plain_bwd():
            km._reference_stopped_backward(call, gY)

        r = {}
        for name, kern_fn, plain_fn, reps in (
                ("forward", fwd, plain_fwd, 10), ("backward", bwd, plain_bwd,
                                                   5),
                ("step", steppers["fused_train"].step,
                 steppers["scan"].step, 5)):
            p1 = timed(plain_fn, 1)
            k = [timed(kern_fn, reps), timed(kern_fn, reps)]
            p2 = timed(plain_fn, 1)
            r[name] = (min(k), min(p1, p2))
            print(f"  {tag:36s} {name:8s} kernel {k[0]:.3f}, {k[1]:.3f} ms; "
                  f"plain {p1:.3f}, {p2:.3f} ms")
        print(f"  {tag}: {hit:.0f} active and {adv:.0f} advancing "
              f"path-steps of K N = {Kb * N}; bound forward "
              f"{b_fwd['bound_ms']:.4f} ms, backward {b_bwd['bound_ms']:.4f}"
              f" ms ({b_fwd['bound_by']}); step {r['step'][0]:.3f} ms -> "
              f"{Kb * N / r['step'][0] * 1e3:.4e} path-steps/s (K N per "
              f"step time)")
        times[tag] = (r, b_fwd, b_bwd, steppers["fused_train"])
    print(f"  card: {smi}")

    first = next(iter(NETS_ELL))
    profile_steps(f"3 solver steps, {first}, K={Kb}", times[first][3].step)

    print(f"  phases 10-12 took {time.perf_counter() - t_phases:.1f} s")
    r, b_fwd, b_bwd, _ = times[first]
    row = {"route": "cuda", "source": STOPPED_SOURCE}
    return [
        dict(row, name="fused_stopped_train_rollout.forward",
             replaces="pspde/rollout/kernels.py:1184", launches=fwd_launches,
             max_abs_err=worst["out"], ms=r["forward"][0],
             plain_ms=r["forward"][1], **b_fwd),
        dict(row, name="fused_stopped_train_rollout.backward",
             replaces="pspde/rollout/kernels.py:1272", launches=bwd_launches,
             max_abs_err=worst["grad"], ms=r["backward"][0],
             plain_ms=r["backward"][1], **b_bwd),
    ]


if __name__ == "__main__":
    main()
