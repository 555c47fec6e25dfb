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
     few training steps.

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
N_TRAIN, DT_TRAIN = 32, 1.0 / 32
K_TRAIN_CHECK, K_BENCH = 8192, 131072


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

    serve_row = {"name": "fused_controlled_rollout", "route": "cuda",
                 "source": SERVE_SOURCE,
                 "replaces": "pspde/rollout/kernels.py:339",
                 "launches": launches, "max_abs_err": worst_abs, "ms": ms,
                 "plain_ms": p_ms}
    train_rows = train_phases(dev, smi, llgc, solver, lqgc, gen, timed)

    print(json.dumps({"kernels": [serve_row] + train_rows}))
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
    try:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(3):
                bench.step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        # device rows only: a CPU op's row repeats the time of the kernels
        # it launched
        dev_time = {}
        for ev in prof.key_averages():
            t = getattr(ev, "self_device_time_total",
                        getattr(ev, "self_cuda_time_total", 0.0))
            if ev.device_type == DeviceType.CUDA and t > 0:
                dev_time[ev.key] = t
        total = sum(dev_time.values())
        print(f"  profiler, 3 binom training steps: device time "
              f"{total / 1e3:.3f} ms of {wall * 1e3:.3f} ms wall (device "
              f"idle {100 * max(0.0, 1 - total / 1e6 / wall):.2f}%)")
        for key, t in sorted(dev_time.items(), key=lambda kv: -kv[1])[:8]:
            print(f"    {100 * t / max(total, 1e-9):6.2f}%  {t / 1e3:9.3f} "
                  f"ms  {key[:90]}")
    except Exception as e:  # the profiler is a report, not a check
        print(f"  profiler unavailable: {type(e).__name__}: {e}")

    row = {"route": "cuda", "source": TRAIN_SOURCE}
    return [
        dict(row, name="fused_train_rollout.forward",
             replaces="pspde/rollout/kernels.py:696", launches=fwd_launches,
             max_abs_err=worst["out"], ms=times["binom"]["forward"][0],
             plain_ms=times["binom"]["forward"][1]),
        dict(row, name="fused_train_rollout.backward",
             replaces="pspde/rollout/kernels.py:788", launches=bwd_launches,
             max_abs_err=worst["grad"], ms=times["binom"]["backward"][0],
             plain_ms=times["binom"]["backward"][1]),
    ]


if __name__ == "__main__":
    main()
