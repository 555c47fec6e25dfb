#!/usr/bin/env python3
"""Drive the PyTorch port's serve and training paths on one CUDA card.

Importance sampling (IS) with a learned control is how a user reads the
PDE solution off a trained model, and ``HJBSolver.train()`` is how the
control is learned.  This script

  1. builds the kernels from pspde_torch/csrc (nvcc, sm_90a, one process
     per source), counts the TF32 HMMA instructions of the serve kernel's
     four (both plans, with and without the double well's drift),
     the HJB forward's and backward's two instantiations each, of the
     ablation ladder's net and full stages on both plans and of the
     stopped backward's twenty-two (fourteen families on the shared plan,
     eight on the device plan) in the library's SASS (none fails), and
     prints the registers and spill bytes of the serve kernel's, the HJB
     forward's and the stopped forward's (fourteen) instantiations from
     ptxas
     (a spill fails);
  2. compares the serve kernel with its plain PyTorch version on host
     noise, on LLGC d=100 with the exported control and on LQGC d=100
     (dense A and sigma, f != 0), at K=8192 and N=100;
  3. does the same on the kernel's own Philox stream, which the plain
     version draws too, elementwise, and holds the serve kernel's outputs
     bitwise equal across 1, 2 and 4 threads a path on both memory plans;
  4. serves IS through pspde_torch.eval.importance_sampling_fused at
     K=2^20 (plain and antithetic) and holds the estimate against the
     exact value log E = 1/2 d dt sum_{j<N} (1 - dt)^{2j} = 21.759305 of
     the Euler-Maruyama chain (discrete Girsanov is exact for additive
     noise, so only Monte-Carlo error remains);
  5. times the serve kernel and the plain version at K=2^20, N=100 with
     CUDA events, both drawing the same Philox stream, and prints the
     kernel's launch (the occupancy API's warps per SM and bytes a block)
     and its bound;
  6. compares the training kernels (forward and replay backward) with
     their plain version on host noise at K=8192, N=32: forward outputs
     and per-leaf gradients of a log-variance (+ KL) loss (within 1e-5 of
     each leaf's largest entry), on LLGC d=100 with the exported control
     and u_tab, and on dense LQGC d=100;
  7. does the same on the Philox stream, for the binom and erfinv maps and
     noise signs +1 and -1;
  8. trains HJBSolver(rollout_mode='fused_train') from the port's own init
     (600 steps, lr 1e-2, K=1024, N=32: the recipe that made the exported
     control), checks the final u_L2, and serves IS with the result;
  9. times the training kernels, the training step and the plain step at
     the bench shape K=131072, N=32, for both noise maps, reads the
     forward's blocks and warps per SM and bytes per block from the CUDA
     occupancy API, and profiles a few training steps;
 10. compares the stopped-path training kernels (forward and replay
     backward) with their plain version at K=8192, N=20, d=50: on
     ExponentialOnBallNonlinearSin(alpha=0.1) with DenseNet (30, 30),
     adaptive and not, on ExponentialOnSphere, and with the notebook net
     DenseNet (70, 50, 50, 50); host noise and the Philox stream (erfinv,
     binom).  Outputs on the paths whose exit step agrees, the count of
     paths whose exit step differs (at most 1e-3 K: |X|^2 is summed in
     another order), per-leaf diffusion-loss gradients, and the backward
     kernel on the plain outputs' cotangents against the plain backward
     (1e-5 of each leaf's largest entry; two launches bitwise equal); and
     once at K=24613, not a multiple of the tile, on fewer blocks than
     tiles, where the backward's lanes take new paths as theirs stop.  The
     forward's outputs must be bitwise equal at its chosen layout, at that
     layout's other grid and at one thread a path on one tile a block, and
     its lanes' trips must sum to the paths' active steps (here and in
     phases 16 and 20);
 11. trains EllipticSolver(rollout_mode='fused_train') on the slice's
     recipe (d=50, N=20, dt=1e-3, lr=1e-3, K=8192, 2000 iterations,
     K_test_log=4096): 2000 launches of each kernel, tail-50 test L2
     <= 1e-3;
 12. times both stopped kernels, one solver step and the plain versions
     at K=65536, N=20 for both nets, reads the block-steps and busy
     lanes that the backward's blocks count against the lane model's
     (they must agree) and the advancing path-steps, prints the forward's
     layout, its warps per SM and bytes a block (the occupancy API's) and
     the lane use its lanes count (also in phases 17 and 22), and profiles
     three solver steps.
 13. runs the HJB-family kernels on their device plan (the net read from
     device memory, each path's arrays in a [row][K] workspace) at LLGC
     d=1000, N=200, K=2048 against their plain versions (serve, training
     outputs and gradients; host noise, binom, erfinv), and forces the
     device plan at d=100, K=8192 against the shared plan (the serve's
     outputs bitwise equal);
 14. trains BASELINE config 5 (LLGC d=1000, T=2, dt=0.01, K=98304,
     log-variance, fused_train, binom) for a few steps on the device plan,
     serves it, times its kernels and steps at those shapes (the plain
     step at K=8192) and profiles one step;
 15. holds the roofline kernels (csrc/roofline.cu) against their plain
     versions (fma_chain over 4 links and by its time at 2P over P
     passes; normals_sum at the rates' shape; every ladder stage on the
     shared plan at d=100 and on the device plan at d=1000, and `full` at
     the bench shape), then measures the FP32 FMA rate, the normals rates
     of both maps, the roofline model at d=100 and d=1000, and the
     ablation ladders at the bench shape and at config 5; normals_sum's
     bound is the larger of its integer multiplies and its own arithmetic
     instructions (4 warp-instructions a clock per SM), counted in its SASS
     loop without the loop's control.
 16. compares the time_stopping branch of the stopped kernels (each path's
     clock, the net on [X, t]) with its plain version at the main path's
     shape: ExponentialOnSphereNonlinearParabolic(d=50), DenseNet (30, 30)
     of input width 51, K=65536, N=20, dt=1e-3, host noise and both Philox
     maps, plain and adaptive_forward; and at the heat shape (BASELINE
     config 2: HeatEquation(d=50, T=0.2) on the whole space, N=100,
     K=4096), where every path runs until its clock ends and no exit step
     may differ.  The clock t must be equal wherever the exit step agrees;
     the backward is held on the plain cotangents as in phase 10;
 17. drives the main path: GeneralSolver(rollout_mode='fused_train') steps
     at K=65536 (one forward and one backward launch per step and no call
     of a plain version), times the step against the scan engine's and
     both kernels against their plain versions, and profiles three steps;
     on the card a value net outside the kernels' family (a TanhMLP)
     raises;
 18. trains that recipe at K=8192, lr 1e-3, K_test_log=4096 for 2000 steps:
     tail-50 test L2 <= 0.12;
 19. takes a few steps of BASELINE config 2 at full width under its cosine
     schedule cosine_decay_schedule(1e-2, 3000, alpha=3e-4) and times the
     step and both kernels there.
 20. compares the torus family of the stopped kernels (the eigen solver's
     domain leg: the square's exit test on the proposal, the drift
     -cos(s) c sin(x), h = y (...) + lambda y, v_ref exp(-sin(s)), the
     lambda leaf, the relu output clamp) with its plain version on
     FokkerPlanckEigen(d=5), N=20, dt=1e-3, K=8192, lambda = 0.3, for the
     solver's default DenseNet (10, 10, 10, 10) (bias 0.8, clamp) and the
     notebook's (no clamp), host noise and both Philox maps, plain and
     adaptive_forward: outputs on the paths whose exit step agrees (at most
     1e-3 K differ), the diffusion-loss gradients of every leaf, lambda's
     nonzero, within GRAD_TOL, and the backward kernel on the plain
     outputs' cotangents within BWD_REL_TOL (two launches bitwise equal);
 21. drives the main path: EigenSolver(FokkerPlanckEigen(d=5),
     rollout_mode='fused_train') on the recipe of
     experiments/eigenvalue_fokker_planck.py for 4000 steps (one forward
     and one backward launch per step, no plain call): the tail-100 V_L2
     and the lambda tail mean within their bounds of JAX's own run
     (experiments/eigen_fp_reference.py); then estimate_lambda on the
     trained net; SchrodingerEigen with the default relu^2 DenseNet on
     fused_train raises, naming the gate;
 22. times both kernels of the family, their plain versions and the solver
     step (against the scan's) at K=500 and K=65536, and profiles three
     steps.
 23. compares the serve kernel's double-well drift (b = -4 kappa x (x^2 -
     1), the kDW instantiations) with its plain version at d=1
     (DoubleWell, eta=3, kappa=5) and d=10 (DoubleWell_multidim, d_1=3,
     d_2=7), K=8192, N=200, dt 0.005, on host noise and the Philox stream
     (signs +1 and -1), every layout bitwise equal; the training kernels
     refuse the drift;
 24. trains HJBSolver on DoubleWell(d=1) on the scan: tests/
     test_double_well_is.py's recipe (eta=1, kappa=1, 400 steps; u_L2 must
     end below 0.3 x its first value; IS through the kernel at K=2^20 must
     read an RE below naive MC's and a log-mean within 0.025 of -v_ref(X_0,
     0) from the FD table), then the notebook's (eta=3, kappa=5, K=10^4,
     40 of its 1000 steps, timed, with the metastable fraction); on the
     card 'fused_train' on the double well raises, naming the gate;
 25. trains DoubleWell_multidim(d=10) (K=500, 40 of its 20000 steps);
 26. trains LQGC(d=10, T=0.5) with LinearLQ under 'outer' (400 steps); in
     24-26 u_L2 must fall (the mean of the last 20 below the first 5's),
     and each scan step is profiled; then serves the learned d=1 and d=10
     controls through importance_sampling_fused at K=2^20, N=200, times the
     kernel and its plain version there and holds one output of each
     against the other and both against the float64 chain
     (serve_against_f64: the trained d=1 control's chain parts float32
     orders by up to ~2e-3 of X on a few dozen of 2^20 paths), and runs
     IS with the FD table's control (control='true') at K=10^5.
 27. compares the stopped kernels' breadth families with their plain
     version at K=8192, DenseNet (30, 30): Committor(d=10), N=50 (the two
     spheres, h = 0, the committor's reference) and
     ExponentialOnBallNonlinearSinHessian(d=20), N=20 (sigma = sqrt(2/d)
     ones(d, d) in the kernels' dense-sigma instantiations, h's (sum x)^2),
     dt 1e-3, adaptive or not, with and without the output clamp, on the
     erfinv stream and (plain, no clamp) host noise: as phase 10, the
     forward bitwise across its layouts;
 28. times both kernels and their plain versions at K=65536 (CUDA events
     and the profiler's device time a launch, over the launches it
     recorded): the committor at JAX's "com10" cell (N=25) and the
     Hessian (N=20), with the bound and the lane use;
 29. trains the notebooks' legs from JAX's initial nets
     (pspde_torch/assets, experiments/stopped_breadth_reference.py):
     the diffusion legs through EllipticSolver(rollout_mode='fused_train')
     for 1000 steps (one launch of each kernel a step, no plain call) and
     the PINN legs for 500 (PINN on 'fused_train' raises, naming the
     gate); each tail-50 test L2 within 3x JAX's at the same recipe and
     step count, and below the leg's first test L2 by at least half of
     JAX's own fall; each step profiled.
 30. compares the cubic family of the stopped kernels (h = y - y^3 with the
     clock: AllenCahn(d=100, T=0.3) on the notebook's sampling ball of
     radius 7, DenseNet (110, 110, 50) on [x, t], the <kTimed, kBreadth>
     instantiations) with its plain version at K=8192, N=25, dt 1e-3, the
     backward on its device plan (the notebook net's 1,924 floats a path
     fit no block): adaptive or not, erfinv, binom and host noise, with
     and without the output clamp; as phase 16 with no path at another
     exit step, and prints the forward's layout and stage and the
     backward's plan and workspace bytes;
 31. forces the backward's device plan on the older families where both
     plans fit (elliptic d=50, gen50, heat, the torus; adaptive or not) and
     holds its gradient rows and block counts bitwise equal to the shared
     plan's on the same grid; the committor's device plan raises;
 32. times the Allen-Cahn pair at K=65536 and the device plan forced at the
     elliptic cell beside the shared plan (CUDA events, the profiler's
     device time), trains the notebook's diffusion leg (alpha0 = 10, K=200,
     K_boundary=50, lr 1e-3, uniform_square, loss_with_stopped=False) for
     1000 steps through 'fused_train' from JAX's initial net (every
     backward on the device plan, no plain call): v(0, 0) within JAX's band
     (experiments/allen_cahn_reference.py, three sampling seeds), the
     tail-50 loss within 3x JAX's and v(0, 0) moved at least half as far as
     JAX's; profiles three steps and times 20 steps of the BSDE leg (N=300).
 33. compares the Schroedinger family of the stopped kernels (zero drift on
     the square, h = -y^3 - y pot(x) + lambda y, v_ref (1/c) exp((1/d) sum
     cos x_j), the tanh features of DenseNetTanh: the <kSch, kTanh>
     instantiations) with its plain version on SchrodingerEigen(d=10),
     DenseNetTanh (15, 15, 15, 15), K=8192, N=20, dt 1e-3, lambda = -2.5:
     with and without the output clamp and JAX's initial net, adaptive or
     not, host noise and both Philox maps; the checks of phase 20, and
     prints the forward's layout and the backward's plan;
 34. times both kernels and their plain versions at the notebook's K=500
     and at K=65536 (CUDA events and the profiler's device time a launch)
     with the bound and the lane use, and the notebook's step on
     'fused_train' and on 'scan' at K=500, each profiled (idle share);
 35. drives the main path: EigenSolver(SchrodingerEigen(d=10),
     rollout_mode='fused_train') on the d=10 recipe of experiments/
     eigenvalue_schroedinger.py (DenseNetTanh with the clamp, lr 1e-3,
     lambda_init -2, K=500, K_boundary=50, alpha (50, 1), 'l2_penalty')
     for 2000 steps from JAX's initial net (one backward launch a step, at
     least one forward launch a step, no plain call): lambda's tail mean
     within JAX's band (experiments/schrodinger_reference.py, three
     sampling seeds), the tail-100 V_L2 within 3x JAX's and lambda moved
     from -2 at least half as far as JAX's; then prints estimate_lambda
     beside lambda_true = -3;
 36. trains six legs (the HJB export recipe, the LQGC 'outer' scan, the
     committor's diffusion and PINN legs, the Allen-Cahn and Schroedinger
     notebook steps), each from one seed for 2 x 50 + 7 steps, once at one
     step per call and once at steps_per_call=50 (one captured CUDA graph,
     replayed): logs, parameters, Adam's state and the generators'
     states bitwise equal, and the training kernels launched once a step
     (and in the graph's warm-up step); prints each mode's step time (CUDA
     events over whole chunks), idle share (torch.profiler), the graph's
     replays and the launches; then holds that a step with a host sync
     under steps_per_call=4 raises at its capture, naming the op.
 37. runs the HJB loss-study notebooks: (a) experiments/ou_linear_costs.py
     at d=40 (LLGC off_diag 0.1, K=500, N=100, lr 1e-3, JAX's initial net)
     with IS at K=20000 every 10 steps, the five losses on the scan (40
     steps) and the four detached ones on fused_train (80 steps, launched
     once a step, per step): a finite IS record every 10 steps, u_L2
     falling, the fused
     log-variance leg's IS runner within 5 SE of the Euler chain's exact
     log E, and that leg without the diagnostics (chunked, captured)
     bitwise the same; (b) experiments/gradient_relative_errors.py in full
     (DoubleWell d=1 'outer', 200 steps, the relative gradient errors
     every 20) within JAX's band of three runs; (c) experiments/
     compare_loss_relative_errors.py at d = 1, 3, ..., 15, K=2^22: finite
     statistics, the cross-entropy RE growing with d much faster than the
     log-variance RE, the table beside BASELINE.md's; (d) the sqrt-schedule
     remat bitwise the per-step rollout at LLGC d=100, K=8192, N=200, and
     two scan steps at config 5's full shape on it (wall, peak memory);
     (e) resume: the HJB export recipe and the committor's diffusion leg
     saved at step 100 of 200 and loaded into a fresh solver train on
     bitwise as the uninterrupted run.
 38. (run right after 35) refines the nets of phases 19, 21, 29, 32 and
     35 with the a-posteriori correctors (pspde_torch/eval/refine.py,
     picard.py, eigen_power.py), each held to its oracle or to JAX's
     band; (e), the Fokker-Planck power iteration, also reads
     estimate_lambda on the scan under the same seed (within 3 SE of the
     kernel's), both engines on one set of host-noise batches (within 0.1
     SE), the committed refined net against JAX's readout on it, and
     kernels 4 and 5 against their plain version on the refined net.
 39. runs the three notebook recipes no earlier phase ran, at their
     scripts' widths from JAX's seed-42 initial nets on the scan: (a)
     experiments/parabolic_neumann.py (GeneralSolver, Neumann data, d=20,
     four alpha2), (b) experiments/ou_moment_initializations.py (the
     moment loss on LLGC d=20 from Y_0 = 0, 10 and the exact v(x_0, 0)),
     (c) experiments/trajectory_length_study.py (EllipticSolver, d=10, N
     from 1 to 100 at two dt), each reading within the band of JAX's
     three seeds at the same step counts, (a) and (c) also falling from
     their first test L2 and (b)'s Y_0 moving from where it was set, each
     at least half as far as JAX's; (c) at N = 1, 20, 100 also on
     fused_train, kernels 4 and 5 held to their plain version at the
     first step and launched once a step; then (d) one scan leg of each
     solver on the rest of problems/ (the first-exit double well, the
     parabolic double-well committor, the linear double well of the
     general solver, the double well beside an OU block): the FD tables
     the host builds equal to the CPU's, finite losses, a falling
     reference error (the loss where no reference exists); the linear
     double well from JAX's initial net, its RMS error against the
     product of the 1-d psi held to JAX's same leg read on the CPU
     (experiments/notebooks_11a_reference.py --part d): equal before
     training, in JAX's band after it, at least half JAX's fall.

Every train() above but phase 39's runs the solvers' default
steps_per_call='auto', as pspde resolves it (min(50, print_every) steps
per call): on the card each chunk is one captured CUDA graph, replayed
(pspde_torch/solvers/_chunk.py), and each leg's launch counts include the
graph's one eager warm-up step.  Phase 39 runs 5 steps a call.

Any failure exits nonzero.  The last line is one JSON object naming the
device.  Run from the repository root:

    python3 chip_smoke.py
"""

import functools
import gc
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
# <= GRAD_TOL * max |plain|.  The stopped backward sums each leaf over the
# 64 (or 32) paths of a block with FP32 FMAs, the N steps and then the
# blocks; the plain version's autograd sums in cuBLAS GEMM order.  The
# gradient is a sum of 2.6e5 path-step terms of both signs, so float32
# reordering moves it by ~1e-6..1e-5 of its largest entry; 1e-3 leaves two
# decades of room and still catches any wrong term, which moves a leaf by
# O(1) of its size.  The HJB loss gradients through both training kernels
# are held to it too.
GRAD_TOL = 1e-3
# The HJB backward (csrc/train_rollout.cu) sums each step's weight-gradient
# products over a block's paths on the tensor cores, as 3xTF32 mma: each
# operand split into two TF32 parts, three products per pair, float32
# accumulators.  Given the plain backward's own cotangents, it reads <= 5.4e-7
# of each leaf's largest entry on an H100 at d=100 (the plain backward
# against itself on permuted paths: <= 3.4e-7), where the plain backward
# with TF32 cuBLAS products reads 6.5e-5 to 4.6e-4 on the largest leaf of
# each case (experiments/torch_backward_error.py): BWD_REL_TOL sits 18x
# above the one and 6.5x below the other.
BWD_REL_TOL = 1e-5
SERVE_SOURCE = "pspde_torch/csrc/controlled_rollout.cu"
TRAIN_SOURCE = "pspde_torch/csrc/train_rollout.cu"
STOPPED_SOURCE = "pspde_torch/csrc/stopped_rollout.cu"
# the stopped backward's device plan, the lanes kernel
LANES_SOURCE = "pspde_torch/csrc/stopped_bwd_lanes.cu"
# the profiler's key of the backward's kernel on each plan (a substring of
# its name and of no other's)
BWD_KEY = {"shared": "stopped_bwd_kernel",
           "device": "stopped_bwd_lane_kernel"}
N_TRAIN, DT_TRAIN = 32, 1.0 / 32
K_TRAIN_CHECK, K_BENCH = 8192, 131072
# the stopped slice (experiments/proto_fused_stopped.py:27-42)
D_ELL, N_ELL, DT_ELL, ALPHA_ELL = 50, 20, 1e-3, 0.1
K_ELL_CHECK, K_ELL_TRAIN, K_ELL_BENCH, L_ELL = 8192, 8192, 65536, 2000
# the refill check: K not a multiple of the tile, past the blocks the card
# holds at once
K_ELL_REFILL = 3 * 8192 + 37
# a net whose backward arrays (1,681 floats a path) fit one block only at
# the stride tile + 1, at tile 32
WIDE_ELL = (85, 85, 85)
NETS_ELL = {"DenseNet (30, 30)": (30, 30),
            "notebook DenseNet (70, 50, 50, 50)": (70, 50, 50, 50)}
# paths whose exit step may differ between kernel and plain: |X|^2 sums in
# another order, so a path within ~1e-7 of the sphere can leave one step
# apart
MASK_TOL = 1e-3
TEST_L2_BOUND = 1e-3
# the space-time slice: the gen50 cell and its convergence leg
# (experiments/proto_fused_stopped_breadth.py:64-77, 113-125) and BASELINE
# config 2 (experiments/baseline_configs.py:41-66)
D_GEN, N_GEN, DT_GEN, K_GEN = 50, 20, 1e-3, 65536
K_GEN_TRAIN, L_GEN = 8192, 2000
STEPS_GEN = 5
# the JAX package's tail-50 test L2 of this recipe is 0.0579, fused and
# scan alike (RESULTS.md:87); v_ref = exp(|x|^2 + t) lies in [1, e^2], and
# an untrained net reads ~8
TEST_L2_BOUND_GEN = 0.12
D_HEAT, T_HEAT, R_HEAT, DT_HEAT, N_HEAT = 50, 0.2, 6.0, 2e-3, 100
K_HEAT, KB_HEAT, L_HEAT, STEPS_HEAT = 4096, 2048, 3000, 5
# the eigen slice: FokkerPlanckEigen(d=5) on the recipe of
# experiments/eigenvalue_fokker_planck.py (K=500, K_boundary=50, 4000 of
# its 100k steps), checked at K_EIG_CHECK with lambda = LAM_EIG and timed
# at K_EIG and K_EIG_BENCH
D_EIG, N_EIG, DT_EIG, LAM_EIG = 5, 20, 1e-3, 0.3
K_EIG, KB_EIG, L_EIG, K_EIG_CHECK, K_EIG_BENCH = 500, 50, 4000, 8192, 65536
# the JAX package's run of that recipe and step count (seed 42, the scan,
# CPU; experiments/eigen_fp_reference.py --L 4000): the mean of the last 100
# V_L2 and the lambda tail mean (last 10%); the port must reach 3x the
# first and max(0.05, 3x) the second
V_L2_TAIL_JAX, LAMBDA_TAIL_JAX = 0.0016942862921860069, -0.010044212591419638
# BASELINE config 5 (experiments/baseline_configs.py:234-253) at the K of
# experiments/proto_d1000_roofline.py; the plain step is timed at K5_PLAIN,
# since at K5 its per-step checkpoints alone would need N K d 4 B = 79 GB
D5, T5, DT5, N5 = 1000, 2.0, 0.01, 200
K5, K5_CHECK, K5_PLAIN, K5_SERVE, STEPS5 = 98304, 2048, 8192, 8192, 3
L5 = 20000   # the decay steps of config 5's cosine schedule
LOG_E5_EXACT = 246.746092
ROOFLINE_SOURCE = "pspde_torch/csrc/roofline.cu"
# the double-well slice: the serve kernel's double-well drift at d=1 and
# d=10 on the notebooks' grid (T=1, dt 0.005: N=200), checked at K_CHECK
# and served at K_SERVE; the training cells of
# experiments/double_well_1d_high_metastability.py (eta=3, kappa=5, K=10^4,
# lr 0.05; 40 of its 1000 steps), double_well_multidim_mixed.py (d=10,
# d_1=3, d_2=7, K=500, lr 5e-3; 40 of its 20000 steps) and
# ou_quadratic_costs_linear_ansatz.py (LQGC d=10, T=0.5, dt 0.05, K=512,
# lr 1e-2, LinearLQ, 'outer'; its 400 steps of tests/test_hjb_solver.py),
# and the recipe of tests/test_double_well_is.py (eta=1, kappa=1, dt 0.01,
# K=1024, lr 5e-3, 400 steps)
DT_DW, N_DW, L_DW = 0.005, 200, 40
# the notebook cells' chunk ('auto' steps_per_call = min(50, print_every)):
# a capture records the chunk's steps (N_DW each) on the host, so a chunk
# of 10 replayed 4 times captures a quarter of what one of 40 does
DW_CHUNK = 10
L_DW_TEST, L_LQ, K_DW_TRUE = 400, 400, 100_000
# the breadth slice: Committor(d=10) (experiments/committor.py: N=50,
# dt 1e-3; timed at JAX's "com10" cell, N=25, RESULTS.md:83) and
# ExponentialOnBallNonlinearSinHessian(d=20) (experiments/
# elliptic_full_hessian.py: N=20, dt 1e-3), checked at K_BR_CHECK and timed
# at K_BR_BENCH; the notebooks' legs cut to L_BR_DIFF and L_BR_PINN steps
D_COM, N_COM, N_COM_BENCH, D_HES, N_HES, DT_BR = 10, 50, 25, 20, 20, 1e-3
K_BR_CHECK, K_BR_BENCH, L_BR_DIFF, L_BR_PINN = 8192, 65536, 1000, 500
K_BR_LEG = 200   # the notebooks' K, at which phase 27 checks the committor too
# the JAX package's runs of those legs at those step counts from the same
# initial nets (seed 42, CPU; experiments/stopped_breadth_reference.py):
# the mean of the last 50 test L2 (K_test_log=10000) and the first one; the
# port's tail must reach 3x JAX's, and the port must fall from its own first
# test L2 by at least half of JAX's fall (an untrained net stays put)
BR_TAIL_JAX = {"committor_diffusion": 0.07768342569470406,
               "hessian_diffusion": 0.013159936517477036,
               "committor_pinn": 0.08584888771176338,
               "hessian_pinn": 5.826070232391357}
BR_FIRST_JAX = {"committor_diffusion": 0.9987972378730774,
                "hessian_diffusion": 6.223019599914551,
                "committor_pinn": 0.9987964630126953,
                "hessian_pinn": 6.236863136291504}
# the Allen-Cahn slice: the notebook's diffusion leg (experiments/
# allen_cahn.py: AllenCahn(d=100, T=0.3) sampled on the ball of radius 7
# with uniform_square, DenseNet (110, 110, 50) on [x, t], N=25, dt 1e-3,
# K=200, K_boundary=50, lr 1e-3, alpha (10, 1, 1), loss_with_stopped=False),
# checked at K_AC_CHECK, timed at K_AC_BENCH, the leg cut to L_AC of its 60k
# steps (2000 until the loss-study phase 37 came); the BSDE leg (N=300,
# alpha (1, 1, 1)) timed for L_AC_BSDE steps
D_AC, T_AC, R_AC, N_AC, DT_AC = 100, 0.3, 7.0, 25, 1e-3
NET_AC = (110, 110, 50)
K_AC_CHECK, K_AC_BENCH, K_AC, KB_AC, L_AC = 8192, 65536, 200, 50, 1000
N_AC_BSDE, L_AC_BSDE = 300, 20
# the JAX package's runs of that leg from the same initial net (seed 42;
# sampling seeds 42, 43, 44; CPU; experiments/allen_cahn_reference.py
# --L 1000): v(0, 0) after L_AC steps, its initial value and the mean of
# the last 50 losses over the three runs (after 2000 steps: v(0, 0) 0.1479,
# 0.1855, 0.1701, the tail 0.0355); the literature's v(0, 0), which the
# notebook nears only after ~60k steps, is printed beside the result
AC_V00_JAX = (0.09900078922510147, 0.15522052347660065, 0.1041320189833641)
AC_V00_INIT_JAX = 0.0
AC_TAIL_JAX = 0.0961051327486833
AC_V00_LITERATURE = 0.052802
# the Schroedinger slice: SchrodingerEigen(d=10) on the d=10 recipe of
# experiments/eigenvalue_schroedinger.py (DenseNetTanh (15, 15, 15, 15) with
# the clamp, lr 1e-3, lambda_init -2, K=500, K_boundary=50, alpha (50, 1),
# 'l2_penalty', N=20, dt 1e-3; L_SCH of its 200k steps), checked at
# K_SCH_CHECK with lambda = LAM_SCH and timed at K_SCH and K_SCH_BENCH
D_SCH, N_SCH, DT_SCH, LAM_SCH = 10, 20, 1e-3, -2.5
NET_SCH = (15, 15, 15, 15)
K_SCH, KB_SCH, L_SCH, K_SCH_CHECK, K_SCH_BENCH = 500, 50, 2000, 8192, 65536
# the JAX package's runs of that recipe from the same initial net (seed 44;
# sampling seeds 42, 43, 44; CPU; experiments/schrodinger_reference.py):
# lambda's first value and its mean over the last 10% of L_SCH steps, and
# the mean over the three runs of the mean of the last 100 V_L2
SCH_LAMBDA_FIRST_JAX = -2.0
SCH_LAMBDA_TAIL_JAX = (-3.1225801849365236, -3.1211551034450533,
                       -3.1258440446853637)
SCH_V_L2_TAIL_JAX = 0.0007755157766708484
# |log IS mean + v_ref(X_0, 0)| of the eta=1, kappa=1 recipe at dt 0.01:
# the JAX package reads 0.0116-0.0119 at K=2^18 over three keys, and the
# FD table's own control 0.0119, the Euler chain's bias against the FD
# solution (experiments/double_well_is_reference.py, CPU); twice that
DW_LOG_MEAN_TOL = 0.025
# instruction slots: 4 warp-instructions a clock per SM (compute capability 9.0),
# 32 threads a warp, at INT_MUL_RATE's SMs and clock
INSTR_RATE = 4 * 32 * 132 * 1.98e9
# the roofline kernels' main-path shapes: the (d, tile) carry of
# pspde/utils/roofline.py, with more passes than its P=512 so that one
# call lasts a millisecond or more (roofline.FMA_P, roofline.NORMALS_P)
FMA_TILE = 4096
# fma_chain vs plain over 4 links (P=1, chain 4: the pass loop's remainder;
# P=4, chain 1: its 4-fold unrolled body): fmaf rounds once where x * x + c
# rounds twice, and each link multiplies an error by |2x| <= 3.83, so one
# ulp of 1 (1.2e-7) can grow to 3.83^4 x 4 ulp ~ 1e-4 at most
FMA_TOL = 1e-4
# fma_chain's time at 2P passes over its time at P: 2 if every pass runs
PASS_RATIO = (1.8, 2.2)
# 32-bit integer multiplies (IMAD, IMAD.HI) per second: 64 per clock per
# SM on compute capability 9.0 (the arithmetic-instruction throughput
# table of NVIDIA's CUDA C++ documentation), 132 SMs at the 1.98 GHz boost
# clock of the H100 SXM data sheet
INT_MUL_RATE = 64 * 132 * 1.98e9
# The least time of a kernel's work: the larger of its operations over the
# peak rate of their type and its bytes (each input read once, each output
# written once) over 3.35 TB/s: NVIDIA's data sheet for the H100 SXM at
# 700 W, dense rates: 67 TFLOP/s in FP32 outside the tensor cores, 495
# TFLOP/s in TF32 on them.  Operations count the arithmetic of the net and
# the step, not the noise generation.
PEAK_FLOPS, PEAK_TF32, PEAK_BYTES = 67e12, 495e12, 3.35e12


def net_products(widths):
    """Operations of a dense stack's products: 2 per weight."""
    return 2 * sum(a * b for a, b in zip(widths[:-1], widths[1:]))


def roofline(flops, nbytes, tf32_flops=0.0):
    """The bound of ``flops`` FP32 operations, ``tf32_flops`` TF32
    tensor-core operations (the two times added) and ``nbytes`` bytes."""
    t_op = flops / PEAK_FLOPS + tf32_flops / PEAK_TF32
    t_b = nbytes / PEAK_BYTES
    return {"bound_ms": 1e3 * max(t_op, t_b),
            "bound_by": "operations" if t_op >= t_b else "bytes",
            "library_ms": None}


def tf32_roofline(flops, products, nbytes):
    """The bound of ``flops`` operations of which ``products`` run on the
    tensor cores as three TF32 products each (3xTF32), the rest in FP32;
    ``bound_ms_fp32`` charges them all at the FP32 rate, the bound of an
    FP32 loop over the same work."""
    return dict(roofline(flops - products, nbytes, 3 * products),
                bound_ms_fp32=roofline(flops, nbytes)["bound_ms"])


def train_fwd_roofline(steps, fwd_flops, widths, nbytes):
    """The HJB forward's bound (and the ladder's): the net's products (2
    operations per weight and path-step) on the tensor cores."""
    return tf32_roofline(steps * fwd_flops, steps * net_products(widths),
                         nbytes)


def train_bwd_roofline(steps, bwd_flops, n_par, widths, nbytes):
    """The HJB backward's bound: the replay's net products and the
    weight-gradient products (2 operations per weight and bias and
    path-step) on the tensor cores."""
    return tf32_roofline(steps * bwd_flops,
                         steps * (2 * n_par + net_products(widths)), nbytes)


def mlp_flops(widths):
    """Multiply-adds of a dense stack (2 per weight) and its activations."""
    prod = sum(a * b for a, b in zip(widths[:-1], widths[1:]))
    return 2 * prod + sum(widths[1:-1])


def train_flops(widths, n_par):
    """FP32 operations of one path-step of the training kernels, (forward,
    backward): the forward is the net plus 15 operations per dimension
    (Euler step, the Z.c, Z.xi, |Z|^2 and u_L2 sums); the backward replays
    it, backpropagates dZ through the hidden layers and forms the weight
    outer products (2 operations per weight and bias)."""
    d = widths[-1]
    fwd = mlp_flops(widths) + 15 * d
    bwd = (fwd + 2 * sum(a * b for a, b in zip(widths[1:-1], widths[2:]))
           + 3 * sum(widths[1:-1]) + 2 * n_par)
    return fwd, bwd


def check(ok, what):
    if not ok:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def captured(s, L):
    """The warm-up steps of solver ``s``'s chunked train() (each launches
    the step's kernels once, eagerly, before its capture), after checking
    that its L steps ran through the default 'auto' steps_per_call as
    captured CUDA graphs: one capture, L // n replays of n steps."""
    g, n = s.graph_stats, s.resolved_steps_per_call
    print(f"  steps_per_call 'auto' -> {n}: {g['captures']} capture(s), "
          f"{g['warmup_steps']} warm-up step(s), {g['replays']} replays of "
          f"{n} steps, {L - n * g['replays']} eager step(s)")
    check(s.steps_per_call == "auto" and n > 1 and g["captures"] == 1
          and g["replays"] == L // n,
          f"the {L} steps ran as captured graphs ({g}, n={n})")
    return g["warmup_steps"]


def ptxas_usage(log, kernel):
    """{mangled instantiation: (registers, spill store bytes, spill load
    bytes)} of the named kernel's instantiations, read from the -Xptxas -v
    report in the build log."""
    import re
    usage, fn, spill = {}, None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = m.group(1) if kernel in m.group(1) else None
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and fn:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            usage[fn] = (int(m.group(1)),) + spill
            fn, spill = None, (0, 0)
    return usage


def lane_args(mangled):
    """The template booleans of a mangled kernel instantiation, as 0s and
    1s in order (e.g. '000011')."""
    import re
    m = re.search(r"I((?:Lb[01]E)+)E", mangled)
    return "".join(re.findall(r"Lb([01])E", m.group(1))) if m else mangled


def sass_text(lib_path):
    """``cuobjdump -sass`` of the built library."""
    from pspde_torch.rollout import _build
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    return subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, check=True).stdout


def tf32_mma_counts(lib_path, kernels):
    """{kernel: {instantiation: count of TF32 HMMA instructions}} of the
    named kernels' instantiations, read from ``cuobjdump -sass`` of the
    built library."""
    counts, fn = {k: {} for k in kernels}, None
    for line in sass_text(lib_path).splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            fn = next(((k, name) for k in kernels if k in name), None)
            if fn is not None:
                counts[fn[0]][fn[1]] = 0
        elif fn is not None and "HMMA" in line and "TF32" in line:
            counts[fn[0]][fn[1]] += 1
    return counts


def sass_of(lib_path, kernel):
    """[(address, instruction)] of the named kernel in ``cuobjdump -sass``
    of the built library, branch targets as addresses."""
    import re
    insts, inside = [], False
    for line in sass_text(lib_path).splitlines():
        if "Function :" in line:
            inside = kernel in line
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if inside and m:
            insts.append((int(m.group(1), 16), m.group(2).strip()))
    return insts


# the opcodes of normals_sum's own arithmetic: Philox's multiplies, xors
# and adds (the key schedule's on the uniform datapath too), the map's
# bit shifts, FP32 arithmetic and MUFU, and the sum's FADD; the rest of its
# loop (branches, convergence barriers, compares, moves, constant loads) is
# control the function does not need
NORMALS_WORK = ("IMAD", "IMAD.WIDE", "IMAD.WIDE.U32", "IMAD.HI.U32",
                "IADD3", "UIADD3", "LOP3.LUT", "SHF.L.U32", "SHF.R.U32.HI",
                "LEA", "LEA.HI", "FFMA", "FADD", "FMUL", "FMNMX", "MUFU.LG2",
                "MUFU.RSQ", "MUFU.SQRT", "I2F", "I2FP.F32.U32", "F2I")


def normals_instructions(lib_path):
    """Instructions a normal that normals_sum_kernel runs on its loop's
    common path: from the head of its (longest) loop to the backward
    branch, following every unconditional branch and falling through every
    predicated one, which in its SASS is the erfinv map (the binom map
    behind the rng branch) and erfinvf's central polynomial (its tail,
    |z| > ~2.8, behind a branch); over the path's MUFU.LG2, one a normal.
    Returns (the function's own arithmetic a normal, the opcodes of
    NORMALS_WORK; every instruction of the path a normal; the path's
    opcode counts)."""
    import re
    insts = sass_of(lib_path, "normals_sum_kernel")
    at = {a: i for i, (a, _) in enumerate(insts)}
    loops = []
    for a, t in insts:
        m = re.search(r"\bBRA\b\s+(0x[0-9a-f]+)", t)
        if m and int(m.group(1), 16) < a:
            loops.append((int(m.group(1), 16), a))
    head, tail = max(loops, key=lambda lp: lp[1] - lp[0])
    i, path = at[head], []
    while True:
        a, t = insts[i]
        path.append(t)
        if a == tail:
            break
        m = re.search(r"\bBRA\b\s+(0x[0-9a-f]+)", t)
        i = at[int(m.group(1), 16)] if m and not t.startswith("@") else i + 1
    ops = {}
    for t in path:
        op = t.split()[1] if t.startswith("@") else t.split()[0]
        ops[op] = ops.get(op, 0) + 1
    check(ops.get("MUFU.LG2", 0) > 0 and "POPC" not in ops
          and "CALL.REL.NOINC" not in ops,
          f"normals_sum's common path is the erfinv map's: {ops}")
    work = sum(n for op, n in ops.items() if op in NORMALS_WORK)
    return (work / ops["MUFU.LG2"], len(path) / ops["MUFU.LG2"],
            dict(sorted(ops.items())))


def compare_serve(tag, kern, plain):
    """Serve kernel against its plain version, output by output, within
    REL_TOL; returns the largest absolute difference."""
    torch.cuda.synchronize()
    worst = 0.0
    for name in ("X", "ito", "riemann", "f_int"):
        a, b = getattr(kern, name), getattr(plain, name)
        check(a.shape == b.shape, f"{tag} {name} shape {a.shape} vs {b.shape}")
        check(bool(torch.isfinite(a).all()), f"{tag} {name} not finite")
        err = float((a - b).abs().max())
        scale = float(b.abs().max())
        rel = err / (1.0 + scale)
        worst = max(worst, err)
        print(f"  {tag} {name:8s} max_abs {err:.3e} max|plain| "
              f"{scale:.3e} rel {rel:.3e}")
        check(rel <= REL_TOL, f"{tag} {name} rel {rel:.3e} > {REL_TOL}")
    return worst


def double_well_chain_f64(prob, net, K, N, dt, seed):
    """The serve's Euler chain of a double-well problem in float64 (the
    net's weights, the drift and the sums) on the kernel's Philox stream
    (``seed``, sign +1) with the kernel's float32 dt and sqrt(dt): (X, ito,
    riemann, grow), ``grow`` each path's sum over its steps of dt times
    the largest slope of the drift, max_j max(0, -4 kappa_j (3 x_j^2 -
    1)): the exponent by which the chain magnifies a perturbation of X."""
    import copy
    from pspde_torch.rollout.kernels import philox_normals
    from pspde_torch.rollout.sde import step_constants, step_time
    f64 = torch.float64
    net64 = copy.deepcopy(net).to(f64)
    kappa = prob.drift_family()[1].to(f64)
    sig = prob.sigma_struct
    dt, sq_dt = step_constants(dt)
    X = prob.X_0.to(f64).expand(K, prob.d)
    ito = torch.zeros(K, dtype=f64, device=X.device)
    riem, grow = torch.zeros_like(ito), torch.zeros_like(ito)
    with torch.no_grad():
        for n in range(N):
            t = step_time(n, dt)
            xi = philox_normals(seed, K, n, prob.d, device=X.device).to(f64)
            u = -net64(torch.cat([torch.full((K, 1), t, dtype=f64,
                                             device=X.device), X], dim=1))
            slope = -4.0 * kappa * (3.0 * X * X - 1.0)
            grow += slope.clamp(min=0.0).amax(dim=-1) * dt
            X = X + (-4.0 * kappa * X * (X * X - 1.0) + sig.apply(u)) * dt \
                + sig.apply(xi) * sq_dt
            ito += torch.sum(u * xi, dim=-1) * sq_dt
            riem += torch.sum(u * u, dim=-1) * dt
    return X, ito, riem, grow


def serve_against_f64(tag, kern, plain, ref):
    """The serve kernel against its plain version where the chain itself
    magnifies float32 rounding (a trained double-well control at K=2^20):
    each against the float64 chain ``ref`` (double_well_chain_f64 on the
    same noise), output by output, differences over 1 + max|ref|.  Kernel
    and plain must agree within REL_TOL on all but 1e-3 K paths (the
    stopped kernels' allowance for paths on which the two float32 orders
    part), and the kernel may stand no farther from the float64 chain
    than twice the plain version does (or REL_TOL).  Prints the paths of
    the largest kernel-plain differences with their growth exponents;
    returns the largest absolute kernel-plain difference."""
    torch.cuda.synchronize()
    grow = ref[3]
    out, worst = {}, 0.0
    for name, r in zip(("X", "ito", "riemann"), ref[:3]):
        a = getattr(kern, name).to(torch.float64)
        b = getattr(plain, name).to(torch.float64)
        scale = 1.0 + float(r.abs().max())

        def by_path(v):
            return v.abs().amax(dim=-1) if v.dim() == 2 else v.abs()
        kp, kr, pr = by_path(a - b), by_path(a - r), by_path(b - r)
        over = int((kp > REL_TOL * scale).sum())
        out[name] = (float(kp.max()) / scale, float(kr.max()) / scale,
                     float(pr.max()) / scale, over)
        top = torch.topk(kp, 3).indices
        print(f"  {tag} {name:8s} over 1 + max|f64| = {scale:.3e}: "
              f"kernel-plain {out[name][0]:.3e}, kernel-f64 "
              f"{out[name][1]:.3e}, plain-f64 {out[name][2]:.3e}; paths "
              f"with kernel-plain > {REL_TOL:g}: {over} of {kp.numel()}; "
              f"the largest three (kernel-plain, kernel-f64, plain-f64, "
              f"growth exponent): "
              + ", ".join(f"({float(kp[i]):.2e}, {float(kr[i]):.2e}, "
                          f"{float(pr[i]):.2e}, {float(grow[i]):.2f})"
                          for i in top.tolist()))
        worst = max(worst, float(kp.max()))
        check(bool(torch.isfinite(a).all()) and over <= 1e-3 * kp.numel(),
              f"{tag} {name}: {over} paths with kernel-plain > {REL_TOL:g}")
        check(out[name][1] <= max(REL_TOL, 2.0 * out[name][2]),
              f"{tag} {name}: kernel-f64 {out[name][1]:.3e} against "
              f"plain-f64 {out[name][2]:.3e}")
    q = torch.quantile(grow[:65536].float(),
                       torch.tensor([0.5, 0.999], device=grow.device))
    print(f"  {tag} growth exponent: median {float(q[0]):.2f}, 99.9% "
          f"{float(q[1]):.2f}, max {float(grow.max()):.2f}")
    return worst


def serve_layouts(tag, prob, net, kern, K=K_CHECK, N=N_STEPS, dt=DT_IS):
    """The serve kernel at tile 32 and 1, 2 and 4 threads a path on both
    memory plans, on the Philox stream of ``kern`` (seed 1234, sign +1, the
    wrapper's layout, K paths, N steps of dt): every output bitwise equal
    to ``kern``'s (the sums' classes make every layout sum in one
    order)."""
    from pspde_torch.rollout import kernels as km
    drift, cost = km._check_family(prob, net, True, 1.0)
    same = {}
    for tpp in (1, 2, 4):
        for plan in km.PLANS:
            packed = km._pack(prob, net, drift, cost, K, N, dt,
                              32, None, 1.0, plan, tpp)
            out = km._serve_kernel(packed, None, 1234, prob.X_0.device)
            same[f"32x{tpp} {plan}"] = all(torch.equal(a, b)
                                           for a, b in zip(out, kern))
    print(f"  {tag} layouts bitwise equal to the wrapper's: {same}")
    check(all(same.values()), f"{tag} serve layouts bitwise: {same}")


def serve_occupancy(prob, net, K, dev, N=N_STEPS, dt=DT_IS):
    """The serve kernel's launch at K paths as the wrapper chooses it."""
    from pspde_torch.rollout import kernels as km
    drift, cost = km._check_family(prob, net, True, 1.0)
    packed = km._pack(prob, net, drift, cost, K, N, dt, None, None, 1.0)
    return km._train_fwd_occupancy(packed, dev, "pspde_serve_occupancy")


def serve_roofline(steps, widths, n_par, K, per_dim=10):
    """The serve kernel's bound: per path-step the TanhMLP's products on
    the tensor cores as 3xTF32 and its activations and ``per_dim``
    operations per dimension (the Euler step, the Ito and Riemann sums: 10;
    15 with the double well's drift) in FP32; the net read once and
    (K, d + 3) written."""
    d = widths[-1]
    return tf32_roofline(steps * (mlp_flops(widths) + per_dim * d),
                         steps * net_products(widths),
                         4 * (n_par + K * (d + 3)))


def timed(fn, reps, warm=True):
    """ms per call of ``fn`` over ``reps`` calls, CUDA events, after one
    warm-up call unless ``warm`` is False."""
    if warm:
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


def timed_out(fn):
    """(ms, output) of one call of ``fn``, CUDA events, no warm-up."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop), out


def compare_rel(tag, a, b):
    """max |a - b| / (1 + max |b|) within REL_TOL, a finite; returns
    max |a - b|."""
    torch.cuda.synchronize()
    check(a.shape == b.shape, f"{tag} shape {a.shape} vs {b.shape}")
    check(bool(torch.isfinite(a).all()), f"{tag} not finite")
    err = float((a - b).abs().max())
    rel = err / (1.0 + float(b.abs().max()))
    print(f"  {tag}: max_abs {err:.3e} rel {rel:.3e}")
    check(rel <= REL_TOL, f"{tag} rel {rel:.3e} > {REL_TOL}")
    return err


def train_loss(prob, out, kw):
    """The log-variance loss (+ the KL term where it is accumulated) whose
    gradients the training checks compare."""
    from pspde_torch.losses import log_variance_loss
    gX = prob.g(out.X)
    loss = log_variance_loss(out.Y, gX)
    if kw.get("accumulate_kl"):
        loss = loss + torch.mean(out.Z_sum + gX)
    return loss


def train_call(prob, net, K, N, dt, kw):
    """The call that ``fused_train_rollout(prob, net, K, N, dt, **kw)``
    makes: what the backward kernel replays."""
    from pspde_torch.rollout import kernels as km
    o = dict(adaptive_forward=True, accumulate_kl=False, kl_ito_term=False,
             u_tab=None, rng="binom", noise_sign=1.0, host_noise=None)
    o.update({k: v for k, v in kw.items() if k not in ("seed", "plan")})
    families = km._check_train_family(prob, net, N, o["noise_sign"],
                                      o["u_tab"], o["rng"])
    return km._TrainCall(prob, net, K, N, dt, kw.get("seed", 0), families,
                         o, None, kw.get("plan"))


def rel_per_leaf(tag, what, names, got, want, tol, worst=None):
    """max |got - want| / max |want| per leaf, each within ``tol``; updates
    ``worst`` ("grad", "grad_rel") where given."""
    rels = []
    for name, a, b in zip(names, got, want):
        err = float((a - b).abs().max())
        scale = float(b.abs().max())
        rels.append(err / scale)
        check(scale > 0 and err <= tol * scale,
              f"{tag} {what} {name} max_abs {err:.3e} > {tol} * {scale:.3e}")
        if worst is not None:
            worst["grad"] = max(worst["grad"], err)
    if worst is not None:
        worst["grad_rel"] = max(worst.get("grad_rel", 0.0), *rels)
    return f"{what} {['%.1e' % r for r in rels]} (<= {tol:g})"


def compare_train(tag, prob, net, K, N, dt, kw, worst):
    """Training kernels against their plain version: the forward's outputs
    within REL_TOL; the backward kernel and the plain backward on the same
    cotangents (those of ``train_loss`` at the plain outputs), per leaf
    within BWD_REL_TOL; and the loss gradients through both kernels against
    those through the plain version, per leaf within GRAD_TOL: they carry
    the forward's output differences (~3e-7 of Y) through the loss, whose
    weights Y - g(X) - mean a trained control makes small, and read up to
    ~1e-5.  Updates ``worst`` ("out", "grad": the largest
    absolute differences of the outputs and of the backward, "grad_rel": the
    backward's largest max|kern - plain| / max|plain| over the leaves) and
    returns the kernel's outputs and loss gradients."""
    from pspde_torch.rollout import kernels as km
    params = list(net.parameters())
    names = [n for n, _ in net.named_parameters()]
    kern = km.fused_train_rollout(prob, net, K, N, dt, **kw)
    g_kern = torch.autograd.grad(train_loss(prob, kern, kw), params)
    plain = km.reference_train_rollout(
        prob, net, K, N, dt, **{k: v for k, v in kw.items() if k != "plan"})
    Y = plain.Y.detach().requires_grad_()
    Zs = plain.Z_sum.detach().requires_grad_()
    gY, gKL = torch.autograd.grad(
        train_loss(prob, plain._replace(Y=Y, Z_sum=Zs), kw), [Y, Zs],
        allow_unused=True)
    gKL = torch.zeros_like(gY) if gKL is None else gKL
    # the loss gradients through the plain version are the plain
    # backward's on (gY, gKL): the autograd replay of the same forward
    outs = [(o, g) for o, g in ((plain.Y, gY), (plain.Z_sum, gKL))
            if o.requires_grad]
    g_plain = torch.autograd.grad([o for o, _ in outs], params,
                                  [g for _, g in outs])
    g_bwd = km._train_backward_kernel(train_call(prob, net, K, N, dt, kw),
                                      gY, gKL)
    torch.cuda.synchronize()
    for name in ("X", "Y", "Z_sum", "u_l2"):
        a, b = getattr(kern, name).detach(), getattr(plain, name).detach()
        check(a.shape == b.shape, f"{tag} {name} shape")
        check(bool(torch.isfinite(a).all()), f"{tag} {name} not finite")
        err = float((a - b).abs().max())
        rel = err / (1.0 + float(b.abs().max()))
        worst["out"] = max(worst["out"], err)
        check(rel <= REL_TOL, f"{tag} {name} rel {rel:.3e} > {REL_TOL}")
    bwd = rel_per_leaf(tag, "backward", names, g_bwd, g_plain, BWD_REL_TOL,
                       worst)
    loss = rel_per_leaf(tag, "loss gradients", names, g_kern, g_plain,
                        GRAD_TOL)
    print(f"  {tag}: outputs ok; max|kern-plain|/max|plain| per leaf: "
          f"{bwd}; {loss}")
    return kern, g_kern


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
    hmma = tf32_mma_counts(info["path"], ("train_backward_kernel",
                                          "train_forward_kernel",
                                          "controlled_rollout_kernel",
                                          "stopped_bwd_kernel",
                                          "stopped_bwd_lane_kernel",
                                          "ablation_kernel"))

    def by_plan(counts):
        return {("device" if "ILb1E" in k else "shared"): v
                for k, v in counts.items()}

    def serve_keys(counts):
        # controlled_rollout_kernel<kDevice, kDW>: the plan, then "dw" for
        # the double well's instantiations
        return {("device" if "ILb1E" in k else "shared")
                + (" dw" if "ELb1EE" in k else ""): v
                for k, v in counts.items()}

    train_hmma = by_plan(hmma["train_backward_kernel"])
    fwd_hmma = by_plan(hmma["train_forward_kernel"])
    serve_hmma = serve_keys(hmma["controlled_rollout_kernel"])
    stopped_hmma = sorted(hmma["stopped_bwd_kernel"].values())
    lane_hmma = sorted(hmma["stopped_bwd_lane_kernel"].values())
    # the ladder's stages: 0 noise, 1 euler, 2 net, 3-6 full*
    ladder_hmma = {}
    for name, n in hmma["ablation_kernel"].items():
        stage = int(name.split("ablation_kernelILi")[1].split("E")[0])
        plan = "device" if f"ILi{stage}ELb1E" in name else "shared"
        ladder_hmma[f"{stage}{plan[0]}"] = n
    print(f"  TF32 HMMA instructions in the serve kernel's SASS: "
          f"{serve_hmma}; the HJB forward's: {fwd_hmma}; "
          f"the backward's: {train_hmma}; the ladder's stages (stage, "
          f"s/d plan): {dict(sorted(ladder_hmma.items()))}; the stopped "
          f"backward's fourteen shared-plan instantiations: {stopped_hmma}, "
          f"its device plan's twelve (the lanes kernel): {lane_hmma}")
    check(len(train_hmma) == 2 and all(train_hmma.values()),
          "both plans of the HJB backward run TF32 mma")
    check(len(fwd_hmma) == 2 and all(fwd_hmma.values()),
          "both plans of the HJB forward run TF32 mma")
    check(len(serve_hmma) == 4 and all(serve_hmma.values()),
          "both plans of the serve kernel run TF32 mma, the double well's "
          "instantiations too")
    check(len(ladder_hmma) == 14
          and all(ladder_hmma[f"{st}{p}"] for st in range(2, 7)
                  for p in "sd"),
          "the ladder's net and full stages run TF32 mma on both plans")
    check(len(stopped_hmma) == 14 and all(stopped_hmma)
          and len(lane_hmma) == 12 and all(lane_hmma),
          "every instantiation of the stopped backward, both plans, runs "
          "TF32 mma")
    for kernel, what, keys, n in (
            ("controlled_rollout_kernel", "the serve kernel", serve_keys, 4),
            ("train_forward_kernel", "the HJB forward", by_plan, 2)):
        use = keys(ptxas_usage(info["log"], kernel))
        print(f"  ptxas, {what} (registers, spill store and load bytes): "
              f"{use}")
        check(len(use) == n and all(u[1] == u[2] == 0 for u in use.values()),
              f"{what}'s instantiations spill no registers")
    stopped_use = ptxas_usage(info["log"], "stopped_fwd_kernel")
    lane_use_regs = ptxas_usage(info["log"], "stopped_bwd_lane_kernel")
    print(f"  ptxas, the stopped forward's fourteen instantiations "
          f"(registers, spill store and load bytes): "
          f"{sorted(stopped_use.values())}; the backward's shared plan's "
          f"fourteen: "
          f"{sorted(ptxas_usage(info['log'], 'stopped_bwd_kernel').values())}"
          f"; its device plan's twelve (the lanes kernel, "
          f"stopped_bwd_lane_kernel<kTimed, kTorus, kRelu, kBreadth, kSch, "
          f"kTanh>): " + "; ".join(
              f"{lane_args(k)} {v}" for k, v in sorted(
                  lane_use_regs.items(), key=lambda kv: lane_args(kv[0]))))
    check(len(lane_use_regs) == 12, "the lanes kernel's twelve "
          "instantiations built (the Schroedinger family's and the "
          "committor's among them)")
    check(len(stopped_use) == 14
          and all(u[1] == u[2] == 0 for u in stopped_use.values()),
          "the stopped forward's instantiations spill no registers")
    block_regs = ptxas_usage(info["log"], "stopped_fwd_block_kernel")
    print(f"  ptxas, the stopped forward's block kernel (the nets no block "
          f"stages), its eight instantiations (registers, spill store and "
          f"load bytes): {sorted(block_regs.values())}")
    check(len(block_regs) == 8
          and all(u[1] == u[2] == 0 for u in block_regs.values()),
          "the block forward's eight instantiations built, spilling no "
          "registers")

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
        worst_abs = max(worst_abs, compare_serve(tag, kern, plain))

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
            if sign == 1.0:
                serve_layouts(f"[{tag}]", prob, net, kern)

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
              f"{bound:.3e}), {wall:.4f} s wall, "
              f"{K_SERVE * N_STEPS / wall:.4e} path-steps/s")
        check(math.isfinite(mean) and mean > 0, f"IS mean {mean}")
        check(err <= bound, f"|log mean - exact| {err:.3e} > {bound:.3e}")
    print(f"  control_test_error {cte:.4f} (K=16384)")
    check(0.0 < cte < 0.2, f"control_test_error {cte}")

    # -- phase 5: timing -----------------------------------------------------
    print(f"phase 5: kernel vs plain, LLGC d=100, K={K_SERVE}, N={N_STEPS}, "
          "Philox noise, CUDA events")

    def kern():
        return km.fused_controlled_rollout(llgc, solver.z_net, K_SERVE,
                                           N_STEPS, DT_IS, seed=5)

    def plain():
        return km.reference_controlled_rollout(llgc, solver.z_net, K_SERVE,
                                               N_STEPS, DT_IS, seed=5)

    plain_ms = [timed(plain, 1)]
    kern_ms = [timed(kern, 10), timed(kern, 10)]
    plain_ms.append(timed(plain, 1))
    ms, p_ms = min(kern_ms), min(plain_ms)
    steps = K_SERVE * N_STEPS
    print(f"  kernel {kern_ms} ms -> {steps / ms * 1e3:.4e} path-steps/s")
    print(f"  plain  {plain_ms} ms -> {steps / p_ms * 1e3:.4e} path-steps/s")
    print(f"  card: {smi}")

    occ = serve_occupancy(llgc, solver.z_net, K_SERVE, dev)
    print(f"  kernel launch (the occupancy API's theoretical residency, not "
          f"a measurement): {occ}")
    n_par = sum(p.numel() for p in solver.z_net.parameters())
    serve_row = {"name": "fused_controlled_rollout", "route": "cuda",
                 "source": SERVE_SOURCE,
                 "replaces": "pspde/rollout/kernels.py:339",
                 "launches": launches, "max_abs_err": worst_abs, "ms": ms,
                 "plain_ms": p_ms,
                 **serve_roofline(steps, [D + 1, 30, 30, D], n_par, K_SERVE)}
    print(f"  bound {serve_row['bound_ms']:.3f} ms "
          f"({serve_row['bound_by']}; all in FP32 "
          f"{serve_row['bound_ms_fp32']:.3f} ms)")
    train_rows = train_phases(dev, smi, llgc, solver, lqgc, gen, timed)
    stopped_rows = stopped_phases(dev, smi, timed)
    config5, wide_rows = wide_phases(dev, smi, llgc, solver)
    roofline_rows = roofline_phases(dev, smi, llgc, solver, config5)
    del config5   # its K=98304 buffers; phase 37 takes a config-5 scan step
    general_rows, heat_leg = general_phases(dev, smi)
    eigen_rows, fp_leg = eigen_phases(dev, smi)
    dw_rows = double_well_phases(dev, smi)
    breadth_rows, committor_leg = breadth_phases(dev, smi)
    ac_rows, ac_leg = allen_cahn_phases(dev, smi)
    sch_rows, sch_leg = schrodinger_phases(dev, smi)
    # phase 38 refines the nets the phases above trained, and runs before
    # 36 and 37, so that the five solvers and their device memory are
    # gone before those phases' captures and timings
    corrector_phase(dev, smi, heat_leg=heat_leg, fp_leg=fp_leg,
                    committor_leg=committor_leg, ac_leg=ac_leg,
                    sch_leg=sch_leg)
    del heat_leg, fp_leg, committor_leg, ac_leg, sch_leg
    gc.collect()
    torch.cuda.empty_cache()
    chunk_phase(dev, smi, llgc)
    loss_study_phase(dev, smi, llgc)
    notebook_phase(dev, smi)

    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [serve_row] + train_rows + stopped_rows
                      + roofline_rows + wide_rows + general_rows
                      + eigen_rows + dw_rows + breadth_rows + ac_rows
                      + sch_rows}))
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

    def compare(tag, prob, net, kw):
        compare_train(tag, prob, net, Kc, N, dt, kw, worst)

    # -- phase 6: training kernels vs plain on host noise --------------------
    print(f"phase 6: training kernels vs plain on host noise, K={Kc}, N={N}, "
          f"outputs rel {REL_TOL:g}; per gradient leaf, the backward on the "
          f"same cotangents {BWD_REL_TOL:g} x max|plain|, the loss gradients "
          f"{GRAD_TOL:g} x max|plain|")
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
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fwd_launches, bwd_launches = counted(km.fused_train_rollout, "launches",
                                         "backward_launches")
    u0, u_end = trainer.u_L2_loss[0], trainer.u_L2_loss[-1]
    print(f"  {len(trainer.u_L2_loss)} steps in {wall:.2f} s; kernel "
          f"launches: forward {fwd_launches}, backward {bwd_launches}")
    print(f"  u_L2 {u0:.4f} -> {u_end:.4f} (every 100: "
          f"{['%.4f' % u for u in trainer.u_L2_loss[::100]]}); loss "
          f"{trainer.loss_log[-1]:.4e}; Y_0 {trainer.Y_0_log[-1]:.4f}")
    warm = captured(trainer, 600)
    check(fwd_launches == 600 + warm and bwd_launches == 600 + warm,
          "the training path launched both training kernels every step (and "
          "in the warm-up step)")
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
        call = train_call(llgc, net, Kb, N, dt, dict(kw, seed=17))

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

    occ = km._train_fwd_occupancy(
        train_call(llgc, net, Kb, N, dt, dict(u_tab=u_tab)).pack(False), dev)
    print(f"  forward launch at the bench shape (the occupancy API's "
          f"theoretical residency from registers and shared memory, not "
          f"a measurement): {occ}")
    bench.fused_rng = "binom"
    profile_steps("3 binom training steps", bench.step)

    n_par = sum(p.numel() for p in net.parameters())
    widths = [D + 1, 30, 30, D]
    fwd_flops, bwd_flops = train_flops(widths, n_par)
    row = {"route": "cuda", "source": TRAIN_SOURCE}
    rows = [
        dict(row, name="fused_train_rollout.forward",
             replaces="pspde/rollout/kernels.py:696", launches=fwd_launches,
             max_abs_err=worst["out"], ms=times["binom"]["forward"][0],
             plain_ms=times["binom"]["forward"][1],
             **train_fwd_roofline(steps, fwd_flops, widths,
                                  4 * (n_par + N * D + Kb * (D + 3)))),
        dict(row, name="fused_train_rollout.backward",
             replaces="pspde/rollout/kernels.py:788", launches=bwd_launches,
             max_abs_err=worst["grad"], max_rel_err=worst["grad_rel"],
             ms=times["binom"]["backward"][0],
             plain_ms=times["binom"]["backward"][1],
             **train_bwd_roofline(steps, bwd_flops, n_par, widths,
                                  4 * (2 * n_par + N * D + 2 * Kb))),
    ]
    for r in rows:
        fp32 = (f"; all in FP32 {r['bound_ms_fp32']:.3f} ms"
                if "bound_ms_fp32" in r else "")
        print(f"  {r['name']} bound {r['bound_ms']:.3f} ms "
              f"({r['bound_by']}{fp32})")
    return rows


def profile_steps(what, step, n=3):
    """Device time and idle share of ``n`` calls of ``step`` under
    torch.profiler, and the kernels that took most of it; returns the last
    call's result."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            out = step()
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
    return out


def stopped_flops(v_net, d, adaptive, torus=False, full=False,
                  cubic=False, sch=False):
    """FP32 operations of one advancing path-step of the stopped kernels,
    counted from their code (csrc/stopped_rollout.cu): (V only, forward,
    backward).  The net reads ``v_net.d_in`` inputs (d, or d + 1 with
    time_stopping) and the step moves d coordinates.  V: the dense
    products, bias, relu and square of each hidden layer, the output dot;
    grad V: the transposed products and 2 relu(h) g; the step: 9 per
    dimension.  The backward replays V (and grad V when adaptive), the
    tangent sweep, the pair sweep and the weight outer products (4 per
    weight: two terms).  The torus family (each sin, cos and exp one
    operation) adds s and q (6 per dimension), the drift (3 per dimension)
    and the box test (2 per dimension) to both kernels, h with lambda and
    -cos(s) (7) and v_ref (6) to the forward, dh/dy + lambda and the lambda
    gradient (6) to the backward.  A dense sigma (``full``) adds its d x d
    products, 2 d^2 each: Z and sigma xi to both kernels, sigma c to both
    when adaptive (and Z's to the backward), and w to the backward.  The
    cubic (``cubic``: h's c_y3 y^3) adds 4 to the forward (y y y, the
    coefficient and the sum) and 4 to the backward's dh/dy (3 c_y3 y y and
    the sum).  The Schroedinger family (``sch``; the net's tanh features,
    each tanh one operation) adds S and pot's terms (8 per dimension: cos,
    sin, sin^2, the two divisions, their difference and the two sums) and
    the box test (2 per dimension) to both kernels, pot's 5 (2/d S, exp,
    the product, two sums), h with lambda (7) and v_ref (7) to the forward,
    dh/dy + lambda and the lambda gradient (9) to the backward; a tanh unit
    costs one more operation than relu^2 in V (tanh and the slope 1 - t^2
    against relu and the square) and one less in grad V and in the
    backward's tangent (a product by the slope against 2 r g)."""
    widths, d_in = list(v_net.arch), v_net.d_in
    ins = [d_in + sum(widths[:l]) for l in range(len(widths))]
    F = d_in + sum(widths)
    v = sum(2 * n * w + 3 * w for n, w in zip(ins, widths)) + 2 * F
    grad = sum(2 * n * w + 2 * w for n, w in zip(ins, widths))
    fwd = v + grad + 9 * d
    bwd = (v + (grad if adaptive else 0) + 8 * d
           + sum(2 * n * w + 2 * w for n, w in zip(ins, widths))
           + sum(6 * w + 4 * (n - d_in) * w for n, w in zip(ins, widths))
           + sum(4 * (n + 1) * w for n, w in zip(ins, widths)) + 4 * F + 2)
    if torus:
        fwd += 11 * d + 13
        bwd += 11 * d + 6
    if full:
        fwd += 2 * d * d * (3 if adaptive else 2)
        bwd += 2 * d * d * (4 if adaptive else 2)
    if cubic:
        fwd += 4
        bwd += 4
    if sch:
        # tanh: V +1 a unit, grad V -1 (the forward's sum is even), the
        # backward's replay +1, its tangent -1, its grad V (adaptive) -1
        H = sum(widths)
        v += H
        fwd += 10 * d + 19
        bwd += 10 * d + 14 - (H if adaptive else 0)
    return v, fwd, bwd


def stopped_bwd_roofline(adv, bwd_flops, v_net, nbytes):
    """The stopped backward's bound over ``adv`` advancing path-steps: its
    hidden layers' weight-gradient products (4 operations per weight and
    bias and path-step: the pair's two terms) run on the tensor cores as
    three TF32 products each (3xTF32), the rest in FP32; ``bound_ms_fp32``
    charges them all at the FP32 rate."""
    ins = [v_net.d_in + sum(v_net.arch[:l]) for l in range(len(v_net.arch))]
    products = adv * sum(4 * (n + 1) * w for n, w in zip(ins, v_net.arch))
    return dict(roofline(adv * bwd_flops - products, nbytes, 3 * products),
                bound_ms_fp32=roofline(adv * bwd_flops, nbytes)["bound_ms"])


def stopped_lane_schedule(lane_steps, tile, grid):
    """A model of the backward kernel's lanes (stopped_rollout.cu:
    stopped_bwd_kernel), the prediction its own counts are held to: each
    of the ``grid`` blocks of ``tile`` lanes owns its range of whole tiles
    of paths (``_stopped_ranges``); before each block-step the lanes
    without a step to take get the next paths of the range in lane order,
    and a path that takes no step frees its lane in the same refill; every
    busy lane then takes one step of its path.  ``lane_steps[k]`` is the
    number of steps path k occupies a lane: its advancing steps on the
    ball and the whole space (the exit test of a step is made at the end
    of the step before), its active steps (``hitting``) on the torus,
    where the step whose proposal leaves is spent.  Returns
    ``block_steps`` (summed over the blocks), the longest block's
    ``max_block_steps``, ``lane_steps`` (their sum) and ``runs``: per path
    (block, lane, first block-step, steps)."""
    import numpy as np
    from pspde_torch.rollout import kernels as km
    lane_steps = np.asarray(lane_steps, dtype=np.int64)
    K = lane_steps.shape[0]
    runs = [None] * K
    total = longest = 0
    for b, (lo, hi) in enumerate(km._stopped_ranges(K, tile, grid)):
        left = [0] * tile      # steps the lane's path still takes
        nxt, step = lo, 0
        while True:
            while nxt < hi:
                free = [i for i in range(tile) if left[i] == 0]
                if not free:
                    break
                for i in free[:hi - nxt]:
                    runs[nxt] = (b, i, step, int(lane_steps[nxt]))
                    left[i] = int(lane_steps[nxt])
                    nxt += 1
            if not any(left):
                break
            left = [max(v - 1, 0) for v in left]
            step += 1
        total += step
        longest = max(longest, step)
    return {"block_steps": total, "max_block_steps": longest,
            "lane_steps": int(lane_steps.sum()), "runs": runs}


def stopped_fwd_lane_schedule(steps, tile, grid, tpp=1):
    """A model of the forward kernel's lanes (stopped_rollout.cu:
    stopped_fwd_kernel): ``grid`` blocks of ``tile`` lanes; lane i (lane i
    mod tile of block i div tile) first takes path i, then, each time its
    path ends, the next path of one queue (lanes that free at the same
    trip take paths in lane order; on the card their order is the atomics'
    and varies).  ``steps[k]``: the trips path k takes (``hitting``: the
    step that stops is taken too).  Returns per lane its ``trips`` (grid,
    tile) and ``runs``: per path (lane, first trip, trips); and ``busy``,
    the lane-trips that the lanes' warps (32 / tpp lanes each) run: each
    warp runs its busiest lane's trips."""
    import heapq
    import numpy as np
    steps = np.asarray(steps, dtype=np.int64)
    K, lanes = steps.shape[0], grid * tile
    trips = np.zeros(lanes, dtype=np.int64)
    runs = [None] * K
    free = []
    for i in range(min(lanes, K)):
        runs[i] = (i, 0, int(steps[i]))
        trips[i] = steps[i]
        heapq.heappush(free, (int(steps[i]), i))
    for k in range(lanes, K):
        at, i = heapq.heappop(free)
        runs[k] = (i, at, int(steps[k]))
        trips[i] += steps[k]
        heapq.heappush(free, (at + int(steps[k]), i))
    trips = trips.reshape(grid, tile)
    return {"trips": trips, "runs": runs,
            "busy": fwd_warp_lane_trips(trips, tpp)}


def fwd_warp_lane_trips(trips, tpp):
    """Lane-trips of the forward's warps: each warp (32 / tpp consecutive
    lanes of a block of ``trips`` (grid, tile)) runs as many trips as its
    busiest lane."""
    per_warp = 32 // tpp
    t = trips.reshape(trips.shape[0], -1, per_warp)
    return int(t.max(axis=2).sum()) * per_warp


def fwd_lane_use(call, dev):
    """The forward's lanes in this run: one launch counts each lane's trips
    (``_stopped_forward_launch``); their sum must be the paths' active steps
    (each path runs once, on one lane).  Lane use = advancing path-steps
    over the lane-trips of the warps (each runs its busiest lane's trips);
    the model (``stopped_fwd_lane_schedule``) gives the same for the queue
    in lane order, and for the one-thread-a-path, one-tile-a-block schedule
    of the parent.  The block forward (the nets no block stages) counts
    each path's trips; its tiles step together, so lane use = advancing
    path-steps over its blocks' steps (the most trips of a tile) x tile,
    and the model reads the same from the paths' active steps.  Returns a
    dict for the reports."""
    import numpy as np
    from pspde_torch.rollout import kernels as km
    packed = call.pack(backward=False)
    occ = km._stopped_fwd_occupancy(packed, dev)
    out, trips = km._stopped_forward_launch(call)
    trips = trips.long().cpu().numpy()
    hit = out.hitting.long().cpu().numpy()
    n_adv = int(out.adv_steps.sum())
    check(int(trips.sum()) == int(hit.sum()),
          f"the forward's lanes ran {int(trips.sum())} trips for "
          f"{int(hit.sum())} active path-steps")
    K, T = hit.shape[0], 64
    old = stopped_fwd_lane_schedule(hit, T, -(-K // T))
    block = km._stopped_fwd_block_of(packed)
    if block is not None:
        padded = np.zeros(trips.size, dtype=np.int64)
        padded[:K] = hit
        busy = int(trips.max(axis=1).sum()) * block.tile
        model = int(padded.reshape(-1, block.tile).max(axis=1).sum()) \
            * block.tile
        layout = (f"block forward, tiles of {block.tile} paths on "
                  f"{block.threads} threads, slices of {block.rows} rows in "
                  f"{block.stages} buffers")
    else:
        lay = km._FwdLayout(*packed.layout)
        busy = fwd_warp_lane_trips(trips, lay.tpp)
        model = stopped_fwd_lane_schedule(hit, lay.tile, trips.shape[0],
                                          lay.tpp)["busy"]
        layout = (f"{lay.tile} lanes x {lay.tpp} threads, "
                  f"{'refilled' if lay.refill else 'one block a tile'}")
    return {"layout": layout,
            "grid": trips.shape[0], "warps_per_sm": occ["warps_per_sm"],
            "block_bytes": occ["smem_bytes"], "active": int(hit.sum()),
            "advancing": n_adv, "lane_use": n_adv / busy,
            "lane_use_model": n_adv / model,
            "lane_use_parent_schedule": n_adv / old["busy"]}


def print_fwd_lane_use(tag, use):
    print(f"  {tag} forward: {use['layout']}, {use['grid']} blocks; the "
          f"occupancy API's {use['warps_per_sm']} warps per SM and "
          f"{use['block_bytes']} bytes a block (theoretical); lanes: "
          f"{use['active']} active and {use['advancing']} advancing "
          f"path-steps, lane use {100 * use['lane_use']:.1f}% counted by "
          f"the kernel (the model's {100 * use['lane_use_model']:.1f}%; one "
          f"thread a path at one tile of 64 a block: "
          f"{100 * use['lane_use_parent_schedule']:.1f}%)")


def lane_use(call, out, gY, torus=False):
    """The stopped backward's lanes in this run: one launch on ``gY``
    counts, per block, its block-steps and its busy lanes summed over them
    (``_stopped_backward_rows``); ``out`` is the forward kernel's output
    on the same call, whose steps the backward replays bitwise.  Lane use
    = advancing path-steps over block-steps x tile.  Returns (measured,
    model): the model ``stopped_lane_schedule`` on ``out``'s step counts
    (a path occupies a lane for its advancing steps, on the torus for its
    active ones) predicts the kernel's counts, and the run fails where
    they differ; the kernel before the refill (one block per tile paths
    until its slowest path stopped: the most ``hitting`` of its paths) is
    a model only, and stays out of the kernels line."""
    from pspde_torch.rollout import kernels as km
    _, counts = km._stopped_backward_rows(call, gY)
    counts = counts.long().cpu().numpy()
    tile, K = call.pack(backward=True).iargs[5], call.X0.shape[0]
    hit = out.hitting.long().cpu().numpy()
    adv = out.adv_steps.long().cpu().numpy()
    grid = counts.shape[0]
    n_adv = int(adv.sum())
    measured = {"tile": tile, "grid": grid,
                "block_steps": int(counts[:, 0].sum()),
                "max_block_steps": int(counts[:, 0].max()),
                "lane_steps": int(counts[:, 1].sum()),
                "advancing_path_steps": n_adv}
    measured["lane_use"] = n_adv / (measured["block_steps"] * tile)
    new = stopped_lane_schedule(hit if torus else adv, tile, grid)
    old = sum(int(hit[lo:lo + tile].max()) for lo in range(0, K, tile))
    model = {"block_steps": new["block_steps"],
             "max_block_steps": new["max_block_steps"],
             "lane_steps": new["lane_steps"],
             "blocks_before": -(-K // tile), "block_steps_before": old,
             "lane_use_before": n_adv / (old * tile)}
    check(all(measured[k] == model[k] for k in ("block_steps",
                                                "max_block_steps",
                                                "lane_steps")),
          f"the backward's lane counts {measured} differ from the lane "
          f"model's {model}")
    return measured, model


def bwd_layout(packed, dev):
    """The stopped backward's launch for one packed call: its plan, tile
    and threads a lane, where the lanes' arrays and the net sit, the grid,
    the stride, the workspace's and a block's shared bytes, and the warps
    per SM (the occupancy API's theoretical residency)."""
    from pspde_torch.rollout import kernels as km
    grid = km._stopped_bwd_grid(packed, dev)
    ts = km._stopped_bwd_ts(packed, grid)
    lay = km._stopped_bwd_lane_of(packed)
    tile, tpp = packed.iargs[5], 1 if lay is None else lay.tpp
    per_path = km._stopped_bwd_per_path(packed)
    in_ws = lay is not None and not lay.smem
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    per_sm = km._stopped_bwd_slots(packed, dev) // sms
    return {"plan": packed.layout[0], "tile": tile, "tpp": tpp,
            "arrays": "workspace" if in_ws else "shared memory",
            "net": "staged" if packed.iargs[6] else "device memory",
            "grid": grid, "stride": ts, "per_path": per_path,
            "workspace_bytes": 4 * per_path * ts if in_ws else 0,
            "block_bytes": km._stopped_bwd_smem(packed, ts),
            "warps_per_sm": per_sm * tile * tpp // 32}


# the device plan's (tile, threads a lane) candidates of phase 32's sweep
BWD_SWEEP = ((64, 4), (32, 4), (32, 8), (16, 4), (16, 8), (16, 16), (8, 16),
             (8, 32))


def bwd_layout_sweep(cells):
    """The device plan's backward at each layout that fits (each (tile,
    tpp) of BWD_SWEEP with the lanes' arrays in the workspace and the net
    from device memory or staged, and with the arrays in shared memory
    where they fit, the net staged beside them where it fits too): device
    ms a launch (torch.profiler) for each cell {tag: (call, gY, reps)},
    and the chosen layout's.  At the first cell the gradients of every
    layout of one tile must be bitwise equal, and those of every tile
    within BWD_REL_TOL of tile 64's (max |diff| / max |tile 64| over the
    leaves).  Returns {"ms": {tag: {layout: ms}}, "chosen": {tag: ms},
    "rel": {layout: rel}}."""
    from pspde_torch.rollout import kernels as km
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "experiments"))
    from torch_kernel_times import device_ms
    first = next(iter(cells))
    cands = []
    for tile, tpp in BWD_SWEEP:
        for smem in (False, True):
            for stage in (False, True):
                lay = km._BwdLayout(tile, tpp, smem, stage)
                try:
                    cells[first][0]._replace(bwd_layout=lay).pack(
                        backward=True)
                except ValueError:
                    continue
                cands.append(lay)
    out = {"ms": {}, "chosen": {}, "rel": {}}
    grads = {}
    for tag, (call, gY, reps) in cells.items():
        chosen = km._stopped_bwd_lane_of(call.pack(backward=True))
        ms = out["ms"][tag] = {}
        for lay in cands + ([] if chosen in cands else [chosen]):
            c = call._replace(bwd_layout=lay)

            def bwd(c=c):
                return km._stopped_backward_kernel(c, gY)
            # the profiler can drop a run's launches: up to three runs
            dms = None
            for _ in range(3):
                dms, _ = device_ms(bwd, reps, "stopped_bwd")
                if dms is not None:
                    break
            ms[lay] = float("nan") if dms is None else dms
            if tag == first:
                grads[lay] = bwd()
        out["chosen"][tag] = ms[chosen]
        print(f"  the device plan's layouts at {tag}, fastest first (tile, "
              "threads a lane, arrays in shared memory, net staged: device "
              "ms a launch): " + "; ".join(
                  f"{tuple(lay)} {v:.3f}"
                  for lay, v in sorted(ms.items(), key=lambda kv: kv[1]))
              + f"; chosen {tuple(chosen)}: {ms[chosen]:.3f}, "
              f"{ms[chosen] / min(ms.values()):.3f}x the fastest")
    torch.cuda.synchronize()
    ref = grads[next(lay for lay in cands if lay.tile == 64)]
    for lay, g in grads.items():
        same = grads[next(c for c in cands if c.tile == lay.tile)]
        check(all(torch.equal(a, b) for a, b in zip(g, same)),
              f"the device plan at {tuple(lay)} differs bitwise from the "
              f"other layouts of tile {lay.tile}")
        out["rel"][lay] = max(float((a - b).abs().max())
                              / float(b.abs().max())
                              for a, b in zip(g, ref))
    worst = max(out["rel"].values())
    print(f"  at {first}: every layout of one tile bitwise equal; against "
          f"tile 64, max |diff| / max |64| " + ", ".join(
              f"tile {t} {max(v for lay, v in out['rel'].items() if lay.tile == t):.3e}"
              for t in sorted({lay.tile for lay in grads}, reverse=True)))
    check(worst <= BWD_REL_TOL, f"the device plan's layouts against tile 64:"
          f" {worst:.3e} > {BWD_REL_TOL:g}")
    return out


# the block forward's (tile, threads, slice rows, ring buffers) candidates of
# phase 32's sweep, at the notebook's K and at the timing K
FWD_SWEEP = {"small": ((1, 64, 16, 3), (2, 64, 16, 3), (2, 128, 8, 3),
                       (2, 128, 16, 2), (4, 128, 16, 3), (4, 256, 16, 3)),
             "large": ((16, 128, 4, 2), (16, 128, 8, 3), (16, 128, 16, 2),
                       (16, 256, 16, 2), (32, 256, 8, 3), (32, 256, 16, 3))}


def fwd_layout_sweep(cells):
    """The block forward at each layout of FWD_SWEEP (and the chosen one)
    for each cell {tag: (call, reps, candidates)}: device ms a launch
    (torch.profiler; up to three runs where it drops the launches), the
    outputs bitwise equal to the chosen layout's.  Returns {"ms": {tag:
    {layout: ms}}, "chosen": {tag: ms}, "layout": {tag: chosen}}."""
    from pspde_torch.rollout import kernels as km
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "experiments"))
    from torch_kernel_times import device_ms
    out = {"ms": {}, "chosen": {}, "layout": {}}
    for tag, (call, reps, cands) in cells.items():
        chosen = km._stopped_fwd_block_of(call.pack(backward=False))
        ref = km._stopped_forward_kernel(call)
        ms = out["ms"][tag] = {}
        for lay in dict.fromkeys((chosen,) + tuple(
                km._FwdBlockLayout(*c) for c in cands)):
            c = call._replace(fwd_block=lay)
            got = km._stopped_forward_kernel(c)
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(got, ref)),
                  f"the block forward at {tuple(lay)} differs bitwise from "
                  f"the chosen layout at {tag}")
            dms = None
            for _ in range(3):
                dms, _ = device_ms(lambda c=c: km._stopped_forward_kernel(c),
                                   reps, "stopped_fwd_block")
                if dms is not None:
                    break
            ms[lay] = float("nan") if dms is None else dms
        out["chosen"][tag], out["layout"][tag] = ms[chosen], tuple(chosen)
        fastest = min(v for v in ms.values() if v == v)
        print(f"  the block forward's layouts at {tag}, fastest first (tile, "
              "threads, slice rows, buffers: device ms a launch; outputs "
              "bitwise equal): " + "; ".join(
                  f"{tuple(lay)} {v:.3f}"
                  for lay, v in sorted(ms.items(), key=lambda kv: kv[1]))
              + f"; chosen {tuple(chosen)}: {ms[chosen]:.3f}, "
              f"{ms[chosen] / fastest:.3f}x the fastest")
    return out


def print_lane_use(tag, use):
    measured, model = use
    print(f"  {tag} lanes: {measured['advancing_path_steps']} advancing "
          f"path-steps; counted by the kernel: {measured['grid']} blocks of "
          f"{measured['tile']} lanes, {measured['block_steps']} block-steps "
          f"(the longest block {measured['max_block_steps']}), "
          f"{measured['lane_steps']} busy lane-steps, lane use "
          f"{100 * measured['lane_use']:.1f}% (the lane model: "
          f"{model['block_steps']}, {model['max_block_steps']}, "
          f"{model['lane_steps']}); the model of one block per tile until "
          f"its slowest path stopped: {model['blocks_before']} blocks, "
          f"{model['block_steps_before']} block-steps, lane use "
          f"{100 * model['lane_use_before']:.1f}%")


class PlainCalls:
    """Counts the calls of the stopped kernels' plain versions while
    entered: the main path may make none."""

    def __init__(self, km):
        self.km, self.n = km, 0

    def __enter__(self):
        km = self.km
        self.originals = (km.reference_stopped_train_rollout,
                          km._reference_stopped_backward)

        def counting(fn):
            def wrapped(*a, **k):
                self.n += 1
                return fn(*a, **k)
            return wrapped

        km.reference_stopped_train_rollout = counting(self.originals[0])
        km._reference_stopped_backward = counting(self.originals[1])
        return self

    def __exit__(self, *exc):
        (self.km.reference_stopped_train_rollout,
         self.km._reference_stopped_backward) = self.originals


def check_lane_layouts(tag, call, gY, rows):
    """The device plan's gradient rows and block counts ``rows`` (at the
    layout the packer chose) against the lanes kernel at every other
    threads-a-lane that the chosen tile takes, and with the lanes' arrays
    in the workspace and the net in device memory, on the same grid:
    bitwise equal (each sum stays one thread's chain in the one-thread
    order whatever the lane's width, so a wrong split fails here).  None
    on the shared plan; else the chosen layout and those held to it."""
    from pspde_torch.rollout import kernels as km
    chosen = km._stopped_bwd_lane_of(call.pack(backward=True))
    if chosen is None:
        return None
    grid = rows[0].shape[0]
    held = []
    for lay in ([chosen._replace(tpp=p) for p in km._STOPPED_LANE_TPP]
                + [chosen._replace(smem=False, stage=False)]):
        c = call._replace(bwd_layout=lay)
        try:
            c.pack(backward=True)
        except ValueError:
            continue
        if lay == chosen or lay in held:
            continue
        other = km._stopped_backward_rows(c, gY, grid)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(rows, other)),
              f"{tag}: the lanes kernel's gradient rows or block counts at "
              f"{tuple(lay)} differ bitwise from the chosen {tuple(chosen)}")
        held.append(lay)
    check(len(held) > 0, f"{tag}: no other layout of the chosen "
          f"{tuple(chosen)}")
    return tuple(chosen), [tuple(lay) for lay in held]


def check_backward(tag, call, net, gY, agree, worst, zero_leaves=(),
                   lam_scale=None):
    """The backward kernel against the plain backward on the plain outputs'
    cotangents ``gY`` (zero on the paths whose exit step differs, where the
    two replays part): within BWD_REL_TOL of each net leaf's largest entry
    (``zero_leaves``, whose gradient vanishes by construction: of 1e-3 of
    the largest leaf's), and with ``call.lam`` lambda's entry within
    BWD_REL_TOL of ``lam_scale``.  Two launches must give bitwise-equal
    gradient rows and the same block counts, and on the device plan the
    other layouts of its tile the same again (``check_lane_layouts``).
    Updates worst["bwd"]; returns the per-leaf ratios, lambda's error, the
    blocks and the layouts held."""
    from pspde_torch.rollout import kernels as km
    gY = gY * agree.to(gY.dtype)
    rows = km._stopped_backward_rows(call, gY)
    again = km._stopped_backward_rows(call, gY)
    g_bwd = km._stopped_backward_kernel(call, gY)
    g_ref = km._reference_stopped_backward(call, gY)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(rows, again)),
          f"{tag}: two launches of the backward gave different gradient "
          "rows or block counts")
    lanes = check_lane_layouts(tag, call, gY, rows)
    names = [n for n, _ in net.named_parameters()]
    n_net = len(names)
    top = max(float(b.abs().max()) for b in g_ref[:n_net])
    rels = []
    for name, a, b in zip(names, g_bwd, g_ref):
        err = float((a - b).abs().max())
        scale = 1e-3 * top if name in zero_leaves else float(b.abs().max())
        worst["bwd"] = max(worst["bwd"], err)
        rels.append(err / scale)
        check(scale > 0 and err <= BWD_REL_TOL * scale,
              f"{tag} backward {name} max_abs {err:.3e} > {BWD_REL_TOL} * "
              f"{scale:.3e}")
    lam_err = None
    if call.lam is not None:
        lam_err = float((g_bwd[-1] - g_ref[-1]).abs())
        worst["bwd"] = max(worst["bwd"], lam_err)
        check(lam_err <= BWD_REL_TOL * lam_scale,
              f"{tag} backward lambda {lam_err:.3e} > {BWD_REL_TOL} * "
              f"{lam_scale:.3e}")
    return rels, lam_err, rows[0].shape[0], lanes


def lanes_note(lanes):
    """check_backward's layouts held, for the reports."""
    if lanes is None:
        return "shared plan"
    chosen, held = lanes
    return (f"lanes kernel at {chosen}, rows bitwise at "
            + ", ".join(str(lay) for lay in held))


def one_thread_layout(call):
    """The forward's one-thread-a-path, one-tile-a-block schedule (the
    kernel before its lanes were refilled and split): tile 64, or 32 where
    64 paths' arrays fit no block."""
    for tile in (64, 32):
        try:
            call._replace(fwd_layout=(tile, 1, False)).pack(backward=False)
            return (tile, 1, False)
        except ValueError:
            continue
    raise RuntimeError("no one-thread layout fits")


def fwd_layout_name(packed):
    """A packed forward call's kernel and layout, for the reports."""
    from pspde_torch.rollout import kernels as km
    block = km._stopped_fwd_block_of(packed)
    if block is not None:
        return (f"block {block.tile}x{block.threads} rows {block.rows} "
                f"stages {block.stages}")
    f = km._FwdLayout(*packed.layout)
    return f"{f.tile}x{f.tpp}{' refilled' if f.refill else ''}"


def other_block_layout(call, block):
    """A block forward layout other than ``block`` in every field that
    fits the call's net: half the tile (2 at tile 1), another thread
    count, slice depth and ring."""
    from pspde_torch.rollout import kernels as km
    tile = block.tile // 2 if block.tile > 1 else 2
    lay = km._FwdBlockLayout(tile, 128 if block.threads != 128 else 64,
                             4 if block.rows != 4 else 8, 5 - block.stages)
    call._replace(fwd_block=lay).pack(backward=False)
    return lay


def check_fwd_layouts(tag, call, kern):
    """The forward's outputs bitwise equal across layouts and kernels:
    ``kern`` (the main path's, at the chosen layout), the chosen layout
    launched again, and for the lanes kernel its other grid (refilled lanes
    or one block a tile) and one thread a path at one tile a block; for the
    block forward (the nets no block stages) another block layout and the
    lanes kernel (stopped_fwd_kernel) forced at its own layout and at one
    thread a path.  Each launch's lanes ran as many trips as the paths'
    active steps (each path once).  Returns the layouts' names."""
    from pspde_torch.rollout import kernels as km
    packed = call.pack(backward=False)
    block = km._stopped_fwd_block_of(packed)
    if block is None:
        lay = km._FwdLayout(*packed.layout)
        forced = [{}, dict(fwd_layout=(lay.tile, lay.tpp, not lay.refill)),
                  dict(fwd_layout=one_thread_layout(call))]
    else:
        forced = [{}, dict(fwd_block=other_block_layout(call, block)),
                  dict(fwd_kernel="lanes"),
                  dict(fwd_layout=one_thread_layout(call))]
    names = []
    for kw in forced:
        c = call._replace(**kw)
        out, trips = km._stopped_forward_launch(c)
        torch.cuda.synchronize()
        name = fwd_layout_name(c.pack(backward=False))
        names.append(name)
        check(all(torch.equal(a.detach(), b.detach())
                  for a, b in zip(out, kern)),
              f"{tag}: the forward at layout {name} differs from the main "
              "path's bitwise")
        check(int(trips.sum()) == int(out.hitting.sum()),
              f"{tag}: layout {name} ran {int(trips.sum())} trips for "
              f"{int(out.hitting.sum())} active path-steps")
    return names


def compare_stopped(tag, prob, net, X0, t0, N, dt, kw, worst, mask_tol,
                    time_stopping=False, zero_leaves=(), bwd_zero_leaves=None):
    """Stopped kernels against their plain version from (X0, t0): outputs
    (and the clock t, which must be equal) on the paths whose exit step
    agrees, the count of paths whose exit step differs (at most
    ``mask_tol`` K), and per-leaf gradients of the diffusion loss through
    the backward kernel; then the backward kernel on the plain outputs'
    cotangents against the plain backward, and two of its launches against
    each other (``check_backward``).  ``zero_leaves`` names the leaves
    whose gradient vanishes by construction (with h = 0 the loss does not
    see the output bias): those are held to 1e-3 of the largest leaf;
    ``bwd_zero_leaves`` (``zero_leaves`` where None) those of Y's
    gradient alone, which the backward sums (with h = 0 the output bias's,
    output clamp or not).
    Updates ``worst`` ("out", "grad", "bwd": largest absolute
    differences)."""
    from pspde_torch.rollout import kernels as km
    params = list(net.parameters())
    kw = dict(kw, time_stopping=time_stopping)

    def V(X, t):
        if time_stopping:
            X = torch.cat([X, t[:, None]], dim=-1)
        return net(X)[:, 0]

    def diffusion_loss(out):
        return torch.mean((V(out.X, out.t) - V(X0, t0) - out.Y) ** 2)

    call = km._StoppedCall(
        prob, net, X0, t0, N, dt, kw.get("seed", 0),
        km._check_stopped_family(prob, net, kw.get("rng", "erfinv"),
                                 time_stopping),
        dict(adaptive_forward=kw.get("adaptive_forward", False),
             rng=kw.get("rng", "erfinv"), host_noise=kw.get("host_noise"),
             time_stopping=time_stopping), None)
    kern = km.fused_stopped_train_rollout(prob, net, X0, t0, N, dt, **kw)
    g_kern = torch.autograd.grad(diffusion_loss(kern), params)
    layouts = check_fwd_layouts(tag, call, kern)
    plain = km.reference_stopped_train_rollout(prob, net, X0, t0, N, dt,
                                               **kw)
    g_plain = torch.autograd.grad(diffusion_loss(plain), params)
    torch.cuda.synchronize()
    agree = (kern.hitting == plain.hitting) & (kern.stopped == plain.stopped)
    n_dis = int((~agree).sum())
    check(n_dis <= mask_tol * X0.shape[0],
          f"{tag}: {n_dis} paths exit at another step")
    check(torch.equal(kern.t[agree], plain.t[agree]),
          f"{tag}: the clocks differ on paths whose exit step agrees")
    for name in ("X", "Y", "v_l2", "adv_steps"):
        a = getattr(kern, name).detach()[agree]
        b = getattr(plain, name).detach()[agree]
        check(bool(torch.isfinite(a).all()), f"{tag} {name} not finite")
        err = float((a - b).abs().max())
        rel = err / (1.0 + float(b.abs().max()))
        worst["out"] = max(worst["out"], err)
        check(rel <= REL_TOL, f"{tag} {name} rel {rel:.3e} > {REL_TOL}")
    rels = []
    top = max(float(b.abs().max()) for b in g_plain)
    for (pname, _), a, b in zip(net.named_parameters(), g_kern, g_plain):
        err = float((a - b).abs().max())
        scale = float(b.abs().max())
        worst["grad"] = max(worst["grad"], err)
        if pname in zero_leaves:
            scale = 1e-3 * top
        rels.append(err / scale)
        check(scale > 0 and err <= GRAD_TOL * scale,
              f"{tag} grad {pname} max_abs {err:.3e} > {GRAD_TOL} * "
              f"{scale:.3e}")
    # the backward on the plain outputs' cotangents
    Y = plain.Y.detach().requires_grad_()
    (gY,) = torch.autograd.grad(diffusion_loss(plain._replace(Y=Y)), [Y])
    bwd, _, grid, lanes = check_backward(
        tag, call, net, gY, agree, worst,
        zero_leaves if bwd_zero_leaves is None else bwd_zero_leaves)
    print(f"  {tag}: forward layouts {layouts} bitwise equal; exit step "
          f"differs on {n_dis} of {X0.shape[0]} paths; advancing steps "
          f"{float(plain.adv_steps.sum()):.0f}; outputs ok; grad "
          f"max|kern-plain|/max|plain| per leaf "
          f"{['%.1e' % r for r in rels]}; backward on plain cotangents "
          f"{['%.1e' % r for r in bwd]} ({grid} blocks, "
          f"{lanes_note(lanes)}), two launches bitwise equal")


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
    worst = {"out": 0.0, "grad": 0.0, "bwd": 0.0}

    def compare(tag, prob, net, adaptive, X0, kw):
        compare_stopped(tag, prob, net, X0,
                        torch.zeros(X0.shape[0], device=dev), N, dt,
                        dict(kw, adaptive_forward=adaptive), worst, MASK_TOL)

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
    # K not a multiple of the tile, on a grid smaller than ceil(K / tile):
    # the lanes take the paths of their block's range as others stop
    X0 = sample_domain(gen, sin.geometry, K_ELL_REFILL, d)
    net = net_of((30, 30), 7)
    call = km._StoppedCall(sin, net, X0, torch.zeros(K_ELL_REFILL,
                                                     device=dev), N, dt,
                           4321, km._check_stopped_family(sin, net,
                                                          "erfinv"),
                           dict(adaptive_forward=True, rng="erfinv",
                                host_noise=None), None)
    packed = call.pack(backward=True)
    grid, tile = km._stopped_bwd_grid(packed, dev), packed.iargs[5]
    check(K_ELL_REFILL % tile and grid < -(-K_ELL_REFILL // tile),
          f"K={K_ELL_REFILL} on {grid} blocks of {tile} exercises the refill")
    compare(f"[Sin, DenseNet (30, 30), adaptive, K={K_ELL_REFILL} on "
            f"{grid} blocks, erfinv]", sin, net, True, X0,
            dict(seed=4321, rng="erfinv"))
    # a net too wide for the backward's stride tile + 4 even at tile 32:
    # its arrays at the forward's stride tile + 1
    X0 = sample_domain(gen, sin.geometry, Kc, d)
    net = net_of(WIDE_ELL, 8)
    call = km._StoppedCall(sin, net, X0, torch.zeros(Kc, device=dev), N, dt,
                           4321, km._check_stopped_family(sin, net,
                                                          "erfinv"),
                           dict(adaptive_forward=False, rng="erfinv",
                                host_noise=None), None)
    packed = call.pack(backward=True)
    ts, tile = km._stopped_bwd_ts(packed), packed.iargs[5]
    check(ts == tile + 1, f"DenseNet {WIDE_ELL}: the backward's stride {ts} "
          f"at tile {tile}")
    compare(f"[Sin, DenseNet {WIDE_ELL}, stride {ts}, erfinv]", sin, net,
            False, X0, dict(seed=4321, rng="erfinv"))

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
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with PlainCalls(km) as plain_calls:
        trainer.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fwd_launches, bwd_launches = counted(km.fused_stopped_train_rollout,
                                         "launches", "backward_launches")
    tail = float(np.mean(trainer.V_test_L2[-50:]))
    print(f"  {len(trainer.loss_log)} steps in {wall:.2f} s; kernel "
          f"launches: forward {fwd_launches}, backward {bwd_launches}; "
          f"plain-version calls {plain_calls.n}")
    print(f"  test L2 every 250: "
          f"{['%.3e' % v for v in trainer.V_test_L2[::250]]}; loss "
          f"{trainer.loss_log[0]:.4e} -> {trainer.loss_log[-1]:.4e}; "
          f"advancing path-steps per step {np.mean(trainer.K_log):.0f}; "
          f"tail-50 test L2 {tail:.4e} (bound {TEST_L2_BOUND:g})")
    warm = captured(trainer, L_ELL)
    check(fwd_launches == L_ELL + warm and bwd_launches == L_ELL + warm
          and plain_calls.n == 0, "the training path launched both "
          "stopped kernels every step (and in the warm-up step) and no "
          "plain version")
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
        b_bwd = stopped_bwd_roofline(adv, bwd_f, net,
                                     4 * (2 * n_par + Kb * (d + 1)))
        use = lane_use(call, probe, gY)
        print_lane_use(tag, use)
        fwd_use = fwd_lane_use(call, dev)
        print_fwd_lane_use(tag, fwd_use)
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
              f" ms (all FP32 {b_bwd['bound_ms_fp32']:.4f}; "
              f"{b_fwd['bound_by']}); step {r['step'][0]:.3f} ms -> "
              f"{Kb * N / r['step'][0] * 1e3:.4e} path-steps/s (K N per "
              f"step time)")
        times[tag] = (r, dict(b_fwd, layout=fwd_use["layout"]),
                      dict(b_bwd, lanes=use[0]), steppers["fused_train"])
    print(f"  card: {smi}")

    first = next(iter(NETS_ELL))
    profile_steps(f"3 solver steps, {first}, K={Kb}", times[first][3].step)

    print(f"  phases 10-12 took {time.perf_counter() - t_phases:.1f} s")
    r, b_fwd, b_bwd, _ = times[first]
    rn, bn_fwd, bn_bwd, _ = times[list(NETS_ELL)[1]]
    row = {"route": "cuda", "source": STOPPED_SOURCE}
    return [
        dict(row, name="fused_stopped_train_rollout.forward",
             replaces="pspde/rollout/kernels.py:1184", launches=fwd_launches,
             max_abs_err=worst["out"], ms=r["forward"][0],
             plain_ms=r["forward"][1], **b_fwd,
             ms_notebook=rn["forward"][0], plain_ms_notebook=rn["forward"][1],
             bound_ms_notebook=bn_fwd["bound_ms"],
             layout_notebook=bn_fwd["layout"]),
        dict(row, name="fused_stopped_train_rollout.backward",
             replaces="pspde/rollout/kernels.py:1272", launches=bwd_launches,
             max_abs_err=max(worst["grad"], worst["bwd"]),
             ms=r["backward"][0], plain_ms=r["backward"][1], **b_bwd,
             ms_notebook=rn["backward"][0],
             plain_ms_notebook=rn["backward"][1],
             bound_ms_notebook=bn_bwd["bound_ms"]),
    ]


def reset_counts(fn, *names):
    """Set a wrapper's launch counts (ints and per-plan dicts) to 0."""
    for name in names:
        val = getattr(fn, name)
        setattr(fn, name, dict.fromkeys(val, 0) if isinstance(val, dict)
                else 0)


def zero_counts():
    """Every launch count to 0: the wrappers' and the four training
    kernels' own words on the device."""
    from pspde_torch.rollout import kernels as km
    km.reset_launch_counts()


def counted(fn, *names):
    """The launches that the training kernels under wrapper ``fn`` counted
    on the device since ``zero_counts`` (km.kernel_launch_counts: each
    launch that ran, a CUDA graph's replays' too), for each count name: an
    int, or {plan: n} for a '_by_plan' name ({kernel: n} for a
    '_by_kernel' one); one value for one name."""
    from pspde_torch.rollout import kernels as km
    c = km.kernel_launch_counts()
    out = tuple({k[2]: v for k, v in c.items() if k[:2] == (fn.__name__,
                                                            name)}
                if name.endswith(("_by_plan", "_by_kernel"))
                else c[(fn.__name__, name)] for name in names)
    return out[0] if len(out) == 1 else out


def wide_phases(dev, smi, llgc, solver):
    """Phases 13-14: the device plan of the HJB-family kernels against
    their plain versions at d=1000 and against the shared plan at d=100,
    and BASELINE config 5 trained and served on the card.  Returns the
    kernels' JSON rows on the device plan and the config-5 solver."""
    import numpy as np
    from pspde_torch.ansatz import TanhMLP
    from pspde_torch.problems import LLGC
    from pspde_torch.rollout import kernels as km
    from pspde_torch.solvers import HJBSolver
    from pspde_torch.utils import cosine_decay_schedule

    t_phases = time.perf_counter()
    d, N, dt, Kc = D5, N5, DT5, K5_CHECK
    llgc5 = LLGC(d=d, T=T5, device=dev)
    trainer = HJBSolver("config5", llgc5,
                        lr=cosine_decay_schedule(1e-2, L5, alpha=1e-2),
                        L=STEPS5, K=K5, delta_t=dt, time_approx="inner",
                        loss_method="log-variance", detach_forward=True,
                        learn_Y_0=True, verbose=False,
                        early_stopping_time=None, seed=5,
                        rollout_mode="fused_train", fused_rng="binom",
                        device=dev)
    check(trainer.resolved_rollout_mode == "fused_train",
          f"engine {trainer.resolved_rollout_mode}")
    gen = torch.Generator(device=dev).manual_seed(13)
    net5 = TanhMLP(d + 1, d, init_scale=0.1, generator=gen, device=dev)
    u5 = trainer._u_tab
    worst = {"serve": 0.0, "out": 0.0, "grad": 0.0}

    # -- phase 13: the device plan against plain and against shared ---------
    print(f"phase 13: device plan, LLGC d={d}, T={T5}, N={N}, TanhMLP "
          f"[{d + 1},30,30,{d}], K={Kc}: kernels vs plain, outputs rel "
          f"{REL_TOL:g}; gradients: the backward on the same cotangents "
          f"{BWD_REL_TOL:g}, the loss gradients {GRAD_TOL:g} x max|plain|")
    reset_counts(km.fused_controlled_rollout, "launches_by_plan")
    noise = torch.randn((N, Kc, d), generator=gen, device=dev)
    for tag, kw in (("host noise", dict(host_noise=noise)),
                    ("Philox, sign +1", dict(seed=1234)),
                    ("Philox, sign -1", dict(seed=1234, noise_sign=-1.0))):
        kern = km.fused_controlled_rollout(llgc5, net5, Kc, N, dt, **kw)
        plain = km.reference_controlled_rollout(llgc5, net5, Kc, N, dt, **kw)
        worst["serve"] = max(worst["serve"], compare_serve(
            f"[serve d={d}, {tag}]", kern, plain))
    check(km.fused_controlled_rollout.launches_by_plan
          == {"shared": 0, "device": 3}, "serve d=1000 ran the device plan: "
          f"{km.fused_controlled_rollout.launches_by_plan}")
    reset_counts(km.fused_train_rollout, "launches_by_plan",
                 "backward_launches_by_plan")
    for tag, kw in (("host noise", dict(host_noise=noise)),
                    ("binom", dict(seed=4321, rng="binom")),
                    ("erfinv", dict(seed=4321, rng="erfinv"))):
        compare_train(f"[train d={d}, u_tab, {tag}]", llgc5, net5, Kc, N, dt,
                      dict(kw, u_tab=u5), worst)
    by_plan = (km.fused_train_rollout.launches_by_plan,
               km.fused_train_rollout.backward_launches_by_plan)
    # three forward launches; six backward, three of them on the plain
    # version's cotangents
    check(by_plan == ({"shared": 0, "device": 3}, {"shared": 0, "device": 6}),
          f"training d=1000 ran the device plan: {by_plan}")
    del noise

    print(f"  d={D}, K={K_CHECK}: the device plan forced against the shared "
          "plan (same tile 64)")
    u1 = llgc.u_ref_table(np.arange(N_TRAIN) * DT_TRAIN)
    plans = {}
    for plan in ("shared", "device"):
        o = km.fused_controlled_rollout(llgc, solver.z_net, K_CHECK, N_STEPS,
                                        DT_IS, seed=9, plan=plan)
        t_out = km.fused_train_rollout(llgc, solver.z_net, K_CHECK, N_TRAIN,
                                       DT_TRAIN, 9, u_tab=u1, plan=plan)
        g = torch.autograd.grad(train_loss(llgc, t_out, {}),
                                list(solver.z_net.parameters()))
        plans[plan] = (o, t_out, g)
    torch.cuda.synchronize()
    for i, what in enumerate(("serve outputs", "training outputs",
                              "training gradients")):
        pairs = list(zip(plans["shared"][i], plans["device"][i]))
        diff = max(float((a.detach() - b.detach()).abs().max())
                   for a, b in pairs)
        scale = max(float(a.detach().abs().max()) for a, _ in pairs)
        bitwise = all(torch.equal(a, b) for a, b in pairs)
        print(f"  {what}: max |shared - device| {diff:.3e} (bitwise "
              f"{bitwise})")
        check(diff <= (GRAD_TOL if i == 2 else REL_TOL) * (1.0 + scale),
              f"device vs shared plan, {what}: {diff:.3e}")
        check(bitwise or i > 0, f"device vs shared plan, {what} bitwise")

    # the training kernels' plain times: at the check shape (the plain
    # backward at K5 would need 79 GB)
    kw = dict(u_tab=u5, rng="binom")
    call = train_call(llgc5, net5, Kc, N, dt, dict(kw, seed=17))
    gY = torch.randn(Kc, generator=gen, device=dev)
    gKL = torch.zeros(Kc, device=dev)

    def no_grad(fn):
        def run():
            with torch.no_grad():
                fn()
        return run

    pairs = {
        "forward":(no_grad(lambda: km.fused_train_rollout(
                        llgc5, net5, Kc, N, dt, 17, **kw)),
                    no_grad(lambda: km.reference_train_rollout(
                        llgc5, net5, Kc, N, dt, 17, **kw))),
        "backward": (lambda: km._train_backward_kernel(call, gY, gKL),
                     lambda: km._reference_train_backward(call, gY, gKL)),
    }
    times = {}
    for name, (kern_fn, plain_fn) in pairs.items():
        p1 = timed(plain_fn, 1)
        k = [timed(kern_fn, 2), timed(kern_fn, 2)]
        p2 = timed(plain_fn, 1)
        times[name] = (min(k), min(p1, p2))
        print(f"  {name:8s} d={d} K={Kc} kernel {k[0]:.3f}, {k[1]:.3f} ms; "
              f"plain {p1:.3f}, {p2:.3f} ms")

    # -- phase 14: BASELINE config 5 on the card ----------------------------
    print(f"phase 14: config 5, HJBSolver(LLGC(d={d}, T={T5}), delta_t={dt}, "
          f"K={K5}, 'inner', log-variance, detach_forward, learn_Y_0, "
          f"fused_train, binom, lr cosine_decay_schedule(1e-2, {L5}, "
          f"alpha=1e-2)), {STEPS5} steps")
    reset_counts(km.fused_train_rollout, "launches", "backward_launches",
                 "launches_by_plan", "backward_launches_by_plan")
    reset_counts(km.fused_controlled_rollout, "launches", "launches_by_plan")
    step_ms = [timed(trainer.step, 1, warm=False) for _ in range(STEPS5)]
    print(f"  steps {['%.1f' % t for t in step_ms]} ms -> "
          f"{K5 * N / min(step_ms) * 1e3:.4e} path-steps/s; loss "
          f"{['%.4e' % v for v in trainer.loss_log]}; u_L2 "
          f"{['%.3f' % v for v in trainer.u_L2_loss]}")
    # the serve entry point with the trained control: log E of the d=1000
    # chain is 1/2 d dt sum_{j<N} (1 - dt)^{2j}; a control trained for a
    # few steps leaves a wide estimator, so only finiteness is checked
    out = km.fused_controlled_rollout(llgc5, trainer.z_net, K5_SERVE, N, dt,
                                      seed=2026)
    logw = -out.f_int - llgc5.g(out.X) - out.ito - 0.5 * out.riemann
    log_mean = float(torch.logsumexp(logw, 0)) - math.log(K5_SERVE)
    print(f"  serve, K={K5_SERVE}: log mean {log_mean:.3f} (exact "
          f"{LOG_E5_EXACT})")
    launches = {"serve": dict(km.fused_controlled_rollout.launches_by_plan),
                "forward": dict(km.fused_train_rollout.launches_by_plan),
                "backward": dict(
                    km.fused_train_rollout.backward_launches_by_plan)}
    print(f"  launches by plan: {launches}")
    check(all(math.isfinite(v) for v in trainer.loss_log), "finite losses")
    check(math.isfinite(log_mean), f"serve log mean {log_mean}")
    check(launches["forward"] == launches["backward"]
          == {"shared": 0, "device": STEPS5}
          and launches["serve"] == {"shared": 0, "device": 1},
          "config 5 ran every launch on the device plan")

    u_tab5 = trainer._u_tab
    fwd_ms = [timed(no_grad(lambda: km.fused_train_rollout(
        llgc5, trainer.z_net, K5, N, dt, 3, u_tab=u_tab5)), 1)
        for _ in range(2)]
    call5 = train_call(llgc5, trainer.z_net, K5, N, dt,
                       dict(seed=3, u_tab=u_tab5, rng="binom"))
    gY5 = torch.randn(K5, generator=gen, device=dev) / K5
    bwd_ms = timed(lambda: km._train_backward_kernel(
        call5, gY5, torch.zeros_like(gY5)), 1, warm=False)
    print(f"  K={K5}: forward kernel {['%.1f' % t for t in fwd_ms]} ms, "
          f"backward kernel {bwd_ms:.1f} ms, step {min(step_ms):.1f} ms")
    occ5 = km._train_fwd_occupancy(call5.pack(False), dev)
    print(f"  forward launch at config 5 (the occupancy API's theoretical "
          f"residency from registers and shared memory, not a "
          f"measurement): {occ5}")

    def serve5():
        return km.fused_controlled_rollout(llgc5, trainer.z_net, K5_SERVE, N,
                                           dt, seed=5)

    def plain_serve5():
        return km.reference_controlled_rollout(llgc5, trainer.z_net,
                                               K5_SERVE, N, dt, seed=5)

    with torch.no_grad():
        p1 = timed(plain_serve5, 1)
        k = [timed(serve5, 2), timed(serve5, 2)]
        p2 = timed(plain_serve5, 1)
    serve_ms = (min(k), min(p1, p2))
    print(f"  serve K={K5_SERVE}: kernel {k[0]:.3f}, {k[1]:.3f} ms; plain "
          f"{p1:.3f}, {p2:.3f} ms; launch (the occupancy API's): "
          f"{serve_occupancy(llgc5, trainer.z_net, K5_SERVE, dev)}")
    profile_steps(f"1 config-5 step, K={K5}", trainer.step, n=1)
    del call5
    torch.cuda.empty_cache()
    plain = HJBSolver("config5_plain", llgc5, lr=1e-2, L=1, K=K5_PLAIN,
                      delta_t=dt, time_approx="inner",
                      loss_method="log-variance", detach_forward=True,
                      learn_Y_0=True, verbose=False,
                      early_stopping_time=None, seed=5, rollout_mode="scan",
                      device=dev)
    # after one warm-up step each: the plain step's first call takes ~10x
    # its steady time
    p_ms = timed(plain.step, 1)
    fused_small = HJBSolver("config5_small", llgc5, lr=1e-2, L=1, K=K5_PLAIN,
                            delta_t=dt, time_approx="inner",
                            loss_method="log-variance", detach_forward=True,
                            learn_Y_0=True, verbose=False,
                            early_stopping_time=None, seed=5,
                            rollout_mode="fused_train", fused_rng="binom",
                            device=dev)
    f_ms = timed(fused_small.step, 1)
    print(f"  K={K5_PLAIN}: plain (scan) step {p_ms:.1f} ms, fused step "
          f"{f_ms:.1f} ms; card: {smi}")
    print(f"  phases 13-14 took {time.perf_counter() - t_phases:.1f} s")

    # the rows: the kernels' times at the main path's shapes (phase 14),
    # the plain versions' where they can run (the training kernels' at the
    # check shape, phase 13)
    n_par = sum(p.numel() for p in trainer.z_net.parameters())
    widths = [d + 1, 30, 30, d]
    fwd_f, bwd_f = train_flops(widths, n_par)
    steps = K5 * N
    row = {"route": "cuda", "source": TRAIN_SOURCE,
           "shape": f"d={d}, K={K5}, N={N}",
           "plain_shape": f"d={d}, K={Kc}, N={N}"}
    return trainer, [
        dict(row, name="fused_controlled_rollout.device_plan_d1000",
             source=SERVE_SOURCE, replaces="pspde/rollout/kernels.py:339",
             shape=f"d={d}, K={K5_SERVE}, N={N}",
             plain_shape=f"d={d}, K={K5_SERVE}, N={N}",
             launches=launches["serve"]["device"],
             max_abs_err=worst["serve"], ms=serve_ms[0],
             plain_ms=serve_ms[1],
             **serve_roofline(K5_SERVE * N, widths, n_par, K5_SERVE)),
        dict(row, name="fused_train_rollout.forward.device_plan_d1000",
             replaces="pspde/rollout/kernels.py:696",
             launches=launches["forward"]["device"],
             max_abs_err=worst["out"], ms=min(fwd_ms),
             plain_ms=times["forward"][1],
             **train_fwd_roofline(steps, fwd_f, widths,
                                  4 * (n_par + N * d + K5 * (d + 3)))),
        dict(row, name="fused_train_rollout.backward.device_plan_d1000",
             replaces="pspde/rollout/kernels.py:788",
             launches=launches["backward"]["device"],
             max_abs_err=worst["grad"], max_rel_err=worst["grad_rel"],
             ms=bwd_ms,
             plain_ms=times["backward"][1],
             **train_bwd_roofline(steps, bwd_f, n_par, widths,
                                  4 * (2 * n_par + N * d + 2 * K5))),
    ]


def roofline_phases(dev, smi, llgc, solver, config5):
    """Phase 15: the roofline kernels against their plain versions at the
    main path's shapes, then the measured rates, the roofline model and the
    ablation ladders at the bench shape (``solver``: LLGC d=100, N=32, the
    exported control) and at config 5 (``config5``).  Returns the kernels'
    JSON rows."""
    from pspde_torch.utils import roofline as rf

    t_phases = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(15)
    llgc5 = config5.problem
    print("phase 15: the roofline kernels vs plain; the FMA and normals "
          "rates; the roofline model; the ablation ladders")

    # fma_chain: 4 links against plain (the map is chaotic, so no longer
    # chain can be compared), then at the main path's size the time at 2P
    # passes over the time at P, and the map's invariant interval
    x0 = 0.3 + 0.01 * torch.randn((D, FMA_TILE), generator=gen, device=dev)
    fma_err = 0.0
    for P, chain in ((1, 4), (4, 1)):
        y = rf.fma_chain(x0.clone(), P, chain)
        err = float((y - rf.reference_fma_chain(x0.clone(), P, chain))
                    .abs().max())
        fma_err = max(fma_err, err)
        print(f"  fma_chain P={P}, chain {chain}: max |kernel - plain| "
              f"{err:.3e} (bound {FMA_TOL:g})")
        check(err <= FMA_TOL, f"fma_chain P={P}, chain {chain}: {err:.3e}")
    x = torch.full((D, FMA_TILE), 0.3, device=dev)
    t_fma = [timed(lambda: rf.fma_chain(x, rf.FMA_P, 16), 5)
             for _ in range(2)]
    t_fma2 = timed(lambda: rf.fma_chain(x, 2 * rf.FMA_P, 16), 5)
    ratio = t_fma2 / min(t_fma)
    x_max = float(x.abs().max())
    print(f"  fma_chain chain 16: P={rf.FMA_P} {t_fma} ms, P={2 * rf.FMA_P} "
          f"{t_fma2:.4f} ms (ratio {ratio:.4f}, bounds {PASS_RATIO}); max "
          f"|x| {x_max:.4f} <= 1.92")
    check(PASS_RATIO[0] <= ratio <= PASS_RATIO[1],
          f"fma_chain 2P / P time ratio {ratio:.4f}")
    check(bool(torch.isfinite(x).all()) and x_max <= 1.92,
          f"fma_chain left the invariant interval: {x_max}")
    p_fma = timed(lambda: rf.reference_fma_chain(x, rf.FMA_P, 16), 1,
                  warm=False)

    # normals_sum at the main path's shape, both maps
    normals_err, t_nrm, p_nrm = 0.0, {}, {}
    for rng in ("erfinv", "binom"):
        def kern():
            return rf.normals_sum(7, D, FMA_TILE, rf.NORMALS_P, rng, dev)
        t_nrm[rng] = [timed(kern, 5) for _ in range(2)]
        p_nrm[rng], b = timed_out(lambda: rf.reference_normals_sum(
            7, D, FMA_TILE, rf.NORMALS_P, rng, dev))
        normals_err = max(normals_err, compare_rel(
            f"normals_sum {rng}, P={rf.NORMALS_P}", kern(), b))
        print(f"    kernel {t_nrm[rng]} ms, plain {p_nrm[rng]:.1f} ms")

    # every ladder stage on both plans: the shared plan at d=100, K=8192,
    # N=32, the device plan at config 5's width (d=1000, K=2048, N=200);
    # then `full` at the bench shape, timed.  The noise stage at d=1000
    # sums 2e5 normals into one float32 per path (|acc| ~ 1.7e3, ulp
    # 1.2e-4) where the plain version sums each step's 1000 first, so it
    # reads ~2e-5 relative, the most of any stage.
    ladder_err = 0.0
    for tag, prob, net, K, N, dt, plan in (
            (f"d={D}, K={K_TRAIN_CHECK}, N={N_TRAIN}", llgc, solver.z_net,
             K_TRAIN_CHECK, N_TRAIN, DT_TRAIN, "shared"),
            (f"d={D5}, K={K5_CHECK}, N={N5}", llgc5, config5.z_net,
             K5_CHECK, N5, DT5, "device")):
        reset_counts(rf.ablation, "launches_by_plan")
        for stage in rf.ABLATION_STAGES:
            a = rf.ablation(stage, prob, net, K, N, dt, seed=11)
            b = rf.reference_ablation(stage, prob, net, K, N, dt, seed=11)
            ladder_err = max(ladder_err, compare_rel(
                f"ablation {stage:12s} {tag}", a, b))
        by_plan = rf.ablation.launches_by_plan
        check(by_plan[plan] == len(rf.ABLATION_STAGES),
              f"ablation {tag} ran the {plan} plan: {by_plan}")

    def full():
        return rf.ablation("full", llgc, solver.z_net, K_BENCH, N_TRAIN,
                           DT_TRAIN)

    t_lad = [timed(full, 5) for _ in range(2)]
    p_lad, b = timed_out(lambda: rf.reference_ablation(
        "full", llgc, solver.z_net, K_BENCH, N_TRAIN, DT_TRAIN))
    ladder_err = max(ladder_err, compare_rel(
        f"ablation full, d={D}, K={K_BENCH}, N={N_TRAIN}", full(), b))
    print(f"  fma_chain P={rf.FMA_P}: kernel {t_fma} ms, plain {p_fma:.1f} "
          f"ms; ablation full K={K_BENCH}: kernel {t_lad} ms, plain "
          f"{p_lad:.1f} ms")

    # the main path: the rates, the model, the ladders
    for fn in (rf.fma_chain, rf.normals_sum):
        reset_counts(fn, "launches")
    reset_counts(rf.ablation, "launches", "launches_by_plan")
    fma_rate = rf.vpu_fma_rate(P=rf.FMA_P, device=dev)
    print(f"  vpu_fma_rate(P={rf.FMA_P}): {fma_rate:.6e} flop/s "
          f"({100 * fma_rate / PEAK_FLOPS:.1f}% of the data sheet's "
          f"{PEAK_FLOPS:.3g}); card: {smi}")
    normals = {rng: rf.prng_normals_rate(P=rf.NORMALS_P, rng=rng, device=dev)
               for rng in ("erfinv", "binom")}
    for rng, r in normals.items():
        print(f"  prng_normals_rate(P={rf.NORMALS_P}, rng={rng!r}): {r:.6e} "
              f"normals/s; card: {smi}")
    for tag, prob, s in (("d=100, N=32", llgc, solver),
                         ("config 5, d=1000, N=200", llgc5, config5)):
        for rng in ("binom", "erfinv"):
            m = rf.fused_train_vpu_roofline(prob, s, fma_rate=fma_rate,
                                            normals_rate=normals[rng])
            print(f"  roofline model, {tag}, {rng}: "
                  f"{m['roofline_path_steps_per_sec']:.4e} path-steps/s "
                  f"(normals {m['normals_per_path_step']:.0f}, elem "
                  f"{m['elem_ops_per_path_step']:.0f}, mm "
                  f"{m['mm_flops_per_path_step']:.0f} FLOP, sfu "
                  f"{m['sfu_per_path_step']:.0f} per path-step; unknown "
                  f"{m['unknown_prims']})")
            check(not m["unknown_prims"], "every traced op counted")
    for tag, prob, s, K, reps in (
            (f"d={D}, K={K_BENCH}, N={N_TRAIN}", llgc, solver, K_BENCH, 10),
            (f"config 5, d={D5}, K={K5}, N={N5}", llgc5, config5, K5, 1)):
        t0 = time.perf_counter()
        lad = rf.fused_ablation_rates(prob, s, K=K, reps=reps)
        print(f"  ablation ladder, {tag} ({time.perf_counter() - t0:.1f} s):")
        for stage, r in lad.items():
            print(f"    {stage:12s} {r:.4e} path-steps/s, "
                  f"{K * s.N / r * 1e3:.3f} ms per launch")
        print(f"    noise / 2 (the training step's replay ceiling): "
              f"{lad['noise'] / 2:.4e}; card: {smi}")
    launches = {"fma_chain": rf.fma_chain.launches,
                "normals_sum": rf.normals_sum.launches,
                "ablation": rf.ablation.launches}
    by_plan = dict(rf.ablation.launches_by_plan)
    print(f"  launches on the main path: {launches}; ablation by plan "
          f"{by_plan}")
    check(all(n > 0 for n in launches.values())
          and all(n > 0 for n in by_plan.values()),
          "the main path launched every roofline kernel, the ladder on "
          "both plans")
    print(f"  phase 15 took {time.perf_counter() - t_phases:.1f} s")

    n_fma = D * FMA_TILE
    n_normals = D * FMA_TILE * rf.NORMALS_P
    # Philox4x32-10: 10 rounds of 2 mul.lo and 2 mul.hi per 4 words, one
    # block per 4 erfinv draws: 10 integer multiplies per normal.  Every
    # instruction takes an issue slot too (4 warp-instructions a clock per
    # SM): the bound is the larger of the two, with the instructions a
    # normal of the function's own arithmetic in the kernel's SASS
    # (NORMALS_WORK); the whole loop's, control included, is printed beside
    from pspde_torch.rollout import _build
    per_normal, issued, path = normals_instructions(
        _build.build_info["path"])
    t_int = 10 * n_normals / INT_MUL_RATE
    t_instr = per_normal * n_normals / INSTR_RATE
    t_issued = issued * n_normals / INSTR_RATE
    print(f"  normals_sum bound: integer multiplies {1e3 * t_int:.4f} ms, "
          f"the function's arithmetic {1e3 * t_instr:.4f} ms ({per_normal:.2f} "
          f"instructions a normal), the whole loop {1e3 * t_issued:.4f} ms "
          f"({issued:.2f} a normal, control included); the loop's common "
          f"path in its SASS: {path}; kernel {min(t_nrm['erfinv']):.4f} ms")
    check(10 <= per_normal <= issued <= 400, f"normals_sum's loop: "
          f"{per_normal} of {issued} instructions a normal")
    n_par = sum(p.numel() for p in solver.z_net.parameters())
    return [
        {"name": "fma_chain", "route": "cuda", "source": ROOFLINE_SOURCE,
         "replaces": "pspde/utils/roofline.py:112",
         "launches": launches["fma_chain"], "max_abs_err": fma_err,
         "ms": min(t_fma), "plain_ms": p_fma,
         **roofline(2.0 * n_fma * 16 * rf.FMA_P, 8 * n_fma)},
        {"name": "normals_sum", "route": "cuda", "source": ROOFLINE_SOURCE,
         "replaces": "pspde/utils/roofline.py:138",
         "launches": launches["normals_sum"], "max_abs_err": normals_err,
         "ms": min(t_nrm["erfinv"]), "plain_ms": p_nrm["erfinv"],
         "bound_ms": 1e3 * max(t_int, t_instr, 4 * FMA_TILE / PEAK_BYTES),
         "bound_by": "operations", "library_ms": None,
         "bound_ms_int_mul": 1e3 * t_int,
         "bound_ms_instructions": 1e3 * t_instr,
         "instructions_per_normal": per_normal,
         "issue_ms_whole_loop": 1e3 * t_issued,
         "issued_per_normal": issued},
        {"name": "ablation", "route": "cuda", "source": ROOFLINE_SOURCE,
         "replaces": "pspde/utils/roofline.py:327",
         "launches": launches["ablation"], "max_abs_err": ladder_err,
         "ms": min(t_lad), "plain_ms": p_lad,
         **tf32_roofline(
             K_BENCH * N_TRAIN * (mlp_flops([D + 1, 30, 30, D]) + 13 * D),
             K_BENCH * N_TRAIN * net_products([D + 1, 30, 30, D]),
             4 * (n_par + K_BENCH))},
    ]


def general_phases(dev, smi):
    """Phases 16-19: the time_stopping branch of the stopped kernels
    against its plain version at the main path's shape and at the heat
    shape, the GeneralSolver main path, its convergence leg and BASELINE
    config 2.  Returns the kernels' JSON rows and config 2's solver, which
    phase 38 refines."""
    import numpy as np
    from pspde_torch.ansatz import DenseNet
    from pspde_torch.ansatz import TanhMLP
    from pspde_torch.problems import (ExponentialOnSphereNonlinearParabolic,
                                      Geometry, HeatEquation)
    from pspde_torch.rollout import kernels as km
    from pspde_torch.rollout.sampling import sample_domain
    from pspde_torch.solvers import GeneralSolver
    from pspde_torch.utils import cosine_decay_schedule

    t_phases = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(16)
    ball = ExponentialOnSphereNonlinearParabolic(d=D_GEN, device=dev)
    heat = HeatEquation(d=D_HEAT, T=T_HEAT, device=dev)
    # the diffusion spread sqrt(tr(2 I) T) = 4.5 leaves the default sampling
    # radius 1: config 2 widens it
    heat.geometry = Geometry(kind="unbounded", boundary_distance=R_HEAT)
    shapes = {
        "gen50": (ball, D_GEN, K_GEN, N_GEN, DT_GEN, MASK_TOL, ()),
        "heat": (heat, D_HEAT, K_HEAT, N_HEAT, DT_HEAT, 0.0,
                 ("layers.2.bias",)),
    }

    def net_of(d, seed):
        return DenseNet(1, (30, 30), d_in=d + 1, device=dev,
                        generator=torch.Generator(dev).manual_seed(seed))

    def starts(prob, K, d):
        X0 = sample_domain(gen, prob.geometry, K, d)
        return X0, torch.rand(K, generator=gen, device=dev) * prob.T

    # -- phase 16: kernels vs plain ------------------------------------------
    print(f"phase 16: time_stopping kernels vs plain, DenseNet (30, 30) on "
          f"[X, t]: gen50 (the unit ball, d={D_GEN}, K={K_GEN}, N={N_GEN}, "
          f"dt={DT_GEN}, T=1) and heat (the whole space, d={D_HEAT}, "
          f"K={K_HEAT}, N={N_HEAT}, dt={DT_HEAT}, T={T_HEAT}); outputs rel "
          f"{REL_TOL:g} and equal clocks on agreeing paths, exit-step "
          f"disagreements <= {MASK_TOL:g} K (gen50) and none (heat), "
          f"gradients {GRAD_TOL:g} x max|plain|")
    worst = {tag: {"out": 0.0, "grad": 0.0, "bwd": 0.0} for tag in shapes}
    for tag, (prob, d, K, N, dt, mask_tol, zero) in shapes.items():
        for adaptive in (False, True):
            net = net_of(d, 1 + adaptive)
            X0, t0 = starts(prob, K, d)
            noise = torch.randn((N, K, d), generator=gen, device=dev)
            for what, kw in (("host noise", dict(host_noise=noise)),
                             ("erfinv", dict(seed=4321, rng="erfinv")),
                             ("binom", dict(seed=4321, rng="binom"))):
                compare_stopped(
                    f"[{tag}{', adaptive' if adaptive else ''}, {what}]",
                    prob, net, X0, t0, N, dt,
                    dict(kw, adaptive_forward=adaptive), worst[tag],
                    mask_tol, time_stopping=True, zero_leaves=zero)
            del noise

    # -- phase 17: the main path ---------------------------------------------
    print(f"phase 17: GeneralSolver(ExponentialOnSphereNonlinearParabolic("
          f"d={D_GEN}), loss_method='diffusion', K={K_GEN}, N={N_GEN}, "
          f"delta_t={DT_GEN}, lr=1e-3, rollout_mode='fused_train'), "
          f"{STEPS_GEN} steps")
    solvers = {mode: GeneralSolver(
        ball, f"gen50-{mode}", loss_method="diffusion", K=K_GEN, N=N_GEN,
        delta_t=DT_GEN, lr=1e-3, L=STEPS_GEN, verbose=False,
        rollout_mode=mode, device=dev) for mode in ("fused_train", "scan")}
    main = solvers["fused_train"]
    check(main.resolved_rollout_mode == "fused_train"
          and main.V_net.d_in == D_GEN + 1 and main.V_net.arch == (30, 30),
          f"engine {main.resolved_rollout_mode}, net {main.V_net.d_in} -> "
          f"{main.V_net.arch}")
    try:
        GeneralSolver(ball, "tanh", K=64, rollout_mode="fused_train",
                      value_net=TanhMLP(D_GEN + 1, 1, device=dev),
                      verbose=False, device=dev)
        raised = ""
    except ValueError as e:
        raised = str(e)
    check("STOPPED_KERNEL_FAMILY" in raised, "a TanhMLP value net on "
          "fused_train raises a ValueError naming the family (got "
          f"{raised[:80]!r})")
    # count the plain versions' calls during the main path: none may run
    reset_counts(km.fused_stopped_train_rollout, "launches",
                 "backward_launches")
    with PlainCalls(km) as plain_calls:
        step_ms = [timed(main.step, 1, warm=False) for _ in range(STEPS_GEN)]
    launches = (km.fused_stopped_train_rollout.launches,
                km.fused_stopped_train_rollout.backward_launches)
    print(f"  steps {['%.2f' % t for t in step_ms]} ms; launches forward "
          f"{launches[0]}, backward {launches[1]}; plain-version calls "
          f"{plain_calls.n}; loss {['%.4e' % v for v in main.loss_log]}; "
          f"advancing path-steps per step {np.mean(main.K_log):.0f} of "
          f"K N = {K_GEN * N_GEN}")
    check(launches == (STEPS_GEN, STEPS_GEN) and plain_calls.n == 0,
          "one forward and one backward launch per step, no plain call")
    check(all(math.isfinite(v) for v in main.loss_log), "finite losses")
    check(all(math.isnan(v) for v in main.V_L2_log),
          "V_L2 reads NaN without an in-kernel reference")

    # timing: the step against the scan engine's, the kernels against
    # their plain versions, at both shapes
    times = {}
    for tag, (prob, d, K, N, dt, _, _) in shapes.items():
        net = net_of(d, 5)
        X0, t0 = starts(prob, K, d)
        gY = torch.randn(K, generator=gen, device=dev) / K
        call = km._StoppedCall(
            prob, net, X0, t0, N, dt, 17,
            km._check_stopped_family(prob, net, "erfinv",
                                     time_stopping=True),
            dict(adaptive_forward=False, rng="erfinv", host_noise=None,
                 time_stopping=True), None)
        probe = km._stopped_forward_kernel(call)
        hit, adv = float(probe.hitting.sum()), float(probe.adv_steps.sum())
        n_par = sum(p.numel() for p in net.parameters())
        v_f, fwd_f, bwd_f = stopped_flops(net, d, adaptive=False)
        b_fwd = roofline((hit - adv) * v_f + adv * fwd_f,
                         4 * (n_par + K * (2 * d + 7)))
        b_bwd = stopped_bwd_roofline(adv, bwd_f, net,
                                     4 * (2 * n_par + K * (d + 2)))
        use = lane_use(call, probe, gY)
        print_lane_use(tag, use)
        fwd_use = fwd_lane_use(call, dev)
        print_fwd_lane_use(tag, fwd_use)

        def plain_fwd():
            with torch.no_grad():
                call.plain()

        r = {}
        for name, kern_fn, plain_fn, reps in (
                ("forward", lambda: km._stopped_forward_kernel(call),
                 plain_fwd, 10),
                ("backward", lambda: km._stopped_backward_kernel(call, gY),
                 lambda: km._reference_stopped_backward(call, gY), 5)):
            p1 = timed(plain_fn, 1)
            k = [timed(kern_fn, reps), timed(kern_fn, reps)]
            p2 = timed(plain_fn, 1)
            r[name] = (min(k), min(p1, p2))
            print(f"  {tag:6s} {name:8s} kernel {k[0]:.3f}, {k[1]:.3f} ms; "
                  f"plain {p1:.3f}, {p2:.3f} ms")
        print(f"  {tag}: {hit:.0f} active and {adv:.0f} advancing "
              f"path-steps of K N = {K * N}; bound forward "
              f"{b_fwd['bound_ms']:.4f} ms, backward "
              f"{b_bwd['bound_ms']:.4f} ms (all FP32 "
              f"{b_bwd['bound_ms_fp32']:.4f}; {b_fwd['bound_by']})")
        times[tag] = (r, dict(b_fwd, layout=fwd_use["layout"]),
                      dict(b_bwd, lanes=use[0]))
    p1 = timed(solvers["scan"].step, 1)
    k = [timed(main.step, 5), timed(main.step, 5)]
    p2 = timed(solvers["scan"].step, 1)
    print(f"  gen50 step: fused_train {k[0]:.3f}, {k[1]:.3f} ms -> "
          f"{K_GEN * N_GEN / min(k) * 1e3:.4e} path-steps/s (K N per step "
          f"time); scan {p1:.3f}, {p2:.3f} ms; card: {smi}")
    profile_steps(f"3 GeneralSolver steps, K={K_GEN}", main.step)
    del solvers

    # -- phase 18: convergence -----------------------------------------------
    print(f"phase 18: GeneralSolver(rollout_mode='fused_train').train(), the "
          f"same recipe at K={K_GEN_TRAIN}, all {L_GEN} iterations, "
          f"K_test_log=4096")
    trainer = GeneralSolver(ball, "gen50-conv", loss_method="diffusion",
                            K=K_GEN_TRAIN, N=N_GEN, delta_t=DT_GEN, lr=1e-3,
                            L=L_GEN, K_test_log=4096, verbose=False,
                            rollout_mode="fused_train", device=dev)
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with PlainCalls(km) as plain_calls:
        trainer.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    conv_launches = counted(km.fused_stopped_train_rollout, "launches",
                            "backward_launches")
    tail = float(np.mean(trainer.V_test_L2[-50:]))
    print(f"  {len(trainer.loss_log)} steps in {wall:.2f} s; kernel launches "
          f"{conv_launches}; plain-version calls {plain_calls.n}; test L2 "
          f"every 250: "
          f"{['%.3e' % v for v in trainer.V_test_L2[::250]]}; loss "
          f"{trainer.loss_log[0]:.4e} -> {trainer.loss_log[-1]:.4e}; "
          f"tail-50 test L2 {tail:.4e} (bound {TEST_L2_BOUND_GEN:g})")
    warm = captured(trainer, L_GEN)
    check(conv_launches == (L_GEN + warm, L_GEN + warm)
          and plain_calls.n == 0,
          "the training path launched both kernels every step (and in the "
          "warm-up step) and no plain version")
    check(all(math.isfinite(v) for v in trainer.loss_log), "finite losses")
    check(tail <= TEST_L2_BOUND_GEN, f"tail-50 test L2 {tail:.4e}")

    # -- phase 19: BASELINE config 2 -----------------------------------------
    print(f"phase 19: config 2, GeneralSolver(HeatEquation(d={D_HEAT}, "
          f"T={T_HEAT}), boundary_distance {R_HEAT}, delta_t={DT_HEAT}, "
          f"N={N_HEAT}, K={K_HEAT}, K_boundary={KB_HEAT}, diffusion, lr "
          f"cosine_decay_schedule(1e-2, {L_HEAT}, alpha=3e-4), "
          f"K_test_log=16384, fused_train), {STEPS_HEAT} steps")
    sched = cosine_decay_schedule(1e-2, L_HEAT, alpha=3e-4)
    config2 = GeneralSolver(heat, "config2", seed=2, L=L_HEAT, lr=sched,
                            delta_t=DT_HEAT, N=N_HEAT, K=K_HEAT,
                            K_boundary=KB_HEAT, K_test_log=16384,
                            loss_method="diffusion", verbose=False,
                            rollout_mode="fused_train", device=dev)
    reset_counts(km.fused_stopped_train_rollout, "launches",
                 "backward_launches")
    heat_ms = [timed(config2.step, 1, warm=False) for _ in range(STEPS_HEAT)]
    heat_launches = (km.fused_stopped_train_rollout.launches,
                     km.fused_stopped_train_rollout.backward_launches)
    lr_now = config2.optimizer.param_groups[0]["lr"]
    print(f"  steps {['%.2f' % t for t in heat_ms]} ms -> "
          f"{np.mean(config2.K_log) / min(heat_ms) * 1e3:.4e} advancing "
          f"path-steps/s ({np.mean(config2.K_log):.0f} of K N = "
          f"{K_HEAT * N_HEAT} per step); loss "
          f"{['%.4e' % v for v in config2.loss_log]}; test L2 "
          f"{['%.3e' % v for v in config2.V_test_L2]}; lr {lr_now:.6e}; "
          f"launches {heat_launches}; card: {smi}")
    check(heat_launches == (STEPS_HEAT, STEPS_HEAT),
          "config 2 launched both kernels every step")
    check(all(math.isfinite(v) for v in config2.loss_log + config2.V_test_L2),
          "finite losses and test errors")
    check(lr_now == sched(STEPS_HEAT - 1) and lr_now < 1e-2,
          f"the last update ran at the schedule's lr ({lr_now})")
    print(f"  phases 16-19 took {time.perf_counter() - t_phases:.1f} s")

    rows = []
    for tag, (prob, d, K, N, dt, _, _) in shapes.items():
        r, b_fwd, b_bwd = times[tag]
        n_launch = launches if tag == "gen50" else heat_launches
        row = {"route": "cuda", "source": STOPPED_SOURCE,
               "shape": f"{type(prob).__name__}, d={d}, K={K}, N={N}"}
        rows += [
            dict(row, name=f"fused_stopped_train_rollout.forward."
                 f"time_stopping.{tag}",
                 replaces="pspde/rollout/kernels.py:1184",
                 launches=n_launch[0], max_abs_err=worst[tag]["out"],
                 ms=r["forward"][0], plain_ms=r["forward"][1], **b_fwd),
            dict(row, name=f"fused_stopped_train_rollout.backward."
                 f"time_stopping.{tag}",
                 replaces="pspde/rollout/kernels.py:1272",
                 launches=n_launch[1],
                 max_abs_err=max(worst[tag]["grad"], worst[tag]["bwd"]),
                 ms=r["backward"][0], plain_ms=r["backward"][1], **b_bwd),
        ]
    return rows, config2


def compare_eigen(tag, prob, net, X0, N, dt, kw, worst, lam_value=LAM_EIG):
    """The square's families of the stopped kernels (the torus, the
    Schroedinger family) against their plain version from X0 with the
    lambda leaf at ``lam_value``: outputs on the paths whose exit
    step agrees (at most MASK_TOL K differ); the diffusion-loss gradients
    of every leaf through both, within GRAD_TOL of the leaf's largest entry,
    lambda's nonzero; and the backward kernel against the plain backward on
    the plain outputs' cotangents (zero on the paths whose exit step
    differs, where the two replays part), within BWD_REL_TOL of each net
    leaf's largest entry and, for the scalar lambda = sum -gY adv V dt, of
    the sum of its terms' sizes sum_k |gY_k S_k|, S = Y(0) - Y(1) (a sum
    over paths of both signs cancels far below its terms).  Updates
    ``worst`` ("out", "grad", "bwd": largest absolute differences)."""
    from pspde_torch.rollout import kernels as km
    K = X0.shape[0]
    t0 = torch.zeros(K, device=X0.device)
    lam = torch.full((1,), lam_value, device=X0.device, requires_grad=True)
    leaves = list(net.parameters()) + [lam]
    names = [n for n, _ in net.named_parameters()] + ["lambda"]

    def V(X):
        return net(X)[:, 0]

    def loss(out):
        return torch.mean((V(out.X) - V(X0) - out.Y) ** 2)

    fam = km._check_stopped_family(prob, net, kw.get("rng", "erfinv"),
                                   lam=lam)
    call = km._StoppedCall(
        prob, net, X0, t0, N, dt, kw.get("seed", 0), fam,
        dict(adaptive_forward=kw.get("adaptive_forward", False),
             rng=kw.get("rng", "erfinv"), host_noise=kw.get("host_noise"),
             time_stopping=False), None, lam)
    kern = km.fused_stopped_train_rollout(prob, net, X0, t0, N, dt, lam=lam,
                                          **kw)
    g_kern = torch.autograd.grad(loss(kern), leaves)
    layouts = check_fwd_layouts(tag, call, kern)
    plain = km.reference_stopped_train_rollout(prob, net, X0, t0, N, dt,
                                               lam=lam, **kw)
    g_plain = torch.autograd.grad(loss(plain), leaves)
    torch.cuda.synchronize()
    agree = (kern.hitting == plain.hitting) & (kern.stopped == plain.stopped)
    n_dis = int((~agree).sum())
    check(n_dis <= MASK_TOL * K, f"{tag}: {n_dis} paths exit at another step")
    for name in ("X", "Y", "v_l2", "adv_steps"):
        a = getattr(kern, name).detach()[agree]
        b = getattr(plain, name).detach()[agree]
        check(bool(torch.isfinite(a).all()), f"{tag} {name} not finite")
        err = float((a - b).abs().max())
        rel = err / (1.0 + float(b.abs().max()))
        worst["out"] = max(worst["out"], err)
        check(rel <= REL_TOL, f"{tag} {name} rel {rel:.3e} > {REL_TOL}")
    check(float(g_plain[-1].abs()) > 0, f"{tag}: the lambda gradient is 0")
    loss_rels = rel_per_leaf(tag, "loss gradients", names, g_kern, g_plain,
                             GRAD_TOL)
    for a, b in zip(g_kern, g_plain):
        worst["grad"] = max(worst["grad"], float((a - b).abs().max()))
    # the backward on the plain outputs' cotangents
    Y = plain.Y.detach().requires_grad_()
    (gY,) = torch.autograd.grad(loss(plain._replace(Y=Y)), [Y])
    with torch.no_grad():
        S = (km.reference_stopped_train_rollout(
            prob, net, X0, t0, N, dt, lam=0.0 * lam, **kw).Y
             - km.reference_stopped_train_rollout(
                 prob, net, X0, t0, N, dt, lam=1.0 + 0.0 * lam, **kw).Y)
    lam_scale = float(torch.sum((gY * agree.to(gY.dtype) * S).abs()))
    bwd, lam_err, grid, lanes = check_backward(tag, call, net, gY, agree,
                                               worst, lam_scale=lam_scale)
    print(f"  {tag}: forward layouts {layouts} bitwise equal; exit step "
          f"differs on {n_dis} of {K} paths; advancing "
          f"steps {float(plain.adv_steps.sum()):.0f}; outputs ok; "
          f"{loss_rels}; backward {['%.1e' % r for r in bwd]} ({grid} "
          f"blocks, {lanes_note(lanes)}, two launches bitwise equal); "
          f"backward lambda "
          f"{lam_err:.2e} of sum|gY S| {lam_scale:.2e} (|d/dlambda| "
          f"{float(g_plain[-1].abs()):.2e})")


def eigen_phases(dev, smi):
    """Phases 20-22: the torus family of the stopped kernels (lambda, the
    square's proposal test, the torus drift, the output clamp) against its
    plain version, the EigenSolver main path, and the times.  Returns the
    kernels' JSON rows and the main path's solver, which phase 38
    refines."""
    import numpy as np
    from pspde_torch.ansatz import DenseNet
    from pspde_torch.problems import FokkerPlanckEigen, SchrodingerEigen
    from pspde_torch.rollout import kernels as km
    from pspde_torch.rollout.sampling import sample_domain
    from pspde_torch.solvers import EigenSolver

    t_phases = time.perf_counter()
    d, N, dt = D_EIG, N_EIG, DT_EIG
    fp = FokkerPlanckEigen(d=d, device=dev)
    gen = torch.Generator(device=dev).manual_seed(20)

    def net_of(default, seed):
        # the solver's default (bias 0.8, the relu clamp) or the notebook's
        kw = dict(bias_init_value=0.8, output_relu=True) if default else {}
        return DenseNet(1, (10, 10, 10, 10), d_in=d, device=dev,
                        generator=torch.Generator(dev).manual_seed(seed), **kw)

    # -- phase 20: the torus family vs plain ---------------------------------
    Kc = K_EIG_CHECK
    print(f"phase 20: torus kernels vs plain, FokkerPlanckEigen(d={d}), "
          f"K={Kc}, N={N}, dt={dt}, lambda={LAM_EIG}, DenseNet (10, 10, 10, "
          f"10) with bias 0.8 and the clamp and without; outputs rel "
          f"{REL_TOL:g} on agreeing paths, exit-step disagreements <= "
          f"{MASK_TOL:g} K, loss gradients {GRAD_TOL:g} and the backward on "
          f"plain cotangents {BWD_REL_TOL:g} x max|plain|")
    worst = {"out": 0.0, "grad": 0.0, "bwd": 0.0}
    X0 = sample_domain(gen, fp.geometry, Kc, d)
    noise = torch.randn((N, Kc, d), generator=gen, device=dev)
    for default in (True, False):
        for adaptive in (False, True):
            net = net_of(default, 1 + adaptive)
            for what, kw in (("host noise", dict(host_noise=noise)),
                             ("erfinv", dict(seed=4321, rng="erfinv")),
                             ("binom", dict(seed=4321, rng="binom"))):
                compare_eigen(
                    f"[{'default' if default else 'notebook'}"
                    f"{', adaptive' if adaptive else ''}, {what}]", fp, net,
                    X0, N, dt, dict(kw, adaptive_forward=adaptive), worst)
    del noise

    # -- phase 21: the main path ---------------------------------------------
    print(f"phase 21: EigenSolver(FokkerPlanckEigen(d={d}), "
          f"rollout_mode='fused_train'), experiments/eigenvalue_fokker_planck"
          f".py's recipe: DenseNet (10, 10, 10, 10), lr 1e-3, lr_lambda 0.01, "
          f"lambda_init 0.5, K={K_EIG}, K_boundary={KB_EIG}, alpha (50, 1), "
          f"'center', N={N}, dt={dt}, {L_EIG} steps")

    def solver(K, mode, L=L_EIG):
        return EigenSolver(
            fp, f"fp-eigen-{mode}", seed=42, delta_t=dt, N=N, lr=1e-3,
            lr_lambda=0.01, lambda_init=0.5, L=L, K=K, K_boundary=KB_EIG,
            alpha=(50.0, 1.0), normalization="center",
            value_net=net_of(False, 42), rollout_mode=mode, verbose=False,
            device=dev)

    main = solver(K_EIG, "fused_train")
    check(main.resolved_rollout_mode == "fused_train",
          f"engine {main.resolved_rollout_mode}")
    try:
        EigenSolver(SchrodingerEigen(d=10, device=dev), "schroedinger",
                    normalization="l2_penalty", rollout_mode="fused_train",
                    verbose=False, device=dev)
        raised = ""
    except ValueError as e:
        raised = str(e)
    check("gate failed" in raised and "STOPPED_KERNEL_FAMILY" in raised,
          "SchrodingerEigen with the solver's default relu^2 DenseNet on "
          "fused_train raises a ValueError naming the gate (got "
          f"{raised[:80]!r})")
    print(f"  SchrodingerEigen(d=10) with the default relu^2 DenseNet on "
          f"fused_train raises: {raised[:120]}")
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with PlainCalls(km) as plain_calls:
        main.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counted(km.fused_stopped_train_rollout, "launches",
                       "backward_launches")
    v_tail = float(np.mean(main.V_L2_log[-100:]))
    lam_tail = main.lambda_tail_mean()
    v_bound = 3.0 * V_L2_TAIL_JAX
    lam_bound = max(0.05, 3.0 * abs(LAMBDA_TAIL_JAX))
    print(f"  {len(main.loss_log)} steps in {wall:.2f} s "
          f"({1e3 * wall / len(main.loss_log):.3f} ms a step); launches "
          f"forward {launches[0]}, backward {launches[1]}; plain-version "
          f"calls {plain_calls.n}; V_L2 every 500: "
          f"{['%.3e' % v for v in main.V_L2_log[::500]]}; lambda every 500: "
          f"{['%.3e' % v for v in main.lambda_log[::500]]}")
    print(f"  tail-100 V_L2 {v_tail:.4e} (bound {v_bound:.4e}, JAX "
          f"{V_L2_TAIL_JAX:.4e}); lambda tail mean {lam_tail:.4e} (bound "
          f"|.| <= {lam_bound:g}, JAX {LAMBDA_TAIL_JAX:.4e})")
    warm = captured(main, L_EIG)
    check(launches == (L_EIG + warm, L_EIG + warm) and plain_calls.n == 0,
          "one forward and one backward launch per step (and in the warm-up "
          "step), no plain call")
    check(all(math.isfinite(v) for v in main.loss_log + main.lambda_log),
          "finite losses and lambdas")
    check(v_tail <= v_bound, f"tail-100 V_L2 {v_tail:.4e} > {v_bound:.4e}")
    check(abs(lam_tail) <= lam_bound,
          f"|lambda tail mean| {abs(lam_tail):.4e} > {lam_bound:g}")
    reset_counts(km.fused_stopped_train_rollout, "launches")
    t0 = time.perf_counter()
    lam_hat, lam_se = main.estimate_lambda(K=4096, n_batches=16)
    est_wall = time.perf_counter() - t0
    print(f"  estimate_lambda (K=4096, 16 batches, two forward launches "
          f"each: {km.fused_stopped_train_rollout.launches}): {lam_hat:.4e} "
          f"+- {lam_se:.1e} in {est_wall:.2f} s (lambda_true "
          f"{fp.lambda_true})")
    check(km.fused_stopped_train_rollout.launches == 32
          and math.isfinite(lam_hat) and math.isfinite(lam_se),
          "estimate_lambda ran on the kernel")

    # -- phase 22: times -----------------------------------------------------
    print(f"phase 22: timing at K={K_EIG} and K={K_EIG_BENCH}, N={N}, d={d}, "
          "notebook net, lambda leaf, erfinv Philox noise, CUDA events")
    times = {}
    for K in (K_EIG, K_EIG_BENCH):
        net = net_of(False, 5)
        X0 = sample_domain(gen, fp.geometry, K, d)
        t0b = torch.zeros(K, device=dev)
        lam = torch.full((1,), LAM_EIG, device=dev)
        gY = torch.randn(K, generator=gen, device=dev) / K
        call = km._StoppedCall(
            fp, net, X0, t0b, N, dt, 17,
            km._check_stopped_family(fp, net, "erfinv", lam=lam),
            dict(adaptive_forward=False, rng="erfinv", host_noise=None,
                 time_stopping=False), None, lam)
        probe = km._stopped_forward_kernel(call)
        hit = float(probe.hitting.sum())
        adv = float(probe.adv_steps.sum())
        n_par = sum(p.numel() for p in net.parameters()) + 1
        _, fwd_f, bwd_f = stopped_flops(net, d, adaptive=False, torus=True)
        # on the torus a step that stops still forms its proposal
        b_fwd = roofline(hit * fwd_f, 4 * (n_par + K * (2 * d + 7)))
        b_bwd = stopped_bwd_roofline(adv, bwd_f, net,
                                     4 * (2 * n_par + K * (d + 2)))
        use = lane_use(call, probe, gY, torus=True)
        print_lane_use(f"K={K}", use)
        fwd_use = fwd_lane_use(call, dev)
        print_fwd_lane_use(f"K={K}", fwd_use)
        steppers = {mode: solver(K, mode, L=1)
                    for mode in ("fused_train", "scan")}

        def plain_fwd():
            with torch.no_grad():
                call.plain()

        r = {}
        for name, kern_fn, plain_fn, reps in (
                ("forward", lambda: km._stopped_forward_kernel(call),
                 plain_fwd, 20),
                ("backward", lambda: km._stopped_backward_kernel(call, gY),
                 lambda: km._reference_stopped_backward(call, gY), 10),
                ("step", steppers["fused_train"].step,
                 steppers["scan"].step, 10)):
            p1 = timed(plain_fn, 1)
            k = [timed(kern_fn, reps), timed(kern_fn, reps)]
            p2 = timed(plain_fn, 1)
            r[name] = (min(k), min(p1, p2))
            print(f"  K={K:6d} {name:8s} kernel {k[0]:.3f}, {k[1]:.3f} ms; "
                  f"plain {p1:.3f}, {p2:.3f} ms")
        print(f"  K={K}: {hit:.0f} active and {adv:.0f} advancing path-steps "
              f"of K N = {K * N}; bound forward {b_fwd['bound_ms']:.5f} ms, "
              f"backward {b_bwd['bound_ms']:.5f} ms (all FP32 "
              f"{b_bwd['bound_ms_fp32']:.5f}; {b_fwd['bound_by']}); "
              f"step {r['step'][0]:.3f} ms")
        times[K] = (r, dict(b_fwd, layout=fwd_use["layout"]),
                    dict(b_bwd, lanes=use[0]), steppers["fused_train"])
    print(f"  card: {smi}")
    profile_steps(f"3 EigenSolver steps, K={K_EIG}", main.step)
    profile_steps(f"3 EigenSolver steps, K={K_EIG_BENCH}",
                  times[K_EIG_BENCH][3].step)
    print(f"  phases 20-22 took {time.perf_counter() - t_phases:.1f} s")

    (r, b_fwd, b_bwd, _), (rb, bb_fwd, bb_bwd, _) = (times[K_EIG],
                                                   times[K_EIG_BENCH])
    row = {"route": "cuda", "source": STOPPED_SOURCE,
           "shape": f"FokkerPlanckEigen, d={d}, K={K_EIG}, N={N}, lambda"}
    rows = [
        dict(row, name="fused_stopped_train_rollout.forward.torus",
             replaces="pspde/rollout/kernels.py:1184", launches=launches[0],
             max_abs_err=worst["out"], ms=r["forward"][0],
             plain_ms=r["forward"][1], **b_fwd,
             ms_K65536=rb["forward"][0], plain_ms_K65536=rb["forward"][1],
             bound_ms_K65536=bb_fwd["bound_ms"],
             layout_K65536=bb_fwd["layout"]),
        dict(row, name="fused_stopped_train_rollout.backward.torus",
             replaces="pspde/rollout/kernels.py:1272", launches=launches[1],
             max_abs_err=max(worst["grad"], worst["bwd"]),
             ms=r["backward"][0],
             plain_ms=r["backward"][1], **b_bwd,
             ms_K65536=rb["backward"][0], plain_ms_K65536=rb["backward"][1],
             bound_ms_K65536=bb_bwd["bound_ms"]),
    ]
    return rows, main


def double_well_phases(dev, smi):
    """Phases 23-26: the serve kernel's double-well drift against its
    plain version at d=1 and d=10; the double-well and LQ training cells on
    the scan with their u_L2 checks, IS of the learned controls through
    the kernel; the times.  Returns the kernels' JSON rows."""
    import numpy as np
    from pspde_torch.ansatz import LinearLQ, TanhMLP
    from pspde_torch.eval import (do_importance_sampling,
                                  importance_sampling,
                                  importance_sampling_fused)
    from pspde_torch.problems import LQGC, DoubleWell, DoubleWell_multidim
    from pspde_torch.rollout import kernels as km
    from pspde_torch.solvers import HJBSolver

    t_phases = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(23)
    dw1 = DoubleWell(d=1, T=1.0, eta=3.0, kappa=5.0, device=dev)
    dw10 = DoubleWell_multidim(d=10, d_1=3, d_2=7, T=1.0, eta=3.0,
                               kappa=5.0, device=dev)
    cells = {1: ("DoubleWell(d=1, eta=3, kappa=5)", dw1),
             10: ("DoubleWell_multidim(d=10, d_1=3, d_2=7, eta=3, kappa=5)",
                  dw10)}

    # -- phase 23: the double-well drift vs plain ---------------------------
    print(f"phase 23: the serve kernel's double-well drift vs plain, K="
          f"{K_CHECK}, N={N_DW}, dt={DT_DW}, TanhMLP (30, 30) with "
          f"N(0, 0.25) weights; host noise and the Philox stream, signs +-1; "
          f"every layout bitwise; tolerance rel {REL_TOL:g}")
    worst = {1: 0.0, 10: 0.0}
    for d, (tag, prob) in cells.items():
        net = TanhMLP(d + 1, d, init_scale=0.5, generator=gen, device=dev)
        noise = torch.randn((N_DW, K_CHECK, d), generator=gen, device=dev)
        kern = km.fused_controlled_rollout(prob, net, K_CHECK, N_DW, DT_DW,
                                           host_noise=noise)
        plain = km.reference_controlled_rollout(prob, net, K_CHECK, N_DW,
                                                DT_DW, host_noise=noise)
        worst[d] = max(worst[d], compare_serve(f"[{tag}, host noise]", kern,
                                               plain))
        del noise
        for sign in (1.0, -1.0):
            kern = km.fused_controlled_rollout(prob, net, K_CHECK, N_DW,
                                               DT_DW, seed=1234,
                                               noise_sign=sign)
            plain = km.reference_controlled_rollout(
                prob, net, K_CHECK, N_DW, DT_DW, seed=1234, noise_sign=sign)
            worst[d] = max(worst[d], compare_serve(
                f"[{tag}, sign {sign:+.0f}]", kern, plain))
            if sign == 1.0:
                serve_layouts(f"[{tag}]", prob, net, kern, N=N_DW, dt=DT_DW)
    try:
        km.fused_train_rollout(dw1, TanhMLP(2, 1, device=dev), 64, 4, DT_DW)
        raised = ""
    except ValueError as e:
        raised = str(e)
    print(f"  fused_train_rollout on the double well raises: {raised[:120]}")
    check("serve kernel only" in raised,
          "the training kernels refuse the double well's drift")

    def train(s):
        """Train ``s`` (its default 'auto' steps_per_call: captured
        graphs) and return the wall seconds a step."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s.train()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / len(s.loss_log)
        captured(s, len(s.loss_log))
        return wall

    def falls(s, what):
        u = s.u_L2_loss
        head, tail = float(np.mean(u[:5])), float(np.mean(u[-20:]))
        print(f"  {what}: u_L2 {u[0]:.4f} -> {u[-1]:.4f} (mean of the first "
              f"5 {head:.4f}, of the last 20 {tail:.4f})")
        check(all(np.isfinite(s.loss_log)) and tail < head,
              f"{what}: u_L2 falls ({head:.4f} -> {tail:.4f})")

    # -- phase 24: the 1-d cells ---------------------------------------------
    print(f"phase 24: HJBSolver on DoubleWell(d=1): tests/"
          f"test_double_well_is.py's recipe (eta=1, kappa=1, dt 0.01, "
          f"K=1024, lr 5e-3, {L_DW_TEST} steps) and the notebook's (eta=3, "
          f"kappa=5, dt {DT_DW}, K=10^4, lr 0.05, {L_DW} steps); IS through "
          f"the kernel at K={K_SERVE}")
    meta = (torch.ones(1), 0.5)
    dwt = DoubleWell(d=1, T=1.0, eta=1.0, kappa=1.0, device=dev)
    dwt.compute_reference_solution(delta_t=0.01, nx=500)
    st = HJBSolver("dw-test", dwt, lr=5e-3, L=L_DW_TEST, K=1024,
                   delta_t=0.01, time_approx="inner",
                   loss_method="log-variance", detach_forward=True,
                   metastability_logs=meta, early_stopping_time=None,
                   verbose=False, device=dev)
    ms_test = 1e3 * train(st)
    u = st.u_L2_loss
    frac = st.particles_close_to_target[-1]
    print(f"  eta=1, kappa=1: u_L2 {u[0]:.4f} -> {u[-1]:.4f} (bound 0.3 x "
          f"the first), metastable fraction {frac:.4f}, {ms_test:.2f} ms a "
          "step")
    check(u[-1] < 0.3 * u[0], f"u_L2 {u[0]:.4f} -> {u[-1]:.4f}")
    check(len(st.particles_close_to_target) == len(st.loss_log),
          "the metastable fraction is logged every step")
    km.fused_controlled_rollout.launches = 0
    mean, var, rel = importance_sampling_fused(dwt, st, K_SERVE,
                                               delta_t=0.01, seed=24)
    check(km.fused_controlled_rollout.launches == 1,
          "IS of the eta=1 model ran the kernel")
    _, _, rel_naive, *_ = do_importance_sampling(
        dwt, st, K_SERVE, delta_t=0.01, verbose=False,
        generator=torch.Generator(dev).manual_seed(24))
    v0 = float(dwt.v_ref_fn(np.zeros(1))(dwt.X_0[None, :], 0)[0])
    err = abs(math.log(mean) + v0)
    print(f"  IS through the kernel: mean {mean:.6e} RE {rel:.4f} (naive "
          f"RE {rel_naive:.4f}); log mean {math.log(mean):.6f} against "
          f"-v_ref(X_0, 0) {-v0:.6f}: {err:.4e} (bound {DW_LOG_MEAN_TOL})")
    check(rel < rel_naive, f"IS RE {rel:.4f} < naive RE {rel_naive:.4f}")
    check(err <= DW_LOG_MEAN_TOL, f"|log mean + v_ref| {err:.4e}")

    dw1.compute_reference_solution()
    try:
        HJBSolver("dw-fused", dw1, delta_t=DT_DW, time_approx="inner",
                  detach_forward=True, rollout_mode="fused_train",
                  verbose=False, device=dev)
        raised = ""
    except ValueError as e:
        raised = str(e)
    print(f"  HJBSolver(rollout_mode='fused_train') on the double well "
          f"raises: {raised[:160]}")
    check("gate failed" in raised and "u_ref_table" in raised,
          "fused_train on the double well raises, naming the gate")
    s1 = HJBSolver("dw-notebook", dw1, lr=0.05, L=L_DW, K=10_000,
                   delta_t=DT_DW, time_approx="inner",
                   loss_method="log-variance", detach_forward=True,
                   metastability_logs=meta, early_stopping_time=None,
                   print_every=DW_CHUNK, verbose=False, device=dev)
    ms_1 = 1e3 * train(s1)
    falls(s1, f"eta=3, kappa=5, {L_DW} steps, {ms_1:.2f} ms a step")
    print(f"  metastable fraction {s1.particles_close_to_target[0]:.4f} -> "
          f"{s1.particles_close_to_target[-1]:.4f}; card: {smi}")
    profile_steps("the eta=3, kappa=5 scan step", s1.step)

    # -- phase 25: the d=10 cell ---------------------------------------------
    print(f"phase 25: HJBSolver on DoubleWell_multidim(d=10, d_1=3, d_2=7, "
          f"eta=3, kappa=5), dt {DT_DW}, K=500, lr 5e-3, {L_DW} steps")
    dw10.compute_reference_solution()
    s10 = HJBSolver("dw-multidim", dw10, lr=5e-3, L=L_DW, K=500,
                    delta_t=DT_DW, time_approx="inner",
                    loss_method="log-variance", detach_forward=True,
                    early_stopping_time=None, print_every=DW_CHUNK,
                    verbose=False, device=dev)
    ms_10 = 1e3 * train(s10)
    falls(s10, f"d=10, {L_DW} steps, {ms_10:.2f} ms a step")
    profile_steps("the d=10 scan step", s10.step)

    # -- phase 26: LQGC with the linear ansatz, 'outer' ----------------------
    print(f"phase 26: HJBSolver on LQGC(d=10, T=0.5, delta_t=0.05), "
          f"LinearLQ, 'outer', K=512, lr 1e-2, {L_LQ} steps")
    lq = LQGC(d=10, T=0.5, delta_t=0.05, device=dev)
    sq = HJBSolver("lq-linear", lq, lr=1e-2, L=L_LQ, K=512, delta_t=0.05,
                   time_approx="outer", loss_method="log-variance",
                   detach_forward=True, learn_Y_0=False,
                   control_net=LinearLQ(lq.B, lq.Q, device=dev,
                                        generator=torch.Generator()
                                        .manual_seed(26)),
                   early_stopping_time=None, verbose=False, device=dev)
    ms_lq = 1e3 * train(sq)
    falls(sq, f"LQGC d=10 LinearLQ 'outer', {L_LQ} steps, {ms_lq:.2f} ms a "
              "step")
    profile_steps("the LQGC 'outer' scan step", sq.step)

    # -- the serve of the learned double-well controls ------------------------
    print(f"  the main path: importance_sampling_fused of the learned "
          f"controls at K={K_SERVE}, N={N_DW}; card: {smi}")
    rows = []
    for d, s in ((1, s1), (10, s10)):
        tag, prob = cells[d]
        km.fused_controlled_rollout.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mean, var, rel = importance_sampling_fused(prob, s, K_SERVE,
                                                   delta_t=DT_DW, seed=25)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = km.fused_controlled_rollout.launches
        print(f"  [{tag}] mean {mean:.6e} var {var:.4e} RE {rel:.4f}, "
              f"{wall:.4f} s wall, {launches} launch(es)")
        check(launches >= 1 and math.isfinite(mean) and mean > 0,
              f"{tag}: the serve launched the kernel, mean {mean}")

        def kern():
            return km.fused_controlled_rollout(prob, s.z_net, K_SERVE, N_DW,
                                               DT_DW, seed=5)

        def plain():
            return km.reference_controlled_rollout(prob, s.z_net, K_SERVE,
                                                   N_DW, DT_DW, seed=5)

        p_ms = [timed(plain, 1)]
        k_ms = [timed(kern, 5), timed(kern, 5)]
        ms, out_p = timed_out(plain)
        p_ms.append(ms)
        # the main path's own shapes and trained net against the plain
        # version on the same Philox stream, both against the float64 chain
        out_k = kern()
        ref = double_well_chain_f64(prob, s.z_net, K_SERVE, N_DW, DT_DW, 5)
        err_check = worst[d]
        worst[d] = max(worst[d], serve_against_f64(
            f"[{tag}, the learned control, K={K_SERVE}]", out_k, out_p, ref))
        del out_p, out_k, ref
        occ = serve_occupancy(prob, s.z_net, K_SERVE, dev, N=N_DW, dt=DT_DW)
        n_par = sum(p.numel() for p in s.z_net.parameters())
        row = {"name": f"fused_controlled_rollout.double_well_d{d}",
               "route": "cuda", "source": SERVE_SOURCE,
               "replaces": "pspde/rollout/kernels.py:339",
               "shape": f"{tag}, K={K_SERVE}, N={N_DW}",
               "launches": launches, "max_abs_err": worst[d],
               "max_abs_err_phase23": err_check,
               "ms": min(k_ms), "plain_ms": min(p_ms),
               **serve_roofline(K_SERVE * N_DW, [d + 1, 30, 30, d], n_par,
                                K_SERVE, per_dim=15)}
        print(f"  [{tag}] kernel {k_ms} ms, plain {p_ms} ms; bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']}; all in FP32 "
              f"{row['bound_ms_fp32']:.4f} ms); no library call computes "
              f"it; launch (the occupancy API's): {occ}")
        rows.append(row)
    m_true, _, rel_true = importance_sampling(
        dw1, s1, K_DW_TRUE, control="true", delta_t=DT_DW,
        generator=torch.Generator(dev).manual_seed(26))
    print(f"  IS with the FD control (control='true'), eta=3, kappa=5, "
          f"K={K_DW_TRUE}: mean {m_true:.6e} RE {rel_true:.4f}")
    check(math.isfinite(m_true) and m_true > 0 and rel_true < 10.0,
          f"IS with the FD control: mean {m_true}, RE {rel_true}")
    print(f"  phases 23-26 took {time.perf_counter() - t_phases:.1f} s")
    return rows


def breadth_phases(dev, smi):
    """Phases 27-29: the breadth families of the stopped kernels (the two
    spheres, the committor's reference, h's (sum x)^2 term, a dense sigma)
    against their plain version, their times at K=65536, and the
    notebooks' diffusion legs through 'fused_train' and PINN legs, from
    JAX's initial nets.  Returns the kernels' JSON rows and the committor's
    diffusion leg, which phase 38 refines."""
    import numpy as np
    from pspde_torch.ansatz import DenseNet
    from pspde_torch.problems import (Committor,
                                      ExponentialOnBallNonlinearSinHessian)
    from pspde_torch.rollout import kernels as km
    from pspde_torch.rollout.sampling import sample_domain
    from pspde_torch.solvers import EllipticSolver
    from pspde_torch.utils.convert import load_control_npz

    t_phases = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(root, "experiments"))
    from torch_kernel_times import device_ms
    gen = torch.Generator(device=dev).manual_seed(27)
    com = Committor(d=D_COM, device=dev)
    hes = ExponentialOnBallNonlinearSinHessian(d=D_HES, alpha=1.0,
                                               device=dev)
    # family: (problem, d, N at the check and the legs, N at the times,
    # the loss's vanishing leaves, asset)
    fams = {"committor": (com, D_COM, N_COM, N_COM_BENCH,
                          ("layers.2.bias",), "committor_d10_densenet.npz"),
            "hessian": (hes, D_HES, N_HES, N_HES, (),
                        "hessian_d20_densenet.npz")}

    def net_of(d, seed, relu=False):
        return DenseNet(1, (30, 30), d_in=d, output_relu=relu, device=dev,
                        generator=torch.Generator(dev).manual_seed(seed))

    # -- phase 27: the families vs plain -------------------------------------
    Kc = K_BR_CHECK
    print(f"phase 27: the breadth families vs plain, K={Kc}, DenseNet (30, "
          f"30): Committor(d={D_COM}) between the spheres 1 and 2 (h = 0, "
          f"the committor's reference), N={N_COM}, and "
          f"ExponentialOnBallNonlinearSinHessian(d={D_HES}) (sigma = "
          f"sqrt(2/d) ones(d, d), h's (sum x)^2), N={N_HES}; dt {DT_BR}, "
          f"adaptive or not, with and without the output clamp; outputs rel "
          f"{REL_TOL:g} on agreeing paths, exit-step disagreements <= "
          f"{MASK_TOL:g} K, gradients {GRAD_TOL:g} and the backward on plain "
          f"cotangents {BWD_REL_TOL:g} x max|plain|; the forward bitwise "
          "across its layouts; the committor's backward on the lanes kernel "
          "(its layout at this K, its rows bitwise across the other layouts "
          "of its tile), the Hessian's on the shared plan; the committor "
          f"again at the notebook's K={K_BR_LEG}, where its main path "
          "launches the backward")
    worst = {tag: {"out": 0.0, "grad": 0.0, "bwd": 0.0} for tag in fams}
    # at the notebooks' K both instantiations (the clamp or not), one of
    # them adaptive: the script's time limit
    cells = [(tag, Kc, gen) for tag in fams] + [
        ("committor", K_BR_LEG,
         torch.Generator(device=dev).manual_seed(270))]
    for tag, K, g in cells:
        prob, d, N, _, zero, _ = fams[tag]
        X0 = sample_domain(g, prob.geometry, K, d)
        t0 = torch.zeros(K, device=dev)
        noise = torch.randn((N, K, d), generator=g, device=dev)
        for relu in (False, True):
            for adaptive in (False, True):
                if K != Kc and adaptive != relu:
                    continue
                net = net_of(d, 1 + 2 * relu + adaptive, relu)
                cases = [("erfinv", dict(seed=4321, rng="erfinv"))]
                if not relu and not adaptive and K == Kc:
                    cases.append(("host noise", dict(host_noise=noise)))
                for what, kw in cases:
                    compare_stopped(
                        f"[{tag}{'' if K == Kc else f' K={K}'}"
                        f"{', adaptive' if adaptive else ''}"
                        f"{', clamp' if relu else ''}, {what}]", prob, net,
                        X0, t0, N, DT_BR,
                        dict(kw, adaptive_forward=adaptive), worst[tag],
                        MASK_TOL, zero_leaves=() if relu else zero,
                        bwd_zero_leaves=zero)
        del noise

    # -- phase 28: times ------------------------------------------------------
    Kb = K_BR_BENCH
    print(f"phase 28: timing at K=200 (the notebooks' legs: the committor "
          f"N={N_COM}, the Hessian N={N_HES}) and at K={Kb} (the committor "
          f"at JAX's 'com10' cell, N={N_COM_BENCH}; the Hessian N={N_HES}), "
          f"d={D_COM} and d={D_HES}; erfinv Philox noise; CUDA events and "
          "the profiler's device time; the backward on both plans where "
          "both run (the committor: the lanes kernel chosen, the shared "
          "plan forced)")
    times = {}
    for tag, (prob, d, N_leg, N_bench, _, _) in fams.items():
        for K, N in ((200, N_leg), (Kb, N_bench)):
            net = net_of(d, 5)
            X0 = sample_domain(gen, prob.geometry, K, d)
            gY = torch.randn(K, generator=gen, device=dev) / K
            call = km._StoppedCall(
                prob, net, X0, torch.zeros(K, device=dev), N, DT_BR, 17,
                km._check_stopped_family(prob, net, "erfinv"),
                dict(adaptive_forward=False, rng="erfinv", host_noise=None),
                None)
            probe = km._stopped_forward_kernel(call)
            hit = float(probe.hitting.sum())
            adv = float(probe.adv_steps.sum())
            full = prob.sigma_struct.kind != "scalar"
            n_par = sum(p.numel() for p in net.parameters())
            n_sig = d * d if full else 0
            v_f, fwd_f, bwd_f = stopped_flops(net, d, adaptive=False,
                                              full=full)
            b_fwd = roofline((hit - adv) * v_f + adv * fwd_f,
                             4 * (n_par + n_sig + K * (2 * d + 5)))
            b_bwd = stopped_bwd_roofline(
                adv, bwd_f, net, 4 * (2 * n_par + n_sig + K * (d + 1)))
            packed = call.pack(backward=True)
            lay = bwd_layout(packed, dev)
            print(f"  {tag} K={K}: backward {lay}")
            use = lane_use(call, probe, gY)
            print_lane_use(f"{tag} K={K}", use)
            fwd_use = fwd_lane_use(call, dev)
            print_fwd_lane_use(f"{tag} K={K}", fwd_use)
            plan = packed.layout[0]
            other = {"shared": "device", "device": "shared"}[plan]
            try:
                call._replace(plan=other).pack(backward=True)
            except ValueError:
                other = None

            def plain_fwd(call=call):
                with torch.no_grad():
                    call.plain()

            def bwd_on(p, call=call, gY=gY):
                c = call._replace(plan=p)
                return lambda: km._stopped_backward_kernel(c, gY)

            r = {}
            for name, kern_fn, plain_fn, reps, key in (
                    ("forward", lambda call=call: km._stopped_forward_kernel(
                        call), plain_fwd, 10, "stopped_fwd_kernel"),
                    ("backward", bwd_on(plan),
                     lambda call=call, gY=gY: km._reference_stopped_backward(
                         call, gY), 5, BWD_KEY[plan]),
                    ("other plan", None if other is None else bwd_on(other),
                     None, 5, None if other is None else BWD_KEY[other])):
                if kern_fn is None:
                    continue
                p1 = timed(plain_fn, 1) if plain_fn else None
                k = [timed(kern_fn, reps), timed(kern_fn, reps)]
                p2 = timed(plain_fn, 1) if plain_fn else None
                dms, seen = device_ms(kern_fn, reps, key)
                r[name] = (min(k), None if p1 is None else min(p1, p2), dms)
                what = (f"{name} ({other} plan)" if name == "other plan"
                        else name if name == "forward" else
                        f"{name} ({plan} plan)")
                print(f"  {tag:9s} K={K:5d} {what:24s} kernel {k[0]:.3f}, "
                      f"{k[1]:.3f} ms (device "
                      f"{'none' if dms is None else f'{dms:.4f}'} ms a "
                      f"launch over the {seen} of {reps} launches the "
                      f"profiler recorded)" + (
                          "" if p1 is None else
                          f"; plain {p1:.3f}, {p2:.3f} ms"))
            print(f"  {tag} K={K}: {hit:.0f} active and {adv:.0f} advancing "
                  f"path-steps of K N = {K * N}; bound forward "
                  f"{b_fwd['bound_ms']:.5f} ms, backward "
                  f"{b_bwd['bound_ms']:.5f} ms (all FP32 "
                  f"{b_bwd['bound_ms_fp32']:.5f}; {b_fwd['bound_by']})")
            times[tag, K] = (r, dict(b_fwd, layout=fwd_use["layout"],
                                     lane_use=fwd_use["lane_use"]),
                             dict(b_bwd, lanes=use[0], plan=plan,
                                  layout=lay))
    print(f"  card: {smi}")

    # -- phase 29: the notebooks' legs ----------------------------------------
    print(f"phase 29: the notebooks' legs from JAX's initial DenseNet (30, "
          f"30) (experiments/stopped_breadth_reference.py), K=200, "
          f"K_boundary=50, lr 1e-3, dt {DT_BR}, K_test_log=10000: the "
          f"diffusion legs on 'fused_train' ({L_BR_DIFF} steps; the "
          f"committor N={N_COM}, alpha (10, 1), loss_with_stopped=False; "
          f"the Hessian N={N_HES}) and the PINN legs ({L_BR_PINN} steps; the "
          "committor alpha (1e-3, 1), the Hessian full_hessian=True); the "
          "tail-50 test L2 within 3x JAX's, falling from the first by at "
          "least half of JAX's fall")
    legs = {
        "committor_diffusion": ("committor", L_BR_DIFF, dict(
            alpha=(10.0, 1.0), loss_method="diffusion",
            loss_with_stopped=False, rollout_mode="fused_train")),
        "hessian_diffusion": ("hessian", L_BR_DIFF, dict(
            loss_method="diffusion", rollout_mode="fused_train")),
        "committor_pinn": ("committor", L_BR_PINN, dict(
            alpha=(1e-3, 1.0), loss_method="PINN",
            loss_with_stopped=False)),
        "hessian_pinn": ("hessian", L_BR_PINN, dict(
            loss_method="PINN", full_hessian=True)),
    }
    try:
        EllipticSolver(hes, "pinn-fused", loss_method="PINN",
                       rollout_mode="fused_train", verbose=False,
                       device=dev)
        raised = ""
    except ValueError as e:
        raised = str(e)
    print(f"  PINN on fused_train raises: {raised[:120]}")
    check("gate failed" in raised and "loss_method" in raised,
          "PINN on fused_train raises, naming the gate")
    launches = {}
    for leg, (tag, L, kw) in legs.items():
        prob, d, N = fams[tag][:3]
        s = EllipticSolver(prob, leg, seed=42, delta_t=DT_BR, N=N, lr=1e-3,
                           L=L, K=200, K_boundary=50, K_test_log=10000,
                           verbose=False, device=dev, **kw)
        tree, _ = load_control_npz(os.path.join(root, "pspde_torch",
                                                "assets", fams[tag][5]))
        s.load_jax_params(tree)
        fused = kw.get("rollout_mode") == "fused_train"
        check(s.resolved_rollout_mode == ("fused_train" if fused else "scan"),
              f"{leg}: engine {s.resolved_rollout_mode}")
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with PlainCalls(km) as plain_calls:
            s.train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = counted(km.fused_stopped_train_rollout, "launches",
                    "backward_launches")
        by_plan = counted(km.fused_stopped_train_rollout,
                          "backward_launches_by_plan")
        tail = float(np.mean(s.V_test_L2[-50:]))
        bound = 3.0 * BR_TAIL_JAX[leg]
        fall = s.V_test_L2[0] - tail
        fall_jax = BR_FIRST_JAX[leg] - BR_TAIL_JAX[leg]
        print(f"  [{leg}] {len(s.loss_log)} steps in {wall:.2f} s "
              f"({1e3 * wall / len(s.loss_log):.3f} ms a step); launches "
              f"forward {n[0]}, backward {n[1]} (by plan {by_plan}); "
              f"plain-version calls "
              f"{plain_calls.n}; test L2 every 100: "
              f"{['%.3e' % v for v in s.V_test_L2[::100]]}; tail-50 "
              f"{tail:.4e} (bound {bound:.4e}, JAX {BR_TAIL_JAX[leg]:.4e}); "
              f"fall from the first {fall:.4e} (JAX {BR_FIRST_JAX[leg]:.4e}"
              f" -> {BR_TAIL_JAX[leg]:.4e}, {fall_jax:.4e}; at least half)")
        check(all(math.isfinite(v) for v in s.loss_log), f"{leg}: finite "
              "losses")
        warm = captured(s, L)
        check(n == ((L + warm, L + warm) if fused else (0, 0))
              and plain_calls.n == 0,
              f"{leg}: one forward and one backward launch a step (and in "
              "the warm-up step) on 'fused_train' and none on PINN, no "
              "plain call")
        if fused:
            # the committor's backward on the lanes kernel, the Hessian's
            # dense sigma on the shared plan
            want = "device" if tag == "committor" else "shared"
            check(by_plan[want] == n[1], f"{leg}: all {n[1]} backward "
                  f"launches on the {want} plan ({by_plan})")
        check(tail <= bound, f"{leg}: tail-50 test L2 {tail:.4e} > "
              f"{bound:.4e}")
        check(fall >= 0.5 * fall_jax, f"{leg}: the test L2 fell by "
              f"{fall:.4e}, less than half of JAX's {fall_jax:.4e}")
        if leg == "committor_diffusion":
            committor_leg = s
        if fused:
            launches[tag] = n
        profile_steps(f"3 steps of {leg}", s.step)
    print(f"  card: {smi}")
    print(f"  phases 27-29 took {time.perf_counter() - t_phases:.1f} s")

    rows = []
    for tag in fams:
        (r, b_fwd, b_bwd), (rb, bb_fwd, bb_bwd) = (times[tag, 200],
                                                   times[tag, Kb])
        prob, d, N_leg, N = fams[tag][:4]
        # the main keys at phase 29's launches' shape (K=200, the leg's N);
        # the *_K65536 keys phase 28's timed call at K_BR_BENCH
        row = {"route": "cuda",
               "shape": f"{type(prob).__name__}, d={d}, K=200, N={N_leg}",
               "shape_K65536": f"{type(prob).__name__}, d={d}, K={Kb}, "
                               f"N={N}",
               "launches_shape": f"phase 29's {tag}_diffusion leg, d={d}, "
                                 f"K=200, N={N_leg}"}

        def at_kb(name, res, bound):
            out = {"ms_K65536": res[name][0],
                   "device_ms_K65536": res[name][2],
                   "plain_ms_K65536": res[name][1],
                   "bound_ms_K65536": bound["bound_ms"]}
            if name == "backward" and "other plan" in res:
                out["other_plan_device_ms_K65536"] = res["other plan"][2]
            return out

        bwd_other = ({"other_plan": {"shared": "device",
                                     "device": "shared"}[b_bwd["plan"]],
                      "other_plan_ms": r["other plan"][0],
                      "other_plan_device_ms": r["other plan"][2]}
                     if "other plan" in r else {})
        rows += [
            dict(row, name=f"fused_stopped_train_rollout.forward.{tag}",
                 source=STOPPED_SOURCE,
                 replaces="pspde/rollout/kernels.py:1184",
                 launches=launches[tag][0], max_abs_err=worst[tag]["out"],
                 ms=r["forward"][0], device_ms=r["forward"][2],
                 plain_ms=r["forward"][1], **b_fwd,
                 **at_kb("forward", rb, bb_fwd)),
            dict(row, name=f"fused_stopped_train_rollout.backward.{tag}",
                 source=(LANES_SOURCE if b_bwd["plan"] == "device"
                         else STOPPED_SOURCE),
                 replaces="pspde/rollout/kernels.py:1272",
                 launches=launches[tag][1],
                 max_abs_err=max(worst[tag]["grad"], worst[tag]["bwd"]),
                 ms=r["backward"][0], device_ms=r["backward"][2],
                 plain_ms=r["backward"][1], **b_bwd, **bwd_other,
                 **at_kb("backward", rb, bb_bwd))]
    return rows, committor_leg


def allen_cahn_phases(dev, smi):
    """Phases 30-32: the cubic family of the stopped kernels (h = y - y^3
    with the clock, AllenCahn's) and the backward's device plan against
    their plain versions at the notebook's width, the device plan forced
    against the shared plan on the older families (bitwise), the times at
    K=65536, and the notebook's diffusion leg through 'fused_train' from
    JAX's initial net against JAX's runs; 20 steps of the BSDE leg.
    Returns the kernels' JSON rows and the diffusion leg, which phase 38
    refines."""
    import numpy as np
    from pspde_torch.ansatz import DenseNet
    from pspde_torch.problems import (AllenCahn, ExponentialOnBallNonlinearSin,
                                      ExponentialOnSphereNonlinearParabolic,
                                      FokkerPlanckEigen, Geometry,
                                      HeatEquation)
    from pspde_torch.rollout import kernels as km
    from pspde_torch.rollout.sampling import sample_domain
    from pspde_torch.solvers import GeneralSolver
    from pspde_torch.utils.convert import (dense_net_from_flax,
                                           load_control_npz)

    t_phases = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(root, "experiments"))
    from torch_kernel_times import device_ms
    gen = torch.Generator(device=dev).manual_seed(30)
    ac = AllenCahn(d=D_AC, T=T_AC, device=dev)
    # the notebook's sampling ball (experiments/allen_cahn.py)
    ac.geometry = Geometry(kind="unbounded", boundary_distance=R_AC)

    def ac_net(seed, relu=False):
        # weight scale 0.05 keeps V within O(1) on the radius-7 ball, as the
        # notebook's V is; at the default 0.1 V reaches O(5) there, and V^3
        # in h with the adaptive drift carries Y and X past float32's range
        # in the plain version and the kernels alike
        return DenseNet(1, NET_AC, d_in=D_AC + 1, output_relu=relu,
                        weight_scale=0.05, device=dev,
                        generator=torch.Generator(dev).manual_seed(seed))

    def starts(prob, K, d, square=False):
        X0 = sample_domain(gen, prob.geometry, K, d, uniform_square=square)
        T = prob.T if prob.T is not None else 0.0
        return X0, torch.rand(K, generator=gen, device=dev) * T

    def ac_call(net, K, N):
        X0, t0 = starts(ac, K, D_AC, True)
        return km._StoppedCall(
            ac, net, X0, t0, N, DT_AC, 17,
            km._check_stopped_family(ac, net, "erfinv", time_stopping=True),
            dict(adaptive_forward=False, rng="erfinv", host_noise=None,
                 time_stopping=True), None)

    # -- phase 30: the cubic family and the device plan vs plain ------------
    t30 = time.perf_counter()
    Kc = K_AC_CHECK
    print(f"phase 30: the cubic family (h = y - y^3, the clock) vs plain, "
          f"AllenCahn(d={D_AC}, T={T_AC}) on the ball of radius {R_AC}, "
          f"DenseNet {NET_AC} on [x, t], K={Kc} and K={K_AC}, N={N_AC}, dt "
          f"{DT_AC}: the forward on the block kernel, the backward on its "
          f"device plan; outputs rel {REL_TOL:g} and equal clocks and exit "
          f"steps on all paths, gradients {GRAD_TOL:g} and the backward on "
          f"plain cotangents {BWD_REL_TOL:g} x max|plain|, two launches "
          "bitwise equal, the forward bitwise across its layouts and against "
          "the lanes kernel (stopped_fwd_kernel) forced at its own layout "
          "and at one thread a path")
    worst = {"out": 0.0, "grad": 0.0, "bwd": 0.0}
    for K in (Kc, K_AC):
        probe = ac_call(ac_net(1), K, N_AC)
        fwd_packed, bwd_packed = probe.pack(False), probe.pack(True)
        print(f"  K={K}: forward {fwd_layout_name(fwd_packed)}, net "
              f"{'staged' if fwd_packed.iargs[6] else 'read from device memory'}"
              f" (stage {fwd_packed.iargs[6]}); backward: "
              f"{bwd_layout(bwd_packed, dev)}")
        check(bwd_packed.layout[0] == "device",
              "the notebook net's backward takes the device plan")
        check(km._stopped_fwd_block_of(fwd_packed) is not None,
              "the notebook net's forward takes the block kernel")
        X0, t0 = starts(ac, K, D_AC, True)
        noise = torch.randn((N_AC, K, D_AC), generator=gen, device=dev)
        for relu, adaptive, cases in (
                (False, False, ("erfinv", "binom", "host noise")),
                (False, True, ("erfinv",)),
                (True, False, ("erfinv",)),
                (True, True, ("binom",))):
            net = ac_net(1 + 2 * relu + adaptive, relu)
            for what in cases:
                kw = (dict(host_noise=noise) if what == "host noise"
                      else dict(seed=4321, rng=what))
                compare_stopped(
                    f"[allen_cahn K={K}{', adaptive' if adaptive else ''}"
                    f"{', clamp' if relu else ''}, {what}]", ac, net, X0, t0,
                    N_AC, DT_AC, dict(kw, adaptive_forward=adaptive), worst,
                    0.0, time_stopping=True)
        del noise
    X0, t0 = starts(ac, Kc, D_AC, True)
    # the net the main path trains from, JAX's seed-42 initial net, on the
    # main path's drift; with the adaptive drift its V carries the plain
    # version itself past float32 on a few paths (printed, not checked)
    tree, _ = load_control_npz(os.path.join(root, "pspde_torch", "assets",
                                            "allen_cahn_d100_densenet.npz"))
    jax_net = dense_net_from_flax(tree, device=dev)
    compare_stopped("[allen_cahn, JAX's initial net, erfinv]", ac, jax_net,
                    X0, t0, N_AC, DT_AC, dict(seed=4321, rng="erfinv"),
                    worst, 0.0, time_stopping=True)
    wild = km.reference_stopped_train_rollout(
        ac, jax_net, X0, t0, N_AC, DT_AC, seed=4321, adaptive_forward=True,
        time_stopping=True)
    Y = wild.Y.detach()
    with torch.no_grad():
        v0 = jax_net(torch.cat([X0, t0[:, None]], dim=-1))[:, 0]
    print(f"  JAX's initial net with the adaptive drift, the plain version: "
          f"V(X0, t0) in [{float(v0.min()):.2f}, {float(v0.max()):.2f}], Y "
          f"non-finite on {int((~torch.isfinite(Y)).sum())} of {Kc} paths, "
          f"|Y| up to {float(Y[torch.isfinite(Y)].abs().max()):.3e} on the "
          "others (not compared)")
    del wild, Y
    print(f"  phase 30 took {time.perf_counter() - t30:.1f} s")

    # -- phase 31: the device plan against the shared plan -------------------
    t31 = time.perf_counter()
    print("phase 31: the backward's device plan (the lanes kernel), forced "
          "at tile 64, against the shared plan on the older families at "
          "widths where both fit (the same grid): bitwise equal gradient "
          "rows and block counts at the chosen layout (4 threads a lane) and "
          "at 2 threads a lane with the arrays in the workspace and the net "
          "in device memory; the block forward forced against "
          "stopped_fwd_kernel on the same inputs: bitwise equal outputs; "
          "the same backward checks on the Schroedinger family and the "
          "committor (whose main paths take the lanes kernel) against the "
          "shared plan forced, with and without the clamp, adaptive or not")
    ball = ExponentialOnBallNonlinearSin(d=D_ELL, alpha=ALPHA_ELL,
                                         device=dev)
    gen50 = ExponentialOnSphereNonlinearParabolic(d=D_GEN, device=dev)
    heat = HeatEquation(d=D_HEAT, T=T_HEAT, device=dev)
    heat.geometry = Geometry(kind="unbounded", boundary_distance=R_HEAT)
    torus = FokkerPlanckEigen(d=D_EIG, device=dev)
    fams = {  # problem, d_in, K, N, dt, time_stopping, lambda, clamp
        "elliptic": (ball, D_ELL, K_ELL_CHECK, N_ELL, DT_ELL, False, None,
                     False),
        "gen50": (gen50, D_GEN + 1, K_ELL_CHECK, N_GEN, DT_GEN, True, None,
                  False),
        "heat": (heat, D_HEAT + 1, K_HEAT, N_HEAT, DT_HEAT, True, None,
                 True),
        "torus": (torus, D_EIG, K_EIG_CHECK, N_EIG, DT_EIG, False,
                  torch.full((1,), LAM_EIG, device=dev), True),
    }
    plan_err = 0.0
    for tag, (prob, d_in, K, N, dt, clock, lam, relu) in fams.items():
        for adaptive in (False, True):
            net = DenseNet(1, (30, 30), d_in=d_in, output_relu=relu,
                           device=dev, generator=torch.Generator(
                               dev).manual_seed(31 + adaptive))
            X0, t0 = starts(prob, K, prob.d)
            if not clock:
                t0 = torch.zeros_like(t0)
            call = km._StoppedCall(
                prob, net, X0, t0, N, dt, 4321,
                km._check_stopped_family(prob, net, "erfinv", clock, lam),
                dict(adaptive_forward=adaptive, rng="erfinv",
                     host_noise=None, time_stopping=clock), None, lam)
            gY = torch.randn(K, generator=gen, device=dev) / K
            # the block forward forced against the lanes kernel, which
            # stages these nets
            fwd_l = km._stopped_forward_kernel(call)
            block = call._replace(fwd_kernel="block")
            fwd_b = km._stopped_forward_kernel(block)
            torch.cuda.synchronize()
            fwd_same = all(torch.equal(a, b) for a, b in zip(fwd_l, fwd_b))
            print(f"  [{tag}{', adaptive' if adaptive else ''}] the block "
                  f"forward forced ({fwd_layout_name(block.pack(False))}) "
                  f"against stopped_fwd_kernel "
                  f"({fwd_layout_name(call.pack(False))}): seven outputs "
                  f"bitwise equal {fwd_same}, "
                  f"{float(fwd_l.adv_steps.sum()):.0f} advancing path-steps")
            check(fwd_same, f"{tag}: the block forward's outputs equal "
                  "stopped_fwd_kernel's bitwise")
            shared = call.pack(backward=True)
            check(shared.layout[0] == "shared", f"{tag}: the shared plan")
            grid = km._stopped_bwd_grid(shared, dev)
            rows_s = km._stopped_backward_rows(call, gY, grid)
            forced = call._replace(plan="device", tile=64)
            lay = km._stopped_bwd_lane_of(forced.pack(backward=True))
            rows_d = km._stopped_backward_rows(forced, gY, grid)
            again = km._stopped_backward_rows(forced, gY, grid)
            other = km._stopped_backward_rows(
                call._replace(bwd_layout=(64, 2, False, False)), gY, grid)
            torch.cuda.synchronize()
            err = max(float((rows_s[0] - r[0]).abs().max())
                      for r in (rows_d, other))
            plan_err = max(plan_err, err)
            print(f"  [{tag}{', adaptive' if adaptive else ''}] K={K}, "
                  f"N={N}, {grid} blocks, device plan {tuple(lay)} and "
                  f"(64, 2, False, False): device - shared max |row| "
                  f"{err:.3e}; block counts equal "
                  f"{torch.equal(rows_s[1], rows_d[1])}")
            check(all(torch.equal(rows_s[0], r[0])
                      and torch.equal(rows_s[1], r[1])
                      for r in (rows_d, other)),
                  f"{tag}: the device plan's gradient rows and block counts "
                  "equal the shared plan's bitwise")
            check(all(torch.equal(a, b) for a, b in zip(rows_d, again)),
                  f"{tag}: two launches of the device plan differ")
    from pspde_torch.ansatz import DenseNetTanh
    from pspde_torch.problems import (Committor,
                                      ExponentialOnBallNonlinearSinHessian,
                                      SchrodingerEigen)
    com = Committor(d=D_COM, device=dev)
    sch = SchrodingerEigen(d=D_SCH, device=dev)
    new_fams = {  # problem, d, K, N, dt, lambda, the net of a seed and clamp
        "schrodinger": (sch, D_SCH, K_SCH_CHECK, N_SCH, DT_SCH,
                        torch.full((1,), LAM_SCH, device=dev),
                        lambda seed, relu: DenseNetTanh(
                            1, NET_SCH, d_in=D_SCH, output_relu=relu,
                            device=dev,
                            generator=torch.Generator(dev).manual_seed(
                                seed))),
        "committor": (com, D_COM, K_BR_CHECK, N_COM, DT_BR, None,
                      lambda seed, relu: DenseNet(
                          1, (30, 30), d_in=D_COM, output_relu=relu,
                          device=dev,
                          generator=torch.Generator(dev).manual_seed(seed)))}
    for tag, (prob, d, K, N, dt, lam, net_of) in new_fams.items():
        X0 = sample_domain(gen, prob.geometry, K, d)
        t0 = torch.zeros(K, device=dev)
        gY = torch.randn(K, generator=gen, device=dev) / K
        for relu in (False, True):
            for adaptive in (False, True):
                net = net_of(31 + 2 * relu + adaptive, relu)
                call = km._StoppedCall(
                    prob, net, X0, t0, N, dt, 4321,
                    km._check_stopped_family(prob, net, "erfinv", lam=lam),
                    dict(adaptive_forward=adaptive, rng="erfinv",
                         host_noise=None, time_stopping=False), None, lam)
                check(call.pack(backward=True).layout[0] == "device",
                      f"{tag}: the main path's backward on the lanes kernel")
                shared = call._replace(plan="shared")
                grid = km._stopped_bwd_grid(shared.pack(backward=True), dev)
                rows_s = km._stopped_backward_rows(shared, gY, grid)
                forced = call._replace(plan="device", tile=64)
                lay = km._stopped_bwd_lane_of(forced.pack(backward=True))
                rows_d = km._stopped_backward_rows(forced, gY, grid)
                again = km._stopped_backward_rows(forced, gY, grid)
                other = km._stopped_backward_rows(
                    call._replace(bwd_layout=(64, 2, False, False)), gY,
                    grid)
                torch.cuda.synchronize()
                err = max(float((rows_s[0] - r[0]).abs().max())
                          for r in (rows_d, other))
                plan_err = max(plan_err, err)
                what = (f"{tag}{', clamp' if relu else ''}"
                        f"{', adaptive' if adaptive else ''}")
                print(f"  [{what}] K={K}, N={N}, {grid} blocks, device plan "
                      f"{tuple(lay)} and (64, 2, False, False): device - "
                      f"shared max |row| {err:.3e}; block counts equal "
                      f"{torch.equal(rows_s[1], rows_d[1])}")
                check(all(torch.equal(rows_s[0], r[0])
                          and torch.equal(rows_s[1], r[1])
                          for r in (rows_d, other)),
                      f"{what}: the device plan's gradient rows and block "
                      "counts equal the shared plan's bitwise")
                check(all(torch.equal(a, b) for a, b in zip(rows_d, again)),
                      f"{what}: two launches of the device plan differ")
    hes = ExponentialOnBallNonlinearSinHessian(d=D_HES, alpha=1.0,
                                               device=dev)
    hnet = DenseNet(1, (30, 30), d_in=D_HES, device=dev)
    try:
        km._StoppedCall(
            hes, hnet, torch.zeros((64, D_HES), device=dev),
            torch.zeros(64, device=dev), N_HES, DT_BR, 0,
            km._check_stopped_family(hes, hnet, "erfinv"),
            dict(adaptive_forward=False, rng="erfinv", host_noise=None),
            None, plan="device").pack(backward=True)
        raised = ""
    except ValueError as e:
        raised = str(e)
    print(f"  a dense sigma (the Hessian) on the device plan raises: "
          f"{raised[:100]}")
    check("Queue 2 item 4(f)" in raised, "the device plan of a dense sigma "
          "raises, naming ROADMAP.md Queue 2 item 4(f)")
    cnet = DenseNet(1, (30, 30), d_in=D_COM, device=dev)
    try:
        km._StoppedCall(
            com, cnet, torch.zeros((64, D_COM), device=dev),
            torch.zeros(64, device=dev), N_COM, DT_BR, 0,
            km._check_stopped_family(com, cnet, "erfinv"),
            dict(adaptive_forward=False, rng="erfinv", host_noise=None),
            None, fwd_kernel="block").pack(backward=False)
        raised = ""
    except ValueError as e:
        raised = str(e)
    print(f"  the committor on the block forward raises: {raised[:100]}")
    check("ROADMAP.md" in raised, "the block forward of a breadth family "
          "without it raises, naming ROADMAP.md")
    print(f"  phase 31 took {time.perf_counter() - t31:.1f} s")

    # -- phase 32: times, the notebook's leg and the BSDE leg ---------------
    t32 = time.perf_counter()
    Kb = K_AC_BENCH
    print(f"phase 32: timing at K={Kb}, N={N_AC}, d={D_AC} (the Allen-Cahn "
          f"pair: the forward on the block kernel, the backward on its "
          f"device plan; both kernels' layouts at K={K_AC} and K={Kb}) and "
          f"the device plan "
          f"forced at the elliptic cell (d={D_ELL}, K={K_ELL_BENCH}, "
          f"N={N_ELL}, DenseNet (30, 30)); erfinv Philox noise; CUDA events "
          "and the profiler's device time")
    net = ac_net(5)
    call = ac_call(net, Kb, N_AC)
    gY = torch.randn(Kb, generator=gen, device=dev) / Kb
    out = km._stopped_forward_kernel(call)
    hit, adv = float(out.hitting.sum()), float(out.adv_steps.sum())
    n_par = sum(p.numel() for p in net.parameters())
    v_f, fwd_f, bwd_f = stopped_flops(net, D_AC, adaptive=False, cubic=True)
    packed = call.pack(backward=True)
    ws_bytes = bwd_layout(packed, dev)["workspace_bytes"]
    # the block forward reads the packed net and its transpose once
    n_wt = km._stopped_wt(net).numel()
    b_fwd = roofline((hit - adv) * v_f + adv * fwd_f,
                     4 * (n_par + n_wt + Kb * (2 * D_AC + 7)))
    b_bwd = stopped_bwd_roofline(adv, bwd_f, net,
                                 4 * (2 * n_par + Kb * (D_AC + 2))
                                 + ws_bytes)
    use = lane_use(call, out, gY)
    print_lane_use("allen_cahn", use)
    fwd_use = fwd_lane_use(call, dev)
    print_fwd_lane_use("allen_cahn", fwd_use)

    def kern_times(tag, call, gY, reps=(10, 5), plain=True):
        r = {}
        for name, kern_fn, plain_fn, n, key in (
                ("forward", lambda: km._stopped_forward_kernel(call),
                 lambda: call.plain(), reps[0], "stopped_fwd"),
                ("backward", lambda: km._stopped_backward_kernel(call, gY),
                 lambda: km._reference_stopped_backward(call, gY), reps[1],
                 "stopped_bwd")):
            p1 = timed(plain_fn, 1) if plain else None
            k = [timed(kern_fn, n), timed(kern_fn, n)]
            p2 = timed(plain_fn, 1) if plain else None
            dms, seen = device_ms(kern_fn, n, key)
            r[name] = (min(k), min(p1, p2) if plain else None, dms)
            print(f"  {tag:22s} {name:8s} kernel {k[0]:.3f}, {k[1]:.3f} ms "
                  f"(device {'none' if dms is None else f'{dms:.3f}'} ms a "
                  f"launch over the {seen} of {n} launches the profiler "
                  "recorded)" + (f"; plain {p1:.3f}, {p2:.3f} ms"
                                 if plain else ""))
        return r

    times = kern_times("allen_cahn", call, gY)
    print(f"  allen_cahn: {hit:.0f} active and {adv:.0f} advancing "
          f"path-steps of K N = {Kb * N_AC}; the device plan's workspace "
          f"{ws_bytes} bytes; bound forward {b_fwd['bound_ms']:.4f} ms "
          f"({b_fwd['bound_by']}), backward {b_bwd['bound_ms']:.4f} ms "
          f"({b_bwd['bound_by']}; all FP32 {b_bwd['bound_ms_fp32']:.4f})")
    # the device plan forced at the elliptic cell, beside the shared plan
    enet = DenseNet(1, (30, 30), d_in=D_ELL, device=dev,
                    generator=torch.Generator(dev).manual_seed(5))
    X0e = sample_domain(gen, ball.geometry, K_ELL_BENCH, D_ELL)
    ecall = km._StoppedCall(
        ball, enet, X0e, torch.zeros(K_ELL_BENCH, device=dev), N_ELL,
        DT_ELL, 17, km._check_stopped_family(ball, enet, "erfinv"),
        dict(adaptive_forward=False, rng="erfinv", host_noise=None), None)
    egY = torch.randn(K_ELL_BENCH, generator=gen, device=dev) / K_ELL_BENCH
    eout = km._stopped_forward_kernel(ecall)
    e_adv = float(eout.adv_steps.sum())
    dcall = ecall._replace(plan="device")
    d_lay = bwd_layout(dcall.pack(backward=True), dev)
    d_ws = d_lay["workspace_bytes"]
    shared_t = kern_times("elliptic, shared plan", ecall, egY, plain=False)
    device_t = kern_times("elliptic, device plan", dcall, egY)
    # the device plan forced through the entry point, counted from 0: the
    # launches of the row below
    reset_counts(km.fused_stopped_train_rollout, "launches",
                 "backward_launches", "backward_launches_by_plan")
    pub = km.fused_stopped_train_rollout(
        ball, enet, X0e, torch.zeros(K_ELL_BENCH, device=dev), N_ELL, DT_ELL,
        17, plan="device")
    g_pub = torch.autograd.grad((pub.Y * egY).sum(), list(enet.parameters()))
    torch.cuda.synchronize()
    fst = km.fused_stopped_train_rollout
    d_launches = (fst.launches, dict(fst.backward_launches_by_plan))
    g_direct = km._stopped_backward_kernel(dcall, egY)
    print(f"  fused_stopped_train_rollout(plan='device') at the elliptic "
          f"cell: launches forward {d_launches[0]}, backward by plan "
          f"{d_launches[1]}; its gradients equal the forced call's bitwise "
          f"{all(torch.equal(a, b) for a, b in zip(g_pub, g_direct))}")
    check(d_launches == (1, {"shared": 0, "device": 1})
          and all(torch.equal(a, b) for a, b in zip(g_pub, g_direct)),
          "plan='device' through fused_stopped_train_rollout: one launch of "
          "each kernel, the backward on the device plan, its gradients the "
          "forced call's bitwise")
    del pub, g_pub, g_direct
    e_par = sum(p.numel() for p in enet.parameters())
    _, _, e_bwd_f = stopped_flops(enet, D_ELL, adaptive=False)
    b_dev = stopped_bwd_roofline(e_adv, e_bwd_f, enet,
                                 4 * (2 * e_par + K_ELL_BENCH * (D_ELL + 1))
                                 + d_ws)
    print(f"  elliptic: {e_adv:.0f} advancing path-steps; the device plan "
          f"{d_lay}; backward shared "
          f"{shared_t['backward'][0]:.3f} ms, device "
          f"{device_t['backward'][0]:.3f} ms; device-plan bound "
          f"{b_dev['bound_ms']:.4f} ms ({b_dev['bound_by']})")
    print(f"  card: {smi}")

    # the notebook's diffusion leg from JAX's initial net
    lo, hi = min(AC_V00_JAX), max(AC_V00_JAX)
    mean = float(np.mean(AC_V00_JAX))
    w = max(hi - lo, 0.1 * abs(mean))
    print(f"  the notebook's diffusion leg: GeneralSolver(AllenCahn(d={D_AC}"
          f"), loss_method='diffusion', N={N_AC}, delta_t={DT_AC}, K={K_AC}, "
          f"K_boundary={KB_AC}, lr 1e-3, alpha (10, 1, 1), uniform_square, "
          f"loss_with_stopped=False, DenseNet {NET_AC}, radius {R_AC}, "
          f"rollout_mode='fused_train'), {L_AC} steps from JAX's initial net "
          "(experiments/allen_cahn_reference.py)")
    common = dict(seed=42, delta_t=DT_AC, lr=1e-3, K=K_AC, K_boundary=KB_AC,
                  uniform_square=True, loss_with_stopped=False,
                  rollout_mode="fused_train", verbose=False, device=dev)

    def leg(name, L, **kw):
        s = GeneralSolver(ac, name, L=L, value_net=ac_net(0), **common,
                          **kw)
        s.load_jax_params(tree)
        check(s.resolved_rollout_mode == "fused_train",
              f"{name}: engine {s.resolved_rollout_mode}")
        return s

    def v00(s):
        with torch.no_grad():
            return float(s.V(torch.zeros((1, D_AC), device=dev),
                             torch.zeros((1,), device=dev))[0])

    s = leg("allen_cahn_diffusion", L_AC, loss_method="diffusion", N=N_AC,
            alpha=(10.0, 1.0, 1.0))
    v_init = v00(s)
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with PlainCalls(km) as plain_calls:
        s.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    *n, by_plan, by_kernel = counted(
        km.fused_stopped_train_rollout, "launches", "backward_launches",
        "backward_launches_by_plan", "launches_by_kernel")
    n = tuple(n)
    v_end = v00(s)
    tail = float(np.mean(s.loss_log[-50:]))
    move = abs(v_end - v_init)
    move_jax = abs(mean - AC_V00_INIT_JAX)
    print(f"  [diffusion] {len(s.loss_log)} steps in {wall:.2f} s "
          f"({1e3 * wall / len(s.loss_log):.3f} ms a step); launches forward "
          f"{n[0]} (by kernel {by_kernel}), backward {n[1]} (by plan "
          f"{by_plan}); plain-version calls "
          f"{plain_calls.n}; loss every 200: "
          f"{['%.3e' % v for v in s.loss_log[::200]]}; tail-50 loss "
          f"{tail:.4e} (bound 3x JAX's {AC_TAIL_JAX:.4e}); v(0, 0) "
          f"{v_init:.6f} -> {v_end:.6f} (JAX {AC_V00_INIT_JAX:.6f} -> "
          f"{['%.6f' % v for v in AC_V00_JAX]}, band [{lo - w:.6f}, "
          f"{hi + w:.6f}]; moved {move:.6f}, at least half of JAX's "
          f"{move_jax:.6f}); the literature's {AC_V00_LITERATURE} after "
          "~60k steps (not checked)")
    check(all(math.isfinite(v) for v in s.loss_log), "diffusion leg: finite "
          "losses")
    warm = captured(s, L_AC)
    check(n == (L_AC + warm, L_AC + warm) and by_plan["device"] == L_AC + warm
          and by_kernel == {"lanes": 0, "block": L_AC + warm}
          and plain_calls.n == 0,
          "diffusion leg: one forward and one backward launch a step (and in "
          "the warm-up step), every forward on the block kernel, every "
          "backward on the device plan, no plain call")
    check(lo - w <= v_end <= hi + w, f"diffusion leg: v(0, 0) {v_end:.6f} "
          f"outside [{lo - w:.6f}, {hi + w:.6f}]")
    check(tail <= 3.0 * AC_TAIL_JAX, f"diffusion leg: tail-50 loss "
          f"{tail:.4e} > 3 x {AC_TAIL_JAX:.4e}")
    check(move >= 0.5 * move_jax, f"diffusion leg: v(0, 0) moved {move:.6f},"
          f" less than half of JAX's {move_jax:.6f}")
    leg_launches = n
    profile_steps(f"3 steps of the Allen-Cahn diffusion leg (K={K_AC})",
                  s.step)

    # the device plan's layouts at the notebook's K (the trained net) and at
    # K_AC_BENCH: each candidate's device time, its gradients at the
    # notebook's K against tile 64's
    scall = ac_call(s.V_net, K_AC, N_AC)
    sgY = torch.randn(K_AC, generator=gen, device=dev) / K_AC
    sweep = bwd_layout_sweep({f"K={K_AC}": (scall, sgY, 3),
                              f"K={Kb}": (call, gY, 2)})
    fsweep = fwd_layout_sweep({f"K={K_AC}": (scall, 10, FWD_SWEEP["small"]),
                               f"K={Kb}": (call, 2, FWD_SWEEP["large"])})
    s_out = km._stopped_forward_kernel(scall)
    s_adv = float(s_out.adv_steps.sum())
    s_hit = float(s_out.hitting.sum())
    s_fwd = roofline((s_hit - s_adv) * v_f + s_adv * fwd_f,
                     4 * (n_par + n_wt + K_AC * (2 * D_AC + 7)))
    s_fwd_use = fwd_lane_use(scall, dev)
    print_fwd_lane_use(f"allen_cahn at K={K_AC}", s_fwd_use)
    print(f"  the block forward at K={K_AC}: {s_hit:.0f} active and "
          f"{s_adv:.0f} advancing path-steps, device "
          f"{fsweep['chosen'][f'K={K_AC}']:.4f} ms at the chosen layout, bound "
          f"{s_fwd['bound_ms']:.4f} ms ({s_fwd['bound_by']})")
    s_use = lane_use(scall, s_out, sgY)
    print_lane_use(f"allen_cahn at K={K_AC}", s_use)
    s_bwd = stopped_bwd_roofline(s_adv, bwd_f, net, 4 * (
        2 * n_par + K_AC * (D_AC + 2)) + bwd_layout(
            scall.pack(backward=True), dev)["workspace_bytes"])
    print(f"  the chosen layout at K={K_AC}: "
          f"{bwd_layout(scall.pack(backward=True), dev)}, {s_adv:.0f} "
          f"advancing path-steps, bound {s_bwd['bound_ms']:.4f} ms "
          f"({s_bwd['bound_by']}; all FP32 {s_bwd['bound_ms_fp32']:.4f})")

    # the same recipe on the scan engine, beside 'fused_train', from JAX's
    # initial net: step times at the notebook's K and at K_AC_CHECK
    def recipe(K, mode):
        r = GeneralSolver(ac, f"allen_cahn_{mode}", L=L_AC,
                          value_net=ac_net(0),
                          **dict(common, K=K, rollout_mode=mode),
                          loss_method="diffusion", N=N_AC,
                          alpha=(10.0, 1.0, 1.0))
        r.load_jax_params(tree)
        check(r.resolved_rollout_mode == mode, f"{mode} at K={K}: engine "
              f"{r.resolved_rollout_mode}")
        return r

    engines = {}
    for K, reps in ((K_AC, 10), (K_AC_CHECK, 3)):
        solvers = {m: recipe(K, m) for m in ("fused_train", "scan")}
        per = {m: [] for m in solvers}
        for m in solvers:
            solvers[m].step()
        for m in ("fused_train", "scan", "scan", "fused_train"):
            per[m] += [timed(solvers[m].step, 1, warm=False)
                       for _ in range(reps)]
        med = engines[K] = {m: float(np.median(v)) for m, v in per.items()}
        print(f"  engines at K={K}, N={N_AC}, {2 * reps} steps each "
              f"(fused, scan, scan, fused): " + "; ".join(
                  f"{m} median {med[m]:.2f} ms (min {min(v):.2f}, max "
                  f"{max(v):.2f})" for m, v in per.items())
              + f"; scan / fused {med['scan'] / med['fused_train']:.3f}")
        check(all(math.isfinite(v) for sv in solvers.values()
                  for v in sv.loss_log), f"engines at K={K}: finite losses")
        if K == K_AC:
            profile_steps(f"3 steps of the scan engine (K={K})",
                          solvers["scan"].step)
        del solvers

    b = leg("allen_cahn_bsde", L_AC_BSDE, loss_method="BSDE", N=N_AC_BSDE,
            alpha=(1.0, 1.0, 1.0))
    reset_counts(km.fused_stopped_train_rollout, "launches",
                 "backward_launches", "launches_by_kernel")
    step_ms = [timed(b.step, 1, warm=False) for _ in range(L_AC_BSDE)]
    n_b = (km.fused_stopped_train_rollout.launches,
           km.fused_stopped_train_rollout.backward_launches)
    b_kernel = dict(km.fused_stopped_train_rollout.launches_by_kernel)
    print(f"  [BSDE] N={N_AC_BSDE}: {L_AC_BSDE} steps, median "
          f"{float(np.median(step_ms)):.2f} ms (min {min(step_ms):.2f}, max "
          f"{max(step_ms):.2f}); launches forward {n_b[0]} (by kernel "
          f"{b_kernel}), backward {n_b[1]}; loss "
          f"{['%.3e' % v for v in b.loss_log[::5]]}; "
          f"advancing path-steps a step {np.mean(b.K_log):.0f} of K N = "
          f"{K_AC * N_AC_BSDE}")
    check(n_b == (L_AC_BSDE, L_AC_BSDE) and b_kernel["block"] == L_AC_BSDE
          and all(math.isfinite(v) for v in b.loss_log),
          "BSDE leg: one launch of each kernel a step, the forward on the "
          "block kernel, finite losses")
    print(f"  card: {smi}")
    print(f"  phase 32 took {time.perf_counter() - t32:.1f} s; phases 30-32 "
          f"{time.perf_counter() - t_phases:.1f} s")

    row = {"route": "cuda", "source": STOPPED_SOURCE,
           "shape": f"AllenCahn, d={D_AC}, DenseNet {NET_AC} on [x, t], "
                    f"K={Kb}, N={N_AC}",
           "launches_shape": f"phase 32's diffusion leg, K={K_AC}, "
                             f"N={N_AC}"}
    rows = [
        dict(row, name="fused_stopped_train_rollout.forward.block.allen_cahn",
             kernel="stopped_fwd_block_kernel",
             replaces="pspde/rollout/kernels.py:1184",
             launches=leg_launches[0], max_abs_err=worst["out"],
             ms=times["forward"][0], device_ms=times["forward"][2],
             plain_ms=times["forward"][1],
             **dict(b_fwd, layout=fwd_use["layout"],
                    lane_use=fwd_use["lane_use"],
                    device_ms_at_K200=fsweep["chosen"][f"K={K_AC}"],
                    bound_ms_at_K200=s_fwd["bound_ms"],
                    layout_device_ms={tag: {str(tuple(lay)): ms
                                            for lay, ms in v.items()}
                                      for tag, v in fsweep["ms"].items()},
                    step_ms={f"K={K}": med for K, med in engines.items()})),
        dict(row, name="fused_stopped_train_rollout.backward.allen_cahn",
             source=LANES_SOURCE,
             replaces="pspde/rollout/kernels.py:1272", plan="device",
             launches=leg_launches[1],
             max_abs_err=max(worst["grad"], worst["bwd"]),
             ms=times["backward"][0], device_ms=times["backward"][2],
             plain_ms=times["backward"][1], workspace_bytes=ws_bytes,
             **dict(b_bwd, lanes=use[0], layout=bwd_layout(packed, dev),
                    device_ms_at_K200=sweep["chosen"][f"K={K_AC}"],
                    bound_ms_at_K200=s_bwd["bound_ms"],
                    lanes_at_K200=s_use[0],
                    layout_device_ms={tag: {str(lay): ms
                                            for lay, ms in v.items()}
                                      for tag, v in sweep["ms"].items()})),
        dict(row, name="fused_stopped_train_rollout.backward.device_plan",
             source=LANES_SOURCE,
             replaces="pspde/rollout/kernels.py:1272", plan="device",
             shape=f"ExponentialOnBallNonlinearSin, d={D_ELL}, DenseNet "
                   f"(30, 30), K={K_ELL_BENCH}, N={N_ELL}, the device plan "
                   "forced",
             launches_shape=f"phase 32's fused_stopped_train_rollout("
                            f"plan='device') at the elliptic cell, "
                            f"K={K_ELL_BENCH}, N={N_ELL}",
             launches=d_launches[1]["device"], max_abs_err=plan_err,
             ms=device_t["backward"][0], device_ms=device_t["backward"][2],
             plain_ms=device_t["backward"][1],
             shared_plan_ms=shared_t["backward"][0],
             workspace_bytes=d_ws, **b_dev)]
    return rows, s


def schrodinger_phases(dev, smi):
    """Phases 33-35: the Schroedinger family of the stopped kernels (zero
    drift on the square, h = -y^3 - y pot(x) + lambda y, the tanh features
    of DenseNetTanh, the output clamp) against its plain version, the times
    of both kernels and of the notebook's step on both engines, and the
    EigenSolver main path from JAX's initial net against JAX's runs.
    Returns the kernels' JSON rows and the main path's solver, which phase
    38 refines."""
    import numpy as np
    from pspde_torch.ansatz import DenseNetTanh
    from pspde_torch.problems import SchrodingerEigen
    from pspde_torch.rollout import kernels as km
    from pspde_torch.rollout.sampling import sample_domain
    from pspde_torch.solvers import EigenSolver
    from pspde_torch.utils.convert import (eigen_params_from_flax,
                                           load_control_npz)

    t_phases = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(root, "experiments"))
    from torch_kernel_times import device_ms
    d, N, dt = D_SCH, N_SCH, DT_SCH
    sch = SchrodingerEigen(d=d, device=dev)
    gen = torch.Generator(device=dev).manual_seed(33)
    tree, _ = load_control_npz(os.path.join(
        root, "pspde_torch", "assets", "schrodinger_d10_densenet_tanh.npz"))

    def net_of(seed, clamp=True):
        return DenseNetTanh(1, NET_SCH, output_relu=clamp, d_in=d,
                            device=dev,
                            generator=torch.Generator(dev).manual_seed(seed))

    jax_net, jax_lam = eigen_params_from_flax(tree, output_relu=True,
                                              device=dev, cls=DenseNetTanh)

    # -- phase 33: the Schroedinger family vs plain --------------------------
    t33 = time.perf_counter()
    Kc = K_SCH_CHECK
    print(f"phase 33: Schroedinger kernels vs plain, SchrodingerEigen(d={d}),"
          f" K={Kc}, N={N}, dt={dt}, lambda={LAM_SCH}, DenseNetTanh "
          f"{NET_SCH} with the clamp and without, and JAX's initial net; "
          f"outputs rel {REL_TOL:g} on agreeing paths, exit-step "
          f"disagreements <= {MASK_TOL:g} K, loss gradients {GRAD_TOL:g} "
          f"and the backward on plain cotangents {BWD_REL_TOL:g} x "
          "max|plain|, two launches bitwise equal, the forward bitwise "
          "across its layouts; the backward on the lanes kernel, its rows "
          "bitwise across the other layouts of its tile; the same at the "
          f"notebook's K={K_SCH}")
    probe_lam = torch.full((1,), LAM_SCH, device=dev)
    probe = km._StoppedCall(
        sch, jax_net, torch.zeros((Kc, d), device=dev),
        torch.zeros(Kc, device=dev), N, dt, 0,
        km._check_stopped_family(sch, jax_net, "erfinv", lam=probe_lam),
        dict(adaptive_forward=False, rng="erfinv", host_noise=None,
             time_stopping=False), None, probe_lam)
    fwd_packed = probe.pack(False)
    lay = km._FwdLayout(*fwd_packed.layout)
    print(f"  forward: {lay.tile} lanes x {lay.tpp} threads, "
          f"{'refilled' if lay.refill else 'one block a tile'}, net "
          f"{'staged' if fwd_packed.iargs[6] else 'from device memory'}")
    for K in (K_SCH, Kc, K_SCH_BENCH):
        bwd_packed = probe._replace(X0=torch.zeros((K, d), device=dev),
                                    t0=torch.zeros(K, device=dev)).pack(True)
        print(f"  backward at K={K}: {bwd_layout(bwd_packed, dev)}")
        check(bwd_packed.layout[0] == "device", f"the notebook net's "
              f"backward at K={K}: the lanes kernel")
    worst = {"out": 0.0, "grad": 0.0, "bwd": 0.0}
    cases = [("clamp", True, False, ("host noise", "erfinv", "binom")),
             ("clamp", True, True, ("host noise", "erfinv", "binom")),
             ("no clamp", False, False, ("erfinv",)),
             ("no clamp", False, True, ("binom",)),
             ("JAX's initial net", None, False, ("erfinv",)),
             ("JAX's initial net", None, True, ("binom",))]
    # at the check K and at the notebook's, where the main path launches
    # the backward: there both instantiations (the clamp or not) and JAX's
    # initial net, one case a net and the clamp's also adaptive (the
    # script's time limit)
    small = [("clamp", True, False, ("erfinv",)),
             ("clamp", True, True, ("binom",)),
             ("no clamp", False, False, ("erfinv",)),
             ("JAX's initial net", None, False, ("erfinv",))]
    for K, g, K_cases in (
            (Kc, gen, cases),
            (K_SCH, torch.Generator(device=dev).manual_seed(330), small)):
        X0 = sample_domain(g, sch.geometry, K, d)
        noise = torch.randn((N, K, d), generator=g, device=dev)
        for tag, clamp, adaptive, maps in K_cases:
            net = (jax_net if clamp is None
                   else net_of(1 + 2 * clamp + adaptive, clamp))
            for what in maps:
                kw = (dict(host_noise=noise) if what == "host noise"
                      else dict(seed=4321, rng=what))
                compare_eigen(f"[schrodinger{'' if K == Kc else f' K={K}'}"
                              f", {tag}{', adaptive' if adaptive else ''}, "
                              f"{what}]", sch, net, X0, N, dt,
                              dict(kw, adaptive_forward=adaptive), worst,
                              lam_value=LAM_SCH)
        del noise
    print(f"  phase 33 took {time.perf_counter() - t33:.1f} s")

    # -- phase 34: times -----------------------------------------------------
    t34 = time.perf_counter()
    print(f"phase 34: timing at K={K_SCH} and K={K_SCH_BENCH}, N={N}, d={d}, "
          f"DenseNetTanh {NET_SCH} with the clamp (JAX's initial net), "
          f"lambda {LAM_SCH}, erfinv Philox noise; CUDA events and the "
          "profiler's device time a launch, the backward on both plans (the "
          "lanes kernel chosen, the shared plan forced); the notebook's step "
          "on 'fused_train' and on 'scan'")

    def recipe(K, mode, L=L_SCH):
        s = EigenSolver(
            sch, f"schroedinger-{mode}", seed=42, delta_t=dt, N=N, lr=1e-3,
            lambda_init=-2.0, L=L, K=K, K_boundary=KB_SCH,
            alpha=(50.0, 1.0), normalization="l2_penalty",
            value_net=net_of(0), rollout_mode=mode, verbose=False,
            device=dev)
        s.load_jax_params(tree)
        check(s.resolved_rollout_mode == mode,
              f"{mode} at K={K}: engine {s.resolved_rollout_mode}")
        return s

    times = {}
    for K in (K_SCH, K_SCH_BENCH):
        X0 = sample_domain(gen, sch.geometry, K, d)
        t0b = torch.zeros(K, device=dev)
        lam = torch.full((1,), LAM_SCH, device=dev)
        gY = torch.randn(K, generator=gen, device=dev) / K
        call = km._StoppedCall(
            sch, jax_net, X0, t0b, N, dt, 17,
            km._check_stopped_family(sch, jax_net, "erfinv", lam=lam),
            dict(adaptive_forward=False, rng="erfinv", host_noise=None,
                 time_stopping=False), None, lam)
        probe = km._stopped_forward_kernel(call)
        hit = float(probe.hitting.sum())
        adv = float(probe.adv_steps.sum())
        n_par = sum(p.numel() for p in jax_net.parameters()) + 1
        _, fwd_f, bwd_f = stopped_flops(jax_net, d, adaptive=False, sch=True)
        # on the square a step that stops still forms its proposal
        b_fwd = roofline(hit * fwd_f, 4 * (n_par + K * (2 * d + 7)))
        b_bwd = stopped_bwd_roofline(adv, bwd_f, jax_net,
                                     4 * (2 * n_par + K * (d + 2)))
        use = lane_use(call, probe, gY, torus=True)
        print_lane_use(f"K={K}", use)
        fwd_use = fwd_lane_use(call, dev)
        print_fwd_lane_use(f"K={K}", fwd_use)

        def plain_fwd():
            with torch.no_grad():
                call.plain()

        shared = call._replace(plan="shared")
        check(call.pack(backward=True).layout[0] == "device",
              f"K={K}: the backward on the lanes kernel")
        r = {}
        for name, kern_fn, plain_fn, reps, key in (
                ("forward", lambda: km._stopped_forward_kernel(call),
                 plain_fwd, 20, "stopped_fwd_kernel"),
                ("backward", lambda: km._stopped_backward_kernel(call, gY),
                 lambda: km._reference_stopped_backward(call, gY), 10,
                 BWD_KEY["device"]),
                ("shared plan",
                 lambda: km._stopped_backward_kernel(shared, gY), None, 10,
                 BWD_KEY["shared"])):
            p1 = timed(plain_fn, 1) if plain_fn else None
            k = [timed(kern_fn, reps), timed(kern_fn, reps)]
            p2 = timed(plain_fn, 1) if plain_fn else None
            dms, seen = device_ms(kern_fn, reps, key)
            r[name] = (min(k), None if p1 is None else min(p1, p2), dms)
            print(f"  K={K:6d} {name:11s} kernel {k[0]:.3f}, {k[1]:.3f} ms "
                  f"(device {'none' if dms is None else f'{dms:.4f}'} ms a "
                  f"launch over the {seen} of {reps} launches the profiler "
                  f"recorded)" + ("" if p1 is None else
                                  f"; plain {p1:.3f}, {p2:.3f} ms"))
        print(f"  K={K}: {hit:.0f} active and {adv:.0f} advancing path-steps "
              f"of K N = {K * N}; bound forward {b_fwd['bound_ms']:.5f} ms, "
              f"backward {b_bwd['bound_ms']:.5f} ms (all FP32 "
              f"{b_bwd['bound_ms_fp32']:.5f}; {b_fwd['bound_by']})")
        times[K] = (r, dict(b_fwd, layout=fwd_use["layout"]),
                    dict(b_bwd, lanes=use[0],
                         layout=bwd_layout(call.pack(backward=True), dev)))
    # the notebook's step at K=500 on both engines, from JAX's initial net:
    # fused, scan, scan, fused
    solvers = {m: recipe(K_SCH, m, L=1) for m in ("fused_train", "scan")}
    per = {m: [] for m in solvers}
    for m in solvers:
        solvers[m].step()
    for m in ("fused_train", "scan", "scan", "fused_train"):
        per[m] += [timed(solvers[m].step, 1, warm=False) for _ in range(10)]
    engines = {m: float(np.median(v)) for m, v in per.items()}
    print(f"  the notebook's step at K={K_SCH}, 20 steps each (fused, scan, "
          "scan, fused): " + "; ".join(
              f"{m} median {engines[m]:.2f} ms (min {min(v):.2f}, max "
              f"{max(v):.2f})" for m, v in per.items())
          + f"; scan / fused {engines['scan'] / engines['fused_train']:.3f}")
    for m in ("fused_train", "scan"):
        profile_steps(f"3 EigenSolver steps on {m}, K={K_SCH}",
                      solvers[m].step)
    check(all(math.isfinite(v) for s in solvers.values()
              for v in s.loss_log), "the notebook's steps: finite losses")
    del solvers
    print(f"  card: {smi}")
    print(f"  phase 34 took {time.perf_counter() - t34:.1f} s")

    # -- phase 35: the main path ---------------------------------------------
    t35 = time.perf_counter()
    lo, hi = min(SCH_LAMBDA_TAIL_JAX), max(SCH_LAMBDA_TAIL_JAX)
    lam_mean = float(np.mean(SCH_LAMBDA_TAIL_JAX))
    move_jax = abs(lam_mean - SCH_LAMBDA_FIRST_JAX)
    w = max(hi - lo, 0.1 * move_jax)
    print(f"phase 35: EigenSolver(SchrodingerEigen(d={d}), "
          f"rollout_mode='fused_train'), experiments/eigenvalue_schroedinger"
          f".py's d=10 recipe: DenseNetTanh {NET_SCH} with the clamp, lr "
          f"1e-3, lambda_init -2, K={K_SCH}, K_boundary={KB_SCH}, alpha (50, "
          f"1), 'l2_penalty', N={N}, dt={dt}, {L_SCH} steps from JAX's "
          "initial net (experiments/schrodinger_reference.py)")
    main = recipe(K_SCH, "fused_train")
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with PlainCalls(km) as plain_calls:
        main.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counted(km.fused_stopped_train_rollout, "launches",
                       "backward_launches")
    by_plan = counted(km.fused_stopped_train_rollout,
                      "backward_launches_by_plan")
    steps = len(main.loss_log)
    lam_tail = main.lambda_tail_mean()
    lam_first = main.lambda_log[0]
    v_tail = float(np.mean(main.V_L2_log[-100:]))
    v_bound = 3.0 * SCH_V_L2_TAIL_JAX
    move = abs(lam_tail - lam_first)
    print(f"  {steps} steps in {wall:.2f} s ({1e3 * wall / steps:.3f} ms a "
          f"step); launches forward {launches[0]}, backward {launches[1]} "
          f"(by plan {by_plan}); plain-version calls {plain_calls.n}; "
          f"lambda every 200: "
          f"{['%.4f' % v for v in main.lambda_log[::200]]}; V_L2 every 200: "
          f"{['%.3e' % v for v in main.V_L2_log[::200]]}")
    jax_tails = ['%.4f' % v for v in SCH_LAMBDA_TAIL_JAX]
    print(f"  lambda {lam_first:.4f} -> tail mean {lam_tail:.4f} (JAX "
          f"{SCH_LAMBDA_FIRST_JAX} -> {jax_tails}, band [{lo - w:.4f}, {hi + w:.4f}]; moved {move:.4f}, at least "
          f"half of JAX's {move_jax:.4f}); tail-100 V_L2 {v_tail:.4e} (bound "
          f"3x JAX's {SCH_V_L2_TAIL_JAX:.4e})")
    warm = captured(main, steps)
    check(launches[1] == steps + warm and launches[0] >= steps + warm
          and plain_calls.n == 0,
          "the main path: one backward launch a step (and in the warm-up "
          "step), at least one forward launch a step, no plain call")
    check(by_plan["device"] == launches[1], f"the main path: all "
          f"{launches[1]} backward launches on the lanes kernel ({by_plan})")
    check(all(math.isfinite(v) for v in main.loss_log + main.lambda_log
              + main.V_L2_log), "finite losses, lambdas and V_L2")
    check(lo - w <= lam_tail <= hi + w, f"lambda tail mean {lam_tail:.4f} "
          f"outside [{lo - w:.4f}, {hi + w:.4f}]")
    check(v_tail <= v_bound, f"tail-100 V_L2 {v_tail:.4e} > {v_bound:.4e}")
    check(move >= 0.5 * move_jax, f"lambda moved {move:.4f}, less than half "
          f"of JAX's {move_jax:.4f}")
    reset_counts(km.fused_stopped_train_rollout, "launches")
    t0 = time.perf_counter()
    lam_hat, lam_se = main.estimate_lambda(K=8192, n_batches=16)
    print(f"  estimate_lambda (K=8192, 16 batches, two forward launches each:"
          f" {km.fused_stopped_train_rollout.launches}): {lam_hat:.4f} +- "
          f"{lam_se:.1e} in {time.perf_counter() - t0:.2f} s (lambda_true "
          f"{sch.lambda_true}; printed, not checked)")
    check(km.fused_stopped_train_rollout.launches == 32
          and math.isfinite(lam_hat) and math.isfinite(lam_se),
          "estimate_lambda ran on the kernel")
    profile_steps(f"3 steps of the main path (K={K_SCH})", main.step)
    print(f"  card: {smi}")
    print(f"  phase 35 took {time.perf_counter() - t35:.1f} s; phases 33-35 "
          f"{time.perf_counter() - t_phases:.1f} s")

    (r, b_fwd, b_bwd), (rb, bb_fwd, bb_bwd) = (times[K_SCH],
                                               times[K_SCH_BENCH])
    row = {"route": "cuda",
           "shape": f"SchrodingerEigen, d={d}, DenseNetTanh {NET_SCH} with "
                    f"the clamp, K={K_SCH}, N={N}, lambda",
           "launches_shape": f"phase 35's {L_SCH} steps, K={K_SCH}"}
    rows = [
        dict(row, name="fused_stopped_train_rollout.forward.schrodinger",
             source=STOPPED_SOURCE,
             replaces="pspde/rollout/kernels.py:1184", launches=launches[0],
             max_abs_err=worst["out"], ms=r["forward"][0],
             device_ms=r["forward"][2], plain_ms=r["forward"][1], **b_fwd,
             ms_K65536=rb["forward"][0], device_ms_K65536=rb["forward"][2],
             plain_ms_K65536=rb["forward"][1],
             bound_ms_K65536=bb_fwd["bound_ms"],
             layout_K65536=bb_fwd["layout"],
             step_ms={m: v for m, v in engines.items()}),
        dict(row, name="fused_stopped_train_rollout.backward.schrodinger",
             source=LANES_SOURCE, plan="device",
             replaces="pspde/rollout/kernels.py:1272", launches=launches[1],
             max_abs_err=max(worst["grad"], worst["bwd"]),
             ms=r["backward"][0], device_ms=r["backward"][2],
             plain_ms=r["backward"][1], **b_bwd,
             shared_plan_ms=r["shared plan"][0],
             shared_plan_device_ms=r["shared plan"][2],
             ms_K65536=rb["backward"][0], device_ms_K65536=rb["backward"][2],
             plain_ms_K65536=rb["backward"][1],
             bound_ms_K65536=bb_bwd["bound_ms"],
             layout_K65536=bb_bwd["layout"],
             shared_plan_device_ms_K65536=rb["shared plan"][2]),
    ]
    return rows, main


# phase 36: steps_per_call, each leg trained for 2 n + r steps once at one
# step per call and once at n per call (one captured CUDA graph of n steps,
# replayed), then CHUNK_TIMED chunks of n steps timed per mode with CUDA
# events, and profiled: one chunk captured, CHUNK_PROFILED eager steps (the
# profiler's processing of an eager chunk's ~40k kernels took ~20 s a leg)
CHUNK_N, CHUNK_R, CHUNK_TIMED, CHUNK_PROFILED = 50, 7, 2, 10
# eager step() calls timed one by one (phase 34's way) after each eager chunk
def same_training(a, b, logs=None):
    """The names of the logs (``logs``, or the solvers' ``_LOG_ATTRS`` but
    the times), state tensors (parameters, Adam's state) and generator
    states in which solvers a and b differ (empty: bitwise equal)."""
    import numpy as np
    logs = logs or [k for k in a._LOG_ATTRS if k != "times"]
    bad = [k for k in logs if not (
        np.shape(getattr(a, k)) == np.shape(getattr(b, k))
        and np.array_equal(np.asarray(getattr(a, k), dtype=np.float64),
                           np.asarray(getattr(b, k), dtype=np.float64),
                           equal_nan=True))]
    sa, sb = a._state_tensors(), b._state_tensors()
    bad += [k for k in sa if k not in sb or not torch.equal(sa[k], sb[k])]
    ga = dict(a._chunk_generators(), _seed_gen=a._seed_gen)
    gb = dict(b._chunk_generators(), _seed_gen=b._seed_gen)
    bad += [k for k in ga if not torch.equal(ga[k].get_state(),
                                             gb[k].get_state())]
    return bad


STEPS_TIMED = 5
# the kernels of the training legs, as the profiler names them
TRAIN_KERNELS = ("train_forward_kernel", "train_backward_kernel",
                 "stopped_fwd_kernel", "stopped_fwd_block_kernel",
                 "stopped_bwd_kernel", "stopped_bwd_lane_kernel")


def chunk_phase(dev, smi, llgc):
    """Phase 36: steps_per_call on six training legs (the HJB export
    recipe, the LQGC 'outer' scan, the committor's diffusion and PINN legs,
    the Allen-Cahn and the Schroedinger notebook steps), each trained from
    one seed for 2 n + r steps at one step per call and at n per call: the
    logs, the parameters, Adam's state and the generators' states bitwise
    equal; the step time of each mode (CUDA events over whole chunks), its
    idle share (torch.profiler over one chunk), the graph's replays and
    the training kernels' launches.  Then a step with a host sync under
    an explicit steps_per_call: the capture raises naming the op, and no
    step runs."""
    import gc
    import weakref

    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from pspde_torch.ansatz import DenseNet, DenseNetTanh, LinearLQ
    from pspde_torch.problems import (LQGC, AllenCahn, Committor,
                                      ExponentialOnBallNonlinearSin,
                                      Geometry, SchrodingerEigen)
    from pspde_torch.rollout import kernels as km
    from pspde_torch.solvers import (EigenSolver, EllipticSolver,
                                     GeneralSolver, HJBSolver)
    from pspde_torch.utils.convert import load_control_npz

    t36 = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    n, L = CHUNK_N, 2 * CHUNK_N + CHUNK_R

    def asset(name):
        return load_control_npz(os.path.join(root, "pspde_torch", "assets",
                                             name))[0]

    lq = LQGC(d=10, T=0.5, delta_t=0.05, device=dev)
    com = Committor(d=D_COM, device=dev)
    ac = AllenCahn(d=D_AC, T=T_AC, device=dev)
    ac.geometry = Geometry(kind="unbounded", boundary_distance=R_AC)
    sch = SchrodingerEigen(d=D_SCH, device=dev)
    trees = {"committor": asset("committor_d10_densenet.npz"),
             "allen_cahn": asset("allen_cahn_d100_densenet.npz"),
             "schrodinger": asset("schrodinger_d10_densenet_tanh.npz")}

    def hjb_export(spc):
        return HJBSolver("chunk-hjb", llgc, lr=1e-2, L=L, K=1024,
                         delta_t=DT_TRAIN, time_approx="inner",
                         loss_method="log-variance", detach_forward=True,
                         learn_Y_0=True, verbose=False,
                         early_stopping_time=None, seed=42,
                         rollout_mode="fused_train", steps_per_call=spc,
                         device=dev)

    def lqgc_outer(spc):
        return HJBSolver("chunk-lq", lq, lr=1e-2, L=L, K=512, delta_t=0.05,
                         time_approx="outer", loss_method="log-variance",
                         detach_forward=True, learn_Y_0=False,
                         control_net=LinearLQ(lq.B, lq.Q, device=dev,
                                              generator=torch.Generator()
                                              .manual_seed(26)),
                         early_stopping_time=None, verbose=False,
                         steps_per_call=spc, device=dev)

    def committor(spc, **kw):
        s = EllipticSolver(com, "chunk-com", seed=42, delta_t=DT_BR, N=N_COM,
                           lr=1e-3, L=L, K=200, K_boundary=50,
                           K_test_log=10000, loss_with_stopped=False,
                           verbose=False, steps_per_call=spc, device=dev,
                           **kw)
        s.load_jax_params(trees["committor"])
        return s

    def allen_cahn(spc):
        s = GeneralSolver(ac, "chunk-ac", seed=42, delta_t=DT_AC, lr=1e-3,
                          L=L, K=K_AC, K_boundary=KB_AC, uniform_square=True,
                          loss_with_stopped=False, loss_method="diffusion",
                          N=N_AC, alpha=(10.0, 1.0, 1.0),
                          value_net=DenseNet(1, NET_AC, d_in=D_AC + 1,
                                             weight_scale=0.05, device=dev),
                          rollout_mode="fused_train", verbose=False,
                          steps_per_call=spc, device=dev)
        s.load_jax_params(trees["allen_cahn"])
        return s

    def schrodinger(spc):
        s = EigenSolver(sch, "chunk-sch", seed=42, delta_t=DT_SCH, N=N_SCH,
                        lr=1e-3, lambda_init=-2.0, L=L, K=K_SCH,
                        K_boundary=KB_SCH, alpha=(50.0, 1.0),
                        normalization="l2_penalty",
                        value_net=DenseNetTanh(1, NET_SCH, output_relu=True,
                                               d_in=D_SCH, device=dev),
                        rollout_mode="fused_train", verbose=False,
                        steps_per_call=spc, device=dev)
        s.load_jax_params(trees["schrodinger"])
        return s

    legs = {
        "hjb_export (LLGC d=100, K=1024, N=32, fused_train)":
            (hjb_export, "fused_train_rollout"),
        "lqgc_outer (LQGC d=10, LinearLQ 'outer', K=512, N=10, scan)":
            (lqgc_outer, None),
        f"committor_diffusion (d={D_COM}, K=200, N={N_COM}, fused_train)":
            (lambda spc: committor(spc, alpha=(10.0, 1.0),
                                   loss_method="diffusion",
                                   rollout_mode="fused_train"),
             "fused_stopped_train_rollout"),
        f"committor_pinn (d={D_COM}, K=200, PINN)":
            (lambda spc: committor(spc, alpha=(1e-3, 1.0),
                                   loss_method="PINN"), None),
        f"allen_cahn (d={D_AC}, K={K_AC}, N={N_AC}, GeneralSolver "
        "fused_train)": (allen_cahn, "fused_stopped_train_rollout"),
        f"schrodinger (d={D_SCH}, K={K_SCH}, N={N_SCH}, EigenSolver "
        "fused_train)": (schrodinger, "fused_stopped_train_rollout"),
    }
    print(f"phase 36: steps_per_call on six legs, each from one seed for "
          f"L = 2 x {n} + {CHUNK_R} = {L} steps at 1 and at {n} steps per "
          f"call (one captured CUDA graph, replayed): logs, parameters, "
          f"Adam's state and the generators bitwise equal, the launches "
          f"that the kernels counted on the device; then, interleaved, "
          f"{CHUNK_TIMED} chunks of {n} steps a mode through train() and "
          f"{CHUNK_TIMED} x {STEPS_TIMED} eager step() calls each of the "
          f"trained solver, of a fresh one (phase 34's timing) and of the "
          f"trained one without the cyclic GC, timed with CUDA events; one "
          f"captured chunk and "
          f"{CHUNK_PROFILED} eager steps profiled; card: {smi}")

    def logs_of(s):
        return {k: v for k, v in vars(s).items() if isinstance(v, list)
                and not k.startswith("_") and k != "times"}

    def totals(counts):
        return {k[0] + "." + k[1]: v for k, v in counts.items()
                if len(k) == 2 and v}

    def chunk_ms(s):
        """ms a step of the next n steps of ``s`` through train()."""
        s.L = s.iteration + n
        return timed(s.train, 1, warm=False) / n

    def profiled_chunk(s, steps):
        """Wall and device ms a step, idle share and launches over the next
        ``steps`` steps of ``s`` under torch.profiler (CUDA activity): the
        kernels the profiler recorded, the training kernels' launches it
        recorded and those the kernels counted on the device."""
        s.L = s.iteration + steps
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            # one kernel and a sync before the window, so that the
            # tracer is running when the window's first launch comes
            torch.ones(1, device=dev).add_(1.0)
            torch.cuda.synchronize()
            zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s.train()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        dev_us, kernels, train_k = 0.0, 0, {}
        for ev in prof.key_averages():
            t = getattr(ev, "self_device_time_total",
                        getattr(ev, "self_cuda_time_total", 0.0))
            if ev.device_type == DeviceType.CUDA and t > 0:
                dev_us += t
                kernels += ev.count
                for k in TRAIN_KERNELS:
                    if k in ev.key:
                        train_k[k] = train_k.get(k, 0) + ev.count
        # (the totals take in the add_ and zero_counts' zero_: two small
        # kernels)
        made = sum(totals(km.kernel_launch_counts()).values())
        return dict(wall_ms=1e3 * wall / steps,
                    device_ms=dev_us / 1e3 / steps,
                    idle=max(0.0, 1.0 - dev_us / 1e6 / wall), steps=steps,
                    kernels=kernels, train_recorded=sum(train_k.values()),
                    train_by_kernel=train_k, train_made=made)

    results = {}
    for name, (make, wrapper) in legs.items():
        t_leg = time.perf_counter()
        runs, launches, made = {}, {}, {}
        for spc in (1, n):
            s = make(spc)
            zero_counts()
            s.train()
            torch.cuda.synchronize()
            launches[spc] = totals(km.kernel_launch_counts())
            made[spc] = totals(km.launch_counts())
            runs[spc] = s
        a, b = runs[1], runs[n]
        la, sa = logs_of(a), a._state_tensors()
        gens = dict(a._chunk_generators(), _seed_gen=a._seed_gen)
        bad = same_training(a, b, list(la))
        g = b.graph_stats
        print(f"  [{name}] {L} steps: launches counted on the device, per "
              f"step {launches[1]}, chunked {launches[n]} (the warm-up "
              f"step's included); made eagerly (the wrappers' counts) "
              f"{made[1]} and {made[n]}; graph {g['captures']} capture, "
              f"{g['warmup_steps']} warm-up step, {g['replays']} replays, "
              f"resolved {b.resolved_steps_per_call}; {len(la)} logs, "
              f"{len(sa)} state tensors, {len(gens)} generators: "
              + ("bitwise equal" if not bad else f"DIFFER: {bad}"))
        check(not bad, f"{name}: per-step and chunked runs bitwise equal "
              f"(differ: {bad})")
        check(a.resolved_steps_per_call == 1 and a.graph_stats["replays"]
              == 0 and b.resolved_steps_per_call == n and g["captures"] == 1
              and g["replays"] == 2, f"{name}: one step per call, and two "
              f"replays of one graph of {n} steps ({g})")
        if wrapper is not None:
            key = f"{wrapper}.launches"
            bkey = f"{wrapper}.backward_launches"
            check(launches[1].get(key) == launches[1].get(bkey) == L
                  and launches[n].get(key) == launches[n].get(bkey) == L + 1,
                  f"{name}: one forward and one backward launch a step, and "
                  f"the warm-up step's ({launches})")
            # the eager launches are the wrappers'; the rest, the replays'
            check(made[1] == launches[1] and all(
                made[n].get(k) == launches[n][k] - g["replays"] * n
                for k in (key, bkey)), f"{name}: the device counts are the "
                f"wrappers' eager launches and the replays' ({made})")
        else:
            check(not launches[1] and not launches[n],
                  f"{name}: no training kernel ({launches})")
        # the eager step also as phase 34 times it (a fresh solver, one
        # untimed step), and without the cyclic garbage collector
        fresh = make(1)
        fresh.step()
        times = {"eager": [], "eager step()": [], "fresh step()": [],
                 "step(), no GC": [], "captured": []}
        for _ in range(CHUNK_TIMED):
            times["eager"].append(chunk_ms(a))
            times["eager step()"] += [timed(a.step, 1, warm=False)
                                      for _ in range(STEPS_TIMED)]
            times["fresh step()"] += [timed(fresh.step, 1, warm=False)
                                      for _ in range(STEPS_TIMED)]
            gc.disable()
            try:
                times["step(), no GC"] += [timed(a.step, 1, warm=False)
                                           for _ in range(STEPS_TIMED)]
            finally:
                gc.enable()
            times["captured"].append(chunk_ms(b))
        prof = {"eager": profiled_chunk(a, CHUNK_PROFILED),
                "captured": profiled_chunk(b, n)}
        results[name] = (times, prof)
        med = {m: float(np.median(v)) for m, v in times.items()}
        for m in ("eager step()", "fresh step()", "step(), no GC"):
            print(f"    {m} {med[m]:.3f} ms median of {len(times[m])} "
                  f"{['%.3f' % t for t in times[m]]}")
        for m in ("eager", "captured"):
            p = prof[m]
            # the profiler's wall carries its own cost a kernel; the device
            # time over the unprofiled step time reads the idle share
            # without it
            print(f"    {m:8s} step {med[m]:.3f} ms median of {CHUNK_TIMED} "
                  f"chunks of {n} through train() "
                  f"{['%.3f' % t for t in times[m]]}; profiled "
                  f"({p['steps']} steps) {p['wall_ms']:.3f} ms a step, "
                  f"device {p['device_ms']:.3f} ms a step, idle "
                  f"{100 * p['idle']:.1f}% (of the unprofiled step "
                  f"{100 * max(0.0, 1 - p['device_ms'] / med[m]):.1f}%), "
                  f"{p['kernels']} kernels recorded, of them "
                  f"{p['train_recorded']} training-kernel launches "
                  f"{p['train_by_kernel']}; the kernels counted "
                  f"{p['train_made']}")
            want = 2 * p["steps"] if wrapper is not None else 0
            check(p["train_made"] == want
                  and p["train_recorded"] <= p["train_made"],
                  f"{name}, {m}: the kernels counted {want} launches in the "
                  f"profiled window ({p['train_made']}), the profiler no "
                  f"more ({p['train_recorded']})")
        print(f"    speed-up {med['eager'] / med['captured']:.2f}x against "
              f"train(), {med['eager step()'] / med['captured']:.2f}x "
              f"against step(); replays {b.graph_stats['replays']}; leg "
              f"{time.perf_counter() - t_leg:.1f} s; card: {smi}")
        del runs, a, b, s, fresh

    # a step that cannot be captured: a host sync in h
    class SyncingH(ExponentialOnBallNonlinearSin):
        def h(self, x, y, z):
            if float(y.abs().max()) < 0.0:   # a host read of a device value
                return y
            return super().h(x, y, z)

    s = EllipticSolver(SyncingH(d=4, alpha=0.1, device=dev), "chunk-sync",
                       K=64, N=5, L=8, steps_per_call=4, verbose=False,
                       device=dev)
    try:
        s.train()
        raised = ""
    except RuntimeError as e:
        raised = str(e)
    print(f"  a host sync in h under steps_per_call=4 raises: {raised[:400]}")
    check("cannot be captured" in raised and "chip_smoke.py" in raised
          and "float(y.abs().max())" in raised and not s.loss_log,
          "the capture of a step with a host sync raises naming the op, and "
          "no step ran")

    # a captured graph that dies in a reference cycle while another graph
    # is captured: the cyclic collector (at a threshold of one allocation)
    # would destroy it inside the capture, which invalidates the capture;
    # pspde_torch/utils/capture.py:gc_held holds the collector off there
    class Holder:
        pass

    x = torch.zeros(8, device=dev)
    old = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream(device=dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        x.add_(1.0)
    torch.cuda.current_stream(dev).wait_stream(side)
    with torch.cuda.graph(old):
        x.add_(1.0)
    graphs, gone, gone_in_capture = [old], None, None
    del old

    class DroppingH(ExponentialOnBallNonlinearSin):
        def h(self, x, y, z):
            nonlocal gone, gone_in_capture
            if graphs and torch.cuda.is_current_stream_capturing():
                holder = Holder()              # a young cycle, its graph's
                holder.graph, holder.me = graphs.pop(), holder   # last ref
                gone = weakref.ref(holder)
                del holder
                [[] for _ in range(100)]       # allocations: a collection
                gone_in_capture = gone() is None
            return super().h(x, y, z)

    s = EllipticSolver(DroppingH(d=4, alpha=0.1, device=dev), "chunk-gc",
                       K=64, N=5, L=8, steps_per_call=4, verbose=False,
                       device=dev)
    threshold = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        s.train()
        raised = ""
    except RuntimeError as e:
        raised = str(e)
    finally:
        gc.set_threshold(*threshold)
    gc.collect()
    print(f"  a captured graph dropped into a dead cycle during another "
          f"capture, the collector at threshold 1: the capture "
          + (f"raised: {raised[:300]}" if raised else
             f"ran ({s.graph_stats}, {len(s.loss_log)} steps); the cycle "
             f"collected inside the capture: {gone_in_capture}, after it: "
             f"{gone is not None and gone() is None}"))
    check(not raised and s.graph_stats["captures"] == 1
          and len(s.loss_log) == 8 and gone_in_capture is False
          and gone is not None and gone() is None
          and all(map(math.isfinite, s.loss_log)),
          "a graph that dies during another capture is collected after it, "
          "and the capture holds")
    del s
    print(f"  phase 36 took {time.perf_counter() - t36:.1f} s")
    return results


# phase 37: the HJB loss-study notebooks.  (a) experiments/ou_linear_costs.py's
# d=40 cell (LLGC off_diag 0.1, seed 42; K=500, dt 0.01, lr 1e-3, 'inner',
# adaptive, IS with K=20000 every 10 steps) cut to OU_L of its 2000 steps
# on fused_train and OU_L_SCAN on the scan (100 both until phase 39 came;
# a scan step is ~0.2 s of host time), from JAX's initial net
# (experiments/hjb_notebooks_reference.py)
OU_D, OU_K, OU_L, OU_IS_K, OU_IS_ITER = 40, 500, 80, 20000, 10
OU_L_SCAN = 40
OU_LOSSES = (
    ("moment", dict(loss_method="moment", detach_forward=True,
                    learn_Y_0=True)),
    ("variance", dict(loss_method="variance", detach_forward=True)),
    ("log-variance", dict(loss_method="log-variance", detach_forward=True)),
    ("relative entropy", dict(loss_method="relative_entropy",
                              detach_forward=False)),
    ("cross-entropy", dict(loss_method="cross_entropy",
                           detach_forward=True)),
)
# (b) experiments/gradient_relative_errors.py in full: DoubleWell(d=1, eta=3,
# kappa=5), 'outer', dt 0.02, K=500, lr 1e-3, 200 steps, the relative
# gradient errors every 20; JAX's figures (CPU, experiments/
# hjb_notebooks_reference.py): the mean |rel| at the seed-42 initial net on
# its noise (pspde_torch/assets/double_well_d1_gv_noise.npz; the card and
# the CPU read one noise within 1e-4), the notebook's figure (the mean of
# grads_rel_error_log) under the sampling seeds 42 to 51 from that net,
# and the median, interquartile range and number of those runs' readings
# pooled.  A reading is a mean of ratios sqrt(Var)/Mean with single
# entries past 10^5 where a mean gradient passes near 0, so the notebook's
# figure has a long upper tail over seeds; the readings of the port's runs
# under DW_SEEDS are held to JAX's by their pooled medians, within three
# standard errors of the difference (normal theory: a median's standard
# error 1.2533 sigma / sqrt(n), sigma = IQR / 1.349).  The solver's own
# option runs per step to DW_STEP_L, against the seed-42 run bitwise; the
# seeds' steps run in captured chunks of DW_SPC
DW_L, DW_K, DW_CGV, DW_FIXED_RTOL = 200, 500, 20, 1e-3
DW_SEEDS, DW_STEP_L, DW_SPC = (42, 43), 21, 5   # 42-47 until phase 39
DW_REL_FIXED_JAX = {"moment": 54.351966857910156,
                    "log-variance": 87.88111877441406}
DW_POOLED_JAX = {"moment": (46.75161361694336, 35.23500728607178, 100),
                 "log-variance": (47.50172996520996, 30.447714805603027,
                                  100)}
DW_REL_GRAD_JAX = {
    "moment": (48.62316665649414, 59.653527450561526, 51.8752685546875,
               81.3914026260376, 61.66171569824219, 41.72494411468506,
               46.88967933654785, 62.70747127532959, 59.55976600646973,
               62.100069236755374),
    "log-variance": (50.43951988220215, 74.63630867004395,
                     60.104606246948244, 35.87673416137695,
                     52.3542839050293, 47.156186485290526,
                     74.18908767700195, 49.12348175048828,
                     48.73446044921875, 45.46357669830322)}
# (c) experiments/compare_loss_relative_errors.py: d = 1, 3, ..., 15, dt 0.005,
# K cut from the notebook's 5 10^7 to CMP_K; BASELINE.md's last row reads
# RE[log-variance] ~ 1.45 and RE[cross-entropy] ~ 2.4 1.30^d
CMP_K, CMP_DT, CMP_DIMS = 2 ** 22, 0.005, tuple(range(1, 16, 2))
# (d) the sqrt schedule against the per-step rollout at LLGC d=100, and one
# scan step at BASELINE config 5 (LLGC d=1000, T=2, N=200, K=98304, remat)
REMAT_K, REMAT_N = 8192, 200
REMAT_L, REMAT_SPC = 10, 5      # the schedule in captured chunks
# (e) resume: save at RESUME_L // 2 of RESUME_L steps
RESUME_L = 200


def llgc_log_e_euler(prob, dt):
    """log E[exp(-g(X_N))] of LLGC's uncontrolled Euler chain on the IS grid
    of step dt (N = ceil(T / dt)), float64: X_N is Gaussian with mean
    (I + A dt)^N x0 and covariance sum_j (I + A dt)^j B B^T (I + A dt)^jT
    dt, and g is linear, so log E = -alpha.m + alpha^T S alpha / 2; discrete
    Girsanov is exact for additive noise, so IS estimates this number up to
    its Monte-Carlo error."""
    import numpy as np
    N = int(np.ceil(prob.T / dt))
    dt = float(np.float32(dt))
    A, B = prob._A_np, prob._B_np
    M = np.eye(prob.d) + A * dt
    m = prob.X_0.detach().cpu().numpy().astype(np.float64)
    S = np.zeros((prob.d, prob.d))
    BB = B @ B.T * dt
    for _ in range(N):
        m = M @ m
        S = M @ S @ M.T + BB
    alpha = prob.alpha.detach().cpu().numpy().astype(np.float64)
    return float(-alpha @ m + 0.5 * alpha @ S @ alpha)


def loss_study_phase(dev, smi, llgc):
    """Phase 37: the loss-study notebooks on the card, (a) to (e)."""
    import tempfile

    import numpy as np
    from pspde_torch.ansatz import DenseNet
    from pspde_torch.eval import (gradient_variances,
                                  loss_estimator_statistics, relative_error)
    from pspde_torch.problems import LLGC, Committor, DoubleWell
    from pspde_torch.rollout import kernels as km
    from pspde_torch.rollout import sde
    from pspde_torch.solvers import EllipticSolver, HJBSolver
    from pspde_torch.utils.convert import load_control_npz, tanh_mlp_from_flax
    from pspde_torch.utils.schedule import cosine_decay_schedule

    t37 = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))

    def asset(name):
        return os.path.join(root, "pspde_torch", "assets", name)

    def synced(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # -- (a) OU linear costs at d=40 ------------------------------------------
    ta = time.perf_counter()
    ou = LLGC(d=OU_D, T=1.0, off_diag=0.1, seed=42, device=dev)
    log_e = llgc_log_e_euler(ou, 0.01)
    v0 = float(ou.v_ref(ou.X_0[None].to(torch.float32), 0.0)[0])
    print(f"phase 37 (a): experiments/ou_linear_costs.py at d={OU_D} "
          f"(LLGC off_diag 0.1, seed 42), K={OU_K}, dt 0.01 (N=100), lr "
          f"1e-3, 'inner', adaptive, IS at K={OU_IS_K} every {OU_IS_ITER} "
          f"steps from JAX's initial net; the five losses on the scan "
          f"({OU_L_SCAN} steps), the four detached ones on fused_train "
          f"({OU_L} steps); log E of the "
          f"Euler chain {log_e:.6f} (-v_ref(X_0, 0) = {-v0:.6f}, continuous "
          f"time); card: {smi}")

    def ou_solver(name, kw, engine, diagnostics=True):
        extra = (dict(IS_variance_K=OU_IS_K, IS_variance_iter=OU_IS_ITER)
                 if diagnostics else {})
        L = OU_L_SCAN if engine == "scan" else OU_L
        s = HJBSolver(name, ou, L=L, lr=1e-3, seed=42, delta_t=0.01,
                      K=OU_K, time_approx="inner",
                      adaptive_forward_process=True, print_every=10,
                      early_stopping_time=None, verbose=False,
                      rollout_mode=engine, device=dev, **extra, **kw)
        s.load_jax_params(asset("llgc_d40_tanhmlp.npz"))
        return s

    # the training kernels against their plain version at the legs' shape:
    # d=40 with dense A and B, the legs' TanhMLP (41, 30, 30, 40) from JAX's
    # initial net, K=500, N=100, dt 0.01, adaptive, the legs' u_tab; host
    # noise and the legs' Philox map
    probe = ou_solver("log-variance", dict(OU_LOSSES[2][1]), "fused_train",
                      diagnostics=False)
    worst = {"out": 0.0, "grad": 0.0}
    noise = torch.randn((probe.N, OU_K, OU_D), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(40))
    for tag, kw in (("host noise", dict(host_noise=noise)),
                    ("Philox, binom", dict(seed=4040, rng="binom"))):
        compare_train(f"[train d={OU_D}, the legs' net, u_tab, {tag}]", ou,
                      probe.z_net, OU_K, probe.N, probe.delta_t,
                      dict(kw, adaptive_forward=True, u_tab=probe._u_tab),
                      worst)
    print(f"  kernels 2-3 at the legs' shape: outputs within REL_TOL "
          f"{REL_TOL:g} (max |kern - plain| {worst['out']:.3e}), the "
          f"backward per leaf within {BWD_REL_TOL:g} (worst "
          f"{worst['grad_rel']:.3e}), the loss gradients within "
          f"{GRAD_TOL:g}")
    del probe, noise
    legs = {}
    for engine in ("scan", "fused_train"):
        for name, kw in OU_LOSSES:
            if engine == "fused_train" and not kw["detach_forward"]:
                continue
            s = ou_solver(name, kw, engine)
            check(s.resolved_rollout_mode == engine,
                  f"{name}: engine {s.resolved_rollout_mode}")
            zero_counts()
            _, wall = synced(s.train)
            u = s.u_L2_loss
            first, last = float(np.mean(u[:10])), float(np.mean(u[-10:]))
            launches = (counted(km.fused_train_rollout, "launches",
                                "backward_launches")
                        if engine == "fused_train" else (0, 0))
            print(f"  [{engine}, {name}] {len(u)} steps in {wall:.2f} s, "
                  f"{s.resolved_steps_per_call} a call; u_L2 mean of the "
                  f"first 10 {first:.4f}, of the last 10 {last:.4f}; loss "
                  f"{s.loss_log[-1]:.4e}; IS RE every {OU_IS_ITER} steps "
                  f"{['%.4f' % r for r in s.IS_rel_log]}; kernel launches "
                  f"(forward, backward) {launches}")
            check(len(s.IS_rel_log) == s.L // OU_IS_ITER
                  and all(math.isfinite(r) for r in s.IS_rel_log),
                  f"{engine}, {name}: {s.L // OU_IS_ITER} finite IS records")
            check(last < first, f"{engine}, {name}: u_L2 falls ({first:.4f} "
                  f"-> {last:.4f})")
            if engine == "fused_train":
                check(launches == (OU_L, OU_L)
                      and s.resolved_steps_per_call == 1
                      and s.graph_stats["captures"] == 0,
                      f"{name}: one forward and one backward launch a step, "
                      f"per step ({launches}, {s.graph_stats})")
            legs[(engine, name)] = s
    lv = legs[("fused_train", "log-variance")]
    (mean, var, rel), wall = synced(lambda: lv._is_runner(
        torch.Generator(device=dev).manual_seed(2027)))
    mean, rel = float(mean), float(rel)
    err = abs(math.log(mean) - log_e)
    bound = 5.0 * rel / math.sqrt(OU_IS_K)
    print(f"  the fused log-variance leg's IS runner, K={OU_IS_K}: mean "
          f"{mean:.6e} RE {rel:.4f}, |log mean - log E| {err:.3e} (5 SE "
          f"{bound:.3e}; against -v_ref(X_0, 0): "
          f"{abs(math.log(mean) + v0):.3e}), {1e3 * wall:.1f} ms")
    check(math.isfinite(mean) and err <= bound,
          f"IS runner |log mean - log E| {err:.3e} > {bound:.3e}")
    plain = ou_solver("log-variance", dict(OU_LOSSES[2][1]), "fused_train",
                      diagnostics=False)
    zero_counts()
    plain.train()
    launches = counted(km.fused_train_rollout, "launches")
    warm = captured(plain, OU_L)
    bad = same_training(lv, plain, ["loss_log", "u_L2_loss"])
    print(f"  the same leg without the diagnostics, chunked and captured: "
          f"{launches} forward launches; against the per-step run with them: "
          + ("bitwise equal" if not bad else f"DIFFER: {bad}"))
    check(not bad and launches == OU_L + warm,
          f"the diagnostics leave the fused log-variance leg as it is "
          f"(differ: {bad})")
    del legs, lv, plain
    print(f"  (a) took {time.perf_counter() - ta:.1f} s")

    # -- (b) relative errors of gradients ------------------------------------
    tb = time.perf_counter()
    dw = DoubleWell(d=1, T=1.0, eta=3.0, kappa=5.0, device=dev)
    dw.compute_reference_solution()
    print(f"phase 37 (b): experiments/gradient_relative_errors.py, "
          f"DoubleWell(d=1, eta=3, kappa=5) with its FD table, 'outer', dt "
          f"0.02 (N=50), K={DW_K}, lr 1e-3, {DW_L} steps, the relative "
          f"gradient errors every {DW_CGV} steps, from JAX's initial nets")
    noise = torch.as_tensor(np.load(asset("double_well_d1_gv_noise.npz"))
                            ["noise"], device=dev)
    for loss, jax_fixed in DW_REL_FIXED_JAX.items():
        s = HJBSolver(loss, dw, L=DW_L, lr=1e-3, seed=42, delta_t=0.02,
                      K=DW_K, time_approx="outer", loss_method=loss,
                      detach_forward=True, verbose=False, device=dev)
        s.load_jax_params(asset("double_well_d1_outer_densenet.npz"))
        rel, wall = synced(lambda: gradient_variances(s, host_noise=noise))
        m = float(torch.mean(torch.abs(rel)))
        big = int((rel.abs() > 1e3).sum())
        print(f"  [{loss}] at JAX's initial net on JAX's noise "
              f"(pspde_torch/assets/double_well_d1_gv_noise.npz): mean "
              f"|rel| {m:.4f} over {rel.numel()} entries ({big} above "
              f"1e3), JAX's {jax_fixed:.4f}, {wall:.2f} s")
        check(abs(m - jax_fixed) <= DW_FIXED_RTOL * abs(jax_fixed),
              f"{loss}: the relative gradient errors on JAX's noise read "
              f"{m:.4f}, JAX's {jax_fixed:.4f}")
    for loss, jax_runs in DW_REL_GRAD_JAX.items():
        def dw_solver(seed, L, **kw):
            s = HJBSolver(loss, dw, L=L, lr=1e-3, seed=seed, delta_t=0.02,
                          K=DW_K, time_approx="outer", loss_method=loss,
                          detach_forward=True, print_every=DW_CGV,
                          early_stopping_time=None, verbose=False,
                          device=dev, **kw)
            s.load_jax_params(asset("double_well_d1_outer_densenet.npz"))
            return s

        # the notebook's option, per step (its gate), to DW_STEP_L
        s = dw_solver(DW_SEEDS[0], DW_STEP_L,
                      compute_gradient_variance=DW_CGV)
        _, wall_step = synced(s.train)
        option = list(s.grads_rel_error_log)
        # each seed's ten readings: the steps in captured chunks (no
        # diagnostic: chunkable), the diagnostic between them after steps
        # 0, 20, ..., 180 from the solver's own generator, as the option
        # takes it; the steps after the last reading change none
        runs, graphs = {}, []
        t0 = time.perf_counter()
        for seed in DW_SEEDS:
            c = dw_solver(seed, 1, steps_per_call=DW_SPC)
            readings = []
            for stop in range(1, DW_L, DW_CGV):
                c.L = stop
                c.train()
                rel = gradient_variances(c, c._gv_gen)
                readings.append(float(torch.mean(torch.abs(rel))))
            runs[seed] = readings
            graphs.append(c.graph_stats)
            del c
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        means = [float(np.mean(r)) for r in runs.values()]
        pooled = [x for r in runs.values() for x in r]
        q1, med, q3 = np.percentile(pooled, [25, 50, 75])
        med_j, iqr_j, n_j = DW_POOLED_JAX[loss]
        limit = 3.0 * 1.2533 / 1.349 * math.sqrt(
            (q3 - q1) ** 2 / len(pooled) + iqr_j ** 2 / n_j)
        same = option == runs[DW_SEEDS[0]][:len(option)]
        print(f"  [{loss}] the option per step, seed {DW_SEEDS[0]}, "
              f"{DW_STEP_L} steps in {wall_step:.2f} s: readings "
              f"{['%.3f' % r for r in option]}, against the captured run's "
              + ("bitwise equal" if same else
                 f"DIFFER ({runs[DW_SEEDS[0]][:len(option)]})"))
        print(f"  [{loss}] seeds {DW_SEEDS[0]}-{DW_SEEDS[-1]}, "
              f"{DW_L // DW_CGV} readings each, {wall:.2f} s (graphs {graphs[0]}): the "
              f"notebook's figure {['%.2f' % m for m in means]} (median "
              f"{float(np.median(means)):.3f}; JAX's ten "
              f"{['%.2f' % m for m in jax_runs]}, median "
              f"{float(np.median(jax_runs)):.3f}); the {len(pooled)} "
              f"readings pooled: median {med:.3f}, IQR {q3 - q1:.3f}, above 100 "
              f"{sum(x > 100 for x in pooled)}; JAX's {n_j}: median "
              f"{med_j:.3f}, IQR {iqr_j:.3f}; |difference| "
              f"{abs(med - med_j):.3f} (limit {limit:.3f})")
        check(len(option) == (DW_STEP_L - 1) // DW_CGV + 1 and same,
              f"{loss}: the option's readings are the captured run's")
        check(all(g["captures"] == 1 for g in graphs)
              and all(len(r) == DW_L // DW_CGV for r in runs.values()),
              f"{loss}: each seed's steps in one captured graph ({graphs})")
        check(abs(med - med_j) <= limit,
              f"{loss}: the pooled readings' median {med:.3f} against "
              f"JAX's {med_j:.3f}, limit {limit:.3f}")
        del s
    print(f"  (b) took {time.perf_counter() - tb:.1f} s")

    # -- (c) relative errors of the loss estimators ----------------------------
    tc = time.perf_counter()
    print(f"phase 37 (c): experiments/compare_loss_relative_errors.py, LLGC(d, "
          f"off_diag 0.1, h_sign +1, seed 42 + d), DenseNet on [t, x], dt "
          f"{CMP_DT} (N=200), K=2^22 a dimension (the notebook: 5 10^7)")
    rel_ce, rel_lv = {}, {}
    for d in CMP_DIMS:
        p = LLGC(d=d, T=1.0, off_diag=0.1, h_sign=+1.0, seed=42 + d,
                 device=dev)
        net = DenseNet(d_out=d, d_in=d + 1,
                       generator=torch.Generator().manual_seed(42),
                       device=dev)

        def ctrl(X, n, t, net=net):
            tX = torch.cat([torch.full((X.shape[0], 1), t, device=dev), X],
                           dim=1)
            return net(tX), None

        stats, wall = synced(lambda: loss_estimator_statistics(
            p, ctrl, K=CMP_K, delta_t=CMP_DT,
            generator=torch.Generator(device=dev).manual_seed(42),
            n_chunks=max(1, CMP_K * d // 100_000_000)))
        check(all(math.isfinite(v) for v in stats.values()),
              f"d={d}: finite statistics {stats}")
        rel_ce[d] = relative_error(stats, "CE_detach")
        rel_lv[d] = relative_error(stats, "var")
        print(f"  d={d:2d}: RE[cross-entropy] {rel_ce[d]:9.3f} (BASELINE.md "
              f"2.4 x 1.30^d = {2.4 * 1.30 ** d:7.3f})   RE[log-variance] "
              f"{rel_lv[d]:7.3f} (BASELINE.md ~1.45)   {wall:.2f} s")
    lo_d, hi_d = CMP_DIMS[0], CMP_DIMS[-1]
    check(rel_ce[hi_d] / rel_ce[lo_d]
          > 2.0 * rel_lv[hi_d] / max(rel_lv[lo_d], 1e-9),
          f"the cross-entropy RE grows from d={lo_d} to d={hi_d} much faster "
          f"than the log-variance RE ({rel_ce}, {rel_lv})")
    print(f"  (c) took {time.perf_counter() - tc:.1f} s")

    # -- (d) the sqrt-schedule remat ------------------------------------------
    td = time.perf_counter()
    replicas = []
    real_replica = sde._replica

    def counting_replica(g, state):
        replicas.append(1)
        return real_replica(g, state)

    net = tanh_mlp_from_flax(load_control_npz(asset("llgc_d100_tanhmlp.npz"))
                             [0]["z"], device=dev)
    cfg = sde.HJBRolloutConfig(N=REMAT_N, delta_t=1.0 / REMAT_N, remat=True,
                               accumulate_kl=True)

    def ctrl100(X, n, t):
        tX = torch.cat([torch.full((X.shape[0], 1), t, device=dev), X], dim=1)
        return net(tX), None

    def remat_run(**kw):
        replicas.clear()
        torch.cuda.reset_peak_memory_stats()
        gen = torch.Generator(device=dev).manual_seed(5)
        out = sde.hjb_rollout(cfg, llgc, ctrl100,
                              llgc.X_0.expand(REMAT_K, llgc.d),
                              torch.zeros(REMAT_K, device=dev),
                              generator=gen, **kw)
        loss = (torch.mean((out.Y - llgc.g(out.X)) ** 2)
                + torch.mean(out.Z_sum))
        grads = torch.autograd.grad(loss, list(net.parameters()))
        torch.cuda.synchronize()
        return ([t.detach() for t in out] + list(grads), gen.get_state(),
                len(replicas), torch.cuda.max_memory_allocated())

    sde._replica = counting_replica
    try:
        (a, sa, na, ma), wa = synced(remat_run)
        (b, sb, nb, mb), wb = synced(lambda: remat_run(remat_threshold=1))
    finally:
        sde._replica = real_replica
    same = all(torch.equal(x, y) for x, y in zip(a, b)) and torch.equal(sa,
                                                                        sb)
    print(f"phase 37 (d): the sqrt schedule against the per-step rollout, "
          f"LLGC d=100, K={REMAT_K}, N={REMAT_N}, the exported control, an "
          f"undetached adaptive forward process, KL sum: per step {wa:.2f} "
          f"s, peak {ma / 2 ** 30:.2f} GiB, {na} chunk replicas; sqrt "
          f"schedule (threshold 1: chunks of {math.isqrt(REMAT_N - 1) + 1}) "
          f"{wb:.2f} s, peak {mb / 2 ** 30:.2f} GiB, {nb} chunk replicas; "
          f"outputs, gradients and the generator's state "
          + ("bitwise equal" if same else "DIFFER"))
    check(same and na == 0 and nb > 0, "the sqrt schedule gives the per-step "
          "rollout's outputs and gradients bitwise")
    del a, b, net
    # the schedule inside captured chunks: a registered generator for each
    # recomputation of each chunk (value mode recomputes a chunk several
    # times: its step differentiates V inside); the solvers' rollouts take
    # threshold 4, and the per-step run's replicas show it engaged
    import pspde_torch.solvers.hjb as hjb_mod
    real_rollout = hjb_mod.hjb_rollout
    hjb_mod.hjb_rollout = functools.partial(sde.hjb_rollout,
                                            remat_threshold=4)
    sde._replica = counting_replica
    try:
        for approx in ("control", "value_function"):
            runs, made = {}, {}
            for spc in (1, REMAT_SPC):
                r = HJBSolver("remat-chunks", llgc, lr=1e-2, L=REMAT_L,
                              K=1024, delta_t=1.0 / 40, time_approx="inner",
                              approx_method=approx,
                              loss_method="log-variance",
                              detach_forward=False, learn_Y_0=True,
                              remat=True, verbose=False,
                              early_stopping_time=None, steps_per_call=spc,
                              device=dev)
                replicas.clear()
                r.train()
                runs[spc], made[spc] = r, len(replicas)
            bad = same_training(runs[1], runs[REMAT_SPC])
            g = runs[REMAT_SPC].graph_stats
            shadows = len(getattr(runs[REMAT_SPC]._graph, "shadows", ()))
            print(f"  the sqrt schedule (N=40 in chunks of 7) in {REMAT_L} "
                  f"training steps of LLGC d=100, K=1024, {approx}, "
                  f"undetached: one step a call ({made[1]} chunk replicas) "
                  f"against {REMAT_SPC} a call ({g}, {shadows} registered "
                  f"generators): "
                  + ("bitwise equal" if not bad else f"DIFFER: {bad}"))
            check(made[1] > 0 and not bad and g["captures"] == 1
                  and g["replays"] == REMAT_L // REMAT_SPC,
                  f"{approx}: the sqrt schedule trains in captured chunks "
                  f"as step by step (differ: {bad})")
            del runs, r
    finally:
        hjb_mod.hjb_rollout = real_rollout
        sde._replica = real_replica
    torch.cuda.empty_cache()
    c5 = LLGC(d=D5, T=T5, device=dev)
    s5 = HJBSolver("config5-scan", c5,
                   lr=cosine_decay_schedule(1e-2, L5, alpha=1e-2), L=2,
                   K=K5, delta_t=DT5, time_approx="inner",
                   loss_method="log-variance", detach_forward=True,
                   learn_Y_0=True, rollout_mode="scan", remat=True,
                   verbose=False, early_stopping_time=None, device=dev)
    sde._replica = counting_replica
    replicas.clear()
    try:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        walls = [synced(s5.step)[1] for _ in range(2)]
    finally:
        sde._replica = real_replica
    peak = torch.cuda.max_memory_allocated()
    engaged = len(replicas) > 0
    print(f"  config 5 on the scan (LLGC d={D5}, T={T5}, N={s5.N}, K={K5}, "
          f"remat=True, log-variance, learn_Y_0): the sqrt schedule "
          f"{'engaged' if engaged else 'NOT engaged'} ({len(replicas)} "
          f"chunk replicas in 2 steps; carry budget "
          f"{sde.default_carry_budget(dev) / 2 ** 30:.1f} GiB), steps "
          f"{['%.3f' % w for w in walls]} s, peak "
          f"{peak / 2 ** 30:.2f} GiB (torch.cuda.max_memory_allocated), "
          f"u_L2 {s5.u_L2_loss}; card: {smi}")
    check(engaged and all(map(math.isfinite, s5.loss_log)),
          "config 5's scan step ran on the sqrt schedule, finite")
    del s5, c5
    torch.cuda.empty_cache()
    print(f"  (d) took {time.perf_counter() - td:.1f} s")

    # -- (e) resume -----------------------------------------------------------
    te = time.perf_counter()
    com = Committor(d=D_COM, device=dev)
    com_tree = load_control_npz(asset("committor_d10_densenet.npz"))[0]

    def hjb_export(L):
        return HJBSolver("resume-hjb", llgc, lr=1e-2, L=L, K=1024,
                         delta_t=DT_TRAIN, time_approx="inner",
                         loss_method="log-variance", detach_forward=True,
                         learn_Y_0=True, verbose=False,
                         early_stopping_time=None, seed=42,
                         rollout_mode="fused_train", device=dev)

    def committor(L):
        s = EllipticSolver(com, "resume-com", seed=42, delta_t=DT_BR,
                           N=N_COM, lr=1e-3, L=L, K=200, K_boundary=50,
                           K_test_log=10000, loss_with_stopped=False,
                           alpha=(10.0, 1.0), loss_method="diffusion",
                           rollout_mode="fused_train", verbose=False,
                           device=dev)
        s.load_jax_params(com_tree)
        return s

    print(f"phase 37 (e): save at step {RESUME_L // 2} of {RESUME_L}, load "
          f"into a fresh solver, train on: against the uninterrupted run "
          f"(chunked, captured)")
    with tempfile.TemporaryDirectory() as tmp:
        for name, make in (("HJB export recipe, fused_train", hjb_export),
                           ("committor diffusion, fused_train", committor)):
            ref = make(RESUME_L)
            ref.train()
            first = make(RESUME_L // 2)
            first.train()
            path = first.save_training_state(out_dir=tmp)
            resumed = make(RESUME_L)
            resumed.load_training_state(path)
            resumed.train()
            torch.cuda.synchronize()
            bad = same_training(ref, resumed)
            print(f"  [{name}] {len(resumed.loss_log)} steps, graphs: "
                  f"uninterrupted {ref.graph_stats}, resumed "
                  f"{resumed.graph_stats}; logs, parameters, Adam's state "
                  f"and generators "
                  + ("bitwise equal" if not bad else f"DIFFER: {bad}"))
            check(not bad and resumed.graph_stats["captures"] == 1,
                  f"{name}: the resumed run is the uninterrupted one "
                  f"(differ: {bad})")
            del ref, first, resumed
    print(f"  (e) took {time.perf_counter() - te:.1f} s")
    print(f"  phase 37 took {time.perf_counter() - t37:.1f} s")


# phase 38: the a-posteriori correctors (pspde_torch/eval/refine.py,
# picard.py, eigen_power.py) on the nets that phases 19, 21, 29, 32 and 35
# trained, at the notebook scripts' settings: (a) two exact oracles at full
# width, (b) experiments/allen_cahn.py's --refine and --picard 3, (c)
# committor.py's --leg picard, (d) baseline_configs.py's config 2 --picard
# 2, (e) eigenvalue_fokker_planck.py's --power-stages 3, (f)
# eigenvalue_schroedinger.py's --power-stages 4, (g) its --gap.  The JAX
# package's readouts that (b), (d) and (e) are held against come from
# experiments/refine_reference.py on the CPU (its docstring lists its cuts).
COR_K = 2 ** 20
COR_RADII = (1.25, 1.5, 1.75)
# cut to keep the whole run inside its time limit (PERF.md section 4): (b)
# 2 of the script's 3 Picard stages on 2048 of its 4096 anchors, (c) 4096
# of the script's 8192 anchors and 2500 of its 5000 refit steps, (d) the
# anchors' K_inner 32 (JAX's band) for the script's 256, (f) 3000 of 6000
# refit steps, (g) 3 of 4 stages and 1500 of 3000 refit and fit steps
COR_AC_K, COR_AC_STAGES, COR_AC_M, COR_AC_KI = 10 ** 6, 2, 2048, 1024
COR_AC_REG = 3000
COR_COM_M, COR_COM_KI, COR_COM_NCAP, COR_COM_REG = 4096, 1024, 8192, 2500
COR_HEAT_M, COR_HEAT_REG = 32768, 8000
COR_FP = dict(T_horizon=1.5, M=8192, K_inner=256, delta_t=2e-3,
              reg_steps=6000)
COR_SCH = dict(T_horizon=0.4, M=8192, K_inner=256, delta_t=2e-3,
               reg_steps=3000, mode="scf", normalization="l2")
COR_GAP = dict(T_horizon=0.5, M=4096, K_inner=64, delta_t=5e-3,
               reg_steps=1500, reg_lr=3e-3)
COR_GAP_STAGES, COR_GAP_FIT = 3, 1500
# experiments/refine_reference.py (CPU): config 2 from the port's initial
# net, 5 steps, then picard_refine(anchors='domain'), 2 stages, M=32768,
# K_inner=32, reg_steps 8000: the mean relative test errors of three seeds
HEAT_MRE_JAX = (0.010828089900314808, 0.010879780165851116,
                0.010853744111955166)
HEAT_KI_JAX = 32
# the same script: the 4000-step FP net (seed 42) refined under three keys:
# estimate_lambda (K=8192, 16 batches) and its standard error, the
# Richardson readout, and the fresh MSE before and after
FP_LAMBDA_JAX = ((0.004616969195223481, 0.00019215107647833243),
                 (0.005435151992214644, 0.0001959518633261844),
                 (0.00248875425585213, 0.00021124193814368546))
FP_RICHARDSON_JAX = ((0.0036402272667989607, 0.00025101864976544304),
                     (0.00457558157931223, 0.00029279660519643816),
                     (0.001321965990448053, 0.00027778324254795506))
FP_MSE_JAX = (4.1137722291750833e-05, 3.820291021838784e-05,
              7.155604544095695e-05)
# experiments/fp_lambda_reference.py (CPU): the JAX package's
# estimate_lambda (K=8192, 16 batches, three keys) and its standard error
# on the port's refined net, pspde_torch/assets/fp_d5_refined_densenet.npz
# (phase 38 (e)'s net on the card, written by experiments/
# torch_fp_refined_net.py)
FP_ASSET = "fp_d5_refined_densenet.npz"
FP_ASSET_LAMBDA_JAX = ((0.008209935754807437, 0.0001542839724426105),
                       (0.007806520214439155, 0.00022191874772792579),
                       (0.008055247548222703, 0.00015589910850271385))


def corrector_phase(dev, smi, heat_leg, fp_leg, committor_leg, ac_leg,
                    sch_leg):
    """Phase 38: the correctors on the trained nets of phases 19, 21, 29,
    32 and 35 (each solver's captured graph released first; a refined net
    goes back into its solver through ``load_state_dict``, which copies
    into the existing tensors).  Every leg prints its wall and
    ``max_memory_allocated``; (b)'s Feynman-Kac readout runs under the
    profiler for the device's idle share."""
    import numpy as np
    from pspde_torch.ansatz import DenseNet
    from pspde_torch.eval import (compute_test_error, eigen_power_refine,
                                  eigen_subspace_refine, feynman_kac_refine,
                                  feynman_kac_refine_elliptic,
                                  picard_refine, picard_refine_elliptic)
    from pspde_torch.eval.refine import reg_fit
    from pspde_torch.problems import Committor, FokkerPlanckEigen
    from pspde_torch.problems.fd_oracles import \
        generator_spectrum_periodic_1d
    from pspde_torch.rollout import kernels as km
    from pspde_torch.rollout.sampling import sample_domain

    t38 = time.perf_counter()
    for leg in (heat_leg, fp_leg, committor_leg, ac_leg, sch_leg):
        leg.release_graph()
    torch.cuda.empty_cache()
    walls = {}

    def leg_run(tag, fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        walls[tag] = (wall, peak)
        print(f"  [{tag}] {wall:.2f} s, max_memory_allocated "
              f"{peak:.2f} GiB")
        return out

    def fresh_mse(net, prob, X):
        with torch.no_grad():
            return float(torch.mean((net(X)[:, 0] - prob.v_ref(X)) ** 2))

    # -- (a) exact oracles ---------------------------------------------------
    heat = heat_leg.problem
    print(f"phase 38 (a): feynman_kac_refine on config 2's HeatEquation(d="
          f"{heat.d}, T={heat.T}) at x0 = 0, K=2^20, dt {DT_HEAT}; "
          f"feynman_kac_refine_elliptic on Committor(d={D_COM}) at radii "
          f"{COR_RADII}, K=2^20, N_cap 4096, dt 1e-3")
    out = leg_run("a heat", lambda: feynman_kac_refine(
        heat, heat_leg.V, torch.zeros(heat.d, device=dev), K=COR_K,
        delta_t=DT_HEAT, generator=380))
    v_true = 2.0 * heat.T * heat.d
    z = abs(float(out.value) - v_true) / float(out.stderr)
    print(f"  heat: v(0, 0) {float(out.value):.5f} +- {float(out.stderr):.5f}"
          f" (2 T d = {v_true:g}: {z:.2f} SE); the net reads "
          f"{float(out.direct):.4f}")
    check(z <= 5.0, f"heat: {z:.2f} SE from 2 T d")
    com = committor_leg.problem
    for r in COR_RADII:
        x0 = torch.full((com.d,), r / math.sqrt(com.d), device=dev)
        out = leg_run(f"a committor r={r}", lambda: feynman_kac_refine_elliptic(
            com, committor_leg.V, x0, K=COR_K, N_cap=4096, delta_t=1e-3,
            generator=381))
        exact = float(com.v_ref(x0[None])[0])
        err = abs(float(out.value) - exact)
        print(f"  committor r={r}: {float(out.value):.5f} +- "
              f"{float(out.stderr):.5f} against {exact:.5f} (|error| "
              f"{err:.5f}, limit 0.02); cap_frac {out.cap_frac:.2e}")
        check(err <= 0.02 and out.cap_frac < 1e-3,
              f"committor r={r}: |error| {err:.5f}, cap_frac "
              f"{out.cap_frac:.2e}")

    # -- (b) Allen-Cahn --------------------------------------------------------
    ac = ac_leg.problem
    lit = AC_V00_LITERATURE
    print(f"phase 38 (b): experiments/allen_cahn.py --refine --picard on "
          f"phase 32's net (AllenCahn(d={ac.d}), {len(ac_leg.loss_log)} "
          f"steps): feynman_kac_refine K=10^6, dt {DT_AC}; picard_refine "
          f"{COR_AC_STAGES} stages, 'tube', M={COR_AC_M}, K_inner="
          f"{COR_AC_KI}, reg_steps {COR_AC_REG}, readout K=10^6; against the "
          f"literature's {lit}")
    x0 = torch.zeros(ac.d, device=dev)
    fk = leg_run("b feynman_kac_refine", lambda: profile_steps(
        f"feynman_kac_refine, AllenCahn d={ac.d}, K=10^6, N=300",
        lambda: feynman_kac_refine(ac, ac_leg.V, x0, K=COR_AC_K,
                                   delta_t=DT_AC, generator=382), n=1))
    val, se, _ = leg_run("b picard_refine", lambda: picard_refine(
        ac, ac_leg.V_net, x0, n_stages=COR_AC_STAGES, M=COR_AC_M,
        K_inner=COR_AC_KI,
        delta_t=DT_AC, reg_steps=COR_AC_REG, readout_K=COR_AC_K,
        generator=383))
    direct = float(fk.direct)
    err = {"direct": abs(direct - lit), "refine": abs(float(fk.value) - lit),
           "picard": abs(float(val) - lit)}
    print(f"  v(0, 0): direct {direct:.6f}, feynman_kac_refine "
          f"{float(fk.value):.6f} +- {float(fk.stderr):.6f}, picard x"
          f"{COR_AC_STAGES} "
          f"{float(val):.6f} +- {float(se):.6f}; |error| "
          + ", ".join(f"{k} {v:.6f}" for k, v in err.items())
          + " (each reading at most half the direct one's)")
    for k in ("refine", "picard"):
        check(err[k] <= 0.5 * err["direct"], f"Allen-Cahn {k}: |error| "
              f"{err[k]:.6f} > half the direct {err['direct']:.6f}")

    # -- (c) committor -------------------------------------------------------
    print(f"phase 38 (c): experiments/committor.py --leg picard on phase "
          f"29's diffusion net: picard_refine_elliptic, 1 stage and then a "
          f"second, M={COR_COM_M}, K_inner={COR_COM_KI}, N_cap "
          f"{COR_COM_NCAP}, dt 1e-3, reg_steps {COR_COM_REG}; fresh MSE on "
          "10^5 samples")
    Xt = sample_domain(torch.Generator(dev).manual_seed(99), com.geometry,
                       10 ** 5, com.d)
    mse0 = fresh_mse(committor_leg.V_net, com, Xt)
    net, mses, hists = committor_leg.V_net, [], []
    for stage in (1, 2):
        net, hist = leg_run(f"c stage {stage}", lambda: picard_refine_elliptic(
            com, net, n_stages=1, M=COR_COM_M, K_inner=COR_COM_KI,
            N_cap=COR_COM_NCAP, delta_t=1e-3, reg_steps=COR_COM_REG,
            generator=384 + stage))
        mses.append(fresh_mse(net, com, Xt))
        hists += hist
    print(f"  fresh MSE {mse0:.4e} -> {mses[0]:.4e} (1 stage) -> "
          f"{mses[1]:.4e} (2 stages); history {hists}")
    check(all(m <= mse0 / 5.0 for m in mses)
          and all(h["cap_frac"] < 1e-3 for h in hists),
          f"committor: the fresh MSE falls 5x ({mse0:.4e} -> {mses}), "
          f"cap_frac < 1e-3 ({hists})")

    # -- (d) heat config 2 ---------------------------------------------------
    print(f"phase 38 (d): experiments/baseline_configs.py config 2 --picard 2 "
          f"on phase 19's net: picard_refine(anchors='domain'), 2 stages, "
          f"M={COR_HEAT_M}, reg_steps {COR_HEAT_REG}, dt {DT_HEAT}, K_inner "
          f"{HEAT_KI_JAX} (JAX's runs); the mean relative test error "
          "(compute_test_error, 'parabolic', K=16384)")

    def mre(net):
        with torch.no_grad():
            return float(compute_test_error(
                lambda XT: net(XT)[:, 0], heat, 16384,
                torch.Generator(dev).manual_seed(5), modus="parabolic")[2])

    trained = mre(heat_leg.V_net)
    _, _, net = leg_run("d picard_refine", lambda: picard_refine(
        heat, heat_leg.V_net, None, n_stages=2, M=COR_HEAT_M,
        K_inner=HEAT_KI_JAX, delta_t=DT_HEAT, reg_steps=COR_HEAT_REG,
        anchors="domain", generator=386))
    refined = mre(net)
    lo, hi = min(HEAT_MRE_JAX), max(HEAT_MRE_JAX)
    w = max(hi - lo, 0.1 * float(np.mean(HEAT_MRE_JAX)))
    print(f"  mean relative error: trained {trained:.4%}, refined "
          f"{refined:.4%} (JAX {['%.4f%%' % (100 * v) for v in HEAT_MRE_JAX]}"
          f", band [{lo - w:.4%}, {hi + w:.4%}]; RESULTS.md:662 reads "
          "0.73-1.01% from 3k-step nets at K_inner 256)")
    check(lo - w <= refined <= hi + w,
          f"config 2: {refined:.4%} outside JAX's band")

    # -- (e) FP eigen --------------------------------------------------------
    fp_power_leg(dev, fp_leg, leg_run)

    # -- (f) Schroedinger SCF ------------------------------------------------
    sch = sch_leg.problem
    Xs = 2 * math.pi * torch.rand((10 ** 5, sch.d),
                                  generator=torch.Generator(dev)
                                  .manual_seed(123), device=dev)
    mse0 = fresh_mse(sch_leg.V_net, sch, Xs)
    print(f"phase 38 (f): experiments/eigenvalue_schroedinger.py "
          f"--power-stages 4 on phase 35's net: eigen_power_refine {COR_SCH}")
    refined, hist = leg_run("f eigen_power_refine scf", lambda: (
        eigen_power_refine(sch, sch_leg.V_net, n_stages=4, generator=388,
                           verbose=True, **COR_SCH)))
    growth = hist[-1]["lambda_growth"]
    print(f"  lambda_growth {[round(h['lambda_growth'], 4) for h in hist]} "
          f"(lambda_true {sch.lambda_true}, limit 0.15); fresh MSE "
          f"{mse0:.4e} -> {fresh_mse(refined, sch, Xs):.4e} (printed: "
          "RESULTS.md:1034-1040 records no gain at this budget)")
    check(abs(growth - sch.lambda_true) <= 0.15,
          f"Schroedinger: lambda_growth {growth:.4f}")

    # -- (g) spectral gap ----------------------------------------------------
    print(f"phase 38 (g): experiments/eigenvalue_fokker_planck.py --gap at "
          f"d=1: three DenseNet (10, 10, 10, 10) fitted to 1, sin x, cos x "
          f"({COR_GAP_FIT} Adam steps, lr 3e-3, 4096 anchors), "
          f"eigen_subspace_refine {COR_GAP_STAGES} stages {COR_GAP}; against "
          "generator_spectrum_periodic_1d(n=256)")
    fp1 = FokkerPlanckEigen(d=1, device=dev)
    gen = torch.Generator(dev).manual_seed(389)
    Xa = 2 * math.pi * torch.rand((4096, 1), generator=gen, device=dev)

    def seeded_nets():
        nets = []
        for j, target in enumerate((torch.ones_like(Xa[:, 0]),
                                    torch.sin(Xa[:, 0]),
                                    torch.cos(Xa[:, 0]))):
            net = DenseNet(1, (10, 10, 10, 10), d_in=1, device=dev,
                           generator=torch.Generator().manual_seed(j))
            nets.append(reg_fit(net, Xa, target, COR_GAP_FIT, 3e-3)[0])
        return nets

    nets = leg_run("g fits", seeded_nets)
    _, hist = leg_run("g eigen_subspace_refine", lambda: (
        eigen_subspace_refine(fp1, nets, n_stages=COR_GAP_STAGES,
                              generator=390,
                              verbose=True, **COR_GAP)))
    fp1_host = FokkerPlanckEigen(d=1, device="cpu")

    def b1(x):
        return fp1_host.b(torch.from_numpy(
            np.asarray(x, np.float32)[:, None]))[:, 0].numpy()

    def W1(x):
        return fp1_host.h(torch.from_numpy(np.asarray(x, np.float32)[:, None]),
                          torch.ones(len(x)), None).numpy()

    _, lam_fd, _ = generator_spectrum_periodic_1d(b1, W1, n=256)
    lams = hist[-1]["lambdas"]
    print(f"  Ritz values {[round(v, 5) for v in lams]}, FD oracle "
          f"{[round(float(v), 5) for v in lam_fd[:3]]}; spectral gap "
          f"{lams[1] - lams[0]:.5f} (FD {lam_fd[1] - lam_fd[0]:.5f})")
    check(abs(lams[0] - lam_fd[0]) < 0.05 and abs(lams[1] - lam_fd[1]) < 0.15,
          f"spectral gap: Ritz {lams[:2]} against FD {lam_fd[:2]}")
    print(f"  legs: " + "; ".join(f"{k} {w:.2f} s, {m:.2f} GiB"
                                   for k, (w, m) in walls.items()))
    print(f"  card: {smi}")
    print(f"  phase 38 took {time.perf_counter() - t38:.1f} s")


def fp_power_leg(dev, fp_leg, leg_run):
    """Phase 38 (e): ``eigen_power_refine`` on phase 21's net, then
    ``estimate_lambda`` (K=8192, 16 batches) and its Richardson readout on
    the solver's engine ('fused_train': kernel 4) against JAX's band; the
    same readout on the scan under the same seed, within 3 SE of the
    kernel's; both engines on one set of host-noise batches, within 0.1 SE
    of each other; the committed refined net against JAX's readout on it;
    and the torus family's kernels held to their plain version on the
    refined net at its lambda (``compare_eigen``).  ``fp_leg.V_net`` holds
    the refined net after it.  Returns the readings."""
    import numpy as np
    from pspde_torch.eval import eigen_power_refine
    from pspde_torch.rollout import kernels as km
    from pspde_torch.rollout.sampling import sample_domain

    fp = fp_leg.problem

    def fresh_mse(net):
        with torch.no_grad():
            return float(torch.mean((net(Xu)[:, 0] - fp.v_ref(Xu)) ** 2))

    Xu = 2 * math.pi * torch.rand((10 ** 5, fp.d),
                                  generator=torch.Generator(dev)
                                  .manual_seed(123), device=dev)
    mse0 = fresh_mse(fp_leg.V_net)
    print(f"phase 38 (e): experiments/eigenvalue_fokker_planck.py "
          f"--power-stages 3 on phase 21's net ({len(fp_leg.loss_log)} "
          f"steps): eigen_power_refine {COR_FP}, then estimate_lambda and "
          "estimate_lambda_richardson (K=8192, 16 batches)")
    refined, hist = leg_run("e eigen_power_refine", lambda: eigen_power_refine(
        fp, fp_leg.V_net, n_stages=3, generator=387, verbose=True, **COR_FP))
    mse1 = fresh_mse(refined)
    fp_leg.V_net.load_state_dict(refined.state_dict())
    reset_counts(km.fused_stopped_train_rollout, "launches")
    lam, lam_se = leg_run("e estimate_lambda", lambda: fp_leg.estimate_lambda(
        K=8192, n_batches=16))
    lam_r, lam_r_se = leg_run("e estimate_lambda_richardson",
                              lambda: fp_leg.estimate_lambda_richardson(
                                  K=8192, n_batches=16))
    launches = km.fused_stopped_train_rollout.launches
    lams = [v for v, _ in FP_LAMBDA_JAX]
    lo, hi = min(lams), max(lams)
    w = max(hi - lo, 3.0 * math.sqrt(max(e for _, e in FP_LAMBDA_JAX) ** 2
                                     + lam_se ** 2))
    print(f"  fresh MSE {mse0:.4e} -> {mse1:.4e} (JAX {FP_MSE_JAX}); "
          f"lambda_growth {[round(h['lambda_growth'], 5) for h in hist]}; "
          f"estimate_lambda {lam:.5f} +- {lam_se:.1e} (JAX "
          f"{['%.5f +- %.1e' % v for v in FP_LAMBDA_JAX]}, band "
          f"[{lo - w:.5f}, {hi + w:.5f}]); Richardson {lam_r:.5f} +- "
          f"{lam_r_se:.1e} (JAX {['%.5f' % v for v, _ in FP_RICHARDSON_JAX]})"
          f"; stopped-forward launches {launches}")
    check(mse1 <= mse0 / 4.0, f"FP: fresh MSE {mse0:.4e} -> {mse1:.4e}, "
          "less than a 4x fall")
    check(lo - w <= lam <= hi + w and launches > 0,
          f"FP: lambda {lam:.5f} outside JAX's band")

    # the readout on the scan (the plain rollout, its own draws from the
    # same seed) beside the kernel's, and both engines on one set of
    # host-noise batches
    engine = fp_leg.resolved_rollout_mode
    fp_leg.resolved_rollout_mode = "scan"
    try:
        lam_s, lam_s_se = leg_run("e estimate_lambda on the scan",
                                  lambda: fp_leg.estimate_lambda(
                                      K=8192, n_batches=16))
    finally:
        fp_leg.resolved_rollout_mode = engine
    # the readout on the committed refined net, which JAX read on the CPU
    from pspde_torch.utils.convert import (eigen_params_from_flax,
                                           load_control_npz)
    root = os.path.dirname(os.path.abspath(__file__))
    asset_net, _ = eigen_params_from_flax(
        load_control_npz(os.path.join(root, "pspde_torch", "assets",
                                      FP_ASSET))[0], device=dev)
    moved = max(float((a - b).detach().abs().max()) for a, b in
                zip(asset_net.parameters(), fp_leg.V_net.parameters()))
    refined_state = {k: v.clone() for k, v in
                     fp_leg.V_net.state_dict().items()}
    fp_leg.V_net.load_state_dict(asset_net.state_dict())
    try:
        lam_a, lam_a_se = fp_leg.estimate_lambda(K=8192, n_batches=16)
    finally:
        fp_leg.V_net.load_state_dict(refined_state)
    lams_a = [v for v, _ in FP_ASSET_LAMBDA_JAX]
    lo_a, hi_a = min(lams_a), max(lams_a)
    w_a = max(hi_a - lo_a, 3.0 * math.sqrt(
        max(e for _, e in FP_ASSET_LAMBDA_JAX) ** 2 + lam_a_se ** 2))
    print(f"  the committed refined net ({FP_ASSET}; this run's refined "
          f"net parts from it by at most {moved:.2e}): estimate_lambda "
          f"{lam_a:.5f} +- {lam_a_se:.1e} on fused_train against JAX's "
          f"{['%.5f +- %.1e' % v for v in FP_ASSET_LAMBDA_JAX]} on the "
          f"same net (band [{lo_a - w_a:.5f}, {hi_a + w_a:.5f}])")
    check(lo_a - w_a <= lam_a <= hi_a + w_a,
          f"FP: on the committed net lambda {lam_a:.5f} outside JAX's "
          "band on that net")
    gap = abs(lam_s - lam)
    se = math.hypot(lam_se, lam_s_se)
    print(f"  estimate_lambda on the scan {lam_s:.5f} +- {lam_s_se:.1e}, "
          f"on fused_train {lam:.5f} +- {lam_se:.1e}: |difference| "
          f"{gap:.2e} ({gap / se:.2f} SE)")
    check(gap <= 3.0 * se, f"FP: estimate_lambda on the scan {lam_s:.5f} "
          f"and on the kernel {lam:.5f} part by {gap / se:.2f} SE")
    gen = torch.Generator(dev).manual_seed(388)
    batches = [(sample_domain(gen, fp.geometry, 8192, fp.d),
                torch.randn((fp_leg.N, 8192, fp.d), generator=gen,
                            device=dev)) for _ in range(16)]
    same = {}
    for mode in ("scan", "fused_train"):
        fp_leg.resolved_rollout_mode = mode
        try:
            same[mode] = fp_leg.estimate_lambda(batches=batches)
        finally:
            fp_leg.resolved_rollout_mode = engine
    diff = abs(same["scan"][0] - same["fused_train"][0])
    print(f"  on one set of host-noise batches: scan "
          f"{same['scan'][0]:.7f} +- {same['scan'][1]:.1e}, fused_train "
          f"{same['fused_train'][0]:.7f}: |difference| {diff:.2e}")
    check(diff <= 0.1 * same["scan"][1],
          f"FP: on the same noise the kernel's readout parts from the "
          f"scan's by {diff:.2e} > 0.1 SE")
    worst = {"out": 0.0, "grad": 0.0, "bwd": 0.0}
    X0 = sample_domain(gen, fp.geometry, 8192, fp.d)
    lam_value = float(fp_leg.lam_net.Y_0.detach())
    compare_eigen(f"refined net, K=8192, lambda {lam_value:.4f}", fp,
                  fp_leg.V_net, X0, fp_leg.N, fp_leg.delta_t,
                  dict(seed=389), worst, lam_value=lam_value)
    return dict(lam=(lam, lam_se), lam_scan=(lam_s, lam_s_se),
                lam_asset=(lam_a, lam_a_se), same_noise=same,
                richardson=(lam_r, lam_r_se), mse=(mse0, mse1))


# phase 39: the three notebook recipes that no phase ran before, at their
# scripts' widths from JAX's seed-42 initial nets on the scripts' engine
# (the solvers' default scan): (a) experiments/parabolic_neumann.py, (b)
# experiments/ou_moment_initializations.py, (c) experiments/
# trajectory_length_study.py, also on fused_train at N = 1, 20, 100; then
# (d) one short scan leg of each solver on the rest of problems/ (the
# first-exit double well, the parabolic double-well committor, the general
# solver's linear double well, the double well beside an OU block).  Each
# recipe reading must fall in JAX's band [min - w, max + w], w = max(max -
# min, 0.1 |mean|), of experiments/notebooks_11a_reference.py's three
# seeds (42, 43, 44) at the same step counts.  Those cut the scripts'
# 100k, 1000 and 20k steps so that the whole run fits the time limit on
# the slowest host seen (PERF.md section 4; the phase prints each leg's
# wall).  (a) and (b) also hold the fall of the test L2 and the move of
# Y_0 to at least half of JAX's, which the bands alone do not show at
# these counts.
# The legs run NB_SPC steps a call (the scripts' 100 would capture 100
# eager steps per leg; a chunked run is bitwise the per-step one).
NB_L_A, NB_L_B, NB_L_C = 100, 50, 15
NB_SPC = 5
NB_A2S = (0.1, 1.0, 10.0, 100.0)
NB_GRID_N = (1, 2, 5, 10, 20, 50, 100)
NB_GRID_DT = (1e-3, 5e-4)
NB_FUSED_N = (1, 20, 100)
NB_A_JAX = {
    "0.1": {"rel_abs": (0.6750110387802124, 0.6716272234916687,
                        0.6738314628601074),
            "test_L2": (9.072013854980469, 8.836319923400879,
                        9.001175880432129)},
    "1": {"rel_abs": (0.6838085651397705, 0.6786915063858032,
                      0.683831512928009),
          "test_L2": (9.344425201416016, 9.044926643371582,
                      9.290127754211426)},
    "10": {"rel_abs": (0.7276403903961182, 0.7216315865516663,
                       0.7290241122245789),
           "test_L2": (10.586390495300293, 10.226479530334473,
                       10.569565773010254)},
    "100": {"rel_abs": (0.7417216897010803, 0.7354323863983154,
                        0.7441245913505554),
            "test_L2": (11.029463768005371, 10.651236534118652,
                        11.049269676208496)},
}
NB_B_JAX = {
    "y0 = 0": {"Y_0": (-0.046857982873916626, -0.05670905485749245,
                       -0.050069354474544525),
               "u_L2": (0.9430469274520874, 0.9124717116355896,
                        0.7978510856628418)},
    "y0 = 10": {"Y_0": (9.948554992675781, 9.948779106140137,
                        9.948633193969727),
                "u_L2": (1.6572396755218506, 2.1134824752807617,
                         1.785599946975708)},
    "y0 exact": {"Y_0": (-4.285638332366943, -4.285297870635986,
                         -4.285308361053467),
                 "u_L2": (0.7114655375480652, 0.8216807246208191,
                          0.6437411904335022)},
}
NB_C_JAX = {
    "1 0.001": (5.355689525604248, 5.356393814086914, 5.353767395019531),
    "2 0.001": (5.355689525604248, 5.356393814086914, 5.353766918182373),
    "5 0.001": (5.355687618255615, 5.3563923835754395, 5.353766441345215),
    "10 0.001": (5.355686664581299, 5.356389045715332, 5.353765487670898),
    "20 0.001": (5.355677127838135, 5.356383323669434, 5.353764057159424),
    "50 0.001": (5.35565710067749, 5.3563761711120605, 5.353762149810791),
    "100 0.001": (5.355652332305908, 5.356374740600586, 5.353760719299316),
    "1 0.0005": (5.355689525604248, 5.356394290924072, 5.353767395019531),
    "2 0.0005": (5.355689525604248, 5.356393814086914, 5.353767395019531),
    "5 0.0005": (5.355689525604248, 5.356393814086914, 5.353766918182373),
    "10 0.0005": (5.355687141418457, 5.356391906738281, 5.353766441345215),
    "20 0.0005": (5.35568380355835, 5.35638952255249, 5.353765964508057),
    "50 0.0005": (5.355673789978027, 5.356382846832275, 5.353762149810791),
    "100 0.0005": (5.355664253234863, 5.356374263763428, 5.353759288787842),
}
# the mean of JAX's first test L2 over the grid's 42 legs (one initial net)
NB_C_FIRST_JAX = 5.476000842593965
# (a): JAX's first test L2 of each a2's three legs (one initial net, each
# seed's own test sample); (b): JAX's v(x_0, 0), the third leg's Y_0
NB_A_FIRST_JAX = {
    "0.1": (19.44320297241211, 19.584728240966797, 19.61106300354004),
    "1": (19.443016052246094, 19.584747314453125, 19.611183166503906),
    "10": (19.443178176879883, 19.584789276123047, 19.611364364624023),
    "100": (19.443294525146484, 19.584848403930664, 19.61140251159668),
}
NB_B_V0_JAX = -4.3290019035339355
# (d) general_linear: JAX's RMS of V against the product of the 1-d psi
# (experiments/notebooks_11a_reference.py --part d, 150 steps from the
# seed-42 initial net, seeds 42-44), before and after training
NB_D_BEFORE_JAX = 0.3880120515823364
NB_D_AFTER_JAX = (0.35953834652900696, 0.3633905053138733,
                  0.3443801999092102)
# the item-7 legs: steps, and tests/test_misc_coverage.py's settings
NB_LEG_L = 150
NB_LEG = dict(N=10, delta_t=0.01, K=64, K_boundary=16, verbose=False,
              steps_per_call=NB_SPC)
# fingerprints of the FD tables (float64) that the legs' problems build on
# the host: per table (sum, sum of squares, entry len // 3), as the CPU
# tests read them from the port's tables, which they hold bitwise to JAX's
# (tests/test_torch_problems_rest.py)
NB_FD_PRINTS = {
    "stopping": [
        177.91008422984433, 138.47318416881745, 0.0695405537446175,
        302.19967881343024, 552.2301870526089, 1.518796018901325],
    "general_linear": [
        7699.656521608407, 6997.183464876924, 0.05035830544938706,
        12490.972837614645, 28816.765456271503, -0.7173363468427585,
        7699.656521608407, 6997.183464876924, 0.05035830544938706,
        12490.972837614645, 28816.765456271503, -0.7173363468427585],
    "committor": [],
    "ou": [
        97163.78664164615, 78857.35714556769, 0.07056698752446462,
        133830.56702870116, 264141.7031578831, -0.21831448783284912],
}


def jax_band(vals):
    """[min - w, max + w] with w = max(max - min, 0.1 |mean|): JAX's three
    seeds, widened by their spread or a tenth of their mean (phase 32's
    rule)."""
    lo, hi = min(vals), max(vals)
    w = max(hi - lo, 0.1 * abs(sum(vals) / len(vals)))
    return lo - w, hi + w


def in_band(tag, value, vals):
    lo, hi = jax_band(vals)
    ok = lo <= value <= hi
    print(f"  {tag}: {value:.5g} (JAX {['%.5g' % v for v in vals]}, band "
          f"[{lo:.5g}, {hi:.5g}]){'' if ok else ' OUTSIDE'}")
    return ok


def fd_fingerprint(*tables):
    """Per table: its sum, its sum of squares (NaN entries left out) and
    its entry at len // 3, in float64."""
    import numpy as np
    out = []
    for a in tables:
        a = np.asarray(a, dtype=np.float64).ravel()
        out += [float(np.nansum(a)), float(np.nansum(a * a)),
                float(a[len(a) // 3])]
    return out


def nb_problems(dev):
    """The item-7 legs' problems, their FD tables built on the host: name
    -> (problem, its tables)."""
    from pspde_torch.problems import (Committor_DoubleWell, DoubleWell_OU,
                                      DoubleWell_stopping, DoubleWellGeneral)
    stop = DoubleWell_stopping(d=1, device=dev)
    stop.compute_reference_solution()
    lin = DoubleWellGeneral(d=2, d_1=1, d_2=1, T=0.5, eta=1.0, kappa=1.0,
                            modus="linear", device=dev)
    lin.compute_reference_solution(delta_t=0.01, nx=300)
    ou = DoubleWell_OU(d=3, device=dev)
    ou.compute_reference_solution()
    com = Committor_DoubleWell(d=1, beta=1.0, eta=2.0, T=0.5, device=dev)
    return {"stopping": (stop, (stop._psi_np, stop._u_np)),
            "general_linear": (lin, (lin._psi1, lin._u1, lin._psi2,
                                     lin._u2)),
            "committor": (com, ()),
            "ou": (ou, (ou._psi_np, ou._u_np))}


def general_err(s, prob, dev):
    """Phase 39 (d): the RMS error of a GeneralSolver's V(x, t) against the
    linear modus' product of the 1-d psi at the grid times on 4096 points
    of the square, the numpy draw at which experiments/
    notebooks_11a_reference.py --part d reads JAX's."""
    import numpy as np
    ts = np.arange(s.N + 1) * s.delta_t
    v_ref = prob.v_ref_fn(ts)
    X = torch.as_tensor(np.random.default_rng(393).uniform(
        -2.5, 2.5, (4096, prob.d)).astype(np.float32), device=dev)
    with torch.no_grad():
        err = [torch.mean((s.V(X, torch.full((4096,), float(t), device=dev))
                           - v_ref(X, i)) ** 2) for i, t in enumerate(ts)]
    return float(torch.sqrt(torch.mean(torch.stack(err))))


def notebook_phase(dev, smi):
    """Phase 39: the three recipes, the trajectory-length cells on
    fused_train, and the item-7 legs."""
    import numpy as np
    from pspde_torch.problems import (LLGC, ExponentialOnBallNonlinearSin,
                                      ExponentialOnSphereNonlinearParabolic)
    from pspde_torch.rollout import kernels as km
    from pspde_torch.rollout.sampling import sample_domain
    from pspde_torch.solvers import EllipticSolver, GeneralSolver, HJBSolver
    from pspde_torch.utils.convert import load_control_npz

    root = os.path.dirname(os.path.abspath(__file__))
    t39 = time.perf_counter()
    walls = {}

    def asset(name):
        return load_control_npz(os.path.join(root, "pspde_torch", "assets",
                                             name))[0]

    def fell(first, last, jax_first, jax_last, what):
        """The fall from the leg's first reading at least half JAX's mean
        fall (the band alone is wide against it after the cut step
        counts)."""
        mean = lambda v: sum(v) / len(v)  # noqa: E731
        fall, jax_fall = first - last, mean(jax_first) - mean(jax_last)
        print(f"    fall from the first {what} {first:.5g}: {fall:.4g} "
              f"(JAX's mean {jax_fall:.4g}; at least half)")
        return fall >= 0.5 * jax_fall

    def train(tag, s):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s.train()
        torch.cuda.synchronize()
        walls[tag] = time.perf_counter() - t0
        return walls[tag]

    # -- (a) parabolic Neumann -----------------------------------------------
    print(f"phase 39 (a): experiments/parabolic_neumann.py: GeneralSolver("
          f"ExponentialOnSphereNonlinearParabolic(d=20, T=1, alpha=1)), "
          f"Neumann, diffusion, N=20, dt 1e-3, K=200, K_boundary=50, alpha "
          f"(1, 1, a2), lr 1e-3, K_test_log 10000, scan, {NB_L_A} steps "
          f"({NB_SPC} a call) from JAX's initial net")
    pa = ExponentialOnSphereNonlinearParabolic(d=20, T=1.0, alpha=1.0,
                                               device=dev)
    pa.boundary_type = "Neumann"
    tree_a = asset("parabolic_neumann_d20_densenet.npz")
    for a2 in NB_A2S:
        s = GeneralSolver(pa, f"diffusion a2={a2:g}", seed=42, delta_t=1e-3,
                          N=20, lr=1e-3, L=NB_L_A, K=200, K_boundary=50,
                          alpha=(1.0, 1.0, a2), loss_method="diffusion",
                          K_test_log=10000, steps_per_call=NB_SPC,
                          print_every=max(NB_L_A // 20, 1), verbose=False,
                          device=dev)
        s.load_jax_params(tree_a)
        check(s.resolved_rollout_mode == "scan" and s.boundary_type
              == "Neumann", f"(a) a2={a2:g}: engine "
              f"{s.resolved_rollout_mode}, {s.boundary_type}")
        wall = train(f"a a2={a2:g}", s)
        jax = NB_A_JAX[f"{a2:g}"]
        print(f"  [a2={a2:g}] {len(s.loss_log)} steps in {wall:.2f} s "
              f"({s.graph_stats['replays']} replays); test L2 every 50: "
              f"{['%.4g' % v for v in s.V_test_L2[::50]]}")
        ok = [in_band(f"a2={a2:g} V_test_rel_abs[-1]", s.V_test_rel_abs[-1],
                      jax["rel_abs"]),
              in_band(f"a2={a2:g} V_test_L2[-1]", s.V_test_L2[-1],
                      jax["test_L2"]),
              fell(s.V_test_L2[0], s.V_test_L2[-1],
                   NB_A_FIRST_JAX[f"{a2:g}"], jax["test_L2"], "test L2")]
        check(all(ok) and np.isfinite(s.loss_log).all(),
              f"(a) a2={a2:g}: a reading outside JAX's band, or no fall")
        del s

    # -- (b) moment-loss initialisations ------------------------------------
    pb = LLGC(d=20, T=1.0, seed=42, device=dev)
    v0 = float(pb.v_ref(torch.zeros((1, 20), device=dev), 0.0)[0])
    print(f"phase 39 (b): experiments/ou_moment_initializations.py: "
          f"HJBSolver(LLGC(d=20, T=1)), moment loss, 'inner', dt 0.01, "
          f"K=500, lr 1e-3, learn_Y_0, detach_forward, no early stopping, "
          f"scan, {NB_L_B} steps ({NB_SPC} a call) from JAX's initial "
          f"control; Y_0 set to 0, 10 and v(x_0, 0) = {v0:.5f} before "
          "train()")
    tree_b = asset("llgc_d20_tanhmlp.npz")
    for name, y0 in (("y0 = 0", 0.0), ("y0 = 10", 10.0), ("y0 exact", v0)):
        s = HJBSolver(name, pb, L=NB_L_B, lr=1e-3, seed=42, delta_t=0.01,
                      K=500, time_approx="inner", loss_method="moment",
                      learn_Y_0=True, detach_forward=True,
                      print_every=max(NB_L_B // 10, 1),
                      early_stopping_time=None, steps_per_call=NB_SPC,
                      verbose=False, device=dev)
        s.load_jax_params(tree_b)
        with torch.no_grad():
            s.y0_net.Y_0.fill_(y0)
        check(s.resolved_rollout_mode == "scan",
              f"(b) {name}: engine {s.resolved_rollout_mode}")
        wall = train(f"b {name}", s)
        jax = NB_B_JAX[name]
        print(f"  [{name}] {len(s.loss_log)} steps in {wall:.2f} s "
              f"({s.graph_stats['replays']} replays); Y_0 every 50: "
              f"{['%.4f' % v for v in s.Y_0_log[::50]]}; u_L2 every 50: "
              f"{['%.4g' % v for v in s.u_L2_loss[::50]]}")
        ok = [in_band(f"{name} Y_0_log[-1] (exact {v0:.4f})", s.Y_0_log[-1],
                      jax["Y_0"]),
              in_band(f"{name} u_L2[-1]", s.u_L2_loss[-1], jax["u_L2"])]
        # Y_0 has moved from where it was set at least half as far as
        # JAX's did (the band alone holds the value it was set to)
        y0_jax = NB_B_V0_JAX if name == "y0 exact" else y0
        move = abs(s.Y_0_log[-1] - y0)
        move_jax = sum(abs(v - y0_jax) for v in jax["Y_0"]) / len(jax["Y_0"])
        print(f"    Y_0 moved {move:.4g} from {y0:.5g} (JAX's mean "
              f"{move_jax:.4g}; at least half)")
        check(all(ok) and move >= 0.5 * move_jax
              and np.isfinite(s.loss_log).all(),
              f"(b) {name}: a reading outside JAX's band, or Y_0 stayed")
        del s

    # -- (c) trajectory length -----------------------------------------------
    print(f"phase 39 (c): experiments/trajectory_length_study.py: "
          f"EllipticSolver(ExponentialOnBallNonlinearSin(d=10, alpha=1)), "
          f"diffusion, K=200, K_boundary=50, lr 1e-3, K_test_log 10000, N in "
          f"{NB_GRID_N} x dt in {NB_GRID_DT}, scan, {NB_L_C} steps "
          f"({NB_SPC} a call) from JAX's initial net; then N in "
          f"{NB_FUSED_N} at dt 1e-3 on fused_train, kernels 4 and 5 held to "
          "their plain version at the first step")
    pc = ExponentialOnBallNonlinearSin(d=10, alpha=1.0, device=dev)
    tree_c = asset("trajectory_length_d10_densenet.npz")

    def length_solver(N, dt, mode):
        s = EllipticSolver(pc, f"N={N} dt={dt:g}", seed=42, delta_t=dt, N=N,
                           lr=1e-3, L=NB_L_C, K=200, K_boundary=50,
                           loss_method="diffusion", K_test_log=10000,
                           steps_per_call=NB_SPC, verbose=False,
                           rollout_mode=mode, device=dev)
        s.load_jax_params(tree_c)
        check(s.resolved_rollout_mode == mode,
              f"(c) N={N} dt={dt:g}: engine {s.resolved_rollout_mode}")
        return s

    bad = []
    for dt in NB_GRID_DT:
        for N in NB_GRID_N:
            s = length_solver(N, dt, "scan")
            wall = train(f"c N={N} dt={dt:g}", s)
            print(f"  [N={N} dt={dt:g}] {wall:.2f} s")
            if not (in_band(f"N={N} dt={dt:g} V_test_L2[-1]",
                            s.V_test_L2[-1], NB_C_JAX[f"{N} {dt:g}"])
                    and fell(s.V_test_L2[0], s.V_test_L2[-1],
                             (NB_C_FIRST_JAX,), NB_C_JAX[f"{N} {dt:g}"],
                             "test L2")):
                bad.append((N, dt))
            del s
    check(not bad, f"(c): readings outside JAX's band at {bad}")
    worst = {"out": 0.0, "grad": 0.0, "bwd": 0.0}
    for N in NB_FUSED_N:
        s = length_solver(N, 1e-3, "fused_train")
        X0 = sample_domain(torch.Generator(dev).manual_seed(390 + N),
                           pc.geometry, 200, pc.d)
        compare_stopped(f"(c) N={N}, K=200, the first step's net", pc,
                        s.V_net, X0, torch.zeros(200, device=dev), N, 1e-3,
                        dict(seed=391), worst, MASK_TOL)
        zero_counts()
        with PlainCalls(km) as plain_calls:
            wall = train(f"c fused N={N}", s)
        n = counted(km.fused_stopped_train_rollout, "launches",
                    "backward_launches")
        warm = s.graph_stats["warmup_steps"]
        print(f"  [fused_train N={N}] {wall:.2f} s; launches forward {n[0]}, "
              f"backward {n[1]} ({NB_L_C} steps and {warm} warm-up step(s));"
              f" plain-version calls {plain_calls.n}")
        check(n == (NB_L_C + warm, NB_L_C + warm) and plain_calls.n == 0,
              f"(c) fused N={N}: one launch of each kernel a step, no plain "
              "call")
        check(in_band(f"fused_train N={N} V_test_L2[-1]", s.V_test_L2[-1],
                      NB_C_JAX[f"{N} 0.001"])
              and fell(s.V_test_L2[0], s.V_test_L2[-1], (NB_C_FIRST_JAX,),
                       NB_C_JAX[f"{N} 0.001"], "test L2"),
              f"(c) fused N={N}: the reading outside JAX's band, or no "
              "fall")
        del s
    print(f"  kernels 4 and 5 against plain at N={NB_FUSED_N}: largest "
          f"|difference| outputs {worst['out']:.2e}, loss gradients "
          f"{worst['grad']:.2e}, backward {worst['bwd']:.2e}")

    # -- (d) the rest of problems/ on the scan -------------------------------
    print(f"phase 39 (d): the rest of problems/, one scan leg a solver, "
          f"{NB_LEG_L} steps, diffusion or log-variance, {NB_LEG}")
    probs = nb_problems(dev)
    for name, (prob, tables) in probs.items():
        got = fd_fingerprint(*tables)
        want = NB_FD_PRINTS[name]
        ok = len(got) == len(want) and np.allclose(got, want, rtol=1e-10,
                                                   atol=0)
        print(f"  [{name}] FD tables' fingerprint {got} (CPU {want})")
        check(ok, f"(d) {name}: the host's FD tables differ from the CPU's")


    legs = {
        "stopping": lambda p: EllipticSolver(
            p, "dw-stopping", loss_method="diffusion", L=NB_LEG_L,
            device=dev, **NB_LEG),
        "general_linear": lambda p: GeneralSolver(
            p, "dw-linear", loss_method="diffusion", L=NB_LEG_L, device=dev,
            **NB_LEG),
        "committor": lambda p: GeneralSolver(
            p, "dw-committor", loss_method="diffusion", L=NB_LEG_L,
            device=dev, **NB_LEG),
        "ou": lambda p: HJBSolver(
            "dw-ou", p, L=NB_LEG_L, lr=1e-2, K=64, delta_t=0.05,
            time_approx="inner", loss_method="log-variance",
            detach_forward=True, verbose=False, early_stopping_time=None,
            steps_per_call=NB_SPC, device=dev)}
    for name, make in legs.items():
        prob = probs[name][0]
        s = make(prob)
        if name == "general_linear":
            # JAX's seed-42 initial net, which JAX's witness trained
            s.load_jax_params(asset("dw_general_linear_d2_densenet.npz"))
        check(s.resolved_rollout_mode == "scan", f"(d) {name}: engine")
        before = general_err(s, prob, dev) if name == "general_linear" else None
        wall = train(f"d {name}", s)
        loss = np.asarray(s.loss_log)
        if name == "stopping":
            err = np.asarray(s.V_L2_log)
            what = "V_L2 against the FD table"
        elif name == "ou":
            err = np.asarray(s.u_L2_loss)
            what = "u_L2 against the FD and closed-form control"
        elif name == "general_linear":
            err = np.asarray([before, general_err(s, prob, dev)])
            what = "RMS of V - the product of the 1-d psi"
        else:
            err = loss
            what = "the loss (no reference exists)"
        n = 1 if name == "general_linear" else 10
        first, last = float(np.mean(err[:n])), float(np.mean(err[-n:]))
        print(f"  [{name}] {type(s).__name__}, {len(loss)} steps in "
              f"{wall:.2f} s; loss first {loss[0]:.4g}, last {loss[-1]:.4g}; "
              f"{what}: first {first:.4g}, last {last:.4g} "
              f"({'means of 10 steps' if n == 10 else 'before and after'})")
        check(np.isfinite(loss).all() and last < first,
              f"(d) {name}: finite losses and a falling error "
              f"({first:.4g} -> {last:.4g})")
        if name == "general_linear":
            # the witness: JAX's same leg read at the same points, the
            # untrained net's reading equal to JAX's on that net, the
            # trained one in JAX's band and at least half JAX's fall
            same = abs(first - NB_D_BEFORE_JAX) <= 1e-4 * NB_D_BEFORE_JAX
            print(f"    before: {first:.6g} against JAX's {NB_D_BEFORE_JAX:.6g}"
                  f" on the same net and points ({'equal' if same else 'DIFFER'}"
                  " within 1e-4)")
            ok = [same, in_band("general_linear RMS after training", last,
                                NB_D_AFTER_JAX),
                  fell(first, last, (NB_D_BEFORE_JAX,), NB_D_AFTER_JAX,
                       "RMS")]
            check(all(ok), f"(d) general_linear: against JAX's witness "
                  f"({first:.4g} -> {last:.4g})")
        del s
    print("  walls: " + "; ".join(f"{k} {w:.2f} s" for k, w in walls.items()))
    print(f"  card: {smi}")
    print(f"  phase 39 took {time.perf_counter() - t39:.1f} s")


if __name__ == "__main__":
    main()
