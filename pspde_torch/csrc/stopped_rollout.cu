// Training rollout of the stopped-path (first-exit) family: the forward
// kernel and its replay backward, each one launch for all N steps.
//
// Replaces the Pallas TPU kernels of pspde/rollout/kernels.py:
// make_fused_stopped_train_rollout, its forward _fwd (pallas_call at
// kernels.py:1184) and its backward _bwd (pallas_call at kernels.py:1272).
// Per path k and step n, with a DenseNet value net V (relu^2 concat-skip
// features, d_out = 1), zero drift, sigma = s I, the ball's exit test on
// the CURRENT state (none on the 'unbounded' geometry), and c = -sg(Z) when
// adaptive, else 0:
//
//   active = !stopped,  sel = |X| < R,  adv = sel & active
//   V, Z = s grad_x V(X),  h = V (c_y + c_yr2 |X|^2)
//                              + phi(exp(k |X|^2 + k_t t) - V^2)
//   a    = ((-h + Z.c) dt + (Z.xi) sqrt(dt)) adv                  Y += a
//   X   += (s c dt + s xi sqrt(dt)) adv                (no gradient)
//   hitting += active,  adv_steps += adv,
//   v_l2 += (V - exp(a_v |X|^2))^2 dt active
//   stopped |= !sel
//
// With time_stopping (the general, space-time solver: the time_stopping
// branch of step_math, pspde/rollout/kernels.py:1045-1082) each path
// carries its own clock t, started at t0[k]: the net reads [X, t] (d + 1
// inputs, t last), Z stays the gradient in the d state rows only, and
//
//   sel = |X| < R  &&  t + dt <= T,        t += dt adv
//
// in float32 with explicit roundings, as the plain version tests it.  The
// state has d rows, the net d_in = d or d + 1 input rows; F = d_in + sum of
// the hidden widths.
//
// The torus family (the eigenvalue solver on FokkerPlanckEigen: the square
// [X_l, X_r]^d, the proposal's exit test of pspde/rollout/kernels.py:
// 1058-1063, and the lambda leaf of the kernel's "value-net weights
// [+ lam]") replaces the drift, h, the reference and the exit test, with
// s = c sum_j cos X_j and the eigenvalue lambda, read from the packed net:
//
//   b_j = -cos(s) c sin(X_j),  h = V (-c^2 sum_j sin^2 X_j sin(s)
//                                     - cos(s) s) + lambda V
//   P   = X + (b + s c) dt + s xi sqrt(dt)     (the proposal; noise first)
//   sel = X_l <= P_j <= X_r for every j,       X = P if adv
//   v_l2 += (V - exp(-sin(s)))^2 dt active
//
// A path whose proposal leaves is counted in hitting and v_l2, does not
// move, adds nothing and stops.  The backward's gradient row carries one
// more entry, d/dlambda = sum -gY V dt over the advancing steps.
//
// The breadth families (the committor and the full-Hessian elliptic
// problem: zero drift, no clock) widen the ball family by four things, read
// from StoppedExt, the kernels' last argument:
//
//   sel = a < |X| < c                      (geometry 3, the two spheres;
//                                           the current state, as the ball)
//   h  += c_ys1 V (sum_j X_j)^2            (the sum beside |X|^2, in order)
//   v_l2 against the committor's (a^2 - r^(2-d) a^d) / (a^2 - c^(2-d) a^d)
//   a dense sigma (diag or full, d x d row-major after the packed net):
//     X_j += (sum_i sigma_ji c_i) dt + (sum_i sigma_ji xi_i) sqrt(dt),
//     Z_j  = sum_i sigma_ij (grad V)_i,    w = gY adv sigma (xi sqrt(dt)
//                                                           + c dt)
//
// each sum over i ascending in one device function that both kernels call
// (full_z, full_step), so that the forward's lanes and the backward's
// replay form the X chain bitwise alike.  The forward's lane splits the
// rows, so Z and the normals go through per-path rows (d each) that the
// lane meets on before the step of X reads them all; the backward keeps
// the normals and Z in 2 d rows of its own.  sigma is staged with the net
// where the net is.  kBreadth and kFull (dense sigma) are template
// parameters like the others, instantiated only for these families, and
// StoppedExt is an argument of its own after the old ones, so that every
// older instantiation keeps its constant-bank offsets and its SASS.
//
// The cubic family (AllenCahn, h = y - y^3: the clock, the whole space or
// the sphere) is the ball family with one more term from StoppedExt,
//
//   h += c_y3 V^3,     dh/dy += 3 c_y3 V^2,
//
// in the instantiations <kTimed = true, kBreadth = true> (cubic_h_value,
// cubic_h_dy), which test the exit and the clock as the other kTimed ones
// do; the breadth families' other terms stay without the clock.
//
// The Schroedinger family (the eigenvalue solver on SchrodingerEigen:
// zero drift on the square [X_l, X_r]^d with the proposal's exit test and
// the lambda leaf, as the torus family) replaces h and the reference, with
// S = sum_j cos X_j and the potential
//
//   pot = -(1/c^2) exp((2/d) S) + sum_j (sin^2 X_j / d^2 - cos X_j / d) - 3,
//   h = -V^3 - V pot + lambda V,    dh/dy = -3 V^2 - pot + lambda,
//   P = X + s c dt + s xi sqrt(dt),  v_l2 += (V - (1/c) exp((1/d) S))^2 dt
//
// in float32 term by term as pspde's SchrodingerEigen.h_T forms them (the
// constants -1/c^2, 1/c, 2/d and 1/d from StoppedExt, Python floats
// rounded to float32 as JAX's weak types round them; the divisions by d^2
// and d as divisions).  Its value net is a DenseNetTanh: tanh(h) features
// where the DenseNet has relu(h)^2, so
//
//   f = tanh(h),  f' = (1 - f^2) h',  f'' = -2 f (1 - f^2),
//
// with the slope 1 - f^2 kept where relu(h) was (value_forward's r rows),
// formed in one device function (tanh_slope) that both kernels call.  The
// family (kSch) and the feature map (kTanh) are template parameters after
// the old ones, instantiated together, and their fields (StoppedExt's
// feat, hfam and the four constants) come after StoppedExt's old ones, so
// that every older instantiation keeps its SASS.
//
// With the output clamp (DenseNet output_relu) V = relu(o) of the output
// o: Z, the step's increment and both sweeps of the backward carry the
// mask 1[o > 0] (the gradient at o = 0 is 0, as in JAX and torch).
//
// The clock (kTimed), the torus family (kTorus) and the clamp (kRelu) are
// template parameters of both kernels, so an instantiation carries none of
// the code its family does not run: as a runtime flag the clock cost the
// elliptic forward 25% at DenseNet (30, 30) and 37% at the notebook net
// (d = 50, K = 65536, N = 20, NVIDIA H100 80GB HBM3 at 700 W).
//
// The forward writes X (K, d) and the (6, K) rows Y, stopped, hitting,
// v_l2, adv_steps, t.  The masks and the X chain carry no gradient, so Y
// depends on the net's parameters theta only through each step's V and
// grad V.  The backward replays the forward on the same noise (the X chain
// and the masks regenerate bitwise: both kernels run the same device
// functions, written with explicit fmaf / __fadd_rn so that no contraction
// can differ between them) and accumulates, per step,
//
//   d/dtheta [ alpha V(X) + w^T grad V(X) ],
//   alpha = gY adv (-dh/dy) dt,   w = gY adv s (xi sqrt(dt) + c dt),
//
// where w is parameter-free (c is a stop-gradient, h is z-free).  w^T grad V
// is the directional derivative D_x V[w]: one forward sweep carries the
// primal and its tangent in direction w (a' = 2 relu(h) h'), one reverse
// sweep over the pair (relu^2'' = 2 [h > 0]) accumulates the weight
// gradients of both terms.  No Hessian, no reverse sweep over time, no
// stored path.  Each block writes its sums to one row of a (grid, n_grad)
// array that the wrapper sums: deterministic, no atomics.
//
// What bounds them on an H100: at d = 50, DenseNet (30, 30) an advancing
// forward path-step is ~16.3 kFLOP (V and grad V) and a backward one
// ~36.5 kFLOP (~44 kFLOP adaptive: the replay, the tangent and pair
// sweeps, the weight-gradient outer products); no device-memory traffic
// but the gradient rows.  Paths leave the ball after ~1.4 steps from the
// uniform start, so the work is a few steps per path.  The per-path arrays
// live in shared memory (3 F + 3 H + 1 floats in the backward, 139 KB for
// 64 paths at (30, 30); 2 F + H + d in the forward), which bounds the
// paths an SM holds.  On the whole space with time_stopping (the heat
// equation) every path runs until its clock ends and all K N path-steps
// are work; on the torus (d = 5, DenseNet (10, 10, 10, 10): ~1 kFLOP a
// path-step) most paths run all N steps, and at the recipe's K = 500 there
// are fewer paths than the card has lanes.
//
// The forward is built for the card.  It ran one thread a path in blocks
// of 64 until each block's slowest path stopped: two warps an SM, each a
// serial, latency-bound chain of shared loads and FMAs.  Now:
//   * A lane (tpp threads of one warp) carries one path at a time, and
//     lanes are refilled: lane i of block b starts with path b tile + i and
//     then takes the next path of one queue (a device-memory counter the
//     wrapper zeroes) each time its path ends, on a grid that fills the
//     card once.  The loop takes one step of the lane's path a trip, so a
//     lane whose path ends starts the next while the warp's other lanes go
//     on.  Outputs are per path, so the order in which the lanes take the
//     paths changes no bit.  Where paths run their N steps (the torus, the
//     whole space) the wrapper launches one block per tile paths instead,
//     and the block scheduler balances the SMs.
//   * Each path's net is split over its lane's threads (lane_value_forward,
//     lane_value_grad): thread q computes the output chunks q, q + p, ... of
//     each hidden layer (matvec_chunk, as before) and the rows q, q + p, ...
//     of grad V's sums (two rows a pass, as two chains); each sum stays one
//     thread's, in the order of value_forward and value_grad, which the
//     backward's replay runs.  The Philox draws are split by dimension
//     group, and |X|^2, the torus terms and the increment's sums over j run
//     in every thread of the lane alike.  So the outputs of every layout
//     (tile, tpp, grid) are bitwise the old kernel's, and the backward,
//     which must regenerate the X chain and the masks bitwise, needs no
//     change.
//   * More warps an SM: blocks of up to 256 threads (tile x tpp), 16 warps
//     an SM at the elliptic cell where there were 2.  Shared memory is then
//     the limit: its loads of grad V's weights, whose rows the threads of a
//     lane read at once, fell in one bank where a row held a multiple of 32
//     floats; the staged copy pads each row by kRowPad floats (FwdNet).
//   * The step that stops computes V only where v_l2 reads it.
//   * Where the net fits no block beside the lanes' arrays (the Allen-Cahn
//     notebook's), the forward is stopped_fwd_block_kernel instead: tiles
//     of paths that step together, each layer one product over the tile
//     with the weights streamed through shared memory, bitwise this
//     kernel's (its note below).
// The backward is built for the card:
//   * Lanes are refilled.  With one block per tile paths for all N steps,
//     a block ran until its slowest path stopped: at the elliptic cell
//     (d = 50, K = 65536, N = 20) 1024 blocks ran 6,155 block-steps for
//     92,479 advancing path-steps, so only 23.5% of the lane-steps carried
//     a path that advances, and everything done per block-step (the
//     waiting lanes at the barrier, the whole weight-gradient phase) was
//     paid ~4x over.  Now the grid fills the card once (at most the blocks
//     it holds at once), each block owns a contiguous range of whole tiles
//     of paths, and at each step's barrier the lanes whose path has stopped
//     or run its N steps take the range's next paths in lane order (a
//     block-wide ballot and prefix count: no atomics, the same bits on
//     every launch).  A path starts at its own step n = 0, so its noise
//     stays keyed by (seed, k, n, j / 4).  On the ball and the whole space
//     the exit test of the next step is made at the end of a step, so a
//     lane never spends a step on a path that stops.  At the elliptic cell
//     132 blocks run 1,949 block-steps (lane use 74.2%, as each block
//     counts its own; NVIDIA H100 80GB HBM3).  Where paths run their N
//     steps (the torus at K = 65536) the refill gains nothing, and the
//     static ranges cost the per-SM balance that 1024 blocks of one tile
//     get from the block scheduler: 4.1 ms there against 3.6 on 1024
//     blocks (NVIDIA H100 80GB HBM3, 700 W).
//   * The shared plan's replay runs one thread a path.  The X chain and
//     the masks must regenerate bitwise, and they do only if each path
//     runs the forward's arithmetic (value_forward and value_grad, whose
//     sums the forward's lanes split without reordering one; torus_terms,
//     torus_step, step_of, selected, draw4) in the forward's order.
//   * Each step's weight-gradient sums, half of the work before (2 FMAs
//     against 4 shared loads per path and entry, scalar), run on the
//     tensor cores: for each hidden layer one product G_l += [f; f']^T
//     [hbar; hbar'] of depth 2 tile (paths, then tangents; the bias a row
//     of ones), mma.sync m16n8k8 TF32.  One TF32 product keeps 2^-11 of
//     each operand, and a gradient summed over 10^5 path-steps of both
//     signs would then miss float32's accuracy by 100x, so every operand is
//     split into big = rna(x) and small = rna(x - big) and three products
//     (big big, big small, small big) keep float32's (3xTF32, as the HJB
//     backward).  The output row (F + 1 entries) stays scalar.  What
//     bounds the products is latency (a warp per SM sub-partition, in
//     order): with the replay's sweeps they are now ~20% of the elliptic
//     backward, no faster than the scalar loop at the torus's 10 columns.
//   * The shared plan's per-path arrays are [row][tile + 4] (conflict-free
//     fragments; tile + 1 for nets too wide for that) in shared memory;
//     the net is staged per block when it fits beside them, else read from
//     device memory (broadcast loads that L1 serves; the notebook net
//     DenseNet (70, 50, 50, 50), 131 KB of weights, fits beside no tile);
//     the block's gradient row lives in device memory (the notebook net's
//     29,491 entries would not fit in shared memory either); the lambda
//     entry is summed in a register per lane and over the block once, at
//     the end.
//   * The device plan (stopped_bwd_lane_kernel, in stopped_bwd_lanes.cu,
//     with its own note) runs the same replay, refill and products on
//     lanes of tpp threads, bitwise the shared plan's rows at one tile.
//   * The torus's proposal takes the rows 0..d of grad V (forward) and of
//     the step (backward), which are free by then.
//
// Noise: host noise (N, K, d), or Philox4x32-10 keyed by (seed, k, n, j / 4)
// through the erfinv map (default) or the binom map; the seed is a device
// word that each thread reads once at entry (stopped_seed), so that a
// captured CUDA graph reads the value written there before each replay.  The plain version
// (pspde_torch/rollout/kernels.py: reference_stopped_train_rollout) draws
// the same stream.

#include "stopped_common.cuh"

namespace {

using namespace pspde;

constexpr int kStoppedTile = 64;
// The backward's bound: shared memory, not registers, bounds its blocks per
// SM (one thread per path, at most 64 threads a block), so it asks for one
// block per SM in __launch_bounds__: without it ptxas keeps it at 40-64
// registers and spills (91-106 and none with it; the notebook net's
// backward 163 -> 99 ms at d = 50, K = 65536, N = 20 on an NVIDIA H100 80GB
// HBM3 at 700 W).  The forward has its own (kFwdThreads, kFwdMinBlocks).
constexpr int kMinBlocksPerSm = 1;

// -- the forward -------------------------------------------------------------

// The forward's block: `tile` lanes of `tpp` threads (tile x tpp a multiple
// of 32, at most kFwdThreads); a lane carries one path at a time.  The
// bound caps registers at 65,536 / (kFwdThreads x kFwdMinBlocks) = 128 a
// thread, two blocks of the largest layout an SM: every instantiation
// takes all 128 without a spill, and the layouts the wrapper chooses run
// 16 warps an SM (the notebook net's 8: one block of 195 KB with the net
// staged).  Caps of 80 (3 blocks) and 64 (4, with spills) read
// within a few per cent of it at the timed cells and 8% slower on the torus
// at K = 500 (experiments/torch_kernel_times.py --layouts stopped on copies
// with the cap changed; NVIDIA H100 80GB HBM3 at 700 W).
constexpr int kFwdThreads = 256;
constexpr int kFwdMinBlocks = 2;
constexpr int kFwdMaxTile = 64;

template <bool kTimed, bool kTorus, bool kRelu, bool kFull, bool kBreadth,
          bool kSch, bool kTanh>
__global__ void __launch_bounds__(kFwdThreads, kFwdMinBlocks)
stopped_fwd_kernel(const StoppedArgs a, const float* __restrict__ P,
                   const float* __restrict__ noise,
                   const float* __restrict__ X0,
                   const float* __restrict__ t0, float* __restrict__ X_out,
                   float* __restrict__ acc_out, int* __restrict__ queue,
                   const int tpp, const StoppedExt ext) {
  extern __shared__ float4 smem4[];
  float* S = reinterpret_cast<float*>(smem4);
  const int ts = a.tile + 1;
  const Lane ln(threadIdx.x, tpp);
  const int slot = threadIdx.x / tpp;    // the lane's column of the arrays
  float* col = S + slot;
  const FwdNet net = stage_fwd_net(a, P, S, &col);
  __syncthreads();   // no barrier below
  count_launch(a.launches);
  const uint2 key = stopped_seed(a);

  const int d_in = net_inputs<kTimed>(a);
  float* f = col;                        // features: X, [t,] relu(h)^2
  float* r = f + a.F * ts;               // relu(h) of the hidden layers
  float* g = r + (a.F - d_in) * ts;      // dV/d(features); on the square
                                         // rows 0..d then hold the proposal
  float* xs = g + a.F * ts;              // the step's normals; kFull: Z
                                         // in the d rows after them
  const float lam = kTorus ? P[a.lam_off] : 0.0f;   // not W: unstaged yet
  // Paths: lane i of block b first takes path b tile + i, then the next
  // path of the queue (one counter for the grid) each time its path ends.
  const int first = gridDim.x * a.tile;
  int k = blockIdx.x * a.tile + slot;
  int n = 0, trips = 0;
  float t = 0.0f, Y = 0.0f, hit = 0.0f, vl2 = 0.0f, advs = 0.0f;
  bool stopped = false;

  auto start = [&]() {
    for (int j = ln.q; j < a.d; j += ln.p)
      f[j * ts] = X0[static_cast<size_t>(k) * a.d + j];
    t = t0[k];
    Y = hit = vl2 = advs = 0.0f;
    stopped = false;
    n = 0;
    ln.sync();
  };

  // Step n of path k, the old one-thread loop's body with the net split
  // over the lane's threads; false where the path stops at this step.
  auto step = [&]() -> bool {
    float r2 = 0.0f, s = 0.0f, qs = 0.0f;   // kSch: s = S, qs = pot
    bool sel = true;
    float s1 = 0.0f;   // kBreadth: sum_j X_j, read before X moves
    if constexpr (kSch) {
      sch_terms(a, ext, f, ts, &s, &qs);
    } else if (kTorus) {
      torus_terms(a, f, ts, &s, &qs);
    } else {
      r2 = sq_norm(f, a.d, ts);
      if constexpr (kBreadth && !kTimed) {
        s1 = coord_sum(f, a.d, ts);
        sel = breadth_selected(a, ext, r2);
      } else {
        sel = selected<kTimed>(a, r2, t);
      }
    }
    hit += 1.0f;
    if (!sel && !a.have_vref) {   // V would not be read: the net is not run
      stopped = true;
      return false;
    }
    if (kTimed) {
      if (ln.q == 0) f[a.d * ts] = t;
      ln.sync();
    }
    const float o = lane_value_forward<kTimed, kTanh>(a, net, f, r, ts, ln);
    const bool on = !kRelu || o > 0.0f;   // the output clamp's mask
    const float V = on ? o : 0.0f;
    if (a.have_vref) {
      if constexpr (kSch) {
        const float e = V - sch_vref(ext, s);
        vl2 += e * e * a.dt;
      } else if constexpr (kBreadth && !kTimed) {
        const float e = V - breadth_vref(a, ext, r2);
        vl2 += e * e * a.dt;
      } else {
        const float e = V - (kTorus ? expf(-sinf(s)) : expf(a.a_vref * r2));
        vl2 += e * e * a.dt;
      }
    }
    if (!sel) {
      stopped = true;
      return false;
    }
    if (on) lane_value_grad<kTimed, kTanh>(a, net, r, g, ts, ln);
    ln.sync();   // grad V complete, and every read of X by the net done
    float h;
    if constexpr (kSch) {
      h = fmaf(lam, V, sch_h(V, qs));
    } else if constexpr (kBreadth && kTimed) {
      h = cubic_h_value(a, ext, r2, t, V);
    } else if constexpr (kBreadth) {
      h = breadth_h_value(a, ext, r2, s1, V);
    } else {
      h = kTorus ? fmaf(lam, V, V * torus_h_dy(s, qs))
                 : h_value<kTimed>(a, r2, t, V);
    }
    const float m_cs = kTorus ? -cosf(s) : 0.0f;
    if constexpr (kFull) {
      // thread q draws the normals of dimension groups q, q + p, ... into
      // xs and forms Z of the same rows into zr; the lane meets, then each
      // thread moves its coordinates by full_step, which reads every row
      // of both and of sigma (after the net, and staged with it)
      float* zr = xs + a.d * ts;
      const float* sg = net.W + ext.sig_off + net.shift[a.L];
      for (int gi = ln.q; 4 * gi < a.d; gi += ln.p) {
        float xi[4];
        draw4(a, key, noise, k, n, gi, xi);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = 4 * gi + q;
          if (j >= a.d) break;
          xs[j * ts] = xi[q];
          zr[j * ts] = on ? full_z(sg, g, a.d, j, ts) : 0.0f;
        }
      }
      ln.sync();
      for (int gi = ln.q; 4 * gi < a.d; gi += ln.p)
        for (int j = 4 * gi; j < min(4 * gi + 4, a.d); ++j)
          f[j * ts] = __fadd_rn(f[j * ts], full_step(a, sg, zr, xs, j, ts));
    } else {
      // thread q draws the normals of dimension groups q, q + p, ... into
      // xs and, off the torus, moves those coordinates
      for (int gi = ln.q; 4 * gi < a.d; gi += ln.p) {
        float xi[4];
        draw4(a, key, noise, k, n, gi, xi);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = 4 * gi + q;
          if (j >= a.d) break;
          xs[j * ts] = xi[q];
          if (!kTorus) {
            const float z = on ? a.sig * g[j * ts] : 0.0f;
            const float c = a.adaptive ? -z : 0.0f;
            f[j * ts] = __fadd_rn(f[j * ts], step_of(a, c, xi[q]));
          }
        }
      }
    }
    ln.sync();
    // the increment's sums over j, in order, in every thread of the lane
    float s_zc = 0.0f, s_zx = 0.0f;
    if constexpr (kFull) {
      const float* zr = xs + a.d * ts;
      for (int j = 0; j < a.d; ++j) {
        const float z = zr[j * ts];
        const float c = a.adaptive ? -z : 0.0f;
        s_zc = fmaf(z, c, s_zc);
        s_zx = fmaf(z, xs[j * ts], s_zx);
      }
    } else {
      for (int j = 0; j < a.d; ++j) {
        const float z = on ? a.sig * g[j * ts] : 0.0f;
        const float c = a.adaptive ? -z : 0.0f;
        s_zc = fmaf(z, c, s_zc);
        s_zx = fmaf(z, xs[j * ts], s_zx);
      }
    }
    if (kTorus) {
      ln.sync();   // every read of grad V done: its rows 0..d take P
      bool inside = true;
      if constexpr (kSch) {   // zero drift: the ball's step of each row
        for (int gi = ln.q; 4 * gi < a.d; gi += ln.p) {
          for (int j = 4 * gi; j < min(4 * gi + 4, a.d); ++j) {
            const float z = on ? a.sig * g[j * ts] : 0.0f;
            const float c = a.adaptive ? -z : 0.0f;
            const float p =
                __fadd_rn(f[j * ts], step_of(a, c, xs[j * ts]));
            inside = inside && in_box(a, p);
            g[j * ts] = p;
          }
        }
      } else {
        for (int gi = ln.q; 4 * gi < a.d; gi += ln.p) {
          for (int j = 4 * gi; j < min(4 * gi + 4, a.d); ++j) {
            const float z = on ? a.sig * g[j * ts] : 0.0f;
            const float c = a.adaptive ? -z : 0.0f;
            const float p = __fadd_rn(
                f[j * ts], torus_step(a, m_cs, f[j * ts], c, xs[j * ts]));
            inside = inside && in_box(a, p);
            g[j * ts] = p;
          }
        }
      }
      if (!__all_sync(ln.mask, inside)) {   // the proposal left: no move,
        stopped = true;                     // no increment
        return false;
      }
      for (int gi = ln.q; 4 * gi < a.d; gi += ln.p)
        for (int j = 4 * gi; j < min(4 * gi + 4, a.d); ++j)
          f[j * ts] = g[j * ts];
    }
    Y += (-h + s_zc) * a.dt + s_zx * a.sq_dt;
    advs += 1.0f;
    if (kTimed) t = __fadd_rn(t, a.dt);
    return true;
  };

  bool live = k < a.K;
  if (live) start();
  while (live) {
    // one step of the lane's path a trip, so that a lane whose path ends
    // takes the next one while the warp's other lanes go on with theirs
    bool more = false;
    if (n < a.N) {
      more = step();
      ++n;
      ++trips;
      ln.sync();   // the step's reads of the path's rows done
    }
    if (!more || n == a.N) {
      float* dst = X_out + static_cast<size_t>(k) * a.d;
      for (int j = ln.q; j < a.d; j += ln.p) dst[j] = f[j * ts];
      if (ln.q == 0) {
        acc_out[k] = Y;
        acc_out[a.K + k] = stopped ? 1.0f : 0.0f;
        acc_out[2 * a.K + k] = hit;
        acc_out[3 * a.K + k] = vl2;
        acc_out[4 * a.K + k] = advs;
        acc_out[5 * a.K + k] = t;
      }
      int next = 0;
      if (first < a.K && ln.q == 0) next = atomicAdd(queue, 1);
      k = first < a.K ? first + __shfl_sync(ln.mask, next, ln.leader())
                      : a.K;
      live = k < a.K;
      if (live) start();
    }
  }
  if (ln.q == 0) queue[1 + blockIdx.x * a.tile + slot] = trips;
}

// -- the forward for nets that no block stages -------------------------------

// stopped_fwd_block_kernel: the forward of stopped_fwd_kernel for the nets
// whose weights fit no block beside the lanes' arrays (the Allen-Cahn
// notebook's DenseNet (110, 110, 50) on [x, t] at d = 100: 53,576 packed
// floats, 214 KB).  There each lane of stopped_fwd_kernel read the whole
// net from device memory twice a step, the 16 lanes of a block the same
// weights each on its own: 119.7 ms at K = 65536 and 3.36 ms at the
// notebook's K = 200, against 49.6 and 1.31 ms with every row of each W
// read at its row 0 (the same loads from an L1-resident window;
// experiments/torch_fwd_bound_probe.py), so the loads that missed L1 took
// ~60% of its time.  Here a block carries a tile of T paths that step
// together, and each layer is one block-cooperative product over the
// tile's paths:
//   * the value sweep's layer l forms the T x w outputs, thread t the path t
//     mod T and up to kBlockTiles output chunks (8 outputs each) in
//     registers, each output's sum one fmaf chain over the input rows in
//     ascending order from 0, then + b_j, relu and its square: matvec_chunk's
//     arithmetic, so every feature is bitwise the one-thread sweep's;
//   * the weights stream through shared memory: W_l (n_in x padded(w),
//     row-major, as packed) in slices of whole rows, a ring of `stages`
//     buffers of `cap` floats filled by cp.async while the block works on
//     the slice before, so each weight comes from L2 once a block-step and
//     feeds the tile's T paths;
//   * grad V's layer l is the same product over W_l^T (w x padded(n_in),
//     the wrapper's transposed copy): row i's sum over the layer's outputs
//     is one thread's fmaf chain in ascending order, then g_i += s, as in
//     value_grad;
//   * the path's scalar chains (|X|^2, the output row V, the increment's
//     sums over j, h, the exit and the clock) stay in one thread a path, the
//     normals and the move of X are split over the block by (path,
//     dimension group), each in the one-thread order.
// So X, Y, stopped, hitting, v_l2, adv_steps and t are bitwise those of
// stopped_fwd_kernel, whose chains stopped_bwd_lane_kernel replays.  A path
// that stops idles in its tile until the tile ends (no refill): the family
// set is the lanes backward's (the ball, the clock's families, the cubic,
// the torus), and the nets no block stages run on the whole space.  g's
// hidden rows share the features' rows (the features are not read after V),
// so a path holds F + H + d_in + d floats.  FP32 FMAs throughout: a
// tensor-core product would change the bits the backward replays.
// Times (device ms by the profiler, parent and change in one call of
// experiments/torch_kernel_times.py --allen-cahn; NVIDIA H100 80GB HBM3
// at 700.00 W): K = 65536 119.0-119.8 -> 25.6-25.7 (tiles of 16 paths on
// 128 threads, 3 blocks an SM), K = 200 3.26-3.31 -> 0.88-0.91 (tiles of
// 2 on 128 threads); the layouts by experiments/torch_fwd_layouts.py.
// What bounds it now is latency: each row of a product is one step of
// every output's chain, ~33 cycles a row at K = 200 with a few warps an SM
// (experiments/torch_fwd_block_phases.py), and at K = 65536 the products'
// loads and FMAs at 12 warps an SM (5.4x the FP32 FLOP bound).
constexpr int kBlockThreads = 256;   // at most, a block
constexpr int kBlockMinBlocks = 2;
constexpr int kBlockMaxTile = 32;    // paths a block, a power of two
constexpr int kBlockTiles = 4;       // output chunks a thread holds a pass

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most stages - 2 of this thread's copy groups are pending
// (stages 2 or 3).
__device__ __forceinline__ void cp_async_wait_ring(int stages) {
  if (stages >= 3)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The block's ring of weight slices: `stages` buffers of `cap` floats.
struct Ring {
  float* buf;
  int cap, stages;
};

// Rows r0..r1 of M (row stride C floats, 16-byte aligned) into buffer s.
__device__ __forceinline__ void ring_fill(const Ring& ring, int s,
                                          const float* __restrict__ M, int C,
                                          int r0, int r1) {
  float* dst = ring.buf + s * ring.cap;
  const float* src = M + static_cast<size_t>(r0) * C;
  const int n4 = (r1 - r0) * C / 4;
  for (int x = threadIdx.x; x < n4; x += blockDim.x)
    cp_async16(dst + 4 * x, src + 4 * x);
}

// out[p][j] = sum_{i < R} in[i][p] M[i][j] for the T paths of the block (in
// a [row][T] array) and the C columns of M (R x C row-major in device
// memory, C a multiple of kChunk, at most the ring's cap): each sum one
// fmaf chain over i ascending from 0, as matvec_chunk's.  Thread t takes
// path t mod T and, in a pass, the chunks t / T + m NT / T (m < kM, the
// fewest of 1, 2 and kBlockTiles that cover the matrix's chunks, so that
// no thread runs tiles that no thread needs); more passes where the chunks
// outnumber kBlockTiles NT / T, every thread in every pass (the block meets
// in each).  M streams through the ring in slices of cap / C rows, the
// next slices in flight while the block works on one.  epi(p, j0, acc)
// takes the 8 sums of the chunk at column j0; the block meets before the
// epilogues (the ring free again) and after them (their rows written).
template <int kM, typename Epi>
__device__ __forceinline__ void product_pass(const float* __restrict__ M,
                                             int R, int C, const float* in,
                                             const Ring& ring, int T,
                                             int base, Epi epi) {
  const int tid = threadIdx.x;
  const int p = tid & (T - 1), slots = blockDim.x / T;
  const int c0 = base + tid / T, n_chunks = C / kChunk;
  const int S = ring.cap / C;
  const int n_slices = (R + S - 1) / S;
  const float* col = in + p;
  // each tile's columns, a chunk past the matrix clamped to its last: the
  // loop below has no branch, and the epilogue drops those sums
  int cols[kM];
  float acc[kM][kChunk];
#pragma unroll
  for (int m = 0; m < kM; ++m) {
    cols[m] = min(c0 + m * slots, n_chunks - 1) * kChunk;
#pragma unroll
    for (int c = 0; c < kChunk; ++c) acc[m][c] = 0.0f;
  }
  for (int s = 0; s + 1 < ring.stages; ++s) {
    if (s < n_slices) ring_fill(ring, s, M, C, s * S, min(R, (s + 1) * S));
    cp_async_commit();
  }
  for (int k = 0; k < n_slices; ++k) {
    cp_async_wait_ring(ring.stages);
    __syncthreads();   // slice k in, and every read of slice k - 1 done
    const int nx = k + ring.stages - 1;
    if (nx < n_slices)
      ring_fill(ring, nx % ring.stages, M, C, nx * S, min(R, (nx + 1) * S));
    cp_async_commit();
    const float* Ms = ring.buf + (k % ring.stages) * ring.cap;
    const int i0 = k * S, rows = min(S, R - i0);
#pragma unroll(kM == 1 ? 8 : kM == 2 ? 4 : 1)
    for (int r = 0; r < rows; ++r) {
      const float a = col[(i0 + r) * T];
      const float* Mr = Ms + r * C;
#pragma unroll
      for (int m = 0; m < kM; ++m) {
        const float4 w0 = *reinterpret_cast<const float4*>(Mr + cols[m]);
        const float4 w1 = *reinterpret_cast<const float4*>(Mr + cols[m] + 4);
        acc[m][0] = fmaf(a, w0.x, acc[m][0]);
        acc[m][1] = fmaf(a, w0.y, acc[m][1]);
        acc[m][2] = fmaf(a, w0.z, acc[m][2]);
        acc[m][3] = fmaf(a, w0.w, acc[m][3]);
        acc[m][4] = fmaf(a, w1.x, acc[m][4]);
        acc[m][5] = fmaf(a, w1.y, acc[m][5]);
        acc[m][6] = fmaf(a, w1.z, acc[m][6]);
        acc[m][7] = fmaf(a, w1.w, acc[m][7]);
      }
    }
  }
  __syncthreads();   // every read of the ring done
#pragma unroll
  for (int m = 0; m < kM; ++m) {
    const int c = c0 + m * slots;
    if (c < n_chunks) epi(p, c * kChunk, acc[m]);
  }
}

template <typename Epi>
__device__ __forceinline__ void block_product(const float* __restrict__ M,
                                              int R, int C, const float* in,
                                              const Ring& ring, int T,
                                              Epi epi) {
  const int slots = blockDim.x / T, n_chunks = C / kChunk;
  for (int base = 0; base < n_chunks; base += kBlockTiles * slots) {
    const int m = (n_chunks - base + slots - 1) / slots;   // block-uniform
    if (m <= 1)
      product_pass<1>(M, R, C, in, ring, T, base, epi);
    else if (m <= 2)
      product_pass<2>(M, R, C, in, ring, T, base, epi);
    else
      product_pass<kBlockTiles>(M, R, C, in, ring, T, base, epi);
  }
  __syncthreads();
}

// The torus family's h = lambda V + V (-q sin(s) - cos(s) s) with each
// rounding written out: the contraction that stopped_fwd_kernel's build of
// torus_h_dy takes (the other two orders, fmaf(-q, sin(s), -(cos(s) s))
// and no fma, move Y on ~1.5% of the torus's paths; NVIDIA H100 80GB HBM3).
__device__ __forceinline__ float torus_h_block(float lam, float V, float s,
                                               float q) {
  const float dy = fmaf(-cosf(s), s, -__fmul_rn(q, sinf(s)));
  return fmaf(lam, V, __fmul_rn(V, dy));
}

// The layout ints of a launch (after StoppedArgs' and StoppedExt's): the
// block's threads, the ring's floats a buffer and its buffers.
struct BlockLayout {
  int threads, cap, stages;
};

// Shared memory of one block, in floats: the step's flags (two words a
// path), the output row wL (F floats), the tile's F + H + d_in + d rows of
// T floats, and the ring, each part a multiple of 4 floats (the ring's
// float4 alignment).  The wrapper's _stopped_fwd_block_bytes computes the
// same.
size_t block_smem_floats(const StoppedArgs& a, const BlockLayout& lay) {
  const size_t d_in = a.time_stopping ? a.d + 1 : a.d;
  const size_t rows = a.F + (a.F - d_in) + d_in + a.d;
  const size_t T = a.tile;
  return (2 * T + 3) / 4 * 4 + (a.F + 3) / 4 * 4 + (rows * T + 3) / 4 * 4 +
         static_cast<size_t>(lay.stages) * lay.cap;
}

template <bool kTimed, bool kTorus, bool kRelu, bool kBreadth>
__global__ void __launch_bounds__(kBlockThreads, kBlockMinBlocks)
stopped_fwd_block_kernel(const StoppedArgs a, const float* __restrict__ P,
                         const float* __restrict__ WT,
                         const float* __restrict__ noise,
                         const float* __restrict__ X0,
                         const float* __restrict__ t0,
                         float* __restrict__ X_out,
                         float* __restrict__ acc_out,
                         int* __restrict__ trips_out, const int cap,
                         const int stages, const StoppedExt ext) {
  static_assert(!kBreadth || kTimed, "the cubic is the one breadth family "
                "of this kernel");
  extern __shared__ float4 smem4[];
  const int T = a.tile, tid = threadIdx.x, NT = blockDim.x;
  const int d_in = net_inputs<kTimed>(a), H = a.F - d_in, d = a.d;
  int* flag = reinterpret_cast<int*>(smem4);   // the step's flags a path
  float* mcs = reinterpret_cast<float*>(smem4) + T;   // the torus's -cos(s)
  float* wL = reinterpret_cast<float*>(smem4) + (2 * T + 3) / 4 * 4;
  float* f = wL + (a.F + 3) / 4 * 4;
  float* r = f + a.F * T;        // relu(h) of the hidden layers
  float* gin = r + H * T;        // dV/d(inputs); on the square rows 0..d
                                 // then hold the proposal
  float* xs = gin + d_in * T;    // the step's normals
  const int n_rows = a.F + H + d_in + d;
  const Ring ring{f + (n_rows * T + 3) / 4 * 4, cap, stages};
  // g: rows 0..d_in in gin, the hidden rows in the features' rows
  auto grow = [&](int i) { return i < d_in ? gin + i * T : f + i * T; };
  int wt_floats = 0;   // W_l^T is w x padded(n_in), layer after layer
  for (int l = 0, n_in = d_in; l < a.L; ++l) {
    wt_floats += a.width[l] * padded(n_in);
    n_in += a.width[l];
  }
  constexpr int kAdv = 1, kOn = 2, kInside = 4;

  const int k0 = blockIdx.x * T;
  const bool owner = tid < T;    // thread p carries path k0 + p's scalars
  const int p = tid, k = k0 + tid;
  bool running = owner && k < a.K;
  float t = 0.0f, Y = 0.0f, hit = 0.0f, vl2 = 0.0f, advs = 0.0f;
  float r2 = 0.0f, s = 0.0f, qs = 0.0f, V = 0.0f;
  bool stopped = false, sel = true, on = true;
  int trips = 0;
  for (int x = tid; x < n_rows * T; x += NT) f[x] = 0.0f;
  for (int x = tid; x < a.F; x += NT) wL[x] = P[a.wL_off + x];
  __syncthreads();
  for (int x = tid; x < T * d; x += NT) {
    const int q = x / d, j = x - q * d;
    if (k0 + q < a.K) f[j * T + q] = X0[static_cast<size_t>(k0 + q) * d + j];
  }
  if (running) t = t0[k];
  count_launch(a.launches);
  const uint2 key = stopped_seed(a);
  const float lam = kTorus ? P[a.lam_off] : 0.0f;
  const int G = (d + 3) / 4;   // dimension groups of the normals
  __syncthreads();

  for (int n = 0; n < a.N; ++n) {
    // the exit and the clock test at the pre-step state, one thread a path
    bool need = false;
    if (running) {
      if constexpr (kTorus) {
        torus_terms(a, f + p, T, &s, &qs);
      } else {
        r2 = sq_norm(f + p, d, T);
        sel = selected<kTimed>(a, r2, t);
      }
      hit += 1.0f;
      ++trips;
      if (!sel && !a.have_vref) {   // V would not be read: no net
        stopped = true;
        running = false;
      } else {
        need = true;
        if (kTimed) f[d * T + p] = t;
      }
    }
    if (!__syncthreads_or(need)) break;   // every path has ended

    // the value sweep, one product a layer
    int n_in = d_in;
    for (int l = 0; l < a.L; ++l) {
      const int w = a.width[l], wp = padded(w);
      const float* bl = P + a.b_off[l];
      float* rl = r + (n_in - d_in) * T;
      float* fl = f + n_in * T;
      block_product(P + a.w_off[l], n_in, wp, f, ring, T,
                    [&](int q, int j0, const float(&acc)[kChunk]) {
#pragma unroll
                      for (int c = 0; c < kChunk; ++c) {
                        const int j = j0 + c;
                        if (j < w) {
                          const float rv = fmaxf(acc[c] + bl[j], 0.0f);
                          rl[j * T + q] = rv;
                          fl[j * T + q] = rv * rv;
                        }
                      }
                    });
      n_in += w;
    }

    // V, v_l2 and the exit, one thread a path
    bool adv = false;
    if (need) {
      float v = 0.0f;
      for (int i = 0; i < a.F; ++i) v = fmaf(f[i * T + p], wL[i], v);
      const float o = v + P[a.bL_off];
      on = !kRelu || o > 0.0f;
      V = on ? o : 0.0f;
      if (a.have_vref) {
        const float e = V - (kTorus ? expf(-sinf(s)) : expf(a.a_vref * r2));
        vl2 += e * e * a.dt;
      }
      if (!sel) {
        stopped = true;
        running = false;
      } else {
        adv = true;
      }
    }
    if (owner) flag[p] = (adv ? kAdv : 0) | (adv && on ? kOn : 0) | kInside;
    if (!__syncthreads_or(adv)) continue;

    // grad V where a path reads it (on): from wL down, one product a layer
    if (__syncthreads_or(adv && on)) {
      for (int x = tid; x < a.F * T; x += NT) {
        const int i = x / T;
        grow(i)[x - i * T] = wL[i];
      }
      __syncthreads();
      int o = a.F, wt_off = wt_floats;
      for (int l = a.L - 1; l >= 0; --l) {
        const int w = a.width[l];
        o -= w;   // layer l's outputs are feature rows o..o + w, its
                  // inputs 0..o
        wt_off -= w * padded(o);
        const float* rl = r + (o - d_in) * T;
        float* go = f + o * T;
        for (int x = tid; x < w * T; x += NT)
          go[x] = 2.0f * rl[x] * go[x];
        __syncthreads();
        block_product(WT + wt_off, w, padded(o), go, ring, T,
                      [&](int q, int i0, const float(&acc)[kChunk]) {
#pragma unroll
                        for (int c = 0; c < kChunk; ++c) {
                          const int i = i0 + c;
                          if (i < o) grow(i)[q] += acc[c];
                        }
                      });
      }
    }

    // the normals, and off the square the move of X, by (path, dimension
    // group); consecutive threads take consecutive paths
    for (int x = tid; x < T * G; x += NT) {
      const int gi = x / T, q = x - gi * T;
      const int fq = flag[q];
      if (!(fq & kAdv)) continue;
      float xi[4];
      draw4(a, key, noise, k0 + q, n, gi, xi);
#pragma unroll
      for (int qq = 0; qq < 4; ++qq) {
        const int j = 4 * gi + qq;
        if (j >= d) break;
        xs[j * T + q] = xi[qq];
        if (!kTorus) {
          const float z = (fq & kOn) ? a.sig * gin[j * T + q] : 0.0f;
          const float c = a.adaptive ? -z : 0.0f;
          f[j * T + q] = __fadd_rn(f[j * T + q], step_of(a, c, xi[qq]));
        }
      }
    }
    __syncthreads();

    // the increment's sums over j, in order, one thread a path
    float s_zc = 0.0f, s_zx = 0.0f, h = 0.0f;
    if (adv) {
      for (int j = 0; j < d; ++j) {
        const float z = on ? a.sig * gin[j * T + p] : 0.0f;
        const float c = a.adaptive ? -z : 0.0f;
        s_zc = fmaf(z, c, s_zc);
        s_zx = fmaf(z, xs[j * T + p], s_zx);
      }
      if constexpr (kBreadth) {
        h = cubic_h_value(a, ext, r2, t, V);
      } else if constexpr (kTorus) {
        h = torus_h_block(lam, V, s, qs);
      } else {
        h = h_value<kTimed>(a, r2, t, V);
      }
    }
    if constexpr (kTorus) {
      // the proposal into rows 0..d of g (every read of them done), and
      // whether it stays in the square; then a path that stays moves there
      if (owner) mcs[p] = adv ? -cosf(s) : 0.0f;
      __syncthreads();
      for (int x = tid; x < T * G; x += NT) {
        const int gi = x / T, q = x - gi * T;
        const int fq = flag[q];
        if (!(fq & kAdv)) continue;
        bool inside = true;
        for (int j = 4 * gi; j < min(4 * gi + 4, d); ++j) {
          const float z = (fq & kOn) ? a.sig * gin[j * T + q] : 0.0f;
          const float c = a.adaptive ? -z : 0.0f;
          const float pj = __fadd_rn(
              f[j * T + q],
              torus_step(a, mcs[q], f[j * T + q], c, xs[j * T + q]));
          inside = inside && in_box(a, pj);
          gin[j * T + q] = pj;
        }
        if (!inside) atomicAnd(flag + q, ~kInside);
      }
      __syncthreads();
      if (adv && !(flag[p] & kInside)) {   // the proposal left: no move, no
        stopped = true;                    // increment
        running = false;
        adv = false;
      }
      __syncthreads();
      if (owner) flag[p] = adv ? kAdv : 0;
      __syncthreads();
      for (int x = tid; x < T * d; x += NT) {
        const int q = x / d, j = x - q * d;
        if (flag[q] & kAdv) f[j * T + q] = gin[j * T + q];
      }
      __syncthreads();
    }
    if (adv) {
      Y += (-h + s_zc) * a.dt + s_zx * a.sq_dt;
      advs += 1.0f;
      if (kTimed) t = __fadd_rn(t, a.dt);
    }
  }
  __syncthreads();
  for (int x = tid; x < T * d; x += NT) {
    const int q = x / d, j = x - q * d;
    if (k0 + q < a.K)
      X_out[static_cast<size_t>(k0 + q) * d + j] = f[j * T + q];
  }
  if (owner && k < a.K) {
    acc_out[k] = Y;
    acc_out[a.K + k] = stopped ? 1.0f : 0.0f;
    acc_out[2 * a.K + k] = hit;
    acc_out[3 * a.K + k] = vl2;
    acc_out[4 * a.K + k] = advs;
    acc_out[5 * a.K + k] = t;
  }
  if (owner) trips_out[k] = trips;
}

// -- the replay backward ---------------------------------------------------

// The backward's per-path arrays are [row][ts], ts = tile + 4 where they
// fit: the weight-gradient products read them as mma fragments, element
// (g, c) of an 8 x 4 block of rows and paths at bank (4 g + c) mod 32, 32
// different banks.  Where tile + 4 does not fit (nets wider than ~1,600
// per-path floats at tile 32) the wrapper passes ts = tile + 1, the
// forward's stride: (g + c) mod 32, up to 4-way conflicts, the same sums
// (pspde_torch/rollout/kernels.py: _stopped_bwd_stride).  A thread walking
// its own path reads one word of each row, and any stride serves that.
// Past that (about 1,760 floats a path) the device plan's lanes kernel
// keeps them at stride tile + 4 in shared memory where its smaller tiles
// let them fit, else in a workspace of device memory, ts = grid x tile,
// block b's lanes at columns b tile .. b tile + tile - 1: the fragments
// then read 4 rows of 8 consecutive words (4 sectors) where shared memory
// read 32 banks, the same values in the same order (_stopped_bwd_ws).

// The lane ballots of the refill: two slots of one word per warp, at the
// start of the backward's shared memory (16 bytes, so the staged net after
// them keeps the float4 alignment matvec_chunk reads it with).
constexpr int kWarps = kStoppedTile / 32;
constexpr int kBallotWords = 2 * kWarps;

// One step's weight-gradient sums over the block's paths: for each hidden
// layer G_l[0:n_in + 1, 0:w] += [f; f']^T [hbar; hbar'] on the tensor cores
// (units of 16 rows by kUnitN x 8 columns, dealt to the block's warps in
// turn across the layers), then the output row, scalar: G[wL][i] +=
// sum_p alpha_p f_i[p] + f'_i[p] and G[bL] += sum_p alpha_p.  The arguments
// are this thread's columns; a path without a gradient this step has zero
// f', hbar, hbar' and alpha.  The caller synchronises before (the rows are
// other threads') and after.  The rows are in shared memory (the shared
// plan); lane_weight_grads is the same sums for the lanes kernel, written
// apart so that this code, and the shared plan's SASS, stay as they were.
template <bool kTimed>
__device__ __forceinline__ void step_weight_grads(
    const StoppedArgs& a, const float* f, const float* fd, const float* gb,
    const float* gdb, const float* al, float* G, int ts) {
  const int tid = threadIdx.x, warp = tid >> 5, n_warps = a.tile >> 5;
  const int d_in = net_inputs<kTimed>(a);
  f -= tid;
  fd -= tid;
  gb -= tid;
  gdb -= tid;
  al -= tid;
  int u0 = 0;   // the units of the layers before this one
  int n_in = d_in;
  for (int l = 0; l < a.L; ++l) {
    const int w = a.width[l];
    const int n_groups = (w + 8 * kUnitN - 1) / (8 * kUnitN);
    const int units = (n_in + 16) / 16 * n_groups;
    for (int u = ((warp - u0) % n_warps + n_warps) % n_warps; u < units;
         u += n_warps) {
      const int mt = u / n_groups;
      pair_tile_product<true>(f, gb + n_in * ts, fd,
                              gdb + (n_in - d_in) * ts, n_in, w, ts, a.tile,
                              G + a.g_off[l], 16 * mt,
                              8 * kUnitN * (u - mt * n_groups));
    }
    u0 += units;
    n_in += w;
  }
  // each thread walks the paths from its own offset: entry e reads path
  // (q + e) mod tile at bank (5 e + q) mod 32, no conflict at tile + 4
  float* GL = G + a.gL_off;
  for (int e = tid; e <= a.F; e += a.tile) {
    float s = 0.0f;
    if (e == a.F) {
      for (int p = 0; p < a.tile; ++p) s += al[p];
    } else {
      const float* fi = f + e * ts;
      const float* fdi = fd + e * ts;
      for (int q = 0; q < a.tile; ++q) {
        const int p = (q + e) & (a.tile - 1);
        s = fmaf(al[p], fi[p], s + fdi[p]);
      }
    }
    GL[e] += s;
  }
}

// The shared plan: one thread a path, the per-path arrays at stride ts in
// shared memory.  (Its kernel parameters are kept as they were: one more
// moved ptxas's register allocation of the dense-sigma instantiations;
// experiments/torch_sass_diff.py holds every instantiation's SASS to the
// parent's.)
template <bool kTimed, bool kTorus, bool kRelu, bool kFull, bool kBreadth,
          bool kSch, bool kTanh>
__global__ void __launch_bounds__(kStoppedTile, kMinBlocksPerSm)
stopped_bwd_kernel(const StoppedArgs a, const float* __restrict__ P,
                   const float* __restrict__ noise,
                   const float* __restrict__ X0,
                   const float* __restrict__ t0,
                   const float* __restrict__ gY, float* __restrict__ part,
                   int* __restrict__ counts, const int ts,
                   const StoppedExt ext) {
  extern __shared__ float4 smem4[];
  uint32_t* ballots = reinterpret_cast<uint32_t*>(smem4);
  float* S = reinterpret_cast<float*>(smem4) + kBallotWords;
  const int tile = a.tile, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = tile >> 5;
  float* col = S + tid;
  const float* W = stage_net(a, P, S, &col);
  float* G = part + static_cast<size_t>(blockIdx.x) * a.n_grad;
  for (int e = tid; e < a.n_grad; e += tile) G[e] = 0.0f;
  // the block's paths not yet started: next .. hi (the same in every thread)
  int next = range_start(blockIdx.x, a.K, tile, gridDim.x);
  const int hi = range_start(blockIdx.x + 1, a.K, tile, gridDim.x);

  const int d_in = net_inputs<kTimed>(a);
  const int H = a.F - d_in;              // hidden feature rows
  float* f = col;                        // features (rows 0..d: X, [d: t])
  float* r = f + a.F * ts;               // relu(h) (kTanh: 1 - tanh(h)^2)
  float* fd = r + H * ts;                // tangent of the features (0..d: w;
                                         // the t slot stays 0: Z is the
                                         // gradient in x only)
  float* hd = fd + a.F * ts;             // tangent of h
  float* gb = hd + H * ts;               // cotangent of the features; rows
                                         // 0..d hold the step of X
  float* gdb = gb + a.F * ts;            // cotangent of the hidden tangents
  float* al = gdb + H * ts;              // alpha; kFull: the step's
                                         // normals and Z in the 2 d rows
                                         // after it
  for (float* p = f; p <= al; p += ts) *p = 0.0f;
  count_launch(a.launches);
  const uint2 key = stopped_seed(a);
  const float* wL = W + a.wL_off;
  const float lam = kTorus ? P[a.lam_off] : 0.0f;   // not W: unstaged yet
  float g_lam = 0.0f;                    // this lane's d/dlambda

  // The lane's path k at its step n, its cotangent gy and clock t; `busy`:
  // it has a step to take, with |X|^2 = r2 (ball and whole space: the exit
  // test of step n is made at the end of step n - 1, so a lane never spends
  // a step on a path that stops; on the torus the test needs the step's
  // proposal, and the step that stops is spent).
  int k = 0, n = 0, slot = 0;
  float gy = 0.0f, t = 0.0f, r2 = 0.0f;
  bool busy = false;
  // what the block ran (the same in every thread): its block-steps and
  // the busy lanes summed over them
  int block_steps = 0, lane_steps = 0;
  auto takes_step = [&]() {
    if (n >= a.N) return false;
    if (kTorus) return true;
    r2 = sq_norm(f, a.d, ts);
    if constexpr (kBreadth && !kTimed) {
      return breadth_selected(a, ext, r2);
    } else {
      return selected<kTimed>(a, r2, t);
    }
  };

  for (;;) {
    // Refill: the lanes without a step to take get the next paths of the
    // range, in lane order (a block-wide ballot and prefix count); a path
    // that takes no step frees its lane for the next round.  The block
    // leaves once the range is drained and no lane is busy.
    int n_free;
    for (;;) {
      const uint32_t m = __ballot_sync(0xFFFFFFFFu, !busy);
      if (lane == 0) ballots[slot * kWarps + warp] = m;
      __syncthreads();
      int below = __popc(m & ((1u << lane) - 1u));
      n_free = 0;
      for (int w = 0; w < n_warps; ++w) {
        const int cnt = __popc(ballots[slot * kWarps + w]);
        n_free += cnt;
        if (w < warp) below += cnt;
      }
      slot ^= 1;   // the next round writes the other slot: no second barrier
      if (n_free == 0 || next >= hi) break;
      if (!busy && next + below < hi) {
        k = next + below;
        for (float* p = f; p <= al; p += ts) *p = 0.0f;
        for (int j = 0; j < a.d; ++j)
          f[j * ts] = X0[static_cast<size_t>(k) * a.d + j];
        gy = gY[k];
        t = t0[k];
        n = 0;
        busy = takes_step();
      }
      next = min(hi, next + n_free);
    }
    if (n_free == tile) break;
    ++block_steps;
    lane_steps += tile - n_free;

    bool adv = false;
    bool opened = false;   // with the clamp: adv and o > 0
    if (busy) {
      float s = 0.0f, qs = 0.0f;   // kSch: s = S, qs = pot
      if constexpr (kSch) {
        sch_terms(a, ext, f, ts, &s, &qs);
      } else if (kTorus) {
        torus_terms(a, f, ts, &s, &qs);
      }
      if (kTimed) f[a.d * ts] = t;
      const float v_out = value_forward<kTimed, kTanh>(a, W, f, r, ts);
      const bool on = !kRelu || v_out > 0.0f;   // the output clamp's mask
      const float V = on ? v_out : 0.0f;
      if (a.adaptive && on) value_grad<kTimed, kTanh>(a, W, r, gb, ts);
      const float m_cs = kTorus ? -cosf(s) : 0.0f;
      bool inside = true;
      if constexpr (kFull) {
        // the normals and Z of every row first (Z reads every row of
        // grad V, which the steps then replace), then w and the steps
        float* xr = al + ts;
        float* zr = xr + a.d * ts;
        const float* sg = W + ext.sig_off;   // sigma, after the net
        for (int gi = 0; 4 * gi < a.d; ++gi) {
          float xi[4];
          draw4(a, key, noise, k, n, gi, xi);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int j = 4 * gi + q;
            if (j >= a.d) break;
            xr[j * ts] = xi[q];
            zr[j * ts] =
                a.adaptive && on ? full_z(sg, gb, a.d, j, ts) : 0.0f;
          }
        }
        for (int j = 0; j < a.d; ++j) {
          const float* row = sg + j * a.d;
          float sw = 0.0f;
          for (int i = 0; i < a.d; ++i) {
            const float c = a.adaptive ? -zr[i * ts] : 0.0f;
            sw = fmaf(row[i], xr[i * ts] * a.sq_dt + c * a.dt, sw);
          }
          fd[j * ts] = gy * sw;
        }
        for (int j = 0; j < a.d; ++j)
          gb[j * ts] = full_step(a, sg, zr, xr, j, ts);
      } else {
        for (int gi = 0; 4 * gi < a.d; ++gi) {
          float xi[4];
          draw4(a, key, noise, k, n, gi, xi);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int j = 4 * gi + q;
            if (j >= a.d) break;
            const float c = a.adaptive && on ? -(a.sig * gb[j * ts]) : 0.0f;
            fd[j * ts] = gy * (a.sig * (xi[q] * a.sq_dt + c * a.dt));
            if constexpr (kSch) {   // zero drift on the square
              const float st = step_of(a, c, xi[q]);
              inside = inside && in_box(a, __fadd_rn(f[j * ts], st));
              gb[j * ts] = st;
            } else if (kTorus) {
              const float st = torus_step(a, m_cs, f[j * ts], c, xi[q]);
              inside = inside && in_box(a, __fadd_rn(f[j * ts], st));
              gb[j * ts] = st;
            } else {
              gb[j * ts] = step_of(a, c, xi[q]);
            }
          }
        }
      }
      adv = !kTorus || inside;
      if (adv) {
        opened = on;
        if constexpr (kSch) {
          *al = -gy * (sch_h_dy(V, qs) + lam) * a.dt;
          g_lam = fmaf(-gy * V, a.dt, g_lam);
        } else if (kTorus) {
          *al = -gy * (torus_h_dy(s, qs) + lam) * a.dt;
          g_lam = fmaf(-gy * V, a.dt, g_lam);
        } else {
          if constexpr (kBreadth && kTimed) {
            *al = -gy * cubic_h_dy(a, ext, r2, t, V) * a.dt;
          } else if constexpr (kBreadth) {
            *al = -gy * breadth_h_dy(a, ext, r2, coord_sum(f, a.d, ts), V) *
                  a.dt;
          } else {
            *al = -gy * h_dy<kTimed>(a, r2, t, V) * a.dt;
          }
        }
        if (kTimed) {
          fd[a.d * ts] = 0.0f;
          t = __fadd_rn(t, a.dt);
        }
        // the path's parameter gradient this step; none where the clamp
        // is shut (there V = 0 and Z = 0 near theta)
        if (on) {
          // tangent sweep: h' = W_l f', (relu(h)^2)' = 2 relu(h) h'
          // (kTanh: tanh(h)' = (1 - tanh(h)^2) h')
          int n_in = d_in;
          for (int l = 0; l < a.L; ++l) {
            const int w = a.width[l], wp = padded(w);
            const float* Wl = W + a.w_off[l];
            const float* rl = r + (n_in - d_in) * ts;
            float* hdl = hd + (n_in - d_in) * ts;
            for (int j0 = 0; j0 < wp; j0 += kChunk) {
              float acc[kChunk];
#pragma unroll
              for (int c = 0; c < kChunk; ++c) acc[c] = 0.0f;
              matvec_chunk(Wl, n_in, wp, j0, fd, ts, acc);
#pragma unroll
              for (int c = 0; c < kChunk; ++c) {
                const int j = j0 + c;
                if constexpr (kTanh) {
                  if (j < w) {
                    hdl[j * ts] = acc[c];
                    fd[(n_in + j) * ts] = __fmul_rn(rl[j * ts], acc[c]);
                  }
                } else {
                  if (j < w) {
                    hdl[j * ts] = acc[c];
                    fd[(n_in + j) * ts] = 2.0f * rl[j * ts] * acc[c];
                  }
                }
              }
            }
            n_in += w;
          }

          // reverse sweep over the pair (V, V'): S = alpha V + V' with
          // V' = wL . f'; rows d_in..F of gb / gdb end as the cotangents
          // of h and h' of each hidden layer (kTanh: with f = tanh(h) and
          // its slope s = 1 - f^2, hbar = s fbar - 2 f s h' fbar',
          // hbar' = s fbar')
          for (int i = d_in; i < a.F; ++i) {
            gb[i * ts] = *al * wL[i];
            gdb[(i - d_in) * ts] = wL[i];
          }
          int o = a.F;
          for (int l = a.L - 1; l >= 0; --l) {
            const int w = a.width[l], wp = padded(w);
            o -= w;
            const float* rl = r + (o - d_in) * ts;
            const float* hdl = hd + (o - d_in) * ts;
            if constexpr (kTanh) {
              for (int j = 0; j < w; ++j) {
                const float sl = rl[j * ts];
                const float tv = f[(o + j) * ts];
                const float ab = gb[(o + j) * ts];
                const float adb = gdb[(o + j - d_in) * ts];
                gb[(o + j) * ts] =
                    sl * ab + (-2.0f * tv * sl) * hdl[j * ts] * adb;
                gdb[(o + j - d_in) * ts] = sl * adb;
              }
            } else {
              for (int j = 0; j < w; ++j) {
                const float rv = rl[j * ts];
                const float ab = gb[(o + j) * ts];
                const float adb = gdb[(o + j - d_in) * ts];
                gb[(o + j) * ts] =
                    rv > 0.0f ? 2.0f * rv * ab + 2.0f * hdl[j * ts] * adb
                              : 0.0f;
                gdb[(o + j - d_in) * ts] = 2.0f * rv * adb;
              }
            }
            const float* Wl = W + a.w_off[l];
            for (int i = d_in; i < o; ++i) {
              const float* Wi = Wl + i * wp;
              float s = 0.0f, sd = 0.0f;
              for (int j = 0; j < w; ++j) {
                s = fmaf(Wi[j], gb[(o + j) * ts], s);
                sd = fmaf(Wi[j], gdb[(o + j - d_in) * ts], sd);
              }
              gb[i * ts] += s;
              gdb[(i - d_in) * ts] += sd;
            }
          }
        }
      }
    }
    const bool grad = kRelu ? opened : adv;
    if (!grad) {   // this lane adds nothing this step
      for (int i = 0; i < a.F; ++i) fd[i * ts] = 0.0f;
      for (int i = d_in; i < a.F; ++i) {
        gb[i * ts] = 0.0f;
        gdb[(i - d_in) * ts] = 0.0f;
      }
      *al = 0.0f;
    }

    if (__syncthreads_or(grad)) {
      step_weight_grads<kTimed>(a, f, fd, gb, gdb, al, G, ts);
      __syncthreads();
    }
    if (busy) {
      if (adv)
        for (int j = 0; j < a.d; ++j)
          f[j * ts] = __fadd_rn(f[j * ts], gb[j * ts]);
      ++n;
      busy = adv && takes_step();
    }
  }
  if (kTorus) {
    // the block's lambda entry: the lanes' sums, through the alpha row
    // (every read of it above ended at a barrier)
    *al = g_lam;
    __syncthreads();
    if (tid == 0) {
      float sum = 0.0f;
      for (int p = 0; p < tile; ++p) sum += al[p];
      G[a.g_lam] = sum;
    }
  }
  if (tid == 0) {
    counts[2 * blockIdx.x] = block_steps;
    counts[2 * blockIdx.x + 1] = lane_steps;
  }
}

// Shared memory of one block, in floats: the staged net and the per-path
// arrays, of stride tile + 1 in the forward (bwd_ts = 0; the normals' d
// rows too, and Z's with a dense sigma), and in the backward's shared plan
// the lane ballots first and the arrays at stride bwd_ts (with a dense
// sigma 2 d more rows).  The wrapper's _stopped_smem_bytes and
// _stopped_per_path compute the same.
size_t smem_floats(const StoppedArgs& a, const StoppedExt& ext, int bwd_ts) {
  const bool backward = bwd_ts > 0;
  const size_t H = a.F - (a.time_stopping ? a.d + 1 : a.d);
  const size_t full_rows = ext.sig_off >= 0 ? (backward ? 2 : 1) * a.d : 0;
  const size_t per_path =
      (backward ? 3 * a.F + 3 * H + 1 : 2 * a.F + H + a.d) + full_rows;
  const size_t net = staged_net_floats(a, !backward);
  return (backward ? kBallotWords : 0) + net +
         per_path * static_cast<size_t>(backward ? bwd_ts : a.tile + 1);
}

// The shared plan's block: tile 32 or 64, one thread a path.
bool bwd_tile_ok(const StoppedArgs& a) {
  return a.tile > 0 && a.tile <= kStoppedTile && a.tile % 32 == 0;
}

// The shared plan's layout, the ints after StoppedArgs' and StoppedExt's:
// [ts, grid, plan = 0] (the device plan, plan 1, is stopped_bwd_lanes.cu's):
// stride tile + 4, or tile + 1 where that does not fit (the note on the
// backward's arrays).  Writes ts and the grid, or returns false.
bool unpack_bwd_layout(const StoppedArgs& a, const int* iargs, int* ts,
                       int* grid) {
  const int* l = iargs + kNumPackedInts;
  *ts = l[0];
  *grid = l[1];
  return l[2] == 0 && bwd_tile_ok(a) &&
         (*ts == a.tile + 4 || *ts == a.tile + 1);
}

// The forward's layout, the ints after StoppedArgs': tpp threads a lane
// (a power of two up to 32) and the grid (1 .. ceil(K / tile) blocks);
// tile x tpp threads a block, a multiple of 32 up to kFwdThreads.  Writes
// tpp and grid (grid may be null), or returns false.
bool fwd_layout(const StoppedArgs& a, const int* iargs, int* tpp,
                int* grid) {
  const int p = iargs[kNumPackedInts];
  const int threads = a.tile * p;
  if (a.tile < 1 || a.tile > kFwdMaxTile || p < 1 || p > 32 ||
      (p & (p - 1)) != 0 || threads % 32 != 0 || threads > kFwdThreads)
    return false;
  *tpp = p;
  if (grid != nullptr) {
    *grid = iargs[kNumPackedInts + 1];
    if (*grid < 1 || *grid > (a.K + a.tile - 1) / a.tile) return false;
  }
  return true;
}

// The block kernel's layout, the ints after StoppedArgs' and StoppedExt's:
// [threads, cap, stages, grid]: threads a block (a multiple of 32 up to
// kBlockThreads), the ring's floats a buffer (a multiple of 4 that holds a
// row of every W_l and W_l^T) and its buffers (2 or 3); the tile a power of
// two up to kBlockMaxTile, the net not staged, one block per tile (grid =
// ceil(K / tile)).  Writes the layout and the grid (grid may be null), or
// returns false.
bool unpack_block_layout(const StoppedArgs& a, const int* iargs,
                         BlockLayout* lay, int* grid) {
  const int* l = iargs + kNumPackedInts;
  *lay = BlockLayout{l[0], l[1], l[2]};
  const int t = a.tile, nt = lay->threads;
  if (t < 1 || t > kBlockMaxTile || (t & (t - 1)) != 0 || nt < 32 ||
      nt > kBlockThreads || nt % 32 != 0 || a.stage != 0 ||
      (lay->stages != 2 && lay->stages != 3) || lay->cap % 4 != 0)
    return false;
  int n_in = a.time_stopping ? a.d + 1 : a.d;
  for (int i = 0; i < a.L; ++i) {
    const int wp = (a.width[i] + kChunk - 1) / kChunk * kChunk;
    const int np = (n_in + kChunk - 1) / kChunk * kChunk;
    if (wp > lay->cap || np > lay->cap) return false;
    n_in += a.width[i];
  }
  if (grid != nullptr) {
    *grid = l[3];
    if (*grid != (a.K + t - 1) / t) return false;
  }
  return true;
}

// The block forward's instantiation (fn takes the Family): the ball, the
// clock's families (the cubic's too) and the torus.  The breadth families
// without the clock and the Schroedinger family have none (ROADMAP.md
// Queue 2 item 4(f)) and are refused.
template <typename Fn>
int with_block_family(const StoppedArgs& a, const StoppedExt& ext, Fn fn) {
  if (unclocked(a, ext) || ext.hfam == 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return with_family(a, ext, [&](auto fam) {
    using Fam = decltype(fam);
    if constexpr (Fam::full || Fam::sch || (Fam::breadth && !Fam::timed)) {
      return static_cast<int>(cudaErrorInvalidValue);
    } else {
      return fn(fam);
    }
  });
}

}  // namespace

// Launch on `stream` of CUDA device `device`; each returns the cudaError_t
// of the launch (0 = success).  `iargs` and `fargs` are host arrays in the
// order of StoppedArgs, then StoppedExt; `seed` is the Philox seed's device
// word (a 0-d int64 tensor), read by the kernel when it runs, and
// `launches` the 64-bit device word it adds one to (count_launch; null:
// none).

// Forward: X0 (K, d), t0 (K,) -> X_out (K, d), acc_out (6, K): Y, stopped,
// hitting, v_l2, adv_steps, t.  `iargs` carries the layout after
// StoppedArgs' and StoppedExt's ints (fwd_layout): tpp threads a lane, the
// grid.  `queue` (1 + grid tile ints, the first 0): the grid's path
// counter, then each lane's trips (the steps it ran, over all its paths).
extern "C" int pspde_stopped_rollout_fwd(const float* params,
                                         const float* host_noise,
                                         const float* X0, const float* t0,
                                         float* X_out, float* acc_out,
                                         int* queue, const int* iargs,
                                         const float* fargs,
                                         const unsigned long long* seed,
                                         unsigned long long* launches,
                                         int device, void* stream) {
  StoppedArgs a;
  StoppedExt ext;
  const int err = unpack(iargs, fargs, seed, device, &a, &ext);
  if (err != 0) return err;
  if (seed == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  a.launches = launches;
  int tpp = 0, grid = 0;
  if (!fwd_layout(a, iargs, &tpp, &grid))
    return static_cast<int>(cudaErrorInvalidValue);
  return with_family(a, ext, [&](auto fam) {
    using Fam = decltype(fam);
    return launch(stopped_fwd_kernel<Fam::timed, Fam::torus, Fam::relu,
                                     Fam::full, Fam::breadth, Fam::sch,
                                     Fam::tanh>,
                  sizeof(float) * smem_floats(a, ext, 0), grid, a.tile * tpp,
                  stream, a, params, host_noise, X0, t0, X_out, acc_out,
                  queue, tpp, ext);
  });
}

// The forward's launch for `iargs` (StoppedArgs' and StoppedExt's ints and
// tpp) on device `device`: out[0] its blocks resident on one SM, out[1]
// threads a block, out[2] shared bytes a block, out[3] the SMs.  The grid
// that fills the card once is out[0] out[3] blocks.
extern "C" int pspde_stopped_fwd_occupancy(const int* iargs,
                                           const float* fargs, int device,
                                           int* out) {
  StoppedArgs a;
  StoppedExt ext;
  const int err = unpack(iargs, fargs, nullptr, device, &a, &ext);
  if (err != 0) return err;
  int tpp = 0;
  if (!fwd_layout(a, iargs, &tpp, nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  return with_family(a, ext, [&](auto fam) {
    using Fam = decltype(fam);
    const size_t smem = sizeof(float) * smem_floats(a, ext, 0);
    out[1] = a.tile * tpp;
    out[2] = static_cast<int>(smem);
    return occupancy(
        stopped_fwd_kernel<Fam::timed, Fam::torus, Fam::relu, Fam::full,
                           Fam::breadth, Fam::sch, Fam::tanh>,
        smem, out[1], device, &out[0], &out[3]);
  });
}

// The forward for nets that no block stages (stopped_fwd_block_kernel):
// as pspde_stopped_rollout_fwd, with `wt` the net's W_l^T (w x padded(n_in)
// row-major, layer after layer) and the layout [threads, cap, stages, grid]
// after StoppedArgs' and StoppedExt's ints (unpack_block_layout); `queue`
// (1 + grid tile ints): each path's trips after the first.  The families of
// with_block_family; the others are refused.
extern "C" int pspde_stopped_rollout_fwd_block(
    const float* params, const float* wt, const float* host_noise,
    const float* X0, const float* t0, float* X_out, float* acc_out,
    int* queue, const int* iargs, const float* fargs,
    const unsigned long long* seed, unsigned long long* launches, int device,
    void* stream) {
  StoppedArgs a;
  StoppedExt ext;
  const int err = unpack(iargs, fargs, seed, device, &a, &ext);
  if (err != 0) return err;
  if (seed == nullptr || wt == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  a.launches = launches;
  BlockLayout lay;
  int grid = 0;
  if (!unpack_block_layout(a, iargs, &lay, &grid))
    return static_cast<int>(cudaErrorInvalidValue);
  return with_block_family(a, ext, [&](auto fam) {
    using Fam = decltype(fam);
    return launch(stopped_fwd_block_kernel<Fam::timed, Fam::torus, Fam::relu,
                                           Fam::breadth>,
                  sizeof(float) * block_smem_floats(a, lay), grid,
                  lay.threads, stream, a, params, wt, host_noise, X0, t0,
                  X_out, acc_out, queue + 1, lay.cap, lay.stages, ext);
  });
}

// The block kernel's launch for `iargs` (StoppedArgs' and StoppedExt's
// ints and the layout, its grid not read): out as
// pspde_stopped_fwd_occupancy's.
extern "C" int pspde_stopped_fwd_block_occupancy(const int* iargs,
                                                 const float* fargs,
                                                 int device, int* out) {
  StoppedArgs a;
  StoppedExt ext;
  const int err = unpack(iargs, fargs, nullptr, device, &a, &ext);
  if (err != 0) return err;
  BlockLayout lay;
  if (!unpack_block_layout(a, iargs, &lay, nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  return with_block_family(a, ext, [&](auto fam) {
    using Fam = decltype(fam);
    const size_t smem = sizeof(float) * block_smem_floats(a, lay);
    out[1] = lay.threads;
    out[2] = static_cast<int>(smem);
    return occupancy(stopped_fwd_block_kernel<Fam::timed, Fam::torus,
                                              Fam::relu, Fam::breadth>,
                     smem, lay.threads, device, &out[0], &out[3]);
  });
}

// Backward: X0, t0, gY (K,) -> grad_out (grid, n_grad), one row of
// per-layer [W (n_in, width); b (1, width)] and [wL (F); bL] sums per block,
// and on the torus the lambda entry last; counts (grid, 2): each block's
// block-steps and its busy lanes summed over them.  `iargs` carries the
// layout after StoppedArgs' and StoppedExt's ints: [ts, grid, plan(, tpp,
// in_smem)], 1 <= grid <= ceil(K / tile); on the spheres at most the blocks
// the card holds at once (pspde_stopped_bwd_slots); block b replays the
// paths of its range (range_start).  The shared plan (plan 0,
// unpack_bwd_layout) launches stopped_bwd_kernel; the device plan (plan 1)
// goes to pspde_stopped_rollout_bwd_lanes (stopped_bwd_lanes.cu), whose
// workspace `ws` (per-path rows x ts floats, ts >= grid x tile) holds the
// lanes' arrays unless they sit in shared memory; null where unused.
extern "C" int pspde_stopped_rollout_bwd(const float* params,
                                         const float* host_noise,
                                         const float* X0, const float* t0,
                                         const float* gY, float* grad_out,
                                         int* counts, float* ws,
                                         const int* iargs,
                                         const float* fargs,
                                         const unsigned long long* seed,
                                         unsigned long long* launches,
                                         int device, void* stream) {
  if (iargs[kNumPackedInts + 2] == 1)
    return pspde_stopped_rollout_bwd_lanes(params, host_noise, X0, t0, gY,
                                           grad_out, counts, ws, iargs, fargs,
                                           seed, launches, device, stream);
  StoppedArgs a;
  StoppedExt ext;
  const int err = unpack(iargs, fargs, seed, device, &a, &ext);
  if (err != 0) return err;
  if (seed == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  a.launches = launches;
  int ts = 0, grid = 0;
  if (!unpack_bwd_layout(a, iargs, &ts, &grid) || grid < 1 ||
      grid > (a.K + a.tile - 1) / a.tile)
    return static_cast<int>(cudaErrorInvalidValue);
  return with_family(a, ext, [&](auto fam) {
    using Fam = decltype(fam);
    return launch(
        stopped_bwd_kernel<Fam::timed, Fam::torus, Fam::relu, Fam::full,
                           Fam::breadth, Fam::sch, Fam::tanh>,
        sizeof(float) * smem_floats(a, ext, ts), grid, a.tile, stream, a,
        params, host_noise, X0, t0, gY, grad_out, counts, ts, ext);
  });
}

// The blocks of the backward's kernel for `iargs` (StoppedArgs' and
// StoppedExt's ints, then the layout as the launch takes it, its grid not
// read) that device `device` holds at once (its SMs times the blocks per
// SM that the shared memory, the registers and the threads allow) into
// *slots: the most blocks worth launching, since each walks its range to
// the end.  The device plan's: pspde_stopped_bwd_lane_slots.
extern "C" int pspde_stopped_bwd_slots(const int* iargs, const float* fargs,
                                       int device, int* slots) {
  if (iargs[kNumPackedInts + 2] == 1)
    return pspde_stopped_bwd_lane_slots(iargs, fargs, device, slots);
  StoppedArgs a;
  StoppedExt ext;
  const int err = unpack(iargs, fargs, nullptr, device, &a, &ext);
  if (err != 0) return err;
  int ts = 0, grid = 0;
  if (!unpack_bwd_layout(a, iargs, &ts, &grid))
    return static_cast<int>(cudaErrorInvalidValue);
  int per_sm = 0, sms = 0;
  const int e = with_family(a, ext, [&](auto fam) {
    using Fam = decltype(fam);
    return occupancy(
        stopped_bwd_kernel<Fam::timed, Fam::torus, Fam::relu, Fam::full,
                           Fam::breadth, Fam::sch, Fam::tanh>,
        sizeof(float) * smem_floats(a, ext, ts), a.tile, device, &per_sm,
        &sms);
  });
  *slots = per_sm * sms;
  return e;
}
