// The stopped backward's device plan: stopped_bwd_lane_kernel, the replay
// backward of stopped_rollout.cu's forward with several threads a path.
//
// Replaces, with stopped_rollout.cu's stopped_bwd_kernel (the shared plan),
// the Pallas TPU kernel of pspde/rollout/kernels.py:
// make_fused_stopped_train_rollout's backward _bwd (pallas_call at
// kernels.py:1272).  What it computes, its families and the replay's
// arithmetic: the note at the head of stopped_rollout.cu; the device code
// both kernels run: stopped_common.cuh.  It is a source of its own so that
// its nvcc runs beside stopped_rollout.cu's (pspde_torch/rollout/_build.py
// starts one a source).
//
// The shared plan's replay runs one thread a path, in blocks of 64 paths.
// Where K leaves the card idle that is a few blocks of two warps, each
// thread a serial chain through the net; this kernel runs the same replay,
// refill and products on lanes of tpp threads, as the forward does: the
// value and tangent sweeps split their output chunks, grad V and the
// reverse pair sweep their rows, each sum in one thread in the one-thread
// order, so its gradient rows at one tile are the shared plan's bitwise.
//   * It first served the nets whose arrays fit no block of the shared
//     plan: the notebook's Allen-Cahn net (d = 100, [x, t], DenseNet (110,
//     110, 50): 1,924 floats a path) fits none even at tile 32 and stride
//     33.  Its one-thread predecessor (the shared plan's code with the
//     arrays in a workspace of device memory) ran 4 blocks of 64 lanes at
//     the notebook's K = 200: two warps on each of 4 SMs, each thread a
//     chain of ~250k dependent FMAs a step, each after a load that waited on
//     L1 or L2; 42.6-43.0 ms a launch, 91% of the notebook step's device
//     time.  The lanes kernel's layout (_stopped_bwd_lane_layout) splits a
//     path as far as K leaves the card idle and halves the tile until K
//     gives the SMs blocks: at K = 200 25 blocks of 8 lanes of 16 threads,
//     the arrays in shared memory, 4.57-4.59 ms; at K = 65536 64 lanes of 4
//     threads, the arrays in a workspace, 121.6-122.0 against 156.5-157.1
//     ms; forced at the elliptic cell (d = 50, K = 65536, N = 20) 0.82
//     against 2.82 ms, the shared plan's 1.78 (device ms by the profiler,
//     parent and change in one call of experiments/torch_kernel_times.py
//     --allen-cahn; NVIDIA H100 80GB HBM3 at 700.00 W).  There what bounds
//     it is latency, not the card's rates (170x the FLOP bound at K = 200,
//     14x at K = 65536): each lane's chain through the net, whose 214 KB of
//     weights no block holds beside the arrays, so every row of every sweep
//     waits on L1 or L2 (staged alone, the net leaves one block an SM and
//     reads slower).
//   * The Schroedinger family (its tanh features: the sweeps' kTanh
//     branches, the shared plan's f' = (1 - f^2) h' and pair h-bar = s
//     f-bar - 2 f s h' f-bar') and the breadth families without the clock
//     (the committor: the two spheres' exit test, h's c_ys1 term) run here
//     too, at the notebooks' small K, where the shared plan's 8 (K = 500)
//     and 4 (K = 200) blocks of 64 one-thread paths left the card idle:
//     with 8 lanes of 16 threads (63 and 25 blocks) the Schroedinger
//     notebook's backward reads 0.48 against 1.57-1.58 ms and the
//     committor's 0.62 against 2.43, and at K = 65536 the lanes kernel
//     still beats the shared plan, 5.07 against 6.49 and 5.58 against
//     8.84 ms (device ms by the profiler, experiments/
//     torch_kernel_times.py --sch-committor and experiments/
//     torch_bwd_layouts.py; NVIDIA H100 80GB HBM3 at 700.00 W).  The
//     width-15 and width-30 layers give the value and tangent sweeps 2
//     and 4 output chunks of 8, so at 16 threads a lane most threads idle
//     there; 16 threads still read fastest, the pair sweep and grad V
//     splitting rows over all of them.
//   * A dense sigma (the normals and Z in 2 d more rows a path of full_z
//     and full_step) has no instantiation here and is refused
//     (with_lane_family).

#include "stopped_common.cuh"

namespace {

using namespace pspde;

// -- the device plan: the replay with several threads a path --------------

// The lanes kernel's block: `tile` lanes of `tpp` threads (tile x tpp a
// multiple of 32, at most kLaneThreads), as the forward's.  The bound caps
// registers at 65,536 / (kLaneThreads x kLaneMinBlocks) = 128 a thread.
constexpr int kLaneThreads = 256;
constexpr int kLaneMinBlocks = 2;
constexpr int kLaneWarps = kLaneThreads / 32;
constexpr int kLaneUnitN = 2;   // n tiles of a unit of its products
// The refill's ballots: two slots of one word per warp (64 bytes, so the
// staged net after them keeps matvec_chunk's float4 alignment).
constexpr int kLaneBallotWords = 2 * kLaneWarps;

// The tangent sweep split over a lane's threads as lane_value_forward
// splits the value sweep: thread q forms the output chunks q, q + p, ...
// of h' = W_l f' (matvec_chunk, each sum over the input rows in order) and
// the features' tangents 2 relu(h) h' (kTanh: (1 - tanh(h)^2) h', the
// slope from the r rows); the threads meet after each layer.  kApart only
// tells instantiations apart: the families added after the first eight
// (the Schroedinger family, the breadth fields without the clock) call
// copies of their own, since a copy shared with the older instantiations
// changed those instantiations' SASS (experiments/torch_sass_diff.py), so
// the older kernels keep the code their checks and times were taken on;
// their times with shared copies are in PERF.md section 6.
template <bool kTimed, bool kTanh = false, bool kApart = false>
__device__ void lane_tangent(const StoppedArgs& a, const FwdNet& net,
                             const float* r, float* fd, float* hd, int ts,
                             const Lane& ln) {
  const int d_in = net_inputs<kTimed>(a);
  int n_in = d_in;
  for (int l = 0; l < a.L; ++l) {
    const int w = a.width[l], wp = padded(w), ws = net.stride(a, l);
    const float* Wl = net.w(a, l);
    const float* rl = r + (n_in - d_in) * ts;
    float* hdl = hd + (n_in - d_in) * ts;
    for (int j0 = ln.q * kChunk; j0 < wp; j0 += ln.p * kChunk) {
      float acc[kChunk];
#pragma unroll
      for (int c = 0; c < kChunk; ++c) acc[c] = 0.0f;
      matvec_chunk(Wl, n_in, ws, j0, fd, ts, acc);
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
    ln.sync();
  }
}

// The reverse sweep over the pair (V, V') split over a lane's threads as
// lane_value_grad splits grad V's: feature row i (i >= d_in) belongs to
// thread i mod p, which forms its cotangents (the output row's alpha wL_i
// and wL_i, each hidden layer's relu^2 pair, and the two sums a row over
// the layer's outputs, in the one-thread sweep's order), two rows a pass;
// the threads meet before each layer's sums, which read other threads'
// rows.  The caller makes them meet after the last.  kTanh: each hidden
// unit's pair is the tanh features' (f = tanh(h), its slope s = 1 - f^2
// from the r rows: hbar = s fbar - 2 f s h' fbar', hbar' = s fbar', as
// stopped_bwd_kernel forms it), f read from the path's feature rows, which
// the kernel keeps F rows before r.  kApart: as lane_tangent's.
template <bool kTimed, bool kTanh = false, bool kApart = false>
__device__ void lane_pair_reverse(const StoppedArgs& a, const FwdNet& net,
                                  const float* r, const float* hd, float* gb,
                                  float* gdb, float alpha, int ts,
                                  const Lane& ln) {
  const int d_in = net_inputs<kTimed>(a);
  const float* wL = net.wL(a);
  const int i0 = d_in + ((ln.q - d_in) & (ln.p - 1));   // this thread's rows
  for (int i = i0; i < a.F; i += ln.p) {
    gb[i * ts] = alpha * wL[i];
    gdb[(i - d_in) * ts] = wL[i];
  }
  int o = a.F;
  for (int l = a.L - 1; l >= 0; --l) {
    const int w = a.width[l], ws = net.stride(a, l);
    o -= w;
    const float* rl = r + (o - d_in) * ts;
    const float* hdl = hd + (o - d_in) * ts;
    if constexpr (kTanh) {
      const float* f = r - a.F * ts;
      for (int j = (ln.q - o) & (ln.p - 1); j < w; j += ln.p) {
        const float sl = rl[j * ts];
        const float tv = f[(o + j) * ts];
        const float ab = gb[(o + j) * ts];
        const float adb = gdb[(o + j - d_in) * ts];
        gb[(o + j) * ts] = sl * ab + (-2.0f * tv * sl) * hdl[j * ts] * adb;
        gdb[(o + j - d_in) * ts] = sl * adb;
      }
    } else {
      for (int j = (ln.q - o) & (ln.p - 1); j < w; j += ln.p) {
        const float rv = rl[j * ts];
        const float ab = gb[(o + j) * ts];
        const float adb = gdb[(o + j - d_in) * ts];
        gb[(o + j) * ts] =
            rv > 0.0f ? 2.0f * rv * ab + 2.0f * hdl[j * ts] * adb : 0.0f;
        gdb[(o + j - d_in) * ts] = 2.0f * rv * adb;
      }
    }
    ln.sync();
    const float* Wl = net.w(a, l);
    for (int i = i0; i < o; i += 2 * ln.p) {
      const int i2 = i + ln.p;
      const float* Wi = Wl + i * ws;
      const float* Wi2 = Wl + min(i2, o - 1) * ws;
      float s = 0.0f, sd = 0.0f, s2 = 0.0f, sd2 = 0.0f;
      for (int j = 0; j < w; ++j) {
        const float gj = gb[(o + j) * ts];
        const float gdj = gdb[(o + j - d_in) * ts];
        s = fmaf(Wi[j], gj, s);
        sd = fmaf(Wi[j], gdj, sd);
        s2 = fmaf(Wi2[j], gj, s2);
        sd2 = fmaf(Wi2[j], gdj, sd2);
      }
      gb[i * ts] += s;
      gdb[(i - d_in) * ts] += sd;
      if (i2 < o) {
        gb[i2 * ts] += s2;
        gdb[(i2 - d_in) * ts] += sd2;
      }
    }
  }
}

// step_weight_grads for the lanes kernel: the same sums in units of
// kLaneUnitN x 8 columns, dealt to the block's tile x tpp threads (its
// warps take the units in turn, its threads the output row's entries); the
// arguments point at path 0 of the rows, in shared memory (kShared) or in
// the workspace.  Each entry of G is summed by one unit's mma in the same
// order whatever the unit's width, so the sums are step_weight_grads'
// bitwise; the narrower unit keeps the kernel within its registers.
template <bool kTimed, bool kShared>
__device__ __forceinline__ void lane_weight_grads(
    const StoppedArgs& a, const float* f, const float* fd, const float* gb,
    const float* gdb, const float* al, float* G, int ts) {
  const int tid = threadIdx.x, warp = tid >> 5, n_warps = blockDim.x >> 5;
  const int d_in = net_inputs<kTimed>(a);
  int u0 = 0;
  int n_in = d_in;
  for (int l = 0; l < a.L; ++l) {
    const int w = a.width[l];
    const int n_groups = (w + 8 * kLaneUnitN - 1) / (8 * kLaneUnitN);
    const int units = (n_in + 16) / 16 * n_groups;
    for (int u = ((warp - u0) % n_warps + n_warps) % n_warps; u < units;
         u += n_warps) {
      const int mt = u / n_groups;
      pair_tile_product<kShared, kLaneUnitN>(
          f, gb + n_in * ts, fd, gdb + (n_in - d_in) * ts, n_in, w, ts,
          a.tile, G + a.g_off[l], 16 * mt,
          8 * kLaneUnitN * (u - mt * n_groups));
    }
    u0 += units;
    n_in += w;
  }
  // entry e sums the paths from (q + e) mod tile, as step_weight_grads
  float* GL = G + a.gL_off;
  for (int e = tid; e <= a.F; e += blockDim.x) {
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

// The device plan's backward: stopped_bwd_kernel's replay, refill and
// products with a lane of tpp threads carrying each path, as the forward's
// lanes do.  The value and tangent sweeps split their output chunks, grad V
// and the reverse pair sweep their rows (lane_value_forward, lane_tangent,
// lane_value_grad, lane_pair_reverse), the normals their dimension groups;
// every sum stays one thread's, in the one-thread replay's order, and every
// thread of a lane holds the path's scalars (gy, t, r2, alpha, busy) alike,
// so the X chain, the masks and every row the products read are bitwise
// the shared plan's, and at one tile so are the gradient rows and the block
// counts (whatever tpp, the staging and the arrays' memory).  The refill
// ballots over the warps' lane leaders: lanes take the range's paths in
// lane order, as the shared plan's threads do.  The lanes' arrays sit at
// stride ts in shared memory (in_smem: ts = tile + 4, after the staged net)
// or in the workspace `ws` (ts = grid x tile, block b's lanes at columns
// b tile ..); the net is staged in FwdNet's padded layout where a.stage,
// else read from device memory.  Its families are the shared plan's but a
// dense sigma: the clock (kTimed), the torus (kTorus), the clamp (kRelu),
// the breadth fields (kBreadth: with the clock the cubic, without it the
// two spheres, the committor's reference and c_ys1), the Schroedinger
// family and the tanh features (kSch, kTanh, last and false by default, so
// that the older instantiations keep their code).  Its times and what
// bounds it: the note at the head of this file.  The bound caps its
// registers at 128, which it keeps without a spill (126-128 in the twelve
// instantiations) since its products run in units of kLaneUnitN
// n-tiles: at kUnitN's 4 it spilled 172-288 bytes and read 3% faster to 8%
// slower; a cap of 255 (164-168 registers, 8-12 warps an SM) read 149-177
// ms at the Allen-Cahn cell's K = 65536 against 114-122
// (experiments/torch_bwd_layouts.py on copies of this file with the
// constant changed; NVIDIA H100 80GB HBM3 at 700.00 W).
template <bool kTimed, bool kTorus, bool kRelu, bool kBreadth,
          bool kSch = false, bool kTanh = false>
__global__ void __launch_bounds__(kLaneThreads, kLaneMinBlocks)
stopped_bwd_lane_kernel(const StoppedArgs a, const float* __restrict__ P,
                        const float* __restrict__ noise,
                        const float* __restrict__ X0,
                        const float* __restrict__ t0,
                        const float* __restrict__ gY,
                        float* __restrict__ part, int* __restrict__ counts,
                        float* __restrict__ ws, const int ts, const int tpp,
                        const int in_smem, const StoppedExt ext) {
  extern __shared__ float4 smem4[];
  uint32_t* ballots = reinterpret_cast<uint32_t*>(smem4);
  float* S = reinterpret_cast<float*>(smem4) + kLaneBallotWords;
  const int tile = a.tile, tid = threadIdx.x;
  const int warp = tid >> 5, n_warps = blockDim.x >> 5;
  const Lane ln(tid, tpp);
  const int slot = tid / tpp;            // the lane's column
  float* base = S;
  const FwdNet net = stage_fwd_net(a, P, S, &base);
  float* col0 = in_smem ? base : ws + static_cast<size_t>(blockIdx.x) * tile;
  float* G = part + static_cast<size_t>(blockIdx.x) * a.n_grad;
  for (int e = tid; e < a.n_grad; e += blockDim.x) G[e] = 0.0f;
  int next = range_start(blockIdx.x, a.K, tile, gridDim.x);
  const int hi = range_start(blockIdx.x + 1, a.K, tile, gridDim.x);

  const int d_in = net_inputs<kTimed>(a);
  const int H = a.F - d_in;
  const int rows = 3 * a.F + 3 * H + 1;  // a path's rows, f .. al
  float* f = col0 + slot;                // as stopped_bwd_kernel's
  float* r = f + a.F * ts;
  float* fd = r + H * ts;
  float* hd = fd + a.F * ts;
  float* gb = hd + H * ts;
  float* gdb = gb + a.F * ts;
  float* al = gdb + H * ts;
  for (int i = ln.q; i < rows; i += ln.p) f[i * ts] = 0.0f;
  count_launch(a.launches);
  const uint2 key = stopped_seed(a);
  const float lam = kTorus ? P[a.lam_off] : 0.0f;
  float g_lam = 0.0f;
  // a lane leader's bit in each tpp bits of a warp's ballot
  const uint32_t leads = tpp == 32 ? 1u : 0xFFFFFFFFu / ((1u << tpp) - 1u);

  int k = 0, n = 0, bslot = 0;
  float gy = 0.0f, t = 0.0f, r2 = 0.0f;
  bool busy = false;
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
    // Refill, as stopped_bwd_kernel's, counting lanes: each warp's ballot
    // keeps its lane leaders' bits.
    int n_free;
    for (;;) {
      const uint32_t m = __ballot_sync(0xFFFFFFFFu, !busy) & leads;
      if ((tid & 31) == 0) ballots[bslot * kLaneWarps + warp] = m;
      __syncthreads();
      int below = __popc(m & ((1u << ln.leader()) - 1u));
      n_free = 0;
      for (int w = 0; w < n_warps; ++w) {
        const int cnt = __popc(ballots[bslot * kLaneWarps + w]);
        n_free += cnt;
        if (w < warp) below += cnt;
      }
      bslot ^= 1;
      if (n_free == 0 || next >= hi) break;
      if (!busy && next + below < hi) {
        k = next + below;
        for (int i = ln.q; i < rows; i += ln.p) f[i * ts] = 0.0f;
        for (int j = ln.q; j < a.d; j += ln.p)
          f[j * ts] = X0[static_cast<size_t>(k) * a.d + j];
        gy = gY[k];
        t = t0[k];
        n = 0;
        ln.sync();
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
      if (kTimed) {
        if (ln.q == 0) f[a.d * ts] = t;
        ln.sync();
      }
      const float v_out =
          lane_value_forward<kTimed, kTanh>(a, net, f, r, ts, ln);
      const bool on = !kRelu || v_out > 0.0f;
      const float V = on ? v_out : 0.0f;
      if (a.adaptive && on) {
        lane_value_grad<kTimed, kTanh>(a, net, r, gb, ts, ln);
        ln.sync();
      }
      const float m_cs = kTorus ? -cosf(s) : 0.0f;
      bool inside = true;
      for (int gi = ln.q; 4 * gi < a.d; gi += ln.p) {
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
      if (kTorus) inside = __all_sync(ln.mask, inside);
      adv = !kTorus || inside;
      float alpha = 0.0f;
      if (adv) {
        opened = on;
        if constexpr (kSch) {
          alpha = -gy * (sch_h_dy(V, qs) + lam) * a.dt;
          g_lam = fmaf(-gy * V, a.dt, g_lam);
        } else if (kTorus) {
          alpha = -gy * (torus_h_dy(s, qs) + lam) * a.dt;
          g_lam = fmaf(-gy * V, a.dt, g_lam);
        } else if constexpr (kBreadth && kTimed) {
          alpha = -gy * cubic_h_dy(a, ext, r2, t, V) * a.dt;
        } else if constexpr (kBreadth) {
          alpha = -gy * breadth_h_dy(a, ext, r2, coord_sum(f, a.d, ts), V) *
                  a.dt;
        } else {
          alpha = -gy * h_dy<kTimed>(a, r2, t, V) * a.dt;
        }
        if (ln.q == 0) {
          *al = alpha;
          if (kTimed) fd[a.d * ts] = 0.0f;
        }
        if (kTimed) t = __fadd_rn(t, a.dt);
      }
      ln.sync();   // the step's rows 0..d_in of fd and gb complete
      if (adv && on) {
        constexpr bool kApart = kSch || (kBreadth && !kTimed);
        lane_tangent<kTimed, kTanh, kApart>(a, net, r, fd, hd, ts, ln);
        lane_pair_reverse<kTimed, kTanh, kApart>(a, net, r, hd, gb, gdb,
                                                 alpha, ts, ln);
      }
    }
    const bool grad = kRelu ? opened : adv;
    if (!grad) {   // this lane adds nothing this step
      for (int i = ln.q; i < a.F; i += ln.p) fd[i * ts] = 0.0f;
      for (int i = d_in + ((ln.q - d_in) & (ln.p - 1)); i < a.F;
           i += ln.p) {
        gb[i * ts] = 0.0f;
        gdb[(i - d_in) * ts] = 0.0f;
      }
      if (ln.q == 0) *al = 0.0f;
    }

    if (__syncthreads_or(grad)) {
      const float* f0 = f - slot;
      if (in_smem)
        lane_weight_grads<kTimed, true>(a, f0, fd - slot, gb - slot,
                                        gdb - slot, al - slot, G, ts);
      else
        lane_weight_grads<kTimed, false>(a, f0, fd - slot, gb - slot,
                                         gdb - slot, al - slot, G, ts);
      __syncthreads();
    }
    if (busy) {
      if (adv)
        for (int j = ln.q; j < a.d; j += ln.p)
          f[j * ts] = __fadd_rn(f[j * ts], gb[j * ts]);
      ln.sync();
      ++n;
      busy = adv && takes_step();
    }
  }
  if (kTorus) {
    if (ln.q == 0) *al = g_lam;
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

// Shared memory of one block of the lanes kernel, in floats: the ballots,
// the staged net (FwdNet's padded rows) and, in_smem, the lanes' 3 F + 3 H
// + 1 rows at stride ts.  The wrapper's _stopped_bwd_smem computes the
// same.
size_t lane_smem_floats(const StoppedArgs& a, int ts, bool in_smem) {
  const size_t H = a.F - (a.time_stopping ? a.d + 1 : a.d);
  const size_t per_path = 3 * a.F + 3 * H + 1;
  return kLaneBallotWords + staged_net_floats(a, true) +
         (in_smem ? per_path * static_cast<size_t>(ts) : 0);
}

// The device plan's layout, the ints after StoppedArgs' and StoppedExt's:
// [ts, grid, plan = 1, tpp, in_smem]: tile a power of two from 8 to 64 (the
// products' depth 2 tile a multiple of 8, the output row's rotation a
// mask), lanes of tpp threads (a power of two up to 32; tile x tpp a
// multiple of 32 up to kLaneThreads), the arrays in shared memory at stride
// tile + 4 (in_smem 1) or in the workspace at a stride of at least the tile
// (grid x tile in a launch).  Returns false for any other.
struct LaneLayout {
  int ts, grid, tpp, in_smem;
};

bool unpack_lane_layout(const StoppedArgs& a, const int* iargs,
                        LaneLayout* lay) {
  const int* l = iargs + kNumPackedInts;
  *lay = LaneLayout{l[0], l[1], l[3], l[4]};
  const int t = a.tile, p = lay->tpp;
  return l[2] == 1 && t >= 8 && t <= 64 && (t & (t - 1)) == 0 && p >= 1 &&
         p <= 32 && (p & (p - 1)) == 0 && (t * p) % 32 == 0 &&
         t * p <= kLaneThreads &&
         (lay->in_smem == 1 ? lay->ts == t + 4
                            : lay->in_smem == 0 && lay->ts >= t);
}

// The lanes kernel's instantiation (fn takes the Family): every family but
// a dense sigma (diag or full), whose 2 d more rows a path of full_z and
// full_step the lanes kernel does not carry (ROADMAP.md Queue 2 item 4(f)),
// refused.
template <typename Fn>
int with_lane_family(const StoppedArgs& a, const StoppedExt& ext, Fn fn) {
  if (ext.sig_off >= 0) return static_cast<int>(cudaErrorInvalidValue);
  return with_family(a, ext, [&](auto fam) {
    using Fam = decltype(fam);
    if constexpr (Fam::full) {
      return static_cast<int>(cudaErrorInvalidValue);
    } else {
      return fn(fam);
    }
  });
}

}  // namespace

// The device plan of pspde_stopped_rollout_bwd (which hands it every call
// whose plan int is 1), with its arguments: the lanes kernel at the layout
// unpack_lane_layout reads, its workspace `ws` (per-path rows x ts floats,
// ts >= grid x tile) where the lanes' arrays are not in shared memory.
extern "C" int pspde_stopped_rollout_bwd_lanes(
    const float* params, const float* host_noise, const float* X0,
    const float* t0, const float* gY, float* grad_out, int* counts,
    float* ws, const int* iargs, const float* fargs,
    const unsigned long long* seed, unsigned long long* launches, int device,
    void* stream) {
  StoppedArgs a;
  StoppedExt ext;
  const int err = unpack(iargs, fargs, seed, device, &a, &ext);
  if (err != 0) return err;
  if (seed == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  a.launches = launches;
  LaneLayout lay;
  if (!unpack_lane_layout(a, iargs, &lay) || lay.grid < 1 ||
      lay.grid > (a.K + a.tile - 1) / a.tile ||
      (!lay.in_smem &&
       (ws == nullptr ||
        static_cast<long long>(lay.grid) * a.tile > lay.ts)))
    return static_cast<int>(cudaErrorInvalidValue);
  return with_lane_family(a, ext, [&](auto fam) {
    using Fam = decltype(fam);
    return launch(
        stopped_bwd_lane_kernel<Fam::timed, Fam::torus, Fam::relu,
                                Fam::breadth, Fam::sch, Fam::tanh>,
        sizeof(float) * lane_smem_floats(a, lay.ts, lay.in_smem), lay.grid,
        a.tile * lay.tpp, stream, a, params, host_noise, X0, t0, gY,
        grad_out, counts, ws, lay.ts, lay.tpp, lay.in_smem, ext);
  });
}

// pspde_stopped_bwd_slots of the device plan: the lanes kernel's blocks
// that device `device` holds at once, into *slots.
extern "C" int pspde_stopped_bwd_lane_slots(const int* iargs,
                                            const float* fargs, int device,
                                            int* slots) {
  StoppedArgs a;
  StoppedExt ext;
  const int err = unpack(iargs, fargs, nullptr, device, &a, &ext);
  if (err != 0) return err;
  LaneLayout lay;
  if (!unpack_lane_layout(a, iargs, &lay))
    return static_cast<int>(cudaErrorInvalidValue);
  int per_sm = 0, sms = 0;
  const int e = with_lane_family(a, ext, [&](auto fam) {
    using Fam = decltype(fam);
    return occupancy(
        stopped_bwd_lane_kernel<Fam::timed, Fam::torus, Fam::relu,
                                Fam::breadth, Fam::sch, Fam::tanh>,
        sizeof(float) * lane_smem_floats(a, lay.ts, lay.in_smem),
        a.tile * lay.tpp, device, &per_sm, &sms);
  });
  *slots = per_sm * sms;
  return e;
}
