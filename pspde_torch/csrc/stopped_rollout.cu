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
// stored path.  Each block writes its sums to one row of an
// (n_blocks, n_grad) array that the wrapper sums: deterministic, no atomics.
//
// What bounds it on an H100: at d = 50, DenseNet (30, 30) an advancing
// forward path-step is ~16.3 kFLOP (V and grad V) and a backward one
// ~36.5 kFLOP (~44 kFLOP adaptive: the replay, the tangent and pair
// sweeps, the weight-gradient outer products), FP32 FMA from shared
// memory; no device-memory traffic but the gradient row.  Paths leave the
// ball after ~1.4 steps from the uniform start, so the work is a few
// steps per path, and per-block fixed costs and latency dominate.  On the
// whole space with time_stopping (the heat equation) every path runs until
// its clock ends, all K N path-steps are work, and at K = 4096 the 64
// blocks leave half the SMs idle.  On the torus (d = 5, DenseNet (10, 10,
// 10, 10): ~1 kFLOP a path-step) most paths run all N steps, and at the
// recipe's K = 500 the 8 blocks fill 8 of 132 SMs.  The design, simple
// first:
//   * one thread per path, one block per `tile` paths, for all N steps; a
//     stopped path skips the net (its X and accumulators are final); in the
//     backward it keeps hitting the barriers with zero cotangents, and a
//     block whose paths are all stopped leaves the loop;
//   * the net is staged per block in shared memory when it fits beside the
//     per-path arrays, else read from device memory (broadcast loads that
//     L1 serves): at the notebook net DenseNet (70, 50, 50, 50) the weights
//     (131 KB) do not fit beside any tile of the backward;
//   * each path's features, relu values, tangents and cotangents live in
//     shared memory as [row][tile + 1] arrays; the torus's proposal takes
//     the rows 0..d of grad V (forward) and of the step (backward), which
//     are free by then;
//   * the block's gradient row lives in device memory, each thread owning
//     the entries e = tid + m tile (read-modify-write once per step, after
//     the barrier, of sum_p over the tile's paths): a shared buffer of the
//     notebook net's 29,491 gradients (118 KB) would not fit either; the
//     lambda entry is summed in a register per path and over the block
//     once, at the end.
//
// Noise: host noise (N, K, d), or Philox4x32-10 keyed by (seed, k, n, j / 4)
// through the erfinv map (default) or the binom map.  The plain version
// (pspde_torch/rollout/kernels.py: reference_stopped_train_rollout) draws
// the same stream.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include "common.cuh"

namespace {

using namespace pspde;

constexpr int kMaxHidden = 4;   // pspde_torch/rollout/kernels.py _MAX_HIDDEN
constexpr int kStoppedTile = 64;
// Shared memory, not registers, bounds the blocks per SM (one thread per
// path, at most 64 threads a block), so the kernels ask for one block per SM
// in __launch_bounds__: without it ptxas keeps them at 40-64 registers and
// spills (91-106 and none with it; the notebook net's backward 163 -> 99 ms
// at d = 50, K = 65536, N = 20 on an NVIDIA H100 80GB HBM3 at 700 W).
constexpr int kMinBlocksPerSm = 1;

// Layout of the integer and float argument arrays the wrapper passes
// (pspde_torch/rollout/kernels.py: _pack_stopped).
struct StoppedArgs {
  int K, N, d;
  int L;            // hidden layers
  int F;            // features: d_in + sum(width)
  int tile;
  int stage;        // 1: the net is staged in shared memory
  int n_params;     // floats of the packed net
  int host_noise, adaptive;
  int rng;          // 0: erfinv, 1: binom
  int phi;          // 0: none, 1: identity, 2: sin
  int have_vref;    // v_ref(x) = exp(a_vref |x|^2)
  int n_grad;       // floats of one block's gradient row
  int time_stopping;  // the net reads d + 1 inputs, [X, t]
  int geom;         // 0: sphere of `radius`, 1: unbounded (with
                    // time_stopping only), 2: the square [X_l, X_r]^d of
                    // the torus family (without time_stopping)
  int width[kMaxHidden], w_off[kMaxHidden], b_off[kMaxHidden],
      g_off[kMaxHidden];
  int wL_off, bL_off, gL_off;
  float dt, sq_dt, sig, radius, c_y, c_yr2, k_exp, a_vref;
  float T;          // the horizon of time_stopping
  float k_t;        // h's time coefficient
  uint32_t key0, key1;
  // The torus family and the clamp come last, so that every field the
  // other families read keeps its offset (and their code its SASS).
  int out_relu;     // V = relu(o) (DenseNet output_relu)
  int lam_off;      // the torus family: lambda's offset in the packed net
  int g_lam;        // and its entry of the gradient row (the last)
  float X_l, X_r;   // the square of the torus family
  float c_tor;      // its uniform coefficient c
};
// The wrapper packs kNumIntArgs ints (the block up to gL_off, then
// out_relu, lam_off, g_lam) and kNumFloatArgs floats (dt ... k_t, then
// X_l, X_r, c_tor).
constexpr int kNumIntArgs = 16 + 4 * kMaxHidden + 6;
constexpr int kNumFloatArgs = 13;
constexpr int kNumTailArgs = 3;
static_assert(offsetof(StoppedArgs, dt) ==
                  (kNumIntArgs - kNumTailArgs) * sizeof(int),
              "StoppedArgs must start with the wrapper's ints but the last "
              "three");
static_assert(offsetof(StoppedArgs, key0) ==
                  offsetof(StoppedArgs, dt) +
                      (kNumFloatArgs - kNumTailArgs) * sizeof(float),
              "the wrapper's floats but the last three follow");
static_assert(offsetof(StoppedArgs, X_l) ==
                  offsetof(StoppedArgs, out_relu) + kNumTailArgs * sizeof(int),
              "the last three ints, then the last three floats");

// Net input rows: the d state rows, and the clock's with time_stopping.
template <bool kTimed>
__device__ __forceinline__ int net_inputs(const StoppedArgs& a) {
  return kTimed ? a.d + 1 : a.d;
}

__device__ __forceinline__ int padded(int w) {
  return (w + kChunk - 1) / kChunk * kChunk;
}

__device__ __forceinline__ void draw4(const StoppedArgs& a,
                                      const float* __restrict__ noise, int k,
                                      int n, int g, float (&xi)[4]) {
  if (a.host_noise) {
    const float* src = noise + (static_cast<size_t>(n) * a.K + k) * a.d;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      xi[q] = 4 * g + q < a.d ? src[4 * g + q] : 0.0f;
    return;
  }
  philox_normals4(static_cast<uint32_t>(k), static_cast<uint32_t>(n),
                  static_cast<uint32_t>(g), a.key0, a.key1, a.rng, xi);
}

// |x|^2 over rows 0..d of this path's column, in a fixed order.
__device__ __forceinline__ float sq_norm(const float* f, int d, int ts) {
  float r2 = 0.0f;
  for (int j = 0; j < d; ++j) r2 = fmaf(f[j * ts], f[j * ts], r2);
  return r2;
}

// The increment s c dt + s xi sqrt(dt) of one coordinate, rounded as the
// plain version rounds (b(X) + sigma c) dt + sigma xi sqrt(dt) with b = 0.
__device__ __forceinline__ float step_of(const StoppedArgs& a, float c,
                                         float x) {
  return __fadd_rn(__fmul_rn(__fmul_rn(a.sig, c), a.dt),
                   __fmul_rn(__fmul_rn(a.sig, x), a.sq_dt));
}

// The torus family at the pre-step state X (rows 0..d of f): s = c sum_j
// cos X_j and q = c^2 sum_j sin^2 X_j.  The drift, and through it the
// masks, read s: both kernels call this one function.
__device__ __forceinline__ void torus_terms(const StoppedArgs& a,
                                            const float* f, int ts,
                                            float* s, float* q) {
  float sv = 0.0f, qv = 0.0f;
  for (int j = 0; j < a.d; ++j) {
    const float x = f[j * ts];
    const float cs = __fmul_rn(a.c_tor, sinf(x));
    sv = fmaf(a.c_tor, cosf(x), sv);
    qv = fmaf(cs, cs, qv);
  }
  *s = sv;
  *q = qv;
}

// dh/dy of the torus family's h = y (-q sin(s) - cos(s) s), without lambda.
__device__ __forceinline__ float torus_h_dy(float s, float q) {
  return -q * sinf(s) - cosf(s) * s;
}

// The torus family's increment (b_j + s c) dt + s xi sqrt(dt) of one
// coordinate x, b_j = (-cos(s) c) sin(x), rounded as the plain version
// rounds (b(X) + sigma c) dt + sigma xi sqrt(dt); m_cs = -cos(s).
__device__ __forceinline__ float torus_step(const StoppedArgs& a, float m_cs,
                                            float x, float c, float xi) {
  const float b = __fmul_rn(__fmul_rn(m_cs, a.c_tor), sinf(x));
  return __fadd_rn(__fmul_rn(__fadd_rn(b, __fmul_rn(a.sig, c)), a.dt),
                   __fmul_rn(__fmul_rn(a.sig, xi), a.sq_dt));
}

__device__ __forceinline__ bool in_box(const StoppedArgs& a, float p) {
  return p >= a.X_l && p <= a.X_r;
}

// The net's output o of the inputs in rows 0..d_in of f (V, or relu's
// argument with the output clamp): writes the features relu(h)^2 into rows
// d_in..F of f and relu(h) into r, and returns o.
template <bool kTimed>
__device__ float value_forward(const StoppedArgs& a,
                               const float* __restrict__ W, float* f,
                               float* r, int ts) {
  const int d_in = net_inputs<kTimed>(a);
  int n_in = d_in;
  for (int l = 0; l < a.L; ++l) {
    const int w = a.width[l], wp = padded(w);
    const float* Wl = W + a.w_off[l];
    const float* bl = W + a.b_off[l];
    float* rl = r + (n_in - d_in) * ts;
    for (int j0 = 0; j0 < wp; j0 += kChunk) {
      float acc[kChunk];
#pragma unroll
      for (int c = 0; c < kChunk; ++c) acc[c] = 0.0f;
      matvec_chunk(Wl, n_in, wp, j0, f, ts, acc);
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const int j = j0 + c;
        if (j < w) {
          const float rv = fmaxf(acc[c] + bl[j], 0.0f);
          rl[j * ts] = rv;
          f[(n_in + j) * ts] = rv * rv;
        }
      }
    }
    n_in += w;
  }
  const float* wL = W + a.wL_off;
  float v = 0.0f;
  for (int i = 0; i < a.F; ++i) v = fmaf(f[i * ts], wL[i], v);
  return v + W[a.bL_off];
}

// g = dV/d(features) into rows 0..F of g (rows 0..d: grad_x V; row d with
// time_stopping: dV/dt, which nothing reads), from the relu values r of the
// last value_forward.
template <bool kTimed>
__device__ void value_grad(const StoppedArgs& a, const float* __restrict__ W,
                           const float* r, float* g, int ts) {
  const int d_in = net_inputs<kTimed>(a);
  const float* wL = W + a.wL_off;
  for (int i = 0; i < a.F; ++i) g[i * ts] = wL[i];
  int o = a.F;
  for (int l = a.L - 1; l >= 0; --l) {
    const int w = a.width[l], wp = padded(w);
    o -= w;   // layer l's outputs are feature rows o..o + w, its inputs 0..o
    const float* rl = r + (o - d_in) * ts;
    for (int j = 0; j < w; ++j)
      g[(o + j) * ts] = 2.0f * rl[j * ts] * g[(o + j) * ts];
    const float* Wl = W + a.w_off[l];
    for (int i = 0; i < o; ++i) {
      const float* Wi = Wl + i * wp;
      float s = 0.0f;
      for (int j = 0; j < w; ++j) s = fmaf(Wi[j], g[(o + j) * ts], s);
      g[i * ts] += s;
    }
  }
}

// The argument of h's exponential at the pre-step state (|x|^2 = r2, clock
// t).
template <bool kTimed>
__device__ __forceinline__ float exp_arg(const StoppedArgs& a, float r2,
                                         float t) {
  return kTimed ? a.k_exp * r2 + a.k_t * t : a.k_exp * r2;
}

// h and dh/dy at the pre-step state with y = V.
template <bool kTimed>
__device__ __forceinline__ float h_value(const StoppedArgs& a, float r2,
                                         float t, float y) {
  float h = y * (a.c_y + a.c_yr2 * r2);
  if (a.phi != 0) {
    const float u = expf(exp_arg<kTimed>(a, r2, t)) - y * y;
    h += a.phi == 1 ? u : sinf(u);
  }
  return h;
}

template <bool kTimed>
__device__ __forceinline__ float h_dy(const StoppedArgs& a, float r2,
                                      float t, float y) {
  float g = a.c_y + a.c_yr2 * r2;
  if (a.phi != 0) {
    const float u = expf(exp_arg<kTimed>(a, r2, t)) - y * y;
    g -= 2.0f * y * (a.phi == 1 ? 1.0f : cosf(u));
  }
  return g;
}

// The step's selection mask: inside the domain (the current state, as the
// plain version's inside_fn tests the sphere) and, with time_stopping, a
// clock that can still advance: fl(t + dt) <= T, the plain version's test.
template <bool kTimed>
__device__ __forceinline__ bool selected(const StoppedArgs& a, float r2,
                                         float t) {
  if (!kTimed) return sqrtf(r2) < a.radius;
  return (a.geom == 1 || sqrtf(r2) < a.radius) && __fadd_rn(t, a.dt) <= a.T;
}

// Stage the packed net in shared memory when the wrapper asked for it;
// returns where the kernels read it, and advances *col past it.
__device__ __forceinline__ const float* stage_net(const StoppedArgs& a,
                                                  const float* __restrict__ P,
                                                  float* S, float** col) {
  if (!a.stage) return P;
  for (int i = threadIdx.x; i < a.n_params; i += a.tile) S[i] = P[i];
  *col += a.n_params;
  return S;
}

template <bool kTimed, bool kTorus, bool kRelu>
__global__ void __launch_bounds__(kStoppedTile, kMinBlocksPerSm)
stopped_fwd_kernel(const StoppedArgs a, const float* __restrict__ P,
                   const float* __restrict__ noise,
                   const float* __restrict__ X0,
                   const float* __restrict__ t0, float* __restrict__ X_out,
                   float* __restrict__ acc_out) {
  extern __shared__ float4 smem4[];
  float* S = reinterpret_cast<float*>(smem4);
  const int ts = a.tile + 1;
  const int k = blockIdx.x * a.tile + threadIdx.x;
  float* col = S + threadIdx.x;
  const float* W = stage_net(a, P, S, &col);
  __syncthreads();
  if (k >= a.K) return;   // no barrier below

  float* f = col;                        // features: X, [t,] relu(h)^2
  float* r = f + a.F * ts;               // relu(h) of the hidden layers
  float* g = r + (a.F - net_inputs<kTimed>(a)) * ts;   // dV/d(features);
                                         // on the torus rows 0..d then
                                         // hold the proposal
  for (int j = 0; j < a.d; ++j)
    f[j * ts] = X0[static_cast<size_t>(k) * a.d + j];
  const float lam = kTorus ? P[a.lam_off] : 0.0f;   // not W: unstaged yet
  float t = t0[k];
  float Y = 0.0f, hit = 0.0f, vl2 = 0.0f, advs = 0.0f;
  bool stopped = false;
  for (int n = 0; n < a.N && !stopped; ++n) {
    float r2 = 0.0f, s = 0.0f, qs = 0.0f;
    bool sel = true;
    if (kTorus) {
      torus_terms(a, f, ts, &s, &qs);
    } else {
      r2 = sq_norm(f, a.d, ts);
      sel = selected<kTimed>(a, r2, t);
    }
    if (kTimed) f[a.d * ts] = t;
    const float o = value_forward<kTimed>(a, W, f, r, ts);
    const bool on = !kRelu || o > 0.0f;   // the output clamp's mask
    const float V = on ? o : 0.0f;
    hit += 1.0f;
    if (a.have_vref) {
      const float e = V - (kTorus ? expf(-sinf(s)) : expf(a.a_vref * r2));
      vl2 += e * e * a.dt;
    }
    if (!sel) {
      stopped = true;
      break;
    }
    if (on) value_grad<kTimed>(a, W, r, g, ts);
    const float h = kTorus ? fmaf(lam, V, V * torus_h_dy(s, qs))
                           : h_value<kTimed>(a, r2, t, V);
    const float m_cs = kTorus ? -cosf(s) : 0.0f;
    bool inside = true;
    float s_zc = 0.0f, s_zx = 0.0f;
    for (int gi = 0; 4 * gi < a.d; ++gi) {
      float xi[4];
      draw4(a, noise, k, n, gi, xi);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = 4 * gi + q;
        if (j >= a.d) break;
        const float z = on ? a.sig * g[j * ts] : 0.0f;
        const float c = a.adaptive ? -z : 0.0f;
        s_zc = fmaf(z, c, s_zc);
        s_zx = fmaf(z, xi[q], s_zx);
        if (kTorus) {
          const float p = __fadd_rn(f[j * ts],
                                    torus_step(a, m_cs, f[j * ts], c, xi[q]));
          inside = inside && in_box(a, p);
          g[j * ts] = p;
        } else {
          f[j * ts] = __fadd_rn(f[j * ts], step_of(a, c, xi[q]));
        }
      }
    }
    if (kTorus) {
      if (!inside) {   // the proposal left: no move, no increment
        stopped = true;
        break;
      }
      for (int j = 0; j < a.d; ++j) f[j * ts] = g[j * ts];
    }
    Y += (-h + s_zc) * a.dt + s_zx * a.sq_dt;
    advs += 1.0f;
    if (kTimed) t = __fadd_rn(t, a.dt);
  }
  float* dst = X_out + static_cast<size_t>(k) * a.d;
  for (int j = 0; j < a.d; ++j) dst[j] = f[j * ts];
  acc_out[k] = Y;
  acc_out[a.K + k] = stopped ? 1.0f : 0.0f;
  acc_out[2 * a.K + k] = hit;
  acc_out[3 * a.K + k] = vl2;
  acc_out[4 * a.K + k] = advs;
  acc_out[5 * a.K + k] = t;
}

template <bool kTimed, bool kTorus, bool kRelu>
__global__ void __launch_bounds__(kStoppedTile, kMinBlocksPerSm)
stopped_bwd_kernel(const StoppedArgs a, const float* __restrict__ P,
                   const float* __restrict__ noise,
                   const float* __restrict__ X0,
                   const float* __restrict__ t0,
                   const float* __restrict__ gY, float* __restrict__ part) {
  extern __shared__ float4 smem4[];
  float* S = reinterpret_cast<float*>(smem4);
  const int tile = a.tile, ts = tile + 1, tid = threadIdx.x;
  const int k = blockIdx.x * tile + tid;
  const bool live = k < a.K;
  float* col = S + tid;
  const float* W = stage_net(a, P, S, &col);
  float* G = part + static_cast<size_t>(blockIdx.x) * a.n_grad;
  for (int e = tid; e < a.n_grad; e += tile) G[e] = 0.0f;

  const int d_in = net_inputs<kTimed>(a);
  const int H = a.F - d_in;              // hidden feature rows
  float* f = col;                        // features (rows 0..d: X, [d: t])
  float* r = f + a.F * ts;               // relu(h)
  float* fd = r + H * ts;                // tangent of the features (0..d: w;
                                         // the t slot stays 0: Z is the
                                         // gradient in x only)
  float* hd = fd + a.F * ts;             // tangent of h
  float* gb = hd + H * ts;               // cotangent of the features; rows
                                         // 0..d hold the step of X
  float* gdb = gb + a.F * ts;            // cotangent of the hidden tangents
  float* al = gdb + H * ts;              // alpha
  for (float* p = f; p <= al; p += ts) *p = 0.0f;
  if (live)
    for (int j = 0; j < a.d; ++j)
      f[j * ts] = X0[static_cast<size_t>(k) * a.d + j];
  const float gy = live ? gY[k] : 0.0f;
  float t = live ? t0[k] : 0.0f;
  bool stopped = !live;
  const float* wL = W + a.wL_off;
  const float lam = kTorus ? P[a.lam_off] : 0.0f;   // not W: unstaged yet
  float g_lam = 0.0f;                    // this path's d/dlambda

  for (int n = 0; n < a.N; ++n) {
    // the block leaves once all of its paths have stopped
    if (!__syncthreads_or(!stopped)) break;
    bool adv = false;
    bool opened = false;   // with the clamp: adv and o > 0
    if (!stopped) {
      float r2 = 0.0f, s = 0.0f, qs = 0.0f;
      bool sel = true;
      if (kTorus) {
        torus_terms(a, f, ts, &s, &qs);
      } else {
        r2 = sq_norm(f, a.d, ts);
        sel = selected<kTimed>(a, r2, t);
      }
      if (sel) {
        if (kTimed) f[a.d * ts] = t;
        const float v_out = value_forward<kTimed>(a, W, f, r, ts);
        const bool on = !kRelu || v_out > 0.0f;   // the output clamp's mask
        const float V = on ? v_out : 0.0f;
        if (a.adaptive && on) value_grad<kTimed>(a, W, r, gb, ts);
        const float m_cs = kTorus ? -cosf(s) : 0.0f;
        bool inside = true;
        for (int gi = 0; 4 * gi < a.d; ++gi) {
          float xi[4];
          draw4(a, noise, k, n, gi, xi);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int j = 4 * gi + q;
            if (j >= a.d) break;
            const float c =
                a.adaptive && on ? -(a.sig * gb[j * ts]) : 0.0f;
            fd[j * ts] = gy * (a.sig * (xi[q] * a.sq_dt + c * a.dt));
            if (kTorus) {
              const float st = torus_step(a, m_cs, f[j * ts], c, xi[q]);
              inside = inside && in_box(a, __fadd_rn(f[j * ts], st));
              gb[j * ts] = st;
            } else {
              gb[j * ts] = step_of(a, c, xi[q]);
            }
          }
        }
        adv = !kTorus || inside;
        if (adv) {
          opened = on;
          if (kTorus) {
            *al = -gy * (torus_h_dy(s, qs) + lam) * a.dt;
            g_lam = fmaf(-gy * V, a.dt, g_lam);
          } else {
            *al = -gy * h_dy<kTimed>(a, r2, t, V) * a.dt;
          }
          if (kTimed) {
            fd[a.d * ts] = 0.0f;
            t = __fadd_rn(t, a.dt);
          }
          // the path's parameter gradient this step; none where the clamp
          // is shut (there V = 0 and Z = 0 near theta)
          if (on) {
            // tangent sweep: h' = W_l f', (relu(h)^2)' = 2 relu(h) h'
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
                  if (j < w) {
                    hdl[j * ts] = acc[c];
                    fd[(n_in + j) * ts] = 2.0f * rl[j * ts] * acc[c];
                  }
                }
              }
              n_in += w;
            }

            // reverse sweep over the pair (V, V'): S = alpha V + V' with
            // V' = wL . f'; rows d_in..F of gb / gdb end as the
            // cotangents of h and h' of each hidden layer
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
              for (int j = 0; j < w; ++j) {
                const float rv = rl[j * ts];
                const float ab = gb[(o + j) * ts];
                const float adb = gdb[(o + j - d_in) * ts];
                gb[(o + j) * ts] =
                    rv > 0.0f ? 2.0f * rv * ab + 2.0f * hdl[j * ts] * adb
                              : 0.0f;
                gdb[(o + j - d_in) * ts] = 2.0f * rv * adb;
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
      if (!adv) stopped = true;
    }
    const bool grad = kRelu ? opened : adv;
    if (!grad) {   // this path adds nothing this step
      for (int i = 0; i < a.F; ++i) fd[i * ts] = 0.0f;
      for (int i = d_in; i < a.F; ++i) {
        gb[i * ts] = 0.0f;
        gdb[(i - d_in) * ts] = 0.0f;
      }
      *al = 0.0f;
    }

    if (__syncthreads_or(grad)) {
      // G[W_l][i][j] += sum_p f_i hbar_j + f'_i hbar'_j over the tile's
      // paths (row n_in: the bias), G[wL][i] += sum_p alpha f_i + f'_i
      const float* fb = f - tid;
      const float* fdb = fd - tid;
      const float* gbb = gb - tid;
      const float* gdbb = gdb - tid;
      const float* alb = al - tid;
      int n_in = d_in;
      for (int l = 0; l < a.L; ++l) {
        const int w = a.width[l];
        float* Gl = G + a.g_off[l];
        for (int e = tid; e < (n_in + 1) * w; e += tile) {
          const int i = e / w;
          const int j = e - i * w;
          const float* hb = gbb + (n_in + j) * ts;
          const float* hdb = gdbb + (n_in + j - d_in) * ts;
          float s = 0.0f;
          if (i == n_in) {
            for (int p = 0; p < tile; ++p) s += hb[p];
          } else {
            const float* fi = fb + i * ts;
            const float* fdi = fdb + i * ts;
            for (int p = 0; p < tile; ++p)
              s = fmaf(fi[p], hb[p], fmaf(fdi[p], hdb[p], s));
          }
          Gl[e] += s;
        }
        n_in += w;
      }
      float* GL = G + a.gL_off;
      for (int e = tid; e <= a.F; e += tile) {
        float s = 0.0f;
        if (e == a.F) {
          for (int p = 0; p < tile; ++p) s += alb[p];
        } else {
          const float* fi = fb + e * ts;
          const float* fdi = fdb + e * ts;
          for (int p = 0; p < tile; ++p)
            s = fmaf(alb[p], fi[p], s + fdi[p]);
        }
        GL[e] += s;
      }
      __syncthreads();
    }
    if (adv)
      for (int j = 0; j < a.d; ++j)
        f[j * ts] = __fadd_rn(f[j * ts], gb[j * ts]);
  }
  if (kTorus) {
    // the block's lambda entry: the paths' sums, through the alpha row
    // (every read of it above ended at a barrier)
    *al = g_lam;
    __syncthreads();
    if (tid == 0) {
      float sum = 0.0f;
      for (int p = 0; p < tile; ++p) sum += al[p];
      G[a.g_lam] = sum;
    }
  }
}

// Shared memory of one block, in floats: the staged net and the per-path
// arrays of stride tile + 1.  The wrapper's _stopped_smem_bytes computes
// the same.
size_t smem_floats(const StoppedArgs& a, bool backward) {
  const size_t H = a.F - (a.time_stopping ? a.d + 1 : a.d);
  const size_t per_path = backward ? 3 * a.F + 3 * H + 1 : 2 * a.F + H;
  return (a.stage ? a.n_params : 0) +
         per_path * static_cast<size_t>(a.tile + 1);
}

int unpack(const int* iargs, const float* fargs, unsigned long long seed,
           int device, StoppedArgs* a) {
  memcpy(a, iargs, (kNumIntArgs - kNumTailArgs) * sizeof(int));
  memcpy(&a->dt, fargs, (kNumFloatArgs - kNumTailArgs) * sizeof(float));
  memcpy(&a->out_relu, iargs + kNumIntArgs - kNumTailArgs,
         kNumTailArgs * sizeof(int));
  memcpy(&a->X_l, fargs + kNumFloatArgs - kNumTailArgs,
         kNumTailArgs * sizeof(float));
  a->key0 = static_cast<uint32_t>(seed & 0xFFFFFFFFull);
  a->key1 = static_cast<uint32_t>(seed >> 32);
  const bool torus = a->geom == 2;
  if (a->tile <= 0 || a->tile > kStoppedTile || a->tile % 32 != 0 ||
      a->L < 1 || a->L > kMaxHidden || a->K <= 0 || a->geom < 0 ||
      a->geom > 2 || (a->geom == 1 && !a->time_stopping) ||
      (torus && (a->time_stopping || a->lam_off < 0 ||
                 a->lam_off >= a->n_params || a->g_lam != a->n_grad - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaSetDevice(device));
}

template <typename Kernel, typename... Args>
int launch(Kernel kernel, const StoppedArgs& a, bool backward, void* stream,
           Args... args) {
  const size_t smem = sizeof(float) * smem_floats(a, backward);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned grid = static_cast<unsigned>((a.K + a.tile - 1) / a.tile);
  kernel<<<grid, a.tile, smem, static_cast<cudaStream_t>(stream)>>>(a,
                                                                     args...);
  return static_cast<int>(cudaGetLastError());
}

// A launch's instantiation: the clock, the torus family, the output clamp.
template <bool kTimed, bool kTorus, bool kRelu>
struct Family {
  static constexpr bool timed = kTimed, torus = kTorus, relu = kRelu;
};

template <typename Fn>
int with_family(const StoppedArgs& a, Fn fn) {
  if (a.geom == 2)
    return a.out_relu ? fn(Family<false, true, true>())
                      : fn(Family<false, true, false>());
  if (a.time_stopping)
    return a.out_relu ? fn(Family<true, false, true>())
                      : fn(Family<true, false, false>());
  return a.out_relu ? fn(Family<false, false, true>())
                    : fn(Family<false, false, false>());
}

}  // namespace

// Launch on `stream` of CUDA device `device`; each returns the cudaError_t
// of the launch (0 = success).  `iargs` and `fargs` are host arrays in the
// order of StoppedArgs.

// Forward: X0 (K, d), t0 (K,) -> X_out (K, d), acc_out (6, K): Y, stopped,
// hitting, v_l2, adv_steps, t.
extern "C" int pspde_stopped_rollout_fwd(const float* params,
                                         const float* host_noise,
                                         const float* X0, const float* t0,
                                         float* X_out, float* acc_out,
                                         const int* iargs,
                                         const float* fargs,
                                         unsigned long long seed, int device,
                                         void* stream) {
  StoppedArgs a;
  const int err = unpack(iargs, fargs, seed, device, &a);
  if (err != 0) return err;
  return with_family(a, [&](auto fam) {
    using Fam = decltype(fam);
    return launch(stopped_fwd_kernel<Fam::timed, Fam::torus, Fam::relu>, a,
                  false, stream, params, host_noise, X0, t0, X_out, acc_out);
  });
}

// Backward: X0, t0, gY (K,) -> grad_out (ceil(K / tile), n_grad), one row of
// per-layer [W (n_in, width); b (1, width)] and [wL (F); bL] sums per block,
// and on the torus the lambda entry last.
extern "C" int pspde_stopped_rollout_bwd(const float* params,
                                         const float* host_noise,
                                         const float* X0, const float* t0,
                                         const float* gY, float* grad_out,
                                         const int* iargs,
                                         const float* fargs,
                                         unsigned long long seed, int device,
                                         void* stream) {
  StoppedArgs a;
  const int err = unpack(iargs, fargs, seed, device, &a);
  if (err != 0) return err;
  return with_family(a, [&](auto fam) {
    using Fam = decltype(fam);
    return launch(stopped_bwd_kernel<Fam::timed, Fam::torus, Fam::relu>, a,
                  true, stream, params, host_noise, X0, t0, gY, grad_out);
  });
}
