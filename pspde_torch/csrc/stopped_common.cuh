// The stopped kernels' shared code: the argument structs, the families'
// device functions, a lane's split of the value sweep and of grad V, the
// weight-gradient product of the backward, and the host's unpacking, family
// dispatch and launch.  Two sources include it: stopped_rollout.cu (the
// forward kernels and the backward's shared plan; its head holds the design
// notes of all of them) and stopped_bwd_lanes.cu (the backward's lanes
// kernel), each compiled by its own nvcc (pspde_torch/rollout/_build.py), so
// that one build waits on neither.  Everything here sits in an anonymous
// namespace, as it did in the one source it came from: each source keeps
// its own copy, and its kernels keep their code.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

#include "common.cuh"

namespace {

using namespace pspde;

constexpr int kMaxHidden = 4;   // pspde_torch/rollout/kernels.py _MAX_HIDDEN

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
  // The torus family and the clamp come last, so that every field the
  // other families read keeps its offset (and their code its SASS).
  int out_relu;     // V = relu(o) (DenseNet output_relu)
  int lam_off;      // the torus family: lambda's offset in the packed net
  int g_lam;        // and its entry of the gradient row (the last)
  float X_l, X_r;   // the square of the torus family
  float c_tor;      // its uniform coefficient c
  const unsigned long long* seed;   // the Philox seed's device word
  unsigned long long* launches;     // the launch count (count_launch)
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
static_assert(offsetof(StoppedArgs, out_relu) ==
                  offsetof(StoppedArgs, dt) +
                      (kNumFloatArgs - kNumTailArgs) * sizeof(float),
              "the wrapper's floats but the last three follow");
static_assert(offsetof(StoppedArgs, X_l) ==
                  offsetof(StoppedArgs, out_relu) + kNumTailArgs * sizeof(int),
              "the last three ints, then the last three floats");

// The breadth families' fields (the header): the kernels' argument after
// the old ones.  The wrapper packs them after StoppedArgs' ints and floats.
struct StoppedExt {
  int sig_off;      // a dense sigma's offset in the packed net, -1: scalar
  int vref;         // with have_vref: 0 exp(a_vref |x|^2), 1 the committor's
  float r_in;       // geometry 3: the inner radius (`radius` the outer)
  float c_ys1;      // h's coefficient on V (sum_j x_j)^2
  float vr_a2, vr_ad, vr_den;   // the committor's a^2, a^d and
                                // a^2 - c^(2-d) a^d
  float c_y3;       // h's coefficient on V^3 (with the clock)
  // The Schroedinger family and the feature map come last, so that every
  // field above keeps its offset (and the breadth families' code its SASS).
  int feat;         // the value net's features: 0 relu(h)^2, 1 tanh(h)
  int hfam;         // 1: the Schroedinger family (on the square)
  float sch_a, sch_b;   // -1/c^2 and 1/c
  float sch_2d, sch_1d; // 2/d and 1/d
};
// The wrapper packs kNumExtInts ints (sig_off, vref, then feat, hfam) and
// kNumExtFloats floats (r_in ... c_y3, then sch_a ... sch_1d).
constexpr int kNumExtInts = 4;
constexpr int kNumExtFloats = 10;
constexpr int kNumExtTailInts = 2;
constexpr int kNumExtTailFloats = 4;
static_assert(offsetof(StoppedExt, r_in) ==
                      (kNumExtInts - kNumExtTailInts) * sizeof(int) &&
                  offsetof(StoppedExt, feat) ==
                      offsetof(StoppedExt, r_in) +
                          (kNumExtFloats - kNumExtTailFloats) *
                              sizeof(float) &&
                  offsetof(StoppedExt, sch_a) ==
                      offsetof(StoppedExt, feat) +
                          kNumExtTailInts * sizeof(int) &&
                  sizeof(StoppedExt) ==
                      kNumExtInts * sizeof(int) +
                          kNumExtFloats * sizeof(float),
              "the wrapper's first ext ints, then its first ext floats, "
              "then the last two ints and the last four floats");
// The launch's own ints (the layout) follow all the wrapper's ints.
constexpr int kNumPackedInts = kNumIntArgs + kNumExtInts;

// Net input rows: the d state rows, and the clock's with time_stopping.
template <bool kTimed>
__device__ __forceinline__ int net_inputs(const StoppedArgs& a) {
  return kTimed ? a.d + 1 : a.d;
}

__device__ __forceinline__ int padded(int w) {
  return (w + kChunk - 1) / kChunk * kChunk;
}

// The Philox key, read from the seed's device word.
__device__ __forceinline__ uint2 stopped_seed(const StoppedArgs& a) {
  const unsigned long long s = __ldg(a.seed);
  return make_uint2(static_cast<uint32_t>(s & 0xFFFFFFFFull),
                    static_cast<uint32_t>(s >> 32));
}

__device__ __forceinline__ void draw4(const StoppedArgs& a, uint2 key,
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
                  static_cast<uint32_t>(g), key.x, key.y, a.rng, xi);
}

// |x|^2 over rows 0..d of this path's column, in a fixed order.
__device__ __forceinline__ float sq_norm(const float* f, int d, int ts) {
  float r2 = 0.0f;
  for (int j = 0; j < d; ++j) r2 = fmaf(f[j * ts], f[j * ts], r2);
  return r2;
}

// sum_j x_j over rows 0..d of this path's column, in a fixed order (h's
// c_ys1 term).
__device__ __forceinline__ float coord_sum(const float* f, int d, int ts) {
  float s1 = 0.0f;
  for (int j = 0; j < d; ++j) s1 += f[j * ts];
  return s1;
}

// Z_j = (sigma^T grad V)_j = sum_i sigma_ij g_i, i ascending: sigma is
// d x d row-major at sg, g this path's rows of grad V.
__device__ __forceinline__ float full_z(const float* sg, const float* g,
                                        int d, int j, int ts) {
  float z = 0.0f;
  for (int i = 0; i < d; ++i) z = fmaf(sg[i * d + j], g[i * ts], z);
  return z;
}

// The increment (sigma c)_j dt + (sigma xi)_j sqrt(dt) of coordinate j
// under a dense sigma, with c = -Z when adaptive (z: the rows of Z) and
// the normals' rows xs, each sum over i ascending; rounded as the plain
// version rounds (b(X) + sigma c) dt + sigma xi sqrt(dt) with b = 0.
__device__ __forceinline__ float full_step(const StoppedArgs& a,
                                           const float* sg, const float* z,
                                           const float* xs, int j, int ts) {
  const float* row = sg + j * a.d;
  float sc = 0.0f, sx = 0.0f;
  for (int i = 0; i < a.d; ++i) {
    if (a.adaptive) sc = fmaf(row[i], -z[i * ts], sc);
    sx = fmaf(row[i], xs[i * ts], sx);
  }
  return __fadd_rn(__fmul_rn(sc, a.dt), __fmul_rn(sx, a.sq_dt));
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

// The Schroedinger family at the pre-step state X (rows 0..d of f): S =
// sum_j cos X_j and pot(X), each term rounded as the plain version rounds
// it (pspde_torch/problems/eigen.py:schrodinger_pot).
__device__ __forceinline__ void sch_terms(const StoppedArgs& a,
                                          const StoppedExt& ext,
                                          const float* f, int ts, float* S,
                                          float* pot) {
  const float d1 = static_cast<float>(a.d);
  const float d2 = static_cast<float>(a.d * a.d);
  float sc = 0.0f, u = 0.0f;
  for (int j = 0; j < a.d; ++j) {
    const float x = f[j * ts];
    const float cx = cosf(x), sx = sinf(x);
    sc = __fadd_rn(sc, cx);
    u = __fadd_rn(u, __fsub_rn(__fdiv_rn(__fmul_rn(sx, sx), d2),
                               __fdiv_rn(cx, d1)));
  }
  *S = sc;
  *pot = __fsub_rn(
      __fadd_rn(__fmul_rn(ext.sch_a, expf(__fmul_rn(ext.sch_2d, sc))), u),
      3.0f);
}

// h = -V^3 - V pot of the Schroedinger family, without lambda, and dh/dy.
__device__ __forceinline__ float sch_h(float y, float pot) {
  return __fsub_rn(-__fmul_rn(__fmul_rn(y, y), y), __fmul_rn(y, pot));
}

__device__ __forceinline__ float sch_h_dy(float y, float pot) {
  return __fsub_rn(__fmul_rn(__fmul_rn(-3.0f, y), y), pot);
}

// Its reference (1/c) exp((1/d) S).
__device__ __forceinline__ float sch_vref(const StoppedExt& ext, float S) {
  return __fmul_rn(ext.sch_b, expf(__fmul_rn(ext.sch_1d, S)));
}

// The tanh features' slope 1 - f^2 at f = tanh(h): the derivative that
// both kernels' sweeps read, formed once so that its rounding is one.
__device__ __forceinline__ float tanh_slope(float tv) {
  return __fsub_rn(1.0f, __fmul_rn(tv, tv));
}

// The net's output o of the inputs in rows 0..d_in of f (V, or relu's
// argument with the output clamp): writes the features relu(h)^2 into rows
// d_in..F of f and relu(h) into r, and returns o; kTanh: the features
// tanh(h) and their slope 1 - tanh(h)^2 into r.
template <bool kTimed, bool kTanh = false>
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
        if constexpr (kTanh) {
          if (j < w) {
            const float tv = tanhf(acc[c] + bl[j]);
            rl[j * ts] = tanh_slope(tv);
            f[(n_in + j) * ts] = tv;
          }
        } else {
          if (j < w) {
            const float rv = fmaxf(acc[c] + bl[j], 0.0f);
            rl[j * ts] = rv;
            f[(n_in + j) * ts] = rv * rv;
          }
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
// last value_forward (kTanh: the slopes).
template <bool kTimed, bool kTanh = false>
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
    if constexpr (kTanh) {
      for (int j = 0; j < w; ++j)
        g[(o + j) * ts] = __fmul_rn(rl[j * ts], g[(o + j) * ts]);
    } else {
      for (int j = 0; j < w; ++j)
        g[(o + j) * ts] = 2.0f * rl[j * ts] * g[(o + j) * ts];
    }
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

// The breadth families (no clock; the header): the step's selection mask
// on the sphere or the two spheres (the current state), h and dh/dy (the
// ball family's and c_ys1 y (sum_j x_j)^2, with s1 = sum_j x_j), and the
// in-kernel reference, exp(a_vref |x|^2) or the committor's closed form.
// The kernels call them only in their kBreadth instantiations, each
// behind `if constexpr`, so that the others keep their code.
__device__ __forceinline__ bool breadth_selected(const StoppedArgs& a,
                                                 const StoppedExt& ext,
                                                 float r2) {
  const float r = sqrtf(r2);
  return a.geom == 3 ? r > ext.r_in && r < a.radius : r < a.radius;
}

__device__ __forceinline__ float breadth_h_value(const StoppedArgs& a,
                                                 const StoppedExt& ext,
                                                 float r2, float s1,
                                                 float y) {
  return h_value<false>(a, r2, 0.0f, y) + y * (ext.c_ys1 * (s1 * s1));
}

__device__ __forceinline__ float breadth_h_dy(const StoppedArgs& a,
                                              const StoppedExt& ext,
                                              float r2, float s1, float y) {
  return h_dy<false>(a, r2, 0.0f, y) + ext.c_ys1 * (s1 * s1);
}

__device__ __forceinline__ float breadth_vref(const StoppedArgs& a,
                                              const StoppedExt& ext,
                                              float r2) {
  if (ext.vref == 1)
    return (ext.vr_a2 - powf(sqrtf(r2), static_cast<float>(2 - a.d)) *
                            ext.vr_ad) /
           ext.vr_den;
  return expf(a.a_vref * r2);
}

// The cubic family (the clock; the header): h and dh/dy of the ball family
// with the clock, and c_y3 y^3.  Called only in the <kTimed, kBreadth>
// instantiations, behind `if constexpr`.
__device__ __forceinline__ float cubic_h_value(const StoppedArgs& a,
                                               const StoppedExt& ext,
                                               float r2, float t, float y) {
  return h_value<true>(a, r2, t, y) + ext.c_y3 * (y * y * y);
}

__device__ __forceinline__ float cubic_h_dy(const StoppedArgs& a,
                                            const StoppedExt& ext, float r2,
                                            float t, float y) {
  return h_dy<true>(a, r2, t, y) + 3.0f * ext.c_y3 * (y * y);
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

// The forward's staged net pads each W row by kRowPad floats (FwdNet).
constexpr int kRowPad = 4;

// The tpp threads of one lane: consecutive threads of one warp (tpp a power
// of two, at most 32), thread q of them, and their warp mask.  Every thread
// of a lane holds the path's scalars and takes every branch alike; they
// meet at sync() where one reads what another wrote.
struct Lane {
  int q, p;
  unsigned mask;
  __device__ __forceinline__ Lane(int tid, int tpp)
      : q(tid & (tpp - 1)), p(tpp),
        mask((tpp == 32 ? 0xFFFFFFFFu : (1u << tpp) - 1u)
             << ((tid & 31) - (tid & (tpp - 1)))) {}
  __device__ __forceinline__ void sync() const { __syncwarp(mask); }
  // the lane's thread 0, as a lane of the warp
  __device__ __forceinline__ int leader() const {
    return (threadIdx.x & 31) - q;
  }
};

// The net as the forward reads it: where it is staged, the packed buffer
// with each W's rows at stride padded(w) + kRowPad and every later section
// shifted by the pads before it, so that the rows the threads of a lane
// read at once in lane_value_grad (i, i + 1, ...) lie in other banks (rows
// of a multiple of 32 floats would put them all in one); else the packed
// buffer in device memory (pad 0).
struct FwdNet {
  const float* W;
  int pad;
  int shift[kMaxHidden + 1];   // floats of pads before W_l's section (l),
                               // before b_l's (l + 1), before wL's (L)
  __device__ __forceinline__ const float* w(const StoppedArgs& a,
                                            int l) const {
    return W + a.w_off[l] + shift[l];
  }
  __device__ __forceinline__ int stride(const StoppedArgs& a, int l) const {
    return padded(a.width[l]) + pad;
  }
  __device__ __forceinline__ const float* b(const StoppedArgs& a,
                                            int l) const {
    return W + a.b_off[l] + shift[l + 1];
  }
  __device__ __forceinline__ const float* wL(const StoppedArgs& a) const {
    return W + a.wL_off + shift[a.L];
  }
  __device__ __forceinline__ float bL(const StoppedArgs& a) const {
    return W[a.bL_off + shift[a.L]];
  }
};

// The forward's net: staged in S by the block's threads (FwdNet's layout)
// where the wrapper asked for it, advancing *col past it, else P.
__device__ __forceinline__ FwdNet stage_fwd_net(const StoppedArgs& a,
                                                const float* __restrict__ P,
                                                float* S, float** col) {
  FwdNet net{P, 0, {0, 0, 0, 0, 0}};
  if (!a.stage) return net;
  int n_in = a.F;
  for (int l = 0; l < a.L; ++l) n_in -= a.width[l];
  for (int l = 0; l < a.L; ++l) {
    net.shift[l + 1] = net.shift[l] + kRowPad * n_in;
    n_in += a.width[l];
  }
  for (int x = threadIdx.x; x < a.n_params; x += blockDim.x) {
    int l = a.L - 1;
    while (l > 0 && x < a.w_off[l]) --l;
    const int wp = padded(a.width[l]);
    const int i = (x - a.w_off[l]) / wp;
    const int rows = (a.b_off[l] - a.w_off[l]) / wp;   // W_l's
    S[i < rows ? x + net.shift[l] + kRowPad * i : x + net.shift[l + 1]] =
        P[x];
  }
  net.W = S;
  net.pad = kRowPad;
  *col += a.n_params + net.shift[a.L];
  return net;
}

// value_forward split over a lane's threads, the net read through FwdNet:
// thread q computes the output chunks q, q + p, ... of each hidden layer
// with matvec_chunk, each output's sum over the input rows in
// value_forward's order; the threads meet after each layer, and each forms
// the output row's sum, the same sum in every thread.
template <bool kTimed, bool kTanh = false>
__device__ float lane_value_forward(const StoppedArgs& a, const FwdNet& net,
                                    float* f, float* r, int ts,
                                    const Lane& ln) {
  const int d_in = net_inputs<kTimed>(a);
  int n_in = d_in;
  for (int l = 0; l < a.L; ++l) {
    const int w = a.width[l], wp = padded(w), ws = net.stride(a, l);
    const float* Wl = net.w(a, l);
    const float* bl = net.b(a, l);
    float* rl = r + (n_in - d_in) * ts;
    for (int j0 = ln.q * kChunk; j0 < wp; j0 += ln.p * kChunk) {
      float acc[kChunk];
#pragma unroll
      for (int c = 0; c < kChunk; ++c) acc[c] = 0.0f;
      matvec_chunk(Wl, n_in, ws, j0, f, ts, acc);
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const int j = j0 + c;
        if constexpr (kTanh) {
          if (j < w) {
            const float tv = tanhf(acc[c] + bl[j]);
            rl[j * ts] = tanh_slope(tv);
            f[(n_in + j) * ts] = tv;
          }
        } else {
          if (j < w) {
            const float rv = fmaxf(acc[c] + bl[j], 0.0f);
            rl[j * ts] = rv;
            f[(n_in + j) * ts] = rv * rv;
          }
        }
      }
    }
    n_in += w;
    ln.sync();
  }
  const float* wL = net.wL(a);
  float v = 0.0f;
  for (int i = 0; i < a.F; ++i) v = fmaf(f[i * ts], wL[i], v);
  return v + net.bL(a);
}

// value_grad split over a lane's threads: row i belongs to thread i mod p,
// which forms its sums over each layer's outputs in value_grad's order, two
// rows a pass (i and i + p, two chains sharing the loads of the outputs'
// rows).  The threads meet before each layer's sums, which read other
// threads' rows; the caller makes them meet after the last.
template <bool kTimed, bool kTanh = false>
__device__ void lane_value_grad(const StoppedArgs& a, const FwdNet& net,
                                const float* r, float* g, int ts,
                                const Lane& ln) {
  const int d_in = net_inputs<kTimed>(a);
  const float* wL = net.wL(a);
  for (int i = ln.q; i < a.F; i += ln.p) g[i * ts] = wL[i];
  int o = a.F;
  for (int l = a.L - 1; l >= 0; --l) {
    const int w = a.width[l], ws = net.stride(a, l);
    o -= w;   // layer l's outputs are feature rows o..o + w, its inputs 0..o
    const float* rl = r + (o - d_in) * ts;
    if constexpr (kTanh) {
      for (int j = (ln.q - o) & (ln.p - 1); j < w; j += ln.p)
        g[(o + j) * ts] = __fmul_rn(rl[j * ts], g[(o + j) * ts]);
    } else {
      for (int j = (ln.q - o) & (ln.p - 1); j < w; j += ln.p)
        g[(o + j) * ts] = 2.0f * rl[j * ts] * g[(o + j) * ts];
    }
    ln.sync();
    const float* Wl = net.w(a, l);
    for (int i = ln.q; i < o; i += 2 * ln.p) {
      const int i2 = i + ln.p;
      const float* Wi = Wl + i * ws;
      const float* Wi2 = Wl + min(i2, o - 1) * ws;
      float s = 0.0f, s2 = 0.0f;
      for (int j = 0; j < w; ++j) {
        const float gj = g[(o + j) * ts];
        s = fmaf(Wi[j], gj, s);
        s2 = fmaf(Wi2[j], gj, s2);
      }
      g[i * ts] += s;
      if (i2 < o) g[i2 * ts] += s2;
    }
  }
}

// -- the backward's shared pieces ------------------------------------------

// The first path of block b's range: the grid's blocks own contiguous
// ranges of whole tiles, tiles floor(b T / grid) .. floor((b + 1) T / grid)
// of the T = ceil(K / tile) (the last cut at K; pspde_torch/rollout/
// kernels.py: _stopped_ranges computes the same).  Where paths run their N
// steps (the torus) whole tiles keep each round of the lanes full, as one
// block per tile did; ranges balanced by paths left every block a last
// round of 37 of 64 paths at K = 65536.
__device__ __forceinline__ int range_start(int b, int K, int tile,
                                           int grid) {
  const int T = (K + tile - 1) / tile;
  return min(K, tile * static_cast<int>(static_cast<long long>(b) * T /
                                        grid));
}

constexpr int kUnitN = 4;   // n tiles (8 output columns each) of a unit

// One warp's unit of one hidden layer's sums over the block's paths,
//   G[r][j] += sum_{p < tile} in0_r[p] D0_j[p] + in1_r[p] D1_j[p],
// for the 16 rows m0.. and the kN x 8 columns n0.. of G (rows + 1,
// cols), row-major: one product of depth 2 tile, the features f against
// the cotangents hbar of h and the tangents f' against those hbar' of h'.
// Row r < rows of the left operands is row r of in0 / in1; row `rows` (the
// bias) is 1 in the first pair and 0 in the second; rows past it are 0 and
// nothing is stored there.  A column past `cols` reads the layer's last
// column and is not stored either, so that every load stays in the layer's
// rows.  All four point at path 0 of [row][ts] arrays, in shared memory
// (kShared) or in the device plan's workspace, read as mma fragments (M:
// the gradient row, N: the output column, K: the paths).  Each operand is
// split into two TF32 parts and each pair of parts multiplied on the
// tensor cores (3xTF32: big big, big small, small big, in
// three independent float32 accumulators); the old G is loaded before the
// products and the step's sum added to it once.
template <bool kShared, int kN = kUnitN>
__device__ __forceinline__ void pair_tile_product(
    const float* in0, const float* D0, const float* in1, const float* D1,
    int rows, int cols, int ts, int tile, float* G, int m0, int n0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  const int nq = min(kN, (cols - n0 + 7) >> 3);
  // the lane's rows m0 + g and m0 + g + 8 of A, and its kN rows of D
  const int ra = m0 + g, rb = ra + 8;
  const bool fa = ra < rows, fb = rb < rows;
  const int oa = (fa ? ra : 0) * ts + c, ob = (fb ? rb : 0) * ts + c;
  const float ca = ra == rows ? 1.0f : 0.0f, cb = rb == rows ? 1.0f : 0.0f;
  int oq[kN];
#pragma unroll
  for (int q = 0; q < kN; ++q)
    oq[q] = min(n0 + 8 * q + g, cols - 1) * ts + c;
  float old[kN][4];
#pragma unroll
  for (int q = 0; q < kN; ++q) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = ra + 8 * (e >> 1), j = n0 + 8 * q + 2 * c + (e & 1);
      old[q][e] = q < nq && r <= rows && j < cols ? G[r * cols + j] : 0.0f;
    }
  }
  // One k-step's fragments, read with ld.shared in shared memory.  The
  // loads are volatile asm, kept in program order with the mma: each
  // step's loads are issued a step ahead, so their latency overlaps the
  // step before's products.
  const PathRow<kShared> A0(in0), A1(in1), B0(D0), B1(D1);
  auto load = [&](int kk, float (&fa_)[4], float (&fb_)[kN][2]) {
    const bool second = kk >= tile;
    const int k0 = second ? kk - tile : kk;
    const PathRow<kShared> A = second ? A1 : A0, B = second ? B1 : B0;
    fa_[0] = A[oa + k0];
    fa_[1] = A[ob + k0];
    fa_[2] = A[oa + k0 + 4];
    fa_[3] = A[ob + k0 + 4];
#pragma unroll
    for (int q = 0; q < kN; ++q) {
      if (q < nq) {
        fb_[q][0] = B[oq[q] + k0];
        fb_[q][1] = B[oq[q] + k0 + 4];
      }
    }
  };
  float bb_[kN][4] = {}, bs_[kN][4] = {}, sb_[kN][4] = {};
  float a[4], b[kN][2] = {}, an[4], bn[kN][2] = {};
  load(0, a, b);
#pragma unroll 2
  for (int kk = 0; kk < 2 * tile; kk += 8) {
    load(min(kk + 8, 2 * tile - 8), an, bn);   // the next step's
    const bool second = kk >= tile;
    const float ka = second ? 0.0f : ca, kb = second ? 0.0f : cb;
    uint32_t ab[4], as[4];
    tf32_split(fa ? a[0] : ka, ab[0], as[0]);
    tf32_split(fb ? a[1] : kb, ab[1], as[1]);
    tf32_split(fa ? a[2] : ka, ab[2], as[2]);
    tf32_split(fb ? a[3] : kb, ab[3], as[3]);
#pragma unroll
    for (int q = 0; q < kN; ++q) {
      if (q < nq) {
        uint32_t bb[2], bs[2];
        tf32_split(b[q][0], bb[0], bs[0]);
        tf32_split(b[q][1], bb[1], bs[1]);
        mma_tf32(bb_[q], ab, bb);
        mma_tf32(bs_[q], ab, bs);
        mma_tf32(sb_[q], as, bb);
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) a[e] = an[e];
#pragma unroll
    for (int q = 0; q < kN; ++q) {
      b[q][0] = bn[q][0];
      b[q][1] = bn[q][1];
    }
  }
#pragma unroll
  for (int q = 0; q < kN; ++q) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = ra + 8 * (e >> 1), j = n0 + 8 * q + 2 * c + (e & 1);
      if (q < nq && r <= rows && j < cols)
        G[r * cols + j] = old[q][e] + ((sb_[q][e] + bs_[q][e]) + bb_[q][e]);
    }
  }
}

// -- the host ---------------------------------------------------------------

// The staged net's floats: the packed buffer, with the forward's row pads
// (FwdNet) where `padded`; 0 where a.stage is 0.
inline size_t staged_net_floats(const StoppedArgs& a, bool padded) {
  if (!a.stage) return 0;
  size_t net = a.n_params;
  if (padded) {
    size_t n_in = a.time_stopping ? a.d + 1 : a.d;
    for (int l = 0; l < a.L; ++l) {
      net += kRowPad * n_in;
      n_in += a.width[l];
    }
  }
  return net;
}

// The breadth fields that go without the clock: the two spheres, a dense
// sigma, the committor's reference, c_ys1.
inline bool unclocked(const StoppedArgs& a, const StoppedExt& ext) {
  return a.geom == 3 || ext.sig_off >= 0 || ext.vref != 0 ||
         ext.c_ys1 != 0.0f;
}

// Whether a call belongs to the breadth families (their instantiations):
// those fields, or the cubic's c_y3, which goes with the clock.
inline bool breadth(const StoppedArgs& a, const StoppedExt& ext) {
  return unclocked(a, ext) || ext.c_y3 != 0.0f;
}

// StoppedArgs and StoppedExt from the wrapper's arrays, checked but for the
// tile, which each kernel's layout checks.
inline int unpack(const int* iargs, const float* fargs,
           const unsigned long long* seed, int device, StoppedArgs* a,
           StoppedExt* ext) {
  memcpy(a, iargs, (kNumIntArgs - kNumTailArgs) * sizeof(int));
  memcpy(&a->dt, fargs, (kNumFloatArgs - kNumTailArgs) * sizeof(float));
  memcpy(&a->out_relu, iargs + kNumIntArgs - kNumTailArgs,
         kNumTailArgs * sizeof(int));
  memcpy(&a->X_l, fargs + kNumFloatArgs - kNumTailArgs,
         kNumTailArgs * sizeof(float));
  memcpy(ext, iargs + kNumIntArgs,
         (kNumExtInts - kNumExtTailInts) * sizeof(int));
  memcpy(&ext->r_in, fargs + kNumFloatArgs,
         (kNumExtFloats - kNumExtTailFloats) * sizeof(float));
  memcpy(&ext->feat, iargs + kNumIntArgs + kNumExtInts - kNumExtTailInts,
         kNumExtTailInts * sizeof(int));
  memcpy(&ext->sch_a, fargs + kNumFloatArgs + kNumExtFloats -
                          kNumExtTailFloats,
         kNumExtTailFloats * sizeof(float));
  a->seed = seed;
  a->launches = nullptr;
  const bool torus = a->geom == 2;
  if (a->L < 1 || a->L > kMaxHidden || a->K <= 0 || a->geom < 0 ||
      a->geom > 3 || (a->geom == 1 && !a->time_stopping) ||
      (torus && (a->time_stopping || a->lam_off < 0 ||
                 a->lam_off >= a->n_params || a->g_lam != a->n_grad - 1)) ||
      ext->vref < 0 || ext->vref > 1 ||
      (ext->sig_off >= 0 && ext->sig_off + a->d * a->d > a->n_params) ||
      (unclocked(*a, *ext) && (torus || a->time_stopping)) ||
      (ext->c_y3 != 0.0f && !a->time_stopping) ||
      // the Schroedinger family goes on the square, with tanh features;
      // tanh with another family is not instantiated (ROADMAP.md Queue 2
      // item 4(g))
      ext->hfam < 0 || ext->hfam > 1 || ext->feat != ext->hfam ||
      (ext->hfam == 1 && !torus))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaSetDevice(device));
}

// Lets `kernel` take `smem` bytes of dynamic shared memory, once per
// kernel and size (allow_dynamic_smem), and launches it with `args`.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, size_t smem, int grid, int threads, void* stream,
           Args... args) {
  const cudaError_t e =
      allow_dynamic_smem(reinterpret_cast<const void*>(kernel), smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<static_cast<unsigned>(grid), threads, smem,
           static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// The blocks of `kernel` at `threads` a block and `smem` shared bytes that
// device `device` holds on one SM (the shared memory, the registers and the
// threads allow) into *per_sm, its SMs into *sms.
template <typename Kernel>
int occupancy(Kernel kernel, size_t smem, int threads, int device,
              int* per_sm, int* sms) {
  cudaError_t e =
      allow_dynamic_smem(reinterpret_cast<const void*>(kernel), smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                      threads, smem);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  return static_cast<int>(e);
}

// A launch's instantiation: the clock, the torus family, the output clamp,
// a dense sigma and the breadth families (the header; with the clock, the
// cubic), the Schroedinger family on the square and the tanh features.
template <bool kTimed, bool kTorus, bool kRelu, bool kFull, bool kBreadth,
          bool kSch = false, bool kTanh = false>
struct Family {
  static constexpr bool timed = kTimed, torus = kTorus, relu = kRelu,
                        full = kFull, breadth = kBreadth, sch = kSch,
                        tanh = kTanh;
};

template <typename Fn>
int with_family(const StoppedArgs& a, const StoppedExt& ext, Fn fn) {
  if (breadth(a, ext)) {
    if (a.time_stopping)   // the cubic, the one breadth field with the clock
      return a.out_relu ? fn(Family<true, false, true, false, true>())
                        : fn(Family<true, false, false, false, true>());
    if (ext.sig_off >= 0)
      return a.out_relu ? fn(Family<false, false, true, true, true>())
                        : fn(Family<false, false, false, true, true>());
    return a.out_relu ? fn(Family<false, false, true, false, true>())
                      : fn(Family<false, false, false, false, true>());
  }
  if (a.geom == 2 && ext.hfam == 1)
    return a.out_relu
               ? fn(Family<false, true, true, false, false, true, true>())
               : fn(Family<false, true, false, false, false, true, true>());
  if (a.geom == 2)
    return a.out_relu ? fn(Family<false, true, true, false, false>())
                      : fn(Family<false, true, false, false, false>());
  if (a.time_stopping)
    return a.out_relu ? fn(Family<true, false, true, false, false>())
                      : fn(Family<true, false, false, false, false>());
  return a.out_relu ? fn(Family<false, false, true, false, false>())
                    : fn(Family<false, false, false, false, false>());
}

}  // namespace

// The backward's device plan (stopped_bwd_lanes.cu): the launch and the
// slots of the lanes kernel, with the arguments of pspde_stopped_rollout_bwd
// and pspde_stopped_bwd_slots, which hand a call whose plan int is 1 to
// them.
extern "C" int pspde_stopped_rollout_bwd_lanes(
    const float* params, const float* host_noise, const float* X0,
    const float* t0, const float* gY, float* grad_out, int* counts,
    float* ws, const int* iargs, const float* fargs,
    const unsigned long long* seed, unsigned long long* launches, int device,
    void* stream);
extern "C" int pspde_stopped_bwd_lane_slots(const int* iargs,
                                            const float* fargs, int device,
                                            int* slots);
