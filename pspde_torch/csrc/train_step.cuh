// The per-step device code of the HJB training forward, shared by the
// training kernels (train_rollout.cu) and the roofline's ablation ladder
// (roofline.cu), so that the ladder's `full` stage executes the forward's
// own instructions.
//
// Two memory plans, chosen by the wrapper (pspde_torch/rollout/kernels.py:
// _choose_plan) and recorded in TrainArgs::plan:
//   * shared (0): the net and X_0 (the staged prefix of the packed buffer)
//     are copied to shared memory once per block; each path's arrays are
//     [row][stride] in shared memory after them (and after the block's
//     gradient buffer in the backward), stride = train_stride;
//   * device (1): for widths whose block fits no tile (d ~ 250 and up) the
//     net and X_0 are read from device memory (the same for every thread:
//     L1 and the 50 MB L2 serve them), each path's arrays live in a
//     workspace of device memory laid out [row][ws_stride] with
//     ws_stride = the grid's paths, so a warp reads 32 consecutive words,
//     and the backward's gradient row is the block's row of grad_out.
// Both plans run the same step code below: the arrays are reached through
// a pointer and a stride (`ts`), as common.cuh:dense / matvec_chunk take.

#pragma once

#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include "common.cuh"

namespace pspde {

// Layout of the integer and float argument arrays the wrapper passes
// (pspde_torch/rollout/kernels.py: _pack_train).
struct TrainArgs {
  int K, N, d, dp, n_layers, tile;
  int drift_kind;   // 0: b(x) = -x, 1: b(x) = A x (A^T at a_off)
  int a_off;
  int sig_kind;     // 0: scalar (sig_scale), 1: diag (at sig_off), 2: full
  int sig_off;
  int f_kind;       // 0: f not needed, 1: f = x^T P x (P^T at p_off)
  int p_off, x0_off;
  int n_stage;      // the staged prefix: the net and X_0
  int u_off, have_u, host_noise;
  int adaptive, accumulate_kl, kl_ito;
  int rng;          // 0: erfinv, 1: binom
  int n_grad;       // floats of one block's gradient buffer
  int rows[kMaxLayers], cols[kMaxLayers], w_off[kMaxLayers],
      b_off[kMaxLayers], g_off[kMaxLayers];
  int plan;         // 0: shared, 1: device
  int ws_stride;    // device plan: the row stride of the workspace
  float dt, sq_dt, noise_sign, sig_scale, c_h, f_coef;
  uint32_t key0, key1;
};
constexpr int kTrainIntArgs = 24 + 5 * kMaxLayers;   // the ints before `dt`
constexpr int kTrainFloatArgs = 6;
static_assert(offsetof(TrainArgs, dt) == kTrainIntArgs * sizeof(int),
              "TrainArgs must start with kTrainIntArgs ints, as the wrapper "
              "packs");

// One thread's per-path arrays: X, X' (X itself for the forward's
// elementwise update), Z (the backward's dZ), V = c dt + xi sqrt(dt) of the
// backward's dense update, the hidden activations H and (backward) their
// cotangents D, each row `ts` floats after the last.
struct TrainState {
  float* X;
  float* Xn;
  float* Zb;
  float* V;
  float* H[kMaxLayers];
  float* D[kMaxLayers];
  int ts;
};

// Per-path floats of one block's arrays; the wrapper's _pack_train counts
// the same.
__host__ __device__ inline size_t train_per_path(const TrainArgs& a,
                                                 bool backward) {
  const bool dense_update = a.drift_kind == 1 || a.sig_kind == 2;
  size_t hidden = 0;
  for (int l = 0; l + 1 < a.n_layers; ++l) hidden += a.cols[l];
  return backward ? a.dp * (dense_update ? 4 : 3) + 2 * hidden
                  : a.dp * (dense_update ? 3 : 2) + hidden;
}

// The row stride of the shared plan's per-path arrays.  A thread walking
// its own path reads one word of each row, so any stride serves the
// forward; tile + 1 is its.  The backward's weight-gradient products
// (train_weight_grads) also read mma fragments, element (g, c) of an 8 x 4
// block of rows and paths, at bank (g stride + c) mod 32: tile + 4 puts
// them on 32 different banks, where tile + 1 gives a 2-way conflict.
__host__ __device__ inline int train_stride(const TrainArgs& a,
                                            bool backward) {
  return a.tile + (backward ? 4 : 1);
}

// Dynamic shared memory of one block, in floats: the staged prefix, the
// gradient buffer (backward) and the per-path arrays at train_stride in
// the shared plan; none in the device plan.  The wrapper's
// _train_smem_bytes computes the same.
inline size_t train_smem_floats(const TrainArgs& a, bool backward) {
  if (a.plan == 1) return 0;
  return a.n_stage + (backward ? a.n_grad : 0) +
         train_per_path(a, backward) *
             static_cast<size_t>(train_stride(a, backward));
}

// The block's prologue for either plan: stage the prefix (shared plan),
// zero the gradient buffer G (backward) and carve this thread's arrays.
// Returns where the net and X_0 are read.  The caller synchronises.  The
// plan is a template parameter, so that in the shared plan's kernels every
// array is known to be in shared memory and read with shared-memory loads.
template <bool kBwd, bool kDevice>
__device__ __forceinline__ const float* train_setup(
    const TrainArgs& a, const float* __restrict__ P, float* S, float* ws,
    float* grad_out, TrainState& st, float** G) {
  const int tid = threadIdx.x;
  const float* W;
  float* col;
  if (!kDevice) {
    for (int i = tid; i < a.n_stage; i += a.tile) S[i] = P[i];
    W = S;
    *G = S + a.n_stage;
    col = *G + (kBwd ? a.n_grad : 0) + tid;
    st.ts = train_stride(a, kBwd);
  } else {
    W = P;
    *G = grad_out + static_cast<size_t>(blockIdx.x) * a.n_grad;
    col = ws + blockIdx.x * a.tile + tid;
    st.ts = a.ws_stride;
  }
  if (kBwd)
    for (int e = tid; e < a.n_grad; e += a.tile) (*G)[e] = 0.0f;

  const int ts = st.ts;
  const bool dense_update = a.drift_kind == 1 || a.sig_kind == 2;
  const int L = a.n_layers;
  st.X = col;
  col += a.dp * ts;
  st.Xn = st.X;   // forward, elementwise update: in place
  if (kBwd || dense_update) {
    st.Xn = col;
    col += a.dp * ts;
  }
  st.Zb = col;
  col += a.dp * ts;
  st.V = st.Zb;
  if (kBwd && dense_update) {
    st.V = col;
    col += a.dp * ts;
  }
  for (int l = 0; l + 1 < L; ++l) {
    st.H[l] = col;
    col += a.cols[l] * ts;
  }
  if (kBwd) {
    for (int l = 0; l + 1 < L; ++l) {
      st.D[l] = col;
      col += a.cols[l] * ts;
    }
    st.D[L - 1] = st.Zb;
  }
  return W;
}

// Z = net([t, X]) into st.Zb, the hidden activations kept in st.H.
__device__ __forceinline__ void train_net(const TrainArgs& a,
                                          const float* W,
                                          const TrainState& st, float t) {
  const float* in = st.X;
  for (int l = 0; l < a.n_layers; ++l) {
    const bool last = l == a.n_layers - 1;
    float* o = last ? st.Zb : st.H[l];
    dense(W + a.w_off[l], W + a.b_off[l], a.rows[l], a.cols[l], in, st.ts, o,
          !last, l == 0, t);
    in = o;
  }
}

// X' of the elementwise update, rounded as the plain version computes
// X + (b(X) + s c) dt + (s x) sqrt(dt) with b(X) = -X.  The X chain is
// written with explicit roundings so that the forward and the backward's
// replay (another instantiation) produce it bitwise alike.
__device__ __forceinline__ float euler_elementwise(float xo, float s, float c,
                                                   float x, float dt,
                                                   float sq_dt) {
  return __fadd_rn(
      __fadd_rn(xo, __fmul_rn(__fadd_rn(-xo, __fmul_rn(s, c)), dt)),
      __fmul_rn(__fmul_rn(s, x), sq_dt));
}

struct StepSums {
  float zc, zx, zz, ul;
};

// The training kernels' noise: host noise (N, K, d) or the Philox stream
// through a.rng.
struct TrainDraw {
  const TrainArgs& a;
  const float* __restrict__ noise;
  bool live;
  int k;
  __device__ __forceinline__ void operator()(int n, int g,
                                             float (&xi)[4]) const {
    if (a.host_noise) {
      const float* src = noise + (static_cast<size_t>(n) * a.K + k) * a.d;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        xi[q] = live && 4 * g + q < a.d ? src[4 * g + q] : 0.0f;
      return;
    }
    philox_normals4(static_cast<uint32_t>(k), static_cast<uint32_t>(n),
                    static_cast<uint32_t>(g), a.key0, a.key1, a.rng, xi);
  }
};

// Noise, the step's sums (forward), dZ into st.Zb (backward), and X'
// (elementwise update) or V = c dt + xi sqrt(dt) (dense update).
template <bool kBwd, class Draw>
__device__ __forceinline__ StepSums train_noise_pass(
    const TrainArgs& a, const float* __restrict__ P, const TrainState& st,
    int n, const Draw& draw, float gy, float gk) {
  const int ts = st.ts;
  const bool dense_update = a.drift_kind == 1 || a.sig_kind == 2;
  StepSums s = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int g = 0; 4 * g < a.d; ++g) {
    float xi[4];
    draw(n, g, xi);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = 4 * g + q;
      if (j >= a.d) break;
      const float x = a.noise_sign * xi[q];
      const float z = st.Zb[j * ts];
      const float c = a.adaptive ? -z : 0.0f;
      if (kBwd) {
        st.Zb[j * ts] =
            gy * ((-a.c_h * z + c) * a.dt + x * a.sq_dt) +
            gk * (z * a.dt - (a.kl_ito ? x * a.sq_dt : 0.0f));
      } else {
        s.zc = fmaf(z, c, s.zc);
        s.zx = fmaf(z, x, s.zx);
        s.zz = fmaf(z, z, s.zz);
        if (a.have_u) {
          const float e = z + P[a.u_off + static_cast<size_t>(n) * a.dp + j];
          s.ul = fmaf(e, e, s.ul);
        }
      }
      if (dense_update) {
        st.V[j * ts] = __fadd_rn(__fmul_rn(c, a.dt), __fmul_rn(x, a.sq_dt));
      } else {
        const float sg = a.sig_kind == 0 ? a.sig_scale : P[a.sig_off + j];
        st.Xn[j * ts] =
            euler_elementwise(st.X[j * ts], sg, c, x, a.dt, a.sq_dt);
      }
    }
  }
  return s;
}

// X' = X + b(X) dt + sigma V of the dense update; rows d..dp stay 0.
__device__ __forceinline__ void train_dense_update(const TrainArgs& a,
                                                   const float* __restrict__ P,
                                                   const TrainState& st) {
  const int ts = st.ts;
  for (int j0 = 0; j0 < a.dp; j0 += kChunk) {
    float bx[kChunk], sv[kChunk];
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      bx[c] = a.drift_kind == 1 ? 0.0f : -st.X[(j0 + c) * ts];
      sv[c] = 0.0f;
    }
    if (a.drift_kind == 1)
      matvec_chunk(P + a.a_off, a.d, a.dp, j0, st.X, ts, bx);
    if (a.sig_kind == 2) {
      matvec_chunk(P + a.sig_off, a.d, a.dp, j0, st.V, ts, sv);
    } else {
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const float s =
            a.sig_kind == 0 ? a.sig_scale : P[a.sig_off + j0 + c];
        sv[c] = __fmul_rn(s, st.V[(j0 + c) * ts]);
      }
    }
#pragma unroll
    for (int c = 0; c < kChunk; ++c)
      st.Xn[(j0 + c) * ts] = __fadd_rn(
          __fadd_rn(st.X[(j0 + c) * ts], __fmul_rn(bx[c], a.dt)), sv[c]);
  }
}

// The forward's accumulators of one step: f(X', t) = X'^T P X', h, and the
// Y, KL and u_L2 increments.
__device__ __forceinline__ void train_accumulate(const TrainArgs& a,
                                                 const float* __restrict__ P,
                                                 const TrainState& st,
                                                 const StepSums& s,
                                                 float& accY, float& accK,
                                                 float& accU) {
  const int ts = st.ts;
  float f = 0.0f;
  if (a.f_kind == 1) {
    for (int j0 = 0; j0 < a.dp; j0 += kChunk) {
      float px[kChunk] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      matvec_chunk(P + a.p_off, a.d, a.dp, j0, st.Xn, ts, px);
#pragma unroll
      for (int c = 0; c < kChunk; ++c)
        f = fmaf(st.Xn[(j0 + c) * ts], px[c], f);
    }
  }
  const float h = a.c_h * 0.5f * s.zz + a.f_coef * f;
  accY += (-h + s.zc) * a.dt + s.zx * a.sq_dt;
  if (a.accumulate_kl)
    accK += (0.5f * s.zz + f) * a.dt - (a.kl_ito ? s.zx * a.sq_dt : 0.0f);
  accU += s.ul * a.dt;
}

// -- the backward's weight-gradient products, on the tensor cores ----------

constexpr int kGradN = 4;   // n tiles (8 output columns each) of a unit

// One warp's unit of one layer's sums, G[r][j] += sum_{p < tile} A_r[p]
// D[j][p], for the 16 rows m0.. and the kGradN x 8 columns n0.. (fewer at
// the layer's last columns).  Row r of the left operand is row r - r0 of
// `in` for r0 <= r < rows, the constant t for r < r0 (layer 0's t row), 1
// for r = rows (the bias) and 0 past it, where G ends: nothing is stored
// there (a constant row still reads row 0 of `in`, so that no load is
// conditional).  `in` and `D` point at path 0 of [row][ts] arrays, each
// read as mma fragments (M: the gradient row, N: the output column, K: the
// paths); G (rows + 1, cols) is row-major.  The old G is loaded before the
// products so that its latency (device memory in the device plan) overlaps
// them, and the step's sum is added to it once.
template <bool kShared>
__device__ __forceinline__ void grad_tile_product(
    const float* in, int r0, int rows, float t, const float* D, int cols,
    int ts, int tile, float* G, int m0, int n0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  const int nq = min(kGradN, (cols - n0) >> 3);
  // the lane's rows m0 + g and m0 + g + 8 of A, and its kGradN rows of D
  const int ra = m0 + g, rb = ra + 8;
  const bool fa = ra >= r0 && ra < rows, fb = rb >= r0 && rb < rows;
  const PathRow<kShared> A0(in + (fa ? ra - r0 : 0) * ts + c);
  const PathRow<kShared> A1(in + (fb ? rb - r0 : 0) * ts + c);
  const float ca = ra < r0 ? t : (ra == rows ? 1.0f : 0.0f);
  const float cb = rb < r0 ? t : (rb == rows ? 1.0f : 0.0f);
  const PathRow<kShared> B(D + (n0 + g) * ts + c);
  float old[kGradN][4];
#pragma unroll
  for (int q = 0; q < kGradN; ++q) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = ra + 8 * h;
      const float* gp = G + r * cols + n0 + 8 * q + 2 * c;
      const bool in_g = q < nq && r <= rows;
      old[q][2 * h] = in_g ? gp[0] : 0.0f;
      old[q][2 * h + 1] = in_g ? gp[1] : 0.0f;
    }
  }
  // three accumulators per n tile (big big, big small, small big): three
  // independent mma chains
  float bb_[kGradN][4] = {}, bs_[kGradN][4] = {}, sb_[kGradN][4] = {};
#pragma unroll 2
  for (int k0 = 0; k0 < tile; k0 += 8) {
    const float a0 = A0[k0], a1 = A1[k0], a2 = A0[k0 + 4], a3 = A1[k0 + 4];
    uint32_t ab[4], as[4];
    tf32_split(fa ? a0 : ca, ab[0], as[0]);
    tf32_split(fb ? a1 : cb, ab[1], as[1]);
    tf32_split(fa ? a2 : ca, ab[2], as[2]);
    tf32_split(fb ? a3 : cb, ab[3], as[3]);
#pragma unroll
    for (int q = 0; q < kGradN; ++q) {
      if (q < nq) {
        uint32_t bb[2], bs[2];
        tf32_split(B[8 * q * ts + k0], bb[0], bs[0]);
        tf32_split(B[8 * q * ts + k0 + 4], bb[1], bs[1]);
        mma_tf32(bb_[q], ab, bb);
        mma_tf32(bs_[q], ab, bs);
        mma_tf32(sb_[q], as, bb);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < kGradN; ++q) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = ra + 8 * h;
      if (q < nq && r <= rows) {
        float* gp = G + r * cols + n0 + 8 * q + 2 * c;
#pragma unroll
        for (int e = 2 * h; e < 2 * h + 2; ++e)
          gp[e - 2 * h] =
              old[q][e] + ((sb_[q][e] + bs_[q][e]) + bb_[q][e]);
      }
    }
  }
}

// Every layer's weight-gradient sums of one step over the block's paths,
// G_l[0:rows+1, 0:cols] += [in_l; 1]^T Delta_l, in_l = [t, X] for l = 0
// and H_{l-1} after it, Delta_l = st.D[l]: each layer's units (16 rows by
// kGradN x 8 columns) are dealt to the block's warps in turn, and each runs
// grad_tile_product over the tile's paths.  The caller synchronises before
// (the D rows are other threads') and after.  Both memory plans run this
// code on their own pointers and strides, in the same order, so their sums
// are bitwise alike.
template <bool kDevice>
__device__ __forceinline__ void train_weight_grads(const TrainArgs& a,
                                                   const TrainState& st,
                                                   float* G, float t) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5, n_warps = a.tile >> 5;
  int u0 = 0;   // the units of the layers before this one
  for (int l = 0; l < a.n_layers; ++l) {
    const int rows = a.rows[l], cols = a.cols[l];
    const int n_groups = (cols + 8 * kGradN - 1) / (8 * kGradN);
    const int units = (rows + 16) / 16 * n_groups;
    const float* in = (l == 0 ? st.X : st.H[l - 1]) - tid;
    for (int u = ((warp - u0) % n_warps + n_warps) % n_warps; u < units;
         u += n_warps) {
      const int mt = u / n_groups;
      grad_tile_product<!kDevice>(in, l == 0 ? 1 : 0, rows, t,
                                  st.D[l] - tid, cols, st.ts, a.tile,
                                  G + a.g_off[l], 16 * mt,
                                  8 * kGradN * (u - mt * n_groups));
    }
    u0 += units;
  }
}

// TrainArgs from the wrapper's arrays and the seed; checks what the
// kernels index by, then selects the device.
inline int train_unpack(const int* iargs, const float* fargs,
                        unsigned long long seed, int device, TrainArgs* a) {
  memcpy(a, iargs, kTrainIntArgs * sizeof(int));
  memcpy(&a->dt, fargs, kTrainFloatArgs * sizeof(float));
  a->key0 = static_cast<uint32_t>(seed & 0xFFFFFFFFull);
  a->key1 = static_cast<uint32_t>(seed >> 32);
  if (a->tile <= 0 || a->tile > kMaxTile || a->tile % 32 != 0 ||
      a->n_layers < 1 || a->n_layers > kMaxLayers || a->K <= 0 ||
      a->plan < 0 || a->plan > 1 ||
      (a->plan == 1 && a->ws_stride < (a->K + a->tile - 1) / a->tile *
                                          a->tile))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaSetDevice(device));
}

}  // namespace pspde
