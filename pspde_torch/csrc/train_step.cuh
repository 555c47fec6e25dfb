// The per-step device code of the HJB training forward, shared by the
// training kernels (train_rollout.cu), the serve kernel
// (controlled_rollout.cu: the same step with the importance-sampling sums)
// and the roofline's ablation ladder (roofline.cu), so that the ladder's
// stages execute the forward's own instructions.
//
// Two memory plans, chosen by the wrapper (pspde_torch/rollout/kernels.py:
// _choose_plan) and recorded in TrainArgs::plan:
//   * shared (0): the net is copied to shared memory once per block (the
//     backward stages the packed buffer's prefix, the net and X_0 as laid
//     out; the forward stages the net in mma fragment order,
//     train_stage_net); each path's arrays are [row][stride] in shared
//     memory after it (and after the backward's gradient buffer), stride =
//     train_stride;
//   * device (1): for widths whose block fits no tile (d ~ 250 and up) the
//     net and X_0 are read from device memory (the same for every thread:
//     L1 and the 50 MB L2 serve them), each path's arrays live in a
//     workspace of device memory laid out [row][ws_stride] with
//     ws_stride = the grid's paths, so a warp reads 32 consecutive words,
//     and the backward's gradient row is the block's row of grad_out.
// Both plans run the same step code below: the arrays are reached through
// a pointer and a stride (`ts`), and both plans' products sum in the same
// order, so that their results are bitwise alike.
//
// The forward's block runs tile x tpp threads: thread q * tile + p works on
// path p (so a warp walks 32 consecutive paths of one row); the net's
// products are the block's (train_net), the noise and the update of path p
// are split over its tpp threads by dimension groups, and the path's sums
// are kept in kSumClasses classes, whichever thread owns a class, and
// combined once, after the last step, in class order (train_path_sums):
// every tpp gives the same bits.  The backward runs one thread per path.

#pragma once

#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include "common.cuh"

namespace pspde {

constexpr int kFwdThreads = 256;   // the forward's block at most: tile x tpp
                                   // (kernels.py _FWD_THREADS)
// The forward's sums of a path are kept apart in classes: class r holds the
// terms of the dimension groups g = r mod kSumClasses (dimensions 4g ..
// 4g + 3) and of the row chunks j0 / kChunk = r mod kSumClasses.  Thread q
// of a path's tpp (a divisor of kSumClasses) owns the classes q, q + tpp, ...
constexpr int kSumClasses = 4;

// Layout of the integer and float argument arrays the wrapper passes
// (pspde_torch/rollout/kernels.py: _pack_train).
struct TrainArgs {
  int K, N, d, dp, n_layers, tile;
  int drift_kind;   // 0: b(x) = -x, 1: b(x) = A x (A^T at a_off), 2: the
                    // double well's b_j = -4 kappa_j x_j (x_j^2 - 1) (4
                    // kappa at a_off; the serve kernel's kDW instantiations
                    // only)
  int a_off;
  int sig_kind;     // 0: scalar (sig_scale), 1: diag (at sig_off), 2: full
  int sig_off;
  int f_kind;       // 0: f not needed, 1: f = x^T P x (P^T at p_off)
  int p_off, x0_off;
  int n_stage;      // the backward's staged prefix: the net and X_0
  int u_off, have_u, host_noise;
  int adaptive, accumulate_kl, kl_ito;
  int rng;          // 0: erfinv, 1: binom
  int n_grad;       // floats of one block's gradient buffer
  int rows[kMaxLayers], cols[kMaxLayers], w_off[kMaxLayers],
      b_off[kMaxLayers], g_off[kMaxLayers];
  int backward;     // 0: the forward's (and the ladder's) launch, 1: the
                    // backward's
  int tpp;          // threads per path (1 in the backward)
  int plan;         // 0: shared, 1: device
  int ws_stride;    // device plan: the row stride of the workspace
  float dt, sq_dt, noise_sign, sig_scale, c_h, f_coef;
  uint32_t key0, key1;   // the serve's and the ladder's seed, by value
  // The training kernels' seed: a device word that each thread reads once
  // at entry (train_seed), so that a captured CUDA graph reads the value of
  // each replay; null in the serve's and the ladder's launches.
  const unsigned long long* seed;
  // The training kernels' launch count (count_launch); null in the serve's
  // and the ladder's launches.
  unsigned long long* launches;
};
constexpr int kTrainIntArgs = 26 + 5 * kMaxLayers;   // the ints before `dt`
constexpr int kTrainFloatArgs = 6;
static_assert(offsetof(TrainArgs, dt) == kTrainIntArgs * sizeof(int),
              "TrainArgs must start with kTrainIntArgs ints, as the wrapper "
              "packs");

// One thread's per-path arrays: X, X' (X itself for the forward's
// elementwise update), Z (the backward's dZ), V = c dt + xi sqrt(dt) of the
// dense update (Z's rows in the forward), the hidden activations H and
// (backward) their cotangents D, each row `ts` floats after the last; `p`
// is the thread's path in the block, so `X - p` is the block's path 0.
struct TrainState {
  float* X;
  float* Xn;
  float* Zb;
  float* V;
  float* H[kMaxLayers];
  float* D[kMaxLayers];
  int ts, p;
};

// Per-path floats of one block's arrays; the wrapper's _pack_train counts
// the same.
__host__ __device__ inline size_t train_per_path(const TrainArgs& a) {
  const bool dense_update = a.drift_kind == 1 || a.sig_kind == 2;
  size_t hidden = 0;
  for (int l = 0; l + 1 < a.n_layers; ++l) hidden += a.cols[l];
  return a.backward ? a.dp * (dense_update ? 4 : 3) + 2 * hidden
                    : a.dp * (dense_update ? 3 : 2) + hidden;
}

// The row stride of the shared plan's per-path arrays.  The mma fragments
// of both kernels' products read element (g, c) of an 8 x 4 block of rows
// and paths at bank (c stride + g) mod 32: tile + 4 (a multiple of 32 plus
// 4) puts them on 32 different banks, and the epilogue's stores of rows
// 2c, 2c + 1 too.
__host__ __device__ inline int train_stride(const TrainArgs& a) {
  return a.tile + 4;
}

// The k rows of layer l's product: layer 0 multiplies X's dp rows (its t
// row goes into the accumulators' initial value, train_net), layer l > 0
// the previous layer's padded width.
__host__ __device__ inline int train_k_rows(const TrainArgs& a, int l) {
  return l == 0 ? a.dp : a.rows[l];
}

// The forward's staged net (train_stage_net): layer 0's t row, each
// layer's bias, then each layer's weights in mma fragment order.
__host__ __device__ inline size_t train_fwd_net_floats(const TrainArgs& a) {
  size_t n = a.cols[0];
  for (int l = 0; l < a.n_layers; ++l)
    n += a.cols[l] + static_cast<size_t>(train_k_rows(a, l)) * a.cols[l];
  return n;
}

// The forward's exchange of per-path sums (train_path_sums): three sums of
// each class of each path.
__host__ __device__ inline size_t train_fwd_sums_floats(const TrainArgs& a) {
  return static_cast<size_t>(kSumClasses) * 3 * a.tile;
}

// Dynamic shared memory of one block, in floats.  Backward: the staged
// prefix, the gradient buffer and the per-path arrays in the shared plan,
// none in the device plan.  Forward: the staged net and the per-path
// arrays in the shared plan, and the exchange of sums in both.  The
// wrapper's _train_smem_bytes computes the same.
inline size_t train_smem_floats(const TrainArgs& a) {
  const size_t arrays = train_per_path(a) *
                        static_cast<size_t>(train_stride(a));
  if (a.backward) return a.plan == 1 ? 0 : a.n_stage + a.n_grad + arrays;
  const size_t sums = train_fwd_sums_floats(a);
  return a.plan == 1 ? sums : train_fwd_net_floats(a) + arrays + sums;
}

// The forward's net in shared memory, from the packed net in P: layer 0's
// t row (W_0 row 0) at S[0], the biases after it, then for each layer l its
// weights B_l (k rows train_k_rows by cols: W_0 rows 1..d and zeros to dp,
// or W_l) as mma B fragments: the fragment of k block kb and n tile nt is
// 32 float2, lane 4g + c holding (B[8kb + c][8nt + g], B[8kb + c + 4][8nt +
// g]), at float2 (kb * cols / 8 + nt) * 32 + lane.  A warp then reads one
// fragment with one 8-byte load per lane, free of bank conflicts.
__device__ __forceinline__ void train_stage_net(const TrainArgs& a,
                                                const float* __restrict__ P,
                                                float* S) {
  const int tid = threadIdx.x, nthr = blockDim.x;
  for (int i = tid; i < a.cols[0]; i += nthr) S[i] = P[a.w_off[0] + i];
  int o = a.cols[0];
  for (int l = 0; l < a.n_layers; ++l) {
    for (int i = tid; i < a.cols[l]; i += nthr) S[o + i] = P[a.b_off[l] + i];
    o += a.cols[l];
  }
  for (int l = 0; l < a.n_layers; ++l) {
    const int cols = a.cols[l], nt_count = cols >> 3;
    const int r0 = l == 0 ? 1 : 0;
    const int n = train_k_rows(a, l) * cols;
    for (int e = tid; e < n; e += nthr) {
      const int h = e & 1, lane = (e >> 1) & 31, blk = e >> 6;
      const int kb = blk / nt_count, nt = blk - kb * nt_count;
      const int row = 8 * kb + (lane & 3) + 4 * h + r0;
      S[o + e] = row < a.rows[l]
                     ? P[a.w_off[l] + row * cols + 8 * nt + (lane >> 2)]
                     : 0.0f;
    }
    o += n;
  }
}

// The block's prologue for either plan: stage the net (shared plan), zero
// the gradient buffer G (backward) and carve this thread's arrays (path p
// = threadIdx.x mod tile) and the forward's exchange of sums (*R).
// Returns where the net is read: the staged prefix or the staged fragments
// (shared plan) or P (device plan).  The caller synchronises.  The plan is
// a template parameter, so that in the shared plan's kernels every array is
// known to be in shared memory and read with shared-memory loads.
template <bool kBwd, bool kDevice>
__device__ __forceinline__ const float* train_setup(
    const TrainArgs& a, const float* __restrict__ P, float* S, float* ws,
    float* grad_out, TrainState& st, float** G, float** R) {
  const int tid = threadIdx.x, nthr = blockDim.x;
  st.p = tid % a.tile;
  const float* W;
  float* col;
  if (!kDevice) {
    st.ts = train_stride(a);
    if (kBwd) {
      for (int i = tid; i < a.n_stage; i += nthr) S[i] = P[i];
      *G = S + a.n_stage;
      col = *G + a.n_grad;
    } else {
      train_stage_net(a, P, S);
      col = S + train_fwd_net_floats(a);
    }
    W = S;
    *R = col + train_per_path(a) * static_cast<size_t>(st.ts);
    col += st.p;
  } else {
    W = P;
    *G = grad_out + static_cast<size_t>(blockIdx.x) * a.n_grad;
    *R = S;
    col = ws + blockIdx.x * a.tile + st.p;
    st.ts = a.ws_stride;
  }
  if (kBwd)
    for (int e = tid; e < a.n_grad; e += nthr) (*G)[e] = 0.0f;

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

// -- the net's products, on the tensor cores ---------------------------------

// A float stored to a row of the block's per-path arrays; in shared memory
// (kShared) with st.shared, as PathRow<true> reads.
template <bool kShared>
__device__ __forceinline__ void path_store(float* p, float v) {
  if (kShared) {
    asm volatile("st.shared.f32 [%0], %1;"
                 :
                 : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))),
                   "f"(v)
                 : "memory");
  } else {
    *p = v;
  }
}

// B fragments of the forward's staged net (train_stage_net).
struct NetFragB {
  uint32_t s;      // shared-window address of this lane's float2 of (0, 0)
  int nt_count;    // n tiles of the layer
  __device__ __forceinline__ NetFragB(const float* frag, int cols)
      : s(static_cast<uint32_t>(__cvta_generic_to_shared(frag)) +
          8 * (threadIdx.x & 31)),
        nt_count(cols >> 3) {}
  __device__ __forceinline__ void operator()(int kb, int nt, float& b0,
                                             float& b1) const {
    asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];"
                 : "=f"(b0), "=f"(b1)
                 : "r"(s + 256 * (kb * nt_count + nt))
                 : "memory");
  }
};

// B fragments read from the layer's row-major weights as packed, W (rows,
// cols): the backward's staged prefix (kShared) or the packed net in device
// memory.  k row k is W row k + r0 (layer 0 skips its t row) while k <
// k_valid, and 0 past it (layer 0's rows d..dp).
template <bool kShared>
struct NetRowB {
  PathRow<kShared> w;   // at W row r0 + c, column g
  int cols, k_valid, c;
  __device__ __forceinline__ NetRowB(const float* W, int r0, int cols_,
                                     int k_valid_)
      : w(W + (r0 + (threadIdx.x & 3)) * cols_ + ((threadIdx.x & 31) >> 2)),
        cols(cols_), k_valid(k_valid_), c(threadIdx.x & 3) {}
  __device__ __forceinline__ void operator()(int kb, int nt, float& b0,
                                             float& b1) const {
    const int k = 8 * kb + c;
    // a row past k_valid reads row 0 (k_valid >= 1), so no load is
    // conditional
    const float v0 = w[(k < k_valid ? 8 * kb : -c) * cols + 8 * nt];
    const float v1 = w[(k + 4 < k_valid ? 8 * kb + 4 : -c) * cols + 8 * nt];
    b0 = k < k_valid ? v0 : 0.0f;
    b1 = k + 4 < k_valid ? v1 : 0.0f;
  }
};

// One warp's unit of one layer, out[j][m] = act(init[j] + sum_{i < k_rows}
// in[i][m] B[i][j]) for the 16 paths m0.. and the kN n tiles nt0.. (8
// output columns each): `in` and `out` point at path 0 of
// [row][ts] arrays, read and written as mma fragments (M: the paths, N: the
// output columns, K: the input rows); init[j] = fmaf(t, trow[j], bias[j])
// for layer 0 (its t row) and bias[j] after it.  Three accumulators (big
// big, big small, small big: 3xTF32) per n tile, the init in the first,
// summed as (sb + bs) + bb; each k block's three products in that order.
// The fragments of k block kb + 1 are loaded before kb's products, so that
// their latency overlaps them.  How many n tiles a unit takes does not
// change any output's arithmetic.
template <int kN, bool kShared, class BRead>
__device__ __forceinline__ void net_tile_product(
    const float* in, int k_rows, const BRead& B, const float* trow, float t,
    const float* bias, float* out, bool act, int ts, int m0, int nt0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  const PathRow<kShared> A(in + c * ts + m0 + g);
  float bb_[kN][4], bs_[kN][4] = {}, sb_[kN][4] = {};
#pragma unroll
  for (int q = 0; q < kN; ++q) {
    const int j = 8 * (nt0 + q) + 2 * c;
    const float i0 = trow ? fmaf(t, trow[j], bias[j]) : bias[j];
    const float i1 = trow ? fmaf(t, trow[j + 1], bias[j + 1]) : bias[j + 1];
    bb_[q][0] = i0;
    bb_[q][1] = i1;
    bb_[q][2] = i0;
    bb_[q][3] = i1;
  }
  const int ts4 = 4 * ts, n_kb = k_rows >> 3;
  float a[4], b[kN][2];
  auto load = [&](int kb) {
    const int r = 8 * kb * ts;
    a[0] = A[r];
    a[1] = A[r + 8];
    a[2] = A[r + ts4];
    a[3] = A[r + ts4 + 8];
#pragma unroll
    for (int q = 0; q < kN; ++q) B(kb, nt0 + q, b[q][0], b[q][1]);
  };
  load(0);
  for (int kb = 0; kb < n_kb; ++kb) {
    uint32_t ab[4], as[4], bb[kN][2], bs[kN][2];
#pragma unroll
    for (int e = 0; e < 4; ++e) tf32_split(a[e], ab[e], as[e]);
#pragma unroll
    for (int q = 0; q < kN; ++q) {
      tf32_split(b[q][0], bb[q][0], bs[q][0]);
      tf32_split(b[q][1], bb[q][1], bs[q][1]);
    }
    load(min(kb + 1, n_kb - 1));
#pragma unroll
    for (int q = 0; q < kN; ++q) {
      mma_tf32(bb_[q], ab, bb[q]);
      mma_tf32(bs_[q], ab, bs[q]);
      mma_tf32(sb_[q], as, bb[q]);
    }
  }
#pragma unroll
  for (int q = 0; q < kN; ++q) {
    float* o = out + (8 * (nt0 + q) + 2 * c) * ts + m0 + g;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float v = (sb_[q][e] + bs_[q][e]) + bb_[q][e];
      path_store<kShared>(o + (e & 1) * ts + (e >> 1) * 8,
                          act ? tanhf(v) : v);
    }
  }
}

// The units of one layer (16 paths by kUnitTiles n tiles each; the
// layer's last nt_count mod kUnitTiles n tiles one a unit), dealt to the
// block's warps in turn from warp 0.  No branch inside a unit's products.
// Units of 4 n tiles: units of 2, which would give each of the forward's 8
// warps a unit of a 32-column layer, measured no faster there and slower
// elsewhere.
constexpr int kUnitTiles = 4;
template <bool kShared, class BRead>
__device__ __forceinline__ void net_layer(const float* in, int k_rows,
                                          const BRead& B, const float* trow,
                                          float t, const float* bias,
                                          float* out, bool act, int ts,
                                          int tile, int nt_count) {
  const int warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  const int full = nt_count / kUnitTiles;
  const int groups = full + nt_count - full * kUnitTiles;
  for (int u = warp; u < (tile >> 4) * groups; u += n_warps) {
    const int mt = u / groups, gi = u - mt * groups;
    if (gi < full)
      net_tile_product<kUnitTiles, kShared>(in, k_rows, B, trow, t, bias,
                                            out, act, ts, 16 * mt,
                                            gi * kUnitTiles);
    else
      net_tile_product<1, kShared>(in, k_rows, B, trow, t, bias, out, act,
                                   ts, 16 * mt,
                                   full * kUnitTiles + gi - full);
  }
}

// Z = net([t, X]) into st.Zb, the hidden activations kept in st.H, for
// every path of the block, a barrier after each layer (net_layer).  The
// caller synchronises before (X's rows are other threads').  B fragments:
// the staged fragments (kFrag: the forward's shared plan, where they
// measured ~10% faster on an H100 than the row-major net) or the row-major
// net at W.  Every plan and kernel sums each output in the same order, so that
// the forward and the backward's replay compute Z, and through it the X
// chain, bitwise alike.
template <bool kShared, bool kFrag>
__device__ __forceinline__ void train_net(const TrainArgs& a,
                                          const float* W,
                                          const TrainState& st, float t) {
  const float* in = st.X - st.p;
  int io = a.cols[0];   // the staged biases
  int fo = io;          // the staged fragments
  for (int l = 0; l < a.n_layers; ++l) fo += a.cols[l];
  for (int l = 0; l < a.n_layers; ++l) {
    const bool last = l == a.n_layers - 1;
    float* out = (last ? st.Zb : st.H[l]) - st.p;
    const int cols = a.cols[l], nt_count = cols >> 3;
    const int k_rows = train_k_rows(a, l);
    const float* trow =
        l == 0 ? (kFrag ? W : W + a.w_off[0]) : static_cast<const float*>(
                                                    nullptr);
    const float* bias = kFrag ? W + io : W + a.b_off[l];
    if (kFrag) {
      const NetFragB B(W + fo, cols);
      net_layer<kShared>(in, k_rows, B, trow, t, bias, out, !last, st.ts,
                         a.tile, nt_count);
    } else {
      const NetRowB<kShared> B(W + a.w_off[l], l == 0 ? 1 : 0, cols,
                               l == 0 ? a.d : k_rows);
      net_layer<kShared>(in, k_rows, B, trow, t, bias, out, !last, st.ts,
                         a.tile, nt_count);
    }
    __syncthreads();
    io += cols;
    fo += k_rows * cols;
    in = out;
  }
}

// -- the noise, the update and the sums -----------------------------------

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

// X' of the elementwise update under the double well's drift, rounded as
// the plain version computes X + (b(X) + s c) dt + (s x) sqrt(dt) with
// b(X) = -(4 kappa X)(X^2 - 1); c4 = 4 kappa_j.
__device__ __forceinline__ float euler_double_well(float xo, float c4,
                                                   float s, float c, float x,
                                                   float dt, float sq_dt) {
  const float b =
      -__fmul_rn(__fmul_rn(c4, xo), __fadd_rn(__fmul_rn(xo, xo), -1.0f));
  return __fadd_rn(
      __fadd_rn(xo, __fmul_rn(__fadd_rn(b, __fmul_rn(s, c)), dt)),
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
  uint32_t key0, key1;   // the Philox key: the seed's low and high words
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
                    static_cast<uint32_t>(g), key0, key1, a.rng, xi);
  }
};

// The training kernels' Philox key, read from the seed's device word.
__device__ __forceinline__ uint2 train_seed(const TrainArgs& a) {
  const unsigned long long s = __ldg(a.seed);
  return make_uint2(static_cast<uint32_t>(s & 0xFFFFFFFFull),
                    static_cast<uint32_t>(s >> 32));
}

// Noise, the step's sums (forward), dZ into st.Zb (backward), and X'
// (elementwise update: b(x) = -x, or the double well's with kDW) or V = c dt
// + xi sqrt(dt) (dense update), for the dimension groups g0, g0 + g_step,
// ... of this thread's path.
template <bool kBwd, bool kDW = false, class Draw>
__device__ __forceinline__ StepSums train_noise_pass(
    const TrainArgs& a, const float* __restrict__ P, const TrainState& st,
    int n, const Draw& draw, float gy, float gk, int g0, int g_step) {
  const int ts = st.ts;
  const bool dense_update = a.drift_kind == 1 || a.sig_kind == 2;
  StepSums s = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int g = g0; 4 * g < a.d; g += g_step) {
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
        if (kDW)
          st.Xn[j * ts] = euler_double_well(st.X[j * ts], P[a.a_off + j], sg,
                                            c, x, a.dt, a.sq_dt);
        else
          st.Xn[j * ts] =
              euler_elementwise(st.X[j * ts], sg, c, x, a.dt, a.sq_dt);
      }
    }
  }
  return s;
}

// X' = X + b(X) dt + sigma V of the dense update, for the row chunks c0,
// c0 + c_step, ... (kChunk rows each); rows d..dp stay 0.  Each row's sums
// run in the same order whichever thread computes it.
__device__ __forceinline__ void train_dense_update(const TrainArgs& a,
                                                   const float* __restrict__ P,
                                                   const TrainState& st,
                                                   int c0, int c_step) {
  const int ts = st.ts;
  for (int j0 = kChunk * c0; j0 < a.dp; j0 += kChunk * c_step) {
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

// A thread's share of the forward's accumulators, by class slot (slot i
// holds class q + i tpp): Y, Z_sum and u_L2 (the serve's ito, riem and
// f_int) are sums over steps of terms linear in the step's sums, so each
// class sums its own terms over the steps, and train_path_sums adds the
// classes once at the end.
struct FwdAcc {
  float y[kSumClasses], k[kSumClasses], u[kSumClasses];
};

// f(X', t) = X'^T P X' over the row chunks of class r (0 where f is not
// needed).
__device__ __forceinline__ float train_f_class(const TrainArgs& a,
                                               const float* __restrict__ P,
                                               const TrainState& st, int r) {
  const int ts = st.ts;
  float f = 0.0f;
  if (a.f_kind == 1) {
    for (int j0 = kChunk * r; j0 < a.dp; j0 += kChunk * kSumClasses) {
      float px[kChunk] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      matvec_chunk(P + a.p_off, a.d, a.dp, j0, st.Xn, ts, px);
#pragma unroll
      for (int c = 0; c < kChunk; ++c)
        f = fmaf(st.Xn[(j0 + c) * ts], px[c], f);
    }
  }
  return f;
}

// f of class r, h, and the class's Y, KL and u_L2 increments of one step,
// into slot i.
__device__ __forceinline__ void train_accumulate(const TrainArgs& a,
                                                 const float* __restrict__ P,
                                                 const TrainState& st,
                                                 const StepSums& s, int r,
                                                 FwdAcc& acc, int i) {
  const float f = train_f_class(a, P, st, r);
  const float h = a.c_h * 0.5f * s.zz + a.f_coef * f;
  acc.y[i] += (-h + s.zc) * a.dt + s.zx * a.sq_dt;
  if (a.accumulate_kl)
    acc.k[i] += (0.5f * s.zz + f) * a.dt - (a.kl_ito ? s.zx * a.sq_dt : 0.0f);
  acc.u[i] += s.ul * a.dt;
}

// The serve's importance-sampling sums of class r (controlled_rollout.cu;
// with adaptive on, the update's control is u = -Z): ito = sum u.xi
// sqrt(dt) = -sum Z.xi sqrt(dt), riem = sum |Z|^2 dt and f_int = sum f(X',
// t) dt, unscaled, into slot i of the accumulators' three classed sums.
__device__ __forceinline__ void serve_accumulate(const TrainArgs& a,
                                                 const float* __restrict__ P,
                                                 const TrainState& st,
                                                 const StepSums& s, int r,
                                                 FwdAcc& acc, int i) {
  acc.y[i] += -s.zx * a.sq_dt;
  acc.k[i] += s.zz * a.dt;
  acc.u[i] += train_f_class(a, P, st, r) * a.dt;
}

enum StepSum { kSumNone = 0, kSumZx, kSumAll, kSumIS };

// One step of the forward for thread q of its path (net, noise, update
// and the sums into acc: all of them, kSumAll, as the forward; the serve's
// ito, riem and f_int, kSumIS; Z.xi alone, kSumZx, as the ladder's net
// stage; none), as the forward kernel, the serve kernel and the ladder's
// stages run it.  kNet false (the ladder's euler stage) leaves Z as it is;
// kDW takes the double well's drift (drift_kind 2, the serve's kDW
// instantiations).  The caller has synchronised since X was last written;
// the step ends with a barrier, X' in st.X.
template <bool kShared, bool kFrag, bool kNet, int kSum, bool kDW = false,
          class Draw>
__device__ __forceinline__ void train_forward_step(
    const TrainArgs& a, const float* __restrict__ P, const float* W,
    TrainState& st, int n, const Draw& draw, int q, FwdAcc& acc) {
  const bool dense_update = a.drift_kind == 1 || a.sig_kind == 2;
  const int slots = kSumClasses / a.tpp;
  if (kNet) train_net<kShared, kFrag>(a, W, st, static_cast<float>(n) * a.dt);
  StepSums s[kSumClasses];
#pragma unroll 1
  for (int i = 0; i < slots; ++i)
    s[i] = train_noise_pass<false, kDW>(a, P, st, n, draw, 0.0f, 0.0f,
                                        q + i * a.tpp, kSumClasses);
  if (dense_update) {
    __syncthreads();   // V's rows are the path's other threads'
    train_dense_update(a, P, st, q, a.tpp);
  }
  if (kSum == kSumAll || kSum == kSumIS) {
    if (a.f_kind == 1) __syncthreads();   // X' likewise
#pragma unroll 1
    for (int i = 0; i < slots; ++i) {
      if (kSum == kSumAll)
        train_accumulate(a, P, st, s[i], q + i * a.tpp, acc, i);
      else
        serve_accumulate(a, P, st, s[i], q + i * a.tpp, acc, i);
    }
  } else if (kSum == kSumZx) {
#pragma unroll 1
    for (int i = 0; i < slots; ++i) acc.y[i] += s[i].zx;
  }
  float* tmp = st.X;
  st.X = st.Xn;
  st.Xn = tmp;
  __syncthreads();
}

// Each path's three sums over its classes, in class order, into y, k, u of
// thread 0 (q = 0) of the path.  R holds the exchange
// (train_fwd_sums_floats).  Every thread of the block calls it (it
// synchronises).
__device__ __forceinline__ void train_path_sums(const TrainArgs& a, float* R,
                                                int q, int p,
                                                const FwdAcc& acc, float& y,
                                                float& k, float& u) {
  for (int i = 0; i < kSumClasses / a.tpp; ++i) {
    float* r = R + (q + i * a.tpp) * 3 * a.tile + p;
    r[0] = acc.y[i];
    r[a.tile] = acc.k[i];
    r[2 * a.tile] = acc.u[i];
  }
  __syncthreads();
  y = R[p];
  k = R[a.tile + p];
  u = R[2 * a.tile + p];
  for (int c = 1; c < kSumClasses; ++c) {
    const float* r = R + c * 3 * a.tile + p;
    y += r[0];
    k += r[a.tile];
    u += r[2 * a.tile];
  }
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

// TrainArgs from the wrapper's arrays and the by-value seed (the serve's
// and the ladder's; the training entries set TrainArgs::seed after it);
// checks what the kernels index by, then selects the device.
inline int train_unpack(const int* iargs, const float* fargs,
                        unsigned long long seed, int device, TrainArgs* a) {
  memcpy(a, iargs, kTrainIntArgs * sizeof(int));
  memcpy(&a->dt, fargs, kTrainFloatArgs * sizeof(float));
  a->key0 = static_cast<uint32_t>(seed & 0xFFFFFFFFull);
  a->key1 = static_cast<uint32_t>(seed >> 32);
  a->seed = nullptr;
  a->launches = nullptr;
  if (a->tile <= 0 || a->tile > kMaxTile || a->tile % 32 != 0 ||
      a->n_layers < 1 || a->n_layers > kMaxLayers || a->K <= 0 ||
      a->drift_kind < 0 || a->drift_kind > 2 ||
      a->plan < 0 || a->plan > 1 || a->backward < 0 || a->backward > 1 ||
      a->tpp < 1 || kSumClasses % a->tpp != 0 ||
      (a->backward && a->tpp != 1) ||
      a->tile * a->tpp > kFwdThreads ||
      (a->plan == 1 && a->ws_stride < (a->K + a->tile - 1) / a->tile *
                                          a->tile))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaSetDevice(device));
}

}  // namespace pspde
