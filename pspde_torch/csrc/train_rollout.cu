// Training rollout of the HJB solver: the forward kernel and its replay
// backward, each one launch for all N steps.
//
// Replaces the Pallas TPU kernels of pspde/rollout/kernels.py:
// make_fused_train_rollout, its forward _fwd (pallas_call at
// kernels.py:696) and its backward _bwd (pallas_call at kernels.py:788).
// Per path k and step n, with c = -sg(Z) when adaptive and 0 otherwise,
// h = c_h |Z|^2 / 2 + f_coef f and f(x) = 0 or x^T P x:
//
//   Z   = net([t_n, X])
//   X'  = X + (b(X) + sigma c) dt + sigma xi sqrt(dt)        (no gradient)
//   a   = (-h(t_n, X', Z) + Z.c) dt + (Z.xi) sqrt(dt)         Y     = sum a
//   kl  = (|Z|^2 / 2 + f(X', t_n)) dt - [kl_ito] (Z.xi) sqrt(dt)   Z_sum = sum kl
//   ul2 = |Z + u_tab[n]|^2 dt                                  u_l2  = sum ul2
//
// The forward writes X (K, d), Y, Z_sum and u_l2 (K,).  With the forward
// detached, Y and Z_sum depend on the net's parameters theta only through
// each step's Z, so the backward needs no reverse sweep: it replays the
// forward from X_0 on the same noise and accumulates
// sum_{k,n} (gY_k da/dZ + gKL_k dkl/dZ) dZ/dtheta, where in closed form
//
//   dZ = gY ((-c_h Z + c) dt + xi sqrt(dt)) + gKL (Z dt - [kl_ito] xi sqrt(dt))
//
// is backpropagated through the TanhMLP by hand.  Each block writes its
// parameter-gradient sums to one row of an (n_blocks, n_grad) array that
// the wrapper sums over blocks: deterministic, no atomics.
//
// What bounds it on an H100: at the bench shapes (d = 100, TanhMLP
// [101 -> 30 -> 30 -> 100], N = 32) a forward path-step is ~13.9 kFLOP of
// net plus d normals, and no device-memory traffic; the backward adds
// ~7.8 kFLOP of input-gradient products and ~14.2 kFLOP of weight-gradient
// outer products.  Both are FP32 FMA and shared-memory bound, as the serve
// kernel.  The design:
//   * one thread per path, one block per `tile` paths, for all N steps;
//   * the net and X_0 staged once per block in shared memory; the dense
//     coefficients (A^T, sigma^T, P^T) and the u_tab table are read from
//     device memory (they are the same for every thread, so L1 serves
//     them), which keeps the dense family inside one block's shared memory;
//   * each path's X, X', Z, hidden activations and (backward) their
//     cotangents live in shared memory as [row][tile + 1] arrays: a warp
//     reads 32 consecutive words when each thread walks its own path, and
//     32 different banks when 32 threads walk 32 rows of one path column
//     (the outer products);
//   * the backward has two barriers per step: after them every thread owns
//     the gradient entries e = tid + m tile of the block's buffer and adds
//     sum_p in_i[p] delta_j[p] over the tile's paths.
//
// Noise: host noise (N, K, d), or Philox4x32-10 keyed by (seed, k, n, j / 4)
// through the erfinv map (counter word 3 = 0) or the binom map (b1 from
// word 3 = 0, b2 from word 3 = 1), times noise_sign.  The plain version
// (pspde_torch/rollout/kernels.py: reference_train_rollout) draws the same
// stream.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include "common.cuh"

namespace {

using namespace pspde;

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
  float dt, sq_dt, noise_sign, sig_scale, c_h, f_coef;
  uint32_t key0, key1;
};
constexpr int kNumIntArgs = 22 + 5 * kMaxLayers;   // the ints before `dt`
constexpr int kNumFloatArgs = 6;
static_assert(offsetof(TrainArgs, dt) == kNumIntArgs * sizeof(int),
              "TrainArgs must start with kNumIntArgs ints, as the wrapper "
              "packs");

__device__ __forceinline__ void draw4(const TrainArgs& a,
                                      const float* __restrict__ noise,
                                      bool live, int k, int n, int g,
                                      float (&xi)[4]) {
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

// Shared memory of one block, in floats: the staged prefix, the gradient
// buffer (backward), and the per-path arrays of stride tile + 1.  The
// wrapper's _train_smem_bytes computes the same.
size_t smem_floats(const TrainArgs& a, bool backward) {
  const bool dense_update = a.drift_kind == 1 || a.sig_kind == 2;
  size_t hidden = 0;
  for (int l = 0; l + 1 < a.n_layers; ++l) hidden += a.cols[l];
  const size_t per_path =
      backward ? a.dp * (dense_update ? 4 : 3) + 2 * hidden
               : a.dp * (dense_update ? 3 : 2) + hidden;
  return a.n_stage + (backward ? a.n_grad : 0) +
         per_path * static_cast<size_t>(a.tile + 1);
}

template <bool kBwd>
__global__ void __launch_bounds__(kMaxTile)
train_rollout_kernel(const TrainArgs a, const float* __restrict__ P,
                     const float* __restrict__ noise,
                     const float* __restrict__ gY,
                     const float* __restrict__ gKL,
                     float* __restrict__ X_out, float* __restrict__ Y_out,
                     float* __restrict__ Zs_out, float* __restrict__ U_out,
                     float* __restrict__ grad_out) {
  extern __shared__ float4 smem4[];
  float* S = reinterpret_cast<float*>(smem4);
  const int tile = a.tile;
  const int ts = tile + 1;
  const int tid = threadIdx.x;
  const int k = blockIdx.x * tile + tid;
  const bool live = k < a.K;
  for (int i = tid; i < a.n_stage; i += tile) S[i] = P[i];
  float* G = S + a.n_stage;
  if (kBwd)
    for (int e = tid; e < a.n_grad; e += tile) G[e] = 0.0f;
  __syncthreads();
  // The forward has no barrier below; the backward keeps every thread of
  // the block (paths past K carry zero cotangents and add nothing).
  if (!kBwd && !live) return;

  const bool dense_update = a.drift_kind == 1 || a.sig_kind == 2;
  const int L = a.n_layers;
  float* col = G + (kBwd ? a.n_grad : 0) + tid;
  float* X = col;
  col += a.dp * ts;
  float* Xn = X;   // forward, elementwise update: in place
  if (kBwd || dense_update) {
    Xn = col;
    col += a.dp * ts;
  }
  float* Zb = col;   // Z, then (backward) its cotangent dZ
  col += a.dp * ts;
  float* V = Zb;     // c dt + xi sqrt(dt) of the dense update
  if (kBwd && dense_update) {
    V = col;
    col += a.dp * ts;
  }
  float* H[kMaxLayers];   // hidden activations
  float* D[kMaxLayers];   // their cotangents; D[L - 1] is dZ
  for (int l = 0; l + 1 < L; ++l) {
    H[l] = col;
    col += a.cols[l] * ts;
  }
  if (kBwd) {
    for (int l = 0; l + 1 < L; ++l) {
      D[l] = col;
      col += a.cols[l] * ts;
    }
    D[L - 1] = Zb;
  }

  for (int j = 0; j < a.dp; ++j) {
    X[j * ts] = S[a.x0_off + j];
    Xn[j * ts] = S[a.x0_off + j];
    V[j * ts] = 0.0f;   // rows d..dp of V are read (times 0) but not set
  }
  const float gy = kBwd && live ? gY[k] : 0.0f;
  // without the KL sum, Z_sum is 0 and its cotangent reaches nothing
  const float gk = kBwd && live && a.accumulate_kl ? gKL[k] : 0.0f;
  float accY = 0.0f, accK = 0.0f, accU = 0.0f;

  for (int n = 0; n < a.N; ++n) {
    const float t = static_cast<float>(n) * a.dt;

    // Z = net([t, X]), hidden activations kept for the backward
    const float* in = X;
    for (int l = 0; l < L; ++l) {
      const bool last = l == L - 1;
      float* o = last ? Zb : H[l];
      dense(S + a.w_off[l], S + a.b_off[l], a.rows[l], a.cols[l], in, ts, o,
            !last, l == 0, t);
      in = o;
    }

    // noise, the step's sums, dZ (backward), and X' (elementwise) or
    // V = c dt + xi sqrt(dt) for the dense update below
    float s_zc = 0.0f, s_zx = 0.0f, s_zz = 0.0f, s_ul = 0.0f;
    for (int g = 0; 4 * g < a.d; ++g) {
      float xi[4];
      draw4(a, noise, live, k, n, g, xi);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = 4 * g + q;
        if (j >= a.d) break;
        const float x = a.noise_sign * xi[q];
        const float z = Zb[j * ts];
        const float c = a.adaptive ? -z : 0.0f;
        if (kBwd) {
          Zb[j * ts] =
              gy * ((-a.c_h * z + c) * a.dt + x * a.sq_dt) +
              gk * (z * a.dt - (a.kl_ito ? x * a.sq_dt : 0.0f));
        } else {
          s_zc = fmaf(z, c, s_zc);
          s_zx = fmaf(z, x, s_zx);
          s_zz = fmaf(z, z, s_zz);
          if (a.have_u) {
            const float e =
                z + P[a.u_off + static_cast<size_t>(n) * a.dp + j];
            s_ul = fmaf(e, e, s_ul);
          }
        }
        if (dense_update) {
          V[j * ts] = c * a.dt + x * a.sq_dt;
        } else {
          const float s = a.sig_kind == 0 ? a.sig_scale : P[a.sig_off + j];
          const float xo = X[j * ts];
          Xn[j * ts] = (xo + (s * c - xo) * a.dt) + s * x * a.sq_dt;
        }
      }
    }

    if (dense_update) {
      // X' = X + b(X) dt + sigma V; rows d..dp stay 0
      for (int j0 = 0; j0 < a.dp; j0 += kChunk) {
        float bx[kChunk], sv[kChunk];
#pragma unroll
        for (int c = 0; c < kChunk; ++c) {
          bx[c] = a.drift_kind == 1 ? 0.0f : -X[(j0 + c) * ts];
          sv[c] = 0.0f;
        }
        if (a.drift_kind == 1)
          matvec_chunk(P + a.a_off, a.d, a.dp, j0, X, ts, bx);
        if (a.sig_kind == 2) {
          matvec_chunk(P + a.sig_off, a.d, a.dp, j0, V, ts, sv);
        } else {
#pragma unroll
          for (int c = 0; c < kChunk; ++c) {
            const float s =
                a.sig_kind == 0 ? a.sig_scale : P[a.sig_off + j0 + c];
            sv[c] = s * V[(j0 + c) * ts];
          }
        }
#pragma unroll
        for (int c = 0; c < kChunk; ++c)
          Xn[(j0 + c) * ts] = X[(j0 + c) * ts] + bx[c] * a.dt + sv[c];
      }
    }

    if (!kBwd) {
      float f = 0.0f;   // f(X', t) = X'^T P X'
      if (a.f_kind == 1) {
        for (int j0 = 0; j0 < a.dp; j0 += kChunk) {
          float px[kChunk] = {0.0f, 0.0f, 0.0f, 0.0f,
                              0.0f, 0.0f, 0.0f, 0.0f};
          matvec_chunk(P + a.p_off, a.d, a.dp, j0, Xn, ts, px);
#pragma unroll
          for (int c = 0; c < kChunk; ++c)
            f = fmaf(Xn[(j0 + c) * ts], px[c], f);
        }
      }
      const float h = a.c_h * 0.5f * s_zz + a.f_coef * f;
      accY += (-h + s_zc) * a.dt + s_zx * a.sq_dt;
      if (a.accumulate_kl)
        accK += (0.5f * s_zz + f) * a.dt - (a.kl_ito ? s_zx * a.sq_dt : 0.0f);
      accU += s_ul * a.dt;
    } else {
      // delta_{l-1} = (W_l delta_l) (1 - H_{l-1}^2), W_l (rows, cols)
      for (int l = L - 1; l > 0; --l) {
        const float* W = S + a.w_off[l];
        const int cols = a.cols[l];
        for (int i = 0; i < a.rows[l]; ++i) {
          float s = 0.0f;
          for (int j0 = 0; j0 < cols; j0 += 4) {
            const float4 w = *reinterpret_cast<const float4*>(W + i * cols +
                                                              j0);
            s = fmaf(w.x, D[l][j0 * ts], s);
            s = fmaf(w.y, D[l][(j0 + 1) * ts], s);
            s = fmaf(w.z, D[l][(j0 + 2) * ts], s);
            s = fmaf(w.w, D[l][(j0 + 3) * ts], s);
          }
          const float hv = H[l - 1][i * ts];
          D[l - 1][i * ts] = s * (1.0f - hv * hv);
        }
      }
      __syncthreads();

      // G_l[i][j] += sum_p in_i[p] delta_j[p] over the tile's paths; row
      // `rows` of G_l is the bias, and row 0 of layer 0 multiplies t
      for (int l = 0; l < L; ++l) {
        const float* inb = (l == 0 ? X : H[l - 1]) - tid;
        const float* db = D[l] - tid;
        const int rows = a.rows[l], cols = a.cols[l];
        float* Gl = G + a.g_off[l];
        for (int e = tid; e < (rows + 1) * cols; e += tile) {
          const int i = e / cols;
          const int j = e - i * cols;
          const float* dj = db + j * ts;
          float s = 0.0f;
          if (i == rows || (l == 0 && i == 0)) {
            for (int p = 0; p < tile; ++p) s += dj[p];
            if (i != rows) s *= t;
          } else {
            const float* ai = inb + (l == 0 ? i - 1 : i) * ts;
            for (int p = 0; p < tile; ++p) s = fmaf(ai[p], dj[p], s);
          }
          Gl[e] += s;
        }
      }
      __syncthreads();
    }

    float* tmp = X;
    X = Xn;
    Xn = tmp;
  }

  if (kBwd) {
    float* dst = grad_out + static_cast<size_t>(blockIdx.x) * a.n_grad;
    for (int e = tid; e < a.n_grad; e += tile) dst[e] = G[e];
  } else {
    float* dst = X_out + static_cast<size_t>(k) * a.d;
    for (int j = 0; j < a.d; ++j) dst[j] = X[j * ts];
    Y_out[k] = accY;
    Zs_out[k] = accK;
    U_out[k] = accU;
  }
}

int unpack(const int* iargs, const float* fargs, unsigned long long seed,
           int device, TrainArgs* a) {
  memcpy(a, iargs, kNumIntArgs * sizeof(int));
  memcpy(&a->dt, fargs, kNumFloatArgs * sizeof(float));
  a->key0 = static_cast<uint32_t>(seed & 0xFFFFFFFFull);
  a->key1 = static_cast<uint32_t>(seed >> 32);
  if (a->tile <= 0 || a->tile > kMaxTile || a->tile % 32 != 0 ||
      a->n_layers < 1 || a->n_layers > kMaxLayers || a->K <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaSetDevice(device));
}

template <bool kBwd>
int launch(const TrainArgs& a, const float* params, const float* noise,
           const float* gY, const float* gKL, float* X_out, float* Y_out,
           float* Zs_out, float* U_out, float* grad_out, void* stream) {
  const size_t smem = sizeof(float) * smem_floats(a, kBwd);
  cudaError_t e = cudaFuncSetAttribute(
      train_rollout_kernel<kBwd>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned grid = static_cast<unsigned>((a.K + a.tile - 1) / a.tile);
  train_rollout_kernel<kBwd><<<grid, a.tile, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      a, params, noise, gY, gKL, X_out, Y_out, Zs_out, U_out, grad_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream` of CUDA device `device`; each returns the cudaError_t
// of the launch (0 = success).  `iargs` and `fargs` are host arrays in the
// order of TrainArgs.

// Forward: X_out (K, d), Y_out, Zs_out, U_out (K,).
extern "C" int pspde_train_rollout_fwd(const float* params,
                                       const float* host_noise, float* X_out,
                                       float* Y_out, float* Zs_out,
                                       float* U_out, const int* iargs,
                                       const float* fargs,
                                       unsigned long long seed, int device,
                                       void* stream) {
  TrainArgs a;
  const int err = unpack(iargs, fargs, seed, device, &a);
  if (err != 0) return err;
  return launch<false>(a, params, host_noise, nullptr, nullptr, X_out, Y_out,
                       Zs_out, U_out, nullptr, stream);
}

// Backward: gY, gKL (K,) -> grad_out (ceil(K / tile), n_grad), one row of
// per-layer [W (rows, cols); b (1, cols)] sums per block.
extern "C" int pspde_train_rollout_bwd(const float* params,
                                       const float* host_noise,
                                       const float* gY, const float* gKL,
                                       float* grad_out, const int* iargs,
                                       const float* fargs,
                                       unsigned long long seed, int device,
                                       void* stream) {
  TrainArgs a;
  const int err = unpack(iargs, fargs, seed, device, &a);
  if (err != 0) return err;
  return launch<true>(a, params, host_noise, gY, gKL, nullptr, nullptr,
                      nullptr, nullptr, grad_out, stream);
}
