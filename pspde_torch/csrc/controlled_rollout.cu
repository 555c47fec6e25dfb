// Controlled Euler-Maruyama rollout for importance sampling, one kernel for
// all N steps.
//
// Replaces the Pallas TPU kernel pspde/rollout/kernels.py:
// fused_controlled_rollout (pallas_call at kernels.py:339).  Same outputs:
// the final state X (K, d) and the per-path integrals ito = int u.dW,
// riem = int |u|^2 dt and f_int = int f dt, laid out as one (K, d + 3)
// row-major array.
//
// What bounds it on an H100: at the serve shapes (d = 100, TanhMLP
// [101 -> 30 -> 30 -> 100], N = 100) every path-step costs about 13.9 kFLOP
// of control net plus d normals (Philox4x32-10 and erfinvf), and no device
// memory traffic at all: FP32 FMA and RNG work bound it.  The design keeps
// all state on chip:
//   * one block owns `tile` paths (one thread per path) for all N steps;
//   * the net's weights, X_0 and the dense constants (A^T, sigma^T, P^T)
//     are staged once per block in shared memory (dynamic, above 48 KB);
//   * each path's state X, the control u and the hidden activations live
//     in shared memory as [row][tile] arrays, so a warp reads 32
//     consecutive words (no bank conflicts) while the weights of a row
//     chunk are read as float4 broadcasts;
//   * products are plain FP32 FMA loops over chunks of kChunk outputs held
//     in registers (widths are zero-padded to kChunk on the host).
// The only device-memory traffic is the host noise (test mode) and the
// final write.  Occupancy is bounded by the ~1.1 KB of per-path state in
// shared memory; that is the first thing to change when making it fast.
// At wide d the staged buffer and the per-path state fit no tile's block
// (d = 1000, TanhMLP (30, 30): 532 KB at tile 32).  The device plan then
// reads the buffer from device memory (the same words for every thread:
// L1 and L2 serve them) and keeps each path's arrays in a workspace of
// device memory laid out [row][ws_stride], ws_stride the grid's paths, so
// that a warp still reads 32 consecutive words; the step code is the same.
//
// Family (the wrapper raises a ValueError outside it): drift -x or A x;
// sigma scalar, diag or full; f zero or x^T P x evaluated at (X_new, t);
// a TanhMLP control with input [t, X]; noise_sign +-1; host noise (N, K, d)
// or in-kernel Philox4x32-10 noise keyed by (seed, k, n, j / 4).

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include "common.cuh"

namespace {

using namespace pspde;

// Layout of the integer and float argument arrays the wrapper passes
// (pspde_torch/rollout/kernels.py: _pack).
struct Args {
  int K, N, d, dp, n_layers, hmax, tile;
  int drift_kind;   // 0: b(x) = -x, 1: b(x) = A x (A^T at a_off)
  int a_off;
  int sig_kind;     // 0: scalar (sig_scale), 1: diag (at sig_off), 2: full
  int sig_off;
  int f_kind;       // 0: f = 0, 1: f = x^T P x (P^T at p_off)
  int p_off, x0_off, n_params, host_noise;
  int rows[kMaxLayers], cols[kMaxLayers], w_off[kMaxLayers],
      b_off[kMaxLayers];
  int plan;         // 0: shared (all staged), 1: device (workspace)
  int ws_stride;    // device plan: the row stride of the workspace
  float dt, sq_dt, noise_sign, sig_scale;
  uint32_t key0, key1;
};
constexpr int kNumIntArgs = 18 + 4 * kMaxLayers;   // the ints before `dt`
static_assert(offsetof(Args, dt) == kNumIntArgs * sizeof(int),
              "Args must start with kNumIntArgs ints, as the wrapper packs");

// kDevice: the plan, a template parameter so that the shared plan's arrays
// are known to be in shared memory (shared-memory loads)
template <bool kDevice>
__global__ void __launch_bounds__(kMaxTile)
controlled_rollout_kernel(const Args a, const float* __restrict__ params,
                          const float* __restrict__ noise,
                          float* __restrict__ out, float* ws) {
  extern __shared__ float4 smem4[];
  float* S = reinterpret_cast<float*>(smem4);
  const int tile = a.tile;
  const int tid = threadIdx.x;
  const int k = blockIdx.x * tile + tid;
  // where the buffer is read, this thread's first array and the row stride
  const float* W;
  float* col;
  int ts;
  if (!kDevice) {
    for (int i = tid; i < a.n_params; i += tile) S[i] = params[i];
    W = S;
    col = S + a.n_params + tid;
    ts = tile;
  } else {
    W = params;
    col = ws + k;
    ts = a.ws_stride;
  }
  __syncthreads();
  if (k >= a.K) return;   // no barrier below: each thread owns its column

  const bool dense_update = a.drift_kind == 1 || a.sig_kind == 2;
  float* X = col;
  col += a.dp * ts;
  float* Xn = X;
  if (dense_update) {
    Xn = col;
    col += a.dp * ts;
  }
  float* U = col;
  col += a.dp * ts;
  float* H[2] = {col, col + a.hmax * ts};

  for (int j = 0; j < a.dp; ++j) X[j * ts] = W[a.x0_off + j];
  float ito = 0.0f, riem = 0.0f, fint = 0.0f;

  for (int n = 0; n < a.N; ++n) {
    const float t = static_cast<float>(n) * a.dt;

    // control u = -net([t, X]); the host negated the last layer
    const float* in = X;
    for (int l = 0; l < a.n_layers; ++l) {
      const bool last = l == a.n_layers - 1;
      float* o = last ? U : H[l & 1];
      dense(W + a.w_off[l], W + a.b_off[l], a.rows[l], a.cols[l], in, ts,
            o, !last, l == 0, t);
      in = o;
    }

    // noise, Girsanov sums, and either the elementwise update in place or
    // v = u dt + xi sqrt(dt) for the dense update below
    float s_ux = 0.0f, s_uu = 0.0f;
    for (int g = 0; 4 * g < a.d; ++g) {
      float xi[4];
      if (a.host_noise) {
        const float* src = noise + (static_cast<size_t>(n) * a.K + k) * a.d;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          xi[q] = 4 * g + q < a.d ? src[4 * g + q] : 0.0f;
      } else {
        const uint4 r = philox4x32_10(
            make_uint4(static_cast<uint32_t>(k), static_cast<uint32_t>(n),
                       static_cast<uint32_t>(g), 0u),
            a.key0, a.key1);
        xi[0] = normal_from_bits(r.x);
        xi[1] = normal_from_bits(r.y);
        xi[2] = normal_from_bits(r.z);
        xi[3] = normal_from_bits(r.w);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = 4 * g + q;
        if (j >= a.d) break;
        const float x = a.noise_sign * xi[q];
        const float u = U[j * ts];
        s_ux = fmaf(u, x, s_ux);
        s_uu = fmaf(u, u, s_uu);
        if (dense_update) {
          U[j * ts] = u * a.dt + x * a.sq_dt;
        } else {
          const float s = a.sig_kind == 0 ? a.sig_scale : W[a.sig_off + j];
          const float xo = X[j * ts];
          X[j * ts] = (xo + (s * u - xo) * a.dt) + s * x * a.sq_dt;
        }
      }
    }
    ito += s_ux * a.sq_dt;
    riem += s_uu * a.dt;

    if (dense_update) {
      // X_new = X + b(X) dt + sigma v, rows d..dp stay 0
      for (int j0 = 0; j0 < a.dp; j0 += kChunk) {
        float bx[kChunk], sv[kChunk];
#pragma unroll
        for (int c = 0; c < kChunk; ++c) {
          bx[c] = a.drift_kind == 1 ? 0.0f : -X[(j0 + c) * ts];
          sv[c] = 0.0f;
        }
        if (a.drift_kind == 1)
          matvec_chunk(W + a.a_off, a.d, a.dp, j0, X, ts, bx);
        if (a.sig_kind == 2) {
          matvec_chunk(W + a.sig_off, a.d, a.dp, j0, U, ts, sv);
        } else {
#pragma unroll
          for (int c = 0; c < kChunk; ++c) {
            const float s =
                a.sig_kind == 0 ? a.sig_scale : W[a.sig_off + j0 + c];
            sv[c] = s * U[(j0 + c) * ts];
          }
        }
#pragma unroll
        for (int c = 0; c < kChunk; ++c)
          Xn[(j0 + c) * ts] = X[(j0 + c) * ts] + bx[c] * a.dt + sv[c];
      }
      float* tmp = X;
      X = Xn;
      Xn = tmp;
    }

    if (a.f_kind == 1) {   // f(X_new, t) = X_new^T P X_new
      float f = 0.0f;
      for (int j0 = 0; j0 < a.dp; j0 += kChunk) {
        float px[kChunk] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
        matvec_chunk(W + a.p_off, a.d, a.dp, j0, X, ts, px);
#pragma unroll
        for (int c = 0; c < kChunk; ++c) f = fmaf(X[(j0 + c) * ts], px[c], f);
      }
      fint += f * a.dt;
    }
  }

  float* dst = out + static_cast<size_t>(k) * (a.d + 3);
  for (int j = 0; j < a.d; ++j) dst[j] = X[j * ts];
  dst[a.d] = ito;
  dst[a.d + 1] = riem;
  dst[a.d + 2] = fint;
}

}  // namespace

// Launch on `stream` of CUDA device `device`; returns the cudaError_t of
// the launch (0 = success).  `iargs` and `fargs` are host arrays in the
// order of Args; `ws` is the device plan's workspace (null in the shared
// plan).
extern "C" int pspde_controlled_rollout(const float* params,
                                        const float* host_noise, float* out,
                                        float* ws, const int* iargs,
                                        const float* fargs,
                                        unsigned long long seed, int device,
                                        void* stream) {
  Args a;
  memcpy(&a, iargs, kNumIntArgs * sizeof(int));
  a.dt = fargs[0];
  a.sq_dt = fargs[1];
  a.noise_sign = fargs[2];
  a.sig_scale = fargs[3];
  a.key0 = static_cast<uint32_t>(seed & 0xFFFFFFFFull);
  a.key1 = static_cast<uint32_t>(seed >> 32);
  if (a.tile <= 0 || a.tile > kMaxTile || a.n_layers < 1 ||
      a.n_layers > kMaxLayers || a.K <= 0 || a.plan < 0 || a.plan > 1 ||
      (a.plan == 1 && a.ws_stride < (a.K + a.tile - 1) / a.tile * a.tile))
    return static_cast<int>(cudaErrorInvalidValue);

  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const bool dense_update = a.drift_kind == 1 || a.sig_kind == 2;
  const size_t per_path = static_cast<size_t>(a.dp) * (dense_update ? 3 : 2)
                          + 2 * static_cast<size_t>(a.hmax);
  const size_t smem =
      a.plan == 1 ? 0 : sizeof(float) * (a.n_params + per_path * a.tile);
  auto kernel = a.plan == 1 ? controlled_rollout_kernel<true>
                            : controlled_rollout_kernel<false>;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned grid = static_cast<unsigned>((a.K + a.tile - 1) / a.tile);
  kernel<<<grid, a.tile, smem, static_cast<cudaStream_t>(stream)>>>(
      a, params, host_noise, out, ws);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pspde_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
