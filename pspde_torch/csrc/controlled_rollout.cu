// Controlled Euler-Maruyama rollout for importance sampling, one kernel for
// all N steps.
//
// Replaces the Pallas TPU kernel pspde/rollout/kernels.py:
// fused_controlled_rollout (pallas_call at kernels.py:339).  Same outputs:
// the final state X (K, d) and the per-path integrals ito = int u.dW,
// riem = int |u|^2 dt and f_int = int f dt, laid out as one (K, d + 3)
// row-major array.  Per path and step, with u = -Z:
//
//   Z   = net([t_n, X])
//   X'  = X + (b(X) + sigma u) dt + sigma xi sqrt(dt)
//   ito += (u.xi) sqrt(dt),  riem += |u|^2 dt,  f_int += f(X', t_n) dt
//
// It is the HJB training forward's step with the adaptive update (c = -Z =
// u): the serve kernel runs train_step.cuh's own code, and only the sums
// differ (train_forward_step<..., kSumIS>: -Z.xi sqrt(dt), |Z|^2 dt and f dt
// into the three classed sums).
//
// What bounds it on an H100: at the serve shapes (d = 100, TanhMLP [101 ->
// 30 -> 30 -> 100], N = 100, K = 2^20) a path-step is ~13.9 kFLOP of the
// net's products, ~1 kFLOP of update and sums and d normals (Philox4x32-10
// and erfinvf), with no device-memory traffic but the final write: the
// net's products as three TF32 tensor-core products each (3xTF32) and the
// noise bound it.  The design (the forward's, train_rollout.cu):
//   * a block of tile x tpp threads, thread q * tile + p on path p: the
//     net's layers are products over the block's paths on the tensor cores
//     (train_net: mma.sync m16n8k8, each operand split into two TF32 parts,
//     float32 accuracy), the noise and update of a path split over its tpp
//     threads by dimension groups;
//   * __launch_bounds__(kFwdThreads, 2): 16 warps per SM at 64 x 4 in the
//     shared plan, where one thread a path gave 4;
//   * each path's sums kept in kSumClasses classes of dimension groups and
//     added in class order after the last step (train_path_sums), so that
//     every tpp and both memory plans give the same bits;
//   * the shared plan stages the net in mma fragment order beside the
//     paths' [row][tile + 4] arrays; the device plan (d ~ 250 and up,
//     where no block fits 227 KB) reads the net from device memory and
//     keeps the arrays in a [row][K] workspace, with the same step code;
//   * the block writes its rows of X and the sums with consecutive stores.
//
// Family (the wrapper raises a ValueError outside it): drift -x or A x;
// sigma scalar, diag or full; f zero or x^T P x evaluated at (X', t); or
// the double well's drift b_j = -4 kappa_j x_j (x_j^2 - 1) (drift_kind 2,
// 4 kappa at a_off) with sigma scalar and f zero, in the kDW
// instantiations, which only this kernel has (the training kernels and the
// ladder keep their code); a TanhMLP control with input [t, X];
// noise_sign +-1; host noise (N, K, d) or in-kernel Philox4x32-10 noise
// keyed by (seed, k, n, j / 4) through the erfinv map.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "train_step.cuh"

namespace {

using namespace pspde;

// Thread q * tile + p of the block works on path p (q < tpp).  Every thread
// stays to the end, paths past K too (the products' barriers need the whole
// block): they carry X_0 on their own noise and write nothing.
template <bool kDevice, bool kDW>
__global__ void __launch_bounds__(kFwdThreads, 2)
controlled_rollout_kernel(const TrainArgs a, const float* __restrict__ P,
                          const float* __restrict__ noise,
                          float* __restrict__ out, float* ws) {
  extern __shared__ float4 smem4[];
  float* S = reinterpret_cast<float*>(smem4);
  const int tile = a.tile;
  const int q = threadIdx.x / tile;
  TrainState st;
  float *G, *R;
  const float* W = train_setup<false, kDevice>(a, P, S, ws, nullptr, st, &G,
                                              &R);
  const int p = st.p, ts = st.ts;
  const int k = blockIdx.x * tile + p;
  for (int j = q; j < a.dp; j += a.tpp) st.X[j * ts] = P[a.x0_off + j];
  __syncthreads();

  const TrainDraw draw{a, noise, k < a.K, k, a.key0, a.key1};
  FwdAcc acc = {};
  for (int n = 0; n < a.N; ++n)
    train_forward_step<!kDevice, !kDevice, true, kSumIS, kDW>(a, P, W, st, n,
                                                              draw, q, acc);

  float ito, riem, fint;
  train_path_sums(a, R, q, p, acc, ito, riem, fint);
  __syncthreads();   // every thread has read the classes
  if (q == 0) {
    R[p] = ito;
    R[tile + p] = riem;
    R[2 * tile + p] = fint;
  }
  __syncthreads();
  // out (K, d + 3): the block's rows are tile * (d + 3) consecutive floats
  const int w = a.d + 3;
  const int k0 = blockIdx.x * tile;
  const int n_out = min(tile, a.K - k0) * w;
  const float* X = st.X - p;
  float* dst = out + static_cast<size_t>(k0) * w;
  for (int e = threadIdx.x; e < n_out; e += blockDim.x) {
    const int pe = e / w, j = e - pe * w;
    dst[e] = j < a.d ? X[j * ts + pe] : R[(j - a.d) * tile + pe];
  }
}

template <bool kDevice, bool kDW>
cudaError_t set_smem(size_t smem) {
  return cudaFuncSetAttribute(controlled_rollout_kernel<kDevice, kDW>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <bool kDevice, bool kDW>
cudaError_t launch(const TrainArgs& a, const float* params,
                   const float* host_noise, float* out, float* ws,
                   size_t smem, cudaStream_t s) {
  const cudaError_t e = set_smem<kDevice, kDW>(smem);
  if (e != cudaSuccess) return e;
  const unsigned grid = static_cast<unsigned>((a.K + a.tile - 1) / a.tile);
  controlled_rollout_kernel<kDevice, kDW><<<grid, a.tile * a.tpp, smem, s>>>(
      a, params, host_noise, out, ws);
  return cudaGetLastError();
}

template <bool kDevice, bool kDW>
cudaError_t occupancy(const TrainArgs& a, size_t smem, int* blocks) {
  const cudaError_t e = set_smem<kDevice, kDW>(smem);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, controlled_rollout_kernel<kDevice, kDW>, a.tile * a.tpp, smem);
}

}  // namespace

// Launch on `stream` of CUDA device `device`; returns the cudaError_t of
// the launch (0 = success).  `iargs` and `fargs` are host arrays in the
// order of TrainArgs (pspde_torch/rollout/kernels.py: _pack); `ws` is the
// device plan's workspace (null in the shared plan).
extern "C" int pspde_controlled_rollout(const float* params,
                                        const float* host_noise, float* out,
                                        float* ws, const int* iargs,
                                        const float* fargs,
                                        unsigned long long seed, int device,
                                        void* stream) {
  TrainArgs a;
  const int err = train_unpack(iargs, fargs, seed, device, &a);
  if (err != 0) return err;
  if (a.backward) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * train_smem_floats(a);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool dw = a.drift_kind == 2;
  cudaError_t e;
  if (a.plan == 1)
    e = dw ? launch<true, true>(a, params, host_noise, out, ws, smem, s)
           : launch<true, false>(a, params, host_noise, out, ws, smem, s);
  else
    e = dw ? launch<false, true>(a, params, host_noise, out, ws, smem, s)
           : launch<false, false>(a, params, host_noise, out, ws, smem, s);
  return static_cast<int>(e);
}

// The launch for `iargs`, as pspde_train_fwd_occupancy reports the
// forward's: out[0] blocks one SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), out[1] threads a block,
// out[2] bytes of dynamic shared memory a block.
extern "C" int pspde_serve_occupancy(const int* iargs, const float* fargs,
                                     int device, int* out) {
  TrainArgs a;
  const int err = train_unpack(iargs, fargs, 0ull, device, &a);
  if (err != 0) return err;
  if (a.backward) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * train_smem_floats(a);
  const bool dw = a.drift_kind == 2;
  cudaError_t e;
  if (a.plan == 1)
    e = dw ? occupancy<true, true>(a, smem, &out[0])
           : occupancy<true, false>(a, smem, &out[0]);
  else
    e = dw ? occupancy<false, true>(a, smem, &out[0])
           : occupancy<false, false>(a, smem, &out[0]);
  out[1] = a.tile * a.tpp;
  out[2] = static_cast<int>(smem);
  return static_cast<int>(e);
}

extern "C" const char* pspde_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
