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
// What bounds them on an H100 (80GB HBM3 at 700 W; rates measured by
// chip_smoke.py phase 15): at the bench shape (d = 100, TanhMLP [101 -> 30
// -> 30 -> 100], N = 32, K = 131072) a forward path-step is ~13.9 kFLOP of
// net products, ~1.5 kFLOP of update and sums and d normals, with no
// device-memory traffic.  As three TF32 products each on the tensor cores
// (495 TFLOP/s dense) the products need >= 0.35 ms of the forward, against
// 0.87 ms as FP32 FMAs (67 TFLOP/s); the 4.2e8 normals need >= 0.81 ms at
// the card's measured 5.2e11 binom normals/s (Philox's integer
// multiplies).  The backward adds ~7.8 kFLOP of input-gradient products
// and ~14.2 kFLOP of weight-gradient products a path-step.  The design:
//   * the net's layers are products over the block's paths on the tensor
//     cores, the same code in both kernels (train_step.cuh: train_net): for
//     layer l, M = the paths, N = its padded output columns, K = its padded
//     input rows; mma.sync m16n8k8 TF32 with each operand split in two TF32
//     parts (3xTF32: float32 accuracy), layer 0's t row and the bias in
//     the accumulators' initial value, tanh in the epilogue; units of 16
//     paths by 4 n tiles dealt to the block's warps, a barrier after
//     each layer.  The A fragments come from the per-path [row][stride]
//     arrays (stride tile + 4: no bank conflicts), the B fragments from the
//     forward's net staged in fragment order (one conflict-free 8-byte load
//     a lane) or, in the backward and the device plan, from the row-major
//     net.  The backward's replay thus computes Z, and the X chain through
//     it, bitwise as the forward did;
//   * the forward's block runs tile x tpp threads (tile 64 x 4 in the
//     shared plan: 108,576 bytes, two blocks of 8 warps an SM where one
//     thread a path gave 4 warps; 64 x 2 in the device plan, the fastest
//     there): a path's noise and update are split over its tpp threads by
//     dimension groups, and its sums are kept in 4 classes of groups and
//     added in class order after the last step, so that every tpp and plan
//     gives the same bits, with no atomics.  No thread leaves early: paths
//     past K carry X_0 on their own noise and write nothing;
//   * the backward keeps one thread per path: its input gradients are
//     per-path FP32 FMA chains, its weight gradients a product over the
//     block's paths, G_l += [in_l; 1]^T Delta_l, on the tensor cores between
//     two barriers a step (train_step.cuh:train_weight_grads), 3xTF32 as
//     the net.  Its shared plan's block (182 KB at d = 100) leaves one block
//     of two warps per SM; __launch_bounds__(kMaxTile, 1) lets ptxas keep
//     its registers, and the forward's (kFwdThreads, 2) keeps it free of
//     spills at two blocks an SM;
//   * past d ~ 250 (TanhMLP (30, 30), N = 200) no tile's block fits the
//     227 KB of shared memory: the device plan (train_step.cuh) reads the
//     net from device memory, keeps each path's arrays in a [row][K]
//     workspace and the block's gradient row in grad_out, with the same
//     step code and the same products, whose fragment rows come through
//     L1 and L2.  At d = 1000 a forward path-step is ~137 kFLOP and moves
//     ~20 KB of per-path state through L2 and device memory.
//
// Noise: host noise (N, K, d), or Philox4x32-10 keyed by (seed, k, n, j / 4),
// the seed read from its device word by each thread at entry,
// through the erfinv map (counter word 3 = 0) or the binom map (b1 from
// word 3 = 0, b2 from word 3 = 1), times noise_sign.  The plain version
// (pspde_torch/rollout/kernels.py: reference_train_rollout) draws the same
// stream.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include "train_step.cuh"

namespace {

using namespace pspde;

// The forward: thread q * tile + p of the block works on path p (q < tpp).
// Every thread stays to the end, paths past K too (the products' barriers
// need the whole block): they carry X_0 on their own noise and write
// nothing.
template <bool kDevice>
__global__ void __launch_bounds__(kFwdThreads, 2)
train_forward_kernel(const TrainArgs a, const float* __restrict__ P,
                     const float* __restrict__ noise,
                     float* __restrict__ X_out, float* __restrict__ Y_out,
                     float* __restrict__ Zs_out, float* __restrict__ U_out,
                     float* ws) {
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
  const bool live = k < a.K;
  for (int j = q; j < a.dp; j += a.tpp) st.X[j * ts] = P[a.x0_off + j];
  __syncthreads();

  count_launch(a.launches);
  const uint2 key = train_seed(a);
  const TrainDraw draw{a, noise, live, k, key.x, key.y};
  FwdAcc acc = {};
  for (int n = 0; n < a.N; ++n)
    train_forward_step<!kDevice, !kDevice, true, kSumAll>(a, P, W, st, n,
                                                          draw, q, acc);

  float y, zs, u;
  train_path_sums(a, R, q, p, acc, y, zs, u);
  if (q == 0 && live) {
    Y_out[k] = y;
    Zs_out[k] = zs;
    U_out[k] = u;
  }
  // X (K, d): the block's paths are tile * d consecutive floats
  const int k0 = blockIdx.x * tile;
  const int n_out = min(tile, a.K - k0) * a.d;
  const float* X = st.X - p;
  float* dst = X_out + static_cast<size_t>(k0) * a.d;
  for (int e = threadIdx.x; e < n_out; e += blockDim.x) {
    const int pe = e / a.d;
    dst[e] = X[(e - pe * a.d) * ts + pe];
  }
}

// The backward: one thread per path.  It replays the forward from X_0 on
// the same noise, with the forward's own net (train_net) and update, so
// its X chain is bitwise the forward's, and at every step accumulates the
// parameter gradients of gY da + gKL dkl.  Paths past K carry zero
// cotangents and add nothing.
//
// At least one block per SM: ptxas may take up to 255 registers a thread.
// In the shared plan one block per SM is all its shared memory allows;
// in the device plan the registers bound the blocks per SM.
template <bool kDevice>
__global__ void __launch_bounds__(kMaxTile, 1)
train_backward_kernel(const TrainArgs a, const float* __restrict__ P,
                      const float* __restrict__ noise,
                      const float* __restrict__ gY,
                      const float* __restrict__ gKL,
                      float* __restrict__ grad_out, float* ws) {
  extern __shared__ float4 smem4[];
  float* S = reinterpret_cast<float*>(smem4);
  const int tile = a.tile;
  const int tid = threadIdx.x;
  const int k = blockIdx.x * tile + tid;
  const bool live = k < a.K;
  TrainState st;
  float *G, *R;
  const float* W = train_setup<true, kDevice>(a, P, S, ws, grad_out, st, &G,
                                             &R);
  __syncthreads();

  const int ts = st.ts;
  const int L = a.n_layers;
  for (int j = 0; j < a.dp; ++j) {
    st.X[j * ts] = W[a.x0_off + j];
    st.Xn[j * ts] = W[a.x0_off + j];
    st.V[j * ts] = 0.0f;   // rows d..dp of V are read (times 0) but not set
  }
  const float gy = live ? gY[k] : 0.0f;
  // without the KL sum, Z_sum is 0 and its cotangent reaches nothing
  const float gk = live && a.accumulate_kl ? gKL[k] : 0.0f;
  count_launch(a.launches);
  const uint2 key = train_seed(a);
  const TrainDraw draw{a, noise, live, k, key.x, key.y};
  const bool dense_update = a.drift_kind == 1 || a.sig_kind == 2;
  __syncthreads();   // X_0 of every path before the first products

  for (int n = 0; n < a.N; ++n) {
    const float t = static_cast<float>(n) * a.dt;
    train_net<!kDevice, false>(a, W, st, t);
    train_noise_pass<true>(a, P, st, n, draw, gy, gk, 0, 1);
    if (dense_update) train_dense_update(a, P, st, 0, 1);

    // delta_{l-1} = (W_l delta_l) (1 - H_{l-1}^2), W_l (rows, cols), for
    // kChunk rows at once (rows = the padded width before layer l): each
    // row's FMA chain sums in column order, the chunk's chains overlap
    for (int l = L - 1; l > 0; --l) {
      const float* Wl = W + a.w_off[l];
      const int cols = a.cols[l];
      const float* Dl = st.D[l];
      for (int i0 = 0; i0 < a.rows[l]; i0 += kChunk) {
        float s[kChunk] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
        for (int j0 = 0; j0 < cols; j0 += 4) {
          const float d0 = Dl[j0 * ts], d1 = Dl[(j0 + 1) * ts],
                      d2 = Dl[(j0 + 2) * ts], d3 = Dl[(j0 + 3) * ts];
#pragma unroll
          for (int c = 0; c < kChunk; ++c) {
            const float4 w = *reinterpret_cast<const float4*>(
                Wl + (i0 + c) * cols + j0);
            s[c] = fmaf(w.x, d0, s[c]);
            s[c] = fmaf(w.y, d1, s[c]);
            s[c] = fmaf(w.z, d2, s[c]);
            s[c] = fmaf(w.w, d3, s[c]);
          }
        }
#pragma unroll
        for (int c = 0; c < kChunk; ++c) {
          const float hv = st.H[l - 1][(i0 + c) * ts];
          st.D[l - 1][(i0 + c) * ts] = s[c] * (1.0f - hv * hv);
        }
      }
    }
    __syncthreads();

    // G_l += [in_l; 1]^T Delta_l over the tile's paths, on the tensor
    // cores; row 0 of layer 0 multiplies t
    train_weight_grads<kDevice>(a, st, G, t);
    __syncthreads();

    float* tmp = st.X;
    st.X = st.Xn;
    st.Xn = tmp;
  }

  if (!kDevice) {   // the device plan summed into its row directly
    float* dst = grad_out + static_cast<size_t>(blockIdx.x) * a.n_grad;
    for (int e = tid; e < a.n_grad; e += tile) dst[e] = G[e];
  }
}

template <bool kBwd, bool kDevice>
int launch_plan(const TrainArgs& a, const float* params, const float* noise,
                const float* gY, const float* gKL, float* X_out,
                float* Y_out, float* Zs_out, float* U_out, float* grad_out,
                float* ws, void* stream) {
  const size_t smem = sizeof(float) * train_smem_floats(a);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>((a.K + a.tile - 1) / a.tile);
  cudaError_t e;
  if (kBwd) {
    e = allow_dynamic_smem(
        reinterpret_cast<const void*>(train_backward_kernel<kDevice>), smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    train_backward_kernel<kDevice><<<grid, a.tile, smem, s>>>(
        a, params, noise, gY, gKL, grad_out, ws);
  } else {
    e = allow_dynamic_smem(
        reinterpret_cast<const void*>(train_forward_kernel<kDevice>), smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    train_forward_kernel<kDevice><<<grid, a.tile * a.tpp, smem, s>>>(
        a, params, noise, X_out, Y_out, Zs_out, U_out, ws);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool kBwd>
int launch(const TrainArgs& a, const float* params, const float* noise,
           const float* gY, const float* gKL, float* X_out, float* Y_out,
           float* Zs_out, float* U_out, float* grad_out, float* ws,
           void* stream) {
  return a.plan == 1
             ? launch_plan<kBwd, true>(a, params, noise, gY, gKL, X_out,
                                       Y_out, Zs_out, U_out, grad_out, ws,
                                       stream)
             : launch_plan<kBwd, false>(a, params, noise, gY, gKL, X_out,
                                        Y_out, Zs_out, U_out, grad_out, ws,
                                        stream);
}

}  // namespace

// Launch on `stream` of CUDA device `device`; each returns the cudaError_t
// of the launch (0 = success).  `iargs` and `fargs` are host arrays in the
// order of TrainArgs; `ws` is the device plan's workspace (null in the
// shared plan); `seed` is a device word (a 0-d int64 tensor) that the
// kernel reads when it runs, so that a captured CUDA graph replays with the
// seed written there before each replay; `launches` is the 64-bit device
// word that the kernel adds one to as it runs (count_launch; null: none).

// Forward: X_out (K, d), Y_out, Zs_out, U_out (K,).
extern "C" int pspde_train_rollout_fwd(const float* params,
                                       const float* host_noise, float* X_out,
                                       float* Y_out, float* Zs_out,
                                       float* U_out, float* ws,
                                       const int* iargs, const float* fargs,
                                       const unsigned long long* seed,
                                       unsigned long long* launches,
                                       int device, void* stream) {
  TrainArgs a;
  const int err = train_unpack(iargs, fargs, 0ull, device, &a);
  if (err != 0) return err;
  if (seed == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  a.seed = seed;
  a.launches = launches;
  // the double well's drift (drift_kind 2) runs in the serve kernel only
  if (a.backward || a.drift_kind == 2)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch<false>(a, params, host_noise, nullptr, nullptr, X_out, Y_out,
                       Zs_out, U_out, nullptr, ws, stream);
}

// Backward: gY, gKL (K,) -> grad_out (ceil(K / tile), n_grad), one row of
// per-layer [W (rows, cols); b (1, cols)] sums per block.
extern "C" int pspde_train_rollout_bwd(const float* params,
                                       const float* host_noise,
                                       const float* gY, const float* gKL,
                                       float* grad_out, float* ws,
                                       const int* iargs, const float* fargs,
                                       const unsigned long long* seed,
                                       unsigned long long* launches,
                                       int device, void* stream) {
  TrainArgs a;
  const int err = train_unpack(iargs, fargs, 0ull, device, &a);
  if (err != 0) return err;
  if (seed == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  a.seed = seed;
  a.launches = launches;
  if (!a.backward || a.drift_kind == 2)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch<true>(a, params, host_noise, gY, gKL, nullptr, nullptr,
                      nullptr, nullptr, grad_out, ws, stream);
}

// The forward's launch for `iargs`: out[0] blocks of the instantiation
// that one SM holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor,
// registers and shared memory both counted), out[1] threads a block, out[2]
// bytes of dynamic shared memory a block.
extern "C" int pspde_train_fwd_occupancy(const int* iargs,
                                         const float* fargs, int device,
                                         int* out) {
  TrainArgs a;
  const int err = train_unpack(iargs, fargs, 0ull, device, &a);
  if (err != 0) return err;
  // the double well's drift (drift_kind 2) runs in the serve kernel only
  if (a.backward || a.drift_kind == 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * train_smem_floats(a);
  const int threads = a.tile * a.tpp;
  cudaError_t e;
  if (a.plan == 1) {
    e = allow_dynamic_smem(
        reinterpret_cast<const void*>(train_forward_kernel<true>), smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &out[0], train_forward_kernel<true>, threads, smem);
  } else {
    e = allow_dynamic_smem(
        reinterpret_cast<const void*>(train_forward_kernel<false>), smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &out[0], train_forward_kernel<false>, threads, smem);
  }
  out[1] = threads;
  out[2] = static_cast<int>(smem);
  return static_cast<int>(e);
}
