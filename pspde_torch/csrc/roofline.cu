// The roofline kernels of the training step: the sustained FP32 FMA rate,
// the in-kernel normals rate, and the ablation ladder of the training
// forward.
//
// Replaces the Pallas TPU kernels of pspde/utils/roofline.py:
// vpu_fma_rate (pallas_call at roofline.py:112), prng_normals_rate
// (roofline.py:138) and fused_ablation_rates (roofline.py:327).  The
// wrappers and plain versions are in pspde_torch/utils/roofline.py.
//
// fma_chain: one thread per element of the (d, tile) carry; each element
//   runs P passes of `chain` dependent x <- fmaf(x, x, c_j), the quadratic
//   map in its bounded chaotic regime (c_j ~ -1.75, |x| <= 1.92).  The
//   c_j come from the kernel's parameters, so each link is one FFMA with a
//   constant-bank operand and the loop adds no other FP32 instruction.  P
//   is a runtime argument: nothing folds.  What bounds it: the FP32 pipes
//   (128 lanes per SM); 16 warps per SM hide the 4-cycle FMA latency.
// normals_sum: acc[k] = sum_{p < P} sum_{j < d} xi(seed, k, p, j), the
//   normals of pspde_torch.rollout.kernels.train_normals (Philox4x32-10 at
//   counter (k, p, j / 4), erfinv or binom map: common.cuh, the very device
//   functions of the training kernels).  A block of 32 x 32 threads owns 32
//   columns; thread (x, y) draws the (pass, group) pairs y, y + 32, ... of
//   column x, and the block sums them in shared memory, so that 4096
//   columns still fill the card.  What bounds it: Philox's 32-bit integer
//   multiplies (IMAD / IMAD.HI, half the FP32 instruction rate) and the map
//   (erfinvf: ~30 FP32 instructions with a log on the SFU; binom: two
//   Philox blocks per four draws, a popcount, 4 FP32 instructions).
// ablation: the training forward's step, stage by stage (the JAX ladder:
//   noise, euler, net, full, full_nonoise, full_rawbits, full_binom), from
//   X_0 = 0.1 with one output acc + sum_j X_j per path.  The stages run the
//   per-step code of train_step.cuh (train_forward_step: the net's
//   tensor-core products, the noise and update split over a path's
//   threads; `full` is the forward's own step on the erfinv stream, without
//   u_L2 or KL) and launch with the forward's block (tile x threads per
//   path), memory plan and dynamic shared memory, so that they differ in
//   work only and the deltas between stages attribute its time.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include "train_step.cuh"

namespace {

using namespace pspde;

// -- fma_chain ---------------------------------------------------------------

constexpr int kMaxChain = 16;

struct ChainConsts {
  float c[kMaxChain];
};

template <int kChain>
__global__ void __launch_bounds__(256)
fma_chain_kernel(float* __restrict__ x, int n, int P, const ChainConsts cc) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float v = x[i];
#pragma unroll 4
  for (int p = 0; p < P; ++p) {
#pragma unroll
    for (int j = 0; j < kChain; ++j) v = fmaf(v, v, cc.c[j]);
  }
  x[i] = v;
}

// -- normals_sum -------------------------------------------------------------

constexpr int kCols = 32;    // columns of one block (threadIdx.x)
constexpr int kSlices = 32;  // threads per column (threadIdx.y)

__global__ void __launch_bounds__(kCols * kSlices)
normals_sum_kernel(float* __restrict__ acc, int tile, int d, int P, int rng,
                   uint32_t key0, uint32_t key1) {
  __shared__ float part[kSlices][kCols + 1];
  const int k = blockIdx.x * kCols + threadIdx.x;
  const int G = (d + 3) / 4;
  // walk the pairs q = y + m kSlices of q = p G + g, p < P, g < G
  const int dp = kSlices / G, dg = kSlices % G;
  int p = threadIdx.y / G, g = threadIdx.y % G;
  float s = 0.0f;
  if (k < tile) {
    while (p < P) {
      float xi[4];
      philox_normals4(static_cast<uint32_t>(k), static_cast<uint32_t>(p),
                      static_cast<uint32_t>(g), key0, key1, rng, xi);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (4 * g + q < d) s += xi[q];
      p += dp;
      g += dg;
      if (g >= G) {
        g -= G;
        ++p;
      }
    }
  }
  part[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && k < tile) {
    float t = 0.0f;
    for (int y = 0; y < kSlices; ++y) t += part[y][threadIdx.x];
    acc[k] = t;
  }
}

// -- ablation ----------------------------------------------------------------

enum Stage {
  kNoise = 0,
  kEuler,
  kNet,
  kFull,
  kFullNoNoise,
  kFullRawBits,
  kFullBinom,
  kNumStages
};

// xi of the erfinv (rng 0) or binom (rng 1) stream, as the training kernels
// draw it
struct MapDraw {
  uint32_t key0, key1;
  int k, rng;
  __device__ __forceinline__ void operator()(int n, int g,
                                             float (&xi)[4]) const {
    philox_normals4(static_cast<uint32_t>(k), static_cast<uint32_t>(n),
                    static_cast<uint32_t>(g), key0, key1, rng, xi);
  }
};

// the Philox bits without a map: (bits >> 9 | 1.0f) - 1.5 in [-0.5, 0.5)
struct RawBitsDraw {
  uint32_t key0, key1;
  int k;
  __device__ __forceinline__ void operator()(int n, int g,
                                             float (&xi)[4]) const {
    const uint4 r = philox4x32_10(
        make_uint4(static_cast<uint32_t>(k), static_cast<uint32_t>(n),
                   static_cast<uint32_t>(g), 0u),
        key0, key1);
    xi[0] = __uint_as_float((r.x >> 9) | 0x3F800000u) - 1.5f;
    xi[1] = __uint_as_float((r.y >> 9) | 0x3F800000u) - 1.5f;
    xi[2] = __uint_as_float((r.z >> 9) | 0x3F800000u) - 1.5f;
    xi[3] = __uint_as_float((r.w >> 9) | 0x3F800000u) - 1.5f;
  }
};

// no generation: a step-dependent constant 0.01 (1 + 1e-6 n)
struct ConstDraw {
  __device__ __forceinline__ void operator()(int n, int,
                                             float (&xi)[4]) const {
    const float v = 0.01f * (1.0f + 1e-6f * static_cast<float>(n));
    xi[0] = v;
    xi[1] = v;
    xi[2] = v;
    xi[3] = v;
  }
};

// One stage for this thread's classes of its path (thread q of tpp):
// acc + sum_j X_j after N steps from X_0 = 0.1, per class of dimension
// groups (train_step.cuh: kSumClasses), in acc.y; train_path_sums adds the
// classes.  Every stage but `noise` runs the forward's step
// (train_forward_step) and its barriers.
template <int kStage, bool kShared, class Draw>
__device__ __forceinline__ void ablation_path(const TrainArgs& a,
                                              const float* __restrict__ P,
                                              const float* W, TrainState& st,
                                              const Draw& draw, int q,
                                              FwdAcc& acc) {
  const int ts = st.ts, slots = kSumClasses / a.tpp;
  for (int j = q; j < a.dp; j += a.tpp) {
    const float x0 = j < a.d ? 0.1f : 0.0f;
    st.X[j * ts] = x0;
    st.Xn[j * ts] = x0;
  }
  __syncthreads();
  for (int n = 0; n < a.N; ++n) {
    if (kStage == kNoise) {
#pragma unroll 1
      for (int i = 0; i < slots; ++i) {
        for (int g = q + i * a.tpp; 4 * g < a.d; g += kSumClasses) {
          float xi[4];
          draw(n, g, xi);
#pragma unroll
          for (int r = 0; r < 4; ++r)
            if (4 * g + r < a.d) acc.y[i] += xi[r];
        }
      }
      continue;
    }
    // euler: the wrapper packs adaptive = 0, so c = 0 whatever Z holds
    train_forward_step<kShared, kShared, kStage != kEuler,
                       kStage == kNet   ? kSumZx
                       : kStage >= kFull ? kSumAll
                                         : kSumNone>(a, P, W, st, n, draw, q,
                                                     acc);
  }
  for (int i = 0; i < slots; ++i) {
    for (int g = q + i * a.tpp; 4 * g < a.d; g += kSumClasses) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
        if (4 * g + r < a.d) acc.y[i] += st.X[(4 * g + r) * ts];
    }
  }
}

template <int kStage, bool kDevice>
__global__ void __launch_bounds__(kFwdThreads, 2)
ablation_kernel(const TrainArgs a, const float* __restrict__ P,
                float* __restrict__ out, float* ws) {
  extern __shared__ float4 smem4[];
  float* S = reinterpret_cast<float*>(smem4);
  const int q = threadIdx.x / a.tile;
  TrainState st;
  float *G, *R;
  const float* W = train_setup<false, kDevice>(a, P, S, ws, nullptr, st, &G,
                                              &R);
  const int k = blockIdx.x * a.tile + st.p;
  FwdAcc acc = {};
  if (kStage == kFullNoNoise) {
    ablation_path<kStage, !kDevice>(a, P, W, st, ConstDraw{}, q, acc);
  } else if (kStage == kFullRawBits) {
    ablation_path<kStage, !kDevice>(a, P, W, st,
                                    RawBitsDraw{a.key0, a.key1, k}, q, acc);
  } else {
    const int rng = kStage == kFullBinom ? 1 : 0;
    ablation_path<kStage, !kDevice>(a, P, W, st,
                                    MapDraw{a.key0, a.key1, k, rng}, q, acc);
  }
  float r, unused_k, unused_u;
  train_path_sums(a, R, q, st.p, acc, r, unused_k, unused_u);
  if (q == 0 && k < a.K) out[k] = r;
}

template <int kStage, bool kDevice>
int launch_ablation_plan(const TrainArgs& a, const float* params, float* out,
                         float* ws, void* stream) {
  const size_t smem = sizeof(float) * train_smem_floats(a);
  cudaError_t e = cudaFuncSetAttribute(
      ablation_kernel<kStage, kDevice>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned grid = static_cast<unsigned>((a.K + a.tile - 1) / a.tile);
  ablation_kernel<kStage, kDevice><<<grid, a.tile * a.tpp, smem,
                                     static_cast<cudaStream_t>(stream)>>>(
      a, params, out, ws);
  return static_cast<int>(cudaGetLastError());
}

template <int kStage>
int launch_ablation(const TrainArgs& a, const float* params, float* out,
                    float* ws, void* stream) {
  return a.plan == 1
             ? launch_ablation_plan<kStage, true>(a, params, out, ws, stream)
             : launch_ablation_plan<kStage, false>(a, params, out, ws,
                                                   stream);
}

template <int kChain>
int launch_chain(float* x, int n, int P, const ChainConsts& cc,
                 void* stream) {
  const unsigned grid = static_cast<unsigned>((n + 255) / 256);
  fma_chain_kernel<kChain><<<grid, 256, 0,
                             static_cast<cudaStream_t>(stream)>>>(x, n, P,
                                                                   cc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream` of CUDA device `device`; each returns the cudaError_t
// of the launch (0 = success).

// x (n,) in place: P passes of `chain` links x <- fmaf(x, x, consts[j]);
// chain is 1, 4 or 16.
extern "C" int pspde_fma_chain(float* x, int n, int P, int chain,
                               const float* consts, int device,
                               void* stream) {
  if (n <= 0 || P < 0) return static_cast<int>(cudaErrorInvalidValue);
  ChainConsts cc;
  memset(&cc, 0, sizeof(cc));
  if (chain < 1 || chain > kMaxChain)
    return static_cast<int>(cudaErrorInvalidValue);
  memcpy(cc.c, consts, chain * sizeof(float));
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  switch (chain) {
    case 1: return launch_chain<1>(x, n, P, cc, stream);
    case 4: return launch_chain<4>(x, n, P, cc, stream);
    case 16: return launch_chain<16>(x, n, P, cc, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// acc (tile,): the per-column sums of P passes of d normals; rng 0 erfinv,
// 1 binom.
extern "C" int pspde_normals_sum(float* acc, int tile, int d, int P, int rng,
                                 unsigned long long seed, int device,
                                 void* stream) {
  if (tile <= 0 || d <= 0 || P < 0 || rng < 0 || rng > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned grid = static_cast<unsigned>((tile + kCols - 1) / kCols);
  normals_sum_kernel<<<grid, dim3(kCols, kSlices), 0,
                       static_cast<cudaStream_t>(stream)>>>(
      acc, tile, d, P, rng, static_cast<uint32_t>(seed & 0xFFFFFFFFull),
      static_cast<uint32_t>(seed >> 32));
  return static_cast<int>(cudaGetLastError());
}

// out (K,): one ablation stage (0 noise, 1 euler, 2 net, 3 full,
// 4 full_nonoise, 5 full_rawbits, 6 full_binom) on the training forward's
// arguments (`iargs`, `fargs` in the order of TrainArgs); `ws` is the
// device plan's workspace (null in the shared plan).
extern "C" int pspde_ablation(const float* params, float* out, float* ws,
                              int stage, const int* iargs, const float* fargs,
                              unsigned long long seed, int device,
                              void* stream) {
  TrainArgs a;
  const int err = train_unpack(iargs, fargs, seed, device, &a);
  if (err != 0) return err;
  // the double well's drift (drift_kind 2) runs in the serve kernel only
  if (a.backward || a.drift_kind == 2)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (stage) {
    case kNoise: return launch_ablation<kNoise>(a, params, out, ws, stream);
    case kEuler: return launch_ablation<kEuler>(a, params, out, ws, stream);
    case kNet: return launch_ablation<kNet>(a, params, out, ws, stream);
    case kFull: return launch_ablation<kFull>(a, params, out, ws, stream);
    case kFullNoNoise:
      return launch_ablation<kFullNoNoise>(a, params, out, ws, stream);
    case kFullRawBits:
      return launch_ablation<kFullRawBits>(a, params, out, ws, stream);
    case kFullBinom:
      return launch_ablation<kFullBinom>(a, params, out, ws, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
