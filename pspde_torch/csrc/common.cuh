// Device code shared by the rollout kernels (train_step.cuh, and through
// it controlled_rollout.cu and train_rollout.cu; stopped_rollout.cu): the
// counter-based noise stream, the two bits -> normal maps, the chunked FP32
// matrix-vector products of the stopped nets and the dense coefficients,
// and the TF32 tensor-core pieces of the net and weight-gradient products.
//
// Per-path arrays are [row][stride] in shared memory: thread p of a block
// reads row i of its own path at in[i * stride], so a warp reads 32
// consecutive words.  Matrices are (rows, cols) row-major with cols padded
// to kChunk on the host, read as float4 broadcasts.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <unordered_map>
#include <utility>

namespace pspde {

constexpr int kMaxLayers = 8;   // pspde_torch/rollout/kernels.py _MAX_LAYERS
constexpr int kChunk = 8;       // ... _CHUNK
constexpr int kMaxTile = 128;   // ... _MAX_TILE

// Host: lets `kernel` take `bytes` of dynamic shared memory on the current
// device (cudaFuncSetAttribute), asking the runtime only when `bytes`
// exceeds what this process set for that kernel and device before.  A
// launch at a shape run once already makes no such call, so the training
// kernels' launches inside a CUDA graph's capture, after the eager warm-up
// step at the same shapes (pspde_torch/solvers/_chunk.py), are stream
// operations only; and a launch saves a runtime call.
inline cudaError_t allow_dynamic_smem(const void* kernel, size_t bytes) {
  static std::mutex mu;
  static std::unordered_map<const void*, size_t> set[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  const auto it = set[dev].find(kernel);
  if (it != set[dev].end() && it->second >= bytes) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(bytes));
  if (e == cudaSuccess) set[dev][kernel] = bytes;
  return e;
}

// Counts a launch of the calling kernel: block 0's thread 0 adds one to the
// 64-bit word `launches` (none where it is null).  The word is the kernel's
// launch count on the device, so that a launch recorded into a CUDA graph is
// counted each time the graph runs it.
__device__ __forceinline__ void count_launch(unsigned long long* launches) {
  if (launches != nullptr && blockIdx.x == 0 && blockIdx.y == 0 &&
      blockIdx.z == 0 && threadIdx.x == 0 && threadIdx.y == 0 &&
      threadIdx.z == 0)
    atomicAdd(launches, 1ull);
}

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z);
    const uint32_t lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// bits -> float in [1, 2) -> [0, 1) -> 2u - 1 clipped to +-(1 - 1e-7)
// (float32 constants) -> sqrt(2) erfinv.
__device__ __forceinline__ float normal_from_bits(uint32_t bits) {
  const float u01 = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
  const float u = fminf(fmaxf(2.0f * u01 - 1.0f, -0.99999988079071044921875f),
                        0.99999988079071044921875f);
  return 1.41421353816986083984375f * erfinvf(u);
}

// Moment-matched normals: (popcount(b1) - 16 + (b2 & 0x7FFF) 2^-15 - 1/2)
// / sqrt(8 + 1/12).  Every step before the final product is exact, so the
// value is bitwise that of the plain version.
__device__ __forceinline__ float normal_from_bits_binom(uint32_t b1,
                                                        uint32_t b2) {
  const float pc = static_cast<float>(__popc(b1) - 16);
  const float u = static_cast<float>(b2 & 0x7FFFu) * 3.0517578125e-05f;
  return ((pc + u) - 0.5f) * 0.351726233959198f;
}

// The four normals of dimension group g (dimensions 4g..4g+3) of path k at
// step n: Philox4x32-10 at counter (k, n, g, 0) through the erfinv map
// (rng 0), or b1 from counter word 3 = 0 and b2 from word 3 = 1 through
// the binom map (rng 1).
__device__ __forceinline__ void philox_normals4(uint32_t k, uint32_t n,
                                                uint32_t g, uint32_t key0,
                                                uint32_t key1, int rng,
                                                float (&xi)[4]) {
  const uint4 r = philox4x32_10(make_uint4(k, n, g, 0u), key0, key1);
  if (rng == 1) {
    const uint4 r2 = philox4x32_10(make_uint4(k, n, g, 1u), key0, key1);
    xi[0] = normal_from_bits_binom(r.x, r2.x);
    xi[1] = normal_from_bits_binom(r.y, r2.y);
    xi[2] = normal_from_bits_binom(r.z, r2.z);
    xi[3] = normal_from_bits_binom(r.w, r2.w);
  } else {
    xi[0] = normal_from_bits(r.x);
    xi[1] = normal_from_bits(r.y);
    xi[2] = normal_from_bits(r.z);
    xi[3] = normal_from_bits(r.w);
  }
}

// acc[c] += sum_{i < rows} in[i] * MT[i][j0 + c] for one chunk of outputs.
// `in` points at this thread's column of a [row][stride] array.
__device__ __forceinline__ void matvec_chunk(const float* __restrict__ MT,
                                             int rows, int cols, int j0,
                                             const float* in, int stride,
                                             float (&acc)[kChunk]) {
#pragma unroll 4
  for (int i = 0; i < rows; ++i) {
    const float a = in[i * stride];
    const float4 w0 = *reinterpret_cast<const float4*>(MT + i * cols + j0);
    const float4 w1 =
        *reinterpret_cast<const float4*>(MT + i * cols + j0 + 4);
    acc[0] = fmaf(a, w0.x, acc[0]);
    acc[1] = fmaf(a, w0.y, acc[1]);
    acc[2] = fmaf(a, w0.z, acc[2]);
    acc[3] = fmaf(a, w0.w, acc[3]);
    acc[4] = fmaf(a, w1.x, acc[4]);
    acc[5] = fmaf(a, w1.y, acc[5]);
    acc[6] = fmaf(a, w1.z, acc[6]);
    acc[7] = fmaf(a, w1.w, acc[7]);
  }
}

// -- TF32 tensor-core products (the backward kernels' weight gradients) --

// x rounded to TF32, as cvt.rna.tf32.f32 rounds a finite x: to nearest,
// ties away from zero, on the 13 dropped mantissa bits (add half their
// range to the magnitude, then clear them; a carry moves into the
// exponent).  Written out, it is two integer instructions; the PTX
// instruction lowers to four, with a guard for inf and NaN.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = big + small + O(2^-22 |x|), big = rna(x) and small = rna(x - big)
// both TF32 (x - big is exact).  Three TF32 products (big big, big small,
// small big) then keep a float32 sum's accuracy, where one would keep
// TF32's 2^-11 (the "3xTF32" split).
__device__ __forceinline__ void tf32_split(float x, uint32_t& big,
                                           uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

// d += a b on one warp's m16n8k8 TF32 tile: A (16 x 8) row-major, B (8 x 8)
// column-major, D float32.  Lane l holds, with g = l / 4 and c = l % 4 (the
// PTX ISA's fragment layout): a = A[g][c], A[g + 8][c], A[g][c + 4],
// A[g + 8][c + 4]; b = B[c][g], B[c + 4][g]; d = D[g][2c], D[g][2c + 1],
// D[g + 8][2c], D[g + 8][2c + 1].
__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A row of the block's per-path arrays, read at path k.  Where the arrays'
// pointers come out of a struct (train_step.cuh: TrainState) or through a
// helper, the compiler loses their address space and would read shared
// memory with generic loads: in shared memory (kShared) the row is kept as
// a shared-window address and read with ld.shared.
template <bool kShared>
struct PathRow {
  const float* p;
  __device__ __forceinline__ explicit PathRow(const float* row) : p(row) {}
  __device__ __forceinline__ float operator[](int k) const { return p[k]; }
};

template <>
struct PathRow<true> {
  uint32_t s;
  __device__ __forceinline__ explicit PathRow(const float* row)
      : s(static_cast<uint32_t>(__cvta_generic_to_shared(row))) {}
  __device__ __forceinline__ float operator[](int k) const {
    float v;
    asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(s + 4 * k)
                 : "memory");
    return v;
  }
};

}  // namespace pspde
