// Shared helpers of the hand-written Hopper kernels (bf16 in, f32 math).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace lavt {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

// WMMA tiles: bf16 16x16x16 with f32 accumulation.
using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragBRow = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBCol = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// 8 bf16 <-> one 16-byte word, for vector loads and stores
union Pack8 {
  uint4 u;
  __nv_bfloat162 h[4];
};

__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ bf16 to_bf(float v) { return __float2bfloat16(v); }

// Round a byte count up to 128 so carved shared-memory regions stay
// aligned for WMMA loads (which need 32-byte aligned tile pointers).
__host__ __device__ constexpr size_t align128(size_t n) { return (n + 127) & ~size_t(127); }

// Raise a kernel's dynamic shared-memory limit above the 48 KB default.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace lavt
