// Shared helpers of the hand-written Hopper kernels (bf16 in, f32 math).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace lavt {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 8 bf16 <-> one 16-byte word, for vector loads and stores
union Pack8 {
  uint4 u;
  __nv_bfloat162 h[4];
};

__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ bf16 to_bf(float v) { return __float2bfloat16(v); }

// The exact-erf GELU through the TPU kernel's erf, Abramowitz & Stegun
// 7.1.26 (|err| < 1.5e-7; lavt_rs_tpu/ops/pallas/fused_mlp.py:_erf):
// returns Phi(v) = 0.5 (1 + erf(v / sqrt 2)) and writes phi(v) =
// exp(-v^2 / 2) / sqrt(2 pi) (its exponential shared), so gelu(v) =
// v Phi(v) and gelu'(v) = Phi(v) + v phi(v).
__device__ __forceinline__ float gelu_cdf_pdf(float v, float* pdf) {
  const float ax = fabsf(v) * 0.70710678118654752f;
  const float t = __fdividef(1.f, 1.f + 0.3275911f * ax);
  const float e = __expf(-ax * ax);
  const float poly =
      ((((1.061405429f * t - 1.453152027f) * t + 1.421413741f) * t - 0.284496736f) * t +
       0.254829592f) * t;
  *pdf = e * 0.3989422804014327f;
  return 0.5f * (1.f + copysignf(1.f - poly * e, v));
}

// Two-pass LayerNorm of one row of C bf16 values by one warp (mean of
// (x - mu)^2, eps inside rsqrt): lane l handles the column pairs
// 2 (l + 32 t), t < C / 64.  Writes the bf16 row to xn; returns (mu, rstd).
template <int C>
__device__ __forceinline__ float2 ln_row_two_pass(const bf16* __restrict__ x,
                                                  const bf16* __restrict__ gamma,
                                                  const bf16* __restrict__ beta, float eps,
                                                  bf16* __restrict__ xn) {
  constexpr int P = C / 64;
  const int lane = threadIdx.x % 32;
  const auto* src = reinterpret_cast<const __nv_bfloat162*>(x);
  const auto* g2 = reinterpret_cast<const __nv_bfloat162*>(gamma);
  const auto* b2 = reinterpret_cast<const __nv_bfloat162*>(beta);
  float2 v[P];
  float s = 0.f;
#pragma unroll
  for (int t = 0; t < P; ++t) {
    v[t] = __bfloat1622float2(src[lane + 32 * t]);
    s += v[t].x + v[t].y;
  }
  const float mu = warp_sum(s) / C;
  float q = 0.f;
#pragma unroll
  for (int t = 0; t < P; ++t) q += (v[t].x - mu) * (v[t].x - mu) + (v[t].y - mu) * (v[t].y - mu);
  const float rstd = rsqrtf(warp_sum(q) / C + eps);
  auto* dst = reinterpret_cast<__nv_bfloat162*>(xn);
#pragma unroll
  for (int t = 0; t < P; ++t) {
    const float2 g = __bfloat1622float2(g2[lane + 32 * t]);
    const float2 b = __bfloat1622float2(b2[lane + 32 * t]);
    dst[lane + 32 * t] = __floats2bfloat162_rn((v[t].x - mu) * rstd * g.x + b.x,
                                               (v[t].y - mu) * rstd * g.y + b.y);
  }
  return make_float2(mu, rstd);
}

// Raise a kernel's dynamic shared-memory limit above the 48 KB default.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace lavt
