// K4: one-pass row LayerNorm.
//
// Replaces lavt_rs_tpu/ops/pallas/ln.py:layer_norm_rows (_ln_kernel), the
// stage-output norms norm0..norm3 of the Swin backbone.
//
// Math: f32 statistics with the fast variance E[x^2] - E[x]^2 and epsilon
// inside rsqrt, then the affine (gamma, beta), out in bf16.
//
// Bound on the H100: memory.  Per row it reads C bf16 values and writes C;
// there are 8 flops per element and no tensor-core work.  Design: one warp
// per row, every lane keeps its C/32 values in registers, so a row is read
// from device memory once and written once.  Lanes read neighbouring
// elements (coalesced 64-byte warp transactions).  C <= 1024.  Wider rows
// (1024 < C <= 4096: Swin-L's stage 4 is 1536) take one block of 128
// threads per row, each keeping up to 32 values, the sums reduced through
// shared memory; still one read and one write of the row.

#include "common.cuh"

namespace lavt {

constexpr int kLnMaxPerLane = 32;  // C <= 1024
constexpr int kLnRowsPerBlock = 8;

__global__ void layer_norm_rows_kernel(const bf16* __restrict__ x,
                                       const bf16* __restrict__ gamma,
                                       const bf16* __restrict__ beta,
                                       bf16* __restrict__ out, int rows, int C,
                                       float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kLnRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const bf16* xr = x + static_cast<size_t>(row) * C;
  float v[kLnMaxPerLane];
  float s = 0.f, ss = 0.f;
#pragma unroll
  for (int t = 0; t < kLnMaxPerLane; ++t) {
    const int c = lane + 32 * t;
    v[t] = c < C ? to_f(xr[c]) : 0.f;
    s += v[t];
    ss += v[t] * v[t];
  }
  s = warp_sum(s);
  ss = warp_sum(ss);
  const float mu = s / C;
  const float var = ss / C - mu * mu;
  const float rstd = rsqrtf(var + eps);
  bf16* orow = out + static_cast<size_t>(row) * C;
#pragma unroll
  for (int t = 0; t < kLnMaxPerLane; ++t) {
    const int c = lane + 32 * t;
    if (c < C) orow[c] = to_bf((v[t] - mu) * rstd * to_f(gamma[c]) + to_f(beta[c]));
  }
}

constexpr int kLnWideThreads = 128;  // 1024 < C <= 4096

__global__ void __launch_bounds__(kLnWideThreads)
layer_norm_wide_rows_kernel(const bf16* __restrict__ x, const bf16* __restrict__ gamma,
                            const bf16* __restrict__ beta, bf16* __restrict__ out,
                            int C, float eps) {
  __shared__ float part[2][kLnWideThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bf16* xr = x + static_cast<size_t>(blockIdx.x) * C;
  float v[kLnMaxPerLane];
  float s = 0.f, ss = 0.f;
#pragma unroll
  for (int t = 0; t < kLnMaxPerLane; ++t) {
    const int c = threadIdx.x + kLnWideThreads * t;
    v[t] = c < C ? to_f(xr[c]) : 0.f;
    s += v[t];
    ss += v[t] * v[t];
  }
  s = warp_sum(s);
  ss = warp_sum(ss);
  if (lane == 0) {
    part[0][warp] = s;
    part[1][warp] = ss;
  }
  __syncthreads();
  s = ss = 0.f;
#pragma unroll
  for (int w = 0; w < kLnWideThreads / 32; ++w) {  // fixed order
    s += part[0][w];
    ss += part[1][w];
  }
  const float mu = s / C;
  const float rstd = rsqrtf(ss / C - mu * mu + eps);
  bf16* orow = out + static_cast<size_t>(blockIdx.x) * C;
#pragma unroll
  for (int t = 0; t < kLnMaxPerLane; ++t) {
    const int c = threadIdx.x + kLnWideThreads * t;
    if (c < C) orow[c] = to_bf((v[t] - mu) * rstd * to_f(gamma[c]) + to_f(beta[c]));
  }
}

}  // namespace lavt

extern "C" int lavt_layer_norm_rows(const void* x, const void* gamma, const void* beta,
                                    void* out, int rows, int C, float eps,
                                    void* stream) {
  using namespace lavt;
  if (C > 32 * kLnMaxPerLane) {
    if (C > kLnWideThreads * kLnMaxPerLane) return static_cast<int>(cudaErrorInvalidValue);
    layer_norm_wide_rows_kernel<<<rows, kLnWideThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(gamma),
        static_cast<const bf16*>(beta), static_cast<bf16*>(out), C, eps);
    return static_cast<int>(cudaGetLastError());
  }
  const int blocks = (rows + kLnRowsPerBlock - 1) / kLnRowsPerBlock;
  layer_norm_rows_kernel<<<blocks, 32 * kLnRowsPerBlock, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(gamma),
      static_cast<const bf16*>(beta), static_cast<bf16*>(out), rows, C, eps);
  return static_cast<int>(cudaGetLastError());
}
