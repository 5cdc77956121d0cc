// The fixed-order sums that several kernels share.
//
//   lavt_sum_partials: out[i] = the sum of S f32 partials in order, the
//     deterministic reduction of every split sum (K5's weight, bias and
//     bias-table grads, K7's, K9's dbias): no float atomics, so two runs of
//     one step give the same bits.
//   lavt_colsum_bf16: f32 column sums of a bf16 matrix by row splits
//     (K5's dbproj), partials for lavt_sum_partials;
//   lavt_colsum_f32: the same of an f32 matrix of any width (K5 f32's
//     dbproj and dbqkv).

#include <cstdint>

#include "common.cuh"

namespace lavt {

// out[i] = sum over s of part[s n + i], s in order (deterministic).
__global__ void sum_partials_kernel(const float* __restrict__ part, float* __restrict__ out,
                                    int parts, size_t n) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    int j = 0;
    for (; j + 8 <= parts; j += 8) {  // eight loads in flight, added in order
      float v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = part[static_cast<size_t>(j + e) * n + i];
#pragma unroll
      for (int e = 0; e < 8; ++e) s += v[e];
    }
    for (; j < parts; ++j) s += part[static_cast<size_t>(j) * n + i];
    out[i] = s;
  }
}

// part[z cols + c] = sum of x[r, c] (f32) over rows r of split z; one
// block of 256 threads per split: a thread takes 8 columns (one 16-byte
// load a row) and every (256 / (cols / 8))-th row, the rows' partials are
// then added in order.  cols % 8 == 0, cols <= 2048.
__global__ void __launch_bounds__(256)
    colsum_bf16_kernel(const bf16* __restrict__ x, float* __restrict__ part, int rows, int cols,
                       int rows_per_split) {
  __shared__ float red[256 * 8];
  const int chunks = cols / 8, par = blockDim.x / chunks;
  const int chunk = threadIdx.x % chunks, lane = threadIdx.x / chunks;
  const int r0 = blockIdx.x * rows_per_split, r1 = min(rows, r0 + rows_per_split);
  float s[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (lane < par) {
    for (int r = r0 + lane; r < r1; r += par) {
      Pack8 p;
      p.u = *reinterpret_cast<const uint4*>(x + static_cast<size_t>(r) * cols + chunk * 8);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(p.h[e]);
        s[2 * e] += f.x, s[2 * e + 1] += f.y;
      }
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) red[(lane * chunks + chunk) * 8 + e] = s[e];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < cols; c += blockDim.x) {
    float t = 0.f;
    for (int l = 0; l < par; ++l) t += red[(l * chunks + c / 8) * 8 + c % 8];
    part[static_cast<size_t>(blockIdx.x) * cols + c] = t;
  }
}

// part[z cols + c] = sum of x[r, c] over rows r of split z, x f32; a block
// of 256 threads per (split z, 128 columns): 32 lanes of 4 columns (a warp
// reads 512 contiguous bytes of a row) by 8 row lanes, lane l every 8th row
// from l, the 8 lanes' sums then added in order.  cols % 4 == 0.
__global__ void __launch_bounds__(256)
    colsum_f32_kernel(const float* __restrict__ x, float* __restrict__ part, int rows, int cols,
                      int rows_per_split) {
  __shared__ float4 red[8][32];
  const int chunk = threadIdx.x % 32, lane = threadIdx.x / 32;
  const int c0 = blockIdx.y * 128 + 4 * chunk;
  const int r0 = blockIdx.x * rows_per_split, r1 = min(rows, r0 + rows_per_split);
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  if (c0 < cols) {
    for (int r = r0 + lane; r < r1; r += 8) {
      const float4 v = *reinterpret_cast<const float4*>(x + static_cast<size_t>(r) * cols + c0);
      s.x += v.x, s.y += v.y, s.z += v.z, s.w += v.w;
    }
  }
  red[lane][chunk] = s;
  __syncthreads();
  if (lane == 0 && c0 < cols) {
    float4 t = red[0][chunk];
    for (int l = 1; l < 8; ++l) {
      const float4 v = red[l][chunk];
      t.x += v.x, t.y += v.y, t.z += v.z, t.w += v.w;
    }
    *reinterpret_cast<float4*>(part + static_cast<size_t>(blockIdx.x) * cols + c0) = t;
  }
}

}  // namespace lavt

extern "C" int lavt_sum_partials(const void* part, void* out, int parts, long long n,
                                 void* stream) {
  using namespace lavt;
  const long long want = (n + 255) / 256;
  const int blocks = static_cast<int>(want < 4096 ? (want > 0 ? want : 1) : 4096);
  sum_partials_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part), static_cast<float*>(out), parts,
      static_cast<size_t>(n));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lavt_colsum_bf16(const void* x, void* part, int rows, int cols, int splits,
                                void* stream) {
  using namespace lavt;
  if (cols < 8 || cols % 8 != 0 || cols > 2048 || rows < 1 || splits < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int per = (rows + splits - 1) / splits;
  colsum_bf16_kernel<<<splits, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<float*>(part), rows, cols, per);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lavt_colsum_f32(const void* x, void* part, int rows, int cols, int splits,
                               void* stream) {
  using namespace lavt;
  if (cols < 4 || cols % 4 != 0 || rows < 1 || splits < 1 || splits > rows ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(part) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int per = (rows + splits - 1) / splits;
  colsum_f32_kernel<<<dim3(splits, (cols + 127) / 128), 256, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(part), rows, cols, per);
  return static_cast<int>(cudaGetLastError());
}
