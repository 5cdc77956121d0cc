// The WMMA GEMM and the fixed-order sums that several kernels share.
//
//   lavt_gemm_bf16: a bf16 GEMM on WMMA (m16n16k16, f32 sums) over 64 x 64
//     block tiles: K1/K2's and K11's out-projection (ops/fused_msa.gemm).
//   lavt_sum_partials: out[i] = the sum of S f32 partials in order, the
//     deterministic reduction of every split sum (K5's weight, bias and
//     bias-table grads, K7's, K9's dbias): no float atomics, so two runs of
//     one step give the same bits.
//   lavt_colsum_bf16: f32 column sums of a bf16 matrix by row splits
//     (K5's dbproj), partials for lavt_sum_partials.

#include "common.cuh"

namespace lavt {

// out (M x N) = sum_k A(m, k) B(k, n) (+ bias[n]), bf16 in, f32
// accumulate, rounded to bf16.
// AK: A is stored k-major (K x M row-major, i.e. A^T), else M x K row-major.
// BN: B is stored n-major (N x K row-major, a torch Linear weight), else
// K x N row-major.  grid (N/64, M/64).
// M, N, K, lda and ldb are multiples of 8 (16-byte loads); tiles past the
// edges are zero-filled.  64 x 64 block tile, four warps of 32 x 32, k in
// steps of 32.
constexpr int kTM = 64, kTK = 32;

template <bool AK, bool BN>
__global__ void __launch_bounds__(128)
gemm_bf16_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B,
                 const bf16* __restrict__ bias, bf16* __restrict__ out, int M, int N, int K,
                 int lda, int ldb) {
  constexpr int LDA = AK ? kTM + 8 : kTK + 8;
  constexpr int LDB = BN ? kTK + 8 : kTM + 8;
  constexpr int LDC = kTM + 4;
  __shared__ __align__(128) bf16 as[kTM * (kTK + 8)];
  __shared__ __align__(128) bf16 bs[kTM * (kTK + 8)];
  __shared__ __align__(128) float cs[kTM * LDC];
  static_assert(kTK * (kTM + 8) <= kTM * (kTK + 8), "k-major tiles fit");

  const int bm = blockIdx.y * kTM, bn = blockIdx.x * kTM;
  const int warp = threadIdx.x >> 5, wr = warp / 2, wc = warp % 2;
  const uint4 zero = make_uint4(0, 0, 0, 0);
  FragC acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < K; k0 += kTK) {
    for (int i = threadIdx.x; i < kTM * kTK / 8; i += 128) {
      if (!AK) {  // 64 (m) x 32 (k)
        const int r = i / (kTK / 8), c = (i % (kTK / 8)) * 8;
        uint4 val = zero;
        if (bm + r < M && k0 + c < K)
          val = *reinterpret_cast<const uint4*>(A + static_cast<size_t>(bm + r) * lda + k0 + c);
        *reinterpret_cast<uint4*>(as + r * LDA + c) = val;
      } else {  // 32 (k) x 64 (m)
        const int r = i / (kTM / 8), c = (i % (kTM / 8)) * 8;
        uint4 val = zero;
        if (k0 + r < K && bm + c < M)
          val = *reinterpret_cast<const uint4*>(A + static_cast<size_t>(k0 + r) * lda + bm + c);
        *reinterpret_cast<uint4*>(as + r * LDA + c) = val;
      }
      if (!BN) {  // 32 (k) x 64 (n)
        const int r = i / (kTM / 8), c = (i % (kTM / 8)) * 8;
        uint4 val = zero;
        if (k0 + r < K && bn + c < N)
          val = *reinterpret_cast<const uint4*>(B + static_cast<size_t>(k0 + r) * ldb + bn + c);
        *reinterpret_cast<uint4*>(bs + r * LDB + c) = val;
      } else {  // 64 (n) x 32 (k)
        const int r = i / (kTK / 8), c = (i % (kTK / 8)) * 8;
        uint4 val = zero;
        if (bn + r < N && k0 + c < K)
          val = *reinterpret_cast<const uint4*>(B + static_cast<size_t>(bn + r) * ldb + k0 + c);
        *reinterpret_cast<uint4*>(bs + r * LDB + c) = val;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTK; kk += 16) {
      FragBRow fbr[2];
      FragBCol fbc[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int n0 = wc * 32 + j * 16;
        if constexpr (BN) wmma::load_matrix_sync(fbc[j], bs + n0 * LDB + kk, LDB);
        else wmma::load_matrix_sync(fbr[j], bs + kk * LDB + n0, LDB);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int m0 = wr * 32 + i * 16;
        if constexpr (AK) {
          FragACol fa;
          wmma::load_matrix_sync(fa, as + kk * LDA + m0, LDA);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            if constexpr (BN) wmma::mma_sync(acc[i][j], fa, fbc[j], acc[i][j]);
            else wmma::mma_sync(acc[i][j], fa, fbr[j], acc[i][j]);
          }
        } else {
          FragA fa;
          wmma::load_matrix_sync(fa, as + m0 * LDA + kk, LDA);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            if constexpr (BN) wmma::mma_sync(acc[i][j], fa, fbc[j], acc[i][j]);
            else wmma::mma_sync(acc[i][j], fa, fbr[j], acc[i][j]);
          }
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(cs + (wr * 32 + i * 16) * LDC + wc * 32 + j * 16, acc[i][j],
                              LDC, wmma::mem_row_major);
  __syncthreads();
  for (int i = threadIdx.x; i < kTM * kTM; i += 128) {
    const int r = i / kTM, c = i % kTM;
    if (bm + r < M && bn + c < N)
      out[static_cast<size_t>(bm + r) * N + bn + c] =
          to_bf(cs[r * LDC + c] + (bias != nullptr ? to_f(bias[bn + c]) : 0.f));
  }
}

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

}  // namespace lavt

extern "C" int lavt_gemm_bf16(const void* a, const void* b, const void* bias, void* out, int M,
                              int N, int K, int lda, int ldb, int a_kmajor, int b_nmajor,
                              void* stream) {
  using namespace lavt;
  dim3 grid((N + kTM - 1) / kTM, (M + kTM - 1) / kTM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* A = static_cast<const bf16*>(a);
  const bf16* B = static_cast<const bf16*>(b);
  const bf16* bi = static_cast<const bf16*>(bias);
  bf16* o = static_cast<bf16*>(out);
  if (a_kmajor && b_nmajor)
    gemm_bf16_kernel<true, true><<<grid, 128, 0, s>>>(A, B, bi, o, M, N, K, lda, ldb);
  else if (a_kmajor)
    gemm_bf16_kernel<true, false><<<grid, 128, 0, s>>>(A, B, bi, o, M, N, K, lda, ldb);
  else if (b_nmajor)
    gemm_bf16_kernel<false, true><<<grid, 128, 0, s>>>(A, B, bi, o, M, N, K, lda, ldb);
  else
    gemm_bf16_kernel<false, false><<<grid, 128, 0, s>>>(A, B, bi, o, M, N, K, lda, ldb);
  return static_cast<int>(cudaGetLastError());
}

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
