// K5: fused window MSA backward from the taped forward's residuals, and
// the building blocks K6 (recompute) reuses.
//
// Replaces lavt_rs_tpu/ops/pallas/fused_msa.py:_fused_bwd_group_resid /
// _bwd_kernel_resid.  Given the output gradient gy (B nW N, C) and the
// residuals of the save-mode forward (q post-scale, k, v as (B nW N, C)
// with lanes in head order, P as (B nW, heads, N, N), all bf16) it
// produces, with the TPU kernel's rounding points:
//   dattn = gy Wproj                       (f32 -> bf16, per head: do)
//   o   = P v                              (f32 -> bf16; feeds dWproj)
//   dv  = P^T do,  dp = do v^T,  ds = P (dp - rowsum(dp P))   (f32)
//   dq  = ds k scale,  dk = ds^T q         (ds rounded to bf16 first)
//   dbias = sum over windows of ds;  dbq/dbk/dbv = row sums of the f32 dq/dk/dv
//   dx  = [dq|dk|dv] Wqkv                  ([dq|dk|dv] rounded to bf16)
//   dWqkv = [dq|dk|dv]^T x,  dWproj = gy^T o,  dbproj = column sums of gy
// as a sequence of launches, all hand-written:
//   1. gemm_bf16 (dattn), 2. msa_bwd_attn_kernel (per window and head:
//   o, dq, dk, dv, dbias and dbqkv partials), 3. gemm_bf16 (dx),
//   4./5. gemm_bf16 split over rows (dWqkv, dWproj), 6. colsum_bf16
//   (dbproj), 7. sum_partials for every split reduction.
//
// Bound on the H100: at hd = 32 the per-head N x N products (five of
// 2 N^2 hd flops per window and head) and the dW/dx GEMMs (8 rows C^2
// flops) are tensor-core work; P (B nW h N^2 bf16) is the largest input.
// Design: the attention kernel keeps the head's q/k/v/do and the N x N
// dp/ds tile in shared memory and reads P from device memory once per
// product (WMMA loads, L2-resident).  Weight and bias-table grads sum over
// all B nW windows.  They are reduced deterministically: every block owns
// a slice of an f32 partial buffer (the attention kernel loops over a
// strided set of windows and accumulates dbias in shared memory; the dW
// GEMMs split the row dimension over grid.z), and sum_partials adds the
// partials in a fixed order.  atomicAdd would make the f32 sums depend on
// the order the blocks run in, so two runs of one step would differ.
// WMMA bf16 m16n16k16 with f32 accumulation; no TMA or wgmma yet.

#include "common.cuh"

namespace lavt {

constexpr int bN = 144;   // window 12 x 12
constexpr int bHD = 32;   // head dim
constexpr int bThreads = 256;
constexpr int bWarps = bThreads / 32;
constexpr int LDSF = bN;       // f32 dp tile
constexpr int LDSB = 2 * bN;   // bf16 ds, written over the first half of each f32 row
constexpr int LDT = bHD + 4;   // f32 144 x 32 staging

constexpr size_t DP_BYTES = align128(size_t(bN) * bN * 4);
constexpr size_t HT_BYTES = align128(size_t(bN) * bHD * 2);
constexpr size_t STG_BYTES = align128(size_t(bN) * LDT * 4);
constexpr size_t BWD_SMEM = 2 * DP_BYTES + 4 * HT_BYTES + STG_BYTES + align128(3 * bHD * 4);
static_assert(BWD_SMEM <= 232448, "fits one block per SM");

// st (144 x 32 f32, ld LDT) -> bf16 columns of dst (row stride ld); the f32
// column sums are added to bsum[32] (the bias grads, before the rounding).
__device__ __forceinline__ void finish_part(const float* st, bf16* dst, int ld, float* bsum) {
  if (threadIdx.x < bHD) {
    float s = 0.f;
    for (int r = 0; r < bN; ++r) s += st[r * LDT + threadIdx.x];
    bsum[threadIdx.x] += s;
  }
  for (int i = threadIdx.x; i < bN * (bHD / 8); i += bThreads) {
    const int r = i / (bHD / 8), d = (i % (bHD / 8)) * 8;
    *reinterpret_cast<uint4*>(dst + static_cast<size_t>(r) * ld + d) = pack8(st + r * LDT + d);
  }
}

// grid (G, heads): block (g, h) takes windows g, g + G, ... for head h.
__global__ void __launch_bounds__(bThreads, 1)
msa_bwd_attn_kernel(const bf16* __restrict__ dattn, const bf16* __restrict__ q,
                    const bf16* __restrict__ k, const bf16* __restrict__ v,
                    const bf16* __restrict__ p, bf16* __restrict__ o,
                    bf16* __restrict__ dqkv, float* __restrict__ dbias_part,
                    float* __restrict__ dbqkv_part, int Bw, int C, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* dps = reinterpret_cast<float*>(smem);
  bf16* dsb = reinterpret_cast<bf16*>(smem);
  float* dba = reinterpret_cast<float*>(smem + DP_BYTES);
  bf16* qs = reinterpret_cast<bf16*>(smem + 2 * DP_BYTES);
  bf16* ks = reinterpret_cast<bf16*>(smem + 2 * DP_BYTES + HT_BYTES);
  bf16* vs = reinterpret_cast<bf16*>(smem + 2 * DP_BYTES + 2 * HT_BYTES);
  bf16* dos = reinterpret_cast<bf16*>(smem + 2 * DP_BYTES + 3 * HT_BYTES);
  float* st = reinterpret_cast<float*>(smem + 2 * DP_BYTES + 4 * HT_BYTES);
  float* bsum = reinterpret_cast<float*>(smem + 2 * DP_BYTES + 4 * HT_BYTES + STG_BYTES);

  const int g = blockIdx.x, G = gridDim.x, h = blockIdx.y, heads = gridDim.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int C3 = 3 * C;
  for (int i = threadIdx.x; i < bN * bN; i += bThreads) dba[i] = 0.f;
  for (int i = threadIdx.x; i < 3 * bHD; i += bThreads) bsum[i] = 0.f;

  for (int win = g; win < Bw; win += G) {
    const size_t row0 = static_cast<size_t>(win) * bN;
    // 1. the head's q, k, v and do columns -> shared memory
    for (int i = threadIdx.x; i < 4 * bN * (bHD / 8); i += bThreads) {
      const int t = i / (bN * (bHD / 8)), r = (i / (bHD / 8)) % bN, d = (i % (bHD / 8)) * 8;
      const bf16* src = t == 0 ? q : t == 1 ? k : t == 2 ? v : dattn;
      bf16* dst = t == 0 ? qs : t == 1 ? ks : t == 2 ? vs : dos;
      *reinterpret_cast<uint4*>(dst + r * bHD + d) = *reinterpret_cast<const uint4*>(
          src + (row0 + r) * C + h * bHD + d);
    }
    __syncthreads();
    const bf16* pw = p + (static_cast<size_t>(win) * heads + h) * bN * bN;

    // 2. o = P v -> bf16 o (the out-projection weight grad's input)
    for (int t = warp; t < 18; t += bWarps) {
      const int r = t / 2, c = t % 2;
      FragC acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll 3
      for (int kk = 0; kk < bN; kk += 16) {
        FragA a;
        FragBRow b;
        wmma::load_matrix_sync(a, pw + r * 16 * bN + kk, bN);
        wmma::load_matrix_sync(b, vs + kk * bHD + c * 16, bHD);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(st + r * 16 * LDT + c * 16, acc, LDT, wmma::mem_row_major);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < bN * (bHD / 8); i += bThreads) {
      const int r = i / (bHD / 8), d = (i % (bHD / 8)) * 8;
      *reinterpret_cast<uint4*>(o + (row0 + r) * C + h * bHD + d) = pack8(st + r * LDT + d);
    }
    __syncthreads();

    // 3. dv = P^T do
    for (int t = warp; t < 18; t += bWarps) {
      const int r = t / 2, c = t % 2;
      FragC acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll 3
      for (int kk = 0; kk < bN; kk += 16) {
        FragACol a;  // A(i, k) = P[kk + k][16 r + i]
        FragBRow b;
        wmma::load_matrix_sync(a, pw + kk * bN + r * 16, bN);
        wmma::load_matrix_sync(b, dos + kk * bHD + c * 16, bHD);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(st + r * 16 * LDT + c * 16, acc, LDT, wmma::mem_row_major);
    }
    __syncthreads();
    finish_part(st, dqkv + row0 * C3 + 2 * C + h * bHD, C3, bsum + 2 * bHD);
    __syncthreads();

    // 4. dp = do v^T (f32, 144 x 144)
    for (int t = warp; t < 81; t += bWarps) {
      const int r = t / 9, c = t % 9;
      FragC acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < bHD; kk += 16) {
        FragA a;
        FragBCol b;
        wmma::load_matrix_sync(a, dos + r * 16 * bHD + kk, bHD);
        wmma::load_matrix_sync(b, vs + c * 16 * bHD + kk, bHD);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(dps + r * 16 * LDSF + c * 16, acc, LDSF, wmma::mem_row_major);
    }
    __syncthreads();

    // 5. ds = P (dp - rowsum(dp P)) in f32; dbias += ds; bf16 ds over the
    //    first half of the row's own f32 storage (each warp owns whole
    //    rows and reads a row fully before it writes)
    for (int r = warp; r < bN; r += bWarps) {
      float pv[5], dv[5];
      float rs = 0.f;
#pragma unroll
      for (int t = 0; t < 5; ++t) {
        const int j = lane + 32 * t;
        pv[t] = j < bN ? to_f(pw[r * bN + j]) : 0.f;
        dv[t] = j < bN ? dps[r * LDSF + j] : 0.f;
        rs += pv[t] * dv[t];
      }
      rs = warp_sum(rs);
      __syncwarp();
#pragma unroll
      for (int t = 0; t < 5; ++t) {
        const int j = lane + 32 * t;
        if (j < bN) {
          const float ds = pv[t] * (dv[t] - rs);
          dba[r * bN + j] += ds;
          dsb[r * LDSB + j] = to_bf(ds);
        }
      }
    }
    __syncthreads();

    // 6. dq = ds k * scale (q was saved post-scale)
    for (int t = warp; t < 18; t += bWarps) {
      const int r = t / 2, c = t % 2;
      FragC acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll 3
      for (int kk = 0; kk < bN; kk += 16) {
        FragA a;
        FragBRow b;
        wmma::load_matrix_sync(a, dsb + r * 16 * LDSB + kk, LDSB);
        wmma::load_matrix_sync(b, ks + kk * bHD + c * 16, bHD);
        wmma::mma_sync(acc, a, b, acc);
      }
#pragma unroll
      for (int e = 0; e < acc.num_elements; ++e) acc.x[e] *= scale;
      wmma::store_matrix_sync(st + r * 16 * LDT + c * 16, acc, LDT, wmma::mem_row_major);
    }
    __syncthreads();
    finish_part(st, dqkv + row0 * C3 + h * bHD, C3, bsum);
    __syncthreads();

    // 7. dk = ds^T q
    for (int t = warp; t < 18; t += bWarps) {
      const int r = t / 2, c = t % 2;
      FragC acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll 3
      for (int kk = 0; kk < bN; kk += 16) {
        FragACol a;  // A(i, k) = ds[kk + k][16 r + i]
        FragBRow b;
        wmma::load_matrix_sync(a, dsb + kk * LDSB + r * 16, LDSB);
        wmma::load_matrix_sync(b, qs + kk * bHD + c * 16, bHD);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(st + r * 16 * LDT + c * 16, acc, LDT, wmma::mem_row_major);
    }
    __syncthreads();
    finish_part(st, dqkv + row0 * C3 + C + h * bHD, C3, bsum + bHD);
    __syncthreads();
  }

  float* dbp = dbias_part + (static_cast<size_t>(g) * heads + h) * bN * bN;
  for (int i = threadIdx.x; i < bN * bN; i += bThreads) dbp[i] = dba[i];
  for (int i = threadIdx.x; i < 3 * bHD; i += bThreads) {
    const int part = i / bHD, d = i % bHD;
    dbqkv_part[static_cast<size_t>(g) * C3 + part * C + h * bHD + d] = bsum[i];
  }
}

// out (M x N) = sum_k A(m, k) B(k, n), bf16 in, f32 accumulate.
// AK: A is stored k-major (K x M row-major, i.e. A^T), else M x K row-major.
// BN: B is stored n-major (N x K row-major, a torch Linear weight), else
// K x N row-major.  grid (N/64, M/64, splits): split z sums k in
// [z k_chunk, (z + 1) k_chunk) and writes its f32 partial to
// out_f + z M N; with out_b (one split) the result, plus bias[n] when
// bias is given, is rounded to bf16.
// M, N, K, lda, ldb and k_chunk are multiples of 8 (16-byte loads); tiles
// past the edges are zero-filled.  64 x 64 block tile, four warps of
// 32 x 32, k in steps of 32.
constexpr int kTM = 64, kTK = 32;

template <bool AK, bool BN>
__global__ void __launch_bounds__(128)
gemm_bf16_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B,
                 const bf16* __restrict__ bias, float* __restrict__ out_f,
                 bf16* __restrict__ out_b, int M, int N, int K, int lda, int ldb,
                 int k_chunk) {
  constexpr int LDA = AK ? kTM + 8 : kTK + 8;
  constexpr int LDB = BN ? kTK + 8 : kTM + 8;
  constexpr int LDC = kTM + 4;
  __shared__ __align__(128) bf16 as[kTM * (kTK + 8)];
  __shared__ __align__(128) bf16 bs[kTM * (kTK + 8)];
  __shared__ __align__(128) float cs[kTM * LDC];
  static_assert(kTK * (kTM + 8) <= kTM * (kTK + 8), "k-major tiles fit");

  const int bm = blockIdx.y * kTM, bn = blockIdx.x * kTM, z = blockIdx.z;
  const int k_lo = z * k_chunk, k_hi = min(K, k_lo + k_chunk);
  const int warp = threadIdx.x >> 5, wr = warp / 2, wc = warp % 2;
  const uint4 zero = make_uint4(0, 0, 0, 0);
  FragC acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = k_lo; k0 < k_hi; k0 += kTK) {
    for (int i = threadIdx.x; i < kTM * kTK / 8; i += 128) {
      if (!AK) {  // 64 (m) x 32 (k)
        const int r = i / (kTK / 8), c = (i % (kTK / 8)) * 8;
        uint4 val = zero;
        if (bm + r < M && k0 + c < k_hi)
          val = *reinterpret_cast<const uint4*>(A + static_cast<size_t>(bm + r) * lda + k0 + c);
        *reinterpret_cast<uint4*>(as + r * LDA + c) = val;
      } else {  // 32 (k) x 64 (m)
        const int r = i / (kTM / 8), c = (i % (kTM / 8)) * 8;
        uint4 val = zero;
        if (k0 + r < k_hi && bm + c < M)
          val = *reinterpret_cast<const uint4*>(A + static_cast<size_t>(k0 + r) * lda + bm + c);
        *reinterpret_cast<uint4*>(as + r * LDA + c) = val;
      }
      if (!BN) {  // 32 (k) x 64 (n)
        const int r = i / (kTM / 8), c = (i % (kTM / 8)) * 8;
        uint4 val = zero;
        if (k0 + r < k_hi && bn + c < N)
          val = *reinterpret_cast<const uint4*>(B + static_cast<size_t>(k0 + r) * ldb + bn + c);
        *reinterpret_cast<uint4*>(bs + r * LDB + c) = val;
      } else {  // 64 (n) x 32 (k)
        const int r = i / (kTK / 8), c = (i % (kTK / 8)) * 8;
        uint4 val = zero;
        if (bn + r < N && k0 + c < k_hi)
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
    if (bm + r < M && bn + c < N) {
      const size_t off = static_cast<size_t>(bm + r) * N + bn + c;
      if (out_b != nullptr)
        out_b[off] = to_bf(cs[r * LDC + c] + (bias != nullptr ? to_f(bias[bn + c]) : 0.f));
      else
        out_f[static_cast<size_t>(z) * M * N + off] = cs[r * LDC + c];
    }
  }
}

// out[i] = sum over s of part[s n + i], s in order (deterministic).
__global__ void sum_partials_kernel(const float* __restrict__ part, float* __restrict__ out,
                                    int parts, size_t n) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (int j = 0; j < parts; ++j) s += part[static_cast<size_t>(j) * n + i];
    out[i] = s;
  }
}

// part[z cols + c] = sum of x[r, c] (f32) over rows r of split z; grid
// (ceil(cols / 256), splits).
__global__ void colsum_bf16_kernel(const bf16* __restrict__ x, float* __restrict__ part, int rows,
                                   int cols, int rows_per_split) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= cols) return;
  const int r0 = blockIdx.y * rows_per_split, r1 = min(rows, r0 + rows_per_split);
  float s = 0.f;
  for (int r = r0; r < r1; ++r) s += to_f(x[static_cast<size_t>(r) * cols + c]);
  part[static_cast<size_t>(blockIdx.y) * cols + c] = s;
}

}  // namespace lavt

extern "C" int lavt_msa_bwd_attn(const void* dattn, const void* q, const void* k,
                                 const void* v, const void* p, void* o, void* dqkv,
                                 void* dbias_part, void* dbqkv_part, int Bw, int C,
                                 int heads, int groups, float scale, void* stream) {
  using namespace lavt;
  cudaError_t err = allow_smem(msa_bwd_attn_kernel, BWD_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  msa_bwd_attn_kernel<<<dim3(groups, heads), bThreads, BWD_SMEM,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(dattn), static_cast<const bf16*>(q),
      static_cast<const bf16*>(k), static_cast<const bf16*>(v), static_cast<const bf16*>(p),
      static_cast<bf16*>(o), static_cast<bf16*>(dqkv), static_cast<float*>(dbias_part),
      static_cast<float*>(dbqkv_part), Bw, C, scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lavt_gemm_bf16(const void* a, const void* b, const void* bias, void* out_f,
                              void* out_b, int M, int N, int K, int lda, int ldb, int a_kmajor,
                              int b_nmajor, int splits, int k_chunk, void* stream) {
  using namespace lavt;
  dim3 grid((N + kTM - 1) / kTM, (M + kTM - 1) / kTM, splits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* A = static_cast<const bf16*>(a);
  const bf16* B = static_cast<const bf16*>(b);
  const bf16* bi = static_cast<const bf16*>(bias);
  float* of = static_cast<float*>(out_f);
  bf16* ob = static_cast<bf16*>(out_b);
  if (a_kmajor && b_nmajor)
    gemm_bf16_kernel<true, true><<<grid, 128, 0, s>>>(A, B, bi, of, ob, M, N, K, lda, ldb, k_chunk);
  else if (a_kmajor)
    gemm_bf16_kernel<true, false><<<grid, 128, 0, s>>>(A, B, bi, of, ob, M, N, K, lda, ldb, k_chunk);
  else if (b_nmajor)
    gemm_bf16_kernel<false, true><<<grid, 128, 0, s>>>(A, B, bi, of, ob, M, N, K, lda, ldb, k_chunk);
  else
    gemm_bf16_kernel<false, false><<<grid, 128, 0, s>>>(A, B, bi, of, ob, M, N, K, lda, ldb, k_chunk);
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
  const int per = (rows + splits - 1) / splits;
  colsum_bf16_kernel<<<dim3((cols + 255) / 256, splits), 256, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<float*>(part), rows, cols, per);
  return static_cast<int>(cudaGetLastError());
}
