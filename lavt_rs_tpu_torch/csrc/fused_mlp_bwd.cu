// K7: backward of the LayerNorm -> fc1 -> GELU -> fc2 (-> DropPath) ->
// residual tail (K3 / K8).
//
// Replaces lavt_rs_tpu/ops/pallas/fused_mlp.py:_bwd/_bwd_kernel (:477) and
// _bwd_hsplit/_bwd_kernel_hsplit (:330).  With the two-pass LN recomputed
// from x, xn = LN(x) (bf16), hpre = xn W1^T + b1 (f32), h = gelu(hpre),
// dmlp = bf16(gy keep) (keep = 1 without DropPath), it computes with the
// TPU kernel's rounding points (h and dhpre rounded to bf16 before their
// GEMMs):
//   dh = dmlp W2,  dhpre = dh gelu'(hpre),  dyln = dhpre W1
//   dW2 = dmlp^T h,  db2 = sum gy keep,  dW1 = dhpre^T xn,  db1 = sum dhpre
//   dgamma = sum dyln xhat,  dbeta = sum dyln
//   dx = gy + LN backward of dyln   (the residual passes gy unscaled)
//
// Bound on the H100: operations.  Five GEMMs of 2 M C 4C (hpre
// recomputed, dh, dW2, dW1, dyln) = 40 M C^2 = 75.5 GFLOP a call at every
// Swin-B stage (M C^2 = 1.887e9), 0.0763 ms at 989 TFLOP/s, against
// ~0.004 ms for x, gy, dx and the weights and their grads at 3.35 TB/s.
//
// Launches (the wrapper allocates every buffer; the kernels allocate
// nothing):
//   (a) mlp_bwd_prep_kernel: one warp per row, xn (bf16), (mu, rstd) f32
//       and dmlp = bf16(gy keep);
//   (b) the GEMM core (gemm_sm90.cuh) as a dual GEMM over one (row tile,
//       hidden tile): hpre = xn W1^T and dh = dmlp W2 (W2 read MN-major)
//       in two accumulators; its epilogue writes h = bf16(gelu(hpre + b1))
//       and dhpre = bf16(dh gelu'(hpre + b1)) and the tile's column sums of
//       the f32 dhpre (db1 partials).  hpre never leaves the registers;
//   (c) dW2 = dmlp^T h and dW1 = dhpre^T xn: the core with K = M (both
//       operands MN-major), split over M into f32 partials that
//       lavt_sum_partials adds in a fixed order (deterministic, no atomics);
//   (d) dyln = dhpre W1 (W1 MN-major), f32 (M, C);
//   (e) ln_bwd_rows_kernel: dx = gy + rstd (dxhat - mean(dxhat) - xhat
//       mean(dxhat xhat)), dxhat = dyln gamma, one warp per row; per
//       64-row block the column partials of dyln xhat, dyln and gy keep
//       (dgamma, dbeta, db2).
// The partials are added in a fixed order by lavt_sum_partials
// (fused_msa_bwd.cu), dW1 with dW2 and dgamma with dbeta and db2 in one
// launch each.  The TPU kernel keeps the hidden and its gradient in
// VMEM; here h and dhpre (M, 4C) make one round trip through L2/HBM (at
// most 4 x 29.5 MB a call, ~0.04 ms) so that every GEMM runs on 128 x 128
// tiles that read each operand once through the TMA ring (the earlier WMMA
// design recomputed hpre/h/dh per 64-wide hidden slice for every row tile
// and read-modify-wrote its f32 partials through L2).
//
// GEMM core: as K3's (a 128 x 128 tile per consumer warpgroup in
// ping-pong, 4 stages of 32 KB; the dual GEMM a 64 x 128 tile with two
// accumulators, 5 stages of 24 KB, a segment's xn or dmlp 8 KB and W1 or
// W2 16 KB; 128 accumulator registers a thread either way).  -Xptxas -v
// (CUDA 12.8, on an H100): every gemm_kernel 168 registers at launch
// (setmaxnreg: 232 for the consumers), 0 bytes spilled;
// mlp_bwd_prep_kernel 27-77 and ln_bwd_rows_kernel 40-251 registers
// (C = 128 ... 1024), 0 spilled.

#include "common.cuh"
#include "gemm_sm90.cuh"

namespace lavt {

using sm90::GemmParams;

constexpr int kLnBwdRows = 64;  // rows per block of ln_bwd_rows_kernel

// (a) one warp per row: xn, (mu, rstd), dmlp = bf16(gy keep)
template <int C>
__global__ void __launch_bounds__(256)
    mlp_bwd_prep_kernel(const bf16* __restrict__ x, const bf16* __restrict__ gy,
                        const bf16* __restrict__ gamma, const bf16* __restrict__ beta,
                        const float* __restrict__ keep, int rows_per_sample,
                        bf16* __restrict__ xn, float* __restrict__ stats,
                        bf16* __restrict__ dmlp, int M, float eps) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= M) return;
  const size_t off = static_cast<size_t>(row) * C;
  const float2 st = ln_row_two_pass<C>(x + off, gamma, beta, eps, xn + off);
  if (lane == 0) reinterpret_cast<float2*>(stats)[row] = st;
  const float kp = keep != nullptr ? keep[row / rows_per_sample] : 1.f;
  const auto* g2 = reinterpret_cast<const __nv_bfloat162*>(gy + off);
  auto* d2 = reinterpret_cast<__nv_bfloat162*>(dmlp + off);
#pragma unroll
  for (int t = 0; t < C / 64; ++t) {
    const float2 g = __bfloat1622float2(g2[lane + 32 * t]);
    d2[lane + 32 * t] = __floats2bfloat162_rn(g.x * kp, g.y * kp);
  }
}

// (b) h = bf16(gelu(hpre)), dhpre = bf16(dh gelu'(hpre)), hpre = acc + b1,
// staged for the TMA stores (h at out, dhpre at out + 16 KB);
// db1_part[row tile, col] = the 64-row tile's column sums of the f32 dhpre
struct EpiDualGeluBwd {
  static constexpr int kStaged = 2, kStagedIn = 0;
  static constexpr int kBNPairs = sm90::kBN / 4;  // a thread's columns: two of each 8
  struct Args {
    const bf16* b1;
    float* db1_part;
    int M, N;
  };
  static __device__ __forceinline__ void store(const Args& a, float (&hp)[64], float (&dh)[64],
                                               int row0, int col0, float* red,
                                               unsigned char* out) {
    float cs[kBNPairs];
#pragma unroll
    for (int j = 0; j < sm90::kBN / 8; ++j) {
      const int c = sm90::frag_col(0, j);
      const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(a.b1 + col0 + c));
      cs[2 * j] = cs[2 * j + 1] = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = sm90::frag_row(0, h), i = 4 * j + 2 * h;
        const float v0 = hp[i] + b.x, v1 = hp[i + 1] + b.y;
        float p0, p1;
        const float c0 = gelu_cdf_pdf(v0, &p0), c1 = gelu_cdf_pdf(v1, &p1);
        const float d0 = dh[i] * (c0 + v0 * p0), d1 = dh[i + 1] * (c1 + v1 * p1);
        sm90::stage_pair(out, r, c, __floats2bfloat162_rn(v0 * c0, v1 * c1));
        sm90::stage_pair(out + 2 * sm90::kBoxBytes, r, c, __floats2bfloat162_rn(d0, d1));
        if (row0 + r < a.M) {
          cs[2 * j] += d0;
          cs[2 * j + 1] += d1;
        }
      }
    }
    // the warp's 16 rows (lanes with one lane % 4 share columns), then the
    // consumer's 4 warps in order, on its own named barrier (the core's
    // barrier before the epilogue keeps the previous tile's sums until read)
    const int warp = threadIdx.x % 128 / 32, lane = threadIdx.x % 32;
#pragma unroll
    for (int i = 0; i < kBNPairs; ++i) {
      cs[i] += __shfl_xor_sync(0xffffffffu, cs[i], 4);
      cs[i] += __shfl_xor_sync(0xffffffffu, cs[i], 8);
      cs[i] += __shfl_xor_sync(0xffffffffu, cs[i], 16);
    }
    if (lane < 4) {
#pragma unroll
      for (int j = 0; j < sm90::kBN / 8; ++j) {
        red[warp * sm90::kBN + 8 * j + 2 * lane] = cs[2 * j];
        red[warp * sm90::kBN + 8 * j + 2 * lane + 1] = cs[2 * j + 1];
      }
    }
    sm90::named_sync(1 + threadIdx.x / 128);
    const int t = threadIdx.x % 128;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) s += red[w * sm90::kBN + t];
    a.db1_part[static_cast<size_t>(row0 / 64) * a.N + col0 + t] = s;
  }
};

// (c), (d) f32 (M, N) per split z at out + z split_stride, rows < M and
// columns < N only (K5's weight grads have N = 96 and 288: ragged tiles)
struct EpiStoreF32 {
  struct Args {
    float* out;
    int M, N;
    long long split_stride;
  };
  static constexpr int kStaged = 0, kStagedIn = 0;
  static __device__ __forceinline__ void store(const Args& a, float (&acc)[64], float (&)[1],
                                               int row0, int col0, float*, unsigned char*) {
    float* out = a.out + blockIdx.z * a.split_stride;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = sm90::frag_row(row0, h);
      if (row >= a.M) continue;
#pragma unroll
      for (int j = 0; j < sm90::kBN / 8; ++j) {
        const int col = sm90::frag_col(col0, j);  // even; N is even
        if (col < a.N)
          *reinterpret_cast<float2*>(out + static_cast<size_t>(row) * a.N + col) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
  }
};

// (e) dx and the column partials of a 64-row block (8 rows a warp, the
// warps' sums added in order): part[block] = (sum dyln xhat, sum dyln,
// sum gy keep), the dgamma, dbeta and db2 partials
template <int C>
__global__ void __launch_bounds__(256)
    ln_bwd_rows_kernel(const float* __restrict__ dyln, const bf16* __restrict__ x,
                       const bf16* __restrict__ gy, const bf16* __restrict__ gamma,
                       const float* __restrict__ keep, int rows_per_sample,
                       const float* __restrict__ stats, bf16* __restrict__ dx,
                       float* __restrict__ part, int M) {
  constexpr int P = C / 64;
  __shared__ float red[3][C];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const auto* g2 = reinterpret_cast<const __nv_bfloat162*>(gamma);
  float2 gm[P], acc[3][P];
#pragma unroll
  for (int t = 0; t < P; ++t) {
    gm[t] = __bfloat1622float2(g2[lane + 32 * t]);
    acc[0][t] = acc[1][t] = acc[2][t] = make_float2(0.f, 0.f);
  }
  for (int r = warp; r < kLnBwdRows; r += 8) {
    const int row = blockIdx.x * kLnBwdRows + r;
    if (row >= M) break;
    const size_t off = static_cast<size_t>(row) * C;
    const float2 st = reinterpret_cast<const float2*>(stats)[row];
    const float kp = keep != nullptr ? keep[row / rows_per_sample] : 1.f;
    const auto* x2 = reinterpret_cast<const __nv_bfloat162*>(x + off);
    const auto* d2 = reinterpret_cast<const float2*>(dyln + off);
    float2 xh[P], dxh[P];
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int t = 0; t < P; ++t) {
      const float2 xv = __bfloat1622float2(x2[lane + 32 * t]);
      const float2 d = d2[lane + 32 * t];
      xh[t] = make_float2((xv.x - st.x) * st.y, (xv.y - st.x) * st.y);
      dxh[t] = make_float2(d.x * gm[t].x, d.y * gm[t].y);
      m1 += dxh[t].x + dxh[t].y;
      m2 += dxh[t].x * xh[t].x + dxh[t].y * xh[t].y;
      acc[0][t].x += d.x * xh[t].x;
      acc[0][t].y += d.y * xh[t].y;
      acc[1][t].x += d.x;
      acc[1][t].y += d.y;
    }
    m1 = warp_sum(m1) / C;
    m2 = warp_sum(m2) / C;
    const auto* gy2 = reinterpret_cast<const __nv_bfloat162*>(gy + off);
    auto* dx2 = reinterpret_cast<__nv_bfloat162*>(dx + off);
#pragma unroll
    for (int t = 0; t < P; ++t) {
      const float2 g = __bfloat1622float2(gy2[lane + 32 * t]);
      acc[2][t].x += g.x * kp;
      acc[2][t].y += g.y * kp;
      dx2[lane + 32 * t] =
          __floats2bfloat162_rn(g.x + st.y * (dxh[t].x - m1 - xh[t].x * m2),
                                g.y + st.y * (dxh[t].y - m1 - xh[t].y * m2));
    }
  }
  for (int w = 0; w < 8; ++w) {
    if (warp == w) {
#pragma unroll
      for (int q = 0; q < 3; ++q)
#pragma unroll
        for (int t = 0; t < P; ++t) {
          const int c = 2 * (lane + 32 * t);
          red[q][c] = (w == 0 ? 0.f : red[q][c]) + acc[q][t].x;
          red[q][c + 1] = (w == 0 ? 0.f : red[q][c + 1]) + acc[q][t].y;
        }
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < 3 * C; i += 256)
    part[static_cast<size_t>(blockIdx.x) * 3 * C + i] = red[i / C][i % C];
}

#define LAVT_MLP_WIDTHS(X) X(128) X(256) X(384) X(512) X(1024)

cudaError_t mlp_bwd_prep(const void* x, const void* gy, const void* g, const void* be,
                         const void* keep, void* xn, void* stats, void* dmlp, int M, int C,
                         int rows_per_sample, float eps, cudaStream_t s) {
  const int blocks = (M + 7) / 8;
  switch (C) {
#define LAVT_CASE(CC)                                                                         \
  case CC:                                                                                    \
    mlp_bwd_prep_kernel<CC><<<blocks, 256, 0, s>>>(                                           \
        static_cast<const bf16*>(x), static_cast<const bf16*>(gy), static_cast<const bf16*>(g), \
        static_cast<const bf16*>(be), static_cast<const float*>(keep), rows_per_sample,       \
        static_cast<bf16*>(xn), static_cast<float*>(stats), static_cast<bf16*>(dmlp), M, eps); \
    break;
    LAVT_MLP_WIDTHS(LAVT_CASE)
#undef LAVT_CASE
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

cudaError_t dual_gemm_gelu_bwd(const void* xn, const void* dmlp, const void* w1, const void* b1,
                               const void* w2, void* h, void* dhpre, void* db1_part, int M, int C,
                               int hidden, cudaStream_t s) {
  GemmParams<EpiDualGeluBwd::Args> p;
  cudaError_t err = sm90::map_a<1>(&p.a0, xn, C, M, false);
  if (err == cudaSuccess) err = sm90::map_b(&p.b0, w1, C, hidden, false);
  if (err == cudaSuccess) err = sm90::map_a<1>(&p.a1, dmlp, C, M, false);
  if (err == cudaSuccess) err = sm90::map_b(&p.b1, w2, hidden, C, true);
  if (err == cudaSuccess) err = sm90::map_out(&p.c0, h, hidden, M);
  if (err == cudaSuccess) err = sm90::map_out(&p.c1, dhpre, hidden, M);
  if (err != cudaSuccess) return err;
  p.k_tiles = p.k_tiles_per_split = C / sm90::kBK;
  p.epi = {static_cast<const bf16*>(b1), static_cast<float*>(db1_part), M, hidden};
  return sm90::launch_gemm<EpiDualGeluBwd, 1, false, false, true, false, true>(p, M, hidden, 1,
                                                                              s);
}

// part + z stride = a[rows of split z]^T b[rows of split z]: a (M, na), b
// (M, nb) bf16 -> f32 (na, nb) per split; split z takes k-tiles
// [z kps, (z + 1) kps)
cudaError_t wgrad(const void* a, const void* b, void* part, int M, int na, int nb, int splits,
                  int k_tiles_per_split, long long split_stride, cudaStream_t s) {
  GemmParams<EpiStoreF32::Args> p;
  cudaError_t err = sm90::map_a<2>(&p.a0, a, na, M, true);
  if (err == cudaSuccess) err = sm90::map_b(&p.b0, b, nb, M, true);
  if (err != cudaSuccess) return err;
  p.k_tiles = (M + sm90::kBK - 1) / sm90::kBK;
  p.k_tiles_per_split = k_tiles_per_split;
  p.epi = {static_cast<float*>(part), na, nb, split_stride};
  return sm90::launch_gemm<EpiStoreF32, 2, true, true>(p, na, nb, splits, s);
}

cudaError_t dgrad(const void* dhpre, const void* w1, void* dyln, int M, int C, int hidden,
                  cudaStream_t s) {
  GemmParams<EpiStoreF32::Args> p;
  cudaError_t err = sm90::map_a<2>(&p.a0, dhpre, hidden, M, false);
  if (err == cudaSuccess) err = sm90::map_b(&p.b0, w1, C, hidden, true);
  if (err != cudaSuccess) return err;
  p.k_tiles = p.k_tiles_per_split = hidden / sm90::kBK;
  p.epi = {static_cast<float*>(dyln), M, C, 0};
  return sm90::launch_gemm<EpiStoreF32, 2, false, true>(p, M, C, 1, s);
}

cudaError_t ln_bwd_rows(const void* dyln, const void* x, const void* gy, const void* g,
                        const void* keep, int rows_per_sample, const void* stats, void* dx,
                        void* part, int M, int C, cudaStream_t s) {
  const int blocks = (M + kLnBwdRows - 1) / kLnBwdRows;
  switch (C) {
#define LAVT_CASE(CC)                                                                         \
  case CC:                                                                                    \
    ln_bwd_rows_kernel<CC><<<blocks, 256, 0, s>>>(                                            \
        static_cast<const float*>(dyln), static_cast<const bf16*>(x),                         \
        static_cast<const bf16*>(gy), static_cast<const bf16*>(g),                            \
        static_cast<const float*>(keep), rows_per_sample, static_cast<const float*>(stats),  \
        static_cast<bf16*>(dx), static_cast<float*>(part), M);                                \
    break;
    LAVT_MLP_WIDTHS(LAVT_CASE)
#undef LAVT_CASE
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace lavt

// Each launch alone (for its test and its time), then K7 as all of them.
extern "C" int lavt_mlp_bwd_prep(const void* x, const void* gy, const void* g, const void* be,
                                 const void* keep, void* xn, void* stats, void* dmlp, int M,
                                 int C, int rows_per_sample, float eps, void* stream) {
  return static_cast<int>(lavt::mlp_bwd_prep(x, gy, g, be, keep, xn, stats, dmlp, M, C,
                                             rows_per_sample, eps,
                                             static_cast<cudaStream_t>(stream)));
}

extern "C" int lavt_dual_gemm_gelu_bwd(const void* xn, const void* dmlp, const void* w1,
                                       const void* b1, const void* w2, void* h, void* dhpre,
                                       void* db1_part, int M, int C, int hidden, void* stream) {
  return static_cast<int>(lavt::dual_gemm_gelu_bwd(xn, dmlp, w1, b1, w2, h, dhpre, db1_part, M,
                                                   C, hidden, static_cast<cudaStream_t>(stream)));
}

extern "C" int lavt_wgrad(const void* a, const void* b, void* part, int M, int na, int nb,
                          int splits, int k_tiles_per_split, void* stream) {
  return static_cast<int>(lavt::wgrad(a, b, part, M, na, nb, splits, k_tiles_per_split,
                                      static_cast<long long>(na) * nb,
                                      static_cast<cudaStream_t>(stream)));
}

extern "C" int lavt_dgrad(const void* dhpre, const void* w1, void* dyln, int M, int C,
                          int hidden, void* stream) {
  return static_cast<int>(
      lavt::dgrad(dhpre, w1, dyln, M, C, hidden, static_cast<cudaStream_t>(stream)));
}

extern "C" int lavt_ln_bwd_rows(const void* dyln, const void* x, const void* gy, const void* g,
                                const void* keep, int rows_per_sample, const void* stats,
                                void* dx, void* part, int M, int C, void* stream) {
  return static_cast<int>(lavt::ln_bwd_rows(dyln, x, gy, g, keep, rows_per_sample, stats, dx,
                                            part, M, C, static_cast<cudaStream_t>(stream)));
}

extern "C" int lavt_mlp_bwd(const void* x, const void* gy, const void* g, const void* be,
                            const void* w1, const void* b1, const void* w2, const void* keep,
                            int rows_per_sample, void* xn, void* dmlp, void* h, void* dhpre,
                            void* dx, void* dyln, void* db1_part, void* dw_part, void* ln_part,
                            void* stats, int M, int C, int hidden, int splits,
                            int k_tiles_per_split, float eps, void* stream) {
  using namespace lavt;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // dw_part: (splits, 2, hidden C), dW1 then dW2 (C, hidden) in each split
  const long long wsize = static_cast<long long>(hidden) * C;
  float* dw1 = static_cast<float*>(dw_part);
  cudaError_t err = mlp_bwd_prep(x, gy, g, be, keep, xn, stats, dmlp, M, C, rows_per_sample,
                                 eps, s);
  if (err == cudaSuccess)
    err = dual_gemm_gelu_bwd(xn, dmlp, w1, b1, w2, h, dhpre, db1_part, M, C, hidden, s);
  if (err == cudaSuccess)
    err = wgrad(dmlp, h, dw1 + wsize, M, C, hidden, splits, k_tiles_per_split, 2 * wsize, s);
  if (err == cudaSuccess)
    err = wgrad(dhpre, xn, dw1, M, hidden, C, splits, k_tiles_per_split, 2 * wsize, s);
  if (err == cudaSuccess) err = dgrad(dhpre, w1, dyln, M, C, hidden, s);
  if (err == cudaSuccess)
    err = ln_bwd_rows(dyln, x, gy, g, keep, rows_per_sample, stats, dx, ln_part, M, C, s);
  return static_cast<int>(err);
}
