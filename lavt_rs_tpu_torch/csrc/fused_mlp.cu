// K3: fused LayerNorm -> fc1 -> exact GELU -> fc2 -> + residual.
//
// Replaces lavt_rs_tpu/ops/pallas/fused_mlp.py:fused_ln_mlp (_fwd/_kernel),
// the tail of every Swin block: out = x + fc2(gelu(fc1(LN(x)))), with the
// two-pass LayerNorm ((x - mu)^2, eps inside rsqrt) and erf GELU.
//
// Bound on the H100: the two GEMMs (4 * M * C * 4C flops) against one read
// and one write of the (M, C) activation; unfused, the (M, 4C) hidden
// activation would cost 8x the activation's bytes in device memory.
// Design: a block owns BM rows (BM = 64/64/32/16 at C = 128/256/512/1024).
// It normalizes its rows into shared memory as bf16, then walks the hidden dimension in chunks of 128: fc1 chunk on the
// tensor cores (WMMA bf16, f32 accumulate), + b1 and GELU in f32, the bf16
// chunk back to shared memory, and the chunk's fc2 product accumulated in
// registers (four or eight 16x16 f32 tiles per warp).  The hidden
// activation never leaves the SM.  The epilogue adds b2 and the residual x
// one 16x16 tile at a time through a per-warp scratch, so the block needs
// no (BM, C) f32 staging: 46-85 KB of shared memory and at most 128
// registers a thread let two blocks share an SM.  Weights are read
// straight from device memory through L1/L2 (no TMA, no wgmma yet).
//
// K8 (DropPath) is the same kernel with a per-sample keep scale: it replaces
// fused_mlp.py:fused_ln_mlp_droppath (_fwd with keep_rows) and computes
// out = x + keep[row / rows_per_sample] * fc2(gelu(fc1(LN(x)))), keep (B,) f32.

#include "common.cuh"

namespace lavt {

constexpr int kMlpThreads = 256;
constexpr int kMlpBH = 128;  // hidden chunk

template <int C>
struct MlpShape {
  static constexpr int BM = C <= 256 ? 64 : 16384 / C;
  static constexpr int NR = BM / 16;
  static constexpr int NC = C / 16;
  static constexpr int TPW = NR * NC / 8;    // output tiles per warp
  static constexpr int LDX = C + 8;          // bf16, normalized rows
  static constexpr int LDH = kMlpBH + 4;     // f32, fc1 chunk accumulators
  static constexpr int LDHB = kMlpBH + 8;    // bf16, GELU chunk
  static constexpr size_t XN_BYTES = align128(size_t(BM) * LDX * 2);
  static constexpr size_t U_BYTES = align128(size_t(BM) * LDH * 4);
  static constexpr size_t HB_BYTES = align128(size_t(BM) * LDHB * 2);
  static constexpr size_t SMEM = XN_BYTES + U_BYTES + HB_BYTES;
  static_assert(NR * NC % 8 == 0 && TPW <= 8, "output tiles split over 8 warps");
  static_assert(U_BYTES >= 8 * 256 * 4, "per-warp epilogue scratch fits H");
  static_assert(SMEM <= 113 * 1024, "two blocks per SM");
};

template <int C>
__global__ void __launch_bounds__(kMlpThreads, 2)
fused_ln_mlp_kernel(const bf16* __restrict__ x, const bf16* __restrict__ gamma,
                    const bf16* __restrict__ beta, const bf16* __restrict__ w1,
                    const bf16* __restrict__ b1, const bf16* __restrict__ w2,
                    const bf16* __restrict__ b2, const float* __restrict__ keep,
                    bf16* __restrict__ out, int M, int hidden, int rows_per_sample,
                    float eps) {
  using S = MlpShape<C>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xn = reinterpret_cast<bf16*>(smem);
  float* u = reinterpret_cast<float*>(smem + S::XN_BYTES);
  bf16* hb = reinterpret_cast<bf16*>(smem + S::XN_BYTES + S::U_BYTES);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * S::BM;

  // 1. two-pass LayerNorm of the block's rows into shared memory (bf16)
  for (int r = warp; r < S::BM; r += kMlpThreads / 32) {
    const int row = row0 + r;
    bf16* dst = xn + r * S::LDX;
    if (row >= M) {
      for (int c = lane; c < C; c += 32) dst[c] = to_bf(0.f);
      continue;
    }
    const bf16* src = x + static_cast<size_t>(row) * C;
    float v[C / 32];
    float s = 0.f;
#pragma unroll
    for (int t = 0; t < C / 32; ++t) {
      v[t] = to_f(src[lane + 32 * t]);
      s += v[t];
    }
    const float mu = warp_sum(s) / C;
    float q = 0.f;
#pragma unroll
    for (int t = 0; t < C / 32; ++t) q += (v[t] - mu) * (v[t] - mu);
    const float rstd = rsqrtf(warp_sum(q) / C + eps);
#pragma unroll
    for (int t = 0; t < C / 32; ++t) {
      const int c = lane + 32 * t;
      dst[c] = to_bf((v[t] - mu) * rstd * to_f(gamma[c]) + to_f(beta[c]));
    }
  }
  __syncthreads();

  FragC acc[S::TPW];
#pragma unroll
  for (int i = 0; i < S::TPW; ++i) wmma::fill_fragment(acc[i], 0.f);

  for (int hc = 0; hc < hidden; hc += kMlpBH) {
    // 2a. fc1 chunk: warp owns hidden columns [hc + 16 warp, +16), all rows
    FragC hf[S::NR];
#pragma unroll
    for (int r = 0; r < S::NR; ++r) wmma::fill_fragment(hf[r], 0.f);
    for (int k0 = 0; k0 < C; k0 += 16) {
      FragBCol b;
      wmma::load_matrix_sync(b, w1 + static_cast<size_t>(hc + warp * 16) * C + k0, C);
#pragma unroll
      for (int r = 0; r < S::NR; ++r) {
        FragA a;
        wmma::load_matrix_sync(a, xn + r * 16 * S::LDX + k0, S::LDX);
        wmma::mma_sync(hf[r], a, b, hf[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < S::NR; ++r)
      wmma::store_matrix_sync(u + r * 16 * S::LDH + warp * 16, hf[r], S::LDH,
                              wmma::mem_row_major);
    __syncthreads();
    // 2b. + b1, exact GELU, bf16 into shared memory
    for (int i = threadIdx.x; i < S::BM * kMlpBH; i += kMlpThreads) {
      const int r = i / kMlpBH, c = i % kMlpBH;
      const float v = u[r * S::LDH + c] + to_f(b1[hc + c]);
      hb[r * S::LDHB + c] = to_bf(0.5f * v * (1.f + erff(v * 0.70710678118654752f)));
    }
    __syncthreads();
    // 2c. fc2 partial product: warp owns output tiles TPW warp .. + TPW - 1
    for (int k0 = 0; k0 < kMlpBH; k0 += 16) {
#pragma unroll
      for (int i = 0; i < S::TPW; ++i) {
        const int t = warp * S::TPW + i, r = t / S::NC, c = t % S::NC;
        FragA a;
        FragBCol b;
        wmma::load_matrix_sync(a, hb + r * 16 * S::LDHB + k0, S::LDHB);
        wmma::load_matrix_sync(b, w2 + static_cast<size_t>(c * 16) * hidden + hc + k0,
                               hidden);
        wmma::mma_sync(acc[i], a, b, acc[i]);
      }
    }
  }

  // 3. epilogue, one 16x16 tile at a time through the warp's 1 KB scratch
  //    in the H region (last read before the final GELU-phase barrier):
  //    + b2 + residual, 8 columns (16 bytes) per lane
  float* scratch = u + warp * 256;
  const int rr = lane >> 1, cc = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < S::TPW; ++i) {
    const int t = warp * S::TPW + i, r = t / S::NC, c = t % S::NC;
    wmma::store_matrix_sync(scratch, acc[i], 16, wmma::mem_row_major);
    __syncwarp();
    const int row = row0 + r * 16 + rr, col = c * 16 + cc;
    if (row < M) {
      const float kp = keep != nullptr ? keep[row / rows_per_sample] : 1.f;
      const size_t off = static_cast<size_t>(row) * C + col;
      Pack8 xv, bv, ov;
      xv.u = *reinterpret_cast<const uint4*>(x + off);
      bv.u = *reinterpret_cast<const uint4*>(b2 + col);
      const float* a = scratch + rr * 16 + cc;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 xf = __bfloat1622float2(xv.h[e]);
        const float2 bf = __bfloat1622float2(bv.h[e]);
        ov.h[e] = __floats2bfloat162_rn(xf.x + kp * (a[2 * e] + bf.x),
                                        xf.y + kp * (a[2 * e + 1] + bf.y));
      }
      *reinterpret_cast<uint4*>(out + off) = ov.u;
    }
    __syncwarp();
  }
}

template <int C>
cudaError_t launch_mlp(const void* x, const void* g, const void* be, const void* w1,
                       const void* b1, const void* w2, const void* b2, const void* keep,
                       void* out, int M, int hidden, int rows_per_sample, float eps,
                       cudaStream_t stream) {
  using S = MlpShape<C>;
  cudaError_t err = allow_smem(fused_ln_mlp_kernel<C>, S::SMEM);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(fused_ln_mlp_kernel<C>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const int blocks = (M + S::BM - 1) / S::BM;
  fused_ln_mlp_kernel<C><<<blocks, kMlpThreads, S::SMEM, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(g),
      static_cast<const bf16*>(be), static_cast<const bf16*>(w1),
      static_cast<const bf16*>(b1), static_cast<const bf16*>(w2),
      static_cast<const bf16*>(b2), static_cast<const float*>(keep), static_cast<bf16*>(out),
      M, hidden, rows_per_sample, eps);
  return cudaGetLastError();
}

}  // namespace lavt

extern "C" int lavt_fused_ln_mlp(const void* x, const void* g, const void* be,
                                 const void* w1, const void* b1, const void* w2,
                                 const void* b2, const void* keep, void* out, int M, int C,
                                 int hidden, int rows_per_sample, float eps, void* stream) {
  using namespace lavt;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (C) {
    case 128: err = launch_mlp<128>(x, g, be, w1, b1, w2, b2, keep, out, M, hidden, rows_per_sample, eps, s); break;
    case 256: err = launch_mlp<256>(x, g, be, w1, b1, w2, b2, keep, out, M, hidden, rows_per_sample, eps, s); break;
    case 512: err = launch_mlp<512>(x, g, be, w1, b1, w2, b2, keep, out, M, hidden, rows_per_sample, eps, s); break;
    case 1024: err = launch_mlp<1024>(x, g, be, w1, b1, w2, b2, keep, out, M, hidden, rows_per_sample, eps, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
