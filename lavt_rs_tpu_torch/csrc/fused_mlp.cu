// K3: LayerNorm -> fc1 -> exact GELU -> fc2 -> + residual, and K8, the same
// with a per-sample DropPath scale.
//
// Replaces lavt_rs_tpu/ops/pallas/fused_mlp.py:fused_ln_mlp (_fwd/_kernel,
// :111), the tail of every Swin block, out = x + fc2(gelu(fc1(LN(x)))),
// and fused_ln_mlp_droppath (:533), out = x + keep[row / rows_per_sample]
// fc2(...), keep (B,) f32.  The rounding points are the TPU kernel's: the
// two-pass LayerNorm (mean of (x - mu)^2, eps inside rsqrt), xn rounded to
// bf16 before fc1, the exact erf GELU in f32 rounded to bf16 before fc2.
//
// Bound on the H100: operations.  M C^2 is 1.887e9 at every Swin-B stage
// ((115200, 128) ... (1800, 1024) at bs 8, 480²), so a call is 16 M C^2 =
// 30.2 GFLOP, 0.0305 ms at 989 TFLOP/s, against ~0.002 ms for x, out and
// the weights at 3.35 TB/s.
//
// Three launches (the wrapper allocates xn and h; the kernels allocate
// nothing):
//   (a) mlp_ln_rows_kernel: one warp per row, the two-pass LN -> xn (M, C)
//       bf16;
//   (b) the GEMM core (gemm_sm90.cuh), xn W1^T, epilogue + b1, GELU ->
//       h (M, 4C) bf16;
//   (c) the GEMM core, h W2^T, epilogue + b2, x keep, + x -> out bf16 (x
//       TMA-loaded into the staged output tile while the mainloop runs).
// The TPU kernel keeps the (M, 4C) hidden in VMEM, where the whole W1 and
// W2 fit.  An SM cannot hold them, and a row block small enough to keep
// its hidden on chip re-reads both weights from L2 for every 16-64 rows
// (the earlier WMMA design: ~0.9 GB of weight traffic a call).  Here the
// hidden makes one round trip through L2/HBM (h written and read once, at
// most 2 x 118 MB a call at stage 1, ~0.07 ms at 3.35 TB/s) and each
// 128 x 128 tile reads its A and B once through the TMA ring.  The GELU
// evaluates erf as the TPU kernel does, by Abramowitz & Stegun 7.1.26
// (common.cuh: |err| < 1.5e-7, a dozen instructions with one exp).
//
// GEMM core: a 128 x 128 tile per consumer warpgroup, 64 deep, 4 stages
// of 32 KB, two consumers in ping-pong (one's GELU epilogue overlaps the
// other's wgmmas), outputs staged (2 x 32 KB) for TMA stores: 201,824
// bytes of shared memory, one block per SM.  -Xptxas -v (CUDA 12.8, on
// an H100): gemm_kernel 168 registers at launch (setmaxnreg: 232 for the
// consumers, 40 for the producer), 0 bytes spilled; mlp_ln_rows_kernel
// 22-48 registers, 0 spilled.

#include "common.cuh"
#include "gemm_sm90.cuh"

namespace lavt {

using sm90::GemmParams;

// (a) one warp per row: the two-pass LayerNorm -> bf16 xn
template <int C>
__global__ void __launch_bounds__(256)
    mlp_ln_rows_kernel(const bf16* __restrict__ x, const bf16* __restrict__ gamma,
                       const bf16* __restrict__ beta, bf16* __restrict__ xn, int M, float eps) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32;
  if (row >= M) return;
  const size_t off = static_cast<size_t>(row) * C;
  ln_row_two_pass<C>(x + off, gamma, beta, eps, xn + off);
}

// (b) h = bf16(gelu(acc + b1)), staged for the TMA store
struct EpiBiasGelu {
  static constexpr int kStaged = 1, kStagedIn = 0;
  struct Args {
    const bf16* b1;
  };
  static __device__ __forceinline__ void store(const Args& a, float (&acc)[64], float (&)[1],
                                               int, int col0, float*, unsigned char* out) {
#pragma unroll
    for (int j = 0; j < sm90::kBN / 8; ++j) {
      const int c = sm90::frag_col(0, j);
      const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(a.b1 + col0 + c));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float v0 = acc[4 * j + 2 * h] + b.x, v1 = acc[4 * j + 2 * h + 1] + b.y;
        float p0, p1;
        const float c0 = gelu_cdf_pdf(v0, &p0), c1 = gelu_cdf_pdf(v1, &p1);
        sm90::stage_pair(out, sm90::frag_row(0, h), c, __floats2bfloat162_rn(v0 * c0, v1 * c1));
      }
    }
  }
};

// (c) out = bf16(x + keep[row / rows_per_sample] (acc + b2)): x arrives
// staged (TMA, rows past M as zeros) and out overwrites it there; keep may
// be null
struct EpiResidual {
  static constexpr int kStaged = 1, kStagedIn = 1;
  struct Args {
    const bf16* b2;
    const float* keep;
    int M, rows_per_sample;
  };
  static __device__ __forceinline__ void store(const Args& a, float (&acc)[64], float (&)[1],
                                               int row0, int col0, float*, unsigned char* out) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = sm90::frag_row(0, h), row = row0 + r;
      const float kp = a.keep != nullptr && row < a.M ? a.keep[row / a.rows_per_sample] : 1.f;
#pragma unroll
      for (int j = 0; j < sm90::kBN / 8; ++j) {
        const int c = sm90::frag_col(0, j);
        const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(a.b2 + col0 + c));
        __nv_bfloat162* xo = sm90::staged_pair(out, r, c);
        const float2 xv = __bfloat1622float2(*xo);
        *xo = __floats2bfloat162_rn(xv.x + kp * (acc[4 * j + 2 * h] + b.x),
                                    xv.y + kp * (acc[4 * j + 2 * h + 1] + b.y));
      }
    }
  }
};

cudaError_t mlp_ln_rows(const void* x, const void* g, const void* be, void* xn, int M, int C,
                        float eps, cudaStream_t s) {
  const int blocks = (M + 7) / 8;
  const auto* xb = static_cast<const bf16*>(x);
  const auto* gb = static_cast<const bf16*>(g);
  const auto* bb = static_cast<const bf16*>(be);
  auto* out = static_cast<bf16*>(xn);
  switch (C) {
    case 128: mlp_ln_rows_kernel<128><<<blocks, 256, 0, s>>>(xb, gb, bb, out, M, eps); break;
    case 256: mlp_ln_rows_kernel<256><<<blocks, 256, 0, s>>>(xb, gb, bb, out, M, eps); break;
    case 384: mlp_ln_rows_kernel<384><<<blocks, 256, 0, s>>>(xb, gb, bb, out, M, eps); break;
    case 512: mlp_ln_rows_kernel<512><<<blocks, 256, 0, s>>>(xb, gb, bb, out, M, eps); break;
    case 1024: mlp_ln_rows_kernel<1024><<<blocks, 256, 0, s>>>(xb, gb, bb, out, M, eps); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

cudaError_t gemm_bias_gelu(const void* xn, const void* w1, const void* b1, void* h, int M, int C,
                           int hidden, cudaStream_t s) {
  GemmParams<EpiBiasGelu::Args> p;
  cudaError_t err = sm90::map_a<2>(&p.a0, xn, C, M, false);
  if (err == cudaSuccess) err = sm90::map_b(&p.b0, w1, C, hidden, false);
  if (err == cudaSuccess) err = sm90::map_out(&p.c0, h, hidden, M);
  if (err != cudaSuccess) return err;
  p.k_tiles = p.k_tiles_per_split = C / sm90::kBK;
  p.epi = {static_cast<const bf16*>(b1)};
  return sm90::launch_gemm<EpiBiasGelu, 2, false, false>(p, M, hidden, 1, s);
}

cudaError_t gemm_residual(const void* h, const void* w2, const void* b2, const void* x,
                          const void* keep, void* out, int M, int C, int hidden,
                          int rows_per_sample, cudaStream_t s) {
  GemmParams<EpiResidual::Args> p;
  cudaError_t err = sm90::map_a<2>(&p.a0, h, hidden, M, false);
  if (err == cudaSuccess) err = sm90::map_b(&p.b0, w2, hidden, C, false);
  if (err == cudaSuccess) err = sm90::map_out(&p.c0, out, C, M);
  if (err == cudaSuccess) err = sm90::map_out(&p.c1, x, C, M);
  if (err != cudaSuccess) return err;
  p.k_tiles = p.k_tiles_per_split = hidden / sm90::kBK;
  p.epi = {static_cast<const bf16*>(b2), static_cast<const float*>(keep), M, rows_per_sample};
  return sm90::launch_gemm<EpiResidual, 2, false, false>(p, M, C, 1, s);
}

}  // namespace lavt

// Each launch alone (for its test and its time), then K3/K8 as the three.
extern "C" int lavt_mlp_ln_rows(const void* x, const void* g, const void* be, void* xn, int M,
                                int C, float eps, void* stream) {
  return static_cast<int>(
      lavt::mlp_ln_rows(x, g, be, xn, M, C, eps, static_cast<cudaStream_t>(stream)));
}

extern "C" int lavt_gemm_bias_gelu(const void* xn, const void* w1, const void* b1, void* h, int M,
                                   int C, int hidden, void* stream) {
  return static_cast<int>(
      lavt::gemm_bias_gelu(xn, w1, b1, h, M, C, hidden, static_cast<cudaStream_t>(stream)));
}

extern "C" int lavt_gemm_residual(const void* h, const void* w2, const void* b2, const void* x,
                                  const void* keep, void* out, int M, int C, int hidden,
                                  int rows_per_sample, void* stream) {
  return static_cast<int>(lavt::gemm_residual(h, w2, b2, x, keep, out, M, C, hidden,
                                              rows_per_sample, static_cast<cudaStream_t>(stream)));
}

extern "C" int lavt_fused_ln_mlp(const void* x, const void* g, const void* be, const void* w1,
                                 const void* b1, const void* w2, const void* b2, const void* keep,
                                 void* xn, void* h, void* out, int M, int C, int hidden,
                                 int rows_per_sample, float eps, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = lavt::mlp_ln_rows(x, g, be, xn, M, C, eps, s);
  if (err == cudaSuccess) err = lavt::gemm_bias_gelu(xn, w1, b1, h, M, C, hidden, s);
  if (err == cudaSuccess)
    err = lavt::gemm_residual(h, w2, b2, x, keep, out, M, C, hidden, rows_per_sample, s);
  return static_cast<int>(err);
}
