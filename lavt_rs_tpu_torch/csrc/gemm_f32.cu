// The f32 GEMM of the f32 variants of K1, K11, K3, K8 and K2p: f32
// accuracy on the tensor cores by 3xTF32.
//
//   out[m, n] = epilogue(sum_k A[m, k] W[n, k])
//
// A (M, K) and W (N, K) row-major (K contiguous: W is a torch nn.Linear
// weight), f32.  It replaces the jnp.dots that the TPU kernels compute in
// f32 on f32 activations (`--no_bf16` with Pallas): the qkv projection (q
// scaled after its bias) and the out-projection of
// lavt_rs_tpu/ops/pallas/fused_msa.py:_kernel (:118-123, :166-170) and of
// experimental.py:_kernel_2d (K11), and fc1 + GELU and fc2 + residual of
// fused_mlp.py:_fwd (:111).  Epilogues (the TPU kernels' f32 math, nothing
// rounded below f32):
//   kBias      (acc + b[n]) s, s = scale on the first `scaled` columns, else 1;
//   kGelu      gelu(acc + b[n]), the exact GELU with erf by Abramowitz &
//              Stegun 7.1.26 (common.cuh, as the TPU kernel evaluates it);
//   kResidual  res[m, n] + acc + b[n], or res[m, n] + keep (acc + b[n]).
//
// Accuracy: 3xTF32 with each 32-deep stage summed apart (csrc/gemm_f32.cuh).
//
// K8 f32 (`keep` given) is kResidual with the per-sample DropPath scale,
// res[m, n] + keep[m / rows_per_sample] (acc + b[n]): fused_mlp.py:_fwd's
// residual with keep_rows (fused_ln_mlp_droppath, :533).
//
// Bound on the H100: operations, at 165 TFLOP/s (495 TFLOP/s TF32 over the
// three passes), from C = 256 on; at C = 128 the two are close: fc1 at
// Swin-B stage 1 (bs 8, 480²: M = 115,200, K = 128, N = 512) is 15.1
// GFLOP, 0.092 ms, against 59 MB in and 236 MB out, 0.088 ms at 3.35 TB/s,
// and fc2 (236 MB in, x 59 MB, out 59 MB) is bytes, 0.106 ms.
//
// Design (a simple kernel, right first): `f32mma::mainloop` on 128 x 128
// output tiles, both operands K-major; the epilogue writes float2 pairs
// from the accumulators.  Not yet wgmma + TMA: tf32 wgmma takes K-major
// operands only, which every inference GEMM has, but its hi / lo split
// would have to be staged in shared memory (ROADMAP.md, queue 2).  Shared
// memory: 3 x 36 KB = 108 KB; the two accumulator sets take one block an
// SM (-Xptxas -v, CUDA 12.8, on an H100: 182 registers, 0 bytes spilled).

#include <cstdint>

#include "gemm_f32.cuh"

namespace lavt {
namespace g32 {

using namespace f32mma;

enum Epi : int { kBias = 0, kGelu = 1, kResidual = 2 };

struct Args {
  const float* a;
  const float* w;
  const float* b;
  const float* res;   // kResidual: (M, N)
  const float* keep;  // kResidual, K8 f32: (M / rows_per_sample,) or null
  float* out;
  int M, N, K;
  int scaled;
  float scale;
  int rows_per_sample;
};

template <int kEpi>
__device__ __forceinline__ float epilogue(const Args& a, float acc, int row, int col) {
  const float v = acc + a.b[col];
  if constexpr (kEpi == kBias) {
    return col < a.scaled ? v * a.scale : v;
  } else if constexpr (kEpi == kGelu) {
    float pdf;
    return v * gelu_cdf_pdf(v, &pdf);
  } else {
    const float kp = a.keep != nullptr ? a.keep[row / a.rows_per_sample] : 1.f;
    return a.res[size_t(row) * a.N + col] + kp * v;
  }
}

template <int kEpi>
__global__ void __launch_bounds__(kThreads, 1) gemm_f32_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const int m0 = blockIdx.y * 128, n0 = blockIdx.x * kBN;
  float acc[4][4][4];
  zero(acc);
  mainloop<128, true, true>(acc, Operand{a.a, a.K, a.M}, Operand{a.w, a.K, a.N}, a.K, 0,
                            a.K / kBK, m0, n0, smem);
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + frag_row<128>(mt, h);
      if (row >= a.M) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = n0 + frag_col(nt);
        if (col >= a.N) continue;
        const float2 v = make_float2(epilogue<kEpi>(a, acc[mt][nt][2 * h], row, col),
                                     epilogue<kEpi>(a, acc[mt][nt][2 * h + 1], row, col + 1));
        *reinterpret_cast<float2*>(a.out + size_t(row) * a.N + col) = v;
      }
    }
}

template <int kEpi>
cudaError_t launch(const Args& a, cudaStream_t s) {
  constexpr size_t kSmem = ring_bytes<128, true, true>();
  cudaError_t err = allow_smem(gemm_f32_kernel<kEpi>, kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.N + kBN - 1) / kBN, (a.M + 127) / 128);
  gemm_f32_kernel<kEpi><<<grid, kThreads, kSmem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace g32
}  // namespace lavt

// out (M, N) = epilogue(A W^T): a (M, K), w (N, K), b (N,), f32 and
// 16-byte aligned, K a multiple of 32, N even; epi 0 kBias (the first
// `scaled` columns times `scale`), 1 kGelu, 2 kResidual (res (M, N); with
// keep, (M / rows_per_sample,), the residual branch scaled per sample).
extern "C" int lavt_gemm_f32(const void* a, const void* w, const void* b, const void* res,
                             const void* keep, void* out, int M, int N, int K, int epi,
                             int scaled, float scale, int rows_per_sample, void* stream) {
  using namespace lavt::g32;
  if (M < 1 || N < 2 || N % 2 != 0 || K < kBK || K % kBK != 0 || !aligned(a) || !aligned(w) ||
      !aligned(out) || (epi == kResidual && res == nullptr) ||
      (keep != nullptr && (epi != kResidual || rows_per_sample < 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args args{static_cast<const float*>(a),   static_cast<const float*>(w),
                  static_cast<const float*>(b),   static_cast<const float*>(res),
                  static_cast<const float*>(keep), static_cast<float*>(out),
                  M, N, K, scaled, scale, rows_per_sample};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (epi) {
    case kBias: return static_cast<int>(launch<kBias>(args, s));
    case kGelu: return static_cast<int>(launch<kGelu>(args, s));
    case kResidual: return static_cast<int>(launch<kResidual>(args, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
