// The f32 GEMM of the f32 variants of K1, K11, K3, K8, K2p, K2 and the
// K1/K2 save mode: f32 accuracy on the tensor cores by 3xTF32.
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
// Accuracy: 3xTF32 with each 32-deep stage summed apart (csrc/gemm_tf32_sm90.cuh).
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
// Design: the 3xTF32 wgmma + TMA core of csrc/gemm_tf32_sm90.cuh, both
// operands K-major (B's lo staged beside its raw tile), 128 x 128 output
// tiles of two consumer warpgroups, persistent blocks; the epilogue writes
// float2 pairs from the accumulators.  (The design before: mma.sync tiles
// with the split at every fragment load, PERF.md.)

#include <cstdint>

#include "gemm_tf32_sm90.cuh"

namespace lavt {
namespace g32 {

enum Epi : int { kBias = 0, kGelu = 1, kResidual = 2 };

struct Args {
  const float* b;
  const float* res;   // kResidual: (M, N)
  const float* keep;  // kResidual, K8 f32: (M / rows_per_sample,) or null
  float* out;
  int M, N;
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
struct EpiGemm {
  using Args = g32::Args;
  static __device__ __forceinline__ void store(const Args& a, const float (&acc)[64], float*,
                                               int row0, int col0, float*) {
    tf32::for_pairs(acc, row0, col0, a.M, a.N, [&](int row, int col, float v0, float v1) {
      *reinterpret_cast<float2*>(a.out + size_t(row) * a.N + col) =
          make_float2(epilogue<kEpi>(a, v0, row, col), epilogue<kEpi>(a, v1, row, col + 1));
    });
  }
};

template <int kEpi>
cudaError_t launch(const void* a, const void* w, const Args& args, int K, cudaStream_t s) {
  tf32::Params<Args> p{};
  cudaError_t err = tf32::map_operand(&p.a0, a, args.M, K, false);
  if (err == cudaSuccess) err = tf32::map_operand(&p.b0, w, args.N, K, false);
  if (err != cudaSuccess) return err;
  p.k_tiles = p.k_tiles_per_split = K / tf32::kBK;
  p.epi = args;
  return tf32::launch<EpiGemm<kEpi>, false, false, false>(p, args.M, args.N, 1, s);
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
  using lavt::tf32::aligned16;
  if (M < 1 || N < 2 || N % 2 != 0 || K < lavt::tf32::kBK || K % lavt::tf32::kBK != 0 ||
      !aligned16(a) || !aligned16(w) || !aligned16(out) || (epi == kResidual && res == nullptr) ||
      (keep != nullptr && (epi != kResidual || rows_per_sample < 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args args{static_cast<const float*>(b),    static_cast<const float*>(res),
                  static_cast<const float*>(keep), static_cast<float*>(out),
                  M, N, scaled, scale, rows_per_sample};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (epi) {
    case kBias: return static_cast<int>(launch<kBias>(a, w, args, K, s));
    case kGelu: return static_cast<int>(launch<kGelu>(a, w, args, K, s));
    case kResidual: return static_cast<int>(launch<kResidual>(a, w, args, K, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The dynamic shared memory of the core's kernels (ops/tf32_core.ring):
// kind 0 both operands K-major, 1 the dual GEMM, 2 B transposed by the
// stagers (dyln, K5 f32's dattn and dx, the weight grads); -1 otherwise.
extern "C" int lavt_tf32_core_smem(int kind) {
  using namespace lavt::tf32;
  switch (kind) {
    case 0: return static_cast<int>(Ring<false, false>::kSmem);
    case 1: return static_cast<int>(Ring<false, true>::kSmem);
    case 2: return static_cast<int>(Ring<true, false>::kSmem);
    default: return -1;
  }
}
