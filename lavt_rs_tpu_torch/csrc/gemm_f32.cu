// The f32 GEMM of the f32 variants of K1, K11, K3, K8, K2p, K2 and the
// K1/K2 save mode: f32 accuracy on the tensor cores by 3xTF32; K3 / K8
// f32's prep launch; and the split of a weight's lo parts.
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
// W's lo parts, lo = w - trunc(w) (trunc clearing the 13 low bits), are
// an input: TMA brings them beside W's hi (the raw tile), so no warp
// splits W again for each output tile and the core's shared memory, which
// bounds it, carries no 16 KB split pass a stage (the design before, the
// stagers' split, is tools/ablate_k3_f32.py's "neither" in a checkout
// that has it).  `split` (lavt_tf32_lo) writes them: the model's f32 MSA
// keeps its projections' lo once a weight version (models/swin2d.py,
// WindowAttention.weight_lo), and ops/fused_msa.gemm_f32 splits W itself
// for a caller that passes none.
//
// K3 / K8 f32 (fused_mlp.py:_fwd, the LN -> fc1 + GELU -> fc2 + residual
// tail) are three launches: `prep` (the two-pass LN rows, each row by one
// warp in registers as csrc/ln.cu's f32 LN rows compute them, and the lo
// parts of W1 and W2, once a call), then fc1 + GELU and fc2 + residual.
// h keeps one round trip, the bf16 K3's choice (csrc/fused_mlp.cu: a row
// block small enough to keep 4C on chip re-reads both weights).  Folding
// the LayerNorm into fc1's A operand lost (tools/ablate_k3_f32.py,
// PERF.md): in place by the stagers it adds a shared-memory pass a stage,
// in the consumers' split it lengthens their path to the tensor cores.
//
// Bound on the H100: operations, at 165 TFLOP/s (495 TFLOP/s TF32 over the
// three passes), from C = 256 on; at C = 128 the two are close: fc1 at
// Swin-B stage 1 (bs 8, 480²: M = 115,200, K = 128, N = 512) is 15.1
// GFLOP, 0.092 ms, against 59 MB in and 236 MB out, 0.088 ms at 3.35 TB/s,
// and fc2 (236 MB in, x 59 MB, out 59 MB) is bytes, 0.106 ms.
//
// Design: the 3xTF32 wgmma + TMA core of csrc/gemm_tf32_sm90.cuh, both
// operands K-major (W's hi the raw tile, its lo brought by TMA beside it),
// 128 x 128 output tiles of two consumer warpgroups, persistent blocks;
// the epilogue writes float2 pairs from the accumulators.  (The design
// before: mma.sync tiles with the split at every fragment load, PERF.md.)

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

// W's lo at `wlo`, brought by TMA beside W
template <int kEpi>
cudaError_t launch(const void* a, const void* w, const void* wlo, const Args& args, int K,
                   cudaStream_t s) {
  tf32::Params<Args> p{};
  cudaError_t err = tf32::map_operand(&p.a0, a, args.M, K, false);
  if (err == cudaSuccess) err = tf32::map_operand(&p.b0, w, args.N, K, false);
  if (err == cudaSuccess) err = tf32::map_operand(&p.b0_lo, wlo, args.N, K, false);
  if (err != cudaSuccess) return err;
  p.k_tiles = p.k_tiles_per_split = K / tf32::kBK;
  p.epi = args;
  return tf32::launch<EpiGemm<kEpi>, false, false, false>(p, args.M, args.N, 1, s);
}

// K3 / K8 f32's prep: blocks [0, row_blocks) take 8 rows each, a warp a row
// (16-byte words, lane l the words l + 32 t, t < V; the two-pass LayerNorm
// of csrc/ln.cu's f32 LN rows, the same expressions); the others split
// the weights' words, w1's `words1` then w2's `words2`, by a grid-stride
// loop (lavt_tf32_lo: no rows, one weight).
template <int V>
__global__ void __launch_bounds__(256)
    mlp_prep_kernel(const float* __restrict__ x, const float* __restrict__ gamma,
                    const float* __restrict__ beta, float* __restrict__ xn, int M, int C,
                    float eps, int row_blocks, const float4* __restrict__ w1,
                    float4* __restrict__ w1lo, const float4* __restrict__ w2,
                    float4* __restrict__ w2lo, long long words1, long long words2) {
  if (static_cast<int>(blockIdx.x) < row_blocks) {
    const int row = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
    if (row >= M) return;
    const int cw = C / 4;
    const auto* src = reinterpret_cast<const float4*>(x + size_t(row) * C);
    float4 v[V];
    float s = 0.f;
#pragma unroll
    for (int t = 0; t < V; ++t) {
      const int wd = lane + 32 * t;
      v[t] = wd < cw ? src[wd] : make_float4(0.f, 0.f, 0.f, 0.f);
      s += (v[t].x + v[t].y) + (v[t].z + v[t].w);
    }
    const float mu = warp_sum(s) / C;
    float q = 0.f;
#pragma unroll
    for (int t = 0; t < V; ++t) {
      if (lane + 32 * t >= cw) continue;
      const float a = v[t].x - mu, b = v[t].y - mu, c = v[t].z - mu, d = v[t].w - mu;
      q += (a * a + b * b) + (c * c + d * d);
    }
    const float rstd = rsqrtf(warp_sum(q) / C + eps);
    auto* dst = reinterpret_cast<float4*>(xn + size_t(row) * C);
    const auto* g4 = reinterpret_cast<const float4*>(gamma);
    const auto* b4 = reinterpret_cast<const float4*>(beta);
#pragma unroll
    for (int t = 0; t < V; ++t) {
      const int wd = lane + 32 * t;
      if (wd >= cw) continue;
      const float4 g = g4[wd], b = b4[wd];
      dst[wd] = make_float4((v[t].x - mu) * rstd * g.x + b.x, (v[t].y - mu) * rstd * g.y + b.y,
                            (v[t].z - mu) * rstd * g.z + b.z, (v[t].w - mu) * rstd * g.w + b.w);
    }
    return;
  }
  const long long stride = static_cast<long long>(gridDim.x - row_blocks) * 256;
  for (long long i = (blockIdx.x - row_blocks) * 256ll + threadIdx.x; i < words1 + words2;
       i += stride) {
    const float4 v = i < words1 ? w1[i] : w2[i - words1];
    const float4 lo = make_float4(tf32::lo_of(v.x), tf32::lo_of(v.y), tf32::lo_of(v.z),
                                  tf32::lo_of(v.w));
    if (i < words1)
      w1lo[i] = lo;
    else
      w2lo[i - words1] = lo;
  }
}

constexpr int kWeightBlocks = 264;  // two an SM

cudaError_t mlp_prep(const float* x, const float* gamma, const float* beta, float* xn, int M,
                     int C, float eps, const float* w1, float* w1lo, const float* w2,
                     float* w2lo, long long words1, long long words2, cudaStream_t s) {
  const int need = (C / 4 + 31) / 32, row_blocks = x != nullptr ? (M + 7) / 8 : 0;
  const int wblocks = static_cast<int>(
      std::min<long long>(kWeightBlocks, (words1 + words2 + 255) / 256));
  if (row_blocks + wblocks == 0) return cudaSuccess;
  const auto* a1 = reinterpret_cast<const float4*>(w1);
  const auto* a2 = reinterpret_cast<const float4*>(w2);
  auto* l1 = reinterpret_cast<float4*>(w1lo);
  auto* l2 = reinterpret_cast<float4*>(w2lo);
#define LAVT_CASE(V)                                                                        \
  if (need <= V) {                                                                          \
    mlp_prep_kernel<V><<<row_blocks + wblocks, 256, 0, s>>>(x, gamma, beta, xn, M, C, eps,  \
                                                            row_blocks, a1, l1, a2, l2,    \
                                                            words1, words2);               \
    return cudaGetLastError();                                                              \
  }
  LAVT_CASE(1) LAVT_CASE(2) LAVT_CASE(3) LAVT_CASE(4) LAVT_CASE(6) LAVT_CASE(8)
  LAVT_CASE(12) LAVT_CASE(16) LAVT_CASE(24) LAVT_CASE(32)
#undef LAVT_CASE
  return cudaErrorInvalidValue;
}

}  // namespace g32
}  // namespace lavt

// out (M, N) = epilogue(A W^T): a (M, K), w (N, K), b (N,), f32 and
// 16-byte aligned, K a multiple of 32, N even; epi 0 kBias (the first
// `scaled` columns times `scale`), 1 kGelu, 2 kResidual (res (M, N); with
// keep, (M / rows_per_sample,), the residual branch scaled per sample).
// wlo (N, K): W's lo parts (w - trunc(w): lavt_tf32_lo, lavt_mlp_f32_prep),
// which TMA brings beside W.
extern "C" int lavt_gemm_f32(const void* a, const void* w, const void* wlo, const void* b,
                             const void* res, const void* keep, void* out, int M, int N, int K,
                             int epi, int scaled, float scale, int rows_per_sample,
                             void* stream) {
  using namespace lavt::g32;
  using lavt::tf32::aligned16;
  if (M < 1 || N < 2 || N % 2 != 0 || K < lavt::tf32::kBK || K % lavt::tf32::kBK != 0 ||
      !aligned16(a) || !aligned16(w) || !aligned16(out) || (epi == kResidual && res == nullptr) ||
      (keep != nullptr && (epi != kResidual || rows_per_sample < 1)) || wlo == nullptr ||
      !aligned16(wlo))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args args{static_cast<const float*>(b),    static_cast<const float*>(res),
                  static_cast<const float*>(keep), static_cast<float*>(out),
                  M, N, scaled, scale, rows_per_sample};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (epi) {
    case kBias: return static_cast<int>(launch<kBias>(a, w, wlo, args, K, s));
    case kGelu: return static_cast<int>(launch<kGelu>(a, w, wlo, args, K, s));
    case kResidual: return static_cast<int>(launch<kResidual>(a, w, wlo, args, K, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K3 / K8 f32's launch 1: x (M, C) f32 -> xn = LN(x) (M, C) (the two-pass
// LayerNorm, gamma and beta (C,)); w1 (hidden, C) and w2 (C, hidden) f32
// -> their lo parts w1lo and w2lo (w - trunc(w), trunc clearing the 13 low
// bits).  C a multiple of 4 up to 4096, every pointer 16-byte aligned; a
// null x skips the rows, a null w1 the weights.
extern "C" int lavt_mlp_f32_prep(const void* x, const void* gamma, const void* beta,
                                 const void* w1, const void* w2, void* xn, void* w1lo,
                                 void* w2lo, int M, int C, int hidden, float eps, void* stream) {
  using namespace lavt::g32;
  const auto ok = [](const void* p) {
    return p == nullptr || lavt::tf32::aligned16(p);
  };
  if (M < 1 || C < 4 || C % 4 != 0 || C > 4096 || hidden < 1 || !ok(x) || !ok(gamma) ||
      !ok(beta) || !ok(w1) || !ok(w2) || !ok(xn) || !ok(w1lo) || !ok(w2lo))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long words = w1 != nullptr ? static_cast<long long>(hidden) * C / 4 : 0;
  return static_cast<int>(mlp_prep(static_cast<const float*>(x),
                                   static_cast<const float*>(gamma),
                                   static_cast<const float*>(beta), static_cast<float*>(xn), M,
                                   C, eps, static_cast<const float*>(w1),
                                   static_cast<float*>(w1lo), static_cast<const float*>(w2),
                                   static_cast<float*>(w2lo), words, words,
                                   static_cast<cudaStream_t>(stream)));
}

// lo (n,) = w - trunc(w) of f32 w (n,), trunc clearing the 13 low bits: a
// weight's lo parts for lavt_gemm_f32.  n a multiple of 4, both pointers
// 16-byte aligned.
extern "C" int lavt_tf32_lo(const void* w, void* lo, long long n, void* stream) {
  using namespace lavt::g32;
  if (n < 4 || n % 4 != 0 || !lavt::tf32::aligned16(w) || !lavt::tf32::aligned16(lo))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(mlp_prep(nullptr, nullptr, nullptr, nullptr, 1, 4, 0.f,
                                   static_cast<const float*>(w), static_cast<float*>(lo),
                                   nullptr, nullptr, n / 4, 0,
                                   static_cast<cudaStream_t>(stream)));
}

// The dynamic shared memory of the core's kernels (ops/tf32_core.ring):
// kind 0 both operands K-major (B's lo by TMA), 1 the dual GEMM, 2 B
// transposed by the stagers (dyln, K5 f32's dattn and dx, the weight
// grads); -1 otherwise.
extern "C" int lavt_tf32_core_smem(int kind) {
  using namespace lavt::tf32;
  switch (kind) {
    case 0: return static_cast<int>(Ring<false, false>::kSmem);
    case 1: return static_cast<int>(Ring<false, true>::kSmem);
    case 2: return static_cast<int>(Ring<true, false>::kSmem);
    default: return -1;
  }
}
