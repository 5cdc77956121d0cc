// The f32 GEMM of the f32 variants of K1, K11 and K3: f32 accuracy on the
// tensor cores by 3xTF32.
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
//   kResidual  res[m, n] + acc + b[n].
//
// Accuracy.  One TF32 product keeps 10 mantissa bits of each factor (about
// 5e-4 relative), too coarse for f32.  Each operand is split into
// hi = tf32(a) (round to nearest) and lo = tf32(a - hi), and each product
// is taken as lo hi + hi lo + hi hi on mma.sync.m16n8k8 tf32 with f32
// accumulation (lo lo, ~2^-22 relative, is dropped): about the error of an
// f32 FFMA sum, at three tensor-core products a term.
//
// Bound on the H100: operations, at 165 TFLOP/s (495 TFLOP/s TF32 over the
// three passes), from C = 256 on; at C = 128 the two are close: fc1 at
// Swin-B stage 1 (bs 8, 480²: M = 115,200, K = 128, N = 512) is 15.1
// GFLOP, 0.092 ms, against 59 MB in and 236 MB out, 0.088 ms at 3.35 TB/s,
// and fc2 (236 MB in, x 59 MB, out 59 MB) is bytes, 0.106 ms.
//
// Design (a simple kernel, right first): a 128 x 128 output tile a block of
// 256 threads (8 warps as 2 x 4 of 64 x 32), 32 deep a stage, a three-stage
// ring of cp.async 16-byte copies (rows past M or N land as zeros), rows
// padded to 36 floats so that the fragment loads of a warp hit 32 banks;
// each warp splits its fragments into hi and lo as it loads them from
// shared memory, and the epilogue writes float2 pairs from the
// accumulators.  Each stage's products are summed apart and added to the
// accumulators in f32 (see the note in the mainloop).  Not yet wgmma +
// TMA: tf32 wgmma takes K-major operands only, which every inference GEMM
// has, but its hi / lo split would have to be staged in shared memory
// (ROADMAP.md, queue 2).  Shared memory: 3 x 36 KB = 108 KB; the two
// accumulator sets take one block an SM (-Xptxas -v, CUDA 12.8, on an
// H100: 184 registers, 0 bytes spilled).

#include <cstdint>

#include "common.cuh"

namespace lavt {
namespace g32 {

constexpr int kBM = 128, kBN = 128, kBK = 32, kPad = 36, kStages = 3, kThreads = 256;
constexpr int kTileFloats = kBM * kPad;  // one operand's stage (kBM == kBN)
constexpr size_t kSmem = size_t(kStages) * 2 * kTileFloats * sizeof(float);

enum Epi : int { kBias = 0, kGelu = 1, kResidual = 2 };

struct Args {
  const float* a;
  const float* w;
  const float* b;
  const float* res;  // kResidual: (M, N)
  float* out;
  int M, N, K;
  int scaled;
  float scale;
};

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// D (16 x 8) += A (16 x 8, row) B (8 x 8, col), tf32 in, f32 accumulate.
// Lane l = 4 g + t: A a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8,
// t + 4); B b0 (k t, n g), b1 (k t + 4, n g); D d0, d1 (g, 2t, 2t + 1),
// d2, d3 (g + 8, 2t, 2t + 1).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// one operand's 128 x 32 stage: 1024 16-byte chunks, 4 a thread; rows
// past `rows` are zero-filled (their source address clamped to row 0)
__device__ __forceinline__ void load_tile(uint32_t dst, const float* src, int row0, int rows,
                                          int K, int k0) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int idx = threadIdx.x + kThreads * i;
    const int r = idx >> 3, c = idx & 7;
    const bool valid = row0 + r < rows;
    const float* p = src + size_t(valid ? row0 + r : 0) * K + k0 + 4 * c;
    cp_async16(dst + (r * kPad + 4 * c) * 4, p, valid);
  }
}

template <int kEpi>
__device__ __forceinline__ float epilogue(const Args& a, float acc, int row, int col) {
  const float v = acc + a.b[col];
  if constexpr (kEpi == kBias) {
    return col < a.scaled ? v * a.scale : v;
  } else if constexpr (kEpi == kGelu) {
    float pdf;
    return v * gelu_cdf_pdf(v, &pdf);
  } else {
    return a.res[size_t(row) * a.N + col] + v;
  }
}

template <int kEpi>
__global__ void __launch_bounds__(kThreads, 1) gemm_f32_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / 4, wn = warp % 4;  // the warp's 64 x 32 block
  const int k_tiles = a.K / kBK;

  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  auto load_stage = [&](int kt) {
    const uint32_t s = base + (kt % kStages) * 2 * kTileFloats * 4;
    load_tile(s, a.a, m0, a.M, a.K, kt * kBK);
    load_tile(s + kTileFloats * 4, a.w, n0, a.N, a.K, kt * kBK);
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < k_tiles) load_stage(s);
    cp_commit();
  }

  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_wait<kStages - 2>();  // stage kt has landed (for this thread)
    __syncthreads();         // ... for every thread; stage kt - 1 is free
    if (kt + kStages - 1 < k_tiles) load_stage(kt + kStages - 1);
    cp_commit();
    const float* As = smem + (kt % kStages) * 2 * kTileFloats;
    const float* Ws = As + kTileFloats;
    float part[4][4][4];  // this stage's sums (see the note at acc +=)
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) part[mt][nt][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kBK / 8; ++kk) {
      const int k = kk * 8 + t;
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float* wr = Ws + (wn * 32 + nt * 8 + g) * kPad + k;
        split(wr[0], bh[nt][0], bl[nt][0]);
        split(wr[4], bh[nt][1], bl[nt][1]);
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const float* ar = As + (wm * 64 + mt * 16 + g) * kPad + k;
        uint32_t ah[4], al[4];
        split(ar[0], ah[0], al[0]);
        split(ar[8 * kPad], ah[1], al[1]);
        split(ar[4], ah[2], al[2]);
        split(ar[8 * kPad + 4], ah[3], al[3]);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          mma_tf32(part[mt][nt], al, bh[nt]);
          mma_tf32(part[mt][nt], ah, bl[nt]);
          mma_tf32(part[mt][nt], ah, bh[nt]);
        }
      }
    }
    // The tensor cores do not round their accumulation to nearest: summed
    // into one accumulator over all K / 8 x 3 products, the error grew with
    // K (1.2e-4 at fc2's K = 4096, 0.9 of the f32 variants' tolerance, on
    // an H100).  Each stage's 12 products go into a zeroed `part`, added to
    // acc by rounded FADDs.
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] += part[mt][nt][i];
  }
  cp_wait<0>();

#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm * 64 + mt * 16 + g + 8 * h;
      if (row >= a.M) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = n0 + wn * 32 + nt * 8 + 2 * t;
        if (col >= a.N) continue;
        const float2 v = make_float2(epilogue<kEpi>(a, acc[mt][nt][2 * h], row, col),
                                     epilogue<kEpi>(a, acc[mt][nt][2 * h + 1], row, col + 1));
        *reinterpret_cast<float2*>(a.out + size_t(row) * a.N + col) = v;
      }
    }
}

inline bool aligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <int kEpi>
cudaError_t launch(const Args& a, cudaStream_t s) {
  cudaError_t err = allow_smem(gemm_f32_kernel<kEpi>, kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.N + kBN - 1) / kBN, (a.M + kBM - 1) / kBM);
  gemm_f32_kernel<kEpi><<<grid, kThreads, kSmem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace g32
}  // namespace lavt

// out (M, N) = epilogue(A W^T): a (M, K), w (N, K), b (N,), f32 and
// 16-byte aligned, K a multiple of 32, N even; epi 0 kBias (the first
// `scaled` columns times `scale`), 1 kGelu, 2 kResidual (res (M, N)).
extern "C" int lavt_gemm_f32(const void* a, const void* w, const void* b, const void* res,
                             void* out, int M, int N, int K, int epi, int scaled, float scale,
                             void* stream) {
  using namespace lavt::g32;
  if (M < 1 || N < 2 || N % 2 != 0 || K < kBK || K % kBK != 0 || !aligned(a) || !aligned(w) ||
      !aligned(out) || (epi == kResidual && res == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args args{static_cast<const float*>(a), static_cast<const float*>(w),
                  static_cast<const float*>(b), static_cast<const float*>(res),
                  static_cast<float*>(out), M, N, K, scaled, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (epi) {
    case kBias: return static_cast<int>(launch<kBias>(args, s));
    case kGelu: return static_cast<int>(launch<kGelu>(args, s));
    case kResidual: return static_cast<int>(launch<kResidual>(args, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
