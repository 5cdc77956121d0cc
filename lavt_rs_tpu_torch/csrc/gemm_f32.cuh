// The 3xTF32 tile product of the f32 variants' GEMMs: f32 accuracy on the
// tensor cores.  csrc/gemm_f32.cu (K1, K11, K3, K8 and K2p f32's
// projections: both operands K-major) and csrc/fused_mlp_bwd_f32.cu (K7
// f32's five products, which read weights N-contiguous and contract the
// weight grads over M) build on `mainloop`.
//
// Accuracy.  One TF32 product keeps 10 mantissa bits of each factor (about
// 5e-4 relative), too coarse for f32.  Each operand is split into
// hi = tf32(a) (round to nearest) and lo = tf32(a - hi), and each product
// is taken as lo hi + hi lo + hi hi on mma.sync.m16n8k8 tf32 with f32
// accumulation (lo lo, ~2^-22 relative, is dropped): about the error of an
// f32 FFMA sum, at three tensor-core products a term.  The tensor cores do
// not round their accumulation to nearest: summed into one accumulator over
// all K / 8 x 3 products, the error grew with K (1.2e-4 at fc2's K = 4096,
// 0.9 of the f32 variants' tolerance, on an H100).  Each 32-deep stage's
// products therefore go into a zeroed `part`, added to the accumulators by
// rounded FADDs.
//
// Tiles.  BM x 128 outputs a block of 256 threads (8 warps as 2 x 4 of
// BM / 2 x 32), 32 deep a stage, a three-stage ring of cp.async 16-byte
// copies (rows past the operand's end and depths past K land as zeros).
// Operand layouts, each staged so that a warp's fragment loads (lane
// 4 g + t on row g, depth t) hit 32 banks:
//   K-major  element (r, k) at p[r ld + k]: an activation (M, K) or an
//            nn.Linear weight (N, K); staged [row][k], rows of 36 floats
//            (36 = 4 mod 32: banks 4 g + t);
//   MN-major element (r, k) at p[k ld + r]: a weight read N-contiguous,
//            W (K, N), or an activation whose rows are the depth (the
//            weight grads, K = M); staged [k][row], rows of R + 8 floats
//            (R + 8 = 8 mod 32: banks 8 t + g).  R and ld multiples of 4.
// Each warp splits its fragments into hi and lo as it loads them from
// shared memory.  Not yet wgmma + TMA (ROADMAP.md, queue 2).

#pragma once

#include <cstdint>

#include "common.cuh"

namespace lavt {
namespace f32mma {

constexpr int kBK = 32, kPadK = 36, kStages = 3, kThreads = 256, kBN = 128;

// one GEMM operand: rows (M or N of the product) past `rows` read as zeros
struct Operand {
  const float* p;
  int ld;  // floats between the stored matrix's rows
  int rows;
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
// Lane l = 4g + t: A a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8,
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

// floats of one operand's R x 32 stage
template <int R, bool KMAJOR>
__host__ __device__ constexpr int stage_floats() {
  return KMAJOR ? R * kPadK : kBK * (R + 8);
}

// shared memory of a BM x 128 product's ring
template <int BM, bool AK, bool BK>
__host__ __device__ constexpr size_t ring_bytes() {
  return size_t(kStages) * (stage_floats<BM, AK>() + stage_floats<kBN, BK>()) * sizeof(float);
}

// stage rows [r0, r0 + R), depths [k0, k0 + 32) of an operand (K-major
// operands need K a multiple of 32)
template <int R, bool KMAJOR>
__device__ __forceinline__ void load_tile(uint32_t dst, const Operand& op, int r0, int k0, int K) {
  constexpr int kChunks = R * kBK / 4;
#pragma unroll
  for (int i = 0; i < kChunks / kThreads; ++i) {
    const int idx = threadIdx.x + kThreads * i;
    if constexpr (KMAJOR) {
      const int r = idx >> 3, c = idx & 7;
      const bool valid = r0 + r < op.rows;
      const float* p = op.p + size_t(valid ? r0 + r : 0) * op.ld + k0 + 4 * c;
      cp_async16(dst + (r * kPadK + 4 * c) * 4, p, valid);
    } else {
      const int k = idx / (R / 4), c = idx % (R / 4);
      const bool valid = k0 + k < K && r0 + 4 * c < op.rows;
      const float* p = op.p + (valid ? size_t(k0 + k) * op.ld + r0 + 4 * c : 0);
      cp_async16(dst + (k * (R + 8) + 4 * c) * 4, p, valid);
    }
  }
}

// element (r, k) of a staged operand
template <int R, bool KMAJOR>
__device__ __forceinline__ float staged(const float* s, int r, int k) {
  return KMAJOR ? s[r * kPadK + k] : s[k * (R + 8) + r];
}

// The output element of accumulator acc[mt][nt][2 h + j]: row m0 +
// frag_row(mt, h), column n0 + frag_col(nt) + j.
template <int BM>
__device__ __forceinline__ int frag_row(int mt, int h) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  return (warp / 4) * (BM / 2) + mt * 16 + lane / 4 + 8 * h;
}

__device__ __forceinline__ int frag_col(int nt) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  return (warp % 4) * 32 + nt * 8 + 2 * (lane % 4);
}

// acc += A[m0 : m0 + BM] B[n0 : n0 + 128]^T over the k-tiles [kt0, kt1)
// (depth K), the ring in `smem` (ring_bytes); every thread returns after
// the block's last read of the ring.
template <int BM, bool AK, bool BK>
__device__ __forceinline__ void mainloop(float (&acc)[BM / 32][4][4], const Operand& A,
                                         const Operand& B, int K, int kt0, int kt1, int m0,
                                         int n0, float* smem) {
  constexpr int MT = BM / 32;
  constexpr int kA = stage_floats<BM, AK>(), kStage = kA + stage_floats<kBN, BK>();
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / 4, wn = warp % 4;

  auto load_stage = [&](int kt) {
    const uint32_t s = base + ((kt - kt0) % kStages) * kStage * 4;
    load_tile<BM, AK>(s, A, m0, kt * kBK, K);
    load_tile<kBN, BK>(s + kA * 4, B, n0, kt * kBK, K);
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (kt0 + s < kt1) load_stage(kt0 + s);
    cp_commit();
  }

  for (int kt = kt0; kt < kt1; ++kt) {
    cp_wait<kStages - 2>();  // stage kt has landed (for this thread)
    __syncthreads();         // ... for every thread; stage kt - 1 is free
    if (kt + kStages - 1 < kt1) load_stage(kt + kStages - 1);
    cp_commit();
    const float* As = smem + ((kt - kt0) % kStages) * kStage;
    const float* Bs = As + kA;
    float part[MT][4][4];  // this stage's sums (see Accuracy)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
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
        const int n = wn * 32 + nt * 8 + g;
        split(staged<kBN, BK>(Bs, n, k), bh[nt][0], bl[nt][0]);
        split(staged<kBN, BK>(Bs, n, k + 4), bh[nt][1], bl[nt][1]);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int r = wm * (BM / 2) + mt * 16 + g;
        uint32_t ah[4], al[4];
        split(staged<BM, AK>(As, r, k), ah[0], al[0]);
        split(staged<BM, AK>(As, r + 8, k), ah[1], al[1]);
        split(staged<BM, AK>(As, r, k + 4), ah[2], al[2]);
        split(staged<BM, AK>(As, r + 8, k + 4), ah[3], al[3]);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          mma_tf32(part[mt][nt], al, bh[nt]);
          mma_tf32(part[mt][nt], ah, bl[nt]);
          mma_tf32(part[mt][nt], ah, bh[nt]);
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] += part[mt][nt][i];
  }
  cp_wait<0>();
  __syncthreads();  // the ring is free for the next mainloop
}

template <int MT>
__device__ __forceinline__ void zero(float (&acc)[MT][4][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
}

inline bool aligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace f32mma
}  // namespace lavt
