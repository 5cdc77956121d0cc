// The mma.sync pieces of the f32 attention kernels (csrc/attn_tf32.cuh:
// K9 f32's and K5 f32's backwards, K10 f32; the f32 MSA forward takes its
// cp.async copies): the m16n8k8 tf32
// tensor-core product and its fragment layouts, and the cp.async copies
// that stage their tiles.  The f32 GEMMs run on the wgmma + TMA core of
// csrc/gemm_tf32_sm90.cuh.
#pragma once

#include <cstdint>

#include "common.cuh"

namespace lavt {
namespace f32mma {

// The rounding split, hi = tf32(a) (round to nearest), lo = tf32(a - hi):
// tools/ablate_k9_f32.py times it against the truncating split that the
// kernels take (csrc/attn_tf32.cuh, `split_rz`).
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

}  // namespace f32mma
}  // namespace lavt
