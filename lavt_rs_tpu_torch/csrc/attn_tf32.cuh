// Shared pieces of the f32 attention kernels on the tensor cores (K9 f32,
// csrc/window_attn_bwd_f32.cu; K5 f32's attention, csrc/fused_msa_bwd_f32.cu;
// K10 f32, csrc/window_attn_f32.cu; and the split and `frag_c2a` of the
// f32 MSA forward of K1, K2, K11 and the save mode, csrc/fused_msa_f32.cu,
// whose products run on wgmma): 3xTF32 products of head-dim-32 operands
// on mma.sync.m16n8k8 (the fragment layouts of csrc/gemm_f32.cuh, `f32mma`).
//
// A warp owns 16 rows of every product it takes part in (one m-tile), so
// each B fragment feeds one accumulator; what a B fragment costs decides
// the speed.  B operands are therefore split once, when a tile is staged,
// into "fragment tiles": for each 8 x 8 block of the operand the 32 lanes'
// (hi0, hi1, lo0, lo1) as one 16-byte word a lane, so a warp loads a B
// fragment with one conflict-free 16-byte load and no arithmetic.  Two
// orders of a [row][d] tile T (rows kLd = 36 floats apart in its raw copy):
//   NT  block (r, c) of S = A T^T: lane (g, t) holds T[8r + g][8c + t] and
//       T[8r + g][8c + t + 4] (T's rows are S's columns);
//   NN  block (r, c) of O = P T:   lane (g, t) holds T[8r + 2t][8c + g] and
//       T[8r + 2t + 1][8c + g] (T's rows are the depth, permuted).
// The permutation lets a C fragment (rows g, g + 8; columns 2t, 2t + 1)
// serve as the A fragment of the next product unchanged (`frag_c2a`): A's
// depth t stands for column 2t and t + 4 for 2t + 1.  So S -> dS -> dS K and
// P -> P V stay in registers; an A operand read from device memory (K5
// f32's saved P) is read in the same order.  A fragments from a raw tile
// (`frag_a`, lane (g, t) reading rows g, g + 8: banks 4g + t) or from
// registers are split where they are used.
//
// The split.  Each operand x is taken as hi + lo, and each product term as
// lo hi + hi lo + hi hi (lo lo, ~2^-21 relative, dropped), all three on the
// tensor cores with f32 accumulation.  hi = tf32(x) and lo = tf32(x - hi)
// are taken by truncation (`split_rz`: hi = x with its 13 low bits
// cleared, lo = x - hi exactly, whose low bits the tensor core ignores):
// two integer / float instructions, where rounding conversions (cvt.rna)
// take several, at about twice the error of a term.
// Measured on an H100 (tools/ablate_k9_f32.py): rounding where fragments
// are used cost 7-8 % of K9 f32's launches, and rounding in the fragment
// tiles 4-5 %; truncation moved K9 f32 by 0.03-0.25 of its 1e-4 gate.
//
// Issue order.  The three products of a term accumulate into one register
// set, a chain of three dependent mma.syncs; the kernels issue them pass
// by pass over independent accumulators (every lo hi, then every hi lo,
// then every hi hi), so that consecutive mma.syncs do not wait on each
// other.
#pragma once

#include <cstdint>

#include "gemm_f32.cuh"

namespace lavt {
namespace tf32attn {

using f32mma::mma_tf32;

constexpr int kHD = 32, kLd = 36;
constexpr int kFragBlock = 32;  // 16-byte words of an 8 x 8 block's fragment

__device__ __forceinline__ int lane_id() { return threadIdx.x % 32; }
__device__ __forceinline__ int lane_g() { return (threadIdx.x % 32) / 4; }
__device__ __forceinline__ int lane_t() { return threadIdx.x % 4; }

__device__ __forceinline__ void split_rz(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

struct Frag4 {
  uint32_t hi[4], lo[4];
};
struct Frag2 {
  uint32_t hi[2], lo[2];
};

// A fragment of rows [0, 16) of `t` (row-major, kLd), depths k0 .. k0 + 7,
// times `scale`
__device__ __forceinline__ Frag4 frag_a(const float* t, int k0, float scale = 1.f) {
  const int g = lane_g(), c = k0 + lane_t();
  Frag4 f;
  split_rz(t[g * kLd + c] * scale, f.hi[0], f.lo[0]);
  split_rz(t[(g + 8) * kLd + c] * scale, f.hi[1], f.lo[1]);
  split_rz(t[g * kLd + c + 4] * scale, f.hi[2], f.lo[2]);
  split_rz(t[(g + 8) * kLd + c + 4] * scale, f.hi[3], f.lo[3]);
  return f;
}

// the A fragment (depth permuted) of a C fragment's 16 x 8 values
__device__ __forceinline__ Frag4 frag_c2a(const float (&c)[4]) {
  Frag4 f;
  split_rz(c[0], f.hi[0], f.lo[0]);
  split_rz(c[2], f.hi[1], f.lo[1]);
  split_rz(c[1], f.hi[2], f.lo[2]);
  split_rz(c[3], f.hi[3], f.lo[3]);
  return f;
}

// block (r, c)'s B fragment of a fragment tile
__device__ __forceinline__ Frag2 frag_b(const uint4* tile, int r, int c) {
  const uint4 w = tile[(r * 4 + c) * kFragBlock + lane_id()];
  Frag2 f;
  f.hi[0] = w.x, f.hi[1] = w.y, f.lo[0] = w.z, f.lo[1] = w.w;
  return f;
}

// The fragment tiles of rows [0, rows) of the raw tile `t` (rows a multiple
// of 8; zeros where the raw rows are), times `scale`: NT into `nt`, NN into
// `nn` (either may be null), by `threads` threads.
__device__ __forceinline__ void build_frags(uint4* nt, uint4* nn, const float* t, int rows,
                                            float scale, int threads) {
  for (int i = threadIdx.x; i < rows / 8 * 4 * kFragBlock; i += threads) {
    const int lane = i % kFragBlock, blk = i / kFragBlock, r = blk / 4, c = blk % 4;
    const int g = lane / 4, tt = lane % 4;
    uint32_t h0, h1, l0, l1;
    if (nt != nullptr) {
      const float* row = t + (8 * r + g) * kLd + 8 * c + tt;
      split_rz(row[0] * scale, h0, l0);
      split_rz(row[4] * scale, h1, l1);
      nt[i] = make_uint4(h0, h1, l0, l1);
    }
    if (nn != nullptr) {
      const float* col = t + (8 * r + 2 * tt) * kLd + 8 * c + g;
      split_rz(col[0] * scale, h0, l0);
      split_rz(col[kLd] * scale, h1, l1);
      nn[i] = make_uint4(h0, h1, l0, l1);
    }
  }
}

// bytes of a fragment tile of `rows` rows
__host__ __device__ constexpr int frag_tile_bytes(int rows) { return rows * kHD * 8; }

template <int N>
__device__ __forceinline__ void zero(float (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[i][e] = 0.f;
}

template <int N>
__device__ __forceinline__ void add(float (&a)[N][4], const float (&b)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[i][e] += b[i][e];
}

// 4-byte asynchronous copy (zeros when !valid)
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

// rows [r0, r0 + rows) of a head (row r at src + r ld, 32 floats, 16-byte
// aligned) into a [row][kLd] tile by 16-byte copies, zeros past n; by
// `threads` threads
__device__ __forceinline__ void stage_rows(float* dst, const float* src, size_t ld, int r0,
                                           int rows, int n, int threads) {
  for (int i = threadIdx.x; i < rows * (kHD / 4); i += threads) {
    const int r = i / (kHD / 4), c = i % (kHD / 4);
    const bool valid = r0 + r < n;
    const float* s = src + (valid ? static_cast<size_t>(r0 + r) * ld + 4 * c : 0);
    f32mma::cp_async16(static_cast<uint32_t>(__cvta_generic_to_shared(dst + r * kLd + 4 * c)),
                       s, valid);
  }
}

}  // namespace tf32attn
}  // namespace lavt
