// Shared pieces of the f32 window-attention kernels (K10 f32,
// csrc/window_attn_f32.cu; K9 f32, csrc/window_attn_bwd_f32.cu): FFMA tile
// products on 64 x 64 (and 64 x 32) shared-memory tiles by 128 threads,
// register-blocked so that every shared-memory word a thread loads feeds
// four or eight FMAs.
//
// Layouts (f32, head dim 32):
//   * a "d-major" tile holds 64 rows of a (rows, 32) operand transposed,
//     t[d * kLd + row]: the operands of S = A B^T (q k^T, do v^T, k q^T,
//     v do^T);
//   * a "row-major" tile holds 64 rows, t[row * kLdR + d] (v, k, q, do) or
//     t[row * kLd + col] (a 64 x 64 P or dS): the operands of O += P V.
// Threads: S tiles (64 x 64) by (ty, tx) = (t / 16, t % 16): rows ty 4 +
// 32 a + i (a < 2, i < 4), columns tx 4 + j (j < 4); a row's 16 threads are
// the 16 lanes of a half-warp.  O tiles (64 x 32) by (rg, dg) = (t / 8, t %
// 8): rows rg + 16 i (i < 4), columns dg 4 + j.  Strides 68 and 36 keep
// each load one shared-memory wavefront or two (16-byte words on distinct
// banks or broadcast).
#pragma once

#include "common.cuh"

namespace lavt {
namespace attn32 {

constexpr int kHD = 32, kT = 64, kThreads = 128;
constexpr int kLd = 68;   // d-major tiles and 64 x 64 row-major tiles
constexpr int kLdR = 36;  // 64 x 32 row-major tiles
constexpr int kTileT = kHD * kLd;   // floats of a d-major tile
constexpr int kTileR = kT * kLdR;   // ... of a 64 x 32 row-major tile
constexpr int kTileS = kT * kLd;    // ... of a 64 x 64 tile

__device__ __forceinline__ float neg_inf() { return __int_as_float(static_cast<int>(0xff800000u)); }

// rows [row0, row0 + 64) of one head (row r at src + r * sn, 32 contiguous
// floats), times `scale`, into a d-major tile; zeros past N.  Consecutive
// lanes take consecutive rows, so the transposed stores are conflict-free.
__device__ __forceinline__ void load_t(float* dst, const float* src, long long sn, int row0,
                                       int n, float scale = 1.f) {
  for (int idx = threadIdx.x; idx < kT * kHD / 4; idx += kThreads) {
    const int r = idx % kT, c = idx / kT;
    float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n) t = __ldg(reinterpret_cast<const float4*>(src + (row0 + r) * sn + 4 * c));
    dst[(4 * c) * kLd + r] = t.x * scale;
    dst[(4 * c + 1) * kLd + r] = t.y * scale;
    dst[(4 * c + 2) * kLd + r] = t.z * scale;
    dst[(4 * c + 3) * kLd + r] = t.w * scale;
  }
}

// the same rows into a 64 x 32 row-major tile
__device__ __forceinline__ void load_r(float* dst, const float* src, long long sn, int row0,
                                       int n, float scale = 1.f) {
  for (int idx = threadIdx.x; idx < kT * kHD / 4; idx += kThreads) {
    const int r = idx / (kHD / 4), c = idx % (kHD / 4);
    float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n) t = __ldg(reinterpret_cast<const float4*>(src + (row0 + r) * sn + 4 * c));
    t.x *= scale, t.y *= scale, t.z *= scale, t.w *= scale;
    *reinterpret_cast<float4*>(dst + r * kLdR + 4 * c) = t;
  }
}

// acc[4 a + i][j] += sum_d A[d][ty 4 + 32 a + i] B[d][tx 4 + j]: a 64 x 64 x 32
// product of two d-major tiles (8 x 4 outputs a thread)
__device__ __forceinline__ void mma_nt(float (&acc)[8][4], const float* A, const float* B,
                                       int ty, int tx) {
#pragma unroll 8
  for (int d = 0; d < kHD; ++d) {
    const float4 a0 = *reinterpret_cast<const float4*>(A + d * kLd + 4 * ty);
    const float4 a1 = *reinterpret_cast<const float4*>(A + d * kLd + 32 + 4 * ty);
    const float4 b = *reinterpret_cast<const float4*>(B + d * kLd + 4 * tx);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int r = 0; r < 8; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
    }
  }
}

// acc[i][j] += sum_{k < kk} A[rg + 16 i][k] B[k][dg 4 + j]: A a 64 x 64
// row-major tile (P or dS), B a 64 x 32 row-major tile; kk a multiple of 4
// (A's columns and B's rows past the real ones hold zeros)
__device__ __forceinline__ void mma_nn(float (&acc)[4][4], const float* A, const float* B, int rg,
                                       int dg, int kk) {
  for (int k = 0; k < kk; k += 4) {
    float4 a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(A + (rg + 16 * i) * kLd + k);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float4 b = *reinterpret_cast<const float4*>(B + (k + e) * kLdR + 4 * dg);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float av = e == 0 ? a[i].x : e == 1 ? a[i].y : e == 2 ? a[i].z : a[i].w;
        acc[i][0] = fmaf(av, b.x, acc[i][0]);
        acc[i][1] = fmaf(av, b.y, acc[i][1]);
        acc[i][2] = fmaf(av, b.z, acc[i][2]);
        acc[i][3] = fmaf(av, b.w, acc[i][3]);
      }
    }
  }
}

// the row of S element (r, c) of thread (ty, tx), and its column
__device__ __forceinline__ int s_row(int ty, int r) { return 4 * ty + 32 * (r / 4) + r % 4; }
__device__ __forceinline__ int s_col(int tx, int c) { return 4 * tx + c; }

// max / sum over the 16 lanes of a half-warp (one S row's threads)
__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// a thread's 8 x 4 S elements into a 64 x 64 row-major tile
__device__ __forceinline__ void store_s(float* dst, const float (&s)[8][4], int ty, int tx) {
#pragma unroll
  for (int r = 0; r < 8; ++r)
    *reinterpret_cast<float4*>(dst + s_row(ty, r) * kLd + 4 * tx) =
        make_float4(s[r][0], s[r][1], s[r][2], s[r][3]);
}

}  // namespace attn32
}  // namespace lavt
