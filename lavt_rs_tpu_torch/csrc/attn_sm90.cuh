// Shared pieces of the Hopper (sm_90a) attention kernels: K10
// (csrc/window_attn_sm90.cu), K9 (csrc/window_attn_bwd_sm90.cu) and K5's
// attention launch (csrc/fused_msa_bwd_sm90.cu).  Head dim 32: a head's row
// is 64 bytes, and a tile of 64 rows of one head (4 KB) is what one TMA box
// of a 4-D (hd, heads | N, N | heads, windows) tensor map brings, in the
// 64-byte swizzle (16-byte chunk j of row r at chunk j ^ ((r / 2) % 4)).
// wgmma reads such a tile as a K-major operand (rows = M or N, 32 deep:
// two 16-deep steps 32 bytes apart) or as an MN-major one (rows = K, 32
// wide: a 16-deep step is 16 rows, 1024 bytes).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "gemm_sm90.cuh"

namespace lavt {
namespace attn {

using sm90::mbar_expect_tx;
using sm90::mbar_init;
using sm90::mbar_wait;
using sm90::named_sync;
using sm90::smem_u32;
using sm90::wgmma_commit;
using sm90::wgmma_fence;
using sm90::wgmma_wait;

constexpr int kHD = 32;                    // head dim
constexpr int kT = 64;                     // rows of a tile (one wgmma M)
constexpr int kTileBytes = kT * kHD * 2;   // a q, k, v or do tile: 4 KB
constexpr float kLog2e = 1.4426950408889634f;

// floats [f, f + count) of a 16-byte-aligned f32 array as the 16-byte-aligned
// span that holds them (the bulk copy's unit): they start at float f % 4 of
// it.  The span stays inside any allocation of 16-byte granularity.
__host__ __device__ inline int span_bytes(long long f, int count) {
  return static_cast<int>(((f + count + 3) / 4 - f / 4) * 16);
}
__device__ __forceinline__ void bulk(uint32_t dst, const float* base, long long f, int count,
                                     uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(base + f / 4 * 4), "r"(span_bytes(f, count)), "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void tma3(const CUtensorMap* m, uint32_t dst, uint64_t* bar, int c0,
                                     int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(m)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void tma4(const CUtensorMap* m, uint32_t dst, uint64_t* bar, int c0,
                                     int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(m)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// shared-memory matrix descriptors: 64-byte swizzle (the head tiles) and
// 128-byte swizzle (64-column boxes of 128-byte rows)
__device__ __forceinline__ uint64_t desc64(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t((lbo >> 4) & 0x3FFF) << 16) |
         (uint64_t((sbo >> 4) & 0x3FFF) << 32) | (2ull << 62);
}
__device__ __forceinline__ uint64_t desc128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t((lbo >> 4) & 0x3FFF) << 16) |
         (uint64_t((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}
// a head tile as a K-major B (rows = N) at 16-deep step ks, and as an
// MN-major B (rows = K) at step kk
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int ks) {
  return desc64(tile + ks * 32, 16, 512);
}
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int kk) {
  return desc64(tile + kk * 1024, 4096, 512);
}

// S (64 x 64, f32) (+)= A (64 x 16 bf16, registers) B (64 x 16, K-major)
__device__ __forceinline__ void wgmma_s(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O (64 x 32, f32) += A (64 x 16 bf16, registers) B (16 x 32, MN-major)
__device__ __forceinline__ void wgmma_o(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O (64 x 32, f32) += A (64 x 16, shared memory: K-major, or MN-major with
// kTA) B (16 x 32, MN-major)
template <int kTA>
__device__ __forceinline__ void wgmma_o_ss(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, %19, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1), "n"(kTA));
}

// D (64 x 144, f32) (+)= A (64 x 16 bf16, registers) B (144 x 16, K-major)
__device__ __forceinline__ void wgmma_n144(float (&d)[72], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %77, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n144k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71}, "
      "{%72, %73, %74, %75}, %76, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// pin register values at this point of the instruction stream (around the
// wgmma fences and waits)
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

__device__ __forceinline__ float neg_inf() { return __int_as_float(static_cast<int>(0xff800000u)); }
__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }

__device__ __forceinline__ uint32_t pack_bf2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// the bf16 pair at (row r, column c) of a 64 x 32 tile in the 64-byte
// swizzle (16-byte chunk j of row r at chunk j ^ ((r / 2) % 4)), times
// scale, rounded to bf16
__device__ __forceinline__ uint32_t q_pair(const unsigned char* tile, int r, int c, float scale) {
  const int b = c * 2;
  const uint32_t v = *reinterpret_cast<const uint32_t*>(
      tile + r * 64 + ((((b >> 4) ^ (r >> 1)) & 3) << 4) + (b & 15));
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
  return pack_bf2(f.x * scale, f.y * scale);
}

// A fragments (two 16-deep steps) of a warpgroup's 64 x 32 tile: rows
// warp 16 + g (+ 8), columns 16 ks + 2 tq (+ 1, + 8, + 9), times scale
__device__ __forceinline__ void tile_frags(uint32_t (&a)[2][4], const unsigned char* tile,
                                           float scale) {
  const int t = threadIdx.x % 128, warp = t / 32, g = (t % 32) / 4, tq = t % 4;
  const int ra = warp * 16 + g, rb = ra + 8;
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    const int c = 16 * ks + 2 * tq;
    a[ks][0] = q_pair(tile, ra, c, scale);
    a[ks][1] = q_pair(tile, rb, c, scale);
    a[ks][2] = q_pair(tile, ra, c + 8, scale);
    a[ks][3] = q_pair(tile, rb, c + 8, scale);
  }
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// -- host: tensor maps --------------------------------------------------------

inline cudaError_t encode(CUtensorMap* map, CUtensorMapDataType dt, int rank, const void* ptr,
                          const cuuint64_t* dims, const cuuint64_t* strides,
                          const cuuint32_t* box, CUtensorMapSwizzle swizzle) {
  const sm90::EncodeTiledFn fn = sm90::encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, dt, rank, const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// q, k, v (or do): (hd, heads, N, windows) at the given element strides, the
// two middle dims in the order of their strides; boxes of one head's 64 rows
inline cudaError_t map_qkv(CUtensorMap* map, const void* ptr, int Bw, int heads, int n,
                           long long sw, long long sh, long long sn) {
  const bool hfirst = sh < sn;
  const cuuint64_t dims[4] = {kHD, cuuint64_t(hfirst ? heads : n), cuuint64_t(hfirst ? n : heads),
                              cuuint64_t(Bw)};
  const cuuint64_t strides[3] = {cuuint64_t(hfirst ? sh : sn) * 2,
                                 cuuint64_t(hfirst ? sn : sh) * 2, cuuint64_t(sw) * 2};
  const cuuint32_t box[4] = {kHD, hfirst ? 1u : cuuint32_t(kT), hfirst ? cuuint32_t(kT) : 1u, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, ptr, dims, strides, box,
                CU_TENSOR_MAP_SWIZZLE_64B);
}

// an f32 (count, N, N) bias or mask with rows `ld` floats apart, in boxes of
// 64 rows x `cols` keys
inline cudaError_t map_bm(CUtensorMap* map, const void* ptr, int count, int n, int ld,
                          int cols) {
  const cuuint64_t dims[3] = {cuuint64_t(n), cuuint64_t(n), cuuint64_t(count)};
  const cuuint64_t strides[2] = {cuuint64_t(ld) * 4, cuuint64_t(ld) * n * 4};
  const cuuint32_t box[3] = {cuuint32_t(cols), kT, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, ptr, dims, strides, box,
                CU_TENSOR_MAP_SWIZZLE_NONE);
}

}  // namespace attn
}  // namespace lavt
