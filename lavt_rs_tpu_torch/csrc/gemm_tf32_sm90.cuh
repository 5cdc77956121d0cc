// The 3xTF32 GEMM core of the f32 variants for Hopper (sm_90a): TMA loads
// into a ring of 128-byte-swizzled stages, warpgroup tensor-core products
// (wgmma.mma_async ... tf32) and an epilogue functor that each user
// supplies.  csrc/gemm_f32.cu (the projections and the LN-MLP GEMMs of K1,
// K11, K3, K8, K2p, K2 and the save mode f32) and csrc/fused_mlp_bwd_f32.cu
// (K7 f32's dual GEMM, weight grads and dyln; K5 f32's dattn, dx and weight
// grads) are built on it.
//
//   D[m, n] = sum_k A[m, k] B[n, k]
//
// Accuracy (3xTF32).  A TF32 product keeps 10 mantissa bits of a factor,
// too coarse for f32.  Each operand x is taken as hi + lo, hi = x with its
// 13 low bits cleared (truncation: the tensor core reads a tf32 operand's
// top 19 bits, so the f32 tile as TMA lands it serves as hi) and lo = x -
// hi (exact; the tensor core truncates it in turn), and each product as
// lo hi + hi lo + hi hi with f32 accumulation (lo lo, ~2^-20 relative,
// dropped).  The tensor cores do not round their accumulation to nearest:
// summed into one accumulator over K = 4096, the error reached 1.2e-4 on
// an H100.  So each 32-deep stage's twelve products (4 k-steps of 8, three
// passes) go into a zeroed partial accumulator (wgmma scale-d = 0 first),
// which rounded FADDs add to the running sum.
//
// tf32 wgmma reads both shared-memory operands K-major (the transpose bits
// exist only for 16-bit types), and takes A from registers.  So:
//   * A comes from registers: each consumer thread loads its fragment of
//     the raw stage (K-major, or MN-major when A's rows are the depth, as
//     in a weight grad) and splits it there, 4 k-steps x (hi, lo) = 32
//     registers, alive until the stage's wgmmas are done;
//   * B comes from shared memory, as two tiles of the same 128-byte swizzle:
//     hi and lo.  K-major B (every weight read as (N, K): the projections,
//     fc1 and fc2, the dual GEMM's W1 and W2's K-major copy): hi is the
//     raw stage and lo comes split already, lo = w - trunc(w) written once
//     a weight version (the model's f32 route keeps it beside the weight)
//     or once a call, brought by a third TMA load beside hi.  MN-major B
//     (a weight grad's activation, a weight read as (K, N)): the stagers
//     transpose the raw boxes into a hi and a lo tile as they split them,
//     the one pass that touches every element anyway.  Their writes are
//     generic-proxy writes: each stager fences them
//     (fence.proxy.async.shared::cta) before it arrives on the stage's
//     ready barrier, which the consumers wait on before their wgmmas.
//   (The design before split a K-major B's lo by the stagers too, for every
//   32-deep stage of every output tile: a 16 KB shared-memory read and
//   write a stage in a core that its shared memory bounds, PERF.md.)
//
// Roles (384 threads, one block an SM, persistent over the output tiles
// b, b + blocks, ... row-major over (ceil(M / 128), ceil(N / 128))):
//   * warpgroups 0 and 1 consume: warpgroup w computes rows 64 w .. of the
//     block's 128 x 128 tile (m64n128k8: 64 accumulator registers and 64
//     of the stage's partial), both on one B stage;
//   * warpgroup 2 produces (setmaxnreg moves registers to the consumers):
//     lane 0 of its first warp issues the TMA loads, its other three warps
//     (96 threads) are the stagers (an MN-major B's; idle otherwise).
// Each stage has three barriers: full (the TMA bytes), ready (the 96
// stagers; MN-major B only) and empty (the consumers' 256 threads, once
// the wgmmas that read the stage are done).  The consumer of a stage waits
// on full too, which makes the TMA-written A tile visible to its loads.
//
// Shared memory per stage, each operand tile 128 rows x 32 floats (16 KB,
// atoms of 8 rows x 128 bytes, SBO 1024; an 8-deep wgmma step moves the
// descriptor's start by 32 bytes): A raw, B raw (K-major: B hi), B lo and,
// with an MN-major B, B hi.  An MN-major raw tile is four TMA boxes of 32 MN x 32 K
// (4 KB each, element (mn, k) of box mn / 32 at k 128 + 16 ((mn % 32 / 4)
// ^ (k % 8)) + 4 (mn % 4) bytes).  Four stages of 48 KB (K-major B) or
// three of 64 KB (MN-major B); the dual GEMM keeps three 48 KB stages and a
// 64 KB stash for its first product (`Ring`).
//
// Ragged edges: TMA fills the rows of a box past the tensor (M, N, or the
// depth K of a weight grad) with zeros, which add nothing; the epilogues
// mask rows >= M and columns >= N.  A split over K (grid z) takes the
// k-tiles [z kps, (z + 1) kps).
//
// Tensor maps are built on the host per call through the driver's
// cuTensorMapEncodeTiled (sm90::encode_tiled, which makes the device's
// primary context current once per host thread).
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "common.cuh"
#include "gemm_sm90.cuh"

namespace lavt {
namespace tf32 {

using sm90::mbar_arrive;
using sm90::mbar_expect_tx;
using sm90::mbar_init;
using sm90::mbar_wait;
using sm90::named_sync;
using sm90::smem_u32;
using sm90::tma_load;

constexpr int kBK = 32;                  // depth of a stage: one 128-byte f32 row
constexpr int kTile = 128;               // rows and columns of a block's output tile
constexpr int kThreads = 384;
constexpr int kOpBytes = kTile * kBK * 4;  // one operand's 128 x 32 stage, 16 KB
constexpr int kBoxBytes = 32 * kBK * 4;    // an MN-major box, 32 MN x 32 K, 4 KB
constexpr int kStagers = 96;               // warps 1-3 of the producer warpgroup
constexpr int kStashBytes = 2 * 64 * kTile * 4;  // the dual's first product, 64 KB
constexpr int kRedBytes = 2 * 4 * kTile * 4;     // the consumers' column sums, 4 KB
// setmaxnreg moves registers within the block's launch allocation (168 a
// thread at 384 threads, one block an SM): 128 x 56 + 256 x 224 = 384 x 168
constexpr int kProducerRegs = 56, kConsumerRegs = 224;

// The ring of a kernel: B MN-major (transposed by the stagers) or not, the
// dual GEMM's stash or not.
template <bool kTB, bool kDual>
struct Ring {
  static constexpr int kTiles = kTB ? 4 : 3;  // A raw, B raw, B lo (, B hi)
  static constexpr int kStageBytes = kTiles * kOpBytes;
  static constexpr int kStages = kDual ? 3 : (kTB ? 3 : 4);
  static constexpr int kBLo = 2 * kOpBytes;                  // offsets in a stage
  static constexpr int kBHi = kTB ? 3 * kOpBytes : kOpBytes;
  // the stages, the stash and column sums (dual), three barriers a stage,
  // and slack to align the base to 1024
  static constexpr size_t kSmem = size_t(kStages) * kStageBytes +
                                  (kDual ? kStashBytes + kRedBytes : 0) + 3 * kStages * 8 + 1024;
};

// -- host: tensor maps ----------------------------------------------------

// A row-major f32 (outer, inner) matrix in boxes of 32 inner elements (128
// bytes, swizzled) by box_outer rows.
inline cudaError_t make_map(CUtensorMap* map, const void* ptr, int inner, int outer,
                            int box_outer) {
  const sm90::EncodeTiledFn fn = sm90::encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {cuuint64_t(inner), cuuint64_t(outer)};
  const cuuint64_t strides[1] = {cuuint64_t(inner) * 4};
  const cuuint32_t box[2] = {32, cuuint32_t(box_outer)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(ptr), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// An operand's map: K-major, stored (rows, K), in boxes of 128 rows;
// MN-major, stored (K, MN), in boxes of 32 K rows.
inline cudaError_t map_operand(CUtensorMap* map, const void* ptr, int mn, int k, bool mn_major) {
  return mn_major ? make_map(map, ptr, mn, k, kBK) : make_map(map, ptr, k, mn, kTile);
}

// What a launch passes: the A and B maps of one or two segments (the dual
// GEMM runs two products over the same output tile) and, for a K-major B,
// the maps of B's lo, the depth in k-tiles, the k-tiles of a split, and
// the epilogue's arguments.
template <class EpiArgs>
struct Params {
  CUtensorMap a0, b0, a1, b1;
  CUtensorMap b0_lo, b1_lo;  // K-major B: its lo, stored like b0 / b1
  int k_tiles, k_tiles_per_split;
  int m_tiles, n_tiles;  // set by launch
  EpiArgs epi;
};

// -- device ---------------------------------------------------------------

__device__ __forceinline__ uint32_t trunc_bits(float x) {
  return __float_as_uint(x) & 0xffffe000u;
}

__device__ __forceinline__ float lo_of(float x) { return x - __uint_as_float(trunc_bits(x)); }

// byte offset of element (r, k) in a K-major 128 x 32 tile
__device__ __forceinline__ int kmajor_off(int r, int k) {
  return r * 128 + ((((k >> 2) ^ (r & 7))) << 4) + (k & 3) * 4;
}

// byte offset of element (mn, k) in an MN-major tile of four 32 x 32 boxes
__device__ __forceinline__ int mnmajor_off(int mn, int k) {
  return (mn >> 5) * kBoxBytes + k * 128 + (((((mn & 31) >> 2) ^ (k & 7))) << 4) + (mn & 3) * 4;
}

// shared-memory matrix descriptor of a K-major 128-byte-swizzled tile at
// `addr`, k-step kk (32 bytes each)
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr, int kk) {
  return sm90::smem_desc(addr + kk * 32, 16, 1024);
}

// D (64 x 128, f32) (+)= A (64 x 8, tf32 registers) B (8 x 128, tf32
// shared memory): scale_d = 0 overwrites D
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
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
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(d[i][j])::"memory");
}

// Where a consumer's accumulator lies (wgmma's layout): acc[4 j + 2 h + e]
// is D[row0 + frag_row(h), col0 + frag_col(j) + e], j < 16, h, e < 2.
__device__ __forceinline__ int frag_row(int h) {
  const int t = threadIdx.x % 128;
  return (t / 32) * 16 + (t % 32) / 4 + 8 * h;
}
__device__ __forceinline__ int frag_col(int j) { return 8 * j + 2 * (threadIdx.x % 4); }

// The stagers' pass over one stage of an MN-major B (96 threads, `sid` <
// 96): the raw boxes transposed into K-major hi = trunc(x) and lo tiles.
// Each warp's 16-byte reads and 4-byte writes fall on distinct banks.
__device__ __forceinline__ void stage_b(unsigned char* b_raw, unsigned char* b_lo,
                                        unsigned char* b_hi, int sid) {
  for (int u = sid; u < kOpBytes / 16; u += kStagers) {
    const int k = u & 31, nq = u >> 5;  // rows 4 nq .. 4 nq + 3 at depth k
    const float4 v = *reinterpret_cast<const float4*>(b_raw + mnmajor_off(4 * nq, k));
    const float x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int off = kmajor_off(4 * nq + i, k);
      const uint32_t hi = trunc_bits(x[i]);
      *reinterpret_cast<uint32_t*>(b_hi + off) = hi;
      *reinterpret_cast<float*>(b_lo + off) = x[i] - __uint_as_float(hi);
    }
  }
}

// A consumer's A fragments of one stage, split: ah / al [k-step][4], rows
// row0 + frag rows of the warp (m64 k8 tf32: a0 (g, t), a1 (g + 8, t), a2
// (g, t + 4), a3 (g + 8, t + 4) of the warp's 16 rows).
template <bool kTA>
__device__ __forceinline__ void load_a(const unsigned char* a, int row0, uint32_t (&ah)[4][4],
                                       uint32_t (&al)[4][4]) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int r = row0 + ((threadIdx.x % 128) / 32) * 16 + g;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rr = r + 8 * (i & 1), k = 8 * kk + t + 4 * (i >> 1);
      const float x = *reinterpret_cast<const float*>(
          a + (kTA ? mnmajor_off(rr, k) : kmajor_off(rr, k)));
      ah[kk][i] = trunc_bits(x);
      al[kk][i] = __float_as_uint(x - __uint_as_float(ah[kk][i]));
    }
}

// Grid (blocks, 1, splits).  Epi::store(args, acc, stash, row0, col0, red)
// finishes a consumer's 64 x 128 block (row0, col0: its first row and
// column); with kDual, acc is the second product and `stash` the
// consumer's copy of the first (thread t's value i at stash[i 128 + t]).
// `red` is 4 x 128 floats of the consumer's own shared memory (named
// barrier 1 + consumer synchronises its 128 threads).
template <class Epi, bool kTA, bool kTB, bool kDual>
__global__ void __launch_bounds__(kThreads, 1)
    gemm_tf32_kernel(const __grid_constant__ Params<typename Epi::Args> p) {
  using R = Ring<kTB, kDual>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* extra = smem + R::kStages * R::kStageBytes;  // stash, column sums
  uint64_t* full = reinterpret_cast<uint64_t*>(extra + (kDual ? kStashBytes + kRedBytes : 0));
  uint64_t* ready = full + R::kStages;
  uint64_t* empty = ready + R::kStages;

  const int wg = threadIdx.x / 128;
  const int n_out = p.m_tiles * p.n_tiles;
  const int kt0 = blockIdx.z * p.k_tiles_per_split;
  const int tiles = min(p.k_tiles, kt0 + p.k_tiles_per_split) - kt0;
  constexpr int kSegs = kDual ? 2 : 1;

  if (threadIdx.x == 0) {
    for (int s = 0; s < R::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&ready[s], kStagers);
      mbar_init(&empty[s], 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {  // producer: the TMA lane and the stagers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const int sid = static_cast<int>(threadIdx.x) - 256 - 32;  // stager id, < 0: none
    if (threadIdx.x == 256) {
      int idx = 0;
      for (int tile = blockIdx.x; tile < n_out; tile += gridDim.x) {
        const int m0 = tile / p.n_tiles * kTile, n0 = tile % p.n_tiles * kTile;
        for (int seg = 0; seg < kSegs; ++seg) {
          const CUtensorMap* ma = seg == 0 ? &p.a0 : &p.a1;
          const CUtensorMap* mb = seg == 0 ? &p.b0 : &p.b1;
          const CUtensorMap* mlo = seg == 0 ? &p.b0_lo : &p.b1_lo;
          for (int t = 0; t < tiles; ++t, ++idx) {
            const int k0 = (kt0 + t) * kBK, s = idx % R::kStages;
            mbar_wait(&empty[s], ((idx / R::kStages) & 1) ^ 1);
            mbar_expect_tx(&full[s], (kTB ? 2 : 3) * kOpBytes);
            const uint32_t a = smem_u32(smem + s * R::kStageBytes), b = a + kOpBytes;
            if (kTA) {
              for (int i = 0; i < 4; ++i) tma_load(ma, a + i * kBoxBytes, &full[s], m0 + 32 * i, k0);
            } else {
              tma_load(ma, a, &full[s], k0, m0);
            }
            if (kTB) {
              for (int i = 0; i < 4; ++i) tma_load(mb, b + i * kBoxBytes, &full[s], n0 + 32 * i, k0);
            } else {  // B's hi is the raw tile, its lo comes beside it
              tma_load(mb, b, &full[s], k0, n0);
              tma_load(mlo, a + R::kBLo, &full[s], k0, n0);
            }
          }
        }
      }
    } else if (sid >= 0 && kTB) {
      int idx = 0;
      for (int tile = blockIdx.x; tile < n_out; tile += gridDim.x)
        for (int seg = 0; seg < kSegs; ++seg)
          for (int t = 0; t < tiles; ++t, ++idx) {
            const int s = idx % R::kStages;
            mbar_wait(&full[s], (idx / R::kStages) & 1);
            unsigned char* st = smem + s * R::kStageBytes;
            stage_b(st + kOpBytes, st + R::kBLo, st + R::kBHi, sid);
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            mbar_arrive(&ready[s]);
          }
    }
  } else {  // consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    float acc[64], part[64];
    float* stash = reinterpret_cast<float*>(extra) + wg * 64 * kTile;
    float* red = reinterpret_cast<float*>(extra + kStashBytes) + wg * 4 * kTile;
    const int t128 = threadIdx.x % 128;
    int idx = 0;
    for (int tile = blockIdx.x; tile < n_out; tile += gridDim.x) {
      const int m0 = tile / p.n_tiles * kTile, n0 = tile % p.n_tiles * kTile;
      for (int seg = 0; seg < kSegs; ++seg) {
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] = 0.f;
        for (int t = 0; t < tiles; ++t, ++idx) {
          const int s = idx % R::kStages, parity = (idx / R::kStages) & 1;
          mbar_wait(&full[s], parity);
          if (kTB) mbar_wait(&ready[s], parity);
          const unsigned char* st = smem + s * R::kStageBytes;
          uint32_t ah[4][4], al[4][4];
          load_a<kTA>(st, 64 * wg, ah, al);
          const uint32_t bhi = smem_u32(st + R::kBHi), blo = smem_u32(st + R::kBLo);
          sm90::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            wgmma_tf32(part, al[kk], kmajor_desc(bhi, kk), kk != 0);
            wgmma_tf32(part, ah[kk], kmajor_desc(blo, kk), 1);
          }
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) wgmma_tf32(part, ah[kk], kmajor_desc(bhi, kk), 1);
          sm90::wgmma_commit();
          sm90::wgmma_wait<0>();
          fence_regs(part);
          fence_regs(ah);
          fence_regs(al);
          mbar_arrive(&empty[s]);
#pragma unroll
          for (int i = 0; i < 64; ++i) acc[i] += part[i];
        }
        if (kDual && seg == 0) {
#pragma unroll
          for (int i = 0; i < 64; ++i) stash[i * 128 + t128] = acc[i];
        }
      }
      Epi::store(p.epi, acc, stash, m0 + 64 * wg, n0, red);
    }
  }
}

// Launch on `stream` over the ceil(m / 128) x ceil(n / 128) output tiles,
// times `splits` over K: at most one block per SM in all.
template <class Epi, bool kTA, bool kTB, bool kDual>
cudaError_t launch(Params<typename Epi::Args> p, int m, int n, int splits, cudaStream_t stream) {
  using R = Ring<kTB, kDual>;
  auto kernel = gemm_tf32_kernel<Epi, kTA, kTB, kDual>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(R::kSmem));
  if (err != cudaSuccess) return err;
  p.m_tiles = (m + kTile - 1) / kTile;
  p.n_tiles = (n + kTile - 1) / kTile;
  const int blocks = std::max(1, std::min(p.m_tiles * p.n_tiles, sm90::sm_count() / splits));
  kernel<<<dim3(blocks, 1, splits), kThreads, R::kSmem, stream>>>(p);
  return cudaGetLastError();
}

// Each consumer thread's float2 pairs of a 64 x 128 block: f(row, col, v0,
// v1) for rows < m and columns < n (col even; n even).
template <class F>
__device__ __forceinline__ void for_pairs(const float (&acc)[64], int row0, int col0, int m, int n,
                                          F&& f) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + frag_row(h);
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = col0 + frag_col(j);
      if (col < n) f(row, col, acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace tf32
}  // namespace lavt
