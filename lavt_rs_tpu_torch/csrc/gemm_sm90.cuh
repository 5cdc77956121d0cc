// A bf16 x bf16 -> f32 tile GEMM for Hopper (sm_90a), written by hand:
// TMA loads into a ring of shared-memory stages, wgmma.mma_async on them,
// and an epilogue functor that each user supplies.  The LN-MLP tail's
// kernels (csrc/fused_mlp.cu, csrc/fused_mlp_bwd.cu) are built on it.
//
//   D[m, n] = sum_k A[m, k] B[n, k]
//
// Either operand may be K-major (K contiguous: A as (M, K), B as (N, K)
// row-major, e.g. xn W1^T with W1 (4C, C)) or MN-major (M or N
// contiguous: A stored (K, M), B stored (K, N), e.g. dmlp W2 with W2
// (C, 4C), or dmlp^T h), through wgmma's transpose bits for 16-bit types.
//
// A warpgroup's tile is 64 kMB rows x 128 columns (kMB = 2 for a plain
// product, 1 for a dual GEMM, which keeps two accumulators), 64 deep per
// stage.  384 threads: warpgroups 0 and 1 consume, warpgroup 2 produces
// (one thread issues every TMA load; the others leave); setmaxnreg moves
// registers from the producer (40) to the consumers (232: 128 accumulator
// registers a thread).  Blocks are persistent (at most one per SM) and
// walk the output tiles b, b + blocks, ...; the j-th tile of a block goes
// to consumer j % 2, so the two consumers ping-pong: one runs its
// epilogue (GELU, stores) while the other's wgmmas run.  The producer
// loads the tiles' stages in that order into one ring, and a consumer
// finds its tile's stages from the tile's place in the sequence.  The two
// mainloops take turns (tile j's after tile j - 1's, through two turn
// barriers), so a consumer never waits on a stage more than one round
// ahead of the last round waited on: a parity wait cannot pass on a stale
// phase.
//
// Shared memory per stage, 128-byte swizzled, as TMA writes it and as the
// wgmma descriptors read it: A (64 kMB rows, 8 or 16 KB) and B (128
// columns, 16 KB):
//   * K-major operand: one box of 64 (K, 128 bytes) x rows; atoms of 8
//     rows x 128 bytes (1024 bytes) follow each other (SBO = 1024); a
//     16-deep wgmma step moves the start address by 32 bytes;
//   * MN-major operand: boxes of 64 (MN, 128 bytes) x 64 (K) rows, 8 KB
//     each, the next 64 MN at +8192 bytes (LBO = 8192); 8 K rows per atom
//     (SBO = 1024); a 16-deep step moves by 2048 bytes.
// Outputs in bf16 leave through shared memory: a consumer stages its
// 64 x 128 blocks (32 KB per consumer) and one thread TMA-stores them,
// asynchronously, so the stores overlap the next tile's wgmmas.
// Each stage has a full barrier (the producer's arrive + the TMA bytes)
// and an empty one (the consumer's 128 threads arrive once the wgmmas
// that read the stage are done); a consumer keeps one stage's wgmmas in
// flight while it waits for the next.
//
// Ragged edges: TMA fills out-of-bounds rows of a box with zeros (rows of
// M past the end, B's rows past N, and the depth past K), so they add
// nothing; a TMA store clips rows >= M, and the f32 epilogues mask them.
// N is a multiple of 128 for the LN-MLP tail; K2p's projections (N = 3C =
// 288 and C = 96, csrc/window_msa_sm90.cu) take a ragged last column
// tile: the core skips its staged boxes past N and their epilogue reads
// no per-column data there.  A split over K (grid z) takes k-tiles
// [z kps, (z + 1) kps).
//
// Tensor maps are built on the host per call (`make_map`) through the
// driver's cuTensorMapEncodeTiled, fetched with cudaGetDriverEntryPoint,
// so the library needs no -lcuda; they reach the kernel as
// __grid_constant__ parameters.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace lavt {
namespace sm90 {

constexpr int kBN = 128, kBK = 64;
constexpr int kThreads = 384;
constexpr int kBoxBytes = 64 * 64 * 2;      // 64 rows of 128 bytes, 8 KB
constexpr int kBBytes = kBN * kBK * 2;      // B's stage, 16 KB
constexpr int kRingBytes = 128 * 1024;      // the operand stages
constexpr int kOutBytes = 32 * 1024;        // a consumer's staged output tile

// The shape of a warpgroup's tile and of the ring for kMB 64-row blocks.
template <int kMB>
struct Tile {
  static constexpr int kRows = 64 * kMB;
  static constexpr int kABytes = kRows * kBK * 2;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kStages = kRingBytes / kStageBytes;  // 4 or 5
  // the stages, the consumers' staged outputs, the stages' barriers, the
  // consumers' two turn and two staged-input barriers, the dual
  // epilogue's column sums (4 warps x 128 columns per consumer) and slack
  // to align the base to 1024
  static constexpr size_t kSmem = size_t(kStages) * kStageBytes + 2 * kOutBytes +
                                  (2 * kStages + 4) * 8 + 2 * 4 * kBN * 4 + 1024;
};

// -- host: tensor maps ----------------------------------------------------

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The encoder, and a context current on the calling thread, which the
// driver call needs: a host thread whose CUDA work so far went through
// another runtime (torch's, e.g. an autograd worker whose allocations
// came from torch's cache) has none, and the encode then fails with an
// invalid value.  cudaFree(0) makes the device's primary context current,
// once per thread.  nullptr if either fails.
inline EncodeTiledFn encode_tiled() {
  static thread_local const bool context = cudaFree(0) == cudaSuccess;
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return context ? fn : nullptr;
}

// A row-major bf16 (outer, inner) matrix in boxes of 64 inner elements
// (128 bytes, swizzled) by box_outer rows.
inline cudaError_t make_map(CUtensorMap* map, const void* ptr, int inner, int outer,
                            int box_outer) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {cuuint64_t(inner), cuuint64_t(outer)};
  const cuuint64_t strides[1] = {cuuint64_t(inner) * 2};
  const cuuint32_t box[2] = {64, cuuint32_t(box_outer)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The maps of the operands: A K-major (M, K) in boxes of 64 kMB rows, B
// K-major (N, K) in boxes of 128 rows; MN-major ones (K, MN) in boxes of
// 64 K rows.
template <int kMB>
inline cudaError_t map_a(CUtensorMap* map, const void* ptr, int inner, int outer, bool mn_major) {
  return make_map(map, ptr, inner, outer, mn_major ? 64 : Tile<kMB>::kRows);
}
inline cudaError_t map_b(CUtensorMap* map, const void* ptr, int inner, int outer, bool mn_major) {
  return make_map(map, ptr, inner, outer, mn_major ? 64 : kBN);
}
// A bf16 (rows, N) output written from staged 64 x 64 boxes.
inline cudaError_t map_out(CUtensorMap* map, const void* ptr, int n, int rows) {
  return make_map(map, ptr, n, rows, 64);
}

// What a launch passes: the A and B maps of one or two segments (a dual
// GEMM runs two products over the same output tile, each into its own
// accumulator), the depth in k-tiles of each, the k-tiles of a split, and
// the epilogue's arguments.
template <class EpiArgs>
struct GemmParams {
  CUtensorMap a0, b0, a1, b1;
  // the bf16 outputs an epilogue stages (Epi::kStaged), or c0 the output
  // and c1 an input of the same shape it reads in place (Epi::kStagedIn)
  CUtensorMap c0, c1;
  int k_tiles;
  int k_tiles_per_split;
  int m_tiles, n_tiles, n_cols;  // set by launch_gemm (n_cols: N)
  EpiArgs epi;
};

// -- device: barriers, TMA, wgmma -------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void tma_load(const CUtensorMap* map, uint32_t dst, uint64_t* bar,
                                         int inner, int outer) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(inner), "r"(outer)
      : "memory");
}

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// Staged output: a 64 x 128 bf16 block as two 64 x 64 boxes of 128-byte
// rows in the 128-byte swizzle TMA stores from (16-byte chunk c of row r
// at chunk c ^ (r % 8)).  The pairs a warp holds for one column group
// fall on 32 distinct banks.
__device__ __forceinline__ __nv_bfloat162* staged_pair(unsigned char* buf, int r, int c) {
  const int cc = c & 63;
  return reinterpret_cast<__nv_bfloat162*>(buf + (c >> 6) * kBoxBytes + r * 128 +
                                           (((cc >> 3) ^ (r & 7)) << 4) + (cc & 7) * 2);
}
__device__ __forceinline__ void stage_pair(unsigned char* buf, int r, int c, __nv_bfloat162 v) {
  *staged_pair(buf, r, c) = v;
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int inner,
                                          int outer) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::
                   "l"(reinterpret_cast<uint64_t>(map)),
               "r"(src), "r"(inner), "r"(outer)
               : "memory");
}

// one operand's stage of `boxes` x 64 MN: K-major, one box at (k0, mn0);
// MN-major, one box of 64 MN per 8 KB at (mn0 + 64 i, k0)
template <bool kMN, int kBoxes>
__device__ __forceinline__ void load_operand(const CUtensorMap* map, uint32_t dst, uint64_t* bar,
                                             int mn0, int k0) {
  if (kMN) {
#pragma unroll
    for (int i = 0; i < kBoxes; ++i) tma_load(map, dst + i * kBoxBytes, bar, mn0 + 64 * i, k0);
  } else {
    tma_load(map, dst, bar, k0, mn0);
  }
}

// shared-memory matrix descriptor, 128-byte swizzle
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t((lbo >> 4) & 0x3FFF) << 16) |
         (uint64_t((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// the descriptor of the 16-deep step kk of a stage (see the top note);
// `mb` picks a 64-row block of A (B is read whole, 128 wide); either
// layout puts 64 rows or 64 MN at 8192 bytes
template <bool kMN>
__device__ __forceinline__ uint64_t step_desc(uint32_t base, int mb, int kk) {
  return kMN ? smem_desc(base + mb * kBoxBytes + kk * 2048, kBoxBytes, 1024)
             : smem_desc(base + mb * kBoxBytes + kk * 32, 16, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator reads across the waits
template <int kN, int kM>
__device__ __forceinline__ void fence_acc(float (&d)[kN][kM]) {
#pragma unroll
  for (int n = 0; n < kN; ++n)
#pragma unroll
    for (int i = 0; i < kM; ++i) asm volatile("" : "+f"(d[n][i])::"memory");
}

// D (64 x 128, f32) += A (64 x 16) B (16 x 128); trans = MN-major operand
template <int kTA, int kTB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
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
      : "l"(da), "l"(db), "r"(1), "n"(kTA), "n"(kTB));
}

// One segment's k-tiles into acc (kMB row blocks): ring slot idx is
// stage idx % kStages in round idx / kStages.  Wait for each stage, issue
// its wgmmas (four 16-deep steps per row block), then release the stage
// before it (`pending`) once its wgmmas are done.
template <int kMB, bool kTA, bool kTB>
__device__ __forceinline__ void consume(float (&acc)[kMB][64], uint32_t a_base, uint32_t b_base,
                                        uint64_t* full, uint64_t* empty, int& idx, int& pending,
                                        int tiles) {
  using T = Tile<kMB>;
  for (int t = 0; t < tiles; ++t, ++idx) {
    const int stage = idx % T::kStages;
    mbar_wait(&full[stage], (idx / T::kStages) & 1);
    const uint32_t a = a_base + stage * T::kABytes;
    const uint32_t b = b_base + stage * kBBytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
      for (int mb = 0; mb < kMB; ++mb)
        wgmma_m64n128k16<kTA, kTB>(acc[mb], step_desc<kTA>(a, mb, kk), step_desc<kTB>(b, 0, kk));
    wgmma_commit();
    wgmma_wait<1>();
    if (pending >= 0) mbar_arrive(&empty[pending]);
    pending = stage;
  }
}

// Where the accumulator of a consumer warpgroup lies (wgmma's layout):
// acc[4 j + 2 h] and acc[4 j + 2 h + 1] are D[frag_row(row0, h),
// frag_col(col0, j)] and the column after it, j < 16, h < 2.  Warp w of
// the warpgroup holds rows 16 w .. 16 w + 15, lane l rows l / 4 and
// l / 4 + 8 and columns 2 (l % 4), + 1 of each 8-column group.  row0 /
// col0: the warpgroup's first row and column.
__device__ __forceinline__ int frag_row(int row0, int h) {
  const int t = threadIdx.x % 128;
  return row0 + (t / 32) * 16 + (t % 32) / 4 + 8 * h;
}
__device__ __forceinline__ int frag_col(int col0, int j) {
  return col0 + 8 * j + 2 * (threadIdx.x % 4);
}

// Grid (blocks, 1, splits): block b takes the output tiles b, b + blocks,
// ... (row-major over (ceil(M / (64 kMB)), N / 128)), its j-th tile on
// consumer j % 2.  Epi::store(args, acc0, acc1, row0, col0, red, out)
// finishes a 64 x 128 block of a consumer's tile (row0, col0: its first
// row and column): it stores f32 itself, or stages Epi::kStaged bf16
// blocks at out, out + 16 KB (`stage_pair`), which the core then writes
// with TMA stores through p.c0, p.c1 (TMA clips rows >= M) while the
// consumer goes on to its next tile.  With Epi::kStagedIn the consumer
// first TMA-loads the same blocks of p.c1 into out (while its mainloop
// runs; rows past M load as zeros) for the epilogue to read and overwrite
// in place.  `red` is 4 x 128 floats of the consumer's own shared memory
// for a column reduction (its users synchronise the consumer's 128
// threads with named barrier 1 + consumer).
template <class Epi, int kMB, bool kTA0, bool kTB0, bool kDual = false, bool kTA1 = false,
          bool kTB1 = false>
__global__ void __launch_bounds__(kThreads, 1)
    gemm_kernel(const __grid_constant__ GemmParams<typename Epi::Args> p) {
  using T = Tile<kMB>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t a_base = smem_u32(smem);
  const uint32_t b_base = a_base + T::kStages * T::kABytes;
  unsigned char* staged = smem + T::kStages * T::kStageBytes;  // 2 x kOutBytes
  uint64_t* full = reinterpret_cast<uint64_t*>(staged + 2 * kOutBytes);
  uint64_t* empty = full + T::kStages;
  uint64_t* turn = empty + T::kStages;  // consumer w may start its next mainloop
  uint64_t* in_full = turn + 2;         // consumer w's staged input has landed

  const int wg = threadIdx.x / 128;
  const int n_out = p.m_tiles * p.n_tiles;
  const int kt0 = blockIdx.z * p.k_tiles_per_split;
  const int tiles = min(p.k_tiles, kt0 + p.k_tiles_per_split) - kt0;
  const int per_tile = (kDual ? 2 : 1) * tiles;  // ring slots of one output tile

  if (threadIdx.x == 0) {
    for (int s = 0; s < T::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128);
    }
    mbar_init(&turn[0], 128);
    mbar_init(&turn[1], 128);
    mbar_init(&in_full[0], 1);
    mbar_init(&in_full[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      int idx = 0;
      for (int tile = blockIdx.x; tile < n_out; tile += gridDim.x) {
        const int m0 = tile / p.n_tiles * T::kRows, n0 = tile % p.n_tiles * kBN;
        for (int seg = 0; seg < (kDual ? 2 : 1); ++seg) {
          const CUtensorMap* ma = seg == 0 ? &p.a0 : &p.a1;
          const CUtensorMap* mb = seg == 0 ? &p.b0 : &p.b1;
          const bool ta = seg == 0 ? kTA0 : kTA1, tb = seg == 0 ? kTB0 : kTB1;
          for (int t = 0; t < tiles; ++t, ++idx) {
            const int k0 = (kt0 + t) * kBK, stage = idx % T::kStages;
            mbar_wait(&empty[stage], ((idx / T::kStages) & 1) ^ 1);
            mbar_expect_tx(&full[stage], T::kStageBytes);
            const uint32_t a = a_base + stage * T::kABytes;
            const uint32_t b = b_base + stage * kBBytes;
            if (ta) load_operand<true, kMB>(ma, a, &full[stage], m0, k0);
            else load_operand<false, kMB>(ma, a, &full[stage], m0, k0);
            if (tb) load_operand<true, 2>(mb, b, &full[stage], n0, k0);
            else load_operand<false, 2>(mb, b, &full[stage], n0, k0);
          }
        }
      }
    }
  } else {  // consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    float acc0[kMB][64], acc1[kDual ? kMB : 1][kDual ? 64 : 1];
    float* red = reinterpret_cast<float*>(in_full + 2) + wg * 4 * kBN;
    unsigned char* out = staged + wg * kOutBytes;
    const int bar = 1 + wg, t = threadIdx.x % 128;
    constexpr int kStaged = Epi::kStaged;
    static_assert(kMB * kStaged * 2 * kBoxBytes <= kOutBytes, "staged output fits");
    uint32_t turns = 0, inputs = 0;
    for (int j = wg;; j += 2) {
      const int tile = blockIdx.x + j * gridDim.x;
      if (tile >= n_out) break;
      const int m0 = tile / p.n_tiles * T::kRows, n0 = tile % p.n_tiles * kBN;
      if constexpr (Epi::kStagedIn) {  // once the last tile's stores have read `out`
        if (t == 0) {
          asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
          mbar_expect_tx(&in_full[wg], kMB * 2 * kBoxBytes);
          for (int mb = 0; mb < kMB; ++mb)
            for (int bx = 0; bx < 2; ++bx)
              tma_load(&p.c1, smem_u32(out) + (mb * 2 + bx) * kBoxBytes, &in_full[wg],
                       n0 + 64 * bx, m0 + 64 * mb);
        }
      }
#pragma unroll
      for (int mb = 0; mb < kMB; ++mb)
#pragma unroll
        for (int i = 0; i < 64; ++i) acc0[mb][i] = 0.f;
      if constexpr (kDual) {
#pragma unroll
        for (int mb = 0; mb < kMB; ++mb)
#pragma unroll
          for (int i = 0; i < 64; ++i) acc1[mb][i] = 0.f;
      }
      // pin the zero-fill here: defined inside a pipeline stage it would
      // serialize the wgmmas
      fence_acc(acc0);
      fence_acc(acc1);
      if (j > 0) mbar_wait(&turn[wg], turns++ & 1);  // tile j - 1's mainloop is done
      int idx = j * per_tile, pending = -1;
      consume<kMB, kTA0, kTB0>(acc0, a_base, b_base, full, empty, idx, pending, tiles);
      if constexpr (kDual)
        consume<kMB, kTA1, kTB1>(acc1, a_base, b_base, full, empty, idx, pending, tiles);
      mbar_arrive(&turn[wg ^ 1]);
      wgmma_wait<0>();
      if (pending >= 0) mbar_arrive(&empty[pending]);
      fence_acc(acc0);
      fence_acc(acc1);
      if constexpr (Epi::kStagedIn) {
        mbar_wait(&in_full[wg], inputs++ & 1);
      } else if constexpr (kStaged > 0) {  // the last tile's stores have read `out`
        if (t == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        named_sync(bar);
      }
#pragma unroll
      for (int mb = 0; mb < kMB; ++mb)
        Epi::store(p.epi, acc0[mb], acc1[kDual ? mb : 0], m0 + 64 * mb, n0, red,
                   out + mb * kStaged * 2 * kBoxBytes);
      if constexpr (kStaged > 0) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        named_sync(bar);
        if (t == 0) {
          for (int mb = 0; mb < kMB; ++mb)
            for (int o = 0; o < kStaged; ++o)
              for (int bx = 0; bx < 2; ++bx)
                if (n0 + 64 * bx < p.n_cols)  // a ragged last tile's boxes past N
                  tma_store(o == 0 ? &p.c0 : &p.c1,
                            smem_u32(out) + ((mb * kStaged + o) * 2 + bx) * kBoxBytes,
                            n0 + 64 * bx, m0 + 64 * mb);
          asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        }
      }
    }
    if (t == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

inline int sm_count() {
  static const int n = [] {
    int dev = 0, count = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    return count > 0 ? count : 1;
  }();
  return n;
}

// Launch on `stream` over the ceil(m / (64 kMB)) x ceil(n / 128) output
// tiles, times `splits` over K: at most one block per SM in all.
template <class Epi, int kMB, bool kTA0, bool kTB0, bool kDual = false, bool kTA1 = false,
          bool kTB1 = false>
cudaError_t launch_gemm(GemmParams<typename Epi::Args> p, int m, int n, int splits,
                        cudaStream_t stream) {
  using T = Tile<kMB>;
  auto kernel = gemm_kernel<Epi, kMB, kTA0, kTB0, kDual, kTA1, kTB1>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(T::kSmem));
  if (err != cudaSuccess) return err;
  p.m_tiles = (m + T::kRows - 1) / T::kRows;
  p.n_tiles = (n + kBN - 1) / kBN;
  p.n_cols = n;
  const int blocks = std::max(1, std::min(p.m_tiles * p.n_tiles, sm_count() / splits));
  kernel<<<dim3(blocks, 1, splits), kThreads, T::kSmem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace sm90
}  // namespace lavt
