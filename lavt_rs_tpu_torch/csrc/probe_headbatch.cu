// P1 / P2: the toy attention of the head-batching probe.
//
// Replaces the two Pallas kernels of tools/probe_headbatch.py, which probe
// whether the per-op cost of many small per-head products, not the matrix
// unit, bounds the fused MSA:
//   P1 loop_kernel (pallas_call at :88): one head at a time;
//   P2 batch_kernel (pallas_call at :92): all heads of a block together,
//      after a relayout into a (heads ch, n, hd) VMEM scratch.
// Both compute, for every window of n tokens and every head (hd = 32), with
// q = k = v = the head's 32 columns of x:
//   S = q q^T (f32),  P = exp(min(S, 80)) / rowsum  (bf16),  O = P v (f32 -> bf16)
// and write O into the head's columns.  x is (grid ch n, heads hd) bf16;
// a row block is ch windows (ch n rows).
//
// Bound on the H100: bytes.  The products are 4 n^2 hd flops per window and
// head (3.1 GFLOP at the tool's defaults, 3 us at the bf16 peak) against a
// read and a write of x (21 MB, 6 us).
//
// One core, two schedules.  A block stages its (window, head) slots of a
// row block by TMA: one 2-D tensor-map box per slot (the slot's n rows x
// 64 bytes, in the 64-byte swizzle, so the ldmatrix reads below are
// conflict-free), each slot on its own mbarrier, all issued at the start,
// so the first slots' math overlaps the later slots' loads.  A warp takes
// a (slot, 16-row group) task: it holds its 16 rows' S (16 x n f32, n / 8
// mma.sync m16n8k16 tiles) in registers, with no score tile in shared
// memory, forms P there, and runs P v from registers (A fragments from the
// S fragments, v by ldmatrix.trans from the slot's tile).  O goes from
// registers straight to its columns in device memory: the staged x is
// never written, so no warp's O can reach columns another warp still reads.
// The schedules differ as the two Pallas kernels do:
//   * P2 (head-batched): block (b, z) takes the run [z S, (z + 1) S) of
//     row block b's slots in window-major order (slot s = (window
//     s / heads, head s % heads)), and its 8 warps take all the run's
//     tasks at once;
//   * P1 (per head): block (b, z) takes heads [z H, (z + 1) H) of row
//     block b, H = heads / split, its slots head-major, and works them one
//     head after another: the warps take one head's ch n / 16 tasks, then
//     meet at a barrier before the next head.
// A row block is spread over `split` blocks where its blocks alone leave
// SMs idle (the tool's 96 row blocks on 132 SMs take split 2 in both);
// each block stages only its own slots, so x is still read once.
// Shared memory: slots / split x n x 64 bytes (55 KB at the tool's
// defaults, split 2), two blocks per SM; the kernels are instantiated per
// n / 16 so the score registers fit.  ptxas -v (the card's nvcc, sm_90a)
// at n = 144 (the tool's): probe_kernel<9, true> (P1) and <9, false> (P2)
// 128 registers, no spills.  At the tool's defaults (H100 80GB HBM3,
// 700 W, chip_smoke.py, device time) P1 0.025 ms and P2 0.025, ~4x the
// byte bound: the barrier between heads costs P1 ~2 %.
//
// Why the first P1 and P2 lost (0.132 and 0.243 ms against SDPA's ~0.075,
// H100 80GB HBM3 at 700 W): P1 ran one block per (row block, head) that
// read the head's 64-byte column runs by synchronous loads and walked its
// windows through an f32 n x n score tile in shared memory (~115 KB at
// n = 144) on WMMA, three __syncthreads per window; P2 ran one block per
// row block (96 blocks of ~216 KB, 36 SMs idle) through the same tile.

#include <cuda.h>

#include "common.cuh"
#include "gemm_sm90.cuh"

namespace lavt {
namespace probe {

constexpr int kHD = 32;
constexpr int kMaxN = 192;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// the shared-memory address of 16-byte chunk j (8 columns) of row r of a
// slot's tile: rows of 64 bytes in the 64-byte swizzle
__device__ __forceinline__ uint32_t chunk(uint32_t tile, int r, int j) {
  return tile + r * 64 + (((j ^ (r >> 1)) & 3) << 4);
}

// One warp's task: O rows r0 .. r0 + 15 of the slot staged at `tile`
// (n = 16 NT rows), written to `out` (row r0's head columns; rows cq apart).
template <int NT>
__device__ __forceinline__ void slot_rows(uint32_t tile, int r0, bf16* __restrict__ out, int cq) {
  const int lane = threadIdx.x % 32, g = lane / 4, tq = lane % 4;
  // q rows r0..r0 + 15 as A fragments of the two 16-deep steps
  uint32_t qa[2][4];
  const int ar = r0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  ldsm_x4(qa[0], chunk(tile, ar, lane >> 4));
  ldsm_x4(qa[1], chunk(tile, ar, 2 + (lane >> 4)));
  // S = q q^T, 8 keys a tile: k rows kb..kb + 7 as B fragments
  float sc[2 * NT][4];
#pragma unroll
  for (int t = 0; t < 2 * NT; ++t) {
    sc[t][0] = sc[t][1] = sc[t][2] = sc[t][3] = 0.f;
    uint32_t b[4];
    ldsm_x4(b, chunk(tile, 8 * t + (lane & 7), lane >> 3));
    mma16816(sc[t], qa[0], b[0], b[1]);
    mma16816(sc[t], qa[1], b[2], b[3]);
  }
  // P = exp(min(S, 80)) / rowsum, rows r0 + g and r0 + g + 8
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int t = 0; t < 2 * NT; ++t) {
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[t][e] = __expf(fminf(sc[t][e], 80.f));
    sum[0] += sc[t][0] + sc[t][1];
    sum[1] += sc[t][2] + sc[t][3];
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
    sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
  }
  const float inv[2] = {1.f / sum[0], 1.f / sum[1]};
  // O = P v, 16 keys a step; v rows by ldmatrix.trans
  float acc[4][4];
#pragma unroll
  for (int d = 0; d < 4; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < NT; ++ks) {
    const uint32_t pa[4] = {pack_bf2(sc[2 * ks][0] * inv[0], sc[2 * ks][1] * inv[0]),
                            pack_bf2(sc[2 * ks][2] * inv[1], sc[2 * ks][3] * inv[1]),
                            pack_bf2(sc[2 * ks + 1][0] * inv[0], sc[2 * ks + 1][1] * inv[0]),
                            pack_bf2(sc[2 * ks + 1][2] * inv[1], sc[2 * ks + 1][3] * inv[1])};
    const int vr = 16 * ks + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int dp = 0; dp < 2; ++dp) {
      uint32_t vb[4];
      ldsm_x4_trans(vb, chunk(tile, vr, 2 * dp + (lane >> 4)));
      mma16816(acc[2 * dp], pa, vb[0], vb[1]);
      mma16816(acc[2 * dp + 1], pa, vb[2], vb[3]);
    }
  }
  bf16* row = out + static_cast<size_t>(g) * cq + 2 * tq;
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    *reinterpret_cast<uint32_t*>(row + 8 * d) = pack_bf2(acc[d][0], acc[d][1]);
    *reinterpret_cast<uint32_t*>(row + 8 * cq + 8 * d) = pack_bf2(acc[d][2], acc[d][3]);
  }
}

// grid (row blocks, split), `slots` slots a block, n = 16 NT: P2
// (kPerHead false) or P1 (true), as the note at the top sets out
template <int NT, bool kPerHead>
__global__ void __launch_bounds__(kThreads, 2)
    probe_kernel(const __grid_constant__ CUtensorMap xmap, bf16* __restrict__ o, int ch,
                 int heads, int slots) {
  constexpr int n = 16 * NT;
  constexpr int kTileBytes = n * 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + slots * kTileBytes);
  const int cq = heads * kHD, row0 = blockIdx.x * ch * n;
  // slot s of this block: its window within the row block and its head
  auto window_of = [&](int s) { return kPerHead ? s % ch : (blockIdx.y * slots + s) / heads; };
  auto head_of = [&](int s) {
    return kPerHead ? blockIdx.y * (slots / ch) + s / ch : (blockIdx.y * slots + s) % heads;
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < slots; ++s) sm90::mbar_init(&bars[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < slots; ++s) {
      sm90::mbar_expect_tx(&bars[s], kTileBytes);
      sm90::tma_load(&xmap, sm90::smem_u32(smem + s * kTileBytes), &bars[s], head_of(s) * kHD,
                     row0 + window_of(s) * n);
    }
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int group = kPerHead ? ch : slots;  // the slots worked between barriers
  for (int s0 = 0; s0 < slots; s0 += group) {
    if (kPerHead && s0 > 0) __syncthreads();  // every warp is done with the last head
    for (int task = warp; task < group * NT; task += kWarps) {
      const int s = s0 + task / NT, r0 = (task % NT) * 16;
      sm90::mbar_wait(&bars[s], 0);
      slot_rows<NT>(sm90::smem_u32(smem + s * kTileBytes), r0,
                    o + static_cast<size_t>(row0 + window_of(s) * n + r0) * cq + head_of(s) * kHD,
                    cq);
    }
  }
}

inline size_t smem_bytes(int slots, int n) { return 1024 + size_t(slots) * (n * 64 + 8); }

template <int NT, bool kPerHead>
cudaError_t launch(const CUtensorMap& map, bf16* o, int grid, int ch, int heads, int split,
                   cudaStream_t s) {
  const int slots = ch * heads / split;
  const size_t smem = smem_bytes(slots, 16 * NT);
  cudaError_t err = allow_smem(probe_kernel<NT, kPerHead>, smem);
  if (err != cudaSuccess) return err;
  probe_kernel<NT, kPerHead><<<dim3(grid, split), kThreads, smem, s>>>(map, o, ch, heads, slots);
  return cudaGetLastError();
}

}  // namespace probe
}  // namespace lavt

// x, o: (grid ch n, heads 32) bf16; batch 0 launches P1 (`split` divides
// heads), 1 launches P2 (`split` divides ch heads), over `split` blocks per
// row block.  n a multiple of 16 up to 192; a block's staged slots must
// fit its shared memory.
extern "C" int lavt_probe_headbatch(const void* x, void* o, int grid, int ch, int n, int heads,
                                    int batch, int split, void* stream) {
  using namespace lavt;
  using namespace lavt::probe;
  if (n <= 0 || n % 16 || n > kMaxN || ch <= 0 || heads <= 0 || grid <= 0 || split <= 0 ||
      (batch ? (ch * heads) % split : heads % split) ||
      smem_bytes(ch * heads / split, n) > 232448)
    return static_cast<int>(cudaErrorInvalidValue);
  const sm90::EncodeTiledFn fn = sm90::encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  // x as (rows, heads 32) bf16 in boxes of one head's n rows, 64-byte swizzle
  CUtensorMap map;
  const cuuint64_t dims[2] = {cuuint64_t(heads) * kHD, cuuint64_t(grid) * ch * n};
  const cuuint64_t strides[1] = {cuuint64_t(heads) * kHD * 2};
  const cuuint32_t box[2] = {kHD, cuuint32_t(n)};
  const cuuint32_t elem[2] = {1, 1};
  if (fn(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(x), dims, strides, box,
         elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  bf16* ob = static_cast<bf16*>(o);
  cudaError_t err;
  switch (n / 16 * 2 + (batch ? 1 : 0)) {
#define PROBE_CASE(k)                                                         \
  case 2 * k: err = launch<k, true>(map, ob, grid, ch, heads, split, s); break; \
  case 2 * k + 1: err = launch<k, false>(map, ob, grid, ch, heads, split, s); break;
    PROBE_CASE(1) PROBE_CASE(2) PROBE_CASE(3) PROBE_CASE(4) PROBE_CASE(5) PROBE_CASE(6)
    PROBE_CASE(7) PROBE_CASE(8) PROBE_CASE(9) PROBE_CASE(10) PROBE_CASE(11) PROBE_CASE(12)
#undef PROBE_CASE
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
