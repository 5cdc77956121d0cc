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
// P1: one slot (window, head) is K1's attention core (WMMA bf16 m16n16k16,
// f32 accumulate; the n x n scores in shared memory, the bf16 probabilities
// written over them).  One block per (row block, head): it reads the head's
// 32 columns of each window (64-byte runs of each row) and writes them
// back, so a row block is read `heads` times in 64-byte pieces.  ~115 KB of
// shared memory at n = 144.
//
// P2 (redesigned for Hopper): a row block is staged once, by TMA: one
// 2-D tensor-map box per (window, head) slot (the slot's n rows x 64 bytes,
// in the 64-byte swizzle, so the ldmatrix reads below are conflict-free),
// each slot on its own mbarrier, all issued at the start, so the first
// slots' math overlaps the later slots' loads.  The block's 8 warps then
// take (slot, 16-row group) tasks in slot order, in parallel: a warp holds
// its 16 rows' S (16 x n f32, n / 8 mma.sync m16n8k16 tiles) in registers,
// with no score tile in shared memory, forms P there, and runs P v from
// registers (A fragments from the S fragments, v by ldmatrix.trans from the
// slot's tile).  O goes from registers straight to its columns in device
// memory: the staged x is never written, so no warp's O can reach columns
// another warp still reads.  A row block may be spread over `split` blocks
// (the slots cut into equal runs, each block staging only its run: the
// row block is still read from device memory once) where its blocks alone
// leave SMs idle: the tool's 96 row blocks on 132 SMs take split 2.
// Shared memory: slots / split x n x 64 bytes (55 KB at the tool's defaults,
// split 2), two blocks per SM; the kernel is instantiated per n / 16 so
// the score registers fit.  ptxas -v (the card's nvcc, sm_90a):
// probe_batch_kernel<9> (n = 144, the tool's) 128 registers, 60 bytes of
// spill stores/loads; <10> 68 bytes, <11> 8, <12> 4; <8> and below no
// spills (128 registers down to 40 at <1>).
//
// Why the first P2 lost (0.243 ms against SDPA's 0.073): one block per row
// block (96 blocks of ~216 KB, one per SM, 36 SMs idle) walked its 12 slots
// one after another, each through an f32 n x n score tile in shared memory,
// three __syncthreads and WMMA loads from shared memory.

#include <cuda.h>

#include "common.cuh"
#include "gemm_sm90.cuh"

namespace lavt {

constexpr int pHD = 32;
constexpr int pThreads = 256;
constexpr int pWarps = pThreads / 32;
constexpr int pMaxN = 192;     // n x n f32 scores in shared memory
constexpr int pLDQ = pHD + 8;  // bf16 q of P1
constexpr int pLDO = pHD + 4;  // f32 output staging

__host__ __device__ constexpr size_t probe_s_bytes(int n) { return align128(size_t(n) * n * 4); }
__host__ __device__ constexpr size_t probe_o_bytes(int n) { return align128(size_t(n) * pLDO * 4); }

// One (window, head) slot: q = k = v = the n x 32 bf16 tile at qs (row
// stride ldq).  S = q q^T in f32 at ss (ld n); P = exp(min(S, 80)) / rowsum
// rounded to bf16 over the first half of each f32 row (each warp owns
// whole rows and reads a row fully before it writes); O = P q in f32 at os
// (ld pLDO).  Ends on a barrier.
__device__ void probe_slot(const bf16* qs, int ldq, float* ss, float* os, int n) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nt = n / 16;
  for (int t = warp; t < nt * nt; t += pWarps) {
    const int r = t / nt, c = t % nt;
    FragC s;
    wmma::fill_fragment(s, 0.f);
#pragma unroll
    for (int kk = 0; kk < pHD; kk += 16) {
      FragA a;
      FragBCol b;
      wmma::load_matrix_sync(a, qs + r * 16 * ldq + kk, ldq);
      wmma::load_matrix_sync(b, qs + c * 16 * ldq + kk, ldq);
      wmma::mma_sync(s, a, b, s);
    }
    wmma::store_matrix_sync(ss + r * 16 * n + c * 16, s, n, wmma::mem_row_major);
  }
  __syncthreads();
  bf16* ps = reinterpret_cast<bf16*>(ss);
  const int ldp = 2 * n;
  for (int r = warp; r < n; r += pWarps) {
    float v[pMaxN / 32];
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < pMaxN / 32; ++t) {
      const int j = lane + 32 * t;
      v[t] = j < n ? expf(fminf(ss[r * n + j], 80.f)) : 0.f;
      sum += v[t];
    }
    sum = warp_sum(sum);
    __syncwarp();
#pragma unroll
    for (int t = 0; t < pMaxN / 32; ++t) {
      const int j = lane + 32 * t;
      if (j < n) ps[r * ldp + j] = to_bf(v[t] / sum);
    }
  }
  __syncthreads();
  for (int t = warp; t < nt * 2; t += pWarps) {
    const int r = t / 2, c = t % 2;
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
    for (int kk = 0; kk < n; kk += 16) {
      FragA a;
      FragBRow b;
      wmma::load_matrix_sync(a, ps + r * 16 * ldp + kk, ldp);
      wmma::load_matrix_sync(b, qs + kk * ldq + c * 16, ldq);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(os + r * 16 * pLDO + c * 16, acc, pLDO, wmma::mem_row_major);
  }
  __syncthreads();
}

// P1: grid (row blocks, heads).
__global__ void __launch_bounds__(pThreads)
probe_loop_kernel(const bf16* __restrict__ x, bf16* __restrict__ o, int ch, int n, int heads) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* ss = reinterpret_cast<float*>(smem);
  bf16* qs = reinterpret_cast<bf16*>(smem + probe_s_bytes(n));
  float* os = reinterpret_cast<float*>(smem + probe_s_bytes(n) + align128(size_t(n) * pLDQ * 2));
  const int h = blockIdx.y, cq = heads * pHD;
  for (int w = 0; w < ch; ++w) {
    const size_t r0 = (static_cast<size_t>(blockIdx.x) * ch + w) * n;
    for (int i = threadIdx.x; i < n * (pHD / 8); i += pThreads) {
      const int r = i / (pHD / 8), d = (i % (pHD / 8)) * 8;
      *reinterpret_cast<uint4*>(qs + r * pLDQ + d) =
          *reinterpret_cast<const uint4*>(x + (r0 + r) * cq + h * pHD + d);
    }
    __syncthreads();
    probe_slot(qs, pLDQ, ss, os, n);
    for (int i = threadIdx.x; i < n * (pHD / 8); i += pThreads) {
      const int r = i / (pHD / 8), d = (i % (pHD / 8)) * 8;
      *reinterpret_cast<uint4*>(o + (r0 + r) * cq + h * pHD + d) = pack8(os + r * pLDO + d);
    }
    __syncthreads();
  }
}

// -- P2 ----------------------------------------------------------------------

namespace p2 {

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

// grid (row blocks, split); block (b, z) takes slots [z S, (z + 1) S) of row
// block b, S = slots, slot s = (window s / heads, head s % heads); n = 16 NT
template <int NT>
__global__ void __launch_bounds__(kThreads, 2)
    probe_batch_kernel(const __grid_constant__ CUtensorMap xmap, bf16* __restrict__ o, int ch,
                       int heads, int slots) {
  constexpr int n = 16 * NT;
  constexpr int kTileBytes = n * 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + slots * kTileBytes);
  const int s0 = blockIdx.y * slots, cq = heads * pHD;
  const int row0 = blockIdx.x * ch * n;
  if (threadIdx.x == 0) {
    for (int s = 0; s < slots; ++s) sm90::mbar_init(&bars[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < slots; ++s) {
      const int w = (s0 + s) / heads, h = (s0 + s) % heads;
      sm90::mbar_expect_tx(&bars[s], kTileBytes);
      sm90::tma_load(&xmap, sm90::smem_u32(smem + s * kTileBytes), &bars[s], h * pHD,
                     row0 + w * n);
    }
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, tq = lane % 4;
  for (int task = warp; task < slots * NT; task += kWarps) {
    const int s = task / NT, r0 = (task % NT) * 16;
    const int w = (s0 + s) / heads, h = (s0 + s) % heads;
    const uint32_t tile = sm90::smem_u32(smem + s * kTileBytes);
    sm90::mbar_wait(&bars[s], 0);
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
    bf16* out = o + static_cast<size_t>(row0 + w * n + r0 + g) * cq + h * pHD + 2 * tq;
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      *reinterpret_cast<uint32_t*>(out + 8 * d) = pack_bf2(acc[d][0], acc[d][1]);
      *reinterpret_cast<uint32_t*>(out + 8 * cq + 8 * d) = pack_bf2(acc[d][2], acc[d][3]);
    }
  }
}

template <int NT>
cudaError_t launch_batch(const CUtensorMap& map, bf16* o, int grid, int ch, int heads,
                         int split, cudaStream_t s) {
  const int slots = ch * heads / split;
  const size_t smem = 1024 + size_t(slots) * 16 * NT * 64 + slots * 8;
  cudaError_t err = allow_smem(probe_batch_kernel<NT>, smem);
  if (err != cudaSuccess) return err;
  probe_batch_kernel<NT><<<dim3(grid, split), kThreads, smem, s>>>(map, o, ch, heads, slots);
  return cudaGetLastError();
}

}  // namespace p2
}  // namespace lavt

// x, o: (grid ch n, heads 32) bf16; batch 0 launches P1, 1 launches P2 over
// `split` blocks per row block (split divides ch heads).  n a multiple of
// 16 up to 192; P2 also needs its staged slots to fit.
extern "C" int lavt_probe_headbatch(const void* x, void* o, int grid, int ch, int n, int heads,
                                    int batch, int split, void* stream) {
  using namespace lavt;
  if (n <= 0 || n % 16 || n > pMaxN || ch <= 0 || heads <= 0 || grid <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* ob = static_cast<bf16*>(o);
  if (batch) {
    if (split <= 0 || (ch * heads) % split ||
        1024 + size_t(ch * heads / split) * (n * 64 + 8) > 232448)
      return static_cast<int>(cudaErrorInvalidValue);
    const sm90::EncodeTiledFn fn = sm90::encode_tiled();
    if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
    // x as (rows, heads 32) bf16 in boxes of one head's n rows, 64-byte swizzle
    CUtensorMap map;
    const cuuint64_t dims[2] = {cuuint64_t(heads) * pHD, cuuint64_t(grid) * ch * n};
    const cuuint64_t strides[1] = {cuuint64_t(heads) * pHD * 2};
    const cuuint32_t box[2] = {pHD, cuuint32_t(n)};
    const cuuint32_t elem[2] = {1, 1};
    if (fn(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(x), dims, strides, box,
           elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
           CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err;
    switch (n / 16) {
#define P2_CASE(k) \
  case k: err = p2::launch_batch<k>(map, ob, grid, ch, heads, split, s); break;
      P2_CASE(1) P2_CASE(2) P2_CASE(3) P2_CASE(4) P2_CASE(5) P2_CASE(6)
      P2_CASE(7) P2_CASE(8) P2_CASE(9) P2_CASE(10) P2_CASE(11) P2_CASE(12)
#undef P2_CASE
      default: err = cudaErrorInvalidValue;
    }
    return static_cast<int>(err);
  }
  const size_t smem = probe_s_bytes(n) + align128(size_t(n) * pLDQ * 2) + probe_o_bytes(n);
  cudaError_t err = allow_smem(probe_loop_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  probe_loop_kernel<<<dim3(grid, heads), pThreads, smem, s>>>(xb, ob, ch, n, heads);
  return static_cast<int>(cudaGetLastError());
}
