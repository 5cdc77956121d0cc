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
// read and a write of x (21 MB, 6 us).  Design: one (window, head) slot is
// K1's attention core (WMMA bf16 m16n16k16, f32 accumulate; the n x n scores
// in shared memory, the bf16 probabilities written over them).  P1 has one
// block per (row block, head): it reads the head's 32 columns of each
// window (64-byte runs of each row) and writes them back, so a row block is
// read `heads` times in 64-byte pieces.  P2 has one block per row block: it
// stages the whole block once in shared memory with 16-byte loads of whole
// rows (the counterpart of the VMEM scratch), runs the heads x ch slots on
// it, writes each slot's O over its own columns, and stores the block back
// once.  Shared memory: P1 ~115 KB, P2 ~216 KB at n = 144, ch 3, 4 heads
// (one block per SM).  No TMA or wgmma.

#include "common.cuh"

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

// P2: grid (row blocks); the block is staged whole in shared memory.
__global__ void __launch_bounds__(pThreads)
probe_batch_kernel(const bf16* __restrict__ x, bf16* __restrict__ o, int ch, int n, int heads) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int cq = heads * pHD, ldx = cq + 8, rows = ch * n;
  const size_t xs_bytes = align128(size_t(rows) * ldx * 2);
  bf16* xs = reinterpret_cast<bf16*>(smem);
  float* ss = reinterpret_cast<float*>(smem + xs_bytes);
  float* os = reinterpret_cast<float*>(smem + xs_bytes + probe_s_bytes(n));
  const size_t row0 = static_cast<size_t>(blockIdx.x) * rows;
  for (int i = threadIdx.x; i < rows * (cq / 8); i += pThreads) {
    const int r = i / (cq / 8), c = (i % (cq / 8)) * 8;
    *reinterpret_cast<uint4*>(xs + r * ldx + c) =
        *reinterpret_cast<const uint4*>(x + (row0 + r) * cq + c);
  }
  __syncthreads();
  for (int h = 0; h < heads; ++h) {
    for (int w = 0; w < ch; ++w) {
      bf16* q = xs + static_cast<size_t>(w) * n * ldx + h * pHD;
      probe_slot(q, ldx, ss, os, n);
      // the slot's output over its own columns: no later slot reads them
      for (int i = threadIdx.x; i < n * (pHD / 8); i += pThreads) {
        const int r = i / (pHD / 8), d = (i % (pHD / 8)) * 8;
        *reinterpret_cast<uint4*>(q + r * ldx + d) = pack8(os + r * pLDO + d);
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < rows * (cq / 8); i += pThreads) {
    const int r = i / (cq / 8), c = (i % (cq / 8)) * 8;
    *reinterpret_cast<uint4*>(o + (row0 + r) * cq + c) =
        *reinterpret_cast<const uint4*>(xs + r * ldx + c);
  }
}

}  // namespace lavt

// x, o: (grid ch n, heads 32) bf16; batch 0 launches P1, 1 launches P2.
// n a multiple of 16 up to 192; P2 also needs its staged block to fit.
extern "C" int lavt_probe_headbatch(const void* x, void* o, int grid, int ch, int n, int heads,
                                    int batch, void* stream) {
  using namespace lavt;
  if (n <= 0 || n % 16 || n > pMaxN || ch <= 0 || heads <= 0 || grid <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* ob = static_cast<bf16*>(o);
  if (batch) {
    const size_t smem = align128(size_t(ch) * n * (heads * pHD + 8) * 2) + probe_s_bytes(n) +
                        probe_o_bytes(n);
    if (smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = allow_smem(probe_batch_kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    probe_batch_kernel<<<grid, pThreads, smem, s>>>(xb, ob, ch, n, heads);
  } else {
    const size_t smem = probe_s_bytes(n) + align128(size_t(n) * pLDQ * 2) + probe_o_bytes(n);
    cudaError_t err = allow_smem(probe_loop_kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    probe_loop_kernel<<<dim3(grid, heads), pThreads, smem, s>>>(xb, ob, ch, n, heads);
  }
  return static_cast<int>(cudaGetLastError());
}
