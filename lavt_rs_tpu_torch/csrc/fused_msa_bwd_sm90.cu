// K5 for Hopper (sm_90a): the fused window-MSA backward from the taped
// forward's residuals (K6 runs the save-mode forward, then these launches).
//
// Replaces lavt_rs_tpu/ops/pallas/fused_msa.py:_fused_bwd_group_resid /
// _bwd_kernel_resid (:323).  Given the output gradient gy (B nW N, C), the
// MSA's input x (post-LN: xn), and the save mode's residuals q (post-scale),
// k, v (B nW N, C; lanes in head order) and P (B nW, heads, N, N), all bf16,
// with N = 144 (window 12) and head dim 32, it computes with the TPU
// kernel's rounding points:
//   dattn = gy Wproj                       (f32 -> bf16, per head: do)
//   o   = P v                              (f32 -> bf16; feeds dWproj)
//   dv  = P^T do,  dP = do v^T,  dS = P (dP - D),  D = rowsum(do o)  (f32)
//   dq  = dS k scale,  dk = dS^T q         (dS rounded to bf16 first)
//   dbias = sum over windows of dS;  dbq/dbk/dbv = column sums of the f32
//   dq/dk/dv
//   dx  = [dq|dk|dv] Wqkv                  ([dq|dk|dv] rounded to bf16)
//   dWqkv = [dq|dk|dv]^T x,  dWproj = gy^T o,  dbproj = column sums of gy
// D is rowsum(dP P) of the TPU kernel written as rowsum(do o) with o the f32
// P v: the same sum in another order (sum_j dP_ij P_ij = sum_d do_id o_id).
//
// Launches (all hand-written; the wrapper allocates every buffer):
//   (a) dattn = gy Wproj on the wgmma + TMA GEMM core (gemm_sm90.cuh), bf16
//       out (`lavt_msa_dgrad`: A K-major, B = Wproj read MN-major);
//   (b) msa_bwd_sm90_kernel: per (window, head) every product above from
//       shared memory on wgmma, dbias and the bias-grad column sums in
//       fixed-order partials per block;
//   (c) dx = dqkv Wqkv on the core (`lavt_msa_dgrad`);
//   (d), (e) dWqkv = dqkv^T x and dWproj = gy^T o on the core, split over
//       the rows into f32 partials (K7's `lavt_wgrad`,
//       csrc/fused_mlp_bwd.cu: both operands MN-major);
//   (f) the column sums of gy (`lavt_colsum_bf16`, csrc/fused_msa_bwd.cu);
//   (g) `lavt_sum_partials` adds every split's partials in a fixed order:
//       the same inputs give the same bits (no float atomics).
//
// Bound on the H100: operations.  Per call 16 rows C^2 (the four GEMMs) +
// 10 N^2 hd per window and head; at Swin-B stage 3 (bs 8: 72 windows, C =
// 512, 16 heads) 43.5 + 7.6 GFLOP = 0.052 ms at 989 TFLOP/s against ~115
// MB (P 48 MB of it) = 0.034 ms at 3.35 TB/s.
//
// Why the first design (csrc/fused_msa_bwd.cu before this file) lost to the
// library chain: its four GEMMs ran on a WMMA GEMM of 64 x 64 tiles with
// synchronous loads (they carry most of the operations at stages 3-4), and
// its attention kernel read P three times from L2 by WMMA loads through
// seven __syncthreads phases per window at one block of 8 warps per SM
// (224 KB of shared memory).
//
// Design of (b).  A block of three warpgroups takes the windows g, g + G,
// ... of one head h (grid (G, heads)).  Per window one thread's TMA loads
// bring q, k, v, do (three 64-row tiles each, 64-byte swizzle, rows past
// 144 zero) and P as 3 x 3 boxes of 64 x 64 (128-byte swizzle, zero past
// 144), 120 KB under one mbarrier.  Warpgroup w owns query tile w and key
// tile w (the third holds 16 of 64 rows):
//   0. o_w = P_w v (P boxes as the K-major A from shared memory) and
//      dv_w = P^T do (the same boxes as the MN-major, transposed A); D of
//      its rows from the f32 o; o, dv stored (bf16).  Block barrier.
//   1. dP_w = do_w v^T (one m64n144 accumulator, do as register A), P_w read
//      in that layout from its boxes, dS = P (dP - D) in registers; dbias
//      of its rows += dS in shared memory (f32, each element one thread's
//      across the block's windows); dS (bf16) over P's boxes; dq_w = dS k
//      (register A).  Block barrier (after a proxy fence).
//   2. dk_w = dS^T q (the dS boxes as transposed A).  Block barrier; the
//      next window's loads.
// The bias-grad column sums stay in registers across windows; at the end
// each block writes its dbias (heads, 144, 144) slice and its 3C column
// sums as partials for (g).
// Shared memory: P/dS 72 KB, q/k/v/do 48 KB, dbias 144 x 152 f32 (85.5 KB;
// rows 152 floats apart: the float2 accesses of a fragment row hit 32
// banks), one barrier: ~206 KB, one block per SM.

#include "attn_sm90.cuh"
#include "common.cuh"
#include "gemm_sm90.cuh"

namespace lavt {
namespace k5 {

using namespace attn;
using sm90::GemmParams;

constexpr int kN = 144;            // window 12 x 12
constexpr int kNT = 3;             // 64-row tiles of a window (the last: 16 rows)
constexpr int kWG = 3;             // warpgroup w: query tile w and key tile w
constexpr int kThreads = 128 * kWG;
constexpr int kBox = 8192;         // a 64 x 64 bf16 box of P or dS
constexpr int kLdD = 152;          // f32 row stride of the dbias tile
constexpr int kBoxesBytes = kNT * kNT * kBox;      // 72 KB
constexpr int kHeadBytes = kNT * kTileBytes;       // one head's 192 rows: 12 KB
constexpr int kDbiasBytes = kN * kLdD * 4;
constexpr size_t kSmem = 1024 + kBoxesBytes + 4 * kHeadBytes + kDbiasBytes + 16;
static_assert(kSmem <= 232448, "one block per SM");

struct Params {
  CUtensorMap q, k, v, dout, p;  // 4-D head maps; P 3-D (144, 144, B nW heads)
  bf16* o;                       // (B nW N, C)
  bf16* dqkv;                    // (B nW N, 3C)
  float* dbias_part;             // (G, heads, N, N)
  float* dbqkv_part;             // (G, 3C)
  int bw, c, heads;
  float scale;
};

// box (i, kc) of P / dS: query rows 64 i.., keys 64 kc..; the bf16 pair at
// (row r of the box, column c < 64) in the 128-byte swizzle
__device__ __forceinline__ unsigned char* box_pair(unsigned char* boxes, int i, int r, int c) {
  return boxes + (i * kNT + (c >> 6)) * kBox + r * 128 + ((((c & 63) >> 3) ^ (r & 7)) << 4) +
         (c & 7) * 2;
}

// Add a warpgroup's 64 x 32 accumulator (rows r0.., row limit 144) to the
// thread's column sums and store it, times s, as bf16 at out (row stride ld).
__device__ __forceinline__ void store_part(const float (&acc)[16], bf16* out, long long ld,
                                           int r0, float s, float (&bsum)[8]) {
  const int t = threadIdx.x % 128, warp = t / 32, g = (t % 32) / 4, tq = t % 4;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r0 + warp * 16 + g + 8 * hh;
    if (r >= kN) continue;
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      const float x = acc[4 * d + 2 * hh] * s, y = acc[4 * d + 2 * hh + 1] * s;
      bsum[2 * d] += x, bsum[2 * d + 1] += y;
      *reinterpret_cast<uint32_t*>(out + r * ld + 8 * d + 2 * tq) = pack_bf2(x, y);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1) msa_bwd_sm90_kernel(const __grid_constant__ Params p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* boxes = smem;                       // P, then dS
  unsigned char* qs = smem + kBoxesBytes;            // q, k, v, do: 192 rows each
  unsigned char* ks = qs + kHeadBytes;
  unsigned char* vs = ks + kHeadBytes;
  unsigned char* dos = vs + kHeadBytes;
  float* dbias = reinterpret_cast<float*>(dos + kHeadBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(reinterpret_cast<unsigned char*>(dbias) +
                                               kDbiasBytes);
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int warp = t / 32, g = (t % 32) / 4, tq = t % 4;
  const int h = blockIdx.y, heads = p.heads, C = p.c, C3 = 3 * C;
  if (threadIdx.x == 0) {
    mbar_init(full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = threadIdx.x; i < kN * kLdD; i += kThreads) dbias[i] = 0.f;
  float bq[8], bk[8], bv[8];  // this thread's column sums: columns 8 d + 2 tq + e
#pragma unroll
  for (int e = 0; e < 8; ++e) bq[e] = bk[e] = bv[e] = 0.f;
  __syncthreads();

  auto issue = [&](int win) {
    mbar_expect_tx(full, kBoxesBytes + 4 * kHeadBytes);
    for (int i = 0; i < kNT; ++i) {
      const int row = i * kT;
      tma4(&p.q, smem_u32(qs) + i * kTileBytes, full, 0, h, row, win);
      tma4(&p.k, smem_u32(ks) + i * kTileBytes, full, 0, h, row, win);
      tma4(&p.v, smem_u32(vs) + i * kTileBytes, full, 0, h, row, win);
      tma4(&p.dout, smem_u32(dos) + i * kTileBytes, full, 0, h, row, win);
      for (int kc = 0; kc < kNT; ++kc)
        tma3(&p.p, smem_u32(boxes) + (i * kNT + kc) * kBox, full, kc * kT, row,
             win * heads + h);
    }
  };
  if (threadIdx.x == 0 && blockIdx.x < p.bw) issue(blockIdx.x);
  const uint32_t vaddr = smem_u32(vs), kaddr = smem_u32(ks), qaddr = smem_u32(qs);
  const uint32_t doaddr = smem_u32(dos), baddr = smem_u32(boxes);
  int phase = 0;
  for (int win = blockIdx.x; win < p.bw; win += gridDim.x, phase ^= 1) {
    const long long row0 = static_cast<long long>(win) * kN;
    mbar_wait(full, phase);
    // 0. o_w = P_w v and dv_w = P^T do: 9 steps of 16 keys / queries each
    float oacc[16], dvacc[16];
#pragma unroll
    for (int d = 0; d < 16; ++d) oacc[d] = dvacc[d] = 0.f;
    pin(oacc);
    pin(dvacc);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 9; ++s) {
      const int kc = s / 4, kk = s % 4;
      wgmma_o_ss<0>(oacc, desc128(baddr + (wg * kNT + kc) * kBox + kk * 32, 16, 1024),
                    mnmajor(vaddr + kc * kTileBytes, kk));
      wgmma_o_ss<1>(dvacc, desc128(baddr + (kc * kNT + wg) * kBox + kk * 2048, 8192, 1024),
                    mnmajor(doaddr + kc * kTileBytes, kk));
    }
    wgmma_commit();
    wgmma_wait<0>();
    pin(oacc);
    pin(dvacc);
    // D of this thread's two rows: do (bf16) times the f32 o over its 8
    // columns, then over the row's four threads
    const unsigned char* dtile = dos + wg * kTileBytes;
    float dsum[2] = {0.f, 0.f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = warp * 16 + g + 8 * hh;
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        const uint32_t pr = q_pair(dtile, r, 8 * d + 2 * tq, 1.f);
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&pr));
        dsum[hh] += f.x * oacc[4 * d + 2 * hh] + f.y * oacc[4 * d + 2 * hh + 1];
      }
      dsum[hh] += __shfl_xor_sync(0xffffffffu, dsum[hh], 1);
      dsum[hh] += __shfl_xor_sync(0xffffffffu, dsum[hh], 2);
    }
    float unused[8] = {};
    store_part(oacc, p.o + row0 * C + h * kHD, C, wg * kT, 1.f, unused);
    store_part(dvacc, p.dqkv + row0 * C3 + 2 * C + h * kHD, C3, wg * kT, 1.f, bv);
    __syncthreads();  // every warpgroup is done reading P for dv

    // 1. dP = do v^T over all 144 keys, dS = P (dP - D), dbias, dq
    float acc[72];
#pragma unroll
    for (int d = 0; d < 72; ++d) acc[d] = 0.f;
    uint32_t da[2][4];
    tile_frags(da, dtile, 1.f);
    pin(acc);
    pin(da[0]);
    pin(da[1]);
    wgmma_fence();
    wgmma_n144(acc, da[0], kmajor(vaddr, 0));
    wgmma_n144(acc, da[1], kmajor(vaddr, 1));
    wgmma_commit();
    wgmma_wait<0>();
    pin(acc);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = warp * 16 + g + 8 * hh, rg = wg * kT + r;
#pragma unroll
      for (int jn = 0; jn < 18; ++jn) {
        const int c = 8 * jn + 2 * tq;
        unsigned char* pp = box_pair(boxes, wg, r, c);
        const float2 pv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(pp));
        float& s0 = acc[4 * jn + 2 * hh];
        float& s1 = acc[4 * jn + 2 * hh + 1];
        s0 = pv.x * (s0 - dsum[hh]);
        s1 = pv.y * (s1 - dsum[hh]);
        if (rg < kN) {
          float2* db = reinterpret_cast<float2*>(dbias + rg * kLdD + c);
          float2 cur = *db;
          cur.x += s0, cur.y += s1;
          *db = cur;
        }
        *reinterpret_cast<uint32_t*>(pp) = pack_bf2(s0, s1);
      }
    }
    // dq = dS k (16 keys a step), times scale
    float dqacc[16];
#pragma unroll
    for (int d = 0; d < 16; ++d) dqacc[d] = 0.f;
    uint32_t sa[9][4];
#pragma unroll
    for (int kk = 0; kk < 9; ++kk) {
      sa[kk][0] = pack_bf2(acc[8 * kk], acc[8 * kk + 1]);
      sa[kk][1] = pack_bf2(acc[8 * kk + 2], acc[8 * kk + 3]);
      sa[kk][2] = pack_bf2(acc[8 * kk + 4], acc[8 * kk + 5]);
      sa[kk][3] = pack_bf2(acc[8 * kk + 6], acc[8 * kk + 7]);
    }
    pin(dqacc);
#pragma unroll
    for (int kk = 0; kk < 9; ++kk) pin(sa[kk]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 9; ++kk)
      wgmma_o(dqacc, sa[kk], mnmajor(kaddr + (kk / 4) * kTileBytes, kk % 4));
    wgmma_commit();
    wgmma_wait<0>();
    pin(dqacc);
    store_part(dqacc, p.dqkv + row0 * C3 + h * kHD, C3, wg * kT, p.scale, bq);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // dS for wgmma
    __syncthreads();

    // 2. dk_w = dS^T q
    float dkacc[16];
#pragma unroll
    for (int d = 0; d < 16; ++d) dkacc[d] = 0.f;
    pin(dkacc);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 9; ++s) {
      const int i = s / 4, kk = s % 4;
      wgmma_o_ss<1>(dkacc, desc128(baddr + (i * kNT + wg) * kBox + kk * 2048, 8192, 1024),
                    mnmajor(qaddr + i * kTileBytes, kk));
    }
    wgmma_commit();
    wgmma_wait<0>();
    pin(dkacc);
    store_part(dkacc, p.dqkv + row0 * C3 + C + h * kHD, C3, wg * kT, 1.f, bk);
    __syncthreads();  // shared memory free for the next window
    if (threadIdx.x == 0 && win + gridDim.x < p.bw) issue(win + gridDim.x);
  }

  // this block's partials: dbias (its head's slice), the 3C column sums
  float* dbp = p.dbias_part + (static_cast<size_t>(blockIdx.x) * heads + h) * kN * kN;
  for (int i = threadIdx.x; i < kN * kN; i += kThreads) dbp[i] = dbias[(i / kN) * kLdD + i % kN];
  // column sums: over the 8 rows of a column within a warp, then the warps
  // in order through shared memory (dbias is free now)
  __syncthreads();
  float* red = dbias;  // [warp (12)][part (3)][32]
#pragma unroll
  for (int e = 0; e < 8; ++e) {
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      bq[e] += __shfl_xor_sync(0xffffffffu, bq[e], o);
      bk[e] += __shfl_xor_sync(0xffffffffu, bk[e], o);
      bv[e] += __shfl_xor_sync(0xffffffffu, bv[e], o);
    }
  }
  if (g == 0) {
    const int w = threadIdx.x / 32;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int col = 8 * (e / 2) + 2 * tq + e % 2;
      red[(w * 3 + 0) * kHD + col] = bq[e];
      red[(w * 3 + 1) * kHD + col] = bk[e];
      red[(w * 3 + 2) * kHD + col] = bv[e];
    }
  }
  __syncthreads();
  if (threadIdx.x < 3 * kHD) {
    const int part = threadIdx.x / kHD, col = threadIdx.x % kHD;
    float s = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) s += red[(w * 3 + part) * kHD + col];
    p.dbqkv_part[static_cast<size_t>(blockIdx.x) * C3 + part * C + h * kHD + col] = s;
  }
}

// -- the GEMMs on the core -------------------------------------------------

// bf16 out, staged and TMA-stored (boxes past N are not stored; TMA clips
// columns past N inside a box)
struct EpiBf16 {
  static constexpr int kStaged = 1, kStagedIn = 0;
  struct Args {};
  static __device__ __forceinline__ void store(const Args&, float (&acc)[64], float (&)[1], int,
                                               int, float*, unsigned char* out) {
#pragma unroll
    for (int j = 0; j < sm90::kBN / 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        sm90::stage_pair(out, sm90::frag_row(0, hh), sm90::frag_col(0, j),
                         __floats2bfloat162_rn(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]));
  }
};

inline cudaError_t map_p(CUtensorMap* map, const void* ptr, int count) {
  const cuuint64_t dims[3] = {kN, kN, cuuint64_t(count)};
  const cuuint64_t strides[2] = {kN * 2, kN * kN * 2};
  const cuuint32_t box[3] = {kT, kT, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, ptr, dims, strides, box,
                CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace k5
}  // namespace lavt

// (b): q, k, v (B nW, 144, C) bf16 (q post-scale) with rows ld elements
// apart (C, or 3C for the column views of the save mode's qkv tensor),
// P (B nW, heads, 144, 144), dattn (B nW 144, C); writes o (B nW 144, C),
// dqkv (B nW 144, 3C), dbias_part (groups, heads, 144, 144) and dbqkv_part
// (groups, 3C) f32.  Grid (groups, heads): block (g, h) takes windows g,
// g + groups, ...
extern "C" int lavt_msa_bwd_attn_sm90(const void* dattn, const void* q, const void* k,
                                      const void* v, const void* p, void* o, void* dqkv,
                                      void* dbias_part, void* dbqkv_part, int Bw, int C,
                                      int ld, int heads, int groups, float scale,
                                      void* stream) {
  using namespace lavt;
  using namespace lavt::k5;
  if (Bw < 1 || heads < 1 || C != heads * kHD || ld < C || ld % 8 || groups < 1 || groups > Bw)
    return static_cast<int>(cudaErrorInvalidValue);
  Params pr;
  const long long sw = static_cast<long long>(kN) * ld, dw = static_cast<long long>(kN) * C;
  cudaError_t err = map_qkv(&pr.q, q, Bw, heads, kN, sw, kHD, ld);
  if (err == cudaSuccess) err = map_qkv(&pr.k, k, Bw, heads, kN, sw, kHD, ld);
  if (err == cudaSuccess) err = map_qkv(&pr.v, v, Bw, heads, kN, sw, kHD, ld);
  if (err == cudaSuccess) err = map_qkv(&pr.dout, dattn, Bw, heads, kN, dw, kHD, C);
  if (err == cudaSuccess) err = map_p(&pr.p, p, Bw * heads);
  if (err != cudaSuccess) return static_cast<int>(err);
  pr.o = static_cast<bf16*>(o);
  pr.dqkv = static_cast<bf16*>(dqkv);
  pr.dbias_part = static_cast<float*>(dbias_part);
  pr.dbqkv_part = static_cast<float*>(dbqkv_part);
  pr.bw = Bw, pr.c = C, pr.heads = heads, pr.scale = scale;
  err = cudaFuncSetAttribute(msa_bwd_sm90_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  msa_bwd_sm90_kernel<<<dim3(groups, heads), kThreads, kSmem,
                        static_cast<cudaStream_t>(stream)>>>(pr);
  return static_cast<int>(cudaGetLastError());
}

// (a), (c): out (M, N) bf16 = A (M, K) B, B stored (K, N) row-major (a torch
// Linear weight read as W, not W^T).  K and N multiples of 8.
extern "C" int lavt_msa_dgrad(const void* a, const void* b, void* out, int M, int N, int K,
                              void* stream) {
  using namespace lavt;
  if (M < 1 || N < 8 || K < 8 || N % 8 || K % 8) return static_cast<int>(cudaErrorInvalidValue);
  sm90::GemmParams<k5::EpiBf16::Args> p;
  cudaError_t err = sm90::map_a<2>(&p.a0, a, K, M, false);
  if (err == cudaSuccess) err = sm90::map_b(&p.b0, b, N, K, true);
  if (err == cudaSuccess) err = sm90::map_out(&p.c0, out, N, M);
  if (err != cudaSuccess) return static_cast<int>(err);
  p.k_tiles = p.k_tiles_per_split = (K + sm90::kBK - 1) / sm90::kBK;
  return static_cast<int>(sm90::launch_gemm<k5::EpiBf16, 2, false, true>(
      p, M, N, 1, static_cast<cudaStream_t>(stream)));
}
