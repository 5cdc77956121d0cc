// K10 for Hopper (sm_90a): attention-only window attention on pre-projected
// heads, with its save mode.
//
// Replaces lavt_rs_tpu/ops/pallas/window_attn.py:_fwd/_fwd_kernel (reached
// from window_attention_pallas) and, in save mode, _vjp_fwd.  Per window and
// head, with hd = 32 and any N <= 400:
//   O = softmax(bf16(q scale) k^T + bias[h] + mask[w mod nW]) v
// the scores, bias, mask and softmax in f32 with max subtraction, P rounded
// to bf16 before P v, O divided by the row sum and rounded to bf16.  The save
// mode also writes lse = m + log(l) in f32, (B nW, heads, N), for K9.
// Masks: window wi = win mod nW takes no mask when wi < nu, else
// mask[wi - nu] (nu = 0 with a full mask, nW without one).
//
// Bound on the H100, per call: 4 N^2 hd flops per window and head against
// q, k, v, O in bf16, the f32 bias and the masked windows' f32 mask.  Bytes
// bind at every path shape (989 TFLOP/s bf16 against 3.35 TB/s): video
// stage 2 (81 windows x 6 heads, N = 392) 9.6 GFLOP (0.010 ms) against
// 48.8 MB of q/k/v/O + 3.7 MB of bias (+ 10.4 MB of mask for the 17 masked
// windows of a shifted block): 0.016-0.019 ms; window-7 stage 1 (2592
// windows x 4 heads, N = 49) 3.2 GFLOP against 130 MB: 0.039 ms.
//
// Why the first design (csrc/window_attn.cu before this file) lost: one
// block per (head, window, query split) at 8 warps of 16 rows, so at N = 49
// half the warps had no rows and at N = 392 the last of four rounds ran one
// warp; k and v copied with plain loads behind a __syncthreads, nothing in
// flight across (window, head)s; the bias and mask read by per-thread 8-byte
// __ldg inside the key loop, their L2 latency on the critical path of the
// mma.sync chain.
//
// Design.  The work unit is one warpgroup's 64 query rows of one (window,
// head), walked key tile by key tile (64 keys an item).  Each warpgroup
// takes its items through a private ring of kR stages in shared memory,
// filled by TMA (cp.async.bulk.tensor, one mbarrier per stage with the
// bytes it expects): thread 0 of the warpgroup issues item i + kR as soon
// as all its threads are done with item i, so the next tiles' loads overlap
// this tile's math.  A stage holds q (at a unit's first key tile), k and v,
// 64 rows x 64 bytes each, from 4-D tensor maps (hd, heads | N, N | heads,
// windows) in the 64-byte swizzle (a head's row is 64 bytes; rows >= N load
// as zeros).  The maps take the tensors' strides, so q, k, v may be views
// of the qkv Linear's output, and O is written at any (window, head, row)
// strides: at inference the Swin blocks make no layout copy around K10.
//   * N <= 64 (window 7): `blocks` persistent blocks of two warpgroups, two
//     blocks per SM; warpgroup c of T takes units c, c + T, ... (u = window
//     heads + head), T a multiple of the heads, so its units share a head:
//     its bias is copied once and held in 32 registers in the score
//     fragments' layout (-inf past N).  A stage also holds the window's
//     whole N x N f32 mask, flat, by one bulk copy (cp.async.bulk, no
//     tensor map) of its 16-byte-aligned span (N^2 floats need not start on
//     16 bytes; 1-D tensor maps, tried first, raised an illegal
//     instruction).
//   * N > 64 (video): one block of two warpgroups per SM; units ordered
//     (q tile, head) outermost, block b takes the run [b P, (b + 1) P) and
//     its warpgroups every other unit, so the block loads the 64 bias rows
//     of each (q tile, head) once (two 3-D-map boxes of 200 keys, rows 800
//     bytes apart: conflict-free 8-byte reads of the score fragments) and
//     a stage holds the 64 x 64 mask tile (a 3-D-map box 72 keys wide,
//     rows 288 bytes apart).  Rows whose floats are not 16-byte aligned
//     (N % 4 != 0) are padded by the wrapper (no path's shape).
// No partial last wave in either: the grid is at most one wave, each
// warpgroup walking its units.
// Tensor cores: S = q k^T is wgmma m64n64k16 (two k steps), q from
// registers (bf16(q scale), read from the staged tile through the swizzle),
// k the K-major B operand in shared memory; O += P v is wgmma m64n32k16 in
// the RS form, P converted from the S accumulator fragments to bf16 A
// fragments in registers, v the MN-major B operand.  The online softmax
// (row max over the four threads of a row, rescale of l and of the O
// fragments, exp as ex2 of one FMA) runs on the accumulator fragments.
// Keys >= N are -inf before the row max; rows >= N are computed from zero
// rows and never written.  The walk over key tiles advances by counters,
// without divisions; a change of unit costs one modulo (the window within
// its image) and, above N = 64, a division at a change of (q tile, head).
//
// Tiles, ring, warpgroups, registers, shared memory: 64 query rows x 64 keys
// an item; kR = 2 stages per warpgroup; two warpgroups (256 threads) per
// block.  N <= 64: a stage of 12 KB q/k/v + the flat mask (10 KB at N = 49)
// and the flat bias per warpgroup, 111,672 bytes a block, two blocks per
// SM; N > 64: 30 KB stages and the block's 100 KB of bias rows, 226,360
// bytes, one block per SM.  ptxas -v (the card's nvcc, sm_90a):
//   window_attn_sm90_kernel<false, false>: 166 registers, 0 spill stores/loads
//   window_attn_sm90_kernel<false, true>:  168 registers, 0 spill stores/loads
//   window_attn_sm90_kernel<true, false>:  128 registers, 0 spill stores/loads
//   window_attn_sm90_kernel<true, true>:   128 registers, 0 spill stores/loads

#include <cuda.h>

#include <atomic>
#include <cstdint>
#include <type_traits>

#include "attn_sm90.cuh"
#include "common.cuh"

namespace lavt {
namespace k10 {

using namespace attn;  // kHD, kT (query rows of a unit, keys of a tile), the helpers

constexpr int kNMax = 400;
constexpr int kWG = 2;                       // warpgroups per block
constexpr int kThreads = 128 * kWG;
constexpr int kR = 2;                        // ring stages per warpgroup
constexpr int kLdT = 72;                     // f32 row stride of a staged mask tile
constexpr int kMaskBytes = kT * kLdT * 4;    // 18 KB
constexpr int kLdB = 200;                    // f32 row stride of a half of the bias rows
constexpr int kBiasBytes = 2 * kT * kLdB * 4;  // a q tile's bias rows, 400 keys: 100 KB

// a flat N x N f32 array copied as its 16-byte-aligned span (up to 3 floats
// before it and after it), in whole KB
__host__ __device__ inline int flat_bytes(int n) { return (n * n * 4 + 32 + 1023) / 1024 * 1024; }
__host__ __device__ inline int stage_bytes(int n) {
  return 3 * kTileBytes + (n <= kT ? flat_bytes(n) : kMaskBytes);
}
__host__ __device__ inline int wg_bytes(int n) {
  return (n <= kT ? flat_bytes(n) : 0) + kR * stage_bytes(n);
}
__host__ __device__ inline size_t smem_bytes(int n) {
  return 1024 + (n <= kT ? 0 : kBiasBytes) + size_t(kWG) * wg_bytes(n) + (kWG * kR + kWG + 1) * 8;
}

struct Params {
  CUtensorMap q, k, v, bias, mask;  // bias, mask: 3-D maps (N > 64)
  const float* bias_p;              // the flat bias and mask (N <= 64)
  const float* mask_p;
  bf16* o;
  float* lse;
  long long o_sw, o_sh, o_sn;  // O's strides (elements) of window, head, row
  int units, bw, heads, n, nqt, nw, nu, has_mask, hfirst, per_block;
  float scale;
};

// -- device helpers -------------------------------------------------------

// A warpgroup's walk over its items (unit k, key tile kt): a counter from
// one key tile to the next; a new unit takes one modulo (win mod nW) and,
// above N = 64, a new (q tile, head) a division.  N <= 64: unit u = win
// heads + h, the warpgroup's units u = cg + k T share the head cg % heads
// (T is a multiple of heads, or there is one unit) and step the window by
// T / heads; above: u = (qt heads + h) Bw + win, the (q tile, head) pairs
// outermost, the warpgroup's units every kWG-th of the block's run.
struct Cursor {
  int kt, pair, h, qt, win, wi;  // wi: the window within its image (win mod nW)
  bool masked;                   // the window takes a mask
  long long wm;                  // its mask's index
};

template <bool kFlat>
__device__ __forceinline__ void set_window(const Params& p, Cursor& c) {
  c.wi = c.win % p.nw;
  c.masked = p.has_mask && c.wi >= p.nu;
  c.wm = c.wi - p.nu;
}

template <bool kFlat>
__device__ __forceinline__ Cursor first_item(const Params& p, int u) {
  Cursor c;
  c.kt = 0;
  if (kFlat) {
    c.pair = 0, c.h = u % p.heads, c.qt = 0, c.win = u / p.heads;
  } else {
    c.pair = u / p.bw, c.win = u % p.bw;
    c.h = c.pair % p.heads, c.qt = c.pair / p.heads;
  }
  set_window<kFlat>(p, c);
  return c;
}

// `wstep`: N <= 64, the window step T / heads
template <bool kFlat>
__device__ __forceinline__ void next_item(const Params& p, Cursor& c, int wstep) {
  if (++c.kt < p.nqt) return;
  c.kt = 0;
  if (kFlat) {
    c.win += wstep;
  } else {
    c.win += kWG;
    if (c.win >= p.bw) {
      while (c.win >= p.bw) c.win -= p.bw, ++c.pair;
      c.h = c.pair % p.heads, c.qt = c.pair / p.heads;
    }
  }
  set_window<kFlat>(p, c);
}

// thread 0 of a warpgroup: the loads of item i (at cursor c) into stage
// i % kR
template <bool kFlat>
__device__ __forceinline__ void issue(const Params& p, unsigned char* stages, uint64_t* full,
                                      int i, const Cursor& c) {
  const int n = p.n, kt = c.kt;
  const int s = i % kR;
  uint64_t* bar = &full[s];
  int bytes = (kt == 0 ? kTileBytes : 0) + 2 * kTileBytes;
  if (c.masked) bytes += kFlat ? span_bytes(c.wm * n * n, n * n) : kMaskBytes;
  mbar_expect_tx(bar, bytes);
  const uint32_t base = smem_u32(stages + s * stage_bytes(n));
  auto qkv = [&](const CUtensorMap* m, uint32_t dst, int row) {
    if (p.hfirst) tma4(m, dst, bar, 0, c.h, row, c.win);
    else tma4(m, dst, bar, 0, row, c.h, c.win);
  };
  if (kt == 0) qkv(&p.q, base, c.qt * kT);
  qkv(&p.k, base + kTileBytes, kt * kT);
  qkv(&p.v, base + 2 * kTileBytes, kt * kT);
  if (!c.masked) return;
  if (kFlat) bulk(base + 3 * kTileBytes, p.mask_p, c.wm * n * n, n * n, bar);
  else tma3(&p.mask, base + 3 * kTileBytes, bar, kt * kT, c.qt * kT, static_cast<int>(c.wm));
}


// kFlat: N <= 64 (one query and one key tile, the bias in registers)
template <bool kFlat, bool kSave>
__global__ void __launch_bounds__(kThreads, kFlat ? 2 : 1)
    window_attn_sm90_kernel(const __grid_constant__ Params p) {
  extern __shared__ unsigned char smem_raw[];
  // aligned to 1024 by an offset, so the pointers stay in shared memory
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int n = p.n, nkt = p.nqt;
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32, g = lane / 4, tq = lane % 4;
  // [N > 64: the block's bias rows] [per warpgroup: N <= 64 its flat bias;
  // its ring] [barriers: the rings', then N <= 64 one per warpgroup, else
  // the block's]
  const float* bias_rows = reinterpret_cast<const float*>(smem);
  unsigned char* region = smem + (kFlat ? 0 : kBiasBytes) + wg * wg_bytes(n);
  const float* bias_flat = reinterpret_cast<const float*>(region);
  unsigned char* stages = region + (kFlat ? flat_bytes(n) : 0);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + (kFlat ? 0 : kBiasBytes) + kWG * wg_bytes(n));
  uint64_t* full = bars + wg * kR;
  uint64_t* bbar = bars + kWG * kR + (kFlat ? wg : kWG);
  if (threadIdx.x == 0) {
    for (int b = 0; b < kWG * kR + kWG + 1; ++b) mbar_init(&bars[b], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // this warpgroup's units: N <= 64, u = cg + k T (T warpgroups in all);
  // above, positions wg, wg + kWG, ... of the block's run [u0, u1)
  const int T = gridDim.x * kWG, cg = blockIdx.x * kWG + wg;
  const int u0 = blockIdx.x * p.per_block, u1 = min(p.units, u0 + p.per_block);
  const int mine = kFlat ? (cg < p.units ? (p.units - 1 - cg) / T + 1 : 0)
                         : (u1 - u0 > wg ? (u1 - u0 - 1 - wg) / kWG + 1 : 0);
  const int items = mine * nkt, wstep = T / p.heads;
  if (kFlat && items == 0) return;  // N > 64: every thread joins the bias barriers
  if (t == 0) {
    if (kFlat) {  // every unit of this warpgroup has head cg % heads
      const long long f = static_cast<long long>(cg % p.heads) * n * n;
      mbar_expect_tx(bbar, span_bytes(f, n * n));
      bulk(smem_u32(bias_flat), p.bias_p, f, n * n, bbar);
    }
  }
  Cursor ahead = first_item<kFlat>(p, kFlat ? cg : u0 + wg);  // thread 0's next load
  if (t == 0)
    for (int i = 0; i < kR && i < items; ++i, next_item<kFlat>(p, ahead, wstep))
      issue<kFlat>(p, stages, full, i, ahead);
  // score fragment (j, hh, e): row warp 16 + g + 8 hh, column 8 j + 2 tq + e
  // of the tile, register 4 j + 2 hh + e
  float breg[kFlat ? 32 : 1];
  if constexpr (kFlat) {
    mbar_wait(bbar, 0);
    const float* bf = bias_flat + (cg % p.heads) * n * n % 4;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = min(warp * 16 + g + 8 * hh, n - 1);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + 2 * tq + e;
          breg[4 * j + 2 * hh + e] = c < n ? bf[r * n + c] : neg_inf();  // keys past N
        }
    }
  }

  uint32_t qa[2][4];
  float o[16], m[2], l[2];
  Cursor cur = first_item<kFlat>(p, kFlat ? cg : u0 + wg);
  auto item = [&](int i) {
    const int kt = cur.kt;
    const Cursor& un = cur;
    const int s = i % kR;
    const unsigned char* st = stages + s * stage_bytes(n);
    mbar_wait(&full[s], (i / kR) & 1);
    if (kt == 0) {  // bf16(q scale) as A fragments of the two k steps
      const int ra = warp * 16 + g, rb = ra + 8;
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        const int c = 16 * ks + 2 * tq;
        qa[ks][0] = q_pair(st, ra, c, p.scale);
        qa[ks][1] = q_pair(st, rb, c, p.scale);
        qa[ks][2] = q_pair(st, ra, c + 8, p.scale);
        qa[ks][3] = q_pair(st, rb, c + 8, p.scale);
      }
#pragma unroll
      for (int d = 0; d < 16; ++d) o[d] = 0.f;
      m[0] = m[1] = neg_inf();
      l[0] = l[1] = 0.f;
    }
    // S = q k^T
    float sacc[32];
#pragma unroll
    for (int d = 0; d < 32; ++d) sacc[d] = 0.f;
    const uint32_t kaddr = smem_u32(st + kTileBytes);
    pin(sacc);
    pin(qa[0]);
    pin(qa[1]);
    wgmma_fence();
    wgmma_s(sacc, qa[0], desc64(kaddr, 16, 512));
    wgmma_s(sacc, qa[1], desc64(kaddr + 32, 16, 512));
    wgmma_commit();
    wgmma_wait<0>();
    pin(sacc);

    // + bias + mask (f32); keys past N drop out (N <= 64: -inf in the bias
    // registers; above, only the last key tile can hold such keys)
    const int k0 = kt * kT;
    const bool masked = un.masked;
    const float* mt = reinterpret_cast<const float*>(st + 3 * kTileBytes);
    auto add_bias = [&](auto full_tile) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = warp * 16 + g + 8 * hh;
        const float* mr = kFlat ? mt + un.wm * n * n % 4 + min(r, n - 1) * n : mt + r * kLdT;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = 8 * j + 2 * tq;
          float& s0 = sacc[4 * j + 2 * hh];
          float& s1 = sacc[4 * j + 2 * hh + 1];
          if constexpr (kFlat) {  // the window's mask starts at float (wm N^2) % 4 of its span
            float2 add = make_float2(breg[4 * j + 2 * hh], breg[4 * j + 2 * hh + 1]);
            if (masked) add.x += mr[min(c, n - 1)], add.y += mr[min(c + 1, n - 1)];
            s0 += add.x, s1 += add.y;
          } else {  // bias rows in two halves of kLdB keys; the mask tile kLdT wide
            const int kc = k0 + c, half = kc >= kLdB;
            float2 add = *reinterpret_cast<const float2*>(bias_rows + half * kT * kLdB +
                                                          r * kLdB + kc - half * kLdB);
            if (masked) {
              const float2 mv = *reinterpret_cast<const float2*>(mr + c);
              add.x += mv.x, add.y += mv.y;
            }
            if (decltype(full_tile)::value) {
              s0 += add.x, s1 += add.y;
            } else {
              s0 = kc < n ? s0 + add.x : neg_inf();
              s1 = kc + 1 < n ? s1 + add.y : neg_inf();
            }
          }
        }
      }
    };
    if (kFlat || k0 + kT <= n) add_bias(std::true_type{});
    else add_bias(std::false_type{});
    // online softmax: the rows' maxima over the four threads of a row
    float alpha[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = neg_inf();
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mx = fmaxf(mx, fmaxf(sacc[4 * j + 2 * hh], sacc[4 * j + 2 * hh + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mn = fmaxf(m[hh], mx);  // finite: key k0 < N is real
      alpha[hh] = ex2((m[hh] - mn) * kLog2e);
      m[hh] = mn;
      l[hh] *= alpha[hh];
    }
    const float ml[2] = {m[0] * kLog2e, m[1] * kLog2e};
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      o[4 * d] *= alpha[0], o[4 * d + 1] *= alpha[0];
      o[4 * d + 2] *= alpha[1], o[4 * d + 3] *= alpha[1];
    }
    // P = exp(S - m) as bf16 A fragments, 16 keys a step
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float pv[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) pv[e] = ex2(fmaf(sacc[8 * kk + e], kLog2e, -ml[(e >> 1) & 1]));
      l[0] += pv[0] + pv[1] + pv[4] + pv[5];
      l[1] += pv[2] + pv[3] + pv[6] + pv[7];
      pa[kk][0] = pack_bf2(pv[0], pv[1]);
      pa[kk][1] = pack_bf2(pv[2], pv[3]);
      pa[kk][2] = pack_bf2(pv[4], pv[5]);
      pa[kk][3] = pack_bf2(pv[6], pv[7]);
    }
    // O += P v (steps wholly past N are zeros of P and of v: skipped)
    const int steps = min(4, (n - k0 + 15) / 16);
    const uint32_t vaddr = smem_u32(st + 2 * kTileBytes);
    pin(o);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) pin(pa[kk]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      if (kk < steps) wgmma_o(o, pa[kk], desc64(vaddr + kk * 1024, 4096, 512));
    wgmma_commit();
    wgmma_wait<0>();
    pin(o);
    named_sync(1 + wg);  // every thread of the warpgroup is done with stage s
    if (t == 0 && i + kR < items) {
      issue<kFlat>(p, stages, full, i + kR, ahead);
      next_item<kFlat>(p, ahead, wstep);
    }
    __syncwarp();

    if (kt == nkt - 1) {  // O / row sum, bf16; lse
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float lt = l[hh];
        lt += __shfl_xor_sync(0xffffffffu, lt, 1);
        lt += __shfl_xor_sync(0xffffffffu, lt, 2);
        const int r = un.qt * kT + warp * 16 + g + 8 * hh;
        if (r < n) {
          if (kSave && tq == 0)
            p.lse[(static_cast<size_t>(un.win) * p.heads + un.h) * n + r] = m[hh] + logf(lt);
          const float inv = 1.f / lt;
          bf16* orow = p.o + un.win * p.o_sw + un.h * p.o_sh + r * p.o_sn;
#pragma unroll
          for (int d = 0; d < 4; ++d)
            *reinterpret_cast<uint32_t*>(orow + 8 * d + 2 * tq) =
                pack_bf2(o[4 * d + 2 * hh] * inv, o[4 * d + 2 * hh + 1] * inv);
        }
      }
    }
    next_item<kFlat>(p, cur, wstep);
  };

  if constexpr (kFlat) {
    for (int i = 0; i < items; ++i) item(i);
  } else {
    // runs of the block's units with one (q tile, head) pair: the block
    // loads that pair's 64 bias rows once per run (two boxes of kLdB keys)
    int i = 0, run = 0;
    for (int s0 = u0; s0 < u1; ++run) {
      const int pair = s0 / p.bw, s1 = min(u1, (pair + 1) * p.bw);
      __syncthreads();  // both warpgroups are done with the last run's rows
      if (threadIdx.x == 0) {
        const int boxes = n > kLdB ? 2 : 1;
        mbar_expect_tx(bbar, boxes * kT * kLdB * 4);
        for (int b = 0; b < boxes; ++b)
          tma3(&p.bias, smem_u32(bias_rows) + b * kT * kLdB * 4, bbar, b * kLdB,
               pair / p.heads * kT, pair % p.heads);
      }
      mbar_wait(bbar, run & 1);
      for (; i < items && cur.pair * p.bw + cur.win < s1; ++i) item(i);
      s0 = s1;
    }
  }
}

// -- host -------------------------------------------------------------------

}  // namespace k10
}  // namespace lavt

// K10 (lse null) or its save mode.  q, k, v share the element strides
// (window, head, row) qsw, qsh, qsn and O has osw, osh, osn; hd is
// contiguous in each.  bias (heads, N, N) and mask (nW - nu, N, N) or null:
// f32, rows `ld` floats apart (ld = N, or N rounded up to 4 where N > 64).
// `blocks`: the grid (ops/window_attn.py's k10_plan).
extern "C" int lavt_window_attn(const void* q, const void* k, const void* v, const void* bias,
                                const void* mask, void* o, void* lse, long long qsw,
                                long long qsh, long long qsn, long long osw, long long osh,
                                long long osn, int Bw, int nW, int nu, int heads, int n, int ld,
                                int blocks, float scale, void* stream) {
  using namespace lavt;
  using namespace lavt::k10;
  const int nqt = (n + kT - 1) / kT;
  const int units = Bw * nqt * heads;
  const bool flat = n <= kT;
  if (n < 1 || n > kNMax || blocks < 1 || heads < 1 || Bw < 1 || ld < n ||
      (flat ? ld != n : ld % 4 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  // N <= 64: a warpgroup with several units must keep one head (its bias
  // registers)
  if (flat && blocks * kWG < units && (blocks * kWG) % heads != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  cudaError_t err = map_qkv(&p.q, q, Bw, heads, n, qsw, qsh, qsn);
  if (err == cudaSuccess) err = map_qkv(&p.k, k, Bw, heads, n, qsw, qsh, qsn);
  if (err == cudaSuccess) err = map_qkv(&p.v, v, Bw, heads, n, qsw, qsh, qsn);
  if (err == cudaSuccess && !flat) err = map_bm(&p.bias, bias, heads, n, ld, kLdB);
  if (err == cudaSuccess && !flat && mask != nullptr)
    err = map_bm(&p.mask, mask, nW - nu, n, ld, kLdT);
  if (err != cudaSuccess) return static_cast<int>(err);
  p.bias_p = static_cast<const float*>(bias);
  p.mask_p = static_cast<const float*>(mask);
  p.o = static_cast<bf16*>(o);
  p.lse = static_cast<float*>(lse);
  p.o_sw = osw, p.o_sh = osh, p.o_sn = osn;
  p.units = units, p.bw = Bw, p.heads = heads, p.n = n, p.nqt = nqt, p.nw = nW, p.nu = nu;
  p.has_mask = mask != nullptr, p.hfirst = qsh < qsn;
  p.per_block = (units + blocks - 1) / blocks;
  p.scale = scale;
  const bool save = lse != nullptr;
  auto kernel = flat ? (save ? &window_attn_sm90_kernel<true, true>
                             : &window_attn_sm90_kernel<true, false>)
                     : (save ? &window_attn_sm90_kernel<false, true>
                             : &window_attn_sm90_kernel<false, false>);
  // each kernel's shared-memory limit (the largest N's), once per device:
  // the attribute holds for the current device only; setting it twice from
  // two threads is harmless
  constexpr int kDevices = 64;
  static std::atomic<bool> limit_set[kDevices][4];
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  std::atomic<bool>* set = dev < kDevices ? &limit_set[dev][2 * flat + save] : nullptr;
  if (set == nullptr || !set->load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_bytes(flat ? kT : kNMax)));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (set != nullptr) set->store(true, std::memory_order_release);
  }
  kernel<<<blocks, kThreads, smem_bytes(n), static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// A K10 block's dynamic shared memory at N (ops/window_attn.py's k10_smem
// is held to it on the card).
extern "C" int lavt_k10_smem(int n) { return static_cast<int>(lavt::k10::smem_bytes(n)); }
