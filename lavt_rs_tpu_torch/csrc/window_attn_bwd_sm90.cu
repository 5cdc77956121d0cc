// K9 for Hopper (sm_90a): the backward of K10 (attention on pre-projected
// heads, csrc/window_attn_sm90.cu).
//
// Replaces lavt_rs_tpu/ops/pallas/window_attn.py:attention_core_bwd /
// _bwd_kernel, the VJP of every K10 call.  Given q, k, v, K10's output o and
// lse, do, the bias and the mask, with s = bf16(q scale) k^T + bias + mask
// as in K10, per window and head (hd = 32, N <= 400):
//   P = exp(s - lse),  D = rowsum(do o)      (f32; o is K10's saved output,
//                                             where the TPU kernel recomputes it)
//   dP = do v^T,  dS = P (dP - D)            (f32)
//   dv = P^T do,  dk = dS^T bf16(q scale),  dq = dS k scale   (P, dS rounded
//                                             to bf16 for the products)
//   dbias[h] = sum over batch and windows of dS   (f32)
// The mask gets no cotangent (a constant of region ids).
//
// Bound on the H100: bytes at every path shape.  Five N x N x hd products
// (10 N^2 hd flops) per window and head against q, k, v, o, do, dq, dk, dv
// in bf16, lse, the f32 bias and dbias and the masked windows' f32 masks:
// video stage 1 (324 windows x 3 heads, N = 392) 47.8 GFLOP (0.048 ms)
// against 200 MB (0.060 ms).
//
// Why the first design (csrc/window_attn.cu before this file) lost to the
// library call:
// per-warp mma.sync over 16-row tiles, k and v copied by plain loads behind
// a __syncthreads, the bias and the mask read per element from L2 inside the
// key loop (transposed, four bytes a thread, in its key launch), every
// window's dS read-modify-written through L2 into per-group f32 slices of
// dbias, and every window's mask read whether it masks anything or not.
//
// Design: two launches and a sum, on K10's wgmma + TMA structure.  dq sums
// over keys, dk and dv over queries and dbias over windows: dbias stays on
// the chip only if one block sees many windows of one (query tile, head),
// and then dk and dv (sums over every query tile) are another block's, so
// S and dP are computed in both launches (7 products, not 5), each a few
// wgmma k-steps next to the elementwise work that bounds them.
//   1. attn_bwd_q_kernel: grid (bp, query tiles x heads); block (b, (i, h))
//      takes the windows b, b + bp, ... of query tile i, head h.  Its f32
//      dbias rows (64 x N) live in shared memory for the whole block and
//      are written once, as partial b, at the end.  Above N = 64 both
//      warpgroups work on one window, each on every other key tile (the
//      parity alternating per window), and add their dq halves in a fixed
//      order through shared memory; at N <= 64 (one key tile) each
//      warpgroup takes every other window with its own dbias rows (partial
//      2 b + warpgroup) and holds the head's bias tile for the block.  Per
//      key tile: S = bf16(q scale) k^T and dP = do v^T (wgmma, q and do as
//      register A, k and v K-major from a TMA ring stage with the 64 x 68
//      f32 bias tile), P, dS in registers, dbias += dS in shared memory,
//      dq += dS k (register A, k MN-major).  D = rowsum(do o) per row (o
//      and lse read a window ahead) and bf16(q scale) (K10's rounding of q)
//      are written for launch 2.
//   2. attn_bwd_kv_kernel: persistent warpgroups over units (key tile j,
//      head h, window), ordered (j, h) outermost; per query tile a stage of
//      a three-deep ring brings bf16(q scale), do and the bias tile (and,
//      first, the unit's k and v: register A); S^T = k q^T, dP^T = v do^T,
//      P^T and dS^T in registers (the bias tile read transposed, rows 68
//      floats apart: no bank conflicts), dv += P^T do, dk += dS^T q
//      (register A, MN-major B).
//   3. sum_partials (csrc/fused_msa_bwd.cu) adds the dbias partials in a
//      fixed order: the same inputs give the same bits (no float atomics).
// Masks: a window's mask is read (from L2, in the fragments' layout) only
// where `flags` marks it nonzero (the Swin blocks build the flags with
// their shift masks); without flags every window's mask is read.

#include "attn_sm90.cuh"
#include "common.cuh"

namespace lavt {
namespace k9 {

using namespace attn;

constexpr int kNMax = 400;
constexpr int kWG = 2;
constexpr int kThreads = 128 * kWG;
constexpr int kR = 2;                          // ring stages per warpgroup (launch 1)
constexpr int kRkv = 3;                        // launch 2's
constexpr int kLdB = 68;                       // f32 row stride of a bias tile
constexpr int kBiasTile = kT * kLdB * 4;       // 17 KB
constexpr int kUnitBytes = 2 * kTileBytes;     // q and do of a window (launch 1)
constexpr int kQStage = 2 * kTileBytes + kBiasTile;                  // k, v, bias
// launch 2's stage: q, do, k, v (+ the bias tile above N = 64)
__host__ __device__ inline int kv_stage(bool flat) { return 4 * kTileBytes + (flat ? 0 : kBiasTile); }

// launch 1: the dbias rows' f32 row stride, >= N, 8 mod 32 (the float2
// accesses of a fragment row fall on 32 banks) unless that costs more than
// 16 floats a row (N = 400: 400, the rows fit shared memory)
__host__ __device__ inline int ld_dbias(int n) {
  const int ld = (n + 7) / 8 * 8, lc = (n + 23) / 32 * 32 + 8;
  return lc - ld <= 16 ? lc : ld;
}
__host__ __device__ inline int dbias_bytes(int n) { return kT * ld_dbias(n) * 4; }
// launch 1's shared memory: above N = 64 [dbias rows][2 unit buffers][per
// warpgroup: kR stages of k, v, bias][dq exchange]; at N <= 64 per
// warpgroup [dbias rows][2 unit buffers][the bias tile][kR stages of k, v]
__host__ __device__ inline size_t q_smem(int n) {
  const size_t bars = 128;
  if (n > kT)
    return 1024 + dbias_bytes(n) + 2 * kUnitBytes + size_t(kWG) * kR * kQStage + kT * kHD * 4 +
           bars;
  return 1024 + size_t(kWG) * (dbias_bytes(n) + 2 * kUnitBytes + kBiasTile +
                               kR * 2 * kTileBytes) + bars;
}
// launch 2: per warpgroup its ring (and at N <= 64 its head's bias tile)
__host__ __device__ inline size_t kv_smem(int n) {
  const bool flat = n <= kT;
  return 1024 + size_t(kWG) * (kRkv * kv_stage(flat) + (flat ? kBiasTile : 0)) + 64;
}

struct QParams {
  CUtensorMap q, k, v, dout, bias;  // heads (B nW, heads, N, 32); bias 3-D
  const float* bias_p;              // the bias itself (N <= 64)
  const bf16* o;
  const float* lse;
  const float* mask;   // (nW, N, N) or null
  const int* flags;    // (nW,): 1 where the window's mask has a nonzero, or null
  bf16* dq;
  bf16* qs;            // bf16(q scale) for launch 2
  float* dsum;         // D, (B nW, heads, N)
  float* dbias_part;   // (parts, heads, N, N)
  int bw, nw, heads, n, nt, bp;
  float scale;
};

struct KVParams {
  CUtensorMap q, k, v, dout, bias;  // q: launch 1's bf16(q scale)
  const float* bias_p;
  const float* lse;
  const float* dsum;
  const float* mask;
  const int* flags;
  bf16* dk;
  bf16* dv;
  int bw, nw, heads, n, nt, units;
};

__device__ __forceinline__ void bar_sync_all(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(kThreads) : "memory");
}

// the mask values (c, c + 1) of one row (0 past N; scalar loads for odd N)
__device__ __forceinline__ float2 mask_pair(const float* __restrict__ row, int c, int n) {
  if (!(n & 1)) return c < n ? __ldg(reinterpret_cast<const float2*>(row + c)) : make_float2(0.f, 0.f);
  return make_float2(c < n ? __ldg(row + c) : 0.f, c + 1 < n ? __ldg(row + c + 1) : 0.f);
}

// a head's N x N f32 bias (N <= 64) into a 64 x kLdB tile, 0 past N, by the
// warpgroup's plain loads (N x N rows need not lie 16 bytes apart)
__device__ __forceinline__ void copy_bias(float* dst, const float* __restrict__ src, int n) {
  for (int e = threadIdx.x % 128; e < kT * kT; e += 128) {
    const int r = e / kT, c = e % kT;
    dst[r * kLdB + c] = r < n && c < n ? __ldg(src + r * n + c) : 0.f;
  }
}

// -- launch 1: dq, D and dbias ------------------------------------------------

template <bool kSplit>
__global__ void __launch_bounds__(kThreads, 1) attn_bwd_q_kernel(const __grid_constant__ QParams p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32, g = lane / 4, tq = lane % 4;
  const int n = p.n, nt = p.nt, heads = p.heads;
  const int i = blockIdx.y / heads, h = blockIdx.y % heads, q0 = i * kT;
  const int ldd = ld_dbias(n);
  // carve: see q_smem
  unsigned char* base = smem + (kSplit ? 0 : wg * (dbias_bytes(n) + 2 * kUnitBytes + kBiasTile +
                                                    kR * 2 * kTileBytes));
  float* dbias = reinterpret_cast<float*>(base);
  unsigned char* units = base + dbias_bytes(n);
  unsigned char* btile = units + 2 * kUnitBytes;  // N <= 64: the head's bias tile
  unsigned char* ring = kSplit ? units + 2 * kUnitBytes + wg * kR * kQStage
                               : btile + kBiasTile;
  const int stage_bytes = kSplit ? kQStage : 2 * kTileBytes;
  float* xchg = reinterpret_cast<float*>(smem + dbias_bytes(n) + 2 * kUnitBytes +
                                         kWG * kR * kQStage);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + q_smem(n) - 128 - 1024);
  uint64_t* full = bars + wg * kR;      // this warpgroup's ring
  uint64_t* ubar = bars + kWG * kR + (kSplit ? 0 : 2 * wg);  // unit buffers 0, 1
  if (threadIdx.x == 0) {
    for (int b = 0; b < kWG * kR + 4; ++b) mbar_init(&bars[b], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  {  // split: one set of rows for the block; else one per warpgroup
    const int tid = kSplit ? threadIdx.x : t, nthr = kSplit ? kThreads : 128;
    for (int e = tid; e < kT * ldd; e += nthr) dbias[e] = 0.f;
  }
  __syncthreads();

  // windows of this warpgroup: u = 0, 1, ... (split: both warpgroups take
  // every window), u = wg, wg + 2, ... (N <= 64), window k + u bp
  const int ustep = kSplit ? 1 : 2, u_first = kSplit ? 0 : wg;
  auto window = [&](int u) { return blockIdx.x + u * p.bp; };
  auto first_j = [&](int u) { return kSplit ? (wg + u) & 1 : 0; };
  const bool loader = kSplit ? threadIdx.x == 0 : t == 0;  // issues the unit loads
  auto issue_unit = [&](int u) {
    uint64_t* bar = &ubar[(u / ustep) & 1];
    const uint32_t dst = smem_u32(units) + ((u / ustep) & 1) * kUnitBytes;
    mbar_expect_tx(bar, kUnitBytes);
    tma4(&p.q, dst, bar, 0, q0, h, window(u));
    tma4(&p.dout, dst + kTileBytes, bar, 0, q0, h, window(u));
  };
  // ring items: (u, j); the producer (t == 0) runs `ahead` kR items early
  struct Cur {
    int u, j;
  };
  auto next = [&](Cur& c) {
    c.j += kSplit ? 2 : 1;
    if (c.j >= nt) c.u += ustep, c.j = first_j(c.u);
  };
  auto issue_item = [&](int idx, const Cur& c) {
    uint64_t* bar = &full[idx % kR];
    const uint32_t dst = smem_u32(ring) + (idx % kR) * stage_bytes;
    mbar_expect_tx(bar, stage_bytes);
    tma4(&p.k, dst, bar, 0, c.j * kT, h, window(c.u));
    tma4(&p.v, dst + kTileBytes, bar, 0, c.j * kT, h, window(c.u));
    if (kSplit) tma3(&p.bias, dst + 2 * kTileBytes, bar, c.j * kT, q0, h);
  };
  Cur ahead{u_first, first_j(u_first)};
  int issued = 0;
  if (loader) {
    for (int u = u_first; u < u_first + 2 * ustep && window(u) < p.bw; u += ustep) issue_unit(u);
  }
  if (t == 0)
    for (; issued < kR && window(ahead.u) < p.bw; ++issued, next(ahead)) issue_item(issued, ahead);
  if (!kSplit) {  // the head's N x N bias (N <= 64) by plain loads, 0 past N
    copy_bias(reinterpret_cast<float*>(btile), p.bias_p + static_cast<size_t>(h) * n * n, n);
    named_sync(1 + wg);
  }

  const int ra = warp * 16 + g, rb = ra + 8;  // this thread's rows of the tile
  // a window's o values at this thread's A-fragment places (rows ra, rb;
  // columns 16 ks + 2 tq (+ 8)) and lse of its rows, fetched a window ahead
  struct Pre {
    uint32_t o[2][4];
    float lse[2];
  };
  auto fetch = [&](int u) {
    Pre f;
    const size_t rows = (static_cast<size_t>(window(u)) * heads + h) * n;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = q0 + (hh ? rb : ra);
      const bool in = window(u) < p.bw && r < n;
      const bf16* orow = p.o + (rows + r) * kHD;
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
#pragma unroll
        for (int half = 0; half < 2; ++half)
          f.o[ks][hh + 2 * half] =
              in ? __ldg(reinterpret_cast<const unsigned*>(orow + 16 * ks + 2 * tq + 8 * half))
                 : 0u;
      f.lse[hh] = in ? __ldg(p.lse + rows + r) * kLog2e : pos_inf();  // rows past N: P = 0
    }
    return f;
  };
  Pre pre = fetch(u_first);
  int item = 0;
  for (int u = u_first; window(u) < p.bw; u += ustep) {
    const int win = window(u);
    const int wi = win % p.nw;
    const bool masked = p.mask != nullptr && (p.flags == nullptr || p.flags[wi] != 0);
    const float* mrow[2] = {nullptr, nullptr};
    const size_t rows = (static_cast<size_t>(win) * heads + h) * n;  // (win, h) row 0
    const unsigned char* ub = units + ((u / ustep) & 1) * kUnitBytes;
    mbar_wait(&ubar[(u / ustep) & 1], (u / ustep / 2) & 1);
    uint32_t qa[2][4], da[2][4];
    tile_frags(qa, ub, p.scale);
    tile_frags(da, ub + kTileBytes, 1.f);
    // D = rowsum(do o) of rows ra, rb; lse; the next window's o and lse
    float dsum[2], lse2[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = q0 + (hh ? rb : ra);
      float s = 0.f;
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const uint32_t ov = pre.o[ks][hh + 2 * half], dv = da[ks][hh + 2 * half];
          const float2 of = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ov));
          const float2 df = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&dv));
          s += df.x * of.x + df.y * of.y;
        }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      dsum[hh] = s;
      lse2[hh] = pre.lse[hh];
      if (masked && r < n) mrow[hh] = p.mask + (static_cast<size_t>(wi) * n + r) * n;
    }
    if (!kSplit || wg == 0) {  // bf16(q scale) for launch 2 (its K10 rounding)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = q0 + (hh ? rb : ra);
        if (r >= n) continue;
#pragma unroll
        for (int ks = 0; ks < 2; ++ks)
#pragma unroll
          for (int half = 0; half < 2; ++half)
            *reinterpret_cast<uint32_t*>(p.qs + (rows + r) * kHD + 16 * ks + 2 * tq + 8 * half) =
                qa[ks][hh + 2 * half];
      }
    }
    pre = fetch(u + ustep);
    float dq[16];
#pragma unroll
    for (int d = 0; d < 16; ++d) dq[d] = 0.f;
    for (int j = first_j(u); j < nt; j += kSplit ? 2 : 1, ++item) {
      const int k0 = j * kT;
      const unsigned char* st = ring + (item % kR) * stage_bytes;
      const uint32_t kaddr = smem_u32(st), vaddr = kaddr + kTileBytes;
      const float* bt = reinterpret_cast<const float*>(kSplit ? st + 2 * kTileBytes : btile);
      // the masked window's values, loaded ahead of the products (L2
      // latency off the elementwise work)
      float2 mk[2][8];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int jn = 0; jn < 8; ++jn)
          mk[hh][jn] = mrow[hh] != nullptr ? mask_pair(mrow[hh], k0 + 8 * jn + 2 * tq, n)
                                           : make_float2(0.f, 0.f);
      mbar_wait(&full[item % kR], (item / kR) & 1);
      float s[32], dp[32];
#pragma unroll
      for (int d = 0; d < 32; ++d) s[d] = dp[d] = 0.f;
      pin(s);
      pin(dp);
      pin(qa[0]);
      pin(qa[1]);
      pin(da[0]);
      pin(da[1]);
      wgmma_fence();
      wgmma_s(s, qa[0], kmajor(kaddr, 0));
      wgmma_s(s, qa[1], kmajor(kaddr, 1));
      wgmma_s(dp, da[0], kmajor(vaddr, 0));
      wgmma_s(dp, da[1], kmajor(vaddr, 1));
      wgmma_commit();
      wgmma_wait<0>();
      pin(s);
      pin(dp);
      // P = exp(s + bias + mask - lse) (0 past N), dS = P (dP - D) into s;
      // dbias += dS
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = hh ? rb : ra;
#pragma unroll
        for (int jn = 0; jn < 8; ++jn) {
          const int c = 8 * jn + 2 * tq, kc = k0 + c;
          float2 add = *reinterpret_cast<const float2*>(bt + r * kLdB + c);
          add.x += mk[hh][jn].x, add.y += mk[hh][jn].y;
          float& s0 = s[4 * jn + 2 * hh];
          float& s1 = s[4 * jn + 2 * hh + 1];
          const float p0 = kc < n ? ex2(fmaf(s0 + add.x, kLog2e, -lse2[hh])) : 0.f;
          const float p1 = kc + 1 < n ? ex2(fmaf(s1 + add.y, kLog2e, -lse2[hh])) : 0.f;
          s0 = p0 * (dp[4 * jn + 2 * hh] - dsum[hh]);
          s1 = p1 * (dp[4 * jn + 2 * hh + 1] - dsum[hh]);
          if (kc < n) {  // columns [N, ldd) of the row are this thread's alone
            float2* db = reinterpret_cast<float2*>(dbias + r * ldd + kc);
            float2 cur = *db;
            cur.x += s0, cur.y += s1;
            *db = cur;
          }
        }
      }
      // dq += dS k, 16 keys a step (steps wholly past N skipped)
      uint32_t sa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        sa[kk][0] = pack_bf2(s[8 * kk], s[8 * kk + 1]);
        sa[kk][1] = pack_bf2(s[8 * kk + 2], s[8 * kk + 3]);
        sa[kk][2] = pack_bf2(s[8 * kk + 4], s[8 * kk + 5]);
        sa[kk][3] = pack_bf2(s[8 * kk + 6], s[8 * kk + 7]);
      }
      const int steps = min(4, (n - k0 + 15) / 16);
      pin(dq);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) pin(sa[kk]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        if (kk < steps) wgmma_o(dq, sa[kk], mnmajor(kaddr, kk));
      wgmma_commit();
      wgmma_wait<0>();
      pin(dq);
      named_sync(1 + wg);  // the warpgroup is done with this stage
      if (t == 0 && window(ahead.u) < p.bw) {
        issue_item(issued++, ahead);
        next(ahead);
      }
    }
    // dq (split: the two warpgroups' halves added in order, warpgroup 0's
    // first), D
    if (kSplit) {
      if (wg == 1) {
#pragma unroll
        for (int d = 0; d < 16; ++d) xchg[t * 16 + d] = dq[d];
      }
      bar_sync_all(3);
    }
    if (!kSplit || wg == 0) {
#pragma unroll
      for (int d = 0; d < 16; ++d) {
        if (kSplit) dq[d] += xchg[t * 16 + d];
        dq[d] *= p.scale;
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = q0 + (hh ? rb : ra);
        if (r >= n) continue;
        bf16* out = p.dq + (rows + r) * kHD;
#pragma unroll
        for (int d = 0; d < 4; ++d)
          *reinterpret_cast<uint32_t*>(out + 8 * d + 2 * tq) =
              pack_bf2(dq[4 * d + 2 * hh], dq[4 * d + 2 * hh + 1]);
        if (tq == 0) p.dsum[rows + r] = dsum[hh];
      }
    }
    if (kSplit) bar_sync_all(3);  // xchg read; both warpgroups' unit reads done
    else named_sync(1 + wg);
    if (loader && window(u + 2 * ustep) < p.bw) issue_unit(u + 2 * ustep);
  }

  // this block's dbias rows (split: both warpgroups' columns) as its partial
  __syncthreads();
  const int part = kSplit ? blockIdx.x : 2 * blockIdx.x + wg;
  float* out = p.dbias_part + (static_cast<size_t>(part) * heads + h) * n * n;
  const int nthr = kSplit ? kThreads : 128, tid = kSplit ? threadIdx.x : t;
  const int rows_here = min(kT, n - q0);
  for (int e = tid; e < rows_here * n; e += nthr) {
    const int r = e / n, c = e % n;
    out[static_cast<size_t>(q0 + r) * n + c] = dbias[r * ldd + c];
  }
}

// -- launch 2: dk, dv ------------------------------------------------------------

template <bool kFlat>
__global__ void __launch_bounds__(kThreads, 1) attn_bwd_kv_kernel(const __grid_constant__ KVParams p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32, g = lane / 4, tq = lane % 4;
  const int n = p.n, nt = p.nt, heads = p.heads;
  constexpr int kStage = kFlat ? 4 * kTileBytes : 4 * kTileBytes + kBiasTile;
  constexpr int kWgBytes = kRkv * kStage + (kFlat ? kBiasTile : 0);
  unsigned char* ring = smem + wg * kWgBytes;
  float* bflat = reinterpret_cast<float*>(ring + kRkv * kStage);  // N <= 64: the head's bias
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kWG * kWgBytes) + wg * kRkv;
  if (t == 0) {
    for (int b = 0; b < kRkv; ++b) mbar_init(&full[b], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // units u = (j heads + h) B nW + window; warpgroup c of T takes c, c + T, ...
  const int T = gridDim.x * kWG, cg = blockIdx.x * kWG + wg;
  struct Cur {
    int u, i;
  };
  auto issue_item = [&](int idx, const Cur& c) {
    const int win = c.u % p.bw, hj = c.u / p.bw, h = hj % heads, j = hj / heads;
    uint64_t* bar = &full[idx % kRkv];
    const uint32_t dst = smem_u32(ring) + (idx % kRkv) * kStage;
    mbar_expect_tx(bar, (c.i == 0 ? 4 : 2) * kTileBytes + (kFlat ? 0 : kBiasTile));
    tma4(&p.q, dst, bar, 0, c.i * kT, h, win);
    tma4(&p.dout, dst + kTileBytes, bar, 0, c.i * kT, h, win);
    if (c.i == 0) {
      tma4(&p.k, dst + 2 * kTileBytes, bar, 0, j * kT, h, win);
      tma4(&p.v, dst + 3 * kTileBytes, bar, 0, j * kT, h, win);
    }
    if (!kFlat) tma3(&p.bias, dst + 4 * kTileBytes, bar, j * kT, c.i * kT, h);
  };
  auto next = [&](Cur& c) {
    if (++c.i >= nt) c.i = 0, c.u += T;
  };
  Cur ahead{cg, 0};
  int issued = 0;
  if (t == 0)
    for (; issued < kRkv && ahead.u < p.units; ++issued, next(ahead)) issue_item(issued, ahead);

  const int ra = warp * 16 + g, rb = ra + 8;  // this thread's key rows of the tile
  int item = 0, bias_h = -1;
  for (int u = cg; u < p.units; u += T) {
    const int win = u % p.bw, hj = u / p.bw, h = hj % heads, j = hj / heads, k0 = j * kT;
    const int wi = win % p.nw;
    if (kFlat && h != bias_h) {  // the warpgroup is past its last item's reads
      copy_bias(bflat, p.bias_p + static_cast<size_t>(h) * n * n, n);
      named_sync(1 + wg);
      bias_h = h;
    }
    const bool masked = p.mask != nullptr && (p.flags == nullptr || p.flags[wi] != 0);
    const size_t rows = (static_cast<size_t>(win) * heads + h) * n;
    uint32_t ka[2][4], va[2][4];
    float dk[16], dv[16];
#pragma unroll
    for (int d = 0; d < 16; ++d) dk[d] = dv[d] = 0.f;
    for (int i = 0; i < nt; ++i, ++item) {
      const int q0 = i * kT;
      unsigned char* st = ring + (item % kRkv) * kStage;
      const uint32_t qaddr = smem_u32(st), doaddr = qaddr + kTileBytes;
      const float* bt = kFlat ? bflat : reinterpret_cast<const float*>(st + 4 * kTileBytes);
      // lse and D of this thread's 16 query columns (issued before the wait)
      float l2[16], dd[16];
#pragma unroll
      for (int jn = 0; jn < 8; ++jn)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = q0 + 8 * jn + 2 * tq + e;
          l2[2 * jn + e] = c < n ? __ldg(p.lse + rows + c) * kLog2e : pos_inf();
          dd[2 * jn + e] = c < n ? __ldg(p.dsum + rows + c) : 0.f;
        }
      // the masked window's values at (query c, key r), loaded ahead
      float mk[32];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int jn = 0; jn < 8; ++jn)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int qc = q0 + 8 * jn + 2 * tq + e, kr = k0 + (hh ? rb : ra);
            mk[4 * jn + 2 * hh + e] =
                masked && qc < n && kr < n
                    ? __ldg(p.mask + (static_cast<size_t>(wi) * n + qc) * n + kr)
                    : 0.f;
          }
      mbar_wait(&full[item % kRkv], (item / kRkv) & 1);
      if (i == 0) {  // the unit's k and v as register A
        tile_frags(ka, st + 2 * kTileBytes, 1.f);
        tile_frags(va, st + 3 * kTileBytes, 1.f);
      }
      float s[32], dp[32];
#pragma unroll
      for (int d = 0; d < 32; ++d) s[d] = dp[d] = 0.f;
      pin(s);
      pin(dp);
      pin(ka[0]);
      pin(ka[1]);
      pin(va[0]);
      pin(va[1]);
      wgmma_fence();
      wgmma_s(s, ka[0], kmajor(qaddr, 0));
      wgmma_s(s, ka[1], kmajor(qaddr, 1));
      wgmma_s(dp, va[0], kmajor(doaddr, 0));
      wgmma_s(dp, va[1], kmajor(doaddr, 1));
      wgmma_commit();
      wgmma_wait<0>();
      pin(s);
      pin(dp);
      // P^T into s, dS^T into dp: (key r, query c); bias and mask at [c][r]
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = hh ? rb : ra;
#pragma unroll
        for (int jn = 0; jn < 8; ++jn)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = 8 * jn + 2 * tq + e;
            const int x = 4 * jn + 2 * hh + e;
            const float add = bt[c * kLdB + r] + mk[x];
            const float pv = ex2(fmaf(s[x] + add, kLog2e, -l2[2 * jn + e]));
            s[x] = pv;
            dp[x] = pv * (dp[x] - dd[2 * jn + e]);
          }
      }
      uint32_t pa[4][4], sa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        pa[kk][0] = pack_bf2(s[8 * kk], s[8 * kk + 1]);
        pa[kk][1] = pack_bf2(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = pack_bf2(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = pack_bf2(s[8 * kk + 6], s[8 * kk + 7]);
        sa[kk][0] = pack_bf2(dp[8 * kk], dp[8 * kk + 1]);
        sa[kk][1] = pack_bf2(dp[8 * kk + 2], dp[8 * kk + 3]);
        sa[kk][2] = pack_bf2(dp[8 * kk + 4], dp[8 * kk + 5]);
        sa[kk][3] = pack_bf2(dp[8 * kk + 6], dp[8 * kk + 7]);
      }
      const int steps = min(4, (n - q0 + 15) / 16);
      pin(dv);
      pin(dk);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        pin(pa[kk]);
        pin(sa[kk]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        if (kk < steps) {
          wgmma_o(dv, pa[kk], mnmajor(doaddr, kk));
          wgmma_o(dk, sa[kk], mnmajor(qaddr, kk));
        }
      wgmma_commit();
      wgmma_wait<0>();
      pin(dv);
      pin(dk);
      named_sync(1 + wg);  // the warpgroup is done with this stage
      if (t == 0 && ahead.u < p.units) {
        issue_item(issued++, ahead);
        next(ahead);
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = k0 + (hh ? rb : ra);
      if (r >= n) continue;
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        *reinterpret_cast<uint32_t*>(p.dk + (rows + r) * kHD + 8 * d + 2 * tq) =
            pack_bf2(dk[4 * d + 2 * hh], dk[4 * d + 2 * hh + 1]);
        *reinterpret_cast<uint32_t*>(p.dv + (rows + r) * kHD + 8 * d + 2 * tq) =
            pack_bf2(dv[4 * d + 2 * hh], dv[4 * d + 2 * hh + 1]);
      }
    }
  }
}

}  // namespace k9
}  // namespace lavt

namespace lavt {
namespace k9 {

// the tensor maps both launches read: q, k, v, do (B nW, heads, N, 32) bf16
// contiguous; above N = 64 bias (heads, N, N) f32 with rows `ld` floats
// apart (ld % 4 == 0: TMA's 16-byte row strides; the wrapper pads N % 4 !=
// 0); at N <= 64 ld = N and the launches copy the bias by plain loads
inline cudaError_t maps(CUtensorMap* q_m, CUtensorMap* k_m, CUtensorMap* v_m, CUtensorMap* do_m,
                        CUtensorMap* b_m, const void* q, const void* k, const void* v,
                        const void* dout, const void* bias, int Bw, int heads, int n, int ld) {
  const long long sh = static_cast<long long>(n) * kHD, sw = sh * heads;
  cudaError_t err = map_qkv(q_m, q, Bw, heads, n, sw, sh, kHD);
  if (err == cudaSuccess) err = map_qkv(k_m, k, Bw, heads, n, sw, sh, kHD);
  if (err == cudaSuccess) err = map_qkv(v_m, v, Bw, heads, n, sw, sh, kHD);
  if (err == cudaSuccess) err = map_qkv(do_m, dout, Bw, heads, n, sw, sh, kHD);
  if (err == cudaSuccess && n > kT) err = map_bm(b_m, bias, heads, n, ld, kLdB);
  return err;
}

inline bool bad_args(int Bw, int heads, int n, int ld) {
  return n < 1 || n > kNMax || Bw < 1 || heads < 1 || (n > kT ? ld < n || ld % 4 != 0 : ld != n);
}

}  // namespace k9
}  // namespace lavt

// K9, launch 1: dq, bf16(q scale) (qs), D (dsum) and the dbias partials.
// q, k, v, o, dout, dq, qs:
// (B nW, heads, N, 32) bf16 contiguous; lse, dsum (B nW, heads, N) f32;
// bias as `maps` takes it; mask (nW, N, N) f32 or null, flags (nW,) int
// (1: the window's mask is read) or null (every window's is); dbias_part
// (parts, heads, N, N) f32,
// parts = bp above N = 64, else 2 bp.  Grid (bp, query tiles x heads).
extern "C" int lavt_window_attn_bwd_q(const void* q, const void* k, const void* v,
                                      const void* o, const void* dout, const void* lse,
                                      const void* bias, const void* mask, const void* flags,
                                      void* dq, void* qs, void* dsum, void* dbias_part, int Bw,
                                      int nW,
                                      int heads, int n, int ld, int bp, float scale,
                                      void* stream) {
  using namespace lavt;
  using namespace lavt::k9;
  if (bad_args(Bw, heads, n, ld) || bp < 1 || bp > Bw)
    return static_cast<int>(cudaErrorInvalidValue);
  QParams qp;
  cudaError_t err = maps(&qp.q, &qp.k, &qp.v, &qp.dout, &qp.bias, q, k, v, dout, bias, Bw,
                         heads, n, ld);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nt = (n + kT - 1) / kT;
  qp.bias_p = static_cast<const float*>(bias);
  qp.o = static_cast<const bf16*>(o);
  qp.lse = static_cast<const float*>(lse);
  qp.mask = static_cast<const float*>(mask);
  qp.flags = static_cast<const int*>(flags);
  qp.dq = static_cast<bf16*>(dq);
  qp.qs = static_cast<bf16*>(qs);
  qp.dsum = static_cast<float*>(dsum);
  qp.dbias_part = static_cast<float*>(dbias_part);
  qp.bw = Bw, qp.nw = nW, qp.heads = heads, qp.n = n, qp.nt = nt, qp.bp = bp;
  qp.scale = scale;
  auto kernel = n > kT ? &attn_bwd_q_kernel<true> : &attn_bwd_q_kernel<false>;
  const size_t smem = q_smem(n);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(bp, nt * heads), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(qp);
  return static_cast<int>(cudaGetLastError());
}

// K9, launch 2: dk, dv from launch 1's qs (bf16(q scale)) and dsum;
// arguments as launch 1's; `blocks` persistent blocks of two warpgroups.
extern "C" int lavt_window_attn_bwd_kv(const void* qs, const void* k, const void* v,
                                       const void* dout, const void* lse, const void* dsum,
                                       const void* bias, const void* mask, const void* flags,
                                       void* dk, void* dv, int Bw, int nW, int heads, int n,
                                       int ld, int blocks, void* stream) {
  using namespace lavt;
  using namespace lavt::k9;
  if (bad_args(Bw, heads, n, ld) || blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  KVParams kp;
  cudaError_t err = maps(&kp.q, &kp.k, &kp.v, &kp.dout, &kp.bias, qs, k, v, dout, bias, Bw,
                         heads, n, ld);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nt = (n + kT - 1) / kT;
  kp.bias_p = static_cast<const float*>(bias);
  kp.lse = static_cast<const float*>(lse);
  kp.dsum = static_cast<const float*>(dsum);
  kp.mask = static_cast<const float*>(mask);
  kp.flags = static_cast<const int*>(flags);
  kp.dk = static_cast<bf16*>(dk);
  kp.dv = static_cast<bf16*>(dv);
  kp.bw = Bw, kp.nw = nW, kp.heads = heads, kp.n = n, kp.nt = nt;
  kp.units = Bw * nt * heads;
  auto kernel = n > kT ? &attn_bwd_kv_kernel<false> : &attn_bwd_kv_kernel<true>;
  const size_t smem = kv_smem(n);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(kp);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lavt_k9_q_smem(int n) { return static_cast<int>(lavt::k9::q_smem(n)); }
