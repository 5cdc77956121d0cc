// K9 f32: the backward of K10 f32 (csrc/window_attn_f32.cu) on f32
// activations.
//
// Replaces the f32 computation of lavt_rs_tpu/ops/pallas/window_attn.py:
// attention_core_bwd / _bwd_kernel, the VJP of every K10 call, on f32
// inputs (the TPU kernel computes in f32; its roundings to the input dtype
// are no-ops).  Given q, k, v, K10 f32's output o and lse, do, the bias and
// the mask, per window and head (hd = 32, N <= 400), all in f32:
//   s = (q scale) k^T + bias + mask,  P = exp(s - lse),  D = rowsum(do o)
//   dP = do v^T,  dS = P (dP - D)
//   dq = dS k scale,  dk = dS^T (q scale),  dv = P^T do
//   dbias[h] = sum over batch and windows of dS
// The mask gets no cotangent (a constant of region ids).
//
// Bound on the H100: operations.  Five N x N x hd products (10 N^2 hd
// flops) per window and head against f32 q, k, v, o, do, dq, dk, dv, lse,
// the bias, dbias and the masked windows' masks: video stage 1 (324
// windows x 3 heads, N = 392) 47.8 GFLOP (0.290 ms at 165 TFLOP/s = the
// 495 TF32 TFLOP/s over the three products of 3xTF32) against 401 MB
// (0.120 ms).
//
// Design: every product in 3xTF32 on mma.sync.m16n8k8 (csrc/attn_tf32.cuh:
// each warp owns 16 rows; S and dP stay in registers as dS and feed dS k,
// P^T and dS^T feed P^T do and dS^T q, with no trip through shared memory;
// the B operands split once a tile into fragment tiles, one 16-byte load
// a fragment).  Two launches and a sum, since dq sums over keys, dk and dv
// over queries and dbias over windows, none by atomics; S and dP are
// computed in both launches (7 products, not 5).  Blocks of 5 warps take
// 80 rows (392 = 5 x 80 - 8: 2 % of the rows padding); the other side runs
// in tiles of 56 (392 = 7 x 56), n-tiles of 8 past N skipped.
//   1. window_attn_bwd_q_f32_kernel: grid (bp, query tiles x heads); block
//      (b, (i, h)) takes the windows b, b + bp, ... of query tile i, head
//      h.  Key tiles outermost, so each thread keeps its 16 x 56 / 32 = 28
//      values of the tile's dbias in registers across the block's windows.
//      Per (key tile, window): q and do (80 rows) and lse in a ring of two
//      stages, k and v (56 rows) raw and then as fragment tiles (k NT and
//      NN, v NT), the next step's tiles loading (cp.async) while this one
//      computes; S = bias + (q scale) k^T (the bias read from L2 into the
//      accumulators before the step's wait) and dP = do v^T (the warp's 16
//      x 56), dS, dbias += dS, and dq = dS k written (the first key tile)
//      or added (the others) to the rows' dq, times scale.  D = rowsum(do
//      o) is computed at the first key tile (four lanes a row), written for
//      launch 2, and read back by the same thread at the others.  After a
//      key tile's last window each warp writes its dbias rows into partial
//      b.  (Windows outermost, with the partial in device memory read and
//      written each step, ran 1.2-1.3x slower on an H100.)
//   2. window_attn_bwd_kv_f32_kernel: a block per (window, head, key tile
//      of 80); k and v staged once, raw (the A operands); per tile of 56
//      queries q scale and do as fragment tiles (NT and NN), lse and D in a
//      ring of two; S^T = k (q scale)^T and dP^T = v do^T (the warp's 16
//      keys x 56 queries), P^T and dS^T, then dv += P^T do and dk += dS^T (q
//      scale), each tile's sum in a zeroed part.
//   3. sum_partials (csrc/fused_msa_bwd.cu) adds the dbias partials in a
//      fixed order: the same inputs give the same bits (no float atomics).
// A window's mask is read only where `flags` marks it nonzero (every
// window's without flags); the bias and the mask are read from L2 at the C
// fragments' places.  Dynamic shared memory: 103.4 KB a block (launch 1),
// 95.1 KB (launch 2), two blocks an SM.  (The designs before, FFMA on
// register-blocked 64 x 64 tiles and before that a thread per row, ran at
// 30.1 and 53.1 ms a video step: PERF.md.)

#include <cstdint>

#include "attn_tf32.cuh"

namespace lavt {
namespace k9f32 {

using namespace tf32attn;

constexpr int kNMax = 400;
constexpr int kWarps = 5, kThreads = 32 * kWarps, kRows = 16 * kWarps;  // 80 rows a block
constexpr int kCols = 56, kNT = kCols / 8;  // the other side's tiles: 7 n-tiles of 8
constexpr int kRowT = kRows * kLd, kColT = kCols * kLd;  // floats of an 80- and a 56-row tile
constexpr int kFragT = frag_tile_bytes(kCols) / 16;      // 16-byte words of a 56-row fragment tile
// launch 1: the fragment tiles k NT, k NN, v NT; raw k and v (56 rows); a
// ring of two stages of q and do (80 rows) and lse
constexpr int kQStage = 2 * kRowT + kRows;
constexpr size_t kQSmem = 3 * kFragT * 16 + (2 * kColT + 2 * kQStage) * sizeof(float);
// launch 2: the fragment tiles q NT, q NN, do NT, do NN; raw q and do (56
// rows); raw k and v (80 rows); a ring of two stages of lse and D (56)
constexpr size_t kKVSmem = 4 * kFragT * 16 + (2 * kColT + 2 * kRowT + 4 * kCols) * sizeof(float);

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const float* o;
  const float* dout;
  const float* lse;   // (Bw, heads, N)
  const float* bias;  // (heads, N, N)
  const float* mask;  // (nW, N, N) or null
  const int* flags;   // (nW,) or null
  float* dq;
  float* dk;
  float* dv;
  float* dsum;        // D (Bw, heads, N): written by launch 1, read by launch 2
  float* part;        // (bp, heads, N, N)
  int bw, nw, heads, n, nt, bp;  // nt: tiles of 80 rows
  float scale;
};

__device__ __forceinline__ bool masked(const Params& p, int wi) {
  return p.mask != nullptr && (p.flags == nullptr || p.flags[wi] != 0);
}

__global__ void __launch_bounds__(kThreads, 2) window_attn_bwd_q_f32_kernel(const Params p) {
  extern __shared__ __align__(16) uint4 smem4[];
  uint4* fkt = smem4;         // k, NT (S = q k^T)
  uint4* fkn = fkt + kFragT;  // k, NN (dq = dS k)
  uint4* fvt = fkn + kFragT;  // v, NT (dP = do v^T)
  float* kraw = reinterpret_cast<float*>(fvt + kFragT);
  float* vraw = kraw + kColT;
  float* ring = vraw + kColT;
  const int warp = threadIdx.x / 32, g = lane_g(), t = lane_t(), n = p.n;
  const int qt = blockIdx.y % p.nt, h = blockIdx.y / p.nt;
  const int row0 = qt * kRows, r0 = row0 + 16 * warp;  // r0: this warp's first row
  const int ra = r0 + g, rb = ra + 8;                  // this thread's rows
  const bool active = r0 < n;
  const int nwb = (p.bw - 1 - static_cast<int>(blockIdx.x)) / p.bp + 1;  // the block's windows
  const int total = (n + kCols - 1) / kCols * nwb;  // (key tile, window) steps
  const float* bias = p.bias + static_cast<size_t>(h) * n * n;
  auto win_of = [&](int wi) { return static_cast<int>(blockIdx.x) + wi * p.bp; };
  auto head_of = [&](int wi) {  // row 0 of window wi's head h
    return (static_cast<size_t>(win_of(wi)) * p.heads + h) * n;
  };
  auto stage = [&](int it) {
    float* s = ring + (it % 2) * kQStage;
    const int kt = (it / nwb) * kCols;
    const size_t head = head_of(it % nwb);
    stage_rows(s, p.q + head * kHD, kHD, row0, kRows, n, kThreads);
    stage_rows(s + kRowT, p.dout + head * kHD, kHD, row0, kRows, n, kThreads);
    for (int i = threadIdx.x; i < kRows; i += kThreads)
      cp_async4(s + 2 * kRowT + i, p.lse + head + min(row0 + i, n - 1), row0 + i < n);
    stage_rows(kraw, p.k + head * kHD, kHD, kt, kCols, n, kThreads);
    stage_rows(vraw, p.v + head * kHD, kHD, kt, kCols, n, kThreads);
  };

  float db[kNT][4];  // the key tile's dbias at this thread's places, across the windows
  zero(db);
  stage(0);
  f32mma::cp_commit();
  for (int it = 0; it < total; ++it) {
    const int kti = it / nwb, wi = it % nwb, k0 = kti * kCols;
    const int knt = (min(kCols, n - k0) + 7) / 8;  // n-tiles of real keys
    const size_t head = head_of(wi);
    // S starts from the bias (read before the wait, so that its latency
    // hides behind it)
    float sc[kNT][4];
    float4 o4[4] = {};  // o[ra][8 t ..), o[rb][8 t ..): D at the first key tile
    float da = 0.f, dd = 0.f;  // D of rows ra and rb
    if (active) {
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = e < 2 ? ra : rb, key = k0 + 8 * j + 2 * t + (e & 1);
          sc[j][e] = row < n && key < n ? __ldg(bias + static_cast<size_t>(row) * n + key) : 0.f;
        }
      if (kti == 0) {
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          if (ra < n) o4[x] = __ldg(reinterpret_cast<const float4*>(p.o + (head + ra) * kHD + 8 * t) + x);
          if (rb < n) o4[2 + x] = __ldg(reinterpret_cast<const float4*>(p.o + (head + rb) * kHD + 8 * t) + x);
        }
      } else {  // written at the first key tile by lane t = 0 of this group
        da = ra < n ? p.dsum[head + ra] : 0.f;
        dd = rb < n ? p.dsum[head + rb] : 0.f;
      }
    }
    f32mma::cp_wait<0>();  // step `it`'s tiles have landed (for this thread)
    __syncthreads();       // ... for every thread; the fragment tiles are free
    build_frags(fkt, fkn, kraw, kCols, 1.f, kThreads);
    build_frags(fvt, nullptr, vraw, kCols, 1.f, kThreads);
    __syncthreads();  // the fragment tiles are built; raw k and v are free
    if (it + 1 < total) stage(it + 1);
    f32mma::cp_commit();
    if (!active) continue;
    const float* s = ring + (it % 2) * kQStage;
    const float* qs = s + 16 * warp * kLd;
    const float* dos = s + kRowT + 16 * warp * kLd;
    const float* ls = s + 2 * kRowT + 16 * warp;
    if (kti == 0) {
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const float4 u = *reinterpret_cast<const float4*>(dos + g * kLd + 8 * t + 4 * x);
        const float4 w = *reinterpret_cast<const float4*>(dos + (g + 8) * kLd + 8 * t + 4 * x);
        da = fmaf(u.x, o4[x].x, fmaf(u.y, o4[x].y, fmaf(u.z, o4[x].z, fmaf(u.w, o4[x].w, da))));
        dd = fmaf(w.x, o4[2 + x].x,
                  fmaf(w.y, o4[2 + x].y, fmaf(w.z, o4[2 + x].z, fmaf(w.w, o4[2 + x].w, dd))));
      }
      da += __shfl_xor_sync(0xffffffffu, da, 1);
      da += __shfl_xor_sync(0xffffffffu, da, 2);
      dd += __shfl_xor_sync(0xffffffffu, dd, 1);
      dd += __shfl_xor_sync(0xffffffffu, dd, 2);
      if (t == 0) {
        if (ra < n) p.dsum[head + ra] = da;
        if (rb < n) p.dsum[head + rb] = dd;
      }
    }
    // S = bias + (q scale) k^T and dP = do v^T: the warp's 16 rows x 56
    // keys, two n-tiles of each at a time, pass by pass
    float dp[kNT][4];
    zero(dp);
#pragma unroll
    for (int kk = 0; kk < kHD / 8; ++kk) {
      const Frag4 aq = frag_a(qs, 8 * kk, p.scale), ad = frag_a(dos, 8 * kk);
#pragma unroll
      for (int j0 = 0; j0 < kNT; j0 += 2) {
        const int j1 = min(j0 + 1, kNT - 1);
        const bool v0 = j0 < knt, v1 = j0 + 1 < kNT && j0 + 1 < knt;
        Frag2 bk0 = {}, bv0 = {}, bk1 = {}, bv1 = {};
        if (v0) bk0 = frag_b(fkt, j0, kk), bv0 = frag_b(fvt, j0, kk);
        if (v1) bk1 = frag_b(fkt, j1, kk), bv1 = frag_b(fvt, j1, kk);
        if (v0) mma_tf32(sc[j0], aq.lo, bk0.hi), mma_tf32(dp[j0], ad.lo, bv0.hi);
        if (v1) mma_tf32(sc[j1], aq.lo, bk1.hi), mma_tf32(dp[j1], ad.lo, bv1.hi);
        if (v0) mma_tf32(sc[j0], aq.hi, bk0.lo), mma_tf32(dp[j0], ad.hi, bv0.lo);
        if (v1) mma_tf32(sc[j1], aq.hi, bk1.lo), mma_tf32(dp[j1], ad.hi, bv1.lo);
        if (v0) mma_tf32(sc[j0], aq.hi, bk0.hi), mma_tf32(dp[j0], ad.hi, bv0.hi);
        if (v1) mma_tf32(sc[j1], aq.hi, bk1.hi), mma_tf32(dp[j1], ad.hi, bv1.hi);
      }
    }
    // dS = P (dP - D) into sc, dbias += dS
    const int wm = win_of(wi) % p.nw;
    const float* mask = masked(p, wm) ? p.mask + static_cast<size_t>(wm) * n * n : nullptr;
    const float la = ls[g], lb = ls[g + 8];
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? ra : rb, key = k0 + 8 * j + 2 * t + (e & 1);
        float ds = 0.f;
        if (j < knt && row < n && key < n) {
          float sv = sc[j][e];
          if (mask != nullptr) sv += __ldg(mask + static_cast<size_t>(row) * n + key);
          ds = expf(sv - (e < 2 ? la : lb)) * (dp[j][e] - (e < 2 ? da : dd));
        }
        db[j][e] += ds;
        sc[j][e] = ds;
      }
    // the rows' dq so far (this thread's own writes at the earlier key
    // tiles), read before the products that add to it
    float2 old[4][2] = {};
    if (kti > 0) {
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int row = x == 0 ? ra : rb;
          if (row < n)
            old[c][x] = *reinterpret_cast<const float2*>(p.dq + (head + row) * kHD + 8 * c + 2 * t);
        }
    }
    // dq = dS k over the tile's keys (56 deep), pass by pass over the four
    // output n-tiles
    float dq[4][4];
    zero(dq);
#pragma unroll
    for (int j = 0; j < kNT; ++j)
      if (j < knt) {
        const Frag4 a = frag_c2a(sc[j]);
        Frag2 b[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) b[c] = frag_b(fkn, j, c);
#pragma unroll
        for (int c = 0; c < 4; ++c) mma_tf32(dq[c], a.lo, b[c].hi);
#pragma unroll
        for (int c = 0; c < 4; ++c) mma_tf32(dq[c], a.hi, b[c].lo);
#pragma unroll
        for (int c = 0; c < 4; ++c) mma_tf32(dq[c], a.hi, b[c].hi);
      }
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int row = x == 0 ? ra : rb;
        if (row < n)
          *reinterpret_cast<float2*>(p.dq + (head + row) * kHD + 8 * c + 2 * t) =
              make_float2(old[c][x].x + dq[c][2 * x] * p.scale,
                          old[c][x].y + dq[c][2 * x + 1] * p.scale);
      }
    if (wi == nwb - 1) {  // the key tile's last window: its dbias into partial b
      float* dst = p.part + (static_cast<size_t>(blockIdx.x) * p.heads + h) * n * n;
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = e < 2 ? ra : rb, key = k0 + 8 * j + 2 * t + (e & 1);
          if (row < n && key < n) dst[static_cast<size_t>(row) * n + key] = db[j][e];
          db[j][e] = 0.f;
        }
    }
  }
  f32mma::cp_wait<0>();
}

__global__ void __launch_bounds__(kThreads, 2) window_attn_bwd_kv_f32_kernel(const Params p) {
  extern __shared__ __align__(16) uint4 smem4[];
  uint4* fqt = smem4;         // q scale, NT (S^T = k (q scale)^T)
  uint4* fqn = fqt + kFragT;  // q scale, NN (dk = dS^T (q scale))
  uint4* fdt = fqn + kFragT;  // do, NT (dP^T = v do^T)
  uint4* fdn = fdt + kFragT;  // do, NN (dv = P^T do)
  float* qraw = reinterpret_cast<float*>(fdn + kFragT);
  float* doraw = qraw + kColT;
  float* kraw = doraw + kColT;  // the block's 80 keys
  float* vraw = kraw + kRowT;
  float* ring = vraw + kRowT;  // two stages of lse and D of 56 queries
  const int warp = threadIdx.x / 32, g = lane_g(), t = lane_t(), n = p.n;
  const int kt = blockIdx.x % p.nt, unit = blockIdx.x / p.nt;  // unit = win heads + h
  const int h = unit % p.heads, win = unit / p.heads;
  const int k0 = kt * kRows, r0 = k0 + 16 * warp;  // r0: this warp's first key
  const int ka = r0 + g, kb = ka + 8;              // this thread's keys
  const bool active = r0 < n;
  const size_t head = static_cast<size_t>(unit) * n;
  const int wm = win % p.nw;
  const float* mask = masked(p, wm) ? p.mask + static_cast<size_t>(wm) * n * n : nullptr;
  const float* bias = p.bias + static_cast<size_t>(h) * n * n;
  const int nqt = (n + kCols - 1) / kCols;
  auto stage = [&](int i) {
    const int q0 = i * kCols;
    stage_rows(qraw, p.q + head * kHD, kHD, q0, kCols, n, kThreads);
    stage_rows(doraw, p.dout + head * kHD, kHD, q0, kCols, n, kThreads);
    float* s = ring + (i % 2) * 2 * kCols;
    for (int x = threadIdx.x; x < 2 * kCols; x += kThreads) {
      const int r = x % kCols;
      const size_t at = head + min(q0 + r, n - 1);
      cp_async4(s + x, x < kCols ? p.lse + at : p.dsum + at, q0 + r < n);
    }
  };
  stage_rows(kraw, p.k + head * kHD, kHD, k0, kRows, n, kThreads);
  stage_rows(vraw, p.v + head * kHD, kHD, k0, kRows, n, kThreads);
  stage(0);
  f32mma::cp_commit();
  float dk[4][4], dv[4][4];
  zero(dk);
  zero(dv);
  for (int i = 0; i < nqt; ++i) {
    const int q0 = i * kCols, qnt = (min(kCols, n - q0) + 7) / 8;
    f32mma::cp_wait<0>();  // query tile i has landed (for this thread)
    __syncthreads();       // ... for every thread; the fragment tiles are free
    build_frags(fqt, fqn, qraw, kCols, p.scale, kThreads);
    build_frags(fdt, fdn, doraw, kCols, 1.f, kThreads);
    __syncthreads();  // the fragment tiles are built; raw q and do are free
    if (i + 1 < nqt) stage(i + 1);
    f32mma::cp_commit();
    if (!active) continue;
    const float* ls = ring + (i % 2) * 2 * kCols;
    const float* dsm = ls + kCols;
    // S^T = k (q scale)^T and dP^T = v do^T: the warp's 16 keys x 56
    // queries, two n-tiles of each at a time, pass by pass
    float st[kNT][4], dpt[kNT][4];
    zero(st);
    zero(dpt);
#pragma unroll
    for (int kk = 0; kk < kHD / 8; ++kk) {
      const Frag4 ak = frag_a(kraw + 16 * warp * kLd, 8 * kk);
      const Frag4 av = frag_a(vraw + 16 * warp * kLd, 8 * kk);
#pragma unroll
      for (int j0 = 0; j0 < kNT; j0 += 2) {
        const int j1 = min(j0 + 1, kNT - 1);
        const bool v0 = j0 < qnt, v1 = j0 + 1 < kNT && j0 + 1 < qnt;
        Frag2 bq0 = {}, bd0 = {}, bq1 = {}, bd1 = {};
        if (v0) bq0 = frag_b(fqt, j0, kk), bd0 = frag_b(fdt, j0, kk);
        if (v1) bq1 = frag_b(fqt, j1, kk), bd1 = frag_b(fdt, j1, kk);
        if (v0) mma_tf32(st[j0], ak.lo, bq0.hi), mma_tf32(dpt[j0], av.lo, bd0.hi);
        if (v1) mma_tf32(st[j1], ak.lo, bq1.hi), mma_tf32(dpt[j1], av.lo, bd1.hi);
        if (v0) mma_tf32(st[j0], ak.hi, bq0.lo), mma_tf32(dpt[j0], av.hi, bd0.lo);
        if (v1) mma_tf32(st[j1], ak.hi, bq1.lo), mma_tf32(dpt[j1], av.hi, bd1.lo);
        if (v0) mma_tf32(st[j0], ak.hi, bq0.hi), mma_tf32(dpt[j0], av.hi, bd0.hi);
        if (v1) mma_tf32(st[j1], ak.hi, bq1.hi), mma_tf32(dpt[j1], av.hi, bd1.hi);
      }
    }
    // P^T into st, dS^T into dpt
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = e < 2 ? ka : kb, ql = 8 * j + 2 * t + (e & 1), qr = q0 + ql;
        float pr = 0.f, ds = 0.f;
        if (j < qnt && key < n && qr < n) {
          const size_t off = static_cast<size_t>(qr) * n + key;
          float sv = st[j][e] + __ldg(bias + off);
          if (mask != nullptr) sv += __ldg(mask + off);
          pr = expf(sv - ls[ql]);
          ds = pr * (dpt[j][e] - dsm[ql]);
        }
        st[j][e] = pr;
        dpt[j][e] = ds;
      }
    // dv += P^T do, then dk += dS^T (q scale): each over the tile's queries
    // (56 deep) into a zeroed part, pass by pass over the four n-tiles
    float part[4][4];
#pragma unroll
    for (int which = 0; which < 2; ++which) {
      zero(part);
#pragma unroll
      for (int j = 0; j < kNT; ++j)
        if (j < qnt) {
          const Frag4 a = frag_c2a(which == 0 ? st[j] : dpt[j]);
          const uint4* f = which == 0 ? fdn : fqn;
          Frag2 b[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) b[c] = frag_b(f, j, c);
#pragma unroll
          for (int c = 0; c < 4; ++c) mma_tf32(part[c], a.lo, b[c].hi);
#pragma unroll
          for (int c = 0; c < 4; ++c) mma_tf32(part[c], a.hi, b[c].lo);
#pragma unroll
          for (int c = 0; c < 4; ++c) mma_tf32(part[c], a.hi, b[c].hi);
        }
      add(which == 0 ? dv : dk, part);
    }
  }
  f32mma::cp_wait<0>();
  if (!active) return;
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int key = x == 0 ? ka : kb;
      if (key < n) {
        const size_t at = (head + key) * kHD + 8 * c + 2 * t;
        *reinterpret_cast<float2*>(p.dk + at) = make_float2(dk[c][2 * x], dk[c][2 * x + 1]);
        *reinterpret_cast<float2*>(p.dv + at) = make_float2(dv[c][2 * x], dv[c][2 * x + 1]);
      }
    }
}

inline bool aligned(const void* ptr) {
  return ptr == nullptr || reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

inline bool bad_args(int Bw, int nW, int heads, int n) {
  return n < 1 || n > kNMax || heads < 1 || Bw < 1 || nW < 1 || Bw % nW != 0;
}

}  // namespace k9f32
}  // namespace lavt

// K9 f32's launch 1: q, k, v, o, dout (Bw, heads, N, 32) f32 contiguous, lse
// (Bw, heads, N) f32, bias (heads, N, N) f32, mask (nW, N, N) f32 or null with
// its window flags (nW,) int32 or null; writes dq (Bw, heads, N, 32), dsum
// (Bw, heads, N) = rowsum(dout o) and the dbias partials (bp, heads, N, N):
// partial b from the windows b, b + bp, ... (ops/window_attn.k9_f32_plan).
extern "C" int lavt_window_attn_bwd_q_f32(const void* q, const void* k, const void* v,
                                          const void* o, const void* dout, const void* lse,
                                          const void* bias, const void* mask, const void* flags,
                                          void* dq, void* dsum, void* dbias_part, int Bw, int nW,
                                          int heads, int n, int bp, float scale, void* stream) {
  using namespace lavt::k9f32;
  if (bad_args(Bw, nW, heads, n) || bp < 1 || bp > Bw || !aligned(q) || !aligned(k) ||
      !aligned(v) || !aligned(o) || !aligned(dout) || !aligned(dq))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.q = static_cast<const float*>(q), p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v), p.o = static_cast<const float*>(o);
  p.dout = static_cast<const float*>(dout), p.lse = static_cast<const float*>(lse);
  p.bias = static_cast<const float*>(bias), p.mask = static_cast<const float*>(mask);
  p.flags = static_cast<const int*>(flags);
  p.dq = static_cast<float*>(dq), p.dsum = static_cast<float*>(dsum);
  p.part = static_cast<float*>(dbias_part);
  p.bw = Bw, p.nw = nW, p.heads = heads, p.n = n, p.nt = (n + kRows - 1) / kRows, p.bp = bp;
  p.scale = scale;
  // the shared-memory limit of the current device (cheap: set on every call)
  const cudaError_t err = lavt::allow_smem(window_attn_bwd_q_f32_kernel, kQSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  window_attn_bwd_q_f32_kernel<<<dim3(bp, p.nt * heads), kThreads, kQSmem,
                                 static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// K9 f32's launch 2: q, k, v, dout as launch 1 takes them, lse and launch
// 1's dsum (Bw, heads, N), the bias, mask and flags as launch 1; writes dk
// and dv (Bw, heads, N, 32) f32.  One block per (window, head, key tile).
extern "C" int lavt_window_attn_bwd_kv_f32(const void* q, const void* k, const void* v,
                                           const void* dout, const void* lse, const void* dsum,
                                           const void* bias, const void* mask, const void* flags,
                                           void* dk, void* dv, int Bw, int nW, int heads, int n,
                                           float scale, void* stream) {
  using namespace lavt::k9f32;
  if (bad_args(Bw, nW, heads, n) || !aligned(q) || !aligned(k) || !aligned(v) ||
      !aligned(dout) || !aligned(dk) || !aligned(dv))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.q = static_cast<const float*>(q), p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v), p.dout = static_cast<const float*>(dout);
  p.lse = static_cast<const float*>(lse), p.dsum = const_cast<float*>(static_cast<const float*>(dsum));
  p.bias = static_cast<const float*>(bias), p.mask = static_cast<const float*>(mask);
  p.flags = static_cast<const int*>(flags);
  p.dk = static_cast<float*>(dk), p.dv = static_cast<float*>(dv);
  p.bw = Bw, p.nw = nW, p.heads = heads, p.n = n, p.nt = (n + kRows - 1) / kRows, p.bp = 1;
  p.scale = scale;
  const long long blocks = static_cast<long long>(Bw) * heads * p.nt;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = lavt::allow_smem(window_attn_bwd_kv_f32_kernel, kKVSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  window_attn_bwd_kv_f32_kernel<<<static_cast<unsigned>(blocks), kThreads, kKVSmem,
                                  static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
