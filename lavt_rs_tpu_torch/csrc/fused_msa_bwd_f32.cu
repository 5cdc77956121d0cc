// K5 f32's attention launch: the attention backward of the fused window MSA
// from the save mode f32's residuals (csrc/fused_msa_f32.cu), on f32
// activations.  K5 f32 runs it between the dattn and dx products on the
// 3xTF32 tile loop (lavt_dgrad_f32, csrc/fused_mlp_bwd_f32.cu); K6 f32 runs
// the save mode f32's launches first.
//
// Replaces the attention part of lavt_rs_tpu/ops/pallas/fused_msa.py:
// _bwd_kernel_resid (K5, :323) and _bwd_kernel (K6, :176) as the TPU
// kernels compute it on f32 inputs (their roundings to x.dtype are
// no-ops).  Per window and head (N = 144, hd = 32), from the saved q
// (post-scale), k, v (column views of the (B nW 144, 3C) qkv tensor, rows
// `ld` floats apart), the saved probabilities P (B nW, heads, 144, 144) and
// dattn = gy Wproj (B nW 144, C):
//   o = P v,  D = rowsum(do o)                      (o feeds dWproj)
//   dP = do v^T,  dS = P (dP - D)
//   dq = dS k scale,  dk = dS^T q,  dv = P^T do      (into dqkv, B nW 144, 3C)
//   dbias[h] = the sum over windows of dS, as per-group partials
// (D = rowsum(do o) equals the TPU kernel's rowsum(dP P).)  bias and mask
// are not read: P carries them, and the mask gets no cotangent.
//
// Bound on the H100: bytes or operations.  Five N x N x hd products (10 N^2
// hd flops) per window and head against P (read once), q, k, v, dattn, o
// and dqkv: Swin-B stage 2 at bs 8 (200 windows x 8 heads) 2.65 GFLOP
// (0.016 ms at 165 TFLOP/s = 495 TF32 over the three products of 3xTF32)
// against 133 MB of P and 37 MB of the rest: bytes, 0.051 ms.
//
// Design: one launch, a block of 9 warps per (group, head) that takes the
// windows g, g + groups, ... whole, every product in 3xTF32 on
// mma.sync.m16n8k8 (csrc/attn_tf32.cuh).  A window's q, k, v and do (144
// rows each) are staged raw by cp.async, the next window's loading while
// this one computes (v in a ring of two; k, q and do as soon as their
// fragment tiles are built); the B operands are split into three fragment
// tiles (one 16-byte load a fragment), rebuilt between the two phases; P
// is read from device memory at the fragments' places (the permuted order
// csrc/attn_tf32.cuh reads A in), once from DRAM and twice more from L2
// within the window's turn.  Per window:
//   A. fragment tiles v NN, v NT, k NN.  Warp w owns query rows 16 w ..:
//      o = P v, o written, D = rowsum(do o) (four lanes a row) into shared
//      memory; then in chunks of 24 keys dP = do v^T, dS = P (dP - D),
//      dbias += dS (the warp's 16 x 144 block, 72 registers a thread, held
//      across the block's windows: partial g, written once, no atomics;
//      held instead in device memory, read and written back each window,
//      it ran 1.2x slower on an H100), dq += dS k; dq scale written.
//   B. fragment tiles do NT, do NN, q NN.  Warp w owns keys 16 w ..: in
//      chunks of 24 queries P^T read, dP^T = v do^T and dS^T = P^T (dP^T -
//      D) (dP recomputed: 6 products, not 5, instead of a trip of dS
//      through memory), dv += P^T do, dk += dS^T q; both written.
// Each product issues pass by pass over its independent accumulators.  The
// dbias partials are added by lavt_sum_partials and dbqkv by the column
// sums of dqkv (lavt_colsum_f32, csrc/fused_msa_bwd.cu), each in a fixed
// order: the same inputs give the same bits.  Dynamic shared memory 209.8
// KB, one block an SM.  (The design before: FFMA on 64 x 64 tiles in three
// launches, P read three times from DRAM: PERF.md.)

#include <cstdint>

#include "attn_tf32.cuh"

namespace lavt {
namespace k5f32 {

using namespace tf32attn;

constexpr int kN = 144, kNT = kN / 8;                    // 18 n-tiles of 8
constexpr int kWarps = kN / 16, kThreads = 32 * kWarps;  // 9 warps of 16 rows
constexpr int kCh = 3, kChunks = kNT / kCh;              // chunks of 24 keys / queries
constexpr int kTile = kN * kLd;                          // floats of a raw 144-row tile
constexpr int kFragT = frag_tile_bytes(kN) / 16;         // 16-byte words of a fragment tile
// three fragment tiles; raw q, k and do; raw v in a ring of two; D
constexpr size_t kSmem = 3 * kFragT * 16 + (5 * kTile + kN) * sizeof(float);

struct Params {
  const float* dattn;  // (m 144, C): do, heads' columns 32 h ..
  const float* q;      // row (w 144 + i) at q + (w 144 + i) ld, head h at + 32 h
  const float* k;
  const float* v;
  const float* p;      // (m, heads, 144, 144)
  float* o;            // (m 144, C)
  float* dqkv;         // (m 144, 3C)
  float* part;         // (groups, heads, 144, 144)
  int m, c, ld, heads, groups;
  float scale;
};

// d[c] += a b[c] for the four n-tiles c, pass by pass
__device__ __forceinline__ void mma_row(float (&d)[4][4], const Frag4& a, const uint4* tile,
                                        int r) {
  Frag2 b[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) b[c] = frag_b(tile, r, c);
#pragma unroll
  for (int c = 0; c < 4; ++c) mma_tf32(d[c], a.lo, b[c].hi);
#pragma unroll
  for (int c = 0; c < 4; ++c) mma_tf32(d[c], a.hi, b[c].lo);
#pragma unroll
  for (int c = 0; c < 4; ++c) mma_tf32(d[c], a.hi, b[c].hi);
}

// d[jj] += a_kk b(r0 + jj, kk) over the depth blocks kk of an A tile (the
// warp's 16 rows of a raw tile) and kCh row blocks of an NT fragment tile,
// pass by pass over the kCh accumulators
__device__ __forceinline__ void mma_nt_chunk(float (&d)[kCh][4], const float* a_rows,
                                             const uint4* tile, int r0) {
#pragma unroll
  for (int kk = 0; kk < kHD / 8; ++kk) {
    const Frag4 a = frag_a(a_rows, 8 * kk);
    Frag2 b[kCh];
#pragma unroll
    for (int jj = 0; jj < kCh; ++jj) b[jj] = frag_b(tile, r0 + jj, kk);
#pragma unroll
    for (int jj = 0; jj < kCh; ++jj) mma_tf32(d[jj], a.lo, b[jj].hi);
#pragma unroll
    for (int jj = 0; jj < kCh; ++jj) mma_tf32(d[jj], a.hi, b[jj].lo);
#pragma unroll
    for (int jj = 0; jj < kCh; ++jj) mma_tf32(d[jj], a.hi, b[jj].hi);
  }
}

__global__ void __launch_bounds__(kThreads, 1) msa_bwd_attn_f32_kernel(const Params p) {
  extern __shared__ __align__(16) uint4 smem4[];
  uint4* f0 = smem4;  // A: v NN (o = P v);    B: do NT (dP^T = v do^T)
  uint4* f1 = f0 + kFragT;  // A: v NT (dP = do v^T); B: do NN (dv = P^T do)
  uint4* f2 = f1 + kFragT;  // A: k NN (dq = dS k);   B: q NN (dk = dS^T q)
  float* qraw = reinterpret_cast<float*>(f2 + kFragT);
  float* kraw = qraw + kTile;
  float* doraw = kraw + kTile;
  float* vring = doraw + kTile;
  float* dsm = vring + 2 * kTile;  // D of the window's rows
  const int warp = threadIdx.x / 32, g = lane_g(), t = lane_t();
  const int h = blockIdx.y;
  const int r0 = 16 * warp, ra = r0 + g, rb = ra + 8;  // the warp's rows (A: queries, B: keys)
  const size_t ld3 = 3 * static_cast<size_t>(p.c);
  auto rows_of = [&](const float* x, int w) {  // row 0 of window w's head h in q, k or v
    return x + static_cast<size_t>(w) * kN * p.ld + h * kHD;
  };
  auto do_of = [&](int w) { return p.dattn + static_cast<size_t>(w) * kN * p.c + h * kHD; };

  float db[kNT][4];  // dbias of rows ra, rb over every key, across the windows
  zero(db);
  {
    const int w = blockIdx.x;
    stage_rows(qraw, rows_of(p.q, w), p.ld, 0, kN, kN, kThreads);
    stage_rows(kraw, rows_of(p.k, w), p.ld, 0, kN, kN, kThreads);
    stage_rows(doraw, do_of(w), p.c, 0, kN, kN, kThreads);
    stage_rows(vring, rows_of(p.v, w), p.ld, 0, kN, kN, kThreads);
    f32mma::cp_commit();
  }
  int slot = 0;
  for (int w = blockIdx.x; w < p.m; w += p.groups, slot ^= 1) {
    const int wn = w + p.groups;  // the next window, if < m
    const float* vraw = vring + slot * kTile;
    f32mma::cp_wait<0>();  // the window's tiles have landed (for this thread)
    __syncthreads();       // ... for every thread; the fragment tiles are free
    build_frags(f1, f0, vraw, kN, 1.f, kThreads);
    build_frags(nullptr, f2, kraw, kN, 1.f, kThreads);
    __syncthreads();  // raw k is free
    if (wn < p.m) {
      stage_rows(kraw, rows_of(p.k, wn), p.ld, 0, kN, kN, kThreads);
      stage_rows(vring + (slot ^ 1) * kTile, rows_of(p.v, wn), p.ld, 0, kN, kN, kThreads);
    }
    f32mma::cp_commit();
    const float* ph = p.p + (static_cast<size_t>(w) * p.heads + h) * kN * kN;
    const size_t row0 = static_cast<size_t>(w) * kN;  // the window's first row

    // A. rows ra, rb are queries.  o = P v: P read a key block ahead.
    float o[4][4];
    zero(o);
    float2 xa = __ldg(reinterpret_cast<const float2*>(ph + ra * kN + 2 * t));
    float2 xb = __ldg(reinterpret_cast<const float2*>(ph + rb * kN + 2 * t));
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const float c[4] = {xa.x, xa.y, xb.x, xb.y};
      if (j + 1 < kNT) {
        xa = __ldg(reinterpret_cast<const float2*>(ph + ra * kN + 8 * (j + 1) + 2 * t));
        xb = __ldg(reinterpret_cast<const float2*>(ph + rb * kN + 8 * (j + 1) + 2 * t));
      }
      mma_row(o, frag_c2a(c), f0, j);
    }
    float da = 0.f, dd = 0.f;  // D of rows ra, rb
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = 8 * c + 2 * t;
      const size_t oa = (row0 + ra) * p.c + h * kHD + col, ob = (row0 + rb) * p.c + h * kHD + col;
      *reinterpret_cast<float2*>(p.o + oa) = make_float2(o[c][0], o[c][1]);
      *reinterpret_cast<float2*>(p.o + ob) = make_float2(o[c][2], o[c][3]);
      const float2 ga = *reinterpret_cast<const float2*>(doraw + ra * kLd + col);
      const float2 gb = *reinterpret_cast<const float2*>(doraw + rb * kLd + col);
      da = fmaf(ga.x, o[c][0], fmaf(ga.y, o[c][1], da));
      dd = fmaf(gb.x, o[c][2], fmaf(gb.y, o[c][3], dd));
    }
    da += __shfl_xor_sync(0xffffffffu, da, 1);
    da += __shfl_xor_sync(0xffffffffu, da, 2);
    dd += __shfl_xor_sync(0xffffffffu, dd, 1);
    dd += __shfl_xor_sync(0xffffffffu, dd, 2);
    if (t == 0) dsm[ra] = da, dsm[rb] = dd;

    // dP = do v^T, dS, dbias, dq = dS k: in chunks of 24 keys
    float dq[4][4];
    zero(dq);
#pragma unroll
    for (int ch = 0; ch < kChunks; ++ch) {
      float2 pa[kCh], pb[kCh];  // P at the chunk's C fragment places
#pragma unroll
      for (int jj = 0; jj < kCh; ++jj) {
        const int j = kCh * ch + jj;
        pa[jj] = __ldg(reinterpret_cast<const float2*>(ph + ra * kN + 8 * j + 2 * t));
        pb[jj] = __ldg(reinterpret_cast<const float2*>(ph + rb * kN + 8 * j + 2 * t));
      }
      float dp[kCh][4];
      zero(dp);
      mma_nt_chunk(dp, doraw + r0 * kLd, f1, kCh * ch);
#pragma unroll
      for (int jj = 0; jj < kCh; ++jj) {
        const int j = kCh * ch + jj;
        dp[jj][0] = pa[jj].x * (dp[jj][0] - da);
        dp[jj][1] = pa[jj].y * (dp[jj][1] - da);
        dp[jj][2] = pb[jj].x * (dp[jj][2] - dd);
        dp[jj][3] = pb[jj].y * (dp[jj][3] - dd);
#pragma unroll
        for (int e = 0; e < 4; ++e) db[j][e] += dp[jj][e];
        mma_row(dq, frag_c2a(dp[jj]), f2, j);
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const size_t col = h * kHD + 8 * c + 2 * t;
      *reinterpret_cast<float2*>(p.dqkv + (row0 + ra) * ld3 + col) =
          make_float2(dq[c][0] * p.scale, dq[c][1] * p.scale);
      *reinterpret_cast<float2*>(p.dqkv + (row0 + rb) * ld3 + col) =
          make_float2(dq[c][2] * p.scale, dq[c][3] * p.scale);
    }
    __syncthreads();  // D of every query; the fragment tiles are free
    build_frags(f0, f1, doraw, kN, 1.f, kThreads);
    build_frags(nullptr, f2, qraw, kN, 1.f, kThreads);
    __syncthreads();  // raw q and do are free
    if (wn < p.m) {
      stage_rows(qraw, rows_of(p.q, wn), p.ld, 0, kN, kN, kThreads);
      stage_rows(doraw, do_of(wn), p.c, 0, kN, kN, kThreads);
    }
    f32mma::cp_commit();

    // B. rows ra, rb are keys.  In chunks of 24 queries: P^T, dP^T = v do^T,
    // dS^T, dv += P^T do, dk += dS^T q.
    float dk[4][4], dv[4][4];
    zero(dk);
    zero(dv);
#pragma unroll
    for (int ch = 0; ch < kChunks; ++ch) {
      float pt[kCh][4];
#pragma unroll
      for (int jj = 0; jj < kCh; ++jj) {
        const int qr = 8 * (kCh * ch + jj) + 2 * t;  // the C fragment's queries qr, qr + 1
        pt[jj][0] = __ldg(ph + qr * kN + ra);
        pt[jj][1] = __ldg(ph + (qr + 1) * kN + ra);
        pt[jj][2] = __ldg(ph + qr * kN + rb);
        pt[jj][3] = __ldg(ph + (qr + 1) * kN + rb);
      }
      float dpt[kCh][4];
      zero(dpt);
      mma_nt_chunk(dpt, vraw + r0 * kLd, f0, kCh * ch);
#pragma unroll
      for (int jj = 0; jj < kCh; ++jj) {
        const int j = kCh * ch + jj, qr = 8 * j + 2 * t;
        const float d0 = dsm[qr], d1 = dsm[qr + 1];
        dpt[jj][0] = pt[jj][0] * (dpt[jj][0] - d0);
        dpt[jj][1] = pt[jj][1] * (dpt[jj][1] - d1);
        dpt[jj][2] = pt[jj][2] * (dpt[jj][2] - d0);
        dpt[jj][3] = pt[jj][3] * (dpt[jj][3] - d1);
        mma_row(dv, frag_c2a(pt[jj]), f1, j);
        mma_row(dk, frag_c2a(dpt[jj]), f2, j);
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const size_t col = h * kHD + 8 * c + 2 * t;
      float* ka_ = p.dqkv + (row0 + ra) * ld3 + col;
      float* kb_ = p.dqkv + (row0 + rb) * ld3 + col;
      *reinterpret_cast<float2*>(ka_ + p.c) = make_float2(dk[c][0], dk[c][1]);
      *reinterpret_cast<float2*>(kb_ + p.c) = make_float2(dk[c][2], dk[c][3]);
      *reinterpret_cast<float2*>(ka_ + 2 * p.c) = make_float2(dv[c][0], dv[c][1]);
      *reinterpret_cast<float2*>(kb_ + 2 * p.c) = make_float2(dv[c][2], dv[c][3]);
    }
  }
  f32mma::cp_wait<0>();
  float* dst = p.part + (static_cast<size_t>(blockIdx.x) * p.heads + h) * kN * kN;
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    *reinterpret_cast<float2*>(dst + ra * kN + 8 * j + 2 * t) = make_float2(db[j][0], db[j][1]);
    *reinterpret_cast<float2*>(dst + rb * kN + 8 * j + 2 * t) = make_float2(db[j][2], db[j][3]);
  }
}

inline bool aligned(const void* ptr) {
  return ptr != nullptr && reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

}  // namespace k5f32
}  // namespace lavt

// K5 f32's attention: dattn (m 144, C), q, k, v (m, 144, C) at row stride
// ld floats (the column views of the save mode's (m 144, 3C) qkv: ld = 3C),
// p (m, heads, 144, 144), all f32; writes o (m 144, C), dqkv (m 144, 3C) and
// the dbias partials (groups, heads, 144, 144), partial g from the windows
// g, g + groups, ... (ops/fused_msa.msa_bwd_f32_groups).  C = 32 heads.
// One launch on `stream`, a block per (group, head).
extern "C" int lavt_msa_bwd_attn_f32(const void* dattn, const void* q, const void* k,
                                     const void* v, const void* prob, void* o, void* dqkv,
                                     void* dbias_part, int m, int C, int ld, int heads,
                                     int groups, float scale, void* stream) {
  using namespace lavt::k5f32;
  if (m < 1 || heads < 1 || C != heads * kHD || ld < C || ld % 4 != 0 || groups < 1 ||
      groups > m || !aligned(dattn) || !aligned(q) || !aligned(k) || !aligned(v) ||
      !aligned(prob) || !aligned(o) || !aligned(dqkv) || !aligned(dbias_part))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.dattn = static_cast<const float*>(dattn);
  p.q = static_cast<const float*>(q), p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v), p.p = static_cast<const float*>(prob);
  p.o = static_cast<float*>(o), p.dqkv = static_cast<float*>(dqkv);
  p.part = static_cast<float*>(dbias_part);
  p.m = m, p.c = C, p.ld = ld, p.heads = heads, p.groups = groups, p.scale = scale;
  const cudaError_t err = lavt::allow_smem(msa_bwd_attn_f32_kernel, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  msa_bwd_attn_f32_kernel<<<dim3(groups, heads), kThreads, kSmem,
                            static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
