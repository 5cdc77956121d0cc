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
// windows x 3 heads, N = 392) 47.8 GFLOP (0.290 ms at 165 TFLOP/s, the f32
// rows' convention; 0.71 ms at the 67 TFLOP/s of the FP32 cores this
// kernel uses) against 401 MB (0.120 ms).
//
// Design: two launches and a sum (as the bf16 K9, csrc/window_attn_bwd_sm90.cu),
// FFMA on register-blocked tiles (csrc/attn_f32.cuh); dq sums over keys, dk
// and dv over queries and dbias over windows, so S and dP are computed in
// both launches (7 products, not 5).
//   1. window_attn_bwd_q_f32_kernel: grid (bp, query tiles x heads), 128
//      threads; block (b, (t, h)) takes the windows b, b + bp, ... of query
//      tile t (64 rows), head h.  Key tiles (64 keys) outermost, so each
//      thread keeps its 8 x 4 block of the tile's dbias in registers across
//      the block's windows.  Per (key tile, window) the block stages q
//      (scaled), do, k and v d-major and k row-major, D = rowsum(do o) and
//      lse of the 64 rows; then dP = do v^T (8 x 4 a thread, staged
//      row-major) and S = q k^T, P = exp(S + bias + mask - lse), dS = P (dP
//      - D) over dP, dbias += dS, and dq += dS k (4 x 4 a thread) written (the first
//      key tile) or added (the others) to the rows' dq, scaled; the first
//      key tile also writes D for launch 2.  After the windows each thread
//      writes its dbias block into partial b.
//   2. window_attn_bwd_kv_f32_kernel: a block of 128 threads per (window,
//      head, key tile); k and v staged d-major once; per query tile q
//      (scaled) and do d-major and row-major, lse and D; dP^T = v do^T and
//      S^T = k q^T (8 x 4 a thread, the keys as rows), P^T and dS^T, then
//      dv += P^T do and dk += dS^T q (4 x 4 a thread), P^T and dS^T staged
//      in turn in one row-major tile.
//   3. sum_partials (csrc/fused_msa_bwd.cu) adds the dbias partials in a
//      fixed order: the same inputs give the same bits (no float atomics).
// A window's mask is read only where `flags` marks it nonzero (every
// window's without flags); the bias and the mask are read from L2.
// Dynamic shared memory: 60.5 KB a block (launch 1), 69.5 KB (launch 2).
// (The first design, a thread per row with q, do and dq in registers and
// broadcast 16-byte loads, one per four FMAs, ran at 4.90 ms at video
// stage 2, slower than its plain version: see PERF.md.)

#include <cstdint>

#include "attn_f32.cuh"

namespace lavt {
namespace k9f32 {

using namespace attn32;

constexpr int kNMax = 400;
// launch 1: q, do, k, v d-major, k row-major, dS, D and lse of the rows
constexpr size_t kQSmem = (4 * kTileT + kTileR + kTileS + 2 * kT) * 4;
// launch 2: k, v, q, do d-major, q and do row-major, P^T / dS^T, lse, D
constexpr size_t kKVSmem = (4 * kTileT + 2 * kTileR + kTileS + 2 * kT) * 4;

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
  int bw, nw, heads, n, nt, bp;
  float scale;
};

__device__ __forceinline__ bool masked(const Params& p, int wi) {
  return p.mask != nullptr && (p.flags == nullptr || p.flags[wi] != 0);
}

__device__ __forceinline__ void zero(float (&a)[8][4]) {
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) a[r][c] = 0.f;
}

__device__ __forceinline__ void zero(float (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) a[i][j] = 0.f;
}

// two blocks an SM: at three (168 registers) it spilled and ran 1.3-1.5x
// slower at the video stages (one H100, PERF.md)
__global__ void __launch_bounds__(kThreads, 2) window_attn_bwd_q_f32_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                 // q (scaled), d-major
  float* ds_ = qs + kTileT;         // do, d-major
  float* ks = ds_ + kTileT;         // k, d-major
  float* vs = ks + kTileT;          // v, d-major
  float* kr = vs + kTileT;          // k, row-major
  float* dss = kr + kTileR;         // dS, row-major
  float* d_s = dss + kTileS;        // D of the rows
  float* l_s = d_s + kT;            // lse of the rows
  const int t = threadIdx.x, n = p.n;
  const int ty = t / 16, tx = t % 16, rg = t / 8, dg = t % 8;
  const int qt = blockIdx.y % p.nt, h = blockIdx.y / p.nt;
  const int row0 = qt * kT;
  const float* bias = p.bias + static_cast<size_t>(h) * n * n;
  for (int kt = 0; kt < n; kt += kT) {
    const int kn = min(kT, n - kt);
    float db[8][4];
    zero(db);
    for (int win = blockIdx.x; win < p.bw; win += p.bp) {
      const size_t head = (static_cast<size_t>(win) * p.heads + h) * n;  // row 0 of the head
      __syncthreads();  // the last window's readers are done
      load_t(qs, p.q + head * kHD, kHD, row0, n, p.scale);
      load_t(ds_, p.dout + head * kHD, kHD, row0, n);
      load_t(ks, p.k + head * kHD, kHD, kt, n);
      load_t(vs, p.v + head * kHD, kHD, kt, n);
      load_r(kr, p.k + head * kHD, kHD, kt, n);
      if (t < kT) {
        const int row = row0 + t;
        float dsum = 0.f, lse = 0.f;
        if (row < n) {
          const float4* a = reinterpret_cast<const float4*>(p.dout + (head + row) * kHD);
          const float4* b = reinterpret_cast<const float4*>(p.o + (head + row) * kHD);
#pragma unroll
          for (int c = 0; c < kHD / 4; ++c) {
            const float4 x = __ldg(a + c), y = __ldg(b + c);
            dsum = fmaf(x.x, y.x, fmaf(x.y, y.y, fmaf(x.z, y.z, fmaf(x.w, y.w, dsum))));
          }
          lse = __ldg(p.lse + head + row);
          if (kt == 0) p.dsum[head + row] = dsum;
        }
        d_s[t] = dsum, l_s[t] = lse;
      }
      __syncthreads();
      const int wi = win % p.nw;
      const float* mask = masked(p, wi) ? p.mask + static_cast<size_t>(wi) * n * n : nullptr;
      // dP = do v^T goes to dss first (each thread its own elements), so
      // that only one 8 x 4 product and the dbias block are live at once
      float acc[8][4];
      zero(acc);
      mma_nt(acc, ds_, vs, ty, tx);
      store_s(dss, acc, ty, tx);
      zero(acc);
      mma_nt(acc, qs, ks, ty, tx);
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int lr = s_row(ty, r), row = row0 + lr;
        const int rowc = min(row, n - 1);
        const float lse = l_s[lr], dsum = d_s[lr];
        float* dsr = dss + lr * kLd + 4 * tx;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = s_col(tx, c);
          float ds = 0.f;
          if (j < kn && row < n) {
            const size_t off = static_cast<size_t>(rowc) * n + kt + j;
            const float s = acc[r][c] + __ldg(bias + off) + (mask != nullptr ? __ldg(mask + off) : 0.f);
            ds = expf(s - lse) * (dsr[c] - dsum);
          }
          db[r][c] += ds;
          dsr[c] = ds;
        }
      }
      __syncthreads();
      float dq[4][4];
      zero(dq);
      mma_nn(dq, dss, kr, rg, dg, (kn + 3) / 4 * 4);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = row0 + rg + 16 * i;
        if (row < n) {
          float4* dst = reinterpret_cast<float4*>(p.dq + (head + row) * kHD + 4 * dg);
          float4 v4 = make_float4(dq[i][0] * p.scale, dq[i][1] * p.scale, dq[i][2] * p.scale,
                                  dq[i][3] * p.scale);
          if (kt > 0) {  // this thread wrote it at the last key tile
            const float4 old = *dst;
            v4.x += old.x, v4.y += old.y, v4.z += old.z, v4.w += old.w;
          }
          *dst = v4;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int row = row0 + s_row(ty, r);
      if (row < n) {
        float* dst = p.part + ((static_cast<size_t>(blockIdx.x) * p.heads + h) * n + row) * n + kt;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = s_col(tx, c);
          if (j < kn) dst[j] = db[r][c];
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 3) window_attn_bwd_kv_f32_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                 // k, d-major
  float* vs = ks + kTileT;          // v, d-major
  float* qs = vs + kTileT;          // q (scaled), d-major
  float* ds_ = qs + kTileT;         // do, d-major
  float* qr = ds_ + kTileT;         // q (scaled), row-major
  float* dr = qr + kTileR;          // do, row-major
  float* pt = dr + kTileR;          // P^T, then dS^T, row-major (keys x queries)
  float* l_s = pt + kTileS;         // lse of the queries
  float* d_s = l_s + kT;            // D of the queries
  const int t = threadIdx.x, n = p.n;
  const int ty = t / 16, tx = t % 16, rg = t / 8, dg = t % 8;
  const int kt = (blockIdx.x % p.nt) * kT, unit = blockIdx.x / p.nt;  // unit = win heads + h
  const int h = unit % p.heads, win = unit / p.heads;
  const size_t head = static_cast<size_t>(unit) * n;
  const int wi = win % p.nw;
  const float* mask = masked(p, wi) ? p.mask + static_cast<size_t>(wi) * n * n : nullptr;
  const float* bias = p.bias + static_cast<size_t>(h) * n * n;
  load_t(ks, p.k + head * kHD, kHD, kt, n);
  load_t(vs, p.v + head * kHD, kHD, kt, n);
  float dk[4][4], dv[4][4];
  zero(dk);
  zero(dv);
  for (int q0 = 0; q0 < n; q0 += kT) {
    const int qn = min(kT, n - q0);
    __syncthreads();  // the last query tile's readers are done
    load_t(qs, p.q + head * kHD, kHD, q0, n, p.scale);
    load_t(ds_, p.dout + head * kHD, kHD, q0, n);
    load_r(qr, p.q + head * kHD, kHD, q0, n, p.scale);
    load_r(dr, p.dout + head * kHD, kHD, q0, n);
    if (t < kT) {
      const bool ok = t < qn;
      l_s[t] = ok ? __ldg(p.lse + head + q0 + t) : 0.f;
      d_s[t] = ok ? p.dsum[head + q0 + t] : 0.f;
    }
    __syncthreads();
    float dpt[8][4], st[8][4];
    zero(dpt);
    mma_nt(dpt, vs, ds_, ty, tx);  // dP^T: keys x queries
    zero(st);
    mma_nt(st, ks, qs, ty, tx);    // S^T
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int key = kt + s_row(ty, r);
      const int keyc = min(key, n - 1);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = s_col(tx, c);
        float pr = 0.f;
        if (i < qn && key < n) {
          const size_t off = static_cast<size_t>(q0 + i) * n + keyc;
          const float s = st[r][c] + __ldg(bias + off) + (mask != nullptr ? __ldg(mask + off) : 0.f);
          pr = expf(s - l_s[i]);
        }
        st[r][c] = pr;
        dpt[r][c] = pr * (dpt[r][c] - d_s[i]);
      }
    }
    store_s(pt, st, ty, tx);
    __syncthreads();
    mma_nn(dv, pt, dr, rg, dg, (qn + 3) / 4 * 4);
    __syncthreads();  // P^T's readers are done
    store_s(pt, dpt, ty, tx);
    __syncthreads();
    mma_nn(dk, pt, qr, rg, dg, (qn + 3) / 4 * 4);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = kt + rg + 16 * i;
    if (key < n) {
      *reinterpret_cast<float4*>(p.dk + (head + key) * kHD + 4 * dg) =
          make_float4(dk[i][0], dk[i][1], dk[i][2], dk[i][3]);
      *reinterpret_cast<float4*>(p.dv + (head + key) * kHD + 4 * dg) =
          make_float4(dv[i][0], dv[i][1], dv[i][2], dv[i][3]);
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
  p.bw = Bw, p.nw = nW, p.heads = heads, p.n = n, p.nt = (n + kT - 1) / kT, p.bp = bp;
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
  p.bw = Bw, p.nw = nW, p.heads = heads, p.n = n, p.nt = (n + kT - 1) / kT, p.bp = 1;
  p.scale = scale;
  const long long blocks = static_cast<long long>(Bw) * heads * p.nt;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = lavt::allow_smem(window_attn_bwd_kv_f32_kernel, kKVSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  window_attn_bwd_kv_f32_kernel<<<static_cast<unsigned>(blocks), kThreads, kKVSmem,
                                  static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
