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
// (0.016 ms at 165 TFLOP/s; 0.040 ms at the 67 TFLOP/s of the FP32 cores
// this launch uses) against 133 MB of P and 37 MB of the rest: bytes,
// 0.051 ms.
//
// Design (simple and right first; K9 f32's, csrc/window_attn_bwd_f32.cu,
// with P read instead of recomputed from the lse), FFMA on the register-
// blocked 64 x 64 tiles of csrc/attn_f32.cuh, 128 threads a block, three
// launches in order:
//   0. msa_bwd_o_f32_kernel, a block per (window, head, query tile): o = P v
//      over the three key tiles (P staged row-major, v row-major), o
//      written, D = rowsum(do o) written for launches 1 and 2;
//   1. msa_bwd_q_f32_kernel, grid (bp, query tiles x heads): block (b, (t,
//      h)) takes the windows b, b + bp, ... of query tile t, head h.  Key
//      tiles outermost, so each thread keeps its 8 x 4 block of the tile's
//      dbias in registers across the block's windows (partial b, written
//      once: no atomics).  Per (key tile, window): do and v d-major, k
//      row-major, D; dP = do v^T (8 x 4 a thread), P read from memory by
//      float4 (a half-warp covers 256 contiguous bytes of a row), dS
//      staged row-major, dq += dS k (4 x 4 a thread) written (the first
//      key tile) or added (the others) to dqkv, times scale;
//   2. msa_bwd_kv_f32_kernel, a block per (window, head, key tile): v
//      d-major once; per query tile do d-major and row-major, q row-major,
//      D, and P^T staged by a transposing load (consecutive lanes on
//      consecutive query rows); dP^T = v do^T, dS^T = P^T (dP^T - D), dv
//      += P^T do and dk += dS^T q (4 x 4 a thread), P^T and dS^T in turn
//      in one tile.
// The dbias partials are added by lavt_sum_partials and dbqkv by the
// column sums of dqkv (lavt_colsum_f32, csrc/fused_msa_bwd.cu), each in a
// fixed order: the same inputs give the same bits.  P is read three times
// (one read each launch).  Static / dynamic shared memory: 26.0 KB (0),
// 43.3 KB (1), 52.3 KB (2); -Xptxas -v (CUDA 12.8, on an H100): 72, 155
// and 165 registers, 0 bytes spilled.

#include <cstdint>

#include "attn_f32.cuh"

namespace lavt {
namespace k5f32 {

using namespace attn32;

constexpr int kN = 144, kNT = (kN + kT - 1) / kT;  // 3 tiles of 64 (the last 16 real)
constexpr size_t kQSmem = (2 * kTileT + kTileR + kTileS + kT) * 4;
constexpr size_t kKVSmem = (2 * kTileT + 2 * kTileR + kTileS + kT) * 4;

struct Params {
  const float* dattn;  // (m 144, C): do, heads' columns 32 h ..
  const float* q;      // row (w 144 + i) at q + (w 144 + i) ld, head h at + 32 h
  const float* k;
  const float* v;
  const float* p;      // (m, heads, 144, 144)
  float* o;            // (m 144, C)
  float* dqkv;         // (m 144, 3C)
  float* dsum;         // D (m, heads, 144)
  float* part;         // (bp, heads, 144, 144)
  int m, c, ld, heads, bp;
  float scale;
};

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

// P[row0 : row0 + 64, col0 : col0 + 64] of one head (rows of 144 floats)
// into a row-major 64 x 64 tile, t[r kLd + c]; zeros past 144
__device__ __forceinline__ void load_p(float* dst, const float* ph, int row0, int col0) {
  for (int idx = threadIdx.x; idx < kT * kT / 4; idx += kThreads) {
    const int r = idx / (kT / 4), c = idx % (kT / 4);
    float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < kN && col0 + 4 * c < kN)
      t = __ldg(reinterpret_cast<const float4*>(ph + (row0 + r) * kN + col0 + 4 * c));
    *reinterpret_cast<float4*>(dst + r * kLd + 4 * c) = t;
  }
}

// the same block transposed, t[c kLd + r]: consecutive lanes take
// consecutive rows, so the transposed stores are conflict-free
__device__ __forceinline__ void load_pt(float* dst, const float* ph, int row0, int col0) {
  for (int idx = threadIdx.x; idx < kT * kT / 4; idx += kThreads) {
    const int r = idx % kT, c = idx / kT;
    float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < kN && col0 + 4 * c < kN)
      t = __ldg(reinterpret_cast<const float4*>(ph + (row0 + r) * kN + col0 + 4 * c));
    dst[(4 * c) * kLd + r] = t.x;
    dst[(4 * c + 1) * kLd + r] = t.y;
    dst[(4 * c + 2) * kLd + r] = t.z;
    dst[(4 * c + 3) * kLd + r] = t.w;
  }
}

// D of rows [row0, row0 + 64) (zeros past 144) into d_s, by threads < 64
__device__ __forceinline__ void load_d(float* d_s, const float* dh, int row0) {
  if (threadIdx.x < kT) {
    const int row = row0 + threadIdx.x;
    d_s[threadIdx.x] = row < kN ? dh[row] : 0.f;
  }
}

// 0. o = P v and D = rowsum(do o) of one (window, head, query tile)
__global__ void __launch_bounds__(kThreads) msa_bwd_o_f32_kernel(const Params p) {
  __shared__ __align__(16) float ps[kTileS];
  __shared__ __align__(16) float vs[kTileR];
  const int t = threadIdx.x, rg = t / 8, dg = t % 8;
  const int qt = blockIdx.x % kNT, unit = blockIdx.x / kNT;  // unit = w heads + h
  const int h = unit % p.heads, w = unit / p.heads;
  const int row0 = qt * kT;
  const float* ph = p.p + static_cast<size_t>(unit) * kN * kN;
  const float* vh = p.v + static_cast<size_t>(w) * kN * p.ld + h * kHD;
  float o[4][4];
  zero(o);
  for (int kt = 0; kt < kN; kt += kT) {
    __syncthreads();  // the last tile's readers are done
    load_p(ps, ph, row0, kt);
    load_r(vs, vh, p.ld, kt, kN);
    __syncthreads();
    mma_nn(o, ps, vs, rg, dg, (min(kT, kN - kt) + 3) / 4 * 4);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + rg + 16 * i;
    float d = 0.f;
    if (row < kN) {
      const size_t at = (static_cast<size_t>(w) * kN + row) * p.c + h * kHD + 4 * dg;
      *reinterpret_cast<float4*>(p.o + at) = make_float4(o[i][0], o[i][1], o[i][2], o[i][3]);
      const float4 g = __ldg(reinterpret_cast<const float4*>(p.dattn + at));
      d = fmaf(g.x, o[i][0], fmaf(g.y, o[i][1], fmaf(g.z, o[i][2], g.w * o[i][3])));
    }
    // the row's 8 threads are 8 consecutive lanes
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    d += __shfl_xor_sync(0xffffffffu, d, 2);
    d += __shfl_xor_sync(0xffffffffu, d, 4);
    if (dg == 0 && row < kN) p.dsum[static_cast<size_t>(unit) * kN + row] = d;
  }
}

// 1. dq and the dbias partials
__global__ void __launch_bounds__(kThreads, 2) msa_bwd_q_f32_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  float* dos = smem;              // do, d-major
  float* vs = dos + kTileT;       // v, d-major
  float* kr = vs + kTileT;        // k, row-major
  float* dss = kr + kTileR;       // dS, row-major
  float* d_s = dss + kTileS;      // D of the rows
  const int t = threadIdx.x;
  const int ty = t / 16, tx = t % 16, rg = t / 8, dg = t % 8;
  const int qt = blockIdx.y % kNT, h = blockIdx.y / kNT;
  const int row0 = qt * kT;
  const size_t ld3 = 3 * static_cast<size_t>(p.c);
  for (int kt = 0; kt < kN; kt += kT) {
    const int kn = min(kT, kN - kt);
    float db[8][4];
    zero(db);
    for (int win = blockIdx.x; win < p.m; win += p.bp) {
      const size_t unit = static_cast<size_t>(win) * p.heads + h;
      const float* dh = p.dattn + static_cast<size_t>(win) * kN * p.c + h * kHD;
      const size_t base = static_cast<size_t>(win) * kN * p.ld + h * kHD;
      const float* ph = p.p + unit * kN * kN;
      __syncthreads();  // the last window's readers are done
      load_t(dos, dh, p.c, row0, kN);
      load_t(vs, p.v + base, p.ld, kt, kN);
      load_r(kr, p.k + base, p.ld, kt, kN);
      load_d(d_s, p.dsum + unit * kN, row0);
      __syncthreads();
      float acc[8][4];
      zero(acc);
      mma_nt(acc, dos, vs, ty, tx);  // dP
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int lr = s_row(ty, r), row = row0 + lr;
        float4 pr = make_float4(0.f, 0.f, 0.f, 0.f);
        if (row < kN && 4 * tx < kn)
          pr = __ldg(reinterpret_cast<const float4*>(ph + row * kN + kt + 4 * tx));
        const float dsum = d_s[lr];
        const float4 ds = make_float4(pr.x * (acc[r][0] - dsum), pr.y * (acc[r][1] - dsum),
                                      pr.z * (acc[r][2] - dsum), pr.w * (acc[r][3] - dsum));
        db[r][0] += ds.x, db[r][1] += ds.y, db[r][2] += ds.z, db[r][3] += ds.w;
        *reinterpret_cast<float4*>(dss + lr * kLd + 4 * tx) = ds;
      }
      __syncthreads();
      float dq[4][4];
      zero(dq);
      mma_nn(dq, dss, kr, rg, dg, (kn + 3) / 4 * 4);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = row0 + rg + 16 * i;
        if (row < kN) {
          float4* dst = reinterpret_cast<float4*>(
              p.dqkv + (static_cast<size_t>(win) * kN + row) * ld3 + h * kHD + 4 * dg);
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
      if (row < kN && 4 * tx < kn)
        *reinterpret_cast<float4*>(
            p.part + ((static_cast<size_t>(blockIdx.x) * p.heads + h) * kN + row) * kN + kt +
            4 * tx) = make_float4(db[r][0], db[r][1], db[r][2], db[r][3]);
    }
  }
}

// 2. dk and dv of one (window, head, key tile)
__global__ void __launch_bounds__(kThreads, 3) msa_bwd_kv_f32_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  float* vs = smem;               // v, d-major
  float* dos = vs + kTileT;       // do, d-major
  float* dr = dos + kTileT;       // do, row-major
  float* qr = dr + kTileR;        // q (post-scale), row-major
  float* pt = qr + kTileR;        // P^T, then dS^T, row-major (keys x queries)
  float* d_s = pt + kTileS;       // D of the queries
  const int t = threadIdx.x;
  const int ty = t / 16, tx = t % 16, rg = t / 8, dg = t % 8;
  const int kt = (blockIdx.x % kNT) * kT, unit = blockIdx.x / kNT;  // unit = w heads + h
  const int h = unit % p.heads, w = unit / p.heads;
  const size_t ld3 = 3 * static_cast<size_t>(p.c);
  const float* dh = p.dattn + static_cast<size_t>(w) * kN * p.c + h * kHD;
  const size_t base = static_cast<size_t>(w) * kN * p.ld + h * kHD;
  const float* ph = p.p + static_cast<size_t>(unit) * kN * kN;
  load_t(vs, p.v + base, p.ld, kt, kN);
  float dk[4][4], dv[4][4];
  zero(dk);
  zero(dv);
  for (int q0 = 0; q0 < kN; q0 += kT) {
    const int qn = min(kT, kN - q0);
    __syncthreads();  // the last query tile's readers are done
    load_t(dos, dh, p.c, q0, kN);
    load_r(dr, dh, p.c, q0, kN);
    load_r(qr, p.q + base, p.ld, q0, kN);
    load_pt(pt, ph, q0, kt);
    load_d(d_s, p.dsum + static_cast<size_t>(unit) * kN, q0);
    __syncthreads();
    float dpt[8][4];
    zero(dpt);
    mma_nt(dpt, vs, dos, ty, tx);  // dP^T: keys x queries
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float4 pr = *reinterpret_cast<const float4*>(pt + s_row(ty, r) * kLd + 4 * tx);
      const float pv[4] = {pr.x, pr.y, pr.z, pr.w};
#pragma unroll
      for (int c = 0; c < 4; ++c) dpt[r][c] = pv[c] * (dpt[r][c] - d_s[s_col(tx, c)]);
    }
    mma_nn(dv, pt, dr, rg, dg, (qn + 3) / 4 * 4);
    __syncthreads();  // P^T's readers are done
    store_s(pt, dpt, ty, tx);
    __syncthreads();
    mma_nn(dk, pt, qr, rg, dg, (qn + 3) / 4 * 4);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = kt + rg + 16 * i;
    if (key < kN) {
      float* row = p.dqkv + (static_cast<size_t>(w) * kN + key) * ld3 + h * kHD + 4 * dg;
      *reinterpret_cast<float4*>(row + p.c) = make_float4(dk[i][0], dk[i][1], dk[i][2], dk[i][3]);
      *reinterpret_cast<float4*>(row + 2 * p.c) =
          make_float4(dv[i][0], dv[i][1], dv[i][2], dv[i][3]);
    }
  }
}

inline bool aligned(const void* ptr) {
  return ptr != nullptr && reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

}  // namespace k5f32
}  // namespace lavt

// K5 f32's attention: dattn (m 144, C), q, k, v (m, 144, C) at row stride
// ld floats (the column views of the save mode's (m 144, 3C) qkv: ld = 3C),
// p (m, heads, 144, 144), all f32; writes o (m 144, C), dqkv (m 144, 3C),
// dsum (m, heads, 144) and the dbias partials (bp, heads, 144, 144), partial
// b from the windows b, b + bp, ... (ops/fused_msa.msa_bwd_f32_groups).
// C = 32 heads.  Three launches on `stream`.
extern "C" int lavt_msa_bwd_attn_f32(const void* dattn, const void* q, const void* k,
                                     const void* v, const void* prob, void* o, void* dqkv,
                                     void* dsum, void* dbias_part, int m, int C, int ld,
                                     int heads, int bp, float scale, void* stream) {
  using namespace lavt::k5f32;
  if (m < 1 || heads < 1 || C != heads * kHD || ld < C || ld % 4 != 0 || bp < 1 || bp > m ||
      !aligned(dattn) || !aligned(q) || !aligned(k) || !aligned(v) || !aligned(prob) ||
      !aligned(o) || !aligned(dqkv) || !aligned(dsum) || !aligned(dbias_part))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long units = static_cast<long long>(m) * heads * kNT;
  if (units > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.dattn = static_cast<const float*>(dattn);
  p.q = static_cast<const float*>(q), p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v), p.p = static_cast<const float*>(prob);
  p.o = static_cast<float*>(o), p.dqkv = static_cast<float*>(dqkv);
  p.dsum = static_cast<float*>(dsum), p.part = static_cast<float*>(dbias_part);
  p.m = m, p.c = C, p.ld = ld, p.heads = heads, p.bp = bp, p.scale = scale;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  msa_bwd_o_f32_kernel<<<static_cast<unsigned>(units), kThreads, 0, s>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = lavt::allow_smem(msa_bwd_q_f32_kernel, kQSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  msa_bwd_q_f32_kernel<<<dim3(bp, kNT * heads), kThreads, kQSmem, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = lavt::allow_smem(msa_bwd_kv_f32_kernel, kKVSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  msa_bwd_kv_f32_kernel<<<static_cast<unsigned>(units), kThreads, kKVSmem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}
