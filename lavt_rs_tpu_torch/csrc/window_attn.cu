// K9: the backward of K10 (K10 itself, the attention-only forward on
// pre-projected heads, is csrc/window_attn_sm90.cu; K2p, whose first design
// had its own attention core here, is csrc/window_msa_sm90.cu on K10's).
//
// K9 replaces lavt_rs_tpu/ops/pallas/window_attn.py:attention_core_bwd /
// _bwd_kernel, the VJP of every K10 call.  Given q, k, v, K10's output o
// and lse, do, the bias and the mask, with s = (q scale rounded to bf16)
// k^T + bias + mask as in K10:
//   P = exp(s - lse),  D = rowsum(do o)      (f32; o is K10's saved output,
//                                             where the TPU kernel recomputes it)
//   dP = do v^T,  dS = P (dP - D)            (f32)
//   dv = P^T do,  dk = dS^T (q scale),  dq = dS k scale   (P, dS rounded
//                                             to bf16 for the products)
//   dbias[h] = sum over batch and windows of dS   (f32)
// The mask gets no cotangent (a constant of region ids).
//
// Bound on the H100: five N x N x hd products (10 N^2 hd flops) per window
// and head against q/k/v/o/do/dq/dk/dv in bf16, lse, the f32 bias, dbias
// and the masked windows' mask; at N = 392, hd = 32 the bytes bound it.
// Design.  dq sums over keys, dk and dv over queries, and dbias over every
// window: no one tiling owns all four, and float atomics would make the
// sums depend on block order, so K9 is two launches and one reduction:
//   1. attn_bwd_q_kernel: a block owns (head, window group, query-row
//      split) and walks its group's windows in order; k and v of the
//      window sit in shared memory, each warp owns 16 query rows (q, do, o
//      as register fragments), computes D, then walks the keys 32 at a
//      time: S and dP by mma.sync, P and dS in registers, dq += dS k.  dS
//      is added, in f32, to the block's rows of its group's (heads, N, N)
//      partial slice in device memory (written at the group's first
//      window, read-modified-written after): each element has one owner,
//      so no atomics.  The groups are as many as a 32 MiB budget of
//      slices allows (one slice per window would be 597 MB at stage 1),
//      and the row splits fill the card.  D goes to device memory for 2.
//   2. attn_bwd_kv_kernel: a block owns (window, head, key split), stages
//      q scale and do in shared memory with lse and D, and each warp owns
//      16 keys (k, v as register fragments) and walks the queries 32 at a
//      time: S^T = k q^T and dP^T = v do^T, P^T and dS^T in registers (the
//      bias and mask read transposed, 32-byte sectors), dv += P^T do and
//      dk += dS^T q.  That recomputes S and dP (7 products, not 5): the
//      price of keeping every sum in registers or one owner's slice.
//   3. sum_partials (csrc/fused_msa_bwd.cu) adds the group slices in a
//      fixed order: the same inputs give the same bits.
// Both kernels: 256 threads, 64 KB of shared memory, two blocks per SM.

#include <cstdint>

#include "common.cuh"

namespace lavt {
namespace wattn {

constexpr int kHD = 32;          // head dim
constexpr int kNMax = 400;       // largest window (video 392, sublane-padded)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kKC = 32;          // keys (queries) per backward step

constexpr int LDH = kHD + 8;     // bf16 q/k/v rows (80 bytes: conflict-free)

constexpr size_t HEAD_BYTES = align128(size_t(kNMax) * LDH * 2);
constexpr size_t SMEM_K9Q = 2 * HEAD_BYTES;
constexpr size_t SMEM_K9KV = 2 * HEAD_BYTES + 2 * align128(size_t(kNMax) * 4);

__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 tiles of shared memory, transposed into B fragments.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// bias/mask values of columns c, c + 1 of one row (0 past n; 8-byte loads
// when n is even, so every row starts 8-byte aligned)
__device__ __forceinline__ float2 ld_pair(const float* __restrict__ row, int c, int n) {
  if (!(n & 1)) return c < n ? __ldg(reinterpret_cast<const float2*>(row + c)) : make_float2(0.f, 0.f);
  return make_float2(c < n ? __ldg(row + c) : 0.f, c + 1 < n ? __ldg(row + c + 1) : 0.f);
}

// Copy rows [0, n) of a (n, 32) bf16 head into shared memory (row stride
// LDH), zero rows [n, n rounded to 16).
__device__ __forceinline__ void stage_head(bf16* dst, const bf16* __restrict__ src, int n) {
  const int n16 = (n + 15) & ~15;
  for (int i = threadIdx.x; i < n16 * (kHD / 8); i += kThreads) {
    const int r = i / (kHD / 8), c = (i % (kHD / 8)) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r < n) v = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(r) * kHD + c);
    *reinterpret_cast<uint4*>(dst + r * LDH + c) = v;
  }
}

// A fragments of 16 rows of a row-major bf16 (rows, 32) matrix (row stride
// ld), zero past row n.
__device__ __forceinline__ void load_qa(uint32_t (&qa)[2][4], const bf16* q, int ld, int r0, int n) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const int ra = r0 + g, rb = ra + 8;
#pragma unroll
  for (int kc = 0; kc < 2; ++kc) {
    const int c = kc * 16 + tq * 2;
    qa[kc][0] = ra < n ? ld32(q + ra * ld + c) : 0u;
    qa[kc][1] = rb < n ? ld32(q + rb * ld + c) : 0u;
    qa[kc][2] = ra < n ? ld32(q + ra * ld + c + 8) : 0u;
    qa[kc][3] = rb < n ? ld32(q + rb * ld + c + 8) : 0u;
  }
}

__device__ __forceinline__ uint32_t scale_bf2(uint32_t v, float scale) {
  __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&v);
  const float2 f = __bfloat1622float2(h);
  return pack_bf2(f.x * scale, f.y * scale);
}

// -- K9: the backward ---------------------------------------------------------

__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }

// sum of the two bf16 products of a pair
__device__ __forceinline__ float dot_bf2(uint32_t a, uint32_t b) {
  const float2 x = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&a));
  const float2 y = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&b));
  return x.x * y.x + x.y * y.y;
}

// row[c], row[c + 1] = (x, y) (first) or += (x, y), columns < n only; one
// 8-byte access when n is even (every row 8-byte aligned, c even)
__device__ __forceinline__ void acc_pair(float* __restrict__ row, int c, int n, float x, float y,
                                         bool first) {
  if (!(n & 1)) {
    if (c < n) {
      float2* p = reinterpret_cast<float2*>(row + c);
      if (!first) {
        const float2 old = *p;
        x += old.x, y += old.y;
      }
      *p = make_float2(x, y);
    }
    return;
  }
  if (c < n) row[c] = first ? x : row[c] + x;
  if (c + 1 < n) row[c + 1] = first ? y : row[c + 1] + y;
}

// Like stage_head, with every value times scale, rounded to bf16 (K10's q)
__device__ __forceinline__ void stage_head_scaled(bf16* dst, const bf16* __restrict__ src, int n,
                                                  float scale) {
  const int n16 = (n + 15) & ~15;
  for (int i = threadIdx.x; i < n16 * (kHD / 8); i += kThreads) {
    const int r = i / (kHD / 8), c = (i % (kHD / 8)) * 8;
    Pack8 p;
    p.u = make_uint4(0, 0, 0, 0);
    if (r < n) {
      p.u = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(r) * kHD + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(p.h[e]);
        p.h[e] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
      }
    }
    *reinterpret_cast<uint4*>(dst + r * LDH + c) = p.u;
  }
}

// acc (16 x 32, C fragments) += A (16 x 16 of bf16 pairs) . X[rows x0 + 0..15]
// (x0 rows of a (rows, 32) bf16 head in shared memory), X read transposed
// into B fragments as K10 reads v.
__device__ __forceinline__ void mma_rows(float (&acc)[4][4], const uint32_t (&a)[4],
                                         const bf16* xs, int x0) {
  const int lane = threadIdx.x & 31;
  const bf16* xr = xs + (x0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDH + (lane >> 4) * 8;
#pragma unroll
  for (int dp = 0; dp < 2; ++dp) {
    uint32_t b[4];
    ldsm_x4_trans(b, xr + dp * 16);
    mma16816(acc[2 * dp], a, b[0], b[1]);
    mma16816(acc[2 * dp + 1], a, b[2], b[3]);
  }
}

// c (16 x 8 tile) += A (16 x 32, two k16 halves) . X[x0 + 0..7]^T (rows of
// a (rows, 32) bf16 head in shared memory), as K10 computes q k^T
__device__ __forceinline__ void mma_rowsT(float (&c)[4], const uint32_t (&a)[2][4],
                                          const bf16* xs, int x0) {
  const int lane = threadIdx.x & 31;
  const bf16* xr = xs + (x0 + (lane >> 2)) * LDH + (lane & 3) * 2;
  mma16816(c, a[0], ld32(xr), ld32(xr + 8));
  mma16816(c, a[1], ld32(xr + 16), ld32(xr + 24));
}

// bf16 A fragment (16 x 16) of the f32 C fragments of two 8-column tiles
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&t0)[4],
                                       const float (&t1)[4]) {
  a[0] = pack_bf2(t0[0], t0[1]);
  a[1] = pack_bf2(t0[2], t0[3]);
  a[2] = pack_bf2(t1[0], t1[1]);
  a[3] = pack_bf2(t1[2], t1[3]);
}

// Store a 16 x 32 C-fragment tile (rows r0 + 0..15, < n) times s as bf16.
__device__ __forceinline__ void store_rows(bf16* __restrict__ out, const float (&acc)[4][4],
                                           int r0, int n, float s) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const int ra = r0 + g, rb = ra + 8;
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    const int c = d * 8 + tq * 2;
    if (ra < n)
      *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(ra) * kHD + c) =
          pack_bf2(acc[d][0] * s, acc[d][1] * s);
    if (rb < n)
      *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(rb) * kHD + c) =
          pack_bf2(acc[d][2] * s, acc[d][3] * s);
  }
}

// K9, launch 1: grid (heads, G, query splits).  Block (h, g, z) takes
// windows g, g + G, ... of head h, and in each the 16-row query tiles
// z * 8 + warp, + 8 * splits, ...; it owns those rows of dbias slice g.
__global__ void __launch_bounds__(kThreads, 2)
attn_bwd_q_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ o,
                  const bf16* __restrict__ dout, const float* __restrict__ lse,
                  const float* __restrict__ bias, const float* __restrict__ mask,
                  bf16* __restrict__ dq, float* __restrict__ dsum,
                  float* __restrict__ dbias_part, int Bw, int nW, int n, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = reinterpret_cast<bf16*>(smem + HEAD_BYTES);

  const int h = blockIdx.x, heads = gridDim.x, g0 = blockIdx.y, G = gridDim.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const int n16 = (n + 15) & ~15, tiles = n16 / 16;
  const float* bias_h = bias + static_cast<size_t>(h) * n * n;
  float* part = dbias_part + (static_cast<size_t>(g0) * heads + h) * n * n;
  for (int win = g0; win < Bw; win += G) {
    const bool first = win == g0;
    const size_t rows = (static_cast<size_t>(win) * heads + h) * n;  // (win, h) row 0
    const size_t base = rows * kHD;
    __syncthreads();  // every warp is done with the last window's k and v
    stage_head(ks, k + base, n);
    stage_head(vs, v + base, n);
    __syncthreads();
    const float* mask_w = mask != nullptr ? mask + static_cast<size_t>(win % nW) * n * n : nullptr;
    for (int gi = blockIdx.z * kWarps + warp; gi < tiles; gi += gridDim.z * kWarps) {
      const int r0 = gi * 16, ra = r0 + g, rb = ra + 8;
      uint32_t qa[2][4], da[2][4], oa[2][4];
      load_qa(qa, q + base, kHD, r0, n);
      load_qa(da, dout + base, kHD, r0, n);
      load_qa(oa, o + base, kHD, r0, n);
      float Da = 0.f, Db = 0.f;  // D = rowsum(do o) of rows ra, rb
#pragma unroll
      for (int kc = 0; kc < 2; ++kc) {
        Da += dot_bf2(da[kc][0], oa[kc][0]) + dot_bf2(da[kc][2], oa[kc][2]);
        Db += dot_bf2(da[kc][1], oa[kc][1]) + dot_bf2(da[kc][3], oa[kc][3]);
#pragma unroll
        for (int e = 0; e < 4; ++e) qa[kc][e] = scale_bf2(qa[kc][e], scale);
      }
#pragma unroll
      for (int sh = 1; sh <= 2; sh <<= 1) {
        Da += __shfl_xor_sync(0xffffffffu, Da, sh);
        Db += __shfl_xor_sync(0xffffffffu, Db, sh);
      }
      // rows past n: lse +inf, so P = 0 and nothing flows
      const float la = ra < n ? lse[rows + ra] : pos_inf();
      const float lb = rb < n ? lse[rows + rb] : pos_inf();
      const size_t oa_off = static_cast<size_t>(ra < n ? ra : 0) * n;
      const size_t ob_off = static_cast<size_t>(rb < n ? rb : 0) * n;
      float acc[4][4];
#pragma unroll
      for (int d = 0; d < 4; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;

      for (int kb = 0; kb < n16; kb += kKC) {
        float s[4][4], dp[4][4];
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.f;
          dp[t][0] = dp[t][1] = dp[t][2] = dp[t][3] = 0.f;
          if (kb + t * 8 < n16) {
            mma_rowsT(s[t], qa, ks, kb + t * 8);
            mma_rowsT(dp[t], da, vs, kb + t * 8);
          }
        }
        // P = exp(s + bias + mask - lse), dS = P (dP - D) into s; keys past
        // n (zero rows of ks) drop out
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int c = kb + t * 8 + tq * 2;
          float2 ba = ld_pair(bias_h + oa_off, c, n), bb = ld_pair(bias_h + ob_off, c, n);
          if (mask_w != nullptr) {
            const float2 ma = ld_pair(mask_w + oa_off, c, n), mb = ld_pair(mask_w + ob_off, c, n);
            ba.x += ma.x, ba.y += ma.y, bb.x += mb.x, bb.y += mb.y;
          }
          const float p0 = c < n ? __expf(s[t][0] + ba.x - la) : 0.f;
          const float p1 = c + 1 < n ? __expf(s[t][1] + ba.y - la) : 0.f;
          const float p2 = c < n ? __expf(s[t][2] + bb.x - lb) : 0.f;
          const float p3 = c + 1 < n ? __expf(s[t][3] + bb.y - lb) : 0.f;
          s[t][0] = p0 * (dp[t][0] - Da);
          s[t][1] = p1 * (dp[t][1] - Da);
          s[t][2] = p2 * (dp[t][2] - Db);
          s[t][3] = p3 * (dp[t][3] - Db);
          if (ra < n) acc_pair(part + oa_off, c, n, s[t][0], s[t][1], first);
          if (rb < n) acc_pair(part + ob_off, c, n, s[t][2], s[t][3], first);
        }
        // dq += dS k (16 keys at a time)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if (kb + j * 16 < n16) {
            uint32_t a[4];
            pack_a(a, s[2 * j], s[2 * j + 1]);
            mma_rows(acc, a, ks, kb + j * 16);
          }
        }
      }
      store_rows(dq + base, acc, r0, n, scale);
      if (tq == 0) {
        if (ra < n) dsum[rows + ra] = Da;
        if (rb < n) dsum[rows + rb] = Db;
      }
    }
  }
}

// K9, launch 2: grid (heads, B nW, key splits).  Block (h, w, z) takes
// the 16-key tiles z * 8 + warp, + 8 * splits, ... of window w, head h.
__global__ void __launch_bounds__(kThreads, 2)
attn_bwd_kv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ dsum,
                   const float* __restrict__ bias, const float* __restrict__ mask,
                   bf16* __restrict__ dk, bf16* __restrict__ dv, int nW, int n, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* dos = reinterpret_cast<bf16*>(smem + HEAD_BYTES);
  float* ls = reinterpret_cast<float*>(smem + 2 * HEAD_BYTES);
  float* Ds = ls + align128(size_t(kNMax) * 4) / 4;

  const int h = blockIdx.x, heads = gridDim.x, win = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const int n16 = (n + 15) & ~15, tiles = n16 / 16;
  const size_t rows = (static_cast<size_t>(win) * heads + h) * n;
  const size_t base = rows * kHD;
  stage_head_scaled(qs, q + base, n, scale);
  stage_head(dos, dout + base, n);
  for (int i = threadIdx.x; i < n16; i += kThreads) {
    ls[i] = i < n ? lse[rows + i] : pos_inf();  // queries past n: P = 0
    Ds[i] = i < n ? dsum[rows + i] : 0.f;
  }
  __syncthreads();
  const float* bias_h = bias + static_cast<size_t>(h) * n * n;
  const float* mask_w = mask != nullptr ? mask + static_cast<size_t>(win % nW) * n * n : nullptr;
  for (int kt = blockIdx.z * kWarps + warp; kt < tiles; kt += gridDim.z * kWarps) {
    const int k0 = kt * 16, ka_row = k0 + g, kb_row = ka_row + 8;
    const int ca = ka_row < n ? ka_row : 0, cb = kb_row < n ? kb_row : 0;
    uint32_t ka[2][4], va[2][4];
    load_qa(ka, k + base, kHD, k0, n);
    load_qa(va, v + base, kHD, k0, n);
    float dka[4][4], dva[4][4];
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      dka[d][0] = dka[d][1] = dka[d][2] = dka[d][3] = 0.f;
      dva[d][0] = dva[d][1] = dva[d][2] = dva[d][3] = 0.f;
    }
    for (int qb = 0; qb < n16; qb += kKC) {
      // S^T = k (q scale)^T and dP^T = v do^T: rows keys, columns queries
      float st[4][4], dpt[4][4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        st[t][0] = st[t][1] = st[t][2] = st[t][3] = 0.f;
        dpt[t][0] = dpt[t][1] = dpt[t][2] = dpt[t][3] = 0.f;
        if (qb + t * 8 < n16) {
          mma_rowsT(st[t], ka, qs, qb + t * 8);
          mma_rowsT(dpt[t], va, dos, qb + t * 8);
        }
      }
      // P^T into st, dS^T into dpt; the bias and mask of (query c, key r)
      // read at [c][r]
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int c = qb + t * 8 + tq * 2;
        if (qb + t * 8 < n16) {
          float b00 = 0.f, b01 = 0.f, b10 = 0.f, b11 = 0.f;  // (key a|b, query c|c+1)
          if (c < n) {
            const size_t off = static_cast<size_t>(c) * n;
            b00 = __ldg(bias_h + off + ca), b10 = __ldg(bias_h + off + cb);
            if (mask_w != nullptr)
              b00 += __ldg(mask_w + off + ca), b10 += __ldg(mask_w + off + cb);
          }
          if (c + 1 < n) {
            const size_t off = static_cast<size_t>(c + 1) * n;
            b01 = __ldg(bias_h + off + ca), b11 = __ldg(bias_h + off + cb);
            if (mask_w != nullptr)
              b01 += __ldg(mask_w + off + ca), b11 += __ldg(mask_w + off + cb);
          }
          const float l0 = ls[c], l1 = ls[c + 1], d0 = Ds[c], d1 = Ds[c + 1];
          const float p00 = ka_row < n ? __expf(st[t][0] + b00 - l0) : 0.f;
          const float p01 = ka_row < n ? __expf(st[t][1] + b01 - l1) : 0.f;
          const float p10 = kb_row < n ? __expf(st[t][2] + b10 - l0) : 0.f;
          const float p11 = kb_row < n ? __expf(st[t][3] + b11 - l1) : 0.f;
          st[t][0] = p00, st[t][1] = p01, st[t][2] = p10, st[t][3] = p11;
          dpt[t][0] = p00 * (dpt[t][0] - d0);
          dpt[t][1] = p01 * (dpt[t][1] - d1);
          dpt[t][2] = p10 * (dpt[t][2] - d0);
          dpt[t][3] = p11 * (dpt[t][3] - d1);
        }
      }
      // dv += P^T do, dk += dS^T (q scale), 16 queries at a time
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (qb + j * 16 < n16) {
          uint32_t a[4];
          pack_a(a, st[2 * j], st[2 * j + 1]);
          mma_rows(dva, a, dos, qb + j * 16);
          pack_a(a, dpt[2 * j], dpt[2 * j + 1]);
          mma_rows(dka, a, qs, qb + j * 16);
        }
      }
    }
    store_rows(dk + base, dka, k0, n, 1.f);
    store_rows(dv + base, dva, k0, n, 1.f);
  }
}

}  // namespace wattn
}  // namespace lavt

// K9's two kernels; dbias_part (groups, heads, n, n) f32 for sum_partials
extern "C" int lavt_window_attn_bwd(const void* q, const void* k, const void* v, const void* o,
                                    const void* dout, const void* lse, const void* bias,
                                    const void* mask, void* dq, void* dk, void* dv, void* dsum,
                                    void* dbias_part, int Bw, int nW, int heads, int n,
                                    int groups, int qsplit, int ksplit, float scale,
                                    void* stream) {
  using namespace lavt;
  using namespace lavt::wattn;
  if (n < 1 || n > kNMax || groups < 1 || groups > Bw || qsplit < 1 || ksplit < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(attn_bwd_q_kernel, SMEM_K9Q);
  if (err == cudaSuccess) err = allow_smem(attn_bwd_kv_kernel, SMEM_K9KV);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16 *qp = static_cast<const bf16*>(q), *kp = static_cast<const bf16*>(k),
             *vp = static_cast<const bf16*>(v), *dop = static_cast<const bf16*>(dout);
  const float *lp = static_cast<const float*>(lse), *bp = static_cast<const float*>(bias),
              *mp = static_cast<const float*>(mask);
  attn_bwd_q_kernel<<<dim3(heads, groups, qsplit), kThreads, SMEM_K9Q, st>>>(
      qp, kp, vp, static_cast<const bf16*>(o), dop, lp, bp, mp, static_cast<bf16*>(dq),
      static_cast<float*>(dsum), static_cast<float*>(dbias_part), Bw, nW, n, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_bwd_kv_kernel<<<dim3(heads, Bw, ksplit), kThreads, SMEM_K9KV, st>>>(
      qp, kp, vp, dop, lp, static_cast<const float*>(dsum), bp, mp, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), nW, n, scale);
  return static_cast<int>(cudaGetLastError());
}
