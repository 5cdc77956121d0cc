// K4: one-pass row LayerNorm, and K4b, its backward in one pass.
//
// K4 replaces lavt_rs_tpu/ops/pallas/ln.py:layer_norm_rows (_ln_kernel),
// the stage-output norms norm0..norm3 of the Swin backbone; its launch is
// also K1's pre-attention LN (ops/fused_msa.save_launches).  K4b replaces
// the XLA backward of that custom_vjp (ln.py:_ln_bwd), the stage norms'
// and K1's LN backward in training.
//
// Math (both): f32 statistics with the fast variance E[x^2] - E[x]^2 and
// epsilon inside rsqrt.  K4: (x - mu) rstd gamma + beta in f32, rounded
// once to bf16.  K4b, from the output gradient g and the f32 master gamma:
//   xhat = (x - mu) rstd, dxn = g gamma, m1 = mean(dxn), m2 = mean(dxn xhat),
//   dx = rstd (dxn - m1 - xhat m2) in bf16,
// and per block of rows the f32 column partials of sum g xhat (dgamma) and
// sum g (dbeta), added in block order by lavt_sum_partials (no atomics).
//
// Bound on the H100: memory (K4 reads x and writes y, K4b reads x and g
// and writes dx; ~8 and ~16 flops per element).  Design:
//   * 16-byte vector loads and stores (8 bf16 a lane), neighbouring lanes
//     on neighbouring words;
//   * a row is held by a lane group of G lanes (G = 4 .. 32, a power of two
//     that divides C / 8, each lane V <= 4 words), so one warp holds 32 / G
//     rows and its reductions are log2(G) shuffles; at C <= 256 G <= 16,
//     more than one row a warp.  Widths that tile no such way (C = 160,
//     224, ...) take G = 32 with the words past C / 8 masked;
//   * gamma and beta are loaded once per lane, into f32 registers;
//   * a persistent grid: block b takes rows [b per, (b + 1) per), its warps
//     step through them together, each lane group's next row loaded before
//     this row's reductions.  At C <= 1024 K4b runs one block an SM of
//     8-24 warps, so that its partials are at most one a SM;
//   * 1024 < C <= 4096 (Swin-L's stage 4 is 1536): the whole block of 256
//     threads on one row at a time, the same vector accesses, its sums
//     reduced through shared memory in warp order.
// The launch plan (`plan`) is mirrored by ops/ln.py:ln_rows_plan.

#include <cstdint>

#include "common.cuh"

namespace lavt {
namespace lnr {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxVecs = 4;        // 16-byte words a lane holds: C <= 1024
constexpr int kWideMaxVecs = 2;    // ... on the wide path: C <= 4096

// K4: blocks of 8 warps an SM keeps resident (the registers each lane
// needs rise with V).  K4b: one block an SM, of as many warps: its
// column partials, one (2, C) per block, are then few to add
__host__ __device__ constexpr int fwd_blocks_per_sm(int v) { return v == 1 ? 5 : (v == 2 ? 3 : (v == 3 ? 2 : 1)); }
__host__ __device__ constexpr int bwd_warps(int v) { return kWarps * (v == 1 ? 3 : (v == 2 ? 2 : 1)); }
constexpr int kWideFwdBlocksPerSm = 3, kWideBwdBlocksPerSm = 2;

struct Plan {
  int lanes, vecs;  // G lanes a row, V words a lane; lanes 0: the wide path
  bool tail;        // words past C / 8 masked
  int per, blocks;  // rows a block, blocks
};

inline Plan plan(int rows, int C, int sms, bool bwd) {
  Plan p{0, 0, false, 0, 0};
  const int words = C / 8;
  int step = 1, per_sm;
  if (C > 32 * kMaxVecs * 8) {
    per_sm = bwd ? kWideBwdBlocksPerSm : kWideFwdBlocksPerSm;
  } else {
    for (int g = C <= 256 ? 16 : 32; g >= 4 && p.lanes == 0; g /= 2)
      if (words % g == 0 && words / g <= kMaxVecs) p.lanes = g, p.vecs = words / g;
    if (p.lanes == 0) p.lanes = 32, p.vecs = (words + 31) / 32, p.tail = true;
    step = (bwd ? bwd_warps(p.vecs) : kWarps) * (32 / p.lanes);
    per_sm = bwd ? 1 : fwd_blocks_per_sm(p.vecs);
  }
  const int iters = (rows + step - 1) / step;
  const int want = iters < sms * per_sm ? iters : sms * per_sm;
  p.per = (iters + want - 1) / want * step;
  p.blocks = (rows + p.per - 1) / p.per;
  return p;
}

__device__ __forceinline__ void unpack(const uint4& u, float* v) {
  Pack8 p;
  p.u = u;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(p.h[e]);
    v[2 * e] = f.x;
    v[2 * e + 1] = f.y;
  }
}

__device__ __forceinline__ uint4 pack(const float* v) {
  Pack8 p;
#pragma unroll
  for (int e = 0; e < 4; ++e) p.h[e] = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
  return p.u;
}

// sum over the G aligned lanes of a group (a fixed tree: every lane of the
// group gets the same bits)
template <int G>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the V words of one row that lane j of its group holds (zeros where the
// row or the word lies outside)
template <int G, int V, bool TAIL>
__device__ __forceinline__ void load_row(const bf16* __restrict__ src, bool valid, int j,
                                         int words, uint4 (&w)[V]) {
#pragma unroll
  for (int t = 0; t < V; ++t) {
    const int c = j + G * t;
    w[t] = (valid && (!TAIL || c < words)) ? __ldg(reinterpret_cast<const uint4*>(src) + c)
                                           : make_uint4(0u, 0u, 0u, 0u);
  }
}

template <int G, int V, bool TAIL>
__global__ void __launch_bounds__(kThreads, fwd_blocks_per_sm(V))
    rows_fwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ gamma,
                    const bf16* __restrict__ beta, bf16* __restrict__ out, int rows, int C,
                    int per, float eps) {
  constexpr int R = 32 / G, kStep = kWarps * R;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int j = lane % G, words = C / 8;
  const int r0 = blockIdx.x * per, r1 = min(rows, r0 + per);
  float gm[V][8], bt[V][8];
#pragma unroll
  for (int t = 0; t < V; ++t) {
    const int c = j + G * t;
    const bool in = !TAIL || c < words;
    unpack(in ? __ldg(reinterpret_cast<const uint4*>(gamma) + c) : make_uint4(0u, 0u, 0u, 0u),
           gm[t]);
    unpack(in ? __ldg(reinterpret_cast<const uint4*>(beta) + c) : make_uint4(0u, 0u, 0u, 0u),
           bt[t]);
  }
  const float inv_c = 1.f / C;
  int row = r0 + warp * R + lane / G;
  uint4 cur[V], nxt[V];
  load_row<G, V, TAIL>(x + static_cast<size_t>(row) * C, row < r1, j, words, cur);
  // warp-uniform bound: every lane takes the shuffles of every iteration
  for (int base = r0 + warp * R; base < r1; base += kStep, row += kStep) {
    load_row<G, V, TAIL>(x + static_cast<size_t>(row + kStep) * C, row + kStep < r1, j, words,
                         nxt);
    float v[V][8], s = 0.f, ss = 0.f;
#pragma unroll
    for (int t = 0; t < V; ++t) {
      unpack(cur[t], v[t]);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        s += v[t][e];
        ss += v[t][e] * v[t][e];
      }
    }
    s = group_sum<G>(s);
    ss = group_sum<G>(ss);
    const float mu = s * inv_c;
    const float rstd = rsqrtf(ss * inv_c - mu * mu + eps);
    if (row < r1) {
      uint4* dst = reinterpret_cast<uint4*>(out + static_cast<size_t>(row) * C);
#pragma unroll
      for (int t = 0; t < V; ++t) {
        const int c = j + G * t;
        if (TAIL && c >= words) continue;
        float y[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) y[e] = (v[t][e] - mu) * rstd * gm[t][e] + bt[t][e];
        dst[c] = pack(y);
      }
    }
#pragma unroll
    for (int t = 0; t < V; ++t) cur[t] = nxt[t];
  }
}

template <int G, int V, bool TAIL>
__global__ void __launch_bounds__(32 * bwd_warps(V), 1)
    rows_bwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                    const float* __restrict__ gamma, bf16* __restrict__ dx,
                    float* __restrict__ part, int rows, int C, int per, float eps) {
  constexpr int R = 32 / G, kW = bwd_warps(V), kStep = kW * R;
  __shared__ float red[2][32 * kMaxVecs * 8];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int j = lane % G, words = C / 8;
  const int r0 = blockIdx.x * per, r1 = min(rows, r0 + per);
  float gm[V][8], acc_gx[V][8], acc_g[V][8];
#pragma unroll
  for (int t = 0; t < V; ++t) {
    const int c = j + G * t;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      gm[t][e] = (!TAIL || c < words) ? __ldg(gamma + 8 * c + e) : 0.f;
      acc_gx[t][e] = acc_g[t][e] = 0.f;
    }
  }
  const float inv_c = 1.f / C;
  int row = r0 + warp * R + lane / G;
  uint4 cx[V], cg[V], nx[V], ng[V];
  load_row<G, V, TAIL>(x + static_cast<size_t>(row) * C, row < r1, j, words, cx);
  load_row<G, V, TAIL>(g + static_cast<size_t>(row) * C, row < r1, j, words, cg);
  for (int base = r0 + warp * R; base < r1; base += kStep, row += kStep) {
    const size_t next = static_cast<size_t>(row + kStep) * C;
    load_row<G, V, TAIL>(x + next, row + kStep < r1, j, words, nx);
    load_row<G, V, TAIL>(g + next, row + kStep < r1, j, words, ng);
    float xh[V][8], s = 0.f, ss = 0.f;
#pragma unroll
    for (int t = 0; t < V; ++t) {
      unpack(cx[t], xh[t]);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        s += xh[t][e];
        ss += xh[t][e] * xh[t][e];
      }
    }
    s = group_sum<G>(s);
    ss = group_sum<G>(ss);
    const float mu = s * inv_c;
    const float rstd = rsqrtf(ss * inv_c - mu * mu + eps);
    float dxn[V][8], m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int t = 0; t < V; ++t) {
      float gv[8];
      unpack(cg[t], gv);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        xh[t][e] = (xh[t][e] - mu) * rstd;
        dxn[t][e] = gv[e] * gm[t][e];
        m1 += dxn[t][e];
        m2 += dxn[t][e] * xh[t][e];
        acc_gx[t][e] += gv[e] * xh[t][e];  // 0 on a masked row or word: g = 0
        acc_g[t][e] += gv[e];
      }
    }
    m1 = group_sum<G>(m1) * inv_c;
    m2 = group_sum<G>(m2) * inv_c;
    if (row < r1) {
      uint4* dst = reinterpret_cast<uint4*>(dx + static_cast<size_t>(row) * C);
#pragma unroll
      for (int t = 0; t < V; ++t) {
        const int c = j + G * t;
        if (TAIL && c >= words) continue;
        float d[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) d[e] = rstd * (dxn[t][e] - m1 - xh[t][e] * m2);
        dst[c] = pack(d);
      }
    }
#pragma unroll
    for (int t = 0; t < V; ++t) cx[t] = nx[t], cg[t] = ng[t];
  }
  // the column partials: the warp's R groups by a fixed shuffle tree, then
  // the warps in order through shared memory
#pragma unroll
  for (int o = G; o < 32; o <<= 1)
#pragma unroll
    for (int t = 0; t < V; ++t)
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        acc_gx[t][e] += __shfl_xor_sync(0xffffffffu, acc_gx[t][e], o);
        acc_g[t][e] += __shfl_xor_sync(0xffffffffu, acc_g[t][e], o);
      }
  for (int w = 0; w < kW; ++w) {
    if (warp == w && lane < G) {
#pragma unroll
      for (int t = 0; t < V; ++t) {
        const int c = j + G * t;
        if (TAIL && c >= words) continue;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          red[0][8 * c + e] = (w == 0 ? 0.f : red[0][8 * c + e]) + acc_gx[t][e];
          red[1][8 * c + e] = (w == 0 ? 0.f : red[1][8 * c + e]) + acc_g[t][e];
        }
      }
    }
    __syncthreads();
  }
  float* dst = part + static_cast<size_t>(blockIdx.x) * 2 * C;
  for (int i = threadIdx.x; i < 2 * C; i += 32 * kW) dst[i] = red[i / C][i % C];
}

// -- 1024 < C <= 4096: the block on one row at a time ------------------------

// the block's sum of (a, b) in warp order; `buf` alternates between calls,
// so one barrier a call keeps a slow warp's reads apart from the next writes
__device__ __forceinline__ float2 block_sum2(float a, float b, float (*buf)[2][kWarps],
                                             int& parity) {
  a = warp_sum(a);
  b = warp_sum(b);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) buf[parity][0][warp] = a, buf[parity][1][warp] = b;
  __syncthreads();
  a = b = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) a += buf[parity][0][w], b += buf[parity][1][w];
  parity ^= 1;
  return make_float2(a, b);
}

__device__ __forceinline__ void load_wide(const bf16* __restrict__ src, bool valid, int words,
                                          uint4 (&w)[kWideMaxVecs]) {
#pragma unroll
  for (int t = 0; t < kWideMaxVecs; ++t) {
    const int c = threadIdx.x + kThreads * t;
    w[t] = (valid && c < words) ? __ldg(reinterpret_cast<const uint4*>(src) + c)
                                : make_uint4(0u, 0u, 0u, 0u);
  }
}

__global__ void __launch_bounds__(kThreads, kWideFwdBlocksPerSm)
    wide_fwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ gamma,
                    const bf16* __restrict__ beta, bf16* __restrict__ out, int rows, int C,
                    int per, float eps) {
  __shared__ float buf[2][2][kWarps];
  int parity = 0;
  const int words = C / 8;
  const int r0 = blockIdx.x * per, r1 = min(rows, r0 + per);
  float gm[kWideMaxVecs][8], bt[kWideMaxVecs][8];
  uint4 gw[kWideMaxVecs], bw[kWideMaxVecs];
  load_wide(gamma, true, words, gw);
  load_wide(beta, true, words, bw);
#pragma unroll
  for (int t = 0; t < kWideMaxVecs; ++t) unpack(gw[t], gm[t]), unpack(bw[t], bt[t]);
  const float inv_c = 1.f / C;
  uint4 cur[kWideMaxVecs], nxt[kWideMaxVecs];
  load_wide(x + static_cast<size_t>(r0) * C, r0 < r1, words, cur);
  for (int row = r0; row < r1; ++row) {
    load_wide(x + static_cast<size_t>(row + 1) * C, row + 1 < r1, words, nxt);
    float v[kWideMaxVecs][8], s = 0.f, ss = 0.f;
#pragma unroll
    for (int t = 0; t < kWideMaxVecs; ++t) {
      unpack(cur[t], v[t]);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        s += v[t][e];
        ss += v[t][e] * v[t][e];
      }
    }
    const float2 sums = block_sum2(s, ss, buf, parity);
    const float mu = sums.x * inv_c;
    const float rstd = rsqrtf(sums.y * inv_c - mu * mu + eps);
    uint4* dst = reinterpret_cast<uint4*>(out + static_cast<size_t>(row) * C);
#pragma unroll
    for (int t = 0; t < kWideMaxVecs; ++t) {
      const int c = threadIdx.x + kThreads * t;
      if (c >= words) continue;
      float y[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) y[e] = (v[t][e] - mu) * rstd * gm[t][e] + bt[t][e];
      dst[c] = pack(y);
    }
#pragma unroll
    for (int t = 0; t < kWideMaxVecs; ++t) cur[t] = nxt[t];
  }
}

__global__ void __launch_bounds__(kThreads, kWideBwdBlocksPerSm)
    wide_bwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                    const float* __restrict__ gamma, bf16* __restrict__ dx,
                    float* __restrict__ part, int rows, int C, int per, float eps) {
  __shared__ float buf[2][2][kWarps];
  int parity = 0;
  const int words = C / 8;
  const int r0 = blockIdx.x * per, r1 = min(rows, r0 + per);
  float gm[kWideMaxVecs][8], acc_gx[kWideMaxVecs][8], acc_g[kWideMaxVecs][8];
#pragma unroll
  for (int t = 0; t < kWideMaxVecs; ++t) {
    const int c = threadIdx.x + kThreads * t;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      gm[t][e] = c < words ? __ldg(gamma + 8 * c + e) : 0.f;
      acc_gx[t][e] = acc_g[t][e] = 0.f;
    }
  }
  const float inv_c = 1.f / C;
  uint4 cx[kWideMaxVecs], cg[kWideMaxVecs], nx[kWideMaxVecs], ng[kWideMaxVecs];
  load_wide(x + static_cast<size_t>(r0) * C, r0 < r1, words, cx);
  load_wide(g + static_cast<size_t>(r0) * C, r0 < r1, words, cg);
  for (int row = r0; row < r1; ++row) {
    const size_t next = static_cast<size_t>(row + 1) * C;
    load_wide(x + next, row + 1 < r1, words, nx);
    load_wide(g + next, row + 1 < r1, words, ng);
    float xh[kWideMaxVecs][8], s = 0.f, ss = 0.f;
#pragma unroll
    for (int t = 0; t < kWideMaxVecs; ++t) {
      unpack(cx[t], xh[t]);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        s += xh[t][e];
        ss += xh[t][e] * xh[t][e];
      }
    }
    const float2 sums = block_sum2(s, ss, buf, parity);
    const float mu = sums.x * inv_c;
    const float rstd = rsqrtf(sums.y * inv_c - mu * mu + eps);
    float dxn[kWideMaxVecs][8], m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int t = 0; t < kWideMaxVecs; ++t) {
      float gv[8];
      unpack(cg[t], gv);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        xh[t][e] = (xh[t][e] - mu) * rstd;
        dxn[t][e] = gv[e] * gm[t][e];
        m1 += dxn[t][e];
        m2 += dxn[t][e] * xh[t][e];
        acc_gx[t][e] += gv[e] * xh[t][e];
        acc_g[t][e] += gv[e];
      }
    }
    const float2 ms = block_sum2(m1, m2, buf, parity);
    m1 = ms.x * inv_c;
    m2 = ms.y * inv_c;
    uint4* dst = reinterpret_cast<uint4*>(dx + static_cast<size_t>(row) * C);
#pragma unroll
    for (int t = 0; t < kWideMaxVecs; ++t) {
      const int c = threadIdx.x + kThreads * t;
      if (c >= words) continue;
      float d[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) d[e] = rstd * (dxn[t][e] - m1 - xh[t][e] * m2);
      dst[c] = pack(d);
    }
#pragma unroll
    for (int t = 0; t < kWideMaxVecs; ++t) cx[t] = nx[t], cg[t] = ng[t];
  }
  // every column is one thread's: its partials go out as they are
  float* dst = part + static_cast<size_t>(blockIdx.x) * 2 * C;
#pragma unroll
  for (int t = 0; t < kWideMaxVecs; ++t) {
    const int c = threadIdx.x + kThreads * t;
    if (c >= words) continue;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      dst[8 * c + e] = acc_gx[t][e];
      dst[C + 8 * c + e] = acc_g[t][e];
    }
  }
}

// the (G, V, tail) layouts `plan` gives for C % 32 == 0, C <= 1024
#define LAVT_LN_LAYOUTS(X)                                                                   \
  X(4, 1, false) X(4, 3, false) X(8, 1, false) X(8, 3, false) X(16, 1, false)              \
  X(16, 2, false) X(16, 3, false) X(32, 2, false) X(32, 3, false) X(32, 4, false)          \
  X(32, 1, true) X(32, 2, true) X(32, 3, true) X(32, 4, true)

inline int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return sms;
}

inline bool supported(int rows, int C) {
  return rows > 0 && C >= 32 && C % 32 == 0 && C <= kThreads * kWideMaxVecs * 8;
}

inline bool aligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace lnr
}  // namespace lavt

extern "C" int lavt_layer_norm_rows(const void* x, const void* gamma, const void* beta,
                                    void* out, int rows, int C, float eps, void* stream) {
  using namespace lavt;
  using namespace lavt::lnr;
  const int sms = sm_count();
  if (!supported(rows, C) || sms == 0 || !aligned(x) || !aligned(gamma) || !aligned(beta) ||
      !aligned(out))
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = plan(rows, C, sms, false);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const bf16*>(x);
  const auto* gb = static_cast<const bf16*>(gamma);
  const auto* bb = static_cast<const bf16*>(beta);
  auto* ob = static_cast<bf16*>(out);
  if (p.lanes == 0) {
    wide_fwd_kernel<<<p.blocks, kThreads, 0, s>>>(xb, gb, bb, ob, rows, C, p.per, eps);
    return static_cast<int>(cudaGetLastError());
  }
#define LAVT_CASE(G, V, T)                                                            \
  if (p.lanes == G && p.vecs == V && p.tail == T) {                                  \
    rows_fwd_kernel<G, V, T><<<p.blocks, kThreads, 0, s>>>(xb, gb, bb, ob, rows, C, \
                                                           p.per, eps);             \
    return static_cast<int>(cudaGetLastError());                                     \
  }
  LAVT_LN_LAYOUTS(LAVT_CASE)
#undef LAVT_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// The number of (2, C) f32 partials lavt_layer_norm_rows_bwd writes at
// (rows, C) on the current device (0: a shape it does not take).
extern "C" int lavt_layer_norm_rows_bwd_parts(int rows, int C) {
  using namespace lavt::lnr;
  const int sms = sm_count();
  if (!supported(rows, C) || sms == 0) return 0;
  return plan(rows, C, sms, true).blocks;
}

// K4b.  x, g (rows, C) bf16; gamma (C) f32; dx (rows, C) bf16; part
// (parts, 2, C) f32, parts = lavt_layer_norm_rows_bwd_parts(rows, C)
// (refused otherwise).
extern "C" int lavt_layer_norm_rows_bwd(const void* x, const void* g, const void* gamma,
                                        void* dx, void* part, int parts, int rows, int C,
                                        float eps, void* stream) {
  using namespace lavt;
  using namespace lavt::lnr;
  const int sms = sm_count();
  if (!supported(rows, C) || sms == 0 || !aligned(x) || !aligned(g) || !aligned(gamma) ||
      !aligned(dx) || !aligned(part))
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = plan(rows, C, sms, true);
  if (parts != p.blocks) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const bf16*>(x);
  const auto* gb = static_cast<const bf16*>(g);
  const auto* gm = static_cast<const float*>(gamma);
  auto* db = static_cast<bf16*>(dx);
  auto* pt = static_cast<float*>(part);
  if (p.lanes == 0) {
    wide_bwd_kernel<<<p.blocks, kThreads, 0, s>>>(xb, gb, gm, db, pt, rows, C, p.per, eps);
    return static_cast<int>(cudaGetLastError());
  }
#define LAVT_CASE(G, V, T)                                                                \
  if (p.lanes == G && p.vecs == V && p.tail == T) {                                      \
    rows_bwd_kernel<G, V, T><<<p.blocks, 32 * bwd_warps(V), 0, s>>>(xb, gb, gm, db, pt, rows, C, \
                                                           p.per, eps);                 \
    return static_cast<int>(cudaGetLastError());                                         \
  }
  LAVT_LN_LAYOUTS(LAVT_CASE)
#undef LAVT_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// K4 f32 and the LN rows of K1 f32: the same row LayerNorms on f32
// activations (`--no_bf16` with Pallas: the TPU kernels,
// lavt_rs_tpu/ops/pallas/ln.py:_ln_kernel and the LN inside
// fused_msa.py:_kernel (:100-106), compute in f32 and their roundings to
// x.dtype are no-ops), with their fast variance E[x^2] - E[x]^2 (K3 f32's
// two-pass LN rows are its prep launch's, csrc/gemm_f32.cu).  Bound:
// bytes (x read, y written, 8 bytes an element).  One warp a row, 16-byte
// words (4 floats), lane l holding the words l + 32 t, t < V (words past
// C / 4 masked), gamma and beta read per word; blocks of 8 rows.
namespace lavt {
namespace lnr32 {

template <int V>
__global__ void __launch_bounds__(256)
    rows_f32_kernel(const float* __restrict__ x, const float* __restrict__ gamma,
                    const float* __restrict__ beta, float* __restrict__ y, int rows, int C,
                    float eps) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= rows) return;
  const int words = C / 4;
  const auto* src = reinterpret_cast<const float4*>(x + size_t(row) * C);
  float4 v[V];
  float s = 0.f, q = 0.f;
#pragma unroll
  for (int t = 0; t < V; ++t) {
    const int wd = lane + 32 * t;
    v[t] = wd < words ? src[wd] : make_float4(0.f, 0.f, 0.f, 0.f);
    s += (v[t].x + v[t].y) + (v[t].z + v[t].w);
    q += (v[t].x * v[t].x + v[t].y * v[t].y) + (v[t].z * v[t].z + v[t].w * v[t].w);
  }
  const float mu = warp_sum(s) / C;
  const float rstd = rsqrtf(warp_sum(q) / C - mu * mu + eps);
  auto* dst = reinterpret_cast<float4*>(y + size_t(row) * C);
  const auto* g4 = reinterpret_cast<const float4*>(gamma);
  const auto* b4 = reinterpret_cast<const float4*>(beta);
#pragma unroll
  for (int t = 0; t < V; ++t) {
    const int wd = lane + 32 * t;
    if (wd >= words) continue;
    const float4 g = g4[wd], b = b4[wd];
    dst[wd] = make_float4((v[t].x - mu) * rstd * g.x + b.x, (v[t].y - mu) * rstd * g.y + b.y,
                          (v[t].z - mu) * rstd * g.z + b.z, (v[t].w - mu) * rstd * g.w + b.w);
  }
}

inline cudaError_t launch(const float* x, const float* g, const float* b, float* y, int rows, int C,
                   float eps, cudaStream_t s) {
  const int need = (C / 4 + 31) / 32, blocks = (rows + 7) / 8;
#define LAVT_CASE(V)                                                                   \
  if (need <= V) {                                                                     \
    rows_f32_kernel<V><<<blocks, 256, 0, s>>>(x, g, b, y, rows, C, eps);              \
    return cudaGetLastError();                                                         \
  }
  LAVT_CASE(1) LAVT_CASE(2) LAVT_CASE(3) LAVT_CASE(4) LAVT_CASE(6) LAVT_CASE(8)
  LAVT_CASE(12) LAVT_CASE(16) LAVT_CASE(24) LAVT_CASE(32)
#undef LAVT_CASE
  return cudaErrorInvalidValue;
}

}  // namespace lnr32
}  // namespace lavt

// K4b f32: K4b's one pass on f32 rows (the XLA backward of the custom_vjp,
// lavt_rs_tpu/ops/pallas/ln.py:_ln_bwd, on f32 activations), one launch:
// the fast variance recomputed from x, dx written in f32, and the (2, C)
// column sums of g xhat (dscale) and g (dbias), added inside the launch.
//
// Bound: bytes (x and g read, dx written, 12 bytes an element: 177 MB at
// the lavt_one Swin-B stage-1 norm, 115,200 x 128, 0.053 ms at 3.35 TB/s).
// To stream at that rate an SM needs some 25-40 KB of x and g in flight.
// Design: a row is held by a lane group of G lanes (8, 16 or 32: at C <= 256
// several rows a warp), each lane V <= 8 16-byte words (words past C / 4
// masked); blocks of 16 warps (8 at V > 4), one an SM, persistent over
// `per` rows; every lane group loads its next row's x and g into registers
// before it reduces the current one, so 64 KB (x and g of 64 rows at C =
// 128) and as much again are in flight per SM at every width.  Each block
// adds its rows' g xhat and g per column in registers, its warps' sums in
// warp order through shared memory, and writes its (2, C) partial; the
// partials are added in the same launch, in block order: blocks come in
// `group`s of about sqrt(blocks), the last block of a group to finish (a
// ticket taken by atomicAdd after __threadfence) adds the group's
// partials in order, and the last group to finish adds the group sums in
// order.  So the sums take the same order, and the same bits, every run,
// and K4b f32 needs no second launch.  The tickets are counters in device
// memory, reset by the blocks that take the last ticket: launches of this
// kernel on one device must not overlap (they run on one stream).
// C > 1024: the block on one row at a time (thread i holds the words i +
// 256 t), its sums through `block_sum2`, the same partials and sums.  The
// plan (`plan_bwd`) is mirrored by ops/ln.py:ln_rows_f32_bwd_plan.
// (The design before: a warp a row, 8 warps an SM, ~8 KB in flight, and
// the partials added by a second launch: 0.208 ms a bs-8 step's four stage
// norms, 47 % of their bound; PERF.md.)
namespace lavt {
namespace lnr32 {

constexpr int kWideWords = 4;   // float4 words a thread holds at C <= 4096
constexpr int kMaxGroups = 64;  // groups of blocks (blocks <= 4096)

__device__ unsigned int g_tickets[kMaxGroups + 1];  // per group, and the groups'

struct BwdPlan {
  int lanes, vecs, warps;  // G lanes a row, V words a lane, warps a block; lanes 0: C > 1024
  int per, blocks;         // rows a block, blocks
  int group, groups;       // blocks a group (the last may hold fewer), groups
};

inline BwdPlan plan_bwd(int rows, int C, int sms) {
  BwdPlan p{0, 0, 8, 0, 0, 0, 0};
  int step = 1;
  if (C <= 1024) {
    const int words = C / 4;
    for (int g = 8; g <= 32 && p.lanes == 0; g *= 2)
      if (words % g == 0 && words / g <= 4) p.lanes = g, p.vecs = words / g;
    if (p.lanes == 0) p.lanes = 32, p.vecs = (words + 31) / 32;
    p.warps = p.vecs <= 4 ? 16 : 8;
    step = p.warps * (32 / p.lanes);
  }
  const int iters = (rows + step - 1) / step;
  const int want = iters < sms ? iters : sms;
  p.per = (iters + want - 1) / want * step;
  p.blocks = (rows + p.per - 1) / p.per;
  int gs = 1;
  while (gs * gs < p.blocks) ++gs;
  p.group = gs;
  p.groups = (p.blocks + gs - 1) / gs;
  return p;
}

__device__ __forceinline__ float4 zero4() { return make_float4(0.f, 0.f, 0.f, 0.f); }
__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// src[0] + src[ld] + ... + src[(rows - 1) ld], added in that order, its
// loads issued eight at a time (from L2: other blocks wrote them)
__device__ __forceinline__ float4 sum_rows(const float4* src, int rows, int ld) {
  float4 a = zero4();
  int r = 0;
  for (; r + 8 <= rows; r += 8) {
    float4 v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = __ldcg(src + size_t(r + e) * ld);
#pragma unroll
    for (int e = 0; e < 8; ++e) a = add4(a, v[e]);
  }
  for (; r < rows; ++r) a = add4(a, __ldcg(src + size_t(r) * ld));
  return a;
}

// The block's partial (2 words float4: sum g xhat, then sum g) is in `ws`
// at row blockIdx.x; adds the partials in block order into sums (2, C),
// by the last block of each group, then the last group (see the top
// note).  ws: (blocks + groups, 2, C) f32.
__device__ void finish_sums(float4* ws, float4* sums, int words, int group, int groups) {
  __shared__ int last;
  const int blocks = gridDim.x, q = blockIdx.x / group;
  const int b0 = q * group, b1 = min(blocks, b0 + group);
  const int n4 = 2 * words;
  __threadfence();  // this block's partial, before its ticket
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&g_tickets[q], 1u) == unsigned(b1 - b0 - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();  // the group's partials, after the ticket
  for (int i = threadIdx.x; i < n4; i += blockDim.x)
    ws[size_t(blocks + q) * n4 + i] = sum_rows(ws + size_t(b0) * n4 + i, b1 - b0, n4);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    g_tickets[q] = 0u;  // for the next launch
    last = atomicAdd(&g_tickets[kMaxGroups], 1u) == unsigned(groups - 1);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int i = threadIdx.x; i < n4; i += blockDim.x)
    sums[i] = sum_rows(ws + size_t(blocks) * n4 + i, groups, n4);
  if (threadIdx.x == 0) g_tickets[kMaxGroups] = 0u;
}

// the V words of a row that lane j of its group holds (zeros where the row
// or the word lies outside)
template <int G, int V>
__device__ __forceinline__ void load_row(const float* __restrict__ src, bool valid, int j,
                                         int words, float4 (&w)[V]) {
#pragma unroll
  for (int t = 0; t < V; ++t) {
    const int c = j + G * t;
    w[t] = valid && c < words ? __ldg(reinterpret_cast<const float4*>(src) + c) : zero4();
  }
}

template <int G, int V, int W>
__global__ void __launch_bounds__(32 * W, 1)
    rows_bwd_f32_kernel(const float* __restrict__ x, const float* __restrict__ g,
                        const float* __restrict__ gamma, float* __restrict__ dx,
                        float* __restrict__ ws, float* __restrict__ sums, int rows, int C,
                        int per, int group, int groups, float eps) {
  constexpr int R = 32 / G, kStep = W * R;
  __shared__ float4 red[2][256];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int j = lane % G, words = C / 4;
  const int r0 = blockIdx.x * per, r1 = min(rows, r0 + per);
  const auto* g4 = reinterpret_cast<const float4*>(gamma);
  const float inv_c = 1.f / C;
  float4 agx[V], ag[V];
#pragma unroll
  for (int t = 0; t < V; ++t) agx[t] = ag[t] = zero4();
  int row = r0 + warp * R + lane / G;
  float4 cx[V], cg[V], nx[V], ng[V];
  load_row<G, V>(x + size_t(row) * C, row < r1, j, words, cx);
  load_row<G, V>(g + size_t(row) * C, row < r1, j, words, cg);
  // warp-uniform bound: every lane takes the shuffles of every iteration
  for (int base = r0 + warp * R; base < r1; base += kStep, row += kStep) {
    const size_t next = size_t(row + kStep) * C;
    load_row<G, V>(x + next, row + kStep < r1, j, words, nx);
    load_row<G, V>(g + next, row + kStep < r1, j, words, ng);
    float s = 0.f, q = 0.f;
#pragma unroll
    for (int t = 0; t < V; ++t) {
      s += (cx[t].x + cx[t].y) + (cx[t].z + cx[t].w);
      q += (cx[t].x * cx[t].x + cx[t].y * cx[t].y) + (cx[t].z * cx[t].z + cx[t].w * cx[t].w);
    }
    s = lnr::group_sum<G>(s);
    q = lnr::group_sum<G>(q);
    const float mu = s * inv_c;
    const float rstd = rsqrtf(q * inv_c - mu * mu + eps);
    float4 dxn[V];
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int t = 0; t < V; ++t) {
      const int c = j + G * t;
      const float4 gm = c < words ? __ldg(g4 + c) : zero4();
      const float4 xh = make_float4((cx[t].x - mu) * rstd, (cx[t].y - mu) * rstd,
                                    (cx[t].z - mu) * rstd, (cx[t].w - mu) * rstd);
      cx[t] = xh;
      dxn[t] = make_float4(cg[t].x * gm.x, cg[t].y * gm.y, cg[t].z * gm.z, cg[t].w * gm.w);
      m1 += (dxn[t].x + dxn[t].y) + (dxn[t].z + dxn[t].w);
      m2 += (dxn[t].x * xh.x + dxn[t].y * xh.y) + (dxn[t].z * xh.z + dxn[t].w * xh.w);
      // a masked row or word: g = 0
      agx[t] = make_float4(agx[t].x + cg[t].x * xh.x, agx[t].y + cg[t].y * xh.y,
                           agx[t].z + cg[t].z * xh.z, agx[t].w + cg[t].w * xh.w);
      ag[t] = add4(ag[t], cg[t]);
    }
    m1 = lnr::group_sum<G>(m1) * inv_c;
    m2 = lnr::group_sum<G>(m2) * inv_c;
    if (row < r1) {
      auto* d4 = reinterpret_cast<float4*>(dx + size_t(row) * C);
#pragma unroll
      for (int t = 0; t < V; ++t) {
        const int c = j + G * t;
        if (c < words)
          d4[c] = make_float4(rstd * (dxn[t].x - m1 - cx[t].x * m2),
                              rstd * (dxn[t].y - m1 - cx[t].y * m2),
                              rstd * (dxn[t].z - m1 - cx[t].z * m2),
                              rstd * (dxn[t].w - m1 - cx[t].w * m2));
      }
    }
#pragma unroll
    for (int t = 0; t < V; ++t) cx[t] = nx[t], cg[t] = ng[t];
  }
  // the block's partial: the warp's R groups by a fixed shuffle tree, then
  // the warps in order through shared memory
#pragma unroll
  for (int o = G; o < 32; o <<= 1)
#pragma unroll
    for (int t = 0; t < V; ++t) {
      agx[t] = make_float4(agx[t].x + __shfl_xor_sync(0xffffffffu, agx[t].x, o),
                           agx[t].y + __shfl_xor_sync(0xffffffffu, agx[t].y, o),
                           agx[t].z + __shfl_xor_sync(0xffffffffu, agx[t].z, o),
                           agx[t].w + __shfl_xor_sync(0xffffffffu, agx[t].w, o));
      ag[t] = make_float4(ag[t].x + __shfl_xor_sync(0xffffffffu, ag[t].x, o),
                          ag[t].y + __shfl_xor_sync(0xffffffffu, ag[t].y, o),
                          ag[t].z + __shfl_xor_sync(0xffffffffu, ag[t].z, o),
                          ag[t].w + __shfl_xor_sync(0xffffffffu, ag[t].w, o));
    }
  for (int wp = 0; wp < W; ++wp) {
    if (warp == wp && lane < G) {
#pragma unroll
      for (int t = 0; t < V; ++t) {
        const int c = j + G * t;
        if (c >= words) continue;
        red[0][c] = wp == 0 ? agx[t] : add4(red[0][c], agx[t]);
        red[1][c] = wp == 0 ? ag[t] : add4(red[1][c], ag[t]);
      }
    }
    __syncthreads();
  }
  float4* mine = reinterpret_cast<float4*>(ws) + size_t(blockIdx.x) * 2 * words;
  for (int i = threadIdx.x; i < 2 * words; i += 32 * W) mine[i] = red[i / words][i % words];
  finish_sums(reinterpret_cast<float4*>(ws), reinterpret_cast<float4*>(sums), words, group,
              groups);
}

__global__ void __launch_bounds__(256, 1)
    wide_bwd_f32_kernel(const float* __restrict__ x, const float* __restrict__ g,
                        const float* __restrict__ gamma, float* __restrict__ dx,
                        float* __restrict__ ws, float* __restrict__ sums, int rows, int C,
                        int per, int group, int groups, float eps) {
  __shared__ float buf[2][2][lnr::kWarps];
  int parity = 0;
  const int words = C / 4;
  const int r0 = blockIdx.x * per, r1 = min(rows, r0 + per);
  const auto* g4 = reinterpret_cast<const float4*>(gamma);
  float4 agx[kWideWords], ag[kWideWords];
#pragma unroll
  for (int t = 0; t < kWideWords; ++t) agx[t] = ag[t] = zero4();
  for (int row = r0; row < r1; ++row) {
    const auto* x4 = reinterpret_cast<const float4*>(x + size_t(row) * C);
    const auto* gr = reinterpret_cast<const float4*>(g + size_t(row) * C);
    float4 xh[kWideWords], gv[kWideWords];
    float s = 0.f, q = 0.f;
#pragma unroll
    for (int t = 0; t < kWideWords; ++t) {
      const int w = threadIdx.x + 256 * t;
      xh[t] = w < words ? x4[w] : zero4();
      gv[t] = w < words ? gr[w] : zero4();
      s += (xh[t].x + xh[t].y) + (xh[t].z + xh[t].w);
      q += (xh[t].x * xh[t].x + xh[t].y * xh[t].y) + (xh[t].z * xh[t].z + xh[t].w * xh[t].w);
    }
    const float2 sums2 = lnr::block_sum2(s, q, buf, parity);
    const float mu = sums2.x / C;
    const float rstd = rsqrtf(sums2.y / C - mu * mu + eps);
    float4 dxn[kWideWords];
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int t = 0; t < kWideWords; ++t) {
      const int w = threadIdx.x + 256 * t;
      const float4 gm = w < words ? g4[w] : zero4();
      xh[t] = make_float4((xh[t].x - mu) * rstd, (xh[t].y - mu) * rstd, (xh[t].z - mu) * rstd,
                          (xh[t].w - mu) * rstd);
      dxn[t] = make_float4(gv[t].x * gm.x, gv[t].y * gm.y, gv[t].z * gm.z, gv[t].w * gm.w);
      m1 += (dxn[t].x + dxn[t].y) + (dxn[t].z + dxn[t].w);
      m2 += (dxn[t].x * xh[t].x + dxn[t].y * xh[t].y) + (dxn[t].z * xh[t].z + dxn[t].w * xh[t].w);
      agx[t] = make_float4(agx[t].x + gv[t].x * xh[t].x, agx[t].y + gv[t].y * xh[t].y,
                           agx[t].z + gv[t].z * xh[t].z, agx[t].w + gv[t].w * xh[t].w);
      ag[t] = add4(ag[t], gv[t]);
    }
    const float2 ms = lnr::block_sum2(m1, m2, buf, parity);
    m1 = ms.x / C;
    m2 = ms.y / C;
    auto* d4 = reinterpret_cast<float4*>(dx + size_t(row) * C);
#pragma unroll
    for (int t = 0; t < kWideWords; ++t) {
      const int w = threadIdx.x + 256 * t;
      if (w < words)
        d4[w] = make_float4(rstd * (dxn[t].x - m1 - xh[t].x * m2),
                            rstd * (dxn[t].y - m1 - xh[t].y * m2),
                            rstd * (dxn[t].z - m1 - xh[t].z * m2),
                            rstd * (dxn[t].w - m1 - xh[t].w * m2));
    }
  }
  // every word is one thread's: its partials go out as they are
  float4* mine = reinterpret_cast<float4*>(ws) + size_t(blockIdx.x) * 2 * words;
#pragma unroll
  for (int t = 0; t < kWideWords; ++t) {
    const int w = threadIdx.x + 256 * t;
    if (w < words) mine[w] = agx[t], mine[words + w] = ag[t];
  }
  finish_sums(reinterpret_cast<float4*>(ws), reinterpret_cast<float4*>(sums), words, group,
              groups);
}

}  // namespace lnr32
}  // namespace lavt

// x, out (rows, C) f32, gamma, beta (C,) f32, all 16-byte aligned, C a
// multiple of 32 up to 4096 (K4 f32, K1 f32's LN rows).
extern "C" int lavt_layer_norm_rows_f32(const void* x, const void* gamma, const void* beta,
                                        void* out, int rows, int C, float eps, void* stream) {
  using namespace lavt::lnr;
  if (!supported(rows, C) || !aligned(x) || !aligned(gamma) || !aligned(beta) || !aligned(out))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* xf = static_cast<const float*>(x);
  const auto* gf = static_cast<const float*>(gamma);
  const auto* bf = static_cast<const float*>(beta);
  auto* of = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(lavt::lnr32::launch(xf, gf, bf, of, rows, C, eps, s));
}

// The rows of f32 workspace lavt_layer_norm_rows_bwd_f32 takes at (rows,
// C) on the current device: (blocks + groups, 2, C) (0: a shape it does not
// take).
extern "C" int lavt_layer_norm_rows_bwd_f32_ws(int rows, int C) {
  const int sms = lavt::lnr::sm_count();
  if (!lavt::lnr::supported(rows, C) || sms == 0) return 0;
  const lavt::lnr32::BwdPlan p = lavt::lnr32::plan_bwd(rows, C, sms);
  return p.blocks + p.groups;
}

// K4b f32, one launch.  x, g (rows, C) f32; gamma (C) f32; writes dx (rows,
// C) f32 and sums (2, C) f32 (dscale, then dbias); ws (ws_rows, 2, C) f32
// scratch, ws_rows = lavt_layer_norm_rows_bwd_f32_ws(rows, C) (refused
// otherwise).
extern "C" int lavt_layer_norm_rows_bwd_f32(const void* x, const void* g, const void* gamma,
                                            void* dx, void* ws, void* sums, int ws_rows,
                                            int rows, int C, float eps, void* stream) {
  using namespace lavt::lnr;
  const int sms = sm_count();
  if (!supported(rows, C) || sms == 0 || !aligned(x) || !aligned(g) || !aligned(gamma) ||
      !aligned(dx) || !aligned(ws) || !aligned(sums))
    return static_cast<int>(cudaErrorInvalidValue);
  const lavt::lnr32::BwdPlan p = lavt::lnr32::plan_bwd(rows, C, sms);
  if (ws_rows != p.blocks + p.groups || p.groups > lavt::lnr32::kMaxGroups)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xf = static_cast<const float*>(x);
  const auto* gf = static_cast<const float*>(g);
  const auto* gm = static_cast<const float*>(gamma);
  auto* df = static_cast<float*>(dx);
  auto* wf = static_cast<float*>(ws);
  auto* sf = static_cast<float*>(sums);
  if (p.lanes == 0) {
    lavt::lnr32::wide_bwd_f32_kernel<<<p.blocks, 256, 0, s>>>(xf, gf, gm, df, wf, sf, rows, C,
                                                              p.per, p.group, p.groups, eps);
    return static_cast<int>(cudaGetLastError());
  }
#define LAVT_CASE(G, V, W)                                                                     \
  if (p.lanes == G && p.vecs == V) {                                                           \
    lavt::lnr32::rows_bwd_f32_kernel<G, V, W><<<p.blocks, 32 * W, 0, s>>>(                     \
        xf, gf, gm, df, wf, sf, rows, C, p.per, p.group, p.groups, eps);                       \
    return static_cast<int>(cudaGetLastError());                                               \
  }
  LAVT_CASE(8, 1, 16) LAVT_CASE(8, 2, 16) LAVT_CASE(8, 3, 16) LAVT_CASE(8, 4, 16)
  LAVT_CASE(16, 3, 16) LAVT_CASE(16, 4, 16) LAVT_CASE(32, 2, 16) LAVT_CASE(32, 3, 16)
  LAVT_CASE(32, 4, 16) LAVT_CASE(32, 5, 8) LAVT_CASE(32, 6, 8) LAVT_CASE(32, 7, 8)
  LAVT_CASE(32, 8, 8)
#undef LAVT_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
