// K7 f32: backward of the LayerNorm -> fc1 -> GELU -> fc2 (-> DropPath) ->
// residual tail (K3 f32 / K8 f32) on f32 activations.
//
// Replaces lavt_rs_tpu/ops/pallas/fused_mlp.py:_bwd/_bwd_kernel (:477) and
// _bwd_hsplit/_bwd_kernel_hsplit (:330) as the TPU kernels compute them on
// f32 activations (`--no_bf16` with Pallas: their roundings to x.dtype are
// no-ops).  With the two-pass LN recomputed from x, xn = LN(x), hpre =
// xn W1^T + b1, h = gelu(hpre), dmlp = gy keep (keep = 1 without DropPath):
//   dh = dmlp W2,  dhpre = dh gelu'(hpre),  dyln = dhpre W1
//   dW2 = dmlp^T h,  db2 = sum gy keep,  dW1 = dhpre^T xn,  db1 = sum dhpre
//   dgamma = sum dyln xhat,  dbeta = sum dyln
//   dx = gy + LN backward of dyln   (the residual passes gy unscaled)
//
// Bound on the H100: operations.  Five GEMMs of 2 M C 4C = 40 M C^2 = 75.5
// GFLOP a call at every Swin-B stage (M C^2 = 1.887e9), 0.458 ms at 165
// TFLOP/s (3xTF32: 495 TF32 over three passes), against ~0.3 ms for the
// f32 x, gy, dx, h and dhpre at stage 1 at 3.35 TB/s.
//
// Launches, the bf16 K7's decomposition (csrc/fused_mlp_bwd.cu); every
// buffer allocated by the wrapper, f32 throughout:
//   (a) prep_kernel: one warp a row, xn, (mu, rstd) and, with keep, dmlp =
//       gy keep (without keep dmlp is gy itself);
//   (b) the dual GEMM: W2 transposed into a K-major copy (`transpose_kernel`;
//       tf32 wgmma reads its shared-memory operands K-major only), which
//       writes the copy's lo parts and W1's beside it (lo = w - trunc(w)),
//       then on the 3xTF32 wgmma + TMA core (csrc/gemm_tf32_sm90.cuh) hpre
//       = xn W1^T into a stash in shared memory and dh = dmlp W2 on the
//       same 128 x 128 tile, each B's lo brought by TMA beside it; the
//       epilogue writes h and dhpre and each consumer's 64-row column sums
//       of dhpre (db1 partials, its four warps' 16 rows in order);
//   (c) dW2 = dmlp^T h and dW1 = dhpre^T xn on the core, both operands
//       MN-major (the depth is M: A's fragments read in place, B
//       transposed by the stagers), split over M into f32 partials
//       (`fused_mlp.bwd_plan(..., f32=True)`), summed by lavt_sum_partials
//       in a fixed order (no atomics);
//   (d) dyln = dhpre W1 on the core (W1 read (K, N): B transposed by the
//       stagers);
//   (e) ln_bwd_kernel: dx, and per 64-row block the column partials of
//       dyln xhat, dyln and gy keep (dgamma, dbeta, db2), the warps' sums
//       added in order.
// h and dhpre (M, 4C) make one round trip through memory, as in the bf16
// K7.  (The design before: mma.sync tiles with the split at every
// fragment load, PERF.md.)

#include "gemm_tf32_sm90.cuh"

namespace lavt {
namespace k7f32 {

constexpr int kRows = 64;  // rows of an LN-backward block and of a db1 partial

__device__ __forceinline__ float4 f4(float a) { return make_float4(a, a, a, a); }

// (a) one warp a row, V = C / 128 float4 words a lane
template <int V>
__global__ void __launch_bounds__(256)
    prep_kernel(const float* __restrict__ x, const float* __restrict__ gy,
                const float* __restrict__ gamma, const float* __restrict__ beta,
                const float* __restrict__ keep, int rows_per_sample, float* __restrict__ xn,
                float* __restrict__ stats, float* __restrict__ dmlp, int M, float eps) {
  constexpr int C = 128 * V;
  const int row = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= M) return;
  const size_t off = size_t(row) * C;
  const auto* x4 = reinterpret_cast<const float4*>(x + off);
  const auto* g4 = reinterpret_cast<const float4*>(gamma);
  const auto* b4 = reinterpret_cast<const float4*>(beta);
  float4 v[V];
  float s = 0.f;
#pragma unroll
  for (int t = 0; t < V; ++t) {
    v[t] = x4[lane + 32 * t];
    s += (v[t].x + v[t].y) + (v[t].z + v[t].w);
  }
  const float mu = warp_sum(s) / C;
  float q = 0.f;
#pragma unroll
  for (int t = 0; t < V; ++t) {
    const float a = v[t].x - mu, b = v[t].y - mu, c = v[t].z - mu, d = v[t].w - mu;
    q += (a * a + b * b) + (c * c + d * d);
  }
  const float rstd = rsqrtf(warp_sum(q) / C + eps);
  auto* dst = reinterpret_cast<float4*>(xn + off);
#pragma unroll
  for (int t = 0; t < V; ++t) {
    const float4 g = g4[lane + 32 * t], b = b4[lane + 32 * t];
    dst[lane + 32 * t] =
        make_float4((v[t].x - mu) * rstd * g.x + b.x, (v[t].y - mu) * rstd * g.y + b.y,
                    (v[t].z - mu) * rstd * g.z + b.z, (v[t].w - mu) * rstd * g.w + b.w);
  }
  if (lane == 0) reinterpret_cast<float2*>(stats)[row] = make_float2(mu, rstd);
  if (keep == nullptr) return;
  const float kp = keep[row / rows_per_sample];
  const auto* gy4 = reinterpret_cast<const float4*>(gy + off);
  auto* d4 = reinterpret_cast<float4*>(dmlp + off);
#pragma unroll
  for (int t = 0; t < V; ++t) {
    const float4 g = gy4[lane + 32 * t];
    d4[lane + 32 * t] = make_float4(g.x * kp, g.y * kp, g.z * kp, g.w * kp);
  }
}

// (b) W2 (rows, cols) -> its transpose (cols, rows) and the transpose's lo
// parts, 32 x 32 tiles; W1 (cols, rows), the transpose's shape, -> its lo
// parts at the same places
__global__ void __launch_bounds__(256)
    transpose_kernel(const float* __restrict__ in, float* __restrict__ out,
                     float* __restrict__ out_lo, const float* __restrict__ w1,
                     float* __restrict__ w1_lo, int rows, int cols) {
  __shared__ float t[32][33];
  const int c0 = blockIdx.x * 32, r0 = blockIdx.y * 32;
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int r = r0 + i, c = c0 + threadIdx.x;
    if (r < rows && c < cols) t[i][threadIdx.x] = in[size_t(r) * cols + c];
  }
  __syncthreads();
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int c = c0 + i, r = r0 + threadIdx.x;
    if (c < cols && r < rows) {
      const size_t at = size_t(c) * rows + r;
      const float v = t[threadIdx.x][i];
      out[at] = v;
      out_lo[at] = tf32::lo_of(v);
      w1_lo[at] = tf32::lo_of(w1[at]);
    }
  }
}

// (b) h = gelu(hpre), dhpre = dh gelu'(hpre), hpre = xn W1^T + b1 (the
// stash) and dh = dmlp W2 (acc) on a consumer's 64 x 128 block;
// db1_part[row block, col] = its column sums of dhpre
struct DualArgs {
  const float* b1;
  float* h;
  float* dhpre;
  float* db1_part;
  int M, hidden;
};

struct EpiDual {
  using Args = DualArgs;
  static __device__ __forceinline__ void store(const Args& a, const float (&acc)[64],
                                               const float* stash, int row0, int col0,
                                               float* red) {
    const int t128 = threadIdx.x % 128, lane = t128 % 32;
    float cs[16][2];
#pragma unroll
    for (int j = 0; j < 16; ++j) cs[j][0] = cs[j][1] = 0.f;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row0 + tf32::frag_row(hh);
      if (row >= a.M) continue;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = col0 + tf32::frag_col(j), i0 = 4 * j + 2 * hh;
        const float2 b = *reinterpret_cast<const float2*>(a.b1 + col);
        const float v0 = stash[i0 * 128 + t128] + b.x, v1 = stash[(i0 + 1) * 128 + t128] + b.y;
        float p0, p1;
        const float c0 = gelu_cdf_pdf(v0, &p0), c1 = gelu_cdf_pdf(v1, &p1);
        const float d0 = acc[i0] * (c0 + v0 * p0), d1 = acc[i0 + 1] * (c1 + v1 * p1);
        const size_t at = size_t(row) * a.hidden + col;
        *reinterpret_cast<float2*>(a.h + at) = make_float2(v0 * c0, v1 * c1);
        *reinterpret_cast<float2*>(a.dhpre + at) = make_float2(d0, d1);
        cs[j][0] += d0;
        cs[j][1] += d1;
      }
    }
    // the warp's 16 rows (lanes of one lane % 4 share columns), then the
    // consumer's four warps in order
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        cs[j][e] += __shfl_xor_sync(0xffffffffu, cs[j][e], 4);
        cs[j][e] += __shfl_xor_sync(0xffffffffu, cs[j][e], 8);
        cs[j][e] += __shfl_xor_sync(0xffffffffu, cs[j][e], 16);
      }
    const int warp = t128 / 32, bar = 1 + threadIdx.x / 128;
    if (lane < 4) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        red[warp * 128 + tf32::frag_col(j)] = cs[j][0];
        red[warp * 128 + tf32::frag_col(j) + 1] = cs[j][1];
      }
    }
    tf32::named_sync(bar);
    if (row0 < a.M)
      a.db1_part[size_t(row0 / kRows) * a.hidden + col0 + t128] =
          ((red[t128] + red[128 + t128]) + red[256 + t128]) + red[384 + t128];
    tf32::named_sync(bar);  // `red` is free for the next tile
  }
};

// (c), (d) out + z split_stride = A B^T over split z's k-tiles, f32
// (M, N), rows < M and columns < N only
struct StoreArgs {
  float* out;
  long long split_stride;
  int M, N;
};

struct EpiStore {
  using Args = StoreArgs;
  static __device__ __forceinline__ void store(const Args& a, const float (&acc)[64], const float*,
                                               int row0, int col0, float*) {
    float* out = a.out + blockIdx.z * a.split_stride;
    tf32::for_pairs(acc, row0, col0, a.M, a.N, [&](int row, int col, float v0, float v1) {
      *reinterpret_cast<float2*>(out + size_t(row) * a.N + col) = make_float2(v0, v1);
    });
  }
};

// (e) dx and the column partials of a 64-row block (8 rows a warp, the
// warps' sums added in order): part[block] = (sum dyln xhat, sum dyln,
// sum gy keep)
template <int V>
__global__ void __launch_bounds__(256, 1)
    ln_bwd_kernel(const float* __restrict__ dyln, const float* __restrict__ x,
                  const float* __restrict__ gy, const float* __restrict__ gamma,
                  const float* __restrict__ keep, int rows_per_sample,
                  const float* __restrict__ stats, float* __restrict__ dx,
                  float* __restrict__ part, int M) {
  constexpr int C = 128 * V;
  __shared__ float4 red[3][C / 4];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const auto* g4 = reinterpret_cast<const float4*>(gamma);
  float4 acc[3][V];
#pragma unroll
  for (int t = 0; t < V; ++t) acc[0][t] = acc[1][t] = acc[2][t] = f4(0.f);
  for (int r = warp; r < kRows; r += 8) {
    const int row = blockIdx.x * kRows + r;
    if (row >= M) break;
    const size_t off = size_t(row) * C;
    const float2 st = reinterpret_cast<const float2*>(stats)[row];
    const float kp = keep != nullptr ? keep[row / rows_per_sample] : 1.f;
    const auto* x4 = reinterpret_cast<const float4*>(x + off);
    const auto* d4 = reinterpret_cast<const float4*>(dyln + off);
    float4 xh[V], dxh[V];
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int t = 0; t < V; ++t) {
      const int w = lane + 32 * t;
      const float4 xv = x4[w], d = d4[w], gm = g4[w];
      xh[t] = make_float4((xv.x - st.x) * st.y, (xv.y - st.x) * st.y, (xv.z - st.x) * st.y,
                          (xv.w - st.x) * st.y);
      dxh[t] = make_float4(d.x * gm.x, d.y * gm.y, d.z * gm.z, d.w * gm.w);
      m1 += (dxh[t].x + dxh[t].y) + (dxh[t].z + dxh[t].w);
      m2 += (dxh[t].x * xh[t].x + dxh[t].y * xh[t].y) + (dxh[t].z * xh[t].z + dxh[t].w * xh[t].w);
      acc[0][t].x += d.x * xh[t].x;
      acc[0][t].y += d.y * xh[t].y;
      acc[0][t].z += d.z * xh[t].z;
      acc[0][t].w += d.w * xh[t].w;
      acc[1][t].x += d.x;
      acc[1][t].y += d.y;
      acc[1][t].z += d.z;
      acc[1][t].w += d.w;
    }
    m1 = warp_sum(m1) / C;
    m2 = warp_sum(m2) / C;
    const auto* gy4 = reinterpret_cast<const float4*>(gy + off);
    auto* dx4 = reinterpret_cast<float4*>(dx + off);
#pragma unroll
    for (int t = 0; t < V; ++t) {
      const int w = lane + 32 * t;
      const float4 g = gy4[w];
      acc[2][t].x += g.x * kp;
      acc[2][t].y += g.y * kp;
      acc[2][t].z += g.z * kp;
      acc[2][t].w += g.w * kp;
      dx4[w] = make_float4(g.x + st.y * (dxh[t].x - m1 - xh[t].x * m2),
                           g.y + st.y * (dxh[t].y - m1 - xh[t].y * m2),
                           g.z + st.y * (dxh[t].z - m1 - xh[t].z * m2),
                           g.w + st.y * (dxh[t].w - m1 - xh[t].w * m2));
    }
  }
  for (int w = 0; w < 8; ++w) {
    if (warp == w) {
#pragma unroll
      for (int q = 0; q < 3; ++q)
#pragma unroll
        for (int t = 0; t < V; ++t) {
          float4& s = red[q][lane + 32 * t];
          const float4 prev = w == 0 ? f4(0.f) : s;
          s = make_float4(prev.x + acc[q][t].x, prev.y + acc[q][t].y, prev.z + acc[q][t].z,
                          prev.w + acc[q][t].w);
        }
    }
    __syncthreads();
  }
  const auto* flat = reinterpret_cast<const float*>(red);
  for (int i = threadIdx.x; i < 3 * C; i += 256)
    part[size_t(blockIdx.x) * 3 * C + i] = flat[i];
}

#define LAVT_K7F32_WIDTHS(X) X(128) X(256) X(384) X(512) X(1024)

inline bool ok(const void* p) { return p == nullptr || tf32::aligned16(p); }

cudaError_t prep(const void* x, const void* gy, const void* g, const void* be, const void* keep,
                 void* xn, void* stats, void* dmlp, int M, int C, int rows_per_sample, float eps,
                 cudaStream_t s) {
  if (M < 1 || rows_per_sample < 1 || !ok(x) || !ok(gy) || !ok(g) || !ok(be) || !ok(xn) ||
      !ok(dmlp) || (keep != nullptr && dmlp == nullptr))
    return cudaErrorInvalidValue;
  const int blocks = (M + 7) / 8;
  switch (C) {
#define LAVT_CASE(CC)                                                                          \
  case CC:                                                                                     \
    prep_kernel<CC / 128><<<blocks, 256, 0, s>>>(                                              \
        static_cast<const float*>(x), static_cast<const float*>(gy),                           \
        static_cast<const float*>(g), static_cast<const float*>(be),                           \
        static_cast<const float*>(keep), rows_per_sample, static_cast<float*>(xn),             \
        static_cast<float*>(stats), static_cast<float*>(dmlp), M, eps);                        \
    break;
    LAVT_K7F32_WIDTHS(LAVT_CASE)
#undef LAVT_CASE
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

cudaError_t dual(const void* xn, const void* dmlp, const void* w1, const void* b1, const void* w2,
                 void* w2t, void* h, void* dhpre, void* db1_part, int M, int C, int hidden,
                 cudaStream_t s) {
  if (M < 1 || C < tf32::kBK || C % tf32::kBK != 0 || hidden < tf32::kTile ||
      hidden % tf32::kTile != 0 || !ok(xn) || !ok(dmlp) || !ok(w1) || !ok(w2) || !ok(w2t) ||
      !ok(h) || !ok(dhpre) || w2t == nullptr)
    return cudaErrorInvalidValue;
  // w2t: W2's K-major copy, its lo parts and W1's, each (hidden, C)
  float* const copy = static_cast<float*>(w2t);
  float* const copy_lo = copy + size_t(hidden) * C;
  float* const w1_lo = copy_lo + size_t(hidden) * C;
  transpose_kernel<<<dim3((hidden + 31) / 32, (C + 31) / 32), dim3(32, 8), 0, s>>>(
      static_cast<const float*>(w2), copy, copy_lo, static_cast<const float*>(w1), w1_lo, C,
      hidden);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  tf32::Params<DualArgs> p{};
  err = tf32::map_operand(&p.a0, xn, M, C, false);
  if (err == cudaSuccess) err = tf32::map_operand(&p.b0, w1, hidden, C, false);
  if (err == cudaSuccess) err = tf32::map_operand(&p.b0_lo, w1_lo, hidden, C, false);
  if (err == cudaSuccess) err = tf32::map_operand(&p.a1, dmlp, M, C, false);
  if (err == cudaSuccess) err = tf32::map_operand(&p.b1, copy, hidden, C, false);
  if (err == cudaSuccess) err = tf32::map_operand(&p.b1_lo, copy_lo, hidden, C, false);
  if (err != cudaSuccess) return err;
  p.k_tiles = p.k_tiles_per_split = C / tf32::kBK;
  p.epi = DualArgs{static_cast<const float*>(b1), static_cast<float*>(h),
                   static_cast<float*>(dhpre), static_cast<float*>(db1_part), M, hidden};
  return tf32::launch<EpiDual, false, false, true>(p, M, hidden, 1, s);
}

// part + z stride = a[rows of split z]^T b[rows of split z]: a (M, na), b
// (M, nb) -> f32 (na, nb) per split; split z takes the 32-row k-tiles
// [z kps, (z + 1) kps), every split at least one
cudaError_t wgrad(const void* a, const void* b, void* part, int M, int na, int nb, int splits,
                  int kps, long long split_stride, cudaStream_t s) {
  const long long k_tiles = (M + tf32::kBK - 1) / tf32::kBK;
  if (M < 1 || na < 4 || na % 4 != 0 || nb < 4 || nb % 4 != 0 || splits < 1 || kps < 1 ||
      static_cast<long long>(splits - 1) * kps >= k_tiles ||
      static_cast<long long>(splits) * kps < k_tiles || !ok(a) || !ok(b) || !ok(part))
    return cudaErrorInvalidValue;
  tf32::Params<StoreArgs> p{};
  cudaError_t err = tf32::map_operand(&p.a0, a, na, M, true);
  if (err == cudaSuccess) err = tf32::map_operand(&p.b0, b, nb, M, true);
  if (err != cudaSuccess) return err;
  p.k_tiles = static_cast<int>(k_tiles);
  p.k_tiles_per_split = kps;
  p.epi = StoreArgs{static_cast<float*>(part), split_stride, na, nb};
  return tf32::launch<EpiStore, true, true, false>(p, na, nb, splits, s);
}

// dyln (M, C) = dhpre (M, hidden) W1 (hidden, C)
cudaError_t dgrad(const void* dhpre, const void* w1, void* dyln, int M, int C, int hidden,
                  cudaStream_t s) {
  if (M < 1 || C < 4 || C % 4 != 0 || hidden < tf32::kBK || hidden % tf32::kBK != 0 ||
      !ok(dhpre) || !ok(w1) || !ok(dyln))
    return cudaErrorInvalidValue;
  tf32::Params<StoreArgs> p{};
  cudaError_t err = tf32::map_operand(&p.a0, dhpre, M, hidden, false);
  if (err == cudaSuccess) err = tf32::map_operand(&p.b0, w1, C, hidden, true);
  if (err != cudaSuccess) return err;
  p.k_tiles = p.k_tiles_per_split = hidden / tf32::kBK;
  p.epi = StoreArgs{static_cast<float*>(dyln), 0, M, C};
  return tf32::launch<EpiStore, false, true, false>(p, M, C, 1, s);
}

cudaError_t ln_bwd(const void* dyln, const void* x, const void* gy, const void* g,
                   const void* keep, int rows_per_sample, const void* stats, void* dx,
                   void* part, int M, int C, cudaStream_t s) {
  if (M < 1 || rows_per_sample < 1 || !ok(dyln) || !ok(x) || !ok(gy) || !ok(g) || !ok(dx))
    return cudaErrorInvalidValue;
  const int blocks = (M + kRows - 1) / kRows;
  switch (C) {
#define LAVT_CASE(CC)                                                                          \
  case CC:                                                                                     \
    ln_bwd_kernel<CC / 128><<<blocks, 256, 0, s>>>(                                            \
        static_cast<const float*>(dyln), static_cast<const float*>(x),                         \
        static_cast<const float*>(gy), static_cast<const float*>(g),                           \
        static_cast<const float*>(keep), rows_per_sample, static_cast<const float*>(stats),   \
        static_cast<float*>(dx), static_cast<float*>(part), M);                                \
    break;
    LAVT_K7F32_WIDTHS(LAVT_CASE)
#undef LAVT_CASE
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace k7f32
}  // namespace lavt

// Each launch alone (for its test and its time), then K7 f32 as all of them;
// the signatures of the bf16 K7's entry points (csrc/fused_mlp_bwd.cu), on
// f32 tensors.  Without keep, dmlp is gy: prep writes no dmlp.
extern "C" int lavt_mlp_bwd_prep_f32(const void* x, const void* gy, const void* g, const void* be,
                                     const void* keep, void* xn, void* stats, void* dmlp, int M,
                                     int C, int rows_per_sample, float eps, void* stream) {
  return static_cast<int>(lavt::k7f32::prep(x, gy, g, be, keep, xn, stats, dmlp, M, C,
                                            rows_per_sample, eps,
                                            static_cast<cudaStream_t>(stream)));
}

// w2t: (3, hidden, C) f32 scratch: W2's K-major copy, its lo parts and W1's
extern "C" int lavt_dual_gemm_gelu_bwd_f32(const void* xn, const void* dmlp, const void* w1,
                                           const void* b1, const void* w2, void* h,
                                           void* dhpre, void* db1_part, void* w2t, int M, int C,
                                           int hidden, void* stream) {
  return static_cast<int>(lavt::k7f32::dual(xn, dmlp, w1, b1, w2, w2t, h, dhpre, db1_part, M,
                                            C, hidden, static_cast<cudaStream_t>(stream)));
}

extern "C" int lavt_wgrad_f32(const void* a, const void* b, void* part, int M, int na, int nb,
                              int splits, int k_tiles_per_split, void* stream) {
  return static_cast<int>(lavt::k7f32::wgrad(a, b, part, M, na, nb, splits, k_tiles_per_split,
                                             static_cast<long long>(na) * nb,
                                             static_cast<cudaStream_t>(stream)));
}

extern "C" int lavt_dgrad_f32(const void* dhpre, const void* w1, void* dyln, int M, int C,
                              int hidden, void* stream) {
  return static_cast<int>(
      lavt::k7f32::dgrad(dhpre, w1, dyln, M, C, hidden, static_cast<cudaStream_t>(stream)));
}

extern "C" int lavt_ln_bwd_rows_f32(const void* dyln, const void* x, const void* gy,
                                    const void* g, const void* keep, int rows_per_sample,
                                    const void* stats, void* dx, void* part, int M, int C,
                                    void* stream) {
  return static_cast<int>(lavt::k7f32::ln_bwd(dyln, x, gy, g, keep, rows_per_sample, stats, dx,
                                              part, M, C, static_cast<cudaStream_t>(stream)));
}

extern "C" int lavt_mlp_bwd_f32(const void* x, const void* gy, const void* g, const void* be,
                                const void* w1, const void* b1, const void* w2, const void* keep,
                                int rows_per_sample, void* xn, void* dmlp, void* h, void* dhpre,
                                void* dx, void* dyln, void* db1_part, void* dw_part,
                                void* ln_part, void* stats, void* w2t, int M, int C, int hidden,
                                int splits, int k_tiles_per_split, float eps, void* stream) {
  using namespace lavt::k7f32;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // dw_part: (splits, 2, hidden C), dW1 then dW2 (C, hidden) in each split
  const long long wsize = static_cast<long long>(hidden) * C;
  float* dw1 = static_cast<float*>(dw_part);
  const void* dm = keep != nullptr ? dmlp : gy;
  cudaError_t err = prep(x, gy, g, be, keep, xn, stats, dmlp, M, C, rows_per_sample, eps, s);
  if (err == cudaSuccess)
    err = dual(xn, dm, w1, b1, w2, w2t, h, dhpre, db1_part, M, C, hidden, s);
  if (err == cudaSuccess)
    err = wgrad(dm, h, dw1 + wsize, M, C, hidden, splits, k_tiles_per_split, 2 * wsize, s);
  if (err == cudaSuccess)
    err = wgrad(dhpre, xn, dw1, M, hidden, C, splits, k_tiles_per_split, 2 * wsize, s);
  if (err == cudaSuccess) err = dgrad(dhpre, w1, dyln, M, C, hidden, s);
  if (err == cudaSuccess)
    err = ln_bwd(dyln, x, gy, g, keep, rows_per_sample, stats, dx, ln_part, M, C, s);
  return static_cast<int>(err);
}
