// K1/K2: fused window multi-head self-attention (W-MSA / SW-MSA).
//
// Replaces lavt_rs_tpu/ops/pallas/fused_msa.py:_fwd_call/_kernel, reached
// from fused_window_msa_ln (K1, pre-attention LayerNorm fused in: the
// unpadded stages) and fused_window_msa (K2, no LayerNorm: the padded
// stages).  Per window of N = 144 tokens and per head (hd = 32):
//   [LN: f32 stats, fast variance E[x^2]-E[x]^2, eps inside rsqrt]
//   q = (x Wq^T + bq) * scale, k = x Wk^T + bk, v = x Wv^T + bv   (bf16)
//   P = softmax(q k^T + relbias[h] + mask[window mod nW])          (f32 -> bf16)
//   O[:, 32h:32h+32] = P v                                         (bf16)
// followed by the out-projection Y = O Wproj^T + bproj.
//
// Bound on the H100: at hd = 32 the per-head score matrices are the bulk
// of the work (2 N^2 hd flops per head, against 6 N C hd for the head's
// q/k/v), and unfused they cost (B nW h N N) f32 in device memory, ten
// times the activation.  Design: kernel 1 has one block per (window, head).
// It streams the window's x through shared memory in 64-column chunks
// (recomputing the row LN from per-row stats when LN is on), forms the
// head's q/k/v on the tensor cores (WMMA bf16 m16n16k16, f32 accumulate;
// 144 = 9 x 16), keeps the 144 x 144 scores in shared memory (85 KB, above
// the 48 KB default through cudaFuncSetAttribute), takes an exact
// max-subtracted softmax in f32, and writes the head's 32 columns of O.
// Scores and probabilities never reach device memory; O does, once, in
// bf16.  Kernel 2 is a tiled WMMA GEMM for the out-projection + bias.
// Shared memory is carved so that dead buffers are reused (the x and
// weight chunks and the q/k/v staging live in the score region before the
// scores do; the output staging reuses q and k): 109 KB, which lets two
// blocks (16 warps) share an SM and hide each other's load latency.
// Global loads and stores move 16 bytes per thread.  No TMA, no wgmma yet.

#include "common.cuh"

namespace lavt {

constexpr int kN = 144;     // window 12 x 12
constexpr int kHD = 32;     // head dim
constexpr int kKC = 64;     // x columns per chunk
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

constexpr int LDXC = kKC + 8;      // bf16 x chunk      (in the score region)
constexpr int LDW = kKC + 8;       // bf16 weight chunk (in the score region)
constexpr int LDST = 3 * kHD + 4;  // f32 q/k/v staging (in the score region)
constexpr int LDS = kN;            // f32 scores
constexpr int LDP = 2 * LDS;       // bf16 probabilities, in place of the scores
constexpr int LDQ = kHD;           // bf16 q, k, v
constexpr int LDOS = kHD;          // f32 output staging (in place of q and k)

constexpr size_t XC_BYTES = align128(size_t(kN) * LDXC * 2);
constexpr size_t WC_BYTES = align128(size_t(3 * kHD) * LDW * 2);
constexpr size_t Q_BYTES = align128(size_t(kN) * LDQ * 2);
constexpr size_t S_BYTES = align128(size_t(kN) * LDS * 4);
constexpr size_t ST_BYTES = align128(size_t(kN) * 2 * 4);
constexpr size_t MSA_SMEM = S_BYTES + 3 * Q_BYTES + ST_BYTES;
static_assert(XC_BYTES + WC_BYTES <= S_BYTES, "x and weight chunks fit the score region");
static_assert(size_t(kN) * LDST * 4 <= S_BYTES, "q/k/v staging fits the score region");
static_assert(size_t(kN) * LDOS * 4 <= 2 * Q_BYTES, "output staging fits q and k");
static_assert(MSA_SMEM <= 113 * 1024, "two blocks per SM");

constexpr int kQkvTiles = (kN / 16) * (3 * kHD / 16);  // 54
constexpr int kQkvPerWarp = (kQkvTiles + kWarps - 1) / kWarps;

__global__ void __launch_bounds__(kThreads, 2)
window_msa_attn_kernel(const bf16* __restrict__ x, const bf16* __restrict__ ln_g,
                       const bf16* __restrict__ ln_b, const bf16* __restrict__ wqkv,
                       const bf16* __restrict__ bqkv, const float* __restrict__ relbias,
                       const float* __restrict__ mask, bf16* __restrict__ o, int nW,
                       int C, float scale, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* ss = reinterpret_cast<float*>(smem);
  bf16* xc = reinterpret_cast<bf16*>(smem);
  bf16* wc = reinterpret_cast<bf16*>(smem + XC_BYTES);
  bf16* qs = reinterpret_cast<bf16*>(smem + S_BYTES);
  bf16* ks = reinterpret_cast<bf16*>(smem + S_BYTES + Q_BYTES);
  bf16* vs = reinterpret_cast<bf16*>(smem + S_BYTES + 2 * Q_BYTES);
  float* os = reinterpret_cast<float*>(qs);
  float* stats = reinterpret_cast<float*>(smem + S_BYTES + 3 * Q_BYTES);

  const int win = blockIdx.x, h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bf16* xw = x + static_cast<size_t>(win) * kN * C;
  const bool has_ln = ln_g != nullptr;

  // 1. per-row LayerNorm statistics (fast variance, as the TPU kernel)
  if (has_ln) {
    for (int r = warp; r < kN; r += kWarps) {
      float s = 0.f, s2 = 0.f;
      for (int c = lane; c < C; c += 32) {
        const float v = to_f(xw[static_cast<size_t>(r) * C + c]);
        s += v;
        s2 += v * v;
      }
      s = warp_sum(s);
      s2 = warp_sum(s2);
      if (lane == 0) {
        const float mu = s / C;
        stats[2 * r] = mu;
        stats[2 * r + 1] = rsqrtf(s2 / C - mu * mu + eps);
      }
    }
    __syncthreads();
  }

  // 2. q/k/v of head h: (144 x C) . (C x 96), x streamed in 64-col chunks
  FragC acc[kQkvPerWarp];
#pragma unroll
  for (int i = 0; i < kQkvPerWarp; ++i) wmma::fill_fragment(acc[i], 0.f);
  for (int k0 = 0; k0 < C; k0 += kKC) {
    for (int i = threadIdx.x; i < kN * kKC / 8; i += kThreads) {
      const int r = i / (kKC / 8), c = (i % (kKC / 8)) * 8;
      Pack8 v;
      v.u = *reinterpret_cast<const uint4*>(xw + static_cast<size_t>(r) * C + k0 + c);
      if (has_ln) {
        Pack8 g, b;
        g.u = *reinterpret_cast<const uint4*>(ln_g + k0 + c);
        b.u = *reinterpret_cast<const uint4*>(ln_b + k0 + c);
        const float mu = stats[2 * r], rstd = stats[2 * r + 1];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 xv = __bfloat1622float2(v.h[e]);
          const float2 gv = __bfloat1622float2(g.h[e]);
          const float2 bv = __bfloat1622float2(b.h[e]);
          v.h[e] = __floats2bfloat162_rn((xv.x - mu) * rstd * gv.x + bv.x,
                                         (xv.y - mu) * rstd * gv.y + bv.y);
        }
      }
      *reinterpret_cast<uint4*>(xc + r * LDXC + c) = v.u;
    }
    for (int i = threadIdx.x; i < 3 * kHD * kKC / 8; i += kThreads) {
      const int j = i / (kKC / 8), c = (i % (kKC / 8)) * 8;
      const int part = j / kHD, d = j % kHD;
      *reinterpret_cast<uint4*>(wc + j * LDW + c) = *reinterpret_cast<const uint4*>(
          wqkv + static_cast<size_t>(part * C + h * kHD + d) * C + k0 + c);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kKC; kk += 16) {
#pragma unroll
      for (int i = 0; i < kQkvPerWarp; ++i) {
        const int t = warp + kWarps * i;
        if (t < kQkvTiles) {
          const int r = t / 6, c = t % 6;
          FragA a;
          FragBCol b;
          wmma::load_matrix_sync(a, xc + r * 16 * LDXC + kk, LDXC);
          wmma::load_matrix_sync(b, wc + c * 16 * LDW + kk, LDW);
          wmma::mma_sync(acc[i], a, b, acc[i]);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kQkvPerWarp; ++i) {
    const int t = warp + kWarps * i;
    if (t < kQkvTiles) {
      const int r = t / 6, c = t % 6;
      wmma::store_matrix_sync(ss + r * 16 * LDST + c * 16, acc[i], LDST, wmma::mem_row_major);
    }
  }
  __syncthreads();
  // + bias; q scaled after its bias; bf16 like the TPU kernel's resident q/k/v
  for (int i = threadIdx.x; i < kN * 3 * kHD; i += kThreads) {
    const int r = i / (3 * kHD), j = i % (3 * kHD);
    const int part = j / kHD, d = j % kHD;
    const float v = ss[r * LDST + j] + to_f(bqkv[part * C + h * kHD + d]);
    if (part == 0) qs[r * LDQ + d] = to_bf(v * scale);
    else if (part == 1) ks[r * LDQ + d] = to_bf(v);
    else vs[r * LDQ + d] = to_bf(v);
  }
  __syncthreads();

  // 3. scores S = q k^T (f32, shared memory)
  for (int t = warp; t < 81; t += kWarps) {
    const int r = t / 9, c = t % 9;
    FragC s;
    wmma::fill_fragment(s, 0.f);
#pragma unroll
    for (int kk = 0; kk < kHD; kk += 16) {
      FragA a;
      FragBCol b;
      wmma::load_matrix_sync(a, qs + r * 16 * LDQ + kk, LDQ);
      wmma::load_matrix_sync(b, ks + c * 16 * LDQ + kk, LDQ);
      wmma::mma_sync(s, a, b, s);
    }
    wmma::store_matrix_sync(ss + r * 16 * LDS + c * 16, s, LDS, wmma::mem_row_major);
  }
  __syncthreads();

  // 4. + relative bias + shift mask, exact max-subtracted softmax; each
  //    warp owns whole rows and writes the bf16 probabilities over the
  //    first half of the row's own f32 storage (read fully first)
  const float* bias_h = relbias + static_cast<size_t>(h) * kN * kN;
  const float* mask_w = mask ? mask + static_cast<size_t>(win % nW) * kN * kN : nullptr;
  bf16* ps = reinterpret_cast<bf16*>(ss);
  for (int r = warp; r < kN; r += kWarps) {
    float v[5];
    float m = -3.0e38f;
#pragma unroll
    for (int t = 0; t < 5; ++t) {
      const int j = lane + 32 * t;
      if (j < kN) {
        float s = ss[r * LDS + j] + bias_h[r * kN + j];
        if (mask_w) s += mask_w[r * kN + j];
        v[t] = s;
        m = fmaxf(m, s);
      }
    }
    m = warp_max(m);
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < 5; ++t) {
      const int j = lane + 32 * t;
      v[t] = j < kN ? expf(v[t] - m) : 0.f;
      sum += v[t];
    }
    sum = warp_sum(sum);
    __syncwarp();
#pragma unroll
    for (int t = 0; t < 5; ++t) {
      const int j = lane + 32 * t;
      if (j < kN) ps[r * LDP + j] = to_bf(v[t] / sum);
    }
  }
  __syncthreads();

  // 5. O = P v (144 x 32), then the head's 32 columns to device memory
  for (int t = warp; t < 18; t += kWarps) {
    const int r = t / 2, c = t % 2;
    FragC acc_o;
    wmma::fill_fragment(acc_o, 0.f);
#pragma unroll
    for (int kk = 0; kk < kN; kk += 16) {
      FragA a;
      FragBRow b;
      wmma::load_matrix_sync(a, ps + r * 16 * LDP + kk, LDP);
      wmma::load_matrix_sync(b, vs + kk * LDQ + c * 16, LDQ);
      wmma::mma_sync(acc_o, a, b, acc_o);
    }
    wmma::store_matrix_sync(os + r * 16 * LDOS + c * 16, acc_o, LDOS, wmma::mem_row_major);
  }
  __syncthreads();
  bf16* ow = o + static_cast<size_t>(win) * kN * C + h * kHD;
  for (int i = threadIdx.x; i < kN * kHD / 8; i += kThreads) {
    const int r = i / (kHD / 8), d = (i % (kHD / 8)) * 8;
    const float* src = os + r * LDOS + d;
    Pack8 v;
#pragma unroll
    for (int e = 0; e < 4; ++e) v.h[e] = __floats2bfloat162_rn(src[2 * e], src[2 * e + 1]);
    *reinterpret_cast<uint4*>(ow + static_cast<size_t>(r) * C + d) = v.u;
  }
}

// Y (M x N) = A (M x K) . W^T + bias, W (N x K) row-major (a torch Linear
// weight).  64 x 64 block tile, four warps of 32 x 32, K in steps of 32.
constexpr int kGT = 64, kGK = 32, kGLD = kGK + 8, kGLDC = kGT + 4;

__global__ void __launch_bounds__(128)
linear_bias_kernel(const bf16* __restrict__ a, const bf16* __restrict__ w,
                   const bf16* __restrict__ bias, bf16* __restrict__ y, int M, int N,
                   int K) {
  __shared__ __align__(128) bf16 as[kGT * kGLD];
  __shared__ __align__(128) bf16 ws[kGT * kGLD];
  __shared__ __align__(128) float cs[kGT * kGLDC];
  const int bm = blockIdx.y * kGT, bn = blockIdx.x * kGT;
  const int warp = threadIdx.x >> 5, wr = warp / 2, wcol = warp % 2;
  FragC acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  for (int k0 = 0; k0 < K; k0 += kGK) {
    for (int i = threadIdx.x; i < kGT * kGK; i += 128) {
      const int r = i / kGK, c = i % kGK;
      as[r * kGLD + c] = bm + r < M ? a[static_cast<size_t>(bm + r) * K + k0 + c] : to_bf(0.f);
      ws[r * kGLD + c] = w[static_cast<size_t>(bn + r) * K + k0 + c];
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kGK; kk += 16) {
      FragA fa[2];
      FragBCol fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], as + (wr * 32 + i * 16) * kGLD + kk, kGLD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], ws + (wcol * 32 + j * 16) * kGLD + kk, kGLD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(cs + (wr * 32 + i * 16) * kGLDC + wcol * 32 + j * 16,
                              acc[i][j], kGLDC, wmma::mem_row_major);
  __syncthreads();
  for (int i = threadIdx.x; i < kGT * kGT; i += 128) {
    const int r = i / kGT, c = i % kGT;
    if (bm + r < M)
      y[static_cast<size_t>(bm + r) * N + bn + c] = to_bf(cs[r * kGLDC + c] + to_f(bias[bn + c]));
  }
}

}  // namespace lavt

extern "C" int lavt_window_msa_attn(const void* x, const void* ln_g, const void* ln_b,
                                    const void* wqkv, const void* bqkv,
                                    const void* relbias, const void* mask, void* o,
                                    int Bw, int nW, int C, int heads, float scale,
                                    float eps, void* stream) {
  using namespace lavt;
  cudaError_t err = allow_smem(window_msa_attn_kernel, MSA_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(window_msa_attn_kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  window_msa_attn_kernel<<<dim3(Bw, heads), kThreads, MSA_SMEM,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(ln_g),
      static_cast<const bf16*>(ln_b), static_cast<const bf16*>(wqkv),
      static_cast<const bf16*>(bqkv), static_cast<const float*>(relbias),
      static_cast<const float*>(mask), static_cast<bf16*>(o), nW, C, scale, eps);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lavt_linear_bias(const void* a, const void* w, const void* bias, void* y,
                                int M, int N, int K, void* stream) {
  using namespace lavt;
  dim3 grid(N / kGT, (M + kGT - 1) / kGT);
  linear_bias_kernel<<<grid, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(w),
      static_cast<const bf16*>(bias), static_cast<bf16*>(y), M, N, K);
  return static_cast<int>(cudaGetLastError());
}
