// K1/K2/K11: fused window multi-head self-attention (W-MSA / SW-MSA).
//
// Replaces lavt_rs_tpu/ops/pallas/fused_msa.py:_fwd_call/_kernel, reached
// from fused_window_msa_ln (K1, pre-attention LayerNorm fused in: the
// unpadded stages) and fused_window_msa (K2, no LayerNorm: the padded
// stages in training; at inference they take K11, below).  Per window of N = 144 tokens and per head (hd = 32):
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
// bf16.  The out-projection + bias then runs on the WMMA GEMM of
// fused_msa_bwd.cu (gemm_bf16, bias epilogue).  C is any multiple of 32
// (C = 32 heads: 96 at Swin-T/S stage 1, up to 1536 at Swin-L stage 4);
// the GEMM zero-fills its 64-column tiles past C.
// Shared memory is carved so that dead buffers are reused (the x and
// weight chunks and the q/k/v staging live in the score region before the
// scores do; the output staging reuses q and k): 109 KB, which lets two
// blocks (16 warps) share an SM and hide each other's load latency.
// Global loads and stores move 16 bytes per thread.  No TMA, no wgmma yet.
//
// K11 (map order): the same kernel reads its window straight out of a
// padded, pre-rolled (B, Hp, Wp, C) feature map and writes the head's 32
// columns of O back at the same map positions, so the partition and the
// reverse copies around the MSA disappear.  Replaces
// lavt_rs_tpu/ops/pallas/experimental.py:_fwd_2d/_kernel_2d, whose
// in-kernel window slices Mosaic rejects on the TPU; on Hopper they are
// address arithmetic.  A window (b, wy, wx) is 12 runs of 12 C contiguous
// bf16 (token 12 i + j at ((b Hp + 12 wy + i) Wp + 12 wx + j) C), so the
// 16-byte loads stay aligned for C a multiple of 8.  The layout is a
// template parameter: the window-order path (K1/K2) compiles to the same
// code as before.  The out-projection is per token, so the GEMM that
// follows runs on O viewed as (B Hp Wp, C) and writes the map directly.
// The shift mask is indexed by the window's place in the image,
// wy (Wp/12) + wx, which is window mod nW in both layouts.
//
// Save mode (training): with q_out non-null the kernel also writes the
// training residuals that the backward (fused_msa_bwd.cu, K5) consumes, as
// the TPU kernel's save=True does: q (post-scale), k and v in bf16 as
// (B nW, N, C) with lanes in head order, the bf16 probabilities P the
// output was made from as (B nW, heads, N, N), and, with LN on, the bf16
// normalized tokens xn (written by the head-0 block of each window).

#include "common.cuh"

namespace lavt {

constexpr int kWS = 12;     // window side
constexpr int kN = kWS * kWS;  // tokens per window
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

// kMap false: x and o are (B nW, N, C) windowed tokens (K1/K2).  kMap
// true: x and o are (B, Hp, Wp, C) maps with nWw = Wp / 12 windows per row
// and nW / nWw per column (K11; no LN, no save mode).
template <bool kMap>
__global__ void __launch_bounds__(kThreads, 2)
window_msa_attn_kernel(const bf16* __restrict__ x, const bf16* __restrict__ ln_g,
                       const bf16* __restrict__ ln_b, const bf16* __restrict__ wqkv,
                       const bf16* __restrict__ bqkv, const float* __restrict__ relbias,
                       const float* __restrict__ mask, bf16* __restrict__ o,
                       bf16* __restrict__ q_out, bf16* __restrict__ k_out,
                       bf16* __restrict__ v_out, bf16* __restrict__ p_out,
                       bf16* __restrict__ xn_out, int nW, int nWw, int C, float scale,
                       float eps) {
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
  // the window's first token, and the offset of token r from it
  size_t base;
  size_t ld_run = 0;  // map order: elements between the window's 12 runs
  if constexpr (kMap) {
    const int b = win / nW, w = win % nW, wy = w / nWw, wx = w % nWw;
    ld_run = static_cast<size_t>(nWw) * kWS * C;
    base = (static_cast<size_t>(b) * (nW / nWw) + wy) * kWS * ld_run +
           static_cast<size_t>(wx) * kWS * C;
  } else {
    base = static_cast<size_t>(win) * kN * C;
  }
  auto tok = [&](int r) -> size_t {
    if constexpr (kMap) return (r / kWS) * ld_run + static_cast<size_t>(r % kWS) * C;
    else return static_cast<size_t>(r) * C;
  };
  const bf16* xw = x + base;
  const bool has_ln = ln_g != nullptr;

  // 1. per-row LayerNorm statistics (fast variance, as the TPU kernel)
  if (has_ln) {
    for (int r = warp; r < kN; r += kWarps) {
      float s = 0.f, s2 = 0.f;
      for (int c = lane; c < C; c += 32) {
        const float v = to_f(xw[tok(r) + c]);
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
  //    (C a multiple of 32: the last chunk may be a 32-column tail, e.g.
  //    C = 96 at Swin-T/S stage 1)
  FragC acc[kQkvPerWarp];
#pragma unroll
  for (int i = 0; i < kQkvPerWarp; ++i) wmma::fill_fragment(acc[i], 0.f);
  for (int k0 = 0; k0 < C; k0 += kKC) {
    const int kc = min(kKC, C - k0);
    for (int i = threadIdx.x; i < kN * kc / 8; i += kThreads) {
      const int r = i / (kc / 8), c = (i % (kc / 8)) * 8;
      Pack8 v;
      v.u = *reinterpret_cast<const uint4*>(xw + tok(r) + k0 + c);
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
      if (xn_out != nullptr && h == 0)
        *reinterpret_cast<uint4*>(xn_out + (static_cast<size_t>(win) * kN + r) * C + k0 + c) =
            v.u;
    }
    for (int i = threadIdx.x; i < 3 * kHD * kc / 8; i += kThreads) {
      const int j = i / (kc / 8), c = (i % (kc / 8)) * 8;
      const int part = j / kHD, d = j % kHD;
      *reinterpret_cast<uint4*>(wc + j * LDW + c) = *reinterpret_cast<const uint4*>(
          wqkv + static_cast<size_t>(part * C + h * kHD + d) * C + k0 + c);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kKC; kk += 16) {
      if (kk >= kc) break;
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
  if (q_out != nullptr) {  // save mode: the head's q/k/v columns
    for (int i = threadIdx.x; i < 3 * kN * (kHD / 8); i += kThreads) {
      const int t = i / (kN * (kHD / 8)), r = (i / (kHD / 8)) % kN, d = (i % (kHD / 8)) * 8;
      const bf16* src = (t == 0 ? qs : t == 1 ? ks : vs) + r * LDQ + d;
      bf16* dst = t == 0 ? q_out : t == 1 ? k_out : v_out;
      *reinterpret_cast<uint4*>(dst + (static_cast<size_t>(win) * kN + r) * C + h * kHD + d) =
          *reinterpret_cast<const uint4*>(src);
    }
  }

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
  bf16* p_win = p_out ? p_out + (static_cast<size_t>(win) * gridDim.y + h) * kN * kN : nullptr;
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
      if (j < kN) {
        const bf16 pb = to_bf(v[t] / sum);
        ps[r * LDP + j] = pb;
        if (p_win) p_win[r * kN + j] = pb;
      }
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
  bf16* ow = o + base + h * kHD;
  for (int i = threadIdx.x; i < kN * kHD / 8; i += kThreads) {
    const int r = i / (kHD / 8), d = (i % (kHD / 8)) * 8;
    const float* src = os + r * LDOS + d;
    Pack8 v;
#pragma unroll
    for (int e = 0; e < 4; ++e) v.h[e] = __floats2bfloat162_rn(src[2 * e], src[2 * e + 1]);
    *reinterpret_cast<uint4*>(ow + tok(r) + d) = v.u;
  }
}

template <bool kMap>
static cudaError_t prepare_msa_attn() {
  cudaError_t err = allow_smem(window_msa_attn_kernel<kMap>, MSA_SMEM);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(window_msa_attn_kernel<kMap>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

}  // namespace lavt

extern "C" int lavt_window_msa_attn(const void* x, const void* ln_g, const void* ln_b,
                                    const void* wqkv, const void* bqkv,
                                    const void* relbias, const void* mask, void* o,
                                    void* q_out, void* k_out, void* v_out, void* p_out,
                                    void* xn_out, int Bw, int nW, int C, int heads,
                                    float scale, float eps, void* stream) {
  using namespace lavt;
  cudaError_t err = prepare_msa_attn<false>();
  if (err != cudaSuccess) return static_cast<int>(err);
  window_msa_attn_kernel<false><<<dim3(Bw, heads), kThreads, MSA_SMEM,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(ln_g),
      static_cast<const bf16*>(ln_b), static_cast<const bf16*>(wqkv),
      static_cast<const bf16*>(bqkv), static_cast<const float*>(relbias),
      static_cast<const float*>(mask), static_cast<bf16*>(o), static_cast<bf16*>(q_out),
      static_cast<bf16*>(k_out), static_cast<bf16*>(v_out), static_cast<bf16*>(p_out),
      static_cast<bf16*>(xn_out), nW, 1, C, scale, eps);
  return static_cast<int>(cudaGetLastError());
}

// K11: x and o are (B, Hp, Wp, C) bf16 maps, Hp and Wp multiples of 12;
// mask (nW, N, N) f32 with nW = (Hp / 12)(Wp / 12), or null.
extern "C" int lavt_window_msa_2d_attn(const void* x, const void* wqkv, const void* bqkv,
                                       const void* relbias, const void* mask, void* o,
                                       int B, int Hp, int Wp, int C, int heads,
                                       float scale, void* stream) {
  using namespace lavt;
  if (Hp % kWS || Wp % kWS || Hp <= 0 || Wp <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = prepare_msa_attn<true>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nWw = Wp / kWS, nW = (Hp / kWS) * nWw;
  window_msa_attn_kernel<true><<<dim3(B * nW, heads), kThreads, MSA_SMEM,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), nullptr, nullptr, static_cast<const bf16*>(wqkv),
      static_cast<const bf16*>(bqkv), static_cast<const float*>(relbias),
      static_cast<const float*>(mask), static_cast<bf16*>(o), nullptr, nullptr, nullptr,
      nullptr, nullptr, nW, nWw, C, scale, 0.f);
  return static_cast<int>(cudaGetLastError());
}
