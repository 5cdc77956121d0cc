// K10: attention-only window attention on pre-projected heads, and K2p:
// the fused window MSA (qkv in the kernel) on sublane-padded windows.
//
// K10 replaces lavt_rs_tpu/ops/pallas/window_attn.py:_fwd/_fwd_kernel
// (reached from window_attention_pallas): per window and head,
//   O = softmax(q k^T + relbias[h] + mask[window]) v
// with q scaled and rounded to bf16, the scores, bias, mask and softmax in
// f32 with max subtraction, and O rounded to bf16.  q, k, v, O are
// (B, nW, heads, N, 32); any N <= 400 (video windows 392 and 196,
// window-7 49).
//
// K2p replaces lavt_rs_tpu/ops/pallas/fused_msa.py:_fwd_call/_kernel at
// the sublane-padded token count (fused_window_msa_padded and the grouped
// 3D route of models/swin3d.py): x is (B nW, n_p, C) with n_p a multiple
// of 16 (392 -> 400), the bias carries -1e9 on the padded key columns, and
// the block computes the head's q/k/v from x and Wqkv itself (WMMA, f32
// accumulation, + bias, q scaled after its bias, rounded to bf16) before
// the same attention; O goes to the head's 32 columns of (B nW, n_p, C).
// The out-projection then runs on the WMMA GEMM of fused_msa_bwd.cu.
//
// Masks: windows are numbered per image (win mod nW); the first nu of
// them take no mask and window wi >= nu takes mask[wi - nu].  nu = 0 with
// a full (nW, N, N) mask, nu = nW without one, and in between for the
// grouped 3D partition (unmasked windows first, boundary windows last with
// a small mask), so a shifted block is one launch.
//
// Bound on the H100: 4 N^2 hd flops per window and head (plus 6 N C hd for
// K2p's q/k/v) against q/k/v/O, the f32 bias and the f32 mask in device
// memory; at N = 392 the mask (nW N^2 f32) is as large as q/k/v/O together.
// Design: one block per (head, window) -- the head varies fastest, so the
// blocks of one window run together and share its mask rows in L2 --
// holds the head's k and v (and for K2p q) in shared memory, rows zero-
// filled up to N rounded to 16.  Each warp owns 16 query rows at a time
// and walks the keys 64 at a time with mma.sync m16n8k16 (bf16 in, f32
// accumulation): the scores stay in registers, the bias and mask are read
// straight from L2 into them (8-byte loads, whole 32-byte sectors), and an
// online softmax (running max and sum per row, O rescaled) turns them into
// bf16 probabilities that feed P v from registers; O is divided by the row
// sum at the end.  No score tile in shared memory: K10 takes 64 KB and K2p
// 109 KB, two blocks per SM.  K10 may split a window's query rows over
// grid.z to fill the card when windows x heads are few.
// No TMA, no wgmma yet.

#include <cstdint>

#include "common.cuh"

namespace lavt {
namespace wattn {

constexpr int kHD = 32;          // head dim
constexpr int kNMax = 400;       // largest window (video 392, sublane-padded)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kKB = 64;          // keys per online-softmax step
constexpr int kTQ = 64;          // K2p: rows per q/k/v projection step

constexpr int LDH = kHD + 8;     // bf16 q/k/v rows (80 bytes: conflict-free)
constexpr int LDE = 16 + 4;      // per-warp f32 16 x 16 staging
constexpr int LDX = 32 + 8;      // K2p: bf16 x and weight chunks of 32 columns

constexpr size_t HEAD_BYTES = align128(size_t(kNMax) * LDH * 2);
constexpr size_t XC_BYTES = align128(size_t(kTQ) * LDX * 2);
constexpr size_t WC_BYTES = align128(size_t(3 * kHD) * LDX * 2);
constexpr size_t E_BYTES = align128(size_t(kWarps) * 16 * LDE * 4);
constexpr size_t SMEM_K10 = 2 * HEAD_BYTES;
constexpr size_t SMEM_K2P = 3 * HEAD_BYTES + XC_BYTES + WC_BYTES;
static_assert(E_BYTES <= XC_BYTES + WC_BYTES, "the staging tiles fit the chunk region");
static_assert(2 * (SMEM_K2P + 1024) <= 228 * 1024, "two K2p blocks per SM");

constexpr int kProjTiles = (kTQ / 16) * (3 * kHD / 16);  // 24 per row group
constexpr int kProjPerWarp = (kProjTiles + kWarps - 1) / kWarps;

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

__device__ __forceinline__ float neg_inf() { return __int_as_float(static_cast<int>(0xff800000u)); }

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

// One warp: O rows [r0, r0 + 16) of one (window, head).  qa holds the rows'
// scaled q as A fragments (two k16 halves of hd = 32); ks / vs the keys
// and values in shared memory, zero rows up to n rounded to 16.
__device__ void attend16(const uint32_t (&qa)[2][4], const bf16* ks, const bf16* vs, int n,
                         int r0, const float* __restrict__ bias_h,
                         const float* __restrict__ mask_w, bf16* __restrict__ out, int ldo) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const int n16 = (n + 15) & ~15;
  const int ra = r0 + g, rb = ra + 8;  // this thread's two rows
  // rows past n read row 0's bias (finite) and are never written
  const size_t oa = static_cast<size_t>(ra < n ? ra : 0) * n;
  const size_t ob = static_cast<size_t>(rb < n ? rb : 0) * n;
  float o[4][4];
#pragma unroll
  for (int d = 0; d < 4; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  float m[2] = {neg_inf(), neg_inf()}, l[2] = {0.f, 0.f};

  for (int kb = 0; kb < n16; kb += kKB) {
    // S = q k^T for 64 keys (8 tiles of 8; n16 - kb is a multiple of 16)
    float s[8][4];
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.f;
      if (kb + t * 8 < n16) {
        const bf16* kr = ks + (kb + t * 8 + g) * LDH + tq * 2;
        mma16816(s[t], qa[0], ld32(kr), ld32(kr + 8));
        mma16816(s[t], qa[1], ld32(kr + 16), ld32(kr + 24));
      }
    }
    // + bias + mask; keys past n drop out; the rows' new maxima
    float mx[2] = {neg_inf(), neg_inf()};
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const int c = kb + t * 8 + tq * 2;
      if (kb + t * 8 < n16) {
        float2 ba = ld_pair(bias_h + oa, c, n), bb = ld_pair(bias_h + ob, c, n);
        if (mask_w != nullptr) {
          const float2 ma = ld_pair(mask_w + oa, c, n), mb = ld_pair(mask_w + ob, c, n);
          ba.x += ma.x, ba.y += ma.y, bb.x += mb.x, bb.y += mb.y;
        }
        s[t][0] = c < n ? s[t][0] + ba.x : neg_inf();
        s[t][1] = c + 1 < n ? s[t][1] + ba.y : neg_inf();
        s[t][2] = c < n ? s[t][2] + bb.x : neg_inf();
        s[t][3] = c + 1 < n ? s[t][3] + bb.y : neg_inf();
      } else {
        s[t][0] = s[t][1] = s[t][2] = s[t][3] = neg_inf();
      }
      mx[0] = fmaxf(mx[0], fmaxf(s[t][0], s[t][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[t][2], s[t][3]));
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float mn = fmaxf(m[i], mx[i]);  // finite: key 0 is always real
      alpha[i] = __expf(m[i] - mn);
      m[i] = mn;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      o[d][0] *= alpha[0], o[d][1] *= alpha[0];
      o[d][2] *= alpha[1], o[d][3] *= alpha[1];
    }
    // P = exp(S - m) (bf16 A fragments, 16 keys each), O += P v
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (kb + j * 16 < n16) {
        float p[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          p[h][0] = __expf(s[2 * j + h][0] - m[0]);
          p[h][1] = __expf(s[2 * j + h][1] - m[0]);
          p[h][2] = __expf(s[2 * j + h][2] - m[1]);
          p[h][3] = __expf(s[2 * j + h][3] - m[1]);
          l[0] += p[h][0] + p[h][1];
          l[1] += p[h][2] + p[h][3];
        }
        const uint32_t pa[4] = {pack_bf2(p[0][0], p[0][1]), pack_bf2(p[0][2], p[0][3]),
                                pack_bf2(p[1][0], p[1][1]), pack_bf2(p[1][2], p[1][3])};
        const bf16* vr = vs + (kb + j * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDH +
                         (lane >> 4) * 8;
#pragma unroll
        for (int dp = 0; dp < 2; ++dp) {
          uint32_t vb[4];
          ldsm_x4_trans(vb, vr + dp * 16);
          mma16816(o[2 * dp], pa, vb[0], vb[1]);
          mma16816(o[2 * dp + 1], pa, vb[2], vb[3]);
        }
      }
    }
  }
  // O / row sum, bf16
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] = 1.f / l[i];
  }
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    const int c = d * 8 + tq * 2;
    if (ra < n)
      *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(ra) * ldo + c) =
          pack_bf2(o[d][0] * l[0], o[d][1] * l[0]);
    if (rb < n)
      *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(rb) * ldo + c) =
          pack_bf2(o[d][2] * l[1], o[d][3] * l[1]);
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

// K10: grid (heads, B nW, query splits)
__global__ void __launch_bounds__(kThreads, 2)
window_attn_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const float* __restrict__ bias,
                   const float* __restrict__ mask, bf16* __restrict__ o, int nW, int nu, int n,
                   float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = reinterpret_cast<bf16*>(smem + HEAD_BYTES);

  const int h = blockIdx.x, heads = gridDim.x, win = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const size_t base = (static_cast<size_t>(win) * heads + h) * n * kHD;
  stage_head(ks, k + base, n);
  stage_head(vs, v + base, n);
  __syncthreads();
  const int wi = win % nW;
  const float* mask_w =
      (mask != nullptr && wi >= nu) ? mask + static_cast<size_t>(wi - nu) * n * n : nullptr;
  const float* bias_h = bias + static_cast<size_t>(h) * n * n;
  const int groups = (n + 15) / 16;
  for (int gi = blockIdx.z * kWarps + warp; gi < groups; gi += gridDim.z * kWarps) {
    uint32_t qa[2][4];
    load_qa(qa, q + base, kHD, gi * 16, n);
#pragma unroll
    for (int kc = 0; kc < 2; ++kc)
#pragma unroll
      for (int e = 0; e < 4; ++e) qa[kc][e] = scale_bf2(qa[kc][e], scale);
    attend16(qa, ks, vs, n, gi * 16, bias_h, mask_w, o + base, kHD);
  }
}

// K2p: grid (heads, B nW); x (B nW, n, C), n a multiple of 16
__global__ void __launch_bounds__(kThreads, 2)
window_msa_np_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wqkv,
                     const bf16* __restrict__ bqkv, const float* __restrict__ bias,
                     const float* __restrict__ mask, bf16* __restrict__ o, int nW, int nu, int n,
                     int C, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = reinterpret_cast<bf16*>(smem + HEAD_BYTES);
  bf16* vs = reinterpret_cast<bf16*>(smem + 2 * HEAD_BYTES);
  bf16* xc = reinterpret_cast<bf16*>(smem + 3 * HEAD_BYTES);
  bf16* wc = reinterpret_cast<bf16*>(smem + 3 * HEAD_BYTES + XC_BYTES);
  float* es = reinterpret_cast<float*>(xc);  // after the chunks of a row group

  const int h = blockIdx.x, win = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bf16* xw = x + static_cast<size_t>(win) * n * C;
  float* e = es + warp * 16 * LDE;

  // 1. q/k/v of head h, 64 rows at a time: (64 x C) . (C x 96), C in
  //    chunks of 32 columns
  for (int g0 = 0; g0 < n; g0 += kTQ) {
    const int rg = min(kTQ, n - g0) / 16;
    FragC acc[kProjPerWarp];
#pragma unroll
    for (int i = 0; i < kProjPerWarp; ++i) wmma::fill_fragment(acc[i], 0.f);
    for (int k0 = 0; k0 < C; k0 += 32) {
      for (int i = threadIdx.x; i < rg * 16 * 4; i += kThreads) {
        const int r = i / 4, c = (i % 4) * 8;
        *reinterpret_cast<uint4*>(xc + r * LDX + c) = *reinterpret_cast<const uint4*>(
            xw + static_cast<size_t>(g0 + r) * C + k0 + c);
      }
      for (int i = threadIdx.x; i < 3 * kHD * 4; i += kThreads) {
        const int j = i / 4, c = (i % 4) * 8;
        const int part = j / kHD, d = j % kHD;
        *reinterpret_cast<uint4*>(wc + j * LDX + c) = *reinterpret_cast<const uint4*>(
            wqkv + static_cast<size_t>(part * C + h * kHD + d) * C + k0 + c);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < 32; kk += 16) {
#pragma unroll
        for (int i = 0; i < kProjPerWarp; ++i) {
          const int t = warp + kWarps * i;
          if (t < rg * 6) {
            const int r = t / 6, c = t % 6;
            FragA a;
            FragBCol b;
            wmma::load_matrix_sync(a, xc + r * 16 * LDX + kk, LDX);
            wmma::load_matrix_sync(b, wc + c * 16 * LDX + kk, LDX);
            wmma::mma_sync(acc[i], a, b, acc[i]);
          }
        }
      }
      __syncthreads();
    }
    // + bias; q scaled after its bias; bf16 like the TPU kernel's q/k/v
#pragma unroll
    for (int i = 0; i < kProjPerWarp; ++i) {
      const int t = warp + kWarps * i;
      if (t < rg * 6) {
        const int r = t / 6, c = t % 6;
        const int part = c / 2, d0 = (c % 2) * 16;
        bf16* dst = part == 0 ? qs : part == 1 ? ks : vs;
        wmma::store_matrix_sync(e, acc[i], LDE, wmma::mem_row_major);
        __syncwarp();
        for (int j = lane; j < 256; j += 32) {
          const int rr = j / 16, dd = j % 16;
          const float val = e[rr * LDE + dd] + to_f(bqkv[part * C + h * kHD + d0 + dd]);
          dst[(g0 + r * 16 + rr) * LDH + d0 + dd] = to_bf(part == 0 ? val * scale : val);
        }
        __syncwarp();
      }
    }
    __syncthreads();  // the staging tiles alias the next row group's chunks
  }

  // 2. the attention, O into the head's 32 columns
  const int wi = win % nW;
  const float* mask_w =
      (mask != nullptr && wi >= nu) ? mask + static_cast<size_t>(wi - nu) * n * n : nullptr;
  const float* bias_h = bias + static_cast<size_t>(h) * n * n;
  bf16* ow = o + static_cast<size_t>(win) * n * C + h * kHD;
  for (int gi = warp; gi < n / 16; gi += kWarps) {
    uint32_t qa[2][4];
    load_qa(qa, qs, LDH, gi * 16, n);
    attend16(qa, ks, vs, n, gi * 16, bias_h, mask_w, ow, C);
  }
}

}  // namespace wattn
}  // namespace lavt

extern "C" int lavt_window_attn(const void* q, const void* k, const void* v, const void* bias,
                                const void* mask, void* o, int Bw, int nW, int nu, int heads,
                                int n, int qsplit, float scale, void* stream) {
  using namespace lavt;
  using namespace lavt::wattn;
  if (n < 1 || n > kNMax) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(window_attn_kernel, SMEM_K10);
  if (err != cudaSuccess) return static_cast<int>(err);
  window_attn_kernel<<<dim3(heads, Bw, qsplit), kThreads, SMEM_K10,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(bias), static_cast<const float*>(mask), static_cast<bf16*>(o),
      nW, nu, n, scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lavt_window_msa_np(const void* x, const void* wqkv, const void* bqkv,
                                  const void* bias, const void* mask, void* o, int Bw, int nW,
                                  int nu, int C, int heads, int n, float scale, void* stream) {
  using namespace lavt;
  using namespace lavt::wattn;
  if (n < 16 || n > kNMax || n % 16 != 0 || C % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(window_msa_np_kernel, SMEM_K2P);
  if (err != cudaSuccess) return static_cast<int>(err);
  window_msa_np_kernel<<<dim3(heads, Bw), kThreads, SMEM_K2P,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wqkv),
      static_cast<const bf16*>(bqkv), static_cast<const float*>(bias),
      static_cast<const float*>(mask), static_cast<bf16*>(o), nW, nu, n, C, scale);
  return static_cast<int>(cudaGetLastError());
}
