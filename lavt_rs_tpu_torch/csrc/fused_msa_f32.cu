// The attention launch of K1 f32, K2 f32, K11 f32 and the K1/K2 save mode
// f32 (K6 f32's forward too): window attention in f32 on f32 activations,
// between the qkv projection and the out-projection on the f32 GEMM
// (csrc/gemm_f32.cu).
//
// Replaces the f32 computation of lavt_rs_tpu/ops/pallas/fused_msa.py:
// _fwd_call/_kernel at N = 144 (fused_window_msa, K2; fused_window_msa_ln,
// K1, whose LayerNorm runs first as K4 f32's row launch, csrc/ln.cu; with
// save=True the training forward _fwd(..., exact=True, save=True)) and, in
// map order, experimental.py:_fwd_2d/_kernel_2d (K11), on f32 inputs
// (`--no_bf16` with Pallas: the TPU kernels compute in f32 and their
// roundings to x.dtype are no-ops).  Per window and head, hd = 32, q, k, v
// read from the f32 qkv tensor the projection wrote (q scaled after its
// bias):
//   s = q k^T + bias[h] + mask[w mod nW]
//   e = exp(min(s, 80))        the TPU inference kernel's shift-free form
//                              (fused_msa.py:_softmax_exp), or, `exact`
//                              (the taped training forward, _vjp_fwd and
//                              _vjp_ln_fwd), exp(s - max_j s): the two
//                              agree while s <= 80
//   O[:, 32h:32h+32] = (sum_j e_j v_j) / sum_j e_j
// In save mode P = e / sum_j e_j is also written (f32, (B nW, heads, 144,
// 144)), and O is made from those P values, as K5 f32 reads them back.
// A window reads its mask only where its flag is set
// (ops/window.shift_mask_flags_2d; every window without flags).
//
// Window order (K1, K2, the save mode): qkv (B nW 144, 3C), O (B nW 144,
// C).  Map order (K11): qkv the padded, pre-rolled (B, Hp, Wp, 3C) map, O
// the (B, Hp, Wp, C) map; token 12 i + j of window (b, wy, wx) at map row
// (b Hp + 12 wy + i) Wp + 12 wx + j, its mask window wy (Wp / 12) + wx.
//
// Bound on the H100, per call: 4 N^2 hd flops per window and head against
// the f32 qkv and O, the bias and the masked windows' mask (and in save
// mode P).  At Swin-B stage 3 (bs 8: 72 windows, C = 512, 16 heads) 3.06
// GFLOP (0.019 ms at 165 TFLOP/s: 495 TF32 over 3xTF32's three passes)
// against 85 MB of qkv and O + 1.3 MB of bias: bytes, 0.026 ms; in save
// mode + 95.6 MB of P, 0.054 ms.
//
// Design: persistent blocks of three warpgroups, one an SM, each over a
// contiguous run of (head, window) items in head-major order, so that a
// block's items share one head (at Swin-B 480² bs 8 a block sees one or
// two heads: 24-25 items at stage 1, 7-9 at stages 3-4).  Warpgroup wg
// owns query rows 64 wg .. 64 wg + 63 (the third holds 16 real rows: its
// other three warps, rows 144-191, feed zeros to the warpgroup's products
// and store nothing), and every product runs on wgmma in 3xTF32 (lo hi +
// hi lo + hi hi, the splits by truncation), A from registers:
//   * S = q k^T, one m64n144 accumulator a warpgroup (72 registers a
//     thread: a warp's 16 rows and all 144 keys in C-fragment order), four
//     8-deep steps; B is k's head slice as cp.async lands it (144 rows of
//     128 bytes, the 128-byte swizzle: a row's 16-byte chunk c at c ^ (row
//     mod 8)), which is its hi, and its lo split beside it;
//   * bias (the head's, staged in C-fragment order once a run: 83 KB; for
//     warp w, key tile j and lane (g, t) one 16-byte word, bias[16w +
//     g][8j + 2t, + 1] and bias[16w + g + 8][...]) and, in a flagged
//     window, the mask (from L2) are added to the accumulator; the exact
//     form's row max over the four lanes of a row; e (ex2.approx of one
//     multiply, `__expf`) and its row sums in registers (save mode: P = e /
//     sum e stored in f32, O made from it);
//   * O = e V, m64n32, eighteen 8-key steps, each C fragment serving as the
//     A fragment of the next product with its depth permuted (A's depth t
//     is key 2t of the step, t + 4 key 2t + 1: `frag_c2a`), so B is v
//     transposed into keys-contiguous rows with the same permutation (five
//     32-key blocks of 32 rows, hi and lo, 40 KB), written once an item
//     from v's staged rows (landing v there directly by 4-byte cp.async
//     copies measured 2-3 % slower).
// The item loop: wait for the item's q, k and v (a barrier), stage a new
// head's bias, one pass writes k's lo and v's transposed hi and lo and
// loads q's fragments, a barrier, the next item's q, k (into the other k
// buffer) and v start by cp.async, and the products run under them.
// Shared memory 212 KB.
// Measured (PERF.md, tools/ablate_msa_f32.py, H100): the design before (a
// block per (window, head), two an SM, mma.sync with each B fragment a
// 16-byte load from shared "fragment tiles" that 9 warps each read whole:
// 663 KB of shared-memory reads an item) was bound by that traffic, the
// mma.sync issue and the softmax in turn; its fragment tiles built from
// 4-byte loads of device memory cost 36 % of its time at stage 1.  Hiding
// those loads (persistent blocks, cp.async) left it as fast as before; a
// wgmma reads each B tile once for 64 rows.  tools/ablate_msa_f32.py
// times it with parts switched off.

#include <algorithm>
#include <cstdint>

#include "attn_tf32.cuh"
#include "gemm_sm90.cuh"

namespace lavt {
namespace msa32 {

using namespace tf32attn;

constexpr int kN = 144, kWS = 12, kNT = kN / 8;  // 18 key tiles of 8
constexpr int kThreads = 384;                    // three warpgroups
constexpr int kRealWarps = kN / 16;              // warps 0-8 own real rows
constexpr int kSlice = kN * kHD * 4;             // bytes of a staged head slice, 18 KB
constexpr int kVtBlock = kHD * 32 * 4;           // v^T: 32 rows x 32 keys, 4 KB
constexpr int kVt = 5 * kVtBlock;                // keys 0-159 (144-159 unused)
constexpr int kBiasWords = kRealWarps * kNT * 32;
constexpr int kPvBatch = 3;  // O = P V's key steps between waits (A registers held)
// shared memory (1024-byte aligned pieces): k (two buffers), k's lo, v^T
// hi and lo, the staged q and v, the bias words
constexpr int kOffK = 0, kOffKlo = 2 * kSlice, kOffVtHi = 3 * kSlice,
              kOffVtLo = kOffVtHi + kVt, kOffQ = kOffVtLo + kVt, kOffV = kOffQ + kSlice,
              kOffBias = kOffV + kSlice;
constexpr size_t kSmem = kOffBias + size_t(kBiasWords) * 16 + 1024;  // + alignment slack

struct Params {
  const float* qkv;
  const float* bias;   // (heads, 144, 144)
  const float* mask;   // (nW, 144, 144) or null
  const int* flags;    // (nW,) or null
  float* o;
  float* p;            // save mode: (B nW, heads, 144, 144), else null
  int nw, c, heads;
  int hp, wp;          // map order: the map's sides
  int windows;         // B nW
};

// D (64 x 144, f32: thread's acc[i] at d[i / 4][i % 4]) (+)= A (64 x 8, tf32
// registers) B (144 x 8, tf32 shared memory, K-major); scale_d = 0 overwrites D
__device__ __forceinline__ void wgmma_n144(float (&d)[kNT][4], const uint32_t (&a)[4],
                                   uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %77, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n144k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71}, "
      "{%72, %73, %74, %75}, %76, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]),
        "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]),
        "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3]), "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]), "+f"(d[10][0]), "+f"(d[10][1]),
        "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]), "+f"(d[13][0]), "+f"(d[13][1]),
        "+f"(d[13][2]), "+f"(d[13][3]), "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]), "+f"(d[16][0]), "+f"(d[16][1]),
        "+f"(d[16][2]), "+f"(d[16][3]), "+f"(d[17][0]), "+f"(d[17][1]), "+f"(d[17][2]), "+f"(d[17][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// D (64 x 32, f32: thread's acc[i] at d[i / 4][i % 4]) (+)= A (64 x 8, tf32
// registers) B (32 x 8, tf32 shared memory, K-major); scale_d = 0 overwrites D
__device__ __forceinline__ void wgmma_n32(float (&d)[4][4], const uint32_t (&a)[4],
                                   uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]),
        "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}


template <bool kMap>
__device__ __forceinline__ size_t token_row(const Params& p, int w, int i) {
  if (!kMap) return size_t(w) * kN + i;
  const int nwx = p.wp / kWS, nwi = (p.hp / kWS) * nwx;
  const int b = w / nwi, wi = w % nwi;
  return (size_t(b) * p.hp + (wi / nwx) * kWS + i / kWS) * p.wp + (wi % nwx) * kWS + i % kWS;
}

__device__ __forceinline__ void zero4(float (&d)[4]) { d[0] = d[1] = d[2] = d[3] = 0.f; }

// keeps the compiler from reusing a wgmma's A registers before its wait
__device__ __forceinline__ void fence_u(uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst), "l"(src) : "memory");
}

// byte offset of element (r, d) of a staged [rows][32] f32 slice, the
// 128-byte swizzle (chunk d / 4 of row r at (d / 4) ^ (r mod 8))
__device__ __forceinline__ int sw_at(int r, int d) {
  return r * 128 + ((((d >> 2) ^ (r & 7))) << 4) + (d & 3) * 4;
}

// window w's head-h slices of q, k, v -> the staged q, k buffer kb, v, by
// 16-byte asynchronous copies
template <bool kMap>
__device__ __forceinline__ void stage_item(const Params& p, uint32_t sq, uint32_t sk,
                                           uint32_t sv, int w, int h) {
  const size_t ld = 3 * size_t(p.c);
  for (int i = threadIdx.x; i < 3 * kN * (kHD / 4); i += kThreads) {
    const int part = i / (kN * (kHD / 4)), r = i / (kHD / 4) % kN, c = i % (kHD / 4);
    const float* src = p.qkv + token_row<kMap>(p, w, r) * ld + part * p.c + h * kHD + 4 * c;
    const uint32_t dst = (part == 0 ? sq : part == 1 ? sk : sv) + sw_at(r, 4 * c);
    f32mma::cp_async16(dst, src, true);
  }
}

// head h's bias -> C-fragment order (word (w kNT + j) 32 + lane), by
// 8-byte asynchronous copies
__device__ __forceinline__ void stage_bias(const Params& p, uint32_t sb, int h) {
  for (int i = threadIdx.x; i < kBiasWords; i += kThreads) {
    const int lane = i % 32, j = i / 32 % kNT, w = i / (32 * kNT);
    const float* src = p.bias + (size_t(h) * kN + 16 * w + lane / 4) * kN + 8 * j + 2 * (lane % 4);
    cp_async8(sb + 16 * i, src);
    cp_async8(sb + 16 * i + 8, src + 8 * kN);
  }
}

__device__ __forceinline__ float4 lo4(float4 x) {
  return make_float4(x.x - __uint_as_float(__float_as_uint(x.x) & 0xffffe000u),
                     x.y - __uint_as_float(__float_as_uint(x.y) & 0xffffe000u),
                     x.z - __uint_as_float(__float_as_uint(x.z) & 0xffffe000u),
                     x.w - __uint_as_float(__float_as_uint(x.w) & 0xffffe000u));
}

// The item's B operands from its staged k (buffer kb) and v: k's lo (the
// same swizzled offsets as k), and v^T hi and lo: element (key, d) of v at row
// d, key column 8 (key / 8 mod 4) + kappa of block key / 32, kappa = 4
// (key mod 2) + (key mod 8) / 2 (frag_c2a's depth order)
__device__ __forceinline__ void build_b(unsigned char* smem, int kb) {
  const float4* k4 = reinterpret_cast<const float4*>(smem + kOffK + kb * kSlice);
  float4* klo4 = reinterpret_cast<float4*>(smem + kOffKlo);
  for (int i = threadIdx.x; i < kSlice / 16; i += kThreads) klo4[i] = lo4(k4[i]);
  // v^T in 4 x 4 blocks: keys 8 g + par + 2 m (m < 4: kappa 4 par + m,
  // one 16-byte chunk of v^T's row d) by d 4 db .. 4 db + 3 (one 16-byte
  // chunk of v's row key)
  const unsigned char* v = smem + kOffV;
  for (int u = threadIdx.x; u < kN * kHD / 16; u += kThreads) {
    const int g = u / 16, par = u / 8 % 2, db = u % 8;
    float4 x[4];
#pragma unroll
    for (int m = 0; m < 4; ++m)
      x[m] = *reinterpret_cast<const float4*>(v + sw_at(8 * g + par + 2 * m, 4 * db));
    const float y[4][4] = {{x[0].x, x[1].x, x[2].x, x[3].x}, {x[0].y, x[1].y, x[2].y, x[3].y},
                           {x[0].z, x[1].z, x[2].z, x[3].z}, {x[0].w, x[1].w, x[2].w, x[3].w}};
#pragma unroll
    for (int dd = 0; dd < 4; ++dd) {
      const int off = (g >> 2) * kVtBlock + sw_at(4 * db + dd, 8 * (g & 3) + 4 * par);
      const float4 hi = make_float4(y[dd][0], y[dd][1], y[dd][2], y[dd][3]);
      *reinterpret_cast<float4*>(smem + kOffVtHi + off) = hi;
      *reinterpret_cast<float4*>(smem + kOffVtLo + off) = lo4(hi);
    }
  }
}

// K-major 128-byte-swizzled B descriptor at `addr` (8-row atoms 1024
// bytes apart)
__device__ __forceinline__ uint64_t bdesc(uint32_t addr) { return sm90::smem_desc(addr, 16, 1024); }

template <bool kMap, bool kExact, bool kSave>
__global__ void __launch_bounds__(kThreads, 1) msa_f32_kernel(const Params p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t s0 = sm90::smem_u32(smem);
  const float4* bias_s = reinterpret_cast<const float4*>(smem + kOffBias);
  // this block's run [i0, i1) of the (head, window) items, head-major
  const long long items = static_cast<long long>(p.windows) * p.heads;
  const int i0 = static_cast<int>(items * blockIdx.x / gridDim.x);
  const int i1 = static_cast<int>(items * (blockIdx.x + 1) / gridDim.x);
  const int warp = threadIdx.x / 32, lane = lane_id(), g = lane_g(), t = lane_t();
  const bool real = warp < kRealWarps;        // rows < 144 (warp-uniform)
  const int ra = 16 * warp + g, rb = ra + 8;  // the thread's query rows
  int head = -1, kb = 0;                      // k's buffer of the item
  if (i0 < i1)
    stage_item<kMap>(p, s0 + kOffQ, s0 + kOffK, s0 + kOffV, i0 % p.windows, i0 / p.windows);
  f32mma::cp_commit();
  for (int it = i0; it < i1; ++it, kb ^= 1) {
    const int w = it % p.windows, h = it / p.windows;
    f32mma::cp_wait<0>();
    __syncthreads();  // the item's rows have landed; every warp is past the last item
    if (h != head) {  // a new head: its bias
      stage_bias(p, s0 + kOffBias, h);
      f32mma::cp_commit();
      head = h;
    }
    build_b(smem, kb);
    Frag4 qf[kHD / 8];  // q's A fragments (rows ra, rb), zeros past row 143
#pragma unroll
    for (int kk = 0; kk < kHD / 8; ++kk) {
      const unsigned char* q = smem + kOffQ;
      const float x0 = real ? *reinterpret_cast<const float*>(q + sw_at(ra, 8 * kk + t)) : 0.f;
      const float x1 = real ? *reinterpret_cast<const float*>(q + sw_at(rb, 8 * kk + t)) : 0.f;
      const float x2 = real ? *reinterpret_cast<const float*>(q + sw_at(ra, 8 * kk + t + 4)) : 0.f;
      const float x3 = real ? *reinterpret_cast<const float*>(q + sw_at(rb, 8 * kk + t + 4)) : 0.f;
      split_rz(x0, qf[kk].hi[0], qf[kk].lo[0]);
      split_rz(x1, qf[kk].hi[1], qf[kk].lo[1]);
      split_rz(x2, qf[kk].hi[2], qf[kk].lo[2]);
      split_rz(x3, qf[kk].hi[3], qf[kk].lo[3]);
    }
    f32mma::cp_wait<0>();  // a new head's bias
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // for the wgmmas
    __syncthreads();  // k's lo, v^T and the bias written, q loaded: the staged q and v free
    if (it + 1 < i1)
      stage_item<kMap>(p, s0 + kOffQ, s0 + kOffK + (kb ^ 1) * kSlice, s0 + kOffV,
                       (it + 1) % p.windows, (it + 1) / p.windows);
    f32mma::cp_commit();

    // S = q k^T (the warpgroup's 64 rows, 144 keys): lo hi and hi lo for
    // every depth step, then hi hi
    float s[kNT][4];
    const uint32_t khi = s0 + kOffK + kb * kSlice, klo = s0 + kOffKlo;
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kHD / 8; ++kk) {
      wgmma_n144(s, qf[kk].lo, bdesc(khi + 32 * kk), kk != 0);
      wgmma_n144(s, qf[kk].hi, bdesc(klo + 32 * kk), 1);
    }
#pragma unroll
    for (int kk = 0; kk < kHD / 8; ++kk) wgmma_n144(s, qf[kk].hi, bdesc(khi + 32 * kk), 1);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_acc(s);

    float inva = 1.f, invb = 1.f;
    if (real) {
      // + bias (staged) + mask (flagged windows, from L2) at the C
      // fragments' places (rows ra, rb; keys 8 j + 2 t, + 1)
      const int mw = w % p.nw;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const float4 bw = bias_s[(warp * kNT + j) * 32 + lane];
        s[j][0] += bw.x, s[j][1] += bw.y, s[j][2] += bw.z, s[j][3] += bw.w;
      }
      if (p.mask != nullptr && (p.flags == nullptr || p.flags[mw] != 0)) {
        const float* ma = p.mask + (size_t(mw) * kN + ra) * kN + 2 * t;
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          const float2 x = __ldg(reinterpret_cast<const float2*>(ma + 8 * j));
          const float2 y = __ldg(reinterpret_cast<const float2*>(ma + 8 * kN + 8 * j));
          s[j][0] += x.x, s[j][1] += x.y, s[j][2] += y.x, s[j][3] += y.y;
        }
      }
      // exact: the row max over the row's 18 tiles (its four lanes by two
      // shuffles), e = exp(s - max); else the shift-free e = exp(min(s, 80))
      float mxa = 0.f, mxb = 0.f;
      if constexpr (kExact) {
        mxa = mxb = __int_as_float(static_cast<int>(0xff800000u));  // -inf
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          mxa = fmaxf(mxa, fmaxf(s[j][0], s[j][1]));
          mxb = fmaxf(mxb, fmaxf(s[j][2], s[j][3]));
        }
#pragma unroll
        for (int o = 1; o < 4; o <<= 1) {
          mxa = fmaxf(mxa, __shfl_xor_sync(0xffffffffu, mxa, o));
          mxb = fmaxf(mxb, __shfl_xor_sync(0xffffffffu, mxb, o));
        }
      }
      float la = 0.f, lb = 0.f;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[j][e] = kExact ? __expf(s[j][e] - mxa) : __expf(fminf(s[j][e], 80.f));
          s[j][2 + e] = kExact ? __expf(s[j][2 + e] - mxb) : __expf(fminf(s[j][2 + e], 80.f));
        }
        la += s[j][0] + s[j][1];
        lb += s[j][2] + s[j][3];
      }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        la += __shfl_xor_sync(0xffffffffu, la, o);
        lb += __shfl_xor_sync(0xffffffffu, lb, o);
      }
      inva = 1.f / la, invb = 1.f / lb;
      if constexpr (kSave) {
        // P = e / l in f32 at the C fragments' places, and O made from it
        float* pa = p.p + ((size_t(w) * p.heads + h) * kN + ra) * kN + 2 * t;
        float* pb = pa + 8 * kN;
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          s[j][0] *= inva, s[j][1] *= inva, s[j][2] *= invb, s[j][3] *= invb;
          *reinterpret_cast<float2*>(pa + 8 * j) = make_float2(s[j][0], s[j][1]);
          *reinterpret_cast<float2*>(pb + 8 * j) = make_float2(s[j][2], s[j][3]);
        }
      }
    } else {  // rows past 143: zeros into the warpgroup's O = P V
#pragma unroll
      for (int j = 0; j < kNT; ++j) zero4(s[j]);
    }

    // O = e V (P V in save mode): eighteen 8-key steps, kPvBatch at a time
    // (their A fragments held until their wgmmas are done)
    float o[4][4];
#pragma unroll
    for (int c = 0; c < 4; ++c) zero4(o[c]);
#pragma unroll
    for (int j0 = 0; j0 < kNT; j0 += kPvBatch) {
      Frag4 a[kPvBatch];
#pragma unroll
      for (int jj = 0; jj < kPvBatch; ++jj) a[jj] = frag_c2a(s[j0 + jj]);
      sm90::wgmma_fence();
#pragma unroll
      for (int jj = 0; jj < kPvBatch; ++jj) {
        const int j = j0 + jj;
        const uint32_t off = (j >> 2) * kVtBlock + (j & 3) * 32;
        wgmma_n32(o, a[jj].lo, bdesc(s0 + kOffVtHi + off), 1);
        wgmma_n32(o, a[jj].hi, bdesc(s0 + kOffVtLo + off), 1);
        wgmma_n32(o, a[jj].hi, bdesc(s0 + kOffVtHi + off), 1);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_acc(o);
#pragma unroll
      for (int jj = 0; jj < kPvBatch; ++jj) {
        fence_u(a[jj].hi);
        fence_u(a[jj].lo);
      }
    }
    if (real) {
      const float fa = kSave ? 1.f : inva, fb = kSave ? 1.f : invb;
      float* oa = p.o + token_row<kMap>(p, w, ra) * p.c + h * kHD + 2 * t;
      float* ob = p.o + token_row<kMap>(p, w, rb) * p.c + h * kHD + 2 * t;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        *reinterpret_cast<float2*>(oa + 8 * c) = make_float2(o[c][0] * fa, o[c][1] * fa);
        *reinterpret_cast<float2*>(ob + 8 * c) = make_float2(o[c][2] * fb, o[c][3] * fb);
      }
    }
  }
}

inline bool aligned(const void* p) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <bool kMap, bool kExact, bool kSave>
cudaError_t launch(Params p, int windows, cudaStream_t s) {
  if (!aligned(p.qkv) || !aligned(p.bias) || !aligned(p.mask) || !aligned(p.o) ||
      !aligned(p.p))
    return cudaErrorInvalidValue;
  auto kernel = msa_f32_kernel<kMap, kExact, kSave>;
  const cudaError_t err = allow_smem(kernel, kSmem);
  if (err != cudaSuccess) return err;
  p.windows = windows;
  const long long items = static_cast<long long>(windows) * p.heads;
  const int blocks = static_cast<int>(std::min<long long>(items, sm90::sm_count()));
  kernel<<<blocks, kThreads, kSmem, s>>>(p);
  return cudaGetLastError();
}

}  // namespace msa32
}  // namespace lavt

// K1 f32's and K2 f32's attention, and their save mode: qkv (B nW 144, 3C)
// f32 (q post-scale), bias (heads, 144, 144) f32, mask (nW, 144, 144) f32 or
// null with its window flags (nW,) int32 or null; writes o (B nW 144, C)
// f32 and, where p is not null (the save mode, exact only), P (B nW, heads,
// 144, 144) f32.  exact: the max-subtracted softmax (the taped forward),
// else exp(min(s, 80)).  C = 32 heads.
extern "C" int lavt_msa_fwd_f32(const void* qkv, const void* bias, const void* mask,
                                const void* flags, void* o, void* prob, int Bw, int nW, int C,
                                int heads, int exact, void* stream) {
  using namespace lavt::msa32;
  if (Bw < 1 || nW < 1 || Bw % nW != 0 || heads < 1 || C != heads * kHD)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{static_cast<const float*>(qkv), static_cast<const float*>(bias),
                 static_cast<const float*>(mask), static_cast<const int*>(flags),
                 static_cast<float*>(o), static_cast<float*>(prob), nW, C, heads, 0, 0, 0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (prob != nullptr)  // the save mode: the taped forward's exact softmax
    return static_cast<int>(exact ? launch<false, true, true>(p, Bw, s)
                                  : cudaErrorInvalidValue);
  return static_cast<int>(exact ? launch<false, true, false>(p, Bw, s)
                                : launch<false, false, false>(p, Bw, s));
}

// K11 f32's attention: qkv (B, Hp, Wp, 3C) f32 (q post-scale), Hp and Wp
// multiples of 12, bias (heads, 144, 144) f32, mask (nW, 144, 144) f32 or
// null with nW = (Hp / 12)(Wp / 12) and its window flags (nW,) int32 or
// null; writes o (B, Hp, Wp, C) f32 at the windows' map positions; exact
// as lavt_msa_fwd_f32's.
extern "C" int lavt_msa_fwd_map_f32(const void* qkv, const void* bias, const void* mask,
                                    const void* flags, void* o, int B, int Hp, int Wp, int C,
                                    int heads, int exact, void* stream) {
  using namespace lavt::msa32;
  if (B < 1 || Hp < kWS || Wp < kWS || Hp % kWS != 0 || Wp % kWS != 0 || heads < 1 ||
      C != heads * kHD)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nW = (Hp / kWS) * (Wp / kWS);
  const Params p{static_cast<const float*>(qkv), static_cast<const float*>(bias),
                 static_cast<const float*>(mask), static_cast<const int*>(flags),
                 static_cast<float*>(o), nullptr, nW, C, heads, Hp, Wp, 0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(exact ? launch<true, true, false>(p, B * nW, s)
                                : launch<true, false, false>(p, B * nW, s));
}
