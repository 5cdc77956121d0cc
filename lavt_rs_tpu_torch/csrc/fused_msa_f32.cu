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
// Design: one block of 9 warps per (window, head), every product in 3xTF32
// on mma.sync.m16n8k8 (csrc/attn_tf32.cuh).  The block builds the head's
// k as an NT fragment tile and v as an NN one straight from the qkv
// tensor (split once, one 16-byte shared-memory load a B fragment; 73.7 KB
// of dynamic shared memory).  Warp w owns query rows 16 w .. 16 w + 15:
// its q fragments are read from device memory and split where they are
// used; S = q k^T is computed once into the C fragments of the row's 18
// key tiles (72 registers a thread), bias and mask are added there, the
// exact form's row max is taken over them (four lanes a row), e and its
// row sums follow in registers; O = e V (or, in save mode, P = e / sum e,
// stored in f32 from the C fragments, and O = P V from those P values) with
// each C fragment serving as the A fragment of the next product
// (`frag_c2a`).  (The design before: FFMA, one thread pair per query row,
// the scores recomputed in each of 1 + exact + save passes, PERF.md.)

#include <cstdint>

#include "attn_tf32.cuh"

namespace lavt {
namespace msa32 {

using namespace tf32attn;

constexpr int kN = 144, kWS = 12, kNT = kN / 8;          // 18 key tiles of 8
constexpr int kWarps = kN / 16, kThreads = 32 * kWarps;  // 9 warps of 16 query rows
constexpr int kFragT = frag_tile_bytes(kN) / 16;         // 16-byte words of a fragment tile
constexpr size_t kSmem = 2 * size_t(kFragT) * 16;        // k NT and v NN

struct Params {
  const float* qkv;
  const float* bias;   // (heads, 144, 144)
  const float* mask;   // (nW, 144, 144) or null
  const int* flags;    // (nW,) or null
  float* o;
  float* p;            // save mode: (B nW, heads, 144, 144), else null
  int nw, c, heads;
  int hp, wp;          // map order: the map's sides
};

template <bool kMap>
__device__ __forceinline__ size_t token_row(const Params& p, int w, int i) {
  if (!kMap) return size_t(w) * kN + i;
  const int nwx = p.wp / kWS, nwi = (p.hp / kWS) * nwx;
  const int b = w / nwi, wi = w % nwi;
  return (size_t(b) * p.hp + (wi / nwx) * kWS + i / kWS) * p.wp + (wi % nwx) * kWS + i % kWS;
}

__device__ __forceinline__ void zero4(float (&d)[4]) { d[0] = d[1] = d[2] = d[3] = 0.f; }

template <bool kMap, bool kExact, bool kSave>
__global__ void __launch_bounds__(kThreads, 2) msa_f32_kernel(const Params p) {
  extern __shared__ __align__(16) uint4 smem4[];
  uint4* kf = smem4;        // k as an NT fragment tile (S = q k^T)
  uint4* vf = kf + kFragT;  // v as an NN fragment tile (O = P v)
  const int w = blockIdx.x, h = blockIdx.y;
  const size_t ld = 3 * size_t(p.c);
  const float* kh = p.qkv + p.c + h * kHD;
  const float* vh = p.qkv + 2 * p.c + h * kHD;
  // block (r, c)'s word of lane (g, tt): NT k[8r + g][8c + tt, + 4], NN
  // v[8r + 2tt, + 1][8c + g]
  for (int i = threadIdx.x; i < kFragT; i += kThreads) {
    const int lane = i % kFragBlock, blk = i / kFragBlock, r = blk / 4, c = blk % 4;
    const int g = lane / 4, tt = lane % 4;
    uint32_t h0, h1, l0, l1;
    const float* kr = kh + token_row<kMap>(p, w, 8 * r + g) * ld + 8 * c + tt;
    split_rz(__ldg(kr), h0, l0);
    split_rz(__ldg(kr + 4), h1, l1);
    kf[i] = make_uint4(h0, h1, l0, l1);
    const float* v0 = vh + token_row<kMap>(p, w, 8 * r + 2 * tt) * ld + 8 * c + g;
    const float* v1 = vh + token_row<kMap>(p, w, 8 * r + 2 * tt + 1) * ld + 8 * c + g;
    split_rz(__ldg(v0), h0, l0);
    split_rz(__ldg(v1), h1, l1);
    vf[i] = make_uint4(h0, h1, l0, l1);
  }

  const int warp = threadIdx.x / 32, g = lane_g(), t = lane_t();
  const int ra = 16 * warp + g, rb = ra + 8;  // the thread's query rows
  const size_t rowa = token_row<kMap>(p, w, ra), rowb = token_row<kMap>(p, w, rb);
  const float* qa = p.qkv + rowa * ld + h * kHD + t;
  const float* qb = p.qkv + rowb * ld + h * kHD + t;
  __syncthreads();  // the fragment tiles are built

  // S = q k^T: per 8-deep step, the q fragment split, then the key tiles
  // in chunks of 3, pass by pass over the chunk
  float s[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j) zero4(s[j]);
#pragma unroll
  for (int kk = 0; kk < kHD / 8; ++kk) {
    Frag4 a;
    split_rz(__ldg(qa + 8 * kk), a.hi[0], a.lo[0]);
    split_rz(__ldg(qb + 8 * kk), a.hi[1], a.lo[1]);
    split_rz(__ldg(qa + 8 * kk + 4), a.hi[2], a.lo[2]);
    split_rz(__ldg(qb + 8 * kk + 4), a.hi[3], a.lo[3]);
#pragma unroll
    for (int ch = 0; ch < kNT / 3; ++ch) {
      Frag2 b[3];
#pragma unroll
      for (int jj = 0; jj < 3; ++jj) b[jj] = frag_b(kf, 3 * ch + jj, kk);
#pragma unroll
      for (int jj = 0; jj < 3; ++jj) mma_tf32(s[3 * ch + jj], a.lo, b[jj].hi);
#pragma unroll
      for (int jj = 0; jj < 3; ++jj) mma_tf32(s[3 * ch + jj], a.hi, b[jj].lo);
#pragma unroll
      for (int jj = 0; jj < 3; ++jj) mma_tf32(s[3 * ch + jj], a.hi, b[jj].hi);
    }
  }

  // + bias + mask at the C fragments' places (rows ra, rb; keys 8 j + 2 t, + 1)
  const int mw = w % p.nw;
  const bool masked = p.mask != nullptr && (p.flags == nullptr || p.flags[mw] != 0);
  const float* ba = p.bias + (size_t(h) * kN + ra) * kN + 2 * t;
  const float* bb = ba + 8 * kN;
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    const float2 x = __ldg(reinterpret_cast<const float2*>(ba + 8 * j));
    const float2 y = __ldg(reinterpret_cast<const float2*>(bb + 8 * j));
    s[j][0] += x.x, s[j][1] += x.y, s[j][2] += y.x, s[j][3] += y.y;
  }
  if (masked) {
    const float* ma = p.mask + (size_t(mw) * kN + ra) * kN + 2 * t;
    const float* mb = ma + 8 * kN;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const float2 x = __ldg(reinterpret_cast<const float2*>(ma + 8 * j));
      const float2 y = __ldg(reinterpret_cast<const float2*>(mb + 8 * j));
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
      s[j][e] = kExact ? expf(s[j][e] - mxa) : expf(fminf(s[j][e], 80.f));
      s[j][2 + e] = kExact ? expf(s[j][2 + e] - mxb) : expf(fminf(s[j][2 + e], 80.f));
    }
    la += s[j][0] + s[j][1];
    lb += s[j][2] + s[j][3];
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    la += __shfl_xor_sync(0xffffffffu, la, o);
    lb += __shfl_xor_sync(0xffffffffu, lb, o);
  }
  const float inva = 1.f / la, invb = 1.f / lb;
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
  // O = e V (P V in save mode): the key tiles are the depth
  float o[4][4];
#pragma unroll
  for (int c = 0; c < 4; ++c) zero4(o[c]);
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    const Frag4 a = frag_c2a(s[j]);
#pragma unroll
    for (int c = 0; c < 4; c += 2) {
      const Frag2 b0 = frag_b(vf, j, c), b1 = frag_b(vf, j, c + 1);
      mma_tf32(o[c], a.lo, b0.hi);
      mma_tf32(o[c + 1], a.lo, b1.hi);
      mma_tf32(o[c], a.hi, b0.lo);
      mma_tf32(o[c + 1], a.hi, b1.lo);
      mma_tf32(o[c], a.hi, b0.hi);
      mma_tf32(o[c + 1], a.hi, b1.hi);
    }
  }
  const float fa = kSave ? 1.f : inva, fb = kSave ? 1.f : invb;
  float* oa = p.o + rowa * p.c + h * kHD + 2 * t;
  float* ob = p.o + rowb * p.c + h * kHD + 2 * t;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    *reinterpret_cast<float2*>(oa + 8 * c) = make_float2(o[c][0] * fa, o[c][1] * fa);
    *reinterpret_cast<float2*>(ob + 8 * c) = make_float2(o[c][2] * fb, o[c][3] * fb);
  }
}

inline bool aligned(const void* p) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <bool kMap, bool kExact, bool kSave>
cudaError_t launch(const Params& p, int windows, cudaStream_t s) {
  if (!aligned(p.qkv) || !aligned(p.bias) || !aligned(p.mask) || !aligned(p.o) ||
      !aligned(p.p))
    return cudaErrorInvalidValue;
  auto kernel = msa_f32_kernel<kMap, kExact, kSave>;
  const cudaError_t err = allow_smem(kernel, kSmem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(windows, p.heads), kThreads, kSmem, s>>>(p);
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
                 static_cast<float*>(o), static_cast<float*>(prob), nW, C, heads, 0, 0};
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
                 static_cast<float*>(o), nullptr, nW, C, heads, Hp, Wp};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(exact ? launch<true, true, false>(p, B * nW, s)
                                : launch<true, false, false>(p, B * nW, s));
}
