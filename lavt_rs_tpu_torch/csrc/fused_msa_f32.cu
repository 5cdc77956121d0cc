// The attention launch of K1 f32 and K11 f32: window attention in f32 on
// f32 activations, between the qkv projection and the out-projection on
// the f32 GEMM (csrc/gemm_f32.cu).
//
// Replaces the f32 computation of lavt_rs_tpu/ops/pallas/fused_msa.py:
// _fwd_call/_kernel at N = 144 (fused_window_msa_ln, K1, whose LayerNorm
// runs first as K4 f32's row launch, csrc/ln.cu) and, in map order,
// experimental.py:_fwd_2d/_kernel_2d (K11), on f32 inputs (`--no_bf16`
// with Pallas: the TPU kernels compute in f32 and their roundings to
// x.dtype are no-ops).  Per window and head, hd = 32, q, k, v read from the
// f32 qkv tensor the projection wrote (q scaled after its bias):
//   s = q k^T + bias[h] + mask[w mod nW]
//   e = exp(min(s, 80))        the TPU inference kernel's shift-free form
//                              (fused_msa.py:_softmax_exp): equal to the
//                              max-subtracted softmax while s <= 80
//   O[:, 32h:32h+32] = (sum_j e_j v_j) / sum_j e_j
// A window reads its mask only where its flag is set
// (ops/window.shift_mask_flags_2d; every window without flags).
//
// Window order (K1): qkv (B nW 144, 3C), O (B nW 144, C).  Map order
// (K11): qkv the padded, pre-rolled (B, Hp, Wp, 3C) map, O the (B, Hp, Wp,
// C) map; token 12 i + j of window (b, wy, wx) at map row
// (b Hp + 12 wy + i) Wp + 12 wx + j, its mask window wy (Wp / 12) + wx.
//
// Bound on the H100, per call: 4 N^2 hd flops per window and head against
// the f32 qkv and O, the bias and the masked windows' mask.  At Swin-B
// stage 3 (bs 8: 72 windows, C = 512, 16 heads) 3.06 GFLOP (0.019 ms at 165
// TFLOP/s, or 0.046 ms at 67 TFLOP/s on the FP32 cores this launch uses)
// against 85 MB of qkv and O + 1.3 MB of bias: bytes, 0.026 ms.
//
// Design (a simple kernel, right first): one block of 288 threads per
// (window, head).  The head's k and v (144 x 32 each) are copied into
// shared memory (rows 36 floats apart); thread 2 i + u holds query row i's
// q in registers and runs over keys 8 s + 4 u .. 8 s + 4 u + 3, s < 18
// (the two halves' k rows then fall 16 banks apart, and a half's 16 lanes
// read one address), with a float4 of bias and of mask per four keys,
// accumulating sum e and sum e v in registers (one pass: the shift-free
// numerator needs no running max); the two halves add theirs by one
// shuffle and each writes 16 of the row's 32 outputs.  FFMA, not the
// tensor cores: 41 KB of shared memory, two blocks an SM by registers
// (-Xptxas -v, CUDA 12.8, on an H100: 96 registers, 16 bytes spilled in
// window order and 28 in map order).

#include <cstdint>

#include "common.cuh"

namespace lavt {
namespace msa32 {

constexpr int kN = 144, kHD = 32, kWS = 12, kPad = 36, kThreads = 2 * kN;

struct Params {
  const float* qkv;
  const float* bias;   // (heads, 144, 144)
  const float* mask;   // (nW, 144, 144) or null
  const int* flags;    // (nW,) or null
  float* o;
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

__device__ __forceinline__ float dot32(const float (&q)[kHD], const float* k) {
  float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int c = 0; c < kHD / 4; ++c) {
    const float4 kv = *reinterpret_cast<const float4*>(k + 4 * c);
    d[0] = fmaf(q[4 * c], kv.x, d[0]);
    d[1] = fmaf(q[4 * c + 1], kv.y, d[1]);
    d[2] = fmaf(q[4 * c + 2], kv.z, d[2]);
    d[3] = fmaf(q[4 * c + 3], kv.w, d[3]);
  }
  return (d[0] + d[1]) + (d[2] + d[3]);
}

template <bool kMap>
__global__ void __launch_bounds__(kThreads, 2) msa_f32_kernel(const Params p) {
  __shared__ __align__(16) float ks[kN * kPad];
  __shared__ __align__(16) float vs[kN * kPad];
  const int w = blockIdx.x, h = blockIdx.y;
  const size_t ld = 3 * size_t(p.c);
  for (int idx = threadIdx.x; idx < kN * kHD / 4; idx += kThreads) {
    const int r = idx / (kHD / 4), c = idx % (kHD / 4);
    const float* src = p.qkv + token_row<kMap>(p, w, r) * ld + h * kHD + 4 * c;
    *reinterpret_cast<float4*>(ks + r * kPad + 4 * c) =
        *reinterpret_cast<const float4*>(src + p.c);
    *reinterpret_cast<float4*>(vs + r * kPad + 4 * c) =
        *reinterpret_cast<const float4*>(src + 2 * p.c);
  }
  const int i = threadIdx.x / 2, u = threadIdx.x % 2;
  const size_t row = token_row<kMap>(p, w, i);
  float q[kHD];
#pragma unroll
  for (int c = 0; c < kHD / 4; ++c) {
    const float4 t = *reinterpret_cast<const float4*>(p.qkv + row * ld + h * kHD + 4 * c);
    q[4 * c] = t.x, q[4 * c + 1] = t.y, q[4 * c + 2] = t.z, q[4 * c + 3] = t.w;
  }
  __syncthreads();

  const int mw = w % p.nw;
  const bool masked = p.mask != nullptr && (p.flags == nullptr || p.flags[mw] != 0);
  const float* brow = p.bias + (size_t(h) * kN + i) * kN;
  const float* mrow = masked ? p.mask + (size_t(mw) * kN + i) * kN : nullptr;
  float o[kHD], l = 0.f;
#pragma unroll
  for (int d = 0; d < kHD; ++d) o[d] = 0.f;
  for (int s = 0; s < kN / 8; ++s) {
    const int j0 = 8 * s + 4 * u;
    const float4 b4 = __ldg(reinterpret_cast<const float4*>(brow + j0));
    const float4 m4 = masked ? __ldg(reinterpret_cast<const float4*>(mrow + j0))
                             : make_float4(0.f, 0.f, 0.f, 0.f);
    const float bb[4] = {b4.x, b4.y, b4.z, b4.w}, mm[4] = {m4.x, m4.y, m4.z, m4.w};
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      float sc = dot32(q, ks + (j0 + jj) * kPad) + bb[jj];
      if (masked) sc += mm[jj];
      const float e = expf(fminf(sc, 80.f));
      l += e;
      const float* vr = vs + (j0 + jj) * kPad;
#pragma unroll
      for (int c = 0; c < kHD / 4; ++c) {
        const float4 vv = *reinterpret_cast<const float4*>(vr + 4 * c);
        o[4 * c] = fmaf(e, vv.x, o[4 * c]);
        o[4 * c + 1] = fmaf(e, vv.y, o[4 * c + 1]);
        o[4 * c + 2] = fmaf(e, vv.z, o[4 * c + 2]);
        o[4 * c + 3] = fmaf(e, vv.w, o[4 * c + 3]);
      }
    }
  }
  l += __shfl_xor_sync(0xffffffffu, l, 1);
#pragma unroll
  for (int d = 0; d < kHD; ++d) o[d] += __shfl_xor_sync(0xffffffffu, o[d], 1);
  const float inv = 1.f / l;
  float4* dst = reinterpret_cast<float4*>(p.o + row * p.c + h * kHD + 16 * u);
  if (u == 0) {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      dst[c] = make_float4(o[4 * c] * inv, o[4 * c + 1] * inv, o[4 * c + 2] * inv,
                           o[4 * c + 3] * inv);
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      dst[c] = make_float4(o[16 + 4 * c] * inv, o[17 + 4 * c] * inv, o[18 + 4 * c] * inv,
                           o[19 + 4 * c] * inv);
  }
}

inline bool aligned(const void* p) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <bool kMap>
cudaError_t launch(const Params& p, int windows, cudaStream_t s) {
  if (!aligned(p.qkv) || !aligned(p.bias) || !aligned(p.mask) || !aligned(p.o))
    return cudaErrorInvalidValue;
  msa_f32_kernel<kMap><<<dim3(windows, p.heads), kThreads, 0, s>>>(p);
  return cudaGetLastError();
}

}  // namespace msa32
}  // namespace lavt

// K1 f32's attention: qkv (B nW 144, 3C) f32 (q post-scale), bias (heads,
// 144, 144) f32, mask (nW, 144, 144) f32 or null with its window flags
// (nW,) int32 or null; writes o (B nW 144, C) f32.  C = 32 heads.
extern "C" int lavt_msa_fwd_f32(const void* qkv, const void* bias, const void* mask,
                                const void* flags, void* o, int Bw, int nW, int C, int heads,
                                void* stream) {
  using namespace lavt::msa32;
  if (Bw < 1 || nW < 1 || Bw % nW != 0 || heads < 1 || C != heads * kHD)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{static_cast<const float*>(qkv), static_cast<const float*>(bias),
                 static_cast<const float*>(mask), static_cast<const int*>(flags),
                 static_cast<float*>(o), nW, C, heads, 0, 0};
  return static_cast<int>(launch<false>(p, Bw, static_cast<cudaStream_t>(stream)));
}

// K11 f32's attention: qkv (B, Hp, Wp, 3C) f32 (q post-scale), Hp and Wp
// multiples of 12, bias (heads, 144, 144) f32, mask (nW, 144, 144) f32 or
// null with nW = (Hp / 12)(Wp / 12) and its window flags (nW,) int32 or
// null; writes o (B, Hp, Wp, C) f32 at the windows' map positions.
extern "C" int lavt_msa_fwd_map_f32(const void* qkv, const void* bias, const void* mask,
                                    const void* flags, void* o, int B, int Hp, int Wp, int C,
                                    int heads, void* stream) {
  using namespace lavt::msa32;
  if (B < 1 || Hp < kWS || Wp < kWS || Hp % kWS != 0 || Wp % kWS != 0 || heads < 1 ||
      C != heads * kHD)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nW = (Hp / kWS) * (Wp / kWS);
  const Params p{static_cast<const float*>(qkv), static_cast<const float*>(bias),
                 static_cast<const float*>(mask), static_cast<const int*>(flags),
                 static_cast<float*>(o), nW, C, heads, Hp, Wp};
  return static_cast<int>(launch<true>(p, B * nW, static_cast<cudaStream_t>(stream)));
}
