// K1, K2, the K1/K2 save mode and K11 for Hopper (sm_90a): the attention
// launch of the fused window MSA, between the qkv projection and the
// out-projection on the wgmma + TMA GEMM core (gemm_bias,
// csrc/window_msa_sm90.cu).  K6 runs the same launch before K5's.
//
// Replaces lavt_rs_tpu/ops/pallas/fused_msa.py:_fwd_call/_kernel at the
// window-12 token count (N = 144) for fused_window_msa (K2),
// fused_window_msa_ln (K1, whose LayerNorm runs first as K4's row launch,
// csrc/ln.cu) and, with save=True, both variants' training forward
// (_fwd(..., save=True)); and, in map order, lavt_rs_tpu/ops/pallas/
// experimental.py:_fwd_2d/_kernel_2d (K11), whose in-kernel window slices
// Mosaic rejects on the TPU.  Per window and head, with hd = 32 and q, k,
// v read from the bf16 qkv tensor that the qkv projection wrote (q scaled
// after its bias, rounded once):
//   S = q k^T + bias[h] + mask[w mod nW]                  (f32)
//   P = bf16(softmax(S)), the exact max-subtracted softmax, normalised in
//       f32 before the rounding                           (save: stored)
//   O[:, 32h:32h+32] = bf16(P v), from those bf16 P values
// the TPU kernel's rounding points (lavt_rs_tpu/ops/pallas/fused_msa.py:
// 118-124): the P that K5 reads back is the P that O was made from.  With
// the saves off the same code runs without the P store, so O has the same
// bits in both modes.  Masks: a window reads mask[w mod nW] only where its
// flag is set (ops/window.shift_mask_flags_2d; every window without flags).
//
// Window order (K1, K2, the save mode): qkv is (B nW 144, 3C) and O
// (B nW 144, C).  Map order (K11): qkv is a padded, pre-rolled (B, Hp, Wp,
// 3C) map and O the (B, Hp, Wp, C) map; window (b, wy, wx) is 12 runs of
// 12 tokens, token 12 i + j at map row (b Hp + 12 wy + i) Wp + 12 wx + j,
// and its place in the image wy (Wp / 12) + wx is w mod nW, as in window
// order.  No partition or reverse copy is made, and the out-projection
// runs on O viewed as (B Hp Wp, C), whose rows are already the map.
//
// Bound on the H100, per call: 4 N^2 hd flops per window and head against
// qkv and O in bf16, the f32 bias and the masked windows' mask, and in
// save mode P.  At Swin-B stage 3 (bs 8: 72 windows, C = 512, 16 heads)
// 3.06 GFLOP (0.003 ms) against 42.5 MB of qkv and O + 1.3 MB of bias
// (+ 0.4 MB of mask for the 5 masked windows of a shifted block) + 47.8 MB
// of P: bytes, 0.013 ms without P and 0.028 ms with it.
//
// Why the first design (one kernel for K1, K11 and the save mode, then a
// WMMA GEMM for the out-projection; both retired) lost to the library
// chain: one block per (window, head)
// streamed the window's whole x (144 x C) through shared memory and
// formed its own head's q, k, v with WMMA (mma.sync) behind synchronous
// loads, so x was read `heads` times per window (16 at stage 3, 32 at
// stage 4), and the qkv product ran without TMA or wgmma; the scores went
// through 85 KB of shared memory in f32, the bias and mask read per thread
// from L2; its out-projection was a WMMA GEMM.
//
// Design.  The qkv projection and the out-projection are GEMMs on the core
// (x read once for all heads).  This launch: a block of three warpgroups
// takes the windows g, g + G, ... of one head h (grid (G, heads), at most
// one block per SM); warpgroup w owns query rows 64 w .. 64 w + 63 (the
// third holds 16 real rows: rows >= 144 are never written).  Per window
// one thread's TMA loads bring the head's q, k, v into a ring of two
// stages, so the next window's loads overlap this one's math: in window
// order three 64-row tiles each (64-byte swizzle, from 4-D maps on qkv at
// row stride 3C; rows >= 144 load as zeros), in map order one box each of
// 32 columns x 12 x 12 map rows, which lands as the window's 144 rows in
// the same swizzled layout (the swizzle follows the shared-memory offset,
// and a 4 KB tile is a whole number of its 512-byte periods).  The map
// box leaves rows 144-191 of each part as they were: no live output reads
// them (S takes keys 0-143 of k, O = P v keys 0-143 of v, and q rows past
// 143 belong to the third warpgroup's three dead warps, whose S, P and O
// rows are neither normalised nor stored; a wgmma row depends on its own
// A row only).  The head's bias is copied into shared memory once per
// block (rows 152 floats apart: the float2 reads of a fragment row hit 32
// banks); a masked window's mask rows are read from L2 in the fragments'
// layout.  S for the warpgroup's 64 rows and all 144 keys is one m64n144
// accumulator (72 f32 registers a thread, two wgmma k steps, q from
// registers, k the K-major B); the softmax runs on it in registers (row
// max and sum over the four threads of a row, exp as ex2 of one FMA; the
// third tile's three warps with no real row skip it); P is packed to bf16
// A fragments once and fed to O = P v as wgmma m64n32k16 in the RS form
// (nine 16-key steps, v the MN-major B).  In save mode the same fragments
// are staged as the warpgroup's 64 rows of P (288-byte rows) and leave by
// one TMA store, which runs under O = P v (stored from the fragments by
// 4-byte writes instead, the save mode took about half as long again on
// an H100).  O leaves as bf16 pairs into the head's 32 columns.  Shared
// memory: 2 x 36 KB stages + 85.5 KB bias (+ 54 KB of staged P) = 159
// (213) KB, one block of 384 threads per SM.  ptxas -v (the card's nvcc,
// sm_90a): 146 registers (150 in save mode), no spills.

#include "attn_sm90.cuh"
#include "common.cuh"

namespace lavt {
namespace msa_fwd {

using namespace attn;

constexpr int kWS = 12;                        // window side
constexpr int kN = kWS * kWS;                  // window 12 x 12
constexpr int kNT = 3;                         // 64-row tiles of a window
constexpr int kWG = 3;                         // warpgroup w: query tile w
constexpr int kThreads = 128 * kWG;
constexpr int kHeadBytes = kNT * kTileBytes;   // one head's 192 rows: 12 KB
constexpr int kStageBytes = 3 * kHeadBytes;    // q, k, v
constexpr int kMapBytes = kN * kHD * 2;        // a map-order box: 144 rows
constexpr int kStages = 2;
constexpr int kLdB = 152;                      // f32 row stride of the bias tile
constexpr int kBiasBytes = kN * kLdB * 4;
constexpr int kBarOff = kStages * kStageBytes + kBiasBytes;  // the ring's barriers
constexpr int kPStageOff = kBarOff + 128;      // save mode: P's staged rows
constexpr int kPStageBytes = kT * kN * 2;      // a warpgroup's 64 rows of P
constexpr size_t smem_bytes(bool save) {
  return 1024 + kPStageOff + (save ? kWG * kPStageBytes : 0);
}
static_assert(smem_bytes(true) <= 232448, "one block per SM");

// a bulk tensor store of a staged box (P's 64 rows of one window and head)
__device__ __forceinline__ void tma_store3(const CUtensorMap* m, uint32_t src, int c0, int c1,
                                           int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(m)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

struct Params {
  CUtensorMap q, k, v;  // 4-D head maps on qkv (map order: window boxes)
  CUtensorMap pmap;     // P as (144, 144, B nW heads), boxes of 64 rows
  const float* bias;    // (heads, 144, 144)
  const float* mask;    // (nW, 144, 144) or null
  const int* flags;     // (nW,): the windows that read their mask; null: all
  bf16* o;              // (B nW 144, C); map order: (B, Hp, Wp, C)
  bf16* p;              // (B nW, heads, 144, 144), save mode
  int bw, nw, c, heads;
  int hp, wp;           // map order: the map's padded height and width
};

// map order: the first map row of window win = (b, wy, wx) and its
// coordinates (12 wx, 12 wy, b) in the tensor maps' (C, Wp, Hp, B) dims
struct MapWindow {
  long long row0;
  int x, y, b;
};
__device__ __forceinline__ MapWindow map_window(const Params& p, int win) {
  const int nww = p.wp / kWS, b = win / p.nw, wi = win % p.nw;
  const int y = wi / nww * kWS, x = wi % nww * kWS;
  return {(static_cast<long long>(b) * p.hp + y) * p.wp + x, x, y, b};
}

// kMap: qkv and O in map order (K11, no saves), else in window order
template <bool kSave, bool kMap>
__global__ void __launch_bounds__(kThreads, 1)
    msa_fwd_sm90_kernel(const __grid_constant__ Params p) {
  static_assert(!(kSave && kMap), "the map order has no save mode");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* stages = smem;
  float* bias = reinterpret_cast<float*>(smem + kStages * kStageBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kBarOff);
  unsigned char* pstage = smem + kPStageOff;
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int warp = t / 32, g = (t % 32) / 4, tq = t % 4;
  const int h = blockIdx.y, C = p.c;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  auto issue = [&](int win, int s) {
    uint64_t* bar = &full[s];
    const uint32_t base = smem_u32(stages + s * kStageBytes);
    if constexpr (kMap) {  // one 32 x 12 x 12 box a part: rows 0-143
      const MapWindow mw = map_window(p, win);
      mbar_expect_tx(bar, 3 * kMapBytes);
      tma4(&p.q, base, bar, h * kHD, mw.x, mw.y, mw.b);
      tma4(&p.k, base + kHeadBytes, bar, h * kHD, mw.x, mw.y, mw.b);
      tma4(&p.v, base + 2 * kHeadBytes, bar, h * kHD, mw.x, mw.y, mw.b);
      return;
    }
    mbar_expect_tx(bar, kStageBytes);
    for (int i = 0; i < kNT; ++i) {
      tma4(&p.q, base + i * kTileBytes, bar, 0, h, i * kT, win);
      tma4(&p.k, base + kHeadBytes + i * kTileBytes, bar, 0, h, i * kT, win);
      tma4(&p.v, base + 2 * kHeadBytes + i * kTileBytes, bar, 0, h, i * kT, win);
    }
  };
  if (threadIdx.x == 0)
    for (int s = 0; s < kStages; ++s) {
      const int win = blockIdx.x + s * gridDim.x;
      if (win < p.bw) issue(win, s);
    }
  // the head's bias, rows kLdB floats apart
  const float* bh = p.bias + static_cast<size_t>(h) * kN * kN;
  for (int i = threadIdx.x; i < kN * kN / 4; i += kThreads) {
    const int r = i / (kN / 4), c4 = i % (kN / 4);
    *reinterpret_cast<float4*>(bias + r * kLdB + 4 * c4) =
        __ldg(reinterpret_cast<const float4*>(bh + r * kN) + c4);
  }
  __syncthreads();

  int it = 0;
  for (int win = blockIdx.x; win < p.bw; win += gridDim.x, ++it) {
    const int s = it % kStages;
    const unsigned char* st = stages + s * kStageBytes;
    const uint32_t kaddr = smem_u32(st) + kHeadBytes, vaddr = kaddr + kHeadBytes;
    mbar_wait(&full[s], (it / kStages) & 1);

    // S = q k^T over all 144 keys
    uint32_t qa[2][4];
    tile_frags(qa, st + wg * kTileBytes, 1.f);  // q is scaled already
    float acc[72];
#pragma unroll
    for (int d = 0; d < 72; ++d) acc[d] = 0.f;
    pin(acc);
    pin(qa[0]);
    pin(qa[1]);
    wgmma_fence();
    wgmma_n144(acc, qa[0], kmajor(kaddr, 0));
    wgmma_n144(acc, qa[1], kmajor(kaddr, 1));
    wgmma_commit();
    wgmma_wait<0>();
    pin(acc);

    // + bias (+ mask), then the exact softmax of each row in f32; a warp
    // whose rows are all past 144 (the third tile) keeps its zeros
    const int wi = win % p.nw;
    const bool masked = p.mask != nullptr && (p.flags == nullptr || p.flags[wi] != 0);
    const float* mw = masked ? p.mask + static_cast<size_t>(wi) * kN * kN : nullptr;
    const bool live = wg * kT + warp * 16 < kN;
    float inv[2] = {0.f, 0.f};
#pragma unroll
    for (int hh = 0; hh < 2 && live; ++hh) {
      const int r = wg * kT + warp * 16 + g + 8 * hh;
      float mx = neg_inf();
      {
        const float* br = bias + r * kLdB;
#pragma unroll
        for (int jn = 0; jn < 18; ++jn) {
          const int c = 8 * jn + 2 * tq;
          const float2 b = *reinterpret_cast<const float2*>(br + c);
          float& s0 = acc[4 * jn + 2 * hh];
          float& s1 = acc[4 * jn + 2 * hh + 1];
          s0 += b.x, s1 += b.y;
        }
        if (masked) {
          const float2* mr = reinterpret_cast<const float2*>(mw + r * kN);
#pragma unroll
          for (int jn = 0; jn < 18; ++jn) {
            const float2 m = __ldg(mr + 4 * jn + tq);
            acc[4 * jn + 2 * hh] += m.x, acc[4 * jn + 2 * hh + 1] += m.y;
          }
        }
      }
#pragma unroll
      for (int jn = 0; jn < 18; ++jn)
        mx = fmaxf(mx, fmaxf(acc[4 * jn + 2 * hh], acc[4 * jn + 2 * hh + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float ml = mx * kLog2e;
      float sum = 0.f;
#pragma unroll
      for (int jn = 0; jn < 18; ++jn) {
        float& s0 = acc[4 * jn + 2 * hh];
        float& s1 = acc[4 * jn + 2 * hh + 1];
        s0 = ex2(fmaf(s0, kLog2e, -ml));
        s1 = ex2(fmaf(s1, kLog2e, -ml));
        sum += s0 + s1;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      inv[hh] = 1.f / sum;
    }
    // P = bf16(exp / sum) as A fragments, 16 keys a step: (row ra, keys
    // 16 kk + 2 tq), (rb, same), (ra, + 8), (rb, + 8); zeros in a dead warp
    uint32_t pa[9][4];
#pragma unroll
    for (int kk = 0; kk < 9; ++kk) {
      pa[kk][0] = pack_bf2(acc[8 * kk] * inv[0], acc[8 * kk + 1] * inv[0]);
      pa[kk][1] = pack_bf2(acc[8 * kk + 2] * inv[1], acc[8 * kk + 3] * inv[1]);
      pa[kk][2] = pack_bf2(acc[8 * kk + 4] * inv[0], acc[8 * kk + 5] * inv[0]);
      pa[kk][3] = pack_bf2(acc[8 * kk + 6] * inv[1], acc[8 * kk + 7] * inv[1]);
    }
    const int ra = wg * kT + warp * 16 + g, rb = ra + 8;
    if constexpr (kSave) {  // P's 64 x 144 rows staged, then one TMA store
      if (live) {
        unsigned char* pst = pstage + wg * kPStageBytes + (warp * 16 + g) * kN * 2 + 4 * tq;
#pragma unroll
        for (int kk = 0; kk < 9; ++kk) {
          *reinterpret_cast<uint32_t*>(pst + 32 * kk) = pa[kk][0];
          *reinterpret_cast<uint32_t*>(pst + 8 * kN * 2 + 32 * kk) = pa[kk][1];
          *reinterpret_cast<uint32_t*>(pst + 32 * kk + 16) = pa[kk][2];
          *reinterpret_cast<uint32_t*>(pst + 8 * kN * 2 + 32 * kk + 16) = pa[kk][3];
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      named_sync(1 + wg);
      if (t == 0) {
        tma_store3(&p.pmap, smem_u32(pstage + wg * kPStageBytes), 0, wg * kT,
                   win * p.heads + h);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
    }

    // O = P v (nine 16-key steps)
    float oacc[16];
#pragma unroll
    for (int d = 0; d < 16; ++d) oacc[d] = 0.f;
    pin(oacc);
#pragma unroll
    for (int kk = 0; kk < 9; ++kk) pin(pa[kk]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 9; ++kk)
      wgmma_o(oacc, pa[kk], mnmajor(vaddr + (kk / 4) * kTileBytes, kk % 4));
    wgmma_commit();
    wgmma_wait<0>();
    pin(oacc);
    // the P store has read its staging rows
    if (kSave && t == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    __syncthreads();  // every warpgroup is done with stage s
    if (threadIdx.x == 0 && win + kStages * gridDim.x < p.bw) issue(win + kStages * gridDim.x, s);

    if (live) {
      const long long row0 = kMap ? map_window(p, win).row0 : static_cast<long long>(win) * kN;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = hh ? rb : ra;
        const long long tok = kMap ? row0 + (r / kWS) * p.wp + r % kWS : row0 + r;
        bf16* orow = p.o + tok * C + h * kHD;
#pragma unroll
        for (int d = 0; d < 4; ++d)
          *reinterpret_cast<uint32_t*>(orow + 8 * d + 2 * tq) =
              pack_bf2(oacc[4 * d + 2 * hh], oacc[4 * d + 2 * hh + 1]);
      }
    }
  }
  if (kSave && t == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// map order: q, k or v of a (B, Hp, Wp, 3C) qkv map (ptr at its first
// column) as (C, Wp, Hp, B) at the map's strides, boxes of one head's
// 12 x 12 window (144 rows of 64 bytes), in the head tiles' swizzle
inline cudaError_t map_part(CUtensorMap* map, const void* ptr, int B, int Hp, int Wp, int C) {
  const cuuint64_t ld = 3ull * C * 2;  // bytes between map rows
  const cuuint64_t dims[4] = {cuuint64_t(C), cuuint64_t(Wp), cuuint64_t(Hp), cuuint64_t(B)};
  const cuuint64_t strides[3] = {ld, ld * Wp, ld * Wp * Hp};
  const cuuint32_t box[4] = {kHD, kWS, kWS, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, ptr, dims, strides, box,
                CU_TENSOR_MAP_SWIZZLE_64B);
}

template <bool kSave, bool kMap>
cudaError_t launch(const Params& pr, int groups, cudaStream_t stream) {
  auto kernel = &msa_fwd_sm90_kernel<kSave, kMap>;
  const size_t smem = smem_bytes(kSave);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(groups, pr.heads), kThreads, smem, stream>>>(pr);
  return cudaGetLastError();
}

inline void set_args(Params* pr, const void* bias, const void* mask, const void* flags, void* o,
                     int Bw, int nW, int C, int heads) {
  pr->bias = static_cast<const float*>(bias);
  pr->mask = static_cast<const float*>(mask);
  pr->flags = static_cast<const int*>(flags);
  pr->o = static_cast<bf16*>(o);
  pr->p = nullptr;
  pr->bw = Bw, pr->nw = nW, pr->c = C, pr->heads = heads;
  pr->hp = pr->wp = 0;
}

}  // namespace msa_fwd
}  // namespace lavt

// qkv (B nW 144, 3C) bf16 (q post-scale), bias (heads, 144, 144) f32, mask
// (nW, 144, 144) f32 or null with its window flags (nW,) int32 or null;
// writes o (B nW 144, C) bf16 and, where p is not null, P (B nW, heads,
// 144, 144) bf16.  Grid (groups, heads): block (g, h) takes windows g,
// g + groups, ...
extern "C" int lavt_msa_fwd_sm90(const void* qkv, const void* bias, const void* mask,
                                 const void* flags, void* o, void* p, int Bw, int nW, int C,
                                 int heads, int groups, void* stream) {
  using namespace lavt;
  using namespace lavt::msa_fwd;
  if (Bw < 1 || nW < 1 || heads < 1 || C != heads * kHD || groups < 1 || groups > Bw)
    return static_cast<int>(cudaErrorInvalidValue);
  Params pr;
  const long long ld = 3LL * C, sw = kN * ld;
  const bf16* base = static_cast<const bf16*>(qkv);
  cudaError_t err = map_qkv(&pr.q, base, Bw, heads, kN, sw, kHD, ld);
  if (err == cudaSuccess) err = map_qkv(&pr.k, base + C, Bw, heads, kN, sw, kHD, ld);
  if (err == cudaSuccess) err = map_qkv(&pr.v, base + 2 * C, Bw, heads, kN, sw, kHD, ld);
  if (err == cudaSuccess && p != nullptr) {
    const cuuint64_t dims[3] = {kN, kN, cuuint64_t(Bw) * heads};
    const cuuint64_t strides[2] = {kN * 2, kN * kN * 2};
    const cuuint32_t box[3] = {kN, kT, 1};
    err = encode(&pr.pmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, p, dims, strides, box,
                 CU_TENSOR_MAP_SWIZZLE_NONE);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  set_args(&pr, bias, mask, flags, o, Bw, nW, C, heads);
  pr.p = static_cast<bf16*>(p);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(p != nullptr ? launch<true, false>(pr, groups, s)
                                       : launch<false, false>(pr, groups, s));
}

// K11's attention: qkv (B, Hp, Wp, 3C) bf16 (q post-scale), Hp and Wp
// multiples of 12, bias (heads, 144, 144) f32, mask (nW, 144, 144) f32 or
// null with nW = (Hp / 12)(Wp / 12) and its window flags (nW,) int32 or
// null; writes o (B, Hp, Wp, C) bf16 at the windows' map positions.  Grid
// (groups, heads) over the B nW windows, b-major, as in window order.
extern "C" int lavt_msa_fwd_map_sm90(const void* qkv, const void* bias, const void* mask,
                                     const void* flags, void* o, int B, int Hp, int Wp, int C,
                                     int heads, int groups, void* stream) {
  using namespace lavt;
  using namespace lavt::msa_fwd;
  if (B < 1 || Hp < kWS || Wp < kWS || Hp % kWS != 0 || Wp % kWS != 0 || heads < 1 ||
      C != heads * kHD)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nW = (Hp / kWS) * (Wp / kWS), Bw = B * nW;
  if (groups < 1 || groups > Bw) return static_cast<int>(cudaErrorInvalidValue);
  Params pr;
  const bf16* base = static_cast<const bf16*>(qkv);
  cudaError_t err = map_part(&pr.q, base, B, Hp, Wp, C);
  if (err == cudaSuccess) err = map_part(&pr.k, base + C, B, Hp, Wp, C);
  if (err == cudaSuccess) err = map_part(&pr.v, base + 2 * C, B, Hp, Wp, C);
  if (err != cudaSuccess) return static_cast<int>(err);
  set_args(&pr, bias, mask, flags, o, Bw, nW, C, heads);
  pr.hp = Hp, pr.wp = Wp;
  return static_cast<int>(launch<false, true>(pr, groups, static_cast<cudaStream_t>(stream)));
}
