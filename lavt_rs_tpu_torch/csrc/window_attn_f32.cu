// K10 f32: attention-only window attention on pre-projected f32 heads, with
// its save mode.
//
// Replaces the f32 computation of lavt_rs_tpu/ops/pallas/window_attn.py:
// _fwd/_fwd_kernel (reached from window_attention_pallas) and, in save
// mode, _vjp_fwd, on f32 activations (`--no_bf16` with Pallas: the TPU
// kernel computes in f32 and its roundings to the input dtype are no-ops).
// Per window and head, hd = 32 and any N <= 400:
//   s = (q scale) k^T + bias[h] + mask
//   O = softmax(s) v           f32, with max subtraction (an online softmax)
// The save mode also writes lse = m + log(l) in f32, (B nW, heads, N), the
// layout K9 f32 (csrc/window_attn_bwd_f32.cu) reads.  Masks: window wi =
// win mod nW takes no mask when wi < nu, else mask[wi - nu] (nu = 0 with a
// full mask, nW without one): the grouping of K2p f32's attention launch.
// q, k, v are read and O is written at given (window, head, row) element
// strides, so one kernel serves the qkv Linear's output (the inference
// route and K2p), and contiguous (B, nW, heads, N, 32) tensors (autograd).
//
// Bound on the H100, per call: 4 N^2 hd flops per window and head against
// f32 q, k, v, O, the bias and the masked windows' masks.  Video stage 2
// (81 windows x 6 heads, N = 392) 9.6 GFLOP (0.058 ms at 165 TFLOP/s, the
// f32 rows' convention; 0.143 ms at the 67 TFLOP/s of the FP32 cores this
// kernel uses) against 101 MB of q/k/v/O and bias (0.030 ms): operations.
// Window-7 stage 1 (bs 8: 2592 windows x 4 heads, N = 49) 3.2 GFLOP against
// 260 MB: bytes, 0.078 ms.
//
// Design (FFMA, not the tensor cores; register-blocked tiles,
// csrc/attn_f32.cuh): an item is 64 query rows of one (window, head), a
// block of 128 threads; a block takes `per_block` consecutive items
// (several (window, head) units at N <= 64, where one item is a unit).
// The item's q (scaled) is staged d-major; per key tile of 64 the block
// stages k d-major and v row-major, then
//   S = q k^T: each thread an 8 x 4 block of the 64 x 64 scores (three
//     16-byte loads a d feed 32 FMAs), + bias + mask (read along the keys
//     from L2: coalesced), -inf past N;
//   the online softmax: each row's max over its 16 threads (shuffles),
//     P = exp(S - m), each thread's share of the row sums kept apart and
//     rescaled, P staged row-major with each row's rescale factor;
//   O += P v: each thread a 4 x 4 block of the 64 x 32 output (eight
//     16-byte loads feed 64 FMAs), rescaled first.
// At the end the row sums are added over their 16 threads; O / l is
// written at O's strides and, in save mode, lse = m + log(l).  Static
// shared memory: 44.5 KB a block.
// (The first design, a thread per query row with q in registers and the
// keys read by broadcast 16-byte loads, one load per four FMAs, ran 0.84
// ms at video stage 2, where this one runs 0.61: PERF.md.)

#include <cstdint>

#include "attn_f32.cuh"

namespace lavt {
namespace k10f32 {

using namespace attn32;

constexpr int kNMax = 400;
constexpr float kNeg = -1e30f;  // the running max before any key: exp(kNeg - m) = 0

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const float* bias;  // (heads, N, N)
  const float* mask;  // (nW - nu, N, N) or null
  float* o;
  float* lse;         // (Bw, heads, N) or null
  long long qsw, qsh, qsn, osw, osh, osn;
  int bw, nw, nu, heads, n, nqt, items, per_block;
  float scale;
};

template <bool kSave>
__global__ void __launch_bounds__(kThreads) window_attn_f32_kernel(const Params p) {
  __shared__ __align__(16) float qs[kTileT];   // q (scaled), d-major
  __shared__ __align__(16) float ks[kTileT];   // k, d-major
  __shared__ __align__(16) float vs[kTileR];   // v, row-major
  __shared__ __align__(16) float ps[kTileS];   // P, row-major
  __shared__ float alpha_s[kT], l_s[kT];
  const int t = threadIdx.x, n = p.n;
  const int ty = t / 16, tx = t % 16, rg = t / 8, dg = t % 8;
  const int first = blockIdx.x * p.per_block;
  const int last = min(first + p.per_block, p.items);
  for (int item = first; item < last; ++item) {
    const int qt = item % p.nqt, unit = item / p.nqt;  // unit = window heads + head
    const int h = unit % p.heads, win = unit / p.heads;
    const int row0 = qt * kT;
    const long long base = win * p.qsw + h * p.qsh;
    const int wi = win % p.nw;
    const float* mask =
        (p.mask != nullptr && wi >= p.nu) ? p.mask + static_cast<size_t>(wi - p.nu) * n * n : nullptr;
    const float* bias = p.bias + static_cast<size_t>(h) * n * n;
    __syncthreads();  // the last item's readers are done
    load_t(qs, p.q + base, p.qsn, row0, n, p.scale);
    float m[8], lp[8], o[4][4];
#pragma unroll
    for (int r = 0; r < 8; ++r) m[r] = kNeg, lp[r] = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) o[i][j] = 0.f;
    for (int kt = 0; kt < n; kt += kT) {
      const int kn = min(kT, n - kt);
      __syncthreads();  // the last tile's readers of ks, vs, ps are done
      load_t(ks, p.k + base, p.qsn, kt, n);
      load_r(vs, p.v + base, p.qsn, kt, n);
      __syncthreads();
      float s[8][4];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
      mma_nt(s, qs, ks, ty, tx);
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int row = min(row0 + s_row(ty, r), n - 1);  // rows past N: never written
        float mt = kNeg;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = s_col(tx, c);
          if (j < kn) {
            const size_t off = static_cast<size_t>(row) * n + kt + j;
            s[r][c] += __ldg(bias + off) + (mask != nullptr ? __ldg(mask + off) : 0.f);
            mt = fmaxf(mt, s[r][c]);
          } else {
            s[r][c] = neg_inf();
          }
        }
        const float mn = fmaxf(m[r], row_max16(mt));
        const float alpha = expf(m[r] - mn);
        m[r] = mn;
        float sum = 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[r][c] = expf(s[r][c] - mn);
          sum += s[r][c];
        }
        lp[r] = lp[r] * alpha + sum;
        if (tx == 0) alpha_s[s_row(ty, r)] = alpha;
      }
      store_s(ps, s, ty, tx);
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a = alpha_s[rg + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) o[i][j] *= a;
      }
      mma_nn(o, ps, vs, rg, dg, (kn + 3) / 4 * 4);
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float l = row_sum16(lp[r]);
      const int row = row0 + s_row(ty, r);
      if (tx == 0) {
        l_s[s_row(ty, r)] = l;
        if (kSave && row < n) p.lse[static_cast<size_t>(unit) * n + row] = m[r] + logf(l);
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + rg + 16 * i;
      if (row < n) {
        const float inv = 1.f / l_s[rg + 16 * i];
        *reinterpret_cast<float4*>(p.o + win * p.osw + h * p.osh + row * p.osn + 4 * dg) =
            make_float4(o[i][0] * inv, o[i][1] * inv, o[i][2] * inv, o[i][3] * inv);
      }
    }
  }
}

inline bool aligned(const void* ptr) {
  return ptr == nullptr || reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

}  // namespace k10f32
}  // namespace lavt

// K10 f32: q, k, v f32 with element strides (window, head, row) qsw, qsh, qsn
// over Bw = B nW windows (hd contiguous; strides multiples of 4, bases 16-byte
// aligned), bias (heads, N, N) f32, mask (nW - nu, N, N) f32 or null (windows
// wi = win mod nW >= nu take mask[wi - nu]); writes O at strides osw, osh,
// osn and, when lse is not null, lse (Bw, heads, N) f32.  `per_block`
// consecutive items (64 query rows of one (window, head)) a block
// (ops/window_attn.k10_f32_plan).
extern "C" int lavt_window_attn_f32(const void* q, const void* k, const void* v,
                                    const void* bias, const void* mask, void* o, void* lse,
                                    long long qsw, long long qsh, long long qsn, long long osw,
                                    long long osh, long long osn, int Bw, int nW, int nu,
                                    int heads, int n, int per_block, float scale,
                                    void* stream) {
  using namespace lavt::k10f32;
  if (n < 1 || n > kNMax || heads < 1 || Bw < 1 || nW < 1 || Bw % nW != 0 || nu < 0 ||
      nu > nW || per_block < 1 || ((qsw | qsh | qsn | osw | osh | osn) & 3) != 0 ||
      !aligned(q) || !aligned(k) || !aligned(v) || !aligned(o))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = static_cast<const float*>(q), p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v), p.bias = static_cast<const float*>(bias);
  p.mask = static_cast<const float*>(mask), p.o = static_cast<float*>(o);
  p.lse = static_cast<float*>(lse);
  p.qsw = qsw, p.qsh = qsh, p.qsn = qsn, p.osw = osw, p.osh = osh, p.osn = osn;
  p.bw = Bw, p.nw = nW, p.nu = nu, p.heads = heads, p.n = n;
  p.nqt = (n + kT - 1) / kT;
  p.items = Bw * heads * p.nqt;
  p.per_block = per_block;
  p.scale = scale;
  const int blocks = (p.items + per_block - 1) / per_block;
  auto s = static_cast<cudaStream_t>(stream);
  if (lse != nullptr)
    window_attn_f32_kernel<true><<<blocks, kThreads, 0, s>>>(p);
  else
    window_attn_f32_kernel<false><<<blocks, kThreads, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}
