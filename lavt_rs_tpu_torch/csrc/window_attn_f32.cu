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
// full mask, nW without one): the grouping of
// window_attn.attention_qkv_grouped.
// q, k, v are read and O is written at given (window, head, row) element
// strides, so one kernel serves the qkv Linear's output (the inference
// route and K2p), and contiguous (B, nW, heads, N, 32) tensors (autograd).
//
// Bound on the H100, per call: 4 N^2 hd flops per window and head against
// f32 q, k, v, O, the bias and the masked windows' masks.  Video stage 2
// (81 windows x 6 heads, N = 392) 9.6 GFLOP, 0.058 ms at 165 TFLOP/s (495
// TF32 over 3xTF32's three passes), against 101 MB, 0.030 ms: operations.
// Window-7 stage 1 (bs 8: 2592 windows x 4 heads, N = 49) 3.2 GFLOP against
// 260 MB: bytes, 0.078 ms.
//
// Design: every product in 3xTF32 on mma.sync.m16n8k8 (csrc/attn_tf32.cuh:
// truncating splits, B operands split once a key tile into fragment tiles
// shared by the block's warps, a term's three passes issued over
// independent accumulators).  An item is `rows` query rows of one (window,
// head) unit, a warp owning 16 of them; the keys stream in chunks of 56 (7
// key tiles of 8).  Per chunk the block builds k as an NT fragment tile and
// v as an NN one from raw tiles that cp.async landed while the block
// computed the chunk before (the raw tiles and the fragment tiles are the
// two buffers); each warp computes its 16 x 56 scores into C fragments,
// adds bias and mask there (read into registers before the products, so
// that their latency overlaps them), runs the online softmax in registers (row max
// over the chunk by two shuffles, the running sum and O rescaled), and
// feeds P straight into P V as A fragments (`frag_c2a`): P never goes
// through shared memory.  Each chunk's P V is summed into a zeroed partial
// and added to the rescaled O.  q is staged with an item's first chunk,
// scaled and split into registers once an item.  A block walks a run of
// `per_block` consecutive items, ordered (head, query tile, window), with
// the next item's first chunk in flight during the last chunk: its items
// share their bias rows, which stay in L1 after the first.
//   * N <= 56 (window 7, N = 49): one chunk (keys padded to 56), one item
//     a unit, 4 warps (queries padded to 64), bytes-bound: q, k, v and O
//     are read and written once, and the block stages its head's bias once
//     (in C-fragment order, a 16-byte word a lane) for its run of windows.
//   * N > 56 (video, N = 392: 7 chunks): items of 80 query rows, 5 warps,
//     operations-bound; bias and mask read at the C fragments' places.
// Shared memory: 66.8 KB a block at N <= 56, three blocks an SM; 55.0 KB
// above, two blocks an SM (the registers: the prefetched bias and mask).
// (The design before: FFMA on register-blocked 64 x 64 tiles, P staged
// through shared memory, bias and mask read per score: 0.61 ms at video
// stage 2; PERF.md.)

#include <cstdint>

#include "attn_tf32.cuh"

namespace lavt {
namespace k10f32 {

using namespace tf32attn;
using f32mma::cp_commit;
using f32mma::cp_wait;
using f32mma::mma_tf32;

constexpr int kNMax = 400;
constexpr int kChunk = 56, kKT = kChunk / 8;  // keys a chunk, key tiles of 8
constexpr float kNeg = -1e30f;  // the running max before any key: exp(kNeg - m) = 0

// The two variants: N <= kChunk (one chunk, the head's bias staged) or not.
template <bool kSmall>
struct Shape {
  static constexpr int kWarps = kSmall ? 4 : 5;
  static constexpr int kRows = 16 * kWarps;  // query rows of an item
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kPerSm = kSmall ? 3 : 2;  // blocks an SM (registers)
  // bytes: raw q, k, v tiles ([row][kLd] floats), the k NT and v NN
  // fragment tiles, and (N <= 56) the head's bias in C-fragment order
  static constexpr int kRawQ = kRows * kLd * 4;
  static constexpr int kRawKV = kChunk * kLd * 4;
  static constexpr int kFrag = frag_tile_bytes(kChunk);
  static constexpr int kBias = kSmall ? kWarps * kKT * 32 * 16 : 0;
  static constexpr int kSmem = kRawQ + 2 * kRawKV + 2 * kFrag + kBias;
};

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const float* bias;  // (heads, N, N)
  const float* mask;  // (nW - nu, N, N) or null
  float* o;
  float* lse;         // (Bw, heads, N) or null
  long long qsw, qsh, qsn, osw, osh, osn;
  int bw, nw, nu, heads, n, qtiles, chunks, items, per_block;
  float scale;
};

// The head's bias (N <= 56) as each lane's C-fragment words: word (w, j,
// lane (g, t)) = bias[r][8 j + 2 t, + 1] for r = 16 w + g and r + 8 (rows
// past N clamped, keys past N zero)
template <int kWarps>
__device__ __forceinline__ void stage_bias(float4* bf, const float* bias, int n, int threads) {
  for (int i = threadIdx.x; i < kWarps * kKT * 32; i += threads) {
    const int lane = i % 32, j = (i / 32) % kKT, w = i / (32 * kKT);
    const int ra = min(16 * w + lane / 4, n - 1), rb = min(16 * w + lane / 4 + 8, n - 1);
    const int col = 8 * j + 2 * (lane % 4);
    const float* a = bias + size_t(ra) * n;
    const float* b = bias + size_t(rb) * n;
    bf[i] = make_float4(col < n ? __ldg(a + col) : 0.f, col + 1 < n ? __ldg(a + col + 1) : 0.f,
                        col < n ? __ldg(b + col) : 0.f, col + 1 < n ? __ldg(b + col + 1) : 0.f);
  }
}

// v = (a[col], a[col + 1], b[col], b[col + 1]) of two rows of N floats,
// keys past N clamped: by 8-byte pairs at an even N
__device__ __forceinline__ void load_pair(float (&v)[4], const float* a, const float* b, int col,
                                          int n) {
  if (n % 2 == 0) {
    const int c = min(col, n - 2);
    const float2 x = __ldg(reinterpret_cast<const float2*>(a + c));
    const float2 y = __ldg(reinterpret_cast<const float2*>(b + c));
    v[0] = x.x, v[1] = x.y, v[2] = y.x, v[3] = y.y;
  } else {
    const int c0 = min(col, n - 1), c1 = min(col + 1, n - 1);
    v[0] = __ldg(a + c0), v[1] = __ldg(a + c1), v[2] = __ldg(b + c0), v[3] = __ldg(b + c1);
  }
}

// s[J0 .. J0 + NJ) += a k^T at depth step kk, pass by pass
template <int J0, int NJ>
__device__ __forceinline__ void qk_tiles(float (&s)[kKT][4], const Frag4& a, const uint4* kf,
                                         int kk) {
  Frag2 b[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) b[j] = frag_b(kf, J0 + j, kk);
#pragma unroll
  for (int j = 0; j < NJ; ++j) mma_tf32(s[J0 + j], a.lo, b[j].hi);
#pragma unroll
  for (int j = 0; j < NJ; ++j) mma_tf32(s[J0 + j], a.hi, b[j].lo);
#pragma unroll
  for (int j = 0; j < NJ; ++j) mma_tf32(s[J0 + j], a.hi, b[j].hi);
}

template <bool kSmall, bool kSave>
__global__ void __launch_bounds__(Shape<kSmall>::kThreads, Shape<kSmall>::kPerSm)
    window_attn_f32_kernel(const Params p) {
  using S = Shape<kSmall>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* rq = reinterpret_cast<float*>(smem);  // raw q rows of the item
  float* rk = rq + S::kRows * kLd;             // raw k rows of the chunk
  float* rv = rk + kChunk * kLd;               // raw v rows of the chunk
  uint4* kf = reinterpret_cast<uint4*>(rv + kChunk * kLd);  // k, NT
  uint4* vf = kf + S::kFrag / 16;                           // v, NN
  float4* bf = reinterpret_cast<float4*>(vf + S::kFrag / 16);

  const int n = p.n;
  const int first = blockIdx.x * p.per_block;
  const int steps = (min(first + p.per_block, p.items) - first) * p.chunks;
  if (steps <= 0) return;
  const int warp = threadIdx.x / 32, g = lane_g(), t = lane_t();

  // step st: item first + st / chunks, chunk st % chunks; item = (head
  // qtiles + query tile) Bw + window
  auto issue = [&](int st) {
    const int item = first + st / p.chunks, c = st % p.chunks;
    const int hq = item / p.bw, win = item % p.bw, h = hq / p.qtiles;
    const long long base = win * p.qsw + h * p.qsh;
    if (c == 0)
      stage_rows(rq, p.q + base, p.qsn, (hq % p.qtiles) * S::kRows, S::kRows, n, S::kThreads);
    stage_rows(rk, p.k + base, p.qsn, c * kChunk, kChunk, n, S::kThreads);
    stage_rows(rv, p.v + base, p.qsn, c * kChunk, kChunk, n, S::kThreads);
    cp_commit();
  };

  issue(0);
  Frag4 qf[kHD / 8];       // the warp's 16 q rows, scaled and split
  float o[4][4], m[2], l[2];  // O (C fragments), running max and sum of rows g, g + 8
  int staged = -1;          // N <= 56: the head whose bias bf holds
  for (int st = 0; st < steps; ++st) {
    const int item = first + st / p.chunks, c = st % p.chunks;
    const int hq = item / p.bw, win = item % p.bw, h = hq / p.qtiles;
    cp_wait<0>();
    __syncthreads();  // the step's raw tiles landed; the last step's readers are done
    build_frags(kf, nullptr, rk, kChunk, 1.f, S::kThreads);
    build_frags(nullptr, vf, rv, kChunk, 1.f, S::kThreads);
    if (c == 0) {
#pragma unroll
      for (int kk = 0; kk < kHD / 8; ++kk) qf[kk] = frag_a(rq + 16 * warp * kLd, 8 * kk, p.scale);
      m[0] = m[1] = kNeg;
      l[0] = l[1] = 0.f;
      zero(o);
    }
    if constexpr (kSmall) {
      if (h != staged) {
        stage_bias<S::kWarps>(bf, p.bias + size_t(h) * n * n, n, S::kThreads);
        staged = h;
      }
    }
    __syncthreads();  // the fragment tiles (and bias) are built; the raw tiles are free
    if (st + 1 < steps) issue(st + 1);

    const int ra = (hq % p.qtiles) * S::kRows + 16 * warp + g, rb = ra + 8;
    if (ra - g >= n) continue;  // the warp's rows all lie past N
    const int key0 = c * kChunk;

    // bias and mask at the C fragments' places (rows ra, rb; keys key0 +
    // 8 j + 2 t, + 1; rows and keys past N clamped), read before the
    // products so that their latency overlaps them
    const int wi = win % p.nw;
    const float* mk = (p.mask != nullptr && wi >= p.nu)
                          ? p.mask + size_t(wi - p.nu) * n * n
                          : nullptr;
    const size_t offa = size_t(min(ra, n - 1)) * n, offb = size_t(min(rb, n - 1)) * n;
    const float* bh = p.bias + size_t(h) * n * n;
    float bv[kKT][4], mv[kKT][4];
#pragma unroll
    for (int j = 0; j < kKT; ++j) {
      if constexpr (kSmall) {
        const float4 w = bf[(warp * kKT + j) * 32 + threadIdx.x % 32];
        bv[j][0] = w.x, bv[j][1] = w.y, bv[j][2] = w.z, bv[j][3] = w.w;
      } else {
        load_pair(bv[j], bh + offa, bh + offb, key0 + 8 * j + 2 * t, n);
      }
      if (mk != nullptr) load_pair(mv[j], mk + offa, mk + offb, key0 + 8 * j + 2 * t, n);
    }

    // S = q k^T over the chunk's 7 key tiles, in groups of 4 and 3
    float s[kKT][4];
    zero(s);
#pragma unroll
    for (int kk = 0; kk < kHD / 8; ++kk) {
      qk_tiles<0, 4>(s, qf[kk], kf, kk);
      qk_tiles<4, 3>(s, qf[kk], kf, kk);
    }

    // + bias + mask; keys past N at -inf
#pragma unroll
    for (int j = 0; j < kKT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (key0 + 8 * j + 2 * t + e < n) {
          s[j][e] += bv[j][e];
          s[j][2 + e] += bv[j][2 + e];
          if (mk != nullptr) {
            s[j][e] += mv[j][e];
            s[j][2 + e] += mv[j][2 + e];
          }
        } else {
          s[j][e] = s[j][2 + e] = __int_as_float(static_cast<int>(0xff800000u));  // -inf
        }
      }
    }

    // the online softmax: the chunk's row max (the row's four lanes by two
    // shuffles), rescale factors, P = exp(s - m) and its row sums
    float mxa = kNeg, mxb = kNeg;
#pragma unroll
    for (int j = 0; j < kKT; ++j) {
      mxa = fmaxf(mxa, fmaxf(s[j][0], s[j][1]));
      mxb = fmaxf(mxb, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int x = 1; x < 4; x <<= 1) {
      mxa = fmaxf(mxa, __shfl_xor_sync(0xffffffffu, mxa, x));
      mxb = fmaxf(mxb, __shfl_xor_sync(0xffffffffu, mxb, x));
    }
    mxa = fmaxf(m[0], mxa), mxb = fmaxf(m[1], mxb);
    const float aa = expf(m[0] - mxa), ab = expf(m[1] - mxb);
    m[0] = mxa, m[1] = mxb;
    float la = 0.f, lb = 0.f;
#pragma unroll
    for (int j = 0; j < kKT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[j][e] = expf(s[j][e] - mxa);
        s[j][2 + e] = expf(s[j][2 + e] - mxb);
      }
      la += s[j][0] + s[j][1];
      lb += s[j][2] + s[j][3];
    }
    l[0] = l[0] * aa + la;
    l[1] = l[1] * ab + lb;

    // O = O alpha + P V, P V summed into a zeroed partial: the chunk's key
    // tiles are the depth, P's C fragments the A fragments
    float pv[4][4];
    zero(pv);
#pragma unroll
    for (int j = 0; j < kKT; ++j) {
      const Frag4 a = frag_c2a(s[j]);
      Frag2 b[4];
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) b[cc] = frag_b(vf, j, cc);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) mma_tf32(pv[cc], a.lo, b[cc].hi);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) mma_tf32(pv[cc], a.hi, b[cc].lo);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) mma_tf32(pv[cc], a.hi, b[cc].hi);
    }
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      o[cc][0] = o[cc][0] * aa + pv[cc][0];
      o[cc][1] = o[cc][1] * aa + pv[cc][1];
      o[cc][2] = o[cc][2] * ab + pv[cc][2];
      o[cc][3] = o[cc][3] * ab + pv[cc][3];
    }

    if (c == p.chunks - 1) {  // the item's last chunk: O / l and lse
      la = l[0], lb = l[1];
#pragma unroll
      for (int x = 1; x < 4; x <<= 1) {
        la += __shfl_xor_sync(0xffffffffu, la, x);
        lb += __shfl_xor_sync(0xffffffffu, lb, x);
      }
      const float ia = 1.f / la, ib = 1.f / lb;
      float* out = p.o + win * p.osw + h * p.osh + 2 * t;
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        if (ra < n)
          *reinterpret_cast<float2*>(out + ra * p.osn + 8 * cc) =
              make_float2(o[cc][0] * ia, o[cc][1] * ia);
        if (rb < n)
          *reinterpret_cast<float2*>(out + rb * p.osn + 8 * cc) =
              make_float2(o[cc][2] * ib, o[cc][3] * ib);
      }
      if (kSave && t == 0) {
        float* ls = p.lse + (size_t(win) * p.heads + h) * n;
        if (ra < n) ls[ra] = m[0] + logf(la);
        if (rb < n) ls[rb] = m[1] + logf(lb);
      }
    }
  }
}

inline bool aligned(const void* ptr) {
  return ptr == nullptr || reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

template <bool kSmall>
cudaError_t launch(const Params& p, cudaStream_t s) {
  using S = Shape<kSmall>;
  auto kernel = p.lse != nullptr ? window_attn_f32_kernel<kSmall, true>
                                 : window_attn_f32_kernel<kSmall, false>;
  const cudaError_t err = allow_smem(kernel, S::kSmem);
  if (err != cudaSuccess) return err;
  const int blocks = (p.items + p.per_block - 1) / p.per_block;
  kernel<<<blocks, S::kThreads, S::kSmem, s>>>(p);
  return cudaGetLastError();
}

}  // namespace k10f32
}  // namespace lavt

// K10 f32: q, k, v f32 with element strides (window, head, row) qsw, qsh, qsn
// over Bw = B nW windows (hd contiguous; strides multiples of 4, bases 16-byte
// aligned), bias (heads, N, N) f32, mask (nW - nu, N, N) f32 or null (windows
// wi = win mod nW >= nu take mask[wi - nu]); writes O at strides osw, osh,
// osn and, when lse is not null, lse (Bw, heads, N) f32.  Items of 64 query
// rows (N <= 56) or 80 (above) of one (window, head), ordered (head, query
// tile, window); `per_block` consecutive items a block
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
  const bool small = n <= kChunk;
  Params p;
  p.q = static_cast<const float*>(q), p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v), p.bias = static_cast<const float*>(bias);
  p.mask = static_cast<const float*>(mask), p.o = static_cast<float*>(o);
  p.lse = static_cast<float*>(lse);
  p.qsw = qsw, p.qsh = qsh, p.qsn = qsn, p.osw = osw, p.osh = osh, p.osn = osn;
  p.bw = Bw, p.nw = nW, p.nu = nu, p.heads = heads, p.n = n;
  const int rows = small ? Shape<true>::kRows : Shape<false>::kRows;
  p.qtiles = (n + rows - 1) / rows;
  p.chunks = (n + kChunk - 1) / kChunk;
  p.items = Bw * heads * p.qtiles;
  p.per_block = per_block;
  p.scale = scale;
  auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(small ? launch<true>(p, s) : launch<false>(p, s));
}

// The dynamic shared memory of a K10 f32 block at N (ops/window_attn.K10_F32_SMEM)
extern "C" int lavt_k10_f32_smem(int n) {
  using namespace lavt::k10f32;
  return n <= kChunk ? Shape<true>::kSmem : Shape<false>::kSmem;
}
