// K2p for Hopper (sm_90a): the fused window MSA on sublane-padded windows,
// as three launches: the qkv projection and the out-projection on the
// wgmma + TMA GEMM core (gemm_sm90.cuh, this file), and between them the
// attention on K10's kernel (csrc/window_attn_sm90.cu), which reads q, k, v
// by strides where the first launch wrote them.
//
// Replaces lavt_rs_tpu/ops/pallas/fused_msa.py:_fwd_call/_kernel at the
// sublane-padded token count (fused_window_msa_padded, :891, and the
// grouped 3D route of models/swin3d.py): x is (B nW, n_p, C) bf16 with n_p
// a multiple of 16 (392 -> 400), the bias (heads, n_p, n_p) f32 carries
// -1e9 on the padded key columns, and per window and head
//   q, k, v = bf16((x Wqkv^T + bqkv) (q: times scale, after its bias))
//   O = softmax(q k^T + bias[h] + mask[window]) v      (f32 softmax)
//   y = bf16(O Wproj^T + bproj)
// with f32 accumulation everywhere, q, k, v, P and O rounded to bf16 (the
// TPU kernel's rounding points, lavt_rs_tpu/ops/pallas/fused_msa.py:
// 118-124).  Masks: window wi of an image takes none when wi < nu, else
// mask[wi - nu] (nu = 0 with a full mask, nW without one): K10's grouping.
//
// Bound on the H100, per stage-1 call of Video Swin-T (324 windows of 392
// tokens, C = 96, 3 heads): 8 rows C^2 + 4 N^2 hd per window and head =
// 28.5 GFLOP (0.029 ms at 989 TFLOP/s) against 50.7 MB of x, y, weights and
// bias (0.015 ms at 3.35 TB/s): operations.
//
// Why the first design (one kernel in csrc/window_attn.cu) lost to the
// library chain (1.258 against 0.860 ms a clip, H100 80GB HBM3 at 700 W):
// one block per (head, window) re-projected its head's q, k, v from x
// with WMMA behind synchronous loads (x read once per head), read
// the f32 bias and mask by per-thread loads from L2 inside the key loop
// (~0.6 GB of L2 traffic a call), and ran at 3.7 waves of two blocks per
// SM; its out-projection was a second launch on the WMMA GEMM.
//
// Design.  (a) qkv = x Wqkv^T on the GEMM core, 128 x 128 tiles per
// consumer warpgroup, 64 deep (K = 96 takes two k-tiles, the second half
// zero-filled by TMA), the epilogue adding bqkv and scaling the first C
// columns (EpiBias<true>): x is read once for all heads and the qkv tensor
// (B nW n_p, 3C) bf16 goes to device memory (75 MB at stage 1, mostly
// L2-resident for launch (b)).  (b) K10's kernel on q, k, v as strided
// views of qkv (its tensor maps take the strides), scale 1 (q is already
// scaled and rounded: bf16(q 1) = q), the grouped mask, O written as
// (B nW, n_p, C).  (c) y = O Wproj^T on the GEMM core, + bproj.  N = 288
// and 96 are not multiples of the core's 128 columns: the last column
// tile is ragged (B's rows past N load as zeros, the staged boxes past N
// are not stored, the epilogue reads no bias there).  The two GEMMs are
// two instances (EpiBias<true>, EpiBias<false>), so a profile tells them
// apart.  Per stage-1 call (H100 80GB HBM3, 700 W, chip_smoke.py): qkv
// 0.046 ms, attention 0.268-0.279, out-projection 0.020; the attention,
// ~9x its byte bound, is K10's per-item instruction stream.
// ptxas -v (the card's nvcc, sm_90a): gemm_kernel<EpiBias<·>, 2, ...> 168
// registers at launch (setmaxnreg: 232 for the consumers), no spills.

#include "common.cuh"
#include "gemm_sm90.cuh"

namespace lavt {

using sm90::GemmParams;

// y = bf16((acc + b) s): kScaled, s = scale on the first `scaled` columns
// (the q columns of the qkv projection), else 1 (the out-projection; two
// instances, so the profiler tells the launches apart); columns past N
// read no bias (their boxes are not stored)
template <bool kScaled>
struct EpiBias {
  static constexpr int kStaged = 1, kStagedIn = 0;
  struct Args {
    const bf16* b;
    int n, scaled;
    float scale;
  };
  static __device__ __forceinline__ void store(const Args& a, float (&acc)[64], float (&)[1],
                                               int, int col0, float*, unsigned char* out) {
#pragma unroll
    for (int j = 0; j < sm90::kBN / 8; ++j) {
      const int c = sm90::frag_col(0, j), col = col0 + c;  // even; N is even
      float2 b = make_float2(0.f, 0.f);
      if (col < a.n) b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(a.b + col));
      const float s = kScaled && col < a.scaled ? a.scale : 1.f;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        sm90::stage_pair(out, sm90::frag_row(0, h), c,
                         __floats2bfloat162_rn((acc[4 * j + 2 * h] + b.x) * s,
                                               (acc[4 * j + 2 * h + 1] + b.y) * s));
    }
  }
};

template <bool kScaled>
cudaError_t gemm_bias(const void* x, const void* w, const void* b, void* y, int M, int N, int K,
                      int scaled, float scale, cudaStream_t stream) {
  using Epi = EpiBias<kScaled>;
  GemmParams<typename Epi::Args> p;
  cudaError_t err = sm90::map_a<2>(&p.a0, x, K, M, false);
  if (err == cudaSuccess) err = sm90::map_b(&p.b0, w, K, N, false);
  if (err == cudaSuccess) err = sm90::map_out(&p.c0, y, N, M);
  if (err != cudaSuccess) return err;
  p.k_tiles = p.k_tiles_per_split = (K + sm90::kBK - 1) / sm90::kBK;
  p.epi = {static_cast<const bf16*>(b), N, scaled, scale};
  return sm90::launch_gemm<Epi, 2, false, false>(p, M, N, 1, stream);
}

}  // namespace lavt

// y (M, N) = bf16((x W^T + b) s) on the GEMM core: x (M, K), W (N, K)
// (a torch Linear weight), b (N,), y bf16, s = scale on columns < scaled
// (none when scaled is 0).  K and N multiples of 8 (16-byte rows for the
// tensor maps).
extern "C" int lavt_gemm_bias_bf16(const void* x, const void* w, const void* b, void* y, int M,
                                   int N, int K, int scaled, float scale, void* stream) {
  if (M < 1 || N < 8 || K < 8 || N % 8 != 0 || K % 8 != 0 || scaled < 0 || scaled > N)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(scaled > 0 ? lavt::gemm_bias<true>(x, w, b, y, M, N, K, scaled, scale, s)
                                     : lavt::gemm_bias<false>(x, w, b, y, M, N, K, 0, 1.f, s));
}
