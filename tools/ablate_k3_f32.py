#!/usr/bin/env python3
"""Times K3 f32's design levers (csrc/gemm_f32.cu) at the lavt_one
Swin-B 480² bs-8 stage shapes on one NVIDIA GPU, by CUDA events, and
prints one JSON object.

    python3 tools/ablate_k3_f32.py --root DIR [--iters 10]

DIR: a checkout whose core still has the stagers' split of a K-major B
and the `kLoByTma` instances, which the variants edit (the tree before
they were replaced by W's lo always by TMA: `git archive df2b5b4`
unpacked under build/); its package and sources are the ones timed.

The variants:
  * "neither": the prep's LN rows alone, then fc1 + GELU and fc2 + residual
    with B's lo split by the core's stagers for every output tile (the
    design before: the core's instances without kLoByTma);
  * "lo by TMA": K3 f32 as it runs (`fused_ln_mlp_f32`): the prep also
    writes W1's and W2's lo parts once a call, which TMA brings beside
    their hi (no stagers' split);
  * "fold by the stagers": lo by TMA, and the stagers, free of the split,
    turn each landed x stage into LN(x) in place from each row's (mean,
    rstd) (written by the prep instead of LN(x)): LN(x) never in device
    memory;
  * "fold in the split": lo by TMA, and the consumers apply the LayerNorm
    to their A values as they load and split them (each thread's two
    rows' (mean, rstd) once a tile, gamma and beta read per stage);
  * "ping-pong": lo by TMA, and the consumers alternate output tiles of
    64 x 128 (each its own A stage of 64 rows, B hi and lo: five 40 KB
    stages), their mainloops in turns (two named barriers), so that one's
    GELU / residual epilogue runs under the other's wgmmas;
  * "ping-pong, unordered": the same without the turns, each consumer
    with a ring of two stages and a TMA lane of its own.
"neither" and "lo by TMA" are the package's own launches (fc1 and fc2
without and with W's lo); the folds and the ping-pong kernel are built
apart with `nvcc -Xptxas -v` from text edits of csrc/gemm_f32.cu and
csrc/gemm_tf32_sm90.cuh under build/ablate_k3_f32/ (fc1's registers and
spill stores printed).  Each variant is checked against
`fused_ln_mlp_plain` within 1e-4 abs + rel, then timed in the order A B
... B A; "ms" holds each variant's two means per stage, "forward" their
sums over a bs-8 forward's blocks (depths 2, 2, 18, 2).  Exits 1 if a
variant fails its check.
"""

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "lavt_rs_tpu_torch", "csrc")
OUT = os.path.join(ROOT, "build", "ablate_k3_f32")
STAGES = ((120, 128, 2), (60, 256, 2), (30, 512, 18), (15, 1024, 2))
VARIANTS = ("neither", "lo by TMA", "fold by the stagers", "fold in the split",
            "ping-pong", "ping-pong, unordered")
CORE, SOURCE = "gemm_tf32_sm90.cuh", "gemm_f32.cu"
# the folds' pieces, inserted before the core's kernel
FOLD_FUNCS = """
__device__ __forceinline__ void fold_ln(unsigned char* a, int m0, int k0, int M,
                                        const float2* stats, const float* gamma,
                                        const float* beta, int sid) {
  constexpr int kRows = (kTile + kStagers / 8 - 1) / (kStagers / 8);
  const int k = 4 * (sid & 7), r0 = sid >> 3;
  const float4 gk = __ldg(reinterpret_cast<const float4*>(gamma + k0 + k));
  const float4 bk = __ldg(reinterpret_cast<const float4*>(beta + k0 + k));
  float2 st[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = m0 + r0 + 12 * i;
    st[i] = r0 + 12 * i < kTile && r < M ? __ldg(stats + r) : make_float2(0.f, 1.f);
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    if (r0 + 12 * i >= kTile) continue;
    float4* w = reinterpret_cast<float4*>(a + kmajor_off(r0 + 12 * i, k));
    const float4 x = *w;
    const float mu = st[i].x, rs = st[i].y;
    *w = make_float4((x.x - mu) * rs * gk.x + bk.x, (x.y - mu) * rs * gk.y + bk.y,
                     (x.z - mu) * rs * gk.z + bk.z, (x.w - mu) * rs * gk.w + bk.w);
  }
}

__device__ __forceinline__ void load_a_ln(const unsigned char* a, int row0, int k0,
                                          const float (&mu)[2], const float (&rs)[2],
                                          const float* gamma, const float* beta,
                                          uint32_t (&ah)[4][4], uint32_t (&al)[4][4]) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int r = row0 + ((threadIdx.x % 128) / 32) * 16 + g;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int hk = 0; hk < 2; ++hk) {
      const int k = 8 * kk + t + 4 * hk;
      const float gk = __ldg(gamma + k0 + k), bk = __ldg(beta + k0 + k);
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int i = hr + 2 * hk;
        const float x = *reinterpret_cast<const float*>(a + kmajor_off(r + 8 * hr, k));
        const float xn = (x - mu[hr]) * rs[hr] * gk + bk;
        ah[kk][i] = trunc_bits(xn);
        al[kk][i] = __float_as_uint(xn - __uint_as_float(ah[kk][i]));
      }
    }
}
"""
# the fold's launch (x, W, W's lo, b, stats, gamma, beta -> h)
FOLD_ENTRY = """
extern "C" int lavt_gemm_mlp_f32_fold(const void* x, const void* w, const void* wlo,
                                      const void* b, const void* stats, const void* gamma,
                                      const void* beta, void* out, int M, int N, int K,
                                      void* stream) {
  using namespace lavt::g32;
  namespace t = lavt::tf32;
  t::Params<Args> p{};
  cudaError_t err = t::map_operand(&p.a0, x, M, K, false);
  if (err == cudaSuccess) err = t::map_operand(&p.b0, w, N, K, false);
  if (err == cudaSuccess) err = t::map_operand(&p.b0_lo, wlo, N, K, false);
  if (err != cudaSuccess) return static_cast<int>(err);
  p.ln_stats = static_cast<const float2*>(stats);
  p.ln_gamma = static_cast<const float*>(gamma);
  p.ln_beta = static_cast<const float*>(beta);
  p.k_tiles = p.k_tiles_per_split = K / t::kBK;
  p.epi = Args{static_cast<const float*>(b), nullptr, nullptr, static_cast<float*>(out),
               M, N, 0, 1.f, 1};
  return static_cast<int>(t::launch<EpiGemm<kGelu>, false, false, false, true, true>(
      p, M, N, 1, static_cast<cudaStream_t>(stream)));
}
"""

# the ping-pong kernel and its launch (x or h, W, W's lo, b, res, keep ->
# out), appended to csrc/gemm_f32.cu
PP_ENTRY = """
namespace lavt {
namespace tf32 {

constexpr int kPpRows = 64, kPpStages = 5;
constexpr int kPpA = kPpRows * kBK * 4;             // A's 64 x 32 stage, 8 KB
constexpr int kPpStageBytes = kPpA + 2 * kOpBytes;  // A, B hi, B lo: 40 KB
constexpr size_t kPpSmem = size_t(kPpStages) * kPpStageBytes + 2 * kPpStages * 8 + 1024;

__device__ __forceinline__ void pair_sync(int id) {
  asm volatile("bar.sync %0, 256;\\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void pair_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\\n" ::"r"(id) : "memory");
}

// Consumer c takes the block's output tiles c, c + 2, ... (64 x 128
// each).  kOrdered: one ring of five stages, filled tile after tile by one
// TMA lane; tile i's mainloop starts after tile i - 1's (barrier 3 + c,
// arrived on by the other consumer), so the consumers' mainloops alternate
// and each epilogue runs under the other's (a consumer never waits on a
// stage whose slot's earlier use has not landed: the parity wait would
// pass it).  Unordered: a ring of two stages a consumer, each filled by a
// TMA lane of its own, the mainloops free.
template <class Epi, bool kOrdered>
__global__ void __launch_bounds__(kThreads, 1)
    gemm_tf32_pp_kernel(const __grid_constant__ Params<typename Epi::Args> p) {
  constexpr int kRing = kOrdered ? kPpStages : 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full_all = reinterpret_cast<uint64_t*>(smem + kPpStages * kPpStageBytes);
  uint64_t* empty_all = full_all + kPpStages;
  const int wg = threadIdx.x / 128;
  const int n_out = p.m_tiles * p.n_tiles, tiles = p.k_tiles;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kPpStages; ++s) {
      mbar_init(&full_all[s], 1);
      mbar_init(&empty_all[s], 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\\n" ::: "memory");
  }
  __syncthreads();
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 256 || (!kOrdered && threadIdx.x == 288)) {
      const int c = kOrdered ? 0 : (threadIdx.x - 256) / 32;  // its consumer's ring
      uint64_t* full = full_all + c * kRing;
      uint64_t* empty = empty_all + c * kRing;
      unsigned char* ring = smem + c * kRing * kPpStageBytes;
      int idx = 0;
      for (int tile = blockIdx.x + c * gridDim.x; tile < n_out;
           tile += (kOrdered ? 1 : 2) * gridDim.x) {
        const int m0 = tile / p.n_tiles * kPpRows, n0 = tile % p.n_tiles * kTile;
        for (int t = 0; t < tiles; ++t, ++idx) {
          const int k0 = t * kBK, s = idx % kRing;
          mbar_wait(&empty[s], ((idx / kRing) & 1) ^ 1);
          mbar_expect_tx(&full[s], kPpStageBytes);
          const uint32_t a = smem_u32(ring + s * kPpStageBytes);
          tma_load(&p.a0, a, &full[s], k0, m0);
          tma_load(&p.b0, a + kPpA, &full[s], k0, n0);
          tma_load(&p.b0_lo, a + kPpA + kOpBytes, &full[s], k0, n0);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\\n" ::"n"(kConsumerRegs));
    float acc[64], part[64];
    const int c = kOrdered ? 0 : wg;
    uint64_t* full = full_all + c * kRing;
    uint64_t* empty = empty_all + c * kRing;
    unsigned char* ring = smem + c * kRing * kPpStageBytes;
    int idx = kOrdered ? wg * tiles : 0;
    for (int tile = blockIdx.x + wg * gridDim.x, i = wg; tile < n_out;
         tile += 2 * gridDim.x, i += 2, idx += kOrdered ? tiles : 0) {
      const int m0 = tile / p.n_tiles * kPpRows, n0 = tile % p.n_tiles * kTile;
      if (kOrdered && i > 0) pair_sync(3 + wg);
#pragma unroll
      for (int j = 0; j < 64; ++j) acc[j] = 0.f;
      for (int t = 0; t < tiles; ++t, ++idx) {
        const int s = idx % kRing, parity = (idx / kRing) & 1;
        mbar_wait(&full[s], parity);
        const unsigned char* st = ring + s * kPpStageBytes;
        uint32_t ah[4][4], al[4][4];
        load_a<false>(st, 0, ah, al);
        const uint32_t bhi = smem_u32(st + kPpA), blo = bhi + kOpBytes;
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_tf32(part, al[kk], kmajor_desc(bhi, kk), kk != 0);
          wgmma_tf32(part, ah[kk], kmajor_desc(blo, kk), 1);
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_tf32(part, ah[kk], kmajor_desc(bhi, kk), 1);
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        fence_regs(part);
        fence_regs(ah);
        fence_regs(al);
        mbar_arrive(&empty[s]);
#pragma unroll
        for (int j = 0; j < 64; ++j) acc[j] += part[j];
      }
      if (kOrdered && tile + gridDim.x < n_out) pair_arrive(3 + (1 - wg));
      Epi::store(p.epi, acc, nullptr, m0, n0, nullptr);
    }
  }
}

}  // namespace tf32
}  // namespace lavt

extern "C" int lavt_gemm_f32_pp(const void* a, const void* w, const void* wlo, const void* b,
                                const void* res, const void* keep, void* out, int M, int N,
                                int K, int epi, int ordered, void* stream) {
  using namespace lavt::g32;
  namespace t = lavt::tf32;
  t::Params<Args> p{};
  cudaError_t err = t::make_map(&p.a0, a, K, M, t::kPpRows);
  if (err == cudaSuccess) err = t::map_operand(&p.b0, w, N, K, false);
  if (err == cudaSuccess) err = t::map_operand(&p.b0_lo, wlo, N, K, false);
  if (err != cudaSuccess) return static_cast<int>(err);
  p.k_tiles = p.k_tiles_per_split = K / t::kBK;
  p.m_tiles = (M + t::kPpRows - 1) / t::kPpRows;
  p.n_tiles = (N + t::kTile - 1) / t::kTile;
  p.epi = Args{static_cast<const float*>(b), static_cast<const float*>(res),
               static_cast<const float*>(keep), static_cast<float*>(out), M, N, 0, 1.f, 1};
  const int blocks = std::max(1, std::min(p.m_tiles * p.n_tiles, lavt::sm90::sm_count()));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LAVT_PP(E, O)                                                                   \\
  if (epi == E && ordered == O) {                                                      \\
    auto kernel = t::gemm_tf32_pp_kernel<EpiGemm<E>, O>;                              \\
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,   \\
                               static_cast<int>(t::kPpSmem));                         \\
    if (err != cudaSuccess) return static_cast<int>(err);                             \\
    kernel<<<blocks, t::kThreads, t::kPpSmem, s>>>(p);                                \\
    return static_cast<int>(cudaGetLastError());                                      \\
  }
  LAVT_PP(kGelu, 1) LAVT_PP(kGelu, 0) LAVT_PP(kResidual, 1) LAVT_PP(kResidual, 0)
#undef LAVT_PP
  return static_cast<int>(cudaErrorInvalidValue);
}
"""


def fold_edits(split):
    """(file, old, new) edits that add the fold to the shipped sources:
    by the stagers, or (split) in the consumers' split."""
    return (
        (CORE, "bool kLoByTma = false>\n__global__",
         "bool kLoByTma = false, bool kFoldLn = false>\n__global__"),
        (CORE, "bool kLoByTma = false>\ncudaError_t launch(",
         "bool kLoByTma = false, bool kFoldLn = false>\ncudaError_t launch("),
        (CORE, "gemm_tf32_kernel<Epi, kTA, kTB, kDual, kLoByTma>;",
         "gemm_tf32_kernel<Epi, kTA, kTB, kDual, kLoByTma, kFoldLn>;"),
        (CORE, "  CUtensorMap b0_lo;          // kLoByTma: B's lo, K-major like b0\n",
         "  CUtensorMap b0_lo;\n  const float2* ln_stats;\n  const float* ln_gamma;\n"
         "  const float* ln_beta;\n"),
        (CORE, "\n// Grid (blocks, 1, splits).", FOLD_FUNCS + "\n// Grid (blocks, 1, splits)."),
        (CORE, "one product\");\n",
         "one product\");\n"
         "  constexpr bool kFold = kFoldLn;\n"
         f"  constexpr bool kSplit = {'true' if split else 'false'};\n"
         "  constexpr bool kStaged = !kLoByTma || (kFold && !kSplit);\n"),
        (CORE, "    } else if (sid >= 0 && !kLoByTma) {", "    } else if (sid >= 0 && kStaged) {"),
        (CORE, "            stage_b<kTB>(st + kOpBytes, st + R::kBLo, st + R::kBHi, sid);",
         "            if constexpr (kFold)\n"
         "              fold_ln(st, tile / p.n_tiles * kTile, (kt0 + t) * kBK, p.epi.M,\n"
         "                      p.ln_stats, p.ln_gamma, p.ln_beta, sid);\n"
         "            else\n"
         "              stage_b<kTB>(st + kOpBytes, st + R::kBLo, st + R::kBHi, sid);"),
        (CORE, "          if (!kLoByTma) mbar_wait(&ready[s], parity);",
         "          if (kStaged) mbar_wait(&ready[s], parity);"),
        (CORE, """      for (int seg = 0; seg < kSegs; ++seg) {
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] = 0.f;""",
         """      float mu[2] = {0.f, 0.f}, rs[2] = {1.f, 1.f};
      if constexpr (kFold && kSplit) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int row = m0 + 64 * wg + frag_row(hr);
          if (row < p.epi.M) {
            const float2 st = __ldg(p.ln_stats + row);
            mu[hr] = st.x, rs[hr] = st.y;
          }
        }
      }
      for (int seg = 0; seg < kSegs; ++seg) {
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] = 0.f;"""),
        (CORE, "          load_a<kTA>(st, 64 * wg, ah, al);",
         "          if constexpr (kFold && kSplit)\n"
         "            load_a_ln(st, 64 * wg, (kt0 + t) * kBK, mu, rs, p.ln_gamma, p.ln_beta, ah, al);\n"
         "          else\n"
         "            load_a<kTA>(st, 64 * wg, ah, al);"),
        # the prep writes each row's (mean, rstd) instead of LN(x)
        (SOURCE, "    auto* dst = reinterpret_cast<float4*>(xn + size_t(row) * C);",
         "    if (lane == 0) reinterpret_cast<float2*>(xn)[row] = make_float2(mu, rstd);\n"
         "    return;\n"
         "    auto* dst = reinterpret_cast<float4*>(xn + size_t(row) * C);"),
    )


def build(name, edits, append=""):
    """A variant's library (argtypes set), after printing its fc1 kernel's
    ptxas registers and spill stores."""
    from lavt_rs_tpu_torch.ops import cuda_lib

    d = os.path.join(OUT, name.replace(" ", "_"))
    os.makedirs(d, exist_ok=True)
    for f in os.listdir(CSRC):
        shutil.copy(os.path.join(CSRC, f), d)
    for f, old, new in edits:
        path = os.path.join(d, f)
        text = open(path).read()
        if text.count(old) != 1:
            raise SystemExit(f"ablate_k3_f32: {f} has changed ({old[:60]!r})")
        with open(path, "w") as o:
            o.write(text.replace(old, new))
    with open(os.path.join(d, SOURCE), "a") as o:
        o.write(append)
    so = os.path.join(d, "lib.so")
    r = subprocess.run([cuda_lib._nvcc(), "-Xptxas=-v", *cuda_lib.NVCC_FLAGS,
                        "-shared", "-o", so, os.path.join(d, SOURCE)],
                       capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(f"ablate_k3_f32: nvcc failed\n{r.stderr}")
    entry = ""
    for line in r.stderr.splitlines():
        if "Compiling entry" in line or "Function properties" in line:
            entry = line
        elif "EpiGemmILi1E" in entry and (
                "registers" in line or "spill" in line):
            # the kernel (core or ping-pong) and its template flags
            kind = "pp" if "pp_kernel" in entry else "core"
            flags = entry.split("EpiGemmILi1EEE", 1)[-1].split("EEv")[0]
            print(f"ptxas ({name}, {kind} {flags}):", line.strip())
    lib = ctypes.CDLL(so)
    for n in ("lavt_mlp_f32_prep", "lavt_gemm_f32"):
        getattr(lib, n).argtypes = cuda_lib.SIGNATURES[n]
    if "lavt_gemm_mlp_f32_fold" in append:
        lib.lavt_gemm_mlp_f32_fold.argtypes = (ctypes.c_void_p,) * 8 + (
            ctypes.c_int,) * 3 + (ctypes.c_void_p,)
    if "lavt_gemm_f32_pp" in append:
        lib.lavt_gemm_f32_pp.argtypes = (ctypes.c_void_p,) * 7 + (
            ctypes.c_int,) * 5 + (ctypes.c_void_p,)
    return lib


def cuda_ms(fn, iters):
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def variant(name, x, g, be, w1, b1, w2, b2, libs):
    """fn() running K3 f32 as variant `name`: the package's launches, or
    for a fold or the ping-pong kernel its library's (`libs`)."""
    import torch

    from lavt_rs_tpu_torch.ops import cuda_lib
    from lavt_rs_tpu_torch.ops import fused_mlp as fm
    from lavt_rs_tpu_torch.ops import fused_msa as ms

    m, c = x.shape
    hidden = w1.shape[0]
    if name == "lo by TMA":
        return lambda: fm.fused_ln_mlp_f32(x, g, be, w1, b1, w2, b2)
    lib = libs.get(name, cuda_lib.lib())

    def call(fn, *a):
        conv = [t.data_ptr() if isinstance(t, torch.Tensor) else t for t in a]
        cuda_lib.check(getattr(lib, fn)(*conv, cuda_lib.stream_ptr(x.device)),
                       fn)

    if name == "neither":
        def neither():
            xn = torch.empty_like(x)
            call("lavt_mlp_f32_prep", x, g, be, None, None, xn, None, None, m,
                 c, hidden, fm.EPS)
            h = ms.gemm_f32(xn, w1, b1, ms.GEMM_F32_GELU)
            return ms.gemm_f32(h, w2, b2, ms.GEMM_F32_RESIDUAL, res=x)

        return neither
    if name.startswith("ping-pong"):
        ordered = int(name == "ping-pong")

        def ping_pong():
            xn, w1lo, w2lo = fm.mlp_f32_prep(x, g, be, w1, w2)
            h = torch.empty((m, hidden), device=x.device)
            call("lavt_gemm_f32_pp", xn, w1, w1lo, b1, None, None, h, m,
                 hidden, c, ms.GEMM_F32_GELU, ordered)
            out = torch.empty_like(x)
            call("lavt_gemm_f32_pp", h, w2, w2lo, b2, x, None, out, m, c,
                 hidden, ms.GEMM_F32_RESIDUAL, ordered)
            return out

        return ping_pong

    def fold():
        stats = torch.empty((m, c), device=x.device)  # (mean, rstd) a row
        w1lo, w2lo = torch.empty_like(w1), torch.empty_like(w2)
        call("lavt_mlp_f32_prep", x, g, be, w1, w2, stats, w1lo, w2lo, m, c,
             hidden, fm.EPS)
        h = torch.empty((m, hidden), device=x.device)
        call("lavt_gemm_mlp_f32_fold", x, w1, w1lo, b1, stats, g, be, h, m,
             hidden, c)
        out = torch.empty_like(x)
        call("lavt_gemm_f32", h, w2, w2lo, b2, x, None, out, m, c, hidden,
             ms.GEMM_F32_RESIDUAL, 0, 1.0, 1)
        return out

    return fold


def main():
    global ROOT, CSRC
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()
    ROOT = os.path.abspath(args.root)
    CSRC = os.path.join(ROOT, "lavt_rs_tpu_torch", "csrc")

    import torch

    if not torch.cuda.is_available():
        print("ablate_k3_f32: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from lavt_rs_tpu_torch.ops import fused_mlp as fm

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(23)

    def rnd(shape, std=1.0):
        return torch.randn(shape, generator=gen, device=dev) * std

    pp = build("ping-pong", (), PP_ENTRY)
    libs = {"fold by the stagers": build("fold by the stagers",
                                         fold_edits(False), FOLD_ENTRY),
            "fold in the split": build("fold in the split", fold_edits(True),
                                       FOLD_ENTRY),
            "ping-pong": pp, "ping-pong, unordered": pp}
    ms = {v: {} for v in VARIANTS}
    forward = dict.fromkeys(VARIANTS, 0.0)
    ok = True
    for side, c, depth in STAGES:
        rows = 8 * side * side
        mlp = (rnd((rows, c), 2.0) + 0.5, rnd((c,), 0.2) + 1.0,
               rnd((c,), 0.2), rnd((4 * c, c), c ** -0.5), rnd((4 * c,), 0.2),
               rnd((c, 4 * c), (4 * c) ** -0.5), rnd((c,), 0.2))
        want = fm.fused_ln_mlp_plain(*mlp)
        fns = {v: variant(v, *mlp, libs) for v in VARIANTS}
        stage = f"x({rows}, {c})"
        for v, fn in fns.items():
            print(f"ablate_k3_f32: checking {v} at {stage}", file=sys.stderr,
                  flush=True)
            err = ((fn() - want).abs() - 1e-4 * want.abs()).max().item()
            if err > 1e-4:
                print(f"ablate_k3_f32: {v} {stage} misses 1e-4 abs + rel "
                      f"({err:.3g})", file=sys.stderr)
                ok = False
        times = {v: [] for v in VARIANTS}
        for v in VARIANTS + VARIANTS[::-1]:
            times[v].append(cuda_ms(fns[v], args.iters))
        for v in VARIANTS:
            ms[v][stage] = times[v]
            forward[v] += depth * sum(times[v]) / 2
        del mlp, want, fns
        torch.cuda.empty_cache()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader", "-i", "0"],
                          capture_output=True, text=True).stdout.strip()
    print(json.dumps({"card": card, "ms": ms, "forward": forward}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
