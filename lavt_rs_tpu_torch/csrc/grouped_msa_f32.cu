// The attention launch of K2p f32: window attention in f32 on the grouped,
// padded video windows of stage 1 (n_p = 392 tokens a window), between K2p
// f32's qkv projection and its out-projection on the 3xTF32 GEMM core
// (ops/fused_msa.grouped_launches).
//
// Replaces the f32 computation of lavt_rs_tpu/ops/pallas/fused_msa.py:
// _fwd_call/_kernel on the grouped 3D route (fused_window_msa_padded and
// the block's grouped call; n_p = 392 in f32, where the sublane tile is 8
// rows), on f32 inputs (`--no_bf16` with Pallas: the TPU kernel computes
// in f32 and its roundings to x.dtype are no-ops).  Per window and head,
// hd = 32, q, k, v read by strides from the f32 qkv tensor the projection
// wrote (B nW, n, 3C) (q already scaled in its epilogue: scale 1 here):
//   s = q k^T + bias[h] (+ mask[w - nu] for windows w >= nu of an image)
//   O = softmax(s) v       exact, max-subtracted (an online softmax over
//                          the key chunks), as K2p f32 takes it (ROADMAP
//                          "Known differences", F8)
// written as (B nW, n, C), the layout the out-projection reads.
//
// Bound on the H100, per call at video stage 1 of an 8-frame 480² clip
// (324 windows x 3 heads, n = 392): 4 n^2 hd flops per (window, head) =
// 19.1 GFLOP, 0.116 ms at 165 TFLOP/s (495 TF32 over 3xTF32's three
// passes), against 146 MB of qkv read, 49 MB of O written, the bias (1.8
// MB) and the grouped call's masks (<= 100 MB): operations.  Rows padded
// to 64-row tiles (7 tiles for 392 rows) make it 0.132 ms of tensor work.
//
// Design: persistent blocks, one an SM, each over a contiguous run of
// items in (window, head, sweep) order: an item is the rows of one sweep
// (four 64-row query tiles: rows 0-255, then 256-391 at n = 392) of one
// (window, head), so a masked window's mask (100 MB in all, past L2) is
// read from device memory once and then for its other heads from L2, the
// heads' biases (1.8 MB) stay in L2, and the runs mix the two sweeps (of
// unequal cost) evenly.  Three warpgroups:
//   * warpgroup 2 produces (setmaxnreg 56): per item it stages the sweep's
//     q rows by cp.async (128-byte swizzled) into one of two buffers, so
//     that an item's q lands while the item before runs; per chunk of 56
//     keys it stages k and v into a ring of three slots and writes k's lo
//     and v transposed into keys-contiguous rows (hi and lo) in
//     `frag_c2a`'s key order, so that every B operand is K-major (k's raw
//     f32 rows are its tf32 hi: the tensor core reads an f32 operand with
//     its 13 low bits cleared); the next job's copies are in flight while
//     it builds the current one.  Full barriers (its 128 threads) and
//     empty ones (the consumers' 256) pace the ring and the q buffers.
//   * warpgroups 0 and 1 consume (setmaxnreg 224): warpgroup wg owns the
//     sweep's query tiles wg and wg + 2 (at n = 392 the second sweep's
//     third tile holds 8 real rows, and only its first warp runs the
//     softmax; its fourth is empty), keeps each tile's O (m64n32), running
//     max and sum in registers across the chunks, and per (tile, chunk):
//       - S = q k^T, m64n56, twelve wgmmas in 3xTF32 (lo hi, hi lo, hi hi
//         over four 8-deep steps), A = q's fragments read from shared
//         memory and split in registers (A from shared memory, hi and lo,
//         doubled the shared-memory reads of these small wgmmas), B = the
//         slot's k (hi and lo);
//       - under those wgmmas, the bias (and in a masked window the mask)
//         read into registers at the C fragments' places;
//       - the online softmax in registers: the chunk's row max over the
//         row's four lanes, the rescale of O and the running sum, e =
//         exp(s - m) (`__expf`);
//       - O += e V, m64n32, 21 wgmmas over seven 8-key steps, each C
//         fragment of e the A fragment of the next product (`frag_c2a`,
//         split in registers), B = the slot's v^T (hi and lo).
//     The two consumers run out of phase, so one's softmax overlaps the
//     other's products.  Two tiles a warpgroup keep its registers within
//     the launch's 168 a thread: the keys are streamed once a sweep.
// Keys past n (n not a multiple of 56) are zero-filled and take -inf;
// query rows past n are zero (or an earlier sweep's finite rows) and not
// stored.  Shared memory 180,304 bytes: two q buffers (a sweep's 256 rows
// each, 64 KB) and three ring slots (k, its lo, v, v^T hi and lo: 37 KB
// each); staging the bias in shared memory (by the consumers, a step
// ahead) measured slower: its copies and reads took the shared-memory
// bandwidth of the wgmmas.  The plan (blocks, runs, sweeps, tiles, chunks,
// shared memory) is mirrored by ops/fused_msa.k2p_f32_plan.
//
// (The design before: K10 f32's kernel, csrc/window_attn_f32.cu, 3xTF32 on
// mma.sync with fragment tiles rebuilt per chunk by every block of 80
// query rows: 0.79-0.87 ms a call at stage 1, 14 % of its bound; PERF.md.)

#include <cstdint>

#include "attn_tf32.cuh"
#include "gemm_sm90.cuh"

namespace lavt {
namespace k2pf32 {

using namespace tf32attn;
using sm90::mbar_arrive;
using sm90::mbar_init;
using sm90::mbar_wait;

constexpr int kMaxN = 448;                    // 7 query tiles of 64
constexpr int kChunk = 56, kKT = kChunk / 8;  // keys a chunk, 8-key steps
constexpr int kSweepTiles = 4;                // query tiles a sweep over the keys
constexpr int kTilesPerWg = kSweepTiles / 2;  // 2: tiles wg and wg + 2 of a sweep
constexpr int kThreads = 384;                 // consumers 0-1, producer 2
constexpr int kStages = 3;                    // ring slots
constexpr int kProducerRegs = 56, kConsumerRegs = 224;
constexpr float kNeg = -1e30f;  // the running max before any key

// shared memory, 1024-byte aligned pieces
constexpr int kRowBytes = kHD * 4;                   // a staged row: 128 bytes
constexpr int kQBytes = kSweepTiles * 64 * kRowBytes;  // a sweep's q rows, 32 KB
constexpr int kKVBytes = kChunk * kRowBytes;          // 7 KB
constexpr int kVtBlock = kHD * 32 * 4;                // v^T: 32 rows x 32 keys, 4 KB
constexpr int kVtBytes = 2 * kVtBlock;                // keys 0-63 of a chunk (56 used)
constexpr int kSlotK = 0, kSlotKlo = kKVBytes, kSlotV = 2 * kKVBytes,
              kSlotVtHi = 3 * kKVBytes, kSlotVtLo = kSlotVtHi + kVtBytes,
              kSlotBytes = kSlotVtLo + kVtBytes;      // 37 KB
constexpr int kOffQ = 0, kOffRing = 2 * kQBytes,      // q: two buffers (items u, u + 1)
              kOffBar = kOffRing + kStages * kSlotBytes;
constexpr size_t kSmem = kOffBar + (2 * kStages + 4) * 8 + 1024;  // + alignment slack

struct Params {
  const float* qkv;   // (B nW, n, 3C)
  const float* bias;  // (heads, n, n)
  const float* mask;  // (nW - nu, n, n) or null
  float* o;           // (B nW, n, C)
  int bw, nw, nu, heads, n, c;
  int tiles, chunks, sweeps;
};

// item it of the (window, head, sweep) order
struct Item {
  int win, h, sweep;
};

__device__ __forceinline__ Item item_at(const Params& p, int it) {
  const int unit = it / p.sweeps;
  return Item{unit / p.heads, unit % p.heads, it % p.sweeps};
}

// D (64 x 56, f32) (+)= A (64 x 8, tf32 registers) B (56 x 8, tf32 shared
// memory, K-major); scale_d = 0 overwrites D
__device__ __forceinline__ void wgmma_n56_rs(float (&d)[kKT][4], const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %33, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n56k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27}, "
      "{%28, %29, %30, %31}, %32, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]),
        "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]),
        "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// D (64 x 32, f32) += A (64 x 8, tf32 registers) B (32 x 8, tf32 shared
// memory, K-major)
__device__ __forceinline__ void wgmma_n32_rs(float (&d)[4][4], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]),
        "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// keeps the compiler from reusing a wgmma's A registers before its wait
__device__ __forceinline__ void fence_u(uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// byte offset of element (r, d) of a staged [rows][32] f32 tile, the
// 128-byte swizzle (16-byte chunk d / 4 of row r at (d / 4) ^ (r mod 8))
__device__ __forceinline__ int sw_at(int r, int d) {
  return r * 128 + ((((d >> 2) ^ (r & 7))) << 4) + (d & 3) * 4;
}

// K-major 128-byte-swizzled operand descriptor at `addr` (8-row atoms
// 1024 bytes apart)
__device__ __forceinline__ uint64_t desc(uint32_t addr) { return sm90::smem_desc(addr, 16, 1024); }

__device__ __forceinline__ float4 lo4(float4 x) {
  return make_float4(x.x - __uint_as_float(__float_as_uint(x.x) & 0xffffe000u),
                     x.y - __uint_as_float(__float_as_uint(x.y) & 0xffffe000u),
                     x.z - __uint_as_float(__float_as_uint(x.z) & 0xffffe000u),
                     x.w - __uint_as_float(__float_as_uint(x.w) & 0xffffe000u));
}

__device__ __forceinline__ void producer_sync() {
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

// -- the producer -------------------------------------------------------------
//
// Its jobs: q of the run's first item, then per item u: chunks 0 and 1, q
// of item u + 1 (into the other q buffer), the rest of the chunks.  The
// copies of the next job are issued (after its destination is free)
// before a job is built.  Each wait for a destination then needs only
// jobs already built: a q buffer is freed by the consumers' last S of the
// item two before, a slot by their last PV of the chunk kStages before.

struct Job {
  int it, chunk;  // chunk < 0: q
  int gc;         // the block's chunk count before it (its ring slot and round)
};

constexpr int kQPos = 2;  // chunks of an item before the next item's q

// the job after jb in the block's run [i0, i1) (jb.it == i1: none)
__device__ __forceinline__ Job next_job(const Job& jb, int i0, int i1, int chunks) {
  const int qpos = min(kQPos, chunks);
  if (jb.chunk < 0) {  // q of item it: the chunk that follows it
    if (jb.it == i0) return Job{i0, 0, 0};              // the run's first q: item i0 begins
    const int u = jb.it - 1;                            // q of u + 1 sits in item u's chunks
    return qpos < chunks ? Job{u, qpos, (u - i0) * chunks + qpos}
                         : Job{u + 1, 0, (u + 1 - i0) * chunks};
  }
  if (jb.chunk + 1 == qpos && jb.it + 1 < i1) return Job{jb.it + 1, -1, jb.gc};
  if (jb.chunk + 1 < chunks) return Job{jb.it, jb.chunk + 1, jb.gc + 1};
  return Job{jb.it + 1, 0, jb.gc + 1};                  // next item (it == i1: none)
}

// job jb's destination is free (the consumers are done with it), then its
// copies, by producer thread pt
__device__ __forceinline__ void issue_job(const Params& p, uint32_t s0, uint64_t* empty,
                                          uint64_t* qempty, const Job& jb, int i0, int pt) {
  const Item item = item_at(p, jb.it);
  const size_t ld = 3 * size_t(p.c);
  const float* base = p.qkv + size_t(item.win) * p.n * ld + item.h * kHD;
  if (jb.chunk < 0) {  // q: the sweep's rows [256 sweep, 256 sweep + 256), below n
    const int u = jb.it - i0;
    mbar_wait(&qempty[u % 2], ((u / 2) & 1) ^ 1);
    const int r0 = item.sweep * kSweepTiles * 64, rows = min(kSweepTiles * 64, p.n - r0);
    const uint32_t sq = s0 + kOffQ + (u % 2) * kQBytes;
    for (int i = pt; i < rows * (kHD / 4); i += 128) {
      const int r = i / (kHD / 4), q4 = i % (kHD / 4);
      f32mma::cp_async16(sq + sw_at(r, 4 * q4), base + (r0 + r) * ld + 4 * q4, true);
    }
    return;
  }
  const int slot = jb.gc % kStages;
  mbar_wait(&empty[slot], ((jb.gc / kStages) & 1) ^ 1);
  const uint32_t sk = s0 + kOffRing + slot * kSlotBytes;
  const int key0 = jb.chunk * kChunk;
  for (int i = pt; i < 2 * kChunk * (kHD / 4); i += 128) {  // k, then v; zeros past n
    const int part = i / (kChunk * (kHD / 4)), r = i / (kHD / 4) % kChunk, q4 = i % (kHD / 4);
    const bool valid = key0 + r < p.n;
    const float* src = base + (1 + part) * p.c + (valid ? size_t(key0 + r) * ld : 0) + 4 * q4;
    f32mma::cp_async16(sk + (part == 0 ? kSlotK : kSlotV) + sw_at(r, 4 * q4), src, valid);
  }
}

// chunk job jb's B parts from its landed rows: the slot's k lo and v^T hi
// and lo (element (key, d) of v at row d, key column 8 (key / 8 mod 4) +
// kappa of block key / 32, kappa = 4 (key mod 2) + (key mod 8) / 2:
// frag_c2a's depth order); q needs none (its lo is split where it is used)
__device__ __forceinline__ void build_job(const Params& p, unsigned char* smem, const Job& jb,
                                          int pt) {
  if (jb.chunk < 0) return;
  unsigned char* slot = smem + kOffRing + (jb.gc % kStages) * kSlotBytes;
  const float4* k4 = reinterpret_cast<const float4*>(slot + kSlotK);
  float4* klo = reinterpret_cast<float4*>(slot + kSlotKlo);
  for (int i = pt; i < kKVBytes / 16; i += 128) klo[i] = lo4(k4[i]);
  // v^T in 4 x 4 blocks: keys 8 g + par + 2 m (m < 4: kappa 4 par + m, one
  // 16-byte chunk of v^T's row d) by d 4 db .. 4 db + 3 (one 16-byte chunk
  // of v's row key)
  const unsigned char* v = slot + kSlotV;
  for (int u = pt; u < kKT * 16; u += 128) {
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
      *reinterpret_cast<float4*>(slot + kSlotVtHi + off) = hi;
      *reinterpret_cast<float4*>(slot + kSlotVtLo + off) = lo4(hi);
    }
  }
}

__device__ void produce(const Params& p, unsigned char* smem, uint64_t* full, uint64_t* empty,
                        uint64_t* qfull, uint64_t* qempty, int i0, int i1) {
  const int pt = threadIdx.x - 256;
  const uint32_t s0 = sm90::smem_u32(smem);
  // q's buffers start at zero: a sweep's rows past n hold zeros, or an
  // earlier sweep's finite rows, which no stored row reads
  for (int i = pt; i < 2 * kQBytes / 16; i += 128)
    reinterpret_cast<float4*>(smem + kOffQ)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  producer_sync();  // the zeros are written before any q lands
  if (i0 >= i1) return;
  Job jb{i0, -1, 0};  // the run's first q
  issue_job(p, s0, empty, qempty, jb, i0, pt);
  f32mma::cp_commit();
  while (jb.it < i1) {
    const Job nx = next_job(jb, i0, i1, p.chunks);
    if (nx.it < i1) issue_job(p, s0, empty, qempty, nx, i0, pt);
    f32mma::cp_commit();
    f32mma::cp_wait<1>();  // job jb's copies (this thread's) have landed
    producer_sync();       // ... and every producer thread's
    build_job(p, smem, jb, pt);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // for the wgmmas
    mbar_arrive(jb.chunk < 0 ? &qfull[(jb.it - i0) % 2] : &full[jb.gc % kStages]);
    jb = nx;
  }
  f32mma::cp_wait<0>();
}

// -- the consumers --------------------------------------------------------------

// bias (+ mask) at the C fragments' places of rows ra, rb and keys key0 +
// 8 j + 2 t, + 1 (rows and keys past n clamped) into b
// b = the bias (+ mask) at the C fragments' places of rows ra, rb and keys
// key0 + 8 j + 2 t, + 1 (rows and keys past n clamped).  (A copy of the
// bias in C-fragment order, a warp's load 512 contiguous bytes, measured
// slower: those full-width loads took the L1's bandwidth from the wgmmas'
// shared-memory reads.)
__device__ __forceinline__ void load_bias(float (&b)[kKT][4], const float* bh, const float* mk,
                                          int ra, int rb, int key0, int t, int n) {
  const size_t oa = size_t(min(ra, n - 1)) * n, ob = size_t(min(rb, n - 1)) * n;
#pragma unroll
  for (int j = 0; j < kKT; ++j) {
    const int col = min(key0 + 8 * j + 2 * t, n - 2);
    const float2 x = __ldg(reinterpret_cast<const float2*>(bh + oa + col));
    const float2 y = __ldg(reinterpret_cast<const float2*>(bh + ob + col));
    b[j][0] = x.x, b[j][1] = x.y, b[j][2] = y.x, b[j][3] = y.y;
  }
  if (mk != nullptr) {
#pragma unroll
    for (int j = 0; j < kKT; ++j) {
      const int col = min(key0 + 8 * j + 2 * t, n - 2);
      const float2 u = __ldg(reinterpret_cast<const float2*>(mk + oa + col));
      const float2 w = __ldg(reinterpret_cast<const float2*>(mk + ob + col));
      b[j][0] += u.x, b[j][1] += u.y, b[j][2] += w.x, b[j][3] += w.y;
    }
  }
}

__device__ void consume(const Params& p, unsigned char* smem, uint64_t* full, uint64_t* empty,
                        uint64_t* qfull, uint64_t* qempty, int i0, int i1) {
  const uint32_t s0 = sm90::smem_u32(smem);
  const int wg = threadIdx.x / 128, ww = threadIdx.x / 32 % 4;
  const int g = lane_g(), t = lane_t();
  const int n = p.n;
  int gc = 0;
  for (int it = i0; it < i1; ++it) {
    const Item item = item_at(p, it);
    const int wi = item.win % p.nw, t0 = item.sweep * kSweepTiles;
    // this warpgroup's tiles of the sweep: t0 + wg, t0 + wg + 2, below `tiles`
    const int my_tiles = min(kTilesPerWg, max(0, (p.tiles - t0 - wg + 1) / 2));
    const int u = it - i0;
    mbar_wait(&qfull[u % 2], (u / 2) & 1);
    if (my_tiles == 0) mbar_arrive(&qempty[u % 2]);
    const unsigned char* qs = smem + kOffQ + (u % 2) * kQBytes;
    float o[kTilesPerWg][4][4], m[kTilesPerWg][2], l[kTilesPerWg][2];
#pragma unroll
    for (int i = 0; i < kTilesPerWg; ++i) {
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) o[i][cc][0] = o[i][cc][1] = o[i][cc][2] = o[i][cc][3] = 0.f;
      m[i][0] = m[i][1] = kNeg;
      l[i][0] = l[i][1] = 0.f;
    }
    const float* bh = p.bias + size_t(item.h) * n * n;
    const float* mk = (p.mask != nullptr && wi >= p.nu) ? p.mask + size_t(wi - p.nu) * n * n
                                                        : nullptr;
    for (int c = 0; c < p.chunks; ++c, ++gc) {
      const int slot = gc % kStages, key0 = c * kChunk;
      mbar_wait(&full[slot], (gc / kStages) & 1);
      const uint32_t sb = s0 + kOffRing + slot * kSlotBytes;
#pragma unroll
      for (int i = 0; i < kTilesPerWg; ++i) {
        if (i >= my_tiles) break;
        const int lt = wg + 2 * i;  // the tile within the sweep
        // q's A fragments (rows 64 lt + 16 ww + g, + 8; depths 8 kk + t, + 4),
        // split in registers
        Frag4 qf[kHD / 8];
        {
          const int qa = 64 * lt + 16 * ww + g, qb = qa + 8;
#pragma unroll
          for (int kk = 0; kk < kHD / 8; ++kk) {
            split_rz(*reinterpret_cast<const float*>(qs + sw_at(qa, 8 * kk + t)), qf[kk].hi[0],
                     qf[kk].lo[0]);
            split_rz(*reinterpret_cast<const float*>(qs + sw_at(qb, 8 * kk + t)), qf[kk].hi[1],
                     qf[kk].lo[1]);
            split_rz(*reinterpret_cast<const float*>(qs + sw_at(qa, 8 * kk + t + 4)),
                     qf[kk].hi[2], qf[kk].lo[2]);
            split_rz(*reinterpret_cast<const float*>(qs + sw_at(qb, 8 * kk + t + 4)),
                     qf[kk].hi[3], qf[kk].lo[3]);
          }
        }
        // S = q k^T: lo hi and hi lo for every depth step, then hi hi
        float s[kKT][4];
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kHD / 8; ++kk) {
          wgmma_n56_rs(s, qf[kk].lo, desc(sb + kSlotK + 32 * kk), kk != 0);
          wgmma_n56_rs(s, qf[kk].hi, desc(sb + kSlotKlo + 32 * kk), 1);
        }
#pragma unroll
        for (int kk = 0; kk < kHD / 8; ++kk)
          wgmma_n56_rs(s, qf[kk].hi, desc(sb + kSlotK + 32 * kk), 1);
        sm90::wgmma_commit();
        // under them: the bias (+ mask) at the C fragments' places
        const int ra = (t0 + lt) * 64 + 16 * ww + g;
        const bool active = (t0 + lt) * 64 + 16 * ww < n;  // the warp has rows below n
        float bm[kKT][4];
        if (active) load_bias(bm, bh, mk, ra, ra + 8, key0, t, n);
        sm90::wgmma_wait<0>();
        sm90::fence_acc(s);
#pragma unroll
        for (int kk = 0; kk < kHD / 8; ++kk) fence_u(qf[kk].hi), fence_u(qf[kk].lo);
        // q's last reader
        if (c == p.chunks - 1 && i == my_tiles - 1) mbar_arrive(&qempty[u % 2]);
        if (active) {
          // + bias + mask; keys past n (a ragged last chunk only) at -inf
#pragma unroll
          for (int j = 0; j < kKT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[j][e] += bm[j][e];
          if (key0 + kChunk > n) {
#pragma unroll
            for (int j = 0; j < kKT; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e)
                if (key0 + 8 * j + 2 * t + e >= n)
                  s[j][e] = s[j][2 + e] = __int_as_float(static_cast<int>(0xff800000u));
          }
          // the online softmax: the chunk's row max (the row's four lanes),
          // the rescale, e = exp(s - m) and its row sums
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
          mxa = fmaxf(m[i][0], mxa), mxb = fmaxf(m[i][1], mxb);
          const float aa = __expf(m[i][0] - mxa), ab = __expf(m[i][1] - mxb);
          m[i][0] = mxa, m[i][1] = mxb;
          float la = 0.f, lb = 0.f;
#pragma unroll
          for (int j = 0; j < kKT; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              s[j][e] = __expf(s[j][e] - mxa);
              s[j][2 + e] = __expf(s[j][2 + e] - mxb);
            }
            la += s[j][0] + s[j][1];
            lb += s[j][2] + s[j][3];
          }
          l[i][0] = l[i][0] * aa + la;
          l[i][1] = l[i][1] * ab + lb;
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
            o[i][cc][0] *= aa, o[i][cc][1] *= aa;
            o[i][cc][2] *= ab, o[i][cc][3] *= ab;
          }
        } else {  // a warp whose rows all lie past n: zeros into O = e V
#pragma unroll
          for (int j = 0; j < kKT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
        }
        // O += e V over the chunk's seven 8-key steps, e's C fragments as
        // the A fragments
        Frag4 a[kKT];
#pragma unroll
        for (int j = 0; j < kKT; ++j) a[j] = frag_c2a(s[j]);
        sm90::wgmma_fence();
#pragma unroll
        for (int j = 0; j < kKT; ++j) {
          const uint32_t off = (j >> 2) * kVtBlock + (j & 3) * 32;
          wgmma_n32_rs(o[i], a[j].lo, desc(sb + kSlotVtHi + off));
          wgmma_n32_rs(o[i], a[j].hi, desc(sb + kSlotVtLo + off));
          wgmma_n32_rs(o[i], a[j].hi, desc(sb + kSlotVtHi + off));
        }
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_acc(o[i]);
#pragma unroll
        for (int j = 0; j < kKT; ++j) fence_u(a[j].hi), fence_u(a[j].lo);
      }
      mbar_arrive(&empty[slot]);  // this warpgroup's wgmmas are done with the slot
    }
    // O / l for the rows below n
#pragma unroll
    for (int i = 0; i < kTilesPerWg; ++i) {
      if (i >= my_tiles) break;
      const int ra = (t0 + wg + 2 * i) * 64 + 16 * ww + g, rb = ra + 8;
      float la = l[i][0], lb = l[i][1];
#pragma unroll
      for (int x = 1; x < 4; x <<= 1) {
        la += __shfl_xor_sync(0xffffffffu, la, x);
        lb += __shfl_xor_sync(0xffffffffu, lb, x);
      }
      const float ia = 1.f / la, ib = 1.f / lb;
      float* out = p.o + size_t(item.win) * n * p.c + item.h * kHD + 2 * t;
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        if (ra < n)
          *reinterpret_cast<float2*>(out + size_t(ra) * p.c + 8 * cc) =
              make_float2(o[i][cc][0] * ia, o[i][cc][1] * ia);
        if (rb < n)
          *reinterpret_cast<float2*>(out + size_t(rb) * p.c + 8 * cc) =
              make_float2(o[i][cc][2] * ib, o[i][cc][3] * ib);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1) k2p_attn_f32_kernel(const Params p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kOffBar);
  uint64_t* empty = full + kStages;
  uint64_t* qfull = empty + kStages;  // per q buffer
  uint64_t* qempty = qfull + 2;
  // this block's run [i0, i1) of the (head, window) items, head-major
  const long long items = static_cast<long long>(p.bw) * p.heads * p.sweeps;
  const int i0 = static_cast<int>(items * blockIdx.x / gridDim.x);
  const int i1 = static_cast<int>(items * (blockIdx.x + 1) / gridDim.x);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 128);
      mbar_init(&empty[s], 256);
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(&qfull[b], 128);
      mbar_init(&qempty[b], 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= 256) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    produce(p, smem, full, empty, qfull, qempty, i0, i1);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    consume(p, smem, full, empty, qfull, qempty, i0, i1);
  }
}

inline bool aligned(const void* ptr) {
  return ptr == nullptr || reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

}  // namespace k2pf32
}  // namespace lavt

// K2p f32's attention: qkv (Bw = B nW windows, n, 3C) f32 as the qkv
// projection writes it (q scaled), bias (heads, n, n) f32, mask (nW - nu, n,
// n) f32 or null (window w of an image takes mask[w - nu] for w >= nu, none
// below); writes o (Bw, n, C) f32.  n a multiple of 8 up to 448, C = 32
// heads; `blocks` persistent blocks (ops/fused_msa.k2p_f32_plan), each a
// contiguous run of the head-major (head, window) items.
extern "C" int lavt_k2p_attn_f32(const void* qkv, const void* bias, const void* mask, void* o,
                                 int Bw, int nW, int nu, int heads, int n, int C, int blocks,
                                 void* stream) {
  using namespace lavt::k2pf32;
  const int tiles = (n + 63) / 64, sweeps = (tiles + kSweepTiles - 1) / kSweepTiles;
  if (Bw < 1 || nW < 1 || Bw % nW != 0 || nu < 0 || nu > nW || heads < 1 ||
      C != heads * kHD || n < 8 || n > kMaxN || n % 8 != 0 || blocks < 1 ||
      static_cast<long long>(blocks) > static_cast<long long>(Bw) * heads * sweeps ||
      !aligned(qkv) || !aligned(bias) || !aligned(mask) || !aligned(o))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{static_cast<const float*>(qkv), static_cast<const float*>(bias),
           static_cast<const float*>(mask), static_cast<float*>(o), Bw, nW, nu, heads, n, C,
           tiles, (n + kChunk - 1) / kChunk, sweeps};
  const cudaError_t err = lavt::allow_smem(k2p_attn_f32_kernel, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  k2p_attn_f32_kernel<<<blocks, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The dynamic shared memory of K2p f32's attention block
// (ops/fused_msa.K2P_F32_SMEM)
extern "C" int lavt_k2p_attn_f32_smem() { return static_cast<int>(lavt::k2pf32::kSmem); }
