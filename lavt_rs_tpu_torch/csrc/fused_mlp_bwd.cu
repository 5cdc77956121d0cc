// K7: backward of the fused LayerNorm -> fc1 -> GELU -> fc2 (-> DropPath)
// -> residual tail (K3 / K8).
//
// Replaces lavt_rs_tpu/ops/pallas/fused_mlp.py:_bwd/_bwd_kernel and
// _bwd_hsplit/_bwd_kernel_hsplit.  With the two-pass LN recomputed from x,
// xn = LN(x) (bf16), hpre = xn W1^T + b1, h = gelu(hpre), dmlp = gy keep
// (keep = 1 without DropPath), it computes with the TPU kernel's rounding
// points (dmlp, h and dhpre rounded to bf16 before their GEMMs):
//   dh = dmlp W2,  dhpre = dh gelu'(hpre),  dyln = dhpre W1
//   dW2 = dmlp^T h,  db2 = sum dmlp,  dW1 = dhpre^T xn,  db1 = sum dhpre
//   dgamma = sum dyln xhat,  dbeta = sum dyln
//   dx = gy + LN backward of dyln   (the residual passes gy unscaled)
//
// Bound on the H100: the GEMMs (five of 2 M C 4C flops, plus the recompute
// of hpre) against three reads of the (M, C) activation and one write;
// unfused, the (M, 4C) hidden and its gradient would cost 16x the
// activation's bytes in device memory.  The hidden never leaves the SM:
//   * mlp_bwd_dx_kernel: a block owns BM rows (as K3) and walks the
//     hidden dimension in chunks of 128, recomputing hpre and dh for the
//     chunk on the tensor cores and accumulating dyln = dhpre W1 in
//     registers; the LN backward then runs on the block's complete rows.
//     dgamma/dbeta are per-block column partials.
//     It also writes the bf16 xn and dmlp rows ((M, C) scratch, the
//     activation's size) for the dW kernel.
//   * mlp_bwd_dw_kernel: the weight grads sum over all M rows, and the
//     hidden is too wide for one block to hold dW1 and dW2 (2 x 4C x C f32)
//     at C >= 256 (the TPU kernel splits the hidden for the same reason,
//     _bwd_hsplit).  Block (j, s) owns hidden columns [64 j, 64 j + 64)
//     and the rows of split s: per row tile it reads xn and dmlp (16-byte
//     loads), recomputes hpre, h, dh and dhpre for its 64 columns and adds
//     dhpre^T xn and dmlp^T h into its own f32 partial slice of dW1 and dW2
//     (read-modify-write through L2, four tiles' loads in flight; no other
//     block touches the slice).  db1 is a partial too; db2, the column
//     sums of dmlp, comes from colsum_bf16 (fused_msa_bwd.cu).
//   * sum_partials (fused_msa_bwd.cu) adds the split partials in order:
//     deterministic, unlike atomicAdd, whose f32 sums would depend on the
//     order the blocks run in.
// WMMA bf16 m16n16k16 with f32 accumulation; weights are read through
// L1/L2.  No TMA or wgmma yet.

#include "common.cuh"

namespace lavt {

constexpr int kBwdThreads = 256;
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kHC = 128;  // hidden chunk of the dx kernel
constexpr int kHB = 64;   // hidden columns of a dW block

template <int C>
struct DxShape {
  static constexpr int BM = C <= 256 ? 64 : 16384 / C;  // K3's row tile
  static constexpr int NR = BM / 16;
  static constexpr int NC = C / 16;
  static constexpr int TPW = NR * NC / kBwdWarps;  // dyln tiles per warp
  static constexpr int LDX = C + 8;                // bf16 xn, dmlp
  static constexpr int LDU = kHC + 4;              // f32 hpre / dhpre chunk
  static constexpr int LDHB = kHC + 8;             // bf16 dhpre chunk
  static constexpr int LDY = C + 4;                // f32 dyln (over xn and dmlp)
  static constexpr size_t X_BYTES = align128(size_t(BM) * LDX * 2);
  static constexpr size_t U_BYTES = align128(size_t(BM) * LDU * 4);
  static constexpr size_t HB_BYTES = align128(size_t(BM) * LDHB * 2);
  static constexpr size_t ST_BYTES = align128(size_t(BM) * 2 * 4);
  static constexpr size_t SMEM = 2 * X_BYTES + U_BYTES + HB_BYTES + ST_BYTES;
  static_assert(NR * NC % kBwdWarps == 0, "dyln tiles split over the warps");
  static_assert(size_t(BM) * LDY * 4 <= 2 * X_BYTES, "dyln staging fits xn + dmlp");
};

template <int C>
struct DwShape {
  static constexpr int BM = C <= 512 ? 64 : 32;
  static constexpr int NR = BM / 16;
  static constexpr int LDX = C + 8;
  static constexpr int LDU = kHB + 4;
  static constexpr int LDH = kHB + 8;
  static constexpr size_t X_BYTES = align128(size_t(BM) * LDX * 2);
  static constexpr size_t U_BYTES = align128(size_t(BM) * LDU * 4);
  static constexpr size_t H_BYTES = align128(size_t(BM) * LDH * 2);
  static constexpr size_t SMEM = 2 * X_BYTES + 2 * U_BYTES + 2 * H_BYTES + align128(kHB * 4);
  static_assert(NR * (kHB / 16) % kBwdWarps == 0, "hpre tiles split over the warps");
  static_assert(SMEM <= 232448, "fits one block per SM");
};

// Rows [row0, row0 + BM) -> bf16 LN(x) (two-pass, as the forward) into xn
// and bf16 gy keep into dm, the per-row (mu, rstd) into stats; rows past M
// are zero.
template <int C, int BM, int LDX>
__device__ __forceinline__ void load_rows(const bf16* __restrict__ x, const bf16* __restrict__ gy,
                                          const bf16* __restrict__ gamma,
                                          const bf16* __restrict__ beta,
                                          const float* __restrict__ keep, int rows_per_sample,
                                          int M, int row0, float eps, bf16* xn, bf16* dm,
                                          float* stats) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < BM; r += kBwdWarps) {
    const int row = row0 + r;
    if (row >= M) {
      for (int c = lane; c < C; c += 32) {
        xn[r * LDX + c] = to_bf(0.f);
        dm[r * LDX + c] = to_bf(0.f);
      }
      continue;
    }
    const bf16* src = x + static_cast<size_t>(row) * C;
    float v[C / 32];
    float s = 0.f;
#pragma unroll
    for (int t = 0; t < C / 32; ++t) {
      v[t] = to_f(src[lane + 32 * t]);
      s += v[t];
    }
    const float mu = warp_sum(s) / C;
    float q = 0.f;
#pragma unroll
    for (int t = 0; t < C / 32; ++t) q += (v[t] - mu) * (v[t] - mu);
    const float rstd = rsqrtf(warp_sum(q) / C + eps);
    if (lane == 0) {
      stats[2 * r] = mu;
      stats[2 * r + 1] = rstd;
    }
    const float kp = keep != nullptr ? keep[row / rows_per_sample] : 1.f;
    const bf16* g = gy + static_cast<size_t>(row) * C;
#pragma unroll
    for (int t = 0; t < C / 32; ++t) {
      const int c = lane + 32 * t;
      xn[r * LDX + c] = to_bf((v[t] - mu) * rstd * to_f(gamma[c]) + to_f(beta[c]));
      dm[r * LDX + c] = to_bf(to_f(g[c]) * kp);
    }
  }
}

template <int C>
__global__ void __launch_bounds__(kBwdThreads, 1)
mlp_bwd_dx_kernel(const bf16* __restrict__ x, const bf16* __restrict__ gy,
                  const bf16* __restrict__ gamma, const bf16* __restrict__ beta,
                  const bf16* __restrict__ w1, const bf16* __restrict__ b1,
                  const bf16* __restrict__ w2, const float* __restrict__ keep,
                  int rows_per_sample, bf16* __restrict__ dx, float* __restrict__ dg_part,
                  float* __restrict__ dbe_part, bf16* __restrict__ xn_out,
                  bf16* __restrict__ dm_out, int M, int hidden, float eps) {
  using S = DxShape<C>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xn = reinterpret_cast<bf16*>(smem);
  bf16* dm = reinterpret_cast<bf16*>(smem + S::X_BYTES);
  float* dy = reinterpret_cast<float*>(smem);  // after the hidden loop
  float* u = reinterpret_cast<float*>(smem + 2 * S::X_BYTES);
  bf16* hb = reinterpret_cast<bf16*>(smem + 2 * S::X_BYTES + S::U_BYTES);
  float* stats = reinterpret_cast<float*>(smem + 2 * S::X_BYTES + S::U_BYTES + S::HB_BYTES);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * S::BM;
  load_rows<C, S::BM, S::LDX>(x, gy, gamma, beta, keep, rows_per_sample, M, row0, eps, xn, dm,
                              stats);
  __syncthreads();
  // the bf16 xn and dmlp rows for the dW kernel
  for (int i = threadIdx.x; i < S::BM * (C / 8); i += kBwdThreads) {
    const int r = i / (C / 8), c = (i % (C / 8)) * 8;
    if (row0 + r < M) {
      const size_t off = static_cast<size_t>(row0 + r) * C + c;
      *reinterpret_cast<uint4*>(xn_out + off) = *reinterpret_cast<const uint4*>(xn + r * S::LDX + c);
      *reinterpret_cast<uint4*>(dm_out + off) = *reinterpret_cast<const uint4*>(dm + r * S::LDX + c);
    }
  }

  FragC acc[S::TPW];
#pragma unroll
  for (int i = 0; i < S::TPW; ++i) wmma::fill_fragment(acc[i], 0.f);

  for (int hc = 0; hc < hidden; hc += kHC) {
    // a. the warp's 16 hidden columns, all BM rows: hpre (no b1 yet), dh
    const int hw = hc + warp * 16;
    FragC hp[S::NR], dh[S::NR];
#pragma unroll
    for (int r = 0; r < S::NR; ++r) {
      wmma::fill_fragment(hp[r], 0.f);
      wmma::fill_fragment(dh[r], 0.f);
    }
    for (int k0 = 0; k0 < C; k0 += 16) {
      FragBCol b1f;
      FragBRow b2f;
      wmma::load_matrix_sync(b1f, w1 + static_cast<size_t>(hw) * C + k0, C);
      wmma::load_matrix_sync(b2f, w2 + static_cast<size_t>(k0) * hidden + hw, hidden);
#pragma unroll
      for (int r = 0; r < S::NR; ++r) {
        FragA a;
        wmma::load_matrix_sync(a, xn + r * 16 * S::LDX + k0, S::LDX);
        wmma::mma_sync(hp[r], a, b1f, hp[r]);
        wmma::load_matrix_sync(a, dm + r * 16 * S::LDX + k0, S::LDX);
        wmma::mma_sync(dh[r], a, b2f, dh[r]);
      }
    }
    // b. + b1 through the warp's own columns of u, then dhpre = dh gelu'(hpre)
    //    on fragments of one type (same element mapping)
    float* uw = u + warp * 16;
#pragma unroll
    for (int r = 0; r < S::NR; ++r)
      wmma::store_matrix_sync(uw + r * 16 * S::LDU, hp[r], S::LDU, wmma::mem_row_major);
    __syncwarp();
    for (int i = lane; i < S::BM * 16; i += 32) {
      const int r = i / 16, c = i % 16;
      uw[r * S::LDU + c] += to_f(b1[hw + c]);
    }
    __syncwarp();
#pragma unroll
    for (int r = 0; r < S::NR; ++r) {
      wmma::load_matrix_sync(hp[r], uw + r * 16 * S::LDU, S::LDU, wmma::mem_row_major);
#pragma unroll
      for (int e = 0; e < dh[r].num_elements; ++e) dh[r].x[e] *= gelu_grad(hp[r].x[e]);
      wmma::store_matrix_sync(uw + r * 16 * S::LDU, dh[r], S::LDU, wmma::mem_row_major);
    }
    __syncwarp();
    for (int i = lane; i < S::BM * 16; i += 32) {
      const int r = i / 16, c = i % 16;
      hb[r * S::LDHB + warp * 16 + c] = to_bf(uw[r * S::LDU + c]);
    }
    __syncthreads();
    // c. dyln += dhpre (BM x 128) W1[hc:hc+128, :]
#pragma unroll
    for (int k0 = 0; k0 < kHC; k0 += 16) {
#pragma unroll
      for (int i = 0; i < S::TPW; ++i) {
        const int t = warp * S::TPW + i, r = t / S::NC, c = t % S::NC;
        FragA a;
        FragBRow b;
        wmma::load_matrix_sync(a, hb + r * 16 * S::LDHB + k0, S::LDHB);
        wmma::load_matrix_sync(b, w1 + static_cast<size_t>(hc + k0) * C + c * 16, C);
        wmma::mma_sync(acc[i], a, b, acc[i]);
      }
    }
    __syncthreads();
  }

  // LN backward on complete rows: dyln to shared memory (over xn and dmlp)
#pragma unroll
  for (int i = 0; i < S::TPW; ++i) {
    const int t = warp * S::TPW + i, r = t / S::NC, c = t % S::NC;
    wmma::store_matrix_sync(dy + r * 16 * S::LDY + c * 16, acc[i], S::LDY, wmma::mem_row_major);
  }
  __syncthreads();
  const int rows = min(S::BM, M - row0);
  // dbeta partial: column sums of dyln (rows past M hold 0)
  for (int c = threadIdx.x; c < C; c += kBwdThreads) {
    float s = 0.f;
    for (int r = 0; r < rows; ++r) s += dy[r * S::LDY + c];
    dbe_part[static_cast<size_t>(blockIdx.x) * C + c] = s;
  }
  __syncthreads();
  // dx = gy + rstd (dxhat - mean(dxhat) - xhat mean(dxhat xhat)), dxhat =
  // dyln gamma; the row's dyln is replaced by dyln xhat for dgamma
  for (int r = warp; r < rows; r += kBwdWarps) {
    const int row = row0 + r;
    const float mu = stats[2 * r], rstd = stats[2 * r + 1];
    const bf16* xr = x + static_cast<size_t>(row) * C;
    float xh[C / 32], dxh[C / 32];
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int t = 0; t < C / 32; ++t) {
      const int c = lane + 32 * t;
      xh[t] = (to_f(xr[c]) - mu) * rstd;
      const float d = dy[r * S::LDY + c];
      dxh[t] = d * to_f(gamma[c]);
      m1 += dxh[t];
      m2 += dxh[t] * xh[t];
      dy[r * S::LDY + c] = d * xh[t];
    }
    m1 = warp_sum(m1) / C;
    m2 = warp_sum(m2) / C;
    const bf16* g = gy + static_cast<size_t>(row) * C;
    bf16* out = dx + static_cast<size_t>(row) * C;
#pragma unroll
    for (int t = 0; t < C / 32; ++t) {
      const int c = lane + 32 * t;
      out[c] = to_bf(to_f(g[c]) + rstd * (dxh[t] - m1 - xh[t] * m2));
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += kBwdThreads) {
    float s = 0.f;
    for (int r = 0; r < rows; ++r) s += dy[r * S::LDY + c];
    dg_part[static_cast<size_t>(blockIdx.x) * C + c] = s;
  }
}

// grid (hidden / 64, splits); block (j, s) takes row tiles s, s + splits, ...
template <int C>
__global__ void __launch_bounds__(kBwdThreads, 1)
mlp_bwd_dw_kernel(const bf16* __restrict__ xn_in, const bf16* __restrict__ dm_in,
                  const bf16* __restrict__ w1, const bf16* __restrict__ b1,
                  const bf16* __restrict__ w2,
                  float* __restrict__ dw1_part, float* __restrict__ dw2_part,
                  float* __restrict__ db1_part, int M, int hidden) {
  using S = DwShape<C>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xn = reinterpret_cast<bf16*>(smem);
  bf16* dm = reinterpret_cast<bf16*>(smem + S::X_BYTES);
  float* uh = reinterpret_cast<float*>(smem + 2 * S::X_BYTES);
  float* ud = reinterpret_cast<float*>(smem + 2 * S::X_BYTES + S::U_BYTES);
  bf16* hh = reinterpret_cast<bf16*>(smem + 2 * S::X_BYTES + 2 * S::U_BYTES);
  bf16* hd = reinterpret_cast<bf16*>(smem + 2 * S::X_BYTES + 2 * S::U_BYTES + S::H_BYTES);
  float* db1s = reinterpret_cast<float*>(smem + 2 * S::X_BYTES + 2 * S::U_BYTES + 2 * S::H_BYTES);

  const int warp = threadIdx.x >> 5;
  const int j0 = blockIdx.x * kHB, split = blockIdx.y, splits = gridDim.y;
  const int tiles = (M + S::BM - 1) / S::BM;
  float* dw1 = dw1_part + static_cast<size_t>(split) * hidden * C;
  float* dw2 = dw2_part + static_cast<size_t>(split) * C * hidden;
  constexpr int kHT = S::NR * (kHB / 16) / kBwdWarps;  // hpre tiles per warp
  constexpr int kWT = 2 * (kHB / 16) * (C / 16) / kBwdWarps;  // dW tiles per warp
  constexpr int kG = 4;  // dW tiles whose partial loads are in flight together
  static_assert(kWT % kG == 0, "dW tiles in whole groups");
  if (threadIdx.x < kHB) db1s[threadIdx.x] = 0.f;

  for (int tile = split, it = 0; tile < tiles; tile += splits, ++it) {
    const int row0 = tile * S::BM;
    const uint4 zero = make_uint4(0, 0, 0, 0);
    for (int i = threadIdx.x; i < S::BM * (C / 8); i += kBwdThreads) {
      const int r = i / (C / 8), c = (i % (C / 8)) * 8;
      const size_t off = static_cast<size_t>(row0 + r) * C + c;
      const bool in = row0 + r < M;
      *reinterpret_cast<uint4*>(xn + r * S::LDX + c) =
          in ? *reinterpret_cast<const uint4*>(xn_in + off) : zero;
      *reinterpret_cast<uint4*>(dm + r * S::LDX + c) =
          in ? *reinterpret_cast<const uint4*>(dm_in + off) : zero;
    }
    __syncthreads();
    // hpre and dh for the block's 64 hidden columns
#pragma unroll
    for (int i = 0; i < kHT; ++i) {
      const int t = warp * kHT + i, r = t / (kHB / 16), c = t % (kHB / 16);
      const int hcol = j0 + c * 16;
      FragC hp, dh;
      wmma::fill_fragment(hp, 0.f);
      wmma::fill_fragment(dh, 0.f);
#pragma unroll 4
      for (int k0 = 0; k0 < C; k0 += 16) {
        FragA a;
        FragBCol b1f;
        FragBRow b2f;
        wmma::load_matrix_sync(b1f, w1 + static_cast<size_t>(hcol) * C + k0, C);
        wmma::load_matrix_sync(a, xn + r * 16 * S::LDX + k0, S::LDX);
        wmma::mma_sync(hp, a, b1f, hp);
        wmma::load_matrix_sync(b2f, w2 + static_cast<size_t>(k0) * hidden + hcol, hidden);
        wmma::load_matrix_sync(a, dm + r * 16 * S::LDX + k0, S::LDX);
        wmma::mma_sync(dh, a, b2f, dh);
      }
      wmma::store_matrix_sync(uh + r * 16 * S::LDU + c * 16, hp, S::LDU, wmma::mem_row_major);
      wmma::store_matrix_sync(ud + r * 16 * S::LDU + c * 16, dh, S::LDU, wmma::mem_row_major);
    }
    __syncthreads();
    // h = gelu(hpre + b1), dhpre = dh gelu'(hpre + b1): bf16 copies for the
    // GEMMs, f32 dhpre kept in ud for db1
    for (int i = threadIdx.x; i < S::BM * kHB; i += kBwdThreads) {
      const int r = i / kHB, c = i % kHB;
      const float hv = uh[r * S::LDU + c] + to_f(b1[j0 + c]);
      const float dv = ud[r * S::LDU + c] * gelu_grad(hv);
      hh[r * S::LDH + c] = to_bf(hv * gelu_cdf(hv));
      hd[r * S::LDH + c] = to_bf(dv);
      ud[r * S::LDU + c] = dv;
    }
    __syncthreads();
    if (threadIdx.x < kHB) {  // rows past M have dmlp = 0, so dhpre = 0
      float s = 0.f;
      for (int r = 0; r < S::BM; ++r) s += ud[r * S::LDU + threadIdx.x];
      db1s[threadIdx.x] += s;
    }
    // dW1[j0 + 16 a, 16 b] += dhpre^T xn and dW2[16 a, j0 + 16 b] += dmlp^T h
    // into the split's partial slice (first tile: start from zero), kG
    // tiles at a time so that their loads are in flight together
    for (int i0 = 0; i0 < kWT; i0 += kG) {
      FragC acc[kG];
      float* dst[kG];
      int ld[kG], ta[kG], tb[kG];
      bool first[kG];
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        const int t = warp * kWT + i0 + g;
        first[g] = t < (kHB / 16) * (C / 16);
        const int tt = first[g] ? t : t - (kHB / 16) * (C / 16);
        if (first[g]) {  // dW1 tile (hidden row block ta, column block tb)
          ta[g] = tt / (C / 16);
          tb[g] = tt % (C / 16);
          dst[g] = dw1 + static_cast<size_t>(j0 + ta[g] * 16) * C + tb[g] * 16;
          ld[g] = C;
        } else {  // dW2 tile (channel row block ta, hidden column block tb)
          ta[g] = tt / (kHB / 16);
          tb[g] = tt % (kHB / 16);
          dst[g] = dw2 + static_cast<size_t>(ta[g] * 16) * hidden + j0 + tb[g] * 16;
          ld[g] = hidden;
        }
        if (it == 0) wmma::fill_fragment(acc[g], 0.f);
        else wmma::load_matrix_sync(acc[g], dst[g], ld[g], wmma::mem_row_major);
      }
#pragma unroll
      for (int g = 0; g < kG; ++g) {
#pragma unroll
        for (int kk = 0; kk < S::BM; kk += 16) {
          FragACol a;
          FragBRow b;
          if (first[g]) {
            wmma::load_matrix_sync(a, hd + kk * S::LDH + ta[g] * 16, S::LDH);
            wmma::load_matrix_sync(b, xn + kk * S::LDX + tb[g] * 16, S::LDX);
          } else {
            wmma::load_matrix_sync(a, dm + kk * S::LDX + ta[g] * 16, S::LDX);
            wmma::load_matrix_sync(b, hh + kk * S::LDH + tb[g] * 16, S::LDH);
          }
          wmma::mma_sync(acc[g], a, b, acc[g]);
        }
      }
#pragma unroll
      for (int g = 0; g < kG; ++g)
        wmma::store_matrix_sync(dst[g], acc[g], ld[g], wmma::mem_row_major);
    }
    __syncthreads();
  }
  if (threadIdx.x < kHB)
    db1_part[static_cast<size_t>(split) * hidden + j0 + threadIdx.x] = db1s[threadIdx.x];
}

template <int C>
cudaError_t launch_mlp_bwd(const void* x, const void* gy, const void* g, const void* be,
                           const void* w1, const void* b1, const void* w2, const void* keep,
                           int rows_per_sample, void* dx, void* dg_part, void* dbe_part,
                           void* dw1_part, void* dw2_part, void* db1_part, void* xn_buf,
                           void* dm_buf, int M, int hidden, int splits, float eps,
                           cudaStream_t stream) {
  using SX = DxShape<C>;
  using SW = DwShape<C>;
  cudaError_t err = allow_smem(mlp_bwd_dx_kernel<C>, SX::SMEM);
  if (err != cudaSuccess) return err;
  err = allow_smem(mlp_bwd_dw_kernel<C>, SW::SMEM);
  if (err != cudaSuccess) return err;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* gb = static_cast<const bf16*>(gy);
  const bf16* gam = static_cast<const bf16*>(g);
  const bf16* bet = static_cast<const bf16*>(be);
  const bf16* w1b = static_cast<const bf16*>(w1);
  const bf16* b1b = static_cast<const bf16*>(b1);
  const bf16* w2b = static_cast<const bf16*>(w2);
  const float* kp = static_cast<const float*>(keep);
  mlp_bwd_dx_kernel<C><<<(M + SX::BM - 1) / SX::BM, kBwdThreads, SX::SMEM, stream>>>(
      xb, gb, gam, bet, w1b, b1b, w2b, kp, rows_per_sample, static_cast<bf16*>(dx),
      static_cast<float*>(dg_part), static_cast<float*>(dbe_part), static_cast<bf16*>(xn_buf),
      static_cast<bf16*>(dm_buf), M, hidden, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mlp_bwd_dw_kernel<C><<<dim3(hidden / kHB, splits), kBwdThreads, SW::SMEM, stream>>>(
      static_cast<const bf16*>(xn_buf), static_cast<const bf16*>(dm_buf), w1b, b1b, w2b,
      static_cast<float*>(dw1_part), static_cast<float*>(dw2_part),
      static_cast<float*>(db1_part), M, hidden);
  return cudaGetLastError();
}

}  // namespace lavt

// Rows per block of the dx kernel (the count of dgamma/dbeta partials is
// ceil(M / rows)) and of a dW row tile, for C in 128/256/512/1024; 0 else.
extern "C" int lavt_mlp_bwd_rows(int C, int dw) {
  using namespace lavt;
  switch (C) {
    case 128: return dw ? DwShape<128>::BM : DxShape<128>::BM;
    case 256: return dw ? DwShape<256>::BM : DxShape<256>::BM;
    case 512: return dw ? DwShape<512>::BM : DxShape<512>::BM;
    case 1024: return dw ? DwShape<1024>::BM : DxShape<1024>::BM;
    default: return 0;
  }
}

extern "C" int lavt_mlp_bwd(const void* x, const void* gy, const void* g, const void* be,
                            const void* w1, const void* b1, const void* w2, const void* keep,
                            int rows_per_sample, void* dx, void* dg_part, void* dbe_part,
                            void* dw1_part, void* dw2_part, void* db1_part, void* xn_buf,
                            void* dm_buf, int M, int C, int hidden, int splits, float eps,
                            void* stream) {
  using namespace lavt;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (C) {
#define LAVT_MLP_BWD_CASE(CC)                                                              \
  case CC:                                                                                 \
    err = launch_mlp_bwd<CC>(x, gy, g, be, w1, b1, w2, keep, rows_per_sample, dx, dg_part, \
                             dbe_part, dw1_part, dw2_part, db1_part, xn_buf, dm_buf, M,    \
                             hidden, splits, eps, s);                                      \
    break;
    LAVT_MLP_BWD_CASE(128)
    LAVT_MLP_BWD_CASE(256)
    LAVT_MLP_BWD_CASE(512)
    LAVT_MLP_BWD_CASE(1024)
#undef LAVT_MLP_BWD_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
