"""Attention-only window attention on pre-projected heads (K10) and its
backward (K9).

Counterpart of `lavt_rs_tpu/ops/pallas/window_attn.py`:
`window_attention_pallas` (`_fwd`, `_fwd_kernel`) with its `custom_vjp`
(`_vjp_fwd`, `_vjp_bwd`) and `attention_core_bwd` (`_bwd_kernel`), and of
`lavt_rs_tpu/ops/attention.py`'s dispatcher: q, k, v are (B, nW, heads,
N, hd), the bias (heads, N, N) and the shift mask (nW, N, N) or None.
Every window-7 2D Swin block and every video Swin block with N <= 400
reaches it between its `qkv` and `proj` Linears (at video inference the
C = 96 blocks take the grouped K2p route instead).

  * `window_attention_plain`: f32 math from the inputs: q·scale rounded
    to the input dtype, the scores, bias, mask and softmax in f32, P
    rounded to the input dtype before P·v, the output rounded once (the
    kernel's online softmax rounds exp(s - running max) and divides by
    the row sum after P·v: the same within that rounding);
  * `attention_core_bwd_plain`: the plain version of K9, the JAX kernel's
    f32 math (P recomputed, dS = P (dP - rowsum(do o))) with the kernel's
    rounding points;
  * `window_attention`: the plain version for a CPU tensor; for a CUDA
    tensor the kernel of csrc/window_attn_sm90.cu (bf16, head dim 32,
    any N <= 400; its launch `k10_plan`), or it raises.
    `window_attention_qkv` runs it at inference on the qkv Linear's
    output, by strides, with O in the layout the out-projection reads
    (plain version `window_attention_qkv_plain`);
    `attention_qkv_grouped` does the same with the windows grouped by
    mask, K2p's attention launch (`ops/fused_msa.grouped_launches`).
    K9 is csrc/window_attn_bwd_sm90.cu, two launches and a sum
    (`bwd_launches`, its grids `k9_plan`).  Where autograd records the
    call it goes through `WindowAttention`: K10 in save mode (the output
    and each row's log-sum-exp) forward and K9 backward on the card, the
    plain versions of both on the CPU (so the CPU tests run the plain
    backward, not autograd through the plain forward).
  * the f32 variants: on a CUDA f32 tensor every entry point above takes
    K10 f32 (csrc/window_attn_f32.cu: both modes, the strided and grouped
    routes; its launch `k10_f32_plan`; counted by `window_attention_f32`)
    or K9 f32 (csrc/window_attn_bwd_f32.cu, two launches and the sum,
    `bwd_launches_f32`, its grids `k9_f32_plan`; counted by
    `attention_core_bwd_f32`): both in 3xTF32 on the tensor cores
    (mma.sync), with the same max-subtracted softmax, whose plain
    versions are the ones above (at f32 their roundings to q's dtype are
    no-ops).

Routing: `attn_fwd_supported` is the JAX package's predicate
(`_attn_tiling`'s arithmetic, copied): the 2D Swin block takes K10 (and
K9 in training) exactly where it holds, as the JAX dispatcher does
(`lavt_rs_tpu/ops/attention.py:65-74`); it holds at window 7 (N = 49) for
every Swin size, where the JAX backward predicate
(`attention_core_bwd_supported`) holds too, so the JAX package takes its
K9 there as well (tests/test_torch_routing.py holds both).  It is False
above N = 256 (a TPU VMEM and measurement gate), where the JAX package
runs XLA.  The 3D video blocks route by `attn_fwd_routed_3d`, the same
predicate plus the port's extension to N <= 400, so the 8-frame video
windows (N = 392) keep K10/K9 as they have since the video slice; window
(8, 12, 12) (N = 1152) runs the torch chain of `ops/attention.py`, as the
JAX package runs XLA there.  The kernels take head dim 32 only
(`window_attn_supported`); the wrappers raise on anything else.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch

from . import cuda_lib
from .fused_msa import sum_partials

HEAD_DIM = 32
MAX_N = 400
# K10's launch (csrc/window_attn_sm90.cu): 64-row units, two warpgroups a
# block, a ring of two stages a warpgroup; an H100 SM's shared memory and
# what each block reserves of it
K10_TILE, K10_WARPGROUPS, K10_STAGES = 64, 2, 2
SMEM_PER_SM, SMEM_PER_BLOCK_RESERVED = 233472, 1024
# K10 f32 (csrc/window_attn_f32.cu, 3xTF32 on mma.sync): keys in chunks of
# 56; at N <= 56 items of 64 query rows (4 warps, one chunk, the head's
# bias staged, three blocks an SM), above of 80 (5 warps, two blocks an
# SM: their registers hold a chunk's bias and mask).  Its shared
# memory at N <= 56 and above: raw q (the item's rows), k and v (56 rows)
# tiles with rows 36 floats apart, k NT and v NN fragment tiles of 56 rows
# (8 bytes an element), and at N <= 56 the bias in C-fragment order (4
# warps x 7 key tiles x 32 lanes x 16 bytes)
K10_F32_CHUNK = 56
K10_F32_WARPS, K10_F32_PER_SM = (4, 5), (3, 2)
K10_F32_SMEM = tuple(16 * w * 36 * 4 + 2 * 56 * 36 * 4 + 2 * 56 * 32 * 8
                     + (w * 7 * 32 * 16 if w == 4 else 0)
                     for w in K10_F32_WARPS)
# K9 f32 (csrc/window_attn_bwd_f32.cu, csrc/attn_tf32.cuh): blocks of 5
# warps on 80 rows (queries in launch 1, keys in launch 2), the other side
# in tiles of 56; raw [row][d] tiles with rows 36 floats apart and fragment
# tiles of 56 rows (8 bytes an element: hi and lo).  Launch 1: fragment
# tiles k NT, k NN, v NT, raw k and v (56 rows), a ring of two stages of q
# and do (80 rows) and lse; launch 2: fragment tiles q NT, q NN, do NT, do
# NN, raw q and do (56 rows), raw k and v (80), a ring of two stages of lse
# and D (56).  Both are built for two blocks an SM (__launch_bounds__).
K9_F32_ROWS, K9_F32_COLS, K9_F32_THREADS, K9_F32_PER_SM = 80, 56, 160, 2
_FRAG56, _RAW56, _RAW80 = 56 * 32 * 8, 56 * 36 * 4, 80 * 36 * 4
K9_F32_SMEM = (3 * _FRAG56 + 2 * _RAW56 + 2 * (2 * _RAW80 + 80 * 4),
               4 * _FRAG56 + 2 * _RAW56 + 2 * _RAW80 + 4 * 56 * 4)


def _scores(q, k, bias, mask, scale) -> torch.Tensor:
    """f32 s = (q·scale) kᵀ + bias + mask, q·scale rounded to q's dtype as
    the kernels round it."""
    qs = (q.float() * scale).to(q.dtype).float()
    s = qs @ k.float().transpose(-1, -2) + bias.float()
    if mask is not None:
        s = s + mask.float()[None, :, None]
    return s


def window_attention_plain(q, k, v, bias, mask: Optional[torch.Tensor] = None,
                           scale: Optional[float] = None) -> torch.Tensor:
    """The plain version of K10.  Returns (B, nW, heads, N, hd) in q's
    dtype."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    s = _scores(q, k, bias, mask, scale)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return (p.float() @ v.float()).to(q.dtype)


def window_attention_save_plain(q, k, v, bias, mask=None,
                                scale: Optional[float] = None
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of K10's save mode: (O, lse), lse the f32
    log-sum-exp of each row's scores, (B, nW, heads, N)."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    s = _scores(q, k, bias, mask, scale)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return (p.float() @ v.float()).to(q.dtype), torch.logsumexp(s, dim=-1)


def attention_core_bwd_plain(q, k, v, bias, mask, do,
                             scale: Optional[float] = None,
                             o: Optional[torch.Tensor] = None):
    """The plain version of K9: the backward of softmax(q kᵀ·scale + bias +
    mask) v.  Returns (dq, dk, dv) in q's dtype and dbias (heads, N, N) f32
    summed over batch and windows; the mask gets no cotangent (a constant
    of region ids), as in the JAX kernel.  f32 math, rounded to q's dtype
    where the kernel rounds (q·scale as K10 does, P before P^T do, dS
    before dS k and dS^T q); D = rowsum(do o) from the forward's output o
    (K10's, as the kernel takes it; by default this function's own), which
    is rowsum(dP P).  In f32 that is the JAX kernel's math."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    dt = q.dtype

    def rounded(t):
        return t.to(dt).float()

    p = torch.softmax(_scores(q, k, bias, mask, scale), dim=-1)
    if o is None:
        o = (rounded(p) @ v.float()).to(dt)
    gf = do.float()
    dv = rounded(p).transpose(-1, -2) @ gf
    dp = gf @ v.float().transpose(-1, -2)
    ds = p * (dp - (gf * o.float()).sum(-1, keepdim=True))
    dq = rounded(ds) @ k.float() * scale
    dk = rounded(ds).transpose(-1, -2) @ rounded(q.float() * scale)
    return dq.to(dt), dk.to(dt), dv.to(dt), ds.sum(dim=(0, 1))


def _attn_tiling(h: int, nw: int, n: int, hd: int, itemsize: int,
                 score_tiles: int, budget: int):
    """The JAX kernels' (head-group, window-chunk) search
    (`lavt_rs_tpu/ops/pallas/window_attn.py:_attn_tiling`): the largest
    per-step batch cw hg whose f32 score tiles and blocks fit the TPU
    budget; None above N = 256 or when a step would be too small."""
    if n > 256:
        return None
    best = None
    for hg in range(h, 0, -1):
        if h % hg:
            continue
        for cw in range(1, nw + 1):
            if nw % cw:
                continue
            slots = cw * hg
            cost = (hg * n * n * 4 + score_tiles * slots * n * n * 4
                    + 2 * cw * n * n * 2 + 2 * 5 * slots * n * hd * itemsize)
            if cost <= budget:
                key = (slots, hg)
                if best is None or key > best[0]:
                    best = (key, hg, cw)
    if best is None:
        return None
    _, hg, cw = best
    if cw * hg < 2 and h * nw > cw * hg:
        return None
    return hg, cw


@functools.lru_cache(maxsize=None)
def attn_fwd_supported(nw: int, n: int, heads: int, hd: int) -> bool:
    """The JAX routing predicate of K10 (`attn_fwd_supported`)."""
    return _attn_tiling(heads, nw, n, hd, 4, score_tiles=3,
                        budget=11 * 1024 * 1024) is not None


def attn_fwd_routed_3d(nw: int, n: int, heads: int, hd: int) -> bool:
    """The 3D blocks' route to K10 (K10 save + K9 in training): the JAX
    predicate, plus the port's extension to N <= 400, which takes the
    8-frame video windows (N = 392) that the JAX package leaves to XLA
    behind its TPU gate of N <= 256."""
    return attn_fwd_supported(nw, n, heads, hd) or n <= MAX_N


def window_attn_supported(n: int, hd: int) -> bool:
    """Geometries the CUDA kernels take: head dim 32, 1 <= N <= 400."""
    return hd == HEAD_DIM and 1 <= n <= MAX_N


def _require_supported(n: int, hd: int) -> None:
    if not window_attn_supported(n, hd):
        raise ValueError(f"window attention kernel: unsupported (N, hd) "
                         f"{(n, hd)}")


def _check_bias_mask(bias, mask, heads, nw, n, dev):
    """Raise unless bias (heads, N, N) and mask (nW, N, N) or None are
    contiguous f32 on `dev`, 16-byte aligned."""
    for name, t, want in (("bias", bias, (heads, n, n)),
                          ("mask", mask, (nw, n, n))):
        if t is None:
            continue
        if t.dtype != torch.float32 or t.device != dev or t.shape != want \
                or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}, expected contiguous float32 "
                             f"{want} on {dev}, 16-byte aligned")


def _check(q, tensors, bias, mask, dtype=torch.bfloat16):
    """K9's arguments: raise unless the kernels take q's geometry, every
    tensor of `tensors` is contiguous `dtype` (bf16; f32 for K9 f32) of q's
    shape on q's device and 16-byte aligned (the kernels move 16-byte
    words), and bias and mask pass `_check_bias_mask`."""
    b, nw, heads, n, hd = q.shape
    _require_supported(n, hd)
    for name, t in tensors:
        cuda_lib.require(t, name, dtype, q.device, q.shape)
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: data must be 16-byte aligned")
    _check_bias_mask(bias, mask, heads, nw, n, q.device)


def k10_smem(n: int) -> int:
    """Dynamic shared memory of a K10 block at N (csrc/window_attn_sm90.cu's
    smem_bytes, exported as `lavt_k10_smem`; tests/test_torch_kernels_cuda.py
    holds the two equal at every N): per warpgroup a ring of stages (q, k, v tiles of 4 KB; at
    N <= 64 the window's flat f32 mask, its 16-byte-aligned span in whole
    KB, and once the head's flat bias; above, a 64 x 72 f32 mask tile and
    the block's 64 bias rows, 2 x 200 keys), the barriers, 1 KB of
    alignment."""
    qkv = 3 * K10_TILE * HEAD_DIM * 2
    if n <= K10_TILE:
        flat = -(-(n * n * 4 + 32) // 1024) * 1024
        per_wg, shared = flat + K10_STAGES * (qkv + flat), 0
    else:
        per_wg, shared = K10_STAGES * (qkv + K10_TILE * 72 * 4), 2 * 64 * 200 * 4
    barriers = (K10_WARPGROUPS * K10_STAGES + K10_WARPGROUPS + 1) * 8
    return 1024 + shared + K10_WARPGROUPS * per_wg + barriers


@functools.lru_cache(maxsize=256)
def k10_plan(bw: int, heads: int, n: int, sms: int) -> dict:
    """K10's launch on `sms` SMs: units of 64 query rows of one (window,
    head), two warpgroups a block, no block beyond one wave.
      * N <= 64: `blocks` persistent blocks; warpgroup c of T takes units
        c, c + T, ... (u = window heads + head).  It holds one head's bias
        in registers, so where it takes several units T is a multiple of
        the heads.
      * N > 64: units ordered (q tile, head) outermost, u = (q tile heads +
        head) B nW + window; block b takes the run [b P, (b + 1) P) of P =
        ceil(units / blocks) units, its warpgroups every other one, and
        loads each (q tile, head)'s 64 bias rows once (`bias_loads` per
        block at most).
    Returns the plan's numbers (chip_smoke.py prints them)."""
    tiles = -(-n // K10_TILE)
    units = bw * tiles * heads
    smem = k10_smem(n)
    flat = n <= K10_TILE
    per_sm = min(2 if flat else 1,
                 SMEM_PER_SM // (smem + SMEM_PER_BLOCK_RESERVED))
    if per_sm < 1:
        raise ValueError(f"K10: {smem} bytes of shared memory at N = {n}")
    cap = sms * per_sm
    blocks = min(cap, -(-units // K10_WARPGROUPS))
    if flat and blocks * K10_WARPGROUPS < units:
        step = heads // math.gcd(heads, K10_WARPGROUPS)
        blocks = max(step, blocks // step * step)
    per_block = -(-units // blocks)
    plan = dict(units=units, items=units * tiles, blocks=blocks,
                warpgroups=blocks * K10_WARPGROUPS, per_sm=per_sm,
                waves=blocks / cap, smem=smem, per_block=per_block)
    if flat:
        plan["units_per_warpgroup"] = -(-units // (blocks * K10_WARPGROUPS))
    else:
        plan["units_per_warpgroup"] = -(-per_block // K10_WARPGROUPS)
        plan["bias_loads"] = max(
            (min(units, u0 + per_block) - 1) // bw - u0 // bw + 1
            for u0 in range(0, units, per_block))
    return plan


@functools.lru_cache(maxsize=256)
def k10_f32_plan(bw: int, heads: int, n: int, sms: int) -> dict:
    """K10 f32's launch (csrc/window_attn_f32.cu) on `sms` SMs.  An item is
    `rows` query rows of one (window, head) unit (64 at N <= 56, else 80),
    ordered (head, query tile, window): item = (h qtiles + t) bw + w, so
    that a block's items share their bias rows.  A block of 32 `warps`
    threads walks `per_block` consecutive items, the keys of each in
    `chunks` of 56; the blocks fill the SMs once at `per_sm` an SM
    (K10_F32_PER_SM).  At N <= 56 (one chunk, one item a unit) a block
    stages its head's bias when its run reaches a new head: `bias_loads`
    per block at most."""
    small = n <= K10_F32_CHUNK
    warps, per_sm = (K10_F32_WARPS[0 if small else 1],
                     K10_F32_PER_SM[0 if small else 1])
    rows = 16 * warps
    qtiles = -(-n // rows)
    items = bw * heads * qtiles
    per_block = -(-items // (per_sm * sms))
    blocks = -(-items // per_block)
    plan = dict(bw=bw, heads=heads, small=small, warps=warps,
                threads=32 * warps, rows=rows,
                qtiles=qtiles, chunks=-(-n // K10_F32_CHUNK), items=items,
                per_block=per_block, blocks=blocks, per_sm=per_sm,
                smem=K10_F32_SMEM[0 if small else 1])
    if small:
        plan["bias_loads"] = max(
            (min(items, i0 + per_block) - 1) // bw - i0 // bw + 1
            for i0 in range(0, items, per_block))
    return plan


def _check_k10(q, k, v, bias, mask, dtype=torch.bfloat16):
    """Raise unless K10 (K10 f32 for dtype float32) takes these: q, k, v
    `dtype` views with one set of strides, hd contiguous, every stride and
    base 16-byte aligned (the tensor maps', K10 f32's 16-byte words); bias
    and mask f32 and contiguous.  Lean: window 7 calls K10 24 times a
    forward, where the host sets the pace."""
    shape, dev = q.shape, q.device
    b, nw, heads, n, hd = shape
    _require_supported(n, hd)
    st = q.stride()
    if k.stride() != st or v.stride() != st:
        raise ValueError("q, k, v: the kernel takes one set of strides")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != dtype or t.device != dev or t.shape != shape:
            raise TypeError(f"{name}: {t.dtype} {tuple(t.shape)} on "
                            f"{t.device}, expected {dtype} {tuple(shape)} "
                            f"on {dev}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: data must be 16-byte aligned")
    words = 16 // q.element_size()
    if st[4] != 1 or (st[1] | st[2] | st[3]) % words or (
            b > 1 and st[0] != nw * st[1]):
        raise ValueError(f"q, k, v: strides {st} (hd contiguous, the others "
                         "16-byte aligned, batch and window merged)")
    _check_bias_mask(bias, mask, heads, nw, n, dev)


def _row_aligned(t):
    """Above N = 64 the kernel reads the bias and mask by 3-D tensor maps,
    whose rows must lie 16 bytes apart: for N % 4 != 0 the rows padded to
    N rounded up to 4, returned with that row stride (a copy, on no
    path's shape); else t and N."""
    n = t.shape[-1]
    if n <= K10_TILE or n % 4 == 0:
        return t, n
    return torch.nn.functional.pad(t, (0, -n % 4)), n + (-n % 4)


def _k10_call(ptrs, qst, ost, b, nw, heads, n, bias, mask, lse, scale,
              device, nu=0, f32=False):
    """The launch, on checked arguments: ptrs (q, k, v, o), the element
    strides (window, head, row) of q, k, v and of O; windows nu.. of each
    image take mask[w - nu] (no window a mask when mask is None).  f32:
    K10 f32's launch (`lavt_window_attn_f32`, plan `k10_f32_plan`)."""
    sms = cuda_lib.sm_count(device.index or 0)
    if f32:
        plan = k10_f32_plan(b * nw, heads, n, sms)
        q, k, v, o = ptrs
        err = cuda_lib.lib().lavt_window_attn_f32(
            q, k, v, bias.data_ptr(),
            None if mask is None else mask.data_ptr(), o,
            None if lse is None else lse.data_ptr(), *qst, *ost, b * nw, nw,
            nu if mask is not None else nw, heads, n, plan["per_block"],
            float(scale), cuda_lib.stream_ptr(device))
        cuda_lib.check(err, "lavt_window_attn_f32")
        return
    plan = k10_plan(b * nw, heads, n, sms)
    bias, ld = _row_aligned(bias)
    if mask is not None:
        mask, _ = _row_aligned(mask)
    q, k, v, o = ptrs
    err = cuda_lib.lib().lavt_window_attn(
        q, k, v, bias.data_ptr(), None if mask is None else mask.data_ptr(),
        o, None if lse is None else lse.data_ptr(), *qst, *ost, b * nw, nw,
        nu if mask is not None else nw, heads, n, ld, plan["blocks"],
        float(scale), cuda_lib.stream_ptr(device))
    cuda_lib.check(err, "lavt_window_attn")


def _launch(q, k, v, bias, mask, scale, save: bool,
            dtype=torch.bfloat16):
    """K10 (K10 f32 for dtype float32) on q, k, v views (_check_k10): (O
    contiguous, lse or None)."""
    b, nw, heads, n, _ = q.shape
    _check_k10(q, k, v, bias, mask, dtype)
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, nw, heads, n), dtype=torch.float32,
                       device=q.device) if save else None)
    _k10_call((q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr()),
              q.stride()[1:4], o.stride()[1:4], b, nw, heads, n, bias, mask,
              lse, scale, q.device, f32=dtype == torch.float32)
    return o, lse


# -- K9's launches (csrc/window_attn_bwd_sm90.cu) and their plain versions ---

def k9_plan(bw: int, heads: int, n: int, sms: int) -> dict:
    """K9's grids on `sms` SMs (one block of two warpgroups per SM).
    Launch 1 takes (bp, query tiles x heads) blocks, block (b, (i, h)) the
    windows b, b + bp, ...; bp as many as fill the SMs once (at least 1,
    at most the windows); its dbias partials are bp (above N = 64: both
    warpgroups on each window) or 2 bp (one per warpgroup).  Launch 2:
    persistent blocks over the B nW x key tiles x heads units."""
    tiles = -(-n // K10_TILE)
    pairs = tiles * heads
    bp = max(1, min(bw, round(sms / pairs)))
    units = bw * tiles * heads
    return dict(bp=bp, parts=bp if n > K10_TILE else 2 * bp,
                q_blocks=bp * pairs,
                kv_blocks=min(sms, -(-units // K10_WARPGROUPS)), units=units)


def mask_flags(mask) -> Optional[torch.Tensor]:
    """(nW,) int32 window flags of a (nW, N, N) mask: 1 where the window's
    mask has a nonzero (None for None).  K9 reads the masks of flagged
    windows only; the Swin blocks take their shift masks' flags from
    `ops/window.shift_mask_flags_2d` / `_3d`, built with the masks, and a
    caller holding another mask computes them once here."""
    return None if mask is None else (mask != 0).flatten(1).any(1).int()


def _bwd_probs(q, k, bias, mask, scale, lse):
    """P = exp(s - lse) of the launches' plain versions (f32)."""
    return torch.exp(_scores(q, k, bias, mask, scale) - lse[..., None])


def attention_bwd_q_plain(q, k, v, bias, mask, do, scale, o, lse, plan):
    """The plain version of launch 1: dq (q's dtype), bf16(q scale) (qs,
    K10's rounding, for launch 2), D = rowsum(do o) and the dbias partials
    (parts, heads, N, N) f32 as `k9_plan` cuts them (part b: windows b,
    b + bp, ...; below N = 65 part 2 b + w: every other of them, from the
    w-th), or `k9_f32_plan` (part b at every N)."""
    b, nw, heads, n, _ = q.shape
    dt = q.dtype
    p = _bwd_probs(q, k, bias, mask, scale, lse)
    dsum = (do.float() * o.float()).sum(-1)
    ds = p * (do.float() @ v.float().transpose(-1, -2) - dsum[..., None])
    dq = (ds.to(dt).float() @ k.float() * scale).to(dt)
    bp, ds_w = plan["bp"], ds.flatten(0, 1)  # (B nW, heads, N, N)
    win = torch.arange(b * nw)
    part = (win % bp if plan["parts"] == bp
            else 2 * (win % bp) + (win // bp) % 2)
    dbias_part = torch.stack([ds_w[part == i].sum(0)
                              for i in range(plan["parts"])])
    return dq, (q.float() * scale).to(dt), dsum, dbias_part


def attention_bwd_kv_plain(qs, k, v, bias, mask, do, lse, dsum):
    """The plain version of launch 2: dk and dv in qs's dtype, from launch
    1's qs = bf16(q scale) and dsum; P and dS rounded to qs's dtype for the
    products."""
    dt = qs.dtype
    p = _bwd_probs(qs, k, bias, mask, 1.0, lse)
    ds = p * (do.float() @ v.float().transpose(-1, -2) - dsum[..., None])
    dv = p.to(dt).float().transpose(-1, -2) @ do.float()
    dk = ds.to(dt).float().transpose(-1, -2) @ qs.float()
    return dk.to(dt), dv.to(dt)


def _ptr(t) -> Optional[int]:
    return None if t is None else t.data_ptr()


def attention_bwd_q(q, k, v, bias, mask, do, scale, o, lse, plan,
                    flags=None):
    """Launch 1 (`lavt_window_attn_bwd_q`): (dq, qs, dsum, dbias
    partials); the plain version on a CPU tensor.  `flags` (`mask_flags`)
    names the windows whose mask the launch reads; None: every window's.
    Above N = 64 the launches read the bias by TMA, whose rows must lie 16
    bytes apart: for N % 4 != 0 (no path's shape) a padded copy
    (`_row_aligned`); at N <= 64 they copy it by plain loads."""
    if q.device.type == "cpu":
        return attention_bwd_q_plain(q, k, v, bias, mask, do, scale, o, lse,
                                     plan)
    b, nw, heads, n, _ = q.shape
    biasp, ld = _row_aligned(bias)
    dq, qs = torch.empty_like(q), torch.empty_like(q)
    dsum = torch.empty_like(lse)
    part = torch.empty((plan["parts"], heads, n, n), dtype=torch.float32,
                       device=q.device)
    err = cuda_lib.lib().lavt_window_attn_bwd_q(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), biasp.data_ptr(),
        _ptr(mask), _ptr(flags), dq.data_ptr(),
        qs.data_ptr(), dsum.data_ptr(), part.data_ptr(), b * nw, nw, heads,
        n, ld, plan["bp"], float(scale), cuda_lib.stream_ptr(q.device))
    cuda_lib.check(err, "lavt_window_attn_bwd_q")
    return dq, qs, dsum, part


def attention_bwd_kv(qs, k, v, bias, mask, do, lse, dsum, plan,
                     flags=None):
    """Launch 2 (`lavt_window_attn_bwd_kv`): (dk, dv) from launch 1's qs
    and dsum, the bias and flags as launch 1 takes them; the plain version
    on a CPU tensor."""
    if qs.device.type == "cpu":
        return attention_bwd_kv_plain(qs, k, v, bias, mask, do, lse, dsum)
    b, nw, heads, n, _ = qs.shape
    biasp, ld = _row_aligned(bias)
    dk, dv = torch.empty_like(qs), torch.empty_like(qs)
    err = cuda_lib.lib().lavt_window_attn_bwd_kv(
        qs.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), dsum.data_ptr(), biasp.data_ptr(),
        _ptr(mask), _ptr(flags), dk.data_ptr(),
        dv.data_ptr(), b * nw, nw, heads, n, ld, plan["kv_blocks"],
        cuda_lib.stream_ptr(qs.device))
    cuda_lib.check(err, "lavt_window_attn_bwd_kv")
    return dk, dv


def bwd_launches(q, k, v, bias, mask, do, scale, o, lse,
                 plan: Optional[dict] = None, flags=None):
    """K9's launches, in order (csrc/window_attn_bwd_sm90.cu): launch 1
    (`attention_bwd_q`: dq, bf16(q scale), D, the dbias partials), launch 2
    (`attention_bwd_kv`: dk, dv), `sum_partials` of dbias.  On CPU tensors
    each takes its plain version, which compose to
    `attention_core_bwd_plain`'s values (tests/test_torch_k9_launches.py).
    Returns (dq, dk, dv, dbias)."""
    b, nw, heads, n, _ = q.shape
    if plan is None:
        sms = (cuda_lib.sm_count(q.device.index or 0)
               if q.device.type == "cuda" else 132)
        plan = k9_plan(b * nw, heads, n, sms)
    dq, qs, dsum, part = attention_bwd_q(q, k, v, bias, mask, do, scale, o,
                                         lse, plan, flags)
    dk, dv = attention_bwd_kv(qs, k, v, bias, mask, do, lse, dsum, plan,
                              flags)
    return dq, dk, dv, sum_partials(part)


def _bwd_launch(q, k, v, bias, mask, do, scale, o, lse, flags):
    """K9 on the card: the checks, then `bwd_launches`."""
    b, nw, heads, n, _ = q.shape
    _check(q, (("q", q), ("k", k), ("v", v), ("o", o), ("do", do)), bias,
           mask)
    cuda_lib.require(lse, "lse", torch.float32, q.device, (b, nw, heads, n))
    if mask is None:
        flags = None
    elif flags is not None:
        cuda_lib.require(flags, "flags", torch.int32, q.device, (nw,))
    return bwd_launches(q, k, v, bias, mask, do, scale, o, lse, flags=flags)


# -- K9 f32's launches (csrc/window_attn_bwd_f32.cu) ---------------------------

def k9_f32_plan(bw: int, heads: int, n: int, sms: int) -> dict:
    """K9 f32's grids on `sms` SMs.  Launch 1: (bp, query tiles x heads)
    blocks of K9_F32_THREADS threads (tiles of K9_F32_ROWS queries), block
    (b, (i, h)) the windows b, b + bp, ... (at least 1, at most the
    windows), bp as many as fill the SMs once at K9_F32_PER_SM blocks an
    SM; one dbias partial a b (`parts`).  Launch 2: a block per (window,
    head, tile of K9_F32_ROWS keys)."""
    tiles = -(-n // K9_F32_ROWS)
    pairs = tiles * heads
    bp = max(1, min(bw, K9_F32_PER_SM * sms // pairs))
    return dict(bp=bp, parts=bp, q_blocks=bp * pairs,
                kv_blocks=bw * heads * tiles, threads=K9_F32_THREADS,
                q_smem=K9_F32_SMEM[0], kv_smem=K9_F32_SMEM[1])


def attention_bwd_q_f32(q, k, v, bias, mask, do, scale, o, lse, plan,
                        flags=None):
    """K9 f32's launch 1 (`lavt_window_attn_bwd_q_f32`): (dq, D =
    rowsum(do o), the dbias partials (parts, heads, N, N), part b from the
    windows b, b + bp, ...) in f32; the plain version (launch 1's of K9,
    `attention_bwd_q_plain`) on a CPU tensor."""
    if q.device.type == "cpu":
        dq, _, dsum, part = attention_bwd_q_plain(q, k, v, bias, mask, do,
                                                  scale, o, lse, plan)
        return dq, dsum, part
    b, nw, heads, n, _ = q.shape
    dq, dsum = torch.empty_like(q), torch.empty_like(lse)
    part = torch.empty((plan["parts"], heads, n, n), dtype=torch.float32,
                       device=q.device)
    err = cuda_lib.lib().lavt_window_attn_bwd_q_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), bias.data_ptr(), _ptr(mask),
        _ptr(flags), dq.data_ptr(), dsum.data_ptr(), part.data_ptr(),
        b * nw, nw, heads, n, plan["bp"], float(scale),
        cuda_lib.stream_ptr(q.device))
    cuda_lib.check(err, "lavt_window_attn_bwd_q_f32")
    return dq, dsum, part


def attention_bwd_kv_f32(q, k, v, bias, mask, do, scale, lse, dsum,
                         flags=None):
    """K9 f32's launch 2 (`lavt_window_attn_bwd_kv_f32`): (dk, dv) in f32
    from launch 1's D; the plain version (launch 2's of K9 on q scale) on a
    CPU tensor."""
    if q.device.type == "cpu":
        return attention_bwd_kv_plain(q * scale, k, v, bias, mask, do, lse,
                                      dsum)
    b, nw, heads, n, _ = q.shape
    dk, dv = torch.empty_like(q), torch.empty_like(q)
    err = cuda_lib.lib().lavt_window_attn_bwd_kv_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), dsum.data_ptr(), bias.data_ptr(), _ptr(mask),
        _ptr(flags), dk.data_ptr(), dv.data_ptr(), b * nw, nw, heads, n,
        float(scale), cuda_lib.stream_ptr(q.device))
    cuda_lib.check(err, "lavt_window_attn_bwd_kv_f32")
    return dk, dv


def bwd_launches_f32(q, k, v, bias, mask, do, scale, o, lse,
                     plan: Optional[dict] = None, flags=None):
    """K9 f32's launches, in order (csrc/window_attn_bwd_f32.cu): launch 1
    (`attention_bwd_q_f32`: dq, D, the dbias partials), launch 2
    (`attention_bwd_kv_f32`: dk, dv), `sum_partials` of dbias.  On CPU
    tensors each takes its plain version, which compose to
    `attention_core_bwd_plain`'s values (tests/test_torch_f32_attn.py).
    Returns (dq, dk, dv, dbias)."""
    b, nw, heads, n, _ = q.shape
    if plan is None:
        sms = (cuda_lib.sm_count(q.device.index or 0)
               if q.device.type == "cuda" else 132)
        plan = k9_f32_plan(b * nw, heads, n, sms)
    dq, dsum, part = attention_bwd_q_f32(q, k, v, bias, mask, do, scale, o,
                                         lse, plan, flags)
    dk, dv = attention_bwd_kv_f32(q, k, v, bias, mask, do, scale, lse, dsum,
                                  flags)
    return dq, dk, dv, sum_partials(part)


def _bwd_launch_f32(q, k, v, bias, mask, do, scale, o, lse, flags):
    """K9 f32 on the card: the checks, then `bwd_launches_f32`."""
    b, nw, heads, n, _ = q.shape
    _check(q, (("q", q), ("k", k), ("v", v), ("o", o), ("do", do)), bias,
           mask, torch.float32)
    cuda_lib.require(lse, "lse", torch.float32, q.device, (b, nw, heads, n))
    if mask is None:
        flags = None
    elif flags is not None:
        cuda_lib.require(flags, "flags", torch.int32, q.device, (nw,))
    return bwd_launches_f32(q, k, v, bias, mask, do, scale, o, lse,
                            flags=flags)


# -- the entry points ----------------------------------------------------------

def window_attention_save(q, k, v, bias, mask=None,
                          scale: Optional[float] = None):
    """K10 in save mode: (O, lse); the plain version on a CPU tensor, K10
    f32's save mode on a CUDA f32 tensor (counted by
    `window_attention_f32`)."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if q.device.type == "cpu":
        return window_attention_save_plain(q, k, v, bias, mask, scale)
    if q.dtype == torch.float32:
        out = _launch(q, k, v, bias, mask, scale, True, torch.float32)
        window_attention_f32.launches += 1
        return out
    out = _launch(q, k, v, bias, mask, scale, save=True)
    window_attention.launches += 1
    return out


def attention_core_bwd(q, k, v, bias, mask, do, scale: Optional[float] = None,
                       o: Optional[torch.Tensor] = None,
                       lse: Optional[torch.Tensor] = None,
                       flags: Optional[torch.Tensor] = None):
    """K9: (dq, dk, dv, dbias) as `attention_core_bwd_plain`; the plain
    version on a CPU tensor, on a CUDA tensor the kernels, which take K10's
    saved output o and lse (where the JAX kernel recomputes o) and read
    the masks of the windows `flags` (`mask_flags`) names, or of every
    window without them."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if q.device.type == "cpu":
        return attention_core_bwd_plain(q, k, v, bias, mask, do, scale, o)
    if q.dtype == torch.float32:
        return attention_core_bwd_f32(q, k, v, bias, mask, do, scale, o, lse,
                                      flags)
    if o is None or lse is None:
        raise ValueError("attention_core_bwd on the card needs K10's saved "
                         "output and lse (window_attention_save)")
    out = _bwd_launch(q, k, v, bias, mask, do, scale, o, lse, flags)
    attention_core_bwd.launches += 1
    return out


def attention_core_bwd_f32(q, k, v, bias, mask, do,
                           scale: Optional[float] = None,
                           o: Optional[torch.Tensor] = None,
                           lse: Optional[torch.Tensor] = None,
                           flags: Optional[torch.Tensor] = None):
    """K9 f32: `attention_core_bwd` on f32 tensors, every output f32; the
    plain version on a CPU tensor, on a CUDA tensor the launches of
    `bwd_launches_f32` from K10 f32's saved o and lse (it raises on any
    other dtype)."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if q.device.type == "cpu":
        return attention_core_bwd_plain(q, k, v, bias, mask, do, scale, o)
    if o is None or lse is None:
        raise ValueError("attention_core_bwd on the card needs K10's saved "
                         "output and lse (window_attention_save)")
    out = _bwd_launch_f32(q, k, v, bias, mask, do, scale, o, lse, flags)
    attention_core_bwd_f32.launches += 1
    return out


class WindowAttention(torch.autograd.Function):
    """K10 in save mode forward, K9 backward (their plain versions on the
    CPU).  Saves K10's output and lse for K9, where the JAX VJP has its
    kernel recompute the output.  The bias and the mask are cast to f32
    and q, k, v made contiguous here; the grads come back in the inputs'
    dtypes, and the mask and its window flags get none."""

    @staticmethod
    def forward(ctx, q, k, v, bias, mask, scale: float, flags=None):
        ctx.scale, ctx.bias_dtype, ctx.flags = scale, bias.dtype, flags
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        bias = bias.float().contiguous()
        mask = None if mask is None else mask.float().contiguous()
        o, lse = window_attention_save(q, k, v, bias, mask, scale)
        ctx.save_for_backward(q, k, v, bias, mask, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, mask, o, lse = ctx.saved_tensors
        dq, dk, dv, dbias = attention_core_bwd(
            q, k, v, bias, mask, do.to(q.dtype).contiguous(), ctx.scale, o,
            lse, ctx.flags)
        return dq, dk, dv, dbias.to(ctx.bias_dtype), None, None, None


def window_attention(q, k, v, bias, mask: Optional[torch.Tensor] = None,
                     scale: Optional[float] = None,
                     flags: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K10: softmax(q kᵀ·scale + bias + mask) v over windows; the plain
    version on a CPU tensor, the kernel on a CUDA tensor.  With autograd
    recording an input, through `WindowAttention` (K9 backward, which
    reads the masks of the windows `flags` names); else the forward alone
    (nothing is saved)."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if records(q, k, v, bias):
        return WindowAttention.apply(q, k, v, bias, mask, scale, flags)
    if q.device.type == "cpu":
        return window_attention_plain(q, k, v, bias, mask, scale)
    if q.dtype == torch.float32:
        return window_attention_f32(q, k, v, bias, mask, scale)
    out, _ = _launch(q, k, v, bias, mask, scale, save=False)
    window_attention.launches += 1
    return out


def window_attention_f32(q, k, v, bias, mask: Optional[torch.Tensor] = None,
                         scale: Optional[float] = None) -> torch.Tensor:
    """K10 f32: the forward alone on f32 q, k, v (csrc/window_attn_f32.cu;
    it raises on any other dtype); the plain version on a CPU tensor.  Its
    counter also counts K10 f32's save mode and strided route."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if q.device.type == "cpu":
        return window_attention_plain(q, k, v, bias, mask, scale)
    out, _ = _launch(q, k, v, bias, mask, scale, False, torch.float32)
    window_attention_f32.launches += 1
    return out


def qkv_heads(qkv: torch.Tensor, heads: int):
    """q, k, v as (B, nW, heads, N, hd) views of the qkv Linear's output
    (B, nW, N, 3C): no copy."""
    b, nw, n, c3 = qkv.shape
    return qkv.view(b, nw, n, 3, heads, c3 // (3 * heads)).permute(
        3, 0, 1, 4, 2, 5)


def window_attention_qkv_plain(qkv, bias, mask, heads: int,
                               scale: float) -> torch.Tensor:
    """The plain version of `window_attention_qkv`: K10's plain version on
    the views, O merged to (B, nW, N, C)."""
    b, nw, n, c3 = qkv.shape
    out = window_attention_plain(*qkv_heads(qkv, heads), bias, mask, scale)
    return out.transpose(2, 3).reshape(b, nw, n, c3 // 3)


def attention_qkv_grouped(qkv, bias, mask, nu: int, heads: int,
                          scale: float) -> torch.Tensor:
    """K10's kernel on the qkv Linear's output (B, nW, N, 3C) with the
    windows grouped by mask: window w of an image takes no mask for
    w < nu, else mask[w - nu] of the (nW - nu, N, N) mask (None: none is
    masked).  The kernel reads q, k, v by strides where the Linear wrote
    them and writes O as (B, nW, N, C), the layout the out-projection
    reads.  Uncounted: `window_attention_qkv` counts its K10 launches, K2p
    (`ops/fused_msa.py`, whose attention launch this is) its own calls.
    The plain version on a CPU tensor; K10 f32's kernel for f32 qkv (K2p
    f32's attention launch), K10's for bf16."""
    b, nw, n, c3 = qkv.shape
    if not 0 <= nu <= nw:
        raise ValueError(f"window attention: nu {nu} outside [0, {nw}]")
    if mask is None or nu == nw:
        mask, nu = None, nw
    if qkv.device.type == "cpu":
        if mask is not None and nu:
            mask = torch.cat([mask.new_zeros((nu,) + mask.shape[1:]), mask])
        return window_attention_qkv_plain(qkv, bias, mask, heads, scale)
    c = c3 // 3
    if c3 != 3 * heads * HEAD_DIM or not window_attn_supported(n, HEAD_DIM):
        raise ValueError(f"window attention kernel: qkv {tuple(qkv.shape)} "
                         f"with {heads} heads (hd {HEAD_DIM}, N <= {MAX_N})")
    if qkv.dtype not in (torch.bfloat16, torch.float32) \
            or not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError(f"qkv: {qkv.dtype}, contiguous "
                         f"{qkv.is_contiguous()}: expected contiguous "
                         "bfloat16 or float32, 16-byte aligned")
    _check_bias_mask(bias, mask, heads, nw - nu, n, qkv.device)
    out = torch.empty((b, nw, n, c), dtype=qkv.dtype, device=qkv.device)
    base, item = qkv.data_ptr(), qkv.element_size()
    # q, k, v at columns 0, C, 2C of each row
    _k10_call((base, base + item * c, base + 2 * item * c, out.data_ptr()),
              (n * c3, HEAD_DIM, c3), (n * c, HEAD_DIM, c), b, nw, heads, n,
              bias, mask, None, scale, qkv.device, nu,
              f32=qkv.dtype == torch.float32)
    return out


def window_attention_qkv(qkv, bias, mask, heads: int,
                         scale: float) -> torch.Tensor:
    """K10 at inference on the qkv Linear's output (B, nW, N, 3C): the
    kernel reads q, k, v by strides where the Linear wrote them and writes
    O in the (B, nW, N, C) layout the out-projection reads, so the block
    makes no layout copy; mask (nW, N, N) or None.  The plain version on a
    CPU tensor.  For the forward alone: where autograd records, the caller
    takes `window_attention` on q, k, v (K10's save mode and K9)."""
    out = attention_qkv_grouped(qkv, bias, mask, 0, heads, scale)
    if qkv.device.type != "cpu":
        counter = (window_attention_f32 if qkv.dtype == torch.float32
                   else window_attention)
        counter.launches += 1
    return out


def records(*tensors) -> bool:
    """Whether autograd records a call on these tensors."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


window_attention.launches = 0
window_attention_f32.launches = 0
attention_core_bwd.launches = 0
attention_core_bwd_f32.launches = 0
