"""Fused window MSA: qkv projection + attention + out-projection (K1/K2),
its training save mode, and its backward (K5, K6).

Counterpart of `lavt_rs_tpu/ops/pallas/fused_msa.py`:
  * `fused_window_msa` (K2): x is post-LN windowed tokens;
  * `fused_window_msa_ln` (K1): x is pre-LN tokens and the block's
    pre-attention LayerNorm (f32 stats, fast variance) runs inside the
    kernel.  Valid only where windowing needed no padding: the model pads
    after LN, and LN of a zero pad row would give ln_bias;
  * `fused_window_msa_save` (K1/K2 in save mode, `_fwd(..., save=True)`):
    the forward that also returns the training residuals q (post-scale),
    k, v (bf16, (B nW, N, C), lanes in head order), the bf16
    probabilities p (B nW, heads, N, N) and, with LN, the bf16 xn;
  * `fused_window_msa_bwd` (K5, `_fused_bwd_group_resid`): every gradient
    from those residuals;
  * `fused_window_msa_bwd_recompute` (K6, `_fused_bwd_group`): the same
    gradients with nothing saved: the save-mode forward into per-call
    scratch, then K5;
  * `FusedWindowMSA`, the autograd Function the model trains through.
    Its forward saves the residuals when `save_residuals_ok` holds (the
    TPU rule: p and qkv under 192 MiB per block) and routes the backward
    to K5, else to K6.  The LN variant's backward is K5/K6 on xn followed
    by the plain LN backward (`_vjp_ln_bwd`);
  * `fused_window_msa_grouped` (K2p: K2's `_fwd_call` at a token count
    padded to 16, n_p = 400 for video windows of 392): x is (B, nW, n_p, C)
    with the first `nu` windows of each image maskless and the rest under
    a small (nW - nu, n_p, n_p) mask, the bias padded by
    `pad_bias_sublane`; the grouped 3D route of `models/swin3d.py` and
    `fused_window_msa_padded` (which pads an unpadded x) reach it.

x is (B, nW, N, C) windowed tokens; weights are torch `nn.Linear` layout:
wqkv (3C, C), bqkv (3C,), wproj (C, C), bproj (C,); bias (h, N, N) f32
relative-position bias; mask (nW, N, N) f32 shift mask or None.  q is
scaled after its bias; q, k, v, the probabilities and the attention
output are rounded to x's dtype, as in the TPU kernel.  The softmax is
the exact max-subtracted one (the TPU inference kernel's exp(min(s, 80))
equals it while every logit is below 80).

Each wrapper takes the plain version for a CPU tensor and launches the
CUDA kernels (csrc/fused_msa.cu: attention; csrc/window_attn.cu: K2p's
attention; csrc/fused_msa_bwd.cu: the out-projection GEMM and the
backward) for a CUDA tensor; the plain
versions compute in f32 with the kernels' rounding points.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from . import cuda_lib
from .ln import layer_norm_rows_bwd_plain
from .ln import layer_norm_rows_plain as layer_norm_f32

LN_EPS = 1e-5
# the TPU rule (`_save_residuals_ok`): save p and qkv for the backward
# while neither exceeds this many bytes per block
RESID_CAP_BYTES = 192 * 1024 * 1024
# blocks in flight that the backward's launches aim for (132 SMs, two
# waves)
_TARGET_BLOCKS = 264


def save_residuals_ok(b: int, nw: int, n: int, c: int, heads: int,
                      itemsize: int = 2) -> bool:
    """Whether the training forward saves (q, k, v, p) for K5, or the
    backward recomputes them (K6)."""
    p_bytes = b * nw * heads * n * n * itemsize
    qkv_bytes = 3 * b * nw * n * c * itemsize
    return max(p_bytes, qkv_bytes) <= RESID_CAP_BYTES


# -- routing: the JAX package's policy, ported ---------------------------------
# The arithmetic of `lavt_rs_tpu/ops/pallas/fused_msa.py` (`_sublane_ok`,
# `_pick_fwd_groups`, `_pick_chunk_bwd`, `_pick_head_groups`,
# `fused_msa_routed`, `fused3d_grouped_routed`), copied so that the port
# takes the fused kernels exactly where the JAX package takes its Pallas
# ones.  The budgets are the TPU's VMEM sizes; they decide the route, not
# what the CUDA kernels could take.  The JAX package's LAVT_* environment
# hatches are not ported: each predicate is the JAX default policy.

_MIB = 1024 * 1024


def _sublane_ok(n: int, itemsize: int) -> bool:
    return n % (16 if itemsize == 2 else 8) == 0


def _sublane_pad(n: int, itemsize: int) -> int:
    pack = 16 if itemsize == 2 else 8
    return -(-n // pack) * pack


def _pick_fwd_groups(nw: int, n: int, c: int, heads: int,
                     itemsize: int) -> Optional[int]:
    """Head-group count of the JAX fused forward, or None when no split
    fits 12 MiB of VMEM (nw does not enter; kept for the JAX signature)."""
    hd = c // heads
    for g in (1, 2, 4, 8):
        if heads % g or (g > 1 and ((heads // g) * hd) % 32):
            continue
        cq = (heads // g) * hd
        weights = (3 * c * cq + cq * c) * itemsize
        bias = (heads // g) * n * n * 4
        ch1 = (n * c * itemsize + 3 * n * cq * 4 + n * n * 4 + n * c * 4
               + n * n * 4)
        if weights + bias + 2 * ch1 <= 12 * _MIB:
            return g
    return None


def _pick_chunk_bwd(nw: int, n: int, c: int, cq: int, heads: int,
                    itemsize: int, budget: int) -> int:
    """The JAX backward's window chunk under `budget` (0: none fits)."""
    fixed = ((3 * c * cq + cq * c) * itemsize + (3 * c * cq + cq * c) * 4
             + 2 * heads * n * n * 4)
    best = 0
    for ch in range(1, nw + 1):
        if nw % ch or not (ch == 1 or _sublane_ok(n, itemsize)):
            continue
        buf = (ch * n * c * itemsize * 2 + ch * n * c * 4 + ch * n * cq * 4
               + 3 * ch * n * cq * 4
               + (4 * ch * n * cq * itemsize if c >= 256 else 0)
               + ch * n * c * 4 + 4 * ch * n * n * 4 + ch * n * n * 4)
        if fixed + buf <= budget:
            best = ch
    return best


def fused_msa_bwd_supported(nw: int, n: int, c: int, heads: int,
                            itemsize: int = 2) -> bool:
    """Whether the JAX fused backward fits some head split and chunk
    (`_pick_head_groups` is not None)."""
    for budget in (10 * _MIB, int(13.5 * _MIB)):
        for g in (1, 2, 4, 8):
            if heads % g or (g > 1 and ((heads // g) * (c // heads)) % 32):
                continue
            cq = (heads // g) * (c // heads)
            if _pick_chunk_bwd(nw, n, c, cq, heads // g, itemsize,
                               budget) >= 1:
                return True
    return False


@functools.lru_cache(maxsize=None)
def fused_msa_routed(nw: int, n: int, c: int, heads: int,
                     itemsize: int = 2) -> bool:
    """The JAX routing policy of the fused window MSA (K1/K2/K11, and in
    training the save mode with K5/K6): sublane-aligned windows (window 12,
    N = 144) whose head groups fit.  Window 7 (N = 49) is not routed: the
    JAX package runs qkv -> the attention-core kernel (K10) -> proj."""
    return (_sublane_ok(n, itemsize)
            and _pick_fwd_groups(nw, n, c, heads, itemsize) is not None)


@functools.lru_cache(maxsize=None)
def fused3d_grouped_routed(nw: int, n: int, c: int, heads: int,
                           itemsize: int = 2) -> bool:
    """The JAX routing policy of the grouped padded 3D route (K2p): the
    measured default width (LAVT_FUSED3D=96: C = 96, the first stage of
    Video Swin-T/S), a sublane padding tax of at most 10 %, and head
    groups that fit forward and backward.  Window (8, 12, 12) (N = 1152)
    is not routed."""
    if c != 96:
        return False
    n_p = _sublane_pad(n, itemsize)
    if (n_p / n) ** 2 > 1.10:
        return False
    return (_pick_fwd_groups(nw, n_p, c, heads, itemsize) is not None
            and fused_msa_bwd_supported(nw, n_p, c, heads, itemsize))


# -- plain versions (f32 math, the kernels' rounding points) ---------------

def fused_window_msa_save_plain(x, ln, wqkv, bqkv, wproj, bproj, bias, mask,
                                heads: int, scale: float,
                                ln_eps: float = LN_EPS):
    """The plain save-mode forward: (y, (q, k, v, p, xn)); xn is None
    without ln.  q/k/v are (B nW, N, C), p (B nW, heads, N, N)."""
    b, nw, n, c = x.shape
    hd = c // heads
    dt = x.dtype
    xn = None
    if ln is not None:
        x = xn = layer_norm_f32(x, ln[0], ln[1], ln_eps)
    qkv = x.float() @ wqkv.float().t() + bqkv.float()
    q = (qkv[..., :c] * scale).to(dt).reshape(b * nw, n, c)
    k = qkv[..., c:2 * c].to(dt).reshape(b * nw, n, c)
    v = qkv[..., 2 * c:].to(dt).reshape(b * nw, n, c)

    def heads_of(t):
        return t.float().view(b * nw, n, heads, hd).transpose(1, 2)

    s = heads_of(q) @ heads_of(k).transpose(-1, -2) + bias.float()
    if mask is not None:
        s = (s.view(b, nw, heads, n, n)
             + mask.float()[None, :, None]).view(b * nw, heads, n, n)
    p = torch.softmax(s, dim=-1).to(dt)
    o = (p.float() @ heads_of(v)).to(dt).transpose(1, 2).reshape(b, nw, n, c)
    y = (o.float() @ wproj.float().t() + bproj.float()).to(dt)
    if xn is not None:
        xn = xn.reshape(b * nw, n, c)
    return y, (q, k, v, p, xn)


def fused_window_msa_plain(x, wqkv, bqkv, wproj, bproj, bias, mask,
                           heads: int, scale: float) -> torch.Tensor:
    """The plain PyTorch version of K2 (f32 math)."""
    return fused_window_msa_save_plain(x, None, wqkv, bqkv, wproj, bproj,
                                       bias, mask, heads, scale)[0]


def fused_window_msa_ln_plain(x, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj,
                              bias, mask, heads: int, scale: float,
                              ln_eps: float = LN_EPS) -> torch.Tensor:
    """The plain PyTorch version of K1."""
    return fused_window_msa_save_plain(x, (ln_scale, ln_bias), wqkv, bqkv,
                                       wproj, bproj, bias, mask, heads, scale,
                                       ln_eps)[0]


def fused_window_msa_bwd_plain(x, gy, wqkv, wproj, saved, heads: int,
                               scale: float):
    """The plain version of K5.  x: the MSA's input (post-LN), gy the
    output gradient, both (B, nW, N, C); saved = (q, k, v, p) of the
    save-mode forward.  Returns (dx in x's dtype, dwqkv, dbqkv, dwproj,
    dbproj, dbias), the weight grads in f32 and torch layout."""
    b, nw, n, c = x.shape
    hd = c // heads
    dt = x.dtype
    q, k, v, p = saved
    rows = b * nw * n
    xf = x.reshape(rows, c).float()
    gyf = gy.reshape(rows, c).float()

    def heads_of(t):  # (rows, C) -> (B nW, heads, N, hd) f32
        return t.float().view(b * nw, n, heads, hd).transpose(1, 2)

    def merge(t):  # (B nW, heads, N, hd) -> (rows, C)
        return t.transpose(1, 2).reshape(rows, c)

    do = heads_of((gyf.to(dt).float() @ wproj.float()).to(dt))
    qh, kh, vh = heads_of(q), heads_of(k), heads_of(v)
    pf = p.float()
    o = merge((pf @ vh).to(dt))
    dv = pf.transpose(-1, -2) @ do
    dp = do @ vh.transpose(-1, -2)
    ds = pf * (dp - (dp * pf).sum(-1, keepdim=True))
    dbias = ds.sum(0)
    dsc = ds.to(dt).float()
    dq = (dsc @ kh) * scale
    dk = dsc.transpose(-1, -2) @ qh
    dqkv = torch.cat([merge(dq), merge(dk), merge(dv)], dim=-1)
    dbqkv = dqkv.sum(0)
    dqkv_c = dqkv.to(dt).float()
    dx = (dqkv_c @ wqkv.float()).to(dt).view(b, nw, n, c)
    dwqkv = dqkv_c.t() @ xf
    dwproj = gyf.t() @ o.float()
    return dx, dwqkv, dbqkv, dwproj, gyf.sum(0), dbias


def fused_window_msa_bwd_recompute_plain(x, ln, wqkv, bqkv, wproj, bproj,
                                         bias, mask, gy, heads: int,
                                         scale: float, ln_eps: float = LN_EPS):
    """The plain version of K6: the save-mode forward, then K5; the
    gradients are with respect to the MSA's input (xn with ln)."""
    _, (q, k, v, p, xn) = fused_window_msa_save_plain(
        x, ln, wqkv, bqkv, wproj, bproj, bias, mask, heads, scale, ln_eps)
    xin = x if xn is None else xn.view(x.shape)
    return fused_window_msa_bwd_plain(xin, gy, wqkv, wproj, (q, k, v, p),
                                      heads, scale)


# -- CUDA launches -----------------------------------------------------------

def fused_msa_supported(n: int, c: int, heads: int) -> bool:
    """Geometries the CUDA kernel takes: window 12 (N = 144), head dim 32
    (so C = 32 heads; x streams through the kernel in 64-column chunks with
    a 32-column tail)."""
    return n == 144 and heads > 0 and c == 32 * heads


def _require_all(checks, dev) -> None:
    for name, t, dt, shape in checks:
        cuda_lib.require(t, name, dt, dev, shape)
        if t.data_ptr() % 16:  # the kernels move 16-byte words
            raise ValueError(f"{name}: data must be 16-byte aligned")


def _check_geometry(x, heads) -> None:
    n, c = x.shape[-2:]
    if not fused_msa_supported(n, c, heads):
        raise ValueError(f"fused window MSA kernel: unsupported (N, C, heads) "
                         f"{(n, c, heads)}")


def _attn_launch(x, ln, wqkv, bqkv, bias, mask, heads, scale, eps,
                 save: bool):
    """The attention kernel: the bf16 attention output (B nW N, C) and, in
    save mode, the residuals (q, k, v, p, xn)."""
    b, nw, n, c = x.shape
    _check_geometry(x, heads)
    dev = x.device
    bf16 = torch.bfloat16
    checks = [("x", x, bf16, None), ("wqkv", wqkv, bf16, (3 * c, c)),
              ("bqkv", bqkv, bf16, (3 * c,)),
              ("bias", bias, torch.float32, (heads, n, n))]
    if mask is not None:
        checks.append(("mask", mask, torch.float32, (nw, n, n)))
    if ln is not None:
        checks += [("ln_scale", ln[0], bf16, (c,)),
                   ("ln_bias", ln[1], bf16, (c,))]
    _require_all(checks, dev)
    m = b * nw
    o = torch.empty((m, n, c), dtype=bf16, device=dev)
    saved = None
    if save:
        q, k, v = (torch.empty((m, n, c), dtype=bf16, device=dev)
                   for _ in range(3))
        p = torch.empty((m, heads, n, n), dtype=bf16, device=dev)
        xn = (torch.empty((m, n, c), dtype=bf16, device=dev)
              if ln is not None else None)
        saved = (q, k, v, p, xn)

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = cuda_lib.lib().lavt_window_msa_attn(
        x.data_ptr(), ptr(ln[0] if ln else None), ptr(ln[1] if ln else None),
        wqkv.data_ptr(), bqkv.data_ptr(), bias.data_ptr(), ptr(mask),
        o.data_ptr(), *(ptr(t) for t in (saved or (None,) * 5)), m, nw, c,
        heads, float(scale), float(eps), cuda_lib.stream_ptr(dev))
    cuda_lib.check(err, "lavt_window_msa_attn")
    return o, saved


def _proj_launch(o, wproj, bproj, shape) -> torch.Tensor:
    c = wproj.shape[0]
    _require_all([("wproj", wproj, torch.bfloat16, (c, c)),
                  ("bproj", bproj, torch.bfloat16, (c,))], o.device)
    return gemm(o, wproj, o.numel() // c, c, c, False, True, torch.bfloat16,
                bias=bproj).view(shape)


def _launch(x, ln, wqkv, bqkv, wproj, bproj, bias, mask, heads, scale, eps,
            save: bool = False):
    o, saved = _attn_launch(x, ln, wqkv, bqkv, bias, mask, heads, scale, eps,
                            save)
    y = _proj_launch(o, wproj, bproj, x.shape)
    return (y, saved) if save else y


def gemm(a, b, m: int, n: int, k: int, a_kmajor: bool, b_nmajor: bool,
         out_dtype=torch.float32, bias=None) -> torch.Tensor:
    """(m, n) = A (m, k) B (k, n) on the hand-written WMMA GEMM of
    csrc/fused_msa_bwd.cu.  A is given as (k, m) when a_kmajor, B as
    (n, k) when b_nmajor (a torch Linear weight); bf16 in, f32 sums.  A
    bf16 result is one pass, plus the (n,) bf16 bias when given; an f32
    result is split over k across blocks when the tile grid is small, then
    the f32 partials are added in order (deterministic)."""
    dev = a.device
    lib = cuda_lib.lib()
    stream = cuda_lib.stream_ptr(dev)
    lda = m if a_kmajor else k
    ldb = k if b_nmajor else n
    splits, k_chunk = 1, k
    if out_dtype == torch.float32:
        tiles = -(-m // 64) * -(-n // 64)
        splits = max(1, min(-(-_TARGET_BLOCKS // tiles), k // 512))
        per_split = -(-k // splits)
        k_chunk = -(-per_split // 32) * 32
        splits = -(-k // k_chunk)
    if out_dtype == torch.bfloat16:
        out = torch.empty((m, n), dtype=out_dtype, device=dev)
        err = lib.lavt_gemm_bf16(a.data_ptr(), b.data_ptr(),
                                 None if bias is None else bias.data_ptr(),
                                 None, out.data_ptr(), m, n, k, lda, ldb,
                                 int(a_kmajor), int(b_nmajor), 1, k, stream)
        cuda_lib.check(err, "lavt_gemm_bf16")
        return out
    part = torch.empty((splits, m, n), dtype=torch.float32, device=dev)
    err = lib.lavt_gemm_bf16(a.data_ptr(), b.data_ptr(), None,
                             part.data_ptr(), None, m, n, k, lda, ldb,
                             int(a_kmajor), int(b_nmajor), splits, k_chunk,
                             stream)
    cuda_lib.check(err, "lavt_gemm_bf16")
    return sum_partials(part)


def sum_partials(part: torch.Tensor) -> torch.Tensor:
    """(S, ...) f32 partials -> (...) summed over S in order, on the
    kernel of csrc/fused_msa_bwd.cu."""
    if part.shape[0] == 1:
        return part[0]
    out = torch.empty(part.shape[1:], dtype=torch.float32, device=part.device)
    err = cuda_lib.lib().lavt_sum_partials(
        part.data_ptr(), out.data_ptr(), part.shape[0], out.numel(),
        cuda_lib.stream_ptr(part.device))
    cuda_lib.check(err, "lavt_sum_partials")
    return out


def colsum(x2: torch.Tensor, keep: Optional[torch.Tensor] = None,
           rows_per_sample: int = 1) -> torch.Tensor:
    """f32 column sums of a bf16 (rows, cols) tensor, each row scaled by
    keep[row // rows_per_sample] when keep is given, on the kernel of
    csrc/fused_msa_bwd.cu (row splits, then their partials in order)."""
    rows, cols = x2.shape
    splits = max(1, min(_TARGET_BLOCKS, rows // 256))
    part = torch.empty((splits, cols), dtype=torch.float32, device=x2.device)
    err = cuda_lib.lib().lavt_colsum_bf16(
        x2.data_ptr(), None if keep is None else keep.data_ptr(),
        part.data_ptr(), rows, cols, splits, max(rows_per_sample, 1),
        cuda_lib.stream_ptr(x2.device))
    cuda_lib.check(err, "lavt_colsum_bf16")
    return sum_partials(part)


def _bwd_launch(x, gy, wqkv, wproj, saved, heads, scale):
    """K5's launches (see csrc/fused_msa_bwd.cu)."""
    b, nw, n, c = x.shape
    _check_geometry(x, heads)
    q, k, v, p = saved
    m = b * nw
    rows = m * n
    dev = x.device
    bf16 = torch.bfloat16
    _require_all([("x", x, bf16, None), ("gy", gy, bf16, (b, nw, n, c)),
                  ("wqkv", wqkv, bf16, (3 * c, c)),
                  ("wproj", wproj, bf16, (c, c)),
                  ("q", q, bf16, (m, n, c)), ("k", k, bf16, (m, n, c)),
                  ("v", v, bf16, (m, n, c)),
                  ("p", p, bf16, (m, heads, n, n))], dev)
    x2, g2 = x.reshape(rows, c), gy.reshape(rows, c)
    dattn = gemm(g2, wproj, rows, c, c, False, False, bf16)
    groups = min(m, -(-_TARGET_BLOCKS // heads))
    o = torch.empty((rows, c), dtype=bf16, device=dev)
    dqkv = torch.empty((rows, 3 * c), dtype=bf16, device=dev)
    dbias_part = torch.empty((groups, heads, n, n), dtype=torch.float32,
                             device=dev)
    dbqkv_part = torch.empty((groups, 3 * c), dtype=torch.float32, device=dev)
    err = cuda_lib.lib().lavt_msa_bwd_attn(
        dattn.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        p.data_ptr(), o.data_ptr(), dqkv.data_ptr(), dbias_part.data_ptr(),
        dbqkv_part.data_ptr(), m, c, heads, groups, float(scale),
        cuda_lib.stream_ptr(dev))
    cuda_lib.check(err, "lavt_msa_bwd_attn")
    dx = gemm(dqkv, wqkv, rows, c, 3 * c, False, False, bf16)
    dwqkv = gemm(dqkv, x2, 3 * c, c, rows, True, False)
    dwproj = gemm(g2, o, c, c, rows, True, False)
    return (dx.view(b, nw, n, c), dwqkv, sum_partials(dbqkv_part), dwproj,
            colsum(g2), sum_partials(dbias_part))


# -- wrappers: plain version on a CPU tensor, the kernel on a CUDA tensor ----

def fused_window_msa(x, wqkv, bqkv, wproj, bproj, bias,
                     mask: Optional[torch.Tensor], heads: int,
                     scale: float) -> torch.Tensor:
    """K2: (B, nW, N, C) post-LN windowed tokens -> projected attention."""
    if x.device.type == "cpu":
        return fused_window_msa_plain(x, wqkv, bqkv, wproj, bproj, bias, mask,
                                      heads, scale)
    y = _launch(x, None, wqkv, bqkv, wproj, bproj, bias, mask, heads, scale,
                LN_EPS)
    fused_window_msa.launches += 1
    return y


def fused_window_msa_ln(x, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj, bias,
                        mask: Optional[torch.Tensor], heads: int, scale: float,
                        ln_eps: float = LN_EPS) -> torch.Tensor:
    """K1: (B, nW, N, C) PRE-LN windowed tokens -> projected attention."""
    if x.device.type == "cpu":
        return fused_window_msa_ln_plain(x, ln_scale, ln_bias, wqkv, bqkv,
                                         wproj, bproj, bias, mask, heads,
                                         scale, ln_eps)
    y = _launch(x, (ln_scale, ln_bias), wqkv, bqkv, wproj, bproj, bias, mask,
                heads, scale, ln_eps)
    fused_window_msa_ln.launches += 1
    return y


def fused_window_msa_save(x, ln, wqkv, bqkv, wproj, bproj, bias, mask,
                          heads: int, scale: float, ln_eps: float = LN_EPS):
    """K1 (ln given) / K2 in save mode: (y, (q, k, v, p, xn))."""
    if x.device.type == "cpu":
        return fused_window_msa_save_plain(x, ln, wqkv, bqkv, wproj, bproj,
                                           bias, mask, heads, scale, ln_eps)
    out = _launch(x, ln, wqkv, bqkv, wproj, bproj, bias, mask, heads, scale,
                  ln_eps, save=True)
    counter = fused_window_msa if ln is None else fused_window_msa_ln
    counter.launches += 1
    return out


def fused_window_msa_bwd(x, gy, wqkv, wproj, saved, heads: int,
                         scale: float):
    """K5: gradients from the save-mode residuals (q, k, v, p); x is the
    MSA's input (xn for the LN variant)."""
    if x.device.type == "cpu":
        return fused_window_msa_bwd_plain(x, gy, wqkv, wproj, saved, heads,
                                          scale)
    out = _bwd_launch(x, gy, wqkv, wproj, saved, heads, scale)
    fused_window_msa_bwd.launches += 1
    return out


def fused_window_msa_bwd_recompute(x, ln, wqkv, bqkv, wproj, bproj, bias,
                                   mask, gy, heads: int, scale: float,
                                   ln_eps: float = LN_EPS):
    """K6: the same gradients as K5 with nothing saved; they are with
    respect to the MSA's input (xn with ln)."""
    if x.device.type == "cpu":
        return fused_window_msa_bwd_recompute_plain(
            x, ln, wqkv, bqkv, wproj, bproj, bias, mask, gy, heads, scale,
            ln_eps)
    _, (q, k, v, p, xn) = _attn_launch(x, ln, wqkv, bqkv, bias, mask, heads,
                                       scale, ln_eps, save=True)
    xin = x if xn is None else xn.view(x.shape)
    out = _bwd_launch(xin, gy, wqkv, wproj, (q, k, v, p), heads, scale)
    fused_window_msa_bwd_recompute.launches += 1
    return out


fused_window_msa.launches = 0
fused_window_msa_ln.launches = 0
fused_window_msa_bwd.launches = 0
fused_window_msa_bwd_recompute.launches = 0


# -- K2p: windows padded to 16 tokens, grouped by mask --------------------------

PAD_KEY_BIAS = -1e9  # kills a padded key: exp underflows to exactly 0 in f32


TOKEN_TILE = 16  # K2p's row tile; its token count is padded to a multiple


def pad_tokens(n: int) -> int:
    """Token count padded to K2p's 16-row tile (392 -> 400; the JAX
    package's `_sublane_pad` for bf16)."""
    return -(-n // TOKEN_TILE) * TOKEN_TILE


def pad_bias_sublane(bias: torch.Tensor, n_p: int) -> torch.Tensor:
    """(h, N, N) bias -> (h, n_p, n_p) f32, zero on the padded query rows
    and -1e9 on the padded key columns."""
    heads, n, _ = bias.shape
    if n_p == n:
        return bias
    out = bias.new_zeros((heads, n_p, n_p), dtype=torch.float32)
    out[:, :n, :n] = bias
    out[:, :, n:] = PAD_KEY_BIAS
    return out


def padded_msa_supported(n_p: int, c: int, heads: int) -> bool:
    """Geometries K2p's kernel takes: n_p a multiple of 16 up to 400, head
    dim 32 (C = 32 heads)."""
    return (heads > 0 and c == 32 * heads and n_p % TOKEN_TILE == 0
            and TOKEN_TILE <= n_p <= 400)


def fused_window_msa_grouped_plain(x, wqkv, bqkv, wproj, bproj, bias, mask,
                                   nu: int, heads: int, scale: float):
    """The plain version of K2p: K2's plain version on the maskless prefix
    and on the masked rest."""
    nw = x.shape[1]
    if mask is None or nu >= nw:
        return fused_window_msa_plain(x, wqkv, bqkv, wproj, bproj, bias, None,
                                      heads, scale)
    parts = [fused_window_msa_plain(x[:, nu:], wqkv, bqkv, wproj, bproj, bias,
                                    mask, heads, scale)]
    if nu > 0:
        parts.insert(0, fused_window_msa_plain(x[:, :nu], wqkv, bqkv, wproj,
                                               bproj, bias, None, heads,
                                               scale))
    return torch.cat(parts, dim=1)


def _grouped_launch(x, wqkv, bqkv, wproj, bproj, bias, mask, nu, heads,
                    scale):
    b, nw, n_p, c = x.shape
    if not padded_msa_supported(n_p, c, heads):
        raise ValueError(f"padded window MSA kernel: unsupported (n_p, C, "
                         f"heads) {(n_p, c, heads)}")
    if mask is None:
        nu = nw
    if not 0 <= nu <= nw:
        raise ValueError(f"padded window MSA kernel: nu {nu} outside [0, {nw}]")
    bf16 = torch.bfloat16
    checks = [("x", x, bf16, None), ("wqkv", wqkv, bf16, (3 * c, c)),
              ("bqkv", bqkv, bf16, (3 * c,)),
              ("bias", bias, torch.float32, (heads, n_p, n_p))]
    if mask is not None:
        checks.append(("mask", mask, torch.float32, (nw - nu, n_p, n_p)))
    _require_all(checks, x.device)
    o = torch.empty((b * nw, n_p, c), dtype=bf16, device=x.device)
    err = cuda_lib.lib().lavt_window_msa_np(
        x.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(), bias.data_ptr(),
        None if mask is None else mask.data_ptr(), o.data_ptr(), b * nw, nw,
        nu, c, heads, n_p, float(scale), cuda_lib.stream_ptr(x.device))
    cuda_lib.check(err, "lavt_window_msa_np")
    return _proj_launch(o, wproj, bproj, x.shape)


def fused_window_msa_grouped(x, wqkv, bqkv, wproj, bproj, bias,
                             mask: Optional[torch.Tensor], nu: int,
                             heads: int, scale: float) -> torch.Tensor:
    """K2p: (B, nW, n_p, C) padded post-LN windowed tokens ->
    projected attention.  bias: (h, n_p, n_p) from `pad_bias_sublane`;
    windows [0, nu) of each image take no mask, window w >= nu takes
    mask[w - nu] of the (nW - nu, n_p, n_p) mask (None: no window is
    masked).  One kernel launch covers both groups."""
    if x.device.type == "cpu":
        return fused_window_msa_grouped_plain(x, wqkv, bqkv, wproj, bproj,
                                              bias, mask, nu, heads, scale)
    y = _grouped_launch(x, wqkv, bqkv, wproj, bproj, bias, mask, nu, heads,
                        scale)
    fused_window_msa_grouped.launches += 1
    return y


fused_window_msa_grouped.launches = 0


def fused_window_msa_padded(x, wqkv, bqkv, wproj, bproj, bias,
                            mask: Optional[torch.Tensor], heads: int,
                            scale: float) -> torch.Tensor:
    """K2 for a window size that is not a multiple of 16 (JAX
    `fused_window_msa_padded`): x (B, nW, N, C), bias (h, N, N), mask
    (nW, N, N) or None.  Tokens are zero-padded to `pad_tokens(N)`, the
    padded keys are killed by the bias, the padded query rows are dropped;
    the call is K2p with no maskless prefix.  No path of the port calls it
    (the video route pads in its partition gather); it is kept for parity
    with the JAX package's API."""
    b, nw, n, c = x.shape
    n_p = pad_tokens(n)
    p = n_p - n
    x_p = torch.nn.functional.pad(x, (0, 0, 0, p)) if p else x
    mask_p = None
    if mask is not None:
        mask_p = torch.nn.functional.pad(mask, (0, p, 0, p)) if p else mask
    y = fused_window_msa_grouped(x_p.contiguous(), wqkv, bqkv, wproj, bproj,
                                 pad_bias_sublane(bias, n_p), mask_p,
                                 0 if mask is not None else nw, heads, scale)
    return y[:, :, :n]


# -- training ----------------------------------------------------------------

class FusedWindowMSA(torch.autograd.Function):
    """K1 (ln_scale given) / K2 with the K5/K6 backward.  Takes the f32
    master weights, runs the kernels on x's dtype (bf16 on the card) and
    returns the weight grads in the weights' dtype; the mask gets none."""

    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj, bias,
                mask, heads: int, scale: float, ln_eps: float = LN_EPS):
        dt = x.dtype
        ln = None if ln_scale is None else (ln_scale.to(dt), ln_bias.to(dt))
        w = (wqkv.to(dt), bqkv.to(dt), wproj.to(dt), bproj.to(dt))
        b, nw, n, c = x.shape
        ctx.heads, ctx.scale, ctx.ln_eps = heads, scale, ln_eps
        ctx.has_ln = ln is not None
        ctx.dtypes = (wqkv.dtype, bqkv.dtype, wproj.dtype, bproj.dtype,
                      bias.dtype)
        ctx.resid = save_residuals_ok(b, nw, n, c, heads, x.element_size())
        if ctx.resid:
            y, (q, k, v, p, xn) = fused_window_msa_save(
                x, ln, *w, bias, mask, heads, scale, ln_eps)
            ctx.save_for_backward(x, ln_scale, w[0], w[2], q, k, v, p, xn)
        else:
            if ln is None:
                y = fused_window_msa(x, *w, bias, mask, heads, scale)
            else:
                y = fused_window_msa_ln(x, *ln, *w, bias, mask, heads, scale,
                                        ln_eps)
            ctx.save_for_backward(x, ln_scale, *(ln or (None, None)), *w,
                                  bias, mask)
        return y

    @staticmethod
    def backward(ctx, gy):
        gy = gy.contiguous()
        heads, scale, eps = ctx.heads, ctx.scale, ctx.ln_eps
        if ctx.resid:
            x, ln_scale, wqkv, wproj, q, k, v, p, xn = ctx.saved_tensors
            xin = x if xn is None else xn.view(x.shape)
            grads = fused_window_msa_bwd(xin, gy, wqkv, wproj, (q, k, v, p),
                                         heads, scale)
        else:
            (x, ln_scale, lns, lnb, wqkv, bqkv, wproj, bproj, bias,
             mask) = ctx.saved_tensors
            ln = (lns, lnb) if ctx.has_ln else None
            grads = fused_window_msa_bwd_recompute(
                x, ln, wqkv, bqkv, wproj, bproj, bias, mask, gy, heads, scale,
                eps)
        dx, dwqkv, dbqkv, dwproj, dbproj, dbias = grads
        dls = dlb = None
        if ctx.has_ln:
            dx, dls, dlb = layer_norm_rows_bwd_plain(x, ln_scale, dx, eps)
            dls, dlb = dls.to(ln_scale.dtype), dlb.to(ln_scale.dtype)
        wq_t, bq_t, wp_t, bp_t, bias_t = ctx.dtypes
        return (dx, dls, dlb, dwqkv.to(wq_t), dbqkv.to(bq_t), dwproj.to(wp_t),
                dbproj.to(bp_t), dbias.to(bias_t), None, None, None, None)


def window_msa(x, ln, wqkv, bqkv, wproj, bproj, bias, mask, heads: int,
               scale: float, ln_eps: float = LN_EPS) -> torch.Tensor:
    """The model's entry: K1 (ln = (scale, bias)) or K2 on x's dtype.  With
    autograd recording a parameter, through `FusedWindowMSA`; else the
    forward kernel alone (nothing is saved)."""
    tensors = (x, wqkv, bqkv, wproj, bproj, bias) + tuple(ln or ())
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        ln_s, ln_b = ln if ln is not None else (None, None)
        return FusedWindowMSA.apply(x, ln_s, ln_b, wqkv, bqkv, wproj, bproj,
                                    bias, mask, heads, scale, ln_eps)
    dt = x.dtype
    w = (wqkv.to(dt), bqkv.to(dt), wproj.to(dt), bproj.to(dt))
    if ln is None:
        return fused_window_msa(x, *w, bias, mask, heads, scale)
    return fused_window_msa_ln(x, ln[0].to(dt), ln[1].to(dt), *w, bias, mask,
                               heads, scale, ln_eps)
