"""Fused window MSA: qkv projection + attention + out-projection (K1/K2),
its training save mode, and its backward (K5, K6).

Counterpart of `lavt_rs_tpu/ops/pallas/fused_msa.py`:
  * `fused_window_msa` (K2): x is post-LN windowed tokens;
  * `fused_window_msa_ln` (K1): x is pre-LN tokens and the block's
    pre-attention LayerNorm (f32 stats, fast variance) runs first, as its
    own launch.  Valid only where windowing needed no padding: the model
    pads after LN, and LN of a zero pad row would give ln_bias;
  * `fused_window_msa_save` (K1/K2 in save mode, `_fwd(..., save=True)`):
    the forward that also returns the training residuals q (post-scale),
    k, v (bf16, (B nW, N, C), lanes in head order; on the card the column
    views of the one (B nW, N, 3C) qkv tensor), the bf16 probabilities p
    (B nW, heads, N, N) and, with LN, the bf16 xn;
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
    padded to the sublane tile of x's dtype, 16 in bf16 and 8 in f32:
    n_p = 400 or 392 for video windows of 392): x is (B, nW, n_p, C)
    with the first `nu` windows of each image maskless and the rest under
    a small (nW - nu, n_p, n_p) mask, the bias padded by
    `pad_bias_sublane`; the grouped 3D route of `models/swin3d.py` and
    `fused_window_msa_padded` (which pads an unpadded x) reach it.

x is (B, nW, N, C) windowed tokens; weights are torch `nn.Linear` layout:
wqkv (3C, C), bqkv (3C,), wproj (C, C), bproj (C,); bias (h, N, N) f32
relative-position bias; mask (nW, N, N) f32 shift mask or None.  q is
scaled after its bias; q, k, v, the probabilities and the attention
output are rounded to x's dtype, as in the TPU kernel.  The bf16 kernels'
softmax is the exact max-subtracted one (the TPU inference kernel's
exp(min(s, 80)) equals it while every logit is below 80).

Each wrapper takes the plain version for a CPU tensor and launches the
CUDA kernels for a CUDA tensor: K1, K2, the save mode and K6's forward as
the launches of `save_launches` (K4's LN rows for K1, the qkv projection
on the wgmma + TMA GEMM core of csrc/window_msa_sm90.cu, the attention of
csrc/fused_msa_sm90.cu, the out-projection on the core); K5 on
csrc/fused_msa_bwd_sm90.cu, its launches `bwd_launches` (the fixed-order
sums on csrc/fused_msa_bwd.cu); K2p as csrc/window_msa_sm90.cu's
projections around K10's attention kernel.  The plain versions compute in
f32 with the kernels' rounding points.

The f32 variants are the same launches on f32 activations, as the TPU
kernels compute them there (their roundings to x.dtype are no-ops), each
entry point with its own launch counter and taken by the bf16 one for a
CUDA f32 tensor (no f32 tensor reaches a bf16 kernel):
  * K1 f32 (`fused_window_msa_ln_f32`), K2 f32 (`fused_window_msa_f32`) and
    the K1/K2 save mode f32 (`fused_window_msa_save_f32`): `save_launches`
    on K4 f32's LN rows, `gemm_bias` on the 3xTF32 GEMM of
    csrc/gemm_f32.cu and the attention of csrc/fused_msa_f32.cu, which
    writes the f32 P in save mode.  Its softmax is the TPU inference
    kernel's shift-free exp(min(s, 80)) where K1 f32 and K2 f32 are called
    for inference, and the exact max-subtracted one in the save mode and
    in the taped forward of a block that saves nothing (`FusedWindowMSA`,
    as JAX's `_vjp_fwd` / `_vjp_ln_fwd`): the forward and its K6
    recompute then take the same P.  The plain versions take the form of
    their kernel (`softmax_form`);
  * K5 f32 (`fused_window_msa_bwd_f32`): `bwd_launches` on f32, the
    attention backward of csrc/fused_msa_bwd_f32.cu (one launch, 3xTF32 on
    the tensor cores) between the 3xTF32 dattn and dx products, K7 f32's
    split weight grads and `lavt_colsum_f32`;
  * K6 f32 (`fused_window_msa_bwd_recompute_f32`): the save mode f32's
    launches up to the attention, then K5 f32's;
  * K2p f32 (`fused_window_msa_grouped_f32`): `grouped_launches` on f32,
    the projections on the 3xTF32 GEMM (W's lo parts kept by the model,
    `WeightLo`), the attention a launch of its own on wgmma in 3xTF32
    (`grouped_attn_f32`, csrc/grouped_msa_f32.cu).
With them `lavt_one` trains at window 12 in f32 (`--window12 --no_bf16`).
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from . import cuda_lib, tf32_core
from .ln import layer_norm_rows_bwd_launch, layer_norm_rows_launch
from .ln import layer_norm_rows_plain as layer_norm_f32

LN_EPS = 1e-5
# the TPU rule (`_save_residuals_ok`): save p and qkv for the backward
# while neither exceeds this many bytes per block
RESID_CAP_BYTES = 192 * 1024 * 1024


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

def softmax_plain(s: torch.Tensor, exact: bool = True) -> torch.Tensor:
    """The softmax over the last dim of f32 scores: the exact
    max-subtracted one, or (exact False) the TPU inference kernel's
    shift-free exp(min(s, 80)) over its row sum (`_softmax_exp` of
    lavt_rs_tpu/ops/pallas/fused_msa.py), which equals it while every
    score is at most 80."""
    if exact:
        return torch.softmax(s, dim=-1)
    e = torch.exp(s.clamp(max=80.0))
    return e / e.sum(-1, keepdim=True)


def softmax_form(t: torch.Tensor, exact: bool) -> bool:
    """The softmax form of an entry point's kernel for t's dtype: the bf16
    kernels take the exact softmax always, the f32 ones the form asked
    (exact in the taped training forward, as JAX's `_vjp_fwd` /
    `_vjp_ln_fwd`; exp(min(s, 80)) at inference).  A CPU tensor's plain
    version takes the same form."""
    return exact or t.dtype != torch.float32


def fused_window_msa_save_plain(x, ln, wqkv, bqkv, wproj, bproj, bias, mask,
                                heads: int, scale: float,
                                ln_eps: float = LN_EPS, exact: bool = True):
    """The plain save-mode forward: (y, (q, k, v, p, xn)); xn is None
    without ln.  q/k/v are (B nW, N, C), p (B nW, heads, N, N); the softmax
    exact or, with exact False, the clamp form (`softmax_plain`)."""
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
    p = softmax_plain(s, exact).to(dt)
    o = (p.float() @ heads_of(v)).to(dt).transpose(1, 2).reshape(b, nw, n, c)
    y = (o.float() @ wproj.float().t() + bproj.float()).to(dt)
    if xn is not None:
        xn = xn.reshape(b * nw, n, c)
    return y, (q, k, v, p, xn)


def fused_window_msa_plain(x, wqkv, bqkv, wproj, bproj, bias, mask,
                           heads: int, scale: float,
                           exact: bool = True) -> torch.Tensor:
    """The plain PyTorch version of K2 (f32 math; exact False: the clamp
    softmax of K2 f32 at inference)."""
    return fused_window_msa_save_plain(x, None, wqkv, bqkv, wproj, bproj,
                                       bias, mask, heads, scale,
                                       exact=exact)[0]


def fused_window_msa_ln_plain(x, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj,
                              bias, mask, heads: int, scale: float,
                              ln_eps: float = LN_EPS,
                              exact: bool = True) -> torch.Tensor:
    """The plain PyTorch version of K1 (exact False: the clamp softmax of
    K1 f32 at inference)."""
    return fused_window_msa_save_plain(x, (ln_scale, ln_bias), wqkv, bqkv,
                                       wproj, bproj, bias, mask, heads, scale,
                                       ln_eps, exact)[0]


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
        return t.float().reshape(b * nw, n, heads, hd).transpose(1, 2)

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
    """Geometries the CUDA launches take: window 12 (N = 144), head dim 32
    (so C = 32 heads, from 96 at Swin-T stage 1 to 1536 at Swin-L stage
    4)."""
    return n == 144 and heads > 0 and c == 32 * heads


def _require_all(checks, dev) -> None:
    for name, t, dt, shape in checks:
        cuda_lib.require(t, name, dt, dev, shape)
        if t.data_ptr() % 16:  # the kernels move 16-byte words
            raise ValueError(f"{name}: data must be 16-byte aligned")


# the f32 GEMM's epilogues (csrc/gemm_f32.cu): + bias (q scaled), GELU,
# + residual
GEMM_F32_BIAS, GEMM_F32_GELU, GEMM_F32_RESIDUAL = 0, 1, 2
GEMM_F32_DEPTH = tf32_core.DEPTH  # K of a core stage: K must be a multiple


def tf32_split(w):
    """(hi, lo) of f32 w as the 3xTF32 kernels split it: hi = w with its 13
    low mantissa bits cleared (what the tensor core reads of an f32
    operand), lo = w - hi (exact: hi + lo == w bit for bit)."""
    hi = (w.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)
    return hi, w - hi


def tf32_lo(w) -> torch.Tensor:
    """The lo parts of f32 w (`tf32_split`'s lo), which `gemm_f32` brings
    by TMA beside w: on the card one launch (`lavt_tf32_lo`), its plain
    version on a CPU tensor."""
    if w.device.type == "cpu":
        return tf32_split(w)[1]
    if w.numel() % 4:
        raise ValueError(f"tf32 lo split: {w.numel()} values, not a multiple "
                         f"of 4")
    _require_all([("w", w, torch.float32, None)], w.device)
    lo = torch.empty_like(w)
    err = cuda_lib.lib().lavt_tf32_lo(w.data_ptr(), lo.data_ptr(), w.numel(),
                                      cuda_lib.stream_ptr(w.device))
    cuda_lib.check(err, "lavt_tf32_lo")
    return lo


class WeightLo:
    """The lo parts of an attention module's two projection weights, kept
    once a weight version: for `nn.Module`s with `qkv` and `proj` Linears,
    `use_kernels`, and `_lo_key` / `_lo` set to None (the 2D and 3D
    `WindowAttention`s)."""

    def weight_lo(self):
        """(qkv weight's, proj weight's) lo parts, w - trunc(w) with trunc
        clearing the 13 low bits, which the f32 kernels' GEMMs bring beside
        w (`tf32_lo`).  Made once and kept until a weight changes (a new
        version, device or storage: in training, once a step, after the
        optimizer's in-place update), as `relative_bias` keeps the bias."""
        wq, wp = self.qkv.weight, self.proj.weight
        key = (wq._version, wp._version, wq.device, wq.data_ptr(),
               wp.data_ptr())
        if self._lo_key != key:
            with torch.no_grad():
                self._lo = (tf32_lo(wq.detach()), tf32_lo(wp.detach()))
            self._lo_key = key
        return self._lo

    def _lo_for(self, x):
        """`weight_lo` where x takes the f32 kernels (an f32 CUDA tensor
        with the kernels and f32 weights), else None."""
        if (self.use_kernels and x.is_cuda and x.dtype == torch.float32
                and self.qkv.weight.dtype == torch.float32):
            return self.weight_lo()
        return None


def gemm_f32(a, w, b, epi: int, res=None, scaled: int = 0,
             scale: float = 1.0, keep=None, rows: int = 1,
             wlo=None) -> torch.Tensor:
    """The 3xTF32 GEMM of the f32 variants (`lavt_gemm_f32`, on the wgmma +
    TMA core of csrc/gemm_tf32_sm90.cuh, `tf32_core` kind "gemm"): out (M, N)
    f32 = epilogue(a wᵀ), a (M, K), w (N, K), b (N,) f32 on the card, K a
    multiple of 32, N even; epi GEMM_F32_BIAS ((· + b) times `scale` on the
    first `scaled` columns), GEMM_F32_GELU (exact GELU of · + b) or
    GEMM_F32_RESIDUAL (res + · + b; with keep, (M / rows,) f32, res +
    keep[row // rows] (· + b): K8 f32).  wlo, w's lo parts (`tf32_lo`;
    K3 / K8 f32's from `fused_mlp.mlp_f32_prep`, the MSA projections' kept
    by the model once a weight version, `WindowAttention.weight_lo`), is
    brought by TMA beside w; for a caller that passes none it is split
    first, by a launch of its own (`tf32_lo`).  Its
    plain versions are its callers' (`gemm_bias_plain`,
    `fused_mlp.gemm_bias_gelu_plain`, `fused_mlp.gemm_residual_plain`)."""
    (m, k), n = a.shape, w.shape[0]
    if k % GEMM_F32_DEPTH or n % 2:
        raise ValueError(f"f32 GEMM kernel: unsupported (M, N, K) "
                         f"{(m, n, k)}")
    f32, dev = torch.float32, a.device
    checks = [("a", a, f32, None), ("w", w, f32, (n, k)), ("b", b, f32, (n,))]
    if epi == GEMM_F32_RESIDUAL:
        checks.append(("res", res, f32, (m, n)))
    if keep is not None:
        if epi != GEMM_F32_RESIDUAL or rows < 1 or m % rows:
            raise ValueError(f"f32 GEMM kernel: keep takes the residual "
                             f"epilogue and samples of rows ({m}, {rows})")
        checks.append(("keep", keep, f32, (m // rows,)))
    _require_all(checks, dev)
    if wlo is None:
        wlo = tf32_lo(w)
    _require_all([("wlo", wlo, f32, (n, k))], dev)
    out = torch.empty((m, n), dtype=f32, device=dev)
    err = cuda_lib.lib().lavt_gemm_f32(
        a.data_ptr(), w.data_ptr(), wlo.data_ptr(), b.data_ptr(),
        None if res is None else res.data_ptr(),
        None if keep is None else keep.data_ptr(), out.data_ptr(), m, n, k,
        epi, scaled, float(scale), max(rows, 1), cuda_lib.stream_ptr(dev))
    cuda_lib.check(err, "lavt_gemm_f32")
    return out


def _check_geometry(x, heads) -> None:
    n, c = x.shape[-2:]
    if not fused_msa_supported(n, c, heads):
        raise ValueError(f"fused window MSA kernel: unsupported (N, C, heads) "
                         f"{(n, c, heads)}")


def sum_partials(part: torch.Tensor) -> torch.Tensor:
    """(S, ...) f32 partials -> (...) summed over S in order, on the
    kernel of csrc/fused_msa_bwd.cu (their f32 sum on a CPU tensor)."""
    if part.device.type == "cpu":
        return part.sum(0)
    if part.shape[0] == 1:
        return part[0]
    out = torch.empty(part.shape[1:], dtype=torch.float32, device=part.device)
    err = cuda_lib.lib().lavt_sum_partials(
        part.data_ptr(), out.data_ptr(), part.shape[0], out.numel(),
        cuda_lib.stream_ptr(part.device))
    cuda_lib.check(err, "lavt_sum_partials")
    return out


def colsum_partials(x2: torch.Tensor) -> torch.Tensor:
    """The f32 column sums of a (rows, cols) tensor by row splits, (splits,
    cols): bf16 on `lavt_colsum_bf16` (a block per split), f32 on
    `lavt_colsum_f32` (a block per split and 128 columns), both of
    csrc/fused_msa_bwd.cu, one split per SM and 32 rows or more each.  A
    CPU tensor gives its f32 sum as one split."""
    if x2.device.type == "cpu":
        return x2.float().sum(0, keepdim=True)
    rows, cols = x2.shape
    dt = x2.dtype
    if dt not in (torch.bfloat16, torch.float32):
        raise TypeError(f"colsum: dtype {dt}, expected bfloat16 or float32")
    _require_all([("x", x2, dt, None)], x2.device)
    splits = max(1, min(_SMS, rows // 32))
    part = torch.empty((splits, cols), dtype=torch.float32, device=x2.device)
    name = "lavt_colsum_f32" if dt == torch.float32 else "lavt_colsum_bf16"
    err = getattr(cuda_lib.lib(), name)(x2.data_ptr(), part.data_ptr(), rows,
                                        cols, splits,
                                        cuda_lib.stream_ptr(x2.device))
    cuda_lib.check(err, name)
    return part


def colsum(x2: torch.Tensor) -> torch.Tensor:
    """f32 column sums of a bf16 or f32 (rows, cols) tensor: its
    `colsum_partials` added in order (`sum_partials`); their f32 sum on a
    CPU tensor."""
    return sum_partials(colsum_partials(x2))


# -- K5's launches (csrc/fused_msa_bwd_sm90.cu) and their plain versions -----

_SMS = 132  # an H100's SMs (the launch plans' target off the card)


def msa_dgrad_plain(a, w) -> torch.Tensor:
    """The plain version of `msa_dgrad`: (a w) in f32, rounded once."""
    return (a.float() @ w.float()).to(a.dtype)


def msa_dgrad(a, w) -> torch.Tensor:
    """(M, N) bf16 = a (M, K) w, w (K, N) a torch Linear weight read as W
    (not Wᵀ): K5's dattn = gy Wproj and dx = dqkv Wqkv, on the wgmma + TMA
    GEMM core (`lavt_msa_dgrad`; w read MN-major).  f32 operands (K5 f32)
    take the 3xTF32 core with w read as (K, N), transposed by its stagers
    (`lavt_dgrad_f32`, K7 f32's dyln product, `tf32_core` kind "dgrad"; K
    a multiple of 32, N of 4).  The plain version on a CPU tensor."""
    if a.device.type == "cpu":
        return msa_dgrad_plain(a, w)
    (m, k), n = a.shape, w.shape[1]
    if a.dtype == torch.float32:
        if k % GEMM_F32_DEPTH or n % 4:
            raise ValueError(f"f32 dgrad kernel: unsupported (M, N, K) "
                             f"{(m, n, k)}")
        f32 = torch.float32
        _require_all([("a", a, f32, None), ("w", w, f32, (k, n))], a.device)
        out = torch.empty((m, n), dtype=f32, device=a.device)
        err = cuda_lib.lib().lavt_dgrad_f32(a.data_ptr(), w.data_ptr(),
                                            out.data_ptr(), m, n, k,
                                            cuda_lib.stream_ptr(a.device))
        cuda_lib.check(err, "lavt_dgrad_f32")
        return out
    bf16 = torch.bfloat16
    _require_all([("a", a, bf16, None), ("w", w, bf16, (k, n))], a.device)
    out = torch.empty((m, n), dtype=bf16, device=a.device)
    err = cuda_lib.lib().lavt_msa_dgrad(a.data_ptr(), w.data_ptr(),
                                        out.data_ptr(), m, n, k,
                                        cuda_lib.stream_ptr(a.device))
    cuda_lib.check(err, "lavt_msa_dgrad")
    return out


def msa_bwd_groups(windows: int, heads: int, sms: int = _SMS) -> int:
    """The attention launch's blocks per head: (groups, heads) blocks of
    one per SM, no more groups than windows."""
    return max(1, min(windows, sms // heads))


def msa_bwd_attn_plain(dattn, q, k, v, p, heads: int, scale: float,
                       groups: int):
    """The plain version of `msa_bwd_attn`: f32 math with the kernel's
    rounding points and its partial sums (block g's windows g, g + groups,
    ...)."""
    m, n, c = q.shape
    hd = c // heads
    dt = q.dtype

    def heads_of(t):  # (m n, C) or (m, n, C) -> (m, heads, n, hd) f32
        return t.float().reshape(m, n, heads, hd).transpose(1, 2)

    def merge(t):  # (m, heads, n, hd) -> (m n, C)
        return t.transpose(1, 2).reshape(m * n, c)

    do, qh, kh, vh = heads_of(dattn), heads_of(q), heads_of(k), heads_of(v)
    pf = p.float()
    of = pf @ vh
    dv = pf.transpose(-1, -2) @ do
    dp = do @ vh.transpose(-1, -2)
    ds = pf * (dp - (do * of).sum(-1, keepdim=True))
    dsc = ds.to(dt).float()
    dqkv = torch.cat([merge((dsc @ kh) * scale),
                      merge(dsc.transpose(-1, -2) @ qh), merge(dv)], dim=-1)
    group = torch.arange(m) % groups
    dbias_part = torch.stack([ds[group == g].sum(0) for g in range(groups)])
    rows = dqkv.view(m, n, 3 * c).sum(1)
    dbqkv_part = torch.stack([rows[group == g].sum(0) for g in range(groups)])
    return merge(of.to(dt)), dqkv.to(dt), dbias_part, dbqkv_part


def _require_rows(named, dev, shape, dtype=torch.bfloat16) -> int:
    """q, k, v: (m, N, C) tensors of `dtype` (bf16; f32 for K5 f32) on dev
    whose rows lie one stride apart, contiguous or the column views of one
    (m N, 3C) qkv tensor (the save mode's residuals); returns that row
    stride."""
    m, n, c = shape
    ld = named[0][1].stride(1)
    for name, t in named:
        if t.device != dev or t.dtype != dtype:
            raise ValueError(f"{name}: {t.dtype} on {t.device}, expected "
                             f"{dtype} on {dev}")
        if tuple(t.shape) != (m, n, c) or t.stride() != (n * ld, ld, 1):
            raise ValueError(f"{name}: shape {tuple(t.shape)} strides "
                             f"{t.stride()}, expected {(m, n, c)} with rows "
                             f"{ld} elements apart")
        if t.data_ptr() % 16 or (ld * t.element_size()) % 16:
            raise ValueError(f"{name}: rows must start on 16 bytes")
    return ld


# K5 f32's attention launch (csrc/fused_msa_bwd_f32.cu): a block of 9 warps
# per (group, head), one an SM; its shared memory, three fragment tiles of
# 144 rows (8 bytes an element), raw q, k and do (144 rows, 36 floats
# apart), raw v in a ring of two, and D
K5_F32_SMEM = 3 * 144 * 32 * 8 + (5 * 144 * 36 + 144) * 4


def msa_bwd_f32_groups(windows: int, heads: int, sms: int = _SMS) -> int:
    """K5 f32's dbias partials: the blocks of its attention launch,
    (groups, heads), fill the SMs once at one block an SM, no more groups
    than windows (csrc/fused_msa_bwd_f32.cu)."""
    return max(1, min(windows, sms // heads))


def msa_bwd_attn(dattn, q, k, v, p, heads: int, scale: float, groups: int):
    """K5's attention launch (`lavt_msa_bwd_attn_sm90`): dattn (B nW N, C)
    and the save mode's q, k, v (B nW, N, C; contiguous, or column views
    of its (B nW N, 3C) qkv tensor), p (B nW, heads, N, N) -> o (B nW N, C)
    and dqkv (B nW N, 3C) bf16, the f32 partials of dbias (groups, heads,
    N, N) and of dbqkv (groups, 3C).  The plain version on a CPU tensor;
    f32 tensors take K5 f32's (`msa_bwd_attn_f32`)."""
    if q.device.type == "cpu":
        return msa_bwd_attn_plain(dattn, q, k, v, p, heads, scale, groups)
    if q.dtype == torch.float32:
        return msa_bwd_attn_f32(dattn, q, k, v, p, heads, scale, groups)
    m, n, c = q.shape
    dev = q.device
    bf16 = torch.bfloat16
    _require_all([("dattn", dattn, bf16, (m * n, c)),
                  ("p", p, bf16, (m, heads, n, n))], dev)
    ld = _require_rows([("q", q), ("k", k), ("v", v)], dev, (m, n, c))
    o = torch.empty((m * n, c), dtype=bf16, device=dev)
    dqkv = torch.empty((m * n, 3 * c), dtype=bf16, device=dev)
    dbias_part = torch.empty((groups, heads, n, n), dtype=torch.float32,
                             device=dev)
    dbqkv_part = torch.empty((groups, 3 * c), dtype=torch.float32, device=dev)
    err = cuda_lib.lib().lavt_msa_bwd_attn_sm90(
        dattn.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        p.data_ptr(), o.data_ptr(), dqkv.data_ptr(), dbias_part.data_ptr(),
        dbqkv_part.data_ptr(), m, c, ld, heads, groups, float(scale),
        cuda_lib.stream_ptr(dev))
    cuda_lib.check(err, "lavt_msa_bwd_attn_sm90")
    return o, dqkv, dbias_part, dbqkv_part


def msa_bwd_attn_f32(dattn, q, k, v, p, heads: int, scale: float,
                     groups: int):
    """K5 f32's attention (`lavt_msa_bwd_attn_f32`, csrc/fused_msa_bwd_f32.cu:
    one launch, a block per (group, head) taking its windows whole), all
    f32: dattn (B nW N, C), the save mode f32's q, k, v (column views of
    its (B nW N, 3C) qkv tensor, or contiguous) and p (B nW, heads, N, N) -> o
    (B nW N, C), dqkv (B nW N, 3C), the dbias partials (groups, heads, N,
    N), block g's from the windows g, g + groups, ..., and the dbqkv
    partials: dqkv's column sums by row splits (`colsum_partials`).  The
    plain version (`msa_bwd_attn_plain`) on a CPU tensor."""
    if q.device.type == "cpu":
        return msa_bwd_attn_plain(dattn, q, k, v, p, heads, scale, groups)
    m, n, c = q.shape
    dev = q.device
    f32 = torch.float32
    if not fused_msa_supported(n, c, heads):
        raise ValueError(f"f32 window MSA backward kernel: unsupported (N, C, "
                         f"heads) {(n, c, heads)}")
    if not 1 <= groups <= m:
        raise ValueError(f"f32 window MSA backward kernel: {groups} groups "
                         f"of {m} windows")
    _require_all([("dattn", dattn, f32, (m * n, c)),
                  ("p", p, f32, (m, heads, n, n))], dev)
    ld = _require_rows([("q", q), ("k", k), ("v", v)], dev, (m, n, c), f32)
    o = torch.empty((m * n, c), dtype=f32, device=dev)
    dqkv = torch.empty((m * n, 3 * c), dtype=f32, device=dev)
    dbias_part = torch.empty((groups, heads, n, n), dtype=f32, device=dev)
    err = cuda_lib.lib().lavt_msa_bwd_attn_f32(
        dattn.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        p.data_ptr(), o.data_ptr(), dqkv.data_ptr(), dbias_part.data_ptr(),
        m, c, ld, heads, groups, float(scale), cuda_lib.stream_ptr(dev))
    cuda_lib.check(err, "lavt_msa_bwd_attn_f32")
    return o, dqkv, dbias_part, colsum_partials(dqkv)


def bwd_launches(x, gy, wqkv, wproj, saved, heads: int, scale: float,
                 groups: Optional[int] = None):
    """K5's launches, in order (csrc/fused_msa_bwd_sm90.cu):
      (a) dattn = gy Wproj (`msa_dgrad`);
      (b) the attention (`msa_bwd_attn`): o, dqkv and the dbias / dbqkv
          partials;
      (c) dx = dqkv Wqkv (`msa_dgrad`);
      (d), (e) dWqkv = dqkvᵀ x, dWproj = gyᵀ o as split partials (K7's
          `fused_mlp.wgrad`, split by `fused_mlp.wgrad_split_tiles`);
      (f) dbproj = the column sums of gy (`colsum`);
      and `sum_partials` over every split, in order.
    K5 f32 is the same launches on f32 tensors, each on its f32 kernel: (a)
    and (c) on the 3xTF32 core (`lavt_dgrad_f32`), (b) K5 f32's
    attention (`msa_bwd_attn_f32`, groups by `msa_bwd_f32_groups`; dbqkv
    from dqkv's column sums), (d)-(e) K7 f32's weight grads on the core
    split by its rule (32-row k-tiles, one block an SM), (f)
    `lavt_colsum_f32`.  On CPU
    tensors each launch takes its plain version, which compose to
    `fused_window_msa_bwd_plain`'s values (tests/test_torch_k5_launches.py,
    tests/test_torch_f32_msa_train.py).  Returns (dx, dwqkv, dbqkv,
    dwproj, dbproj, dbias) as K5 does."""
    from .fused_mlp import (  # imports this module
        GEMM_DEPTH, wgrad, wgrad_split_tiles)

    b, nw, n, c = x.shape
    q, k, v, p = saved
    m = b * nw
    rows = m * n
    f32 = x.dtype == torch.float32
    if groups is None:
        sms = (cuda_lib.sm_count(x.device.index or 0)
               if x.device.type == "cuda" else _SMS)
        groups = (msa_bwd_f32_groups if f32 else msa_bwd_groups)(m, heads,
                                                                 sms)
    depth, per_sm = (GEMM_F32_DEPTH, 1) if f32 else (GEMM_DEPTH, 2)
    x2, g2 = x.reshape(rows, c), gy.reshape(rows, c)
    dattn = msa_dgrad(g2, wproj)
    o, dqkv, dbias_part, dbqkv_part = msa_bwd_attn(dattn, q, k, v, p, heads,
                                                   scale, groups)
    dx = msa_dgrad(dqkv, wqkv)
    dwqkv = wgrad(dqkv, x2, wgrad_split_tiles(rows, 3 * c, c, 1, depth,
                                              per_sm) * depth)
    dwproj = wgrad(g2, o, wgrad_split_tiles(rows, c, c, 1, depth, per_sm)
                   * depth)
    return (dx.view(b, nw, n, c), sum_partials(dwqkv), sum_partials(dbqkv_part),
            sum_partials(dwproj), colsum(g2), sum_partials(dbias_part))


def _bwd_launch(x, gy, wqkv, wproj, saved, heads, scale,
                dtype=torch.bfloat16):
    """K5 (bf16) or K5 f32 (every tensor f32) on the card: the checks, then
    `bwd_launches`."""
    b, nw, n, c = x.shape
    _check_geometry(x, heads)
    q, k, v, p = saved
    m = b * nw
    dt = dtype
    _require_all([("x", x, dt, None), ("gy", gy, dt, (b, nw, n, c)),
                  ("wqkv", wqkv, dt, (3 * c, c)),
                  ("wproj", wproj, dt, (c, c)),
                  ("p", p, dt, (m, heads, n, n))], x.device)
    _require_rows([("q", q), ("k", k), ("v", v)], x.device, (m, n, c), dt)
    return bwd_launches(x, gy, wqkv, wproj, saved, heads, scale)


# -- K2 and the save mode (csrc/fused_msa_sm90.cu) and their plain versions --

def msa_attn_plain(qkv, bias, mask, heads: int, exact: bool = True):
    """The plain version of `msa_attn`: f32 math with the kernel's rounding
    points (P rounded to bf16 after its f32 normalisation, O made from that
    P), the softmax exact or (exact False, K1 f32 / K2 f32 / K11 f32 at
    inference) the clamp form.  Returns (o (B nW N, C), p (B nW, heads, N,
    N))."""
    m, n, c3 = qkv.shape
    c = c3 // 3
    dt = qkv.dtype

    def heads_of(t):  # (m, N, C) -> (m, heads, N, hd) f32
        return t.float().reshape(m, n, heads, c // heads).transpose(1, 2)

    q, k, v = (heads_of(qkv[..., i * c:(i + 1) * c]) for i in range(3))
    s = q @ k.transpose(-1, -2) + bias.float()
    if mask is not None:
        nw = mask.shape[0]
        s = (s.view(m // nw, nw, heads, n, n)
             + mask.float()[None, :, None]).view(m, heads, n, n)
    p = softmax_plain(s, exact).to(dt)
    o = (p.float() @ v).to(dt).transpose(1, 2).reshape(m * n, c)
    return o, p


def msa_attn(qkv, bias, mask, heads: int, save: bool,
             flags: Optional[torch.Tensor] = None, exact: bool = True):
    """The attention launch of K2, the save mode and K6's forward
    (`lavt_msa_fwd_sm90`): qkv (B nW, 144, 3C) bf16 as `gemm_bias` writes
    it (q scaled), bias (heads, 144, 144) f32, mask (nW, 144, 144) f32 or
    None with its window flags (`window.shift_mask_flags_2d`; None: every
    window reads its mask) -> (o (B nW 144, C) bf16, p (B nW, heads, 144,
    144) bf16 with save, else None); the exact softmax.  The plain version
    on a CPU tensor (which returns p either way, in `softmax_form`); an f32
    qkv takes the f32 attention (`msa_attn_f32`: the softmax exact or, with
    exact False, the clamp form)."""
    if qkv.device.type == "cpu":
        return msa_attn_plain(qkv, bias, mask, heads,
                              softmax_form(qkv, exact))
    if qkv.dtype == torch.float32:
        return msa_attn_f32(qkv, bias, mask, heads, flags, save, exact)
    m, n, c3 = qkv.shape
    c = c3 // 3
    dev = qkv.device
    if not fused_msa_supported(n, c, heads):
        raise ValueError(f"fused window MSA kernel: unsupported (N, C, heads) "
                         f"{(n, c, heads)}")
    nw = 1 if mask is None else mask.shape[0]
    checks = [("qkv", qkv, torch.bfloat16, None),
              ("bias", bias, torch.float32, (heads, n, n))]
    if mask is not None:
        checks.append(("mask", mask, torch.float32, (nw, n, n)))
        if m % nw:
            raise ValueError(f"mask: {nw} windows do not divide {m}")
        if flags is not None:
            cuda_lib.require(flags, "flags", torch.int32, dev, (nw,))
    _require_all(checks, dev)
    o = torch.empty((m * n, c), dtype=torch.bfloat16, device=dev)
    p = (torch.empty((m, heads, n, n), dtype=torch.bfloat16, device=dev)
         if save else None)
    groups = msa_bwd_groups(m, heads, cuda_lib.sm_count(dev.index or 0))
    err = cuda_lib.lib().lavt_msa_fwd_sm90(
        qkv.data_ptr(), bias.data_ptr(),
        None if mask is None else mask.data_ptr(),
        None if mask is None or flags is None else flags.data_ptr(),
        o.data_ptr(), None if p is None else p.data_ptr(), m, nw, c, heads,
        groups, cuda_lib.stream_ptr(dev))
    cuda_lib.check(err, "lavt_msa_fwd_sm90")
    return o, p


def _attn_f32_checks(qkv, bias, mask, flags, heads: int, n: int, c: int,
                     nw: int) -> None:
    """The f32 attention launches' checks of their inputs."""
    dev = qkv.device
    if not fused_msa_supported(n, c, heads):
        raise ValueError(f"f32 window MSA kernel: unsupported (N, C, heads) "
                         f"{(n, c, heads)}")
    f32 = torch.float32
    checks = [("qkv", qkv, f32, None), ("bias", bias, f32, (heads, n, n))]
    if mask is not None:
        checks.append(("mask", mask, f32, (nw, n, n)))
        if flags is not None:
            cuda_lib.require(flags, "flags", torch.int32, dev, (nw,))
    _require_all(checks, dev)


def msa_attn_f32(qkv, bias, mask, heads: int,
                 flags: Optional[torch.Tensor] = None, save: bool = False,
                 exact: bool = False):
    """The f32 attention launch of K1 f32, K2 f32, the save mode f32 and K6
    f32's forward (`lavt_msa_fwd_f32`, csrc/fused_msa_f32.cu): qkv (B nW,
    144, 3C) f32 as `gemm_bias` writes it (q scaled), bias (heads, 144,
    144) f32, mask (nW, 144, 144) f32 or None with its window flags -> (o
    (B nW 144, C) f32, p (B nW, heads, 144, 144) f32 with save, else
    None); e = exp(s - max) with exact (the taped forward), else exp(min(s,
    80)), normalised by its row sum; with save (exact only: the taped
    forward's) O is made from the stored P.  The plain version
    (`msa_attn_plain`) on a CPU tensor."""
    if save and not exact:
        raise ValueError("the f32 save mode takes the exact softmax")
    if qkv.device.type == "cpu":
        o, p = msa_attn_plain(qkv, bias, mask, heads, exact)
        return o, (p if save else None)
    m, n, c3 = qkv.shape
    c = c3 // 3
    nw = 1 if mask is None else mask.shape[0]
    if m % nw:
        raise ValueError(f"mask: {nw} windows do not divide {m}")
    _attn_f32_checks(qkv, bias, mask, flags, heads, n, c, nw)
    o = torch.empty((m * n, c), dtype=torch.float32, device=qkv.device)
    p = (torch.empty((m, heads, n, n), dtype=torch.float32, device=qkv.device)
         if save else None)
    err = cuda_lib.lib().lavt_msa_fwd_f32(
        qkv.data_ptr(), bias.data_ptr(),
        None if mask is None else mask.data_ptr(),
        None if mask is None or flags is None else flags.data_ptr(),
        o.data_ptr(), None if p is None else p.data_ptr(), m, nw, c, heads,
        int(exact), cuda_lib.stream_ptr(qkv.device))
    cuda_lib.check(err, "lavt_msa_fwd_f32")
    return o, p


def attn_launches(x, ln, wqkv, bqkv, bias, mask, heads: int, scale: float,
                  ln_eps: float = LN_EPS, save: bool = True, flags=None,
                  exact: bool = True, wlo=None):
    """The launches of `save_launches` before the out-projection: (o
    (B nW N, C), (q, k, v, p, xn) with save, else None).  q, k, v are the
    column views of the one qkv tensor (B nW, N, 3C) (no copy); xn is
    None without ln.  wlo: (wqkv's, wproj's) lo parts for the f32 GEMMs, or
    None."""
    b, nw, n, c = x.shape
    rows = b * nw * n
    x2 = x.reshape(rows, c)
    xn = None
    if ln is not None:
        x2 = xn = layer_norm_rows_launch(x2, ln[0], ln[1], ln_eps)
    qkv = gemm_bias(x2, wqkv, bqkv, c, scale,
                    wlo=None if wlo is None else wlo[0]).view(b * nw, n, 3 * c)
    o, p = msa_attn(qkv, bias, mask, heads, save, flags, exact)
    if not save:
        return o, None
    q, k, v = (qkv[..., i * c:(i + 1) * c] for i in range(3))
    return o, (q, k, v, p, None if xn is None else xn.view(b * nw, n, c))


def save_launches(x, ln, wqkv, bqkv, wproj, bproj, bias, mask, heads: int,
                  scale: float, ln_eps: float = LN_EPS, save: bool = True,
                  flags=None, exact: bool = True, wlo=None):
    """K1 and K2 (save False) and the K1/K2 save mode, in order:
      (0) K1 only: xn = the pre-attention LN rows on K4's launch
          (`ln.layer_norm_rows_launch`, f32 stats, fast variance);
      (a) qkv = x Wqkvᵀ + bqkv, q scaled after its bias, bf16 (B nW N, 3C),
          on the GEMM core (`gemm_bias`);
      (b) the attention (`msa_attn`) on qkv: O (B nW N, C) and, with save,
          the bf16 P it was made from;
      (c) y = O Wprojᵀ + bproj on the GEMM core.
    On f32 tensors (K1 f32, K2 f32, the save mode f32, K6 f32's forward)
    each launch takes its f32 kernel: K4 f32's LN rows, the 3xTF32 GEMM,
    `msa_attn_f32` (exact: the max-subtracted softmax, else exp(min(s,
    80)); the bf16 attention is exact either way), the 3xTF32 GEMM, each
    GEMM with its weight's lo parts from `wlo` (wqkv's, wproj's) where
    given.  Returns y (B, nW, N, C), with save (y, (q, k, v, p, xn)), q, k, v the
    column views of qkv.  On CPU tensors each launch takes its plain
    version, which compose to `fused_window_msa_save_plain`'s values
    (tests/test_torch_msa_save_launches.py)."""
    o, saved = attn_launches(x, ln, wqkv, bqkv, bias, mask, heads, scale,
                             ln_eps, save, flags, exact, wlo)
    y = gemm_bias(o, wproj, bproj,
                  wlo=None if wlo is None else wlo[1]).view(x.shape)
    return (y, saved) if save else y


def _check_save_launches(x, ln, wqkv, bqkv, wproj, bproj, heads,
                         dtype=torch.bfloat16) -> None:
    """The launches' checks of their inputs beside what `msa_attn` holds,
    before any launch: every tensor of `dtype` (bf16; f32 for K1 f32)."""
    _check_geometry(x, heads)
    b, nw, n, c = x.shape
    checks = [("x", x, dtype, None), ("wqkv", wqkv, dtype, (3 * c, c)),
              ("bqkv", bqkv, dtype, (3 * c,))]
    if wproj is not None:
        checks += [("wproj", wproj, dtype, (c, c)),
                   ("bproj", bproj, dtype, (c,))]
    if ln is not None:
        checks += [("ln_scale", ln[0], dtype, (c,)),
                   ("ln_bias", ln[1], dtype, (c,))]
    _require_all(checks, x.device)


# -- wrappers: plain version on a CPU tensor, the kernel on a CUDA tensor ----

def fused_window_msa(x, wqkv, bqkv, wproj, bproj, bias,
                     mask: Optional[torch.Tensor], heads: int, scale: float,
                     flags: Optional[torch.Tensor] = None,
                     exact: bool = False, wlo=None) -> torch.Tensor:
    """K2: (B, nW, N, C) post-LN windowed tokens -> projected attention;
    on the card the launches of `save_launches` without the saves.  A CUDA
    f32 x takes K2 f32 (`fused_window_msa_f32`); `exact` chooses its
    softmax (JAX `fused_window_msa`: exp(min(s, 80)); the taped forward,
    `FusedWindowMSA`: exact), the bf16 kernel's is exact; `wlo` its
    weights' lo parts."""
    if x.device.type == "cpu":
        return fused_window_msa_plain(x, wqkv, bqkv, wproj, bproj, bias, mask,
                                      heads, scale, softmax_form(x, exact))
    if x.dtype == torch.float32:
        return fused_window_msa_f32(x, wqkv, bqkv, wproj, bproj, bias, mask,
                                    heads, scale, flags, exact, wlo)
    _check_save_launches(x, None, wqkv, bqkv, wproj, bproj, heads)
    y = save_launches(x, None, wqkv, bqkv, wproj, bproj, bias, mask, heads,
                      scale, save=False, flags=flags)
    fused_window_msa.launches += 1
    return y


def fused_window_msa_f32(x, wqkv, bqkv, wproj, bproj, bias,
                         mask: Optional[torch.Tensor], heads: int,
                         scale: float, flags: Optional[torch.Tensor] = None,
                         exact: bool = False, wlo=None) -> torch.Tensor:
    """K2 f32: K2 on f32 tokens and weights; on the card the launches of
    `save_launches` without the saves, each on its f32 kernel (the 3xTF32
    GEMM, `msa_attn_f32`, the 3xTF32 GEMM), the softmax exp(min(s, 80))
    (JAX `fused_window_msa`) or, with exact, the max-subtracted one (the
    taped forward of a block that saves nothing); wlo: (wqkv's, wproj's)
    lo parts (`tf32_lo`), or None: each GEMM splits its weight first.  The
    plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return fused_window_msa_plain(x, wqkv, bqkv, wproj, bproj, bias, mask,
                                      heads, scale, exact)
    _check_save_launches(x, None, wqkv, bqkv, wproj, bproj, heads,
                         torch.float32)
    y = save_launches(x, None, wqkv, bqkv, wproj, bproj, bias, mask, heads,
                      scale, save=False, flags=flags, exact=exact, wlo=wlo)
    fused_window_msa_f32.launches += 1
    return y


def fused_window_msa_ln(x, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj, bias,
                        mask: Optional[torch.Tensor], heads: int, scale: float,
                        ln_eps: float = LN_EPS,
                        flags: Optional[torch.Tensor] = None,
                        exact: bool = False, wlo=None) -> torch.Tensor:
    """K1: (B, nW, N, C) PRE-LN windowed tokens -> projected attention; on
    the card the launches of `save_launches` with LN and without the saves
    (y has the save mode's bits).  A CUDA f32 x takes K1 f32
    (`fused_window_msa_ln_f32`), `exact` and `wlo` as `fused_window_msa`'s."""
    if x.device.type == "cpu":
        return fused_window_msa_ln_plain(x, ln_scale, ln_bias, wqkv, bqkv,
                                         wproj, bproj, bias, mask, heads,
                                         scale, ln_eps, softmax_form(x, exact))
    if x.dtype == torch.float32:
        return fused_window_msa_ln_f32(x, ln_scale, ln_bias, wqkv, bqkv,
                                       wproj, bproj, bias, mask, heads, scale,
                                       ln_eps, flags, exact, wlo)
    ln = (ln_scale, ln_bias)
    _check_save_launches(x, ln, wqkv, bqkv, wproj, bproj, heads)
    y = save_launches(x, ln, wqkv, bqkv, wproj, bproj, bias, mask, heads,
                      scale, ln_eps, save=False, flags=flags)
    fused_window_msa_ln.launches += 1
    return y


def fused_window_msa_ln_f32(x, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj,
                            bias, mask: Optional[torch.Tensor], heads: int,
                            scale: float, ln_eps: float = LN_EPS,
                            flags: Optional[torch.Tensor] = None,
                            exact: bool = False, wlo=None) -> torch.Tensor:
    """K1 f32: K1 on f32 tokens and weights; on the card the launches of
    `save_launches` without the saves, each on its f32 kernel (K4 f32's LN
    rows, the 3xTF32 GEMM, `msa_attn_f32`, the 3xTF32 GEMM), the softmax
    exp(min(s, 80)) at inference (JAX `fused_window_msa_ln`) or, with
    exact, the max-subtracted one (the taped forward, JAX `_vjp_ln_fwd`);
    wlo as `fused_window_msa_f32`'s.  The plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return fused_window_msa_ln_plain(x, ln_scale, ln_bias, wqkv, bqkv,
                                         wproj, bproj, bias, mask, heads,
                                         scale, ln_eps, exact)
    ln = (ln_scale, ln_bias)
    _check_save_launches(x, ln, wqkv, bqkv, wproj, bproj, heads,
                         torch.float32)
    y = save_launches(x, ln, wqkv, bqkv, wproj, bproj, bias, mask, heads,
                      scale, ln_eps, save=False, flags=flags, exact=exact,
                      wlo=wlo)
    fused_window_msa_ln_f32.launches += 1
    return y


def fused_window_msa_save(x, ln, wqkv, bqkv, wproj, bproj, bias, mask,
                          heads: int, scale: float, ln_eps: float = LN_EPS,
                          flags: Optional[torch.Tensor] = None, wlo=None):
    """K1 (ln given) / K2 in save mode: (y, (q, k, v, p, xn)); on the card
    the launches of `save_launches`, q, k, v the column views of their
    qkv tensor.  A CUDA f32 x takes the save mode f32
    (`fused_window_msa_save_f32`)."""
    if x.device.type == "cpu":
        return fused_window_msa_save_plain(x, ln, wqkv, bqkv, wproj, bproj,
                                           bias, mask, heads, scale, ln_eps)
    if x.dtype == torch.float32:
        return fused_window_msa_save_f32(x, ln, wqkv, bqkv, wproj, bproj,
                                         bias, mask, heads, scale, ln_eps,
                                         flags, wlo)
    _check_save_launches(x, ln, wqkv, bqkv, wproj, bproj, heads)
    out = save_launches(x, ln, wqkv, bqkv, wproj, bproj, bias, mask, heads,
                        scale, ln_eps, flags=flags)
    counter = fused_window_msa if ln is None else fused_window_msa_ln
    counter.launches += 1
    return out


def fused_window_msa_save_f32(x, ln, wqkv, bqkv, wproj, bproj, bias, mask,
                              heads: int, scale: float,
                              ln_eps: float = LN_EPS,
                              flags: Optional[torch.Tensor] = None, wlo=None):
    """The K1/K2 save mode f32 (JAX `_fwd(..., exact=True, save=True)` on
    f32): (y, (q, k, v, p, xn)), all f32, the exact softmax; on the card
    the launches of `save_launches` on their f32 kernels, q, k, v the
    column views of the f32 qkv tensor, p written by `msa_attn_f32`; wlo
    as `fused_window_msa_f32`'s.  One count per call, with or without ln.
    The plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return fused_window_msa_save_plain(x, ln, wqkv, bqkv, wproj, bproj,
                                           bias, mask, heads, scale, ln_eps)
    _check_save_launches(x, ln, wqkv, bqkv, wproj, bproj, heads,
                         torch.float32)
    out = save_launches(x, ln, wqkv, bqkv, wproj, bproj, bias, mask, heads,
                        scale, ln_eps, flags=flags, wlo=wlo)
    fused_window_msa_save_f32.launches += 1
    return out


def fused_window_msa_bwd(x, gy, wqkv, wproj, saved, heads: int,
                         scale: float):
    """K5: gradients from the save-mode residuals (q, k, v, p); x is the
    MSA's input (xn for the LN variant).  CUDA f32 tensors take K5 f32
    (`fused_window_msa_bwd_f32`)."""
    if x.device.type == "cpu":
        return fused_window_msa_bwd_plain(x, gy, wqkv, wproj, saved, heads,
                                          scale)
    if x.dtype == torch.float32:
        return fused_window_msa_bwd_f32(x, gy, wqkv, wproj, saved, heads,
                                        scale)
    out = _bwd_launch(x, gy, wqkv, wproj, saved, heads, scale)
    fused_window_msa_bwd.launches += 1
    return out


def fused_window_msa_bwd_f32(x, gy, wqkv, wproj, saved, heads: int,
                             scale: float):
    """K5 f32: K5 from the save mode f32's residuals, every tensor f32
    (JAX `_fused_bwd_group_resid` on f32); on the card `bwd_launches` on
    their f32 kernels.  The plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return fused_window_msa_bwd_plain(x, gy, wqkv, wproj, saved, heads,
                                          scale)
    out = _bwd_launch(x, gy, wqkv, wproj, saved, heads, scale, torch.float32)
    fused_window_msa_bwd_f32.launches += 1
    return out


def fused_window_msa_bwd_recompute(x, ln, wqkv, bqkv, wproj, bproj, bias,
                                   mask, gy, heads: int, scale: float,
                                   ln_eps: float = LN_EPS,
                                   flags: Optional[torch.Tensor] = None,
                                   wlo=None):
    """K6: the same gradients as K5 with nothing saved; they are with
    respect to the MSA's input (xn with ln).  On the card the save mode's
    launches up to the attention (`attn_launches`), then K5's.  CUDA f32
    tensors take K6 f32 (`fused_window_msa_bwd_recompute_f32`)."""
    if x.device.type == "cpu":
        return fused_window_msa_bwd_recompute_plain(
            x, ln, wqkv, bqkv, wproj, bproj, bias, mask, gy, heads, scale,
            ln_eps)
    if x.dtype == torch.float32:
        return fused_window_msa_bwd_recompute_f32(
            x, ln, wqkv, bqkv, wproj, bproj, bias, mask, gy, heads, scale,
            ln_eps, flags, wlo)
    out = _recompute_launch(x, ln, wqkv, bqkv, wproj, bias, mask, gy, heads,
                            scale, ln_eps, flags, torch.bfloat16)
    fused_window_msa_bwd_recompute.launches += 1
    return out


def fused_window_msa_bwd_recompute_f32(x, ln, wqkv, bqkv, wproj, bproj, bias,
                                       mask, gy, heads: int, scale: float,
                                       ln_eps: float = LN_EPS,
                                       flags: Optional[torch.Tensor] = None,
                                       wlo=None):
    """K6 f32 (JAX `_fused_bwd_group` on f32): the save mode f32's
    launches up to the attention, with the exact softmax (`attn_launches`,
    P into per-call scratch; wqkv's lo parts from `wlo` where given), then
    K5 f32's; every tensor f32.  The plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return fused_window_msa_bwd_recompute_plain(
            x, ln, wqkv, bqkv, wproj, bproj, bias, mask, gy, heads, scale,
            ln_eps)
    out = _recompute_launch(x, ln, wqkv, bqkv, wproj, bias, mask, gy, heads,
                            scale, ln_eps, flags, torch.float32, wlo)
    fused_window_msa_bwd_recompute_f32.launches += 1
    return out


def _recompute_launch(x, ln, wqkv, bqkv, wproj, bias, mask, gy, heads, scale,
                      ln_eps, flags, dtype, wlo=None):
    """K6 / K6 f32 on the card: the save mode's checks and launches up to
    the attention, then `_bwd_launch` (its checks, K5's launches)."""
    _check_save_launches(x, ln, wqkv, bqkv, None, None, heads, dtype)
    _, (q, k, v, p, xn) = attn_launches(x, ln, wqkv, bqkv, bias, mask, heads,
                                        scale, ln_eps, flags=flags, wlo=wlo)
    xin = x if xn is None else xn.view(x.shape)
    return _bwd_launch(xin, gy, wqkv, wproj, (q, k, v, p), heads, scale,
                       dtype)


fused_window_msa.launches = 0
fused_window_msa_f32.launches = 0
fused_window_msa_ln.launches = 0
fused_window_msa_ln_f32.launches = 0
fused_window_msa_save_f32.launches = 0
fused_window_msa_bwd.launches = 0
fused_window_msa_bwd_f32.launches = 0
fused_window_msa_bwd_recompute.launches = 0
fused_window_msa_bwd_recompute_f32.launches = 0


# -- K2p: windows padded to 16 tokens, grouped by mask --------------------------

PAD_KEY_BIAS = -1e9  # kills a padded key: exp underflows to exactly 0 in f32


TOKEN_TILE = 16  # K2p's bf16 row tile; its token count is padded to a multiple


def pad_tokens(n: int) -> int:
    """Token count padded to K2p's bf16 16-row tile (392 -> 400; the JAX
    package's `_sublane_pad(n, 2)`).  The f32 route pads to 8
    (`_sublane_pad(n, 4)`: 392 stays 392), as the JAX block does at its
    dtype's itemsize."""
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


def padded_msa_supported(n_p: int, c: int, heads: int,
                         itemsize: int = 2) -> bool:
    """Geometries K2p's launches take: n_p a whole number of sublane tiles
    of the dtype (`_sublane_ok`: 16 rows in bf16, 8 in f32) up to 400
    (K10's kernel and K10 f32's), head dim 32 (C = 32 heads)."""
    return (heads > 0 and c == 32 * heads and _sublane_ok(n_p, itemsize)
            and 0 < n_p <= 400)


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


def gemm_bias_plain(x2, w, b, scaled: int = 0,
                    scale: float = 1.0) -> torch.Tensor:
    """The plain version of `gemm_bias`: f32 math, rounded once."""
    y = x2.float() @ w.float().t() + b.float()
    if scaled:
        y[:, :scaled] *= scale
    return y.to(x2.dtype)


def gemm_bias(x2, w, b, scaled: int = 0, scale: float = 1.0,
              wlo=None) -> torch.Tensor:
    """(M, N) = (x2 wᵀ + b) s rounded to bf16, s = scale on the first
    `scaled` columns (else 1), on the wgmma + TMA GEMM core
    (csrc/window_msa_sm90.cu): K2p's qkv projection (scaled = C: q scaled
    after its bias, as the TPU kernel rounds it) and its out-projection
    (scaled = 0).  x2 (M, K), w (N, K) (a torch Linear weight), b (N,),
    bf16; the plain version on a CPU tensor.  f32 operands take the 3xTF32
    GEMM (`gemm_f32`, K1 f32's and K11 f32's projections, w's lo parts
    `wlo` or, given none, split by a launch of their own), rounded
    nowhere."""
    if x2.device.type == "cpu":
        return gemm_bias_plain(x2, w, b, scaled, scale)
    if x2.dtype == torch.float32:
        return gemm_f32(x2, w, b, GEMM_F32_BIAS, scaled=scaled, scale=scale,
                        wlo=wlo)
    (m, k), n = x2.shape, w.shape[0]
    bf16 = torch.bfloat16
    _require_all([("x", x2, bf16, None), ("w", w, bf16, (n, k)),
                  ("b", b, bf16, (n,))], x2.device)
    y = torch.empty((m, n), dtype=bf16, device=x2.device)
    err = cuda_lib.lib().lavt_gemm_bias_bf16(
        x2.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), m, n, k,
        scaled, float(scale), cuda_lib.stream_ptr(x2.device))
    cuda_lib.check(err, "lavt_gemm_bias_bf16")
    return y


# K2p f32's attention launch (csrc/grouped_msa_f32.cu): 64-row query tiles
# in sweeps of four (each of the two consumer warpgroups owns two), keys in
# chunks of 56 through a ring of three slots, up to 448 tokens; its shared
# memory: two q buffers (a sweep's 256 rows of 128 bytes each), and per
# slot k, k's lo and v (56 rows of 128 bytes each), v^T's hi and lo (two 4
# KB blocks of 32 keys each), the ring's and the q buffers' barriers, 1 KB
# of alignment slack
K2P_F32_TILE, K2P_F32_SWEEP, K2P_F32_CHUNK = 64, 4, 56
K2P_F32_STAGES, K2P_F32_MAX_N = 3, 448
K2P_F32_SMEM = (2 * K2P_F32_SWEEP * K2P_F32_TILE * 128
                + K2P_F32_STAGES * (3 * K2P_F32_CHUNK * 128 + 2 * 2 * 4096)
                + (2 * K2P_F32_STAGES + 4) * 8 + 1024)


@functools.lru_cache(maxsize=64)
def k2p_f32_plan(bw: int, heads: int, n: int, sms: int) -> dict:
    """K2p f32's attention launch (`lavt_k2p_attn_f32`) on `sms` SMs: an
    item is one sweep (four 64-row query tiles) of one (window, head),
    `sweeps` a unit; the items in (window, head, sweep) order, item = (w
    heads + h) sweeps + s; one persistent block an SM, block b over the items
    [items b / blocks, items (b + 1) / blocks) (`per_block` at most); the
    unit's query rows in `tiles` tiles, `tiles_per_warpgroup` of a sweep
    for each of the two consumer warpgroups, its keys in `chunks` of 56
    streamed once a sweep; `smem` bytes."""
    tiles = -(-n // K2P_F32_TILE)
    sweeps = -(-tiles // K2P_F32_SWEEP)
    items = bw * heads * sweeps
    blocks = min(items, sms)
    return dict(items=items, blocks=blocks, per_block=-(-items // blocks),
                tiles=tiles, sweeps=sweeps, tiles_per_warpgroup=2,
                chunks=-(-n // K2P_F32_CHUNK), stages=K2P_F32_STAGES,
                smem=K2P_F32_SMEM)


def grouped_attn_f32(qkv, bias, mask, nu: int, heads: int) -> torch.Tensor:
    """K2p f32's attention launch (`lavt_k2p_attn_f32`,
    csrc/grouped_msa_f32.cu): qkv (B, nW, n, 3C) f32 as the qkv projection
    writes it (q scaled), bias (heads, n, n) f32; window w of an image
    takes no mask for w < nu, else mask[w - nu] of the (nW - nu, n, n) f32
    mask (None: no window is masked) -> O (B, nW, n, C) f32, the exact
    softmax.  n a multiple of 8 up to 448.  Uncounted (K2p f32 counts its
    calls).  The plain version (`window_attn.attention_qkv_grouped` at
    scale 1) on a CPU tensor."""
    from . import window_attn  # imports this module

    b, nw, n, c3 = qkv.shape
    if mask is None or nu == nw:
        mask, nu = None, nw
    if qkv.device.type == "cpu":
        return window_attn.attention_qkv_grouped(qkv, bias, mask, nu, heads,
                                                 1.0)
    c = c3 // 3
    if (c != 32 * heads or n % 8 or not 8 <= n <= K2P_F32_MAX_N
            or not 0 <= nu <= nw):
        raise ValueError(f"K2p f32 attention kernel: qkv {tuple(qkv.shape)}"
                         f", {heads} heads, nu {nu}")
    f32 = torch.float32
    checks = [("qkv", qkv, f32, None), ("bias", bias, f32, (heads, n, n))]
    if mask is not None:
        checks.append(("mask", mask, f32, (nw - nu, n, n)))
    _require_all(checks, qkv.device)
    plan = k2p_f32_plan(b * nw, heads, n,
                        cuda_lib.sm_count(qkv.device.index or 0))
    out = torch.empty((b, nw, n, c), dtype=f32, device=qkv.device)
    err = cuda_lib.lib().lavt_k2p_attn_f32(
        qkv.data_ptr(), bias.data_ptr(),
        None if mask is None else mask.data_ptr(), out.data_ptr(), b * nw,
        nw, nu, heads, n, c, plan["blocks"], cuda_lib.stream_ptr(qkv.device))
    cuda_lib.check(err, "lavt_k2p_attn_f32")
    return out


def grouped_launches(x, wqkv, bqkv, wproj, bproj, bias, mask, nu: int,
                     heads: int, scale: float, wlo=None) -> torch.Tensor:
    """K2p's three launches, in order (csrc/window_msa_sm90.cu):
      (a) qkv = x Wqkvᵀ + bqkv, q scaled after its bias, bf16 (B nW n_p,
          3C), on the GEMM core (`gemm_bias`);
      (b) the attention on K10's kernel, q, k, v read from qkv by strides,
          scale 1 (q is scaled already), the mask grouping by nu, O as
          (B nW n_p, C) (`window_attn.attention_qkv_grouped`);
      (c) y = O Wprojᵀ + bproj on the GEMM core.
    K2p f32 is the same three launches on f32: (a) and (c) on the 3xTF32
    GEMM (`gemm_f32`, with wlo, (Wqkv's, Wproj's) lo parts, or split by
    launches of their own), (b) on its own attention launch
    (`grouped_attn_f32`).  On CPU tensors each launch takes its plain
    version, which compose to `fused_window_msa_grouped_plain`'s values
    (tests/test_torch_k2p_launches.py)."""
    from . import window_attn  # imports this module

    b, nw, n_p, c = x.shape
    rows = b * nw * n_p
    lo = (None, None) if wlo is None else wlo
    qkv = gemm_bias(x.reshape(rows, c), wqkv, bqkv, c, scale,
                    wlo=lo[0]).view(b, nw, n_p, 3 * c)
    if x.dtype == torch.float32:
        o = grouped_attn_f32(qkv, bias, mask, nu, heads)
    else:
        o = window_attn.attention_qkv_grouped(qkv, bias, mask, nu, heads, 1.0)
    return gemm_bias(o.view(rows, c), wproj, bproj,
                     wlo=lo[1]).view(b, nw, n_p, c)


def _grouped_launch(x, wqkv, bqkv, wproj, bproj, bias, mask, nu, heads,
                    scale, dtype=torch.bfloat16, wlo=None):
    """K2p's checks before any launch (every tensor `dtype`: bf16, or f32
    for K2p f32; the bias and mask f32), then `grouped_launches`."""
    b, nw, n_p, c = x.shape
    itemsize = 4 if dtype == torch.float32 else 2
    if not padded_msa_supported(n_p, c, heads, itemsize):
        raise ValueError(f"padded window MSA kernel: unsupported (n_p, C, "
                         f"heads) {(n_p, c, heads)} at {dtype}")
    if mask is None:
        nu = nw
    if not 0 <= nu <= nw:
        raise ValueError(f"padded window MSA kernel: nu {nu} outside [0, {nw}]")
    dt = dtype
    checks = [("x", x, dt, None), ("wqkv", wqkv, dt, (3 * c, c)),
              ("bqkv", bqkv, dt, (3 * c,)),
              ("wproj", wproj, dt, (c, c)), ("bproj", bproj, dt, (c,)),
              ("bias", bias, torch.float32, (heads, n_p, n_p))]
    if mask is not None:
        checks.append(("mask", mask, torch.float32, (nw - nu, n_p, n_p)))
    _require_all(checks, x.device)
    return grouped_launches(x, wqkv, bqkv, wproj, bproj, bias, mask, nu,
                            heads, scale, wlo)


def fused_window_msa_grouped(x, wqkv, bqkv, wproj, bproj, bias,
                             mask: Optional[torch.Tensor], nu: int,
                             heads: int, scale: float,
                             wlo=None) -> torch.Tensor:
    """K2p: (B, nW, n_p, C) padded post-LN windowed tokens ->
    projected attention.  bias: (h, n_p, n_p) from `pad_bias_sublane`;
    windows [0, nu) of each image take no mask, window w >= nu takes
    mask[w - nu] of the (nW - nu, n_p, n_p) mask (None: no window is
    masked).  On the card the three launches of `grouped_launches`, each
    covering both groups; one count per call.  A CUDA f32 x takes K2p f32
    (`fused_window_msa_grouped_f32`, with wlo, the weights' lo parts as
    `WeightLo.weight_lo` keeps them, or None)."""
    if x.device.type == "cpu":
        return fused_window_msa_grouped_plain(x, wqkv, bqkv, wproj, bproj,
                                              bias, mask, nu, heads, scale)
    if x.dtype == torch.float32:
        return fused_window_msa_grouped_f32(x, wqkv, bqkv, wproj, bproj, bias,
                                            mask, nu, heads, scale, wlo)
    y = _grouped_launch(x, wqkv, bqkv, wproj, bproj, bias, mask, nu, heads,
                        scale)
    fused_window_msa_grouped.launches += 1
    return y


def fused_window_msa_grouped_f32(x, wqkv, bqkv, wproj, bproj, bias,
                                 mask: Optional[torch.Tensor], nu: int,
                                 heads: int, scale: float,
                                 wlo=None) -> torch.Tensor:
    """K2p f32: K2p on f32 tokens and weights, n_p a multiple of 8 (392 at
    the video windows: no padding); on the card the launches of
    `grouped_launches` on f32 (the 3xTF32 GEMM, with wlo, (Wqkv's, Wproj's)
    lo parts, or split by a launch each; the attention launch
    `grouped_attn_f32`; the 3xTF32 GEMM), one count per call.  The
    attention is the exact max-subtracted softmax, where the TPU inference
    kernel takes the shift-free exp(min(s, 80)) (`_softmax_exp` of
    lavt_rs_tpu/ops/pallas/fused_msa.py): the two agree while every logit
    is at most 80.  The plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return fused_window_msa_grouped_plain(x, wqkv, bqkv, wproj, bproj,
                                              bias, mask, nu, heads, scale)
    y = _grouped_launch(x, wqkv, bqkv, wproj, bproj, bias, mask, nu, heads,
                        scale, torch.float32, wlo)
    fused_window_msa_grouped_f32.launches += 1
    return y


fused_window_msa_grouped.launches = 0
fused_window_msa_grouped_f32.launches = 0


def fused_window_msa_padded(x, wqkv, bqkv, wproj, bproj, bias,
                            mask: Optional[torch.Tensor], heads: int,
                            scale: float) -> torch.Tensor:
    """K2 for a window size that is not a multiple of 16 (JAX
    `fused_window_msa_padded`): x (B, nW, N, C), bias (h, N, N), mask
    (nW, N, N) or None.  Tokens are zero-padded to the sublane tile of x's
    dtype (`_sublane_pad`, as the JAX wrapper: 16 in bf16, 8 in f32), the
    padded keys are killed by the bias, the padded query rows are dropped;
    the call is K2p with no maskless prefix.  No path of the port calls it
    (the video route pads in its partition gather); it is kept for parity
    with the JAX package's API."""
    b, nw, n, c = x.shape
    n_p = _sublane_pad(n, x.element_size())
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
    master weights, runs the kernels on x's dtype (bf16 on the card, or
    f32: the save mode f32 with K5 f32, or K1 f32 / K2 f32 with K6 f32)
    and returns the weight grads in the weights' dtype; the mask gets
    none.  The taped forward takes the exact softmax, as JAX's `_vjp_fwd`
    / `_vjp_ln_fwd` do, so that K6's recomputed P is the one the output
    came from.  `wlo`: the f32 weights' lo parts (`window_msa`'s)."""

    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj, bias,
                mask, heads: int, scale: float, ln_eps: float = LN_EPS,
                flags=None, wlo=None):
        dt = x.dtype
        ln = None if ln_scale is None else (ln_scale.to(dt), ln_bias.to(dt))
        w = (wqkv.to(dt), bqkv.to(dt), wproj.to(dt), bproj.to(dt))
        b, nw, n, c = x.shape
        ctx.heads, ctx.scale, ctx.ln_eps = heads, scale, ln_eps
        ctx.has_ln = ln is not None
        ctx.dtypes = (wqkv.dtype, bqkv.dtype, wproj.dtype, bproj.dtype,
                      bias.dtype)
        ctx.resid = save_residuals_ok(b, nw, n, c, heads, x.element_size())
        ctx.flags, ctx.wlo = flags, wlo
        if ctx.resid:
            y, (q, k, v, p, xn) = fused_window_msa_save(
                x, ln, *w, bias, mask, heads, scale, ln_eps, flags, wlo)
            ctx.save_for_backward(x, ln_scale, w[0], w[2], q, k, v, p, xn)
        else:
            if ln is None:
                y = fused_window_msa(x, *w, bias, mask, heads, scale, flags,
                                     exact=True, wlo=wlo)
            else:
                y = fused_window_msa_ln(x, *ln, *w, bias, mask, heads, scale,
                                        ln_eps, flags, exact=True, wlo=wlo)
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
                eps, ctx.flags, ctx.wlo)
        dx, dwqkv, dbqkv, dwproj, dbproj, dbias = grads
        dls = dlb = None
        if ctx.has_ln:  # K4b's launch (f32: K4b f32's), counted as K5 / K6
            c = x.shape[-1]
            dx, dls, dlb = layer_norm_rows_bwd_launch(
                x.reshape(-1, c), ln_scale.float(), dx.reshape(-1, c), eps)
            dx = dx.view(x.shape)
            dls, dlb = dls.to(ln_scale.dtype), dlb.to(ln_scale.dtype)
        wq_t, bq_t, wp_t, bp_t, bias_t = ctx.dtypes
        return (dx, dls, dlb, dwqkv.to(wq_t), dbqkv.to(bq_t), dwproj.to(wp_t),
                dbproj.to(bp_t), dbias.to(bias_t), None, None, None, None,
                None, None)


def window_msa(x, ln, wqkv, bqkv, wproj, bproj, bias, mask, heads: int,
               scale: float, ln_eps: float = LN_EPS,
               flags: Optional[torch.Tensor] = None, wlo=None) -> torch.Tensor:
    """The model's entry: K1 (ln = (scale, bias)) or K2 on x's dtype.  With
    autograd recording a parameter, through `FusedWindowMSA`; else the
    forward kernel alone (nothing is saved).  `flags`: the mask's window
    flags (`window.shift_mask_flags_2d`), read by K1, K2 and the save
    mode; `wlo`: (wqkv's, wproj's) lo parts for the f32 kernels' GEMMs
    (`WindowAttention.weight_lo`), or None."""
    tensors = (x, wqkv, bqkv, wproj, bproj, bias) + tuple(ln or ())
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        ln_s, ln_b = ln if ln is not None else (None, None)
        return FusedWindowMSA.apply(x, ln_s, ln_b, wqkv, bqkv, wproj, bproj,
                                    bias, mask, heads, scale, ln_eps, flags,
                                    wlo)
    dt = x.dtype
    w = (wqkv.to(dt), bqkv.to(dt), wproj.to(dt), bproj.to(dt))
    if ln is None:
        return fused_window_msa(x, *w, bias, mask, heads, scale, flags,
                                wlo=wlo)
    return fused_window_msa_ln(x, ln[0].to(dt), ln[1].to(dt), *w, bias, mask,
                               heads, scale, ln_eps, flags, wlo=wlo)
