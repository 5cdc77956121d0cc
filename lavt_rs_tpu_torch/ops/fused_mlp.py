"""Fused LayerNorm -> fc1 -> exact GELU -> fc2 -> residual (K3), its
DropPath variant (K8) and their backward (K7).

Counterpart of `lavt_rs_tpu/ops/pallas/fused_mlp.py`:
  * `fused_ln_mlp` (K3): out = x + fc2(gelu(fc1(LN(x))));
  * `fused_ln_mlp_droppath` (K8): out = x + keep[row // rows] * fc2(...),
    keep (B,) f32 the per-sample DropPath scale (0 or 1 / keep_prob);
  * `fused_ln_mlp_bwd` (K7, `_bwd` / `_bwd_hsplit`): dx, dgamma, dbeta,
    dW1, db1, dW2, db2, with or without keep;
  * `FusedLnMlp`, the autograd Function the model trains through.
The LayerNorm is the two-pass one (mean of (x − μ)², eps 1e-5) and the
GELU the exact erf one (the CUDA kernels evaluate erf as the TPU kernel
does, by Abramowitz & Stegun 7.1.26, within 1.5e-7).  The normalized rows
and the GELU output are rounded to x's dtype before their GEMMs, as in the
TPU kernel, and the backward rounds dmlp = gy keep and dhpre before
theirs.  Weights are torch `nn.Linear` layout: w1 (4C, C), w2 (C, 4C).

K3 f32 (`fused_ln_mlp_f32`) is K3 on f32 activations, as the TPU kernel
computes it there (its roundings to x.dtype are no-ops): the same three
launches, each taking its f32 kernel for an f32 tensor (the two-pass LN
rows of csrc/ln.cu, fc1 + GELU and fc2 + residual on the 3xTF32 GEMM of
csrc/gemm_f32.cu).  `fused_ln_mlp` takes it for a CUDA f32 tensor; K8 and
K7 have no f32 variant yet and raise on one.

Each wrapper takes the plain version for a CPU tensor and launches the
CUDA kernels (csrc/fused_mlp.cu, csrc/fused_mlp_bwd.cu, on the GEMM core of
csrc/gemm_sm90.cuh) for a CUDA tensor.  K3/K8 is three launches, each with
a wrapper and a plain version of its own here: `mlp_ln_rows` (the two-pass
LN), `gemm_bias_gelu` (fc1 + b1 + GELU), `gemm_residual` (fc2 + b2, keep,
+ x).  K7 is `mlp_bwd_prep` (xn, (mu, rstd), dmlp), `dual_gemm_gelu_bwd`
(h, dhpre and the db1 partials from one pass over hpre and dh), two
`wgrad` (dW2 = dmlp^T h, dW1 = dhpre^T xn, split over the rows), `dgrad`
(dyln = dhpre W1) and `ln_bwd_rows` (dx; dgamma, dbeta and db2 partials),
then the partials' fixed-order sums.  `bwd_plan` sizes the partials and
`bwd_buffers` cuts K7's buffers from two workspaces.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from . import cuda_lib
from .fused_msa import (GEMM_F32_GELU, GEMM_F32_RESIDUAL, gemm_f32,
                        sum_partials)
from .ln import layer_norm_rows_f32_launch

EPS = 1e-5
KERNEL_WIDTHS = (128, 256, 384, 512, 1024)
# f32 bytes of split partials of dW1 + dW2 the K7 launch may allocate
_DW_PARTIAL_BYTES = 64 * 1024 * 1024
GEMM_TILE = 128   # rows and columns of a plain product's tile (GEMM core)
DUAL_ROWS = 64    # rows of a dual-GEMM tile: the db1 partials
GEMM_DEPTH = 64   # rows of K in one pipeline stage (a k-tile)
LN_BWD_ROWS = 64  # rows per block of the LN-backward row kernel
_SMS = 132        # streaming multiprocessors of an H100 SXM


def _keep_rows(keep: Optional[torch.Tensor], rows: int):
    return None if keep is None else keep.float().repeat_interleave(rows)[:, None]


def _ln_two_pass(x, g, be, eps):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    xhat = (xf - mu) * rstd
    return xf, xhat, rstd, xhat * g.float() + be.float()


def _mlp_plain(x, g, be, w1, b1, w2, b2, eps, keep_rows):
    dt = x.dtype
    xf, _, _, xn = _ln_two_pass(x, g, be, eps)
    h = xn.to(dt).float() @ w1.float().t() + b1.float()
    h = F.gelu(h, approximate="none")
    y = h.to(dt).float() @ w2.float().t() + b2.float()
    if keep_rows is not None:
        y = y * keep_rows
    return (xf + y).to(dt)


def fused_ln_mlp_plain(x, g, be, w1, b1, w2, b2, eps: float = EPS):
    """x: (M, C) -> x + fc2(gelu(fc1(LN(x)))) in x.dtype; f32 math."""
    return _mlp_plain(x, g, be, w1, b1, w2, b2, eps, None)


def fused_ln_mlp_droppath_plain(x, g, be, w1, b1, w2, b2, keep, rows: int,
                                eps: float = EPS):
    """The plain version of K8: x (M, C) with M = B rows; keep (B,)."""
    return _mlp_plain(x, g, be, w1, b1, w2, b2, eps, _keep_rows(keep, rows))


def fused_ln_mlp_bwd_plain(x, gy, g, be, w1, b1, w2, keep=None, rows: int = 1,
                           eps: float = EPS):
    """The plain version of K7: (dx in x's dtype, dg, dbe, dw1, db1, dw2,
    db2), the parameter grads in f32 and torch layout."""
    dt = x.dtype
    _, xhat, rstd, xn = _ln_two_pass(x, g, be, eps)
    xn_c = xn.to(dt).float()
    hpre = xn_c @ w1.float().t() + b1.float()
    cdf = 0.5 * (1.0 + torch.erf(hpre * 2.0 ** -0.5))
    h = hpre * cdf
    gyf = gy.float()
    kr = _keep_rows(keep, rows)
    dmlp = gyf if kr is None else gyf * kr
    dmlp_c = dmlp.to(dt).float()
    dw2 = dmlp_c.t() @ h.to(dt).float()
    dh = dmlp_c @ w2.float()
    pdf = torch.exp(-0.5 * hpre * hpre) * 0.3989422804014327
    dhpre = dh * (cdf + hpre * pdf)
    dhpre_c = dhpre.to(dt).float()
    dw1 = dhpre_c.t() @ xn_c
    dyln = dhpre_c @ w1.float()
    dxhat = dyln * g.float()
    m1 = dxhat.mean(dim=-1, keepdim=True)
    m2 = (dxhat * xhat).mean(dim=-1, keepdim=True)
    dx = (gyf + rstd * (dxhat - m1 - xhat * m2)).to(dt)
    return (dx, (dyln * xhat).sum(0), dyln.sum(0), dw1, dhpre.sum(0), dw2,
            dmlp.sum(0))


def fused_ln_mlp_supported(m: int, c: int, hidden: int) -> bool:
    return m > 0 and c in KERNEL_WIDTHS and hidden % 128 == 0


def fused_tail_routed(c: int) -> bool:
    """Whether a 2D Swin block's LN -> MLP -> residual tail takes K3 (K8
    and K7 in training).  The JAX package's `fused_tail` test
    (`lavt_rs_tpu/models/swin2d.py:361-362`): C <= 512 and C % 128 == 0
    (128, 256, 384, 512); at 96, 192, 768 and 1536 it runs the XLA chain,
    and the port the torch chain (LN, fc1, exact GELU, fc2, residual).
    One extension: C = 1024 (Swin-B stage 4) also takes K3, as the port
    has since its first slice; the JAX package keeps it on XLA only
    because the weights overflow a TPU core's VMEM.  The JAX test's
    dropout clause holds in every config (Swin's drop_rate is 0, which
    the port requires)."""
    return (c <= 512 and c % 128 == 0) or c == 1024


def _check(x, params, keep, rows, dtype=torch.bfloat16) -> None:
    m, c = x.shape
    hidden = params[2].shape[0]
    if not fused_ln_mlp_supported(m, c, hidden):
        raise ValueError(f"fused_ln_mlp kernel: unsupported (M, C, hidden) "
                         f"{(m, c, hidden)}")
    g, be, w1, b1, w2 = params[:5]
    named = [("x", x, None), ("g", g, (c,)), ("be", be, (c,)),
             ("w1", w1, (hidden, c)), ("b1", b1, (hidden,)),
             ("w2", w2, (c, hidden))]
    if len(params) > 5:
        named.append(("b2", params[5], (c,)))
    _require_typed(named, x.device, dtype)
    _require_keep(keep, m, rows, x.device)


def _require_keep(keep, m: int, rows: int, device) -> None:
    """keep, when given: (M / rows,) f32, one scale per sample of rows."""
    if keep is not None:
        if rows <= 0 or m % rows:
            raise ValueError(f"keep: {m} rows are not samples of {rows}")
        cuda_lib.require(keep, "keep", torch.float32, device, (m // rows,))


def _require_typed(named, device, dtype=torch.bfloat16) -> None:
    """Contiguous tensors of `dtype` (bf16; f32 for K3 f32) on `device` (of
    the given shapes), 16-byte aligned: TMA and cp.async read the GEMM
    operands, the row kernels read pairs or 16-byte words."""
    for name, t, shape in named:
        cuda_lib.require(t, name, dtype, device, shape)
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: data is not aligned for the kernel")


def _launch(name: str, *args) -> None:
    """Call the C entry point `name` on the current stream: tensors (and
    None) as pointers, the rest as they are."""
    dev = next(a.device for a in args if isinstance(a, torch.Tensor))
    conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    err = getattr(cuda_lib.lib(), name)(*conv, cuda_lib.stream_ptr(dev))
    cuda_lib.check(err, name)


def _supported(m: int, c: int, hidden: int) -> None:
    if not fused_ln_mlp_supported(m, c, hidden):
        raise ValueError(f"LN-MLP kernels: unsupported (M, C, hidden) "
                         f"{(m, c, hidden)}")


# -- K3 / K8: the three launches and their plain versions --------------------

def mlp_ln_rows_plain(x, g, be, eps: float = EPS):
    """(a): the two-pass LayerNorm of x's rows, in x's dtype."""
    return _ln_two_pass(x, g, be, eps)[3].to(x.dtype)


def gemm_bias_gelu_plain(xn, w1, b1):
    """(b): h = gelu(xn W1^T + b1) in xn's dtype, f32 math."""
    hpre = xn.float() @ w1.float().t() + b1.float()
    return F.gelu(hpre, approximate="none").to(xn.dtype)


def gemm_residual_plain(h, w2, b2, x, keep=None, rows: int = 1):
    """(c): x + keep[row // rows] (h W2^T + b2) in x's dtype, f32 math."""
    y = h.float() @ w2.float().t() + b2.float()
    kr = _keep_rows(keep, rows)
    return (x.float() + (y if kr is None else y * kr)).to(x.dtype)


def mlp_ln_rows(x, g, be, eps: float = EPS):
    """(a) on the card: x (M, C) bf16 -> xn (M, C) bf16 (f32 -> f32 on K3
    f32's two-pass LN rows)."""
    if x.device.type == "cpu":
        return mlp_ln_rows_plain(x, g, be, eps)
    m, c = x.shape
    _supported(m, c, GEMM_TILE)
    if x.dtype == torch.float32:
        return layer_norm_rows_f32_launch(x, g, be, eps, two_pass=True)
    _require_typed([("x", x, None), ("g", g, (c,)), ("be", be, (c,))],
                  x.device)
    xn = torch.empty_like(x)
    _launch("lavt_mlp_ln_rows", x, g, be, xn, m, c, float(eps))
    return xn


def gemm_bias_gelu(xn, w1, b1):
    """(b) on the card: xn (M, C), w1 (hidden, C) -> h (M, hidden) bf16
    (f32 -> f32 on the 3xTF32 GEMM)."""
    if xn.device.type == "cpu":
        return gemm_bias_gelu_plain(xn, w1, b1)
    (m, c), hidden = xn.shape, w1.shape[0]
    _supported(m, c, hidden)
    if xn.dtype == torch.float32:
        return gemm_f32(xn, w1, b1, GEMM_F32_GELU)
    _require_typed([("xn", xn, None), ("w1", w1, (hidden, c)),
                   ("b1", b1, (hidden,))], xn.device)
    h = torch.empty((m, hidden), dtype=xn.dtype, device=xn.device)
    _launch("lavt_gemm_bias_gelu", xn, w1, b1, h, m, c, hidden)
    return h


def gemm_residual(h, w2, b2, x, keep=None, rows: int = 1):
    """(c) on the card: h (M, hidden), w2 (C, hidden), x (M, C) -> out
    (f32 -> f32 on the 3xTF32 GEMM, without keep: K8 has no f32 variant
    yet)."""
    if h.device.type == "cpu":
        return gemm_residual_plain(h, w2, b2, x, keep, rows)
    (c, hidden), m = w2.shape, x.shape[0]
    _supported(m, c, hidden)
    if h.dtype == torch.float32:
        if keep is not None:
            raise NotImplementedError("K8 (keep) has no f32 variant yet "
                                      "(ROADMAP.md queue 2)")
        return gemm_f32(h, w2, b2, GEMM_F32_RESIDUAL, res=x)
    _require_typed([("h", h, (m, hidden)), ("w2", w2, None), ("b2", b2, (c,)),
                   ("x", x, (m, c))], x.device)
    _require_keep(keep, m, rows, x.device)
    out = torch.empty_like(x)
    _launch("lavt_gemm_residual", h, w2, b2, x, keep, out, m, c, hidden,
            max(rows, 1))
    return out


# -- K7: the launches and their plain versions ---------------------------------

class BwdPlan(NamedTuple):
    """The partial sums one K7 call writes (M rows, width C, hidden)."""
    row_tiles: int    # DUAL_ROWS-row tiles over M: the db1 partials
    splits: int       # splits over M of the weight-grad GEMMs
    split_tiles: int  # k-tiles (GEMM_DEPTH rows of M) of each split
    ln_blocks: int    # LN_BWD_ROWS-row blocks: the dgamma/dbeta partials

    @property
    def split_rows(self) -> int:
        return self.split_tiles * GEMM_DEPTH


def wgrad_split_tiles(m: int, na: int, nb: int, gemms: int = 1) -> int:
    """The k-tiles (GEMM_DEPTH rows of M) of each split over M of `gemms`
    weight-grad GEMMs (`wgrad`) of (Na, Nb) outputs: as many splits as
    leave each of the two consumers of every SM one output tile of one of
    them (no split when the tiles alone fill them), no more than their f32
    partials fit in `_DW_PARTIAL_BYTES`, no empty split.  K7's dW1/dW2 and
    K5's dWqkv/dWproj (ops/fused_msa.py) split by this rule."""
    k_tiles = -(-m // GEMM_DEPTH)
    tiles = -(-na // GEMM_TILE) * -(-nb // GEMM_TILE)
    cap = _DW_PARTIAL_BYTES // (4 * na * nb * gemms)
    splits = max(1, min(2 * _SMS // tiles, cap, k_tiles))
    return -(-k_tiles // splits)


def bwd_plan(m: int, c: int, hidden: int) -> BwdPlan:
    """dW1 and dW2 split over M by `wgrad_split_tiles`."""
    k_tiles = -(-m // GEMM_DEPTH)
    split_tiles = wgrad_split_tiles(m, hidden, c, gemms=2)
    return BwdPlan(-(-m // DUAL_ROWS), -(-k_tiles // split_tiles), split_tiles,
                   -(-m // LN_BWD_ROWS))


def _row_block_sums(t, rows: int):
    """(M, N) f32 -> (ceil(M / rows), N): the sums over each block of rows."""
    pad = (-t.shape[0]) % rows
    return F.pad(t, (0, 0, 0, pad)).view(-1, rows, t.shape[1]).sum(1)


def mlp_bwd_prep_plain(x, gy, g, be, keep=None, rows: int = 1,
                       eps: float = EPS):
    """(a): xn (x's dtype), stats (M, 2) f32 = (mu, rstd) of each row,
    dmlp = gy keep[row // rows] in x's dtype."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt((xf - mu).square().mean(dim=-1, keepdim=True) + eps)
    xn = (xf - mu) * rstd * g.float() + be.float()
    kr = _keep_rows(keep, rows)
    dm = gy.float() if kr is None else gy.float() * kr
    return xn.to(x.dtype), torch.cat([mu, rstd], 1), dm.to(x.dtype)


def dual_gemm_gelu_bwd_plain(xn, dmlp, w1, b1, w2):
    """(b): hpre = xn W1^T + b1 (f32), h = gelu(hpre) and dhpre = (dmlp W2)
    gelu'(hpre) in xn's dtype, and db1_part (ceil(M / 64), hidden): each
    64-row tile's column sums of the f32 dhpre."""
    hpre = xn.float() @ w1.float().t() + b1.float()
    cdf = 0.5 * (1.0 + torch.erf(hpre * 2.0 ** -0.5))
    pdf = torch.exp(-0.5 * hpre * hpre) * 0.3989422804014327
    dhpre = (dmlp.float() @ w2.float()) * (cdf + hpre * pdf)
    return ((hpre * cdf).to(xn.dtype), dhpre.to(xn.dtype),
            _row_block_sums(dhpre, DUAL_ROWS))


def wgrad_plain(a, b, split_rows: int):
    """(c): (splits, Na, Nb) f32, split s = a[rows]^T b[rows] over rows
    [s split_rows, (s + 1) split_rows) of a (M, Na) and b (M, Nb)."""
    return torch.stack([a[i:i + split_rows].float().t()
                        @ b[i:i + split_rows].float()
                        for i in range(0, a.shape[0], split_rows)])


def dgrad_plain(dhpre, w1):
    """(d): dyln = dhpre W1, (M, C) f32."""
    return dhpre.float() @ w1.float()


def ln_bwd_rows_plain(dyln, x, gy, g, stats, keep=None, rows: int = 1):
    """(e): dx = gy + LN backward of dyln (x's dtype), and part
    (ceil(M / 64), 3, C): each 64-row block's column sums of dyln xhat,
    dyln and gy keep[row // rows] (the dgamma, dbeta and db2 partials)."""
    mu, rstd = stats[:, :1], stats[:, 1:]
    xhat = (x.float() - mu) * rstd
    dxhat = dyln * g.float()
    m1 = dxhat.mean(dim=-1, keepdim=True)
    m2 = (dxhat * xhat).mean(dim=-1, keepdim=True)
    dx = (gy.float() + rstd * (dxhat - m1 - xhat * m2)).to(x.dtype)
    kr = _keep_rows(keep, rows)
    dmlp = gy.float() if kr is None else gy.float() * kr
    return dx, torch.stack([_row_block_sums(t, LN_BWD_ROWS)
                            for t in (dyln * xhat, dyln, dmlp)], 1)


def mlp_bwd_prep(x, gy, g, be, keep=None, rows: int = 1, eps: float = EPS):
    """(a) on the card."""
    if x.device.type == "cpu":
        return mlp_bwd_prep_plain(x, gy, g, be, keep, rows, eps)
    m, c = x.shape
    _supported(m, c, GEMM_TILE)
    _require_typed([("x", x, None), ("gy", gy, (m, c)), ("g", g, (c,)),
                   ("be", be, (c,))], x.device)
    _require_keep(keep, m, rows, x.device)
    xn, dm = torch.empty_like(x), torch.empty_like(x)
    stats = torch.empty((m, 2), dtype=torch.float32, device=x.device)
    _launch("lavt_mlp_bwd_prep", x, gy, g, be, keep, xn, stats, dm, m, c,
            max(rows, 1), float(eps))
    return xn, stats, dm


def dual_gemm_gelu_bwd(xn, dmlp, w1, b1, w2):
    """(b) on the card."""
    if xn.device.type == "cpu":
        return dual_gemm_gelu_bwd_plain(xn, dmlp, w1, b1, w2)
    (m, c), hidden = xn.shape, w1.shape[0]
    _supported(m, c, hidden)
    _require_typed([("xn", xn, None), ("dmlp", dmlp, (m, c)),
                   ("w1", w1, (hidden, c)), ("b1", b1, (hidden,)),
                   ("w2", w2, (c, hidden))], xn.device)
    h, dhpre = (torch.empty((m, hidden), dtype=xn.dtype, device=xn.device)
                for _ in range(2))
    db1_part = torch.empty((-(-m // DUAL_ROWS), hidden), dtype=torch.float32,
                           device=xn.device)
    _launch("lavt_dual_gemm_gelu_bwd", xn, dmlp, w1, b1, w2, h, dhpre,
            db1_part, m, c, hidden)
    return h, dhpre, db1_part


def wgrad(a, b, split_rows: int):
    """(c) on the card: a (M, Na), b (M, Nb) bf16, Na and Nb multiples of
    8 (a last tile of fewer than 128 columns is not stored past Nb),
    split_rows a multiple of 64.  Also K5's dWqkv = dqkvᵀ x and dWproj =
    gyᵀ o."""
    if a.device.type == "cpu":
        return wgrad_plain(a, b, split_rows)
    m, na = a.shape
    nb = b.shape[1]
    if (na % 8 or nb % 8 or split_rows % GEMM_DEPTH or split_rows < 1
            or m < 1):
        raise ValueError(f"wgrad: unsupported (M, Na, Nb, split rows) "
                         f"{(m, na, nb, split_rows)}")
    _require_typed([("a", a, None), ("b", b, (m, nb))], a.device)
    splits = -(-m // split_rows)
    part = torch.empty((splits, na, nb), dtype=torch.float32, device=a.device)
    _launch("lavt_wgrad", a, b, part, m, na, nb, splits,
            split_rows // GEMM_DEPTH)
    return part


def dgrad(dhpre, w1):
    """(d) on the card: dhpre (M, hidden), w1 (hidden, C) -> (M, C) f32."""
    if dhpre.device.type == "cpu":
        return dgrad_plain(dhpre, w1)
    (hidden, c), m = w1.shape, dhpre.shape[0]
    _supported(m, c, hidden)
    _require_typed([("dhpre", dhpre, (m, hidden)), ("w1", w1, None)],
                  dhpre.device)
    dyln = torch.empty((m, c), dtype=torch.float32, device=dhpre.device)
    _launch("lavt_dgrad", dhpre, w1, dyln, m, c, hidden)
    return dyln


def ln_bwd_rows(dyln, x, gy, g, stats, keep=None, rows: int = 1):
    """(e) on the card."""
    if x.device.type == "cpu":
        return ln_bwd_rows_plain(dyln, x, gy, g, stats, keep, rows)
    m, c = x.shape
    _supported(m, c, GEMM_TILE)
    _require_typed([("x", x, None), ("gy", gy, (m, c)), ("g", g, (c,))],
                  x.device)
    cuda_lib.require(dyln, "dyln", torch.float32, x.device, (m, c))
    cuda_lib.require(stats, "stats", torch.float32, x.device, (m, 2))
    _require_keep(keep, m, rows, x.device)
    dx = torch.empty_like(x)
    part = torch.empty((-(-m // LN_BWD_ROWS), 3, c), dtype=torch.float32,
                       device=x.device)
    _launch("lavt_ln_bwd_rows", dyln, x, gy, g, keep, max(rows, 1), stats, dx,
            part, m, c)
    return dx, part


# -- K3 / K8 / K7: the entry points ------------------------------------------

def _fwd_launch(x, g, be, w1, b1, w2, b2, eps, keep, rows):
    _check(x, (g, be, w1, b1, w2, b2), keep, rows)
    m, c = x.shape
    hidden = w1.shape[0]
    xn, out = torch.empty_like(x), torch.empty_like(x)
    h = torch.empty((m, hidden), dtype=x.dtype, device=x.device)
    _launch("lavt_fused_ln_mlp", x, g, be, w1, b1, w2, b2, keep, xn, h, out,
            m, c, hidden, max(rows, 1), float(eps))
    return out


def fused_ln_mlp(x, g, be, w1, b1, w2, b2, eps: float = EPS):
    """K3: x (M, C) bf16 tokens -> x + fc2(gelu(fc1(LN(x)))) in bf16; f32
    tokens on the card take K3 f32 (`fused_ln_mlp_f32`)."""
    if x.device.type == "cpu":
        return fused_ln_mlp_plain(x, g, be, w1, b1, w2, b2, eps)
    if x.dtype == torch.float32:
        return fused_ln_mlp_f32(x, g, be, w1, b1, w2, b2, eps)
    out = _fwd_launch(x, g, be, w1, b1, w2, b2, eps, None, 0)
    fused_ln_mlp.launches += 1
    return out


def fused_ln_mlp_f32(x, g, be, w1, b1, w2, b2, eps: float = EPS):
    """K3 f32: x (M, C) f32 tokens and f32 weights -> x + fc2(gelu(fc1(
    LN(x)))) in f32; on the card the three launches (`mlp_ln_rows`,
    `gemm_bias_gelu`, `gemm_residual`) on their f32 kernels, the plain
    version on a CPU tensor."""
    if x.device.type == "cpu":
        return fused_ln_mlp_plain(x, g, be, w1, b1, w2, b2, eps)
    _check(x, (g, be, w1, b1, w2, b2), None, 0, torch.float32)
    xn = mlp_ln_rows(x, g, be, eps)
    out = gemm_residual(gemm_bias_gelu(xn, w1, b1), w2, b2, x)
    fused_ln_mlp_f32.launches += 1
    return out


def fused_ln_mlp_droppath(x, g, be, w1, b1, w2, b2, keep, rows: int,
                          eps: float = EPS):
    """K8: x (M, C) bf16 with M = B rows, keep (B,) f32 -> x + keep[sample]
    fc2(gelu(fc1(LN(x)))) in bf16."""
    if x.device.type == "cpu":
        return fused_ln_mlp_droppath_plain(x, g, be, w1, b1, w2, b2, keep,
                                           rows, eps)
    out = _fwd_launch(x, g, be, w1, b1, w2, b2, eps, keep, rows)
    fused_ln_mlp_droppath.launches += 1
    return out


def bwd_buffers(m: int, c: int, hidden: int, device,
                dtype=torch.bfloat16) -> dict:
    """Every buffer one K7 call writes, in the order `lavt_mlp_bwd` takes
    them: the (M, C) / (M, hidden) intermediates, cut from one bf16 and
    one f32 workspace (every piece a multiple of 16 bytes, so each starts
    aligned for TMA), dx, and the f32 partials that `bwd_plan` sizes:
    db1 (row tiles, hidden), dW1 and dW2 (splits, 2, hidden C; their own
    allocation: with one split the grads are views of it), dgamma, dbeta
    and db2 (LN blocks, 3, C)."""
    plan = bwd_plan(m, c, hidden)
    half = {"xn": (m, c), "dmlp": (m, c), "h": (m, hidden),
            "dhpre": (m, hidden)}
    full = {"dyln": (m, c), "db1_part": (plan.row_tiles, hidden),
            "ln_part": (plan.ln_blocks, 3, c), "stats": (m, 2)}
    buf = {}
    for shapes, dt in ((half, dtype), (full, torch.float32)):
        sizes = [math.prod(sh) for sh in shapes.values()]
        ws = torch.empty(sum(sizes), dtype=dt, device=device)
        for (name, shape), piece in zip(shapes.items(), ws.split(sizes)):
            buf[name] = piece.view(shape)
    buf["dx"] = torch.empty((m, c), dtype=dtype, device=device)
    buf["dw_part"] = torch.empty((plan.splits, 2, hidden * c),
                                 dtype=torch.float32, device=device)
    return {k: buf[k] for k in ("xn", "dmlp", "h", "dhpre", "dx", "dyln",
                                "db1_part", "dw_part", "ln_part", "stats")}


def _bwd_launch(x, gy, g, be, w1, b1, w2, keep, rows, eps):
    _check(x, (g, be, w1, b1, w2), keep, rows)
    cuda_lib.require(gy, "gy", torch.bfloat16, x.device, x.shape)
    m, c = x.shape
    hidden = w1.shape[0]
    plan = bwd_plan(m, c, hidden)
    buf = bwd_buffers(m, c, hidden, x.device, x.dtype)
    _launch("lavt_mlp_bwd", x, gy, g, be, w1, b1, w2, keep, max(rows, 1),
            *buf.values(), m, c, hidden, plan.splits, plan.split_tiles,
            float(eps))
    dw = sum_partials(buf["dw_part"])
    ln = sum_partials(buf["ln_part"])
    return (buf["dx"], ln[0], ln[1], dw[0].view(hidden, c),
            sum_partials(buf["db1_part"]), dw[1].view(c, hidden), ln[2])


def fused_ln_mlp_bwd(x, gy, g, be, w1, b1, w2, keep=None, rows: int = 0,
                     eps: float = EPS):
    """K7: the backward of K3 (keep None) or K8."""
    if x.device.type == "cpu":
        return fused_ln_mlp_bwd_plain(x, gy, g, be, w1, b1, w2, keep,
                                      max(rows, 1), eps)
    out = _bwd_launch(x, gy, g, be, w1, b1, w2, keep, rows, eps)
    fused_ln_mlp_bwd.launches += 1
    return out


fused_ln_mlp.launches = 0
fused_ln_mlp_f32.launches = 0
fused_ln_mlp_droppath.launches = 0
fused_ln_mlp_bwd.launches = 0


class FusedLnMlp(torch.autograd.Function):
    """K3 (keep None) / K8 with the K7 backward.  Takes the f32 master
    weights, runs the kernels on x's dtype and returns the parameter
    grads in their dtypes; keep gets none."""

    @staticmethod
    def forward(ctx, x, g, be, w1, b1, w2, b2, keep, rows: int,
                eps: float = EPS):
        dt = x.dtype
        p = tuple(t.to(dt) for t in (g, be, w1, b1, w2, b2))
        ctx.rows, ctx.eps = rows, eps
        ctx.dtypes = tuple(t.dtype for t in (g, be, w1, b1, w2, b2))
        ctx.save_for_backward(x, *p[:5], keep)
        if keep is None:
            return fused_ln_mlp(x, *p, eps)
        return fused_ln_mlp_droppath(x, *p, keep, rows, eps)

    @staticmethod
    def backward(ctx, gy):
        x, g, be, w1, b1, w2, keep = ctx.saved_tensors
        dx, *grads = fused_ln_mlp_bwd(x, gy.contiguous(), g, be, w1, b1, w2,
                                      keep, ctx.rows, ctx.eps)
        dg, dbe, dw1, db1, dw2, db2 = (t.to(d) for t, d in
                                       zip(grads, ctx.dtypes))
        return dx, dg, dbe, dw1, db1, dw2, db2, None, None, None


def ln_mlp(x, g, be, w1, b1, w2, b2, keep: Optional[torch.Tensor] = None,
           rows: int = 0, eps: float = EPS) -> torch.Tensor:
    """The model's entry: K3, or K8 with a per-sample keep, on x's dtype.
    With autograd recording a parameter, through `FusedLnMlp`; else the
    forward kernel alone."""
    tensors = (x, g, be, w1, b1, w2, b2)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return FusedLnMlp.apply(x, g, be, w1, b1, w2, b2, keep, rows, eps)
    dt = x.dtype
    p = tuple(t.to(dt) for t in (g, be, w1, b1, w2, b2))
    if keep is None:
        return fused_ln_mlp(x, *p, eps)
    return fused_ln_mlp_droppath(x, *p, keep, rows, eps)
