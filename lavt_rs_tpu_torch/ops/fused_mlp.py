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
GELU the exact erf one.  The normalized rows and the GELU output are
rounded to x's dtype before their GEMMs, as in the TPU kernel, and the
backward rounds dmlp = gy keep and dhpre before theirs.  Weights are
torch `nn.Linear` layout: w1 (4C, C), w2 (C, 4C).

Each wrapper takes the plain version for a CPU tensor and launches the
CUDA kernels (csrc/fused_mlp.cu, csrc/fused_mlp_bwd.cu) for a CUDA tensor.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import cuda_lib
from .fused_msa import colsum, sum_partials

EPS = 1e-5
KERNEL_WIDTHS = (128, 256, 384, 512, 1024)
# f32 bytes of split partials of dW1 + dW2 the K7 launch may allocate
_DW_PARTIAL_BYTES = 64 * 1024 * 1024


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


def _check(x, params, keep, rows) -> None:
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
    for name, t, shape in named:
        cuda_lib.require(t, name, torch.bfloat16, x.device, shape)
        # 16-byte vector loads; WMMA reads the weights in 32-byte rows
        if t.data_ptr() % (32 if name in ("w1", "w2") else 16):
            raise ValueError(f"{name}: data is not aligned for the kernel")
    if keep is not None:
        if rows <= 0 or m % rows:
            raise ValueError(f"keep: {m} rows are not samples of {rows}")
        cuda_lib.require(keep, "keep", torch.float32, x.device, (m // rows,))


def _fwd_launch(x, g, be, w1, b1, w2, b2, eps, keep, rows):
    _check(x, (g, be, w1, b1, w2, b2), keep, rows)
    m, c = x.shape
    out = torch.empty_like(x)
    err = cuda_lib.lib().lavt_fused_ln_mlp(
        x.data_ptr(), g.data_ptr(), be.data_ptr(), w1.data_ptr(),
        b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        None if keep is None else keep.data_ptr(), out.data_ptr(), m, c,
        w1.shape[0], max(rows, 1), float(eps), cuda_lib.stream_ptr(x.device))
    cuda_lib.check(err, "lavt_fused_ln_mlp")
    return out


def fused_ln_mlp(x, g, be, w1, b1, w2, b2, eps: float = EPS):
    """K3: x (M, C) bf16 tokens -> x + fc2(gelu(fc1(LN(x)))) in bf16."""
    if x.device.type == "cpu":
        return fused_ln_mlp_plain(x, g, be, w1, b1, w2, b2, eps)
    out = _fwd_launch(x, g, be, w1, b1, w2, b2, eps, None, 0)
    fused_ln_mlp.launches += 1
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


def _bwd_launch(x, gy, g, be, w1, b1, w2, keep, rows, eps):
    _check(x, (g, be, w1, b1, w2), keep, rows)
    cuda_lib.require(gy, "gy", torch.bfloat16, x.device, x.shape)
    m, c = x.shape
    hidden = w1.shape[0]
    dev = x.device
    lib = cuda_lib.lib()
    f32 = torch.float32
    n_dx = -(-m // lib.lavt_mlp_bwd_rows(c, 0))
    tiles = -(-m // lib.lavt_mlp_bwd_rows(c, 1))
    splits = max(1, min(tiles, -(-264 // (hidden // 64)),
                        _DW_PARTIAL_BYTES // (8 * hidden * c)))
    dx = torch.empty_like(x)
    dg_part, dbe_part = (torch.empty((n_dx, c), dtype=f32, device=dev)
                         for _ in range(2))
    dw1_part = torch.empty((splits, hidden, c), dtype=f32, device=dev)
    dw2_part = torch.empty((splits, c, hidden), dtype=f32, device=dev)
    db1_part = torch.empty((splits, hidden), dtype=f32, device=dev)
    xn_buf, dm_buf = torch.empty_like(x), torch.empty_like(x)  # bf16 xn, dmlp
    err = lib.lavt_mlp_bwd(
        x.data_ptr(), gy.data_ptr(), g.data_ptr(), be.data_ptr(),
        w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        None if keep is None else keep.data_ptr(), max(rows, 1), dx.data_ptr(),
        dg_part.data_ptr(), dbe_part.data_ptr(), dw1_part.data_ptr(),
        dw2_part.data_ptr(), db1_part.data_ptr(), xn_buf.data_ptr(),
        dm_buf.data_ptr(), m, c, hidden, splits, float(eps),
        cuda_lib.stream_ptr(dev))
    cuda_lib.check(err, "lavt_mlp_bwd")
    return (dx, sum_partials(dg_part), sum_partials(dbe_part),
            sum_partials(dw1_part), sum_partials(db1_part),
            sum_partials(dw2_part), colsum(gy, keep, rows))


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
