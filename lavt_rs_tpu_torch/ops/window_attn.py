"""Attention-only window attention on pre-projected heads (K10) and its
backward (K9).

Counterpart of `lavt_rs_tpu/ops/pallas/window_attn.py`:
`window_attention_pallas` (`_fwd`, `_fwd_kernel`) with its `custom_vjp`
(`_vjp_fwd`, `_vjp_bwd`) and `attention_core_bwd` (`_bwd_kernel`), and of
`lavt_rs_tpu/ops/attention.py`'s dispatcher: q, k, v are (B, nW, heads,
N, hd), the bias (heads, N, N) and the shift mask (nW, N, N) or None.
Every video Swin block reaches it between its `qkv` and `proj` Linears
(in training; at inference the first stage takes the grouped K2p route).

  * `window_attention_plain`: f32 math from the inputs: q·scale rounded
    to the input dtype, the scores, bias, mask and softmax in f32, P
    rounded to the input dtype before P·v, the output rounded once (the
    kernel's online softmax rounds exp(s - running max) and divides by
    the row sum after P·v: the same within that rounding);
  * `attention_core_bwd_plain`: the plain version of K9, the JAX kernel's
    f32 math (P recomputed, dS = P (dP - rowsum(do o))) with the kernel's
    rounding points;
  * `window_attention`: the plain version for a CPU tensor; for a CUDA
    tensor the kernel of csrc/window_attn.cu (bf16, head dim 32, any
    N <= 400), or it raises.  Where autograd records the call it goes
    through `WindowAttention`: K10 in save mode (the output and each row's
    log-sum-exp) forward and K9 backward on the card, the plain versions
    of both on the CPU (so the CPU tests run the plain backward, not
    autograd through the plain forward).

The JAX package routes its kernels only where N <= 256 (a TPU VMEM and
measurement gate, `_attn_tiling`); the port's kernels also take the
8-frame video windows (N = 392).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import cuda_lib
from .fused_msa import sum_partials

HEAD_DIM = 32
MAX_N = 400
# blocks the launch aims for (132 SMs at two blocks each, one wave)
_TARGET_BLOCKS = 264
_ROWS = 128  # query rows a block's 8 warps take at once
# K9's dbias partial slices, one (heads, N, N) f32 slice per window group:
# as many groups as fit this budget (one slice per window would be 597 MB
# at video stage 1)
_DBIAS_PART_BYTES = 32 * 2**20


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


def window_attn_supported(n: int, hd: int) -> bool:
    """Geometries the CUDA kernels take: head dim 32, 1 <= N <= 400."""
    return hd == HEAD_DIM and 1 <= n <= MAX_N


def _check(q, tensors, bias, mask):
    """Raise unless the kernels take q's geometry and every tensor is
    contiguous on q's device with the kernels' dtype and shape."""
    b, nw, heads, n, hd = q.shape
    if not window_attn_supported(n, hd):
        raise ValueError(f"window attention kernel: unsupported (N, hd) "
                         f"{(n, hd)}")
    checks = [(name, t, torch.bfloat16, q.shape) for name, t in tensors]
    checks.append(("bias", bias, torch.float32, (heads, n, n)))
    if mask is not None:
        checks.append(("mask", mask, torch.float32, (nw, n, n)))
    for name, t, dt, shape in checks:
        cuda_lib.require(t, name, dt, q.device, shape)
        if t.data_ptr() % 16:  # the kernels move 16-byte words
            raise ValueError(f"{name}: data must be 16-byte aligned")


def _splits(tiles: int, blocks: int) -> int:
    """grid.z: split a window's 16-row tiles (8 per block pass) until the
    launch has ~_TARGET_BLOCKS blocks."""
    return max(1, min(-(-tiles // 8), -(-_TARGET_BLOCKS // blocks)))


def _launch(q, k, v, bias, mask, scale, save: bool):
    b, nw, heads, n, _ = q.shape
    _check(q, (("q", q), ("k", k), ("v", v)), bias, mask)
    o = torch.empty_like(q)
    lse = (torch.empty((b, nw, heads, n), dtype=torch.float32,
                       device=q.device) if save else None)
    blocks = b * nw * heads
    tiles = -(-n // _ROWS)
    qsplit = max(1, min(tiles, -(-_TARGET_BLOCKS // blocks)))
    err = cuda_lib.lib().lavt_window_attn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
        None if mask is None else mask.data_ptr(), o.data_ptr(),
        None if lse is None else lse.data_ptr(), b * nw, nw,
        0 if mask is not None else nw, heads, n, qsplit, float(scale),
        cuda_lib.stream_ptr(q.device))
    cuda_lib.check(err, "lavt_window_attn")
    return o, lse


def _bwd_launch(q, k, v, bias, mask, do, scale, o, lse):
    """K9's launches (see csrc/window_attn.cu)."""
    b, nw, heads, n, _ = q.shape
    _check(q, (("q", q), ("k", k), ("v", v), ("o", o), ("do", do)), bias,
           mask)
    cuda_lib.require(lse, "lse", torch.float32, q.device, (b, nw, heads, n))
    bw = b * nw
    groups = max(1, min(bw, _DBIAS_PART_BYTES // (heads * n * n * 4)))
    tiles = -(-n // 16)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    dsum = torch.empty_like(lse)
    part = torch.empty((groups, heads, n, n), dtype=torch.float32,
                       device=q.device)
    err = cuda_lib.lib().lavt_window_attn_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), bias.data_ptr(),
        None if mask is None else mask.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), dsum.data_ptr(), part.data_ptr(), bw,
        nw, heads, n, groups, _splits(tiles, heads * groups),
        _splits(tiles, bw * heads), float(scale),
        cuda_lib.stream_ptr(q.device))
    cuda_lib.check(err, "lavt_window_attn_bwd")
    return dq, dk, dv, sum_partials(part)


def window_attention_save(q, k, v, bias, mask=None,
                          scale: Optional[float] = None):
    """K10 in save mode: (O, lse); the plain version on a CPU tensor."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if q.device.type == "cpu":
        return window_attention_save_plain(q, k, v, bias, mask, scale)
    out = _launch(q, k, v, bias, mask, scale, save=True)
    window_attention.launches += 1
    return out


def attention_core_bwd(q, k, v, bias, mask, do, scale: Optional[float] = None,
                       o: Optional[torch.Tensor] = None,
                       lse: Optional[torch.Tensor] = None):
    """K9: (dq, dk, dv, dbias) as `attention_core_bwd_plain`; the plain
    version on a CPU tensor, on a CUDA tensor the kernels, which take K10's
    saved output o and lse (where the JAX kernel recomputes o)."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if q.device.type == "cpu":
        return attention_core_bwd_plain(q, k, v, bias, mask, do, scale, o)
    if o is None or lse is None:
        raise ValueError("attention_core_bwd on the card needs K10's saved "
                         "output and lse (window_attention_save)")
    out = _bwd_launch(q, k, v, bias, mask, do, scale, o, lse)
    attention_core_bwd.launches += 1
    return out


class WindowAttention(torch.autograd.Function):
    """K10 in save mode forward, K9 backward (their plain versions on the
    CPU).  Saves K10's output and lse for K9, where the JAX VJP has its
    kernel recompute the output.  The bias and the mask are cast to f32
    and q, k, v made contiguous here; the grads come back in the inputs'
    dtypes, and the mask gets none."""

    @staticmethod
    def forward(ctx, q, k, v, bias, mask, scale: float):
        ctx.scale, ctx.bias_dtype = scale, bias.dtype
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
            lse)
        return dq, dk, dv, dbias.to(ctx.bias_dtype), None, None


def window_attention(q, k, v, bias, mask: Optional[torch.Tensor] = None,
                     scale: Optional[float] = None) -> torch.Tensor:
    """K10: softmax(q kᵀ·scale + bias + mask) v over windows; the plain
    version on a CPU tensor, the kernel on a CUDA tensor.  With autograd
    recording an input, through `WindowAttention` (K9 backward); else the
    forward alone (nothing is saved)."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v, bias)):
        return WindowAttention.apply(q, k, v, bias, mask, scale)
    if q.device.type == "cpu":
        return window_attention_plain(q, k, v, bias, mask, scale)
    out, _ = _launch(q, k, v, bias, mask, scale, save=False)
    window_attention.launches += 1
    return out


window_attention.launches = 0
attention_core_bwd.launches = 0
