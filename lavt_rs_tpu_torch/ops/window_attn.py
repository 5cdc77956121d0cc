"""Attention-only window attention on pre-projected heads (K10).

Counterpart of `lavt_rs_tpu/ops/pallas/window_attn.py:window_attention_pallas`
(`_fwd`, `_fwd_kernel`) and of `lavt_rs_tpu/ops/attention.py`'s
dispatcher: q, k, v are (B, nW, heads, N, hd), the bias (heads, N, N)
and the shift mask (nW, N, N) or None.  The video backbone's stages 2-4
reach it between their `qkv` and `proj` Linears.

  * `window_attention_plain`: f32 math from the inputs: q·scale rounded
    to the input dtype, the scores, bias, mask and softmax in f32, P
    rounded to the input dtype before P·v, the output rounded once (the
    kernel's online softmax rounds exp(s - running max) and divides by
    the row sum after P·v: the same within that rounding);
  * `window_attention`: the plain version for a CPU tensor; for a CUDA
    tensor the kernel of csrc/window_attn.cu (bf16, head dim 32, any
    N <= 400), or it raises.

The JAX package routes its kernel only where N <= 256 (a TPU VMEM and
measurement gate, `_attn_tiling`); the port's kernel also takes the
8-frame video windows (N = 392).
"""

from __future__ import annotations

from typing import Optional

import torch

from . import cuda_lib

HEAD_DIM = 32
MAX_N = 400
# blocks the launch aims for (132 SMs at two blocks each, one wave)
_TARGET_BLOCKS = 264
_ROWS = 128  # query rows a block's 8 warps take at once


def window_attention_plain(q, k, v, bias, mask: Optional[torch.Tensor] = None,
                           scale: Optional[float] = None) -> torch.Tensor:
    """The plain version of K10.  Returns (B, nW, heads, N, hd) in q's
    dtype."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    dt = q.dtype
    qs = (q.float() * scale).to(dt)
    s = qs.float() @ k.float().transpose(-1, -2) + bias.float()
    if mask is not None:
        s = s + mask.float()[None, :, None]
    p = torch.softmax(s, dim=-1).to(dt)
    return (p.float() @ v.float()).to(dt)


def window_attn_supported(n: int, hd: int) -> bool:
    """Geometries the CUDA kernel takes: head dim 32, 1 <= N <= 400."""
    return hd == HEAD_DIM and 1 <= n <= MAX_N


def _launch(q, k, v, bias, mask, scale) -> torch.Tensor:
    b, nw, heads, n, hd = q.shape
    if not window_attn_supported(n, hd):
        raise ValueError(f"window attention kernel: unsupported (N, hd) "
                         f"{(n, hd)}")
    dev = q.device
    bf16 = torch.bfloat16
    checks = [("q", q, bf16, None), ("k", k, bf16, q.shape),
              ("v", v, bf16, q.shape),
              ("bias", bias, torch.float32, (heads, n, n))]
    if mask is not None:
        checks.append(("mask", mask, torch.float32, (nw, n, n)))
    for name, t, dt, shape in checks:
        cuda_lib.require(t, name, dt, dev, shape)
        if t.data_ptr() % 16:  # the kernel moves 16-byte words
            raise ValueError(f"{name}: data must be 16-byte aligned")
    o = torch.empty_like(q)
    blocks = b * nw * heads
    tiles = -(-n // _ROWS)
    qsplit = max(1, min(tiles, -(-_TARGET_BLOCKS // blocks)))
    err = cuda_lib.lib().lavt_window_attn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
        None if mask is None else mask.data_ptr(), o.data_ptr(), b * nw, nw,
        0 if mask is not None else nw, heads, n, qsplit, float(scale),
        cuda_lib.stream_ptr(dev))
    cuda_lib.check(err, "lavt_window_attn")
    return o


def window_attention(q, k, v, bias, mask: Optional[torch.Tensor] = None,
                     scale: Optional[float] = None) -> torch.Tensor:
    """K10: softmax(q kᵀ·scale + bias + mask) v over windows; the plain
    version on a CPU tensor, the kernel on a CUDA tensor."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if q.device.type == "cpu":
        return window_attention_plain(q, k, v, bias, mask, scale)
    out = _launch(q, k, v, bias, mask, scale)
    window_attention.launches += 1
    return out


window_attention.launches = 0
