"""Fused window MSA: qkv projection + attention + out-projection (K1/K2).

Counterpart of `lavt_rs_tpu/ops/pallas/fused_msa.py`:
  * `fused_window_msa` (K2): x is post-LN windowed tokens;
  * `fused_window_msa_ln` (K1): x is pre-LN tokens and the block's
    pre-attention LayerNorm (f32 stats, fast variance) runs inside the
    kernel.  Valid only where windowing needed no padding: the model pads
    after LN, and LN of a zero pad row would give ln_bias.

x is (B, nW, N, C) windowed tokens; weights are torch `nn.Linear` layout:
wqkv (3C, C), bqkv (3C,), wproj (C, C), bproj (C,); bias (h, N, N) f32
relative-position bias; mask (nW, N, N) f32 shift mask or None.  q is
scaled after its bias; q, k, v, the probabilities and the attention
output are rounded to x's dtype, as in the TPU kernel.  The softmax is
the exact max-subtracted one (the TPU inference kernel's exp(min(s, 80))
equals it while every logit is below 80).

Each wrapper takes the plain version for a CPU tensor and launches the
CUDA kernels (csrc/fused_msa.cu: attention, then the out-projection GEMM)
for a CUDA tensor.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import cuda_lib
from .attention import window_attention
from .ln import layer_norm_rows_plain as layer_norm_f32

LN_EPS = 1e-5


def fused_window_msa_plain(x, wqkv, bqkv, wproj, bproj, bias, mask,
                           heads: int, scale: float) -> torch.Tensor:
    """The plain PyTorch version of K2 (f32 math)."""
    b, nw, n, c = x.shape
    hd = c // heads
    dt = x.dtype
    qkv = x.float() @ wqkv.float().t() + bqkv.float()
    qkv = qkv.view(b, nw, n, 3, heads, hd).permute(3, 0, 1, 4, 2, 5)
    q = (qkv[0] * scale).to(dt)
    k, v = qkv[1].to(dt), qkv[2].to(dt)
    o = window_attention(q, k, v, bias, mask, scale=1.0)
    o = o.permute(0, 1, 3, 2, 4).reshape(b, nw, n, c)
    return (o.float() @ wproj.float().t() + bproj.float()).to(dt)


def fused_window_msa_ln_plain(x, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj,
                              bias, mask, heads: int, scale: float,
                              ln_eps: float = LN_EPS) -> torch.Tensor:
    """The plain PyTorch version of K1."""
    return fused_window_msa_plain(layer_norm_f32(x, ln_scale, ln_bias, ln_eps),
                                  wqkv, bqkv, wproj, bproj, bias, mask, heads,
                                  scale)


def fused_msa_supported(n: int, c: int, heads: int) -> bool:
    """Geometries the CUDA kernel takes: window 12 (N = 144), head dim 32,
    C a multiple of 64 (the out-projection GEMM's tile)."""
    return n == 144 and heads > 0 and c == 32 * heads and c % 64 == 0


def _launch(x, ln, wqkv, bqkv, wproj, bproj, bias, mask, heads, scale,
            eps) -> torch.Tensor:
    b, nw, n, c = x.shape
    if not fused_msa_supported(n, c, heads):
        raise ValueError(f"fused window MSA kernel: unsupported (N, C, heads) "
                         f"{(n, c, heads)}")
    dev = x.device
    bf16 = torch.bfloat16
    checks = [("x", x, bf16, None), ("wqkv", wqkv, bf16, (3 * c, c)),
              ("bqkv", bqkv, bf16, (3 * c,)), ("wproj", wproj, bf16, (c, c)),
              ("bproj", bproj, bf16, (c,)),
              ("bias", bias, torch.float32, (heads, n, n))]
    if mask is not None:
        checks.append(("mask", mask, torch.float32, (nw, n, n)))
    if ln is not None:
        checks += [("ln_scale", ln[0], bf16, (c,)), ("ln_bias", ln[1], bf16, (c,))]
    for name, t, dt, shape in checks:
        cuda_lib.require(t, name, dt, dev, shape)
        if t.data_ptr() % 16:  # the kernel moves 16-byte words
            raise ValueError(f"{name}: data must be 16-byte aligned")
    lib = cuda_lib.lib()
    stream = cuda_lib.stream_ptr(dev)
    o = torch.empty_like(x)
    err = lib.lavt_window_msa_attn(
        x.data_ptr(), ln[0].data_ptr() if ln is not None else None,
        ln[1].data_ptr() if ln is not None else None, wqkv.data_ptr(),
        bqkv.data_ptr(), bias.data_ptr(),
        mask.data_ptr() if mask is not None else None, o.data_ptr(),
        b * nw, nw, c, heads, float(scale), float(eps), stream)
    cuda_lib.check(err, "lavt_window_msa_attn")
    y = torch.empty_like(x)
    err = lib.lavt_linear_bias(o.data_ptr(), wproj.data_ptr(), bproj.data_ptr(),
                               y.data_ptr(), b * nw * n, c, c, stream)
    cuda_lib.check(err, "lavt_linear_bias")
    return y


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


fused_window_msa.launches = 0
fused_window_msa_ln.launches = 0
