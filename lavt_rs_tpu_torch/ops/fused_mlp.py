"""Fused LayerNorm -> fc1 -> exact GELU -> fc2 -> residual (K3).

Counterpart of `lavt_rs_tpu/ops/pallas/fused_mlp.py:fused_ln_mlp`:
out = x + fc2(gelu(fc1(LN(x)))), with the two-pass LayerNorm
(mean of (x − μ)², eps 1e-5) and the exact erf GELU.  The normalized rows
and the GELU output are rounded to x's dtype before their GEMMs, as in
the TPU kernel.  Weights are torch `nn.Linear` layout: w1 (4C, C),
w2 (C, 4C).

`fused_ln_mlp` takes the plain version for a CPU tensor and launches the
CUDA kernel (csrc/fused_mlp.cu) for a CUDA tensor.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import cuda_lib

EPS = 1e-5
KERNEL_WIDTHS = (128, 256, 512, 1024)


def fused_ln_mlp_plain(x, g, be, w1, b1, w2, b2, eps: float = EPS):
    """x: (M, C) -> x + fc2(gelu(fc1(LN(x)))) in x.dtype; f32 math."""
    dt = x.dtype
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    xn = (xf - mu) * torch.rsqrt(var + eps) * g.float() + be.float()
    h = xn.to(dt).float() @ w1.float().t() + b1.float()
    h = F.gelu(h, approximate="none")
    y = h.to(dt).float() @ w2.float().t() + b2.float()
    return (xf + y).to(dt)


def fused_ln_mlp_supported(m: int, c: int, hidden: int) -> bool:
    return m > 0 and c in KERNEL_WIDTHS and hidden % 128 == 0


def fused_ln_mlp(x, g, be, w1, b1, w2, b2, eps: float = EPS):
    """x: (M, C) bf16 tokens -> x + fc2(gelu(fc1(LN(x)))) in bf16."""
    if x.device.type == "cpu":
        return fused_ln_mlp_plain(x, g, be, w1, b1, w2, b2, eps)
    m, c = x.shape
    hidden = w1.shape[0]
    if not fused_ln_mlp_supported(m, c, hidden):
        raise ValueError(f"fused_ln_mlp kernel: unsupported (M, C, hidden) "
                         f"{(m, c, hidden)}")
    for name, t, shape in (("x", x, None), ("g", g, (c,)), ("be", be, (c,)),
                           ("w1", w1, (hidden, c)), ("b1", b1, (hidden,)),
                           ("w2", w2, (c, hidden)), ("b2", b2, (c,))):
        cuda_lib.require(t, name, torch.bfloat16, x.device, shape)
        # 16-byte vector loads; WMMA reads the weights in 32-byte rows
        if t.data_ptr() % (32 if name in ("w1", "w2") else 16):
            raise ValueError(f"{name}: data is not aligned for the kernel")
    out = torch.empty_like(x)
    err = cuda_lib.lib().lavt_fused_ln_mlp(
        x.data_ptr(), g.data_ptr(), be.data_ptr(), w1.data_ptr(),
        b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), out.data_ptr(),
        m, c, hidden, float(eps), cuda_lib.stream_ptr(x.device))
    cuda_lib.check(err, "lavt_fused_ln_mlp")
    fused_ln_mlp.launches += 1
    return out


fused_ln_mlp.launches = 0
