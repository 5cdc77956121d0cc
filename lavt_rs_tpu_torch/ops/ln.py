"""Row LayerNorm for the stage-output norms (K4).

Counterpart of `lavt_rs_tpu/ops/pallas/ln.py:layer_norm_rows`: f32 stats
with the fast variance E[x²] − E[x]², epsilon inside rsqrt, affine in f32,
result in x's dtype.  `layer_norm_rows` takes the plain version for a CPU
tensor and launches the CUDA kernel (csrc/ln.cu) for a CUDA tensor.
"""

from __future__ import annotations

import torch

from . import cuda_lib


def layer_norm_rows_plain(x: torch.Tensor, scale: torch.Tensor,
                          bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last dim with f32 stats and fast variance, in x's
    dtype; the plain PyTorch version (also K1's pre-attention LN)."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf * xf).mean(dim=-1, keepdim=True) - mu * mu
    xn = (xf - mu) * torch.rsqrt(var + eps)
    return (xn * scale.float() + bias.float()).to(x.dtype)


def layer_norm_rows_supported(rows: int, c: int) -> bool:
    return rows > 0 and c % 32 == 0 and 32 <= c <= 1024


def layer_norm_rows(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    eps: float = 1e-5) -> torch.Tensor:
    """x: (rows, C) bf16 -> LayerNorm over C, in bf16."""
    if x.device.type == "cpu":
        return layer_norm_rows_plain(x, scale, bias, eps)
    rows, c = x.shape
    if not layer_norm_rows_supported(rows, c):
        raise ValueError(f"layer_norm_rows kernel: unsupported shape {(rows, c)}")
    for name, t, shape in (("x", x, None), ("scale", scale, (c,)),
                           ("bias", bias, (c,))):
        cuda_lib.require(t, name, torch.bfloat16, x.device, shape)
    out = torch.empty_like(x)
    err = cuda_lib.lib().lavt_layer_norm_rows(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
        rows, c, float(eps), cuda_lib.stream_ptr(x.device))
    cuda_lib.check(err, "lavt_layer_norm_rows")
    layer_norm_rows.launches += 1
    return out


layer_norm_rows.launches = 0
