"""Row LayerNorm for the stage-output norms (K4).

Counterpart of `lavt_rs_tpu/ops/pallas/ln.py:layer_norm_rows`: f32 stats
with the fast variance E[x²] − E[x]², epsilon inside rsqrt, affine in f32,
result in x's dtype.  `layer_norm_rows` takes the plain version for a CPU
tensor and launches the CUDA kernel (csrc/ln.cu) for a CUDA tensor.

`LayerNormRows` is the autograd Function the model calls: its forward is
`layer_norm_rows` on x's dtype (it casts the f32 master scale and bias),
its backward the plain formula of `lavt_rs_tpu/ops/pallas/ln.py:_ln_bwd`
(f32, fast variance), as on the TPU.
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


def layer_norm_rows_bwd_plain(x: torch.Tensor, scale: torch.Tensor,
                              g: torch.Tensor, eps: float = 1e-5):
    """Backward of `layer_norm_rows_plain` over the last dim: (dx in x's
    dtype, dscale f32, dbias f32) from the output gradient g."""
    c = x.shape[-1]
    xf = x.reshape(-1, c).float()
    gf = g.reshape(-1, c).float()
    mu = xf.mean(dim=1, keepdim=True)
    var = (xf * xf).mean(dim=1, keepdim=True) - mu * mu
    rsig = torch.rsqrt(var + eps)
    xn = (xf - mu) * rsig
    dxn = gf * scale.float()
    m1 = dxn.mean(dim=1, keepdim=True)
    m2 = (dxn * xn).mean(dim=1, keepdim=True)
    dx = (rsig * (dxn - m1 - xn * m2)).to(x.dtype).view(x.shape)
    return dx, (gf * xn).sum(0), gf.sum(0)


def layer_norm_rows_supported(rows: int, c: int) -> bool:
    """Shapes the CUDA kernel takes: C a multiple of 32 up to 4096."""
    return rows > 0 and c % 32 == 0 and 32 <= c <= 4096


def layer_norm_rows_routed(rows: int, c: int) -> bool:
    """The JAX routing predicate of the stage norms
    (`lavt_rs_tpu/ops/pallas/ln.py:layer_norm_rows_supported`, read by
    `models/swin2d.py:_StageNorm`): K4 at lane-aligned widths up to 4096;
    elsewhere (Swin-T/S/L's 96 and 192) the plain f32 LayerNorm, as the
    JAX package runs `layer_norm_f32` through XLA there."""
    return c % 128 == 0 and c <= 4096


def layer_norm_rows(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    eps: float = 1e-5) -> torch.Tensor:
    """x: (rows, C) bf16 -> LayerNorm over C, in bf16."""
    if x.device.type == "cpu":
        return layer_norm_rows_plain(x, scale, bias, eps)
    out = layer_norm_rows_launch(x, scale, bias, eps)
    layer_norm_rows.launches += 1
    return out


def layer_norm_rows_launch(x: torch.Tensor, scale: torch.Tensor,
                           bias: torch.Tensor, eps: float = 1e-5
                           ) -> torch.Tensor:
    """K4's launch without its count (the plain version on a CPU tensor):
    the pre-attention LN of K1's save mode, which counts as K1."""
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
    return out


layer_norm_rows.launches = 0


class LayerNormRows(torch.autograd.Function):
    """K4 forward on x's dtype (the f32 master scale and bias are cast to
    it), plain f32 backward; grads for scale and bias come back in their
    own dtype."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps: float = 1e-5):
        ctx.eps = eps
        ctx.save_for_backward(x, scale)
        return layer_norm_rows(x, scale.to(x.dtype), bias.to(x.dtype), eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        dx, ds, db = layer_norm_rows_bwd_plain(x, scale, g, ctx.eps)
        return dx, ds.to(scale.dtype), db.to(scale.dtype), None
