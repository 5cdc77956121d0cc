"""Fused window MSA over a whole padded feature map (K11).

Counterpart of `lavt_rs_tpu/ops/pallas/experimental.py`
(`fused_window_msa_2d`, `_ref_forward_2d`): window partition + fused MSA
(K2's math) + window reverse over a padded and, for shifted blocks,
pre-rolled (B, Hp, Wp, C) map, Hp and Wp multiples of the window.

  * `fused_window_msa_2d_plain` partitions, runs K2's plain version and
    reverses (`_ref_forward_2d`);
  * `fused_window_msa_2d` takes the plain version for a CPU tensor and
    launches K11 for a CUDA tensor: the attention kernel of
    csrc/fused_msa.cu in map order (each block reads its window's 12 runs
    of 12 C tokens from the map and writes the head's columns of O back at
    the same positions), then the WMMA GEMM out-projection on O viewed as
    (B Hp Wp, C), whose rows are already the map.  No partition or reverse
    copy is made.  While autograd records an input it goes through
    `FusedWindowMSA2D`, whose backward is autograd through the plain
    version, as the JAX function's VJP is `jax.vjp` of `_ref_forward_2d`
    (no path of the port trains through it).

Weights are torch `nn.Linear` layout (wqkv (3C, C), wproj (C, C)); bias
(heads, N, N) f32; mask (nW, N, N) f32 with nW = (Hp / ws)(Wp / ws), window
(wy, wx) of each image taking mask[wy (Wp / ws) + wx], or None.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import cuda_lib
from .fused_msa import (_proj_launch, _require_all, fused_msa_supported,
                        fused_window_msa_plain)
from .window import window_partition, window_reverse


def fused_window_msa_2d_plain(x, wqkv, bqkv, wproj, bproj, bias, mask,
                              heads: int, scale: float, ws: int
                              ) -> torch.Tensor:
    """The plain version of K11: partition -> K2's plain version ->
    reverse (f32 math, the kernel's rounding points)."""
    b, hp, wp, c = x.shape
    nw = (hp // ws) * (wp // ws)
    xw = window_partition(x, ws).view(b, nw, ws * ws, c)
    y = fused_window_msa_plain(xw, wqkv, bqkv, wproj, bproj, bias, mask,
                               heads, scale)
    return window_reverse(y.view(b * nw, ws * ws, c), ws, hp, wp)


def _launch(x, wqkv, bqkv, wproj, bproj, bias, mask, heads, scale, ws):
    b, hp, wp, c = x.shape
    if hp % ws or wp % ws or not fused_msa_supported(ws * ws, c, heads):
        raise ValueError(f"fused window MSA 2D kernel: unsupported (Hp, Wp, "
                         f"C, heads, ws) {(hp, wp, c, heads, ws)}")
    n = ws * ws
    nw = (hp // ws) * (wp // ws)
    bf16 = torch.bfloat16
    checks = [("x", x, bf16, None), ("wqkv", wqkv, bf16, (3 * c, c)),
              ("bqkv", bqkv, bf16, (3 * c,)),
              ("bias", bias, torch.float32, (heads, n, n))]
    if mask is not None:
        checks.append(("mask", mask, torch.float32, (nw, n, n)))
    _require_all(checks, x.device)
    o = torch.empty_like(x)
    err = cuda_lib.lib().lavt_window_msa_2d_attn(
        x.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(), bias.data_ptr(),
        None if mask is None else mask.data_ptr(), o.data_ptr(), b, hp, wp, c,
        heads, float(scale), cuda_lib.stream_ptr(x.device))
    cuda_lib.check(err, "lavt_window_msa_2d_attn")
    return _proj_launch(o, wproj, bproj, x.shape)


def _forward(x, wqkv, bqkv, wproj, bproj, bias, mask, heads, scale, ws):
    if x.device.type == "cpu":
        return fused_window_msa_2d_plain(x, wqkv, bqkv, wproj, bproj, bias,
                                         mask, heads, scale, ws)
    y = _launch(x, wqkv, bqkv, wproj, bproj, bias, mask, heads, scale, ws)
    fused_window_msa_2d.launches += 1
    return y


class FusedWindowMSA2D(torch.autograd.Function):
    """K11 forward; the backward is autograd through the plain version."""

    @staticmethod
    def forward(ctx, x, wqkv, bqkv, wproj, bproj, bias, mask, heads: int,
                scale: float, ws: int):
        ctx.save_for_backward(x, wqkv, bqkv, wproj, bproj, bias, mask)
        ctx.static = (heads, scale, ws)
        return _forward(x, wqkv, bqkv, wproj, bproj, bias, mask, heads, scale,
                        ws)

    @staticmethod
    def backward(ctx, gy):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad[:len(saved)]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(want) if t is not None else None
                      for t, want in zip(saved, need)]
            y = fused_window_msa_2d_plain(*leaves, *ctx.static)
            wrt = [t for t, want in zip(leaves, need) if want]
            grads = iter(torch.autograd.grad(y, wrt, gy))
        return tuple(next(grads) if want else None for want in need) + (
            None, None, None)


def fused_window_msa_2d(x, wqkv, bqkv, wproj, bproj, bias,
                        mask: Optional[torch.Tensor], heads: int,
                        scale: float, ws: int) -> torch.Tensor:
    """K11: (B, Hp, Wp, C) padded, pre-rolled post-LN map -> the projected
    attention at the same map positions."""
    tensors = (x, wqkv, bqkv, wproj, bproj, bias, mask)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in tensors):
        return FusedWindowMSA2D.apply(x, wqkv, bqkv, wproj, bproj, bias, mask,
                                      heads, scale, ws)
    return _forward(x, wqkv, bqkv, wproj, bproj, bias, mask, heads, scale, ws)


fused_window_msa_2d.launches = 0
