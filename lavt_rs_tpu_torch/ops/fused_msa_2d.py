"""Fused window MSA over a whole padded feature map (K11).

Counterpart of `lavt_rs_tpu/ops/pallas/experimental.py`
(`fused_window_msa_2d`, `_ref_forward_2d`): window partition + fused MSA
(K2's math) + window reverse over a padded and, for shifted blocks,
pre-rolled (B, Hp, Wp, C) map, Hp and Wp multiples of the window.

  * `fused_window_msa_2d_plain` partitions, runs K2's plain version and
    reverses (`_ref_forward_2d`);
  * `fused_window_msa_2d` takes the plain version for a CPU tensor and
    launches K11 for a CUDA tensor: the three launches of `map_launches`
    on the map, with no partition or reverse copy (the qkv projection on
    the wgmma + TMA GEMM core over the map's rows, csrc/fused_msa_sm90.cu's
    attention in map order, which loads each window's q, k, v as one TMA
    box a head and writes the head's columns of O back at the window's
    map positions, and the out-projection on the core over O's rows, which
    are already the map).  While autograd records an input it goes through
    `FusedWindowMSA2D`, whose backward is autograd through the plain
    version, as the JAX function's VJP is `jax.vjp` of `_ref_forward_2d`
    (no path of the port trains through it).

Weights are torch `nn.Linear` layout (wqkv (3C, C), wproj (C, C)); bias
(heads, N, N) f32; mask (nW, N, N) f32 with nW = (Hp / ws)(Wp / ws), window
(wy, wx) of each image taking mask[wy (Wp / ws) + wx], or None; flags the
mask's (nW,) int32 window flags (`window.shift_mask_flags_2d`: the windows
whose mask the card reads; None: every window), which change no value.

K11 f32 (`fused_window_msa_2d_f32`) is K11 on f32 activations, as the JAX
kernel computes it there: the launches of `map_launches`, each on its f32
kernel for an f32 tensor (the 3xTF32 GEMM of csrc/gemm_f32.cu, the map-order
attention of csrc/fused_msa_f32.cu, `msa_attn_map_f32`); `fused_window_msa_2d`
takes it for a CUDA f32 tensor.  Its softmax is the TPU inference kernel's
exp(min(s, 80)), and its plain version takes that form for an f32 map
(`fused_msa.softmax_form`); under `FusedWindowMSA2D` the forward takes the
exact softmax of its backward.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import cuda_lib
from .fused_msa import (_attn_f32_checks, _require_all, fused_msa_supported,
                        fused_window_msa_plain, gemm_bias, msa_attn_plain,
                        msa_bwd_groups, softmax_form)
from .window import window_partition, window_reverse


def fused_window_msa_2d_plain(x, wqkv, bqkv, wproj, bproj, bias, mask,
                              heads: int, scale: float, ws: int,
                              exact: bool = True) -> torch.Tensor:
    """The plain version of K11: partition -> K2's plain version ->
    reverse (f32 math, the kernel's rounding points; exact False: the
    clamp softmax of K11 f32)."""
    b, hp, wp, c = x.shape
    nw = (hp // ws) * (wp // ws)
    xw = window_partition(x, ws).view(b, nw, ws * ws, c)
    y = fused_window_msa_plain(xw, wqkv, bqkv, wproj, bproj, bias, mask,
                               heads, scale, exact)
    return window_reverse(y.view(b * nw, ws * ws, c), ws, hp, wp)


def msa_attn_map_plain(qkv, bias, mask, heads: int,
                       exact: bool = True) -> torch.Tensor:
    """The plain version of `msa_attn_map`: the qkv map partitioned into
    windows, `msa_attn_plain` (its rounding points and softmax form), O
    written back at the windows' map positions."""
    b, hp, wp, c3 = qkv.shape
    n = bias.shape[-1]
    ws = math.isqrt(n)
    qw = window_partition(qkv, ws)
    o, _ = msa_attn_plain(qw, bias, mask, heads, exact)
    return window_reverse(o.view(qw.shape[0], n, c3 // 3), ws, hp, wp)


def msa_attn_map(qkv, bias, mask, heads: int,
                 flags: Optional[torch.Tensor] = None,
                 exact: bool = False) -> torch.Tensor:
    """K11's attention launch (`lavt_msa_fwd_map_sm90`): qkv (B, Hp, Wp, 3C)
    bf16 as `gemm_bias` writes it over the map's rows (q scaled), bias
    (heads, 144, 144) f32, mask (nW, 144, 144) f32 or None with its window
    flags -> O (B, Hp, Wp, C) bf16, each window's rows at its map
    positions; the exact softmax.  The plain version on a CPU tensor (in
    `softmax_form`); an f32 map takes K11 f32's attention
    (`msa_attn_map_f32`, exp(min(s, 80)) unless exact)."""
    if qkv.device.type == "cpu":
        return msa_attn_map_plain(qkv, bias, mask, heads,
                                  softmax_form(qkv, exact))
    if qkv.dtype == torch.float32:
        return msa_attn_map_f32(qkv, bias, mask, heads, flags, exact)
    b, hp, wp, c3 = qkv.shape
    c, n, dev = c3 // 3, 144, qkv.device
    if hp % 12 or wp % 12 or not fused_msa_supported(n, c, heads):
        raise ValueError(f"window MSA map kernel: unsupported (Hp, Wp, C, "
                         f"heads) {(hp, wp, c, heads)}")
    nw = (hp // 12) * (wp // 12)
    checks = [("qkv", qkv, torch.bfloat16, None),
              ("bias", bias, torch.float32, (heads, n, n))]
    if mask is not None:
        checks.append(("mask", mask, torch.float32, (nw, n, n)))
        if flags is not None:
            cuda_lib.require(flags, "flags", torch.int32, dev, (nw,))
    _require_all(checks, dev)
    o = torch.empty((b, hp, wp, c), dtype=torch.bfloat16, device=dev)
    groups = msa_bwd_groups(b * nw, heads, cuda_lib.sm_count(dev.index or 0))
    err = cuda_lib.lib().lavt_msa_fwd_map_sm90(
        qkv.data_ptr(), bias.data_ptr(),
        None if mask is None else mask.data_ptr(),
        None if mask is None or flags is None else flags.data_ptr(),
        o.data_ptr(), b, hp, wp, c, heads, groups, cuda_lib.stream_ptr(dev))
    cuda_lib.check(err, "lavt_msa_fwd_map_sm90")
    return o


def msa_attn_map_f32(qkv, bias, mask, heads: int,
                     flags: Optional[torch.Tensor] = None,
                     exact: bool = False) -> torch.Tensor:
    """K11 f32's attention launch (`lavt_msa_fwd_map_f32`): qkv (B, Hp,
    Wp, 3C) f32 (q scaled), bias (heads, 144, 144) f32, mask (nW, 144, 144)
    f32 or None with its window flags -> O (B, Hp, Wp, C) f32 at the
    windows' map positions, e = exp(min(s, 80)) (exact: exp(s - max))
    normalised by its row sum.  The plain version on a CPU tensor."""
    if qkv.device.type == "cpu":
        return msa_attn_map_plain(qkv, bias, mask, heads, exact)
    b, hp, wp, c3 = qkv.shape
    c, n = c3 // 3, 144
    if hp % 12 or wp % 12:
        raise ValueError(f"f32 window MSA map kernel: unsupported (Hp, Wp) "
                         f"{(hp, wp)}")
    nw = (hp // 12) * (wp // 12)
    _attn_f32_checks(qkv, bias, mask, flags, heads, n, c, nw)
    o = torch.empty((b, hp, wp, c), dtype=torch.float32, device=qkv.device)
    err = cuda_lib.lib().lavt_msa_fwd_map_f32(
        qkv.data_ptr(), bias.data_ptr(),
        None if mask is None else mask.data_ptr(),
        None if mask is None or flags is None else flags.data_ptr(),
        o.data_ptr(), b, hp, wp, c, heads, int(exact),
        cuda_lib.stream_ptr(qkv.device))
    cuda_lib.check(err, "lavt_msa_fwd_map_f32")
    return o


def map_launches(x, wqkv, bqkv, wproj, bproj, bias, mask, heads: int,
                 scale: float, flags=None, exact: bool = False, wlo=None
                 ) -> torch.Tensor:
    """K11's three launches, in order, on the (B, Hp, Wp, C) map:
      (a) qkv = x Wqkvᵀ + bqkv over the map's B Hp Wp rows, q scaled after
          its bias, bf16 (B, Hp, Wp, 3C), on the GEMM core (`gemm_bias`);
      (b) the attention in map order (`msa_attn_map`): O (B, Hp, Wp, C);
      (c) y = O Wprojᵀ + bproj over the same rows on the GEMM core.
    On CPU tensors each launch takes its plain version, which compose to
    `fused_window_msa_2d_plain`'s values (tests/test_torch_k11_launches.py);
    on the card y has the bits of the K2 launches on the partitioned map.
    `exact`: the f32 attention's softmax form (the bf16 one is exact);
    `wlo`: (wqkv's, wproj's) lo parts for the f32 GEMMs, or None."""
    b, hp, wp, c = x.shape
    rows = b * hp * wp
    lo = wlo or (None, None)
    qkv = gemm_bias(x.reshape(rows, c), wqkv, bqkv, c, scale, wlo=lo[0])
    o = msa_attn_map(qkv.view(b, hp, wp, 3 * c), bias, mask, heads, flags,
                     exact)
    return gemm_bias(o.view(rows, c), wproj, bproj,
                     wlo=lo[1]).view(b, hp, wp, c)


def _launch(x, wqkv, bqkv, wproj, bproj, bias, mask, heads, scale, ws,
            flags, dtype=torch.bfloat16, exact=False, wlo=None):
    """The checks (every tensor of `dtype`: bf16, or f32 for K11 f32), then
    `map_launches`."""
    b, hp, wp, c = x.shape
    if hp % ws or wp % ws or not fused_msa_supported(ws * ws, c, heads):
        raise ValueError(f"fused window MSA 2D kernel: unsupported (Hp, Wp, "
                         f"C, heads, ws) {(hp, wp, c, heads, ws)}")
    _require_all([("x", x, dtype, None), ("wqkv", wqkv, dtype, (3 * c, c)),
                  ("bqkv", bqkv, dtype, (3 * c,)),
                  ("wproj", wproj, dtype, (c, c)),
                  ("bproj", bproj, dtype, (c,))], x.device)
    return map_launches(x, wqkv, bqkv, wproj, bproj, bias, mask, heads, scale,
                        flags, exact, wlo)


def _forward(x, wqkv, bqkv, wproj, bproj, bias, mask, heads, scale, ws,
             flags, exact=False, wlo=None):
    """K11 (f32: K11 f32), its softmax form by `softmax_form`: the clamp
    form of K11 f32 at inference, exact under `FusedWindowMSA2D`'s tape."""
    if x.device.type == "cpu":
        return fused_window_msa_2d_plain(x, wqkv, bqkv, wproj, bproj, bias,
                                         mask, heads, scale, ws,
                                         softmax_form(x, exact))
    if x.dtype == torch.float32:
        return fused_window_msa_2d_f32(x, wqkv, bqkv, wproj, bproj, bias,
                                       mask, heads, scale, ws, flags, exact,
                                       wlo)
    y = _launch(x, wqkv, bqkv, wproj, bproj, bias, mask, heads, scale, ws,
                flags)
    fused_window_msa_2d.launches += 1
    return y


def fused_window_msa_2d_f32(x, wqkv, bqkv, wproj, bproj, bias,
                            mask: Optional[torch.Tensor], heads: int,
                            scale: float, ws: int,
                            flags: Optional[torch.Tensor] = None,
                            exact: bool = False, wlo=None) -> torch.Tensor:
    """K11 f32: K11's forward on an f32 map and f32 weights, the softmax
    exp(min(s, 80)) of the TPU inference kernel (exact: the max-subtracted
    one); on the card the launches of `map_launches` on their f32 kernels
    (`wlo`: (wqkv's, wproj's) lo parts, as `WindowAttention.weight_lo`
    keeps them, or None: each GEMM splits its weight first), the plain
    version on a CPU tensor."""
    if x.device.type == "cpu":
        return fused_window_msa_2d_plain(x, wqkv, bqkv, wproj, bproj, bias,
                                         mask, heads, scale, ws, exact)
    y = _launch(x, wqkv, bqkv, wproj, bproj, bias, mask, heads, scale, ws,
                flags, torch.float32, exact, wlo)
    fused_window_msa_2d_f32.launches += 1
    return y


class FusedWindowMSA2D(torch.autograd.Function):
    """K11 forward (the exact softmax, as the backward's); the backward is
    autograd through the plain version."""

    @staticmethod
    def forward(ctx, x, wqkv, bqkv, wproj, bproj, bias, mask, heads: int,
                scale: float, ws: int, flags=None, wlo=None):
        ctx.save_for_backward(x, wqkv, bqkv, wproj, bproj, bias, mask)
        ctx.static = (heads, scale, ws)
        return _forward(x, wqkv, bqkv, wproj, bproj, bias, mask, heads, scale,
                        ws, flags, exact=True, wlo=wlo)

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
            None, None, None, None, None)


def fused_window_msa_2d(x, wqkv, bqkv, wproj, bproj, bias,
                        mask: Optional[torch.Tensor], heads: int,
                        scale: float, ws: int,
                        flags: Optional[torch.Tensor] = None,
                        wlo=None) -> torch.Tensor:
    """K11: (B, Hp, Wp, C) padded, pre-rolled post-LN map -> the projected
    attention at the same map positions; `wlo`: the f32 weights' lo parts
    (`WindowAttention.weight_lo`) or None."""
    tensors = (x, wqkv, bqkv, wproj, bproj, bias, mask)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in tensors):
        return FusedWindowMSA2D.apply(x, wqkv, bqkv, wproj, bproj, bias, mask,
                                      heads, scale, ws, flags, wlo)
    return _forward(x, wqkv, bqkv, wproj, bproj, bias, mask, heads, scale, ws,
                    flags, wlo=wlo)


fused_window_msa_2d.launches = 0
fused_window_msa_2d_f32.launches = 0
