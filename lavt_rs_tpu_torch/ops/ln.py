"""Row LayerNorm for the stage-output norms (K4) and its backward (K4b).

Counterpart of `lavt_rs_tpu/ops/pallas/ln.py:layer_norm_rows`: f32 stats
with the fast variance E[x²] − E[x]², epsilon inside rsqrt, affine in f32,
result in x's dtype.  `layer_norm_rows` takes the plain version for a CPU
tensor and launches the CUDA kernel (csrc/ln.cu) for a CUDA tensor.

K4b (`layer_norm_rows_bwd`, csrc/ln.cu) is the backward of that
custom_vjp (`ln.py:_ln_bwd`, XLA on the TPU) in one pass: it recomputes
the stats from x and writes dx and per block of rows the column partials
of dscale and dbias, which `fused_msa.sum_partials` adds in block order.

`LayerNormRows` is the autograd Function the model calls: its forward is
`layer_norm_rows` on x's dtype (it casts the f32 master scale and bias),
its backward K4b from the f32 master scale (the plain formula on the
CPU).

K4 f32 (`layer_norm_rows_f32`, csrc/ln.cu) is the same LayerNorm on f32
rows, as the TPU kernel computes it on f32 activations; `layer_norm_rows`
takes it for a CUDA f32 tensor (no f32 tensor is cast into the bf16
kernel).  Its launch `layer_norm_rows_f32_launch` also makes K1 f32's LN
rows.  K4b f32
(`layer_norm_rows_bwd_f32`, csrc/ln.cu) is K4b's pass on f32 rows in one
launch: dx in f32, and the column sums added inside the launch from its
blocks' partials, in block order (its plan `ln_rows_f32_bwd_plan`);
`layer_norm_rows_bwd` and `LayerNormRows` take it for a CUDA f32 tensor,
`layer_norm_rows_bwd_launch` for K1 f32's LN backward.
"""

from __future__ import annotations

import math

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
    dx, gf, xn = _bwd_rows(x, scale, g, eps)
    return dx, (gf * xn).sum(0), gf.sum(0)


def _bwd_rows(x, scale, g, eps):
    """The plain backward by rows: dx, and the f32 (rows, C) g and xhat
    whose column sums make dscale and dbias."""
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
    return dx, gf, xn


def ln_rows_plan(rows: int, c: int, sms: int, bwd: bool = False) -> dict:
    """The launch plan of csrc/ln.cu (`lnr::plan`): a row held by `lanes`
    lanes of `vecs` 16-byte words each (`tail`: words past C / 8 masked;
    lanes 0: 1024 < C, the whole block on one row), `per` rows a block,
    `blocks` blocks (K4b writes one (2, C) partial each).  K4 runs blocks
    of 8 warps, 1-5 an SM; K4b (bwd) one block an SM of 8-24 warps."""
    words, step = c // 8, 1
    lanes = vecs = 0
    tail = False
    if c > 1024:
        per_sm = 2 if bwd else 3
    else:
        g = 16 if c <= 256 else 32
        while g >= 4 and not lanes:
            if words % g == 0 and words // g <= 4:
                lanes, vecs = g, words // g
            g //= 2
        if not lanes:
            lanes, vecs, tail = 32, -(-words // 32), True
        warps = 8 * (3 if vecs == 1 else 2 if vecs == 2 else 1) if bwd else 8
        step = warps * (32 // lanes)
        per_sm = 1 if bwd else (5 if vecs == 1 else 3 if vecs == 2
                                else 2 if vecs == 3 else 1)
    iters = -(-rows // step)
    want = min(iters, sms * per_sm)
    per = -(-iters // want) * step
    return {"lanes": lanes, "vecs": vecs, "tail": tail, "per": per,
            "blocks": -(-rows // per)}


def ln_rows_f32_bwd_plan(rows: int, c: int, sms: int) -> dict:
    """K4b f32's launch plan (csrc/ln.cu `lnr32::plan_bwd`): at C <= 1024 a
    row held by `lanes` lanes (8, 16 or 32) of `vecs` 16-byte words each
    (words past C / 4 masked), blocks of `warps` warps (16, or 8 at vecs >
    4), each lane group loading its next row while it reduces one; above,
    the block of 8 warps on one row (lanes 0).  One block an SM, `per` rows
    a block, `blocks` blocks, each writing one (2, C) partial; the partials
    are added in the launch by groups of `group` blocks (the smallest
    group with group ** 2 >= blocks), then the `groups` group sums, each
    in order."""
    lanes = vecs = 0
    warps, step = 8, 1
    if c <= 1024:
        words = c // 4
        g = 8
        while g <= 32 and not lanes:
            if words % g == 0 and words // g <= 4:
                lanes, vecs = g, words // g
            g *= 2
        if not lanes:
            lanes, vecs = 32, -(-words // 32)
        warps = 16 if vecs <= 4 else 8
        step = warps * (32 // lanes)
    iters = -(-rows // step)
    per = -(-iters // min(iters, sms)) * step
    blocks = -(-rows // per)
    group = math.isqrt(blocks - 1) + 1
    return {"lanes": lanes, "vecs": vecs, "warps": warps, "per": per,
            "blocks": blocks, "group": group, "groups": -(-blocks // group)}


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


def _check_rows(named, rows: int, c: int, dev) -> None:
    """The kernels' checks: a shape they take, each tensor contiguous of
    its dtype and shape on `dev`, 16-byte aligned (they move 16-byte
    words)."""
    if not layer_norm_rows_supported(rows, c):
        raise ValueError(f"layer_norm_rows kernels: unsupported shape "
                         f"{(rows, c)}")
    for name, t, dtype, shape in named:
        cuda_lib.require(t, name, dtype, dev, shape)
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: data must be 16-byte aligned")


def layer_norm_rows(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    eps: float = 1e-5) -> torch.Tensor:
    """x: (rows, C) bf16 -> LayerNorm over C, in bf16; f32 rows on the card
    take K4 f32 (`layer_norm_rows_f32`)."""
    if x.device.type == "cpu":
        return layer_norm_rows_plain(x, scale, bias, eps)
    if x.dtype == torch.float32:
        return layer_norm_rows_f32(x, scale, bias, eps)
    out = layer_norm_rows_launch(x, scale, bias, eps)
    layer_norm_rows.launches += 1
    return out


def layer_norm_rows_launch(x: torch.Tensor, scale: torch.Tensor,
                           bias: torch.Tensor, eps: float = 1e-5
                           ) -> torch.Tensor:
    """K4's launch without its count (the plain version on a CPU tensor):
    the pre-attention LN of K1's save mode, which counts as K1; f32 rows
    take K4 f32's launch (K1 f32's LN)."""
    if x.device.type == "cpu":
        return layer_norm_rows_plain(x, scale, bias, eps)
    if x.dtype == torch.float32:
        return layer_norm_rows_f32_launch(x, scale, bias, eps)
    if x.dim() != 2:
        raise ValueError(f"layer_norm_rows kernel: x must be (rows, C), got "
                         f"{tuple(x.shape)}")
    rows, c = x.shape
    bf16 = torch.bfloat16
    _check_rows([("x", x, bf16, None), ("scale", scale, bf16, (c,)),
                 ("bias", bias, bf16, (c,))], rows, c, x.device)
    out = torch.empty_like(x)
    err = cuda_lib.lib().lavt_layer_norm_rows(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
        rows, c, float(eps), cuda_lib.stream_ptr(x.device))
    cuda_lib.check(err, "lavt_layer_norm_rows")
    return out


layer_norm_rows.launches = 0


def layer_norm_rows_f32(x: torch.Tensor, scale: torch.Tensor,
                        bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """K4 f32: x (rows, C) f32 -> LayerNorm over C in f32, the fast
    variance (csrc/ln.cu); the plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return layer_norm_rows_plain(x, scale, bias, eps)
    out = layer_norm_rows_f32_launch(x, scale, bias, eps)
    layer_norm_rows_f32.launches += 1
    return out


def layer_norm_rows_f32_launch(x: torch.Tensor, scale: torch.Tensor,
                               bias: torch.Tensor,
                               eps: float = 1e-5) -> torch.Tensor:
    """The f32 row launch without a count (`lavt_layer_norm_rows_f32`):
    x (rows, C), scale, bias (C,) f32 -> f32, the fast variance (K4 f32,
    K1 f32's LN).  The plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return layer_norm_rows_plain(x, scale, bias, eps)
    if x.dim() != 2:
        raise ValueError(f"layer_norm_rows f32 kernel: x must be (rows, C), "
                         f"got {tuple(x.shape)}")
    rows, c = x.shape
    f32 = torch.float32
    _check_rows([("x", x, f32, None), ("scale", scale, f32, (c,)),
                 ("bias", bias, f32, (c,))], rows, c, x.device)
    out = torch.empty_like(x)
    err = cuda_lib.lib().lavt_layer_norm_rows_f32(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
        rows, c, float(eps), cuda_lib.stream_ptr(x.device))
    cuda_lib.check(err, "lavt_layer_norm_rows_f32")
    return out


layer_norm_rows_f32.launches = 0


def layer_norm_rows_bwd_partials_plain(x: torch.Tensor, scale: torch.Tensor,
                                       g: torch.Tensor, eps: float = 1e-5,
                                       sms: int = 132):
    """The plain version of `layer_norm_rows_bwd_partials`: dx as
    `layer_norm_rows_bwd_plain` gives it and the f32 (blocks, 2, C)
    partials (sum g xhat, sum g) over the rows of each block of the launch
    plan (`ln_rows_plan` on `sms` SMs; 132: an H100's)."""
    rows, c = x.shape
    return _plan_partials(x, scale, g, eps,
                          ln_rows_plan(rows, c, sms, bwd=True))


def _plan_partials(x, scale, g, eps, plan):
    """The plain backward by rows: dx and the f32 (blocks, 2, C) partials
    (sum g xhat, sum g) over the rows of each block of a `plan`."""
    rows, c = x.shape
    dx, gf, xn = _bwd_rows(x, scale, g, eps)
    pad = plan["blocks"] * plan["per"] - rows
    both = torch.stack((gf * xn, gf), 1)  # (rows, 2, C)
    both = torch.cat((both, both.new_zeros(pad, 2, c)))
    return dx, both.view(plan["blocks"], plan["per"], 2, c).sum(1)


def layer_norm_rows_bwd_partials_f32_plain(x: torch.Tensor,
                                           scale: torch.Tensor,
                                           g: torch.Tensor, eps: float = 1e-5,
                                           sms: int = 132):
    """dx and the f32 (blocks, 2, C) column partials of K4b f32's blocks
    (`ln_rows_f32_bwd_plan` on `sms` SMs), which `sum_groups_plain` adds
    as the launch does."""
    rows, c = x.shape
    return _plan_partials(x, scale, g, eps, ln_rows_f32_bwd_plan(rows, c, sms))


def sum_groups_plain(part: torch.Tensor, plan: dict) -> torch.Tensor:
    """K4b f32's sum of its blocks' partials (blocks, 2, C) -> (2, C): each
    group of `plan["group"]` blocks added in block order, then the group
    sums in group order."""
    k = plan["group"]
    sums = [sum_in_order(part[i:i + k]) for i in range(0, part.shape[0], k)]
    return sum_in_order(torch.stack(sums))


def sum_in_order(t: torch.Tensor) -> torch.Tensor:
    """t[0] + t[1] + ... in f32, left to right."""
    out = t[0].clone()
    for row in t[1:]:
        out += row
    return out


def layer_norm_rows_bwd_f32_launch(x: torch.Tensor, scale: torch.Tensor,
                                   g: torch.Tensor, eps: float = 1e-5):
    """K4b f32's one launch without its count: x, g (rows, C) f32 and the
    f32 scale -> (dx f32, dscale f32, dbias f32), the column sums added in
    the launch (`lavt_layer_norm_rows_bwd_f32`); the plain version on a CPU
    tensor.  Also K1 f32's LN backward in `FusedWindowMSA` (which counts as
    K5 f32)."""
    if x.device.type == "cpu":
        return layer_norm_rows_bwd_plain(x, scale, g, eps)
    if x.dim() != 2:
        raise ValueError(f"layer_norm_rows_bwd f32 kernel: x must be (rows, "
                         f"C), got {tuple(x.shape)}")
    rows, c = x.shape
    f32 = torch.float32
    _check_rows([("x", x, f32, None), ("g", g, f32, (rows, c)),
                 ("scale", scale, f32, (c,))], rows, c, x.device)
    lib = cuda_lib.lib()
    ws_rows = lib.lavt_layer_norm_rows_bwd_f32_ws(rows, c)
    dx = torch.empty_like(x)
    ws = torch.empty((ws_rows, 2, c), dtype=f32, device=x.device)
    sums = torch.empty((2, c), dtype=f32, device=x.device)
    err = lib.lavt_layer_norm_rows_bwd_f32(
        x.data_ptr(), g.data_ptr(), scale.data_ptr(), dx.data_ptr(),
        ws.data_ptr(), sums.data_ptr(), ws_rows, rows, c, float(eps),
        cuda_lib.stream_ptr(x.device))
    cuda_lib.check(err, "lavt_layer_norm_rows_bwd_f32")
    return dx, sums[0], sums[1]


def layer_norm_rows_bwd_partials(x: torch.Tensor, scale: torch.Tensor,
                                 g: torch.Tensor, eps: float = 1e-5):
    """K4b's launch: x, g (rows, C) bf16 and the f32 scale -> (dx bf16,
    the f32 (blocks, 2, C) column partials of dscale and dbias, one per
    block of the launch plan).  The plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return layer_norm_rows_bwd_partials_plain(x, scale, g, eps)
    if x.dim() != 2:
        raise ValueError(f"layer_norm_rows_bwd kernel: x must be (rows, C), "
                         f"got {tuple(x.shape)}")
    rows, c = x.shape
    bf16 = torch.bfloat16
    _check_rows([("x", x, bf16, None), ("g", g, bf16, (rows, c)),
                 ("scale", scale, torch.float32, (c,))], rows, c, x.device)
    lib = cuda_lib.lib()
    parts = lib.lavt_layer_norm_rows_bwd_parts(rows, c)
    dx = torch.empty_like(x)
    part = torch.empty((parts, 2, c), dtype=torch.float32, device=x.device)
    err = lib.lavt_layer_norm_rows_bwd(
        x.data_ptr(), g.data_ptr(), scale.data_ptr(), dx.data_ptr(),
        part.data_ptr(), parts, rows, c, float(eps),
        cuda_lib.stream_ptr(x.device))
    cuda_lib.check(err, "lavt_layer_norm_rows_bwd")
    return dx, part


def layer_norm_rows_bwd_launch(x: torch.Tensor, scale: torch.Tensor,
                               g: torch.Tensor, eps: float = 1e-5):
    """K4b (K4b f32's one launch for f32 rows) without its count: (dx,
    dscale f32, dbias f32), K4b's partials added in block order
    (`fused_msa.sum_partials`); the plain version on a CPU tensor.  K1's
    LN backward in `FusedWindowMSA`, which counts as K5."""
    if x.device.type == "cpu":
        return layer_norm_rows_bwd_plain(x, scale, g, eps)
    if x.dtype == torch.float32:
        return layer_norm_rows_bwd_f32_launch(x, scale, g, eps)
    from .fused_msa import sum_partials  # imports this module

    dx, part = layer_norm_rows_bwd_partials(x, scale, g, eps)
    sums = sum_partials(part)
    return dx, sums[0], sums[1]


def layer_norm_rows_bwd(x: torch.Tensor, scale: torch.Tensor,
                        g: torch.Tensor, eps: float = 1e-5):
    """K4b: the backward of `layer_norm_rows` from the output gradient g,
    x and g (rows, C) bf16 and the f32 master scale -> (dx bf16, dscale
    f32, dbias f32).  The plain version on a CPU tensor; on the card the
    kernel, or it raises; f32 rows take K4b f32 (`layer_norm_rows_bwd_f32`)."""
    if x.device.type == "cpu":
        return layer_norm_rows_bwd_plain(x, scale, g, eps)
    if x.dtype == torch.float32:
        return layer_norm_rows_bwd_f32(x, scale, g, eps)
    out = layer_norm_rows_bwd_launch(x, scale, g, eps)
    layer_norm_rows_bwd.launches += 1
    return out


def layer_norm_rows_bwd_f32(x: torch.Tensor, scale: torch.Tensor,
                            g: torch.Tensor, eps: float = 1e-5):
    """K4b f32: the same backward from f32 x and g (rows, C) -> (dx f32,
    dscale f32, dbias f32), on K4b f32's one launch; the plain version on a
    CPU tensor."""
    if x.device.type == "cpu":
        return layer_norm_rows_bwd_plain(x, scale, g, eps)
    out = layer_norm_rows_bwd_f32_launch(x, scale, g, eps)
    layer_norm_rows_bwd_f32.launches += 1
    return out


layer_norm_rows_bwd.launches = 0
layer_norm_rows_bwd_f32.launches = 0


class LayerNormRows(torch.autograd.Function):
    """K4 forward on x's dtype (the f32 master scale and bias are cast to
    it), K4b backward from the f32 scale; grads for scale and bias come
    back in their own dtype."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps: float = 1e-5):
        ctx.eps = eps
        ctx.save_for_backward(x, scale)
        return layer_norm_rows(x, scale.to(x.dtype), bias.to(x.dtype), eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        dx, ds, db = layer_norm_rows_bwd(x, scale.float(), g.contiguous(),
                                         ctx.eps)
        return dx, ds.to(scale.dtype), db.to(scale.dtype), None
