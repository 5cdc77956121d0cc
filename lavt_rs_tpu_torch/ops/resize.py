"""Bilinear resize (counterpart of `lavt_rs_tpu/ops/resize.py`).

The JAX package builds this from two interpolation matmuls for the TPU's
matrix unit; here it is `F.interpolate(mode="bilinear")`.  Corner-aligned
unless `align_corners=False` (the half-pixel form with source indices
clamped at 0, JAX `_linear_matrix_np`'s and torch's), which only the LTS
decoder's last upsample takes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_nchw(x: torch.Tensor, out_hw, exact: bool = True,
                align_corners: bool = True) -> torch.Tensor:
    """Bilinear resize of (B, C, H, W).  exact=True interpolates in f32 and
    returns f32 (final logits); exact=False stays in x's dtype
    (intermediate decoder features)."""
    out_hw = (int(out_hw[0]), int(out_hw[1]))
    if tuple(x.shape[-2:]) == out_hw:
        return x.float() if exact else x
    if exact:
        x = x.float()
    return F.interpolate(x, size=out_hw, mode="bilinear",
                         align_corners=align_corners)


def resize_f32(x: torch.Tensor, out_hw, align_corners: bool = True
               ) -> torch.Tensor:
    """JAX `resize_2d`'s default (exact) form on (B, C, H, W): interpolated
    in f32, returned in x's dtype."""
    return resize_nchw(x, out_hw, True, align_corners).to(x.dtype)
