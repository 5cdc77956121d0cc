"""Bilinear and bicubic resize (counterpart of `lavt_rs_tpu/ops/resize.py`).

The JAX package builds this from two interpolation matmuls for the TPU's
matrix unit; here it is `F.interpolate`.  Bilinear is corner-aligned
unless `align_corners=False` (the half-pixel form with source indices
clamped at 0, JAX `_linear_matrix_np`'s and torch's), which the LTS
decoder's last upsample and EFN's pooled attention take.  Bicubic (the
absolute position embedding's resize) is torch's: a = -0.75, half-pixel
source indices, taps clamped at the edges, as JAX `_cubic_matrix_np`.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

# torch's CUDA upsampling indexes its output with 32-bit integers: a larger
# output (seg_last's 480² decoder map at 512 channels and an eval batch of
# 24 sentences: 2.8e9 elements) is resized in batch chunks under it
MAX_ELEMENTS = 2 ** 31 - 1


def resize_nchw(x: torch.Tensor, out_hw, exact: bool = True,
                align_corners: bool = True,
                mode: str = "bilinear") -> torch.Tensor:
    """Bilinear (or bicubic) resize of (B, C, H, W).  exact=True
    interpolates in f32 and returns f32 (final logits); exact=False stays
    in x's dtype (intermediate decoder features)."""
    out_hw = (int(out_hw[0]), int(out_hw[1]))
    if tuple(x.shape[-2:]) == out_hw:
        return x.float() if exact else x
    if exact:
        x = x.float()
    per_sample = x.shape[1] * math.prod(out_hw)
    if x.shape[0] * per_sample > MAX_ELEMENTS:
        return torch.cat([
            F.interpolate(part, size=out_hw, mode=mode,
                          align_corners=align_corners)
            for part in x.split(max(1, MAX_ELEMENTS // per_sample))])
    return F.interpolate(x, size=out_hw, mode=mode,
                         align_corners=align_corners)


def resize_f32(x: torch.Tensor, out_hw, align_corners: bool = True,
               mode: str = "bilinear") -> torch.Tensor:
    """JAX `resize_2d`'s default (exact) form on (B, C, H, W): interpolated
    in f32, returned in x's dtype."""
    return resize_nchw(x, out_hw, True, align_corners, mode).to(x.dtype)
