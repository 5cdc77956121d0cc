"""Corner-aligned bilinear resize (counterpart of `lavt_rs_tpu/ops/resize.py`).

The JAX package builds this from two interpolation matmuls for the TPU's
matrix unit; here it is `F.interpolate(align_corners=True)`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_nchw(x: torch.Tensor, out_hw, exact: bool = True) -> torch.Tensor:
    """Bilinear, corner-aligned resize of (B, C, H, W).  exact=True
    interpolates in f32 and returns f32 (final logits); exact=False stays
    in x's dtype (intermediate decoder features)."""
    out_hw = (int(out_hw[0]), int(out_hw[1]))
    if tuple(x.shape[-2:]) == out_hw:
        return x.float() if exact else x
    if exact:
        x = x.float()
    return F.interpolate(x, size=out_hw, mode="bilinear", align_corners=True)
