"""Normalization helpers (counterpart of `lavt_rs_tpu/ops/norm.py`)."""

from __future__ import annotations

import torch

# constants mirror lavt_rs_tpu/data/transforms.py IMAGENET_MEAN/STD
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def maybe_normalize_image(x: torch.Tensor) -> torch.Tensor:
    """ImageNet normalization of a uint8 (..., 3) image on its device, in
    f32; float inputs are taken as already normalized and pass through."""
    if x.dtype != torch.uint8:
        return x
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=x.device)
    return (x.to(torch.float32) / 255.0 - mean) / std


def instance_norm_tokens(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm1d(affine=False) over (..., L, C) tokens: per channel,
    statistics over L in f32 (biased variance, like torch)."""
    xf = x.float()
    mean = xf.mean(dim=-2, keepdim=True)
    var = (xf - mean).square().mean(dim=-2, keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


class InstanceNormTokens(torch.nn.Module):
    """Module form of instance_norm_tokens; like torch's InstanceNorm1d
    with affine=False it holds no state."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return instance_norm_tokens(x)


def instance_norm_nd(x: torch.Tensor, dims, eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm (affine=False) of a channels-last tensor over `dims`
    (e.g. (1, 2, 3) of (B, D, H, W, C), like torch's InstanceNorm3d on
    (B, C, D, H, W)): per sample and channel, f32 statistics, biased
    variance."""
    xf = x.float()
    mean = xf.mean(dim=dims, keepdim=True)
    var = (xf - mean).square().mean(dim=dims, keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)
