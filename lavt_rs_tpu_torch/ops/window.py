"""Window partition / reverse, shifted-window masks and relative-position
bias for 2D Swin attention (counterpart of `lavt_rs_tpu/ops/window.py`,
2D part).

The JAX package fuses shift + partition into static gathers and expands
the bias table with one-hot matmuls; both work around the TPU and are not
ported.  Here the partition is `torch.roll` + `view` + `permute`, the mask
is built once per (shape, device) and the bias is a plain gather.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * H//ws * W//ws, ws*ws, C). H, W divisible by ws."""
    b, h, w, c = x.shape
    x = x.view(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def window_reverse(windows: torch.Tensor, ws: int, h: int, w: int) -> torch.Tensor:
    """Inverse of window_partition: (B*nW, ws*ws, C) -> (B, H, W, C)."""
    c = windows.shape[-1]
    b = windows.shape[0] // ((h // ws) * (w // ws))
    x = windows.view(b, h // ws, w // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, c)


def shift_region_ids_2d(hp: int, wp: int, ws: int, shift: int) -> np.ndarray:
    """(nW, ws*ws) int32 region ids of each windowed token."""
    img = np.zeros((hp, wp), dtype=np.int32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for vs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, vs] = cnt
            cnt += 1
    img = img.reshape(hp // ws, ws, wp // ws, ws).transpose(0, 2, 1, 3)
    return np.ascontiguousarray(img.reshape(-1, ws * ws))


@functools.lru_cache(maxsize=64)
def _shift_mask_cached(hp: int, wp: int, ws: int, shift: int,
                       device: torch.device) -> torch.Tensor:
    ids = torch.from_numpy(shift_region_ids_2d(hp, wp, ws, shift)).to(device)
    mask = torch.where(ids[:, None, :] != ids[:, :, None], -100.0, 0.0)
    return mask.to(torch.float32).contiguous()


def shift_mask_2d(hp: int, wp: int, ws: int, shift: int,
                  device="cpu") -> Optional[torch.Tensor]:
    """Additive (nW, N, N) f32 SW-MSA mask (0 / -100) for padded size
    (hp, wp), built once per shape and device; None when shift == 0."""
    if shift == 0:
        return None
    return _shift_mask_cached(hp, wp, ws, shift, torch.device(device))


@functools.lru_cache(maxsize=64)
def relative_position_index_2d(wh: int, ww: int) -> np.ndarray:
    """(Wh*Ww, Wh*Ww) index into the (2Wh-1)(2Ww-1) bias table."""
    coords = np.stack(np.meshgrid(np.arange(wh), np.arange(ww), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += wh - 1
    rel[:, :, 1] += ww - 1
    rel[:, :, 0] *= 2 * ww - 1
    return rel.sum(-1)


def relative_bias_from_table(table: torch.Tensor, index: torch.Tensor
                             ) -> torch.Tensor:
    """(h, N, N) f32 bias from a ((2Wh-1)(2Ww-1), h) table and the (N, N)
    index of `relative_position_index_2d`: a plain gather."""
    n = index.shape[0]
    bias = table.float()[index.reshape(-1)].view(n, n, -1)
    return bias.permute(2, 0, 1).contiguous()
