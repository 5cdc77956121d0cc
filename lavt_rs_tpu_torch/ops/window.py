"""Window partition / reverse, shifted-window masks and relative-position
bias for 2D and 3D Swin attention (counterpart of `lavt_rs_tpu/ops/window.py`).

The JAX package fuses the 2D shift + partition into static gathers and
expands the bias tables with one-hot matmuls; both work around the TPU and
are not ported.  Here the 2D partition is `torch.roll` + `view` +
`permute`, masks are built once per (shape, device) and the biases are
plain gathers.  The 3D grouped partition (pad + shift + partition + token
pad as one gather, windows ordered unmasked-first) is kept: it lets a
shifted video block run the padded MSA kernel (K2p) maskless on most
windows and under a small mask on the rest; its index tensors are cached
per (shape, device).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

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
                  device) -> Optional[torch.Tensor]:
    """Additive (nW, N, N) f32 SW-MSA mask (0 / -100) for padded size
    (hp, wp), built once per shape and device; None when shift == 0.  The
    device is required: the mask belongs beside the activations (at
    video stage 1 the 3D mask is 199 MB)."""
    if shift == 0:
        return None
    return _shift_mask_cached(hp, wp, ws, shift, torch.device(device))


def _ids_to_flags(ids: np.ndarray, device) -> torch.Tensor:
    """(nW,) int32: 1 where a window's tokens lie in more than one region
    (its shift mask has a nonzero), else 0."""
    flags = (ids != ids[:, :1]).any(axis=1).astype(np.int32)
    return torch.from_numpy(flags).to(device)


@functools.lru_cache(maxsize=64)
def _shift_flags_cached(hp: int, wp: int, ws: int, shift: int,
                        device: torch.device) -> torch.Tensor:
    return _ids_to_flags(shift_region_ids_2d(hp, wp, ws, shift), device)


def shift_mask_flags_2d(hp: int, wp: int, ws: int, shift: int,
                        device) -> Optional[torch.Tensor]:
    """The (nW,) int32 window flags of `shift_mask_2d`'s mask (1 where a
    window's mask has a nonzero), built once per shape and device from the
    region ids; None when shift == 0.  K9 reads the masks of flagged
    windows only (`window_attn.attention_core_bwd`)."""
    if shift == 0:
        return None
    return _shift_flags_cached(hp, wp, ws, shift, torch.device(device))


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


# -- 3D (the video backbone) ----------------------------------------------------

def window_partition_3d(x: torch.Tensor, ws) -> torch.Tensor:
    """(B, D, H, W, C) -> (B * nW, wd*wh*ww, C); dims divisible by ws."""
    b, d, h, w, c = x.shape
    wd, wh, ww = ws
    x = x.view(b, d // wd, wd, h // wh, wh, w // ww, ww, c)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(-1, wd * wh * ww, c)


def window_reverse_3d(windows: torch.Tensor, ws, d: int, h: int, w: int
                      ) -> torch.Tensor:
    """Inverse of window_partition_3d: (B*nW, N, C) -> (B, D, H, W, C)."""
    wd, wh, ww = ws
    c = windows.shape[-1]
    b = windows.shape[0] // ((d // wd) * (h // wh) * (w // ww))
    x = windows.view(b, d // wd, h // wh, w // ww, wd, wh, ww, c)
    x = x.permute(0, 1, 4, 2, 5, 3, 6, 7)
    return x.reshape(b, d, h, w, c)


def get_window_size_3d(input_size, window_size, shift_size=None):
    """Clamp window and shift to the input dims: where an input dim is <=
    the window dim, the window takes the input dim and its shift is 0."""
    use_ws = list(window_size)
    use_ss = list(shift_size) if shift_size is not None else None
    for i in range(len(input_size)):
        if input_size[i] <= window_size[i]:
            use_ws[i] = input_size[i]
            if use_ss is not None:
                use_ss[i] = 0
    if shift_size is None:
        return tuple(use_ws)
    return tuple(use_ws), tuple(use_ss)


def _regions(size: int, win: int, shift: int):
    return ((slice(0, -win), slice(-win, -shift), slice(-shift, None))
            if shift else (slice(0, -win), slice(-win, None)))


@functools.lru_cache(maxsize=64)
def shift_region_ids_3d(dp: int, hp: int, wp: int, ws: Tuple[int, int, int],
                        ss: Tuple[int, int, int]) -> np.ndarray:
    """(nW, wd*wh*ww) int32 region ids of each windowed token of the
    padded (dp, hp, wp) volume under shift ss."""
    img = np.zeros((dp, hp, wp), dtype=np.int32)
    cnt = 0
    for ds_ in _regions(dp, ws[0], ss[0]):
        for hs in _regions(hp, ws[1], ss[1]):
            for vs in _regions(wp, ws[2], ss[2]):
                img[ds_, hs, vs] = cnt
                cnt += 1
    wd, wh, ww = ws
    img = img.reshape(dp // wd, wd, hp // wh, wh, wp // ww, ww)
    img = img.transpose(0, 2, 4, 1, 3, 5).reshape(-1, wd * wh * ww)
    return np.ascontiguousarray(img)


def _ids_to_mask(ids: np.ndarray, device) -> torch.Tensor:
    idt = torch.from_numpy(ids).to(device)
    mask = torch.where(idt[:, None, :] != idt[:, :, None], -100.0, 0.0)
    return mask.to(torch.float32).contiguous()


@functools.lru_cache(maxsize=32)
def _shift_mask_3d_cached(dp, hp, wp, ws, ss, device) -> torch.Tensor:
    return _ids_to_mask(shift_region_ids_3d(dp, hp, wp, ws, ss), device)


def shift_mask_3d(dp: int, hp: int, wp: int, ws, ss,
                  device) -> Optional[torch.Tensor]:
    """Additive (nW, N, N) f32 mask (0 / -100) of the shifted 3D windows,
    built once per shape and device (required, as for `shift_mask_2d`);
    None when no dim is shifted."""
    ws, ss = tuple(int(v) for v in ws), tuple(int(v) for v in ss)
    if not any(ss):
        return None
    return _shift_mask_3d_cached(dp, hp, wp, ws, ss, torch.device(device))


@functools.lru_cache(maxsize=32)
def _shift_flags_3d_cached(dp, hp, wp, ws, ss, device) -> torch.Tensor:
    return _ids_to_flags(shift_region_ids_3d(dp, hp, wp, ws, ss), device)


def shift_mask_flags_3d(dp: int, hp: int, wp: int, ws, ss,
                        device) -> Optional[torch.Tensor]:
    """The (nW,) int32 window flags of `shift_mask_3d`'s mask, as
    `shift_mask_flags_2d` gives them; None when no dim is shifted."""
    ws, ss = tuple(int(v) for v in ws), tuple(int(v) for v in ss)
    if not any(ss):
        return None
    return _shift_flags_3d_cached(dp, hp, wp, ws, ss, torch.device(device))


@functools.lru_cache(maxsize=16)
def relative_position_index_3d(wd: int, wh: int, ww: int) -> np.ndarray:
    """(N, N) index into the (2wd-1)(2wh-1)(2ww-1) bias table."""
    coords = np.stack(np.meshgrid(np.arange(wd), np.arange(wh), np.arange(ww),
                                  indexing="ij"))
    flat = coords.reshape(3, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += wd - 1
    rel[:, :, 1] += wh - 1
    rel[:, :, 2] += ww - 1
    rel[:, :, 0] *= (2 * wh - 1) * (2 * ww - 1)
    rel[:, :, 1] *= 2 * ww - 1
    return rel.sum(-1)


def relative_bias_from_table_3d(table: torch.Tensor, index: torch.Tensor,
                                n: int) -> torch.Tensor:
    """(h, n, n) f32 bias = table[index[:n, :n]]: the full window's index,
    truncated on a clamped window as the reference does."""
    idx = index[:n, :n].reshape(-1)
    bias = table.float()[idx].view(n, n, -1)
    return bias.permute(2, 0, 1).contiguous()


@functools.lru_cache(maxsize=32)
def grouped_partition_idx_3d(d: int, h: int, w: int, dp: int, hp: int,
                             wp: int, ws: Tuple[int, int, int],
                             ss: Tuple[int, int, int], n_p: int):
    """Index arrays of the grouped 3D partition: zero-pad + cyclic shift +
    window partition + token pad (N -> n_p) as one gather, with the
    windows permuted so the unmasked ones (no shift boundary inside) come
    first.  Returns (fwd, inv, nu, ids_masked):
      fwd (nW n_p,) indices into the flat (d h w) source, every pad
        position mapped to the sentinel d h w (one appended zero row);
      inv (d h w,) the position of each real token in the windowed stream;
      nu the number of unmasked windows (the prefix);
      ids_masked (nW - nu, N) region ids of the masked windows."""
    wd, wh, ww = ws
    n = wd * wh * ww
    nw = (dp // wd) * (hp // wh) * (wp // ww)
    di, hi, wi, i, j, k = np.meshgrid(
        np.arange(dp // wd), np.arange(hp // wh), np.arange(wp // ww),
        np.arange(wd), np.arange(wh), np.arange(ww), indexing="ij")
    sd = (di * wd + i + ss[0]) % dp
    sh = (hi * wh + j + ss[1]) % hp
    sw = (wi * ww + k + ss[2]) % wp
    real = (sd < d) & (sh < h) & (sw < w)
    src = np.where(real, (sd * h + sh) * w + sw, d * h * w).astype(np.int64)
    src = src.reshape(nw, n)
    real = real.reshape(nw, n)
    if any(ss):
        ids = shift_region_ids_3d(dp, hp, wp, ws, ss)
        masked = np.array([len(np.unique(r)) > 1 for r in ids])
    else:
        ids = np.zeros((nw, n), np.int32)
        masked = np.zeros((nw,), bool)
    perm = np.concatenate([np.nonzero(~masked)[0], np.nonzero(masked)[0]])
    nu = int((~masked).sum())
    src_p, real_p = src[perm], real[perm]
    pad_tokens = np.full((nw, n_p - n), d * h * w, np.int64)
    fwd = np.concatenate([src_p, pad_tokens], axis=1).reshape(-1)
    inv = np.empty(d * h * w, np.int64)
    wpos, tpos = np.nonzero(real_p)
    inv[src_p[real_p]] = wpos * n_p + tpos
    return (np.ascontiguousarray(fwd), np.ascontiguousarray(inv), nu,
            np.ascontiguousarray(ids[perm[nu:]]))


@functools.lru_cache(maxsize=32)
def _grouped_cached(d, h, w, dp, hp, wp, ws, ss, n_p, device):
    """(fwd, inv) index tensors, nu and the (nW - nu, n_p, n_p) small mask
    (or None) on `device`."""
    fwd, inv, nu, ids = grouped_partition_idx_3d(d, h, w, dp, hp, wp, ws, ss,
                                                 n_p)
    mask = None
    if ids.shape[0]:
        mask = _ids_to_mask(ids, device)
        p = n_p - mask.shape[1]
        if p:
            mask = torch.nn.functional.pad(mask, (0, p, 0, p)).contiguous()
    return (torch.from_numpy(fwd).to(device), torch.from_numpy(inv).to(device),
            nu, mask)


def partition_3d_groups(d: int, h: int, w: int, dp: int, hp: int, wp: int,
                        ws, ss, n_p: int, device):
    """(nu, mask_small or None) of the grouped partition: nu unmasked
    windows first, then the masked ones under the (nW - nu, n_p, n_p)
    additive mask on `device` (required), zero on the padded rows and
    columns (the padded keys are killed by the bias)."""
    _, _, nu, mask = _grouped_cached(d, h, w, dp, hp, wp, tuple(ws),
                                     tuple(ss), n_p, torch.device(device))
    return nu, mask


def partition_shifted_padded_3d(x: torch.Tensor, ws, ss, dp: int, hp: int,
                                wp: int, n_p: int) -> torch.Tensor:
    """(B, D, H, W, C) -> (B, nW, n_p, C): pad + shift + partition + token
    pad as one gather, windows permuted unmasked-first."""
    b, d, h, w, c = x.shape
    fwd, _, _, _ = _grouped_cached(d, h, w, dp, hp, wp, tuple(ws), tuple(ss),
                                   n_p, x.device)
    nw = fwd.shape[0] // n_p
    xa = torch.cat([x.reshape(b, d * h * w, c), x.new_zeros((b, 1, c))], 1)
    return xa.index_select(1, fwd).view(b, nw, n_p, c)


def reverse_shifted_unpadded_3d(xw: torch.Tensor, ws, ss, dp: int, hp: int,
                                wp: int, d: int, h: int, w: int,
                                n_p: int) -> torch.Tensor:
    """Inverse of partition_shifted_padded_3d: (B, nW, n_p, C) ->
    (B, D, H, W, C)."""
    b, nw, _, c = xw.shape
    _, inv, _, _ = _grouped_cached(d, h, w, dp, hp, wp, tuple(ws), tuple(ss),
                                   n_p, xw.device)
    return xw.reshape(b, nw * n_p, c).index_select(1, inv).view(b, d, h, w, c)
