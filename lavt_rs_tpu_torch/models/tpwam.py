"""The 3D PWAM of the video backbone (counterpart of
`lavt_rs_tpu/models/tpwam.py`): SepTPWAM, the published A2D default, and
the 2D PWAM on a clip's flattened tokens.

Visual features come in as (B, D, H, W, C) and the result is
(B, D*H*W, C).  The convolutions are `nn.Conv3d` on (B, C, D, H, W) with
"same" padding, under the reference's names (`temporal_vis_project.0`,
`f_query_t.0`, `W_t.0`, `project_mm_t.0`, ...), so reference checkpoints
load as they are; InstanceNorm3d (affine=False) is `instance_norm_nd`
over (D, H, W) with f32 statistics.  The language keys and values are
kernel-1 Conv1d weights (`f_key.0`, `f_value.0`) applied as linear maps.
Padding words are masked with the reference's `sim + (1e4 * mask - 1e4)`.
In training, `dropout` (`fusion.dropout`, --fusion_drop; 0 in the A2D
recipe) follows every Conv3d + GELU and the token-wise project_mm + GELU,
drawn from the generator passed to `forward` in the JAX module's order.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import BranchFuse, TPWAMConfig, TPWAMKind
from ..ops.dropout import dropout
from ..ops.norm import InstanceNormTokens, instance_norm_nd
from .pwam import PWAM, TokenConv1d


def _conv3d(c_in: int, c_out: int, kernel, bias: bool = True) -> nn.Conv3d:
    if any(k % 2 == 0 for k in kernel):
        raise NotImplementedError(f"even Conv3d kernel {kernel}: 'same' "
                                  "padding is ported for odd kernels only")
    return nn.Conv3d(c_in, c_out, tuple(kernel),
                     padding=tuple(k // 2 for k in kernel), bias=bias)


class InstanceNorm3dF32(nn.Module):
    """InstanceNorm3d (affine=False) of (B, C, D, H, W) in f32."""

    def forward(self, x):
        return instance_norm_nd(x, (2, 3, 4))


class ConvGELU3D(nn.Sequential):
    """Conv3d + exact GELU (`name.0` is the conv), then dropout at `rate`
    in training."""

    def __init__(self, c_in: int, c_out: int, kernel, rate: float = 0.0):
        super().__init__(_conv3d(c_in, c_out, kernel), nn.GELU())
        self.rate = rate

    def forward(self, x, generator=None):
        return dropout(self[1](self[0](x)), self.rate, self.training,
                       generator)


class ConvIN3D(nn.Sequential):
    """Conv3d + InstanceNorm3d(affine=False)."""

    def __init__(self, c_in: int, c_out: int, kernel):
        super().__init__(_conv3d(c_in, c_out, kernel), InstanceNorm3dF32())


class SelfGate3D(nn.Module):
    """x + tanh(fc2(relu(fc1(x)))) * x with bias-free 1x1x1 convs, zero at
    init (the factory keeps them zero)."""

    def __init__(self, dim: int):
        super().__init__()
        self.fc1 = _conv3d(dim, dim, (1, 1, 1), bias=False)
        self.fc2 = _conv3d(dim, dim, (1, 1, 1), bias=False)

    def forward(self, x):
        return x + torch.tanh(self.fc2(F.relu(self.fc1(x)))) * x


def cross_attention(query, key, value, l_mask, num_heads: int, dim: int):
    """(B, L, C) visual queries over (B, N_l, C) language keys/values: the
    scores in f32, scaled by dim^-1/2, padding words masked with the 1e4
    trick; probabilities and output rounded to the query's dtype."""
    b, length, _ = query.shape
    n_l = key.shape[1]
    h = num_heads
    q = query.reshape(b, length, h, dim // h).transpose(1, 2)
    k = key.reshape(b, n_l, h, dim // h).transpose(1, 2)
    v = value.reshape(b, n_l, h, dim // h).transpose(1, 2)
    sim = torch.matmul(q.float(), k.float().transpose(-1, -2)) * dim ** -0.5
    mf = l_mask.float()[:, None, None, :]
    attn = torch.softmax(sim + (1e4 * mf - 1e4), dim=-1).to(query.dtype)
    out = torch.matmul(attn.float(), v.float()).to(query.dtype)
    return out.transpose(1, 2).reshape(b, length, dim)


def _tokens(x):
    """(B, C, D, H, W) -> (B, D*H*W, C)."""
    return x.flatten(2).transpose(1, 2)


def _volume(t, dhw):
    """(B, D*H*W, C) -> (B, C, D, H, W)."""
    b, _, c = t.shape
    return t.transpose(1, 2).reshape(b, c, *dhw)


class SepTPWAM(nn.Module):
    """Decoupled temporal / spatial PWAM (reference
    video_swin_transformer.py:1300-1584)."""

    def __init__(self, dim: int, lang_dim: int = 768, num_heads: int = 1,
                 cfg: TPWAMConfig = TPWAMConfig(), dropout: float = 0.0):
        super().__init__()
        self.dim, self.num_heads, self.cfg = dim, num_heads, cfg
        self.dropout = dropout
        kt, ks = cfg.kernel_t, cfg.kernel_s
        fuse_k = cfg.fuse_kernel or kt
        self.temporal_vis_project = ConvGELU3D(dim, dim, kt, dropout)
        self.spatial_vis_project = ConvGELU3D(dim, dim, ks, dropout)
        self.f_query_t = ConvIN3D(dim, dim, kt)
        self.f_query_s = ConvIN3D(dim, dim, ks)
        if cfg.self_gate:
            for name in ("t_gate_v", "s_gate_v", "t_gate_q", "s_gate_q"):
                self.add_module(name, SelfGate3D(dim))
        if cfg.branch_fuse == BranchFuse.CAT:
            self.vis_fuse = ConvGELU3D(2 * dim, dim, fuse_k, dropout)
            self.f_fuse = ConvIN3D(2 * dim, dim, fuse_k)
        elif cfg.branch_fuse == BranchFuse.SUM_CONV:
            self.vis_fuse = ConvGELU3D(dim, dim, fuse_k, dropout)
            self.f_fuse = ConvIN3D(dim, dim, fuse_k)
        self.f_key = nn.Sequential(TokenConv1d(lang_dim, dim))
        self.f_value = nn.Sequential(TokenConv1d(lang_dim, dim))
        if cfg.w_single_conv:
            self.W = ConvIN3D(dim, dim, self._single(cfg.w_single_conv))
        elif cfg.w_t3x3_s1x1:
            self.W_t = ConvIN3D(dim, dim, kt)
            self.W_s = ConvIN3D(dim, dim, (1, 1, 1))
        else:
            self.W = nn.Sequential(TokenConv1d(dim, dim), InstanceNormTokens())
        if cfg.mm_single_conv:
            self.project_mm = ConvGELU3D(dim, dim,
                                         self._single(cfg.mm_single_conv),
                                         dropout)
        elif cfg.mm_t3x3_s1x1:
            self.project_mm_t = ConvGELU3D(dim, dim, kt, dropout)
            self.project_mm_s = ConvGELU3D(dim, dim, (1, 1, 1), dropout)
        else:
            self.project_mm = nn.Sequential(TokenConv1d(dim, dim), nn.GELU())

    def _single(self, kind: str):
        return self.cfg.kernel_t if kind == "3x3" else (1, 3, 3)

    def _fuse(self, t, s, conv: str, *args):
        kind = self.cfg.branch_fuse
        if kind == BranchFuse.CAT:
            return getattr(self, conv)(torch.cat([t, s], dim=1), *args)
        out = t + s
        return (getattr(self, conv)(out, *args) if kind == BranchFuse.SUM_CONV
                else out)

    def forward(self, x, l, l_mask, generator=None):
        """x (B, D, H, W, C); l (B, N_l, D_l); l_mask (B, N_l) in {0, 1};
        the generator draws the dropout in training."""
        cfg = self.cfg
        dhw = x.shape[1:4]
        xc = x.permute(0, 4, 1, 2, 3).contiguous()
        t_vis = self.temporal_vis_project(xc, generator)
        s_vis = self.spatial_vis_project(xc, generator)
        if cfg.self_gate:
            t_vis, s_vis = self.t_gate_v(t_vis), self.s_gate_v(s_vis)
        ts_vis = self._fuse(t_vis, s_vis, "vis_fuse", generator)
        q_t = self.f_query_t(xc)
        q_s = self.f_query_s(xc)
        if cfg.self_gate:
            q_t, q_s = self.t_gate_q(q_t), self.s_gate_q(q_s)
        query = _tokens(self._fuse(q_t, q_s, "f_fuse"))

        m = l_mask.to(x.dtype)[:, :, None]
        key = self.f_key(l) * m
        value = self.f_value(l) * m
        lang = cross_attention(query, key, value, l_mask, self.num_heads,
                               self.dim)
        if cfg.w_single_conv:
            lang = _tokens(self.W(_volume(lang, dhw)))
        elif cfg.w_t3x3_s1x1:
            lang3d = _volume(lang, dhw)
            lang = _tokens(self.W_t(lang3d) + self.W_s(lang3d))
        else:
            lang = self.W(lang)
        mm = _tokens(ts_vis) * lang
        if cfg.mm_single_conv:
            return _tokens(self.project_mm(_volume(mm, dhw), generator))
        if cfg.mm_t3x3_s1x1:
            mm3d = _volume(mm, dhw)
            return _tokens(self.project_mm_t(mm3d, generator)
                           + self.project_mm_s(mm3d, generator))
        return dropout(self.project_mm(mm), self.dropout, self.training,
                       generator)


class ClipPWAM(PWAM):
    """The 2D PWAM on a clip's flattened (B, D*H*W, C) tokens
    (TPWAMKind.PWAM2D)."""

    def forward(self, x, l, l_mask, generator=None):
        b, d, h, w, c = x.shape
        return super().forward(x.reshape(b, d * h * w, c), l, l_mask,
                               generator)


def build_tpwam(cfg: TPWAMConfig, dim: int, num_heads: int,
                lang_dim: int = 768, dropout: float = 0.0) -> nn.Module:
    """The 3D fusion module of one video stage: SepTPWAM or the clip-wide
    2D PWAM, with `dropout` (`fusion.dropout`) in training; the other
    variants are in the long-tail slice."""
    if cfg.kind == TPWAMKind.SEP:
        return SepTPWAM(dim, lang_dim, num_heads, cfg, dropout)
    if cfg.kind == TPWAMKind.PWAM2D:
        return ClipPWAM(dim, lang_dim, num_heads, dropout=dropout)
    raise NotImplementedError(
        f"3D PWAM kind {cfg.kind.value!r}: only SepTPWAM and the 2D PWAM are "
        "ported; the other variants are in the long-tail slice (ROADMAP.md "
        "slice 5)")
