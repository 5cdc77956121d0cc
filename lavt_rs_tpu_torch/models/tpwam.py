"""The 3D PWAM family of the video backbone (counterpart of
`lavt_rs_tpu/models/tpwam.py`, reference lib/video_swin_transformer.py:
1061-2089): SepTPWAM, the published A2D default; SepTPWAMInner
(--sep_t_pwam_inner); SepSeqTPWAM (--sep_seq_t_pwam, and with
`inner_only` --sep_seq_t_pwam_inner); TPWAM (--t_pwam; --t_pwam_comp
with W and project_mm as Conv3d too); TSPWAM (--ts_pwam: a temporal and
a spatial TPWAM summed or concatenated and reduced); SeqTPWAM
(--seq_t_pwam, with --res its P3D-C residual); and the 2D PWAM on a
clip's flattened tokens.

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

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import (BranchFuse, FusionConfig, FusionKind, TPWAMConfig,
                      TPWAMKind)
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


def _token_w(dim: int) -> nn.Sequential:
    """`W`: a kernel-1 Conv1d and InstanceNorm over the tokens."""
    return nn.Sequential(TokenConv1d(dim, dim), InstanceNormTokens())


def _token_mm(c_in: int, dim: int) -> nn.Sequential:
    """A token-wise kernel-1 Conv1d + GELU (`project_mm`, `out_reduce`)."""
    return nn.Sequential(TokenConv1d(c_in, dim), nn.GELU())


class _LangAttention(nn.Module):
    """The language keys and values (`f_key.0`, `f_value.0`, padding words
    zeroed), the cross attention and the token-wise `project_mm` that the
    3D kinds share."""

    def _lang_init(self, dim: int, lang_dim: int, num_heads: int,
                   dropout: float) -> None:
        self.dim, self.num_heads, self.dropout = dim, num_heads, dropout
        self.f_key = nn.Sequential(TokenConv1d(lang_dim, dim))
        self.f_value = nn.Sequential(TokenConv1d(lang_dim, dim))

    def attend(self, query, l, l_mask):
        """query (B, L, C) -> the attended language (B, L, C)."""
        m = l_mask.to(query.dtype)[:, :, None]
        return cross_attention(query, self.f_key(l) * m, self.f_value(l) * m,
                               l_mask, self.num_heads, self.dim)

    def project(self, mm, generator):
        """The token-wise `project_mm` (Conv1d + GELU) and its dropout."""
        return dropout(self.project_mm(mm), self.dropout, self.training,
                       generator)


class SepTPWAM(_LangAttention):
    """Decoupled temporal / spatial PWAM (reference
    video_swin_transformer.py:1300-1584)."""

    def __init__(self, dim: int, lang_dim: int = 768, num_heads: int = 1,
                 cfg: TPWAMConfig = TPWAMConfig(), dropout: float = 0.0):
        super().__init__()
        self.cfg = cfg
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
        self._lang_init(dim, lang_dim, num_heads, dropout)
        if cfg.w_single_conv:
            self.W = ConvIN3D(dim, dim, self._single(cfg.w_single_conv))
        elif cfg.w_t3x3_s1x1:
            self.W_t = ConvIN3D(dim, dim, kt)
            self.W_s = ConvIN3D(dim, dim, (1, 1, 1))
        else:
            self.W = _token_w(dim)
        if cfg.mm_single_conv:
            self.project_mm = ConvGELU3D(dim, dim,
                                         self._single(cfg.mm_single_conv),
                                         dropout)
        elif cfg.mm_t3x3_s1x1:
            self.project_mm_t = ConvGELU3D(dim, dim, kt, dropout)
            self.project_mm_s = ConvGELU3D(dim, dim, (1, 1, 1), dropout)
        else:
            self.project_mm = _token_mm(dim, dim)

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
        lang = self.attend(query, l, l_mask)
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
        return self.project(mm, generator)


class SepTPWAMInner(_LangAttention):
    """Inner-query-only decoupling (reference
    video_swin_transformer.py:1587-1694): the outer projection one 1x1x1
    Conv3d (`spatial_vis_project`), the query's temporal (kernel_t) and
    spatial (kernel_s) ConvIN branches summed; W and project_mm
    token-wise."""

    def __init__(self, dim: int, lang_dim: int = 768, num_heads: int = 1,
                 kernel_t=(3, 1, 1), kernel_s=(1, 1, 1),
                 dropout: float = 0.0):
        super().__init__()
        self._lang_init(dim, lang_dim, num_heads, dropout)
        self.spatial_vis_project = ConvGELU3D(dim, dim, (1, 1, 1), dropout)
        self.f_query_t = ConvIN3D(dim, dim, kernel_t)
        self.f_query_s = ConvIN3D(dim, dim, kernel_s)
        self.W = _token_w(dim)
        self.project_mm = _token_mm(dim, dim)

    def forward(self, x, l, l_mask, generator=None):
        xc = x.permute(0, 4, 1, 2, 3).contiguous()
        vis = _tokens(self.spatial_vis_project(xc, generator))
        query = _tokens(self.f_query_t(xc) + self.f_query_s(xc))
        lang = self.W(self.attend(query, l, l_mask))
        return self.project(vis * lang, generator)


class SepSeqTPWAM(_LangAttention):
    """Decoupled-sequential + parallel-spatial PWAM (reference
    video_swin_transformer.py:1822-2089): a spatial conv of its own kernel
    (kernel_sq) then the temporal one (kernel_t), with the P3D-C residual
    inside that branch under `residual`, plus a parallel spatial branch
    (kernel_s), for the outer projection and the query; `inner_only`
    (SepSeqTPWAMInner) makes the outer projection one 1x1x1 conv."""

    def __init__(self, dim: int, lang_dim: int = 768, num_heads: int = 1,
                 kernel_t=(3, 1, 1), kernel_s=(1, 1, 1), kernel_sq=(1, 1, 1),
                 residual: bool = False, inner_only: bool = False,
                 dropout: float = 0.0):
        super().__init__()
        self._lang_init(dim, lang_dim, num_heads, dropout)
        self.residual, self.inner_only = residual, inner_only
        if inner_only:
            self.spatial_vis_project = ConvGELU3D(dim, dim, (1, 1, 1),
                                                  dropout)
        else:
            self.spatial_vis_project_q = ConvGELU3D(dim, dim, kernel_sq,
                                                    dropout)
            self.temporal_vis_project_q = ConvGELU3D(dim, dim, kernel_t,
                                                     dropout)
            self.spatial_vis_project = ConvGELU3D(dim, dim, kernel_s,
                                                  dropout)
        self.f_query_s_q = ConvIN3D(dim, dim, kernel_sq)
        self.f_query_t_q = ConvIN3D(dim, dim, kernel_t)
        self.f_query_s = ConvIN3D(dim, dim, kernel_s)
        self.W = _token_w(dim)
        self.project_mm = _token_mm(dim, dim)

    def forward(self, x, l, l_mask, generator=None):
        xc = x.permute(0, 4, 1, 2, 3).contiguous()
        if self.inner_only:
            vis = self.spatial_vis_project(xc, generator)
        else:
            s_q = self.spatial_vis_project_q(xc, generator)
            t_q = self.temporal_vis_project_q(s_q, generator)
            if self.residual:
                t_q = s_q + t_q
            vis = t_q + self.spatial_vis_project(xc, generator)
        q_s_q = self.f_query_s_q(xc)
        q_t = self.f_query_t_q(q_s_q)
        if self.residual:
            q_t = q_s_q + q_t
        query = _tokens(q_t + self.f_query_s(xc))
        lang = self.W(self.attend(query, l, l_mask))
        return self.project(_tokens(vis) * lang, generator)


class TPWAM(_LangAttention):
    """Single-branch 3D-conv PWAM (reference video_swin_transformer.py:
    1186-1236): the outer projection (`vis_project`) and the query
    (`f_query`) one Conv3d each; with `all_conv3d` (TPWAMComp) W and
    project_mm Conv3d of the same kernel, else token-wise; `mm_conv` (the
    kernel of TSPWAM's --mm_3x3 temporal branch) makes project_mm alone a
    Conv3d."""

    def __init__(self, dim: int, lang_dim: int = 768, num_heads: int = 1,
                 kernel=(3, 1, 1), all_conv3d: bool = False, mm_conv=None,
                 dropout: float = 0.0):
        super().__init__()
        self._lang_init(dim, lang_dim, num_heads, dropout)
        self.w_conv = kernel if all_conv3d else None
        self.mm_conv = mm_conv or (kernel if all_conv3d else None)
        self.vis_project = ConvGELU3D(dim, dim, kernel, dropout)
        self.f_query = ConvIN3D(dim, dim, kernel)
        self.W = (ConvIN3D(dim, dim, self.w_conv) if self.w_conv
                  else _token_w(dim))
        self.project_mm = (ConvGELU3D(dim, dim, self.mm_conv, dropout)
                           if self.mm_conv else _token_mm(dim, dim))

    def forward(self, x, l, l_mask, generator=None):
        dhw = x.shape[1:4]
        xc = x.permute(0, 4, 1, 2, 3).contiguous()
        vis = _tokens(self.vis_project(xc, generator))
        lang = self.attend(_tokens(self.f_query(xc)), l, l_mask)
        lang = (_tokens(self.W(_volume(lang, dhw))) if self.w_conv
                else self.W(lang))
        mm = vis * lang
        if self.mm_conv:
            return _tokens(self.project_mm(_volume(mm, dhw), generator))
        return self.project(mm, generator)


class TSPWAM(nn.Module):
    """Two parallel PWAMs (reference video_swin_transformer.py:1061-1183):
    `temporal` (a TPWAM of kernel_t; with --mm_3x3 its project_mm a
    Conv3d of kernel_t) and `spatial` (1x1x1), summed (BranchFuse.SUM,
    --tspwam_sum), else concatenated (spatial first) and reduced by
    `out_reduce`: a token-wise Conv1d + GELU, or with --cat_reduce_3 a
    (1, 3, 3) Conv3d + GELU."""

    def __init__(self, dim: int, lang_dim: int = 768, num_heads: int = 1,
                 cfg: TPWAMConfig = TPWAMConfig(), dropout: float = 0.0):
        super().__init__()
        self.cfg, self.dropout = cfg, dropout
        self.temporal = TPWAM(dim, lang_dim, num_heads, cfg.kernel_t,
                              mm_conv=(cfg.kernel_t
                                       if cfg.mm_single_conv == "3x3"
                                       else None), dropout=dropout)
        self.spatial = TPWAM(dim, lang_dim, num_heads, (1, 1, 1),
                             dropout=dropout)
        if cfg.branch_fuse != BranchFuse.SUM:
            self.out_reduce = (ConvGELU3D(2 * dim, dim, cfg.fuse_kernel,
                                          dropout)
                               if cfg.fuse_kernel is not None
                               else _token_mm(2 * dim, dim))

    def forward(self, x, l, l_mask, generator=None):
        t = self.temporal(x, l, l_mask, generator)
        s = self.spatial(x, l, l_mask, generator)
        if self.cfg.branch_fuse == BranchFuse.SUM:
            return t + s
        out = torch.cat([s, t], dim=-1)
        if self.cfg.fuse_kernel is not None:
            return _tokens(self.out_reduce(_volume(out, x.shape[1:4]),
                                           generator))
        return dropout(self.out_reduce(out), self.dropout, self.training,
                       generator)


class SeqTPWAM(_LangAttention):
    """P3D-A style sequential spatial -> temporal PWAM (reference
    video_swin_transformer.py:1697-1819), with the P3D-C residual under
    `residual`: the outer projection and the query each a spatial conv
    (kernel_s) followed by a temporal one (kernel_t)."""

    def __init__(self, dim: int, lang_dim: int = 768, num_heads: int = 1,
                 kernel_t=(3, 1, 1), kernel_s=(1, 3, 3),
                 residual: bool = False, dropout: float = 0.0):
        super().__init__()
        self._lang_init(dim, lang_dim, num_heads, dropout)
        self.residual = residual
        self.spatial_vis_project = ConvGELU3D(dim, dim, kernel_s, dropout)
        self.temporal_vis_project = ConvGELU3D(dim, dim, kernel_t, dropout)
        self.f_query_s = ConvIN3D(dim, dim, kernel_s)
        self.f_query_t = ConvIN3D(dim, dim, kernel_t)
        self.W = _token_w(dim)
        self.project_mm = _token_mm(dim, dim)

    def forward(self, x, l, l_mask, generator=None):
        xc = x.permute(0, 4, 1, 2, 3).contiguous()
        s_vis = self.spatial_vis_project(xc, generator)
        t_vis = self.temporal_vis_project(s_vis, generator)
        vis = t_vis + s_vis if self.residual else t_vis
        q_s = self.f_query_s(xc)
        q_t = self.f_query_t(q_s)
        query = _tokens(q_t + q_s if self.residual else q_t)
        lang = self.W(self.attend(query, l, l_mask))
        return self.project(_tokens(vis) * lang, generator)


class ClipPWAM(PWAM):
    """The 2D PWAM on a clip's flattened (B, D*H*W, C) tokens
    (TPWAMKind.PWAM2D)."""

    def forward(self, x, l, l_mask, generator=None):
        b, d, h, w, c = x.shape
        return super().forward(x.reshape(b, d * h * w, c), l, l_mask,
                               generator)


def build_tpwam(cfg: TPWAMConfig, dim: int, num_heads: int,
                lang_dim: int = 768, dropout: float = 0.0,
                fusion: Optional[FusionConfig] = None) -> nn.Module:
    """The 3D fusion module of one video stage (JAX `build_tpwam`, the
    reference's eight flags), with `dropout` (`fusion.dropout`) in
    training; the clip-wide 2D PWAM takes `fusion`'s attention form
    (LangProject under --fuse simple) and att_norm."""
    k = cfg.kind
    if k == TPWAMKind.SEP:
        return SepTPWAM(dim, lang_dim, num_heads, cfg, dropout)
    if k == TPWAMKind.SEP_INNER:
        return SepTPWAMInner(dim, lang_dim, num_heads, cfg.kernel_t,
                             cfg.kernel_s, dropout)
    if k in (TPWAMKind.T, TPWAMKind.T_COMP):
        return TPWAM(dim, lang_dim, num_heads, cfg.kernel_t,
                     all_conv3d=k == TPWAMKind.T_COMP, dropout=dropout)
    if k == TPWAMKind.TS:
        return TSPWAM(dim, lang_dim, num_heads, cfg, dropout)
    if k == TPWAMKind.SEQ:
        return SeqTPWAM(dim, lang_dim, num_heads, cfg.kernel_t, cfg.kernel_s,
                        cfg.seq_residual, dropout)
    if k in (TPWAMKind.SEP_SEQ, TPWAMKind.SEP_SEQ_INNER):
        return SepSeqTPWAM(dim, lang_dim, num_heads, cfg.kernel_t,
                           cfg.kernel_s, cfg.kernel_sq, cfg.seq_residual,
                           k == TPWAMKind.SEP_SEQ_INNER, dropout)
    if k == TPWAMKind.PWAM2D:
        fusion = fusion or FusionConfig()
        return ClipPWAM(dim, lang_dim, num_heads,
                        attention=fusion.kind != FusionKind.SIMPLE,
                        att_norm=fusion.att_norm, dropout=dropout)
    raise ValueError(f"unknown 3D PWAM kind: {k}")
