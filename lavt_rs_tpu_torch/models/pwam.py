"""Pixel-Word Attention Module and the language gate (counterpart of
`lavt_rs_tpu/models/pwam.py`).

Visual tokens are (B, L, C) and language features (B, N_l, D_l).  The
reference's 1x1 Conv1d projections keep their Conv1d weights (out, in, 1)
and their names (`vis_project.0`, `image_lang_att.f_query.0`, ...), so
reference checkpoints load as they are; they are applied to channels-last
tokens as a linear map.  Padding words are masked with the reference's
`sim + (1e4 * mask - 1e4)`.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import AttnNorm, GateKind, LGAct
from ..ops.dropout import dropout
from ..ops.norm import InstanceNormTokens


class TokenConv1d(nn.Conv1d):
    """A kernel-1 Conv1d (reference parameter shape) applied to
    channels-last (..., C) tokens."""

    def __init__(self, c_in: int, c_out: int):
        super().__init__(c_in, c_out, 1)

    def forward(self, x):
        return F.linear(x, self.weight[:, :, 0], self.bias)


def _att_norm(kind: AttnNorm) -> nn.Module:
    if kind == AttnNorm.IN:
        return InstanceNormTokens()
    raise NotImplementedError(
        f"att_norm {kind.value!r}: only the published IN is ported (the "
        "BN/LN variants are in the long-tail slice, ROADMAP.md item 3, "
        "slice 5)")


class SpatialImageLanguageAttention(nn.Module):
    """Multi-head cross attention: visual queries over language keys/values."""

    def __init__(self, v_in: int, l_in: int, key_channels: int,
                 value_channels: int, num_heads: int = 1,
                 att_norm: AttnNorm = AttnNorm.IN):
        super().__init__()
        self.key_channels, self.value_channels = key_channels, value_channels
        self.num_heads = num_heads
        self.f_query = nn.Sequential(TokenConv1d(v_in, key_channels),
                                     _att_norm(att_norm))
        self.f_key = nn.Sequential(TokenConv1d(l_in, key_channels))
        self.f_value = nn.Sequential(TokenConv1d(l_in, value_channels))
        self.W = nn.Sequential(TokenConv1d(value_channels, value_channels),
                               _att_norm(att_norm))

    def forward(self, x, l, l_mask):
        """x: (B, L, C_v); l: (B, N_l, D_l); l_mask: (B, N_l) in {0, 1}."""
        b, hw, _ = x.shape
        n_l = l.shape[1]
        h = self.num_heads
        kc, vc = self.key_channels, self.value_channels
        m = l_mask.to(x.dtype)[:, :, None]
        query = self.f_query(x)
        key = self.f_key(l) * m
        value = self.f_value(l) * m
        q = query.view(b, hw, h, kc // h).transpose(1, 2)
        k = key.view(b, n_l, h, kc // h).transpose(1, 2)
        v = value.view(b, n_l, h, vc // h).transpose(1, 2)
        sim = torch.matmul(q.float(), k.float().transpose(-1, -2)) * kc ** -0.5
        mf = l_mask.float()[:, None, None, :]
        attn = torch.softmax(sim + (1e4 * mf - 1e4), dim=-1).to(x.dtype)
        out = torch.matmul(attn.float(), v.float()).to(x.dtype)
        out = out.transpose(1, 2).reshape(b, hw, vc)
        return self.W(out)


class PWAM(nn.Module):
    """mm = project_mm(vis_project(x) * image_lang_att(x, l, l_mask)), with
    `dropout` (--fusion_drop, 0 by default) after both projections in
    training."""

    def __init__(self, dim: int, lang_dim: int = 768, num_heads: int = 1,
                 attention: bool = True, att_norm: AttnNorm = AttnNorm.IN,
                 dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        if not attention:
            raise NotImplementedError(
                "LangProject (--fuse simple) is in the long-tail slice "
                "(ROADMAP.md item 3, slice 5)")
        self.vis_project = nn.Sequential(TokenConv1d(dim, dim), nn.GELU())
        self.image_lang_att = SpatialImageLanguageAttention(
            dim, lang_dim, dim, dim, num_heads, att_norm)
        self.project_mm = nn.Sequential(TokenConv1d(dim, dim), nn.GELU())

    def forward(self, x, l, l_mask, generator=None):
        vis = dropout(self.vis_project(x), self.dropout, self.training,
                      generator)
        lang = self.image_lang_att(x, l, l_mask)
        return dropout(self.project_mm(vis * lang), self.dropout,
                       self.training, generator)


class LanguageGate(nn.Sequential):
    """Linear -> ReLU -> Linear -> tanh/sigmoid, both Linears bias-free and
    zero-initialized: at init the fusion branch is exactly off.  A
    Sequential, so the names are the reference's `res_gate.0`/`res_gate.2`."""

    def __init__(self, dim: int, act: LGAct = LGAct.TANH):
        super().__init__(nn.Linear(dim, dim, bias=False), nn.ReLU(),
                         nn.Linear(dim, dim, bias=False),
                         nn.Tanh() if act == LGAct.TANH else nn.Sigmoid())
        nn.init.zeros_(self[0].weight)
        nn.init.zeros_(self[2].weight)


def apply_gate(x, mm, gate_out, kind: GateKind):
    if kind == GateKind.DEFAULT:
        return x + gate_out * mm
    if kind == GateKind.NO_GATE:
        return x + mm
    return x
