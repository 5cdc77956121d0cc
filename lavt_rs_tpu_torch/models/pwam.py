"""Pixel-Word Attention Module and the language gate (counterpart of
`lavt_rs_tpu/models/pwam.py`).

Visual tokens are (B, L, C) and language features (B, N_l, D_l).  The
reference's 1x1 Conv1d projections keep their Conv1d weights (out, in, 1)
and their names (`vis_project.0`, `image_lang_att.f_query.0`, ...), so
reference checkpoints load as they are; they are applied to channels-last
tokens as a linear map.  Padding words are masked with the reference's
`sim + (1e4 * mask - 1e4)`.

The attention's norms after `f_query` and `W` (--att_norm_layer_type) are
the reference's second Sequential entries, `f_query.1` and `W.1`: the
published InstanceNorm (no parameters), a LayerNorm (eps 1e-5), a
BatchNorm1d over (B, L) per channel (batch statistics in training,
running ones in eval; a plain `nn.BatchNorm1d`, so `parallel.ddp.
convert_sync_bn` makes it cross-process), or none (the Sequential holds
only its conv).  `--fuse simple` swaps the attention for `LangProject`
(`image_lang_att.project.0` / `.2`), whose (B, 1, C) sentence projection
multiplies every pixel.
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


def masked_mean(l: torch.Tensor, l_mask: torch.Tensor) -> torch.Tensor:
    """(B, N_l, D) -> (B, D): the mean of the unmasked words in f32 (the
    kept words' sum over the mask's sum, JAX `_masked_meanpool`)."""
    m = l_mask.float()[:, :, None]
    return (l.float() * m).sum(1) / m.sum(1)


def _att_norm(kind: AttnNorm, c: int) -> list:
    """The norm after a projection of the attention, as the Sequential's
    second entry (none for AttnNorm.NONE)."""
    if kind == AttnNorm.IN:
        return [InstanceNormTokens()]
    if kind == AttnNorm.LN:
        return [nn.LayerNorm(c, eps=1e-5)]
    if kind == AttnNorm.BN:
        return [nn.BatchNorm1d(c, eps=1e-5)]
    return []


class NormedProjection(nn.Sequential):
    """A token projection (`name.0`) and its att_norm (`name.1`, if any) on
    (B, L, C) tokens.  The BatchNorm1d takes (B, C, L), in f32: the JAX
    module's statistics and normalization are f32 whatever the compute
    dtype, its output in the input's."""

    def forward(self, x):
        y = self[0](x)
        if len(self) == 1:
            return y
        norm = self[1]
        if isinstance(norm, nn.BatchNorm1d):
            return norm(y.transpose(1, 2).float()).transpose(1, 2).to(y.dtype)
        return norm(y)


class SpatialImageLanguageAttention(nn.Module):
    """Multi-head cross attention: visual queries over language keys/values."""

    def __init__(self, v_in: int, l_in: int, key_channels: int,
                 value_channels: int, num_heads: int = 1,
                 att_norm: AttnNorm = AttnNorm.IN):
        super().__init__()
        self.key_channels, self.value_channels = key_channels, value_channels
        self.num_heads = num_heads
        self.f_query = NormedProjection(TokenConv1d(v_in, key_channels),
                                        *_att_norm(att_norm, key_channels))
        self.f_key = nn.Sequential(TokenConv1d(l_in, key_channels))
        self.f_value = nn.Sequential(TokenConv1d(l_in, value_channels))
        self.W = NormedProjection(TokenConv1d(value_channels, value_channels),
                                  *_att_norm(att_norm, value_channels))

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


class LangGen(nn.Module):
    """A sentence vector's 2-layer projection Linear -> ReLU -> Linear
    (`project.0`, `project.2`): the `lang_gen` of LTS and GACD."""

    def __init__(self, l_in: int, c_out: int):
        super().__init__()
        self.project = nn.Sequential(nn.Linear(l_in, c_out), nn.ReLU(),
                                     nn.Linear(c_out, c_out))

    def forward(self, s):
        return self.project(s)


class LangProject(LangGen):
    """The `--fuse simple` ablation (JAX `pwam.LangProject`, reference
    lib/backbone.py:1375-1402): the masked mean of the words in f32, cast
    to the compute dtype, through `LangGen`, as (B, 1, C)."""

    def forward(self, x, l, l_mask):
        return super().forward(masked_mean(l, l_mask).to(x.dtype))[:, None, :]


class PWAM(nn.Module):
    """mm = project_mm(vis_project(x) * image_lang_att(x, l, l_mask)), with
    `dropout` (--fusion_drop, 0 by default) after both projections in
    training; `attention=False` (--fuse simple) takes `LangProject`'s
    sentence projection for the attention."""

    def __init__(self, dim: int, lang_dim: int = 768, num_heads: int = 1,
                 attention: bool = True, att_norm: AttnNorm = AttnNorm.IN,
                 dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.vis_project = nn.Sequential(TokenConv1d(dim, dim), nn.GELU())
        self.image_lang_att = (
            SpatialImageLanguageAttention(dim, lang_dim, dim, dim, num_heads,
                                          att_norm)
            if attention else LangProject(lang_dim, dim))
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
