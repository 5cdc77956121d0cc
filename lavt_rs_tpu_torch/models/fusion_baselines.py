"""The alternative fusion baselines BCAM, GACD and EFN (counterpart of
`lavt_rs_tpu/models/fusion_baselines.py`, reference lib/bcam.py).

  * BCAM (--bcam): BRINet's bi-directional cross-attention
    (bcam.py:7-72).  Its relevance map is a learned Linear to the stage's
    H*W (`a_proj`), so the module is bound to one map size: `hw` is given
    at construction (the multimodal Swin computes it from the config's
    image size) and a forward at another size raises.
  * GACD (--gacd): GARAN's collect-diffuse attention (bcam.py:75-127).
  * EFN (--efn) and EFNAttention: the sentence-concat projection and the
    mutual H*W x H*W attention, with a 2x average pool and a half-pixel
    bilinear resize back above 225 tokens (bcam.py:160-269).

Layouts: x (B, H*W, C); l (B, N_l, D_l); l_mask (B, N_l) in {0, 1}.  The
names are the reference's (`vis_1.0`, `lang_gen.project.0`,
`image_lang_att.W.0`, ...), so its checkpoints load as they are.
Precision as in the JAX modules: the projections in the compute dtype;
the scores' products from compute-dtype operands accumulated in f32 and
their softmax in f32; the other products accumulated in f32 and cast
back to the compute dtype (a bf16 matmul on the card accumulates in
f32); the masked means of the words in f32.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..ops.norm import instance_norm_tokens
from ..ops.resize import resize_f32
from .pwam import LangGen, TokenConv1d, masked_mean


def _scores(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ bᵀ in f32 from compute-dtype operands (bf16 -> f32 is exact)."""
    return torch.matmul(a.float(), b.float().transpose(-1, -2))


def _mask_bias(l_mask: torch.Tensor) -> torch.Tensor:
    """The reference's padding-word term 1e4 * mask - 1e4, (B, 1, N_l)."""
    return 1e4 * l_mask.float()[:, None, :] - 1e4


def _relu_linear(c_in: int, c_out: int) -> nn.Sequential:
    return nn.Sequential(nn.Linear(c_in, c_out), nn.ReLU())


class BCAM(nn.Module):
    """Bi-directional cross-attention (BRINet); `hw` is the stage's H*W,
    the size of the learned relevance projection `a_proj`."""

    def __init__(self, dim: int, hw: int, l_in: int = 768):
        super().__init__()
        self.hw = hw
        self.lang_reduce = nn.Linear(l_in, dim)
        for i in (1, 2, 3, 4):
            self.add_module(f"vis_{i}", _relu_linear(dim, dim))
        self.out_1 = nn.Linear(dim, dim)
        self.vis_2_2 = nn.Linear(dim, dim)
        self.a_proj = nn.Linear(dim, hw)
        self.out3_proj = _relu_linear(2 * dim, dim)

    def forward(self, x, l, l_mask, generator=None):
        if x.shape[1] != self.hw:
            raise ValueError(
                f"BCAM of a {self.hw}-token map (its learned a_proj) called "
                f"on {x.shape[1]} tokens: the model is built for one image "
                "size (ModelConfig.img_size)")
        dt = x.dtype
        l = self.lang_reduce(l)
        # visual-to-language attention
        sim = _scores(self.vis_1(x), l) + _mask_bias(l_mask)
        out = torch.matmul(torch.softmax(sim, dim=-1).to(dt), l)
        # language-guided spatial relevance (B, HW, HW)
        a = torch.tanh(self.out_1(out) + self.vis_2_2(self.vis_2(x)))
        rel = torch.softmax(self.a_proj(a), dim=-1,
                            dtype=torch.float32).to(dt)
        out2 = torch.matmul(rel, self.vis_3(x))
        out3 = self.out3_proj(torch.cat([out2, out], dim=-1))
        return out3 + self.vis_4(x)


class GACD(nn.Module):
    """GARAN collect-diffuse attention: the sentence vector (`lang_gen`)
    gates the pixels, one query collects a global feature over them
    (softmax) and diffuses it back (sigmoid)."""

    def __init__(self, dim: int, l_in: int = 768):
        super().__init__()
        self.dim = dim
        self.lang_gen = LangGen(l_in, dim)
        self.mm_gen = _relu_linear(dim, dim)
        self.query = nn.Linear(dim, dim)
        self.key_c = nn.Linear(dim, dim)
        self.key_d = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)

    def forward(self, x, l, l_mask, generator=None):
        dt = x.dtype
        s = self.lang_gen(masked_mean(l, l_mask).to(dt))[:, None, :]
        x = self.mm_gen(s * x)
        query = self.query(s)
        scale = self.dim ** -0.5
        a_c = torch.softmax(_scores(query, self.key_c(x)) * scale, dim=-1)
        a_d = torch.sigmoid(_scores(query, self.key_d(x)) * scale)
        f_col = torch.matmul(a_c.to(dt), self.value(x))  # (B, 1, dim)
        f_dif = torch.matmul(a_d.to(dt).transpose(1, 2), f_col)
        return x + f_dif


class EFN(nn.Module):
    """The sentence vector concatenated to every pixel (`project`), the
    words' attention map over the pixels (`lang_project`), then the
    mutual attention `image_lang_att`."""

    def __init__(self, dim: int, l_in: int = 768):
        super().__init__()
        self.dim = dim
        self.project = nn.Sequential(TokenConv1d(dim + l_in, dim), nn.GELU())
        self.lang_project = nn.Sequential(TokenConv1d(l_in, dim), nn.GELU())
        self.image_lang_att = EFNAttention(dim)

    def forward(self, x, l, l_mask, generator=None):
        dt = x.dtype
        b, hw, _ = x.shape
        sent = masked_mean(l, l_mask).to(dt)
        m = self.project(torch.cat([x, sent[:, None, :].expand(b, hw, -1)],
                                   dim=-1))
        lang = self.lang_project(l) * l_mask.to(dt)[:, :, None]
        score = _scores(m, lang) * self.dim ** -0.5 + _mask_bias(l_mask)
        l_map = torch.matmul(torch.softmax(score, dim=-1).to(dt), lang)
        return self.image_lang_att(m, l_map)


class EFNAttention(nn.Module):
    """Mutual H*W x H*W attention of a square map: f_query / f_key (kernel-1
    Conv1d + InstanceNorm), pooled 2x2 when H*W > 225 (the sides must be
    even, as the JAX reshape needs), both softmaxes of one score matrix,
    `W` (Conv1d kernel 3 over the token axis + InstanceNorm), and a
    half-pixel bilinear resize back (f32, as JAX `resize_2d`) where it
    pooled."""

    POOL_ABOVE = 225

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim
        self.f_query = nn.Sequential(TokenConv1d(dim, dim))
        self.f_key = nn.Sequential(TokenConv1d(dim, dim))
        self.W = nn.Sequential(nn.Conv1d(2 * dim, dim, 3, padding=1))

    def forward(self, m, l_map):
        dt = m.dtype
        b, hw, c = m.shape
        h = w = int(round(hw ** 0.5))
        m = instance_norm_tokens(self.f_query(m))
        l_map = instance_norm_tokens(self.f_key(l_map))
        pooled = hw > self.POOL_ABOVE
        if pooled:
            def pool(t):
                return t.reshape(b, h // 2, 2, w // 2, 2, c).mean(
                    dim=(2, 4)).reshape(b, hw // 4, c)

            m, l_map = pool(m), pool(l_map)
        sim = _scores(m, l_map) * self.dim ** -0.5
        s1 = torch.softmax(sim, dim=-1).to(dt)
        s2 = torch.softmax(sim, dim=-2).transpose(1, 2).to(dt)
        cat = torch.cat([torch.matmul(s1, l_map), torch.matmul(s2, m)],
                        dim=-1)
        out = instance_norm_tokens(self.W(cat.transpose(1, 2)).transpose(1, 2))
        if pooled:
            out = out.transpose(1, 2).reshape(b, self.dim, h // 2, w // 2)
            out = resize_f32(out, (h, w), align_corners=False)
            out = out.reshape(b, self.dim, hw).transpose(1, 2)
        return out
