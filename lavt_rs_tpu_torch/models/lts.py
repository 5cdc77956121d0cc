"""LTS decoder: sentence-vector modulation, a language filter and ASPP
(counterpart of `lavt_rs_tpu/models/lts.py`; reference
lib/mask_predictor.py:147-281).

NCHW inside, NHWC stage features in.  LeakyReLU at torch's slope 0.01;
ASPP rates 12 / 24 / 36.  Every resize is the JAX package's exact form
(f32 interpolation, back to the compute dtype), corner-aligned but the
last: a fixed 2x upsample with align_corners=False (the only half-pixel
resize of the reference), which returns f32 logits at H/4.  Parameter
names are the reference's (`lang_gen.project.0`, `vis_proj.0`,
`aspp.convs.N.M`, `conv1_1`, ...), which `torch2jax.convert_lts_decoder`
reads.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.resize import resize_f32, resize_nchw
from .pwam import LangGen, masked_mean


def _leaky(x):
    return F.leaky_relu(x, 0.01)


def _conv1x1(c_in: int, c_out: int) -> nn.Conv2d:
    return nn.Conv2d(c_in, c_out, 1, bias=False)


def _cbr(c_in: int, c_out: int, k: int = 1, dilation: int = 1) -> list:
    return [nn.Conv2d(c_in, c_out, k, padding=dilation * (k // 2),
                      dilation=dilation, bias=False),
            nn.BatchNorm2d(c_out), nn.ReLU()]


class ASPPPooling(nn.Sequential):
    """Global average -> 1x1 Conv-BN-ReLU, broadcast back to the map (the
    reference's align_corners=False upsample of a 1x1 map)."""

    def __init__(self, c_in: int, c_out: int):
        super().__init__(nn.AdaptiveAvgPool2d(1), *_cbr(c_in, c_out))

    def forward(self, x):
        return super().forward(x).expand(-1, -1, *x.shape[-2:])


class ASPP(nn.Module):
    """1x1, three atrous 3x3 and the pooling branch, concatenated, then a
    1x1 Conv-BN-ReLU projection (no dropout, as the JAX module at its
    default rate 0)."""

    def __init__(self, c_in: int, c_out: int, rates=(12, 24, 36)):
        super().__init__()
        self.convs = nn.ModuleList(
            [nn.Sequential(*_cbr(c_in, c_out))]
            + [nn.Sequential(*_cbr(c_in, c_out, 3, r)) for r in rates]
            + [ASPPPooling(c_in, c_out)])
        self.project = nn.Sequential(*_cbr(len(self.convs) * c_out, c_out))

    def forward(self, x):
        return self.project(torch.cat([c(x) for c in self.convs], dim=1))


def sentence_vector(l: torch.Tensor, l_mask: torch.Tensor) -> torch.Tensor:
    """The mean of the unmasked words, in f32, returned in l's dtype."""
    return masked_mean(l, l_mask).to(l.dtype)


class LTSDecoding(nn.Module):
    """forward(x_c4, x_c3, x_c2 NHWC, l (B, N_l, D_l), l_mask) -> (B, K,
    H/4, W/4) f32 logits."""

    def __init__(self, c4_dims: int, num_classes: int = 2,
                 lang_dim: int = 768):
        super().__init__()
        hidden, c2 = c4_dims // 2, c4_dims // 4
        self.lang_gen = LangGen(lang_dim, c4_dims)
        self.lang_proj = nn.Sequential(nn.Linear(c4_dims, c4_dims),
                                       nn.LeakyReLU())
        for name, c_in, c_out in (("vis_proj", c4_dims, c4_dims),
                                  ("conv4", c4_dims, hidden),
                                  ("conv3_v", c4_dims // 2, hidden),
                                  ("conv3", 2 * hidden, hidden),
                                  ("conv2_v", c2, c2)):
            self.add_module(name, nn.Sequential(_conv1x1(c_in, c_out),
                                                nn.LeakyReLU()))
        self.lang_filter = nn.Linear(c4_dims, hidden + c2)
        self.aspp = ASPP(hidden + c2 + 1, hidden // 2)
        self.conv1_1 = nn.Conv2d(hidden // 2, num_classes, 1)

    def forward(self, x_c4, x_c3, x_c2, l, l_mask):
        x_c4, x_c3, x_c2 = (t.permute(0, 3, 1, 2) for t in (x_c4, x_c3, x_c2))
        s = self.lang_gen(sentence_vector(l, l_mask))
        s = self.lang_proj(s)
        mm = self.vis_proj(x_c4) * s[:, :, None, None]
        mm = self.conv4(resize_f32(mm, x_c3.shape[-2:]))
        mm = torch.cat([mm, self.conv3_v(x_c3)], dim=1)
        mm = self.conv3(resize_f32(mm, x_c2.shape[-2:]))
        mm = torch.cat([mm, self.conv2_v(x_c2)], dim=1)
        l_kernel = self.lang_filter(s)
        relevance = (mm * l_kernel[:, :, None, None]).sum(1, keepdim=True)
        mm = self.aspp(torch.cat([mm, relevance], dim=1))
        mm = self.conv1_1(mm)
        h, w = mm.shape[-2:]
        return resize_nchw(mm, (2 * h, 2 * w), align_corners=False)
