"""VLT decoder ("classifier"): query generation, transformer fusion, query
balancing and progressive decoding (counterpart of
`lavt_rs_tpu/models/vlt.py`; reference lib/vlt.py:12-485).

NCHW inside, NHWC stage features in, queries batch-first (B, Q, D).
Parameter names are the reference's, which composes
`nn.MultiheadAttention`, `nn.TransformerEncoderLayer` and
`nn.TransformerDecoderLayer` (`in_proj_weight`, `out_proj`, `linear1`,
`norm1`, ... under `transformer_fusion.transformer_encoder.layers.N`) and
1x1 `nn.Conv1d`s (`project_query.0`, `q_to_spatial.0`, ...), so a
reference state dict loads as it is and `torch2jax.convert_vlt_decoder`
reads the port's.  The attention is this module's own (`MultiheadAttention`
below, under those names): the JAX `MHA`'s math, its scores and its
attention-times-values products accumulated in f32 from operands in the
compute dtype, with no fused fast path (torch's layers take one in eval
mode, which rounds otherwise).  Post-LN layers with ReLU feed-forwards and
no dropout, as the JAX layers.  Every resize is the JAX package's exact
form (f32 interpolation, back to the compute dtype), corner-aligned.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.resize import resize_f32
from .lts import sentence_vector


@functools.lru_cache(maxsize=16)
def _positional_encoding_np(n: int, dim: int) -> np.ndarray:
    pos = np.arange(n, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, dim, 2, dtype=np.float64)
                 * (-np.log(10000.0) / dim))
    pe = np.zeros((n, dim), np.float32)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return pe


def positional_encoding(n: int, dim: int, like: torch.Tensor) -> torch.Tensor:
    """The interleaved sin / cos encoding (reference vlt.py:203-222), (n,
    dim) in like's dtype on its device."""
    return torch.from_numpy(_positional_encoding_np(n, dim)).to(
        device=like.device, dtype=like.dtype)


def _cbr(c_in: int, c_out: int, k: int = 1) -> list:
    return [nn.Conv2d(c_in, c_out, k, padding=k // 2, bias=False),
            nn.BatchNorm2d(c_out), nn.ReLU()]


def _conv1d_relu(c_in: int, c_out: int) -> nn.Sequential:
    return nn.Sequential(nn.Conv1d(c_in, c_out, 1, bias=False), nn.ReLU())


def _pointwise(seq: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
    """A (1x1 Conv1d, ReLU) pair on x's last axis: (B, L, C_in) -> (B, L,
    C_out)."""
    return seq[1](F.linear(x, seq[0].weight[:, :, 0]))


class MultiheadAttention(nn.Module):
    """Multi-head attention under `nn.MultiheadAttention`'s names
    (`in_proj_weight` (3D, D), `in_proj_bias`, `out_proj`), batch-first,
    with torch's key_padding_mask (True = ignore)."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.dim, self.heads = dim, heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = nn.Linear(dim, dim)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, q, k, v, key_padding_mask=None):
        b, lq, d = q.shape
        h, hd = self.heads, d // self.heads
        w, bias = self.in_proj_weight, self.in_proj_bias

        def heads(x, i):  # the i-th of the q / k / v projections, by head
            y = F.linear(x, w[i * d:(i + 1) * d], bias[i * d:(i + 1) * d])
            return y.view(b, -1, h, hd).transpose(1, 2)

        qp, kp, vp = heads(q, 0), heads(k, 1), heads(v, 2)
        dt = qp.dtype
        with torch.autocast(q.device.type, enabled=False):
            s = torch.matmul(qp.float(), kp.float().transpose(-1, -2))
            s = s / hd ** 0.5
            if key_padding_mask is not None:
                s = s.masked_fill(key_padding_mask[:, None, None, :],
                                  float("-inf"))
            p = torch.softmax(s, dim=-1).to(dt)
            o = torch.matmul(p.float(), vp.float()).to(dt)
        return self.out_proj(o.transpose(1, 2).reshape(b, lq, d))


class TransformerEncoderLayer(nn.Module):
    """Post-LN self-attention + ReLU feed-forward (`nn.TransformerEncoderLayer`
    at dropout 0, batch-first)."""

    def __init__(self, dim: int, heads: int, ff: int):
        super().__init__()
        self.self_attn = MultiheadAttention(dim, heads)
        self.linear1 = nn.Linear(dim, ff)
        self.linear2 = nn.Linear(ff, dim)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, x):
        x = self.norm1(x + self.self_attn(x, x, x))
        return self.norm2(x + self.linear2(F.relu(self.linear1(x))))


class TransformerDecoderLayer(nn.Module):
    """Post-LN self-attention, cross-attention to the memory, ReLU
    feed-forward (`nn.TransformerDecoderLayer` at dropout 0, batch-first)."""

    def __init__(self, dim: int, heads: int, ff: int):
        super().__init__()
        self.self_attn = MultiheadAttention(dim, heads)
        self.multihead_attn = MultiheadAttention(dim, heads)
        self.linear1 = nn.Linear(dim, ff)
        self.linear2 = nn.Linear(ff, dim)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, tgt, memory):
        tgt = self.norm1(tgt + self.self_attn(tgt, tgt, tgt))
        tgt = self.norm2(tgt + self.multihead_attn(tgt, memory, memory))
        return self.norm3(tgt + self.linear2(F.relu(self.linear1(tgt))))


class _Layers(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class TransformerFusion(nn.Module):
    """The reference's `transformer_fusion` (`TransformerModel`, vlt.py:
    225-263): encoder layers over the pixels, decoder layers over the
    queries."""

    def __init__(self, dim: int, heads: int, ff: int, nlayers: int):
        super().__init__()
        self.transformer_encoder = _Layers(
            TransformerEncoderLayer(dim, heads, ff) for _ in range(nlayers))
        self.transformer_decoder = _Layers(
            TransformerDecoderLayer(dim, heads, ff) for _ in range(nlayers))

    def forward(self, src, tgt):
        for layer in self.transformer_encoder.layers:
            src = layer(src)
        for layer in self.transformer_decoder.layers:
            tgt = layer(tgt, src)
        return tgt


class QueryGenerationModule(nn.Module):
    """Coordinates concatenated as [x, x, x, y, y, y] (reference vlt.py:
    287-289), three 3x3 Conv-BN-ReLU, a 1x1 conv to the queries, each
    query's spatial map projected to `dim`, attention over the words."""

    def __init__(self, visual_dim: int, dim: int, num_queries: int,
                 spatial: int, lang_dim: int):
        super().__init__()
        self.project_1 = nn.Sequential(*_cbr(visual_dim + 6, visual_dim, 3),
                                       *_cbr(visual_dim, visual_dim, 3),
                                       *_cbr(visual_dim, visual_dim, 3))
        self.project_2 = nn.Conv2d(visual_dim, num_queries, 1, bias=False)
        self.project_query = _conv1d_relu(spatial, dim)
        self.project_lang = _conv1d_relu(lang_dim, dim)
        self.query_gen = MultiheadAttention(dim, 8)

    def forward(self, x, l, l_mask):
        """x (B, C_v, H, W), l (B, N_l, D_l), l_mask (B, N_l) -> (B, Q,
        dim)."""
        b, _, h, w = x.shape
        ys = 2.0 * torch.arange(h, device=x.device) / (h - 1.0) - 1.0
        xs = 2.0 * torch.arange(w, device=x.device) / (w - 1.0) - 1.0
        xg, yg = xs[None, :].expand(h, w), ys[:, None].expand(h, w)
        coords = torch.stack([xg, xg, xg, yg, yg, yg]).to(x.dtype)
        x = torch.cat([x, coords[None].expand(b, -1, -1, -1)], dim=1)
        x = self.project_2(self.project_1(x))
        vis_q = _pointwise(self.project_query, x.flatten(2))  # (B, Q, dim)
        lp = _pointwise(self.project_lang, l)  # (B, N_l, dim)
        dim = vis_q.shape[-1]
        q_in = vis_q + positional_encoding(vis_q.shape[1], dim, vis_q)
        l_in = lp + positional_encoding(lp.shape[1], dim, lp)
        out = self.query_gen(q_in, l_in, l_in, key_padding_mask=l_mask == 0)
        return out + vis_q


class QueryBalancingModule(nn.Module):
    """The decoded queries scaled by a sigmoid gate of both."""

    def __init__(self, dim: int):
        super().__init__()
        self.not_decoded_query_proj = _conv1d_relu(dim, dim)
        self.decoded_query_proj = _conv1d_relu(dim, dim)
        self.gate_proj = nn.Sequential(
            nn.Conv1d(2 * dim, dim, 1, bias=False), nn.ReLU(),
            nn.Conv1d(dim, 1, 1, bias=False), nn.Sigmoid())

    def forward(self, not_decoded, decoded):
        x = _pointwise(self.not_decoded_query_proj, not_decoded)
        y = _pointwise(self.decoded_query_proj, decoded)
        g = _pointwise(self.gate_proj[:2], torch.cat([y, x], dim=-1))
        g = torch.sigmoid(F.linear(g, self.gate_proj[2].weight[:, :, 0]))
        return g * y


class ProgressiveDecoding(nn.Module):
    """Two 3x3 Conv-BN-ReLU, then three of (2x corner-aligned upsample,
    3x3 Conv-BN-ReLU), then the 1x1 classifier."""

    STAGES = (("conv1_4", "bn1_4"), ("conv2_4", "bn2_4"),
              ("conv1_3", "bn1_3"), ("conv1_2", "bn1_2"),
              ("conv1_1", "bn1_1"))

    def __init__(self, hidden: int, num_classes: int = 2):
        super().__init__()
        for conv, bn in self.STAGES:
            self.add_module(conv, nn.Conv2d(hidden, hidden, 3, padding=1,
                                            bias=False))
            self.add_module(bn, nn.BatchNorm2d(hidden))
        self.classifier = nn.Conv2d(hidden, num_classes, 1)

    def forward(self, x):
        for i, (conv, bn) in enumerate(self.STAGES):
            if i >= 2:
                x = resize_f32(x, (2 * x.shape[-2], 2 * x.shape[-1]))
            x = F.relu(getattr(self, bn)(getattr(self, conv)(x)))
        return self.classifier(x)


class VLTFuseAndClassify(nn.Module):
    """forward(x_c4, x_c3, x_c2 NHWC, l (B, N_l, D_l), l_mask) -> (B, K,
    H/2, W/2) logits in the compute dtype; `img_size` fixes the queries'
    spatial map (img_size // 16, the C3 resolution)."""

    def __init__(self, c4_dims: int, img_size: int = 480, d_model: int = 256,
                 nhead: int = 8, d_hid: int = 256, nlayers: int = 2,
                 num_queries: int = 16, num_classes: int = 2,
                 lang_dim: int = 768):
        super().__init__()
        joint = c4_dims
        self.size = img_size // 16
        self.vis_reduce_chann_1 = nn.Sequential(*_cbr(joint, joint // 2),
                                                *_cbr(joint // 2, joint, 3))
        self.vis_reduce_chann_2 = nn.Sequential(*_cbr(joint // 2, joint // 2))
        self.fuse_1_2 = nn.Sequential(*_cbr(joint + joint // 2, joint // 2))
        self.vis_reduce_chann_3 = nn.Sequential(*_cbr(joint // 4, joint // 4))
        self.fuse_2_3 = nn.Sequential(*_cbr(joint // 2 + joint // 4,
                                            joint // 2))
        self.hallucinate_result_of_23 = nn.Sequential(
            *_cbr(joint // 2, joint // 4), *_cbr(joint // 4, joint // 2, 3))
        self.project_again = nn.Sequential(*_cbr(joint, joint // 2))
        self.fuse_again = nn.Sequential(*_cbr(joint + joint // 2, d_model))
        self.last_project = nn.Sequential(*_cbr(d_model, d_model))
        self.lang_proj = nn.Sequential(nn.Linear(lang_dim, joint),
                                       nn.BatchNorm1d(joint), nn.ReLU())
        self.joint_threshold = nn.Sequential(nn.BatchNorm2d(joint), nn.ReLU())
        self.query_generation = QueryGenerationModule(
            joint // 2, d_model, num_queries, self.size ** 2, lang_dim)
        self.transformer_fusion = TransformerFusion(d_model, nhead, d_hid,
                                                    nlayers)
        self.query_balancing = QueryBalancingModule(d_model)
        self.q_to_spatial = _conv1d_relu(d_model, self.size ** 2)
        self.spatial_refine = nn.Sequential(*_cbr(num_queries, d_model, 3))
        self.decoding = ProgressiveDecoding(d_model, num_classes)

    def forward(self, x_c4, x_c3, x_c2, l, l_mask):
        x_c4, x_c3, x_c2 = (t.permute(0, 3, 1, 2) for t in (x_c4, x_c3, x_c2))
        sent = self.lang_proj(sentence_vector(l, l_mask))
        # a bottleneck residual on c4, modulated by the sentence, thresholded
        x_c4 = x_c4 + self.vis_reduce_chann_1(x_c4)
        x_mm_c4 = self.joint_threshold(x_c4 * sent[:, :, None, None])
        up = resize_f32(x_mm_c4, x_c3.shape[-2:])
        fm_mid_query = self.fuse_1_2(torch.cat(
            [up, self.vis_reduce_chann_2(x_c3)], dim=1))
        x_c2d = self.vis_reduce_chann_3(F.avg_pool2d(x_c2, 2))
        fm_query = self.fuse_2_3(torch.cat([fm_mid_query, x_c2d], dim=1))
        fm_mid_tf = torch.cat([self.hallucinate_result_of_23(fm_query),
                               fm_mid_query], dim=1)
        f_tf = self.fuse_again(torch.cat(
            [up, self.project_again(fm_mid_tf)], dim=1))
        f_tf = self.last_project(f_tf)

        queries = self.query_generation(fm_query, l, l_mask)
        src = f_tf.flatten(2).transpose(1, 2)  # (B, H W, d_model)
        d = src.shape[-1]
        src = src + positional_encoding(src.shape[1], d, src)
        tgt = queries + positional_encoding(queries.shape[1], d, queries)
        tgt = self.transformer_fusion(src, tgt)
        balanced = self.query_balancing(queries, tgt)

        out = _pointwise(self.q_to_spatial, balanced)  # (B, Q, size²)
        b, q = out.shape[:2]
        out = self.spatial_refine(out.view(b, q, self.size, self.size))
        return self.decoding(out)
