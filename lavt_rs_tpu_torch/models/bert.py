"""BERT-base encoder (counterpart of `lavt_rs_tpu/models/bert.py`).

Post-LN transformer with learned word/position/type embeddings, exact GELU
and layer_norm_eps 1e-12; the HF `(1 - mask) * -10000` additive key bias.
Attention is a plain matmul + f32 softmax.  Module and parameter names
follow Hugging Face's BertModel (`embeddings.word_embeddings`,
`encoder.layer.N.attention.self.query`, ...) so reference checkpoints load
as they are.  No pooler: LAVT consumes the last hidden state only.
In training, `attn_dropout` drops attention probabilities and
`hidden_dropout` the embeddings and both residual branches, drawn from
the generator passed to `forward` (as `lavt_rs_tpu/models/bert.py`).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import BertConfig
from ..ops.dropout import dropout


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings,
                                                cfg.hidden_size)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size,
                                                  cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.register_buffer(
            "position_ids",
            torch.arange(cfg.max_position_embeddings).unsqueeze(0))

    def forward(self, ids, token_type_ids):
        pos = self.position_ids[:, :ids.shape[1]]
        x = (self.word_embeddings(ids) + self.position_embeddings(pos)
             + self.token_type_embeddings(token_type_ids))
        return self.LayerNorm(x)


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.num_heads = cfg.num_heads
        self.attn_dropout = cfg.attn_dropout
        self.query = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.key = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.value = nn.Linear(cfg.hidden_size, cfg.hidden_size)

    def forward(self, x, attn_bias, generator=None):
        b, n, d = x.shape
        h = self.num_heads
        hd = d // h

        def split(t):
            return t.view(b, n, h, hd).transpose(1, 2)

        q, k, v = split(self.query(x)), split(self.key(x)), split(self.value(x))
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
        probs = torch.softmax(scores / hd ** 0.5 + attn_bias, dim=-1)
        probs = dropout(probs.to(x.dtype), self.attn_dropout, self.training,
                        generator)
        out = torch.matmul(probs.float(), v.float()).to(x.dtype)
        return out.transpose(1, 2).reshape(b, n, d)


class _DenseLN(nn.Module):
    """`dense` + dropout + `LayerNorm` of a residual (HF's
    BertSelfOutput/BertOutput)."""

    def __init__(self, d_in: int, d_out: int, eps: float, drop: float):
        super().__init__()
        self.dense = nn.Linear(d_in, d_out)
        self.LayerNorm = nn.LayerNorm(d_out, eps=eps)
        self.drop = drop

    def forward(self, y, residual, generator=None):
        y = dropout(self.dense(y), self.drop, self.training, generator)
        return self.LayerNorm(residual + y)


class BertAttention(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.self = BertSelfAttention(cfg)
        self.output = _DenseLN(cfg.hidden_size, cfg.hidden_size,
                               cfg.layer_norm_eps, cfg.hidden_dropout)

    def forward(self, x, attn_bias, generator=None):
        return self.output(self.self(x, attn_bias, generator), x, generator)


class BertIntermediate(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, cfg.intermediate_size)

    def forward(self, x):
        return F.gelu(self.dense(x), approximate="none")


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.attention = BertAttention(cfg)
        self.intermediate = BertIntermediate(cfg)
        self.output = _DenseLN(cfg.intermediate_size, cfg.hidden_size,
                               cfg.layer_norm_eps, cfg.hidden_dropout)

    def forward(self, x, attn_bias, generator=None):
        x = self.attention(x, attn_bias, generator)
        return self.output(self.intermediate(x), x, generator)


class _Layers(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.layer = nn.ModuleList(BertLayer(cfg) for _ in range(cfg.num_layers))


class BertEncoder(nn.Module):
    """BertModel minus the pooler: (ids, mask) -> (B, N, hidden)."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.embeddings = BertEmbeddings(cfg)
        self.encoder = _Layers(cfg)
        self.hidden_dropout = cfg.hidden_dropout

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = dropout(self.embeddings(input_ids, token_type_ids),
                    self.hidden_dropout, self.training, generator)
        # HF extended attention mask: (1 - m) * -10000 on the key axis
        bias = (1.0 - attention_mask.float())[:, None, None, :] * -10000.0
        for layer in self.encoder.layer:
            x = layer(x, bias, generator)
        return x
