"""Windowed multi-head attention, plain math (counterpart of
`lavt_rs_tpu/ops/attention.py:window_attention_xla`).

It is the attention core of the fused MSA's plain version
(ops/fused_msa.py).  Scores, bias, mask and softmax are f32; q, k and v
and the probabilities keep the input dtype, as in the fused kernels.
"""

from __future__ import annotations

from typing import Optional

import torch


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias: torch.Tensor, mask: Optional[torch.Tensor] = None,
                     scale: Optional[float] = None) -> torch.Tensor:
    """q, k, v: (B, nW, nH, N, hd); bias (nH, N, N); mask (nW, N, N) or
    None.  Returns (B, nW, nH, N, hd) in q's dtype."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    dt = q.dtype
    s = torch.matmul(q.float() * scale, k.float().transpose(-1, -2))
    s = s + bias.float()[None, None]
    if mask is not None:
        s = s + mask.float()[None, :, None]
    p = torch.softmax(s, dim=-1).to(dt)
    return torch.matmul(p.float(), v.float()).to(dt)
