"""Windowed multi-head attention as ordinary torch ops (counterpart of
`lavt_rs_tpu/ops/attention.py:window_attention_xla`).

The JAX package runs this chain through XLA wherever its kernel
predicates do not route a Pallas kernel (`window_attn.attn_fwd_supported`
False: the video window (8, 12, 12), N = 1152); the port runs the same ops
there.  It is the counterpart of that XLA route, not a stand-in for a
kernel: the reference has no kernel at these geometries.

q, k, v: (B, nW, heads, N, hd); bias (heads, N, N); mask (nW, N, N) or
None.  The scores accumulate in f32; under bf16 activations they are
stored in bf16 before the f32 softmax, as the JAX function does (and as
the reference's autocast does); P is rounded to the activation dtype
before P·v.  Autograd differentiates it like any torch module.
"""

from __future__ import annotations

from typing import Optional

import torch


def window_attention_xla(q, k, v, bias, mask: Optional[torch.Tensor] = None,
                         scale: Optional[float] = None) -> torch.Tensor:
    """softmax(q kᵀ·scale + bias + mask) v in q's dtype."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    dt = q.dtype
    s = torch.matmul((q * scale).float(), k.float().transpose(-1, -2))
    s = s + bias.float()
    if mask is not None:
        s = s + mask.float()[None, :, None]
    if dt == torch.bfloat16:
        s = s.to(dt)
    p = torch.softmax(s.float(), dim=-1).to(dt)
    return torch.matmul(p.float(), v.float()).to(dt)
