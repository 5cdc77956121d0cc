"""Model factory (counterpart of `lavt_rs_tpu/models/factory.py`).

Only `lavt_one` is ported; every other family raises NotImplementedError
naming the ROADMAP.md slice that ports it.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn

from ..config import ModelConfig
from .lavt import LAVTOne
from .pwam import LanguageGate
from .swin2d import WindowAttention

_LATER = {
    "lavt_video": "slice 4 (video)",
    "lavt": "slice 5 (long tail)",
    "lts": "slice 5 (long tail)",
    "vlt": "slice 5 (long tail)",
    "lavt_vlt": "slice 5 (long tail)",
}


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded random init in the JAX package's scheme: LeCun-normal linear
    and conv weights (std fan_in^-1/2) with zero biases, N(0, 0.02)
    embeddings, 0.02 truncated-normal bias tables, unit norms, and zero
    language gates (the fusion branch starts off)."""

    def normal_(t: torch.Tensor, std: float):
        t.copy_(torch.randn(t.shape, generator=generator,
                            device=generator.device, dtype=torch.float32) * std)

    gates = {id(m[i]) for m in model.modules() if isinstance(m, LanguageGate)
             for i in (0, 2)}
    for m in model.modules():
        if id(m) in gates:
            m.weight.zero_()
        elif isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d)):
            normal_(m.weight, 1.0 / math.sqrt(m.weight[0].numel()))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            normal_(m.weight, 0.02)
        elif isinstance(m, (nn.LayerNorm, nn.BatchNorm2d)):
            m.weight.fill_(1.0)
            m.bias.zero_()
            if isinstance(m, nn.BatchNorm2d):
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
        if isinstance(m, WindowAttention):
            t = m.relative_position_bias_table
            normal_(t, 0.02)
            t.clamp_(-0.04, 0.04)


def build_model(cfg: ModelConfig, device="cpu",
                generator: Optional[torch.Generator] = None) -> nn.Module:
    """The eval-mode model on `device`, parameters in cfg.dtype (batch
    norms kept in f32).  With a generator, weights are drawn by
    `init_weights`; without, they keep PyTorch's default init (to be
    overwritten by a state dict)."""
    if cfg.name != "lavt_one":
        where = _LATER.get(cfg.name)
        raise NotImplementedError(
            f"model {cfg.name!r} is not ported yet"
            + (f": ROADMAP.md {where}" if where else ""))
    with torch.device(device):
        model = LAVTOne(cfg)
    if generator is not None:
        init_weights(model, generator)
    model.to(cfg.compute_dtype)
    for m in model.modules():
        if isinstance(m, nn.BatchNorm2d):
            m.float()
    return model.eval()
