"""Model factory (counterpart of `lavt_rs_tpu/models/factory.py`).

`lavt_one` and `lavt_video` (inference and training) are ported; every
other family raises NotImplementedError naming the ROADMAP.md slice that
ports it.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn

from ..config import ModelConfig
from .lavt import LAVTOne, LAVTVideo
from .pwam import LanguageGate
from .swin2d import WindowAttention
from .swin3d import WindowAttention3D
from .tpwam import SelfGate3D

_MODELS = {"lavt_one": LAVTOne, "lavt_video": LAVTVideo}
_LATER = {
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
    language gates and 3D self-gates (the fusion branch starts off)."""

    def normal_(t: torch.Tensor, std: float):
        t.copy_(torch.randn(t.shape, generator=generator,
                            device=generator.device, dtype=torch.float32) * std)

    gates = {id(m[i]) for m in model.modules() if isinstance(m, LanguageGate)
             for i in (0, 2)}
    gates |= {id(c) for m in model.modules() if isinstance(m, SelfGate3D)
              for c in (m.fc1, m.fc2)}
    for m in model.modules():
        if id(m) in gates:
            m.weight.zero_()
        elif isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d, nn.Conv3d)):
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
        if isinstance(m, (WindowAttention, WindowAttention3D)):
            t = m.relative_position_bias_table
            normal_(t, 0.02)
            t.clamp_(-0.04, 0.04)


def build_model(cfg: ModelConfig, device="cuda",
                generator: Optional[torch.Generator] = None,
                train: bool = False) -> nn.Module:
    """The model on `device` (the card unless the caller asks for the
    CPU).  With a generator, weights are drawn by `init_weights`; without,
    they keep PyTorch's default init (to be overwritten by a state dict).

    train=False: eval mode, parameters in cfg.dtype (batch norms kept in
    f32).  train=True: train mode (batch statistics, dropout, DropPath),
    parameters in f32 as the optimizer's masters; the compute runs in
    cfg.dtype, under `torch.autocast` for the plain modules
    (`train.step`), while the kernel Functions cast the weights
    themselves."""
    if cfg.name not in _MODELS:
        where = _LATER.get(cfg.name)
        raise NotImplementedError(
            f"model {cfg.name!r} is not ported yet"
            + (f": ROADMAP.md {where}" if where else ""))
    with torch.device(device):
        model = _MODELS[cfg.name](cfg)
    if generator is not None:
        init_weights(model, generator)
    if train:
        return model.train()
    model.to(cfg.compute_dtype)
    for m in model.modules():
        if isinstance(m, nn.BatchNorm2d):
            m.float()
    return model.eval()
