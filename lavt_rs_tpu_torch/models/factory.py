"""Model factory (counterpart of `lavt_rs_tpu/models/factory.py`).

`lavt_one` and `lavt_video` (inference and training) are ported; every
other family raises NotImplementedError naming the ROADMAP.md slice that
ports it.  f32 activations with the kernels on the card run where every
kernel of the model's plan has an f32 variant; every kernel of the port
has one (`F32_KERNELS`), so `lavt_one` and `lavt_video` run in f32 at
either window, in inference and in training.  `build_model` keeps the
check as the guard for a kernel added without its f32 variant: it then
refuses, naming the missing variants, before a weight is allocated.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn

from ..config import ModelConfig, SwinConfig
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


SAVE_MODE = "K1/K2 save mode"
# the kernels with an f32 variant (ops: fused_window_msa_ln_f32,
# fused_window_msa_f32, fused_window_msa_save_f32, fused_window_msa_bwd_f32,
# fused_window_msa_bwd_recompute_f32, fused_window_msa_2d_f32,
# fused_ln_mlp_f32, layer_norm_rows_f32, window_attention_f32 with its save
# mode, fused_window_msa_grouped_f32, attention_core_bwd_f32,
# fused_ln_mlp_droppath_f32, fused_ln_mlp_bwd_f32, layer_norm_rows_bwd_f32)
F32_KERNELS = frozenset({"K1", "K2", SAVE_MODE, "K5", "K6", "K11", "K3",
                         "K4", "K10", "K2p", "K9", "K8", "K7", "K4b"})


def kernels_without_variant(cfg: ModelConfig, train: bool = False) -> list:
    """The kernels of cfg's plan (its backbone's `kernel_plan` at the compute
    dtype's itemsize, one clip of `num_frames` for lavt_video, per training
    step with `train`) that have no variant for cfg's compute dtype, sorted;
    [] for bf16 or without the kernels.  A training step's K1 / K2 (the
    plan's keys) stands for K1, K2 and the save mode (`SAVE_MODE`), and
    its MSA backward for both K5 and K6, which the step chooses between by
    its batch: the list holds for every batch size.  The model is built on
    the meta device: nothing is allocated."""
    dt = cfg.compute_dtype
    if not cfg.use_kernels or dt == torch.bfloat16:
        return []
    with torch.device("meta"):
        backbone = _MODELS[cfg.name](cfg).backbone
    img = (cfg.img_size, cfg.img_size)
    if cfg.name == "lavt_video":
        counts = backbone.kernel_plan(cfg.num_frames, img, dt.itemsize, train)[0]
    else:
        counts = backbone.kernel_plan(img, 1, dt.itemsize, train)[0]
    have = F32_KERNELS if dt == torch.float32 else frozenset()
    names = set(counts)
    if train and names & {"K5", "K6"}:
        names |= {"K5", "K6"}
    if train and names & {"K1", "K2"}:
        names |= {"K1", "K2", SAVE_MODE}
    return sorted(k for k in names if k not in have)


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
    missing = (kernels_without_variant(cfg, train)
               if torch.device(device).type == "cuda" else [])
    if missing:
        raise NotImplementedError(
            f"{cfg.dtype} activations with the kernels on the card: this "
            f"{'training' if train else 'inference'} plan launches "
            f"{', '.join(missing)}, with no {cfg.dtype} variant yet "
            "(ROADMAP.md, \"f32 kernel variants\"; f32 has "
            f"{', '.join(sorted(F32_KERNELS))}).  "
            "Use bf16, or the plain versions (use_kernels=False, "
            "--no_pallas), or the CPU")
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


def make_config(name: str, swin_type: str = "base", window12: bool = True,
                **kw) -> ModelConfig:
    """The reference factory's size and window selection
    (lib/segmentation.py:16-45), as `lavt_rs_tpu/models/factory.py:
    make_config`: window 12 or 7; for lavt_video the per-size drop-path
    rate, the 3D window (8, 12, 12) or (8, 7, 7) and 22 tokens."""
    swin_kw = {}
    if name == "lavt_video":
        swin_kw["drop_path_rate"] = {"tiny": 0.1, "small": 0.2,
                                     "base": 0.3}.get(swin_type, 0.3)
        swin_kw["window_size_3d"] = (8, 12, 12) if window12 else (8, 7, 7)
        kw.setdefault("max_tokens", 22)
    swin = SwinConfig.from_size(swin_type, window_size=12 if window12 else 7,
                                **swin_kw)
    return ModelConfig(name=name, swin=swin, **kw)
