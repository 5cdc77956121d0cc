"""AdamW and the LR schedule with the reference's parameter groups
(counterpart of `lavt_rs_tpu/train/optim.py`, reference train.py:615-700).

  * AdamW, lr 5e-5, weight decay 1e-2 (betas 0.9/0.999, eps 1e-8,
    decoupled decay), optionally amsgrad as torch has it.
  * Backbone parameters whose name contains 'norm', 'absolute_pos_embed'
    or 'relative_position_bias_table' take no weight decay; the classifier
    and BERT keep the default (decoder BN scales included, as the
    reference).
  * BERT subsetting (`lang_enc_params`): parameters in no group are frozen.
    encoder-10 (default) trains encoder layers 0-9 only; encoder-all all
    layers; the embeddings train only with the 'embeddings+' variants.
  * Poly LR per iteration: lr (1 − it / total_iters)^0.9 (a `LambdaLR`
    stepped once per step), or constant with fix_lr.
Labels are read from the port's state-dict names, which are the reference
PyTorch ones (`backbone.layers.N...`, `text_encoder.encoder.layer.N...`;
for lavt `model.backbone...` and `bert_model.encoder.layer.N...`).
The PWAM attention's LayerNorm / BatchNorm att_norm (`image_lang_att.
f_query.1`, `image_lang_att.W.1`) takes no decay, as the JAX package
labels its `f_query_norm` / `W_norm`; the reference's name rule decays
them (their names hold no 'norm').
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Tuple

import torch
import torch.nn as nn


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 5e-5
    weight_decay: float = 1e-2
    epochs: int = 40
    iters_per_epoch: int = 1000
    lang_enc_params: str = "encoder-10"
    bert_trainable_layers: int = 10
    loss: str = "cross_entropy"  # see losses.LOSSES
    focal_rate: float = 3.0
    dice_rate: float = 1.0
    boundary_rate: float = 0.05
    amsgrad: bool = False
    fix_lr: bool = False
    poly_power: float = 0.9

    @property
    def total_iters(self) -> int:
        return self.epochs * self.iters_per_epoch


_NO_DECAY_RE = re.compile(
    r"norm|absolute_pos_embed|relative_position_bias_table"
    r"|image_lang_att\.(?:f_query|W)\.1\.")
# 'text_encoder' = the BERT inside the model; 'bert_model' = lavt's BERT
# beside its segmentation net `model` (reference train.py:634-686 applies
# the same rules to both)
_BERT = ("text_encoder.", "bert_model.")
_BERT_LAYER_RE = re.compile(
    r"^(?:text_encoder|bert_model)\.encoder\.layer\.(\d+)\.")
_BACKBONE = ("backbone.", "model.backbone.")


def label_param(name: str, cfg: TrainConfig) -> str:
    """'decay' / 'no_decay' / 'frozen' for a state-dict parameter name."""
    if name.startswith(_BERT):
        enc = cfg.lang_enc_params
        m = _BERT_LAYER_RE.match(name)
        if m is not None:
            if (enc in ("encoder-10", "embeddings+encoder-10")
                    and int(m.group(1)) >= cfg.bert_trainable_layers):
                return "frozen"
            return "decay"
        return "decay" if enc.startswith("embeddings+") else "frozen"
    if name.startswith(_BACKBONE) and _NO_DECAY_RE.search(name):
        return "no_decay"
    return "decay"


def param_groups(model: nn.Module, cfg: TrainConfig) -> List[Dict]:
    """The 'decay' and 'no_decay' groups (frozen parameters in neither)."""
    groups = {"decay": [], "no_decay": []}
    for name, p in model.named_parameters():
        label = label_param(name, cfg)
        if label != "frozen":
            groups[label].append(p)
    return [{"params": groups["decay"], "weight_decay": cfg.weight_decay},
            {"params": groups["no_decay"], "weight_decay": 0.0}]


def poly_factor(step: int, cfg: TrainConfig) -> float:
    if cfg.fix_lr:
        return 1.0
    return max(1.0 - step / cfg.total_iters, 0.0) ** cfg.poly_power


def build_optimizer(model: nn.Module, cfg: TrainConfig
                    ) -> Tuple[torch.optim.AdamW, torch.optim.lr_scheduler.LambdaLR]:
    """torch AdamW over the reference's groups and the per-iteration poly
    schedule (call `sched.step()` after every `opt.step()`)."""
    opt = torch.optim.AdamW(param_groups(model, cfg), lr=cfg.lr,
                            betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=cfg.weight_decay,
                            amsgrad=cfg.amsgrad)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda step: poly_factor(step, cfg))
    return opt, sched
