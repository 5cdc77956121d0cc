"""The training step (counterpart of `lavt_rs_tpu/train/step.py`).

One step: normalize the uint8 image (or clip) on its device, forward
(dropout and DropPath drawn from the step's generator), loss, backward,
AdamW step and the per-iteration LR schedule.  Parameters and the AdamW state are f32;
the activations run in the model's compute dtype: the Swin kernels'
autograd Functions cast the weights themselves, and the plain modules run
under `torch.autocast` (bf16 needs no loss scaling).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn as nn

from ..losses import get_loss
from ..metrics import batch_iou
from ..ops.norm import maybe_normalize_image
from .optim import TrainConfig, build_optimizer


def create_train_state(model: nn.Module, tcfg: TrainConfig
                       ) -> Tuple[torch.optim.AdamW,
                                  torch.optim.lr_scheduler.LambdaLR]:
    """The optimizer and LR schedule of a model built with train=True."""
    return build_optimizer(model, tcfg)


def make_train_step(model: nn.Module, opt: torch.optim.Optimizer,
                    sched: torch.optim.lr_scheduler.LRScheduler,
                    tcfg: TrainConfig) -> Callable:
    """Returns step(batch, generator) -> {'loss', 'iou', 'lr'}: loss and iou
    0-dim tensors on the model's device (reading them waits for the step),
    lr the float this step used.

    batch: 'image' (B, H, W, 3) uint8 (or an already normalized float),
    'ids' (B, N), 'mask' (B, N), 'target' (B, H, W) integer.  `iou` is the
    mean per-image IoU with union 0 counted as 0, the reference's in-train
    signal."""
    loss_fn = get_loss(tcfg.loss, tcfg.focal_rate, tcfg.dice_rate,
                       tcfg.boundary_rate)

    def step(batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        return _step(model, opt, sched, loss_fn, batch["image"], batch,
                     generator, lambda out: out)

    return step


def make_video_train_step(model: nn.Module, opt: torch.optim.Optimizer,
                          sched: torch.optim.lr_scheduler.LRScheduler,
                          tcfg: TrainConfig) -> Callable:
    """The lavt_video step: step(batch, generator) -> {'loss', 'iou', 'lr'}
    as `make_train_step`, with the loss and iou on the annotated frame only
    (the reference index-selects the valid frame before the loss,
    train.py:280-285).

    batch: 'video' (B, T, H, W, 3) uint8 (or an already normalized float),
    'ids' (B, N), 'mask' (B, N), 'target' (B, H, W) integer for the
    annotated frame, 'valid_index' (B,) its position in the clip."""
    loss_fn = get_loss(tcfg.loss, tcfg.focal_rate, tcfg.dice_rate,
                       tcfg.boundary_rate)

    def step(batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        b, t = batch["video"].shape[:2]
        index = batch["valid_index"].to(torch.long)

        def frame(out):  # (B T, H, W, K) frame-major -> (B, H, W, K)
            out = out.reshape(b, t, *out.shape[1:])
            return out[torch.arange(b, device=out.device), index]

        return _step(model, opt, sched, loss_fn, batch["video"], batch,
                     generator, frame)

    return step


def _step(model, opt, sched, loss_fn, pixels, batch, generator, select):
    """Normalize, forward under autocast, loss and IoU on select(logits),
    backward, AdamW and the schedule."""
    model.train()
    x = maybe_normalize_image(pixels)
    dt = model.cfg.compute_dtype
    lr = opt.param_groups[0]["lr"]
    opt.zero_grad(set_to_none=True)
    with torch.autocast(x.device.type, dtype=dt, enabled=dt != torch.float32):
        out = select(model(x, batch["ids"], batch["mask"],
                           generator=generator))
    loss = loss_fn(out.float(), batch["target"])
    loss.backward()
    opt.step()
    sched.step()
    with torch.no_grad():
        inter, union = batch_iou(out, batch["target"])
        iou = torch.where(union > 0, inter / union.clamp(min=1.0),
                          torch.zeros_like(inter)).mean()
    return {"loss": loss.detach(), "iou": iou, "lr": lr}
