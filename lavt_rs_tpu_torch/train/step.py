"""The training step (counterpart of `lavt_rs_tpu/train/step.py`).

One step: normalize the uint8 image (or clip) on its device, forward
(dropout and DropPath drawn from the step's generator), loss, backward,
AdamW step and the per-iteration LR schedule.  Parameters and the AdamW state are f32;
the activations run in the model's compute dtype: the Swin kernels'
autograd Functions cast the weights themselves, and the plain modules run
under `torch.autocast` (bf16 needs no loss scaling).

Under DistributedDataParallel (`parallel.ddp.wrap_ddp`) each process runs
the step on its own batch, and the step is the global batch's, as the JAX
package's over its sharded batch: one all_reduce of (the batch's loss
weight, weighted loss, mean IoU) before the backward scales this
process's loss so that DDP's mean of the gradients is the gradient of the
global loss, and the step returns the global loss and mean IoU.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn
from torch.nn.parallel import DistributedDataParallel

from ..losses import get_loss, loss_weight
from ..metrics import batch_iou
from ..ops.norm import maybe_normalize_image
from ..parallel.ddp import unwrap
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
    loss = _loss(tcfg)

    def step(batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        return _step(model, opt, sched, loss, batch["image"], batch,
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
    loss = _loss(tcfg)

    def step(batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        b, t = batch["video"].shape[:2]
        index = batch["valid_index"].to(torch.long)

        def frame(out):  # (B T, H, W, K) frame-major -> (B, H, W, K)
            out = out.reshape(b, t, *out.shape[1:])
            return out[torch.arange(b, device=out.device), index]

        return _step(model, opt, sched, loss, batch["video"], batch,
                     generator, frame)

    return step


def _loss(tcfg: TrainConfig) -> Tuple[Callable, Callable]:
    """tcfg's loss and its batch weight (`losses.loss_weight`)."""
    return (get_loss(tcfg.loss, tcfg.focal_rate, tcfg.dice_rate,
                     tcfg.boundary_rate),
            functools.partial(loss_weight, tcfg.loss))


def _global_batch(loss, iou, weight):
    """(this process's loss scaled for DDP's gradient mean, the global
    batch's loss, its mean IoU) from one all_reduce; equal batches on
    every process, as the loader gives."""
    world = dist.get_world_size()
    t = torch.stack([weight.float(), loss.detach() * weight, iou.float()])
    dist.all_reduce(t)
    return loss * (weight * world / t[0]), t[1] / t[0], t[2] / world


def _step(model, opt, sched, loss, pixels, batch, generator, select):
    """Normalize, forward under autocast, loss and IoU on select(logits)
    (under DDP the global batch's), backward, AdamW and the schedule;
    `loss` is `_loss`'s pair."""
    loss_fn, weight_fn = loss
    model.train()
    x = maybe_normalize_image(pixels)
    dt = unwrap(model).cfg.compute_dtype
    lr = opt.param_groups[0]["lr"]
    opt.zero_grad(set_to_none=True)
    with torch.autocast(x.device.type, dtype=dt, enabled=dt != torch.float32):
        out = select(model(x, batch["ids"], batch["mask"],
                           generator=generator))
    loss = loss_fn(out.float(), batch["target"])
    with torch.no_grad():
        inter, union = batch_iou(out, batch["target"])
        iou = torch.where(union > 0, inter / union.clamp(min=1.0),
                          torch.zeros_like(inter)).mean()
    shown = loss.detach()
    if isinstance(model, DistributedDataParallel):
        loss, shown, iou = _global_batch(loss, iou,
                                         weight_fn(batch["target"]))
    loss.backward()
    opt.step()
    sched.step()
    return {"loss": shown, "iou": iou, "lr": lr}
