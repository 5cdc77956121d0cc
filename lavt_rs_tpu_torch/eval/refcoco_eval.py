"""The per-batch RefCOCO inference step (counterpart of
`lavt_rs_tpu/eval/refcoco_eval.py:_fwd_iou_for`).

`fwd_iou` takes per-ref uint8 images, per-sentence token ids and masks and
a bit-packed binary target, normalizes the images on the device, runs the
model on every (ref, sentence) pair, takes the argmax and returns the
intersection and union of the predicted mask with the target.  The full
`evaluate` loop (padded-S batching, metrics, sharding) is ROADMAP.md
slice 3.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from ..ops.norm import maybe_normalize_image


def unpack_target(target: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(R, ceil(H*W/8)) uint8 big-endian packed bits (np.packbits) ->
    (R, H, W) uint8 in {0, 1}."""
    r, p8 = target.shape
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=target.device)
    bits = (target[:, :, None] >> shifts) & 1
    return bits.reshape(r, p8 * 8)[:, :h * w].reshape(r, h, w)


@torch.no_grad()
def fwd_iou(model: nn.Module, image: torch.Tensor, ids: torch.Tensor,
            mask: torch.Tensor, target: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """image (R, H, W, 3) uint8 per ref; ids / mask (R, S, L) per sentence;
    target (R, ceil(H*W/8)) packed bits.  Returns (inter, union), each
    (R, S) f32 pixel counts."""
    r, s = ids.shape[:2]
    h, w = image.shape[1:3]
    gt = unpack_target(target, h, w).float()[:, None]
    img = maybe_normalize_image(image)
    img = img[:, None].expand(r, s, h, w, 3).reshape(r * s, h, w, 3)
    logits = model(img, ids.reshape(r * s, -1), mask.reshape(r * s, -1))
    pred = logits.argmax(dim=-1).reshape(r, s, h, w).float()
    inter = (pred * gt).sum(dim=(2, 3))
    union = torch.maximum(pred, gt).sum(dim=(2, 3))
    return inter, union
