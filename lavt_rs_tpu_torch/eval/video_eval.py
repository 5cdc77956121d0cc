"""The per-clip A2D inference step (counterpart of the body of
`lavt_rs_tpu/eval/video_eval.py:evaluate_a2d`).

`clip_iou` normalizes one uint8 clip on its device, runs the video model,
takes the argmax of the annotated frame (`valid_index`) and returns the
intersection and union of that mask with the frame's target.  The dataset
loop, `SegMetrics` and the CLI are ROADMAP.md slice 3.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from ..ops.norm import maybe_normalize_image


@torch.no_grad()
def clip_iou(model: nn.Module, video: torch.Tensor, ids: torch.Tensor,
             mask: torch.Tensor, valid_index: int, target: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """video (T, H, W, 3) uint8; ids / mask (L,) for the clip's sentence;
    target (H, W) in {0, 1} for frame `valid_index`.  Returns (inter,
    union) as f32 pixel counts (0-d tensors on the clip's device)."""
    logits = model(maybe_normalize_image(video)[None], ids[None], mask[None])
    pred = logits[valid_index].argmax(dim=-1).float()
    gt = target.float()
    return (pred * gt).sum(), torch.maximum(pred, gt).sum()
