"""Training-time IoU (counterpart of `lavt_rs_tpu/metrics.py:batch_iou`).
The eval accumulators (`SegMetrics`) come with the eval loop (ROADMAP.md
slice 3)."""

from __future__ import annotations

import torch


def batch_iou(logits: torch.Tensor, target: torch.Tensor):
    """Per-sample intersection and union (f32) from NHWC logits: pred =
    argmax over classes, I = sum(pred gt), U = sum(pred + gt) − I."""
    b = logits.shape[0]
    pred = logits.argmax(dim=-1).reshape(b, -1).float()
    gt = target.reshape(b, -1).float()
    inter = (pred * gt).sum(1)
    return inter, (pred + gt).sum(1) - inter
