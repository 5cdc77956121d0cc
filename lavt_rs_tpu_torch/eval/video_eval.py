"""Video evaluation loops (counterpart of `lavt_rs_tpu/eval/video_eval.py`).

  * `clip_iou`, the per-clip A2D step: one uint8 clip normalized on its
    device, the video model, the argmax of the annotated frame
    (`valid_index`), the intersection and union of that mask with the
    frame's target;
  * `evaluate_a2d` (reference train.py:332-395, test.py:121-230): every
    clip of the dataset through `clip_iou`; mIoU / oIoU / P@K
    (`metrics.SegMetrics`);
  * `evaluate_ytvos_jf`: local J&F on a labeled YTVOS-style dataset (the
    annotated frame of each item; the competition split is scored on the
    server, from the PNGs of `cli.test_ytvos`).

Both loops are pipelined (`eval.pipeline.run_pipelined`): the producer
thread decodes the next clips and copies them to the card (pinned,
non-blocking) while earlier clips are in flight; only two pixel counts
(A2D) or one uint8 mask (J&F) per clip come back to the host.  Each
prints the JAX loop's summary line to stderr.
"""

from __future__ import annotations

import sys
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..data.loader import to_device
from ..metrics import PR_THRESHOLDS, SegMetrics
from ..metrics_video import JFMetrics
from ..ops.norm import maybe_normalize_image
from .pipeline import run_pipelined


@torch.no_grad()
def clip_logits(model: nn.Module, video: torch.Tensor, ids: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
    """video (T, H, W, 3) uint8 (or normalized float); ids / mask (L,).
    Returns the (T, H, W, 2) logits."""
    return model(maybe_normalize_image(video)[None], ids[None], mask[None])


@torch.no_grad()
def clip_iou(model: nn.Module, video: torch.Tensor, ids: torch.Tensor,
             mask: torch.Tensor, valid_index: int, target: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """video (T, H, W, 3) uint8; ids / mask (L,) for the clip's sentence;
    target (H, W) in {0, 1} for frame `valid_index`.  Returns (inter,
    union) as f32 pixel counts (0-d tensors on the clip's device)."""
    logits = clip_logits(model, video, ids, mask)
    pred = logits[valid_index].argmax(dim=-1).float()
    gt = target.float()
    return (pred * gt).sum(), torch.maximum(pred, gt).sum()


def _clips(model: nn.Module, ds, max_items: Optional[int]):
    """produce() of the loops: each example with its clip, ids, mask and
    target on the model's device."""
    device = next(model.parameters()).device
    n = len(ds) if max_items is None else min(len(ds), max_items)

    def produce():
        for i in range(n):
            ex = ds[i]
            yield ex, [to_device(a, device) for a in (
                ex.video, ex.ids.astype(np.int64), ex.mask.astype(np.int64),
                ex.target.astype(np.uint8))]

    return produce


def evaluate_a2d(model: nn.Module, ds,
                 max_items: Optional[int] = None) -> dict:
    """ds yields `data.a2d.VideoExample`s of (T, H, W, 3) clips; each is
    scored on its annotated frame.  Returns SegMetrics.summary()."""
    metrics = SegMetrics()

    def dispatch(item):
        ex, (video, ids, mask, target) = item
        return clip_iou(model, video, ids, mask, ex.valid_index, target)

    def sink(item, result):
        inter, union = (t.item() for t in result)
        metrics.update(np.asarray([inter]), np.asarray([union]))

    run_pipelined(_clips(model, ds, max_items), dispatch, sink)
    summary = metrics.summary()
    prec = " ".join(f"P@{t}={summary[f'P@{t}']:.2f}" for t in PR_THRESHOLDS)
    print(f"A2D: mIoU={summary['mIoU']:.2f} oIoU={summary['oIoU']:.2f} "
          f"{prec} (n={metrics.n})", file=sys.stderr)
    return summary


def evaluate_ytvos_jf(model: nn.Module, ds,
                      max_items: Optional[int] = None) -> dict:
    """Local J&F over a labeled YTVOS-style dataset (`data.ytvos.
    YTVOSDataset`): the annotated frame of each item.  Returns
    JFMetrics.summary()."""
    jf = JFMetrics()

    def dispatch(item):
        ex, (video, ids, mask, _) = item
        logits = clip_logits(model, video, ids, mask)
        return logits[ex.valid_index].argmax(dim=-1).to(torch.uint8)

    def sink(item, pred):
        jf.update(pred.cpu().numpy(), item[0].target.astype(np.uint8))

    run_pipelined(_clips(model, ds, max_items), dispatch, sink)
    summary = jf.summary()
    print(f"YTVOS(train-split) J={summary['J']:.2f} F={summary['F']:.2f} "
          f"J&F={summary['J&F']:.2f}", file=sys.stderr)
    return summary
