"""IoU / precision@K metrics (counterpart of `lavt_rs_tpu/metrics.py`):
`batch_iou` for training, `SegMetrics` for the eval loops.

Behavioral contract: reference train.py:64-131, test.py:242-262: oIoU is
cum_I / cum_U, mIoU the mean per-prediction IoU, P@{0.5..0.9} the share of
predictions at or above each threshold.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

PR_THRESHOLDS = (0.5, 0.6, 0.7, 0.8, 0.9)


def batch_iou(logits: torch.Tensor, target: torch.Tensor):
    """Per-sample intersection and union (f32) from NHWC logits: pred =
    argmax over classes, I = sum(pred gt), U = sum(pred + gt) − I."""
    b = logits.shape[0]
    pred = logits.argmax(dim=-1).reshape(b, -1).float()
    gt = target.reshape(b, -1).float()
    inter = (pred * gt).sum(1)
    return inter, (pred + gt).sum(1) - inter


@dataclasses.dataclass
class SegMetrics:
    """Accumulates oIoU / mIoU / P@K exactly like the reference eval loops
    (numpy and Python floats only)."""

    cum_i: float = 0.0
    cum_u: float = 0.0
    iou_list: list = dataclasses.field(default_factory=list)
    pr_count: Dict[float, int] = dataclasses.field(
        default_factory=lambda: {t: 0 for t in PR_THRESHOLDS})

    def update(self, inter, union) -> None:
        inter = np.atleast_1d(np.asarray(inter, np.float64))
        union = np.atleast_1d(np.asarray(union, np.float64))
        for i, u in zip(inter, union):
            iou = 0.0 if u == 0 else float(i / u)  # reference train.py:72-74
            self.cum_i += float(i)
            self.cum_u += float(u)
            self.iou_list.append(iou)
            for t in PR_THRESHOLDS:
                if iou >= t:
                    self.pr_count[t] += 1

    @property
    def n(self) -> int:
        return len(self.iou_list)

    def summary(self) -> Dict[str, float]:
        n = max(self.n, 1)
        sum_iou = float(np.sum(self.iou_list)) if self.iou_list else 0.0
        out = {
            "mIoU": 100.0 * sum_iou / n if self.iou_list else 0.0,
            "oIoU": 100.0 * self.cum_i / max(self.cum_u, 1e-12),
        }
        for t in PR_THRESHOLDS:
            out[f"P@{t}"] = 100.0 * self.pr_count[t] / n
        return out

    def merge_stats(self, stats: np.ndarray) -> None:
        """Fold all-gathered per-rank `stats_row`s into this accumulator,
        the reduction of a rank-sharded eval: mIoU is sum(iou) / n, so the
        per-item lists never cross ranks."""
        for row in np.atleast_2d(np.asarray(stats, np.float64)):
            self.cum_i += float(row[0])
            self.cum_u += float(row[1])
            # the foreign items' IoUs as (n - 1) zeros and the remainder,
            # so that len() and sum() are both exact
            n_f, sum_f = int(row[3]), float(row[2])
            if n_f > 0:
                self.iou_list.extend([0.0] * (n_f - 1) + [sum_f])
            for t, v in zip(PR_THRESHOLDS, row[4:]):
                self.pr_count[t] += int(v)

    def stats_row(self) -> np.ndarray:
        """This rank's sufficient statistics for merge_stats: cum_I, cum_U,
        sum(iou), n, then the P@K counts."""
        return np.asarray(
            [self.cum_i, self.cum_u, float(np.sum(self.iou_list)),
             float(self.n)] + [float(self.pr_count[t])
                               for t in PR_THRESHOLDS], np.float64)
