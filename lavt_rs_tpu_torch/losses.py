"""Segmentation losses (counterpart of `lavt_rs_tpu/losses.py`).

All take NHWC logits (B, H, W, C) and integer targets (B, H, W) and compute
in f32.  The reference's quirks are kept as the JAX package keeps them:
  * cross_entropy weights the classes [0.9, 1.1] and normalizes by the
    weight sum (torch `F.cross_entropy(weight=...)` semantics);
  * the dice cardinality is sum(p² + t), not sum(p + t);
  * dice-focal: alpha 0.25, gamma 2, focal_rate 3;
  * dice-boundary: max-pool boundary F1 with theta0 = 3, theta = 5.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

_CE_WEIGHTS = (0.9, 1.1)


def cross_entropy_loss(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    logits = logits.float()
    c = logits.shape[-1]
    w = torch.tensor(_CE_WEIGHTS[:c], dtype=torch.float32, device=logits.device)
    return F.cross_entropy(logits.reshape(-1, c), target.reshape(-1).long(),
                           weight=w)


def _dice_terms(logits, target):
    probs = torch.softmax(logits.float(), dim=-1)
    onehot = F.one_hot(target.long(), logits.shape[-1]).float()
    inter = (probs * onehot).sum((1, 2))  # (B, C)
    card = (probs * probs + onehot).sum((1, 2))
    return probs, onehot, inter, card


def multiclass_dice_loss(logits, target, eps: float = 1e-6):
    _, _, inter, card = _dice_terms(logits, target)
    loss_c = (1.0 - 2.0 * inter / (card + eps)).mean(0)
    return (loss_c[1] + loss_c[0]) / 2.0


def dice_focal_loss(logits, target, focal_rate: float = 3.0,
                    dice_rate: float = 1.0, alpha: float = 0.25,
                    gamma: float = 2.0, eps: float = 1e-5):
    probs, onehot, inter, card = _dice_terms(logits, target)
    loss_c = (1.0 - 2.0 * inter / (card + 1e-6)).mean(0)
    dice_loss = (loss_c[1] + loss_c[0]) / 2.0
    pt = probs * onehot + (1.0 - probs) * (1.0 - onehot)
    focal_w = alpha * (1.0 - pt).pow(gamma)
    focal = -focal_w * (onehot * torch.log(pt + eps)
                        + (1.0 - onehot) * torch.log(1.0 - pt + eps))
    return dice_loss * dice_rate + focal.mean() * focal_rate


def _max_pool(x, k: int):
    """(B, H, W) max pool, stride 1, same padding."""
    return F.max_pool2d(x[:, None], k, 1, (k - 1) // 2)[:, 0]


def boundary_loss(logits, target, theta0: int = 3, theta: int = 5):
    """Boundary F1 loss (Bokhovkin & Burnaev)."""
    probs = torch.softmax(logits.float(), dim=-1)[..., 1]
    gt = target.float()
    gt_b = _max_pool(1.0 - gt, theta0) - (1.0 - gt)
    pr_b = _max_pool(1.0 - probs, theta0) - (1.0 - probs)
    gt_b_ext = _max_pool(gt_b, theta).flatten(1)
    pr_b_ext = _max_pool(pr_b, theta).flatten(1)
    gt_b, pr_b = gt_b.flatten(1), pr_b.flatten(1)
    p = (pr_b * gt_b_ext).sum(-1) / (pr_b.sum(-1) + 1e-7)
    r = (gt_b * pr_b_ext).sum(-1) / (gt_b.sum(-1) + 1e-7)
    bf1 = 2.0 * p * r / (p + r + 1e-7)
    return (1.0 - bf1).mean()


def dice_boundary_loss(logits, target, boundary_rate: float = 1.0,
                       dice_rate: float = 1.0):
    return (multiclass_dice_loss(logits, target) * dice_rate
            + boundary_loss(logits, target) * boundary_rate)


LOSSES = {
    "cross_entropy": cross_entropy_loss,
    "dice": multiclass_dice_loss,
    "dice_focal": dice_focal_loss,
    "dice_boundary": dice_boundary_loss,
}


def loss_weight(name: str, target: torch.Tensor) -> torch.Tensor:
    """What loss `name` divides its sum by on a batch of `target`s: the
    class weights of its pixels for cross_entropy (F.cross_entropy's
    weighted mean); for the others, whose terms are per-sample or
    per-pixel means of equal-sized samples, the batch size.  The loss of
    several batches together is their losses' mean weighted by it."""
    if name == "cross_entropy":
        w = torch.tensor(_CE_WEIGHTS, dtype=torch.float32,
                         device=target.device)
        return w[target.long()].sum()
    return torch.tensor(float(target.shape[0]), device=target.device)


def get_loss(name: str, focal_rate: float = 3.0, dice_rate: float = 1.0,
             boundary_rate: float = 0.05):
    """Loss by name, with the reference's rate knobs."""
    if name == "dice_focal":
        return functools.partial(dice_focal_loss, focal_rate=focal_rate,
                                 dice_rate=dice_rate)
    if name == "dice_boundary":
        return functools.partial(dice_boundary_loss,
                                 boundary_rate=boundary_rate,
                                 dice_rate=dice_rate)
    return LOSSES[name]
