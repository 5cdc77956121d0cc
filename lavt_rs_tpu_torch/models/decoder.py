"""SimpleDecoding, the LAVT top-down conv decoder (counterpart of
`lavt_rs_tpu/models/decoder.py`).

At each join: corner-aligned bilinear upsample to the skip's resolution,
concat along channels, two 3x3 Conv-BN-ReLU; then a 1x1 conv to the class
logits.  Plain `torch.cat` + `nn.Conv2d` + `nn.BatchNorm2d` (eval mode),
with the reference's flat names (`conv1_4`, `bn1_4`, ..., `conv1_1`).
NHWC features in, NCHW logits out (at the stage-1 resolution; the model
owns the final upsample).

The decoder options of the JAX module (`decoder.py:117-168`):
  * `lazy_pred`: no stage-1 skip, so no third join (`conv1_2` ... `bn2_2`);
  * `interpolate_before_seg`: a 2x corner-aligned upsample (of the stage-1
    map, or of the last join's without it) and a Conv-BN-ReLU `pre_seg`;
  * `seg_last` (with it): a 4x upsample and a Conv-BN-ReLU
    `seg_last_conv`.
Both extra stages resize in the compute dtype.  `pre_seg` and
`seg_last_conv` have no reference name in this repository; they are
named after the JAX modules (`pre_seg.conv`, `pre_seg.bn`, ...), so a
reference checkpoint of those two options does not load them.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.resize import resize_nchw

# (conv, bn) name pairs per join, deepest first
JOINS = (("conv1_4", "bn1_4", "conv2_4", "bn2_4"),
         ("conv1_3", "bn1_3", "conv2_3", "bn2_3"),
         ("conv1_2", "bn1_2", "conv2_2", "bn2_2"))


class ConvBNReLU(nn.Module):
    """3x3 Conv (no bias) -> BatchNorm2d -> ReLU, as `conv` and `bn` (the
    JAX `ConvBNReLU`'s names)."""

    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.conv = nn.Conv2d(c_in, c_out, 3, padding=1, bias=False)
        self.bn = nn.BatchNorm2d(c_out)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class SimpleDecoding(nn.Module):
    def __init__(self, c4_dims: int, num_classes: int = 2, factor: int = 2,
                 lazy_pred: bool = False,
                 interpolate_before_seg: bool = False,
                 seg_last: bool = False):
        super().__init__()
        hidden = c4_dims // factor
        skips = (c4_dims // 2, c4_dims // 4, c4_dims // 8)
        self.joins = JOINS[:2] if lazy_pred else JOINS
        c_in = c4_dims
        for (c1, b1, c2, b2), skip in zip(self.joins, skips):
            self.add_module(c1, nn.Conv2d(c_in + skip, hidden, 3, padding=1,
                                          bias=False))
            self.add_module(b1, nn.BatchNorm2d(hidden))
            self.add_module(c2, nn.Conv2d(hidden, hidden, 3, padding=1,
                                          bias=False))
            self.add_module(b2, nn.BatchNorm2d(hidden))
            c_in = hidden
        self.pre_seg = (ConvBNReLU(hidden, hidden) if interpolate_before_seg
                        else None)
        self.seg_last_conv = (ConvBNReLU(hidden, hidden)
                              if interpolate_before_seg and seg_last else None)
        self.conv1_1 = nn.Conv2d(hidden, num_classes, 1)

    def _cbr(self, conv: str, bn: str, x):
        return F.relu(getattr(self, bn)(getattr(self, conv)(x)))

    def forward(self, x_c4, x_c3, x_c2, x_c1=None):
        """x_c4..x_c1: NHWC stage features, deepest first (x_c1 None under
        lazy_pred)."""
        x = x_c4.permute(0, 3, 1, 2)
        for (c1, b1, c2, b2), skip in zip(self.joins, (x_c3, x_c2, x_c1)):
            skip = skip.permute(0, 3, 1, 2)
            if x.shape[-2] < skip.shape[-2] or x.shape[-1] < skip.shape[-1]:
                x = resize_nchw(x, skip.shape[-2:], exact=False)
            x = torch.cat([x, skip], dim=1)
            x = self._cbr(c2, b2, self._cbr(c1, b1, x))
        if self.pre_seg is not None:
            bh, bw = x_c1.shape[1:3] if x_c1 is not None else x.shape[-2:]
            x = self.pre_seg(resize_nchw(x, (2 * bh, 2 * bw), exact=False))
            if self.seg_last_conv is not None:
                x = self.seg_last_conv(resize_nchw(x, (4 * bh, 4 * bw),
                                                   exact=False))
        return self.conv1_1(x)
