"""SimpleDecoding, the LAVT top-down conv decoder (counterpart of
`lavt_rs_tpu/models/decoder.py`).

At each join: corner-aligned bilinear upsample to the skip's resolution,
concat along channels, two 3x3 Conv-BN-ReLU; then a 1x1 conv to the class
logits.  Plain `torch.cat` + `nn.Conv2d` + `nn.BatchNorm2d` (eval mode),
with the reference's flat names (`conv1_4`, `bn1_4`, ..., `conv1_1`).
NHWC features in, NCHW logits out (at the stage-1 resolution; the model
owns the final upsample).
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


class SimpleDecoding(nn.Module):
    def __init__(self, c4_dims: int, num_classes: int = 2, factor: int = 2):
        super().__init__()
        hidden = c4_dims // factor
        skips = (c4_dims // 2, c4_dims // 4, c4_dims // 8)
        c_in = c4_dims
        for (c1, b1, c2, b2), skip in zip(JOINS, skips):
            self.add_module(c1, nn.Conv2d(c_in + skip, hidden, 3, padding=1,
                                          bias=False))
            self.add_module(b1, nn.BatchNorm2d(hidden))
            self.add_module(c2, nn.Conv2d(hidden, hidden, 3, padding=1,
                                          bias=False))
            self.add_module(b2, nn.BatchNorm2d(hidden))
            c_in = hidden
        self.conv1_1 = nn.Conv2d(hidden, num_classes, 1)

    def _cbr(self, conv: str, bn: str, x):
        return F.relu(getattr(self, bn)(getattr(self, conv)(x)))

    def forward(self, x_c4, x_c3, x_c2, x_c1):
        """x_c4..x_c1: NHWC stage features, deepest first."""
        x = x_c4.permute(0, 3, 1, 2)
        for (c1, b1, c2, b2), skip in zip(JOINS, (x_c3, x_c2, x_c1)):
            skip = skip.permute(0, 3, 1, 2)
            if x.shape[-2] < skip.shape[-2] or x.shape[-1] < skip.shape[-1]:
                x = resize_nchw(x, skip.shape[-2:], exact=False)
            x = torch.cat([x, skip], dim=1)
            x = self._cbr(c2, b2, self._cbr(c1, b1, x))
        return self.conv1_1(x)
