"""LAVTOne: BERT + multimodal Swin + SimpleDecoding in one module
(counterpart of `lavt_rs_tpu/models/lavt.py:LAVTOne`).

I/O as in the JAX package: image NHWC float (already normalized), text
(B, N_l) token ids, l_mask (B, N_l) in {0, 1}; logits NHWC
(B, H, W, num_classes) in f32, upsampled to the input size with
corner-aligned bilinear.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..config import ModelConfig
from ..ops.resize import resize_nchw
from .bert import BertEncoder
from .decoder import SimpleDecoding
from .swin2d import MultiModalSwinTransformer


class LAVTOne(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.lazy_pred or cfg.interpolate_before_seg or cfg.seg_last:
            raise NotImplementedError(
                "lazy_pred / interpolate_before_seg / seg_last decoders are "
                "in the long-tail slice (ROADMAP.md slice 5)")
        self.cfg = cfg
        self.text_encoder = BertEncoder(cfg.bert)
        self.backbone = MultiModalSwinTransformer(
            cfg.swin, cfg.fusion, cfg.out_indices, cfg.use_kernels)
        self.classifier = SimpleDecoding(8 * cfg.swin.embed_dim,
                                         cfg.num_classes)

    def forward(self, image: torch.Tensor, text_ids: torch.Tensor,
                l_mask: torch.Tensor) -> torch.Tensor:
        dt = self.cfg.compute_dtype
        in_hw = image.shape[1:3]
        l_feats = self.text_encoder(text_ids, l_mask)
        x_c1, x_c2, x_c3, x_c4 = self.backbone(image.to(dt), l_feats, l_mask)
        logits = self.classifier(x_c4, x_c3, x_c2, x_c1)
        return resize_nchw(logits, in_hw, exact=True).permute(0, 2, 3, 1)
