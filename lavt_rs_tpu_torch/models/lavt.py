"""LAVTOne and LAVTVideo: BERT + multimodal Swin + SimpleDecoding in one
module (counterpart of `lavt_rs_tpu/models/lavt.py`).

I/O as in the JAX package: image NHWC float (already normalized) or video
(B, T, H, W, 3), text (B, N_l) token ids, l_mask (B, N_l) in {0, 1};
logits NHWC (B, H, W, num_classes), or frame-major (B*T, H, W,
num_classes) for video, in f32, upsampled to the input size with
corner-aligned bilinear.  In training the generator draws every dropout
and DropPath mask, in forward order (BERT first).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from ..config import ModelConfig
from ..ops.resize import resize_nchw
from .bert import BertEncoder
from .decoder import SimpleDecoding
from .swin2d import MultiModalSwinTransformer
from .swin3d import MultiModalSwinTransformer3D


def _check_decoder(cfg: ModelConfig) -> None:
    if cfg.lazy_pred or cfg.interpolate_before_seg or cfg.seg_last:
        raise NotImplementedError(
            "lazy_pred / interpolate_before_seg / seg_last decoders are "
            "in the long-tail slice (ROADMAP.md slice 5)")


def upsample_logits_nchw(logits: torch.Tensor, in_hw) -> torch.Tensor:
    """(B, K, h, w) logits -> (B, H, W, K) f32 at the input size,
    corner-aligned bilinear."""
    return resize_nchw(logits, in_hw, exact=True).permute(0, 2, 3, 1)


class LAVTOne(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        _check_decoder(cfg)
        self.cfg = cfg
        self.text_encoder = BertEncoder(cfg.bert)
        self.backbone = MultiModalSwinTransformer(
            cfg.swin, cfg.fusion, cfg.out_indices, cfg.use_kernels,
            cfg.use_checkpoint)
        self.classifier = SimpleDecoding(8 * cfg.swin.embed_dim,
                                         cfg.num_classes)

    def forward(self, image: torch.Tensor, text_ids: torch.Tensor,
                l_mask: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        dt = self.cfg.compute_dtype
        in_hw = image.shape[1:3]
        l_feats = self.text_encoder(text_ids, l_mask, generator=generator)
        x_c1, x_c2, x_c3, x_c4 = self.backbone(image.to(dt), l_feats, l_mask,
                                               generator)
        logits = self.classifier(x_c4, x_c3, x_c2, x_c1)
        return upsample_logits_nchw(logits, in_hw)


class LAVTVideo(nn.Module):
    """lavt_video: Video Swin 3D backbone + per-frame SimpleDecoding."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        _check_decoder(cfg)
        if cfg.hybrid_2d_3d:
            raise NotImplementedError(
                "the hybrid 2D Swin + 3D PWAM backbone is not ported yet "
                "(ROADMAP.md slice 4)")
        self.cfg = cfg
        self.text_encoder = BertEncoder(cfg.bert)
        self.backbone = MultiModalSwinTransformer3D(
            cfg.swin, cfg.fusion, cfg.tpwam, cfg.out_indices,
            cfg.use_checkpoint, cfg.use_kernels)
        self.classifier = SimpleDecoding(8 * cfg.swin.embed_dim,
                                         cfg.num_classes)

    def forward(self, video: torch.Tensor, text_ids: torch.Tensor,
                l_mask: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """video (B, T, H, W, 3) normalized -> (B*T, H, W, K) f32 logits;
        the generator draws the dropout and DropPath masks in training."""
        dt = self.cfg.compute_dtype
        in_hw = video.shape[2:4]
        l_feats = self.text_encoder(text_ids, l_mask, generator=generator)
        x_c1, x_c2, x_c3, x_c4 = self.backbone(video.to(dt), l_feats, l_mask,
                                               generator)
        logits = self.classifier(x_c4, x_c3, x_c2, x_c1)
        return upsample_logits_nchw(logits, in_hw)
