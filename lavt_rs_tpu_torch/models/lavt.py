"""The model families (counterpart of `lavt_rs_tpu/models/lavt.py`):

  * LAVTOne: BERT + multimodal Swin + SimpleDecoding in one module;
  * LAVT: the multimodal Swin + SimpleDecoding on language features
    computed outside it (reference lib/_utils.py:10-27);
  * LAVTTwo (`lavt`): LAVT beside its BERT, as the submodules `model` and
    `bert_model`, so its state_dict splits into the reference's two
    checkpoint dicts {'model', 'bert_model'};
  * LTS (`lts`): BERT + the plain Swin (stages 2-4) + LTSDecoding;
  * VLT (`vlt`, and `lavt_vlt` with the multimodal Swin): BERT + Swin
    (stages 2-4) + VLTFuseAndClassify;
  * LAVTVideo: BERT + Video Swin (or the hybrid) + per-frame
    SimpleDecoding.

I/O as in the JAX package: image NHWC float (already normalized) or video
(B, T, H, W, 3), text (B, N_l) token ids, l_mask (B, N_l) in {0, 1};
logits NHWC (B, H, W, num_classes), or frame-major (B*T, H, W,
num_classes) for video, in f32, upsampled to the input size with
corner-aligned bilinear.  In training the generator draws every dropout
and DropPath mask, in forward order (BERT first).

The decoder options (`lazy_pred`, `interpolate_before_seg`, `seg_last`)
are lavt_one's and lavt_video's, as in the JAX package: under lazy_pred
the backbone's outputs are stages 2-4 (`ModelConfig.out_indices`) and the
decoder joins two; LAVTVideo with seg_last returns the decoder's NHWC
logits in the compute dtype, without the final upsample (JAX
`lavt.py:244-248`).  The lavt family's LAVT reads four stages: JAX builds
its backbone with lazy_pred's three and fails to unpack them, and the
port refuses the flag there; it ignores the other two, as JAX does.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from ..config import ModelConfig
from ..ops.resize import resize_nchw
from .bert import BertEncoder
from .decoder import SimpleDecoding
from .lts import LTSDecoding
from .swin2d import MultiModalSwinTransformer, SwinTransformer
from .swin3d import MultiModalSwinTransformer3D
from .vlt import VLTFuseAndClassify

# the stages whose outputs the lts and vlt heads read
STAGES_2_4 = (1, 2, 3)


def simple_decoding(cfg: ModelConfig) -> SimpleDecoding:
    """lavt_one's and lavt_video's decoder with the config's options."""
    return SimpleDecoding(8 * cfg.swin.embed_dim, cfg.num_classes,
                          lazy_pred=cfg.lazy_pred,
                          interpolate_before_seg=cfg.interpolate_before_seg,
                          seg_last=cfg.seg_last)


def decode(classifier: SimpleDecoding, feats, lazy_pred: bool):
    """The decoder on the backbone's stage outputs (stages 2-4 under
    lazy_pred), deepest first."""
    x_c1, (x_c2, x_c3, x_c4) = ((None, feats) if lazy_pred
                                else (feats[0], feats[1:]))
    return classifier(x_c4, x_c3, x_c2, x_c1)


def upsample_logits_nchw(logits: torch.Tensor, in_hw) -> torch.Tensor:
    """(B, K, h, w) logits -> (B, H, W, K) f32 at the input size,
    corner-aligned bilinear."""
    return resize_nchw(logits, in_hw, exact=True).permute(0, 2, 3, 1)


class LAVTOne(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.text_encoder = BertEncoder(cfg.bert)
        self.backbone = MultiModalSwinTransformer(
            cfg.swin, cfg.fusion, cfg.out_indices, cfg.use_kernels,
            cfg.use_checkpoint, cfg.img_size)
        self.classifier = simple_decoding(cfg)

    def forward(self, image: torch.Tensor, text_ids: torch.Tensor,
                l_mask: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        dt = self.cfg.compute_dtype
        in_hw = image.shape[1:3]
        l_feats = self.text_encoder(text_ids, l_mask, generator=generator)
        feats = self.backbone(image.to(dt), l_feats, l_mask, generator)
        logits = decode(self.classifier, feats, self.cfg.lazy_pred)
        return upsample_logits_nchw(logits, in_hw)


class LAVT(nn.Module):
    """lavt's segmentation net: forward(image, l_feats (B, N_l, 768),
    l_mask) with the language features computed outside it."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.lazy_pred:
            raise ValueError(
                "lavt with --lazy_pred: LAVT decodes four stages, and "
                "lazy_pred's backbone gives three (the JAX package's LAVT "
                "fails to unpack them too)")
        self.cfg = cfg
        self.backbone = MultiModalSwinTransformer(
            cfg.swin, cfg.fusion, cfg.out_indices, cfg.use_kernels,
            cfg.use_checkpoint, cfg.img_size)
        self.classifier = SimpleDecoding(8 * cfg.swin.embed_dim,
                                         cfg.num_classes)

    def forward(self, image: torch.Tensor, l_feats: torch.Tensor,
                l_mask: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        dt = self.cfg.compute_dtype
        in_hw = image.shape[1:3]
        x_c1, x_c2, x_c3, x_c4 = self.backbone(image.to(dt), l_feats.to(dt),
                                               l_mask, generator)
        logits = self.classifier(x_c4, x_c3, x_c2, x_c1)
        return upsample_logits_nchw(logits, in_hw)


class LAVTTwo(nn.Module):
    """lavt: the reference trains it as two models, the segmentation net
    and a BertModel, checkpointed as {'model': ..., 'bert_model': ...}
    (reference train.py:596-605).  Here they are the submodules `model`
    and `bert_model` of one module with lavt_one's forward(image, ids,
    mask), so the train step and the evaluation take it unchanged.
    Checkpoints hold the two submodules as the reference's two dicts
    (`train.checkpoint.model_dicts`)."""

    CHECKPOINT_DICTS = ("model", "bert_model")

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.bert_model = BertEncoder(cfg.bert)
        self.model = LAVT(cfg)

    @property
    def backbone(self) -> MultiModalSwinTransformer:
        return self.model.backbone

    def forward(self, image: torch.Tensor, text_ids: torch.Tensor,
                l_mask: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        l_feats = self.bert_model(text_ids, l_mask, generator=generator)
        return self.model(image, l_feats, l_mask, generator)


class LTS(nn.Module):
    """lts: BERT, the plain Swin (stages 2-4), LTSDecoding (reference
    lib/_utils.py:248-273)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.text_encoder = BertEncoder(cfg.bert)
        self.backbone = SwinTransformer(cfg.swin, STAGES_2_4, cfg.use_kernels,
                                        cfg.use_checkpoint)
        self.classifier = LTSDecoding(8 * cfg.swin.embed_dim,
                                      cfg.num_classes, cfg.bert.hidden_size)

    def forward(self, image: torch.Tensor, text_ids: torch.Tensor,
                l_mask: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        dt = self.cfg.compute_dtype
        in_hw = image.shape[1:3]
        l_feats = self.text_encoder(text_ids, l_mask, generator=generator)
        x_c2, x_c3, x_c4 = self.backbone(image.to(dt), generator)
        logits = self.classifier(x_c4, x_c3, x_c2, l_feats, l_mask)
        return upsample_logits_nchw(logits, in_hw)


class VLT(nn.Module):
    """vlt: BERT, the plain Swin (stages 2-4), VLTFuseAndClassify
    (reference lib/_utils.py:278-305); lavt_vlt (`fused_backbone`): the
    multimodal Swin in its place."""

    def __init__(self, cfg: ModelConfig, fused_backbone: bool = False):
        super().__init__()
        self.cfg = cfg
        self.text_encoder = BertEncoder(cfg.bert)
        if fused_backbone:
            self.backbone = MultiModalSwinTransformer(
                cfg.swin, cfg.fusion, STAGES_2_4, cfg.use_kernels,
                cfg.use_checkpoint, cfg.img_size)
        else:
            self.backbone = SwinTransformer(cfg.swin, STAGES_2_4,
                                            cfg.use_kernels,
                                            cfg.use_checkpoint)
        self.fused = fused_backbone
        self.classifier = VLTFuseAndClassify(
            8 * cfg.swin.embed_dim, cfg.img_size,
            num_classes=cfg.num_classes, lang_dim=cfg.bert.hidden_size)

    def forward(self, image: torch.Tensor, text_ids: torch.Tensor,
                l_mask: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        dt = self.cfg.compute_dtype
        in_hw = image.shape[1:3]
        l_feats = self.text_encoder(text_ids, l_mask, generator=generator)
        if self.fused:
            feats = self.backbone(image.to(dt), l_feats, l_mask, generator)
        else:
            feats = self.backbone(image.to(dt), generator)
        x_c2, x_c3, x_c4 = feats
        logits = self.classifier(x_c4, x_c3, x_c2, l_feats, l_mask)
        return upsample_logits_nchw(logits, in_hw)


class LAVTVideo(nn.Module):
    """lavt_video: Video Swin 3D backbone (or, with `hybrid_2d_3d`, the
    hybrid of per-frame 2D Swin blocks and the clip's fusion) + per-frame
    SimpleDecoding."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.text_encoder = BertEncoder(cfg.bert)
        self.backbone = MultiModalSwinTransformer3D(
            cfg.swin, cfg.fusion, cfg.tpwam, cfg.out_indices,
            cfg.use_checkpoint, cfg.use_kernels, cfg.hybrid_2d_3d)
        self.classifier = simple_decoding(cfg)

    def forward(self, video: torch.Tensor, text_ids: torch.Tensor,
                l_mask: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """video (B, T, H, W, 3) normalized -> (B*T, H, W, K) f32 logits
        (with seg_last the decoder's (B*T, h, w, K) in the compute dtype,
        not upsampled); the generator draws the dropout and DropPath masks
        in training."""
        dt = self.cfg.compute_dtype
        in_hw = video.shape[2:4]
        l_feats = self.text_encoder(text_ids, l_mask, generator=generator)
        feats = self.backbone(video.to(dt), l_feats, l_mask, generator)
        logits = decode(self.classifier, feats, self.cfg.lazy_pred)
        if self.cfg.seg_last:
            return logits.permute(0, 2, 3, 1)
        return upsample_logits_nchw(logits, in_hw)
