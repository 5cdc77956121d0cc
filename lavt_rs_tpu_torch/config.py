"""Typed configuration for the PyTorch port.

Plain dataclasses mirroring `lavt_rs_tpu.config` (SwinConfig, FusionConfig,
BertConfig, ModelConfig) with no JAX import, so the port runs where JAX is
not installed.  Field names and defaults follow the JAX package, except:

  * `dtype` defaults to "bfloat16", the headline inference type;
  * `use_kernels` replaces `use_pallas`: True routes the Swin blocks and
    stage norms through the hand-written CUDA kernels (on a CUDA tensor;
    a CPU tensor always takes the plain version), False runs the plain
    PyTorch versions of the same functions everywhere.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple

import torch


class FusionKind(str, enum.Enum):
    PWAM = "pwam"
    SIMPLE = "simple"
    BCAM = "bcam"
    GACD = "gacd"
    EFN = "efn"


class GateKind(str, enum.Enum):
    DEFAULT = "default"  # zero-init 2-layer MLP gate, x + gate(mm) * mm
    NO_GATE = "no_gate"  # x + mm
    NONE = "none"  # no residual fusion add at all


class AttnNorm(str, enum.Enum):
    IN = "IN"
    BN = "BN"
    LN = "LN"
    NONE = "none"


class LGAct(str, enum.Enum):
    TANH = "tanh"
    SIGMOID = "sigmoid"


class StageOutput(str, enum.Enum):
    RESIDUAL = "residual"
    HIDDEN = "hidden"
    LAZY = "lazy"


class TPWAMKind(str, enum.Enum):
    """3D PWAM family selector of the video backbone."""

    PWAM2D = "pwam2d"  # plain 2D PWAM applied on flattened THW tokens
    TS = "ts"
    T = "t"
    T_COMP = "t_comp"
    SEP = "sep"  # SepTPWAM: decoupled t/s branches (published default)
    SEP_INNER = "sep_inner"
    SEQ = "seq"
    SEP_SEQ = "sep_seq"
    SEP_SEQ_INNER = "sep_seq_inner"


class BranchFuse(str, enum.Enum):
    """How SepTPWAM fuses its temporal and spatial branches."""

    SUM = "sum"
    SUM_CONV = "sum_conv"
    CAT = "cat"  # concat + reduce conv


SWIN_SIZES = {
    "tiny": dict(embed_dim=96, depths=(2, 2, 6, 2), num_heads=(3, 6, 12, 24)),
    "small": dict(embed_dim=96, depths=(2, 2, 18, 2), num_heads=(3, 6, 12, 24)),
    "base": dict(embed_dim=128, depths=(2, 2, 18, 2), num_heads=(4, 8, 16, 32)),
    "large": dict(embed_dim=192, depths=(2, 2, 18, 2), num_heads=(6, 12, 24, 48)),
}


@dataclasses.dataclass(frozen=True)
class SwinConfig:
    embed_dim: int = 128
    depths: Tuple[int, ...] = (2, 2, 18, 2)
    num_heads: Tuple[int, ...] = (4, 8, 16, 32)
    window_size: int = 12
    patch_size: int = 4
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    qk_scale: Optional[float] = None
    drop_rate: float = 0.0
    attn_drop_rate: float = 0.0
    drop_path_rate: float = 0.3
    ape: bool = False
    patch_norm: bool = True
    out_indices: Tuple[int, ...] = (0, 1, 2, 3)
    # video (3D) extras; ignored by the 2D backbone
    window_size_3d: Tuple[int, int, int] = (8, 7, 7)
    patch_size_3d: Tuple[int, int, int] = (1, 4, 4)

    @property
    def num_layers(self) -> int:
        return len(self.depths)

    @property
    def num_features(self) -> Tuple[int, ...]:
        return tuple(self.embed_dim * 2**i for i in range(self.num_layers))

    @staticmethod
    def from_size(size: str, window_size: int = 12, **kw) -> "SwinConfig":
        table = SWIN_SIZES[size]
        return SwinConfig(embed_dim=table["embed_dim"], depths=table["depths"],
                          num_heads=table["num_heads"],
                          window_size=window_size, **kw)


@dataclasses.dataclass(frozen=True)
class FusionConfig:
    kind: FusionKind = FusionKind.PWAM
    gate: GateKind = GateKind.DEFAULT
    lg_act: LGAct = LGAct.TANH
    att_norm: AttnNorm = AttnNorm.IN
    num_heads: Tuple[int, ...] = (1, 1, 1, 1)
    dropout: float = 0.0
    lang_dim: int = 768
    stage_output: StageOutput = StageOutput.RESIDUAL


@dataclasses.dataclass(frozen=True)
class TPWAMConfig:
    """3D-PWAM variant of the video models (A2D defaults: kernel_t 3-3-3,
    kernel_s 1-1-1, W and project_mm decomposed into t + s branches)."""

    kind: TPWAMKind = TPWAMKind.SEP
    kernel_t: Tuple[int, int, int] = (3, 3, 3)
    kernel_s: Tuple[int, int, int] = (1, 1, 1)
    kernel_sq: Tuple[int, int, int] = (1, 3, 3)
    branch_fuse: BranchFuse = BranchFuse.SUM
    fuse_kernel: Optional[Tuple[int, int, int]] = None  # None: kernel_t
    self_gate: bool = False
    w_t3x3_s1x1: bool = True
    mm_t3x3_s1x1: bool = True
    # single-conv W / project_mm ablations: "3" = Conv3d (1, 3, 3), "3x3" =
    # Conv3d kernel_t; they take precedence over the t/s decompositions
    w_single_conv: Optional[str] = None
    mm_single_conv: Optional[str] = None
    seq_residual: bool = False


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    hidden_dropout: float = 0.1
    attn_dropout: float = 0.1


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "lavt_one"
    swin: SwinConfig = dataclasses.field(default_factory=SwinConfig)
    fusion: FusionConfig = dataclasses.field(default_factory=FusionConfig)
    bert: BertConfig = dataclasses.field(default_factory=BertConfig)
    tpwam: TPWAMConfig = dataclasses.field(default_factory=TPWAMConfig)
    num_classes: int = 2
    img_size: int = 480
    max_tokens: int = 20
    lazy_pred: bool = False
    interpolate_before_seg: bool = False
    seg_last: bool = False
    # video
    num_frames: int = 8
    hybrid_2d_3d: bool = False
    # the reference skips the last video stage's language gate under
    # checkpointing (MMBasicLayer3D); the port reads it for that alone
    use_checkpoint: bool = False
    dtype: str = "bfloat16"
    use_kernels: bool = True

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def out_indices(self) -> Tuple[int, ...]:
        return (1, 2, 3) if self.lazy_pred else self.swin.out_indices

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def lavt_one_base(window12: bool = True, **kw) -> ModelConfig:
    """The published headline config: lavt_one, Swin-B, 480², window 12."""
    swin = SwinConfig.from_size("base", window_size=12 if window12 else 7)
    return ModelConfig(name="lavt_one", swin=swin, **kw)


def lavt_video_tiny(**kw) -> ModelConfig:
    """A2D recipe: Video Swin-T, SepTPWAM t=3-3-3 s=1-1-1 (README.md:185)."""
    swin = SwinConfig.from_size("tiny", window_size=7, drop_path_rate=0.1)
    return ModelConfig(name="lavt_video", swin=swin, max_tokens=22, **kw)
