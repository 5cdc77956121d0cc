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
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "lavt_one"
    swin: SwinConfig = dataclasses.field(default_factory=SwinConfig)
    fusion: FusionConfig = dataclasses.field(default_factory=FusionConfig)
    bert: BertConfig = dataclasses.field(default_factory=BertConfig)
    num_classes: int = 2
    img_size: int = 480
    max_tokens: int = 20
    lazy_pred: bool = False
    interpolate_before_seg: bool = False
    seg_last: bool = False
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
