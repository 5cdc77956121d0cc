"""Multimodal Swin Transformer, 2D (counterpart of
`lavt_rs_tpu/models/swin2d.py`, the lavt_one path).

NHWC / (B, L, C) tokens throughout.  Parameter names are the reference's
(`layers.N.blocks.M.attn.qkv`, `layers.N.fusion...`, `norm{i}`).

Routing.  Each block is routed before any launch by the JAX package's
own predicates, ported (`ops/fused_msa.fused_msa_routed`,
`ops/window_attn.attn_fwd_supported`, `ops/fused_mlp.fused_tail_routed`,
`ops/ln.layer_norm_rows_routed`), as `lavt_rs_tpu/models/swin2d.py:
205-247, 288-292, 352-362, 141` does.  With `use_kernels` a routed call
launches the hand-written kernel on a CUDA tensor (its plain version on a
CPU tensor); with `use_kernels=False` the same route calls the plain
versions.  Where the JAX package runs XLA the port runs the same ops as
torch modules: that is the counterpart of the XLA route, not a fallback.
`SwinBlock.kernels` lists the kernels a block launches on these routes
and `MultiModalSwinTransformer.kernel_plan` adds them up per forward or
training step.
  * The window MSA ("fused", window 12): K1 (`fused_window_msa_ln`, the
    pre-attention LN taken by the MSA's own launches) where windowing needs
    no padding.  Where it does, the block runs an explicit LN first (the
    model pads after LN, and LN of a zero pad row would give ln_bias), pads
    and rolls the map, and the MSA reads its windows from the (B, Hp, Wp,
    C) map and writes them back at the same positions through K11
    (`fused_msa_2d`, its attention launch in map order): no partition or
    reverse copy.  At 480² that is K1 at stages 1-2 and K11 at stages 3
    (30 -> 36) and 4 (15 -> 24).  While autograd records the block
    (training), the padded stages keep the partition and K2 (through
    `FusedWindowMSA`).
  * The window MSA ("core", window 7, N = 49): the explicit LN, the `qkv`
    Linear, K10 (`window_attn.window_attention`; in training K10's save
    mode and K9 through `window_attn.WindowAttention`), the `proj` Linear.
    Every window-7 stage pads at 480² (120 -> 126, 60 -> 63, 30 -> 35,
    15 -> 21).
  * The window MSA ("chain", where neither predicate holds): the same
    Linears around `ops/attention.window_attention_xla`.
  * The LN -> MLP -> residual tail: K3 (`fused_ln_mlp`; K8 and K7 in
    training) at C = 128, 256, 384, 512 and 1024; at 96, 192, 768 and 1536
    the torch chain norm2 -> fc1 -> exact GELU -> fc2 -> residual.
  * The stage-output norms: K4 (`layer_norm_rows`) at C % 128 == 0 up to
    4096, else the plain f32 row LN.
  * With `use_checkpoint` (training) each block runs under
    `torch.utils.checkpoint` (the reference's per-block checkpoint, JAX
    `nn.remat`): its forward kernels run again in the backward's
    recompute.
  * With Swin's `drop_rate` > 0 in training the LN -> MLP tail leaves the
    fused kernels for the torch chain with its two dropouts (the JAX
    block's `fused_tail` test, `lavt_rs_tpu/models/swin2d.py:361-362`);
    the MSA keeps its route, its output dropped after it (JAX
    `proj_drop`).  `attn_drop_rate` is stored and applied nowhere, as in
    the JAX package.

Training (the module in train mode, parameters in f32): the routed MSA and
LN-MLP tail run through their autograd Functions (`FusedWindowMSA`: K1/K2
in save mode with the K5 backward, or K6 past the residual cap;
`window_attn.WindowAttention`: K10's save mode with the K9 backward;
`FusedLnMlp`: K3 where the block's drop-path rate is 0, else K8 with a
per-sample keep, both with the K7 backward), the routed stage norms
through `LayerNormRows` (K4 with the K4b backward).  DropPath on the attention
branch and the tail's keep are drawn from the generator passed to
`forward`; the per-block rates are linspace(0, drop_path_rate, blocks),
as in the JAX package.  A block's dropout masks (`drop_rate`) come from a
generator of its own, seeded from that generator (`ops.dropout.
dropout_seed`).

The multimodal backbone's stage fusion (`MMBasicLayer.fusion`) is the
config's kind: PWAM (or with --fuse simple its LangProject form, and the
`att_norm` kinds), BCAM, GACD or EFN (`models/fusion_baselines.py`);
`ape` adds the absolute position embedding (`absolute_pos_embed`, the
224 pretraining grid's 56 x 56 rows, (1, 3136, C) as an ImageNet Swin
file holds it) bicubic-resized to the patch grid.  The plain Swin of lts
and vlt has neither, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..config import FusionConfig, FusionKind, GateKind, StageOutput, SwinConfig
from ..ops import attention, fused_mlp, fused_msa, fused_msa_2d, ln, window_attn
from ..ops.dropout import (drop_path_apply, drop_path_kept, drop_path_scale,
                           dropout, dropout_seed, seeded)
from ..ops.resize import resize_f32
from ..ops.window import (relative_bias_from_table, relative_position_index_2d,
                          shift_mask_2d, shift_mask_flags_2d,
                          window_partition, window_reverse)
from .fusion_baselines import BCAM, EFN, GACD
from .pwam import PWAM, LanguageGate, apply_gate


class WindowAttention(fused_msa.WeightLo, nn.Module):
    """W-MSA with a learned relative-position bias, on the route of
    `route`: one fused-MSA call (K1 when the block's pre-attention LN is
    passed in), or qkv -> K10 -> proj, or qkv -> the torch chain -> proj."""

    def __init__(self, dim: int, window_size: int, num_heads: int,
                 qkv_bias: bool = True, qk_scale: Optional[float] = None,
                 use_kernels: bool = True):
        super().__init__()
        self.dim, self.window_size, self.num_heads = dim, window_size, num_heads
        self.scale = qk_scale if qk_scale is not None else (dim // num_heads) ** -0.5
        self.use_kernels = use_kernels
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        # a copy on the default device: the index array is cached and shared
        self.register_buffer("relative_position_index", torch.tensor(
            relative_position_index_2d(window_size, window_size)))
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        self._bias_key = None
        self._bias = None
        self._lo_key = None
        self._lo = None

    def relative_bias(self) -> torch.Tensor:
        """(h, N, N) f32 bias.  Gathered with grad while autograd records
        the table (training: dbias reaches the table through the gather);
        otherwise gathered once and kept until the table changes (a new
        version, device or storage)."""
        t = self.relative_position_bias_table
        if torch.is_grad_enabled() and t.requires_grad:
            return relative_bias_from_table(t, self.relative_position_index)
        key = (t._version, t.device, t.data_ptr())
        if self._bias_key != key:
            with torch.no_grad():
                self._bias = relative_bias_from_table(
                    t, self.relative_position_index)
            self._bias_key = key
        return self._bias

    def _args(self, x, mask):
        bqkv = self.qkv.bias
        if bqkv is None:
            bqkv = torch.zeros(3 * self.dim, dtype=x.dtype, device=x.device)
        return (self.qkv.weight, bqkv, self.proj.weight, self.proj.bias,
                self.relative_bias(), mask, self.num_heads, self.scale)

    def route(self, nw: int, n: int, itemsize: int) -> str:
        """'fused' where the JAX package takes its fused MSA kernel, 'core'
        where it takes the attention-core kernel between its Dense layers,
        'chain' where it runs XLA."""
        h = self.num_heads
        if fused_msa.fused_msa_routed(nw, n, self.dim, h, itemsize):
            return "fused"
        if window_attn.attn_fwd_supported(nw, n, h, self.dim // h):
            return "core"
        return "chain"

    def takes_map_route(self, x) -> bool:
        """Whether a padded block's MSA runs on the map through K11: with
        the kernels, where `fused_msa.window_msa` would take the forward
        kernel alone (no autograd recording x or a parameter)."""
        return self.use_kernels and not (torch.is_grad_enabled() and (
            x.requires_grad or any(p.requires_grad for p in self.parameters())))

    def forward_map(self, x, mask=None, flags=None):
        """K11: x (B, Hp, Wp, C) post-LN, padded and pre-rolled map ->
        the projected attention at the same positions; flags: the mask's
        window flags (`window.shift_mask_flags_2d`) or None."""
        dt = x.dtype
        wqkv, bqkv, wproj, bproj, *rest = self._args(x, mask)
        return fused_msa_2d.fused_window_msa_2d(
            x, wqkv.to(dt), bqkv.to(dt), wproj.to(dt), bproj.to(dt), *rest,
            self.window_size, flags, wlo=self._lo_for(x))

    def forward(self, x, mask=None, ln_params=None, flags=None):
        """x: (B, nW, N, C) windowed tokens (pre-LN when ln_params, the
        block's norm1 (weight, bias), is given: the fused route only);
        mask (nW, N, N) or None, with its window flags (the windows whose
        mask K1, K2, the save mode and K9 read;
        `window.shift_mask_flags_2d`) or None."""
        b, nw, n, c = x.shape
        route = self.route(nw, n, x.element_size())
        if route == "fused":
            args = self._args(x, mask)
            if self.use_kernels:
                return fused_msa.window_msa(x, ln_params, *args, flags=flags,
                                            wlo=self._lo_for(x))
            if ln_params is not None:
                return fused_msa.fused_window_msa_ln_plain(x, *ln_params,
                                                           *args)
            return fused_msa.fused_window_msa_plain(x, *args)
        if ln_params is not None:
            raise ValueError(f"the {route} route takes post-LN tokens")
        h = self.num_heads
        qkv = self.qkv(x)
        bias = self.relative_bias()
        if route == "core" and self.use_kernels and not window_attn.records(
                qkv, bias):  # K10 on the Linear's output: no layout copies
            return self.proj(window_attn.window_attention_qkv(
                qkv, bias, mask, h, self.scale))
        q, k, v = (t.contiguous() for t in window_attn.qkv_heads(qkv, h))
        if route == "core" and self.use_kernels:
            out = window_attn.window_attention(q, k, v, bias, mask,
                                               self.scale, flags)
        else:
            attend = (window_attn.window_attention_plain if route == "core"
                      else attention.window_attention_xla)
            out = attend(q, k, v, bias, mask, self.scale)
        return self.proj(out.transpose(2, 3).reshape(b, nw, n, c))


class Mlp(nn.Module):
    """`mlp.fc1` -> exact GELU -> `mlp.fc2` (the reference's names), each
    followed by dropout at `rate` in training.  Where the tail is routed
    to K3 the block passes these weights to the fused LN-MLP instead of
    calling the module."""

    def __init__(self, dim: int, hidden: int, rate: float = 0.0):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)
        self.rate = rate

    def forward(self, x, generator: Optional[torch.Generator] = None):
        x = dropout(F.gelu(self.fc1(x)), self.rate, self.training, generator)
        return dropout(self.fc2(x), self.rate, self.training, generator)


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int = 7,
                 shift_size: int = 0, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, qk_scale: Optional[float] = None,
                 use_kernels: bool = True, drop_path_rate: float = 0.0,
                 use_checkpoint: bool = False, drop_rate: float = 0.0):
        super().__init__()
        self.window_size, self.shift_size = window_size, shift_size
        self.use_kernels = use_kernels
        self.drop_path_rate = drop_path_rate
        self.drop_rate = drop_rate
        self.use_checkpoint = use_checkpoint  # its layer checkpoints it
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention(dim, window_size, num_heads, qkv_bias,
                                    qk_scale, use_kernels)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), drop_rate)

    def _windows(self, hw: Tuple[int, int]) -> Tuple[int, int, int]:
        """(bottom pad, right pad, windows) of an h x w map."""
        ws = self.window_size
        pad_b, pad_r = ((ws - s % ws) % ws for s in hw)
        return pad_b, pad_r, ((hw[0] + pad_b) // ws) * ((hw[1] + pad_r) // ws)

    def tail_fused(self, train: bool) -> bool:
        """Whether the LN -> MLP tail takes the fused kernels (K3, or K8
        and K7 in training): the JAX block's test, C % 128 == 0 up to the
        port's widths and, in training, no dropout (`drop_rate` 0)."""
        return fused_mlp.fused_tail_routed(self.attn.dim) and not (
            train and self.drop_rate > 0)

    def kernels(self, hw: Tuple[int, int], batch: int, itemsize: int = 2,
                train: bool = False) -> List[str]:
        """The kernels one forward of this block launches on the card for
        `batch` h x w maps (train: one training step, forward and
        backward, where a checkpointed block runs its forward kernels
        again in the recompute), as `forward` routes it; none without
        use_kernels."""
        if not self.use_kernels:
            return []
        pad_b, pad_r, nw = self._windows(hw)
        n, c, heads = self.window_size ** 2, self.attn.dim, self.attn.num_heads
        route = self.attn.route(nw, n, itemsize)
        fwd, bwd = [], []
        if route == "fused":
            fwd.append(("K2" if train else "K11") if pad_b or pad_r else "K1")
            if train:
                bwd.append("K5" if fused_msa.save_residuals_ok(
                    batch, nw, n, c, heads, itemsize) else "K6")
        elif route == "core":
            fwd.append("K10")
            bwd += ["K9"] if train else []
        if self.tail_fused(train):
            fwd.append("K8" if train and self.drop_path_rate > 0 else "K3")
            bwd += ["K7"] if train else []
        return fwd * (2 if train and self.use_checkpoint else 1) + bwd

    def draw_kept(self, b: int, generator: Optional[torch.Generator],
                  device) -> Tuple:
        """The block's draws: its two DropPath draws, attention branch
        first, then the tail's (K8's keep where the tail is fused), and
        the seed of its dropout generator (`dropout_seed`); None for each
        where nothing is drawn."""
        return tuple(drop_path_kept(b, self.drop_path_rate, self.training,
                                    generator, device) for _ in range(2)) + (
            dropout_seed(self.drop_rate, self.training, generator, device),)

    def forward(self, x, hw: Tuple[int, int],
                generator: Optional[torch.Generator] = None,
                kept: Optional[Tuple[Optional[torch.Tensor], ...]] = None):
        """x: (B, H*W, C); the generator draws DropPath and the dropout
        seed in training, unless the draws are given (`kept`, from
        `draw_kept`)."""
        h, w = hw
        b, l, c = x.shape
        if kept is None:
            kept = self.draw_kept(b, generator, x.device)
        drops = seeded(kept[2], x.device)
        ws, ss = self.window_size, self.shift_size
        shortcut = x
        pad_b, pad_r, nw = self._windows(hw)
        padded = bool(pad_b or pad_r)
        hp, wp = h + pad_b, w + pad_r
        fused = self.attn.route(nw, ws * ws, x.element_size()) == "fused"
        if fused and not padded:
            ln_params = (self.norm1.weight, self.norm1.bias)
        else:
            ln_params = None
            x = fused_msa.layer_norm_f32(x, self.norm1.weight, self.norm1.bias)
        x = x.view(b, h, w, c)
        if padded:
            x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
        if ss > 0:
            x = torch.roll(x, shifts=(-ss, -ss), dims=(1, 2))
        mask = shift_mask_2d(hp, wp, ws, ss, x.device)
        flags = shift_mask_flags_2d(hp, wp, ws, ss, x.device)
        if padded and fused and self.attn.takes_map_route(x):
            x = self.attn.forward_map(x, mask, flags)
        else:
            xw = window_partition(x, ws).view(b, nw, ws * ws, c)
            xw = self.attn(xw, mask, ln_params, flags)
            x = window_reverse(xw.view(b * nw, ws * ws, c), ws, hp, wp)
        if ss > 0:
            x = torch.roll(x, shifts=(ss, ss), dims=(1, 2))
        if padded:
            x = x[:, :h, :w, :]
        rate = self.drop_path_rate
        x = dropout(x.reshape(b, l, c), self.drop_rate, self.training, drops)
        x = shortcut + drop_path_apply(x, kept[0], rate)
        if not self.tail_fused(self.training):
            return x + drop_path_apply(self.mlp(self.norm2(x), drops),
                                       kept[1], rate)

        params = (self.norm2.weight, self.norm2.bias, self.mlp.fc1.weight,
                  self.mlp.fc1.bias, self.mlp.fc2.weight, self.mlp.fc2.bias)
        keep = drop_path_scale(kept[1], rate)
        x2 = x.reshape(b * l, c)
        if self.use_kernels:
            y = fused_mlp.ln_mlp(x2, *params, keep, l)
        elif keep is None:
            y = fused_mlp.fused_ln_mlp_plain(x2, *params)
        else:
            y = fused_mlp.fused_ln_mlp_droppath_plain(x2, *params, keep, l)
        return y.view(b, l, c)


class PatchEmbed(nn.Module):
    """4x4 stride-4 conv patchifier: NHWC image -> (B, Wh, Ww, C)."""

    def __init__(self, embed_dim: int = 96, patch_size: int = 4,
                 patch_norm: bool = True):
        super().__init__()
        self.patch_size = patch_size
        self.proj = nn.Conv2d(3, embed_dim, patch_size, patch_size)
        self.norm = nn.LayerNorm(embed_dim, eps=1e-5) if patch_norm else None

    def forward(self, x):
        ps = self.patch_size
        x = x.permute(0, 3, 1, 2)
        h, w = x.shape[-2:]
        if h % ps or w % ps:
            x = F.pad(x, (0, (ps - w % ps) % ps, 0, (ps - h % ps) % ps))
        x = self.proj(x).permute(0, 2, 3, 1)
        return self.norm(x) if self.norm is not None else x


class PatchMerging(nn.Module):
    """2x2 space-to-depth + LN + Linear(4C -> 2C, no bias)."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim, eps=1e-5)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x, hw):
        h, w = hw
        b, l, c = x.shape
        x = x.view(b, h, w, c)
        if h % 2 or w % 2:
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                       x[:, 1::2, 1::2]], dim=-1).view(b, -1, 4 * c)
        return self.reduction(self.norm(x))


class StageNorm(nn.LayerNorm):
    """Stage-output LayerNorm (`norm{i}`), one-pass fast-variance row LN:
    K4 (`layer_norm_rows`) with use_kernels where `layer_norm_rows_routed`
    holds, its plain version otherwise."""

    def __init__(self, dim: int, use_kernels: bool = True):
        super().__init__(dim, eps=1e-5)
        self.use_kernels = use_kernels

    def routed(self, rows: int) -> bool:
        """Whether `rows` rows take K4."""
        return self.use_kernels and ln.layer_norm_rows_routed(
            rows, self.normalized_shape[0])

    def forward(self, x):
        c = x.shape[-1]
        if self.routed(x.numel() // c):
            y = ln.LayerNormRows.apply(x.reshape(-1, c), self.weight,
                                       self.bias, self.eps)
        else:
            y = ln.layer_norm_rows_plain(x.reshape(-1, c), self.weight,
                                         self.bias, self.eps)
        return y.view(x.shape)


def run_blocks(layer: nn.Module, x, hw: Tuple[int, int],
               generator: Optional[torch.Generator] = None):
    """x through `layer.blocks`; with the layer's `use_checkpoint` in
    training each block runs under `torch.utils.checkpoint` (the
    reference's per-block checkpoint, JAX `nn.remat`), its DropPath draws
    made first so that the recompute applies the same."""
    remat = (layer.use_checkpoint and layer.training
             and torch.is_grad_enabled())
    for blk in layer.blocks:
        if remat:
            x = checkpoint(blk, x, hw, None,
                           blk.draw_kept(x.shape[0], generator, x.device),
                           use_reentrant=False)
        else:
            x = blk(x, hw, generator)
    return x


def make_blocks(dim: int, depth: int, num_heads: int, window_size: int,
                mlp_ratio: float, qkv_bias: bool, qk_scale: Optional[float],
                use_kernels: bool,
                drop_path_rates: Optional[Tuple[float, ...]],
                use_checkpoint: bool, drop_rate: float = 0.0) -> nn.ModuleList:
    """One stage's Swin blocks, every second one shifted by half a
    window."""
    rates = drop_path_rates or (0.0,) * depth
    return nn.ModuleList(
        SwinBlock(dim, num_heads, window_size,
                  0 if i % 2 == 0 else window_size // 2, mlp_ratio, qkv_bias,
                  qk_scale, use_kernels, rates[i], use_checkpoint, drop_rate)
        for i in range(depth))


class BasicLayer(nn.Module):
    """One plain (language-free) Swin stage of the lts / vlt backbone:
    blocks -> merge (JAX `swin2d.BasicLayer`, reference lib/backbone.py:
    1409-1554).  With `use_checkpoint` each block is checkpointed in
    training, as in `MMBasicLayer`."""

    def __init__(self, dim: int, depth: int, num_heads: int, window_size: int,
                 mlp_ratio: float, qkv_bias: bool, qk_scale: Optional[float],
                 has_downsample: bool, use_kernels: bool = True,
                 drop_path_rates: Optional[Tuple[float, ...]] = None,
                 use_checkpoint: bool = False, drop_rate: float = 0.0):
        super().__init__()
        self.blocks = make_blocks(dim, depth, num_heads, window_size,
                                  mlp_ratio, qkv_bias, qk_scale, use_kernels,
                                  drop_path_rates, use_checkpoint, drop_rate)
        self.use_checkpoint = use_checkpoint
        self.downsample = PatchMerging(dim) if has_downsample else None

    def forward(self, x, hw, generator: Optional[torch.Generator] = None):
        h, w = hw
        x = run_blocks(self, x, hw, generator)
        if self.downsample is not None:
            return x, self.downsample(x, hw), ((h + 1) // 2, (w + 1) // 2)
        return x, x, hw


def make_fusion(fusion: FusionConfig, dim: int, heads: int,
                hw: Optional[int] = None) -> nn.Module:
    """A 2D stage's fusion module of the config's kind (JAX
    `MMBasicLayer`, `lavt_rs_tpu/models/swin2d.py:498-522`): PWAM, its
    LangProject form (--fuse simple), BCAM (bound to the stage's map of
    `hw` tokens), GACD or EFN."""
    kind = fusion.kind
    if kind in (FusionKind.PWAM, FusionKind.SIMPLE):
        return PWAM(dim, fusion.lang_dim, heads,
                    attention=kind == FusionKind.PWAM,
                    att_norm=fusion.att_norm, dropout=fusion.dropout)
    if kind == FusionKind.BCAM:
        if hw is None:
            raise ValueError("BCAM needs its stage's H*W (the learned "
                             "a_proj): build the backbone with img_size")
        return BCAM(dim, hw, fusion.lang_dim)
    if kind == FusionKind.GACD:
        return GACD(dim, fusion.lang_dim)
    if kind == FusionKind.EFN:
        return EFN(dim, fusion.lang_dim)
    raise ValueError(f"unknown fusion kind {kind}")


class MMBasicLayer(nn.Module):
    """One multimodal stage: Swin blocks -> fusion (`make_fusion`) -> LG
    residual -> merge.  With `use_checkpoint` each block is checkpointed
    in training; the language gate is applied either way (as in the JAX
    layer).  `hw`: the stage's tokens, which BCAM's projection needs."""

    def __init__(self, dim: int, depth: int, num_heads: int, window_size: int,
                 mlp_ratio: float, qkv_bias: bool, qk_scale: Optional[float],
                 has_downsample: bool, fusion: FusionConfig, fusion_heads: int,
                 use_kernels: bool = True,
                 drop_path_rates: Optional[Tuple[float, ...]] = None,
                 use_checkpoint: bool = False, drop_rate: float = 0.0,
                 hw: Optional[int] = None):
        super().__init__()
        self.fusion_cfg = fusion
        self.blocks = make_blocks(dim, depth, num_heads, window_size,
                                  mlp_ratio, qkv_bias, qk_scale, use_kernels,
                                  drop_path_rates, use_checkpoint, drop_rate)
        self.use_checkpoint = use_checkpoint
        self.fusion = make_fusion(fusion, dim, fusion_heads, hw)
        self.res_gate = (LanguageGate(dim, fusion.lg_act)
                         if fusion.gate == GateKind.DEFAULT else None)
        self.downsample = PatchMerging(dim) if has_downsample else None

    def forward(self, x, hw, l, l_mask,
                generator: Optional[torch.Generator] = None):
        h, w = hw
        x = run_blocks(self, x, hw, generator)
        x_pre_fusion = x
        mm = self.fusion(x, l, l_mask, generator)
        gate_out = self.res_gate(mm) if self.res_gate is not None else None
        x = apply_gate(x, mm, gate_out, self.fusion_cfg.gate)
        out = self.fusion_cfg.stage_output
        x_out = (mm if out == StageOutput.RESIDUAL
                 else x if out == StageOutput.HIDDEN else x_pre_fusion)
        if self.downsample is not None:
            return x_out, self.downsample(x, hw), ((h + 1) // 2, (w + 1) // 2)
        return x_out, x, hw


def blocks_plan(blocks, hw: Tuple[int, int], batch: int, itemsize: int,
                train: bool, counts: Dict[str, int], unrouted: List[str],
                where: str) -> None:
    """Add the launches of one stage's `blocks` on `batch` h x w maps
    (`SwinBlock.kernels`) to `counts`, and to `unrouted` each of their
    routes that launches none, with the reason (the JAX package runs XLA
    there)."""
    for blk in blocks:
        for k in blk.kernels(hw, batch, itemsize, train):
            counts[k] = counts.get(k, 0) + 1
    n, c = blk.window_size ** 2, blk.attn.dim
    if blk.use_kernels and blk.attn.route(blk._windows(hw)[2], n,
                                          itemsize) == "chain":
        unrouted.append(f"{where} MSA (C {c}, N {n}): fused_msa_routed "
                        "and attn_fwd_supported are False (JAX: XLA): "
                        "the torch chain")
    if blk.use_kernels and not fused_mlp.fused_tail_routed(c):
        unrouted.append(f"{where} LN-MLP tails (C {c}): the fused_tail "
                        "test is False (C % 128 or C > 512; JAX: XLA): "
                        "the torch chain")


# the absolute position embedding's grid: the 224² pretraining images
APE_PRETRAIN_SIZE = 224


class _SwinStages(nn.Module):
    """What the two 2D backbones share: the patch embedding (with `ape`,
    the absolute position embedding, and the dropout at `drop_rate`
    after it), the stage norms `norm{i}` of out_indices only (no `norm0`
    where stage 1 is not an output), the kernel plan and the pass over
    the stages."""

    def __init__(self, cfg: SwinConfig, out_indices: Tuple[int, ...],
                 ape: bool = False):
        super().__init__()
        self.cfg, self.out_indices = cfg, tuple(out_indices)
        self.patch_embed = PatchEmbed(cfg.embed_dim, cfg.patch_size,
                                      cfg.patch_norm)
        side = APE_PRETRAIN_SIZE // cfg.patch_size
        self.absolute_pos_embed = (
            nn.Parameter(torch.zeros(1, side * side, cfg.embed_dim))
            if ape else None)

    def stage_tokens(self, img_size: int) -> List[int]:
        """Each stage's H*W for img_size² images: the patch grid (padded
        up, as `PatchEmbed`), then (h + 1) // 2 per merge (`PatchMerging`)."""
        h = -(-img_size // self.cfg.patch_size)
        out = []
        for _ in range(self.cfg.num_layers):
            out.append(h * h)
            h = (h + 1) // 2
        return out

    def _embed(self, x, generator):
        """Patch embedding (+ the bicubic-resized `absolute_pos_embed`,
        interpolated in f32 and added in the compute dtype) -> (B, L, C)
        tokens, dropped at `drop_rate` in training."""
        x = self.patch_embed(x)
        b, wh, ww, c = x.shape
        if self.absolute_pos_embed is not None:
            side = int(round(self.absolute_pos_embed.shape[1] ** 0.5))
            ape = self.absolute_pos_embed.float().view(1, side, side, c)
            ape = resize_f32(ape.permute(0, 3, 1, 2), (wh, ww),
                             align_corners=False, mode="bicubic")
            x = x + ape.permute(0, 2, 3, 1).to(x.dtype)
        x = x.reshape(b, wh * ww, c)
        return dropout(x, self.cfg.drop_rate, self.training,
                       generator), (wh, ww)

    def _add_norms(self, use_kernels: bool) -> None:
        """After the layers, as the reference orders its state dict."""
        for i in self.out_indices:
            self.add_module(f"norm{i}", StageNorm(self.cfg.num_features[i],
                                                  use_kernels))

    def _drop_path_rates(self, i: int) -> Tuple[float, ...]:
        cfg = self.cfg
        dpr = np.linspace(0, cfg.drop_path_rate, sum(cfg.depths)).tolist()
        start = sum(cfg.depths[:i])
        return tuple(dpr[start:start + cfg.depths[i]])

    def kernel_plan(self, img: Tuple[int, int], batch: int,
                    itemsize: int = 2, train: bool = False
                    ) -> Tuple[Dict[str, int], List[str]]:
        """Launches per forward of `batch` img = (H, W) images on the card
        (train: per training step), from each block's `kernels` and the
        stage norms' route; and, with the kernels, the parts that launch
        none, each with the reason (the JAX package runs XLA there)."""
        counts: Dict[str, int] = {}
        unrouted = []
        ps = self.patch_embed.patch_size
        hw = tuple(-(-s // ps) for s in img)
        for i, layer in enumerate(self.layers):
            where = f"stage {i + 1}"
            blocks_plan(layer.blocks, hw, batch, itemsize, train, counts,
                        unrouted, where)
            c = layer.blocks[-1].attn.dim
            norm = getattr(self, f"norm{i}", None)
            if norm is not None and norm.routed(batch * hw[0] * hw[1]):
                counts["K4"] = counts.get("K4", 0) + 1
                if train:
                    counts["K4b"] = counts.get("K4b", 0) + 1
            elif norm is not None and norm.use_kernels:
                unrouted.append(f"{where} norm (C {c}): "
                                "layer_norm_rows_routed is False (C % 128; "
                                "JAX: XLA): the plain f32 row LN")
            hw = ((hw[0] + 1) // 2, (hw[1] + 1) // 2)
        return counts, unrouted

    def _stages(self, x, run_layer, generator=None
                ) -> Tuple[torch.Tensor, ...]:
        """The residual stream runs in x's dtype (the compute dtype): under
        autocast the plain modules' outputs are cast back to it before
        every stage and stage norm.  run_layer(layer, x, hw) -> (x_out,
        x, next_hw)."""
        dt = x.dtype
        b = x.shape[0]
        x, hw = self._embed(x, generator)
        outs = []
        for i, layer in enumerate(self.layers):
            x_out, x, next_hw = run_layer(layer, x.to(dt), hw)
            if i in self.out_indices:
                x_out = getattr(self, f"norm{i}")(x_out.to(dt))
                outs.append(x_out.view(b, hw[0], hw[1], -1))
            hw = next_hw
        return tuple(outs)


class SwinTransformer(_SwinStages):
    """The plain 4-stage Swin backbone of lts and vlt (JAX
    `swin2d.SwinTransformer`, reference lib/backbone.py:1557-1693):
    forward(image NHWC) -> tuple of per-stage NHWC features, one per
    out_indices ((1, 2, 3) in both families)."""

    def __init__(self, cfg: SwinConfig,
                 out_indices: Tuple[int, ...] = (0, 1, 2, 3),
                 use_kernels: bool = True, use_checkpoint: bool = False):
        super().__init__(cfg, out_indices)
        self.layers = nn.ModuleList(
            BasicLayer(cfg.num_features[i], cfg.depths[i], cfg.num_heads[i],
                       cfg.window_size, cfg.mlp_ratio, cfg.qkv_bias,
                       cfg.qk_scale, i < cfg.num_layers - 1, use_kernels,
                       self._drop_path_rates(i), use_checkpoint,
                       cfg.drop_rate)
            for i in range(cfg.num_layers))
        self._add_norms(use_kernels)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        return self._stages(x, lambda layer, x, hw: layer(x, hw, generator),
                            generator)


class MultiModalSwinTransformer(_SwinStages):
    """forward(image NHWC, l (B, N_l, D_l), l_mask (B, N_l)) -> tuple of
    per-stage NHWC features, one per out_indices.  `img_size`: the square
    input the model is built for, which BCAM's per-stage projections
    need (`stage_tokens`)."""

    def __init__(self, cfg: SwinConfig, fusion: FusionConfig,
                 out_indices: Tuple[int, ...] = (0, 1, 2, 3),
                 use_kernels: bool = True, use_checkpoint: bool = False,
                 img_size: Optional[int] = None):
        super().__init__(cfg, out_indices, cfg.ape)
        hws = (self.stage_tokens(img_size) if img_size
               else [None] * cfg.num_layers)
        self.layers = nn.ModuleList(
            MMBasicLayer(cfg.num_features[i], cfg.depths[i], cfg.num_heads[i],
                         cfg.window_size, cfg.mlp_ratio, cfg.qkv_bias,
                         cfg.qk_scale, i < cfg.num_layers - 1, fusion,
                         fusion.num_heads[i], use_kernels,
                         self._drop_path_rates(i), use_checkpoint,
                         cfg.drop_rate, hws[i])
            for i in range(cfg.num_layers))
        self._add_norms(use_kernels)

    def forward(self, x, l, l_mask,
                generator: Optional[torch.Generator] = None):
        return self._stages(
            x, lambda layer, x, hw: layer(x, hw, l, l_mask, generator),
            generator)
