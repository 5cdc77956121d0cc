"""Multimodal Video Swin Transformer, 3D (counterpart of
`lavt_rs_tpu/models/swin3d.py`, the lavt_video backbone).

(B, D, H, W, C) tokens throughout; the stage outputs are per-frame
(B*D, Hi, Wi, Ci).  Parameter names are the reference's
(`layers.N.blocks.M.attn.qkv`, `layers.N.fusion.f_query_t.0`, `norm{i}`).
Windows and shifts are clamped to the input dims (`get_window_size_3d`);
a clamped window keeps the full window's bias table and index, sliced
[:N, :N], as the reference does.

Routing.  Each block is routed before any launch, as the JAX package
routes with `use_pallas` (`lavt_rs_tpu/models/swin3d.py:120-145,
184-200`); with `use_kernels` a routed call launches the hand-written
kernel on a CUDA tensor (its plain version on a CPU tensor):
  * the grouped padded route, in eval mode, where the JAX package's
    `fused3d_grouped_routed` holds (ported in `ops/fused_msa.py`: C = 96,
    the first stage of Video Swin-T/S, at window (8, 7, 7)): pad + shift +
    partition + token pad (392 -> 400 in bf16; none in f32, whose
    sublane tile is 8) as one gather with the unmasked
    windows first (`ops/window.partition_shifted_padded_3d`), then K2p
    (`fused_window_msa_grouped`: qkv, attention and out-projection as
    three launches, each over the maskless prefix and the small-mask rest
    at once), then the inverse gather;
  * elsewhere the `qkv` and `proj` Linears stay plain and K10
    (`ops/window_attn.window_attention`) runs between them where
    `window_attn.attn_fwd_routed_3d` holds: the JAX `attn_fwd_supported`
    plus the port's extension to N <= 400 (the (8, 7, 7) windows,
    N = 392, which the JAX package leaves to XLA behind its TPU gate of
    N <= 256; the port has run K10 there since the video slice);
  * at window (8, 12, 12) (N = 1152, `lavt_video --window12`) the same
    Linears around the torch chain `ops/attention.window_attention_xla`,
    as the JAX package runs XLA there (both its predicates are False).
`SwinBlock3D.route` names a block's route and `kernels` the kernels it
launches; `MultiModalSwinTransformer3D.kernel_plan` adds them up.

The hybrid backbone (`hybrid_2d`, --ytvos_2d_swin_3d_pwam and
--ytvos_2d_swin_pwam) builds `Hybrid2D3DLayer`s instead: the 2D Swin
blocks of `swin2d` at `cfg.window_size`, per frame, on their own routes
(at window 7, N = 49: K10, in training its save mode and K9; K3, or K8
and K7, at C % 128 == 0), then the fusion over the clip.
With `use_kernels=False` every block takes the second or third route with
K10's plain version.  The LayerNorms, the MLP, PatchMerging and the stage
norms are plain PyTorch, as in the JAX package (no fused tail in 3D).

Training (the module in train mode, parameters in f32): every block takes
the second route, as the JAX package gates its grouped route on
`deterministic` (measured there: 154.7 -> 184.8 ms per clip with it in
training), so K2p stays off the training path and every block runs K10 in
save mode forward and K9 backward (`window_attn.WindowAttention`).  The
relative-position bias is gathered with grad, so dbias reaches the table.
DropPath follows the attention and the MLP, each a per-sample draw from
the generator passed to `forward`, in the JAX order; the per-block rates
are linspace(0, drop_path_rate, blocks).

Activation checkpointing (`use_checkpoint`, the JAX package's `nn.remat`
of every `SwinBlock3D`, `lavt_rs_tpu/models/swin3d.py:332-333`): in
training each block runs under `torch.utils.checkpoint` (non-reentrant),
so its activations are recomputed in the backward.  Its two DropPath
draws are made before the checkpointed call and passed in, so that the
recompute applies the same ones (checkpoint's `preserve_rng_state`
restores the default generators, not the explicit `torch.Generator` the
port draws from); the recompute runs K10's save mode again, so a
checkpointed block launches it twice a step.  The last stage also skips
its language gate under the flag, as the reference does.

The stage fusion is `tpwam.build_tpwam`'s 3D kind, whatever the fusion
kind (the JAX layers read `fusion.kind` only for the 2D PWAM of
TPWAMKind.PWAM2D, where --fuse simple takes LangProject).  Swin's
`drop_rate` drops the patch embedding's output and the MLP's two
outputs in training (no projection dropout in the 3D attention, as in
the JAX block; the hybrid's 2D blocks take `swin2d`'s); `ape` is not
read: the JAX 3D backbone has no absolute position embedding.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..config import (FusionConfig, GateKind, StageOutput, SwinConfig,
                      TPWAMConfig)
from ..ops import attention, fused_msa, window_attn
from ..ops.dropout import (drop_path_apply, drop_path_kept, dropout,
                           dropout_seed, seeded)
from ..ops.window import (get_window_size_3d, partition_3d_groups,
                          partition_shifted_padded_3d,
                          relative_bias_from_table_3d,
                          relative_position_index_3d,
                          reverse_shifted_unpadded_3d, shift_mask_3d,
                          shift_mask_flags_3d,
                          window_partition_3d, window_reverse_3d)
from .pwam import LanguageGate, apply_gate
from .swin2d import Mlp, SwinBlock, blocks_plan
from .tpwam import build_tpwam


class WindowAttention3D(fused_msa.WeightLo, nn.Module):
    """3D W-MSA with a relative-position bias over (wd, wh, ww) windows;
    the f32 kernels' lo parts of its weights kept as the 2D module keeps
    them (`fused_msa.WeightLo`)."""

    def __init__(self, dim: int, window_size: Tuple[int, int, int],
                 num_heads: int, qkv_bias: bool = True,
                 qk_scale: Optional[float] = None, use_kernels: bool = True):
        super().__init__()
        self.dim, self.window_size, self.num_heads = dim, window_size, num_heads
        self.scale = qk_scale if qk_scale is not None else (dim // num_heads) ** -0.5
        self.use_kernels = use_kernels
        wd, wh, ww = window_size
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * wd - 1) * (2 * wh - 1) * (2 * ww - 1), num_heads))
        self.register_buffer("relative_position_index", torch.tensor(
            relative_position_index_3d(wd, wh, ww)))
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        self._bias_key = None
        self._bias = None
        self._lo_key = None
        self._lo = None

    def relative_bias(self, n: int, n_p: Optional[int] = None) -> torch.Tensor:
        """(h, N, N) f32 bias of an N-token window (padded to n_p by
        `pad_bias_sublane` when given).  Gathered with grad while autograd
        records the table (training: dbias reaches the table through the
        gather); otherwise gathered once and kept until the table changes
        (a new version, device or storage)."""
        t = self.relative_position_bias_table

        def gather():
            bias = relative_bias_from_table_3d(
                t, self.relative_position_index, n)
            return bias if n_p is None else fused_msa.pad_bias_sublane(bias,
                                                                       n_p)

        if torch.is_grad_enabled() and t.requires_grad:
            return gather()
        key = (t._version, t.device, t.data_ptr(), n, n_p)
        if self._bias_key != key:
            with torch.no_grad():
                self._bias = gather()
            self._bias_key = key
        return self._bias

    def route(self, nw: int, n: int) -> str:
        """'core' (qkv -> K10 -> proj) where `attn_fwd_routed_3d` holds,
        else 'chain' (the torch chain, the JAX package's XLA route)."""
        h = self.num_heads
        return ("core" if window_attn.attn_fwd_routed_3d(nw, n, h,
                                                         self.dim // h)
                else "chain")

    def forward(self, x, mask=None, groups: Optional[Tuple[int, int]] = None,
                flags=None):
        """x: (B, nW, N, C) windowed post-LN tokens, mask (nW, N, N) or None,
        with its window flags (the windows whose mask K9 reads;
        `window.shift_mask_flags_3d`) or None.  With groups = (nu,
        n_real): x is the grouped stream (B, nW, n_p, C) of
        `partition_shifted_padded_3d`, windows [0, nu) maskless and the
        rest under the small mask (nW - nu, n_p, n_p)."""
        b, nw, n, c = x.shape
        h = self.num_heads
        if groups is not None:
            nu, n_real = groups
            bqkv = self.qkv.bias
            if bqkv is None:
                bqkv = torch.zeros(3 * c, dtype=x.dtype, device=x.device)
            return fused_msa.fused_window_msa_grouped(
                x, self.qkv.weight, bqkv, self.proj.weight, self.proj.bias,
                self.relative_bias(n_real, n), mask, nu, h, self.scale,
                wlo=self._lo_for(x))
        qkv = self.qkv(x)
        bias = self.relative_bias(n)
        route = self.route(nw, n)
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


class SwinBlock3D(nn.Module):
    def __init__(self, dim: int, num_heads: int,
                 window_size: Tuple[int, int, int] = (2, 7, 7),
                 shift_size: Tuple[int, int, int] = (0, 0, 0),
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 qk_scale: Optional[float] = None, use_kernels: bool = True,
                 drop_path_rate: float = 0.0, use_checkpoint: bool = False,
                 drop_rate: float = 0.0):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.window_size, self.shift_size = tuple(window_size), tuple(shift_size)
        self.use_kernels = use_kernels
        self.drop_path_rate = drop_path_rate
        self.drop_rate = drop_rate
        self.use_checkpoint = use_checkpoint  # its layer checkpoints it
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention3D(dim, self.window_size, num_heads,
                                      qkv_bias, qk_scale, use_kernels)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), drop_rate)

    def _windows(self, dhw: Tuple[int, int, int]):
        """(window, shift, pads, windows, tokens per window) of a
        d x h x w clip."""
        ws, ss = get_window_size_3d(dhw, self.window_size, self.shift_size)
        pads = tuple((k - s % k) % k for s, k in zip(dhw, ws))
        nw = math.prod((s + p) // k for s, p, k in zip(dhw, pads, ws))
        return ws, ss, pads, nw, math.prod(ws)

    def route(self, n: int, nw: int, itemsize: int = 2,
              train: bool = False) -> str:
        """'grouped' (K2p) in eval mode with the kernels, where
        `fused3d_grouped_routed` holds (the JAX block's test); else the
        attention's route, 'core' (K10) or 'chain'."""
        if not train and self.use_kernels and \
                fused_msa.fused3d_grouped_routed(nw, n, self.dim,
                                                 self.num_heads, itemsize):
            return "grouped"
        return self.attn.route(nw, n)

    def kernels(self, dhw: Tuple[int, int, int], itemsize: int = 2,
                train: bool = False) -> List[str]:
        """The kernels one forward of this block launches on the card for
        a d x h x w clip (train: one training step, where a checkpointed
        block runs K10's save mode again in its recompute), as `forward`
        routes it; none without use_kernels."""
        if not self.use_kernels:
            return []
        *_, nw, n = self._windows(dhw)
        route = self.route(n, nw, itemsize, train)
        fwd = ["K10", "K10"] if train and self.use_checkpoint else ["K10"]
        return {"grouped": ["K2p"], "core": fwd + ["K9"] if train else fwd,
                "chain": []}[route]

    def draw_kept(self, b: int, generator: Optional[torch.Generator],
                  device) -> Tuple:
        """The block's two DropPath draws, attention branch first, and the
        seed of its dropout generator (None for each where nothing is
        drawn)."""
        return tuple(drop_path_kept(b, self.drop_path_rate, self.training,
                                    generator, device) for _ in range(2)) + (
            dropout_seed(self.drop_rate, self.training, generator, device),)

    def forward(self, x, generator: Optional[torch.Generator] = None,
                kept: Optional[Tuple[Optional[torch.Tensor], ...]] = None):
        """x: (B, D, H, W, C); the generator draws DropPath in training,
        unless the draws are given (`kept`, from `draw_kept`)."""
        b, d, h, w, c = x.shape
        if kept is None:
            kept = self.draw_kept(b, generator, x.device)
        ws, ss, (pad_d, pad_b, pad_r), nw, n = self._windows((d, h, w))
        shortcut = x
        y = self.norm1(x)
        dp, hp, wp = d + pad_d, h + pad_b, w + pad_r
        if self.route(n, nw, y.element_size(), self.training) == "grouped":
            # the JAX block's token padding at the dtype's itemsize: 392 ->
            # 400 in bf16, 392 in f32 (the route's predicate checked it)
            n_p = fused_msa._sublane_pad(n, y.element_size())
            nu, mask = partition_3d_groups(d, h, w, dp, hp, wp, ws, ss, n_p,
                                           y.device)
            yw = partition_shifted_padded_3d(y, ws, ss, dp, hp, wp, n_p)
            yw = self.attn(yw, mask, groups=(nu, n))
            y = reverse_shifted_unpadded_3d(yw, ws, ss, dp, hp, wp, d, h, w,
                                            n_p)
        else:
            if pad_d or pad_b or pad_r:
                y = F.pad(y, (0, 0, 0, pad_r, 0, pad_b, 0, pad_d))
            if any(ss):
                y = torch.roll(y, shifts=(-ss[0], -ss[1], -ss[2]),
                               dims=(1, 2, 3))
            mask = shift_mask_3d(dp, hp, wp, ws, ss, y.device)
            flags = shift_mask_flags_3d(dp, hp, wp, ws, ss, y.device)
            yw = window_partition_3d(y, ws).view(b, nw, n, c)
            yw = self.attn(yw, mask, flags=flags)
            y = window_reverse_3d(yw.reshape(b * nw, n, c), ws, dp, hp, wp)
            if any(ss):
                y = torch.roll(y, shifts=ss, dims=(1, 2, 3))
            if pad_d or pad_b or pad_r:
                y = y[:, :d, :h, :w]
        rate = self.drop_path_rate
        x = shortcut + drop_path_apply(y, kept[0], rate)
        return x + drop_path_apply(
            self.mlp(self.norm2(x), seeded(kept[2], x.device)), kept[1], rate)


class PatchEmbed3D(nn.Module):
    """Conv3d patchifier, kernel = stride = patch (1, 4, 4), then LN."""

    def __init__(self, embed_dim: int = 96,
                 patch_size: Tuple[int, int, int] = (1, 4, 4),
                 patch_norm: bool = True):
        super().__init__()
        self.patch_size = tuple(patch_size)
        self.proj = nn.Conv3d(3, embed_dim, self.patch_size, self.patch_size)
        self.norm = nn.LayerNorm(embed_dim, eps=1e-5) if patch_norm else None

    def forward(self, x):
        """x (B, D, H, W, 3) -> (B, D', H', W', C)."""
        pads = []
        for p, s in zip(reversed(self.patch_size), reversed(x.shape[1:4])):
            pads += [0, (p - s % p) % p]
        x = x.permute(0, 4, 1, 2, 3)
        if any(pads):
            x = F.pad(x, pads)
        x = self.proj(x).permute(0, 2, 3, 4, 1)
        return self.norm(x) if self.norm is not None else x


class PatchMerging3D(nn.Module):
    """Spatial-only 2x2 merge + LN + Linear(4C -> 2C, no bias); the
    temporal dim is untouched."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim, eps=1e-5)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x):
        b, d, h, w, c = x.shape
        if h % 2 or w % 2:
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat([x[:, :, 0::2, 0::2], x[:, :, 1::2, 0::2],
                       x[:, :, 0::2, 1::2], x[:, :, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x))


class MMBasicLayer3D(nn.Module):
    """One multimodal video stage: Swin blocks -> 3D PWAM -> LG residual ->
    merge.  With `use_checkpoint` each block is checkpointed in training;
    the reference skips the last stage's language gate when it checkpoints
    (`skip_gate`)."""

    def __init__(self, dim: int, depth: int, num_heads: int,
                 window_size: Tuple[int, int, int], mlp_ratio: float,
                 qkv_bias: bool, qk_scale: Optional[float],
                 has_downsample: bool, fusion: FusionConfig, fusion_heads: int,
                 tpwam: TPWAMConfig, skip_gate: bool = False,
                 use_kernels: bool = True,
                 drop_path_rates: Optional[Tuple[float, ...]] = None,
                 use_checkpoint: bool = False, drop_rate: float = 0.0):
        super().__init__()
        self.fusion_cfg = fusion
        shift = tuple(s // 2 for s in window_size)
        rates = drop_path_rates or (0.0,) * depth
        self.blocks = nn.ModuleList(
            SwinBlock3D(dim, num_heads, window_size,
                        (0, 0, 0) if i % 2 == 0 else shift, mlp_ratio,
                        qkv_bias, qk_scale, use_kernels,
                        drop_path_rate=rates[i], use_checkpoint=use_checkpoint,
                        drop_rate=drop_rate)
            for i in range(depth))
        self.use_checkpoint = use_checkpoint
        self.fusion = build_tpwam(tpwam, dim, fusion_heads, fusion.lang_dim,
                                  fusion.dropout, fusion)
        self.res_gate = (LanguageGate(dim, fusion.lg_act)
                         if fusion.gate == GateKind.DEFAULT and not skip_gate
                         else None)
        self.skip_gate = skip_gate
        self.downsample = PatchMerging3D(dim) if has_downsample else None

    def forward(self, x, l, l_mask,
                generator: Optional[torch.Generator] = None):
        """x (B, D, H, W, C) -> (x_out (B, D, H, W, C), x_next)."""
        b, d, h, w, c = x.shape
        remat = (self.use_checkpoint and self.training
                 and torch.is_grad_enabled())
        for blk in self.blocks:
            if remat:  # the draws first: the recompute applies the same
                x = checkpoint(blk, x, None,
                               blk.draw_kept(b, generator, x.device),
                               use_reentrant=False)
            else:
                x = blk(x, generator)
        x_pre_fusion = x
        mm = self.fusion(x, l, l_mask, generator)  # (B, DHW, C)
        flat = x.reshape(b, d * h * w, c)
        kind = self.fusion_cfg.gate
        if self.skip_gate and kind == GateKind.DEFAULT:
            kind = GateKind.NONE
        gate_out = self.res_gate(mm) if self.res_gate is not None else None
        flat = apply_gate(flat, mm, gate_out, kind)
        out = self.fusion_cfg.stage_output
        x_out = (mm.reshape(b, d, h, w, c) if out == StageOutput.RESIDUAL
                 else flat.reshape(b, d, h, w, c) if out == StageOutput.HIDDEN
                 else x_pre_fusion)
        x = flat.reshape(b, d, h, w, c)
        if self.downsample is not None:
            x = self.downsample(x)
        return x_out, x


class Hybrid2D3DLayer(nn.Module):
    """One stage of the hybrid 2D-Swin video backbone (--ytvos_2d_swin_3d_pwam,
    --ytvos_2d_swin_pwam; JAX `Hybrid2D3DLayer`, reference
    lib/backbone.py:708-992): 2D Swin blocks (`swin2d.SwinBlock`, its
    routes and kernels) on the (B*D, H*W, C) frames -> fusion over the clip
    (`build_tpwam`'s kind on (B, D, H, W, C); under TPWAMKind.PWAM2D the
    2D PWAM on its flattened tokens) -> LG residual -> merge.  The stage output is the
    fusion output.  With `use_checkpoint` each block is checkpointed in
    training, its DropPath draws made first (as `swin2d.MMBasicLayer`)."""

    def __init__(self, dim: int, depth: int, num_heads: int, window_size: int,
                 mlp_ratio: float, qkv_bias: bool, qk_scale: Optional[float],
                 has_downsample: bool, fusion: FusionConfig, fusion_heads: int,
                 tpwam: TPWAMConfig, use_kernels: bool = True,
                 drop_path_rates: Optional[Tuple[float, ...]] = None,
                 use_checkpoint: bool = False, drop_rate: float = 0.0):
        super().__init__()
        self.fusion_cfg = fusion
        rates = drop_path_rates or (0.0,) * depth
        self.blocks = nn.ModuleList(
            SwinBlock(dim, num_heads, window_size,
                      0 if i % 2 == 0 else window_size // 2, mlp_ratio,
                      qkv_bias, qk_scale, use_kernels, rates[i],
                      use_checkpoint, drop_rate)
            for i in range(depth))
        self.use_checkpoint = use_checkpoint
        self.fusion = build_tpwam(tpwam, dim, fusion_heads, fusion.lang_dim,
                                  fusion.dropout, fusion)
        self.res_gate = (LanguageGate(dim, fusion.lg_act)
                         if fusion.gate == GateKind.DEFAULT else None)
        self.downsample = PatchMerging3D(dim) if has_downsample else None

    def forward(self, x, l, l_mask,
                generator: Optional[torch.Generator] = None):
        """x (B, D, H, W, C) -> (x_out (B, D, H, W, C), x_next)."""
        b, d, h, w, c = x.shape
        flat = x.reshape(b * d, h * w, c)
        remat = (self.use_checkpoint and self.training
                 and torch.is_grad_enabled())
        for blk in self.blocks:
            if remat:  # the draws first: the recompute applies the same
                flat = checkpoint(blk, flat, (h, w), None,
                                  blk.draw_kept(b * d, generator, x.device),
                                  use_reentrant=False)
            else:
                flat = blk(flat, (h, w), generator)
        tokens = flat.reshape(b, d * h * w, c)
        mm = self.fusion(flat.reshape(b, d, h, w, c), l, l_mask,
                         generator)  # (B, DHW, C)
        gate_out = self.res_gate(mm) if self.res_gate is not None else None
        tokens = apply_gate(tokens, mm, gate_out, self.fusion_cfg.gate)
        x = tokens.reshape(b, d, h, w, c)
        if self.downsample is not None:
            x = self.downsample(x)
        return mm.reshape(b, d, h, w, c), x


class MultiModalSwinTransformer3D(nn.Module):
    """forward(video (B, T, H, W, 3), l (B, N_l, D_l), l_mask (B, N_l)) ->
    tuple of per-frame (B*T, Hi, Wi, Ci) features, one per out_indices."""

    def __init__(self, cfg: SwinConfig, fusion: FusionConfig,
                 tpwam: TPWAMConfig, out_indices: Tuple[int, ...] = (0, 1, 2, 3),
                 use_checkpoint: bool = False, use_kernels: bool = True,
                 hybrid_2d: bool = False):
        super().__init__()
        self.cfg, self.out_indices = cfg, tuple(out_indices)
        self.patch_embed = PatchEmbed3D(cfg.embed_dim, cfg.patch_size_3d,
                                        cfg.patch_norm)
        last = cfg.num_layers - 1
        dpr = np.linspace(0, cfg.drop_path_rate, sum(cfg.depths)).tolist()
        starts = np.cumsum((0,) + tuple(cfg.depths)).tolist()

        def layer(i):
            common = (cfg.num_features[i], cfg.depths[i], cfg.num_heads[i])
            rest = (cfg.mlp_ratio, cfg.qkv_bias, cfg.qk_scale, i < last,
                    fusion, fusion.num_heads[i], tpwam)
            kw = dict(use_kernels=use_kernels,
                      drop_path_rates=tuple(dpr[starts[i]:starts[i + 1]]),
                      use_checkpoint=use_checkpoint, drop_rate=cfg.drop_rate)
            if hybrid_2d:  # the 2D window, as the JAX package (:506-511)
                return Hybrid2D3DLayer(*common, cfg.window_size, *rest, **kw)
            return MMBasicLayer3D(*common, cfg.window_size_3d, *rest,
                                  skip_gate=use_checkpoint and i == last, **kw)

        self.layers = nn.ModuleList(layer(i) for i in range(cfg.num_layers))
        for i in self.out_indices:
            self.add_module(f"norm{i}", nn.LayerNorm(cfg.num_features[i],
                                                     eps=1e-5))

    def kernel_plan(self, frames: int, img: Tuple[int, int],
                    itemsize: int = 2, train: bool = False
                    ) -> Tuple[Dict[str, int], List[str]]:
        """Launches per forward of one clip of `frames` img = (H, W) frames
        on the card (train: per training step), from each block's
        `kernels` (the hybrid's 2D blocks at a batch of the clip's frames);
        and, with the kernels, the routes that launch none, each with the
        reason (the JAX package runs XLA there)."""
        counts: Dict[str, int] = {}
        unrouted = []
        pt, ph, pw = self.patch_embed.patch_size
        d, h, w = -(-frames // pt), -(-img[0] // ph), -(-img[1] // pw)
        for i, layer in enumerate(self.layers):
            if isinstance(layer, Hybrid2D3DLayer):
                blocks_plan(layer.blocks, (h, w), d, itemsize, train, counts,
                            unrouted, f"stage {i + 1}")
                h, w = (h + 1) // 2, (w + 1) // 2
                continue
            for j, blk in enumerate(layer.blocks):
                got = blk.kernels((d, h, w), itemsize, train)
                for k in got:
                    counts[k] = counts.get(k, 0) + 1
                ws, _, _, nw, n = blk._windows((d, h, w))
                if blk.use_kernels and not got:
                    unrouted.append(
                        f"stage {i + 1} block {j} (C {blk.dim}, window {ws}, "
                        f"N {n}): fused3d_grouped_routed and "
                        "attn_fwd_supported are False (JAX: XLA) and N > 400, "
                        "past the port's K10 extension: the torch chain")
            h, w = (h + 1) // 2, (w + 1) // 2
        return counts, unrouted

    def forward(self, video, l, l_mask,
                generator: Optional[torch.Generator] = None):
        """The residual stream runs in the video's dtype (the compute
        dtype): under autocast the plain modules' outputs are cast back to
        it before every stage and stage norm, as in the 2D backbone."""
        dt = video.dtype
        x = dropout(self.patch_embed(video), self.cfg.drop_rate,
                    self.training, generator)
        outs = []
        for i, layer in enumerate(self.layers):
            x_out, x = layer(x.to(dt), l, l_mask, generator)
            if i in self.out_indices:
                x_out = getattr(self, f"norm{i}")(x_out.to(dt))
                b, d, hh, ww, cc = x_out.shape
                outs.append(x_out.reshape(b * d, hh, ww, cc))
        return tuple(outs)
