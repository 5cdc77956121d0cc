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

Training (the module in train mode, parameters in f32): the routed MSA and
LN-MLP tail run through their autograd Functions (`FusedWindowMSA`: K1/K2
in save mode with the K5 backward, or K6 past the residual cap;
`window_attn.WindowAttention`: K10's save mode with the K9 backward;
`FusedLnMlp`: K3 where the block's drop-path rate is 0, else K8 with a
per-sample keep, both with the K7 backward), the routed stage norms
through `LayerNormRows` (K4 with the K4b backward).  DropPath on the attention
branch and the tail's keep are drawn from the generator passed to
`forward`; the per-block rates are linspace(0, drop_path_rate, blocks),
as in the JAX package.
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
from ..ops.dropout import drop_path_apply, drop_path_kept, drop_path_scale
from ..ops.window import (relative_bias_from_table, relative_position_index_2d,
                          shift_mask_2d, shift_mask_flags_2d,
                          window_partition, window_reverse)
from .pwam import PWAM, LanguageGate, apply_gate


class WindowAttention(nn.Module):
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

    def weight_lo(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(qkv weight's, proj weight's) lo parts, w - trunc(w) with trunc
        clearing the 13 low bits, which the f32 kernels' GEMMs bring beside
        w (`fused_msa.tf32_lo`).  Made once and kept until a weight changes
        (a new version, device or storage: in training, once a step, after
        the optimizer's in-place update), as `relative_bias` keeps the
        bias."""
        wq, wp = self.qkv.weight, self.proj.weight
        key = (wq._version, wp._version, wq.device, wq.data_ptr(),
               wp.data_ptr())
        if self._lo_key != key:
            with torch.no_grad():
                self._lo = (fused_msa.tf32_lo(wq.detach()),
                            fused_msa.tf32_lo(wp.detach()))
            self._lo_key = key
        return self._lo

    def _lo_for(self, x):
        """`weight_lo` where x takes the f32 kernels (an f32 CUDA tensor
        with the kernels and f32 weights), else None."""
        if (self.use_kernels and x.is_cuda and x.dtype == torch.float32
                and self.qkv.weight.dtype == torch.float32):
            return self.weight_lo()
        return None

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
    """`mlp.fc1` -> exact GELU -> `mlp.fc2` (the reference's names).  Where
    the tail is routed to K3 the block passes these weights to the fused
    LN-MLP instead of calling the module."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int = 7,
                 shift_size: int = 0, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, qk_scale: Optional[float] = None,
                 use_kernels: bool = True, drop_path_rate: float = 0.0,
                 use_checkpoint: bool = False):
        super().__init__()
        self.window_size, self.shift_size = window_size, shift_size
        self.use_kernels = use_kernels
        self.drop_path_rate = drop_path_rate
        self.use_checkpoint = use_checkpoint  # its layer checkpoints it
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention(dim, window_size, num_heads, qkv_bias,
                                    qk_scale, use_kernels)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def _windows(self, hw: Tuple[int, int]) -> Tuple[int, int, int]:
        """(bottom pad, right pad, windows) of an h x w map."""
        ws = self.window_size
        pad_b, pad_r = ((ws - s % ws) % ws for s in hw)
        return pad_b, pad_r, ((hw[0] + pad_b) // ws) * ((hw[1] + pad_r) // ws)

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
        if fused_mlp.fused_tail_routed(c):
            fwd.append("K8" if train and self.drop_path_rate > 0 else "K3")
            bwd += ["K7"] if train else []
        return fwd * (2 if train and self.use_checkpoint else 1) + bwd

    def draw_kept(self, b: int, generator: Optional[torch.Generator],
                  device) -> Tuple[Optional[torch.Tensor], ...]:
        """The block's two DropPath draws, attention branch first, then the
        tail's (K8's keep where the tail is fused); None for each where
        nothing is drawn."""
        return tuple(drop_path_kept(b, self.drop_path_rate, self.training,
                                    generator, device) for _ in range(2))

    def forward(self, x, hw: Tuple[int, int],
                generator: Optional[torch.Generator] = None,
                kept: Optional[Tuple[Optional[torch.Tensor], ...]] = None):
        """x: (B, H*W, C); the generator draws DropPath in training, unless
        the draws are given (`kept`, from `draw_kept`)."""
        h, w = hw
        b, l, c = x.shape
        if kept is None:
            kept = self.draw_kept(b, generator, x.device)
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
        x = shortcut + drop_path_apply(x.reshape(b, l, c), kept[0], rate)
        if not fused_mlp.fused_tail_routed(c):
            return x + drop_path_apply(self.mlp(self.norm2(x)), kept[1], rate)

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


class MMBasicLayer(nn.Module):
    """One multimodal stage: Swin blocks -> PWAM -> LG residual -> merge.
    With `use_checkpoint` each block is checkpointed in training; the
    language gate is applied either way (as in the JAX layer)."""

    def __init__(self, dim: int, depth: int, num_heads: int, window_size: int,
                 mlp_ratio: float, qkv_bias: bool, qk_scale: Optional[float],
                 has_downsample: bool, fusion: FusionConfig, fusion_heads: int,
                 use_kernels: bool = True,
                 drop_path_rates: Optional[Tuple[float, ...]] = None,
                 use_checkpoint: bool = False):
        super().__init__()
        if fusion.kind != FusionKind.PWAM:
            raise NotImplementedError(
                f"fusion {fusion.kind.value!r}: only PWAM is ported; the "
                "baselines are in the long-tail slice (ROADMAP.md slice 5)")
        self.fusion_cfg = fusion
        rates = drop_path_rates or (0.0,) * depth
        self.blocks = nn.ModuleList(
            SwinBlock(dim, num_heads, window_size,
                      0 if i % 2 == 0 else window_size // 2, mlp_ratio,
                      qkv_bias, qk_scale, use_kernels, rates[i],
                      use_checkpoint)
            for i in range(depth))
        self.use_checkpoint = use_checkpoint
        self.fusion = PWAM(dim, fusion.lang_dim, fusion_heads,
                           att_norm=fusion.att_norm, dropout=fusion.dropout)
        self.res_gate = (LanguageGate(dim, fusion.lg_act)
                         if fusion.gate == GateKind.DEFAULT else None)
        self.downsample = PatchMerging(dim) if has_downsample else None

    def forward(self, x, hw, l, l_mask,
                generator: Optional[torch.Generator] = None):
        h, w = hw
        remat = (self.use_checkpoint and self.training
                 and torch.is_grad_enabled())
        for blk in self.blocks:
            if remat:  # the draws first: the recompute applies the same
                x = checkpoint(blk, x, hw, None,
                               blk.draw_kept(x.shape[0], generator, x.device),
                               use_reentrant=False)
            else:
                x = blk(x, hw, generator)
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


class MultiModalSwinTransformer(nn.Module):
    """forward(image NHWC, l (B, N_l, D_l), l_mask (B, N_l)) -> tuple of
    per-stage NHWC features, one per out_indices."""

    def __init__(self, cfg: SwinConfig, fusion: FusionConfig,
                 out_indices: Tuple[int, ...] = (0, 1, 2, 3),
                 use_kernels: bool = True, use_checkpoint: bool = False):
        super().__init__()
        if cfg.ape:
            raise NotImplementedError(
                "absolute position embedding is in the long-tail slice "
                "(ROADMAP.md slice 5)")
        if cfg.drop_rate or cfg.attn_drop_rate:
            raise NotImplementedError(
                "Swin drop_rate / attn_drop_rate (0 in every published "
                "config) are not ported")
        self.cfg, self.out_indices = cfg, tuple(out_indices)
        self.patch_embed = PatchEmbed(cfg.embed_dim, cfg.patch_size,
                                      cfg.patch_norm)
        dpr = np.linspace(0, cfg.drop_path_rate, sum(cfg.depths)).tolist()
        starts = np.cumsum((0,) + tuple(cfg.depths)).tolist()
        self.layers = nn.ModuleList(
            MMBasicLayer(cfg.num_features[i], cfg.depths[i], cfg.num_heads[i],
                         cfg.window_size, cfg.mlp_ratio, cfg.qkv_bias,
                         cfg.qk_scale, i < cfg.num_layers - 1, fusion,
                         fusion.num_heads[i], use_kernels,
                         tuple(dpr[starts[i]:starts[i + 1]]), use_checkpoint)
            for i in range(cfg.num_layers))
        for i in self.out_indices:
            self.add_module(f"norm{i}", StageNorm(cfg.num_features[i],
                                                  use_kernels))

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
            for blk in layer.blocks:
                for k in blk.kernels(hw, batch, itemsize, train):
                    counts[k] = counts.get(k, 0) + 1
            n, c = blk.window_size ** 2, blk.attn.dim
            where = f"stage {i + 1}"
            if blk.use_kernels and blk.attn.route(
                    blk._windows(hw)[2], n, itemsize) == "chain":
                unrouted.append(f"{where} MSA (C {c}, N {n}): fused_msa_routed "
                                "and attn_fwd_supported are False (JAX: XLA): "
                                "the torch chain")
            if blk.use_kernels and not fused_mlp.fused_tail_routed(c):
                unrouted.append(f"{where} LN-MLP tails (C {c}): the fused_tail "
                                "test is False (C % 128 or C > 512; JAX: XLA): "
                                "the torch chain")
            norm = getattr(self, f"norm{i}", None)
            if norm is not None and norm.routed(batch * hw[0] * hw[1]):
                counts["K4"] = counts.get("K4", 0) + 1
                if train:
                    counts["K4b"] = counts.get("K4b", 0) + 1
            elif norm is not None and norm.use_kernels:
                unrouted.append(f"{where} norm (C {c}): layer_norm_rows_routed "
                                "is False (C % 128; JAX: XLA): the plain f32 "
                                "row LN")
            hw = ((hw[0] + 1) // 2, (hw[1] + 1) // 2)
        return counts, unrouted

    def forward(self, x, l, l_mask,
                generator: Optional[torch.Generator] = None):
        """The residual stream runs in x's dtype (the compute dtype): under
        autocast the plain modules' outputs are cast back to it before
        every stage and stage norm."""
        dt = x.dtype
        x = self.patch_embed(x)
        b, wh, ww, c = x.shape
        x = x.reshape(b, wh * ww, c)
        outs = []
        hw = (wh, ww)
        for i, layer in enumerate(self.layers):
            x_out, x, next_hw = layer(x.to(dt), hw, l, l_mask, generator)
            if i in self.out_indices:
                x_out = getattr(self, f"norm{i}")(x_out.to(dt))
                outs.append(x_out.view(b, hw[0], hw[1], -1))
            hw = next_hw
        return tuple(outs)
