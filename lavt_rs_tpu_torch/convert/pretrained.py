"""Pretrained-weight initialization for training (counterpart of
`lavt_rs_tpu/convert/pretrained.py`).

The reference's weight-import flags, applied to a freshly built model:
  * --pretrained_swin_weights: a backbone-only ImageNet Swin (2D models;
    reference lib/mmcv_custom/checkpoint.py:287-360, relative-position
    tables resized bicubic when the window differs, e.g. 7 -> 12 under
    --window12) or Kinetics Video-Swin (lavt_video; patch embedding summed
    over its temporal kernel, reference lib/video_swin_transformer.py:
    811-852).  A full lavt_one / lavt_video / lts / vlt checkpoint
    passed here loads whole.  lavt takes them into its segmentation net
    (`model.backbone.`, `model.classifier.`).  The plain Swin of lts and
    vlt has no fusion weights and no `norm0`: an ImageNet file's tensors
    match its blocks, and nothing else is invented;
  * --ck_bert: HF BERT weights for the text encoder (lavt's
    `bert_model`; a local file only; a uniform `bert.` prefix is
    stripped, the pooler dropped: the port's BERT has none);
  * --pretrained2d_lavt_weights_for_a_3d_model: a 2D LAVT checkpoint
    inflated into the 3D backbone (reference lib/_utils.py:185-238):
    patch embedding unsqueezed in time, relative-position tables resized
    to the 3D window's spatial extent and tiled in time, the 2D fusion
    weights dropped;
  * --pretrained_video_lavt_weights_on_refcocos: a full lavt_video
    checkpoint from the combined-RefCOCO pretraining stage;
  * --pretrained2d_lavt_weights: a 2D LAVT checkpoint into the hybrid
    2D-Swin video model (reference lib/_utils.py:133-183, JAX
    `convert_lavt_2d_to_hybrid`): the patch embedding takes a temporal
    axis of 1, the 2D blocks load as they are (tables resized only when
    the window differs), the fusion weights only into the 2D PWAM of
    --ytvos_2d_swin_pwam (with a 3D SepTPWAM they are dropped).

The port's state_dict uses the reference's names, so a checkpoint maps
onto it by renaming keys and reshaping a few tensors; no tree conversion.
Each flag's tensors are merged non-strictly, as the JAX package's
`merge_variables` and torch's `load_state_dict(strict=False)`: a key
whose name and shape match is copied, everything else keeps its init,
and a per-flag summary of loaded and skipped counts is printed.  The
geometry buffers (`relative_position_index`, ImageNet Swin's `attn_mask`)
are skipped: the model builds its own.  Of a checkpoint's stage fusions
and decoder, a flag carries what the JAX converters carry
(`torch2jax.convert_mm_swin2d`, `convert_mm_swin3d`,
`convert_simple_decoding`) and skips the rest (`jax_converter_reads`):
the 2D PWAM's projections (attention or LangProject) but not its
LayerNorm / BatchNorm att_norm, nor BCAM / GACD / EFN; the 3D kinds'
Conv3d branches of the JAX list and their token-wise keys, values, W
and project_mm; not `pre_seg` / `seg_last_conv`, which have no
reference name.  A flag that matches nothing raises ValueError.  The reshaping runs on the CPU in f32; the results
are copied into the model on its device.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Dict, List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import ModelConfig, TPWAMKind
from ..train.checkpoint import load_model_tensors

StateDict = Dict[str, torch.Tensor]
GEOMETRY_BUFFERS = ("relative_position_index", "attn_mask")
TABLE = "attn.relative_position_bias_table"
# the 2D stage-fusion modules torch2jax.convert_mm_swin2d carries (when the
# stage has `fusion.vis_project.0`)
_FUSION_2D = frozenset(
    ["vis_project.0", "project_mm.0", "image_lang_att.project.0",
     "image_lang_att.project.2"]
    + [f"image_lang_att.{n}.0" for n in ("f_query", "f_key", "f_value", "W")])
# ... and the 3D ones convert_mm_swin3d carries: Conv3d (5-dim) weights of
# these modules, and the token-wise (not 5-dim) ones of _FUSION_3D_TOKEN
_FUSION_3D_CONV = frozenset(
    ("temporal_vis_project", "spatial_vis_project", "temporal_vis_project_q",
     "spatial_vis_project_q", "vis_project", "f_query", "f_query_t",
     "f_query_s", "f_query_t_q", "f_query_s_q", "W_t", "W_s",
     "project_mm_t", "project_mm_s", "W", "project_mm"))
_FUSION_3D_TOKEN = frozenset(("f_key", "f_value", "W", "project_mm"))
# decoder modules with no reference name (named after the JAX modules)
_JAX_ONLY_DECODER = ("classifier.pre_seg.", "classifier.seg_last_conv.")


def jax_converter_reads(name: str, sd: StateDict, prefix: str,
                        video: bool) -> bool:
    """Whether the JAX converters carry the checkpoint tensor `prefix` +
    `name` (a stage-fusion tensor `layers.N.fusion....`, or any other)."""
    if ".fusion." not in name:
        return True
    layer, _, rest = name.partition(".fusion.")
    module = rest.rpartition(".")[0]
    base = f"{prefix}{layer}.fusion."
    if not video:
        return (f"{base}vis_project.0.weight" in sd
                and module in _FUSION_2D)
    top, _, index = module.rpartition(".")
    w = sd.get(f"{base}{module}.weight")
    if index != "0" or w is None:
        return False
    return (top in _FUSION_3D_CONV and w.dim() == 5) or (
        top in _FUSION_3D_TOKEN and w.dim() != 5)


def strip_prefixes(sd: StateDict) -> StateDict:
    """Strip 'module.' everywhere; strip a uniform 'backbone.'/'encoder.'
    (JAX `torch2jax.strip_prefixes`)."""
    out = {k.removeprefix("module."): v for k, v in sd.items()}
    for pfx in ("backbone.", "encoder."):
        if out and all(k.startswith(pfx) for k in out):
            out = {k[len(pfx):]: v for k, v in out.items()}
    return out


def interpolate_rel_pos_bias(table: torch.Tensor,
                             dst_window: Tuple[int, int]) -> torch.Tensor:
    """Bicubic-resize a 2D relative-position table ((2Ws-1)^2, nH) to
    ((2Wd-1)(2Wd'-1), nH) in f32 (reference lib/mmcv_custom/checkpoint.py:
    340-356); the table itself when the window is the same."""
    l1, nh = table.shape
    s1 = int(round(l1 ** 0.5))
    d1, d2 = 2 * dst_window[0] - 1, 2 * dst_window[1] - 1
    if (s1, s1) == (d1, d2):
        return table
    t = table.float().contiguous().permute(1, 0).view(1, nh, s1, s1)
    t = F.interpolate(t, size=(d1, d2), mode="bicubic")
    return t.view(nh, d1 * d2).permute(1, 0).contiguous()


def inflate_rel_pos_table_2d_to_3d(table: torch.Tensor,
                                   window_3d) -> torch.Tensor:
    """2D table -> 3D: bicubic resize to (2Wh-1)(2Ww-1), then tiled
    2Wd-1 times in time (reference lib/_utils.py:156-175)."""
    wd, wh, ww = window_3d
    return interpolate_rel_pos_bias(table, (wh, ww)).repeat(2 * wd - 1, 1)


def inflate_patch_embed_2d_to_3d(w: torch.Tensor,
                                 patch_t: int = 1) -> torch.Tensor:
    """Conv2d (out, in, kh, kw) -> Conv3d (out, in, patch_t, kh, kw):
    repeated along the new depth axis and divided by patch_t, so a
    temporally constant clip gives the 2D output (reference
    lib/video_swin_transformer.py:783); depth 1, every shipped config,
    is the plain unsqueeze."""
    w3 = w[:, :, None].repeat_interleave(patch_t, dim=2)
    return w3 / patch_t if patch_t > 1 else w3


def sum_patch_embed_temporal(w: torch.Tensor) -> torch.Tensor:
    """Kinetics Video-Swin (out, in, kd, kh, kw) -> depth 1 by summing over
    the temporal kernel (reference lib/video_swin_transformer.py:841-843)."""
    return w.sum(dim=2, keepdim=True)


def _swin_partial(sd: StateDict, cfg: ModelConfig, prefix: str,
                  from_2d: bool = False) -> StateDict:
    """Swin backbone tensors of `sd` under `prefix` -> the port's
    `backbone.` names.  2D models: tables resized to the model's window
    (JAX `convert_mm_swin2d`).  lavt_video (`convert_mm_swin3d`): a 3D
    patch embedding of another temporal depth is summed; with from_2d the
    2D checkpoint's patch embedding and tables are inflated and its
    fusion weights dropped."""
    swin, video = cfg.swin, cfg.name == "lavt_video"
    out: StateDict = {}
    for k, v in sd.items():
        if not k.startswith(prefix):
            continue
        name = k[len(prefix):]
        if name == "patch_embed.proj.weight" and video:
            if from_2d:
                v = inflate_patch_embed_2d_to_3d(v, swin.patch_size_3d[0])
            elif v.dim() != 5:
                raise ValueError(
                    f"{k}: a 2D patch embedding {tuple(v.shape)} for the 3D "
                    "backbone; lavt_video takes Kinetics Video-Swin weights "
                    "(or a 2D LAVT checkpoint through "
                    "--pretrained2d_lavt_weights_for_a_3d_model)")
            elif v.shape[2] != swin.patch_size_3d[0]:
                v = sum_patch_embed_temporal(v)
        elif name.endswith(TABLE):
            if not video:
                v = interpolate_rel_pos_bias(
                    v, (swin.window_size, swin.window_size))
            elif from_2d:
                v = inflate_rel_pos_table_2d_to_3d(v, swin.window_size_3d)
        elif from_2d and ".fusion." in name:
            continue  # the 2D PWAM has no 3D counterpart
        if not jax_converter_reads(name, sd, prefix, video):
            continue
        out["backbone." + name] = v
    return out


def full_partial(sd: StateDict, cfg: ModelConfig,
                 from_2d: bool = False) -> StateDict:
    """A full lavt_one / lavt_video checkpoint (or, with from_2d, a 2D one
    for lavt_video) -> the port's names (JAX `convert_lavt_one`,
    `convert_lavt_video`)."""
    sd = strip_prefixes(sd)
    out = {k: v for k, v in sd.items()
           if k.startswith(("text_encoder.", "classifier."))
           and not k.startswith(("text_encoder.pooler.",)
                                + _JAX_ONLY_DECODER)}
    out.update(_swin_partial(sd, cfg, "backbone.", from_2d))
    return out


def hybrid_partial(sd: StateDict, cfg: ModelConfig) -> StateDict:
    """A full 2D lavt_one checkpoint -> the hybrid 2D-Swin video model's
    names (JAX `convert_lavt_2d_to_hybrid`): mapped as a lavt_one of the
    hybrid's widths and window, its patch embedding given a temporal
    axis of 1, its fusion weights kept only for the 2D PWAM."""
    out = full_partial(sd, cfg.replace(name="lavt_one"))
    pe = "backbone.patch_embed.proj.weight"
    if pe in out:
        out[pe] = out[pe][:, :, None]
    if cfg.tpwam.kind != TPWAMKind.PWAM2D:
        out = {k: v for k, v in out.items() if ".fusion." not in k}
    return out


def bert_partial(sd: StateDict, cfg: ModelConfig) -> StateDict:
    """HF BertModel weights -> the text encoder's names (lavt's
    `bert_model.`, every other family's `text_encoder.`); a uniform
    `bert.` prefix is stripped (JAX `_bert_partial`), the pooler
    dropped."""
    if sd and all(k.startswith("bert.") for k in sd):
        sd = {k[len("bert."):]: v for k, v in sd.items()}
    prefix = "bert_model." if cfg.name == "lavt" else "text_encoder."
    return {prefix + k: v for k, v in sd.items()
            if not k.startswith("pooler.")}


def into_model(partial: StateDict, cfg: ModelConfig) -> StateDict:
    """lavt keeps its backbone and decoder under its segmentation net
    `model.` (JAX `merge(..., into_model_root=True)`): a full lavt_one
    checkpoint's text encoder lands there too and is skipped, as in the
    JAX package."""
    if cfg.name != "lavt":
        return partial
    return {"model." + k: v for k, v in partial.items()}


def merge(model: nn.Module, partial: StateDict,
          flag: str) -> Tuple[List[str], List[str]]:
    """Copy each tensor of `partial` whose name and shape match the
    model's state_dict into it (cast to the model's dtype, on its
    device); print the summary.  Returns (loaded, skipped) names."""
    own = model.state_dict()
    loaded, skipped = [], []
    for k, v in partial.items():
        if k.endswith(GEOMETRY_BUFFERS):
            skipped.append(f"{k} (geometry buffer)")
        elif k not in own:
            skipped.append(k)
        elif own[k].shape != v.shape:
            skipped.append(f"{k} (shape {tuple(v.shape)} vs "
                           f"{tuple(own[k].shape)})")
        else:
            loaded.append(k)
    if not loaded:
        raise ValueError(f"{flag}: no tensors matched the model; wrong "
                         f"checkpoint for --model {model.cfg.name}? (skipped "
                         f"{len(skipped)})")
    with torch.no_grad():
        for k in loaded:
            own[k].copy_(partial[k])
    print(f"[{flag}] loaded {len(loaded)} tensors, skipped {len(skipped)}",
          file=sys.stderr)
    for s in skipped[:8]:
        print(f"  skipped: {s}", file=sys.stderr)
    if len(skipped) > 8:
        print(f"  ... and {len(skipped) - 8} more", file=sys.stderr)
    return loaded, skipped


def _needs_video(cfg: ModelConfig, flag: str) -> None:
    if cfg.name != "lavt_video":
        raise ValueError(f"{flag} needs --model lavt_video")


def apply_pretrained_flags(model: nn.Module, cfg: ModelConfig,
                           args) -> List[dict]:
    """Apply the weight-import flags set in `args` to `model` in place, in
    the JAX package's order.  Returns one record per flag applied:
    {"flag", "loaded", "skipped" (name lists), "seconds"}."""
    records = []

    def apply(flag, path, partial_of):
        t0 = time.perf_counter()
        label, partial = partial_of(load_model_tensors(path, "cpu"))
        loaded, skipped = merge(model, partial, flag + label)
        records.append({"flag": flag + label, "loaded": loaded,
                        "skipped": skipped,
                        "seconds": time.perf_counter() - t0})

    def swin_or_full(sd):
        sd = {k.removeprefix("module."): v for k, v in sd.items()}
        if any(k.startswith("text_encoder.") for k in sd):
            return " (full checkpoint)", into_model(full_partial(sd, cfg),
                                                    cfg)
        return " (backbone only)", into_model(
            _swin_partial(strip_prefixes(sd), cfg, ""), cfg)

    if getattr(args, "pretrained_swin_weights", ""):
        apply("--pretrained_swin_weights", args.pretrained_swin_weights,
              swin_or_full)
    ck_bert = getattr(args, "ck_bert", "")
    if ck_bert and os.path.isfile(ck_bert):
        apply("--ck_bert", ck_bert, lambda sd: ("", bert_partial(sd, cfg)))
    path = getattr(args, "pretrained2d_lavt_weights", "")
    if path:
        if cfg.name != "lavt_video" or not cfg.hybrid_2d_3d:
            raise ValueError("--pretrained2d_lavt_weights is for the hybrid "
                             "2D-Swin video models (--ytvos_2d_swin_*)")
        apply("--pretrained2d_lavt_weights", path,
              lambda sd: ("", hybrid_partial(sd, cfg)))
    path = getattr(args, "pretrained2d_lavt_weights_for_a_3d_model", "")
    if path:
        _needs_video(cfg, "--pretrained2d_lavt_weights_for_a_3d_model")
        apply("--pretrained2d_lavt_weights_for_a_3d_model", path,
              lambda sd: ("", full_partial(sd, cfg, from_2d=True)))
    path = getattr(args, "pretrained_video_lavt_weights_on_refcocos", "")
    if path:
        _needs_video(cfg, "--pretrained_video_lavt_weights_on_refcocos")
        apply("--pretrained_video_lavt_weights_on_refcocos", path,
              lambda sd: ("", full_partial(sd, cfg)))
    return records
