"""JAX variables -> the port's state_dict (the weight carry-over).

Inverts `lavt_rs_tpu/convert/torch2jax.py:convert_lavt_one` and
`convert_lavt_video` (`convert_mm_swin3d`; for the hybrid 2D-Swin video
model the 2D blocks' mapping under the video model's names): it takes the
JAX package's `{'params': ..., 'batch_stats': ...}` for a lavt_one or
lavt_video model, given as nested dicts of numpy arrays, and returns the
port's state_dict, whose names are the reference PyTorch ones:

  * Dense kernel (in, out)       -> Linear weight (out, in)
  * Dense kernel of a 1x1 Conv1d -> weight (out, in, 1)
  * Conv kernel (kh, kw, in, out) -> Conv2d weight (out, in, kh, kw)
  * Conv kernel (kd, kh, kw, in, out) -> Conv3d weight (out, in, kd, kh, kw)
  * LayerNorm / BatchNorm scale  -> weight
  * BatchNorm batch_stats mean/var -> running_mean / running_var
  * Embed embedding              -> Embedding weight

It reads numpy only, so it runs without JAX installed.  The geometry
buffers (`relative_position_index`, `position_ids`) and BatchNorm's
`num_batches_tracked` are filled in, so the result loads strictly.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Mapping

import numpy as np
import torch

from ..config import ModelConfig
from ..models.decoder import JOINS
from ..ops.window import relative_position_index_2d, relative_position_index_3d

# JAX decoder module names, in the order of models.decoder.JOINS
_DECODER_JAX = (("fuse4_a", "fuse4_b"), ("fuse3_a", "fuse3_b"),
                ("fuse2_a", "fuse2_b"))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))


def _linear(kernel) -> torch.Tensor:
    return _t(np.asarray(kernel).T)


def _conv1x1(kernel) -> torch.Tensor:
    return _t(np.asarray(kernel).T[:, :, None])


def _conv2d(kernel) -> torch.Tensor:
    return _t(np.asarray(kernel).transpose(3, 2, 0, 1))


def _conv3d(kernel) -> torch.Tensor:
    return _t(np.asarray(kernel).transpose(4, 3, 0, 1, 2))


# SepTPWAM's Conv3d branches (ConvGELU3D / ConvIN3D, each `<name>.conv`)
_TPWAM_CONVS = ("temporal_vis_project", "spatial_vis_project", "vis_fuse",
                "f_query_t", "f_query_s", "f_fuse", "W_t", "W_s",
                "project_mm_t", "project_mm_s")


def _put(sd: Dict[str, torch.Tensor], dst: str, src: Mapping, weight) -> None:
    sd[f"{dst}.weight"] = weight(src["kernel"])
    if "bias" in src:
        sd[f"{dst}.bias"] = _t(src["bias"])


def tpwam_state_dict_from_jax(fu: Mapping) -> Dict[str, torch.Tensor]:
    """JAX SepTPWAM params -> the port module's state_dict (names relative
    to the module)."""
    sd: Dict[str, torch.Tensor] = OrderedDict()
    for name in _TPWAM_CONVS:
        if name in fu:
            _put(sd, f"{name}.0", fu[name]["conv"], _conv3d)
    for name in ("t_gate_v", "s_gate_v", "t_gate_q", "s_gate_q"):
        if name in fu:
            for fc in ("fc1", "fc2"):
                _put(sd, f"{name}.{fc}", fu[name][fc], _conv3d)
    for name in ("f_key", "f_value"):
        _put(sd, f"{name}.0", fu[name], _conv1x1)
    for name in ("W", "project_mm"):  # a Conv3d, or a Dense as a Conv1d
        if name in fu:
            if "conv" in fu[name]:
                _put(sd, f"{name}.0", fu[name]["conv"], _conv3d)
            else:
                _put(sd, f"{name}.0", fu[name], _conv1x1)
    return sd


def state_dict_from_jax(variables: Mapping, cfg: ModelConfig
                        ) -> Dict[str, torch.Tensor]:
    """JAX lavt_one / lavt_video variables -> port state_dict (f32 CPU
    tensors)."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    sd: Dict[str, torch.Tensor] = OrderedDict()

    def dense(dst: str, src: Mapping, conv1d: bool = False):
        _put(sd, dst, src, _conv1x1 if conv1d else _linear)

    def norm(dst: str, src: Mapping):
        sd[f"{dst}.weight"] = _t(src["scale"])
        sd[f"{dst}.bias"] = _t(src["bias"])

    # BERT
    te = params["text_encoder"]
    for name in ("word_embeddings", "position_embeddings",
                 "token_type_embeddings"):
        sd[f"text_encoder.embeddings.{name}.weight"] = _t(te[name]["embedding"])
    norm("text_encoder.embeddings.LayerNorm", te["embeddings_layernorm"])
    sd["text_encoder.embeddings.position_ids"] = torch.arange(
        cfg.bert.max_position_embeddings).unsqueeze(0)
    for i in range(cfg.bert.num_layers):
        src, dst = te[f"layer_{i}"], f"text_encoder.encoder.layer.{i}"
        for name in ("query", "key", "value"):
            dense(f"{dst}.attention.self.{name}", src["attention"][name])
        dense(f"{dst}.attention.output.dense", src["attention_output"])
        norm(f"{dst}.attention.output.LayerNorm", src["attention_layernorm"])
        dense(f"{dst}.intermediate.dense", src["intermediate"])
        dense(f"{dst}.output.dense", src["output"])
        norm(f"{dst}.output.LayerNorm", src["output_layernorm"])

    # multimodal Swin (2D, or 3D for video)
    bb, swin = params["backbone"], cfg.swin
    video = cfg.name == "lavt_video"
    sd["backbone.patch_embed.proj.weight"] = (_conv3d if video else _conv2d)(
        bb["patch_embed"]["proj"]["kernel"])
    sd["backbone.patch_embed.proj.bias"] = _t(bb["patch_embed"]["proj"]["bias"])
    if "norm" in bb["patch_embed"]:
        norm("backbone.patch_embed.norm", bb["patch_embed"]["norm"])
    # the hybrid video backbone's blocks are 2D (JAX `Hybrid2D3DLayer`:
    # the 2D block names and tables under the video model's prefix)
    index = torch.from_numpy(
        relative_position_index_3d(*swin.window_size_3d)
        if video and not cfg.hybrid_2d_3d
        else relative_position_index_2d(swin.window_size, swin.window_size))
    for i in range(swin.num_layers):
        lt, lp = bb[f"layers_{i}"], f"backbone.layers.{i}"
        for j in range(swin.depths[i]):
            bt, bp = lt[f"blocks_{j}"], f"{lp}.blocks.{j}"
            norm(f"{bp}.norm1", bt["norm1"])
            sd[f"{bp}.attn.relative_position_bias_table"] = _t(
                bt["attn"]["relative_position_bias_table"])
            sd[f"{bp}.attn.relative_position_index"] = index.clone()
            dense(f"{bp}.attn.qkv", bt["attn"]["qkv"])
            dense(f"{bp}.attn.proj", bt["attn"]["proj"])
            norm(f"{bp}.norm2", bt["norm2"])
            dense(f"{bp}.mlp.fc1", bt["mlp"]["fc1"])
            dense(f"{bp}.mlp.fc2", bt["mlp"]["fc2"])
        fu, fp = lt["fusion"], f"{lp}.fusion"
        if "image_lang_att" in fu:  # the 2D PWAM
            dense(f"{fp}.vis_project.0", fu["vis_project"], conv1d=True)
            for name in ("f_query", "f_key", "f_value", "W"):
                dense(f"{fp}.image_lang_att.{name}.0",
                      fu["image_lang_att"][name], conv1d=True)
            dense(f"{fp}.project_mm.0", fu["project_mm"], conv1d=True)
        else:
            for k, v in tpwam_state_dict_from_jax(fu).items():
                sd[f"{fp}.{k}"] = v
        if "res_gate" in lt:
            dense(f"{lp}.res_gate.0", lt["res_gate"]["fc1"])
            dense(f"{lp}.res_gate.2", lt["res_gate"]["fc2"])
        if "downsample" in lt:
            norm(f"{lp}.downsample.norm", lt["downsample"]["norm"])
            dense(f"{lp}.downsample.reduction", lt["downsample"]["reduction"])
    for i in cfg.out_indices:
        norm(f"backbone.norm{i}", bb[f"norm{i}"])

    # SimpleDecoding
    cl, cs = params["classifier"], stats["classifier"]
    for (c1, b1, c2, b2), (ja, jb) in zip(JOINS, _DECODER_JAX):
        for conv, bn, src in ((c1, b1, ja), (c2, b2, jb)):
            sd[f"classifier.{conv}.weight"] = _conv2d(cl[src]["conv"]["kernel"])
            norm(f"classifier.{bn}", cl[src]["bn"])
            sd[f"classifier.{bn}.running_mean"] = _t(cs[src]["bn"]["mean"])
            sd[f"classifier.{bn}.running_var"] = _t(cs[src]["bn"]["var"])
            sd[f"classifier.{bn}.num_batches_tracked"] = torch.tensor(0)
    sd["classifier.conv1_1.weight"] = _conv2d(cl["head"]["kernel"])
    sd["classifier.conv1_1.bias"] = _t(cl["head"]["bias"])
    return sd
