"""JAX variables -> the port's state_dict (the weight carry-over).

Inverts `lavt_rs_tpu/convert/torch2jax.py`'s converters of every family:
`convert_lavt_one`, `convert_lavt_two` (lavt), `convert_lts`,
`convert_vlt` (vlt, lavt_vlt) and `convert_lavt_video`
(`convert_mm_swin3d`; for the hybrid 2D-Swin video model the 2D blocks'
mapping under the video model's names): it takes the JAX package's
`{'params': ..., 'batch_stats': ...}`, given as nested dicts of numpy
arrays, and returns the port's state_dict, whose names are the reference
PyTorch ones:

  * Dense kernel (in, out)       -> Linear weight (out, in)
  * Dense kernel of a 1x1 Conv1d -> weight (out, in, 1)
  * MHA {q,k,v}_proj             -> in_proj_weight / in_proj_bias
  * Conv kernel (kh, kw, in, out) -> Conv2d weight (out, in, kh, kw)
  * Conv kernel (kd, kh, kw, in, out) -> Conv3d weight (out, in, kd, kh, kw)
  * LayerNorm / BatchNorm scale  -> weight
  * BatchNorm batch_stats mean/var -> running_mean / running_var
  * Embed embedding              -> Embedding weight

It reads numpy only, so it runs without JAX installed.  The geometry
buffers (`relative_position_index`, `position_ids`) and BatchNorm's
`num_batches_tracked` are filled in, so the result loads strictly.

Every fusion and decoder variant maps: the 2D PWAM with its att_norm
(`f_query_norm` / `W_norm`, a BatchNorm's statistics from
`batch_stats`) or its LangProject form; BCAM, GACD and EFN; every 3D
PWAM kind (TSPWAM's two TPWAMs nested under `temporal.` / `spatial.`);
the absolute position embedding ((1, S, S, C) -> (1, S*S, C)); the
decoder without its third join (lazy_pred) and with `pre_seg` /
`seg_last_conv`.
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


# the 3D kinds' Conv3d branches (ConvGELU3D / ConvIN3D, each `<name>.conv`)
_TPWAM_CONVS = ("temporal_vis_project", "spatial_vis_project", "vis_fuse",
                "f_query_t", "f_query_s", "f_fuse", "W_t", "W_s",
                "project_mm_t", "project_mm_s", "temporal_vis_project_q",
                "spatial_vis_project_q", "f_query_t_q", "f_query_s_q",
                "vis_project", "f_query")


def _put(sd: Dict[str, torch.Tensor], dst: str, src: Mapping, weight) -> None:
    sd[f"{dst}.weight"] = weight(src["kernel"])
    if "bias" in src:
        sd[f"{dst}.bias"] = _t(src["bias"])


def tpwam_state_dict_from_jax(fu: Mapping) -> Dict[str, torch.Tensor]:
    """JAX params of a 3D PWAM kind -> the port module's state_dict (names
    relative to the module); TSPWAM's branches nested as `temporal.` and
    `spatial.`, its reduce `out_reduce.0`."""
    sd: Dict[str, torch.Tensor] = OrderedDict()
    if "temporal" in fu and "spatial" in fu:  # TSPWAM
        for branch in ("temporal", "spatial"):
            for k, v in tpwam_state_dict_from_jax(fu[branch]).items():
                sd[f"{branch}.{k}"] = v
        if "out_reduce" in fu:
            red = fu["out_reduce"]
            if "conv" in red:
                _put(sd, "out_reduce.0", red["conv"], _conv3d)
            else:
                _put(sd, "out_reduce.0", red, _conv1x1)
        return sd
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


def _dense(sd, dst: str, src: Mapping, conv1d: bool = False) -> None:
    _put(sd, dst, src, _conv1x1 if conv1d else _linear)


def _norm(sd, dst: str, src: Mapping) -> None:
    sd[f"{dst}.weight"] = _t(src["scale"])
    sd[f"{dst}.bias"] = _t(src["bias"])


def _batch_norm(sd, dst: str, src: Mapping, stats: Mapping) -> None:
    _norm(sd, dst, src)
    sd[f"{dst}.running_mean"] = _t(stats["mean"])
    sd[f"{dst}.running_var"] = _t(stats["var"])
    sd[f"{dst}.num_batches_tracked"] = torch.tensor(0)


def pwam_2d_state_dict_from_jax(fu: Mapping, stats: Mapping
                                ) -> Dict[str, torch.Tensor]:
    """JAX 2D PWAM params (and its att_norm BatchNorms' `stats`) -> the
    port module's state_dict: the attention with its norms `f_query.1` /
    `W.1` (JAX `f_query_norm` / `W_norm`), or LangProject
    (`image_lang_att.project.0` / `.2`, JAX `fc1` / `fc2`)."""
    sd: Dict[str, torch.Tensor] = OrderedDict()
    _dense(sd, "vis_project.0", fu["vis_project"], conv1d=True)
    att, st = fu["image_lang_att"], stats.get("image_lang_att", {})
    if "fc1" in att:
        _dense(sd, "image_lang_att.project.0", att["fc1"])
        _dense(sd, "image_lang_att.project.2", att["fc2"])
    else:
        for name in ("f_query", "f_key", "f_value", "W"):
            _dense(sd, f"image_lang_att.{name}.0", att[name], conv1d=True)
            norm = f"{name}_norm"
            if norm in st:
                _batch_norm(sd, f"image_lang_att.{name}.1", att[norm],
                            st[norm])
            elif norm in att:
                _norm(sd, f"image_lang_att.{name}.1", att[norm])
    _dense(sd, "project_mm.0", fu["project_mm"], conv1d=True)
    return sd


def baseline_state_dict_from_jax(fu: Mapping) -> Dict[str, torch.Tensor]:
    """JAX BCAM / GACD / EFN params -> the port module's state_dict (the
    reference's names: tests/torch_oracles.py's BCAM / GACD / EFN)."""
    sd: Dict[str, torch.Tensor] = OrderedDict()
    if "lang_reduce" in fu:  # BCAM
        for name in ("lang_reduce", "out_1", "vis_2_2", "a_proj"):
            _dense(sd, name, fu[name])
        for name in ("vis_1", "vis_2", "vis_3", "vis_4", "out3_proj"):
            _dense(sd, f"{name}.0", fu[name])
    elif "mm_gen" in fu:  # GACD
        _dense(sd, "lang_gen.project.0", fu["lang_gen_fc1"])
        _dense(sd, "lang_gen.project.2", fu["lang_gen_fc2"])
        _dense(sd, "mm_gen.0", fu["mm_gen"])
        for name in ("query", "key_c", "key_d", "value"):
            _dense(sd, name, fu[name])
    else:  # EFN: the Conv1d kernel (3, in, out) -> (out, in, 3)
        _dense(sd, "project.0", fu["project"], conv1d=True)
        _dense(sd, "lang_project.0", fu["lang_project"], conv1d=True)
        att = fu["image_lang_att"]
        for name in ("f_query", "f_key"):
            _dense(sd, f"image_lang_att.{name}.0", att[name], conv1d=True)
        _put(sd, "image_lang_att.W.0", att["W"],
             lambda k: _t(np.asarray(k).transpose(2, 1, 0)))
    return sd


def fusion_state_dict_from_jax(fu: Mapping, stats: Mapping
                               ) -> Dict[str, torch.Tensor]:
    """Any stage fusion's JAX params -> the port module's state_dict."""
    if "vis_project" in fu and "kernel" in fu["vis_project"]:
        return pwam_2d_state_dict_from_jax(fu, stats)
    if any(k in fu for k in ("lang_reduce", "mm_gen", "lang_project")):
        return baseline_state_dict_from_jax(fu)
    return tpwam_state_dict_from_jax(fu)


def _conv_bn(sd, dst_conv: str, dst_bn: str, src: Mapping,
             stats: Mapping) -> None:
    """A JAX ConvBN {conv, bn} -> Conv2d + BatchNorm2d."""
    sd[f"{dst_conv}.weight"] = _conv2d(src["conv"]["kernel"])
    _batch_norm(sd, dst_bn, src["bn"], stats["bn"])


def bert_state_dict_from_jax(te: Mapping, cfg: ModelConfig, prefix: str
                             ) -> Dict[str, torch.Tensor]:
    """JAX BertEncoder params -> the port's BERT under `prefix`."""
    sd: Dict[str, torch.Tensor] = OrderedDict()
    for name in ("word_embeddings", "position_embeddings",
                 "token_type_embeddings"):
        sd[f"{prefix}embeddings.{name}.weight"] = _t(te[name]["embedding"])
    _norm(sd, f"{prefix}embeddings.LayerNorm", te["embeddings_layernorm"])
    sd[f"{prefix}embeddings.position_ids"] = torch.arange(
        cfg.bert.max_position_embeddings).unsqueeze(0)
    for i in range(cfg.bert.num_layers):
        src, dst = te[f"layer_{i}"], f"{prefix}encoder.layer.{i}"
        for name in ("query", "key", "value"):
            _dense(sd, f"{dst}.attention.self.{name}", src["attention"][name])
        _dense(sd, f"{dst}.attention.output.dense", src["attention_output"])
        _norm(sd, f"{dst}.attention.output.LayerNorm",
              src["attention_layernorm"])
        _dense(sd, f"{dst}.intermediate.dense", src["intermediate"])
        _dense(sd, f"{dst}.output.dense", src["output"])
        _norm(sd, f"{dst}.output.LayerNorm", src["output_layernorm"])
    return sd


def backbone_state_dict_from_jax(bb: Mapping, cfg: ModelConfig, prefix: str,
                                 stats: Mapping = None
                                 ) -> Dict[str, torch.Tensor]:
    """A JAX Swin backbone (multimodal 2D or 3D, the hybrid, or the plain
    2D `SwinTransformer`) and its batch statistics (the BN att_norm's) ->
    the port's under `prefix`; the stage norms `norm{i}` the JAX tree has
    (no `norm0` for a plain Swin of stages 2-4)."""
    sd: Dict[str, torch.Tensor] = OrderedDict()
    stats = stats or {}
    swin = cfg.swin
    video = cfg.name == "lavt_video"
    if "absolute_pos_embed" in bb:
        ape = np.asarray(bb["absolute_pos_embed"])
        sd[f"{prefix}absolute_pos_embed"] = _t(
            ape.reshape(1, -1, ape.shape[-1]))
    sd[f"{prefix}patch_embed.proj.weight"] = (_conv3d if video else _conv2d)(
        bb["patch_embed"]["proj"]["kernel"])
    sd[f"{prefix}patch_embed.proj.bias"] = _t(
        bb["patch_embed"]["proj"]["bias"])
    if "norm" in bb["patch_embed"]:
        _norm(sd, f"{prefix}patch_embed.norm", bb["patch_embed"]["norm"])
    # the hybrid video backbone's blocks are 2D (JAX `Hybrid2D3DLayer`:
    # the 2D block names and tables under the video model's prefix)
    index = torch.from_numpy(
        relative_position_index_3d(*swin.window_size_3d)
        if video and not cfg.hybrid_2d_3d
        else relative_position_index_2d(swin.window_size, swin.window_size))
    for i in range(swin.num_layers):
        lt, lp = bb[f"layers_{i}"], f"{prefix}layers.{i}"
        for j in range(swin.depths[i]):
            bt, bp = lt[f"blocks_{j}"], f"{lp}.blocks.{j}"
            _norm(sd, f"{bp}.norm1", bt["norm1"])
            sd[f"{bp}.attn.relative_position_bias_table"] = _t(
                bt["attn"]["relative_position_bias_table"])
            sd[f"{bp}.attn.relative_position_index"] = index.clone()
            _dense(sd, f"{bp}.attn.qkv", bt["attn"]["qkv"])
            _dense(sd, f"{bp}.attn.proj", bt["attn"]["proj"])
            _norm(sd, f"{bp}.norm2", bt["norm2"])
            _dense(sd, f"{bp}.mlp.fc1", bt["mlp"]["fc1"])
            _dense(sd, f"{bp}.mlp.fc2", bt["mlp"]["fc2"])
        fu, fp = lt.get("fusion"), f"{lp}.fusion"
        if fu is not None:
            fstats = stats.get(f"layers_{i}", {}).get("fusion", {})
            for k, v in fusion_state_dict_from_jax(fu, fstats).items():
                sd[f"{fp}.{k}"] = v
        if "res_gate" in lt:
            _dense(sd, f"{lp}.res_gate.0", lt["res_gate"]["fc1"])
            _dense(sd, f"{lp}.res_gate.2", lt["res_gate"]["fc2"])
        if "downsample" in lt:
            _norm(sd, f"{lp}.downsample.norm", lt["downsample"]["norm"])
            _dense(sd, f"{lp}.downsample.reduction",
                   lt["downsample"]["reduction"])
    for i in range(swin.num_layers):
        if f"norm{i}" in bb:
            _norm(sd, f"{prefix}norm{i}", bb[f"norm{i}"])
    return sd


def simple_decoding_state_dict_from_jax(cl: Mapping, cs: Mapping,
                                        prefix: str
                                        ) -> Dict[str, torch.Tensor]:
    """JAX SimpleDecoding -> the reference's names; no third join under
    lazy_pred, `pre_seg` / `seg_last_conv` (JAX's names) where built."""
    sd: Dict[str, torch.Tensor] = OrderedDict()
    for (c1, b1, c2, b2), (ja, jb) in zip(JOINS, _DECODER_JAX):
        for conv, bn, src in ((c1, b1, ja), (c2, b2, jb)):
            if src in cl:
                _conv_bn(sd, f"{prefix}{conv}", f"{prefix}{bn}", cl[src],
                         cs[src])
    for name in ("pre_seg", "seg_last_conv"):
        if name in cl:
            _conv_bn(sd, f"{prefix}{name}.conv", f"{prefix}{name}.bn",
                     cl[name], cs[name])
    sd[f"{prefix}conv1_1.weight"] = _conv2d(cl["head"]["kernel"])
    sd[f"{prefix}conv1_1.bias"] = _t(cl["head"]["bias"])
    return sd


def lts_state_dict_from_jax(cl: Mapping, cs: Mapping, prefix: str
                            ) -> Dict[str, torch.Tensor]:
    """JAX LTSDecoding -> the reference's names (inverse of
    `torch2jax.convert_lts_decoder`)."""
    sd: Dict[str, torch.Tensor] = OrderedDict()
    _dense(sd, f"{prefix}lang_gen.project.0", cl["lang_gen_fc1"])
    _dense(sd, f"{prefix}lang_gen.project.2", cl["lang_gen_fc2"])
    _dense(sd, f"{prefix}lang_proj.0", cl["lang_proj"])
    for name in ("vis_proj", "conv4", "conv3_v", "conv3", "conv2_v"):
        sd[f"{prefix}{name}.0.weight"] = _conv2d(cl[name]["kernel"])
    _dense(sd, f"{prefix}lang_filter", cl["lang_filter"])
    a, sa, ap = cl["aspp"], cs["aspp"], f"{prefix}aspp."
    sd[f"{ap}convs.0.0.weight"] = _conv2d(a["conv1x1"]["kernel"])
    _batch_norm(sd, f"{ap}convs.0.1", a["bn1x1"], sa["bn1x1"])
    for i in range(3):
        _conv_bn(sd, f"{ap}convs.{i + 1}.0", f"{ap}convs.{i + 1}.1",
                 a[f"atrous_{i}"], sa[f"atrous_{i}"])
    _conv_bn(sd, f"{ap}convs.4.1", f"{ap}convs.4.2", a["pool"], sa["pool"])
    sd[f"{ap}project.0.weight"] = _conv2d(a["project"]["kernel"])
    _batch_norm(sd, f"{ap}project.1", a["project_bn"], sa["project_bn"])
    sd[f"{prefix}conv1_1.weight"] = _conv2d(cl["head"]["kernel"])
    sd[f"{prefix}conv1_1.bias"] = _t(cl["head"]["bias"])
    return sd


# (reference Sequential, its conv indices) <- JAX ConvBN names
_VLT_CONV_BN = (("vis_reduce_chann_1", 0, "vis_reduce_1a"),
                ("vis_reduce_chann_1", 3, "vis_reduce_1b"),
                ("vis_reduce_chann_2", 0, "vis_reduce_2"),
                ("fuse_1_2", 0, "fuse_1_2"),
                ("vis_reduce_chann_3", 0, "vis_reduce_3"),
                ("fuse_2_3", 0, "fuse_2_3"),
                ("hallucinate_result_of_23", 0, "hallucinate_a"),
                ("hallucinate_result_of_23", 3, "hallucinate_b"),
                ("project_again", 0, "project_again"),
                ("fuse_again", 0, "fuse_again"),
                ("last_project", 0, "last_project"),
                ("spatial_refine", 0, "spatial_refine"))
_VLT_DECODING = (("conv1_4", "bn1_4", "c4a"), ("conv2_4", "bn2_4", "c4b"),
                 ("conv1_3", "bn1_3", "c3"), ("conv1_2", "bn1_2", "c2"),
                 ("conv1_1", "bn1_1", "c1"))


def _mha(sd, dst: str, src: Mapping) -> None:
    """JAX MHA {q,k,v,out}_proj -> `in_proj_weight` / `in_proj_bias` /
    `out_proj` (nn.MultiheadAttention's names)."""
    names = ("q_proj", "k_proj", "v_proj")
    sd[f"{dst}.in_proj_weight"] = torch.cat(
        [_linear(src[n]["kernel"]) for n in names])
    sd[f"{dst}.in_proj_bias"] = torch.cat([_t(src[n]["bias"]) for n in names])
    _dense(sd, f"{dst}.out_proj", src["out_proj"])


def vlt_state_dict_from_jax(cl: Mapping, cs: Mapping, prefix: str
                            ) -> Dict[str, torch.Tensor]:
    """JAX VLTFuseAndClassify -> the reference's names (inverse of
    `torch2jax.convert_vlt_decoder`)."""
    sd: Dict[str, torch.Tensor] = OrderedDict()
    p = prefix
    for seq, i, src in _VLT_CONV_BN:
        _conv_bn(sd, f"{p}{seq}.{i}", f"{p}{seq}.{i + 1}", cl[src], cs[src])
    _dense(sd, f"{p}lang_proj.0", cl["lang_proj"])
    _batch_norm(sd, f"{p}lang_proj.1", cl["lang_proj_bn"], cs["lang_proj_bn"])
    _batch_norm(sd, f"{p}joint_threshold.0", cl["joint_threshold_bn"],
                cs["joint_threshold_bn"])
    qg, sq, qp = cl["query_generation"], cs["query_generation"], \
        f"{p}query_generation."
    for i in range(3):
        _conv_bn(sd, f"{qp}project_1.{3 * i}", f"{qp}project_1.{3 * i + 1}",
                 qg[f"project_1_{i}"], sq[f"project_1_{i}"])
    sd[f"{qp}project_2.weight"] = _conv2d(qg["project_2"]["kernel"])
    _dense(sd, f"{qp}project_query.0", qg["project_query"], conv1d=True)
    _dense(sd, f"{qp}project_lang.0", qg["project_lang"], conv1d=True)
    _mha(sd, f"{qp}query_gen", qg["query_gen"])
    tf = f"{p}transformer_fusion."
    nlayers = sum(1 for k in cl if k.startswith("enc_"))
    for i in range(nlayers):
        for kind, jax_name, attns, norms in (
                ("encoder", f"enc_{i}", (("self_attn", "self_attn"),),
                 ("norm1", "norm2")),
                ("decoder", f"dec_{i}", (("self_attn", "self_attn"),
                                         ("multihead_attn", "cross_attn")),
                 ("norm1", "norm2", "norm3"))):
            src, dst = cl[jax_name], f"{tf}transformer_{kind}.layers.{i}"
            for torch_name, jname in attns:
                _mha(sd, f"{dst}.{torch_name}", src[jname])
            for lin in ("linear1", "linear2"):
                _dense(sd, f"{dst}.{lin}", src[lin])
            for n in norms:
                _norm(sd, f"{dst}.{n}", src[n])
    qb, qbp = cl["query_balancing"], f"{p}query_balancing."
    for name in ("not_decoded_query_proj", "decoded_query_proj"):
        _dense(sd, f"{qbp}{name}.0", qb[name], conv1d=True)
    _dense(sd, f"{qbp}gate_proj.0", qb["gate_fc1"], conv1d=True)
    _dense(sd, f"{qbp}gate_proj.2", qb["gate_fc2"], conv1d=True)
    _dense(sd, f"{p}q_to_spatial.0", cl["q_to_spatial"], conv1d=True)
    dc, ds = cl["decoding"], cs["decoding"]
    for conv, bn, src in _VLT_DECODING:
        _conv_bn(sd, f"{p}decoding.{conv}", f"{p}decoding.{bn}", dc[src],
                 ds[src])
    _put(sd, f"{p}decoding.classifier", dc["classifier"], _conv2d)
    return sd


_HEADS = {"lts": lts_state_dict_from_jax, "vlt": vlt_state_dict_from_jax,
          "lavt_vlt": vlt_state_dict_from_jax}


def state_dict_from_jax(variables: Mapping, cfg: ModelConfig
                        ) -> Dict[str, torch.Tensor]:
    """JAX variables of any family -> port state_dict (f32 CPU tensors).
    `lavt`'s tree {'model': {backbone, classifier}, 'bert_model'} (JAX
    `LAVTTwo`) maps to the port's `model.` and `bert_model.` names."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    if cfg.name == "lavt":
        sd = bert_state_dict_from_jax(params["bert_model"], cfg,
                                      "bert_model.")
        sd.update(backbone_state_dict_from_jax(
            params["model"]["backbone"], cfg, "model.backbone.",
            stats.get("model", {}).get("backbone")))
        sd.update(simple_decoding_state_dict_from_jax(
            params["model"]["classifier"], stats["model"]["classifier"],
            "model.classifier."))
        return sd
    sd = bert_state_dict_from_jax(params["text_encoder"], cfg,
                                  "text_encoder.")
    sd.update(backbone_state_dict_from_jax(params["backbone"], cfg,
                                           "backbone.",
                                           stats.get("backbone")))
    head = _HEADS.get(cfg.name, simple_decoding_state_dict_from_jax)
    sd.update(head(params["classifier"], stats["classifier"], "classifier."))
    return sd
