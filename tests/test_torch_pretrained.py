"""The port's weight-import flags (`convert/pretrained.py`) against the JAX
package's `apply_pretrained_flags`, on the CPU.

A small lavt_one (embed 48, depths (1, 1, 2, 1), window 12, 2 BERT
layers) and a small lavt_video (embed 32, depths (2, 2, 2, 2), window
(8, 7, 7), 1 BERT layer) start from the same seeded JAX variables in both
packages (`convert/from_jax.py`); each flag then loads a .pth written by
the test, in both.  The port's state_dict, mapped by the JAX package's
`convert_lavt_one` / `convert_lavt_video`, must equal the JAX variables
bitwise, leaf for leaf: the same tensors loaded, the same reshaping (the
bicubic 7 -> 12 tables, the 2D -> 3D inflation, the Kinetics patch-embed
sum), the rest at its init.  Also: the refusals, the train CLI with a
flag, and F5's help string.  The hybrid video model's flag,
--pretrained2d_lavt_weights, is tests/test_torch_hybrid.py's.
"""

import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lavt_rs_tpu import config as JC
from lavt_rs_tpu.convert import torch2jax as t2j
from lavt_rs_tpu.convert.pretrained import \
    apply_pretrained_flags as japply_flags
from lavt_rs_tpu.models.factory import build_model as jbuild_model
from lavt_rs_tpu_torch import config as C
from lavt_rs_tpu_torch.cli import args as cli_args
from lavt_rs_tpu_torch.cli import train as cli_train
from lavt_rs_tpu_torch.convert import pretrained
from lavt_rs_tpu_torch.convert.from_jax import state_dict_from_jax
from lavt_rs_tpu_torch.models.factory import build_model
from test_torch_model import random_variables
from torch_threads import torch_threads  # noqa: F401 (autouse fixture)

SWIN_2D = dict(embed_dim=48, depths=(1, 1, 2, 1), num_heads=(3, 6, 12, 24))
SWIN_3D = dict(embed_dim=32, depths=(2, 2, 2, 2), num_heads=(1, 2, 4, 8))
BERT_2D = dict(vocab_size=120, num_layers=2, intermediate_size=256,
               max_position_embeddings=64)
BERT_3D = dict(BERT_2D, num_layers=1)
IMG, TOKENS, T = 64, 6, 4
FLAGS = ("pretrained_swin_weights", "ck_bert", "pretrained2d_lavt_weights",
         "pretrained2d_lavt_weights_for_a_3d_model",
         "pretrained_video_lavt_weights_on_refcocos")


def flags(**kw):
    ns = argparse.Namespace(**{f: "" for f in FLAGS})
    for k, v in kw.items():
        setattr(ns, k, v)
    return ns


def port_config(video, window=12, **kw):
    if video:
        return C.lavt_video_tiny().replace(
            swin=C.SwinConfig(**SWIN_3D, window_size=7, drop_path_rate=0.1),
            bert=C.BertConfig(**BERT_3D), img_size=IMG, max_tokens=TOKENS,
            num_frames=T, dtype="float32", **kw)
    return C.ModelConfig(swin=C.SwinConfig(**SWIN_2D, window_size=window),
                         bert=C.BertConfig(**BERT_2D), img_size=IMG,
                         max_tokens=TOKENS, dtype="float32", **kw)


def jax_config(video):
    if video:
        return JC.lavt_video_tiny().replace(
            swin=JC.SwinConfig(**SWIN_3D, window_size=7, drop_path_rate=0.1),
            bert=JC.BertConfig(**BERT_3D), img_size=IMG, max_tokens=TOKENS,
            num_frames=T)
    return JC.ModelConfig(name="lavt_one", swin=JC.SwinConfig(**SWIN_2D,
                                                              window_size=12),
                          bert=JC.BertConfig(**BERT_2D), img_size=IMG,
                          max_tokens=TOKENS)


def jax_variables(jcfg, video):
    jm = jbuild_model(jcfg)
    img = jnp.zeros((1, T, IMG, IMG, 3) if video else (1, IMG, IMG, 3))
    ids = jnp.ones((1, TOKENS), jnp.int32)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), img, ids,
                                            ids))
    shapes = {k: shapes[k] for k in ("params", "batch_stats")}
    return random_variables(shapes, np.random.default_rng(11))


@pytest.fixture(scope="module", params=[False, True], ids=["2d", "3d"])
def start(request):
    """(video, JAX config, the seeded JAX variables)."""
    video = request.param
    jcfg = jax_config(video)
    return video, jcfg, jax_variables(jcfg, video)


def port_model(video, variables):
    cfg = port_config(video)
    m = build_model(cfg, "cpu", train=True)
    m.load_state_dict(state_dict_from_jax(variables, cfg), strict=True)
    return m


def random_port_state(cfg, seed):
    """A reference-named state dict drawn by the port's seeded init, with
    the gates and BatchNorm statistics made non-trivial."""
    m = build_model(cfg, "cpu", generator=torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    sd = m.state_dict()
    for k, v in sd.items():
        if "res_gate" in k or "running_" in k:
            v.copy_(v + 0.1 * torch.rand(v.shape, generator=g))
    return sd


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


def assert_port_equals_jax(pm, jcfg, jvars, video):
    sd = {k: v.detach().numpy() for k, v in pm.state_dict().items()}
    convert = t2j.convert_lavt_video if video else t2j.convert_lavt_one
    got, want = flat(convert(sd, jcfg)), flat(jax.device_get(jvars))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def imagenet_swin(cfg, seed):
    """A backbone-only ImageNet-format Swin (no prefix, a final `norm`, a
    classification head, the index and attn_mask buffers) at cfg's widths
    and window."""
    sd = random_port_state(cfg, seed)
    out = {k[len("backbone."):]: v for k, v in sd.items()
           if k.startswith("backbone.") and ".fusion." not in k
           and "res_gate" not in k and not k.startswith("backbone.norm")}
    c = cfg.swin.num_features[-1]
    out.update({"norm.weight": torch.ones(c), "norm.bias": torch.zeros(c),
                "head.weight": torch.randn(10, c), "head.bias": torch.zeros(10),
                "layers.0.blocks.0.attn_mask": torch.zeros(4, 49, 49)})
    return out


def kinetics_swin(cfg, seed, kd=2):
    """A Kinetics Video-Swin backbone (mmaction format: `backbone.` on every
    key, a patch embedding of temporal depth kd)."""
    out = imagenet_swin(cfg, seed)
    w = out["patch_embed.proj.weight"]
    out["patch_embed.proj.weight"] = torch.randn(
        w.shape[:2] + (kd,) + w.shape[3:], generator=torch.Generator(
        ).manual_seed(seed)) * 0.1
    return {"backbone." + k: v for k, v in out.items()}


def save(tmp_path, name, sd, wrap="model"):
    path = tmp_path / name
    torch.save({wrap: sd} if wrap else sd, path)
    return str(path)


def run_both(start, args):
    video, jcfg, jvars = start
    pm = port_model(video, jvars)
    records = pretrained.apply_pretrained_flags(pm, pm.cfg, args)
    jmerged = japply_flags(jvars, jcfg, args)
    assert_port_equals_jax(pm, jcfg, jmerged, video)
    assert records and all(r["loaded"] for r in records)
    return pm, records


def test_backbone_only_swin(start, tmp_path):
    """--pretrained_swin_weights: ImageNet Swin window 7 into the window-12
    lavt_one (tables bicubic 7 -> 12), Kinetics Video-Swin into
    lavt_video (patch embedding summed over its depth 2)."""
    video = start[0]
    if video:
        sd = kinetics_swin(port_config(True), 21)
        path = save(tmp_path, "swin_tiny_patch244_window877_kinetics.pth", sd,
                    wrap="state_dict")
    else:
        sd = {"module." + k: v
              for k, v in imagenet_swin(port_config(False, window=7),
                                        21).items()}
        path = save(tmp_path, "swin_base_patch4_window7_224.pth", sd)
    pm, (rec,) = run_both(start, flags(pretrained_swin_weights=path))
    assert rec["flag"] == "--pretrained_swin_weights (backbone only)"
    skipped = " ".join(rec["skipped"])
    for name in ("head.weight", "backbone.norm.weight",
                 "relative_position_index", "attn_mask"):
        assert name in skipped, name
    table = "layers.2.blocks.1.attn.relative_position_bias_table"
    got = pm.state_dict()["backbone." + table]
    if video:
        torch.testing.assert_close(got, sd["backbone." + table], rtol=0,
                                   atol=0)
        pe = pm.state_dict()["backbone.patch_embed.proj.weight"]
        torch.testing.assert_close(
            pe, sd["backbone.patch_embed.proj.weight"].sum(2, keepdim=True),
            rtol=0, atol=0)
    else:
        assert got.shape == (23 * 23, 12)
        torch.testing.assert_close(
            got, pretrained.interpolate_rel_pos_bias(sd["module." + table],
                                                     (12, 12)),
            rtol=0, atol=0)


def test_full_checkpoint_through_the_swin_flag(start, tmp_path):
    """A full checkpoint passed as --pretrained_swin_weights loads whole
    (lavt_one window 7 into window 12: tables resized; lavt_video as is)."""
    video = start[0]
    sd = random_port_state(port_config(video, window=7), 22)
    path = save(tmp_path, "lavt_full.pth",
                {"module." + k: v for k, v in sd.items()})
    _, (rec,) = run_both(start, flags(pretrained_swin_weights=path))
    assert rec["flag"] == "--pretrained_swin_weights (full checkpoint)"
    assert any(k.startswith("classifier.") for k in rec["loaded"])
    assert any(k.startswith("text_encoder.") for k in rec["loaded"])


def test_ck_bert(start, tmp_path):
    """--ck_bert: an HF dump with a uniform `bert.` prefix and a pooler."""
    video = start[0]
    sd = random_port_state(port_config(video), 23)
    bert = {"bert." + k[len("text_encoder."):]: v for k, v in sd.items()
            if k.startswith("text_encoder.")}
    bert["bert.pooler.dense.weight"] = torch.zeros(768, 768)
    bert["bert.pooler.dense.bias"] = torch.zeros(768)
    path = save(tmp_path, "bert.bin", bert, wrap=None)
    _, (rec,) = run_both(start, flags(ck_bert=path))
    assert rec["flag"] == "--ck_bert"
    assert all(k.startswith("text_encoder.") for k in rec["loaded"])
    assert not any("pooler" in k for k in rec["loaded"] + rec["skipped"])


def test_video_flags(start, tmp_path):
    """--pretrained2d_lavt_weights_for_a_3d_model (a window-12 lavt_one
    checkpoint inflated into the 3D backbone, its fusion dropped) and
    --pretrained_video_lavt_weights_on_refcocos; both raise on lavt_one."""
    video = start[0]
    two_d = save(tmp_path, "lavt_one.pth", random_port_state(
        C.ModelConfig(swin=C.SwinConfig(**SWIN_3D, window_size=12),
                      bert=C.BertConfig(**BERT_3D), dtype="float32"), 24))
    vid = save(tmp_path, "lavt_video.pth",
               random_port_state(port_config(True), 25))
    if not video:
        for flag, path in (("pretrained2d_lavt_weights_for_a_3d_model", two_d),
                           ("pretrained_video_lavt_weights_on_refcocos", vid)):
            pm = port_model(False, start[2])
            with pytest.raises(ValueError, match="needs --model lavt_video"):
                pretrained.apply_pretrained_flags(pm, pm.cfg,
                                                  flags(**{flag: path}))
        return
    pm, (rec,) = run_both(start, flags(
        pretrained2d_lavt_weights_for_a_3d_model=two_d))
    assert not any(".fusion." in k for k in rec["loaded"])
    assert pm.state_dict()["backbone.patch_embed.proj.weight"].shape[2] == 1
    table = pm.state_dict()[
        "backbone.layers.0.blocks.0.attn.relative_position_bias_table"]
    assert table.shape == (15 * 13 * 13, 1)
    _, (rec,) = run_both(start, flags(
        pretrained_video_lavt_weights_on_refcocos=vid))
    assert any(".fusion." in k for k in rec["loaded"])


def test_refusals(start, tmp_path):
    """A Swin of other widths matches nothing and raises ValueError in both
    packages; so does --pretrained2d_lavt_weights into a model that is not
    the hybrid video model (tests/test_torch_hybrid.py loads it into one)."""
    video, jcfg, jvars = start
    other = dataclasses.replace(port_config(video).swin, embed_dim=64,
                                num_heads=(2, 4, 8, 16))
    cfg = port_config(video).replace(swin=other)
    sd = kinetics_swin(cfg, 27) if video else imagenet_swin(cfg, 27)
    path = save(tmp_path, "other.pth", sd)
    pm = port_model(video, jvars)
    args = flags(pretrained_swin_weights=path)
    with pytest.raises(ValueError, match="no tensors matched"):
        pretrained.apply_pretrained_flags(pm, pm.cfg, args)
    with pytest.raises(ValueError, match="no tensors matched"):
        japply_flags(jvars, jcfg, args)
    hybrid_flag = flags(pretrained2d_lavt_weights=path)
    with pytest.raises(ValueError, match="hybrid 2D-Swin video models"):
        pretrained.apply_pretrained_flags(pm, pm.cfg, hybrid_flag)
    with pytest.raises(ValueError, match="hybrid 2D-Swin video models"):
        japply_flags(jvars, jcfg, hybrid_flag)
    # an HF model id (not a local file) is not a --ck_bert file
    assert pretrained.apply_pretrained_flags(
        pm, pm.cfg, flags(ck_bert="bert-base-uncased")) == []


@pytest.mark.parametrize("rel,window", [(7, 12), (12, 7), (7, 7)])
def test_interpolate_rel_pos_bias_matches_jax(rel, window):
    rng = np.random.default_rng(rel + window)
    table = rng.standard_normal(((2 * rel - 1) ** 2, 5)).astype(np.float32)
    got = pretrained.interpolate_rel_pos_bias(torch.from_numpy(table),
                                              (window, window))
    np.testing.assert_array_equal(
        got.numpy(), t2j.interpolate_rel_pos_bias(table, (window, window)))
    got = pretrained.inflate_rel_pos_table_2d_to_3d(torch.from_numpy(table),
                                                    (8, window, window))
    np.testing.assert_array_equal(got.numpy(), t2j.inflate_rel_pos_table_2d_to_3d(
        table, (8, window, window)))
    w = rng.standard_normal((6, 3, 4, 4)).astype(np.float32)
    for pt in (1, 2):
        np.testing.assert_array_equal(
            pretrained.inflate_patch_embed_2d_to_3d(torch.from_numpy(w),
                                                    pt).numpy(),
            t2j.inflate_patch_embed_2d_to_3d(w, pt))


def test_train_cli_applies_the_flag(tmp_path, monkeypatch, capsys):
    """cli.train --synthetic with --pretrained_swin_weights on a full
    checkpoint: the flag's summary is printed and training runs."""
    real = cli_args.model_config_from_args

    def shrunk(args):
        return real(args).replace(
            swin=C.SwinConfig(embed_dim=16, depths=(1, 1, 1, 1),
                              num_heads=(1, 2, 4, 8), window_size=4,
                              drop_path_rate=0.0),
            bert=dataclasses.replace(C.BertConfig(), num_layers=1,
                                     vocab_size=120), img_size=32)

    monkeypatch.setattr(cli_train, "model_config_from_args", shrunk)
    base = ["--synthetic", "--synthetic_steps", "1", "-b", "1", "--img_size",
            "32", "--no_bf16", "--device", "cpu", "--output-dir", "",
            "--epochs", "1"]
    cfg = shrunk(cli_train.get_parser().parse_args(base))
    path = save(tmp_path, "full.pth", random_port_state(cfg, 26))
    rec = cli_train.main(base + ["--pretrained_swin_weights", path])
    assert rec["epoch"] == 0
    err = capsys.readouterr().err
    assert "[--pretrained_swin_weights (full checkpoint)] loaded" in err


def test_use_checkpoint_help_names_both_backbones():
    """F5: --use_checkpoint's help says what the flag does since the 2D
    blocks are recomputed too."""
    text = " ".join(cli_train.get_parser().format_help().split())
    assert ("both backbones (lavt_one's 2D Swin, lavt_video's 3D Swin) "
            "recompute each Swin block in the backward") in text
    assert "lavt_video's last stage skips its language gate" in text
    assert "ignore it" not in text
