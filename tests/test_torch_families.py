"""The port's other model families (lavt, lts, vlt, lavt_vlt) against the
JAX package's, on the CPU, in f32.

Each family is built small in both frameworks (embed 48, depths (1, 1, 2,
1), window 12, 64² input, 2 BERT layers: stages 1-4 all pad, so every
block takes K11's plain version under no_grad).  Weights are carried both
ways:

  * JAX variables drawn from a seeded numpy generator, into the port by
    `convert/from_jax.py` (strict load);
  * the port's state_dict drawn from a seeded numpy generator, into JAX by
    the reference converters `torch2jax.convert_lavt_two` /
    `convert_lts` / `convert_vlt`, whose tree must equal the JAX model's
    own (so the port's names are the reference's, and no stage norm is
    invented: lts and vlt have no `norm0`).

Logits are held to JAX's within 1e-4 abs + 1e-4 rel.  Also: lavt's
segmentation net on external language features, its two-dict
state_dict, the LTS decoder's resizes, the VLT head's attention and
layers against the torch modules the reference composes, the seeded
init, the weight-import flags against JAX's, and the f32 guard on each
family's plan.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as tnn
import torch.nn.functional as F

from lavt_rs_tpu.config import BertConfig as JBertConfig
from lavt_rs_tpu.config import ModelConfig as JModelConfig
from lavt_rs_tpu.config import SwinConfig as JSwinConfig
from lavt_rs_tpu.convert import torch2jax
from lavt_rs_tpu.models.factory import build_model as jbuild_model
from lavt_rs_tpu.models.lavt import LAVT as JLAVT
from lavt_rs_tpu.ops.resize import resize_2d
from lavt_rs_tpu_torch import config as C
from lavt_rs_tpu_torch.convert.from_jax import state_dict_from_jax
from lavt_rs_tpu_torch.models import vlt
from lavt_rs_tpu_torch.models.factory import build_model
from lavt_rs_tpu_torch.ops.resize import resize_nchw
from test_torch_model import BERT, SWIN, random_variables
from torch_threads import torch_threads  # noqa: F401 (autouse fixture)

FAMILIES = ("lavt", "lts", "vlt", "lavt_vlt")
IMG, TOKENS = 64, 6
TOL = 1e-4


def configs(name, **kw):
    """(JAX config, port config) of the small `name` model."""
    jcfg = JModelConfig(name=name, swin=JSwinConfig(**SWIN),
                        bert=JBertConfig(**BERT), img_size=IMG,
                        max_tokens=TOKENS, **kw)
    cfg = C.ModelConfig(name=name, swin=C.SwinConfig(**SWIN),
                        bert=C.BertConfig(**BERT), img_size=IMG,
                        max_tokens=TOKENS, dtype="float32")
    return jcfg, cfg


def jax_shapes(jm):
    img = jnp.zeros((1, IMG, IMG, 3))
    ids = jnp.ones((1, TOKENS), jnp.int32)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), img, ids,
                                            ids))
    return {k: shapes[k] for k in ("params", "batch_stats")}


def random_state_dict(model, rng):
    """Seeded values for every floating tensor of the port's state_dict
    (the scheme of `random_variables`); the index buffers kept."""
    out = {}
    for name, t in model.state_dict().items():
        if not t.is_floating_point():
            out[name] = t.clone()
            continue
        shape = tuple(t.shape)
        normal = rng.standard_normal(shape)
        if name.endswith("running_var"):
            v = 1.0 + 0.5 * rng.random(shape)
        elif name.endswith(("relative_position_bias_table", "_embeddings.weight")):
            v = 0.5 * normal
        elif t.dim() >= 2:
            v = normal * float(np.prod(shape[1:])) ** -0.5
        elif name.endswith(".weight"):
            v = 1.0 + 0.1 * normal
        else:  # biases, running_mean
            v = 0.1 * normal
        out[name] = torch.from_numpy(v.astype(np.float32))
    return out


def to_jax(name, sd, jcfg):
    """The port's state_dict -> JAX variables by the reference converters."""
    np_sd = {k: v.numpy() for k, v in sd.items()}
    if name == "lavt":
        split = {p: {k[len(p) + 1:]: v for k, v in np_sd.items()
                     if k.startswith(p + ".")}
                 for p in ("model", "bert_model")}
        return torch2jax.convert_lavt_two(split["model"], split["bert_model"],
                                          jcfg)
    if name == "lts":
        return torch2jax.convert_lts(np_sd, jcfg)
    return torch2jax.convert_vlt(np_sd, jcfg)


def tree_shapes(t, prefix=()):
    out = {}
    for k, v in t.items():
        if isinstance(v, dict):
            out.update(tree_shapes(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = tuple(v.shape)
    return out


def inputs(rng, b=2):
    img = rng.standard_normal((b, IMG, IMG, 3)).astype(np.float32)
    ids = rng.integers(1, 120, (b, TOKENS)).astype(np.int64)
    mask = np.ones((b, TOKENS), np.int64)
    mask[0, 4:] = 0
    return img, ids, mask


def port_logits(pm, arrays):
    with torch.no_grad():
        return pm(*(torch.from_numpy(a) for a in arrays)).numpy()


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    name = request.param
    jcfg, cfg = configs(name)
    jm = jbuild_model(jcfg)
    return name, jcfg, cfg, jm, jax.jit(jm.apply), jax_shapes(jm)


def test_logits_from_jax_variables(family):
    """JAX's variables carried into the port by from_jax."""
    name, _, cfg, _, apply, shapes = family
    variables = random_variables(shapes, np.random.default_rng(7))
    pm = build_model(cfg, device="cpu")
    pm.load_state_dict(state_dict_from_jax(variables, cfg), strict=True)
    arrays = inputs(np.random.default_rng(1))
    want = np.asarray(apply(variables, *arrays))
    got = port_logits(pm, arrays)
    assert got.shape == (2, IMG, IMG, 2) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL, err_msg=name)


def test_logits_through_reference_converters(family):
    """The port's weights carried into JAX by torch2jax: the tree is the
    JAX model's own, and the logits agree."""
    name, jcfg, cfg, _, apply, shapes = family
    pm = build_model(cfg, device="cpu")
    pm.load_state_dict(random_state_dict(pm, np.random.default_rng(11)))
    variables = to_jax(name, pm.state_dict(), jcfg)
    for part in ("params", "batch_stats"):
        assert tree_shapes(variables[part]) == tree_shapes(shapes[part])
    arrays = inputs(np.random.default_rng(2))
    want = np.asarray(apply(variables, *arrays))
    got = port_logits(pm, arrays)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL, err_msg=name)


def test_stage_norms_of_each_family():
    """lavt's multimodal Swin has norm0-norm3; the lts / vlt / lavt_vlt
    backbones (stages 2-4) norm1-norm3 and no norm0."""
    for name in FAMILIES:
        pm = build_model(configs(name)[1], device="meta")
        norms = sorted({k.split(".")[-2] for k in pm.state_dict()
                        if ".backbone.norm" in "." + k})
        assert norms == (["norm0", "norm1", "norm2", "norm3"]
                         if name == "lavt" else ["norm1", "norm2", "norm3"]), \
            (name, norms)


def test_lavt_two_dicts_and_external_language_features():
    """LAVTTwo's state_dict splits into the reference's {'model',
    'bert_model'}, and its `model` is LAVT on precomputed l_feats (JAX
    `LAVT`)."""
    jcfg, cfg = configs("lavt")
    pm = build_model(cfg, device="cpu")
    pm.load_state_dict(random_state_dict(pm, np.random.default_rng(13)))
    tops = {k.split(".")[0] for k in pm.state_dict()}
    assert tops == {"model", "bert_model"}
    assert {k.split(".")[1] for k in pm.state_dict()
            if k.startswith("model.")} == {"backbone", "classifier"}
    assert pm.backbone is pm.model.backbone
    variables = to_jax("lavt", pm.state_dict(), jcfg)
    rng = np.random.default_rng(3)
    img, _, mask = inputs(rng)
    l_feats = rng.standard_normal((2, TOKENS, 768)).astype(np.float32)
    jlavt = JLAVT(jcfg)
    want = np.asarray(jax.jit(jlavt.apply)(
        {"params": variables["params"]["model"],
         "batch_stats": variables["batch_stats"]["model"]},
        img, l_feats, mask))
    with torch.no_grad():
        got = pm.model(*(torch.from_numpy(a) for a in (img, l_feats, mask)))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("hw,out", [((4, 4), (8, 8)), ((6, 5), (12, 10)),
                                    ((3, 7), (16, 9)), ((8, 8), (8, 8))])
def test_resize_forms_match_jax(hw, out, align_corners):
    """The port's bilinear resize against JAX `resize_2d` (f32): the
    corner-aligned form of every join, and the half-pixel form of the LTS
    decoder's last 2x upsample."""
    x = np.random.default_rng(5).standard_normal((2, *hw, 3)).astype(np.float32)
    want = np.asarray(resize_2d(jnp.asarray(x), out,
                                align_corners=align_corners))
    got = resize_nchw(torch.from_numpy(x).permute(0, 3, 1, 2), out,
                      align_corners=align_corners).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def _copy_mha(ours, ref):
    with torch.no_grad():
        ref.in_proj_weight.copy_(ours.in_proj_weight)
        ref.in_proj_bias.copy_(ours.in_proj_bias)
        ref.out_proj.weight.copy_(ours.out_proj.weight)
        ref.out_proj.bias.copy_(ours.out_proj.bias)


def test_vlt_attention_and_layers_against_torch_modules():
    """The VLT head's attention and layers load the state dicts of the
    torch modules the reference composes (nn.MultiheadAttention,
    nn.TransformerEncoderLayer / DecoderLayer at dropout 0, seq-first) and
    give their outputs; eval mode (torch's fused fast path where it takes
    one) and train mode alike."""
    torch.manual_seed(0)
    dim, heads, b = 32, 8, 2
    q = torch.randn(b, 5, dim)
    kv = torch.randn(b, 9, dim)
    pad = torch.zeros(b, 9, dtype=torch.bool)
    pad[1, 6:] = True
    ours = vlt.MultiheadAttention(dim, heads)
    ref = tnn.MultiheadAttention(dim, heads)
    ref.load_state_dict(ours.state_dict())
    enc = vlt.TransformerEncoderLayer(dim, heads, 48)
    ref_enc = tnn.TransformerEncoderLayer(dim, heads, 48, dropout=0.0)
    ref_enc.load_state_dict(enc.state_dict())
    dec = vlt.TransformerDecoderLayer(dim, heads, 48)
    ref_dec = tnn.TransformerDecoderLayer(dim, heads, 48, dropout=0.0)
    ref_dec.load_state_dict(dec.state_dict())
    sf = lambda t: t.transpose(0, 1)  # noqa: E731 (seq-first)
    for train in (False, True):
        for m in (ref, ref_enc, ref_dec):
            m.train(train)
        with torch.no_grad():
            torch.testing.assert_close(
                ours(q, kv, kv, key_padding_mask=pad),
                sf(ref(sf(q), sf(kv), sf(kv), key_padding_mask=pad)[0]),
                rtol=2e-5, atol=2e-5)
            torch.testing.assert_close(enc(kv), sf(ref_enc(sf(kv))),
                                       rtol=2e-5, atol=2e-5)
            torch.testing.assert_close(dec(q, kv), sf(ref_dec(sf(q), sf(kv))),
                                       rtol=2e-5, atol=2e-5)


def test_vlt_positional_encoding_and_coords():
    """The interleaved sin / cos encoding as the reference's formula, and
    the query generator's coordinate channels [x, x, x, y, y, y]."""
    import math

    n, d = 22, 64
    pe = torch.zeros(n, d)
    pos = torch.arange(0, n, dtype=torch.float).unsqueeze(1)
    div = torch.exp(torch.arange(0, d, 2).float() * (-math.log(10000.0) / d))
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    torch.testing.assert_close(vlt.positional_encoding(n, d, pe), pe,
                               rtol=1e-6, atol=1e-6)
    qg = vlt.QueryGenerationModule(4, 8, 2, 9, 6)
    seen = {}
    qg.project_1.register_forward_hook(
        lambda m, a, o: seen.update(x=a[0]))
    with torch.no_grad():
        qg(torch.zeros(1, 4, 3, 3), torch.zeros(1, 2, 6),
           torch.ones(1, 2, dtype=torch.long))
    coords = seen["x"][0, 4:]
    lin = torch.tensor([-1.0, 0.0, 1.0])
    for i in range(3):
        torch.testing.assert_close(coords[i], lin[None, :].expand(3, 3))
        torch.testing.assert_close(coords[3 + i], lin[:, None].expand(3, 3))


def test_seeded_build_draws_every_tensor():
    """With a generator every parameter of the new heads is drawn (no
    torch default init left): two seeds differ everywhere a weight is
    random, the same seed gives the same bits, and the VLT head's
    BatchNorm1d starts at mean 0 / var 1."""
    for name in ("lts", "vlt"):
        cfg = configs(name)[1]
        a, b, c = (build_model(cfg, "cpu", torch.Generator().manual_seed(s))
                   .state_dict() for s in (0, 0, 1))
        for k, v in a.items():
            torch.testing.assert_close(b[k], v, rtol=0, atol=0)
        for k in ("classifier.query_generation.query_gen.in_proj_weight",
                  "classifier.transformer_fusion.transformer_encoder."
                  "layers.0.self_attn.in_proj_weight"):
            if k in a:
                assert not torch.equal(a[k], c[k]), k
                std = float(a[k].std())
                assert abs(std - a[k].shape[1] ** -0.5) < 0.2 * std, (k, std)
        if name == "vlt":
            assert not a["classifier.query_generation.query_gen."
                         "in_proj_bias"].any()
            assert torch.equal(a["classifier.lang_proj.1.running_var"],
                               torch.ones(8 * SWIN["embed_dim"]))


@pytest.mark.parametrize("name", ["lavt", "lts"])
def test_pretrained_flags_match_jax(name, tmp_path):
    """--pretrained_swin_weights (an ImageNet Swin, window 7 -> 12) and
    --ck_bert (an HF dump: `bert.` prefix, pooler) land where the JAX
    package's `apply_pretrained_flags` puts them, bitwise: lavt's
    segmentation net `model.backbone.` and its `bert_model.`; the plain
    Swin of lts (no fusion weights, no stage norm made up from the file's
    final `norm`) and its `text_encoder.`."""
    from lavt_rs_tpu.convert.pretrained import \
        apply_pretrained_flags as japply_flags
    from lavt_rs_tpu_torch.convert import pretrained
    from test_torch_pretrained import (flags, flat, imagenet_swin,
                                       port_config, save)

    jcfg, cfg = configs(name)
    jvars = random_variables(jax_shapes(jbuild_model(jcfg)),
                             np.random.default_rng(17))
    pm = build_model(cfg, device="cpu")
    pm.load_state_dict(state_dict_from_jax(jvars, cfg), strict=True)
    swin = save(tmp_path, "swin_base_patch4_window7_224.pth",
                imagenet_swin(port_config(False, window=7), 21))
    bert_src = build_model(configs("lts")[1], "cpu",
                           torch.Generator().manual_seed(5)).state_dict()
    bert = {"bert." + k.removeprefix("text_encoder."): v
            for k, v in bert_src.items() if k.startswith("text_encoder.")}
    bert["bert.pooler.dense.weight"] = torch.zeros(768, 768)
    path = save(tmp_path, "bert.bin", bert, wrap=None)
    args = flags(pretrained_swin_weights=swin, ck_bert=path)
    records = pretrained.apply_pretrained_flags(pm, cfg, args)
    want = flat(japply_flags(jvars, jcfg, args))
    got = flat(to_jax(name, pm.state_dict(), jcfg))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    swin_rec, bert_rec = records
    prefix = "model.backbone." if name == "lavt" else "backbone."
    assert swin_rec["loaded"] and all(k.startswith(prefix)
                                      for k in swin_rec["loaded"])
    assert not any(k[len(prefix):].startswith("norm")  # no stage norm
                   for k in swin_rec["loaded"])
    bert = "bert_model." if name == "lavt" else "text_encoder."
    assert bert_rec["loaded"] and all(k.startswith(bert)
                                      for k in bert_rec["loaded"])


def test_full_checkpoint_through_the_swin_flag(tmp_path):
    """A full lts checkpoint passed as --pretrained_swin_weights loads whole
    into the port (its text encoder, plain Swin and LTS head).  The JAX
    package converts every full 2D checkpoint with `convert_lavt_one`,
    whose decoder map knows SimpleDecoding's names only: of the LTS head it
    loads the last conv (`conv1_1`, SimpleDecoding's name too) and leaves
    the rest at its init (ROADMAP.md §3, a known difference)."""
    from lavt_rs_tpu.convert.pretrained import \
        apply_pretrained_flags as japply_flags
    from lavt_rs_tpu_torch.convert import pretrained
    from test_torch_pretrained import flags, save

    jcfg, cfg = configs("lts")
    src = build_model(cfg, "cpu")
    src.load_state_dict(random_state_dict(src, np.random.default_rng(19)))
    want = src.state_dict()
    path = save(tmp_path, "lts_full.pth", want)
    jvars = random_variables(jax_shapes(jbuild_model(jcfg)),
                             np.random.default_rng(17))
    pm = build_model(cfg, "cpu")
    pm.load_state_dict(state_dict_from_jax(jvars, cfg))
    init = {k: v.clone() for k, v in pm.state_dict().items()}
    (rec,) = pretrained.apply_pretrained_flags(
        pm, cfg, flags(pretrained_swin_weights=path))
    assert rec["flag"] == "--pretrained_swin_weights (full checkpoint)"
    for k, v in want.items():
        torch.testing.assert_close(pm.state_dict()[k], v, rtol=0, atol=0)
    jax_sd = state_dict_from_jax(
        jax.device_get(japply_flags(jvars, jcfg, flags(
            pretrained_swin_weights=path))), cfg)
    for k, v in jax_sd.items():
        if k.startswith("classifier.") and not k.startswith(
                "classifier.conv1_1."):
            torch.testing.assert_close(v, init[k], rtol=0, atol=0)
        elif v.is_floating_point():
            torch.testing.assert_close(v, want[k], rtol=0, atol=0)


@pytest.mark.parametrize("name", FAMILIES)
def test_f32_guard_finds_each_familys_backbone(monkeypatch, name):
    """`kernels_without_variant` plans each family's Swin-B window-12
    backbone where it is (lavt's under `model.`): [] with every f32
    variant, and with K5's taken away the training plan names K5 (as
    lavt_one's, test_torch_f32_kernels.py) and `build_model` refuses
    before any allocation."""
    from lavt_rs_tpu_torch.models import factory

    cfg = factory.make_config(name, "base", dtype="float32")
    assert factory.kernels_without_variant(cfg, True) == []
    monkeypatch.setattr(factory, "F32_KERNELS",
                        factory.F32_KERNELS - {"K5"})
    assert factory.kernels_without_variant(cfg, True) == ["K5"]
    assert factory.kernels_without_variant(cfg, False) == []
    with pytest.raises(NotImplementedError, match="K5"):
        build_model(cfg, device="cuda", train=True)
