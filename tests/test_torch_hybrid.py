"""The port's hybrid 2D-Swin video model (`swin3d.Hybrid2D3DLayer`,
--ytvos_2d_swin_3d_pwam and --ytvos_2d_swin_pwam) and its weight-import
flag (--pretrained2d_lavt_weights) against the JAX package's, on the CPU.

A small hybrid lavt_video (the Swin of tests/test_torch_video.py: embed
32, depths (2, 2, 2, 2), heads (1, 2, 4, 8), 2D window 7; 4-frame 32²
clips and 1 BERT layer, the sizes of JAX tests/test_video.py:271-330) is
built in both frameworks for the 3D SepTPWAM fusion and for the 2D PWAM;
every JAX variable is drawn from a seeded numpy generator and carried into
the port by `convert/from_jax.py`.  Everything runs in f32, the port on
its plain versions.  Tolerances as tests/test_torch_video.py (logits
rtol 1e-3 / atol 2e-4 and argmax agreement) and
tests/test_torch_video_train.py (one train step with DropPath and dropout
0: loss 1e-4 relative; each gradient ‖got − want‖ ≤ 1e-2 ‖want‖ + 1e-4 G
√n); the port's --use_checkpoint step is held to the same JAX gradients,
which remat does not change.  The weight import is compared leaf for
leaf, bitwise, in the port's names.
"""

import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lavt_rs_tpu import config as JC
from lavt_rs_tpu.convert.pretrained import \
    apply_pretrained_flags as japply_flags
from lavt_rs_tpu.models.factory import build_model as jbuild_model
from lavt_rs_tpu.train import optim as joptim
from lavt_rs_tpu.train.step import TrainState
from lavt_rs_tpu.train.step import make_video_train_step as jmake_video_step
from lavt_rs_tpu_torch import config as C
from lavt_rs_tpu_torch.convert import pretrained
from lavt_rs_tpu_torch.convert.from_jax import state_dict_from_jax
from lavt_rs_tpu_torch.models import swin2d, swin3d
from lavt_rs_tpu_torch.models.factory import (build_model,
                                              kernels_without_variant)
from lavt_rs_tpu_torch.models.lavt import LAVTVideo
from lavt_rs_tpu_torch.train import optim
from lavt_rs_tpu_torch.train.step import (create_train_state,
                                          make_video_train_step)
from test_torch_model import random_variables
from test_torch_train import _close, _grads_as_state
from test_torch_video import SWIN
from torch_threads import torch_threads  # noqa: F401 (autouse fixture)

T, IMG, TOKENS, B = 4, 32, 6, 2
VALID = (1, 3)
BERT = dict(vocab_size=120, num_layers=1, intermediate_size=256,
            max_position_embeddings=64, hidden_dropout=0.0, attn_dropout=0.0)
KINDS = {"sep": "SEP", "pwam2d": "PWAM2D"}


def jax_config(kind, **kw):
    return JC.lavt_video_tiny().replace(
        swin=JC.SwinConfig(**SWIN, drop_path_rate=0.0),
        bert=JC.BertConfig(**BERT), img_size=IMG, max_tokens=TOKENS,
        num_frames=T, hybrid_2d_3d=True,
        tpwam=JC.TPWAMConfig(kind=JC.TPWAMKind[KINDS[kind]]), **kw)


def port_config(kind, **kw):
    return C.lavt_video_tiny().replace(
        swin=C.SwinConfig(**SWIN, drop_path_rate=0.0),
        bert=C.BertConfig(**BERT), img_size=IMG, max_tokens=TOKENS,
        num_frames=T, hybrid_2d_3d=True,
        tpwam=C.TPWAMConfig(kind=C.TPWAMKind[KINDS[kind]]), dtype="float32",
        **kw)


def jax_variables(jm, seed):
    vid = jnp.zeros((1, T, IMG, IMG, 3))
    ids = jnp.ones((1, TOKENS), jnp.int32)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), vid, ids,
                                            ids))
    shapes = {k: shapes[k] for k in ("params", "batch_stats")}
    return random_variables(shapes, np.random.default_rng(seed))


def _batch(rng):
    mask = np.ones((B, TOKENS), np.int32)
    mask[0, 4:] = 0
    return {"video": rng.integers(0, 256, (B, T, IMG, IMG, 3)).astype(np.uint8),
            "ids": rng.integers(1, 120, (B, TOKENS)).astype(np.int32),
            "mask": mask,
            "target": rng.integers(0, 2, (B, IMG, IMG)).astype(np.int32),
            "valid_index": np.asarray(VALID, np.int32)}


def hybrid_case(kind):
    """For one fusion: the JAX variables, logits of one clip, and one JAX
    train step's loss and gradients (in the port's names)."""
    jcfg = jax_config(kind)
    jm = jbuild_model(jcfg)
    variables = jax_variables(jm, 7)
    rng = np.random.default_rng(1)
    clip = (rng.standard_normal((1, T, IMG, IMG, 3)).astype(np.float32),
            rng.integers(1, 120, (1, TOKENS)).astype(np.int64),
            np.asarray([[1, 1, 1, 1, 0, 0]], np.int64))
    logits = np.asarray(jax.jit(jm.apply)(variables, *clip))

    jtrain = jbuild_model(jcfg, train=True)
    batch = _batch(np.random.default_rng(9))
    state = TrainState(step=jnp.zeros((), jnp.int32),
                       params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       opt_state=jax.tree.map(jnp.zeros_like,
                                              variables["params"]))
    jstep = jax.jit(jmake_video_step(jtrain, _grads_as_state(),
                                     joptim.TrainConfig()))
    new_state, jmetrics = jstep(state, {k: jnp.asarray(v)
                                        for k, v in batch.items()},
                                jax.random.PRNGKey(3))
    grads = state_dict_from_jax(
        {"params": jax.tree.map(np.asarray, new_state.opt_state),
         "batch_stats": jax.tree.map(np.asarray, new_state.batch_stats)},
        port_config(kind))
    return dict(kind=kind, variables=variables, clip=clip, logits=logits,
                batch=batch, loss=float(jmetrics["loss"]), grads=grads)


def port_model(kind, variables, train=False, **kw):
    cfg = port_config(kind, **kw)
    m = build_model(cfg, device="cpu", train=train)
    m.load_state_dict(state_dict_from_jax(variables, cfg), strict=True)
    return m


@pytest.fixture(scope="module")
def hybrid():
    """The SepTPWAM case (--ytvos_2d_swin_3d_pwam); the 2D PWAM's is
    tests/test_torch_hybrid_pwam2d.py."""
    return hybrid_case("sep")


def check_logits(hybrid):
    pm = port_model(hybrid["kind"], hybrid["variables"])
    layers = pm.backbone.layers
    assert all(isinstance(l, swin3d.Hybrid2D3DLayer) for l in layers)
    assert all(isinstance(b, swin2d.SwinBlock) for l in layers
               for b in l.blocks)
    table = layers[0].blocks[0].attn.relative_position_bias_table
    assert table.shape == ((2 * 7 - 1) ** 2, 1)
    with torch.no_grad():
        got = pm(*(torch.from_numpy(a) for a in hybrid["clip"])).numpy()
    want = hybrid["logits"]
    assert got.shape == (T, IMG, IMG, 2) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=2e-4)
    margin = np.abs(want[..., 1] - want[..., 0])
    agree = (got.argmax(-1) == want.argmax(-1)) | (margin < 1e-3)
    assert agree.mean() > 0.9999


def check_train_step(hybrid, use_checkpoint):
    """The loss and every parameter's gradient (the 2D blocks' bias
    tables among them) of one port step, checkpointed or not, against the
    JAX step's."""
    pm = port_model(hybrid["kind"], hybrid["variables"], train=True,
                    use_checkpoint=use_checkpoint)
    tcfg = optim.TrainConfig()
    step = make_video_train_step(pm, *create_train_state(pm, tcfg), tcfg)
    metrics = step({k: torch.from_numpy(v)
                    for k, v in hybrid["batch"].items()},
                   torch.Generator().manual_seed(3))
    _close(metrics["loss"], hybrid["loss"], "loss")
    want = hybrid["grads"]
    params = dict(pm.named_parameters())
    top = max(float(want[n].abs().max()) for n in params)
    tables = 0
    for name, p in params.items():
        w = want[name].numpy()
        if p.grad is None:  # unused in the graph: JAX's gradient is 0 too
            assert not w.any(), name
            continue
        g = p.grad.numpy()
        assert g.shape == w.shape, name
        bound = 1e-2 * np.linalg.norm(w) + 1e-4 * top * np.sqrt(w.size)
        assert np.linalg.norm(g - w) <= bound, (name, np.linalg.norm(g - w),
                                                np.linalg.norm(w))
        if name.endswith("relative_position_bias_table"):
            assert np.abs(w).max() > 0 and w.shape[0] == 169, name
            tables += 1
    assert tables == sum(SWIN["depths"])


def test_hybrid_logit_parity(hybrid):
    check_logits(hybrid)


@pytest.mark.parametrize("use_checkpoint", [False, True],
                         ids=["plain", "checkpoint"])
def test_hybrid_train_step_matches_jax(hybrid, use_checkpoint):
    check_train_step(hybrid, use_checkpoint)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_pretrained2d_lavt_weights_matches_jax(kind, tmp_path):
    """A 2D lavt_one .pth written from a port model of the hybrid's widths
    (window 7) loads as JAX `apply_pretrained_flags` loads it: every leaf
    equal; the patch embedding 5-D with a temporal axis of 1, the 49-token
    tables as they are, the fusion loaded for the 2D PWAM and skipped for
    the 3D SepTPWAM."""
    two_d = C.ModelConfig(swin=C.SwinConfig(**SWIN), bert=C.BertConfig(**BERT),
                          img_size=IMG, max_tokens=TOKENS, dtype="float32")
    src = build_model(two_d, "cpu", generator=torch.Generator().manual_seed(5))
    sd = src.state_dict()
    g = torch.Generator().manual_seed(6)
    for k, v in sd.items():
        if "res_gate" in k or "running_" in k:
            v.copy_(v + 0.1 * torch.rand(v.shape, generator=g))
    path = tmp_path / "lavt_one.pth"
    torch.save({"model": sd}, path)
    args = argparse.Namespace(
        pretrained_swin_weights="", ck_bert="", pretrained2d_lavt_weights=str(path),
        pretrained2d_lavt_weights_for_a_3d_model="",
        pretrained_video_lavt_weights_on_refcocos="")

    jcfg = jax_config(kind)
    jvars = jax_variables(jbuild_model(jcfg), 11)
    cfg = port_config(kind)
    pm = build_model(cfg, "cpu", train=True)
    pm.load_state_dict(state_dict_from_jax(jvars, cfg), strict=True)
    (rec,) = pretrained.apply_pretrained_flags(pm, cfg, args)
    want = state_dict_from_jax(japply_flags(jvars, jcfg, args), cfg)
    got = pm.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(),
                                      err_msg=k)

    assert rec["flag"] == "--pretrained2d_lavt_weights" and rec["seconds"] > 0
    pe = "backbone.patch_embed.proj.weight"
    assert pe in rec["loaded"] and got[pe].dim() == 5 and got[pe].shape[2] == 1
    torch.testing.assert_close(got[pe][:, :, 0], sd[pe], rtol=0, atol=0)
    table = "backbone.layers.0.blocks.0.attn.relative_position_bias_table"
    assert got[table].shape[0] == (2 * 7 - 1) ** 2
    torch.testing.assert_close(got[table], sd[table], rtol=0, atol=0)
    fusion = "backbone.layers.0.fusion.image_lang_att.f_key.0.weight"
    if kind == "pwam2d":
        assert fusion in rec["loaded"]
        torch.testing.assert_close(got[fusion], sd[fusion], rtol=0, atol=0)
    else:
        assert not any(".fusion." in k for k in rec["loaded"] + rec["skipped"])
    assert any(k.startswith("classifier.") for k in rec["loaded"])
    assert any(k.startswith("text_encoder.") for k in rec["loaded"])

    video = build_model(cfg.replace(hybrid_2d_3d=False), "cpu")
    with pytest.raises(ValueError, match="hybrid 2D-Swin video models"):
        pretrained.apply_pretrained_flags(video, video.cfg, args)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_hybrid_kernel_plan(kind):
    """`lavt_video_tiny` with either hybrid flag at 480², 8 frames: the 2D
    window-7 blocks launch K10 (N = 49) in all 12 blocks and K3 (K8 and
    K7 in training, every block's drop-path rate > 0) at C = 384; the
    stage norms and the C = 96 / 192 / 768 tails stay plain, as in the
    JAX package.  Every kernel has its f32 variant."""
    cfg = C.lavt_video_tiny(hybrid_2d_3d=True,
                            tpwam=C.TPWAMConfig(kind=C.TPWAMKind[KINDS[kind]]))
    with torch.device("meta"):
        plan = LAVTVideo(cfg).backbone.kernel_plan
    assert plan(8, (480, 480))[0] == {"K10": 12, "K3": 6}
    assert plan(8, (480, 480), 4, train=True)[0] == {"K10": 12, "K9": 12,
                                                     "K8": 6, "K7": 6}
    unrouted = plan(8, (480, 480))[1]
    assert len(unrouted) == 3 and all("LN-MLP tails" in u for u in unrouted)
    with torch.device("meta"):
        ckpt = LAVTVideo(cfg.replace(use_checkpoint=True)).backbone
    assert ckpt.kernel_plan(8, (480, 480), 2, True)[0] == {
        "K10": 24, "K9": 12, "K8": 12, "K7": 6}
    f32 = cfg.replace(dtype="float32")
    assert kernels_without_variant(f32) == []
    assert kernels_without_variant(f32, train=True) == []
    assert kernels_without_variant(dataclasses.replace(
        f32, swin=dataclasses.replace(f32.swin, window_size=12)),
        train=True) == []
