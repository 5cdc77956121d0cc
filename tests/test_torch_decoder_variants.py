"""The decoder options (lazy_pred, interpolate_before_seg, seg_last), the
absolute position embedding (`ape`) and Swin's drop rates in the port,
against the JAX package, on the CPU, in f32.

  * lavt_one (test_torch_fusion_variants.py's small model) under each
    decoder option and their combination: logits within 1e-4 of JAX's
    from the same variables (`from_jax`: no third join under lazy_pred,
    `pre_seg` / `seg_last_conv`); lazy_pred's stage norms are norm1-norm3
    (the plan's K4 3), and its state_dict goes into JAX through
    `torch2jax`, which drops the stage-1 join.
  * lavt_video's decoder options: tests/test_torch_tpwam_kinds.py.
  * ape: the bicubic resize against JAX `resize_2d` (a = -0.75,
    half-pixel, edge-clamped taps) at the 64², 448² and 480² grids, and
    the model both ways (`absolute_pos_embed` (1, 56², C) into JAX by
    `torch2jax`); the plain Swin of lts has none, as JAX's.
  * drop_rate and attn_drop_rate: eval logits equal JAX's (dropout off).
  * A resize whose output passes torch's 32-bit element limit on the card
    (seg_last's decoder map in an eval batch) runs in batch chunks, bit
    for bit the one-piece resize (the limit lowered here).
The train steps (drop_rate, and every decoder option with ape against
JAX's step): tests/test_torch_decoder_variants_train.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lavt_rs_tpu.convert import torch2jax
from lavt_rs_tpu.models.factory import build_model as jbuild_model
from lavt_rs_tpu.ops.resize import resize_2d
from lavt_rs_tpu_torch.convert.from_jax import state_dict_from_jax
from lavt_rs_tpu_torch.models.factory import build_model
from lavt_rs_tpu_torch.ops.resize import resize_f32
from test_torch_families import random_state_dict, tree_shapes
from test_torch_fusion_variants import (IMG, _close, _port_out, configs,
                                        inputs, jax_shapes)
from test_torch_model import random_variables
from torch_threads import torch_threads  # noqa: F401 (autouse fixture)

DECODERS = (dict(lazy_pred=True), dict(interpolate_before_seg=True),
            dict(interpolate_before_seg=True, seg_last=True),
            dict(lazy_pred=True, interpolate_before_seg=True, seg_last=True))


def _from_jax(jcfg, cfg, seed=7):
    jm = jbuild_model(jcfg)
    variables = random_variables(jax_shapes(jm), np.random.default_rng(seed))
    pm = build_model(cfg, device="cpu")
    pm.load_state_dict(state_dict_from_jax(variables, cfg), strict=True)
    return jm, variables, pm


@pytest.mark.parametrize("flags", DECODERS,
                         ids=lambda f: "+".join(sorted(f)))
def test_lavt_one_decoders_from_jax_variables(flags):
    jcfg, cfg = configs(**flags)
    jm, variables, pm = _from_jax(jcfg, cfg)
    names = pm.state_dict()
    assert ("classifier.conv1_2.weight" in names) == (not cfg.lazy_pred)
    assert ("classifier.pre_seg.conv.weight" in names) == \
        cfg.interpolate_before_seg
    assert ("classifier.seg_last_conv.bn.running_var" in names) == \
        cfg.seg_last
    arrays = inputs(1)
    want = np.asarray(jax.jit(jm.apply)(variables, *arrays))
    got = _port_out(pm, *arrays)
    assert got.shape == (2, IMG, IMG, 2)
    _close(got, want, msg=str(flags))


def test_lazy_pred_stage_norms_plan_and_reference_converter():
    """lazy_pred: the backbone outputs stages 2-4 (norm1-norm3, K4 3 a
    forward in the plan); the port's state_dict into JAX by
    `torch2jax.convert_lavt_one` (no stage-1 join) equals JAX's tree and
    logits."""
    jcfg, cfg = configs(lazy_pred=True)
    pm = build_model(cfg, device="cpu")
    norms = sorted({k.split(".")[1] for k in pm.state_dict()
                    if k.startswith("backbone.norm")})
    assert norms == ["norm1", "norm2", "norm3"]
    plan, _ = build_model(cfg.replace(swin=dataclasses.replace(
        cfg.swin, embed_dim=128)), "meta").backbone.kernel_plan((480, 480), 8)
    assert plan["K4"] == 3
    pm.load_state_dict(random_state_dict(pm, np.random.default_rng(11)))
    jm = jbuild_model(jcfg)
    variables = torch2jax.convert_lavt_one(
        {k: v.numpy() for k, v in pm.state_dict().items()}, jcfg)
    shapes = jax_shapes(jm)
    for part in ("params", "batch_stats"):
        assert tree_shapes(variables[part]) == tree_shapes(shapes[part])
    arrays = inputs(2)
    _close(_port_out(pm, *arrays),
           np.asarray(jax.jit(jm.apply)(variables, *arrays)))


# -- ape ----------------------------------------------------------------------

@pytest.mark.parametrize("grid", [16, 56, 112, 120])
def test_ape_bicubic_resize_matches_jax(grid):
    rng = np.random.default_rng(grid)
    table = rng.standard_normal((1, 56, 56, 8)).astype(np.float32)
    want = np.asarray(resize_2d(jnp.asarray(table), (grid, grid),
                                method="bicubic", align_corners=False))
    got = resize_f32(torch.from_numpy(table).permute(0, 3, 1, 2),
                     (grid, grid), align_corners=False,
                     mode="bicubic").permute(0, 2, 3, 1).numpy()
    _close(got, want)


def test_ape_both_ways():
    """`absolute_pos_embed` (1, 56², C), the layout torch2jax reads, from
    JAX's (1, 56, 56, C) and back; the logits of both; lts's plain Swin
    builds none (JAX `SwinTransformer` ignores ape)."""
    jcfg, cfg = configs(swin=dict(ape=True))
    jm, variables, pm = _from_jax(jcfg, cfg)
    assert pm.backbone.absolute_pos_embed.shape == (1, 56 * 56, 48)
    arrays = inputs(4)
    _close(_port_out(pm, *arrays),
           np.asarray(jax.jit(jm.apply)(variables, *arrays)))
    pm.load_state_dict(random_state_dict(pm, np.random.default_rng(12)))
    back = torch2jax.convert_lavt_one(
        {k: v.numpy() for k, v in pm.state_dict().items()}, jcfg)
    for part in ("params", "batch_stats"):
        assert tree_shapes(back[part]) == tree_shapes(variables[part])
    _close(_port_out(pm, *arrays),
           np.asarray(jax.jit(jm.apply)(back, *arrays)))
    lts = build_model(cfg.replace(name="lts"), "meta")
    assert lts.backbone.absolute_pos_embed is None


# -- drop_rate / attn_drop_rate ------------------------------------------------------

def test_drop_rates_in_eval_match_jax():
    jcfg, cfg = configs(swin=dict(drop_rate=0.1, attn_drop_rate=0.1))
    jm, variables, pm = _from_jax(jcfg, cfg)
    arrays = inputs(5)
    _close(_port_out(pm, *arrays),
           np.asarray(jax.jit(jm.apply)(variables, *arrays)))


def test_resize_splits_the_batch_past_the_element_limit(monkeypatch):
    from lavt_rs_tpu_torch.ops import resize

    x = torch.randn(5, 3, 6, 7, generator=torch.Generator().manual_seed(0))
    want = resize.resize_nchw(x, (12, 14), exact=False)
    monkeypatch.setattr(resize, "MAX_ELEMENTS", 2 * 3 * 12 * 14 + 1)
    calls = []
    real = resize.F.interpolate
    monkeypatch.setattr(resize.F, "interpolate",
                        lambda t, **kw: calls.append(t.shape[0]) or real(t, **kw))
    got = resize.resize_nchw(x, (12, 14), exact=False)
    assert calls == [2, 2, 1]
    assert torch.equal(got, want)
