"""The small lavt_video of tests/test_torch_video.py (embed 32, depths
(2, 2, 2, 2), 4-frame 64² clips, 1 BERT layer) with the 3D PWAM kinds,
against the JAX package's, on the CPU, in f32 (its decoder options:
tests/test_torch_tpwam_kinds.py).

  * TSPWAM (concatenated, the (1, 3, 3) reduce): logits within 1e-4 of
    JAX's; the hybrid with --ytvos_2d_swin_pwam --fuse simple (the
    clip-wide PWAM takes LangProject, as JAX reads the fusion kind there).
  * One training step with SepSeqTPWAM (residual) against JAX's: the loss
    within 1e-4 relative, every gradient within
    test_torch_video_train.py's bound, the decoder's BatchNorm
    statistics.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lavt_rs_tpu import config as JC
from lavt_rs_tpu.models.factory import build_model as jbuild_model
from lavt_rs_tpu.train import optim as joptim
from lavt_rs_tpu.train.step import TrainState
from lavt_rs_tpu.train.step import make_video_train_step as jmake_video_step
from lavt_rs_tpu_torch import config as C
from lavt_rs_tpu_torch.convert.from_jax import state_dict_from_jax
from lavt_rs_tpu_torch.models import pwam, tpwam
from lavt_rs_tpu_torch.models.factory import build_model
from lavt_rs_tpu_torch.train import optim
from lavt_rs_tpu_torch.train.step import (create_train_state,
                                          make_video_train_step)
from test_torch_fusion_variants import IMG, TOKENS, _close, _port_out
from test_torch_model import random_variables
from test_torch_tpwam_kinds import (FRAMES, VBERT, VSWIN, video_configs,
                                    video_inputs, video_jax_shapes,
                                    video_pair)
from test_torch_train import _grads_as_state
from test_torch_train_families import _bn_counts
from torch_threads import torch_threads  # noqa: F401 (autouse fixture)


def test_lavt_video_with_tspwam():
    jm, variables, pm = video_pair(*video_configs(
        dict(kind="ts", kernel_t=(3, 1, 1), branch_fuse="cat",
             fuse_kernel=(1, 3, 3))))
    assert type(pm.backbone.layers[0].fusion) is tpwam.TSPWAM
    arrays = video_inputs(4)
    _close(_port_out(pm, *arrays),
           np.asarray(jax.jit(jm.apply)(variables, *arrays)))


def test_hybrid_2d_swin_pwam_with_fuse_simple():
    """--ytvos_2d_swin_pwam --fuse simple: the 2D Swin blocks per frame,
    the clip-wide 2D PWAM with LangProject (JAX reads `fusion.kind` for
    PWAM2D alone)."""
    jcfg, cfg = video_configs(dict(kind="pwam2d"), fuse="simple")
    jm, variables, pm = video_pair(jcfg.replace(hybrid_2d_3d=True),
                                   cfg.replace(hybrid_2d_3d=True))
    fusion = pm.backbone.layers[0].fusion
    assert isinstance(fusion.image_lang_att, pwam.LangProject)
    arrays = video_inputs(5)
    _close(_port_out(pm, *arrays),
           np.asarray(jax.jit(jm.apply)(variables, *arrays)))


# -- one video train step with SepSeqTPWAM --------------------------------------

B, VALID = 2, (1, 3)


@pytest.fixture(scope="module")
def video_steps():
    no_drop = dict(drop_path_rate=0.0)
    jcfg, cfg = video_configs(dict(kind="sep_seq", kernel_t=(3, 1, 1),
                                   seq_residual=True))
    nb = dict(hidden_dropout=0.0, attn_dropout=0.0)
    jcfg = jcfg.replace(swin=JC.SwinConfig(**VSWIN, **no_drop),
                        bert=JC.BertConfig(**VBERT, **nb), use_pallas=False)
    cfg = cfg.replace(swin=C.SwinConfig(**VSWIN, **no_drop),
                      bert=C.BertConfig(**VBERT, **nb))
    jm = jbuild_model(jcfg, train=True)
    variables = random_variables(video_jax_shapes(jm),
                                 np.random.default_rng(7))
    rng = np.random.default_rng(9)
    mask = np.ones((B, TOKENS), np.int32)
    mask[0, 4:] = 0
    batch = {"video": rng.integers(0, 256, (B, FRAMES, IMG, IMG, 3)
                                   ).astype(np.uint8),
             "ids": rng.integers(1, 120, (B, TOKENS)).astype(np.int32),
             "mask": mask,
             "target": rng.integers(0, 2, (B, IMG, IMG)).astype(np.int32),
             "valid_index": np.asarray(VALID, np.int32)}
    state = TrainState(step=jnp.zeros((), jnp.int32),
                       params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       opt_state=jax.tree.map(jnp.zeros_like,
                                              variables["params"]))
    jstep = jax.jit(jmake_video_step(jm, _grads_as_state(),
                                     joptim.TrainConfig()))
    new_state, jmetrics = jstep(state, {k: jnp.asarray(v)
                                        for k, v in batch.items()},
                                jax.random.PRNGKey(3))
    pm = build_model(cfg, device="cpu", train=True)
    pm.load_state_dict(state_dict_from_jax(variables, cfg), strict=True)
    bn_counts = _bn_counts(pm)
    tcfg = optim.TrainConfig()
    pmetrics = make_video_train_step(pm, *create_train_state(pm, tcfg), tcfg)(
        {k: torch.from_numpy(v) for k, v in batch.items()},
        torch.Generator().manual_seed(3))
    stats = jax.tree.map(np.asarray, new_state.batch_stats)
    return dict(pm=pm, jmetrics=jmetrics, pmetrics=pmetrics,
                bn_counts=bn_counts,
                want_grads=state_dict_from_jax(
                    {"params": jax.tree.map(np.asarray, new_state.opt_state),
                     "batch_stats": stats}, cfg),
                want_stats=state_dict_from_jax(
                    {"params": variables["params"], "batch_stats": stats},
                    cfg),
                old_stats=state_dict_from_jax(variables, cfg))


def test_video_step_loss_matches_jax(video_steps):
    got = float(video_steps["pmetrics"]["loss"])
    want = float(video_steps["jmetrics"]["loss"])
    assert abs(got - want) <= 1e-4 * abs(want), (got, want)


def test_video_step_grads_match_jax(video_steps):
    """Every gradient, the SepSeqTPWAM convolutions' among them, within
    test_torch_video_train.py's bound."""
    pm, want = video_steps["pm"], video_steps["want_grads"]
    params = dict(pm.named_parameters())
    top = max(float(want[n].abs().max()) for n in params)
    fused = 0
    for name, p in params.items():
        w = want[name].numpy()
        if p.grad is None:
            assert not w.any(), name
            continue
        g = p.grad.numpy()
        bound = 1e-2 * np.linalg.norm(w) + 1e-4 * top * np.sqrt(w.size)
        assert np.linalg.norm(g - w) <= bound, name
        fused += ".fusion.f_query_t_q." in name
    assert fused == 2 * len(VSWIN["depths"])


def test_video_step_batch_norm_statistics_match_jax(video_steps):
    """The decoder's BatchNorms, torch's running_var unbiased (n / (n - 1)
    of flax's update)."""
    pm, want, old = (video_steps["pm"], video_steps["want_stats"],
                     video_steps["old_stats"])
    mods = dict(pm.named_modules())
    assert len(video_steps["bn_counts"]) == 6
    for name, n in video_steps["bn_counts"].items():
        mod = mods[name]
        np.testing.assert_allclose(mod.running_mean.numpy(),
                                   want[f"{name}.running_mean"].numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
        v_old = old[f"{name}.running_var"].numpy()
        biased = (want[f"{name}.running_var"].numpy() - 0.9 * v_old) / 0.1
        np.testing.assert_allclose(
            mod.running_var.numpy(), 0.9 * v_old + 0.1 * biased * n / (n - 1),
            rtol=1e-5, atol=1e-5, err_msg=name)
        assert int(mod.num_batches_tracked) == 1
