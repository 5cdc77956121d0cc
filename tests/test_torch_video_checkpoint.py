"""Activation checkpointing of the 3D Swin blocks (`use_checkpoint`) in the
port's lavt_video training step, on the CPU.

A small lavt_video (embed 48, depths (1, 1, 2, 1), heads (3, 6, 12, 24),
window 7, 4-frame 64² clips, 1 BERT layer), batch 2 with annotated frames
1 and 3:
  * one step with every block checkpointed equals the same model's step
    with the checkpointing switched off (its layers' `use_checkpoint`
    cleared, so the last stage still skips its language gate), DropPath
    0.1 and every dropout on from one generator seed: the loss and every
    gradient within 1e-6 abs + 1e-5 rel (the same f32 ops in another
    autograd graph), and each checkpointed block runs K10's save mode
    twice (its forward and the recompute);
  * the checkpointed step equals JAX `make_video_train_step` on a model
    built with `use_checkpoint=True` (`nn.remat` of every SwinBlock3D), its
    seeded variables carried by `convert/from_jax.py`, everything f32 with
    DropPath and dropout 0 (the frameworks draw different numbers), within
    tests/test_torch_video_train.py's tolerances;
  * the kernel plan of a training step counts K10's save mode twice per
    checkpointed block (the recompute), K9 once.
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
from lavt_rs_tpu_torch.models.factory import build_model
from lavt_rs_tpu_torch.ops import window_attn
from lavt_rs_tpu_torch.train import optim
from lavt_rs_tpu_torch.train.step import (create_train_state,
                                          make_video_train_step)
from test_torch_model import random_variables
from test_torch_train import _close, _grads_as_state
from test_torch_video import BERT, IMG, T, TOKENS
from test_torch_video_train import NO_DROP_BERT, _video_batch
from torch_threads import torch_threads  # noqa: F401 (autouse fixture)

SWIN = dict(embed_dim=48, depths=(1, 1, 2, 1), num_heads=(3, 6, 12, 24),
            window_size=7)


def _cfg(drop: bool, **kw):
    swin = dict(SWIN, drop_path_rate=0.1 if drop else 0.0)
    bert = BERT if drop else NO_DROP_BERT
    return C.lavt_video_tiny().replace(
        swin=C.SwinConfig(**swin), bert=C.BertConfig(**bert), img_size=IMG,
        max_tokens=TOKENS, num_frames=T, dtype="float32", **kw)


def _step(model, batch, seed):
    tcfg = optim.TrainConfig()
    step = make_video_train_step(model, *create_train_state(model, tcfg), tcfg)
    metrics = step({k: torch.from_numpy(v) for k, v in batch.items()},
                   torch.Generator().manual_seed(seed))
    grads = {n: p.grad.clone() for n, p in model.named_parameters()
             if p.grad is not None}
    return metrics, grads


def test_checkpointed_step_equals_the_unchecked_step(monkeypatch):
    cfg = _cfg(drop=True, use_checkpoint=True)
    models = [build_model(cfg, device="cpu", train=True,
                          generator=torch.Generator().manual_seed(0))
              for _ in range(2)]
    models[1].load_state_dict(models[0].state_dict())
    for layer in models[1].backbone.layers:  # same model, no checkpointing
        layer.use_checkpoint = False
    assert models[0].backbone.layers[-1].res_gate is None  # skip_gate
    calls = []
    save = window_attn.window_attention_save
    monkeypatch.setattr(window_attn, "window_attention_save",
                        lambda *a: calls.append(1) or save(*a))
    batch = _video_batch(np.random.default_rng(9))
    results = []
    for m in models:
        calls.clear()
        results.append(_step(m, batch, 3))
        results[-1] += (len(calls),)
    (m0, g0, n0), (m1, g1, n1) = results
    assert (n0, n1) == (10, 5)  # K10's save mode: forward and recompute
    torch.testing.assert_close(m0["loss"], m1["loss"], rtol=1e-5, atol=1e-6)
    assert g0.keys() == g1.keys() and len(g0) > 100
    for name in g0:
        torch.testing.assert_close(g0[name], g1[name], rtol=1e-5, atol=1e-6,
                                   msg=name)


def test_kernel_plan_counts_the_recompute():
    plans = []
    for ckpt, k10 in ((False, 5), (True, 10)):
        m = build_model(_cfg(drop=False, use_checkpoint=ckpt), device="meta",
                        train=True)
        assert m.backbone.kernel_plan(T, (IMG, IMG), 4, train=True)[0] == {
            "K10": k10, "K9": 5}
        plans.append(m.backbone.kernel_plan(T, (IMG, IMG), 4))
    assert plans[0] == plans[1]  # inference: the flag changes nothing


def test_checkpointed_step_matches_jax_remat():
    jcfg = JC.lavt_video_tiny().replace(
        swin=JC.SwinConfig(**SWIN, drop_path_rate=0.0),
        bert=JC.BertConfig(**NO_DROP_BERT), img_size=IMG, max_tokens=TOKENS,
        num_frames=T, use_pallas=False, use_checkpoint=True)
    jm = jbuild_model(jcfg, train=True)
    vid = jnp.zeros((1, T, IMG, IMG, 3))
    ids = jnp.ones((1, TOKENS), jnp.int32)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), vid, ids,
                                            ids))
    shapes = {k: shapes[k] for k in ("params", "batch_stats")}
    variables = random_variables(shapes, np.random.default_rng(7))
    batch = _video_batch(np.random.default_rng(9))
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

    cfg = _cfg(drop=False, use_checkpoint=True)
    pm = build_model(cfg, device="cpu", train=True)
    pm.load_state_dict(state_dict_from_jax(variables, cfg), strict=True)
    pmetrics, grads = _step(pm, batch, 3)
    _close(pmetrics["loss"], jmetrics["loss"], "loss")
    want = state_dict_from_jax(
        {"params": jax.tree.map(np.asarray, new_state.opt_state),
         "batch_stats": jax.tree.map(np.asarray, new_state.batch_stats)}, cfg)
    params = dict(pm.named_parameters())
    top = max(float(want[n].abs().max()) for n in params)
    for name in params:
        w = want[name].numpy()
        if name not in grads:  # unused in the graph: JAX's gradient is 0 too
            assert not w.any(), name
            continue
        g = grads[name].numpy()
        bound = 1e-2 * np.linalg.norm(w) + 1e-4 * top * np.sqrt(w.size)
        assert np.linalg.norm(g - w) <= bound, (name, np.linalg.norm(g - w),
                                                np.linalg.norm(w))
