"""Train steps of the decoder options, `ape` and Swin's drop rates in the
port, on the CPU, in f32 (test_torch_fusion_variants.py's small
lavt_one).

  * drop_rate > 0: in a train step the LN -> MLP tails leave the fused
    route for the chain (JAX `swin2d.py:361-362`: no tail kernel in the
    plan, none called), the MSA keeps its route, the dropout masks are
    the blocks' own (a --use_checkpoint step equals the unflagged one).
    Dropout masks cannot match JAX's (other random numbers): the
    train-step parity below runs at rate 0.
  * One train step of lavt_one with lazy_pred, interpolate_before_seg,
    seg_last and ape against JAX's: test_torch_train_families.py's checks
    (the stage-4 fusion and gate, which lazy_pred's outputs do not read,
    take no gradient, JAX's being 0) and the BatchNorm statistics,
    `pre_seg`'s and `seg_last_conv`'s among them.
"""

import dataclasses

import numpy as np
import torch

from lavt_rs_tpu_torch.models.factory import build_model
from lavt_rs_tpu_torch.ops import fused_mlp
from lavt_rs_tpu_torch.train.optim import TrainConfig
from lavt_rs_tpu_torch.train.step import create_train_state, make_train_step
from test_torch_fusion_variants import IMG, configs, inputs
from test_torch_fusion_variants_train import (  # noqa: F401 (collected here)
    batch_norm_statistics_match_jax, test_block_gradients_match_jax,
    test_label_param_matches_jax, test_loss_matches_jax)
from test_torch_train_families import steps_fixture
from torch_threads import torch_threads  # noqa: F401 (autouse fixture)


def _drop_step(cfg, monkeypatch, seed=3):
    """One train step of `cfg` (small lavt_one, DropPath 0) on a fixed
    batch; returns (loss, grads, fused tail calls)."""
    calls = []
    real = fused_mlp.ln_mlp
    monkeypatch.setattr(fused_mlp, "ln_mlp",
                        lambda *a: calls.append(1) or real(*a))
    model = build_model(cfg, "cpu", torch.Generator().manual_seed(0),
                        train=True)
    tcfg = TrainConfig()
    step = make_train_step(model, *create_train_state(model, tcfg), tcfg)
    x, ids, mask = inputs(6)
    batch = {"image": torch.from_numpy(x), "ids": torch.from_numpy(ids),
             "mask": torch.from_numpy(mask),
             "target": torch.from_numpy(np.random.default_rng(7).integers(
                 0, 2, (2, IMG, IMG)))}
    out = step(batch, torch.Generator().manual_seed(seed))
    grads = torch.cat([p.grad.flatten() for p in model.parameters()
                       if p.grad is not None])
    return float(out["loss"]), grads, len(calls)


def test_drop_rate_takes_the_tails_off_the_fused_route(monkeypatch):
    """drop_rate > 0 in training: no LN-MLP tail kernel in the step's plan
    (K3 / K8 / K7) and none called, where rate 0 takes them at C = 384
    (JAX `swin2d.py:361-362`); eval keeps K3.  The dropout masks are the
    blocks' own (seeded from the step's generator), so a
    --use_checkpoint step gives the unflagged step's loss and gradients,
    and another generator seed another loss."""
    _, cfg = configs(swin=dict(drop_path_rate=0.0))
    dropped = cfg.replace(swin=dataclasses.replace(cfg.swin, drop_rate=0.1))
    bb = build_model(dropped, "meta", train=True).backbone
    train_plan, _ = bb.kernel_plan((IMG, IMG), 2, 4, train=True)
    assert not {"K3", "K8", "K7"} & set(train_plan)
    assert "K3" in bb.kernel_plan((IMG, IMG), 2, 4)[0]
    assert {"K3", "K7"} <= set(build_model(cfg, "meta", train=True)
                               .backbone.kernel_plan((IMG, IMG), 2, 4,
                                                     train=True)[0])
    loss0, _, calls0 = _drop_step(cfg, monkeypatch)
    loss, grads, calls = _drop_step(dropped, monkeypatch)
    assert calls0 > 0 and calls == 0 and loss != loss0
    flagged = dropped.replace(use_checkpoint=True)
    loss_c, grads_c, _ = _drop_step(flagged, monkeypatch)
    assert loss_c == loss
    torch.testing.assert_close(grads_c, grads, rtol=1e-5, atol=1e-6)
    assert _drop_step(dropped, monkeypatch, seed=4)[0] != loss


# -- a train step with every decoder option and ape -----------------------------------

def decoder_step_configs(_):
    jcfg, cfg = configs(swin=dict(drop_path_rate=0.0, ape=True),
                        bert=dict(hidden_dropout=0.0, attn_dropout=0.0),
                        lazy_pred=True, interpolate_before_seg=True,
                        seg_last=True)
    return jcfg.replace(use_pallas=False), cfg


steps = steps_fixture(("lazy+ibs+seg_last+ape",), decoder_step_configs)


def test_batch_norm_statistics_match_jax(steps):
    """The decoder's BatchNorms, `pre_seg`'s and `seg_last_conv`'s too."""
    batch_norm_statistics_match_jax(steps)
    assert {"classifier.pre_seg.bn", "classifier.seg_last_conv.bn"} <= set(
        steps["bn_counts"])
