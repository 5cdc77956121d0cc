"""The training step of the port's fusion variants against the JAX
package's, on the CPU, in f32: the PWAM att_norm kinds (BN, LN, none)
here, BCAM and GACD in test_torch_fusion_baselines_train.py, EFN and
--fuse simple in test_torch_fusion_efn_simple_train.py, on this file's
fixture (the files split to stay under ~90 s each in the tier-1 run's
workers).

Each variant's small lavt_one of test_torch_fusion_variants.py, with
DropPath and the BERT dropouts at 0, takes one JAX `make_train_step` on
the XLA route and one port step (the kernel route: on CPU tensors the
autograd Functions take their plain versions), from seeded numpy
variables carried by `convert/from_jax.py`: test_torch_train_families.py's
checks (the loss within 1e-4 relative, every Swin block's gradient at
cosine >= 0.999, the parameter groups equal JAX `label_param`'s) and the
BatchNorm statistics within 1e-5, the BN att_norm's within `STATS_TOL`:
flax's train-mode BatchNorm takes the fast variance E[x²] − E[x]², which
can miss the exact value by ~1e-2 where a channel's values lie close
(ROADMAP.md §3).  The BN att_norm's parameters take no
weight decay, as JAX labels its `f_query_norm` / `W_norm`.
"""

import numpy as np
import pytest
import torch

from lavt_rs_tpu_torch.train import optim
from test_torch_fusion_variants import configs
from test_torch_train_families import (  # noqa: F401 (collected here too)
    MOMENTUM, steps_fixture, test_block_gradients_match_jax,
    test_label_param_matches_jax, test_loss_matches_jax)
from torch_threads import torch_threads  # noqa: F401 (autouse fixture)

NO_DROP = dict(swin=dict(drop_path_rate=0.0),
               bert=dict(hidden_dropout=0.0, attn_dropout=0.0))
# the BN att_norm's statistics (flax's fast variance); every other 1e-5
STATS_TOL = 1e-3


def variant_configs(variant):
    kind, att = variant
    jcfg, cfg = configs(kind, att, **NO_DROP)
    return jcfg.replace(use_pallas=False), cfg


def batch_norm_statistics_match_jax(steps):
    """Every BatchNorm's running statistics (the decoder's and the BN
    att_norm's) against JAX's update, torch's running_var unbiased."""
    pm, want, old = steps["pm"], steps["want_stats"], steps["old_stats"]
    counts = steps["bn_counts"]
    mods = dict(pm.named_modules())
    assert counts and set(counts) == {
        n for n, m in mods.items()
        if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)}
    for bn, n in counts.items():
        mod = mods[bn]
        tol = STATS_TOL if ".image_lang_att." in bn else 1e-5
        np.testing.assert_allclose(mod.running_mean.numpy(),
                                   want[f"{bn}.running_mean"].numpy(),
                                   rtol=tol, atol=tol, err_msg=bn)
        v_old = old[f"{bn}.running_var"].numpy()
        biased = (want[f"{bn}.running_var"].numpy()
                  - (1 - MOMENTUM) * v_old) / MOMENTUM
        unbiased = (1 - MOMENTUM) * v_old + MOMENTUM * biased * n / (n - 1)
        np.testing.assert_allclose(mod.running_var.numpy(), unbiased,
                                   rtol=tol, atol=tol, err_msg=bn)
        assert int(mod.num_batches_tracked) == 1


steps = steps_fixture((("pwam", "BN"), ("pwam", "LN"), ("pwam", "none")),
                      variant_configs)


def test_batch_norm_statistics_match_jax(steps):
    batch_norm_statistics_match_jax(steps)
    att = [n for n in steps["bn_counts"] if ".image_lang_att." in n]
    assert len(att) == (8 if steps["name"] == ("pwam", "BN") else 0)


@pytest.mark.parametrize("att", ["BN", "LN"])
def test_att_norm_takes_no_decay(att):
    """JAX names the att_norm `f_query_norm` / `W_norm` and its `norm`
    rule exempts them; the port's reference names `f_query.1` / `W.1`
    take the same label (the reference's rule would decay them)."""
    from lavt_rs_tpu_torch.models.factory import build_model

    pm = build_model(configs("pwam", att)[1], "meta")
    names = [n for n, _ in pm.named_parameters()
             if ".image_lang_att.f_query.1." in n
             or ".image_lang_att.W.1." in n]
    assert len(names) == 16
    for n in names:
        assert optim.label_param(n, optim.TrainConfig()) == "no_decay", n
