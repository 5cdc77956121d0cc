"""The port's training step against the JAX package's, on the CPU.

The test_torch_model.py lavt_one (embed 48, depths (1, 1, 2, 1), window
12, 96², 2 BERT layers) with seeded numpy variables runs one JAX
`make_train_step` on the XLA route (use_pallas=False) and one port step
(`train.step.make_train_step`, kernel route: on CPU tensors the autograd
Functions take the plain versions of K1/K2 save mode, K5, K3, K7 and K4).
Everything is f32, DropPath and both BERT dropouts are 0 (the two
frameworks draw different random numbers; DropPath is covered by K8's
explicit keep in test_torch_train_kernels_plain.py and by the structural
tests here).  The JAX step's optimizer is a transform that returns zero
updates and keeps the gradients as its state, so the gradients are read
exactly.

Tolerances:
  * loss: 1e-4 relative (f32 sums in another order);
  * gradients: per parameter, ‖got − want‖ ≤ 1e-2 ‖want‖ + 1e-4 G √n,
    G the largest gradient magnitude of the model and n the parameter's
    size.  The classifier's gradients agree to ~1e-6; below the decoder's
    first train-mode BatchNorm + ReLU they differ by ~1e-3 (worst
    4.4e-3, measured), since a pre-activation within f32 rounding of 0
    may take the other ReLU branch in the two frameworks.  The second
    term covers gradients that are 0 in exact arithmetic (biases in front
    of an InstanceNorm or a softmax), which both frameworks give as f32
    noise of ~1e-9;
  * BatchNorm running statistics within 1e-5.  torch updates running_var
    with the unbiased batch variance (n / (n − 1)), flax with the biased
    one; the test applies that factor to the JAX update (ROADMAP.md §3);
  * AdamW against optax on identical gradients: parameters within 1e-6
    relative to their magnitude, 4 steps of the poly schedule (or of
    fix_lr's constant one), amsgrad on and off;
  * losses and their gradients against lavt_rs_tpu.losses: 1e-5;
    batch_iou: exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn as nn

from lavt_rs_tpu import losses as jlosses
from lavt_rs_tpu.config import BertConfig as JBertConfig
from lavt_rs_tpu.config import ModelConfig as JModelConfig
from lavt_rs_tpu.config import SwinConfig as JSwinConfig
from lavt_rs_tpu.metrics import batch_iou as jbatch_iou
from lavt_rs_tpu.models.factory import build_model as jbuild_model
from lavt_rs_tpu.train import optim as joptim
from lavt_rs_tpu.train.step import TrainState
from lavt_rs_tpu.train.step import make_train_step as jmake_train_step
from lavt_rs_tpu_torch import config as C
from lavt_rs_tpu_torch import losses
from lavt_rs_tpu_torch.convert.from_jax import state_dict_from_jax
from lavt_rs_tpu_torch.metrics import batch_iou
from lavt_rs_tpu_torch.models.factory import build_model
from lavt_rs_tpu_torch.models.swin2d import SwinBlock
from lavt_rs_tpu_torch.ops.dropout import (drop_path, drop_path_kept,
                                           drop_path_scale)
from lavt_rs_tpu_torch.train import optim
from lavt_rs_tpu_torch.train.step import create_train_state, make_train_step
from test_torch_model import BERT, IMG, SWIN, TOKENS, random_variables

TOL = 1e-4
NO_DROP_SWIN = dict(SWIN, drop_path_rate=0.0)
NO_DROP_BERT = dict(BERT, hidden_dropout=0.0, attn_dropout=0.0)
# decoder BatchNorm -> elements per channel at 96², batch 2
BN_ELEMS = {"bn1_4": 72, "bn2_4": 72, "bn1_3": 288, "bn2_3": 288,
            "bn1_2": 1152, "bn2_2": 1152}


def _close(got, want, name=""):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got)
    want = np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=TOL,
                               atol=TOL * float(np.abs(want).max()),
                               err_msg=name)


def _batch(rng, b=2):
    mask = np.ones((b, TOKENS), np.int32)
    mask[0, 4:] = 0
    return {"image": rng.integers(0, 256, (b, IMG, IMG, 3)).astype(np.uint8),
            "ids": rng.integers(1, 120, (b, TOKENS)).astype(np.int32),
            "mask": mask,
            "target": rng.integers(0, 2, (b, IMG, IMG)).astype(np.int32)}


def _grads_as_state():
    """An optax transform whose update is zero and whose state is the
    last gradient tree."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


@pytest.fixture(scope="module")
def steps():
    jcfg = JModelConfig(name="lavt_one", swin=JSwinConfig(**NO_DROP_SWIN),
                        bert=JBertConfig(**NO_DROP_BERT), img_size=IMG,
                        max_tokens=TOKENS, use_pallas=False)
    jm = jbuild_model(jcfg, train=True)
    img = jnp.zeros((1, IMG, IMG, 3))
    ids = jnp.ones((1, TOKENS), jnp.int32)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), img, ids,
                                            ids))
    shapes = {k: shapes[k] for k in ("params", "batch_stats")}
    variables = random_variables(shapes, np.random.default_rng(7))
    batch = _batch(np.random.default_rng(9))

    tcfg = joptim.TrainConfig()
    state = TrainState(step=jnp.zeros((), jnp.int32),
                       params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       opt_state=jax.tree.map(jnp.zeros_like,
                                              variables["params"]))
    jstep = jax.jit(jmake_train_step(jm, _grads_as_state(), tcfg))
    new_state, jmetrics = jstep(state, {k: jnp.asarray(v)
                                        for k, v in batch.items()},
                                jax.random.PRNGKey(3))

    cfg = C.ModelConfig(swin=C.SwinConfig(**NO_DROP_SWIN),
                        bert=C.BertConfig(**NO_DROP_BERT), img_size=IMG,
                        max_tokens=TOKENS, dtype="float32")
    pm = build_model(cfg, device="cpu", train=True)
    pm.load_state_dict(state_dict_from_jax(variables, cfg), strict=True)
    ptcfg = optim.TrainConfig()
    opt, sched = create_train_state(pm, ptcfg)
    pstep = make_train_step(pm, opt, sched, ptcfg)
    pmetrics = pstep({k: torch.from_numpy(v) for k, v in batch.items()},
                     torch.Generator().manual_seed(3))
    want_grads = state_dict_from_jax(
        {"params": jax.tree.map(np.asarray, new_state.opt_state),
         "batch_stats": jax.tree.map(np.asarray, new_state.batch_stats)}, cfg)
    want_stats = state_dict_from_jax(
        {"params": variables["params"],
         "batch_stats": jax.tree.map(np.asarray, new_state.batch_stats)}, cfg)
    old_stats = state_dict_from_jax(variables, cfg)
    return dict(jm=jm, variables=variables, jmetrics=jmetrics, pm=pm,
                pmetrics=pmetrics, want_grads=want_grads,
                want_stats=want_stats, old_stats=old_stats)


def test_train_step_loss_and_metrics_match_jax(steps):
    jm, pm = steps["jmetrics"], steps["pmetrics"]
    _close(pm["loss"], jm["loss"], "loss")
    assert pm["lr"] == pytest.approx(float(jm["lr"]), rel=1e-6)  # f32 in JAX
    # iou counts argmax pixels: a pixel whose two logits tie within f32
    # noise may flip
    assert abs(float(pm["iou"]) - float(jm["iou"])) < 1e-3


def test_train_step_grads_match_jax(steps):
    pm, want = steps["pm"], steps["want_grads"]
    params = dict(pm.named_parameters())
    top = max(float(want[n].abs().max()) for n in params)
    for name, p in params.items():
        w = want[name].numpy()
        if p.grad is None:  # unused: the last stage's gate
            assert name.startswith("backbone.layers.3.res_gate"), name
            assert not w.any(), name
            continue
        g = p.grad.numpy()
        assert g.shape == w.shape, name
        bound = 1e-2 * np.linalg.norm(w) + 1e-4 * top * np.sqrt(w.size)
        assert np.linalg.norm(g - w) <= bound, (name, np.linalg.norm(g - w),
                                                np.linalg.norm(w))


def test_train_step_batch_norm_statistics_match_jax(steps):
    pm, want, old = steps["pm"], steps["want_stats"], steps["old_stats"]
    momentum = 0.1
    for bn, n in BN_ELEMS.items():
        mod = getattr(pm.classifier, bn)
        key = f"classifier.{bn}"
        np.testing.assert_allclose(mod.running_mean.numpy(),
                                   want[f"{key}.running_mean"].numpy(),
                                   rtol=1e-5, atol=1e-5)
        v_old = old[f"{key}.running_var"].numpy()
        biased = (want[f"{key}.running_var"].numpy()
                  - (1 - momentum) * v_old) / momentum
        unbiased_update = (1 - momentum) * v_old + momentum * biased * n / (n - 1)
        np.testing.assert_allclose(mod.running_var.numpy(), unbiased_update,
                                   rtol=1e-5, atol=1e-5)
        assert int(mod.num_batches_tracked) == 1


def test_label_param_matches_jax_on_mapped_names(steps):
    """Each JAX leaf labelled by lavt_rs_tpu's label_param, carried to the
    port's names by state_dict_from_jax, against the port's label_param."""
    codes = {"decay": 1.0, "no_decay": 2.0, "frozen": 3.0}
    tcfg = joptim.TrainConfig()

    def label_tree(tree, path=()):
        if isinstance(tree, dict):
            return {k: label_tree(v, path + (k,)) for k, v in tree.items()}
        return np.full(np.shape(tree),
                       codes[joptim.label_param("/".join(path), tcfg)],
                       np.float32)

    variables = steps["variables"]
    mapped = state_dict_from_jax(
        {"params": label_tree(variables["params"]),
         "batch_stats": variables["batch_stats"]}, steps["pm"].cfg)
    ptcfg = optim.TrainConfig()
    seen = set()
    for name, _ in steps["pm"].named_parameters():
        want = np.unique(mapped[name].numpy())
        assert want.size == 1, name
        assert codes[optim.label_param(name, ptcfg)] == want[0], name
        seen.add(optim.label_param(name, ptcfg))
    assert seen == {"decay", "no_decay", "frozen"}


# (port name, JAX path) pairs covering the three labels
_OPT_PARAMS = (
    ("backbone.layers.0.blocks.0.norm1.weight",
     "backbone/layers_0/blocks_0/norm1/scale", (8,)),
    ("backbone.layers.0.blocks.0.attn.relative_position_bias_table",
     "backbone/layers_0/blocks_0/attn/relative_position_bias_table", (9, 2)),
    ("backbone.layers.0.blocks.0.attn.qkv.weight",
     "backbone/layers_0/blocks_0/attn/qkv/kernel", (6, 4)),
    ("classifier.bn1_4.weight", "classifier/fuse4_a/bn/scale", (5,)),
    ("text_encoder.encoder.layer.0.intermediate.dense.weight",
     "text_encoder/layer_0/intermediate/kernel", (4, 3)),
    ("text_encoder.encoder.layer.10.output.dense.weight",
     "text_encoder/layer_10/output/kernel", (3, 3)),
    ("text_encoder.embeddings.word_embeddings.weight",
     "text_encoder/word_embeddings/embedding", (7, 2)),
)


def _module_with(named):
    root = nn.Module()
    for name, value in named.items():
        *parents, leaf = name.split(".")
        m = root
        for part in parents:
            if not hasattr(m, part):
                m.add_module(part, nn.Module())
            m = getattr(m, part)
        m.register_parameter(leaf, nn.Parameter(torch.from_numpy(value.copy())))
    return root


def _nest(flat):
    tree = {}
    for path, value in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = value
    return tree


@pytest.mark.parametrize("amsgrad,fix_lr", [(False, False), (True, False),
                                            (False, True)])
def test_adamw_matches_optax_over_poly_schedule(amsgrad, fix_lr):
    rng = np.random.default_rng(11)
    init = {n: rng.standard_normal(s).astype(np.float32)
            for n, _, s in _OPT_PARAMS}
    jpath = {n: p for n, p, _ in _OPT_PARAMS}
    kw = dict(lr=1e-2, iters_per_epoch=6, epochs=1, amsgrad=amsgrad,
              fix_lr=fix_lr)
    model = _module_with(init)
    opt, sched = optim.build_optimizer(model, optim.TrainConfig(**kw))
    jparams = _nest({jpath[n]: jnp.asarray(v) for n, v in init.items()})
    tx = joptim.build_optimizer(jparams, joptim.TrainConfig(**kw))
    jstate = tx.init(jparams)
    params = dict(model.named_parameters())
    for _ in range(4):
        grads = {n: rng.standard_normal(v.shape).astype(np.float32)
                 for n, v in init.items()}
        for n, p in params.items():
            p.grad = torch.from_numpy(grads[n])
        opt.step()
        sched.step()
        updates, jstate = tx.update(
            _nest({jpath[n]: jnp.asarray(g) for n, g in grads.items()}),
            jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for n, p in params.items():
            node = jparams
            for part in jpath[n].split("/"):
                node = node[part]
            want = np.asarray(node)
            np.testing.assert_allclose(p.detach().numpy(), want, rtol=1e-6,
                                       atol=1e-6 * float(np.abs(want).max()),
                                       err_msg=n)
    # the frozen parameters never moved
    for n in ("text_encoder.encoder.layer.10.output.dense.weight",
              "text_encoder.embeddings.word_embeddings.weight"):
        np.testing.assert_array_equal(params[n].detach().numpy(), init[n])


@pytest.mark.parametrize("name", sorted(losses.LOSSES))
def test_losses_match_jax(name):
    rng = np.random.default_rng(13)
    logits = (rng.standard_normal((2, 24, 24, 2)) * 2).astype(np.float32)
    target = (rng.random((2, 24, 24)) > 0.6).astype(np.int32)
    jfn = jlosses.get_loss(name)
    want, want_g = jax.value_and_grad(jfn)(jnp.asarray(logits),
                                           jnp.asarray(target))
    lt = torch.from_numpy(logits).requires_grad_()
    got = losses.get_loss(name)(lt, torch.from_numpy(target).long())
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(want_g), rtol=1e-5,
                               atol=1e-5 * float(np.abs(want_g).max()))


def test_batch_iou_matches_jax():
    rng = np.random.default_rng(17)
    logits = rng.standard_normal((3, 16, 16, 2)).astype(np.float32)
    target = (rng.random((3, 16, 16)) > 0.5).astype(np.int32)
    want = jbatch_iou(jnp.asarray(logits), jnp.asarray(target))
    got = batch_iou(torch.from_numpy(logits), torch.from_numpy(target))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_drop_path_keeps_or_zeroes_whole_samples():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(64, 10, 3)
    y = drop_path(x, 0.3, True, g)
    for i in range(64):
        dropped = bool((y[i] == 0).all())
        assert dropped or torch.allclose(y[i], x[i] / 0.7)
    assert 0 < sum(bool((y[i] == 0).all()) for i in range(64)) < 64
    keep = drop_path_scale(drop_path_kept(64, 0.3, True, g, "cpu"), 0.3)
    assert set(keep.tolist()) <= {0.0, float(torch.tensor(1.0 / 0.7))}
    assert drop_path(x, 0.3, False, None) is x  # eval mode: no draw


def test_swin_block_drop_path_routes_match_and_draw_per_sample():
    """A block in train mode with DropPath: the kernel route (the
    Functions, K8 for the tail) and the plain route give the same output
    from one generator seed; a sample whose two draws both drop passes x
    through unchanged."""
    torch.manual_seed(0)
    blocks = [SwinBlock(48, 3, 12, 6, use_kernels=k, drop_path_rate=0.5)
              for k in (True, False)]
    blocks[1].load_state_dict(blocks[0].state_dict())
    x = torch.randn(16, 24 * 24, 48)
    outs = []
    for blk in blocks:
        blk.train()
        outs.append(blk(x, (24, 24), torch.Generator().manual_seed(5)))
    torch.testing.assert_close(outs[0], outs[1], rtol=1e-5, atol=1e-5)
    g = torch.Generator().manual_seed(5)  # the block's two draws, in order
    attn_kept = torch.rand((16,), generator=g) < 0.5
    tail_kept = torch.rand((16,), generator=g) < 0.5
    both_dropped = ~attn_kept & ~tail_kept
    assert bool(both_dropped.any())
    torch.testing.assert_close(outs[0][both_dropped], x[both_dropped])


def test_kernel_and_plain_routes_draw_the_same_dropout():
    """With every dropout on, the two routes of one small model take the
    same draws from one seed and give the same loss gradient (CPU)."""
    cfg = C.ModelConfig(swin=C.SwinConfig(embed_dim=32, depths=(1, 1, 2, 1),
                                          num_heads=(1, 2, 4, 8)),
                        bert=C.BertConfig(vocab_size=50, num_layers=1,
                                          intermediate_size=64,
                                          max_position_embeddings=16),
                        fusion=C.FusionConfig(dropout=0.1),
                        img_size=96, max_tokens=4, dtype="float32")
    models = [build_model(dataclasses.replace(cfg, use_kernels=k), "cpu",
                          torch.Generator().manual_seed(0), train=True)
              for k in (True, False)]
    rng = np.random.default_rng(19)
    b = _batch(rng, 2)
    img = torch.from_numpy(rng.standard_normal((2, 96, 96, 3)).astype(np.float32))
    ids = torch.from_numpy(b["ids"][:, :4] % 50).long()
    mask = torch.ones(2, 4, dtype=torch.long)
    outs = []
    for m in models:
        out = m(img, ids, mask, generator=torch.Generator().manual_seed(2))
        out.square().mean().backward()
        outs.append((out, m.backbone.layers[2].blocks[1].attn.qkv.weight.grad))
    torch.testing.assert_close(outs[0][0], outs[1][0], rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(outs[0][1], outs[1][1], rtol=1e-4, atol=1e-6)
