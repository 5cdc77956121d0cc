"""The training step of the port's other families against the JAX
package's, on the CPU, in f32: lavt and lts here, vlt and lavt_vlt in
test_torch_train_families_vlt.py (on this file's `steps_fixture`).

Each family's small model of test_torch_families.py, with DropPath and
both BERT dropouts at 0 (the frameworks draw different random numbers),
takes one JAX `make_train_step` on the XLA route (use_pallas=False) and
one port step (`train.step.make_train_step`, kernel route: on CPU
tensors the autograd Functions take their plain versions), from seeded
numpy variables carried by `convert/from_jax.py`.  The JAX step's
optimizer returns zero updates and keeps the gradients as its state (as
test_torch_train.py).

  * loss within 1e-4 relative;
  * every Swin block's gradient (its parameters concatenated) at cosine
    >= 0.999 with JAX's, and the whole model's;
  * every BatchNorm's running statistics within 1e-5, torch's running_var
    taking the unbiased batch variance (n / (n - 1), n the elements a
    channel) where flax takes the biased one (ROADMAP.md §3); one VLT
    BatchNorm's within 1e-3 (`STATS_TOL`: flax's fast variance in the
    BatchNorm1d before it, pinned in test_torch_train_families_vlt.py);
  * the parameter groups equal JAX `label_param`'s on the mapped names
    (lavt's `bert_model.` as `text_encoder.`, `model.backbone.` as
    `backbone.`);
  * 16 steps of each family's tiny model on one batch lower the loss, as
    the JAX package's test_zoo_train_step_descends.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lavt_rs_tpu.config import BertConfig as JBertConfig
from lavt_rs_tpu.config import ModelConfig as JModelConfig
from lavt_rs_tpu.config import SwinConfig as JSwinConfig
from lavt_rs_tpu.models.factory import build_model as jbuild_model
from lavt_rs_tpu.train import optim as joptim
from lavt_rs_tpu.train.step import TrainState
from lavt_rs_tpu.train.step import make_train_step as jmake_train_step
from lavt_rs_tpu_torch import config as C
from lavt_rs_tpu_torch.convert.from_jax import state_dict_from_jax
from lavt_rs_tpu_torch.models.factory import build_model
from lavt_rs_tpu_torch.train import optim
from lavt_rs_tpu_torch.train.step import create_train_state, make_train_step
from test_torch_families import FAMILIES, IMG, TOKENS, jax_shapes
from test_torch_model import BERT, SWIN, random_variables
from test_torch_train import _batch, _grads_as_state
from torch_threads import torch_threads  # noqa: F401 (autouse fixture)

NO_DROP_SWIN = dict(SWIN, drop_path_rate=0.0)
NO_DROP_BERT = dict(BERT, hidden_dropout=0.0, attn_dropout=0.0)
LOSS_RTOL, MIN_COS = 1e-4, 0.999
MOMENTUM = 0.1
# VLT's joint_threshold BatchNorm normalizes x_c4 times the sentence vector,
# whose BatchNorm1d over a batch of 2 flax computes with its fast variance
# E[x²] − E[x]²: 1.4e-3 from the exact value on this batch, the port's
# 9e-6 (test_sentence_batch_norm_variance_form).  Its running statistics
# follow at up to 6.5e-4 (4.4e-4 relative) and are held at 1e-3 abs + rel;
# every other statistic at 1e-5.
STATS_TOL = {"classifier.joint_threshold.0": 1e-3}


def _configs(name):
    jcfg = JModelConfig(name=name, swin=JSwinConfig(**NO_DROP_SWIN),
                        bert=JBertConfig(**NO_DROP_BERT), img_size=IMG,
                        max_tokens=TOKENS, use_pallas=False)
    cfg = C.ModelConfig(name=name, swin=C.SwinConfig(**NO_DROP_SWIN),
                        bert=C.BertConfig(**NO_DROP_BERT), img_size=IMG,
                        max_tokens=TOKENS, dtype="float32")
    return jcfg, cfg


def _bn_counts(model):
    """Forward hooks recording each BatchNorm's elements per channel."""
    counts = {}

    def record(name):
        def hook(mod, args, out):
            counts[name] = args[0].numel() // args[0].shape[1]
        return hook

    for name, m in model.named_modules():
        if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
            m.register_forward_hook(record(name))
    return counts


def steps_fixture(families, configs=None):
    """The module fixture `steps`: one family's JAX and port steps a
    parameter (the families are split over two files, each under ~90 s
    in the tier-1 run's workers); `configs(param)` -> (JAX config, port
    config), by default the family `param`'s small model."""
    def steps(request):
        return _steps(request, configs or _configs)

    return pytest.fixture(scope="module", params=families,
                          name="steps")(steps)


def _steps(request, configs):
    name = request.param
    jcfg, cfg = configs(name)
    jm = jbuild_model(jcfg, train=True)
    variables = random_variables(jax_shapes(jm), np.random.default_rng(7))
    batch = _batch(np.random.default_rng(9))
    batch = dict(batch, image=batch["image"][:, :IMG, :IMG],
                 ids=batch["ids"][:, :TOKENS], mask=batch["mask"][:, :TOKENS],
                 target=batch["target"][:, :IMG, :IMG])

    state = TrainState(step=jnp.zeros((), jnp.int32),
                       params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       opt_state=jax.tree.map(jnp.zeros_like,
                                              variables["params"]))
    jstep = jax.jit(jmake_train_step(jm, _grads_as_state(),
                                     joptim.TrainConfig()))
    new_state, jmetrics = jstep(state, {k: jnp.asarray(v)
                                        for k, v in batch.items()},
                                jax.random.PRNGKey(3))

    pm = build_model(cfg, device="cpu", train=True)
    pm.load_state_dict(state_dict_from_jax(variables, cfg), strict=True)
    bn_counts = _bn_counts(pm)
    ptcfg = optim.TrainConfig()
    opt, sched = create_train_state(pm, ptcfg)
    pmetrics = make_train_step(pm, opt, sched, ptcfg)(
        {k: torch.from_numpy(v) for k, v in batch.items()},
        torch.Generator().manual_seed(3))
    new_stats = jax.tree.map(np.asarray, new_state.batch_stats)
    return dict(
        name=name, cfg=cfg, pm=pm, variables=variables, jmetrics=jmetrics,
        pmetrics=pmetrics, bn_counts=bn_counts,
        want_grads=state_dict_from_jax(
            {"params": jax.tree.map(np.asarray, new_state.opt_state),
             "batch_stats": new_stats}, cfg),
        want_stats=state_dict_from_jax(
            {"params": variables["params"], "batch_stats": new_stats}, cfg),
        old_stats=state_dict_from_jax(variables, cfg))


steps = steps_fixture(("lavt", "lts"))


def _cos(a, b):
    return float(a @ b / max(float(a.norm() * b.norm()), 1e-30))


def test_loss_matches_jax(steps):
    got, want = float(steps["pmetrics"]["loss"]), float(steps["jmetrics"]["loss"])
    assert abs(got - want) <= LOSS_RTOL * abs(want), (steps["name"], got, want)
    assert abs(float(steps["pmetrics"]["iou"])
               - float(steps["jmetrics"]["iou"])) < 1e-3


def test_block_gradients_match_jax(steps):
    pm, want = steps["pm"], steps["want_grads"]
    blocks, got_all, want_all = {}, [], []
    for name, p in pm.named_parameters():
        w = want[name].flatten()
        g = (p.grad if p.grad is not None else torch.zeros_like(p)).flatten()
        if p.grad is None:  # the last stage's gate feeds no output (with
            # lazy_pred its fusion neither: the stage outputs are pre-fusion)
            unused = ((".layers.3.res_gate.", ".layers.3.fusion.")
                      if steps["cfg"].lazy_pred else (".layers.3.res_gate.",))
            assert any(u in name for u in unused) and not w.any(), name
        got_all.append(g)
        want_all.append(w)
        parts = name.removeprefix("model.").split(".")
        if parts[0] == "backbone" and parts[3:4] == ["blocks"]:
            pair = blocks.setdefault(".".join(parts[1:5]), ([], []))
            pair[0].append(g)
            pair[1].append(w)
    assert len(blocks) == sum(SWIN["depths"])
    for key, (g, w) in blocks.items():
        cos = _cos(torch.cat(g), torch.cat(w))
        assert cos >= MIN_COS, (steps["name"], key, cos)
    assert _cos(torch.cat(got_all), torch.cat(want_all)) >= MIN_COS


def test_batch_norm_statistics_match_jax(steps):
    pm, want, old = steps["pm"], steps["want_stats"], steps["old_stats"]
    counts = steps["bn_counts"]
    mods = dict(pm.named_modules())
    assert counts and set(counts) == {
        n for n, m in mods.items()
        if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)}
    for bn, n in counts.items():
        mod = mods[bn]
        tol = STATS_TOL.get(bn, 1e-5)
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


def test_label_param_matches_jax(steps):
    """JAX label_param on each JAX leaf, carried to the port's names,
    against the port's; lavt's BERT (`bert_model.`) and backbone
    (`model.backbone.`) take lavt_one's rules."""
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
         "batch_stats": variables["batch_stats"]}, steps["cfg"])
    seen = set()
    for name, _ in steps["pm"].named_parameters():
        want = np.unique(mapped[name].numpy())
        label = optim.label_param(name, optim.TrainConfig())
        assert want.size == 1 and codes[label] == want[0], name
        seen.add(label)
    assert seen == {"decay", "no_decay", "frozen"}


def _tiny(name):
    """The JAX test_model_zoo.py model (embed 32, window 4, one BERT layer,
    5 tokens) at 32²."""
    return C.ModelConfig(
        name=name, swin=C.SwinConfig(embed_dim=32, depths=(1, 1, 1, 1),
                                     num_heads=(2, 4, 8, 16), window_size=4,
                                     drop_path_rate=0.0),
        bert=C.BertConfig(vocab_size=64, num_layers=1), img_size=32,
        max_tokens=5, dtype="float32")


@pytest.mark.parametrize("name", FAMILIES)
def test_train_steps_descend(name):
    """16 AdamW steps (lr 1e-3, dice) on one fixed batch lower the loss
    and leave the frozen BERT layers' parameters (none at one layer:
    the embeddings) untouched."""
    rng = np.random.default_rng(0)
    b = 2
    batch = {
        "image": torch.from_numpy(rng.standard_normal((b, 32, 32, 3))
                                  .astype(np.float32)),
        "ids": torch.from_numpy(rng.integers(1, 64, (b, 5))),
        "mask": torch.ones(b, 5, dtype=torch.long),
        "target": torch.from_numpy(rng.integers(0, 2, (b, 32, 32))),
    }
    model = build_model(_tiny(name), "cpu", torch.Generator().manual_seed(0),
                        train=True)
    tcfg = optim.TrainConfig(lr=1e-3, iters_per_epoch=100, epochs=1,
                             loss="dice")
    step = make_train_step(model, *create_train_state(model, tcfg), tcfg)
    bert = "bert_model" if name == "lavt" else "text_encoder"
    emb = dict(model.named_parameters())[
        f"{bert}.embeddings.word_embeddings.weight"]
    before = emb.detach().clone()
    losses = [float(step(batch, torch.Generator().manual_seed(1))["loss"])
              for _ in range(16)]
    assert np.isfinite(losses).all(), (name, losses)
    assert min(losses[-3:]) < losses[0], (name, losses)
    assert torch.equal(emb.detach(), before)
