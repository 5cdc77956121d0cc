"""Window-7 lavt_one and Swin-T widths: the port against the JAX package,
on the CPU.

A small window-7 lavt_one (embed 48, depths (1, 1, 2, 1), 64² input, one
BERT layer, as test_full_model_parity.py) routes every Swin block to
qkv -> K10 -> proj (`fused_msa_routed` is False at N = 49,
`attn_fwd_supported` True); on CPU tensors K10 and, in training, K10's
save mode and K9 take their plain versions.  A Swin-T-width model
(embed 96: stages 96 / 192 / 384 / 768) at window 12 mixes the routes:
K1 at the unpadded stages 1-2, K11 at the padded stages 3-4, the LN-MLP
tail on K3 at 384 and on the torch chain at 96, 192 and 768, the stage
norms on K4 at 384 and 768 and on the plain row LN at 96 and 192.  Every
JAX variable is drawn from a seeded numpy generator and carried into the
port by `convert/from_jax.py`; the JAX models run their XLA route
(use_pallas=False).  All f32.

Tolerances: logits rtol 1e-3 / atol 2e-4 plus argmax agreement, as
test_torch_model.py; the training step as test_torch_train.py (loss 1e-4
relative; each gradient within 1e-2 of its norm plus 1e-4 G √n).
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
from lavt_rs_tpu_torch.ops import window_attn
from lavt_rs_tpu_torch.train import optim
from lavt_rs_tpu_torch.train.step import create_train_state, make_train_step
from test_torch_model import random_variables
from test_torch_train import _grads_as_state
from torch_threads import torch_threads  # noqa: F401 (autouse fixture)

BERT = dict(vocab_size=120, num_layers=1, intermediate_size=256,
            max_position_embeddings=64, hidden_dropout=0.0, attn_dropout=0.0)
W7 = dict(embed_dim=48, depths=(1, 1, 2, 1), num_heads=(3, 6, 12, 24),
          window_size=7, drop_path_rate=0.0)
TINY12 = dict(embed_dim=96, depths=(1, 1, 1, 1), num_heads=(3, 6, 12, 24),
              window_size=12)
TOKENS = 6


def _pair(swin, img, train=False):
    """(JAX model, its seeded variables, the port model with them)."""
    jcfg = JModelConfig(name="lavt_one", swin=JSwinConfig(**swin),
                        bert=JBertConfig(**BERT), img_size=img,
                        max_tokens=TOKENS, use_pallas=False)
    jm = jbuild_model(jcfg, train=train)
    x = jnp.zeros((1, img, img, 3))
    ids = jnp.ones((1, TOKENS), jnp.int32)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x, ids,
                                            ids))
    shapes = {k: shapes[k] for k in ("params", "batch_stats")}
    variables = random_variables(shapes, np.random.default_rng(7))
    cfg = C.ModelConfig(swin=C.SwinConfig(**swin), bert=C.BertConfig(**BERT),
                        img_size=img, max_tokens=TOKENS, dtype="float32")
    pm = build_model(cfg, device="cpu", train=train)
    pm.load_state_dict(state_dict_from_jax(variables, cfg), strict=True)
    return jm, variables, pm


def _inputs(rng, img, b=2):
    x = rng.standard_normal((b, img, img, 3)).astype(np.float32)
    ids = rng.integers(1, 120, (b, TOKENS)).astype(np.int64)
    mask = np.ones((b, TOKENS), np.int64)
    mask[0, 4:] = 0
    return x, ids, mask


def _logits_match(jm, variables, pm, img):
    x, ids, mask = _inputs(np.random.default_rng(1), img)
    want = np.asarray(jax.jit(jm.apply)(variables, x, ids, mask))
    with torch.no_grad():
        got = pm(*(torch.from_numpy(a) for a in (x, ids, mask))).numpy()
    assert got.shape == (2, img, img, 2)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=2e-4)
    margin = np.abs(want[..., 1] - want[..., 0])
    assert ((got.argmax(-1) == want.argmax(-1)) | (margin < 1e-3)).mean() \
        > 0.9999


@pytest.fixture(scope="module")
def w7_pair():
    return _pair(W7, 64)


def test_window7_blocks_take_the_attention_core_route(w7_pair):
    _, _, pm = w7_pair
    # K10 in all five blocks, K3 and K4 at C = 384 only
    assert pm.backbone.kernel_plan((64, 64), 2, 4) == (
        {"K10": 5, "K3": 1, "K4": 1},
        ["stage 1 LN-MLP tails (C 48): the fused_tail test is False "
         "(C % 128 or C > 512; JAX: XLA): the torch chain",
         "stage 1 norm (C 48): layer_norm_rows_routed is False (C % 128; "
         "JAX: XLA): the plain f32 row LN",
         "stage 2 LN-MLP tails (C 96): the fused_tail test is False "
         "(C % 128 or C > 512; JAX: XLA): the torch chain",
         "stage 2 norm (C 96): layer_norm_rows_routed is False (C % 128; "
         "JAX: XLA): the plain f32 row LN",
         "stage 3 LN-MLP tails (C 192): the fused_tail test is False "
         "(C % 128 or C > 512; JAX: XLA): the torch chain",
         "stage 3 norm (C 192): layer_norm_rows_routed is False (C % 128; "
         "JAX: XLA): the plain f32 row LN"])
    assert [b.attn.route((-(-side // 7)) ** 2, 49, 4)
            for layer, side in zip(pm.backbone.layers, (16, 8, 4, 2))
            for b in layer.blocks] == ["core"] * 5
    # the JAX predicate behind the route, at every stage (N = 49, hd 16)
    for layer, side in zip(pm.backbone.layers, (16, 8, 4, 2)):
        nw = (-(-side // 7)) ** 2
        heads = layer.blocks[0].attn.num_heads
        assert window_attn.attn_fwd_supported(nw, 49, heads, 48 // 3)


def test_window7_logit_parity(w7_pair):
    _logits_match(*w7_pair, 64)


def test_swin_t_widths_window12_logit_parity():
    jm, variables, pm = _pair(TINY12, 96)
    # K1 at the unpadded stages 1-2, K11 at 3-4; K3 at 384; K4 at 384, 768
    assert pm.backbone.kernel_plan((96, 96), 2, 4)[0] == {
        "K1": 2, "K11": 2, "K3": 1, "K4": 2}
    _logits_match(jm, variables, pm, 96)


@pytest.fixture(scope="module")
def w7_steps():
    img = 64
    jm, variables, pm = _pair(W7, img, train=True)
    rng = np.random.default_rng(9)
    mask = np.ones((2, TOKENS), np.int32)
    mask[0, 4:] = 0
    batch = {"image": rng.integers(0, 256, (2, img, img, 3)).astype(np.uint8),
             "ids": rng.integers(1, 120, (2, TOKENS)).astype(np.int32),
             "mask": mask,
             "target": rng.integers(0, 2, (2, img, img)).astype(np.int32)}
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
    ptcfg = optim.TrainConfig()
    pstep = make_train_step(pm, *create_train_state(pm, ptcfg), ptcfg)
    pmetrics = pstep({k: torch.from_numpy(v) for k, v in batch.items()},
                     torch.Generator().manual_seed(3))
    want = state_dict_from_jax(
        {"params": jax.tree.map(np.asarray, new_state.opt_state),
         "batch_stats": jax.tree.map(np.asarray, new_state.batch_stats)},
        pm.cfg)
    return dict(jmetrics=jmetrics, pmetrics=pmetrics, pm=pm, want=want)


def test_window7_train_step_loss_matches_jax(w7_steps):
    assert w7_steps["pm"].backbone.kernel_plan((64, 64), 2, 4, True)[0] == {
        "K10": 5, "K9": 5, "K3": 1, "K7": 1, "K4": 1, "K4b": 1}
    got = float(w7_steps["pmetrics"]["loss"])
    want = float(w7_steps["jmetrics"]["loss"])
    assert got == pytest.approx(want, rel=1e-4)


def test_window7_train_step_grads_match_jax(w7_steps):
    pm, want = w7_steps["pm"], w7_steps["want"]
    params = dict(pm.named_parameters())
    top = max(float(want[n].abs().max()) for n in params)
    checked = 0
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
        checked += "relative_position_bias_table" in name
    assert checked == 5  # K9's dbias reached every block's table
