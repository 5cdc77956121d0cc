"""The port's lavt_one modules against the JAX modules, on the CPU.

One small lavt_one (embed 48, depths (1, 1, 2, 1), window 12, 96² input,
2 BERT layers) is built in both frameworks; every JAX variable is drawn
from a seeded numpy generator (gates non-zero, so PWAM reaches the
residual; non-trivial BatchNorm statistics) and carried into the port by
`convert/from_jax.py`.  Everything runs in f32.  Tolerances: whole-model
logits rtol 1e-3 / atol 2e-4 plus argmax agreement, as
test_full_model_parity.py; modules 1e-4 (f32 sums in another order).
"""

import dataclasses
from typing import Mapping

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lavt_rs_tpu.config import BertConfig as JBertConfig
from lavt_rs_tpu.config import ModelConfig as JModelConfig
from lavt_rs_tpu.config import SwinConfig as JSwinConfig
from lavt_rs_tpu.eval.refcoco_eval import _fwd_iou_for
from lavt_rs_tpu.models import bert as jbert
from lavt_rs_tpu.models import decoder as jdecoder
from lavt_rs_tpu.models import pwam as jpwam
from lavt_rs_tpu.models import swin2d as jswin
from lavt_rs_tpu.models.factory import build_model as jbuild_model
from lavt_rs_tpu_torch import config as C
from lavt_rs_tpu_torch.convert.from_jax import state_dict_from_jax
from lavt_rs_tpu_torch.eval.refcoco_eval import fwd_iou
from lavt_rs_tpu_torch.models.factory import build_model

TOL = 1e-4
SWIN = dict(embed_dim=48, depths=(1, 1, 2, 1), num_heads=(3, 6, 12, 24),
            window_size=12)
BERT = dict(vocab_size=120, num_layers=2, intermediate_size=256,
            max_position_embeddings=64)
IMG, TOKENS = 96, 6


def random_variables(tree: Mapping, rng, name: str = ""):
    """Seeded values for every leaf of a JAX variable tree (of shapes)."""
    if isinstance(tree, Mapping):
        return {k: random_variables(v, rng, k) for k, v in tree.items()}
    shape = tree.shape
    normal = rng.standard_normal(shape)
    if name == "kernel":
        out = normal * float(np.prod(shape[:-1])) ** -0.5
    elif name == "scale":
        out = 1.0 + 0.1 * normal
    elif name == "var":
        out = 1.0 + 0.5 * rng.random(shape)
    elif name in ("embedding", "relative_position_bias_table"):
        out = 0.5 * normal
    else:  # bias, mean
        out = 0.1 * normal
    return out.astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    jcfg = JModelConfig(name="lavt_one", swin=JSwinConfig(**SWIN),
                        bert=JBertConfig(**BERT), img_size=IMG,
                        max_tokens=TOKENS)
    jm = jbuild_model(jcfg)
    img = jnp.zeros((1, IMG, IMG, 3))
    ids = jnp.ones((1, TOKENS), jnp.int32)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), img, ids, ids))
    # init also fills the 'folded' inference cache (the expanded rel-pos
    # biases); apply would read it instead of the tables, so drop it
    shapes = {k: shapes[k] for k in ("params", "batch_stats")}
    variables = random_variables(shapes, np.random.default_rng(7))

    cfg = C.ModelConfig(swin=C.SwinConfig(**SWIN), bert=C.BertConfig(**BERT),
                        img_size=IMG, max_tokens=TOKENS, dtype="float32")
    pm = build_model(cfg, device="cpu")
    pm.load_state_dict(state_dict_from_jax(variables, cfg), strict=True)
    return jcfg, jm, variables, pm


def _inputs(rng, b=2):
    img = rng.standard_normal((b, IMG, IMG, 3)).astype(np.float32)
    ids = rng.integers(1, 120, (b, TOKENS)).astype(np.int64)
    mask = np.ones((b, TOKENS), np.int64)
    mask[0, 4:] = 0
    return img, ids, mask


def test_full_model_logit_parity(pair):
    _, jm, variables, pm = pair
    img, ids, mask = _inputs(np.random.default_rng(1))
    want = np.asarray(jax.jit(jm.apply)(variables, img, ids, mask))
    with torch.no_grad():
        got = pm(*(torch.from_numpy(a) for a in (img, ids, mask))).numpy()
    assert got.shape == (2, IMG, IMG, 2) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=2e-4)
    margin = np.abs(want[..., 1] - want[..., 0])
    agree = (got.argmax(-1) == want.argmax(-1)) | (margin < 1e-3)
    assert agree.mean() > 0.9999


def test_plain_route_equals_kernel_route_on_cpu(pair):
    """use_kernels=False calls the plain versions directly; on CPU tensors
    the kernel wrappers take the same plain versions, in their kernels'
    softmax form (`fused_msa.softmax_form`: the f32 inference kernels'
    exp(min(s, 80)), which the plain route, JAX's XLA route, does not
    take): with the exact form they give the plain route's bits."""
    from unittest import mock

    from lavt_rs_tpu_torch.ops import fused_msa, fused_msa_2d

    jcfg, _, variables, pm = pair
    cfg = dataclasses.replace(pm.cfg, use_kernels=False)
    plain = build_model(cfg, device="cpu")
    plain.load_state_dict(pm.state_dict())
    img, ids, mask = (torch.from_numpy(a) for a in
                      _inputs(np.random.default_rng(2), b=1))
    exact = mock.patch.object(fused_msa, "softmax_form", lambda t, e: True)
    exact_2d = mock.patch.object(fused_msa_2d, "softmax_form",
                                 lambda t, e: True)
    with torch.no_grad(), exact, exact_2d:
        torch.testing.assert_close(plain(img, ids, mask), pm(img, ids, mask),
                                   rtol=0, atol=0)


@pytest.mark.parametrize("hw", [(6, 6), (24, 24)])
def test_swin_block_shifted(pair, hw):
    """layers_2.blocks_1 is a shifted block: at 6x6 it pads to 12 (LN
    outside the MSA; under no_grad the K11 route), at 24x24 it does not
    (the K1 route, LN inside the MSA)."""
    _, _, variables, pm = pair
    c, heads = 4 * SWIN["embed_dim"], SWIN["num_heads"][2]
    x = np.random.default_rng(3).standard_normal((2, hw[0] * hw[1], c)
                                                  ).astype(np.float32)
    jblock = jswin.SwinBlock(dim=c, num_heads=heads, window_size=12,
                             shift_size=6)
    params = variables["params"]["backbone"]["layers_2"]["blocks_1"]
    want = jblock.apply({"params": params}, jnp.asarray(x), hw)
    with torch.no_grad():
        got = pm.backbone.layers[2].blocks[1](torch.from_numpy(x), hw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_pwam_and_gate(pair):
    _, _, variables, pm = pair
    rng = np.random.default_rng(4)
    c = SWIN["embed_dim"]
    x = rng.standard_normal((2, 30, c)).astype(np.float32)
    l = rng.standard_normal((2, TOKENS, 768)).astype(np.float32)
    l_mask = np.ones((2, TOKENS), np.int64)
    l_mask[1, 3:] = 0
    lt = variables["params"]["backbone"]["layers_0"]
    mm = jpwam.PWAM(dim=c).apply({"params": lt["fusion"]}, x, l, l_mask)
    gate = jpwam.LanguageGate(dim=c).apply({"params": lt["res_gate"]}, mm)
    want = jpwam.apply_gate(x, mm, gate, jswin.GateKind.DEFAULT)
    layer = pm.backbone.layers[0]
    xt, lt_, mt = (torch.from_numpy(a) for a in (x, l, l_mask))
    with torch.no_grad():
        mm_t = layer.fusion(xt, lt_, mt)
        got = xt + layer.res_gate(mm_t) * mm_t
    assert float(np.abs(np.asarray(gate)).max()) > 0.01  # the gate is on
    np.testing.assert_allclose(mm_t.numpy(), np.asarray(mm), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_bert_layer(pair):
    jcfg, _, variables, pm = pair
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, TOKENS, 768)).astype(np.float32)
    mask = np.ones((2, TOKENS), np.float32)
    mask[0, 2:] = 0
    bias = ((1.0 - mask)[:, None, None, :] * -10000.0).astype(np.float32)
    params = variables["params"]["text_encoder"]["layer_1"]
    want = jbert.BertLayer(jcfg.bert).apply({"params": params}, x, bias)
    with torch.no_grad():
        got = pm.text_encoder.encoder.layer[1](torch.from_numpy(x),
                                              torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_simple_decoding(pair):
    _, _, variables, pm = pair
    rng = np.random.default_rng(6)
    c = SWIN["embed_dim"]
    feats = [rng.standard_normal((2, 24 // 2 ** i, 24 // 2 ** i, c * 2 ** i)
                                 ).astype(np.float32) for i in range(4)]
    dec = jdecoder.SimpleDecoding(c4_dims=8 * c, nchw_out=True)
    want = dec.apply({"params": variables["params"]["classifier"],
                      "batch_stats": variables["batch_stats"]["classifier"]},
                     feats[3], feats[2], feats[1], feats[0])
    with torch.no_grad():
        got = pm.classifier(*(torch.from_numpy(f) for f in feats[::-1]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_fwd_iou(pair):
    """The inference step: uint8 image, on-device normalize, forward,
    argmax, inter/union against a bit-packed target."""
    _, jm, variables, pm = pair
    rng = np.random.default_rng(8)
    r, s = 2, 2
    image = rng.integers(0, 256, (r, IMG, IMG, 3)).astype(np.uint8)
    ids = rng.integers(1, 120, (r, s, TOKENS)).astype(np.int64)
    mask = np.ones((r, s, TOKENS), np.int64)
    mask[:, 1, 3:] = 0
    target = np.packbits(rng.random((r, IMG * IMG)) > 0.5, axis=1)
    want = _fwd_iou_for(jm.apply)(variables, image, ids, mask, target)
    got = fwd_iou(pm, *(torch.from_numpy(a) for a in (image, ids, mask,
                                                      target)))
    for g, w in zip(got, want):
        assert g.shape == (r, s)
        # pixels whose two logits tie within f32 noise may flip
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=3)
