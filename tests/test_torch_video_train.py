"""The port's lavt_video training path against the JAX package's, on the CPU.

K9's plain version (`window_attn.attention_core_bwd_plain`) is held to the
JAX kernel `attention_core_bwd` in `pltpu.force_tpu_interpret_mode()` at
N = 49 and 196, and to `jax.vjp` of the XLA attention at N = 392, where
the JAX kernel does not run (`_attn_bwd_tiling` gates N <= 256); all in
f32, within 2e-4 abs + rel as the module's other tests.  The autograd
Function (`WindowAttention`: K10 save mode + K9, their plain versions
here) is held to autograd through K10's plain version.

One whole video training step: the small lavt_video of
tests/test_torch_video.py (embed 32, depths (2, 2, 2, 2), heads
(1, 2, 4, 8), 4-frame 64² clips, 1 BERT layer), batch 2 with annotated
frames 1 and 3, seeded numpy variables carried into the port by
`convert/from_jax.py`, runs one JAX `make_video_train_step` on the XLA
route and one port `make_video_train_step` (kernel route: every 3D block
through the Function), everything f32 with DropPath and every dropout 0
(the frameworks draw different numbers).  The JAX optimizer is the
zero-update transform that keeps the gradients, so they are read exactly.
Tolerances as tests/test_torch_train.py states them: loss 1e-4 relative;
each gradient ‖got − want‖ ≤ 1e-2 ‖want‖ + 1e-4 G √n; BatchNorm running
statistics 1e-5 after the unbiased-variance factor.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from lavt_rs_tpu import config as JC
from lavt_rs_tpu.models.factory import build_model as jbuild_model
from lavt_rs_tpu.ops import attention as jattn
from lavt_rs_tpu.ops.pallas import window_attn as jwattn
from lavt_rs_tpu.train import optim as joptim
from lavt_rs_tpu.train.step import TrainState
from lavt_rs_tpu.train.step import make_video_train_step as jmake_video_step
from lavt_rs_tpu_torch import config as C
from lavt_rs_tpu_torch.convert.from_jax import state_dict_from_jax
from lavt_rs_tpu_torch.models import swin3d, tpwam
from lavt_rs_tpu_torch.models.factory import build_model
from lavt_rs_tpu_torch.ops import fused_msa, window_attn
from lavt_rs_tpu_torch.ops.window import (relative_bias_from_table_3d,
                                          shift_mask_3d)
from lavt_rs_tpu_torch.train import optim
from lavt_rs_tpu_torch.train.step import (create_train_state,
                                          make_video_train_step)
from test_torch_model import random_variables
from test_torch_train import _close, _grads_as_state
from test_torch_video import (BERT, IMG, SWIN, T, TOKENS, _grouped_at,
                              _qkv_bias_mask, _t)
from torch_threads import torch_threads  # noqa: F401 (autouse fixture)

TOL = 2e-4
SCALE = 32 ** -0.5
B = 2
VALID = (1, 3)
NO_DROP_SWIN = dict(SWIN, drop_path_rate=0.0)
NO_DROP_BERT = dict(BERT, hidden_dropout=0.0, attn_dropout=0.0)
# decoder BatchNorm -> elements per channel at 64², B·T = 8 frames
BN_ELEMS = {"bn1_4": 128, "bn2_4": 128, "bn1_3": 512, "bn2_3": 512,
            "bn1_2": 2048, "bn2_2": 2048}


def _allclose(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


# -- K9's plain version ----------------------------------------------------------

def _bwd_inputs(rng, n, masked):
    args = _qkv_bias_mask(rng, 1, 2, 2, n, 32, masked)
    do = rng.standard_normal(args[0].shape).astype(np.float32)
    return args, do


def _plain_bwd(args, do):
    t = [None if a is None else _t(a) for a in args]
    return window_attn.attention_core_bwd_plain(*t, _t(do), SCALE)


@pytest.mark.parametrize("n", [49, 196])
@pytest.mark.parametrize("masked", [False, True])
def test_attention_core_bwd_plain_vs_pallas(rng, n, masked):
    """dq, dk, dv and dbias against the JAX kernel in interpret mode."""
    args, do = _bwd_inputs(rng, n, masked)
    jargs = [None if a is None else jnp.asarray(a) for a in args]
    with pltpu.force_tpu_interpret_mode():
        want = jwattn.attention_core_bwd(*jargs, jnp.asarray(do), SCALE)
    for got, w in zip(_plain_bwd(args, do), want[:4]):
        assert got.dtype == torch.float32 and got.shape == w.shape
        _allclose(got.numpy(), w)


@pytest.mark.parametrize("masked", [False, True])
def test_attention_core_bwd_plain_vs_xla_vjp(rng, masked):
    """At N = 392 (an 8-frame window) against jax.vjp of the XLA attention:
    the bias cotangent is dbias."""
    args, do = _bwd_inputs(rng, 392, masked)
    q, k, v, bias, mask = (None if a is None else jnp.asarray(a) for a in args)
    _, vjp = jax.vjp(lambda *t: jattn.window_attention_xla(*t, mask,
                                                           scale=SCALE),
                     q, k, v, bias)
    want = vjp(jnp.asarray(do))
    for got, w in zip(_plain_bwd(args, do), want):
        _allclose(got.numpy(), w)


@pytest.mark.parametrize("masked", [False, True])
def test_window_attention_function_backward(rng, masked):
    """`window_attention` under autograd goes through `WindowAttention`
    (K10 save mode + K9, plain here), whose backward agrees with autograd
    through K10's plain version."""
    args = [None if a is None else _t(a)
            for a in _qkv_bias_mask(rng, 2, 3, 2, 98, 32, masked)]
    do = torch.randn(args[0].shape, generator=torch.Generator().manual_seed(4))
    grads = []
    for fn in (window_attn.window_attention,
               window_attn.window_attention_plain):
        leaves = [a.clone().requires_grad_() for a in args[:4]]
        out = fn(*leaves, args[4], SCALE)
        if fn is window_attn.window_attention:
            assert type(out.grad_fn).__name__ == "WindowAttentionBackward"
        grads.append(torch.autograd.grad(out, leaves, do))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)


def test_relative_bias_table_gets_its_gradient():
    """In training the 3D attention gathers its bias with grad: the table's
    gradient equals autograd through the plain gather and attention; at
    inference the gathered bias is cached."""
    torch.manual_seed(0)
    c, heads, ws, n = 64, 2, (2, 7, 7), 98
    m = swin3d.WindowAttention3D(c, ws, heads).train()
    with torch.no_grad():
        m.relative_position_bias_table.normal_()
    x = torch.randn(2, 3, n, c)
    mask = shift_mask_3d(2, 7, 21, ws, (1, 3, 3), "cpu")
    w = torch.randn(2, 3, n, c)
    (m(x, mask) * w).sum().backward()
    got = m.relative_position_bias_table.grad
    assert got is not None and bool(got.abs().sum() > 0)

    table = m.relative_position_bias_table.detach().clone().requires_grad_()
    bias = relative_bias_from_table_3d(table, m.relative_position_index, n)
    qkv = m.qkv(x).view(2, 3, n, 3, heads, c // heads)
    q, k, v = qkv.permute(3, 0, 1, 4, 2, 5)
    out = window_attn.window_attention_plain(q, k, v, bias, mask, m.scale)
    ref = m.proj(out.transpose(2, 3).reshape(2, 3, n, c))
    (ref * w).sum().backward()
    torch.testing.assert_close(got, table.grad, rtol=1e-4, atol=1e-5)

    with torch.no_grad():
        assert m.relative_bias(n) is m.relative_bias(n)


# -- structure -------------------------------------------------------------------

def test_swin_block3d_drop_path_draws_per_sample():
    """A train-mode block draws DropPath per sample, attention branch first
    and then the MLP's, from the generator; the kernel and plain routes take
    the same draws; a sample whose two draws both drop passes unchanged."""
    torch.manual_seed(0)
    blocks = [swin3d.SwinBlock3D(32, 1, (2, 7, 7), (1, 3, 3), use_kernels=k,
                                 drop_path_rate=0.5) for k in (True, False)]
    blocks[1].load_state_dict(blocks[0].state_dict())
    x = torch.randn(16, 2, 7, 7, 32)
    outs = [blk.train()(x, torch.Generator().manual_seed(5)) for blk in blocks]
    torch.testing.assert_close(outs[0], outs[1], rtol=1e-5, atol=1e-5)
    g = torch.Generator().manual_seed(5)
    attn_kept = torch.rand((16,), generator=g) < 0.5
    mlp_kept = torch.rand((16,), generator=g) < 0.5
    both_dropped = ~attn_kept & ~mlp_kept
    assert bool(both_dropped.any()) and bool((~both_dropped).any())
    torch.testing.assert_close(outs[0][both_dropped], x[both_dropped])
    assert not torch.allclose(outs[0][~both_dropped], x[~both_dropped])
    assert torch.equal(blocks[0].eval()(x), blocks[0](x))  # eval: no draw


def test_sep_tpwam_dropout_in_training_only():
    """SepTPWAM's `fusion.dropout` changes the output in train mode and not
    in eval mode; at rate 0 train and eval agree."""
    torch.manual_seed(0)
    dim, l_in, heads = 16, 24, 2
    cfg = C.ModelConfig(name="lavt_video").tpwam
    x = torch.randn(2, 3, 4, 4, dim)
    l = torch.randn(2, 5, l_in)
    mask = torch.ones(2, 5)
    drop = tpwam.build_tpwam(cfg, dim, heads, l_in, dropout=0.5)
    keep = tpwam.build_tpwam(cfg, dim, heads, l_in)
    keep.load_state_dict(drop.state_dict())
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        base = keep.eval()(x, l, mask)
        torch.testing.assert_close(keep.train()(x, l, mask, g), base)
        torch.testing.assert_close(drop.eval()(x, l, mask), base)
        dropped = drop.train()(x, l, mask, g)
    assert not torch.allclose(dropped, base, atol=1e-3)
    with pytest.raises(ValueError, match="Generator"):
        drop.train()(x, l, mask)


# -- one whole video training step -------------------------------------------------

def _video_batch(rng):
    mask = np.ones((B, TOKENS), np.int32)
    mask[0, 4:] = 0
    return {"video": rng.integers(0, 256, (B, T, IMG, IMG, 3)).astype(np.uint8),
            "ids": rng.integers(1, 120, (B, TOKENS)).astype(np.int32),
            "mask": mask,
            "target": rng.integers(0, 2, (B, IMG, IMG)).astype(np.int32),
            "valid_index": np.asarray(VALID, np.int32)}


@pytest.fixture(scope="module")
def video_steps():
    jcfg = JC.lavt_video_tiny().replace(
        swin=JC.SwinConfig(**NO_DROP_SWIN), bert=JC.BertConfig(**NO_DROP_BERT),
        img_size=IMG, max_tokens=TOKENS, num_frames=T, use_pallas=False)
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

    cfg = C.lavt_video_tiny().replace(
        swin=C.SwinConfig(**NO_DROP_SWIN), bert=C.BertConfig(**NO_DROP_BERT),
        img_size=IMG, max_tokens=TOKENS, num_frames=T, dtype="float32")
    pm = build_model(cfg, device="cpu", train=True)
    pm.load_state_dict(state_dict_from_jax(variables, cfg), strict=True)
    tcfg = optim.TrainConfig()
    pstep = make_video_train_step(pm, *create_train_state(pm, tcfg), tcfg)
    pmetrics = pstep({k: torch.from_numpy(v) for k, v in batch.items()},
                     torch.Generator().manual_seed(3))
    want_grads = state_dict_from_jax(
        {"params": jax.tree.map(np.asarray, new_state.opt_state),
         "batch_stats": jax.tree.map(np.asarray, new_state.batch_stats)}, cfg)
    want_stats = state_dict_from_jax(
        {"params": variables["params"],
         "batch_stats": jax.tree.map(np.asarray, new_state.batch_stats)}, cfg)
    return dict(variables=variables, jmetrics=jmetrics, pm=pm,
                pmetrics=pmetrics, want_grads=want_grads,
                want_stats=want_stats, old_stats=state_dict_from_jax(
                    variables, cfg))


def test_video_train_step_loss_and_metrics_match_jax(video_steps):
    jm, pm = video_steps["jmetrics"], video_steps["pmetrics"]
    _close(pm["loss"], jm["loss"], "loss")
    assert pm["lr"] == pytest.approx(float(jm["lr"]), rel=1e-6)
    assert abs(float(pm["iou"]) - float(jm["iou"])) < 1e-3


def test_video_train_step_grads_match_jax(video_steps):
    """Every parameter's gradient, the relative-position tables of all
    sixteen 3D blocks among them."""
    pm, want = video_steps["pm"], video_steps["want_grads"]
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
            assert np.abs(w).max() > 0, name
            tables += 1
    assert tables == sum(SWIN["depths"])


def test_video_train_step_batch_norm_statistics_match_jax(video_steps):
    pm = video_steps["pm"]
    want, old = video_steps["want_stats"], video_steps["old_stats"]
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
        unbiased = (1 - momentum) * v_old + momentum * biased * n / (n - 1)
        np.testing.assert_allclose(mod.running_var.numpy(), unbiased,
                                   rtol=1e-5, atol=1e-5)
        assert int(mod.num_batches_tracked) == 1


def test_video_label_param_matches_jax_on_mapped_names(video_steps):
    """Each JAX video leaf labelled by lavt_rs_tpu's label_param, carried to
    the port's names by state_dict_from_jax, against the port's."""
    codes = {"decay": 1.0, "no_decay": 2.0, "frozen": 3.0}
    tcfg = joptim.TrainConfig()

    def label_tree(tree, path=()):
        if isinstance(tree, dict):
            return {k: label_tree(v, path + (k,)) for k, v in tree.items()}
        return np.full(np.shape(tree),
                       codes[joptim.label_param("/".join(path), tcfg)],
                       np.float32)

    pm, variables = video_steps["pm"], video_steps["variables"]
    mapped = state_dict_from_jax(
        {"params": label_tree(variables["params"]),
         "batch_stats": variables["batch_stats"]}, pm.cfg)
    ptcfg = optim.TrainConfig()
    seen = set()
    for name, _ in pm.named_parameters():
        want = np.unique(mapped[name].numpy())
        assert want.size == 1, name
        assert codes[optim.label_param(name, ptcfg)] == want[0], name
        seen.add(optim.label_param(name, ptcfg))
    assert seen == {"decay", "no_decay", "frozen"}


def test_stage1_takes_the_grouped_route_in_eval_only(video_steps,
                                                     monkeypatch):
    """Training keeps every 3D block on the K10 / K9 route, as the JAX
    package gates its grouped route on `deterministic`; in eval mode the
    first stage takes the grouped padded route (K2p), here forced at this
    model's C = 32 as LAVT_FUSED3D=all forces it in the JAX package.  At
    its default the route takes C = 96 (Video Swin-T stage 1, N = 392)."""
    pm = video_steps["pm"]
    blocks = [b for layer in pm.backbone.layers for b in layer.blocks]
    wide = swin3d.SwinBlock3D(96, 3, (8, 7, 7))
    assert wide.route(392, 324) == "grouped"
    assert wide.route(392, 324, train=True) == "core"
    assert pm.backbone.kernel_plan(T, (IMG, IMG), 4, train=True)[0] == {
        "K10": 8, "K9": 8}
    monkeypatch.setattr(fused_msa, "fused3d_grouped_routed", _grouped_at(32))
    assert [b.route(196, 9, 4, b.training) for b in blocks] == ["core"] * 8
    try:
        pm.eval()
        assert ([b.route(196, 9, 4, b.training) for b in blocks]
                == ["grouped"] * 2 + ["core"] * 6)
    finally:
        pm.train()


def test_video_drop_path_rates_follow_linspace():
    cfg = C.lavt_video_tiny().replace(
        swin=C.SwinConfig(**SWIN, drop_path_rate=0.2), bert=C.BertConfig(**BERT),
        dtype="float32")
    m = build_model(cfg, device="cpu", train=True)
    rates = [b.drop_path_rate for layer in m.backbone.layers
             for b in layer.blocks]
    np.testing.assert_allclose(rates, np.linspace(0, 0.2, 8))
