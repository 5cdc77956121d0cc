"""The port's lavt_video modules against the JAX modules, on the CPU.

A small lavt_video (embed 32, depths (2, 2, 2, 2) so every stage has a
shifted block, heads (1, 2, 4, 8) so the head dim is 32 as in Video
Swin-T, 4-frame 64² clips, 1 BERT layer) is built in both frameworks;
every JAX variable is drawn from a seeded numpy generator (language gates
non-zero) and carried into the port by `convert/from_jax.py`.  The Pallas
kernels run in `pltpu.force_tpu_interpret_mode()`; the JAX grouped 3D
route is forced with LAVT_FUSED3D=all, as tests/test_pallas_window_attn.py
does.  Everything runs in f32.  Tolerances: index and mask arrays exact;
modules 2e-4 abs + rel (f32 sums in another order, through a softmax and
the Pallas interpret path); whole-model logits rtol 1e-3 / atol 2e-4 plus
argmax agreement, as tests/test_torch_model.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import torch_oracles as oracle
from lavt_rs_tpu import config as JC
from lavt_rs_tpu.models import swin3d as jswin3d
from lavt_rs_tpu.models import tpwam as jtpwam
from lavt_rs_tpu.models.factory import build_model as jbuild_model
from lavt_rs_tpu.ops import attention as jattn
from lavt_rs_tpu.ops import window as jwin
from lavt_rs_tpu.ops.pallas import fused_msa as jfused
from lavt_rs_tpu.ops.pallas import window_attn as jwattn
from lavt_rs_tpu_torch import config as C
from lavt_rs_tpu_torch.convert.from_jax import (state_dict_from_jax,
                                                tpwam_state_dict_from_jax)
from lavt_rs_tpu_torch.eval.video_eval import clip_iou
from lavt_rs_tpu_torch.models import swin3d, tpwam
from lavt_rs_tpu_torch.models.factory import build_model
from lavt_rs_tpu_torch.ops import fused_msa, window, window_attn
from test_torch_model import random_variables
from torch_threads import torch_threads  # noqa: F401 (autouse fixture)

TOL = 2e-4
SWIN = dict(embed_dim=32, depths=(2, 2, 2, 2), num_heads=(1, 2, 4, 8),
            window_size=7)
BERT = dict(vocab_size=120, num_layers=1, intermediate_size=256,
            max_position_embeddings=64)
T, IMG, TOKENS = 4, 64, 6
# (D, H, W, window, shift): shifted, unshifted, clamped in D and H (their
# shift drops to 0); all N = 196
GEOMS = [(4, 14, 14, (8, 7, 7), (4, 3, 3)), (4, 14, 14, (8, 7, 7), (0, 0, 0)),
         (4, 7, 12, (8, 7, 7), (4, 3, 3))]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


# -- 3D window helpers ---------------------------------------------------------

def test_window_partition_reverse_3d(rng):
    x = rng.standard_normal((2, 4, 14, 21, 3)).astype(np.float32)
    ws = (2, 7, 7)
    got = window.window_partition_3d(_t(x), ws)
    want = jwin.window_partition_3d(jnp.asarray(x), ws)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    back = window.window_reverse_3d(got, ws, 4, 14, 21)
    np.testing.assert_array_equal(back.numpy(), x)


@pytest.mark.parametrize("size", [(8, 120, 120), (4, 30, 30), (2, 7, 9)])
def test_get_window_size_3d(size):
    ws, ss = (8, 7, 7), (4, 3, 3)
    assert (window.get_window_size_3d(size, ws, ss)
            == jwin.get_window_size_3d(size, ws, ss))
    assert window.get_window_size_3d(size, ws) == jwin.get_window_size_3d(size, ws)


@pytest.mark.parametrize("dp,hp,wp,ws,ss", [
    (4, 14, 14, (4, 7, 7), (2, 3, 3)), (8, 21, 21, (8, 7, 7), (0, 3, 3)),
    (4, 14, 14, (4, 7, 7), (0, 0, 0))])
def test_shift_mask_3d(dp, hp, wp, ws, ss):
    got = window.shift_mask_3d(dp, hp, wp, ws, ss, "cpu")
    want = jwin.shift_mask_3d(dp, hp, wp, ws, ss)
    if want is None:
        assert got is None
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n", [392, 196, 98])
def test_relative_bias_3d(rng, n):
    """Full window and the reference's [:N, :N] truncation when clamped."""
    table = rng.standard_normal((15 * 13 * 13, 3)).astype(np.float32)
    index = _t(window.relative_position_index_3d(8, 7, 7))
    got = window.relative_bias_from_table_3d(_t(table), index, n)
    want = jwin.relative_bias_from_table_3d(jnp.asarray(table), 8, 7, 7, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=0)


@pytest.mark.parametrize("d,h,w,ws,ss", [
    (4, 14, 14, (4, 7, 7), (2, 3, 3)), (4, 14, 14, (4, 7, 7), (0, 0, 0)),
    (2, 10, 12, (2, 7, 7), (0, 3, 3)), (8, 15, 15, (8, 7, 7), (0, 3, 3))])
def test_grouped_partition_3d(rng, d, h, w, ws, ss):
    """Index arrays, unmasked-first order, small mask, partition and
    reverse: all exactly the JAX package's."""
    dp, hp, wp = (-(-s // k) * k for s, k in zip((d, h, w), ws))
    n = ws[0] * ws[1] * ws[2]
    n_p = fused_msa.pad_tokens(n)
    got = window.grouped_partition_idx_3d(d, h, w, dp, hp, wp, ws, ss, n_p)
    want = jwin._grouped_padded_partition_idx_3d_np(d, h, w, dp, hp, wp, ws,
                                                    ss, n_p)
    for g, wa in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(wa))
    nu, mask = window.partition_3d_groups(d, h, w, dp, hp, wp, ws, ss, n_p,
                                          "cpu")
    jnu, jmask = jwin.partition_3d_groups(d, h, w, dp, hp, wp, ws, ss, n_p)
    assert nu == jnu
    if jmask is None:
        assert mask is None
    else:
        np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    x = rng.standard_normal((2, d, h, w, 5)).astype(np.float32)
    xw = window.partition_shifted_padded_3d(_t(x), ws, ss, dp, hp, wp, n_p)
    jxw = jwin.partition_shifted_padded_3d(jnp.asarray(x), ws, ss, dp, hp, wp,
                                           n_p)
    np.testing.assert_array_equal(xw.numpy(), np.asarray(jxw))
    back = window.reverse_shifted_unpadded_3d(xw, ws, ss, dp, hp, wp, d, h, w,
                                              n_p)
    np.testing.assert_array_equal(back.numpy(), x)


def test_grouped_mask_is_cached_per_padded_volume():
    """Clips of 13 and 16 frames pad to one depth and share one cached mask
    (equal to the JAX package's for each length); clear_device_caches
    releases it, and the next call builds an equal one."""
    ws, ss, n_p = (8, 7, 7), (4, 3, 3), fused_msa.pad_tokens(392)
    got = {d: window.partition_3d_groups(d, 14, 14, 16, 14, 14, ws, ss, n_p,
                                         "cpu") for d in (13, 16)}
    assert got[13][1] is got[16][1]
    for d in (13, 16):
        jnu, jmask = jwin.partition_3d_groups(d, 14, 14, 16, 14, 14, ws, ss,
                                              n_p)
        assert got[d][0] == jnu
        np.testing.assert_array_equal(got[d][1].numpy(), np.asarray(jmask))
    window.clear_device_caches()
    nu, mask = window.partition_3d_groups(13, 14, 14, 16, 14, 14, ws, ss, n_p,
                                          "cpu")
    assert mask is not got[13][1] and nu == got[13][0]
    np.testing.assert_array_equal(mask.numpy(), got[13][1].numpy())


# -- K10 and K2p, plain versions -------------------------------------------------

def _qkv_bias_mask(rng, b, nw, h, n, hd, masked):
    q, k, v = (rng.standard_normal((b, nw, h, n, hd)).astype(np.float32)
               for _ in range(3))
    bias = rng.standard_normal((h, n, n)).astype(np.float32)
    mask = (np.where(rng.random((nw, n, n)) > 0.7, -100.0, 0.0)
            .astype(np.float32) if masked else None)
    return q, k, v, bias, mask


@pytest.mark.parametrize("n", [49, 196, 392])
@pytest.mark.parametrize("masked", [False, True])
def test_window_attention_k10_plain(rng, n, masked):
    """K10's plain version against the Pallas kernel (interpret mode) at
    N = 49 and 196, and against the XLA path at N = 392, where the JAX
    package's kernel does not run (`_attn_tiling` gates N <= 256)."""
    args = _qkv_bias_mask(rng, 1, 2, 2, n, 32, masked)
    scale = 32 ** -0.5
    jargs = [None if a is None else jnp.asarray(a) for a in args]
    if n <= 256:
        with pltpu.force_tpu_interpret_mode():
            want = jwattn.window_attention_pallas(*jargs, scale=scale)
    else:
        want = jattn.window_attention_xla(*jargs, scale=scale)
    got = window_attn.window_attention(
        *(None if a is None else _t(a) for a in args), scale)
    _close(got.numpy(), want)


def _msa_weights(rng, c):
    """JAX layout (in, out) weights and the port's torch layout."""
    wqkv = rng.standard_normal((c, 3 * c)).astype(np.float32) * c ** -0.5
    bqkv = rng.standard_normal((3 * c,)).astype(np.float32) * 0.1
    wproj = rng.standard_normal((c, c)).astype(np.float32) * c ** -0.5
    bproj = rng.standard_normal((c,)).astype(np.float32) * 0.1
    jw = [jnp.asarray(a) for a in (wqkv, bqkv, wproj, bproj)]
    tw = [_t(wqkv.T), _t(bqkv), _t(wproj.T), _t(bproj)]
    return jw, tw


@pytest.mark.parametrize("masked", [False, True])
def test_fused_window_msa_padded_plain(rng, masked):
    """K2p through `fused_window_msa_padded` (N = 49 padded to 56 in f32,
    the sublane of its itemsize, as the JAX wrapper pads it) against the
    JAX wrapper on the Pallas kernel in interpret mode."""
    b, nw, n, c, h = 1, 4, 49, 64, 2
    x = rng.standard_normal((b, nw, n, c)).astype(np.float32)
    bias = rng.standard_normal((h, n, n)).astype(np.float32)
    mask = (np.where(rng.random((nw, n, n)) > 0.7, -100.0, 0.0)
            .astype(np.float32) if masked else None)
    jw, tw = _msa_weights(rng, c)
    scale = (c // h) ** -0.5
    with pltpu.force_tpu_interpret_mode():
        want = jfused.fused_window_msa_padded(
            jnp.asarray(x), *jw, jnp.asarray(bias),
            None if mask is None else jnp.asarray(mask), h, scale)
    got = fused_msa.fused_window_msa_padded(
        _t(x), *tw, _t(bias), None if mask is None else _t(mask), h, scale)
    _close(got.numpy(), want)
    np.testing.assert_array_equal(
        fused_msa.pad_bias_sublane(_t(bias), 56).numpy(),
        np.asarray(jfused.pad_bias_sublane(jnp.asarray(bias), 56)))


def _block_state_dict(params):
    """JAX SwinBlock3D params -> the port block's state_dict."""
    sd = {}
    for name in ("norm1", "norm2"):
        sd[f"{name}.weight"] = _t(params[name]["scale"])
        sd[f"{name}.bias"] = _t(params[name]["bias"])
    for name in ("attn.qkv", "attn.proj", "mlp.fc1", "mlp.fc2"):
        src = params[name.split(".")[0]][name.split(".")[1]]
        sd[f"{name}.weight"] = _t(np.asarray(src["kernel"]).T)
        sd[f"{name}.bias"] = _t(src["bias"])
    sd["attn.relative_position_bias_table"] = _t(
        params["attn"]["relative_position_bias_table"])
    return sd


@pytest.mark.parametrize("route", ["grouped", "k10"])
@pytest.mark.parametrize("geom", range(len(GEOMS)))
def test_swin_block3d(rng, monkeypatch, route, geom):
    """One SwinBlock3D against the JAX block with use_pallas: on the grouped
    padded route (K2p's plain version; JAX: LAVT_FUSED3D=all, the padded
    K2 in interpret mode) and on the K10 route (JAX: LAVT_FUSED3D=off,
    K10 in interpret mode where N <= 256, else XLA), for shifted,
    unshifted and depth-clamped windows.  The port's route is forced the
    same way, through `fused_msa.fused3d_grouped_routed`."""
    d, h, w, ws, ss = GEOMS[geom]
    c, heads = 64, 2
    monkeypatch.setenv("LAVT_FUSED3D", "all" if route == "grouped" else "off")
    monkeypatch.setattr(fused_msa, "fused3d_grouped_routed",
                        _grouped_at(c) if route == "grouped"
                        else lambda *a, **k: False)
    x = rng.standard_normal((1, d, h, w, c)).astype(np.float32)
    jblk = jswin3d.SwinBlock3D(dim=c, num_heads=heads, window_size=ws,
                               shift_size=ss, use_pallas=True)
    shapes = jax.eval_shape(lambda: jblk.init(jax.random.PRNGKey(0),
                                              jnp.asarray(x)))
    params = random_variables(shapes["params"], np.random.default_rng(geom))
    with pltpu.force_tpu_interpret_mode():
        want = jblk.apply({"params": params}, jnp.asarray(x))
    blk = swin3d.SwinBlock3D(c, heads, ws, ss).eval()
    blk.load_state_dict(_block_state_dict(params), strict=False)
    ws_, _ = window.get_window_size_3d((d, h, w), ws, ss)
    n = ws_[0] * ws_[1] * ws_[2]
    assert (blk.route(n, 1) == "grouped") == (route == "grouped")
    with torch.no_grad():
        got = blk(_t(x))
    _close(got.numpy(), want)


# -- SepTPWAM ----------------------------------------------------------------------

def test_sep_tpwam(rng):
    """The port's SepTPWAM against the JAX module (variables from numpy)
    and against the reference-layout torch oracle (its state_dict loaded
    into the port as it is)."""
    dim, l_in, heads = 16, 24, 2
    x = rng.standard_normal((2, 3, 4, 4, dim)).astype(np.float32)
    l = rng.standard_normal((2, 5, l_in)).astype(np.float32)
    mask = np.ones((2, 5), np.float32)
    mask[0, 3:] = 0
    jm = jtpwam.SepTPWAM(dim=dim, num_heads=heads)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x, l, mask))
    variables = random_variables(shapes, np.random.default_rng(11))
    want = jm.apply(variables, x, l, mask)
    cfg = C.ModelConfig(name="lavt_video")
    pm = tpwam.build_tpwam(cfg.tpwam, dim, heads, l_in)
    pm.load_state_dict(tpwam_state_dict_from_jax(variables["params"]),
                       strict=True)
    with torch.no_grad():
        got = pm(_t(x), _t(l), _t(mask))
    _close(got.numpy(), want)

    torch.manual_seed(0)
    om = oracle.SepTPWAMOracle(dim, l_in, heads=heads).eval()
    pm.load_state_dict(om.state_dict(), strict=True)
    with torch.no_grad():
        want_o = om(_t(x), _t(l.transpose(0, 2, 1)), _t(mask[:, :, None]))
        got_o = pm(_t(x), _t(l), _t(mask))
    _close(got_o.numpy(), want_o.numpy())


def test_build_tpwam_kinds():
    """Each 3D PWAM kind builds its class (JAX `build_tpwam`)."""
    classes = {C.TPWAMKind.SEP: tpwam.SepTPWAM,
               C.TPWAMKind.PWAM2D: tpwam.ClipPWAM,
               C.TPWAMKind.SEP_INNER: tpwam.SepTPWAMInner,
               C.TPWAMKind.T: tpwam.TPWAM, C.TPWAMKind.T_COMP: tpwam.TPWAM,
               C.TPWAMKind.TS: tpwam.TSPWAM, C.TPWAMKind.SEQ: tpwam.SeqTPWAM,
               C.TPWAMKind.SEP_SEQ: tpwam.SepSeqTPWAM,
               C.TPWAMKind.SEP_SEQ_INNER: tpwam.SepSeqTPWAM}
    assert set(classes) == set(C.TPWAMKind)
    cfg = C.TPWAMConfig()
    for kind, cls in classes.items():
        m = tpwam.build_tpwam(dataclasses.replace(cfg, kind=kind), 8, 1, 16)
        assert type(m) is cls, kind
    comp = tpwam.build_tpwam(dataclasses.replace(cfg, kind=C.TPWAMKind.T_COMP),
                             8, 1, 16)
    assert comp.w_conv == comp.mm_conv == cfg.kernel_t
    assert tpwam.build_tpwam(dataclasses.replace(
        cfg, kind=C.TPWAMKind.SEP_SEQ_INNER), 8, 1, 16).inner_only


# -- the whole small model -----------------------------------------------------

def _grouped_at(width):
    """`fused3d_grouped_routed` forced on at C = width wherever K2p's kernel
    takes the window, as the JAX package's LAVT_FUSED3D=all forces it."""
    def routed(nw, n, c, heads, itemsize=2):
        return c == width and fused_msa.padded_msa_supported(
            fused_msa.pad_tokens(n), c, heads)
    return routed


@pytest.fixture
def stage1_grouped(monkeypatch):
    """Stage 1 (C = 32) of the small model on the grouped padded route
    (K2p's plain version here), stages 2-4 on K10."""
    monkeypatch.setattr(fused_msa, "fused3d_grouped_routed",
                        _grouped_at(SWIN["embed_dim"]))


@pytest.fixture(scope="module")
def video_pair():
    jcfg = JC.lavt_video_tiny().replace(
        swin=JC.SwinConfig(**SWIN, drop_path_rate=0.1),
        bert=JC.BertConfig(**BERT), img_size=IMG, max_tokens=TOKENS,
        num_frames=T)
    jm = jbuild_model(jcfg)
    vid = jnp.zeros((1, T, IMG, IMG, 3))
    ids = jnp.ones((1, TOKENS), jnp.int32)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), vid, ids,
                                            ids))
    shapes = {k: shapes[k] for k in ("params", "batch_stats")}
    variables = random_variables(shapes, np.random.default_rng(7))
    # with `stage1_grouped` the port routes stage 1 through the grouped
    # padded route, stages 2-4 through K10, all on the plain versions here
    cfg = C.lavt_video_tiny().replace(
        swin=C.SwinConfig(**SWIN, drop_path_rate=0.1),
        bert=C.BertConfig(**BERT), img_size=IMG, max_tokens=TOKENS,
        num_frames=T, dtype="float32")
    pm = build_model(cfg, device="cpu")
    pm.load_state_dict(state_dict_from_jax(variables, cfg), strict=True)
    return jax.jit(jm.apply), variables, pm


def _clip_inputs(rng):
    video = rng.standard_normal((1, T, IMG, IMG, 3)).astype(np.float32)
    ids = rng.integers(1, 120, (1, TOKENS)).astype(np.int64)
    mask = np.ones((1, TOKENS), np.int64)
    mask[0, 4:] = 0
    return video, ids, mask


def test_lavt_video_logit_parity(video_pair, stage1_grouped):
    japply, variables, pm = video_pair
    assert pm.backbone.kernel_plan(T, (IMG, IMG), 4)[0] == {"K2p": 2,
                                                            "K10": 6}
    video, ids, mask = _clip_inputs(np.random.default_rng(1))
    want = np.asarray(japply(variables, video, ids, mask))
    with torch.no_grad():
        got = pm(*(torch.from_numpy(a) for a in (video, ids, mask))).numpy()
    assert got.shape == (T, IMG, IMG, 2) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=2e-4)
    margin = np.abs(want[..., 1] - want[..., 0])
    agree = (got.argmax(-1) == want.argmax(-1)) | (margin < 1e-3)
    assert agree.mean() > 0.9999


def test_clip_iou(video_pair, stage1_grouped):
    """The per-clip A2D step: uint8 clip, on-device normalize, forward,
    argmax of the annotated frame, inter/union (as evaluate_a2d's sink)."""
    from lavt_rs_tpu.ops.norm import maybe_normalize_image

    japply, variables, pm = video_pair
    rng = np.random.default_rng(9)
    video = rng.integers(0, 256, (T, IMG, IMG, 3)).astype(np.uint8)
    ids = rng.integers(1, 120, (TOKENS,)).astype(np.int64)
    mask = np.ones((TOKENS,), np.int64)
    mask[3:] = 0
    target = (rng.random((IMG, IMG)) > 0.5).astype(np.uint8)
    valid = 2
    logits = np.asarray(japply(variables, maybe_normalize_image(
        jnp.asarray(video[None])), ids[None], mask[None]))
    pred = logits[valid].argmax(-1)
    want = (np.logical_and(pred, target).sum(),
            np.logical_or(pred, target).sum())
    got = clip_iou(pm, *(torch.from_numpy(a) for a in (video, ids, mask)),
                   valid, torch.from_numpy(target))
    for g, w in zip(got, want):
        assert g.shape == ()
        # pixels whose two logits tie within f32 noise may flip
        np.testing.assert_allclose(g.item(), w, rtol=0, atol=3)


def test_video_plain_route_equals_kernel_route_on_cpu(video_pair,
                                                      stage1_grouped):
    """use_kernels=False takes the K10 route everywhere with the plain
    attention; the kernel route (grouped padded K2p at stage 1) gives
    the same logits up to f32 summation order."""
    _, _, pm = video_pair
    plain = build_model(dataclasses.replace(pm.cfg, use_kernels=False),
                        device="cpu")
    plain.load_state_dict(pm.state_dict())
    video, ids, mask = (torch.from_numpy(a) for a in
                        _clip_inputs(np.random.default_rng(2)))
    with torch.no_grad():
        torch.testing.assert_close(plain(video, ids, mask),
                                   pm(video, ids, mask), rtol=1e-4, atol=1e-4)


def test_video_training_not_ported():
    """build_model(train=True) for lavt_video (the name dates from when it
    raised): a model in train mode with f32 parameters on the CPU."""
    cfg = C.lavt_video_tiny().replace(swin=C.SwinConfig(**SWIN),
                                      bert=C.BertConfig(**BERT))
    assert cfg.dtype == "bfloat16"
    m = build_model(cfg, device="cpu", train=True)
    assert m.training and all(mod.training for mod in m.modules())
    assert {p.dtype for p in m.parameters()} == {torch.float32}
    assert {p.device.type for p in m.parameters()} == {"cpu"}
