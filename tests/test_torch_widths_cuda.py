"""The kernels at the widths the routing added, the probe kernels P1/P2,
the window-7 route and the f32 refusal, on the card.  Marked `cuda`;
every test skips without a CUDA device.  Runs without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_widths_cuda.py

* K3 / K8 / K7 at C = 384 (Swin-T/S stage 3, Swin-L stage 2);
* K4 and K4b at C = 1536 (Swin-L stage 4), 4096 (the routed maximum) and
  1056 (masked words on the wide path);
* K1 / K2 / K11, the save mode, K5 and K6 at C = 96 (Swin-T/S stage 1 at
  window 12: three heads, a 32-column tail in the attention kernel's x
  chunks and in the out-projection GEMM's tiles);
* P1 / P2 against their plain version and each other;
* a small window-7 model on the card: every block on K10, none on K1 or
  K11;
* f32 with the kernels refused, where a kernel of the plan has no f32
  variant (a test takes K5's away: every plan has its variants, window-12
  training too), before anything is built or launched.

Inputs are bf16 and the tolerances those of test_torch_kernels_cuda.py
(whose helpers this file uses).
"""

import numpy as np
import pytest
import torch

from lavt_rs_tpu_torch import config as C
from lavt_rs_tpu_torch.models.factory import build_model
from lavt_rs_tpu_torch.ops import fused_mlp, fused_msa, fused_msa_2d, ln
from lavt_rs_tpu_torch.ops import window_attn
from lavt_rs_tpu_torch.tools import probe_headbatch as probe
from test_torch_kernels_cuda import (TOL_LN_MLP, TOL_MSA, TOL_P, _bf16,
                                     _close, _close_grads, _keep, _map_args,
                                     _mlp_args, _msa_args, _rel_frob)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


@pytest.mark.parametrize("rows,c", [(225, 1536), (64, 4096), (33, 1056)])
def test_layer_norm_rows_wide_kernel(dev, rows, c):
    rng = np.random.default_rng(c)
    x = _bf16(rng, (rows, c), 2.0, dev) + 0.5
    s = _bf16(rng, (c,), 0.2, dev) + 1.0
    b = _bf16(rng, (c,), 0.2, dev)
    _close(ln.layer_norm_rows(x, s, b), ln.layer_norm_rows_plain(x, s, b),
           TOL_LN_MLP)


@pytest.mark.parametrize("rows,c", [(225, 1536), (64, 4096), (33, 1056)])
def test_layer_norm_rows_bwd_wide_kernel(dev, rows, c):
    """K4b on the wide path (the block on one row): Swin-L stage 4's
    training backward, the routed maximum, a width of masked words."""
    rng = np.random.default_rng(c + 1)
    x = _bf16(rng, (rows, c), 2.0, dev) + 0.5
    s = (_bf16(rng, (c,), 0.2, dev) + 1.0).float()
    g = _bf16(rng, (rows, c), 1.0, dev)
    got = ln.layer_norm_rows_bwd(x, s, g)
    want = ln.layer_norm_rows_bwd_plain(x, s, g)
    _close(got[0], want[0], TOL_LN_MLP)
    for a, w in zip(got[1:], want[1:]):
        _rel_frob(a, w, 1e-3)


def test_ln_mlp_kernels_at_384(dev):
    rng = np.random.default_rng(384)
    m, c, rows = 900, 384, 225
    args = _mlp_args(rng, dev, m, c)
    _close(fused_mlp.fused_ln_mlp(*args), fused_mlp.fused_ln_mlp_plain(*args),
           TOL_LN_MLP)
    keep = _keep(dev, m // rows)
    _close(fused_mlp.fused_ln_mlp_droppath(*args, keep, rows),
           fused_mlp.fused_ln_mlp_droppath_plain(*args, keep, rows),
           TOL_LN_MLP)
    x, g, be, w1, b1, w2, _ = args
    gy = _bf16(rng, (m, c), 1.0, dev)
    for kp in (None, keep):
        _close_grads(fused_mlp.fused_ln_mlp_bwd(x, gy, g, be, w1, b1, w2, kp,
                                                rows),
                     fused_mlp.fused_ln_mlp_bwd_plain(x, gy, g, be, w1, b1,
                                                      w2, kp, rows))


@pytest.mark.parametrize("shift", [False, True])
def test_msa_kernels_at_96(dev, shift):
    """K1, K2, the save mode (with and without LN), K5 and K6 at C = 96."""
    rng = np.random.default_rng(96 + shift)
    c, heads = 96, 3
    x, w, bias, mask, scale = _msa_args(rng, dev, 2, 24, c, heads, shift)
    lnp = (_bf16(rng, (c,), 0.2, dev) + 1.0, _bf16(rng, (c,), 0.2, dev))
    _close(fused_msa.fused_window_msa_ln(x, *lnp, *w, bias, mask, heads,
                                         scale),
           fused_msa.fused_window_msa_ln_plain(x, *lnp, *w, bias, mask, heads,
                                               scale), TOL_MSA)
    _close(fused_msa.fused_window_msa(x, *w, bias, mask, heads, scale),
           fused_msa.fused_window_msa_plain(x, *w, bias, mask, heads, scale),
           TOL_MSA)
    for ln_ in (None, lnp):
        y, saved = fused_msa.fused_window_msa_save(x, ln_, *w, bias, mask,
                                                   heads, scale)
        y_p, saved_p = fused_msa.fused_window_msa_save_plain(
            x, ln_, *w, bias, mask, heads, scale)
        _close(y, y_p, TOL_MSA)
        torch.cuda.synchronize()
        err = (saved[3].float() - saved_p[3].float()).abs()
        assert bool((err <= TOL_P + TOL_MSA * saved_p[3].float().abs()).all())
    gy = _bf16(rng, x.shape, 1.0, dev)
    resid = saved_p[:4]
    xin = saved_p[4].view(x.shape)
    _close_grads(fused_msa.fused_window_msa_bwd(xin, gy, w[0], w[2], resid,
                                                heads, scale),
                 fused_msa.fused_window_msa_bwd_plain(xin, gy, w[0], w[2],
                                                      resid, heads, scale))
    _close_grads(fused_msa.fused_window_msa_bwd_recompute(
        x, lnp, *w, bias, mask, gy, heads, scale),
        fused_msa.fused_window_msa_bwd_recompute_plain(
            x, lnp, *w, bias, mask, gy, heads, scale))


@pytest.mark.parametrize("hp,wp,shift", [(60, 60, True), (24, 36, False)])
def test_k11_at_96(dev, hp, wp, shift):
    rng = np.random.default_rng(hp + wp)
    x, w, bias, mask, scale = _map_args(rng, dev, 2, hp, wp, 96, 3, shift)
    args = (x, *w, bias, mask, 3, scale, 12)
    _close(fused_msa_2d.fused_window_msa_2d(*args),
           fused_msa_2d.fused_window_msa_2d_plain(*args), TOL_MSA)


def test_probe_kernels(dev):
    # against the plain version on the check input (the softmax far from
    # uniform), P1 against P2 on the tool's input at the tool's atol
    xc = probe.probe_input(8, 3, 4, 144, device=dev, std=probe.CHECK_STD)
    want = probe.probe_attention_plain(xc, 4, 144)
    for fn in (probe.loop_attention, probe.batch_attention):
        assert probe.mismatch(fn(xc, 3, 4, 144), want) <= 1
    x = probe.probe_input(8, 3, 4, 144, device=dev)
    p1 = probe.loop_attention(x, 3, 4, 144)
    p2 = probe.batch_attention(x, 3, 4, 144)
    torch.testing.assert_close(p1, p2, rtol=0, atol=1e-2)
    with pytest.raises(ValueError):  # n not a multiple of 16
        probe.loop_attention(x[:49 * 12].contiguous(), 3, 4, 49)


def _small(window, **kw):
    return C.ModelConfig(
        swin=C.SwinConfig(embed_dim=32, depths=(2, 2, 2, 2),
                          num_heads=(1, 2, 4, 8), window_size=window),
        bert=C.BertConfig(num_layers=1), img_size=96, **kw)


def test_window7_model_on_the_card(dev):
    """A bf16 window-7 model: every block's MSA through K10, none through
    K1 or K11."""
    from lavt_rs_tpu_torch.eval.refcoco_eval import fwd_iou

    g = torch.Generator(device=dev).manual_seed(0)
    m = build_model(_small(7), dev, generator=g)
    window_attn.window_attention.launches = 0
    fused_msa_2d.fused_window_msa_2d.launches = 0
    fused_msa.fused_window_msa_ln.launches = 0
    img = torch.randint(0, 256, (2, 96, 96, 3), dtype=torch.uint8, device=dev)
    ids = torch.randint(1, 1000, (2, 1, 8), device=dev)
    mask = torch.ones(2, 1, 8, device=dev)
    inter, union = fwd_iou(m, img, ids, mask,
                           torch.zeros(2, 96 * 96 // 8, dtype=torch.uint8,
                                       device=dev))
    torch.cuda.synchronize()
    assert bool(torch.isfinite(union).all())
    assert window_attn.window_attention.launches == 8
    assert fused_msa_2d.fused_window_msa_2d.launches == 0
    assert fused_msa.fused_window_msa_ln.launches == 0


@pytest.mark.parametrize("drop", [None, "K5"], ids=["window12_train",
                                                    "guard"])
def test_f32_with_kernels_is_refused_before_any_launch(dev, monkeypatch,
                                                       drop):
    """Refused where the plan holds a kernel without an f32 variant, before
    any launch or allocation.  Every plan has its f32 variants now
    (window12_train: window-12 training builds, as window-7 inference and
    training do); the refusal stays as the guard: with K5's variant taken
    away (guard) window-12 training is refused, naming it."""
    from lavt_rs_tpu_torch.models import factory

    if drop is None:
        assert build_model(_small(12, dtype="float32"), dev,
                           train=True) is not None
    else:
        monkeypatch.setattr(factory, "F32_KERNELS",
                            factory.F32_KERNELS - {drop})
        before = (ln.layer_norm_rows.launches,
                  fused_mlp.fused_ln_mlp.launches,
                  window_attn.window_attention.launches,
                  window_attn.window_attention_f32.launches)
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        with pytest.raises(NotImplementedError, match=f"launches {drop}, "):
            build_model(_small(12, dtype="float32"), dev, train=True)
        assert torch.cuda.max_memory_allocated(dev) == base  # no allocation
        assert (ln.layer_norm_rows.launches, fused_mlp.fused_ln_mlp.launches,
                window_attn.window_attention.launches,
                window_attn.window_attention_f32.launches) == before
    # window-7 f32 inference and training pass the refusal; the plain
    # versions take f32 on the card
    assert build_model(_small(7, dtype="float32"), dev) is not None
    assert build_model(_small(7, dtype="float32"), dev,
                       train=True) is not None
    assert build_model(_small(7, dtype="float32", use_kernels=False),
                       dev, train=True) is not None
