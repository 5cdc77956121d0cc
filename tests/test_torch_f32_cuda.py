"""The f32 variants of K1, K2, the K1/K2 save mode, K5, K6, K11, K3, K4,
K10 (both modes), K2p, K9, K8, K7 and K4b on the card.  Marked `cuda`; every test skips without a CUDA device.  Runs
without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_f32_cuda.py

* each f32 variant against its f32 plain version at small stage-shaped
  sizes (shifted and unshifted windows, a non-square map, a width of
  masked words), within 1e-4 abs + 1e-4 rel with TF32 off (3xTF32
  products and f32 sums in another order; one TF32 pass, ~5e-4 relative,
  fails it), counted on its own counter and on no bf16 one;
* a small f32 window-12 model on the card: its f32 launches equal its
  `kernel_plan` at itemsize 4, no bf16 kernel runs, and its logits agree
  with the plain f32 model's within 1e-2 (chip_smoke.py's f32 gate);
* K10 f32 (contiguous, save mode, the strided qkv route, the grouped
  attention with nu at 0, mid and nW) at N = 16, 49, 57, 196, 392 and
  400, K2p f32 and K9 f32 at N = 49, 392 and 400, masked and not, within
  1e-4 abs + rel of their plain versions; K10 f32's save mode and K9
  f32's dbias the same bits in two runs (no atomics); K10 f32's shared
  memory against its plan at every N;
* a small f32 window-7 lavt_one and an f32 lavt_video (Video Swin-T, 8
  frames of 64²) launch their plans, forward and in a training step,
  against the plain f32 model;
* K3 f32's launches (the prep's LN rows and the weights' lo parts; fc1 +
  GELU and fc2 + residual with W's lo by TMA) against their plain
  versions at C = 128-1024;
* K8 f32, K7 f32 (with keep and without) and K4b f32 at C = 128, 256,
  512 and 1024 (K4b f32 also at 96 and 1536) on M a multiple of no tile,
  keep with a zero, within 1e-4 abs + rel of their plain versions, the
  same bits in two calls;
* the save mode f32 (with and without LN), K5 f32 (the same bits in two
  calls), K6 f32 and K2 f32 (both softmax forms) at N = 144 against their
  plain versions; F7: with logits past 80, K1 f32 at inference takes the
  clamp form and the taped forward and K6 f32's recomputed P the exact
  one; a small f32 window-12 lavt_one trains on its plan, saving its
  residuals (save mode f32, K5 f32) or recomputing them (K1 f32 / K2 f32
  taped, K6 f32), against the plain f32 step;
* the f32 window-MSA attention (csrc/fused_msa_f32.cu: persistent
  blocks over runs of (head, window) items) in window and map order, in
  its clamp, exact and save modes, unmasked and masked with and without
  window flags, on a 36 x 24 map, at the stage-4 shape, with runs that
  cross heads mid-way and with fewer items than SMs: within 1e-4 abs +
  rel of its plain version, the same bits twice;
* the 3xTF32 wgmma + TMA core (csrc/gemm_tf32_sm90.cuh): its shared
  memory against `tf32_core.ring`; `gemm_f32`'s epilogues at Swin-B,
  Swin-T and video stage shapes (ragged M, ragged N), the dual GEMM, the
  weight grads and the dgrads (every operand layout) and K5 f32's
  products within 1e-4 abs + rel of their plain versions, their sums
  within 1e-4 (rms + |want|) of f64, the same bits twice; `gemm_f32` with
  W's lo from its caller and split by its own launch (the same bits) at K
  = 128-1024; the lo split against `tf32_split`; K7 f32's dual GEMM with
  the lo parts of W1 and of W2's K-major copy written beside the copy and
  brought by TMA.
"""

import numpy as np
import pytest
import torch

from lavt_rs_tpu_torch import config as C
from lavt_rs_tpu_torch.models.factory import build_model
from lavt_rs_tpu_torch.ops import (fused_mlp, fused_msa, fused_msa_2d, ln,
                                   window_attn)
from lavt_rs_tpu_torch.ops.window import shift_mask_2d, shift_mask_flags_2d

pytestmark = pytest.mark.cuda

TOL = 1e-4
F32 = {"K1": fused_msa.fused_window_msa_ln_f32,
       "K2": fused_msa.fused_window_msa_f32,
       "save": fused_msa.fused_window_msa_save_f32,
       "K5": fused_msa.fused_window_msa_bwd_f32,
       "K6": fused_msa.fused_window_msa_bwd_recompute_f32,
       "K11": fused_msa_2d.fused_window_msa_2d_f32,
       "K3": fused_mlp.fused_ln_mlp_f32, "K4": ln.layer_norm_rows_f32,
       "K10": window_attn.window_attention_f32,
       "K2p": fused_msa.fused_window_msa_grouped_f32,
       "K9": window_attn.attention_core_bwd_f32,
       "K8": fused_mlp.fused_ln_mlp_droppath_f32,
       "K7": fused_mlp.fused_ln_mlp_bwd_f32, "K4b": ln.layer_norm_rows_bwd_f32}
BF16 = {"K1": fused_msa.fused_window_msa_ln,
        "K2": fused_msa.fused_window_msa,
        "K5": fused_msa.fused_window_msa_bwd,
        "K6": fused_msa.fused_window_msa_bwd_recompute,
        "K11": fused_msa_2d.fused_window_msa_2d, "K3": fused_mlp.fused_ln_mlp,
        "K4": ln.layer_norm_rows, "K10": window_attn.window_attention,
        "K2p": fused_msa.fused_window_msa_grouped,
        "K9": window_attn.attention_core_bwd,
        "K8": fused_mlp.fused_ln_mlp_droppath, "K7": fused_mlp.fused_ln_mlp_bwd,
        "K4b": ln.layer_norm_rows_bwd}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda:0")


def _f32(rng, shape, std, dev):
    return torch.from_numpy((rng.standard_normal(shape) * std)
                            .astype(np.float32)).to(dev)


def _close(got, want):
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    err = (got - want).abs()
    assert bool((err <= TOL + TOL * want.abs()).all()), err.max().item()


def _counts():
    return ({k: f.launches for k, f in F32.items()},
            {k: f.launches for k, f in BF16.items()})


def _once(kernel, fn):
    """fn() with `kernel`'s f32 counter up by one and no other counter."""
    f32, bf16 = _counts()
    out = fn()
    f32[kernel] += 1
    assert _counts() == (f32, bf16)
    return out


@pytest.mark.parametrize("rows,c", [(225, 128), (64, 1024), (33, 96)])
def test_layer_norm_rows_f32(dev, rows, c):
    rng = np.random.default_rng(c)
    x = _f32(rng, (rows, c), 2.0, dev) + 0.5
    s = _f32(rng, (c,), 0.2, dev) + 1.0
    b = _f32(rng, (c,), 0.2, dev)
    got = _once("K4", lambda: ln.layer_norm_rows(x, s, b))
    _close(got, ln.layer_norm_rows_plain(x, s, b))
    # K3 f32's LN rows: its prep launch's two-pass variance (no weights)
    xn = torch.empty_like(x)
    fused_mlp._launch("lavt_mlp_f32_prep", x, s, b, None, None, xn, None,
                      None, rows, c, 4 * c, 1e-5)
    _close(xn, fused_mlp.mlp_ln_rows_plain(x, s, b))


@pytest.mark.parametrize("m,c", [(900, 128), (100, 1024)])
def test_ln_mlp_f32(dev, m, c):
    rng = np.random.default_rng(m + c)
    x = _f32(rng, (m, c), 2.0, dev) + 0.5
    args = (x, _f32(rng, (c,), 0.2, dev) + 1.0, _f32(rng, (c,), 0.2, dev),
            _f32(rng, (4 * c, c), c ** -0.5, dev),
            _f32(rng, (4 * c,), 0.2, dev),
            _f32(rng, (c, 4 * c), (4 * c) ** -0.5, dev),
            _f32(rng, (c,), 0.2, dev))
    got = _once("K3", lambda: fused_mlp.fused_ln_mlp(*args))
    want = fused_mlp.fused_ln_mlp_plain(*args)
    _close(got, want)
    _close(got - x, want - x)  # the branch, which x could hide
    # K8 f32 (keep in the residual epilogue): no f32 tensor into a bf16
    # kernel, a bf16 one into none of the f32 kernels
    keep = torch.tensor([1.0 / 0.7, 0.0, 1.0 / 0.7, 1.0 / 0.7], device=dev)
    got = _once("K8", lambda: fused_mlp.fused_ln_mlp_droppath(*args, keep,
                                                              m // 4))
    want = fused_mlp.fused_ln_mlp_droppath_plain(*args, keep, m // 4)
    _close(got, want)
    _close(got - x, want - x)
    with pytest.raises(TypeError):
        fused_mlp.fused_ln_mlp_droppath_f32(x.bfloat16(), *args[1:], keep,
                                            m // 4)


def _msa(rng, dev, c, heads):
    return (_f32(rng, (3 * c, c), c ** -0.5, dev), _f32(rng, (3 * c,), 0.2, dev),
            _f32(rng, (c, c), c ** -0.5, dev), _f32(rng, (c,), 0.2, dev),
            _f32(rng, (heads, 144, 144), 1.0, dev))


@pytest.mark.parametrize("shift", [False, True])
@pytest.mark.parametrize("c,heads", [(128, 4), (256, 8)])
def test_fused_window_msa_ln_f32(dev, shift, c, heads):
    rng = np.random.default_rng(c + shift)
    hw = 24
    x = _f32(rng, (2, 4, 144, c), 2.0, dev) + 0.5
    lnp = (_f32(rng, (c,), 0.2, dev) + 1.0, _f32(rng, (c,), 0.2, dev))
    w = _msa(rng, dev, c, heads)
    mask = shift_mask_2d(hw, hw, 12, 6, dev) if shift else None
    flags = shift_mask_flags_2d(hw, hw, 12, 6, dev) if shift else None
    sc = 32 ** -0.5
    got = _once("K1", lambda: fused_msa.fused_window_msa_ln(
        x, *lnp, *w, mask, heads, sc, flags=flags))
    _close(got, fused_msa.fused_window_msa_ln_plain(x, *lnp, *w, mask, heads,
                                                    sc))


@pytest.mark.parametrize("b,hp,wp,c,heads,shift", [
    (2, 36, 24, 256, 8, True), (1, 24, 24, 512, 16, False),
    (1, 24, 24, 1024, 32, True)])
def test_fused_window_msa_2d_f32(dev, b, hp, wp, c, heads, shift):
    rng = np.random.default_rng(hp + c)
    x = _f32(rng, (b, hp, wp, c), 1.0, dev)
    w = _msa(rng, dev, c, heads)
    mask = shift_mask_2d(hp, wp, 12, 6, dev) if shift else None
    flags = shift_mask_flags_2d(hp, wp, 12, 6, dev) if shift else None
    sc = 32 ** -0.5
    got = _once("K11", lambda: fused_msa_2d.fused_window_msa_2d(
        x, *w, mask, heads, sc, 12, flags))
    _close(got, fused_msa_2d.fused_window_msa_2d_plain(x, *w, mask, heads,
                                                       sc, 12))


def test_f32_save_mode_and_k2_raise_on_the_card(dev):
    """The save mode and K2 take their f32 variants for an f32 tensor (no
    f32 tensor is cast into a bf16 kernel), and the f32 entry points raise
    for a bf16 one (none is cast into an f32 kernel)."""
    rng = np.random.default_rng(5)
    x = _f32(rng, (1, 4, 144, 128), 1.0, dev)
    w = _msa(rng, dev, 128, 4)
    _once("K2", lambda: fused_msa.fused_window_msa(x, *w, None, 4,
                                                   32 ** -0.5))
    _once("save", lambda: fused_msa.fused_window_msa_save(x, None, *w, None,
                                                          4, 32 ** -0.5))
    with pytest.raises(TypeError):
        fused_msa.fused_window_msa_f32(x.bfloat16(), *w, None, 4, 32 ** -0.5)
    with pytest.raises(TypeError):
        fused_msa.fused_window_msa_save_f32(x.bfloat16(), None, *w, None, 4,
                                            32 ** -0.5)


def test_small_f32_window12_model_launches_its_plan(dev):
    """192²: stages 1-3 unpadded (K1), stage 4 padded 6 -> 12 (K11); K3 and
    K4 at C = 128 and 256."""
    from lavt_rs_tpu_torch.eval.refcoco_eval import fwd_iou

    cfg = C.ModelConfig(
        swin=C.SwinConfig(embed_dim=32, depths=(2, 2, 2, 2),
                          num_heads=(1, 2, 4, 8), window_size=12),
        bert=C.BertConfig(num_layers=1), img_size=192, dtype="float32")
    g = torch.Generator(device=dev).manual_seed(0)
    model = build_model(cfg, dev, generator=g)
    plan, _ = model.backbone.kernel_plan((192, 192), 2, itemsize=4)
    assert plan == {"K1": 6, "K11": 2, "K3": 4, "K4": 2}
    for f in list(F32.values()) + list(BF16.values()):
        f.launches = 0
    image = torch.randint(0, 256, (2, 192, 192, 3), generator=g, device=dev,
                          dtype=torch.uint8)
    ids = torch.randint(1000, 20000, (2, 1, 8), generator=g, device=dev)
    mask = torch.ones(2, 1, 8, dtype=torch.long, device=dev)
    inter, union = fwd_iou(model, image, ids, mask,
                           torch.zeros(2, 192 * 192 // 8, dtype=torch.uint8,
                                       device=dev))
    torch.cuda.synchronize()
    assert bool(torch.isfinite(union).all())
    f32, bf16 = _counts()
    assert {k: n for k, n in f32.items() if n} == plan
    assert not any(bf16.values())

    from lavt_rs_tpu_torch.ops.norm import maybe_normalize_image

    ref = build_model(cfg.replace(use_kernels=False), dev)
    ref.load_state_dict(model.state_dict())
    img = maybe_normalize_image(image)
    with torch.no_grad():
        got = model(img, ids[:, 0], mask[:, 0])
        want = ref(img, ids[:, 0], mask[:, 0])
    assert (got - want).abs().max().item() <= 1e-2


# -- K10 f32, K2p f32, K9 f32 ---------------------------------------------------

def _attn(rng, dev, n, masked, b=2, nw=4, heads=3):
    q, k, v, do = (_f32(rng, (b, nw, heads, n, 32), 1.0, dev)
                   for _ in range(4))
    bias = _f32(rng, (heads, n, n), 1.0, dev)
    mask = None
    if masked:  # window 1 masks nothing (its flag 0)
        m = np.where(rng.random((nw, n, n)) > 0.7, -100.0, 0.0)
        m[1] = 0.0
        mask = torch.from_numpy(m.astype(np.float32)).to(dev)
    return q, k, v, bias, mask, do


@pytest.mark.parametrize("n", [16, 49, 57, 196, 392, 400])
@pytest.mark.parametrize("masked", [False, True])
def test_window_attention_f32(dev, n, masked):
    rng = np.random.default_rng(n + masked)
    q, k, v, bias, mask, _ = _attn(rng, dev, n, masked)
    sc = 32 ** -0.5
    want = window_attn.window_attention_plain(q, k, v, bias, mask, sc)
    _close(_once("K10", lambda: window_attn.window_attention(
        q, k, v, bias, mask, sc)), want)
    o, lse = _once("K10", lambda: window_attn.window_attention_save(
        q, k, v, bias, mask, sc))
    wo, wlse = window_attn.window_attention_save_plain(q, k, v, bias, mask, sc)
    _close(o, wo)
    _close(lse, wlse)
    # no atomics: the same bits in a second call
    o2, lse2 = window_attn.window_attention_save(q, k, v, bias, mask, sc)
    torch.cuda.synchronize()
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    # the strided route on a qkv Linear's output
    b, nw, heads, _, _ = q.shape
    qkv = torch.cat([t.transpose(2, 3).reshape(b, nw, n, heads * 32)
                     for t in (q, k, v)], -1).contiguous()
    got = _once("K10", lambda: window_attn.window_attention_qkv(
        qkv, bias, mask, heads, sc))
    _close(got, want.transpose(2, 3).reshape(b, nw, n, heads * 32))
    with pytest.raises(TypeError):  # no f32 tensor into the bf16 kernel
        window_attn.window_attention_f32(q.bfloat16(), k.bfloat16(),
                                         v.bfloat16(), bias, mask, sc)


def test_k10_f32_smem_is_the_plan(dev):
    from lavt_rs_tpu_torch.ops import cuda_lib

    for n in (1, 16, 49, 56, 57, 144, 196, 392, 400):
        assert cuda_lib.lib().lavt_k10_f32_smem(n) == \
            window_attn.k10_f32_plan(8, 2, n, 132)["smem"]


@pytest.mark.parametrize("n", [392, 400])
def test_grouped_attention_f32(dev, n):
    """K2p f32's attention launch: windows [0, nu) maskless, the rest under
    the small mask, nu at 0, mid and nW (uncounted: K2p counts its
    calls)."""
    rng = np.random.default_rng(n)
    b, nw, heads = 2, 5, 3
    qkv = _f32(rng, (b, nw, n, 3 * heads * 32), 1.0, dev)
    bias = _f32(rng, (heads, n, n), 1.0, dev)
    for nu in (0, 2, nw):
        small = torch.from_numpy(np.where(
            rng.random((nw - nu, n, n)) > 0.7, -100.0, 0.0).astype(
            np.float32)).to(dev) if nu < nw else None
        full = None if small is None else torch.cat(
            [small.new_zeros((nu, n, n)), small])
        before = _counts()
        got = window_attn.attention_qkv_grouped(qkv, bias, small, nu, heads,
                                                0.3)
        assert _counts() == before
        _close(got, window_attn.window_attention_qkv_plain(qkv, bias, full,
                                                           heads, 0.3))


@pytest.mark.parametrize("n_p,nu", [(392, 0), (392, 3), (392, 6), (400, 3)])
def test_fused_window_msa_grouped_f32(dev, n_p, nu):
    rng = np.random.default_rng(n_p + nu)
    c, heads, nw = 96, 3, 6
    x = _f32(rng, (1, nw, n_p, c), 1.0, dev)
    w = (_f32(rng, (3 * c, c), c ** -0.5, dev), _f32(rng, (3 * c,), 0.2, dev),
         _f32(rng, (c, c), c ** -0.5, dev), _f32(rng, (c,), 0.2, dev))
    bias = fused_msa.pad_bias_sublane(_f32(rng, (heads, 392, 392), 1.0, dev),
                                      n_p)
    mask = torch.from_numpy(np.where(
        rng.random((nw - nu, n_p, n_p)) > 0.7, -100.0, 0.0).astype(
        np.float32)).to(dev) if nu < nw else None
    args = (x, *w, bias, mask, nu, heads, 32 ** -0.5)
    got = _once("K2p", lambda: fused_msa.fused_window_msa_grouped(*args))
    want = fused_msa.fused_window_msa_grouped_plain(*args)
    _close(got[:, :, :392], want[:, :, :392])
    if (n_p, nu) == (392, 0):  # the padded wrapper: no padding in f32
        sc = 32 ** -0.5
        got = _once("K2p", lambda: fused_msa.fused_window_msa_padded(
            x, *w, bias, mask, heads, sc))
        _close(got, fused_msa.fused_window_msa_plain(x, *w, bias, mask, heads,
                                                     sc))


@pytest.mark.parametrize("n", [49, 392, 400])
@pytest.mark.parametrize("masked", [False, True])
def test_attention_core_bwd_f32(dev, n, masked):
    rng = np.random.default_rng(10 * n + masked)
    q, k, v, bias, mask, do = _attn(rng, dev, n, masked)
    sc = 32 ** -0.5
    o, lse = window_attn.window_attention_save(q, k, v, bias, mask, sc)
    flags = window_attn.mask_flags(mask)
    got = _once("K9", lambda: window_attn.attention_core_bwd(
        q, k, v, bias, mask, do, sc, o, lse, flags))
    want = window_attn.attention_core_bwd_plain(q, k, v, bias, mask, do, sc,
                                                o)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _close(g, w)
    again = window_attn.attention_core_bwd(q, k, v, bias, mask, do, sc, o,
                                           lse, flags)
    torch.cuda.synchronize()
    for g, a in zip(got, again):  # no atomics: the same bits
        assert torch.equal(g, a)
    with pytest.raises(TypeError):  # bf16 gradient into the f32 kernel
        window_attn.attention_core_bwd(q, k, v, bias, mask, do.bfloat16(), sc,
                                       o, lse, flags)


def _zero():
    for f in list(F32.values()) + list(BF16.values()):
        f.launches = 0


def test_small_f32_window7_model_launches_its_plan(dev):
    """Window 7 at 96²: every block's attention on K10 f32 (the strided
    route), K3 f32 at C = 128 and 256, K4 f32."""
    from lavt_rs_tpu_torch.ops.norm import maybe_normalize_image

    cfg = C.ModelConfig(
        swin=C.SwinConfig(embed_dim=32, depths=(2, 2, 2, 2),
                          num_heads=(1, 2, 4, 8), window_size=7),
        bert=C.BertConfig(num_layers=1), img_size=96, dtype="float32")
    g = torch.Generator(device=dev).manual_seed(1)
    model = build_model(cfg, dev, generator=g)
    plan, _ = model.backbone.kernel_plan((96, 96), 2, itemsize=4)
    assert plan["K10"] == 8
    _zero()
    image = torch.randint(0, 256, (2, 96, 96, 3), generator=g, device=dev,
                          dtype=torch.uint8)
    ids = torch.randint(1000, 20000, (2, 8), generator=g, device=dev)
    mask = torch.ones(2, 8, dtype=torch.long, device=dev)
    img = maybe_normalize_image(image)
    with torch.no_grad():
        got = model(img, ids, mask)
    torch.cuda.synchronize()
    f32, bf16 = _counts()
    assert {k: n for k, n in f32.items() if n} == plan
    assert not any(bf16.values())
    ref = build_model(cfg.replace(use_kernels=False), dev)
    ref.load_state_dict(model.state_dict())
    with torch.no_grad():
        want = ref(img, ids, mask)
    assert (got - want).abs().max().item() <= 1e-2


def test_small_f32_video_model_launches_its_plan(dev):
    """Video Swin-T on 8 frames of 64² in f32: K2p f32 at stage 1 (n_p =
    392), K10 f32 in the ten other blocks a forward; a training step takes
    K10 f32's save mode and K9 f32 in all 12 blocks, its loss within 1e-4
    relative of the plain f32 step's."""
    from lavt_rs_tpu_torch.train.optim import TrainConfig
    from lavt_rs_tpu_torch.train.step import (create_train_state,
                                              make_video_train_step)

    img, frames = 64, 8
    cfg = C.lavt_video_tiny().replace(bert=C.BertConfig(num_layers=1),
                                      img_size=img, dtype="float32")
    g = torch.Generator(device=dev).manual_seed(2)
    model = build_model(cfg, dev, generator=g)
    clip = torch.randn(1, frames, img, img, 3, generator=g, device=dev)
    ids = torch.randint(1000, 20000, (1, 22), generator=g, device=dev)
    mask = torch.ones(1, 22, dtype=torch.long, device=dev)
    plan, _ = model.backbone.kernel_plan(frames, (img, img), 4)
    assert plan == {"K2p": 2, "K10": 10}
    _zero()
    with torch.no_grad():
        got = model(clip, ids, mask)
    torch.cuda.synchronize()
    f32, bf16 = _counts()
    assert {k: n for k, n in f32.items() if n} == plan
    assert not any(bf16.values())
    ref = build_model(cfg.replace(use_kernels=False), dev)
    ref.load_state_dict(model.state_dict())
    with torch.no_grad():
        want = ref(clip, ids, mask)
    assert (got - want).abs().max().item() <= 1e-2
    weights = model.state_dict()
    batch = {"video": torch.randint(0, 256, (1, frames, img, img, 3),
                                    generator=g, device=dev,
                                    dtype=torch.uint8),
             "ids": ids, "mask": mask,
             "target": torch.randint(0, 2, (1, img, img), generator=g,
                                     device=dev),
             "valid_index": torch.tensor([3], device=dev)}
    losses = {}
    for kernels in (True, False):
        t = build_model(cfg.replace(use_kernels=kernels), dev, train=True)
        t.load_state_dict(weights)
        tcfg = TrainConfig()
        step = make_video_train_step(t, *create_train_state(t, tcfg), tcfg)
        _zero()
        out = step(batch, torch.Generator(device=dev).manual_seed(3))
        torch.cuda.synchronize()
        losses[kernels] = out["loss"].item()
        f32, bf16 = _counts()
        launched = {k: n for k, n in f32.items() if n}
        assert launched == ({"K10": 12, "K9": 12} if kernels else {})
        assert not any(bf16.values())
    assert abs(losses[True] - losses[False]) <= 1e-4 * abs(losses[False])


# -- K8 f32, K7 f32, K4b f32 ------------------------------------------------------

def _mlp_args(rng, dev, m, c):
    return (_f32(rng, (m, c), 2.0, dev) + 0.5, _f32(rng, (c,), 0.2, dev) + 1.0,
            _f32(rng, (c,), 0.2, dev), _f32(rng, (4 * c, c), c ** -0.5, dev),
            _f32(rng, (4 * c,), 0.2, dev),
            _f32(rng, (c, 4 * c), (4 * c) ** -0.5, dev),
            _f32(rng, (c,), 0.2, dev))


@pytest.mark.parametrize("m,c,rows", [(901, 128, 53), (459, 256, 51),
                                      (225, 512, 25), (105, 1024, 35)])
def test_k8_k7_f32(dev, m, c, rows):
    """K8 f32 and K7 f32 with keep (a dropped sample among them) and K7
    f32 without, on M rows that fill no tile; K7 f32's grads are the same
    bits in two calls (its partials are summed in a fixed order)."""
    rng = np.random.default_rng(m + c)
    args = _mlp_args(rng, dev, m, c)
    x = args[0]
    keep = torch.where(torch.arange(m // rows, device=dev) % 3 == 1, 0.0,
                       1.0 / 0.7)
    got = _once("K8", lambda: fused_mlp.fused_ln_mlp_droppath(*args, keep,
                                                              rows))
    want = fused_mlp.fused_ln_mlp_droppath_plain(*args, keep, rows)
    _close(got, want)
    _close(got - x, want - x)
    gy = _f32(rng, (m, c), 1.0, dev)
    for kp in (keep, None):
        bwd = (x, gy, *args[1:6], kp, rows)
        got = _once("K7", lambda: fused_mlp.fused_ln_mlp_bwd(*bwd))
        want = fused_mlp.fused_ln_mlp_bwd_plain(*bwd)
        for g, w in zip(got, want):
            assert g.shape == w.shape
            _close(g, w)
        again = fused_mlp.fused_ln_mlp_bwd_f32(*bwd)
        torch.cuda.synchronize()
        assert all(torch.equal(g, a) for g, a in zip(got, again))
    with pytest.raises(TypeError):  # a bf16 gradient into the f32 kernel
        fused_mlp.fused_ln_mlp_bwd(x, gy.bfloat16(), *args[1:6], keep, rows)


@pytest.mark.parametrize("m,c", [(901, 128), (459, 256), (225, 512),
                                 (105, 1024)])
def test_k3_f32_launches(dev, m, c):
    """K3 f32's three launches against their plain versions: the prep's LN
    rows within 1e-4 and the weights' lo parts bit for bit; fc1 + GELU and
    fc2 + residual with W's lo by TMA within 1e-4 abs + rel, and the same
    bits as with W split by the core's stagers (bias and GELU epilogues);
    K3 f32 and K8 f32 the same bits in two calls."""
    rng = np.random.default_rng(3 * m + c)
    x, g, be, w1, b1, w2, b2 = _mlp_args(rng, dev, m, c)
    xn, w1lo, w2lo = fused_mlp.mlp_f32_prep(x, g, be, w1, w2)
    wxn, w1lo_, w2lo_ = fused_mlp.mlp_f32_prep_plain(x, g, be, w1, w2)
    _close(xn, wxn)
    assert torch.equal(w1lo, w1lo_) and torch.equal(w2lo, w2lo_)
    want_h = fused_mlp.gemm_bias_gelu_plain(xn, w1, b1)
    _close(fused_mlp.gemm_gelu_f32(xn, w1, w1lo, b1), want_h)
    want = fused_mlp.gemm_residual_plain(want_h, w2, b2, x)
    _close(fused_mlp.gemm_residual_f32(want_h, w2, w2lo, b2, x), want)
    for epi in (fused_msa.GEMM_F32_BIAS, fused_msa.GEMM_F32_GELU):
        assert torch.equal(fused_msa.gemm_f32(xn, w1, b1, epi, wlo=w1lo),
                           fused_msa.gemm_f32(xn, w1, b1, epi))
    for fn in (lambda: fused_mlp.fused_ln_mlp_f32(x, g, be, w1, b1, w2, b2),
               lambda: fused_mlp.fused_ln_mlp_droppath_f32(
                   x, g, be, w1, b1, w2, b2,
                   torch.tensor([1.0 / 0.7], device=dev), m)):
        got, again = fn(), fn()
        torch.cuda.synchronize()
        assert torch.equal(got, again)


@pytest.mark.parametrize("rows,c", [(225, 128), (1001, 256), (333, 512),
                                    (64, 1024), (33, 96), (50, 1536)])
def test_layer_norm_rows_bwd_f32(dev, rows, c):
    rng = np.random.default_rng(rows + c)
    x = _f32(rng, (rows, c), 2.0, dev) + 0.5
    s = _f32(rng, (c,), 0.2, dev) + 1.0
    g = _f32(rng, (rows, c), 1.0, dev)
    from lavt_rs_tpu_torch.ops import cuda_lib

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = ln.ln_rows_f32_bwd_plan(rows, c, sms)
    assert cuda_lib.lib().lavt_layer_norm_rows_bwd_f32_ws(rows, c) == (
        plan["blocks"] + plan["groups"])
    got = _once("K4b", lambda: ln.layer_norm_rows_bwd(x, s, g))
    want = ln.layer_norm_rows_bwd_plain(x, s, g)
    for a, w in zip(got, want):
        _close(a, w)
    again = ln.layer_norm_rows_bwd_f32(x, s, g)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_small_f32_window7_model_trains_on_its_plan(dev):
    """A window-7 lavt_one at 96² in f32 with DropPath on: one training
    step launches its plan on the f32 kernels (K10 f32's save mode and K9
    f32 in every block, K3 f32 / K8 f32 and K7 f32 at C = 128 and 256, K4
    f32 and K4b f32) and no bf16 kernel, its loss within 1e-4 relative of
    the plain f32 step's from the same weights and generator."""
    from lavt_rs_tpu_torch.train.optim import TrainConfig
    from lavt_rs_tpu_torch.train.step import (create_train_state,
                                              make_train_step)

    cfg = C.ModelConfig(
        swin=C.SwinConfig(embed_dim=32, depths=(2, 2, 2, 2),
                          num_heads=(1, 2, 4, 8), window_size=7,
                          drop_path_rate=0.3),
        bert=C.BertConfig(num_layers=1), img_size=96, dtype="float32")
    g = torch.Generator(device=dev).manual_seed(4)
    weights = build_model(cfg, dev, generator=g).state_dict()
    batch = {"image": torch.randint(0, 256, (2, 96, 96, 3), generator=g,
                                    device=dev, dtype=torch.uint8),
             "ids": torch.randint(1000, 20000, (2, 8), generator=g,
                                  device=dev),
             "mask": torch.ones(2, 8, dtype=torch.long, device=dev),
             "target": torch.randint(0, 2, (2, 96, 96), generator=g,
                                     device=dev)}
    losses = {}
    for kernels in (True, False):
        t = build_model(cfg.replace(use_kernels=kernels), dev, train=True)
        t.load_state_dict(weights)
        plan, _ = t.backbone.kernel_plan((96, 96), 2, 4, True)
        assert {"K8", "K7", "K4b", "K9"} <= set(plan) or not kernels
        tcfg = TrainConfig()
        step = make_train_step(t, *create_train_state(t, tcfg), tcfg)
        _zero()
        out = step(batch, torch.Generator(device=dev).manual_seed(5))
        torch.cuda.synchronize()
        losses[kernels] = out["loss"].item()
        f32, bf16 = _counts()
        assert {k: n for k, n in f32.items() if n} == (plan if kernels
                                                       else {})
        assert not any(bf16.values())
    assert abs(losses[True] - losses[False]) <= 1e-4 * abs(losses[False])


# -- the save mode f32, K5 f32, K6 f32, K2 f32 (window-12 f32 training) --------

def _window12(rng, dev, c, heads, shift, bias_std=1.0, b=2):
    """x (b, 4, 144, C), LN parameters, the MSA weights with a bias table
    of std bias_std, the shift mask of a 24 x 24 map and its flags."""
    x = _f32(rng, (b, 4, 144, c), 2.0, dev) + 0.5
    lnp = (_f32(rng, (c,), 0.2, dev) + 1.0, _f32(rng, (c,), 0.2, dev))
    w = _msa(rng, dev, c, heads)
    w = w[:4] + (w[4] * bias_std,)
    mask = shift_mask_2d(24, 24, 12, 6, dev) if shift else None
    flags = shift_mask_flags_2d(24, 24, 12, 6, dev) if shift else None
    return x, lnp, w, mask, flags


@pytest.mark.parametrize("with_ln,shift", [(True, True), (False, True),
                                           (False, False)])
@pytest.mark.parametrize("c,heads", [(128, 4), (512, 16)])
def test_save_mode_f32(dev, with_ln, shift, c, heads):
    rng = np.random.default_rng(c + 2 * with_ln + shift)
    x, lnp, w, mask, flags = _window12(rng, dev, c, heads, shift)
    lnp = lnp if with_ln else None
    sc = 32 ** -0.5
    y, got = _once("save", lambda: fused_msa.fused_window_msa_save(
        x, lnp, *w, mask, heads, sc, flags=flags))
    want = fused_msa.fused_window_msa_save_plain(x, lnp, *w, mask, heads, sc)
    _close(y, want[0])
    for g, wt in zip(got, want[1]):
        assert (g is None) == (wt is None)
        if g is not None:
            _close(g, wt)
    assert got[0].stride() == (144 * 3 * c, 3 * c, 1)  # views of qkv


def _msa_chain(x, wqkv, bqkv, wproj, bproj, bias, mask, heads, scale):
    """The window MSA as a PyTorch chain in x's dtype (the f64 reference
    of the backward's sums)."""
    b, nw, n, c = x.shape
    qkv = (x @ wqkv.t() + bqkv).view(b, nw, n, 3, heads, c // heads)
    q, k, v = qkv.permute(3, 0, 1, 4, 2, 5)
    s = (q * scale) @ k.transpose(-1, -2) + bias
    if mask is not None:
        s = s + mask[:, None]
    o = (s.softmax(-1) @ v).permute(0, 1, 3, 2, 4).reshape(b, nw, n, c)
    return o @ wproj.t() + bproj


def _check_msa_grads(got, plain, x, w, mask, gy, heads, scale):
    """K5 / K6 f32's (dx, dwqkv, dbqkv, dwproj, dbproj, dbias): dx within
    1e-4 abs + rel of the plain version's, each sum over rows or windows
    within 1e-4 (rms + |want|) of its f64 value (autograd through
    `_msa_chain` in f64 from x, the MSA's input): an f32 sum of ~1000
    terms carries f32 rounding on the scale of its terms, in the plain
    version as in the kernel (chip_smoke.py's `check_f32_backward`)."""
    _close(got[0], plain[0])
    leaves = [t.double().requires_grad_() for t in (x, *w)]
    y = _msa_chain(*leaves, None if mask is None else mask.double(), heads,
                   scale)
    ref = torch.autograd.grad(y, leaves, gy.double())
    for g, r in zip(got[1:], ref[1:]):
        assert g.shape == r.shape and bool(torch.isfinite(g).all())
        e = (g.double() - r).abs() / (r.square().mean().sqrt() + r.abs())
        assert e.max().item() <= TOL, e.max().item()


@pytest.mark.parametrize("shift", [False, True])
@pytest.mark.parametrize("c,heads", [(128, 4), (256, 8), (96, 3)])
def test_k5_f32(dev, shift, c, heads):
    rng = np.random.default_rng(3 * c + shift)
    x, _, w, mask, flags = _window12(rng, dev, c, heads, shift)
    sc = 32 ** -0.5
    _, (q, k, v, p, _) = fused_msa.fused_window_msa_save_f32(
        x, None, *w, mask, heads, sc, flags=flags)
    gy = _f32(rng, x.shape, 1.0, dev)

    def k5():
        return fused_msa.fused_window_msa_bwd(x, gy, w[0], w[2], (q, k, v, p),
                                              heads, sc)

    got = _once("K5", k5)
    want = fused_msa.fused_window_msa_bwd_plain(x, gy, w[0], w[2],
                                                (q, k, v, p), heads, sc)
    _check_msa_grads(got, want, x, w, mask, gy, heads, sc)
    again = k5()
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("with_ln", [True, False])
def test_k6_f32(dev, with_ln):
    rng = np.random.default_rng(17 + with_ln)
    x, lnp, w, mask, flags = _window12(rng, dev, 128, 4, True)
    lnp = lnp if with_ln else None
    gy = _f32(rng, x.shape, 1.0, dev)
    sc = 32 ** -0.5
    got = _once("K6", lambda: fused_msa.fused_window_msa_bwd_recompute(
        x, lnp, *w, mask, gy, 4, sc, flags=flags))
    want = fused_msa.fused_window_msa_bwd_recompute_plain(x, lnp, *w, mask,
                                                          gy, 4, sc)
    xin = x if lnp is None else ln.layer_norm_rows_plain(x, *lnp)
    _check_msa_grads(got, want, xin, w, mask, gy, 4, sc)


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("c,heads,shift", [(512, 16, True), (1024, 32, False)])
def test_k2_f32(dev, exact, c, heads, shift):
    rng = np.random.default_rng(c + exact)
    x, _, w, mask, flags = _window12(rng, dev, c, heads, shift, b=1)
    sc = 32 ** -0.5
    got = _once("K2", lambda: fused_msa.fused_window_msa(
        x, *w, mask, heads, sc, flags, exact=exact))
    _close(got, fused_msa.fused_window_msa_plain(x, *w, mask, heads, sc,
                                                 exact))


def test_f7_softmax_forms_past_80_on_the_card(dev):
    """F7 with logits past 80 (a bias table of std 60): K1 f32 at inference
    takes exp(min(s, 80)) (its plain version's form, not the exact one);
    the taped forward (`window_msa` under autograd, K1 f32 exact when the
    block saves nothing) and the save mode f32's P, which K6 f32
    recomputes, take the exact softmax."""
    rng = np.random.default_rng(80)
    x, lnp, w, mask, flags = _window12(rng, dev, 128, 4, True, 60.0)
    sc = 32 ** -0.5
    clamp = fused_msa.fused_window_msa_ln_plain(x, *lnp, *w, mask, 4, sc,
                                                exact=False)
    exact = fused_msa.fused_window_msa_ln_plain(x, *lnp, *w, mask, 4, sc)
    assert (clamp - exact).abs().max().item() > 1e-2
    got = _once("K1", lambda: fused_msa.fused_window_msa_ln(
        x, *lnp, *w, mask, 4, sc, flags=flags))
    _close(got, clamp)
    taped = _once("K1", lambda: fused_msa.fused_window_msa_ln(
        x, *lnp, *w, mask, 4, sc, flags=flags, exact=True))
    _close(taped, exact)
    _, saved = fused_msa.attn_launches(x, lnp, w[0], w[1], w[4], mask, 4, sc,
                                       flags=flags)
    _, want = fused_msa.fused_window_msa_save_plain(x, lnp, *w, mask, 4, sc)
    _close(saved[3], want[3])  # K6 f32's P: the exact softmax


def _f32_train_counts(backbone, img, batch):
    """The f32 counters of one training step, from each block's kernels: a
    block's K1 / K2 counts on the save mode f32 where its backward is K5,
    else on K1 f32 / K2 f32 (taped, exact); K4 and K4b from the plan."""
    plan = backbone.kernel_plan(img, batch, 4, True)[0]
    counts = {k: n for k, n in plan.items() if k in ("K4", "K4b")}
    hw = tuple(-(-s // 4) for s in img)
    for layer in backbone.layers:
        for blk in layer.blocks:
            ks = blk.kernels(hw, batch, 4, True)
            for k in ks:
                key = "save" if k in ("K1", "K2") and "K5" in ks else k
                counts[key] = counts.get(key, 0) + 1
        hw = ((hw[0] + 1) // 2, (hw[1] + 1) // 2)
    return counts


@pytest.mark.parametrize("resid", [True, False])
def test_small_f32_window12_model_trains_on_its_plan(dev, monkeypatch, resid):
    """A window-12 lavt_one at 192² in f32 with DropPath on (K1 at stages
    1-3, K2 at stage 4): one training step launches its plan on the f32
    kernels and no bf16 kernel, saving its residuals (the save mode f32 and
    K5 f32) or, past a zero residual cap, recomputing them (K1 f32 / K2 f32
    taped, K6 f32); its loss within 1e-4 relative of the plain f32 step's
    from the same weights and generator."""
    from lavt_rs_tpu_torch.train.optim import TrainConfig
    from lavt_rs_tpu_torch.train.step import (create_train_state,
                                              make_train_step)

    if not resid:
        monkeypatch.setattr(fused_msa, "RESID_CAP_BYTES", 0)
    cfg = C.ModelConfig(
        swin=C.SwinConfig(embed_dim=32, depths=(2, 2, 2, 2),
                          num_heads=(1, 2, 4, 8), window_size=12,
                          drop_path_rate=0.3),
        bert=C.BertConfig(num_layers=1), img_size=192, dtype="float32")
    g = torch.Generator(device=dev).manual_seed(6)
    weights = build_model(cfg, dev, generator=g).state_dict()
    batch = {"image": torch.randint(0, 256, (2, 192, 192, 3), generator=g,
                                    device=dev, dtype=torch.uint8),
             "ids": torch.randint(1000, 20000, (2, 8), generator=g,
                                  device=dev),
             "mask": torch.ones(2, 8, dtype=torch.long, device=dev),
             "target": torch.randint(0, 2, (2, 192, 192), generator=g,
                                     device=dev)}
    losses = {}
    for kernels in (True, False):
        t = build_model(cfg.replace(use_kernels=kernels), dev, train=True)
        t.load_state_dict(weights)
        want = _f32_train_counts(t.backbone, (192, 192), 2) if kernels else {}
        if kernels:
            assert ("K5" in want) == resid and ("K6" in want) != resid
        tcfg = TrainConfig()
        step = make_train_step(t, *create_train_state(t, tcfg), tcfg)
        _zero()
        out = step(batch, torch.Generator(device=dev).manual_seed(7))
        torch.cuda.synchronize()
        losses[kernels] = out["loss"].item()
        f32, bf16 = _counts()
        assert {k: n for k, n in f32.items() if n} == want
        assert not any(bf16.values())
    assert abs(losses[True] - losses[False]) <= 1e-4 * abs(losses[False])


# -- the 3xTF32 wgmma + TMA core (csrc/gemm_tf32_sm90.cuh) -----------------------

def _sums_close(got, want64):
    """A sum within TOL (rms + |want|) of its f64 value."""
    torch.cuda.synchronize()
    rms = want64.pow(2).mean().sqrt()
    err = (got.double() - want64).abs()
    assert bool((err <= TOL * (rms + want64.abs())).all()), \
        (err / (rms + want64.abs())).max().item()


def _twice(fn):
    """fn()'s outputs, checked to be the same bits in a second call."""
    got, again = fn(), fn()
    torch.cuda.synchronize()
    got_t = got if isinstance(got, tuple) else (got,)
    again_t = again if isinstance(again, tuple) else (again,)
    assert all(torch.equal(a, b) for a, b in zip(got_t, again_t))
    return got


def test_tf32_core_smem_is_the_plan(dev):
    from lavt_rs_tpu_torch.ops import cuda_lib, tf32_core

    lib = cuda_lib.lib()
    for kind, idx in tf32_core.SMEM_KIND.items():
        assert lib.lavt_tf32_core_smem(idx) == tf32_core.ring(kind)["smem"]
    assert lib.lavt_tf32_core_smem(3) == -1


# (M, N, K) of `gemm_f32` (both operands K-major): Swin-B stage 1 fc1 /
# fc2 and stage 4's (M cut, ragged), Swin-T / Video Swin-T C = 96 (qkv N =
# 288, a ragged last column tile; the out-projection N = 96 < 128), K2p
# f32's qkv and stage-3 widths; M of one row, of 33
CORE_GEMMS = [(2085, 512, 128), (2085, 128, 512), (1805, 4096, 1024),
              (1805, 1024, 4096), (1571, 288, 96), (1571, 96, 96),
              (700, 384, 96), (700, 96, 384), (457, 1536, 512), (1, 256, 128),
              (33, 768, 768)]


@pytest.mark.parametrize("m,n,k", CORE_GEMMS)
def test_tf32_core_gemm_every_epilogue(dev, m, n, k):
    """`gemm_f32`'s three epilogues (bias with q's scale on the first
    columns, GELU, residual with and without keep), each with w's lo split
    by gemm_f32's own launch and given by the caller, within 1e-4 abs + rel of
    their f32 plain versions and the bias's sums within 1e-4 (rms +
    |want|) of f64; the same bits twice."""
    rng = np.random.default_rng(m + n + k)
    a = _f32(rng, (m, k), 1.0, dev)
    w = _f32(rng, (n, k), k ** -0.5, dev)
    b = _f32(rng, (n,), 0.2, dev)
    acc = a @ w.t() + b
    acc64 = a.double() @ w.double().t() + b.double()
    col = torch.arange(n, device=dev) < n // 3
    res = _f32(rng, (m, n), 1.0, dev)
    rows = m // 2 if m % 2 == 0 else m
    keep = torch.where(torch.arange(m // rows, device=dev) % 2 == 1, 0.0,
                       1.0 / 0.7)
    gemm = fused_msa.gemm_f32
    for lo in (None, fused_mlp.tf32_split(w)[1]):  # split by gemm_f32, given
        got = _twice(lambda: gemm(a, w, b, fused_msa.GEMM_F32_BIAS,
                                  scaled=n // 3, scale=0.17, wlo=lo))
        _close(got, torch.where(col, acc * 0.17, acc))
        _sums_close(got, torch.where(col, acc64 * 0.17, acc64))
        _close(_twice(lambda: gemm(a, w, b, fused_msa.GEMM_F32_GELU, wlo=lo)),
               fused_mlp.gemm_bias_gelu_plain(a, w, b))
        _close(_twice(lambda: gemm(a, w, b, fused_msa.GEMM_F32_RESIDUAL,
                                   res=res, wlo=lo)),
               fused_mlp.gemm_residual_plain(a, w, b, res))
        got = _twice(lambda: gemm(a, w, b, fused_msa.GEMM_F32_RESIDUAL,
                                  res=res, keep=keep, rows=rows, wlo=lo))
        want = fused_mlp.gemm_residual_plain(a, w, b, res, keep, rows)
        _close(got, want)
        _close(got - res, want - res)


# (M, C) of K7 f32's and K5 f32's products on the core: Swin-B stages 1, 2
# and 4 (M cut, ragged) and the width 384; K5 f32's also at the Swin-T /
# Video Swin-T width 96 (`test_tf32_core_k5_products_at_96`)
CORE_BWD = [(2085, 128), (333, 1024), (1571, 384), (203, 256)]


@pytest.mark.parametrize("m,c", CORE_BWD)
def test_tf32_core_dual_wgrad_dgrad(dev, m, c):
    """The dual GEMM (W2 through its K-major copy, W1's and the copy's lo
    by TMA), the weight grads (A's
    MN-major fragments read in place, B transposed by the stagers; split
    over M by K7 f32's plan) and dyln / K5 f32's dattn and dx (B read as
    (K, N), transposed by the stagers): within 1e-4 abs + rel of their f32
    plain versions, the products' sums within 1e-4 (rms + |want|) of f64,
    the same bits twice."""
    rng = np.random.default_rng(m + c)
    hidden = 4 * c
    xn = _f32(rng, (m, c), 1.0, dev)
    dmlp = _f32(rng, (m, c), 1.0, dev)
    w1 = _f32(rng, (hidden, c), c ** -0.5, dev)
    b1 = _f32(rng, (hidden,), 0.2, dev)
    w2 = _f32(rng, (c, hidden), hidden ** -0.5, dev)
    got = _twice(lambda: fused_mlp.dual_gemm_gelu_bwd(xn, dmlp, w1, b1, w2))
    want = fused_mlp.dual_gemm_gelu_bwd_plain(xn, dmlp, w1, b1, w2)
    for g, w_ in zip(got, want):
        assert g.shape == w_.shape
        _close(g, w_)
    h, dhpre, _ = got
    plan = fused_mlp.bwd_plan(m, c, hidden, f32=True)
    for a, b_ in ((dmlp, h), (dhpre, xn)):
        part = _twice(lambda a=a, b_=b_: fused_mlp.wgrad(a, b_,
                                                        plan.split_rows))
        assert part.shape[0] == plan.splits
        _close(part, fused_mlp.wgrad_plain(a, b_, plan.split_rows))
        _sums_close(fused_msa.sum_partials(part), a.double().t() @ b_.double())
    dyln = _twice(lambda: fused_mlp.dgrad(dhpre, w1))
    _close(dyln, fused_mlp.dgrad_plain(dhpre, w1))
    _sums_close(dyln, dhpre.double() @ w1.double())


def _k5_products(rng, dev, m, c):
    """K5 f32's products on the core at (M, C): dattn = gy Wproj, dx = dqkv
    Wqkv (B read as (K, N)) and the weight grads dWqkv, dWproj (split over
    M by K7 f32's rule)."""
    for kk in (c, 3 * c):
        a = _f32(rng, (m, kk), 1.0, dev)
        wt = _f32(rng, (kk, c), kk ** -0.5, dev)
        got = _twice(lambda a=a, wt=wt: fused_msa.msa_dgrad(a, wt))
        _close(got, fused_msa.msa_dgrad_plain(a, wt))
        _sums_close(got, a.double() @ wt.double())
        x = _f32(rng, (m, c), 1.0, dev)
        sr = fused_mlp.wgrad_split_tiles(m, kk, c, 1, fused_mlp.GEMM_F32_DEPTH,
                                         1) * fused_mlp.GEMM_F32_DEPTH
        part = _twice(lambda a=a, x=x: fused_mlp.wgrad(a, x, sr))
        _close(part, fused_mlp.wgrad_plain(a, x, sr))
        _sums_close(fused_msa.sum_partials(part), a.double().t() @ x.double())


@pytest.mark.parametrize("m,c", [(1571, 96), (333, 1024)])
def test_tf32_core_k5_products(dev, m, c):
    _k5_products(np.random.default_rng(m + c + 5), dev, m, c)


# The f32 MSA attention: (order, B (map) or B nW (window order), the map's
# sides, C, heads): a 36 x 24 map; the stage-4 shape; 20 windows x 8 heads
# (160 items on 132 SMs: runs of one or two windows that cross heads
# mid-way); 16 items, fewer than the SMs
ATTN_CASES = [("map", 2, (36, 24), 256, 8), ("map", 2, (24, 24), 1024, 32),
              ("window", 20, (24, 24), 256, 8), ("map", 1, (24, 24), 128, 4)]
ATTN_PARAMS = [(*case, mode, masking) for case in ATTN_CASES
               for mode in ("clamp", "exact", "save")
               for masking in ("none", "flags", "no flags")
               if not (case[0] == "map" and mode == "save")]


@pytest.mark.parametrize("order,b,hw,c,heads,mode,masking", ATTN_PARAMS)
def test_msa_attention_f32(dev, order, b, hw, c, heads, mode, masking):
    """The f32 attention launch in window order (K1 f32, K2 f32, the save
    mode f32) and map order (K11 f32), each mode and masking against its
    plain version within 1e-4 abs + rel (the save mode's P too), the same
    bits twice."""
    rng = np.random.default_rng(b + c + heads + len(mode) + len(masking))
    hp, wp = hw
    shape = ((b, hp, wp, 3 * c) if order == "map"
             else (b, 144, 3 * c))
    qkv = _f32(rng, shape, 1.0, dev)
    bias = _f32(rng, (heads, 144, 144), 1.0, dev)
    mask = flags = None
    if masking != "none":
        mask = shift_mask_2d(hp, wp, 12, 6, dev)
        if masking == "flags":
            flags = shift_mask_flags_2d(hp, wp, 12, 6, dev)
    exact = mode != "clamp"
    if order == "map":
        got = _twice(lambda: fused_msa_2d.msa_attn_map_f32(
            qkv, bias, mask, heads, flags, exact))
        _close(got, fused_msa_2d.msa_attn_map_plain(qkv, bias, mask, heads,
                                                    exact))
        return
    save = mode == "save"
    want_o, want_p = fused_msa.msa_attn_plain(qkv, bias, mask, heads, exact)
    if save:
        o, p = _twice(lambda: fused_msa.msa_attn_f32(qkv, bias, mask, heads,
                                                     flags, True, exact))
        _close(p, want_p)
    else:
        o = _twice(lambda: fused_msa.msa_attn_f32(qkv, bias, mask, heads,
                                                  flags, False, exact)[0])
        assert fused_msa.msa_attn_f32(qkv, bias, mask, heads, flags)[1] is None
    _close(o, want_o)


@pytest.mark.parametrize("k", [128, 256, 512, 1024])
def test_gemm_f32_lo_given_or_split(dev, k):
    """`gemm_f32` at the Swin-B widths (qkv: N = 3K; the out-projection: N
    = K), each epilogue, with W's lo from its caller and split by its own
    launch: the same bits, within 1e-4 abs + rel of the plain versions;
    the split (`tf32_lo`) is `tf32_split`'s lo bit for bit."""
    rng = np.random.default_rng(k)
    m = 1000
    a = _f32(rng, (m, k), 1.0, dev)
    res = _f32(rng, (m, k), 1.0, dev)
    for n in (3 * k, k):
        w = _f32(rng, (n, k), k ** -0.5, dev)
        b = _f32(rng, (n,), 0.2, dev)
        lo = fused_msa.tf32_lo(w)
        assert torch.equal(lo, fused_mlp.tf32_split(w)[1])
        for epi, kw, want in (
                (fused_msa.GEMM_F32_BIAS, {"scaled": n // 3, "scale": 0.17},
                 fused_msa.gemm_bias_plain(a, w, b, n // 3, 0.17)),
                (fused_msa.GEMM_F32_GELU, {},
                 fused_mlp.gemm_bias_gelu_plain(a, w, b))) + ((
                (fused_msa.GEMM_F32_RESIDUAL, {"res": res},
                 fused_mlp.gemm_residual_plain(a, w, b, res)),) if n == k
                else ()):
            given = _twice(lambda: fused_msa.gemm_f32(a, w, b, epi, wlo=lo,
                                                      **kw))
            split = fused_msa.gemm_f32(a, w, b, epi, **kw)
            torch.cuda.synchronize()
            assert torch.equal(given, split)
            _close(given, want)


@pytest.mark.parametrize("m,c", [(2085, 128), (333, 1024)])
def test_k7_f32_dual_gemm_lo_by_tma(dev, m, c):
    """K7 f32's dual GEMM: its first launch writes W2's K-major copy, the
    copy's lo parts and W1's (`tf32_split`'s, bit for bit) into its
    scratch, which TMA brings beside W1 and the copy; h, dhpre and the db1
    partials within 1e-4 abs + rel of the plain version."""
    rng = np.random.default_rng(m + c + 7)
    hidden = 4 * c
    xn = _f32(rng, (m, c), 1.0, dev)
    dmlp = _f32(rng, (m, c), 1.0, dev)
    w1 = _f32(rng, (hidden, c), c ** -0.5, dev)
    b1 = _f32(rng, (hidden,), 0.2, dev)
    w2 = _f32(rng, (c, hidden), hidden ** -0.5, dev)
    h, dhpre = (torch.empty((m, hidden), device=dev) for _ in range(2))
    db1 = torch.empty((-(-m // fused_mlp.DUAL_ROWS), hidden), device=dev)
    w2t = torch.full((3, hidden, c), float("nan"), device=dev)
    fused_mlp._launch("lavt_dual_gemm_gelu_bwd_f32", xn, dmlp, w1, b1, w2, h,
                      dhpre, db1, w2t, m, c, hidden)
    torch.cuda.synchronize()
    copy = w2.t().contiguous()
    assert torch.equal(w2t[0], copy)
    assert torch.equal(w2t[1], fused_mlp.tf32_split(copy)[1])
    assert torch.equal(w2t[2], fused_mlp.tf32_split(w1)[1])
    for got, want in zip((h, dhpre, db1), fused_mlp.dual_gemm_gelu_bwd_plain(
            xn, dmlp, w1, b1, w2)):
        _close(got, want)
