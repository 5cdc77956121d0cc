"""The f32 variants of K1, K11, K3 and K4 on the card.  Marked `cuda`;
every test skips without a CUDA device.  Runs without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_f32_cuda.py

* each f32 variant against its f32 plain version at small stage-shaped
  sizes (shifted and unshifted windows, a non-square map, a width of
  masked words), within 1e-4 abs + 1e-4 rel with TF32 off (3xTF32
  products and f32 sums in another order; one TF32 pass, ~5e-4 relative,
  fails it), counted on its own counter and on no bf16 one;
* a small f32 window-12 model on the card: its f32 launches equal its
  `kernel_plan` at itemsize 4, no bf16 kernel runs, and its logits agree
  with the plain f32 model's within 1e-2 (chip_smoke.py's f32 gate).
"""

import numpy as np
import pytest
import torch

from lavt_rs_tpu_torch import config as C
from lavt_rs_tpu_torch.models.factory import build_model
from lavt_rs_tpu_torch.ops import fused_mlp, fused_msa, fused_msa_2d, ln
from lavt_rs_tpu_torch.ops.window import shift_mask_2d, shift_mask_flags_2d

pytestmark = pytest.mark.cuda

TOL = 1e-4
F32 = {"K1": fused_msa.fused_window_msa_ln_f32,
       "K11": fused_msa_2d.fused_window_msa_2d_f32,
       "K3": fused_mlp.fused_ln_mlp_f32, "K4": ln.layer_norm_rows_f32}
BF16 = {"K1": fused_msa.fused_window_msa_ln,
        "K11": fused_msa_2d.fused_window_msa_2d, "K3": fused_mlp.fused_ln_mlp,
        "K4": ln.layer_norm_rows}


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
    # K3 f32's LN rows: the same launch with the two-pass variance
    _close(ln.layer_norm_rows_f32_launch(x, s, b, two_pass=True),
           fused_mlp.mlp_ln_rows_plain(x, s, b))


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
    keep = torch.ones(4, device=dev)  # K8 has no f32 variant yet
    with pytest.raises(TypeError):
        fused_mlp.fused_ln_mlp_droppath(*args, keep, m // 4)
    with pytest.raises(NotImplementedError, match="no f32 variant"):
        fused_mlp.gemm_residual(x.repeat(1, 4), *args[5:], x, keep, m // 4)


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
    """No f32 variant yet: an f32 tensor raises, and is never cast into a
    bf16 kernel."""
    rng = np.random.default_rng(5)
    x = _f32(rng, (1, 4, 144, 128), 1.0, dev)
    w = _msa(rng, dev, 128, 4)
    with pytest.raises(TypeError):
        fused_msa.fused_window_msa(x, *w, None, 4, 32 ** -0.5)
    with pytest.raises(TypeError):
        fused_msa.fused_window_msa_save(x, None, *w, None, 4, 32 ** -0.5)


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
    assert f32 == plan and not any(bf16.values())

    from lavt_rs_tpu_torch.ops.norm import maybe_normalize_image

    ref = build_model(cfg.replace(use_kernels=False), dev)
    ref.load_state_dict(model.state_dict())
    img = maybe_normalize_image(image)
    with torch.no_grad():
        got = model(img, ids[:, 0], mask[:, 0])
        want = ref(img, ids[:, 0], mask[:, 0])
    assert (got - want).abs().max().item() <= 1e-2
