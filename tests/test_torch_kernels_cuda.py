"""The hand-written CUDA kernels (K1-K11, K2p) against their plain
PyTorch versions, on the card.  Marked `cuda`; every test skips without a CUDA device.

Runs without JAX (the repo's conftest imports it), so on the GPU machine:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

Inputs are bf16; the plain versions compute in f32 from the same bf16
inputs and round where the kernels round.  Tolerances: bf16 keeps 8
significant bits (relative step 2^-8 ≈ 3.9e-3), so one rounding of an O(1)
output is ≤ 4e-3 and a rounding that lands on the other side of a
neighbouring intermediate (the bf16 LN output, GELU output, q/k/v, P)
moves the result by a few such steps: 2e-2 (≈ 5 steps) for LN and MLP,
3e-2 for the MSA, whose P and attention output are rounded twice more.

The backward kernels (K5, K6, K7) are held to their plain versions on the
same bf16 inputs: elementwise outputs (dx) within TOL_DX · (rms + |want|),
the rms of the wanted tensor standing for its scale, and the weight, bias
and bias-table grads, sums over all rows of products of bf16-rounded
factors, within a relative Frobenius error of TOL_GRAD.  The saved
probabilities P are within TOL_P absolute plus TOL_MSA relative.
"""

import numpy as np
import pytest
import torch

from lavt_rs_tpu_torch.ops.fused_mlp import (
    fused_ln_mlp, fused_ln_mlp_bwd, fused_ln_mlp_bwd_plain,
    fused_ln_mlp_droppath, fused_ln_mlp_droppath_plain, fused_ln_mlp_plain)
from lavt_rs_tpu_torch.ops.fused_msa import (
    fused_window_msa, fused_window_msa_bwd, fused_window_msa_bwd_plain,
    fused_window_msa_grouped, fused_window_msa_grouped_plain,
    fused_window_msa_bwd_recompute, fused_window_msa_bwd_recompute_plain,
    fused_window_msa_ln, fused_window_msa_ln_plain, fused_window_msa_plain,
    fused_window_msa_save, fused_window_msa_save_plain, pad_bias_sublane)
from lavt_rs_tpu_torch.ops.fused_msa_2d import (fused_window_msa_2d,
                                                fused_window_msa_2d_plain)
from lavt_rs_tpu_torch.ops.ln import layer_norm_rows, layer_norm_rows_plain
from lavt_rs_tpu_torch.ops.window import (partition_3d_groups,
                                          relative_bias_from_table,
                                          relative_bias_from_table_3d,
                                          relative_position_index_2d,
                                          relative_position_index_3d,
                                          shift_mask_2d, window_partition,
                                          window_reverse)
from lavt_rs_tpu_torch.ops.window_attn import (
    attention_core_bwd, attention_core_bwd_plain, window_attention,
    window_attention_plain, window_attention_save, window_attention_save_plain)

pytestmark = pytest.mark.cuda

TOL_LN_MLP = 2e-2
TOL_MSA = 3e-2
TOL_P = 2e-3
TOL_DX = 3e-2
TOL_GRAD = 1e-2


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def _bf16(rng, shape, std, dev):
    return torch.from_numpy((rng.standard_normal(shape) * std)
                            .astype(np.float32)).to(dev, torch.bfloat16)


def _close(got, want, tol):
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    bound = tol + tol * want.float().abs()
    assert bool(torch.isfinite(got.float()).all())
    assert bool((err <= bound).all()), f"max abs err {err.max().item():.4g}"


@pytest.mark.parametrize("rows,c", [(1800, 1024), (7200, 512), (3600, 256),
                                    (14400, 128), (37, 96)])
def test_layer_norm_rows_kernel(dev, rows, c):
    rng = np.random.default_rng(c)
    x = _bf16(rng, (rows, c), 2.0, dev) + 0.5
    s = _bf16(rng, (c,), 0.2, dev) + 1.0
    b = _bf16(rng, (c,), 0.2, dev)
    _close(layer_norm_rows(x, s, b), layer_norm_rows_plain(x, s, b), TOL_LN_MLP)


@pytest.mark.parametrize("m,c", [(1000, 128), (900, 256), (450, 512),
                                 (225, 1024)])
def test_fused_ln_mlp_kernel(dev, m, c):
    rng = np.random.default_rng(c + 1)
    x = _bf16(rng, (m, c), 1.0, dev)
    args = (x, _bf16(rng, (c,), 0.2, dev) + 1.0, _bf16(rng, (c,), 0.2, dev),
            _bf16(rng, (4 * c, c), c ** -0.5, dev), _bf16(rng, (4 * c,), 0.2, dev),
            _bf16(rng, (c, 4 * c), (4 * c) ** -0.5, dev),
            _bf16(rng, (c,), 0.2, dev))
    _close(fused_ln_mlp(*args), fused_ln_mlp_plain(*args), TOL_LN_MLP)


def _msa_args(rng, dev, b, hw, c, heads, shift):
    ws, n = 12, 144
    nw = (hw // ws) ** 2
    x = _bf16(rng, (b, nw, n, c), 1.0, dev)
    table = torch.from_numpy(rng.standard_normal((23 * 23, heads))
                             .astype(np.float32)).to(dev)
    index = torch.from_numpy(relative_position_index_2d(ws, ws)).to(dev)
    bias = relative_bias_from_table(table, index)
    mask = shift_mask_2d(hw, hw, ws, ws // 2, dev) if shift else None
    w = (_bf16(rng, (3 * c, c), c ** -0.5, dev), _bf16(rng, (3 * c,), 0.2, dev),
         _bf16(rng, (c, c), c ** -0.5, dev), _bf16(rng, (c,), 0.2, dev))
    return x, w, bias, mask, (c // heads) ** -0.5


@pytest.mark.parametrize("c,heads,hw,shift", [(128, 4, 48, False),
                                              (128, 4, 48, True),
                                              (256, 8, 24, True)])
def test_fused_window_msa_ln_kernel(dev, c, heads, hw, shift):
    rng = np.random.default_rng(c + heads)
    x, w, bias, mask, scale = _msa_args(rng, dev, 2, hw, c, heads, shift)
    ln = (_bf16(rng, (c,), 0.2, dev) + 1.0, _bf16(rng, (c,), 0.2, dev))
    got = fused_window_msa_ln(x, *ln, *w, bias, mask, heads, scale)
    want = fused_window_msa_ln_plain(x, *ln, *w, bias, mask, heads, scale)
    _close(got, want, TOL_MSA)


@pytest.mark.parametrize("c,heads,hw,shift", [(512, 16, 36, True),
                                              (1024, 32, 24, False),
                                              (1024, 32, 24, True)])
def test_fused_window_msa_kernel(dev, c, heads, hw, shift):
    rng = np.random.default_rng(c + heads + 7)
    x, w, bias, mask, scale = _msa_args(rng, dev, 2, hw, c, heads, shift)
    got = fused_window_msa(x, *w, bias, mask, heads, scale)
    want = fused_window_msa_plain(x, *w, bias, mask, heads, scale)
    _close(got, want, TOL_MSA)


def test_kernels_refuse_what_they_do_not_take(dev):
    rng = np.random.default_rng(3)
    x = _bf16(rng, (64, 128), 1.0, dev)
    s, b = torch.ones(128, device=dev), torch.zeros(128, device=dev)
    with pytest.raises(TypeError):
        layer_norm_rows(x, s, b)  # f32 params
    with pytest.raises(ValueError):
        layer_norm_rows(x.t(), s.bfloat16()[:64], b.bfloat16()[:64])
    xw, w, bias, mask, scale = _msa_args(rng, dev, 1, 24, 128, 4, False)
    with pytest.raises(ValueError):
        fused_window_msa(xw[:, :, :100], *w, bias, mask, 4, scale)  # N != 144


def _map_args(rng, dev, b, hp, wp, c, heads, shift):
    ws, n = 12, 144
    x = _bf16(rng, (b, hp, wp, c), 1.0, dev)
    table = torch.from_numpy(rng.standard_normal((23 * 23, heads))
                             .astype(np.float32)).to(dev)
    index = torch.from_numpy(relative_position_index_2d(ws, ws)).to(dev)
    bias = relative_bias_from_table(table, index)
    mask = shift_mask_2d(hp, wp, ws, ws // 2, dev) if shift else None
    w = (_bf16(rng, (3 * c, c), c ** -0.5, dev), _bf16(rng, (3 * c,), 0.2, dev),
         _bf16(rng, (c, c), c ** -0.5, dev), _bf16(rng, (c,), 0.2, dev))
    return x, w, bias, mask, (c // heads) ** -0.5


# stage 3 and 4 at 480² (padded 36² and 24²) and a non-square map, where a
# swapped window row/column or mask index shows
K11_CASES = [(512, 16, 36, 36, False), (512, 16, 36, 36, True),
             (1024, 32, 24, 24, False), (1024, 32, 24, 24, True),
             (256, 8, 36, 24, True), (256, 8, 24, 36, False)]


@pytest.mark.parametrize("c,heads,hp,wp,shift", K11_CASES)
def test_fused_window_msa_2d_kernel(dev, c, heads, hp, wp, shift):
    rng = np.random.default_rng(c + hp + 3 * wp)
    x, w, bias, mask, scale = _map_args(rng, dev, 2, hp, wp, c, heads, shift)
    got = fused_window_msa_2d(x, *w, bias, mask, heads, scale, 12)
    want = fused_window_msa_2d_plain(x, *w, bias, mask, heads, scale, 12)
    assert got.shape == x.shape
    _close(got, want, TOL_MSA)


@pytest.mark.parametrize("c,heads,hp,wp,shift", K11_CASES)
def test_fused_window_msa_2d_equals_partition_route(dev, c, heads, hp, wp,
                                                    shift):
    """K11 shares K2's attention core and GEMM, token for token: its output
    is bit-equal to partition -> K2 -> reverse on the same bf16 inputs."""
    rng = np.random.default_rng(c + hp + 3 * wp + 1)
    x, w, bias, mask, scale = _map_args(rng, dev, 2, hp, wp, c, heads, shift)
    got = fused_window_msa_2d(x, *w, bias, mask, heads, scale, 12)
    nw = (hp // 12) * (wp // 12)
    xw = window_partition(x, 12).view(2, nw, 144, c).contiguous()
    yw = fused_window_msa(xw, *w, bias, mask, heads, scale)
    want = window_reverse(yw.view(2 * nw, 144, c), 12, hp, wp)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_fused_window_msa_2d_refuses_what_it_does_not_take(dev):
    rng = np.random.default_rng(5)
    x, w, bias, mask, scale = _map_args(rng, dev, 1, 24, 36, 256, 8, True)
    with pytest.raises(ValueError):  # Hp not a multiple of the window
        fused_window_msa_2d(x[:, :20].contiguous(), *w, bias, None, 8, scale,
                            12)
    with pytest.raises(ValueError):  # a mask of the wrong window count
        fused_window_msa_2d(x, *w, bias, mask[:3], 8, scale, 12)
    with pytest.raises(TypeError):  # f32 map
        fused_window_msa_2d(x.float(), *w, bias, mask, 8, scale, 12)
    with pytest.raises(ValueError):  # window 7
        fused_window_msa_2d(x[:, :21, :21].contiguous(), *w, bias, None, 8,
                            scale, 7)


def _close_scaled(got, want, tol):
    torch.cuda.synchronize()
    g, w = got.float(), want.float()
    assert bool(torch.isfinite(g).all())
    err = (g - w).abs()
    scale = w.square().mean().sqrt()
    assert bool((err <= tol * (scale + w.abs())).all()), \
        f"max abs err {err.max().item():.4g} at scale {scale.item():.4g}"


def _rel_frob(got, want, tol):
    torch.cuda.synchronize()
    g, w = got.float(), want.float()
    assert bool(torch.isfinite(g).all())
    rel = ((g - w).norm() / w.norm().clamp(min=1e-30)).item()
    assert rel <= tol, f"relative Frobenius error {rel:.4g}"


def _close_grads(got, want):
    _close_scaled(got[0], want[0], TOL_DX)
    for g, w in zip(got[1:], want[1:]):
        assert g.shape == w.shape and g.dtype == torch.float32
        _rel_frob(g, w, TOL_GRAD)


# (C, heads, image side) at two Swin-B stage shapes each
MSA_SHAPES = [(128, 4, 48, True, True), (256, 8, 24, True, False),
              (512, 16, 36, False, True), (1024, 32, 24, False, False)]


@pytest.mark.parametrize("c,heads,hw,with_ln,shift", MSA_SHAPES)
def test_fused_window_msa_save_mode_kernel(dev, c, heads, hw, with_ln, shift):
    rng = np.random.default_rng(c + 11)
    x, w, bias, mask, scale = _msa_args(rng, dev, 2, hw, c, heads, shift)
    ln = ((_bf16(rng, (c,), 0.2, dev) + 1.0, _bf16(rng, (c,), 0.2, dev))
          if with_ln else None)
    y, saved = fused_window_msa_save(x, ln, *w, bias, mask, heads, scale)
    y_p, saved_p = fused_window_msa_save_plain(x, ln, *w, bias, mask, heads,
                                               scale)
    _close(y, y_p, TOL_MSA)
    for name, got, want in zip("qkvpx", saved, saved_p):
        if want is None:
            assert got is None
            continue
        assert got.shape == want.shape and got.dtype == torch.bfloat16, name
        if name == "p":
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs()
            assert bool((err <= TOL_P + TOL_MSA * want.float().abs()).all())
        else:
            _close(got, want, TOL_MSA)


@pytest.mark.parametrize("c,heads,hw,with_ln,shift", MSA_SHAPES)
def test_fused_window_msa_bwd_kernel(dev, c, heads, hw, with_ln, shift):
    """K5 on the plain save-mode residuals (both sides see one tape)."""
    rng = np.random.default_rng(c + 13)
    x, w, bias, mask, scale = _msa_args(rng, dev, 2, hw, c, heads, shift)
    _, (q, k, v, p, _) = fused_window_msa_save_plain(x, None, *w, bias, mask,
                                                     heads, scale)
    gy = _bf16(rng, x.shape, 1.0, dev)
    got = fused_window_msa_bwd(x, gy, w[0], w[2], (q, k, v, p), heads, scale)
    want = fused_window_msa_bwd_plain(x, gy, w[0], w[2], (q, k, v, p), heads,
                                      scale)
    _close_grads(got, want)


@pytest.mark.parametrize("c,heads,hw,with_ln,shift", MSA_SHAPES[::3])
def test_fused_window_msa_bwd_recompute_kernel(dev, c, heads, hw, with_ln,
                                               shift):
    rng = np.random.default_rng(c + 17)
    x, w, bias, mask, scale = _msa_args(rng, dev, 2, hw, c, heads, shift)
    ln = ((_bf16(rng, (c,), 0.2, dev) + 1.0, _bf16(rng, (c,), 0.2, dev))
          if with_ln else None)
    gy = _bf16(rng, x.shape, 1.0, dev)
    got = fused_window_msa_bwd_recompute(x, ln, *w, bias, mask, gy, heads,
                                         scale)
    want = fused_window_msa_bwd_recompute_plain(x, ln, *w, bias, mask, gy,
                                                heads, scale)
    _close_grads(got, want)


def _mlp_args(rng, dev, m, c):
    return (_bf16(rng, (m, c), 1.0, dev), _bf16(rng, (c,), 0.2, dev) + 1.0,
            _bf16(rng, (c,), 0.2, dev), _bf16(rng, (4 * c, c), c ** -0.5, dev),
            _bf16(rng, (4 * c,), 0.2, dev),
            _bf16(rng, (c, 4 * c), (4 * c) ** -0.5, dev),
            _bf16(rng, (c,), 0.2, dev))


def _keep(dev, b, drop=0.3):
    bern = torch.arange(b, device=dev) % 3 != 1
    return torch.where(bern, 1.0 / (1.0 - drop), 0.0).float()


@pytest.mark.parametrize("m,c,rows", [(1000, 128, 250), (900, 256, 225),
                                      (450, 512, 225), (225, 1024, 75)])
def test_fused_ln_mlp_droppath_kernel(dev, m, c, rows):
    rng = np.random.default_rng(c + 19)
    args = _mlp_args(rng, dev, m, c)
    keep = _keep(dev, m // rows)
    _close(fused_ln_mlp_droppath(*args, keep, rows),
           fused_ln_mlp_droppath_plain(*args, keep, rows), TOL_LN_MLP)


@pytest.mark.parametrize("m,c,rows,drop", [(1000, 128, 250, False),
                                           (900, 256, 225, True),
                                           (450, 512, 225, False),
                                           (225, 1024, 75, True)])
def test_fused_ln_mlp_bwd_kernel(dev, m, c, rows, drop):
    rng = np.random.default_rng(c + 23)
    x, g, be, w1, b1, w2, _ = _mlp_args(rng, dev, m, c)
    gy = _bf16(rng, (m, c), 1.0, dev)
    keep = _keep(dev, m // rows) if drop else None
    got = fused_ln_mlp_bwd(x, gy, g, be, w1, b1, w2, keep, rows)
    want = fused_ln_mlp_bwd_plain(x, gy, g, be, w1, b1, w2, keep, rows)
    _close_grads(got, want)


def test_training_kernels_refuse_what_they_do_not_take(dev):
    rng = np.random.default_rng(29)
    x, w, bias, mask, scale = _msa_args(rng, dev, 1, 24, 128, 4, False)
    _, (q, k, v, p, _) = fused_window_msa_save_plain(x, None, *w, bias, mask,
                                                     4, scale)
    with pytest.raises(TypeError):  # f32 output gradient
        fused_window_msa_bwd(x, x.float(), w[0], w[2], (q, k, v, p), 4, scale)
    with pytest.raises(ValueError):  # head dim 64
        fused_window_msa_save(x, None, *w, bias, mask, 2, scale)
    xm, g, be, w1, b1, w2, b2 = _mlp_args(rng, dev, 64, 96)  # C = 96
    with pytest.raises(ValueError):
        fused_ln_mlp_bwd(xm, xm, g, be, w1, b1, w2)
    xm, g, be, w1, b1, w2, b2 = _mlp_args(rng, dev, 64, 128)
    with pytest.raises(TypeError):  # f32 weights
        fused_ln_mlp_bwd(xm, xm, g, be, w1.float(), b1, w2)
    with pytest.raises(ValueError):  # 64 rows are not samples of 48
        fused_ln_mlp_droppath(xm, g, be, w1, b1, w2, b2, _keep(dev, 2), 48)


# -- the video kernels: K10 (attention on pre-projected heads) and K2p --------

def _video_bias_mask(rng, dev, heads, n, nw, masked):
    table = torch.from_numpy(rng.standard_normal((15 * 13 * 13, heads))
                             .astype(np.float32)).to(dev)
    index = torch.from_numpy(relative_position_index_3d(8, 7, 7)).to(dev)
    bias = relative_bias_from_table_3d(table, index, n)
    mask = (torch.from_numpy(np.where(rng.random((nw, n, n)) > 0.7, -100.0,
                                      0.0).astype(np.float32)).to(dev)
            if masked else None)
    return bias, mask


@pytest.mark.parametrize("nw,heads,n,masked", [
    (81, 6, 392, True), (25, 12, 392, False), (9, 24, 392, True),
    (9, 24, 196, True), (16, 3, 49, True)])
def test_window_attention_kernel(dev, nw, heads, n, masked):
    """K10 at the video stage-2..4 shapes (N = 392), a 4-frame clip's N =
    196 and window-7's N = 49."""
    rng = np.random.default_rng(nw + heads + n)
    q, k, v = (_bf16(rng, (1, nw, heads, n, 32), 1.0, dev) for _ in range(3))
    bias, mask = _video_bias_mask(rng, dev, heads, n, nw, masked)
    _close(window_attention(q, k, v, bias, mask, 32 ** -0.5),
           window_attention_plain(q, k, v, bias, mask, 32 ** -0.5), TOL_MSA)


@pytest.mark.parametrize("masked", [False, True])
def test_fused_window_msa_grouped_kernel(dev, masked):
    """K2p at the video stage-1 shape: 324 windows of 392 tokens padded to
    400, C = 96, 3 heads; shifted, the first 289 windows are maskless and
    the other 35 take the small mask."""
    rng = np.random.default_rng(96 + masked)
    c, heads, n, n_p, nw = 96, 3, 392, 400, 324
    ws, ss = (8, 7, 7), (0, 3, 3) if masked else (0, 0, 0)
    nu, mask = partition_3d_groups(8, 120, 120, 8, 126, 126, ws, ss, n_p, dev)
    assert nu == (289 if masked else nw)
    x = _bf16(rng, (1, nw, n_p, c), 1.0, dev)
    x[:, :, n:] = 0
    bias, _ = _video_bias_mask(rng, dev, heads, n, nw, False)
    bias = pad_bias_sublane(bias, n_p)
    w = (_bf16(rng, (3 * c, c), c ** -0.5, dev), _bf16(rng, (3 * c,), 0.2, dev),
         _bf16(rng, (c, c), c ** -0.5, dev), _bf16(rng, (c,), 0.2, dev))
    args = (x, *w, bias, mask, nu, heads, 32 ** -0.5)
    _close(fused_window_msa_grouped(*args)[:, :, :n],
           fused_window_msa_grouped_plain(*args)[:, :, :n], TOL_MSA)


def test_video_kernels_refuse_what_they_do_not_take(dev):
    rng = np.random.default_rng(5)
    q = _bf16(rng, (1, 2, 2, 416, 32), 1.0, dev)
    bias = torch.zeros((2, 416, 416), device=dev)
    with pytest.raises(ValueError):
        window_attention(q, q, q, bias, None)  # N > 400
    x = _bf16(rng, (1, 2, 392, 96), 1.0, dev)
    w = (_bf16(rng, (288, 96), 0.1, dev), _bf16(rng, (288,), 0.1, dev),
         _bf16(rng, (96, 96), 0.1, dev), _bf16(rng, (96,), 0.1, dev))
    with pytest.raises(ValueError):  # 392 is not a multiple of 16
        fused_window_msa_grouped(x, *w, torch.zeros((3, 392, 392), device=dev),
                                 None, 2, 3, 32 ** -0.5)


# K9 and K10's save mode at every video stage's shape of an 8-frame 480²
# clip (stage 1 shifted: 324 windows, 35 of them masked), a 4-frame clip's
# N = 196 and window-7's N = 49
VIDEO_BWD_SHAPES = [(324, 3, 392, True), (81, 6, 392, False),
                    (25, 12, 392, True), (9, 24, 392, False),
                    (9, 24, 196, True), (16, 3, 49, True)]


def _video_attn_args(rng, dev, nw, heads, n, masked):
    q, k, v = (_bf16(rng, (1, nw, heads, n, 32), 1.0, dev) for _ in range(3))
    bias, mask = _video_bias_mask(rng, dev, heads, n, nw, masked)
    return q, k, v, bias, mask


@pytest.mark.parametrize("nw,heads,n,masked", VIDEO_BWD_SHAPES)
def test_window_attention_save_mode_kernel(dev, nw, heads, n, masked):
    """K10's save mode: the output as K10's, each row's log-sum-exp within
    TOL_P abs + 1e-4 rel (f32 on both sides, from the same bf16 q·scale)."""
    rng = np.random.default_rng(nw + heads + n + 1)
    q, k, v, bias, mask = _video_attn_args(rng, dev, nw, heads, n, masked)
    o, lse = window_attention_save(q, k, v, bias, mask, 32 ** -0.5)
    o_p, lse_p = window_attention_save_plain(q, k, v, bias, mask, 32 ** -0.5)
    _close(o, o_p, TOL_MSA)
    assert lse.shape == (1, nw, heads, n) and lse.dtype == torch.float32
    err = (lse - lse_p).abs()
    assert bool((err <= TOL_P + 1e-4 * lse_p.abs()).all()), err.max().item()


@pytest.mark.parametrize("nw,heads,n,masked", VIDEO_BWD_SHAPES)
def test_attention_core_bwd_kernel(dev, nw, heads, n, masked):
    """K9 on K10's saved output and lse against the plain backward on the
    same output: dq/dk/dv within TOL_DX of their scale, dbias by relative
    Frobenius."""
    rng = np.random.default_rng(nw + heads + n + 2)
    q, k, v, bias, mask = _video_attn_args(rng, dev, nw, heads, n, masked)
    scale = 32 ** -0.5
    o, lse = window_attention_save(q, k, v, bias, mask, scale)
    do = _bf16(rng, q.shape, 1.0, dev)
    got = attention_core_bwd(q, k, v, bias, mask, do, scale, o, lse)
    want = attention_core_bwd_plain(q, k, v, bias, mask, do, scale, o)
    for g, w in zip(got[:3], want[:3]):
        assert g.shape == q.shape and g.dtype == torch.bfloat16
        _close_scaled(g, w, TOL_DX)
    assert got[3].shape == (heads, n, n) and got[3].dtype == torch.float32
    _rel_frob(got[3], want[3], TOL_GRAD)
    again = attention_core_bwd(q, k, v, bias, mask, do, scale, o, lse)
    for g, a in zip(got, again):  # fixed-order sums: the same bits
        assert torch.equal(g, a)


def test_window_attention_function_on_the_card(dev):
    """Autograd through window_attention launches K10 (save mode) once and
    K9 once, and its grads agree with autograd through the plain version."""
    rng = np.random.default_rng(3)
    args = _video_attn_args(rng, dev, 9, 24, 392, True)
    do = _bf16(rng, args[0].shape, 1.0, dev)
    grads = []
    for fn in (window_attention, window_attention_plain):
        leaves = [t.detach().requires_grad_() for t in args[:4]]
        n10, n9 = window_attention.launches, attention_core_bwd.launches
        out = fn(*leaves, args[4], 32 ** -0.5)
        grads.append(torch.autograd.grad(out, leaves, do))
        if fn is window_attention:
            assert window_attention.launches == n10 + 1
            assert attention_core_bwd.launches == n9 + 1
    for i, (g, w) in enumerate(zip(*grads)):
        if i < 3:
            _close_scaled(g, w, TOL_DX)
        else:
            _rel_frob(g, w, TOL_GRAD)


def test_attention_core_bwd_refuses_what_it_does_not_take(dev):
    rng = np.random.default_rng(6)
    q = _bf16(rng, (1, 2, 2, 392, 32), 1.0, dev)
    bias = torch.zeros((2, 392, 392), device=dev)
    o, lse = window_attention_save(q, q, q, bias, None)
    with pytest.raises(ValueError):  # no saved output and lse
        attention_core_bwd(q, q, q, bias, None, q)
    with pytest.raises(TypeError):  # f32 gradient
        attention_core_bwd(q, q, q, bias, None, q.float(), None, o, lse)
    with pytest.raises(ValueError):  # lse of another shape
        attention_core_bwd(q, q, q, bias, None, q, None, o, lse[:, :1])
