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

K1, K2, the save mode and K6's forward run the launches of
`fused_msa.save_launches` (the GEMM core around csrc/fused_msa_sm90.cu's
attention); their attention launch is also held alone to its plain
version, in both modes, and K1's output to the save mode's y, bit for
bit.  K11 runs `fused_msa_2d.map_launches` (the same GEMMs over the map's
rows around that attention in map order): its attention launch is held to
its plain version and to the window-order launch on the partitioned map,
and K11's output to the K2 launches on the partitioned map, bit for bit.

K4 is held to its plain version at every row layout of its launch plan,
and K4b (its backward) to the plain backward: dx at TOL_LN_MLP, dscale
and dbias within 1e-3 relative Frobenius; two K4b calls give the same
bits.

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

from lavt_rs_tpu_torch.ops import fused_mlp as fm
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
from lavt_rs_tpu_torch.ops import cuda_lib, ln
from lavt_rs_tpu_torch.ops.ln import layer_norm_rows, layer_norm_rows_plain
from lavt_rs_tpu_torch.ops.window import (partition_3d_groups,
                                          relative_bias_from_table,
                                          relative_bias_from_table_3d,
                                          relative_position_index_2d,
                                          relative_position_index_3d,
                                          shift_mask_2d, shift_mask_3d,
                                          shift_mask_flags_2d,
                                          window_partition, window_reverse)
from lavt_rs_tpu_torch.ops.window_attn import (
    attention_core_bwd, attention_core_bwd_plain, mask_flags, window_attention,
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


# K4 and K4b: every row layout of csrc/ln.cu's plan (lane groups of 4-32
# lanes, the masked words of 1056's wide rows, the wide path), one row,
# a ragged few, a stage-4 count and a stage-1 count
LN_WIDTHS = (96, 128, 192, 256, 384, 512, 768, 1024, 1056, 1536, 4096)
LN_ROWS = (1, 7, 1800, 115200)


def _ln_args(rng, rows, c, dev):
    x = _bf16(rng, (rows, c), 2.0, dev) + 0.5
    return (x, _bf16(rng, (c,), 0.2, dev) + 1.0, _bf16(rng, (c,), 0.2, dev),
            _bf16(rng, (rows, c), 1.0, dev))


@pytest.mark.parametrize("c", LN_WIDTHS)
@pytest.mark.parametrize("rows", LN_ROWS)
def test_layer_norm_rows_kernel_at_every_width(dev, rows, c):
    x, s, b, _ = _ln_args(np.random.default_rng(rows + c), rows, c, dev)
    _close(layer_norm_rows(x, s, b), layer_norm_rows_plain(x, s, b), TOL_LN_MLP)


@pytest.mark.parametrize("c", LN_WIDTHS)
@pytest.mark.parametrize("rows", LN_ROWS)
def test_layer_norm_rows_bwd_kernel(dev, rows, c):
    """K4b against the plain backward: dx within 2e-2 abs + rel, dscale and
    dbias (sums over the rows) within 1e-3 relative Frobenius."""
    x, s, _, g = _ln_args(np.random.default_rng(rows + c + 1), rows, c, dev)
    before = ln.layer_norm_rows_bwd.launches
    got = ln.layer_norm_rows_bwd(x, s.float(), g)
    assert ln.layer_norm_rows_bwd.launches == before + 1
    want = ln.layer_norm_rows_bwd_plain(x, s.float(), g)
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.float32
    _close(got[0], want[0], TOL_LN_MLP)
    for a, w in zip(got[1:], want[1:]):
        _rel_frob(a, w, 1e-3)


@pytest.mark.parametrize("rows,c", [(115200, 128), (28800, 256), (1800, 1024),
                                    (33, 1056), (225, 1536)])
def test_layer_norm_rows_bwd_is_deterministic(dev, rows, c):
    x, s, _, g = _ln_args(np.random.default_rng(c + 5), rows, c, dev)
    a = ln.layer_norm_rows_bwd_launch(x, s.float(), g)
    b = ln.layer_norm_rows_bwd_launch(x, s.float(), g)
    torch.cuda.synchronize()
    assert all(torch.equal(p, q) for p, q in zip(a, b))


def test_layer_norm_rows_bwd_plan_is_the_kernels(dev):
    """The partial count the C side launches equals ops/ln.py's mirror of
    its plan on this card, and the partials add up to the plain grads."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    lib = cuda_lib.lib()
    for c in range(32, 4097, 32):
        for rows in (1, 7, 1800, 115200):
            assert lib.lavt_layer_norm_rows_bwd_parts(rows, c) == (
                ln.ln_rows_plan(rows, c, sms, bwd=True)["blocks"]), (rows, c)
    assert lib.lavt_layer_norm_rows_bwd_parts(8, 80) == 0
    x, s, _, g = _ln_args(np.random.default_rng(9), 28800, 256, dev)
    dx, part = ln.layer_norm_rows_bwd_partials(x, s.float(), g)
    want = ln.layer_norm_rows_bwd_plain(x, s.float(), g)
    _rel_frob(part.sum(0)[0], want[1], 1e-3)
    _rel_frob(part.sum(0)[1], want[2], 1e-3)


def test_layer_norm_rows_bwd_refuses_what_it_does_not_take(dev):
    x, s, _, g = _ln_args(np.random.default_rng(3), 64, 128, dev)
    before = ln.layer_norm_rows_bwd.launches
    with pytest.raises(TypeError):  # f32 output gradient
        ln.layer_norm_rows_bwd(x, s.float(), g.float())
    with pytest.raises(TypeError):  # bf16 scale: the kernel takes the master
        ln.layer_norm_rows_bwd(x, s, g)
    with pytest.raises(ValueError):  # non-contiguous x
        ln.layer_norm_rows_bwd(x.t(), s.float()[:64], g.t().contiguous())
    with pytest.raises(ValueError):  # C = 80
        ln.layer_norm_rows_bwd(x[:, :80].contiguous(), s.float()[:80],
                               g[:, :80].contiguous())
    assert ln.layer_norm_rows_bwd.launches == before


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
    """K11 runs K2's launches in map order (the same GEMMs over the map's
    rows, the same attention on each window), token for token: its output
    is bit-equal to partition -> the K2 launches -> reverse on the same
    bf16 inputs, with the mask's window flags as the blocks pass them."""
    rng = np.random.default_rng(c + hp + 3 * wp + 1)
    x, w, bias, mask, scale = _map_args(rng, dev, 2, hp, wp, c, heads, shift)
    flags = shift_mask_flags_2d(hp, wp, 12, 6, dev) if shift else None
    got = fused_window_msa_2d(x, *w, bias, mask, heads, scale, 12, flags)
    nw = (hp // 12) * (wp // 12)
    xw = window_partition(x, 12).view(2, nw, 144, c).contiguous()
    yw = fused_window_msa(xw, *w, bias, mask, heads, scale, flags=flags)
    want = window_reverse(yw.view(2 * nw, 144, c), 12, hp, wp)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


# the map-order attention launch: C = 96 (Swin-T stage 1 at 448², a map of
# 120 -> 10 x 10 windows, batch cut), 512 and 1024 (Swin-B stages 3-4 at
# 480²) and the non-square maps of K11_CASES: (B, Hp, Wp, C, heads)
MAP_ATTN_SHAPES = [(1, 120, 120, 96, 3), (2, 36, 36, 512, 16),
                   (2, 24, 24, 1024, 32), (2, 36, 24, 256, 8),
                   (2, 24, 36, 256, 8)]


@pytest.mark.parametrize("b,hp,wp,c,heads", MAP_ATTN_SHAPES)
@pytest.mark.parametrize("shift", [False, True])
def test_msa_attn_map_launch(dev, b, hp, wp, c, heads, shift):
    """The attention launch in map order against its plain version
    (`msa_attn_map_plain`, within TOL_MSA), and bit-equal to the window-order
    launch on the partitioned qkv map, reversed (with the window flags and
    without: they change no bit)."""
    from lavt_rs_tpu_torch.ops import fused_msa as fmsa
    from lavt_rs_tpu_torch.ops import fused_msa_2d as fmsa2d

    rng = np.random.default_rng(c + hp + 2 * wp + 61)
    x, w, bias, mask, scale = _map_args(rng, dev, b, hp, wp, c, heads, shift)
    flags = shift_mask_flags_2d(hp, wp, 12, 6, dev) if shift else None
    qkv = fmsa.gemm_bias(x.reshape(-1, c), w[0], w[1], c, scale)
    qkv = qkv.view(b, hp, wp, 3 * c)
    o = fmsa2d.msa_attn_map(qkv, bias, mask, heads, flags)
    assert o.shape == (b, hp, wp, c)
    _close(o, fmsa2d.msa_attn_map_plain(qkv, bias, mask, heads), TOL_MSA)
    qw = window_partition(qkv, 12).contiguous()
    ow, _ = fmsa.msa_attn(qw, bias, mask, heads, False, flags)
    want = window_reverse(ow.view(qw.shape[0], 144, c), 12, hp, wp)
    torch.cuda.synchronize()
    assert torch.equal(o, want)
    assert torch.equal(o, fmsa2d.msa_attn_map(qkv, bias, mask, heads))


@pytest.mark.parametrize("c,heads,hw,shift", [(128, 4, 48, False),
                                              (128, 4, 48, True),
                                              (256, 8, 24, True),
                                              (96, 3, 24, True)])
def test_fused_window_msa_ln_equals_save_mode_y(dev, c, heads, hw, shift):
    """K1 is the save mode's launches without the saves: its output has the
    bits of the save mode's y on the same inputs."""
    rng = np.random.default_rng(c + heads + 67)
    x, w, bias, mask, scale = _msa_args(rng, dev, 2, hw, c, heads, shift)
    flags = mask_flags(mask) if shift else None
    ln = (_bf16(rng, (c,), 0.2, dev) + 1.0, _bf16(rng, (c,), 0.2, dev))
    got = fused_window_msa_ln(x, *ln, *w, bias, mask, heads, scale,
                              flags=flags)
    y, _ = fused_window_msa_save(x, ln, *w, bias, mask, heads, scale,
                                 flags=flags)
    torch.cuda.synchronize()
    assert torch.equal(got, y)


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


# -- the LN-MLP launches: K3/K8 (LN rows, fc1 + GELU, fc2 + residual) and K7
# (prep, dual GEMM, weight grads, dyln, LN backward), each against its plain
# version on the same inputs --------------------------------------------------

# (C, M): Swin-B stages 1-4 and Swin-T stage 3 at bs 8, 480²; and M = 1 and
# 1800 + 7 (ragged row tiles) at every width
MLP_LAUNCH_CASES = ([(128, 115200), (256, 28800), (384, 7200), (512, 7200),
                     (1024, 1800)]
                    + [(c, m) for c in (128, 256, 384, 512, 1024)
                       for m in (1, 1807)])


def _samples(m):
    """Rows per sample of keep: 8 samples at the main path's M, else 1."""
    return m // 8 if m % 8 == 0 else 1


def _close_branch(out, want, x, tol):
    """The MLP branch out - x within tol abs + rel plus one bf16 step of
    the output (2^-7 |out|), so that x does not hide a branch error."""
    torch.cuda.synchronize()
    w_out = want.float()
    err = ((out.float() - x.float()) - (w_out - x.float())).abs()
    bound = tol + tol * (w_out - x.float()).abs() + 2 ** -7 * w_out.abs()
    assert bool((err <= bound).all()), f"branch max abs err {err.max().item():.4g}"


@pytest.mark.parametrize("c,m", MLP_LAUNCH_CASES)
def test_ln_mlp_forward_launches(dev, c, m):
    rng = np.random.default_rng(c + m)
    x, g, be, w1, b1, w2, b2 = _mlp_args(rng, dev, m, c)
    xn = fm.mlp_ln_rows(x, g, be)
    _close(xn, fm.mlp_ln_rows_plain(x, g, be), TOL_LN_MLP)
    h = fm.gemm_bias_gelu(xn, w1, b1)
    _close(h, fm.gemm_bias_gelu_plain(xn, w1, b1), TOL_LN_MLP)
    rows = _samples(m)
    for keep in (None, _keep(dev, m // rows)):
        out = fm.gemm_residual(h, w2, b2, x, keep, rows)
        want = fm.gemm_residual_plain(h, w2, b2, x, keep, rows)
        _close(out, want, TOL_LN_MLP)
        _close_branch(out, want, x, TOL_LN_MLP)


@pytest.mark.parametrize("c,m", MLP_LAUNCH_CASES)
def test_ln_mlp_backward_launches(dev, c, m):
    rng = np.random.default_rng(c + m + 1)
    x, g, be, w1, b1, w2, _ = _mlp_args(rng, dev, m, c)
    gy = _bf16(rng, (m, c), 1.0, dev)
    rows = _samples(m)
    keep = _keep(dev, m // rows)
    got = fm.mlp_bwd_prep(x, gy, g, be, keep, rows)
    for a, b in zip(got, fm.mlp_bwd_prep_plain(x, gy, g, be, keep, rows)):
        _close(a, b, TOL_LN_MLP)
    xn, stats, dm = got
    h, dh, db1 = fm.dual_gemm_gelu_bwd(xn, dm, w1, b1, w2)
    h_p, dh_p, db1_p = fm.dual_gemm_gelu_bwd_plain(xn, dm, w1, b1, w2)
    _close(h, h_p, TOL_LN_MLP)
    _close_scaled(dh, dh_p, TOL_DX)
    _rel_frob(db1, db1_p, TOL_GRAD)
    split = fm.bwd_plan(m, c, 4 * c).split_rows
    for a, b in ((dm, h), (dh, xn)):
        _rel_frob(fm.wgrad(a, b, split), fm.wgrad_plain(a, b, split), TOL_GRAD)
    dyln = fm.dgrad(dh, w1)
    _close_scaled(dyln, fm.dgrad_plain(dh, w1), TOL_DX)
    dx, part = fm.ln_bwd_rows(dyln, x, gy, g, stats, keep, rows)
    dx_p, part_p = fm.ln_bwd_rows_plain(dyln, x, gy, g, stats, keep, rows)
    _close_scaled(dx, dx_p, TOL_DX)
    for i in range(3):  # the dgamma, dbeta and db2 partials
        _rel_frob(part[:, i], part_p[:, i], TOL_GRAD)


@pytest.mark.parametrize("m,na,nb", [(2000, 288, 96), (1807, 96, 96)])
def test_wgrad_at_ragged_widths(dev, m, na, nb):
    """The weight-grad GEMM at widths that end in a part tile (K5 at C =
    96: dWqkv 288 x 96, dWproj 96 x 96): every split's partials against
    the plain version's, nothing stored past Nb."""
    rng = np.random.default_rng(na + nb)
    a, b = _bf16(rng, (m, na), 1.0, dev), _bf16(rng, (m, nb), 1.0, dev)
    split = fm.wgrad_split_tiles(m, na, nb) * fm.GEMM_DEPTH
    _rel_frob(fm.wgrad(a, b, split), fm.wgrad_plain(a, b, split), TOL_GRAD)


def test_ln_mlp_launches_refuse_what_they_do_not_take(dev):
    rng = np.random.default_rng(41)
    x, g, be, w1, b1, w2, b2 = _mlp_args(rng, dev, 100, 128)
    keep = _keep(dev, 3)
    h = fm.gemm_bias_gelu(fm.mlp_ln_rows(x, g, be), w1, b1)
    with pytest.raises(ValueError):  # 100 rows are not samples of 33
        fm.gemm_residual(h, w2, b2, x, keep, 33)
    with pytest.raises(ValueError):
        fm.mlp_bwd_prep(x, x, g, be, keep, 33)
    with pytest.raises(ValueError):  # C = 96 has no kernel
        fm.mlp_ln_rows(*_mlp_args(rng, dev, 64, 96)[:3])
    with pytest.raises(ValueError):  # 60 columns: not a multiple of 8
        fm.wgrad(x[:, :60].contiguous(), x, 64)


@pytest.mark.parametrize("m,c", [(115200, 128), (7200, 512)])
def test_ln_mlp_bwd_is_deterministic(dev, m, c):
    """The weight and bias grads are fixed-order sums of partials: two
    calls on the same inputs agree bit for bit."""
    rng = np.random.default_rng(c + 31)
    x, g, be, w1, b1, w2, _ = _mlp_args(rng, dev, m, c)
    gy = _bf16(rng, (m, c), 1.0, dev)
    keep = _keep(dev, 8)
    first = fused_ln_mlp_bwd(x, gy, g, be, w1, b1, w2, keep, m // 8)
    second = fused_ln_mlp_bwd(x, gy, g, be, w1, b1, w2, keep, m // 8)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_ln_mlp_kernels_launch_only_the_ports_kernels(dev):
    """A K3, a K8 and a K7 call launch only the port's kernels (namespace
    lavt::, built from csrc), no cuBLAS / cuDNN / CUTLASS library kernel."""
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(37)
    m, c = 7200, 512
    x, g, be, w1, b1, w2, b2 = _mlp_args(rng, dev, m, c)
    gy = _bf16(rng, (m, c), 1.0, dev)
    keep = _keep(dev, 8)

    def calls():
        fused_ln_mlp(x, g, be, w1, b1, w2, b2)
        fused_ln_mlp_droppath(x, g, be, w1, b1, w2, b2, keep, m // 8)
        fused_ln_mlp_bwd(x, gy, g, be, w1, b1, w2, keep, m // 8)
        torch.cuda.synchronize()

    calls()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        calls()
    names = {e.key for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0)) > 0}
    assert names, "the profiler recorded no kernel"
    assert all("lavt::" in n for n in names), sorted(names)
    assert any("gemm_kernel" in n for n in names)


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


# K2p's calls: (frames, window, shift, grouping) of a 480² clip's stage 1
# (324 windows); grouping "small" is the route's (nu maskless windows,
# then the masked ones under the small mask), "full" the same windows as
# nu = 0 under the full mask, "empty" nu = nW with a mask of no windows
K2P_CASES = {
    "unshifted": (8, (8, 7, 7), (0, 0, 0), "small"),
    "shifted": (8, (8, 7, 7), (0, 3, 3), "small"),
    "nu-0-full-mask": (8, (8, 7, 7), (0, 3, 3), "full"),
    "nu-nW-empty-mask": (8, (8, 7, 7), (0, 0, 0), "empty"),
    "4-frame-shifted": (4, (4, 7, 7), (0, 3, 3), "small"),
}


def _k2p_weights(rng, dev, c):
    return (_bf16(rng, (3 * c, c), c ** -0.5, dev),
            _bf16(rng, (3 * c,), 0.2, dev),
            _bf16(rng, (c, c), c ** -0.5, dev), _bf16(rng, (c,), 0.2, dev))


@pytest.mark.parametrize("case", list(K2P_CASES))
def test_fused_window_msa_grouped_kernel(dev, case):
    """K2p at the video stage-1 shape: 324 windows of 392 tokens padded to
    400 (8 frames) or 196 padded to 208 (4 frames), C = 96, 3 heads;
    shifted, the first 289 windows are maskless and the other 35 take the
    small mask; also nu = 0 under the full mask and nu = nW with an empty
    mask.  One count per call, none of K10's."""
    frames, ws, ss, grouping = K2P_CASES[case]
    rng = np.random.default_rng(96 + len(case))
    c, heads, nw = 96, 3, 324
    n = ws[0] * ws[1] * ws[2]
    n_p = -(-n // 16) * 16
    nu, mask = partition_3d_groups(frames, 120, 120, frames, 126, 126, ws, ss,
                                   n_p, dev)
    assert nu == (289 if ss[1] else nw)
    if grouping == "full":
        mask, nu = torch.cat([mask.new_zeros((nu, n_p, n_p)), mask]), 0
    elif grouping == "empty":
        mask = torch.zeros((0, n_p, n_p), device=dev)
    x = _bf16(rng, (1, nw, n_p, c), 1.0, dev)
    x[:, :, n:] = 0
    table = torch.from_numpy(rng.standard_normal(
        ((2 * ws[0] - 1) * 13 * 13, heads)).astype(np.float32)).to(dev)
    index = torch.from_numpy(relative_position_index_3d(*ws)).to(dev)
    bias = pad_bias_sublane(relative_bias_from_table_3d(table, index, n), n_p)
    args = (x, *_k2p_weights(rng, dev, c), bias, mask, nu, heads, 32 ** -0.5)
    n2p, n10 = fused_window_msa_grouped.launches, window_attention.launches
    got = fused_window_msa_grouped(*args)
    assert fused_window_msa_grouped.launches == n2p + 1
    assert window_attention.launches == n10
    _close(got[:, :, :n], fused_window_msa_grouped_plain(*args)[:, :, :n],
           TOL_MSA)


def test_fused_window_msa_padded_kernel(dev):
    """`fused_window_msa_padded` (K2p with nu = 0 and the full mask, x, bias
    and mask padded by the wrapper) at 392 tokens against K2's plain
    version on the unpadded windows: the padded keys drop out exactly."""
    from lavt_rs_tpu_torch.ops.fused_msa import fused_window_msa_padded

    rng = np.random.default_rng(97)
    c, heads, n, nw = 96, 3, 392, 36
    x = _bf16(rng, (1, nw, n, c), 1.0, dev)
    bias, _ = _video_bias_mask(rng, dev, heads, n, nw, False)
    mask = shift_mask_3d(8, 42, 42, (8, 7, 7), (0, 3, 3), dev)
    w = _k2p_weights(rng, dev, c)
    n2p = fused_window_msa_grouped.launches
    got = fused_window_msa_padded(x, *w, bias, mask, heads, 32 ** -0.5)
    assert fused_window_msa_grouped.launches == n2p + 1
    assert got.shape == x.shape
    _close(got, fused_window_msa_plain(x, *w, bias, mask, heads, 32 ** -0.5),
           TOL_MSA)


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


# -- K10 and P2 redesigned for Hopper (csrc/window_attn_sm90.cu, P1 and P2
# in csrc/probe_headbatch.cu) --------------------------------------------------

# (B, nW, heads, N): every K10 shape of the main paths (the video clip's
# stages 1-4, stage 1 in training; a 4-frame stage 2; window-7 Swin-B at
# bs 8, stages 1-4) and ragged N (130: rows not 16-byte aligned above 64)
K10_SHAPES = [(1, 324, 3, 392), (1, 81, 6, 392), (1, 25, 12, 392),
              (1, 9, 24, 392), (1, 81, 6, 196), (8, 324, 4, 49),
              (8, 81, 8, 49), (8, 25, 16, 49), (8, 9, 32, 49)]
K10_RAGGED = [(2, 3, 5, n) for n in (1, 17, 63, 130, 400)]


def _k10_args(rng, dev, b, nw, heads, n, masked):
    q, k, v = (_bf16(rng, (b, nw, heads, n, 32), 1.0, dev) for _ in range(3))
    bias = torch.from_numpy(rng.standard_normal((heads, n, n))
                            .astype(np.float32)).to(dev)
    mask = (torch.from_numpy(np.where(rng.random((nw, n, n)) > 0.7, -100.0,
                                      0.0).astype(np.float32)).to(dev)
            if masked else None)
    return q, k, v, bias, mask


@pytest.mark.parametrize("b,nw,heads,n", K10_SHAPES + K10_RAGGED)
@pytest.mark.parametrize("masked", [False, True])
def test_k10_both_modes_at_every_shape(dev, b, nw, heads, n, masked):
    """K10 and its save mode against their plain versions (TOL_MSA; lse
    within TOL_P abs + 1e-4 rel)."""
    rng = np.random.default_rng(b + nw + heads + n + masked)
    q, k, v, bias, mask = _k10_args(rng, dev, b, nw, heads, n, masked)
    sc = 32 ** -0.5
    _close(window_attention(q, k, v, bias, mask, sc),
           window_attention_plain(q, k, v, bias, mask, sc), TOL_MSA)
    o, lse = window_attention_save(q, k, v, bias, mask, sc)
    o_p, lse_p = window_attention_save_plain(q, k, v, bias, mask, sc)
    _close(o, o_p, TOL_MSA)
    err = (lse - lse_p).abs()
    assert bool((err <= TOL_P + 1e-4 * lse_p.abs()).all()), err.max().item()


def test_k10_smem_matches_the_kernels_layout(dev):
    """The shared memory ops/window_attn.k10_plan plans with is what the
    kernel carves, at every N it takes."""
    from lavt_rs_tpu_torch.ops import cuda_lib
    from lavt_rs_tpu_torch.ops.window_attn import MAX_N, k10_smem

    lib = cuda_lib.lib()
    assert [lib.lavt_k10_smem(n) for n in range(1, MAX_N + 1)] == [
        k10_smem(n) for n in range(1, MAX_N + 1)]


@pytest.mark.parametrize("b,nw,heads,n", [(8, 9, 32, 49), (1, 25, 12, 392),
                                          (2, 3, 5, 130)])
@pytest.mark.parametrize("masked", [False, True])
def test_k10_strided_qkv_route(dev, b, nw, heads, n, masked):
    """K10 on the qkv Linear's output (q, k, v by strides, O written as
    (B, nW, N, C)): the same bits as K10 on contiguous copies, and its
    plain version's values."""
    from lavt_rs_tpu_torch.ops.window_attn import (qkv_heads,
                                                   window_attention_qkv,
                                                   window_attention_qkv_plain)

    rng = np.random.default_rng(n + masked)
    c = heads * 32
    qkv = _bf16(rng, (b, nw, n, 3 * c), 1.0, dev)
    _, _, _, bias, mask = _k10_args(rng, dev, 1, nw, heads, n, masked)
    sc = 32 ** -0.5
    n10 = window_attention.launches
    got = window_attention_qkv(qkv, bias, mask, heads, sc)
    assert window_attention.launches == n10 + 1
    assert got.shape == (b, nw, n, c) and got.is_contiguous()
    q, k, v = (t.contiguous() for t in qkv_heads(qkv, heads))
    same = window_attention(q, k, v, bias, mask, sc)
    torch.cuda.synchronize()
    assert torch.equal(got, same.transpose(2, 3).reshape(b, nw, n, c))
    _close(got, window_attention_qkv_plain(qkv, bias, mask, heads, sc),
           TOL_MSA)


def test_p2_against_its_plain_version_and_p1(dev):
    """P2 at the tool's defaults and at n = 16 and 192 (its plan's splits)
    within CHECK_ATOL + CHECK_RTOL of the plain version on the check input,
    and within 1e-2 of P1 on the tool's input."""
    from lavt_rs_tpu_torch.tools import probe_headbatch as probe

    for grid, ch, heads, n in ((96, 3, 4, 144), (4, 3, 4, 144),
                               (8, 2, 3, 192), (16, 1, 2, 16)):
        xc = probe.probe_input(grid, ch, heads, n, device=dev,
                               std=probe.CHECK_STD)
        got = probe.batch_attention(xc, ch, heads, n)
        assert probe.mismatch(got, probe.probe_attention_plain(
            xc, heads, n)) <= 1
    x = probe.probe_input(96, 3, 4, 144, device=dev)
    diff = (probe.loop_attention(x, 3, 4, 144).float()
            - probe.batch_attention(x, 3, 4, 144).float()).abs().max()
    assert diff.item() <= 1e-2


def test_p1_against_its_plain_version(dev):
    """P1 (the per-head schedule) at the tool's defaults and at n = 16 and
    192 (its plan's splits of the heads) within CHECK_ATOL + CHECK_RTOL of
    the plain version on the check input."""
    from lavt_rs_tpu_torch.tools import probe_headbatch as probe

    for grid, ch, heads, n in ((96, 3, 4, 144), (4, 3, 4, 144),
                               (8, 2, 3, 192), (16, 1, 2, 16)):
        xc = probe.probe_input(grid, ch, heads, n, device=dev,
                               std=probe.CHECK_STD)
        got = probe.loop_attention(xc, ch, heads, n)
        assert probe.mismatch(got, probe.probe_attention_plain(
            xc, heads, n)) <= 1


def _profiled(fns):
    """The device kernels fns launch under torch.profiler: {name: count}.
    A session can come back without device records, or without some of
    them (late in a long process): one counts only when it recorded a
    kernel for every launch call it saw; up to five sessions."""
    from torch.profiler import ProfilerActivity, profile

    for fn in fns:
        fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for fn in fns:
                fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        names = {e.key: e.count for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0)) > 0}
        calls = sum(e.count for e in events
                    if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC"))
        if names and sum(names.values()) >= calls:
            return names
    return {}


def _in_fresh_process(name):
    """The JSON a profiling function of this module returns, run in a new
    Python process: late in a long process torch.profiler drops kernel
    records (sessions come back with some of the launches, or none)."""
    import json
    import os
    import subprocess
    import sys

    here = os.path.dirname(os.path.abspath(__file__))
    code = ("import json, sys; sys.path[:0] = [{!r}, {!r}]; "
            "import test_torch_kernels_cuda as T; "
            "print(json.dumps(T.{}()))").format(here, os.path.dirname(here),
                                                name)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _first_calls_on_a_new_thread():
    """K10, a GEMM-core weight grad and K9 called once on the main thread,
    then as the first calls of a new host thread, whose outputs come from
    torch's cache (so the thread makes no runtime call before the
    library's): {"errors": the messages of the calls that raised}."""
    import threading

    dev = torch.device("cuda:0")
    rng = np.random.default_rng(13)
    q, k, v, bias, mask = _video_attn_args(rng, dev, 9, 24, 392, True)
    o, lse = window_attention_save(q, k, v, bias, mask, 32 ** -0.5)
    a = _bf16(rng, (256, 128), 1.0, dev)
    calls = [lambda: window_attention(q, k, v, bias, mask, 32 ** -0.5),
             lambda: fm.wgrad(a, a, 64),
             lambda: attention_core_bwd(q, k, v, bias, mask, q, 32 ** -0.5, o,
                                        lse)]
    for fn in calls:
        fn()
    torch.cuda.synchronize()
    errors = []

    def run():
        for fn in calls:
            try:
                fn()
            except RuntimeError as e:
                errors.append(str(e))
        torch.cuda.synchronize()

    thread = threading.Thread(target=run)
    thread.start()
    thread.join()
    return {"errors": errors}


def test_kernels_launch_as_a_new_threads_first_calls(dev):
    """A host thread's first CUDA work can be the library's (an autograd
    worker whose allocations all come from torch's cache): the launches
    bind a context before they encode their tensor maps (in a fresh
    process, where the thread is the library's first but one)."""
    assert _in_fresh_process("_first_calls_on_a_new_thread") == {"errors": []}


def _k10_p2_profiles():
    """K10, its save mode, the strided route, K2p, P1 and P2 under
    torch.profiler: {"all": names of every call, "k2p": one K2p call's}."""
    from lavt_rs_tpu_torch.ops.window_attn import window_attention_qkv
    from lavt_rs_tpu_torch.tools import probe_headbatch as probe

    dev = torch.device("cuda:0")
    rng = np.random.default_rng(11)
    small = _k10_args(rng, dev, 8, 9, 32, 49, True)
    big = _k10_args(rng, dev, 1, 9, 24, 392, True)
    qkv = _bf16(rng, (8, 9, 49, 3 * 1024), 1.0, dev)
    x = probe.probe_input(96, 3, 4, 144, device=dev)
    nu, mask = partition_3d_groups(8, 120, 120, 8, 126, 126, (8, 7, 7),
                                   (0, 3, 3), 400, dev)
    xw = _bf16(rng, (1, 324, 400, 96), 1.0, dev)
    bias = pad_bias_sublane(_video_bias_mask(rng, dev, 3, 392, 1, False)[0],
                            400)
    k2p = (xw, *_k2p_weights(rng, dev, 96), bias, mask, nu, 3, 32 ** -0.5)

    names = _profiled(
        [lambda a=a: window_attention(*a, 32 ** -0.5) for a in (small, big)]
        + [lambda a=a: window_attention_save(*a, 32 ** -0.5)
           for a in (small, big)]
        + [lambda: window_attention_qkv(qkv, small[3], small[4], 32,
                                        32 ** -0.5),
           lambda: fused_window_msa_grouped(*k2p),
           lambda: probe.loop_attention(x, 3, 4, 144),
           lambda: probe.batch_attention(x, 3, 4, 144)])
    return {"all": names,
            "k2p": _profiled([lambda: fused_window_msa_grouped(*k2p)])}


def test_k10_and_p2_launch_only_the_ports_kernels(dev):
    """K10 (N = 49 and 392), its save mode, the strided route, K2p, P1 and
    P2 under torch.profiler (in a fresh process): every kernel is the
    port's own (no cuBLAS, cuDNN, flash or SDPA kernel), and a K2p call is
    its three launches (the qkv GEMM, K10's kernel, the out-projection
    GEMM)."""
    profiles = _in_fresh_process("_k10_p2_profiles")
    names, k2p_kernels = profiles["all"], profiles["k2p"]
    assert names, "the profiler recorded no kernel"
    assert all("lavt::" in n for n in names), sorted(names)
    for want in ("window_attn_sm90_kernel", "gemm_kernel",
                 "probe_kernel<9, true>", "probe_kernel<9, false>"):
        assert any(want in n for n in names), (want, sorted(names))
    assert sum(k2p_kernels.values()) == 3, k2p_kernels
    assert sum(n for k, n in k2p_kernels.items() if "gemm_kernel" in k) == 2
    assert sum(n for k, n in k2p_kernels.items()
               if "window_attn_sm90_kernel" in k) == 1


# -- K5 and K9 redesigned for Hopper (csrc/fused_msa_bwd_sm90.cu,
# csrc/window_attn_bwd_sm90.cu) ------------------------------------------------

# K5 at every shape chip_smoke.py checks: lavt_one Swin-B 480² at bs 8 (B,
# image side padded to 12, C, heads) per stage, and C = 96 (Swin-T stage 1)
K5_SHAPES = [(8, 120, 128, 4), (8, 60, 256, 8), (8, 36, 512, 16),
             (8, 24, 1024, 32), (8, 120, 96, 3)]
# K9 at every shape chip_smoke.py checks: (B, nW, heads, N, masked), the
# video stages (stage 1 in training too), a 4-frame clip's stage 2, window 7
K9_SHAPES = [(1, 324, 3, 392, False), (1, 324, 3, 392, True),
             (1, 81, 6, 392, True), (1, 25, 12, 392, True),
             (1, 9, 24, 392, True), (1, 81, 6, 196, True),
             (1, 64, 3, 49, True), (8, 324, 4, 49, False),
             (8, 81, 8, 49, True), (8, 25, 16, 49, True), (8, 9, 32, 49, True)]


def _k5_case(dev, b, hw, c, heads, seed):
    rng = np.random.default_rng(seed)
    x, w, bias, mask, scale = _msa_args(rng, dev, b, hw, c, heads, True)
    _, (q, k, v, p, _) = fused_window_msa_save(x, None, *w, bias, mask, heads,
                                               scale)
    gy = _bf16(rng, x.shape, 1.0, dev)
    return x, gy, w, (q, k, v, p), heads, scale


@pytest.mark.parametrize("b,hw,c,heads", K5_SHAPES)
def test_k5_kernel_at_the_path_shapes(dev, b, hw, c, heads):
    """K5 on the kernel's own save-mode residuals at every bs-8 stage shape,
    against its plain version on the same residuals; two calls give the
    same bits."""
    x, gy, w, saved, heads, scale = _k5_case(dev, b, hw, c, heads, c + 41)
    got = fused_window_msa_bwd(x, gy, w[0], w[2], saved, heads, scale)
    want = fused_window_msa_bwd_plain(x, gy, w[0], w[2], saved, heads, scale)
    _close_grads(got, want)
    again = fused_window_msa_bwd(x, gy, w[0], w[2], saved, heads, scale)
    for g, a in zip(got, again):
        assert torch.equal(g, a)


def test_k5_launches_against_their_plain_versions(dev):
    """Each of K5's launches alone against its plain counterpart, on the
    same inputs (stage 3's shape, C = 512)."""
    from lavt_rs_tpu_torch.ops import fused_msa as fmsa

    x, gy, w, (q, k, v, p), heads, scale = _k5_case(dev, 8, 36, 512, 16, 43)
    rows, c = gy.numel() // 512, 512
    g2, x2 = gy.reshape(rows, c), x.reshape(rows, c)
    dattn = fmsa.msa_dgrad(g2, w[2])
    _close(dattn, fmsa.msa_dgrad_plain(g2, w[2]), TOL_MSA)
    groups = fmsa.msa_bwd_groups(q.shape[0], heads)
    got = fmsa.msa_bwd_attn(dattn, q, k, v, p, heads, scale, groups)
    want = fmsa.msa_bwd_attn_plain(dattn.cpu(), q.cpu(), k.cpu(), v.cpu(),
                                   p.cpu(), heads, scale, groups)
    _close(got[0], want[0].to(dev), TOL_MSA)
    _close_scaled(got[1], want[1].to(dev), TOL_DX)
    for g, wt in zip(got[2:], want[2:]):
        _rel_frob(g, wt.to(dev), TOL_GRAD)
    dqkv = got[1]
    _close_scaled(fmsa.msa_dgrad(dqkv, w[0]), fmsa.msa_dgrad_plain(dqkv, w[0]),
                  TOL_DX)
    for a, b_ in ((dqkv, x2), (g2, got[0])):
        sr = fm.wgrad_split_tiles(rows, a.shape[1], b_.shape[1]) * 64
        part = fm.wgrad(a, b_, sr)
        assert part.shape[0] == -(-rows // sr)
        _rel_frob(fmsa.sum_partials(part), a.float().t() @ b_.float(), TOL_GRAD)


def test_k6_kernel_at_bs16(dev):
    """K6 (the save-mode forward, then K5's launches) at stage 1 with batch
    16, where the saved probabilities pass the residual cap."""
    rng = np.random.default_rng(47)
    x, w, bias, mask, scale = _msa_args(rng, dev, 16, 120, 128, 4, True)
    ln = (_bf16(rng, (128,), 0.2, dev) + 1.0, _bf16(rng, (128,), 0.2, dev))
    gy = _bf16(rng, x.shape, 1.0, dev)
    got = fused_window_msa_bwd_recompute(x, ln, *w, bias, mask, gy, 4, scale)
    want = fused_window_msa_bwd_recompute_plain(x, ln, *w, bias, mask, gy, 4,
                                                scale)
    _close_grads(got, want)


# the save mode's attention launch (K2 / the save mode / K6's forward) at
# the four Swin-B stage shapes of a bs-8 step, the batch cut: (B, image
# side padded to 12, C, heads)
MSA_ATTN_SHAPES = [(2, 120, 128, 4), (2, 60, 256, 8), (4, 36, 512, 16),
                   (4, 24, 1024, 32)]


def _qkv_case(dev, b, hw, c, heads, shift, seed):
    """The qkv projection's output (q scaled) on the GEMM core, with the
    bias, mask and the mask's window flags of a (hw x hw) map."""
    from lavt_rs_tpu_torch.ops import fused_msa as fmsa

    rng = np.random.default_rng(seed)
    x, w, bias, mask, scale = _msa_args(rng, dev, b, hw, c, heads, shift)
    qkv = fmsa.gemm_bias(x.reshape(-1, c), w[0], w[1], c, scale)
    return qkv.view(-1, 144, 3 * c), bias, mask, mask_flags(mask)


@pytest.mark.parametrize("b,hw,c,heads", MSA_ATTN_SHAPES)
@pytest.mark.parametrize("shift", [False, True])
def test_msa_attn_launch_both_modes(dev, b, hw, c, heads, shift):
    """The attention launch against its plain version (O within TOL_MSA, P
    within TOL_P + TOL_MSA relative); O has the same bits with the saves on
    and off, with the window flags and without, and in two calls; O is the
    bf16 product of the stored P (f32 sums in another order: within two
    bf16 steps)."""
    from lavt_rs_tpu_torch.ops import fused_msa as fmsa

    qkv, bias, mask, flags = _qkv_case(dev, b, hw, c, heads, shift, c + 53)
    o, p = fmsa.msa_attn(qkv, bias, mask, heads, True, flags)
    o_off, p_off = fmsa.msa_attn(qkv, bias, mask, heads, False, flags)
    o_all, p_all = fmsa.msa_attn(qkv, bias, mask, heads, True)
    o_p, p_p = fmsa.msa_attn_plain(qkv, bias, mask, heads)
    _close(o, o_p, TOL_MSA)
    torch.cuda.synchronize()
    err = (p.float() - p_p.float()).abs()
    assert bool((err <= TOL_P + TOL_MSA * p_p.float().abs()).all()), \
        f"P: max abs err {err.max().item():.4g}"
    assert p_off is None
    assert torch.equal(o, o_off) and torch.equal(o, o_all)
    assert torch.equal(p, p_all)
    o2, p2 = fmsa.msa_attn(qkv, bias, mask, heads, True, flags)
    assert torch.equal(o, o2) and torch.equal(p, p2)
    m = qkv.shape[0]
    vh = qkv[..., 2 * c:].float().reshape(m, 144, heads, 32).transpose(1, 2)
    from_p = (p.float() @ vh).transpose(1, 2).reshape(m * 144, c)
    _close(o, from_p.bfloat16(), 8e-3)


@pytest.mark.parametrize("b,hw,c,heads", MSA_ATTN_SHAPES[2:])
def test_k5_k6_on_the_save_launches_residuals(dev, b, hw, c, heads):
    """K5 on the save mode's residuals (q, k, v the column views of its qkv
    tensor) gives the same bits as on contiguous copies, and K5 and K6
    agree with their plain versions (grads within TOL_GRAD relative
    Frobenius)."""
    rng = np.random.default_rng(c + 59)
    x, w, bias, mask, scale = _msa_args(rng, dev, b, hw, c, heads, True)
    flags = mask_flags(mask)
    _, (q, k, v, p, _) = fused_window_msa_save(x, None, *w, bias, mask, heads,
                                               scale, flags=flags)
    assert q.stride(1) == 3 * c and not q.is_contiguous()
    gy = _bf16(rng, x.shape, 1.0, dev)
    got = fused_window_msa_bwd(x, gy, w[0], w[2], (q, k, v, p), heads, scale)
    copies = tuple(t.contiguous() for t in (q, k, v))
    again = fused_window_msa_bwd(x, gy, w[0], w[2], copies + (p,), heads,
                                 scale)
    for g, a in zip(got, again):
        assert torch.equal(g, a)
    _close_grads(got, fused_window_msa_bwd_plain(x, gy, w[0], w[2],
                                                 (q, k, v, p), heads, scale))
    k6 = fused_window_msa_bwd_recompute(x, None, *w, bias, mask, gy, heads,
                                        scale, flags=flags)
    _close_grads(k6, fused_window_msa_bwd_recompute_plain(
        x, None, *w, bias, mask, gy, heads, scale))


def _k9_case(dev, b, nw, heads, n, masked, seed):
    rng = np.random.default_rng(seed)
    q, k, v, do = (_bf16(rng, (b, nw, heads, n, 32), 1.0, dev)
                   for _ in range(4))
    if n == 49:
        table = torch.from_numpy(rng.standard_normal((13 * 13, heads))
                                 .astype(np.float32)).to(dev)
        bias = relative_bias_from_table(
            table, torch.from_numpy(relative_position_index_2d(7, 7)).to(dev))
        side = int(nw ** 0.5) * 7
        mask = shift_mask_2d(side, side, 7, 3, dev) if masked else None
    else:
        bias, _ = _video_bias_mask(rng, dev, heads, n, nw, False)
        side = int(nw ** 0.5) * 7
        mask = (shift_mask_3d(8 if n == 392 else 4, side, side,
                              (n // 49, 7, 7), (0, 3, 3), dev)
                if masked else None)
    o, lse = window_attention_save(q, k, v, bias, mask, 32 ** -0.5)
    return q, k, v, bias, mask, do, o, lse


@pytest.mark.parametrize("b,nw,heads,n,masked", K9_SHAPES)
def test_k9_kernel_at_the_path_shapes(dev, b, nw, heads, n, masked):
    """K9 at every video and window-7 shape of the main paths, on K10's
    saved output and lse, the shift masks of those blocks with their window
    flags; two calls give the same bits, and so does a call without the
    flags (every window's mask read: the others' are zeros)."""
    q, k, v, bias, mask, do, o, lse = _k9_case(dev, b, nw, heads, n, masked,
                                               n + nw + heads)
    scale, flags = 32 ** -0.5, mask_flags(mask)
    got = attention_core_bwd(q, k, v, bias, mask, do, scale, o, lse, flags)
    want = attention_core_bwd_plain(q, k, v, bias, mask, do, scale, o)
    for g, w in zip(got[:3], want[:3]):
        _close_scaled(g, w, TOL_DX)
    _rel_frob(got[3], want[3], TOL_GRAD)
    again = attention_core_bwd(q, k, v, bias, mask, do, scale, o, lse, flags)
    unflagged = attention_core_bwd(q, k, v, bias, mask, do, scale, o, lse)
    for g, a, u in zip(got, again, unflagged):
        assert torch.equal(g, a) and torch.equal(g, u)


@pytest.mark.parametrize("n", [392, 49])
def test_k9_launches_against_their_plain_versions(dev, n):
    """K9's two launches alone against their plain counterparts, with the
    window flags the blocks build beside their shift masks."""
    from lavt_rs_tpu_torch.ops import window_attn as wa
    from lavt_rs_tpu_torch.ops.window import (shift_mask_flags_2d,
                                              shift_mask_flags_3d)

    b, nw, heads = (1, 81, 6) if n == 392 else (8, 81, 8)
    q, k, v, bias, mask, do, o, lse = _k9_case(dev, b, nw, heads, n, True, 5)
    scale = 32 ** -0.5
    flags = (shift_mask_flags_3d(8, 63, 63, (8, 7, 7), (0, 3, 3), dev)
             if n == 392 else shift_mask_flags_2d(63, 63, 7, 3, dev))
    assert torch.equal(flags, wa.mask_flags(mask))
    plan = wa.k9_plan(b * nw, heads, n, 132)
    dq, qs, dsum, part = wa.attention_bwd_q(q, k, v, bias, mask, do, scale,
                                            o, lse, plan, flags)
    cpu = [t.cpu() for t in (q, k, v, bias, mask, do)]
    dq_p, qs_p, dsum_p, part_p = wa.attention_bwd_q_plain(
        *cpu, scale, o.cpu(), lse.cpu(), plan)
    _close_scaled(dq, dq_p.to(dev), TOL_DX)
    assert torch.equal(qs.cpu(), qs_p)  # one rounding of q scale
    _close_scaled(dsum, dsum_p.to(dev), 1e-3)
    _rel_frob(part, part_p.to(dev), TOL_GRAD)
    dk, dv = wa.attention_bwd_kv(qs, k, v, bias, mask, do, lse, dsum, plan,
                                 flags)
    dk_p, dv_p = wa.attention_bwd_kv_plain(qs.cpu(), *cpu[1:], lse.cpu(),
                                           dsum.cpu())
    _close_scaled(dk, dk_p.to(dev), TOL_DX)
    _close_scaled(dv, dv_p.to(dev), TOL_DX)


def _k5_k9_profiles():
    """One K5, one K9 and one K6 call under torch.profiler: {"k5": names,
    "k9": ..., "k6": ...}."""
    dev = torch.device("cuda:0")
    x, gy, w, saved, heads, scale = _k5_case(dev, 8, 36, 512, 16, 53)
    q, k, v, bias, mask, do, o, lse = _k9_case(dev, 1, 81, 6, 392, True, 7)
    flags = mask_flags(mask)
    zeros = torch.zeros((heads, 144, 144), device=dev)
    return {
        "k5": _profiled([lambda: fused_window_msa_bwd(x, gy, w[0], w[2], saved,
                                                      heads, scale)]),
        "k9": _profiled([lambda: attention_core_bwd(
            q, k, v, bias, mask, do, 32 ** -0.5, o, lse, flags)]),
        "k6": _profiled([lambda: fused_window_msa_bwd_recompute(
            x, None, *w, zeros, None, gy, heads, scale)])}


def test_k5_and_k9_launch_only_the_ports_kernels(dev):
    """K5 (and K6) and K9 launch only the port's kernels (namespace lavt::),
    no cuBLAS / cuDNN / SDPA kernel (profiled in a fresh process): K5 as
    two GEMM-core dgrads, its attention, two weight-grad GEMMs, the column
    sums and the partial sums; K9 as its two launches and the dbias sum."""
    profiles = _in_fresh_process("_k5_k9_profiles")
    k5, k9, k6 = profiles["k5"], profiles["k9"], profiles["k6"]
    assert all("lavt::" in n for n in k5), sorted(k5)
    assert sum(c for n, c in k5.items() if "gemm_kernel" in n) == 4, k5
    assert sum(c for n, c in k5.items() if "msa_bwd_sm90_kernel" in n) == 1
    assert all("lavt::" in n for n in k9), sorted(k9)
    assert sum(c for n, c in k9.items() if "attn_bwd_q_kernel" in n) == 1
    assert sum(c for n, c in k9.items() if "attn_bwd_kv_kernel" in n) == 1
    assert k6 and all("lavt::" in n for n in k6), sorted(k6)


@pytest.mark.parametrize("n", [17, 63, 130, 400])
def test_k9_kernel_at_ragged_n(dev, n):
    """K9 off the path shapes: N not a multiple of 16 or 64 (one key tile
    and several; 130: bias rows padded for TMA) and N = 400, under a
    random mask, on K10's saved output and lse.  (At N = 1 the softmax is
    1 and dq, dk are rounding noise: nothing to compare.)"""
    rng = np.random.default_rng(n + 61)
    b, nw, heads = 2, 3, 5
    q, k, v, do = (_bf16(rng, (b, nw, heads, n, 32), 1.0, dev)
                   for _ in range(4))
    bias = torch.from_numpy(rng.standard_normal((heads, n, n))
                            .astype(np.float32)).to(dev)
    mask = torch.from_numpy(np.where(rng.random((nw, n, n)) > 0.7, -100.0,
                                     0.0).astype(np.float32)).to(dev)
    mask[1] = 0.0  # a window whose flag is 0
    scale = 32 ** -0.5
    o, lse = window_attention_save(q, k, v, bias, mask, scale)
    got = attention_core_bwd(q, k, v, bias, mask, do, scale, o, lse)
    want = attention_core_bwd_plain(q, k, v, bias, mask, do, scale, o)
    for g, w in zip(got[:3], want[:3]):
        _close_scaled(g, w, TOL_DX)
    _rel_frob(got[3], want[3], TOL_GRAD)
