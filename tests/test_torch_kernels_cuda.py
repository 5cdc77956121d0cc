"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card.  Marked `cuda`; every test skips without a CUDA device.

Runs without JAX (the repo's conftest imports it), so on the GPU machine:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

Inputs are bf16; the plain versions compute in f32 from the same bf16
inputs and round where the kernels round.  Tolerances: bf16 keeps 8
significant bits (relative step 2^-8 ≈ 3.9e-3), so one rounding of an O(1)
output is ≤ 4e-3 and a rounding that lands on the other side of a
neighbouring intermediate (the bf16 LN output, GELU output, q/k/v, P)
moves the result by a few such steps: 2e-2 (≈ 5 steps) for LN and MLP,
3e-2 for the MSA, whose P and attention output are rounded twice more.
"""

import numpy as np
import pytest
import torch

from lavt_rs_tpu_torch.ops.fused_mlp import fused_ln_mlp, fused_ln_mlp_plain
from lavt_rs_tpu_torch.ops.fused_msa import (
    fused_window_msa, fused_window_msa_ln, fused_window_msa_ln_plain,
    fused_window_msa_plain)
from lavt_rs_tpu_torch.ops.ln import layer_norm_rows, layer_norm_rows_plain
from lavt_rs_tpu_torch.ops.window import (relative_bias_from_table,
                                          relative_position_index_2d,
                                          shift_mask_2d)

pytestmark = pytest.mark.cuda

TOL_LN_MLP = 2e-2
TOL_MSA = 3e-2


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
