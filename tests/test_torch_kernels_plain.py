"""Plain versions of the port's kernels (K1-K4) against the Pallas
kernels they replace, on the CPU with Pallas in interpret mode.

Window 12 (N = 144), head dim 32, a few windows, with and without the
shift mask; same numpy inputs, f32 throughout.  The Pallas inference MSA
uses exp(min(s, 80)) where the port takes the exact max-subtracted softmax:
the two agree while every logit is below 80, as here.  Tolerances: 1e-4
for the MSA (f32 sums over C and N in another order, through softmax),
1e-5 for the LayerNorm and the MLP.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from lavt_rs_tpu.ops.pallas import fused_mlp as jmlp
from lavt_rs_tpu.ops.pallas import fused_msa as jmsa
from lavt_rs_tpu.ops.pallas import ln as jln
from lavt_rs_tpu.ops.window import shift_mask_2d as jshift_mask_2d
from lavt_rs_tpu_torch.ops import fused_mlp, fused_msa, ln
from torch_threads import torch_threads  # noqa: F401 (autouse fixture)

TOL_MSA = 1e-4
TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a, order="C"))


def _msa_inputs(rng, c, heads, hw):
    b, n = 1, 144
    nw = (hw // 12) ** 2
    f = np.float32
    return dict(
        x=rng.standard_normal((b, nw, n, c)).astype(f),
        ln_s=(1.0 + 0.1 * rng.standard_normal(c)).astype(f),
        ln_b=(0.1 * rng.standard_normal(c)).astype(f),
        wqkv=(rng.standard_normal((c, 3 * c)) * c ** -0.5).astype(f),
        bqkv=(0.1 * rng.standard_normal(3 * c)).astype(f),
        wproj=(rng.standard_normal((c, c)) * c ** -0.5).astype(f),
        bproj=(0.1 * rng.standard_normal(c)).astype(f),
        bias=rng.standard_normal((heads, n, n)).astype(f),
        scale=(c // heads) ** -0.5)


@pytest.mark.parametrize("shift", [False, True])
def test_plain_k1_matches_fused_window_msa_ln(rng, shift):
    c, heads, hw = 64, 2, 24
    a = _msa_inputs(rng, c, heads, hw)
    mask = jshift_mask_2d(hw, hw, 12, 6) if shift else None
    with pltpu.force_tpu_interpret_mode():
        want = jmsa.fused_window_msa_ln(
            *(jnp.asarray(a[k]) for k in ("x", "ln_s", "ln_b", "wqkv", "bqkv",
                                          "wproj", "bproj", "bias")),
            mask, heads, a["scale"])
    got = fused_msa.fused_window_msa_ln(
        _t(a["x"]), _t(a["ln_s"]), _t(a["ln_b"]), _t(a["wqkv"].T), _t(a["bqkv"]),
        _t(a["wproj"].T), _t(a["bproj"]), _t(a["bias"]),
        None if mask is None else _t(np.asarray(mask)), heads, a["scale"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL_MSA,
                               atol=TOL_MSA)


@pytest.mark.parametrize("shift", [False, True])
def test_plain_k2_matches_fused_window_msa(rng, shift):
    c, heads, hw = 96, 3, 24
    a = _msa_inputs(rng, c, heads, hw)
    mask = jshift_mask_2d(hw, hw, 12, 6) if shift else None
    with pltpu.force_tpu_interpret_mode():
        want = jmsa.fused_window_msa(
            *(jnp.asarray(a[k]) for k in ("x", "wqkv", "bqkv", "wproj",
                                          "bproj", "bias")),
            mask, heads, a["scale"])
    got = fused_msa.fused_window_msa(
        _t(a["x"]), _t(a["wqkv"].T), _t(a["bqkv"]), _t(a["wproj"].T),
        _t(a["bproj"]), _t(a["bias"]),
        None if mask is None else _t(np.asarray(mask)), heads, a["scale"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL_MSA,
                               atol=TOL_MSA)


@pytest.mark.parametrize("m,c", [(64, 128), (40, 256)])
def test_plain_k3_matches_fused_ln_mlp(rng, m, c):
    f = np.float32
    hidden = 4 * c
    x = rng.standard_normal((m, c)).astype(f) * 2 + 0.5
    g = (1.0 + 0.1 * rng.standard_normal(c)).astype(f)
    be = (0.1 * rng.standard_normal(c)).astype(f)
    w1 = (rng.standard_normal((c, hidden)) * c ** -0.5).astype(f)
    b1 = (0.1 * rng.standard_normal(hidden)).astype(f)
    w2 = (rng.standard_normal((hidden, c)) * hidden ** -0.5).astype(f)
    b2 = (0.1 * rng.standard_normal(c)).astype(f)
    with pltpu.force_tpu_interpret_mode():
        want = jmlp.fused_ln_mlp(*(jnp.asarray(a) for a in
                                   (x, g, be, w1, b1, w2, b2)))
    got = fused_mlp.fused_ln_mlp(_t(x), _t(g), _t(be), _t(w1.T), _t(b1),
                                 _t(w2.T), _t(b2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("rows,c", [(64, 128), (24, 1024)])
def test_plain_k4_matches_layer_norm_rows(rng, rows, c):
    f = np.float32
    x = rng.standard_normal((rows, c)).astype(f) * 3 + 1
    s = (1.0 + 0.1 * rng.standard_normal(c)).astype(f)
    b = (0.1 * rng.standard_normal(c)).astype(f)
    with pltpu.force_tpu_interpret_mode():
        want = jln.layer_norm_rows(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b))
    got = ln.layer_norm_rows(_t(x), _t(s), _t(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_cpu_tensors_take_the_plain_version_without_counting(rng):
    x = _t(rng.standard_normal((8, 128)).astype(np.float32))
    s, b = torch.ones(128), torch.zeros(128)
    before = ln.layer_norm_rows.launches
    torch.testing.assert_close(ln.layer_norm_rows(x, s, b),
                               ln.layer_norm_rows_plain(x, s, b))
    assert ln.layer_norm_rows.launches == before
