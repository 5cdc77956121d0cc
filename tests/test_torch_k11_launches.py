"""The host side of K11 and K1 on the CPU: their launches and their glue.

K11 (the window MSA over a padded, pre-rolled (B, Hp, Wp, C) map) runs on
the card as the three launches of `ops/fused_msa_2d.map_launches`: the qkv
projection on the GEMM core over the map's rows (`gemm_bias`, q scaled
after its bias), the attention in map order (`msa_attn_map`: each
window's q, k, v read from the qkv map, O written back at the window's map
positions), and the out-projection on the core over O's rows.  K1 runs as
`ops/fused_msa.save_launches` with LN and without the saves.  On CPU
tensors each launch takes its plain version, so the shapes, views and
window arithmetic around the kernels run here:

* `map_launches`' plain composition equals K11's plain version
  (`fused_window_msa_2d_plain`) with and without the shift mask, with and
  without the mask's window flags, on square and non-square maps;
* it equals the window-order launches (`save_launches(save=False)`) on the
  partitioned map, partitioned back, and `msa_attn_map_plain` equals the
  window-order `msa_attn_plain` on the partitioned qkv map;
* it equals the JAX package's `experimental.fused_window_msa_2d` (the
  Pallas kernel) in interpret mode;
* K1's launches with the window flags equal `fused_window_msa_ln_plain`
  and the JAX `fused_window_msa_ln` in interpret mode;
* a padded, shifted `SwinBlock` passes its mask's window flags to K11 and
  an unpadded one to K1.

Window 12 (N = 144), head dim 32 (2 and 4 heads), batch 2, 24 x 24 and
36 x 24 maps.  Tolerances: f32 on both sides of the same math, so 1e-5
abs + rel; against Pallas 2e-4 abs + rel (f32 sums over C and N in
another order, through softmax; the JAX map kernel keeps q and k in f32
where the port rounds them to x's dtype, which in f32 is no rounding), as
tests/test_torch_msa_save_launches.py holds the save mode's launches.
"""

from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from lavt_rs_tpu.ops.pallas import experimental as jexp
from lavt_rs_tpu.ops.pallas import fused_msa as jmsa
from lavt_rs_tpu_torch.models.swin2d import SwinBlock
from lavt_rs_tpu_torch.ops import fused_msa, fused_msa_2d
from lavt_rs_tpu_torch.ops.window import (shift_mask_2d, shift_mask_flags_2d,
                                          window_partition, window_reverse)

N, WS, B = 144, 12, 2
MAPS = [(24, 24), (36, 24)]
TOL, TOL_PALLAS = 1e-5, 2e-4


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))


def _map_inputs(rng, heads, hp, wp, shift):
    """A (B, Hp, Wp, C) map at C = 32 heads, torch-layout weights, the
    bias, the shift mask of the map and its window flags (or None)."""
    c = 32 * heads
    x = _t(rng.standard_normal((B, hp, wp, c)))
    w = [_t(a) for a in (rng.standard_normal((3 * c, c)) * c ** -0.5,
                         0.2 * rng.standard_normal(3 * c),
                         rng.standard_normal((c, c)) * c ** -0.5,
                         0.2 * rng.standard_normal(c))]
    bias = _t(rng.standard_normal((heads, N, N)))
    mask = shift_mask_2d(hp, wp, WS, WS // 2, "cpu") if shift else None
    flags = shift_mask_flags_2d(hp, wp, WS, WS // 2, "cpu") if shift else None
    return x, w, bias, mask, flags


@pytest.mark.parametrize("heads", [2, 4])
@pytest.mark.parametrize("hp,wp", MAPS)
@pytest.mark.parametrize("shift,with_flags", [(False, False), (True, False),
                                              (True, True)])
def test_map_launches_compose_to_the_plain(heads, hp, wp, shift, with_flags):
    rng = np.random.default_rng(heads + hp + 2 * shift + 4 * with_flags)
    x, w, bias, mask, flags = _map_inputs(rng, heads, hp, wp, shift)
    sc = 32 ** -0.5
    y = fused_msa_2d.map_launches(x, *w, bias, mask, heads, sc,
                                  flags if with_flags else None)
    want = fused_msa_2d.fused_window_msa_2d_plain(x, *w, bias, mask, heads,
                                                  sc, WS)
    assert y.shape == x.shape
    torch.testing.assert_close(y, want, rtol=TOL, atol=TOL)
    # the wrapper on a CPU tensor: the plain version in K11 f32's softmax
    # form (exp(min(s, 80)) on these f32 inputs), no kernel counted
    before = fused_msa_2d.fused_window_msa_2d.launches
    got = fused_msa_2d.fused_window_msa_2d(x, *w, bias, mask, heads, sc, WS,
                                           flags if with_flags else None)
    torch.testing.assert_close(got, fused_msa_2d.fused_window_msa_2d_plain(
        x, *w, bias, mask, heads, sc, WS, exact=False), rtol=0, atol=0)
    assert fused_msa_2d.fused_window_msa_2d.launches == before


@pytest.mark.parametrize("heads", [2, 4])
@pytest.mark.parametrize("hp,wp", MAPS)
def test_map_launches_equal_the_window_order_launches(heads, hp, wp):
    rng = np.random.default_rng(17 + heads + wp)
    x, w, bias, mask, flags = _map_inputs(rng, heads, hp, wp, True)
    sc, c = 32 ** -0.5, 32 * heads
    nw = (hp // WS) * (wp // WS)
    y = fused_msa_2d.map_launches(x, *w, bias, mask, heads, sc, flags)
    xw = window_partition(x, WS).view(B, nw, N, c)
    yw = fused_msa.save_launches(xw, None, *w, bias, mask, heads, sc,
                                 save=False, flags=flags)
    torch.testing.assert_close(
        y, window_reverse(yw.view(B * nw, N, c), WS, hp, wp), rtol=TOL,
        atol=TOL)
    # the attention alone: map order against window order on the same qkv
    # (K11 f32's softmax form, exp(min(s, 80)), on these f32 inputs)
    qkv = fused_msa.gemm_bias(x.reshape(-1, c), w[0], w[1], c, sc)
    qkv = qkv.view(B, hp, wp, 3 * c)
    o = fused_msa_2d.msa_attn_map(qkv, bias, mask, heads, flags)
    ow, _ = fused_msa.msa_attn_plain(window_partition(qkv, WS), bias, mask,
                                     heads, exact=False)
    assert o.shape == (B, hp, wp, c)
    torch.testing.assert_close(o, window_reverse(ow.view(B * nw, N, c), WS,
                                                 hp, wp), rtol=0, atol=0)


@pytest.mark.parametrize("shift", [False, True])
def test_map_launches_match_the_pallas_kernel(shift):
    """The non-square 36 x 24 map (3 x 2 windows), where a swapped window
    row or column, or a wrong mask index, shows."""
    rng = np.random.default_rng(23 + shift)
    heads = 2
    x, w, bias, mask, flags = _map_inputs(rng, heads, 36, 24, shift)
    sc = 32 ** -0.5
    with pltpu.force_tpu_interpret_mode():
        want = jexp.fused_window_msa_2d(
            jnp.asarray(x.numpy()), jnp.asarray(w[0].numpy().T),
            jnp.asarray(w[1].numpy()), jnp.asarray(w[2].numpy().T),
            jnp.asarray(w[3].numpy()), jnp.asarray(bias.numpy()),
            None if mask is None else jnp.asarray(mask.numpy()), heads, sc,
            WS)
    y = fused_msa_2d.map_launches(x, *w, bias, mask, heads, sc, flags)
    np.testing.assert_allclose(y.numpy(), np.asarray(want), rtol=TOL_PALLAS,
                               atol=TOL_PALLAS)


@pytest.mark.parametrize("heads", [2, 4])
def test_k1_launches_with_flags(heads):
    rng = np.random.default_rng(29 + heads)
    c, hw, sc = 32 * heads, 24, 32 ** -0.5
    nw = (hw // WS) ** 2
    x = _t(rng.standard_normal((B, nw, N, c)))
    w = [_t(a) for a in (rng.standard_normal((3 * c, c)) * c ** -0.5,
                         0.2 * rng.standard_normal(3 * c),
                         rng.standard_normal((c, c)) * c ** -0.5,
                         0.2 * rng.standard_normal(c))]
    bias = _t(rng.standard_normal((heads, N, N)))
    mask = shift_mask_2d(hw, hw, WS, 6, "cpu")
    flags = shift_mask_flags_2d(hw, hw, WS, 6, "cpu")
    ln = (_t(1 + 0.2 * rng.standard_normal(c)),
          _t(0.2 * rng.standard_normal(c)))
    want = fused_msa.fused_window_msa_ln_plain(x, *ln, *w, bias, mask, heads,
                                               sc)
    got = fused_msa.save_launches(x, ln, *w, bias, mask, heads, sc,
                                  save=False, flags=flags)
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
    # the wrapper: the plain version in K1 f32's inference softmax form
    wrapped = fused_msa.fused_window_msa_ln(x, *ln, *w, bias, mask, heads, sc,
                                            flags=flags)
    torch.testing.assert_close(wrapped, fused_msa.fused_window_msa_ln_plain(
        x, *ln, *w, bias, mask, heads, sc, exact=False), rtol=0, atol=0)
    with pltpu.force_tpu_interpret_mode():
        jwant = jmsa.fused_window_msa_ln(
            jnp.asarray(x.numpy()), jnp.asarray(ln[0].numpy()),
            jnp.asarray(ln[1].numpy()), jnp.asarray(w[0].numpy().T),
            jnp.asarray(w[1].numpy()), jnp.asarray(w[2].numpy().T),
            jnp.asarray(w[3].numpy()), jnp.asarray(bias.numpy()),
            jnp.asarray(mask.numpy()), heads, sc)
    np.testing.assert_allclose(got.numpy(), np.asarray(jwant),
                               rtol=TOL_PALLAS, atol=TOL_PALLAS)


@pytest.mark.parametrize("hw,target", [((18, 30), "fused_msa_2d"),
                                       ((24, 24), "fused_msa")])
def test_swin_block_passes_its_window_flags(hw, target):
    """A shifted block under no_grad: padded (18 x 30 -> 24 x 36) it takes
    K11, unpadded (24 x 24) K1; each gets the shift mask's window flags."""
    torch.manual_seed(0)
    block = SwinBlock(64, 2, window_size=WS, shift_size=6).eval()
    for p in block.parameters():
        torch.nn.init.normal_(p, std=0.1)
    x = torch.randn(1, hw[0] * hw[1], 64)
    hp, wp = (-(-s // WS) * WS for s in hw)
    module, name = ((fused_msa_2d, "fused_window_msa_2d")
                    if target == "fused_msa_2d"
                    else (fused_msa, "fused_window_msa_ln"))
    with mock.patch.object(module, name, wraps=getattr(module, name)) as k:
        with torch.no_grad():
            y = block(x, hw)
    assert k.call_count == 1 and y.shape == x.shape
    args, kwargs = k.call_args
    flags = kwargs.get("flags", args[-1])
    torch.testing.assert_close(flags, shift_mask_flags_2d(hp, wp, WS, 6,
                                                          "cpu"))
