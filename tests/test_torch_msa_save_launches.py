"""The host side of K2 and the K1/K2 save mode on the CPU: their launches
and their glue.

K2, the save mode and K6's forward run on the card as the launches of
`ops/fused_msa.save_launches`: K1's pre-attention LN rows on K4's launch
(`ln.layer_norm_rows_launch`), the qkv projection on the GEMM core
(`gemm_bias`, q scaled after its bias), the attention (`msa_attn`: P
normalised in f32, rounded to bf16, stored in save mode, and O made from
that bf16 P) on the qkv tensor, and the out-projection on the core.  The
save mode's q, k, v are the column views of that one qkv tensor, which
K5's attention launch reads at row stride 3C.  On CPU tensors each launch
takes its plain version, so the shapes, views and strides around the
kernels run here:

* the plain launches compose to `fused_window_msa_save_plain`'s y, q, k,
  v, p and xn (and, without saves, to K2's plain version) at N = 144 with
  2 and 4 heads, a few windows, with and without the shift mask, with and
  without LN;
* in bf16, O is the bf16 product of the stored P (not of the unnormalised
  exponentials divided afterwards, which gives other bits), and xn's bits
  are the save plain version's;
* K5's plain launches (`bwd_launches`) give the same bits on the saved
  column views as on contiguous copies;
* the composition equals the JAX package's save path (`_fwd(...,
  save=True)` of `fused_window_msa` / `fused_window_msa_ln`) on its Pallas
  kernel in interpret mode.

Tolerances: f32 on both sides of the same math, so 1e-5 abs + rel;
against Pallas 2e-4 abs + rel, as tests/test_torch_k2p_launches.py holds
K2p's launches to it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from lavt_rs_tpu.ops.pallas import fused_msa as jmsa
from lavt_rs_tpu_torch.ops import fused_msa
from lavt_rs_tpu_torch.ops.window import shift_mask_2d, shift_mask_flags_2d
from torch_threads import torch_threads  # noqa: F401 (autouse fixture)

N = 144
NAMES = ("q", "k", "v", "p", "xn")


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))


def _inputs(rng, heads, hw=24, b=2, shift=True, ln=True):
    """Windowed x (B, nW, 144, C) at C = 32 heads, torch-layout weights,
    the bias, the shift mask of an hw x hw map and its window flags, the
    LN parameters (or None)."""
    c, nw = 32 * heads, (hw // 12) ** 2
    x = _t(rng.standard_normal((b, nw, N, c)))
    w = [_t(a) for a in (rng.standard_normal((3 * c, c)) * c ** -0.5,
                         0.2 * rng.standard_normal(3 * c),
                         rng.standard_normal((c, c)) * c ** -0.5,
                         0.2 * rng.standard_normal(c))]
    bias = _t(rng.standard_normal((heads, N, N)))
    mask = shift_mask_2d(hw, hw, 12, 6, "cpu") if shift else None
    flags = shift_mask_flags_2d(hw, hw, 12, 6, "cpu") if shift else None
    lnp = ((_t(1 + 0.2 * rng.standard_normal(c)),
            _t(0.2 * rng.standard_normal(c))) if ln else None)
    return x, w, bias, mask, flags, lnp


@pytest.mark.parametrize("heads", [2, 4])
@pytest.mark.parametrize("shift", [False, True])
@pytest.mark.parametrize("ln", [False, True])
def test_launches_compose_to_the_save_plain(heads, shift, ln):
    rng = np.random.default_rng(heads + 2 * shift + 4 * ln)
    x, w, bias, mask, flags, lnp = _inputs(rng, heads, shift=shift, ln=ln)
    sc = 32 ** -0.5
    y_want, want = fused_msa.fused_window_msa_save_plain(
        x, lnp, *w, bias, mask, heads, sc)
    y, got = fused_msa.save_launches(x, lnp, *w, bias, mask, heads, sc,
                                     flags=flags)
    torch.testing.assert_close(y, y_want, rtol=1e-5, atol=1e-5)
    for name, g, wt in zip(NAMES, got, want):
        if wt is None:
            assert g is None and not ln, name
            continue
        assert g.shape == wt.shape, name
        torch.testing.assert_close(g, wt, rtol=1e-5, atol=1e-5, msg=name)
    q, k, v = got[:3]  # column views of one (B nW, N, 3C) tensor
    c = 32 * heads
    assert q.stride() == k.stride() == v.stride() == (N * 3 * c, 3 * c, 1)
    assert k.data_ptr() - q.data_ptr() == c * q.element_size()
    # without saves: K2's plain version (no LN: the model's K2 is post-LN)
    if not ln:
        torch.testing.assert_close(
            fused_msa.save_launches(x, None, *w, bias, mask, heads, sc,
                                    save=False),
            fused_msa.fused_window_msa_plain(x, *w, bias, mask, heads, sc),
            rtol=1e-5, atol=1e-5)


def test_output_is_made_from_the_stored_probabilities():
    rng = np.random.default_rng(3)
    x, w, bias, mask, _, lnp = _inputs(rng, 2)
    xb = x.bfloat16()
    wb = [t.bfloat16() for t in w]
    lnb = tuple(t.bfloat16() for t in lnp)
    _, (q, k, v, p, xn) = fused_msa.save_launches(xb, lnb, *wb, bias, mask, 2,
                                                  32 ** -0.5)
    b, nw, n, c = x.shape
    m = b * nw
    o, p2 = fused_msa.msa_attn(
        torch.cat([q, k, v], -1), bias, mask, 2, save=True)
    assert torch.equal(p, p2)
    vh = v.float().reshape(m, n, 2, 32).transpose(1, 2)
    want = (p.float() @ vh).bfloat16().transpose(1, 2).reshape(m * n, c)
    assert torch.equal(o, want)
    # K10's rounding (the unnormalised exp in bf16, O divided afterwards)
    # gives other bits: the check above tells the two apart
    qh, kh = (t.float().reshape(m, n, 2, 32).transpose(1, 2) for t in (q, k))
    s = (qh @ kh.transpose(-1, -2) + bias).view(b, nw, 2, n, n) + mask[:, None]
    s = s.view(m, 2, n, n)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    k10 = ((e.bfloat16().float() @ vh) / e.sum(-1, keepdim=True)).bfloat16()
    assert not torch.equal(o, k10.transpose(1, 2).reshape(m * n, c))
    # xn: K4's launch gives the save plain version's bits
    _, want = fused_msa.fused_window_msa_save_plain(xb, lnb, *wb, bias, mask,
                                                    2, 32 ** -0.5)
    assert xn.dtype == torch.bfloat16 and torch.equal(xn, want[4])


@pytest.mark.parametrize("shift", [False, True])
def test_k5_gives_the_same_bits_on_the_views(shift):
    rng = np.random.default_rng(7 + shift)
    x, w, bias, mask, flags, _ = _inputs(rng, 2, shift=shift, ln=False)
    xb, gy = x.bfloat16(), _t(rng.standard_normal(x.shape)).bfloat16()
    wb = [t.bfloat16() for t in w]
    _, (q, k, v, p, _) = fused_msa.save_launches(xb, None, *wb, bias, mask, 2,
                                                 32 ** -0.5, flags=flags)
    assert not q.is_contiguous()
    got = fused_msa.bwd_launches(xb, gy, wb[0], wb[2], (q, k, v, p), 2,
                                 32 ** -0.5)
    want = fused_msa.bwd_launches(
        xb, gy, wb[0], wb[2], tuple(t.contiguous() for t in (q, k, v, p)), 2,
        32 ** -0.5)
    for g, wt in zip(got, want):
        assert torch.equal(g, wt)


@pytest.mark.parametrize("ln,shift", [(True, False), (False, True)])
def test_launches_match_the_pallas_save_path(ln, shift):
    rng = np.random.default_rng(11 + ln)
    x, w, bias, mask, flags, lnp = _inputs(rng, 2, shift=shift, ln=ln)
    sc = 32 ** -0.5
    with pltpu.force_tpu_interpret_mode():
        out, saved = jmsa._fwd(
            jnp.asarray(x.numpy()), jnp.asarray(w[0].numpy().T),
            jnp.asarray(w[1].numpy()), jnp.asarray(w[2].numpy().T),
            jnp.asarray(w[3].numpy()), jnp.asarray(bias.numpy()),
            None if mask is None else jnp.asarray(mask.numpy()), 2, sc,
            ln=None if lnp is None else tuple(jnp.asarray(t.numpy())
                                             for t in lnp),
            exact=True, save=True)
    y, got = fused_msa.save_launches(x, lnp, *w, bias, mask, 2, sc,
                                     flags=flags)
    np.testing.assert_allclose(y.numpy(), np.asarray(out), rtol=2e-4,
                               atol=2e-4)
    for name, g, wt in zip(NAMES, got, saved):
        np.testing.assert_allclose(g.numpy(), np.asarray(wt), rtol=2e-4,
                                   atol=2e-4, err_msg=name)
    assert len(saved) == (5 if ln else 4)
