"""K9 f32 and K5 f32's attention launch, the f32 attention backwards in
3xTF32 on the tensor cores, and the softmax forms of the inference MSA
kernels past a logit of 80, on the card.  Marked `cuda`; every test skips
without a CUDA device.  Runs without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_attn_tf32_cuda.py

* K9 f32's launches (`bwd_launches_f32`: dq, D and the dbias partials,
  then dk and dv, then the sum) at N = 392 (video stage-1 geometry: 80-row
  tiles with 8 rows of padding, key tiles of 56) and N = 49 (window 7),
  with masked and unmasked windows (window flags naming some of them), on
  the card's own plan (several dbias partials), within 1e-4 abs + rel of
  their plain versions, launch by launch; two calls give the same bits;
* K5 f32's attention launch (`msa_bwd_attn_f32`: o, dqkv, the dbias
  partials by group, the dbqkv sum) at N = 144 from the save mode f32's P
  and q, k, v views, at shifted stage shapes (C = 128 and 512), within
  1e-4 abs + rel of `msa_bwd_attn_plain`; two calls give the same bits;
* F8: with a bias table of std 60 (logits past 80), K2p f32 and the bf16
  K1 and K11 agree with their exact plain versions (1e-4 abs + rel in f32,
  bf16 within the bf16 MSA tests' 3e-2), which differ from the clamp form
  the JAX inference kernels take by more than 1e-2.

f32 tolerance: 3xTF32 products and f32 sums in another order than the
plain versions' (tests/test_torch_f32_cuda.py); TF32 off in the plain
versions.
"""

import numpy as np
import pytest
import torch

from lavt_rs_tpu_torch.ops import (cuda_lib, fused_msa, fused_msa_2d,
                                   window_attn)
from lavt_rs_tpu_torch.ops.window import shift_mask_2d, shift_mask_flags_2d

pytestmark = pytest.mark.cuda

TOL = 1e-4
TOL_BF16 = 3e-2
SCALE = 32 ** -0.5


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


def _close(got, want, tol=TOL):
    torch.cuda.synchronize()
    assert got.shape == want.shape
    assert bool(torch.isfinite(got.float()).all())
    err = (got.float() - want.float()).abs()
    assert bool((err <= tol + tol * want.float().abs()).all()), \
        err.max().item()


@pytest.mark.parametrize("n,nw,heads", [(392, 12, 3), (49, 32, 4)])
@pytest.mark.parametrize("masked", [False, True])
def test_k9_f32_launches(dev, n, nw, heads, masked):
    rng = np.random.default_rng(n + nw + masked)
    b = 2
    q, k, v, do = (_f32(rng, (b, nw, heads, n, 32), 1.0, dev)
                   for _ in range(4))
    bias = _f32(rng, (heads, n, n), 1.0, dev)
    mask = flags = None
    if masked:  # every third window masks nothing (its flag is 0)
        m = np.where(rng.random((nw, n, n)) > 0.7, -100.0, 0.0)
        m[::3] = 0.0
        mask = torch.from_numpy(m.astype(np.float32)).to(dev)
        flags = window_attn.mask_flags(mask)
    o, lse = window_attn.window_attention_save(q, k, v, bias, mask, SCALE)
    plan = window_attn.k9_f32_plan(b * nw, heads, n, cuda_lib.sm_count(0))
    assert plan["parts"] > 1
    dq, dsum, part = window_attn.attention_bwd_q_f32(
        q, k, v, bias, mask, do, SCALE, o, lse, plan, flags)
    pdq, _, pdsum, ppart = window_attn.attention_bwd_q_plain(
        q, k, v, bias, mask, do, SCALE, o, lse, plan)
    _close(dq, pdq)
    _close(dsum, pdsum)
    _close(part, ppart)
    dk, dv = window_attn.attention_bwd_kv_f32(q, k, v, bias, mask, do, SCALE,
                                              lse, dsum, flags)
    pdk, pdv = window_attn.attention_bwd_kv_plain(q * SCALE, k, v, bias, mask,
                                                  do, lse, pdsum)
    _close(dk, pdk)
    _close(dv, pdv)
    got = window_attn.bwd_launches_f32(q, k, v, bias, mask, do, SCALE, o, lse,
                                       flags=flags)
    again = window_attn.bwd_launches_f32(q, k, v, bias, mask, do, SCALE, o,
                                         lse, flags=flags)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.parametrize("c,heads", [(128, 4), (512, 16)])
def test_k5_f32_attention_launch(dev, c, heads):
    rng = np.random.default_rng(c)
    b, hw = 2, 24
    x = _f32(rng, (b, 4, 144, c), 1.0, dev)
    w = (_f32(rng, (3 * c, c), c ** -0.5, dev), _f32(rng, (3 * c,), 0.2, dev),
         _f32(rng, (c, c), c ** -0.5, dev), _f32(rng, (c,), 0.2, dev),
         _f32(rng, (heads, 144, 144), 1.0, dev))
    mask = shift_mask_2d(hw, hw, 12, 6, dev)
    flags = shift_mask_flags_2d(hw, hw, 12, 6, dev)
    _, (q, k, v, p, _) = fused_msa.fused_window_msa_save_f32(
        x, None, *w, mask, heads, SCALE, flags=flags)
    m = b * 4
    dattn = _f32(rng, (m * 144, c), 1.0, dev)
    groups = fused_msa.msa_bwd_f32_groups(m, heads, 3 * heads)  # 3 partials
    assert 1 < groups < m
    got = fused_msa.msa_bwd_attn_f32(dattn, q, k, v, p, heads, SCALE, groups)
    want = fused_msa.msa_bwd_attn_plain(dattn, q, k, v, p, heads, SCALE,
                                        groups)
    for g, wt in zip(got[:3], want[:3]):  # o, dqkv, the dbias partials
        _close(g, wt)
    _close(got[3].sum(0), want[3].sum(0))  # dbqkv (partials split apart)
    again = fused_msa.msa_bwd_attn_f32(dattn, q, k, v, p, heads, SCALE,
                                       groups)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(got, again))


def _msa_weights(rng, dev, c, heads, dtype):
    return [t.to(dtype) for t in (
        _f32(rng, (3 * c, c), c ** -0.5, dev), _f32(rng, (3 * c,), 0.2, dev),
        _f32(rng, (c, c), c ** -0.5, dev), _f32(rng, (c,), 0.2, dev))]


def test_f8_k2p_f32_is_exact_past_80(dev):
    rng = np.random.default_rng(81)
    c, heads, nw, nu = 96, 3, 6, 3
    x = _f32(rng, (1, nw, 392, c), 1.0, dev)
    w = _msa_weights(rng, dev, c, heads, torch.float32)
    bias = _f32(rng, (heads, 392, 392), 60.0, dev)
    mask = torch.from_numpy(np.where(rng.random((nw - nu, 392, 392)) > 0.7,
                                     -100.0, 0.0).astype(np.float32)).to(dev)
    args = (x, *w, bias, mask, nu, heads, SCALE)
    got = fused_msa.fused_window_msa_grouped(*args)
    exact = fused_msa.fused_window_msa_grouped_plain(*args)
    _close(got, exact)
    clamp = torch.cat([
        fused_msa.fused_window_msa_plain(x[:, :nu], *w, bias, None, heads,
                                         SCALE, exact=False),
        fused_msa.fused_window_msa_plain(x[:, nu:], *w, bias, mask, heads,
                                         SCALE, exact=False)], dim=1)
    assert (clamp - exact).abs().max().item() > 1e-2


def test_f8_bf16_k1_and_k11_are_exact_past_80(dev):
    rng = np.random.default_rng(82)
    c, heads, bf16 = 128, 4, torch.bfloat16
    w = _msa_weights(rng, dev, c, heads, bf16)
    bias = _f32(rng, (heads, 144, 144), 60.0, dev)
    mask = shift_mask_2d(24, 24, 12, 6, dev)
    x = _f32(rng, (2, 4, 144, c), 1.0, dev).to(bf16)
    ln = (_f32(rng, (c,), 0.2, dev).add(1.0).to(bf16),
          _f32(rng, (c,), 0.2, dev).to(bf16))
    got = fused_msa.fused_window_msa_ln(x, *ln, *w, bias, mask, heads, SCALE)
    exact = fused_msa.fused_window_msa_ln_plain(x, *ln, *w, bias, mask,
                                                heads, SCALE)
    clamp = fused_msa.fused_window_msa_ln_plain(
        x.float(), *(t.float() for t in (*ln, *w)), bias, mask, heads, SCALE,
        exact=False)
    _close(got, exact, TOL_BF16)
    assert (clamp - exact.float()).abs().max().item() > 1e-2
    xm = _f32(rng, (2, 36, 36, c), 1.0, dev).to(bf16)
    mask36 = shift_mask_2d(36, 36, 12, 6, dev)
    got = fused_msa_2d.fused_window_msa_2d(xm, *w, bias, mask36, heads, SCALE,
                                           12)
    exact = fused_msa_2d.fused_window_msa_2d_plain(xm, *w, bias, mask36,
                                                   heads, SCALE, 12)
    _close(got, exact, TOL_BF16)
