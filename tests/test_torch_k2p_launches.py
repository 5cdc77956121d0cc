"""K2p's host side on the CPU: its three launches and their glue.

K2p (the fused window MSA on sublane-padded, mask-grouped windows) runs on
the card as three launches (`ops/fused_msa.grouped_launches`): the qkv
projection on the GEMM core (`gemm_bias`, q scaled after its bias), K10's
kernel on strided views of its output with the windows grouped by mask
(`window_attn.attention_qkv_grouped`, scale 1), and the out-projection on
the GEMM core.  On CPU tensors each launch takes its plain version, so the
views, strides and mask grouping around the kernels run here:

* the three plain launches compose to K2p's plain version
  (`fused_window_msa_grouped_plain`, K2's plain version on the maskless
  prefix and on the masked rest) at the video stage-1 token counts (392
  padded to 400; a 4-frame clip's 196 padded to 208) and at 49 padded to
  64, for every grouping: nu maskless windows then the small mask, nu = 0
  under the full mask, nu = nW without a mask and with an empty one;
* `gemm_bias`'s plain version scales only the first `scaled` columns, after
  the bias;
* the grouped attention equals K10's plain version under the full mask
  (zeros on the first nu windows);
* the composition equals the JAX package's `fused_window_msa_padded` on
  its Pallas kernel in interpret mode, through the port's padded wrapper's
  arithmetic (x, bias and mask padded, nu = 0).

Tolerances: f32 on both sides of the same math, the products batched
otherwise, so 1e-5 abs + rel; against Pallas 2e-4 abs + rel, as
tests/test_torch_video.py holds K2p's plain version to it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from lavt_rs_tpu.ops.pallas import fused_msa as jfused
from lavt_rs_tpu_torch.ops import fused_msa, window_attn
from lavt_rs_tpu_torch.ops.window import partition_3d_groups

HEADS = 2


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _weights(rng, c):
    return [_t(a.astype(np.float32)) for a in (
        rng.standard_normal((3 * c, c)) * c ** -0.5,
        rng.standard_normal((3 * c,)) * 0.2,
        rng.standard_normal((c, c)) * c ** -0.5,
        rng.standard_normal((c,)) * 0.2)]


def _inputs(rng, nw, n, n_p, c=64, b=1):
    x = rng.standard_normal((b, nw, n_p, c)).astype(np.float32)
    x[:, :, n:] = 0
    bias = _t(rng.standard_normal((HEADS, n, n)).astype(np.float32))
    return _t(x), fused_msa.pad_bias_sublane(bias, n_p)


def _mask(rng, windows, n, n_p):
    m = np.zeros((windows, n_p, n_p), np.float32)
    m[:, :n, :n] = np.where(rng.random((windows, n, n)) > 0.7, -100.0, 0.0)
    return _t(m)


# (N, windows per image, nu, grouping): "small" nu maskless windows, then
# the small mask; "full" nu = 0 under the full mask; "none" no mask;
# "empty" nu = nW and a mask of no windows
CASES = [(392, 6, 4, "small"), (392, 6, 0, "full"), (392, 6, 6, "none"),
         (392, 6, 6, "empty"), (196, 5, 2, "small"), (49, 7, 3, "small"),
         (49, 7, 0, "full")]


@pytest.mark.parametrize("n,nw,nu,grouping", CASES)
def test_launches_compose_to_k2p_plain(n, nw, nu, grouping):
    rng = np.random.default_rng(n + nw + nu)
    n_p = fused_msa.pad_tokens(n)
    x, bias = _inputs(rng, nw, n, n_p, b=2)
    mask = {"small": lambda: _mask(rng, nw - nu, n, n_p),
            "full": lambda: _mask(rng, nw, n, n_p),
            "none": lambda: None,
            "empty": lambda: torch.zeros((0, n_p, n_p))}[grouping]()
    args = (x, *_weights(rng, 64), bias, mask, nu, HEADS, 32 ** -0.5)
    want = fused_msa.fused_window_msa_grouped_plain(*args)
    got = fused_msa.grouped_launches(*args)
    assert got.shape == x.shape
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    # on a CPU tensor the wrapper takes K2p's plain version
    torch.testing.assert_close(fused_msa.fused_window_msa_grouped(*args), want,
                               rtol=0, atol=0)


def test_gemm_bias_plain_scales_the_first_columns_after_the_bias():
    rng = np.random.default_rng(1)
    x2, w, b = (_t(rng.standard_normal(s).astype(np.float32))
                for s in ((5, 32), (96, 32), (96,)))
    y = fused_msa.gemm_bias(x2, w, b, 32, 0.25)
    full = x2 @ w.t() + b
    torch.testing.assert_close(y[:, :32], full[:, :32] * 0.25)
    torch.testing.assert_close(y[:, 32:], full[:, 32:])
    # bf16 in, rounded once from f32
    y16 = fused_msa.gemm_bias(x2.bfloat16(), w.bfloat16(), b.bfloat16(), 32,
                              0.25)
    want = x2.bfloat16().float() @ w.bfloat16().float().t() + \
        b.bfloat16().float()
    want[:, :32] *= 0.25
    assert y16.dtype == torch.bfloat16
    assert torch.equal(y16, want.bfloat16())


@pytest.mark.parametrize("nu", [0, 3, 5])
def test_grouped_attention_is_k10_under_the_full_mask(nu):
    rng = np.random.default_rng(nu)
    b, nw, n = 2, 5, 64
    qkv = _t(rng.standard_normal((b, nw, n, 3 * HEADS * 32))
             .astype(np.float32))
    bias = _t(rng.standard_normal((HEADS, n, n)).astype(np.float32))
    small = _mask(rng, nw - nu, n, n) if nu < nw else None
    full = (torch.cat([torch.zeros((nu, n, n)), small]) if small is not None
            else None)
    want = window_attn.window_attention_qkv_plain(qkv, bias, full, HEADS, 0.3)
    got = window_attn.attention_qkv_grouped(qkv, bias, small, nu, HEADS, 0.3)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    with pytest.raises(ValueError):
        window_attn.attention_qkv_grouped(qkv, bias, small, nw + 1, HEADS, 0.3)


def test_shifted_stage1_grouping_composes():
    """The stage-1 grouping of a 4-frame clip's shifted block (196 tokens
    padded to 208, windows unmasked-first, the small mask from
    `partition_3d_groups`), cut to its first and last windows."""
    rng = np.random.default_rng(5)
    nu, mask = partition_3d_groups(4, 28, 28, 4, 28, 28, (4, 7, 7), (0, 3, 3),
                                   208, "cpu")
    nw = nu + mask.shape[0]
    assert 0 < nu < nw
    keep = list(range(2)) + list(range(nu, nw))
    x, bias = _inputs(rng, len(keep), 196, 208)
    args = (x, *_weights(rng, 64), bias, mask, 2, HEADS, 32 ** -0.5)
    torch.testing.assert_close(fused_msa.grouped_launches(*args),
                               fused_msa.fused_window_msa_grouped_plain(*args),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_launches_match_the_pallas_kernel(masked):
    """The launches on the padded wrapper's inputs (N = 49 -> 64, nu = 0
    with the full mask) against the JAX `fused_window_msa_padded` on its
    Pallas kernel in interpret mode."""
    rng = np.random.default_rng(11 + masked)
    b, nw, n, c = 1, 4, 49, 64
    x = rng.standard_normal((b, nw, n, c)).astype(np.float32)
    bias = rng.standard_normal((HEADS, n, n)).astype(np.float32)
    mask = (np.where(rng.random((nw, n, n)) > 0.7, -100.0, 0.0)
            .astype(np.float32) if masked else None)
    tw = _weights(rng, c)
    scale = 32 ** -0.5
    with pltpu.force_tpu_interpret_mode():
        want = jfused.fused_window_msa_padded(
            jnp.asarray(x), jnp.asarray(tw[0].numpy().T), jnp.asarray(tw[1]),
            jnp.asarray(tw[2].numpy().T), jnp.asarray(tw[3]),
            jnp.asarray(bias), None if mask is None else jnp.asarray(mask),
            HEADS, scale)
    n_p = fused_msa.pad_tokens(n)
    xp = torch.nn.functional.pad(_t(x), (0, 0, 0, n_p - n))
    mp = (None if mask is None
          else torch.nn.functional.pad(_t(mask), (0, n_p - n, 0, n_p - n)))
    got = fused_msa.grouped_launches(
        xp, *tw, fused_msa.pad_bias_sublane(_t(bias), n_p), mp,
        0 if masked else nw, HEADS, scale)[:, :, :n]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
