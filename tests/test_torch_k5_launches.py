"""K5's host side on the CPU: its launches and their glue.

K5 (the fused window-MSA backward from the save mode's residuals) runs on
the card as launches (`ops/fused_msa.bwd_launches`): dattn = gy Wproj on the
GEMM core (`msa_dgrad`), the attention launch (`msa_bwd_attn`: o, dqkv and
the dbias / dbqkv partials of its (group, head) blocks), dx = dqkv Wqkv
(`msa_dgrad`), the weight grads as split partials (K7's `fused_mlp.wgrad`,
split by `fused_mlp.wgrad_split_tiles`), the column
sums of gy (`colsum`) and `sum_partials`.  On CPU tensors each launch takes
its plain version, so the shapes, splits and partials around the kernels
run here:

* the plain launches compose to K5's plain version
  (`fused_window_msa_bwd_plain`) at window 12 (N = 144), with and without
  the shift mask, for one group and for groups that do not divide the
  windows;
* the composition equals the JAX package's residual backward
  (`_fused_bwd` on saved residuals, `_fused_bwd_group_resid` /
  `_bwd_kernel_resid` in Pallas interpret mode) from the JAX save mode's
  residuals;
* each dbias / dbqkv partial is its group's windows' sum, and the weight
  grads' split partials add up to the whole product.

Tolerances: f32 on both sides of the same math, summed in another order
(D as rowsum(do o) where the plain version takes rowsum(dP P)), so 1e-5
relative to each output's largest magnitude; against Pallas 2e-4, as
tests/test_torch_train_kernels_plain.py holds K5's plain version to it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from lavt_rs_tpu.ops.pallas import fused_msa as jmsa
from lavt_rs_tpu.ops.window import shift_mask_2d as jshift_mask_2d
from lavt_rs_tpu_torch.ops import fused_mlp, fused_msa

C, HEADS, HW, B = 64, 2, 24, 2
NAMES = ("dx", "dwqkv", "dbqkv", "dwproj", "dbproj", "dbias")


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))


def _close(got, want, tol, name=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * float(np.abs(want).max()),
                               err_msg=name)


def _inputs(rng, shift):
    f = np.float32
    nw = (HW // 12) ** 2
    return dict(
        x=rng.standard_normal((B, nw, 144, C)).astype(f),
        gy=rng.standard_normal((B, nw, 144, C)).astype(f),
        wqkv=(rng.standard_normal((C, 3 * C)) * C ** -0.5).astype(f),
        bqkv=(0.1 * rng.standard_normal(3 * C)).astype(f),
        wproj=(rng.standard_normal((C, C)) * C ** -0.5).astype(f),
        bproj=(0.1 * rng.standard_normal(C)).astype(f),
        bias=rng.standard_normal((HEADS, 144, 144)).astype(f),
        mask=jshift_mask_2d(HW, HW, 12, 6) if shift else None,
        scale=(C // HEADS) ** -0.5)


def _port(a):
    """x, gy, the torch-layout weights and the port's save-mode residuals."""
    x, gy = _t(a["x"]), _t(a["gy"])
    wqkv, wproj = _t(a["wqkv"].T), _t(a["wproj"].T)
    mask = None if a["mask"] is None else _t(a["mask"])
    _, (q, k, v, p, _) = fused_msa.fused_window_msa_save_plain(
        x, None, wqkv, _t(a["bqkv"]), wproj, _t(a["bproj"]), _t(a["bias"]),
        mask, HEADS, a["scale"])
    return x, gy, wqkv, wproj, (q, k, v, p)


@pytest.mark.parametrize("shift", [False, True])
@pytest.mark.parametrize("groups", [None, 1, 3])
def test_launches_compose_to_k5_plain(rng, shift, groups):
    a = _inputs(rng, shift)
    x, gy, wqkv, wproj, saved = _port(a)
    want = fused_msa.fused_window_msa_bwd_plain(x, gy, wqkv, wproj, saved,
                                                HEADS, a["scale"])
    got = fused_msa.bwd_launches(x, gy, wqkv, wproj, saved, HEADS,
                                 a["scale"], groups)
    for name, g, w in zip(NAMES, got, want):
        _close(g, w, 1e-5, name)


@pytest.mark.parametrize("shift", [False, True])
def test_launches_match_pallas_residual_backward(rng, shift):
    a = _inputs(rng, shift)
    mask = a["mask"]
    args = [jnp.asarray(a[k]) for k in ("x", "wqkv", "bqkv", "wproj",
                                        "bproj", "bias")]
    with pltpu.force_tpu_interpret_mode():
        _, saved = jmsa._fwd(*args, mask, HEADS, a["scale"], exact=True,
                             save=True)
        want = jmsa._fused_bwd(args[0], args[1], args[2], args[3], args[5],
                               mask, jnp.asarray(a["gy"]), HEADS, a["scale"],
                               saved=saved[:4])
    x, gy, wqkv, wproj, resid = _port(a)
    got = fused_msa.bwd_launches(x, gy, wqkv, wproj, resid, HEADS, a["scale"])
    for name, g, w in zip(NAMES, got, want):
        g = g.numpy()
        _close(g.T if name in ("dwqkv", "dwproj") else g, w, 2e-4, name)


def test_attention_partials_are_their_groups_sums(rng):
    a = _inputs(rng, True)
    x, gy, wqkv, wproj, (q, k, v, p) = _port(a)
    m = q.shape[0]
    dattn = fused_msa.msa_dgrad(gy.reshape(-1, C), wproj)
    o, dqkv, dbias_part, dbqkv_part = fused_msa.msa_bwd_attn(
        dattn, q, k, v, p, HEADS, a["scale"], 3)
    assert dbias_part.shape == (3, HEADS, 144, 144)
    assert dbqkv_part.shape == (3, 3 * C)
    for g in range(3):
        wins = list(range(g, m, 3))
        d_one = [fused_msa.msa_bwd_attn(
            dattn.view(m, 144, C)[w], q[w:w + 1], k[w:w + 1], v[w:w + 1],
            p[w:w + 1], HEADS, a["scale"], 1) for w in wins]
        _close(dbias_part[g], sum(d[2][0] for d in d_one), 1e-5, "dbias")
        _close(dbqkv_part[g], sum(d[3][0] for d in d_one), 1e-5, "dbqkv")
        for w, d in zip(wins, d_one):
            _close(dqkv.view(m, 144, 3 * C)[w], d[1], 1e-5, "dqkv")
            _close(o.view(m, 144, C)[w], d[0], 1e-5, "o")


@pytest.mark.parametrize("rows,na,nb", [(115200, 384, 128),
                                        (10368, 1536, 512),
                                        (4608, 3072, 1024),
                                        (2000, 288, 96)])
def test_wgrad_split_plan(rows, na, nb):
    """Splits of the weight-grad GEMMs: whole 64-row k-tiles, no empty
    split, f32 partials within their budget; the splits of a small product
    add up to aᵀ b."""
    sr = fused_mlp.wgrad_split_tiles(rows, na, nb) * fused_mlp.GEMM_DEPTH
    splits = -(-rows // sr)
    assert (splits - 1) * sr < rows
    assert splits == 1 or splits * na * nb * 4 <= fused_mlp._DW_PARTIAL_BYTES
    g = torch.Generator().manual_seed(0)
    a, b = torch.randn(300, 40, generator=g), torch.randn(300, 24, generator=g)
    part = fused_mlp.wgrad(a, b, 128)
    assert part.shape == (3, 40, 24)
    torch.testing.assert_close(fused_msa.sum_partials(part), a.t() @ b,
                               rtol=1e-5, atol=1e-5)


def test_groups_fill_the_card_once():
    """The attention launch's (groups, heads) grid at the bs-8 Swin-B
    shapes: one block per SM at most, no group without a window."""
    for m, heads, want in ((800, 4, 33), (200, 8, 16), (72, 16, 8),
                           (32, 32, 4)):
        g = fused_msa.msa_bwd_groups(m, heads)
        assert g == want and g * heads <= 132
    assert fused_msa.msa_bwd_groups(2, 4) == 2
