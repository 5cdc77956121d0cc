"""Plain versions of the port's training kernels (K1/K2 save mode, K5, K6,
K7, K8, and K4's backward) against the Pallas kernels they replace, on the
CPU with Pallas in interpret mode.

Window 12 (N = 144), head dim 32, a few windows, with and without the
shift mask; the same numpy inputs in f32 throughout.  The JAX weights are
(in, out) where the port's are torch (out, in): they are transposed on the
way in and the weight grads on the way out.  The port's backward runs
through its autograd Functions (`FusedWindowMSA`, `FusedLnMlp`,
`LayerNormRows`), which on CPU tensors take the plain versions.

Tolerances: every output within 1e-4 relative to the largest magnitude of
the wanted tensor (f32 sums over rows, C and N taken in another order;
the MSA also through the softmax).  The Pallas GELU is an erf polynomial
within 1.5e-7 of the erf the port uses.
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

TOL = 1e-4


def _t(a, grad=False):
    t = torch.from_numpy(np.array(a, dtype=np.float32, order="C"))
    return t.requires_grad_(grad)


def _close(got, want, name=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=TOL,
                               atol=TOL * float(np.abs(want).max()),
                               err_msg=name)


def _msa_inputs(rng, c, heads, hw, b=1):
    n = 144
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
        gy=rng.standard_normal((b, nw, n, c)).astype(f),
        scale=(c // heads) ** -0.5)


def _mask(hw, shift):
    return jshift_mask_2d(hw, hw, 12, 6) if shift else None


def _port_weights(a, grad=False):
    return (_t(a["wqkv"].T, grad), _t(a["bqkv"], grad), _t(a["wproj"].T, grad),
            _t(a["bproj"], grad), _t(a["bias"], grad))


@pytest.mark.parametrize("with_ln,shift", [(True, False), (False, True)])
def test_plain_save_mode_matches_pallas_save(rng, with_ln, shift):
    c, heads, hw = 64, 2, 24
    a = _msa_inputs(rng, c, heads, hw)
    mask = _mask(hw, shift)
    ln_j = (jnp.asarray(a["ln_s"]), jnp.asarray(a["ln_b"])) if with_ln else None
    with pltpu.force_tpu_interpret_mode():
        out, saved = jmsa._fwd(
            *(jnp.asarray(a[k]) for k in ("x", "wqkv", "bqkv", "wproj",
                                          "bproj", "bias")),
            mask, heads, a["scale"], ln=ln_j, exact=True, save=True)
    ln_t = (_t(a["ln_s"]), _t(a["ln_b"])) if with_ln else None
    wqkv, bqkv, wproj, bproj, bias = _port_weights(a)
    y, got = fused_msa.fused_window_msa_save(
        _t(a["x"]), ln_t, wqkv, bqkv, wproj, bproj, bias,
        None if mask is None else _t(mask), heads, a["scale"])
    _close(y, out, "y")
    for name, g, w in zip(("q", "k", "v", "p", "xn"), got, saved):
        _close(g, w, name)
    assert (got[4] is None) == (not with_ln)


def _msa_vjp(a, heads, mask, with_ln):
    """JAX: vjp of fused_window_msa(_ln) on its residual route (K5)."""
    keys = ("x",) + (("ln_s", "ln_b") if with_ln else ()) + (
        "wqkv", "bqkv", "wproj", "bproj", "bias")
    args = [jnp.asarray(a[k]) for k in keys]

    def f(*xs):
        if with_ln:
            return jmsa.fused_window_msa_ln(*xs, mask, heads, a["scale"])
        return jmsa.fused_window_msa(*xs, mask, heads, a["scale"])

    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(f, *args)
        grads = vjp(jnp.asarray(a["gy"]))
    return dict(zip(keys, grads))


@pytest.mark.parametrize("with_ln,shift", [(True, False), (True, True),
                                           (False, True)])
def test_plain_k5_matches_pallas_residual_backward(rng, with_ln, shift):
    c, heads, hw = 64, 2, 24
    a = _msa_inputs(rng, c, heads, hw, b=2)
    mask = _mask(hw, shift)
    b, nw, n = a["x"].shape[:3]
    # both sides on the residual route (the port's K5, the TPU's resid)
    assert fused_msa.save_residuals_ok(b, nw, n, c, heads, 4)
    assert jmsa._save_residuals_ok(b, nw, n, c, heads, 4)
    want = _msa_vjp(a, heads, mask, with_ln)
    x = _t(a["x"], True)
    ln_s, ln_b = (_t(a["ln_s"], True), _t(a["ln_b"], True)) if with_ln else (
        None, None)
    w = _port_weights(a, True)
    y = fused_msa.FusedWindowMSA.apply(
        x, ln_s, ln_b, *w, None if mask is None else _t(mask), heads,
        a["scale"])
    inputs = [x, *w] + ([ln_s, ln_b] if with_ln else [])
    got = torch.autograd.grad(y, inputs, _t(a["gy"]))
    names = ["x", "wqkv", "bqkv", "wproj", "bproj", "bias"] + (
        ["ln_s", "ln_b"] if with_ln else [])
    for name, g in zip(names, got):
        g = g.detach().numpy()
        _close(g.T if name in ("wqkv", "wproj") else g, want[name], name)


@pytest.mark.parametrize("shift", [False, True])
def test_plain_k6_matches_pallas_recompute_backward(rng, shift):
    c, heads, hw = 96, 3, 24
    a = _msa_inputs(rng, c, heads, hw)
    mask = _mask(hw, shift)
    with pltpu.force_tpu_interpret_mode():
        want = jmsa._fused_bwd(
            *(jnp.asarray(a[k]) for k in ("x", "wqkv", "bqkv", "wproj",
                                          "bias")),
            mask, jnp.asarray(a["gy"]), heads, a["scale"], saved=None)
    wqkv, bqkv, wproj, bproj, bias = _port_weights(a)
    got = fused_msa.fused_window_msa_bwd_recompute(
        _t(a["x"]), None, wqkv, bqkv, wproj, bproj, bias,
        None if mask is None else _t(mask), _t(a["gy"]), heads, a["scale"])
    for name, g, w in zip(("dx", "dwqkv", "dbqkv", "dwproj", "dbproj",
                           "dbias"), got, want):
        g = g.numpy()
        _close(g.T if name in ("dwqkv", "dwproj") else g, w, name)


def test_k6_route_matches_k5_route_with_ln(rng, monkeypatch):
    """Past the residual cap the Function recomputes (K6, LN included) and
    gives K5's gradients."""
    c, heads, hw = 64, 2, 24
    a = _msa_inputs(rng, c, heads, hw)
    mask = _t(_mask(hw, True))

    def grads():
        x = _t(a["x"], True)
        lns, lnb = _t(a["ln_s"], True), _t(a["ln_b"], True)
        w = _port_weights(a, True)
        y = fused_msa.FusedWindowMSA.apply(x, lns, lnb, *w, mask, heads,
                                           a["scale"])
        return torch.autograd.grad(y, [x, lns, lnb, *w], _t(a["gy"]))

    resid = grads()
    monkeypatch.setattr(fused_msa, "RESID_CAP_BYTES", 0)
    before = fused_msa.fused_window_msa_bwd.launches
    recompute = grads()
    assert fused_msa.fused_window_msa_bwd.launches == before  # CPU: no launch
    for g, w in zip(recompute, resid):
        _close(g, w.numpy())


def _mlp_inputs(rng, m, c):
    f = np.float32
    hidden = 4 * c
    return dict(
        x=(rng.standard_normal((m, c)) * 2 + 0.5).astype(f),
        g=(1.0 + 0.1 * rng.standard_normal(c)).astype(f),
        be=(0.1 * rng.standard_normal(c)).astype(f),
        w1=(rng.standard_normal((c, hidden)) * c ** -0.5).astype(f),
        b1=(0.1 * rng.standard_normal(hidden)).astype(f),
        w2=(rng.standard_normal((hidden, c)) * hidden ** -0.5).astype(f),
        b2=(0.1 * rng.standard_normal(c)).astype(f),
        gy=rng.standard_normal((m, c)).astype(f))


_MLP_KEYS = ("x", "g", "be", "w1", "b1", "w2", "b2")


def _mlp_port(a, keep, rows):
    xs = [_t(a[k].T if k in ("w1", "w2") else a[k], True) for k in _MLP_KEYS]
    y = fused_mlp.FusedLnMlp.apply(*xs, keep, rows)
    grads = torch.autograd.grad(y, xs, _t(a["gy"]))
    return y, [g.numpy().T if k in ("w1", "w2") else g.numpy()
               for k, g in zip(_MLP_KEYS, grads)]


@pytest.mark.parametrize("m,c,hsplit", [(64, 128, False), (32, 512, True)])
def test_plain_k7_matches_pallas_mlp_backward(rng, monkeypatch, m, c, hsplit):
    """K7 against the vjp of fused_ln_mlp: at C = 128 on `_bwd`, at 512 on
    `_bwd_hsplit` (two hidden groups)."""
    if hsplit:
        monkeypatch.setattr(jmlp, "fused_ln_mlp_bwd_supported",
                            lambda *a, **k: False)
        monkeypatch.setattr(jmlp, "_pick_hidden_groups", lambda *a, **k: 2)
    else:
        assert jmlp.fused_ln_mlp_bwd_supported(m, c, 4 * c, 4)
    a = _mlp_inputs(rng, m, c)
    with pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(jmlp.fused_ln_mlp,
                           *(jnp.asarray(a[k]) for k in _MLP_KEYS))
        want = vjp(jnp.asarray(a["gy"]))
    y, got = _mlp_port(a, None, 0)
    _close(y, out, "y")
    for k, g, w in zip(_MLP_KEYS, got, want):
        _close(g, w, k)


def test_plain_k8_and_k7_with_keep_match_pallas_droppath(rng):
    b, rows, c = 3, 16, 128
    a = _mlp_inputs(rng, b * rows, c)
    keep = np.asarray([1.0 / 0.7, 0.0, 1.0 / 0.7], np.float32)
    with pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(
            lambda *xs: jmlp.fused_ln_mlp_droppath(*xs, jnp.asarray(keep),
                                                   rows),
            *(jnp.asarray(a[k]) for k in _MLP_KEYS))
        want = vjp(jnp.asarray(a["gy"]))
    y, got = _mlp_port(a, _t(keep), rows)
    _close(y, out, "y")
    for k, g, w in zip(_MLP_KEYS, got, want):
        _close(g, w, k)
    # the dropped sample's branch is zero: its rows pass x unchanged
    np.testing.assert_array_equal(y[rows:2 * rows].detach().numpy(),
                                  a["x"][rows:2 * rows])


@pytest.mark.parametrize("rows,c", [(64, 128), (24, 1024)])
def test_plain_k4_backward_matches_layer_norm_rows_vjp(rng, rows, c):
    f = np.float32
    x = (rng.standard_normal((rows, c)) * 3 + 1).astype(f)
    s = (1.0 + 0.1 * rng.standard_normal(c)).astype(f)
    b = (0.1 * rng.standard_normal(c)).astype(f)
    gy = rng.standard_normal((rows, c)).astype(f)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(jln.layer_norm_rows, jnp.asarray(x), jnp.asarray(s),
                         jnp.asarray(b))
        want = vjp(jnp.asarray(gy))
    xs = [_t(x, True), _t(s, True), _t(b, True)]
    y = ln.LayerNormRows.apply(*xs, 1e-5)
    got = torch.autograd.grad(y, xs, _t(gy))
    for name, g, w in zip(("x", "scale", "bias"), got, want):
        _close(g, w, name)
