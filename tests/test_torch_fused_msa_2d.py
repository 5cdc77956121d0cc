"""K11's plain version and the K11 route of a padded Swin block against the
JAX package, on the CPU.

`fused_window_msa_2d_plain` is held to the Pallas `fused_window_msa_2d`
(lavt_rs_tpu/ops/pallas/experimental.py) in interpret mode, and the
gradients of the port's `fused_window_msa_2d` (its autograd Function: the
backward is autograd through the plain version) to `jax.vjp` of the JAX
function, on a non-square map where a swapped window row and column or a
wrong mask index would show.  Same numpy inputs, f32 throughout; 1e-4 (f32
sums over C and N in another order, through softmax).

A padded, shifted SwinBlock of the small lavt_one of test_torch_model.py
(weights carried over by `convert/from_jax.py`) runs the K11 route under
no_grad; it is held to the JAX block at 1e-4 and to the port's own
partition route (autograd recording: partition, K2's Function, reverse),
which computes the same windows in the same order, exactly.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from lavt_rs_tpu.models import swin2d as jswin
from lavt_rs_tpu.ops.pallas import experimental as jexp
from lavt_rs_tpu_torch.ops import fused_msa_2d
from test_torch_model import SWIN, pair  # noqa: F401  (module fixture)

TOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))


def _inputs(rng, b, hp, wp, c, heads, ws):
    n = ws * ws
    nw = (hp // ws) * (wp // ws)
    f = np.float32
    return dict(
        x=rng.standard_normal((b, hp, wp, c)).astype(f),
        wqkv=(rng.standard_normal((c, 3 * c)) * c ** -0.5).astype(f),
        bqkv=(0.1 * rng.standard_normal(3 * c)).astype(f),
        wproj=(rng.standard_normal((c, c)) * c ** -0.5).astype(f),
        bproj=(0.1 * rng.standard_normal(c)).astype(f),
        bias=rng.standard_normal((heads, n, n)).astype(f),
        mask=np.where(rng.random((nw, n, n)) > 0.7, -100.0, 0.0).astype(f))


def _port_args(a, with_mask):
    """The port's argument order and torch layout (weights (out, in))."""
    return (_t(a["x"]), _t(a["wqkv"].T), _t(a["bqkv"]), _t(a["wproj"].T),
            _t(a["bproj"]), _t(a["bias"]), _t(a["mask"]) if with_mask else None)


def _jax_args(a, with_mask):
    return tuple(jnp.asarray(a[k]) for k in ("x", "wqkv", "bqkv", "wproj",
                                             "bproj", "bias")) + (
        jnp.asarray(a["mask"]) if with_mask else None,)


@pytest.mark.parametrize("with_mask", [False, True])
def test_plain_k11_matches_pallas_fused_window_msa_2d(with_mask):
    """Window 12, a 24 x 36 map (2 x 3 windows), 2 heads of 32."""
    rng = np.random.default_rng(11 + with_mask)
    c, heads, ws = 64, 2, 12
    a = _inputs(rng, 1, 24, 36, c, heads, ws)
    scale = (c // heads) ** -0.5
    with pltpu.force_tpu_interpret_mode():
        want = jexp.fused_window_msa_2d(*_jax_args(a, with_mask), heads,
                                        scale, ws)
    got = fused_msa_2d.fused_window_msa_2d(*_port_args(a, with_mask), heads,
                                           scale, ws)
    assert got.shape == (1, 24, 36, c)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_k11_gradients_match_jax_vjp():
    """Window 4 on an 8 x 12 map (2 x 3 windows), as the JAX test runs it;
    every input's gradient, the mask's too."""
    rng = np.random.default_rng(5)
    c, heads, ws = 32, 4, 4
    a = _inputs(rng, 2, 8, 12, c, heads, ws)
    scale = (c // heads) ** -0.5
    g = rng.standard_normal((2, 8, 12, c)).astype(np.float32)

    def f(*args):
        return jexp.fused_window_msa_2d(*args, heads, scale, ws)

    with pltpu.force_tpu_interpret_mode():
        want_y, vjp = jax.vjp(f, *_jax_args(a, True))
        want = vjp(jnp.asarray(g))
    leaves = [t.requires_grad_() for t in _port_args(a, True)]
    y = fused_msa_2d.fused_window_msa_2d(*leaves, heads, scale, ws)
    assert y.grad_fn is not None and "FusedWindowMSA2D" in type(y.grad_fn).__name__
    got = torch.autograd.grad(y, leaves, torch.from_numpy(g))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y),
                               rtol=TOL, atol=TOL)
    names = ("x", "wqkv", "bqkv", "wproj", "bproj", "bias", "mask")
    for name, gp, gj in zip(names, got, want):
        gj = np.asarray(gj)
        if name in ("wqkv", "wproj"):
            gj = gj.T  # JAX kernel (in, out) -> torch (out, in)
        np.testing.assert_allclose(gp.numpy(), gj, rtol=TOL, atol=TOL,
                                   err_msg=name)


def test_k11_without_grad_needs_no_function():
    rng = np.random.default_rng(6)
    a = _inputs(rng, 1, 8, 8, 16, 2, 4)
    y = fused_msa_2d.fused_window_msa_2d(*_port_args(a, False), 2, 0.25, 4)
    assert y.grad_fn is None
    assert fused_msa_2d.fused_window_msa_2d.launches == 0  # CPU: no kernel


@pytest.mark.parametrize("hw", [(6, 6), (18, 30)])
def test_padded_swin_block_k11_route(pair, hw):  # noqa: F811
    """layers_2.blocks_1 (C 192, 12 heads, window 12, shift 6) on a map
    that pads: 6 x 6 -> 12 x 12 (one window) and 18 x 30 -> 24 x 36 (2 x 3
    windows, non-square)."""
    _, _, variables, pm = pair
    c, heads = 4 * SWIN["embed_dim"], SWIN["num_heads"][2]
    x = np.random.default_rng(hw[1]).standard_normal((2, hw[0] * hw[1], c)
                                                     ).astype(np.float32)
    jblock = jswin.SwinBlock(dim=c, num_heads=heads, window_size=12,
                             shift_size=6)
    params = variables["params"]["backbone"]["layers_2"]["blocks_1"]
    want = jblock.apply({"params": params}, jnp.asarray(x), hw)
    block = pm.backbone.layers[2].blocks[1]
    plain_2d = fused_msa_2d.fused_window_msa_2d_plain
    with mock.patch.object(fused_msa_2d, "fused_window_msa_2d_plain",
                           wraps=plain_2d) as k11:
        with torch.no_grad():
            got = block(torch.from_numpy(x), hw)
            # the K11 route in the taped route's (exact) softmax form: K11
            # f32 itself takes exp(min(s, 80)) (`fused_msa.softmax_form`)
            with mock.patch.object(fused_msa_2d, "softmax_form",
                                   lambda t, e: True):
                got_exact = block(torch.from_numpy(x), hw)
        assert k11.call_count == 2  # the K11 route
        partition = block(torch.from_numpy(x), hw)  # autograd records
        assert k11.call_count == 2  # the partition route
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    torch.testing.assert_close(got_exact, partition.detach(), rtol=0, atol=0)
