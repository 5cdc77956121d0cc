"""K4 (the row LayerNorm) and K4b (its backward in one pass) on the CPU:
the plain versions their wrappers take there against the JAX package's
`layer_norm_rows` custom_vjp and `fused_window_msa_ln` (Pallas in interpret
mode), the block partials of K4b's launch, its launch plan, and the
kernel plan's K4b count.

Tolerances: every output within 1e-4 relative to the largest magnitude of
the wanted tensor (f32 sums over rows and C taken in another order; the
MSA also through the softmax), as tests/test_torch_train_kernels_plain.py.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from lavt_rs_tpu.ops.pallas import fused_msa as jmsa
from lavt_rs_tpu.ops.pallas import ln as jln
from lavt_rs_tpu.ops.window import shift_mask_2d as jshift_mask_2d
from lavt_rs_tpu_torch.models.factory import build_model, make_config
from lavt_rs_tpu_torch.ops import fused_msa, ln
from torch_threads import torch_threads  # noqa: F401 (autouse fixture)

TOL = 1e-4
LN_CU = Path(ln.__file__).resolve().parent.parent / "csrc" / "ln.cu"


@pytest.fixture
def rng():
    return np.random.default_rng(14)


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


def _ln_inputs(rng, rows, c):
    f = np.float32
    return ((rng.standard_normal((rows, c)) * 2 + 0.5).astype(f),
            (1.0 + 0.2 * rng.standard_normal(c)).astype(f),
            (0.2 * rng.standard_normal(c)).astype(f),
            rng.standard_normal((rows, c)).astype(f))


@pytest.mark.parametrize("rows,c", [(48, 128), (40, 256), (16, 1536)])
def test_layer_norm_rows_matches_jax_vjp(rng, rows, c):
    x, s, b, gy = _ln_inputs(rng, rows, c)
    with pltpu.force_tpu_interpret_mode():
        y_j, vjp = jax.vjp(jln.layer_norm_rows, jnp.asarray(x),
                           jnp.asarray(s), jnp.asarray(b))
        want = vjp(jnp.asarray(gy))
    xs = [_t(x, True), _t(s, True), _t(b, True)]
    y = ln.LayerNormRows.apply(*xs, 1e-5)
    _close(y, y_j, "y")
    got = torch.autograd.grad(y, xs, _t(gy))
    for name, g, w in zip(("x", "scale", "bias"), got, want):
        _close(g, w, name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_norm_rows_bwd_on_cpu_is_the_plain_version(rng, dtype):
    x, s, _, gy = _ln_inputs(rng, 37, 96)
    x, g = _t(x).to(dtype), _t(gy).to(dtype)
    before = ln.layer_norm_rows_bwd.launches
    for fn in (ln.layer_norm_rows_bwd, ln.layer_norm_rows_bwd_launch):
        got = fn(x, _t(s), g)
        want = ln.layer_norm_rows_bwd_plain(x, _t(s), g)
        assert got[0].dtype == dtype
        for a, w in zip(got, want):
            assert torch.equal(a, w)
    assert ln.layer_norm_rows_bwd.launches == before


@pytest.mark.parametrize("rows,c,sms", [(1, 128, 132), (7, 96, 132),
                                        (1800, 1024, 132), (3000, 256, 4),
                                        (333, 1056, 2), (50, 4096, 132),
                                        (1155, 160, 3)])
def test_block_partials_add_up_to_the_plain_grads(rng, rows, c, sms):
    x, s, _, gy = _ln_inputs(rng, rows, c)
    x, sc, g = _t(x), _t(s), _t(gy)
    dx, part = ln.layer_norm_rows_bwd_partials_plain(x, sc, g, sms=sms)
    plan = ln.ln_rows_plan(rows, c, sms, bwd=True)
    assert part.shape == (plan["blocks"], 2, c) and part.dtype == torch.float32
    want = ln.layer_norm_rows_bwd_plain(x, sc, g)
    assert torch.equal(dx, want[0])
    sums = fused_msa.sum_partials(part)
    _close(sums[0], want[1].numpy(), "dscale")
    _close(sums[1], want[2].numpy(), "dbias")
    # the wrapper on a CPU tensor: the H100's plan
    assert ln.layer_norm_rows_bwd_partials(x, sc, g)[1].shape[0] == (
        ln.ln_rows_plan(rows, c, 132, bwd=True)["blocks"])


def _instantiated_layouts():
    """The (lanes, vecs, tail) row layouts csrc/ln.cu instantiates."""
    text = LN_CU.read_text()
    body = text[text.index("#define LAVT_LN_LAYOUTS"):]
    body = body[:body.index("\n\n")]
    return {(int(g), int(v), t == "true")
            for g, v, t in re.findall(r"X\((\d+), (\d+), (true|false)\)",
                                      body)}


@pytest.mark.parametrize("bwd", [False, True])
def test_launch_plan_covers_every_width(bwd):
    """For every width the kernels take, the plan's layout is one that
    csrc/ln.cu instantiates and its blocks cover the rows once."""
    layouts = _instantiated_layouts()
    assert len(layouts) == 14
    for c in range(32, 4097, 32):
        assert ln.layer_norm_rows_supported(1, c)
        for rows in (1, 7, 33, 1800, 115200):
            p = ln.ln_rows_plan(rows, c, 132, bwd)
            if c > 1024:
                assert p["lanes"] == 0 and p["per"] >= 1
            else:
                assert (p["lanes"], p["vecs"], p["tail"]) in layouts
                words = p["lanes"] * p["vecs"]
                assert words * 8 >= c if p["tail"] else words * 8 == c
                warps = 8 * (4 - min(p["vecs"], 3)) if bwd else 8
                assert p["per"] % (warps * 32 // p["lanes"]) == 0
                assert c > 256 or p["lanes"] <= 16 or p["tail"]
            assert (p["blocks"] - 1) * p["per"] < rows <= p["blocks"] * p["per"]
            assert p["blocks"] <= 132 * 5
    assert not ln.layer_norm_rows_supported(1, 4128)
    assert not ln.layer_norm_rows_supported(1, 80)


def _msa_inputs(rng, c, heads, hw):
    n = 144
    nw = (hw // 12) ** 2
    f = np.float32
    return dict(
        x=(rng.standard_normal((1, nw, n, c)) * 2 + 0.3).astype(f),
        ln_s=(1.0 + 0.1 * rng.standard_normal(c)).astype(f),
        ln_b=(0.1 * rng.standard_normal(c)).astype(f),
        wqkv=(rng.standard_normal((c, 3 * c)) * c ** -0.5).astype(f),
        bqkv=(0.1 * rng.standard_normal(3 * c)).astype(f),
        wproj=(rng.standard_normal((c, c)) * c ** -0.5).astype(f),
        bproj=(0.1 * rng.standard_normal(c)).astype(f),
        bias=rng.standard_normal((heads, n, n)).astype(f),
        gy=rng.standard_normal((1, nw, n, c)).astype(f),
        scale=(c // heads) ** -0.5)


@pytest.mark.parametrize("c,heads,shift", [(96, 3, True), (128, 4, False)])
def test_fused_window_msa_ln_backward_matches_jax(rng, c, heads, shift):
    """K1's LN backward (K4b's launch inside `FusedWindowMSA.backward`):
    dx, dls and dlb against JAX `fused_window_msa_ln`'s VJP."""
    hw = 24
    a = _msa_inputs(rng, c, heads, hw)
    mask = jshift_mask_2d(hw, hw, 12, 6) if shift else None
    keys = ("x", "ln_s", "ln_b", "wqkv", "bqkv", "wproj", "bproj", "bias")

    def f(*xs):
        return jmsa.fused_window_msa_ln(*xs, mask, heads, a["scale"])

    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(f, *(jnp.asarray(a[k]) for k in keys))
        want = vjp(jnp.asarray(a["gy"]))
    x, ln_s, ln_b = (_t(a[k], True) for k in ("x", "ln_s", "ln_b"))
    w = (_t(a["wqkv"].T), _t(a["bqkv"]), _t(a["wproj"].T), _t(a["bproj"]),
         _t(a["bias"]))
    y = fused_msa.FusedWindowMSA.apply(
        x, ln_s, ln_b, *w, None if mask is None else _t(mask), heads,
        a["scale"])
    got = torch.autograd.grad(y, (x, ln_s, ln_b), _t(a["gy"]))
    for name, g, wnt in zip(("x", "ln_s", "ln_b"), got, want):
        _close(g, wnt, name)


@pytest.mark.parametrize("window12", [True, False])
def test_kernel_plan_lists_k4b_per_stage_norm(window12):
    """Swin-B at 480², bs 8: K4b once per routed stage norm a step, none
    at inference."""
    cfg = make_config("lavt_one", swin_type="base", window12=window12)
    backbone = build_model(cfg, device="meta", train=True).backbone
    train = backbone.kernel_plan((480, 480), 8, 2, True)[0]
    infer = backbone.kernel_plan((480, 480), 8, 2)[0]
    assert train["K4b"] == train["K4"] == 4
    assert "K4b" not in infer
