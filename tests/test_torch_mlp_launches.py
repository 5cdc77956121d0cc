"""The launches of the LN-MLP tail kernels (K3/K8: LN rows, fc1 + GELU,
fc2 + residual; K7: prep, dual GEMM, weight grads, dyln, LN backward), on
the CPU through their plain versions.

* Composed, the per-launch plain versions equal `fused_ln_mlp_plain`,
  `fused_ln_mlp_droppath_plain` and `fused_ln_mlp_bwd_plain`: the same
  bf16 rounding points (bf16 inputs and intermediates, f32 math), so the
  outputs agree to f32 summation order: 1e-6 relative to the largest
  magnitude (the partial sums over 128-row tiles, 64-row blocks and row
  splits are added in another order than one sum over all rows).
* One case of each against the JAX Pallas kernels in interpret mode (f32
  inputs; tolerances as tests/test_torch_train_kernels_plain.py: 1e-5
  for the forward, 1e-4 for the grads, the Pallas GELU being an erf
  polynomial within 1.5e-7 of erf).
* The launch plan (`bwd_plan`, `bwd_buffers`): row tiles, the split over
  M of the weight grads under `_DW_PARTIAL_BYTES`, and the buffer shapes
  cut from the workspaces, without a card or nvcc (the meta device).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from lavt_rs_tpu.ops.pallas import fused_mlp as jmlp
from lavt_rs_tpu_torch.ops import fused_mlp as fm
from torch_threads import torch_threads  # noqa: F401 (autouse fixture)

TOL = 1e-6
SHAPES = [(m, c) for m in (1, 37, 250) for c in (128, 384)]
# (M, C, rows per sample of keep)
KEEP_CASES = [(m, c, 1) for m in (1, 37) for c in (128, 384)] + [
    (250, 128, 25), (250, 384, 25), (250, 384, 1)]


def _inputs(m, c, dtype=torch.bfloat16, seed=0):
    rng = np.random.default_rng(seed + m + c)
    hidden = 4 * c

    def t(shape, std=1.0, mean=0.0):
        a = rng.standard_normal(shape) * std + mean
        return torch.from_numpy(a.astype(np.float32)).to(dtype)

    return dict(x=t((m, c), 2.0, 0.5), g=t((c,), 0.1, 1.0), be=t((c,), 0.1),
                w1=t((hidden, c), c ** -0.5), b1=t((hidden,), 0.1),
                w2=t((c, hidden), hidden ** -0.5), b2=t((c,), 0.1),
                gy=t((m, c)))


def _keep(m, rows):
    b = m // rows
    return torch.where(torch.arange(b) % 3 == 1, 0.0, 1.0 / 0.7).float()


def _params(a):
    return tuple(a[k] for k in ("x", "g", "be", "w1", "b1", "w2", "b2"))


def _close(got, want, tol=TOL, name=""):
    got, want = np.asarray(got.float()), np.asarray(want.float())
    assert got.shape == want.shape, (name, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * float(np.abs(want).max()),
                               err_msg=name)


def _fwd_composed(x, g, be, w1, b1, w2, b2, keep=None, rows=1):
    xn = fm.mlp_ln_rows(x, g, be)
    h = fm.gemm_bias_gelu(xn, w1, b1)
    return fm.gemm_residual(h, w2, b2, x, keep, rows)


def _bwd_composed(x, gy, g, be, w1, b1, w2, keep=None, rows=1):
    """K7's launches in order, their partials summed over the first axis."""
    m, c = x.shape
    plan = fm.bwd_plan(m, c, w1.shape[0])
    xn, stats, dmlp = fm.mlp_bwd_prep(x, gy, g, be, keep, rows)
    h, dhpre, db1_part = fm.dual_gemm_gelu_bwd(xn, dmlp, w1, b1, w2)
    dw2_part = fm.wgrad(dmlp, h, plan.split_rows)
    dw1_part = fm.wgrad(dhpre, xn, plan.split_rows)
    dyln = fm.dgrad(dhpre, w1)
    dx, ln_part = fm.ln_bwd_rows(dyln, x, gy, g, stats, keep, rows)
    buf = fm.bwd_buffers(m, c, w1.shape[0], "meta")
    for name, part in (("db1_part", db1_part), ("ln_part", ln_part),
                       ("dyln", dyln), ("stats", stats), ("h", h),
                       ("dhpre", dhpre), ("xn", xn), ("dmlp", dmlp)):
        assert part.shape == buf[name].shape, name
    assert dw1_part.shape[0] == dw2_part.shape[0] == buf["dw_part"].shape[0]
    dg, dbe, db2 = ln_part.sum(0)
    return (dx, dg, dbe, dw1_part.sum(0), db1_part.sum(0), dw2_part.sum(0),
            db2)


@pytest.mark.parametrize("m,c", SHAPES)
def test_forward_launches_compose_to_k3(m, c):
    a = _inputs(m, c)
    _close(_fwd_composed(*_params(a)), fm.fused_ln_mlp_plain(*_params(a)))


@pytest.mark.parametrize("m,c,rows", KEEP_CASES)
def test_forward_launches_compose_to_k8(m, c, rows):
    a = _inputs(m, c)
    keep = _keep(m, rows)
    got = _fwd_composed(*_params(a), keep, rows)
    want = fm.fused_ln_mlp_droppath_plain(*_params(a), keep, rows)
    _close(got, want)
    # a dropped sample's rows pass x through
    dropped = keep.repeat_interleave(rows) == 0
    assert torch.equal(got[dropped], a["x"][dropped])


@pytest.mark.parametrize("m,c,rows,drop",
                         [(m, c, 1, False) for m, c in SHAPES]
                         + [(m, c, rows, True) for m, c, rows in KEEP_CASES])
def test_backward_launches_compose_to_k7(m, c, rows, drop):
    a = _inputs(m, c)
    keep = _keep(m, rows) if drop else None
    args = (a["x"], a["gy"], a["g"], a["be"], a["w1"], a["b1"], a["w2"],
            keep, rows)
    got = _bwd_composed(*args)
    want = fm.fused_ln_mlp_bwd_plain(*args)
    for name, g_, w_ in zip(("dx", "dg", "dbe", "dw1", "db1", "dw2", "db2"),
                            got, want):
        _close(g_, w_, name=name)


def test_launches_take_the_plain_version_on_the_cpu():
    a = _inputs(37, 128)
    before = (fm.fused_ln_mlp.launches, fm.fused_ln_mlp_bwd.launches)
    xn = fm.mlp_ln_rows(a["x"], a["g"], a["be"])
    assert torch.equal(xn, fm.mlp_ln_rows_plain(a["x"], a["g"], a["be"]))
    assert xn.dtype == torch.bfloat16
    assert (fm.fused_ln_mlp.launches, fm.fused_ln_mlp_bwd.launches) == before


# -- against the Pallas kernels (interpret mode) ------------------------------

def _jax_params(a):
    return tuple(jnp.asarray(np.asarray(a[k].T if k in ("w1", "w2") else a[k]))
                 for k in ("x", "g", "be", "w1", "b1", "w2", "b2"))


def test_forward_launches_match_pallas_fused_ln_mlp():
    a = _inputs(64, 128, torch.float32)
    with pltpu.force_tpu_interpret_mode():
        want = jmlp.fused_ln_mlp(*_jax_params(a))
    _close(_fwd_composed(*_params(a)), torch.from_numpy(np.array(want)),
           1e-5)


def test_forward_launches_match_pallas_droppath():
    rows, c = 16, 128
    a = _inputs(3 * rows, c, torch.float32)
    keep = _keep(3 * rows, rows)
    with pltpu.force_tpu_interpret_mode():
        want = jmlp.fused_ln_mlp_droppath(*_jax_params(a),
                                          jnp.asarray(keep.numpy()), rows)
    _close(_fwd_composed(*_params(a), keep, rows),
           torch.from_numpy(np.array(want)), 1e-5)


@pytest.mark.parametrize("drop", [False, True])
def test_backward_launches_match_pallas_vjp(drop):
    rows, c = 16, 128
    m = 3 * rows
    a = _inputs(m, c, torch.float32)
    keep = _keep(m, rows) if drop else None
    with pltpu.force_tpu_interpret_mode():
        if drop:
            fn = lambda *xs: jmlp.fused_ln_mlp_droppath(  # noqa: E731
                *xs, jnp.asarray(keep.numpy()), rows)
        else:
            fn = jmlp.fused_ln_mlp
        _, vjp = jax.vjp(fn, *_jax_params(a))
        want = vjp(jnp.asarray(a["gy"].numpy()))
    dx, dg, dbe, dw1, db1, dw2, db2 = _bwd_composed(
        a["x"], a["gy"], a["g"], a["be"], a["w1"], a["b1"], a["w2"], keep,
        rows)
    got = (dx, dg, dbe, dw1.t(), db1, dw2.t(), db2)  # JAX weights are (in, out)
    for name, g_, w_ in zip(("dx", "dg", "dbe", "dw1", "db1", "dw2", "db2"),
                            got, want):
        _close(g_, torch.from_numpy(np.array(w_)), 1e-4, name)


# -- the launch plan ----------------------------------------------------------

# (M, C) at bs 8 and bs 16 on the main paths, and ragged M
PLAN_SHAPES = ([(115200, 128), (28800, 256), (7200, 384), (7200, 512),
                (1800, 1024)]
               + [(230400, 128), (3600, 1024)]
               + [(m, c) for m in (1, 37, 1807) for c in (128, 1024)])


@pytest.mark.parametrize("m,c", PLAN_SHAPES)
def test_bwd_plan_splits_the_rows_within_the_partial_budget(m, c):
    hidden = 4 * c
    plan = fm.bwd_plan(m, c, hidden)
    k_tiles = -(-m // fm.GEMM_DEPTH)
    assert plan.row_tiles == -(-m // fm.DUAL_ROWS)
    assert plan.ln_blocks == -(-m // fm.LN_BWD_ROWS)
    # every row in exactly one split, no split empty
    assert plan.split_rows == plan.split_tiles * fm.GEMM_DEPTH
    assert plan.splits * plan.split_tiles >= k_tiles
    assert (plan.splits - 1) * plan.split_tiles < k_tiles
    assert len(range(0, m, plan.split_rows)) == plan.splits
    # the f32 partials of dW1 + dW2 fit the budget (one split always runs)
    assert plan.splits == 1 or (plan.splits * 8 * hidden * c
                                <= fm._DW_PARTIAL_BYTES)
    # enough blocks for the SMs unless the rows or the budget run out
    blocks = plan.splits * (hidden // fm.GEMM_TILE) * (c // fm.GEMM_TILE)
    assert (blocks >= fm._SMS or plan.split_tiles == 1
            or (plan.splits + 1) * 8 * hidden * c > fm._DW_PARTIAL_BYTES)
    buf = fm.bwd_buffers(m, c, hidden, "meta")
    assert buf["dw_part"].shape == (plan.splits, 2, hidden * c)
    assert buf["db1_part"].shape == (plan.row_tiles, hidden)
    assert buf["ln_part"].shape == (plan.ln_blocks, 3, c)
    assert buf["h"].shape == buf["dhpre"].shape == (m, hidden)
    assert buf["dyln"].dtype == buf["stats"].dtype == torch.float32
    assert list(buf) == ["xn", "dmlp", "h", "dhpre", "dx", "dyln", "db1_part",
                         "dw_part", "ln_part", "stats"]


def test_bwd_plan_at_stage_one_and_four():
    # stage 1 at bs 8: 4 output tiles per weight grad, so 65 splits of 28
    # k-tiles (260 tiles for 264 consumers); stage 4: 256 tiles fill the
    # consumers unsplit
    assert fm.bwd_plan(115200, 128, 512) == (1800, 65, 28, 1800)
    assert fm.bwd_plan(1800, 1024, 4096) == (29, 1, 29, 29)
