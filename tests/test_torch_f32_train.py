"""K8 f32, K7 f32 and K4b f32 (the window-7 lavt_one training step in f32)
on the CPU: their entry points, their launches' plain versions and their
launch plans, against the port's plain versions and the Pallas kernels
they replace at f32 (the kernels themselves run on the card in
tests/test_torch_f32_cuda.py).

* `fused_ln_mlp_droppath_f32`, `fused_ln_mlp_bwd_f32` and
  `layer_norm_rows_bwd_f32`, and the bf16 entry points that route a CUDA
  f32 tensor to them, take their plain versions on CPU tensors and count
  no launch; K8 f32 and K7 f32 agree with the Pallas kernel (interpret
  mode) and its VJP at f32 within test_torch_train_kernels_plain.py's
  tolerances (1e-5 forward, 1e-4 grads).
* K3 f32's and K8 f32's launches (prep: the LN rows and the weights' lo
  parts; fc1 + GELU; fc2 + keep + residual) composed through their plain
  versions
  equal `fused_ln_mlp_plain` / `fused_ln_mlp_droppath_plain` (1e-6 of the
  largest magnitude), and the weights split hi + lo bit for bit.
* K7 f32's launches (prep, dual GEMM, weight grads split by
  `bwd_plan(..., f32=True)`, dyln, LN-backward rows), composed through
  their plain versions, equal `fused_ln_mlp_bwd_plain` at f32 to f32
  summation order (1e-6 of the largest magnitude): keep and none, C =
  128 and 1024, M a multiple of no tile; its buffers include W2's K-major
  copy for the dual GEMM.
* K7 f32's weight-grad split and K4b f32's block plan cover every row
  once; K4b f32's block partials add up to the plain grads.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from lavt_rs_tpu.ops.pallas import fused_mlp as jmlp
from lavt_rs_tpu.ops.pallas import ln as jln
from lavt_rs_tpu_torch.ops import fused_mlp as fm
from lavt_rs_tpu_torch.ops import fused_msa, ln
from torch_threads import torch_threads  # noqa: F401 (autouse fixture)

COUNTERS = (fm.fused_ln_mlp_droppath_f32, fm.fused_ln_mlp_bwd_f32,
            ln.layer_norm_rows_bwd_f32, fm.fused_ln_mlp_droppath,
            fm.fused_ln_mlp_bwd, ln.layer_norm_rows_bwd)


def _launches():
    return tuple(f.launches for f in COUNTERS)


def _mlp(m, c, seed):
    rng = np.random.default_rng(seed)
    hidden = 4 * c

    def t(shape, std=1.0, mean=0.0):
        return torch.from_numpy((rng.standard_normal(shape) * std + mean)
                                .astype(np.float32))

    return dict(x=t((m, c), 2.0, 0.5), g=t((c,), 0.1, 1.0), be=t((c,), 0.1),
                w1=t((hidden, c), c ** -0.5), b1=t((hidden,), 0.1),
                w2=t((c, hidden), hidden ** -0.5), b2=t((c,), 0.1),
                gy=t((m, c)))


def _keep(m, rows):
    return torch.where(torch.arange(m // rows) % 3 == 1, 0.0, 1.0 / 0.7)


def _params(a):
    return tuple(a[k] for k in ("x", "g", "be", "w1", "b1", "w2", "b2"))


def _close(got, want, tol, name=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * float(np.abs(want).max()),
                               err_msg=name)


@pytest.mark.parametrize("drop", [False, True])
def test_k8_k7_f32_entry_points_match_pallas(drop):
    """On CPU tensors the f32 entry points are the plain versions (no
    count), equal to the Pallas forward and its VJP at f32."""
    rows, c = 16, 128
    m = 3 * rows
    a = _mlp(m, c, 190 + drop)
    keep = _keep(m, rows) if drop else None
    jp = tuple(jnp.asarray(a[k].numpy().T if k in ("w1", "w2")
                           else a[k].numpy())
               for k in ("x", "g", "be", "w1", "b1", "w2", "b2"))
    with pltpu.force_tpu_interpret_mode():
        if drop:
            fn = lambda *xs: jmlp.fused_ln_mlp_droppath(  # noqa: E731
                *xs, jnp.asarray(keep.numpy()), rows)
        else:
            fn = jmlp.fused_ln_mlp
        y, vjp = jax.vjp(fn, *jp)
        want = vjp(jnp.asarray(a["gy"].numpy()))
    before = _launches()
    if drop:
        got_y = fm.fused_ln_mlp_droppath_f32(*_params(a), keep, rows)
        torch.testing.assert_close(
            fm.fused_ln_mlp_droppath(*_params(a), keep, rows), got_y,
            rtol=1e-6, atol=1e-6)
    else:
        got_y = fm.fused_ln_mlp_f32(*_params(a))
    _close(got_y, y, 1e-5, "y")
    args = (a["x"], a["gy"], a["g"], a["be"], a["w1"], a["b1"], a["w2"],
            keep, rows)
    got = fm.fused_ln_mlp_bwd_f32(*args)
    # the same plain version (the CPU's BLAS may split its sums by thread)
    for g_, w_ in zip(got, fm.fused_ln_mlp_bwd(*args)):
        torch.testing.assert_close(g_, w_, rtol=1e-6, atol=1e-6)
    dx, dg, dbe, dw1, db1, dw2, db2 = got
    for name, g_, w_ in zip(("dx", "dg", "dbe", "dw1", "db1", "dw2", "db2"),
                            (dx, dg, dbe, dw1.t(), db1, dw2.t(), db2), want):
        _close(g_, w_, 1e-4, name)
    assert _launches() == before


def _bwd_composed_f32(x, gy, g, be, w1, b1, w2, keep=None, rows=1):
    """K7 f32's launches in order (their plain versions on the CPU), the
    weight grads split as K7 f32 splits them, the partials summed."""
    m, c = x.shape
    plan = fm.bwd_plan(m, c, w1.shape[0], f32=True)
    xn, stats, dmlp = fm.mlp_bwd_prep(x, gy, g, be, keep, rows)
    h, dhpre, db1_part = fm.dual_gemm_gelu_bwd(xn, dmlp, w1, b1, w2)
    dw2_part = fm.wgrad(dmlp, h, plan.split_rows)
    dw1_part = fm.wgrad(dhpre, xn, plan.split_rows)
    assert dw1_part.shape[0] == dw2_part.shape[0] == plan.splits
    dyln = fm.dgrad(dhpre, w1)
    dx, ln_part = fm.ln_bwd_rows(dyln, x, gy, g, stats, keep, rows)
    buf = fm.bwd_buffers(m, c, w1.shape[0], "meta", torch.float32)
    for name, part in (("db1_part", db1_part), ("ln_part", ln_part),
                       ("dyln", dyln), ("stats", stats), ("h", h),
                       ("dhpre", dhpre), ("xn", xn), ("dmlp", dmlp),
                       ("dx", dx)):
        assert part.shape == buf[name].shape, name
        assert buf[name].dtype == torch.float32, name
    assert buf["dw_part"].shape == (plan.splits, 2, c * w1.shape[0])
    # W2's K-major copy, its lo parts and W1's, which the dual GEMM on the
    # 3xTF32 core reads (each B's lo by TMA)
    assert buf["w2t"].shape == (3, w1.shape[0], c)
    assert buf["w2t"].dtype == torch.float32
    dg, dbe, db2 = fused_msa.sum_partials(ln_part)
    return (dx, dg, dbe, fused_msa.sum_partials(dw1_part),
            fused_msa.sum_partials(db1_part), fused_msa.sum_partials(dw2_part),
            db2)


@pytest.mark.parametrize("m,c,rows,drop", [
    (37, 128, 1, False), (2085, 128, 139, True), (45, 1024, 1, False),
    (45, 1024, 15, True)])
def test_k7_f32_launches_compose_to_the_plain_backward(m, c, rows, drop):
    """M = 2085 splits the weight grads into 33 splits of 2 k-tiles (the
    last ragged) at C = 128; 37 and 45 fill no 64-row tile."""
    a = _mlp(m, c, m + c)
    keep = _keep(m, rows) if drop else None
    args = (a["x"], a["gy"], a["g"], a["be"], a["w1"], a["b1"], a["w2"],
            keep, rows)
    want = fm.fused_ln_mlp_bwd_plain(*args)
    for name, g_, w_ in zip(("dx", "dg", "dbe", "dw1", "db1", "dw2", "db2"),
                            _bwd_composed_f32(*args), want):
        _close(g_, w_, 1e-6, name)


@pytest.mark.parametrize("m,c,rows,drop", [
    (37, 128, 1, False), (2085, 128, 139, True), (45, 1024, 1, False),
    (45, 1024, 15, True)])
def test_k3_k8_f32_launches_compose_to_the_plain_forward(m, c, rows, drop):
    """K3 f32's and K8 f32's launches (prep: the LN rows and the weights'
    lo parts; fc1 + GELU; fc2 + keep + residual), composed through their
    plain versions, equal
    `fused_ln_mlp_plain` / `fused_ln_mlp_droppath_plain` at f32 to f32
    summation order, and each weight's hi + lo is the weight bit for
    bit."""
    a = _mlp(m, c, 7 * m + c)
    x, g, be, w1, b1, w2, b2 = _params(a)
    keep = _keep(m, rows) if drop else None
    xn, w1lo, w2lo = fm.mlp_f32_prep(x, g, be, w1, w2)
    assert torch.equal(xn, fm.mlp_ln_rows_plain(x, g, be))
    for w, lo in ((w1, w1lo), (w2, w2lo)):
        hi, _ = fm.tf32_split(w)
        assert torch.equal(hi + lo, w)
        assert float(lo.abs().max()) <= 2.0 ** -10 * float(w.abs().max())
    h = fm.gemm_gelu_f32(xn, w1, w1lo, b1)
    got = fm.gemm_residual_f32(h, w2, w2lo, b2, x, keep, rows)
    want = (fm.fused_ln_mlp_plain(x, g, be, w1, b1, w2, b2) if keep is None
            else fm.fused_ln_mlp_droppath_plain(x, g, be, w1, b1, w2, b2,
                                                keep, rows))
    _close(got, want, 1e-6, "out")
    _close(got - x, want - x, 1e-6, "branch")


# (M, C) of the window-7 bs-8 step (480², padded to windows of 7 only in
# the attention: the MLP tails see the unpadded tokens), bs 16, ragged M
PLAN_SHAPES = ([(115200, 128), (28800, 256), (7200, 512), (1800, 1024)]
               + [(230400, 128), (7200, 384)]
               + [(m, c) for m in (1, 33, 2085) for c in (128, 1024)])


@pytest.mark.parametrize("m,c", PLAN_SHAPES)
def test_k7_f32_split_plan_covers_every_row_once(m, c):
    hidden = 4 * c
    plan = fm.bwd_plan(m, c, hidden, f32=True)
    depth = fm.GEMM_F32_DEPTH
    k_tiles = -(-m // depth)
    assert plan.split_rows == plan.split_tiles * depth
    # split s takes the k-tiles [s split_tiles, (s + 1) split_tiles): all,
    # once, none empty (the C side refuses an empty split)
    assert (plan.splits - 1) * plan.split_tiles < k_tiles
    assert plan.splits * plan.split_tiles >= k_tiles
    covered = np.zeros(m, np.int64)
    for s in range(plan.splits):
        covered[s * plan.split_rows:(s + 1) * plan.split_rows] += 1
    assert (covered == 1).all()
    assert plan.splits * 2 * hidden * c * 4 <= max(fm._DW_PARTIAL_BYTES,
                                                   2 * hidden * c * 4)
    # one split at most per SM and output tile: the f32 GEMM runs one
    # block an SM
    tiles = -(-hidden // fm.GEMM_TILE) * -(-c // fm.GEMM_TILE)
    assert plan.splits <= max(1, fm._SMS // tiles)
    assert plan.row_tiles == -(-m // fm.DUAL_ROWS)
    assert plan.ln_blocks == -(-m // fm.LN_BWD_ROWS)
    # the bf16 plan is unchanged by the f32 one
    assert type(fm.bwd_plan(m, c, hidden)) is fm.BwdPlan


def test_k7_f32_plan_at_stage_one_and_four():
    assert fm.bwd_plan(115200, 128, 512, f32=True) == (1800, 33, 110, 1800)
    assert fm.bwd_plan(1800, 1024, 4096, f32=True) == (29, 1, 57, 29)


@pytest.mark.parametrize("rows,c,sms", [
    (1, 128, 132), (7, 96, 132), (115200, 128, 132), (1800, 1024, 132),
    (3000, 256, 4), (333, 1056, 2), (50, 1536, 132), (1155, 160, 3)])
def test_k4b_f32_plan_and_partials(rows, c, sms):
    """The plan's blocks take every row once (a block's steps whole: its
    warps' lane groups at C <= 1024, one row above), at most one an SM, in
    groups of at most `group` that cover them; the partials over its
    blocks, added as the launch adds them (`sum_groups_plain`), make the
    plain dscale and dbias, and dx is the plain one."""
    p = ln.ln_rows_f32_bwd_plan(rows, c, sms)
    step = 1 if c > 1024 else p["warps"] * (32 // p["lanes"])
    if c <= 1024:
        assert p["lanes"] * p["vecs"] >= c // 4 and p["vecs"] <= 8
        assert p["warps"] == (16 if p["vecs"] <= 4 else 8)
    assert p["per"] % step == 0 and p["blocks"] <= sms
    assert (p["blocks"] - 1) * p["per"] < rows <= p["blocks"] * p["per"]
    assert p["group"] ** 2 >= p["blocks"] > (p["group"] - 1) ** 2
    assert (p["groups"] - 1) * p["group"] < p["blocks"] <= (
        p["groups"] * p["group"])
    rng = np.random.default_rng(rows + c)
    x = torch.from_numpy((rng.standard_normal((rows, c)) * 2 + 1)
                         .astype(np.float32))
    s = torch.from_numpy((1 + 0.1 * rng.standard_normal(c)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((rows, c)).astype(np.float32))
    dx, part = ln.layer_norm_rows_bwd_partials_f32_plain(x, s, g, sms=sms)
    assert part.shape == (p["blocks"], 2, c) and part.dtype == torch.float32
    want = ln.layer_norm_rows_bwd_plain(x, s, g)
    assert torch.equal(dx, want[0])
    sums = ln.sum_groups_plain(part, p)
    _close(sums[0], want[1], 1e-5, "dscale")
    _close(sums[1], want[2], 1e-5, "dbias")
    # the one launch's wrapper on a CPU tensor: the plain backward
    got = ln.layer_norm_rows_bwd_f32_launch(x, s, g)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_k4b_f32_entry_points_match_the_pallas_vjp():
    """K4b f32 (and the K4b entry, which routes a CUDA f32 tensor to it)
    on CPU tensors: the plain backward, no count, equal to the VJP of the
    Pallas LayerNorm at f32."""
    rng = np.random.default_rng(191)
    rows, c = 64, 256
    x = (rng.standard_normal((rows, c)) * 3 + 1).astype(np.float32)
    s = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    b = (0.1 * rng.standard_normal(c)).astype(np.float32)
    gy = rng.standard_normal((rows, c)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(jln.layer_norm_rows, jnp.asarray(x), jnp.asarray(s),
                         jnp.asarray(b))
        want = vjp(jnp.asarray(gy))
    before = _launches()
    got = ln.layer_norm_rows_bwd_f32(torch.from_numpy(x), torch.from_numpy(s),
                                     torch.from_numpy(gy))
    again = ln.layer_norm_rows_bwd(torch.from_numpy(x), torch.from_numpy(s),
                                   torch.from_numpy(gy))
    assert _launches() == before
    for name, g_, a_, w_ in zip(("dx", "dscale", "dbias"), got, again, want):
        assert g_.dtype == torch.float32 and torch.equal(g_, a_)
        _close(g_, w_, 1e-4, name)
