"""The 3xTF32 GEMM core of the f32 variants (csrc/gemm_tf32_sm90.cuh) on
the CPU: its arithmetic emulated in numpy, and its host-side plans
(`ops/tf32_core`) against the plans of the launches built on it.  The
kernels themselves run on the card in tests/test_torch_f32_cuda.py.

* The split as the core takes it: hi = x with its 13 low bits cleared
  (the tensor core reads a tf32 operand's top 19 bits), lo = x - hi,
  itself truncated by the tensor core; three products lo hi + hi lo + hi
  hi a term, f32 sums, each 32-deep stage into a partial added to the
  running sum.  At fc2's K = 4096 on seeded inputs it meets 1e-4 abs +
  rel of the f64 product, where one TF32 pass (hi hi) does not.
* The lo split (`fused_msa.tf32_lo`'s plain version) is w - trunc(w) bit
  for bit, and `WindowAttention` keeps its weights' lo parts until a
  weight changes in place (an optimizer's step) and then makes them anew.
* The plans: tiles, k-tiles, blocks (at most one an SM over the splits),
  each kind's shared memory within an H100 block's 227 KB, which operands
  take the transposing pass, where each kind's B gets its lo parts (by
  TMA for a K-major B, from the stagers for an MN-major one), and K7
  f32's weight-grad split, db1 row tiles and buffers against them.
"""

import numpy as np
import pytest
import torch

from lavt_rs_tpu_torch.models.swin2d import WindowAttention
from lavt_rs_tpu_torch.models.swin3d import WindowAttention3D
from lavt_rs_tpu_torch.ops import fused_mlp as fm
from lavt_rs_tpu_torch.ops import fused_msa
from lavt_rs_tpu_torch.ops import tf32_core as core
from torch_threads import torch_threads  # noqa: F401 (autouse fixture)

TOL = 1e-4


def _trunc(x):
    """x (f32) with its 13 low mantissa bits cleared: the tf32 the tensor
    core reads."""
    return (x.view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)


def _core_product(a, b, passes=3):
    """a (M, K) b (N, K)^T as the core computes it: per 32-deep stage a
    zeroed f32 partial of the stage's products (three passes a term, or
    one: hi hi), added to the f32 running sum."""
    ahi, bhi = _trunc(a), _trunc(b)
    alo, blo = _trunc(a - ahi), _trunc(b - bhi)
    acc = np.zeros((a.shape[0], b.shape[0]), np.float32)
    for k0 in range(0, a.shape[1], core.DEPTH):
        part = np.zeros_like(acc)
        for k in range(k0, k0 + core.DEPTH):
            if passes == 3:
                part += np.outer(alo[:, k], bhi[:, k])
                part += np.outer(ahi[:, k], blo[:, k])
            part += np.outer(ahi[:, k], bhi[:, k])
        acc += part
    return acc


def test_the_split_meets_f32_tolerance_at_fc2_depth():
    rng = np.random.default_rng(4096)
    m, n, k = 24, 20, 4096
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = (rng.standard_normal((n, k)) * k ** -0.5).astype(np.float32)
    want = a.astype(np.float64) @ b.astype(np.float64).T
    err = np.abs(_core_product(a, b) - want)
    assert (err <= TOL + TOL * np.abs(want)).all(), err.max()
    # one TF32 pass, ~2^-10 of each factor, misses it
    err1 = np.abs(_core_product(a, b, passes=1) - want)
    assert not (err1 <= TOL + TOL * np.abs(want)).all()


def test_hi_and_lo_carry_every_bit():
    rng = np.random.default_rng(19)
    x = (rng.standard_normal(10000) * 10.0 ** rng.integers(-6, 6, 10000)
         ).astype(np.float32)
    hi = _trunc(x)
    assert (x - hi + hi == x).all()        # lo = x - hi is exact
    assert (np.abs(x - hi) <= np.abs(x) * 2.0 ** -10).all()
    assert (hi.view(np.uint32) & np.uint32(0x1FFF) == 0).all()


@pytest.mark.parametrize("kind", sorted(core.KINDS))
def test_every_kind_fits_a_block(kind):
    r = core.ring(kind)
    assert r["smem"] <= core.SMEM_LIMIT
    assert r["stages"] >= 3
    assert r["stage_bytes"] % 1024 == 0  # 128-byte swizzle atoms
    b_mn = core.KINDS[kind][1]
    assert r["operand_tiles"] == (4 if b_mn else 3)


def test_which_operands_take_the_transposing_pass():
    assert core.transposed("gemm") == {}
    assert core.transposed("dual") == {"W2": "copy"}
    assert core.transposed("dgrad") == {"B": "stagers"}
    assert core.transposed("wgrad") == {"A": "in place", "B": "stagers"}
    assert core.plan("dual", 64, 512, 128)["launches"] == 2
    assert all(core.plan(k, 64, 512, 128)["launches"] == 1
               for k in ("gemm", "dgrad", "wgrad"))
    # a K-major B's lo comes by TMA; the stagers serve only an MN-major B
    assert {k: core.b_lo(k) for k in core.KINDS} == {
        "gemm": "TMA", "dual": "TMA", "dgrad": "stagers", "wgrad": "stagers"}
    assert all(core.plan(k, 64, 512, 128)["b_lo"] == core.b_lo(k)
               for k in core.KINDS)
    with pytest.raises(ValueError):
        core.plan("nt", 64, 64, 64)


def test_plans_at_swin_b_stage_shapes():
    # fc1 at stage 1 (bs 8, 480²): 900 x 4 output tiles, 4 k-tiles
    p = core.plan("gemm", 115200, 512, 128)
    assert (p["m_tiles"], p["n_tiles"], p["k_tiles"], p["blocks"]) == (
        900, 4, 4, 132)
    # K7 f32's dual GEMM at stage 4: 15 x 32 tiles over the 132 SMs
    p = core.plan("dual", 1800, 4096, 1024)
    assert (p["tiles"], p["k_tiles"], p["blocks"]) == (480, 32, 132)
    # dyln at stage 4: 15 x 8 = 120 tiles, fewer than the SMs
    p = core.plan("dgrad", 1800, 1024, 4096)
    assert (p["tiles"], p["k_tiles"], p["blocks"]) == (120, 128, 120)
    # the weight grads at stage 1: dW1 (512, 128) in 33 splits over M
    bp = fm.bwd_plan(115200, 128, 512, f32=True)
    p = core.plan("wgrad", 512, 128, 115200, bp.splits)
    assert (p["tiles"], p["k_tiles"], p["blocks"]) == (4, 3600, 4)
    assert p["blocks"] * bp.splits <= core.SMS


# the (M, C) of K7 f32's calls: window-7 bs-8 stages, bs 16, ragged M
PLAN_SHAPES = ([(115200, 128), (28800, 256), (7200, 512), (1800, 1024)]
               + [(230400, 128), (7200, 384)]
               + [(m, c) for m in (1, 33, 2085) for c in (128, 1024)])


@pytest.mark.parametrize("m,c", PLAN_SHAPES)
def test_k7_f32_plan_on_the_core(m, c):
    """K7 f32's weight grads split over M into the core's k-tiles, each
    split's blocks together at most one an SM; its db1 partials are the
    consumers' 64-row halves of the core's 128-row tiles; its buffers hold
    W2's K-major copy, the copy's lo parts and W1's, at a 16-byte
    boundary."""
    hidden = 4 * c
    bp = fm.bwd_plan(m, c, hidden, f32=True)
    assert fm.GEMM_F32_DEPTH == core.DEPTH
    assert bp.split_rows % core.DEPTH == 0
    for na, nb in ((c, hidden), (hidden, c)):
        p = core.plan("wgrad", na, nb, m, bp.splits)
        assert (bp.splits - 1) * bp.split_tiles < p["k_tiles"]
        assert bp.splits * bp.split_tiles >= p["k_tiles"]
        assert bp.splits == 1 or p["blocks"] * bp.splits <= core.SMS
    assert fm.DUAL_ROWS * 2 == core.TILE
    assert bp.row_tiles == -(-m // fm.DUAL_ROWS)
    assert bp.row_tiles <= 2 * core.plan("dual", m, hidden, c)["m_tiles"]
    buf = fm.bwd_buffers(m, c, hidden, "meta", torch.float32)
    assert buf["w2t"].shape == (3, hidden, c)
    assert buf["w2t"].storage_offset() * 4 % 16 == 0
    assert list(buf)[-1] == "w2t"
    assert "w2t" not in fm.bwd_buffers(m, c, hidden, "meta")


def test_the_lo_split_is_w_minus_trunc_w():
    rng = np.random.default_rng(24)
    w = (rng.standard_normal((96, 32))
         * 10.0 ** rng.integers(-6, 6, (96, 32))).astype(np.float32)
    want = w - _trunc(w)
    lo = fused_msa.tf32_lo(torch.from_numpy(w)).numpy()
    assert lo.dtype == np.float32
    assert (lo.view(np.uint32) == want.view(np.uint32)).all()
    hi, lo2 = fused_msa.tf32_split(torch.from_numpy(w))
    assert (hi.numpy().view(np.uint32) == _trunc(w).view(np.uint32)).all()
    assert (lo2.numpy().view(np.uint32) == want.view(np.uint32)).all()
    assert fm.tf32_split is fused_msa.tf32_split


def test_window_attention_remakes_its_lo_after_an_update():
    torch.manual_seed(24)
    _remakes_its_lo_after_an_update(WindowAttention(64, 12, 2))


def test_window_attention_3d_remakes_its_lo_after_an_update():
    """The 3D module keeps its lo parts as the 2D one does (one helper,
    `fused_msa.WeightLo`): K2p f32's projections take them."""
    torch.manual_seed(25)
    attn = WindowAttention3D(64, (2, 7, 7), 2)
    assert attn._lo_for(torch.zeros(1, 64)) is None  # a CPU tensor: no kernel
    _remakes_its_lo_after_an_update(attn)


def _remakes_its_lo_after_an_update(attn):
    ws = (attn.qkv.weight, attn.proj.weight)

    def want():
        return [fused_msa.tf32_split(w.detach())[1] for w in ws]

    lo = attn.weight_lo()
    assert attn.weight_lo() is lo  # kept while the weights stay
    assert all(torch.equal(a, b) for a, b in zip(lo, want()))
    with torch.no_grad():
        attn.qkv.weight.mul_(1.5)  # in place: a new version
    lo2 = attn.weight_lo()
    assert lo2 is not lo and not torch.equal(lo2[0], lo[0])
    assert all(torch.equal(a, b) for a, b in zip(lo2, want()))
    opt = torch.optim.AdamW(attn.parameters(), lr=1e-2)
    for w in ws:
        w.grad = torch.ones_like(w)
    opt.step()  # the optimizer's in-place update: made anew once
    lo3 = attn.weight_lo()
    assert lo3 is not lo2 and attn.weight_lo() is lo3
    assert all(torch.equal(a, b) for a, b in zip(lo3, want()))
