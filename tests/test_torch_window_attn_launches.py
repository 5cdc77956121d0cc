"""K10's host side on the CPU: its launch plan and its strided route.

K10 (csrc/window_attn_sm90.cu) runs only on the card; what surrounds it
runs here, with no card and no nvcc:

* `k10_plan`, the persistent launch: every 64-row unit of every (window,
  head) is taken by exactly one warpgroup, the grid fits the card in one
  wave, at N <= 64 each warpgroup's units share one head (its bias is held
  in registers), and the shared memory fits an H100 SM (two blocks at
  N <= 64, one above) at the main paths' shapes and at ragged N;
* `window_attention_qkv`, the inference route on the qkv Linear's output:
  q, k, v are views (no copy) and its plain version equals K10's plain
  version on contiguous copies, at N in {1, 17, 49, 63, 196, 392} with
  and without a mask, and the JAX package's Pallas kernel
  (`window_attention_pallas`, interpret mode) on the same q, k, v;
* a 2D and a 3D window-attention module through the kernel route (the
  strided views) against the same module's plain route.

Tolerances: the strided and contiguous plain versions run the same f32
math, so 1e-6; against Pallas 1e-4 relative to the largest output (f32
sums in another order through the softmax).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from lavt_rs_tpu.ops.pallas import window_attn as jwa
from lavt_rs_tpu_torch.models.swin2d import WindowAttention
from lavt_rs_tpu_torch.models.swin3d import WindowAttention3D
from lavt_rs_tpu_torch.ops import window_attn as wa
from lavt_rs_tpu_torch.ops.window import shift_mask_2d, shift_mask_3d
from torch_threads import torch_threads  # noqa: F401 (autouse fixture)

SMS = 132
NS = (1, 17, 49, 63, 196, 392)
# (B nW, heads, N) of the main paths: window-7 Swin-B at bs 8, stages 1-4;
# the video clip's stages 1-4 (stage 1 in training); a 4-frame stage 2
PATH_SHAPES = [(2592, 4, 49), (648, 8, 49), (200, 16, 49), (72, 32, 49),
               (324, 3, 392), (81, 6, 392), (25, 12, 392), (9, 24, 392),
               (81, 6, 196)]


def _k10_units(plan, bw, heads, n):
    """The units each warpgroup of `plan` takes, in its order, as (window,
    q tile, head): the kernel's assignment (csrc/window_attn_sm90.cu's
    `first_item` / `next_item`) written out."""
    units, t = plan["units"], plan["warpgroups"]
    if n <= 64:
        return [[(u // heads, 0, u % heads) for u in range(c, units, t)]
                for c in range(t)]
    per = plan["per_block"]
    out = []
    for c in range(t):
        b, w = divmod(c, 2)
        run = range(b * per + w, min(units, (b + 1) * per), 2)
        out.append([(u % bw, u // bw // heads, u // bw % heads) for u in run])
    return out


@pytest.mark.parametrize("bw,heads,n", PATH_SHAPES
                         + [(6, 5, n) for n in NS + (130, 400)])
def test_k10_plan_covers_every_unit_once_in_one_wave(bw, heads, n):
    plan = wa.k10_plan(bw, heads, n, SMS)
    tiles = -(-n // 64)
    units, t = plan["units"], plan["warpgroups"]
    assert units == bw * tiles * heads and plan["items"] == units * tiles
    assert t == 2 * plan["blocks"] and plan["waves"] <= 1
    taken = _k10_units(plan, bw, heads, n)
    assert len(taken) == t
    flat = [u for wg in taken for u in wg]
    assert sorted(flat) == sorted((w, qt, h) for w in range(bw)
                                  for qt in range(tiles) for h in range(heads))
    assert max(map(len, taken)) == plan["units_per_warpgroup"]
    if n <= 64:  # the bias in registers: one head per warpgroup
        assert all(len({h for _, _, h in wg}) <= 1 for wg in taken)
        assert max(map(len, taken)) - min(map(len, taken)) <= 1
    else:  # a block's (q tile, head) runs: one bias load each
        for b in range(plan["blocks"]):
            pairs = [(qt, h) for wg in taken[2 * b:2 * b + 2]
                     for _, qt, h in wg]
            assert len(set(pairs)) <= plan["bias_loads"]
    # the blocks the plan puts on an SM fit its shared memory
    assert plan["per_sm"] == (2 if n <= 49 else 1)
    assert plan["per_sm"] * (plan["smem"] + wa.SMEM_PER_BLOCK_RESERVED) \
        <= wa.SMEM_PER_SM


def test_k10_shared_memory_at_the_path_shapes():
    # csrc/window_attn_sm90.cu's smem_bytes, worked by hand: window 7 two
    # rings of (12 KB q/k/v + 10 KB mask) and a 10 KB bias per warpgroup;
    # video the block's 100 KB of bias rows and two rings of (12 KB + an
    # 18 KB mask tile); seven barriers
    assert wa.k10_smem(49) == 1024 + 2 * (10240 + 2 * (12288 + 10240)) + 56
    assert wa.k10_smem(392) == 1024 + 102400 + 2 * 2 * (12288 + 18432) + 56
    assert all(wa.k10_smem(n) <= 232448 for n in range(1, wa.MAX_N + 1))


def test_k10_plan_refills_a_small_grid():
    # fewer units than warpgroups: one unit each, heads need not divide
    plan = wa.k10_plan(3, 5, 49, SMS)
    assert plan["blocks"] == 8 and plan["units_per_warpgroup"] == 1


def _qkv(rng, b, nw, n, heads, dtype=torch.float32):
    return torch.from_numpy(rng.standard_normal(
        (b, nw, n, 3 * heads * 32)).astype(np.float32)).to(dtype)


def _bias_mask(rng, heads, nw, n, masked):
    bias = torch.from_numpy(rng.standard_normal((heads, n, n))
                            .astype(np.float32))
    mask = (torch.from_numpy(np.where(rng.random((nw, n, n)) > 0.7, -100.0,
                                      0.0).astype(np.float32))
            if masked else None)
    return bias, mask


def test_qkv_heads_are_views():
    qkv = _qkv(np.random.default_rng(0), 2, 3, 17, 2)
    q, k, v = wa.qkv_heads(qkv, 2)
    assert q.shape == (2, 3, 2, 17, 32)
    for i, t in enumerate((q, k, v)):
        assert t.untyped_storage().data_ptr() == \
            qkv.untyped_storage().data_ptr()
        assert t.data_ptr() == qkv.data_ptr() + i * 2 * 32 * 4
        assert torch.equal(t, qkv.view(2, 3, 17, 3, 2, 32)[:, :, :, i]
                           .transpose(2, 3))


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("masked", [False, True])
def test_qkv_route_plain_matches_k10_plain(n, masked):
    rng = np.random.default_rng(n + masked)
    b, nw, heads = 2, 3, 2
    qkv = _qkv(rng, b, nw, n, heads)
    bias, mask = _bias_mask(rng, heads, nw, n, masked)
    sc = 32 ** -0.5
    q, k, v = (t.contiguous() for t in wa.qkv_heads(qkv, heads))
    want = wa.window_attention_plain(q, k, v, bias, mask, sc)
    want = want.transpose(2, 3).reshape(b, nw, n, heads * 32)
    got = wa.window_attention_qkv_plain(qkv, bias, mask, heads, sc)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    # on a CPU tensor the wrapper takes the plain version
    torch.testing.assert_close(wa.window_attention_qkv(qkv, bias, mask,
                                                       heads, sc), want,
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n,masked", [(49, False), (49, True), (196, True)])
def test_qkv_route_matches_the_pallas_kernel(n, masked):
    rng = np.random.default_rng(7 * n + masked)
    b, nw, heads = 1, 4, 2
    assert jwa.attn_fwd_supported(nw, n, heads, 32)
    qkv = _qkv(rng, b, nw, n, heads)
    bias, mask = _bias_mask(rng, heads, nw, n, masked)
    sc = 32 ** -0.5
    q, k, v = (jnp.asarray(t.contiguous().numpy())
               for t in wa.qkv_heads(qkv, heads))
    with pltpu.force_tpu_interpret_mode():
        want = jwa.window_attention_pallas(
            q, k, v, jnp.asarray(bias.numpy()),
            None if mask is None else jnp.asarray(mask.numpy()), sc)
    want = np.asarray(want).transpose(0, 1, 3, 2, 4).reshape(b, nw, n, -1)
    got = wa.window_attention_qkv(qkv, bias, mask, heads, sc).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * float(np.abs(want).max()))


def _spy(monkeypatch):
    calls = []
    real = wa.window_attention_qkv

    def spy(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)

    monkeypatch.setattr(wa, "window_attention_qkv", spy)
    return calls


def _module_pair(cls, seed, *args):
    torch.manual_seed(seed)
    kern = cls(*args, use_kernels=True)
    plain = cls(*args, use_kernels=False)
    plain.load_state_dict(kern.state_dict())
    return kern, plain


def test_2d_block_attention_takes_the_strided_route(monkeypatch):
    """A window-7 2D block's attention (route 'core'): with the kernels and
    no autograd recording, one call of the strided route, equal to the
    plain route on contiguous q, k, v."""
    kern, plain = _module_pair(WindowAttention, 0, 64, 7, 2)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 4, 49, 64)).astype(np.float32))
    mask = shift_mask_2d(14, 14, 7, 3, "cpu")
    assert kern.route(4, 49, 4) == "core"
    calls = _spy(monkeypatch)
    with torch.no_grad():
        got, want = kern(x, mask), plain(x, mask)
    assert calls == [(2, 4, 49, 192)]
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    # recording autograd: the contiguous route (K10's save mode and K9)
    got = kern(x, mask)
    assert len(calls) == 1
    torch.testing.assert_close(got.detach(), want, rtol=1e-6, atol=1e-6)


def test_3d_block_attention_takes_the_strided_route(monkeypatch):
    """A video block's attention at N = 392 (8 x 7 x 7 windows, shifted)
    through the strided route, equal to the plain route."""
    kern, plain = _module_pair(WindowAttention3D, 2, 64, (8, 7, 7), 2)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (1, 4, 392, 64)).astype(np.float32))
    mask = shift_mask_3d(8, 14, 14, (8, 7, 7), (0, 3, 3), "cpu")
    calls = _spy(monkeypatch)
    with torch.no_grad():
        got, want = kern(x, mask), plain(x, mask)
    assert calls == [(1, 4, 392, 192)]
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
