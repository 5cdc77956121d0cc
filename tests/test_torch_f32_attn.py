"""The f32 variants of K10 (both modes), K2p and K9 on the CPU: their
launch plans, the f32 grouped route's token padding, the plans of the
models they open to f32 on the card, and their entry points' CPU paths.

* `k10_f32_plan` and `k9_f32_plan` at the path shapes: window 7 at bs 8
  (N = 49), an 8-frame 480² clip (N = 392), a 4-frame clip (N = 196);
  every item once (K10 f32's in (head, window, query tile) order, a
  window-7 block's run within two heads), the grids within one wave,
  the shared memory the sources declare (K10 f32's three blocks an SM,
  K9 f32's within a block's 227 KB and two blocks an SM), launch 1's
  dbias partials one a window stride.
* K9 f32's launches (`bwd_launches_f32`: dq, D and the dbias partials of
  launch 1, one partial a window stride at every N; dk, dv of launch 2;
  the sum) compose to K9's plain version `attention_core_bwd_plain` at
  N = 49, 196 and 392, masked and not, and each partial is its windows'
  sum.
* The f32 entry points take their plain versions on CPU tensors and count
  no launch.
* `kernel_plan` at itemsize 4: window-7 inference K10 24 / K3 24 / K4 4, a
  clip K2p 2 / K10 10, a video step K10 12 / K9 12 (24 / 12 with
  --use_checkpoint).
* The grouped 3D route pads a window's 392 tokens to the sublane tile of
  its dtype, as the JAX block does: 392 in f32, 400 in bf16; the f32
  block equals the JAX block (use_pallas, LAVT_FUSED3D=all, the Pallas
  kernel in interpret mode) within the video tests' 2e-4.

The kernels themselves run on the card in tests/test_torch_f32_cuda.py.
Tolerances: the composition 1e-5 relative to each output's largest
magnitude (f32 on both sides of the same math, P from lse where the plain
version takes the softmax), as tests/test_torch_k9_launches.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from lavt_rs_tpu.models import swin3d as jswin3d
from lavt_rs_tpu_torch import config as C
from lavt_rs_tpu_torch.models import swin3d
from lavt_rs_tpu_torch.models.factory import build_model
from lavt_rs_tpu_torch.ops import fused_msa, window_attn
from test_torch_model import random_variables
from test_torch_video import _block_state_dict
from torch_threads import torch_threads  # noqa: F401 (autouse fixture)

SCALE = 32 ** -0.5
NAMES = ("dq", "dk", "dv", "dbias")
SMS = 132
COUNTERS = (window_attn.window_attention, window_attn.window_attention_f32,
            window_attn.attention_core_bwd,
            window_attn.attention_core_bwd_f32,
            fused_msa.fused_window_msa_grouped,
            fused_msa.fused_window_msa_grouped_f32)
# (B nW, heads, N) of each path: window 7 at bs 8, stages 1-4; an 8-frame
# 480² clip's stages 1-4 (stage 1: training and K2p f32's attention);
# stage 2 of a 4-frame clip
PATH_SHAPES = [(2592, 4, 49), (648, 8, 49), (200, 16, 49), (72, 32, 49),
               (324, 3, 392), (81, 6, 392), (25, 12, 392), (9, 24, 392),
               (81, 6, 196)]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, tol, name=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * float(np.abs(want).max()),
                               err_msg=name)


def _inputs(rng, n, masked, b=2, nw=3, heads=2):
    q, k, v, do = (_t(rng.standard_normal((b, nw, heads, n, 32))
                      .astype(np.float32)) for _ in range(4))
    bias = _t(rng.standard_normal((heads, n, n)).astype(np.float32))
    mask = None
    if masked:  # window 1 of each image masks nothing (a flag of 0)
        m = np.where(rng.random((nw, n, n)) > 0.7, -100.0, 0.0)
        m[1] = 0.0
        mask = _t(m.astype(np.float32))
    return q, k, v, bias, mask, do


def _k10_f32_items(plan, block):
    """The (head, window, query tile) of each item that block `block` of
    `k10_f32_plan`'s launch takes, in order, as the kernel derives them
    (item = (head qtiles + tile) bw + window)."""
    bw, out = plan["bw"], []
    for item in range(block * plan["per_block"],
                      min((block + 1) * plan["per_block"], plan["items"])):
        hq, win = divmod(item, bw)
        out.append((hq // plan["qtiles"], win, hq % plan["qtiles"]))
    return out


@pytest.mark.parametrize("bw,heads,n", PATH_SHAPES)
def test_k10_f32_plan_covers_every_item_once(bw, heads, n):
    """Every (head, window, query tile) once over the blocks' runs, the
    blocks within one wave (three an SM at N <= 56, two above), and as
    many blocks' shared memory within an SM's."""
    plan = window_attn.k10_f32_plan(bw, heads, n, SMS)
    small = n <= 56
    rows = 64 if small else 80
    assert (plan["rows"], plan["threads"]) == (rows, 2 * rows)
    assert plan["qtiles"] == -(-n // rows) and plan["chunks"] == -(-n // 56)
    assert plan["items"] == bw * heads * plan["qtiles"]
    assert plan["per_sm"] == (3 if small else 2)
    assert plan["blocks"] <= plan["per_sm"] * SMS
    assert (plan["blocks"] - 1) * plan["per_block"] < plan["items"] \
        <= plan["blocks"] * plan["per_block"]
    seen = [it for b in range(plan["blocks"])
            for it in _k10_f32_items(plan, b)]
    assert len(seen) == len(set(seen)) == plan["items"]
    assert set(seen) == {(h, w, t) for h in range(heads) for w in range(bw)
                         for t in range(plan["qtiles"])}
    per_block = window_attn.SMEM_PER_SM // (
        plan["smem"] + window_attn.SMEM_PER_BLOCK_RESERVED)
    assert per_block >= plan["per_sm"] >= 2
    assert plan["smem"] == (68352 if small else 56320)


def test_k10_f32_plan_at_window_7():
    """At the four window-7 shapes of a bs-8 forward each block takes a run
    of windows of one head, crossing into the next head at most once (its
    bias staged at most twice), and the runs fill the SMs once."""
    got = [window_attn.k10_f32_plan(bw, h, n, SMS) for bw, h, n in
           PATH_SHAPES[:4]]
    assert [p["per_block"] for p in got] == [27, 14, 9, 6]
    assert [p["blocks"] for p in got] == [384, 371, 356, 384]
    assert all(p["small"] and p["chunks"] == 1 and p["bias_loads"] <= 2
               for p in got)


@pytest.mark.parametrize("bw,heads,n", [PATH_SHAPES[0], PATH_SHAPES[5],
                                        PATH_SHAPES[8]])
def test_k10_f32_plan_orders_items_head_tile_window(bw, heads, n):
    """A block's items follow (head, query tile, window): the windows of
    one head's query tile back to back, so a block's items share their
    bias rows (one head's bias at N <= 56), crossing into the next (head,
    tile) at most once."""
    plan = window_attn.k10_f32_plan(bw, heads, n, SMS)
    order = [(h * plan["qtiles"] + t) * bw + w
             for b in range(plan["blocks"])
             for h, w, t in _k10_f32_items(plan, b)]
    assert order == list(range(plan["items"]))
    for b in range(plan["blocks"]):
        items = _k10_f32_items(plan, b)
        assert len({(h, t) for h, _, t in items}) <= 2


@pytest.mark.parametrize("bw,heads,n", PATH_SHAPES)
def test_k9_f32_plan_fills_the_sms_once(bw, heads, n):
    plan = window_attn.k9_f32_plan(bw, heads, n, SMS)
    tiles = -(-n // 80)
    assert plan["parts"] == plan["bp"] and 1 <= plan["bp"] <= bw
    assert plan["q_blocks"] == plan["bp"] * tiles * heads
    assert plan["q_blocks"] <= 2 * SMS or plan["bp"] == 1
    assert plan["kv_blocks"] == bw * heads * tiles
    assert plan["threads"] == 160
    assert (plan["q_smem"], plan["kv_smem"]) == (105856, 97408)


def test_k9_f32_plan_at_the_video_stages():
    got = [window_attn.k9_f32_plan(bw, h, n, SMS)["bp"]
           for bw, h, n in PATH_SHAPES[4:8]]
    assert got == [17, 8, 4, 2]


@pytest.mark.parametrize("bw,heads,n", PATH_SHAPES)
def test_k9_f32_grids_fit_an_sm_and_partials_follow_launch_1(bw, heads, n):
    """Each launch's shared memory fits a block (227 KB) and two blocks an
    SM with the 1 KB each reserves, as both are built for; launch 2 has a
    block per key tile of every (window, head); launch 1's dbias partials
    are its window strides, each window in exactly one."""
    plan = window_attn.k9_f32_plan(bw, heads, n, SMS)
    for smem in (plan["q_smem"], plan["kv_smem"]):
        assert smem <= 232448
        assert (window_attn.K9_F32_PER_SM
                * (smem + window_attn.SMEM_PER_BLOCK_RESERVED)
                <= window_attn.SMEM_PER_SM)
    assert plan["kv_blocks"] == bw * heads * -(-n // window_attn.K9_F32_ROWS)
    strides = [w % plan["bp"] for w in range(bw)]
    assert sorted(set(strides)) == list(range(plan["parts"]))


@pytest.mark.parametrize("n", [49, 196, 392])
@pytest.mark.parametrize("masked", [False, True])
def test_k9_f32_launches_compose_to_k9_plain(rng, n, masked):
    q, k, v, bias, mask, do = _inputs(rng, n, masked)
    o, lse = window_attn.window_attention_save_plain(q, k, v, bias, mask,
                                                     SCALE)
    want = window_attn.attention_core_bwd_plain(q, k, v, bias, mask, do,
                                                SCALE, o)
    flags = window_attn.mask_flags(mask)
    for sms in (SMS, 1):  # one window a partial, and every window in one
        plan = window_attn.k9_f32_plan(6, 2, n, sms)
        got = window_attn.bwd_launches_f32(q, k, v, bias, mask, do, SCALE,
                                           o, lse, plan, flags)
        for name, g, w in zip(NAMES, got, want):
            assert g.dtype == torch.float32
            _close(g, w, 1e-5, name)


def test_k9_f32_dbias_partials_are_their_windows_sums(rng):
    """Partial b sums the windows b, b + bp, ... at N = 49 too (the bf16
    K9 splits each by warpgroup there)."""
    q, k, v, bias, mask, do = _inputs(rng, 49, True, nw=5)
    o, lse = window_attn.window_attention_save_plain(q, k, v, bias, mask,
                                                     SCALE)
    plan = window_attn.k9_f32_plan(10, 2, 49, 3)  # 3 x 2 blocks: bp 3
    assert (plan["bp"], plan["parts"]) == (3, 3)
    _, dsum, part = window_attn.attention_bwd_q_f32(q, k, v, bias, mask, do,
                                                    SCALE, o, lse, plan)
    _close(dsum, (do * o).sum(-1), 1e-6, "D")
    flat = [t.flatten(0, 1) for t in (q, k, v, do, o)]
    for w in range(10):
        wi = w % 5
        one = window_attn.attention_core_bwd_plain(
            *(t[w:w + 1, None] for t in flat[:3]), bias,
            mask[wi:wi + 1], flat[3][w:w + 1, None], SCALE,
            flat[4][w:w + 1, None])[3]
        part[w % 3] -= one
    assert float(part.abs().max()) < 1e-4


def test_f32_entry_points_take_their_plain_versions_on_the_cpu(rng):
    q, k, v, bias, mask, do = _inputs(rng, 49, True)
    before = [f.launches for f in COUNTERS]
    want = window_attn.window_attention_plain(q, k, v, bias, mask, SCALE)
    for got in (window_attn.window_attention_f32(q, k, v, bias, mask, SCALE),
                window_attn.window_attention(q, k, v, bias, mask, SCALE),
                window_attn.window_attention_save(q, k, v, bias, mask,
                                                  SCALE)[0]):
        assert torch.equal(got, want)
    o, lse = window_attn.window_attention_save(q, k, v, bias, mask, SCALE)
    got = window_attn.attention_core_bwd_f32(q, k, v, bias, mask, do, SCALE,
                                             o, lse)
    for g, w in zip(got, window_attn.attention_core_bwd_plain(
            q, k, v, bias, mask, do, SCALE, o)):
        assert torch.equal(g, w)
    b, nw, heads, n, _ = q.shape
    qkv = torch.cat([t.transpose(2, 3).reshape(b, nw, n, heads * 32)
                     for t in (q, k, v)], -1)
    torch.testing.assert_close(
        window_attn.window_attention_qkv(qkv, bias, mask, heads, SCALE),
        want.transpose(2, 3).reshape(b, nw, n, heads * 32), rtol=1e-6,
        atol=1e-6)
    c = 64
    x = _t(rng.standard_normal((1, 3, 56, c)).astype(np.float32))
    w = [_t((rng.standard_normal(s) * 0.1).astype(np.float32))
         for s in ((3 * c, c), (3 * c,), (c, c), (c,))]
    bias56 = fused_msa.pad_bias_sublane(bias, 56)
    assert torch.equal(
        fused_msa.fused_window_msa_grouped_f32(x, *w, bias56, None, 3, 2,
                                               SCALE),
        fused_msa.fused_window_msa_grouped_plain(x, *w, bias56, None, 3, 2,
                                                 SCALE))
    assert [f.launches for f in COUNTERS] == before


def test_padded_msa_supported_takes_the_f32_sublane():
    assert fused_msa.padded_msa_supported(392, 96, 3, itemsize=4)
    assert not fused_msa.padded_msa_supported(392, 96, 3)  # bf16: 16 rows
    assert fused_msa.padded_msa_supported(400, 96, 3)
    assert not fused_msa.padded_msa_supported(396, 96, 3, itemsize=4)


@pytest.mark.parametrize("name,train,ckpt,want", [
    ("window7", False, False, {"K10": 24, "K3": 24, "K4": 4}),
    ("lavt_video", False, False, {"K2p": 2, "K10": 10}),
    ("lavt_video", True, False, {"K10": 12, "K9": 12}),
    ("lavt_video", True, True, {"K10": 24, "K9": 12}),
])
def test_kernel_plan_at_itemsize_4(name, train, ckpt, want):
    """The plans at f32 are the bf16 plans: window 7 at bs 8, an 8-frame
    480² clip (stage 1 on K2p f32 at n_p = 392), a video training step."""
    if name == "window7":
        cfg = C.lavt_one_base(window12=False, dtype="float32")
    else:
        cfg = C.lavt_video_tiny(dtype="float32", use_checkpoint=ckpt)
    backbone = build_model(cfg, "meta", train=train).backbone
    for itemsize in (4, 2):
        if name == "window7":
            counts = backbone.kernel_plan((480, 480), 8, itemsize, train)
        else:
            counts = backbone.kernel_plan(8, (480, 480), itemsize, train)
        assert counts == (want, [])


@pytest.fixture
def grouped_at_32(monkeypatch):
    """The grouped 3D route forced on at C = 32 (one head) in both packages,
    as the JAX package's LAVT_FUSED3D=all forces it; every K2p call's
    stream shape recorded."""
    monkeypatch.setenv("LAVT_FUSED3D", "all")
    monkeypatch.setattr(
        fused_msa, "fused3d_grouped_routed",
        lambda nw, n, c, heads, itemsize=2: c == 32 and
        fused_msa.padded_msa_supported(fused_msa._sublane_pad(n, itemsize),
                                       c, heads, itemsize))
    shapes, grouped = [], fused_msa.fused_window_msa_grouped

    def recorded(x, *a):
        shapes.append(tuple(x.shape))
        return grouped(x, *a)

    monkeypatch.setattr(fused_msa, "fused_window_msa_grouped", recorded)
    return shapes


def test_grouped_route_pads_to_the_dtype_sublane(rng, grouped_at_32):
    """An 8-frame 14² clip under (8, 7, 7) windows shifted by (0, 3, 3):
    four windows of 392 tokens.  The f32 block's grouped stream is (1, 4,
    392, 32) and its output the JAX block's; in bf16 the stream is padded
    to 400."""
    c, ws, ss = 32, (8, 7, 7), (0, 3, 3)
    x = rng.standard_normal((1, 8, 14, 14, c)).astype(np.float32)
    jblk = jswin3d.SwinBlock3D(dim=c, num_heads=1, window_size=ws,
                               shift_size=ss, use_pallas=True)
    shapes = jax.eval_shape(lambda: jblk.init(jax.random.PRNGKey(0),
                                              jnp.asarray(x)))
    params = random_variables(shapes["params"], np.random.default_rng(3))
    with pltpu.force_tpu_interpret_mode():
        want = jblk.apply({"params": params}, jnp.asarray(x))
    blk = swin3d.SwinBlock3D(c, 1, ws, ss).eval()
    blk.load_state_dict(_block_state_dict(params), strict=False)
    assert blk.route(392, 4, itemsize=4) == "grouped"
    with torch.no_grad():
        got = blk(_t(x))
        assert grouped_at_32 == [(1, 4, 392, c)]
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                                   atol=2e-4)
        blk.to(torch.bfloat16)(_t(x).bfloat16())
    assert grouped_at_32 == [(1, 4, 392, c), (1, 4, 400, c)]
