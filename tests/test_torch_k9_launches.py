"""K9's host side on the CPU: its launches and their glue.

K9 (the backward of K10) runs on the card as two launches and a sum
(`ops/window_attn.bwd_launches`): launch 1 (`attention_bwd_q`: dq, D =
rowsum(do o) and the dbias partials of its (window stride, query tile x
head) blocks, as `k9_plan` cuts them), launch 2 (`attention_bwd_kv`: dk, dv
from launch 1's D) and `sum_partials`.  On CPU tensors each launch takes
its plain version, so the plan, the partials and the mask flags around the
kernels run here:

* the plain launches compose to K9's plain version
  (`attention_core_bwd_plain`) at N = 49 (window 7), 196 (a 4-frame video
  window) and 400 (an 8-frame window padded to 16 tokens), with and
  without a mask, from K10's saved output and lse;
* the composition equals the JAX package's kernel `attention_core_bwd` in
  Pallas interpret mode at N = 49 and 196, and `jax.vjp` of its XLA
  attention at N = 400, where the JAX kernel does not run (its tiling gates
  N <= 256);
* `k9_plan`'s grids at the video and window-7 shapes, each dbias partial
  its windows' sum, and the mask flags.

Tolerances: f32 on both sides of the same math (P from lse where the plain
version takes the softmax), so 1e-5 relative to each output's largest
magnitude; against JAX 2e-4 abs + rel, as tests/test_torch_video_train.py
holds K9's plain version to it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from lavt_rs_tpu.ops import attention as jattn
from lavt_rs_tpu.ops.pallas import window_attn as jwattn
from lavt_rs_tpu_torch.ops import window_attn
from lavt_rs_tpu_torch.ops.window import (shift_mask_2d, shift_mask_3d,
                                          shift_mask_flags_2d,
                                          shift_mask_flags_3d)
from torch_threads import torch_threads  # noqa: F401 (autouse fixture)

SCALE = 32 ** -0.5
NAMES = ("dq", "dk", "dv", "dbias")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, tol, name=""):
    got = np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * float(np.abs(want).max()),
                               err_msg=name)


def _inputs(rng, n, masked, b=2, nw=3, heads=2):
    q, k, v, do = (rng.standard_normal((b, nw, heads, n, 32)).astype(np.float32)
                   for _ in range(4))
    bias = rng.standard_normal((heads, n, n)).astype(np.float32)
    mask = None
    if masked:  # window 1 of each image masks nothing (a flag of 0)
        mask = np.where(rng.random((nw, n, n)) > 0.7, -100.0,
                        0.0).astype(np.float32)
        mask[1] = 0.0
    return q, k, v, bias, mask, do


def _port(args):
    q, k, v, bias, mask, do = (None if a is None else _t(a) for a in args)
    o, lse = window_attn.window_attention_save_plain(q, k, v, bias, mask,
                                                     SCALE)
    return q, k, v, bias, mask, do, o, lse


@pytest.mark.parametrize("n", [49, 196, 400])
@pytest.mark.parametrize("masked", [False, True])
def test_launches_compose_to_k9_plain(rng, n, masked):
    q, k, v, bias, mask, do, o, lse = _port(_inputs(rng, n, masked))
    want = window_attn.attention_core_bwd_plain(q, k, v, bias, mask, do,
                                                SCALE, o)
    for sms in (132, 7):  # one pass of windows per block, and many
        plan = window_attn.k9_plan(q.shape[0] * q.shape[1], q.shape[2], n,
                                   sms)
        got = window_attn.bwd_launches(q, k, v, bias, mask, do, SCALE, o, lse,
                                       plan)
        for name, g, w in zip(NAMES, got, want):
            _close(g, w, 1e-5, name)


@pytest.mark.parametrize("n", [49, 196, 400])
@pytest.mark.parametrize("masked", [False, True])
def test_launches_match_jax(rng, n, masked):
    args = _inputs(rng, n, masked)
    jq, jk, jv, jb, jm, jdo = (None if a is None else jnp.asarray(a)
                               for a in args)
    if n <= 256:
        with pltpu.force_tpu_interpret_mode():
            want = jwattn.attention_core_bwd(jq, jk, jv, jb, jm, jdo, SCALE)[:4]
    else:
        _, vjp = jax.vjp(lambda *t: jattn.window_attention_xla(*t, jm,
                                                               scale=SCALE),
                         jq, jk, jv, jb)
        want = vjp(jdo)
    q, k, v, bias, mask, do, o, lse = _port(args)
    got = window_attn.bwd_launches(q, k, v, bias, mask, do, SCALE, o, lse)
    for name, g, w in zip(NAMES, got, want):
        _close(g, w, 2e-4, name)


def test_plan_at_the_path_shapes():
    """Launch 1 fills the 132 SMs about once with (bp, query tiles x heads)
    blocks; its partials are bp above N = 64 and 2 bp at window 7 (one per
    warpgroup); launch 2 holds one block per SM at most."""
    cases = {  # (B nW, heads, N): (bp, parts)
        (324, 3, 392): (6, 6), (81, 6, 392): (3, 3), (25, 12, 392): (2, 2),
        (9, 24, 392): (1, 1), (2592, 4, 49): (33, 66), (72, 32, 49): (4, 8)}
    for (bw, heads, n), (bp, parts) in cases.items():
        plan = window_attn.k9_plan(bw, heads, n, 132)
        assert (plan["bp"], plan["parts"]) == (bp, parts), (bw, heads, n)
        assert plan["kv_blocks"] <= 132 and plan["bp"] <= bw


def test_dbias_partials_are_their_windows_sums(rng):
    q, k, v, bias, mask, do, o, lse = _port(_inputs(rng, 49, True, nw=5))
    plan = window_attn.k9_plan(10, 2, 49, 6)  # bp 3: 6 partials
    assert plan["parts"] == 6
    _, _, _, part = window_attn.attention_bwd_q(q, k, v, bias, mask, do,
                                                SCALE, o, lse, plan)
    flat = [t.flatten(0, 1) for t in (q, k, v, do, o)]
    for w in range(10):
        wi = w % 5
        one = window_attn.attention_core_bwd_plain(
            *(t[w:w + 1, None] for t in flat[:3]), bias,
            mask[wi:wi + 1], flat[3][w:w + 1, None], SCALE,
            flat[4][w:w + 1, None])[3]
        slot = 2 * (w % 3) + (w // 3) % 2
        part[slot] -= one
    assert float(part.abs().max()) < 1e-4


def test_mask_flags():
    """The window flags of a mask, and those the blocks build beside their
    shift masks from the region ids (`shift_mask_flags_2d` / `_3d`)."""
    mask = shift_mask_2d(56, 56, 7, 3, "cpu")
    flags = window_attn.mask_flags(mask)
    assert flags.dtype == torch.int32 and flags.shape == (64,)
    assert int(flags.sum()) == 15  # the last row and column of windows
    assert torch.equal(shift_mask_flags_2d(56, 56, 7, 3, "cpu"), flags)
    mask3 = shift_mask_3d(8, 126, 126, (8, 7, 7), (0, 3, 3), "cpu")
    flags3 = window_attn.mask_flags(mask3)
    assert int(flags3.sum()) == 35
    assert torch.equal(
        shift_mask_flags_3d(8, 126, 126, (8, 7, 7), (0, 3, 3), "cpu"), flags3)
    assert window_attn.mask_flags(None) is None
    assert shift_mask_flags_2d(56, 56, 7, 0, "cpu") is None
    assert shift_mask_flags_3d(8, 126, 126, (8, 7, 7), (0, 0, 0),
                               "cpu") is None
