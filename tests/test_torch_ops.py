"""Plain ops of the PyTorch port against lavt_rs_tpu.ops, on the CPU.

Same numpy inputs through both; compared in f32.  Permutations, masks and
gathers are exact (tolerance 0); norms and resize agree to float32
rounding (1e-5); the window attention sums in another order (1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lavt_rs_tpu.ops import attention as jattn
from lavt_rs_tpu.ops import norm as jnorm
from lavt_rs_tpu.ops import resize as jresize
from lavt_rs_tpu.ops import window as jwin
from lavt_rs_tpu_torch.ops import norm, resize, window, window_attn
from torch_threads import torch_threads  # noqa: F401 (autouse fixture)

TOL = 1e-5


@pytest.mark.parametrize("h,w,ws,shift", [(24, 24, 12, 0), (24, 36, 12, 6),
                                          (14, 21, 7, 3)])
def test_window_partition_reverse_and_roll(rng, h, w, ws, shift):
    x = rng.standard_normal((2, h, w, 5)).astype(np.float32)
    xt = torch.roll(torch.from_numpy(x), (-shift, -shift), dims=(1, 2))
    xj = jnp.roll(jnp.asarray(x), (-shift, -shift), axis=(1, 2))
    got = window.window_partition(xt, ws)
    want = jwin.window_partition(xj, ws)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    back = window.window_reverse(got, ws, h, w)
    np.testing.assert_array_equal(back.numpy(), xt.numpy())
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jwin.window_reverse(want, ws, h, w)))


@pytest.mark.parametrize("hp,wp,ws,shift", [(24, 24, 12, 6), (36, 36, 12, 6),
                                            (24, 36, 12, 6), (14, 14, 7, 3)])
def test_shift_mask_2d(hp, wp, ws, shift):
    got = window.shift_mask_2d(hp, wp, ws, shift, "cpu")
    want = np.asarray(jwin.shift_mask_2d(hp, wp, ws, shift))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert window.shift_mask_2d(hp, wp, ws, 0, "cpu") is None
    # cached per shape and device
    assert window.shift_mask_2d(hp, wp, ws, shift, "cpu") is got


@pytest.mark.parametrize("ws,heads", [(12, 4), (7, 3)])
def test_relative_bias(rng, ws, heads):
    table = rng.standard_normal(((2 * ws - 1) ** 2, heads)).astype(np.float32)
    index = window.relative_position_index_2d(ws, ws)
    np.testing.assert_array_equal(index, jwin.relative_position_index_2d(ws, ws))
    got = window.relative_bias_from_table(torch.from_numpy(table),
                                          torch.from_numpy(index))
    want = np.asarray(jwin.relative_bias_from_table(jnp.asarray(table), ws, ws))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


def test_relative_position_index_buffer_is_a_copy_on_the_device():
    from lavt_rs_tpu_torch.models.swin2d import WindowAttention

    with torch.device("meta"):
        assert WindowAttention(32, 12, 1).relative_position_index.is_meta
    attn = WindowAttention(32, 12, 1)
    attn.relative_position_index.fill_(0)  # as load_state_dict writes into it
    assert window.relative_position_index_2d(12, 12).max() == 23 * 23 - 1


def test_normalize_image_and_instance_norm(rng):
    img = rng.integers(0, 256, (2, 8, 8, 3)).astype(np.uint8)
    got = norm.maybe_normalize_image(torch.from_numpy(img))
    want = jnorm.maybe_normalize_image(jnp.asarray(img))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    f = torch.ones(2, 3)
    assert norm.maybe_normalize_image(f) is f
    x = rng.standard_normal((2, 30, 16)).astype(np.float32) * 3 + 1
    np.testing.assert_allclose(
        norm.instance_norm_tokens(torch.from_numpy(x)).numpy(),
        np.asarray(jnorm.instance_norm_tokens(jnp.asarray(x))),
        rtol=TOL, atol=TOL)


@pytest.mark.parametrize("src,dst", [((15, 15), (30, 30)), ((24, 24), (96, 96)),
                                     ((7, 9), (13, 20))])
def test_resize_corner_aligned(rng, src, dst):
    x = rng.standard_normal((2,) + src + (3,)).astype(np.float32)
    got = resize.resize_nchw(torch.from_numpy(x).permute(0, 3, 1, 2), dst)
    want = jresize.resize_2d(jnp.asarray(x), dst, method="bilinear",
                             align_corners=True)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)
    xn = np.ascontiguousarray(x.transpose(0, 3, 1, 2))
    np.testing.assert_allclose(
        resize.resize_nchw(torch.from_numpy(xn), dst).numpy(),
        np.asarray(jresize.resize_nchw(jnp.asarray(xn), dst)),
        rtol=TOL, atol=TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_window_attention(rng, masked):
    b, nw, h, n, hd = 2, 4, 3, 16, 8
    q, k, v = (rng.standard_normal((b, nw, h, n, hd)).astype(np.float32)
               for _ in range(3))
    bias = rng.standard_normal((h, n, n)).astype(np.float32)
    mask = (np.where(rng.random((nw, n, n)) > 0.7, -100.0, 0.0)
            .astype(np.float32) if masked else None)
    got = window_attn.window_attention(
        *(torch.from_numpy(a) for a in (q, k, v, bias)),
        None if mask is None else torch.from_numpy(mask))
    want = jattn.window_attention_xla(
        *(jnp.asarray(a) for a in (q, k, v, bias)),
        None if mask is None else jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
