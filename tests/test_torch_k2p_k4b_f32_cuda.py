"""K2p f32's attention launch and K4b f32's one launch on the card.

Run on a machine with an NVIDIA GPU (skipped here without CUDA):

    python -m pytest --noconftest -p no:cacheprovider -q \
        tests/test_torch_k2p_k4b_f32_cuda.py

* K2p f32's attention (`fused_msa.grouped_attn_f32`, csrc/grouped_msa_f32.cu:
  3xTF32 on wgmma, keys in chunks of 56, two consumer warpgroups over the
  64-row query tiles) at the video stage-1 shape of an 8-frame 480² clip
  (324 windows of 392 tokens, 3 heads) maskless and grouped at nu = 0,
  nW / 2 and nW; with fewer items than SMs; with runs of items that cross
  heads; at token counts that leave a ragged last chunk and tile (104,
  200) and at one query tile (56): within 1e-4 abs + rel of the f32 plain
  version, the same bits twice;
* K2p f32 as a call (the three launches, with the weights' lo parts kept
  and without): within 1e-4 abs + rel of its plain version, one count;
* K4b f32 (`ln.layer_norm_rows_bwd_f32`: dx and the column sums in one
  launch) at the lavt_one Swin-B 480² bs-8 stage widths and K1 f32's LN
  backward at C = 96 (`ln.layer_norm_rows_bwd_launch`): dx within 1e-4 abs
  + rel of the plain version, dscale and dbias within 1e-4 (rms + |want|)
  of their f64 values (at 115,200 rows the f32 plain version's own sums
  miss 1e-4 abs + rel of f64), the same bits twice; its workspace as its
  plan says.

f32 tolerance: 3xTF32 products and f32 sums in another order than the
plain versions' (tests/test_torch_f32_cuda.py); TF32 off in the plain
versions.
"""

import numpy as np
import pytest
import torch

from lavt_rs_tpu_torch.ops import cuda_lib, fused_msa, ln, window_attn

pytestmark = pytest.mark.cuda

TOL = 1e-4
SCALE = 32 ** -0.5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda:0")


def _f32(rng, shape, std, dev):
    return torch.from_numpy((rng.standard_normal(shape) * std)
                            .astype(np.float32)).to(dev)


def _close(got, want):
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == torch.float32
    assert bool(torch.isfinite(got).all())
    err = (got - want).abs()
    assert bool((err <= TOL + TOL * want.abs()).all()), err.max().item()


def _sums_close(got, want64):
    """A sum within TOL (rms + |want|) of its f64 value."""
    torch.cuda.synchronize()
    rms = want64.pow(2).mean().sqrt()
    err = (got.double() - want64).abs()
    assert bool((err <= TOL * (rms + want64.abs())).all()), \
        (err / (rms + want64.abs())).max().item()


def _grouped_mask(rng, nw, nu, n, dev):
    if nu >= nw:
        return None
    return torch.from_numpy(np.where(rng.random((nw - nu, n, n)) > 0.7,
                                     -100.0, 0.0).astype(np.float32)).to(dev)


def _attention_case(dev, b, nw, n, heads, nu, seed):
    rng = np.random.default_rng(seed)
    qkv = _f32(rng, (b, nw, n, 3 * 32 * heads), 1.0, dev)
    bias = _f32(rng, (heads, n, n), 2.0, dev)
    mask = _grouped_mask(rng, nw, nu, n, dev)
    got = fused_msa.grouped_attn_f32(qkv, bias, mask, nu, heads)
    want = window_attn.window_attention_qkv_plain(
        qkv, bias, None if mask is None else torch.cat(
            [mask.new_zeros((nu, n, n)), mask]), heads, 1.0)
    _close(got, want)
    again = fused_msa.grouped_attn_f32(qkv, bias, mask, nu, heads)
    torch.cuda.synchronize()
    assert torch.equal(got, again)


def test_k2p_f32_attention_smem_is_the_plan_s(dev):
    assert cuda_lib.lib().lavt_k2p_attn_f32_smem() == fused_msa.K2P_F32_SMEM


@pytest.mark.parametrize("nu", [0, 162, 324])
def test_k2p_f32_attention_at_the_stage1_shape(dev, nu):
    _attention_case(dev, 1, 324, 392, 3, nu, nu)


def test_k2p_f32_attention_with_fewer_items_than_sms(dev):
    plan = fused_msa.k2p_f32_plan(5, 3, 392, cuda_lib.sm_count(0))
    assert plan["items"] == plan["blocks"] == 30
    _attention_case(dev, 1, 5, 392, 3, 2, 7)


def test_k2p_f32_attention_runs_cross_windows_and_heads(dev):
    """500 (window, head, sweep) items on the SMs in runs of three or four,
    which cross from one head to the next and from one window to the next;
    two images under the grouping."""
    plan = fused_msa.k2p_f32_plan(50, 5, 392, cuda_lib.sm_count(0))
    blocks, sweeps = plan["blocks"], plan["sweeps"]
    runs = [(500 * i // blocks, 500 * (i + 1) // blocks) for i in range(blocks)]
    assert any(i0 // sweeps % 5 != (i1 - 1) // sweeps % 5 for i0, i1 in runs)
    assert any(i0 // (5 * sweeps) != (i1 - 1) // (5 * sweeps) for i0, i1 in runs)
    _attention_case(dev, 2, 25, 392, 5, 10, 8)


@pytest.mark.parametrize("n", [104, 200, 56])
def test_k2p_f32_attention_ragged_chunks_and_tiles(dev, n):
    _attention_case(dev, 2, 6, n, 2, 3, n)


def test_k2p_f32_call_with_and_without_kept_lo(dev):
    rng = np.random.default_rng(25)
    c, heads, nw, nu = 96, 3, 12, 6
    x = _f32(rng, (1, nw, 392, c), 1.0, dev)
    w = (_f32(rng, (3 * c, c), c ** -0.5, dev), _f32(rng, (3 * c,), 0.2, dev),
         _f32(rng, (c, c), c ** -0.5, dev), _f32(rng, (c,), 0.2, dev))
    bias = _f32(rng, (heads, 392, 392), 1.0, dev)
    mask = _grouped_mask(rng, nw, nu, 392, dev)
    args = (x, *w, bias, mask, nu, heads, SCALE)
    before = fused_msa.fused_window_msa_grouped_f32.launches
    got = fused_msa.fused_window_msa_grouped(*args)
    assert fused_msa.fused_window_msa_grouped_f32.launches == before + 1
    _close(got, fused_msa.fused_window_msa_grouped_plain(*args))
    lo = (fused_msa.tf32_lo(w[0]), fused_msa.tf32_lo(w[2]))
    kept = fused_msa.fused_window_msa_grouped_f32(*args, wlo=lo)
    torch.cuda.synchronize()
    assert torch.equal(got, kept)


def _ln_bwd_f64(x, s, g, eps=1e-5):
    """dscale and dbias of the fast-variance LayerNorm in f64."""
    xd, gd = x.double(), g.double()
    mu = xd.mean(1, keepdim=True)
    var = (xd * xd).mean(1, keepdim=True) - mu * mu
    xn = (xd - mu) * torch.rsqrt(var + eps)
    return (gd * xn).sum(0), gd.sum(0)


@pytest.mark.parametrize("rows,c,entry", [
    (115200, 128, "K4b f32"), (28800, 256, "K4b f32"), (7200, 512, "K4b f32"),
    (1800, 1024, "K4b f32"), (115200, 96, "K1 f32 LN"), (50, 1536, "K4b f32")])
def test_k4b_f32_one_launch(dev, rows, c, entry):
    rng = np.random.default_rng(rows + c)
    x = _f32(rng, (rows, c), 2.0, dev) + 0.5
    s = _f32(rng, (c,), 0.2, dev) + 1.0
    g = _f32(rng, (rows, c), 1.0, dev)
    plan = ln.ln_rows_f32_bwd_plan(rows, c, cuda_lib.sm_count(0))
    assert cuda_lib.lib().lavt_layer_norm_rows_bwd_f32_ws(rows, c) == (
        plan["blocks"] + plan["groups"])
    if entry == "K4b f32":
        before = ln.layer_norm_rows_bwd_f32.launches
        fn = lambda: ln.layer_norm_rows_bwd_f32(x, s, g)  # noqa: E731
    else:
        before = None
        fn = lambda: ln.layer_norm_rows_bwd_launch(x, s, g)  # noqa: E731
    got = fn()
    if before is not None:
        assert ln.layer_norm_rows_bwd_f32.launches == before + 1
    _close(got[0], ln.layer_norm_rows_bwd_plain(x, s, g)[0])
    want_s, want_b = _ln_bwd_f64(x, s, g)
    _sums_close(got[1], want_s)
    _sums_close(got[2], want_b)
    again = fn()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
