"""The f32 variants of K1, K11, K3 and K4 on the CPU: their routes, the
narrowed f32 refusal and `--no_bf16`, and their entry points against the
Pallas kernels they replace at f32 (K10, K2p and K9 f32:
tests/test_torch_f32_attn.py; K8, K7 and K4b f32:
tests/test_torch_f32_train.py).

* `kernel_plan` of `lavt_one_base` at itemsize 4 (480², bs 8): inference
  is K1 4, K11 20, K3 24, K4 4, the bf16 plan; the training plan takes K6
  at stage 1, where f32 residuals exceed the TPU's save cap.
* `build_model` refuses f32 with the kernels on the card only where the
  plan holds a kernel without an f32 variant, naming the missing
  variants, before any allocation: every plan passes it now (window-12
  lavt_one training too, tests/test_torch_f32_msa_train.py), and a test
  that takes K5's variant away sees the guard name it.
* `--no_bf16` parses to float32, and its help says what runs on the card.
* `fused_window_msa_ln_f32`, `fused_window_msa_2d_f32`, `fused_ln_mlp_f32`
  and `layer_norm_rows_f32` take their plain versions on CPU tensors
  (counting no launch) and agree with the Pallas kernels in interpret
  mode on f32 inputs, within the tolerances of test_torch_kernels_plain.py
  (1e-4 for the MSA: f32 sums over C and N in another order, through
  softmax; 1e-5 for the LayerNorm and the MLP).  The kernels themselves
  run on the card in tests/test_torch_f32_cuda.py.

Whole-model f32 parity with JAX at window 12 is held by
`tests/test_torch_model.py::test_full_model_logit_parity` (dtype float32).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from lavt_rs_tpu.ops.pallas import experimental as jexp
from lavt_rs_tpu.ops.pallas import fused_mlp as jmlp
from lavt_rs_tpu.ops.pallas import fused_msa as jmsa
from lavt_rs_tpu.ops.pallas import ln as jln
from lavt_rs_tpu.ops.window import shift_mask_2d as jshift_mask_2d
from lavt_rs_tpu_torch import config as C
from lavt_rs_tpu_torch.cli import test as cli_test
from lavt_rs_tpu_torch.cli.args import model_config_from_args
from lavt_rs_tpu_torch.models.factory import (build_model,
                                              kernels_without_variant)
from lavt_rs_tpu_torch.ops import fused_mlp, fused_msa, fused_msa_2d, ln
from torch_threads import torch_threads  # noqa: F401 (autouse fixture)

TOL_MSA = 1e-4
TOL = 1e-5
F32_COUNTERS = (fused_msa.fused_window_msa_ln_f32,
                fused_msa_2d.fused_window_msa_2d_f32,
                fused_mlp.fused_ln_mlp_f32, ln.layer_norm_rows_f32)


def _t(a):
    return torch.from_numpy(np.array(a, order="C"))


def _launches():
    return tuple(f.launches for f in F32_COUNTERS)


@pytest.fixture(scope="module")
def base_backbone():
    with torch.device("meta"):
        return build_model(C.lavt_one_base(dtype="float32"),
                           device="meta").backbone


def test_f32_inference_plan_is_the_bf16_plan(base_backbone):
    counts, unrouted = base_backbone.kernel_plan((480, 480), 8, itemsize=4)
    assert counts == {"K1": 4, "K11": 20, "K3": 24, "K4": 4}
    assert unrouted == []
    assert base_backbone.kernel_plan((480, 480), 8, itemsize=2)[0] == counts


def test_f32_training_plan_takes_k6_at_stage_1(base_backbone):
    """At bs 8 an f32 stage-1 block's residuals exceed the TPU's 192 MiB
    save cap (`save_residuals_ok(8, 100, 144, 128, 4, itemsize=4)`), so
    its backward recomputes (K6), where bf16 saves them (K5)."""
    assert not fused_msa.save_residuals_ok(8, 100, 144, 128, 4, itemsize=4)
    assert fused_msa.save_residuals_ok(8, 100, 144, 128, 4, itemsize=2)
    blocks = base_backbone.layers[0].blocks
    assert [b.kernels((120, 120), 8, 4, True) for b in blocks] == [
        ["K1", "K3", "K6", "K7"], ["K1", "K8", "K6", "K7"]]
    counts = base_backbone.kernel_plan((480, 480), 8, itemsize=4,
                                       train=True)[0]
    assert counts["K6"] == 2 and counts["K5"] == 22


@pytest.mark.parametrize("drop,missing", [(None, []), ("K5", ["K5"])],
                         ids=["train", "guard"])
def test_f32_refused_where_a_variant_is_missing(monkeypatch, drop, missing):
    """Window-12 lavt_one training, the last plan whose save mode and MSA
    backward lacked f32 variants, has them now (the save mode f32, K5 f32,
    K6 f32, K2 f32) and passes the refusal at any batch size (train; here,
    with no card, a later step raises something else).  The check stays
    the guard for a kernel added without its f32 variant: with K5's taken
    away (guard) the plan names K5, K6's partner at another batch size,
    and `build_model` refuses before any allocation."""
    from lavt_rs_tpu_torch.models import factory

    cfg = C.lavt_one_base(dtype="float32")
    if drop is not None:
        monkeypatch.setattr(factory, "F32_KERNELS",
                            factory.F32_KERNELS - {drop})
    assert kernels_without_variant(cfg, True) == missing
    if missing:
        with pytest.raises(NotImplementedError,
                           match="f32 kernel variants") as err:
            build_model(cfg, device="cuda", train=True)
        assert all(k in str(err.value) for k in missing)
    elif not torch.cuda.is_available():
        with pytest.raises(Exception) as err:
            build_model(cfg, device="cuda", train=True)
        assert not isinstance(err.value, NotImplementedError), err.value


@pytest.mark.parametrize("cfg,train", [
    (C.lavt_one_base(window12=False, dtype="float32"), False),
    (C.lavt_video_tiny().replace(dtype="float32"), False),
    (C.lavt_video_tiny().replace(dtype="float32"), True),
    (C.lavt_one_base(window12=False, dtype="float32"), True),
], ids=["window7", "lavt_video", "lavt_video_train", "window7_train"])
def test_f32_passes_the_refusal_with_k10_k2p_k9(cfg, train):
    """Window-7 inference (K10, K3, K4), lavt_video inference (K2p, K10)
    and its training step (K10's save mode, K9), and the window-7
    lavt_one training step (K10's save mode, K9, K3, K8, K7, K4, K4b)
    have every f32 variant: `build_model` does not refuse them (without a
    card it fails later, at the first allocation, with another error)."""
    assert kernels_without_variant(cfg, train) == []
    if torch.cuda.is_available():
        pytest.skip("a card would build the model")
    with pytest.raises(Exception) as err:
        build_model(cfg, device="cuda", train=train)
    assert not isinstance(err.value, NotImplementedError), err.value


@pytest.mark.parametrize("swin_type", ["base", "tiny", "large"])
def test_window12_f32_inference_passes_the_refusal(swin_type):
    """Every kernel of a window-12 lavt_one inference plan has an f32
    variant (Swin-T and Swin-L add the C = 96 / 192 / 384 / 768 / 1536
    routes, which take K1, K11 or the torch chain); the plain versions
    and the CPU take f32 everywhere."""
    from lavt_rs_tpu_torch.models.factory import make_config

    cfg = make_config("lavt_one", swin_type, window12=True, dtype="float32")
    assert kernels_without_variant(cfg) == []
    assert kernels_without_variant(cfg.replace(use_kernels=False), True) == []
    assert kernels_without_variant(cfg.replace(dtype="bfloat16"), True) == []


def test_no_bf16_parses_to_float32_and_says_what_runs():
    parser = cli_test.get_parser()
    args = parser.parse_args(["--window12", "--no_bf16"])
    assert args.bf16 is False
    cfg = model_config_from_args(args)
    assert cfg.dtype == "float32" and cfg.swin.window_size == 12
    assert kernels_without_variant(cfg) == []
    assert model_config_from_args(parser.parse_args([])).dtype == "bfloat16"
    assert kernels_without_variant(cfg, True) == []  # window-12 training
    text = " ".join(parser.format_help().split())
    assert ("for inference and training (lavt_one at windows 12 and 7, "
            "lavt_video; every kernel has an f32 variant: K1, K2, the K1/K2 "
            "save mode, K5, K6, K11, K3, K4, K10, K2p, K9, K8, K7, K4b)"
            ) in text
    window7 = model_config_from_args(parser.parse_args(["--no_bf16"]))
    assert window7.swin.window_size == 7 and kernels_without_variant(
        window7) == []


def _msa_inputs(rng, c, heads, lead):
    f = np.float32
    n = 144
    return dict(
        x=rng.standard_normal(lead + (c,)).astype(f),
        ln_s=(1.0 + 0.1 * rng.standard_normal(c)).astype(f),
        ln_b=(0.1 * rng.standard_normal(c)).astype(f),
        wqkv=(rng.standard_normal((c, 3 * c)) * c ** -0.5).astype(f),
        bqkv=(0.1 * rng.standard_normal(3 * c)).astype(f),
        wproj=(rng.standard_normal((c, c)) * c ** -0.5).astype(f),
        bproj=(0.1 * rng.standard_normal(c)).astype(f),
        bias=rng.standard_normal((heads, n, n)).astype(f),
        scale=(c // heads) ** -0.5)


@pytest.mark.parametrize("shift", [False, True])
def test_k1_f32_matches_fused_window_msa_ln(shift):
    rng = np.random.default_rng(170 + shift)
    c, heads, hw = 64, 2, 24
    a = _msa_inputs(rng, c, heads, (1, (hw // 12) ** 2, 144))
    mask = jshift_mask_2d(hw, hw, 12, 6) if shift else None
    with pltpu.force_tpu_interpret_mode():
        want = jmsa.fused_window_msa_ln(
            *(jnp.asarray(a[k]) for k in ("x", "ln_s", "ln_b", "wqkv", "bqkv",
                                          "wproj", "bproj", "bias")),
            mask, heads, a["scale"])
    before = _launches()
    args = (_t(a["x"]), _t(a["ln_s"]), _t(a["ln_b"]), _t(a["wqkv"].T),
            _t(a["bqkv"]), _t(a["wproj"].T), _t(a["bproj"]), _t(a["bias"]),
            None if mask is None else _t(np.asarray(mask)), heads, a["scale"])
    got = fused_msa.fused_window_msa_ln_f32(*args)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL_MSA,
                               atol=TOL_MSA)
    # the K1 entry takes the same route for f32 (on the card: K1 f32)
    torch.testing.assert_close(fused_msa.fused_window_msa_ln(*args), got,
                               rtol=0, atol=0)
    assert _launches() == before


@pytest.mark.parametrize("shift", [False, True])
def test_k11_f32_matches_fused_window_msa_2d(shift):
    """The non-square 36 x 24 map (3 x 2 windows)."""
    rng = np.random.default_rng(171 + shift)
    c, heads, hp, wp = 64, 2, 36, 24
    a = _msa_inputs(rng, c, heads, (1, hp, wp))
    mask = jshift_mask_2d(hp, wp, 12, 6) if shift else None
    with pltpu.force_tpu_interpret_mode():
        want = jexp.fused_window_msa_2d(
            *(jnp.asarray(a[k]) for k in ("x", "wqkv", "bqkv", "wproj",
                                          "bproj", "bias")),
            mask, heads, a["scale"], 12)
    before = _launches()
    args = (_t(a["x"]), _t(a["wqkv"].T), _t(a["bqkv"]), _t(a["wproj"].T),
            _t(a["bproj"]), _t(a["bias"]),
            None if mask is None else _t(np.asarray(mask)), heads, a["scale"],
            12)
    got = fused_msa_2d.fused_window_msa_2d_f32(*args)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL_MSA,
                               atol=TOL_MSA)
    torch.testing.assert_close(fused_msa_2d.fused_window_msa_2d(*args), got,
                               rtol=0, atol=0)
    assert _launches() == before


@pytest.mark.parametrize("m,c", [(64, 128), (40, 256)])
def test_k3_f32_matches_fused_ln_mlp(m, c):
    rng = np.random.default_rng(172 + c)
    f = np.float32
    hidden = 4 * c
    x = rng.standard_normal((m, c)).astype(f) * 2 + 0.5
    g = (1.0 + 0.1 * rng.standard_normal(c)).astype(f)
    be = (0.1 * rng.standard_normal(c)).astype(f)
    w1 = (rng.standard_normal((c, hidden)) * c ** -0.5).astype(f)
    b1 = (0.1 * rng.standard_normal(hidden)).astype(f)
    w2 = (rng.standard_normal((hidden, c)) * hidden ** -0.5).astype(f)
    b2 = (0.1 * rng.standard_normal(c)).astype(f)
    with pltpu.force_tpu_interpret_mode():
        want = jmlp.fused_ln_mlp(*(jnp.asarray(a) for a in
                                   (x, g, be, w1, b1, w2, b2)))
    before = _launches()
    args = (_t(x), _t(g), _t(be), _t(w1.T), _t(b1), _t(w2.T), _t(b2))
    got = fused_mlp.fused_ln_mlp_f32(*args)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    # its three launches' plain versions compose to it (the LN rows by the
    # f32 launch's two-pass variance)
    xn = ln.layer_norm_rows_f32_launch(args[0], args[1], args[2],
                                       two_pass=True)
    torch.testing.assert_close(xn, fused_mlp.mlp_ln_rows(*args[:3]), rtol=0,
                               atol=0)
    h = fused_mlp.gemm_bias_gelu(xn, args[3], args[4])
    torch.testing.assert_close(
        fused_mlp.gemm_residual(h, args[5], args[6], args[0]), got,
        rtol=1e-6, atol=1e-6)
    assert _launches() == before


@pytest.mark.parametrize("rows,c", [(64, 128), (24, 1024)])
def test_k4_f32_matches_layer_norm_rows(rows, c):
    rng = np.random.default_rng(173 + c)
    f = np.float32
    x = rng.standard_normal((rows, c)).astype(f) * 3 + 1
    s = (1.0 + 0.1 * rng.standard_normal(c)).astype(f)
    b = (0.1 * rng.standard_normal(c)).astype(f)
    with pltpu.force_tpu_interpret_mode():
        want = jln.layer_norm_rows(jnp.asarray(x), jnp.asarray(s),
                                   jnp.asarray(b))
    before = _launches()
    got = ln.layer_norm_rows_f32(_t(x), _t(s), _t(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    torch.testing.assert_close(ln.layer_norm_rows(_t(x), _t(s), _t(b)), got,
                               rtol=0, atol=0)
    torch.testing.assert_close(ln.layer_norm_rows_f32_launch(_t(x), _t(s),
                                                             _t(b)), got,
                               rtol=0, atol=0)
    assert _launches() == before
