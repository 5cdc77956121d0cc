"""The f32 variants of the K1/K2 save mode, K5, K6 and K2 on the CPU (the
window-12 f32 training path), and the softmax forms of the f32 MSA.

* `fused_window_msa_save_f32` (the save mode f32), with and without LN,
  against the JAX save path (`_fwd(..., exact=True, save=True)`) on its
  Pallas kernel in interpret mode: y, q, k, v, P and xn;
* `fused_window_msa_bwd_f32` (K5 f32) and its launches (`bwd_launches`
  with K5 f32's dbias groups and weight-grad splits) composed through
  their plain versions, against `_fused_bwd(..., saved=...)` (the
  residual backward, `_bwd_kernel_resid`);
* `fused_window_msa_bwd_recompute_f32` (K6 f32), with and without LN,
  against `_fused_bwd` with nothing saved (`_bwd_kernel`);
* `fused_window_msa_f32` (K2 f32) against JAX `fused_window_msa`;
* F7: with logits past 80 (a bias table of std 60), the inference plain
  version of K1 f32 (exp(min(s, 80)), `softmax_form`) equals JAX
  `fused_window_msa_ln` (the clamp form) and differs from the exact
  softmax, while the taped route (`FusedWindowMSA`, saving its residuals
  or recomputing them as K6 does) equals JAX's taped forward (`_fwd(...,
  exact=True)`) and its VJP;
* no launch is counted on the CPU; the window-12 f32 training plan at bs
  20 recomputes every block (K6 24, no K5).

Tolerances: 2e-4 of each output's largest magnitude plus 2e-4 relative
against Pallas, as tests/test_torch_k5_launches.py holds K5's launches
(f32 on both sides, sums over C and N in another order).  The kernels
themselves run on the card in tests/test_torch_f32_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from lavt_rs_tpu.ops.pallas import fused_msa as jmsa
from lavt_rs_tpu.ops.window import shift_mask_2d as jshift_mask_2d
from lavt_rs_tpu_torch import config as C
from lavt_rs_tpu_torch.models.factory import build_model
from lavt_rs_tpu_torch.ops import fused_mlp, fused_msa

N, HW, B = 144, 24, 1
TOL = 2e-4
GRADS = ("dx", "dwqkv", "dbqkv", "dwproj", "dbproj", "dbias")
COUNTERS = (fused_msa.fused_window_msa_save_f32,
            fused_msa.fused_window_msa_bwd_f32,
            fused_msa.fused_window_msa_bwd_recompute_f32,
            fused_msa.fused_window_msa_f32, fused_msa.fused_window_msa_ln_f32)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))


def _close(got, want, name="", tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * float(np.abs(want).max()),
                               err_msg=name)


def _launches():
    return tuple(f.launches for f in COUNTERS)


def _inputs(rng, heads, shift=True, bias_std=1.0):
    """x (B, nW, 144, C) f32 at C = 32 heads and the JAX-layout weights
    (wqkv (C, 3C), wproj (C, C)), the LN parameters, the bias table and the
    shift mask of a 24 x 24 map (four windows an image)."""
    f = np.float32
    c, nw = 32 * heads, (HW // 12) ** 2
    return dict(
        x=rng.standard_normal((B, nw, N, c)).astype(f),
        gy=rng.standard_normal((B, nw, N, c)).astype(f),
        ln_s=(1.0 + 0.1 * rng.standard_normal(c)).astype(f),
        ln_b=(0.1 * rng.standard_normal(c)).astype(f),
        wqkv=(rng.standard_normal((c, 3 * c)) * c ** -0.5).astype(f),
        bqkv=(0.1 * rng.standard_normal(3 * c)).astype(f),
        wproj=(rng.standard_normal((c, c)) * c ** -0.5).astype(f),
        bproj=(0.1 * rng.standard_normal(c)).astype(f),
        bias=(bias_std * rng.standard_normal((heads, N, N))).astype(f),
        mask=np.asarray(jshift_mask_2d(HW, HW, 12, 6)) if shift else None,
        heads=heads, scale=32 ** -0.5)


def _port(a):
    """(x, the torch-layout weights (wqkv, bqkv, wproj, bproj), the bias,
    the mask, (ln_s, ln_b)) as CPU tensors."""
    w = (_t(a["wqkv"].T), _t(a["bqkv"]), _t(a["wproj"].T), _t(a["bproj"]))
    mask = None if a["mask"] is None else _t(a["mask"])
    return _t(a["x"]), w, _t(a["bias"]), mask, (_t(a["ln_s"]), _t(a["ln_b"]))


def _jax(a, *keys):
    return [None if a[k] is None else jnp.asarray(a[k]) for k in keys]


@pytest.mark.parametrize("ln,shift", [(True, True), (False, True),
                                      (False, False)])
def test_save_mode_f32_matches_the_pallas_save_path(ln, shift):
    a = _inputs(np.random.default_rng(3 + ln + 2 * shift), 2, shift)
    x, w, bias, mask, lnp = _port(a)
    jx, jwq, jbq, jwp, jbp, jbias, jmask, jls, jlb = _jax(
        a, "x", "wqkv", "bqkv", "wproj", "bproj", "bias", "mask", "ln_s",
        "ln_b")
    with pltpu.force_tpu_interpret_mode():
        out, saved = jmsa._fwd(jx, jwq, jbq, jwp, jbp, jbias, jmask, 2,
                               a["scale"], ln=(jls, jlb) if ln else None,
                               exact=True, save=True)
    before = _launches()
    y, got = fused_msa.fused_window_msa_save_f32(
        x, lnp if ln else None, *w, bias, mask, 2, a["scale"])
    assert _launches() == before
    _close(y, out, "y")
    for name, g, want in zip(("q", "k", "v", "p", "xn"), got, saved):
        _close(g, want, name)
    assert (got[4] is None) == (not ln) and len(saved) == 4 + ln
    # the bf16 entry point takes the f32 route for an f32 tensor
    y2, _ = fused_msa.fused_window_msa_save(x, lnp if ln else None, *w, bias,
                                            mask, 2, a["scale"])
    assert torch.equal(y, y2)


@pytest.mark.parametrize("shift", [False, True])
def test_k5_f32_matches_the_pallas_residual_backward(shift):
    a = _inputs(np.random.default_rng(7 + shift), 2, shift)
    x, w, bias, mask, _ = _port(a)
    jx, jwq, jbq, jwp, jbp, jbias, jmask, jgy = _jax(
        a, "x", "wqkv", "bqkv", "wproj", "bproj", "bias", "mask", "gy")
    with pltpu.force_tpu_interpret_mode():
        _, saved = jmsa._fwd(jx, jwq, jbq, jwp, jbp, jbias, jmask, 2,
                             a["scale"], exact=True, save=True)
        want = jmsa._fused_bwd(jx, jwq, jbq, jwp, jbias, jmask, jgy, 2,
                               a["scale"], saved=saved[:4])
    _, (q, k, v, p, _) = fused_msa.fused_window_msa_save_f32(
        x, None, *w, bias, mask, 2, a["scale"])
    gy = _t(a["gy"])
    m = x.shape[0] * x.shape[1]
    groups = fused_msa.msa_bwd_f32_groups(m, 2, 6)  # a 6-SM plan: 2 groups
    assert groups == 2
    before = _launches()
    got = fused_msa.fused_window_msa_bwd_f32(x, gy, w[0], w[2], (q, k, v, p),
                                             2, a["scale"])
    launches = fused_msa.bwd_launches(x, gy, w[0], w[2], (q, k, v, p), 2,
                                      a["scale"], groups)
    assert _launches() == before
    for name, g, l, wt in zip(GRADS, got, launches, want):
        g, l = g.numpy(), l.numpy()
        t = name in ("dwqkv", "dwproj")
        _close(g.T if t else g, wt, name)
        _close(l.T if t else l, wt, name)


@pytest.mark.parametrize("ln", [True, False])
def test_k6_f32_matches_the_pallas_recompute_backward(ln):
    a = _inputs(np.random.default_rng(11 + ln), 2, True)
    x, w, bias, mask, lnp = _port(a)
    jx, jwq, jbq, jwp, jbias, jmask, jgy, jls, jlb = _jax(
        a, "x", "wqkv", "bqkv", "wproj", "bias", "mask", "gy", "ln_s",
        "ln_b")
    if ln:
        jx = jmsa.layer_norm_f32(jx, jls, jlb)
    with pltpu.force_tpu_interpret_mode():
        want = jmsa._fused_bwd(jx, jwq, jbq, jwp, jbias, jmask, jgy, 2,
                               a["scale"])
    before = _launches()
    got = fused_msa.fused_window_msa_bwd_recompute_f32(
        x, lnp if ln else None, *w, bias, mask, _t(a["gy"]), 2, a["scale"])
    assert _launches() == before
    for name, g, wt in zip(GRADS, got, want):
        g = g.numpy()
        _close(g.T if name in ("dwqkv", "dwproj") else g, wt, name)


@pytest.mark.parametrize("bias_std", [1.0, 60.0])
def test_k2_f32_matches_fused_window_msa(bias_std):
    """K2 f32 called directly takes JAX `fused_window_msa`'s inference
    softmax, exp(min(s, 80)), past 80 too (bias std 60)."""
    a = _inputs(np.random.default_rng(13), 2, True, bias_std)
    x, w, bias, mask, _ = _port(a)
    with pltpu.force_tpu_interpret_mode():
        want = jmsa.fused_window_msa(*_jax(a, "x", "wqkv", "bqkv", "wproj",
                                           "bproj", "bias", "mask"), 2,
                                     a["scale"])
    before = _launches()
    got = fused_msa.fused_window_msa_f32(x, *w, bias, mask, 2, a["scale"])
    assert _launches() == before
    _close(got, want, "y")
    assert torch.equal(got, fused_msa.fused_window_msa(x, *w, bias, mask, 2,
                                                       a["scale"]))


def _taped(a, resid):
    """y and the gradients of the port's taped K1 (`window_msa` under
    autograd: `FusedWindowMSA`, saving its residuals or, with resid
    False, K1 taped then K6) on f32 CPU tensors."""
    x, w, bias, mask, lnp = _port(a)
    leaves = [t.clone().requires_grad_() for t in (x, *lnp, *w, bias)]
    y = fused_msa.window_msa(leaves[0], tuple(leaves[1:3]), *leaves[3:7],
                             leaves[7], mask, a["heads"], a["scale"])
    y.backward(_t(a["gy"]))
    return y.detach(), [t.grad for t in leaves]


@pytest.mark.parametrize("resid", [True, False])
def test_f7_taped_f32_forward_is_exact_past_80(monkeypatch, resid):
    """F7: logits past 80.  K1 f32's inference plain version takes the
    clamp form of JAX `fused_window_msa_ln` (and differs from the exact
    softmax there); the taped route takes the exact form of JAX's taped
    forward (`_fwd(..., exact=True)`, `_vjp_ln_fwd`), and its gradients
    equal JAX's VJP, with the residuals saved (resid) or recomputed (K6:
    `save_residuals_ok` False on both sides)."""
    a = _inputs(np.random.default_rng(17), 2, True, bias_std=60.0)
    x, w, bias, mask, lnp = _port(a)
    jargs = _jax(a, "x", "ln_s", "ln_b", "wqkv", "bqkv", "wproj", "bproj",
                 "bias")
    jmask = _jax(a, "mask")[0]
    if not resid:
        monkeypatch.setattr(fused_msa, "RESID_CAP_BYTES", 0)
        monkeypatch.setenv("LAVT_MSA_RESIDUALS", "0")

    def jfn(*t):
        return jmsa.fused_window_msa_ln(*t, jmask, 2, a["scale"])

    with pltpu.force_tpu_interpret_mode():
        clamp = jfn(*jargs)
        exact = jmsa._fwd(jargs[0], *jargs[3:], jmask, 2, a["scale"],
                          ln=tuple(jargs[1:3]), exact=True)
        jy, vjp = jax.vjp(jfn, *jargs)
        want = vjp(jnp.asarray(a["gy"]))
    np.testing.assert_allclose(np.asarray(jy), np.asarray(exact), rtol=0,
                               atol=0)
    before = _launches()
    infer = fused_msa.fused_window_msa_ln_f32(x, *lnp, *w, bias, mask, 2,
                                              a["scale"])
    assert torch.equal(infer, fused_msa.fused_window_msa_ln(
        x, *lnp, *w, bias, mask, 2, a["scale"]))
    _close(infer, clamp, "inference y")
    assert float(np.abs(infer.numpy() - np.asarray(exact)).max()) > 1e-2
    y, grads = _taped(a, resid)
    assert _launches() == before
    assert fused_msa.save_residuals_ok(B, 4, N, 64, 2, 4) == resid
    _close(y, exact, "taped y")
    names = ("dx", "dln_s", "dln_b", "dwqkv", "dbqkv", "dwproj", "dbproj",
             "dbias")
    for name, g, wt in zip(names, grads, want):
        g = g.numpy()
        _close(g.T if name in ("dwqkv", "dwproj") else g, wt, name)


def test_window12_f32_training_plan_recomputes_at_bs_20():
    """At bs 20 every window-12 f32 block recomputes (`save_residuals_ok`
    is False at every stage): the taped forward is K1 f32 at stages 1-2
    and K2 f32 at stages 3-4, the backward K6 f32 in all 24 blocks; at bs
    8 stage 1 recomputes and stages 2-4 save (K5 22, K6 2)."""
    with torch.device("meta"):
        backbone = build_model(C.lavt_one_base(dtype="float32"),
                               device="meta", train=True).backbone
    stages = ((100, 128, 4), (25, 256, 8), (9, 512, 16), (4, 1024, 32))
    assert not any(fused_msa.save_residuals_ok(20, nw, N, c, h, 4)
                   for nw, c, h in stages)
    assert [fused_msa.save_residuals_ok(8, nw, N, c, h, 4)
            for nw, c, h in stages] == [False, True, True, True]
    counts = backbone.kernel_plan((480, 480), 20, itemsize=4, train=True)[0]
    assert counts == {"K1": 4, "K2": 20, "K6": 24, "K3": 1, "K8": 23,
                      "K7": 24, "K4": 4, "K4b": 4}
    bs8 = backbone.kernel_plan((480, 480), 8, itemsize=4, train=True)[0]
    assert (bs8["K5"], bs8["K6"]) == (22, 2)
    assert fused_mlp.fused_tail_routed(128)
