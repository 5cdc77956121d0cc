"""The port's fusion variants (BCAM, GACD, EFN, --fuse simple's
LangProject, the BN / LN / none att_norm) against the JAX package's, on
the CPU, in f32.

  * Each module alone: JAX params drawn from a seeded numpy generator,
    carried into the port by `convert/from_jax.py` (strict load), outputs
    within 1e-4 abs + rel; the baselines also against the reference-named
    oracles of tests/torch_oracles.py, whose state_dict the port loads
    strictly (the reference's names).  The masked means divide by the
    mask's sum in f32, with a row whose mask holds one word (GACD,
    LangProject); EFN pools at the 480² stage maps of 120², 60² and 30²
    and not at 15², and refuses an odd pooled side as the JAX reshape
    does.  The att_norm kinds also in train mode: BatchNorm's batch
    statistics, its running statistics with torch's unbiased variance
    (ROADMAP.md §3).
  * `make_fusion` builds each kind's module.
The whole small lavt_one of each variant (`configs`, the model helpers
here): tests/test_torch_fusion_variants_model.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_oracles as oracle
from lavt_rs_tpu import config as JC
from lavt_rs_tpu.models import fusion_baselines as jfb
from lavt_rs_tpu.models import pwam as jpwam
from lavt_rs_tpu_torch import config as C
from lavt_rs_tpu_torch.convert.from_jax import (baseline_state_dict_from_jax,
                                                pwam_2d_state_dict_from_jax)
from lavt_rs_tpu_torch.models import fusion_baselines as fb
from lavt_rs_tpu_torch.models import pwam
from lavt_rs_tpu_torch.models.swin2d import make_fusion
from test_torch_model import BERT, SWIN, random_variables
from torch_threads import torch_threads  # noqa: F401 (autouse fixture)

TOL = 1e-4
IMG, TOKENS = 64, 6


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=msg)


def _inputs(seed, b, hw, dim, l_in, nl, one_word=False):
    """x (b, hw, dim), l (b, nl, l_in), a mask with padded words (row 0
    keeps one word with `one_word`, else four)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, hw, dim)).astype(np.float32)
    l = rng.standard_normal((b, nl, l_in)).astype(np.float32)
    mask = np.ones((b, nl), np.float32)
    mask[0, 1 if one_word else 4:] = 0.0
    return x, l, mask


def _jax_module(jm, seed, *args):
    """A JAX module's seeded params and its output on args."""
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), *args))
    params = random_variables(shapes["params"], np.random.default_rng(seed))
    return params, np.asarray(jm.apply({"params": params}, *args))


def _port_out(pm, *args):
    with torch.no_grad():
        return pm(*(_t(a) for a in args)).numpy()


def _oracle_out(om, x, l, mask):
    """The reference layout: l (B, l_in, N_l), mask (B, N_l, 1)."""
    with torch.no_grad():
        return om.eval()(_t(x), _t(l.transpose(0, 2, 1)),
                         _t(mask[:, :, None])).numpy()


# -- the baselines alone ---------------------------------------------------------

def test_bcam_against_jax_and_the_oracle():
    dim, l_in, hw = 32, 48, 36
    x, l, mask = _inputs(0, 2, hw, dim, l_in, 7)
    params, want = _jax_module(jfb.BCAM(dim=dim, hw=hw), 1, x, l, mask)
    pm = fb.BCAM(dim, hw, l_in=l_in)
    pm.load_state_dict(baseline_state_dict_from_jax(params), strict=True)
    _close(_port_out(pm, x, l, mask), want)

    torch.manual_seed(10)
    om = oracle.BCAMOracle(dim, dim, l_in, hw)
    pm.load_state_dict(om.state_dict(), strict=True)
    _close(_port_out(pm, x, l, mask), _oracle_out(om, x, l, mask))


def test_gacd_against_jax_and_the_oracle():
    """One row's mask keeps a single word: the sentence vector is that
    word (the masked mean's f32 division by the mask's sum)."""
    dim, l_in, hw = 16, 24, 25
    x, l, mask = _inputs(2, 2, hw, dim, l_in, 5, one_word=True)
    params, want = _jax_module(jfb.GACD(dim=dim), 3, x, l, mask)
    pm = fb.GACD(dim, l_in)
    pm.load_state_dict(baseline_state_dict_from_jax(params), strict=True)
    _close(_port_out(pm, x, l, mask), want)

    torch.manual_seed(11)
    om = oracle.GACDOracle(dim, dim, l_in)
    sd = {k.replace("lang_gen.", "lang_gen.project."): v
          for k, v in om.state_dict().items()}
    pm.load_state_dict(sd, strict=True)
    _close(_port_out(pm, x, l, mask), _oracle_out(om, x, l, mask))


@pytest.mark.parametrize("side", [14, 16])
def test_efn_against_jax_and_the_oracle(side):
    """14² = 196 tokens attend at full size, 16² = 256 through the 2x pool
    and the half-pixel bilinear resize back."""
    dim, l_in = 16, 24
    x, l, mask = _inputs(4, 2, side * side, dim, l_in, 6)
    params, want = _jax_module(jfb.EFN(dim=dim), 5, x, l, mask)
    pm = fb.EFN(dim, l_in=l_in)
    pm.load_state_dict(baseline_state_dict_from_jax(params), strict=True)
    _close(_port_out(pm, x, l, mask), want)

    torch.manual_seed(12)
    om = oracle.EFNOracle(dim, dim, l_in)
    pm.load_state_dict(om.state_dict(), strict=True)
    _close(_port_out(pm, x, l, mask), _oracle_out(om, x, l, mask))


@pytest.mark.parametrize("side,pooled", [(120, True), (60, True), (30, True),
                                         (15, False)])
def test_efn_attention_at_the_480_stage_maps(side, pooled):
    """EFNAttention at Swin's 480² stage maps: 120², 60² and 30² are
    pooled (more than 225 tokens), 15² is not; each against JAX."""
    dim, hw = 4, side * side
    assert (hw > fb.EFNAttention.POOL_ABOVE) == pooled
    rng = np.random.default_rng(side)
    m = rng.standard_normal((1, hw, dim)).astype(np.float32)
    l_map = rng.standard_normal((1, hw, dim)).astype(np.float32)
    params, want = _jax_module(jfb.EFNAttention(dim=dim), 6, m, l_map)
    pm = fb.EFNAttention(dim)
    pm.load_state_dict(_efn_attention_state_dict(params), strict=True)
    _close(_port_out(pm, m, l_map), want)


def _efn_attention_state_dict(att):
    """EFNAttention's JAX params -> the port module's state_dict, through
    EFN's mapping (its projections' entries dropped)."""
    dense = {"kernel": np.zeros((1, 1), np.float32),
             "bias": np.zeros(1, np.float32)}
    sd = baseline_state_dict_from_jax({"project": dense,
                                       "lang_project": dense,
                                       "image_lang_att": att})
    return {k.removeprefix("image_lang_att."): v for k, v in sd.items()
            if k.startswith("image_lang_att.")}


def test_efn_refuses_an_odd_pooled_side():
    """17² = 289 tokens pool, and an odd side does not split in 2 x 2
    windows: the JAX reshape fails, and so does the port's."""
    m = np.zeros((1, 17 * 17, 4), np.float32)
    with pytest.raises(TypeError):
        _jax_module(jfb.EFNAttention(dim=4), 0, m, m)
    with pytest.raises(RuntimeError):
        _port_out(fb.EFNAttention(4), m, m)


# -- LangProject, the masked mean and the att_norm kinds -------------------------

def test_masked_mean_and_lang_project():
    """The masked mean in f32 (a one-word row among them) and --fuse
    simple's PWAM (LangProject broadcast over the pixels) against JAX."""
    dim, l_in, hw = 16, 24, 20
    x, l, mask = _inputs(7, 3, hw, dim, l_in, 5, one_word=True)
    mask[2, :] = 1.0
    got = pwam.masked_mean(_t(l), _t(mask)).numpy()
    np.testing.assert_array_equal(got[0], l[0, 0])
    _close(got, np.asarray(jfb._masked_meanpool(jnp.asarray(l),
                                                jnp.asarray(mask))))
    jm = jpwam.PWAM(dim=dim, attention=False)
    params, want = _jax_module(jm, 8, x, l, mask)
    pm = pwam.PWAM(dim, l_in, attention=False)
    pm.load_state_dict(pwam_2d_state_dict_from_jax(params, {}), strict=True)
    assert isinstance(pm.image_lang_att, pwam.LangProject)
    _close(_port_out(pm, x, l, mask), want)


def _pwam_pair(att, seed):
    dim, l_in, hw = 16, 24, 30
    x, l, mask = _inputs(seed, 2, hw, dim, l_in, 6)
    jm = jpwam.PWAM(dim=dim, num_heads=2, att_norm=JC.AttnNorm(att))
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x, l, mask))
    variables = random_variables(dict(shapes), np.random.default_rng(seed))
    pm = pwam.PWAM(dim, l_in, 2, att_norm=C.AttnNorm(att))
    pm.load_state_dict(pwam_2d_state_dict_from_jax(
        variables["params"], variables.get("batch_stats", {})), strict=True)
    return jm, variables, pm, (x, l, mask)


@pytest.mark.parametrize("att", ["BN", "LN", "none"])
def test_att_norm_kinds_eval(att):
    jm, variables, pm, args = _pwam_pair(att, 9)
    names = {k for k in pm.state_dict() if ".f_query." in "." + k}
    want_names = {"image_lang_att.f_query.0.weight",
                  "image_lang_att.f_query.0.bias"}
    if att != "none":
        want_names |= {"image_lang_att.f_query.1.weight",
                       "image_lang_att.f_query.1.bias"}
    if att == "BN":
        want_names |= {f"image_lang_att.f_query.1.{n}" for n in
                       ("running_mean", "running_var", "num_batches_tracked")}
    assert names == want_names
    _close(_port_out(pm.eval(), *args),
           np.asarray(jm.apply(variables, *args)), msg=att)


def test_batch_norm_att_norm_trains_on_batch_statistics():
    """Train mode: the BatchNorm1d att_norm normalizes by the batch's
    statistics over (B, L) and updates its running ones (momentum 0.1 =
    flax's 0.9; torch's running_var unbiased, n / (n - 1) of flax's)."""
    jm, variables, pm, args = _pwam_pair("BN", 10)
    out, mutated = jm.apply(variables, *args, deterministic=False,
                            mutable=["batch_stats"])
    got = pm.train()(*(_t(a) for a in args))
    _close(got.detach().numpy(), np.asarray(out))
    old = variables["batch_stats"]["image_lang_att"]
    new = mutated["batch_stats"]["image_lang_att"]
    n = args[0].shape[0] * args[0].shape[1]
    for jname, name in (("f_query_norm", "f_query"), ("W_norm", "W")):
        bn = getattr(pm.image_lang_att, name)[1]
        _close(bn.running_mean.numpy(), np.asarray(new[jname]["mean"]),
               tol=1e-5)
        biased = (np.asarray(new[jname]["var"])
                  - 0.9 * np.asarray(old[jname]["var"])) / 0.1
        _close(bn.running_var.numpy(),
               0.9 * np.asarray(old[jname]["var"]) + 0.1 * biased * n
               / (n - 1), tol=1e-5)


# -- the whole small lavt_one of each variant --------------------------------------

def configs(kind="pwam", att="IN", swin=None, bert=None, **kw):
    """(JAX config, port config) of the small lavt_one with fusion `kind`
    and att_norm `att`; `swin`, `bert` (overrides) and `kw` (decoder
    flags) on both."""
    swin = dict(SWIN, **(swin or {}))
    bert = dict(BERT, **(bert or {}))
    lazy = kw.get("lazy_pred", False)
    jfusion = JC.FusionConfig(kind=JC.FusionKind(kind),
                              att_norm=JC.AttnNorm(att),
                              stage_output=(JC.StageOutput.LAZY if lazy
                                            else JC.StageOutput.RESIDUAL))
    fusion = C.FusionConfig(kind=C.FusionKind(kind), att_norm=C.AttnNorm(att),
                            stage_output=C.StageOutput(jfusion.stage_output
                                                       .value))
    jcfg = JC.ModelConfig(name="lavt_one", swin=JC.SwinConfig(**swin),
                          bert=JC.BertConfig(**bert), img_size=IMG,
                          max_tokens=TOKENS, fusion=jfusion, **kw)
    cfg = C.ModelConfig(name="lavt_one", swin=C.SwinConfig(**swin),
                        bert=C.BertConfig(**bert), img_size=IMG,
                        max_tokens=TOKENS, dtype="float32", fusion=fusion,
                        **kw)
    return jcfg, cfg


def jax_shapes(jm, img=IMG):
    x = jnp.zeros((1, img, img, 3))
    ids = jnp.ones((1, TOKENS), jnp.int32)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x, ids,
                                            ids))
    return {k: shapes[k] for k in ("params", "batch_stats")}


def inputs(seed, b=2, img=IMG):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, img, img, 3)).astype(np.float32)
    ids = rng.integers(1, 120, (b, TOKENS)).astype(np.int64)
    mask = np.ones((b, TOKENS), np.int64)
    mask[0, 4:] = 0
    return x, ids, mask


def test_make_fusion_kinds():
    for kind, cls in ((C.FusionKind.PWAM, pwam.PWAM),
                      (C.FusionKind.SIMPLE, pwam.PWAM),
                      (C.FusionKind.BCAM, fb.BCAM),
                      (C.FusionKind.GACD, fb.GACD),
                      (C.FusionKind.EFN, fb.EFN)):
        m = make_fusion(C.FusionConfig(kind=kind), 8, 1, hw=16)
        assert type(m) is cls
    simple = make_fusion(C.FusionConfig(kind=C.FusionKind.SIMPLE), 8, 1)
    assert isinstance(simple.image_lang_att, pwam.LangProject)
    with pytest.raises(ValueError, match="H\\*W"):
        make_fusion(C.FusionConfig(kind=C.FusionKind.BCAM), 8, 1)
