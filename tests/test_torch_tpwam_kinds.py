"""The 3D PWAM kinds of the port's lavt_video against the JAX package's,
on the CPU, in f32.

  * Each kind alone (SepTPWAMInner, SepSeqTPWAM with and without
    `inner_only` and the P3D-C residual, TPWAM and TPWAMComp, TSPWAM summed
    or concatenated with its token-wise or (1, 3, 3) Conv3d reduce and
    --mm_3x3, SeqTPWAM with and without the residual): JAX params drawn
    from a seeded numpy generator, carried into the port by
    `from_jax.tpwam_state_dict_from_jax` (strict load), outputs within
    1e-4 abs + rel; SepTPWAMInner and SepSeqTPWAM also against the
    reference-named oracles of tests/torch_oracles.py.
  * Each 3D PWAM flag of the CLIs builds its class through build_model.
  * The small lavt_video of tests/test_torch_video.py (embed 32, depths
    (2, 2, 2, 2), 4-frame 64² clips, 1 BERT layer; `video_configs` and
    the model helpers here) with the decoder options: seg_last returns
    the decoder's logits without the final upsample, NHWC at the stage-1
    map without interpolate_before_seg and at the input size with it (JAX
    `lavt.py:244-248`); lazy_pred with interpolate_before_seg.  With the
    kinds: tests/test_torch_tpwam_kinds_video.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_oracles as oracle
from lavt_rs_tpu import config as JC
from lavt_rs_tpu.models import tpwam as jtpwam
from lavt_rs_tpu.models.factory import build_model as jbuild_model
from lavt_rs_tpu_torch import config as C
from lavt_rs_tpu_torch.convert.from_jax import (state_dict_from_jax,
                                                tpwam_state_dict_from_jax)
from lavt_rs_tpu_torch.models import tpwam
from lavt_rs_tpu_torch.models.factory import build_model
from test_torch_fusion_variants import IMG, TOKENS, _close, _port_out
from test_torch_model import random_variables
from torch_threads import torch_threads  # noqa: F401 (autouse fixture)

DIM, HEADS, L_IN = 16, 2, 24
# (TPWAMConfig fields) of each module case, and the port class it builds
KINDS = (
    (dict(kind="sep_inner", kernel_t=(3, 1, 1)), "SepTPWAMInner"),
    (dict(kind="t", kernel_t=(3, 1, 1)), "TPWAM"),
    (dict(kind="t_comp", kernel_t=(3, 1, 1)), "TPWAM"),
    (dict(kind="t_comp", kernel_t=(3, 3, 3)), "TPWAM"),
    (dict(kind="ts", kernel_t=(3, 1, 1), branch_fuse="cat"), "TSPWAM"),
    (dict(kind="ts", kernel_t=(3, 1, 1), branch_fuse="cat",
          fuse_kernel=(1, 3, 3)), "TSPWAM"),
    (dict(kind="ts", kernel_t=(3, 1, 1), branch_fuse="sum",
          mm_single_conv="3x3"), "TSPWAM"),
    (dict(kind="ts", kernel_t=(3, 3, 3), branch_fuse="cat",
          mm_single_conv="3x3"), "TSPWAM"),
    (dict(kind="seq", kernel_t=(3, 1, 1), kernel_s=(1, 3, 3)), "SeqTPWAM"),
    (dict(kind="seq", kernel_t=(3, 1, 1), seq_residual=True), "SeqTPWAM"),
    (dict(kind="sep_seq", kernel_t=(3, 1, 1)), "SepSeqTPWAM"),
    (dict(kind="sep_seq", kernel_t=(3, 1, 1), seq_residual=True),
     "SepSeqTPWAM"),
    (dict(kind="sep_seq_inner", kernel_t=(3, 3, 3), seq_residual=True),
     "SepSeqTPWAM"),
)


def _tpwam_cfg(cfgmod, fields):
    return cfgmod.TPWAMConfig(**{
        k: (cfgmod.TPWAMKind(v) if k == "kind" else
            cfgmod.BranchFuse(v) if k == "branch_fuse" else v)
        for k, v in fields.items()})


def _module_inputs(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 4, 6, 6, DIM)).astype(np.float32)
    l = rng.standard_normal((2, 5, L_IN)).astype(np.float32)
    mask = np.ones((2, 5), np.float32)
    mask[0, 3:] = 0.0
    return x, l, mask


@pytest.mark.parametrize("fields,cls", KINDS,
                         ids=[f"{f['kind']}-{i}" for i, (f, _) in
                              enumerate(KINDS)])
def test_each_kind_against_jax(fields, cls):
    x, l, mask = _module_inputs(len(fields))
    jm = jtpwam.build_tpwam(_tpwam_cfg(JC, fields), dim=DIM, num_heads=HEADS,
                            dropout=0.0, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x, l,
                                            mask))
    params = random_variables(shapes["params"], np.random.default_rng(5))
    want = np.asarray(jm.apply({"params": params}, x, l, mask))
    pm = tpwam.build_tpwam(_tpwam_cfg(C, fields), DIM, HEADS, L_IN)
    assert type(pm).__name__ == cls
    pm.load_state_dict(tpwam_state_dict_from_jax(params), strict=True)
    _close(_port_out(pm.eval(), x, l, mask), want, msg=str(fields))


def _oracle_case(om, pm, seed):
    x, l, mask = _module_inputs(seed)
    pm.load_state_dict(om.state_dict(), strict=True)
    with torch.no_grad():
        want = om.eval()(torch.from_numpy(x),
                         torch.from_numpy(np.ascontiguousarray(
                             l.transpose(0, 2, 1))),
                         torch.from_numpy(mask[:, :, None])).numpy()
    _close(_port_out(pm.eval(), x, l, mask), want)


def test_sep_tpwam_inner_against_the_oracle():
    torch.manual_seed(0)
    om = oracle.SepTPWAMInnerOracle(DIM, L_IN, heads=HEADS)
    _oracle_case(om, tpwam.SepTPWAMInner(DIM, L_IN, HEADS), 1)


@pytest.mark.parametrize("inner,res", [(False, False), (False, True),
                                       (True, False), (True, True)])
def test_sep_seq_tpwam_against_the_oracle(inner, res):
    torch.manual_seed(1)
    om = oracle.SepSeqTPWAMOracle(DIM, L_IN, heads=HEADS, ksq=(1, 3, 3),
                                  res=res, inner=inner)
    _oracle_case(om, tpwam.SepSeqTPWAM(DIM, L_IN, HEADS, kernel_sq=(1, 3, 3),
                                       residual=res, inner_only=inner), 2)


# -- lavt_video -----------------------------------------------------------------

VSWIN = dict(embed_dim=32, depths=(2, 2, 2, 2), num_heads=(1, 2, 4, 8),
             window_size=7)
VBERT = dict(vocab_size=120, num_layers=1, intermediate_size=256,
             max_position_embeddings=64)
FRAMES = 4


def video_configs(tpwam=None, fuse="pwam", **kw):
    """(JAX config, port config) of test_torch_video.py's small lavt_video
    with a 3D PWAM config (`tpwam`: TPWAMConfig fields), fusion kind
    `fuse` and decoder flags `kw`."""
    tpwam = tpwam or {}
    so = "lazy" if kw.get("lazy_pred") else "residual"

    def tp(cfgmod):
        fields = {k: (cfgmod.TPWAMKind(v) if k == "kind" else
                      cfgmod.BranchFuse(v) if k == "branch_fuse" else v)
                  for k, v in tpwam.items()}
        return cfgmod.TPWAMConfig(**fields)

    jcfg = JC.ModelConfig(
        name="lavt_video", swin=JC.SwinConfig(**VSWIN),
        bert=JC.BertConfig(**VBERT), img_size=IMG, max_tokens=TOKENS,
        tpwam=tp(JC), fusion=JC.FusionConfig(
            kind=JC.FusionKind(fuse), stage_output=JC.StageOutput(so)), **kw)
    cfg = C.ModelConfig(
        name="lavt_video", swin=C.SwinConfig(**VSWIN),
        bert=C.BertConfig(**VBERT), img_size=IMG, max_tokens=TOKENS,
        dtype="float32", tpwam=tp(C), fusion=C.FusionConfig(
            kind=C.FusionKind(fuse), stage_output=C.StageOutput(so)), **kw)
    return jcfg, cfg


def video_jax_shapes(jm):
    vid = jnp.zeros((1, FRAMES, IMG, IMG, 3))
    ids = jnp.ones((1, TOKENS), jnp.int32)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), vid, ids,
                                            ids))
    return {k: shapes[k] for k in ("params", "batch_stats")}


def video_inputs(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1, FRAMES, IMG, IMG, 3)).astype(np.float32)
    ids = rng.integers(1, 120, (1, TOKENS)).astype(np.int64)
    mask = np.ones((1, TOKENS), np.int64)
    mask[0, 4:] = 0
    return x, ids, mask


def video_pair(jcfg, cfg, seed=7):
    jm = jbuild_model(jcfg)
    variables = random_variables(video_jax_shapes(jm),
                                 np.random.default_rng(seed))
    pm = build_model(cfg, device="cpu")
    pm.load_state_dict(state_dict_from_jax(variables, cfg), strict=True)
    return jm, variables, pm


def test_each_video_kind_builds_from_its_flag():
    """The CLI's 3D PWAM flags build their classes through build_model
    (the non-SEP kinds ignore the fusion kind, as the JAX layers)."""
    from lavt_rs_tpu_torch.cli.args import model_config_from_args
    from lavt_rs_tpu_torch.cli.train import get_parser

    for flag, cls in (("--ts_pwam", tpwam.TSPWAM), ("--t_pwam", tpwam.TPWAM),
                      ("--t_pwam_comp", tpwam.TPWAM),
                      ("--sep_t_pwam_inner", tpwam.SepTPWAMInner),
                      ("--seq_t_pwam", tpwam.SeqTPWAM),
                      ("--sep_seq_t_pwam", tpwam.SepSeqTPWAM),
                      ("--sep_seq_t_pwam_inner", tpwam.SepSeqTPWAM)):
        cfg = model_config_from_args(get_parser().parse_args(
            ["--model", "lavt_video", "--swin_type", "tiny", flag,
             "--bcam"]))
        pm = build_model(cfg, "meta")
        assert all(type(layer.fusion) is cls for layer in pm.backbone.layers)


@pytest.mark.parametrize("flags,side", [
    (dict(seg_last=True), IMG // 4),
    (dict(interpolate_before_seg=True, seg_last=True), IMG),
    (dict(lazy_pred=True, interpolate_before_seg=True), IMG)],
    ids=["seg_last", "ibs+seg_last", "lazy+ibs"])
def test_lavt_video_decoders(flags, side):
    jm, variables, pm = video_pair(*video_configs(**flags))
    arrays = video_inputs(3)
    want = np.asarray(jax.jit(jm.apply)(variables, *arrays))
    got = _port_out(pm, *arrays)
    assert got.shape == want.shape == (FRAMES, side, side, 2)
    _close(got, want, msg=str(flags))
