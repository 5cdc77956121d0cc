"""--pretrained_swin_weights with a full checkpoint of each fusion,
decoder and 3D PWAM variant, against the JAX package's flag, on the CPU.

The port's small model (test_torch_fusion_variants.py's lavt_one,
test_torch_tpwam_kinds.py's lavt_video) starts from seeded JAX variables
(`from_jax`); a full checkpoint of the same variant with other weights
goes through both packages' flag.  The port loads what the JAX
converters carry and leaves the rest at init: BCAM, GACD and EFN, the
att_norm layers (`f_query.1` / `W.1`), `pre_seg` / `seg_last_conv`,
TSPWAM's branches and the clip-wide PWAM's attention skipped;
LangProject, `absolute_pos_embed` and the 3D kinds' listed convolutions
loaded.  The port's model equals JAX's merged variables through
`from_jax`, bitwise.
"""

import argparse

import numpy as np
import pytest
import torch

from lavt_rs_tpu.convert.pretrained import \
    apply_pretrained_flags as japply_flags
from lavt_rs_tpu.models.factory import build_model as jbuild_model
from lavt_rs_tpu_torch.convert import pretrained
from lavt_rs_tpu_torch.convert.from_jax import state_dict_from_jax
from lavt_rs_tpu_torch.models.factory import build_model
from test_torch_fusion_variants import configs, jax_shapes
from test_torch_model import random_variables
from test_torch_tpwam_kinds import video_configs, video_jax_shapes
from torch_threads import torch_threads  # noqa: F401 (autouse fixture)

CPU = torch.device("cpu")

PRETRAINED_CASES = {
    "bcam": lambda: configs("bcam"),
    "gacd": lambda: configs("gacd"),
    "efn+lazy": lambda: configs("efn", lazy_pred=True),
    "simple+ape+ibs+seg_last": lambda: configs(
        "simple", swin=dict(ape=True), interpolate_before_seg=True,
        seg_last=True),
    "BN": lambda: configs("pwam", "BN"),
    "LN": lambda: configs("pwam", "LN"),
    "ts": lambda: video_configs(dict(kind="ts", kernel_t=(3, 1, 1),
                                     branch_fuse="cat")),
    "t_comp": lambda: video_configs(dict(kind="t_comp", kernel_t=(3, 1, 1))),
    "sep_seq_inner": lambda: video_configs(dict(kind="sep_seq_inner",
                                                kernel_t=(3, 1, 1))),
    "pwam2d": lambda: video_configs(dict(kind="pwam2d")),
    "sep+cat+gates": lambda: video_configs(dict(
        kind="sep", kernel_t=(3, 1, 1), branch_fuse="cat", self_gate=True)),
}


@pytest.mark.parametrize("case", PRETRAINED_CASES)
def test_pretrained_flag_loads_what_jax_loads(case, tmp_path):
    jcfg, cfg = PRETRAINED_CASES[case]()
    jm = jbuild_model(jcfg)
    video = cfg.name == "lavt_video"
    shapes = video_jax_shapes(jm) if video else jax_shapes(jm)
    jvars = random_variables(shapes, np.random.default_rng(11))
    pm = build_model(cfg, CPU)
    pm.load_state_dict(state_dict_from_jax(jvars, cfg), strict=True)
    before = {k: v.clone() for k, v in pm.state_dict().items()}
    src = build_model(cfg, CPU, generator=torch.Generator().manual_seed(5))
    path = str(tmp_path / "full.pth")
    torch.save({"model": src.state_dict()}, path)
    args = argparse.Namespace(pretrained_swin_weights=path)
    records = pretrained.apply_pretrained_flags(pm, cfg, args)
    want = state_dict_from_jax(japply_flags(jvars, jcfg, args), cfg)
    got = pm.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    loaded = set(records[0]["loaded"])
    assert loaded and all(not torch.equal(got[k], before[k])
                          for k in loaded if got[k].is_floating_point()
                          and got[k].numel() > 1)
    fusion = {k for k in loaded if ".fusion." in k}
    if case in ("bcam", "gacd", "efn+lazy", "ts"):
        assert not fusion, sorted(fusion)[:4]
    if case == "sep+cat+gates":
        assert fusion and not any(f".fusion.{m}." in k for k in fusion
                                  for m in ("vis_fuse", "f_fuse", "t_gate_v"))
    if case == "simple+ape+ibs+seg_last":
        assert "backbone.absolute_pos_embed" in loaded
        assert any(".image_lang_att.project." in k for k in fusion)
        assert not any(".pre_seg." in k or ".seg_last_conv." in k
                       for k in loaded)
    if case in ("BN", "LN"):
        assert fusion and not any(".f_query.1." in k for k in loaded)
