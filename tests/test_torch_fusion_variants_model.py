"""The whole small lavt_one of each fusion variant against the JAX
package's, on the CPU, in f32 (test_torch_fusion_variants.py's model:
embed 48, depths (1, 1, 2, 1), window 12, 64², 2 BERT layers).

  * Each fusion kind and att_norm: logits within 1e-4 of JAX's from the
    same variables (`from_jax`, strict load).
  * --fuse simple's state_dict also into JAX through the reference
    converter `torch2jax`, which maps LangProject (it maps neither the
    baselines nor the att_norm layers).
  * BCAM's learned projection is bound to the config's image size: the
    stage maps it is built for, and a forward at another size raises.
"""

import jax
import numpy as np
import pytest
import torch

from lavt_rs_tpu.convert import torch2jax
from lavt_rs_tpu.models.factory import build_model as jbuild_model
from lavt_rs_tpu_torch.convert.from_jax import state_dict_from_jax
from lavt_rs_tpu_torch.models import fusion_baselines as fb
from lavt_rs_tpu_torch.models import pwam
from lavt_rs_tpu_torch.models.factory import build_model
from test_torch_families import random_state_dict, tree_shapes
from test_torch_fusion_variants import (IMG, _close, _port_out, configs,
                                        inputs, jax_shapes)
from test_torch_model import random_variables
from torch_threads import torch_threads  # noqa: F401 (autouse fixture)

# (fusion kind, att_norm) of the whole-model cases
VARIANTS = (("simple", "IN"), ("bcam", "IN"), ("gacd", "IN"), ("efn", "IN"),
            ("pwam", "BN"), ("pwam", "LN"), ("pwam", "none"))


@pytest.mark.parametrize("kind,att", VARIANTS)
def test_lavt_one_logits_from_jax_variables(kind, att):
    jcfg, cfg = configs(kind, att)
    jm = jbuild_model(jcfg)
    variables = random_variables(jax_shapes(jm), np.random.default_rng(7))
    pm = build_model(cfg, device="cpu")
    pm.load_state_dict(state_dict_from_jax(variables, cfg), strict=True)
    fusion = pm.backbone.layers[0].fusion
    assert type(fusion) is {"simple": pwam.PWAM, "pwam": pwam.PWAM,
                            "bcam": fb.BCAM, "gacd": fb.GACD,
                            "efn": fb.EFN}[kind]
    arrays = inputs(1)
    want = np.asarray(jax.jit(jm.apply)(variables, *arrays))
    got = _port_out(pm, *arrays)
    assert got.shape == (2, IMG, IMG, 2)
    _close(got, want, msg=f"{kind} {att}")


def test_lang_project_through_the_reference_converter():
    """--fuse simple: the port's state_dict (the reference's names) into
    JAX by `torch2jax.convert_lavt_one`, whose tree is the JAX model's."""
    jcfg, cfg = configs("simple")
    jm = jbuild_model(jcfg)
    pm = build_model(cfg, device="cpu")
    pm.load_state_dict(random_state_dict(pm, np.random.default_rng(11)))
    variables = torch2jax.convert_lavt_one(
        {k: v.numpy() for k, v in pm.state_dict().items()}, jcfg)
    shapes = jax_shapes(jm)
    for part in ("params", "batch_stats"):
        assert tree_shapes(variables[part]) == tree_shapes(shapes[part])
    arrays = inputs(2)
    _close(_port_out(pm, *arrays),
           np.asarray(jax.jit(jm.apply)(variables, *arrays)))


def test_bcam_is_bound_to_the_config_image_size():
    """BCAM's a_proj at each stage projects to that stage's H*W, computed
    from img_size as PatchEmbed and PatchMerging compute the maps; the
    model refuses another size."""
    _, cfg = configs("bcam")
    pm = build_model(cfg, device="cpu", generator=torch.Generator()
                     .manual_seed(0))
    assert pm.backbone.stage_tokens(480) == [14400, 3600, 900, 225]
    assert pm.backbone.stage_tokens(70) == [324, 81, 25, 9]
    assert [layer.fusion.a_proj.out_features
            for layer in pm.backbone.layers] == [256, 64, 16, 4]
    x, ids, mask = inputs(3, 1, img=96)
    with pytest.raises(ValueError, match="img_size"):
        _port_out(pm, x, ids, mask)
