"""Weight carry-over and independence of the PyTorch port, on the CPU.

* JAX variables -> `state_dict_from_jax` -> port -> `convert_lavt_one`
  gives back the JAX variables leaf by leaf (exactly: only transposes).
* A reference-layout PyTorch state dict (tests/torch_lavt.py) loads into
  the port as it is, and both give the same logits (rtol 1e-3 / atol 2e-4,
  the tolerance of test_full_model_parity.py).
* The port imports and runs with JAX, flax, transformers and the JAX
  package made unimportable.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from lavt_rs_tpu.config import BertConfig as JBertConfig
from lavt_rs_tpu.config import ModelConfig as JModelConfig
from lavt_rs_tpu.config import SwinConfig as JSwinConfig
from lavt_rs_tpu.config import lavt_video_tiny as jlavt_video_tiny
from lavt_rs_tpu.convert.torch2jax import convert_lavt_one, convert_lavt_video
from lavt_rs_tpu.models.factory import build_model as jbuild_model
from lavt_rs_tpu_torch import config as C
from lavt_rs_tpu_torch.convert.from_jax import state_dict_from_jax
from lavt_rs_tpu_torch.models.factory import build_model
from test_torch_model import random_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SWIN = dict(embed_dim=32, depths=(1, 2, 1, 1), num_heads=(1, 2, 4, 8),
            window_size=12)
BERT = dict(vocab_size=100, num_layers=2, intermediate_size=128,
            max_position_embeddings=32)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


def test_round_trip_through_convert_lavt_one():
    jcfg = JModelConfig(name="lavt_one", swin=JSwinConfig(**SWIN),
                        bert=JBertConfig(**BERT), img_size=96, max_tokens=5)
    jm = jbuild_model(jcfg)
    ids = jnp.ones((1, 5), jnp.int32)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            jnp.zeros((1, 96, 96, 3)), ids, ids))
    shapes = {k: shapes[k] for k in ("params", "batch_stats")}
    variables = random_variables(shapes, np.random.default_rng(11))

    cfg = C.ModelConfig(swin=C.SwinConfig(**SWIN), bert=C.BertConfig(**BERT),
                        img_size=96, max_tokens=5, dtype="float32")
    port = build_model(cfg, device="cpu")
    port.load_state_dict(state_dict_from_jax(variables, cfg), strict=True)
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    back = _flat(convert_lavt_one(sd, jcfg))
    want = _flat(variables)
    assert sorted(back) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_round_trip_through_convert_lavt_video():
    """lavt_video: JAX variables -> port -> `convert_lavt_video` gives the
    same variables back (Conv3d kernels, SepTPWAM branches, 3D tables)."""
    swin = dict(embed_dim=32, depths=(1, 1, 2, 1), num_heads=(1, 2, 4, 8),
                window_size=7)
    jcfg = jlavt_video_tiny().replace(swin=JSwinConfig(**swin),
                                      bert=JBertConfig(**BERT), img_size=64,
                                      max_tokens=5, num_frames=2)
    jm = jbuild_model(jcfg)
    ids = jnp.ones((1, 5), jnp.int32)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 2, 64, 64, 3)), ids, ids))
    shapes = {k: shapes[k] for k in ("params", "batch_stats")}
    variables = random_variables(shapes, np.random.default_rng(13))

    cfg = C.lavt_video_tiny().replace(swin=C.SwinConfig(**swin),
                                      bert=C.BertConfig(**BERT), img_size=64,
                                      max_tokens=5, num_frames=2,
                                      dtype="float32")
    port = build_model(cfg, device="cpu")
    port.load_state_dict(state_dict_from_jax(variables, cfg), strict=True)
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    back = _flat(convert_lavt_video(sd, jcfg))
    want = _flat(variables)
    assert sorted(back) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_reference_state_dict_loads_as_is():
    from transformers import BertConfig as HFConfig

    from torch_lavt import LAVTOneOracle

    torch.manual_seed(0)
    embed, depths, heads = 48, (1, 1, 2, 1), (3, 6, 12, 24)
    hf = HFConfig(vocab_size=120, hidden_size=768, num_hidden_layers=1,
                  num_attention_heads=12, intermediate_size=256,
                  max_position_embeddings=64, hidden_act="gelu",
                  attn_implementation="eager")
    oracle = LAVTOneOracle(embed, depths, heads, window=12, bert_cfg=hf).eval()
    cfg = C.ModelConfig(
        swin=C.SwinConfig(embed_dim=embed, depths=depths, num_heads=heads,
                          window_size=12),
        bert=C.BertConfig(vocab_size=120, num_layers=1, intermediate_size=256,
                          max_position_embeddings=64),
        img_size=96, max_tokens=6, dtype="float32")
    port = build_model(cfg, device="cpu")
    missing, unexpected = port.load_state_dict(oracle.state_dict(), strict=False)
    # recent HF versions keep position_ids out of the state dict; v3.0.2,
    # which the reference checkpoints were saved with, stored it
    assert set(missing) <= {"text_encoder.embeddings.position_ids"}
    assert not unexpected

    rng = np.random.default_rng(12)
    img = rng.standard_normal((2, 96, 96, 3)).astype(np.float32)
    ids = torch.from_numpy(rng.integers(1, 120, (2, 6)))
    mask = torch.ones(2, 6, dtype=torch.long)
    mask[1, 3:] = 0
    with torch.no_grad():
        want = oracle(torch.from_numpy(img.transpose(0, 3, 1, 2)), ids, mask)
        got = port(torch.from_numpy(img), ids, mask)
    np.testing.assert_allclose(got.numpy(), want.permute(0, 2, 3, 1).numpy(),
                               rtol=1e-3, atol=2e-4)


def test_port_runs_without_jax():
    code = """
import sys
for name in ("jax", "jaxlib", "flax", "transformers", "lavt_rs_tpu"):
    sys.modules[name] = None
import torch
import lavt_rs_tpu_torch
from lavt_rs_tpu_torch import config as C
from lavt_rs_tpu_torch.convert import from_jax
from lavt_rs_tpu_torch.eval.refcoco_eval import fwd_iou
from lavt_rs_tpu_torch.models.factory import build_model
from lavt_rs_tpu_torch.ops import cuda_lib, dropout, fused_mlp, fused_msa, ln
from lavt_rs_tpu_torch import losses, metrics
from lavt_rs_tpu_torch.train.optim import TrainConfig
from lavt_rs_tpu_torch.train.step import create_train_state, make_train_step
import chip_smoke
cfg = C.ModelConfig(swin=C.SwinConfig(embed_dim=32, depths=(1, 1, 1, 1),
                                      num_heads=(1, 2, 4, 8)),
                    bert=C.BertConfig(vocab_size=50, num_layers=1,
                                      intermediate_size=64,
                                      max_position_embeddings=16),
                    dtype="float32")
model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
image = torch.randint(0, 256, (1, 96, 96, 3), dtype=torch.uint8)
ids = torch.randint(1, 50, (1, 1, 4))
mask = torch.ones(1, 1, 4, dtype=torch.long)
target = torch.zeros(1, 96 * 96 // 8, dtype=torch.uint8)
inter, union = fwd_iou(model, image, ids, mask, target)
assert inter.shape == (1, 1) and bool(torch.isfinite(union).all())
model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0),
                    train=True)
tcfg = TrainConfig()
step = make_train_step(model, *create_train_state(model, tcfg), tcfg)
out = step({"image": image, "ids": ids[:, 0], "mask": mask[:, 0],
            "target": torch.zeros(1, 96, 96, dtype=torch.long)},
           torch.Generator().manual_seed(1))
assert bool(torch.isfinite(out["loss"]))
from lavt_rs_tpu_torch.eval.video_eval import clip_iou
vcfg = C.lavt_video_tiny().replace(
    swin=C.SwinConfig(embed_dim=32, depths=(1, 1, 1, 1), num_heads=(1, 2, 4, 8),
                      window_size=7),
    bert=cfg.bert, dtype="float32")
video_model = build_model(vcfg, device="cpu",
                          generator=torch.Generator().manual_seed(0))
video = torch.randint(0, 256, (2, 64, 64, 3), dtype=torch.uint8)
inter, union = clip_iou(video_model, video, ids[0, 0], mask[0, 0], 1,
                        torch.zeros(64, 64, dtype=torch.uint8))
assert inter.item() == 0 and bool(torch.isfinite(union))
from lavt_rs_tpu_torch.train.step import make_video_train_step
video_model = build_model(vcfg, device="cpu",
                          generator=torch.Generator().manual_seed(0), train=True)
step = make_video_train_step(video_model, *create_train_state(video_model, tcfg),
                             tcfg)
out = step({"video": video[None], "ids": ids[:, 0], "mask": mask[:, 0],
            "target": torch.zeros(1, 64, 64, dtype=torch.long),
            "valid_index": torch.tensor([1])}, torch.Generator().manual_seed(1))
assert bool(torch.isfinite(out["loss"]))
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "flax")
       and sys.modules[m] is not None]
assert not bad, bad
print("ok")
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")
