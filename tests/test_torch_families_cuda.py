"""The other families (lavt, lts, vlt, lavt_vlt) on the card, through the
kernels, against their plain routes.  Marked `cuda`; every test skips
without a CUDA device.  Runs without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_families_cuda.py

Swin-B window 12 at 480² (every block on lavt_one's routes: K1 at stages
1-2, K11 at 3-4, K3 in every tail), BERT with 2 layers, seeded weights with
non-zero language gates and each head's class-1 bias shifted so that the
batch's logit gap has median 0 (a gap spreading less than 0.25, the VLT
heads', first scaled up to it), bs 2.  In bf16 and f32 a forward's launches equal the backbone's
kernel plan (K4 4 for lavt, 3 for the stage-2-4 backbones) on the
dtype's counters, and the logits pass chip_smoke.py's gates against the
plain f32 route of the same weights: bf16 argmax agreement >= 0.995 on
the pixels whose f32 margin exceeds 0.05; f32 within 1e-2, no argmax
change past a 1e-2 margin.  A bf16 train step at bs 2 launches its
plan's kernels.
"""

import pytest
import torch

from lavt_rs_tpu_torch.config import BertConfig
from lavt_rs_tpu_torch.models.factory import build_model, make_config
from lavt_rs_tpu_torch.models.pwam import LanguageGate
from lavt_rs_tpu_torch.ops import fused_mlp, fused_msa, fused_msa_2d, ln
from lavt_rs_tpu_torch.ops import window_attn
from lavt_rs_tpu_torch.train.optim import TrainConfig
from lavt_rs_tpu_torch.train.step import create_train_state, make_train_step

pytestmark = pytest.mark.cuda

IMG, TOKENS, BATCH = 480, 20, 2
MARGIN, MIN_AGREE, F32_GATE = 0.05, 0.995, 1e-2
GAP_STD = 0.25  # chip_smoke.FAMILY_GAP_STD
HEAD_BIAS = {"lavt": "model.classifier.conv1_1.bias",
             "lts": "classifier.conv1_1.bias",
             "vlt": "classifier.decoding.classifier.bias",
             "lavt_vlt": "classifier.decoding.classifier.bias"}
# the counters of a forward's kernels, by the plan's names, per dtype
FORWARD = {"bfloat16": {"K1": fused_msa.fused_window_msa_ln,
                        "K11": fused_msa_2d.fused_window_msa_2d,
                        "K3": fused_mlp.fused_ln_mlp,
                        "K4": ln.layer_norm_rows},
           "float32": {"K1": fused_msa.fused_window_msa_ln_f32,
                       "K11": fused_msa_2d.fused_window_msa_2d_f32,
                       "K3": fused_mlp.fused_ln_mlp_f32,
                       "K4": ln.layer_norm_rows_f32}}
STEP = {"K1": fused_msa.fused_window_msa_ln, "K2": fused_msa.fused_window_msa,
        "K3": fused_mlp.fused_ln_mlp, "K4": ln.layer_norm_rows,
        "K4b": ln.layer_norm_rows_bwd, "K5": fused_msa.fused_window_msa_bwd,
        "K6": fused_msa.fused_window_msa_bwd_recompute,
        "K7": fused_mlp.fused_ln_mlp_bwd,
        "K8": fused_mlp.fused_ln_mlp_droppath,
        "K9": window_attn.attention_core_bwd,
        "K10": window_attn.window_attention}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda:0")


def _inputs(dev, g):
    image = torch.randn(BATCH, IMG, IMG, 3, generator=g, device=dev)
    ids = torch.randint(1000, 20000, (BATCH, TOKENS), generator=g, device=dev)
    mask = torch.ones(BATCH, TOKENS, dtype=torch.long, device=dev)
    mask[:, 9:] = 0
    return image, ids, mask


def _model(name, dev, g):
    cfg = make_config(name, "base").replace(bert=BertConfig(num_layers=2))
    model = build_model(cfg, dev, generator=g)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, LanguageGate):
                for lin in (m[0], m[2]):
                    lin.weight.normal_(0.0, 0.05, generator=g)
    return cfg, model


def _launches(counters, fn):
    for f in counters.values():
        f.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {k: f.launches for k, f in counters.items() if f.launches}


@pytest.mark.parametrize("name", sorted(HEAD_BIAS))
def test_family_kernel_route(dev, name):
    g = torch.Generator(device=dev).manual_seed(len(name))
    cfg, model = _model(name, dev, g)
    x = _inputs(dev, g)
    bias = model.get_parameter(HEAD_BIAS[name])
    weight = model.get_parameter(HEAD_BIAS[name][:-4] + "weight")
    with torch.no_grad():  # the logit gap centred, its std >= GAP_STD
        out = model(*x)
        gap = (out[..., 1] - out[..., 0]).float()
        k = max(1.0, GAP_STD / gap.std().item())
        weight.mul_(k)
        bias.mul_(k)
        bias[1] -= (gap.median() * k).to(bias.dtype)
    ref = build_model(cfg.replace(dtype="float32", use_kernels=False), dev)
    ref.load_state_dict(model.state_dict())
    with torch.no_grad():
        want = ref(*x)
    sure = (want[..., 1] - want[..., 0]).abs()
    for dtype in ("bfloat16", "float32"):
        m = model
        if dtype == "float32":
            m = build_model(cfg.replace(dtype=dtype), dev)
            m.load_state_dict(model.state_dict())
        with torch.no_grad():
            got, launches = _launches(FORWARD[dtype], lambda: m(*x))
        plan, _ = m.backbone.kernel_plan((IMG, IMG), BATCH,
                                         getattr(torch, dtype).itemsize)
        assert launches == plan == {"K1": 4, "K11": 20, "K3": 24,
                                    "K4": 4 if name == "lavt" else 3}
        assert got.shape == want.shape == (BATCH, IMG, IMG, 2)
        assert bool(torch.isfinite(got).all())
        flips = got.argmax(-1) != want.argmax(-1)
        if dtype == "bfloat16":
            agree = 1.0 - flips[sure > MARGIN].float().mean().item()
            assert agree >= MIN_AGREE, agree
        else:
            assert (got - want).abs().max().item() <= F32_GATE
            assert not bool(flips[sure > F32_GATE].any())


@pytest.mark.parametrize("name", sorted(HEAD_BIAS))
def test_family_train_step_launches_its_plan(dev, name):
    g = torch.Generator(device=dev).manual_seed(len(name) + 10)
    cfg = make_config(name, "base").replace(bert=BertConfig(num_layers=2))
    model = build_model(cfg, dev, generator=g, train=True)
    tcfg = TrainConfig()
    step = make_train_step(model, *create_train_state(model, tcfg), tcfg)
    image, ids, mask = _inputs(dev, g)
    batch = {"image": image, "ids": ids, "mask": mask,
             "target": torch.randint(0, 2, (BATCH, IMG, IMG), generator=g,
                                     device=dev)}
    out, launches = _launches(STEP, lambda: step(
        batch, torch.Generator(device=dev).manual_seed(1)))
    plan, _ = model.backbone.kernel_plan((IMG, IMG), BATCH, 2, True)
    assert launches == plan
    assert plan["K4"] == plan["K4b"] == (4 if name == "lavt" else 3)
    assert torch.isfinite(out["loss"])
