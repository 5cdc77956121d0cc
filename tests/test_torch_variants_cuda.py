"""The fusion, decoder and 3D PWAM variants on the card, through the
kernels, against their plain routes.  Marked `cuda`; every test skips
without a CUDA device.  Runs without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_variants_cuda.py

lavt_one Swin-B window 12 at 480², BERT with 2 layers, seeded weights with
non-zero language gates and the head's class-1 bias shifted so that the
batch's logit gap has median 0, bs 2, one model per variant group (BCAM;
GACD with ape; EFN with interpolate_before_seg and seg_last; --fuse
simple with lazy_pred; the BN, LN and none att_norm).  In bf16 and f32 a
forward's launches equal the backbone's kernel plan on the dtype's
counters (K1 4 / K11 20 / K3 24 / K4 4, K4 3 under lazy_pred), and the
logits pass chip_smoke.py's gates against the plain f32 route of the
same weights: bf16 argmax agreement >= 0.995 on the pixels whose f32
margin exceeds 0.05; f32 within 1e-2, no argmax change past a 1e-2
margin.  A bf16 train step at bs 2 launches its plan's kernels: with
Swin's drop_rate 0.1 no tail kernel (K3 / K8 / K7).  lavt_video_tiny with
each 3D PWAM kind on an 8-frame 480² clip: the clip's launches equal its
plan (K2p 2 / K10 10) and the pixel gate holds against the plain f32
route.
"""

import dataclasses

import pytest
import torch

from lavt_rs_tpu_torch.config import (AttnNorm, BertConfig, FusionKind,
                                      StageOutput, TPWAMKind, lavt_video_tiny)
from lavt_rs_tpu_torch.models.factory import build_model, make_config
from lavt_rs_tpu_torch.models.pwam import LanguageGate
from lavt_rs_tpu_torch.ops import fused_msa, window_attn
from lavt_rs_tpu_torch.train.optim import TrainConfig
from lavt_rs_tpu_torch.train.step import create_train_state, make_train_step
from test_torch_families_cuda import (FORWARD, F32_GATE, MARGIN, MIN_AGREE,
                                      STEP, _inputs, _launches)

pytestmark = pytest.mark.cuda

IMG, BATCH, FRAMES = 480, 2, 8
HEAD_BIAS = "classifier.conv1_1.bias"
# (fusion kind, att_norm, Swin fields, model fields) of each variant group
VARIANTS = {
    "bcam": (FusionKind.BCAM, AttnNorm.IN, {}, {}),
    "gacd+ape": (FusionKind.GACD, AttnNorm.IN, dict(ape=True), {}),
    "efn+ibs+seg_last": (FusionKind.EFN, AttnNorm.IN, {},
                         dict(interpolate_before_seg=True, seg_last=True)),
    "simple+lazy": (FusionKind.SIMPLE, AttnNorm.IN, {},
                    dict(lazy_pred=True)),
    "BN": (FusionKind.PWAM, AttnNorm.BN, {}, {}),
    "LN": (FusionKind.PWAM, AttnNorm.LN, {}, {}),
    "none": (FusionKind.PWAM, AttnNorm.NONE, {}, {}),
}
VIDEO_KINDS = (TPWAMKind.SEP_INNER, TPWAMKind.T, TPWAMKind.T_COMP,
               TPWAMKind.TS, TPWAMKind.SEQ, TPWAMKind.SEP_SEQ,
               TPWAMKind.SEP_SEQ_INNER)
COUNTERS_3D = {"bfloat16": {"K10": window_attn.window_attention,
                            "K2p": fused_msa.fused_window_msa_grouped},
               "float32": {"K10": window_attn.window_attention_f32,
                           "K2p": fused_msa.fused_window_msa_grouped_f32}}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda:0")


def variant_config(name, **swin):
    kind, att, swin_kw, model_kw = VARIANTS[name]
    cfg = make_config("lavt_one", "base").replace(
        bert=BertConfig(num_layers=2), **model_kw)
    fusion = dataclasses.replace(
        cfg.fusion, kind=kind, att_norm=att,
        stage_output=(StageOutput.LAZY if cfg.lazy_pred
                      else StageOutput.RESIDUAL))
    return cfg.replace(fusion=fusion, swin=dataclasses.replace(
        cfg.swin, **swin_kw, **swin))


def _open_gates(model, g):
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, LanguageGate):
                for lin in (m[0], m[2]):
                    lin.weight.normal_(0.0, 0.05, generator=g)


def _gates(dtype, got, want):
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    sure = (want[..., 1] - want[..., 0]).abs()
    flips = got.argmax(-1) != want.argmax(-1)
    if dtype == "bfloat16":
        agree = 1.0 - flips[sure > MARGIN].float().mean().item()
        assert agree >= MIN_AGREE, agree
    else:
        assert (got - want).abs().max().item() <= F32_GATE
        assert not bool(flips[sure > F32_GATE].any())


@pytest.mark.parametrize("name", VARIANTS)
def test_variant_kernel_route(dev, name):
    g = torch.Generator(device=dev).manual_seed(len(name))
    cfg = variant_config(name)
    model = build_model(cfg, dev, generator=g)
    _open_gates(model, g)
    x = _inputs(dev, g)
    bias = model.get_parameter(HEAD_BIAS)
    with torch.no_grad():
        out = model(*x)
        bias[1] -= (out[..., 1] - out[..., 0]).float().median().to(bias.dtype)
    ref = build_model(cfg.replace(dtype="float32", use_kernels=False), dev)
    ref.load_state_dict(model.state_dict())
    with torch.no_grad():
        want = ref(*x)
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
                                    "K4": 3 if cfg.lazy_pred else 4}
        _gates(dtype, got, want)


@pytest.mark.parametrize("name,drop", [("BN", 0.1), ("bcam", 0.0),
                                       ("simple+lazy", 0.0)])
def test_variant_train_step_launches_its_plan(dev, name, drop):
    g = torch.Generator(device=dev).manual_seed(len(name) + 10)
    cfg = variant_config(name, drop_rate=drop)
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
    assert bool({"K3", "K8", "K7"} & set(plan)) == (drop == 0.0)
    assert plan["K4"] == plan["K4b"] == (3 if cfg.lazy_pred else 4)
    assert torch.isfinite(out["loss"])


@pytest.mark.parametrize("kind", VIDEO_KINDS, ids=lambda k: k.value)
def test_video_kind_kernel_route(dev, kind):
    g = torch.Generator(device=dev).manual_seed(7)
    cfg = lavt_video_tiny(bert=BertConfig(num_layers=2))
    cfg = cfg.replace(tpwam=dataclasses.replace(cfg.tpwam, kind=kind))
    model = build_model(cfg, dev, generator=g)
    _open_gates(model, g)
    clip = torch.randn(1, FRAMES, IMG, IMG, 3, generator=g, device=dev)
    ids = torch.randint(1000, 20000, (1, 22), generator=g, device=dev)
    mask = torch.ones(1, 22, dtype=torch.long, device=dev)
    mask[:, 9:] = 0
    ref = build_model(cfg.replace(dtype="float32", use_kernels=False), dev)
    ref.load_state_dict(model.state_dict())
    with torch.no_grad():
        want = ref(clip, ids, mask)
    for dtype in ("bfloat16", "float32"):
        m = model
        if dtype == "float32":
            m = build_model(cfg.replace(dtype=dtype), dev)
            m.load_state_dict(model.state_dict())
        with torch.no_grad():
            got, launches = _launches(COUNTERS_3D[dtype],
                                      lambda: m(clip, ids, mask))
        plan, _ = m.backbone.kernel_plan(FRAMES, (IMG, IMG),
                                         getattr(torch, dtype).itemsize)
        assert launches == plan == {"K10": 10, "K2p": 2}
        _gates(dtype, got, want)
