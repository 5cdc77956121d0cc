"""The port's routing predicates against the JAX package's, on the CPU.

The port takes a hand-written kernel exactly where the JAX package takes a
Pallas kernel: its predicates are copies of the JAX policy
(`lavt_rs_tpu/ops/pallas/fused_msa.py:fused_msa_routed`,
`fused3d_grouped_routed`; `ops/pallas/window_attn.py:attn_fwd_supported`,
`attention_core_bwd_supported`; `ops/pallas/ln.py:
layer_norm_rows_supported`; the `fused_tail` test of
`models/swin2d.py:361-362`).  One parametrised test holds each of them to
the JAX function over Swin-T/S/B/L x window 7 / 12 x 224² / 480² x
itemsize 2 / 4, at every stage's geometry, for the 2D MSA, the 3D MSA of
an 8-frame clip, the LN-MLP tail and the stage norm, and checks the route
each Swin block and video block takes.  The port trains the core route
with K9 wherever it takes K10, which the JAX backward predicate
(`attention_core_bwd_supported`) is held to allow.  Two port extensions
are pinned where they differ: K3 at C = 1024 (Swin-B stage 4, where the
JAX tail runs XLA only because the weights overflow a TPU core's VMEM)
and K10/K9 on the 8-frame video windows (N = 392, above the JAX kernels'
N <= 256 gate).
The JAX package's LAVT_* environment hatches are unset here: the port
ports their defaults.
"""

import itertools

import pytest
import torch

from lavt_rs_tpu import config as JC
from lavt_rs_tpu.models.factory import make_config as jmake_config
from lavt_rs_tpu.ops.pallas import fused_msa as jmsa
from lavt_rs_tpu.ops.pallas import ln as jln
from lavt_rs_tpu.ops.pallas import window_attn as jattn
from lavt_rs_tpu_torch import config as C
from lavt_rs_tpu_torch.models import swin2d, swin3d
from lavt_rs_tpu_torch.models.factory import (build_model,
                                              kernels_without_variant,
                                              make_config)
from lavt_rs_tpu_torch.ops import fused_mlp, fused_msa, ln, window_attn
from lavt_rs_tpu_torch.ops.window import get_window_size_3d
from torch_threads import torch_threads  # noqa: F401 (autouse fixture)

HD = 32
FRAMES = 8
CASES = list(itertools.product(("tiny", "small", "base", "large"), (7, 12),
                               (224, 480), (2, 4)))
HATCHES = ("LAVT_FUSED_MSA", "LAVT_FUSED3D", "LAVT_FUSED_PADDED",
           "LAVT_FAT128")


def _stages(size, img):
    swin = C.SwinConfig.from_size(size)
    side = img // 4
    for c, heads in zip(swin.num_features, swin.num_heads):
        yield side, c, heads
        side = (side + 1) // 2


@pytest.mark.parametrize("size,window,img,itemsize", CASES)
def test_predicates_equal_jax(monkeypatch, size, window, img, itemsize):
    for var in HATCHES:
        monkeypatch.delenv(var, raising=False)
    for side, c, heads in _stages(size, img):
        # 2D MSA: the padded map's windows
        nw = (-(-side // window)) ** 2
        n = window * window
        fused = fused_msa.fused_msa_routed(nw, n, c, heads, itemsize)
        core = window_attn.attn_fwd_supported(nw, n, heads, HD)
        assert fused == jmsa.fused_msa_routed(nw, n, c, heads, itemsize)
        assert core == jattn.attn_fwd_supported(nw, n, heads, HD)
        want = "fused" if fused else "core" if core else "chain"
        attn = swin2d.WindowAttention(c, window, heads)
        assert attn.route(nw, n, itemsize) == want
        # the routes the configs give: window 12 fused, window 7 on K10
        # with K9 in training
        assert want == ("fused" if window == 12 else "core")
        if want == "core":  # the port's training takes K9 there, as JAX
            assert jattn.attention_core_bwd_supported(n, heads, HD, nw)
        # LN-MLP tail (the JAX block's test) and stage norm
        jax_tail = c <= 512 and c % 128 == 0
        assert fused_mlp.fused_tail_routed(c) == (jax_tail or c == 1024)
        rows = 8 * side * side
        assert (ln.layer_norm_rows_routed(rows, c)
                == jln.layer_norm_rows_supported(rows, c))
        # 3D MSA of an 8-frame clip, window (8, w, w), clamped to the input
        ws, _ = get_window_size_3d((FRAMES, side, side), (8, window, window),
                                   (4, window // 2, window // 2))
        nw3 = ((-(-FRAMES // ws[0])) * (-(-side // ws[1]))
               * (-(-side // ws[2])))
        n3 = ws[0] * ws[1] * ws[2]
        grouped = fused_msa.fused3d_grouped_routed(nw3, n3, c, heads,
                                                   itemsize)
        assert grouped == jmsa.fused3d_grouped_routed(nw3, n3, c, heads,
                                                      itemsize)
        assert (window_attn.attn_fwd_supported(nw3, n3, heads, HD)
                == jattn.attn_fwd_supported(nw3, n3, heads, HD) is False)
        blk = swin3d.SwinBlock3D(c, heads, (8, window, window))
        route3 = "core" if n3 <= 400 else "chain"
        assert blk.route(n3, nw3, itemsize) == ("grouped" if grouped
                                                 else route3)
        assert blk.route(n3, nw3, itemsize, train=True) == route3
        # K10 on the (8, 7, 7) windows (the port's extension), the torch
        # chain on (8, 12, 12) where the JAX package runs XLA
        assert (window_attn.attn_fwd_routed_3d(nw3, n3, heads, HD)
                == (n3 <= 400))
        assert (n3 == 1152) == (window == 12 and side >= 12)


W12_TRAIN = {"K1": 4, "K2": 20, "K3": 1, "K4": 4, "K4b": 4, "K5": 24, "K7": 24,
             "K8": 23}
W7_TRAIN = {"K10": 24, "K9": 24, "K3": 1, "K4": 4, "K4b": 4, "K7": 24,
            "K8": 23}
# (config, batch or frames, train, launches per forward or step): the
# counts chip_smoke.py checks on the card, written out by hand
PLANS = [
    (("lavt_one", "base", True), 8, False,
     {"K1": 4, "K11": 20, "K3": 24, "K4": 4}),
    (("lavt_one", "base", True), 8, True, W12_TRAIN),
    (("lavt_one", "base", True), 16, True, dict(W12_TRAIN, K5=22, K6=2)),
    (("lavt_one", "base", False), 8, False, {"K10": 24, "K3": 24, "K4": 4}),
    (("lavt_one", "base", False), 8, True, W7_TRAIN),
    (("lavt_one", "tiny", True), 2, True,
     {"K1": 4, "K2": 8, "K5": 12, "K8": 6, "K7": 6, "K4": 2, "K4b": 2}),
    (("lavt_one", "large", True), 1, False,
     {"K1": 4, "K11": 20, "K3": 2, "K4": 3}),
    (("lavt_video", "tiny", False), 8, False, {"K2p": 2, "K10": 10}),
    (("lavt_video", "tiny", False), 8, True, {"K10": 12, "K9": 12}),
    (("lavt_video", "tiny", True), 8, False, {}),
]


@pytest.mark.parametrize("name,n,train,want", PLANS)
def test_kernel_plan_at_full_width(monkeypatch, name, n, train, want):
    """The backbone's kernel plan (the routes its blocks take, built on
    the meta device) of bf16 models at 480² against hand-written launch
    counts; every part that launches no kernel has a reason."""
    for var in HATCHES:
        monkeypatch.delenv(var, raising=False)
    cfg = make_config(name[0], swin_type=name[1], window12=name[2])
    backbone = build_model(cfg, device="meta", train=train).backbone
    if name[0] == "lavt_video":
        counts, unrouted = backbone.kernel_plan(n, (480, 480), 2, train)
    else:
        counts, unrouted = backbone.kernel_plan((480, 480), n, 2, train)
    assert counts == want
    blocks = sum(cfg.swin.depths)
    if name == ("lavt_video", "tiny", True):
        assert len(unrouted) == blocks
        assert all("N 1152" in why and "JAX: XLA" in why for why in unrouted)
    if name[1] == "tiny" and name[0] == "lavt_one":
        # the torch chain at C = 96, 192 and 768, the plain LN at 96, 192
        assert len(unrouted) == 5
    if name[1] == "large":
        # the torch chain at C = 192, 768 and 1536, the plain LN at 192
        assert len(unrouted) == 4


@pytest.mark.parametrize("drop", [None, "K5"], ids=["window12_train",
                                                    "guard"])
def test_f32_with_kernels_on_the_card_is_refused(monkeypatch, drop):
    """build_model refuses f32 activations with the kernels on a CUDA
    device only where the plan holds a kernel without an f32 variant,
    before it allocates a weight.  Every kernel of the port has one now
    (window12_train: lavt_one training at window 12, the last plan that
    lacked them, passes), so the refusal stays as the guard for a kernel
    added without its variant: with K5's taken away (guard) it names K5
    and raises here, without a card.  The plain versions and the CPU take
    f32 either way."""
    from lavt_rs_tpu_torch.models import factory

    cfg = C.lavt_one_base(dtype="float32")
    assert kernels_without_variant(
        C.lavt_one_base(window12=False, dtype="float32"), True) == []
    if drop is None:
        assert kernels_without_variant(cfg) == []
        assert kernels_without_variant(cfg, True) == []
    else:
        monkeypatch.setattr(factory, "F32_KERNELS",
                            factory.F32_KERNELS - {drop})
        assert kernels_without_variant(cfg, True) == [drop]
        with pytest.raises(NotImplementedError, match=f"launches {drop}, "):
            build_model(cfg, device="cuda", train=True)
        with pytest.raises(NotImplementedError, match="f32 kernel variants"):
            build_model(cfg, device=torch.device("cuda", 0), train=True)
    small = C.ModelConfig(
        swin=C.SwinConfig(embed_dim=32, depths=(1, 1, 1, 1),
                          num_heads=(1, 2, 4, 8), window_size=7),
        bert=C.BertConfig(num_layers=1, vocab_size=120,
                          intermediate_size=64, max_position_embeddings=64),
        img_size=64, dtype="float32")
    assert build_model(small, device="cpu") is not None


@pytest.mark.parametrize("name,size,window12",
                         list(itertools.product(("lavt_one", "lavt_video"),
                                                ("tiny", "small", "base",
                                                 "large"), (False, True))))
def test_make_config_matches_jax(name, size, window12):
    got = make_config(name, swin_type=size, window12=window12)
    want = jmake_config(name, swin_type=size, window12=window12)
    for field in ("embed_dim", "depths", "num_heads", "window_size",
                  "drop_path_rate", "window_size_3d"):
        assert getattr(got.swin, field) == getattr(want.swin, field), field
    assert (got.name, got.max_tokens) == (want.name, want.max_tokens)


@pytest.mark.parametrize("window12", [False, True])
def test_lavt_one_tiny_matches_jax(window12):
    got, want = C.lavt_one_tiny(window12), JC.lavt_one_tiny(window12)
    for field in ("embed_dim", "depths", "num_heads", "window_size"):
        assert getattr(got.swin, field) == getattr(want.swin, field), field
    assert got.name == want.name == "lavt_one"
