"""lavt_video on the card at the clip lengths of A2D evaluation (16
consecutive frames: two temporal windows, a live temporal shift of 4) and
of whole YTVOS videos (13 and 20 frames: temporal padding), through the
kernels (K2p at stage 1, K10 in the other blocks) against the plain f32
route of the same weights.  Marked `cuda`; every test skips without a
CUDA device.  Runs without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_video_cuda.py

Video Swin-T at 224² (C = 96 at stage 1 takes the grouped route, as at
480²), BERT with 2 layers, seeded weights with non-zero language gates.
The launches per clip equal the backbone's kernel plan, and the logits
pass chip_smoke.py's pixel gate: argmax agreement >= 0.995 on the pixels
whose f32 margin exceeds 0.05.
"""

import pytest
import torch

from lavt_rs_tpu_torch.config import BertConfig, lavt_video_tiny
from lavt_rs_tpu_torch.models.factory import build_model
from lavt_rs_tpu_torch.models.pwam import LanguageGate
from lavt_rs_tpu_torch.ops import fused_msa, window_attn

pytestmark = pytest.mark.cuda

IMG, TOKENS = 224, 22
MARGIN, MIN_AGREE = 0.05, 0.995


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


@pytest.mark.parametrize("frames", [16, 13, 20])
def test_long_clip_kernel_route(dev, frames):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = lavt_video_tiny().replace(bert=BertConfig(num_layers=2),
                                    img_size=IMG)
    g = torch.Generator(device=dev).manual_seed(frames)
    model = build_model(cfg, dev, generator=g)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, LanguageGate):
                for lin in (m[0], m[2]):
                    lin.weight.normal_(0.0, 0.05, generator=g)
    ref = build_model(cfg.replace(dtype="float32", use_kernels=False), dev)
    ref.load_state_dict(model.state_dict())
    clip = torch.randn(1, frames, IMG, IMG, 3, generator=g, device=dev)
    ids = torch.randint(1000, 20000, (1, TOKENS), generator=g, device=dev)
    mask = torch.ones(1, TOKENS, dtype=torch.long, device=dev)
    mask[:, 9:] = 0
    kernels = {"K2p": fused_msa.fused_window_msa_grouped,
               "K10": window_attn.window_attention}
    for fn in kernels.values():
        fn.launches = 0
    with torch.no_grad():
        got = model(clip, ids, mask)
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in kernels.items()}
        want = ref(clip, ids, mask)
    plan, _ = model.backbone.kernel_plan(frames, (IMG, IMG))
    assert launches == plan == {"K2p": 2, "K10": 10}
    assert got.shape == want.shape == (frames, IMG, IMG, 2)
    assert bool(torch.isfinite(got).all())
    sure = (want[..., 1] - want[..., 0]).abs() > MARGIN
    agree = (got.argmax(-1) == want.argmax(-1))[sure].float().mean().item()
    assert agree >= MIN_AGREE, agree
