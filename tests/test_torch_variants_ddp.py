"""PWAM's BatchNorm att_norm (--att_norm_layer_type BN) under data
parallelism, on the CPU under gloo, at world 2.

`parallel.ddp.convert_sync_bn` turns the att_norm's BatchNorm1d
(`image_lang_att.f_query.1`, `.W.1`) into `SyncBatchNorm1d`, whose
statistics are over every process's (B, L) tokens, as the JAX package's
over its sharded batch.  Two processes (test_torch_ddp.py's spawn and
rendezvous) each run a train-mode forward + backward of one PWAM on half
the batch; against one process's nn.BatchNorm1d on the joint batch: the
output and dx (the ranks' halves), the parameter gradients (the ranks'
sum, as DDP reduces them), the running statistics, within 1e-5.
"""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from lavt_rs_tpu_torch import config as C
from lavt_rs_tpu_torch.models import pwam
from lavt_rs_tpu_torch.models.factory import build_model
from lavt_rs_tpu_torch.parallel import ddp
from test_torch_ddp import B, GROUP_TIMEOUT, WORLD, _spawn
from torch_threads import torch_threads  # noqa: F401 (autouse fixture)

DIM, L_IN, HW, NL = 16, 24, 30, 6


def _module():
    m = pwam.PWAM(DIM, L_IN, 2, att_norm=C.AttnNorm.BN)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.3)
    return m.train()


def _inputs():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((WORLD * B, HW, DIM)).astype(np.float32)
    l = rng.standard_normal((WORLD * B, NL, L_IN)).astype(np.float32)
    mask = np.ones((WORLD * B, NL), np.float32)
    mask[0, 4:] = 0.0
    gy = rng.standard_normal((WORLD * B, HW, DIM)).astype(np.float32)
    return [torch.from_numpy(a) for a in (x, l, mask, gy)]


def _run(m, x, l, mask, gy):
    x = x.clone().requires_grad_()
    y = m(x, l, mask)
    (y * gy).sum().backward()
    return {"y": y.detach(), "dx": x.grad,
            "grads": {n: p.grad.clone() for n, p in m.named_parameters()},
            "state": {k: v.clone() for k, v in m.state_dict().items()}}


def _child(rank, tmp):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous",
                            rank=rank, world_size=WORLD,
                            timeout=GROUP_TIMEOUT)
    try:
        m = ddp.convert_sync_bn(_module())
        types = [type(m.image_lang_att.f_query[1]).__name__,
                 type(m.image_lang_att.W[1]).__name__]
        part = slice(rank * B, (rank + 1) * B)
        out = _run(m, *(t[part] for t in _inputs()))
        out["types"] = types
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("ddp_att_norm"))
    return _spawn(_child, (tmp,), tmp)


def test_batch_norm_att_norm_is_cross_process(ranks):
    assert all(r["types"] == ["SyncBatchNorm1d"] * 2 for r in ranks)
    want = _run(_module(), *_inputs())
    close = dict(rtol=1e-5, atol=1e-5)
    for key in ("y", "dx"):
        torch.testing.assert_close(torch.cat([r[key] for r in ranks]),
                                   want[key], **close)
    for name, g in want["grads"].items():
        torch.testing.assert_close(ranks[0]["grads"][name]
                                   + ranks[1]["grads"][name], g, **close)
    for r in ranks:
        for k, v in want["state"].items():
            torch.testing.assert_close(r["state"][k], v, **close)


def test_convert_sync_bn_takes_every_att_norm_batch_norm():
    """A lavt_one with the BN att_norm: its 8 att_norm BatchNorm1d (two a
    stage) and the decoder's 6 BatchNorm2d become the cross-process
    forms, keeping the reference's names."""
    cfg = C.ModelConfig(
        swin=C.SwinConfig(embed_dim=32, depths=(1, 1, 1, 1),
                          num_heads=(1, 2, 4, 8), window_size=4),
        bert=C.BertConfig(num_layers=1, vocab_size=64), img_size=32,
        max_tokens=5, dtype="float32",
        fusion=C.FusionConfig(att_norm=C.AttnNorm.BN))
    model = build_model(cfg, "cpu", train=True)
    names = set(model.state_dict())
    ddp.convert_sync_bn(model)
    assert set(model.state_dict()) == names
    kinds = {}
    for m in model.modules():
        kinds[type(m)] = kinds.get(type(m), 0) + 1
    assert kinds[ddp.SyncBatchNorm1d] == 8
    assert kinds[ddp.SyncBatchNorm2d] == 6
