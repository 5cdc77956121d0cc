"""Data parallelism (counterpart of `lavt_rs_tpu/parallel/mesh.py`): one
process per card, torch's DistributedDataParallel, and a cross-process
BatchNorm.

The reference trains one process per GPU under DDP over NCCL (reference
train.py:591-592, utils.py:215-232); the JAX package shards the batch
over a 'data' mesh axis in one jitted program, where the gradient mean
and the BatchNorm statistics come out global.  Here:
  * `init_distributed` reads torchrun's RANK, WORLD_SIZE and LOCAL_RANK
    and joins (or creates) the default process group: NCCL for the card,
    gloo for the CPU;
  * `wrap_ddp` / `unwrap`: the model in DDP, with
    `find_unused_parameters` on (see `wrap_ddp`);
  * `SyncBatchNorm2d`, `SyncBatchNorm1d` / `convert_sync_bn`: BatchNorm
    over the global batch, by `all_reduce` alone (gloo has no all_gather
    of CUDA tensors, which `nn.SyncBatchNorm` takes, and `nn.SyncBatchNorm`
    does not run on CPU tensors): the decoders' BatchNorm2d, VLT's
    sentence BatchNorm1d and PWAM's BatchNorm1d att_norm
    (--att_norm_layer_type bn, over (B, C, L) tokens), as the JAX
    package's batch statistics are over its sharded batch.
Each process's batch is its own: -b is per process, as in the reference
(DistributedSampler); the JAX package's -b is the global batch.
"""

from __future__ import annotations

import datetime
import os
from typing import Tuple

import torch
import torch.distributed as dist
import torch.nn as nn
from torch.nn.parallel import DistributedDataParallel

# a collective that waits longer than this fails instead of hanging
TIMEOUT = datetime.timedelta(minutes=30)


def init_distributed(device: str) -> Tuple[int, int, torch.device]:
    """(rank, world, device) of this process.  A process group already
    initialized (e.g. by a launcher of its own) is used as it is;
    otherwise one is created at WORLD_SIZE > 1 (torchrun's env://
    rendezvous): NCCL for a CUDA device, gloo for the CPU.  A bare `cuda`
    becomes `cuda:LOCAL_RANK`; an explicit index is kept (several
    processes may share a card).  A CUDA device without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"--device {device}: no CUDA device is "
                               "available (pass --device cpu for the CPU)")
        if dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
    if not (dist.is_available() and dist.is_initialized()):
        world = int(os.environ.get("WORLD_SIZE", "1"))
        if world == 1:
            return 0, 1, dev
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                rank=int(os.environ["RANK"]),
                                world_size=world, timeout=TIMEOUT)
    return dist.get_rank(), dist.get_world_size(), dev


def wrap_ddp(model: nn.Module, device: torch.device
             ) -> DistributedDataParallel:
    """`model` under DDP with `find_unused_parameters` on, with or without
    --use_checkpoint.  The reference turns it off under --use_checkpoint
    (train.py:591-592) because its checkpoint is the reentrant one, which
    DDP's search for unused parameters does not take; the port's is the
    non-reentrant one, which it does.  And the search is needed: the last
    stage's language gate of lavt_one and of the hybrid video model feeds
    no output (the stage output is the fusion's, and no stage follows), so
    its weights get no gradient in any step, and DDP without the search
    fails on the step after."""
    return DistributedDataParallel(
        model, device_ids=[device.index] if device.type == "cuda" else None,
        find_unused_parameters=True)


def unwrap(model: nn.Module) -> nn.Module:
    """The module inside DDP (the model itself otherwise)."""
    return model.module if isinstance(model, DistributedDataParallel) \
        else model


def _channel_dims(x):
    """The dims BatchNorm reduces over (all but C = dim 1) and C's
    broadcast shape: (N, C), (N, C, L) or (N, C, H, W)."""
    c = x.shape[1]
    return ((0,) + tuple(range(2, x.dim())),
            (1, c) + (1,) * (x.dim() - 2))


class _SyncBatchNormFn(torch.autograd.Function):
    """Training-mode BatchNorm over every process's batch ((N, C), (N, C,
    L) or (N, C, H, W)): forward and backward each take one all_reduce of
    per-channel sums."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        x32 = x.float()
        dims, shape = _channel_dims(x)
        count = torch.full((1,), x32.numel() // x32.shape[1],
                           dtype=torch.float32, device=x.device)
        stats = torch.cat([x32.sum(dims), (x32 * x32).sum(dims), count])
        dist.all_reduce(stats)
        c = x.shape[1]
        n = stats[2 * c]
        mean = stats[:c] / n
        var = (stats[c:2 * c] / n - mean * mean).clamp(min=0.0)
        invstd = torch.rsqrt(var + eps)
        ctx.save_for_backward(x, weight, mean, invstd, n)
        ctx.mark_non_differentiable(mean, var, n)
        y = ((x32 - mean.view(shape)) * (invstd * weight).view(shape)
             + bias.view(shape))
        return y.to(x.dtype), mean, var, n

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar, _dn):
        x, weight, mean, invstd, n = ctx.saved_tensors
        c = x.shape[1]
        dims, shape = _channel_dims(x)
        dy = dy.float()
        xhat = (x.float() - mean.view(shape)) * invstd.view(shape)
        local = torch.cat([dy.sum(dims), (dy * xhat).sum(dims)])
        sums = local.clone()
        dist.all_reduce(sums)
        dx = (invstd * weight).view(shape) * (
            dy - (sums[:c] / n).view(shape)
            - xhat * (sums[c:] / n).view(shape))
        # dweight and dbias of this process's batch: DDP reduces them
        return dx.to(x.dtype), local[c:], local[:c], None


class _SyncBatchNorm:
    """A BatchNorm whose training-mode statistics are those of every
    process's batch together (the JAX package's under a data-sharded jit),
    by all_reduce only, so it runs under gloo on CPU and CUDA tensors alike.
    The running variance takes torch's unbiased factor n / (n - 1), n the
    global count.  In eval mode it is the torch BatchNorm it derives from,
    whose state-dict names it keeps."""

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        y, mean, var, n = _SyncBatchNormFn.apply(x, self.weight, self.bias,
                                                 self.eps)
        with torch.no_grad():
            self.num_batches_tracked.add_(1)
            m = (1.0 / float(self.num_batches_tracked)
                 if self.momentum is None else self.momentum)
            self.running_mean.lerp_(mean, m)
            self.running_var.lerp_(var * n / (n - 1), m)
        return y


class SyncBatchNorm2d(_SyncBatchNorm, nn.BatchNorm2d):
    """nn.BatchNorm2d over every process's batch (the decoders)."""


class SyncBatchNorm1d(_SyncBatchNorm, nn.BatchNorm1d):
    """nn.BatchNorm1d over every process's batch (VLT's sentence
    projection, PWAM's BN att_norm)."""


_SYNC = {nn.BatchNorm2d: SyncBatchNorm2d, nn.BatchNorm1d: SyncBatchNorm1d}


def convert_sync_bn(model: nn.Module) -> nn.Module:
    """Replace every nn.BatchNorm2d / nn.BatchNorm1d of `model` by its
    SyncBatchNorm holding the same parameters and buffers (so an optimizer
    made before or after sees the same tensors); returns the model."""
    for name, child in list(model.named_children()):
        if type(child) in _SYNC:
            if not (child.affine and child.track_running_stats):
                raise ValueError(f"{name}: a SyncBatchNorm needs an affine "
                                 "BatchNorm that tracks its statistics")
            sync = _SYNC[type(child)](child.num_features, child.eps,
                                      child.momentum, device="meta")
            for key in ("weight", "bias", "running_mean", "running_var",
                        "num_batches_tracked"):
                setattr(sync, key, getattr(child, key))
            setattr(model, name, sync.train(child.training))
        else:
            convert_sync_bn(child)
    return model
