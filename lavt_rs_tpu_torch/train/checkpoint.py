"""Checkpoint save/restore with the reference's retention policies
(counterpart of `lavt_rs_tpu/train/checkpoint.py`).

Behavioral contract (reference train.py:738-829, utils.py:200-212):
  * one file per epoch, in the reference's `torch.save` dict format:
    {"model", "optimizer", "lr_scheduler", "epoch", "args"}, `args` the
    run's `argparse.Namespace`; lavt's (a model whose `CHECKPOINT_DICTS`
    are ("model", "bert_model")) holds its segmentation net and its BERT
    as the reference's two dicts, {"model", "bert_model", ...}
    (train.py:596-605);
  * named `epoch_{N:04d}[_{tag}].pth`: the JAX package's directory names
    with `.pth` (RefCOCO tags them with the val metrics, train.py:761-762);
  * `keep`: only the newest N stay (remove_extra_checkpoints_on_master,
    utils.py:205-212);
  * saved on rank 0 only (save_on_master);
  * read with `torch.load(..., weights_only=True)`: tensors, plain
    containers and `argparse.Namespace`, nothing else unpickled.

A file is written beside its final name and renamed into place, so an
interrupted save leaves no truncated checkpoint for `latest_checkpoint`.
"""

from __future__ import annotations

import argparse
import os
import re
from typing import List, Optional, Tuple

import torch
import torch.nn as nn

from ..utils.logging import is_main_process

_NAME_RE = re.compile(r"epoch_(\d+)(_.*)?\.pth$")
_STATE_KEYS = ("model", "bert_model", "optimizer", "lr_scheduler", "epoch")


def model_dicts(model: nn.Module) -> dict:
    """The model's tensors as the reference's checkpoint entries: {"model":
    state_dict}, or one entry per submodule named in the model's
    `CHECKPOINT_DICTS`."""
    parts = getattr(model, "CHECKPOINT_DICTS", None)
    if parts is None:
        return {"model": model.state_dict()}
    return {p: getattr(model, p).state_dict() for p in parts}


def load_model_dicts(model: nn.Module, ckpt: dict) -> None:
    """Load `model_dicts`' entries of `ckpt` into the model (strict)."""
    parts = getattr(model, "CHECKPOINT_DICTS", None)
    if parts is None:
        model.load_state_dict(ckpt["model"])
    for p in parts or ():
        getattr(model, p).load_state_dict(ckpt[p])


def checkpoint_name(epoch: int, metrics_tag: str = "") -> str:
    return (f"epoch_{epoch:04d}" + (f"_{metrics_tag}" if metrics_tag else "")
            + ".pth")


def save_checkpoint(ckpt_dir: str, epoch: int, model: nn.Module,
                    optimizer: torch.optim.Optimizer,
                    lr_scheduler: torch.optim.lr_scheduler.LRScheduler,
                    extra: Optional[dict] = None, metrics_tag: str = "",
                    keep: Optional[int] = None) -> Optional[str]:
    """Save the model, optimizer and schedule states under
    ckpt_dir/epoch_<N>[_<tag>].pth (with `extra`'s keys, e.g. "args");
    returns the path, or None off rank 0."""
    if not is_main_process():
        return None
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.abspath(os.path.join(ckpt_dir,
                                        checkpoint_name(epoch, metrics_tag)))
    payload = dict(extra or {})
    payload.update(model_dicts(model), optimizer=optimizer.state_dict(),
                   lr_scheduler=lr_scheduler.state_dict(), epoch=epoch)
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    if keep:
        prune_checkpoints(ckpt_dir, keep)
    return path


def list_checkpoints(ckpt_dir: str) -> List[Tuple[int, str]]:
    """(epoch, path) of every checkpoint file in ckpt_dir, oldest first."""
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        m = _NAME_RE.match(name)
        path = os.path.join(ckpt_dir, name)
        if m and os.path.isfile(path):
            out.append((int(m.group(1)), path))
    return sorted(out)


def prune_checkpoints(ckpt_dir: str, keep: int) -> None:
    """Keep only the newest `keep` checkpoints (the reference keeps the
    last 8 for YTVOS, utils.py:205-212)."""
    for _, path in list_checkpoints(ckpt_dir)[:-keep]:
        os.remove(path)


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    ckpts = list_checkpoints(ckpt_dir)
    return ckpts[-1][1] if ckpts else None


def load_checkpoint(path: str, device) -> dict:
    """The checkpoint's dict, its tensors on `device`."""
    with torch.serialization.safe_globals([argparse.Namespace]):
        return torch.load(path, map_location=device, weights_only=True)


def load_model_tensors(path: str, device, dicts=None) -> dict:
    """A local .pth file's model tensors on `device`: the `model`,
    `state_dict` or `module` entry when there is one (reference
    checkpoints, mmcv and mmaction files), else the top level (HF dumps);
    entries that are not tensors (the run's args) are dropped.  With
    `dicts` (a model's `CHECKPOINT_DICTS`, lavt's ("model", "bert_model"))
    the file must hold each of those entries: their tensors are returned
    under "<entry>.", a DDP `module.` prefix stripped."""
    if "://" in path:
        raise ValueError(f"{path!r}: pass a local checkpoint path")
    ckpt = load_checkpoint(path, device)
    if dicts is not None:
        missing = [p for p in dicts if not isinstance(ckpt.get(p), dict)]
        if missing:
            raise ValueError(
                f"{path!r} has no {' or '.join(map(repr, missing))} dict: "
                f"this model loads a checkpoint of the dicts {dicts} (a "
                "reference lavt file; a lavt_one file holds 'model' alone)")
        return {f"{p}.{k.removeprefix('module.')}": v for p in dicts
                for k, v in ckpt[p].items() if isinstance(v, torch.Tensor)}
    for key in ("model", "state_dict", "module"):
        if isinstance(ckpt, dict) and isinstance(ckpt.get(key), dict):
            ckpt = ckpt[key]
            break
    return {k: v for k, v in ckpt.items() if isinstance(v, torch.Tensor)}


def restore_checkpoint(path: str, model: nn.Module,
                       optimizer: torch.optim.Optimizer,
                       lr_scheduler: torch.optim.lr_scheduler.LambdaLR,
                       device) -> Tuple[dict, int]:
    """Load a checkpoint of `save_checkpoint` into the model, the optimizer
    and the schedule, built as they were when it was saved (the same
    parameter groups in the same order, the same iters_per_epoch: a
    LambdaLR saves no lambda, only its step count).  Returns (extra,
    epoch), extra holding the other keys (e.g. "args"); the reference's
    resume restores model, optimizer, schedule and epoch the same way
    (train.py:607-612, 723-735).

    The learning rates are then set from the schedule at the restored
    step, as a LambdaLR step sets them: the saved ones again when the run
    goes on with the same --epochs; with others, the new run's poly
    schedule (the JAX package's optax schedule is a function of the
    step)."""
    ckpt = load_checkpoint(path, device)
    load_model_dicts(model, ckpt)
    optimizer.load_state_dict(ckpt["optimizer"])
    lr_scheduler.load_state_dict(ckpt["lr_scheduler"])
    step = lr_scheduler.last_epoch
    lrs = [base * fn(step) for base, fn in zip(lr_scheduler.base_lrs,
                                                lr_scheduler.lr_lambdas)]
    for group, lr in zip(optimizer.param_groups, lrs):
        group["lr"] = lr
    lr_scheduler._last_lr = lrs
    extra = {k: v for k, v in ckpt.items() if k not in _STATE_KEYS}
    return extra, int(ckpt["epoch"])
