"""RefCOCO evaluation (counterpart of `lavt_rs_tpu/eval/refcoco_eval.py`);
behavioral contract: reference test.py:53-109.

Per image, per sentence: forward -> argmax -> IoU against the target;
accumulate cum_I / cum_U (oIoU), the per-prediction IoU list (mIoU) and
P@K (`metrics.SegMetrics`).  Every sentence of every ref is evaluated.

  * `fwd_iou`, the per-batch step: per-ref uint8 images, per-sentence
    token ids and masks and a bit-packed binary target in; the images
    normalized on the device, the model run on every (ref, sentence) pair,
    the intersection and union of the argmax with the target out;
  * `evaluate`, the loop, keeping the JAX contract: one padded sentence
    count S for the whole eval (a ref with fewer sentences is padded with
    all-zero ids and masks, and those rows are dropped), ceil(24 / S) refs
    per batch unless given, the final batch padded by repeating its last
    ref, big-endian `np.packbits` targets, a producer thread for the
    decode and the pinned host-to-device copy with PIPELINE_DEPTH
    batches in flight (`eval.pipeline.run_pipelined`), progress lines
    every LOG_EVERY refs and the `Final:` line to `out_stream`.  Under `torch.distributed` with
    world > 1, rank r takes items [r::world] and the ranks' `stats_row`s
    are all-gathered and folded with `merge_stats`.
"""

from __future__ import annotations

import sys
import time
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..data.loader import to_device
from ..metrics import PR_THRESHOLDS, SegMetrics
from ..ops.norm import maybe_normalize_image
from .pipeline import run_pipelined

# sentences per device batch that `evaluate` aims for
SENTENCES_PER_BATCH = 24
# device batches in flight before the oldest result is read
PIPELINE_DEPTH = 2
LOG_EVERY = 100


def unpack_target(target: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(R, ceil(H*W/8)) uint8 big-endian packed bits (np.packbits) ->
    (R, H, W) uint8 in {0, 1}."""
    r, p8 = target.shape
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=target.device)
    bits = (target[:, :, None] >> shifts) & 1
    return bits.reshape(r, p8 * 8)[:, :h * w].reshape(r, h, w)


@torch.no_grad()
def fwd_iou(model: nn.Module, image: torch.Tensor, ids: torch.Tensor,
            mask: torch.Tensor, target: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """image (R, H, W, 3) uint8 per ref; ids / mask (R, S, L) per sentence;
    target (R, ceil(H*W/8)) packed bits.  Returns (inter, union), each
    (R, S) f32 pixel counts."""
    r, s = ids.shape[:2]
    h, w = image.shape[1:3]
    gt = unpack_target(target, h, w).float()[:, None]
    img = maybe_normalize_image(image)
    img = img[:, None].expand(r, s, h, w, 3).reshape(r * s, h, w, 3)
    logits = model(img, ids.reshape(r * s, -1), mask.reshape(r * s, -1))
    pred = logits.argmax(dim=-1).reshape(r, s, h, w).float()
    inter = (pred * gt).sum(dim=(2, 3))
    union = torch.maximum(pred, gt).sum(dim=(2, 3))
    return inter, union


def ref_batches(ds, items: Sequence[int], refs_per_batch: int,
                sentences: int) -> Iterator[Tuple]:
    """Host batches of `refs_per_batch` refs from ds[i] for i in items:
    (last item, sentence counts of the real refs, image (R, H, W, 3),
    ids (R, S, L) int64, mask (R, S, L) int64, packed target (R, ceil(H W
    / 8)) uint8).  S is at least `sentences`; the final batch is padded
    with copies of its last ref."""
    buf = []
    for pos, i in enumerate(items):
        buf.append(ds[i])
        if len(buf) < refs_per_batch and pos + 1 < len(items):
            continue
        real = len(buf)
        buf.extend([buf[-1]] * (refs_per_batch - real))
        sp = max([sentences] + [ex.ids.shape[0] for ex in buf])
        ids = np.zeros((refs_per_batch, sp) + buf[0].ids.shape[1:], np.int64)
        mask = np.zeros_like(ids)
        for j, ex in enumerate(buf):
            ids[j, :ex.ids.shape[0]] = ex.ids
            mask[j, :ex.mask.shape[0]] = ex.mask
        image = np.stack([ex.image for ex in buf])
        raw = np.stack([ex.target for ex in buf]).astype(np.uint8)
        target = np.packbits(raw.reshape(refs_per_batch, -1), axis=1)
        yield i, [ex.ids.shape[0] for ex in buf[:real]], image, ids, mask, target
        buf = []


def _world() -> Tuple[int, int]:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _all_gather_rows(row: np.ndarray, device: torch.device) -> np.ndarray:
    import torch.distributed as dist

    if dist.get_backend() != "nccl":
        device = torch.device("cpu")
    t = torch.from_numpy(row).to(device)
    rows = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(rows, t)
    return torch.stack(rows).cpu().numpy()


def evaluate(model: nn.Module, ds, max_items: Optional[int] = None,
             refs_per_batch: Optional[int] = None, out_stream=None) -> dict:
    """Evaluate `model` (on its parameters' device) on every sentence of
    the first `max_items` refs of `ds`; returns SegMetrics.summary()."""
    if out_stream is None:  # resolved at call time, not import time
        out_stream = sys.stderr
    device = next(model.parameters()).device
    metrics = SegMetrics()
    # one padded sentence count for the whole eval (a dataset without
    # pre-tokenized sentences pads each batch to its own largest count)
    sp0 = max(map(len, getattr(ds, "input_ids", ())), default=1)
    n = len(ds) if max_items is None else min(len(ds), max_items)
    rank, world = _world()
    items = list(range(n))[rank::world]
    rb = refs_per_batch or -(-SENTENCES_PER_BATCH // sp0)

    def produce():
        for i, scounts, *arrays in ref_batches(ds, items, rb, sp0):
            yield i, scounts, [to_device(a, device) for a in arrays]

    def dispatch(batch):
        return fwd_iou(model, *batch[2])

    t0 = time.time()
    next_log = LOG_EVERY

    def sink(batch, result):
        nonlocal next_log
        i, scounts = batch[:2]
        inter, union = (t.cpu().numpy() for t in result)
        for j, s in enumerate(scounts):
            metrics.update(inter[j, :s], union[j, :s])
        if i + 1 >= next_log:
            next_log += LOG_EVERY
            el = time.time() - t0
            print(f"eval [{i + 1}/{n}] {el:.1f}s "
                  f"({metrics.n / el:.2f} sent/s)", file=out_stream)

    run_pipelined(produce, dispatch, sink, PIPELINE_DEPTH)

    if world > 1:
        rows = _all_gather_rows(metrics.stats_row(), device)
        metrics = SegMetrics()
        metrics.merge_stats(rows)

    summary = metrics.summary()
    prec = " ".join(f"P@{t}={summary[f'P@{t}']:.2f}" for t in PR_THRESHOLDS)
    print(f"Final: mIoU={summary['mIoU']:.2f} oIoU={summary['oIoU']:.2f} "
          f"{prec} (n={metrics.n})", file=out_stream)
    return summary
