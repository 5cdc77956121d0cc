"""Ref-YouTube-VOS inference entry point (counterpart of
`lavt_rs_tpu/cli/test_ytvos.py`, the reference test_ytvos.py): per-frame
PNG masks of the validation videos, for the competition server.

    python -m lavt_rs_tpu_torch.cli.test_ytvos --ytvos_data_root \\
        ./data/ReferringYouTubeVOS2021 --conv3d_kernel_size_t 3-3-3 \\
        --w_t3x3_s1x1 --mm_t3x3_s1x1 --vocab ./vocab.txt \\
        --checkpoint ./checkpoints/ytvos.pth --out ./ytvos_masks

Behavioral contract (reference test_ytvos.py:52-279):
  * the videos are the valid metas minus the test metas' videos, asserted
    to be the competition's 202 when the test metas exist;
  * per video and expression: the expression tokenized to 22 ids, ALL the
    video's frames as one clip (resized to --img_size), one forward, the
    logits resized to the video's original size (corner-aligned bilinear)
    and their argmax written as {out}/{video}/{exp_id}/{frame}.png
    (0 / 255);
  * image models (lavt_one) take the frames as a batch (the reference's
    evaluate_single_frames), one forward per expression;
  * the videos are sharded over processes: [RANK::WORLD_SIZE] (the
    environment of a `torchrun` launch), then [--local_rank::--ngpus].

--chunk_frames N runs a long video in chunks of N frames, each widened by
--chunk_halo frames on both sides; the halo's outputs are dropped, so the
kept frames see the same temporal context as in one forward (with a halo
at least the model's temporal receptive field).  The loop is pipelined
(`eval.pipeline.run_pipelined`): the next videos decode and copy to the
card while the current one's forwards run; the resize and the argmax run
on the card, and only uint8 masks come back.  --max_videos caps the
count; --pipeline_depth sets the videos in flight.  --visualize (mask
overlays) is ROADMAP.md item 27 and raises.

`--no_bf16` runs the video in f32 on the card with the kernels' f32
variants (K2p f32 at stage 1, K10 f32 in the other blocks; lavt_one's
frame batches on K1/K11 or K10 f32 with K3 f32 and K4 f32); training in
f32 (`cli.train --no_bf16`) runs on the f32 variants too.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch

# the reference tokenizes every expression to 22 ids (test_ytvos.py:150)
EXPRESSION_TOKENS = 22


def get_parser() -> argparse.ArgumentParser:
    from .args import (add_data_args, add_eval_args, add_model_args,
                       add_train_args)

    p = argparse.ArgumentParser("lavt_rs_tpu_torch ytvos inference")
    add_model_args(p)
    add_data_args(p)
    add_train_args(p)
    add_eval_args(p)
    p.add_argument("--checkpoint", default="",
                   help="reference-format torch .pth or a train-CLI "
                        "directory; --resume is the reference-compatible "
                        "alias")
    p.add_argument("--out", default="./ytvos_masks")
    p.add_argument("--chunk_frames", type=int, default=0,
                   help="process videos in temporal chunks of this size")
    p.add_argument("--chunk_halo", type=int, default=8,
                   help="frames overlapped on each side of a chunk and "
                        "dropped on stitch (default: the published "
                        "config's temporal window, 8; 0 truncates the "
                        "temporal context at chunk boundaries)")
    p.add_argument("--pipeline_depth", type=int, default=2,
                   help="videos decoded and copied ahead of the running "
                        "forwards; 1 = sequential")
    p.add_argument("--max_videos", type=int, default=0)
    p.set_defaults(model="lavt_video", swin_type="tiny", split="valid")
    return p


def load_validation_videos(root: str) -> dict:
    """valid metas minus the test videos == the 202 competition videos
    (reference test_ytvos.py:84-99, asserted there too).  The metas are
    the valid split's whatever --split (the frames' directory) is, as in
    the JAX package."""
    with open(os.path.join(root, "meta_expressions", "valid",
                           "meta_expressions.json")) as f:
        valid = json.load(f)["videos"]
    test_path = os.path.join(root, "meta_expressions", "test",
                             "meta_expressions.json")
    if os.path.exists(test_path):
        with open(test_path) as f:
            test = json.load(f)["videos"]
        videos = {k: v for k, v in valid.items() if k not in test}
        # only checkable when the test metas exist
        assert len(videos) == 202, (
            f"error: incorrect number of validation videos "
            f"({len(videos)} != 202)")
    else:
        videos = valid
    return videos


def shard(names, ngpus: int, local_rank: int):
    """This process's videos: [RANK::WORLD_SIZE] of the sorted names, then
    [local_rank::ngpus] of those."""
    rank = int(os.environ.get("RANK", "0"))
    world = int(os.environ.get("WORLD_SIZE", "1"))
    names = sorted(names)[rank::world]
    if ngpus > 1:
        names = names[local_rank::ngpus]
    return names


def forward_clip(model, clip: torch.Tensor, ids: torch.Tensor,
                 attn: torch.Tensor, video: bool) -> torch.Tensor:
    """(t, H, W, 3) uint8 frames of one expression -> (t, H, W, 2) logits:
    one clip for a video model, a batch of t images for an image model."""
    from ..ops.norm import maybe_normalize_image

    x = maybe_normalize_image(clip)
    if video:
        return model(x[None], ids, attn)
    t = clip.shape[0]
    return model(x, ids.repeat(t, 1), attn.repeat(t, 1))


def resize_argmax(logits: torch.Tensor, size) -> torch.Tensor:
    """(t, h, w, 2) logits -> (t, H, W) uint8 masks at the original size:
    corner-aligned bilinear in f32 (NCHW), then the argmax, on the card."""
    from ..ops.resize import resize_nchw

    y = resize_nchw(logits.permute(0, 3, 1, 2), size)
    return y.argmax(dim=1).to(torch.uint8)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Write every mask.  Returns {"videos", "frames", "expressions",
    "seconds" (the whole loop), "decode_s" (frame decode and resize, in the
    producer thread), "write_s" (PNG writes), "wait_s" (the loop's wait
    on the producer)}."""
    args = get_parser().parse_args(argv)
    if args.visualize:
        raise NotImplementedError("--visualize (mask overlays) needs "
                                  "utils/visualize.py: ROADMAP.md item 27")
    if args.model not in ("lavt_one", "lavt_video"):
        raise NotImplementedError(f"--model {args.model}: the port runs "
                                  "lavt_one and lavt_video; the other "
                                  "families are ROADMAP.md slice 5")

    from PIL import Image

    from ..data.loader import to_device
    from ..data.transforms import load_image_resized
    from ..eval.pipeline import run_pipelined
    from ..models.factory import build_model
    from ..text.tokenizer import WordPieceTokenizer, resolve_vocab
    from .args import model_config_from_args
    from .test import load_reference_checkpoint

    videos = load_validation_videos(args.ytvos_data_root)
    names = shard(videos, args.ngpus, args.local_rank)
    if args.max_videos:
        names = names[:args.max_videos]

    device = torch.device(args.device)
    cfg = model_config_from_args(args)
    is_video = cfg.name == "lavt_video"
    if not args.checkpoint and args.resume:
        args.checkpoint = args.resume
    if args.checkpoint:
        model = build_model(cfg, device)
        load_reference_checkpoint(model, args.checkpoint, device)
    else:
        print("WARNING: random weights (no --checkpoint)", file=sys.stderr)
        model = build_model(cfg, device, generator=torch.Generator(
            device=device).manual_seed(args.seed))
    tok = WordPieceTokenizer.from_vocab_file(
        resolve_vocab(args.vocab, args.bert_tokenizer))
    frames_dir = os.path.join(args.ytvos_data_root, args.split, "JPEGImages")
    stats = {"videos": len(names), "frames": 0, "expressions": 0,
             "decode_s": 0.0, "write_s": 0.0}

    def produce():
        for vi, vid in enumerate(names):
            t0 = time.perf_counter()
            frames = sorted(videos[vid]["frames"])
            paths = [os.path.join(frames_dir, vid, f"{fr}.jpg")
                     for fr in frames]
            with Image.open(paths[0]) as im:  # the header only
                size = (im.height, im.width)
            clip = np.stack([load_image_resized(p, args.img_size,
                                                host_normalize=False)
                             for p in paths])
            exps = []
            for exp_id, exp in videos[vid]["expressions"].items():
                ids, attn = tok.encode_padded(exp["exp"], EXPRESSION_TOKENS)
                exps.append((exp_id, to_device(ids[None].astype(np.int64),
                                               device),
                             to_device(attn[None].astype(np.int64), device)))
            stats["decode_s"] += time.perf_counter() - t0
            yield vi, vid, frames, size, to_device(clip, device), exps

    @torch.no_grad()
    def dispatch(item):
        _, _, _, size, clip, exps = item
        t = clip.shape[0]
        step = args.chunk_frames or t
        halo = args.chunk_halo if args.chunk_frames and is_video else 0
        preds = []  # per expression: the (t_i, H, W) uint8 mask chunks
        for exp_id, ids, attn in exps:
            chunks = []
            for s in range(0, t, step):
                lo, hi = max(0, s - halo), min(t, s + step + halo)
                logits = forward_clip(model, clip[lo:hi], ids, attn,
                                      is_video)
                keep = slice(s - lo, s - lo + min(step, t - s))
                chunks.append(resize_argmax(logits[keep], size))
            preds.append((exp_id, torch.cat(chunks)))
        return preds

    def sink(item, preds):
        vi, vid, frames, _, _, exps = item
        for exp_id, pred in preds:
            pred = pred.cpu().numpy()
            t0 = time.perf_counter()
            out_dir = os.path.join(args.out, vid, str(exp_id))
            os.makedirs(out_dir, exist_ok=True)
            for t, fr in enumerate(frames):
                Image.fromarray(pred[t] * 255).save(
                    os.path.join(out_dir, f"{fr}.png"))
            stats["write_s"] += time.perf_counter() - t0
        stats["frames"] += len(frames)
        stats["expressions"] += len(exps)
        print(f"[{vi + 1}/{len(names)}] {vid}: {len(exps)} expressions",
              file=sys.stderr)

    t0 = time.perf_counter()
    stats["wait_s"] = run_pipelined(produce, dispatch, sink,
                                    depth=args.pipeline_depth)
    stats["seconds"] = time.perf_counter() - t0
    return stats


if __name__ == "__main__":
    main()
