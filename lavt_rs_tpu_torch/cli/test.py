"""Evaluation entry point (counterpart of `lavt_rs_tpu/cli/test.py`, the
reference test.py): RefCOCO (every sentence of every ref of a split) with
the image families (--model lavt_one, lavt, lts, vlt, lavt_vlt), or
A2D-Sentences (`--dataset a2d`, every clip's annotated frame) with
lavt_video; mIoU / oIoU / P@K.  A reference `lavt` checkpoint holds two
dicts, {'model', 'bert_model'} (the segmentation net and its BERT).

    python -m lavt_rs_tpu_torch.cli.test --window12 --img_size 480 \\
        --refer_data_root ./refer/data/ --dataset refcoco --splitBy unc \\
        --split val --vocab ./vocab.txt --checkpoint ./checkpoints/model.pth

The published RefCOCO command passes --window12; without it the model is
window 7 (N = 49), whose blocks run qkv -> K10 -> proj on the card, as the
JAX package routes them.  `--no_bf16` (f32 activations, as the published
RefCOCO and A2D checkpoints were trained) runs on the card with the
kernels' f32 variants: K1, K11, K3 and K4 at `--window12`, K10 f32 (and
K3 f32, K4 f32) at window 7, K2p f32 and K10 f32 in lavt_video (`--dataset
a2d`).  Training in f32 (`cli.train --no_bf16`, at either window) runs on
the f32 variants too; `--no_pallas` (the plain versions) and `--device
cpu` also run f32.
`--synthetic` runs a tiny random window-7 model
on a 4-ref synthetic dataset (no data needed); `--device cpu` runs on the
host.

A2D (reference test.py:121-230):

    python -m lavt_rs_tpu_torch.cli.test --model lavt_video --swin_type tiny \\
        --conv3d_kernel_size_t 3-3-3 --w_t3x3_s1x1 --mm_t3x3_s1x1 \\
        --dataset a2d --a2d_data_root ./data/A2D --a2d_ann ./data/a2d_val.json \\
        --vocab ./vocab.txt --checkpoint ./checkpoints/a2d.pth [--a2d_masks]

(the A2D recipe's flags, README.md:185; its config is
`config.lavt_video_tiny()`): clips of --clip_length (16) consecutive
frames around each annotated frame, edge-padded, or sparse-sampled with
--not_consecutive
(`data/a2d.A2DSentencesDataset`, cv2 for the mp4s, h5py for the masks);
`eval/video_eval.evaluate_a2d`; --a2d_masks writes each clip's predicted
annotated-frame mask to <--output-dir>/a2d_masks/<id>.png.  --checkpoint
(or --resume) takes a reference .pth or a train-CLI directory.
`--synthetic` runs a tiny random video model on two 2-frame clips.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

# the only keys a reference checkpoint may lack: recent transformers keep
# BERT's position_ids out of the state dict (the port's model has it)
OPTIONAL_KEYS = frozenset({"text_encoder.embeddings.position_ids",
                           "bert_model.embeddings.position_ids"})
# BERT's pooler, which reference checkpoints hold and the port has not
POOLERS = ("text_encoder.pooler.", "bert_model.pooler.")
# the RefCOCO-family models and the datasets they evaluate
IMAGE_MODELS = ("lavt_one", "lavt", "lts", "vlt", "lavt_vlt")
SYNTHETIC_REFS = 4


def get_parser() -> argparse.ArgumentParser:
    from .args import (add_data_args, add_eval_args, add_model_args,
                       add_train_args)

    p = argparse.ArgumentParser("lavt_rs_tpu_torch evaluation")
    add_model_args(p)
    add_data_args(p)
    add_train_args(p)  # --resume / --ckpt / --seed / --synthetic
    add_eval_args(p)
    p.add_argument("--checkpoint", default="",
                   help="reference-format torch .pth (a local path); "
                        "--resume is the reference-compatible alias")
    p.add_argument("--max_items", type=int, default=0)
    p.add_argument("--save_vis", default="",
                   help="directory for mask-overlay PNG dumps (not ported "
                        "yet)")
    p.set_defaults(split="val")
    return p


def _refuse_unported(args) -> None:
    if args.dataset not in ("refcoco", "refcoco+", "refcocog", "a2d"):
        raise NotImplementedError(f"--dataset {args.dataset}: this CLI "
                                  "evaluates the RefCOCO family and A2D "
                                  "(ROADMAP.md slice 3); YTVOS inference is "
                                  "cli.test_ytvos")
    if args.save_vis or args.save_feats:
        raise NotImplementedError("--save_vis / --save_feats are not ported "
                                  "yet: ROADMAP.md item 27")
    if (args.dataset == "a2d") != (args.model == "lavt_video"):
        raise ValueError("--dataset a2d goes with --model lavt_video, the "
                         "RefCOCO family with --model "
                         + "/".join(IMAGE_MODELS))


def load_reference_checkpoint(model: nn.Module, path: str,
                              device: torch.device) -> None:
    """Load a reference-format .pth into `model`: unwrap `model` /
    `state_dict` / `module` (for lavt the two dicts `model` and
    `bert_model`, which it must hold), strip a `module.` (DDP) prefix, drop
    BERT's pooler (the port has none), and load; only `OPTIONAL_KEYS` may
    be missing.  Local files only; a directory stands for its newest
    checkpoint of the train CLI (`train.checkpoint.latest_checkpoint`)."""
    from ..train.checkpoint import latest_checkpoint, load_model_tensors

    if os.path.isdir(path):
        newest = latest_checkpoint(path)
        if newest is None:
            raise FileNotFoundError(f"no epoch_*.pth checkpoint under {path!r}")
        print(f"loading {newest}", file=sys.stderr)
        path = newest
    # reference checkpoints carry the run's argparse.Namespace beside the
    # tensors; nothing else is unpickled
    dicts = getattr(model, "CHECKPOINT_DICTS", None)
    sd = {k.removeprefix("module."): v
          for k, v in load_model_tensors(path, device, dicts).items()}
    sd = {k: v for k, v in sd.items() if not k.startswith(POOLERS)}
    missing, unexpected = model.load_state_dict(sd, strict=False)
    missing = set(missing) - OPTIONAL_KEYS
    if missing or unexpected:
        raise RuntimeError(f"checkpoint {path!r} does not fit the model: "
                           f"missing {sorted(missing)[:8]}, unexpected "
                           f"{sorted(unexpected)[:8]}")


class SyntheticRefs:
    """The JAX CLI's 4-ref synthetic dataset: normalized random images,
    random binary targets, 1-3 sentences of 8 random token ids."""

    def __len__(self) -> int:
        return SYNTHETIC_REFS

    def __getitem__(self, i: int):
        from ..data.refcoco import ReferExample

        rng = np.random.default_rng(i)
        s = 1 + i % 3
        return ReferExample(
            image=rng.standard_normal((64, 64, 3)).astype(np.float32),
            target=rng.integers(0, 2, (64, 64)).astype(np.int32),
            ids=rng.integers(0, 100, (s, 8)).astype(np.int32),
            mask=np.ones((s, 8), np.int32), ref_id=i)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Parse, build the model, load or draw its weights, evaluate; returns
    the summary (mIoU, oIoU, P@K)."""
    args = get_parser().parse_args(argv)
    _refuse_unported(args)

    from ..config import BertConfig, SwinConfig
    from ..eval.refcoco_eval import evaluate
    from ..models.factory import build_model
    from .args import model_config_from_args

    if not args.checkpoint and args.resume:
        args.checkpoint = args.resume
    device = torch.device(args.device)
    cfg = model_config_from_args(args)

    def seeded():
        return torch.Generator(device=device).manual_seed(args.seed)

    if args.dataset == "a2d":
        return eval_a2d(args, cfg, device, seeded)
    if args.synthetic:
        cfg = cfg.replace(
            swin=SwinConfig(embed_dim=48, depths=(1, 1, 2, 1),
                            num_heads=(3, 6, 12, 24), window_size=7),
            bert=BertConfig(num_layers=2), img_size=64, max_tokens=8)
        model = build_model(cfg, device, generator=seeded())
        ds = SyntheticRefs()
    else:
        from ..data.refcoco import ReferDataset
        from ..data.refer import REFER
        from ..text.tokenizer import WordPieceTokenizer, resolve_vocab

        refer = REFER(args.refer_data_root, args.dataset, args.splitBy)
        tok = WordPieceTokenizer.from_vocab_file(
            resolve_vocab(args.vocab, args.bert_tokenizer))
        ds = ReferDataset(refer, tok, split=args.split,
                          img_size=args.img_size, max_tokens=cfg.max_tokens,
                          eval_mode=True,
                          host_normalize=False)  # normalized on the device
        if args.checkpoint:
            model = build_model(cfg, device)
            load_reference_checkpoint(model, args.checkpoint, device)
        else:
            print("WARNING: no checkpoint; evaluating random weights",
                  file=sys.stderr)
            model = build_model(cfg, device, generator=seeded())
    summary = evaluate(model, ds, max_items=args.max_items or None)
    print(summary)
    return summary


class SyntheticClips:
    """The JAX CLI's two synthetic A2D clips: 2 normalized random 64²
    frames, a random binary target, 8 random token ids."""

    def __len__(self) -> int:
        return 2

    def __getitem__(self, i: int):
        from ..data.a2d import VideoExample

        rng = np.random.default_rng(i)
        return VideoExample(
            video=rng.standard_normal((2, 64, 64, 3)).astype(np.float32),
            target=rng.integers(0, 2, (64, 64)).astype(np.int32),
            valid_index=i % 2, valid=1,
            ids=rng.integers(0, 100, (8,)).astype(np.int32),
            mask=np.ones((8,), np.int32), image_id=f"synthetic_{i}")


def a2d_dataset(args, cfg):
    """The A2D split that --dataset a2d evaluates: uint8 clips of
    --clip_length frames (normalized on the device)."""
    from ..data.a2d import A2DSentencesDataset
    from ..text.tokenizer import WordPieceTokenizer, resolve_vocab

    tok = WordPieceTokenizer.from_vocab_file(
        resolve_vocab(args.vocab, args.bert_tokenizer))
    return A2DSentencesDataset(
        args.a2d_data_root, args.a2d_ann, tok, subset=args.split,
        num_frames=args.num_frames, clip_length=args.clip_length,
        img_size=args.img_size, max_tokens=cfg.max_tokens,
        host_normalize=False, not_consecutive=args.not_consecutive)


def eval_a2d(args, cfg, device, seeded) -> dict:
    """--dataset a2d: build lavt_video, load --checkpoint (or draw seeded
    random weights), `evaluate_a2d`, then --a2d_masks.  --synthetic: the
    JAX CLI's tiny model on its two synthetic clips."""
    from ..config import BertConfig, SwinConfig
    from ..data.loader import to_device
    from ..eval.video_eval import clip_logits, evaluate_a2d
    from ..models.factory import build_model

    if args.synthetic:
        cfg = cfg.replace(
            swin=SwinConfig(embed_dim=48, depths=(1, 1, 2, 1),
                            num_heads=(3, 6, 12, 24),
                            window_size_3d=(2, 7, 7)),
            bert=BertConfig(num_layers=2), img_size=64, max_tokens=8,
            num_frames=2)
        model = build_model(cfg, device, generator=seeded())
        ds = SyntheticClips()
    else:
        ds = a2d_dataset(args, cfg)
        if args.checkpoint:
            model = build_model(cfg, device)
            load_reference_checkpoint(model, args.checkpoint, device)
        else:
            print("WARNING: no checkpoint; evaluating random weights",
                  file=sys.stderr)
            model = build_model(cfg, device, generator=seeded())
    summary = evaluate_a2d(model, ds, max_items=args.max_items or None)
    print(summary)

    if args.a2d_masks:
        from PIL import Image

        out = os.path.join(args.output_dir or ".", "a2d_masks")
        os.makedirs(out, exist_ok=True)
        n = min(len(ds), args.max_items or 32)
        for i in range(n):
            ex = ds[i]
            logits = clip_logits(model, *(to_device(a, device) for a in (
                ex.video, ex.ids.astype(np.int64), ex.mask.astype(np.int64))))
            pred = logits[ex.valid_index].argmax(-1).to(torch.uint8).cpu()
            Image.fromarray(pred.numpy() * 255).save(
                os.path.join(out, f"{ex.image_id}.png"))
        print(f"saved {n} A2D masks to {out}", file=sys.stderr)
    return summary


if __name__ == "__main__":
    main()
