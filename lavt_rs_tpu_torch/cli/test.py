"""RefCOCO evaluation entry point (counterpart of `lavt_rs_tpu/cli/test.py`,
the reference test.py): every sentence of every ref of a split, mIoU /
oIoU / P@K.

    python -m lavt_rs_tpu_torch.cli.test --window12 --img_size 480 \\
        --refer_data_root ./refer/data/ --dataset refcoco --splitBy unc \\
        --split val --vocab ./vocab.txt --checkpoint ./checkpoints/model.pth

The published RefCOCO command passes --window12; without it the model is
window 7 (N = 49), whose blocks run qkv -> K10 -> proj on the card, as the
JAX package routes them.  `--no_bf16` (f32 activations) runs on the card
only with `--no_pallas` (the plain versions) or on the host (`--device
cpu`): the kernels compute in bf16, and f32 with the kernels is refused
before the model is built.  `--synthetic` runs a tiny random model on a
4-ref synthetic dataset (no data needed); `--device cpu` runs on the host.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

# the only key a reference checkpoint may lack: recent transformers keep
# BERT's position_ids out of the state dict (the port's model has it)
OPTIONAL_KEYS = frozenset({"text_encoder.embeddings.position_ids"})
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
    if args.dataset == "a2d":
        raise NotImplementedError("A2D evaluation is not ported yet: "
                                  "ROADMAP.md item 24")
    if args.dataset not in ("refcoco", "refcoco+", "refcocog"):
        raise NotImplementedError(f"--dataset {args.dataset}: only the "
                                  "RefCOCO family is ported (ROADMAP.md "
                                  "slice 3)")
    if args.save_vis or args.save_feats:
        raise NotImplementedError("--save_vis / --save_feats are not ported "
                                  "yet: ROADMAP.md item 27")
    if args.model != "lavt_one":
        raise NotImplementedError(f"--model {args.model}: the port's test CLI "
                                  "takes lavt_one; the other families are "
                                  "ROADMAP.md slice 5")


def load_reference_checkpoint(model: nn.Module, path: str,
                              device: torch.device) -> None:
    """Load a reference-format .pth into `model`: unwrap `model` /
    `state_dict` / `module`, strip a `module.` (DDP) prefix, drop BERT's
    pooler (the port has none), and load; only `OPTIONAL_KEYS` may be
    missing.  Local files only; a directory stands for its newest
    checkpoint of the train CLI (`train.checkpoint.latest_checkpoint`)."""
    from ..train.checkpoint import latest_checkpoint, load_checkpoint

    if "://" in path:
        raise ValueError(f"{path!r}: pass a local checkpoint path")
    if os.path.isdir(path):
        newest = latest_checkpoint(path)
        if newest is None:
            raise FileNotFoundError(f"no epoch_*.pth checkpoint under {path!r}")
        print(f"loading {newest}", file=sys.stderr)
        path = newest
    # reference checkpoints carry the run's argparse.Namespace beside the
    # tensors; nothing else is unpickled
    ckpt = load_checkpoint(path, device)
    for key in ("model", "state_dict", "module"):
        if isinstance(ckpt, dict) and isinstance(ckpt.get(key), dict):
            ckpt = ckpt[key]
            break
    sd = {k.removeprefix("module."): v for k, v in ckpt.items()
          if hasattr(v, "shape")}
    sd = {k: v for k, v in sd.items()
          if not k.startswith("text_encoder.pooler.")}
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


if __name__ == "__main__":
    main()
