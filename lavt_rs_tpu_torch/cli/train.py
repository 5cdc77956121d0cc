"""Training entry point (counterpart of `lavt_rs_tpu/cli/train.py`, the
reference train.py) on one card, or on several under torchrun.  The flag
surface is the reference's parser (cli/args.py), so the README.md:167
RefCOCO recipe runs as it is:

    python -m lavt_rs_tpu_torch.cli.train --dataset refcoco --model lavt_one \\
        --swin_type base --window12 --lr 0.00005 --wd 1e-2 -b 8 \\
        --epochs 40 --refer_data_root ./refer/data --vocab ./vocab.txt \\
        --output-dir ./checkpoints

Per epoch: the `PrefetchLoader` (-j threads decode, augment and pin; the
copies to the card run ahead of the step), `train.step.make_train_step`
(AdamW, poly LR, DropPath) with `MetricLogger.log_every`, then every
--eval_every epochs `eval.refcoco_eval.evaluate` on --val_split, and a
checkpoint `epoch_NNNN_<model_id>_mIoU_<x>_oIoU_<y>.pth` in the reference's
dict format (train/checkpoint.py).  --resume takes a checkpoint file or a
directory (its newest file) and continues at the saved epoch + 1.
`--synthetic` trains on random batches without data on disk (lavt_video
too); `--device cpu` runs the plain versions on the host.

`--model lavt_video` trains on the video datasets (`video_datasets`; the
A2D recipe of README.md:185, with --model lavt_video --swin_type tiny):

    python -m lavt_rs_tpu_torch.cli.train --model lavt_video \\
        --dataset a2d|ytvos|ref_pseudo_video|joint --swin_type tiny ...

A2D and the RefCOCO pseudo-clips (`ref_pseudo_video`,
--image_combined_3d_pretrain) are evaluated every --eval_every epochs by
`eval.video_eval.evaluate_a2d` (tag `tmIoU_<train>_mIoU_<x>_oIoU_<y>`) and
saved only when the train mIoU improves; YTVOS and `joint` train blind
(tag `tmIoU_<train>`) and save every epoch, scratch YTVOS keeping the
last 8.  Those rules are the JAX CLI's (cli/train.py:362-441), and
--image_combined_3d_pretrain under lavt_one saves best-only too.

The step's dropout and DropPath draws come from a generator seeded by
(--seed + 1, the global step), so a resumed run draws at step s what an
unbroken run draws there.  The data order restarts from --seed on resume,
as in the JAX package: continuation is not bit-exact.  With -j > 1 the
datasets' own draws (a sentence, a frame sample, an augmentation) are
taken in the loader threads' order, as in the JAX package.

The weight-import flags (--pretrained_swin_weights, --ck_bert as a local
file, --pretrained2d_lavt_weights into the hybrid 2D-Swin video model of
--ytvos_2d_swin_3d_pwam / --ytvos_2d_swin_pwam,
--pretrained2d_lavt_weights_for_a_3d_model,
--pretrained_video_lavt_weights_on_refcocos; `convert/pretrained.py`) are
applied to the built model before the optimizer is made (and before
--resume, which overwrites them, as in the JAX package).

Data parallelism (`parallel/ddp.py`), one process per card:

    torchrun --nproc_per_node N -m lavt_rs_tpu_torch.cli.train ... -b 8

-b is per process, as in the reference's DistributedSampler (the JAX
CLI's -b is the global batch): each process takes every N-th item of the
epoch's permutation, len // N of them, so all take the same number of
steps.  The model is wrapped in DDP (`wrap_ddp`: find_unused_parameters
on, as the last stage's language gate feeds no output), the decoder's BatchNorms take the global batch's
statistics (`SyncBatchNorm2d`), and the step's loss and IoU are the
global batch's.  Process r > 0 draws its dropout and DropPath from
(--seed + 1, step, r).  Only rank 0 writes checkpoints, of the model
without its DDP wrapper, so a one-process run resumes from them; every
process loads --resume.  The group is NCCL on the card; --device cpu
runs gloo.  A caller that has initialized a process group itself (e.g.
several processes sharing one card under gloo, each at --device cuda:0)
is trained in that group.

The image families (--model lavt_one, lavt, lts, vlt, lavt_vlt) train on
the RefCOCO branch; lavt's checkpoints hold its segmentation net and its
BERT as the reference's two dicts {'model', 'bert_model'}, which
`cli.test --model lavt` loads.  Every fusion and decoder variant trains
(--bcam, --gacd, --efn, --fuse simple, --att_norm_layer_type, --lazy_pred,
--interpolate_before_seg, --seg_last, the 3D PWAM kinds of lavt_video).
What stays refused is the test CLI's, not this one's: --save_vis /
--save_feats and --dataset ytvos in `cli.test`, `cli.test_ytvos
--visualize` and `cli.test_ytvos` with the image families (ROADMAP.md
item 3).
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch

from .args import (add_data_args, add_eval_args, add_model_args,
                   add_train_args, model_config_from_args,
                   train_config_from_args)

# the three RefCOCO-family sources of --ref_image_combined_pretrain (at the
# reference's 22 tokens, data/dataset_refer_bert.py:39-42) and of the
# combined video branches (joint, --image_combined_3d_pretrain)
COMBINED_SOURCES = (("refcoco", "unc"), ("refcoco+", "unc"),
                    ("refcocog", "umd"))
COMBINED_MAX_TOKENS = 22


def get_parser():
    p = argparse.ArgumentParser("lavt_rs_tpu_torch training")
    add_model_args(p)
    add_data_args(p)
    add_train_args(p)
    add_eval_args(p)
    return p


def synthetic_batches(args, steps, rng, video: bool = False,
                      vocab_size: int = 30522):
    """The JAX CLI's random batches (numpy): normalized float images (or
    clips), in-vocabulary ids, full masks, random binary targets."""
    hi = min(30000, vocab_size - 1)
    for _ in range(steps):
        batch = {
            "ids": rng.integers(
                1, hi, (args.batch_size, args.max_tokens)
            ).astype(np.int32),
            "mask": np.ones((args.batch_size, args.max_tokens), np.int32),
            "target": rng.integers(
                0, 2, (args.batch_size, args.img_size, args.img_size)
            ).astype(np.int32),
        }
        if video:
            batch["video"] = rng.standard_normal(
                (args.batch_size, args.num_frames, args.img_size,
                 args.img_size, 3)).astype(np.float32)
            batch["valid_index"] = rng.integers(
                0, args.num_frames, (args.batch_size,)).astype(np.int32)
        else:
            batch["image"] = rng.standard_normal(
                (args.batch_size, args.img_size, args.img_size, 3)
            ).astype(np.float32)
        yield batch


class _SizedIter:
    """Wrap a generator with a known length so MetricLogger.log_every can
    print [i/n] + ETA."""

    def __init__(self, it, n):
        self._it, self._n = iter(it), n

    def __iter__(self):
        return self._it

    def __len__(self):
        return self._n


def step_generator(seed: int, step: int, device,
                   rank: int = 0) -> torch.Generator:
    """The generator of global step `step`'s dropout and DropPath draws,
    seeded from (seed + 1, step): the JAX step's fold_in(key, step).
    Process `rank` > 0 of a data-parallel run draws for its own batch,
    seeded from (seed + 1, step, rank); rank 0 keeps the one-process
    stream."""
    entropy = [seed + 1, step] + ([rank] if rank else [])
    s = np.random.SeedSequence(entropy).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(s[0]))


def _augment_from_args(args):
    """The --aug_* flags -> `build_paired_augment` (None when all off)."""
    from ..data.transforms import build_paired_augment

    affine = None
    if args.aug_random_affine:
        a = args.aug_random_affine
        affine = {"degrees": (-a[0], a[0])}
        if len(a) >= 3:
            affine["translate"] = (a[1], a[2])
        if len(a) >= 5:
            affine["scale"] = (a[3], a[4])
    return build_paired_augment(
        resize_range=(tuple(args.aug_random_resize * 2)[:2]
                      if args.aug_random_resize else None),
        hflip=args.aug_random_hflip,
        crop=args.aug_random_crop, affine=affine, seed=args.seed)


def refcoco_datasets(args):
    """The RefCOCO branch's (train, val) datasets: uint8 images (normalized
    on the device), the paired augmentations on the train split."""
    from ..data.pseudo_video import ConcatDataset
    from ..data.refcoco import ReferDataset
    from ..data.refer import REFER
    from ..text.tokenizer import WordPieceTokenizer, resolve_vocab

    refer = REFER(args.refer_data_root, args.dataset, args.splitBy)
    tok = WordPieceTokenizer.from_vocab_file(
        resolve_vocab(args.vocab, args.bert_tokenizer))
    if args.ref_image_combined_pretrain:
        train_ds = ConcatDataset([
            ReferDataset(REFER(args.refer_data_root, name, sb), tok,
                         split=args.split, img_size=args.img_size,
                         max_tokens=COMBINED_MAX_TOKENS, host_normalize=False)
            for name, sb in COMBINED_SOURCES])
    else:
        train_ds = ReferDataset(refer, tok, split=args.split,
                                img_size=args.img_size,
                                max_tokens=args.max_tokens,
                                host_normalize=False,
                                augment=_augment_from_args(args))
    val_ds = ReferDataset(refer, tok, split=args.val_split,
                          img_size=args.img_size, max_tokens=args.max_tokens,
                          eval_mode=True, host_normalize=False)
    return train_ds, val_ds


def video_datasets(args):
    """The video branches' (train, val) datasets, built as the JAX CLI
    builds them (cli/train.py:116-210): uint8 clips (normalized on the
    device); val is None where the branch trains blind (ytvos, joint).

      * a2d: A2D-Sentences' train subset; val on --val_split (with
        --not_consecutive);
      * ytvos: Ref-YouTube-VOS on --ytvos_data_root / --ytvos_ann;
      * ref_pseudo_video, joint, --image_combined_3d_pretrain: each
        RefCOCO-family source (the three when combined, else refcoco on
        --splitBy) as pseudo-clips, from its COCO-format refexp json where
        `{root}/{name}/instances_{name}_{split}.json` exists, else from
        REFER with `ImageToSeqAugmenter(seed=--seed)`; joint appends
        YTVOS; val is refcoco's --val_split as static pseudo-clips (splitBy
        unc when combined)."""
    from ..data.pseudo_video import (ConcatDataset, ImageToSeqAugmenter,
                                     ReferPseudoVideos)
    from ..data.refer import REFER
    from ..text.tokenizer import WordPieceTokenizer, resolve_vocab

    tok = WordPieceTokenizer.from_vocab_file(
        resolve_vocab(args.vocab, args.bert_tokenizer))
    clip = dict(num_frames=args.num_frames, img_size=args.img_size,
                max_tokens=args.max_tokens, host_normalize=False)

    def ytvos():
        from ..data.ytvos import YTVOSDataset

        return YTVOSDataset(args.ytvos_data_root, args.ytvos_ann, tok, **clip)

    combined = args.dataset == "joint" or args.image_combined_3d_pretrain
    val_ds = None  # YTVOS trains blind: its split is scored on a server
    if args.dataset == "a2d":
        from ..data.a2d import A2DSentencesDataset

        train_ds = A2DSentencesDataset(
            args.a2d_data_root, args.a2d_ann, tok, subset="train",
            clip_length=args.clip_length, **clip)
        val_ds = A2DSentencesDataset(
            args.a2d_data_root, args.a2d_ann, tok, subset=args.val_split,
            clip_length=args.clip_length,
            not_consecutive=args.not_consecutive, **clip)
    elif args.dataset == "ytvos":
        train_ds = ytvos()
    elif args.dataset in ("ref_pseudo_video", "joint") or \
            args.image_combined_3d_pretrain:
        from ..data.refexp2seq import build_refexp_dataset

        parts = []
        for name, sb in (COMBINED_SOURCES if combined
                         else (("refcoco", args.splitBy),)):
            refexp_ann = os.path.join(args.refer_data_root, name,
                                      f"instances_{name}_{args.split}.json")
            if os.path.exists(refexp_ann):
                parts.append(build_refexp_dataset(
                    name, args.split, args.refer_data_root, tok,
                    seed=args.seed, **clip))
            else:
                parts.append(ReferPseudoVideos(
                    REFER(args.refer_data_root, name, sb), tok,
                    split=args.split,
                    augmenter=ImageToSeqAugmenter(seed=args.seed), **clip))
        if args.dataset == "joint":
            parts.append(ytvos())
        train_ds = parts[0] if len(parts) == 1 else ConcatDataset(parts)
    else:
        raise ValueError(f"unknown video dataset {args.dataset}")
    if args.dataset == "ref_pseudo_video" or (
            args.image_combined_3d_pretrain and args.dataset != "a2d"):
        val_ds = ReferPseudoVideos(
            REFER(args.refer_data_root, "refcoco",
                  "unc" if combined else args.splitBy),
            tok, split=args.val_split, **clip)
    return train_ds, val_ds


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Parse, build, (resume,) train and evaluate.  Returns the last
    epoch's record: {"start_epoch", "epoch", "train_mIoU", "summary" (the
    val eval's, or None), "logger" (its MetricLogger, with iter_time and
    data_time), "checkpoint" (the path saved, or None off rank 0)}.  Under
    torchrun (WORLD_SIZE > 1) or in a process group already initialized,
    each process trains on its shard of the data in DDP; a group this
    call created is destroyed when it returns."""
    import torch.distributed as dist

    from ..parallel.ddp import init_distributed

    args = get_parser().parse_args(argv)
    owned = not (dist.is_available() and dist.is_initialized())
    rank, world, device = init_distributed(args.device)
    try:
        return _train(args, rank, world, device)
    finally:
        if owned and world > 1:
            dist.destroy_process_group()


def _train(args, rank: int, world: int, device: torch.device) -> dict:
    from ..convert import pretrained
    from ..data.loader import (PrefetchLoader, collate_refer,
                               collate_video, to_device)
    from ..models.factory import build_model
    from ..parallel.ddp import convert_sync_bn, wrap_ddp
    from ..train.checkpoint import (latest_checkpoint, restore_checkpoint,
                                    save_checkpoint)
    from ..train.step import (create_train_state, make_train_step,
                              make_video_train_step)
    from ..utils.logging import MetricLogger, SmoothedValue, print_master

    cfg = model_config_from_args(args)
    args.max_tokens = cfg.max_tokens
    video = cfg.name == "lavt_video"

    def put(batch):
        return {k: to_device(v, device) for k, v in batch.items()}

    val_ds = None
    if args.synthetic:
        iters_per_epoch = args.synthetic_steps
        rng = np.random.default_rng(args.seed if rank == 0
                                    else [args.seed, rank])

        def epoch_batches(epoch):
            return map(put, synthetic_batches(args, iters_per_epoch, rng,
                                              video=video,
                                              vocab_size=cfg.bert.vocab_size))
    else:
        train_ds, val_ds = (video_datasets if video
                            else refcoco_datasets)(args)
        loader = PrefetchLoader(train_ds, args.batch_size,
                                collate_video if video else collate_refer,
                                shuffle=True, num_workers=args.workers,
                                seed=args.seed, shard_index=rank,
                                num_shards=world, device_put=put)
        iters_per_epoch = len(loader)

        def epoch_batches(epoch):
            loader.set_epoch(epoch)
            return iter(loader)

    tcfg = train_config_from_args(args, max(iters_per_epoch, 1))
    model = build_model(cfg, device, train=True,
                        generator=torch.Generator(device=device).manual_seed(
                            args.seed))
    pretrained.apply_pretrained_flags(model, cfg, args)
    if world > 1:  # the decoder's BatchNorm over the global batch
        convert_sync_bn(model)
    opt, sched = create_train_state(model, tcfg)
    start_epoch = 0
    if args.resume:
        path = (args.resume if os.path.isfile(args.resume)
                else latest_checkpoint(args.resume))
        if path is None:
            raise FileNotFoundError(f"no checkpoints under {args.resume}")
        _, resume_epoch = restore_checkpoint(path, model, opt, sched, device)
        # continue AFTER the saved epoch (reference train.py:738
        # `range(max(0, resume_epoch+1), epochs)`)
        start_epoch = resume_epoch + 1
        print_master(f"resumed from {path}; continuing at epoch "
                     f"{start_epoch}", file=sys.stderr)
    # every process loads, converts and restores `model` before DDP wraps
    # it; checkpoints and the eval model take `model`, without `module.`
    step_fn = (make_video_train_step if video else make_train_step)(
        wrap_ddp(model, device) if world > 1 else model,
        opt, sched, tcfg)

    # one eval model (the compute dtype, eval mode) for every epoch, so its
    # routes' cached tensors and the built kernels are reused; it takes the
    # trainer's weights before each eval (load_state_dict casts them)
    eval_model = None if args.synthetic else build_model(cfg, device)

    # A2D and the pseudo-clip pretraining save only when the train mIoU
    # improves (reference train.py:775-811); RefCOCO, YTVOS and joint save
    # every epoch, scratch YTVOS keeping the last 8
    best_metric = -1.0
    best_only = (args.dataset in ("a2d", "ref_pseudo_video")
                 or args.image_combined_3d_pretrain) and not args.synthetic
    keep = args.keep_checkpoints
    if not keep and args.dataset == "ytvos" and \
            not args.pretrained_video_lavt_weights_on_refcocos:
        keep = 8

    record = {"start_epoch": start_epoch, "epoch": None, "train_mIoU": None,
              "summary": None, "logger": None, "checkpoint": None}
    for epoch in range(start_epoch, args.epochs):
        t0 = time.time()
        iou_sum, iou_n = 0.0, 0
        # iter/data timing, ETA, peak device memory (the reference
        # MetricLogger.log_every line, utils.py:113-150)
        logger = MetricLogger(out=sys.stderr)
        logger.add_meter("lr", SmoothedValue(1, fmt="{value:.2e}"))
        batches = logger.log_every(
            _SizedIter(epoch_batches(epoch), iters_per_epoch),
            max(args.print_freq, 1), header=f"Epoch: [{epoch}]")
        for batch in batches:
            metrics = step_fn(batch, step_generator(
                args.seed, sched.last_epoch, device, rank))
            # reading the loss waits for the step: iter_time is real
            iou = float(metrics["iou"])
            logger.update(loss=float(metrics["loss"]), iou=iou,
                          lr=metrics["lr"])
            iou_sum += iou
            iou_n += 1
        logger.synchronize_between_processes()
        # the step's IoU is the global batch's: every process decides alike
        train_miou = 100.0 * iou_sum / max(iou_n, 1)
        print_master(f"epoch {epoch} done in {time.time() - t0:.1f}s "
                     f"(train mIoU {train_miou:.2f})  {logger}",
                     file=sys.stderr)

        # validation every --eval_every epochs, like the reference
        # (train.py:743, 768); checkpoints are named with their metrics
        # (train.py:761-762)
        tag, summary = "", None
        if val_ds is not None and (epoch + 1) % max(args.eval_every, 1) == 0:
            eval_model.load_state_dict(model.state_dict())
            if video:
                from ..eval.video_eval import evaluate_a2d

                summary = evaluate_a2d(eval_model, val_ds)
                tag = f"tmIoU_{train_miou:.2f}_"
            else:
                from ..eval.refcoco_eval import evaluate

                summary = evaluate(eval_model, val_ds)
            tag += f"mIoU_{summary['mIoU']:.2f}_oIoU_{summary['oIoU']:.2f}"
        elif video:
            tag = f"tmIoU_{train_miou:.2f}"

        ckpt = None
        if args.output_dir and best_only and train_miou <= best_metric:
            print_master(f"epoch {epoch}: train mIoU {train_miou:.2f} did "
                         f"not improve on {best_metric:.2f}; not saving",
                         file=sys.stderr)
        elif args.output_dir:
            best_metric = max(best_metric, train_miou)
            # --model_id goes into the name like the reference's
            # model_best_{model_id}.pth (train.py:761-807)
            if args.model_id:
                tag = f"{args.model_id}_{tag}" if tag else args.model_id
            ckpt = save_checkpoint(args.output_dir, epoch, model, opt, sched,
                                   extra={"args": args}, metrics_tag=tag,
                                   keep=keep or None)
            print_master(f"saved {ckpt}", file=sys.stderr)
        record.update(epoch=epoch, train_mIoU=train_miou, summary=summary,
                      logger=logger, checkpoint=ckpt)
    print_master("training complete", file=sys.stderr)
    return record


if __name__ == "__main__":
    main()
