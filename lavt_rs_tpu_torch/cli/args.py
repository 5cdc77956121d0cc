"""Reference-compatible CLI argument surface (counterpart of
`lavt_rs_tpu/cli/args.py`).

Replicates the reference's single argparse parser (reference args.py:4-255,
~80 flags) so a user of the reference can switch with the same command
lines, and maps the flags onto the port's typed config
(`config.ModelConfig`, `model_config_from_args`).

`--device` picks the device (the card by default, `cpu` for the plain
versions on the host); `--no_pallas` asks for the plain PyTorch versions
of the kernels (`use_kernels=False`).  Flags that are parsed-but-unused in
the reference (--map_score, --test_fake_method, --davis_data_root,
--sample_3) or runner-specific (--pin_mem) are accepted for drop-in
compatibility and ignored; each says so in its help string.  --local_rank
and --ngpus shard the YTVOS CLI's videos (`cli/test_ytvos.py`).
"""

from __future__ import annotations

import argparse
from typing import Tuple


def _k3(s: str) -> Tuple[int, int, int]:
    """'a-b-c' kernel-size string -> (a, b, c) (reference args.py:24-40)."""
    a, b, c = (int(x) for x in s.split("-"))
    return (a, b, c)


def add_model_args(p: argparse.ArgumentParser):
    p.add_argument("--model", default="lavt_one",
                   choices=["lavt", "lavt_one", "lavt_video", "lts", "vlt",
                            "lavt_vlt"])
    p.add_argument("--model_id", default="lavt",
                   help="name used in checkpoint filenames")
    p.add_argument("--swin_type", default="base",
                   choices=["tiny", "small", "base", "large"])
    p.add_argument("--window12", action="store_true",
                   help="Swin window 12 (the published RefCOCO models); "
                        "without it window 7, whose blocks run K10 on the "
                        "card")
    p.add_argument("--img_size", type=int, default=480)
    p.add_argument("--max_tokens", type=int, default=0,
                   help="0 = auto (20, or 22 for video/combined pretrain)")
    p.add_argument("--mha", default="",
                   help="per-stage PWAM head counts 'a-b-c-d'")
    p.add_argument("--fuse", default="default", choices=["default", "simple"])
    p.add_argument("--bcam", action="store_true")
    p.add_argument("--gacd", action="store_true")
    p.add_argument("--efn", action="store_true")
    p.add_argument("--version", default="default",
                   choices=["default", "no_gate", "none"],
                   help="language-gate variant")
    p.add_argument("--att_norm_layer_type", default="IN",
                   choices=["IN", "BN", "LN", "none"])
    p.add_argument("--lg_act_layer", default="tanh",
                   choices=["tanh", "sigmoid"])
    p.add_argument("--fusion_drop", type=float, default=0.0)
    p.add_argument("--hs", action="store_true",
                   help="feed gated hidden states to the decoder")
    p.add_argument("--lazy_pred", action="store_true")
    p.add_argument("--seg_last", action="store_true")
    p.add_argument("--interpolate_before_seg", action="store_true")
    p.add_argument("--use_checkpoint", action="store_true",
                   help="activation checkpointing in training: both "
                        "backbones (lavt_one's 2D Swin, lavt_video's 3D "
                        "Swin) recompute each Swin block in the backward; "
                        "lavt_video's last stage skips its language gate, "
                        "as in the reference")
    # --- 3D-PWAM family (video) ---
    p.add_argument("--sep_t_pwam", action="store_true")
    p.add_argument("--sep_t_pwam_inner", action="store_true")
    p.add_argument("--t_pwam", action="store_true")
    p.add_argument("--t_pwam_comp", action="store_true")
    p.add_argument("--ts_pwam", action="store_true")
    p.add_argument("--seq_t_pwam", action="store_true")
    p.add_argument("--sep_seq_t_pwam", action="store_true")
    p.add_argument("--sep_seq_t_pwam_inner", action="store_true")
    p.add_argument("--ytvos_2d_swin_pwam", action="store_true",
                   help="2D Swin backbone + per-frame 2D PWAM")
    p.add_argument("--ytvos_2d_swin_3d_pwam", action="store_true",
                   help="2D Swin backbone + 3D PWAM fusion")
    p.add_argument("--conv3d_kernel_size", default="3-1-1", type=str)
    p.add_argument("--conv3d_kernel_size_t", default="3-1-1", type=str)
    p.add_argument("--conv3d_kernel_size_s", default="1-1-1", type=str)
    p.add_argument("--conv3d_kernel_size_sq", default="1-3-3", type=str)
    p.add_argument("--sept_sum_3_kernel_size", default="", type=str)
    p.add_argument("--sept_cat_reduce_kernel_size", default="", type=str)
    p.add_argument("--tspwam_sum", action="store_true")
    p.add_argument("--cat_reduce_3", action="store_true")
    p.add_argument("--w_3", action="store_true")
    p.add_argument("--w_3x3", action="store_true")
    p.add_argument("--w_t3x3_s1x1", action="store_true")
    p.add_argument("--mm_3", action="store_true")
    p.add_argument("--mm_3x3", action="store_true")
    p.add_argument("--mm_t3x3_s1x1", action="store_true")
    p.add_argument("--s_tanh_plus_1_gate_1_q", action="store_true")
    p.add_argument("--s_tanh_plus_1_gate_1_v", action="store_true")
    p.add_argument("--t_tanh_plus_1_gate_1_q", action="store_true")
    p.add_argument("--t_tanh_plus_1_gate_1_v", action="store_true")
    p.add_argument("--res", action="store_true",
                   help="P3D-C residual in SeqTPWAM")
    p.add_argument("--num_frames", type=int, default=8)
    p.add_argument("--clip_length", type=int, default=16)
    # --- text encoder ---
    p.add_argument("--bert_tokenizer", default="bert-base-uncased",
                   help="tokenizer id; used to locate the vocab file")
    p.add_argument("--ck_bert", default="bert-base-uncased",
                   help="BERT weights id/path for the converter")
    p.add_argument("--vocab", default="./vocab.txt",
                   help="WordPiece vocab file for the native tokenizer")
    # --- extras with no reference equivalent ---
    p.add_argument("--bf16", dest="bf16", action="store_true", default=True,
                   help="bf16 compute (default)")
    p.add_argument("--no_bf16", dest="bf16", action="store_false",
                   help="f32 activations: on the card with the kernels "
                        "for inference and training (lavt_one at windows "
                        "12 and 7, lavt_video; every kernel has an f32 "
                        "variant: K1, K2, the K1/K2 save mode, K5, K6, "
                        "K11, K3, K4, K10, K2p, K9, K8, K7, K4b)")
    p.add_argument("--use_amp", dest="bf16", action="store_true",
                   help="reference alias for bf16 compute")
    p.add_argument("--no_pallas", action="store_true",
                   help="run the plain PyTorch versions instead of the "
                        "hand-written CUDA kernels")


def add_data_args(p: argparse.ArgumentParser):
    p.add_argument("--dataset", default="refcoco",
                   choices=["refcoco", "refcoco+", "refcocog", "a2d",
                            "ytvos", "ref_pseudo_video", "joint"])
    p.add_argument("--splitBy", default="unc")
    p.add_argument("--split", default="train")
    p.add_argument("--val_split", default="val")
    p.add_argument("--refer_data_root", default="./refer/data/")
    p.add_argument("--a2d_data_root", "--a2d_root", dest="a2d_data_root",
                   default="./data/A2D/Release/")
    p.add_argument("--a2d_ann", default="./data/a2d_annotations.json")
    p.add_argument("--ytvos_data_root", "--ytvos_root",
                   dest="ytvos_data_root",
                   default="./data/ReferringYouTubeVOS2021/")
    p.add_argument("--ytvos_ann", default="./data/meta_expressions.json")
    p.add_argument("--davis_data_root", default="./data/DAVIS/",
                   help="accepted for compatibility; DAVIS eval is not on "
                        "the reference's default path either")
    p.add_argument("--pseudo_video_aug", default="",
                   help="parsed-but-unused in the reference (args.py:132); "
                        "accepted — pseudo-video augmentation is always on "
                        "(data/pseudo_video.py ImageToSeqAugmenter)")
    p.add_argument("--ref_image_combined_pretrain", "--combined_pretrain",
                   dest="ref_image_combined_pretrain", action="store_true",
                   help="train on refcoco+refcoco+ +refcocog combined "
                        "(max_tokens 22)")
    p.add_argument("--image_combined_3d_pretrain", action="store_true",
                   help="combined pretrain as static pseudo-videos (3D)")
    p.add_argument("--not_consecutive", action="store_true",
                   help="A2D inference: sparse-sample frames like training")
    p.add_argument("--sample_3", action="store_true",
                   help="JHMDB-only in the reference; accepted, unused")
    # Random paired augmentations (reference transforms.py:33-103 —
    # declared surface, off by default there too; train.py:54-60)
    p.add_argument("--aug_random_resize", type=int, nargs="+", default=None,
                   metavar="MIN [MAX]",
                   help="smaller-edge random resize range before the final "
                        "square resize (reference RandomResize)")
    p.add_argument("--aug_random_hflip", type=float, default=0.0,
                   metavar="P", help="paired horizontal flip probability "
                                     "(reference RandomHorizontalFlip)")
    p.add_argument("--aug_random_crop", type=int, default=None,
                   metavar="SIZE",
                   help="paired random crop (pad-if-smaller, mask fill 255 "
                        "-> background; reference RandomCrop)")
    p.add_argument("--aug_random_affine", type=float, nargs="+",
                   default=None, metavar="DEG [TX TY [SLO SHI]]",
                   help="paired random affine: rotation +-DEG, optional "
                        "translate fractions, optional scale range "
                        "(reference RandomAffine)")
    p.add_argument("-j", "--workers", type=int, default=8,
                   help="data-loader prefetch threads")
    p.add_argument("--pin_mem", action="store_true",
                   help="accepted; the eval loop always pins its host batches "
                        "on the card")


def add_train_args(p: argparse.ArgumentParser):
    p.add_argument("--lr", type=float, default=5e-5)
    p.add_argument("--lr_upsample", type=float, default=3e-5,
                   help="parsed-but-unused in the reference (args.py:87, "
                        "no train.py consumer); accepted")
    p.add_argument("--wd", "--weight-decay", "--weight_decay",
                   dest="weight_decay", type=float, default=1e-2)
    p.add_argument("--amsgrad", action="store_true")
    p.add_argument("--fix_lr", action="store_true")
    p.add_argument("--epochs", type=int, default=40)
    p.add_argument("-b", "--batch-size", "--batch_size", dest="batch_size",
                   type=int, default=8,
                   help="GLOBAL batch size (split across chips)")
    p.add_argument("--loss", default="ce",
                   choices=["ce", "cross_entropy", "dice", "dice_focal",
                            "dice_b", "dice_boundary"])
    p.add_argument("--loss_focal_rate", type=float, default=3.0)
    p.add_argument("--loss_dice_rate", type=float, default=1.0)
    p.add_argument("--loss_boundary_rate", type=float, default=0.05)
    p.add_argument("--lang_enc_params", default="encoder-10")
    p.add_argument("--pretrained_swin_weights", "--pretrained",
                   dest="pretrained_swin_weights", default="",
                   help="torch .pth to convert and load (ImageNet Swin / "
                        "Kinetics Video-Swin)")
    p.add_argument("--pretrained2d_lavt_weights", default="",
                   help="2D LAVT ckpt inflated into a video model "
                        "(2D backbone kept)")
    p.add_argument("--pretrained2d_lavt_weights_for_a_3d_model", default="",
                   help="2D LAVT ckpt inflated into a 3D backbone "
                        "(fusion keys dropped)")
    p.add_argument("--pretrained_video_lavt_weights_on_refcocos", default="",
                   help="video LAVT ckpt from combined RefCOCO pretraining")
    p.add_argument("--ddp_trained_weights", action="store_true",
                   help="accepted for compatibility; the loader strips "
                        "the 'module.' DDP prefix unconditionally and the "
                        "port's BERT has no pooler to drop (the reference "
                        "flag works around a transformers bug, "
                        "test.py:284-286)")
    p.add_argument("--ckpt", action="store_true",
                   help="load checkpoints non-strictly")
    p.add_argument("--resume", default="")
    p.add_argument("--output-dir", "--output_dir", dest="output_dir",
                   default="./checkpoints/")
    p.add_argument("--keep_checkpoints", type=int, default=0,
                   help="keep only last N checkpoints (0 = all; the "
                        "reference keeps last 8 for YTVOS)")
    p.add_argument("--eval_every", type=int, default=1)
    p.add_argument("--print-freq", "--print_freq", dest="print_freq",
                   type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--synthetic", action="store_true",
                   help="random data smoke run (no dataset needed)")
    p.add_argument("--synthetic_steps", type=int, default=4)


def add_eval_args(p: argparse.ArgumentParser):
    p.add_argument("--device", default="cuda",
                   help="torch device: the card by default; cpu runs the "
                        "plain versions on the host")
    p.add_argument("--local_rank", type=int, default=0,
                   help="this process's index among --ngpus YTVOS "
                        "inference workers; unused elsewhere")
    p.add_argument("--ngpus", type=int, default=1,
                   help="process count for sharded YTVOS inference "
                        "(with --local_rank: this process takes videos "
                        "[local_rank::ngpus] of its RANK's share)")
    p.add_argument("--visualize", action="store_true",
                   help="save mask-overlay visualizations (YTVOS; not "
                        "ported yet: ROADMAP.md item 27)")
    p.add_argument("--a2d_masks", action="store_true",
                   help="dump predicted A2D masks as PNGs")
    p.add_argument("--save_feats", default="",
                   help="directory for decoder-feature .npz dumps")
    p.add_argument("--map_score", default="mask_pool",
                   help="parsed-but-unused in the reference; accepted")
    p.add_argument("--test_fake_method", default="add_first",
                   help="parsed-but-unused in the reference; accepted")
    p.add_argument("--debug", action="store_true",
                   help="parsed-but-unused in the reference; accepted")


def model_config_from_args(args):
    """args -> the port's ModelConfig, replicating the reference factory's
    selection rules (lib/segmentation.py:14-212) as the JAX package's
    `model_config_from_args` and `make_config` do."""
    from ..config import (AttnNorm, BranchFuse, FusionConfig, FusionKind,
                          GateKind, LGAct, ModelConfig, StageOutput,
                          SwinConfig, TPWAMConfig, TPWAMKind)

    video = args.model == "lavt_video"
    combined = getattr(args, "ref_image_combined_pretrain", False) or \
        getattr(args, "image_combined_3d_pretrain", False)
    max_tokens = args.max_tokens or (22 if (video or combined) else 20)
    # The reference flips to window-12 when 'window12' appears in the
    # pretrained checkpoint FILENAME, independent of the --window12 flag
    # (lib/segmentation.py:35-39).
    window12 = args.window12 or \
        "window12" in (getattr(args, "pretrained_swin_weights", "") or "")
    swin_kw = {}
    if video:
        # video drop-path rates per size and 3D window per --window12
        # (lib/segmentation.py:154-212)
        swin_kw["drop_path_rate"] = {"tiny": 0.1, "small": 0.2,
                                     "base": 0.3}.get(args.swin_type, 0.3)
        swin_kw["window_size_3d"] = (8, 12, 12) if window12 else (8, 7, 7)
    swin = SwinConfig.from_size(args.swin_type,
                                window_size=12 if window12 else 7, **swin_kw)
    # fusion kind / gate / stage output
    kind = FusionKind.PWAM
    if args.fuse == "simple":
        kind = FusionKind.SIMPLE
    if args.bcam:
        kind = FusionKind.BCAM
    if args.gacd:
        kind = FusionKind.GACD
    if args.efn:
        kind = FusionKind.EFN
    gate = {"default": GateKind.DEFAULT, "no_gate": GateKind.NO_GATE,
            "none": GateKind.NONE}[args.version]
    stage_out = StageOutput.RESIDUAL
    if args.hs:
        stage_out = StageOutput.HIDDEN
    if args.lazy_pred:
        stage_out = StageOutput.LAZY
    heads = tuple(int(x) for x in args.mha.split("-")) if args.mha \
        else FusionConfig().num_heads
    fusion = FusionConfig(
        kind=kind, gate=gate,
        lg_act=LGAct(args.lg_act_layer),
        att_norm=AttnNorm(args.att_norm_layer_type)
        if args.att_norm_layer_type != "none" else AttnNorm.NONE,
        num_heads=heads, dropout=args.fusion_drop,
        stage_output=stage_out)

    # 3D-PWAM family (last matching flag wins, like the reference's
    # if/elif chain in lib/video_swin_transformer.py:425-520)
    tkind = TPWAMKind.SEP
    for flag, k in (("ts_pwam", TPWAMKind.TS), ("t_pwam", TPWAMKind.T),
                    ("t_pwam_comp", TPWAMKind.T_COMP),
                    ("sep_t_pwam", TPWAMKind.SEP),
                    ("sep_t_pwam_inner", TPWAMKind.SEP_INNER),
                    ("seq_t_pwam", TPWAMKind.SEQ),
                    ("sep_seq_t_pwam", TPWAMKind.SEP_SEQ),
                    ("sep_seq_t_pwam_inner", TPWAMKind.SEP_SEQ_INNER)):
        if getattr(args, flag):
            tkind = k
    if getattr(args, "ytvos_2d_swin_pwam", False):
        tkind = TPWAMKind.PWAM2D
    self_gate = any(getattr(args, f) for f in (
        "s_tanh_plus_1_gate_1_q", "s_tanh_plus_1_gate_1_v",
        "t_tanh_plus_1_gate_1_q", "t_tanh_plus_1_gate_1_v"))
    fuse_kernel = None
    branch_fuse = BranchFuse.SUM
    if tkind == TPWAMKind.TS and not args.tspwam_sum:
        # TSPWAM defaults to concat + Linear reduce; --cat_reduce_3
        # swaps the reduce for a (1,3,3) Conv3d
        branch_fuse = BranchFuse.CAT
        if args.cat_reduce_3:
            fuse_kernel = (1, 3, 3)
    if args.sept_sum_3_kernel_size:
        branch_fuse = BranchFuse.SUM_CONV
        fuse_kernel = _k3(args.sept_sum_3_kernel_size)
    if args.sept_cat_reduce_kernel_size:
        branch_fuse = BranchFuse.CAT
        fuse_kernel = _k3(args.sept_cat_reduce_kernel_size)
    kernel_t = _k3(args.conv3d_kernel_size_t
                   if args.conv3d_kernel_size_t != "3-1-1"
                   else args.conv3d_kernel_size)
    tpwam = TPWAMConfig(
        kind=tkind, kernel_t=kernel_t,
        kernel_s=_k3(args.conv3d_kernel_size_s),
        kernel_sq=_k3(args.conv3d_kernel_size_sq),
        branch_fuse=branch_fuse, fuse_kernel=fuse_kernel,
        self_gate=self_gate,
        w_t3x3_s1x1=args.w_t3x3_s1x1,
        mm_t3x3_s1x1=args.mm_t3x3_s1x1,
        w_single_conv="3x3" if args.w_3x3 else ("3" if args.w_3 else None),
        mm_single_conv="3x3" if args.mm_3x3 else
        ("3" if args.mm_3 else None),
        seq_residual=args.res)

    return ModelConfig(
        name=args.model, swin=swin, fusion=fusion, tpwam=tpwam,
        img_size=args.img_size, max_tokens=max_tokens,
        use_checkpoint=args.use_checkpoint,
        dtype="bfloat16" if args.bf16 else "float32",
        use_kernels=not args.no_pallas, lazy_pred=args.lazy_pred,
        interpolate_before_seg=args.interpolate_before_seg,
        seg_last=args.seg_last, num_frames=args.num_frames,
        # both hybrid flags use the 2D-Swin-backbone layer; they differ in
        # the fusion module (3D SepTPWAM vs plain 2D PWAM)
        hybrid_2d_3d=(getattr(args, "ytvos_2d_swin_3d_pwam", False)
                      or getattr(args, "ytvos_2d_swin_pwam", False)))


def train_config_from_args(args, iters_per_epoch: int):
    """args -> the port's TrainConfig (the JAX package's
    `train_config_from_args`, with its loss aliases).  JAX's config also
    carries the batch size, which no code of either package reads; the
    port's has no such field (the loader and the CLI take -b)."""
    from ..train.optim import TrainConfig

    loss = {"ce": "cross_entropy", "dice_b": "dice_boundary"}.get(
        args.loss, args.loss)
    return TrainConfig(
        lr=args.lr, weight_decay=args.weight_decay, epochs=args.epochs,
        iters_per_epoch=iters_per_epoch,
        lang_enc_params=args.lang_enc_params,
        loss=loss, amsgrad=args.amsgrad, fix_lr=args.fix_lr,
        focal_rate=args.loss_focal_rate,
        dice_rate=args.loss_dice_rate,
        boundary_rate=args.loss_boundary_rate)
