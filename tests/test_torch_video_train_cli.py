"""The port's video training branches (`cli.train.video_datasets` and
`cli.train.main` with --model lavt_video) against the JAX CLI, on the CPU.

  * For each branch (a2d on test_video_data.py's mp4 + h5 fixture, ytvos
    on its JPEG + palette-PNG fixture, ref_pseudo_video over REFER and
    over a COCO-format refexp json, joint, --image_combined_3d_pretrain):
    `video_datasets` gives the types, part order, lengths and sources of
    the datasets JAX's cli/train.py:116-210 builds, and the first
    `PrefetchLoader` + `collate_video` batch at -j 1 equals the JAX
    loader's on JAX's datasets (`video` within 1 uint8 LSB: the JAX
    package resizes with its native loader, the port with PIL);
  * one epoch of `cli.train.main` per branch on test_torch_train_cli.py's
    shrunk config (lavt_video, 3 frames, 32², --no_bf16 --device cpu):
    the checkpoint names and tags of JAX's cli/train.py:400-441, a second
    epoch whose train mIoU does not improve skipped on the best-only
    branches (the step's iou scripted), keep 8 for scratch YTVOS, and
    `cli.test --dataset a2d --resume` on the A2D directory giving the
    in-train eval's summary.
"""

import json
import os
import shutil

import numpy as np
import pytest

from lavt_rs_tpu.data import loader as jloader
from lavt_rs_tpu.data.a2d import A2DSentencesDataset as JA2D
from lavt_rs_tpu.data.pseudo_video import ConcatDataset as JConcat
from lavt_rs_tpu.data.pseudo_video import ImageToSeqAugmenter as JAug
from lavt_rs_tpu.data.pseudo_video import ReferPseudoVideos as JRPV
from lavt_rs_tpu.data.refer import REFER as JREFER
from lavt_rs_tpu.data.refexp2seq import build_refexp_dataset as jbuild_refexp
from lavt_rs_tpu.data.ytvos import YTVOSDataset as JYTVOS
from lavt_rs_tpu.text.tokenizer import WordPieceTokenizer as JTokenizer
from lavt_rs_tpu_torch.cli import test as cli_test
from lavt_rs_tpu_torch.cli import train as cli_train
from lavt_rs_tpu_torch.data import loader
from lavt_rs_tpu_torch.train import checkpoint as ckpt_mod
from lavt_rs_tpu_torch.train import step as step_mod
from test_data import VOCAB, synthetic_refcoco  # noqa: F401  (fixture)
from test_torch_train_cli import shrunk  # noqa: F401  (fixture)
from test_video_data import VOCAB as VIDEO_VOCAB
from test_video_data import a2d_fixture, ytvos_fixture  # noqa: F401
from torch_threads import torch_threads  # noqa: F401 (autouse fixture)

WORDS = VOCAB + [w for w in VIDEO_VOCAB if w not in VOCAB]
# 3 frames: the sparse sampler of A2D and YTVOS takes at least 3 (the
# annotated frame and two neighbours), so at 3 every branch's clips have
# one length and joint's batches stack
CLIP = ["--model", "lavt_video", "--num_frames", "3", "--img_size", "32",
        "--clip_length", "4", "-j", "1", "--seed", "3"]
CPU = ["--no_bf16", "--device", "cpu", "--print-freq", "1"]


@pytest.fixture(scope="module")
def roots(tmp_path_factory, synthetic_refcoco, a2d_fixture,  # noqa: F811
          ytvos_fixture):  # noqa: F811
    """The branches' data: a vocab; the RefCOCO split under the three
    RefCOCO-family names (refcocog by umd); a copy of it with refcoco's
    train refs as a COCO-format refexp json (one entry per sentence); the
    A2D and YTVOS fixtures."""
    base = tmp_path_factory.mktemp("video_train")
    vocab = base / "vocab.txt"
    vocab.write_text("\n".join(WORDS) + "\n")
    refer = base / "refer"
    shutil.copytree(synthetic_refcoco, refer)
    shutil.copytree(refer / "refcoco", refer / "refcoco+")
    shutil.copytree(refer / "refcoco", refer / "refcocog")
    os.rename(refer / "refcocog" / "refs(unc).p",
              refer / "refcocog" / "refs(umd).p")
    refexp = base / "refexp"
    shutil.copytree(synthetic_refcoco, refexp)
    r = JREFER(str(refexp))
    images, anns = [], []
    for ref_id in r.getRefIds(split="train"):
        ref = r.Refs[ref_id]
        for sent in ref["sentences"]:
            n = len(images) + 1
            images.append(dict(r.Imgs[ref["image_id"]], id=n,
                               caption=sent["raw"]))
            anns.append(dict(r.Anns[ref["ann_id"]], id=100 + n, image_id=n))
    with open(refexp / "refcoco" / "instances_refcoco_train.json", "w") as f:
        json.dump({"images": images, "annotations": anns}, f)
    a2d_root, a2d_ann = a2d_fixture
    ytvos_root, ytvos_ann = ytvos_fixture
    return {"vocab": str(vocab), "refer": str(refer), "refexp": str(refexp),
            "a2d": ["--a2d_data_root", a2d_root, "--a2d_ann", a2d_ann],
            "ytvos": ["--ytvos_data_root", ytvos_root, "--ytvos_ann",
                      ytvos_ann]}


def branch_argv(roots, branch):
    """Each branch's flags (and its batch size)."""
    refer = ["--refer_data_root", roots["refer"]]
    return ["--vocab", roots["vocab"]] + {
        "a2d": ["--dataset", "a2d", "-b", "1"] + roots["a2d"],
        "ytvos": ["--dataset", "ytvos", "-b", "1"] + roots["ytvos"],
        "ref_pseudo_video": ["--dataset", "ref_pseudo_video", "-b", "2"]
        + refer,
        "refexp": ["--dataset", "ref_pseudo_video", "-b", "2",
                   "--refer_data_root", roots["refexp"]],
        "joint": ["--dataset", "joint", "-b", "2"] + refer + roots["ytvos"],
        "combined_3d": ["--image_combined_3d_pretrain", "-b", "2"] + refer,
        # the RefCOCO branch of lavt_one, best-only under the flag as in JAX
        "lavt_one_3d": ["--image_combined_3d_pretrain", "-b", "2",
                        "--model", "lavt_one"] + refer,
    }[branch]


def jax_video_datasets(args):
    """JAX's cli/train.py:116-210, as written there, on JAX's classes."""
    tok = JTokenizer.from_vocab_file(args.vocab)
    clip = dict(num_frames=args.num_frames, img_size=args.img_size,
                max_tokens=args.max_tokens, host_normalize=False)
    if args.dataset == "a2d":
        train_ds = JA2D(args.a2d_data_root, args.a2d_ann, tok, subset="train",
                        clip_length=args.clip_length, **clip)
    elif args.dataset == "ytvos":
        train_ds = JYTVOS(args.ytvos_data_root, args.ytvos_ann, tok, **clip)
    else:
        combined = (args.dataset == "joint"
                    or args.image_combined_3d_pretrain)
        sources = ((("refcoco", "unc"), ("refcoco+", "unc"),
                    ("refcocog", "umd")) if combined
                   else (("refcoco", args.splitBy),))
        parts = []
        for name, sb in sources:
            refexp_ann = os.path.join(args.refer_data_root, name,
                                      f"instances_{name}_{args.split}.json")
            if os.path.exists(refexp_ann):
                parts.append(jbuild_refexp(name, args.split,
                                           args.refer_data_root, tok,
                                           seed=args.seed, **clip))
            else:
                parts.append(JRPV(JREFER(args.refer_data_root, name, sb),
                                  tok, split=args.split,
                                  augmenter=JAug(seed=args.seed), **clip))
        if args.dataset == "joint":
            parts.append(JYTVOS(args.ytvos_data_root, args.ytvos_ann, tok,
                                **clip))
        train_ds = parts[0] if len(parts) == 1 else JConcat(parts)
    val_ds = None
    if args.dataset == "a2d":
        val_ds = JA2D(args.a2d_data_root, args.a2d_ann, tok,
                      subset=args.val_split, clip_length=args.clip_length,
                      not_consecutive=args.not_consecutive, **clip)
    elif args.dataset == "ref_pseudo_video" or \
            args.image_combined_3d_pretrain:
        val_ds = JRPV(JREFER(args.refer_data_root, "refcoco",
                             "unc" if combined else args.splitBy),
                      tok, split=args.val_split, **clip)
    return train_ds, val_ds


def describe(ds):
    """Type, length and source of a dataset, its parts in order."""
    if ds is None:
        return None
    name = type(ds).__name__
    if name == "ConcatDataset":
        return (name, len(ds), [describe(d) for d in ds.datasets])
    source = {
        "ReferPseudoVideos": lambda: (ds.refer.dataset, ds.ref_ids,
                                      ds.augmenter is None),
        "RefExpPseudoVideos": lambda: (ds.ids, ds.img_folder),
        "A2DSentencesDataset": lambda: (ds.subset, ds.clip_length,
                                        ds.not_consecutive, ds.items),
        "YTVOSDataset": lambda: (ds.videos, len(ds.metas)),
    }[name]()
    return (name, len(ds), source, ds.num_frames, ds.img_size,
            ds.max_tokens)


def parsed(argv):
    args = cli_train.get_parser().parse_args(argv)
    args.max_tokens = cli_train.model_config_from_args(args).max_tokens
    return args


LENGTHS = {"a2d": (1, 1), "ytvos": (2, None), "ref_pseudo_video": (2, 1),
           "refexp": (3, 1), "joint": (8, None), "combined_3d": (6, 1)}


@pytest.mark.parametrize("branch", list(LENGTHS))
def test_video_datasets_and_first_batch_match_jax(roots, branch):
    args = parsed(CLIP + branch_argv(roots, branch))
    train_ds, val_ds = cli_train.video_datasets(args)
    jtrain, jval = jax_video_datasets(args)
    assert describe(train_ds) == describe(jtrain)
    assert describe(val_ds) == describe(jval)
    assert (len(train_ds), val_ds and len(val_ds)) == LENGTHS[branch]
    if branch == "joint":
        assert [type(d).__name__ for d in train_ds.datasets] == \
            ["ReferPseudoVideos"] * 3 + ["YTVOSDataset"]

    got = next(iter(loader.PrefetchLoader(
        train_ds, args.batch_size, loader.collate_video, shuffle=True,
        num_workers=args.workers, seed=args.seed)))
    want = next(iter(jloader.PrefetchLoader(
        jtrain, args.batch_size, jloader.collate_video, shuffle=True,
        num_workers=args.workers, seed=args.seed)))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and \
            got[k].shape == want[k].shape, k
        if k == "video":
            diff = np.abs(got[k].astype(np.int16) - want[k].astype(np.int16))
            assert diff.max() <= 1, diff.max()
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["video"].shape == (args.batch_size, 3, 32, 32, 3)


def test_video_model_on_a_refcoco_dataset_raises(roots):
    with pytest.raises(ValueError, match="unknown video dataset refcoco"):
        cli_train.video_datasets(parsed(
            CLIP + ["--vocab", roots["vocab"], "--refer_data_root",
                    roots["refer"]]))


def script_iou(monkeypatch, per_epoch):
    """The video step's iou replaced by 0.5 over the first `per_epoch`
    steps and 0.25 after them (the loss and the update stay the step's)."""
    def scripting(real):
        def make(model, opt, sched, tcfg):
            step, calls = real(model, opt, sched, tcfg), []

            def scripted(batch, generator=None):
                out = step(batch, generator)
                out["iou"] = out["iou"] * 0 + (0.5 if len(calls) < per_epoch
                                               else 0.25)
                calls.append(1)
                return out

            return scripted

        return make

    for name in ("make_train_step", "make_video_train_step"):
        monkeypatch.setattr(step_mod, name,
                            scripting(getattr(step_mod, name)))


@pytest.mark.parametrize("branch", list(LENGTHS))
def test_video_branch_epochs(roots, branch, shrunk, tmp_path,  # noqa: F811
                             monkeypatch, capsys):
    out = str(tmp_path / "ck")
    saves = []
    real_save = ckpt_mod.save_checkpoint

    def save(*a, **kw):
        saves.append(kw["keep"])
        return real_save(*a, **kw)

    monkeypatch.setattr(ckpt_mod, "save_checkpoint", save)
    argv = CLIP + branch_argv(roots, branch) + CPU + ["--output-dir", out]
    rec = cli_train.main(argv + ["--epochs", "1"])
    err = capsys.readouterr().err
    (_, path), = ckpt_mod.list_checkpoints(out)
    assert rec["checkpoint"] == path and np.isfinite(rec["train_mIoU"])
    tag = f"epoch_0000_lavt_tmIoU_{rec['train_mIoU']:.2f}"
    if LENGTHS[branch][1] is None:  # trains blind
        assert rec["summary"] is None and "A2D: mIoU=" not in err
        assert os.path.basename(path) == tag + ".pth"
    else:
        s = rec["summary"]
        assert err.count("A2D: mIoU=") == 1
        assert os.path.basename(path) == (
            f"{tag}_mIoU_{s['mIoU']:.2f}_oIoU_{s['oIoU']:.2f}.pth")
    assert saves == [8 if branch == "ytvos" else None]

    if branch == "a2d":
        got = cli_test.main(["--model", "lavt_video", "--dataset", "a2d",
                             "--split", "val", "--num_frames", "3",
                             "--img_size", "32", "--clip_length", "4",
                             "--vocab", roots["vocab"], "--resume", out]
                            + roots["a2d"] + CPU[:3])
        assert got == rec["summary"]


@pytest.mark.parametrize("branch,steps", [
    ("a2d", 1), ("ref_pseudo_video", 1), ("joint", 4), ("lavt_one_3d", 1)])
def test_best_only_skips_an_epoch_that_does_not_improve(
        roots, branch, steps, shrunk, monkeypatch, tmp_path,  # noqa: F811
        capsys):
    """Epoch 0 trains at iou 0.5 and is saved; epoch 1 at 0.25 is skipped
    on the best-only branches (--image_combined_3d_pretrain under lavt_one
    too) and saved on joint (JAX cli/train.py:362-370, :428-441)."""
    argv = CLIP + branch_argv(roots, branch)
    script_iou(monkeypatch, steps)
    out = str(tmp_path / "ck")
    rec = cli_train.main(argv + CPU + ["--output-dir", out, "--epochs", "2"])
    err = capsys.readouterr().err
    assert rec["epoch"] == 1 and rec["train_mIoU"] == pytest.approx(25.0)
    files = ckpt_mod.list_checkpoints(out)
    assert os.path.basename(files[0][1]).startswith(
        "epoch_0000_lavt_mIoU_" if branch == "lavt_one_3d"
        else "epoch_0000_lavt_tmIoU_50.00")
    if branch != "joint":
        assert [e for e, _ in files] == [0] and rec["checkpoint"] is None
        assert ("epoch 1: train mIoU 25.00 did not improve on 50.00; not "
                "saving") in err
    else:
        assert [e for e, _ in files] == [0, 1] and rec["checkpoint"]
        assert "did not improve" not in err
