"""The port's train CLI (`lavt_rs_tpu_torch.cli.train`) and its checkpoints,
on the CPU, on the shrunk config of the JAX package's CLI tests
(test_cli_paths.py / test_cli_train_data.py: embed 16, depths (1, 1, 1, 1),
window 4, one BERT layer, 32²; f32, the plain versions of the kernels).

  * checkpoints: save / list / prune / latest / restore round-trip
    bitwise, names equal to the JAX package's checkpoint stems (with
    `.pth`), and `cli.test` loads the port's file and directory;
  * `--synthetic`, as the JAX package's `test_train_save_resume_step`:
    epochs [0], then [0, 1] resumed from the directory, then [0, 1, 2]
    resumed from a file; the model, the AdamW moments and the schedule's
    step restored bitwise equal to the file's;
  * the RefCOCO branch on JAX's `synthetic_refcoco` fixture (PrefetchLoader,
    paired augmentation, per-epoch eval): the checkpoint is named
    `..._mIoU_<x>_oIoU_<y>.pth`, and `cli.test` on the directory gives the
    in-train eval's summary;
  * every refusal names its ROADMAP.md item, and each video branch
    reaches its own data reader.
"""

import dataclasses
import os
import re

import numpy as np
import pytest
import torch

from lavt_rs_tpu.train.checkpoint import save_checkpoint as jsave_checkpoint
from lavt_rs_tpu_torch.cli import args as cli_args
from lavt_rs_tpu_torch.cli import test as cli_test
from lavt_rs_tpu_torch.cli import train as cli_train
from lavt_rs_tpu_torch.config import SwinConfig
from lavt_rs_tpu_torch.models.factory import build_model
from lavt_rs_tpu_torch.train import checkpoint as ckpt_mod
from lavt_rs_tpu_torch.train.optim import TrainConfig
from lavt_rs_tpu_torch.train.step import create_train_state, make_train_step
from test_data import VOCAB, synthetic_refcoco  # noqa: F401  (fixture)
from torch_threads import torch_threads  # noqa: F401 (autouse fixture)

CPU = torch.device("cpu")
SYNTH = ["--synthetic", "--synthetic_steps", "2", "-b", "2", "--img_size",
         "32", "--print-freq", "1", "--no_bf16", "--device", "cpu"]


@pytest.fixture
def shrunk(monkeypatch):
    """The CLIs build the JAX tests' shrunk config (cli.train binds
    model_config_from_args at import, cli.test at call time)."""
    real = cli_args.model_config_from_args

    def config(args):
        cfg = real(args)
        return cfg.replace(
            swin=SwinConfig(embed_dim=16, depths=(1, 1, 1, 1),
                            num_heads=(1, 2, 4, 8), window_size=4,
                            window_size_3d=(2, 4, 4), drop_path_rate=0.0),
            bert=dataclasses.replace(cfg.bert, num_layers=1,
                                     vocab_size=len(VOCAB) + 100),
            img_size=32)

    monkeypatch.setattr(cli_train, "model_config_from_args", config)
    monkeypatch.setattr(cli_args, "model_config_from_args", config)
    return config


def _tiny_state(seed=0):
    """A shrunk model with one AdamW step taken (moments non-zero)."""
    args = cli_train.get_parser().parse_args(SYNTH)
    from lavt_rs_tpu_torch.config import BertConfig, ModelConfig

    cfg = ModelConfig(swin=SwinConfig(embed_dim=16, depths=(1, 1, 1, 1),
                                      num_heads=(1, 2, 4, 8), window_size=4,
                                      drop_path_rate=0.0),
                      bert=BertConfig(num_layers=1, vocab_size=64),
                      img_size=32, max_tokens=6, dtype="float32")
    model = build_model(cfg, CPU, train=True,
                        generator=torch.Generator().manual_seed(seed))
    tcfg = TrainConfig(iters_per_epoch=3, epochs=2)
    opt, sched = create_train_state(model, tcfg)
    rng = np.random.default_rng(seed)
    args.max_tokens, args.batch_size = 6, 2
    batch = next(cli_train.synthetic_batches(args, 1, rng, vocab_size=64))
    make_train_step(model, opt, sched, tcfg)(
        {k: torch.from_numpy(v) for k, v in batch.items()},
        torch.Generator().manual_seed(1))
    return cfg, tcfg, model, opt, sched, args


def _assert_same(a, b, where=""):
    """Nested state dicts equal bitwise (tensors by dtype and value)."""
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype, where
        assert torch.equal(a.cpu(), b.cpu()), where
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    else:
        assert a == b, where


def test_checkpoint_round_trip(tmp_path):
    cfg, tcfg, model, opt, sched, args = _tiny_state()
    d = str(tmp_path / "ck")
    paths = [ckpt_mod.save_checkpoint(d, e, model, opt, sched,
                                      extra={"args": args}, metrics_tag=tag)
             for e, tag in ((0, ""), (1, "lavt_mIoU_1.25_oIoU_2.50"),
                            (2, "lavt"))]
    assert [os.path.basename(p) for p in paths] == [
        "epoch_0000.pth", "epoch_0001_lavt_mIoU_1.25_oIoU_2.50.pth",
        "epoch_0002_lavt.pth"]
    (tmp_path / "ck" / "notes.txt").write_text("not a checkpoint")
    assert ckpt_mod.list_checkpoints(d) == [(e, p) for e, p in
                                            zip(range(3), paths)]
    assert ckpt_mod.latest_checkpoint(d) == paths[-1]
    assert ckpt_mod.latest_checkpoint(str(tmp_path / "none")) is None

    raw = ckpt_mod.load_checkpoint(paths[1], CPU)
    assert set(raw) == {"model", "optimizer", "lr_scheduler", "epoch", "args"}
    assert raw["args"] == args and raw["epoch"] == 1

    _, _, fresh, fopt, fsched, _ = _tiny_state(seed=1)
    extra, epoch = ckpt_mod.restore_checkpoint(paths[1], fresh, fopt, fsched,
                                               CPU)
    assert epoch == 1 and extra == {"args": args}
    _assert_same(fresh.state_dict(), model.state_dict(), "model")
    _assert_same(fopt.state_dict(), opt.state_dict(), "optimizer")
    _assert_same(fsched.state_dict(), sched.state_dict(), "lr_scheduler")
    assert fsched.last_epoch == sched.last_epoch == 1

    ckpt_mod.prune_checkpoints(d, 2)
    assert [e for e, _ in ckpt_mod.list_checkpoints(d)] == [1, 2]
    p3 = ckpt_mod.save_checkpoint(d, 3, model, opt, sched, keep=1)
    assert ckpt_mod.list_checkpoints(d) == [(3, p3)]

    # cli.test reads the port's file, and a directory as its newest file
    for path in (p3, d):
        ev = build_model(cfg, CPU)
        cli_test.load_reference_checkpoint(ev, path, CPU)
        for k, v in model.state_dict().items():
            assert torch.equal(ev.state_dict()[k], v), k


def test_checkpoint_names_match_jax_stems(tmp_path):
    """The JAX package's orbax directory names, with `.pth`."""
    for epoch, tag in ((0, ""), (7, "lavt_mIoU_31.42_oIoU_27.18"),
                       (12, "tmIoU_5.00")):
        jpath = jsave_checkpoint(str(tmp_path / "jax"), epoch,
                                 {"w": np.zeros(2, np.float32)},
                                 metrics_tag=tag)
        assert ckpt_mod.checkpoint_name(epoch, tag) == \
            os.path.basename(jpath) + ".pth"


def _record_restores(monkeypatch):
    """Wrap restore_checkpoint: after each restore, hold the model, the
    optimizer and the schedule against the file, bitwise."""
    real, seen = ckpt_mod.restore_checkpoint, []

    def restore(path, model, opt, sched, device):
        out = real(path, model, opt, sched, device)
        saved = ckpt_mod.load_checkpoint(path, CPU)
        _assert_same(model.state_dict(), saved["model"], "model")
        _assert_same(opt.state_dict()["state"], saved["optimizer"]["state"],
                     "AdamW moments")
        assert sched.last_epoch == saved["lr_scheduler"]["last_epoch"] > 0
        seen.append(os.path.basename(path))
        return out

    monkeypatch.setattr(ckpt_mod, "restore_checkpoint", restore)
    return seen


def test_synthetic_save_resume_step(tmp_path, shrunk, monkeypatch):
    seen = _record_restores(monkeypatch)
    out = str(tmp_path / "ckpts")
    rec = cli_train.main(SYNTH + ["--epochs", "1", "--output-dir", out])
    assert [e for e, _ in ckpt_mod.list_checkpoints(out)] == [0]
    assert rec["start_epoch"] == 0 and rec["epoch"] == 0
    assert rec["logger"].iter_time.count == 2

    # resume from the directory; must train exactly epoch 1
    rec = cli_train.main(SYNTH + ["--epochs", "2", "--output-dir", out,
                                  "--resume", out])
    assert [e for e, _ in ckpt_mod.list_checkpoints(out)] == [0, 1]
    assert rec["start_epoch"] == 1 and rec["epoch"] == 1
    # from an explicit file too
    ep1 = ckpt_mod.list_checkpoints(out)[-1][1]
    cli_train.main(SYNTH + ["--epochs", "3", "--output-dir", out,
                            "--resume", ep1])
    assert [e for e, _ in ckpt_mod.list_checkpoints(out)] == [0, 1, 2]
    assert seen == ["epoch_0000_lavt.pth", "epoch_0001_lavt.pth"]
    last = ckpt_mod.load_checkpoint(ckpt_mod.latest_checkpoint(out), CPU)
    assert last["lr_scheduler"]["last_epoch"] == 6  # 3 epochs of 2 steps
    with pytest.raises(FileNotFoundError):
        cli_train.main(SYNTH + ["--resume", str(tmp_path / "empty")])


def test_step_generator_folds_in_the_step():
    draws = [cli_train.step_generator(3, s, CPU).initial_seed()
             for s in (0, 1, 2)]
    assert len(set(draws)) == 3
    assert draws[1] == cli_train.step_generator(3, 1, CPU).initial_seed()
    assert draws[1] != cli_train.step_generator(4, 1, CPU).initial_seed()


def test_synthetic_video_epoch(tmp_path, shrunk):
    out = str(tmp_path / "ck")
    rec = cli_train.main(SYNTH + ["--model", "lavt_video", "--num_frames",
                                  "2", "--epochs", "1", "--output-dir", out])
    (_, path), = ckpt_mod.list_checkpoints(out)
    assert re.search(r"epoch_0000_lavt_tmIoU_[\d.]+\.pth$", path), path
    assert rec["summary"] is None and np.isfinite(rec["train_mIoU"])


def test_refcoco_branch_evaluates_and_cli_test_agrees(
        synthetic_refcoco, tmp_path, shrunk, capsys):  # noqa: F811
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(VOCAB) + "\n")
    out = str(tmp_path / "ck")
    data = ["--dataset", "refcoco", "--refer_data_root", synthetic_refcoco,
            "--vocab", str(vocab), "--img_size", "32", "--no_bf16",
            "--device", "cpu"]
    rec = cli_train.main(data + [
        "-b", "1", "--epochs", "1", "--val_split", "val", "-j", "2",
        "--print-freq", "1", "--aug_random_hflip", "0.5",
        "--aug_random_resize", "36", "48", "--output-dir", out])
    err = capsys.readouterr().err
    assert err.count("Final: mIoU=") == 1 and "Epoch: [0]  [1/2]" in err
    (_, path), = ckpt_mod.list_checkpoints(out)
    summary = rec["summary"]
    assert os.path.basename(path) == (
        f"epoch_0000_lavt_mIoU_{summary['mIoU']:.2f}"
        f"_oIoU_{summary['oIoU']:.2f}.pth")
    assert rec["checkpoint"] == path

    got = cli_test.main(data + ["--resume", out])
    assert got == summary


def test_combined_pretrain_concatenates_three_sources(
        synthetic_refcoco, tmp_path):  # noqa: F811
    import shutil

    root = tmp_path / "data"
    shutil.copytree(synthetic_refcoco, root)
    shutil.copytree(root / "refcoco", root / "refcoco+")
    shutil.copytree(root / "refcoco", root / "refcocog")
    os.rename(root / "refcocog" / "refs(unc).p", root / "refcocog" / "refs(umd).p")
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(VOCAB) + "\n")
    args = cli_train.get_parser().parse_args([
        "--refer_data_root", str(root), "--vocab", str(vocab),
        "--ref_image_combined_pretrain", "--img_size", "32"])
    args.max_tokens = cli_args.model_config_from_args(args).max_tokens
    train_ds, val_ds = cli_train.refcoco_datasets(args)
    assert len(train_ds) == 3 * 2 and len(val_ds) == 1
    assert args.max_tokens == 22
    assert all(p.max_tokens == 22 for p in train_ds.datasets)
    assert train_ds[5].ids.shape == (22,)


class _Built(Exception):
    """Raised by a patched model_config_from_args: the config is built."""


@pytest.mark.parametrize("extra,where", [
    (["--bcam"], "bcam"),
    (["--fuse", "simple"], "simple"),
])
def test_cli_refuses_what_is_not_ported(extra, where, monkeypatch):
    """The fusion flags the CLI once refused (ROADMAP.md item 3) now build:
    `cli.train` makes the config whose fusion fields are the JAX
    package's `model_config_from_args`'s (they train in
    tests/test_torch_variants_cli.py)."""
    from lavt_rs_tpu.cli import args as jcli_args
    from lavt_rs_tpu.cli import train as jcli_train
    from test_torch_eval import _plain

    built = []

    def capture(args):
        built.append(cli_args.model_config_from_args(args))
        raise _Built

    monkeypatch.setattr(cli_train, "model_config_from_args", capture)
    with pytest.raises(_Built):
        cli_train.main(["--device", "cpu"] + extra)
    want = jcli_args.model_config_from_args(
        jcli_train.get_parser().parse_args(extra)).fusion
    assert built[0].fusion.kind.value == where
    assert _plain(built[0].fusion) == _plain(want)


@pytest.mark.parametrize("extra,raises,match", [
    (["--dataset", "a2d"], FileNotFoundError, "a2d.json"),
    (["--dataset", "ytvos"], FileNotFoundError, "meta.json"),
    (["--image_combined_3d_pretrain"], FileNotFoundError,
     re.escape("refcoco/refs(unc).p")),
    ([], ValueError, "unknown video dataset refcoco"),
])
def test_cli_takes_the_video_branches(tmp_path, extra, raises, match):
    """The video branches (once refused as ROADMAP.md item 24) now run:
    without data on disk each stops at its own reader, and a video model
    on a RefCOCO dataset raises the JAX CLI's ValueError.  They train on
    data in tests/test_torch_video_train_cli.py."""
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(VOCAB) + "\n")
    with pytest.raises(raises, match=match):
        cli_train.main(["--device", "cpu", "--model", "lavt_video",
                        "--vocab", str(vocab), "--refer_data_root",
                        str(tmp_path), "--a2d_data_root", str(tmp_path),
                        "--a2d_ann", str(tmp_path / "a2d.json"),
                        "--ytvos_data_root", str(tmp_path), "--ytvos_ann",
                        str(tmp_path / "meta.json")] + extra)


@pytest.mark.parametrize("flag", ["--ytvos_2d_swin_3d_pwam",
                                  "--ytvos_2d_swin_pwam"])
def test_cli_trains_the_hybrid_with_a_2d_checkpoint(tmp_path, shrunk,
                                                     capsys, flag):
    """The hybrid 2D-Swin video model and --pretrained2d_lavt_weights (once
    refused as ROADMAP.md item 24b): a lavt_one .pth of the shrunk widths
    loads into it (the fusion too under --ytvos_2d_swin_pwam) and an
    epoch trains."""
    cfg = shrunk(cli_train.get_parser().parse_args(SYNTH))
    src = build_model(cfg.replace(dtype="float32"), CPU,
                      generator=torch.Generator().manual_seed(3))
    path = tmp_path / "lavt_one.pth"
    torch.save({"model": src.state_dict()}, path)
    rec = cli_train.main(SYNTH + ["--model", "lavt_video", "--num_frames",
                                  "2", "--epochs", "1", "--output-dir", "",
                                  flag, "--pretrained2d_lavt_weights",
                                  str(path)])
    assert rec["epoch"] == 0 and np.isfinite(rec["train_mIoU"])
    assert np.isfinite(rec["logger"].loss.global_avg)
    err = capsys.readouterr().err
    loaded = int(re.search(r"\[--pretrained2d_lavt_weights\] loaded (\d+)",
                           err).group(1))
    keep_fusion = flag == "--ytvos_2d_swin_pwam"
    assert loaded == sum(not k.endswith("relative_position_index")
                         and (keep_fusion or ".fusion." not in k)
                         for k in src.state_dict())


def test_cli_trains_under_torchrun(tmp_path):
    """WORLD_SIZE=2 (once refused as ROADMAP.md item 16) trains: two
    processes with torchrun's environment (RANK, LOCAL_RANK, WORLD_SIZE,
    MASTER_ADDR / MASTER_PORT on localhost) each run `cli.train.main`,
    which makes the gloo group, trains an epoch in DDP and destroys the
    group; rank 0 alone writes the checkpoint."""
    from test_torch_ddp import torchrun_world2

    recs = torchrun_world2(str(tmp_path))
    (_, path), = ckpt_mod.list_checkpoints(str(tmp_path / "ckpt"))
    assert recs[0]["checkpoint"] == path and recs[1]["checkpoint"] is None
    assert not any(r["initialized"] for r in recs)
