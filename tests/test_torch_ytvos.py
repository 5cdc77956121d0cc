"""The port's YTVOS inference CLI (`lavt_rs_tpu_torch.cli.test_ytvos`)
against the JAX package's, on the CPU, on the competition layout of
tests/test_cli_ytvos.py (copied): meta_expressions/valid/... and
valid/JPEGImages/<video>/<frame>.jpg, 24x32 frames.

Both CLIs load one reference .pth of a small f32 model (the JAX tests'
shrunk config: embed 16, depths (1, 1, 1, 1), window 4 / (2, 4, 4), one
BERT layer, 32²) and write a PNG per frame and expression at the original
size; each mask agrees with the JAX CLI's on all but 1 % of its pixels
(argmax near-ties of f32 logits summed in another order, as
tests/test_torch_eval.py).  Also: lavt_one's single-frame path, the
202-video assertion, the sharding by RANK / WORLD_SIZE and --ngpus /
--local_rank, chunks with a halo equal to one forward (bitwise), and the
refusal of --visualize.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from lavt_rs_tpu_torch.cli import test_ytvos as cli
from lavt_rs_tpu_torch.config import SwinConfig
from lavt_rs_tpu_torch.models.factory import build_model
from torch_threads import torch_threads  # noqa: F401 (autouse fixture)

VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "the", "dog", "a", "cat"]
SWIN = dict(embed_dim=16, depths=(1, 1, 1, 1), num_heads=(1, 2, 4, 8),
            window_size=4, window_size_3d=(2, 4, 4), drop_path_rate=0.0)
VIDS = {"vidA": 3, "vidB": 2, "vidC": 4}


def write_ytvos(root, frames_per_video, seed=0, size=(24, 32)):
    rng = np.random.default_rng(seed)
    meta = {"videos": {}}
    for vid, n in frames_per_video.items():
        frames = [f"{i:05d}" for i in range(n)]
        jdir = root / "valid" / "JPEGImages" / vid
        jdir.mkdir(parents=True)
        for fr in frames:
            Image.fromarray(rng.integers(0, 255, size + (3,), np.uint8)
                            ).save(jdir / f"{fr}.jpg")
        exps = {"0": {"exp": "a cat"}}
        if vid == "vidA":
            exps["1"] = {"exp": "the dog"}
        meta["videos"][vid] = {"frames": frames, "expressions": exps}
    mdir = root / "meta_expressions" / "valid"
    mdir.mkdir(parents=True)
    with open(mdir / "meta_expressions.json", "w") as f:
        json.dump(meta, f)
    (root / "vocab.txt").write_text("\n".join(VOCAB) + "\n")
    return str(root)


@pytest.fixture(scope="module")
def ytvos_root(tmp_path_factory):
    return write_ytvos(tmp_path_factory.mktemp("ytvos_comp"), VIDS)


def _shrunk(real):
    def config(args):
        cfg = real(args)
        return cfg.replace(swin=SwinConfig(**SWIN), bert=dataclasses.replace(
            cfg.bert, num_layers=1, vocab_size=len(VOCAB)), img_size=32)
    return config


@pytest.fixture
def shrunk(monkeypatch):
    import lavt_rs_tpu_torch.cli.args as pargs

    monkeypatch.setattr(pargs, "model_config_from_args",
                        _shrunk(pargs.model_config_from_args))
    return pargs.model_config_from_args


def checkpoint(tmp_path, shrunk, model="lavt_video", seed=3):
    cfg = shrunk(cli.get_parser().parse_args(["--model", model,
                                              "--no_bf16"]))
    m = build_model(cfg, "cpu", generator=torch.Generator().manual_seed(seed))
    path = tmp_path / f"{model}.pth"
    torch.save({"model": m.state_dict()}, path)
    return str(path)


def base(root, out, ckpt=None, model="lavt_video"):
    argv = ["--model", model, "--ytvos_data_root", root, "--vocab",
            os.path.join(root, "vocab.txt"), "--img_size", "32",
            "--num_frames", "2", "--no_bf16", "--out", out]
    return argv + (["--checkpoint", ckpt] if ckpt else [])


def masks(out):
    """{(video, expression, frame): mask} of a CLI's output directory."""
    got = {}
    for dirpath, _, files in os.walk(out):
        for f in files:
            vid, exp = os.path.relpath(dirpath, out).split(os.sep)
            got[(vid, exp, f)] = np.asarray(Image.open(os.path.join(dirpath,
                                                                    f)))
    return got


@pytest.mark.parametrize("model", ["lavt_video", "lavt_one"])
def test_masks_match_the_jax_cli(ytvos_root, tmp_path, monkeypatch, shrunk,
                                 model):
    import lavt_rs_tpu.cli.args as jargs
    from lavt_rs_tpu.cli import test_ytvos as jcli

    monkeypatch.setattr(jargs, "model_config_from_args",
                        _shrunk(jargs.model_config_from_args))
    ckpt = checkpoint(tmp_path, shrunk, model)
    stats = cli.main(base(ytvos_root, str(tmp_path / "port"), ckpt, model)
                     + ["--device", "cpu"])
    jcli.main(base(ytvos_root, str(tmp_path / "jax"), ckpt, model))
    got, want = masks(tmp_path / "port"), masks(tmp_path / "jax")
    assert got.keys() == want.keys()
    assert len(got) == sum(n * (2 if v == "vidA" else 1)
                           for v, n in VIDS.items())
    assert stats["videos"] == 3 and stats["frames"] == sum(VIDS.values())
    assert stats["expressions"] == 4
    for k, g in got.items():
        assert g.shape == want[k].shape == (24, 32) and g.dtype == np.uint8
        assert set(np.unique(g)) <= {0, 255}
        assert (g != want[k]).mean() <= 0.01, k


def test_202_video_assertion(tmp_path):
    """With test metas present, the validation count must be exactly 202
    (reference test_ytvos.py:99)."""

    def build(n_valid_only, root):
        vdir = root / "meta_expressions" / "valid"
        tdir = root / "meta_expressions" / "test"
        vdir.mkdir(parents=True)
        tdir.mkdir(parents=True)
        test = {f"t{i}": {} for i in range(3)}
        valid = {f"v{i}": {} for i in range(n_valid_only)}
        valid.update(test)  # competition quirk: valid contains test too
        with open(vdir / "meta_expressions.json", "w") as f:
            json.dump({"videos": valid}, f)
        with open(tdir / "meta_expressions.json", "w") as f:
            json.dump({"videos": test}, f)

    build(202, tmp_path / "ok")
    videos = cli.load_validation_videos(str(tmp_path / "ok"))
    assert len(videos) == 202 and not any(v.startswith("t") for v in videos)
    build(17, tmp_path / "bad")
    with pytest.raises(AssertionError, match="incorrect number"):
        cli.load_validation_videos(str(tmp_path / "bad"))


@pytest.mark.parametrize("env,ngpus,local_rank,want", [
    ({}, 1, 0, ["vidA", "vidB", "vidC"]),
    ({"RANK": "1", "WORLD_SIZE": "2"}, 1, 0, ["vidB"]),
    ({"RANK": "0", "WORLD_SIZE": "2"}, 2, 1, ["vidC"]),
    ({}, 3, 2, ["vidC"]),
])
def test_sharding(ytvos_root, tmp_path, monkeypatch, shrunk, env, ngpus,
                  local_rank, want):
    for k in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert cli.shard(VIDS, ngpus, local_rank) == want
    out = tmp_path / "out"
    cli.main(base(ytvos_root, str(out)) + [
        "--device", "cpu", "--ngpus", str(ngpus), "--local_rank",
        str(local_rank), "--max_videos", "1"])
    assert sorted(os.listdir(out)) == want[:1]


def test_chunks_with_a_halo_equal_one_forward(tmp_path, shrunk):
    """--chunk_frames 8 --chunk_halo 8 on a 16-frame video gives the
    unchunked masks exactly (every kept frame sees its whole temporal
    receptive field); --chunk_halo 0 runs the truncating chunks."""
    root = write_ytvos(tmp_path / "long", {"vidL": 16}, seed=1)
    ckpt = checkpoint(tmp_path, shrunk)
    runs = {}
    for name, extra in (("full", []),
                        ("chunk", ["--chunk_frames", "8", "--chunk_halo", "8"]),
                        ("raw", ["--chunk_frames", "5", "--chunk_halo", "0"])):
        cli.main(base(root, str(tmp_path / name), ckpt) + ["--device", "cpu"]
                 + extra)
        runs[name] = masks(tmp_path / name)
    assert len(runs["full"]) == 16
    for k, v in runs["full"].items():
        np.testing.assert_array_equal(runs["chunk"][k], v, err_msg=str(k))
    assert runs["raw"].keys() == runs["full"].keys()


def test_refusals(ytvos_root, tmp_path):
    with pytest.raises(NotImplementedError, match="item 27"):
        cli.main(base(ytvos_root, str(tmp_path)) + ["--visualize"])
    with pytest.raises(NotImplementedError, match="slice 5"):
        cli.main(base(ytvos_root, str(tmp_path), model="lts"))

