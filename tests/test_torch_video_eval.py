"""The port's A2D evaluation path against the JAX package, on the CPU: the
frame samplers, J / F, the A2D and YTVOS datasets, `evaluate_a2d`,
`evaluate_ytvos_jf` and `cli.test --dataset a2d` (with --a2d_masks).

The fixtures are tests/test_video_data.py's (a 10-frame mp4 with an h5
instance mask; a 4-frame YTVOS video with palette-PNG masks), copied, with
one A2D sentence more whose instance is absent from its frame (so the
dataset resamples).  Every item is held bitwise: the clips, targets,
ids, masks, annotated positions and names.  (The JAX package resizes
frames with its native loader, which agrees with PIL, the port's, within
1 uint8 LSB in general, and bitwise at these sizes.)  The eval loops run one small f32 lavt_video in
both packages (the weights carried by a reference .pth through both
CLIs' loaders, or by `convert/from_jax.py`): per-clip inter / union
within 1 % of H·W and summaries within 1 point, as
tests/test_torch_eval.py holds the RefCOCO eval (argmax near-ties of f32
logits summed in another order).
"""

import dataclasses
import json
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from lavt_rs_tpu import config as JC
from lavt_rs_tpu.data import video_sampling as jvs
from lavt_rs_tpu.data.a2d import A2DSentencesDataset as JA2D
from lavt_rs_tpu.data.ytvos import YTVOSDataset as JYTVOS
from lavt_rs_tpu.eval import video_eval as jvideo_eval
from lavt_rs_tpu.metrics_video import JFMetrics as JJF
from lavt_rs_tpu.metrics_video import f_measure as jf_measure
from lavt_rs_tpu.metrics_video import j_measure as jj_measure
from lavt_rs_tpu.models.factory import build_model as jbuild_model
from lavt_rs_tpu.text.tokenizer import WordPieceTokenizer as JTokenizer
from lavt_rs_tpu_torch import config as C
from lavt_rs_tpu_torch.cli import test as cli_test
from lavt_rs_tpu_torch.convert.from_jax import state_dict_from_jax
from lavt_rs_tpu_torch.data import video_sampling as vs
from lavt_rs_tpu_torch.data.a2d import A2DSentencesDataset
from lavt_rs_tpu_torch.data.ytvos import YTVOSDataset
from lavt_rs_tpu_torch.eval import video_eval
from lavt_rs_tpu_torch.metrics_video import JFMetrics, f_measure, j_measure
from lavt_rs_tpu_torch.models.factory import build_model
from lavt_rs_tpu_torch.text.tokenizer import WordPieceTokenizer
from test_torch_model import random_variables
from torch_threads import torch_threads  # noqa: F401 (autouse fixture)

VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "the", "dog", "running",
         "a", "cat"]
SWIN = dict(embed_dim=16, depths=(1, 1, 1, 1), num_heads=(1, 2, 4, 8),
            window_size=4, window_size_3d=(2, 4, 4), drop_path_rate=0.0)
IMG = 32


@pytest.fixture(scope="module")
def toks():
    vocab = {w: i for i, w in enumerate(VOCAB)}
    return WordPieceTokenizer(vocab), JTokenizer(vocab)


@pytest.fixture(scope="module")
def a2d_fixture(tmp_path_factory):
    import cv2
    import h5py

    root = tmp_path_factory.mktemp("a2d")
    clips = root / "Release" / "clips320H"
    anns = root / "Release" / "a2d_annotation_with_instances" / "vid1"
    clips.mkdir(parents=True)
    anns.mkdir(parents=True)

    # 10-frame synthetic mp4
    w = cv2.VideoWriter(str(clips / "vid1.mp4"),
                        cv2.VideoWriter_fourcc(*"mp4v"), 10, (32, 24))
    rng = np.random.default_rng(0)
    for _ in range(10):
        w.write(rng.integers(0, 255, (24, 32, 3), np.uint8))
    w.release()

    # h5 mask for (1-indexed) frame 5 with 2 instances; instance 0 empty
    m = np.zeros((2, 32, 24), np.uint8)  # stored transposed
    m[1, 5:15, 5:15] = 1
    with h5py.File(anns / "00005.h5", "w") as f:
        f["instance"] = np.array([0, 7])
        f["reMask"] = m

    ann_file = root / "train_ann.json"
    with open(ann_file, "w") as f:
        json.dump([["the dog running", "vid1", 5, 7],
                   ["a cat", "vid1", 5, 0]], f)
    return str(root), str(ann_file)


@pytest.fixture(scope="module")
def ytvos_fixture(tmp_path_factory):
    root = tmp_path_factory.mktemp("ytvos")
    frames = [f"{i:05d}" for i in range(0, 20, 5)]
    jdir = root / "JPEGImages" / "vidA"
    adir = root / "Annotations" / "vidA"
    jdir.mkdir(parents=True)
    adir.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for fr in frames:
        Image.fromarray(rng.integers(0, 255, (24, 32, 3), np.uint8)
                        ).save(jdir / f"{fr}.jpg")
        m = np.zeros((24, 32), np.uint8)
        m[4:12, 6:20] = 2  # obj_id 2
        img = Image.fromarray(m, mode="P")
        # full palette so PIL's PNG writer can't re-index the values
        img.putpalette(sum(([i, i, i] for i in range(256)), []))
        img.save(adir / f"{fr}.png", bits=8)

    meta = {"videos": {"vidA": {
        "frames": frames,
        "expressions": {"0": {"exp": "a cat", "obj_id": "2"},
                        "1": {"exp": "the dog", "obj_id": "3"}}}}}
    ann = root / "meta.json"
    with open(ann, "w") as f:
        json.dump(meta, f)
    return str(root), str(ann)


def test_samplers_match_jax():
    """Same seeds, same draws, same clips: every branch of the sparse
    sampler (global fill from outside the local span, from the whole
    video, with repeats) and the edge-padded window."""
    for seed in range(20):
        rng, jrng = random.Random(seed), random.Random(seed)
        for vid_len, frame_id, n in ((30, 2, 8), (30, 29, 8), (8, 4, 8),
                                     (4, 1, 8), (4, 3, 3), (10, 5, 16)):
            got = vs.sparse_sample(frame_id, vid_len, n, rng)
            assert got == jvs.sparse_sample(frame_id, vid_len, n, jrng)
        assert rng.random() == jrng.random()
    for frame_id, vid_len, n in ((1, 30, 8), (29, 30, 8), (4, 10, 16),
                                 (0, 1, 16), (5, 11, 7)):
        assert (vs.consecutive_window(frame_id, vid_len, n)
                == jvs.consecutive_window(frame_id, vid_len, n))


def test_j_and_f_match_jax():
    rng = np.random.default_rng(3)
    jf, jjf = JFMetrics(), JJF()
    for h, w in ((24, 32), (64, 48), (120, 160)):
        gt = np.zeros((h, w), np.uint8)
        gt[h // 4:3 * h // 4, w // 5:w // 2] = 1
        for pred in ((rng.random((h, w)) > 0.7).astype(np.uint8),
                     np.roll(gt, 3, axis=1), gt, np.zeros_like(gt)):
            assert j_measure(pred, gt) == jj_measure(pred, gt)
            assert f_measure(pred, gt) == jf_measure(pred, gt)
            jf.update(np.stack([pred, gt]), np.stack([gt, gt]))
            jjf.update(np.stack([pred, gt]), np.stack([gt, gt]))
    assert f_measure(np.zeros((8, 8)), np.zeros((8, 8))) == 1.0
    assert jf.summary() == jjf.summary()


def _same_example(ex, jex):
    assert ex.video.dtype == jex.video.dtype and ex.video.shape == jex.video.shape
    np.testing.assert_array_equal(ex.video, jex.video)
    np.testing.assert_array_equal(ex.target, jex.target)
    assert ex.target.dtype == jex.target.dtype
    np.testing.assert_array_equal(ex.ids, jex.ids)
    np.testing.assert_array_equal(ex.mask, jex.mask)
    assert (ex.valid_index, ex.valid, ex.image_id) == (
        jex.valid_index, jex.valid, jex.image_id)


@pytest.mark.parametrize("kw", [
    dict(subset="train", num_frames=4),
    dict(subset="val", clip_length=6, host_normalize=False),
    dict(subset="val", clip_length=16, not_consecutive=True),
], ids=["train", "val", "not_consecutive"])
def test_a2d_dataset_matches_jax(a2d_fixture, toks, kw):
    """Item 1's instance is absent from its frame: both datasets resample
    from their generators, in step."""
    root, ann = a2d_fixture
    ds = A2DSentencesDataset(root, ann, toks[0], img_size=32, seed=3, **kw)
    jds = JA2D(root, ann, toks[1], img_size=32, seed=3, **kw)
    assert len(ds) == len(jds) == 2
    for i in (0, 1, 1, 0):
        _same_example(ds[i], jds[i])
    assert ds[0].target.sum() > 0 and ds[0].image_id == "v_vid1_f_5_i_7"


def test_ytvos_dataset_matches_jax(ytvos_fixture, toks):
    """Expression 1 names an object absent from every frame: resampled."""
    root, ann = ytvos_fixture
    for num_frames, host_normalize in ((4, True), (2, False)):
        kw = dict(num_frames=num_frames, img_size=32, seed=5,
                  host_normalize=host_normalize)
        ds, jds = YTVOSDataset(root, ann, toks[0], **kw), JYTVOS(
            root, ann, toks[1], **kw)
        assert len(ds) == len(jds) == 8 // num_frames
        for i in list(range(len(ds))) * 2:
            _same_example(ds[i], jds[i])


# -- the eval loops and the CLI --------------------------------------------------

def _video_cfgs():
    jcfg = JC.lavt_video_tiny().replace(
        swin=JC.SwinConfig(**SWIN), bert=JC.BertConfig(
            vocab_size=len(VOCAB), num_layers=1),
        img_size=IMG, max_tokens=22, num_frames=4)
    cfg = C.lavt_video_tiny().replace(
        swin=C.SwinConfig(**SWIN), bert=C.BertConfig(
            vocab_size=len(VOCAB), num_layers=1),
        img_size=IMG, max_tokens=22, num_frames=4, dtype="float32")
    return jcfg, cfg


@pytest.fixture(scope="module")
def video_pair():
    """The small lavt_video in both packages on one set of seeded weights."""
    jcfg, cfg = _video_cfgs()
    jm = jbuild_model(jcfg)
    vid = jnp.zeros((1, 4, IMG, IMG, 3))
    ids = jnp.ones((1, 22), jnp.int32)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), vid, ids,
                                            ids))
    variables = random_variables({k: shapes[k] for k in
                                  ("params", "batch_stats")},
                                 np.random.default_rng(17))
    pm = build_model(cfg, device="cpu")
    pm.load_state_dict(state_dict_from_jax(variables, cfg), strict=True)
    return jm, variables, pm


def test_evaluate_a2d_matches_jax(a2d_fixture, toks, video_pair):
    jm, variables, pm = video_pair
    root, ann = a2d_fixture
    kw = dict(subset="val", clip_length=6, img_size=IMG, host_normalize=False)
    ds = A2DSentencesDataset(root, ann, toks[0], **kw)
    jds = JA2D(root, ann, toks[1], **kw)
    summary = video_eval.evaluate_a2d(pm, ds)
    jsummary = jvideo_eval.evaluate_a2d(lambda v, *a: jm.apply(v, *a),
                                        variables, jds)
    assert summary.keys() == jsummary.keys()
    for k in summary:
        assert abs(summary[k] - jsummary[k]) <= 1.0, (k, summary, jsummary)
    # one clip's inter / union against the JAX forward's
    ex = ds[0]
    logits = np.asarray(jm.apply(variables, jvideo_eval.maybe_normalize_image(
        jnp.asarray(ex.video[None])), ex.ids[None].astype(np.int32),
        ex.mask[None].astype(np.int32)))
    pred = logits[ex.valid_index].argmax(-1)
    want = (np.logical_and(pred, ex.target).sum(),
            np.logical_or(pred, ex.target).sum())
    got = video_eval.clip_iou(pm, *(torch.from_numpy(a) for a in (
        ex.video, ex.ids.astype(np.int64), ex.mask.astype(np.int64))),
        ex.valid_index, torch.from_numpy(ex.target))
    for g, w in zip(got, want):
        assert abs(g.item() - w) <= 0.01 * IMG * IMG


def test_evaluate_ytvos_jf_matches_jax(ytvos_fixture, toks, video_pair):
    jm, variables, pm = video_pair
    root, ann = ytvos_fixture
    kw = dict(num_frames=4, img_size=IMG, host_normalize=False, seed=2)
    summary = video_eval.evaluate_ytvos_jf(
        pm, YTVOSDataset(root, ann, toks[0], **kw))
    jsummary = jvideo_eval.evaluate_ytvos_jf(
        lambda v, *a: jm.apply(v, *a), variables,
        JYTVOS(root, ann, toks[1], **kw))
    for k in ("J", "F", "J&F"):
        assert abs(summary[k] - jsummary[k]) <= 1.0, (k, summary, jsummary)


def _shrunk(real):
    def config(args):
        cfg = real(args)
        return cfg.replace(swin=type(cfg.swin)(**SWIN), bert=dataclasses.replace(
            cfg.bert, num_layers=1, vocab_size=len(VOCAB)), img_size=IMG)
    return config


@pytest.mark.parametrize("extra", [[], ["--not_consecutive"]],
                         ids=["consecutive", "not_consecutive"])
def test_cli_a2d_matches_jax(a2d_fixture, tmp_path, monkeypatch, extra):
    """`--model lavt_video --dataset a2d --a2d_masks` through both CLIs on
    one reference .pth: the summaries within 1 point, each dumped mask
    within 1 % of its pixels."""
    import lavt_rs_tpu.cli.args as jargs
    import lavt_rs_tpu_torch.cli.args as pargs
    from lavt_rs_tpu.cli import test as jcli_test

    monkeypatch.setattr(jargs, "model_config_from_args",
                        _shrunk(jargs.model_config_from_args))
    monkeypatch.setattr(pargs, "model_config_from_args",
                        _shrunk(pargs.model_config_from_args))
    root, ann = a2d_fixture
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(VOCAB) + "\n")
    cfg = pargs.model_config_from_args(cli_test.get_parser().parse_args(
        ["--model", "lavt_video", "--no_bf16"]))
    model = build_model(cfg, "cpu", generator=torch.Generator().manual_seed(4))
    ckpt = tmp_path / "a2d.pth"
    torch.save({"model": model.state_dict()}, ckpt)
    argv = ["--model", "lavt_video", "--dataset", "a2d", "--a2d_data_root",
            root, "--a2d_ann", ann, "--vocab", str(vocab), "--img_size",
            str(IMG), "--clip_length", "6", "--a2d_masks", "--no_bf16",
            "--checkpoint", str(ckpt)] + extra
    summary = cli_test.main(argv + ["--device", "cpu", "--output-dir",
                                    str(tmp_path / "port")])
    jsummary = jcli_test.main(argv + ["--output-dir", str(tmp_path / "jax")])
    for k in summary:
        assert abs(summary[k] - jsummary[k]) <= 1.0, (k, summary, jsummary)
    names = sorted(p.name for p in (tmp_path / "jax" / "a2d_masks").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port" /
                                            "a2d_masks").iterdir())
    assert names == ["v_vid1_f_5_i_7.png"]
    for name in names:
        got = np.asarray(Image.open(tmp_path / "port" / "a2d_masks" / name))
        want = np.asarray(Image.open(tmp_path / "jax" / "a2d_masks" / name))
        assert got.shape == want.shape == (IMG, IMG)
        assert set(np.unique(got)) <= {0, 255}
        assert (got != want).mean() <= 0.01


def test_cli_a2d_synthetic_and_refusals(capsys):
    summary = cli_test.main(["--model", "lavt_video", "--dataset", "a2d",
                             "--synthetic", "--device", "cpu", "--no_bf16"])
    assert "A2D: mIoU=" in capsys.readouterr().err
    assert "P@0.5" in summary
    with pytest.raises(ValueError, match="goes with --model lavt_video"):
        cli_test.main(["--dataset", "a2d", "--synthetic", "--device", "cpu"])
    with pytest.raises(ValueError, match="goes with --model lavt_video"):
        cli_test.main(["--model", "lavt_video", "--synthetic", "--device",
                       "cpu"])
