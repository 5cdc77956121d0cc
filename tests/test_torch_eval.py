"""The port's RefCOCO evaluation path against the JAX package, on the CPU:
tokenizer, COCO masks, REFER, ReferDataset, SegMetrics, `evaluate` (one
process and two gloo ranks) and the `test` CLI.

The data tests run both packages on one synthetic on-disk RefCOCO (the
layout of test_data.py's `synthetic_refcoco`: `refs(unc).p`,
`instances.json`, COCO-named JPEGs, plus a `vocab.txt`), with polygon,
uncompressed-RLE and compressed-RLE annotations.  Everything is held
exactly, except the decoded images: the JAX dataset may take its native
JPEG loader, which agrees with PIL (the port's decoder) within 1 uint8 LSB.

`evaluate` runs on the small lavt_one of test_torch_model.py (weights
carried over by `convert/from_jax.py`, f32): per-sentence inter / union
within 1 % of H·W and the summaries within 1 point of the JAX loop's.
The margin is for argmax near-ties of f32 logits summed in another order,
not a defect.
"""

import argparse
import dataclasses
import enum
import json
import os
import pickle
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from lavt_rs_tpu.data import coco_mask as jcoco
from lavt_rs_tpu.data.refcoco import ReferDataset as JReferDataset
from lavt_rs_tpu.data.refer import REFER as JREFER
from lavt_rs_tpu.eval.refcoco_eval import _fwd_iou_for
from lavt_rs_tpu.eval.refcoco_eval import evaluate as jevaluate
from lavt_rs_tpu.metrics import SegMetrics as JSegMetrics
from lavt_rs_tpu.text.tokenizer import WordPieceTokenizer as JTokenizer
from lavt_rs_tpu.cli.args import model_config_from_args as jconfig_from_args
from lavt_rs_tpu_torch.cli import test as cli_test
from lavt_rs_tpu_torch.cli.args import model_config_from_args
from lavt_rs_tpu_torch.data import coco_mask
from lavt_rs_tpu_torch.data.refcoco import ReferDataset
from lavt_rs_tpu_torch.data.refer import REFER
from lavt_rs_tpu_torch.eval.pipeline import run_pipelined
from lavt_rs_tpu_torch.eval.refcoco_eval import evaluate, fwd_iou, ref_batches
from lavt_rs_tpu_torch.metrics import PR_THRESHOLDS, SegMetrics
from lavt_rs_tpu_torch.models.factory import build_model
from lavt_rs_tpu_torch.text.tokenizer import WordPieceTokenizer, resolve_vocab
from test_torch_model import IMG, TOKENS, pair  # noqa: F401  (module fixture)
from torch_threads import torch_threads  # noqa: F401 (autouse fixture)

REPO = Path(__file__).resolve().parents[1]
VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "the", "dog", "cat", "left",
         "right", "on", "a", "red", "man", "cafe", "##s", "in", "blue",
         "shirt", ",", "!", "small", "big", "person", "##y", "near"]
SENTENCES = [["the dog on the left", "a red dog"], ["Café man, in blue!"],
             ["cats near the big person", "small cat", "catsy right"],
             ["the person"], ["dog on the right", "a zebra-striped shirt"],
             ["big man"], ["left cat"], ["the red shirt", "blue dog"]]
SPLITS = ["val"] * 6 + ["train", "testA"]
SIZES = [(48, 64), (64, 48), (56, 72)]  # (h, w) of the three images


def rle_string(counts):
    """COCO compressed RLE of run lengths (pycocotools rleToString)."""
    out = []
    for i, x in enumerate(counts):
        if i > 2:
            x -= counts[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = (x != -1) if (c & 0x10) else (x != 0)
            out.append(chr((c | 0x20 if more else c) + 48))
    return "".join(out)


@pytest.fixture(scope="module")
def refcoco_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("refer_data")
    (root / "refcoco").mkdir()
    img_dir = root / "images" / "mscoco" / "images" / "train2014"
    img_dir.mkdir(parents=True)
    rng = np.random.default_rng(0)
    images, annotations, refs = [], [], []
    for i, (h, w) in enumerate(SIZES):
        fn = f"COCO_train2014_{i:012d}.jpg"
        # smooth content, so the JPEG decoders see real image structure
        yy, xx = np.mgrid[0:h, 0:w]
        img = np.stack([(yy * 3 + xx * 2) % 256, (xx * 5) % 256,
                        rng.integers(0, 256, (h, w))], -1).astype(np.uint8)
        Image.fromarray(img).save(img_dir / fn, quality=90)
        images.append({"id": i, "file_name": fn, "height": h, "width": w})
    for j, sents in enumerate(SENTENCES):
        img_id = j % 3
        h, w = SIZES[img_id]
        x0, y0 = 3 + 2 * j, 4 + j
        if j % 4 == 1:  # uncompressed RLE
            m = np.zeros((h, w), np.uint8)
            m[y0:y0 + 20, x0:x0 + 15] = 1
            seg = coco_mask.mask_to_rle(m)
        elif j % 4 == 3:  # compressed RLE
            m = np.zeros((h, w), np.uint8)
            m[y0:y0 + 9, x0:x0 + 30] = 1
            rle = coco_mask.mask_to_rle(m)
            seg = {"counts": rle_string(rle["counts"]), "size": [h, w]}
        else:  # two polygons
            seg = [[x0, y0, x0 + 25, y0 + 2, x0 + 20, y0 + 30, x0 + 1, y0 + 18],
                   [x0 + 30, y0, x0 + 38, y0, x0 + 38, y0 + 7]]
        annotations.append({"id": 100 + j, "image_id": img_id,
                            "category_id": 1, "segmentation": seg,
                            "area": 0, "bbox": [x0, y0, 10, 8],
                            "iscrowd": 0})
        refs.append({"ref_id": j, "ann_id": 100 + j, "image_id": img_id,
                     "category_id": 1, "split": SPLITS[j],
                     "sentences": [{"raw": s, "sent": s, "sent_id": 10 * j + k}
                                   for k, s in enumerate(sents)],
                     "sent_ids": [10 * j + k for k in range(len(sents))]})
    with open(root / "refcoco" / "refs(unc).p", "wb") as f:
        pickle.dump(refs, f)
    with open(root / "refcoco" / "instances.json", "w") as f:
        json.dump({"images": images, "annotations": annotations,
                   "categories": [{"id": 1, "name": "thing"}]}, f)
    (root / "vocab.txt").write_text("\n".join(VOCAB) + "\n")
    return str(root)


def _tokenizers(root):
    path = os.path.join(root, "vocab.txt")
    return (WordPieceTokenizer.from_vocab_file(path),
            JTokenizer.from_vocab_file(path))


def test_tokenizer_matches_jax(refcoco_root):
    tok, jtok = _tokenizers(refcoco_root)
    texts = [s for sents in SENTENCES for s in sents] + [
        "  Dogs\tON the  LEFT ", "naïve 猫 cat", "x" * 120, ""]
    for text in texts:
        assert tok.tokenize(text) == jtok.tokenize(text), text
        for n in (4, 20):
            ids, mask = tok.encode_padded(text, n)
            jids, jmask = jtok.encode_padded(text, n)
            np.testing.assert_array_equal(ids, jids)
            np.testing.assert_array_equal(mask, jmask)
    assert resolve_vocab("", refcoco_root) == os.path.join(refcoco_root,
                                                           "vocab.txt")
    with pytest.raises(FileNotFoundError):
        resolve_vocab("missing.txt", "")


def test_coco_masks_match_jax():
    rng = np.random.default_rng(3)
    m = (rng.random((13, 17)) > 0.5).astype(np.uint8)
    rle = coco_mask.mask_to_rle(m)
    assert rle == jcoco.mask_to_rle(m)
    s = rle_string(rle["counts"])
    assert coco_mask.decode_compressed_rle_counts(s) == rle["counts"]
    assert (coco_mask.decode_compressed_rle_counts(s)
            == jcoco.decode_compressed_rle_counts(s))
    for seg in (rle, {"counts": s, "size": [13, 17]},
                [[1, 1, 12, 2, 9, 11, 2, 8], [14, 0, 16, 0, 16, 5]]):
        got = coco_mask.annotation_to_mask(seg, 13, 17)
        np.testing.assert_array_equal(got, jcoco.annotation_to_mask(seg, 13, 17))
    np.testing.assert_array_equal(coco_mask.annotation_to_mask(rle, 13, 17), m)


def test_refer_matches_jax(refcoco_root):
    r, jr = (R(refcoco_root, "refcoco", "unc") for R in (REFER, JREFER))
    for split in ("train", "val", "testA", "test"):
        assert r.getRefIds(split=split) == jr.getRefIds(split=split)
    assert r.getRefIds(image_ids=[1]) == jr.getRefIds(image_ids=[1])
    assert r.getImgIds([0, 4, 5]) == jr.getImgIds([0, 4, 5])
    assert r.loadRefs([2, 3]) == jr.loadRefs([2, 3])
    for ref in r.refs:
        got, want = r.getMask(ref), jr.getMask(ref)
        np.testing.assert_array_equal(got["mask"], want["mask"])
        assert got["area"] == want["area"] > 0
        assert r.image_path(ref["image_id"]) == jr.image_path(ref["image_id"])


@pytest.mark.parametrize("eval_mode,host_normalize", [(True, False),
                                                      (False, True)])
def test_refer_dataset_matches_jax(refcoco_root, eval_mode, host_normalize):
    tok, jtok = _tokenizers(refcoco_root)
    split = "val" if eval_mode else "train"
    kw = dict(split=split, img_size=40, max_tokens=8, eval_mode=eval_mode,
              seed=4, host_normalize=host_normalize)
    ds = ReferDataset(REFER(refcoco_root), tok, **kw)
    jds = JReferDataset(JREFER(refcoco_root), jtok, **kw)
    assert len(ds) == len(jds) > 0
    for i in range(len(ds)):
        ex, jex = ds[i], jds[i]
        assert ex.image.dtype == jex.image.dtype
        lsb = 1.0 if ex.image.dtype == np.uint8 else 1.0 / 255 / 0.224
        np.testing.assert_allclose(ex.image.astype(np.float32),
                                   jex.image.astype(np.float32), rtol=0,
                                   atol=lsb * 1.0001)
        np.testing.assert_array_equal(ex.target, jex.target)
        assert ex.target.dtype == jex.target.dtype and ex.target.any()
        np.testing.assert_array_equal(ex.ids, jex.ids)
        np.testing.assert_array_equal(ex.mask, jex.mask)
        assert ex.ref_id == jex.ref_id


def test_seg_metrics_match_jax():
    rng = np.random.default_rng(9)
    union = rng.integers(0, 50, 40).astype(np.float64)
    union[:3] = 0
    inter = np.floor(union * rng.random(40))
    m, jm = SegMetrics(), JSegMetrics()
    for lo in range(0, 40, 7):
        m.update(inter[lo:lo + 7], union[lo:lo + 7])
        jm.update(inter[lo:lo + 7], union[lo:lo + 7])
    assert m.summary() == jm.summary() and m.n == jm.n == 40
    np.testing.assert_array_equal(m.stats_row(), jm.stats_row())
    # two shards merged
    parts = [SegMetrics(), SegMetrics()]
    parts[0].update(inter[:25], union[:25])
    parts[1].update(inter[25:], union[25:])
    rows = np.stack([p.stats_row() for p in parts])
    merged, jmerged = SegMetrics(), JSegMetrics()
    merged.merge_stats(rows)
    jmerged.merge_stats(rows)
    assert merged.summary() == jmerged.summary()
    assert merged.n == 40 and merged.pr_count == m.pr_count
    for k, v in m.summary().items():
        assert merged.summary()[k] == pytest.approx(v, rel=1e-12)
    assert tuple(PR_THRESHOLDS) == (0.5, 0.6, 0.7, 0.8, 0.9)


def _eval_ds(root, img_size=IMG):
    tok, _ = _tokenizers(root)
    return ReferDataset(REFER(root), tok, split="val", img_size=img_size,
                        max_tokens=TOKENS, eval_mode=True,
                        host_normalize=False)


def test_evaluate_matches_jax(refcoco_root, pair):  # noqa: F811
    """Six val refs of 1-3 sentences, S = 3, two refs per batch."""
    _, jm, variables, pm = pair
    ds = _eval_ds(refcoco_root)
    rb, hw = 2, IMG * IMG
    # one batch's per-sentence inter / union
    _, scounts, *arrays = next(ref_batches(ds, range(len(ds)), rb, 3))
    want = _fwd_iou_for(jm.apply)(variables, *arrays)
    got = fwd_iou(pm, *(torch.from_numpy(a) for a in arrays))
    for g, w in zip(got, want):
        assert g.shape == (rb, 3)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=0.01 * hw)
    # the whole loop
    summary = evaluate(pm, ds, refs_per_batch=rb, out_stream=sys.stdout)
    jsummary = jevaluate(lambda v, *a: jm.apply(v, *a), variables, ds,
                         refs_per_batch=rb, out_stream=sys.stdout)
    assert summary.keys() == jsummary.keys()
    for k in summary:
        assert abs(summary[k] - jsummary[k]) <= 1.0, (k, summary, jsummary)


def test_padded_sentence_rows_stay_finite(pair):  # noqa: F811
    """`evaluate` pads a ref's sentences with all-zero ids and masks: every
    word is masked in BERT and PWAM, and the logits stay finite."""
    pm = pair[3]
    img = torch.zeros((1, IMG, IMG, 3))
    ids = torch.zeros((1, TOKENS), dtype=torch.long)
    with torch.no_grad():
        logits = pm(img, ids, torch.zeros_like(ids))
    assert bool(torch.isfinite(logits).all())


_RANK_MAIN = """
import json, sys
import torch, torch.distributed as dist
from lavt_rs_tpu_torch.cli.test import SyntheticRefs
from lavt_rs_tpu_torch.eval.refcoco_eval import evaluate
sys.path.insert(0, sys.argv[4])
from test_torch_eval import synthetic_model
rank, world, port = (int(a) for a in sys.argv[1:4])
if world > 1:
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
try:
    s = evaluate(synthetic_model(), SyntheticRefs(), refs_per_batch=1)
    print("SUMMARY " + json.dumps(s))
finally:
    if world > 1:
        dist.destroy_process_group()
"""


def synthetic_model():
    """The CLI's --synthetic lavt_one (f32, seeded), on the CPU."""
    from lavt_rs_tpu_torch.config import BertConfig, ModelConfig, SwinConfig

    cfg = ModelConfig(swin=SwinConfig(embed_dim=48, depths=(1, 1, 2, 1),
                                      num_heads=(3, 6, 12, 24), window_size=7),
                      bert=BertConfig(num_layers=2), img_size=64, max_tokens=8,
                      dtype="float32")
    return build_model(cfg, "cpu", generator=torch.Generator().manual_seed(0))


def test_two_rank_sharded_evaluate_equals_one_process():
    """Two gloo ranks take items [r::2]; their merged summary equals a
    one-process run's.  One ref per batch, every process with the same
    thread count: each ref's forward has the same shape and the same
    arithmetic in both runs, so its IoU is the same bits; the merge adds
    the IoUs in another order, hence 1e-12."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, OMP_NUM_THREADS="2")
    env["PYTHONPATH"] = os.pathsep.join([str(REPO),
                                         env.get("PYTHONPATH", "")])
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK_MAIN, str(rank), str(world), str(port),
         str(REPO / "tests")], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env, cwd=str(REPO))
        for rank, world in ((0, 2), (1, 2), (0, 1))]
    summaries = []
    for p in procs:
        out, err = p.communicate(timeout=240)
        assert p.returncode == 0, err[-3000:]
        assert "(n=7)" in err  # every rank reports all 1 + 2 + 3 + 1 sentences
        summaries.append(json.loads(out.split("SUMMARY ", 1)[1]))
    *ranks, want = summaries
    for got in ranks:
        assert got.keys() == want.keys()
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=1e-12, abs=1e-12), k


def test_cli_synthetic_runs():
    env = dict(os.environ, OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "lavt_rs_tpu_torch.cli.test", "--synthetic",
         "--device", "cpu", "--no_bf16", "--max_items", "2"],
        capture_output=True, text=True, cwd=str(REPO), env=env, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "Final: mIoU=" in proc.stderr
    assert "'oIoU'" in proc.stdout


def test_cli_reads_a_refcoco_split(refcoco_root, tmp_path, capsys):
    """The real branch on the CPU: REFER, the tokenizer, ReferDataset and
    evaluate under a Swin-T model from a reference-format .pth."""
    args = ["--swin_type", "tiny", "--img_size", "64", "--device", "cpu",
            "--no_bf16", "--refer_data_root", refcoco_root, "--dataset",
            "refcoco", "--splitBy", "unc", "--split", "val", "--vocab",
            os.path.join(refcoco_root, "vocab.txt"), "--max_items", "3"]
    cfg = model_config_from_args(cli_test.get_parser().parse_args(args))
    assert cfg.swin.window_size == 7 and cfg.max_tokens == 20
    model = build_model(cfg, "cpu", generator=torch.Generator().manual_seed(1))
    path = tmp_path / "model.pth"
    torch.save({"model": model.state_dict()}, path)
    summary = cli_test.main(args + ["--checkpoint", str(path)])
    assert "Final: mIoU=" in capsys.readouterr().err
    assert set(summary) == {"mIoU", "oIoU"} | {f"P@{t}" for t in PR_THRESHOLDS}


@pytest.mark.parametrize("prefix,drop_position_ids", [("module.", True),
                                                       ("", False)])
def test_reference_checkpoint_loads(pair, tmp_path, prefix,  # noqa: F811
                                    drop_position_ids):
    pm = pair[3]
    sd = {prefix + k: v for k, v in pm.state_dict().items()
          if not (drop_position_ids and k.endswith("position_ids"))}
    path = tmp_path / "ckpt.pth"
    torch.save({"model": sd, "epoch": 3,
                "args": argparse.Namespace(model="lavt_one")}, path)
    fresh = build_model(pm.cfg, "cpu")
    cli_test.load_reference_checkpoint(fresh, str(path), torch.device("cpu"))
    for k, v in pm.state_dict().items():
        torch.testing.assert_close(fresh.state_dict()[k], v, rtol=0, atol=0)
    bad = tmp_path / "bad.pth"
    torch.save({"model": dict(list(sd.items())[:-1])}, bad)
    with pytest.raises(RuntimeError, match="missing"):
        cli_test.load_reference_checkpoint(fresh, str(bad),
                                           torch.device("cpu"))
    # a directory without an epoch_*.pth checkpoint of the train CLI
    with pytest.raises(FileNotFoundError, match="no epoch_"):
        cli_test.load_reference_checkpoint(fresh, str(tmp_path),
                                           torch.device("cpu"))
    # a directory stands for its newest checkpoint (the older one here
    # does not fit the model)
    run = tmp_path / "run"
    run.mkdir()
    torch.save({"model": dict(list(sd.items())[:-1])}, run / "epoch_0000.pth")
    torch.save({"model": sd, "epoch": 1}, run / "epoch_0001_lavt.pth")
    fresh = build_model(pm.cfg, "cpu")
    cli_test.load_reference_checkpoint(fresh, str(run), torch.device("cpu"))
    for k, v in pm.state_dict().items():
        torch.testing.assert_close(fresh.state_dict()[k], v, rtol=0, atol=0)


def test_cli_refuses_what_is_not_ported():
    """The test CLI's refusals; the fusion baselines, once refused here,
    run (tests/test_torch_variants_cli.py)."""
    for extra, where in ((["--dataset", "ytvos"], "slice 3"),
                         (["--save_vis", "out"], "item 27"),
                         (["--save_feats", "out"], "item 27")):
        with pytest.raises(NotImplementedError, match=where):
            cli_test.main(["--synthetic", "--device", "cpu"] + extra)


def _plain(obj):
    """A config as nested plain values (enums by value)."""
    if dataclasses.is_dataclass(obj):
        return {f.name: _plain(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, enum.Enum):
        return obj.value
    if isinstance(obj, (tuple, list)):
        return tuple(_plain(v) for v in obj)
    return obj


@pytest.mark.parametrize("argv", [
    ["--window12"],
    ["--swin_type", "tiny", "--no_bf16", "--mha", "1-2-4-8", "--hs"],
    ["--pretrained_swin_weights", "swin_base_window12.pth", "--version",
     "no_gate", "--lg_act_layer", "sigmoid", "--fusion_drop", "0.1"],
    ["--model", "lavt_video", "--swin_type", "small", "--w_3x3",
     "--sept_sum_3_kernel_size", "1-3-3", "--ts_pwam", "--tspwam_sum"]])
def test_model_config_from_args_matches_jax(argv):
    args = cli_test.get_parser().parse_args(argv)
    got, want = _plain(model_config_from_args(args)), _plain(
        jconfig_from_args(args))
    for section in ("swin", "fusion", "tpwam"):
        assert got[section] == want[section], section
    for key in ("name", "img_size", "max_tokens", "dtype", "lazy_pred",
                "num_frames", "hybrid_2d_3d", "use_checkpoint"):
        assert got[key] == want[key], key
    assert got["use_kernels"] is True


def _producers():
    return [t for t in threading.enumerate() if t.name == "eval-producer"]


@pytest.mark.parametrize("depth", [1, 2, 5])
def test_run_pipelined_keeps_order_and_stops_its_thread(depth):
    got = []
    run_pipelined(lambda: iter(range(40)), lambda i: i * i,
                  lambda i, r: got.append((i, r)), depth)
    assert got == [(i, i * i) for i in range(40)]
    assert not _producers()

    def failing():
        yield 1
        raise KeyError("decode")

    with pytest.raises(KeyError, match="decode"):
        run_pipelined(failing, lambda i: i, lambda i, r: None, depth)
    assert not _producers()

    def sink(i, r):
        if i == 3:
            raise ValueError("sink")

    # the consumer fails while the producer blocks on a full queue
    with pytest.raises(ValueError, match="sink"):
        run_pipelined(lambda: iter(range(10 ** 6)), lambda i: i, sink, depth)
    assert not _producers()


def test_run_pipelined_returns_the_wait_on_its_producer():
    """The consumer's seconds blocked on the queue: at least the slow
    producer's 3 x 50 ms, which nothing else in the loop overlaps."""
    def slow():
        for i in range(3):
            time.sleep(0.05)
            yield i

    waited = run_pipelined(slow, lambda i: i, lambda i, r: None)
    assert 0.14 <= waited < 5
    assert run_pipelined(lambda: iter(()), lambda i: i,
                         lambda i, r: None) < 5
