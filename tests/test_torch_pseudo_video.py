"""The port's pseudo-video data (`data/pseudo_video.py`, `data/refexp2seq.py`)
against the JAX package, on the CPU.

  * `ImageToSeqAugmenter`: for two seeds, several calls on a 40x50 image
    and its mask, bitwise (the same random draws in the same order, the
    same cv2 calls), and the generators' states equal after them;
  * `ReferPseudoVideos` with and without an augmenter on JAX's
    `synthetic_refcoco` fixture (uint8 clips, and normalized on the host),
    several indices in sequence (so the shared sentence / shuffle and
    augmenter generators advance);
  * `RefExpPseudoVideos` through `build_refexp_dataset` on a COCO-format
    refexp json written here (a polygon, an RLE, a crowd annotation, an
    entry left without annotations).

Every item: `video` within 1 uint8 LSB of JAX's (the JAX package resizes
with its native loader, the port with PIL; normalized, 1 LSB over the
smallest ImageNet std), `target`, `valid_index`,
`valid`, `ids`, `mask` and `image_id` equal.
"""

import json
import os

import numpy as np
import pytest
from PIL import Image

from lavt_rs_tpu.data import pseudo_video as jpv
from lavt_rs_tpu.data import refexp2seq as jrx
from lavt_rs_tpu.data.refer import REFER as JREFER
from lavt_rs_tpu.text.tokenizer import WordPieceTokenizer as JTokenizer
from lavt_rs_tpu_torch.data import pseudo_video as pv
from lavt_rs_tpu_torch.data import refexp2seq as rx
from lavt_rs_tpu_torch.data.coco_mask import mask_to_rle
from lavt_rs_tpu_torch.data.refer import REFER
from lavt_rs_tpu_torch.text.tokenizer import WordPieceTokenizer
from test_data import VOCAB, synthetic_refcoco  # noqa: F401  (fixture)
from torch_threads import torch_threads  # noqa: F401 (autouse fixture)

CLIP = dict(num_frames=4, img_size=32, max_tokens=22, host_normalize=False)
# indices in the order they are read: each ref more than once
ORDER = (0, 1, 1, 0, 1)


@pytest.fixture(scope="module")
def toks():
    vocab = {w: i for i, w in enumerate(VOCAB)}
    return WordPieceTokenizer(vocab), JTokenizer(vocab)


def assert_same_item(got, want):
    assert got.video.shape == want.video.shape
    assert got.video.dtype == want.video.dtype
    if got.video.dtype == np.uint8:
        diff = np.abs(got.video.astype(np.int16) - want.video.astype(np.int16))
        assert diff.max() <= 1, diff.max()
    else:  # normalized on the host: 1 LSB over the smallest ImageNet std
        np.testing.assert_allclose(got.video, want.video, rtol=0,
                                   atol=1 / 255 / 0.224 + 1e-6)
    np.testing.assert_array_equal(got.target, want.target)
    assert got.target.dtype == want.target.dtype
    assert (got.valid_index, got.valid, got.image_id) == \
        (want.valid_index, want.valid, want.image_id)
    np.testing.assert_array_equal(got.ids, want.ids)
    np.testing.assert_array_equal(got.mask, want.mask)


@pytest.mark.parametrize("seed", [0, 7])
def test_augmenter_bitwise(seed):
    rng = np.random.default_rng(seed)
    image = rng.integers(0, 256, (40, 50, 3), np.uint8)
    mask = np.zeros((40, 50), np.uint8)
    mask[8:30, 10:35] = 1
    got, want = pv.ImageToSeqAugmenter(seed=seed), \
        jpv.ImageToSeqAugmenter(seed=seed)
    moved = 0
    for _ in range(6):
        (gi, gm), (wi, wm) = got(image, mask), want(image, mask)
        assert gi.dtype == wi.dtype and gm.dtype == wm.dtype
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gm, wm)
        assert gi.shape == image.shape and gm.shape == mask.shape
        moved += int(not np.array_equal(gm, mask))
    assert moved == 6  # every call jitters the mask
    assert got.rng.getstate() == want.rng.getstate()


@pytest.mark.parametrize("augment,host_normalize", [
    (False, False), (True, False), (True, True)])
def test_refer_pseudo_videos(synthetic_refcoco, toks, augment,  # noqa: F811
                             host_normalize):
    tok, jtok = toks
    clip = dict(CLIP, host_normalize=host_normalize)
    got = pv.ReferPseudoVideos(
        REFER(synthetic_refcoco), tok, split="train",
        augmenter=pv.ImageToSeqAugmenter(seed=3) if augment else None,
        **clip)
    want = jpv.ReferPseudoVideos(
        JREFER(synthetic_refcoco), jtok, split="train",
        augmenter=jpv.ImageToSeqAugmenter(seed=3) if augment else None,
        **clip)
    assert len(got) == len(want) == 2
    orders = set()
    for i in ORDER:
        a, b = got[i], want[i]
        assert_same_item(a, b)
        assert a.target.sum() > 0
        if not augment:
            assert a.valid_index == 0
            assert all(np.array_equal(f, a.video[0]) for f in a.video)
        orders.add(a.valid_index)
    assert got.rng.getstate() == want.rng.getstate()
    if augment:
        assert len(orders) > 1  # the frame order is shuffled


@pytest.fixture(scope="module")
def refexp_root(tmp_path_factory):
    """A COCO-format refexp root: two 40x50 images, five sentence entries
    (a polygon, an RLE, one whose only annotation is a crowd, one without
    annotations, one with a crowd beside its polygon)."""
    root = tmp_path_factory.mktemp("refexp")
    img_dir = root / "images" / "mscoco" / "images" / "train2014"
    img_dir.mkdir(parents=True)
    (root / "refcoco").mkdir()
    rng = np.random.default_rng(5)
    for k in range(2):
        Image.fromarray(rng.integers(0, 255, (40, 50, 3), np.uint8)).save(
            img_dir / f"img{k}.jpg")
    rle_mask = np.zeros((40, 50), np.uint8)
    rle_mask[12:33, 20:44] = 1
    square = [[5, 5, 25, 5, 25, 20, 5, 20]]
    entries = [(1, "img0.jpg", "the dog on the left"),
               (2, "img1.jpg", "a red cat"),
               (3, "img0.jpg", "the crowd"),
               (4, "img1.jpg", "no annotations"),
               (5, "img1.jpg", "the cat on the right")]
    anns = [(10, 1, square, 0), (11, 2, mask_to_rle(rle_mask), 0),
            (12, 3, square, 1),
            (13, 5, [[30, 25, 45, 25, 45, 35, 30, 35]], 0),
            (14, 5, square, 1)]
    coco = {
        "images": [{"id": i, "file_name": fn, "height": 40, "width": 50,
                    "caption": cap} for i, fn, cap in entries],
        "annotations": [{"id": a, "image_id": i, "category_id": 1,
                         "iscrowd": crowd, "area": 1, "segmentation": seg,
                         "bbox": [0, 0, 1, 1]}
                        for a, i, seg, crowd in anns]}
    with open(root / "refcoco" / "instances_refcoco_train.json", "w") as f:
        json.dump(coco, f)
    return str(root)


def test_refexp_pseudo_videos(refexp_root, toks):
    tok, jtok = toks
    got = rx.build_refexp_dataset("refcoco", "train", refexp_root, tok,
                                  seed=2, **CLIP)
    want = jrx.build_refexp_dataset("refcoco", "train", refexp_root, jtok,
                                    seed=2, **CLIP)
    assert got.img_folder == want.img_folder and os.path.isdir(got.img_folder)
    assert got.ids == want.ids == [1, 2, 5]  # 3: crowd only; 4: none
    assert len(got.anns_by_image[5]) == 1  # its crowd annotation dropped
    for i in ORDER + (2, 0, 2):
        a, b = got[i], want[i]
        assert_same_item(a, b)
        assert a.target.sum() > 0
    assert got.rng.getstate() == want.rng.getstate()
    assert got.augmenter.rng.getstate() == want.augmenter.rng.getstate()
    # an augmenter passed in is the one taken
    aug = pv.ImageToSeqAugmenter(seed=9)
    assert rx.build_refexp_dataset("refcoco", "train", refexp_root, tok,
                                   augmenter=aug, **CLIP).augmenter is aug
