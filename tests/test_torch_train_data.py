"""The port's training data path against the JAX package's, on the CPU:
the paired augmentations, `ReferDataset(augment=...)`, `batch_iterator`,
`PrefetchLoader` with its collates, `ConcatDataset`, the metric logger and
`train_config_from_args`.

Everything is held bitwise (numpy arrays equal, floats equal): both
packages make the same PIL and numpy calls in the same order.  The data
tests read JAX's `synthetic_refcoco` fixture (test_data.py: three 40x50
JPEGs, two train refs, one val, one testA).  Where the JAX dataset decodes
without augmentation it may take its native JPEG loader, which agrees with
PIL (the port's decoder) within 1 uint8 LSB; those tests switch it off, so
that the JAX dataset takes its own PIL path and the images agree bitwise.
"""

import argparse
import dataclasses
import io
import re

import numpy as np
import pytest
from PIL import Image

import lavt_rs_tpu.native as jnative
from lavt_rs_tpu.cli import train as jcli_train
from lavt_rs_tpu.cli.args import train_config_from_args as jtrain_config
from lavt_rs_tpu.data import loader as jloader
from lavt_rs_tpu.data import transforms as jT
from lavt_rs_tpu.data.pseudo_video import ConcatDataset as JConcatDataset
from lavt_rs_tpu.data.refcoco import ReferDataset as JReferDataset
from lavt_rs_tpu.data.refcoco import batch_iterator as jbatch_iterator
from lavt_rs_tpu.data.refer import REFER as JREFER
from lavt_rs_tpu.text.tokenizer import WordPieceTokenizer as JTokenizer
from lavt_rs_tpu.utils import logging as jlogging
from lavt_rs_tpu_torch.cli import train as cli_train
from lavt_rs_tpu_torch.cli.args import train_config_from_args
from lavt_rs_tpu_torch.data import loader
from lavt_rs_tpu_torch.data import transforms as T
from lavt_rs_tpu_torch.data.pseudo_video import ConcatDataset
from lavt_rs_tpu_torch.data.refcoco import ReferDataset, batch_iterator
from lavt_rs_tpu_torch.data.refer import REFER
from lavt_rs_tpu_torch.text.tokenizer import WordPieceTokenizer
from lavt_rs_tpu_torch.utils import logging as tlogging
from test_data import VOCAB, synthetic_refcoco  # noqa: F401  (fixture)
from torch_threads import torch_threads  # noqa: F401 (autouse fixture)


def _pair(seed=0, w=53, h=41):
    """A smooth RGB image and a two-valued mask ("L", values 0 / 1)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([(yy * 5 + xx * 3) % 256, (xx * 7) % 256,
                    rng.integers(0, 256, (h, w))], -1).astype(np.uint8)
    mask = ((yy - h / 2) ** 2 + (xx - w / 3) ** 2 < (h / 3) ** 2)
    return Image.fromarray(img), Image.fromarray(mask.astype(np.uint8))


# (name, call(module, img, mask, rng)): every paired augmentation and
# their compositions, each from one seed and one PIL pair
AUGMENTATIONS = [
    ("random_hflip_pair", lambda m, i, k, r: m.random_hflip_pair(i, k, r)),
    ("random_resize_pair", lambda m, i, k, r: m.random_resize_pair(
        i, k, 20, 70, r)),
    ("random_resize_pair_fixed", lambda m, i, k, r: m.random_resize_pair(
        i, k, 41, None, r)),
    ("pad_if_smaller", lambda m, i, k, r: (m.pad_if_smaller(i, 60),
                                           m.pad_if_smaller(k, 60, 255))),
    ("random_crop_pair", lambda m, i, k, r: m.random_crop_pair(i, k, 30, r)),
    ("random_crop_pair_padded", lambda m, i, k, r: m.random_crop_pair(
        i, k, 48, r)),
    ("center_crop_pair", lambda m, i, k, r: m.center_crop_pair(i, k, 45)),
    ("affine_pair", lambda m, i, k, r: m.affine_pair(
        i, k, 17.0, (3, -2), 1.1, (5.0, -4.0))),
    ("random_affine_pair", lambda m, i, k, r: m.random_affine_pair(
        i, k, r, degrees=(-30, 30), translate=(0.1, 0.2), scale=(0.8, 1.2),
        shear=(-5, 5, -3, 3))),
    ("random_affine_pair_shear2", lambda m, i, k, r: m.random_affine_pair(
        i, k, r, degrees=(-10, 10), shear=(-8, 8))),
    ("build_paired_augment_all", lambda m, i, k, r: m.build_paired_augment(
        resize_range=(30, 60), hflip=0.5, crop=32,
        affine={"degrees": (-15, 15), "translate": (0.1, 0.1),
                "scale": (0.9, 1.1)}, seed=7)(i, k)),
    ("build_paired_augment_hflip", lambda m, i, k, r: m.build_paired_augment(
        hflip=0.7, seed=3)(i, k)),
    ("build_paired_augment_crop", lambda m, i, k, r: m.build_paired_augment(
        crop=50, seed=5)(i, k)),
]


@pytest.mark.parametrize("name,call", AUGMENTATIONS,
                         ids=[a[0] for a in AUGMENTATIONS])
def test_paired_augmentation_matches_jax(name, call):
    for seed in range(4):
        img, mask = _pair(seed)
        rng, jrng = np.random.default_rng(seed), np.random.default_rng(seed)
        got, want = call(T, img, mask, rng), call(jT, img, mask, jrng)
        for g, w in zip(got, want):
            assert g.mode == w.mode and g.size == w.size
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
        assert rng.random() == jrng.random()  # the same number of draws


def test_augmentation_helpers_match_jax():
    for w, h, s in ((50, 40, 40), (40, 50, 30), (64, 64, 64), (31, 77, 480)):
        assert T._smaller_edge_size(w, h, s) == jT._smaller_edge_size(w, h, s)
    for args in (((20.5, 10.5), 30.0, (2, 3), 1.2, (4.0, -2.0)),
                 ((0.5, 0.5), -90.0, (0, 0), 1.0, (0.0, 0.0))):
        assert T._inverse_affine_matrix(*args) == \
            jT._inverse_affine_matrix(*args)
    assert T.build_paired_augment() is None
    assert jT.build_paired_augment() is None


@pytest.fixture
def pil_only(monkeypatch):
    """The JAX dataset decodes with PIL (its native loader switched off)."""
    monkeypatch.setattr(jnative, "decode_resize_jpeg", lambda *a, **k: None)


def _datasets(root, augment=None, jaugment=None, split="train", **kw):
    tok = WordPieceTokenizer({w: i for i, w in enumerate(VOCAB)})
    jtok = JTokenizer({w: i for i, w in enumerate(VOCAB)})
    kw = dict(split=split, img_size=24, max_tokens=8, **kw)
    return (ReferDataset(REFER(root, "refcoco", "unc"), tok, augment=augment,
                         **kw),
            JReferDataset(JREFER(root, "refcoco", "unc"), jtok,
                          augment=jaugment, **kw))


def _same_example(ex, jex):
    for f in ("image", "target", "ids", "mask"):
        a, b = getattr(ex, f), getattr(jex, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert ex.ref_id == jex.ref_id


AUG = dict(resize_range=(30, 60), hflip=0.5, crop=28,
           affine={"degrees": (-20, 20), "translate": (0.1, 0.1)})


@pytest.mark.parametrize("augmented,host_normalize", [
    (False, False), (False, True), (True, False), (True, True)])
def test_refer_dataset_matches_jax(synthetic_refcoco, pil_only,  # noqa: F811
                                   augmented, host_normalize):
    aug = (T.build_paired_augment(seed=3, **AUG) if augmented else None)
    jaug = (jT.build_paired_augment(seed=3, **AUG) if augmented else None)
    ds, jds = _datasets(synthetic_refcoco, aug, jaug, seed=5,
                        host_normalize=host_normalize)
    assert len(ds) == len(jds) == 2
    for _ in range(3):  # new sentence and augmentation draws each round
        for i in range(len(ds)):
            _same_example(ds[i], jds[i])


def test_augment_pads_map_to_background(synthetic_refcoco):  # noqa: F811
    """RandomCrop's 255 pad pixels become background; eval mode ignores the
    augmentation."""
    aug = T.build_paired_augment(crop=64, seed=0)  # pads the 40x50 images
    ds, _ = _datasets(synthetic_refcoco, aug, None)
    for i in range(len(ds)):
        assert set(np.unique(ds[i].target)) <= {0, 1}
    ev, _ = _datasets(synthetic_refcoco, aug, None, eval_mode=True)
    assert ev.augment is None


def test_batch_iterator_matches_jax(synthetic_refcoco, pil_only):  # noqa: F811
    ds, jds = _datasets(synthetic_refcoco, split="train")
    for kw in (dict(batch_size=1, seed=3),
               dict(batch_size=1, shard_index=1, num_shards=2),
               dict(batch_size=2, shuffle=False, drop_last=False)):
        got = list(batch_iterator(ds, **kw))
        want = list(jbatch_iterator(jds, **kw))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in g:
                assert g[k].dtype == w[k].dtype
                np.testing.assert_array_equal(g[k], w[k])


class _Items:
    """An index-deterministic dataset of ReferExample-like items."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rng = np.random.default_rng(i)
        return argparse.Namespace(
            image=rng.integers(0, 256, (4, 5, 3), dtype=np.uint8),
            target=rng.integers(0, 2, (4, 5)).astype(np.int32),
            ids=rng.integers(0, 30, 6), mask=np.ones(6, np.int64),
            video=rng.integers(0, 256, (2, 4, 5, 3), dtype=np.uint8),
            valid_index=i % 2)


def _same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k])


def _cut(batches, items, bs, drop_last):
    """One shard's batches re-cut to its first `items` items."""
    cat = {k: np.concatenate([b[k] for b in batches])[:items]
           for k in batches[0]}
    end = items - items % bs if drop_last else items
    return [{k: v[s:s + bs] for k, v in cat.items()}
            for s in range(0, end, bs)]


@pytest.mark.parametrize("collate", ["collate_refer", "collate_video"])
@pytest.mark.parametrize("drop_last", [True, False])
def test_prefetch_loader_matches_jax(collate, drop_last):
    """Epochs 0 and 1, both shards of two, at several workers: the same
    batches in the same order as the JAX loader's, each shard cut to its
    first 11 // 2 items (the JAX loader's shard 0 takes all 6 of its own,
    a batch more than its len with drop_last; the port's shards are equal
    so that data-parallel processes take the same steps: ROADMAP.md §3),
    uint8 targets, int32 ids and masks."""
    ds = _Items(11)
    for shard in (0, 1):
        kw = dict(batch_size=2, shuffle=True, drop_last=drop_last,
                  num_workers=3, seed=9, shard_index=shard, num_shards=2)
        ld = loader.PrefetchLoader(ds, collate=getattr(loader, collate), **kw)
        jld = jloader.PrefetchLoader(ds, collate=getattr(jloader, collate),
                                     **kw)
        assert len(ld) == len(jld) == (2 if drop_last else 3)
        for epoch in (0, 1):
            ld.set_epoch(epoch)
            jld.set_epoch(epoch)
            got, want = list(ld), list(jld)
            assert len(got) == len(ld)
            _same_batches(got, _cut(want, 11 // 2, 2, drop_last))
            assert got[0]["target"].dtype == np.uint8
            assert got[0]["ids"].dtype == np.int32


def test_prefetch_loader_refer_dataset_matches_jax(
        synthetic_refcoco):  # noqa: F811
    """The train CLI's loader on ReferDataset(augment) at one worker (one
    order of the datasets' random draws) for epochs 0 and 1; the port's
    device_put hook gives the same values as tensors."""
    import torch

    aug = T.build_paired_augment(seed=1, **AUG)
    jaug = jT.build_paired_augment(seed=1, **AUG)
    ds, jds = _datasets(synthetic_refcoco, aug, jaug, host_normalize=False)
    kw = dict(batch_size=1, num_workers=1, seed=2)
    ld = loader.PrefetchLoader(
        ds, collate=loader.collate_refer,
        device_put=lambda b: {k: loader.to_device(v, torch.device("cpu"))
                              for k, v in b.items()}, **kw)
    jld = jloader.PrefetchLoader(jds, collate=jloader.collate_refer, **kw)
    for epoch in (0, 1):
        ld.set_epoch(epoch)
        jld.set_epoch(epoch)
        got = [{k: v.numpy() for k, v in b.items()} for b in ld]
        _same_batches(got, list(jld))


def test_prefetch_loader_raises_a_workers_error_and_stops():
    class Broken(_Items):
        def __getitem__(self, i):
            if i == 5:
                raise OSError("unreadable item")
            return super().__getitem__(i)

    ld = loader.PrefetchLoader(Broken(8), 2, loader.collate_refer,
                               shuffle=False, num_workers=2)
    with pytest.raises(OSError, match="unreadable"):
        list(ld)
    it = iter(loader.PrefetchLoader(_Items(40), 2, loader.collate_refer,
                                    prefetch=1, num_workers=2))
    next(it)
    it.close()  # an abandoned epoch stops its producer thread
    import threading

    assert not any(t.name == "prefetch-loader" and t.is_alive()
                   for t in threading.enumerate())


def test_concat_dataset_matches_jax():
    parts = [list(range(3)), list(range(10, 15)), [], list(range(20, 22))]
    ds, jds = ConcatDataset(parts), JConcatDataset(parts)
    assert len(ds) == len(jds) == 10
    assert [ds[i] for i in range(len(ds))] == [jds[i] for i in range(len(jds))]
    assert list(ds.offsets) == list(jds.offsets)


def _logged(mod):
    """Drive a MetricLogger as the train CLI does; returns its meters, its
    str and its printed lines without the clock-dependent fields."""
    out = io.StringIO()
    log = mod.MetricLogger(out=out)
    log.add_meter("lr", mod.SmoothedValue(1, fmt="{value:.2e}"))
    values = [0.9, 0.25, 1.5, 0.75, 0.5, 2.0, 0.125]
    seen = []
    for i, x in enumerate(log.log_every(list(range(7)), 3, header="Epoch: [4]")):
        seen.append(x)
        log.update(loss=values[i], iou=values[-1 - i], lr=1e-4 / (i + 1))
    log.synchronize_between_processes()
    meters = {k: (m.median, m.avg, m.global_avg, m.max, m.value, m.count,
                  m.total, str(m)) for k, m in log.meters.items()}
    lines = [re.sub(r"  (eta|time|data|mem): [^ ]+(  )?", " ", ln)
             for ln in out.getvalue().splitlines()]
    return seen, meters, str(log), lines


def test_metric_logger_matches_jax():
    assert _logged(tlogging) == _logged(jlogging)
    for fmt in (None, "{median:.3f} {avg:.3f} {max:.3f} {value:.3f}"):
        kw = {} if fmt is None else {"fmt": fmt}
        sv, jsv = tlogging.SmoothedValue(4, **kw), jlogging.SmoothedValue(4, **kw)
        for x, n in ((3.0, 1), (1.0, 2), (4.0, 1), (1.5, 3), (9.0, 1)):
            sv.update(x, n)
            jsv.update(x, n)
            assert str(sv) == str(jsv)
            assert (sv.median, sv.avg, sv.global_avg, sv.max, sv.value) == \
                (jsv.median, jsv.avg, jsv.global_avg, jsv.max, jsv.value)
    assert tlogging.is_main_process()
    assert tlogging.device_memory_mb() is None  # no card used on the CPU


@pytest.mark.parametrize("argv", [
    [],
    ["--lr", "1e-4", "--wd", "0.05", "--epochs", "3", "-b", "4",
     "--loss", "dice_b", "--loss_boundary_rate", "0.1", "--amsgrad"],
    ["--loss", "dice_focal", "--loss_focal_rate", "2.5",
     "--loss_dice_rate", "0.5", "--fix_lr",
     "--lang_enc_params", "embeddings+encoder-all"],
    ["--loss", "ce", "--batch_size", "32", "--epochs", "40"],
])
def test_train_config_from_args_matches_jax(argv):
    args = cli_train.get_parser().parse_args(argv)
    jargs = jcli_train.get_parser().parse_args(argv)
    for n in (1, 137):
        got, want = train_config_from_args(args, n), jtrain_config(jargs, n)
        got, want = dataclasses.asdict(got), dataclasses.asdict(want)
        # JAX's config has two fields more, which no code reads: the CLI
        # sets no gradient clipping, and the batch size goes to the loader
        assert set(want) - set(got) == {"grad_clip", "batch_size"}
        assert want["grad_clip"] is None
        assert want["batch_size"] == args.batch_size
        assert got == {k: want[k] for k in got}
