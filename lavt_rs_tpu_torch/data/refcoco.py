"""RefCOCO-family dataset (counterpart of `lavt_rs_tpu/data/refcoco.py`:
`ReferExample`, `ReferDataset`).

Behavioral contract (reference data/dataset_refer_bert.py:24-124):
  * all sentences tokenized up front (pad/truncate to max_tokens);
  * train mode samples ONE random sentence per item;
  * eval mode exposes ALL sentences of the ref (the eval loop iterates
    them, reference test.py:73-94);
  * mask from REFER.getMask, resized NEAREST to the model size;
  * image resized bilinear (PIL) and, with host_normalize,
    ImageNet-normalized; without, uint8 for the device to normalize;
  * an optional paired augmentation (`transforms.build_paired_augment`)
    at full resolution before that resize, in train mode only.

`batch_iterator` is the JAX package's host-side batcher.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List

import numpy as np
from PIL import Image

from ..text.tokenizer import WordPieceTokenizer
from .refer import REFER
from .transforms import load_image_resized, normalize, resize_mask


@dataclasses.dataclass
class ReferExample:
    image: np.ndarray  # (H, W, 3) float32, or uint8 without host_normalize
    target: np.ndarray  # (H, W) int32
    ids: np.ndarray  # (N_l,) or (S, N_l) in eval mode
    mask: np.ndarray  # same leading shape as ids
    ref_id: int = -1


class ReferDataset:
    def __init__(self, refer: REFER, tokenizer: WordPieceTokenizer,
                 split: str = "train", img_size: int = 480,
                 max_tokens: int = 20, eval_mode: bool = False,
                 seed: int = 0, host_normalize: bool = True,
                 augment=None):
        self.refer = refer
        self.tokenizer = tokenizer
        self.split = split
        self.img_size = img_size
        self.max_tokens = max_tokens
        self.eval_mode = eval_mode
        self.host_normalize = host_normalize
        # (img_pil, mask_pil) -> (img_pil, mask_pil), applied at full
        # resolution before the model-size resize; never in eval mode
        self.augment = augment if not eval_mode else None
        self.rng = np.random.default_rng(seed)

        self.ref_ids: List[int] = refer.getRefIds(split=split)
        # every sentence tokenized once, as the reference does at init
        self.input_ids: List[np.ndarray] = []
        self.attn_masks: List[np.ndarray] = []
        for r in self.ref_ids:
            pairs = [tokenizer.encode_padded(sent["raw"], max_tokens)
                     for sent in refer.Refs[r]["sentences"]]
            self.input_ids.append(np.stack([p[0] for p in pairs]))  # (S, N_l)
            self.attn_masks.append(np.stack([p[1] for p in pairs]))

    def __len__(self) -> int:
        return len(self.ref_ids)

    def __getitem__(self, index: int) -> ReferExample:
        ref_id = self.ref_ids[index]
        ref = self.refer.Refs[ref_id]
        path = self.refer.image_path(ref["image_id"])
        if self.augment is not None:
            image, target = self._augmented(path, ref)
        else:
            image = load_image_resized(path, self.img_size,
                                       host_normalize=self.host_normalize)
            target = resize_mask(self.refer.getMask(ref)["mask"],
                                 self.img_size)
        if self.eval_mode:
            ids = self.input_ids[index]  # all sentences (S, N_l)
            attn = self.attn_masks[index]
        else:
            s = int(self.rng.integers(len(self.input_ids[index])))
            ids = self.input_ids[index][s]
            attn = self.attn_masks[index][s]
        return ReferExample(image=image, target=target, ids=ids, mask=attn,
                            ref_id=ref_id)

    def _augmented(self, path: str, ref: dict):
        """The full-resolution PIL pair through `augment`, then the
        model-size resize.  RandomCrop pads masks with 255 (ignore); the
        two-class losses have no ignore class, so pad pixels become
        background, as in the JAX package (the reference never trains
        this path: its default pipeline has no random augmentations)."""
        mask = Image.fromarray(self.refer.getMask(ref)["mask"].astype(np.uint8))
        with Image.open(path) as img:
            img, mask = self.augment(img.convert("RGB"), mask)
        size = (self.img_size, self.img_size)
        image = np.asarray(img.resize(size, Image.BILINEAR))
        if self.host_normalize:
            image = normalize(image)
        target = np.asarray(mask.resize(size, Image.NEAREST))
        return image, np.where(target == 255, 0, target).astype(np.int32)


def batch_iterator(ds: ReferDataset, batch_size: int, shuffle: bool = True,
                   seed: int = 0, drop_last: bool = True,
                   shard_index: int = 0, num_shards: int = 1
                   ) -> Iterator[Dict[str, np.ndarray]]:
    """Host-side batcher with deterministic shuffling and optional sharding
    (the DistributedSampler equivalent, reference train.py:554); the
    threaded `loader.PrefetchLoader` is what the train CLI runs."""
    order = np.arange(len(ds))
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    order = order[shard_index::num_shards]
    n = len(order)
    end = n - n % batch_size if drop_last else n
    for start in range(0, end, batch_size):
        items = [ds[int(i)] for i in order[start:start + batch_size]]
        yield {
            "image": np.stack([it.image for it in items]),
            "target": np.stack([it.target for it in items]),
            "ids": np.stack([it.ids for it in items]).astype(np.int32),
            "mask": np.stack([it.mask for it in items]).astype(np.int32),
            "ref_id": np.asarray([it.ref_id for it in items]),
        }
