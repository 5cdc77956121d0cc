"""RefCOCO-family dataset (counterpart of `lavt_rs_tpu/data/refcoco.py`:
`ReferExample`, `ReferDataset`).

Behavioral contract (reference data/dataset_refer_bert.py:24-124):
  * all sentences tokenized up front (pad/truncate to max_tokens);
  * train mode samples ONE random sentence per item;
  * eval mode exposes ALL sentences of the ref (the eval loop iterates
    them, reference test.py:73-94);
  * mask from REFER.getMask, resized NEAREST to the model size;
  * image resized bilinear (PIL) and, with host_normalize,
    ImageNet-normalized; without, uint8 for the device to normalize.

The paired random augmentations and `batch_iterator` come with the train
CLI (ROADMAP.md slice 3).
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from ..text.tokenizer import WordPieceTokenizer
from .refer import REFER
from .transforms import load_image_resized, resize_mask


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
                 seed: int = 0, host_normalize: bool = True):
        self.refer = refer
        self.tokenizer = tokenizer
        self.split = split
        self.img_size = img_size
        self.max_tokens = max_tokens
        self.eval_mode = eval_mode
        self.host_normalize = host_normalize
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
        image = load_image_resized(self.refer.image_path(ref["image_id"]),
                                   self.img_size,
                                   host_normalize=self.host_normalize)
        target = resize_mask(self.refer.getMask(ref)["mask"], self.img_size)
        if self.eval_mode:
            ids = self.input_ids[index]  # all sentences (S, N_l)
            attn = self.attn_masks[index]
        else:
            s = int(self.rng.integers(len(self.input_ids[index])))
            ids = self.input_ids[index][s]
            attn = self.attn_masks[index][s]
        return ReferExample(image=image, target=target, ids=ids, mask=attn,
                            ref_id=ref_id)
