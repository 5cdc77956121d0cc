"""COCO-format refexp pseudo-videos (counterpart of
`lavt_rs_tpu/data/refexp2seq.py`; the reference's ModulatedDetection,
data/refexp2seq.py:28-298).

The input is the COCO-format refexp json
(`{root}/{dataset}/instances_{dataset}_{split}.json`, images under
`{root}/images/mscoco/images/train2014`): ONE image entry per referring
sentence, the sentence stored as the entry's `caption`, one annotated
instance per entry.  Crowd annotations are dropped, and so are entries
left without annotations.  Each item becomes a num_frames pseudo-clip as
`pseudo_video.ReferPseudoVideos` builds one with an augmenter: the image,
jittered copies (`ImageToSeqAugmenter`), the order shuffled (reference
refexp2seq.py:44-49, 81-98).  This path always augments.

Kept from the JAX package: the supervised frame is the unaugmented one
(`valid_index`), whereas the reference marks every augmented frame valid
(ROADMAP.md, known differences).  Polygons and RLE are rasterized with
`coco_mask.annotation_to_mask` (no pycocotools).
"""

from __future__ import annotations

import json
import os
import random
from typing import List, Optional

import numpy as np
from PIL import Image

from ..text.tokenizer import WordPieceTokenizer
from .a2d import VideoExample
from .coco_mask import annotation_to_mask
from .pseudo_video import ImageToSeqAugmenter, pseudo_clip


class RefExpPseudoVideos:
    """COCO-format refexp json -> augmented pseudo-clips."""

    def __init__(self, img_folder: str, ann_file: str,
                 tokenizer: WordPieceTokenizer, num_frames: int = 8,
                 img_size: int = 480, max_tokens: int = 22,
                 augmenter: Optional[ImageToSeqAugmenter] = None,
                 seed: int = 0, host_normalize: bool = True):
        self.host_normalize = host_normalize
        self.img_folder = img_folder
        self.tokenizer = tokenizer
        self.num_frames = num_frames
        self.img_size = img_size
        self.max_tokens = max_tokens
        # the reference always augments on this path (refexp2seq.py:33-38)
        self.augmenter = augmenter if augmenter is not None else \
            ImageToSeqAugmenter(seed=seed)
        self.rng = random.Random(seed)

        with open(ann_file) as f:
            coco = json.load(f)
        self.images = {im["id"]: im for im in coco["images"]}
        self.anns_by_image = {}
        for ann in coco["annotations"]:
            if not ann.get("iscrowd", 0):
                self.anns_by_image.setdefault(ann["image_id"], []).append(ann)
        self.ids: List[int] = [i for i in sorted(self.images)
                               if self.anns_by_image.get(i)]

    def __len__(self) -> int:
        return len(self.ids)

    def __getitem__(self, index: int) -> VideoExample:
        entry = self.images[self.ids[index]]
        with Image.open(os.path.join(self.img_folder,
                                     entry["file_name"])) as img:
            base = np.asarray(img.convert("RGB"))
        h, w = entry["height"], entry["width"]
        # one instance per entry (the reference asserts it,
        # refexp2seq.py:85); extras are united
        mask = np.zeros((h, w), np.uint8)
        for ann in self.anns_by_image[self.ids[index]]:
            mask |= annotation_to_mask(ann["segmentation"], h, w
                                       ).astype(np.uint8)
        ids, attn = self.tokenizer.encode_padded(entry["caption"],
                                                 self.max_tokens)
        video, target, valid_index = pseudo_clip(
            base, mask, self.num_frames, self.img_size, self.augmenter,
            self.rng, self.host_normalize)
        return VideoExample(video=video, target=target,
                            valid_index=valid_index, valid=1, ids=ids,
                            mask=attn, image_id=f"refexp_{self.ids[index]}")


def build_refexp_dataset(dataset: str, split: str, refer_data_root: str,
                         tokenizer: WordPieceTokenizer, **kw
                         ) -> RefExpPseudoVideos:
    """The reference build()'s path layout (refexp2seq.py:278-298)."""
    img_folder = os.path.join(refer_data_root, "images", "mscoco", "images",
                              "train2014")
    ann_file = os.path.join(refer_data_root, dataset,
                            f"instances_{dataset}_{split}.json")
    return RefExpPseudoVideos(img_folder, ann_file, tokenizer, **kw)
