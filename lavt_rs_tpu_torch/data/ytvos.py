"""Ref-YouTube-VOS dataset (counterpart of `lavt_rs_tpu/data/ytvos.py`).

Behavioral contract: reference data/ytvos.py:24-327.
  * metas: one per (video, expression, frame_id every num_frames) from
    meta_expressions.json's {videos: {vid: {expressions, frames}}};
  * per item: sparse local + global frame sampling around the meta's frame;
  * masks: Annotations/<vid>/<frame>.png palette PNGs, mask = (png ==
    obj_id), resized NEAREST;
  * a random other item is drawn until the clip's annotated frame holds
    the instance (reference ytvos.py:244-247);
  * expressions are tokenized once, at init.

PIL only: frames decode and resize with `transforms.load_image_resized`.
"""

from __future__ import annotations

import json
import os
import random
from typing import List

import numpy as np
from PIL import Image

from ..text.tokenizer import WordPieceTokenizer
from .a2d import VideoExample
from .transforms import load_image_resized, resize_mask
from .video_sampling import sparse_sample


class YTVOSDataset:
    def __init__(self, img_folder: str, ann_file: str,
                 tokenizer: WordPieceTokenizer, num_frames: int = 8,
                 img_size: int = 480, max_tokens: int = 22, seed: int = 0,
                 host_normalize: bool = True):
        self.host_normalize = host_normalize
        self.img_folder = img_folder
        self.num_frames = num_frames
        self.img_size = img_size
        self.max_tokens = max_tokens
        self.tokenizer = tokenizer
        self.rng = random.Random(seed)

        with open(ann_file) as f:
            by_video = json.load(f)["videos"]
        self.videos = list(by_video.keys())
        self.metas: List[dict] = []
        for vid in self.videos:
            vd = by_video[vid]
            frames = sorted(vd["frames"])
            for exp_id, exp in vd["expressions"].items():
                ids, attn = tokenizer.encode_padded(exp["exp"], max_tokens)
                for frame_id in range(0, len(frames), num_frames):
                    self.metas.append(dict(
                        video=vid, ids=ids, mask=attn,
                        obj_id=int(exp["obj_id"]), frames=frames,
                        frame_id=frame_id, exp_id=exp_id))

    def __len__(self):
        return len(self.metas)

    def _frame_path(self, vid, frame):
        return os.path.join(self.img_folder, "JPEGImages", vid,
                            f"{frame}.jpg")

    def _mask_path(self, vid, frame):
        return os.path.join(self.img_folder, "Annotations", vid,
                            f"{frame}.png")

    def __getitem__(self, idx: int) -> VideoExample:
        for _attempt in range(50):
            meta = self.metas[idx]
            frames, frame_id = meta["frames"], meta["frame_id"]
            indices, valid_index = sparse_sample(
                frame_id, len(frames), self.num_frames, self.rng)

            clip, masks = [], []
            for i in indices:
                clip.append(load_image_resized(
                    self._frame_path(meta["video"], frames[i]),
                    self.img_size, host_normalize=self.host_normalize))
                with Image.open(self._mask_path(meta["video"],
                                                frames[i])) as png:
                    m = np.asarray(png.convert("P")) == meta["obj_id"]
                masks.append(resize_mask(m, self.img_size))

            target = masks[valid_index]
            if target.any():
                return VideoExample(
                    video=np.stack(clip), target=target,
                    valid_index=valid_index, valid=1,
                    ids=meta["ids"], mask=meta["mask"],
                    image_id=f"{meta['video']}_{meta['exp_id']}")
            idx = self.rng.randint(0, len(self) - 1)
        raise RuntimeError(
            "YTVOSDataset: 50 consecutive resamples found no clip containing "
            "the referred instance; check the Annotations PNGs and obj_ids")
