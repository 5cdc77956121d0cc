"""A2D-Sentences dataset (counterpart of `lavt_rs_tpu/data/a2d.py`).

Behavioral contract: reference data/a2d.py:24-272.
  * items are (text query, video id, frame index, instance id) tuples of
    the preprocessed json annotation file;
  * train: sparse frame sampling around the (1-indexed) annotated frame;
    eval: the consecutive, edge-padded clip_length window, or with
    not_consecutive a sparse clip of clip_length frames;
  * the annotated frame's instance mask comes from
    Release/a2d_annotation_with_instances/<vid>/<frame:05d>.h5 ('reMask',
    stored transposed); `valid_index` is its position in the clip;
  * the text is tokenized to max_tokens;
  * an item whose mask is empty is resampled (reference a2d.py:227-231).

The mp4 clips decode with cv2 and the masks read with h5py, both imported
where they are used; the frames resize with PIL (`transforms.resize_rgb`).
The clip stays uint8 with host_normalize=False (normalized on the device,
as `eval.video_eval.clip_iou` takes it).
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
from typing import List, Optional

import numpy as np

from ..text.tokenizer import WordPieceTokenizer
from .transforms import normalize, resize_mask, resize_rgb
from .video_sampling import consecutive_window, sparse_sample


def read_video_frames(path: str, indices: Optional[List[int]] = None
                      ) -> List[np.ndarray]:
    """Decode RGB frames with cv2, in order; indices=None: all frames."""
    import cv2

    cap = cv2.VideoCapture(path)
    frames = []
    i = 0
    wanted = set(indices) if indices is not None else None
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        if wanted is None or i in wanted:
            frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
        i += 1
    cap.release()
    return frames


def video_length(path: str) -> int:
    """The frame count in the mp4's header."""
    import cv2

    cap = cv2.VideoCapture(path)
    n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    cap.release()
    return n


@dataclasses.dataclass
class VideoExample:
    video: np.ndarray  # (T, H, W, 3) uint8, or float32 normalized
    target: np.ndarray  # (H, W) int32: the annotated frame's mask
    valid_index: int  # position of the annotated frame in the clip
    valid: int  # 1 if the instance appears in the annotated frame
    ids: np.ndarray
    mask: np.ndarray
    image_id: str = ""


class A2DSentencesDataset:
    def __init__(self, root: str, ann_file: str,
                 tokenizer: WordPieceTokenizer, subset: str = "train",
                 num_frames: int = 8, clip_length: int = 16,
                 img_size: int = 480, max_tokens: int = 22, seed: int = 0,
                 host_normalize: bool = True, not_consecutive: bool = False):
        self.host_normalize = host_normalize
        self.not_consecutive = not_consecutive
        self.videos_dir = os.path.join(root, "Release", "clips320H")
        self.masks_dir = os.path.join(
            root, "Release", "a2d_annotation_with_instances")
        with open(ann_file) as f:
            self.items = [tuple(a) for a in json.load(f)]
        self.tokenizer = tokenizer
        self.subset = subset
        self.num_frames = num_frames
        self.clip_length = clip_length
        self.img_size = img_size
        self.max_tokens = max_tokens
        self.rng = random.Random(seed)

    def __len__(self):
        return len(self.items)

    def _load_mask(self, video_id: str, frame_idx: int, instance_id):
        import h5py

        path = os.path.join(self.masks_dir, video_id, f"{frame_idx:05d}.h5")
        with h5py.File(path, "r") as f:
            instances = [int(i) for i in np.asarray(f["instance"]).ravel()]
            pos = instances.index(int(instance_id))
            masks = np.asarray(f["reMask"])
        if len(instances) == 1:
            masks = masks[None]
        return masks[pos].T  # stored transposed (reference a2d.py:187)

    def __getitem__(self, idx: int) -> VideoExample:
        for _attempt in range(50):
            text, video_id, frame_idx, instance_id = self.items[idx]
            text = " ".join(str(text).lower().split())
            frame_id = int(frame_idx) - 1  # 1-indexed source

            vpath = os.path.join(self.videos_dir, f"{video_id}.mp4")
            vid_len = video_length(vpath)
            if self.subset == "train":
                indices, valid_index = sparse_sample(
                    frame_id, vid_len, self.num_frames, self.rng)
            elif self.not_consecutive:
                indices, valid_index = sparse_sample(
                    frame_id, vid_len, self.clip_length, self.rng)
            else:
                indices, valid_index = consecutive_window(
                    frame_id, vid_len, self.clip_length)

            wanted = sorted(set(indices))
            by_idx = dict(zip(wanted, read_video_frames(vpath, wanted)))
            clip = []
            for i in indices:
                arr = resize_rgb(by_idx[i], self.img_size)
                clip.append(normalize(arr) if self.host_normalize else arr)

            raw_mask = self._load_mask(video_id, int(frame_idx), instance_id)
            valid = int((raw_mask > 0).any())
            target = resize_mask(raw_mask > 0, self.img_size)
            ids, attn = self.tokenizer.encode_padded(text, self.max_tokens)
            if valid:
                return VideoExample(
                    video=np.stack(clip), target=target,
                    valid_index=valid_index, valid=valid, ids=ids, mask=attn,
                    image_id=f"v_{video_id}_f_{frame_idx}_i_{instance_id}")
            idx = self.rng.randint(0, len(self) - 1)
        raise RuntimeError(
            "A2DSentencesDataset: 50 consecutive resamples found no item "
            "with a non-empty instance mask")
