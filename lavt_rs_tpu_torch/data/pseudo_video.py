"""Pseudo-video data (counterpart of `lavt_rs_tpu/data/pseudo_video.py`).

  * `ImageToSeqAugmenter` (reference data/image_to_seq_augmenter.py:18-98,
    imgaug there, cv2 here as in the JAX package): per synthetic frame a
    random perspective, rotation and translation, and a coin for a motion
    blur, applied alike to the image and its mask.  Its draws come from
    one `random.Random(seed)` in the JAX package's order (8 perspective
    offsets, angle, tx, ty, the blur coin, kernel and axis), so one seed
    gives the same `warpPerspective` / `filter2D` bits in both packages;
  * `ReferPseudoVideos` (reference data/refer_video.py:25-138): a RefCOCO
    ref as a num_frames clip of its image.  Frame 0 is the image itself;
    with an augmenter the others are jittered copies and the frame order
    is shuffled, and `valid_index` is where frame 0 landed; without one
    the clip is the image repeated.  The sentence and the shuffle are
    drawn from the dataset's own `random.Random(seed)`;
  * `ConcatDataset` (reference data/concat_dataset.py:17-33): the joint
    and the combined-pretraining datasets.

Frames resize bilinear with PIL (`transforms.resize_rgb`; the JAX package's
native resize agrees with it within 1 uint8 LSB), masks NEAREST
(`transforms.resize_mask`).
"""

from __future__ import annotations

import random
from typing import List, Optional, Sequence, Tuple

import numpy as np
from PIL import Image

from ..text.tokenizer import WordPieceTokenizer
from .a2d import VideoExample
from .refer import REFER
from .transforms import normalize, resize_mask, resize_rgb


class ImageToSeqAugmenter:
    """Single image+mask -> synthetic clip via random geometric jitter."""

    def __init__(self, perspective: bool = True, affine: bool = True,
                 motion_blur: bool = True, rotation_range: float = 3.0,
                 perspective_magnitude: float = 0.08,
                 translate_range: float = 0.02,
                 motion_blur_kernel_sizes: Sequence[int] = (3, 5),
                 motion_blur_prob: float = 0.5, seed: int = 0):
        self.perspective = perspective
        self.affine = affine
        self.motion_blur = motion_blur
        self.rotation_range = rotation_range
        self.perspective_magnitude = perspective_magnitude
        self.translate_range = translate_range
        self.mb_kernels = list(motion_blur_kernel_sizes)
        self.mb_prob = motion_blur_prob
        self.rng = random.Random(seed)

    def _transform_matrix(self, h: int, w: int) -> np.ndarray:
        import cv2

        src = np.float32([[0, 0], [w, 0], [w, h], [0, h]])
        dst = src.copy()
        if self.perspective:
            mag = self.perspective_magnitude
            jitter = np.float32(
                [[self.rng.uniform(-mag, mag) * w,
                  self.rng.uniform(-mag, mag) * h] for _ in range(4)])
            dst = src + jitter
        m = cv2.getPerspectiveTransform(src, dst)
        if self.affine:
            ang = self.rng.uniform(-self.rotation_range, self.rotation_range)
            tx = self.rng.uniform(-self.translate_range,
                                  self.translate_range) * w
            ty = self.rng.uniform(-self.translate_range,
                                  self.translate_range) * h
            rot = cv2.getRotationMatrix2D((w / 2, h / 2), ang, 1.0)
            rot = np.vstack([rot, [0, 0, 1]]).astype(np.float32)
            rot[0, 2] += tx
            rot[1, 2] += ty
            m = rot @ m
        return m

    def __call__(self, image: np.ndarray, mask: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
        import cv2

        h, w = image.shape[:2]
        m = self._transform_matrix(h, w)
        img_t = cv2.warpPerspective(image, m, (w, h),
                                    flags=cv2.INTER_LINEAR,
                                    borderMode=cv2.BORDER_REPLICATE)
        mask_t = cv2.warpPerspective(mask.astype(np.uint8), m, (w, h),
                                     flags=cv2.INTER_NEAREST)
        if self.motion_blur and self.rng.random() < self.mb_prob:
            k = self.rng.choice(self.mb_kernels)
            kernel = np.zeros((k, k), np.float32)
            if self.rng.random() < 0.5:
                kernel[k // 2, :] = 1.0 / k
            else:
                kernel[:, k // 2] = 1.0 / k
            img_t = cv2.filter2D(img_t, -1, kernel)
        return img_t, mask_t


def pseudo_clip(base: np.ndarray, mask: np.ndarray, num_frames: int,
                img_size: int, augmenter: Optional[ImageToSeqAugmenter],
                rng: random.Random, host_normalize: bool):
    """(clip, target, valid_index) of one image: frame 0 the image, frames
    1.. the augmenter's jittered copies (without one, frame 0 repeated:
    it is resized once), each resized to img_size; with an augmenter the
    frame order is shuffled by `rng`.  The target is frame 0's mask: the
    other frames' warped masks are not supervised."""
    frames = [resize_rgb(base, img_size)]
    for _ in range(1, num_frames):
        frames.append(frames[0] if augmenter is None else
                      resize_rgb(augmenter(base, mask)[0], img_size))
    order = list(range(num_frames))
    if augmenter is not None:
        rng.shuffle(order)
    video = np.stack([frames[i] for i in order])
    return (normalize(video) if host_normalize else video,
            resize_mask(mask, img_size), order.index(0))


class ReferPseudoVideos:
    """RefCOCO refs as static pseudo-clips (reference data/refer_video.py).

    With `augmenter`, frames are jittered per-frame and shuffled
    (the refexp2seq behavior, reference data/refexp2seq.py:44-49, 81-98);
    without, the clip is a plain repeat of the image.
    """

    def __init__(self, refer: REFER, tokenizer: WordPieceTokenizer,
                 split: str = "train", num_frames: int = 8,
                 img_size: int = 480, max_tokens: int = 22,
                 augmenter: Optional[ImageToSeqAugmenter] = None,
                 seed: int = 0, host_normalize: bool = True):
        self.host_normalize = host_normalize
        self.refer = refer
        self.tokenizer = tokenizer
        self.num_frames = num_frames
        self.img_size = img_size
        self.max_tokens = max_tokens
        self.augmenter = augmenter
        self.rng = random.Random(seed)
        self.ref_ids: List[int] = refer.getRefIds(split=split)

    def __len__(self):
        return len(self.ref_ids)

    def __getitem__(self, index: int) -> VideoExample:
        ref = self.refer.Refs[self.ref_ids[index]]
        with Image.open(self.refer.image_path(ref["image_id"])) as img:
            base = np.asarray(img.convert("RGB"))
        mask = self.refer.getMask(ref)["mask"]
        sent = self.rng.choice(ref["sentences"])["raw"]
        ids, attn = self.tokenizer.encode_padded(sent, self.max_tokens)
        video, target, valid_index = pseudo_clip(
            base, mask, self.num_frames, self.img_size, self.augmenter,
            self.rng, self.host_normalize)
        return VideoExample(video=video, target=target,
                            valid_index=valid_index, valid=1, ids=ids,
                            mask=attn, image_id=f"ref_{self.ref_ids[index]}")


class ConcatDataset:
    """build_joint_dataset equivalent (reference data/concat_dataset.py)."""

    def __init__(self, datasets: Sequence):
        self.datasets = list(datasets)
        self.offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def __len__(self):
        return int(self.offsets[-1])

    def __getitem__(self, idx: int):
        d = int(np.searchsorted(self.offsets, idx, side="right")) - 1
        return self.datasets[d][idx - int(self.offsets[d])]
