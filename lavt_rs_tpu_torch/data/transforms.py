"""Paired image/mask transforms (counterpart of the RefCOCO part of
`lavt_rs_tpu/data/transforms.py`).

The reference's default pipeline is Resize(480, bilinear image / NEAREST
mask) -> ToTensor -> Normalize(ImageNet mean/std).  Images decode with
PIL, the JAX package's own fallback path; its native JPEG loader agrees
with PIL within 1 uint8 LSB and is not ported (ROADMAP.md).

The random paired augmentations (reference transforms.py:33-103,
`build_paired_augment`) are PIL and numpy only and make the JAX package's
calls in its order, so the same seed and the same PIL pair give the same
bits.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
from PIL import Image

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def normalize(img: np.ndarray) -> np.ndarray:
    """uint8 HWC -> float32 HWC normalized by ImageNet stats."""
    x = img.astype(np.float32) / 255.0
    return (x - IMAGENET_MEAN) / IMAGENET_STD


def load_image_resized(path: str, size: int,
                       host_normalize: bool = True) -> np.ndarray:
    """Decode an on-disk image with PIL and resize it bilinear to
    (size, size): uint8 HWC, or float32 normalized with host_normalize
    (False leaves the normalization to the device, `ops.norm`)."""
    with Image.open(path) as img:
        arr = np.asarray(img.convert("RGB").resize((size, size),
                                                   Image.BILINEAR))
    return normalize(arr) if host_normalize else arr


def resize_rgb(arr: np.ndarray, size: int) -> np.ndarray:
    """An in-memory uint8 HWC RGB frame (the video datasets decode with
    cv2) resized bilinear to (size, size) with PIL; the JAX package's native
    resize agrees with it within 1 uint8 LSB."""
    return np.asarray(Image.fromarray(arr).convert("RGB").resize(
        (size, size), Image.BILINEAR))


def resize_mask(mask: np.ndarray, size: int) -> np.ndarray:
    """(h, w) {0, 1} mask -> (size, size) int32, NEAREST, as the reference
    resizes the target."""
    img = Image.fromarray(mask.astype(np.uint8))
    return np.asarray(img.resize((size, size), Image.NEAREST)).astype(np.int32)


def random_hflip_pair(img: Image.Image, mask: Image.Image, rng) -> tuple:
    if rng.random() < 0.5:
        img = img.transpose(Image.FLIP_LEFT_RIGHT)
        mask = mask.transpose(Image.FLIP_LEFT_RIGHT)
    return img, mask


# ---------------------------------------------------------------------------
# Random paired augmentations (reference transforms.py:33-103). These are
# NOT on the reference's default path (train.py:54-60 composes only
# Resize/ToTensor/Normalize) but are part of its declared surface. The
# reference delegates to torchvision's PIL backend; these make the same PIL
# calls directly, so pixels match the v0.8-era torchvision semantics.
# ---------------------------------------------------------------------------

def _smaller_edge_size(w: int, h: int, size: int) -> Tuple[int, int]:
    """torchvision F.resize(int): smaller edge -> size, aspect preserved."""
    if (w <= h and w == size) or (h <= w and h == size):
        return w, h
    if w < h:
        return size, int(size * h / w)
    return int(size * w / h), size


def random_resize_pair(img: Image.Image, mask: Image.Image,
                       min_size: int, max_size: Optional[int], rng):
    """reference RandomResize (transforms.py:33-46): size ~ U{min..max},
    smaller-edge resize, bilinear image / NEAREST mask."""
    if max_size is None:
        max_size = min_size
    size = int(rng.integers(min_size, max_size + 1))
    w, h = _smaller_edge_size(*img.size, size)
    return (img.resize((w, h), Image.BILINEAR),
            mask.resize((w, h), Image.NEAREST))


def pad_if_smaller(img: Image.Image, size: int, fill=0) -> Image.Image:
    """Right/bottom pad up to `size` (the torchvision segmentation-reference
    helper the reference's RandomCrop calls at transforms.py:65-66 but
    never defines; masks pad with fill=255 = ignore)."""
    ow, oh = img.size
    padw = max(size - ow, 0)
    padh = max(size - oh, 0)
    if padw == 0 and padh == 0:
        return img
    out = Image.new(img.mode, (ow + padw, oh + padh),
                    fill if img.mode != "RGB" else tuple([fill] * 3))
    out.paste(img, (0, 0))
    return out


def random_crop_pair(img: Image.Image, mask: Image.Image, size: int, rng):
    """reference RandomCrop (transforms.py:60-70): pad_if_smaller (mask
    fill 255) then one uniform (i, j) crop applied to both."""
    img = pad_if_smaller(img, size)
    mask = pad_if_smaller(mask, size, fill=255)
    w, h = img.size
    i = int(rng.integers(0, h - size + 1))
    j = int(rng.integers(0, w - size + 1))
    box = (j, i, j + size, i + size)
    return img.crop(box), mask.crop(box)


def center_crop_pair(img: Image.Image, mask: Image.Image, size: int):
    """reference CenterCrop (transforms.py:73-80)."""
    img = pad_if_smaller(img, size)
    mask = pad_if_smaller(mask, size, fill=255)
    w, h = img.size
    i = (h - size) // 2
    j = (w - size) // 2
    box = (j, i, j + size, i + size)
    return img.crop(box), mask.crop(box)


def _inverse_affine_matrix(center, angle, translate, scale, shear):
    """torchvision _get_inverse_affine_matrix: PIL's transform wants the
    output->input map for M = T(translate) C R(angle)S(shear)Scale C^-1."""
    rot = math.radians(angle)
    sx, sy = (math.radians(s) for s in shear)
    cx, cy = center
    tx, ty = translate
    a = math.cos(rot - sy) / math.cos(sy)
    b = -math.cos(rot - sy) * math.tan(sx) / math.cos(sy) - math.sin(rot)
    c = math.sin(rot - sy) / math.cos(sy)
    d = -math.sin(rot - sy) * math.tan(sx) / math.cos(sy) + math.cos(rot)
    m = [d / scale, -b / scale, 0.0, -c / scale, a / scale, 0.0]
    m[2] += m[0] * (-cx - tx) + m[1] * (-cy - ty)
    m[5] += m[3] * (-cx - tx) + m[4] * (-cy - ty)
    m[2] += cx
    m[5] += cy
    return m


def affine_pair(img: Image.Image, mask: Image.Image, angle: float,
                translate=(0, 0), scale: float = 1.0, shear=(0.0, 0.0)):
    """torchvision F.affine on both (PIL backend, resample=0 = NEAREST,
    the reference RandomAffine default transforms.py:91)."""
    center = (img.size[0] * 0.5 + 0.5, img.size[1] * 0.5 + 0.5)
    m = _inverse_affine_matrix(center, angle, translate, scale, shear)
    kw = dict(resample=Image.NEAREST)
    return (img.transform(img.size, Image.AFFINE, m, **kw),
            mask.transform(mask.size, Image.AFFINE, m, **kw))


def random_affine_pair(img: Image.Image, mask: Image.Image, rng,
                       degrees=(0.0, 0.0), translate=None, scale=None,
                       shear=None):
    """reference RandomAffine (transforms.py:90-103): ONE parameter draw
    (T.RandomAffine.get_params) applied to both image and mask."""
    angle = float(rng.uniform(degrees[0], degrees[1]))
    if translate is not None:
        w, h = img.size
        max_dx, max_dy = translate[0] * w, translate[1] * h
        tr = (int(round(rng.uniform(-max_dx, max_dx))),
              int(round(rng.uniform(-max_dy, max_dy))))
    else:
        tr = (0, 0)
    sc = float(rng.uniform(scale[0], scale[1])) if scale is not None else 1.0
    if shear is not None:
        if len(shear) == 2:
            sh = (float(rng.uniform(shear[0], shear[1])), 0.0)
        else:
            sh = (float(rng.uniform(shear[0], shear[1])),
                  float(rng.uniform(shear[2], shear[3])))
    else:
        sh = (0.0, 0.0)
    return affine_pair(img, mask, angle, tr, sc, sh)


def build_paired_augment(resize_range=None, hflip: float = 0.0,
                         crop: Optional[int] = None, affine=None,
                         seed: int = 0):
    """Compose the reference's random paired augs into ONE callable
    (img_pil, mask_pil) -> (img_pil, mask_pil), or None if nothing is
    enabled. Off by default, like the reference (train.py:54-60 composes
    only Resize/ToTensor/Normalize); the --aug_* CLI flags turn pieces on.

    affine: dict(degrees=(lo, hi), translate=(fx, fy)|None,
                 scale=(lo, hi)|None, shear=(...)|None).
    One numpy generator from `seed` feeds every draw, in the order resize,
    flip, crop, affine.
    """
    if resize_range is None and not hflip and crop is None and affine is None:
        return None
    rng = np.random.default_rng(seed)

    def aug(img: Image.Image, mask: Image.Image):
        if resize_range is not None:
            img, mask = random_resize_pair(img, mask, resize_range[0],
                                           resize_range[1], rng)
        if hflip and rng.random() < hflip:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
            mask = mask.transpose(Image.FLIP_LEFT_RIGHT)
        if crop is not None:
            img, mask = random_crop_pair(img, mask, crop, rng)
        if affine is not None:
            img, mask = random_affine_pair(img, mask, rng, **affine)
        return img, mask

    return aug
