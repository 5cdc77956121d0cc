"""The eval pipeline's image and mask transforms (counterpart of the part of
`lavt_rs_tpu/data/transforms.py` that RefCOCO evaluation uses).

The reference's default pipeline is Resize(480, bilinear image / NEAREST
mask) -> ToTensor -> Normalize(ImageNet mean/std).  Images decode with
PIL, the JAX package's own fallback path; its native JPEG loader agrees
with PIL within 1 uint8 LSB and is not ported (ROADMAP.md), nor are the
paired random augmentations, which only training uses.
"""

from __future__ import annotations

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


def resize_mask(mask: np.ndarray, size: int) -> np.ndarray:
    """(h, w) {0, 1} mask -> (size, size) int32, NEAREST, as the reference
    resizes the target."""
    img = Image.fromarray(mask.astype(np.uint8))
    return np.asarray(img.resize((size, size), Image.NEAREST)).astype(np.int32)
