"""Native COCO segmentation decoding (no pycocotools dependency).

The port's own copy of `lavt_rs_tpu/data/coco_mask.py`.

The reference reads RefCOCO masks through refer/pycocotools
(`REFER.getMask`, imported at data/dataset_refer_bert.py:15).  This module
implements the three COCO segmentation encodings from scratch:
  * polygons: list of [x0, y0, x1, y1, ...] — rasterized with cv2
  * uncompressed RLE: {'counts': [int, ...], 'size': [h, w]}
  * compressed RLE: {'counts': bytes/str, 'size': [h, w]} (LEB128-ish
    varint delta coding used by the COCO API)

COCO RLE is column-major (Fortran order), starting with a run of zeros.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Union

import numpy as np


def decode_compressed_rle_counts(s: Union[str, bytes]) -> List[int]:
    """Decode the COCO compressed RLE 'counts' string into run lengths.

    Format: 6-bit chunks packed into chars offset by 48, sign-extended
    varints, with runs (index >= 2) delta-coded against counts[i-2].
    """
    if isinstance(s, str):
        s = s.encode("ascii")
    counts: List[int] = []
    i = 0
    while i < len(s):
        x = 0
        k = 0
        more = True
        while more:
            c = s[i] - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def rle_to_mask(rle: Dict) -> np.ndarray:
    """{'counts': ..., 'size': [h, w]} -> (h, w) uint8 mask."""
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, (str, bytes)):
        counts = decode_compressed_rle_counts(counts)
    flat = np.zeros(h * w, dtype=np.uint8)
    pos = 0
    val = 0
    for run in counts:
        if val:
            flat[pos:pos + run] = 1
        pos += run
        val ^= 1
    return flat.reshape((w, h)).T  # column-major


def mask_to_rle(mask: np.ndarray) -> Dict:
    """(h, w) {0,1} mask -> uncompressed column-major RLE."""
    h, w = mask.shape
    flat = np.asfortranarray(mask.astype(np.uint8)).reshape(-1, order="F")
    # run-length encode starting with zeros
    change = np.flatnonzero(np.diff(flat)) + 1
    idx = np.concatenate(([0], change, [flat.size]))
    runs = np.diff(idx).tolist()
    if flat[0] == 1:
        runs = [0] + runs
    return {"counts": runs, "size": [h, w]}


def polygons_to_mask(polys: Sequence[Sequence[float]], h: int,
                     w: int) -> np.ndarray:
    """Union of filled polygons -> (h, w) uint8 mask."""
    import cv2

    mask = np.zeros((h, w), dtype=np.uint8)
    for poly in polys:
        pts = np.asarray(poly, dtype=np.float64).reshape(-1, 2)
        pts = np.round(pts).astype(np.int32)
        cv2.fillPoly(mask, [pts], 1)
    return mask


def annotation_to_mask(segmentation, h: int, w: int) -> np.ndarray:
    """COCO 'segmentation' field of any encoding -> (h, w) uint8 mask."""
    if isinstance(segmentation, list):
        return polygons_to_mask(segmentation, h, w)
    if isinstance(segmentation, dict):
        return rle_to_mask(segmentation)
    raise TypeError(f"unknown segmentation type: {type(segmentation)}")


def iou(mask_a: np.ndarray, mask_b: np.ndarray) -> float:
    inter = np.logical_and(mask_a, mask_b).sum()
    union = np.logical_or(mask_a, mask_b).sum()
    return float(inter) / float(union) if union else 0.0
