"""RefCOCO / RefCOCO+ / G-Ref annotation reader (the port's own copy of
`lavt_rs_tpu/data/refer.py`).

Replaces the external `refer` API clone the reference requires
(README.md:14-15; `from refer.refer import REFER` at
data/dataset_refer_bert.py:15).  Same data layout on disk:

  <data_root>/<dataset>/refs(<splitBy>).p   — pickled list of ref dicts
  <data_root>/<dataset>/instances.json      — COCO-format annotations
  <data_root>/images/mscoco/images/train2014/ — images (refcoco*)

and the same core surface: getRefIds / getImgIds / loadRefs / getMask /
Refs / Imgs / IMAGE_DIR.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Dict, List, Optional, Sequence

import numpy as np

from .coco_mask import annotation_to_mask


class REFER:
    def __init__(self, data_root: str, dataset: str = "refcoco",
                 splitBy: str = "unc"):
        self.data_root = data_root
        self.dataset = dataset
        ref_file = os.path.join(data_root, dataset, f"refs({splitBy}).p")
        inst_file = os.path.join(data_root, dataset, "instances.json")
        with open(ref_file, "rb") as f:
            self.refs: List[Dict] = pickle.load(f)
        with open(inst_file) as f:
            instances = json.load(f)

        if dataset in ("refcoco", "refcoco+", "refcocog"):
            self.IMAGE_DIR = os.path.join(
                data_root, "images", "mscoco", "images", "train2014")
        elif dataset == "refclef":
            self.IMAGE_DIR = os.path.join(
                data_root, "images", "saiapr_tc-12")
        else:
            self.IMAGE_DIR = os.path.join(data_root, "images")

        self.Refs = {r["ref_id"]: r for r in self.refs}
        self.Imgs = {img["id"]: img for img in instances["images"]}
        self.Anns = {a["id"]: a for a in instances["annotations"]}
        self.Cats = {c["id"]: c["name"]
                     for c in instances.get("categories", [])}

        self.imgToRefs: Dict[int, List[Dict]] = {}
        for r in self.refs:
            self.imgToRefs.setdefault(r["image_id"], []).append(r)

    # -- query API ----------------------------------------------------------

    def getRefIds(self, image_ids=None, cat_ids=None,
                  split: str = "") -> List[int]:
        refs = self.refs
        if image_ids:
            wanted = set(np.atleast_1d(image_ids).tolist())
            refs = [r for r in refs if r["image_id"] in wanted]
        if cat_ids:
            wanted = set(np.atleast_1d(cat_ids).tolist())
            refs = [r for r in refs if r["category_id"] in wanted]
        if split:
            if split in ("testA", "testB", "testC"):
                # rank-constrained test splits (refcoco/+ convention)
                refs = [r for r in refs if split[-1] in r["split"]]
            elif split in ("testAB", "testBC", "testAC"):
                refs = [r for r in refs if r["split"] == split]
            elif split == "test":
                refs = [r for r in refs if "test" in r["split"]]
            elif split in ("train", "val"):
                refs = [r for r in refs if r["split"] == split]
            else:
                raise ValueError(f"unknown split {split!r}")
        return [r["ref_id"] for r in refs]

    def getImgIds(self, ref_ids=None) -> List[int]:
        if ref_ids is None:
            return list(self.Imgs.keys())
        ref_ids = np.atleast_1d(ref_ids).tolist()
        return list(dict.fromkeys(self.Refs[r]["image_id"] for r in ref_ids))

    def loadRefs(self, ref_ids) -> List[Dict]:
        return [self.Refs[r] for r in np.atleast_1d(ref_ids).tolist()]

    def getMask(self, ref: Dict) -> Dict:
        """Binary mask for the referred instance, like refer's getMask."""
        ann = self.Anns[ref["ann_id"]]
        img = self.Imgs[ref["image_id"]]
        mask = annotation_to_mask(ann["segmentation"], img["height"],
                                  img["width"])
        return {"mask": mask, "area": int(mask.sum())}

    def image_path(self, image_id: int) -> str:
        return os.path.join(self.IMAGE_DIR, self.Imgs[image_id]["file_name"])
