"""Pseudo-video data (counterpart of `lavt_rs_tpu/data/pseudo_video.py`).

Only `ConcatDataset` is ported so far: the train CLI's
--ref_image_combined_pretrain concatenates the three RefCOCO-family
datasets with it.  `ImageToSeqAugmenter` and `ReferPseudoVideos` come with
the video training data (ROADMAP.md item 24).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


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
