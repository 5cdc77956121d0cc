"""Frame-sampling policies of the video datasets (counterpart of
`lavt_rs_tpu/data/video_sampling.py`).

Behavioral contract: reference data/a2d.py:75-144 and data/ytvos.py:132-177,
the MTTR-style sparse sampler (the annotated frame, two local neighbours
at offsets U[1, 3] and a random global fill) and the consecutive,
edge-padded eval window.  The sparse sampler takes the JAX package's
`random.Random` draws in its order, so one seed gives the same clips.
"""

from __future__ import annotations

import random
from typing import List, Tuple


def sparse_sample(frame_id: int, vid_len: int, num_frames: int,
                  rng: random.Random) -> Tuple[List[int], int]:
    """Returns (sorted frame indices, position of frame_id)."""
    sample_indx = [frame_id]
    before = rng.randint(1, 3)
    after = rng.randint(1, 3)
    sample_indx.extend([max(0, frame_id - before),
                        min(vid_len - 1, frame_id + after)])

    if num_frames > 3:
        all_inds = list(range(vid_len))
        global_inds = (all_inds[: min(sample_indx)]
                       + all_inds[max(sample_indx):])
        global_n = num_frames - len(sample_indx)
        if len(global_inds) > global_n:
            for s in rng.sample(range(len(global_inds)), global_n):
                sample_indx.append(global_inds[s])
        elif vid_len >= global_n:
            for s in rng.sample(range(vid_len), global_n):
                sample_indx.append(all_inds[s])
        else:
            ids = rng.sample(range(vid_len), global_n - vid_len) \
                + list(range(vid_len))
            for s in ids:
                sample_indx.append(all_inds[s])
    sample_indx.sort()
    return sample_indx, sample_indx.index(frame_id)


def consecutive_window(frame_id: int, vid_len: int,
                       clip_length: int) -> Tuple[List[int], int]:
    """clip_length consecutive frames centred on frame_id, edge-padded
    (reference a2d.py:137-144)."""
    start = frame_id - clip_length // 2
    end = frame_id + (clip_length + 1) // 2
    idx = [min(max(i, 0), vid_len - 1) for i in range(start, end)]
    idx.sort()
    return idx, idx.index(frame_id)
