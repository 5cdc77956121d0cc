"""Threaded prefetching batch loader (counterpart of
`lavt_rs_tpu/data/loader.py`).

The reference overlaps host-side JPEG decode + resize with GPU compute via
torch DataLoader worker processes (train.py:554-563).  Here a thread pool
runs the dataset's `__getitem__` (PIL's decode and resize release the
interpreter lock) while the card runs the previous step, and a small
prefetch queue keeps the host-to-device copy ahead of the compute stream:
`device_put` (e.g. `to_device` on each array) runs in the producer
thread.

Batches come in the JAX package's order: a permutation drawn from
`seed + epoch`, every `num_shards`-th index from `shard_index`, the last
partial batch dropped with `drop_last`.  Every shard takes len // shards
items (the permutation's last len % shards are left to a later epoch's
draw), so the processes of a data-parallel run take the same number of
steps.  With `num_workers > 1` the
items of a batch are fetched concurrently, so a dataset's own random
draws (a sentence, an augmentation) are taken in the threads' order.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator, Optional, Sequence

import numpy as np
import torch

_SENTINEL = object()


class PrefetchLoader:
    """Wraps an index-based dataset into a shuffled, batched, prefetched
    iterator.

    collate: list of examples -> dict of stacked numpy arrays.
    device_put: optional, applied to each collated batch in the producer
    thread (e.g. `to_device` on each array).
    """

    def __init__(self, dataset, batch_size: int, collate: Callable,
                 shuffle: bool = True, drop_last: bool = True,
                 num_workers: int = 8, prefetch: int = 4, seed: int = 0,
                 shard_index: int = 0, num_shards: int = 1,
                 device_put: Optional[Callable] = None):
        self.ds = dataset
        self.batch_size = batch_size
        self.collate = collate
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.seed = seed
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.device_put = device_put
        self.epoch = 0

    def set_epoch(self, epoch: int):
        """DistributedSampler.set_epoch equivalent (reference train.py:739)."""
        self.epoch = epoch

    def __len__(self):
        n = len(self.ds) // self.num_shards
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[Dict]:
        order = np.arange(len(self.ds))
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(order)
        n = len(order) // self.num_shards
        order = order[self.shard_index::self.num_shards][:n]
        end = n - n % self.batch_size if self.drop_last else n
        batches = [order[s:s + self.batch_size]
                   for s in range(0, end, self.batch_size)]
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(x) -> bool:
            while not stop.is_set():
                try:
                    q.put(x, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for idxs in batches:
                        items = list(pool.map(self.ds.__getitem__,
                                              [int(i) for i in idxs]))
                        batch = self.collate(items)
                        if self.device_put is not None:
                            batch = self.device_put(batch)
                        if not put(batch):
                            return
                put(_SENTINEL)
            except BaseException as e:  # raised again in the consumer
                put(e)

        t = threading.Thread(target=produce, name="prefetch-loader",
                             daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is _SENTINEL:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            t.join()


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array as a tensor on `device`: on the card through pinned
    host memory by a non-blocking copy (issued on the caller's stream, so
    it runs ahead of the work that reads it); on the CPU as it is."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def collate_refer(items: Sequence) -> Dict[str, np.ndarray]:
    return {
        "image": np.stack([it.image for it in items]),
        # binary masks ship as uint8: a 480-squared int32 target is 4x the
        # bytes of the uint8 image itself; every consumer takes any int dtype
        "target": np.stack([it.target for it in items]).astype(np.uint8),
        "ids": np.stack([it.ids for it in items]).astype(np.int32),
        "mask": np.stack([it.mask for it in items]).astype(np.int32),
    }


def collate_video(items: Sequence) -> Dict[str, np.ndarray]:
    return {
        "video": np.stack([it.video for it in items]),
        "target": np.stack([it.target for it in items]).astype(np.uint8),
        "ids": np.stack([it.ids for it in items]).astype(np.int32),
        "mask": np.stack([it.mask for it in items]).astype(np.int32),
        "valid_index": np.asarray([it.valid_index for it in items],
                                  np.int32),
    }
