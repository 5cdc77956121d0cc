"""Producer/consumer pipelining for eval loops (counterpart of
`lavt_rs_tpu/eval/pipeline.py`).

A strictly sequential loop alternates dataset decode -> host-to-device copy
-> enqueue -> result sync and leaves the card idle while the host works.
`run_pipelined` runs the decode and the copy in a producer thread (PIL's
decode and resize and the pinned copy release the interpreter lock) while
up to `depth` enqueued batches are in flight on the card.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from typing import Callable, Iterable

_DONE = object()


def run_pipelined(produce: Callable[[], Iterable], dispatch: Callable,
                  sink: Callable, depth: int = 2) -> float:
    """produce() yields prepared items (the host-to-device copy belongs
    inside it, so that it overlaps the card's work); dispatch(item)
    enqueues the device work and returns without waiting for it;
    sink(item, result) waits for the result (`.cpu()`) and consumes it.

    An exception raised in the producer is raised again here.  On any
    exit the producer is told to stop and is joined.  Returns the seconds
    the consumer waited on the producer (the card starved by the host's
    decode and copy when nothing was in flight)."""
    depth = max(depth, 1)
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def put(x) -> bool:
        while not stop.is_set():
            try:
                q.put(x, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _produce():
        try:
            for item in produce():
                if not put(item):
                    return
            put(_DONE)
        except BaseException as e:  # raised again in the consumer
            put(e)

    producer = threading.Thread(target=_produce, name="eval-producer",
                                daemon=True)
    producer.start()
    try:
        inflight: "deque" = deque()
        waited = 0.0
        while True:
            t0 = time.perf_counter()
            b = q.get()
            waited += time.perf_counter() - t0
            if b is _DONE:
                break
            if isinstance(b, BaseException):
                raise b
            inflight.append((b, dispatch(b)))
            if len(inflight) >= depth:
                sink(*inflight.popleft())
        while inflight:
            sink(*inflight.popleft())
        return waited
    finally:
        stop.set()
        producer.join()
