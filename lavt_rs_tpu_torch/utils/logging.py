"""Training-loop metering (counterpart of `lavt_rs_tpu/utils/logging.py`):
SmoothedValue / MetricLogger.

Behavioral contract: reference utils.py:16-150
  * SmoothedValue: windowed deque median/avg + global avg;
  * MetricLogger.log_every: iter/data timing, ETA, peak device memory
    (`torch.cuda.max_memory_allocated`, as the reference prints it);
  * is_main_process / print gating (reference utils.py:161-202);
  * synchronize_between_processes: each meter's (count, total) summed
    over the processes (reference utils.py:34-45), a no-op on one.
"""

from __future__ import annotations

import datetime
import sys
import time
from collections import defaultdict, deque
from typing import Iterable, Optional

import torch


def _world() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def is_main_process() -> bool:
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()) or \
        dist.get_rank() == 0


def print_master(*args, **kw):
    if is_main_process():
        print(*args, **kw)


class SmoothedValue:
    def __init__(self, window_size: int = 20,
                 fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque: deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value, n: int = 1):
        self.deque.append(float(value))
        self.count += n
        self.total += float(value) * n

    def synchronize_between_processes(self):
        """All-reduce (count, total) across processes (reference
        utils.py:34-45); nothing to do on one process.  The deque is not
        synchronized, as in the reference.  The tensor lies on the card
        under NCCL and on the host under gloo."""
        if _world() == 1:
            return
        import torch.distributed as dist

        dev = (torch.device("cuda", torch.cuda.current_device())
               if dist.get_backend() == "nccl" else torch.device("cpu"))
        t = torch.tensor([self.count, self.total], dtype=torch.float64,
                         device=dev)
        dist.barrier()
        dist.all_reduce(t)
        self.count, self.total = int(t[0].item()), float(t[1].item())

    @property
    def median(self) -> float:
        d = sorted(self.deque)
        return d[len(d) // 2] if d else 0.0

    @property
    def avg(self) -> float:
        return sum(self.deque) / len(self.deque) if self.deque else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)

    @property
    def max(self) -> float:
        return max(self.deque) if self.deque else 0.0

    @property
    def value(self) -> float:
        return self.deque[-1] if self.deque else 0.0

    def __str__(self):
        return self.fmt.format(median=self.median, avg=self.avg,
                               global_avg=self.global_avg, max=self.max,
                               value=self.value)


def device_memory_mb() -> Optional[float]:
    """Peak device memory allocated by torch on the current card, in MiB
    (the reference's `torch.cuda.max_memory_allocated` line); None when
    this process has not used the card."""
    if not torch.cuda.is_initialized():
        return None
    return torch.cuda.max_memory_allocated() / (1024.0 * 1024.0)


class MetricLogger:
    def __init__(self, delimiter: str = "  ", out=None):
        self.meters = defaultdict(SmoothedValue)
        self.delimiter = delimiter
        # resolve at call time so stream redirection (capsys, tee) works
        self.out = out if out is not None else sys.stderr
        # seconds per iteration and waiting for data, over log_every's loop
        self.iter_time = SmoothedValue(fmt="{avg:.4f}")
        self.data_time = SmoothedValue(fmt="{avg:.4f}")

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def add_meter(self, name, meter):
        self.meters[name] = meter

    def synchronize_between_processes(self):
        for m in self.meters.values():
            m.synchronize_between_processes()

    def __str__(self):
        return self.delimiter.join(
            f"{name}: {meter}" for name, meter in self.meters.items())

    def log_every(self, iterable: Iterable, print_freq: int,
                  header: str = ""):
        i = 0
        start = time.time()
        end = time.time()
        iter_time, data_time = self.iter_time, self.data_time
        n = len(iterable) if hasattr(iterable, "__len__") else None
        for obj in iterable:
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if i % print_freq == 0 and is_main_process():
                parts = [header]
                if n:
                    eta = iter_time.global_avg * (n - i)
                    parts.append(f"[{i}/{n}]")
                    parts.append(
                        f"eta: {datetime.timedelta(seconds=int(eta))}")
                parts.append(str(self))
                parts.append(f"time: {iter_time}")
                parts.append(f"data: {data_time}")
                mem = device_memory_mb()
                if mem is not None:
                    parts.append(f"mem: {mem:.0f}MB")
                print(self.delimiter.join(parts), file=self.out, flush=True)
            i += 1
            end = time.time()
        total = time.time() - start
        if is_main_process():
            print(f"{header} Total time: "
                  f"{datetime.timedelta(seconds=int(total))}",
                  file=self.out, flush=True)
