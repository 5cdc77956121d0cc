"""Probe: per-head attention (P1) against head-batched attention (P2).

Counterpart of `tools/probe_headbatch.py`, whose two Pallas kernels ask
whether the per-op cost of the fused MSA's many small per-head products,
not the matrix unit, bounds it.  On the card the same question reads: does
a kernel lose time by working one head at a time (P1: a block takes its
row block's heads one after another, as the Pallas loop does) rather than
all of a row block's heads at once (P2)?  Both kernels are in
`csrc/probe_headbatch.cu`, on one core (the row block's (window, head)
slots staged by TMA, scores in registers); they differ only in that
schedule.

    python -m lavt_rs_tpu_torch.tools.probe_headbatch [--ch 3] [--heads 4] \\
        [--n 144] [--hd 32] [--grid 96] [--rounds 6] [--device cuda]

x is (grid ch n, heads hd) bf16, numpy `default_rng(0)` normals times 0.1.
For every window of n rows and every head, q = k = v = the head's hd
columns; s = q qᵀ in f32, p = exp(min(s, 80)) / Σ rounded to bf16, and
o = p v in f32, written as bf16 into the head's columns.  The tool checks
P1 against P2 at atol 1e-2, as the JAX tool does, and prints the minimum
and median ms of `--rounds` rounds of 10 launches each (CUDA events).
It runs on the card unless `--device cpu` is given; on the CPU both
wrappers take the plain version and the times are host-clock times of it.
The kernels take hd = 32 and n a multiple of 16 up to 192.

The tool's input makes the softmax nearly uniform (scores about 0.3 on
the diagonal, 0.06 off it), so each output is close to its window's mean
and a 1e-2 check cannot tell a kernel that skips the scores.  A kernel is
held to its plain version on `probe_input(..., std=CHECK_STD)` instead
(scores about 5 on the diagonal, 0.9 off it) at `CHECK_ATOL` abs +
`CHECK_RTOL` rel, which the window mean and a copy of x both fail
(`mismatch`).
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..ops import cuda_lib

HEAD_DIM = 32
MAX_N = 192
# the kernel-vs-plain check: its input's std and tolerance
CHECK_STD = 0.4
CHECK_ATOL, CHECK_RTOL = 1e-3, 2e-2


def probe_attention_plain(x: torch.Tensor, heads: int, n: int,
                          hd: int = HEAD_DIM) -> torch.Tensor:
    """The plain version of P1 and P2: f32 math from x's values, p rounded
    to x's dtype before p v, the output rounded once."""
    rows, cq = x.shape
    q = x.float().view(rows // n, n, heads, hd).transpose(1, 2)
    s = q @ q.transpose(-1, -2)
    e = torch.exp(torch.clamp(s, max=80.0))
    p = (e / e.sum(-1, keepdim=True)).to(x.dtype).float()
    return (p @ q).to(x.dtype).transpose(1, 2).reshape(rows, cq)


# P1's and P2's blocks (csrc/probe_headbatch.cu): 256 threads, at most
# two a SM; an H100 SM's shared memory and a block's limit
BLOCKS_PER_SM = 2
SMEM_PER_BLOCK = 232448


def batch_smem(slots: int, n: int) -> int:
    """A block's dynamic shared memory for `slots` staged (window, head)
    tiles of n rows x 64 bytes: the tiles, a barrier each, 1 KB of
    alignment."""
    return 1024 + slots * (n * 64 + 8)


def _plan(grid: int, ch: int, heads: int, n: int, sms: int,
          unit: int) -> dict:
    """Each of the `grid` row blocks spread over `split` blocks, each
    staging and running ch heads / split slots: split divides
    ch heads / unit (a block takes whole runs of `unit` slots), the
    largest whose blocks still fit the card in one wave (split 1 where the
    row blocks alone fill it), raised until a block's slots fit."""
    slots = ch * heads
    runs = slots // unit
    split = 1 if grid >= sms else max(
        d for d in range(1, runs + 1)
        if runs % d == 0 and (d == 1 or grid * d <= sms * BLOCKS_PER_SM))
    while batch_smem(slots // split, n) > SMEM_PER_BLOCK and split < runs:
        split = next(d for d in range(split + 1, runs + 1) if runs % d == 0)
    smem = batch_smem(slots // split, n)
    if smem > SMEM_PER_BLOCK:
        raise ValueError(f"probe kernels: {slots // split} slots of n = {n} "
                         "do not fit a block")
    return dict(split=split, blocks=grid * split, slots_per_block=slots // split,
                smem=smem, waves=grid * split / (sms * BLOCKS_PER_SM))


def batch_plan(grid: int, ch: int, heads: int, n: int, sms: int) -> dict:
    """P2's launch: a row block's ch heads slots (window-major) cut into
    `split` equal runs, one block each."""
    return _plan(grid, ch, heads, n, sms, unit=1)


def loop_plan(grid: int, ch: int, heads: int, n: int, sms: int) -> dict:
    """P1's launch: a row block's heads cut into `split` equal runs, one
    block each, which works its heads one after another (split divides
    heads: a head's ch windows stay in one block)."""
    return _plan(grid, ch, heads, n, sms, unit=ch)


def _launch(x, ch, heads, n, hd, batch: bool) -> torch.Tensor:
    rows, cq = x.shape
    if hd != HEAD_DIM or n % 16 or not 16 <= n <= MAX_N:
        raise ValueError(f"probe kernels: unsupported (n, hd) {(n, hd)}")
    if cq != heads * hd or ch <= 0 or rows % (ch * n):
        raise ValueError(f"probe kernels: x {tuple(x.shape)} is not blocks "
                         f"of {ch} windows of {n} rows x {heads} heads")
    cuda_lib.require(x, "x", torch.bfloat16, x.device)
    if x.data_ptr() % 16:
        raise ValueError("x: data must be 16-byte aligned")
    o = torch.empty_like(x)
    grid = rows // (ch * n)
    plan = batch_plan if batch else loop_plan
    split = plan(grid, ch, heads, n, cuda_lib.sm_count(x.device.index or 0))["split"]
    err = cuda_lib.lib().lavt_probe_headbatch(
        x.data_ptr(), o.data_ptr(), grid, ch, n, heads, int(batch), split,
        cuda_lib.stream_ptr(x.device))
    cuda_lib.check(err, "lavt_probe_headbatch")
    return o


def loop_attention(x: torch.Tensor, ch: int, heads: int, n: int,
                   hd: int = HEAD_DIM) -> torch.Tensor:
    """P1 (`loop_kernel`): the per-head schedule.  A row block's slots are
    staged in shared memory by TMA; a block (`loop_plan`'s split of the
    row block's heads) works its heads one after another, each head's
    windows by the block's warps in parallel, a barrier between heads.
    The plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return probe_attention_plain(x, heads, n, hd)
    out = _launch(x, ch, heads, n, hd, batch=False)
    loop_attention.launches += 1
    return out


def batch_attention(x: torch.Tensor, ch: int, heads: int, n: int,
                    hd: int = HEAD_DIM) -> torch.Tensor:
    """P2 (`batch_kernel`): a row block's (window, head) slots staged once
    in shared memory by TMA and run in parallel by the block's warps (the
    row block over `batch_plan`'s split blocks).  The plain version on a
    CPU tensor."""
    if x.device.type == "cpu":
        return probe_attention_plain(x, heads, n, hd)
    out = _launch(x, ch, heads, n, hd, batch=True)
    batch_attention.launches += 1
    return out


loop_attention.launches = 0
batch_attention.launches = 0


def probe_input(grid: int, ch: int, heads: int, n: int, hd: int = HEAD_DIM,
                device="cpu", std: float = 0.1) -> torch.Tensor:
    """x: default_rng(0) normals times std, in bf16 (std 0.1: the JAX
    tool's)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((grid * ch * n, heads * hd)) * std
    return torch.from_numpy(x.astype(np.float32)).to(device, torch.bfloat16)


def mismatch(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest |got - want| / (CHECK_ATOL + CHECK_RTOL |want|): the
    check passes at <= 1."""
    want = want.float()
    err = (got.float() - want).abs()
    return (err / (CHECK_ATOL + CHECK_RTOL * want.abs())).max().item()


def _times_ms(fn, device, rounds: int, iters: int = 10):
    """ms per call of each round (CUDA events on the card, host clock on
    the CPU)."""
    fn()
    out = []
    for _ in range(rounds):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            torch.cuda.synchronize(device)
            out.append(start.elapsed_time(end) / iters)
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            out.append((time.perf_counter() - t0) * 1e3 / iters)
    return out


def get_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("lavt_rs_tpu_torch head-batching probe")
    ap.add_argument("--ch", type=int, default=3)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--n", type=int, default=144)
    ap.add_argument("--hd", type=int, default=32)
    ap.add_argument("--grid", type=int, default=96)
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default: the kernels) or cpu (the plain "
                         "version)")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = get_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            print("probe_headbatch: CUDA is not available (pass --device cpu "
                  "for the plain version)", file=sys.stderr)
            return 1
        print(f"device: {torch.cuda.get_device_name(device)}")
    else:
        print("device: cpu (the plain version; host-clock times)")
    x = probe_input(args.grid, args.ch, args.heads, args.n, args.hd, device)
    shape = (args.ch, args.heads, args.n, args.hd)
    ra, rb = loop_attention(x, *shape), batch_attention(x, *shape)
    err = (ra.float() - rb.float()).abs().max().item()
    if not err <= 1e-2:
        print(f"probe_headbatch: loop and batch differ by {err:.4g} "
              "(atol 1e-2)", file=sys.stderr)
        return 1
    ta = _times_ms(lambda: loop_attention(x, *shape), device, args.rounds)
    tb = _times_ms(lambda: batch_attention(x, *shape), device, args.rounds)
    print(f"x {tuple(x.shape)} bf16, loop vs batch max abs diff {err:.3g}")
    print(f"loop : min {min(ta):.3f}  med {statistics.median(ta):.3f} ms")
    print(f"batch: min {min(tb):.3f}  med {statistics.median(tb):.3f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
