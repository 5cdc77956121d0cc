#!/usr/bin/env python3
"""K4 (the row LayerNorm) and its backward on one NVIDIA GPU: each launch
by device time at the Swin-B 480² bs-8 shapes, and the LN backward's
share of the window-12 bs-8 training step.

    python3 lavt_rs_tpu_torch/tools/profile_ln.py [--root CHECKOUT]
        [--no-kernels] [--no-step] [--steps 3]

`--root` is the root of the checkout whose `lavt_rs_tpu_torch` (and
`chip_smoke.py`, for the step's seeded model and batch) is measured; by
default the one that holds this file.  Run the file by its path (not
with -m) to measure another checkout.

Kernels (`kernel_lines`), at (115200, 128), (28800, 256), (7200, 512) and
(1800, 1024), the stage norms' shapes, which are also K1's LN rows at
stages 1 and 2: device ms per launch (torch.profiler, over 10 launches
after a warm-up) of
  * K4's launch (`ln.layer_norm_rows_launch`), K3's LN-rows launch
    (`fused_mlp.mlp_ln_rows`, two-pass) and `F.layer_norm` in bf16;
  * the LN backward: K4b (`ln.layer_norm_rows_bwd_launch`) where the
    checkout has it, the plain chain (`ln.layer_norm_rows_bwd_plain`) with
    its launch count, and autograd through bf16 `F.layer_norm`;
each beside its byte bound at 3.35 TB/s.

Step (`step_lines`): the lavt_one Swin-B window-12 bs-8 training step of
chip_smoke.py (seeded weights, synthetic batch, AdamW) under
torch.profiler over `--steps` steps after two warm-up steps, with the LN
backward's two call sites wrapped in `torch.profiler.record_function`:
the stage norms' (`LayerNormRows.backward`) and K1's pre-attention LN
(`FusedWindowMSA.backward`).  Prints the device busy per step and, per
call site, the device ms and kernel launches per step inside the range.
"""

from __future__ import annotations

import argparse
import functools
import os
import sys

SHAPES = ((115200, 128), (28800, 256), (7200, 512), (1800, 1024))
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
# the LN backward's call sites: (label, module, the names either tree
# calls there)
SITES = (("LN bwd: stage norms", "ln",
          ("layer_norm_rows_bwd_plain", "layer_norm_rows_bwd")),
         ("LN bwd: K1's LN", "fused_msa",
          ("layer_norm_rows_bwd_plain", "layer_norm_rows_bwd_launch")))


def log(*a):
    print(*a, flush=True)


def _sessions(fn, n):
    """One torch.profiler session over n calls of fn: {kernel name: (device
    us, launches)}."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return {e.key: (getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0)), e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


def device_ms(fn, iters=10, tries=3):
    """(device ms, kernel launches, {short kernel name: device ms}) per
    call of fn, or (None, None, {}) when no session recorded a whole
    window."""
    import torch

    def launches(session):
        return sum(n for _, n in session.values())

    fn()
    torch.cuda.synchronize()
    per_call = max(launches(_sessions(fn, 1)) for _ in range(tries))
    for _ in range(tries):
        session = _sessions(fn, iters)
        if per_call and launches(session) >= per_call * iters:
            by = {short(k): us / 1e3 / iters for k, (us, _) in session.items()}
            return sum(by.values()), launches(session) // iters, by
    return None, None, {}


def short(name):
    """A kernel's name without its namespace, parameters and template
    arguments."""
    return name.split("(")[0].replace("void ", "").split("<")[0].split("::")[-1]


def fmt(ms):
    return "not measured" if ms is None else f"{ms:.4f}"


def kernel_lines(dev, card):
    """Each LN launch, forward and backward, at the stage shapes."""
    import torch
    import torch.nn.functional as F

    from lavt_rs_tpu_torch.ops import fused_mlp, ln

    g = torch.Generator(device=dev).manual_seed(0)

    def rnd(shape, std=1.0, mean=0.0):
        return (torch.randn(shape, generator=g, device=dev) * std
                + mean).bfloat16()

    has_k4b = hasattr(ln, "layer_norm_rows_bwd_launch")
    for rows, c in SHAPES:
        x, gy = rnd((rows, c), 2.0, 0.5), rnd((rows, c))
        s, b = rnd((c,), 0.2, 1.0), rnd((c,), 0.2)
        sf = s.float()
        fwd_bound = (2 * rows * c * 2 + 2 * c * 2) / PEAK_BYTES * 1e3
        bwd_bound = (3 * rows * c * 2 + c * 4 + 2 * c * 4) / PEAK_BYTES * 1e3
        fwd = {"K4": lambda: ln.layer_norm_rows_launch(x, s, b),
               "K3's LN rows": lambda: fused_mlp.mlp_ln_rows(x, s, b),
               "F.layer_norm": lambda: F.layer_norm(x, (c,), s, b, 1e-5)}
        parts = []
        for name, fn in fwd.items():
            ms = device_ms(fn)[0]
            parts.append(f"{name} {fmt(ms)}")
        log(f"LN forward ({rows}, {c}), device ms per launch: "
            + "; ".join(parts) + f" (bound {fwd_bound:.4f} bytes)  [{card}]")
        leaves = [t.detach().requires_grad_() for t in (x, s, b)]
        y = F.layer_norm(leaves[0], (c,), leaves[1], leaves[2], 1e-5)
        bwd = {"plain chain": lambda: ln.layer_norm_rows_bwd_plain(x, sf, gy),
               "F.layer_norm autograd": lambda: torch.autograd.grad(
                   y, leaves, gy, retain_graph=True)}
        if has_k4b:
            bwd = {"K4b": lambda: ln.layer_norm_rows_bwd_launch(x, sf, gy),
                   **bwd}
        parts = []
        for name, fn in bwd.items():
            ms, n, by = device_ms(fn)
            kernels = (" = " + " + ".join(f"{k} {v:.4f}" for k, v in by.items())
                       if name == "K4b" else "")
            parts.append(f"{name} {fmt(ms)} ({n} kernels{kernels})")
        log(f"LN backward ({rows}, {c}), device ms per call: "
            + "; ".join(parts) + f" (bound {bwd_bound:.4f} bytes)  [{card}]")
        del x, gy, y, leaves
        torch.cuda.empty_cache()


def _labelled(label, fn):
    import torch

    @functools.wraps(fn)
    def run(*a, **k):
        with torch.profiler.record_function(label):
            return fn(*a, **k)
    return run


def _within(events, labels):
    """{label: (kernel launches, device us)} of the device work inside
    each label's ranges on the device's timeline: the profiler's
    device-side annotation of a `record_function` range spans the kernels
    launched in it, whether by an aten op or through ctypes (the profiler
    links only the former to the range's CPU events)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    spans = {label: [] for label in labels}
    kernels = []
    for e in events:
        if e.device_type != cuda:
            continue
        t = (e.time_range.start, e.time_range.end)
        if e.name in spans:
            spans[e.name].append(t)
        elif not (getattr(e, "is_user_annotation", False)
                  or e.name.startswith(("Optimizer.", "ProfilerStep"))):
            kernels.append(t)
    out = {}
    for label, ranges in spans.items():
        n = us = 0
        for a, b in ranges:
            for k0, k1 in kernels:
                if a <= k0 and k1 <= b:
                    n, us = n + 1, us + (k1 - k0)
        out[label] = (n, us)
    return out


def step_profile(dev, steps=3):
    """The window-12 bs-8 training step under torch.profiler with the LN
    backward's call sites labelled: (wall ms, device busy ms, {label:
    (device ms, launches)}) per step."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from lavt_rs_tpu_torch.ops import fused_msa, ln

    mods = {"ln": ln, "fused_msa": fused_msa}
    saved = []
    for label, mod, names in SITES:
        for name in names:
            if hasattr(mods[mod], name):
                saved.append((mods[mod], name, getattr(mods[mod], name)))
                setattr(mods[mod], name,
                        _labelled(label, getattr(mods[mod], name)))
    try:
        g = torch.Generator(device=dev).manual_seed(chip_smoke.SEED)
        weights = chip_smoke.main_path_model(dev, g).state_dict()
        step = chip_smoke.train_setup(dev, weights)
        del weights
        batch = chip_smoke.train_batch(dev, g, chip_smoke.BATCH)
        gen = torch.Generator(device=dev)
        for _ in range(2):
            step(batch, gen)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                step(batch, gen)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / steps
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    labels = [label for label, _, _ in SITES]
    # annotation ranges (the labels, the optimizer's step, profiler steps)
    # span the kernels launched in them: counting them too would count
    # those twice
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.key not in labels
               and not e.key.startswith(("Optimizer.", "ProfilerStep"))
               ) / 1e3 / steps
    sites = {label: (us / 1e3 / steps if n else None, n / steps)
             for label, (n, us) in _within(prof.events(), labels).items()}
    return wall, busy, sites


def step_lines(dev, card, steps=3):
    wall, busy, sites = step_profile(dev, steps)
    log(f"window-12 bs-8 train step under torch.profiler ({steps} steps): "
        f"wall {wall:.3f} ms, device busy {busy:.3f} ms per step  [{card}]")
    for label, (ms, n) in sites.items():
        log(f"  {label}: {fmt(ms)} device ms, {n:g} kernel launches per "
            f"step")
    total = [ms for ms, _ in sites.values()]
    if None not in total:
        log(f"  LN backward in all: {sum(total):.4f} device ms per step")
    return busy, sites


def main():
    here = os.path.dirname(os.path.abspath(__file__))
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(here)),
                    help="the checkout to measure")
    ap.add_argument("--no-kernels", action="store_true")
    ap.add_argument("--no-step", action="store_true")
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()
    if "lavt_rs_tpu_torch" in sys.modules:
        raise SystemExit("profile_ln: run this file by its path, not with -m")
    sys.path.insert(0, os.path.abspath(args.root))

    import subprocess

    import torch

    if not torch.cuda.is_available():
        print("profile_ln: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader", "-i", "0"],
                          capture_output=True, text=True,
                          check=True).stdout.strip()
    import lavt_rs_tpu_torch

    log(f"profile_ln on {os.path.dirname(lavt_rs_tpu_torch.__file__)}  "
        f"[{card}]")
    dev = torch.device("cuda:0")
    if not args.no_kernels:
        kernel_lines(dev, card)
    if not args.no_step:
        step_lines(dev, card, args.steps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
