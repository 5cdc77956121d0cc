#!/usr/bin/env python3
"""Times K7 (the fused LN-MLP backward, with the DropPath keep) at the four
Swin-B 480² bs-8 stage shapes on one NVIDIA GPU, and prints its largest
relative Frobenius error against the plain version.

    python3 tools/time_torch_k7.py [--iters 20]

Prints one JSON object {C: [ms per call, error]}.  To compare two trees
on one card, run it from each tree's root in one command, in turns
(parent, change, change, parent).
"""

import argparse
import json
import os
import sys

STAGES = ((120, 128), (60, 256), (30, 512), (15, 1024))  # (side, C)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("time_torch_k7: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    from lavt_rs_tpu_torch.ops import fused_mlp

    dev = torch.device("cuda:0")
    g = torch.Generator(device=dev).manual_seed(0)

    def rnd(shape, std=1.0, mean=0.0):
        t = torch.randn(shape, generator=g, device=dev) * std + mean
        return t.bfloat16()

    keep = torch.where(torch.arange(8, device=dev) % 3 != 1, 1 / 0.7,
                       0.0).float()
    out = {}
    for side, c in STAGES:
        rows = 8 * side * side
        x, gy = rnd((rows, c)), rnd((rows, c))
        p = (rnd((c,), 0.2, 1.0), rnd((c,), 0.2), rnd((4 * c, c), c ** -0.5),
             rnd((4 * c,), 0.2), rnd((c, 4 * c), (4 * c) ** -0.5))
        fn = lambda: fused_mlp.fused_ln_mlp_bwd(x, gy, *p, keep, side * side)
        want = fused_mlp.fused_ln_mlp_bwd_plain(x, gy, *p, keep, side * side)
        err = max(((a.float() - b.float()).norm() / b.float().norm()).item()
                  for a, b in zip(fn(), want))
        for _ in range(3):
            fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        out[c] = [start.elapsed_time(end) / args.iters, err]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
