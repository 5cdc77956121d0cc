#!/usr/bin/env python3
"""Where the PyTorch port's lavt_one (or lavt_video) training step spends
its time, on one NVIDIA GPU.

    python3 tools/profile_torch_train.py [--batch 8] [--steps 3] [--trace T]
    python3 tools/profile_torch_train.py --video [--steps 3]

Builds lavt_one Swin-B / window 12 / 480² for training (f32 parameters,
bf16 compute, AdamW, DropPath 0.3, dropout 0.1) from chip_smoke.py's
seeded `main_path_model` weights and a synthetic batch (`train_batch`);
with --video, lavt_video_tiny (DropPath 0.1, BERT dropout 0.1) with
seeded random weights on one synthetic 8-frame 480² clip
(`video_train_batch`).  Takes two warm-up steps, then prints:
  * the step time with CUDA events over `--steps` steps;
  * a torch.profiler window over `--steps` steps: device time per step,
    the device's idle share of the wall time, the device time by category
    (the hand-written kernels by name, cuBLAS GEMMs, cuDNN convs, the
    rest), and the top kernels by device time.
With --trace, the chrome trace of the window is written to that path.
"""

import argparse
import os
import sys
import time
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from profile_torch_infer import category, cuda_ms  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--trace", help="write the chrome trace here")
    ap.add_argument("--video", action="store_true",
                    help="the lavt_video step on one clip (no --batch)")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_train: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke

    dev = torch.device("cuda:0")
    g = torch.Generator(device=dev).manual_seed(chip_smoke.SEED)
    if args.video:
        from lavt_rs_tpu_torch.config import lavt_video_tiny
        from lavt_rs_tpu_torch.models.factory import build_model
        from lavt_rs_tpu_torch.train.optim import TrainConfig
        from lavt_rs_tpu_torch.train.step import (create_train_state,
                                                  make_video_train_step)

        model = build_model(lavt_video_tiny(), dev, generator=g, train=True)
        tcfg = TrainConfig()
        step = make_video_train_step(model, *create_train_state(model, tcfg),
                                     tcfg)
        batch = chip_smoke.video_train_batch(dev, g)
    else:
        weights = chip_smoke.main_path_model(dev, g).state_dict()
        step = chip_smoke.train_setup(dev, weights)
        batch = chip_smoke.train_batch(dev, g, args.batch)
    gen = torch.Generator(device=dev)
    run = lambda: step(batch, gen)
    for _ in range(2):
        run()
    torch.cuda.synchronize()
    what = "one clip" if args.video else f"bs {args.batch}"
    print(f"train step: {cuda_ms(run, args.steps):.3f} ms ({what}, mean of "
          f"{args.steps})", flush=True)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1000 / args.steps
    if args.trace:
        os.makedirs(os.path.dirname(os.path.abspath(args.trace)), exist_ok=True)
        prof.export_chrome_trace(args.trace)

    # annotation ranges (the optimizer's step, profiler steps) cover the
    # kernels they launch: counting them too would count those twice
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) is not None
              and str(e.device_type).endswith("CUDA")
              and not e.key.startswith(("Optimizer.", "ProfilerStep"))]
    dev_us = {e.key: e.self_device_time_total for e in events}
    total_ms = sum(dev_us.values()) / 1000 / args.steps
    print(f"profiled: wall {wall_ms:.3f} ms/step, device busy "
          f"{total_ms:.3f} ms/step, idle share "
          f"{max(0.0, 1 - total_ms / wall_ms):.3f}")
    by_cat = defaultdict(float)
    for k, us in dev_us.items():
        by_cat[category(k)] += us / 1000 / args.steps
    for cat, ms in sorted(by_cat.items(), key=lambda kv: -kv[1]):
        print(f"  {cat:28s} {ms:9.3f} ms/step  {ms / total_ms:6.1%}")
    print("top kernels (device ms/step, calls/step):")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:30]:
        print(f"  {e.self_device_time_total / 1000 / args.steps:9.3f}  "
              f"{e.count / args.steps:6.1f}  {e.key[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
