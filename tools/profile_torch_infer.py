#!/usr/bin/env python3
"""Where the PyTorch port's lavt_one inference step spends its time, on
one NVIDIA GPU.

    python3 tools/profile_torch_infer.py [--batch 8] [--steps 3] [--trace T]

Builds lavt_one Swin-B / window 12 / 480² / bf16 and its inputs with
chip_smoke.py's `main_path_model` and `requests`, then prints:
  * per-part forward times with CUDA events: BERT, backbone, decoder +
    final upsample, and the whole forward;
  * a torch.profiler window over `--steps` forwards: device time per step,
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
# the port's hand-written kernels (csrc/), by the names the profiler shows
HAND_WRITTEN = (
    "msa_fwd_sm90_kernel",         # K1, K2, K11, the save mode, K6's forward
    "window_attn_sm90_kernel",     # K10 and its save mode, K2p's attention
    "attn_bwd_q_kernel",           # K9
    "attn_bwd_kv_kernel",          # K9
    "msa_bwd_sm90_kernel",         # K5 / K6: the attention launch
    "mlp_ln_rows_kernel",          # K3 / K8: LN rows
    "mlp_bwd_prep_kernel",         # K7
    "ln_bwd_rows_kernel",          # K7
    "gemm_kernel",                 # the wgmma + TMA GEMM core (K3, K8, K7, the MSAs' GEMMs)
    "layer_norm_wide_rows_kernel",  # K4 at C > 1024
    "layer_norm_rows_kernel",      # K4
    "sum_partials_kernel",
    "colsum_bf16_kernel",
    "probe_kernel",                # P1 (<n / 16, true>), P2 (<n / 16, false>)
)


def category(name: str) -> str:
    for k in HAND_WRITTEN:
        if k in name:
            return k
    low = name.lower()
    if "fprop" in low or "conv" in low or "cudnn" in low:
        return "cuDNN conv"
    if "gemm" in low or "xmma" in low or "cutlass" in low or "nvjet" in low:
        return "cuBLAS GEMM"
    if "layer_norm" in low or "layernorm" in low:
        return "torch layer norm"
    if "softmax" in low:
        return "torch softmax"
    if "copy" in low or "memcpy" in low or "cat" in low or "roll" in low:
        return "copies / layout"
    if "elementwise" in low or "vectorized" in low or "reduce" in low:
        return "elementwise / reduce"
    return "other"


def cuda_ms(fn, iters):
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--trace", help="write the chrome trace here")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_infer: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke
    from lavt_rs_tpu_torch.ops.norm import maybe_normalize_image
    from lavt_rs_tpu_torch.ops.resize import resize_nchw

    dev = torch.device("cuda:0")
    g = torch.Generator(device=dev).manual_seed(chip_smoke.SEED)
    model = chip_smoke.main_path_model(dev, g)
    image, ids, mask, _ = chip_smoke.requests(dev, g, 1, args.batch)[0]
    img = maybe_normalize_image(image)
    ids, mask = ids[:, 0], mask[:, 0]
    dt = model.cfg.compute_dtype

    with torch.no_grad():
        fwd = lambda: model(img, ids, mask)
        for _ in range(3):
            fwd()
        torch.cuda.synchronize()
        l_feats = model.text_encoder(ids, mask)
        feats = model.backbone(img.to(dt), l_feats, mask)
        parts = {
            "bert": lambda: model.text_encoder(ids, mask),
            "backbone": lambda: model.backbone(img.to(dt), l_feats, mask),
            "decoder+upsample": lambda: resize_nchw(
                model.classifier(*feats[::-1]), img.shape[1:3]),
            "forward": fwd,
        }
        for name, fn in parts.items():
            print(f"{name}: {cuda_ms(fn, 5):.3f} ms (bs {args.batch})",
                  flush=True)

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(args.steps):
                fwd()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1000 / args.steps
    if args.trace:
        os.makedirs(os.path.dirname(os.path.abspath(args.trace)), exist_ok=True)
        prof.export_chrome_trace(args.trace)

    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) is not None
              and str(e.device_type).endswith("CUDA")]
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
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:25]:
        print(f"  {e.self_device_time_total / 1000 / args.steps:9.3f}  "
              f"{e.count / args.steps:6.1f}  {e.key[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
