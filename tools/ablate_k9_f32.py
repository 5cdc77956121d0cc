#!/usr/bin/env python3
"""Time variants of K9 f32 (lavt_rs_tpu_torch/csrc/window_attn_bwd_f32.cu)
on one NVIDIA GPU, each built apart from a text edit of the sources.

    python3 tools/ablate_k9_f32.py

The variants: the source as it is (launch 1 at two blocks an SM, launch
2 at three, the bias read as it is); launch 1 at three blocks an SM (its
grid sized for three, `__launch_bounds__(128, 3)`: 168 registers); launch
2 reading a transposed copy of the bias (coalesced along the queries).
Each is built with `nvcc -Xptxas -v` into its own library under
build/ablate_k9_f32/ (registers and spill stores printed), checked
against the package's K9 f32 within 1e-4 abs + rel, and its two launches
timed by CUDA events at the video training shapes (an 8-frame 480² clip's
stages 1-3, shifted), in the order A B C C B A.  Exits 1 if a variant
fails its check.
"""

import ctypes
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "lavt_rs_tpu_torch", "csrc")
OUT = os.path.join(ROOT, "build", "ablate_k9_f32")
SOURCE = "window_attn_bwd_f32.cu"
Q_BOUNDS = "__launch_bounds__(kThreads, 2) window_attn_bwd_q_f32_kernel"
KV_BIAS = "st[r][c] + __ldg(bias + off)"
KV_BIAS_T = "st[r][c] + __ldg(bias + static_cast<size_t>(keyc) * n + q0 + i)"
# name: (text edits, launch-1 blocks an SM, launch 2 takes the bias transposed)
VARIANTS = {
    "as is": ((), 2, False),
    "launch 1 at 3 blocks an SM": (
        ((Q_BOUNDS, Q_BOUNDS.replace("kThreads, 2", "kThreads, 3")),), 3, False),
    "launch 2 on a transposed bias": (((KV_BIAS, KV_BIAS_T),), 2, True),
}


def build(name, edits):
    """The variant's library (argtypes set), after printing its ptxas
    registers and spill stores (launch 2's first, as ptxas lists them)."""
    from lavt_rs_tpu_torch.ops import cuda_lib

    d = os.path.join(OUT, re.sub(r"\W+", "_", name))
    os.makedirs(d, exist_ok=True)
    for f in ("common.cuh", "attn_f32.cuh", SOURCE):
        shutil.copy(os.path.join(CSRC, f), d)
    text = open(os.path.join(CSRC, SOURCE)).read()
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"{name}: the source has changed ({old!r})")
        text = text.replace(old, new)
    with open(os.path.join(d, SOURCE), "w") as f:
        f.write(text)
    so = os.path.join(d, "lib.so")
    r = subprocess.run([cuda_lib._nvcc(), "-Xptxas=-v", *cuda_lib.NVCC_FLAGS,
                        "-shared", "-o", so, os.path.join(d, SOURCE)],
                       capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(f"{name}: nvcc failed\n{r.stderr}")
    print(f"{name}: registers {re.findall(r'Used (\d+) registers', r.stderr)}, "
          f"spill stores {re.findall(r'(\d+) bytes spill stores', r.stderr)} "
          f"bytes", flush=True)
    lib = ctypes.CDLL(so)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.lavt_window_attn_bwd_q_f32.argtypes = [P] * 12 + [I] * 5 + [F, P]
    lib.lavt_window_attn_bwd_kv_f32.argtypes = [P] * 11 + [I] * 4 + [F, P]
    return lib


def cuda_ms(fn, iters=10):
    import torch

    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main():
    import torch

    if not torch.cuda.is_available():
        print("ablate_k9_f32: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from lavt_rs_tpu_torch.ops import cuda_lib, fused_msa
    from lavt_rs_tpu_torch.ops import window_attn as wa
    from lavt_rs_tpu_torch.ops.window import shift_mask_3d

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True).stdout.strip())
    cuda_lib.lib()
    libs = {name: build(name, edits) for name, (edits, _, _) in VARIANTS.items()}
    g = torch.Generator(device=dev).manual_seed(0)
    sc, n = 32 ** -0.5, 392
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = cuda_lib.stream_ptr(dev)
    failed = False
    for nw, heads, side in ((324, 3, 126), (81, 6, 63), (25, 12, 35)):
        q, k, v, do = (torch.randn((1, nw, heads, n, 32), generator=g,
                                   device=dev) for _ in range(4))
        bias = torch.randn((heads, n, n), generator=g, device=dev)
        mask = shift_mask_3d(8, side, side, (8, 7, 7), (0, 3, 3), dev)
        flags = wa.mask_flags(mask)
        o, lse = wa.window_attention_save(q, k, v, bias, mask, sc)
        want = wa.attention_core_bwd(q, k, v, bias, mask, do, sc, o, lse,
                                     flags)
        bias_t = bias.transpose(1, 2).contiguous()
        order = list(libs) + list(libs)[::-1]
        times = {name: [] for name in libs}
        for name in order:
            lib, (_, per_sm, transposed) = libs[name], VARIANTS[name]
            bp = max(1, min(nw, per_sm * sms // (-(-n // 64) * heads)))
            dq, dsum = torch.empty_like(q), torch.empty_like(lse)
            part = torch.empty((bp, heads, n, n), device=dev)
            dk, dv = torch.empty_like(q), torch.empty_like(q)
            kv_bias = bias_t if transposed else bias

            def launch1():
                cuda_lib.check(lib.lavt_window_attn_bwd_q_f32(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    do.data_ptr(), lse.data_ptr(), bias.data_ptr(),
                    mask.data_ptr(), flags.data_ptr(), dq.data_ptr(),
                    dsum.data_ptr(), part.data_ptr(), nw, nw, heads, n, bp, sc,
                    stream), name)

            def launch2():
                cuda_lib.check(lib.lavt_window_attn_bwd_kv_f32(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                    lse.data_ptr(), dsum.data_ptr(), kv_bias.data_ptr(),
                    mask.data_ptr(), flags.data_ptr(), dk.data_ptr(),
                    dv.data_ptr(), nw, nw, heads, n, sc, stream), name)

            launch1()
            launch2()
            got = (dq, dk, dv, fused_msa.sum_partials(part))
            torch.cuda.synchronize()
            worst = max(((a - b).abs() / (1e-4 + 1e-4 * b.abs())).max().item()
                        for a, b in zip(got, want))
            if not worst <= 1.0:
                print(f"{name}: disagrees with K9 f32 (worst error / limit "
                      f"{worst:.3f}) FAILED")
                failed = True
            times[name].append((cuda_ms(launch1), cuda_ms(launch2)))
        print(f"video stage ({nw} windows, {heads} heads, N = {n}), ms a call "
              f"(two runs each):")
        for name, runs in times.items():
            print(f"  {name}: launch 1 "
                  f"{', '.join(f'{a:.4f}' for a, _ in runs)}; launch 2 "
                  f"{', '.join(f'{b:.4f}' for _, b in runs)}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
