#!/usr/bin/env python3
"""Time variants of K9 f32 (lavt_rs_tpu_torch/csrc/window_attn_bwd_f32.cu)
on one NVIDIA GPU, each built apart from a text edit of the sources.

    python3 tools/ablate_k9_f32.py

The variants: the sources as they are (every operand split by
truncation, csrc/attn_tf32.cuh); the fragment tiles split by rounding
(cvt.rna, the split csrc/gemm_f32.cuh takes); every split by rounding;
both launches built for one block an SM
(ptxas then takes registers past the 168 it keeps to at two, without
spilling; the blocks an SM then follow the registers); no tensor-core
products (the mma.sync
instructions removed, their operands still loaded and split: what the
rest costs; its values are wrong); no exp (P = s - lse; wrong values).
Each is built with `nvcc -Xptxas -v` into its own library under
build/ablate_k9_f32/ (registers and spill stores printed), checked
against the package's K9 f32 within 1e-4 abs + rel (the variants marked
"timing only" are expected to miss it and are not failed for it), and its
two launches timed by CUDA events at the video training shapes (an
8-frame 480² clip's stages 1 and 3, shifted) and window 7's stage 1 at
bs 8, in the order A B C ... C B A.  Exits 1 if a checked variant fails
its check.
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
FILES = ("common.cuh", "gemm_f32.cuh", "attn_tf32.cuh", SOURCE)
MMA = ('"mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "\n'
       '      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\\n"')
SPLIT_RZ = ("  hi = __float_as_uint(x) & 0xffffe000u;\n"
            "  lo = __float_as_uint(x - __uint_as_float(hi));\n")
# name: (edits (file, old, new, count), checked)
VARIANTS = {
    "as is": ((), True),
    "fragment tiles split by rounding": (
        (("attn_tf32.cuh", "      split_rz(", "      f32mma::split(", 4),),
        True),
    "every split by rounding": (
        (("attn_tf32.cuh", SPLIT_RZ, "  f32mma::split(x, hi, lo);\n", 1),),
        True),
    "registers past 168 (launch bounds of one block an SM)": (
        ((SOURCE, "__launch_bounds__(kThreads, 2)",
          "__launch_bounds__(kThreads, 1)", 2),), True),
    "no products (timing only)": ((("gemm_f32.cuh", MMA, '""', 1),), False),
    "no exp (timing only)": (((SOURCE, "expf(", "(", 2),), False),
}


def build(name, edits):
    """The variant's library (argtypes set), after printing its ptxas
    registers and spill stores (launch 2's first, as ptxas lists them)."""
    from lavt_rs_tpu_torch.ops import cuda_lib

    d = os.path.join(OUT, re.sub(r"\W+", "_", name))
    os.makedirs(d, exist_ok=True)
    for f in FILES:
        shutil.copy(os.path.join(CSRC, f), d)
    for f, old, new, count in edits:
        path = os.path.join(d, f)
        text = open(path).read()
        if text.count(old) != count:
            raise SystemExit(f"{name}: {f} has changed ({old!r})")
        with open(path, "w") as out:
            out.write(text.replace(old, new))
    so = os.path.join(d, "lib.so")
    r = subprocess.run([cuda_lib._nvcc(), "-Xptxas=-v", *cuda_lib.NVCC_FLAGS,
                        "-shared", "-o", so, os.path.join(d, SOURCE)],
                       capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(f"{name}: nvcc failed\n{r.stderr}")
    regs = re.findall(r"Used (\d+) registers", r.stderr)
    spills = re.findall(r"(\d+) bytes spill stores", r.stderr)
    print(f"{name}: registers {regs}, spill stores {spills} bytes", flush=True)
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
    from lavt_rs_tpu_torch.ops.window import shift_mask_2d, shift_mask_3d

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True).stdout.strip())
    cuda_lib.lib()
    libs = {name: build(name, edits) for name, (edits, _) in VARIANTS.items()}
    g = torch.Generator(device=dev).manual_seed(0)
    sc = 32 ** -0.5
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = cuda_lib.stream_ptr(dev)
    failed = False
    # (label, B nW, nW, heads, N, the shift mask)
    shapes = [(f"video stage {i} (N = 392)", nw, nw, heads, 392,
               shift_mask_3d(8, side, side, (8, 7, 7), (0, 3, 3), dev))
              for i, nw, heads, side in ((1, 324, 3, 126), (3, 25, 12, 35))]
    shapes.append(("window 7 stage 1 at bs 8 (N = 49)", 8 * 324, 324, 4, 49,
                   shift_mask_2d(126, 126, 7, 3, dev)))
    for label, bw, nw, heads, n, mask in shapes:
        q, k, v, do = (torch.randn((bw // nw, nw, heads, n, 32), generator=g,
                                   device=dev) for _ in range(4))
        bias = torch.randn((heads, n, n), generator=g, device=dev)
        flags = wa.mask_flags(mask)
        o, lse = wa.window_attention_save(q, k, v, bias, mask, sc)
        want = wa.attention_core_bwd(q, k, v, bias, mask, do, sc, o, lse,
                                     flags)
        plan = wa.k9_f32_plan(bw, heads, n, sms)
        order = list(libs) + list(libs)[::-1]
        times = {name: [] for name in libs}
        for name in order:
            lib, checked = libs[name], VARIANTS[name][1]
            dq, dsum = torch.empty_like(q), torch.empty_like(lse)
            part = torch.empty((plan["parts"], heads, n, n), device=dev)
            dk, dv = torch.empty_like(q), torch.empty_like(q)

            def launch1():
                cuda_lib.check(lib.lavt_window_attn_bwd_q_f32(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    do.data_ptr(), lse.data_ptr(), bias.data_ptr(),
                    mask.data_ptr(), flags.data_ptr(), dq.data_ptr(),
                    dsum.data_ptr(), part.data_ptr(), bw, nw, heads, n,
                    plan["bp"], sc, stream), name)

            def launch2():
                cuda_lib.check(lib.lavt_window_attn_bwd_kv_f32(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                    lse.data_ptr(), dsum.data_ptr(), bias.data_ptr(),
                    mask.data_ptr(), flags.data_ptr(), dk.data_ptr(),
                    dv.data_ptr(), bw, nw, heads, n, sc, stream), name)

            launch1()
            launch2()
            got = (dq, dk, dv, fused_msa.sum_partials(part))
            torch.cuda.synchronize()
            worst = max(((a - b).abs() / (1e-4 + 1e-4 * b.abs())).max().item()
                        for a, b in zip(got, want))
            if checked and not worst <= 1.0:
                print(f"{name}: disagrees with K9 f32 (worst error / limit "
                      f"{worst:.3f}) FAILED")
                failed = True
            times[name].append((cuda_ms(launch1), cuda_ms(launch2), worst))
        print(f"{label} ({bw} windows, {heads} heads), ms a call (two runs "
              f"each), worst error / the 1e-4 limit:")
        for name, runs in times.items():
            print(f"  {name}: launch 1 "
                  f"{', '.join(f'{a:.4f}' for a, _, _ in runs)}; launch 2 "
                  f"{', '.join(f'{b:.4f}' for _, b, _ in runs)}; error "
                  f"{max(e for _, _, e in runs):.3g}", flush=True)
        del q, k, v, do, o, lse, want
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
