#!/usr/bin/env python3
"""Time variants of the 3xTF32 GEMM core (lavt_rs_tpu_torch/csrc/
gemm_tf32_sm90.cuh) on one NVIDIA GPU, each built apart from a text edit of
the sources, through K7 f32's three products on it.

    python3 tools/ablate_tf32_core.py --root DIR

DIR: a checkout whose core still has the stagers' split of a K-major B,
which the variants edit (the tree before W's lo always came by TMA: `git
archive df2b5b4` unpacked under build/); its package and sources are the
ones timed.

The variants: the sources as they are; one tensor-core pass a term (hi
hi only: two thirds of the wgmmas removed); no stagers' pass (B's lo and
transposed hi tiles left unwritten); no A fragments (the consumers' loads
and splits of A removed, their registers zero); no fold (the stage's
partial not added to the running sum).  Only the first is right: the
others are timing only.  Each is built with `nvcc -Xptxas -v` from
csrc/fused_mlp_bwd_f32.cu into its own library under
build/ablate_tf32_core/ (registers and spill stores printed), checked
against the package's kernels (the variant "as is" within 1e-4 abs + rel),
and K7 f32's dual GEMM (both operands K-major, W2 copied transposed
first), the two weight grads (A read MN-major in place, B transposed by the
stagers) and dyln (B transposed) are timed by CUDA events at the
window-7 bs-8 stage-1 and stage-3 shapes, in the order A B C ... C B A.
Exits 1 if the variant "as is" fails its check.
"""

import ctypes
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "lavt_rs_tpu_torch", "csrc")
OUT = os.path.join(ROOT, "build", "ablate_tf32_core")
SOURCE = "fused_mlp_bwd_f32.cu"
CORE = "gemm_tf32_sm90.cuh"
FILES = ("common.cuh", "gemm_sm90.cuh", CORE, SOURCE)
# name: edits (file, old, new, count); the first is checked, the rest are
# timing only
VARIANTS = {
    "as is": (),
    "one pass (hi hi)": (
        (CORE, "            wgmma_tf32(part, al[kk], kmajor_desc(bhi, kk), kk != 0);\n"
               "            wgmma_tf32(part, ah[kk], kmajor_desc(blo, kk), 1);\n", "", 1),),
    "no stagers' pass": (
        (CORE, "            stage_b<kTB>(st + kOpBytes, st + R::kBLo, st + R::kBHi, sid);\n",
         "", 1),),
    "no A fragments": (
        (CORE, "          load_a<kTA>(st, 64 * wg, ah, al);\n",
         "          for (int i = 0; i < 16; ++i) ah[i / 4][i % 4] = al[i / 4][i % 4] = 0u;\n",
         1),),
    "no fold": (
        (CORE, "          for (int i = 0; i < 64; ++i) acc[i] += part[i];\n",
         "          for (int i = 0; i < 64; ++i) acc[i] = part[i];\n", 1),),
}


def build(name, edits):
    """The variant's library (argtypes set), after printing its ptxas
    registers and spill stores."""
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
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.lavt_dual_gemm_gelu_bwd_f32.argtypes = [P] * 9 + [I] * 3 + [P]
    lib.lavt_wgrad_f32.argtypes = [P] * 3 + [I] * 5 + [P]
    lib.lavt_dgrad_f32.argtypes = [P] * 3 + [I] * 3 + [P]
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
    global ROOT, CSRC
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ROOT = os.path.abspath(ap.parse_args().root)
    CSRC = os.path.join(ROOT, "lavt_rs_tpu_torch", "csrc")
    import torch

    if not torch.cuda.is_available():
        print("ablate_tf32_core: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from lavt_rs_tpu_torch.ops import cuda_lib
    from lavt_rs_tpu_torch.ops import fused_mlp as fm

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True).stdout.strip())
    cuda_lib.lib()
    libs = {name: build(name, edits) for name, edits in VARIANTS.items()}
    g = torch.Generator(device=dev).manual_seed(0)
    stream = cuda_lib.stream_ptr(dev)
    failed = False
    for label, m, c in (("stage 1", 115200, 128), ("stage 3", 7200, 512)):
        hidden = 4 * c

        def rnd(shape, std=1.0):
            return torch.randn(shape, generator=g, device=dev) * std

        xn, dmlp = rnd((m, c)), rnd((m, c))
        w1, b1 = rnd((hidden, c), c ** -0.5), rnd((hidden,), 0.2)
        w2 = rnd((c, hidden), hidden ** -0.5)
        plan = fm.bwd_plan(m, c, hidden, f32=True)
        want_h, want_dh, want_db1 = fm.dual_gemm_gelu_bwd(xn, dmlp, w1, b1, w2)
        want_dw = fm.wgrad(want_dh, xn, plan.split_rows)
        want_dy = fm.dgrad(want_dh, w1)
        order = list(libs) + list(libs)[::-1]
        times = {name: [] for name in libs}
        for name in order:
            lib = libs[name]
            h, dh = torch.empty_like(want_h), torch.empty_like(want_dh)
            db1, w2t = torch.empty_like(want_db1), torch.empty((hidden, c),
                                                               device=dev)
            dw, dy = torch.empty_like(want_dw), torch.empty_like(want_dy)

            def dual():
                cuda_lib.check(lib.lavt_dual_gemm_gelu_bwd_f32(
                    xn.data_ptr(), dmlp.data_ptr(), w1.data_ptr(),
                    b1.data_ptr(), w2.data_ptr(), h.data_ptr(), dh.data_ptr(),
                    db1.data_ptr(), w2t.data_ptr(), m, c, hidden, stream),
                    name)

            def wgrad():
                cuda_lib.check(lib.lavt_wgrad_f32(
                    want_dh.data_ptr(), xn.data_ptr(), dw.data_ptr(), m,
                    hidden, c, plan.splits, plan.split_tiles, stream), name)

            def dgrad():
                cuda_lib.check(lib.lavt_dgrad_f32(
                    want_dh.data_ptr(), w1.data_ptr(), dy.data_ptr(), m, c,
                    hidden, stream), name)

            dual()
            wgrad()
            dgrad()
            torch.cuda.synchronize()
            worst = max(((a - b).abs() / (1e-4 + 1e-4 * b.abs())).max().item()
                        for a, b in ((h, want_h), (dh, want_dh),
                                     (db1, want_db1), (dw, want_dw),
                                     (dy, want_dy)))
            if name == "as is" and not worst <= 1.0:
                print(f"{name}: disagrees with K7 f32's kernels (worst error "
                      f"/ limit {worst:.3f}) FAILED")
                failed = True
            times[name].append((cuda_ms(dual), cuda_ms(wgrad), cuda_ms(dgrad),
                                worst))
        print(f"{label} (M {m}, C {c}), ms a launch (two runs each), worst "
              f"error / the 1e-4 limit:")
        for name, runs in times.items():
            print(f"  {name}: dual {', '.join(f'{r[0]:.4f}' for r in runs)}; "
                  f"weight grad {', '.join(f'{r[1]:.4f}' for r in runs)}; "
                  f"dyln {', '.join(f'{r[2]:.4f}' for r in runs)}; error "
                  f"{max(r[3] for r in runs):.3g}", flush=True)
        del xn, dmlp, want_h, want_dh, want_dw, want_dy
        torch.cuda.empty_cache()
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
