#!/usr/bin/env python3
"""Time variants of the f32 window-MSA attention (the attention launch of
K1 f32, K11 f32, K2 f32 and the save mode f32:
lavt_rs_tpu_torch/csrc/fused_msa_f32.cu) on one NVIDIA GPU, each built
apart from a text edit of the sources.

    python3 tools/ablate_msa_f32.py [--source CSRC_DIR ...] [--iters 20]

Each --source (default: this tree's csrc) is a checkout's csrc directory;
its design is told by its text: "persistent" blocks of three warpgroups
over (head, run of windows), q, k and v staged by cp.async, the products
on wgmma (this tree's), or the design before, one block per (window,
head), mma.sync on fragment tiles built from 4-byte loads.  The variants of each: as it is; no bias or mask reads
(zeros added); no products (every wgmma or mma.sync removed); one pass (hi hi
only: two thirds of the wgmmas or mma.syncs removed); no q, k, v loads
(the tiles keep stale values, or constants); no exp; this tree's also
without the pass that writes k's lo and v^T (stale tiles), with the
rounded `expf` for its `__expf` (ex2.approx), and with O = P V's waits
every 2 or 6 key steps instead of 3.  The "no" variants and "one pass"
are timing only; the others are checked.  Each is built with `nvcc -Xptxas -v` into its
own library under build/ablate_msa_f32/ (registers and spill stores
printed), called through its C entry points at Swin-B 480² bs-8 stage 1
(800 windows, C = 128, 4 heads) and stage 3 (72 windows of a 36 x 36 map,
C = 512, 16 heads), each in window order (lavt_msa_fwd_f32) and map order
(lavt_msa_fwd_map_f32), unshifted and under the shift mask with its
window flags, the clamp softmax (inference), and timed on the device with
its launches queued behind a device sleep, in the order A B C ... C B A.
Prints each variant's ms and its max of |got - want| - 1e-4 |want|
against the plain version; exits 1 if a checked build misses 1e-4 abs +
rel.
"""

import argparse
import ctypes
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "build", "ablate_msa_f32")
SOURCE = "fused_msa_f32.cu"

PRODUCTS = (r"mma_tf32\([^;]*\);", ";")
LO_PASSES = (r"mma_tf32\([^;]*\.lo\b[^;]*\);", ";")
NO_EXP = (r"\bexpf\(", "(")
# design: (marker in SOURCE, {variant: regex edits (pattern, replacement)})
DESIGNS = {
    "persistent": ("persistent", {
        "as is": (),
        "no bias or mask reads": (
            (r"stage_bias\(p, s0 \+ kOffBias, h\);", ""),
            (r"const float4 bw = bias_s\[[^;]*;",
             "const float4 bw = make_float4(0.f, 0.f, 0.f, 0.f);"),
            (r"__ldg\(reinterpret_cast<const float2\*>\(ma \+ [^;]*\)\)",
             "make_float2(0.f, 0.f)")),
        "no products": ((r"\bwgmma_n(144|32)\((s|o), [^;]*\);", ";"),),
        "one pass": ((r"\bwgmma_n(144|32)\((s|o), [^;]*(\.lo\b|klo|VtLo)[^;]*\);", ";"),),
        "no q, k, v loads": ((r"stage_item<kMap>\([^;]*\);", ""),),
        "no exp": ((r"\b__expf\(", "("),),
        "no B builds": ((r"build_b\(smem, kb\);", ""),),
        "expf": ((r"\b__expf\(", "expf("),),
        "P V waits every 2 steps": ((r"kPvBatch = 3;", "kPvBatch = 2;"),),
        "P V waits every 6 steps": ((r"kPvBatch = 3;", "kPvBatch = 6;"),),
    }),
    "before": ("blockIdx.x, h = blockIdx.y", {
        "as is": (),
        "no bias or mask reads": (
            (r"__ldg\(reinterpret_cast<const float2\*>\([bm][ab] \+ 8 \* j\)\)",
             "make_float2(0.f, 0.f)"),),
        "no products": (PRODUCTS,),
        "one pass": (LO_PASSES,),
        "no q, k, v loads": (
            (r"__ldg\((kr|kr \+ 4|v0|v1|q[ab] \+ 8 \* kk|q[ab] \+ 8 \* kk \+ 4)\)",
             "0.5f"),),
        "no exp": (NO_EXP,),
    }),
}
# (label, C, heads, map (B, Hp, Wp) or window order (B nW, nW))
SHAPES = (("stage 1, window order", 128, 4, None, (800, 100)),
          ("stage 1, map order", 128, 4, (8, 120, 120), None),
          ("stage 3, map order", 512, 16, (8, 36, 36), None),
          ("stage 3, window order", 512, 16, None, (72, 9)))
P, I = ctypes.c_void_p, ctypes.c_int
# variants that compute something else: timed, not checked
TIMING_ONLY = re.compile(r": (no |one pass)")


def build(tag, src, edits):
    """The variant's library (argtypes set), after printing its ptxas
    registers and spill stores."""
    d = os.path.join(OUT, re.sub(r"\W+", "_", tag))
    os.makedirs(d, exist_ok=True)
    for f in os.listdir(src):
        shutil.copy(os.path.join(src, f), d)
    path = os.path.join(d, SOURCE)
    text = open(path).read()
    for pat, new in edits:
        text, n = re.subn(pat, new, text)
        if n == 0:
            raise SystemExit(f"{tag}: {SOURCE} has changed ({pat!r})")
    with open(path, "w") as out:
        out.write(text)
    sys.path.insert(0, ROOT)
    from lavt_rs_tpu_torch.ops import cuda_lib

    so = os.path.join(d, "lib.so")
    r = subprocess.run([cuda_lib._nvcc(), "-Xptxas=-v", *cuda_lib.NVCC_FLAGS,
                        "-shared", "-o", so, path], capture_output=True,
                       text=True)
    if r.returncode:
        raise SystemExit(f"{tag}: nvcc failed\n{r.stderr}")
    regs = re.findall(r"Used (\d+) registers", r.stderr)
    spills = re.findall(r"(\d+) bytes spill stores", r.stderr)
    print(f"{tag}: registers {regs}, spill stores {spills}", flush=True)
    lib = ctypes.CDLL(so)
    lib.lavt_msa_fwd_f32.argtypes = [P] * 6 + [I] * 5 + [P]
    lib.lavt_msa_fwd_map_f32.argtypes = [P] * 5 + [I] * 6 + [P]
    return lib


def queued_ms(fn, iters):
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", action="append", default=None)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("ablate_msa_f32: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from lavt_rs_tpu_torch.ops import fused_msa, fused_msa_2d
    from lavt_rs_tpu_torch.ops.window import (shift_mask_2d,
                                              shift_mask_flags_2d)

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    sources = args.source or [os.path.join(ROOT, "lavt_rs_tpu_torch", "csrc")]
    libs = {}
    for i, src in enumerate(sources):
        text = open(os.path.join(src, SOURCE)).read()
        design = next(k for k, (mark, _) in DESIGNS.items() if mark in text)
        for name, edits in DESIGNS[design][1].items():
            libs[f"{i}:{design}: {name}"] = build(f"{i}_{design}_{name}", src,
                                                  edits)
    g = torch.Generator(device=dev).manual_seed(24)
    ok = True
    for label, c, heads, mp, wo in SHAPES:
        side = mp[1] if mp else int(round((wo[1]) ** 0.5)) * 12
        nw = (side // 12) ** 2
        shape = (*mp, 3 * c) if mp else (wo[0], 144, 3 * c)
        qkv = torch.randn(shape, generator=g, device=dev)
        bias = torch.randn((heads, 144, 144), generator=g, device=dev)
        for shift in (False, True):
            mask = shift_mask_2d(side, side, 12, 6, dev) if shift else None
            flags = shift_mask_flags_2d(side, side, 12, 6, dev) if shift else None
            if mp:
                want = fused_msa_2d.msa_attn_map_plain(qkv, bias, mask, heads,
                                                       exact=False)
            else:
                want = fused_msa.msa_attn_plain(qkv, bias, mask, heads,
                                                exact=False)[0]
            fns, errs = {}, {}
            for name, lib in libs.items():
                o = torch.empty(want.shape, device=dev)
                ptrs = (qkv.data_ptr(), bias.data_ptr(),
                        None if mask is None else mask.data_ptr(),
                        None if flags is None else flags.data_ptr(),
                        o.data_ptr())

                def fn(lib=lib, ptrs=ptrs, o=o):
                    s = torch.cuda.current_stream().cuda_stream
                    if mp:
                        err = lib.lavt_msa_fwd_map_f32(*ptrs, *mp, c, heads, 0,
                                                       s)
                    else:
                        err = lib.lavt_msa_fwd_f32(*ptrs, None, wo[0], nw, c,
                                                   heads, 0, s)
                    if err:
                        raise RuntimeError(f"{name}: CUDA error {err}")
                    return o

                got = fn()
                torch.cuda.synchronize()
                errs[name] = ((got - want).abs() - 1e-4 * want.abs()).max().item()
                if not TIMING_ONLY.search(name) and not errs[name] <= 1e-4:
                    ok = False
                fns[name] = fn
            times = {name: [] for name in fns}
            for name in list(fns) + list(fns)[::-1]:
                times[name].append(queued_ms(fns[name], args.iters))
            print(f"{label} ({c}, {heads} heads), mask {shift}: " + "; ".join(
                f"{name} {sum(t) / 2:.4f} ms (err {errs[name]:.2e})"
                for name, t in times.items()), flush=True)
        del qkv, want
        torch.cuda.empty_cache()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader", "-i", "0"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
