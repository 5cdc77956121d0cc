#!/usr/bin/env python3
"""Time variants of K2p f32's attention launch (the video stage-1 f32
window attention at n = 392: lavt_rs_tpu_torch/csrc/grouped_msa_f32.cu)
on one NVIDIA GPU, each built apart from a text edit of the source.

    python3 tools/ablate_k2p_f32.py [--source CSRC_DIR] [--iters 20]

--source (default: this tree's csrc) is a checkout's csrc directory.  The
variants: as it is; no products (every wgmma removed); one pass (hi hi
only: two thirds of the wgmmas removed); no exp; no bias or mask reads
(zeros added); no lo split (the producer writes the raw values where it
writes k's and v^T's lo parts); no products, bias or mask reads (both of
those); no prefetch (the producer waits for the next job's copies too
before it builds a job); no copies (the producer issues no cp.async:
stale tiles); no builds (the producer writes no lo parts and no v^T:
stale tiles); rings of two and of four slots; the next item's q copied
after an item's fourth chunk, not its second.  The variants that drop
work (no products, exp, bias or mask reads, lo split, copies, builds)
and one pass are timing only; the others are checked against the f32
plain version (within 1e-4 abs + rel).  Each is built with `nvcc -Xptxas
-v` (the builds started together) into its own library under
build/ablate_k2p_f32/ (registers and spill stores printed), called
through its C entry point at the stage-1 shape of an 8-frame 480² clip
(324 windows of 392 tokens, 3 heads), maskless and grouped (the first
half of the windows maskless), and at K10 f32's video stage-2 shape (81
windows, 6 heads) maskless, timed on the device with its launches queued
behind a device sleep, in the order A B C ... C B A.  Prints each
variant's ms and its max of |got - want| - 1e-4 |want| against the plain
version; exits 1 if a checked build misses 1e-4 abs + rel.
"""

import argparse
import ctypes
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "build", "ablate_k2p_f32")
SOURCE = "grouped_msa_f32.cu"

NO_BIAS = (r"__ldg\(reinterpret_cast<const float2\*>\((bh|mk) \+ o[ab] \+ col\)\)",
           "make_float2(0.f, 0.f)")
VARIANTS = {
    "as is": (),
    "no products": ((r"\bwgmma_n(56|32)_rs\((s|o\[i\]), [^;]*\);", ";"),),
    "one pass": ((r"\bwgmma_n56_rs\(s, qf\[kk\]\.lo[^;]*\);", ";"),
                 (r"\bwgmma_n56_rs\(s, [^;]*kSlotKlo[^;]*\);", ";"),
                 (r"\bwgmma_n32_rs\(o\[i\], a\[j\]\.lo[^;]*\);", ";"),
                 (r"\bwgmma_n32_rs\(o\[i\], [^;]*kSlotVtLo[^;]*\);", ";")),
    "no exp": ((r"\b__expf\(", "("),),
    "no bias or mask reads": (NO_BIAS,),
    "no lo split": ((r"= lo4\(", "= ("),),
    "no products, bias or mask reads": (
        (r"\bwgmma_n(56|32)_rs\((s|o\[i\]), [^;]*\);", ";"), NO_BIAS),
    "no prefetch": ((r"f32mma::cp_wait<1>\(\);  // job jb's copies", "f32mma::cp_wait<0>();  // job jb's copies"),),
    "no copies": ((r"f32mma::cp_async16\((sq|sk) [^;]*\);", ";"),),
    "no builds": ((r"(__device__ __forceinline__ void build_job\([^{]*\{\n)",
                   r"\1  if (pt >= 0) return;\n"),),
    "two ring slots": ((r"kStages = 3;", "kStages = 2;"),),
    "four ring slots": ((r"kStages = 3;", "kStages = 4;"),),
    "next q after the fourth chunk": ((r"kQPos = 2;", "kQPos = 4;"),),
}
# (label, windows, heads, nu: windows below it maskless; None: no mask)
SHAPES = (("stage 1 maskless", 324, 3, None), ("stage 1 grouped", 324, 3, 162),
          ("K10 f32 video stage 2 shape", 81, 6, None))
N = 392
P, I = ctypes.c_void_p, ctypes.c_int
# variants that compute something else: timed, not checked
TIMING_ONLY = re.compile(r"^(no (products|exp|bias|lo|copies|builds)|one pass)")


def build_all(src, variants):
    """Every variant's library (argtypes set), its nvcc runs started
    together, after printing each one's ptxas registers and spill
    stores."""
    sys.path.insert(0, ROOT)
    from lavt_rs_tpu_torch.ops import cuda_lib

    procs = {}
    for tag, edits in variants.items():
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
        so = os.path.join(d, "lib.so")
        procs[tag] = (so, subprocess.Popen(
            [cuda_lib._nvcc(), "-Xptxas=-v", *cuda_lib.NVCC_FLAGS, "-shared",
             "-o", so, path], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    libs = {}
    for tag, (so, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{tag}: nvcc failed\n{err}")
        regs = re.findall(r"Used (\d+) registers", err)
        spills = re.findall(r"(\d+) bytes spill stores", err)
        print(f"{tag}: registers {regs}, spill stores {spills}", flush=True)
        lib = ctypes.CDLL(so)
        lib.lavt_k2p_attn_f32.argtypes = [P] * 4 + [I] * 7 + [P]
        libs[tag] = lib
    return libs


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
    ap.add_argument("--source", default=os.path.join(ROOT, "lavt_rs_tpu_torch",
                                                     "csrc"))
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("ablate_k2p_f32: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from lavt_rs_tpu_torch.ops import window_attn

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    libs = build_all(args.source, VARIANTS)
    g = torch.Generator(device=dev).manual_seed(25)
    ok = True
    for label, nw, heads, nu in SHAPES:
        c = 32 * heads
        qkv = torch.randn((1, nw, N, 3 * c), generator=g, device=dev)
        bias = torch.randn((heads, N, N), generator=g, device=dev)
        mask = full = None
        if nu is not None:
            mask = torch.where(torch.rand((nw - nu, N, N), generator=g,
                                          device=dev) > 0.7, -100.0, 0.0)
            full = torch.cat([mask.new_zeros((nu, N, N)), mask])
        want = window_attn.window_attention_qkv_plain(qkv, bias, full, heads,
                                                      1.0)
        fns, errs = {}, {}
        for name, lib in libs.items():
            o = torch.empty(want.shape, device=dev)

            def fn(lib=lib, o=o, name=name):
                err = lib.lavt_k2p_attn_f32(
                    qkv.data_ptr(), bias.data_ptr(),
                    None if mask is None else mask.data_ptr(), o.data_ptr(),
                    nw, nw, nw if nu is None else nu, heads, N, c,
                    min(nw * heads, sms), torch.cuda.current_stream().cuda_stream)
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
        print(f"{label} ({nw} windows, {heads} heads, n {N}): " + "; ".join(
            f"{name} {sum(t) / 2:.4f} ms (err {errs[name]:.2e})"
            for name, t in times.items()), flush=True)
        del qkv, want, full, mask
        torch.cuda.empty_cache()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader", "-i", "0"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
