#!/usr/bin/env python3
"""Time variants of K10 f32 (lavt_rs_tpu_torch/csrc/window_attn_f32.cu) on
one NVIDIA GPU, each built apart from a text edit of the sources.

    python3 tools/ablate_k10_f32.py [--parent DIR]

The variants: the sources as they are; N > 56 built for three blocks an
SM (ptxas then keeps to 128 registers and spills); one tensor-core pass a
term (hi hi only: two thirds of the mma.sync removed); no products (every
mma.sync removed, with the fragment loads that fed them); no fragment
tiles (the block's split of k and v removed: the tiles hold stale
values); no bias or mask reads (zeros added); no exp (P = s - m).  Only
the first two are right: the others are timing only.  With --parent, the
K10 f32 kernel of another checkout's sources (DIR/lavt_rs_tpu_torch/csrc,
its launch plan copied here) is timed beside them.  Each is built with
`nvcc -Xptxas -v` into its own library under build/ablate_k10_f32/
(registers and spill stores printed), called through its C entry point at
the video stage-2 shape of an 8-frame 480² clip (N = 392: 81 windows, 6
heads) and window 7's stage 1 at bs 8 (N = 49: 2592 windows, 4 heads),
unshifted and under a random mask, and timed on the device with its
launches queued behind a device sleep, in the order A B C ... C B A.
Prints each variant's ms and its max of |got - want| - 1e-4 |want|
against K10's plain version; exits 1 if a checked variant misses 1e-4
abs + rel.
"""

import argparse
import ctypes
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "lavt_rs_tpu_torch", "csrc")
OUT = os.path.join(ROOT, "build", "ablate_k10_f32")
SOURCE = "window_attn_f32.cu"
QK = "  for (int j = 0; j < NJ; ++j) mma_tf32(s[J0 + j], a.{}, b[j].{});\n"
PV = "      for (int cc = 0; cc < 4; ++cc) mma_tf32(pv[cc], a.{}, b[cc].{});\n"
ONE_PASS = tuple((f.format(x, y), "") for f in (QK, PV)
                 for x, y in (("lo", "hi"), ("hi", "lo")))
# name: (edits (old, new) of SOURCE, blocks an SM above N = 56, checked)
VARIANTS = {
    "as is": ((), 2, True),
    "N > 56 at three blocks an SM": (
        (("kSmall ? 3 : 2", "kSmall ? 3 : 3"),), 3, True),
    "one pass (timing only)": (ONE_PASS, 2, False),
    "no products (timing only)": (
        ONE_PASS + tuple((f.format("hi", "hi"), "") for f in (QK, PV)), 2,
        False),
    "no fragment tiles (timing only)": (
        (("    build_frags(kf, nullptr, rk, kChunk, 1.f, S::kThreads);\n"
          "    build_frags(nullptr, vf, rv, kChunk, 1.f, S::kThreads);\n",
          ""),), 2, False),
    "no bias or mask reads (timing only)": (
        (("        load_pair(bv[j], bh + offa, bh + offb, key0 + 8 * j + 2 * t, n);\n",
          "        bv[j][0] = bv[j][1] = bv[j][2] = bv[j][3] = 0.f;\n"),
         ("      if (mk != nullptr) load_pair(mv[j], mk + offa, mk + offb, "
          "key0 + 8 * j + 2 * t, n);\n",
          "      mv[j][0] = mv[j][1] = mv[j][2] = mv[j][3] = 0.f;\n")), 2, False),
    "no exp (timing only)": (
        (("        s[j][e] = expf(s[j][e] - mxa);\n"
          "        s[j][2 + e] = expf(s[j][2 + e] - mxb);\n",
          "        s[j][e] = s[j][e] - mxa;\n"
          "        s[j][2 + e] = s[j][2 + e] - mxb;\n"),), 2, False),
}
# (B nW, nW, heads, N)
SHAPES = ((81, 81, 6, 392), (2592, 324, 4, 49))


def build(name, src, edits):
    """The variant's library (argtypes set), after printing its ptxas
    registers and spill stores."""
    from lavt_rs_tpu_torch.ops import cuda_lib

    d = os.path.join(OUT, re.sub(r"\W+", "_", name))
    os.makedirs(d, exist_ok=True)
    for f in os.listdir(src):
        shutil.copy(os.path.join(src, f), d)
    path = os.path.join(d, SOURCE)
    text = open(path).read()
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"{name}: {SOURCE} has changed ({old!r})")
        text = text.replace(old, new)
    with open(path, "w") as out:
        out.write(text)
    so = os.path.join(d, "lib.so")
    r = subprocess.run([cuda_lib._nvcc(), "-Xptxas=-v", *cuda_lib.NVCC_FLAGS,
                        "-shared", "-o", so, path], capture_output=True,
                       text=True)
    if r.returncode:
        raise SystemExit(f"{name}: nvcc failed\n{r.stderr}")
    regs = re.findall(r"Used (\d+) registers", r.stderr)
    spills = re.findall(r"(\d+) bytes spill stores", r.stderr)
    print(f"{name}: registers {regs}, spill stores {spills}", flush=True)
    lib = ctypes.CDLL(so)
    lib.lavt_window_attn_f32.argtypes = cuda_lib.SIGNATURES[
        "lavt_window_attn_f32"]
    return lib


def per_block(per_sm, bw, heads, n, sms):
    """The launch's `per_block`: this tree's plan at `per_sm` blocks an SM
    above N = 56, or (per_sm None) the first FFMA design's (64-row items,
    one a block above N = 64)."""
    if per_sm is None:
        tiles = -(-n // 64)
        items = bw * heads * tiles
        return 1 if tiles > 1 else max(1, min(4, items // (16 * sms)))
    rows, slots = (64, 3) if n <= 56 else (80, per_sm)
    items = bw * heads * -(-n // rows)
    return -(-items // (slots * sms))


def queued_ms(fn, iters=20):
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
    ap.add_argument("--parent", default=None)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("ablate_k10_f32: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from lavt_rs_tpu_torch.ops import window_attn as wa

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    variants = {k: (CSRC, e, p, c) for k, (e, p, c) in VARIANTS.items()}
    if args.parent:
        variants["parent"] = (os.path.join(args.parent, "lavt_rs_tpu_torch",
                                           "csrc"), (), None, True)
    libs = {k: build(k, src, e) for k, (src, e, _, _) in variants.items()}
    g = torch.Generator(device=dev).manual_seed(10)
    sc = 32 ** -0.5
    ok = True
    for bw, nw, heads, n in SHAPES:
        qkv = torch.randn((bw // nw, nw, n, 3 * heads * 32), generator=g,
                          device=dev)
        q, k, v = wa.qkv_heads(qkv, heads)
        bias = torch.randn((heads, n, n), generator=g, device=dev)
        rand_mask = torch.where(torch.randn((nw, n, n), generator=g,
                                            device=dev) > 1.0, -100.0, 0.0)
        for mask in (None, rand_mask):
            want = wa.window_attention_plain(q, k, v, bias, mask, sc)
            fns, errs = {}, {}
            for name, lib in libs.items():
                pb = per_block(variants[name][2], bw, heads, n, sms)
                o = torch.empty(q.shape, device=dev)

                def fn(lib=lib, pb=pb, o=o, mask=mask):
                    err = lib.lavt_window_attn_f32(
                        q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        bias.data_ptr(),
                        None if mask is None else mask.data_ptr(),
                        o.data_ptr(), None, *q.stride()[1:4],
                        *o.stride()[1:4], bw, nw, nw if mask is None else 0,
                        heads, n, pb, sc, torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"lavt_window_attn_f32: {err}")
                    return o

                got = fn()
                torch.cuda.synchronize()
                errs[name] = ((got - want).abs()
                              - 1e-4 * want.abs()).max().item()
                if variants[name][3] and not errs[name] <= 1e-4:
                    ok = False
                fns[name] = fn
            times = {name: [] for name in fns}
            for name in list(fns) + list(fns)[::-1]:
                times[name].append(queued_ms(fns[name]))
            print(f"N {n} ({bw} windows, {heads} heads), mask "
                  f"{mask is not None}: " + "; ".join(
                      f"{name} {sum(t) / 2:.4f} ms (err {errs[name]:.2e})"
                      for name, t in times.items()), flush=True)
        del qkv, q, k, v, bias, rand_mask
        torch.cuda.empty_cache()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader", "-i", "0"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
