#!/usr/bin/env python3
"""What bounds the first K5 and K9 kernels: their launches timed one by one,
and throwaway builds with one part switched off, on one NVIDIA GPU.

    python3 tools/ablate_k5_k9.py --source OLD/lavt_rs_tpu_torch/csrc [--iters 10]

--source is the `csrc/` of a checkout that still has the first designs
(`msa_bwd_attn_kernel` and the WMMA GEMM `lavt_gemm_bf16` in
`fused_msa_bwd.cu`; `attn_bwd_q_kernel` / `attn_bwd_kv_kernel` in
`window_attn.cu`).  Both sources (with that checkout's `common.cuh`) are
compiled by nvcc into one library per variant, each variant an edit:
  full       the kernels as they were;
  no-p       K5's attention kernel reads no P (zeros in its place: the
             WMMA loads of o = P v and dv = P^T do, and the dS pass);
  no-dbias   K5's attention kernel adds nothing to its shared dbias tile;
  no-rmw     K9's q launch writes nothing to its dbias slices (no
             read-modify-write through L2).
K5 runs at each window-12 stage's bs-8 shape of lavt_one Swin-B 480²
(B nW = 800 / 200 / 72 / 32 windows of 144, C = 128 / 256 / 512 / 1024):
each launch of the full variant apart (dattn GEMM, attention, dx GEMM,
dWqkv and dWproj GEMMs with their split partials, colsum, sum_partials)
under torch.profiler, then the attention launch of every variant with
CUDA events.  K9 runs at video stages 1-4 (8-frame 480² clip, N = 392),
unshifted and shifted, and at window 7 (bs 8, N = 49): each kernel's
device ms under torch.profiler (the q launch, the kv launch, the dbias
sum), and the whole call of `full` and `no-rmw` with CUDA events.  The
inputs are seeded random values; the variants' outputs are not checked:
all but `full` compute something else by design.
"""

import argparse
import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# variant -> (file, old text, new text) edits; every old text occurs once
EDITS = {
    "full": [],
    "no-p": [
        ("fused_msa_bwd.cu", "wmma::load_matrix_sync(a, pw + r * 16 * bN + kk, bN);",
         "wmma::fill_fragment(a, __float2bfloat16(0.f));"),
        ("fused_msa_bwd.cu", "wmma::load_matrix_sync(a, pw + kk * bN + r * 16, bN);",
         "wmma::fill_fragment(a, __float2bfloat16(0.f));"),
        ("fused_msa_bwd.cu", "pv[t] = j < bN ? to_f(pw[r * bN + j]) : 0.f;",
         "pv[t] = 0.f;")],
    "no-dbias": [("fused_msa_bwd.cu", "dba[r * bN + j] += ds;", "(void)0;")],
    "no-rmw": [
        ("window_attn.cu",
         "if (ra < n) acc_pair(part + oa_off, c, n, s[t][0], s[t][1], first);",
         "(void)first;"),
        ("window_attn.cu",
         "if (rb < n) acc_pair(part + ob_off, c, n, s[t][2], s[t][3], first);",
         "(void)0;")],
}
P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
SIGS = {
    "lavt_msa_bwd_attn": (P,) * 9 + (I, I, I, I, F, P),
    "lavt_gemm_bf16": (P,) * 5 + (I,) * 9 + (P,),
    "lavt_sum_partials": (P, P, I, L, P),
    "lavt_colsum_bf16": (P, P, I, I, I, P),
    "lavt_window_attn_bwd": (P,) * 13 + (I,) * 7 + (F, P),
}
TARGET_BLOCKS = 264  # the first designs' aim (132 SMs, two blocks each)
# lavt_one Swin-B 480² at window 12, bs 8: (B nW, C)
K5_STAGES = ((800, 128), (200, 256), (72, 512), (32, 1024))
# (label, B, nW, heads, N, image side padded to the window, window)
K9_CASES = (("video stage 1", 1, 324, 3, 392, 126, 7),
            ("video stage 2", 1, 81, 6, 392, 63, 7),
            ("video stage 3", 1, 25, 12, 392, 35, 7),
            ("video stage 4", 1, 9, 24, 392, 21, 7),
            ("window-7 stage 1", 8, 324, 4, 49, 126, 7),
            ("window-7 stage 2", 8, 81, 8, 49, 63, 7),
            ("window-7 stage 3", 8, 25, 16, 49, 35, 7),
            ("window-7 stage 4", 8, 9, 32, 49, 21, 7))


def build(source: Path, out: Path):
    """One shared library per variant (both sources), nvcc in parallel."""
    sys.path.insert(0, str(ROOT))
    from lavt_rs_tpu_torch.ops import cuda_lib

    nvcc = cuda_lib._nvcc()
    procs = {}
    for name, edits in EDITS.items():
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        shutil.copy(source / "common.cuh", d / "common.cuh")
        for fname in ("fused_msa_bwd.cu", "window_attn.cu"):
            src = (source / fname).read_text()
            for f, old, new in edits:
                if f != fname:
                    continue
                if src.count(old) != 1:
                    raise SystemExit(f"{name}: the edit's text is not in "
                                     f"{fname} once: {old!r}")
                src = src.replace(old, new)
            (d / fname).write_text(src)
        cmd = [nvcc, *cuda_lib.NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"),
               str(d / "fused_msa_bwd.cu"), str(d / "window_attn.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True)
    libs = {}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{err}")
        lib = ctypes.CDLL(str(out / name / "lib.so"))
        for fn, args in SIGS.items():
            getattr(lib, fn).argtypes = list(args)
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def check(err, what):
    if err:
        raise RuntimeError(f"{what}: CUDA error {err}")


def main() -> int:
    ap = argparse.ArgumentParser("ablate the first K5 and K9 kernels")
    ap.add_argument("--source", required=True, type=Path,
                    help="csrc/ of a checkout with the first K5 and K9")
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("ablate_k5_k9: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from lavt_rs_tpu_torch.ops import cuda_lib
    from lavt_rs_tpu_torch.ops.window import shift_mask_2d, shift_mask_3d

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    libs = build(args.source.resolve(), ROOT / "build" / "ablate_k5_k9")
    dev = torch.device("cuda:0")
    stream = cuda_lib.stream_ptr(dev)
    g = torch.Generator(device=dev).manual_seed(0)

    def rnd(shape, std=1.0):
        return (torch.randn(shape, generator=g, device=dev) * std).bfloat16()

    def events_ms(fn):
        for _ in range(2):
            fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / args.iters

    def by_kernel(fn):
        """{kernel name: device ms per call} over iters calls."""
        fn()
        torch.cuda.synchronize()
        for _ in range(3):  # a session can come back without device records
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(args.iters):
                    fn()
                torch.cuda.synchronize()
            out = {}
            for e in prof.key_averages():
                if e.device_type != torch.autograd.DeviceType.CUDA:
                    continue
                us = getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0))
                if us > 0:
                    key = e.key.split("(")[0].replace("void ", "")
                    out[key] = out.get(key, 0.0) + us / 1e3 / args.iters
            if out:
                return out
        return {}

    def fmt(d):
        return "; ".join(f"{k[:48]} {v:.4f}" for k, v in
                         sorted(d.items(), key=lambda kv: -kv[1]))

    # -- K5 -----------------------------------------------------------------
    bf16 = torch.bfloat16
    for si, (m, c) in enumerate(K5_STAGES):
        heads, n = c // 32, 144
        rows = m * n
        x, gy = rnd((rows, c)), rnd((rows, c))
        q, k, v = (rnd((m, n, c)) for _ in range(3))
        p = torch.softmax(torch.randn((m, heads, n, n), generator=g,
                                      device=dev), -1).to(bf16)
        wqkv, wproj = rnd((3 * c, c), c ** -0.5), rnd((c, c), c ** -0.5)
        groups = min(m, -(-TARGET_BLOCKS // heads))
        dattn = torch.empty((rows, c), dtype=bf16, device=dev)
        o = torch.empty((rows, c), dtype=bf16, device=dev)
        dqkv = torch.empty((rows, 3 * c), dtype=bf16, device=dev)
        dx = torch.empty((rows, c), dtype=bf16, device=dev)
        dbias_part = torch.empty((groups, heads, n, n), dtype=torch.float32,
                                 device=dev)
        dbqkv_part = torch.empty((groups, 3 * c), dtype=torch.float32,
                                 device=dev)
        dbias = torch.empty((heads, n, n), dtype=torch.float32, device=dev)

        def wsplit(mm, nn, kk):
            tiles = -(-mm // 64) * -(-nn // 64)
            splits = max(1, min(-(-TARGET_BLOCKS // tiles), kk // 512))
            per_split = -(-kk // splits)
            chunk = -(-per_split // 32) * 32
            return -(-kk // chunk), chunk

        sq, cq = wsplit(3 * c, c, rows)
        sp, cp = wsplit(c, c, rows)
        dwq = torch.empty((sq, 3 * c, c), dtype=torch.float32, device=dev)
        dwp = torch.empty((sp, c, c), dtype=torch.float32, device=dev)
        cs = max(1, min(TARGET_BLOCKS, rows // 256))
        cpart = torch.empty((cs, c), dtype=torch.float32, device=dev)
        outs = [torch.empty(t.shape[1:], dtype=torch.float32, device=dev)
                for t in (dwq, dwp, cpart, dbqkv_part)]

        def launches(lib):
            return {
                "dattn GEMM": lambda: check(lib.lavt_gemm_bf16(
                    gy.data_ptr(), wproj.data_ptr(), None, None,
                    dattn.data_ptr(), rows, c, c, c, c, 0, 0, 1, c, stream),
                    "dattn"),
                "attention": lambda: check(lib.lavt_msa_bwd_attn(
                    dattn.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    p.data_ptr(), o.data_ptr(), dqkv.data_ptr(),
                    dbias_part.data_ptr(), dbqkv_part.data_ptr(), m, c, heads,
                    groups, 32 ** -0.5, stream), "attention"),
                "dx GEMM": lambda: check(lib.lavt_gemm_bf16(
                    dqkv.data_ptr(), wqkv.data_ptr(), None, None, dx.data_ptr(),
                    rows, c, 3 * c, 3 * c, c, 0, 0, 1, 3 * c, stream), "dx"),
                "dWqkv GEMM": lambda: check(lib.lavt_gemm_bf16(
                    dqkv.data_ptr(), x.data_ptr(), None, dwq.data_ptr(), None,
                    3 * c, c, rows, 3 * c, c, 1, 0, sq, cq, stream), "dWqkv"),
                "dWproj GEMM": lambda: check(lib.lavt_gemm_bf16(
                    gy.data_ptr(), o.data_ptr(), None, dwp.data_ptr(), None,
                    c, c, rows, c, c, 1, 0, sp, cp, stream), "dWproj"),
                "colsum": lambda: check(lib.lavt_colsum_bf16(
                    gy.data_ptr(), cpart.data_ptr(), rows, c, cs, stream),
                    "colsum"),
                "sum_partials": lambda: [check(lib.lavt_sum_partials(
                    t.data_ptr(), out.data_ptr(), t.shape[0], out.numel(),
                    stream), "sum") for t, out in
                    ((dwq, outs[0]), (dwp, outs[1]), (cpart, outs[2]),
                     (dbqkv_part, outs[3]), (dbias_part, dbias))],
            }

        full = launches(libs["full"])
        parts = {name: sum(by_kernel(fn).values()) for name, fn in full.items()}
        total = sum(parts.values())
        print(f"K5 stage {si + 1} (B nW {m}, C {c}, heads {heads}), device ms "
              f"per call by launch (torch.profiler): " + "; ".join(
                  f"{k} {v:.4f}" for k, v in parts.items())
              + f"; sum {total:.4f}", flush=True)
        print(f"  whole call (CUDA events) "
              f"{events_ms(lambda: [f() for f in full.values()]):.4f} ms; "
              "attention launch by variant (CUDA events): " + "; ".join(
                  f"{name} {events_ms(launches(lib)['attention']):.4f}"
                  for name, lib in libs.items() if name != "no-rmw"),
              flush=True)
        del x, gy, q, k, v, p, dattn, o, dqkv, dx, dbias_part, dwq, dwp
        torch.cuda.empty_cache()

    # -- K9 -----------------------------------------------------------------
    for label, b, nw, heads, n, side, ws in K9_CASES:
        bw = b * nw
        shape = (bw, heads, n, 32)
        q, k, v, o, do = (rnd(shape) for _ in range(5))
        lse = torch.full((bw, heads, n), 8.0, dtype=torch.float32, device=dev)
        bias = torch.randn((heads, n, n), generator=g, device=dev)
        dq, dk, dv = (torch.empty(shape, dtype=bf16, device=dev)
                      for _ in range(3))
        dsum = torch.empty_like(lse)
        groups = max(1, min(bw, 32 * 2 ** 20 // (heads * n * n * 4)))
        part = torch.empty((groups, heads, n, n), dtype=torch.float32,
                           device=dev)
        dbias = torch.empty((heads, n, n), dtype=torch.float32, device=dev)
        tiles = -(-n // 16)

        def splits(blocks):
            return max(1, min(-(-tiles // 8), -(-TARGET_BLOCKS // blocks)))

        for shifted in (False, True):
            mask = None
            if shifted:
                mask = (shift_mask_3d(8, side, side, (8, 7, 7), (0, 3, 3), dev)
                        if n == 392 else shift_mask_2d(side, side, 7, 3, dev))
                masked = int((mask != 0).flatten(1).any(1).sum())
            mp = None if mask is None else mask.data_ptr()

            def call(lib, mp=mp):
                check(lib.lavt_window_attn_bwd(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    do.data_ptr(), lse.data_ptr(), bias.data_ptr(), mp,
                    dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                    dsum.data_ptr(), part.data_ptr(), bw, nw, heads, n, groups,
                    splits(heads * groups), splits(bw * heads), 32 ** -0.5,
                    stream), "K9")
                check(libs["full"].lavt_sum_partials(
                    part.data_ptr(), dbias.data_ptr(), groups, dbias.numel(),
                    stream), "sum")

            kern = by_kernel(lambda: call(libs["full"]))
            kv = sum(t for name, t in kern.items() if "kv_kernel" in name)
            tot = sum(kern.values())
            norm = by_kernel(lambda: call(libs["no-rmw"]))
            print(f"K9 {label} (B nW {bw}, heads {heads}, N {n}, mask "
                  f"{shifted}{f', {masked} windows masked' if shifted else ''}"
                  f"), device ms per call (torch.profiler): {fmt(kern)}; sum "
                  f"{tot:.4f}, kv launch share {kv / tot:.3f}; no-rmw: "
                  f"{fmt(norm)}", flush=True)
            print(f"  whole call (CUDA events): full "
                  f"{events_ms(lambda: call(libs['full'])):.4f}, no-rmw "
                  f"{events_ms(lambda: call(libs['no-rmw'])):.4f} ms",
                  flush=True)
        del q, k, v, o, do, part
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
