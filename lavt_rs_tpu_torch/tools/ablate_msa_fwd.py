"""What bounds the first K1/K2 forward and its save mode: their launches
timed one by one, a throwaway build with the qkv projection switched off,
and the GEMM core on the same products, on one NVIDIA GPU.

    python -m lavt_rs_tpu_torch.tools.ablate_msa_fwd --source OLD/lavt_rs_tpu_torch/csrc \\
        [--iters 10]

--source is the `csrc/` of a checkout that still has the first design:
`window_msa_attn_kernel` in `fused_msa.cu` with its save mode (the five
save pointers of `lavt_window_msa_attn`), the WMMA GEMM `lavt_gemm_bf16`
in `fused_msa_bwd.cu`, and the GEMM core's `lavt_gemm_bias_bf16` in
`window_msa_sm90.cu` (e.g. `git archive 128380d` unpacked under `build/`).
The three sources (with that checkout's headers) are compiled by nvcc into
one library per variant, each variant an edit:
  full     the kernels as they were;
  no-qkv   the attention kernel skips its qkv projection (the loop that
           streams the window's x through shared memory and forms the
           head's q, k, v with WMMA): q, k, v are the bias alone.
At each window-12 stage's bs-8 shape of lavt_one Swin-B 480² (B nW = 800 /
200 / 72 / 32 windows of 144 tokens, C = 128 / 256 / 512 / 1024; LN on at
stages 1-2, as K1 runs there), unshifted and shifted (the shift mask of
the padded map), each launch's device ms under torch.profiler: the
attention launch with the saves on and off, the WMMA out-projection, and
`lavt_gemm_bias_bf16` on the qkv shape (rows, 3C, C) and the
out-projection shape (rows, C, C); then the attention launch of each
variant with CUDA events.  Inputs are seeded random values; the variants'
outputs are not checked: `no-qkv` computes something else by design.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

SOURCES = ("fused_msa.cu", "fused_msa_bwd.cu", "window_msa_sm90.cu")
HEADERS = ("common.cuh", "gemm_sm90.cuh")
# variant -> (file, old text, new text) edits; every old text occurs once
EDITS = {
    "full": [],
    "no-qkv": [("fused_msa.cu", "for (int k0 = 0; k0 < C; k0 += kKC) {",
                "for (int k0 = 0; k0 < 0; k0 += kKC) {")],
}
P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGS = {
    "lavt_window_msa_attn": (P,) * 13 + (I, I, I, I, F, F, P),
    "lavt_gemm_bf16": (P,) * 4 + (I,) * 7 + (P,),
    "lavt_gemm_bias_bf16": (P,) * 4 + (I,) * 4 + (F, P),
}
# lavt_one Swin-B 480² at window 12, bs 8: (B nW, nW, padded map side, C)
STAGES = ((800, 100, 120, 128), (200, 25, 60, 256), (72, 9, 36, 512),
          (32, 4, 24, 1024))


def build(source: Path, out: Path):
    """One shared library per variant, nvcc in parallel (one per source)."""
    from lavt_rs_tpu_torch.ops import cuda_lib

    nvcc = cuda_lib._nvcc()
    procs = {}
    for name, edits in EDITS.items():
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        for h in HEADERS:
            shutil.copy(source / h, d / h)
        for fname in SOURCES:
            src = (source / fname).read_text()
            for f, old, new in edits:
                if f != fname:
                    continue
                if src.count(old) != 1:
                    raise SystemExit(f"{name}: the edit's text is not in "
                                     f"{fname} once: {old!r}")
                src = src.replace(old, new)
            (d / fname).write_text(src)
            cmd = [nvcc, *cuda_lib.NVCC_FLAGS, "-c", "-o",
                   str(d / f"{Path(fname).stem}.o"), str(d / fname)]
            procs[(name, fname)] = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    for key, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {key}:\n{err}")
    libs = {}
    for name in EDITS:
        d = out / name
        subprocess.run([nvcc, *cuda_lib.NVCC_FLAGS, "-shared", "-o",
                        str(d / "lib.so"),
                        *(str(d / f"{Path(f).stem}.o") for f in SOURCES)],
                       check=True)
        lib = ctypes.CDLL(str(d / "lib.so"))
        for fn, args in SIGS.items():
            getattr(lib, fn).argtypes = list(args)
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def check(err, what):
    if err:
        raise RuntimeError(f"{what}: CUDA error {err}")


def main() -> int:
    ap = argparse.ArgumentParser("ablate the first K1/K2 forward")
    ap.add_argument("--source", required=True, type=Path,
                    help="csrc/ of a checkout with the first K1/K2 design")
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("ablate_msa_fwd: CUDA is not available", file=sys.stderr)
        return 1
    from lavt_rs_tpu_torch.ops import cuda_lib
    from lavt_rs_tpu_torch.ops.window import shift_mask_2d

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    root = Path(cuda_lib.__file__).resolve().parents[2]
    libs = build(args.source.resolve(), root / "build" / "ablate_msa_fwd")
    dev = torch.device("cuda:0")
    stream = cuda_lib.stream_ptr(dev)
    g = torch.Generator(device=dev).manual_seed(0)
    bf16 = torch.bfloat16

    def rnd(shape, std=1.0):
        return (torch.randn(shape, generator=g, device=dev) * std).to(bf16)

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

    def device_ms(fn):
        """Device ms per call of fn's kernels (torch.profiler)."""
        fn()
        torch.cuda.synchronize()
        for _ in range(3):  # a session can come back without device records
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(args.iters):
                    fn()
                torch.cuda.synchronize()
            total = 0.0
            for e in prof.key_averages():
                if e.device_type != torch.autograd.DeviceType.CUDA:
                    continue
                total += getattr(e, "self_device_time_total",
                                 getattr(e, "self_cuda_time_total", 0))
            if total > 0:
                return total / 1e3 / args.iters
        return float("nan")

    for si, (m, nw, side, c) in enumerate(STAGES):
        heads, n = c // 32, 144
        rows = m * n
        ln = si < 2
        x = rnd((rows, c))
        wqkv, bqkv = rnd((3 * c, c), c ** -0.5), rnd((3 * c,), 0.2)
        wproj, bproj = rnd((c, c), c ** -0.5), rnd((c,), 0.2)
        lng, lnb = rnd((c,), 0.2) + 1, rnd((c,), 0.2)
        bias = torch.randn((heads, n, n), generator=g, device=dev)
        o, y = (torch.empty((rows, c), dtype=bf16, device=dev)
                for _ in range(2))
        qkv = torch.empty((rows, 3 * c), dtype=bf16, device=dev)
        q, k, v = (torch.empty((m, n, c), dtype=bf16, device=dev)
                   for _ in range(3))
        p = torch.empty((m, heads, n, n), dtype=bf16, device=dev)
        xn = torch.empty((rows, c), dtype=bf16, device=dev)

        def attn(lib, save, mask):
            sv = ((q.data_ptr(), k.data_ptr(), v.data_ptr(), p.data_ptr(),
                   xn.data_ptr() if ln else None) if save else (None,) * 5)
            check(lib.lavt_window_msa_attn(
                x.data_ptr(), lng.data_ptr() if ln else None,
                lnb.data_ptr() if ln else None, wqkv.data_ptr(),
                bqkv.data_ptr(), bias.data_ptr(),
                None if mask is None else mask.data_ptr(), o.data_ptr(), *sv,
                m, nw, c, heads, 32 ** -0.5, 1e-5, stream), "attention")

        full = libs["full"]
        gemms = {
            "WMMA out-projection": lambda: check(full.lavt_gemm_bf16(
                o.data_ptr(), wproj.data_ptr(), bproj.data_ptr(),
                y.data_ptr(), rows, c, c, c, c, 0, 1, stream), "WMMA proj"),
            "core qkv (gemm_bias)": lambda: check(full.lavt_gemm_bias_bf16(
                x.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(),
                qkv.data_ptr(), rows, 3 * c, c, c, 32 ** -0.5, stream),
                "core qkv"),
            "core out-projection (gemm_bias)": lambda: check(
                full.lavt_gemm_bias_bf16(
                    o.data_ptr(), wproj.data_ptr(), bproj.data_ptr(),
                    y.data_ptr(), rows, c, c, 0, 1.0, stream), "core proj"),
        }
        parts = {name: device_ms(fn) for name, fn in gemms.items()}
        print(f"stage {si + 1} (B nW {m}, C {c}, heads {heads}, LN {ln}), "
              "device ms per call (torch.profiler): " + "; ".join(
                  f"{k} {v:.4f}" for k, v in parts.items()), flush=True)
        for shifted in (False, True):
            mask = shift_mask_2d(side, side, 12, 6, dev) if shifted else None
            on = device_ms(lambda: attn(full, True, mask))
            off = device_ms(lambda: attn(full, False, mask))
            var = "; ".join(
                f"{name} {events_ms(lambda: attn(lib, s, mask)):.4f}"
                f"{' (save)' if s else ''}"
                for name, lib in libs.items() for s in (False, True))
            print(f"  mask {shifted}: attention launch, saves on {on:.4f}, "
                  f"saves off {off:.4f} ms (torch.profiler); by variant "
                  f"(CUDA events): {var}", flush=True)
        del x, o, y, qkv, q, k, v, p, xn
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
