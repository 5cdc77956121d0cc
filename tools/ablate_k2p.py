#!/usr/bin/env python3
"""What bounds K2p's first design: throwaway builds of its kernel with one
part switched off each, timed on one NVIDIA GPU.

    python3 tools/ablate_k2p.py --source OLD/lavt_rs_tpu_torch/csrc [--iters 20]

K2p's first design is one kernel per (head, window), `window_msa_np_kernel`
in `csrc/window_attn.cu` of a checkout from before its redesign (given by
--source, with that checkout's `common.cuh`): the block projects its
head's q, k, v from x on WMMA, then runs the attention by mma.sync with
the f32 bias and mask read from L2 inside the key loop; the
out-projection was a second launch on a WMMA GEMM, which this tree no
longer builds: the out-projection here runs on this tree's GEMM core
(`fused_msa.gemm_bias`).  The kernel's source is compiled by nvcc into one
library per variant, each variant an edit of the source:
  full         the kernel as it was;
  no-bias      the attention reads no bias or mask (zeros in their place);
  no-xw-loads  the projection's x and Wqkv loads replaced by zeros (its
               WMMA products and shared-memory stores stay);
  no-proj      the projection skipped (q, k, v: what shared memory holds);
  no-attn      the attention skipped (the projection alone).
Each runs at both stage-1 calls of Video Swin-T on an 8-frame 480² clip
(324 windows of 392 tokens padded to 400, C = 96, 3 heads; unshifted: no
mask; shifted: 289 maskless windows, then 35 under the mask), timed with
CUDA events.  Then the full variant's attention launch and the
out-projection run under torch.profiler at both calls, each launch's device
time printed.  The variants' outputs are not checked: all but `full`
compute something else by design.
"""

import argparse
import ctypes
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# variant -> (old text, new text, count) edits of window_attn.cu
EDITS = {
    "full": [],
    "no-bias": [
        ("float2 ba = ld_pair(bias_h + oa, c, n), bb = ld_pair(bias_h + ob, c, n);",
         "float2 ba = make_float2(0.f, 0.f), bb = ba;"),
        ("const float2 ma = ld_pair(mask_w + oa, c, n), mb = ld_pair(mask_w + ob, c, n);",
         "const float2 ma = make_float2(0.f, 0.f), mb = ma;")],
    "no-xw-loads": [
        ("*reinterpret_cast<const uint4*>(\n"
         "            xw + static_cast<size_t>(g0 + r) * C + k0 + c)",
         "make_uint4(0, 0, 0, 0)"),
        ("*reinterpret_cast<const uint4*>(\n"
         "            wqkv + static_cast<size_t>(part * C + h * kHD + d) * C + k0 + c)",
         "make_uint4(0, 0, 0, 0)")],
    "no-proj": [("for (int g0 = 0; g0 < n; g0 += kTQ) {",
                 "for (int g0 = 0; g0 < 0; g0 += kTQ) {")],
    "no-attn": [("for (int gi = warp; gi < n / 16; gi += kWarps) {",
                 "for (int gi = warp; gi < 0; gi += kWarps) {")],
}
ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_float,
                                                          ctypes.c_void_p]


def build(source: Path, out: Path):
    """One shared library per variant, nvcc runs in parallel."""
    sys.path.insert(0, str(ROOT))
    from lavt_rs_tpu_torch.ops import cuda_lib

    nvcc = cuda_lib._nvcc()
    text = (source / "window_attn.cu").read_text()
    procs = {}
    for name, edits in EDITS.items():
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        shutil.copy(source / "common.cuh", d / "common.cuh")
        src = text
        for old, new in edits:
            if src.count(old) != 1:
                raise SystemExit(f"{name}: the edit's text is not in the "
                                 f"source once: {old!r}")
            src = src.replace(old, new)
        (d / "window_attn.cu").write_text(src)
        cmd = [nvcc, *cuda_lib.NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"),
               str(d / "window_attn.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True)
    libs = {}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{err}")
        lib = ctypes.CDLL(str(out / name / "lib.so"))
        lib.lavt_window_msa_np.argtypes = ARGTYPES
        lib.lavt_window_msa_np.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser("ablate the first K2p kernel")
    ap.add_argument("--source", required=True, type=Path,
                    help="csrc/ of a checkout with the first K2p kernel")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("ablate_k2p: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from lavt_rs_tpu_torch.ops import cuda_lib, fused_msa
    from lavt_rs_tpu_torch.ops.window import partition_3d_groups

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    libs = build(args.source.resolve(), ROOT / "build" / "ablate_k2p")
    dev = torch.device("cuda:0")
    g = torch.Generator(device=dev).manual_seed(0)
    c, heads, n, n_p, nw = 96, 3, 392, 400, 324

    def rnd(shape, std=1.0):
        return (torch.randn(shape, generator=g, device=dev) * std).bfloat16()

    x = rnd((nw, n_p, c))
    x[:, n:] = 0
    wqkv, bqkv = rnd((3 * c, c), c ** -0.5), rnd((3 * c,), 0.2)
    wproj, bproj = rnd((c, c), c ** -0.5), rnd((c,), 0.2)
    bias = fused_msa.pad_bias_sublane(
        torch.randn((heads, n, n), generator=g, device=dev), n_p)
    o = torch.empty((nw, n_p, c), dtype=torch.bfloat16, device=dev)
    stream = cuda_lib.stream_ptr(dev)

    def attention(lib, mask, nu):
        err = lib.lavt_window_msa_np(
            x.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(), bias.data_ptr(),
            None if mask is None else mask.data_ptr(), o.data_ptr(), nw, nw,
            nu, c, heads, n_p, float(32 ** -0.5), stream)
        if err:
            raise RuntimeError(f"lavt_window_msa_np: CUDA error {err}")

    def proj():
        return fused_msa.gemm_bias(o.view(nw * n_p, c), wproj, bproj)

    def events_ms(fn):
        for _ in range(3):
            fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / args.iters

    calls = []
    for shifted in (False, True):
        ss = (0, 3, 3) if shifted else (0, 0, 0)
        nu, mask = partition_3d_groups(8, 120, 120, 8, 126, 126, (8, 7, 7), ss,
                                       n_p, dev)
        calls.append((f"{'shifted' if shifted else 'unshifted'} (nu {nu})",
                      mask, nu))
    for what, mask, nu in calls:
        parts = [f"{name} {events_ms(lambda l=lib: attention(l, mask, nu)):.4f}"
                 for name, lib in libs.items()]
        print(f"K2p first design, attention launch, stage 1 {what}, ms per "
              f"call (CUDA events, {args.iters} calls): " + "; ".join(parts),
              flush=True)
    for what, mask, nu in calls:
        full = libs["full"]
        attention(full, mask, nu)
        proj()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(args.iters):
                attention(full, mask, nu)
                proj()
            torch.cuda.synchronize()
        rows = [(getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0)), e.count, e.key)
                for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        print(f"K2p first design under torch.profiler, stage 1 {what}, device "
              f"ms per call: " + "; ".join(
                  f"{key.split('(')[0].replace('void ', '')[:60]} "
                  f"{us / 1e3 / args.iters:.4f} (x{count // args.iters})"
                  for us, count, key in sorted(rows, reverse=True) if us > 0),
              flush=True)
        print(f"  out-projection alone (CUDA events): {events_ms(proj):.4f} ms",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
