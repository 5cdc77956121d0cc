"""Build and load the hand-written CUDA kernels (`lavt_rs_tpu_torch/csrc`).

The sources have a plain C interface.  On first use each is compiled with
`nvcc -gencode arch=compute_90a,code=sm_90a` (one nvcc per source, all
started together), and the objects are linked into one shared library
under `<repo>/build/kernels/<hash of the sources>/`, then loaded with
ctypes.
Nothing is built or imported when this module is imported: `lib()` does it
on the first kernel launch, so the CPU tests can import every module.

Every entry point returns `cudaGetLastError()`; `check()` raises when it is
not 0.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("ln.cu", "fused_mlp.cu", "fused_msa_bwd.cu",
           "fused_msa_bwd_sm90.cu", "fused_mlp_bwd.cu", "window_attn_sm90.cu",
           "window_attn_bwd_sm90.cu", "window_msa_sm90.cu",
           "fused_msa_sm90.cu", "probe_headbatch.cu", "gemm_f32.cu",
           "fused_msa_f32.cu", "window_attn_f32.cu", "window_attn_bwd_f32.cu",
           "fused_mlp_bwd_f32.cu", "fused_msa_bwd_f32.cu", "grouped_msa_f32.cu")
HEADERS = ("common.cuh", "gemm_sm90.cuh", "attn_sm90.cuh", "gemm_f32.cuh",
           "attn_tf32.cuh", "gemm_tf32_sm90.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-lineinfo")

P = ctypes.c_void_p
I = ctypes.c_int
L = ctypes.c_longlong
F = ctypes.c_float

# argtypes of each C entry point (pointers and the stream as c_void_p)
SIGNATURES = {
    "lavt_layer_norm_rows": (P, P, P, P, I, I, F, P),
    "lavt_layer_norm_rows_f32": (P, P, P, P, I, I, F, P),
    "lavt_layer_norm_rows_bwd_parts": (I, I),
    "lavt_layer_norm_rows_bwd": (P,) * 5 + (I, I, I, F, P),
    "lavt_mlp_ln_rows": (P, P, P, P, I, I, F, P),
    "lavt_gemm_bias_gelu": (P, P, P, P, I, I, I, P),
    "lavt_gemm_residual": (P,) * 6 + (I, I, I, I, P),
    "lavt_fused_ln_mlp": (P,) * 11 + (I, I, I, I, F, P),
    "lavt_msa_bwd_attn_sm90": (P,) * 9 + (I,) * 5 + (F, P),
    "lavt_msa_fwd_sm90": (P,) * 6 + (I,) * 5 + (P,),
    "lavt_msa_fwd_map_sm90": (P,) * 5 + (I,) * 6 + (P,),
    "lavt_msa_dgrad": (P, P, P, I, I, I, P),
    "lavt_sum_partials": (P, P, I, L, P),
    "lavt_colsum_bf16": (P, P, I, I, I, P),
    "lavt_mlp_bwd_prep": (P,) * 8 + (I, I, I, F, P),
    "lavt_dual_gemm_gelu_bwd": (P,) * 8 + (I, I, I, P),
    "lavt_wgrad": (P, P, P) + (I,) * 5 + (P,),
    "lavt_dgrad": (P, P, P, I, I, I, P),
    "lavt_ln_bwd_rows": (P,) * 5 + (I,) + (P,) * 3 + (I, I, P),
    "lavt_mlp_bwd": (P,) * 8 + (I,) + (P,) * 10 + (I,) * 5 + (F, P),
    "lavt_window_attn": (P,) * 7 + (L,) * 6 + (I,) * 7 + (F, P),
    "lavt_k10_smem": (I,),
    "lavt_window_attn_bwd_q": (P,) * 13 + (I,) * 6 + (F, P),
    "lavt_window_attn_bwd_kv": (P,) * 11 + (I,) * 6 + (P,),
    "lavt_k9_q_smem": (I,),
    "lavt_gemm_bias_bf16": (P,) * 4 + (I,) * 4 + (F, P),
    "lavt_probe_headbatch": (P, P) + (I,) * 6 + (P,),
    "lavt_gemm_f32": (P,) * 7 + (I,) * 5 + (F, I, P),
    "lavt_tf32_core_smem": (I,),
    "lavt_tf32_lo": (P, P, L, P),
    "lavt_mlp_f32_prep": (P,) * 8 + (I, I, I, F, P),
    "lavt_layer_norm_rows_bwd_f32_ws": (I, I),
    "lavt_layer_norm_rows_bwd_f32": (P,) * 6 + (I, I, I, F, P),
    "lavt_mlp_bwd_prep_f32": (P,) * 8 + (I, I, I, F, P),
    "lavt_dual_gemm_gelu_bwd_f32": (P,) * 9 + (I, I, I, P),
    "lavt_wgrad_f32": (P, P, P) + (I,) * 5 + (P,),
    "lavt_dgrad_f32": (P, P, P, I, I, I, P),
    "lavt_ln_bwd_rows_f32": (P,) * 5 + (I,) + (P,) * 3 + (I, I, P),
    "lavt_mlp_bwd_f32": (P,) * 8 + (I,) + (P,) * 11 + (I,) * 5 + (F, P),
    "lavt_msa_fwd_f32": (P,) * 6 + (I,) * 5 + (P,),
    "lavt_msa_fwd_map_f32": (P,) * 5 + (I,) * 6 + (P,),
    "lavt_msa_bwd_attn_f32": (P,) * 8 + (I,) * 5 + (F, P),
    "lavt_colsum_f32": (P, P, I, I, I, P),
    "lavt_window_attn_f32": (P,) * 7 + (L,) * 6 + (I,) * 6 + (F, P),
    "lavt_k10_f32_smem": (I,),
    "lavt_k2p_attn_f32": (P,) * 4 + (I,) * 7 + (P,),
    "lavt_k2p_attn_f32_smem": (),
    "lavt_window_attn_bwd_q_f32": (P,) * 12 + (I,) * 5 + (F, P),
    "lavt_window_attn_bwd_kv_f32": (P,) * 11 + (I,) * 4 + (F, P),
}

_LIB = None
build_seconds = None  # wall time of the build in this process (None: cached)


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        path = Path(cand) / "bin" / "nvcc"
        if cand and path.exists():
            return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> Path:
    """Compile the kernels unless this source hash is already built;
    returns the path of the shared library."""
    global build_seconds
    out_dir = BUILD_ROOT / _digest()
    so = out_dir / "liblavt_kernels.so"
    if so.exists():
        return so
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = os.getpid()
    nvcc = _nvcc()
    extra = ["-Xptxas=-v"] if verbose else []
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in SOURCES:
        obj = out_dir / f"{Path(src).stem}.{tag}.o"
        cmd = [nvcc, *extra, *NVCC_FLAGS, "-c", "-o", str(obj), str(CSRC / src)]
        objs.append(obj)
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.PIPE, text=True)))
    failed = []
    for cmd, proc in procs:  # wait for every compile before reporting
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}"
                          f"\n{out}\n{err}")
        elif verbose:
            print(err, flush=True)
    if failed:
        raise RuntimeError("\n".join(failed))
    tmp = out_dir / f"liblavt_kernels.{tag}.so"
    cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    for obj in objs:
        obj.unlink()
    os.replace(tmp, so)
    build_seconds = time.perf_counter() - t0
    return so


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    if _LIB is None:
        handle = ctypes.CDLL(str(build()))
        for name, args in SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = list(args)
            fn.restype = ctypes.c_int
        _LIB = handle
    return _LIB


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def stream_ptr(device) -> int:
    """The raw pointer of the current CUDA stream on `device` (a
    torch.device): torch's own accessor where the build has it (no Stream
    object per call), else through torch.cuda.current_stream."""
    import torch

    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(device.index if device.index is not None
                   else torch.cuda.current_device())
    return torch.cuda.current_stream(device).cuda_stream


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The streaming multiprocessors of CUDA device `index` (the launch
    plans' target)."""
    import torch

    return torch.cuda.get_device_properties(index).multi_processor_count


def require(t, name: str, dtype, device, shape=None) -> None:
    """Raise unless t is a contiguous CUDA tensor of the given dtype on
    `device` (and shape, when given)."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
