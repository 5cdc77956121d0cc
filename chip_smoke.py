#!/usr/bin/env python3
"""Smoke test of the PyTorch port (lavt_rs_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root, one card

1. Prints the card's name and power limit, then builds the hand-written
   CUDA kernels from `lavt_rs_tpu_torch/csrc` with nvcc (sm_90a).
2. Kernel phases: each kernel (K1 fused LN+window MSA, K2 window MSA,
   K3 fused LN-MLP, K4 row LN) on seeded bf16 inputs at the shapes the
   main path gives it (lavt_one Swin-B 480², batch 8), against its plain
   PyTorch version (f32 math from the same bf16 inputs, TF32 off), within
   a stated tolerance.  Then the kernel, the plain version and a bf16
   PyTorch chain of the same math (bf16 F.linear / matmul / F.layer_norm,
   the speed a library gives) are timed with CUDA events.
3. Main path: lavt_one Swin-B / window 12 / 480² / 12-layer BERT in bf16
   from seeded random weights (see `main_path_model`) answers three
   batches of 8 RefCOCO-style requests (uint8 images, 20 token ids with
   padded masks, packed targets) through `eval.refcoco_eval.fwd_iou`.
   The kernels' launch counters must show every routed call.  One batch's
   logits are checked against the same weights run through the plain path
   in f32.
4. Times the bf16 forward at batch 8, with the kernels and with the plain
   versions (bf16 weights, f32 math, TF32 off).

Exits non-zero on any failure, without CUDA, or without the package.
The last two lines are the per-kernel JSON and
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import json
import os
import subprocess
import sys
import time

BATCH = 8
N_REQUESTS = 3
TOKENS = 20
SEED = 0
GATE_STD = 0.05
# bf16 keeps 8 significant bits (one rounding of an O(1) value moves it by
# up to 2^-8 ≈ 3.9e-3).  LN and MLP outputs are rounded once more at the
# bf16 LN output / GELU output before their GEMMs: a few such steps.  The
# MSA also rounds q/k/v, P and the attention output before the
# out-projection, so its bound is wider.
TOL = {"K1": 3e-2, "K2": 3e-2, "K3": 2e-2, "K4": 2e-2}
# main path vs the f32 plain path: argmax agreement on confident pixels
MARGIN, MIN_AGREE = 0.05, 0.995
REPLACES = {
    "K1": "lavt_rs_tpu/ops/pallas/fused_msa.py:1415",
    "K2": "lavt_rs_tpu/ops/pallas/fused_msa.py:1261",
    "K3": "lavt_rs_tpu/ops/pallas/fused_mlp.py:111",
    "K4": "lavt_rs_tpu/ops/pallas/ln.py:63",
}
SOURCES = {
    "K1": "lavt_rs_tpu_torch/csrc/fused_msa.cu",
    "K2": "lavt_rs_tpu_torch/csrc/fused_msa.cu",
    "K3": "lavt_rs_tpu_torch/csrc/fused_mlp.cu",
    "K4": "lavt_rs_tpu_torch/csrc/ln.cu",
}
# Swin-B at 480²: (tokens per side, C, heads, blocks) per stage
STAGES = ((120, 128, 4, 2), (60, 256, 8, 2), (30, 512, 16, 18),
          (15, 1024, 32, 2))


def log(*a):
    print(*a, flush=True)


def cuda_time_ms(fn, iters=10, warmup=2):
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def compare(name, got, want):
    import torch

    torch.cuda.synchronize()
    tol = TOL[name]
    g, w = got.float(), want.float()
    if not bool(torch.isfinite(g).all()):
        raise RuntimeError(f"{name}: non-finite kernel output")
    err = (g - w).abs()
    ok = bool((err <= tol + tol * w.abs()).all())
    max_err = err.max().item()
    if not ok:
        raise RuntimeError(f"{name}: kernel disagrees with its plain version "
                           f"(max abs err {max_err:.4g}, tol {tol} abs + rel)")
    return max_err


def torch_bf16_ln(x, s, b):
    """K4's math as one PyTorch bf16 call (timing baseline only)."""
    import torch.nn.functional as F

    return F.layer_norm(x, x.shape[-1:], s, b, 1e-5)


def torch_bf16_mlp(x, g, be, w1, b1, w2, b2):
    """K3's math as a bf16 PyTorch chain (timing baseline only)."""
    import torch.nn.functional as F

    h = F.gelu(F.linear(F.layer_norm(x, x.shape[-1:], g, be, 1e-5), w1, b1))
    return x + F.linear(h, w2, b2)


def torch_bf16_msa(x, wqkv, bqkv, wproj, bproj, bias, mask, heads, scale,
                   ln=None):
    """K1 (with ln) / K2's math as a bf16 PyTorch chain: bf16 GEMMs, the
    softmax in f32 (timing baseline only)."""
    import torch.nn.functional as F

    b, nw, n, c = x.shape
    if ln is not None:
        x = F.layer_norm(x, (c,), *ln, 1e-5)
    qkv = F.linear(x, wqkv, bqkv).view(b, nw, n, 3, heads, c // heads)
    q, k, v = qkv.permute(3, 0, 1, 4, 2, 5)
    s = (q * scale @ k.transpose(-1, -2)).float() + bias
    if mask is not None:
        s = s + mask[:, None]
    o = s.softmax(-1).to(x.dtype) @ v
    return F.linear(o.permute(0, 1, 3, 2, 4).reshape(b, nw, n, c), wproj, bproj)


def kernel_phases(dev):
    """Each kernel against its plain version at the main-path shapes;
    returns {name: [max_abs_err, ms, plain ms, torch bf16 ms]}, the times
    per forward (calls per forward x ms per call)."""
    import torch

    from lavt_rs_tpu_torch.ops import fused_mlp, fused_msa, ln
    from lavt_rs_tpu_torch.ops.window import (relative_bias_from_table,
                                              relative_position_index_2d,
                                              shift_mask_2d)

    g = torch.Generator(device=dev).manual_seed(SEED)

    def rnd(shape, std=1.0, mean=0.0, dtype=torch.bfloat16):
        t = torch.randn(shape, generator=g, device=dev) * std + mean
        return t.to(dtype)

    res = {k: [0.0, 0.0, 0.0, 0.0] for k in TOL}

    def check_and_time(name, what, calls, fn_k, fn_p, fn_b):
        want = fn_p()
        err = compare(name, fn_k(), want)
        err_b = (fn_b().float() - want.float()).abs().max().item()
        tk = cuda_time_ms(fn_k)
        tp = cuda_time_ms(fn_p, iters=3, warmup=1)
        tb = cuda_time_ms(fn_b)
        r = res[name]
        r[0] = max(r[0], err)
        r[1] += calls * tk
        r[2] += calls * tp
        r[3] += calls * tb
        log(f"{name} {what}: max abs err {err:.3g} (tol {TOL[name]} abs+rel; "
            f"torch bf16 chain {err_b:.3g}), kernel {tk:.4f} ms, plain "
            f"(f32 math) {tp:.4f} ms, torch bf16 {tb:.4f} ms")

    index = torch.from_numpy(relative_position_index_2d(12, 12)).to(dev)
    for si, (side, c, heads, depth) in enumerate(STAGES):
        rows = BATCH * side * side
        # K4: the stage-output norm
        x = rnd((rows, c), 2.0, 0.5)
        s, b = rnd((c,), 0.2, 1.0), rnd((c,), 0.2)
        check_and_time("K4", f"stage {si + 1} ({rows}, {c})", 1,
                       lambda: ln.layer_norm_rows(x, s, b),
                       lambda: ln.layer_norm_rows_plain(x, s, b),
                       lambda: torch_bf16_ln(x, s, b))
        # K3: the LN-MLP tail of every block
        args = (rnd((rows, c)), rnd((c,), 0.2, 1.0), rnd((c,), 0.2),
                rnd((4 * c, c), c ** -0.5), rnd((4 * c,), 0.2),
                rnd((c, 4 * c), (4 * c) ** -0.5), rnd((c,), 0.2))
        check_and_time("K3", f"stage {si + 1} ({rows}, {c})", depth,
                       lambda: fused_mlp.fused_ln_mlp(*args),
                       lambda: fused_mlp.fused_ln_mlp_plain(*args),
                       lambda: torch_bf16_mlp(*args))
        # K1 at the unpadded stages, K2 at the padded ones (pad to 12k)
        hp = -(-side // 12) * 12
        nw = (hp // 12) ** 2
        name = "K1" if hp == side else "K2"
        xw = rnd((BATCH, nw, 144, c))
        w = (rnd((3 * c, c), c ** -0.5), rnd((3 * c,), 0.2),
             rnd((c, c), c ** -0.5), rnd((c,), 0.2))
        bias = relative_bias_from_table(
            torch.randn((23 * 23, heads), generator=g, device=dev), index)
        lnp = (rnd((c,), 0.2, 1.0), rnd((c,), 0.2))
        for shift in (False, True):
            mask = shift_mask_2d(hp, hp, 12, 6, dev) if shift else None
            tail = (*w, bias, mask, heads, (c // heads) ** -0.5)
            if name == "K1":
                fk = lambda: fused_msa.fused_window_msa_ln(xw, *lnp, *tail)
                fp = lambda: fused_msa.fused_window_msa_ln_plain(xw, *lnp, *tail)
                fb = lambda: torch_bf16_msa(xw, *tail, ln=lnp)
            else:
                fk = lambda: fused_msa.fused_window_msa(xw, *tail)
                fp = lambda: fused_msa.fused_window_msa_plain(xw, *tail)
                fb = lambda: torch_bf16_msa(xw, *tail)
            check_and_time(name, f"stage {si + 1} x{tuple(xw.shape)} heads "
                           f"{heads} mask {shift}", depth // 2, fk, fp, fb)
    return res


def main_path_model(dev, g):
    """lavt_one_base in bf16 on `dev`, weights drawn from `g` by the JAX
    init scheme (`factory.init_weights`), then two changes that make a
    random model a meaningful bf16 check:
      * the language gates are drawn N(0, GATE_STD) instead of zero, so
        PWAM reaches the residual stream;
      * BERT's residual-branch outputs (attention.output.dense and
        output.dense) are scaled by (2 * layers)^-1/2, GPT-2's scaled
        residual init.  Without it a random 12-layer post-LN BERT averages
        its tokens together (they end within ~2% of each other), and
        PWAM's InstanceNorm over pixels then divides bf16 rounding by a
        near-zero spread, which no trained text encoder gives."""
    import torch

    from lavt_rs_tpu_torch.config import lavt_one_base
    from lavt_rs_tpu_torch.models.bert import BertEncoder
    from lavt_rs_tpu_torch.models.factory import build_model
    from lavt_rs_tpu_torch.models.pwam import LanguageGate

    model = build_model(lavt_one_base(), dev, generator=g)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, LanguageGate):
                for lin in (m[0], m[2]):
                    lin.weight.copy_(torch.randn(lin.weight.shape, generator=g,
                                                 device=dev) * GATE_STD)
            elif isinstance(m, BertEncoder):
                scale = (2 * len(m.encoder.layer)) ** -0.5
                for layer in m.encoder.layer:
                    layer.attention.output.dense.weight.mul_(scale)
                    layer.output.dense.weight.mul_(scale)
    return model


def requests(dev, g, n, batch=BATCH):
    import numpy as np
    import torch

    rng = np.random.default_rng(SEED)
    out = []
    for _ in range(n):
        image = torch.randint(0, 256, (batch, 480, 480, 3), generator=g,
                              device=dev, dtype=torch.uint8)
        ids = torch.from_numpy(rng.integers(1000, 20000, (batch, 1, TOKENS)))
        mask = np.zeros((batch, 1, TOKENS), np.int64)
        for i, n_tok in enumerate(rng.integers(5, TOKENS + 1, batch)):
            mask[i, 0, :n_tok] = 1
        target = np.packbits(rng.random((batch, 480 * 480)) > 0.5, axis=1)
        out.append((image, ids.to(dev), torch.from_numpy(mask).to(dev),
                    torch.from_numpy(target).to(dev)))
    return out


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from lavt_rs_tpu_torch.config import lavt_one_base
    except ImportError as e:  # run outside the repository
        print(f"chip_smoke: the lavt_rs_tpu_torch package is missing ({e})",
              file=sys.stderr)
        return 1
    from lavt_rs_tpu_torch.eval.refcoco_eval import fwd_iou
    from lavt_rs_tpu_torch.models.factory import build_model
    from lavt_rs_tpu_torch.ops import cuda_lib, fused_mlp, fused_msa, ln
    from lavt_rs_tpu_torch.ops.norm import maybe_normalize_image

    # the plain versions and the f32 reference model run full f32 GEMMs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    cuda_lib.lib()
    log(f"kernel build+load: {time.perf_counter() - t0:.2f} s "
        f"(nvcc {cuda_lib.build_seconds} s)")

    # -- kernel phases ----------------------------------------------------
    res = kernel_phases(dev)
    for k, (_, ms, plain_ms, bf16_ms) in res.items():
        log(f"{k} per forward: kernel {ms:.3f} ms, plain (f32 math) "
            f"{plain_ms:.3f} ms, torch bf16 {bf16_ms:.3f} ms")

    # -- main path ---------------------------------------------------------
    cfg = lavt_one_base()
    g = torch.Generator(device=dev).manual_seed(SEED)
    t0 = time.perf_counter()
    model = main_path_model(dev, g)
    log(f"model build ({cfg.dtype}, use_kernels={cfg.use_kernels}): "
        f"{time.perf_counter() - t0:.2f} s")
    batches = requests(dev, g, N_REQUESTS)
    counters = {"K1": fused_msa.fused_window_msa_ln,
                "K2": fused_msa.fused_window_msa,
                "K3": fused_mlp.fused_ln_mlp, "K4": ln.layer_norm_rows}
    per_forward = {"K1": 4, "K2": 20, "K3": 24, "K4": 4}
    for fn in counters.values():
        fn.launches = 0
    results = [fwd_iou(model, *b) for b in batches]
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    log(f"launches over {N_REQUESTS} batches of {BATCH}: {launches}")
    for k, n in per_forward.items():
        if launches[k] != n * N_REQUESTS:
            raise RuntimeError(f"{k}: {launches[k]} launches, expected "
                               f"{n * N_REQUESTS}")
    for inter, union in results:
        if inter.shape != (BATCH, 1) or not bool(torch.isfinite(union).all()):
            raise RuntimeError("fwd_iou: bad inter/union")
        if bool((inter > union).any()):
            raise RuntimeError("fwd_iou: intersection above union")
    iou = torch.cat([i / u.clamp(min=1) for i, u in results]).mean().item()
    log(f"fwd_iou: mean IoU vs random targets {iou:.4f}")

    # -- one batch against the f32 plain path --------------------------------
    image, ids, mask, _ = batches[0]
    img = maybe_normalize_image(image)
    with torch.no_grad():
        logits = model(img, ids[:, 0], mask[:, 0])
    if tuple(logits.shape) != (BATCH, 480, 480, 2):
        raise RuntimeError(f"logits shape {tuple(logits.shape)}")
    if not bool(torch.isfinite(logits).all()):
        raise RuntimeError("non-finite logits")
    ref = build_model(cfg.replace(dtype="float32", use_kernels=False), dev)
    ref.load_state_dict(model.state_dict())
    with torch.no_grad():
        want = ref(img, ids[:, 0], mask[:, 0])
    del ref
    margin = (want[..., 1] - want[..., 0]).abs()
    sure = margin > MARGIN
    agree = (logits.argmax(-1) == want.argmax(-1))[sure].float().mean().item()
    log(f"bf16 kernel path vs f32 plain path: max |dlogit| "
        f"{(logits - want).abs().max().item():.4g}, logit scale "
        f"{want.abs().max().item():.4g}, argmax agreement {agree:.5f} on "
        f"{sure.float().mean().item():.3f} of pixels (margin > {MARGIN})")
    if not agree >= MIN_AGREE:
        raise RuntimeError(f"argmax agreement {agree:.5f} < {MIN_AGREE}")

    # -- forward time --------------------------------------------------------
    iters, plain_iters = 40, 10
    with torch.no_grad():
        ms = cuda_time_ms(lambda: model(img, ids[:, 0], mask[:, 0]),
                          iters=iters, warmup=3)
        plain = build_model(cfg.replace(use_kernels=False), dev)
        plain.load_state_dict(model.state_dict())
        plain_ms = cuda_time_ms(lambda: plain(img, ids[:, 0], mask[:, 0]),
                                iters=plain_iters, warmup=2)
    log(f"forward bs {BATCH} bf16 with kernels: {ms:.3f} ms/step, "
        f"{BATCH * 1000 / ms:.2f} img/s (mean of {iters}); plain versions "
        f"(bf16 weights, f32 math, TF32 off): {plain_ms:.3f} ms/step, "
        f"{BATCH * 1000 / plain_ms:.2f} img/s (mean of {plain_iters})  [{card}]")
    log(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    kernels = [{"name": k, "route": "cuda", "source": SOURCES[k],
                "replaces": REPLACES[k], "launches": launches[k],
                "max_abs_err": res[k][0], "ms": res[k][1],
                "plain_ms": res[k][2]} for k in ("K1", "K2", "K3", "K4")]
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
