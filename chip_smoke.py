#!/usr/bin/env python3
"""Smoke test of the PyTorch port (lavt_rs_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root, one card

1. Prints the card's name and power limit, then builds the hand-written
   CUDA kernels from `lavt_rs_tpu_torch/csrc` with nvcc (sm_90a).
2. Kernel phases: each kernel on seeded bf16 inputs at the shapes the
   main paths give it (lavt_one Swin-B 480², batch 8; K6 also at stage 1
   with batch 16), against its plain PyTorch version (f32 math from the
   same bf16 inputs, TF32 off), within a stated tolerance:
     * inference: K1 fused LN+window MSA, K2 window MSA, K3 fused LN-MLP,
       K4 row LN;
     * training: K1/K2 in save mode, K5 (MSA backward from the saved
       residuals), K6 (MSA backward, recomputing), K7 (LN-MLP backward,
       with and without the DropPath keep), K8 (LN-MLP with DropPath).
   Then the kernel, the plain version and the library chain (a bf16
   PyTorch chain of the same math: bf16 F.linear / matmul / F.layer_norm
   for a forward, autograd backward through that chain for a backward)
   are timed with CUDA events, and each call's bound (the larger of its
   bytes over 3.35 TB/s and its operations over 989 TFLOP/s) is printed
   beside its time.
3. Inference main path: lavt_one Swin-B / window 12 / 480² / 12-layer
   BERT in bf16 from seeded random weights (`main_path_model`) answers
   three batches of 8 RefCOCO-style requests (uint8 images, 20 token ids
   with padded masks, packed targets) through `eval.refcoco_eval.fwd_iou`.
   The kernels' launch counters must show every routed call.  One batch's
   logits are checked against the same weights run through the plain path
   in f32.  Then the bf16 forward at batch 8 is timed, with the kernels
   and with the plain versions.
4. Video phase: K10 (attention on pre-projected heads) at the stage-2..4
   shapes of an 8-frame 480² clip (N = 392) and at N = 196, K2p (the
   padded fused MSA) at the stage-1 shape, maskless and grouped, each
   against its plain version, timed beside its bound, its plain version
   and its library call (one `scaled_dot_product_attention` for K10, a
   bf16 linear / SDPA / linear chain for K2p).  Then lavt_video
   (Video Swin-T, SepTPWAM, 12-layer BERT, the A2D recipe) in bf16 from
   seeded random weights answers three 8-frame 480² clips through
   `eval.video_eval.clip_iou`; the counters must show K2p twice and K10
   ten times per clip.  One clip's annotated frame is checked against the
   f32 plain route, the forward is timed (ms per clip, frames/s, with and
   without the kernels) and one clip is broken down by `torch.profiler`.
5. Training main path: the same weights in an f32 `build_model(...,
   train=True)` take AdamW steps (`train.step.make_train_step`: DropPath
   0.3, BERT dropout 0.1, weighted CE, poly LR) on synthetic uint8
   batches:
     * 1 warm-up step, then 10 timed steps at batch 8 on one repeated
       batch with the dropout generator reseeded every step (one fixed
       objective): launch counts per step, ms/step, img/s, peak memory,
       and the loss must fall;
     * one step at batch 16, where stage 1's saved probabilities pass the
       192 MiB cap and its blocks take K6;
     * first, the gate: one forward + backward of the kernel route (bf16)
       and of the plain route (`use_kernels=False`, f32 math, TF32 off)
       from the same weights, batch and generator seed with every dropout
       on and BatchNorm on its running statistics: the losses agree within
       1e-2 relative, each Swin block's concatenated parameter gradients
       have cosine >= 0.98, all gradients are finite.  With BN on its batch
       statistics its backward amplifies bf16 rounding in any bf16 route;
       those cosines, for the kernel route and for the plain modules under
       bf16 autocast, are printed and not checked.

Exits non-zero on any failure, without CUDA, or without the package.
The last two lines are the per-kernel JSON and
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import json
import math
import os
import subprocess
import sys
import time

BATCH = 8
BATCH_BIG = 16
N_REQUESTS = 3
TRAIN_STEPS = 10
TOKENS = 20
SEED = 0
GATE_STD = 0.05
# bf16 keeps 8 significant bits (one rounding of an O(1) value moves it by
# up to 2^-8 ≈ 3.9e-3).  LN and MLP outputs are rounded once more at the
# bf16 LN output / GELU output before their GEMMs: a few such steps.  The
# MSA also rounds q/k/v, P and the attention output before the
# out-projection, so its bound is wider.  Elementwise outputs are held to
# TOL abs + rel.
TOL = {"K1": 3e-2, "K2": 3e-2, "K3": 2e-2, "K4": 2e-2, "K8": 2e-2}
# save mode: the probabilities P (values ~1/144) within TOL_P abs + 3e-2 rel
TOL_P = 2e-3
# backward kernels: dx within TOL_DX (rms(want) + |want|), the rms standing
# for the tensor's scale; the weight, bias and bias-table grads (sums over
# all rows of bf16-rounded factors) within a relative Frobenius error of
# TOL_GRAD
TOL_DX = 3e-2
TOL_GRAD = 1e-2
# training gate: kernel route (bf16) vs plain route (f32 math)
LOSS_RTOL, MIN_COS = 1e-2, 0.98
# main path vs the f32 plain path: argmax agreement on confident pixels
MARGIN, MIN_AGREE = 0.05, 0.995
# H100 SXM peaks (NVIDIA data sheet): dense bf16 tensor cores, HBM3
PEAK_FLOPS, PEAK_BYTES = 989e12, 3.35e12
NAMES = ("K1", "K2", "K3", "K4", "K5", "K6", "K7", "K8", "K10", "K2p", "K9")
REPLACES = {
    "K1": "lavt_rs_tpu/ops/pallas/fused_msa.py:1415",
    "K2": "lavt_rs_tpu/ops/pallas/fused_msa.py:1261",
    "K3": "lavt_rs_tpu/ops/pallas/fused_mlp.py:111",
    "K4": "lavt_rs_tpu/ops/pallas/ln.py:63",
    "K5": "lavt_rs_tpu/ops/pallas/fused_msa.py:672",
    "K6": "lavt_rs_tpu/ops/pallas/fused_msa.py:576",
    "K7": "lavt_rs_tpu/ops/pallas/fused_mlp.py:477",
    "K8": "lavt_rs_tpu/ops/pallas/fused_mlp.py:533",
    "K10": "lavt_rs_tpu/ops/pallas/window_attn.py:120",
    "K2p": "lavt_rs_tpu/ops/pallas/fused_msa.py:891",
    "K9": "lavt_rs_tpu/ops/pallas/window_attn.py:292",
}
SOURCES = {
    "K1": "lavt_rs_tpu_torch/csrc/fused_msa.cu",
    "K2": "lavt_rs_tpu_torch/csrc/fused_msa.cu",
    "K3": "lavt_rs_tpu_torch/csrc/fused_mlp.cu",
    "K4": "lavt_rs_tpu_torch/csrc/ln.cu",
    "K5": "lavt_rs_tpu_torch/csrc/fused_msa_bwd.cu",
    "K6": "lavt_rs_tpu_torch/csrc/fused_msa_bwd.cu",
    "K7": "lavt_rs_tpu_torch/csrc/fused_mlp_bwd.cu",
    "K8": "lavt_rs_tpu_torch/csrc/fused_mlp.cu",
    "K10": "lavt_rs_tpu_torch/csrc/window_attn.cu",
    "K2p": "lavt_rs_tpu_torch/csrc/window_attn.cu",
    "K9": "lavt_rs_tpu_torch/csrc/window_attn.cu",
}
# Swin-B at 480²: (tokens per side, C, heads, blocks) per stage
STAGES = ((120, 128, 4, 2), (60, 256, 8, 2), (30, 512, 16, 18),
          (15, 1024, 32, 2))
# launches per training step (batch 8; at batch 16 stage 1 takes K6)
TRAIN_PER_STEP = {"K1": 4, "K2": 20, "K3": 1, "K4": 4, "K5": 24, "K6": 0,
                  "K7": 24, "K8": 23}
BIG_PER_STEP = dict(TRAIN_PER_STEP, K5=22, K6=2)
# video Swin-T on an 8-frame 480² clip: (tokens per side, C, heads, blocks)
VIDEO_STAGES = ((120, 96, 3, 2), (60, 192, 6, 2), (30, 384, 12, 6),
                (15, 768, 24, 2))
FRAMES, VIDEO_TOKENS, N_CLIPS = 8, 22, 3
# launches per clip: K2p in both stage-1 blocks, K10 in the ten others
VIDEO_PER_CLIP = {"K10": 10, "K2p": 2}
# launches per video training step: every 3D block takes K10 (save mode)
# forward and K9 backward; no K2p in training
VIDEO_TRAIN_PER_STEP = {"K10": 12, "K9": 12}


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


# -- work of one call: (operations, bytes) ----------------------------------

def ln_work(rows, c):
    return 8 * rows * c, 2 * rows * c * 2 + 2 * c * 2


def mlp_work(m, c, backward=False, keep=0):
    """K3/K8 forward: two GEMMs of 2 M C 4C; K7: five (hpre recomputed,
    dh, dW2, dW1, dyln).  Bytes: x (and gy) read, out (dx) written, the
    bf16 weights read, the f32 weight grads written."""
    w = 8 * c * c * 2 + 5 * c * 2
    if backward:
        return 40 * m * c * c, 3 * m * c * 2 + w + (8 * c * c + 7 * c) * 4
    return 16 * m * c * c, 2 * m * c * 2 + w + keep * 4


def msa_work(b, nw, c, heads, mode, ln=False, mask=True):
    """mode 'fwd' (K1/K2), 'save' (save mode), 'bwd' (K5) or 'recompute'
    (K6).  Operations: the qkv (6 rows C²) and out-projection (2 rows C²)
    GEMMs and two N x N x hd products per window and head forward; the
    backward's dattn (2), dx (6), dWqkv (6), dWproj (2 rows C²) GEMMs and
    five N x N x hd products, plus, recomputing, the qkv GEMM and q kᵀ."""
    n, hd = 144, 32
    rows, m = b * nw * n, b * nw
    att = 2 * m * heads * n * n * hd
    act = rows * c * 2
    weights = 4 * c * c * 2 + 4 * c * 2
    tables = heads * n * n * 4 + (nw * n * n * 4 if mask else 0)
    p_bytes = m * heads * n * n * 2
    grads = (4 * c * c + 4 * c + heads * n * n) * 4
    if mode == "fwd":
        return 8 * rows * c * c + 2 * att, 2 * act + weights + tables
    if mode == "save":
        return (8 * rows * c * c + 2 * att,
                (5 + int(ln)) * act + weights + tables + p_bytes)
    if mode == "bwd":
        return 16 * rows * c * c + 5 * att, 6 * act + p_bytes + weights + grads
    return 22 * rows * c * c + 6 * att, 3 * act + weights + tables + grads


def bound_ms(work):
    flops, nbytes = work
    t_ops, t_mem = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


# -- checks ------------------------------------------------------------------

def compare(name, got, want, tol=None, tol_abs=None):
    import torch

    torch.cuda.synchronize()
    tol = TOL[name] if tol is None else tol
    tol_abs = tol if tol_abs is None else tol_abs
    g, w = got.float(), want.float()
    if not bool(torch.isfinite(g).all()):
        raise RuntimeError(f"{name}: non-finite kernel output")
    err = (g - w).abs()
    max_err = err.max().item()
    if not bool((err <= tol_abs + tol * w.abs()).all()):
        raise RuntimeError(f"{name}: kernel disagrees with its plain version "
                           f"(max abs err {max_err:.4g}, tol {tol_abs} abs + "
                           f"{tol} rel)")
    return max_err


def compare_saved(name, got, want):
    """Save mode: (y, (q, k, v, p, xn)) against the plain version's."""
    err = compare(name, got[0], want[0])
    for part, g, w in zip(("q", "k", "v", "p", "xn"), got[1], want[1]):
        if (g is None) != (w is None):
            raise RuntimeError(f"{name} save mode: {part} missing")
        if g is not None:
            tol_abs = TOL_P if part == "p" else None
            err = max(err, compare(name, g, w, TOL[name], tol_abs))
    return err


def compare_grads(name, got, want, n_dx=1):
    """Backward: the first n_dx outputs (dx; K9's dq, dk, dv) elementwise
    (scaled), every accumulated grad after them by its relative Frobenius
    error; returns (the dx's max abs error, the worst Frobenius error)."""
    import torch

    torch.cuda.synchronize()
    max_err = 0.0
    for i in range(n_dx):
        g, w = got[i].float(), want[i].float()
        if not bool(torch.isfinite(g).all()):
            raise RuntimeError(f"{name}: non-finite dx #{i}")
        err = (g - w).abs()
        scale = w.square().mean().sqrt()
        if not bool((err <= TOL_DX * (scale + w.abs())).all()):
            raise RuntimeError(f"{name}: dx #{i} disagrees with the plain "
                               f"version (max abs err {err.max().item():.4g} "
                               f"at scale {scale.item():.4g})")
        max_err = max(max_err, err.max().item())
    worst = 0.0
    for i, (gg, ww) in enumerate(zip(got[n_dx:], want[n_dx:]), n_dx):
        if not bool(torch.isfinite(gg).all()):
            raise RuntimeError(f"{name}: non-finite grad #{i}")
        rel = ((gg.float() - ww.float()).norm()
               / ww.float().norm().clamp(min=1e-30)).item()
        worst = max(worst, rel)
        if rel > TOL_GRAD:
            raise RuntimeError(f"{name}: grad #{i} relative Frobenius error "
                               f"{rel:.4g} > {TOL_GRAD}")
    return max_err, worst


def compare_lse(name, got, want):
    """K10's save mode: (O, lse); O as K10's, lse (f32 on both sides) within
    TOL_P abs + 1e-4 rel."""
    import torch

    err = compare(name, got[0], want[0], TOL["K2"])
    lse_err = (got[1] - want[1]).abs()
    if not bool((lse_err <= TOL_P + 1e-4 * want[1].abs()).all()):
        raise RuntimeError(f"{name}: lse disagrees with the plain version "
                           f"(max abs err {lse_err.max().item():.4g})")
    return err


# -- the library chains (timing baselines only) -------------------------------

def torch_bf16_ln(x, s, b):
    """K4's math as one PyTorch bf16 call (timing baseline only)."""
    import torch.nn.functional as F

    return F.layer_norm(x, x.shape[-1:], s, b, 1e-5)


def torch_bf16_mlp(x, g, be, w1, b1, w2, b2, keep_rows=None):
    """K3's math (K8's with keep_rows) as a bf16 PyTorch chain (timing
    baseline only)."""
    import torch.nn.functional as F

    h = F.gelu(F.linear(F.layer_norm(x, x.shape[-1:], g, be, 1e-5), w1, b1))
    y = F.linear(h, w2, b2)
    return x + (y if keep_rows is None else y * keep_rows)


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


def chain_grad(fn, inputs, gy, forward=False):
    """A closure timing autograd backward through a bf16 chain (the library
    yardstick of a backward kernel); with forward, the forward too."""
    import torch

    leaves = [t.detach().requires_grad_() for t in inputs]
    if forward:
        return lambda: torch.autograd.grad(fn(*leaves), leaves, gy)
    y = fn(*leaves)
    return lambda: torch.autograd.grad(y, leaves, gy, retain_graph=True)


# -- kernel phases ------------------------------------------------------------

class Results:
    """Per kernel: max error and, per step (calls x per-call), the kernel,
    plain and library ms and the bound."""

    def __init__(self):
        self.r = {k: dict(err=0.0, ms=0.0, plain=0.0, lib=0.0, bound=0.0,
                          ops=0.0, mem=0.0) for k in NAMES + ("save", "K10s")}

    def add(self, name, calls, err, tk, tp, tb, work):
        r = self.r[name]
        r["err"] = max(r["err"], err)
        b, _ = bound_ms(work)
        for key, v in (("ms", tk), ("plain", tp), ("lib", tb), ("bound", b),
                       ("ops", work[0] / PEAK_FLOPS * 1e3),
                       ("mem", work[1] / PEAK_BYTES * 1e3)):
            r[key] += calls * v

    def bound_by(self, name):
        r = self.r[name]
        return "operations" if r["ops"] >= r["mem"] else "bytes"


def measure(res, name, what, calls, fk, fp, fb, work, check):
    want = fp()
    got = fk()
    out = check(name, got, want)
    err, extra = (out if isinstance(out, tuple) else (out, None))
    del got, want
    tk = cuda_time_ms(fk)
    tp = cuda_time_ms(fp, iters=3, warmup=1)
    tb = cuda_time_ms(fb)
    res.add(name, calls, err, tk, tp, tb, work)
    b, by = bound_ms(work)
    frob = "" if extra is None else f", worst grad rel Frobenius {extra:.3g}"
    log(f"{name} {what}: max abs err {err:.3g}{frob}; kernel {tk:.4f} ms, "
        f"bound {b:.4f} ms ({by}), plain (f32 math) {tp:.4f} ms, library "
        f"chain {tb:.4f} ms")
    return tk, tp, tb


def kernel_phases(dev):
    """Each kernel against its plain version at the main-path shapes;
    returns the Results (K1-K4 per forward at batch 8, K5/K7/K8 per
    training step at batch 8, K6 per training step at batch 16)."""
    import torch

    from lavt_rs_tpu_torch.ops import fused_mlp, fused_msa, ln
    from lavt_rs_tpu_torch.ops.window import (relative_bias_from_table,
                                              relative_position_index_2d,
                                              shift_mask_2d)

    g = torch.Generator(device=dev).manual_seed(SEED)

    def rnd(shape, std=1.0, mean=0.0, dtype=torch.bfloat16):
        t = torch.randn(shape, generator=g, device=dev) * std + mean
        return t.to(dtype)

    res = Results()
    index = torch.from_numpy(relative_position_index_2d(12, 12)).to(dev)
    for si, (side, c, heads, depth) in enumerate(STAGES):
        rows = BATCH * side * side
        st = f"stage {si + 1}"
        # K4: the stage-output norm
        x = rnd((rows, c), 2.0, 0.5)
        s, b = rnd((c,), 0.2, 1.0), rnd((c,), 0.2)
        measure(res, "K4", f"{st} ({rows}, {c})", 1,
                lambda: ln.layer_norm_rows(x, s, b),
                lambda: ln.layer_norm_rows_plain(x, s, b),
                lambda: torch_bf16_ln(x, s, b), ln_work(rows, c), compare)
        # K3 / K8 / K7: the LN-MLP tail of every block (in training K3 in
        # block 0 only, where the drop-path rate is 0)
        args = (rnd((rows, c)), rnd((c,), 0.2, 1.0), rnd((c,), 0.2),
                rnd((4 * c, c), c ** -0.5), rnd((4 * c,), 0.2),
                rnd((c, 4 * c), (4 * c) ** -0.5), rnd((c,), 0.2))
        measure(res, "K3", f"{st} ({rows}, {c})", depth,
                lambda: fused_mlp.fused_ln_mlp(*args),
                lambda: fused_mlp.fused_ln_mlp_plain(*args),
                lambda: torch_bf16_mlp(*args), mlp_work(rows, c), compare)
        keep = torch.where(torch.arange(BATCH, device=dev) % 3 != 1,
                           1.0 / 0.7, 0.0).float()
        keep_rows = keep.repeat_interleave(side * side)[:, None].bfloat16()
        tail = side * side
        dp_blocks = depth - (1 if si == 0 else 0)
        measure(res, "K8", f"{st} ({rows}, {c}) keep", dp_blocks,
                lambda: fused_mlp.fused_ln_mlp_droppath(*args, keep, tail),
                lambda: fused_mlp.fused_ln_mlp_droppath_plain(*args, keep,
                                                              tail),
                lambda: torch_bf16_mlp(*args, keep_rows),
                mlp_work(rows, c, keep=BATCH), compare)
        gy = rnd((rows, c))
        x, gam, bet, w1, b1, w2, b2 = args
        variants = [(keep, dp_blocks)] + ([(None, 1)] if si == 0 else [])
        for kp, calls in variants:
            kr = None if kp is None else keep_rows
            measure(res, "K7", f"{st} ({rows}, {c}) keep {kp is not None}",
                    calls,
                    lambda: fused_mlp.fused_ln_mlp_bwd(x, gy, gam, bet, w1, b1,
                                                       w2, kp, tail),
                    lambda: fused_mlp.fused_ln_mlp_bwd_plain(
                        x, gy, gam, bet, w1, b1, w2, kp, tail),
                    chain_grad(lambda *t: torch_bf16_mlp(*t, kr), args, gy),
                    mlp_work(rows, c, backward=True), compare_grads)
        del args, gy, x, w1, w2
        # K1 at the unpadded stages, K2 at the padded ones (pad to 12k)
        hp = -(-side // 12) * 12
        nw = (hp // 12) ** 2
        name = "K1" if hp == side else "K2"
        xw = rnd((BATCH, nw, 144, c))
        w = (rnd((3 * c, c), c ** -0.5), rnd((3 * c,), 0.2),
             rnd((c, c), c ** -0.5), rnd((c,), 0.2))
        bias = relative_bias_from_table(
            torch.randn((23 * 23, heads), generator=g, device=dev), index)
        lnp = (rnd((c,), 0.2, 1.0), rnd((c,), 0.2)) if name == "K1" else None
        sc = (c // heads) ** -0.5
        for shift in (False, True):
            mask = shift_mask_2d(hp, hp, 12, 6, dev) if shift else None
            tail = (*w, bias, mask, heads, sc)
            if name == "K1":
                fk = lambda: fused_msa.fused_window_msa_ln(xw, *lnp, *tail)
                fp = lambda: fused_msa.fused_window_msa_ln_plain(xw, *lnp, *tail)
            else:
                fk = lambda: fused_msa.fused_window_msa(xw, *tail)
                fp = lambda: fused_msa.fused_window_msa_plain(xw, *tail)
            measure(res, name, f"{st} x{tuple(xw.shape)} heads {heads} mask "
                    f"{shift}", depth // 2, fk, fp,
                    lambda: torch_bf16_msa(xw, *tail, ln=lnp),
                    msa_work(BATCH, nw, c, heads, "fwd", mask=shift), compare)
        # training: save mode, K5 on the kernel's residuals, K6 (shift mask)
        mask = shift_mask_2d(hp, hp, 12, 6, dev)
        tail = (*w, bias, mask, heads, sc)
        measure(
            res, "save", f"{name} save mode {st} x{tuple(xw.shape)}", depth,
            lambda: fused_msa.fused_window_msa_save(xw, lnp, *tail),
            lambda: fused_msa.fused_window_msa_save_plain(xw, lnp, *tail),
            lambda: torch_bf16_msa(xw, *tail, ln=lnp),
            msa_work(BATCH, nw, c, heads, "save", ln=lnp is not None),
            lambda _n, got, want: compare_saved(name, got, want))
        y, saved = fused_msa.fused_window_msa_save(xw, lnp, *tail)
        xin = xw if lnp is None else saved[4].view(xw.shape)
        res_k5 = saved[:4]
        gy = rnd(xw.shape)
        chain_in = (xw, *w, bias) + tuple(lnp or ())

        def chain_fn(x_, wq, bq, wp, bp, bi, *lnt):
            return torch_bf16_msa(x_, wq, bq, wp, bp, bi, mask, heads, sc,
                                  ln=lnt or None)

        measure(res, "K5", f"{st} x{tuple(xw.shape)} heads {heads}", depth,
                lambda: fused_msa.fused_window_msa_bwd(xin, gy, w[0], w[2],
                                                       res_k5, heads, sc),
                lambda: fused_msa.fused_window_msa_bwd_plain(
                    xin, gy, w[0], w[2], res_k5, heads, sc),
                chain_grad(chain_fn, chain_in, gy),
                msa_work(BATCH, nw, c, heads, "bwd"), compare_grads)
        del y, saved, res_k5, xin
        batches = (BATCH, BATCH_BIG) if si == 0 else (BATCH,)
        for bsz in batches:
            xk = xw if bsz == BATCH else rnd((bsz, nw, 144, c))
            gk = gy if bsz == BATCH else rnd(xk.shape)
            calls = 2 if bsz == BATCH_BIG else 0
            measure(res, "K6", f"{st} x{tuple(xk.shape)} heads {heads}", calls,
                    lambda: fused_msa.fused_window_msa_bwd_recompute(
                        xk, lnp, *tail[:6], gk, heads, sc),
                    lambda: fused_msa.fused_window_msa_bwd_recompute_plain(
                        xk, lnp, *tail[:6], gk, heads, sc),
                    chain_grad(chain_fn, (xk,) + chain_in[1:], gk,
                               forward=True),
                    msa_work(bsz, nw, c, heads, "recompute",
                             ln=lnp is not None), compare_grads)
        del xw, gy
        torch.cuda.empty_cache()
    return res


# -- the main paths -------------------------------------------------------------

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
    from lavt_rs_tpu_torch.config import lavt_one_base
    from lavt_rs_tpu_torch.models.factory import build_model

    return meaningful(build_model(lavt_one_base(), dev, generator=g), dev, g)


def meaningful(model, dev, g):
    """Non-zero language gates and GPT-2-scaled BERT residual branches (see
    `main_path_model`), in place; returns the model."""
    import torch

    from lavt_rs_tpu_torch.models.bert import BertEncoder
    from lavt_rs_tpu_torch.models.pwam import LanguageGate

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


def train_batch(dev, g, batch):
    """A synthetic training batch: uint8 images, token ids with padded
    masks, a random binary target."""
    import torch

    image, ids, mask, _ = requests(dev, g, 1, batch)[0]
    target = torch.randint(0, 2, (batch, 480, 480), generator=g, device=dev)
    return {"image": image, "ids": ids[:, 0], "mask": mask[:, 0],
            "target": target}


def counters():
    from lavt_rs_tpu_torch.ops import fused_mlp, fused_msa, ln, window_attn

    return {"K1": fused_msa.fused_window_msa_ln,
            "K2": fused_msa.fused_window_msa,
            "K3": fused_mlp.fused_ln_mlp, "K4": ln.layer_norm_rows,
            "K5": fused_msa.fused_window_msa_bwd,
            "K6": fused_msa.fused_window_msa_bwd_recompute,
            "K7": fused_mlp.fused_ln_mlp_bwd,
            "K8": fused_mlp.fused_ln_mlp_droppath,
            "K10": window_attn.window_attention,
            "K2p": fused_msa.fused_window_msa_grouped,
            "K9": window_attn.attention_core_bwd}


def zero_counts():
    for fn in counters().values():
        fn.launches = 0


def read_counts():
    return {k: fn.launches for k, fn in counters().items()}


def check_counts(what, counts, per, times):
    """Every counter equals per[k] * times (0 where per has no entry)."""
    for k in counts:
        n = per.get(k, 0)
        if counts[k] != n * times:
            raise RuntimeError(f"{what}: {k} launched {counts[k]} times, "
                               f"expected {n * times}")


def inference(dev, card, model):
    """The fwd_iou main path, the f32 check and the forward timing;
    returns its launch counts."""
    import torch

    from lavt_rs_tpu_torch.eval.refcoco_eval import fwd_iou
    from lavt_rs_tpu_torch.models.factory import build_model
    from lavt_rs_tpu_torch.ops.norm import maybe_normalize_image

    cfg = model.cfg
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    batches = requests(dev, g, N_REQUESTS)
    zero_counts()
    results = [fwd_iou(model, *b) for b in batches]
    torch.cuda.synchronize()
    launches = read_counts()
    log(f"inference launches over {N_REQUESTS} batches of {BATCH}: {launches}")
    check_counts("inference", launches,
                 {"K1": 4, "K2": 20, "K3": 24, "K4": 4, "K5": 0, "K6": 0,
                  "K7": 0, "K8": 0}, N_REQUESTS)
    for inter, union in results:
        if inter.shape != (BATCH, 1) or not bool(torch.isfinite(union).all()):
            raise RuntimeError("fwd_iou: bad inter/union")
        if bool((inter > union).any()):
            raise RuntimeError("fwd_iou: intersection above union")
    iou = torch.cat([i / u.clamp(min=1) for i, u in results]).mean().item()
    log(f"fwd_iou: mean IoU vs random targets {iou:.4f}")

    # one batch against the f32 plain path
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

    iters, plain_iters = 20, 5
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
    return launches


def train_setup(dev, weights):
    """lavt_one_base built for training with `weights`, its AdamW and the
    train step."""
    from lavt_rs_tpu_torch.config import lavt_one_base
    from lavt_rs_tpu_torch.models.factory import build_model
    from lavt_rs_tpu_torch.train.optim import TrainConfig
    from lavt_rs_tpu_torch.train.step import (create_train_state,
                                              make_train_step)

    model = build_model(lavt_one_base(), dev, train=True)
    model.load_state_dict(weights)
    tcfg = TrainConfig()
    opt, sched = create_train_state(model, tcfg)
    return make_train_step(model, opt, sched, tcfg)


def training(dev, card, weights):
    """Steps at batch 8 (timed, counted, loss falls) and one at batch 16;
    returns the launches at batch 8 and at batch 16."""
    import torch

    step = train_setup(dev, weights)
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    batch = train_batch(dev, g, BATCH)

    def gen():
        return torch.Generator(device=dev).manual_seed(SEED + 3)

    t0 = time.perf_counter()
    step(batch, gen())
    torch.cuda.synchronize()
    log(f"train step bs {BATCH}, first (warm-up): "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    outs = [step(batch, gen()) for _ in range(TRAIN_STEPS)]
    end.record()
    torch.cuda.synchronize()
    launches = read_counts()
    ms = start.elapsed_time(end) / TRAIN_STEPS
    log(f"train launches over {TRAIN_STEPS} steps of {BATCH}: {launches}")
    check_counts("train bs 8", launches, TRAIN_PER_STEP, TRAIN_STEPS)
    losses = [o["loss"].item() for o in outs]
    if not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"non-finite training loss: {losses}")
    log(f"train bs {BATCH} bf16 (kernels, AdamW, DropPath 0.3, dropout 0.1): "
        f"{ms:.3f} ms/step, {BATCH * 1000 / ms:.2f} img/s (mean of "
        f"{TRAIN_STEPS} steps); peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB  [{card}]")
    log(f"loss over {TRAIN_STEPS} steps on one batch (dropout reseeded each "
        f"step): first {losses[0]:.6f}, last {losses[-1]:.6f}; all "
        f"{[round(v, 6) for v in losses]}; iou {outs[-1]['iou'].item():.4f}, "
        f"lr {outs[-1]['lr']:.6g}")
    if not losses[-1] < losses[0]:
        raise RuntimeError("the training loss did not fall")

    big = train_batch(dev, g, BATCH_BIG)
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    out = step(big, gen())
    loss = out["loss"].item()
    big_launches = read_counts()
    log(f"train step bs {BATCH_BIG}: loss {loss:.6f}, "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms (one step, host clock), "
        f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"launches {big_launches}")
    if not math.isfinite(loss):
        raise RuntimeError("non-finite loss at batch 16")
    check_counts("train bs 16", big_launches, BIG_PER_STEP, 1)
    return launches, big_launches


def gate_run(dev, cfg, weights, bn_batch_stats, batch, seed):
    """One forward + backward of the train-mode model (dropout and DropPath
    on, drawn from `seed`); BatchNorm on its batch statistics or on its
    running ones.  A video batch ('video', 'valid_index') takes the loss on
    its annotated frames.  Returns (loss, {parameter: f32 grad})."""
    import torch

    from lavt_rs_tpu_torch.losses import get_loss
    from lavt_rs_tpu_torch.models.factory import build_model
    from lavt_rs_tpu_torch.ops.norm import maybe_normalize_image

    m = build_model(cfg, dev, train=True)
    m.load_state_dict(weights)
    if not bn_batch_stats:
        for mod in m.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.eval()
    dt = cfg.compute_dtype
    pixels = batch["video"] if "video" in batch else batch["image"]
    with torch.autocast(dev.type, dtype=dt, enabled=dt != torch.float32):
        out = m(maybe_normalize_image(pixels), batch["ids"], batch["mask"],
                generator=torch.Generator(device=dev).manual_seed(seed))
    if "video" in batch:
        b, t = pixels.shape[:2]
        out = out.reshape(b, t, *out.shape[1:])[
            torch.arange(b, device=dev), batch["valid_index"]]
    loss = get_loss("cross_entropy")(out.float(), batch["target"])
    loss.backward()
    grads = {}
    for name, p in m.named_parameters():
        if p.grad is not None:
            if not bool(torch.isfinite(p.grad).all()):
                raise RuntimeError(f"gate: non-finite gradient of {name}")
            grads[name] = p.grad.float()
    return loss.item(), grads


def block_cosines(a, b):
    """Cosine of each Swin block's concatenated parameter grads."""
    import torch

    blocks = {}
    for name, g in a.items():
        parts = name.split(".")
        if parts[0] == "backbone" and parts[3:4] == ["blocks"]:
            pair = blocks.setdefault(".".join(parts[1:5]), ([], []))
            pair[0].append(g.flatten())
            pair[1].append(b[name].flatten())
    cos = {}
    for key, (x, y) in blocks.items():
        x, y = torch.cat(x), torch.cat(y)
        cos[key] = (x @ y / (x.norm() * y.norm()).clamp(min=1e-30)).item()
    return cos


def training_gate(dev, weights):
    """Kernel route (bf16) vs plain route (f32 math, TF32 off) from the same
    weights, batch and generator seed, dropout and DropPath on.  Checked
    with BatchNorm on its running statistics: in train mode BN's backward
    subtracts the batch means of its gradient, which amplifies bf16
    rounding in any bf16 route; that comparison (and a bf16 route without
    the kernels) is printed beside it.  Returns the worst checked cosine."""
    import torch

    from lavt_rs_tpu_torch.config import lavt_one_base

    batch = train_batch(dev, torch.Generator(device=dev).manual_seed(SEED + 4),
                        BATCH)
    seed = SEED + 5

    def cfg(kernels, dtype):
        return lavt_one_base().replace(use_kernels=kernels, dtype=dtype)

    ref_loss, ref = gate_run(dev, cfg(False, "float32"), weights, False,
                             batch, seed)
    loss, got = gate_run(dev, cfg(True, "bfloat16"), weights, False, batch,
                         seed)
    rel = abs(loss - ref_loss) / abs(ref_loss)
    cos = block_cosines(got, ref)
    worst = min(cos, key=cos.get)
    del ref, got
    log(f"training gate (BN running statistics, dropout + DropPath on): loss "
        f"kernel route (bf16) {loss:.6f}, plain route (f32 math) "
        f"{ref_loss:.6f}, rel diff {rel:.3g} (limit {LOSS_RTOL}); "
        f"{len(cos)} Swin blocks, worst gradient cosine {cos[worst]:.5f} "
        f"({worst}, limit {MIN_COS}); all gradients finite")
    log("per-block cosines: " + ", ".join(f"{k} {v:.4f}"
                                          for k, v in cos.items()))
    if rel > LOSS_RTOL:
        raise RuntimeError(f"gate: loss rel diff {rel:.4g} > {LOSS_RTOL}")
    if cos[worst] < MIN_COS:
        raise RuntimeError(f"gate: cosine {cos[worst]:.5f} < {MIN_COS}")
    # BN on batch statistics (the training recipe): printed, not checked
    ref_loss_b, ref_b = gate_run(dev, cfg(False, "float32"), weights, True,
                                 batch, seed)
    for kernels, what in ((True, "kernel route"),
                          (False, "plain modules under bf16 autocast")):
        loss_b, got_b = gate_run(dev, cfg(kernels, "bfloat16"), weights, True,
                                 batch, seed)
        cb = block_cosines(got_b, ref_b)
        del got_b
        log(f"BN batch statistics, {what} (bf16) vs plain route (f32): loss "
            f"{loss_b:.6f} vs {ref_loss_b:.6f}, worst Swin-block cosine "
            f"{min(cb.values()):.5f}, mean {sum(cb.values()) / len(cb):.5f}")
    return cos[worst]


# -- video: K10 and K2p, then the lavt_video main path ------------------------------

def masked_windows(mask):
    """Windows of an (nW, N, N) shift mask that mask anything."""
    return 0 if mask is None else int((mask != 0).flatten(1).any(1).sum())


def attn_work(b, nw, heads, n, masked=0):
    """K10: q kᵀ and P v (4 N² hd flops per window and head); bytes: q, k,
    v and O in bf16, the f32 bias and the f32 mask of the `masked` windows
    whose mask is not all zero."""
    hd = 32
    m = b * nw * heads
    return (4 * m * n * n * hd,
            4 * m * n * hd * 2 + heads * n * n * 4 + masked * n * n * 4)


def attn_save_work(b, nw, heads, n, masked=0):
    """K10's save mode: K10's work plus each row's f32 lse written."""
    flops, nbytes = attn_work(b, nw, heads, n, masked)
    return flops, nbytes + b * nw * heads * n * 4


def attn_bwd_work(b, nw, heads, n, masked=0):
    """K9: five N x N x hd products (10 N² hd flops) per window and head;
    bytes: q, k, v, o, do read and dq, dk, dv written in bf16, the f32 lse
    read, the f32 bias read and dbias written, and the f32 mask of the
    `masked` windows whose mask is not all zero."""
    hd = 32
    m = b * nw * heads
    return (10 * m * n * n * hd,
            8 * m * n * hd * 2 + m * n * 4 + 2 * heads * n * n * 4
            + masked * n * n * 4)


def padded_msa_work(b, nw, n, c, heads, masked):
    """K2p at the real token count n (the function needs none of the
    padding): the qkv and out-projection GEMMs (8 rows C²) and 4 n² hd per
    window and head; bytes: x in, y out, the weights, the bias and the mask
    of the `masked` windows."""
    rows = b * nw * n
    flops = 8 * rows * c * c + 4 * b * nw * heads * n * n * 32
    nbytes = (2 * rows * c * 2 + 4 * c * c * 2 + 4 * c * 2
              + heads * n * n * 4 + masked * n * n * 4)
    return flops, nbytes


def sdpa_mask(bias, mask, nw):
    """bias (h, N, N) + mask (nW, N, N) as one bf16 (nW, h, N, N) additive
    mask for `scaled_dot_product_attention` (timing baseline only)."""
    import torch

    full = bias[None].expand(nw, *bias.shape)
    if mask is not None:
        full = full + mask[:, None]
    return full.to(torch.bfloat16).contiguous()


def video_kernel_phases(dev, res):
    """K10 at the stage-2..4 shapes (and N = 196), K2p at stage 1, against
    their plain versions; per clip into `res`."""
    import torch
    import torch.nn.functional as F

    from lavt_rs_tpu_torch.ops import fused_msa, window_attn
    from lavt_rs_tpu_torch.ops.window import (partition_3d_groups,
                                              relative_bias_from_table_3d,
                                              relative_position_index_3d,
                                              shift_mask_3d)

    g = torch.Generator(device=dev).manual_seed(SEED + 10)

    def rnd(shape, std=1.0):
        return (torch.randn(shape, generator=g, device=dev) * std).bfloat16()

    index = torch.from_numpy(relative_position_index_3d(8, 7, 7)).to(dev)

    def bias_of(heads, n):
        table = torch.randn((15 * 13 * 13, heads), generator=g, device=dev)
        return relative_bias_from_table_3d(table, index, n)

    sc = 32 ** -0.5
    for si, (side, c, heads, depth) in enumerate(VIDEO_STAGES):
        hp = -(-side // 7) * 7
        nw = (hp // 7) ** 2
        shift_mask = None
        if si == 0:
            # K2p: 392 tokens padded to 400, windows grouped unmasked-first
            n, n_p = 392, 400
            w = (rnd((3 * c, c), c ** -0.5), rnd((3 * c,), 0.2),
                 rnd((c, c), c ** -0.5), rnd((c,), 0.2))
            xw = rnd((1, nw, n_p, c))
            xw[:, :, n:] = 0
            bias = fused_msa.pad_bias_sublane(bias_of(heads, n), n_p)
            for shift in (False, True):
                ss = (0, 3, 3) if shift else (0, 0, 0)
                nu, mask = partition_3d_groups(FRAMES, side, side, FRAMES, hp,
                                               hp, (8, 7, 7), ss, n_p, dev)
                args = (xw, *w, bias, mask, nu, heads, sc)
                full = None
                if mask is not None:
                    full = torch.cat([mask.new_zeros((nu, n_p, n_p)), mask])
                am = sdpa_mask(bias, full, nw)

                def chain(x=xw, am=am, w=w):
                    qkv = F.linear(x, w[0], w[1]).view(nw, n_p, 3, heads, 32)
                    q, k, v = qkv.permute(2, 0, 3, 1, 4)
                    o = F.scaled_dot_product_attention(q, k, v, attn_mask=am,
                                                       scale=sc)
                    return F.linear(o.transpose(1, 2).reshape(1, nw, n_p, c),
                                    w[2], w[3])

                measure(res, "K2p", f"stage 1 x{tuple(xw.shape)} heads "
                        f"{heads} nu {nu}", 1,
                        lambda a=args: fused_msa.fused_window_msa_grouped(*a),
                        lambda a=args: fused_msa.fused_window_msa_grouped_plain(
                            *a),
                        chain, padded_msa_work(1, nw, n, c, heads,
                                               masked_windows(mask)),
                        lambda name, got, want: compare(
                            name, got[:, :, :n], want[:, :, :n], TOL["K2"]))
                del am
            del xw
            continue
        # K10 on the stage's pre-projected heads
        n = 392
        q, k, v = (rnd((1, nw, heads, n, 32)) for _ in range(3))
        bias = bias_of(heads, n)
        for shift in (False, True):
            mask = None
            if shift:
                mask = shift_mask_3d(FRAMES, hp, hp, (8, 7, 7), (0, 3, 3), dev)
            am = sdpa_mask(bias, mask, nw)
            measure(res, "K10", f"stage {si + 1} q{tuple(q.shape)} mask "
                    f"{shift}", depth // 2,
                    lambda m=mask: window_attn.window_attention(q, k, v, bias,
                                                                m, sc),
                    lambda m=mask: window_attn.window_attention_plain(
                        q, k, v, bias, m, sc),
                    lambda am=am: F.scaled_dot_product_attention(
                        q[0], k[0], v[0], attn_mask=am, scale=sc),
                    attn_work(1, nw, heads, n, masked_windows(mask)),
                    lambda name, got, want: compare(name, got, want,
                                                    TOL["K2"]))
            del am
        if si == 1:  # a 4-frame clip's stage-2 windows (N = 196): checked
            n4 = 196
            q4, k4, v4 = (rnd((1, nw, heads, n4, 32)) for _ in range(3))
            b4 = bias_of(heads, n4)
            got = window_attn.window_attention(q4, k4, v4, b4, None, sc)
            err = compare("K10", got, window_attn.window_attention_plain(
                q4, k4, v4, b4, None, sc), TOL["K2"])
            log(f"K10 N = 196 q{tuple(q4.shape)}: max abs err {err:.3g}")
            res.r["K10"]["err"] = max(res.r["K10"]["err"], err)
        del q, k, v
        torch.cuda.empty_cache()


def video_model(dev, g, **kw):
    """lavt_video_tiny in bf16 from seeded weights, made meaningful as
    `main_path_model` makes lavt_one (the 3D self-gates are off in the A2D
    recipe)."""
    from lavt_rs_tpu_torch.config import lavt_video_tiny
    from lavt_rs_tpu_torch.models.factory import build_model

    return meaningful(build_model(lavt_video_tiny(**kw), dev, generator=g),
                      dev, g)


def clips(dev, g, n):
    """A2D-style requests: an 8-frame 480² uint8 clip, 22 token ids with a
    padded mask, the annotated frame and its binary target."""
    import numpy as np
    import torch

    rng = np.random.default_rng(SEED + 11)
    out = []
    for _ in range(n):
        video = torch.randint(0, 256, (FRAMES, 480, 480, 3), generator=g,
                              device=dev, dtype=torch.uint8)
        ids = torch.from_numpy(rng.integers(1000, 20000, VIDEO_TOKENS))
        mask = torch.zeros(VIDEO_TOKENS, dtype=torch.int64)
        mask[:int(rng.integers(5, VIDEO_TOKENS + 1))] = 1
        target = torch.from_numpy(rng.random((480, 480)) > 0.5).to(torch.uint8)
        out.append((video, ids.to(dev), mask.to(dev),
                    int(rng.integers(0, FRAMES)), target.to(dev)))
    return out


def profile_clip(fn, card, what="video clip"):
    """One call of fn (a clip, a step) under torch.profiler: device busy
    time and the kernels that take it, by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        # user annotations (Optimizer.step#AdamW.step) span kernels: skip
        annotation = (getattr(e, "is_user_annotation", False)
                      or e.key.startswith("Optimizer."))
        if (us > 0 and e.device_type == torch.autograd.DeviceType.CUDA
                and not annotation):
            rows.append((us / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    log(f"{what} under torch.profiler: wall {wall:.3f} ms (host clock, "
        f"profiler on), device busy {busy:.3f} ms, idle share "
        f"{max(0.0, 1 - busy / wall):.3f}  [{card}]")
    for ms, count, key in rows[:20]:
        log(f"  {ms:9.3f} ms {100 * ms / busy:5.1f}% x{count:4d} {key[:110]}")


def video(dev, card, res):
    """The lavt_video main path: clip_iou on N_CLIPS clips (launch counts),
    the f32 check, the timing and a profile; returns the launch counts and
    the model's weights."""
    import torch

    from lavt_rs_tpu_torch.eval.video_eval import clip_iou
    from lavt_rs_tpu_torch.models.factory import build_model
    from lavt_rs_tpu_torch.ops.norm import maybe_normalize_image

    video_kernel_phases(dev, res)
    log("video kernel phases done")
    g = torch.Generator(device=dev).manual_seed(SEED + 12)
    t0 = time.perf_counter()
    model = video_model(dev, g)
    cfg = model.cfg
    log(f"lavt_video_tiny build ({cfg.dtype}, use_kernels={cfg.use_kernels}, "
        f"grouped padded route at stage 1): "
        f"{time.perf_counter() - t0:.2f} s")
    reqs = clips(dev, g, N_CLIPS)
    zero_counts()
    results = [clip_iou(model, *r) for r in reqs]
    torch.cuda.synchronize()
    launches = read_counts()
    log(f"video launches over {N_CLIPS} clips: {launches}")
    check_counts("video", launches, VIDEO_PER_CLIP, N_CLIPS)
    for inter, union in results:
        if not (bool(torch.isfinite(union)) and 0 <= inter.item() <= union.item()):
            raise RuntimeError(f"clip_iou: bad inter/union {inter}, {union}")
    iou = sum(i.item() / max(u.item(), 1.0) for i, u in results) / N_CLIPS
    log(f"clip_iou: mean IoU vs random targets {iou:.4f}")

    video_u8, ids, mask, valid, _ = reqs[0]
    clip = maybe_normalize_image(video_u8)[None]
    with torch.no_grad():
        logits = model(clip, ids[None], mask[None])
    if tuple(logits.shape) != (FRAMES, 480, 480, 2):
        raise RuntimeError(f"video logits shape {tuple(logits.shape)}")
    if not bool(torch.isfinite(logits).all()):
        raise RuntimeError("non-finite video logits")
    ref = build_model(cfg.replace(dtype="float32", use_kernels=False), dev)
    ref.load_state_dict(model.state_dict())
    with torch.no_grad():
        want = ref(clip, ids[None], mask[None])
    del ref
    got, want = logits[valid], want[valid]
    margin = (want[..., 1] - want[..., 0]).abs()
    sure = margin > MARGIN
    agree = (got.argmax(-1) == want.argmax(-1))[sure].float().mean().item()
    log(f"video bf16 kernel route vs f32 plain route, annotated frame "
        f"{valid}: max |dlogit| {(got - want).abs().max().item():.4g}, logit "
        f"scale {want.abs().max().item():.4g}, argmax agreement {agree:.5f} "
        f"on {sure.float().mean().item():.3f} of pixels (margin > {MARGIN})")
    if not agree >= MIN_AGREE:
        raise RuntimeError(f"video argmax agreement {agree:.5f} < {MIN_AGREE}")

    def fwd(m):
        return lambda: m(clip, ids[None], mask[None])

    iters, plain_iters = 20, 5
    with torch.no_grad():
        ms = cuda_time_ms(fwd(model), iters=iters, warmup=3)
        plain = build_model(cfg.replace(use_kernels=False), dev)
        plain.load_state_dict(model.state_dict())
        plain_ms = cuda_time_ms(fwd(plain), iters=plain_iters, warmup=2)
        del plain
        log(f"video forward, one 8-frame 480² clip, bf16 with kernels: "
            f"{ms:.3f} ms/clip, {FRAMES * 1000 / ms:.2f} frames/s (mean of "
            f"{iters}); plain versions (bf16 weights, f32 math, TF32 off): "
            f"{plain_ms:.3f} ms/clip, {FRAMES * 1000 / plain_ms:.2f} "
            f"frames/s (mean of {plain_iters})  [{card}]")
        profile_clip(fwd(model), card)
    weights = model.state_dict()
    del model
    torch.cuda.empty_cache()
    return launches, weights


# -- video training: K10's save mode and K9, then the train step -----------------

def video_train_kernel_phases(dev, res):
    """K10's save mode and K9 at every stage's shape of an 8-frame 480² clip
    (stage 1 too: training keeps it off K2p), shifted and unshifted, plus
    N = 196 (a 4-frame clip's stage 2) and N = 49 (window-7 2D), each
    against its plain version; per training step into `res` ("K10s",
    "K9").  K9's library call: autograd through K10's SDPA chain with the
    bias requiring grad (bias + mask as one bf16 mask)."""
    import torch
    import torch.nn.functional as F

    from lavt_rs_tpu_torch.ops import window_attn as wa
    from lavt_rs_tpu_torch.ops.window import (relative_bias_from_table,
                                              relative_bias_from_table_3d,
                                              relative_position_index_2d,
                                              relative_position_index_3d,
                                              shift_mask_2d, shift_mask_3d)

    g = torch.Generator(device=dev).manual_seed(SEED + 20)

    def rnd(shape, std=1.0):
        return (torch.randn(shape, generator=g, device=dev) * std).bfloat16()

    index = torch.from_numpy(relative_position_index_3d(8, 7, 7)).to(dev)
    sc = 32 ** -0.5
    cases = []  # (label, calls per step, heads, N, nW, bias, mask)
    for si, (side, c, heads, depth) in enumerate(VIDEO_STAGES):
        hp = -(-side // 7) * 7
        nw = (hp // 7) ** 2
        table = torch.randn((15 * 13 * 13, heads), generator=g, device=dev)
        bias = relative_bias_from_table_3d(table, index, 392)
        for shift in (False, True):
            mask = (shift_mask_3d(FRAMES, hp, hp, (8, 7, 7), (0, 3, 3), dev)
                    if shift else None)
            cases.append((f"stage {si + 1} mask {shift}", depth // 2, heads,
                          392, nw, bias, mask))
    table = torch.randn((15 * 13 * 13, 6), generator=g, device=dev)
    cases.append(("4-frame stage 2 mask True", 0, 6, 196, 81,
                  relative_bias_from_table_3d(table, index, 196),
                  shift_mask_3d(4, 63, 63, (4, 7, 7), (0, 3, 3), dev)))
    table = torch.randn((13 * 13, 3), generator=g, device=dev)
    cases.append(("window-7 2D mask True", 0, 3, 49, 64,
                  relative_bias_from_table(
                      table, torch.from_numpy(
                          relative_position_index_2d(7, 7)).to(dev)),
                  shift_mask_2d(56, 56, 7, 3, dev)))
    for label, calls, heads, n, nw, bias, mask in cases:
        q, k, v = (rnd((1, nw, heads, n, 32)) for _ in range(3))
        masked = masked_windows(mask)
        am = sdpa_mask(bias, mask, nw)
        what = f"{label} q{tuple(q.shape)}"
        measure(res, "K10s", what, calls,
                lambda: wa.window_attention_save(q, k, v, bias, mask, sc),
                lambda: wa.window_attention_save_plain(q, k, v, bias, mask,
                                                       sc),
                lambda: F.scaled_dot_product_attention(
                    q[0], k[0], v[0], attn_mask=am, scale=sc),
                attn_save_work(1, nw, heads, n, masked), compare_lse)
        del am
        o, lse = wa.window_attention_save(q, k, v, bias, mask, sc)
        do = rnd(q.shape)

        def sdpa_chain(q_, k_, v_, b_, mask=mask, nw=nw):
            return F.scaled_dot_product_attention(
                q_[0], k_[0], v_[0], attn_mask=sdpa_mask(b_, mask, nw),
                scale=sc)

        measure(res, "K9", what, calls,
                lambda: wa.attention_core_bwd(q, k, v, bias, mask, do, sc, o,
                                              lse),
                lambda: wa.attention_core_bwd_plain(q, k, v, bias, mask, do,
                                                    sc, o),
                chain_grad(sdpa_chain, (q, k, v, bias), do[0]),
                attn_bwd_work(1, nw, heads, n, masked),
                lambda name, got, want: compare_grads(name, got, want, 3))
        del q, k, v, o, lse, do
        torch.cuda.empty_cache()


def video_train_batch(dev, g):
    """One A2D training clip: an 8-frame 480² uint8 clip, 22 token ids with
    a padded mask, the annotated frame's index and binary target."""
    import torch

    video, ids, mask, valid, _ = clips(dev, g, 1)[0]
    target = torch.randint(0, 2, (1, *video.shape[1:3]), generator=g,
                           device=dev)
    return {"video": video[None], "ids": ids[None], "mask": mask[None],
            "target": target,
            "valid_index": torch.tensor([valid], device=dev)}


def video_training_gate(dev, weights):
    """The lavt_one gate for lavt_video_tiny: kernel route (bf16; K10 save
    mode and K9 in every 3D block) vs plain route (f32 math, TF32 off) from
    the same weights, clip and generator seed, DropPath and dropout on, BN
    on its running statistics; the loss on the annotated frame within
    LOSS_RTOL and every 3D block's parameter gradients (relative-position
    tables included) with cosine >= MIN_COS.  Checked with the language
    gates at zero, as `init_weights` draws them and a fine-tuning run
    starts: through non-zero gates, SepTPWAM's InstanceNorms carry bf16
    rounding into the residual stream in any bf16 route (worst cosine
    ~0.976 for the plain modules under bf16 autocast, ~0.979 with the
    kernels); both are printed for the `meaningful` gates, not checked.
    Returns the worst checked cosine."""
    import torch

    from lavt_rs_tpu_torch.config import lavt_video_tiny

    batch = video_train_batch(
        dev, torch.Generator(device=dev).manual_seed(SEED + 21))
    seed = SEED + 22
    f32 = lavt_video_tiny(use_kernels=False, dtype="float32")
    zero_gates = {k: torch.zeros_like(v) if ".res_gate." in k else v
                  for k, v in weights.items()}
    ref_loss, ref = gate_run(dev, f32, zero_gates, False, batch, seed)
    zero_counts()
    loss, got = gate_run(dev, lavt_video_tiny(), zero_gates, False, batch,
                         seed)
    launches = read_counts()
    check_counts("video gate", launches, VIDEO_TRAIN_PER_STEP, 1)
    rel = abs(loss - ref_loss) / abs(ref_loss)
    cos = block_cosines(got, ref)
    tables = [k for k in got if k.endswith("relative_position_bias_table")]
    del got, ref
    if len(cos) != 12 or len(tables) != 12:
        raise RuntimeError(f"video gate: {len(cos)} blocks, {len(tables)} "
                           "bias tables with gradients, expected 12")
    worst = min(cos, key=cos.get)
    log(f"video training gate (language gates 0, BN running statistics, "
        f"DropPath + dropout on): loss kernel route (bf16) {loss:.6f}, plain "
        f"route (f32 math) {ref_loss:.6f}, rel diff {rel:.3g} (limit "
        f"{LOSS_RTOL}); 12 3D blocks, worst gradient cosine {cos[worst]:.5f} "
        f"({worst}, limit {MIN_COS}); launches {launches}")
    log("per-block cosines: " + ", ".join(f"{k} {v:.4f}"
                                          for k, v in cos.items()))
    if rel > LOSS_RTOL:
        raise RuntimeError(f"video gate: loss rel diff {rel:.4g} > {LOSS_RTOL}")
    if cos[worst] < MIN_COS:
        raise RuntimeError(f"video gate: cosine {cos[worst]:.5f} < {MIN_COS}")
    # the language gates N(0, GATE_STD): printed, not checked
    ref_loss_g, ref_g = gate_run(dev, f32, weights, False, batch, seed)
    for kernels, what in ((True, "kernel route"),
                          (False, "plain modules under bf16 autocast")):
        loss_g, got_g = gate_run(dev, lavt_video_tiny(use_kernels=kernels),
                                 weights, False, batch, seed)
        cg = block_cosines(got_g, ref_g)
        del got_g
        log(f"language gates N(0, {GATE_STD}), {what} (bf16) vs plain route "
            f"(f32): loss {loss_g:.6f} vs {ref_loss_g:.6f}, worst 3D-block "
            f"cosine {min(cg.values()):.5f}, mean "
            f"{sum(cg.values()) / len(cg):.5f}")
    return cos[worst]


def video_training(dev, card, weights):
    """lavt_video_tiny's training step (`make_video_train_step`: uint8 clip
    normalized on the card, forward with DropPath 0.1 and BERT dropout 0.1,
    the loss on the annotated frame, backward, AdamW, poly LR): a warm-up
    step, then TRAIN_STEPS timed steps on one clip with the generator
    reseeded every step (launch counts, ms/step, clips/s, peak memory, the
    loss must fall), then one step under torch.profiler.  Returns the
    launch counts."""
    import torch

    from lavt_rs_tpu_torch.config import lavt_video_tiny
    from lavt_rs_tpu_torch.models.factory import build_model
    from lavt_rs_tpu_torch.train.optim import TrainConfig
    from lavt_rs_tpu_torch.train.step import (create_train_state,
                                              make_video_train_step)

    model = build_model(lavt_video_tiny(), dev, train=True)
    model.load_state_dict(weights)
    tcfg = TrainConfig()
    step = make_video_train_step(model, *create_train_state(model, tcfg), tcfg)
    batch = video_train_batch(
        dev, torch.Generator(device=dev).manual_seed(SEED + 23))

    def gen():
        return torch.Generator(device=dev).manual_seed(SEED + 24)

    t0 = time.perf_counter()
    step(batch, gen())
    torch.cuda.synchronize()
    log(f"video train step, first (warm-up): "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    outs = [step(batch, gen()) for _ in range(TRAIN_STEPS)]
    end.record()
    torch.cuda.synchronize()
    launches = read_counts()
    ms = start.elapsed_time(end) / TRAIN_STEPS
    log(f"video train launches over {TRAIN_STEPS} steps: {launches}")
    check_counts("video train", launches, VIDEO_TRAIN_PER_STEP, TRAIN_STEPS)
    losses = [o["loss"].item() for o in outs]
    if not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"non-finite video training loss: {losses}")
    log(f"video train step, one 8-frame 480² clip, bf16 (kernels, AdamW, "
        f"DropPath 0.1, BERT dropout 0.1): {ms:.3f} ms/step, "
        f"{1000 / ms:.3f} clips/s (mean of {TRAIN_STEPS} steps); peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB  [{card}]")
    log(f"video loss over {TRAIN_STEPS} steps on one clip (dropout reseeded "
        f"each step): first {losses[0]:.6f}, last {losses[-1]:.6f}; all "
        f"{[round(v, 6) for v in losses]}; iou {outs[-1]['iou'].item():.4f}, "
        f"lr {outs[-1]['lr']:.6g}")
    if not losses[-1] < losses[0]:
        raise RuntimeError("the video training loss did not fall")
    profile_clip(lambda: step(batch, gen()), card, "video train step")
    del model, step
    torch.cuda.empty_cache()
    return launches


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
    from lavt_rs_tpu_torch.ops import cuda_lib

    # the plain versions and the f32 reference models run full f32 GEMMs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    t_start = time.perf_counter()

    t0 = time.perf_counter()
    cuda_lib.lib()
    log(f"kernel build+load: {time.perf_counter() - t0:.2f} s "
        f"(nvcc {cuda_lib.build_seconds} s)")

    # -- kernel phases ----------------------------------------------------
    res = kernel_phases(dev)
    for k in NAMES[:8] + ("save",):
        r = res.r[k]
        log(f"{k} per {'forward' if k < 'K5' else 'train step'}: kernel "
            f"{r['ms']:.3f} ms, bound {r['bound']:.3f} ms ({res.bound_by(k)}), "
            f"plain (f32 math) {r['plain']:.3f} ms, library chain "
            f"{r['lib']:.3f} ms")
    log(f"kernel phases done at {time.perf_counter() - t_start:.1f} s")

    # -- inference main path -------------------------------------------------
    cfg = lavt_one_base()
    t0 = time.perf_counter()
    model = main_path_model(dev, torch.Generator(device=dev).manual_seed(SEED))
    log(f"model build ({cfg.dtype}, use_kernels={cfg.use_kernels}): "
        f"{time.perf_counter() - t0:.2f} s")
    infer_launches = inference(dev, card, model)
    weights = model.state_dict()
    del model
    torch.cuda.empty_cache()
    log(f"inference done at {time.perf_counter() - t_start:.1f} s")

    # -- video main path (its kernel phases first) ---------------------------------
    video_launches, video_weights = video(dev, card, res)
    for k in ("K10", "K2p"):
        r = res.r[k]
        log(f"{k} per clip: kernel {r['ms']:.3f} ms, bound {r['bound']:.3f} ms "
            f"({res.bound_by(k)}), plain (f32 math) {r['plain']:.3f} ms, "
            f"library {r['lib']:.3f} ms")
    log(f"video done at {time.perf_counter() - t_start:.1f} s")

    # -- video training main path (its kernel phases first) ------------------------
    video_train_kernel_phases(dev, res)
    for k in ("K10s", "K9"):
        r = res.r[k]
        log(f"{'K10 save mode' if k == 'K10s' else k} per video train step: "
            f"kernel {r['ms']:.3f} ms, bound {r['bound']:.3f} ms "
            f"({res.bound_by(k)}), plain (f32 math) {r['plain']:.3f} ms, "
            f"library {r['lib']:.3f} ms")
    video_training_gate(dev, video_weights)
    torch.cuda.empty_cache()
    video_train_launches = video_training(dev, card, video_weights)
    del video_weights
    log(f"video training done at {time.perf_counter() - t_start:.1f} s")

    # -- training main path ----------------------------------------------------
    training_gate(dev, weights)
    torch.cuda.empty_cache()
    log(f"gate done at {time.perf_counter() - t_start:.1f} s")
    train_launches, big_launches = training(dev, card, weights)
    log(f"training done at {time.perf_counter() - t_start:.1f} s")

    launches = {k: infer_launches[k] for k in ("K1", "K2", "K3", "K4")}
    launches.update({k: train_launches[k] for k in ("K5", "K7", "K8")})
    launches["K6"] = big_launches["K6"]
    launches.update({k: video_launches[k] for k in ("K10", "K2p")})
    launches["K9"] = video_train_launches["K9"]
    kernels = []
    for k in NAMES:
        r = res.r[k]
        kernels.append({"name": k, "route": "cuda", "source": SOURCES[k],
                        "replaces": REPLACES[k], "launches": launches[k],
                        "max_abs_err": r["err"], "ms": r["ms"],
                        "plain_ms": r["plain"], "bound_ms": r["bound"],
                        "bound_by": res.bound_by(k), "library_ms": r["lib"]})
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
