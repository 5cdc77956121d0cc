#!/usr/bin/env python3
"""Times the f32 variants that run on the 3xTF32 GEMM core and the f32
attentions (K7 f32, K3 f32, K8 f32, the K1/K2 save mode f32, K2 f32, K5
f32, K1 f32, K11 f32) at the lavt_one Swin-B 480² stage shapes, and K10
f32 in both modes at the window-7 bs-8 shapes (N = 49) and the video
stages 2-4 of an 8-frame 480² clip (N = 392), on one NVIDIA GPU, by CUDA
events, and prints one JSON object.

    python3 tools/time_f32_core.py [--root DIR] [--iters 10]

--root: the repository tree whose `lavt_rs_tpu_torch` to import (default:
this one), so that one command can time two trees on one card, in turns:

    python3 tools/time_f32_core.py --root <parent tree>
    python3 tools/time_f32_core.py
    python3 tools/time_f32_core.py
    python3 tools/time_f32_core.py --root <parent tree>

The JSON: {"card": ..., "ms": {kernel: {stage: ms per call}}, "step":
{kernel: ms}, "launches": {kernel: {stage: {launch: ms}}}}, "step"
summing each stage's call over the blocks that make it in a step
(depths 2, 2, 18, 2; the MSA kernels at their window-12
stages: the save mode and K5 at stages 2-4 of a bs-8 step, K2 at stages
3-4 of a bs-20 one, half the blocks shifted; K10 f32 ("K10.f32/w7" on the
qkv Linear's output, per window-7 bs-8 forward; "K10s.f32/w7" its save
mode, per step; "K10.f32" and "K10s.f32" per 8-frame clip and video step,
Video Swin-T depths 2, 6, 2 at stages 2-4), each stage's call the mean of
its unshifted and shifted windows, timed on the device with its launches
queued behind a device sleep: the host's time to enqueue a window-7 call
exceeds the call's).  K1 f32 at stages 1-2 and K11 f32 at stages 3-4 (the
window-12 bs-8 inference forward: "step" per forward, the blocks at each
stage, half shifted) are timed on the device, launches queued, per call
with the weights' lo parts as the model passes them, unshifted and
shifted ("stage s" and "stage s shifted"), and launch by launch
("launches": the LN rows, the lo split of both weights where the tree has
one, qkv, the attention, the out-projection); K6 f32 per bs-8 step (its
stage-1 calls) and K2p f32 per 8-frame clip (video stage 1, maskless and
grouped); K11 f32's out-projection
also at the M of two full waves of 132 output tiles and of three beside
the path's ("stage s out-projection waves": what its last, partial wave
costs).  Seeded inputs; TF32 off.
"""

import argparse
import json
import os
import subprocess
import sys

STAGES = ((120, 128, 4, 2), (60, 256, 8, 2), (30, 512, 16, 18),
          (15, 1024, 32, 2))  # (side, C, heads, depth) at 480², patch 4
# K10 f32: (B nW, nW, heads, N, blocks, key): window 7 at bs 8 (sides 120,
# 60, 30, 15 padded to 126, 63, 35, 21), Video Swin-T stages 2-4 of an
# 8-frame clip (sides 60, 30, 15 padded to 63, 35, 21)
K10_SHAPES = ((8 * 324, 324, 4, 49, 2, "w7"), (8 * 81, 81, 8, 49, 2, "w7"),
              (8 * 25, 25, 16, 49, 18, "w7"), (8 * 9, 9, 32, 49, 2, "w7"),
              (81, 81, 6, 392, 2, "video"), (25, 25, 12, 392, 6, "video"),
              (9, 9, 24, 392, 2, "video"))


def cuda_ms(fn, iters):
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def queued_ms(fn, iters):
    """Device ms of one call of fn, its launches queued behind a ~10 ms
    device sleep so that the host's time to enqueue them is not timed."""
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


def lo_kw(fused_msa, w):
    """{"wlo": (wqkv's, wproj's) lo parts} as the model passes them to the
    f32 MSA entry points, where the tree has them; else {}."""
    import inspect

    if "wlo" not in inspect.signature(fused_msa.gemm_bias).parameters:
        return {}
    return {"wlo": (fused_msa.tf32_lo(w[0]), fused_msa.tf32_lo(w[2]))}


def msa_f32(ms, step, launches, rnd, dev, iters):
    """K1 f32 (stages 1-2, window order, after the LN rows) and K11 f32
    (stages 3-4, map order) per call and launch by launch, on the device
    with their launches queued (`queued_ms`)."""
    import torch

    from lavt_rs_tpu_torch.ops import fused_msa, fused_msa_2d, ln
    from lavt_rs_tpu_torch.ops.window import (shift_mask_2d,
                                              shift_mask_flags_2d)

    sc = 32 ** -0.5
    for si, (side, c, heads, depth) in enumerate(STAGES):
        key = "K1.f32" if si < 2 else "K11.f32"
        hp = -(-side // 12) * 12
        nw = (hp // 12) ** 2
        w = (rnd((3 * c, c), c ** -0.5), rnd((3 * c,), 0.2),
             rnd((c, c), c ** -0.5), rnd((c,), 0.2), rnd((heads, 144, 144)))
        lnp = (rnd((c,), 0.2) + 1.0, rnd((c,), 0.2))
        kw = lo_kw(fused_msa, w)  # the lo parts as the model keeps them
        lo, has_lo = kw.get("wlo"), bool(kw)
        x = (rnd((8, nw, 144, c), 2.0) + 0.5 if key == "K1.f32"
             else rnd((8, hp, hp, c)))
        rows = x.numel() // c
        for shift in (False, True):
            mask = shift_mask_2d(hp, hp, 12, 6, dev) if shift else None
            flags = shift_mask_flags_2d(hp, hp, 12, 6, dev) if shift else None
            stage = f"stage {si + 1}" + (" shifted" if shift else "")
            if key == "K1.f32":
                def call():
                    return fused_msa.fused_window_msa_ln_f32(
                        x, *lnp, *w, mask, heads, sc, flags=flags, **kw)
            else:
                def call():
                    return fused_msa_2d.fused_window_msa_2d_f32(
                        x, *w, mask, heads, sc, 12, flags, **kw)
            ms[key][stage] = queued_ms(call, iters)
            step[key] += depth // 2 * ms[key][stage]
            x2 = x.reshape(rows, c)
            xn = ln.layer_norm_rows_launch(x2, *lnp) if key == "K1.f32" else x2
            glo = [{"wlo": t} if has_lo else {} for t in (lo or (None, None))]
            qkv = fused_msa.gemm_bias(xn, w[0], w[1], c, sc, **glo[0])
            if key == "K1.f32":
                def attn():
                    return fused_msa.msa_attn_f32(
                        qkv.view(-1, 144, 3 * c), w[4], mask, heads, flags)[0]
            else:
                def attn():
                    return fused_msa_2d.msa_attn_map_f32(
                        qkv.view(8, hp, hp, 3 * c), w[4], mask, heads, flags)
            o = attn().reshape(rows, c)
            parts = {}
            if key == "K1.f32":
                parts["LN rows"] = lambda: ln.layer_norm_rows_launch(x2, *lnp)
            if has_lo:
                parts["lo split"] = lambda: (fused_msa.tf32_lo(w[0]),
                                             fused_msa.tf32_lo(w[2]))
            parts["qkv"] = lambda: fused_msa.gemm_bias(xn, w[0], w[1], c, sc,
                                                       **glo[0])
            parts["attention"] = attn
            parts["out-projection"] = lambda: fused_msa.gemm_bias(
                o, w[2], w[3], **glo[1])
            launches.setdefault(key, {})[stage] = {
                name: queued_ms(fn, iters) for name, fn in parts.items()}
            del qkv, o
        if key == "K11.f32":  # the out-projection's last wave of tiles
            waves = {}
            n_tiles = c // 128  # 128 x 128 output tiles, 132 SMs
            for m_tiles in (264 // n_tiles, -(-rows // 128), 396 // n_tiles):
                a = rnd((m_tiles * 128, c))
                waves[f"M {m_tiles * 128} ({m_tiles * n_tiles} tiles)"] = \
                    queued_ms(lambda: fused_msa.gemm_bias(a, w[2], w[3],
                                                          **glo[1]), iters)
            launches[key][f"stage {si + 1} out-projection waves"] = waves
        del x
        torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("time_f32_core: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    from lavt_rs_tpu_torch.ops import fused_mlp as fm
    from lavt_rs_tpu_torch.ops import fused_msa
    from lavt_rs_tpu_torch.ops.window import (shift_mask_2d,
                                              shift_mask_flags_2d)

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    g = torch.Generator(device=dev).manual_seed(22)

    def rnd(shape, std=1.0):
        return torch.randn(shape, generator=g, device=dev) * std

    ms = {k: {} for k in ("K7.f32", "K3.f32", "K8.f32", "save.f32", "K5.f32",
                          "K2.f32", "K10.f32/w7", "K10s.f32/w7", "K10.f32",
                          "K10s.f32", "K1.f32", "K11.f32", "K6.f32", "K2p.f32")}
    step = dict.fromkeys(ms, 0.0)
    sc = 32 ** -0.5
    for si, (side, c, heads, depth) in enumerate(STAGES):
        rows, tail = 8 * side * side, side * side
        x = rnd((rows, c), 2.0) + 0.5
        mlp = (x, rnd((c,), 0.2) + 1.0, rnd((c,), 0.2), rnd((4 * c, c), c ** -0.5),
               rnd((4 * c,), 0.2), rnd((c, 4 * c), (4 * c) ** -0.5),
               rnd((c,), 0.2))
        keep = torch.where(torch.arange(8, device=dev) % 3 != 1, 1.0 / 0.7,
                           0.0)
        gy = rnd((rows, c))
        stage = f"stage {si + 1}"
        for key, fn in (
                ("K3.f32", lambda: fm.fused_ln_mlp_f32(*mlp)),
                ("K8.f32", lambda: fm.fused_ln_mlp_droppath_f32(*mlp, keep,
                                                                tail)),
                ("K7.f32", lambda: fm.fused_ln_mlp_bwd_f32(
                    x, gy, *mlp[1:6], keep, tail))):
            ms[key][stage] = cuda_ms(fn, args.iters)
            step[key] += depth * ms[key][stage]
        del x, gy, mlp
        if si == 0:  # K6 f32: stage 1 of a bs-8 step recomputes its MSA
            nw = (side // 12) ** 2
            w = (rnd((3 * c, c), c ** -0.5), rnd((3 * c,), 0.2),
                 rnd((c, c), c ** -0.5), rnd((c,), 0.2), rnd((heads, 144, 144)))
            lnp = (rnd((c,), 0.2) + 1.0, rnd((c,), 0.2))
            xw, gw = rnd((8, nw, 144, c), 2.0) + 0.5, rnd((8, nw, 144, c))
            kw = lo_kw(fused_msa, w)
            for shift in (False, True):
                mask = shift_mask_2d(side, side, 12, 6, dev) if shift else None
                flags = (shift_mask_flags_2d(side, side, 12, 6, dev) if shift
                         else None)
                t = cuda_ms(lambda: fused_msa.fused_window_msa_bwd_recompute_f32(
                    xw, lnp, *w, mask, gw, heads, sc, flags=flags, **kw),
                    args.iters)
                ms["K6.f32"][stage + (" shifted" if shift else "")] = t
                step["K6.f32"] += depth // 2 * t
            del xw, gw
            torch.cuda.empty_cache()
            continue
        hp = -(-side // 12) * 12
        nw = (hp // 12) ** 2
        w = (rnd((3 * c, c), c ** -0.5), rnd((3 * c,), 0.2),
             rnd((c, c), c ** -0.5), rnd((c,), 0.2), rnd((heads, 144, 144)))
        mask = shift_mask_2d(hp, hp, 12, 6, dev)
        flags = shift_mask_flags_2d(hp, hp, 12, 6, dev)
        lnp = (rnd((c,), 0.2) + 1.0, rnd((c,), 0.2)) if si < 2 else None
        for b, keys in ((8, ("save.f32", "K5.f32")), (20, ("K2.f32",))):
            if b == 20 and si < 2:
                continue
            xw = rnd((b, nw, 144, c))
            tl = (*w, mask, heads, sc)
            kw = lo_kw(fused_msa, w)
            if b == 8:
                y, saved = fused_msa.fused_window_msa_save_f32(
                    xw, lnp, *tl, flags=flags, **kw)
                xin = xw if lnp is None else saved[4].view(xw.shape)
                gw = rnd(xw.shape)
                fns = {"save.f32": lambda: fused_msa.fused_window_msa_save_f32(
                           xw, lnp, *tl, flags=flags, **kw),
                       "K5.f32": lambda: fused_msa.fused_window_msa_bwd_f32(
                           xin, gw, w[0], w[2], saved[:4], heads, sc)}
            else:
                fns = {"K2.f32": lambda: fused_msa.fused_window_msa_f32(
                    xw, *tl, flags=flags, exact=True, **kw)}
            for key in keys:
                ms[key][stage] = cuda_ms(fns[key], args.iters)
                step[key] += depth * ms[key][stage]
            del xw, fns
            torch.cuda.empty_cache()
    launches = {}
    msa_f32(ms, step, launches, rnd, dev, args.iters)
    # K2p f32: video stage 1 of an 8-frame 480² clip (324 windows of 392
    # tokens, C = 96, 3 heads), two calls a clip: maskless, and grouped
    # (the first half of the windows maskless, a mask on the rest)
    nw, n, c, heads = 324, 392, 96, 3
    w = (rnd((3 * c, c), c ** -0.5), rnd((3 * c,), 0.2), rnd((c, c), c ** -0.5),
         rnd((c,), 0.2))
    xw, bias = rnd((1, nw, n, c)), rnd((heads, n, n))
    small = torch.where(rnd((nw - nw // 2, n, n)) > 1.0, -100.0, 0.0)
    for name, mask, nu in (("maskless", None, nw), ("grouped", small, nw // 2)):
        t = cuda_ms(lambda: fused_msa.fused_window_msa_grouped_f32(
            xw, *w, bias, mask, nu, heads, sc), args.iters)
        ms["K2p.f32"][f"stage 1 {name}"] = t
        step["K2p.f32"] += t
    del xw, bias, small
    torch.cuda.empty_cache()
    from lavt_rs_tpu_torch.ops import window_attn as wa

    for bw, nw, heads, n, blocks, key in K10_SHAPES:
        sfx = "/w7" if key == "w7" else ""
        qkv = rnd((bw // nw, nw, n, 3 * heads * 32))
        q, k, v = (t.contiguous() for t in wa.qkv_heads(qkv, heads))
        bias = rnd((heads, n, n))
        mask = torch.where(rnd((nw, n, n)) > 1.0, -100.0, 0.0)
        stage = f"N {n} ({bw}, {heads})"
        for name, fn in (
                ("K10.f32" + sfx, lambda m: wa.window_attention_qkv(
                    qkv, bias, m, heads, sc)),
                ("K10s.f32" + sfx, lambda m: wa.window_attention_save(
                    q, k, v, bias, m, sc))):
            t = (queued_ms(lambda: fn(None), args.iters)
                 + queued_ms(lambda: fn(mask), args.iters)) / 2
            ms[name][stage] = t
            step[name] += blocks * t
        del qkv, q, k, v, mask
        torch.cuda.empty_cache()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader", "-i", "0"],
                          capture_output=True, text=True).stdout.strip()
    print(json.dumps({"root": os.path.abspath(args.root), "card": card,
                      "ms": ms, "step": step, "launches": launches}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
