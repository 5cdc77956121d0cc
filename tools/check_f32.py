#!/usr/bin/env python3
"""A quick check of the f32 variants (K1 f32, K11 f32, K3 f32, K4 f32) on
one NVIDIA GPU, shorter than chip_smoke.py's phase 3c.

    python3 tools/check_f32.py

Builds the kernels (printing ptxas -v for the f32 kernels), holds each
f32 variant against its f32 plain version at the lavt_one Swin-B 480²
bs-8 path shapes within 1e-4 abs + 1e-4 rel (TF32 off), printing each
one's max error, its worst error over the limit and its time per call
(CUDA events) beside its plain version's; then runs one bs-8 f32 forward
with the kernels (chip_smoke.py's `main_path_model` weights) and prints
its launch counts, its max |dlogit| against the plain f32 model, the
argmax agreement where the plain margin exceeds 1e-2, and both models'
ms a forward.  Exits 1 if a check fails.
"""

import contextlib
import io
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-4


def main():
    import torch

    if not torch.cuda.is_available():
        print("check_f32: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from lavt_rs_tpu_torch.config import lavt_one_base
    from lavt_rs_tpu_torch.models.factory import build_model
    from lavt_rs_tpu_torch.ops import (cuda_lib, fused_mlp, fused_msa,
                                       fused_msa_2d, ln)
    from lavt_rs_tpu_torch.ops.norm import maybe_normalize_image
    from lavt_rs_tpu_torch.ops.window import (shift_mask_2d,
                                              shift_mask_flags_2d)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True).stdout.strip())
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        cuda_lib.build(verbose=True)
    cuda_lib.lib()
    print(f"build {time.perf_counter() - t0:.1f} s")
    lines = out.getvalue().splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry" in line and any(
                k in line for k in ("g32", "msa32", "lnr32")):
            print("\n".join(lines[i:i + 4]))
    g = torch.Generator(device=dev).manual_seed(0)
    failed = []

    def rn(*shape, std=1.0):
        return torch.randn(*shape, generator=g, device=dev) * std

    def check(name, got, want):
        torch.cuda.synchronize()
        err = (got - want).abs()
        lim = TOL + TOL * want.abs()
        ok = bool((err <= lim).all()) and bool(torch.isfinite(got).all())
        print(f"{name}: max abs err {err.max().item():.3e}, worst err / "
              f"limit {(err / lim).max().item():.3f}, scale "
              f"{want.abs().max().item():.3g} {'ok' if ok else 'FAILED'}",
              flush=True)
        if not ok:
            failed.append(name)

    def ms(fn):
        return cs.cuda_time_ms(fn, iters=10, warmup=2)

    for side, c, _, _ in cs.STAGES:
        rows = 8 * side * side
        x, s, b = rn(rows, c), 1 + rn(c, std=0.1), rn(c, std=0.1)
        check(f"K4 f32 {rows}x{c}", ln.layer_norm_rows_f32(x, s, b),
              ln.layer_norm_rows_plain(x, s, b))
        args = (x, s, b, rn(4 * c, c, std=c ** -0.5), rn(4 * c, std=0.02),
                rn(c, 4 * c, std=(4 * c) ** -0.5), rn(c, std=0.02))
        got = fused_mlp.fused_ln_mlp_f32(*args)
        want = fused_mlp.fused_ln_mlp_plain(*args)
        check(f"K3 f32 {rows}x{c}", got, want)
        check(f"K3 f32 branch {rows}x{c}", got - x, want - x)
        print(f"  ms a call: K4 f32 "
              f"{ms(lambda: ln.layer_norm_rows_f32(x, s, b)):.4f}, plain "
              f"{ms(lambda: ln.layer_norm_rows_plain(x, s, b)):.4f}; K3 f32 "
              f"{ms(lambda: fused_mlp.fused_ln_mlp_f32(*args)):.4f}, plain "
              f"{ms(lambda: fused_mlp.fused_ln_mlp_plain(*args)):.4f}")

    def msa_weights(c, heads):
        return (rn(3 * c, c, std=c ** -0.5), rn(3 * c, std=0.02),
                rn(c, c, std=c ** -0.5), rn(c, std=0.02),
                rn(heads, 144, 144, std=0.02))

    sc = 32 ** -0.5
    for side, c, heads, _ in cs.STAGES[:2]:
        x = rn(8, (side // 12) ** 2, 144, c)
        lnp = (1 + rn(c, std=0.1), rn(c, std=0.1))
        w = msa_weights(c, heads)
        for shift in (False, True):
            mask = shift_mask_2d(side, side, 12, 6, dev) if shift else None
            flags = (shift_mask_flags_2d(side, side, 12, 6, dev) if shift
                     else None)

            def k1():
                return fused_msa.fused_window_msa_ln_f32(
                    x, *lnp, *w, mask, heads, sc, flags=flags)

            def plain():
                return fused_msa.fused_window_msa_ln_plain(x, *lnp, *w, mask,
                                                           heads, sc)

            check(f"K1 f32 C={c} shifted={shift}", k1(), plain())
            print(f"  ms a call: K1 f32 {ms(k1):.4f}, plain {ms(plain):.4f}")
    for b, hp, wp, c, heads, shift, _ in cs.K11_CASES[:5]:
        x = rn(b, hp, wp, c)
        w = msa_weights(c, heads)
        mask = shift_mask_2d(hp, wp, 12, 6, dev) if shift else None
        flags = shift_mask_flags_2d(hp, wp, 12, 6, dev) if shift else None
        args = (x, *w, mask, heads, sc, 12)
        check(f"K11 f32 {(b, hp, wp, c)} shifted={shift}",
              fused_msa_2d.fused_window_msa_2d_f32(*args, flags),
              fused_msa_2d.fused_window_msa_2d_plain(*args))
        print(f"  ms a call: K11 f32 "
              f"{ms(lambda: fused_msa_2d.fused_window_msa_2d_f32(*args, flags)):.4f}")

    cfg = lavt_one_base(dtype="float32")
    gm = torch.Generator(device=dev).manual_seed(0)
    model = cs.meaningful(build_model(cfg, dev, generator=gm), dev, gm)
    image, ids, mask, _ = cs.requests(dev, gm, 1)[0]
    img = maybe_normalize_image(image)
    cs.zero_counts()
    with torch.no_grad():
        logits = model(img, ids[:, 0], mask[:, 0])
    torch.cuda.synchronize()
    print(f"launches of one forward: {cs.nonzero_counts(cs.read_counts())}")
    ref = build_model(cfg.replace(use_kernels=False), dev)
    ref.load_state_dict(model.state_dict())
    with torch.no_grad():
        want = ref(img, ids[:, 0], mask[:, 0])
        sure = (want[..., 1] - want[..., 0]).abs() > 1e-2
        agree = (logits.argmax(-1) == want.argmax(-1))[sure].float().mean()
        print(f"forward: max |dlogit| "
              f"{(logits - want).abs().max().item():.3e}, logit scale "
              f"{want.abs().max().item():.3g}, argmax agreement "
              f"{agree.item():.6f} on {sure.float().mean().item():.4f} of "
              f"the pixels (plain margin > 1e-2)")
        print(f"ms a bs-8 forward: f32 with the kernels "
              f"{ms(lambda: model(img, ids[:, 0], mask[:, 0])):.3f}, plain "
              f"f32 {cs.cuda_time_ms(lambda: ref(img, ids[:, 0], mask[:, 0]), iters=3, warmup=1):.3f}")
    print("FAILED: " + ", ".join(failed) if failed else "all checks ok")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
