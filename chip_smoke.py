#!/usr/bin/env python3
"""Smoke test of the PyTorch port (lavt_rs_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root, one card

1. Prints the card's name and power limit, then builds the hand-written
   CUDA kernels from `lavt_rs_tpu_torch/csrc` with nvcc (sm_90a) and
   prints ptxas's registers and spills of K2p's and P1/P2's kernels.
2. Kernel phases: each kernel on seeded bf16 inputs at the shapes the
   main paths give it (lavt_one Swin-B 480², batch 8; K6 also at stage 1
   with batch 16), against its plain PyTorch version (f32 math from the
   same bf16 inputs, TF32 off), within a stated tolerance:
     * inference: K1 fused LN+window MSA, K2 window MSA, K3 fused LN-MLP,
       K4 row LN;
     * training: K1/K2 in save mode, K5 (MSA backward from the saved
       residuals), K6 (MSA backward, recomputing), K7 (LN-MLP backward,
       with and without the DropPath keep), K8 (LN-MLP with DropPath),
       K4b (the row LN's backward: dx within 2e-2 abs + rel, dscale and
       dbias within 1e-3 relative Frobenius; two calls give the same
       bits).
   K4 at each stage is also timed on the device (launches queued) beside
   K3's two-pass LN-rows launch and `F.layer_norm`; K4b's library call is
   autograd through bf16 `F.layer_norm`.
   K1, K2, the save mode and K6's forward run the launches of
   `fused_msa.save_launches` (K4's LN rows for K1, the qkv projection and
   the out-projection on the GEMM core, csrc/fused_msa_sm90.cu's
   attention between them); K1's output must have the bits of the save
   mode's y, and its device time per forward (launches queued) is printed
   beside its CUDA-event time; at the end of the run (9.) each of those
   launches is timed on the device at every stage (K1's at stages 1-2,
   K2's at 3-4, the save mode's at all four), and a stage-1 save mode,
   K1, K2 and K6 call run under torch.profiler (only the port's kernels).
   K1 and K2 are timed beside both library chains (the matmul
   chain and linear / SDPA / linear; the faster is their yardstick); the
   save mode's yardstick is the matmul chain (SDPA returns no P).
   Then the kernel, the plain version and the library chain (a bf16
   PyTorch chain of the same math: bf16 F.linear / matmul / F.layer_norm
   for a forward, autograd backward through that chain for a backward)
   are timed with CUDA events, and each call's bound (the larger of its
   bytes over 3.35 TB/s and its operations over 989 TFLOP/s) is printed
   beside its time.  K3 and K8 are held to their plain version on out and
   on the MLP branch out - x (so that the residual does not hide a branch
   error).  At each stage's shape (and Swin-T stage 3's in phase 7) every
   launch of K3/K8 (LN rows, fc1 + GELU, fc2 + residual) and of K7 (prep,
   dual GEMM, the two weight-grad GEMMs, dyln, LN backward) is timed on
   the device (torch.profiler) beside its bound; each entry point's
   device time beside its library chain's (the CUDA-event times above
   include the host's time to enqueue, which dominates the autograd chain
   of K7's yardstick at stages 2-4) and its host time per call; and (in
   9.) one K3, one K8 and one K7 call run under torch.profiler, which
   must see
   only the port's own kernels (no cuBLAS, cuDNN or CUTLASS library
   kernel).  K5's (and K6's) library call is the faster, in this run, of
   autograd through the matmul chain and through a linear / 4-D SDPA /
   linear chain (which one won is printed); two K5 calls must give the
   same bits, and (at the end of the run, 9.) each K5 call's launches
   (dattn and dx GEMMs, attention, weight-grad GEMMs, column and partial
   sums) are timed on the device and a stage-1 call runs under
   torch.profiler (only the port's kernels).
   K11 (the window MSA over a padded, pre-rolled
   feature map: the qkv GEMM over the map's rows, csrc/fused_msa_sm90.cu's
   attention in map order, the out-projection GEMM) is checked at stages
   3 and 4, unshifted and shifted, on a non-square map and at the
   stage-1/2 shapes, must give the bits of the K2 launches on the
   partitioned map (window_partition -> K2 -> window_reverse, the route
   it replaces), and is timed beside its bound, its plain version, an
   SDPA chain (partition, linear, `scaled_dot_product_attention`, linear,
   reverse) and that route; its device time per forward (launches
   queued) is printed beside its CUDA-event time, and at the end of the
   run (9.) its three launches are timed on the device at each path shape
   and one call runs under torch.profiler (only the port's kernels).
3. Inference main path: lavt_one Swin-B / window 12 / 480² / 12-layer
   BERT in bf16 from seeded random weights (`main_path_model`) answers
   three batches of 8 RefCOCO-style requests (uint8 images, 20 token ids
   with padded masks, packed targets) through `eval.refcoco_eval.fwd_iou`.
   The kernels' launch counters must show every routed call (K1 in the 4
   unpadded blocks of stages 1-2, K11 in the 20 padded blocks of stages
   3-4, K3 in all 24, K4 4; K2 none: it stays on the training path).  One
   batch's
   logits are checked against the same weights run through the plain path
   in f32.  Then the bf16 forward at batch 8 is timed, with the kernels
   and with the plain versions, and one forward runs under torch.profiler
   (device busy, printed beside the figure measured on K1's and K11's
   first design).
3b. RefCOCO eval main path: a synthetic RefCOCO split (48 val refs of
   1-3 sentences, 640x480 JPEGs with polygon masks, a vocab.txt) written
   to a temporary directory and the same weights saved as a reference
   .pth; `lavt_rs_tpu_torch.cli.test.main` evaluates it in process
   (--window12, 480², bf16, the kernels): its Final line, the launch
   counts per device batch (as the inference forward), sentences/s and
   ms per device batch; a warm rerun of `evaluate`, one batch under
   `torch.profiler` (device busy beside the first K1/K11 design's
   figure, idle share), and the gate: the first
   batch's argmax against the f32 plain model (the pixel gate below),
   and both models' summaries and their differences.
3c. f32 inference main path (`--no_bf16` with the kernels: the f32
   variants K1 f32, K11 f32, K3 f32, K4 f32), with TF32 off for every
   f32 product outside the kernels (the flags printed):
     * each f32 variant on seeded f32 inputs at its path shapes (K1 f32 at
       stages 1-2, K11 f32 at stages 3-4 and a non-square map, each
       shifted and unshifted; K3 f32 and K4 f32 at C = 128, 256, 512,
       1024) against its f32 plain version within 1e-4 abs + 1e-4 rel,
       timed (CUDA events; on the device with its launches queued) beside
       its bound (f32 bytes over 3.35 TB/s, operations over 165 TFLOP/s:
       495 TFLOP/s TF32 over 3xTF32's three passes), its plain version
       and its f32 library chain (TF32 off: the faster of the matmul and
       linear / SDPA / linear chains; F.linear / F.gelu; F.layer_norm);
     * lavt_one Swin-B window-12 f32 with the kernels, on the main path's
       weights, answers three batches of 8 through `fwd_iou`: the f32
       counters must equal the model's `kernel_plan` at itemsize 4 (K1 4,
       K11 20, K3 24, K4 4 a forward) and every bf16 counter stay 0; the
       gate against the plain f32 model on the same weights (max |dlogit|
       <= 1e-2, the same argmax wherever the plain margin exceeds 1e-2);
       ms a batch and img/s beside the plain model's, peak memory, one
       forward under torch.profiler (device busy, idle share), and the
       Swin blocks of every stage under it, which must launch no cuBLAS,
       cuDNN or attention library kernel;
     * `cli.test.main --window12 --no_bf16` on 3b's split and .pth with
       the kernels (launches per device batch as the forward's) and with
       --no_pallas: both summaries, mIoU and oIoU within 0.005, and
       sentences/s of each.
   The phase prints its seconds.
4. Video phase: K10 (attention on pre-projected heads) at the stage-2..4
   shapes of an 8-frame 480² clip (N = 392) and at N = 196, K2p (the
   padded fused MSA) at the stage-1 shape, maskless and grouped, each
   against its plain version, timed beside its bound, its plain version
   and its library call (one `scaled_dot_product_attention` for K10, a
   bf16 linear / SDPA / linear chain for K2p); K2p's three launches (qkv
   GEMM, K10's kernel, out-projection GEMM) each timed on the device
   beside its bound, and one K2p call with nu = 0 under the full mask
   (`fused_window_msa_padded`) against K2's plain version.  Then lavt_video
   (Video Swin-T, SepTPWAM, 12-layer BERT, the A2D recipe) in bf16 from
   seeded random weights answers three 8-frame 480² clips through
   `eval.video_eval.clip_iou`; the counters must show K2p twice and K10
   ten times per clip.  K10's launch plan (persistent blocks of two
   warpgroups, waves, units of 64 query rows per warpgroup, bias loads per
   block) is printed at every shape it is timed at, here, in the video
   training phase and at window 7.  One clip's annotated frame is checked against the
   f32 plain route, the forward is timed (ms per clip, frames/s, with and
   without the kernels) and one clip is broken down by `torch.profiler`.
   Video training: K10's save mode and K9 at every stage (and N = 196,
   49) against their plain versions (K9 with the masks' window flags),
   two K9 calls giving the same bits, and at the end of the run (9.) K9's
   two launches and its dbias sum timed on the device with their plan and
   a masked stage-1 call under torch.profiler (only the port's kernels);
   the training gate, 10 timed steps, a profiler breakdown, then one step
   with --use_checkpoint (every 3D block recomputed: K10's save mode 24 /
   K9 12 per step), whose peak device memory must be below the unflagged
   step's.
4b. A2D evaluation at the reference's clip length: `lavt_rs_tpu_torch.
   cli.test.main` in process with the A2D recipe's flags (VIDEO_RECIPE,
   whose config is lavt_video_tiny), --dataset a2d --clip_length 16, the
   video phase's weights as a reference .pth (--checkpoint), bf16 with the
   kernels, on A2D_CLIPS in-memory 16-frame 480² clips (h5py does not
   import on the card's machine, so the mp4 + h5 readers are held by the
   CPU tests only).  Two temporal windows of 8 and a live temporal shift
   of 4, which 8-frame clips never have.  The launches per clip must equal
   `kernel_plan(cfg, 480, 16)`; prints the summary, ms per clip (the
   CLI's cold run and a warm rerun of `evaluate_a2d`), clips/s, frames/s,
   peak memory and one clip under torch.profiler (idle share); the
   annotated frame passes the pixel gate against the f32 plain model.
4c. YTVOS inference: `lavt_rs_tpu_torch.cli.test_ytvos.main` in process
   on two whole JPEG videos written by the phase (20 frames of 720x1280
   and 13 of 360x640, two expressions each: temporal padding), with the
   same weights: unchunked and with --chunk_frames 8 --chunk_halo 8, each
   through the kernels and through the plain f32 route (--no_pallas
   --no_bf16).  Checks the PNGs' count and sizes, the launches against the
   kernel plan at each forward's length (none on the plain route) and
   every forward's logits against the same forward of the plain route by
   the pixel gate; prints ms per video, frames/s, the host's seconds
   (decode in the producer thread, the loop's wait on it, PNG writes),
   the device's idle share over the unchunked loop (rerun under
   torch.profiler) and the chunked masks' agreement with the unchunked
   ones (not gated).  Each video CLI run starts with the shift masks
   cached per geometry released (`ops.window.clear_device_caches`), and
   the phase ends so: the later phases' peak memory holds none of its.
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
     * one bs-8 step with --use_checkpoint (every 2D block recomputed:
       the save mode and K8/K3 twice per block), its launch counts equal
       to the model's `kernel_plan`, its peak device memory below the
       unflagged step's;
     * first, the gate: one forward + backward of the kernel route (bf16)
       and of the plain route (`use_kernels=False`, f32 math, TF32 off)
       from the same weights, batch and generator seed with every dropout
       on and BatchNorm on its running statistics: the losses agree within
       1e-2 relative, each Swin block's concatenated parameter gradients
       have cosine >= 0.98, all gradients are finite.  With BN on its batch
       statistics its backward amplifies bf16 rounding in any bf16 route;
       those cosines, for the kernel route and for the plain modules under
       bf16 autocast, are printed and not checked.
5b. Train CLI: `lavt_rs_tpu_torch.cli.train.main` in process on the
   eval phase's synthetic split (its TRAIN_REFS train refs; the val refs
   for the per-epoch eval) at the published configuration (--window12,
   Swin-B, 480², bf16, -b 8, -j 4, --aug_random_hflip 0.5; weights drawn
   by the CLI from its seed): epoch 0 into a temporary --output-dir, then
   --resume on that directory for epoch 1.  The launch counts per step
   must equal TRAIN_PER_STEP and per eval batch INFER_PER_FORWARD; two
   checkpoint files tagged with their eval's mIoU / oIoU; the resumed
   model, AdamW moments and schedule step equal the file's bitwise; the
   test CLI on the directory reproduces the last in-train eval within
   0.01 mIoU and oIoU.  Prints steps/s, img/s, the loader's data wait
   against the iteration time, peak device memory and the median ms per
   step beside `make_train_step`'s on one repeated batch (5.).  Epoch 0
   starts from a Swin-B window-7 ImageNet checkpoint written by the phase
   (seeded, 336 MiB f32, with the head, final norm and geometry buffers)
   through --pretrained_swin_weights: the model the CLI builds must hold
   the file's 325 tensors after the flag (the relative-position tables
   equal to the port's bicubic 7 -> 12 of the file's, computed on the CPU)
   and skip its other 39; prints the counts and the flag's seconds.

6. Window 7 (`lavt_one_base(window12=False)`, the CLIs' default): the
   launch counts of the models' own kernel plan (`kernel_plan`, from the
   routes the blocks take by the ported predicates) must equal the
   hand-written ones (window 12's and the video model's too); K10, K10's save mode and K9 at the
   four window-7 shapes (8, nW, h, 49, 32) against their plain versions,
   timed beside their bound and an SDPA chain; the bs-8 forward (counts
   K10 24 / K3 24 / K4 4 per forward, the pixel gate, ms and img/s, a
   profiler breakdown); the training gate and 10 steps at bs 8 (counts
   K10 24 / K9 24 / K8 23 / K3 1 / K7 24 / K4 4 / K4b 4 per step, falling
   loss).
7. The routing cases: the kernels at the widths the routing added (K4
   and K4b at 1536, K3/K8/K7 at 384, K1/K2/save/K5/K6/K11 at 96) against their plain
   versions with bound / plain / library times; forwards of Swin-T
   window 7, Swin-T window 12 (480² and 448², K1 and K11 at C = 96),
   Swin-L window 12 and lavt_video --window12, each with launch counts
   equal to its model's kernel plan, each route that launches no kernel printed
   with its reason (every one a route where the JAX package runs XLA), and
   the pixel gate against the f32 plain model; f32 with the kernels
   refused, naming the variants still missing, before any launch or
   allocation where a kernel of the plan has no f32 variant (window-7
   inference, window-12 training); one Swin-T window-12 training
   step at bs 2 (the save mode and K5 at C = 96).
8. P1 / P2 (the head-batching probe) against their plain version on an
   input whose softmax is far from uniform (x at std 0.4, 1e-3 abs +
   2e-2 rel; a kernel writing each window's mean or a copy of x is shown
   to fail that check), timed at the tool's shapes beside their bound and
   `scaled_dot_product_attention(scale=1)`, each on the device with its
   launches queued behind a sleep (`queued_ms`; a loop of CUDA events
   times the host's enqueue at this size, printed beside); P1 against P2
   on the tool's input at its atol 1e-2; then the tool as a user runs it,
   whose launches the kernels line reports; P1's and P2's launch plans (their
   splits of a row block over blocks) are printed.  Then (in 9.) K10 (N =
   49 and 392), its save mode, its strided route on the qkv Linear's
   output, K2p (stage 1, shifted), P1 and P2 run under `torch.profiler`,
   which must
   see only the port's own kernels (no cuBLAS, cuDNN, flash or SDPA
   kernel).
9. The torch.profiler checks held back from the timed phases (`defer`),
   in a fresh Python process on the inputs of their phases: K5's and
   K9's (also window 7's) launch-by-launch device times, and every
   only-port-kernels check (K3 / K8 / K7 at each width, K5, K9, and
   those of 8.).  No timed window follows their profiler sessions, and
   none runs late in the long main process, where torch.profiler drops
   kernel records.  Last, the window-12 bs-8 training step under
   torch.profiler with the LN backward's two call sites labelled
   (`lavt_rs_tpu_torch/tools/profile_ln.py`): its device busy and the LN
   backward's device ms and launches a step, beside the figures of the
   plain chain that K4b replaced; each call site launches K4b and its
   partial sum, no more.

Exits non-zero on any failure, without CUDA, or without the package.
The last two lines are the per-kernel JSON and
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import contextlib
import functools
import io
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
TOL = {"K1": 3e-2, "K2": 3e-2, "K3": 2e-2, "K4": 2e-2, "K4b": 2e-2,
       "K8": 2e-2}
# save mode: the probabilities P (values ~1/144) within TOL_P abs + 3e-2 rel
TOL_P = 2e-3
# backward kernels: dx within TOL_DX (rms(want) + |want|), the rms standing
# for the tensor's scale; the weight, bias and bias-table grads (sums over
# all rows of bf16-rounded factors) within a relative Frobenius error of
# TOL_GRAD
TOL_DX = 3e-2
TOL_GRAD = 1e-2
# K4b (the LN backward): dx within TOL["K4b"] abs + rel, dscale and dbias
# (sums over the rows of f32 products) within TOL_LN_GRAD relative
# Frobenius
TOL_LN_GRAD = 1e-3
# training gate: kernel route (bf16) vs plain route (f32 math)
LOSS_RTOL, MIN_COS = 1e-2, 0.98
# main path vs the f32 plain path: argmax agreement on confident pixels
MARGIN, MIN_AGREE = 0.05, 0.995
# H100 SXM peaks (NVIDIA data sheet): dense bf16 tensor cores, HBM3
PEAK_FLOPS, PEAK_BYTES = 989e12, 3.35e12
NAMES = ("K1", "K2", "K3", "K4", "K4b", "K5", "K6", "K7", "K8", "K10", "K2p",
         "K9", "K11", "P1", "P2")
FORWARD_NAMES = ("K1", "K2", "K3", "K4")  # timed per forward, the rest per step
REPLACES = {
    "K1": "lavt_rs_tpu/ops/pallas/fused_msa.py:1415",
    "K2": "lavt_rs_tpu/ops/pallas/fused_msa.py:1261",
    "K3": "lavt_rs_tpu/ops/pallas/fused_mlp.py:111",
    "K4": "lavt_rs_tpu/ops/pallas/ln.py:63",
    "K4b": "lavt_rs_tpu/ops/pallas/ln.py:89",
    "K5": "lavt_rs_tpu/ops/pallas/fused_msa.py:672",
    "K6": "lavt_rs_tpu/ops/pallas/fused_msa.py:576",
    "K7": "lavt_rs_tpu/ops/pallas/fused_mlp.py:477",
    "K8": "lavt_rs_tpu/ops/pallas/fused_mlp.py:533",
    "K10": "lavt_rs_tpu/ops/pallas/window_attn.py:120",
    "K2p": "lavt_rs_tpu/ops/pallas/fused_msa.py:891",
    "K9": "lavt_rs_tpu/ops/pallas/window_attn.py:292",
    "K11": "lavt_rs_tpu/ops/pallas/experimental.py:71",
    "P1": "tools/probe_headbatch.py:88",
    "P2": "tools/probe_headbatch.py:92",
    "K1.f32": "lavt_rs_tpu/ops/pallas/fused_msa.py:1415",
    "K11.f32": "lavt_rs_tpu/ops/pallas/experimental.py:71",
    "K3.f32": "lavt_rs_tpu/ops/pallas/fused_mlp.py:111",
    "K4.f32": "lavt_rs_tpu/ops/pallas/ln.py:63",
}
SOURCES = {
    "K1": "lavt_rs_tpu_torch/csrc/fused_msa_sm90.cu",
    "K2": "lavt_rs_tpu_torch/csrc/fused_msa_sm90.cu",
    "K3": "lavt_rs_tpu_torch/csrc/fused_mlp.cu",
    "K4": "lavt_rs_tpu_torch/csrc/ln.cu",
    "K4b": "lavt_rs_tpu_torch/csrc/ln.cu",
    "K5": "lavt_rs_tpu_torch/csrc/fused_msa_bwd_sm90.cu",
    "K6": "lavt_rs_tpu_torch/csrc/fused_msa_bwd_sm90.cu",
    "K7": "lavt_rs_tpu_torch/csrc/fused_mlp_bwd.cu",
    "K8": "lavt_rs_tpu_torch/csrc/fused_mlp.cu",
    "K10": "lavt_rs_tpu_torch/csrc/window_attn_sm90.cu",
    "K2p": "lavt_rs_tpu_torch/csrc/window_msa_sm90.cu",
    "K9": "lavt_rs_tpu_torch/csrc/window_attn_bwd_sm90.cu",
    "K11": "lavt_rs_tpu_torch/csrc/fused_msa_sm90.cu",
    "P1": "lavt_rs_tpu_torch/csrc/probe_headbatch.cu",
    "P2": "lavt_rs_tpu_torch/csrc/probe_headbatch.cu",
    # K1 f32 and K11 f32: the attention launch (their GEMMs: gemm_f32.cu,
    # K1 f32's LN rows: ln.cu); K3 f32: its GEMMs (its LN rows: ln.cu)
    "K1.f32": "lavt_rs_tpu_torch/csrc/fused_msa_f32.cu",
    "K11.f32": "lavt_rs_tpu_torch/csrc/fused_msa_f32.cu",
    "K3.f32": "lavt_rs_tpu_torch/csrc/gemm_f32.cu",
    "K4.f32": "lavt_rs_tpu_torch/csrc/ln.cu",
}
# Swin-B at 480²: (tokens per side, C, heads, blocks) per stage
STAGES = ((120, 128, 4, 2), (60, 256, 8, 2), (30, 512, 16, 18),
          (15, 1024, 32, 2))
# launches per inference forward: K1 in the 4 unpadded blocks of stages
# 1-2, K11 in the 20 padded blocks of stages 3-4 (K2 only in training)
INFER_PER_FORWARD = {"K1": 4, "K11": 20, "K3": 24, "K4": 4}
# K11 at the map shapes of a bs-8 forward: (B, Hp, Wp, C, heads, shifted,
# calls per forward); stages 1-2 (unpadded, they keep K1) and a non-square
# map are checked and timed, not on the path
K11_CASES = ((8, 36, 36, 512, 16, False, 9), (8, 36, 36, 512, 16, True, 9),
             (8, 24, 24, 1024, 32, False, 1), (8, 24, 24, 1024, 32, True, 1),
             (2, 36, 24, 256, 8, True, 0), (8, 120, 120, 128, 4, False, 0),
             (8, 60, 60, 256, 8, False, 0))
# the eval phase's synthetic RefCOCO: val refs, images, sentences per ref
EVAL_REFS, EVAL_IMAGES, EVAL_MAX_SENTENCES = 48, 16, 3
# ... and its train refs, which the train CLI phase trains on (3 steps of
# BATCH an epoch)
TRAIN_REFS = 24
# the train CLI's val mIoU / oIoU against the test CLI's on its checkpoint
CLI_SUMMARY_TOL = 0.01
EVAL_WORDS = ("the", "a", "man", "woman", "dog", "cat", "left", "right",
              "red", "blue", "shirt", "on", "in", "near", "big", "small",
              "person", "car", "chair", "table", "white", "black", "middle",
              "front", "back", "guy", "girl", "with", "hat", "bike")
# launches per training step (batch 8; at batch 16 stage 1 takes K6)
TRAIN_PER_STEP = {"K1": 4, "K2": 20, "K3": 1, "K4": 4, "K4b": 4, "K5": 24,
                  "K6": 0, "K7": 24, "K8": 23}
BIG_PER_STEP = dict(TRAIN_PER_STEP, K5=22, K6=2)
# ... with --use_checkpoint: every block's recompute runs its forward
# kernels again (the save mode, counted as K1 / K2, and K8 or K3)
TRAIN_CKPT_PER_STEP = dict(TRAIN_PER_STEP, K1=8, K2=40, K3=2, K8=46)
# video Swin-T on an 8-frame 480² clip: (tokens per side, C, heads, blocks)
VIDEO_STAGES = ((120, 96, 3, 2), (60, 192, 6, 2), (30, 384, 12, 6),
                (15, 768, 24, 2))
FRAMES, VIDEO_TOKENS, N_CLIPS = 8, 22, 3
# the CLI flags of the A2D recipe (README.md:185, BASELINE.md): their
# model config is config.lavt_video_tiny()
VIDEO_RECIPE = ("--model", "lavt_video", "--swin_type", "tiny",
                "--conv3d_kernel_size_t", "3-3-3", "--conv3d_kernel_size_s",
                "1-1-1", "--w_t3x3_s1x1", "--mm_t3x3_s1x1")
# A2D evaluation at the reference's --clip_length: 16 consecutive frames,
# two temporal windows of 8 and a live temporal shift of 4.  h5py does not
# import on the card's machine (cv2 does), so the clips are built in memory
# and the disk readers (mp4 + h5) are held by the CPU tests alone
A2D_CLIP, A2D_CLIPS = 16, 32
# the video CLIs' --img_size: the recipe's 480
CLI_IMG = 480
# YTVOS inference of whole videos: (name, frames, original (h, w)), lengths
# that are not multiples of the temporal window; two expressions each
YTVOS_VIDEOS = (("vid20", 20, (720, 1280)), ("vid13", 13, (360, 640)))
YTVOS_EXPRESSIONS = 2
# the Swin-B window-7 ImageNet checkpoint of the weight-import check:
# tensors the train CLI's window-12 model takes (patch embedding 4, 24
# blocks of 13, 3 patch mergings of 3) and the ones it skips (the final
# norm and the head 4, 24 relative_position_index and 11 attn_mask buffers)
SWIN_B_LOADED, SWIN_B_SKIPPED = 325, 39
# launches per clip: K2p in both stage-1 blocks, K10 in the ten others
VIDEO_PER_CLIP = {"K10": 10, "K2p": 2}
# launches per video training step: every 3D block takes K10 (save mode)
# forward and K9 backward; no K2p in training
VIDEO_TRAIN_PER_STEP = {"K10": 12, "K9": 12}
# ... with --use_checkpoint: every block's recompute runs K10's save mode
# again
VIDEO_CKPT_PER_STEP = {"K10": 24, "K9": 12}
# window-7 Swin-B at 480² (lavt_one_base(window12=False)): (padded tokens
# per side, C, heads, blocks); every block runs qkv -> K10 -> proj
W7_STAGES = ((126, 128, 4, 2), (63, 256, 8, 2), (35, 512, 16, 18),
             (21, 1024, 32, 2))
W7_INFER_PER_FORWARD = {"K10": 24, "K3": 24, "K4": 4}
W7_TRAIN_PER_STEP = {"K10": 24, "K9": 24, "K8": 23, "K3": 1, "K7": 24,
                     "K4": 4, "K4b": 4}
# the f32 variants (phase 3c), their counters' names: K1 f32, K11 f32, K3
# f32, K4 f32
F32_NAMES = ("K1.f32", "K11.f32", "K3.f32", "K4.f32")
# each against its f32 plain version: abs + rel (3xTF32 products and f32
# sums in another order; one TF32 pass, ~5e-4 relative, fails it)
F32_TOL = 1e-4
# the f32 forward against the plain f32 model: max |dlogit|, and the margin
# above which the argmax must be the same
F32_GATE = 1e-2
# cli.test --no_bf16 with the kernels against --no_pallas: mIoU, oIoU
F32_CLI_TOL = 0.005
# the f32 variants' operation bound: 495 TFLOP/s TF32 over 3xTF32's three
# tensor-core passes
PEAK_FLOPS_F32 = 495e12 / 3
# device busy under torch.profiler on the first K1/K11 design (one
# H100 80GB HBM3 at 700 W, this script; PERF.md section 5), printed beside
# this run's
FIRST_DESIGN_BUSY = {
    "forward": "28.0-29.3 ms on the first K1/K11 design, PERF.md",
    "eval batch": "78.7-80.8 ms on the first K1/K11 design, PERF.md"}
# the window-12 bs-8 training step with the plain LN backward chain that
# K4b replaced (one H100 80GB HBM3 at 700 W,
# lavt_rs_tpu_torch/tools/profile_ln.py; PERF.md section 6), printed
# beside this run's
PLAIN_LN_BWD_STEP = ("device busy 74.076-74.126 ms, LN backward 4.834-4.836 "
                     "ms and 200 launches a step with the plain chain, "
                     "PERF.md")
# K4b's launch and its partial sum, at most, per LN backward call
LN_BWD_LAUNCHES_PER_CALL = 2
# the probe's defaults (tools/probe_headbatch.py): ch, heads, n, hd, grid
PROBE = (3, 4, 144, 32, 96)


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

def ln_work(rows, c, item=2):
    """K4 (item 2: bf16; 4: K4 f32): x read, y written, scale and bias."""
    return 8 * rows * c, 2 * rows * c * item + 2 * c * item


def ln_bwd_work(rows, c):
    """K4b: x and g read, dx written (bf16), the f32 scale read and dscale,
    dbias written; ~16 operations an element (stats, xhat, the two row
    means, dx, the column sums)."""
    return 16 * rows * c, 3 * rows * c * 2 + 3 * c * 4


def mlp_work(m, c, backward=False, keep=0, item=2):
    """K3/K8 forward: two GEMMs of 2 M C 4C; K7: five (hpre recomputed,
    dh, dW2, dW1, dyln).  Bytes: x (and gy) read, out (dx) written, the
    bf16 weights read (item 4: K3 f32's f32 tensors), the f32 weight grads
    written."""
    w = 8 * c * c * item + 5 * c * item
    if backward:
        return 40 * m * c * c, 3 * m * c * 2 + w + (8 * c * c + 7 * c) * 4
    return 16 * m * c * c, 2 * m * c * item + w + keep * 4


def msa_work(b, nw, c, heads, mode, ln=False, mask=True, item=2):
    """mode 'fwd' (K1/K2), 'save' (save mode), 'bwd' (K5) or 'recompute'
    (K6).  Operations: the qkv (6 rows C²) and out-projection (2 rows C²)
    GEMMs and two N x N x hd products per window and head forward; the
    backward's dattn (2), dx (6), dWqkv (6), dWproj (2 rows C²) GEMMs and
    five N x N x hd products, plus, recomputing, the qkv GEMM and q kᵀ.
    Activations and weights of `item` bytes (4: K1 f32 and K11 f32)."""
    n, hd = 144, 32
    rows, m = b * nw * n, b * nw
    att = 2 * m * heads * n * n * hd
    act = rows * c * item
    weights = 4 * c * c * item + 4 * c * item
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


def bound_ms(work, peak=PEAK_FLOPS):
    flops, nbytes = work
    t_ops, t_mem = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
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


def compare_ln_bwd(name, got, want):
    """K4b: (dx, dscale, dbias); dx within TOL abs + rel, the column sums
    by their relative Frobenius error (TOL_LN_GRAD); returns (dx's max abs
    error, the worse Frobenius error)."""
    import torch

    err = compare(name, got[0], want[0], TOL["K4b"])
    worst = 0.0
    for part, g, w in zip(("dscale", "dbias"), got[1:], want[1:]):
        if not bool(torch.isfinite(g).all()):
            raise RuntimeError(f"{name}: non-finite {part}")
        rel = ((g - w).norm() / w.norm().clamp(min=1e-30)).item()
        worst = max(worst, rel)
        if rel > TOL_LN_GRAD:
            raise RuntimeError(f"{name}: {part} relative Frobenius error "
                               f"{rel:.4g} > {TOL_LN_GRAD}")
    return err, worst


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


def compare_branch(name, got, want, x, tol=None):
    """K3/K8: the MLP branch out - x against the plain version's, within
    TOL abs + TOL rel of the branch plus one bf16 step of the output
    (2^-7 |out|: the kernel's and the plain version's f32 sums round to
    bf16 on either side of a boundary).  Checking out alone lets the
    residual x hide a branch error up to TOL |x|."""
    import torch

    torch.cuda.synchronize()
    tol = TOL[name] if tol is None else tol
    w_out = want.float()
    g, w = got.float() - x.float(), w_out - x.float()
    err = (g - w).abs()
    if not bool((err <= tol + tol * w.abs() + 2 ** -7 * w_out.abs()).all()):
        raise RuntimeError(f"{name}: the branch out - x disagrees with the "
                           f"plain version's (max abs err "
                           f"{err.max().item():.4g}, tol {tol} abs + {tol} "
                           f"rel + 2^-7 |out|)")
    return err.max().item()


def compare_out_and_branch(x, tol=None):
    """A check of K3/K8 on out and on the branch out - x."""
    return lambda name, got, want: max(compare(name, got, want, tol),
                                       compare_branch(name, got, want, x, tol))


def only_port_kernels(what, fns):
    """Runs fns under torch.profiler: every kernel they launch on the card
    must be one of the port's own (namespace lavt::, built from csrc into
    build/kernels), none of cuBLAS, cuDNN or a CUTLASS library; returns
    the kernels' names."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for fn in fns:  # warm: the build and the first launches happen here
        fn()
    torch.cuda.synchronize()
    names = set()
    for _ in range(3):  # a session can come back without device records
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for fn in fns:
                fn()
            torch.cuda.synchronize()
        names = {e.key for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0)) > 0}
        if names:
            break
    if not names:
        raise RuntimeError(f"{what}: torch.profiler recorded no kernel")
    foreign = sorted(n for n in names if "lavt::" not in n)
    if foreign:
        raise RuntimeError(f"{what}: launched kernels that are not the "
                           f"port's: {foreign}")
    short = sorted({n.split("(")[0].split("<")[0].replace("void ", "")
                    for n in names})
    log(f"{what} under torch.profiler: {len(names)} kernels, all the port's "
        f"({', '.join(short)})")
    return names


def mlp_launch_work(m, c, splits):
    """(operations, bytes) of each launch of K3/K8 and K7 at (M, C), hidden
    4C: each input read once and each output written once (the f32
    partials of the weight grads: `splits` of each)."""
    hd = 4 * c
    act, hid, w = m * c * 2, m * hd * 2, hd * c * 2
    rt, lb = -(-m // 64), -(-m // 64)
    return {
        "LN rows": (8 * m * c, 2 * act + 4 * c),
        "fc1+GELU": (2 * m * c * hd, act + w + 2 * hd + hid),
        "fc2+residual": (2 * m * hd * c, hid + w + 2 * act + 2 * c),
        "prep": (10 * m * c, 4 * act + 8 * m + 4 * c),
        "dual GEMM": (4 * m * c * hd, 2 * act + 2 * w + 2 * hid + 4 * rt * hd),
        "wgrad": (4 * m * c * hd, 2 * act + 2 * hid + 2 * splits * 4 * hd * c),
        "dyln": (2 * m * hd * c, hid + w + 4 * m * c),
        "LN bwd": (12 * m * c, 4 * m * c + 3 * act + 8 * m + 12 * lb * c),
    }


def _device_session(fn, n):
    """One torch.profiler session over n calls of fn: {kernel name: (device
    us, launches)}."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return {e.key: (getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0)), e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


def device_ms_by_kernel(fn, iters=10, tries=3):
    """Device ms per call of fn by kernel name: the time of the kernels it
    launches, from torch.profiler over `iters` calls after a warm-up,
    without the host's time between launches (which a CUDA-event loop of
    short launches measures instead).  A session that recorded fewer
    kernels than one call launches, times `iters`, is dropped and taken
    again; after `tries` such sessions the result is None (not
    measured)."""
    import torch

    def launches(session):
        return sum(count for _, count in session.values())

    fn()
    torch.cuda.synchronize()
    per_call = max(launches(_device_session(fn, 1)) for _ in range(tries))
    for _ in range(tries):
        session = _device_session(fn, iters)
        if per_call and launches(session) >= per_call * iters:
            return {k: us / 1e3 / iters for k, (us, _) in session.items()}
    return None


def device_ms(fn, iters=10, tries=3):
    """Device ms of one call of fn (`device_ms_by_kernel`, summed), or None
    (not measured)."""
    by_kernel = device_ms_by_kernel(fn, iters, tries)
    return None if by_kernel is None else sum(by_kernel.values())


def queued_ms(fn, iters=20):
    """Device time of one call of fn by CUDA events, its launches queued
    behind a ~10 ms device sleep so that the host's time to enqueue them
    (which window 7's short calls exceed) is not timed."""
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


def fmt_ms(ms):
    return "not measured" if ms is None else f"{ms:.4f}"


def host_us(fn, iters=50):
    """Host time to enqueue one call of fn (no synchronisation inside the
    loop), in microseconds."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / iters
    torch.cuda.synchronize()
    return us


def mlp_launch_phase(what, args, gy, keep, tail):
    """K3/K8 and K7 launch by launch at (M, C): each launch's device time
    beside its bound, each entry point's device time (beside its library
    chain's) and host time per call, and one K3, one K8 and one K7 call
    under torch.profiler, which must see only the port's kernels."""
    from lavt_rs_tpu_torch.ops import fused_mlp as fm

    x, ga, be, w1, b1, w2, b2 = args
    m, c = x.shape
    plan = fm.bwd_plan(m, c, w1.shape[0])
    xn = fm.mlp_ln_rows(x, ga, be)
    h = fm.gemm_bias_gelu(xn, w1, b1)
    xn_b, stats, dm = fm.mlp_bwd_prep(x, gy, ga, be, keep, tail)
    h_b, dh, _ = fm.dual_gemm_gelu_bwd(xn_b, dm, w1, b1, w2)
    dyln = fm.dgrad(dh, w1)
    sr = plan.split_rows
    launches = {
        "LN rows": lambda: fm.mlp_ln_rows(x, ga, be),
        "fc1+GELU": lambda: fm.gemm_bias_gelu(xn, w1, b1),
        "fc2+residual": lambda: fm.gemm_residual(h, w2, b2, x, keep, tail),
        "prep": lambda: fm.mlp_bwd_prep(x, gy, ga, be, keep, tail),
        "dual GEMM": lambda: fm.dual_gemm_gelu_bwd(xn_b, dm, w1, b1, w2),
        "wgrad": lambda: (fm.wgrad(dm, h_b, sr), fm.wgrad(dh, xn_b, sr)),
        "dyln": lambda: fm.dgrad(dh, w1),
        "LN bwd": lambda: fm.ln_bwd_rows(dyln, x, gy, ga, stats, keep, tail),
    }
    work = mlp_launch_work(m, c, plan.splits)
    parts = []
    for name, fn in launches.items():
        b, by = bound_ms(work[name])
        parts.append(f"{name} {fmt_ms(device_ms(fn))} (bound {b:.4f} {by})")
    log(f"LN-MLP launches per call, {what} ({m}, {c}), device ms: "
        + "; ".join(parts))
    calls = {"K3": lambda: fm.fused_ln_mlp(*args),
             "K8": lambda: fm.fused_ln_mlp_droppath(*args, keep, tail),
             "K7": lambda: fm.fused_ln_mlp_bwd(x, gy, ga, be, w1, b1, w2, keep,
                                               tail)}
    kr = keep.repeat_interleave(tail)[:, None].bfloat16()
    chains = {"K3": lambda: torch_bf16_mlp(*args),
              "K8": lambda: torch_bf16_mlp(*args, kr),
              "K7": chain_grad(lambda *t: torch_bf16_mlp(*t, kr), args, gy)}
    log(f"LN-MLP calls at ({m}, {c}): device ms kernel | library chain "
        + ", ".join(f"{k} {fmt_ms(device_ms(f))} | "
                    f"{fmt_ms(device_ms(chains[k]))}" for k, f in calls.items())
        + "; host us to enqueue one call "
        + ", ".join(f"{k} {host_us(f):.1f}" for k, f in calls.items()))
    defer(functools.partial(mlp_port_check,
                            f"K3 / K8 / K7 calls at ({m}, {c})", tail),
          *args, gy, keep)


def k5_launch_line(what, fn, b, nw, c, heads):
    """K5 launch by launch at (b, nW, 144, C): each kernel's device ms per
    call (torch.profiler), the attention launch's bound beside it."""
    from lavt_rs_tpu_torch.ops import fused_msa

    by = device_ms_by_kernel(fn)
    m = b * nw
    att = (10 * m * heads * 144 * 144 * 32,
           (4 * m * 144 * c + m * 144 * 4 * c) * 2 + m * heads * 144 * 144 * 2)
    bnd, kind = bound_ms(att)
    parts = "not measured" if by is None else "; ".join(
        f"{short_kernel(k)} {v:.4f}" for k, v in
        sorted(by.items(), key=lambda kv: -kv[1]))
    log(f"K5 launches {what}, device ms per call: {parts} (attention bound "
        f"{bnd:.4f} {kind}; groups "
        f"{fused_msa.msa_bwd_groups(m, heads)}); host {host_us(fn):.1f} us "
        f"to enqueue a call")


def k9_launch_line(what, fn, b, nw, heads, n, masked):
    """K9 launch by launch: each kernel's device ms per call
    (torch.profiler) and the launch plan."""
    import torch

    from lavt_rs_tpu_torch.ops import window_attn as wa

    by = device_ms_by_kernel(fn)
    plan = wa.k9_plan(b * nw, heads, n, torch.cuda.get_device_properties(
        0).multi_processor_count)
    parts = "not measured" if by is None else "; ".join(
        f"{short_kernel(k)} {v:.4f}" for k, v in
        sorted(by.items(), key=lambda kv: -kv[1]))
    log(f"K9 launches {what} ({masked} windows masked), device ms per call: "
        f"{parts}; plan bp {plan['bp']} (partials {plan['parts']}), launch 1 "
        f"{plan['q_blocks']} blocks, launch 2 {plan['kv_blocks']}; host "
        f"{host_us(fn):.1f} us to enqueue a call")


# torch.profiler checks held back until every timed window has run: (the
# check, its tensors on the host)
DEFERRED = []


def defer(fn, *tensors):
    """Runs fn(*tensors) at the end of the run, in a fresh process
    (`run_deferred`): no profiler session of the per-launch lines and the
    port-kernels checks comes before a timed window, and none runs late in
    a long process, where torch.profiler drops kernel records.  fn must
    pickle (a module-level function or a partial of one); the tensors wait
    on the host."""
    DEFERRED.append((fn, [None if t is None else t.cpu() for t in tensors]))


def run_deferred():
    """The deferred checks in `python chip_smoke.py --deferred FILE`, their
    functions and inputs passed through FILE under the checkout's build/;
    raises unless that process exits 0."""
    import torch

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_deferred.pt")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    try:
        torch.save(DEFERRED, path)
        DEFERRED.clear()
        rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                             "--deferred", path], timeout=600).returncode
    finally:
        if os.path.exists(path):
            os.remove(path)
    if rc:
        raise RuntimeError(f"the deferred profiler checks failed (exit {rc})")


def deferred_child(path):
    """The deferred checks' process: each function on its inputs, moved to
    the card."""
    import torch

    dev = torch.device("cuda:0")
    for fn, tensors in torch.load(path, weights_only=False):
        fn(*[None if t is None else t.to(dev) for t in tensors])
        torch.cuda.empty_cache()
    return 0


def mlp_port_check(what, tail, x, ga, be, w1, b1, w2, b2, gy, keep):
    """One K3, one K8 and one K7 call under torch.profiler: only the port's
    kernels."""
    from lavt_rs_tpu_torch.ops import fused_mlp as fm

    args = (x, ga, be, w1, b1, w2, b2)
    only_port_kernels(what, [
        lambda: fm.fused_ln_mlp(*args),
        lambda: fm.fused_ln_mlp_droppath(*args, keep, tail),
        lambda: fm.fused_ln_mlp_bwd(x, gy, ga, be, w1, b1, w2, keep, tail)])


def k5_profiler_checks(what, nw, c, heads, sc, port_only, x, gy, wqkv, wproj,
                       *saved):
    """K5's launch line and (port_only) its only-port-kernels check."""
    from lavt_rs_tpu_torch.ops import fused_msa

    def k5():
        return fused_msa.fused_window_msa_bwd(x, gy, wqkv, wproj, saved, heads,
                                              sc)

    k5_launch_line(what, k5, BATCH, nw, c, heads)
    if port_only:
        only_port_kernels(f"K5 {what}", [k5])


def save_launch_work(b, nw, c, heads, ln, masked, save=True):
    """(operations, bytes) of each launch of the save mode (K1 / K2 /
    K11's without save) at (B, nW, 144, C): each input read once and each
    output written once."""
    n, rows, m = 144, b * nw * 144, b * nw
    act = rows * c * 2
    att = 4 * m * heads * n * n * 32
    att_bytes = (4 * act + heads * n * n * 4 + masked * n * n * 4
                 + (m * heads * n * n * 2 if save else 0))
    work = {"qkv": (6 * rows * c * c, 4 * act + (3 * c * c + 3 * c) * 2),
            "attention": (att, att_bytes),
            "out-projection": (2 * rows * c * c, 2 * act + (c * c + c) * 2)}
    if ln:
        work["LN rows"] = ln_work(rows, c)
    return work


def launch_line(label, fn, work):
    """Each kernel of fn's launches by device ms per call (torch.profiler)
    beside each launch's bound, and the host's time to enqueue a call."""
    bounds = "; ".join(f"{k} {bound_ms(v)[0]:.4f} {bound_ms(v)[1]}"
                       for k, v in work.items())
    by = device_ms_by_kernel(fn)
    parts = "not measured" if by is None else "; ".join(
        f"{short_kernel(k)} {v:.4f}" for k, v in
        sorted(by.items(), key=lambda kv: -kv[1]))
    log(f"{label}, device ms per call: {parts} (bounds: {bounds}); host "
        f"{host_us(fn):.1f} us to enqueue a call")


def save_profiler_checks(what, heads, sc, port_only, x, ln_s, ln_b, wqkv,
                         bqkv, wproj, bproj, bias, mask, flags):
    """The save mode's launches and, without saves, K1's (at the unpadded
    stages) or K2's (at the padded ones), each kernel's device ms per call
    (torch.profiler) beside each launch's bound; with port_only, a
    save-mode, a K1, a K2 and a K6 call under torch.profiler: only the
    port's kernels."""
    from lavt_rs_tpu_torch.ops import fused_msa

    lnp = None if ln_s is None else (ln_s, ln_b)
    w = (wqkv, bqkv, wproj, bproj, bias, mask, heads, sc)

    def save():
        return fused_msa.fused_window_msa_save(x, lnp, *w, flags=flags)

    def k2():
        return fused_msa.fused_window_msa(x, *w, flags=flags)

    def k1():
        return fused_msa.fused_window_msa_ln(x, *lnp, *w, flags=flags)

    b, nw, _, c = x.shape
    masked = int(flags.sum())
    for label, fn, saves in (("save mode", save, True),
                             ("K2 (no saves)", k2, False) if lnp is None
                             else ("K1 (no saves)", k1, False)):
        launch_line(f"{label} launches {what} x{tuple(x.shape)}", fn,
                    save_launch_work(b, nw, c, heads, lnp is not None, masked,
                                     saves))
    if port_only:
        only_port_kernels(f"save mode / K1 / K2 / K6 {what}", [
            save, k2, lambda: fused_msa.fused_window_msa_bwd_recompute(
                x, lnp, *w[:6], x, heads, sc, flags=flags)] + (
                    [k1] if lnp is not None else []))


def k11_profiler_checks(what, heads, sc, port_only, x, wqkv, bqkv, wproj,
                        bproj, bias, mask, flags):
    """K11's three launches (the qkv GEMM over the map's rows, the
    attention in map order, the out-projection), each kernel's device ms
    per call beside each launch's bound; with port_only, a K11 call under
    torch.profiler: only the port's kernels."""
    from lavt_rs_tpu_torch.ops import fused_msa_2d

    def k11():
        return fused_msa_2d.fused_window_msa_2d(x, wqkv, bqkv, wproj, bproj,
                                                bias, mask, heads, sc, 12,
                                                flags)

    b, hp, wp, c = x.shape
    nw = (hp // 12) * (wp // 12)
    masked = 0 if mask is None else (nw if flags is None else int(flags.sum()))
    launch_line(f"K11 launches {what}", k11,
                save_launch_work(b, nw, c, heads, False, masked, False))
    if port_only:
        only_port_kernels(f"K11 {what}", [k11])


def k9_profiler_checks(what, b, nw, heads, n, masked, sc, port_only, q, k, v,
                       bias, mask, do, o, lse):
    """K9's launch line and (port_only) its only-port-kernels check, with
    the mask's window flags as the Swin blocks pass them."""
    from lavt_rs_tpu_torch.ops import window_attn as wa

    flags = wa.mask_flags(mask)

    def k9():
        return wa.attention_core_bwd(q, k, v, bias, mask, do, sc, o, lse,
                                     flags)

    k9_launch_line(what, k9, b, nw, heads, n, masked)
    if port_only:
        only_port_kernels(f"K9 {what}", [k9])


def short_kernel(name):
    """A kernel's name without its namespace, parameters and template
    arguments' noise (the GEMM core's epilogue kept)."""
    base = name.split("(")[0].replace("void ", "")
    if "gemm_kernel<" in base:
        epi = base.split("gemm_kernel<")[1].split(",")[0].split("::")[-1]
        return f"gemm<{epi}>"
    return base.split("<")[0].split("::")[-1]


def check_deterministic(what, fn):
    """Two calls of fn give the same bits (fixed-order sums, no float
    atomics)."""
    import torch

    a, b = fn(), fn()
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        raise RuntimeError(f"{what}: two calls gave different bits")
    log(f"{what}: two calls give the same bits")


def same_bits(what, got, want, of):
    """got has the bits of want (the same launches on the same inputs in
    another order or mode)."""
    import torch

    torch.cuda.synchronize()
    if not torch.equal(got, want):
        diff = (got.float() - want.float()).abs().max().item()
        raise RuntimeError(f"{what}: not bit-equal to {of} (max abs "
                           f"difference {diff:.3g})")
    log(f"{what}: bit-equal to {of}")


def ln_device_line(what, x, s, b):
    """K4, K3's LN-rows launch (two-pass, `fused_mlp.mlp_ln_rows`) and
    `F.layer_norm` on the same inputs, each on the device with its
    launches queued behind a sleep (`queued_ms`), beside the byte bound;
    returns K4's."""
    from lavt_rs_tpu_torch.ops import fused_mlp, ln

    rows, c = x.shape
    fns = {"K4": lambda: ln.layer_norm_rows_launch(x, s, b),
           "K3's LN rows": lambda: fused_mlp.mlp_ln_rows(x, s, b),
           "F.layer_norm": lambda: torch_bf16_ln(x, s, b)}
    if not fused_mlp.fused_tail_routed(c):
        del fns["K3's LN rows"]
    ms = {k: queued_ms(f) for k, f in fns.items()}
    log(f"K4 {what}, device ms a launch (queued): "
        + "; ".join(f"{k} {v:.4f}" for k, v in ms.items())
        + f" (bound {bound_ms(ln_work(rows, c))[0]:.4f} bytes)")
    return ms["K4"]


def device_per_call(res, name, what, calls, fn):
    """fn's device ms a call with its launches queued behind a device sleep
    (`queued_ms`: no enqueue time), added per forward to res under name."""
    ms = queued_ms(fn)
    res.r[name]["device"] += calls * ms
    log(f"{name} {what}: device {ms:.4f} ms a call (launches queued)")


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


def torch_bf16_msa_sdpa(x, wqkv, bqkv, wproj, bproj, bias, mask, heads,
                        scale, ln=None):
    """K1 / K2's math as linear, one `scaled_dot_product_attention` over the
    B nW windows as its 4-D batch with the bias and the mask as one
    additive mask of x's dtype (`sdpa_mask`), linear (timing baseline
    only)."""
    import torch.nn.functional as F

    b, nw, n, c = x.shape
    if ln is not None:
        x = F.layer_norm(x, (c,), *ln, 1e-5)
    qkv = F.linear(x, wqkv, bqkv).view(b * nw, n, 3, heads, c // heads)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    o = F.scaled_dot_product_attention(
        q, k, v, attn_mask=sdpa_mask(bias, mask, nw, b, x.dtype), scale=scale)
    return F.linear(o.transpose(1, 2).reshape(b, nw, n, c), wproj, bproj)


def msa_bwd_yardstick(what, chain_in, gy, mask, heads, scale, forward=False):
    """K5's (K6's with forward) library call: the faster, in this run, of
    autograd through the matmul chain (`torch_bf16_msa`) and through the
    linear / 4-D SDPA / linear chain (`torch_bf16_msa_sdpa`), both taking
    the bias-table grad; logs both times and returns (the faster closure,
    its name)."""
    def wrap(chain):
        def fn(x_, wq, bq, wp, bp, bi, *lnt):
            return chain(x_, wq, bq, wp, bp, bi, mask, heads, scale,
                         ln=lnt or None)
        return chain_grad(fn, chain_in, gy, forward)

    fns = {"matmul chain": wrap(torch_bf16_msa),
           "SDPA chain": wrap(torch_bf16_msa_sdpa)}
    times = {name: cuda_time_ms(fn) for name, fn in fns.items()}
    best = min(times, key=times.get)
    log(f"{what} library yardsticks: "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in times.items())
        + f"; the faster: {best}")
    return fns[best], best


def msa_fwd_yardstick(what, x, tail, lnp):
    """K1's / K2's library call: the faster, in this run, of the matmul
    chain (`torch_bf16_msa`) and the linear / 4-D SDPA / linear chain
    (`torch_bf16_msa_sdpa`); logs both times and returns (the faster
    closure, its name)."""
    fns = {"matmul chain": lambda: torch_bf16_msa(x, *tail, ln=lnp),
           "SDPA chain": lambda: torch_bf16_msa_sdpa(x, *tail, ln=lnp)}
    times = {name: cuda_time_ms(fn) for name, fn in fns.items()}
    best = min(times, key=times.get)
    log(f"{what} library yardsticks: "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in times.items())
        + f"; the faster: {best}")
    return fns[best], best


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
        self.r = {}
        for k in NAMES + ("save", "K2s", "K10s") + F32_NAMES:
            self.entry(k)

    def entry(self, name):
        return self.r.setdefault(name, dict(
            err=0.0, ms=0.0, plain=0.0, lib=0.0, bound=0.0, ops=0.0, mem=0.0,
            replaced=0.0, device=0.0))

    def add(self, name, calls, err, tk, tp, tb, work, peak=PEAK_FLOPS):
        r = self.entry(name)
        r["err"] = max(r["err"], err)
        b, _ = bound_ms(work, peak)
        for key, v in (("ms", tk), ("plain", tp), ("lib", tb), ("bound", b),
                       ("ops", work[0] / peak * 1e3),
                       ("mem", work[1] / PEAK_BYTES * 1e3)):
            r[key] += calls * v

    def bound_by(self, name):
        r = self.r[name]
        return "operations" if r["ops"] >= r["mem"] else "bytes"


def measure(res, name, what, calls, fk, fp, fb, work, check, queued=False,
            also=(), peak=PEAK_FLOPS):
    """Check fk against fp, then time fk, fp and fb (CUDA events around a
    loop of calls; with `queued`, the calls queued behind a device sleep,
    so that a call shorter than the host's time to enqueue it is timed on
    the device: `queued_ms`) and add them to `res` under name and the
    names in `also`; the bound takes `peak` operations a second (bf16's,
    or PEAK_FLOPS_F32 for an f32 variant)."""
    want = fp()
    got = fk()
    out = check(name, got, want)
    err, extra = (out if isinstance(out, tuple) else (out, None))
    del got, want
    if queued:
        tk, tp, tb = queued_ms(fk), queued_ms(fp, iters=3), queued_ms(fb)
        how = (f" (device: launches queued; events around a loop "
               f"{cuda_time_ms(fk):.4f}, host {host_us(fk):.1f} us a call)")
    else:
        tk = cuda_time_ms(fk)
        tp = cuda_time_ms(fp, iters=3, warmup=1)
        tb = cuda_time_ms(fb)
        how = ""
    for key in (name,) + tuple(also):
        res.add(key, calls, err, tk, tp, tb, work, peak)
    b, by = bound_ms(work, peak)
    frob = "" if extra is None else f", worst grad rel Frobenius {extra:.3g}"
    log(f"{name} {what}: max abs err {err:.3g}{frob}; kernel {tk:.4f} "
        f"ms{how}, bound {b:.4f} ms ({by}), plain (f32 math) {tp:.4f} ms, "
        f"library chain {tb:.4f} ms")
    return tk, tp, tb


def kernel_phases(dev):
    """Each kernel against its plain version at the main-path shapes;
    returns the Results (K1-K4 per forward at batch 8, K5/K7/K8 per
    training step at batch 8, K6 per training step at batch 16)."""
    import torch

    from lavt_rs_tpu_torch.ops import fused_mlp, fused_msa, ln
    from lavt_rs_tpu_torch.ops.window import (relative_bias_from_table,
                                              relative_position_index_2d,
                                              shift_mask_2d,
                                              shift_mask_flags_2d)

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
        res.r["K4"]["device"] += ln_device_line(f"{st} ({rows}, {c})", x, s,
                                                b)
        # K4b: the stage norm's backward (and, uncounted, K1's LN's at
        # stages 1-2, the same shapes) from the f32 master scale
        gy, sf = rnd((rows, c)), s.float()
        measure(res, "K4b", f"{st} ({rows}, {c})", 1,
                lambda: ln.layer_norm_rows_bwd(x, sf, gy),
                lambda: ln.layer_norm_rows_bwd_plain(x, sf, gy),
                chain_grad(torch_bf16_ln, (x, s, b), gy),
                ln_bwd_work(rows, c), compare_ln_bwd)
        check_deterministic(f"K4b {st}", lambda: ln.layer_norm_rows_bwd_launch(
            x, sf, gy))
        device_per_call(res, "K4b", f"{st} ({rows}, {c})", 1,
                        lambda: ln.layer_norm_rows_bwd_launch(x, sf, gy))
        del gy
        # K3 / K8 / K7: the LN-MLP tail of every block (in training K3 in
        # block 0 only, where the drop-path rate is 0)
        args = (rnd((rows, c)), rnd((c,), 0.2, 1.0), rnd((c,), 0.2),
                rnd((4 * c, c), c ** -0.5), rnd((4 * c,), 0.2),
                rnd((c, 4 * c), (4 * c) ** -0.5), rnd((c,), 0.2))
        measure(res, "K3", f"{st} ({rows}, {c})", depth,
                lambda: fused_mlp.fused_ln_mlp(*args),
                lambda: fused_mlp.fused_ln_mlp_plain(*args),
                lambda: torch_bf16_mlp(*args), mlp_work(rows, c),
                compare_out_and_branch(args[0]))
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
                mlp_work(rows, c, keep=BATCH), compare_out_and_branch(args[0]))
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
        mlp_launch_phase(st, args, gy, keep, tail)
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
            flags = shift_mask_flags_2d(hp, hp, 12, 6, dev) if shift else None
            tail = (*w, bias, mask, heads, sc)
            if name == "K1":
                fk = lambda: fused_msa.fused_window_msa_ln(xw, *lnp, *tail,
                                                           flags=flags)
                fp = lambda: fused_msa.fused_window_msa_ln_plain(xw, *lnp, *tail)
            else:
                fk = lambda: fused_msa.fused_window_msa(xw, *tail, flags=flags)
                fp = lambda: fused_msa.fused_window_msa_plain(xw, *tail)
            what = f"{st} x{tuple(xw.shape)} heads {heads} mask {shift}"
            lib, lib_name = msa_fwd_yardstick(f"{name} {what}", xw, tail, lnp)
            res.entry(name).setdefault("lib_by", []).append(lib_name)
            measure(res, name, what, depth // 2, fk, fp, lib,
                    msa_work(BATCH, nw, c, heads, "fwd", mask=shift), compare)
            if name == "K1":
                same_bits(f"K1 {what}", fk(), fused_msa.fused_window_msa_save(
                    xw, lnp, *tail, flags=flags)[0], "the save mode's y")
                device_per_call(res, "K1", what, depth // 2, fk)
        # training: save mode, K5 on the kernel's residuals, K6 (shift mask);
        # the save mode's yardstick is the matmul chain (SDPA returns no P),
        # the SDPA chain's time is logged beside it
        mask = shift_mask_2d(hp, hp, 12, 6, dev)
        flags = shift_mask_flags_2d(hp, hp, 12, 6, dev)
        tail = (*w, bias, mask, heads, sc)
        msa_fwd_yardstick(f"{name} save mode {st}", xw, tail, lnp)
        measure(
            res, "save", f"{name} save mode {st} x{tuple(xw.shape)}", depth,
            lambda: fused_msa.fused_window_msa_save(xw, lnp, *tail,
                                                    flags=flags),
            lambda: fused_msa.fused_window_msa_save_plain(xw, lnp, *tail),
            lambda: torch_bf16_msa(xw, *tail, ln=lnp),
            msa_work(BATCH, nw, c, heads, "save", ln=lnp is not None),
            lambda _n, got, want: compare_saved(name, got, want),
            also=("K2s",) if name == "K2" else ())
        defer(functools.partial(save_profiler_checks, st, heads, sc, si == 0),
              xw, *(lnp or (None, None)), *w, bias, mask, flags)
        y, saved = fused_msa.fused_window_msa_save(xw, lnp, *tail, flags=flags)
        xin = xw if lnp is None else saved[4].view(xw.shape)
        res_k5 = saved[:4]
        gy = rnd(xw.shape)
        chain_in = (xw, *w, bias) + tuple(lnp or ())
        what = f"{st} x{tuple(xw.shape)} heads {heads}"

        def k5():
            return fused_msa.fused_window_msa_bwd(xin, gy, w[0], w[2], res_k5,
                                                  heads, sc)

        lib, lib_name = msa_bwd_yardstick(f"K5 {what}", chain_in, gy, mask,
                                          heads, sc)
        res.entry("K5").setdefault("lib_by", []).append(lib_name)
        measure(res, "K5", what, depth, k5,
                lambda: fused_msa.fused_window_msa_bwd_plain(
                    xin, gy, w[0], w[2], res_k5, heads, sc),
                lib, msa_work(BATCH, nw, c, heads, "bwd"), compare_grads)
        check_deterministic(f"K5 {what}", k5)
        defer(functools.partial(k5_profiler_checks, what, nw, c, heads, sc,
                                si == 0), xin, gy, w[0], w[2], *res_k5)
        del y, saved, res_k5, xin
        batches = (BATCH, BATCH_BIG) if si == 0 else (BATCH,)
        for bsz in batches:
            xk = xw if bsz == BATCH else rnd((bsz, nw, 144, c))
            gk = gy if bsz == BATCH else rnd(xk.shape)
            calls = 2 if bsz == BATCH_BIG else 0
            what = f"{st} x{tuple(xk.shape)} heads {heads}"
            lib, lib_name = msa_bwd_yardstick(
                f"K6 {what}", (xk,) + chain_in[1:], gk, mask, heads, sc,
                forward=True)
            measure(res, "K6", what, calls,
                    lambda: fused_msa.fused_window_msa_bwd_recompute(
                        xk, lnp, *tail[:6], gk, heads, sc, flags=flags),
                    lambda: fused_msa.fused_window_msa_bwd_recompute_plain(
                        xk, lnp, *tail[:6], gk, heads, sc),
                    lib,
                    msa_work(bsz, nw, c, heads, "recompute",
                             ln=lnp is not None), compare_grads)
        del xw, gy
        torch.cuda.empty_cache()
    return res


def torch_bf16_msa_2d(x, wqkv, bqkv, wproj, bproj, am, heads, scale, ws=12):
    """K11's function as a bf16 PyTorch chain: window partition, linear,
    one `scaled_dot_product_attention` with the bias and the mask as one
    bf16 additive mask `am` (nW, h, N, N), linear, window reverse (timing
    baseline only)."""
    import torch.nn.functional as F

    from lavt_rs_tpu_torch.ops.window import window_partition, window_reverse

    b, hp, wp, c = x.shape
    nw, n = (hp // ws) * (wp // ws), ws * ws
    xw = window_partition(x, ws).view(b, nw, n, c)
    qkv = F.linear(xw, wqkv, bqkv).view(b, nw, n, 3, heads, c // heads)
    q, k, v = qkv.permute(3, 0, 1, 4, 2, 5)
    o = F.scaled_dot_product_attention(q, k, v, attn_mask=am, scale=scale)
    y = F.linear(o.transpose(2, 3).reshape(b * nw, n, c), wproj, bproj)
    return window_reverse(y, ws, hp, wp)


def k11_kernel_phase(dev, res):
    """K11 against its plain version at the map shapes of a bs-8 forward
    (K11_CASES), timed beside its bound, its plain version, the SDPA chain
    and the route it replaces (window_partition -> K2 -> window_reverse);
    per forward into `res`."""
    import torch

    from lavt_rs_tpu_torch.ops import fused_msa, fused_msa_2d
    from lavt_rs_tpu_torch.ops.window import (relative_bias_from_table,
                                              relative_position_index_2d,
                                              shift_mask_2d,
                                              shift_mask_flags_2d,
                                              window_partition,
                                              window_reverse)

    g = torch.Generator(device=dev).manual_seed(SEED + 20)

    def rnd(shape, std=1.0):
        return (torch.randn(shape, generator=g, device=dev) * std).bfloat16()

    index = torch.from_numpy(relative_position_index_2d(12, 12)).to(dev)
    port_only = True
    for b, hp, wp, c, heads, shift, calls in K11_CASES:
        nw = (hp // 12) * (wp // 12)
        x = rnd((b, hp, wp, c))
        w = (rnd((3 * c, c), c ** -0.5), rnd((3 * c,), 0.2),
             rnd((c, c), c ** -0.5), rnd((c,), 0.2))
        bias = relative_bias_from_table(
            torch.randn((23 * 23, heads), generator=g, device=dev), index)
        mask = shift_mask_2d(hp, wp, 12, 6, dev) if shift else None
        flags = shift_mask_flags_2d(hp, wp, 12, 6, dev) if shift else None
        sc = (c // heads) ** -0.5
        args = (x, *w, bias, mask, heads, sc, 12)
        am = sdpa_mask(bias, mask, nw)

        def k11(a=args, f=flags):
            return fused_msa_2d.fused_window_msa_2d(*a, f)

        def replaced(x=x, w=w, bias=bias, mask=mask, heads=heads, sc=sc,
                     f=flags):
            xw = window_partition(x, 12).view(x.shape[0], -1, 144, x.shape[3])
            y = fused_msa.fused_window_msa(xw, *w, bias, mask, heads, sc,
                                           flags=f)
            return window_reverse(y.view(-1, 144, x.shape[3]), 12,
                                  *x.shape[1:3])

        what = (f"x{tuple(x.shape)} heads {heads} mask {shift}"
                + ("" if calls else " (off the path)"))
        measure(res, "K11", what, calls, k11,
                lambda a=args: fused_msa_2d.fused_window_msa_2d_plain(*a),
                lambda x=x, w=w, am=am, heads=heads, sc=sc: torch_bf16_msa_2d(
                    x, *w, am, heads, sc),
                msa_work(b, nw, c, heads, "fwd", mask=shift),
                lambda name, got, want: compare(name, got, want, TOL["K2"]))
        same_bits(f"K11 {what}", k11(), replaced(),
                  "the K2 launches on the partitioned map")
        device_per_call(res, "K11", what, calls, k11)
        tr = cuda_time_ms(replaced)
        res.r["K11"]["replaced"] += calls * tr
        log(f"K11 {what}: the route it replaces (partition, K2, reverse) "
            f"{tr:.4f} ms")
        if calls:
            defer(functools.partial(k11_profiler_checks, what, heads, sc,
                                    port_only), x, *w, bias, mask, flags)
            port_only = False
        del x, am, args
        torch.cuda.empty_cache()


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

    from lavt_rs_tpu_torch.ops import fused_msa_2d
    from lavt_rs_tpu_torch.tools import probe_headbatch as probe

    return {"K1": fused_msa.fused_window_msa_ln,
            "K2": fused_msa.fused_window_msa,
            "K3": fused_mlp.fused_ln_mlp, "K4": ln.layer_norm_rows,
            "K4b": ln.layer_norm_rows_bwd,
            "K5": fused_msa.fused_window_msa_bwd,
            "K6": fused_msa.fused_window_msa_bwd_recompute,
            "K7": fused_mlp.fused_ln_mlp_bwd,
            "K8": fused_mlp.fused_ln_mlp_droppath,
            "K10": window_attn.window_attention,
            "K2p": fused_msa.fused_window_msa_grouped,
            "K9": window_attn.attention_core_bwd,
            "K11": fused_msa_2d.fused_window_msa_2d,
            "P1": probe.loop_attention, "P2": probe.batch_attention,
            "K1.f32": fused_msa.fused_window_msa_ln_f32,
            "K11.f32": fused_msa_2d.fused_window_msa_2d_f32,
            "K3.f32": fused_mlp.fused_ln_mlp_f32,
            "K4.f32": ln.layer_norm_rows_f32}


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


def inference(dev, card, model, per_forward=None, what="inference"):
    """The fwd_iou main path (launches per forward as `per_forward`, by
    default the window-12 ones), the f32 check and the forward timing;
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
    log(f"{what} launches over {N_REQUESTS} batches of {BATCH}: {launches}")
    check_counts(what, launches, per_forward or INFER_PER_FORWARD, N_REQUESTS)
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
    log(f"{what}: bf16 kernel path vs f32 plain path: max |dlogit| "
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
    log(f"{what}: forward bs {BATCH} bf16 with kernels: {ms:.3f} ms/step, "
        f"{BATCH * 1000 / ms:.2f} img/s (mean of {iters}); plain versions "
        f"(bf16 weights, f32 math, TF32 off): {plain_ms:.3f} ms/step, "
        f"{BATCH * 1000 / plain_ms:.2f} img/s (mean of {plain_iters})  [{card}]")
    return launches


def write_refcoco(root, rng):
    """A synthetic RefCOCO split under `root`, laid out as REFER reads it:
    `refcoco/refs(unc).p`, `refcoco/instances.json`, COCO-sized 640x480
    JPEGs under `images/mscoco/images/train2014/`, and a `vocab.txt`
    covering every word.  EVAL_REFS val refs, then TRAIN_REFS train refs,
    of 1-EVAL_MAX_SENTENCES sentences, each referring to one polygon
    annotation."""
    import pickle

    import numpy as np
    from PIL import Image

    h, w = 480, 640
    img_dir = os.path.join(root, "images", "mscoco", "images", "train2014")
    os.makedirs(img_dir)
    os.makedirs(os.path.join(root, "refcoco"))
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    images, annotations, refs = [], [], []
    for i in range(EVAL_IMAGES):
        f = rng.uniform(0.01, 0.05, 3)
        smooth = np.stack([np.sin(xx * f[0] + yy * f[1] + i),
                           np.cos(yy * f[2] - xx * f[0]),
                           np.sin((xx + yy) * f[1] * 0.5)], -1)
        img = (127.5 + 100 * smooth + rng.normal(0, 12, (h, w, 3)))
        name = f"COCO_train2014_{i:012d}.jpg"
        Image.fromarray(img.clip(0, 255).astype(np.uint8)).save(
            os.path.join(img_dir, name), quality=90)
        images.append({"id": i, "file_name": name, "height": h, "width": w})
    for j in range(EVAL_REFS + TRAIN_REFS):
        cx, cy = rng.uniform(120, w - 120), rng.uniform(100, h - 100)
        ang = np.sort(rng.uniform(0, 2 * np.pi, 8))
        rad = rng.uniform(30, 110, 8)
        poly = np.stack([cx + rad * np.cos(ang), cy + rad * np.sin(ang)], 1)
        annotations.append({
            "id": 1000 + j, "image_id": j % EVAL_IMAGES, "category_id": 1,
            "segmentation": [np.round(poly, 2).ravel().tolist()],
            "area": 0, "bbox": [0, 0, 0, 0], "iscrowd": 0})
        sents = [" ".join(rng.choice(EVAL_WORDS, int(rng.integers(2, 9))))
                 for _ in range(1 + j % EVAL_MAX_SENTENCES)]
        refs.append({"ref_id": j, "ann_id": 1000 + j,
                     "image_id": j % EVAL_IMAGES, "category_id": 1,
                     "split": "val" if j < EVAL_REFS else "train",
                     "sentences": [{"raw": s, "sent": s, "sent_id": 10 * j + k}
                                   for k, s in enumerate(sents)],
                     "sent_ids": [10 * j + k for k in range(len(sents))]})
    with open(os.path.join(root, "refcoco", "refs(unc).p"), "wb") as fh:
        pickle.dump(refs, fh)
    with open(os.path.join(root, "refcoco", "instances.json"), "w") as fh:
        json.dump({"images": images, "annotations": annotations,
                   "categories": [{"id": 1, "name": "object"}]}, fh)
    vocab = os.path.join(root, "vocab.txt")
    with open(vocab, "w") as fh:
        fh.write("\n".join(("[PAD]", "[UNK]", "[CLS]", "[SEP]") + EVAL_WORDS)
                 + "\n")
    return vocab


def batch_logits(model, image, ids, mask):
    """The model's logits on every (ref, sentence) pair of an eval batch,
    as `fwd_iou` runs it."""
    import torch

    from lavt_rs_tpu_torch.ops.norm import maybe_normalize_image

    r, s = ids.shape[:2]
    h, w = image.shape[1:3]
    img = maybe_normalize_image(image)[:, None].expand(r, s, h, w, 3)
    with torch.no_grad():
        return model(img.reshape(r * s, h, w, 3), ids.reshape(r * s, -1),
                     mask.reshape(r * s, -1)).view(r, s, h, w, -1)


def refcoco_split(root, weights):
    """The eval phases' synthetic RefCOCO split under `root` and `weights`
    as a reference .pth there: (the vocab's path, the .pth's path)."""
    import numpy as np
    import torch

    vocab = write_refcoco(root, np.random.default_rng(SEED + 30))
    ckpt = os.path.join(root, "lavt_one_base.pth")
    torch.save({"model": weights}, ckpt)
    return vocab, ckpt


def eval_phase(dev, card, weights, root, vocab, ckpt):
    """The RefCOCO `test` entry point on the synthetic split under `root`
    (`refcoco_split`): the CLI in process from the .pth of `weights`
    (launch counts, the Final line, sentences/s), a warm rerun of
    `evaluate`, one batch under the profiler, and the gate against the
    f32 plain model.  Returns the launch counts of the CLI's run, its
    device batches and its sentences."""
    import contextlib
    import io

    import torch

    from lavt_rs_tpu_torch.cli import test as cli_test
    from lavt_rs_tpu_torch.config import lavt_one_base
    from lavt_rs_tpu_torch.data.refcoco import ReferDataset
    from lavt_rs_tpu_torch.data.refer import REFER
    from lavt_rs_tpu_torch.eval import refcoco_eval
    from lavt_rs_tpu_torch.models.factory import build_model
    from lavt_rs_tpu_torch.text.tokenizer import WordPieceTokenizer

    ds = ReferDataset(REFER(root), WordPieceTokenizer.from_vocab_file(vocab),
                      split="val", img_size=480, max_tokens=TOKENS,
                      eval_mode=True, host_normalize=False)
    sentences = sum(len(x) for x in ds.input_ids)
    s_pad = max(len(x) for x in ds.input_ids)
    rb = -(-refcoco_eval.SENTENCES_PER_BATCH // s_pad)
    batches = -(-len(ds) // rb)
    log(f"eval: {len(ds)} refs, {sentences} sentences, S = {s_pad}, "
        f"{rb} refs ({rb * s_pad} sentences) per device batch, "
        f"{batches} batches")

    # the CLI, its evaluate timed on the wall clock (it ends in a sync)
    evaluate, seconds = refcoco_eval.evaluate, []

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = evaluate(*a, **kw)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        return out

    argv = ["--window12", "--img_size", "480", "--refer_data_root", root,
            "--dataset", "refcoco", "--splitBy", "unc", "--split", "val",
            "--vocab", vocab, "--checkpoint", ckpt, "--device", str(dev)]
    err = io.StringIO()
    zero_counts()
    refcoco_eval.evaluate = timed
    try:
        with contextlib.redirect_stderr(err):
            summary = cli_test.main(argv)
    finally:
        refcoco_eval.evaluate = evaluate
    launches = read_counts()
    for line in err.getvalue().splitlines():
        log(f"cli: {line}")
    log(f"eval launches over {batches} batches: {launches}")
    check_counts("eval", launches, INFER_PER_FORWARD, batches)
    if sorted(summary) != sorted(["mIoU", "oIoU"] + [
            f"P@{t}" for t in (0.5, 0.6, 0.7, 0.8, 0.9)]):
        raise RuntimeError(f"eval: bad summary {summary}")
    if not all(math.isfinite(v) and 0 <= v <= 100 for v in summary.values()):
        raise RuntimeError(f"eval: summary out of range {summary}")
    s_cli = seconds[0]
    log(f"eval via the CLI (first run, cold): {s_cli:.3f} s, "
        f"{sentences / s_cli:.2f} sentences/s, "
        f"{1e3 * s_cli / batches:.3f} ms per device batch  [{card}]")

    model = build_model(lavt_one_base(), dev)
    model.load_state_dict(weights)
    quiet = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warm = refcoco_eval.evaluate(model, ds, out_stream=quiet)
    torch.cuda.synchronize()
    s_warm = time.perf_counter() - t0
    log(f"eval rerun (warm, evaluate): {s_warm:.3f} s, "
        f"{sentences / s_warm:.2f} sentences/s, "
        f"{1e3 * s_warm / batches:.3f} ms per device batch  [{card}]")
    log(f"eval rerun's summary equals the CLI run's: {warm == summary}")

    first = next(refcoco_eval.ref_batches(ds, range(len(ds)), rb, s_pad))
    scounts = first[1]
    image, ids, mask, target = (torch.from_numpy(a).to(dev)
                                for a in first[2:])
    profile_clip(lambda: [t.cpu() for t in refcoco_eval.fwd_iou(
        model, image, ids, mask, target)], card,
        f"one eval batch ({rb * s_pad} sentences)", FIRST_DESIGN_BUSY[
            "eval batch"])

    # the gate: f32 plain model, same weights, same items
    got = batch_logits(model, image, ids, mask)
    del model
    torch.cuda.empty_cache()
    ref = build_model(lavt_one_base().replace(dtype="float32",
                                              use_kernels=False), dev)
    ref.load_state_dict(weights)
    want = batch_logits(ref, image, ids, mask)
    if not bool(torch.isfinite(got).all()):
        raise RuntimeError("eval: non-finite logits (padded sentence rows "
                           "included)")
    real = torch.zeros(ids.shape[:2], dtype=torch.bool, device=dev)
    for j, s in enumerate(scounts):
        real[j, :s] = True
    got, want = got[real], want[real]
    sure = (want[..., 1] - want[..., 0]).abs() > MARGIN
    agree = (got.argmax(-1) == want.argmax(-1))[sure].float().mean().item()
    log(f"eval first batch, bf16 kernels vs f32 plain: max |dlogit| "
        f"{(got.float() - want).abs().max().item():.4g}, argmax agreement "
        f"{agree:.5f} on {sure.float().mean().item():.3f} of the real "
        f"sentences' pixels (margin > {MARGIN})")
    if not agree >= MIN_AGREE:
        raise RuntimeError(f"eval argmax agreement {agree:.5f} < "
                           f"{MIN_AGREE}")
    plain = refcoco_eval.evaluate(ref, ds, out_stream=quiet)
    del ref
    torch.cuda.empty_cache()
    log(f"eval summary, bf16 kernels: {summary}")
    log(f"eval summary, f32 plain:    {plain}")
    log("eval summary differences (kernels - plain): "
        + ", ".join(f"{k} {summary[k] - plain[k]:+.4f}" for k in summary))
    return launches, batches, sentences


# -- f32 inference main path: the f32 variants of K1, K11, K3 and K4 -----------

# substrings of the names of library kernels (cuBLAS, CUTLASS, cuDNN,
# PyTorch's attention and softmax) that the f32 Swin blocks must not launch
LIBRARY_KERNEL_TAGS = ("gemm", "gemv", "cublas", "cutlass", "xmma", "nvjet",
                       "cudnn", "conv", "attention", "fmha", "flash",
                       "softmax")


def f32_kernel_phase(dev, res):
    """Each f32 variant on seeded f32 inputs at its path shapes against its
    f32 plain version within F32_TOL abs + rel (K3 f32 also on the branch
    out - x), timed beside its bound (PEAK_FLOPS_F32), its plain version
    and its f32 library chain, and on the device with its launches queued;
    per forward into `res`."""
    import torch

    from lavt_rs_tpu_torch.ops import fused_mlp, fused_msa, fused_msa_2d, ln
    from lavt_rs_tpu_torch.ops.window import (relative_bias_from_table,
                                              relative_position_index_2d,
                                              shift_mask_2d,
                                              shift_mask_flags_2d)

    g = torch.Generator(device=dev).manual_seed(SEED + 40)

    def rnd(shape, std=1.0):
        return torch.randn(shape, generator=g, device=dev) * std

    def check(name, got, want):
        return compare(name, got, want, F32_TOL)

    index = torch.from_numpy(relative_position_index_2d(12, 12)).to(dev)

    def msa_weights(c, heads):
        return ((rnd((3 * c, c), c ** -0.5), rnd((3 * c,), 0.2),
                 rnd((c, c), c ** -0.5), rnd((c,), 0.2)),
                relative_bias_from_table(
                    torch.randn((23 * 23, heads), generator=g, device=dev),
                    index))

    sc = 32 ** -0.5
    for side, c, heads, blocks in STAGES:
        rows = BATCH * side * side
        x = rnd((rows, c), 2.0) + 0.5
        s_, b_ = rnd((c,), 0.2) + 1.0, rnd((c,), 0.2)
        what = f"x({rows}, {c})"
        measure(res, "K4.f32", what, 1,
                lambda: ln.layer_norm_rows_f32(x, s_, b_),
                lambda: ln.layer_norm_rows_plain(x, s_, b_),
                lambda: torch_bf16_ln(x, s_, b_), ln_work(rows, c, 4), check,
                peak=PEAK_FLOPS_F32)
        device_per_call(res, "K4.f32", what, 1,
                        lambda: ln.layer_norm_rows_f32(x, s_, b_))
        mlp = (x, s_, b_, rnd((4 * c, c), c ** -0.5), rnd((4 * c,), 0.2),
               rnd((c, 4 * c), (4 * c) ** -0.5), rnd((c,), 0.2))
        measure(res, "K3.f32", what, blocks,
                lambda: fused_mlp.fused_ln_mlp_f32(*mlp),
                lambda: fused_mlp.fused_ln_mlp_plain(*mlp),
                lambda: torch_bf16_mlp(*mlp), mlp_work(rows, c, item=4),
                lambda name, got, want: max(
                    check(name, got, want), check(name, got - x, want - x)),
                peak=PEAK_FLOPS_F32)
        device_per_call(res, "K3.f32", what, blocks,
                        lambda: fused_mlp.fused_ln_mlp_f32(*mlp))
        del x, mlp
    for side, c, heads, blocks in STAGES[:2]:  # K1 f32: the unpadded stages
        nw = (side // 12) ** 2
        x = rnd((BATCH, nw, 144, c), 2.0) + 0.5
        lnp = (rnd((c,), 0.2) + 1.0, rnd((c,), 0.2))
        w, bias = msa_weights(c, heads)
        for shift in (False, True):
            mask = shift_mask_2d(side, side, 12, 6, dev) if shift else None
            flags = (shift_mask_flags_2d(side, side, 12, 6, dev) if shift
                     else None)
            tail = (*w, bias, mask, heads, sc)
            what = f"x{tuple(x.shape)} heads {heads} mask {shift}"
            lib, _ = msa_fwd_yardstick(f"K1.f32 {what}", x, tail, lnp)

            def k1(tail=tail, flags=flags):
                return fused_msa.fused_window_msa_ln_f32(x, *lnp, *tail,
                                                         flags=flags)

            measure(res, "K1.f32", what, blocks // 2, k1,
                    lambda: fused_msa.fused_window_msa_ln_plain(x, *lnp,
                                                                *tail),
                    lib, msa_work(BATCH, nw, c, heads, "fwd", ln=True,
                                  mask=shift, item=4), check,
                    peak=PEAK_FLOPS_F32)
            device_per_call(res, "K1.f32", what, blocks // 2, k1)
        del x
    for b, hp, wp, c, heads, shift, calls in K11_CASES[:5]:
        nw = (hp // 12) * (wp // 12)
        x = rnd((b, hp, wp, c))
        w, bias = msa_weights(c, heads)
        mask = shift_mask_2d(hp, wp, 12, 6, dev) if shift else None
        flags = shift_mask_flags_2d(hp, wp, 12, 6, dev) if shift else None
        args = (x, *w, bias, mask, heads, sc, 12)
        am = sdpa_mask(bias, mask, nw, dtype=torch.float32)
        what = (f"x{tuple(x.shape)} heads {heads} mask {shift}"
                + ("" if calls else " (off the path)"))

        def k11(args=args, flags=flags):
            return fused_msa_2d.fused_window_msa_2d_f32(*args, flags)

        measure(res, "K11.f32", what, calls, k11,
                lambda: fused_msa_2d.fused_window_msa_2d_plain(*args),
                lambda: torch_bf16_msa_2d(x, *w, am, heads, sc),
                msa_work(b, nw, c, heads, "fwd", mask=shift, item=4), check,
                peak=PEAK_FLOPS_F32)
        device_per_call(res, "K11.f32", what, calls, k11)
        del x, am, args
        torch.cuda.empty_cache()


def swin_blocks_port_only(dev, model):
    """The first two Swin blocks (unshifted, shifted) of every stage of an
    f32 lavt_one `model` on bs-8 f32 tokens under torch.profiler: none may
    launch a library GEMM, convolution or attention kernel
    (LIBRARY_KERNEL_TAGS); prints the port's kernels and the others
    (PyTorch's copies and elementwise kernels: pad, roll, add)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator(device=dev).manual_seed(SEED + 41)
    calls = []
    for (side, c, _, _), layer in zip(STAGES, model.backbone.layers):
        x = torch.randn((BATCH, side * side, c), generator=g, device=dev)
        calls += [functools.partial(blk, x, (side, side))
                  for blk in layer.blocks[:2]]
    names = set()
    with torch.no_grad():
        for fn in calls:
            fn()
        torch.cuda.synchronize()
        for _ in range(3):  # a profile can come back without device records
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for fn in calls:
                    fn()
                torch.cuda.synchronize()
            names = {e.key for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and getattr(e, "self_device_time_total",
                                 getattr(e, "self_cuda_time_total", 0)) > 0}
            if names:
                break
    if not names:
        raise RuntimeError("f32 Swin blocks: torch.profiler recorded no "
                           "kernel")
    library = sorted(n for n in names if "lavt::" not in n and any(
        t in n.lower() for t in LIBRARY_KERNEL_TAGS))
    if library:
        raise RuntimeError(f"f32 Swin blocks launched library kernels: "
                           f"{library}")
    port = sorted({short_kernel(n) for n in names if "lavt::" in n})
    other = sorted({short_kernel(n) for n in names if "lavt::" not in n})
    log(f"f32 Swin blocks (2 a stage, bs {BATCH}) under torch.profiler: "
        f"{len(names)} kernels, no library GEMM, convolution or attention; "
        f"the port's: {', '.join(port)}; PyTorch's: {', '.join(other)}")


def f32_inference(dev, card, weights):
    """lavt_one Swin-B window-12 f32 with the kernels, on `weights`:
    N_REQUESTS batches of 8 through `fwd_iou` (the f32 counters equal the
    model's `kernel_plan` at itemsize 4, every bf16 counter 0), the gate
    against the plain f32 model on the same weights (max |dlogit| <=
    F32_GATE, the same argmax wherever the plain margin exceeds F32_GATE),
    ms a batch and img/s beside the plain model's, peak memory, one
    forward under torch.profiler and the Swin blocks under it
    (`swin_blocks_port_only`).  Returns the launch counts."""
    import torch

    from lavt_rs_tpu_torch.config import lavt_one_base
    from lavt_rs_tpu_torch.eval.refcoco_eval import fwd_iou
    from lavt_rs_tpu_torch.models.factory import build_model
    from lavt_rs_tpu_torch.ops.norm import maybe_normalize_image

    cfg = lavt_one_base(dtype="float32")
    plan = kernel_plan(cfg, 480, BATCH)[0]
    if plan != INFER_PER_FORWARD:
        raise RuntimeError(f"f32 forward: the kernel plan at itemsize 4 is "
                           f"{plan}, not the bf16 plan {INFER_PER_FORWARD}")
    per = {f"{k}.f32": n for k, n in plan.items()}
    t0 = time.perf_counter()
    model = build_model(cfg, dev)
    model.load_state_dict(weights)
    log(f"f32 model build + the main path's weights: "
        f"{time.perf_counter() - t0:.2f} s")
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    batches = requests(dev, g, N_REQUESTS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    results = [fwd_iou(model, *b) for b in batches]
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    launches = read_counts()
    log(f"f32 inference launches over {N_REQUESTS} batches of {BATCH}: "
        f"{nonzero_counts(launches)} (the plan at itemsize 4: {plan} a "
        f"forward)")
    check_counts("f32 inference", launches, per, N_REQUESTS)
    for inter, union in results:
        if inter.shape != (BATCH, 1) or not bool(torch.isfinite(union).all()):
            raise RuntimeError("f32 fwd_iou: bad inter/union")
        if bool((inter > union).any()):
            raise RuntimeError("f32 fwd_iou: intersection above union")

    image, ids, mask, _ = batches[0]
    img = maybe_normalize_image(image)

    def forward(m):
        with torch.no_grad():
            return m(img, ids[:, 0], mask[:, 0])

    logits = forward(model)
    ref = build_model(cfg.replace(use_kernels=False), dev)
    ref.load_state_dict(weights)
    want = forward(ref)
    if tuple(logits.shape) != (BATCH, 480, 480, 2) or not bool(
            torch.isfinite(logits).all()):
        raise RuntimeError(f"f32 logits: shape {tuple(logits.shape)} or "
                           f"non-finite")
    diff = (logits - want).abs().max().item()
    sure = (want[..., 1] - want[..., 0]).abs() > F32_GATE
    flips = int((logits.argmax(-1) != want.argmax(-1))[sure].sum().item())
    log(f"f32 gate, kernels vs the plain f32 model: max |dlogit| {diff:.4g} "
        f"(limit {F32_GATE}), logit scale {want.abs().max().item():.4g}; "
        f"argmax differs on {flips} of the {int(sure.sum().item())} pixels "
        f"whose plain margin exceeds {F32_GATE} "
        f"({sure.float().mean().item():.4f} of all)")
    if not diff <= F32_GATE or flips:
        raise RuntimeError("f32 gate failed")
    del logits, want
    iters, plain_iters = 10, 3
    ms = cuda_time_ms(lambda: forward(model), iters=iters, warmup=2)
    plain_ms = cuda_time_ms(lambda: forward(ref), iters=plain_iters,
                            warmup=1)
    del ref
    torch.cuda.empty_cache()
    log(f"f32 forward bs {BATCH} with the kernels: {ms:.3f} ms a batch, "
        f"{BATCH * 1000 / ms:.2f} img/s (mean of {iters}); the plain f32 "
        f"model (TF32 off): {plain_ms:.3f} ms, "
        f"{BATCH * 1000 / plain_ms:.2f} img/s (mean of {plain_iters}); peak "
        f"{peak:.3f} GiB over the fwd_iou batches  [{card}]")
    profile_clip(lambda: forward(model), card, "f32 window-12 bs-8 forward")
    swin_blocks_port_only(dev, model)
    del model
    torch.cuda.empty_cache()
    return launches


def f32_cli(dev, card, root, vocab, ckpt, batches, sentences):
    """`cli.test.main --window12 --no_bf16` in process on the synthetic
    split under `root` and its .pth, with the kernels (the f32 counters per
    device batch as the f32 forward's, every bf16 counter 0) and with
    --no_pallas (no launch): both summaries, which agree within
    F32_CLI_TOL on mIoU and oIoU, and sentences/s of each (evaluate on the
    wall clock, its first run)."""
    import contextlib
    import io

    import torch

    from lavt_rs_tpu_torch.cli import test as cli_test
    from lavt_rs_tpu_torch.eval import refcoco_eval

    argv = ["--window12", "--no_bf16", "--img_size", "480",
            "--refer_data_root", root, "--dataset", "refcoco", "--splitBy",
            "unc", "--split", "val", "--vocab", vocab, "--checkpoint", ckpt,
            "--device", str(dev)]
    evaluate, seconds = refcoco_eval.evaluate, []

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = evaluate(*a, **kw)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        return out

    per = {f"{k}.f32": n for k, n in INFER_PER_FORWARD.items()}
    summaries = {}
    refcoco_eval.evaluate = timed
    try:
        for label, extra, want in (("kernels", [], per),
                                   ("--no_pallas", ["--no_pallas"], {})):
            err = io.StringIO()
            zero_counts()
            with contextlib.redirect_stderr(err):
                summaries[label] = cli_test.main(argv + extra)
            launches = read_counts()
            torch.cuda.empty_cache()
            for line in err.getvalue().splitlines():
                log(f"cli --no_bf16 ({label}): {line}")
            check_counts(f"f32 eval ({label})", launches, want, batches)
            log(f"f32 eval via the CLI ({label}): launches over {batches} "
                f"batches {nonzero_counts(launches)}; {seconds[-1]:.3f} s, "
                f"{sentences / seconds[-1]:.2f} sentences/s, "
                f"{1e3 * seconds[-1] / batches:.3f} ms per device batch  "
                f"[{card}]")
    finally:
        refcoco_eval.evaluate = evaluate
    got, plain = summaries["kernels"], summaries["--no_pallas"]
    log(f"f32 eval summary, kernels:     {got}")
    log(f"f32 eval summary, --no_pallas: {plain}")
    log("f32 eval summary differences (kernels - plain): "
        + ", ".join(f"{k} {got[k] - plain[k]:+.5f}" for k in got))
    for k in ("mIoU", "oIoU"):
        if not abs(got[k] - plain[k]) <= F32_CLI_TOL:
            raise RuntimeError(f"f32 eval: {k} {got[k]} against --no_pallas "
                               f"{plain[k]} (limit {F32_CLI_TOL})")


def f32_phase(dev, card, res, weights, root, vocab, ckpt, batches,
              sentences):
    """Phase 3c: the f32 variants' kernel checks (`f32_kernel_phase`), the
    f32 forward (`f32_inference`) and the test CLI with --no_bf16
    (`f32_cli`); returns the forward's launch counts."""
    import torch

    t0 = time.perf_counter()
    log(f"f32 phase: torch.backends.cuda.matmul.allow_tf32 = "
        f"{torch.backends.cuda.matmul.allow_tf32}, "
        f"torch.backends.cudnn.allow_tf32 = "
        f"{torch.backends.cudnn.allow_tf32} (the plain versions, the library "
        f"chains and the plain f32 model multiply in full f32)")
    f32_kernel_phase(dev, res)
    for k in F32_NAMES:
        r = res.r[k]
        log(f"{k} per forward: kernel {r['ms']:.3f} ms (on the device, "
            f"launches queued: {r['device']:.3f} ms), bound {r['bound']:.3f} "
            f"ms ({res.bound_by(k)}), plain (f32) {r['plain']:.3f} ms, "
            f"library chain (f32, TF32 off) {r['lib']:.3f} ms")
    launches = f32_inference(dev, card, weights)
    f32_cli(dev, card, root, vocab, ckpt, batches, sentences)
    log(f"f32 phase: {time.perf_counter() - t0:.1f} s")
    return launches


def train_setup(dev, weights, cfg=None):
    """`cfg` (lavt_one_base by default) built for training with `weights`,
    its AdamW and the train step."""
    from lavt_rs_tpu_torch.config import lavt_one_base
    from lavt_rs_tpu_torch.models.factory import build_model
    from lavt_rs_tpu_torch.train.optim import TrainConfig
    from lavt_rs_tpu_torch.train.step import (create_train_state,
                                              make_train_step)

    model = build_model(cfg or lavt_one_base(), dev, train=True)
    model.load_state_dict(weights)
    tcfg = TrainConfig()
    opt, sched = create_train_state(model, tcfg)
    return make_train_step(model, opt, sched, tcfg)


def training(dev, card, weights, cfg=None, per_step=None, what="train"):
    """Steps at batch 8 (timed, counted as `per_step`, by default the
    window-12 counts; loss falls) and, for the window-12 model, one at
    batch 16; returns the launches at batch 8 and at batch 16 (None), and
    the ms per step at batch 8."""
    import torch

    step = train_setup(dev, weights, cfg)
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
    log(f"{what} launches over {TRAIN_STEPS} steps of {BATCH}: {launches}")
    check_counts(f"{what} bs 8", launches, per_step or TRAIN_PER_STEP,
                 TRAIN_STEPS)
    losses = [o["loss"].item() for o in outs]
    if not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"non-finite training loss: {losses}")
    log(f"{what} bs {BATCH} bf16 (kernels, AdamW, DropPath 0.3, dropout 0.1): "
        f"{ms:.3f} ms/step, {BATCH * 1000 / ms:.2f} img/s (mean of "
        f"{TRAIN_STEPS} steps); peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB  [{card}]")
    log(f"loss over {TRAIN_STEPS} steps on one batch (dropout reseeded each "
        f"step): first {losses[0]:.6f}, last {losses[-1]:.6f}; all "
        f"{[round(v, 6) for v in losses]}; iou {outs[-1]['iou'].item():.4f}, "
        f"lr {outs[-1]['lr']:.6g}")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"{what}: the training loss did not fall")
    if cfg is not None:
        return launches, None, ms

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
    return launches, big_launches, ms


def ln_bwd_step_check(card):
    """The window-12 bs-8 training step under torch.profiler with the LN
    backward's two call sites labelled (`tools/profile_ln.step_profile`:
    the stage norms' `LayerNormRows.backward`, K1's LN in
    `FusedWindowMSA.backward`): device busy and the LN backward's device ms
    and launches a step, beside the plain chain's that K4b replaced; each
    site launches K4b and its partial sum, no more."""
    import torch

    from lavt_rs_tpu_torch.tools import profile_ln

    wall, busy, sites = profile_ln.step_profile(torch.device("cuda:0"))
    parts = []
    for label, (ms, n) in sites.items():
        parts.append(f"{label} {fmt_ms(ms)} ms, {n:g} launches")
        calls = TRAIN_PER_STEP["K4b" if "stage" in label else "K1"]
        if ms is not None and n > LN_BWD_LAUNCHES_PER_CALL * calls:
            raise RuntimeError(f"{label}: {n:g} launches a step, more than "
                               f"K4b's {LN_BWD_LAUNCHES_PER_CALL} a call")
    total = sum(ms for ms, _ in sites.values() if ms is not None)
    log(f"window-12 bs-8 train step under torch.profiler: device busy "
        f"{busy:.3f} ms a step (wall {wall:.3f}); LN backward "
        f"{total:.4f} ms a step ({'; '.join(parts)}) [{PLAIN_LN_BWD_STEP}]  "
        f"[{card}]")


def checkpoint_training(dev, card, weights):
    """--use_checkpoint on the window-12 bs-8 step: one step after a
    warm-up one with the flag and without, each model alone on the card;
    the flagged step's launches must equal TRAIN_CKPT_PER_STEP (the
    model's `kernel_plan`, checked in main) and its peak device memory
    lie below the unflagged step's."""
    import gc

    import torch

    from lavt_rs_tpu_torch.config import lavt_one_base

    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    batch = train_batch(dev, g, BATCH)

    def one_step(cfg):
        step = train_setup(dev, weights, cfg)
        step(batch, torch.Generator(device=dev).manual_seed(SEED + 3))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        out = step(batch, torch.Generator(device=dev).manual_seed(SEED + 3))
        torch.cuda.synchronize()
        peak, launches = torch.cuda.max_memory_allocated(), read_counts()
        del step
        gc.collect()
        torch.cuda.empty_cache()
        return peak, launches, out["loss"].item()

    off, _, loss_off = one_step(lavt_one_base())
    on, launches, loss_on = one_step(lavt_one_base().replace(
        use_checkpoint=True))
    log(f"train step bs {BATCH} with --use_checkpoint: launches {launches}, "
        f"loss {loss_on:.6f} (unflagged {loss_off:.6f}); peak device memory "
        f"{on / 2**30:.3f} GiB against {off / 2**30:.3f} GiB without it  "
        f"[{card}]")
    check_counts("train --use_checkpoint", launches, TRAIN_CKPT_PER_STEP, 1)
    if not math.isfinite(loss_on):
        raise RuntimeError("non-finite loss with --use_checkpoint")
    if not on < off:
        raise RuntimeError("--use_checkpoint did not lower the training "
                           "step's peak memory")


def write_imagenet_swin(path):
    """A Swin-B window-7 ImageNet-1k checkpoint in the published format
    (`{"model": ...}`, no prefix, the final `norm`, a 1000-class `head`,
    each block's `relative_position_index` and the shifted blocks'
    `attn_mask` at 224²), its tensors drawn from a seeded CPU generator
    (weights and tables N(0, 0.02), LayerNorm scales 1 + N(0, 0.02));
    the names and shapes are the port's window-7 Swin-B backbone's."""
    import torch

    from lavt_rs_tpu_torch.config import lavt_one_base
    from lavt_rs_tpu_torch.models.factory import build_model
    from lavt_rs_tpu_torch.ops.window import relative_position_index_2d

    g = torch.Generator().manual_seed(SEED + 50)
    cfg = lavt_one_base(window12=False)
    sd = {}
    for k, v in build_model(cfg, "meta").state_dict().items():
        name = k.removeprefix("backbone.")
        if (name == k or ".fusion." in name or ".res_gate." in name
                or name.startswith("norm")):
            continue
        if name.endswith("relative_position_index"):
            sd[name] = torch.from_numpy(relative_position_index_2d(7, 7))
        else:
            sd[name] = torch.randn(v.shape, generator=g) * 0.02
            if name.endswith(("norm.weight", "norm1.weight", "norm2.weight")):
                sd[name] += 1.0
    c = cfg.swin.num_features[-1]
    sd.update({"norm.weight": torch.ones(c), "norm.bias": torch.zeros(c),
               "head.weight": torch.randn(1000, c, generator=g) * 0.02,
               "head.bias": torch.zeros(1000)})
    for i, res in enumerate((56, 28, 14)):  # stage 4 (7²) is not shifted
        for j in range(1, cfg.swin.depths[i], 2):
            sd[f"layers.{i}.blocks.{j}.attn_mask"] = torch.zeros(
                (res // 7) ** 2, 49, 49)
    torch.save({"model": sd}, path)
    return sd


def train_cli_phase(dev, card, step_ms):
    """The RefCOCO train CLI (`lavt_rs_tpu_torch.cli.train.main`) in process
    on the synthetic split's TRAIN_REFS train refs at the published
    configuration (--window12, Swin-B, 480², bf16, batch 8, -j 4, a paired
    hflip), its weights drawn by the CLI from --seed: epoch 0, then
    --resume from its checkpoint directory for epoch 1, each run evaluating
    the val split (EVAL_REFS refs) and saving a checkpoint; then the test
    CLI on that directory.  Checks the launches per step (TRAIN_PER_STEP)
    and per eval batch (INFER_PER_FORWARD), the two files and their
    metric tags, the resumed model, AdamW moments and schedule step
    against the file (bitwise), and the test CLI's summary against the
    last in-train eval's (within CLI_SUMMARY_TOL).  Prints steps/s and
    img/s, the loader's data wait against the iteration time, peak device
    memory, and ms per step beside `make_train_step`'s on one repeated
    batch (`step_ms`, this script's training phase)."""
    import contextlib
    import gc
    import io
    import re
    import tempfile

    import numpy as np
    import torch

    from lavt_rs_tpu_torch.cli import test as cli_test
    from lavt_rs_tpu_torch.cli import train as cli_train
    from lavt_rs_tpu_torch.convert import pretrained
    from lavt_rs_tpu_torch.data.refcoco import ReferDataset
    from lavt_rs_tpu_torch.data.refer import REFER
    from lavt_rs_tpu_torch.eval import refcoco_eval
    from lavt_rs_tpu_torch.text.tokenizer import WordPieceTokenizer
    from lavt_rs_tpu_torch.train import checkpoint as ckpt

    with tempfile.TemporaryDirectory() as root:
        vocab = write_refcoco(root, np.random.default_rng(SEED + 30))
        val = ReferDataset(REFER(root), WordPieceTokenizer.from_vocab_file(
            vocab), split="val", img_size=480, max_tokens=TOKENS,
            eval_mode=True)
        s_pad = max(len(x) for x in val.input_ids)
        eval_batches = -(-len(val) // -(-refcoco_eval.SENTENCES_PER_BATCH
                                        // s_pad))
        steps = TRAIN_REFS // BATCH
        out = os.path.join(root, "checkpoints")
        data = ["--window12", "--img_size", "480", "--refer_data_root", root,
                "--dataset", "refcoco", "--splitBy", "unc", "--vocab", vocab,
                "--device", str(dev)]
        argv = data + ["-b", str(BATCH), "-j", "4", "--aug_random_hflip",
                       "0.5", "--split", "train", "--val_split", "val",
                       "--print-freq", "1", "--output-dir", out]
        evaluate, restore = refcoco_eval.evaluate, ckpt.restore_checkpoint
        counts, restored = {}, []
        swin = os.path.join(root, "swin_base_patch4_window7_224.pth")
        t0 = time.perf_counter()
        swin_sd = write_imagenet_swin(swin)
        log(f"wrote {os.path.basename(swin)} ({len(swin_sd)} tensors, "
            f"{os.path.getsize(swin) / 2**20:.1f} MiB) in "
            f"{time.perf_counter() - t0:.2f} s")
        apply_flags = pretrained.apply_pretrained_flags

        def checked_apply(model, cfg, args):
            records = apply_flags(model, cfg, args)
            if not records:  # the resumed run takes no flag
                return records
            (rec,) = records
            sd = model.state_dict()
            wrong = []
            for k in rec["loaded"]:
                want = swin_sd[k.removeprefix("backbone.")]
                if k.endswith(pretrained.TABLE):
                    want = pretrained.interpolate_rel_pos_bias(want, (12, 12))
                if not torch.equal(sd[k], want.to(sd[k].device)):
                    wrong.append(k)
            skipped = " ".join(rec["skipped"])
            log(f"{rec['flag']}: loaded {len(rec['loaded'])} tensors, "
                f"skipped {len(rec['skipped'])} (head, norm, "
                f"relative_position_index, attn_mask among them), "
                f"{rec['seconds']:.2f} s in the flag (read, bicubic 7 -> 12 "
                f"on the CPU, copies to the card); tensors of the CLI's "
                f"model unequal to the file's: {wrong}  [{card}]")
            if (wrong or len(rec["loaded"]) != SWIN_B_LOADED
                    or len(rec["skipped"]) != SWIN_B_SKIPPED
                    or not all(x in skipped for x in (
                        "head.weight", "norm.weight",
                        "relative_position_index", "attn_mask"))):
                raise RuntimeError("--pretrained_swin_weights did not load "
                                   "the file as it should")
            return records

        def counted_evaluate(*a, **kw):
            torch.cuda.synchronize()
            counts["train"] = read_counts()
            zero_counts()
            t0 = time.perf_counter()
            summary = evaluate(*a, **kw)
            torch.cuda.synchronize()
            counts["eval"], counts["eval s"] = (read_counts(),
                                                time.perf_counter() - t0)
            return summary

        def checked_restore(path, model, opt, sched, device):
            result = restore(path, model, opt, sched, device)
            saved = ckpt.load_checkpoint(path, device)
            sd, st = model.state_dict(), opt.state_dict()["state"]
            want = saved["optimizer"]["state"]
            same = {
                "model": sd.keys() == saved["model"].keys() and all(
                    torch.equal(v, saved["model"][k]) for k, v in sd.items()),
                "AdamW moments": st.keys() == want.keys() and all(
                    torch.equal(t, want[i][n].to(t.device))
                    for i, s in st.items() for n, t in s.items()),
                "schedule step": sched.last_epoch
                == saved["lr_scheduler"]["last_epoch"] == steps}
            restored.append((os.path.basename(path), same))
            return result

        def run(extra, what):
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            counts.clear()
            zero_counts()
            err = io.StringIO()
            refcoco_eval.evaluate = counted_evaluate
            ckpt.restore_checkpoint = checked_restore
            pretrained.apply_pretrained_flags = checked_apply
            t0 = time.perf_counter()
            try:
                with contextlib.redirect_stderr(err):
                    rec = cli_train.main(argv + extra)
            finally:
                refcoco_eval.evaluate, ckpt.restore_checkpoint = (evaluate,
                                                                  restore)
                pretrained.apply_pretrained_flags = apply_flags
            seconds = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() / 2**30
            for line in err.getvalue().splitlines():
                log(f"train cli: {line}")
            log(f"{what}: launches over {steps} steps {counts['train']}, over "
                f"{eval_batches} eval batches {counts['eval']}")
            check_counts(f"{what} steps", counts["train"], TRAIN_PER_STEP,
                         steps)
            check_counts(f"{what} eval", counts["eval"], INFER_PER_FORWARD,
                         eval_batches)
            lg = rec["logger"]
            it, dt, loss = lg.iter_time, lg.data_time, lg.meters["loss"]
            if it.count != steps or not all(map(math.isfinite, loss.deque)):
                raise RuntimeError(f"{what}: {it.count} steps, losses "
                                   f"{list(loss.deque)}")
            log(f"{what}: {steps} steps of {BATCH}: iteration {it.avg:.4f} s "
                f"mean ({[round(x, 4) for x in it.deque]}), "
                f"{1 / it.avg:.3f} steps/s, {BATCH / it.avg:.2f} img/s; "
                f"median {1e3 * it.median:.1f} ms/step against "
                f"make_train_step's {step_ms:.1f} ms/step on one repeated "
                f"batch; data wait {dt.avg:.4f} s mean "
                f"({[round(x, 4) for x in dt.deque]}) = "
                f"{dt.total / it.total:.3f} of the iteration time; eval "
                f"{counts['eval s']:.2f} s; whole run {seconds:.1f} s; peak "
                f"device memory {peak:.2f} GiB  [{card}]")
            return rec

        rec0 = run(["--epochs", "1", "--pretrained_swin_weights", swin],
                   "train CLI epoch 0 (--pretrained_swin_weights)")
        rec1 = run(["--epochs", "2", "--resume", out],
                   "train CLI epoch 1 (--resume on the directory)")
        files = ckpt.list_checkpoints(out)
        log("train CLI checkpoints: " + ", ".join(
            f"{os.path.basename(p)} ({os.path.getsize(p) / 2**30:.2f} GiB)"
            for _, p in files))
        if [e for e, _ in files] != [0, 1] or rec1["start_epoch"] != 1:
            raise RuntimeError(f"train CLI: checkpoints {files}, resumed at "
                               f"epoch {rec1['start_epoch']}")
        for (_, path), rec in zip(files, (rec0, rec1)):
            tag = (f"_mIoU_{rec['summary']['mIoU']:.2f}"
                   f"_oIoU_{rec['summary']['oIoU']:.2f}.pth")
            if not re.fullmatch(r"epoch_000\d_lavt" + re.escape(tag),
                                os.path.basename(path)):
                raise RuntimeError(f"train CLI: {path} is not tagged {tag}")
        log(f"train CLI resume: restored {restored}")
        if len(restored) != 1 or not all(restored[0][1].values()):
            raise RuntimeError(f"train CLI: the resumed state is not the "
                               f"saved one: {restored}")

        gc.collect()
        torch.cuda.empty_cache()
        err = io.StringIO()
        zero_counts()
        with contextlib.redirect_stderr(err):
            got = cli_test.main(data + ["--split", "val", "--resume", out])
        for line in err.getvalue().splitlines():
            log(f"test cli: {line}")
        check_counts("test CLI on the train CLI's directory", read_counts(),
                     INFER_PER_FORWARD, eval_batches)
        want = rec1["summary"]
        diff = {k: got[k] - want[k] for k in ("mIoU", "oIoU")}
        log(f"test CLI on the directory: {got}; the train CLI's last eval: "
            f"{want}; differences {diff} (tolerance {CLI_SUMMARY_TOL})")
        if not all(abs(d) <= CLI_SUMMARY_TOL for d in diff.values()):
            raise RuntimeError("the test CLI does not reproduce the train "
                               "CLI's last eval")


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


def training_gate(dev, weights, base=None, what="training gate"):
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
        return (base or lavt_one_base()).replace(use_kernels=kernels,
                                                 dtype=dtype)

    ref_loss, ref = gate_run(dev, cfg(False, "float32"), weights, False,
                             batch, seed)
    loss, got = gate_run(dev, cfg(True, "bfloat16"), weights, False, batch,
                         seed)
    rel = abs(loss - ref_loss) / abs(ref_loss)
    cos = block_cosines(got, ref)
    worst = min(cos, key=cos.get)
    del ref, got
    log(f"{what} (BN running statistics, dropout + DropPath on): loss "
        f"kernel route (bf16) {loss:.6f}, plain route (f32 math) "
        f"{ref_loss:.6f}, rel diff {rel:.3g} (limit {LOSS_RTOL}); "
        f"{len(cos)} Swin blocks, worst gradient cosine {cos[worst]:.5f} "
        f"({worst}, limit {MIN_COS}); all gradients finite")
    log("per-block cosines: " + ", ".join(f"{k} {v:.4f}"
                                          for k, v in cos.items()))
    if rel > LOSS_RTOL:
        raise RuntimeError(f"{what}: loss rel diff {rel:.4g} > {LOSS_RTOL}")
    if cos[worst] < MIN_COS:
        raise RuntimeError(f"{what}: cosine {cos[worst]:.5f} < {MIN_COS}")
    if base is not None:  # the BN batch-statistics print: window 12 only
        return cos[worst]
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


def sdpa_mask(bias, mask, nw, b=1, dtype=None):
    """bias (h, N, N) + mask (nW, N, N) as one bf16 (or `dtype`) (b nW, h,
    N, N) additive mask for `scaled_dot_product_attention` (timing baseline
    only)."""
    import torch

    full = bias[None].expand(nw, *bias.shape)
    if mask is not None:
        full = full + mask[:, None]
    full = full.to(dtype or torch.bfloat16)
    return full.repeat(b, 1, 1, 1) if b > 1 else full.contiguous()


def sdpa_windows(q, k, v, am, scale):
    """One SDPA call over (B, nW, heads, N, hd) windows, B and nW merged
    into its 4-D batch (a 5-D input takes SDPA's slow math path); `am` from
    `sdpa_mask(..., b=B)`."""
    import torch.nn.functional as F

    return F.scaled_dot_product_attention(
        q.flatten(0, 1), k.flatten(0, 1), v.flatten(0, 1), attn_mask=am,
        scale=scale)


def k10_plan_line(what, b, nw, heads, n):
    """Log K10's launch plan at (B, nW, heads, N) on this card."""
    import torch

    from lavt_rs_tpu_torch.ops import window_attn

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = window_attn.k10_plan(b * nw, heads, n, sms)
    loads = (f", bias loads per block {plan['bias_loads']}"
             if "bias_loads" in plan else "")
    log(f"K10 plan {what} ({b}, {nw}, {heads}, {n}) on {sms} SMs: "
        f"{plan['blocks']} blocks x 2 warpgroups ({plan['per_sm']} per SM, "
        f"{plan['waves']:.3f} waves), {plan['units']} units of 64 rows "
        f"({plan['items']} key tiles), <= {plan['units_per_warpgroup']} per "
        f"warpgroup, {plan['smem']} B of shared memory{loads}")


def k10_on_qkv(res, name, what, calls, qkv, qkv_copies, bias, mask, heads,
               sc, masked):
    """K10 as the inference path runs it, on the qkv Linear's output (q,
    k, v read by strides, O written as (B, nW, N, C)), against its plain
    version at TOL["K2"], timed beside its bound and one SDPA call on
    `qkv_copies`, contiguous copies of the same q, k, v (on the strided
    views SDPA takes a slower path, timed and logged too); then K10 on
    those copies (the route of the save mode and K9 in training) against
    its plain version, its error into `name`'s and its time logged."""
    from lavt_rs_tpu_torch.ops import window_attn as wa

    b, nw, n, _ = qkv.shape
    am = sdpa_mask(bias, mask, nw, b)
    q, k, v = qkv_copies
    measure(res, name, f"{what} qkv{tuple(qkv.shape)} mask {mask is not None}",
            calls,
            lambda: wa.window_attention_qkv(qkv, bias, mask, heads, sc),
            lambda: wa.window_attention_qkv_plain(qkv, bias, mask, heads, sc),
            lambda: sdpa_windows(q, k, v, am, sc),
            attn_work(b, nw, heads, n, masked),
            lambda nm, got, want: compare(nm, got, want, TOL["K2"]))
    t_views = cuda_time_ms(
        lambda: sdpa_windows(*wa.qkv_heads(qkv, heads), am, sc))
    del am
    err = compare(name, wa.window_attention(q, k, v, bias, mask, sc),
                  wa.window_attention_plain(q, k, v, bias, mask, sc), TOL["K2"])
    res.r[name]["err"] = max(res.r[name]["err"], err)
    tk = cuda_time_ms(lambda: wa.window_attention(q, k, v, bias, mask, sc))
    log(f"{name} {what} contiguous q{tuple(q.shape)} mask {mask is not None}"
        f": max abs err {err:.3g}; kernel {tk:.4f} ms (not in the kernels "
        f"line: the path runs the qkv route); SDPA on the strided views "
        f"{t_views:.4f} ms")


def k2p_launch_phase(what, args):
    """K2p's three launches (`fused_msa.grouped_launches`): each launch's
    device time per call from torch.profiler over whole K2p calls (the
    two GEMMs are two kernel instances), and each launch alone by CUDA
    events with its launches queued (`queued_ms`), beside its bound; then
    the call's host time to enqueue."""
    from lavt_rs_tpu_torch.ops import fused_msa
    from lavt_rs_tpu_torch.ops import window_attn as wa

    x, wqkv, bqkv, wproj, bproj, bias, mask, nu, heads, sc = args
    b, nw, n_p, c = x.shape
    rows = b * nw * n_p
    x2 = x.view(rows, c)
    qkv = fused_msa.gemm_bias(x2, wqkv, bqkv, c, sc)
    o = wa.attention_qkv_grouped(qkv.view(b, nw, n_p, 3 * c), bias, mask, nu,
                                 heads, 1.0)
    # name, the kernel's profiler key, the launch alone, its work
    launches = (
        ("qkv GEMM", "EpiBias<true>",
         lambda: fused_msa.gemm_bias(x2, wqkv, bqkv, c, sc),
         (6 * rows * c * c, 2 * rows * c * 4 + 3 * c * c * 2)),
        ("attention (K10's kernel)", "window_attn_sm90_kernel",
         lambda: wa.attention_qkv_grouped(qkv.view(b, nw, n_p, 3 * c), bias,
                                          mask, nu, heads, 1.0),
         attn_work(b, nw, heads, n_p, masked_windows(mask))),
        ("out-projection GEMM", "EpiBias<false>",
         lambda: fused_msa.gemm_bias(o.view(rows, c), wproj, bproj),
         (2 * rows * c * c, 2 * rows * c * 2 + c * c * 2)))
    call = lambda: fused_msa.fused_window_msa_grouped(*args)  # noqa: E731
    by_kernel = device_ms_by_kernel(call) or {}
    parts = []
    for name, key, fn, work in launches:
        prof_ms = sum(ms for k, ms in by_kernel.items() if key in k) or None
        bms, by = bound_ms(work)
        parts.append(f"{name} {fmt_ms(prof_ms)} (alone, events "
                     f"{queued_ms(fn):.4f}; bound {bms:.4f} {by})")
    total = sum(by_kernel.values()) or None
    log(f"K2p launches {what}, device ms per call (torch.profiler): "
        + "; ".join(parts) + f"; the call {fmt_ms(total)} over "
        f"{len(by_kernel)} kernels, host {host_us(call):.1f} us to enqueue it")
    del qkv, o


def video_kernel_phases(dev, res):
    """K10 at the stage-2..4 shapes (and N = 196), on the qkv Linear's
    output as the blocks run it and on contiguous copies, and K2p at stage
    1, against their plain versions; per clip into `res`."""
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

                what = f"stage 1 x{tuple(xw.shape)} heads {heads} nu {nu}"
                measure(res, "K2p", what, 1,
                        lambda a=args: fused_msa.fused_window_msa_grouped(*a),
                        lambda a=args: fused_msa.fused_window_msa_grouped_plain(
                            *a),
                        chain, padded_msa_work(1, nw, n, c, heads,
                                               masked_windows(mask)),
                        lambda name, got, want: compare(
                            name, got[:, :, :n], want[:, :, :n], TOL["K2"]))
                del am
                k2p_launch_phase(what, args)
            # nu = 0 under the full (nW, N, N) shift mask, through the padded
            # wrapper (x, bias and mask padded there), against K2's plain
            # version on the unpadded windows
            x_u = xw[:, :, :n].contiguous()
            b_u = bias[:, :n, :n].contiguous()
            full = shift_mask_3d(FRAMES, hp, hp, (8, 7, 7), (0, 3, 3), dev)
            err = compare("K2p", fused_msa.fused_window_msa_padded(
                              x_u, *w, b_u, full, heads, sc),
                          fused_msa.fused_window_msa_plain(
                              x_u, *w, b_u, full, heads, sc), TOL["K2"])
            res.r["K2p"]["err"] = max(res.r["K2p"]["err"], err)
            log(f"K2p nu = 0 under the full mask (fused_window_msa_padded, "
                f"x{tuple(x_u.shape)}, mask{tuple(full.shape)}): max abs err "
                f"{err:.3g}")
            del xw, x_u, full
            continue
        # K10 on the stage's qkv Linear output, as the blocks call it
        n = 392
        k10_plan_line(f"video stage {si + 1}", 1, nw, heads, n)
        qkv = rnd((1, nw, n, 3 * c))
        qkv_copies = [t.contiguous()
                      for t in window_attn.qkv_heads(qkv, heads)]
        bias = bias_of(heads, n)
        for shift in (False, True):
            mask = None
            if shift:
                mask = shift_mask_3d(FRAMES, hp, hp, (8, 7, 7), (0, 3, 3), dev)
            k10_on_qkv(res, "K10", f"stage {si + 1}", depth // 2, qkv,
                       qkv_copies, bias, mask, heads, sc,
                       masked_windows(mask))
        if si == 1:  # a 4-frame clip's stage-2 windows (N = 196): checked
            n4 = 196
            qkv4 = rnd((1, nw, n4, 3 * c))
            q4, k4, v4 = (t.contiguous()
                          for t in window_attn.qkv_heads(qkv4, heads))
            b4 = bias_of(heads, n4)
            for route, got, want in (
                    ("qkv", window_attn.window_attention_qkv(
                        qkv4, b4, None, heads, sc),
                     window_attn.window_attention_qkv_plain(
                         qkv4, b4, None, heads, sc)),
                    ("contiguous", window_attn.window_attention(
                        q4, k4, v4, b4, None, sc),
                     window_attn.window_attention_plain(
                         q4, k4, v4, b4, None, sc))):
                err = compare("K10", got, want, TOL["K2"])
                log(f"K10 N = 196 {route} qkv{tuple(qkv4.shape)}: max abs "
                    f"err {err:.3g}")
                res.r["K10"]["err"] = max(res.r["K10"]["err"], err)
            del qkv4, q4, k4, v4
        del qkv, qkv_copies
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


def profile_clip(fn, card, what="video clip", before=None):
    """One call of fn (a clip, a step) under torch.profiler: device busy
    time (beside `before`, an earlier figure, when given) and the kernels
    that take it, by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    log_profile(prof, wall, card, what, before)


def log_profile(prof, wall, card, what, before=None):
    """A profiler session's device busy time over its `wall` ms, the idle
    share, and the kernels that take the busy time, by name."""
    import torch

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
        f"profiler on), device busy {busy:.3f} ms"
        + ("" if before is None else f" ({before})")
        + f", idle share {max(0.0, 1 - busy / wall):.3f}  [{card}]")
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


# -- A2D evaluation and YTVOS inference through the CLIs -------------------------

def video_checkpoint(root, weights):
    """The video phase's weights as a reference-format .pth under root."""
    import torch

    path = os.path.join(root, "lavt_video_tiny_a2d.pth")
    torch.save({"model": weights}, path)
    return path


def a2d_examples():
    """A2D_CLIPS in-memory A2D items: A2D_CLIP-frame 480² uint8 clips, the
    annotated frame at the consecutive window's centre, an elliptic
    target, 22 token ids with a padded mask."""
    import numpy as np

    from lavt_rs_tpu_torch.data.a2d import VideoExample
    from lavt_rs_tpu_torch.data.video_sampling import consecutive_window

    rng = np.random.default_rng(SEED + 40)
    yy, xx = np.mgrid[0:CLI_IMG, 0:CLI_IMG]
    out = []
    for i in range(A2D_CLIPS):
        indices, valid_index = consecutive_window(20 + i, 60, A2D_CLIP)
        cy, cx, ry, rx = CLI_IMG * rng.uniform((0.25, 0.25, 0.08, 0.08),
                                               (0.75, 0.75, 0.3, 0.3))
        target = (((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1)
        mask = np.zeros(VIDEO_TOKENS, np.int64)
        mask[:int(rng.integers(5, VIDEO_TOKENS + 1))] = 1
        out.append(VideoExample(
            video=rng.integers(0, 256, (len(indices), CLI_IMG, CLI_IMG, 3), np.uint8),
            target=target.astype(np.int32), valid_index=valid_index, valid=1,
            ids=rng.integers(1000, 20000, VIDEO_TOKENS), mask=mask,
            image_id=f"a2d_{i}"))
    return out


def a2d_phase(dev, card, ckpt):
    """`cli.test --dataset a2d` (lavt_video_tiny, bf16, the kernels) in
    process on A2D_CLIPS in-memory A2D_CLIP-frame 480² clips, with the
    video phase's weights as --checkpoint: launches per clip equal to
    `kernel_plan(cfg, CLI_IMG, A2D_CLIP)`, ms per clip (the CLI's cold run and
    a warm rerun of `evaluate_a2d`), clips/s, frames/s, peak memory, one
    clip's idle share (`torch.profiler`), and the annotated frame against
    the f32 plain model by the pixel gate."""
    import torch

    from lavt_rs_tpu_torch.cli import test as cli_test
    from lavt_rs_tpu_torch.data.loader import to_device
    from lavt_rs_tpu_torch.eval import video_eval
    from lavt_rs_tpu_torch.models.factory import build_model

    examples = a2d_examples()
    dataset, evaluate = cli_test.a2d_dataset, video_eval.evaluate_a2d
    runs = []

    def counted(model, ds, **kw):
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        summary = evaluate(model, ds, **kw)
        torch.cuda.synchronize()
        runs.append((model, time.perf_counter() - t0, read_counts()))
        return summary

    gc_cuda()
    torch.cuda.reset_peak_memory_stats()
    cli_test.a2d_dataset = lambda args, cfg: examples
    video_eval.evaluate_a2d = counted
    err = io.StringIO()
    try:
        with contextlib.redirect_stderr(err):
            summary = cli_test.main(list(VIDEO_RECIPE) + [
                "--dataset", "a2d", "--split", "val", "--clip_length",
                str(A2D_CLIP), "--img_size", str(CLI_IMG), "--device", str(dev),
                "--checkpoint", ckpt])
    finally:
        cli_test.a2d_dataset, video_eval.evaluate_a2d = dataset, evaluate
    peak = torch.cuda.max_memory_allocated() / 2**30
    for line in err.getvalue().splitlines():
        log(f"test cli (a2d): {line}")
    model, cold, launches = runs[0]
    cfg = model.cfg
    plan = kernel_plan(cfg, CLI_IMG, A2D_CLIP)[0]
    log(f"A2D launches over {A2D_CLIPS} {A2D_CLIP}-frame clips: "
        f"{nonzero_counts(launches)}; kernel_plan(cfg, {CLI_IMG}, {A2D_CLIP}) per "
        f"clip: {plan}")
    check_counts("A2D eval", launches, plan, A2D_CLIPS)
    counted(model, examples)
    warm, launches = runs[1][1:]
    check_counts("A2D eval (warm)", launches, plan, A2D_CLIPS)
    log(f"A2D via cli.test --model lavt_video --dataset a2d (lavt_video_tiny "
        f"bf16, the kernels, {A2D_CLIPS} {A2D_CLIP}-frame {CLI_IMG}² clips): "
        f"{summary}; cold {1e3 * cold / A2D_CLIPS:.1f} ms/clip, warm "
        f"{1e3 * warm / A2D_CLIPS:.1f} ms/clip = {A2D_CLIPS / warm:.2f} "
        f"clips/s = {A2D_CLIP * A2D_CLIPS / warm:.1f} frames/s (host clock, "
        f"pipelined decode-free loop); peak device memory {peak:.2f} GiB  "
        f"[{card}]")

    ex = examples[0]
    clip = [to_device(a, dev) for a in (ex.video, ex.ids, ex.mask)]
    profile_clip(lambda: video_eval.clip_iou(
        model, *clip, ex.valid_index, to_device(ex.target, dev)), card,
        f"A2D {A2D_CLIP}-frame clip (clip_iou)")
    temporal_geometry_ms(model, dev, card)
    v = ex.valid_index
    got = video_eval.clip_logits(model, *clip)[v:v + 1]
    ref = build_model(cfg.replace(dtype="float32", use_kernels=False), dev)
    ref.load_state_dict(model.state_dict())
    want = video_eval.clip_logits(ref, *clip)[v:v + 1]
    del ref, model
    agree = gate_pixels(f"A2D {A2D_CLIP}-frame clip", got, want,
                        (1, CLI_IMG, CLI_IMG, 2))
    log(f"A2D {A2D_CLIP}-frame clip, annotated frame {v}: bf16 kernel route "
        f"vs f32 plain route, max |dlogit| "
        f"{(got - want).abs().max().item():.4g}, argmax agreement "
        f"{agree:.5f} on the pixels of f32 margin > {MARGIN}")
    gc_cuda()


def temporal_geometry_ms(model, dev, card, forwards=3):
    """K2p's and K10's device ms per clip of the lavt_video `model` at T =
    8 (one temporal window, the shift clamped to 0), 13, 16 (two windows,
    a live shift of 4; 13 padded) and 20 (three, padded): one
    torch.profiler session over `forwards` forwards each, the kernels in
    launch order.  A forward launches K10's kernel 12 times (K2p's
    attention in the 2 stage-1 blocks first, then K10 in the 10 others)
    and the GEMM core 4 times (K2p's projections).  A session that lost
    kernel records prints "not measured"."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from lavt_rs_tpu_torch.eval.video_eval import clip_logits

    rng = np.random.default_rng(SEED + 42)
    ids = torch.from_numpy(rng.integers(1000, 20000, VIDEO_TOKENS)).to(dev)
    mask = torch.ones(VIDEO_TOKENS, dtype=torch.int64, device=dev)
    base = None
    for t in (FRAMES, 13, A2D_CLIP, 20):
        clip = torch.from_numpy(rng.integers(0, 256, (t, CLI_IMG, CLI_IMG, 3),
                                             np.uint8)).to(dev)
        clip_logits(model, clip, ids, mask)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(forwards):
                clip_logits(model, clip, ids, mask)
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA),
                        key=lambda e: e.time_range.start)
        attn = [e.time_range.elapsed_us() / 1e3 for e in events
                if "window_attn_sm90_kernel" in e.name]
        gemm = [e.time_range.elapsed_us() / 1e3 for e in events
                if "sm90::gemm_kernel" in e.name]
        windows = -(-t // 8)
        if len(attn) != 12 * forwards or len(gemm) != 4 * forwards:
            log(f"T = {t}: K2p / K10 per clip not measured (the profiler "
                f"recorded {len(attn)} attention and {len(gemm)} GEMM "
                f"launches over {forwards} forwards)")
            continue
        k2p = (sum(attn[i] for i in range(len(attn)) if i % 12 < 2)
               + sum(gemm)) / forwards
        k10 = sum(attn[i] for i in range(len(attn)) if i % 12 >= 2) / forwards
        if t == FRAMES:
            base = (k2p, k10)
        ratio = ("" if base is None else
                 f" ({k2p / base[0]:.2f}x T = 8, {k2p / base[0] / windows:.2f}x"
                 f" per window; K10 {k10 / base[1]:.2f}x, "
                 f"{k10 / base[1] / windows:.2f}x per window)")
        log(f"T = {t} ({windows} temporal window{'s' * (windows > 1)} of 8): "
            f"K2p {k2p:.3f} ms per clip, K10 {k10:.3f} ms{ratio}, device, "
            f"torch.profiler over {forwards} forwards  [{card}]")


def write_ytvos(root, rng):
    """YTVOS_VIDEOS in the competition layout under root: JPEG frames at
    their original sizes in valid/JPEGImages/<video>/, YTVOS_EXPRESSIONS
    expressions each in meta_expressions/valid/meta_expressions.json, a
    vocab.txt.  Returns the vocab's path."""
    import numpy as np
    from PIL import Image

    meta = {"videos": {}}
    for name, n, (h, w) in YTVOS_VIDEOS:
        d = os.path.join(root, "valid", "JPEGImages", name)
        os.makedirs(d)
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32) / max(h, w)
        frames = [f"{5 * t:05d}" for t in range(n)]
        for t, fr in enumerate(frames):
            smooth = np.stack([np.sin(9 * xx + 0.3 * t), np.cos(7 * yy - 0.2 * t),
                               np.sin(5 * (xx + yy) + 0.1 * t)], -1)
            img = 127.5 + 100 * smooth + rng.normal(0, 10, (h, w, 3))
            Image.fromarray(img.clip(0, 255).astype(np.uint8)).save(
                os.path.join(d, f"{fr}.jpg"), quality=90)
        meta["videos"][name] = {"frames": frames, "expressions": {
            str(e): {"exp": " ".join(rng.choice(EVAL_WORDS,
                                                int(rng.integers(2, 9))))}
            for e in range(YTVOS_EXPRESSIONS)}}
    os.makedirs(os.path.join(root, "meta_expressions", "valid"))
    with open(os.path.join(root, "meta_expressions", "valid",
                           "meta_expressions.json"), "w") as fh:
        json.dump(meta, fh)
    vocab = os.path.join(root, "vocab.txt")
    with open(vocab, "w") as fh:
        fh.write("\n".join(("[PAD]", "[UNK]", "[CLS]", "[SEP]") + EVAL_WORDS)
                 + "\n")
    return vocab


def read_masks(out):
    """{(video, expression, frame): uint8 mask} of a test_ytvos output."""
    import numpy as np
    from PIL import Image

    got = {}
    for dirpath, _, files in os.walk(out):
        for f in files:
            with Image.open(os.path.join(dirpath, f)) as im:
                got[(*os.path.relpath(dirpath, out).split(os.sep), f)] = \
                    np.asarray(im)
    return got


def ytvos_phase(dev, card, ckpt):
    """`cli.test_ytvos.main` in process on YTVOS_VIDEOS (whole videos of 20
    and 13 frames, YTVOS_EXPRESSIONS expressions each, originals of 720x1280
    and 360x640), with the video phase's weights as --checkpoint: unchunked
    and with --chunk_frames 8 --chunk_halo 8, each through the kernels and
    through the plain f32 route (--no_pallas --no_bf16).  Checks the PNGs'
    count and sizes, each forward's launches against `kernel_plan` at its
    length (none on the plain route), and every forward of the kernel
    route against the same forward of the plain route by the pixel gate.
    Prints ms per video, frames/s, the host's seconds (decode in the
    producer thread, the loop's wait on it, PNG writes), the device's idle
    share over the unchunked loop (a rerun under torch.profiler), and the
    chunked run's agreement with the unchunked one (not gated)."""
    import tempfile

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from lavt_rs_tpu_torch.cli import args as cli_args
    from lavt_rs_tpu_torch.cli import test_ytvos as cli_ytvos
    from lavt_rs_tpu_torch.eval import pipeline

    with tempfile.TemporaryDirectory() as root:
        vocab = write_ytvos(root, np.random.default_rng(SEED + 41))
        argv = list(VIDEO_RECIPE) + [
            "--ytvos_data_root", root, "--vocab", vocab, "--img_size", str(CLI_IMG),
            "--device", str(dev), "--checkpoint", ckpt]
        cfg = cli_args.model_config_from_args(cli_ytvos.get_parser().parse_args(argv))
        forward, loop = cli_ytvos.forward_clip, pipeline.run_pipelined
        chunked = ["--chunk_frames", "8", "--chunk_halo", "8"]
        plain = ["--no_pallas", "--no_bf16"]
        sessions = []

        def profiled(*a, **kw):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                waited = loop(*a, **kw)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            sessions.append((prof, wall, waited))
            return waited

        def run(extra, what, profiled_loop=False):
            lengths, logits = [], []

            def recorded(model, clip, ids, attn, video):
                out = forward(model, clip, ids, attn, video)
                lengths.append(clip.shape[0])
                logits.append(out)
                return out

            out = os.path.join(root, what.replace(" ", "_"))
            gc_cuda()
            torch.cuda.reset_peak_memory_stats()
            zero_counts()
            cli_ytvos.forward_clip = recorded
            if profiled_loop:
                pipeline.run_pipelined = profiled
            err = io.StringIO()
            try:
                with contextlib.redirect_stderr(err):
                    stats = cli_ytvos.main(argv + ["--out", out] + extra)
            finally:
                cli_ytvos.forward_clip, pipeline.run_pipelined = forward, loop
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() / 2**30
            for line in err.getvalue().splitlines():
                log(f"test_ytvos cli ({what}): {line}")
            launches = nonzero_counts(read_counts())
            want = {}
            if plain[0] not in extra:
                for t in lengths:
                    for k, n in kernel_plan(cfg, CLI_IMG, t)[0].items():
                        want[k] = want.get(k, 0) + n
            if launches != want:
                raise RuntimeError(f"YTVOS {what}: launches {launches}, the "
                                   f"kernel plan over forwards of {lengths} "
                                   f"frames gives {want}")
            masks = read_masks(out)
            sizes = {name: hw for name, _, hw in YTVOS_VIDEOS}
            n_want = sum(n for _, n, _ in YTVOS_VIDEOS) * YTVOS_EXPRESSIONS
            if len(masks) != n_want or any(
                    m.shape != sizes[k[0]] or m.dtype != np.uint8
                    for k, m in masks.items()):
                raise RuntimeError(f"YTVOS {what}: {len(masks)} PNGs (want "
                                   f"{n_want}) or wrong sizes")
            s, n_vid = stats["seconds"], stats["videos"]
            masks_per_s = sum(n * YTVOS_EXPRESSIONS
                              for _, n, _ in YTVOS_VIDEOS) / s
            log(f"YTVOS via cli.test_ytvos ({what}): {n_vid} videos, "
                f"{stats['frames']} frames, {stats['expressions']} "
                f"expressions, forwards of {lengths} frames; "
                f"{1e3 * s / n_vid:.1f} ms/video, {stats['frames'] / s:.2f} "
                f"frames/s ({masks_per_s:.2f} frame masks/s); the loop "
                f"{s:.3f} s: its wait on the producer {stats['wait_s']:.3f} "
                f"s (decode and copy {stats['decode_s']:.3f} s in the "
                f"producer thread), PNG writes {stats['write_s']:.3f} s; "
                f"launches {launches}; {len(masks)} PNGs at the original "
                f"sizes; peak {peak:.2f} GiB  [{card}]")
            return masks, logits, lengths

        full, got, lengths = run([], "unchunked")
        cut, got_cut, lengths_cut = run(chunked, "chunked 8 + halo 8")
        _, want, plain_lengths = run(plain, "plain f32")
        _, want_cut, plain_lengths_cut = run(chunked + plain,
                                             "plain f32 chunked 8 + halo 8")
        if (lengths, lengths_cut) != (plain_lengths, plain_lengths_cut):
            raise RuntimeError(f"YTVOS: the plain route's forwards "
                               f"{plain_lengths} / {plain_lengths_cut} are "
                               f"not the kernel route's {lengths} / "
                               f"{lengths_cut}")
        for what, g_all, w_all, ts in (("unchunked", got, want, lengths),
                                       ("chunked", got_cut, want_cut,
                                        lengths_cut)):
            for i, (g, w, t) in enumerate(zip(g_all, w_all, ts)):
                agree = gate_pixels(f"YTVOS {what} forward {i}", g, w, w.shape)
                log(f"YTVOS {what} forward {i} ({t} frames): bf16 kernel "
                    f"route vs f32 plain route, max |dlogit| "
                    f"{(g - w).abs().max().item():.4g}, argmax agreement "
                    f"{agree:.5f} on the pixels of f32 margin > {MARGIN}")
        del got, want, got_cut, want_cut
        same = np.mean([(cut[k] == m).mean() for k, m in full.items()])
        log(f"YTVOS chunked (8 + halo 8) against unchunked masks: "
            f"{same:.5f} of pixels equal (not gated)")
        run([], "unchunked, the loop under torch.profiler",
            profiled_loop=True)
        prof, wall, waited = sessions[0]
        log_profile(prof, wall, card,
                    f"YTVOS unchunked loop ({len(YTVOS_VIDEOS)} videos; its "
                    f"wait on the producer {1e3 * waited:.1f} ms)")
    gc_cuda()


def gc_cuda():
    """Free the card's memory held by dead tensors, the allocator's cache
    and the shift masks cached per geometry (`ops.window`)."""
    import gc

    import torch

    from lavt_rs_tpu_torch.ops.window import clear_device_caches

    clear_device_caches()
    gc.collect()
    torch.cuda.empty_cache()


def nonzero_counts(counts):
    return {k: v for k, v in counts.items() if v}


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
        k10_plan_line(f"save mode {label}", 1, nw, heads, n)
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

        def k9(q=q, k=k, v=v, bias=bias, mask=mask, do=do, o=o, lse=lse,
               flags=wa.mask_flags(mask)):
            return wa.attention_core_bwd(q, k, v, bias, mask, do, sc, o, lse,
                                         flags)

        measure(res, "K9", what, calls, k9,
                lambda: wa.attention_core_bwd_plain(q, k, v, bias, mask, do,
                                                    sc, o),
                chain_grad(sdpa_chain, (q, k, v, bias), do[0]),
                attn_bwd_work(1, nw, heads, n, masked),
                lambda name, got, want: compare_grads(name, got, want, 3))
        check_deterministic(f"K9 {what}", k9)
        defer(functools.partial(k9_profiler_checks, what, 1, nw, heads, n,
                                masked, sc, label == "stage 1 mask True"),
              q, k, v, bias, mask, do, o, lse)
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
    peak = {}

    def one_step(stp):
        """One step after a warm-up one: its peak device memory and its
        launches."""
        stp(batch, gen())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        out = stp(batch, gen())
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated(), read_counts(), out

    peak["off"], _, _ = one_step(step)
    del model, step
    torch.cuda.empty_cache()
    # --use_checkpoint: every 3D block recomputed in the backward (K10's save
    # mode twice a step); the last stage skips its language gate
    model = build_model(lavt_video_tiny().replace(use_checkpoint=True), dev,
                        train=True)
    missing, unexpected = model.load_state_dict(weights, strict=False)
    if missing or any(".res_gate." not in k for k in unexpected):
        raise RuntimeError(f"video checkpoint model: missing {missing}, "
                           f"unexpected {unexpected}")
    step = make_video_train_step(model, *create_train_state(model, tcfg), tcfg)
    peak["on"], ck_launches, out = one_step(step)
    log(f"video train step with --use_checkpoint: launches {ck_launches}, "
        f"loss {out['loss'].item():.6f}; peak device memory "
        f"{peak['on'] / 2**30:.3f} GiB against {peak['off'] / 2**30:.3f} GiB "
        f"without it  [{card}]")
    check_counts("video train --use_checkpoint", ck_launches,
                 VIDEO_CKPT_PER_STEP, 1)
    if not peak["on"] < peak["off"]:
        raise RuntimeError("--use_checkpoint did not lower the video training "
                           "step's peak memory")
    del model, step
    torch.cuda.empty_cache()
    return launches


# -- window 7, the routing cases, the new widths and the probe -------------------

def profile_forward(dev, card, model, what, before=None):
    """One bs-8 forward of a lavt_one `model` under torch.profiler (device
    busy, idle share, the kernels that take the time); `before`: an
    earlier figure printed beside the device busy."""
    import torch

    from lavt_rs_tpu_torch.ops.norm import maybe_normalize_image

    g = torch.Generator(device=dev).manual_seed(SEED + 9)
    image, ids, mask, _ = requests(dev, g, 1)[0]
    img = maybe_normalize_image(image)
    with torch.no_grad():
        profile_clip(lambda: model(img, ids[:, 0], mask[:, 0]), card, what,
                     before)


def kernel_plan(cfg, img, n, train=False):
    """The launches per forward of a bf16 `cfg` at img² (n images; for
    lavt_video one clip of n frames), per step with `train`, as the model's
    own plan gives them (its backbone's `kernel_plan`, from the routes its
    blocks take); and the parts that launch no kernel, with their reason.
    The model is built on the meta device: nothing is allocated or
    launched."""
    from lavt_rs_tpu_torch.models.factory import build_model

    backbone = build_model(cfg, "meta", train=train).backbone
    itemsize = cfg.compute_dtype.itemsize
    if cfg.name == "lavt_video":
        return backbone.kernel_plan(n, (img, img), itemsize, train)
    return backbone.kernel_plan((img, img), n, itemsize, train)


def window7_kernel_phase(dev, res):
    """K10, K10's save mode and K9 at the four window-7 shapes of a bs-8
    lavt_one_base(window12=False) forward (stage s: (8, nW, h, 49, 32);
    the shifted blocks under their (nW, 49, 49) mask), each against its
    plain version, timed beside its bound and its SDPA chain (B nW as
    SDPA's 4-D batch; autograd through it for K9); K10 on the qkv Linear's
    output as the forward runs it (and checked on contiguous copies), the
    save mode and K9 on the contiguous q, k, v training gives them; per
    forward ("K10/w7") or training step ("K10s/w7", "K9/w7") into
    `res`."""
    import torch

    from lavt_rs_tpu_torch.ops import window_attn as wa
    from lavt_rs_tpu_torch.ops.window import (relative_bias_from_table,
                                              relative_position_index_2d,
                                              shift_mask_2d)

    g = torch.Generator(device=dev).manual_seed(SEED + 30)

    def rnd(shape):
        return torch.randn(shape, generator=g, device=dev).bfloat16()

    index = torch.from_numpy(relative_position_index_2d(7, 7)).to(dev)
    sc = 32 ** -0.5
    for si, (side, c, heads, depth) in enumerate(W7_STAGES):
        nw = (side // 7) ** 2
        k10_plan_line(f"window 7 stage {si + 1}", BATCH, nw, heads, 49)
        # q, k, v: contiguous copies of the heads of one qkv Linear output,
        # so that both K10 routes see the same inputs
        qkv = rnd((BATCH, nw, 49, 3 * heads * 32))
        q, k, v = (t.contiguous() for t in wa.qkv_heads(qkv, heads))
        bias = relative_bias_from_table(
            torch.randn((13 * 13, heads), generator=g, device=dev), index)
        for shift in (False, True):
            mask = shift_mask_2d(side, side, 7, 3, dev) if shift else None
            masked = masked_windows(mask)
            am = sdpa_mask(bias, mask, nw, BATCH)
            what = f"window 7 stage {si + 1} q{tuple(q.shape)} mask {shift}"
            k10_on_qkv(res, "K10/w7", f"window 7 stage {si + 1}", depth // 2,
                       qkv, (q, k, v), bias, mask, heads, sc, masked)
            measure(res, "K10s/w7", what, depth // 2,
                    lambda m=mask: wa.window_attention_save(q, k, v, bias, m,
                                                            sc),
                    lambda m=mask: wa.window_attention_save_plain(
                        q, k, v, bias, m, sc),
                    lambda am=am: sdpa_windows(q, k, v, am, sc),
                    attn_save_work(BATCH, nw, heads, 49, masked), compare_lse)
            del am
            # both K10 routes' device time without the host's, and host time
            routes = (("contiguous q, k, v", lambda m=mask: wa.window_attention(
                          q, k, v, bias, m, sc)),
                      ("strided, on qkv", lambda m=mask: wa.window_attention_qkv(
                          qkv, bias, m, heads, sc)))
            log(f"K10 routes {what}: " + "; ".join(
                f"{name} device {queued_ms(fn):.4f} ms (events, launches "
                f"queued), host {host_us(fn):.1f} us" for name, fn in routes))
            o, lse = wa.window_attention_save(q, k, v, bias, mask, sc)
            do = rnd(q.shape)

            def sdpa_chain(q_, k_, v_, b_, mask=mask, nw=nw):
                # 4-D, B nW as SDPA's batch (5-D input takes its math path)
                return sdpa_windows(q_, k_, v_, sdpa_mask(b_, mask, nw, BATCH),
                                    sc).view(q_.shape)

            def k9(m=mask, o=o, lse=lse, do=do, flags=wa.mask_flags(mask)):
                return wa.attention_core_bwd(q, k, v, bias, m, do, sc, o, lse,
                                             flags)

            measure(res, "K9/w7", what, depth // 2, k9,
                    lambda m=mask, o=o, do=do: wa.attention_core_bwd_plain(
                        q, k, v, bias, m, do, sc, o),
                    chain_grad(sdpa_chain, (q, k, v, bias), do),
                    attn_bwd_work(BATCH, nw, heads, 49, masked),
                    lambda name, got, want: compare_grads(name, got, want, 3))
            check_deterministic(f"K9 {what}", k9)
            defer(functools.partial(k9_profiler_checks, what, BATCH, nw,
                                    heads, 49, masked, sc, False),
                  q, k, v, bias, mask, do, o, lse)
            del o, lse, do
        del qkv, q, k, v
        torch.cuda.empty_cache()
    for key, per in (("K10/w7", "forward"), ("K10s/w7", "train step"),
                     ("K9/w7", "train step")):
        r = res.r[key]
        log(f"{key} per window-7 bs-{BATCH} {per}: kernel {r['ms']:.3f} ms, "
            f"bound {r['bound']:.3f} ms ({res.bound_by(key)}), plain (f32 "
            f"math) {r['plain']:.3f} ms, library (SDPA) {r['lib']:.3f} ms")


def widths_kernel_phase(dev, res):
    """The kernels at the widths this routing added, against their plain
    versions and timed beside bound, plain and library chain, at the shapes
    their paths give them (bs 8, 480²; per-forward or per-step calls):
    K4 and K4b at 1536 (Swin-L stage 4, 1 call); K3, K8 and K7 at 384 (Swin-T
    stage 3, 6 blocks); K1 at 96 (Swin-T window-12 stage 1, 2 blocks), K2,
    the save mode, K5 and K6 at 96 (stage 1's shape, off the window-12
    path), K11 at 96 (a 448² input's stage 1, 112 -> 120).  Results go
    under "<kernel>@<C>"."""
    import torch

    from lavt_rs_tpu_torch.ops import fused_mlp, fused_msa, fused_msa_2d, ln
    from lavt_rs_tpu_torch.ops.window import (relative_bias_from_table,
                                              relative_position_index_2d,
                                              shift_mask_2d)

    g = torch.Generator(device=dev).manual_seed(SEED + 50)

    def rnd(shape, std=1.0, mean=0.0):
        return (torch.randn(shape, generator=g, device=dev) * std
                + mean).bfloat16()

    def check(tol):
        return lambda name, got, want: compare(name, got, want, tol)

    rows, c = BATCH * 15 * 15, 1536
    x = rnd((rows, c), 2.0, 0.5)
    s, b = rnd((c,), 0.2, 1.0), rnd((c,), 0.2)
    measure(res, "K4@1536", f"Swin-L stage 4 ({rows}, {c})", 1,
            lambda: ln.layer_norm_rows(x, s, b),
            lambda: ln.layer_norm_rows_plain(x, s, b),
            lambda: torch_bf16_ln(x, s, b), ln_work(rows, c), check(TOL["K4"]))
    gy, sf = rnd((rows, c)), s.float()
    measure(res, "K4b@1536", f"Swin-L stage 4 ({rows}, {c})", 1,
            lambda: ln.layer_norm_rows_bwd(x, sf, gy),
            lambda: ln.layer_norm_rows_bwd_plain(x, sf, gy),
            chain_grad(torch_bf16_ln, (x, s, b), gy), ln_bwd_work(rows, c),
            compare_ln_bwd)

    rows, c, tail = BATCH * 30 * 30, 384, 30 * 30
    args = (rnd((rows, c)), rnd((c,), 0.2, 1.0), rnd((c,), 0.2),
            rnd((4 * c, c), c ** -0.5), rnd((4 * c,), 0.2),
            rnd((c, 4 * c), (4 * c) ** -0.5), rnd((c,), 0.2))
    keep = torch.where(torch.arange(BATCH, device=dev) % 3 != 1, 1.0 / 0.7,
                       0.0).float()
    keep_rows = keep.repeat_interleave(tail)[:, None].bfloat16()
    measure(res, "K3@384", f"Swin-T stage 3 ({rows}, {c})", 6,
            lambda: fused_mlp.fused_ln_mlp(*args),
            lambda: fused_mlp.fused_ln_mlp_plain(*args),
            lambda: torch_bf16_mlp(*args), mlp_work(rows, c),
            compare_out_and_branch(args[0], TOL["K3"]))
    measure(res, "K8@384", f"Swin-T stage 3 ({rows}, {c}) keep", 6,
            lambda: fused_mlp.fused_ln_mlp_droppath(*args, keep, tail),
            lambda: fused_mlp.fused_ln_mlp_droppath_plain(*args, keep, tail),
            lambda: torch_bf16_mlp(*args, keep_rows),
            mlp_work(rows, c, keep=BATCH),
            compare_out_and_branch(args[0], TOL["K8"]))
    gy = rnd((rows, c))
    x, gam, bet, w1, b1, w2, _ = args
    measure(res, "K7@384", f"Swin-T stage 3 ({rows}, {c}) keep", 6,
            lambda: fused_mlp.fused_ln_mlp_bwd(x, gy, gam, bet, w1, b1, w2,
                                               keep, tail),
            lambda: fused_mlp.fused_ln_mlp_bwd_plain(x, gy, gam, bet, w1, b1,
                                                     w2, keep, tail),
            chain_grad(lambda *t: torch_bf16_mlp(*t, keep_rows), args, gy),
            mlp_work(rows, c, backward=True), compare_grads)
    mlp_launch_phase("Swin-T stage 3", args, gy, keep, tail)
    del args, gy, x
    torch.cuda.empty_cache()

    c, heads, nw = 96, 3, 100
    index = torch.from_numpy(relative_position_index_2d(12, 12)).to(dev)
    bias = relative_bias_from_table(
        torch.randn((23 * 23, heads), generator=g, device=dev), index)
    w = (rnd((3 * c, c), c ** -0.5), rnd((3 * c,), 0.2),
         rnd((c, c), c ** -0.5), rnd((c,), 0.2))
    lnp = (rnd((c,), 0.2, 1.0), rnd((c,), 0.2))
    sc = 32 ** -0.5
    xw = rnd((BATCH, nw, 144, c))
    for shift in (False, True):
        mask = shift_mask_2d(120, 120, 12, 6, dev) if shift else None
        tail_args = (*w, bias, mask, heads, sc)
        measure(res, "K1@96", f"Swin-T w12 stage 1 x{tuple(xw.shape)} mask "
                f"{shift}", 1,
                lambda t=tail_args: fused_msa.fused_window_msa_ln(xw, *lnp, *t),
                lambda t=tail_args: fused_msa.fused_window_msa_ln_plain(
                    xw, *lnp, *t),
                lambda t=tail_args: torch_bf16_msa(xw, *t, ln=lnp),
                msa_work(BATCH, nw, c, heads, "fwd", mask=shift),
                check(TOL["K1"]))
    mask = shift_mask_2d(120, 120, 12, 6, dev)
    tail_args = (*w, bias, mask, heads, sc)
    measure(res, "K2@96", f"x{tuple(xw.shape)} mask True (off the path)", 0,
            lambda: fused_msa.fused_window_msa(xw, *tail_args),
            lambda: fused_msa.fused_window_msa_plain(xw, *tail_args),
            lambda: torch_bf16_msa(xw, *tail_args),
            msa_work(BATCH, nw, c, heads, "fwd"), check(TOL["K2"]))
    measure(res, "save@96", f"K1 save mode x{tuple(xw.shape)}", 2,
            lambda: fused_msa.fused_window_msa_save(xw, lnp, *tail_args),
            lambda: fused_msa.fused_window_msa_save_plain(xw, lnp, *tail_args),
            lambda: torch_bf16_msa(xw, *tail_args, ln=lnp),
            msa_work(BATCH, nw, c, heads, "save", ln=True),
            lambda _n, got, want: compare_saved("K1", got, want))
    _, saved = fused_msa.fused_window_msa_save(xw, lnp, *tail_args)
    xin, resid = saved[4].view(xw.shape), saved[:4]
    gy = rnd(xw.shape)
    chain_in = (xw, *w, bias) + lnp
    what = f"x{tuple(xw.shape)} heads {heads}"
    measure(res, "K5@96", what, 2,
            lambda: fused_msa.fused_window_msa_bwd(xin, gy, w[0], w[2], resid,
                                                   heads, sc),
            lambda: fused_msa.fused_window_msa_bwd_plain(xin, gy, w[0], w[2],
                                                         resid, heads, sc),
            msa_bwd_yardstick(f"K5@96 {what}", chain_in, gy, mask, heads,
                              sc)[0],
            msa_work(BATCH, nw, c, heads, "bwd"), compare_grads)
    measure(res, "K6@96", f"{what} (off the path)", 0,
            lambda: fused_msa.fused_window_msa_bwd_recompute(
                xw, lnp, *tail_args[:6], gy, heads, sc),
            lambda: fused_msa.fused_window_msa_bwd_recompute_plain(
                xw, lnp, *tail_args[:6], gy, heads, sc),
            msa_bwd_yardstick(f"K6@96 {what}", chain_in, gy, mask, heads, sc,
                              forward=True)[0],
            msa_work(BATCH, nw, c, heads, "recompute", ln=True),
            compare_grads)
    del saved, xin, resid, gy, xw
    xm = rnd((BATCH, 120, 120, c))
    for shift in (False, True):
        mask = shift_mask_2d(120, 120, 12, 6, dev) if shift else None
        am = sdpa_mask(bias, mask, nw)
        a = (xm, *w, bias, mask, heads, sc, 12)
        measure(res, "K11@96", f"448² stage 1 x{tuple(xm.shape)} mask {shift}",
                1, lambda a=a: fused_msa_2d.fused_window_msa_2d(*a),
                lambda a=a: fused_msa_2d.fused_window_msa_2d_plain(*a),
                lambda am=am: torch_bf16_msa_2d(xm, *w, am, heads, sc),
                msa_work(BATCH, nw, c, heads, "fwd", mask=shift),
                check(TOL["K2"]))
    del xm
    torch.cuda.empty_cache()


def routing_forward(dev, card, label, cfg, img, batch):
    """One bf16 forward of a lavt_one `cfg` with the kernels at img² and
    `batch` images: its launches must equal its kernel plan (the routes
    its blocks take by the ported predicates), the routes that launch
    nothing are printed with their reason, and its argmax must agree with
    the f32 plain model's."""
    import numpy as np
    import torch

    from lavt_rs_tpu_torch.models.factory import build_model
    from lavt_rs_tpu_torch.ops.norm import maybe_normalize_image

    g = torch.Generator(device=dev).manual_seed(SEED + 40)
    model = meaningful(build_model(cfg, dev, generator=g), dev, g)
    rng = np.random.default_rng(SEED + 41)
    image = torch.randint(0, 256, (batch, img, img, 3), generator=g,
                          device=dev, dtype=torch.uint8)
    ids = torch.from_numpy(rng.integers(1000, 20000, (batch, TOKENS))).to(dev)
    mask = torch.ones((batch, TOKENS), dtype=torch.int64, device=dev)
    mask[:, 12:] = 0
    x = maybe_normalize_image(image)
    want_counts, unrouted = model.backbone.kernel_plan((img, img), batch)
    zero_counts()
    with torch.no_grad():
        logits = model(x, ids, mask)
    torch.cuda.synchronize()
    launches = {k: v for k, v in read_counts().items() if v}
    ref = build_model(cfg.replace(dtype="float32", use_kernels=False), dev)
    ref.load_state_dict(model.state_dict())
    with torch.no_grad():
        want = ref(x, ids, mask)
    del ref, model
    agree = gate_pixels(label, logits, want, (batch, img, img, 2))
    log(f"routing {label} ({img}², batch {batch}, bf16): launches "
        f"{launches}, predicted {want_counts}; argmax agreement with the f32 "
        f"plain model {agree:.5f}")
    for why in unrouted:
        log(f"  no kernel, as in the JAX package: {why}")
    if launches != want_counts:
        raise RuntimeError(f"routing {label}: launches {launches} differ from "
                           f"the kernel plan's {want_counts}")
    torch.cuda.empty_cache()
    return launches


def gate_pixels(label, got, want, shape):
    """The pixel gate: finite logits of `shape`, and argmax agreement on the
    pixels whose f32 margin exceeds MARGIN of at least MIN_AGREE."""
    import torch

    if tuple(got.shape) != tuple(shape):
        raise RuntimeError(f"{label}: logits shape {tuple(got.shape)}")
    if not bool(torch.isfinite(got).all()):
        raise RuntimeError(f"{label}: non-finite logits")
    sure = (want[..., 1] - want[..., 0]).abs() > MARGIN
    agree = (got.argmax(-1) == want.argmax(-1))[sure].float().mean().item()
    if not agree >= MIN_AGREE:
        raise RuntimeError(f"{label}: argmax agreement {agree:.5f} < "
                           f"{MIN_AGREE}")
    return agree


def routing_video(dev, card):
    """lavt_video --window12 (window (8, 12, 12), N = 1152) on one 8-frame
    480² clip: its launches equal its kernel plan (none: every 3D block
    runs the torch chain, as the JAX package runs XLA), each block's reason
    printed, the annotated frame against the f32 plain model."""
    import torch

    from lavt_rs_tpu_torch.models.factory import build_model, make_config
    from lavt_rs_tpu_torch.ops.norm import maybe_normalize_image

    cfg = make_config("lavt_video", "tiny", window12=True)
    g = torch.Generator(device=dev).manual_seed(SEED + 42)
    model = meaningful(build_model(cfg, dev, generator=g), dev, g)
    video_u8, ids, mask, valid, _ = clips(dev, g, 1)[0]
    clip = maybe_normalize_image(video_u8)[None]
    want_counts, unrouted = model.backbone.kernel_plan(FRAMES, (480, 480))
    zero_counts()
    with torch.no_grad():
        logits = model(clip, ids[None], mask[None])
    torch.cuda.synchronize()
    launches = {k: v for k, v in read_counts().items() if v}
    ref = build_model(cfg.replace(dtype="float32", use_kernels=False), dev)
    ref.load_state_dict(model.state_dict())
    with torch.no_grad():
        want = ref(clip, ids[None], mask[None])
    del ref, model
    agree = gate_pixels("lavt_video --window12", logits[valid:valid + 1],
                        want[valid:valid + 1], (1, 480, 480, 2))
    log(f"routing lavt_video --window12 (window {cfg.swin.window_size_3d}, "
        f"8-frame 480² clip, bf16): launches {launches}, predicted "
        f"{want_counts}; annotated frame argmax agreement with the f32 plain "
        f"model {agree:.5f}")
    for why in unrouted:
        log(f"  no kernel, as in the JAX package: {why}")
    if launches != want_counts:
        raise RuntimeError(f"routing lavt_video --window12: launches "
                           f"{launches} differ from the kernel plan's "
                           f"{want_counts}")
    torch.cuda.empty_cache()


def f32_refusal(dev):
    """f32 activations with the kernels on the card where a kernel of the
    plan has no f32 variant (window-7 inference: K10; window-12 training:
    K2, K4b, K5, K7, K8): build_model raises, naming them, before it
    allocates a weight or launches a kernel."""
    import torch

    from lavt_rs_tpu_torch.config import lavt_one_base
    from lavt_rs_tpu_torch.models.factory import (build_model,
                                                  kernels_without_variant)

    for what, cfg, train in (
            ("window-7 inference", lavt_one_base(window12=False,
                                                 dtype="float32"), False),
            ("window-12 training", lavt_one_base(dtype="float32"), True)):
        missing = kernels_without_variant(cfg, train)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        allocated = torch.cuda.memory_allocated(dev)
        zero_counts()
        try:
            build_model(cfg, dev, train=train)
        except NotImplementedError as e:
            message = str(e)
        else:
            raise RuntimeError(f"f32 with the kernels on the card was not "
                               f"refused: {what}")
        if ("f32 kernel variants" not in message or not missing
                or not all(k in message for k in missing)):
            raise RuntimeError(f"f32 refusal ({what}) names no ROADMAP item "
                               f"or not the missing variants {missing}: "
                               f"{message}")
        launched = {k: v for k, v in read_counts().items() if v}
        peak = torch.cuda.max_memory_allocated(dev)
        if launched or peak != allocated:
            raise RuntimeError(f"f32 refusal ({what}) came after work: "
                               f"launches {launched}, {peak - allocated} B "
                               f"allocated")
        log(f"f32 + kernels on the card, {what}: refused before any launch "
            f"or allocation: {message}")


def routing_training_step(dev, card):
    """One AdamW step of Swin-T --window12 at bs 2 (480²): the save mode
    and K5 at C = 96 (K1 at stages 1-2, K2 at 3-4), K8/K7 at 384; launches
    equal to its kernel plan."""
    import math

    import torch

    from lavt_rs_tpu_torch.config import lavt_one_tiny
    from lavt_rs_tpu_torch.models.factory import build_model
    from lavt_rs_tpu_torch.train.optim import TrainConfig
    from lavt_rs_tpu_torch.train.step import (create_train_state,
                                              make_train_step)

    cfg = lavt_one_tiny(window12=True)
    g = torch.Generator(device=dev).manual_seed(SEED + 43)
    model = build_model(cfg, dev, generator=g, train=True)
    tcfg = TrainConfig()
    step = make_train_step(model, *create_train_state(model, tcfg), tcfg)
    batch = train_batch(dev, g, 2)
    want_counts, _ = model.backbone.kernel_plan((480, 480), 2, train=True)
    zero_counts()
    out = step(batch, torch.Generator(device=dev).manual_seed(SEED + 44))
    loss = out["loss"].item()
    launches = {k: v for k, v in read_counts().items() if v}
    log(f"routing Swin-T --window12 train step (bs 2, 480²): loss "
        f"{loss:.6f}; launches {launches}, predicted {want_counts}")
    if not math.isfinite(loss):
        raise RuntimeError("Swin-T --window12 step: non-finite loss")
    if launches != want_counts:
        raise RuntimeError(f"Swin-T --window12 step: launches {launches} "
                           f"differ from the kernel plan's {want_counts}")
    del model, step
    torch.cuda.empty_cache()


def probe_phase(dev, card, res):
    """P1 and P2 against their plain version on the check input (std
    `CHECK_STD`: the softmax far from uniform) at `CHECK_ATOL` abs +
    `CHECK_RTOL` rel, after checking that a kernel writing each window's
    mean or a copy of x would fail that check there; timed at the tool's
    defaults beside their bound and `scaled_dot_product_attention(scale=1)`
    (each on the device, its launches queued: a call is shorter than the
    host's time to enqueue it);
    P1 against P2 on the tool's input at its atol 1e-2; then the tool as a
    user runs it (`python -m lavt_rs_tpu_torch.tools.probe_headbatch`, in
    process, on the card): its launches."""
    import torch
    import torch.nn.functional as F

    from lavt_rs_tpu_torch.tools import probe_headbatch as probe

    ch, heads, n, hd, grid = PROBE
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name, plan_of, cut in (("P1", probe.loop_plan, "heads"),
                               ("P2", probe.batch_plan, "slots")):
        plan = plan_of(grid, ch, heads, n, sms)
        log(f"{name} plan: {grid} row blocks of {ch} windows x {heads} heads, "
            f"{cut} split {plan['split']}: {plan['blocks']} blocks of "
            f"{plan['slots_per_block']} slots, {plan['smem']} B of shared "
            f"memory, {plan['waves']:.3f} waves at two blocks per SM")
    x = probe.probe_input(grid, ch, heads, n, hd, dev, std=probe.CHECK_STD)
    rows = x.shape[0]
    want = probe.probe_attention_plain(x, heads, n, hd)
    mean = x.float().view(rows // n, n, -1).mean(1, keepdim=True)
    for what, wrong in (("each window's mean", mean.expand(-1, n, -1)),
                        ("a copy of x", x)):
        ratio = probe.mismatch(wrong.reshape(rows, -1), want)
        log(f"P1/P2 check: a kernel writing {what} would be off by {ratio:.1f}"
            f"x the tolerance ({probe.CHECK_ATOL} abs + {probe.CHECK_RTOL} "
            f"rel, x at std {probe.CHECK_STD})")
        if not ratio > 1:
            raise RuntimeError(f"the P1/P2 check passes {what}")
    del want, mean

    def sdpa():
        q = x.view(rows // n, n, heads, hd).transpose(1, 2)
        o = F.scaled_dot_product_attention(q, q, q, scale=1.0)
        return o.transpose(1, 2).reshape(rows, heads * hd)

    def check(name, got, want):
        torch.cuda.synchronize()
        if not bool(torch.isfinite(got).all()):
            raise RuntimeError(f"{name}: non-finite kernel output")
        ratio = probe.mismatch(got, want)
        if not ratio <= 1:
            raise RuntimeError(f"{name}: kernel disagrees with its plain "
                               f"version ({ratio:.3g}x the tolerance)")
        return (got.float() - want.float()).abs().max().item()

    work = (4 * (rows // n) * heads * n * n * hd, 2 * x.numel() * 2)
    for name, fn in (("P1", probe.loop_attention),
                     ("P2", probe.batch_attention)):
        measure(res, name, f"x{tuple(x.shape)} ch {ch} heads {heads} n {n}, "
                f"std {probe.CHECK_STD}", 1,
                lambda fn=fn: fn(x, ch, heads, n, hd),
                lambda: probe.probe_attention_plain(x, heads, n, hd), sdpa,
                work, check, queued=True)
    xt = probe.probe_input(grid, ch, heads, n, hd, dev)
    diff = (probe.loop_attention(xt, ch, heads, n).float()
            - probe.batch_attention(xt, ch, heads, n).float()).abs().max()
    log(f"P1 vs P2 on the tool's input: max abs diff {diff.item():.3g} "
        f"(atol 1e-2)")
    if not diff.item() <= 1e-2:
        raise RuntimeError(f"P1 and P2 differ by {diff.item():.4g}")
    zero_counts()
    if probe.main([]) != 0:
        raise RuntimeError("the probe tool failed")
    torch.cuda.synchronize()
    launches = read_counts()
    log(f"probe tool launches: P1 {launches['P1']}, P2 {launches['P2']}  "
        f"[{card}]")
    if not (launches["P1"] and launches["P2"]):
        raise RuntimeError("the probe tool launched no P1 or P2")
    return launches


def k10_p2_only_port_kernels(dev):
    """K10 at N = 49 and 392, its save mode, its strided route on the qkv
    Linear's output, K2p at stage 1 (shifted), P1 and P2 under
    torch.profiler: only the port's kernels."""
    import torch

    from lavt_rs_tpu_torch.ops import fused_msa
    from lavt_rs_tpu_torch.ops import window_attn as wa
    from lavt_rs_tpu_torch.ops.window import (partition_3d_groups,
                                              shift_mask_2d, shift_mask_3d)
    from lavt_rs_tpu_torch.tools import probe_headbatch as probe

    g = torch.Generator(device=dev).manual_seed(SEED + 40)

    def rnd(shape):
        return torch.randn(shape, generator=g, device=dev).bfloat16()

    cases = []
    for b, nw, heads, n, mask in (
            (BATCH, 9, 32, 49, shift_mask_2d(21, 21, 7, 3, dev)),
            (1, 9, 24, 392, shift_mask_3d(FRAMES, 21, 21, (8, 7, 7),
                                          (0, 3, 3), dev))):
        qkv = rnd((b, nw, n, 3 * heads * 32))
        q, k, v = (t.contiguous() for t in wa.qkv_heads(qkv, heads))
        bias = torch.randn((heads, n, n), generator=g, device=dev)
        cases.append((qkv, q, k, v, bias, mask, heads))
    ch, heads, n, hd, grid = PROBE
    x = probe.probe_input(grid, ch, heads, n, hd, dev)
    fns = []
    for qkv, q, k, v, bias, mask, h in cases:
        fns += [lambda q=q, k=k, v=v, b=bias, m=mask: wa.window_attention(
                    q, k, v, b, m, 32 ** -0.5),
                lambda q=q, k=k, v=v, b=bias, m=mask: wa.window_attention_save(
                    q, k, v, b, m, 32 ** -0.5),
                lambda t=qkv, b=bias, m=mask, h=h: wa.window_attention_qkv(
                    t, b, m, h, 32 ** -0.5)]
    nu, mask = partition_3d_groups(FRAMES, 120, 120, FRAMES, 126, 126,
                                   (8, 7, 7), (0, 3, 3), 400, dev)
    k2p = (rnd((1, 324, 400, 96)), rnd((288, 96)) * 0.1, rnd((288,)) * 0.2,
           rnd((96, 96)) * 0.1, rnd((96,)) * 0.2,
           torch.randn((3, 400, 400), generator=g, device=dev), mask, nu, 3,
           32 ** -0.5)
    fns += [lambda: fused_msa.fused_window_msa_grouped(*k2p),
            lambda: probe.loop_attention(x, ch, heads, n, hd),
            lambda: probe.batch_attention(x, ch, heads, n, hd)]
    names = only_port_kernels("K10 (N = 49, 392), K10 save, the strided "
                              "route, K2p, P1 and P2", fns)
    for want in ("window_attn_sm90_kernel", "gemm_kernel",
                 f"probe_kernel<{n // 16}, true>",
                 f"probe_kernel<{n // 16}, false>"):
        if not any(want in nm for nm in names):
            raise RuntimeError(f"the profiler saw no {want}")


# kernels whose ptxas -v line chip_smoke prints: K2p's (the GEMM core's
# two EpiBias instances and K10's kernel), P1/P2's, K5's, K9's and the f32
# variants
PTXAS_KERNELS = {"EpiBiasILb1E": "K2p / K2 / save-mode qkv GEMM (GEMM core)",
                 "EpiBiasILb0E": "K2p / K2 / save-mode out-projection GEMM (GEMM core)",
                 "msa_fwd_sm90_kernelILb0E": "K2 attention",
                 "msa_fwd_sm90_kernelILb1E": "save-mode attention",
                 "window_attn_sm90_kernelILb0ELb0E": "K10 / K2p attention",
                 "probe_kernelILi9ELb1E": "P1 (n = 144)",
                 "probe_kernelILi9ELb0E": "P2 (n = 144)",
                 "msa_bwd_sm90_kernel": "K5 attention",
                 "EpiBf16": "K5 dattn / dx GEMM (GEMM core)",
                 "EpiStoreF32": "K5 / K7 weight-grad and K7 dgrad GEMMs (GEMM core)",
                 "attn_bwd_q_kernelILb1E": "K9 launch 1 (N > 64)",
                 "attn_bwd_q_kernelILb0E": "K9 launch 1 (N <= 64)",
                 "attn_bwd_kv_kernelILb0E": "K9 launch 2 (N > 64)",
                 "attn_bwd_kv_kernelILb1E": "K9 launch 2 (N <= 64)",
                 "gemm_f32_kernelILi0E": "K1 f32 / K11 f32 projections (3xTF32 GEMM)",
                 "gemm_f32_kernelILi1E": "K3 f32 fc1 + GELU (3xTF32 GEMM)",
                 "gemm_f32_kernelILi2E": "K3 f32 fc2 + residual (3xTF32 GEMM)",
                 "msa_f32_kernelILb0E": "K1 f32 attention",
                 "msa_f32_kernelILb1E": "K11 f32 attention (map order)",
                 "rows_f32_kernelILi1ELb0E": "K4 f32 (C = 128)",
                 "rows_f32_kernelILi8ELb1E": "K3 f32 LN rows (C = 1024)"}


def ptxas_lines(text):
    """Print the registers and spills of PTXAS_KERNELS from a build's
    ptxas -v output ("not measured" where the library was cached)."""
    import re

    found, entry = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
            continue
        if entry is None:
            continue
        key = next((k for k in PTXAS_KERNELS if k in entry), None)
        if key and ("registers" in line or "spill" in line):
            found.setdefault(key, []).append(
                line.split(":", 1)[-1].strip().rstrip("."))
    for key, what in PTXAS_KERNELS.items():
        log(f"ptxas -v {what}: "
            + ("; ".join(found[key]) if key in found else "not measured "
               "(a cached build)"))


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

    if sys.argv[1:2] == ["--deferred"]:
        return deferred_child(sys.argv[2])
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
    ptxas = io.StringIO()
    with contextlib.redirect_stdout(ptxas):  # the build's ptxas -v lines
        cuda_lib.build(verbose=True)
    cuda_lib.lib()
    log(f"kernel build+load: {time.perf_counter() - t0:.2f} s "
        f"(nvcc {cuda_lib.build_seconds} s)")
    ptxas_lines(ptxas.getvalue())

    # -- kernel phases ----------------------------------------------------
    res = kernel_phases(dev)
    for k in NAMES[:9] + ("save",):
        r = res.r[k]
        won = (f" (the faster per stage: {', '.join(r['lib_by'])})"
               if "lib_by" in r else "")
        log(f"{k} per {'forward' if k in FORWARD_NAMES else 'train step'}: kernel "
            f"{r['ms']:.3f} ms, bound {r['bound']:.3f} ms ({res.bound_by(k)}), "
            f"plain (f32 math) {r['plain']:.3f} ms, library chain "
            f"{r['lib']:.3f} ms{won}")
    log(f"K1 per forward on the device (launches queued): "
        f"{res.r['K1']['device']:.3f} ms")
    log(f"K4 per forward on the device (launches queued): "
        f"{res.r['K4']['device']:.4f} ms, by events {res.r['K4']['ms']:.4f}, "
        f"bound {res.r['K4']['bound']:.4f} ms (0.158 by events before its "
        f"redesign, PERF.md); K4b per train step (the stage norms) on the "
        f"device: {res.r['K4b']['device']:.4f} ms, by events "
        f"{res.r['K4b']['ms']:.4f}, bound {res.r['K4b']['bound']:.4f} ms")
    r = res.r["K2s"]
    log(f"K2 as the main path launches it (the save mode at stages 3-4) per "
        f"train step: kernel {r['ms']:.3f} ms, bound {r['bound']:.3f} ms "
        f"({res.bound_by('K2s')}), plain (f32 math) {r['plain']:.3f} ms, "
        f"library (matmul) chain {r['lib']:.3f} ms")
    k11_kernel_phase(dev, res)
    r = res.r["K11"]
    log(f"K11 per forward (stages 3-4): kernel {r['ms']:.3f} ms (on the "
        f"device, launches queued: {r['device']:.3f} ms), bound "
        f"{r['bound']:.3f} ms ({res.bound_by('K11')}), plain (f32 math) "
        f"{r['plain']:.3f} ms, library chain {r['lib']:.3f} ms, the route it "
        f"replaces (partition, K2, reverse) {r['replaced']:.3f} ms")
    log(f"kernel phases done at {time.perf_counter() - t_start:.1f} s")

    # -- inference main path -------------------------------------------------
    cfg = lavt_one_base()
    t0 = time.perf_counter()
    model = main_path_model(dev, torch.Generator(device=dev).manual_seed(SEED))
    log(f"model build ({cfg.dtype}, use_kernels={cfg.use_kernels}): "
        f"{time.perf_counter() - t0:.2f} s")
    infer_launches = inference(dev, card, model)
    profile_forward(dev, card, model, "window-12 bs-8 forward",
                    FIRST_DESIGN_BUSY["forward"])
    weights = model.state_dict()
    del model
    torch.cuda.empty_cache()
    log(f"inference done at {time.perf_counter() - t_start:.1f} s")

    # -- RefCOCO eval main path: the test CLI on a synthetic split -------------
    import tempfile

    with tempfile.TemporaryDirectory() as root:
        vocab, ckpt = refcoco_split(root, weights)
        eval_launches, batches, sentences = eval_phase(dev, card, weights,
                                                       root, vocab, ckpt)
        torch.cuda.empty_cache()
        log(f"eval done at {time.perf_counter() - t_start:.1f} s")

        # -- f32 inference main path: --no_bf16 with the kernels ---------------
        f32_launches = f32_phase(dev, card, res, weights, root, vocab, ckpt,
                                 batches, sentences)
        torch.cuda.empty_cache()
        log(f"f32 phase done at {time.perf_counter() - t_start:.1f} s")

    # -- video main path (its kernel phases first) ---------------------------------
    video_launches, video_weights = video(dev, card, res)
    for k in ("K10", "K2p"):
        r = res.r[k]
        log(f"{k} per clip: kernel {r['ms']:.3f} ms, bound {r['bound']:.3f} ms "
            f"({res.bound_by(k)}), plain (f32 math) {r['plain']:.3f} ms, "
            f"library {r['lib']:.3f} ms")
    log(f"video done at {time.perf_counter() - t_start:.1f} s")

    # -- the video evaluation CLIs: A2D at 16 frames, YTVOS whole videos --------
    with tempfile.TemporaryDirectory() as root:
        ckpt = video_checkpoint(root, video_weights)
        a2d_phase(dev, card, ckpt)
        log(f"A2D eval done at {time.perf_counter() - t_start:.1f} s")
        ytvos_phase(dev, card, ckpt)
        log(f"YTVOS inference done at {time.perf_counter() - t_start:.1f} s")

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
    train_launches, big_launches, step_ms = training(dev, card, weights)
    defer(functools.partial(ln_bwd_step_check, card))
    checkpoint_training(dev, card, weights)
    del weights
    torch.cuda.empty_cache()
    log(f"training done at {time.perf_counter() - t_start:.1f} s")

    # -- the RefCOCO train CLI: two epochs (a save and a resume), its evals ------
    train_cli_phase(dev, card, step_ms)
    torch.cuda.empty_cache()
    log(f"train CLI done at {time.perf_counter() - t_start:.1f} s")

    # -- window 7: lavt_one_base(window12=False), the CLI's default --------------
    from lavt_rs_tpu_torch.config import lavt_one_tiny, lavt_video_tiny
    from lavt_rs_tpu_torch.models.factory import build_model, make_config

    w7cfg = lavt_one_base(window12=False)
    for what, got, want in (
            ("window 12 forward", kernel_plan(cfg, 480, BATCH)[0],
             INFER_PER_FORWARD),
            ("window 12 step", kernel_plan(cfg, 480, BATCH, True)[0],
             nonzero_counts(TRAIN_PER_STEP)),
            ("window 12 bs-16 step",
             kernel_plan(cfg, 480, BATCH_BIG, True)[0], BIG_PER_STEP),
            ("window 12 step, --use_checkpoint",
             kernel_plan(cfg.replace(use_checkpoint=True), 480, BATCH,
                         True)[0], nonzero_counts(TRAIN_CKPT_PER_STEP)),
            ("window 7 forward", kernel_plan(w7cfg, 480, BATCH)[0],
             W7_INFER_PER_FORWARD),
            ("window 7 step", kernel_plan(w7cfg, 480, BATCH, True)[0],
             W7_TRAIN_PER_STEP),
            ("video clip", kernel_plan(lavt_video_tiny(), 480, FRAMES)[0],
             VIDEO_PER_CLIP),
            ("video step",
             kernel_plan(lavt_video_tiny(), 480, FRAMES, True)[0],
             VIDEO_TRAIN_PER_STEP),
            ("video step, --use_checkpoint",
             kernel_plan(lavt_video_tiny().replace(use_checkpoint=True), 480,
                         FRAMES, True)[0], VIDEO_CKPT_PER_STEP)):
        if got != want:
            raise RuntimeError(f"{what}: the models' kernel plan gives {got}, "
                               f"the checked counts are {want}")
    window7_kernel_phase(dev, res)
    g7 = torch.Generator(device=dev).manual_seed(SEED + 7)
    model = meaningful(build_model(w7cfg, dev, generator=g7), dev, g7)
    w7_infer = inference(dev, card, model, W7_INFER_PER_FORWARD,
                         "window-7 inference")
    profile_forward(dev, card, model, "window-7 bs-8 forward")
    w7_weights = model.state_dict()
    del model
    torch.cuda.empty_cache()
    training_gate(dev, w7_weights, w7cfg, "window-7 training gate")
    torch.cuda.empty_cache()
    w7_train, _, _ = training(dev, card, w7_weights, w7cfg,
                              W7_TRAIN_PER_STEP, "window-7 train")
    del w7_weights
    torch.cuda.empty_cache()
    log(f"window 7 done at {time.perf_counter() - t_start:.1f} s")

    # -- the routing cases and the new widths -------------------------------------
    widths_kernel_phase(dev, res)
    routing_forward(dev, card, "Swin-T window 7", lavt_one_tiny(), 480, 2)
    routing_forward(dev, card, "Swin-T --window12",
                    lavt_one_tiny(window12=True), 480, 2)
    routing_forward(dev, card, "Swin-T --window12",
                    lavt_one_tiny(window12=True), 448, 2)
    routing_forward(dev, card, "Swin-L --window12",
                    make_config("lavt_one", "large", window12=True), 480, 1)
    routing_video(dev, card)
    f32_refusal(dev)
    routing_training_step(dev, card)
    log(f"routing done at {time.perf_counter() - t_start:.1f} s")

    # -- P1 / P2: the head-batching probe --------------------------------------
    probe_launches = probe_phase(dev, card, res)
    defer(functools.partial(k10_p2_only_port_kernels, dev))
    log(f"probe done at {time.perf_counter() - t_start:.1f} s")

    # -- the profiler checks held back from the timed phases -------------------
    run_deferred()
    log(f"deferred profiler checks done at {time.perf_counter() - t_start:.1f} s")


    launches = {k: infer_launches[k] for k in ("K1", "K3", "K4")}
    launches["K11"] = eval_launches["K11"]
    launches.update({k: train_launches[k]
                     for k in ("K2", "K4b", "K5", "K7", "K8")})
    launches["K6"] = big_launches["K6"]
    launches.update({k: video_launches[k] for k in ("K10", "K2p")})
    launches["K9"] = video_train_launches["K9"]
    launches.update({k: probe_launches[k] for k in ("P1", "P2")})
    launches.update({k: f32_launches[k] for k in F32_NAMES})
    # the window-7 main path's K10 (per forward) and K9 (per training step)
    launches["K10/w7"], launches["K9/w7"] = w7_infer["K10"], w7_train["K9"]
    SOURCES.update({"K10/w7": SOURCES["K10"], "K9/w7": SOURCES["K9"]})
    REPLACES.update({"K10/w7": REPLACES["K10"], "K9/w7": REPLACES["K9"]})
    kernels = []
    for k in NAMES + ("K10/w7", "K9/w7") + F32_NAMES:
        # K2's launches on the main path are the save mode's at stages 3-4
        r = res.r["K2s" if k == "K2" else k]
        kernels.append({"name": k, "route": "cuda", "source": SOURCES[k],
                        "replaces": REPLACES[k], "launches": launches[k],
                        "max_abs_err": r["err"], "ms": r["ms"],
                        "plain_ms": r["plain"], "bound_ms": r["bound"],
                        "bound_by": res.bound_by("K2s" if k == "K2" else k),
                        "library_ms": r["lib"]})
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
