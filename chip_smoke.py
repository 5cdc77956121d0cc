#!/usr/bin/env python3
"""Smoke test of the PyTorch port (lavt_rs_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root, one card

1. Prints the card's name and power limit, then builds the hand-written
   CUDA kernels from `lavt_rs_tpu_torch/csrc` with nvcc (sm_90a) and
   prints ptxas's registers and spills of K2p's, P1/P2's, K5's, K9's and
   the f32 variants' kernels (the 3xTF32 wgmma core's instances, the f32
   MSA attention's).
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
       K1 f32 and K11 f32 with the weights' lo parts as the model keeps
       them, and launch by launch (the LN rows, qkv, the attention, the
       out-projection, the lo split) by device ms beside each bound;
     * the work around K11 f32 in a window-12 bs-8 f32 forward (the plain
       pre-attention LN, the pad, the two rolls, the crop) at the padded
       blocks' shapes by device ms under torch.profiler, recorded beside
       K11 f32's;
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
3d. f32 window attention (`--no_bf16` with the kernels at window 7 and in
   lavt_video: K10 f32 in both modes, K2p f32, K9 f32), TF32 off:
     * each on seeded f32 inputs at its path shapes against its f32 plain
       version within 1e-4 abs + 1e-4 rel, timed beside its bound, its
       plain version and its f32 library call (SDPA over B nW windows for
       K10, autograd through it for K9, linear / SDPA / linear for K2p):
       K10 f32 at the four window-7 shapes of a bs-8 forward (the strided
       route; contiguous q, k, v and, under the shift mask, the windows
       grouped by mask checked) and at video stages 2-4 of an 8-frame
       clip, K2p f32 at stage 1 (n_p = 392: no padding in f32;
       grouped by mask, unshifted and shifted; the weights' lo parts kept
       as the model keeps them; two calls give the same bits; its
       attention launch's plan printed and its shared memory held to the
       kernel's own; each launch by device ms beside its bound: qkv, the
       attention on wgmma, the out-projection, the lo split the model runs
       once a weight version), K10 f32's save mode and K9
       f32 at all four video stages (two K9 f32 calls give the same bits;
       K9 f32's device ms by kernel under torch.profiler at each; K10
       f32's, K2p f32's and K9 f32's times beside their FFMA designs',
       FFMA_DESIGN_MS); their launch plans printed, K10 f32's shared
       memory held to the kernel's own;
     * window-7 lavt_one_base in f32 on seeded window-7 weights: three
       bs-8 batches through `fwd_iou` (counts K10 f32 24 / K3 f32 24 / K4
       f32 4 a forward, no bf16 launch), the f32 gate, ms and img/s beside
       the plain f32 model, a profile;
     * `cli.test.main --no_bf16` at window 7 (the CLI's default) on 3b's
       split and those weights as a .pth, with the kernels and with
       --no_pallas: mIoU and oIoU within 0.005.
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
4d. The f32 video paths (`--no_bf16` with the kernels): lavt_video_tiny
   in f32 on the video phase's weights answers three 8-frame 480² clips
   (counts K2p f32 2 / K10 f32 10 a clip, no bf16 launch; one clip held
   to the plain f32 model by the pixel gate and the f32 gate; ms a clip
   beside the plain model; a profile); `cli.test --dataset a2d --no_bf16`
   on 8 of 4b's clips and `cli.test_ytvos --no_bf16` (unchunked) on 4c's
   videos, each against its --no_pallas --no_bf16 run (A2D: mIoU and oIoU
   within 0.005, the annotated frame by both gates; YTVOS: every forward
   by both gates), with their launches against the plan.
4e. The f32 video train step: its gate against the plain f32 step (the
   loss within 1e-4 relative, every 3D block's gradient cosine >= 0.999;
   counts K10 f32 12 / K9 f32 12), then 10 timed steps (the loss falls,
   ms a step, peak memory), a profile, and a --use_checkpoint step (K10
   f32 24 / K9 f32 12).
4f. Video train CLI: `lavt_rs_tpu_torch.cli.train.main` in process at
   the A2D recipe (VIDEO_RECIPE, 480², 8 frames, bf16, the weights drawn
   by the CLI from --seed) on data the phase writes: --dataset
   ref_pseudo_video at -b 4 -j 4 on a synthetic RefCOCO split (24 train
   refs as augmented, shuffled pseudo-clips) for two epochs, each
   evaluated by `evaluate_a2d` on the 48 val refs as static pseudo-clips;
   one epoch over the same refs as a COCO-format refexp json; --dataset
   ytvos at -b 1 on two JPEG videos with palette-PNG Annotations (16
   frames, 720x1280 and 360x640, two objects each); one epoch of
   --dataset joint (the split under the three RefCOCO-family names, then
   the YTVOS set); then the f32 gate: one ref_pseudo_video epoch with
   --no_bf16 -j 1 (the f32 launches, its f32 eval) against --no_pallas
   --no_bf16 (no launch), the first logged loss within 1e-4 relative.
   Checks the launches per step and per eval clip against the models'
   `kernel_plan` (K10 save 12 / K9 12 a step, K2p 2 / K10 10 a clip; the
   f32 variants), the checkpoints' names and tags (`tmIoU_<train>` with
   the eval's `_mIoU_<x>_oIoU_<y>`), the best-only skip of an epoch whose
   train mIoU does not improve, keep 8 for YTVOS, finite losses; prints
   steps/s, clips/s, the loader's data wait against the iteration time,
   eval seconds and clips/s, peak memory and the phase's seconds.  A2D
   training is not run here: its reader needs h5py, which the card's
   machine lacks (the CPU tests hold it).
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
6b. Window-7 training in f32 (`--no_bf16` with the kernels: K8 f32, K7
   f32 and K4b f32 beside K10 f32's save mode, K9 f32, K3 f32, K4 f32),
   TF32 off:
     * K4b f32, K8 f32 (keep with a dropped sample) and K7 f32 (with and
       without keep) at the four stage shapes of a bs-8 step, K10 f32's
       save mode and K9 f32 at the four window-7 shapes (N = 49, the 2D
       shift mask, 4-32 heads), each within 1e-4 abs + rel of its f32
       plain version, the backward's sums over rows or windows (weight,
       bias, scale and bias-table grads) within 1e-4 of (rms + |want|)
       of their f64 values, where the f32 plain version's own sums miss
       1e-4 abs + rel (both counted and printed), timed per call and per
       step beside its bound, its plain version and its f32 library
       chain, and on the device (K4b f32, at most one kernel a call under
       torch.profiler, at each stage); two calls of K4b f32, K7 f32 and K9 f32
       give the same bits; K9 f32's device ms by kernel (torch.profiler)
       at each shape and its time per step beside its FFMA design's; K8
       f32's launches (the prep: LN rows and W's lo parts; fc1 + GELU and
       fc2 + residual with W's lo by TMA) and K7 f32's (the 3xTF32 wgmma core's dual GEMM, weight
       grads and dyln, the W2 transpose, the LN rows) by device ms at each
       stage beside each
       launch's bound, their times per step beside the mma.sync tile
       loop's (MMA_SYNC_CORE_MS), and one K3 f32, one K8 f32 and one K7
       f32 call at stage 1 under torch.profiler (only the port's kernels,
       deferred to 9.);
     * the gate: one forward + backward of lavt_one_base(window12=False)
       in f32 with the kernels and of the plain f32 route from the same
       weights, batch and seed (BN batch statistics): losses within 1e-4
       relative, each of the 24 Swin blocks' gradient cosine >= 0.999,
       launches equal to the plan (K10 f32 24 / K9 f32 24 / K8 f32 23 /
       K3 f32 1 / K7 f32 24 / K4 f32 4 / K4b f32 4);
     * 10 timed bs-8 f32 steps (counts, ms/step, img/s, peak memory,
       falling loss) and one under torch.profiler (device busy, idle
       share, time by kernel);
     * `cli.train --no_bf16` at window 7 on the synthetic train refs (-j
       1): epoch 0 into a checkpoint directory, --resume for epoch 1 with
       its in-train eval on the f32 kernels (launches per step and per
       eval batch checked), and epoch 0 with --no_pallas --no_bf16: the
       first logged losses within 1e-4 relative; iteration and data
       seconds, img/s, peak memory.
6c. Window-12 training in f32 (`--window12 --no_bf16` with the kernels:
   the K1/K2 save mode f32, K5 f32, K6 f32 and K2 f32 beside K1 f32, K3,
   K8, K7, K4 and K4b f32), TF32 off:
     * the save mode f32 at stage 2 (with LN) and stages 3-4, K5 f32 at
       stages 2-4 on its residuals and K6 f32 at stage 1 (bs 8), K6 f32 at
       every stage and K2 f32 (the taped, exact form; the clamp form
       checked too) at stages 3-4 (bs 20), shifted and unshifted, each
       within 1e-4 abs + rel of its f32 plain version, K5 f32's and K6
       f32's sums over rows or windows within 1e-4 (rms + |want|) of
       their f64 values; timed per call and per step beside the bound,
       the plain version and the f32 library chain, and on the device;
       two K5 f32 calls give the same bits; K5 f32's and K6 f32's device
       ms by kernel (torch.profiler) at each shape, and their times per
       step beside their FFMA designs' (FFMA_DESIGN_MS) and the mma.sync
       GEMM's (MMA_SYNC_CORE_MS); the save mode f32's and K2 f32's
       launches (LN rows, the GEMMs on the 3xTF32 wgmma core, the
       attention on 3xTF32 mma.sync) by device ms beside each launch's
       bound; one save mode f32, one K5 f32 and one K2 f32 call (stage 2,
       shifted) under torch.profiler (only the port's kernels, deferred
       to 9.);
     * F7 on stage 1's geometry with logits past 80 (a bias table of std
       60): K1 f32 at inference against the clamp plain version, the
       taped K1 f32 and K6 f32's recomputed P against the exact one;
     * the gate of a bs-8 step against the plain f32 step (loss within
       1e-4 relative, each of the 24 Swin blocks' gradient cosine >=
       0.999, launches equal to the plan: K1 f32 2 / save mode f32 22 /
       K5 f32 22 / K6 f32 2 / K3 f32 1 / K8 f32 23 / K7 f32 24 / K4 f32 4
       / K4b f32 4, no bf16 launch), 10 timed steps (ms/step, img/s, peak
       memory, falling loss) and one under torch.profiler (device busy,
       idle share);
     * one bs-20 step with --use_checkpoint (every block recomputes: K1
       f32 / K2 f32 taped and K6 f32, no K5; peak memory) and its gate
       against the plain f32 route with --use_checkpoint;
     * `cli.train --window12 --no_bf16` (-j 1, one 3-step epoch and its
       f32 eval, launches per step and per eval batch checked) against
       `--no_pallas --no_bf16`: the first logged loss within 1e-4
       relative.
7. The routing cases: the kernels at the widths the routing added (K4
   and K4b at 1536, K3/K8/K7 at 384, K1/K2/save/K5/K6/K11 at 96) against their plain
   versions with bound / plain / library times; forwards of Swin-T
   window 7, Swin-T window 12 (480² and 448², K1 and K11 at C = 96),
   Swin-L window 12 and lavt_video --window12, each with launch counts
   equal to its model's kernel plan, each route that launches no kernel printed
   with its reason (every one a route where the JAX package runs XLA), and
   the pixel gate against the f32 plain model; f32 with the kernels:
   nothing left to refuse (window-12 training builds), and the guard,
   with K5's f32 variant taken away for the check, refuses before any
   launch or allocation, naming K5; one Swin-T window-12 training
   step at bs 2 (the save mode and K5 at C = 96).
7b. Data parallelism: DDP_WORLD processes sharing cuda:0 in a gloo group
   (`torch.multiprocessing.spawn`, a file:// rendezvous; NCCL takes one
   process a card), each building lavt_one Swin-B window 12 480² from the
   same seed (DropPath and dropout 0, weights made `meaningful`), the
   decoder's BatchNorms cross-
   process (`parallel.ddp.SyncBatchNorm2d`), the model in DDP:
     * the first step in bf16 and in f32 with the kernels at DDP_BATCH a
       rank against one process's step on the joint batch: the loss (bf16
       1e-2, f32 1e-4 relative); in f32 each Swin block's all-reduced
       gradient cosine (0.999) and the decoder BNs' running statistics
       (1e-4 of their largest magnitude), in bf16 both printed (DDP_GATES
       says why); each rank's launches equal the plan at DDP_BATCH; the
       ms of DDP_TIMED_STEPS more steps at world 1 and world 2 (on one
       card through gloo: the collectives' host cost, not a speed-up);
     * `cli.train.main` in the group for two epochs on the synthetic
       split: each epoch's shards disjoint and equal, checkpoints from
       rank 0 only without `module.` keys, a one-process --resume.
   A child's failure or a hang past DDP_LIMIT_S fails the phase.
7c. The hybrid 2D-Swin video model, lavt_video_tiny with
   --ytvos_2d_swin_3d_pwam and with --ytvos_2d_swin_pwam (seeded weights
   made meaningful): the plan against HYBRID_PER_CLIP (K10 12 / K3 6 a
   clip) and HYBRID_TRAIN_PER_STEP (K10 save 12 / K9 12 / K8 6 / K7 6);
   one 8-frame 480² clip in bf16 and f32 with the kernels against the plain
   f32 route (the pixel gate and the f32 gate on every frame; launches;
   ms per clip; a profile); the bf16 step's gate (language gates 0, BN
   running statistics) and the f32 step's (`f32_training_gate`), ms per
   step and a profile; --pretrained2d_lavt_weights from a Swin-T window-7
   lavt_one file the phase writes (loaded / skipped counts, seconds); and
   `cli.test_ytvos --ytvos_2d_swin_3d_pwam` on the YTVOS phase's videos.
7d. The other families ("families"): lavt (the two-model LAVT), lts, vlt
   and lavt_vlt at Swin-B 480² window 12 (`make_config(name, "base")`,
   seeded weights made meaningful, the class-logit gap centred on one
   batch and, for the VLT heads, scaled up to a std of 0.25): the plan against FAMILY_PER_FORWARD (K1 4 / K11 20 / K3 24 and
   K4 4 for lavt, 3 for the stage-2-4 backbones); three bs-8 batches
   through `fwd_iou` in bf16 (launches), the pixel gate against the plain
   f32 model, the f32 model with the kernels (its launches, the f32 gate),
   ms a forward of each and a profile; a bs-4 train step in bf16 (launches
   as its plan, falling loss, ms, peak) and the f32 step's gate
   (`f32_training_gate`); vlt at window 7 one bs-8 forward (K10 24 / K3 24
   / K4 3, the pixel gate); `cli.test --model lavt` from a reference
   two-dict checkpoint {'model', 'bert_model'} (bf16 launches per device
   batch; --no_bf16 against --no_pallas within F32_CLI_TOL), and
   `cli.train --model lavt --synthetic` for an epoch, whose checkpoint
   holds the two dicts and loads in `cli.test --resume`.
7e. The fusion and decoder variants ("variants"), at Swin-B 480² window
   12 from the CLIs' flags (`model_config_from_args`; VARIANT_GROUPS:
   --bcam; --gacd with ape; --efn with --interpolate_before_seg
   --seg_last; --fuse simple with --lazy_pred; --att_norm_layer_type BN,
   LN, none; Swin's drop_rate 0.1 in the BN group's step, attn_drop_rate
   0.1 in the LN group): each group's plan against the hand counts (K1 4 /
   K11 20 / K3 24 / K4 4 a forward, K4 3 under lazy_pred; a bs-4 step
   VARIANT_STEP, without K3 / K8 / K7 at drop_rate 0.1), three bs-8
   batches through `fwd_iou` in bf16 and a forward in f32 with the
   kernels against the plain f32 model (the pixel gate, the f32 gate, ms,
   a profile, the peak memory: BCAM's relevance maps above all), a bs-4
   bf16 step (falling loss, ms, peak) and the f32 step's gate;
   `cli.test --window12 --no_bf16 --efn --interpolate_before_seg
   --seg_last` against --no_pallas (mIoU and oIoU within F32_CLI_TOL);
   then lavt_video_tiny with each other 3D PWAM kind (--sep_t_pwam_inner,
   --t_pwam, --t_pwam_comp, --ts_pwam, --seq_t_pwam, --sep_seq_t_pwam,
   --sep_seq_t_pwam_inner): one 8-frame 480² clip in bf16 and f32 (K2p 2
   / K10 10 a clip, the pixel and f32 gates, ms), and a bf16 train step of
   --sep_seq_t_pwam and --ts_pwam (K10 12 / K9 12 a step, ms, peak).
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
   only-port-kernels check (K3 / K8 / K7 at each width, K5, K9, K3 /
   K8 / K7 f32, the save mode / K5 / K2 f32, and those of 8.).  No timed window follows their profiler sessions, and
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
    "K10.f32/w7": "lavt_rs_tpu/ops/pallas/window_attn.py:120",
    "K10.f32": "lavt_rs_tpu/ops/pallas/window_attn.py:120",
    "K10s.f32": "lavt_rs_tpu/ops/pallas/window_attn.py:165",
    "K2p.f32": "lavt_rs_tpu/ops/pallas/fused_msa.py:891",
    "K9.f32": "lavt_rs_tpu/ops/pallas/window_attn.py:292",
    "K8.f32": "lavt_rs_tpu/ops/pallas/fused_mlp.py:533",
    "K7.f32": "lavt_rs_tpu/ops/pallas/fused_mlp.py:477",
    "K4b.f32": "lavt_rs_tpu/ops/pallas/ln.py:89",
    "K10s.f32/w7": "lavt_rs_tpu/ops/pallas/window_attn.py:165",
    "K9.f32/w7": "lavt_rs_tpu/ops/pallas/window_attn.py:292",
    "save.f32": "lavt_rs_tpu/ops/pallas/fused_msa.py:1083",
    "K5.f32": "lavt_rs_tpu/ops/pallas/fused_msa.py:672",
    "K6.f32": "lavt_rs_tpu/ops/pallas/fused_msa.py:576",
    "K6.f32/bs20": "lavt_rs_tpu/ops/pallas/fused_msa.py:576",
    "K2.f32": "lavt_rs_tpu/ops/pallas/fused_msa.py:1261",
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
    # K1 f32's LN rows: ln.cu); K3 f32: its three launches
    "K1.f32": "lavt_rs_tpu_torch/csrc/fused_msa_f32.cu",
    "K11.f32": "lavt_rs_tpu_torch/csrc/fused_msa_f32.cu",
    "K3.f32": "lavt_rs_tpu_torch/csrc/gemm_f32.cu",
    "K4.f32": "lavt_rs_tpu_torch/csrc/ln.cu",
    # K10 f32 in both modes; K2p f32's attention launch (its projections:
    # gemm_f32.cu); K9 f32's two launches
    "K10.f32/w7": "lavt_rs_tpu_torch/csrc/window_attn_f32.cu",
    "K10.f32": "lavt_rs_tpu_torch/csrc/window_attn_f32.cu",
    "K10s.f32": "lavt_rs_tpu_torch/csrc/window_attn_f32.cu",
    "K2p.f32": "lavt_rs_tpu_torch/csrc/grouped_msa_f32.cu",
    "K9.f32": "lavt_rs_tpu_torch/csrc/window_attn_bwd_f32.cu",
    # K8 f32: K3 f32's launches with keep in fc2's epilogue; K7 f32's
    # launches; K4b f32's one launch (dx and the column sums)
    "K8.f32": "lavt_rs_tpu_torch/csrc/gemm_f32.cu",
    "K7.f32": "lavt_rs_tpu_torch/csrc/fused_mlp_bwd_f32.cu",
    "K4b.f32": "lavt_rs_tpu_torch/csrc/ln.cu",
    "K10s.f32/w7": "lavt_rs_tpu_torch/csrc/window_attn_f32.cu",
    "K9.f32/w7": "lavt_rs_tpu_torch/csrc/window_attn_bwd_f32.cu",
    # the save mode f32 and K2 f32: the attention launch (their GEMMs:
    # gemm_f32.cu); K5 f32 and K6 f32: the attention backward (their
    # products: fused_mlp_bwd_f32.cu; K6 f32's forward: fused_msa_f32.cu)
    "save.f32": "lavt_rs_tpu_torch/csrc/fused_msa_f32.cu",
    "K5.f32": "lavt_rs_tpu_torch/csrc/fused_msa_bwd_f32.cu",
    "K6.f32": "lavt_rs_tpu_torch/csrc/fused_msa_bwd_f32.cu",
    "K6.f32/bs20": "lavt_rs_tpu_torch/csrc/fused_msa_bwd_f32.cu",
    "K2.f32": "lavt_rs_tpu_torch/csrc/fused_msa_f32.cu",
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
# the video train CLI phase: the A2D recipe's batch (README.md:185) for the
# pseudo-clip and joint runs, YTVOS at batch 1; the YTVOS train videos
# ((name, frames, original (h, w)), one expression per object id)
VIDEO_CLI_BATCH, YTVOS_CLI_BATCH = 4, 1
YTVOS_TRAIN_VIDEOS = (("train_a", 16, (720, 1280)),
                      ("train_b", 16, (360, 640)))
YTVOS_TRAIN_OBJECTS = 2
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
# the f32 variants (phases 3c-3d, 4d-4e): K1 f32, K11 f32, K3 f32, K4 f32
# (their counters' names), then the rows of K10 f32 (per window-7 bs-8
# forward, per clip), K10 f32's save mode (per video train step), K2p f32
# (per clip) and K9 f32 (per video train step); the counters of those are
# "K10.f32" (both modes), "K2p.f32" and "K9.f32"
F32_NAMES = ("K1.f32", "K11.f32", "K3.f32", "K4.f32", "K10.f32/w7",
             "K10.f32", "K10s.f32", "K2p.f32", "K9.f32")
# ... and of the window-7 f32 training step (phase 6b): K8 f32, K7 f32, K4b
# f32 (their counters' names), K10 f32's save mode and K9 f32 at N = 49
# (counted on "K10.f32" and "K9.f32")
F32_TRAIN_NAMES = ("K8.f32", "K7.f32", "K4b.f32", "K10s.f32/w7", "K9.f32/w7")
# ... and of the window-12 f32 training steps (phase 6c): the K1/K2 save
# mode f32, K5 f32, K6 f32 (per bs-8 step, at stage 1), K6 f32 per bs-20
# step (every block) and K2 f32 (per bs-20 step, stages 3-4); their
# counters are "save.f32", "K5.f32", "K6.f32" (both batch sizes) and
# "K2.f32"
F32_W12_TRAIN_NAMES = ("save.f32", "K5.f32", "K6.f32", "K6.f32/bs20",
                       "K2.f32")
# the batch of the window-12 f32 step whose every block recomputes
# (`save_residuals_ok` is False at every stage from bs 19 on)
BATCH_F32_BIG = 20
# launches of a window-12 bs-8 f32 step: stage 1 recomputes (K1 f32 taped,
# exact, then K6 f32), stages 2-4 save (the save mode f32, K5 f32)
F32_W12_TRAIN_PER_STEP = {"K1.f32": 2, "save.f32": 22, "K5.f32": 22,
                          "K6.f32": 2, "K3.f32": 1, "K8.f32": 23,
                          "K7.f32": 24, "K4.f32": 4, "K4b.f32": 4}
# ... of a bs-20 step with --use_checkpoint (every block's forward kernels
# run again in its recompute): K1 f32 / K2 f32 taped and K6 f32 everywhere
F32_W12_BIG_PER_STEP = {"K1.f32": 8, "K2.f32": 40, "K6.f32": 24,
                        "K3.f32": 2, "K8.f32": 46, "K7.f32": 24,
                        "K4.f32": 4, "K4b.f32": 4}
# launches of a window-12 f32 eval batch (the f32 inference forward)
F32_W12_INFER_PER_FORWARD = {"K1.f32": 4, "K11.f32": 20, "K3.f32": 24,
                             "K4.f32": 4}
# F7: the std of the bias table that drives window-12 logits past 80
F7_BIAS_STD = 60.0
# launches of a window-7 bs-8 f32 step (the bf16 step's, on the f32
# variants) and of a window-7 f32 eval batch
F32_W7_TRAIN_PER_STEP = {"K10.f32": 24, "K9.f32": 24, "K8.f32": 23,
                         "K3.f32": 1, "K7.f32": 24, "K4.f32": 4,
                         "K4b.f32": 4}
F32_W7_INFER_PER_FORWARD = {"K10.f32": 24, "K3.f32": 24, "K4.f32": 4}
# `cli.train --no_bf16` against --no_pallas --no_bf16: the first logged
# loss, relative
F32_CLI_LOSS_RTOL = 1e-4
# launches of the f32 video paths: a clip, a train step (with
# --use_checkpoint: K10 f32's save mode again in every block's recompute)
F32_VIDEO_PER_CLIP = {"K2p.f32": 2, "K10.f32": 10}
F32_VIDEO_TRAIN_PER_STEP = {"K10.f32": 12, "K9.f32": 12}
F32_VIDEO_CKPT_PER_STEP = {"K10.f32": 24, "K9.f32": 12}
# the f32 video train step against the plain f32 step: the loss (relative)
# and each 3D block's gradient cosine
F32_LOSS_RTOL, F32_MIN_COS = 1e-4, 0.999
# the f32 A2D evaluation's in-memory clips (a quarter of the bf16 phase's)
F32_A2D_CLIPS = 8
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
# the data-parallel phase: DDP_WORLD processes sharing the card under gloo,
# DDP_BATCH images each, against one process on the joint batch; the steps
# timed after the compared first one; the join's limit (s); the gates of
# the world-2 step against the world-1 step: (loss relative, each Swin
# block's gradient cosine, the decoder BatchNorms' running statistics
# relative to their largest magnitude).  In bf16 the cosines and the
# statistics are printed, not checked: a batch of 4 rounds otherwise than
# one of 8 (GEMM tiles), and BatchNorm's batch statistics amplify that in
# any bf16 route, as the training gate records (one process, plain bf16,
# BN on running statistics: worst block cosine 0.988 between a bs-8 step
# and its two bs-4 halves; with BN's batch statistics the DDP step's
# 0.908; f32: 0.9999988; one H100 80GB HBM3 at 700 W); f32 checks
# the cross-process BatchNorm on the card
DDP_WORLD, DDP_BATCH, DDP_TIMED_STEPS, DDP_LIMIT_S = 2, 4, 3, 600
DDP_GATES = {"bfloat16": (LOSS_RTOL, None, None),
             "float32": (F32_LOSS_RTOL, F32_MIN_COS, 1e-4)}
# the hybrid 2D-Swin video model's flags, and its launches on an 8-frame
# 480² clip: the 2D window-7 blocks take K10 (N = 49) in all 12, K3 at C =
# 384 (6 blocks); in training K10's save mode and K9 in all 12, K8 (every
# stage-3 rate is > 0) and K7 at C = 384; the stage norms and the tails at
# C = 96, 192, 768 stay plain, as in the JAX package
# the other families at Swin-B 480² window 12 (bs 8): lavt's multimodal
# Swin normalizes all four stages (K4 4), the stage-2-4 backbones of lts,
# vlt and lavt_vlt three; every block on lavt_one's routes
FAMILIES = ("lavt", "lts", "vlt", "lavt_vlt")
FAMILY_PER_FORWARD = {name: {"K1": 4, "K11": 20, "K3": 24,
                             "K4": 4 if name == "lavt" else 3}
                      for name in FAMILIES}
FAMILY_W7_PER_FORWARD = {"K10": 24, "K3": 24, "K4": 3}  # vlt, window 7
FAMILY_STEP_BATCH, FAMILY_STEPS = 4, 5
# each family's class-logit bias (the last conv's), set by `balance_head`
# so that the two classes split a batch's pixels: a random head otherwise
# prefers one class everywhere and the pixel gates check a constant; a
# head whose logit gap spreads less than FAMILY_GAP_STD is scaled up to it
# first (lavt's and lts's random heads spread about that far: 67-78 % of
# their pixels past the 0.05 margin; the VLT heads' 0.2-1.3 %)
FAMILY_GAP_STD = 0.25
FAMILY_HEAD_BIAS = {"lavt": "model.classifier.conv1_1.bias",
                    "lts": "classifier.conv1_1.bias",
                    "vlt": "classifier.decoding.classifier.bias",
                    "lavt_vlt": "classifier.decoding.classifier.bias"}
# the fusion and decoder variants at Swin-B 480² window 12 (the "variants"
# phase): (label, CLI flags, Swin fields of the model, Swin fields of its
# train step), the compatible flags combined so that every variant runs
# once: BCAM alone (its relevance maps are the largest tensors), GACD with
# ape, EFN with interpolate_before_seg and seg_last, --fuse simple with
# lazy_pred, and each att_norm kind (BN with drop_rate 0.1 in the step,
# LN with attn_drop_rate 0.1, which the JAX package stores and never
# applies)
VARIANT_GROUPS = (
    ("bcam", ("--bcam",), {}, {}),
    ("gacd+ape", ("--gacd",), {"ape": True}, {}),
    ("efn+ibs+seg_last", ("--efn", "--interpolate_before_seg", "--seg_last"),
     {}, {}),
    ("simple+lazy_pred", ("--fuse", "simple", "--lazy_pred"), {}, {}),
    ("BN att_norm", ("--att_norm_layer_type", "BN"), {}, {"drop_rate": 0.1}),
    ("LN att_norm", ("--att_norm_layer_type", "LN"),
     {"attn_drop_rate": 0.1}, {}),
    ("none att_norm", ("--att_norm_layer_type", "none"), {}, {}),
)
# their head is lavt_one's (`balance_head`)
FAMILY_HEAD_BIAS.update({group[0]: "classifier.conv1_1.bias"
                         for group in VARIANT_GROUPS})
# the group whose weights go through `cli.test --no_bf16` against
# --no_pallas, on the first VARIANT_CLI_REFS refs of the synthetic split
VARIANT_CLI_GROUP, VARIANT_CLI_REFS = "efn+ibs+seg_last", 16
# launches of a window-12 bs-4 train step (the save mode at every block,
# K5 behind it; K3 in the first block of stage 1, whose DropPath rate is
# 0, K8 in the others); with drop_rate > 0 the tails take the chain (no
# K3 / K8 / K7); under lazy_pred three stage norms
VARIANT_STEP = {"K1": 4, "K2": 20, "K5": 24, "K3": 1, "K8": 23, "K7": 24,
                "K4": 4, "K4b": 4}
# the other 3D PWAM kinds on lavt_video_tiny (the A2D recipe's flags): each
# one 8-frame 480² clip in bf16 and f32 (VIDEO_PER_CLIP: the kinds sit
# after the same Video Swin-T blocks); a bf16 train step of those in
# VARIANT_VIDEO_STEPS (VIDEO_TRAIN_PER_STEP)
VARIANT_VIDEO_FLAGS = ("--sep_t_pwam_inner", "--t_pwam", "--t_pwam_comp",
                       "--ts_pwam", "--seq_t_pwam", "--sep_seq_t_pwam",
                       "--sep_seq_t_pwam_inner")
VARIANT_VIDEO_STEPS = ("--sep_seq_t_pwam", "--ts_pwam")
HYBRID_FLAGS = ("--ytvos_2d_swin_3d_pwam", "--ytvos_2d_swin_pwam")
HYBRID_PER_CLIP = {"K10": 12, "K3": 6}
HYBRID_TRAIN_PER_STEP = {"K10": 12, "K9": 12, "K8": 6, "K7": 6}
# device busy under torch.profiler on the first K1/K11 design (one
# H100 80GB HBM3 at 700 W, this script; PERF.md section 5), printed beside
# this run's
FIRST_DESIGN_BUSY = {
    "forward": "28.0-29.3 ms on the first K1/K11 design, PERF.md",
    "eval batch": "78.7-80.8 ms on the first K1/K11 design, PERF.md"}
# the f32 attention backwards' times per training step on their FFMA
# designs, before the 3xTF32 tensor-core ones (one H100 80GB HBM3 at 700
# W, this script; PERF.md section 6), printed beside this run's
FFMA_DESIGN_MS = {
    "K10.f32/w7": "3.178 ms a window-7 bs-8 forward",
    "K10.f32": "4.209 ms a clip",
    "K10s.f32": "6.764 ms a video step",
    "K10s.f32/w7": "3.456-3.497 ms a window-7 bs-8 step",
    "K2p.f32": "2.882-2.917 ms a clip (its attention launch)",
    "K9.f32": "30.132 ms a video step",
    "K9.f32/w7": "11.485-11.487 ms a window-7 bs-8 step",
    "K5.f32": "42.676-42.856 ms a window-12 bs-8 step",
    "K6.f32": "7.711-7.717 ms a window-12 bs-8 step",
    "K6.f32/bs20": "154.334-154.601 ms a window-12 bs-20 step"}
# the f32 variants' times on the mma.sync GEMM tile loop and the FFMA MSA
# attention, before the 3xTF32 wgmma + TMA core (one H100 80GB HBM3 at
# 700 W, this script; PERF.md section 6), printed beside this run's
MMA_SYNC_CORE_MS = {
    "K1.f32": "2.871-2.913 ms a forward",
    "K11.f32": "13.915-13.926 ms a forward",
    "K3.f32": "17.111-17.162 ms a forward; on the shared 3xTF32 wgmma core's "
              "three launches 9.756-9.780",
    "K8.f32": "16.331-17.799 ms a window-7 bs-8 step; on the shared 3xTF32 "
              "wgmma core's three launches 9.463-9.550",
    "K7.f32": "44.137-44.220 ms a window-7 bs-8 step",
    "save.f32": "18.811-18.905 ms a window-12 bs-8 step",
    "K5.f32": "33.288-33.576 ms a window-12 bs-8 step",
    "K6.f32": "5.778-5.810 ms a window-12 bs-8 step",
    "K6.f32/bs20": "128.030-128.550 ms a window-12 bs-20 step",
    "K2.f32": "34.616-35.057 ms a window-12 bs-20 step"}
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


def ln_bwd_work(rows, c, item=2):
    """K4b: x and g read, dx written (bf16; f32 for K4b f32: item 4), the
    f32 scale read and dscale, dbias written; ~16 operations an element
    (stats, xhat, the two row means, dx, the column sums)."""
    return 16 * rows * c, 3 * rows * c * item + 3 * c * 4


def mlp_work(m, c, backward=False, keep=0, item=2):
    """K3/K8 forward: two GEMMs of 2 M C 4C; K7: five (hpre recomputed,
    dh, dW2, dW1, dyln).  Bytes: x (and gy) read, out (dx) written, the
    bf16 weights read (item 4: the f32 variants' f32 tensors), the f32
    weight grads written."""
    w = 8 * c * c * item + 5 * c * item
    if backward:
        return 40 * m * c * c, 3 * m * c * item + w + (8 * c * c + 7 * c) * 4
    return 16 * m * c * c, 2 * m * c * item + w + keep * 4


def msa_work(b, nw, c, heads, mode, ln=False, mask=True, item=2):
    """mode 'fwd' (K1/K2), 'save' (save mode), 'bwd' (K5) or 'recompute'
    (K6).  Operations: the qkv (6 rows C²) and out-projection (2 rows C²)
    GEMMs and two N x N x hd products per window and head forward; the
    backward's dattn (2), dx (6), dWqkv (6), dWproj (2 rows C²) GEMMs and
    five N x N x hd products, plus, recomputing, the qkv GEMM and q kᵀ.
    Activations, weights and P of `item` bytes (4: the f32 variants)."""
    n, hd = 144, 32
    rows, m = b * nw * n, b * nw
    att = 2 * m * heads * n * n * hd
    act = rows * c * item
    weights = 4 * c * c * item + 4 * c * item
    tables = heads * n * n * 4 + (nw * n * n * 4 if mask else 0)
    p_bytes = m * heads * n * n * item
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


def f64_grads(fn, inputs, gy):
    """The backward of fn (a PyTorch chain of the kernel's function) by
    autograd in f64 from the same inputs and gradient: the sums' reference,
    far past f32's rounding."""
    import torch

    leaves = [t.detach().double().requires_grad_() for t in inputs]
    return torch.autograd.grad(fn(*leaves), leaves, gy.double())


def sum_err(got, want64):
    """(max |got - want64| / (rms(want64) + |want64|), the elements where
    |got - want64| > F32_TOL (1 + |want64|)): the error of an f32 sum over
    many rows on the scale of its terms' sum, and its misses of 1e-4 abs +
    rel."""
    w = want64.double()
    e = (got.double() - w).abs()
    return ((e / (w.square().mean().sqrt() + w.abs())).max().item(),
            int((e > F32_TOL * (1 + w.abs())).sum()))


def check_f32_backward(ref64, n_rows):
    """A check of an f32 backward kernel's outputs: the first n_rows (dx;
    K9's dq, dk, dv) elementwise within F32_TOL abs + rel of the f32 plain
    version; each later one, a sum over up to 115,200 rows or 2,592
    windows (a weight, bias, scale or bias-table grad), against `ref64`
    (`f64_grads`) within F32_TOL (rms(want) + |want|).  The f32 plain
    version's own sums miss 1e-4 abs + rel of the f64 values at such
    sizes (a sum of M terms of O(1) carries f32 rounding of its natural
    scale); its error is printed beside the kernel's.  Returns the max abs
    error over every output (the sums' against f64)."""
    def check(name, got, want):
        err = max(compare(name, g, w, F32_TOL)
                  for g, w in zip(got[:n_rows], want[:n_rows]))
        pairs = list(zip(got[n_rows:], want[n_rows:], ref64[n_rows:]))
        kern = [sum_err(g, r) for g, _, r in pairs]
        plain = [sum_err(w, r) for _, w, r in pairs]
        err = max([err] + [(g.double() - r).abs().max().item()
                           for g, _, r in pairs])
        log(f"{name}: its sums against f64, max |err| / (rms + |want|): "
            f"kernel {max(k for k, _ in kern):.3g}, f32 plain version "
            f"{max(p for p, _ in plain):.3g} (limit {F32_TOL}); elements "
            f"past 1e-4 abs + rel of f64: kernel "
            f"{sum(n for _, n in kern)}, f32 plain version "
            f"{sum(n for _, n in plain)} of "
            f"{sum(r.numel() for _, _, r in pairs)}")
        kern = max(k for k, _ in kern)
        if kern > F32_TOL:
            raise RuntimeError(f"{name}: a sum disagrees with its f64 value "
                               f"({kern:.4g} > {F32_TOL} of rms + |want|)")
        return err
    return check


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


def mlp_launch_work(m, c, splits, item=2):
    """(operations, bytes) of each launch of K3/K8 and K7 at (M, C), hidden
    4C, on `item`-byte activations and weights: each input read once and
    each output written once (the f32 partials of the weight grads:
    `splits` of each)."""
    hd = 4 * c
    act, hid, w = m * c * item, m * hd * item, hd * c * item
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


def k4b_f32_kernel_check(what, x, scale, gy, calls=5, tries=3):
    """K4b f32 launches one kernel a call (its partial sums in the same
    launch), by torch.profiler over `calls` calls, the most launches of
    `tries` sessions (a session can drop records): fails on more launches
    than calls or more than one kernel name."""
    from lavt_rs_tpu_torch.ops import ln

    def fn():
        return ln.layer_norm_rows_bwd_f32(x, scale, gy)

    fn()
    session = max((_device_session(fn, calls) for _ in range(tries)),
                  key=lambda ses: sum(count for _, count in ses.values()))
    launches = sum(count for _, count in session.values())
    if launches > calls or len(session) > 1:
        raise RuntimeError(f"{what}: {launches} kernel launches over {calls} "
                           f"calls ({sorted(session)}), not one a call")
    log(f"{what}: {launches} kernel launches over {calls} calls under "
        f"torch.profiler ({', '.join(short_kernel(k) for k in session)})")


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


def save_launch_work(b, nw, c, heads, ln, masked, save=True, item=2):
    """(operations, bytes) of each launch of the save mode (K1 / K2 /
    K11's without save) at (B, nW, 144, C) on `item`-byte activations,
    weights and P: each input read once and each output written once."""
    n, rows, m = 144, b * nw * 144, b * nw
    act = rows * c * item
    att = 4 * m * heads * n * n * 32
    att_bytes = (4 * act + heads * n * n * 4 + masked * n * n * 4
                 + (m * heads * n * n * item if save else 0))
    work = {"qkv": (6 * rows * c * c, 4 * act + (3 * c * c + 3 * c) * item),
            "attention": (att, att_bytes),
            "out-projection": (2 * rows * c * c,
                               2 * act + (c * c + c) * item)}
    if ln:
        work["LN rows"] = ln_work(rows, c, item)
    return work


def f32_launch_line(label, fn, work):
    """fn's launches by device ms a launch (`log_device_by_kernel`) after
    each launch's bound at the f32 peak (PEAK_FLOPS_F32)."""
    log(f"{label}: bounds " + "; ".join(
        f"{k} {bound_ms(v, PEAK_FLOPS_F32)[0]:.4f} "
        f"{bound_ms(v, PEAK_FLOPS_F32)[1]}" for k, v in work.items()))
    log_device_by_kernel(label, fn)


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


def f32_msa_port_check(what, heads, sc, x, ln_s, ln_b, wqkv, bqkv, wproj,
                       bproj, bias, mask, flags, gy):
    """One save mode f32, one K5 f32 (on its residuals) and one K2 f32
    call under torch.profiler: only the port's kernels."""
    from lavt_rs_tpu_torch.ops import fused_msa

    lnp = None if ln_s is None else (ln_s, ln_b)
    w = (wqkv, bqkv, wproj, bproj, bias, mask, heads, sc)
    _, saved = fused_msa.fused_window_msa_save(x, lnp, *w, flags=flags)
    xin = x if lnp is None else saved[4].view(x.shape)
    only_port_kernels(what, [
        lambda: fused_msa.fused_window_msa_save(x, lnp, *w, flags=flags),
        lambda: fused_msa.fused_window_msa_bwd(xin, gy, wqkv, wproj,
                                               saved[:4], heads, sc),
        lambda: fused_msa.fused_window_msa(x, *w, flags=flags, exact=True)])


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


def msa_f32_launch_lines(label, x, lnp, w, bias, mask, flags, heads, sc, lo):
    """K1 f32's (lnp given: x (B, nW, 144, C)) or K11 f32's (x the (B, Hp,
    Wp, C) map) launches one by one, each by device ms a call (CUDA events
    around its launches queued behind a device sleep, `queued_ms`) beside
    its bound at the f32 peak: the LN rows (K1 f32), qkv with wqkv's lo,
    the attention, the out-projection with wproj's lo, and the lo split of
    both weights that the model runs once a weight version
    (`WindowAttention.weight_lo`)."""
    from lavt_rs_tpu_torch.ops import fused_msa, fused_msa_2d, ln

    c = x.shape[-1]
    rows = x.numel() // c
    b, nw = x.shape[0], rows // x.shape[0] // 144
    x2 = x.reshape(rows, c)
    xn = ln.layer_norm_rows_launch(x2, *lnp) if lnp is not None else x2
    qkv = fused_msa.gemm_bias(xn, w[0], w[1], c, sc, wlo=lo[0])
    if lnp is not None:
        def attn():
            return fused_msa.msa_attn_f32(qkv.view(-1, 144, 3 * c), bias, mask,
                                          heads, flags)[0]
    else:
        def attn():
            return fused_msa_2d.msa_attn_map_f32(qkv.view(*x.shape[:3], 3 * c),
                                                 bias, mask, heads, flags)
    o = attn().reshape(rows, c)
    work = save_launch_work(b, nw, c, heads, lnp is not None,
                            masked_windows(mask), save=False, item=4)
    work["lo split"] = (0, 2 * 4 * 4 * c * c)
    parts = {}
    if lnp is not None:
        parts["LN rows"] = lambda: ln.layer_norm_rows_launch(x2, *lnp)
    parts["qkv"] = lambda: fused_msa.gemm_bias(xn, w[0], w[1], c, sc,
                                               wlo=lo[0])
    parts["attention"] = attn
    parts["out-projection"] = lambda: fused_msa.gemm_bias(o, w[2], w[3],
                                                          wlo=lo[1])
    parts["lo split"] = lambda: (fused_msa.tf32_lo(w[0]),
                                 fused_msa.tf32_lo(w[2]))
    log(f"{label}: device ms a call by launch (launches queued), bound at "
        f"the f32 peak: " + "; ".join(
            f"{k} {queued_ms(fn):.4f} (bound "
            f"{bound_ms(work[k], PEAK_FLOPS_F32)[0]:.4f} "
            f"{bound_ms(work[k], PEAK_FLOPS_F32)[1]})"
            for k, fn in parts.items()))


def k2p_f32_plan_line(nw, heads, n, sms):
    """K2p f32's attention plan at (nW, heads, n) on `sms` SMs, its shared
    memory held to the kernel's own."""
    from lavt_rs_tpu_torch.ops import cuda_lib, fused_msa

    p = fused_msa.k2p_f32_plan(nw, heads, n, sms)
    smem = cuda_lib.lib().lavt_k2p_attn_f32_smem()
    if smem != p["smem"]:
        raise RuntimeError(f"K2p f32 attention: the kernel's shared memory "
                           f"{smem} B, its plan's {p['smem']}")
    log(f"K2p f32 attention plan ({nw}, {heads}, {n}) on {sms} SMs: "
        f"{p['blocks']} persistent blocks over {p['items']} (window, head, "
        f"sweep) items, {p['per_block']} a block at most; {p['tiles']} query "
        f"tiles of 64 in {p['sweeps']} sweeps ({p['tiles_per_warpgroup']} a "
        f"consumer warpgroup a sweep), {p['chunks']} key chunks of 56 a "
        f"sweep through {p['stages']} ring slots; {p['smem']} B (the "
        f"kernel's own)")


def k2p_f32_launch_lines(label, args, lo):
    """K2p f32's launches one by one (`fused_msa.grouped_launches` on f32),
    each by device ms a call (its launches queued behind a device sleep,
    `queued_ms`) beside its bound at the f32 peak: qkv with wqkv's lo, the
    attention (`grouped_attn_f32`), the out-projection with wproj's lo,
    and the lo split of both weights that the model runs once a weight
    version (`WeightLo.weight_lo`)."""
    from lavt_rs_tpu_torch.ops import fused_msa

    x, wqkv, bqkv, wproj, bproj, bias, mask, nu, heads, sc = args
    b, nw, n, c = x.shape
    rows = b * nw * n
    x2 = x.reshape(rows, c)
    qkv = fused_msa.gemm_bias(x2, wqkv, bqkv, c, sc, wlo=lo[0])
    qv = qkv.view(b, nw, n, 3 * c)
    o = fused_msa.grouped_attn_f32(qv, bias, mask, nu, heads).view(rows, c)
    masked = 0 if mask is None else mask.shape[0] * b
    work = {"qkv": (6 * rows * c * c, 4 * (4 * rows * c + 6 * c * c + 3 * c)),
            "attention": attn_work(b, nw, heads, n, masked, 4),
            "out-projection": (2 * rows * c * c,
                               4 * (2 * rows * c + 2 * c * c + c)),
            "lo split": (0, 2 * 4 * 4 * c * c)}
    parts = {"qkv": lambda: fused_msa.gemm_bias(x2, wqkv, bqkv, c, sc,
                                                wlo=lo[0]),
             "attention": lambda: fused_msa.grouped_attn_f32(
                 qv, bias, mask, nu, heads),
             "out-projection": lambda: fused_msa.gemm_bias(o, wproj, bproj,
                                                           wlo=lo[1]),
             "lo split": lambda: (fused_msa.tf32_lo(wqkv),
                                  fused_msa.tf32_lo(wproj))}
    log(f"{label}: device ms a call by launch (launches queued), bound at "
        f"the f32 peak: " + "; ".join(
            f"{k} {queued_ms(fn):.4f} (bound "
            f"{bound_ms(work[k], PEAK_FLOPS_F32)[0]:.4f} "
            f"{bound_ms(work[k], PEAK_FLOPS_F32)[1]})"
            for k, fn in parts.items()))
    del qkv, o


def around_k11_f32(dev, card, k11_ms):
    """The work around K11 f32 in a window-12 bs-8 f32 forward, recorded
    for a later change to judge: at each padded block's shapes (stage 3's
    18 blocks on 30², stage 4's 2 on 15², half of them shifted by 6) the
    plain pre-attention LN (`fused_msa.layer_norm_f32`), the pad to a
    multiple of 12, the roll before and after K11 and the crop back (its
    copy in the reshape), as `SwinBlock.forward` runs them
    (models/swin2d.py), by device ms a forward under torch.profiler
    (`record_function` labels), beside K11 f32's `k11_ms` a forward."""
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile, record_function

    from lavt_rs_tpu_torch.ops import fused_msa

    g = torch.Generator(device=dev).manual_seed(SEED + 45)
    blocks = []
    for side, c, _, depth in STAGES[2:]:
        pad = (12 - side % 12) % 12
        x = torch.randn((BATCH, side * side, c), generator=g, device=dev)
        lnp = (torch.randn((c,), generator=g, device=dev) * 0.2 + 1.0,
               torch.randn((c,), generator=g, device=dev) * 0.2)
        y = torch.randn((BATCH, side + pad, side + pad, c), generator=g,
                        device=dev)
        blocks += [(x, lnp, y, side, pad, shift)
                   for shift in (0, 6) for _ in range(depth // 2)]

    def forward():
        for x, lnp, y, side, pad, ss in blocks:
            b, _, c = x.shape
            with record_function("around K11: pre-attention LN"):
                t = fused_msa.layer_norm_f32(x, *lnp).view(b, side, side, c)
            with record_function("around K11: pad"):
                t = F.pad(t, (0, 0, 0, pad, 0, pad))
            if ss:
                with record_function("around K11: roll before"):
                    t = torch.roll(t, shifts=(-ss, -ss), dims=(1, 2))
                with record_function("around K11: roll after"):
                    t = torch.roll(y, shifts=(ss, ss), dims=(1, 2))
            else:
                t = y
            with record_function("around K11: crop"):
                t = t[:, :side, :side, :].reshape(b, side * side, c)

    forward()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        forward()
        torch.cuda.synchronize()
    parts = {}
    for e in prof.key_averages():
        if e.key.startswith("around K11: "):
            us = getattr(e, "device_time_total",
                         getattr(e, "cuda_time_total", 0))
            parts[e.key[len("around K11: "):]] = us / 1e3
    total = sum(parts.values())
    log("f32 window-12 bs-8 forward around K11 f32 (20 padded blocks, "
        "torch.profiler, device ms a forward): " + "; ".join(
            f"{k} {v:.4f}" for k, v in parts.items())
        + f"; total {total:.4f} beside K11 f32's {k11_ms:.4f}  [{card}]")


def mlp_f32_launch_work(m, c):
    """(operations, bytes) of K3 / K8 f32's launches at (M, C), hidden 4C,
    in f32: the prep (x, gamma, beta read, LN(x) written; W1 and W2 read,
    their lo parts written), fc1 + GELU (LN(x), W1 and its lo read, h
    written), fc2 + residual (h, W2 and its lo, x read, out written)."""
    hd = 4 * c
    act, hid, w = 4 * m * c, 4 * m * hd, 4 * hd * c
    return {"prep": (8 * m * c, 2 * act + 8 * c + 4 * w),
            "fc1+GELU": (2 * m * c * hd, act + 2 * w + 4 * hd + hid),
            "fc2+residual": (2 * m * hd * c, hid + 2 * w + 2 * act + 4 * c)}


def short_kernel(name):
    """A kernel's name without its namespace, parameters and template
    arguments' noise (the GEMM core's epilogue kept)."""
    base = name.split("(")[0].replace("void ", "")
    if "gemm_tf32_kernel<" in base:  # epilogue, A and B layouts
        args = base.split("gemm_tf32_kernel<", 1)[1].rsplit(">", 1)[0]
        epi, ta, tb, _ = (a.strip() for a in args.rsplit(",", 3))
        lay = "".join("M" if f == "true" else "K" for f in (ta, tb))
        return f"tf32<{epi.split('::')[-1]},{lay}>"
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


def ffma_design(key):
    """`key`'s times on its earlier designs, for a summary line (or "")."""
    out = (f"; on the FFMA design {FFMA_DESIGN_MS[key]} (PERF.md)"
           if key in FFMA_DESIGN_MS else "")
    if key in MMA_SYNC_CORE_MS:
        out += (f"; on the mma.sync GEMM and FFMA MSA attention "
                f"{MMA_SYNC_CORE_MS[key]} (PERF.md)")
    return out


def log_device_by_kernel(what, fn, iters=10):
    """fn's device ms by kernel over one torch.profiler session of `iters`
    calls after a warm-up: each kernel's ms a launch and the launches a
    call the session recorded (a session can drop some: a fraction below
    the call's count shows it, and ms a launch stay right), and the call's
    total (ms a launch times the launches a call, rounded, at least 1)."""
    import torch

    fn()
    torch.cuda.synchronize()
    session = _device_session(fn, iters)
    rows = sorted(((short_kernel(k), us / 1e3 / n, n / iters)
                   for k, (us, n) in session.items() if n),
                  key=lambda r: -r[1] * r[2])
    parts = ", ".join(f"{name} {ms:.4f} x {per:g}" for name, ms, per in rows)
    total = sum(ms * max(1, round(per)) for _, ms, per in rows)
    log(f"{what}: device ms a launch by kernel x the launches a call "
        f"recorded (torch.profiler): {parts}; total {total:.4f} a call")


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
        for k in (NAMES + ("save", "K2s", "K10s") + F32_NAMES + F32_TRAIN_NAMES
                  + F32_W12_TRAIN_NAMES):
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
            "K4.f32": ln.layer_norm_rows_f32,
            "K10.f32": window_attn.window_attention_f32,
            "K2p.f32": fused_msa.fused_window_msa_grouped_f32,
            "K9.f32": window_attn.attention_core_bwd_f32,
            "K8.f32": fused_mlp.fused_ln_mlp_droppath_f32,
            "K7.f32": fused_mlp.fused_ln_mlp_bwd_f32,
            "K4b.f32": ln.layer_norm_rows_bwd_f32,
            "K2.f32": fused_msa.fused_window_msa_f32,
            "save.f32": fused_msa.fused_window_msa_save_f32,
            "K5.f32": fused_msa.fused_window_msa_bwd_f32,
            "K6.f32": fused_msa.fused_window_msa_bwd_recompute_f32}


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
        # the weights' lo parts, as the model keeps them
        lo = (fused_msa.tf32_lo(w[0]), fused_msa.tf32_lo(w[2]))
        for shift in (False, True):
            mask = shift_mask_2d(side, side, 12, 6, dev) if shift else None
            flags = (shift_mask_flags_2d(side, side, 12, 6, dev) if shift
                     else None)
            tail = (*w, bias, mask, heads, sc)
            what = f"x{tuple(x.shape)} heads {heads} mask {shift}"
            lib, _ = msa_fwd_yardstick(f"K1.f32 {what}", x, tail, lnp)

            def k1(tail=tail, flags=flags):
                return fused_msa.fused_window_msa_ln_f32(x, *lnp, *tail,
                                                         flags=flags, wlo=lo)

            measure(res, "K1.f32", what, blocks // 2, k1,
                    lambda: fused_msa.fused_window_msa_ln_plain(x, *lnp,
                                                                *tail),
                    lib, msa_work(BATCH, nw, c, heads, "fwd", ln=True,
                                  mask=shift, item=4), check,
                    peak=PEAK_FLOPS_F32)
            device_per_call(res, "K1.f32", what, blocks // 2, k1)
            msa_f32_launch_lines(f"K1.f32 launches {what}", x, lnp, w, bias,
                                 mask, flags, heads, sc, lo)
        del x
    for b, hp, wp, c, heads, shift, calls in K11_CASES[:5]:
        nw = (hp // 12) * (wp // 12)
        x = rnd((b, hp, wp, c))
        w, bias = msa_weights(c, heads)
        lo = (fused_msa.tf32_lo(w[0]), fused_msa.tf32_lo(w[2]))
        mask = shift_mask_2d(hp, wp, 12, 6, dev) if shift else None
        flags = shift_mask_flags_2d(hp, wp, 12, 6, dev) if shift else None
        args = (x, *w, bias, mask, heads, sc, 12)
        am = sdpa_mask(bias, mask, nw, dtype=torch.float32)
        what = (f"x{tuple(x.shape)} heads {heads} mask {shift}"
                + ("" if calls else " (off the path)"))

        def k11(args=args, flags=flags, lo=lo):
            return fused_msa_2d.fused_window_msa_2d_f32(*args, flags, wlo=lo)

        measure(res, "K11.f32", what, calls, k11,
                lambda: fused_msa_2d.fused_window_msa_2d_plain(*args),
                lambda: torch_bf16_msa_2d(x, *w, am, heads, sc),
                msa_work(b, nw, c, heads, "fwd", mask=shift, item=4), check,
                peak=PEAK_FLOPS_F32)
        device_per_call(res, "K11.f32", what, calls, k11)
        msa_f32_launch_lines(f"K11.f32 launches {what}", x, None, w, bias,
                             mask, flags, heads, sc, lo)
        del x, am, args
        torch.cuda.empty_cache()


def swin_blocks_port_only(dev, model, plain_linears=False):
    """The first two Swin blocks (unshifted, shifted) of every stage of an
    f32 lavt_one `model` on bs-8 f32 tokens under torch.profiler: none may
    launch a library GEMM, convolution or attention kernel
    (LIBRARY_KERNEL_TAGS; with `plain_linears`, at window 7, the library
    GEMMs of the blocks' qkv and proj Linears, plain there as the JAX
    package leaves them to XLA, are allowed and listed); prints the port's
    kernels and the others (PyTorch's copies and elementwise kernels: pad,
    roll, add)."""
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
    gemm_tags = ("gemm", "gemv", "cublas", "cutlass", "xmma", "nvjet")
    tags = tuple(t for t in LIBRARY_KERNEL_TAGS
                 if not (plain_linears and t in gemm_tags))
    library = sorted(n for n in names if "lavt::" not in n and any(
        t in n.lower() for t in tags))
    if library:
        raise RuntimeError(f"f32 Swin blocks launched library kernels: "
                           f"{library}")
    port = sorted({short_kernel(n) for n in names if "lavt::" in n})
    other = sorted({short_kernel(n) for n in names if "lavt::" not in n})
    log(f"f32 Swin blocks (2 a stage, bs {BATCH}) under torch.profiler: "
        f"{len(names)} kernels, no library "
        f"{'convolution or attention (the qkv and proj Linears plain)' if plain_linears else 'GEMM, convolution or attention'}"
        f"; the port's: {', '.join(port)}; PyTorch's: {', '.join(other)}")


def f32_gate(label, got, want):
    """The f32 gate: finite logits within F32_GATE of the plain f32
    model's `want`, and the same argmax wherever the plain margin exceeds
    F32_GATE; logs the figures."""
    import torch

    if not bool(torch.isfinite(got).all()):
        raise RuntimeError(f"{label}: non-finite logits")
    diff = (got - want).abs().max().item()
    sure = (want[..., 1] - want[..., 0]).abs() > F32_GATE
    flips = int((got.argmax(-1) != want.argmax(-1))[sure].sum().item())
    log(f"{label}, kernels vs the plain f32 model: max |dlogit| {diff:.4g} "
        f"(limit {F32_GATE}), logit scale {want.abs().max().item():.4g}; "
        f"argmax differs on {flips} of the {int(sure.sum().item())} pixels "
        f"whose plain margin exceeds {F32_GATE} "
        f"({sure.float().mean().item():.4f} of all)")
    if not diff <= F32_GATE or flips:
        raise RuntimeError(f"{label}: f32 gate failed")


def f32_inference(dev, card, weights, cfg=None, per_forward=None,
                  what="window-12"):
    """lavt_one Swin-B f32 with the kernels (window 12 unless `cfg` says
    otherwise), on `weights`: N_REQUESTS batches of 8 through `fwd_iou`
    (the f32 counters equal the model's `kernel_plan` at itemsize 4, which
    must be the bf16 plan `per_forward`, every bf16 counter 0), the gate
    against the plain f32 model on the same weights (`f32_gate`), ms a
    batch and img/s beside the plain model's, peak memory, one forward
    under torch.profiler and the Swin blocks under it
    (`swin_blocks_port_only`).  Returns the launch counts."""
    import torch

    from lavt_rs_tpu_torch.config import lavt_one_base
    from lavt_rs_tpu_torch.eval.refcoco_eval import fwd_iou
    from lavt_rs_tpu_torch.models.factory import build_model
    from lavt_rs_tpu_torch.ops.norm import maybe_normalize_image

    cfg = lavt_one_base(dtype="float32") if cfg is None else cfg
    per_forward = INFER_PER_FORWARD if per_forward is None else per_forward
    plan = kernel_plan(cfg, 480, BATCH)[0]
    if plan != per_forward:
        raise RuntimeError(f"f32 {what} forward: the kernel plan at itemsize "
                           f"4 is {plan}, not the bf16 plan {per_forward}")
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
    log(f"f32 {what} inference launches over {N_REQUESTS} batches of "
        f"{BATCH}: {nonzero_counts(launches)} (the plan at itemsize 4: "
        f"{plan} a forward)")
    check_counts(f"f32 {what} inference", launches, per, N_REQUESTS)
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
    if tuple(logits.shape) != (BATCH, 480, 480, 2):
        raise RuntimeError(f"f32 logits: shape {tuple(logits.shape)}")
    f32_gate(f"f32 {what} gate", logits, want)
    del logits, want
    iters, plain_iters = 10, 3
    ms = cuda_time_ms(lambda: forward(model), iters=iters, warmup=2)
    plain_ms = cuda_time_ms(lambda: forward(ref), iters=plain_iters,
                            warmup=1)
    del ref
    torch.cuda.empty_cache()
    log(f"f32 {what} forward bs {BATCH} with the kernels: {ms:.3f} ms a batch, "
        f"{BATCH * 1000 / ms:.2f} img/s (mean of {iters}); the plain f32 "
        f"model (TF32 off): {plain_ms:.3f} ms, "
        f"{BATCH * 1000 / plain_ms:.2f} img/s (mean of {plain_iters}); peak "
        f"{peak:.3f} GiB over the fwd_iou batches  [{card}]")
    profile_clip(lambda: forward(model), card, f"f32 {what} bs-8 forward")
    swin_blocks_port_only(dev, model, plain_linears=cfg.swin.window_size != 12)
    del model
    torch.cuda.empty_cache()
    return launches


def f32_cli(dev, card, root, vocab, ckpt, batches, sentences, window12=True):
    """`cli.test.main --window12 --no_bf16` (without --window12: window 7,
    the CLI's default, on a window-7 .pth) in process on the synthetic
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

    argv = ["--window12"] if window12 else []
    argv += ["--no_bf16", "--img_size", "480",
             "--refer_data_root", root, "--dataset", "refcoco", "--splitBy",
             "unc", "--split", "val", "--vocab", vocab, "--checkpoint", ckpt,
             "--device", str(dev)]
    window = "window 12" if window12 else "window 7"
    evaluate, seconds = refcoco_eval.evaluate, []

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = evaluate(*a, **kw)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        return out

    per = {f"{k}.f32": n for k, n in (
        INFER_PER_FORWARD if window12 else W7_INFER_PER_FORWARD).items()}
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
                log(f"cli --no_bf16 {window} ({label}): {line}")
            check_counts(f"f32 eval {window} ({label})", launches, want,
                         batches)
            log(f"f32 eval {window} via the CLI ({label}): launches over "
                f"{batches} "
                f"batches {nonzero_counts(launches)}; {seconds[-1]:.3f} s, "
                f"{sentences / seconds[-1]:.2f} sentences/s, "
                f"{1e3 * seconds[-1] / batches:.3f} ms per device batch  "
                f"[{card}]")
    finally:
        refcoco_eval.evaluate = evaluate
    check_summaries(f"f32 eval {window}", summaries["kernels"],
                    summaries["--no_pallas"])


def check_summaries(what, got, plain):
    """Two eval summaries (the kernels', --no_pallas's) logged with their
    differences; mIoU and oIoU within F32_CLI_TOL."""
    log(f"{what} summary, kernels:     {got}")
    log(f"{what} summary, --no_pallas: {plain}")
    log(f"{what} summary differences (kernels - plain): "
        + ", ".join(f"{k} {got[k] - plain[k]:+.5f}" for k in got))
    for k in ("mIoU", "oIoU"):
        if not abs(got[k] - plain[k]) <= F32_CLI_TOL:
            raise RuntimeError(f"{what}: {k} {got[k]} against --no_pallas "
                               f"{plain[k]} (limit {F32_CLI_TOL})")


def f32_phase(dev, card, res, weights, root, vocab, ckpt, batches,
              sentences):
    """Phase 3c: the f32 variants' kernel checks (`f32_kernel_phase`), the
    f32 forward (`f32_inference`) and the test CLI with --no_bf16
    (`f32_cli`); then phase 3d: K10 f32, its save mode, K9 f32 and K2p f32
    (`f32_attn_kernel_phase`), window 7's f32 forward and `cli.test
    --no_bf16` at window 7 on seeded window-7 weights saved beside `ckpt`.
    Returns the window-12 and the window-7 forwards' launch counts."""
    import torch

    t0 = time.perf_counter()
    log(f"f32 phase: torch.backends.cuda.matmul.allow_tf32 = "
        f"{torch.backends.cuda.matmul.allow_tf32}, "
        f"torch.backends.cudnn.allow_tf32 = "
        f"{torch.backends.cudnn.allow_tf32} (the plain versions, the library "
        f"chains and the plain f32 model multiply in full f32)")
    f32_kernel_phase(dev, res)
    for k in F32_NAMES[:4]:
        r = res.r[k]
        log(f"{k} per forward: kernel {r['ms']:.3f} ms (on the device, "
            f"launches queued: {r['device']:.3f} ms), bound {r['bound']:.3f} "
            f"ms ({res.bound_by(k)}), plain (f32) {r['plain']:.3f} ms, "
            f"library chain (f32, TF32 off) {r['lib']:.3f} ms")
    around_k11_f32(dev, card, res.r["K11.f32"]["device"])
    launches = f32_inference(dev, card, weights)
    f32_cli(dev, card, root, vocab, ckpt, batches, sentences)
    log(f"f32 phase (window 12): {time.perf_counter() - t0:.1f} s")

    from lavt_rs_tpu_torch.config import lavt_one_base
    from lavt_rs_tpu_torch.models.factory import build_model

    t0 = time.perf_counter()
    f32_attn_kernel_phase(dev, res)
    for k, per in (("K10.f32/w7", "window-7 bs-8 forward"),
                   ("K10.f32", "clip"), ("K2p.f32", "clip"),
                   ("K10s.f32", "video train step"),
                   ("K9.f32", "video train step")):
        r = res.r[k]
        log(f"{k} per {per}: kernel {r['ms']:.3f} ms, bound "
            f"{r['bound']:.3f} ms ({res.bound_by(k)}), plain (f32) "
            f"{r['plain']:.3f} ms, library (f32, TF32 off) {r['lib']:.3f} "
            f"ms{ffma_design(k)}")
    g = torch.Generator(device=dev).manual_seed(SEED + 51)
    w7 = meaningful(build_model(lavt_one_base(window12=False), dev,
                                generator=g), dev, g).state_dict()
    w7_launches = f32_inference(
        dev, card, w7, lavt_one_base(window12=False, dtype="float32"),
        W7_INFER_PER_FORWARD, "window-7")
    ckpt7 = os.path.join(root, "lavt_one_base_window7.pth")
    torch.save({"model": w7}, ckpt7)
    del w7
    f32_cli(dev, card, root, vocab, ckpt7, batches, sentences,
            window12=False)
    log(f"f32 phase (window 7, K10 f32, K9 f32, K2p f32): "
        f"{time.perf_counter() - t0:.1f} s")
    return launches, w7_launches


def f32_attn_kernel_phase(dev, res):
    """K10 f32, K10 f32's save mode, K9 f32 and K2p f32 on seeded f32
    inputs at their path shapes against their f32 plain versions within
    F32_TOL abs + rel, timed beside their bound (PEAK_FLOPS_F32), their
    plain versions and their f32 library calls (TF32 off: one SDPA over
    B nW windows for K10, autograd through it for K9; linear / SDPA /
    linear for K2p):
      * K10 f32 at the four window-7 shapes of a bs-8 forward, on the qkv
        Linear's output as the forward runs it (and on contiguous copies):
        per forward into "K10.f32/w7";
      * K10 f32 at video stages 2-4 of an 8-frame 480² clip (N = 392, on
        the qkv Linear's output) and K2p f32 at stage 1 (n_p = 392, no
        padding in f32; grouped by mask, unshifted and shifted): per clip
        into "K10.f32" and "K2p.f32";
      * K10 f32's save mode (O and lse) and K9 f32 (dq, dk, dv, dbias; the
        masks' window flags; two calls give the same bits) at all four
        video stages: per training step into "K10s.f32" and "K9.f32".
    K10 f32's and K9 f32's launch plans are printed at every shape."""
    import torch
    import torch.nn.functional as F

    from lavt_rs_tpu_torch.ops import fused_msa
    from lavt_rs_tpu_torch.ops import window_attn as wa
    from lavt_rs_tpu_torch.ops.window import (partition_3d_groups,
                                              relative_bias_from_table,
                                              relative_bias_from_table_3d,
                                              relative_position_index_2d,
                                              relative_position_index_3d,
                                              shift_mask_2d, shift_mask_3d)

    g = torch.Generator(device=dev).manual_seed(SEED + 50)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    f32 = torch.float32

    def rnd(shape, std=1.0):
        return torch.randn(shape, generator=g, device=dev) * std

    def check(name, got, want):
        return compare(name, got, want, F32_TOL)

    def check_all(name, got, want):
        return max(check(name, a, b) for a, b in zip(got, want))

    def plans(what, b, nw, heads, n):
        from lavt_rs_tpu_torch.ops import cuda_lib

        p10 = wa.k10_f32_plan(b * nw, heads, n, sms)
        p9 = wa.k9_f32_plan(b * nw, heads, n, sms)
        smem = cuda_lib.lib().lavt_k10_f32_smem(n)
        if smem != p10["smem"]:
            raise RuntimeError(f"K10 f32 at N = {n}: the kernel's shared "
                               f"memory {smem} B, its plan's {p10['smem']}")
        log(f"K10 f32 / K9 f32 plans {what} ({b}, {nw}, {heads}, {n}) on "
            f"{sms} SMs: K10 f32 {p10['blocks']} blocks of {p10['threads']} "
            f"threads, {p10['per_block']} of its {p10['items']} items "
            f"({p10['rows']} query rows, {p10['chunks']} key chunks of 56) "
            f"a block"
            + (f", its head's bias staged {p10['bias_loads']} times at most"
               if "bias_loads" in p10 else "")
            + f", {p10['smem']} B (the kernel's own); K9 f32 launch 1 "
            f"{p9['q_blocks']} blocks ({p9['bp']} window strides, "
            f"{p9['parts']} dbias partials), launch 2 {p9['kv_blocks']} "
            f"blocks")

    sc = 32 ** -0.5
    index = torch.from_numpy(relative_position_index_2d(7, 7)).to(dev)
    for si, (side, c, heads, depth) in enumerate(W7_STAGES):
        nw = (side // 7) ** 2
        plans(f"window 7 stage {si + 1}", BATCH, nw, heads, 49)
        qkv = rnd((BATCH, nw, 49, 3 * heads * 32))
        q, k, v = (t.contiguous() for t in wa.qkv_heads(qkv, heads))
        bias = relative_bias_from_table(rnd((13 * 13, heads)), index)
        for shift in (False, True):
            mask = shift_mask_2d(side, side, 7, 3, dev) if shift else None
            am = sdpa_mask(bias, mask, nw, BATCH, f32)
            what = f"window 7 stage {si + 1} qkv{tuple(qkv.shape)} mask {shift}"
            measure(res, "K10.f32/w7", what, depth // 2,
                    lambda m=mask: wa.window_attention_qkv(qkv, bias, m,
                                                           heads, sc),
                    lambda m=mask: wa.window_attention_qkv_plain(
                        qkv, bias, m, heads, sc),
                    lambda am=am: sdpa_windows(q, k, v, am, sc),
                    attn_work(BATCH, nw, heads, 49, masked_windows(mask), 4),
                    check, peak=PEAK_FLOPS_F32)
            del am
            err = check("K10.f32/w7",
                        wa.window_attention(q, k, v, bias, mask, sc),
                        wa.window_attention_plain(q, k, v, bias, mask, sc))
            res.r["K10.f32/w7"]["err"] = max(res.r["K10.f32/w7"]["err"], err)
            log(f"K10.f32/w7 {what}, on contiguous q, k, v: max abs err "
                f"{err:.3g}")
            if shift:  # grouped by mask as K2p f32 launches it: the first
                # half of each image's windows maskless, the rest masked
                nu = nw // 2
                small = mask[nu:].clone()  # its own, 16-byte-aligned copy
                err = check("K10.f32/w7", wa.attention_qkv_grouped(
                    qkv, bias, small, nu, heads, sc),
                    wa.window_attention_qkv_plain(
                        qkv, bias, torch.cat([small.new_zeros((nu, 49, 49)),
                                              small]), heads, sc))
                res.r["K10.f32/w7"]["err"] = max(res.r["K10.f32/w7"]["err"],
                                                 err)
                log(f"K10.f32/w7 {what}, grouped (nu {nu}): max abs err "
                    f"{err:.3g}")
        del qkv, q, k, v
        torch.cuda.empty_cache()
    index = torch.from_numpy(relative_position_index_3d(8, 7, 7)).to(dev)
    for si, (side, c, heads, depth) in enumerate(VIDEO_STAGES):
        hp = -(-side // 7) * 7
        nw = (hp // 7) ** 2
        n = 392
        bias = relative_bias_from_table_3d(rnd((15 * 13 * 13, heads)), index,
                                           n)
        shift_mask = shift_mask_3d(FRAMES, hp, hp, (8, 7, 7), (0, 3, 3), dev)
        plans(f"video stage {si + 1}", 1, nw, heads, n)
        if si == 0:  # K2p f32: 392 tokens, no padding in f32
            w = (rnd((3 * c, c), c ** -0.5), rnd((3 * c,), 0.2),
                 rnd((c, c), c ** -0.5), rnd((c,), 0.2))
            lo = (fused_msa.tf32_lo(w[0]), fused_msa.tf32_lo(w[2]))
            k2p_f32_plan_line(nw, heads, n, sms)
            xw = rnd((1, nw, n, c))
            for ss in ((0, 0, 0), (0, 3, 3)):
                nu, mask = partition_3d_groups(FRAMES, side, side, FRAMES, hp,
                                               hp, (8, 7, 7), ss, n, dev)
                args = (xw, *w, bias, mask, nu, heads, sc)
                full = None if mask is None else torch.cat(
                    [mask.new_zeros((nu, n, n)), mask])
                am = sdpa_mask(bias, full, nw, dtype=f32)

                def chain(am=am):
                    qkv = F.linear(xw, w[0], w[1]).view(nw, n, 3, heads, 32)
                    q_, k_, v_ = qkv.permute(2, 0, 3, 1, 4)
                    o = F.scaled_dot_product_attention(q_, k_, v_,
                                                       attn_mask=am, scale=sc)
                    return F.linear(o.transpose(1, 2).reshape(1, nw, n, c),
                                    w[2], w[3])

                what = f"stage 1 x{tuple(xw.shape)} heads {heads} nu {nu}"
                measure(res, "K2p.f32", what, 1,
                        lambda a=args: fused_msa.fused_window_msa_grouped(
                            *a, wlo=lo),
                        lambda a=args: fused_msa.fused_window_msa_grouped_plain(
                            *a), chain,
                        padded_msa_work(1, nw, n, c, heads,
                                        masked_windows(mask), 4),
                        check, peak=PEAK_FLOPS_F32)
                check_deterministic(f"K2p f32 {what}", lambda a=args: (
                    fused_msa.fused_window_msa_grouped(*a, wlo=lo),))
                k2p_f32_launch_lines(f"K2p f32 launches {what}", args, lo)
                del am, full
            del xw
        else:  # K10 f32 on the stage's qkv Linear output
            qkv = rnd((1, nw, n, 3 * c))
            q, k, v = (t.contiguous() for t in wa.qkv_heads(qkv, heads))
            for mask in (None, shift_mask):
                am = sdpa_mask(bias, mask, nw, dtype=f32)
                measure(res, "K10.f32", f"video stage {si + 1} "
                        f"qkv{tuple(qkv.shape)} mask {mask is not None}",
                        depth // 2,
                        lambda m=mask: wa.window_attention_qkv(qkv, bias, m,
                                                               heads, sc),
                        lambda m=mask: wa.window_attention_qkv_plain(
                            qkv, bias, m, heads, sc),
                        lambda am=am: sdpa_windows(q, k, v, am, sc),
                        attn_work(1, nw, heads, n, masked_windows(mask), 4),
                        check, peak=PEAK_FLOPS_F32)
                del am
            del qkv, q, k, v
        # training: every stage on K10 f32's save mode and K9 f32
        q, k, v, do = (rnd((1, nw, heads, n, 32)) for _ in range(4))
        for mask in (None, shift_mask):
            masked = masked_windows(mask)
            am = sdpa_mask(bias, mask, nw, dtype=f32)
            what = (f"video stage {si + 1} q{tuple(q.shape)} mask "
                    f"{mask is not None}")
            measure(res, "K10s.f32", what, depth // 2,
                    lambda m=mask: wa.window_attention_save(q, k, v, bias, m,
                                                            sc),
                    lambda m=mask: wa.window_attention_save_plain(
                        q, k, v, bias, m, sc),
                    lambda am=am: F.scaled_dot_product_attention(
                        q[0], k[0], v[0], attn_mask=am, scale=sc),
                    attn_save_work(1, nw, heads, n, masked, 4), check_all,
                    peak=PEAK_FLOPS_F32)
            del am
            o, lse = wa.window_attention_save(q, k, v, bias, mask, sc)

            def sdpa_chain(q_, k_, v_, b_, mask=mask, nw=nw):
                return F.scaled_dot_product_attention(
                    q_[0], k_[0], v_[0],
                    attn_mask=sdpa_mask(b_, mask, nw, dtype=f32), scale=sc)

            def k9(mask=mask, o=o, lse=lse, flags=wa.mask_flags(mask)):
                return wa.attention_core_bwd(q, k, v, bias, mask, do, sc, o,
                                             lse, flags)

            measure(res, "K9.f32", what, depth // 2, k9,
                    lambda m=mask, o=o: wa.attention_core_bwd_plain(
                        q, k, v, bias, m, do, sc, o),
                    chain_grad(sdpa_chain, (q, k, v, bias), do[0]),
                    attn_bwd_work(1, nw, heads, n, masked, 4), check_all,
                    peak=PEAK_FLOPS_F32)
            check_deterministic(f"K9 f32 {what}", k9)
            log_device_by_kernel(f"K9.f32 {what}", k9)
            del o, lse
        del q, k, v, do, shift_mask
        torch.cuda.empty_cache()


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


def training(dev, card, weights, cfg=None, per_step=None, what="train",
             profile=False):
    """Steps at batch 8 (timed, counted as `per_step`, by default the
    window-12 counts; loss falls; with `profile`, one more under
    torch.profiler) and, for the window-12 model, one at batch 16; returns
    the launches at batch 8 and at batch 16 (None), and the ms per step at
    batch 8."""
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
    dtype = "bfloat16" if cfg is None else cfg.dtype
    log(f"{what} bs {BATCH} {dtype} (kernels, AdamW, DropPath 0.3, dropout 0.1): "
        f"{ms:.3f} ms/step, {BATCH * 1000 / ms:.2f} img/s (mean of "
        f"{TRAIN_STEPS} steps); peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB  [{card}]")
    log(f"loss over {TRAIN_STEPS} steps on one batch (dropout reseeded each "
        f"step): first {losses[0]:.6f}, last {losses[-1]:.6f}; all "
        f"{[round(v, 6) for v in losses]}; iou {outs[-1]['iou'].item():.4f}, "
        f"lr {outs[-1]['lr']:.6g}")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"{what}: the training loss did not fall")
    if profile:
        profile_clip(lambda: step(batch, gen()), card, f"{what} bs-{BATCH} step")
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
            if isinstance(mod, torch.nn.modules.batchnorm._BatchNorm):
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
        parts = name.removeprefix("model.").split(".")  # lavt: model.backbone
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


def attn_work(b, nw, heads, n, masked=0, item=2):
    """K10: q kᵀ and P v (4 N² hd flops per window and head); bytes: q, k,
    v and O in bf16 (f32 for K10 f32: item 4), the f32 bias and the f32
    mask of the `masked` windows whose mask is not all zero."""
    hd = 32
    m = b * nw * heads
    return (4 * m * n * n * hd,
            4 * m * n * hd * item + heads * n * n * 4 + masked * n * n * 4)


def attn_save_work(b, nw, heads, n, masked=0, item=2):
    """K10's save mode: K10's work plus each row's f32 lse written."""
    flops, nbytes = attn_work(b, nw, heads, n, masked, item)
    return flops, nbytes + b * nw * heads * n * 4


def attn_bwd_work(b, nw, heads, n, masked=0, item=2):
    """K9: five N x N x hd products (10 N² hd flops) per window and head;
    bytes: q, k, v, o, do read and dq, dk, dv written in bf16 (f32 for K9
    f32: item 4), the f32 lse read, the f32 bias read and dbias written,
    and the f32 mask of the `masked` windows whose mask is not all zero."""
    hd = 32
    m = b * nw * heads
    return (10 * m * n * n * hd,
            8 * m * n * hd * item + m * n * 4 + 2 * heads * n * n * 4
            + masked * n * n * 4)


def padded_msa_work(b, nw, n, c, heads, masked, item=2):
    """K2p at the real token count n (the function needs none of the
    padding): the qkv and out-projection GEMMs (8 rows C²) and 4 n² hd per
    window and head; bytes: x in, y out, the weights (bf16, or f32 for K2p
    f32: item 4), the bias and the mask of the `masked` windows."""
    rows = b * nw * n
    flops = 8 * rows * c * c + 4 * b * nw * heads * n * n * 32
    nbytes = ((2 * rows * c + 4 * c * c + 4 * c) * item
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


def timed_evaluate(evaluate, model, *a, **kw):
    """evaluate(model, ...) on synchronized host clocks: (its return value,
    (model, seconds, the launches it made))."""
    import torch

    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    out = evaluate(model, *a, **kw)
    torch.cuda.synchronize()
    return out, (model, time.perf_counter() - t0, read_counts())


def a2d_cli(dev, ckpt, examples, extra=(), label="a2d"):
    """`cli.test --dataset a2d` with the A2D recipe's flags (and `extra`)
    in process on the in-memory `examples` at A2D_CLIP frames, CLI_IMG²,
    --checkpoint ckpt: (its summary, (the CLI's model, its evaluate's
    seconds, the launches), the peak device memory in GiB); the CLI's
    stderr logged."""
    import torch

    from lavt_rs_tpu_torch.cli import test as cli_test
    from lavt_rs_tpu_torch.eval import video_eval

    dataset, evaluate = cli_test.a2d_dataset, video_eval.evaluate_a2d
    runs = []

    def counted(*a, **kw):
        out, run = timed_evaluate(evaluate, *a, **kw)
        runs.append(run)
        return out

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
                "--checkpoint", ckpt, *extra])
    finally:
        cli_test.a2d_dataset, video_eval.evaluate_a2d = dataset, evaluate
    peak = torch.cuda.max_memory_allocated() / 2**30
    for line in err.getvalue().splitlines():
        log(f"test cli ({label}): {line}")
    return summary, runs[0], peak


def a2d_phase(dev, card, ckpt):
    """`cli.test --dataset a2d` (lavt_video_tiny, bf16, the kernels) in
    process on A2D_CLIPS in-memory A2D_CLIP-frame 480² clips, with the
    video phase's weights as --checkpoint: launches per clip equal to
    `kernel_plan(cfg, CLI_IMG, A2D_CLIP)`, ms per clip (the CLI's cold run and
    a warm rerun of `evaluate_a2d`), clips/s, frames/s, peak memory, one
    clip's idle share (`torch.profiler`), and the annotated frame against
    the f32 plain model by the pixel gate."""
    from lavt_rs_tpu_torch.data.loader import to_device
    from lavt_rs_tpu_torch.eval import video_eval
    from lavt_rs_tpu_torch.models.factory import build_model

    examples = a2d_examples()
    summary, (model, cold, launches), peak = a2d_cli(dev, ckpt, examples)
    cfg = model.cfg
    plan = kernel_plan(cfg, CLI_IMG, A2D_CLIP)[0]
    log(f"A2D launches over {A2D_CLIPS} {A2D_CLIP}-frame clips: "
        f"{nonzero_counts(launches)}; kernel_plan(cfg, {CLI_IMG}, {A2D_CLIP}) per "
        f"clip: {plan}")
    check_counts("A2D eval", launches, plan, A2D_CLIPS)
    _, (_, warm, launches) = timed_evaluate(video_eval.evaluate_a2d, model,
                                            examples)
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


def a2d_f32_phase(dev, card, ckpt):
    """`cli.test --dataset a2d --no_bf16` (lavt_video_tiny in f32: K2p f32
    at stage 1, K10 f32 in the other blocks) in process on F32_A2D_CLIPS of
    the in-memory A2D_CLIP-frame clips with the video phase's weights, and
    with --no_pallas (the plain f32 route): launches per clip equal to the
    plan at itemsize 4 (none on the plain route), both summaries within
    F32_CLI_TOL on mIoU and oIoU, ms per clip of each run, and the first
    clip's annotated frame against the plain route's by the pixel gate and
    the f32 gate."""
    from lavt_rs_tpu_torch.data.loader import to_device
    from lavt_rs_tpu_torch.eval import video_eval

    examples = a2d_examples()[:F32_A2D_CLIPS]
    n = len(examples)
    runs = {}
    for label, extra in (("kernels", ["--no_bf16"]),
                         ("--no_pallas", ["--no_bf16", "--no_pallas"])):
        summary, (model, seconds, launches), peak = a2d_cli(
            dev, ckpt, examples, extra, f"a2d --no_bf16, {label}")
        want = {}
        if label == "kernels":
            want = {f"{k}.f32": v for k, v in
                    kernel_plan(model.cfg, CLI_IMG, A2D_CLIP)[0].items()}
        check_counts(f"f32 A2D eval ({label})", launches, want, n)
        log(f"f32 A2D via cli.test --dataset a2d --no_bf16 ({label}, {n} "
            f"{A2D_CLIP}-frame {CLI_IMG}² clips): launches "
            f"{nonzero_counts(launches)}; {1e3 * seconds / n:.1f} ms/clip, "
            f"{A2D_CLIP * n / seconds:.1f} frames/s (host clock, the CLI's "
            f"run); peak device memory {peak:.2f} GiB  [{card}]")
        runs[label] = (summary, model)
    check_summaries("f32 A2D eval", runs["kernels"][0],
                    runs["--no_pallas"][0])
    ex = examples[0]
    clip = [to_device(a, dev) for a in (ex.video, ex.ids, ex.mask)]
    v = ex.valid_index
    got, want = (video_eval.clip_logits(runs[k][1], *clip)[v:v + 1]
                 for k in ("kernels", "--no_pallas"))
    del runs
    agree = gate_pixels(f"f32 A2D {A2D_CLIP}-frame clip", got, want,
                        (1, CLI_IMG, CLI_IMG, 2))
    f32_gate(f"f32 A2D {A2D_CLIP}-frame clip, annotated frame {v} (argmax "
             f"agreement {agree:.5f} where the margin exceeds {MARGIN})",
             got, want)
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


def ytvos_phase(dev, card, ckpt, f32=False):
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
    chunked run's agreement with the unchunked one (not gated).  With f32:
    the unchunked run with --no_bf16 (K2p f32, K10 f32) and the plain f32
    route only, every forward held to the plain route's by the pixel gate
    and the f32 gate."""
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
            suffix = ".f32" if "--no_bf16" in extra else ""
            if plain[0] not in extra:
                for t in lengths:
                    for k, n in kernel_plan(cfg, CLI_IMG, t)[0].items():
                        want[k + suffix] = want.get(k + suffix, 0) + n
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

        if f32:
            _, got, lengths = run(["--no_bf16"], "f32 unchunked")
            _, want, plain_lengths = run(plain, "plain f32")
            if lengths != plain_lengths:
                raise RuntimeError(f"YTVOS f32: the plain route's forwards "
                                   f"{plain_lengths} are not the kernel "
                                   f"route's {lengths}")
            for i, (g, w, t) in enumerate(zip(got, want, lengths)):
                agree = gate_pixels(f"YTVOS f32 forward {i}", g, w, w.shape)
                f32_gate(f"YTVOS f32 forward {i} ({t} frames; argmax "
                         f"agreement {agree:.5f} where the margin exceeds "
                         f"{MARGIN})", g, w)
            del got, want
            gc_cuda()
            return
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


def video_training(dev, card, weights, cfg=None, per_step=None,
                   ckpt_per_step=None, what="video"):
    """lavt_video_tiny's training step (`make_video_train_step`: uint8 clip
    normalized on the card, forward with DropPath 0.1 and BERT dropout 0.1,
    the loss on the annotated frame, backward, AdamW, poly LR; `cfg`, bf16
    by default): a warm-up step, then TRAIN_STEPS timed steps on one clip
    with the generator reseeded every step (launch counts `per_step`,
    ms/step, clips/s, peak memory, the loss must fall), then one step under
    torch.profiler and one with --use_checkpoint (`ckpt_per_step`).
    Returns the launch counts."""
    import torch

    from lavt_rs_tpu_torch.config import lavt_video_tiny
    from lavt_rs_tpu_torch.models.factory import build_model
    from lavt_rs_tpu_torch.train.optim import TrainConfig
    from lavt_rs_tpu_torch.train.step import (create_train_state,
                                              make_video_train_step)

    cfg = lavt_video_tiny() if cfg is None else cfg
    per_step = VIDEO_TRAIN_PER_STEP if per_step is None else per_step
    ckpt_per_step = (VIDEO_CKPT_PER_STEP if ckpt_per_step is None
                     else ckpt_per_step)
    model = build_model(cfg, dev, train=True)
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
    log(f"{what} train step, first (warm-up): "
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
    log(f"{what} train launches over {TRAIN_STEPS} steps: "
        f"{nonzero_counts(launches)}")
    check_counts(f"{what} train", launches, per_step, TRAIN_STEPS)
    losses = [o["loss"].item() for o in outs]
    if not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"non-finite {what} training loss: {losses}")
    log(f"{what} train step, one 8-frame 480² clip, {cfg.dtype} (kernels, AdamW, "
        f"DropPath 0.1, BERT dropout 0.1): {ms:.3f} ms/step, "
        f"{1000 / ms:.3f} clips/s (mean of {TRAIN_STEPS} steps); peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB  [{card}]")
    log(f"{what} loss over {TRAIN_STEPS} steps on one clip (dropout reseeded "
        f"each step): first {losses[0]:.6f}, last {losses[-1]:.6f}; all "
        f"{[round(v, 6) for v in losses]}; iou {outs[-1]['iou'].item():.4f}, "
        f"lr {outs[-1]['lr']:.6g}")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"the {what} training loss did not fall")
    profile_clip(lambda: step(batch, gen()), card, f"{what} train step")
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
    model = build_model(cfg.replace(use_checkpoint=True), dev, train=True)
    missing, unexpected = model.load_state_dict(weights, strict=False)
    if missing or any(".res_gate." not in k for k in unexpected):
        raise RuntimeError(f"video checkpoint model: missing {missing}, "
                           f"unexpected {unexpected}")
    step = make_video_train_step(model, *create_train_state(model, tcfg), tcfg)
    peak["on"], ck_launches, out = one_step(step)
    log(f"{what} train step with --use_checkpoint: launches "
        f"{nonzero_counts(ck_launches)}, loss {out['loss'].item():.6f}; peak "
        f"device memory {peak['on'] / 2**30:.3f} GiB against "
        f"{peak['off'] / 2**30:.3f} GiB without it  [{card}]")
    check_counts(f"{what} train --use_checkpoint", ck_launches,
                 ckpt_per_step, 1)
    if not peak["on"] < peak["off"]:
        raise RuntimeError(f"--use_checkpoint did not lower the {what} "
                           f"training step's peak memory")
    del model, step
    torch.cuda.empty_cache()
    return launches


# -- the f32 video paths: --no_bf16 with the kernels ------------------------------

def video_f32(dev, card, weights):
    """lavt_video_tiny in f32 with the kernels (K2p f32 at stage 1, K10 f32
    in the ten other blocks) on the video phase's weights: N_CLIPS 8-frame
    480² clips through `clip_iou` (the f32 counters equal the plan at
    itemsize 4, every bf16 counter 0), one clip against the plain f32
    model by the pixel gate and the f32 gate, ms a clip beside the plain
    model's, one clip under torch.profiler.  Returns the launch counts."""
    import torch

    from lavt_rs_tpu_torch.config import lavt_video_tiny
    from lavt_rs_tpu_torch.eval.video_eval import clip_iou
    from lavt_rs_tpu_torch.models.factory import build_model
    from lavt_rs_tpu_torch.ops.norm import maybe_normalize_image

    cfg = lavt_video_tiny(dtype="float32")
    plan = kernel_plan(cfg, 480, FRAMES)[0]
    per = {f"{k}.f32": n for k, n in plan.items()}
    if per != F32_VIDEO_PER_CLIP:
        raise RuntimeError(f"f32 clip: the kernel plan at itemsize 4 is "
                           f"{plan}, not {F32_VIDEO_PER_CLIP}")
    model = build_model(cfg, dev)
    model.load_state_dict(weights)
    g = torch.Generator(device=dev).manual_seed(SEED + 13)
    reqs = clips(dev, g, N_CLIPS)
    zero_counts()
    results = [clip_iou(model, *r) for r in reqs]
    torch.cuda.synchronize()
    launches = read_counts()
    log(f"f32 video launches over {N_CLIPS} clips: "
        f"{nonzero_counts(launches)} (the plan at itemsize 4: {plan} a clip)")
    check_counts("f32 video", launches, per, N_CLIPS)
    for inter, union in results:
        if not (bool(torch.isfinite(union))
                and 0 <= inter.item() <= union.item()):
            raise RuntimeError(f"f32 clip_iou: bad inter/union {inter}, "
                               f"{union}")
    video_u8, ids, mask, valid, _ = reqs[0]
    clip = maybe_normalize_image(video_u8)[None]

    def fwd(m):
        return lambda: m(clip, ids[None], mask[None])

    ref = build_model(cfg.replace(use_kernels=False), dev)
    ref.load_state_dict(weights)
    with torch.no_grad():
        got, want = fwd(model)()[valid:valid + 1], fwd(ref)()[valid:valid + 1]
        agree = gate_pixels("f32 clip", got, want, (1, 480, 480, 2))
        f32_gate(f"f32 clip, annotated frame {valid} (argmax agreement "
                 f"{agree:.5f} where the margin exceeds {MARGIN})", got, want)
        del got, want
        iters, plain_iters = 10, 3
        ms = cuda_time_ms(fwd(model), iters=iters, warmup=2)
        plain_ms = cuda_time_ms(fwd(ref), iters=plain_iters, warmup=1)
        del ref
        log(f"f32 video forward, one 8-frame 480² clip with the kernels: "
            f"{ms:.3f} ms/clip, {FRAMES * 1000 / ms:.2f} frames/s (mean of "
            f"{iters}); the plain f32 model (TF32 off): {plain_ms:.3f} "
            f"ms/clip, {FRAMES * 1000 / plain_ms:.2f} frames/s (mean of "
            f"{plain_iters})  [{card}]")
        profile_clip(fwd(model), card, "f32 video clip")
    del model
    gc_cuda()
    return launches


def f32_training_gate(dev, weights, cfg, batch, per_step, blocks, what):
    """An f32 train step's gate: one forward + backward of `cfg` (f32) with
    the kernels and of the plain f32 route (`use_kernels=False`) from the
    same weights, batch and generator seed, DropPath, dropout and
    BatchNorm's batch statistics on as in the step: the f32 launches equal
    `per_step`, the losses within F32_LOSS_RTOL, every one of the `blocks`
    Swin blocks' parameter gradients (relative-position tables included)
    with cosine >= F32_MIN_COS."""
    seed = SEED + 26
    ref_loss, ref = gate_run(dev, cfg.replace(use_kernels=False), weights,
                             True, batch, seed)
    zero_counts()
    loss, got = gate_run(dev, cfg, weights, True, batch, seed)
    launches = read_counts()
    check_counts(what, launches, per_step, 1)
    rel = abs(loss - ref_loss) / abs(ref_loss)
    cos = block_cosines(got, ref)
    del got, ref
    if len(cos) != blocks:
        raise RuntimeError(f"{what}: {len(cos)} blocks, expected {blocks}")
    worst = min(cos, key=cos.get)
    log(f"{what} (DropPath, dropout, BN batch statistics): loss kernels "
        f"{loss:.8f}, plain f32 route {ref_loss:.8f}, rel diff {rel:.3g} "
        f"(limit {F32_LOSS_RTOL}); {blocks} Swin blocks, worst gradient "
        f"cosine {cos[worst]:.7f} ({worst}, limit {F32_MIN_COS}), mean "
        f"{sum(cos.values()) / len(cos):.7f}; launches "
        f"{nonzero_counts(launches)}")
    if rel > F32_LOSS_RTOL:
        raise RuntimeError(f"{what}: loss rel diff {rel:.4g} > "
                           f"{F32_LOSS_RTOL}")
    if cos[worst] < F32_MIN_COS:
        raise RuntimeError(f"{what}: cosine {cos[worst]:.7f} < "
                           f"{F32_MIN_COS}")


def video_training_gate_f32(dev, weights):
    """The f32 video train step's gate (`f32_training_gate`): lavt_video_
    tiny in f32, K10 f32's save mode and K9 f32 in its 12 3D blocks."""
    import torch

    from lavt_rs_tpu_torch.config import lavt_video_tiny

    batch = video_train_batch(
        dev, torch.Generator(device=dev).manual_seed(SEED + 25))
    f32_training_gate(dev, weights, lavt_video_tiny(dtype="float32"), batch,
                      F32_VIDEO_TRAIN_PER_STEP, 12, "f32 video training gate")


# -- the video train CLI: the pseudo-clip, refexp, YTVOS and joint branches -------

def write_ytvos_train(root, rng):
    """A Ref-YouTube-VOS train split under root, laid out as `YTVOSDataset`
    reads it: YTVOS_TRAIN_VIDEOS as JPEG frames at their original sizes in
    JPEGImages/<video>/, palette PNGs in Annotations/<video>/ holding
    YTVOS_TRAIN_OBJECTS ellipses (object ids 1, 2, ...) that move over the
    frames, one expression per object in meta_expressions.json (with its
    obj_id).  Returns the json's path."""
    import numpy as np
    from PIL import Image

    palette = [v for i in range(256) for v in (i, i, i)]
    meta = {"videos": {}}
    for name, n, (h, w) in YTVOS_TRAIN_VIDEOS:
        jdir = os.path.join(root, "JPEGImages", name)
        adir = os.path.join(root, "Annotations", name)
        os.makedirs(jdir)
        os.makedirs(adir)
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        frames = [f"{5 * t:05d}" for t in range(n)]
        for t, fr in enumerate(frames):
            u, v = xx / max(h, w), yy / max(h, w)
            smooth = np.stack([np.sin(9 * u + 0.3 * t), np.cos(7 * v - 0.2 * t),
                               np.sin(5 * (u + v) + 0.1 * t)], -1)
            img = 127.5 + 100 * smooth + rng.normal(0, 10, (h, w, 3))
            Image.fromarray(img.clip(0, 255).astype(np.uint8)).save(
                os.path.join(jdir, f"{fr}.jpg"), quality=90)
            m = np.zeros((h, w), np.uint8)
            for obj in range(1, YTVOS_TRAIN_OBJECTS + 1):
                cx = w * (0.25 + 0.5 * (obj - 1) + 0.005 * t)
                inside = ((yy - 0.5 * h) / (0.2 * h)) ** 2 \
                    + ((xx - cx) / (0.15 * w)) ** 2 <= 1
                m[inside] = obj
            png = Image.frombytes("P", (w, h), m.tobytes())
            png.putpalette(palette)
            png.save(os.path.join(adir, f"{fr}.png"))
        meta["videos"][name] = {"frames": frames, "expressions": {
            str(obj - 1): {"exp": " ".join(rng.choice(
                EVAL_WORDS, int(rng.integers(2, 9)))), "obj_id": str(obj)}
            for obj in range(1, YTVOS_TRAIN_OBJECTS + 1)}}
    ann = os.path.join(root, "meta_expressions.json")
    with open(ann, "w") as fh:
        json.dump(meta, fh)
    return ann


def write_refexp(root):
    """refcoco's train refs under `root` (`write_refcoco`) as the COCO-format
    refexp json `refcoco/instances_refcoco_train.json`: one image entry per
    sentence, the sentence its caption, the ref's annotation its one
    instance.  Returns the entries' count."""
    from lavt_rs_tpu_torch.data.refer import REFER

    refer = REFER(root)
    images, anns = [], []
    for ref_id in refer.getRefIds(split="train"):
        ref = refer.Refs[ref_id]
        for sent in ref["sentences"]:
            n = len(images) + 1
            images.append(dict(refer.Imgs[ref["image_id"]], id=n,
                               caption=sent["raw"]))
            anns.append(dict(refer.Anns[ref["ann_id"]], id=n, image_id=n))
    with open(os.path.join(root, "refcoco", "instances_refcoco_train.json"),
              "w") as fh:
        json.dump({"images": images, "annotations": anns}, fh)
    return len(images)


def video_train_cli_phase(dev, card):
    """`cli.train.main --model lavt_video` in process at the A2D recipe
    (VIDEO_RECIPE, 480², FRAMES frames, bf16), its weights drawn by the CLI
    from --seed, on data written by the phase (`write_refcoco`'s split:
    TRAIN_REFS train refs, EVAL_REFS val refs):
      * --dataset ref_pseudo_video at -b VIDEO_CLI_BATCH -j 4 for two
        epochs, each evaluated by `evaluate_a2d` on the val refs as static
        pseudo-clips, best-only checkpoints;
      * one epoch over the same train refs as a COCO-format refexp json
        (`write_refexp`: `build_refexp_dataset` takes it);
      * --dataset ytvos at -b YTVOS_CLI_BATCH on `write_ytvos_train`'s
        videos (trains blind, keeps the last 8);
      * one epoch of --dataset joint (the split under the three
        RefCOCO-family names, then the YTVOS set);
      * the f32 gate: one ref_pseudo_video epoch with --no_bf16 -j 1 and
        its f32 eval, against --no_pallas --no_bf16 from the same seed
        (the first logged loss within F32_CLI_LOSS_RTOL).
    Checks the launches per step and per eval clip against the models'
    `kernel_plan` (bf16 and at itemsize 4; none on the plain run), the
    checkpoints' names, tags, best-only skips and keep counts (JAX
    cli/train.py:362-441) and finite losses; prints steps/s, clips/s, the
    loader's data wait against the iteration time, eval seconds and peak
    device memory.  Returns the phase's seconds."""
    import contextlib
    import io
    import re
    import shutil
    import tempfile

    import numpy as np
    import torch

    from lavt_rs_tpu_torch.cli import train as cli_train
    from lavt_rs_tpu_torch.config import lavt_video_tiny
    from lavt_rs_tpu_torch.eval import video_eval
    from lavt_rs_tpu_torch.train import checkpoint as ckpt

    t_phase = time.perf_counter()
    plans = {}
    for dtype, suffix, step_want, clip_want in (
            ("bfloat16", "", VIDEO_TRAIN_PER_STEP, VIDEO_PER_CLIP),
            ("float32", ".f32", F32_VIDEO_TRAIN_PER_STEP,
             F32_VIDEO_PER_CLIP)):
        cfg = lavt_video_tiny(dtype=dtype)
        plans[dtype] = [{f"{k}{suffix}": n for k, n in
                         kernel_plan(cfg, CLI_IMG, FRAMES, train)[0].items()}
                        for train in (True, False)]
        if plans[dtype] != [step_want, clip_want]:
            raise RuntimeError(f"video train CLI: the {dtype} plan gives "
                               f"{plans[dtype]}, not {step_want} a step and "
                               f"{clip_want} a clip")
    evaluate, save = video_eval.evaluate_a2d, ckpt.save_checkpoint
    counts = {}

    def counted_evaluate(*a, **kw):
        torch.cuda.synchronize()
        counts["train"].append(read_counts())
        zero_counts()
        t0 = time.perf_counter()
        summary = evaluate(*a, **kw)
        torch.cuda.synchronize()
        counts["eval"].append(read_counts())
        counts["eval s"].append(time.perf_counter() - t0)
        counts["summary"].append(summary)
        zero_counts()
        return summary

    def recorded_save(*a, **kw):
        counts["keep"].append(kw.get("keep"))
        return save(*a, **kw)

    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        rng = np.random.default_rng(SEED + 50)
        vocab = write_refcoco(root, np.random.default_rng(SEED + 30))
        yroot = os.path.join(root, "ytvos")
        yann = write_ytvos_train(yroot, rng)
        # one item per (video, expression, every FRAMES-th frame)
        ytvos_items = YTVOS_TRAIN_OBJECTS * sum(
            -(-n // FRAMES) for _, n, _ in YTVOS_TRAIN_VIDEOS)
        log(f"video train CLI data written in {time.perf_counter() - t0:.2f} "
            f"s: {TRAIN_REFS} train / {EVAL_REFS} val refs, YTVOS "
            f"{[v[:3] for v in YTVOS_TRAIN_VIDEOS]} ({ytvos_items} items)")
        base = list(VIDEO_RECIPE) + [
            "--img_size", str(CLI_IMG), "--num_frames", str(FRAMES),
            "--refer_data_root", root, "--vocab", vocab, "--device",
            str(dev), "--split", "train", "--val_split", "val",
            "--print-freq", "1", "--seed", str(SEED)]
        ytvos = ["--ytvos_data_root", yroot, "--ytvos_ann", yann]

        def run(extra, what, steps, batch, per_step, per_clip, epochs=1):
            gc_cuda()
            torch.cuda.reset_peak_memory_stats()
            counts.clear()
            counts.update(train=[], eval=[], summary=[], keep=[],
                          **{"eval s": []})
            zero_counts()
            err = io.StringIO()
            video_eval.evaluate_a2d = counted_evaluate
            ckpt.save_checkpoint = recorded_save
            t0 = time.perf_counter()
            try:
                with contextlib.redirect_stderr(err):
                    rec = cli_train.main(base + extra)
            finally:
                video_eval.evaluate_a2d, ckpt.save_checkpoint = evaluate, save
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() / 2**30
            text = err.getvalue()
            for line in text.splitlines():
                log(f"video train cli: {line}")
            if not counts["eval"]:  # no eval: the run's launches
                counts["train"].append(read_counts())
            log(f"{what}: launches over {steps} steps an epoch "
                f"{[nonzero_counts(c) for c in counts['train']]}"
                + (f", over {EVAL_REFS} eval clips "
                   f"{[nonzero_counts(c) for c in counts['eval']]}"
                   if counts["eval"] else ""))
            for c in counts["train"]:  # an epoch's (the run is one epoch)
                check_counts(f"{what} steps", c, per_step, steps)
            for c in counts["eval"]:
                check_counts(f"{what} eval", c, per_clip, EVAL_REFS)
            if per_clip is not None and len(counts["eval"]) != epochs:
                raise RuntimeError(f"{what}: {len(counts['eval'])} evals in "
                                   f"{epochs} epochs")
            lg = rec["logger"]
            it, dt, loss = lg.iter_time, lg.data_time, lg.meters["loss"]
            if it.count != steps or not all(map(math.isfinite, loss.deque)):
                raise RuntimeError(f"{what}: {it.count} steps, losses "
                                   f"{list(loss.deque)}")
            avg = it.total / it.count
            log(f"{what}: {steps} steps of {batch} clips in its last epoch: "
                f"iteration {avg:.4f} s mean ({[round(x, 4) for x in it.deque]}"
                f"), {1 / avg:.3f} steps/s, {batch / avg:.3f} clips/s; data "
                f"wait {dt.total / dt.count:.4f} s mean "
                f"({[round(x, 4) for x in dt.deque]}) = "
                f"{dt.total / it.total:.3f} of the iteration time; losses "
                f"{[round(x, 6) for x in loss.deque]}; eval "
                f"{[round(x, 2) for x in counts['eval s']]} s "
                f"({[round(EVAL_REFS / x, 2) for x in counts['eval s']]} "
                f"clips/s); whole run {seconds:.1f} s; peak device memory "
                f"{peak:.2f} GiB  [{card}]")
            return rec, text, dict(counts)

        def epoch_mious(text):
            return [float(m) for _, m in re.findall(
                r"epoch (\d+) done in [\d.]+s \(train mIoU ([\d.]+)\)", text)]

        def tag_of(miou, summary):
            return (f"tmIoU_{miou:.2f}" + ("" if summary is None else
                    f"_mIoU_{summary['mIoU']:.2f}_oIoU_{summary['oIoU']:.2f}"))

        def saved(out, want, what):
            names = [os.path.basename(p) for _, p in
                     ckpt.list_checkpoints(out)]
            log(f"{what}: checkpoints {names}")
            if names != want:
                raise RuntimeError(f"{what}: checkpoints {names}, expected "
                                   f"{want}")
            shutil.rmtree(out)

        b = str(VIDEO_CLI_BATCH)
        rpv_steps = TRAIN_REFS // VIDEO_CLI_BATCH
        # 1. ref_pseudo_video: two epochs, each evaluated, best-only saving
        out = os.path.join(root, "rpv")
        rec, text, c = run(["--dataset", "ref_pseudo_video", "-b", b, "-j",
                            "4", "--epochs", "2", "--output-dir", out],
                           "video train CLI ref_pseudo_video", rpv_steps,
                           VIDEO_CLI_BATCH, VIDEO_TRAIN_PER_STEP,
                           VIDEO_PER_CLIP, epochs=2)
        m = epoch_mious(text)
        want = [f"epoch_0000_lavt_{tag_of(m[0], c['summary'][0])}.pth"]
        skip = (f"epoch 1: train mIoU {m[1]:.2f} did not improve on "
                f"{m[0]:.2f}; not saving")
        if skip not in text:
            want.append(f"epoch_0001_lavt_{tag_of(m[1], c['summary'][1])}"
                        ".pth")
        log(f"video train CLI ref_pseudo_video: train mIoU {m}, evals "
            f"{[(s['mIoU'], s['oIoU']) for s in c['summary']]}; epoch 1 "
            f"{'skipped (best-only)' if skip in text else 'saved'}")
        if len(m) != 2 or (m[1] > m[0] if skip in text else m[1] < m[0]) \
                or c["keep"] != [None] * len(want):
            raise RuntimeError(f"video train CLI ref_pseudo_video: train "
                               f"mIoU {m}, saves {c['keep']}")
        saved(out, want, "video train CLI ref_pseudo_video")

        # 2. the same refs as a COCO-format refexp json (then removed: the
        #    joint run reads refcoco by REFER)
        entries = write_refexp(root)
        out = os.path.join(root, "refexp")
        rec, text, c = run(["--dataset", "ref_pseudo_video", "-b", b, "-j",
                            "4", "--epochs", "1", "--output-dir", out],
                           "video train CLI refexp json",
                           entries // VIDEO_CLI_BATCH, VIDEO_CLI_BATCH,
                           VIDEO_TRAIN_PER_STEP, VIDEO_PER_CLIP)
        os.remove(os.path.join(root, "refcoco",
                               "instances_refcoco_train.json"))
        saved(out, [f"epoch_0000_lavt_"
                    f"{tag_of(rec['train_mIoU'], c['summary'][0])}.pth"],
              f"video train CLI refexp json ({entries} entries)")

        # 3. ytvos: trains blind, keeps the last 8
        out = os.path.join(root, "ytvos_ck")
        rec, text, c = run(["--dataset", "ytvos", "-b", str(YTVOS_CLI_BATCH),
                            "-j", "4", "--epochs", "1", "--output-dir", out]
                           + ytvos, "video train CLI ytvos",
                           ytvos_items // YTVOS_CLI_BATCH, YTVOS_CLI_BATCH,
                           VIDEO_TRAIN_PER_STEP, None)
        if c["keep"] != [8] or c["eval"]:
            raise RuntimeError(f"video train CLI ytvos: keep {c['keep']}, "
                               f"{len(c['eval'])} evals")
        saved(out, [f"epoch_0000_lavt_{tag_of(rec['train_mIoU'], None)}.pth"],
              "video train CLI ytvos (keep 8)")

        # 4. joint: the split under the three RefCOCO-family names + YTVOS
        shutil.copytree(os.path.join(root, "refcoco"),
                        os.path.join(root, "refcoco+"))
        shutil.copytree(os.path.join(root, "refcoco"),
                        os.path.join(root, "refcocog"))
        os.rename(os.path.join(root, "refcocog", "refs(unc).p"),
                  os.path.join(root, "refcocog", "refs(umd).p"))
        out = os.path.join(root, "joint")
        rec, text, c = run(["--dataset", "joint", "-b", b, "-j", "4",
                            "--epochs", "1", "--output-dir", out] + ytvos,
                           "video train CLI joint",
                           (3 * TRAIN_REFS + ytvos_items) // VIDEO_CLI_BATCH,
                           VIDEO_CLI_BATCH, VIDEO_TRAIN_PER_STEP, None)
        if c["keep"] != [None] or c["eval"]:
            raise RuntimeError(f"video train CLI joint: keep {c['keep']}, "
                               f"{len(c['eval'])} evals")
        saved(out, [f"epoch_0000_lavt_{tag_of(rec['train_mIoU'], None)}.pth"],
              "video train CLI joint")

        # 5. the f32 gate: --no_bf16 with the kernels against --no_pallas
        f32 = ["--dataset", "ref_pseudo_video", "-b", b, "-j", "1",
               "--no_bf16", "--epochs", "1", "--output-dir", ""]
        rec, _, _ = run(f32, "video train CLI ref_pseudo_video --no_bf16",
                        rpv_steps, VIDEO_CLI_BATCH, F32_VIDEO_TRAIN_PER_STEP,
                        F32_VIDEO_PER_CLIP)
        plain, _, _ = run(f32 + ["--no_pallas", "--eval_every", "2"],
                          "video train CLI ref_pseudo_video --no_pallas "
                          "--no_bf16", rpv_steps, VIDEO_CLI_BATCH, {}, None)
        got = rec["logger"].meters["loss"].deque[0]
        want = plain["logger"].meters["loss"].deque[0]
        rel = abs(got - want) / abs(want)
        log(f"video train CLI --no_bf16: first logged loss {got:.8f} with the "
            f"kernels, {want:.8f} with --no_pallas, rel diff {rel:.3g} "
            f"(limit {F32_CLI_LOSS_RTOL})")
        if rel > F32_CLI_LOSS_RTOL:
            raise RuntimeError(f"video train CLI --no_bf16: first loss rel "
                               f"diff {rel:.4g} > {F32_CLI_LOSS_RTOL}")
    gc_cuda()
    seconds = time.perf_counter() - t_phase
    log(f"video train CLI phase: {seconds:.1f} s  [{card}]")
    return seconds


# -- window-7 training in f32: K8 f32, K7 f32, K4b f32 -----------------------------

def f32_train_kernel_phase(dev, res):
    """K4b f32, K8 f32 and K7 f32 (with keep, a dropped sample among the
    eight, in the 23 DropPath blocks; without it in stage 1's first) at
    the four Swin-B stage shapes of a bs-8 window-7 step (M = 8 side², C,
    hidden 4C), and K10 f32's save mode and K9 f32 at the four window-7
    shapes (8, nW, h, 49, 32), unshifted and under the shift mask; each
    against its f32 plain version within F32_TOL abs + rel (K8 f32 also on
    the branch out - x; K10's save mode's O and lse, and dx, dq, dk, dv
    elementwise), the backward's sums over rows or windows (K7 f32's
    weight and bias grads, K4b f32's dscale and dbias, K9 f32's dbias)
    against f64 (`check_f32_backward`), timed (CUDA events) beside its bound
    (PEAK_FLOPS_F32), its plain version and its f32 library chain (TF32
    off: F.layer_norm / linear / GELU / linear for K8, autograd through it
    for K7, through f32 F.layer_norm for K4b; SDPA over B nW windows and
    autograd through it for K10's save mode and K9), and on the device
    with its launches queued; two calls of K4b f32, K7 f32 and K9 f32 give
    the same bits; K8 f32's and K7 f32's launches by device ms
    (torch.profiler) beside each launch's bound at every stage, and (in
    `run_deferred`'s process) one K3 f32, one K8 f32 and one K7 f32 call
    at stage 1 with only the port's kernels.  Per training step into
    `res`."""
    import torch

    from lavt_rs_tpu_torch.ops import fused_mlp as fm
    from lavt_rs_tpu_torch.ops import ln
    from lavt_rs_tpu_torch.ops import window_attn as wa
    from lavt_rs_tpu_torch.ops.window import (relative_bias_from_table,
                                              relative_position_index_2d,
                                              shift_mask_2d)

    g = torch.Generator(device=dev).manual_seed(SEED + 60)
    f32 = torch.float32

    def rnd(shape, std=1.0):
        return torch.randn(shape, generator=g, device=dev) * std

    def check(name, got, want):
        return compare(name, got, want, F32_TOL)

    def check_all(name, got, want):
        return max(check(name, a, b) for a, b in zip(got, want))

    keep = torch.where(torch.arange(BATCH, device=dev) % 3 != 1, 1.0 / 0.7,
                       0.0)
    for si, (side, c, heads, depth) in enumerate(STAGES):
        rows, tail = BATCH * side * side, side * side
        what = f"stage {si + 1} ({rows}, {c})"
        x = rnd((rows, c), 2.0) + 0.5
        s_, b_ = rnd((c,), 0.2) + 1.0, rnd((c,), 0.2)
        gy = rnd((rows, c))

        def k4b():
            return ln.layer_norm_rows_bwd_f32(x, s_, gy)

        measure(res, "K4b.f32", what, 1, k4b,
                lambda: ln.layer_norm_rows_bwd_plain(x, s_, gy),
                chain_grad(torch_bf16_ln, (x, s_, b_), gy),
                ln_bwd_work(rows, c, 4),
                check_f32_backward(f64_grads(torch_bf16_ln, (x, s_, b_), gy),
                                   1), peak=PEAK_FLOPS_F32)
        check_deterministic(f"K4b f32 {what}", k4b)
        device_per_call(res, "K4b.f32", what, 1, k4b)
        defer(functools.partial(k4b_f32_kernel_check, f"K4b f32 {what}"), x,
              s_, gy)
        mlp = (x, s_, b_, rnd((4 * c, c), c ** -0.5), rnd((4 * c,), 0.2),
               rnd((c, 4 * c), (4 * c) ** -0.5), rnd((c,), 0.2))
        keep_rows = keep.repeat_interleave(tail)[:, None]
        dp_blocks = depth - (1 if si == 0 else 0)

        def k8():
            return fm.fused_ln_mlp_droppath_f32(*mlp, keep, tail)

        measure(res, "K8.f32", f"{what} keep", dp_blocks, k8,
                lambda: fm.fused_ln_mlp_droppath_plain(*mlp, keep, tail),
                lambda: torch_bf16_mlp(*mlp, keep_rows),
                mlp_work(rows, c, keep=BATCH, item=4),
                lambda name, got, want: max(
                    check(name, got, want), check(name, got - x, want - x)),
                peak=PEAK_FLOPS_F32)
        device_per_call(res, "K8.f32", f"{what} keep", dp_blocks, k8)
        plan = fm.bwd_plan(rows, c, 4 * c, True)
        work = mlp_launch_work(rows, c, plan.splits, 4)
        f32_launch_line(f"K8.f32 launches {what} keep", k8,
                        mlp_f32_launch_work(rows, c))
        for kp, calls in [(keep, dp_blocks)] + ([(None, 1)] if si == 0
                                                else []):
            kr = None if kp is None else keep_rows
            bwd = (x, gy, *mlp[1:6], kp, tail)

            def k7(bwd=bwd):
                return fm.fused_ln_mlp_bwd_f32(*bwd)

            w7 = f"{what} keep {kp is not None}"
            ref64 = f64_grads(lambda *t, kr=kr: torch_bf16_mlp(
                *t, None if kr is None else kr.double()), mlp, gy)
            measure(res, "K7.f32", w7, calls, k7,
                    lambda bwd=bwd: fm.fused_ln_mlp_bwd_plain(*bwd),
                    chain_grad(lambda *t, kr=kr: torch_bf16_mlp(*t, kr), mlp,
                               gy),
                    mlp_work(rows, c, backward=True, item=4),
                    check_f32_backward(ref64, 1), peak=PEAK_FLOPS_F32)
            del ref64
            check_deterministic(f"K7 f32 {w7}", k7)
            device_per_call(res, "K7.f32", w7, calls, k7)
            if kp is not None:  # the dual GEMM, weight grads, dyln on the core
                f32_launch_line(f"K7.f32 launches {w7}", k7,
                                {k: work[k] for k in ("prep", "dual GEMM",
                                                      "wgrad", "dyln",
                                                      "LN bwd")})
                if si == 0:
                    defer(functools.partial(
                        mlp_port_check, f"K3 f32 / K8 f32 / K7 f32 {w7}", tail),
                        *mlp, gy, keep)
        del x, gy, mlp
        torch.cuda.empty_cache()
    sc = 32 ** -0.5
    index = torch.from_numpy(relative_position_index_2d(7, 7)).to(dev)
    for si, (side, c, heads, depth) in enumerate(W7_STAGES):
        nw = (side // 7) ** 2
        q, k, v, do = (rnd((BATCH, nw, heads, 49, 32)) for _ in range(4))
        bias = relative_bias_from_table(rnd((13 * 13, heads)), index)
        for shift in (False, True):
            mask = shift_mask_2d(side, side, 7, 3, dev) if shift else None
            masked = masked_windows(mask)
            am = sdpa_mask(bias, mask, nw, BATCH, f32)
            what = f"window 7 stage {si + 1} q{tuple(q.shape)} mask {shift}"
            measure(res, "K10s.f32/w7", what, depth // 2,
                    lambda m=mask: wa.window_attention_save(q, k, v, bias, m,
                                                            sc),
                    lambda m=mask: wa.window_attention_save_plain(
                        q, k, v, bias, m, sc),
                    lambda am=am: sdpa_windows(q, k, v, am, sc),
                    attn_save_work(BATCH, nw, heads, 49, masked, 4),
                    check_all, peak=PEAK_FLOPS_F32)
            del am
            o, lse = wa.window_attention_save(q, k, v, bias, mask, sc)

            def sdpa_chain(q_, k_, v_, b_, mask=mask, nw=nw):
                return sdpa_windows(q_, k_, v_,
                                    sdpa_mask(b_, mask, nw, BATCH, f32),
                                    sc).view(q_.shape)

            def k9(m=mask, o=o, lse=lse, flags=wa.mask_flags(mask)):
                return wa.attention_core_bwd(q, k, v, bias, m, do, sc, o, lse,
                                             flags)

            def attn(q_, k_, v_, b_, mask=mask):
                s_ = q_ @ k_.transpose(-1, -2) * sc + b_
                s_ = s_ if mask is None else s_ + mask[:, None]
                return torch.softmax(s_, -1) @ v_

            measure(res, "K9.f32/w7", what, depth // 2, k9,
                    lambda m=mask, o=o: wa.attention_core_bwd_plain(
                        q, k, v, bias, m, do, sc, o),
                    chain_grad(sdpa_chain, (q, k, v, bias), do),
                    attn_bwd_work(BATCH, nw, heads, 49, masked, 4),
                    check_f32_backward(f64_grads(attn, (q, k, v, bias), do),
                                       3), peak=PEAK_FLOPS_F32)
            check_deterministic(f"K9 f32 {what}", k9)
            log_device_by_kernel(f"K9.f32/w7 {what}", k9)
            del o, lse
        del q, k, v, do
        torch.cuda.empty_cache()
    for key in F32_TRAIN_NAMES:
        r = res.r[key]
        device = (f" (on the device, launches queued: {r['device']:.3f} ms)"
                  if r["device"] else "")
        log(f"{key} per window-7 bs-{BATCH} f32 train step: kernel "
            f"{r['ms']:.3f} ms{device}, bound {r['bound']:.3f} ms "
            f"({res.bound_by(key)}), plain (f32) {r['plain']:.3f} ms, "
            f"library (f32, TF32 off) {r['lib']:.3f} ms{ffma_design(key)}")


def train_cli_f32_phase(dev, card, window12=False):
    """`cli.train --no_bf16` at window 7 (the CLI's default) on a synthetic
    RefCOCO split (TRAIN_REFS train refs, EVAL_REFS val refs), Swin-B
    480², bs 8, -j 1 (one loader thread: the same batches in every run),
    weights drawn by the CLI from its seed: epoch 0 with the kernels into
    a temporary --output-dir, then --resume on it for epoch 1, whose
    in-train eval runs on the f32 kernels; and epoch 0 with --no_pallas
    --no_bf16 from the same seed (those two save no checkpoint).  Checks the launches per step
    (F32_W7_TRAIN_PER_STEP) and per eval batch (F32_W7_INFER_PER_FORWARD),
    none on the plain run, and the first logged loss against the plain
    run's (F32_CLI_LOSS_RTOL); prints iteration and data seconds, img/s,
    the eval's seconds and peak device memory.  With `window12`
    (`--window12 --no_bf16`): epoch 0 with the kernels and its f32 eval
    (F32_W12_TRAIN_PER_STEP a step, F32_W12_INFER_PER_FORWARD an eval
    batch), then epoch 0 with --no_pallas --no_bf16, no checkpoint."""
    import contextlib
    import gc
    import io
    import tempfile

    import numpy as np
    import torch

    from lavt_rs_tpu_torch.cli import train as cli_train
    from lavt_rs_tpu_torch.data.refcoco import ReferDataset
    from lavt_rs_tpu_torch.data.refer import REFER
    from lavt_rs_tpu_torch.eval import refcoco_eval
    from lavt_rs_tpu_torch.text.tokenizer import WordPieceTokenizer

    evaluate = refcoco_eval.evaluate
    counts = {}

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
        argv = ["--img_size", "480", "--refer_data_root", root, "--dataset",
                "refcoco", "--splitBy", "unc", "--vocab", vocab, "--device",
                str(dev), "--no_bf16", "-b", str(BATCH), "-j", "1",
                "--split", "train", "--val_split", "val", "--print-freq", "1",
                "--eval_every", "2"]

        def run(extra, what, per_step, per_eval):
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            counts.clear()
            zero_counts()
            err = io.StringIO()
            refcoco_eval.evaluate = counted_evaluate
            t0 = time.perf_counter()
            try:
                with contextlib.redirect_stderr(err):
                    rec = cli_train.main(argv + extra)
            finally:
                refcoco_eval.evaluate = evaluate
            seconds = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() / 2**30
            for line in err.getvalue().splitlines():
                log(f"train cli f32: {line}")
            counts.setdefault("train", read_counts())
            log(f"{what}: launches over {steps} steps "
                f"{nonzero_counts(counts['train'])}"
                + (f", over {eval_batches} eval batches "
                   f"{nonzero_counts(counts['eval'])}" if "eval" in counts
                   else ""))
            check_counts(f"{what} steps", counts["train"], per_step, steps)
            if per_eval is not None:
                check_counts(f"{what} eval", counts["eval"], per_eval,
                             eval_batches)
            lg = rec["logger"]
            it, dt, loss = lg.iter_time, lg.data_time, lg.meters["loss"]
            if it.count != steps or not all(map(math.isfinite, loss.deque)):
                raise RuntimeError(f"{what}: {it.count} steps, losses "
                                   f"{list(loss.deque)}")
            log(f"{what}: {steps} steps of {BATCH}: iteration {it.avg:.4f} s "
                f"mean ({[round(x, 4) for x in it.deque]}), "
                f"{BATCH / it.avg:.2f} img/s; data wait {dt.avg:.4f} s mean "
                f"({[round(x, 4) for x in dt.deque]}); losses "
                f"{[round(x, 8) for x in loss.deque]}"
                + (f"; eval {counts['eval s']:.2f} s, summary "
                   f"{rec['summary']}" if "eval s" in counts else "")
                + f"; whole run {seconds:.1f} s; peak device memory "
                f"{peak:.2f} GiB  [{card}]")
            return rec

        tag = " --window12" if window12 else ""
        if window12:
            argv.append("--window12")
            rec0 = run(["--epochs", "1", "--eval_every", "1", "--output-dir",
                        ""], "train CLI --window12 --no_bf16 epoch 0 (its "
                       "f32 eval)", F32_W12_TRAIN_PER_STEP,
                       F32_W12_INFER_PER_FORWARD)
        else:
            rec0 = run(["--epochs", "1", "--output-dir", out],
                       "train CLI --no_bf16 epoch 0", F32_W7_TRAIN_PER_STEP,
                       None)
            run(["--epochs", "2", "--resume", out, "--output-dir", ""],
                "train CLI --no_bf16 epoch 1 (--resume, its f32 eval)",
                F32_W7_TRAIN_PER_STEP, F32_W7_INFER_PER_FORWARD)
        plain = run(["--epochs", "1", "--no_pallas", "--output-dir", ""],
                    f"train CLI{tag} --no_pallas --no_bf16 epoch 0", {}, None)
        got = rec0["logger"].meters["loss"].deque[0]
        want = plain["logger"].meters["loss"].deque[0]
        rel = abs(got - want) / abs(want)
        log(f"train CLI{tag} --no_bf16: first logged loss {got:.8f} with the "
            f"kernels, {want:.8f} with --no_pallas, rel diff {rel:.3g} "
            f"(limit {F32_CLI_LOSS_RTOL})")
        if rel > F32_CLI_LOSS_RTOL:
            raise RuntimeError(f"train CLI{tag} --no_bf16: first loss rel "
                               f"diff {rel:.4g} > {F32_CLI_LOSS_RTOL}")


# -- window-12 training in f32: the save mode f32, K5 f32, K6 f32, K2 f32 ---------

def msa_chain(x, wqkv, bqkv, wproj, bproj, bias, mask, heads, scale):
    """The window MSA as a PyTorch chain in x's dtype (the f64 reference
    of K5 f32's and K6 f32's sums; no library yardstick)."""
    b, nw, n, c = x.shape
    qkv = (x @ wqkv.t() + bqkv).view(b, nw, n, 3, heads, c // heads)
    q, k, v = qkv.permute(3, 0, 1, 4, 2, 5)
    s = (q * scale) @ k.transpose(-1, -2) + bias
    if mask is not None:
        s = s + mask[:, None]
    o = (s.softmax(-1) @ v).permute(0, 1, 3, 2, 4).reshape(b, nw, n, c)
    return o @ wproj.t() + bproj


def f32_step_counts(cfg, batch):
    """The f32 counters of one training step of `cfg` at 480² and `batch`,
    from its blocks' own kernels (`SwinBlock.kernels`, at itemsize 4): a
    block's K1 / K2 counts on the save mode f32 where its backward is K5,
    else on K1 f32 / K2 f32 (the taped forward); every other kernel on its
    f32 variant's counter; the stage norms' K4 / K4b from the model's
    `kernel_plan`, whose counts these add up to."""
    from lavt_rs_tpu_torch.models.factory import build_model

    backbone = build_model(cfg, "meta", train=True).backbone
    plan, _ = backbone.kernel_plan((480, 480), batch, 4, True)
    counts = {f"{k}.f32": plan[k] for k in ("K4", "K4b") if k in plan}
    hw = (120, 120)
    total = {}
    for layer in backbone.layers:
        for blk in layer.blocks:
            ks = blk.kernels(hw, batch, 4, True)
            for k in ks:
                total[k] = total.get(k, 0) + 1
                key = ("save" if k in ("K1", "K2") and "K5" in ks else k)
                counts[f"{key}.f32"] = counts.get(f"{key}.f32", 0) + 1
        hw = ((hw[0] + 1) // 2, (hw[1] + 1) // 2)
    total.update({k: plan[k] for k in ("K4", "K4b") if k in plan})
    if total != plan:
        raise RuntimeError(f"the blocks' kernels {total} do not add up to "
                           f"the plan {plan}")
    return counts


def f32_msa_train_kernel_phase(dev, res):
    """The window-12 f32 training path's MSA kernels at its shapes (Swin-B
    480²), shifted and unshifted, each against its f32 plain version
    within F32_TOL abs + rel (the save mode f32: y, q, k, v, P and xn; K5
    f32 and K6 f32: dx, and their sums over rows or windows, dWqkv, dbqkv,
    dWproj, dbproj, dbias, within F32_TOL (rms + |want|) of their f64
    values, `check_f32_backward`), timed (CUDA events) beside its bound
    (PEAK_FLOPS_F32), its plain version and its f32 library chain (TF32
    off: the matmul chain for the save mode, whose P SDPA does not return;
    the faster of the matmul and linear / SDPA / linear chains, or of
    autograd through them, for K2 f32, K5 f32 and K6 f32), and on the
    device with its launches queued:
      * bs 8 (the 10-step run): K6 f32 at stage 1 (with LN), the save mode
        f32 at stage 2 (with LN) and 3-4 (without), K5 f32 at stages 2-4
        on the save mode's residuals (two calls give the same bits);
      * bs 20 (every block recomputes): K6 f32 at every stage and K2 f32
        (the taped form, exact; the clamp form checked) at stages 3-4;
      * F7 at stage 1's geometry with logits past 80 (a bias table of std
        F7_BIAS_STD): K1 f32 at inference takes the clamp form, the taped
        K1 f32 and K6 f32's recomputed P the exact one, K6 f32 there
        against its plain version.
    The save mode f32's and K2 f32's launches by device ms (torch.profiler)
    beside each launch's bound at every shape; (in `run_deferred`'s
    process) one save mode f32, one K5 f32 and one K2 f32 call (stage 2,
    shifted) with only the port's kernels.  Per training step into
    `res`."""
    import torch

    from lavt_rs_tpu_torch.ops import fused_msa as fm
    from lavt_rs_tpu_torch.ops.ln import layer_norm_rows_plain
    from lavt_rs_tpu_torch.ops.window import (relative_bias_from_table,
                                              relative_position_index_2d,
                                              shift_mask_2d,
                                              shift_mask_flags_2d)

    g = torch.Generator(device=dev).manual_seed(SEED + 70)
    sc = 32 ** -0.5
    index = torch.from_numpy(relative_position_index_2d(12, 12)).to(dev)

    def rnd(shape, std=1.0):
        return torch.randn(shape, generator=g, device=dev) * std

    def check(name, got, want):
        return compare(name, got, want, F32_TOL)

    def check_saved(name, got, want):
        err = check(name, got[0], want[0])
        for part, a, b in zip(("q", "k", "v", "p", "xn"), got[1], want[1]):
            if (a is None) != (b is None):
                raise RuntimeError(f"{name}: {part} missing")
            if a is not None:
                err = max(err, check(f"{name} {part}", a, b))
        return err

    def ref64(xin, w, bias, mask, heads, gy):
        return f64_grads(lambda *t: msa_chain(
            *t, None if mask is None else mask.double(), heads, sc),
            (xin, *w, bias), gy)

    def inputs(b, side, c, heads, ln, bias_std=1.0):
        hp = -(-side // 12) * 12
        nw = (hp // 12) ** 2
        x = rnd((b, nw, 144, c), 2.0 if ln else 1.0) + (0.5 if ln else 0.0)
        w = (rnd((3 * c, c), c ** -0.5), rnd((3 * c,), 0.2),
             rnd((c, c), c ** -0.5), rnd((c,), 0.2))
        bias = relative_bias_from_table(rnd((23 * 23, heads), bias_std),
                                        index)
        lnp = (rnd((c,), 0.2) + 1.0, rnd((c,), 0.2)) if ln else None
        return hp, nw, x, w, bias, lnp

    def masks(hp, shift):
        return ((shift_mask_2d(hp, hp, 12, 6, dev),
                 shift_mask_flags_2d(hp, hp, 12, 6, dev)) if shift
                else (None, None))

    def k6_case(name, what, calls, x, lnp, w, bias, mask, flags, heads, gy):
        b, nw, _, c = x.shape
        tail = (*w, bias, mask)

        lo = (fm.tf32_lo(w[0]), fm.tf32_lo(w[2]))  # as the model keeps them

        def k6():
            return fm.fused_window_msa_bwd_recompute(x, lnp, *tail, gy, heads,
                                                     sc, flags=flags, wlo=lo)

        lib, _ = msa_bwd_yardstick(f"{name} {what}",
                                   (x, *w, bias) + tuple(lnp or ()), gy, mask,
                                   heads, sc, forward=True)
        xin = x if lnp is None else layer_norm_rows_plain(x, *lnp)
        measure(res, name, what, calls, k6,
                lambda: fm.fused_window_msa_bwd_recompute_plain(
                    x, lnp, *tail, gy, heads, sc), lib,
                msa_work(b, nw, c, heads, "recompute", ln=lnp is not None,
                         mask=mask is not None, item=4),
                check_f32_backward(ref64(xin, w, bias, mask, heads, gy), 1),
                peak=PEAK_FLOPS_F32)
        device_per_call(res, name, what, calls, k6)
        log_device_by_kernel(f"{name} {what}", k6)
        del lib

    # -- bs 8: the save mode f32, K5 f32 (stages 2-4), K6 f32 (stage 1)
    for si, (side, c, heads, depth) in enumerate(STAGES):
        ln = si < 2
        hp, nw, x, w, bias, lnp = inputs(BATCH, side, c, heads, ln)
        gy = rnd(x.shape)
        for shift in (False, True):
            mask, flags = masks(hp, shift)
            tail = (*w, bias, mask, heads, sc)
            what = f"stage {si + 1} x{tuple(x.shape)} heads {heads} mask {shift}"
            if si == 0:
                k6_case("K6.f32", what, depth // 2, x, lnp, w, bias, mask,
                        flags, heads, gy)
                continue
            msa_fwd_yardstick(f"save.f32 {what}", x, tail, lnp)
            lo = (fm.tf32_lo(w[0]), fm.tf32_lo(w[2]))  # as the model keeps them

            def save(tail=tail, flags=flags, lo=lo):
                return fm.fused_window_msa_save(x, lnp, *tail, flags=flags,
                                                wlo=lo)

            measure(res, "save.f32", what, depth // 2, save,
                    lambda tail=tail: fm.fused_window_msa_save_plain(
                        x, lnp, *tail),
                    lambda tail=tail: torch_bf16_msa(x, *tail, ln=lnp),
                    msa_work(BATCH, nw, c, heads, "save", ln=ln, mask=shift,
                             item=4), check_saved, peak=PEAK_FLOPS_F32)
            device_per_call(res, "save.f32", what, depth // 2, save)
            f32_launch_line(f"save.f32 launches {what}", save,
                            save_launch_work(BATCH, nw, c, heads, ln,
                                             masked_windows(mask), item=4))
            _, saved = save()
            xin = x if lnp is None else saved[4].view(x.shape)
            resid = saved[:4]

            def k5(xin=xin, resid=resid):
                return fm.fused_window_msa_bwd(xin, gy, w[0], w[2], resid,
                                               heads, sc)

            lib, _ = msa_bwd_yardstick(f"K5.f32 {what}",
                                       (x, *w, bias) + tuple(lnp or ()), gy,
                                       mask, heads, sc)
            measure(res, "K5.f32", what, depth // 2, k5,
                    lambda xin=xin, resid=resid:
                        fm.fused_window_msa_bwd_plain(xin, gy, w[0], w[2],
                                                      resid, heads, sc),
                    lib, msa_work(BATCH, nw, c, heads, "bwd", item=4),
                    check_f32_backward(ref64(xin, w, bias, mask, heads, gy),
                                       1), peak=PEAK_FLOPS_F32)
            check_deterministic(f"K5 f32 {what}", k5)
            device_per_call(res, "K5.f32", what, depth // 2, k5)
            log_device_by_kernel(f"K5.f32 {what}", k5)
            if si == 1 and shift:
                defer(functools.partial(
                    f32_msa_port_check,
                    f"save f32 / K5 f32 / K2 f32 {what}", heads, sc),
                    x, *lnp, *w, bias, mask, flags, gy)
            del saved, resid, xin, lib
        del x, gy
        torch.cuda.empty_cache()

    # -- F7: stage 1's geometry, logits past 80
    hp, nw, x, w, bias, lnp = inputs(BATCH, 120, 128, 4, True, F7_BIAS_STD)
    mask, flags = masks(hp, True)
    tail = (*w, bias, mask, 4, sc)
    clamp = fm.fused_window_msa_ln_plain(x, *lnp, *tail, exact=False)
    exact = fm.fused_window_msa_ln_plain(x, *lnp, *tail)
    gap = (clamp - exact).abs().max().item()
    if not gap > 1e-2:
        raise RuntimeError(f"F7: the logits do not pass 80 (clamp and exact "
                           f"forms differ by {gap:.3g})")
    e_inf = check("K1.f32 F7 inference (clamp)", fm.fused_window_msa_ln(
        x, *lnp, *tail, flags=flags), clamp)
    e_tap = check("K1.f32 F7 taped (exact)", fm.fused_window_msa_ln(
        x, *lnp, *tail, flags=flags, exact=True), exact)
    _, saved = fm.attn_launches(x, lnp, w[0], w[1], bias, mask, 4, sc,
                                flags=flags)
    _, want = fm.fused_window_msa_save_plain(x, lnp, *tail)
    e_p = check("K6.f32 F7 recomputed P", saved[3], want[3])
    del saved, want
    gy = rnd(x.shape)
    got = fm.fused_window_msa_bwd_recompute(x, lnp, *tail[:6], gy, 4, sc,
                                            flags=flags)
    plain = fm.fused_window_msa_bwd_recompute_plain(x, lnp, *tail[:6], gy, 4,
                                                    sc)
    e_dx = check("K6.f32 F7 dx", got[0], plain[0])
    log(f"F7 (logits past 80, bias std {F7_BIAS_STD}, x{tuple(x.shape)}): "
        f"clamp and exact forms differ by {gap:.4g}; K1 f32 at inference "
        f"against the clamp plain version {e_inf:.3g}, taped against the "
        f"exact one {e_tap:.3g}; K6 f32's recomputed P against the exact "
        f"P {e_p:.3g}, its dx {e_dx:.3g} (limit {F32_TOL} abs + rel)")
    del x, gy, got, plain, clamp, exact
    torch.cuda.empty_cache()

    # -- bs 20: K6 f32 at every stage, K2 f32 (taped, exact) at stages 3-4
    for si, (side, c, heads, depth) in enumerate(STAGES):
        ln = si < 2
        hp, nw, x, w, bias, lnp = inputs(BATCH_F32_BIG, side, c, heads, ln)
        gy = rnd(x.shape)
        for shift in (False, True):
            mask, flags = masks(hp, shift)
            tail = (*w, bias, mask, heads, sc)
            what = f"stage {si + 1} x{tuple(x.shape)} heads {heads} mask {shift}"
            k6_case("K6.f32/bs20", what, depth // 2, x, lnp, w, bias, mask,
                    flags, heads, gy)
            if ln:
                continue

            lo = (fm.tf32_lo(w[0]), fm.tf32_lo(w[2]))  # as the model keeps them

            def k2(tail=tail, flags=flags, lo=lo):
                return fm.fused_window_msa(x, *tail, flags=flags, exact=True,
                                           wlo=lo)

            lib, _ = msa_fwd_yardstick(f"K2.f32 {what}", x, tail, None)
            measure(res, "K2.f32", what, depth // 2, k2,
                    lambda tail=tail: fm.fused_window_msa_plain(x, *tail),
                    lib, msa_work(BATCH_F32_BIG, nw, c, heads, "fwd",
                                  mask=shift, item=4), check,
                    peak=PEAK_FLOPS_F32)
            device_per_call(res, "K2.f32", what, depth // 2, k2)
            f32_launch_line(f"K2.f32 launches {what}", k2,
                            save_launch_work(BATCH_F32_BIG, nw, c, heads,
                                             False, masked_windows(mask),
                                             save=False, item=4))
            e = check("K2.f32 clamp form", fm.fused_window_msa(
                x, *tail, flags=flags), fm.fused_window_msa_plain(
                    x, *tail, exact=False))
            log(f"K2.f32 {what}: the clamp form (JAX fused_window_msa) "
                f"against its plain version, max abs err {e:.3g}")
            del lib
        del x, gy
        torch.cuda.empty_cache()
    for key in F32_W12_TRAIN_NAMES:
        r = res.r[key]
        per = f"bs-{BATCH_F32_BIG}" if key in ("K6.f32/bs20", "K2.f32") \
            else f"bs-{BATCH}"
        log(f"{key} per window-12 {per} f32 train step: kernel "
            f"{r['ms']:.3f} ms (on the device, launches queued: "
            f"{r['device']:.3f} ms), bound {r['bound']:.3f} ms "
            f"({res.bound_by(key)}), plain (f32) {r['plain']:.3f} ms, "
            f"library (f32, TF32 off) {r['lib']:.3f} ms{ffma_design(key)}")


def f32_big_step(dev, card, weights):
    """One window-12 f32 AdamW step at bs BATCH_F32_BIG with
    --use_checkpoint (`train.step.make_train_step`), where every block
    recomputes: its launches equal F32_W12_BIG_PER_STEP (K1 f32 / K2 f32
    taped, K6 f32 in every block, no K5), its loss finite; host ms and
    peak device memory printed; then its gate against the plain f32 route
    with --use_checkpoint (`f32_training_gate`).  Returns the launches."""
    import gc

    import torch

    from lavt_rs_tpu_torch.config import lavt_one_base

    cfg = lavt_one_base(dtype="float32").replace(use_checkpoint=True)
    g = torch.Generator(device=dev).manual_seed(SEED + 29)
    batch = train_batch(dev, g, BATCH_F32_BIG)
    step = train_setup(dev, weights, cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    out = step(batch, torch.Generator(device=dev).manual_seed(SEED + 3))
    loss = out["loss"].item()
    ms = (time.perf_counter() - t0) * 1e3
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"window-12 f32 train step bs {BATCH_F32_BIG} --use_checkpoint: loss "
        f"{loss:.6f}, {ms:.1f} ms (one step, host clock, the first at this "
        f"batch), peak device memory {peak:.2f} GiB; launches "
        f"{nonzero_counts(launches)}  [{card}]")
    if not math.isfinite(loss):
        raise RuntimeError("window-12 f32 bs-20 step: non-finite loss")
    check_counts("window-12 f32 bs-20 step", launches, F32_W12_BIG_PER_STEP,
                 1)
    del step, out
    gc.collect()
    torch.cuda.empty_cache()
    f32_training_gate(dev, weights, cfg, batch, F32_W12_BIG_PER_STEP, 24,
                      f"window-12 f32 bs-{BATCH_F32_BIG} gate "
                      "(--use_checkpoint)")
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
    """Nothing is left to refuse: every plan has its f32 variants
    (`kernels_without_variant` is [] for window-12 and window-7 training),
    and window-12 f32 training builds on the card (phase 6c trains it).
    The refusal stays as the guard for a kernel added without its f32
    variant: with K5's taken out of `factory.F32_KERNELS` for the check,
    `build_model` refuses window-12 training, naming K5, before it
    allocates a weight or launches a kernel."""
    import gc

    import torch

    from lavt_rs_tpu_torch.config import lavt_one_base
    from lavt_rs_tpu_torch.models import factory

    w12 = lavt_one_base(dtype="float32")
    for what, cfg in (("window-12 training", w12),
                      ("window-7 training", lavt_one_base(
                          window12=False, dtype="float32"))):
        missing = factory.kernels_without_variant(cfg, True)
        if missing:
            raise RuntimeError(f"f32 {what} lacks the variants {missing}")
    model = factory.build_model(w12, dev, train=True)
    log(f"f32 + kernels on the card, window-12 training: nothing to refuse, "
        f"the model builds ({sum(p.numel() for p in model.parameters())} "
        f"parameters)")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    have = factory.F32_KERNELS
    factory.F32_KERNELS = have - {"K5"}
    try:
        missing = factory.kernels_without_variant(w12, True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        allocated = torch.cuda.memory_allocated(dev)
        zero_counts()
        try:
            factory.build_model(w12, dev, train=True)
        except NotImplementedError as e:
            message = str(e)
        else:
            raise RuntimeError("the f32 guard did not refuse a plan whose K5 "
                               "had no f32 variant")
    finally:
        factory.F32_KERNELS = have
    if missing != ["K5"] or "launches K5," not in message:
        raise RuntimeError(f"the f32 guard names {missing}: {message}")
    launched = {k: v for k, v in read_counts().items() if v}
    peak = torch.cuda.max_memory_allocated(dev)
    if launched or peak != allocated:
        raise RuntimeError(f"the f32 guard came after work: launches "
                           f"{launched}, {peak - allocated} B allocated")
    log(f"the f32 guard (K5's variant taken away for the check): refused "
        f"before any launch or allocation: {message}")


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
# variants (the 3xTF32 wgmma core's instances, the f32 MSA attention's,
# K2p f32's attention, K4b f32's at the stage widths)
# -- data parallelism: DDP on two processes sharing the card ----------------------

def ddp_config(dtype):
    """lavt_one_base (Swin-B window 12, 480²) in `dtype` for the
    data-parallel check, with DropPath and BERT's dropouts 0: the world-1
    and world-2 steps then draw nothing and compute the same function.
    Its weights are made `meaningful`: without that, PWAM's InstanceNorm
    divides by a near-zero spread and the logits of one image move by
    ~1 in bf16 (3e-3 in f32, plain route) between a batch of 8 and one of
    4 on one card, where GEMMs tile the rows differently."""
    import dataclasses

    from lavt_rs_tpu_torch.config import lavt_one_base

    cfg = lavt_one_base(dtype=dtype)
    return cfg.replace(
        swin=dataclasses.replace(cfg.swin, drop_path_rate=0.0),
        bert=dataclasses.replace(cfg.bert, hidden_dropout=0.0,
                                 attn_dropout=0.0))


def ddp_step_counts(cfg, batch):
    """One training step's launches of `cfg` at `batch` images, as the
    counters read them: the plan's (bf16) or its f32 counters'."""
    if cfg.dtype == "float32":
        return f32_step_counts(cfg, batch)
    return nonzero_counts(kernel_plan(cfg, 480, batch, True)[0])


def ddp_step(dev, cfg, batch, rank=None):
    """The first training step of `cfg` from its seeded init on `batch` (in
    DDP with the cross-process BatchNorm when `rank` is given, on that
    rank's DDP_BATCH of the joint batch), then DDP_TIMED_STEPS more, each
    timed by the host clock around a synchronized step.  Returns (the
    first step's loss (the global batch's under DDP), its launches, its
    Swin blocks' gradients on the host (after DDP's all_reduce), the
    decoder BatchNorms' running statistics after it, the timed steps' ms)."""
    import torch

    from lavt_rs_tpu_torch.models.factory import build_model
    from lavt_rs_tpu_torch.parallel.ddp import convert_sync_bn, wrap_ddp
    from lavt_rs_tpu_torch.train.optim import TrainConfig
    from lavt_rs_tpu_torch.train.step import (create_train_state,
                                              make_train_step)

    g = torch.Generator(device=dev).manual_seed(SEED + 50)
    model = meaningful(build_model(cfg, dev, train=True, generator=g), dev, g)
    trained = model
    if rank is not None:
        convert_sync_bn(model)
        part = slice(rank * DDP_BATCH, (rank + 1) * DDP_BATCH)
        batch = {k: v[part] for k, v in batch.items()}
        trained = wrap_ddp(model, dev)
    tcfg = TrainConfig()
    opt, sched = create_train_state(model, tcfg)
    step = make_train_step(trained, opt, sched, tcfg)

    def gen():
        return torch.Generator(device=dev).manual_seed(SEED + 51)

    zero_counts()
    loss = step(batch, gen())["loss"].item()
    torch.cuda.synchronize()
    launches = nonzero_counts(read_counts())
    grads = {n: p.grad.float().cpu() for n, p in model.named_parameters()
             if p.grad is not None and ".blocks." in n}
    bn = {n: b.float().cpu() for n, b in model.classifier.named_buffers()
          if "running_" in n}
    ms = []
    for _ in range(DDP_TIMED_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(batch, gen())
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    del step, opt, sched, trained, model
    gc_cuda()
    return loss, launches, grads, bn, ms


def ddp_cli_argv(tmp, dev):
    """The RefCOCO train CLI at the published configuration (--window12,
    Swin-B, 480², bf16) on the synthetic split under tmp/data, -b
    DDP_BATCH a process, the val split evaluated every second epoch."""
    root = os.path.join(tmp, "data")
    return ["--window12", "--img_size", "480", "--refer_data_root", root,
            "--dataset", "refcoco", "--splitBy", "unc", "--vocab",
            os.path.join(root, "vocab.txt"), "--device", str(dev), "-b",
            str(DDP_BATCH), "-j", "2", "--split", "train", "--val_split",
            "val", "--eval_every", "2", "--print-freq", "1"]


def ddp_cli_rank(dev, tmp):
    """`cli.train.main` in this process's group: two epochs into
    tmp/ckpt.  Returns the train items this rank read, in order (its
    dataset wrapped to record them), the record's checkpoint and the
    run's seconds."""
    from lavt_rs_tpu_torch.cli import train as cli_train

    seen = []
    datasets = cli_train.refcoco_datasets

    class Recorded:
        def __init__(self, ds):
            self.ds = ds

        def __len__(self):
            return len(self.ds)

        def __getitem__(self, i):
            seen.append(int(i))
            return self.ds[i]

    def recorded(args):
        train_ds, val_ds = datasets(args)
        return Recorded(train_ds), val_ds

    cli_train.refcoco_datasets = recorded
    t0 = time.perf_counter()
    rec = cli_train.main(ddp_cli_argv(tmp, dev) + [
        "--epochs", "2", "--output-dir", os.path.join(tmp, "ckpt")])
    return {"seen": seen, "checkpoint": rec["checkpoint"],
            "seconds": time.perf_counter() - t0,
            "step_s": rec["logger"].iter_time.global_avg}


def ddp_rank(rank, tmp):
    """Process `rank` of DDP_WORLD sharing cuda:0 in a gloo group (a
    file:// rendezvous under `tmp`; NCCL takes one process a card): the
    bf16 and f32 first steps on its share of tmp/batch.pt (rank 0 writes
    the blocks' gradients to tmp), then the train CLI in the group; its
    results to tmp/rank<rank>.pt."""
    import datetime

    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous",
                            rank=rank, world_size=DDP_WORLD,
                            timeout=datetime.timedelta(minutes=10))
    try:
        batch = {k: v.to(dev) for k, v in torch.load(
            os.path.join(tmp, "batch.pt")).items()}
        out = {}
        for dtype in ("bfloat16", "float32"):
            loss, launches, grads, bn, ms = ddp_step(dev, ddp_config(dtype),
                                                     batch, rank)
            if rank == 0:
                torch.save(grads, os.path.join(tmp, f"grads_{dtype}.pt"))
            del grads
            out[dtype] = {"loss": loss, "launches": launches, "bn": bn,
                          "ms": ms}
        out["cli"] = ddp_cli_rank(dev, tmp)
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def data_parallel_phase(dev, card):
    """Data parallelism on the one card: DDP_WORLD processes sharing
    cuda:0 under gloo (`ddp_rank`), against one process.
      * lavt_one Swin-B window 12 480² (`ddp_config`: DropPath and dropout
        0) in bf16 and in f32 with the kernels: the first step at
        DDP_BATCH a rank against the world-1 step on the joint batch from
        the same seeded init: the loss (DDP_GATES: bf16 1e-2, f32 1e-4
        relative); in f32 each Swin block's all-reduced gradient cosine
        (0.999) and the decoder BatchNorms' running statistics (1e-4 of
        their largest magnitude), in bf16 both printed (DDP_GATES says
        why); each rank's launches equal the plan
        at DDP_BATCH, the world-1 step's at the joint batch; the timed
        steps' ms at world 1 and world 2 (two processes on one card and
        gloo's all_reduce through the host: the cost of the collectives,
        not a speed-up);
      * `cli.train.main` at world 2 for two epochs on the synthetic split:
        each epoch's shards disjoint and TRAIN_REFS / DDP_WORLD long, the
        checkpoints written by rank 0 alone, with no `module.` key, and a
        one-process --resume of the directory trains an epoch.
    Any child's failure fails the phase."""
    import argparse
    import tempfile

    import numpy as np
    import torch
    import torch.multiprocessing as mp

    from lavt_rs_tpu_torch.cli import train as cli_train
    from lavt_rs_tpu_torch.train import checkpoint as ckpt

    t_phase = time.perf_counter()
    joint = DDP_WORLD * DDP_BATCH
    with tempfile.TemporaryDirectory() as tmp:
        batch = train_batch(dev, torch.Generator(device=dev).manual_seed(
            SEED + 52), joint)
        torch.save({k: v.cpu() for k, v in batch.items()},
                   os.path.join(tmp, "batch.pt"))
        write_refcoco(os.path.join(tmp, "data"),
                      np.random.default_rng(SEED + 30))
        world1 = {}
        for dtype in ("bfloat16", "float32"):
            cfg = ddp_config(dtype)
            loss, launches, grads, bn, ms = ddp_step(dev, cfg, batch)
            want = ddp_step_counts(cfg, joint)
            if launches != want:
                raise RuntimeError(f"data parallel, world 1 {dtype}: "
                                   f"launches {launches}, plan {want}")
            world1[dtype] = (loss, grads, bn, ms)
        del batch
        gc_cuda()
        t0 = time.perf_counter()
        ctx = mp.spawn(ddp_rank, args=(tmp,), nprocs=DDP_WORLD, join=False)
        deadline = time.monotonic() + DDP_LIMIT_S
        while not ctx.join(timeout=10):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise RuntimeError(f"data parallel: the {DDP_WORLD} "
                                   f"processes did not end in {DDP_LIMIT_S} s")
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"))
                 for r in range(DDP_WORLD)]
        log(f"data parallel: {DDP_WORLD} processes on cuda:0 under gloo "
            f"ended in {time.perf_counter() - t0:.1f} s")
        for dtype in ("bfloat16", "float32"):
            loss1, grads1, bn1, ms1 = world1[dtype]
            rtol, min_cos, bn_tol = DDP_GATES[dtype]
            got = [r[dtype] for r in ranks]
            want = ddp_step_counts(ddp_config(dtype), DDP_BATCH)
            for r, g in enumerate(got):
                if g["launches"] != want:
                    raise RuntimeError(f"data parallel {dtype} rank {r}: "
                                       f"launches {g['launches']}, plan "
                                       f"{want}")
            if len({g["loss"] for g in got}) != 1:
                raise RuntimeError(f"data parallel {dtype}: the ranks' "
                                   f"losses differ: {[g['loss'] for g in got]}")
            rel = abs(got[0]["loss"] - loss1) / abs(loss1)
            # in f64: an f32 dot of a block's ~3.5M host values errs ~1e-4
            cos = block_cosines(
                {k: v.double() for k, v in torch.load(os.path.join(
                    tmp, f"grads_{dtype}.pt")).items()},
                {k: v.double() for k, v in grads1.items()})
            worst = min(cos, key=cos.get)
            bn_err = max((got[r]["bn"][k] - v).abs().max().item()
                         / v.abs().max().item()
                         for r in range(DDP_WORLD) for k, v in bn1.items())
            ms2 = [m for g in got for m in g["ms"]]
            log(f"data parallel {dtype}, Swin-B w12 480²: world 2 x bs "
                f"{DDP_BATCH} vs world 1 bs {joint} on the joint batch: loss "
                f"{got[0]['loss']:.8f} vs {loss1:.8f}, rel diff {rel:.3g} "
                f"(limit {rtol}); {len(cos)} Swin blocks, worst all-reduced "
                f"gradient cosine {cos[worst]:.7f} ({worst}, limit "
                f"{min_cos or 'none: printed'}), mean "
                f"{sum(cos.values()) / len(cos):.7f}; decoder BN running "
                f"statistics max rel diff {bn_err:.3g} (limit "
                f"{bn_tol or 'none: printed'}); launches a rank "
                f"{got[0]['launches']} (the plan at bs {DDP_BATCH})")
            log(f"data parallel {dtype} step ms (host clock, synchronized, "
                f"{DDP_TIMED_STEPS} steps after the first): world 1 bs "
                f"{joint} {[round(m, 1) for m in ms1]}; world 2 bs "
                f"{DDP_BATCH} a rank, two processes sharing the card, gloo's "
                f"all_reduce through the host {[round(m, 1) for m in ms2]}  "
                f"[{card}]")
            if len(cos) != 24 or rel > rtol or min_cos is not None and (
                    cos[worst] < min_cos or bn_err > bn_tol):
                raise RuntimeError(f"data parallel {dtype}: the world-2 step "
                                   "fails its gate against the world-1 step")
        cli = [r["cli"] for r in ranks]
        per_epoch = TRAIN_REFS // DDP_WORLD // DDP_BATCH * DDP_BATCH
        for c in cli:
            if len(c["seen"]) != 2 * per_epoch:
                raise RuntimeError(f"data parallel CLI: a rank read "
                                   f"{len(c['seen'])} train items, want "
                                   f"{2 * per_epoch}")
        for e in (0, 1):
            shards = [set(c["seen"][e * per_epoch:(e + 1) * per_epoch])
                      for c in cli]
            if any(len(s) != per_epoch for s in shards) or \
                    set.intersection(*shards):
                raise RuntimeError(f"data parallel CLI epoch {e}: shards "
                                   f"{shards} not disjoint sets of "
                                   f"{per_epoch}")
        out = os.path.join(tmp, "ckpt")
        files = [p for _, p in ckpt.list_checkpoints(out)]
        if len(files) != 2 or cli[0]["checkpoint"] != files[-1] or any(
                c["checkpoint"] is not None for c in cli[1:]):
            raise RuntimeError(f"data parallel CLI: checkpoints {files}, "
                               f"the ranks' records "
                               f"{[c['checkpoint'] for c in cli]}")
        with torch.serialization.safe_globals([argparse.Namespace]):
            keys = torch.load(files[-1], map_location="cpu", mmap=True,
                              weights_only=True)["model"].keys()
        if any(k.startswith("module.") for k in keys):
            raise RuntimeError("data parallel CLI: `module.` keys saved")
        t0 = time.perf_counter()
        rec = cli_train.main(ddp_cli_argv(tmp, dev) + [
            "--epochs", "3", "--resume", out, "--output-dir", ""])
        loss = rec["logger"].loss.global_avg
        if rec["start_epoch"] != 2 or not math.isfinite(loss):
            raise RuntimeError(f"data parallel CLI: the world-1 resume "
                               f"started at {rec['start_epoch']}, loss {loss}")
        log(f"data parallel CLI (Swin-B w12 480² bf16, -b {DDP_BATCH} a "
            f"process): world 2, two epochs of {TRAIN_REFS // joint} steps "
            f"in {[round(c['seconds'], 1) for c in cli]} s, "
            f"{[round(c['step_s'], 3) for c in cli]} s a step (two "
            f"processes sharing the card); shards of {per_epoch} items "
            f"disjoint each epoch; checkpoints {[os.path.basename(p) for p in files]} "
            f"from rank 0 only, no `module.` keys; the world-1 --resume "
            f"epoch 2: {TRAIN_REFS // DDP_BATCH} steps in "
            f"{time.perf_counter() - t0:.1f} s, loss {loss:.5f}  [{card}]")
    gc_cuda()
    log(f"data parallel phase: {time.perf_counter() - t_phase:.1f} s")


# -- the hybrid 2D-Swin video model: --ytvos_2d_swin_3d_pwam / _pwam ------------

def hybrid_config(flag, no_bf16=False):
    """The A2D recipe's lavt_video_tiny with a hybrid flag, as the CLIs
    build it (`model_config_from_args`)."""
    from lavt_rs_tpu_torch.cli import args as cli_args
    from lavt_rs_tpu_torch.cli import train as cli_train

    argv = list(VIDEO_RECIPE) + [flag, "--img_size", str(CLI_IMG)]
    return cli_args.model_config_from_args(cli_train.get_parser().parse_args(
        argv + (["--no_bf16"] if no_bf16 else [])))


def hybrid_forwards(dev, card, flag, model, reqs):
    """One clip through the bf16 and f32 kernel routes of the hybrid model
    and through the plain f32 route (`clip_forwards`: launches per clip
    HYBRID_PER_CLIP)."""
    clip_forwards(dev, card, f"hybrid {flag}", model, reqs, HYBRID_PER_CLIP)


def clip_forwards(dev, card, what, model, reqs, per_clip, iters=5):
    """One clip through the bf16 and f32 kernel routes of a video model
    and through the plain f32 route (launches per clip `per_clip`, the
    pixel gate and the f32 gate on all 8 frames, each route's peak
    memory over its first call), then ms per clip (each route the mean
    of `iters` calls after one warm-up) and a profile of the bf16 clip."""
    import torch

    from lavt_rs_tpu_torch.models.factory import build_model
    from lavt_rs_tpu_torch.ops.norm import maybe_normalize_image

    cfg = model.cfg
    video_u8, ids, mask, _, _ = reqs
    clip = maybe_normalize_image(video_u8)[None]
    models = {"bf16": model}
    for name, over in (("f32", dict(dtype="float32")),
                       ("plain f32", dict(dtype="float32",
                                          use_kernels=False))):
        models[name] = build_model(cfg.replace(**over), dev)
        models[name].load_state_dict(model.state_dict())
    logits, ms, peak = {}, {}, {}
    for name, m in models.items():
        zero_counts()
        torch.cuda.reset_peak_memory_stats(dev)
        with torch.no_grad():
            logits[name] = m(clip, ids[None], mask[None])
        torch.cuda.synchronize()
        peak[name] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        launches = nonzero_counts(read_counts())
        want = ({} if name == "plain f32" else
                {k + (".f32" if name == "f32" else ""): n
                 for k, n in per_clip.items()})
        if launches != want:
            raise RuntimeError(f"{what} {name}: launches {launches}, "
                               f"want {want}")
        with torch.no_grad():
            ms[name] = cuda_time_ms(lambda: m(clip, ids[None], mask[None]),
                                    iters=iters, warmup=1)
    want = logits["plain f32"]
    agree = gate_pixels(f"{what} bf16", logits["bf16"], want,
                        (FRAMES, 480, 480, 2))
    f32_gate(f"{what} f32 clip", logits["f32"], want)
    log(f"{what} clip (8 frames 480², launches {per_clip}): "
        f"bf16 kernels vs f32 plain route max |dlogit| "
        f"{(logits['bf16'] - want).abs().max().item():.4g}, argmax agreement "
        f"{agree:.5f} on all frames (margin > {MARGIN}); ms per clip: bf16 "
        f"{ms['bf16']:.3f}, f32 {ms['f32']:.3f}, plain f32 "
        f"{ms['plain f32']:.3f} (mean of {iters}); peak GiB (the three "
        f"models' weights included): bf16 {peak['bf16']:.3f}, f32 "
        f"{peak['f32']:.3f}, plain f32 {peak['plain f32']:.3f}  [{card}]")
    with torch.no_grad():
        profile_clip(lambda: model(clip, ids[None], mask[None]), card,
                     f"{what} bf16 clip")
    del models, logits
    gc_cuda()


def hybrid_steps(dev, card, flag, weights):
    """The train step of the hybrid model: the bf16 gate against the plain
    f32 step (language gates 0, BN running statistics, DropPath and
    dropout on: loss LOSS_RTOL, each of the 12 2D blocks' cosine MIN_COS;
    launches HYBRID_TRAIN_PER_STEP), the f32 gate (`f32_training_gate`),
    and the bf16 step's ms over DDP_TIMED_STEPS steps after a warm-up,
    one under torch.profiler."""
    import torch

    from lavt_rs_tpu_torch.models.factory import build_model
    from lavt_rs_tpu_torch.train.optim import TrainConfig
    from lavt_rs_tpu_torch.train.step import (create_train_state,
                                              make_video_train_step)

    cfg = hybrid_config(flag)
    batch = video_train_batch(
        dev, torch.Generator(device=dev).manual_seed(SEED + 61))
    seed = SEED + 62
    zero_gates = {k: torch.zeros_like(v) if ".res_gate." in k else v
                  for k, v in weights.items()}
    ref_loss, ref = gate_run(dev, cfg.replace(use_kernels=False,
                                              dtype="float32"),
                             zero_gates, False, batch, seed)
    zero_counts()
    loss, got = gate_run(dev, cfg, zero_gates, False, batch, seed)
    launches = nonzero_counts(read_counts())
    rel = abs(loss - ref_loss) / abs(ref_loss)
    cos = block_cosines(got, ref)
    worst = min(cos, key=cos.get)
    del got, ref
    log(f"hybrid {flag} training gate (language gates 0, BN running "
        f"statistics, DropPath + dropout on): loss bf16 kernels {loss:.6f}, "
        f"plain f32 {ref_loss:.6f}, rel diff {rel:.3g} (limit {LOSS_RTOL}); "
        f"{len(cos)} 2D blocks, worst gradient cosine {cos[worst]:.5f} "
        f"({worst}, limit {MIN_COS}); launches {launches}")
    if launches != HYBRID_TRAIN_PER_STEP or len(cos) != 12 or \
            rel > LOSS_RTOL or cos[worst] < MIN_COS:
        raise RuntimeError(f"hybrid {flag}: the bf16 training gate failed")
    f32_training_gate(dev, weights, hybrid_config(flag, no_bf16=True), batch,
                      {f"{k}.f32": n for k, n in HYBRID_TRAIN_PER_STEP.items()},
                      12, f"hybrid {flag} f32 training gate")
    gc_cuda()
    model = build_model(cfg, dev, train=True)
    model.load_state_dict(weights)
    tcfg = TrainConfig()
    step = make_video_train_step(model, *create_train_state(model, tcfg), tcfg)

    def gen():
        return torch.Generator(device=dev).manual_seed(seed)

    step(batch, gen())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_time_ms(lambda: step(batch, gen()), iters=DDP_TIMED_STEPS,
                      warmup=0)
    log(f"hybrid {flag} bf16 train step, one 8-frame 480² clip: {ms:.3f} "
        f"ms/step (mean of {DDP_TIMED_STEPS}), peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB  [{card}]")
    profile_clip(lambda: step(batch, gen()), card,
                 f"hybrid {flag} bf16 train step")
    del step, model
    gc_cuda()


def hybrid_pretrained(dev, flag, path, src):
    """--pretrained2d_lavt_weights: the Swin-T window-7 lavt_one file at
    `path` (state dict `src`) into the hybrid model: every tensor but the
    12 relative-position indexes (skipped: the model builds its own) and,
    under the 3D SepTPWAM, the 2D fusion (dropped); the patch embedding
    with a temporal axis of 1, the tables as they are."""
    import argparse

    import torch

    from lavt_rs_tpu_torch.convert import pretrained
    from lavt_rs_tpu_torch.models.factory import build_model

    cfg = hybrid_config(flag)
    model = build_model(cfg, dev, train=True)
    args = argparse.Namespace(**{f: "" for f in (
        "pretrained_swin_weights", "ck_bert",
        "pretrained2d_lavt_weights_for_a_3d_model",
        "pretrained_video_lavt_weights_on_refcocos")})
    args.pretrained2d_lavt_weights = path
    (rec,) = pretrained.apply_pretrained_flags(model, cfg, args)
    keep_fusion = flag == "--ytvos_2d_swin_pwam"
    want = [k for k in src if not k.endswith("relative_position_index")
            and (keep_fusion or ".fusion." not in k)]
    sd = model.state_dict()
    pe, table = ("backbone.patch_embed.proj.weight",
                 "backbone.layers.2.blocks.3.attn.relative_position_bias_table")
    same = (torch.equal(sd[pe][:, :, 0].cpu(), src[pe])
            and torch.equal(sd[table].cpu(), src[table]))
    log(f"hybrid {flag} --pretrained2d_lavt_weights (Swin-T window-7 "
        f"lavt_one .pth): loaded {len(rec['loaded'])} tensors, skipped "
        f"{len(rec['skipped'])}, in {rec['seconds']:.2f} s; patch embedding "
        f"{tuple(sd[pe].shape)}, tables of {sd[table].shape[0]} rows")
    if sorted(rec["loaded"]) != sorted(want) or len(rec["skipped"]) != 12 \
            or not same:
        raise RuntimeError(f"hybrid {flag}: --pretrained2d_lavt_weights "
                           f"loaded {len(rec['loaded'])} tensors, want "
                           f"{len(want)}, or changed them")
    del model
    gc_cuda()


def hybrid_ytvos(dev, card, ckpt):
    """`cli.test_ytvos.main` with --ytvos_2d_swin_3d_pwam on YTVOS_VIDEOS
    (the YTVOS phase's synthetic whole videos) and the hybrid's weights:
    every forward's launches HYBRID_PER_CLIP, a PNG of the original size
    per frame and expression, ms per video."""
    import contextlib
    import io
    import tempfile

    import numpy as np
    import torch

    from lavt_rs_tpu_torch.cli import test_ytvos as cli_ytvos

    with tempfile.TemporaryDirectory() as root:
        vocab = write_ytvos(root, np.random.default_rng(SEED + 41))
        out = os.path.join(root, "out")
        argv = list(VIDEO_RECIPE) + [
            "--ytvos_2d_swin_3d_pwam", "--ytvos_data_root", root, "--vocab",
            vocab, "--img_size", str(CLI_IMG), "--device", str(dev),
            "--checkpoint", ckpt, "--out", out]
        forward, lengths = cli_ytvos.forward_clip, []

        def recorded(model, clip, *a):
            lengths.append(clip.shape[0])
            return forward(model, clip, *a)

        zero_counts()
        cli_ytvos.forward_clip = recorded
        err = io.StringIO()
        try:
            with contextlib.redirect_stderr(err):
                stats = cli_ytvos.main(argv)
        finally:
            cli_ytvos.forward_clip = forward
        torch.cuda.synchronize()
        launches = nonzero_counts(read_counts())
        want = {k: n * len(lengths) for k, n in HYBRID_PER_CLIP.items()}
        masks = read_masks(out)
        sizes = {name: hw for name, _, hw in YTVOS_VIDEOS}
        n_want = sum(n for _, n, _ in YTVOS_VIDEOS) * YTVOS_EXPRESSIONS
        log(f"hybrid YTVOS via cli.test_ytvos --ytvos_2d_swin_3d_pwam: "
            f"{stats['videos']} videos, forwards of {lengths} frames, "
            f"{1e3 * stats['seconds'] / stats['videos']:.1f} ms/video, "
            f"launches {launches}, {len(masks)} PNGs  [{card}]")
        if launches != want or len(masks) != n_want or any(
                m.shape != sizes[k[0]] for k, m in masks.items()):
            raise RuntimeError(f"hybrid YTVOS: launches {launches} (want "
                               f"{want}) or {len(masks)} PNGs (want "
                               f"{n_want}) of the wrong sizes:\n"
                               + err.getvalue()[-2000:])


def balance_head(model, x, ids, mask, name):
    """Shift the family's class-1 logit bias (`FAMILY_HEAD_BIAS`) so that
    the median logit gap (class 1 - class 0) of one forward on (x, ids,
    mask) is 0; where the gap spreads less than FAMILY_GAP_STD (the VLT
    heads: ~0.01), first scale the last conv up to that spread.  Returns
    the two tensors as they were."""
    import torch

    bias = model.get_parameter(FAMILY_HEAD_BIAS[name])
    weight = model.get_parameter(FAMILY_HEAD_BIAS[name][:-4] + "weight")
    before = {FAMILY_HEAD_BIAS[name]: bias.detach().clone(),
              FAMILY_HEAD_BIAS[name][:-4] + "weight": weight.detach().clone()}
    with torch.no_grad():
        logits = model(x, ids, mask)
        gap = (logits[..., 1] - logits[..., 0]).float()
        k = max(1.0, FAMILY_GAP_STD / gap.std().item())
        weight.mul_(k)
        bias.mul_(k)
        bias[1] -= (gap.median() * k).to(bias.dtype)
    return before


def family_forwards(dev, card, name, cfg, per_forward):
    """One family's inference main path at 480², bs 8: seeded weights made
    meaningful (`meaningful`, `balance_head`), N_REQUESTS batches through
    `fwd_iou` in bf16 (launches as `per_forward`, its kernel plan), the
    pixel gate against the plain f32 model, then the f32 model with the
    kernels (the f32 counters as the bf16 plan's) and the f32 gate; ms a
    batch of each, the bf16 forward's device busy and idle share, peak
    memory.  Returns the bf16 weights (on the card), with the head
    balanced and as drawn."""
    import torch

    from lavt_rs_tpu_torch.eval.refcoco_eval import fwd_iou
    from lavt_rs_tpu_torch.models.factory import build_model
    from lavt_rs_tpu_torch.ops.norm import maybe_normalize_image

    window = cfg.swin.window_size
    what = f"{name} window {window}"
    plan = kernel_plan(cfg, 480, BATCH)[0]
    if plan != per_forward:
        raise RuntimeError(f"{what}: the kernel plan gives {plan}, the "
                           f"checked counts are {per_forward}")
    g = torch.Generator(device=dev).manual_seed(SEED + 70)
    model = meaningful(build_model(cfg, dev, generator=g), dev, g)
    batches = requests(dev, g, N_REQUESTS)
    image, ids, mask, _ = batches[0]
    x, ids0, mask0 = maybe_normalize_image(image), ids[:, 0], mask[:, 0]
    head = balance_head(model, x, ids0, mask0, name)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    results = [fwd_iou(model, *b) for b in batches]
    torch.cuda.synchronize()
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    check_counts(f"{what} bf16 inference", launches, per_forward, N_REQUESTS)
    for inter, union in results:
        if inter.shape != (BATCH, 1) or bool((inter > union).any()):
            raise RuntimeError(f"{what}: bad inter/union")

    def forward(m):
        with torch.no_grad():
            return m(x, ids0, mask0)

    got = forward(model)
    ms = cuda_time_ms(lambda: forward(model), iters=10, warmup=2)
    profile_clip(lambda: forward(model), card, f"{what} bs-8 bf16 forward")
    weights = model.state_dict()
    del model
    ref = build_model(cfg.replace(dtype="float32", use_kernels=False), dev)
    ref.load_state_dict(weights)
    want = forward(ref)
    plain_ms = cuda_time_ms(lambda: forward(ref), iters=3, warmup=1)
    del ref
    agree = gate_pixels(f"{what} bf16", got, want, (BATCH, 480, 480, 2))
    sure = (want[..., 1] - want[..., 0]).abs() > MARGIN
    log(f"{what} bf16 launches over {N_REQUESTS} batches of {BATCH}: "
        f"{nonzero_counts(launches)}; against the f32 plain model: max "
        f"|dlogit| {(got - want).abs().max().item():.4g}, argmax agreement "
        f"{agree:.5f} on {sure.float().mean().item():.3f} of pixels (margin "
        f"> {MARGIN}); {ms:.3f} ms a bs-8 forward, "
        f"{BATCH * 1000 / ms:.2f} img/s; the plain f32 model {plain_ms:.3f} "
        f"ms; peak {peak:.3f} GiB over the fwd_iou batches  [{card}]")
    del got
    gc_cuda()
    drawn = dict(weights, **head)
    if window != 12:
        return weights, drawn
    f32 = build_model(cfg.replace(dtype="float32"), dev)
    f32.load_state_dict(weights)
    zero_counts()
    got = forward(f32)
    torch.cuda.synchronize()
    f32_launches = read_counts()
    check_counts(f"{what} f32 inference", f32_launches,
                 {f"{k}.f32": n for k, n in per_forward.items()}, 1)
    f32_ms = cuda_time_ms(lambda: forward(f32), iters=5, warmup=1)
    del f32
    f32_gate(f"{what} f32 gate", got, want)
    log(f"{what} f32 with the kernels: launches a forward "
        f"{nonzero_counts(f32_launches)}; {f32_ms:.3f} ms a bs-8 forward  "
        f"[{card}]")
    del got, want
    gc_cuda()
    return weights, drawn


def family_steps(dev, card, name, cfg, weights):
    """A family's train step at bs FAMILY_STEP_BATCH from `weights`: the
    bf16 step (a first step, then FAMILY_STEPS timed steps: launches as its
    kernel plan, the loss finite and below the first's in one of the last
    three, peak memory) and the f32 step's gate
    (`f32_training_gate`: the f32 launches, loss and block gradients
    against the plain f32 route)."""
    import torch

    what = f"{name} window {cfg.swin.window_size}"
    per_step = kernel_plan(cfg, 480, FAMILY_STEP_BATCH, True)[0]
    step = train_setup(dev, weights, cfg)
    batch = train_batch(dev, torch.Generator(device=dev).manual_seed(
        SEED + 71), FAMILY_STEP_BATCH)

    def gen():
        return torch.Generator(device=dev).manual_seed(SEED + 72)

    first = step(batch, gen())["loss"].item()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    losses = [step(batch, gen())["loss"] for _ in range(FAMILY_STEPS)]
    end.record()
    torch.cuda.synchronize()
    launches = read_counts()
    ms = start.elapsed_time(end) / FAMILY_STEPS
    losses = [first] + [v.item() for v in losses]
    check_counts(f"{what} bf16 step", launches, per_step, FAMILY_STEPS)
    # the first AdamW steps move every weight by ~lr: the loss descends
    # over the steps, not at each (test_zoo_train_step_descends's check)
    if not all(math.isfinite(v) for v in losses) or \
            not min(losses[-3:]) < losses[0]:
        raise RuntimeError(f"{what}: training losses {losses}")
    log(f"{what} bf16 step bs {FAMILY_STEP_BATCH}: launches a step "
        f"{per_step}; {ms:.3f} ms a step, "
        f"{FAMILY_STEP_BATCH * 1000 / ms:.2f} img/s (mean of "
        f"{FAMILY_STEPS}), peak {torch.cuda.max_memory_allocated(dev) / 2 ** 30:.2f} "
        f"GiB; losses {[round(v, 6) for v in losses]}  [{card}]")
    del step
    gc_cuda()
    f32 = cfg.replace(dtype="float32")
    f32_training_gate(dev, weights, f32, batch,
                      f32_step_counts(f32, FAMILY_STEP_BATCH),
                      sum(cfg.swin.depths), f"{what} f32 training gate")
    gc_cuda()


def family_clis(dev, card, root, lavt_weights):
    """The CLIs with --model lavt on a synthetic split under `root`: the
    test CLI from a reference-format two-dict checkpoint {'model',
    'bert_model'} in bf16 (launches per device batch as the bf16 plan's)
    and with --no_bf16 against --no_pallas (`f32_cli`'s tolerance); the
    train CLI for a synthetic epoch (its checkpoint holds the two dicts),
    which the test CLI then loads."""
    import contextlib
    import io

    import numpy as np
    import torch

    from lavt_rs_tpu_torch.cli import test as cli_test
    from lavt_rs_tpu_torch.cli import train as cli_train
    from lavt_rs_tpu_torch.train.checkpoint import (latest_checkpoint,
                                                    load_checkpoint)

    vocab = write_refcoco(root, np.random.default_rng(SEED + 73))
    ckpt = os.path.join(root, "lavt.pth")
    sd = {k: v.float().cpu() for k, v in lavt_weights.items()}
    torch.save({p: {k[len(p) + 1:]: v for k, v in sd.items()
                    if k.startswith(p + ".")} for p in ("model", "bert_model")},
               ckpt)
    argv = ["--model", "lavt", "--window12", "--img_size", "480",
            "--refer_data_root", root, "--dataset", "refcoco", "--splitBy",
            "unc", "--split", "val", "--vocab", vocab, "--device", str(dev)]
    per = FAMILY_PER_FORWARD["lavt"]
    summaries = {}
    for label, extra, counters in (
            ("bf16", [], per),
            ("--no_bf16", ["--no_bf16"],
             {f"{k}.f32": n for k, n in per.items()}),
            ("--no_bf16 --no_pallas", ["--no_bf16", "--no_pallas"], {})):
        err = io.StringIO()
        zero_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(err):
            summaries[label] = cli_test.main(argv + extra
                                             + ["--checkpoint", ckpt])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = nonzero_counts(read_counts())
        batches = launches.get("K4.f32", launches.get("K4", 0)) // per["K4"]
        if counters and (batches < 1 or launches != {
                k: n * batches for k, n in counters.items()}):
            raise RuntimeError(f"cli.test --model lavt {label}: launches "
                               f"{launches}, not {counters} a batch")
        if not counters and launches:
            raise RuntimeError(f"cli.test --model lavt {label}: launched "
                               f"{launches}")
        log(f"cli.test --model lavt {label} (two-dict checkpoint): "
            f"{err.getvalue().strip().splitlines()[-1]}; launches "
            f"{launches} over {batches} device batches; {seconds:.2f} s "
            f"with the model's build  [{card}]")
        gc_cuda()
    check_summaries("cli.test --model lavt --no_bf16",
                    summaries["--no_bf16"], summaries["--no_bf16 --no_pallas"])
    out = os.path.join(root, "lavt_ck")
    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        rec = cli_train.main(["--model", "lavt", "--window12", "--synthetic",
                              "--synthetic_steps", "2", "-b",
                              str(FAMILY_STEP_BATCH), "--epochs", "1",
                              "--output-dir", out, "--device", str(dev)])
    seconds = time.perf_counter() - t0
    saved = load_checkpoint(latest_checkpoint(out), "cpu")
    if set(saved) != {"model", "bert_model", "optimizer", "lr_scheduler",
                      "epoch", "args"}:
        raise RuntimeError(f"cli.train --model lavt saved {sorted(saved)}")
    log(f"cli.train --model lavt --synthetic: an epoch of 2 steps at bs "
        f"{FAMILY_STEP_BATCH} in {seconds:.2f} s (build, steps, the two-dict "
        f"checkpoint), {rec['logger'].iter_time.median:.3f} s a step "
        f"(median); saved {sorted(saved)}  [{card}]")
    del saved
    with contextlib.redirect_stderr(io.StringIO()):
        summary = cli_test.main(argv + ["--resume", out, "--max_items", "8"])
    log(f"cli.test --model lavt --resume <the train CLI's directory>: "
        f"{summary}")
    gc_cuda()


def families_phase(dev, card):
    """The other families at Swin-B 480² (`make_config(name, 'base')`,
    window 12): lavt (LAVTTwo), lts, vlt and lavt_vlt each answer bs-8
    batches in bf16 and f32 (`family_forwards`) and take a bs-4 train step
    in bf16 and f32 (`family_steps`); vlt at window 7 one bs-8 forward;
    then the CLIs with --model lavt (`family_clis`)."""
    import tempfile

    from lavt_rs_tpu_torch.models.factory import make_config

    t_phase = time.perf_counter()
    lavt_weights = None
    for name in FAMILIES:
        cfg = make_config(name, "base", window12=True)
        weights, drawn = family_forwards(dev, card, name, cfg,
                                         FAMILY_PER_FORWARD[name])
        family_steps(dev, card, name, cfg, drawn)
        if name == "lavt":
            lavt_weights = {k: v.cpu() for k, v in weights.items()}
        del weights, drawn
        gc_cuda()
    family_forwards(dev, card, "vlt", make_config("vlt", "base",
                                                  window12=False),
                    FAMILY_W7_PER_FORWARD)
    gc_cuda()
    with tempfile.TemporaryDirectory() as root:
        family_clis(dev, card, root, lavt_weights)
    log(f"families phase: {time.perf_counter() - t_phase:.1f} s")


def hybrid_phase(dev, card):
    """The hybrid 2D-Swin video model (lavt_video_tiny with
    --ytvos_2d_swin_3d_pwam, then --ytvos_2d_swin_pwam; seeded weights made
    meaningful): its plan against HYBRID_PER_CLIP / HYBRID_TRAIN_PER_STEP,
    one 8-frame 480² clip (`hybrid_forwards`), the train step
    (`hybrid_steps`), --pretrained2d_lavt_weights from a Swin-T window-7
    lavt_one file the phase writes (`hybrid_pretrained`), and one YTVOS
    run of the first (`hybrid_ytvos`)."""
    import tempfile

    import torch

    from lavt_rs_tpu_torch.config import lavt_one_tiny
    from lavt_rs_tpu_torch.models.factory import build_model

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        g = torch.Generator(device=dev).manual_seed(SEED + 63)
        src = {k: v.cpu() for k, v in build_model(
            lavt_one_tiny(dtype="float32"), dev,
            generator=g).state_dict().items()}
        path = os.path.join(root, "lavt_one_swin_tiny_window7.pth")
        torch.save({"model": src}, path)
        ckpt = None
        for flag in HYBRID_FLAGS:
            cfg = hybrid_config(flag)
            for train, want in ((False, HYBRID_PER_CLIP),
                                (True, HYBRID_TRAIN_PER_STEP)):
                got = kernel_plan(cfg, 480, FRAMES, train)[0]
                if got != want:
                    raise RuntimeError(f"hybrid {flag}: the kernel plan "
                                       f"gives {got}, the checked counts "
                                       f"are {want}")
            g = torch.Generator(device=dev).manual_seed(SEED + 60)
            model = meaningful(build_model(cfg, dev, generator=g), dev, g)
            hybrid_forwards(dev, card, flag, model, clips(dev, g, 1)[0])
            weights = model.state_dict()
            del model
            if ckpt is None:
                ckpt = video_checkpoint(root, weights)
            hybrid_steps(dev, card, flag, weights)
            hybrid_pretrained(dev, flag, path, src)
            del weights
            gc_cuda()
        hybrid_ytvos(dev, card, ckpt)
    gc_cuda()
    log(f"hybrid phase: {time.perf_counter() - t_phase:.1f} s")


def variant_config(flags, swin=None):
    """lavt_one Swin-B 480² window 12 (`make_config("lavt_one", "base")`)
    with a variant's CLI flags, as the CLIs build it
    (`model_config_from_args`), and `swin`'s fields."""
    import dataclasses

    from lavt_rs_tpu_torch.cli import args as cli_args
    from lavt_rs_tpu_torch.cli import train as cli_train

    cfg = cli_args.model_config_from_args(cli_train.get_parser().parse_args(
        ["--window12", "--img_size", "480", *flags]))
    return cfg.replace(swin=dataclasses.replace(cfg.swin, **(swin or {})))


def variant_step_counts(cfg):
    """The hand counts of a bs-FAMILY_STEP_BATCH window-12 step of `cfg`
    (VARIANT_STEP, less the tails' kernels at drop_rate > 0, three stage
    norms under lazy_pred)."""
    want = dict(VARIANT_STEP)
    if cfg.swin.drop_rate > 0:
        for k in ("K3", "K8", "K7"):
            del want[k]
    if cfg.lazy_pred:
        want["K4"] = want["K4b"] = 3
    return want


def variant_cli(dev, card, root, flags, weights):
    """`cli.test --window12 --no_bf16` with a variant's flags on a
    synthetic split under `root` and the variant's weights as a reference
    .pth, with the kernels (the f32 counters per device batch as the f32
    forward's) and with --no_pallas (no launch): mIoU and oIoU within
    F32_CLI_TOL (`check_summaries`)."""
    import contextlib
    import io

    import numpy as np
    import torch

    from lavt_rs_tpu_torch.cli import test as cli_test

    vocab = write_refcoco(root, np.random.default_rng(SEED + 80))
    ckpt = os.path.join(root, "variant.pth")
    torch.save({"model": {k: v.float().cpu() for k, v in weights.items()}},
               ckpt)
    argv = ["--window12", "--img_size", "480", "--no_bf16",
            "--refer_data_root", root, "--dataset", "refcoco", "--splitBy",
            "unc", "--split", "val", "--vocab", vocab, "--checkpoint", ckpt,
            "--max_items", str(VARIANT_CLI_REFS), "--device", str(dev), *flags]
    per = {f"{k}.f32": n for k, n in kernel_plan(
        variant_config(flags), 480, BATCH)[0].items()}
    summaries = {}
    for label, extra, counters in (("kernels", [], per),
                                   ("--no_pallas", ["--no_pallas"], {})):
        err = io.StringIO()
        zero_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(err):
            summaries[label] = cli_test.main(argv + extra)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = nonzero_counts(read_counts())
        batches = launches.get("K4.f32", 0) // per["K4.f32"] if per else 0
        if launches != {k: n * batches for k, n in counters.items()} or (
                counters and batches < 1):
            raise RuntimeError(f"cli.test {' '.join(flags)} --no_bf16 "
                               f"({label}): launches {launches}, not "
                               f"{counters} a batch")
        log(f"cli.test {' '.join(flags)} --no_bf16 ({label}): "
            f"{err.getvalue().strip().splitlines()[-1]}; launches "
            f"{launches}; {seconds:.2f} s with the model's build  [{card}]")
        gc_cuda()
    check_summaries(f"cli.test {' '.join(flags)} --no_bf16",
                    summaries["kernels"], summaries["--no_pallas"])


def variant_video_step(dev, card, flag, weights):
    """A bf16 train step of lavt_video_tiny with a 3D PWAM kind: a warm-up
    step, then DDP_TIMED_STEPS timed steps on one clip (launches a step
    VIDEO_TRAIN_PER_STEP, finite losses, ms a step, peak memory)."""
    import torch

    from lavt_rs_tpu_torch.models.factory import build_model
    from lavt_rs_tpu_torch.train.optim import TrainConfig
    from lavt_rs_tpu_torch.train.step import (create_train_state,
                                              make_video_train_step)

    model = build_model(variant_video_config(flag), dev, train=True)
    model.load_state_dict(weights)
    tcfg = TrainConfig()
    step = make_video_train_step(model, *create_train_state(model, tcfg), tcfg)
    batch = video_train_batch(
        dev, torch.Generator(device=dev).manual_seed(SEED + 81))

    def gen():
        return torch.Generator(device=dev).manual_seed(SEED + 82)

    first = step(batch, gen())["loss"].item()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    losses = []
    ms = cuda_time_ms(lambda: losses.append(step(batch, gen())["loss"]),
                      iters=DDP_TIMED_STEPS, warmup=0)
    launches = nonzero_counts(read_counts())
    losses = [first] + [v.item() for v in losses]
    check_counts(f"video {flag} bf16 step", read_counts(),
                 VIDEO_TRAIN_PER_STEP, DDP_TIMED_STEPS)
    if not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"video {flag}: training losses {losses}")
    log(f"video {flag} bf16 train step, one 8-frame 480² clip: {ms:.3f} "
        f"ms/step (mean of {DDP_TIMED_STEPS}), launches over them "
        f"{launches}, peak {torch.cuda.max_memory_allocated() / 2**30:.2f} "
        f"GiB; losses {[round(v, 6) for v in losses]}  [{card}]")
    del step, model
    gc_cuda()


def variant_video_config(flag):
    """lavt_video_tiny with the A2D recipe's flags and a 3D PWAM flag, as
    the CLIs build it."""
    from lavt_rs_tpu_torch.cli import args as cli_args
    from lavt_rs_tpu_torch.cli import train as cli_train

    return cli_args.model_config_from_args(cli_train.get_parser().parse_args(
        list(VIDEO_RECIPE) + [flag, "--img_size", str(CLI_IMG)]))


def variants_phase(dev, card):
    """The fusion and decoder variants (VARIANT_GROUPS) at Swin-B 480²
    window 12: each group's plan against the hand counts (K1 4 / K11 20 /
    K3 24 / K4 4 a forward, K4 3 under lazy_pred; VARIANT_STEP a step),
    three bs-8 batches through `fwd_iou` in bf16 and a forward in f32 with
    the kernels, each against the plain f32 model (`family_forwards`: the
    pixel gate, the f32 gate, ms, a profile, peak memory), a bs-4 bf16
    step and the f32 step's gate (`family_steps`); `cli.test --no_bf16`
    against --no_pallas on VARIANT_CLI_GROUP's weights; then the other 3D
    PWAM kinds on lavt_video_tiny (one 8-frame 480² clip each in bf16 and
    f32, `clip_forwards`; a bf16 train step of VARIANT_VIDEO_STEPS)."""
    import tempfile

    import torch

    from lavt_rs_tpu_torch.models.factory import build_model

    t_phase = time.perf_counter()
    cli_weights = None
    for label, flags, swin, step_swin in VARIANT_GROUPS:
        cfg = variant_config(flags, swin)
        per_forward = {"K1": 4, "K11": 20, "K3": 24,
                       "K4": 3 if cfg.lazy_pred else 4}
        step_cfg = variant_config(flags, dict(swin, **step_swin))
        step_plan = kernel_plan(step_cfg, 480, FAMILY_STEP_BATCH, True)[0]
        if step_plan != variant_step_counts(step_cfg):
            raise RuntimeError(f"{label}: the step's plan gives {step_plan}, "
                               f"the hand counts are "
                               f"{variant_step_counts(step_cfg)}")
        t0 = time.perf_counter()
        weights, drawn = family_forwards(dev, card, label, cfg, per_forward)
        family_steps(dev, card, label, step_cfg, drawn)
        if label == VARIANT_CLI_GROUP:
            cli_weights = {k: v.cpu() for k, v in weights.items()}
        del weights, drawn
        gc_cuda()
        log(f"variant {label}: {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as root:
        flags = next(g[1] for g in VARIANT_GROUPS
                     if g[0] == VARIANT_CLI_GROUP)
        variant_cli(dev, card, root, flags, cli_weights)
    del cli_weights
    gc_cuda()
    for flag in VARIANT_VIDEO_FLAGS:
        t0 = time.perf_counter()
        cfg = variant_video_config(flag)
        plan = kernel_plan(cfg, 480, FRAMES)[0]
        if plan != VIDEO_PER_CLIP or kernel_plan(
                cfg, 480, FRAMES, True)[0] != VIDEO_TRAIN_PER_STEP:
            raise RuntimeError(f"video {flag}: the plan gives {plan}")
        g = torch.Generator(device=dev).manual_seed(SEED + 83)
        model = meaningful(build_model(cfg, dev, generator=g), dev, g)
        clip_forwards(dev, card, f"video {flag}", model, clips(dev, g, 1)[0],
                      VIDEO_PER_CLIP, iters=3)
        weights = model.state_dict()
        del model
        if flag in VARIANT_VIDEO_STEPS:
            variant_video_step(dev, card, flag, weights)
        del weights
        gc_cuda()
        log(f"video {flag}: {time.perf_counter() - t0:.1f} s")
    log(f"variants phase: {time.perf_counter() - t_phase:.1f} s")


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
                 "EpiGemmILi0E": "f32 projections (3xTF32 wgmma core, W lo by TMA)",
                 "EpiGemmILi1E": "K3 / K8 f32 fc1 + GELU (3xTF32 wgmma core, W1 lo "
                                 "by TMA)",
                 "EpiGemmILi2E": "K3 / K8 f32 fc2 + residual (3xTF32 wgmma core, "
                                 "W2 lo by TMA)",
                 "mlp_prep_kernelILi1E": "K3 / K8 f32 prep (C = 128) and the lo split",
                 "7EpiDual": "K7 f32 dual GEMM (3xTF32 wgmma core)",
                 "8EpiStoreELb0ELb1E": "K7 f32 dyln, K5 f32 dattn / dx (3xTF32 wgmma "
                                      "core, B transposed by the stagers)",
                 "8EpiStoreELb1ELb1E": "K7 / K5 f32 weight grads (3xTF32 wgmma core)",
                 "transpose_kernel": "K7 f32 W2 transpose and lo parts",
                 "msa_f32_kernelILb0ELb0ELb0E": "K1 / K2 f32 attention (clamp)",
                 "msa_f32_kernelILb0ELb1ELb0E": "K1 / K2 f32 attention (taped, exact)",
                 "msa_f32_kernelILb0ELb1ELb1E": "save-mode f32 attention",
                 "msa_f32_kernelILb1E": "K11 f32 attention (map order)",
                 "rows_f32_kernelILi1EE": "K4 f32 (C = 128)",
                 "window_attn_f32_kernelILb1ELb0E": "K10 f32 (N <= 56)",
                 "window_attn_f32_kernelILb1ELb1E": "K10 save f32 (N <= 56)",
                 "window_attn_f32_kernelILb0ELb0E": "K10 f32 (N > 56)",
                 "window_attn_f32_kernelILb0ELb1E": "K10 save f32 (N > 56)",
                 "k2p_attn_f32_kernel": "K2p f32 attention (wgmma, 3xTF32)",
                 "rows_bwd_f32_kernelILi8ELi4ELi16EE": "K4b f32 (C = 128)",
                 "rows_bwd_f32_kernelILi16ELi4ELi16EE": "K4b f32 (C = 256)",
                 "rows_bwd_f32_kernelILi32ELi4ELi16EE": "K4b f32 (C = 512)",
                 "rows_bwd_f32_kernelILi32ELi8ELi8EE": "K4b f32 (C = 1024)"}


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
        f32_launches, f32_w7_launches = f32_phase(
            dev, card, res, weights, root, vocab, ckpt, batches, sentences)
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

        # -- the f32 video paths: a clip, A2D and YTVOS with --no_bf16 ----------
        f32_video_launches = video_f32(dev, card, video_weights)
        a2d_f32_phase(dev, card, ckpt)
        ytvos_phase(dev, card, ckpt, f32=True)
        log(f"f32 video inference done at "
            f"{time.perf_counter() - t_start:.1f} s")

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
    log(f"video training done at {time.perf_counter() - t_start:.1f} s")
    # -- the f32 video train step ------------------------------------------------
    from lavt_rs_tpu_torch.config import lavt_video_tiny

    video_training_gate_f32(dev, video_weights)
    gc_cuda()
    f32_video_train_launches = video_training(
        dev, card, video_weights, lavt_video_tiny(dtype="float32"),
        F32_VIDEO_TRAIN_PER_STEP, F32_VIDEO_CKPT_PER_STEP, "f32 video")
    del video_weights
    gc_cuda()
    log(f"f32 video training done at {time.perf_counter() - t_start:.1f} s")

    # -- the video train CLI: ref_pseudo_video, refexp, ytvos, joint, f32 ---------
    video_train_cli_phase(dev, card)
    log(f"video train CLI done at {time.perf_counter() - t_start:.1f} s")

    # -- training main path ----------------------------------------------------
    training_gate(dev, weights)
    torch.cuda.empty_cache()
    log(f"gate done at {time.perf_counter() - t_start:.1f} s")
    train_launches, big_launches, step_ms = training(dev, card, weights)
    defer(functools.partial(ln_bwd_step_check, card))
    checkpoint_training(dev, card, weights)
    # kept on the host for the window-12 f32 training phase (6c)
    w12_weights = {k: v.cpu() for k, v in weights.items()}
    del weights
    torch.cuda.empty_cache()
    log(f"training done at {time.perf_counter() - t_start:.1f} s")

    # -- the RefCOCO train CLI: two epochs (a save and a resume), its evals ------
    train_cli_phase(dev, card, step_ms)
    torch.cuda.empty_cache()
    log(f"train CLI done at {time.perf_counter() - t_start:.1f} s")

    # -- window 7: lavt_one_base(window12=False), the CLI's default --------------
    from lavt_rs_tpu_torch.config import lavt_one_tiny
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
    torch.cuda.empty_cache()
    log(f"window 7 done at {time.perf_counter() - t_start:.1f} s")

    # -- 6b. window-7 training in f32: K8 f32, K7 f32, K4b f32 -------------------
    f32_train_kernel_phase(dev, res)
    w7f32 = lavt_one_base(window12=False, dtype="float32")
    plan = {f"{k}.f32": n
            for k, n in kernel_plan(w7f32, 480, BATCH, True)[0].items()}
    if plan != F32_W7_TRAIN_PER_STEP:
        raise RuntimeError(f"window-7 f32 step: the kernel plan at itemsize "
                           f"4 gives {plan}, not {F32_W7_TRAIN_PER_STEP}")
    gc_cuda()
    f32_training_gate(
        dev, w7_weights, w7f32,
        train_batch(dev, torch.Generator(device=dev).manual_seed(SEED + 27),
                    BATCH),
        F32_W7_TRAIN_PER_STEP, 24, "window-7 f32 training gate")
    gc_cuda()
    w7_f32_train, _, _ = training(dev, card, w7_weights, w7f32,
                                  F32_W7_TRAIN_PER_STEP, "window-7 f32 train",
                                  profile=True)
    del w7_weights
    gc_cuda()
    train_cli_f32_phase(dev, card)
    gc_cuda()
    log(f"window-7 f32 training done at {time.perf_counter() - t_start:.1f} s")

    # -- 6c. window-12 training in f32: the save mode f32, K5 f32, K6 f32, K2 f32
    f32_msa_train_kernel_phase(dev, res)
    gc_cuda()
    w12f32 = lavt_one_base(dtype="float32")
    for what, got, want in (
            ("window-12 bs-8 f32 step", f32_step_counts(w12f32, BATCH),
             F32_W12_TRAIN_PER_STEP),
            (f"window-12 bs-{BATCH_F32_BIG} f32 step, --use_checkpoint",
             f32_step_counts(w12f32.replace(use_checkpoint=True),
                             BATCH_F32_BIG), F32_W12_BIG_PER_STEP)):
        if got != want:
            raise RuntimeError(f"{what}: the kernel plan at itemsize 4 gives "
                               f"{got}, not {want}")
    f32_training_gate(
        dev, w12_weights, w12f32,
        train_batch(dev, torch.Generator(device=dev).manual_seed(SEED + 28),
                    BATCH),
        F32_W12_TRAIN_PER_STEP, 24, "window-12 f32 training gate")
    gc_cuda()
    w12_f32_train, _, _ = training(dev, card, w12_weights, w12f32,
                                   F32_W12_TRAIN_PER_STEP,
                                   "window-12 f32 train", profile=True)
    gc_cuda()
    w12_f32_big = f32_big_step(dev, card, w12_weights)
    del w12_weights
    gc_cuda()
    train_cli_f32_phase(dev, card, window12=True)
    gc_cuda()
    log(f"window-12 f32 training done at "
        f"{time.perf_counter() - t_start:.1f} s")

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

    # -- data parallelism (DDP on two processes) and the hybrid video model ----
    data_parallel_phase(dev, card)
    log(f"data parallel done at {time.perf_counter() - t_start:.1f} s")
    hybrid_phase(dev, card)
    log(f"hybrid done at {time.perf_counter() - t_start:.1f} s")
    families_phase(dev, card)
    log(f"families done at {time.perf_counter() - t_start:.1f} s")
    variants_phase(dev, card)
    log(f"variants done at {time.perf_counter() - t_start:.1f} s")

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
    launches.update({k: f32_launches[k] for k in F32_NAMES[:4]})
    launches["K10.f32/w7"] = f32_w7_launches["K10.f32"]
    launches.update({k: f32_video_launches[k] for k in ("K10.f32", "K2p.f32")})
    launches["K10s.f32"] = f32_video_train_launches["K10.f32"]
    launches["K9.f32"] = f32_video_train_launches["K9.f32"]
    # the window-7 main path's K10 (per forward) and K9 (per training step)
    launches["K10/w7"], launches["K9/w7"] = w7_infer["K10"], w7_train["K9"]
    launches.update({k: w7_f32_train[k] for k in F32_TRAIN_NAMES[:3]})
    launches["K10s.f32/w7"] = w7_f32_train["K10.f32"]
    launches["K9.f32/w7"] = w7_f32_train["K9.f32"]
    launches.update({k: w12_f32_train[k] for k in F32_W12_TRAIN_NAMES[:3]})
    launches["K6.f32/bs20"] = w12_f32_big["K6.f32"]
    launches["K2.f32"] = w12_f32_big["K2.f32"]
    SOURCES.update({"K10/w7": SOURCES["K10"], "K9/w7": SOURCES["K9"]})
    REPLACES.update({"K10/w7": REPLACES["K10"], "K9/w7": REPLACES["K9"]})
    kernels = []
    for k in (NAMES + ("K10/w7", "K9/w7") + F32_NAMES + F32_TRAIN_NAMES
              + F32_W12_TRAIN_NAMES):
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
