#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (smpl_nerf_tpu_torch) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card, nvcc (PATH, $CUDA_HOME/bin or /usr/local/cuda/bin) and
the repository checkout around this file. Without a card, or outside the
checkout, it exits non-zero before printing any result. Every training run
passes --number_validation_images=0 except phase 8b's logging run: where
tensorboard imports, `cli.train.train` logs through a SummaryWriter, and its
per-epoch rerenders would add launches to the counts. Phases, each
unguarded, so that any failure exits non-zero:

  1. the card's name and power limit, as nvidia-smi reports them;
  2. build every kernel from smpl_nerf_tpu_torch/csrc/ (one nvcc per source,
     all started together) and print the build seconds and ptxas usage
     (registers, spills, wgmma serialisation), which the kernels line repeats
     per kernel under "ptxas";
  3. each kernel against its plain PyTorch version on the card, at the main
     path's shapes, with CUDA-event times (median of 20) of both and the
     least time the card could take for the same work; A and E also with
     their device time per launch from torch.profiler ("device_ms", beside
     the event time, which includes the wrapper's host time): A (sample_pdf), B
     (fused v2 forward, at 131,072 and 393,216 rows: the coarse and the fine
     call of a 2048-ray batch), D (fused v1 forward, the configs/config.txt
     net with its 621-wide pose prefix, at 131,072 and 262,144 rows, and at
     131,072 rows at in_dim 148 and 84: the append_vertex_locations_to_nerf
     and the prefix-free vertex_sphere nets), C (fused
     v2 backward, seeded cotangent, at 131,072 and 393,216 rows, run twice to
     hold its determinism, with its workspace's peak bytes), E
     (fused expert tiles: seeded sorted-tile plans with padding slots and empty
     trailing tiles at E=8000, L=413,696 and at E_occ=329, L=57,344, D=42,
     H=32, O=4, tile 256, in bf16 and in float32; its headline numbers come
     from phase 10, on the plan of a chunk that the distill path serves) and F
     (relu-matmul at n=131,072, W=256/512/1024, beside the library call
     torch.relu(x @ w)) and G (the vertex attention, against its eager path
     at port_bench's dummy_dynamic.train shapes: 2048 and 4096 rays of 64
     samples over 6,890 vertices, radius 0.15, T = 1e4; twice, bit for bit;
     its bound from port_bench/counts_dynamic.py) and H (the normalised-ReLU
     attention's forward and backward against the eager path under autograd
     at port_bench's image_wise_dynamic.train shapes: 2048 rays of 64 samples
     over the seeded 6,890-vertex body, radius 0.15; twice, bit for bit; the
     share of pairs inside a sphere, H1's and H2's device ms beside the eager
     path's, its bound by operations); A, B and D also at the
     shapes of phase 10b's whole-image 256^2 batch (A at R = 65,536, B at
     12,582,912 rows, D at 8,388,608 rows of 705 floats; timed over 5 calls:
     by_rays / by_rows);
     then A, B, C and D at a culled fine pass's shapes (K =
     711 rays of a 2048-ray batch: K, K*64, K*128 and K*192 rows, none a
     multiple of a tile), under the same bounds, except that C's dX max is
     taken against the float64 gradient of the same rounded forward, on three
     inputs, one of them the card test's case; then B and C on raw rows with a
     conditioning prefix [prefix | xyz | dir] (phase_fused_prefix): the
     config.txt net's 621-wide pose prefix at 131,072 rows and at ODD_K x 128
     rows, the 64-wide vertex embedding and the 18 encoded joint columns at
     131,072 rows, C's dX max on the prefix columns and on the xyz/dir
     columns apart against the float64 gradient, C twice (bit for bit), with
     event and device times, bounds and the plain versions' times (the
     kernels line's "_prefix" entries);
  4. the smpl_nerf render: `cli/render_path` on a 2-view 128x128 circle of a
     full-width configs/arm_angles.txt run (seeded weights, --use_fused_mlp=2,
     --use_pallas=1, 2048-ray batches), with the kernels' launch counts set to
     0 just before and read just after; then the same views through the plain
     path (--use_fused_mlp=0 --use_pallas=0), the pixel difference between
     the two, and ms per view of both; one kernel-path render under
     torch.profiler gives the device time by kernel and the device's busy share;
  5. the culled renders of the same configuration: seeded full-width runs
     whose config sets near/far to enclose the occupancy grid's box from a
     camera at radius 8 (CULL_RADIUS), where the box covers a third of each
     view, so that the grid culls, and whose nets' sigma biases are raised
     by CULL_FINE_SIGMA_BIAS and CULL_COARSE_SIGMA_BIAS; `render_path --fast 1` (cap 0.25) and
     `--fast 2` (the occupancy grid, budget derived from probe counts: below
     the batch, at an odd K), each with its launch counts per batch and per
     grid bake, kernel path against plain path ray by ray, `--fast 1
     --cap_fraction 1` against the full render, the 64^3 grid bake timed
     apart, ms per view of the full, fast and occupancy renders in turns, and
     one profiled kernel-path render of each;
  6. the append render and its culled renders: the same through a full-width
     configs/config.txt (append_smpl_params) run with --run_fine=1
     --use_fused_mlp=1 --use_pallas=1, which goes through A and D; then
     phase 4's render of such a run with --use_fused_mlp=2 --use_pallas=1
     (A, and B on 627-float prefix rows; never D) against the plain path,
     and one profiled render;
  7. training: a seeded arm_angles.txt teacher renders 8 train and 2 val views
     at 64x64 (one arm angle per view), written as transforms.json + PNGs;
     `cli.train.train` then runs 2 epochs of 8 steps (batch 2048, 64+128
     samples, 8x256 nets, bf16) from one seed through the kernel path
     (--use_fused_mlp=2 --use_pallas=1: A, B forward, C backward) and through
     the plain path (0, 0); launch counts (the post-training GIF step's renders
     of the 10 views included), finite and falling losses, the two paths'
     losses per step, inference.gif and the 10 PNGs in the run dir, the saved
     run rendered through `render_path`, ms per step of both paths in turns
     (these runs, and the plain one, with --render_gif=0), and one profiled
     step;
  7a. parallel (the parallel layer at world 1, on phase 7's dataset and
     arm_angles.txt nets, --use_fused_mlp=2 --use_pallas=1): PAR_STEPS steps
     through `cli.train.train` on mesh '1,1' with no process group, then a
     world-1 NCCL group is initialised in-process (file:// rendezvous; its
     seconds, with the first all-reduce) and the same steps run through the
     data-parallel step (global-row draws, the loss share, the gradient and
     loss all-reduces, rank 0's weights broadcast): A's, B's and C's launch
     counts of both runs (equal, and as many as the steps and validation
     batches ask for), the largest loss and weight differences (<= PAR_REL
     relative; the same arithmetic, so 0 is expected), ms per step of both
     (CUDA events, in turns); again with --tensor_parallel=1 (off on a model
     axis of 1: the same losses); `torch.distributed.run --nproc_per_node=1
     train_torch.py --multihost=1 --mesh_shape=1` for TORCHRUN_STEPS steps as a
     subprocess (rank 0's run dir) and `restore_train_state` of that run
     through `broadcast_file`; then sample_parallel_raw2outputs (R=SA_R,
     S=SA_S), pipeline_trunk / pp_render_ray_net (one stage, PP_MICRO
     microbatches, 8x256 float32) and expert_parallel_apply (EP_E experts,
     EP_N tokens, skip ids) against their dense forms (<= PAR_FN_REL of the
     largest value); the group is destroyed at the end;
 8. inference: `cli.inference.inference` (inference_torch.py) on the kernel-path
     training run and its val split at --inf_fast 0, 1 and 2, each with its
     launch counts (one grid bake per val view at 2), scores.json (mse, psnr,
     ssim, rlpips), the PNGs and walking.gif;
 8c. the prefixed nets trained on raw rows: configs/config.txt with
     --run_fine=1 (append_smpl_params, 621-wide prefix, 64 + 64 samples) for
     phase 7's steps through --use_fused_mlp=2 --use_pallas=1 (A, B, C) and
     the plain path from one seed: launch counts, finite and falling losses,
     the losses per step within LOSS_REL, the run through render_path and
     inference_torch (launch counts), ms per step in turns, a profiled step;
 8a. the net variants: `cli.train.train` with --siren 1 on configs/arm_angles.txt
     (8x256, skip 4, 64 + 128 samples, bf16) and with --grid_encoding 1 on
     configs/config.txt with --run_fine=1 (append_smpl_params, 621-wide pose
     prefix; levels 8/16/32/64, F=4, W=64, 3 layers) on phase 7's dataset:
     NET_STEPS steps through the kernel path (--use_pallas=1: kernel A in the
     fine pass; these nets run their own forward) and the plain path
     (--use_pallas=0) from one seed, first losses within LOSS_REL, launch
     counts, bytes per net, an explicit --use_fused_mlp=2 refused naming the
     flag, ms per step in turns, one profiled step; then phase 4's 2-view
     128x128 render through both paths on seeded weights (grid features drawn
     from U(-1, 1)) and one profiled kernel-path render, and for
     the grid run --fast 1 and --fast 2 (launch counts) and --fast 1
     --cap_fraction 1 against the full render;
 8b. the training flags, arm_angles.txt, 2 steps each: --check_nans 1 on finite
     weights trains; from a copy of that run with a NaN in one fine-net
     weight (--load_run) it raises naming that weight; --profile_dir writes
     a Chrome trace that names kernel A (its size printed); a recording
     writer with --number_validation_images 2 gets the scalars, the rerender
     grid (2 x 3 panels of 64x64), the warp cloud and vedo_data, with the
     rerenders' launches counted;
  9. the SMPL-driven families: configs/config.txt runs at full width (8x256
     nets, 64 coarse samples, bf16, sigma noise 1, the 3,120-vertex procedural
     human) on phase 7's dataset, whose transforms.json carries the poses and
     betas. dummy_dynamic through the kernel path (--use_fused_mlp=-1, the
     auto mode: B forward and C backward on rows whose directions differ per
     sample; G, which takes every CUDA attention with no gradient to keep,
     whatever the flags, so its plain path runs G too) and
     append_vertex_locations_to_nerf with --run_fine=1 --use_fused_mlp=1
     --use_pallas=1 (A, and D at in_dim 148), each:
     SMPL_STEPS training steps of 2048 rays with their launch counts, the
     plain path from the same seed (its first loss within LOSS_REL),
     inference_torch on the run (PNGs, walking.gif, scores.json), the val
     views through both paths on the same weights (both nets' sigma bias
     raised by CULL_FINE_SIGMA_BIAS), ms per step and per 128x128 view in
     turns, one profiled step and render, and the device ms of the step's
     LBS and (dummy_dynamic) vertex attention; dummy_dynamic again with
     --images_per_batch 2 (every gathered batch within 2 images); then
     append_vertex_locations_to_nerf again with --use_fused_mlp=2 (A, and B
     and C on rows whose prefix is the 64-wide vertex embedding), the same
     checks, and the embedder's loss gradient, which reaches it only through
     C's prefix columns of dX, held against B's and C's plain versions
     (BWD_DW_REL) and against the plain path (LOSS_REL); then
     image_wise_dynamic for one epoch from the dummy_dynamic run's coarse
     net, frozen: the pose error printed, the arm angles moved, kernel H
     launched;
 10. the generator and the families on its data: `create_dataset_torch`
     (cli.dataset) on the card writes an smpl set and an smpl_nerf set of 10
     views at 64x64 (a circle, ratio 0.8, both arms swept over the views: the
     same cameras and poses) and 2 views of smpl_nerf at 128x128, with seconds
     per image; one smpl image again on the CPU, held to the CPU test's bounds.
     smpl and warp train SMPL_STEPS full-width configs/config.txt steps on the
     smpl set (no kernel: smpl runs the coarse net's plain forward, warp only
     the warp field, whose nets must keep their seeded weights), the first
     step against the port's CPU run on the same seed and batch, ms per step.
     vertex_sphere on the smpl_nerf set, precomputed and with
     --vertex_sphere_in_step=1 --images_per_batch 2: the loader's seconds on
     the card, the kernel path (auto: B and C on the coarse net) and the plain
     path from one seed (launch counts, first losses), inference_torch on the
     val split, the val views through the kernel path and through
     --use_fused_mlp=1 (kernel D at the prefix-free width 84) against the
     plain path on the same weights (coarse sigma bias raised by
     CULL_FINE_SIGMA_BIAS), ms per step and per 128x128 view in turns, one
     profiled step and render, and in-step the warp recompute's device ms.
     smpl_estimator trains EST_EPOCHS epochs on the smpl_nerf set's images
     (finite, falling loss; the run dir reloads with its BatchNorm
     statistics), seconds per epoch;
 10a. the Table-1 baselines: nearest neighbours (`cli.baselines`) on the
     generated smpl_nerf set with its scores, files and seconds; the
     silhouette fit of arm angle 0.6 (joint 41) on the procedural human from
     a 64x64 silhouette the card ray traces, 150 Adam steps on the card
     (recovered within 0.25, tests/test_baselines.py's case), its seconds;
     create_dataset_torch --dataset_type=pix2pix on the same cameras and
     poses, P2P_EPOCHS epochs of the bf16 U-Net (`cli.pix2pix`, seconds per
     epoch, a falling loss), and `cli.evaluate_pix2pix` on the val views
     (ground truth, NN renders, U-Net renders; the comparison GIF);
 10b. the tools: `measure_render_256_torch` (cli.measure_render) at
     TOOL_RES^2 on phase 4's smpl_nerf configuration (seeded, with the culled
     phase's sigma biases: every ray opaque before its last sample), one batch
     of all 65,536 rays through its four candidates (full, fg-culled,
     occupancy, occupancy on a prebaked grid; one warm call and five timed
     each): the kernel path's launches of A and B recorded with their rows per
     candidate (the full render: A at R = 65,536, B at 4,194,304 coarse and
     12,582,912 fine rows), the plain path's none, the two full renders held
     to the render bounds, each candidate's best-of-5 ms, the peak device
     memory and one profiled full render; the kernel path of phase 6's append
     configuration (mode 1: D at 8,388,608 rows of 705 floats);
     `pose_landscape_torch` over LANDSCAPE_ANGLES on phase 9's image_wise run;
     `rescore_renders_torch` on phase 8's --inf_fast 0 renders (forced,
     --dry_run: PSNR of the 8-bit files within 0.1 dB of inference's, the file
     untouched); `aliasing_floor_torch` on phase 10's smpl_nerf val split;
 11. distillation: `cli.distill.main` on that dataset's val split (2 views of
     64x64, one 4096-ray chunk each) with a seeded full-width `nerf` teacher
     (arm_angles.txt widths, --use_fused_mlp=2, so the teacher runs through
     kernel B): grid 20 (8000 experts), hidden 32, 192 samples, chunk 4096,
     tile 256, 300 distill steps, 100 + 40 fine-tune steps (cuts: the recipe
     runs thousands). A random-weight teacher has no density above the tool's
     default thresholds, so --sigma_thresh and --ess_thresh are quantiles
     (0.90, 0.97) of the teacher's probed sigma. The tool runs twice on one
     --out_dir: first without ESS, which fits and saves the fields; then the
     script bisects --ess_thresh on the fine-tuned field itself until 5-35 % of
     the cells (after dilation) are occupied, sets the launch counts to 0 and
     runs the tool again with ESS and ray culling, which resumes the fields
     and caches and serves through every form, kernel E included. Checks: E
     launched as often as the chunk count predicts, no overflow, the tool's
     own kernel-against-culled check (max |drgb| <= 5e-2) and a whole view of
     both, skip routing + padding + several tiles per expert all present,
     finite falling losses (the histories the tool returns), scores.json and
     field.npz read back; ms per view of every serving form; one profiled
     kernel-path view; and kernel E against its plain version, timed, on the
     sorted-tile plan of view 0's chunk through the compact field (bf16, the
     serving type, and float32): the kernels line's numbers for E;
 12. roofline: `cli.mlp_roofline.main` part `chain` (W=256/512/1024, depth 8,
     131,072 rows: launches F; the kernel chain within one bf16 step of the
     largest output of the library chain, and not dead) and part
     `fusedmlp` at W=256 (B, C and D);
 13. one JSON line of per-kernel results (with each path's launches);
 14. last line: {"ok": true, "device": {"platform": "gpu", ...}}.

Tolerances, each with its reason:
  * sample_pdf (kernel A): the kernel's warp-shuffle cumsum adds in another
    order than torch.cumsum, so where u meets a cdf entry to float precision
    the sample lands one bin over. Every sample must lie within one bin width
    (the widest bin of its input) and at most 0.5% may differ by more than 1e-4.
  * fused forwards (kernels B and D): both sides round the same values to
    bf16 at the same places and accumulate in float32, but in another order,
    which can flip one bf16 rounding (2^-8 relative) that carries through
    later layers: max |err| <= 2e-2 * max |plain| and mean |err| <= 2e-3 *
    mean |plain|.
  * fused v2 backward (kernel C): the same roundings, and besides a ReLU
    mask flips where the two forwards put an activation on either side of
    0, which moves one row's dX by a whole term: dX max |err| <= 0.25 * max
    |plain| and mean |err| <= 5e-3 * mean |plain|. Every dW and db is a sum
    over all rows, where such flips average out, and the kernel rounds dW to
    bf16 per 256-row slice (as the JAX kernel's tiles) where the plain version
    rounds once: ||kernel - plain|| <= 3e-2 * ||plain||. The kernel sums with
    no atomics, in a fixed order, so two runs on the same inputs must agree
    bit for bit (dX, every dW and db). At the culled budget's 136,512 rows
    dX's max bound is held against the float64 gradient of the same rounded
    forward instead of the plain version: both round every cotangent to
    bf16, in their own orders, and through the encoding's 2^9 frequencies
    one rounding moves a row's dX by a good part of the largest row's; on
    the card test's inputs the plain version is further than the bound from
    the float64 gradient on one row, on which the kernel is close to it.
  * fused expert tiles (kernel E): in float32 the kernel and its plain
    version differ only in summation order: max |err| <= 2e-5 * max(1, max
    |plain|). In bf16 both round the encoding, the weights and the hidden
    activations to bf16 at the same places, but a float32 sum taken in
    another order can flip one of those roundings (2^-8 relative), which the
    second layer carries on: max |err| <= 5e-2 on outputs of order 1.
  * relu-matmul (kernel F): products of bf16 values are exact in float32 and
    only the order of the float32 sum differs, so an output can land on the
    other side of one bf16 rounding (2^-7 relative); next to zero, where relu
    cuts, the float32 sums themselves differ by their own rounding (up to 1024
    terms of order 0.1): |err| <= 2^-7 * |plain| + 5e-5 per element. Over the
    roofline script's 8-layer chain the kernel is held against the library
    call: max |kernel - library| <= 2^-7 * max |output| (they have agreed bit
    for bit so far), and the chain's mean |output| must be above 0.
  * kernel H (the normalised-ReLU attention): every pair's a is the eager
    path's, so the forward differs only in the order of its sums (max |err|
    <= 1e-5 * max |eager|) and each gradient in the order of its sums and in
    summing c (s - v) / d per pair where autograd takes grad / (2 d) times
    2 (s - v): |err| <= 1e-4 * |eager| by norm. No float atomics: two runs
    agree bit for bit.
  * fused-kernel expert render vs the culled render (same plan, same bf16
    serving type, the two roundings of `ep.tiles_apply` and of the kernel):
    max |drgb| <= 5e-2, the tool's own bound.
  * kernel path vs plain path renders: the plain path rounds like flax's
    bf16 Dense (product and bias rounded to bf16), the kernel like the TPU
    kernel (float32 bias, bf16 after each activation), and the fine samples
    can flip a bin: max pixel difference <= 0.1, mean <= 1e-2.
  * culled renders, kernel path vs plain path, ray by ray, each path's
    choice of rays replayed from its own passes (a culled ray must keep its
    coarse colour, or hold the background colour, bit for bit):
    `--fast 1` sends the 25 % of rays of largest coarse opacity through the
    fine pass, and each path picks from its own opacities; on random weights
    many rays have opacity 1 to within rounding, so the picks differ at the
    budget's edge, where a ray's pixel jumps between its coarse and its fine
    colour. So the pixel bounds above hold on the rays both paths treat
    alike; a ray picked by one path only must lie within twice the paths'
    largest opacity difference (itself <= 0.1) of its batch's K-th opacity;
    and on the kernel path's own picks, which no tie can shift, the plain
    path's passes must give the kernel path's render under the pixel bounds
    on every ray. `--fast 2`: the auto budget must lie below the batch; every
    ray that clears the grid's threshold in either path must be rendered by
    both, a ray rendered by one path only must be below the threshold in
    both (the budget's rest, taken below the threshold, ties by index), and the
    rays both paths treat alike are held to the pixel bounds.
  * `--fast 1 --cap_fraction 1` vs the full render, both on the kernel path:
    the same kernels on the same rows, only reordered by the selection, and
    each row's result depends on that row alone: max |diff| <= 1e-4.
  * kernel path vs plain path training losses: the same two roundings, in
    the forward and in the gradients, from the same weights, batches and
    jitter: each of the first 8 steps' losses within 10 % of the other path's
    (the SMPL-driven families and vertex_sphere: the first step's).
  * the vertex embedder's gradient under --use_fused_mlp=2 (phase 9): a sum
    over every ray of the prefix columns of C's dX, like a dW: against the
    same pipeline with B and C replaced by their plain versions (the same
    roundings) ||kernel - plain|| <= BWD_DW_REL * ||plain||; against the
    plain path (flax's roundings, as the losses) within LOSS_REL.
  * smpl and warp, the card's first-step loss against the CPU's: the same
    plain bf16 nets (flax's rounding) from the same weights and batch; cuBLAS
    and the CPU sum each bf16 product in float32 in their own orders, which
    can flip a bf16 rounding (2^-8 relative) of an activation: 1e-2 relative.
  * --siren / --grid_encoding, kernel path against plain path: only the
    fine samples differ (kernel A against its plain version, which can flip
    a bin): the first step's loss within LOSS_REL, the renders under the
    pixel bounds above; --fast 1 --cap_fraction 1 against the full render
    under CAP1_MAX.
  * the evaluation's scores against each baseline's own run: the NN renders
    are training images, exact in 8 bits: PSNR within 0.1 dB; the U-Net's
    own scores are taken on its float renders and the evaluation's on its
    8-bit PNGs: PSNR within 0.5 dB.
  * the generated smpl image, card against CPU: the CPU test's bounds
    (tests/test_torch_port_generate.py), on the pixels whose closest face
    is the same on both devices (a ray through a triangle edge can take the
    neighbouring face): hit masks on >= 99.5 % of the pixels, the face on
    >= 98 %, colour within 1 level, depth and warp within 1e-4.
"""
from __future__ import annotations

import json
import os
import shutil
import statistics
import struct
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
ARM_ANGLES = os.path.join(REPO, "configs", "arm_angles.txt")
APPEND_CONFIG = os.path.join(REPO, "configs", "config.txt")
DEVICE = "cuda"

# H100 SXM published peaks (NVIDIA data sheet): dense bf16 tensor cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12          # float32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12

PDF_R, PDF_K, PDF_F = 2048, 63, 128          # one 2048-ray batch, 64 coarse -> 63 mids
MLP_ROWS = 2048 * 64                          # one coarse batch of rows
FINE_ROWS = 2048 * (64 + 128)                 # one fine batch (coarse + fine samples)
VIEWS, RES, BATCH, POSE_ANGLE = 2, 128, 2048, 20.0
MLP_ERR_MAX, MLP_ERR_MEAN = 2e-2, 2e-3
PDF_OFF_SHARE = 5e-3
PIXEL_MAX, PIXEL_MEAN = 0.1, 1e-2
CAP1_MAX = 1e-4
FAST_CAP = 0.25      # render_path's --fast 1 budget when --cap_fraction is not given
# the culled renders' camera radius: the occupancy grid's box (DEFAULT_AABB,
# half-width 2) then covers a third of each view, and near/far enclose the
# box's corners (2 * sqrt(3) from its centre)
CULL_RADIUS = 8.0
CULL_NEAR_FAR = (CULL_RADIUS - 3.5, CULL_RADIUS + 3.5)
# added to the culled runs' fine sigma bias, so that every ray is opaque
# before its last fine sample: that sample's interval is 1e10 long, so where
# a ray still lets light through there, a density within rounding of 0 sets
# the ray's colour apart between the two paths (an append ray at radius 8 did
# without it)
CULL_FINE_SIGMA_BIAS = 4.0
# the same for the coarse net, which --fast 1 picks by: with flax's lecun
# draw (std sqrt(1 / fan_in)) a seeded coarse ray can reach its last sample
# with most of its light (one kept 0.74 of it), and then its opacity is 0 or
# 1 by the sign of a density within rounding of 0. +2 over the 64 samples of
# 0.11 makes every ray opaque before its last sample (transmittance about
# e^-14) and leaves the opacities apart below 1, so the budget still ranks
CULL_COARSE_SIGMA_BIAS = 2.0
ODD_K = 711          # an auto-cap budget of a 2048-ray batch: no multiple of a tile
BWD_DX_MAX, BWD_DX_MEAN, BWD_DW_REL = 0.25, 5e-3, 3e-2
TRAIN_VIEWS, VAL_VIEWS, TRAIN_RES = 8, 2, 64
EPOCHS, STEPS_PER_EPOCH = 2, 8
LOSS_REL, LOSS_STEPS = 0.10, 8
EXPERT_D, EXPERT_H, EXPERT_TILE, L_POS, L_DIR = 42, 32, 256, 4, 2
EXPERT_F32_REL, EXPERT_BF16_ABS = 2e-5, 5e-2
RELU_ROWS, RELU_WIDTHS, RELU_REL, RELU_ABS = 131072, (256, 512, 1024), 2.0 ** -7, 5e-5
# kernel G at port_bench's dummy_dynamic.train: a step, its validation batch,
# 64 coarse samples, SMPL's vertices, warp_radius and warp_temperature; its
# bound against the eager path (tests/test_torch_port_cuda.py's ATT_REL)
ATT_R, ATT_R_VAL, ATT_S, ATT_V, ATT_RADIUS, ATT_T, ATT_REL = 2048, 4096, 64, 6890, 0.15, 1e4, 1e-5
# kernel H at port_bench's image_wise_dynamic.train: a step's 2048 rays of 64
# samples (ATT_S) over the 6,890-vertex body at its warp_radius (ATT_RADIUS);
# the gradients' bound against the eager path under autograd, by norm
# (tests/test_torch_port_cuda.py's RELU_GRAD_REL); ~10 forward and ~20 backward
# FP32 operations a (sample, vertex) pair, the published math once a pair
RELU_R, RELU_GRAD_REL, RELU_OPS_PER_PAIR = 2048, 1e-4, 30
DISTILL_GRID, DISTILL_SAMPLES, DISTILL_CHUNK = 20, 192, 4096
DISTILL_STEPS, FINETUNE_STEPS, FINETUNE2_STEPS, DISTILL_REPS = 300, 100, 40, 3
OCCUPIED_SHARE = (0.05, 0.35)   # bisection target; the contract is 2-50 %
ROOFLINE_REPS, ROOFLINE_DEPTH = 5, 8
SMPL_STEPS, SMPL_IPB = 4, 2     # steps per SMPL-driven training run; its --images_per_batch
GEN_VIEWS, GEN_RES, GEN_VAL, VS_VIEW_RES = 10, 64, 2, 128    # generated sets; vertex_sphere views
SAMPLE_LOSS_REL = 1e-2          # smpl / warp first-step loss, card against the CPU (bf16 nets)
GEN_HIT_SHARE, GEN_FACE_SHARE, GEN_T_ATOL = 0.995, 0.98, 1e-4   # the CPU test's bounds
EST_EPOCHS, EST_BATCH = 3, 4
NET_STEPS = 4                   # steps of each --siren / --grid_encoding / flag run
FIT_STEPS, FIT_ANGLE, FIT_TOL = 150, 0.6, 0.25    # tests/test_baselines.py's arm-angle fit
P2P_VIEWS, P2P_EPOCHS, P2P_BATCH = GEN_VIEWS, 5, 4
# the paths of the prefixed nets on raw rows (--use_fused_mlp=2): the prefix
# rows of kernels B and C
PREFIX_PATHS = ("append_v2", "append_vertex_v2")
# the parallel phase: steps of each world-1 run, the bound on the group run's
# losses and weights against the run without a group (the same arithmetic: a
# share of 1, sums over one rank), the sample-axis, pipeline and expert shapes
PAR_STEPS, PAR_REL, TORCHRUN_STEPS = 4, 1e-6, 2
SA_R, SA_S, PP_ROWS, PP_MICRO, EP_E, EP_N = 2048, 192, 4096, 4, 64, 8192
PAR_FN_REL = 1e-4
# the tools phase: the whole-image view of measure_render (one batch of all
# its rays; 64 coarse + 128 fine samples on arm_angles.txt, 64 + 64 on
# config.txt), its cull budget, the pose landscape's angles
TOOL_RES = 256
TOOL_RAYS = TOOL_RES * TOOL_RES
TOOL_K = int(TOOL_RAYS * 0.25)
TOOL_REPS = dict(reps=5, warmup=1)   # timing of the kernels at the whole-image shapes
PLAIN_CHUNK = 1 << 20                # rows per call of a plain version above this
LANDSCAPE_ANGLES = ("0", "40", "5")
SPAN_CAPACITY = 1 << 16              # spans a timed training run records (`timed_run`)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event time of one call of fn, in ms."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def mlp_macs(spec) -> int:
    """Multiply-adds per sample of a RenderRayNet (every layer, both heads)."""
    W, P, D, add = spec.width, spec.positions_dim, spec.directions_dim, spec.additional_input_dim
    macs = (P + add) * W
    macs += sum((W + (P + add if i in spec.skips else 0)) * W for i in range(spec.n_layers - 1))
    macs += W * W + W                                            # additional layer, sigma head
    macs += (W + (D if spec.use_directional_input else 0)) * (W // 2)
    macs += (W // 2) * (W // 2) + (W // 2) * 3                   # directional_net_0, rgb head
    return macs


def phase_card() -> str:
    line = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {line}")
    return line


def phase_build() -> dict:
    """Build every kernel; returns {source name: ptxas lines on registers,
    spills and wgmma serialisation}."""
    from smpl_nerf_tpu_torch.ops import _build

    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"build: {len(logs)} kernels in {time.perf_counter() - t0:.1f} s")
    usage = {}
    for name, log in logs.items():
        usage[name] = [line.strip() for line in log.splitlines()
                       if any(w in line for w in ("entry function", "registers", "spill",
                                                  "Performance Loss"))]
        for line in usage[name]:
            print(f"  ptxas {name}: {line}")
    return usage


def phase_sample_pdf(device) -> dict:
    """Kernel A at a 2048-ray batch (the entry's headline) and at the
    whole-image batch of the tools phase (R = TOOL_RAYS, by_rays)."""
    by_rays = {str(R): sample_pdf_at(device, R) for R in (PDF_R, TOOL_RAYS)}
    return {"name": "sample_pdf", "route": "cuda",
            "source": "smpl_nerf_tpu_torch/csrc/sample_pdf.cu",
            "replaces": "smpl_nerf_tpu/ops/sample_pdf_pallas.py:83", "parity_ok": True,
            **by_rays[str(PDF_R)], "bound_by": "bytes", "library_ms": None, "by_rays": by_rays}


def sample_pdf_at(device, R: int) -> dict:
    """Kernel A on R seeded rays (K = PDF_K bins, 30 % of them empty, PDF_F
    fine samples) against its plain version, timed."""
    from smpl_nerf_tpu_torch.core import sampling
    from smpl_nerf_tpu_torch.ops import sample_pdf_cuda

    g = torch.Generator(device=device).manual_seed(0)
    bins = torch.sort(1.0 + 3.0 * torch.rand(R, PDF_K, generator=g, device=device), -1)[0]
    weights = torch.rand(R, PDF_K - 1, generator=g, device=device)
    weights = torch.where(torch.rand(weights.shape, generator=g, device=device) < 0.3,
                          torch.zeros_like(weights), weights)     # empty space
    got = sample_pdf_cuda.sample_pdf_cuda(bins, weights, PDF_F)
    want = sampling.sample_pdf(bins, weights, PDF_F)
    torch.cuda.synchronize()
    err = (got - want).abs()
    max_err = float(err.max())
    off_share = float((err > 1e-4).float().mean())
    widest = float((bins[:, 1:] - bins[:, :-1]).max())
    print(f"kernel A sample_pdf R={R} K={PDF_K} F={PDF_F}: max|err|={max_err:.3e} "
          f"(bound: widest bin {widest:.3e}), share off by >1e-4: {off_share:.3e} "
          f"(bound {PDF_OFF_SHARE})")
    check(bool(torch.isfinite(got).all()), "sample_pdf kernel gave non-finite samples")
    check(max_err <= widest and off_share <= PDF_OFF_SHARE,
          "sample_pdf kernel disagrees with its plain version")
    ms = time_ms(lambda: sample_pdf_cuda.sample_pdf_cuda(bins, weights, PDF_F))
    plain_ms = time_ms(lambda: sampling.sample_pdf(bins, weights, PDF_F))
    device_ms = kernel_device_ms("sample_pdf", lambda: sample_pdf_cuda.sample_pdf_cuda(
        bins, weights, PDF_F))
    bytes_moved = 4 * R * (PDF_K + (PDF_K - 1) + PDF_F)
    bound_ms = 1e3 * bytes_moved / PEAK_BYTES_PER_S
    print(f"  time: kernel {ms:.4f} ms per call (events), {device_ms:.4f} ms on the device "
          f"(profiler), plain {plain_ms:.4f} ms, bound {bound_ms:.5f} ms "
          f"({bytes_moved} B at {PEAK_BYTES_PER_S:.3g} B/s), {100 * bound_ms / device_ms:.1f} % "
          f"of the bound on the device")
    return {"max_abs_err": max_err, "off_share": off_share, "ms": ms, "device_ms": device_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms}


def full_width_net(device, seed: int, additional_input_dim: int = 0):
    """The 8x256 RenderRayNet of both configs (skip 4, L=10/4, bf16) with seeded
    weights and small seeded biases, so that a misplaced bias shows."""
    from smpl_nerf_tpu_torch.models import RenderRayNet

    gen = torch.Generator().manual_seed(seed)
    net = RenderRayNet(n_layers=8, width=256, positions_dim=60, directions_dim=24,
                       additional_input_dim=additional_input_dim, skips=(4,),
                       compute_dtype=torch.bfloat16, generator=gen)
    with torch.no_grad():
        for layer in net.modules():
            if isinstance(layer, torch.nn.Linear):
                layer.bias.copy_(0.05 * torch.randn(layer.bias.shape, generator=gen))
    return net.to(device).requires_grad_(False)


def raw_rows(device, seed: int, rows: int = MLP_ROWS) -> torch.Tensor:
    """[rows, 6] raw rows: xyz in the scene's box, unit directions."""
    g = torch.Generator(device=device).manual_seed(seed)
    xyz = 3.0 * torch.rand(rows, 3, generator=g, device=device) - 1.5
    dirs = torch.randn(rows, 3, generator=g, device=device)
    return torch.cat([xyz, dirs / dirs.norm(dim=-1, keepdim=True)], -1).contiguous()


def in_chunks(fn, x: torch.Tensor, chunk: int = PLAIN_CHUNK):
    """A call of the row-wise plain version `fn` on all of x: in one piece up
    to `chunk` rows, above that chunk by chunk (a plain forward's float32
    temporaries at the whole-image shapes would not fit beside x)."""
    if x.shape[0] <= chunk:
        return lambda: fn(x)
    return lambda: torch.cat([fn(x[lo:lo + chunk]) for lo in range(0, x.shape[0], chunk)])


def forward_parity(name: str, got, want) -> tuple:
    """Print and check a fused forward against its plain version (B's bounds)."""
    err = (got - want).abs()
    max_err, mean_err = float(err.max()), float(err.mean())
    scale_max, scale_mean = float(want.abs().max()), float(want.abs().mean())
    print(f"  max|err|={max_err:.3e} (rel {max_err / scale_max:.3e}, bound {MLP_ERR_MAX}), "
          f"mean|err|={mean_err:.3e} (rel {mean_err / scale_mean:.3e}, bound {MLP_ERR_MEAN})")
    check(bool(torch.isfinite(got).all()), f"{name} kernel gave non-finite outputs")
    check(max_err <= MLP_ERR_MAX * scale_max and mean_err <= MLP_ERR_MEAN * scale_mean,
          f"{name} kernel disagrees with its plain version")
    return max_err, max_err / scale_max


def phase_fused_mlp(device) -> dict:
    """Kernel B at the two batch sizes of a step and of a render batch:
    131,072 rows (the coarse call, the entry's headline) and 393,216 (fine)."""
    from smpl_nerf_tpu_torch.ops import fused_mlp, fused_mlp_v2

    net = full_width_net(device, seed=1)
    spec = fused_mlp.spec_from_model(net)
    flat = fused_mlp.flatten_params(spec, net)
    by_rows = {}
    for rows in (MLP_ROWS, FINE_ROWS, TOOL_RAYS * 192):
        reps = TOOL_REPS if rows > FINE_ROWS else {}
        x = raw_rows(device, seed=2, rows=rows)
        plain = in_chunks(lambda rows: fused_mlp_v2.reference_forward_raw(spec, flat, rows), x)
        with torch.no_grad():
            got = fused_mlp_v2.fused_forward_cuda(spec, net, x)
            want = plain()
        torch.cuda.synchronize()
        print(f"kernel B fused_mlp_v2_fwd N={rows} W={spec.width} layers={spec.n_layers} "
              f"skips={spec.skips} bf16, {fused_mlp_v2.shared_bytes(spec)} B shared memory per "
              f"block:")
        max_err, rel_err = forward_parity("fused v2", got, want)
        del got, want
        with torch.no_grad():
            ms = time_ms(lambda: fused_mlp_v2.fused_forward_cuda(spec, net, x), **reps)
            plain_ms = time_ms(plain, **reps)
        flops = 2 * mlp_macs(spec) * rows
        bytes_moved = rows * (6 + 4) * 4 + sum(p.numel() for p in flat) * 2
        ops_ms, bytes_ms = 1e3 * flops / PEAK_BF16_FLOPS, 1e3 * bytes_moved / PEAK_BYTES_PER_S
        print(f"  time: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound by operations "
              f"{ops_ms:.5f} ms ({flops:.4g} FLOP at {PEAK_BF16_FLOPS:.3g} FLOP/s bf16; "
              f"{mlp_macs(spec)} MAC/sample), by bytes {bytes_ms:.5f} ms, "
              f"{100 * max(ops_ms, bytes_ms) / ms:.1f} % of the bound")
        by_rows[str(rows)] = {"max_abs_err": max_err, "rel_err": rel_err, "ms": ms,
                              "plain_ms": plain_ms, "bound_ms": max(ops_ms, bytes_ms),
                              "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}
        del x, plain
    torch.cuda.empty_cache()
    return {"name": "fused_mlp_v2_fwd", "route": "cuda",
            "source": "smpl_nerf_tpu_torch/csrc/fused_mlp_v2_fwd.cu",
            "replaces": "smpl_nerf_tpu/ops/fused_mlp_v2.py:128", "parity_ok": True,
            **by_rows[str(MLP_ROWS)], "library_ms": None, "by_rows": by_rows}


def phase_fused_mlp_v1(device) -> dict:
    """Kernel D on pre-encoded rows of the configs/config.txt net: 621-wide
    pose prefix (69 joints x (1 + 2*4)), 60 position and 24 direction columns,
    at the append render's two batch sizes: 131,072 rows (a coarse batch, the
    entry's headline) and 262,144 (a fine batch); and of the
    append_vertex_locations_to_nerf net, whose prefix is the 64-wide vertex
    embedding (in_dim 148), and of the prefix-free vertex_sphere net (in_dim
    84: 60 position and 24 direction columns), each at 131,072 rows (by_rows
    keys "148:131072", "84:131072")."""
    from smpl_nerf_tpu_torch.ops import fused_mlp

    by_rows = {}
    for add, rows, key in ((621, MLP_ROWS, str(MLP_ROWS)), (621, 2 * MLP_ROWS, str(2 * MLP_ROWS)),
                           (64, MLP_ROWS, f"148:{MLP_ROWS}"), (0, MLP_ROWS, f"84:{MLP_ROWS}"),
                           (621, TOOL_RAYS * 128, str(TOOL_RAYS * 128))):
        reps = TOOL_REPS if rows > 2 * MLP_ROWS else {}
        net = full_width_net(device, seed=3, additional_input_dim=add)
        spec = fused_mlp.spec_from_model(net)
        flat = fused_mlp.flatten_params(spec, net)
        g = torch.Generator(device=device).manual_seed(4)
        # encoded columns lie in [-1, 1]; the identity part of the pose prefix too
        x = 2.0 * torch.rand(rows, spec.in_dim, generator=g, device=device) - 1.0
        plain = in_chunks(lambda rows: fused_mlp.reference_forward(spec, flat, rows), x)
        with torch.no_grad():
            got = fused_mlp.fused_forward_cuda(spec, net, x)
            want = plain()
        torch.cuda.synchronize()
        print(f"kernel D fused_mlp_fwd N={rows} in_dim={spec.in_dim} "
              f"(prefix {spec.additional_input_dim}) W={spec.width} layers={spec.n_layers} "
              f"skips={spec.skips} bf16, {fused_mlp.shared_bytes(spec)} B shared memory per "
              f"block:")
        max_err, rel_err = forward_parity("fused v1", got, want)
        del got, want
        with torch.no_grad():
            ms = time_ms(lambda: fused_mlp.fused_forward_cuda(spec, net, x), **reps)
            plain_ms = time_ms(plain, **reps)
        flops = 2 * mlp_macs(spec) * rows
        bytes_moved = rows * (spec.in_dim + 4) * 4 + sum(p.numel() for p in flat) * 2
        ops_ms, bytes_ms = 1e3 * flops / PEAK_BF16_FLOPS, 1e3 * bytes_moved / PEAK_BYTES_PER_S
        print(f"  time: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound by operations "
              f"{ops_ms:.5f} ms ({flops:.4g} FLOP; {mlp_macs(spec)} MAC/sample), by bytes "
              f"{bytes_ms:.5f} ms ({bytes_moved} B; {(spec.in_dim + 4) * 4} B/sample), "
              f"{100 * max(ops_ms, bytes_ms) / ms:.1f} % of the bound")
        by_rows[key] = {"max_abs_err": max_err, "rel_err": rel_err, "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": max(ops_ms, bytes_ms),
                        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}
        del x, plain
    torch.cuda.empty_cache()
    return {"name": "fused_mlp_fwd", "route": "cuda",
            "source": "smpl_nerf_tpu_torch/csrc/fused_mlp_fwd.cu",
            "replaces": "smpl_nerf_tpu/ops/fused_mlp.py:139", "parity_ok": True,
            **by_rows[str(MLP_ROWS)], "library_ms": None, "by_rows": by_rows}


def phase_fused_bwd(device) -> dict:
    """Kernel C against autograd through the plain forward, seeded cotangent,
    at 131,072 and 393,216 rows (a step's two calls); each run twice, which
    must give the same bits."""
    from smpl_nerf_tpu_torch.ops import fused_mlp, fused_mlp_v2

    net = full_width_net(device, seed=5)
    spec = fused_mlp.spec_from_model(net)
    flat = fused_mlp.flatten_params(spec, net)
    n_params = sum(p.numel() for p in flat)
    by_rows = {}
    for rows in (MLP_ROWS, FINE_ROWS):
        x = raw_rows(device, seed=6, rows=rows)
        gen = torch.Generator(device=device).manual_seed(7)
        # the cotangent of a mean loss over the rows
        g = torch.randn(rows, 4, generator=gen, device=device) / rows
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        dflat, dx = fused_mlp_v2.fused_backward_cuda(spec, net, x, g)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        again_flat, again_dx = fused_mlp_v2.fused_backward_cuda(spec, net, x, g)
        want_flat, want_dx = fused_mlp_v2.reference_backward_raw(spec, flat, x, g)
        torch.cuda.synchronize()
        same = torch.equal(dx, again_dx) and all(torch.equal(a, b)
                                                 for a, b in zip(dflat, again_flat))
        err = (dx - want_dx).abs()
        max_err, mean_err = float(err.max()), float(err.mean())
        scale_max, scale_mean = float(want_dx.abs().max()), float(want_dx.abs().mean())
        rels = [float((a - b).norm() / b.norm()) for a, b in zip(dflat, want_flat)]
        workspace = fused_mlp_v2.workspace_bytes(spec, rows)
        print(f"kernel C fused_mlp_v2_bwd N={rows} W={spec.width} layers={spec.n_layers} bf16: "
              f"dX max|err|={max_err:.3e} (rel {max_err / scale_max:.3e}, bound {BWD_DX_MAX}), "
              f"mean|err|={mean_err:.3e} (rel {mean_err / scale_mean:.3e}, bound "
              f"{BWD_DX_MEAN}); dW/db worst ||err||/||plain||={max(rels):.3e} over {len(rels)} "
              f"tensors (bound {BWD_DW_REL}); two runs bit-identical: {same}; workspace "
              f"{workspace} B, peak allocated during the call {peak} B")
        check(all(bool(torch.isfinite(t).all()) for t in (dx, *dflat)),
              "fused v2 backward kernel gave non-finite gradients")
        check(max_err <= BWD_DX_MAX * scale_max and mean_err <= BWD_DX_MEAN * scale_mean
              and max(rels) <= BWD_DW_REL,
              "fused v2 backward kernel disagrees with its plain version")
        check(same, "fused v2 backward kernel is not bit-identical from run to run")
        del again_flat, again_dx, want_flat, want_dx
        ms = time_ms(lambda: fused_mlp_v2.fused_backward_cuda(spec, net, x, g))
        plain_ms = time_ms(lambda: fused_mlp_v2.reference_backward_raw(spec, flat, x, g), reps=5)
        flops = 3 * 2 * mlp_macs(spec) * rows          # recompute, dH chain, dW
        bytes_moved = rows * (6 + 4 + 6) * 4 + n_params * (2 + 4)
        ops_ms, bytes_ms = 1e3 * flops / PEAK_BF16_FLOPS, 1e3 * bytes_moved / PEAK_BYTES_PER_S
        print(f"  time: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound by operations "
              f"{ops_ms:.5f} ms ({flops:.4g} FLOP at {PEAK_BF16_FLOPS:.3g} FLOP/s bf16), by "
              f"bytes {bytes_ms:.5f} ms, {100 * max(ops_ms, bytes_ms) / ms:.1f} % of the bound")
        by_rows[str(rows)] = {"max_abs_err": max_err, "rel_err": max_err / scale_max,
                              "dw_rel_err": max(rels), "bit_identical": same,
                              "workspace_bytes": workspace, "peak_bytes": peak, "ms": ms,
                              "plain_ms": plain_ms, "bound_ms": max(ops_ms, bytes_ms),
                              "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}
    return {"name": "fused_mlp_v2_bwd", "route": "cuda",
            "source": "smpl_nerf_tpu_torch/csrc/fused_mlp_v2_bwd.cu",
            "replaces": "smpl_nerf_tpu/ops/fused_mlp_v2.py:157", "parity_ok": True,
            **by_rows[str(MLP_ROWS)], "library_ms": None, "by_rows": by_rows}


def prefixed_raw_rows(device, seed: int, rows: int, add: int) -> torch.Tensor:
    """[rows, add + 6] raw rows: a prefix in [-1, 1] (an encoded pose, an
    embedding's scale), then `raw_rows`."""
    g = torch.Generator(device=device).manual_seed(seed + 1000)
    prefix = 2.0 * torch.rand(rows, add, generator=g, device=device) - 1.0
    return torch.cat([prefix, raw_rows(device, seed, rows)], -1).contiguous()


def phase_fused_prefix(device) -> tuple:
    """Kernels B and C on raw rows with a conditioning prefix, against their
    plain versions: the append_smpl_params nets of configs/config.txt (a
    621-wide encoded pose prefix) at 131,072 rows and at a culled budget's
    fine pass (ODD_K rays x 128 samples), append_vertex_locations_to_nerf's
    64-wide embedding and append_to_nerf's 18 encoded joint columns at
    131,072 rows. C's dX max is held against the float64 gradient of the same
    rounded forward (`exact_backward_dx`), on the prefix columns and on the
    xyz/dir columns apart; C runs twice, bit for bit. Returns the kernels
    line's entries of B and C with prefix rows (headline: add 621 at 131,072
    rows)."""
    from smpl_nerf_tpu_torch.ops import fused_mlp, fused_mlp_v2

    b_shapes, c_shapes = {}, {}
    for add, rows, timed in ((621, MLP_ROWS, True), (621, ODD_K * 128, False),
                             (64, MLP_ROWS, True), (18, MLP_ROWS, True)):
        key = f"{add}:{rows}"
        net = full_width_net(device, seed=20 + add, additional_input_dim=add)
        spec = fused_mlp.spec_from_model(net)
        flat = fused_mlp.flatten_params(spec, net)
        n_params = sum(p.numel() for p in flat)
        x = prefixed_raw_rows(device, seed=21, rows=rows, add=add)
        gen = torch.Generator(device=device).manual_seed(22)
        g = torch.randn(rows, 4, generator=gen, device=device) / rows
        with torch.no_grad():
            got = fused_mlp_v2.fused_forward_cuda(spec, net, x)
            want = fused_mlp_v2.reference_forward_raw(spec, flat, x)
        torch.cuda.synchronize()
        print(f"kernel B fused_mlp_v2_fwd with a prefix: N={rows} add={add} (rows of "
              f"{add + 6} floats) W={spec.width} layers={spec.n_layers} bf16:")
        max_err, rel_err = forward_parity("fused v2 (prefix rows)", got, want)
        del got, want
        dflat, dx = fused_mlp_v2.fused_backward_cuda(spec, net, x, g)
        again_flat, again_dx = fused_mlp_v2.fused_backward_cuda(spec, net, x, g)
        want_flat, want_dx = fused_mlp_v2.reference_backward_raw(spec, flat, x, g)
        exact = fused_mlp_v2.exact_backward_dx(spec, flat, x, g)
        torch.cuda.synchronize()
        same = torch.equal(dx, again_dx) and all(torch.equal(a, b)
                                                 for a, b in zip(dflat, again_flat))
        rels = [float((a - b).norm() / b.norm()) for a, b in zip(dflat, want_flat)]
        dx_abs_err = float((dx.double() - exact).abs().max())
        reading = {}
        for part, cols in (("prefix", slice(0, add)), ("xyz_dir", slice(add, add + 6))):
            scale_max = float(want_dx[:, cols].abs().max())
            scale_mean = float(want_dx[:, cols].abs().mean())
            to_exact = float((dx[:, cols].double() - exact[:, cols]).abs().max()) / scale_max
            plain_exact = float((want_dx[:, cols].double() - exact[:, cols]).abs().max()) / scale_max
            mean_rel = float((dx[:, cols] - want_dx[:, cols]).abs().mean()) / scale_mean
            reading[part] = {"dx_max_to_exact": to_exact, "plain_dx_max_to_exact": plain_exact,
                             "dx_mean_to_plain": mean_rel}
            print(f"kernel C fused_mlp_v2_bwd with a prefix: N={rows} add={add}, dX {part} "
                  f"columns: max|err| / max|plain dX| against the float64 gradient "
                  f"{to_exact:.4f} (bound {BWD_DX_MAX}; the plain version's own "
                  f"{plain_exact:.4f}), mean|err| rel to the plain version {mean_rel:.3e} "
                  f"(bound {BWD_DX_MEAN})")
            check(to_exact <= BWD_DX_MAX and mean_rel <= BWD_DX_MEAN,
                  f"fused v2 backward kernel's dX {part} columns disagree (add {add}, N {rows})")
        workspace = fused_mlp_v2.workspace_bytes(spec, rows)
        print(f"  dW/db worst ||err||/||plain||={max(rels):.3e} over {len(rels)} tensors (bound "
              f"{BWD_DW_REL}); two runs bit-identical: {same}; workspace {workspace} B")
        check(all(bool(torch.isfinite(t).all()) for t in (dx, *dflat)) and dx.shape == x.shape,
              f"fused v2 backward kernel gave non-finite or misshapen gradients (add {add})")
        check(max(rels) <= BWD_DW_REL, f"fused v2 backward kernel's dW disagree (add {add})")
        check(same, f"fused v2 backward kernel is not bit-identical with a prefix (add {add})")
        del dflat, dx, again_flat, again_dx, want_flat, want_dx, exact
        b_shapes[key] = {"max_abs_err": max_err, "rel_err": rel_err}
        c_shapes[key] = {"max_abs_err": dx_abs_err,
                         "dx": reading, "dw_rel_err": max(rels), "bit_identical": same,
                         "workspace_bytes": workspace}
        if not timed:
            continue
        flops = 2 * mlp_macs(spec) * rows
        for shapes, what, fn, plain, reps, mult, io_floats in (
                (b_shapes, "B", lambda: fused_mlp_v2.fused_forward_cuda(spec, net, x),
                 lambda: fused_mlp_v2.reference_forward_raw(spec, flat, x), 20, 1, add + 6 + 4),
                (c_shapes, "C", lambda: fused_mlp_v2.fused_backward_cuda(spec, net, x, g),
                 lambda: fused_mlp_v2.reference_backward_raw(spec, flat, x, g), 5, 3,
                 2 * (add + 6) + 4)):
            with torch.no_grad():
                ms = time_ms(fn)
                plain_ms = time_ms(plain, reps=reps)
            device_ms = kernel_device_ms("fused_mlp_v2_fwd" if what == "B" else "fused_mlp_v2_bwd",
                                         fn, reps=5)
            bytes_moved = rows * io_floats * 4 + n_params * (2 if what == "B" else 2 + 4)
            ops_ms = 1e3 * mult * flops / PEAK_BF16_FLOPS
            bytes_ms = 1e3 * bytes_moved / PEAK_BYTES_PER_S
            print(f"  kernel {what} with a prefix, N={rows} add={add}: {ms:.4f} ms (events), "
                  f"{device_ms:.4f} ms on the device (profiler), plain {plain_ms:.4f} ms, bound "
                  f"by operations {ops_ms:.5f} ms ({mult * flops:.4g} FLOP; {mlp_macs(spec)} "
                  f"MAC/sample), by bytes {bytes_ms:.5f} ms ({bytes_moved} B), "
                  f"{100 * max(ops_ms, bytes_ms) / ms:.1f} % of the bound")
            shapes[key].update({"ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
                                "bound_ms": max(ops_ms, bytes_ms),
                                "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"})
    head = f"621:{MLP_ROWS}"
    entries = []
    for name, shapes, replaces in (("fused_mlp_v2_fwd", b_shapes, "128"),
                                   ("fused_mlp_v2_bwd", c_shapes, "157")):
        entries.append({"name": f"{name}_prefix", "counter": name, "route": "cuda",
                        "source": f"smpl_nerf_tpu_torch/csrc/{name}.cu",
                        "replaces": f"smpl_nerf_tpu/ops/fused_mlp_v2.py:{replaces}",
                        "parity_ok": True,
                        **{k: shapes[head][k] for k in ("max_abs_err", "ms", "device_ms",
                                                         "plain_ms", "bound_ms", "bound_by")},
                        "library_ms": None, "by_shape": shapes})
    return tuple(entries)


def expert_plan_inputs(device, seed: int, n_experts: int, touched: int, mean_count: float,
                       budget: int):
    """A seeded sorted-tile plan and its slot inputs: `touched` experts with
    exponentially spread token counts (so some fill several tiles), as many
    skipped tokens again, padding slots in every run and empty trailing tiles."""
    from smpl_nerf_tpu_torch.parallel import ep

    rng = np.random.RandomState(seed)
    counts = np.maximum(1, rng.exponential(mean_count, touched).astype(np.int64))
    ids = np.repeat(rng.choice(n_experts, touched, replace=False), counts)
    ids = np.concatenate([ids, np.full(len(ids) // 2, n_experts)])      # skip-routed tokens
    rng.shuffle(ids)
    plan = ep.sorted_tile_plan(torch.as_tensor(ids, device=device), n_experts, budget,
                               EXPERT_TILE)
    check(int(plan.overflow.sum()) == 0, "the seeded expert plan overflows its budget")
    check(not bool(plan.valid[-EXPERT_TILE:].any()) and not bool(plan.valid.all()),
          "the seeded expert plan has no empty trailing tile or no padding")
    g = torch.Generator(device=device).manual_seed(seed)
    local = torch.rand(budget, 3, generator=g, device=device)
    dirs = torch.randn(budget, 3, generator=g, device=device)
    dirs = (dirs / dirs.norm(dim=-1, keepdim=True)).contiguous()
    experts = ep.ExpertMLP(
        0.3 * torch.randn(n_experts, EXPERT_D, EXPERT_H, generator=g, device=device),
        0.1 * torch.randn(n_experts, EXPERT_H, generator=g, device=device),
        0.3 * torch.randn(n_experts, EXPERT_H, 4, generator=g, device=device),
        0.1 * torch.randn(n_experts, 4, generator=g, device=device))
    return experts, local, dirs, plan


def expert_tiles_variant(name: str, experts, local, dirs, plan, dtype) -> dict:
    """Kernel E against its plain version on one plan's slots: parity, CUDA-event
    times of both, and the bound from what this plan needs."""
    from smpl_nerf_tpu_torch.ops import expert_tiles

    L, n_experts = plan.valid.shape[0], experts.w0.shape[0]
    n_valid = int(plan.valid.sum())
    used = plan.valid.view(-1, EXPERT_TILE).any(-1)
    touched = int(torch.unique(plan.tile_expert[used]).numel())
    kw = dict(l_pos=L_POS, l_dir=L_DIR, tile=EXPERT_TILE, compute_dtype=dtype)
    args = (experts, local, dirs, plan.valid, plan.tile_expert)
    with torch.no_grad():
        got = expert_tiles.expert_tiles_cuda(*args, **kw)
        want = expert_tiles.expert_tiles_reference(*args, **kw)
        torch.cuda.synchronize()
        ms = time_ms(lambda: expert_tiles.expert_tiles_cuda(*args, **kw))
        plain_ms = time_ms(lambda: expert_tiles.expert_tiles_reference(*args, **kw))
        device_ms = kernel_device_ms("expert_tiles",
                                     lambda: expert_tiles.expert_tiles_cuda(*args, **kw))
    err, scale = float((got - want).abs().max()), float(want.abs().max())
    bound = EXPERT_BF16_ABS if dtype is not None else EXPERT_F32_REL * max(1.0, scale)
    # every slot's mask read and output written; position and direction read
    # only for the slots that hold a token; the tile table; each touched
    # expert's weights read once. Arithmetic only for the slots that hold a token
    per_weights = EXPERT_D * EXPERT_H + EXPERT_H + EXPERT_H * 4 + 4
    bytes_moved = L * (1 + 16) + n_valid * (12 + 12) + 4 * (L // EXPERT_TILE) \
        + 4 * touched * per_weights
    flops = 2 * n_valid * (EXPERT_D * EXPERT_H + EXPERT_H * 4)
    bytes_ms = 1e3 * bytes_moved / PEAK_BYTES_PER_S
    ops_ms = 1e3 * flops / (PEAK_BF16_FLOPS if dtype is not None else PEAK_F32_FLOPS)
    print(f"kernel E expert_tiles {name}: E={n_experts} L={L} ({n_valid} valid slots, "
          f"{touched} experts touched) D={EXPERT_D} H={EXPERT_H} O=4 tile {EXPERT_TILE}: "
          f"max|err|={err:.3e} (max|plain| {scale:.3e}, bound {bound:.3e})")
    print(f"  time: kernel {ms:.4f} ms per call (events), {device_ms:.4f} ms on the device "
          f"(profiler), plain {plain_ms:.4f} ms, bound by bytes {bytes_ms:.5f} ms "
          f"({bytes_moved} B), by operations {ops_ms:.5f} ms ({flops:.4g} FLOP at the "
          f"{'bf16' if dtype is not None else 'float32'} peak), "
          f"{100 * max(bytes_ms, ops_ms) / device_ms:.1f} % of the bound on the device")
    check(bool(torch.isfinite(got).all()), f"expert_tiles {name} gave non-finite outputs")
    check(float(got[~plan.valid].abs().max()) == 0.0,
          f"expert_tiles {name} wrote non-zeros into invalid slots")
    check(err <= bound, f"expert_tiles {name} disagrees with its plain version")
    return {"max_abs_err": err, "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "slots": L, "valid_slots": n_valid, "experts": n_experts,
            "experts_touched": touched}


def phase_expert_tiles(device) -> dict:
    """Kernel E against its plain version at two seeded stream shapes (the
    full 8000-expert field and a small compact field), in bf16 and float32.
    The entry's headline numbers come later, from the plan that the distill
    path itself launches (`phase_distill`)."""
    shapes = {"full": (0, 8000, 1000, 220.0, 413696), "ess": (1, 329, 150, 150.0, 57344)}
    variants = {}
    for shape, (seed, n_experts, touched, mean_count, L) in shapes.items():
        experts, local, dirs, plan = expert_plan_inputs(device, seed, n_experts, touched,
                                                        mean_count, L)
        for dtype in (torch.bfloat16, None):
            name = f"{shape}_{'bf16' if dtype is not None else 'f32'}"
            variants[name] = expert_tiles_variant(name, experts, local, dirs, plan, dtype)
    return {"name": "expert_tiles", "route": "cuda",
            "source": "smpl_nerf_tpu_torch/csrc/expert_tiles.cu",
            "replaces": "smpl_nerf_tpu/ops/expert_tiles_pallas.py:68",
            "parity_ok": True, "library_ms": None, "variants": variants}


def phase_relu_matmul(device) -> dict:
    """Kernel F against its plain version and the library call, one layer of
    the roofline chain at each width. The entry's headline is W=256."""
    from smpl_nerf_tpu_torch.ops import relu_matmul

    by_width = {}
    for W in RELU_WIDTHS:
        g = torch.Generator(device=device).manual_seed(W)
        x = torch.randn(RELU_ROWS, W, generator=g, device=device).to(torch.bfloat16)
        w = (0.05 * torch.randn(W, W, generator=g, device=device)).to(torch.bfloat16)
        got = relu_matmul.relu_matmul_cuda(x, w)
        want = relu_matmul.relu_matmul_reference(x, w)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs()
        excess = float((err - RELU_REL * want.float().abs()).max())
        ms = time_ms(lambda: relu_matmul.relu_matmul_cuda(x, w))
        plain_ms = time_ms(lambda: relu_matmul.relu_matmul_reference(x, w))
        library_ms = time_ms(lambda: torch.relu(x @ w))
        flops = 2 * RELU_ROWS * W * W
        bytes_moved = 2 * (2 * RELU_ROWS * W + W * W)
        ops_ms, bytes_ms = 1e3 * flops / PEAK_BF16_FLOPS, 1e3 * bytes_moved / PEAK_BYTES_PER_S
        print(f"kernel F relu_matmul n={RELU_ROWS} W={W} bf16: max|err|={float(err.max()):.3e}, "
              f"largest |err| - 2^-7 |plain| = {excess:.3e} (bound {RELU_ABS})")
        print(f"  time: kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), plain "
              f"{plain_ms:.4f} ms, library torch.relu(x @ w) {library_ms:.4f} ms, bound by bytes "
              f"{bytes_ms:.5f} ms ({bytes_moved} B), by operations {ops_ms:.5f} ms "
              f"({flops:.4g} FLOP)")
        check(bool(torch.isfinite(got.float()).all()), "relu_matmul gave non-finite outputs")
        check(excess <= RELU_ABS, f"relu_matmul W={W} disagrees with its plain version")
        by_width[str(W)] = {"max_abs_err": float(err.max()), "ms": ms, "plain_ms": plain_ms,
                            "library_ms": library_ms, "bound_ms": max(ops_ms, bytes_ms),
                            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}
    head = by_width["256"]
    return {"name": "relu_matmul", "route": "cuda",
            "source": "smpl_nerf_tpu_torch/csrc/relu_matmul.cu",
            "replaces": "scripts/mlp_roofline.py:69", "parity_ok": True, **head,
            "by_width": by_width}


def attention_inputs(gen, R: int, S: int, V: int, device, meshes: int = 8) -> tuple:
    """Kernel G's inputs: rays from a circle of radius 2.4 at a body-sized box
    of V vertices, S samples a ray between 1 and 4, each ray's mesh and warp
    vectors gathered from `meshes` poses as the pipeline gathers its table."""
    table = gen.uniform(-1, 1, (meshes, V, 3)) * np.array([0.4, 0.9, 0.25])
    warp_table = gen.normal(0, 0.05, (meshes, V, 3))
    pick = gen.randint(0, meshes, R)
    angle = gen.uniform(0, 2 * np.pi, R)
    origins = np.stack([2.4 * np.cos(angle), gen.normal(0, 0.1, R), 2.4 * np.sin(angle)], -1)
    dirs = table[pick, gen.randint(0, V, R)] + gen.normal(0, 0.05, (R, 3)) - origins
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    z = np.linspace(1.0, 4.0, S)[None, :] + gen.uniform(0, 3.0 / S, (R, S))
    samples = origins[:, None, :] + z[..., None] * dirs[:, None, :]
    return tuple(torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)
                 for a in (samples, table[pick], warp_table[pick]))


def phase_vertex_attention(device) -> dict:
    """Kernel G against the eager path at a dummy_dynamic.train step's shapes
    (ATT_R rays x ATT_S samples over ATT_V vertices, the cell's radius and
    temperature), twice (bit for bit), with event and device times of both
    and the bound of port_bench/counts_dynamic.py; also at the cell's
    validation batch (ATT_R_VAL rays)."""
    from port_bench import counts_dynamic
    from smpl_nerf_tpu_torch.ops import vertex_attention as va

    by_rays = {}
    for R in (ATT_R, ATT_R_VAL):
        s, g, w = attention_inputs(np.random.RandomState(R), R, ATT_S, ATT_V, device)
        args = (s, g, w, ATT_RADIUS, ATT_T)
        got = va.vertex_attention_cuda(*args)
        again = va.vertex_attention_cuda(*args)
        want = va.vertex_attention_eager(*args)
        torch.cuda.synchronize()
        gap = float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)
        carried = float((got.abs().amax(-1) > 0).float().mean())
        ms = time_ms(lambda: va.vertex_attention_cuda(*args))
        device_ms = kernel_device_ms("vertex_attention", lambda: va.vertex_attention_cuda(*args))
        plain_ms = time_ms(lambda: va.vertex_attention_eager(*args), reps=5, warmup=1)
        pairs = R * ATT_S * ATT_V
        bound_ms = 1e3 * counts_dynamic.attention_bound_s(pairs)
        print(f"kernel G vertex_attention R={R} S={ATT_S} V={ATT_V} radius {ATT_RADIUS} "
              f"T {ATT_T}: max|err| / max|eager| = {gap:.3e} (bound {ATT_REL}), bit-identical "
              f"twice {torch.equal(got, again)}, samples with a warp {100 * carried:.2f} %")
        print(f"  time: kernel {ms:.4f} ms (device {device_ms:.4f}), plain (eager) "
              f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms (operations, {pairs} pairs): "
              f"{100 * bound_ms / device_ms:.1f} % of it")
        check(bool(torch.isfinite(got).all()), "vertex_attention gave non-finite warps")
        check(torch.equal(got, again), "vertex_attention differs from run to run")
        check(gap <= ATT_REL, f"vertex_attention R={R} disagrees with the eager path")
        by_rays[str(R)] = {"max_rel_err": gap, "ms": ms, "device_ms": device_ms,
                           "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "operations"}
    return {"name": "vertex_attention", "route": "cuda",
            "source": "smpl_nerf_tpu_torch/csrc/vertex_attention.cu",
            "replaces": "none: smpl_nerf_tpu/ops/vertex_attention.py runs a lax.scan",
            "parity_ok": True, "library_ms": None, **by_rays[str(ATT_R)], "by_rays": by_rays}


def relu_attention_inputs(gen, R: int, S: int, device) -> tuple:
    """Kernel H's inputs: one mesh, port_bench's seeded 6,890-vertex body at
    rest (`body.make_body`) with warp vectors N(0, 0.05); rays from a circle
    of radius 2.4, half aimed at the body's vertices, half at a 2 m box
    around it (most of them miss, as most of a view's pixels do), S samples a
    ray between 1 and 4 (the cell's near and far)."""
    from port_bench import body as body_mod

    verts = body_mod.make_body(int(gen.randint(1 << 30)))["v_template"]
    V = len(verts)
    angle = gen.uniform(0, 2 * np.pi, R)
    origins = np.stack([2.4 * np.cos(angle), gen.normal(0, 0.1, R), 2.4 * np.sin(angle)], -1)
    target = np.where((np.arange(R) % 2 == 0)[:, None],
                      verts[gen.randint(0, V, R)] + gen.normal(0, 0.05, (R, 3)),
                      gen.uniform(-1, 1, (R, 3)))
    dirs = target - origins
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    z = np.linspace(1.0, 4.0, S)[None, :] + gen.uniform(0, 3.0 / S, (R, S))
    samples = origins[:, None, :] + z[..., None] * dirs[:, None, :]
    return tuple(torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)
                 for a in (samples, verts, gen.normal(0, 0.05, (V, 3))))


def phase_relu_attention(device) -> dict:
    """Kernel H against the eager path under autograd at an
    image_wise_dynamic.train step's shapes (RELU_R rays x ATT_S samples over
    the 6,890-vertex body, radius ATT_RADIUS; the goal vertices and the warps
    take a gradient, the samples none, as in the cell; then the samples' too):
    the forward's and each gradient's error, bit identity on a rerun, the
    share of pairs inside a sphere, event and device ms of H1 (the forward)
    and H2 (the backward) beside the eager forward and backward's, and the
    bound by operations."""
    from smpl_nerf_tpu_torch.ops import vertex_attention as va

    gen = np.random.RandomState(RELU_R + 24)
    s, g, w = relu_attention_inputs(gen, RELU_R, ATT_S, device)
    cot = torch.from_numpy(gen.normal(size=(RELU_R, ATT_S, 3)).astype(np.float32)).to(device)

    def step(fn, with_samples=False):
        leaves = [s.clone().requires_grad_(with_samples), g.clone().requires_grad_(True),
                  w.clone().requires_grad_(True)]
        out = fn(*leaves, ATT_RADIUS)
        wrt = leaves if with_samples else leaves[1:]
        return (out.detach(), *torch.autograd.grad(out, wrt, cot))

    got, again = step(va.relu_attention_cuda), step(va.relu_attention_cuda)
    got_s = step(va.relu_attention_cuda, True)
    want = step(va.relu_attention_eager, True)
    torch.cuda.synchronize()
    fwd_err = float((got[0] - want[0]).abs().max()) / max(float(want[0].abs().max()), 1e-30)
    errors = {"out": fwd_err}
    for name, a, b in zip(("samples", "goal", "warps"), got_s[1:], want[1:]):
        errors[name] = float((a - b).norm() / b.norm().clamp(min=1e-30))
        errors[name + "_max"] = (float((a - b).abs().max())
                                 / max(float(b.abs().max()), 1e-30))
    identical = all(torch.equal(a, b) for a, b in zip(got, again))
    with torch.no_grad():
        inside = sum(int((torch.relu(ATT_RADIUS - va._dist(s, g[None, lo:lo + 512])) > 0).sum())
                     for lo in range(0, len(g), 512))
    pairs = RELU_R * ATT_S * len(g)
    with torch.no_grad():
        fwd_ms = time_ms(lambda: va.relu_attention_cuda(s, g, w, ATT_RADIUS))
        h1_ms = kernel_device_ms("relu_attention", lambda: va.relu_attention_cuda(s, g, w,
                                                                                  ATT_RADIUS))
    step_ms = time_ms(lambda: step(va.relu_attention_cuda))
    h12_ms = kernel_device_ms("relu_attention", lambda: step(va.relu_attention_cuda))
    with torch.no_grad():
        plain_fwd_ms = time_ms(lambda: va.relu_attention_eager(s, g, w, ATT_RADIUS), reps=5,
                               warmup=1)
    plain_ms = time_ms(lambda: step(va.relu_attention_eager), reps=5, warmup=1)
    bound_ms = 1e3 * pairs * RELU_OPS_PER_PAIR / PEAK_F32_FLOPS
    print(f"kernel H relu_attention R={RELU_R} S={ATT_S} V={len(g)} radius {ATT_RADIUS}: "
          f"forward max|err| / max|eager| = {fwd_err:.3e} (bound {ATT_REL}); gradients "
          f"|err| / |eager| samples {errors['samples']:.3e}, goal {errors['goal']:.3e}, warps "
          f"{errors['warps']:.3e} (bound {RELU_GRAD_REL}; by max: samples "
          f"{errors['samples_max']:.3e}, goal {errors['goal_max']:.3e}, warps "
          f"{errors['warps_max']:.3e}); bit-identical twice {identical}; pairs inside a "
          f"sphere {inside} of {pairs} ({100 * inside / pairs:.3f} %)")
    print(f"  time: H1 forward {fwd_ms:.4f} ms (device {h1_ms:.4f}), H1 + H2 forward and "
          f"backward {step_ms:.4f} ms (device {h12_ms:.4f}; H2 {h12_ms - h1_ms:.4f}); eager "
          f"forward {plain_fwd_ms:.4f} ms, forward and backward {plain_ms:.4f} ms; bound "
          f"{bound_ms:.4f} ms (operations: {RELU_OPS_PER_PAIR} a pair at {PEAK_F32_FLOPS:.3g} "
          f"FLOP/s, {pairs} pairs): {100 * bound_ms / h12_ms:.1f} % of it")
    check(all(bool(torch.isfinite(t).all()) for t in got_s), "relu_attention gave non-finite "
          "values")
    check(identical, "relu_attention differs from run to run")
    check(fwd_err <= ATT_REL, "relu_attention's forward disagrees with the eager path")
    check(all(errors[k] <= RELU_GRAD_REL for k in ("samples", "goal", "warps")),
          "relu_attention's gradients disagree with the eager path's")
    return {"name": "relu_attention", "route": "cuda",
            "source": "smpl_nerf_tpu_torch/csrc/relu_attention.cu",
            "replaces": "none: smpl_nerf_tpu/ops/vertex_attention.py relu_attention_warp runs "
                        "a lax.scan", "parity_ok": True,
            "library_ms": None, "max_rel_err": errors, "ms": step_ms, "device_ms": h12_ms,
            "h1_ms": fwd_ms, "h1_device_ms": h1_ms, "h2_device_ms": h12_ms - h1_ms,
            "plain_ms": plain_ms, "plain_forward_ms": plain_fwd_ms, "bound_ms": bound_ms,
            "bound_by": "operations", "inside_share": inside / pairs}


def launch_counts() -> dict:
    from smpl_nerf_tpu_torch.ops import (expert_tiles, fused_mlp, fused_mlp_v2, relu_matmul,
                                         sample_pdf_cuda, vertex_attention)

    return {"sample_pdf": sample_pdf_cuda.launches, "fused_mlp_v2_fwd": fused_mlp_v2.launches,
            "fused_mlp_fwd": fused_mlp.launches, "fused_mlp_v2_bwd": fused_mlp_v2.launches_bwd,
            "expert_tiles": expert_tiles.launches, "relu_matmul": relu_matmul.launches,
            "vertex_attention": vertex_attention.launches,
            "relu_attention": vertex_attention.relu_launches}


def zero_launch_counts() -> None:
    from smpl_nerf_tpu_torch.ops import (expert_tiles, fused_mlp, fused_mlp_v2, relu_matmul,
                                         sample_pdf_cuda, vertex_attention)

    sample_pdf_cuda.launches = fused_mlp_v2.launches = 0
    fused_mlp.launches = fused_mlp_v2.launches_bwd = 0
    expert_tiles.launches = relu_matmul.launches = vertex_attention.launches = 0
    vertex_attention.relu_launches = 0


def write_runs(tmp: str, config_file: str, tag: str, kernel_flags: tuple, extra=(),
               fine_sigma_bias: float = 0.0, coarse_sigma_bias: float = 0.0) -> tuple:
    """Two run dirs with the same seeded full-width weights: the kernel path
    (--use_fused_mlp, --use_pallas = kernel_flags) and the plain path (0, 0);
    fine_sigma_bias and coarse_sigma_bias are added to the nets' sigma biases. A grid net's
    features are drawn from U(-1, 1) in place of its +-1e-4 init, so that its
    density varies in space as a trained grid's does."""
    from smpl_nerf_tpu_torch import config
    from smpl_nerf_tpu_torch.training import checkpoints, factory

    parser = config.config_parser()
    runs = []
    for name, (fused, pallas) in ((f"{tag}_kernel_run", kernel_flags), (f"{tag}_plain_run", (0, 0))):
        args = parser.parse_args([f"--config={config_file}", f"--use_fused_mlp={fused}",
                                  f"--use_pallas={pallas}", f"--batchsize_val={BATCH}", *extra])
        models, _ = factory.build_models_and_params(args, seed=0, device="cpu")
        gen = torch.Generator().manual_seed(5)
        with torch.no_grad():
            models["model_fine"].sigma_out_layer.bias += fine_sigma_bias
            models["model_coarse"].sigma_out_layer.bias += coarse_sigma_bias
            for key in ("model_coarse", "model_fine"):
                for grid in getattr(models[key], "grids", list)():
                    grid.uniform_(-1.0, 1.0, generator=gen)
        run_dir = os.path.join(tmp, name)
        checkpoints.save_run(run_dir, {k: m.state_dict() for k, m in models.items()},
                             args, parser)
        runs.append(run_dir)
    return tuple(runs)


def render(run_dir: str, out: str, views: int = VIEWS, res: int = RES, extra=(),
           radius: float = 2.4):
    from smpl_nerf_tpu_torch.cli import render_path

    t0 = time.perf_counter()
    got = render_path.main(["--run_dir", run_dir, "--camera_path", "circle",
                            "--number_steps", str(views), "--resolution", str(res),
                            "--human_pose_angle", str(POSE_ANGLE), "--out", out,
                            "--camera_radius", str(radius), "--batch_size", str(BATCH),
                            "--device", DEVICE, *extra])
    return got, time.perf_counter() - t0


def phase_render(tmp: str, what: str, config_file: str, kernel_flags: tuple, extra: tuple,
                 expected: dict) -> tuple:
    """Render VIEWS views through the kernel path (launch counts set to 0 just
    before, read just after, held against `expected` per batch) and through
    the plain path; compare pixels; time both in turns."""
    kernel_run, plain_run = write_runs(tmp, config_file, what, kernel_flags, extra)
    out = os.path.join(tmp, "views.npy")
    n_batches = -(-VIEWS * RES * RES // BATCH)

    zero_launch_counts()
    kernel_views, first_s = render(kernel_run, out)
    counts = launch_counts()
    print(f"{what}: render_path {VIEWS}x{RES}x{RES} {os.path.basename(config_file)} full width, "
          f"kernel path, {n_batches} batches of {BATCH} rays: launches {counts} in "
          f"{first_s:.2f} s (first call, weight pack included)")
    check(kernel_views.shape == (VIEWS, RES, RES, 3), f"bad render shape {kernel_views.shape}")
    check(bool(np.isfinite(kernel_views).all()), f"non-finite kernel render ({what})")
    for name, per_batch in expected.items():
        check(counts[name] == per_batch * n_batches,
              f"{what}: {name} launched {counts[name]} times, expected {per_batch * n_batches}")

    plain_views, _ = render(plain_run, out)                 # warm-up of the plain path
    check(bool(np.isfinite(plain_views).all()), f"non-finite plain render ({what})")
    diff = abs(kernel_views - plain_views)
    print(f"{what}: kernel path vs plain path pixels: max|diff|={diff.max():.4e} "
          f"(bound {PIXEL_MAX}), mean|diff|={diff.mean():.4e} (bound {PIXEL_MEAN})")
    check(float(diff.max()) <= PIXEL_MAX and float(diff.mean()) <= PIXEL_MEAN,
          f"{what}: kernel path and plain path renders disagree")

    seconds = {"plain": [], "kernel": []}
    for path in ("plain", "kernel", "kernel", "plain"):
        _, sec = render(plain_run if path == "plain" else kernel_run, out)
        seconds[path].append(sec)
    per_view = {k: 1e3 * statistics.mean(v) / VIEWS for k, v in seconds.items()}
    print(f"{what}: ms per {RES}x{RES} view through render_path (host clock, "
          f"plain/kernel/kernel/plain): kernel path {per_view['kernel']:.1f}, "
          f"plain path {per_view['plain']:.1f}")
    return counts, (kernel_run, plain_run)


def culled_rays(run_dir: str) -> tuple:
    """(pipeline, RayData, per-ray tensors on the card) of run_dir's culled
    camera path, as render_path builds them."""
    from smpl_nerf_tpu_torch.cli import render_path
    from smpl_nerf_tpu_torch.render import batched
    from smpl_nerf_tpu_torch.training import checkpoints

    device = torch.device(DEVICE)
    args = checkpoints.load_config(run_dir)
    pipeline = batched.build_from_run(run_dir, args, device)
    joints = None if args.model_type in ("nerf", "original_nerf") else args.human_joints
    data = render_path.camera_path_data("circle", VIEWS, CULL_RADIUS, -90, 90, RES, joints,
                                        POSE_ANGLE)
    rays = {"ray_translation": torch.as_tensor(data.origins, device=device),
            "ray_direction": torch.as_tensor(data.directions, device=device)}
    if data.human_poses is not None:
        rays["human_pose"] = torch.as_tensor(data.human_poses[data.image_indices], device=device)
    return pipeline, data, rays


def replay_batches(data, rays):
    """The batches render_rays_batched cuts: (lo, hi, batch)."""
    from smpl_nerf_tpu_torch.render import batched

    for _, lo, hi in batched.batch_bounds(data.num_rays, data.num_images, BATCH, False):
        idx = batched.padded_rows(lo, hi, BATCH, DEVICE)
        yield lo, hi, {key: v[idx] for key, v in rays.items()}


def fast_decisions(run_dir: str, picks=None) -> tuple:
    """Per ray of a `--fast 1` render of run_dir's culled camera path: its
    coarse colour, its coarse opacity, whether the renderer sent it through
    the fine pass (the FAST_CAP share of largest opacities of its batch,
    picked as `render/fast.py` picks them), from the same batches and the
    same passes; and, given `picks` (one bool per ray), the render this path
    gives with those picks instead of its own: coarse colour everywhere, the
    fine pass on the picked rays."""
    from smpl_nerf_tpu_torch.render import fast as fast_mod

    pipeline, data, rays = culled_rays(run_dir)
    passes = pipeline.passes
    k = int(BATCH * FAST_CAP)
    rgb, acc, chosen, forced = [], [], [], []
    with torch.no_grad():
        for lo, hi, batch in replay_batches(data, rays):
            origins, dirs = batch["ray_translation"], batch["ray_direction"]
            pose = passes.pose(batch)
            out, z_vals, _ = passes.coarse(origins, dirs, pose)
            picked = torch.zeros(BATCH, dtype=torch.bool, device=DEVICE)
            picked[fast_mod.top_k(out.acc, k)[1]] = True
            rgb.append(out.rgb.float()[:hi - lo])
            acc.append(out.acc.float()[:hi - lo])
            chosen.append(picked[:hi - lo])
            if picks is not None:
                sel = torch.nonzero(torch.as_tensor(picks[lo:hi], device=DEVICE))[:, 0]
                out_f, _ = passes.fine(origins[sel], dirs[sel], None if pose is None else
                                       pose[sel], z_vals[sel], out.weights[sel])
                composed = out.rgb.float()[:hi - lo].clone()
                composed[sel] = out_f.rgb.float()
                forced.append(composed)
    result = [torch.cat(t).cpu().numpy() for t in (rgb, acc, chosen)]
    return (*result, torch.cat(forced).cpu().numpy() if forced else None)


def fast_parity(what: str, runs: tuple, kernel_views: np.ndarray,
                plain_views: np.ndarray) -> None:
    """Kernel path against plain path for `--fast 1`, ray by ray. Which rays
    take the fine pass follows each path's own coarse opacities, and on these
    random weights many rays have opacity 1 to within rounding (their last
    sample's interval is 1e10 long), so the two paths' picks differ at the
    budget's edge. Checks: each path's picks reproduce its render (a ray left
    out kept its coarse colour, bit for bit); the paths' opacities agree within
    PIXEL_MAX; rays picked by both paths or by neither agree under the pixel
    bounds; a ray picked by one path only lies within twice the opacity
    difference of its batch's K-th opacity in both paths, as a top-K of
    scores that differ by at most that much must; and the kernel path's
    render agrees on every ray, under the pixel bounds, with the plain path's
    passes on the kernel path's own picks, a selection no tie can shift."""
    k = int(BATCH * FAST_CAP)
    decided = {}
    for path, run, views in (("kernel", runs[0], kernel_views),
                             ("plain", runs[1], plain_views)):
        coarse, acc, chosen, _ = fast_decisions(run)
        flat = views.reshape(-1, 3)
        check(np.array_equal(flat[~chosen], coarse[~chosen]),
              f"{what} --fast 1 ({path} path): a culled ray lost its coarse colour")
        decided[path] = (acc, chosen, flat)
    (acc_k, chosen_k, flat_k), (acc_p, chosen_p, flat_p) = decided["kernel"], decided["plain"]
    tol = float(abs(acc_k - acc_p).max())
    same = chosen_k == chosen_p
    diff = abs(flat_k - flat_p)[same]
    edge_ok = True
    for lo in range(0, acc_k.shape[0], BATCH):
        sl = slice(lo, lo + BATCH)
        kth_k = np.sort(acc_k[sl])[::-1][k - 1]
        kth_p = np.sort(acc_p[sl])[::-1][k - 1]
        odd = ~same[sl]
        edge_ok &= bool((abs(acc_k[sl][odd] - kth_k) <= 2 * tol).all()
                        and (abs(acc_p[sl][odd] - kth_p) <= 2 * tol).all())
    forced = abs(flat_k - fast_decisions(runs[1], picks=chosen_k)[3])
    print(f"{what} --fast 1: kernel path vs plain path: coarse opacity max|diff|={tol:.4e} "
          f"(bound {PIXEL_MAX}); {int((~same).sum())} of {same.size} rays picked by one path "
          f"only, all at the budget's edge: {edge_ok}; on the rays both paths treat alike, "
          f"pixels max|diff|={diff.max():.4e} (bound {PIXEL_MAX}), mean|diff|="
          f"{diff.mean():.4e} (bound {PIXEL_MEAN}); over every ray max|diff|="
          f"{abs(flat_k - flat_p).max():.4e}, mean {abs(flat_k - flat_p).mean():.4e}; "
          f"against the plain path on the kernel path's picks, every ray: max|diff|="
          f"{forced.max():.4e}, mean|diff|={forced.mean():.4e}")
    check(tol <= PIXEL_MAX, f"{what} --fast 1: the paths' coarse opacities disagree")
    check(edge_ok, f"{what} --fast 1: a ray picked by one path only is not at the budget's edge")
    check(float(diff.max()) <= PIXEL_MAX and float(diff.mean()) <= PIXEL_MEAN,
          f"{what} --fast 1: kernel path and plain path renders disagree")
    check(float(forced.max()) <= PIXEL_MAX and float(forced.mean()) <= PIXEL_MEAN,
          f"{what} --fast 1: the kernel path disagrees with the plain path on its own picks")


def occupancy_decisions(run_dir: str) -> tuple:
    """(cap, scores, chosen) per ray of a `--fast 2` render of run_dir's
    culled camera path: the auto budget, each ray's grid score and whether
    the renderer rendered it, replayed as cli/inference.render_dataset and
    render/fast.py do (one pose on the path: one grid for every batch)."""
    from smpl_nerf_tpu_torch.cli import inference
    from smpl_nerf_tpu_torch.render import fast as fast_mod

    pipeline, data, rays = culled_rays(run_dir)
    cap, grids = inference._auto_cap_fraction(pipeline, data, data.human_poses, False, BATCH)
    occ = fast_mod.make_occupancy_renderer(pipeline, cap, warn_saturation=False,
                                           warn_background=False)
    grid = grids[0].to(DEVICE)
    scores, chosen = [], []
    with torch.no_grad():
        for lo, hi, batch in replay_batches(data, rays):
            s = occ.ray_scores(grid, batch["ray_translation"], batch["ray_direction"])
            picked = torch.zeros(BATCH, dtype=torch.bool, device=DEVICE)
            picked[fast_mod.top_k(s, max(1, int(BATCH * cap)))[1]] = True
            scores.append(s[:hi - lo])
            chosen.append(picked[:hi - lo])
    return cap, torch.cat(scores).cpu().numpy(), torch.cat(chosen).cpu().numpy()


def occupancy_parity(what: str, runs: tuple, kernel_views: np.ndarray,
                     plain_views: np.ndarray) -> None:
    """Kernel path against plain path for `--fast 2`, ray by ray. Checks: the
    auto budget lies below the batch (the render culls); each path's choice
    reproduces its render (a culled ray holds the background colour, bit for
    bit); every ray whose score clears the threshold in either path is
    rendered by both; a ray rendered by one path only is below the threshold
    in both (the budget's rest, taken below the threshold, ties by index);
    the rays both paths treat alike agree under the pixel bounds."""
    from smpl_nerf_tpu_torch.ops import occupancy
    from smpl_nerf_tpu_torch.training import checkpoints

    bg = 1.0 if int(checkpoints.load_config(runs[0]).white_background) else 0.0
    decided = {}
    for path, run, views in (("kernel", runs[0], kernel_views),
                             ("plain", runs[1], plain_views)):
        cap, scores, chosen = occupancy_decisions(run)
        flat = views.reshape(-1, 3)
        check(cap < 1.0, f"{what} --fast 2 ({path} path): the auto budget {cap} culls nothing")
        check(bool((flat[~chosen] == bg).all()),
              f"{what} --fast 2 ({path} path): a culled ray is not the background colour")
        decided[path] = (cap, scores > occupancy.OCC_THRESHOLD, chosen, flat)
    (cap_k, fg_k, chosen_k, flat_k), (cap_p, fg_p, chosen_p, flat_p) = (decided["kernel"],
                                                                        decided["plain"])
    fg = fg_k | fg_p
    same = chosen_k == chosen_p
    diff = abs(flat_k - flat_p)[same]
    K = max(1, int(BATCH * cap_k))
    print(f"{what} --fast 2: auto budget kernel path {cap_k:.4f} (K={K} of {BATCH}, "
          f"{K % 128} rays past a whole 128), plain path {cap_p:.4f}; foreground "
          f"{int(fg_k.sum())} / {int(fg_p.sum())} of {fg.size} rays, rendered {int(chosen_k.sum())}"
          f" / {int(chosen_p.sum())}; {int((~same).sum())} rays rendered by one path only; "
          f"on the rays both paths treat alike pixels max|diff|={diff.max():.4e} (bound "
          f"{PIXEL_MAX}), mean|diff|={diff.mean():.4e} (bound {PIXEL_MEAN})")
    check(bool((chosen_k & chosen_p)[fg].all()),
          f"{what} --fast 2: a foreground ray was culled by a path")
    check(not bool(fg[~same].any()),
          f"{what} --fast 2: a ray rendered by one path only clears the threshold")
    check(float(diff.max()) <= PIXEL_MAX and float(diff.mean()) <= PIXEL_MEAN,
          f"{what} --fast 2: kernel path and plain path renders disagree")


def phase_culled(tmp: str, what: str, config_file: str, kernel_flags: tuple, extra: tuple,
                 net_kernel: str) -> tuple:
    """`render_path --fast 1` (cap 0.25) and `--fast 2` (auto cap) of one
    family's full-width runs, seen from CULL_RADIUS: launch counts set to 0
    just before and read just after each kernel-path render, held per batch
    and per grid bake; kernel path against plain path, ray by ray; --fast 1
    --cap_fraction 1 against the full render; the bake timed apart (CUDA
    events); ms per view of the full, fast and occupancy renders in turns;
    one profiled kernel-path render of each. Returns ({path: launch counts},
    {path: device ms})."""
    from smpl_nerf_tpu_torch.render import batched
    from smpl_nerf_tpu_torch.render import fast as fast_mod
    from smpl_nerf_tpu_torch.training import checkpoints

    near, far = CULL_NEAR_FAR
    runs = write_runs(tmp, config_file, f"{what}_culled", kernel_flags,
                      (*extra, f"--near={near}", f"--far={far}"), CULL_FINE_SIGMA_BIAS,
                      CULL_COARSE_SIGMA_BIAS)
    kernel_run, plain_run = runs
    out = os.path.join(tmp, "views.npy")
    n_batches = -(-VIEWS * RES * RES // BATCH)
    paths, device_ms = {}, {}
    for fast, name in ((1, "fast"), (2, "occupancy")):
        flags = ("--fast", str(fast))
        zero_launch_counts()
        views, first_s = render(kernel_run, out, extra=flags, radius=CULL_RADIUS)
        counts = launch_counts()
        # one shared body pose on the camera path: one grid, baked by the
        # budget's probe pass and reused by every batch
        bakes = 1 if fast == 2 else 0
        expected = {"sample_pdf": n_batches, net_kernel: 2 * n_batches + bakes}
        print(f"{what} --fast {fast}: render_path {VIEWS}x{RES}x{RES} from radius "
              f"{CULL_RADIUS}, {n_batches} batches of {BATCH} rays: launches {counts} in "
              f"{first_s:.2f} s; per batch A {counts['sample_pdf'] / n_batches:g}, {net_kernel} "
              f"{(counts[net_kernel] - bakes) / n_batches:g}; grid bake {bakes} x {net_kernel}")
        for kernel, got in counts.items():
            want = expected.get(kernel, 0)
            check(got == want, f"{what} --fast {fast}: {kernel} launched {got} times, "
                               f"expected {want}")
        check(views.shape == (VIEWS, RES, RES, 3) and bool(np.isfinite(views).all()),
              f"{what} --fast {fast}: bad kernel-path render")
        plain_views, _ = render(plain_run, out, extra=flags, radius=CULL_RADIUS)
        check(bool(np.isfinite(plain_views).all()), f"{what} --fast {fast}: bad plain render")
        if fast == 1:
            fast_parity(what, runs, views, plain_views)
        else:
            occupancy_parity(what, runs, views, plain_views)
        paths[f"{what}_{name}"] = counts
    full_views, _ = render(kernel_run, out, radius=CULL_RADIUS)
    capped, _ = render(kernel_run, out, extra=("--fast", "1", "--cap_fraction", "1"),
                       radius=CULL_RADIUS)
    cap_err = float(abs(capped - full_views).max())
    print(f"{what} --fast 1 --cap_fraction 1 vs the full render (kernel path): max|diff|="
          f"{cap_err:.4e} (bound {CAP1_MAX})")
    check(cap_err <= CAP1_MAX, f"{what}: --fast 1 --cap_fraction 1 differs from the full render")

    bake_ms = {}
    for path, run in (("kernel", kernel_run), ("plain", plain_run)):
        args = checkpoints.load_config(run)
        pipe = batched.build_from_run(run, args, torch.device(DEVICE))
        occ = fast_mod.make_occupancy_renderer(pipe, 1.0, warn_background=False)
        pose = torch.zeros(1, 69, device=DEVICE)
        pose[0, [int(j) for j in args.human_joints]] = float(np.deg2rad(POSE_ANGLE))
        bake_ms[path] = time_ms(lambda: occ.build_grid({"human_pose": pose}), reps=5,
                                warmup=1)
    print(f"{what}: grid bake (64^3 = 262,144 lattice rows through the coarse net, CUDA "
          f"events, median of 5): kernel path {bake_ms['kernel']:.3f} ms, plain path "
          f"{bake_ms['plain']:.3f} ms")

    seconds = {(path, mode): [] for path in ("plain", "kernel") for mode in (0, 1, 2)}
    for path in ("plain", "kernel", "kernel", "plain"):
        for mode in (0, 1, 2):
            _, sec = render(plain_run if path == "plain" else kernel_run, out,
                            extra=("--fast", str(mode)), radius=CULL_RADIUS)
            seconds[(path, mode)].append(sec)
    per_view = {key: 1e3 * statistics.mean(v) / VIEWS for key, v in seconds.items()}
    for path in ("kernel", "plain"):
        turns = {mode: " ".join(f"{1e3 * sec / VIEWS:.1f}" for sec in seconds[(path, mode)])
                 for mode in (0, 1, 2)}
        print(f"{what}: ms per {RES}x{RES} view through render_path from radius "
              f"{CULL_RADIUS} (host clock, plain/kernel/kernel/plain), {path} path: full "
              f"{per_view[(path, 0)]:.1f} ({turns[0]}), fast {per_view[(path, 1)]:.1f} "
              f"({turns[1]}), occupancy {per_view[(path, 2)]:.1f} ({turns[2]}; budget probe "
              f"pass and bake included)")
    for fast, name in ((0, "full_from_cull_radius"), (1, "fast"), (2, "occupancy")):
        device_ms[f"{what}_{name}"] = profiled(
            f"kernel-path {what} --fast {fast} render of {VIEWS} views from radius "
            f"{CULL_RADIUS}",
            lambda: render(kernel_run, out, extra=("--fast", str(fast)), radius=CULL_RADIUS))
    return paths, device_ms


def phase_odd_k(device) -> dict:
    """Kernels A, B, C and D at a culled fine pass's shapes: K = ODD_K rays of
    a 2048-ray batch (an auto-cap budget), so K, K*64, K*128 and K*192 rows,
    none a multiple of a 128-row tile, against their plain versions."""
    from smpl_nerf_tpu_torch.core import sampling
    from smpl_nerf_tpu_torch.ops import fused_mlp, fused_mlp_v2, sample_pdf_cuda

    K = ODD_K
    g = torch.Generator(device=device).manual_seed(8)
    bins = torch.sort(1.0 + 3.0 * torch.rand(K, PDF_K, generator=g, device=device), -1)[0]
    weights = torch.rand(K, PDF_K - 1, generator=g, device=device)
    weights = torch.where(torch.rand(weights.shape, generator=g, device=device) < 0.3,
                          torch.zeros_like(weights), weights)
    got = sample_pdf_cuda.sample_pdf_cuda(bins, weights, PDF_F)
    want = sampling.sample_pdf(bins, weights, PDF_F)
    err = (got - want).abs()
    widest = float((bins[:, 1:] - bins[:, :-1]).max())
    off_share = float((err > 1e-4).float().mean())
    print(f"odd K: kernel A R={K}: max|err|={float(err.max()):.3e} (bound: widest bin "
          f"{widest:.3e}), share off by >1e-4 {off_share:.3e} (bound {PDF_OFF_SHARE})")
    check(bool(torch.isfinite(got).all()) and float(err.max()) <= widest
          and off_share <= PDF_OFF_SHARE, f"sample_pdf kernel disagrees at R={K}")
    result = {"sample_pdf": {"rays": K, "max_abs_err": float(err.max())}}
    for name, module, add, row_counts in (("fused_mlp_v2_fwd", fused_mlp_v2, 0, (64, 192)),
                                          ("fused_mlp_fwd", fused_mlp, 621, (64, 128))):
        net = full_width_net(device, seed=1 if add == 0 else 3, additional_input_dim=add)
        spec = fused_mlp.spec_from_model(net)
        flat = fused_mlp.flatten_params(spec, net)
        result[name] = {}
        for per_ray in row_counts:
            rows = K * per_ray
            if add == 0:
                x = raw_rows(device, seed=9, rows=rows)
                reference = fused_mlp_v2.reference_forward_raw
            else:
                x = 2.0 * torch.rand(rows, spec.in_dim, generator=g, device=device) - 1.0
                reference = fused_mlp.reference_forward
            with torch.no_grad():
                got = module.fused_forward_cuda(spec, net, x)
                want = reference(spec, flat, x)
            print(f"odd K: kernel {name} N={rows} ({K} rays x {per_ray} samples, "
                  f"{rows % 128} rows past the last whole 128-row tile):")
            result[name][str(rows)] = forward_parity(name, got, want)[0]
    result["fused_mlp_v2_bwd"] = odd_k_backward(device, K * 192)
    return result


def odd_k_backward(device, rows: int) -> dict:
    """Kernel C at a culled fine pass's rows, held as phase 3 holds it, except
    that dX's largest error is taken against the float64 gradient of the
    same rounded forward (`fused_mlp_v2.exact_backward_dx`): the plain
    version rounds its cotangents to bf16 too, and is itself that far off on
    some rows. Three inputs: the card test's case (net seed 256 + rows, rows
    and cotangent from numpy's RandomState(0)) and two of this script's."""
    from smpl_nerf_tpu_torch.ops import fused_mlp, fused_mlp_v2

    readings = []
    for label, net_seed, row_seed in (("card test's case", 256 + rows, None),
                                      ("seed 11", 11, 12), ("seed 13", 13, 14)):
        net = full_width_net(device, seed=net_seed)
        spec = fused_mlp.spec_from_model(net)
        flat = fused_mlp.flatten_params(spec, net)
        if row_seed is None:
            rng = np.random.RandomState(0)
            p3 = rng.uniform(-2, 2, (rows, 3)).astype(np.float32)
            d3 = rng.randn(rows, 3).astype(np.float32)
            d3 /= np.linalg.norm(d3, axis=-1, keepdims=True)
            x = torch.from_numpy(np.concatenate([p3, d3], -1)).to(device)
            g = torch.from_numpy(rng.randn(rows, 4).astype(np.float32)).to(device) / rows
        else:
            x = raw_rows(device, seed=row_seed, rows=rows)
            gen = torch.Generator(device=device).manual_seed(row_seed)
            g = torch.randn(rows, 4, generator=gen, device=device) / rows
        dflat, dx = fused_mlp_v2.fused_backward_cuda(spec, net, x, g)
        want_flat, want_dx = fused_mlp_v2.reference_backward_raw(spec, flat, x, g)
        exact = fused_mlp_v2.exact_backward_dx(spec, flat, x, g)
        scale_max, scale_mean = float(want_dx.abs().max()), float(want_dx.abs().mean())
        to_plain = (dx - want_dx).abs()
        kernel_exact = (dx.double() - exact).abs().amax(-1)
        plain_exact = (want_dx.double() - exact).abs().amax(-1)
        worst = int(to_plain.amax(-1).argmax())
        rels = [float((a - b).norm() / b.norm()) for a, b in zip(dflat, want_flat)]
        reading = {"input": label, "dx_max_to_plain": float(to_plain.max()) / scale_max,
                   "dx_max_to_exact": float(kernel_exact.max()) / scale_max,
                   "plain_dx_max_to_exact": float(plain_exact.max()) / scale_max,
                   "dx_mean_to_plain": float(to_plain.mean()) / scale_mean,
                   "dw_rel": max(rels)}
        print(f"odd K: kernel C N={rows} ({label}): dX max|err| / max|plain dX|: against the "
              f"plain version {reading['dx_max_to_plain']:.4f}, against the float64 gradient "
              f"{reading['dx_max_to_exact']:.4f} (bound {BWD_DX_MAX}; the plain version's own "
              f"{reading['plain_dx_max_to_exact']:.4f}); worst row against the plain version "
              f"{worst}: kernel {float(kernel_exact[worst]):.3e}, plain "
              f"{float(plain_exact[worst]):.3e} from the float64 gradient; dX mean|err| rel "
              f"{reading['dx_mean_to_plain']:.3e} (bound {BWD_DX_MEAN}); dW/db worst rel "
              f"{reading['dw_rel']:.3e} (bound {BWD_DW_REL})")
        check(all(bool(torch.isfinite(t).all()) for t in (dx, *dflat))
              and reading["dx_max_to_exact"] <= BWD_DX_MAX
              and reading["dx_mean_to_plain"] <= BWD_DX_MEAN and max(rels) <= BWD_DW_REL,
              f"fused v2 backward kernel disagrees at N={rows} ({label})")
        readings.append(reading)
        del dflat, dx, want_flat, want_dx, exact
    return {"rows": rows, "readings": readings}


# per wrapper: the device kernels of one launch (C's launch runs three; the
# first one counts the launches)
KERNEL_SYMBOLS = (("sample_pdf", ("sample_pdf_kernel",)),
                  ("fused_mlp_v2_fwd", ("fused_mlp_v2_fwd_kernel",)),
                  ("fused_mlp_fwd", ("fused_mlp_fwd_kernel",)),
                  ("fused_mlp_v2_bwd", ("fused_mlp_v2_bwd_kernel", "fused_mlp_v2_dw_kernel",
                                        "fused_mlp_v2_dw_reduce_kernel")),
                  ("expert_tiles", ("expert_tiles_kernel",)),
                  ("relu_matmul", ("relu_matmul_kernel",)),
                  ("vertex_attention", ("vertex_attention_max_kernel",
                                        "vertex_attention_sum_kernel")),
                  ("relu_attention", ("relu_attention_rows_kernel", "relu_attention_vertex_kernel",
                                      "relu_attention_reduce_kernel")))


def profiled(what: str, fn, top: int = 10) -> dict:
    """Run fn under torch.profiler: device time by kernel name (the `top`
    first), the device's busy share of fn's host-clock time, and the device ms
    per launch of each port kernel that ran."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    # device-side events only (kernels, copies): a CPU op's row repeats the
    # device time of the kernels it launched
    rows = [(e.key, e.count, e.self_device_time_total) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    rows = sorted((r for r in rows if r[2] > 0), key=lambda r: -r[2])
    busy_us = sum(r[2] for r in rows)
    print(f"profile: {what}, {1e3 * wall_s:.1f} ms host clock, "
          f"device busy {busy_us / 1e3:.1f} ms ({busy_us / 1e4 / wall_s:.1f} %)")
    for key, count, us in rows[:top]:
        print(f"  {us / 1e3:9.3f} ms  {count:6d}x  {key[:90]}")
    device_ms = {}
    for name, symbols in KERNEL_SYMBOLS:
        launches = sum(c for key, c, _ in rows if symbols[0] in key)
        if launches:
            us = sum(us for key, _, us in rows if any(sym in key for sym in symbols))
            device_ms[name] = us / 1e3 / launches
    print(f"profile: device ms per launch {device_ms}")
    return device_ms


def kernel_device_ms(name: str, fn, reps: int = 20, attempts: int = 3) -> float:
    """Device ms per launch of one port kernel over `reps` calls of fn, from
    torch.profiler (fn warmed up by the caller's event timing). A profiler
    session now and then hands back no device events at all (seen on the
    H100 after a dozen sessions in one process), so a window that saw none
    is profiled again, `attempts` times in all."""
    def calls():
        for _ in range(reps):
            fn()

    for _ in range(attempts):
        device_ms = profiled(f"{reps} calls of {name}", calls, top=0)
        if name in device_ms:
            return device_ms[name]
    fail(f"the profiler saw no device time of {name} in {attempts} sessions")


def make_dataset(tmp: str, teacher_run: str) -> str:
    """Render TRAIN_VIEWS + VAL_VIEWS views of the teacher on a circle, one arm
    angle per view, and write them as a dataset directory (train/ and val/)."""
    from smpl_nerf_tpu_torch.cli import inference, render_path
    from smpl_nerf_tpu_torch.data import datasets
    from smpl_nerf_tpu_torch.training import checkpoints

    args = checkpoints.load_config(teacher_run)
    n = TRAIN_VIEWS + VAL_VIEWS
    data = render_path.camera_path_data("circle", n, 2.4, -90, 90, TRAIN_RES,
                                        args.human_joints, 0.0)
    angles = np.deg2rad(np.linspace(0.0, 45.0, n, dtype=np.float32))
    for j in args.human_joints:
        data.human_poses[:, int(j)] = angles
    images = inference.render_dataset(args, teacher_run, data, batch_size=BATCH, device=DEVICE)
    check(bool(np.isfinite(images).all()), "non-finite teacher render")
    dataset_dir = os.path.join(tmp, "dataset")
    val = np.arange(n) % (n // VAL_VIEWS) == 1            # spread over the circle
    for split, sel in (("train", ~val), ("val", val)):
        datasets.write_dataset(os.path.join(dataset_dir, split), images[sel],
                               data.camera_transforms[sel], np.pi / 3, data.human_poses[sel])
    print(f"training: dataset of {int((~val).sum())} train and {int(val.sum())} val views "
          f"{TRAIN_RES}x{TRAIN_RES} rendered by the port (pixel mean {images.mean():.4f}, "
          f"std {images.std():.4f})")
    return dataset_dir


def train_run(tmp: str, dataset_dir: str, name: str, fused: int, pallas: int,
              gif: bool = False):
    from smpl_nerf_tpu_torch.cli import train as train_cli

    log_dir = os.path.join(tmp, name)
    solver = train_cli.train(
        [f"--config={ARM_ANGLES}", f"--dataset_dir={dataset_dir}", "--sigma_noise_std=0",
         f"--num_epochs={EPOCHS}", f"--steps_per_epoch={STEPS_PER_EPOCH}",
         f"--batchsize_val={BATCH}", "--seed=1", f"--use_fused_mlp={fused}",
         f"--use_pallas={pallas}", f"--render_gif={int(gif)}",
         "--number_validation_images=0"], log_dir=log_dir,
        device=DEVICE)
    return solver, log_dir


def phase_training(tmp: str, dataset_dir: str) -> tuple:
    from smpl_nerf_tpu_torch.data import datasets

    steps = EPOCHS * STEPS_PER_EPOCH
    val_batches = EPOCHS * -(-VAL_VIEWS * TRAIN_RES * TRAIN_RES // BATCH)

    # the post-training GIF step renders every train and val view
    gif_batches = (-(-TRAIN_VIEWS * TRAIN_RES * TRAIN_RES // BATCH)
                   + -(-VAL_VIEWS * TRAIN_RES * TRAIN_RES // BATCH))

    zero_launch_counts()
    solver, kernel_dir = train_run(tmp, dataset_dir, "train_kernel", 2, 1, gif=True)
    counts = launch_counts()
    kernel_loss = solver.history["step_loss"]
    print(f"training: cli.train arm_angles.txt full width, kernel path, {steps} steps of "
          f"{BATCH} rays + {val_batches} validation batches + {gif_batches} batches of the "
          f"post-training GIF: launches {counts}")
    # per step 1 x A, 2 x B, 2 x C (coarse and fine net); per validation or GIF
    # batch 1 x A, 2 x B
    renders = val_batches + gif_batches
    expected = {"sample_pdf": steps + renders, "fused_mlp_v2_fwd": 2 * (steps + renders),
                "fused_mlp_v2_bwd": 2 * steps, "fused_mlp_fwd": 0}
    for name, want in expected.items():
        check(counts[name] == want, f"training: {name} launched {counts[name]} times, "
                                    f"expected {want}")
    plain_solver, _ = train_run(tmp, dataset_dir, "train_plain", 0, 0)
    plain_loss = plain_solver.history["step_loss"]
    print("training: loss per step, kernel path: " + " ".join(f"{v:.5f}" for v in kernel_loss))
    print("training: loss per step, plain path:  " + " ".join(f"{v:.5f}" for v in plain_loss))
    for what, losses, sol in (("kernel", kernel_loss, solver), ("plain", plain_loss, plain_solver)):
        check(len(losses) == steps and bool(np.isfinite(losses).all())
              and bool(np.isfinite(sol.history["val_loss"]).all()),
              f"training: non-finite loss on the {what} path")
        check(np.mean(losses[-4:]) < losses[0],
              f"training: the {what} path's loss did not fall ({losses[0]} -> {losses[-4:]})")
    rel = max(abs(k - q) / q for k, q in zip(kernel_loss[:LOSS_STEPS], plain_loss[:LOSS_STEPS]))
    print(f"training: kernel vs plain loss over the first {LOSS_STEPS} steps: "
          f"max relative difference {rel:.3e} (bound {LOSS_REL})")
    check(rel <= LOSS_REL, "training: kernel path and plain path losses disagree")

    for required in ("config.txt", "model_coarse.pt", "model_fine.pt", "model_warp_field.pt",
                     "val_curve.json", "train_state.pt", os.path.join("best", "model_coarse.pt")):
        check(os.path.exists(os.path.join(kernel_dir, required)),
              f"training: the run dir lacks {required}")
    view, _ = render(kernel_dir, os.path.join(tmp, "trained.npy"), views=1, res=TRAIN_RES)
    check(view.shape == (1, TRAIN_RES, TRAIN_RES, 3) and bool(np.isfinite(view).all()),
          "training: the saved run does not render")
    check_rerenders(kernel_dir, TRAIN_VIEWS + VAL_VIEWS, TRAIN_RES, "inference.gif")
    print(f"training: the post-training GIF step wrote inference.gif and "
          f"{TRAIN_VIEWS + VAL_VIEWS} img_XXX.png into the run dir")

    ms = {"plain": [], "kernel": []}
    for path in ("plain", "kernel", "kernel", "plain"):
        _, _, step = timed_run(train_run, tmp, dataset_dir, f"train_{path}_timed",
                               *((2, 1) if path == "kernel" else (0, 0)))
        ms[path].append(step)
    print(f"training: ms per step of {BATCH} rays (host clock, synchronised, median without "
          f"the first step; plain/kernel/kernel/plain): kernel path "
          f"{statistics.mean(ms['kernel']):.1f}, plain path {statistics.mean(ms['plain']):.1f}")

    # one step of the kernel path under the profiler
    data = datasets.load_dataset(os.path.join(dataset_dir, "train"), "smpl_nerf")
    arrays = solver.device_arrays(data, "smpl_nerf")
    batch = solver.gather(arrays, np.arange(BATCH))
    solver.train_step(batch, solver.generator)
    device_ms = profiled("one kernel-path training step",
                         lambda: solver.train_step(batch, solver.generator))
    return counts, device_ms, kernel_dir


def parallel_run(tmp: str, dataset_dir: str, name: str, extra=()) -> tuple:
    """cli.train on arm_angles.txt for PAR_STEPS kernel-path steps; (solver, launches)."""
    from smpl_nerf_tpu_torch.cli import train as train_cli

    zero_launch_counts()
    solver = train_cli.train(
        [f"--config={ARM_ANGLES}", f"--dataset_dir={dataset_dir}", "--num_epochs=1",
         f"--steps_per_epoch={PAR_STEPS}", f"--batchsize_val={BATCH}", "--seed=1",
         "--use_fused_mlp=2", "--use_pallas=1", "--render_gif=0",
         "--number_validation_images=0", *extra],
        log_dir=os.path.join(tmp, name), device=DEVICE)
    return solver, launch_counts()


def max_rel(got: dict, want: dict) -> float:
    """Largest |got - want| / max |want| over the tensors of two state-dict trees."""
    worst = 0.0
    for name, sd in want.items():
        for key, w in sd.items():
            g = got[name][key].float()
            worst = max(worst, float((g - w.float()).abs().max())
                        / max(float(w.float().abs().max()), 1e-30))
    return worst


def timed_run(run, *args) -> tuple:
    """(solver, run dir, ms a step) of `run(*args)`, one of the *_run
    functions, under the span recorder (`tracing`): a step runs from the start
    of its `solver.gather` to the end of its `solver.loss_read` (host clock,
    synchronised by the loss read); the median without the first step."""
    from smpl_nerf_tpu_torch import tracing

    tracing.enable(SPAN_CAPACITY)
    try:
        solver, run_dir = run(*args)
    finally:
        tracing.disable()
    start, end = {}, {}
    for span in tracing.snapshot().spans:
        if span.name == "solver.gather":
            start[span.request] = span.start_ns
        elif span.name == "solver.loss_read":
            end[span.request] = span.end_ns
    steps = sorted(end)[1:]
    return solver, run_dir, 1e-6 * statistics.median(end[k] - start[k] for k in steps)


def step_ms(solver, arrays) -> float:
    """CUDA-event ms of one train step of BATCH rays, as train() steps."""
    lo, hi = solver.local_rows(BATCH)
    batch = solver.gather(arrays, np.arange(BATCH)[lo:hi])
    share = (hi - lo) / BATCH if solver.mesh.distributed else None
    return time_ms(lambda: solver.train_step(batch, solver.draws(BATCH), share), reps=5,
                   warmup=1)


def phase_parallel(tmp: str, dataset_dir: str) -> dict:
    import torch.distributed as dist
    from smpl_nerf_tpu_torch.core import integrate
    from smpl_nerf_tpu_torch.data import datasets
    from smpl_nerf_tpu_torch.models import RenderRayNet
    from smpl_nerf_tpu_torch.parallel import ep, pp, sample_axis
    from smpl_nerf_tpu_torch.parallel import mesh as mesh_mod

    steps = PAR_STEPS
    val_batches = -(-VAL_VIEWS * TRAIN_RES * TRAIN_RES // BATCH)
    expected = {"sample_pdf": steps + val_batches,
                "fused_mlp_v2_fwd": 2 * (steps + val_batches),
                "fused_mlp_v2_bwd": 2 * steps, "fused_mlp_fwd": 0}
    check(not dist.is_initialized(), "parallel: a process group is up before the phase")
    plain, plain_counts = parallel_run(tmp, dataset_dir, "par_nogroup", ("--mesh_shape=1,1",))
    check(not plain.mesh.distributed, "parallel: the run without a group has collectives")
    t0 = time.perf_counter()
    mesh_mod.init_distributed(DEVICE, f"file://{os.path.join(tmp, 'rendezvous')}", rank=0,
                              world=1)
    probe = torch.ones(1, device=DEVICE)
    dist.all_reduce(probe)                  # NCCL makes its communicator here
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    print(f"parallel: world-1 NCCL group up in {init_s:.3f} s (init and first all-reduce)")
    group, group_counts = parallel_run(tmp, dataset_dir, "par_group", ("--mesh_shape=1,1",))
    check(group.mesh.distributed and dist.get_backend() == "nccl",
          "parallel: the group run has no NCCL mesh")
    for what, counts in (("no group", plain_counts), ("world-1 group", group_counts)):
        print(f"parallel: {what}: launches A {counts['sample_pdf']}, "
              f"B {counts['fused_mlp_v2_fwd']}, C {counts['fused_mlp_v2_bwd']}")
        for name, want in expected.items():
            check(counts[name] == want, f"parallel: {what}: {name} launched {counts[name]} "
                                        f"times, expected {want}")
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(group.history["step_loss"],
                                                       plain.history["step_loss"]))
    val_rel = abs(group.history["val_loss"][0] - plain.history["val_loss"][0]) / abs(
        plain.history["val_loss"][0])
    w_rel = max_rel(group.raw_state_dicts(), plain.raw_state_dicts())
    print(f"parallel: group vs no group over {steps} steps: loss max rel {loss_rel:.3e}, "
          f"val loss rel {val_rel:.3e}, weights max rel {w_rel:.3e} (bound {PAR_REL})")
    check(max(loss_rel, val_rel, w_rel) <= PAR_REL,
          "parallel: the world-1 group run differs from the run without a group")
    tp_run, tp_counts = parallel_run(tmp, dataset_dir, "par_tp",
                                     ("--mesh_shape=1,1", "--tensor_parallel=1"))
    tp_rel = max(abs(a - b) / abs(b) for a, b in zip(tp_run.history["step_loss"],
                                                     group.history["step_loss"]))
    print(f"parallel: --tensor_parallel=1 on mesh '1,1' (a model axis of 1: off): "
          f"launches {tp_counts}, loss max rel {tp_rel:.3e} against the group run")
    check(not tp_run.tensor_parallel and tp_rel <= PAR_REL and tp_counts == group_counts,
          "parallel: --tensor_parallel=1 on a model axis of 1 changed the run")
    data = datasets.load_dataset(os.path.join(dataset_dir, "train"), "smpl_nerf")
    arrays = group.device_arrays(data, "smpl_nerf")
    ms = {"group": [], "no group": []}
    for which in ("group", "no group", "no group", "group"):
        ms[which].append(step_ms(group if which == "group" else plain, arrays))
    print(f"parallel: ms per step of {BATCH} rays (CUDA events, median of 5, in turns "
          f"group / no group / no group / group): world-1 group "
          f"{statistics.mean(ms['group']):.2f} {ms['group']}, no group "
          f"{statistics.mean(ms['no group']):.2f} {ms['no group']}")

    # the CLI under torchrun: one process, its own group (env:// rendezvous)
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=1",
         os.path.join(REPO, "train_torch.py"), "--multihost=1", "--mesh_shape=1",
         f"--config={ARM_ANGLES}", f"--dataset_dir={dataset_dir}", "--num_epochs=1",
         f"--steps_per_epoch={TORCHRUN_STEPS}", f"--batchsize_val={BATCH}", "--seed=1",
         "--use_fused_mlp=2", "--use_pallas=1", "--render_gif=0",
         "--number_validation_images=0", "--experiment_name=torchrun_smoke"],
        cwd=tmp, env=dict(os.environ, PYTHONPATH=REPO), capture_output=True, text=True,
        timeout=600)
    if run.returncode != 0:
        print(run.stdout[-3000:] + run.stderr[-3000:], file=sys.stderr)
    check(run.returncode == 0, f"parallel: the torchrun training exited {run.returncode}")
    runs = [d for d in os.listdir(os.path.join(tmp, "runs")) if d.endswith("_torchrun_smoke")]
    check(len(runs) == 1, f"parallel: torchrun wrote {runs}, not one run dir")
    run_dir = os.path.join(tmp, "runs", runs[0])
    for required in ("config.txt", "model_coarse.pt", "model_fine.pt", "train_state.pt"):
        check(os.path.exists(os.path.join(run_dir, required)),
              f"parallel: the torchrun run dir lacks {required}")
    restored = group.restore_train_state(run_dir)
    print(f"parallel: torchrun --nproc_per_node=1 train_torch.py --multihost=1: "
          f"{TORCHRUN_STEPS} steps in {time.perf_counter() - t0:.1f} s (process included); "
          f"restore_train_state through broadcast_file: {restored}, epoch offset "
          f"{group.epoch_offset}")
    check(restored and group.epoch_offset == 1,
          "parallel: the torchrun run did not resume through broadcast_file")

    # the sample axis, the pipeline and the experts at world 1, on the card
    mesh = mesh_mod.make_mesh("1,1", DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    raw = torch.randn((SA_R, SA_S, 4), generator=gen, device=DEVICE)
    z = torch.sort(1.0 + 3.0 * torch.rand((SA_R, SA_S), generator=gen, device=DEVICE), -1)[0]
    dirs = torch.randn((SA_R, 3), generator=gen, device=DEVICE)
    got = sample_axis.sample_parallel_raw2outputs(
        mesh, sample_axis.segment(raw, mesh), sample_axis.segment(z, mesh),
        sample_axis.segment(sample_axis.global_dists(z, dirs), mesh))
    want = integrate.raw2outputs(raw, z, dirs)
    errs = {"sample_axis": max(float((getattr(got, k) - getattr(want, k)).abs().max())
                               / max(float(getattr(want, k).abs().max()), 1.0)
                               for k in ("rgb", "weights", "depth", "acc"))}
    net = RenderRayNet(8, 256, 60, 24, generator=torch.Generator().manual_seed(7),
                       device=DEVICE)
    x = torch.randn((PP_ROWS, 84), generator=gen, device=DEVICE)
    with torch.no_grad():
        k, b, u = pp.stack_trunk(net, 8, (4,), 60, 256)
        trunk = pp.pipeline_trunk(mesh, k, b, u, x[:, :60], PP_MICRO)
        dense = pp.trunk_dense(k, b, u, x[:, :60])
        errs["pipeline_trunk"] = float((trunk - dense).abs().max()) / float(dense.abs().max())
        out = pp.pp_render_ray_net(mesh, net, x, n_layers=8, width=256, pos_dim=60,
                                   dir_dim=24, n_micro=PP_MICRO)
        ref = net(x)
        errs["pp_render_ray_net"] = float((out - ref).abs().max()) / float(ref.abs().max())
        experts = ep.init_experts(torch.Generator(device=DEVICE).manual_seed(4), EP_E, 6, 32, 4)
        xt = torch.randn((EP_N, 6), generator=gen, device=DEVICE)
        ids = torch.randint(0, EP_E + 1, (EP_N,), generator=gen, device=DEVICE)   # E: skip
        r = ep.expert_parallel_apply(mesh, experts, xt, ids, capacity=EP_N)
        real = ids < EP_E
        ref = ep.expert_apply(experts, xt, ids.clamp(max=EP_E - 1)) * real[:, None]
        check(not bool(r.overflow.any()), "parallel: expert_parallel_apply overflowed")
        errs["expert_parallel_apply"] = float((r.out - ref).abs().max()) / float(
            ref.abs().max())
    print(f"parallel: against the dense forms, max error over max |value|: {errs} "
          f"(bound {PAR_FN_REL})")
    for name, err in errs.items():
        check(err <= PAR_FN_REL, f"parallel: {name} disagrees with its dense form ({err:.3e})")
    mesh_mod.destroy()
    check(not dist.is_initialized(), "parallel: the process group outlived the phase")
    return {"dp_train": group_counts, "dp_tp_train": tp_counts,
            "dp_nogroup_train": plain_counts}


def prefix_train_run(tmp: str, dataset_dir: str, name: str, fused: int, pallas: int):
    """cli.train on configs/config.txt with --run_fine=1 (append_smpl_params:
    the 621-wide encoded pose prefix on both nets, 64 + 64 samples), phase 7's
    steps and seed."""
    from smpl_nerf_tpu_torch.cli import train as train_cli

    log_dir = os.path.join(tmp, name)
    solver = train_cli.train(
        [f"--config={APPEND_CONFIG}", "--run_fine=1", f"--dataset_dir={dataset_dir}",
         "--sigma_noise_std=0", f"--num_epochs={EPOCHS}", f"--steps_per_epoch={STEPS_PER_EPOCH}",
         f"--batchsize_val={BATCH}", "--seed=1", f"--use_fused_mlp={fused}",
         f"--use_pallas={pallas}", "--render_gif=0", "--number_validation_images=0"],
        log_dir=log_dir, device=DEVICE)
    return solver, log_dir


def phase_prefix_training(tmp: str, dataset_dir: str) -> tuple:
    """append_smpl_params trained through kernels A, B and C (--use_fused_mlp=2
    --use_pallas=1: the prefixed nets on raw rows) and through the plain path
    from one seed: launch counts, finite and falling losses, the two paths'
    losses per step, the run rendered through render_path and scored by
    inference_torch (launch counts of each), ms per step in turns and one
    profiled step. Returns ({path: launch counts}, device ms by kernel)."""
    from smpl_nerf_tpu_torch.cli import inference
    from smpl_nerf_tpu_torch.data import datasets

    steps = EPOCHS * STEPS_PER_EPOCH
    val_batches = EPOCHS * -(-VAL_VIEWS * TRAIN_RES * TRAIN_RES // BATCH)
    paths = {}
    zero_launch_counts()
    solver, kernel_dir = prefix_train_run(tmp, dataset_dir, "append_v2_kernel", 2, 1)
    counts = launch_counts()
    print(f"append_v2: cli.train append_smpl_params configs/config.txt --run_fine=1 full width "
          f"(621-wide prefix), kernel path --use_fused_mlp=2 --use_pallas=1, {steps} steps of "
          f"{BATCH} rays + {val_batches} validation batches: launches {counts}")
    # per step 1 x A, 2 x B, 2 x C (coarse and fine net); per validation batch 1 x A, 2 x B
    check_counts("append_v2 training", counts,
                 {"sample_pdf": steps + val_batches, "fused_mlp_v2_fwd": 2 * (steps + val_batches),
                  "fused_mlp_v2_bwd": 2 * steps})
    paths["append_v2_train"] = counts
    plain_solver, _ = prefix_train_run(tmp, dataset_dir, "append_v2_plain", 0, 0)
    kernel_loss, plain_loss = solver.history["step_loss"], plain_solver.history["step_loss"]
    print("append_v2: loss per step, kernel path: " + " ".join(f"{v:.5f}" for v in kernel_loss))
    print("append_v2: loss per step, plain path:  " + " ".join(f"{v:.5f}" for v in plain_loss))
    for what, losses, sol in (("kernel", kernel_loss, solver), ("plain", plain_loss, plain_solver)):
        check(len(losses) == steps and bool(np.isfinite(losses).all())
              and bool(np.isfinite(sol.history["val_loss"]).all()),
              f"append_v2: non-finite loss on the {what} path")
        check(np.mean(losses[-4:]) < losses[0],
              f"append_v2: the {what} path's loss did not fall ({losses[0]} -> {losses[-4:]})")
    rel = max(abs(k - q) / q for k, q in zip(kernel_loss[:LOSS_STEPS], plain_loss[:LOSS_STEPS]))
    print(f"append_v2: kernel vs plain loss over the first {LOSS_STEPS} steps: max relative "
          f"difference {rel:.3e} (bound {LOSS_REL})")
    check(rel <= LOSS_REL, "append_v2: kernel path and plain path losses disagree")

    zero_launch_counts()
    view, _ = render(kernel_dir, os.path.join(tmp, "append_v2_trained.npy"), views=1,
                     res=TRAIN_RES)
    counts = launch_counts()
    render_batches = -(-TRAIN_RES * TRAIN_RES // BATCH)
    print(f"append_v2: render_path of the trained run, 1 view {TRAIN_RES}x{TRAIN_RES}: "
          f"launches {counts}")
    check(view.shape == (1, TRAIN_RES, TRAIN_RES, 3) and bool(np.isfinite(view).all()),
          "append_v2: the saved run does not render")
    check_counts("append_v2 render_path", counts,
                 {"sample_pdf": render_batches, "fused_mlp_v2_fwd": 2 * render_batches})
    paths["append_v2_trained_render"] = counts

    zero_launch_counts()
    save_dir = os.path.join(tmp, "append_v2_inference")
    per_split = -(-VAL_VIEWS * TRAIN_RES * TRAIN_RES // BATCH)
    scores = inference.inference([
        f"--inf_run_dir={kernel_dir}", f"--inf_ground_truth_dir={os.path.join(dataset_dir, 'val')}",
        f"--inf_save_dir={save_dir}", f"--inf_batchsize={BATCH}", f"--device={DEVICE}"])
    counts = launch_counts()
    print(f"append_v2: inference_torch on the run, {VAL_VIEWS} val views: launches {counts}; "
          + " ".join(f"{k} {v:.5f}" for k, v in scores.items()))
    check_counts("append_v2 inference", counts,
                 {"sample_pdf": per_split, "fused_mlp_v2_fwd": 2 * per_split})
    with open(os.path.join(save_dir, "scores.json")) as fh:
        saved = json.load(fh)
    for key in ("mse", "psnr", "ssim", "rlpips"):
        check(key in saved and bool(np.isfinite(saved[key])),
              f"append_v2 inference: scores.json lacks a finite {key}")
    check_rerenders(save_dir, VAL_VIEWS, TRAIN_RES, "walking.gif")
    paths["append_v2_inference"] = counts

    ms = {"plain": [], "kernel": []}
    for path in ("plain", "kernel", "kernel", "plain"):
        _, _, step = timed_run(prefix_train_run, tmp, dataset_dir, f"append_v2_{path}_timed",
                               *((2, 1) if path == "kernel" else (0, 0)))
        ms[path].append(step)
    print(f"append_v2: ms per step of {BATCH} rays (host clock, synchronised, median without "
          f"the first step; plain/kernel/kernel/plain): kernel path "
          f"{statistics.mean(ms['kernel']):.1f} {ms['kernel']}, plain path "
          f"{statistics.mean(ms['plain']):.1f} {ms['plain']}")
    data = datasets.load_dataset(os.path.join(dataset_dir, "train"), "append_smpl_params")
    arrays = solver.device_arrays(data, "append_smpl_params")
    batch = solver.gather(arrays, np.arange(BATCH))
    solver.train_step(batch, solver.generator)
    device_ms = profiled("one kernel-path append_smpl_params (--use_fused_mlp=2) training step",
                         lambda: solver.train_step(batch, solver.generator))
    return paths, {"append_v2_train": device_ms}


def embedder_gradient(tmp: str, dataset_dir: str) -> dict:
    """append_vertex_locations_to_nerf under --use_fused_mlp=2: the loss
    gradient of the vertex embedder, whose 64-wide output is both nets'
    prefix, so that it reaches the embedder only through kernel C's prefix
    columns of dX. Held against the same pipeline with kernels B and C
    replaced by their plain versions (autograd through
    `reference_forward_raw`; the same roundings: BWD_DW_REL by relative
    norm), and printed beside the plain path's (--use_fused_mlp=0, flax's
    roundings: LOSS_REL)."""
    import dataclasses

    from smpl_nerf_tpu_torch import pipelines
    from smpl_nerf_tpu_torch.data import datasets
    from smpl_nerf_tpu_torch.ops import fused_mlp, fused_mlp_v2
    from smpl_nerf_tpu_torch.training import solver as solver_mod

    model_type = "append_vertex_locations_to_nerf"
    solver, _ = smpl_family_run(tmp, dataset_dir, "append_vertex_v2_grad", model_type, 2, 1,
                                ("--run_fine=1",), steps=1)
    train = datasets.load_dataset(os.path.join(dataset_dir, "train"), model_type)
    batch = solver.gather(solver.device_arrays(train, model_type),
                          np.arange(BATCH) * 3 % train.num_rays)
    pipe = solver.pipeline
    embedder = pipe.models["vertex_embedder"]

    def grads(pipeline):
        for m in pipeline.models.values():
            m.zero_grad()
        loss, _ = solver_mod.make_loss_fn(pipeline)(batch, None, False)
        loss.backward()
        return float(loss.detach()), [p.grad.clone() for p in embedder.parameters()]

    c0 = launch_counts()["fused_mlp_v2_bwd"]
    loss_k, kernel = grads(pipe)
    check(launch_counts()["fused_mlp_v2_bwd"] - c0 == 2,
          "embedder gradient: kernel C did not run on both nets")
    plain_cfg = dataclasses.replace(pipe.cfg, use_fused_mlp=0, use_pallas=0)
    loss_p, plain = grads(pipelines.build_pipeline(plain_cfg, pipe.models, pipe.passes.encoders,
                                                   pipe.passes.extras))
    original = pipelines.fused_v2.fused_apply_raw
    pipelines.fused_v2.fused_apply_raw = lambda spec, net, x: fused_mlp_v2.reference_forward_raw(
        spec, fused_mlp.flatten_params(spec, net), x)
    try:
        loss_r, reference = grads(pipe)
    finally:
        pipelines.fused_v2.fused_apply_raw = original
    to_ref = max(float((a - b).norm() / b.norm()) for a, b in zip(kernel, reference))
    to_plain = max(float((a - b).norm() / b.norm()) for a, b in zip(kernel, plain))
    print(f"append_vertex_v2: vertex embedder gradient (|g| {float(kernel[0].norm()):.4e}), "
          f"kernel path against B and C's plain versions: worst ||err||/||ref|| {to_ref:.3e} "
          f"(bound {BWD_DW_REL}); against the plain path: {to_plain:.3e} (bound {LOSS_REL}); "
          f"losses {loss_k:.6f} / {loss_r:.6f} / {loss_p:.6f}")
    check(all(bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0 for g in kernel),
          "embedder gradient: zero or non-finite on the kernel path")
    check(to_ref <= BWD_DW_REL, "embedder gradient: kernel path and plain versions disagree")
    check(to_plain <= LOSS_REL, "embedder gradient: kernel path and plain path disagree")
    return {"to_plain_versions": to_ref, "to_plain_path": to_plain}


def gif_frames(path: str) -> tuple:
    """(width, height, frames) of a GIF89a file, read off its block structure."""
    with open(path, "rb") as fh:
        data = fh.read()
    check(data[:6] == b"GIF89a" and data[-1:] == b";", f"{path} is not a whole GIF89a file")
    w, h, packed = struct.unpack("<HHB", data[6:11])
    pos = 13 + (3 << ((packed & 7) + 1) if packed & 0x80 else 0)

    def past_sub_blocks(pos):
        while data[pos]:
            pos += data[pos] + 1
        return pos + 1

    frames = 0
    while data[pos] != 0x3B:
        if data[pos] == 0x21:                       # extension: label, sub-blocks
            pos = past_sub_blocks(pos + 2)
        elif data[pos] == 0x2C:                     # image: descriptor, code size, data
            local = data[pos + 9]
            pos += 10 + (3 << ((local & 7) + 1) if local & 0x80 else 0)
            pos = past_sub_blocks(pos + 1)
            frames += 1
        else:
            fail(f"{path}: unknown GIF block 0x{data[pos]:02x}")
    return w, h, frames


def check_rerenders(directory: str, n: int, res: int, gif_name: str) -> None:
    """n readable res x res img_XXX.png files and an n-frame GIF in directory."""
    from smpl_nerf_tpu_torch.data import png

    for i in range(n):
        image = png.read_png(os.path.join(directory, f"img_{i:03d}.png"))
        check(image.shape == (res, res, 3), f"{directory}: img_{i:03d}.png is {image.shape}")
    frames = gif_frames(os.path.join(directory, gif_name))
    check(frames == (res, res, n), f"{directory}/{gif_name}: {frames}, expected "
                                   f"({res}, {res}, {n})")


def phase_inference(tmp: str, dataset_dir: str, run_dir: str) -> dict:
    """`inference_torch.py` (cli.inference.inference) on the trained kernel-path
    run and the val split at --inf_fast 0, 1 and 2; returns the launch counts
    of the three runs together."""
    from smpl_nerf_tpu_torch.cli import inference

    val_dir = os.path.join(dataset_dir, "val")
    n_batches = -(-VAL_VIEWS * TRAIN_RES * TRAIN_RES // BATCH)
    zero_launch_counts()
    for fast in (0, 1, 2):
        save_dir = os.path.join(tmp, f"inference_fast{fast}")
        before = launch_counts()
        t0 = time.perf_counter()
        scores = inference.inference([
            f"--inf_run_dir={run_dir}", f"--inf_ground_truth_dir={val_dir}",
            f"--inf_save_dir={save_dir}", f"--inf_batchsize={BATCH}", f"--inf_fast={fast}",
            f"--device={DEVICE}"])
        seconds = time.perf_counter() - t0
        counts = {k: v - before[k] for k, v in launch_counts().items()}
        # the val views hold two arm angles: with --inf_fast 2 one grid per image
        bakes = VAL_VIEWS if fast == 2 else 0
        expected = {"sample_pdf": n_batches, "fused_mlp_v2_fwd": 2 * n_batches + bakes}
        print(f"inference --inf_fast {fast}: {VAL_VIEWS} val views {TRAIN_RES}x{TRAIN_RES} in "
              f"{n_batches} batches of {BATCH}: launches {counts} ({bakes} grid bakes), "
              f"{seconds:.2f} s host clock (model build, scores and files included); "
              + " ".join(f"{k} {v:.5f}" for k, v in scores.items()))
        for kernel, got in counts.items():
            want = expected.get(kernel, 0)
            check(got == want, f"inference --inf_fast {fast}: {kernel} launched {got} times, "
                               f"expected {want}")
        with open(os.path.join(save_dir, "scores.json")) as fh:
            saved = json.load(fh)
        for key in ("mse", "psnr", "ssim", "rlpips"):
            check(key in saved and bool(np.isfinite(saved[key])),
                  f"inference --inf_fast {fast}: scores.json lacks a finite {key}")
        check(saved["fast"] == fast and saved["run_dir"] == run_dir,
              f"inference --inf_fast {fast}: scores.json names another run")
        check_rerenders(save_dir, VAL_VIEWS, TRAIN_RES, "walking.gif")
    return launch_counts()


def smpl_family_run(tmp: str, dataset_dir: str, name: str, model_type: str, fused: int,
                    pallas: int, extra=(), steps: int = SMPL_STEPS):
    """A full-width configs/config.txt run of an SMPL-driven family (8x256
    nets, 64 coarse samples, bf16, sigma noise 1, the procedural human): one
    epoch of `steps` steps of BATCH rays, then one validation pass."""
    from smpl_nerf_tpu_torch.cli import train as train_cli

    log_dir = os.path.join(tmp, name)
    solver = train_cli.train(
        [f"--config={APPEND_CONFIG}", f"--model_type={model_type}",
         f"--dataset_dir={dataset_dir}", "--num_epochs=1", f"--steps_per_epoch={steps}",
         f"--batchsize_val={BATCH}", "--seed=1", f"--use_fused_mlp={fused}",
         f"--use_pallas={pallas}", "--number_validation_images=0", *extra], log_dir=log_dir,
        device=DEVICE)
    return solver, log_dir


def check_counts(what: str, counts: dict, expected: dict) -> None:
    for name, got in counts.items():
        want = expected.get(name, 0)
        check(got == want, f"{what}: {name} launched {got} times, expected {want}")


def phase_smpl_family(tmp: str, dataset_dir: str, what: str, model_type: str,
                      kernel_flags: tuple, extra: tuple, per_step: dict,
                      per_batch: dict) -> tuple:
    """Train SMPL_STEPS steps of `model_type` through the kernel path
    (launch counts against per_step and per validation batch), again through
    the plain path from the same seed (first losses held together), run
    inference_torch on the kernel-path run's val split (PNGs, GIF,
    scores.json), hold one rendering of the val views through both paths on
    the same weights, time steps and 128x128 views in turns, and profile one
    step. Returns ({path: launch counts}, {path: device ms by kernel},
    the kernel-path run dir)."""
    from smpl_nerf_tpu_torch.cli import inference
    from smpl_nerf_tpu_torch.core.sampling import coarse_sampling
    from smpl_nerf_tpu_torch.data import datasets
    from smpl_nerf_tpu_torch.ops import vertex_attention
    from smpl_nerf_tpu_torch.ops.vertex_attention import vertex_attention_warp

    val_dir = os.path.join(dataset_dir, "val")
    val_batches = -(-VAL_VIEWS * TRAIN_RES * TRAIN_RES // BATCH)
    paths, device_ms = {}, {}

    zero_launch_counts()
    calls = vertex_attention.calls
    solver, kernel_dir = smpl_family_run(tmp, dataset_dir, f"{what}_kernel", model_type,
                                         *kernel_flags, extra)
    counts = launch_counts()
    calls = vertex_attention.calls - calls
    print(f"{what}: cli.train {model_type} configs/config.txt full width, kernel path "
          f"(--use_fused_mlp={kernel_flags[0]} --use_pallas={kernel_flags[1]} {' '.join(extra)}), "
          f"{SMPL_STEPS} steps of {BATCH} rays + {val_batches} validation batches: "
          f"launches {counts}, vertex attention calls {calls}")
    check_counts(f"{what} training", counts, {
        k: SMPL_STEPS * per_step.get(k, 0) + val_batches * per_batch.get(k, 0) for k in counts})
    check(counts["vertex_attention"] == calls,
          f"{what}: {calls - counts['vertex_attention']} vertex attention calls took the eager path")
    paths[f"{what}_train"] = counts
    plain_solver, plain_dir = smpl_family_run(tmp, dataset_dir, f"{what}_plain", model_type,
                                              0, 0, extra)
    kernel_loss, plain_loss = solver.history["step_loss"], plain_solver.history["step_loss"]
    print(f"{what}: loss per step, kernel path: " + " ".join(f"{v:.5f}" for v in kernel_loss))
    print(f"{what}: loss per step, plain path:  " + " ".join(f"{v:.5f}" for v in plain_loss))
    for path, losses, sol in (("kernel", kernel_loss, solver), ("plain", plain_loss, plain_solver)):
        check(len(losses) == SMPL_STEPS and bool(np.isfinite(losses).all())
              and bool(np.isfinite(sol.history["val_loss"]).all()),
              f"{what}: non-finite loss on the {path} path")
    rel = abs(kernel_loss[0] - plain_loss[0]) / plain_loss[0]
    print(f"{what}: first-step loss kernel {kernel_loss[0]:.6f} vs plain {plain_loss[0]:.6f}: "
          f"relative difference {rel:.3e} (bound {LOSS_REL})")
    check(rel <= LOSS_REL, f"{what}: kernel path and plain path first losses disagree")
    for required in ("config.txt", "model_coarse.pt", "model_smpl_estimator.pt"):
        check(os.path.exists(os.path.join(kernel_dir, required)),
              f"{what}: the run dir lacks {required}")

    zero_launch_counts()
    save_dir = os.path.join(tmp, f"{what}_inference")
    t0 = time.perf_counter()
    scores = inference.inference([
        f"--inf_run_dir={kernel_dir}", f"--inf_ground_truth_dir={val_dir}",
        f"--inf_save_dir={save_dir}", f"--inf_batchsize={BATCH}", f"--device={DEVICE}"])
    counts = launch_counts()
    print(f"{what}: inference_torch on the kernel-path run, {VAL_VIEWS} val views "
          f"{TRAIN_RES}x{TRAIN_RES}: launches {counts}, {time.perf_counter() - t0:.2f} s; "
          + " ".join(f"{k} {v:.5f}" for k, v in scores.items()))
    check_counts(f"{what} inference", counts,
                 {k: val_batches * per_batch.get(k, 0) for k in counts})
    paths[f"{what}_inference"] = counts
    with open(os.path.join(save_dir, "scores.json")) as fh:
        saved = json.load(fh)
    for key in ("mse", "psnr", "ssim", "rlpips"):
        check(key in saved and bool(np.isfinite(saved[key])),
              f"{what} inference: scores.json lacks a finite {key}")
    check_rerenders(save_dir, VAL_VIEWS, TRAIN_RES, "walking.gif")

    # the val views through both paths on the kernel-path run's weights, with
    # both nets' sigma bias raised as the culled runs' fine net's is (every ray
    # opaque before its last sample, whose 1e10-long interval would otherwise
    # let a density within rounding of 0 set a ray's colour apart)
    held_dir = os.path.join(tmp, f"{what}_held")
    shutil.copytree(kernel_dir, held_dir)
    for key in ("model_coarse", "model_fine"):
        path = os.path.join(held_dir, f"{key}.pt")
        sd = torch.load(path, map_location="cpu")
        sd["sigma_out_layer.bias"] += CULL_FINE_SIGMA_BIAS
        torch.save(sd, path)
    args = inference.setup_from_run_dir(held_dir)
    data = datasets.load_dataset(val_dir, model_type)
    views = {}
    for path, (fused, pallas) in (("kernel", kernel_flags), ("plain", (0, 0))):
        args.use_fused_mlp, args.use_pallas = fused, pallas
        views[path] = inference.render_dataset(args, held_dir, data, batch_size=BATCH,
                                               device=DEVICE)
    diff = abs(views["kernel"] - views["plain"])
    print(f"{what}: val views, same weights, kernel vs plain path: max|diff|={diff.max():.4e} "
          f"(bound {PIXEL_MAX}), mean|diff|={diff.mean():.4e} (bound {PIXEL_MEAN})")
    check(bool(np.isfinite(views["kernel"]).all()), f"{what}: non-finite kernel render")
    check(float(diff.max()) <= PIXEL_MAX and float(diff.mean()) <= PIXEL_MEAN,
          f"{what}: kernel path and plain path renders disagree")

    ms = {"plain": [], "kernel": []}
    view_ms = {"plain": [], "kernel": []}
    out = os.path.join(tmp, f"{what}_views.npy")
    render(kernel_dir, out)                              # warm-up of the 128x128 renders
    for path in ("plain", "kernel", "kernel", "plain"):
        _, _, step = timed_run(smpl_family_run, tmp, dataset_dir, f"{what}_{path}_timed",
                               model_type, *(kernel_flags if path == "kernel" else (0, 0)),
                               extra)
        ms[path].append(step)
        _, sec = render(kernel_dir if path == "kernel" else plain_dir, out)
        view_ms[path].append(1e3 * sec / VIEWS)
    print(f"{what}: ms per step of {BATCH} rays (host clock, synchronised, median without the "
          f"first step; plain/kernel/kernel/plain): kernel path "
          f"{statistics.mean(ms['kernel']):.1f} {ms['kernel']}, plain path "
          f"{statistics.mean(ms['plain']):.1f} {ms['plain']}")
    print(f"{what}: ms per {RES}x{RES} view through render_path (host clock, in the same "
          f"turns): kernel path {statistics.mean(view_ms['kernel']):.1f} {view_ms['kernel']}, "
          f"plain path {statistics.mean(view_ms['plain']):.1f} {view_ms['plain']}")

    # one step and one 2-view render of the kernel path under the profiler; the
    # SMPL work of a step timed apart (CUDA events, median of 5)
    train = datasets.load_dataset(os.path.join(dataset_dir, "train"), model_type)
    arrays = solver.device_arrays(train, model_type)
    batch = solver.gather(arrays, np.arange(BATCH) * 3 % train.num_rays)
    solver.train_step(batch, solver.generator)
    device_ms[f"{what}_train"] = profiled(f"one kernel-path {model_type} training step",
                                          lambda: solver.train_step(batch, solver.generator))
    device_ms[f"{what}_render"] = profiled(f"kernel-path {model_type} render of {VIEWS} views",
                                           lambda: render(kernel_dir, out))
    passes, cfg = solver.pipeline.passes, solver.pipeline.cfg
    with torch.no_grad():
        lbs_ms = time_ms(lambda: passes.goal_verts_table(batch["image_indices"]), reps=5,
                         warmup=1)
        pose_ms = time_ms(lambda: passes.pose(batch), reps=5, warmup=1)
        print(f"{what}: device ms per step: the batch's goal vertices (a lookup of the pose "
              f"table skinned once) {lbs_ms:.3f}, the whole per-ray conditioning (table gathers"
              f"{', vertex embedder' if model_type != 'dummy_dynamic' else ''}) {pose_ms:.3f}")
        if model_type == "dummy_dynamic":
            goal, warps = passes.pose(batch)
            samples, _ = coarse_sampling(batch["ray_translation"], batch["ray_direction"],
                                         cfg.near, cfg.far, cfg.number_coarse_samples)
            att_ms = time_ms(lambda: vertex_attention_warp(
                samples, goal, warps, cfg.warp_radius, cfg.warp_temperature), reps=5, warmup=1)
            print(f"{what}: device ms per step: vertex attention over {samples.shape[0]} x "
                  f"{samples.shape[1]} samples and {goal.shape[1]} vertices {att_ms:.3f}")
    return paths, device_ms, kernel_dir


def phase_images_per_batch(tmp: str, dataset_dir: str) -> dict:
    """dummy_dynamic on the kernel path with --images_per_batch 2: every
    gathered batch (training and validation) holds rays of at most 2 images."""
    from smpl_nerf_tpu_torch.training import solver as solver_mod

    distinct = []
    gather = solver_mod.Solver.gather

    def recording_gather(self, arrays, idx):
        batch = gather(self, arrays, idx)
        distinct.append(int(torch.unique(batch["image_indices"]).numel()))
        return batch

    zero_launch_counts()
    solver_mod.Solver.gather = recording_gather
    try:
        sol, _ = smpl_family_run(tmp, dataset_dir, "dynamic_ipb", "dummy_dynamic", -1, 1,
                                 (f"--images_per_batch={SMPL_IPB}",))
    finally:
        solver_mod.Solver.gather = gather
    counts = launch_counts()
    print(f"images_per_batch {SMPL_IPB}: dummy_dynamic kernel path, images per gathered batch "
          f"{distinct} (training steps first), losses "
          + " ".join(f"{v:.5f}" for v in sol.history["step_loss"]) + f"; launches {counts}")
    check(len(distinct) >= SMPL_STEPS and max(distinct) <= SMPL_IPB,
          f"images_per_batch {SMPL_IPB}: a batch spans more images ({distinct})")
    check(max(distinct[:SMPL_STEPS]) == SMPL_IPB,
          f"images_per_batch {SMPL_IPB}: no training batch drew from {SMPL_IPB} images")
    check(bool(np.isfinite(sol.history["step_loss"]).all()),
          f"images_per_batch {SMPL_IPB}: non-finite loss")
    return counts


def phase_image_wise(tmp: str, dataset_dir: str, coarse_run: str) -> dict:
    """image_wise_dynamic: one epoch (every train view, two 2048-ray steps
    each) optimising the two arm angles through the dummy_dynamic run's coarse
    net, frozen (--load_coarse_model). Kernel H takes every attention call."""
    from smpl_nerf_tpu_torch.cli import train as train_cli

    zero_launch_counts()
    t0 = time.perf_counter()
    final, errors = train_cli.train(
        [f"--config={APPEND_CONFIG}", "--model_type=image_wise_dynamic",
         f"--dataset_dir={dataset_dir}", "--num_epochs=1", "--seed=1",
         f"--load_coarse_model={coarse_run}"], log_dir=os.path.join(tmp, "image_wise"),
        device=DEVICE)
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    arms = [float(final["smpl_estimator"][k]) for k in ("arm_angle_l", "arm_angle_r")]
    print(f"image_wise: pose errors per epoch {errors}, arm angles {arms} (from 0), "
          f"{seconds:.2f} s host clock; launches {counts}")
    check(bool(np.isfinite(errors).all()) and all(np.isfinite(arms)),
          "image_wise: non-finite pose error or arm angles")
    check(any(a != 0.0 for a in arms), "image_wise: the arm angles did not move")
    check(counts["relu_attention"] > 0, "image_wise: kernel H took no attention call")
    coarse = torch.load(os.path.join(coarse_run, "model_coarse.pt"), map_location="cpu")
    check(all(torch.equal(v.cpu(), coarse[k]) for k, v in final["model_coarse"].items()),
          "image_wise: the frozen coarse net moved")
    return counts


def phase_generate(tmp: str) -> tuple:
    """create_dataset_torch (cli.dataset.main) on the card: an smpl set and an
    smpl_nerf set of GEN_VIEWS views at GEN_RES^2 (a circle, ratio 0.8, both
    arms swept from -90 to 90 degrees over the views: the same cameras and
    poses), and 2 val views of smpl_nerf at VS_VIEW_RES^2 for the
    vertex_sphere view timings; seconds per image. Then the first train image
    of the smpl set again on the CPU (`render/raytrace`), held to the CPU
    test's bounds on the pixels whose closest face is the same on both
    devices. Returns ({set: directory}, launch counts)."""
    from smpl_nerf_tpu_torch.cli import dataset as dataset_cli
    from smpl_nerf_tpu_torch.data import png
    from smpl_nerf_tpu_torch.models import smpl as smpl_mod
    from smpl_nerf_tpu_torch.ops import raymesh
    from smpl_nerf_tpu_torch.render import raytrace

    dirs = {}
    zero_launch_counts()
    for key, kind, res, views, ratio in (("smpl", "smpl", GEN_RES, GEN_VIEWS, 0.8),
                                         ("smpl_nerf", "smpl_nerf", GEN_RES, GEN_VIEWS, 0.8),
                                         ("view", "smpl_nerf", VS_VIEW_RES, 2, 0.0)):
        dirs[key] = os.path.join(tmp, f"gen_{key}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dataset_cli.main([f"--save_dir={dirs[key]}", f"--dataset_type={kind}",
                          f"--resolution={res}", "--camera_path=circle",
                          f"--number_steps={views}", f"--human_number_steps={views}",
                          f"--train_val_ratio={ratio}", "--device", DEVICE])
        seconds = time.perf_counter() - t0
        print(f"generate: create_dataset_torch --dataset_type={kind} {views} views "
              f"{res}x{res} on the card: {seconds:.3f} s, {seconds / views:.4f} s per image "
              "(host clock: LBS, ray tracing, PNG and .npy writing)")
    counts = launch_counts()
    check(all(v == 0 for v in counts.values()), f"generate: a kernel launched {counts}")

    train_dir = os.path.join(dirs["smpl"], "train")
    with open(os.path.join(train_dir, "transforms.json")) as fh:
        meta = json.load(fh)
    name = sorted(meta["image_transform_map"])[0]
    stem = name[len("img_"):-len(".png")]
    cam = np.asarray(meta["image_transform_map"][name], np.float32)
    pose = np.asarray(meta["image_pose_map"][name], np.float32)
    fov = meta["camera_angle_x"]
    model = smpl_mod.procedural_human()
    canonical = smpl_mod.smpl_forward(model, np.zeros(10), torch.zeros(69)).numpy()
    verts = smpl_mod.smpl_forward(model, np.zeros(10), torch.from_numpy(pose)).numpy()
    img = raytrace.render_scene(verts, model.faces, cam, GEN_RES, GEN_RES, fov,
                                vertex_colors=model.vertex_colors, device="cpu")
    warp, depth = raytrace.get_warp(canonical, verts, model.faces, cam, GEN_RES, GEN_RES, fov,
                                    device="cpu")
    card_img = png.read_png(os.path.join(train_dir, name))[..., ::-1]
    card_warp = np.load(os.path.join(train_dir, f"warp_{stem}.npy"))
    card_depth = np.load(os.path.join(train_dir, f"depth_{stem}.npy"))
    hits = {}
    for dev in ("cpu", DEVICE):
        o, d = raytrace.pixel_rays(cam, GEN_RES, GEN_RES, fov, dev)
        v = smpl_mod.smpl_forward(model, np.zeros(10), torch.from_numpy(pose).to(dev))
        h = raymesh.intersect_rays(o, d, v, model.faces)
        hits[dev] = (h.hit.cpu().numpy(), h.face_idx.cpu().numpy())
    hit_same = hits["cpu"][0] == hits[DEVICE][0]
    same = (hit_same & (hits["cpu"][1] == hits[DEVICE][1])).reshape(GEN_RES, GEN_RES)
    colour = np.abs(img.astype(int) - card_img.astype(int)).max(-1)[same].max()
    depth_err = np.abs(depth - card_depth)[same].max()
    warp_err = np.abs(warp - card_warp)[same].max()
    print(f"generate: {name} of the smpl set again on the CPU: hit masks agree on "
          f"{hit_same.mean():.4%} (bound {GEN_HIT_SHARE:.1%}), the face on {same.mean():.4%} "
          f"(bound {GEN_FACE_SHARE:.0%}); there colour max|diff| {colour} level(s) (bound 1), "
          f"depth {depth_err:.3e}, warp {warp_err:.3e} (bound {GEN_T_ATOL})")
    check(hit_same.mean() >= GEN_HIT_SHARE and same.mean() >= GEN_FACE_SHARE,
          "generate: the card's and the CPU's hits disagree")
    check(colour <= 1 and depth_err <= GEN_T_ATOL and warp_err <= GEN_T_ATOL,
          "generate: the card's smpl image disagrees with the CPU's")
    check(float(np.abs(card_warp).max()) > 1e-2, "generate: no pixel of the smpl image warps")
    return dirs, counts


def sample_run(tmp: str, dataset_dir: str, name: str, model_type: str, fused: int,
               extra=(), steps: int = SMPL_STEPS, device=None):
    """A full-width configs/config.txt run (8x256 nets, 64 coarse samples,
    bf16, sigma noise 1) of a family on the loader's samples: one epoch of
    `steps` steps of BATCH rays, then one validation pass."""
    from smpl_nerf_tpu_torch.cli import train as train_cli

    log_dir = os.path.join(tmp, name)
    solver = train_cli.train(
        [f"--config={APPEND_CONFIG}", f"--model_type={model_type}",
         f"--dataset_dir={dataset_dir}", "--num_epochs=1", f"--steps_per_epoch={steps}",
         f"--batchsize_val={BATCH}", "--seed=1", f"--use_fused_mlp={fused}", "--use_pallas=0",
         "--number_validation_images=0", *extra], log_dir=log_dir, device=device or DEVICE)
    return solver, log_dir


def phase_smpl_warp(tmp: str, dataset_dir: str) -> dict:
    """smpl and warp on the generated smpl set: SMPL_STEPS steps on the card
    (no kernel: smpl runs the coarse net's plain forward, as JAX's `.apply`,
    warp only the warp field), the first step against the port's CPU run on
    the same seed and batch, ms per step; warp leaves its nets where they
    were. Returns {path: launch counts}."""
    from smpl_nerf_tpu_torch.training import checkpoints, factory

    paths = {}
    for model_type in ("smpl", "warp"):
        zero_launch_counts()
        solver, run_dir, ms = timed_run(sample_run, tmp, dataset_dir, f"{model_type}_card",
                                        model_type, -1)
        counts = launch_counts()
        check_counts(f"{model_type} training", counts, {})
        paths[f"{model_type}_train"] = counts
        cpu, _ = sample_run(tmp, dataset_dir, f"{model_type}_cpu", model_type, -1, steps=1,
                            device="cpu")
        card_loss, cpu_loss = solver.history["step_loss"], cpu.history["step_loss"]
        rel = abs(card_loss[0] - cpu_loss[0]) / cpu_loss[0]
        print(f"{model_type}: cli.train configs/config.txt full width, {SMPL_STEPS} steps of "
              f"{BATCH} rays on the card: losses " + " ".join(f"{v:.6f}" for v in card_loss)
              + f"; first step {card_loss[0]:.6f} against the CPU's {cpu_loss[0]:.6f}: relative "
              f"{rel:.3e} (bound {SAMPLE_LOSS_REL}); {ms:.2f} ms per step (host clock, "
              f"synchronised, median without the first); launches {counts}")
        check(bool(np.isfinite(card_loss).all())
              and bool(np.isfinite(solver.history["val_loss"]).all()),
              f"{model_type}: non-finite loss")
        check(rel <= SAMPLE_LOSS_REL, f"{model_type}: the card's first loss is not the CPU's")
        check(os.path.exists(os.path.join(run_dir, "model_coarse.pt")),
              f"{model_type}: the run dir lacks model_coarse.pt")
        if model_type == "warp":
            # only the warp field trains: the nets keep their seeded weights
            seeded, _ = factory.build_models_and_params(solver.args, seed=1, device="cpu")
            saved = checkpoints.load_run(run_dir)
            for key in ("model_coarse", "model_fine"):
                check(all(torch.equal(v, saved[key][k])
                          for k, v in seeded[key].state_dict().items()),
                      f"warp: {key} moved, though it gets no gradient")
            check(not all(torch.equal(v, saved["model_warp_field"][k]) for k, v in
                          seeded["model_warp_field"].state_dict().items()),
                  "warp: the warp field did not move")
    return paths


def vs_views(args, run_dir: str, data, use_fused_mlp: int) -> np.ndarray:
    from smpl_nerf_tpu_torch.cli import inference

    args.use_fused_mlp = use_fused_mlp
    return inference.render_dataset(args, run_dir, data, batch_size=BATCH, device=DEVICE)


def phase_vertex_sphere(tmp: str, dataset_dir: str, view_dir: str, what: str,
                        extra: tuple) -> tuple:
    """vertex_sphere on the generated smpl_nerf set, precomputed or in-step
    (`extra`): the loader's seconds on the card; SMPL_STEPS steps through the
    kernel path (auto: B forward, C backward on the coarse net) with launch
    counts, the plain path (0) from the same seed, first losses within
    LOSS_REL; inference_torch on the val split; the val views through both
    paths on the same weights (the coarse sigma bias raised by
    CULL_FINE_SIGMA_BIAS) and through --use_fused_mlp=1 (kernel D at the
    prefix-free width) under the render bounds; ms per step and per
    VS_VIEW_RES^2 view in turns; one profiled step and render; in-step, the
    warp recompute's device ms. Returns ({path: launch counts},
    {path: device ms by kernel})."""
    from smpl_nerf_tpu_torch.cli import inference
    from smpl_nerf_tpu_torch.data import datasets

    val_dir = os.path.join(dataset_dir, "val")
    val_batches = -(-GEN_VAL * GEN_RES * GEN_RES // BATCH)
    paths, device_ms = {}, {}
    zero_launch_counts()
    solver, kernel_dir = sample_run(tmp, dataset_dir, f"{what}_kernel", "vertex_sphere", -1, extra)
    counts = launch_counts()
    print(f"{what}: cli.train vertex_sphere configs/config.txt full width, kernel path "
          f"(--use_fused_mlp=-1 {' '.join(extra)}), {SMPL_STEPS} steps of {BATCH} rays + "
          f"{val_batches} validation batches: launches {counts}")
    check_counts(f"{what} training", counts, {"fused_mlp_v2_fwd": SMPL_STEPS + val_batches,
                                              "fused_mlp_v2_bwd": SMPL_STEPS})
    paths[f"{what}_train"] = counts
    plain_solver, plain_dir = sample_run(tmp, dataset_dir, f"{what}_plain", "vertex_sphere", 0,
                                         extra)
    kernel_loss, plain_loss = solver.history["step_loss"], plain_solver.history["step_loss"]
    print(f"{what}: loss per step, kernel path: " + " ".join(f"{v:.5f}" for v in kernel_loss))
    print(f"{what}: loss per step, plain path:  " + " ".join(f"{v:.5f}" for v in plain_loss))
    for path, losses, sol in (("kernel", kernel_loss, solver), ("plain", plain_loss, plain_solver)):
        check(len(losses) == SMPL_STEPS and bool(np.isfinite(losses).all())
              and bool(np.isfinite(sol.history["val_loss"]).all()),
              f"{what}: non-finite loss on the {path} path")
    rel = abs(kernel_loss[0] - plain_loss[0]) / plain_loss[0]
    print(f"{what}: first-step loss kernel {kernel_loss[0]:.6f} vs plain {plain_loss[0]:.6f}: "
          f"relative difference {rel:.3e} (bound {LOSS_REL})")
    check(rel <= LOSS_REL, f"{what}: kernel path and plain path first losses disagree")

    # the loader on the card: the precompute (or, in-step, the goal meshes)
    args = solver.args
    train = datasets.load_dataset(os.path.join(dataset_dir, "train"), "vertex_sphere", args,
                                  device=DEVICE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    datasets.load_dataset(os.path.join(dataset_dir, "train"), "vertex_sphere", args,
                          device=DEVICE)
    load_s = time.perf_counter() - t0
    if train.sample_warps is not None:
        made = ("precomputed warps; share of samples that warp "
                f"{(np.abs(train.sample_warps).max(-1) > 0).mean():.4f}")
    else:
        made = "goal meshes for the in-step path"
    print(f"{what}: the loader on the card, {train.num_images} train views of {GEN_RES}^2 at "
          f"{args.number_coarse_samples} samples: {load_s:.3f} s (host clock, second call; PNG "
          f"reads, LBS, {made})")

    zero_launch_counts()
    save_dir = os.path.join(tmp, f"{what}_inference")
    t0 = time.perf_counter()
    scores = inference.inference([
        f"--inf_run_dir={kernel_dir}", f"--inf_ground_truth_dir={val_dir}",
        f"--inf_save_dir={save_dir}", f"--inf_batchsize={BATCH}", f"--device={DEVICE}"])
    counts = launch_counts()
    print(f"{what}: inference_torch on the kernel-path run, {GEN_VAL} val views "
          f"{GEN_RES}x{GEN_RES}: launches {counts}, {time.perf_counter() - t0:.2f} s; "
          + " ".join(f"{k} {v:.5f}" for k, v in scores.items()))
    check_counts(f"{what} inference", counts, {"fused_mlp_v2_fwd": val_batches})
    paths[f"{what}_inference"] = counts
    with open(os.path.join(save_dir, "scores.json")) as fh:
        saved = json.load(fh)
    for key in ("mse", "psnr", "ssim", "rlpips"):
        check(key in saved and bool(np.isfinite(saved[key])),
              f"{what} inference: scores.json lacks a finite {key}")
    check_rerenders(save_dir, GEN_VAL, GEN_RES, "walking.gif")

    held_dir = os.path.join(tmp, f"{what}_held")
    shutil.copytree(kernel_dir, held_dir)
    path = os.path.join(held_dir, "model_coarse.pt")
    sd = torch.load(path, map_location="cpu")
    sd["sigma_out_layer.bias"] += CULL_FINE_SIGMA_BIAS
    torch.save(sd, path)
    held_args = inference.setup_from_run_dir(held_dir)
    data = datasets.load_dataset(val_dir, "vertex_sphere", held_args, device=DEVICE)
    views = {"plain": vs_views(held_args, held_dir, data, 0),
             "kernel": vs_views(held_args, held_dir, data, -1)}
    zero_launch_counts()
    views["fused1"] = vs_views(held_args, held_dir, data, 1)
    counts = launch_counts()
    check_counts(f"{what} --use_fused_mlp=1 render", counts, {"fused_mlp_fwd": val_batches})
    paths[f"{what}_fused1_render"] = counts
    print(f"{what}: the --use_fused_mlp=1 render of the val views: launches {counts}")
    for path in ("kernel", "fused1"):
        diff = abs(views[path] - views["plain"])
        print(f"{what}: val views, same weights, {path} vs plain path: max|diff|="
              f"{diff.max():.4e} (bound {PIXEL_MAX}), mean|diff|={diff.mean():.4e} "
              f"(bound {PIXEL_MEAN})")
        check(bool(np.isfinite(views[path]).all()), f"{what}: non-finite {path} render")
        check(float(diff.max()) <= PIXEL_MAX and float(diff.mean()) <= PIXEL_MEAN,
              f"{what}: {path} path and plain path renders disagree")

    view_args = inference.setup_from_run_dir(kernel_dir)
    view_data = datasets.load_dataset(os.path.join(view_dir, "val"), "vertex_sphere", view_args,
                                      device=DEVICE)
    n_views = view_data.num_images
    ms = {"plain": [], "kernel": []}
    view_ms = {"plain": [], "kernel": []}
    vs_views(view_args, kernel_dir, view_data, -1)                  # warm-up
    for path in ("plain", "kernel", "kernel", "plain"):
        _, _, step = timed_run(sample_run, tmp, dataset_dir, f"{what}_{path}_timed",
                               "vertex_sphere", -1 if path == "kernel" else 0, extra)
        ms[path].append(step)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vs_views(view_args, kernel_dir if path == "kernel" else plain_dir, view_data,
                 -1 if path == "kernel" else 0)
        view_ms[path].append(1e3 * (time.perf_counter() - t0) / n_views)
    print(f"{what}: ms per step of {BATCH} rays (host clock, synchronised, median without the "
          f"first step; plain/kernel/kernel/plain): kernel path "
          f"{statistics.mean(ms['kernel']):.1f} {ms['kernel']}, plain path "
          f"{statistics.mean(ms['plain']):.1f} {ms['plain']}")
    print(f"{what}: ms per {VS_VIEW_RES}x{VS_VIEW_RES} view through render_dataset (host clock, "
          f"model build included, in the same turns): kernel path "
          f"{statistics.mean(view_ms['kernel']):.1f} {view_ms['kernel']}, plain path "
          f"{statistics.mean(view_ms['plain']):.1f} {view_ms['plain']}")

    arrays = solver.device_arrays(train, "vertex_sphere")
    batch = solver.gather(arrays, np.arange(BATCH) * 3 % train.num_rays)
    solver.train_step(batch, solver.generator)
    device_ms[f"{what}_train"] = profiled(f"one kernel-path vertex_sphere training step",
                                          lambda: solver.train_step(batch, solver.generator))
    device_ms[f"{what}_render"] = profiled(
        f"kernel-path vertex_sphere render of {n_views} {VS_VIEW_RES}^2 view(s)",
        lambda: vs_views(view_args, kernel_dir, view_data, -1))
    if "goal_verts_itable" in batch:
        passes = solver.pipeline.passes
        samples = (batch["ray_translation"][:, None, :]
                   + batch["ray_direction"][:, None, :] * batch["vs_z"][..., None])
        with torch.no_grad():
            warp_ms = time_ms(lambda: passes.vertex_sphere_warps(batch, samples), reps=5,
                              warmup=1)
        print(f"{what}: device ms of the in-step warp recompute (CUDA events, median of 5): "
              f"{warp_ms:.3f} for {samples.shape[0]} x {samples.shape[1]} samples and "
              f"{batch['goal_verts_itable'].shape[1]} vertices")
    return paths, device_ms


def phase_estimator(tmp: str, dataset_dir: str) -> dict:
    """smpl_estimator: the CNN trains EST_EPOCHS epochs on the generated
    smpl_nerf set's GEN_RES^2 images through cli.train (routed before any
    render pipeline): finite losses, the last epoch's below the first's, the
    run dir reloads with its BatchNorm statistics; seconds per epoch."""
    from smpl_nerf_tpu_torch.cli import train as train_cli
    from smpl_nerf_tpu_torch.data import datasets
    from smpl_nerf_tpu_torch.training import estimator

    run_dir = os.path.join(tmp, "estimator")
    zero_launch_counts()
    final, history = train_cli.train(
        [f"--config={APPEND_CONFIG}", "--model_type=smpl_estimator",
         f"--dataset_dir={dataset_dir}", f"--num_epochs={EST_EPOCHS}",
         f"--batchsize={EST_BATCH}", "--lrate=3e-4", "--seed=1"], log_dir=run_dir, device=DEVICE)
    counts = launch_counts()
    check_counts("estimator", counts, {})
    train_loss = history["train_loss"]
    print(f"estimator: {EST_EPOCHS} epochs on {GEN_VIEWS - GEN_VAL} train views "
          f"{GEN_RES}x{GEN_RES}, batches of {EST_BATCH}: train losses "
          + " ".join(f"{v:.5f}" for v in train_loss) + ", val losses "
          + " ".join(f"{v:.5f}" for v in history["val_loss"])
          + "; seconds per epoch (host clock) " + " ".join(f"{v:.3f}" for v in history["seconds"]))
    check(bool(np.isfinite(train_loss + history["val_loss"]).all()), "estimator: non-finite loss")
    check(train_loss[-1] < train_loss[0], "estimator: the loss did not fall")
    loaded = estimator.load_estimator(run_dir, DEVICE)
    check(all(torch.equal(v, final["smpl_estimator"][k].to(v.device))
              for k, v in loaded.state_dict().items()), "estimator: the run dir does not reload")
    data = datasets.load_dataset(os.path.join(dataset_dir, "val"), "smpl_estimator")
    with torch.no_grad():
        out = loaded(torch.as_tensor(data.images, device=DEVICE))
    check(out.shape == (GEN_VAL, 2) and bool(torch.isfinite(out).all()),
          "estimator: the reloaded CNN does not predict")
    return counts


class LaunchRows:
    """Records the rows of every launch of kernels A, B and D, by the label
    of the candidate being rendered, by wrapping each module's launching
    function for the duration of a `with` (the wrappers' counts still count
    each launch once: the wrapped function counts it)."""

    TARGETS = (("sample_pdf", "sample_pdf_cuda", "sample_pdf_cuda", lambda a: a[0].shape[0]),
               ("fused_mlp_v2_fwd", "fused_mlp_v2", "fused_forward_cuda",
                lambda a: a[2].shape[0]),
               ("fused_mlp_fwd", "fused_mlp", "fused_forward_cuda", lambda a: a[2].shape[0]))

    def __init__(self):
        self.label, self.rows, self._saved = None, {}, []

    def __enter__(self):
        import importlib
        from smpl_nerf_tpu_torch.cli import measure_render

        for kernel, module, fn_name, rows_of in self.TARGETS:
            mod = importlib.import_module(f"smpl_nerf_tpu_torch.ops.{module}")
            original = getattr(mod, fn_name)

            def recorded(*a, _orig=original, _kernel=kernel, _rows=rows_of, **kw):
                out = _orig(*a, **kw)
                key = (self.label, _kernel)
                self.rows.setdefault(key, []).append(int(_rows(a)))
                return out
            self._saved.append((mod, fn_name, original))
            setattr(mod, fn_name, recorded)
        original_candidates = measure_render.candidates

        def labelled(pipeline, batch):
            self.label = "grid_bake"
            out = original_candidates(pipeline, batch)
            return {name: (lambda n=name, f=fn: (setattr(self, "label", n), f())[1])
                    for name, fn in out.items()}
        self._saved.append((measure_render, "candidates", original_candidates))
        measure_render.candidates = labelled
        return self

    def __exit__(self, *exc):
        for mod, name, original in reversed(self._saved):
            setattr(mod, name, original)
        return False

    def histogram(self, label: str, kernel: str) -> dict:
        """{rows: launches} of one candidate and kernel."""
        rows = self.rows.get((label, kernel), [])
        return {r: rows.count(r) for r in sorted(set(rows), reverse=True)}


def tool_measure(run_dir: str, what: str) -> tuple:
    """measure_render (measure_render_256_torch.py's main) on run_dir at
    TOOL_RES^2: (result, launch counts, LaunchRows, peak device bytes)."""
    from smpl_nerf_tpu_torch.cli import measure_render

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts()
    t0 = time.perf_counter()
    with LaunchRows() as rows:
        result = measure_render.main([run_dir, str(TOOL_RES), "--device", DEVICE])
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    print(f"tools: measure_render {what} {TOOL_RES}x{TOOL_RES}: launches {counts}, peak device "
          f"memory {peak / 2 ** 30:.2f} GiB, {seconds:.1f} s host clock in all; best of 5 ms "
          + " ".join(f"{k} {v:.2f}" for k, v in result["ms"].items()))
    for label in ("grid_bake",) + tuple(result["ms"]):
        per = {k: rows.histogram(label, k) for k in ("sample_pdf", "fused_mlp_v2_fwd",
                                                     "fused_mlp_fwd")}
        print(f"tools: {what} [{label}] launches by rows: "
              + "; ".join(f"{k} {v}" for k, v in per.items() if v))
    for name, rgb in result["rgb"].items():
        check(rgb.shape == (TOOL_RES, TOOL_RES, 3) and bool(np.isfinite(rgb).all()),
              f"tools: {what} [{name}] render is not a finite {TOOL_RES}^2 image")
    return result, counts, rows, peak


def whole_image_render(run_dir: str):
    """measure_render's full candidate on run_dir's TOOL_RES^2 view, built as
    the tool builds it, for the profiler."""
    from smpl_nerf_tpu_torch.cli import inference, measure_render
    from smpl_nerf_tpu_torch.render import batched
    from smpl_nerf_tpu_torch.training.factory import dataset_extras

    args = inference.setup_from_run_dir(run_dir)
    data = measure_render.view_data(args.model_type, TOOL_RES)
    pipeline = batched.build_from_run(run_dir, args, torch.device(DEVICE),
                                      dataset_extras(args, data))
    batch = measure_render.whole_image_batch(data, args.model_type, DEVICE)
    return measure_render.candidates(pipeline, batch)["naive_all_rays"]


def phase_tools(tmp: str, dataset_dir: str, gen_dirs: dict) -> tuple:
    """The four tools, on what earlier phases made where they can:
    measure_render at TOOL_RES^2 on seeded full-width arm_angles.txt runs
    (kernel path: A at R = TOOL_RAYS and B at TOOL_RAYS x 192 fine rows in
    every full render; plain path: no launch; the full renders of the two
    paths held to the render bounds), then on a config.txt append run (mode
    1: D on TOOL_RAYS x 128 rows of 705 floats, the peak device memory);
    pose_landscape over LANDSCAPE_ANGLES on phase 9's image_wise run;
    rescore_renders on phase 8's --inf_fast 0 renders (forced, not written
    back); aliasing_floor on phase 10's smpl_nerf val split; one profiled
    kernel-path full render. Returns (launch counts by path, device ms per
    launch by path). The measured runs' sigma biases are raised as the culled phase's are
    (CULL_FINE_SIGMA_BIAS, CULL_COARSE_SIGMA_BIAS): phase 4's runs, at the
    65,536 rays of one 256^2 view, had a ray that still let light through
    at its last sample (an interval 1e10 long), whose pixel the two paths'
    roundings of a density near 0 set 0.53 apart (mean 8.9e-4)."""
    from smpl_nerf_tpu_torch.cli import aliasing_floor, pose_landscape, rescore_renders

    biases = dict(fine_sigma_bias=CULL_FINE_SIGMA_BIAS, coarse_sigma_bias=CULL_COARSE_SIGMA_BIAS)
    smpl_runs = write_runs(tmp, ARM_ANGLES, "tools", (2, 1), **biases)
    append_runs = write_runs(tmp, APPEND_CONFIG, "tools_append", (1, 1), ("--run_fine=1",),
                             **biases)
    paths = {}
    kernel, paths["tools_measure"], rows, _ = tool_measure(smpl_runs[0], "smpl_nerf kernel path")
    n = 6                                       # calls of each candidate: warm + best of 5
    for label in ("naive_all_rays", "fg_culled", "occupancy", "occupancy_prebaked"):
        pdf = rows.histogram(label, "sample_pdf")
        mlp = rows.histogram(label, "fused_mlp_v2_fwd")
        if label == "naive_all_rays":
            want_pdf, want_mlp = {TOOL_RAYS: n}, {TOOL_RAYS * 192: n, TOOL_RAYS * 64: n}
        else:
            want_pdf = {TOOL_K: n}
            want_mlp = {TOOL_K * 192: n, (TOOL_RAYS if label == "fg_culled" else TOOL_K) * 64: n}
            if label == "occupancy":
                want_mlp[64 ** 3] = n          # the grid baked in every call
        check(pdf == want_pdf and mlp == want_mlp,
              f"tools: [{label}] launched A {pdf} and B {mlp} (rows: launches), "
              f"expected {want_pdf} and {want_mlp}")
    check(rows.histogram("grid_bake", "fused_mlp_v2_fwd") == {64 ** 3: 1},
          "tools: the prebaked grid was not baked once through kernel B")
    device_ms = {"tools_measure": profiled(f"kernel-path {TOOL_RES}^2 whole-image render",
                                           whole_image_render(smpl_runs[0]))}
    plain, plain_counts, _, _ = tool_measure(smpl_runs[1], "smpl_nerf plain path")
    check(all(v == 0 for v in plain_counts.values()),
          f"tools: the plain path launched {plain_counts}")
    for name in kernel["rgb"]:
        diff = np.abs(kernel["rgb"][name] - plain["rgb"][name])
        print(f"tools: {TOOL_RES}^2 [{name}] kernel vs plain path: max|diff| {diff.max():.4e}, "
              f"mean {diff.mean():.4e}"
              + (f" (bounds {PIXEL_MAX}, {PIXEL_MEAN})" if name == "naive_all_rays" else
                 " (culled on random weights: each path picks its own rays; not bounded)"))
    diff = np.abs(kernel["rgb"]["naive_all_rays"] - plain["rgb"]["naive_all_rays"])
    check(float(diff.max()) <= PIXEL_MAX and float(diff.mean()) <= PIXEL_MEAN,
          "tools: the whole-image kernel render disagrees with the plain path's")
    print("tools: ms per whole-image view, kernel / plain path: "
          + ", ".join(f"{k} {kernel['ms'][k]:.2f} / {plain['ms'][k]:.2f}" for k in kernel["ms"]))

    # the append family: D's rows are expanded per sample (705 floats each),
    # so one fine pass holds 23.6 GB (peak 44.52 GiB in all on the H100)
    _, paths["tools_measure_append"], arows, _ = tool_measure(
        append_runs[0], "append_smpl_params (mode 1) kernel path")
    fine = arows.histogram("naive_all_rays", "fused_mlp_fwd")
    check(fine.get(TOOL_RAYS * 128) == n, f"tools: the append run's full render launched D {fine}")

    iw_run = os.path.join(tmp, "image_wise")
    zero_launch_counts()
    land = pose_landscape.main(["--run_dir", iw_run, "--dataset_dir",
                                os.path.join(dataset_dir, "train"), "--angles",
                                *LANDSCAPE_ANGLES, "--rays", "8192", "--device", DEVICE])
    paths["tools_landscape"] = launch_counts()
    losses = [r["loss"] for r in land["landscape"]]
    check(len(losses) == int(LANDSCAPE_ANGLES[2]) and bool(np.isfinite(losses).all()),
          f"tools: pose_landscape gave {losses}")
    check_counts("tools_landscape", paths["tools_landscape"], {})

    renders_dir = os.path.join(tmp, "inference_fast0")
    with open(os.path.join(renders_dir, "scores.json")) as fh:
        stored = json.load(fh)
    zero_launch_counts()
    fresh = rescore_renders.main(["--renders_dir", renders_dir, "--force", "--dry_run",
                                  "--device", DEVICE])[0]
    paths["tools_rescore"] = launch_counts()
    print(f"tools: rescore_renders of {renders_dir}: psnr {fresh['psnr']:.4f} from the 8-bit "
          f"files against {stored['psnr']:.4f} from the float renders")
    check(abs(fresh["psnr"] - stored["psnr"]) <= 0.1 and "rlpips" in fresh,
          "tools: the re-scored PSNR drifts more than 0.1 dB from inference's")
    with open(os.path.join(renders_dir, "scores.json")) as fh:
        check(json.load(fh) == stored, "tools: --dry_run rewrote scores.json")

    zero_launch_counts()
    floor = aliasing_floor.main(["--dataset_dir", os.path.join(gen_dirs["smpl_nerf"], "val"),
                                 "--frames", str(GEN_VAL), "--device", DEVICE])
    paths["tools_aliasing"] = launch_counts()
    check(all(15.0 < v < 80.0 for v in floor["psnr"]),
          f"tools: aliasing floors {floor['psnr']} are no PSNR of a rendered view")
    return paths, device_ms


def phase_distill(tmp: str, dataset_dir: str) -> tuple:
    """The distilled-expert serving path through `cli.distill.main`; returns
    (launch counts of the serving run, device ms per launch of a profiled view,
    kernel E against its plain version on the plan of one served chunk)."""
    from smpl_nerf_tpu_torch import config
    from smpl_nerf_tpu_torch.cli import distill
    from smpl_nerf_tpu_torch.data import datasets
    from smpl_nerf_tpu_torch.render import experts as ex
    from smpl_nerf_tpu_torch.training import checkpoints, factory

    # a seeded full-width static teacher: the arm_angles.txt nets as a `nerf` run
    parser = config.config_parser()
    args = parser.parse_args([f"--config={ARM_ANGLES}", "--model_type=nerf", "--use_fused_mlp=2",
                              "--use_pallas=1"])
    models, _ = factory.build_models_and_params(args, seed=0, device="cpu")
    run_dir = os.path.join(tmp, "nerf_teacher_run")
    checkpoints.save_run(run_dir, {k: m.state_dict() for k, m in models.items()}, args, parser)
    val_dir = os.path.join(dataset_dir, "val")
    out_dir = os.path.join(tmp, "distill_out")

    # thresholds from the teacher's own density: a random-weight teacher has
    # none above the tool's defaults
    teacher_fn, cfg, _ = distill.build_teacher(run_dir, device=DEVICE)
    data = datasets.load_dataset(val_dir, "nerf")
    _, sigma, _, _ = distill.probe_sigma(teacher_fn, data, cfg.near, cfg.far, 64,
                                         torch.device(DEVICE))
    sigma_thresh, ess_teacher = (float(np.quantile(sigma, q)) for q in (0.90, 0.97))
    print(f"distill: teacher sigma on the 64^3 probe: max {sigma.max():.4f}, quantiles 0.90 / "
          f"0.97 = {sigma_thresh:.4f} / {ess_teacher:.4f} (--sigma_thresh, first --ess_thresh)")
    check(sigma_thresh > 0.0, "the seeded teacher has no positive density to bound")

    def argv(ess_thresh, *extra):
        return ["--run_dir", run_dir, "--dataset_dir", val_dir, "--out_dir", out_dir,
                "--grid", str(DISTILL_GRID), "--hidden", str(EXPERT_H), "--l_pos", str(L_POS),
                "--l_dir", str(L_DIR), "--steps", str(DISTILL_STEPS),
                "--samples", str(DISTILL_SAMPLES), "--chunk", str(DISTILL_CHUNK),
                "--tile", str(EXPERT_TILE), "--time_reps", str(DISTILL_REPS),
                "--finetune_steps", str(FINETUNE_STEPS),
                "--finetune2_steps", str(FINETUNE2_STEPS), "--sigma_thresh", str(sigma_thresh),
                "--ess_thresh", str(ess_thresh), "--device", DEVICE, *extra]

    # first run: fit and save the fields (no ESS yet)
    fit = distill.main(argv(ess_teacher, "--ess", "0"))
    distill_loss = [loss for _, loss in fit["distill_loss_history"]]
    ft_loss = [loss for phase in ("finetune", "finetune2")
               for _, loss in fit[phase]["loss_history"]]
    check(len(distill_loss) >= 6 and len(ft_loss) >= 6 and not any(fit["resumed"].values())
          and not fit["finetune"]["resumed"] and not fit["finetune2"]["resumed"],
          "distill: the first run did not fit the fields itself")
    print(f"distill: nmse {distill_loss[0]:.4f} -> {distill_loss[-1]:.4f} over {DISTILL_STEPS} "
          f"steps; fine-tune pixel mse {ft_loss[0]:.6f} -> {ft_loss[-1]:.6f}")
    check(bool(np.isfinite(distill_loss + ft_loss).all()), "distill: non-finite loss")
    check(np.mean(distill_loss[-3:]) < distill_loss[0], "distill: the distill loss did not fall")
    check(np.mean(ft_loss[-3:]) < np.mean(ft_loss[:3]), "distill: the fine-tune loss did not fall")
    check(fit["finetune"]["overflow"] == 0 and fit["finetune2"]["overflow"] == 0,
          "distill: fine-tune samples overflowed their budget")

    # --ess_thresh on the fine-tuned field itself: bisect until 5-35 % of the
    # cells are occupied after dilation
    field = ex.load_field(os.path.join(out_dir, "field_ft2.npz"), DEVICE)
    probe = torch.rand(200000, 3, generator=torch.Generator().manual_seed(0)).to(DEVICE)
    probe = field.aabb_min + probe * (field.aabb_max - field.aabb_min)
    with torch.no_grad():
        field_sigma = ex.expert_raw_fn(field, probe, torch.nn.functional.normalize(
            torch.ones_like(probe), dim=-1))[:, 3]
    lo, hi = float(field_sigma.min()), float(field_sigma.max())
    for _ in range(40):
        ess_thresh = 0.5 * (lo + hi)
        occ = ex.dilate_occupancy(ex.cell_occupancy(field, 3, ess_thresh), DISTILL_GRID)
        share = float(occ.mean())
        if share < OCCUPIED_SHARE[0]:
            hi = ess_thresh
        elif share > OCCUPIED_SHARE[1]:
            lo = ess_thresh
        else:
            break
    print(f"distill: --ess_thresh {ess_thresh:.5f} leaves {int(occ.sum())}/{occ.size} cells "
          f"occupied after dilation ({100 * share:.1f} %)")
    check(0.02 <= share <= 0.5, "distill: no threshold leaves 2-50 % of the cells occupied")

    # the serving run: resumes the fields and caches, then every serving form
    zero_launch_counts()
    out = distill.main(argv(ess_thresh, "--ess", "1", "--ray_cull", "1"))
    counts = launch_counts()
    chunks_per_view = -(-data.h * data.w // DISTILL_CHUNK)
    rc_chunks = out["ray_cull"]["stream"] // DISTILL_CHUNK
    expected = 1 + (DISTILL_REPS + 1) * (chunks_per_view + rc_chunks)
    print(f"distill: cli.distill.main grid {DISTILL_GRID}^3 hidden {EXPERT_H}, "
          f"{DISTILL_SAMPLES} samples, chunk {DISTILL_CHUNK}, tile {EXPERT_TILE}: launches "
          f"{counts}; kernel E expected 1 check + {DISTILL_REPS + 1} x ({chunks_per_view} + "
          f"{rc_chunks}) timed chunks = {expected}")
    check(counts["expert_tiles"] == expected,
          f"distill: expert_tiles launched {counts['expert_tiles']} times, expected {expected}")
    check(counts["fused_mlp_v2_fwd"] > 0, "distill: the teacher did not run through kernel B")
    check(all(out["resumed"].values()) and out["finetune"]["resumed"]
          and out["finetune2"]["resumed"],
          "distill: the serving run did not resume the fields and the teacher render")
    ess = out["ess"]
    check(ess["occupied_cells"] == int(occ.sum()), "distill: the tool's occupancy differs")
    check(ess["kernel_check_max_abs_rgb"] <= distill.KERNEL_CHECK_MAX,
          "distill: fused-kernel render disagrees with the culled render")
    with open(os.path.join(out_dir, "scores.json")) as fh:
        check(json.load(fh)["latency_ms"] == out["latency_ms"], "distill: scores.json differs")
    back = ex.load_field(os.path.join(out_dir, "field.npz"), DEVICE)
    check(tuple(back.experts.w0.shape) == (DISTILL_GRID ** 3, EXPERT_D, EXPERT_H)
          and all(bool(torch.isfinite(w).all()) for w in back.experts),
          "distill: field.npz does not read back")
    for leg in ("teacher", "distilled", "distill_gap"):
        check(all(np.isfinite(v) for v in out[leg].values()), f"distill: non-finite {leg} scores")
    lat = out["latency_ms"]
    print(f"distill: ms per {data.h}x{data.w} view of {DISTILL_SAMPLES} samples (host clock, "
          f"synchronised, median of {DISTILL_REPS}): teacher {lat['teacher']}, tiled "
          f"{lat['tiled']}, ESS-culled {lat['ess_culled']}, ESS-tiled {lat['ess_tiled']}, "
          f"ESS-fused-kernel {lat['ess_fused_kernel']}, ESS-bucketed {lat['ess_bucketed']}, "
          f"tile sweep {lat['ess_tile_sweep']}; ray-culled {out['ray_cull']['latency_ms']}")

    # what the kernel saw: skip routing, padding and several tiles per expert
    z = np.linspace(cfg.near, cfg.far, DISTILL_SAMPLES, dtype=np.float32)
    lo_np, hi_np = field.aabb_min.cpu().numpy(), field.aabb_max.cpu().numpy()
    n_samples = DISTILL_CHUNK * DISTILL_SAMPLES
    routed = padded = several = n_chunks = 0
    for per_expert in distill._chunk_counts(data, lo_np, hi_np, DISTILL_GRID, z, DISTILL_CHUNK,
                                            occupied=occ):
        touched = per_expert[per_expert > 0]
        n_chunks += 1
        routed += int(touched.sum())
        padded += int((touched % EXPERT_TILE > 0).sum())
        several += int((touched > EXPERT_TILE).sum())
    print(f"distill: over {n_chunks} chunks, {routed} of {n_chunks * n_samples} samples routed "
          f"to an expert (the rest skipped), {padded} padded runs, {several} runs of several "
          f"tiles, budget {ess['budget']} slots per chunk")
    check(0 < routed < n_chunks * n_samples and padded > 0 and several > 0,
          "distill: skip routing, padding and several tiles per expert did not all occur")

    # one whole view through the kernel path and through the culled path
    cfield = ex.compact_field(field, occ)
    n = data.h * data.w
    o = torch.as_tensor(data.origins[:n], device=DEVICE)
    d = torch.as_tensor(data.directions[:n], device=DEVICE)
    z_row = torch.as_tensor(z, device=DEVICE)

    @torch.no_grad()
    def view(use_kernel):
        rgb, over = [], 0
        for lo_ in range(0, n, DISTILL_CHUNK):
            oc, dc = o[lo_:lo_ + DISTILL_CHUNK], d[lo_:lo_ + DISTILL_CHUNK]
            outs, n_over = ex.render_rays_with_experts_culled(
                cfield, oc, dc, z_row.expand(oc.shape[0], -1), ess["budget"], EXPERT_TILE,
                compute_dtype=torch.bfloat16, use_kernel=use_kernel)
            rgb.append(outs.rgb)
            over += int(n_over)
        return torch.cat(rgb), over

    kernel_rgb, kernel_over = view(True)
    culled_rgb, culled_over = view(False)
    diff = float((kernel_rgb - culled_rgb).abs().max())
    print(f"distill: one view, fused-kernel path vs culled path: max|drgb|={diff:.3e} "
          f"(bound {distill.KERNEL_CHECK_MAX}), n_overflow {kernel_over} and {culled_over}")
    check(kernel_over == 0 and culled_over == 0, "distill: samples overflowed the ESS budget")
    check(bool(torch.isfinite(kernel_rgb).all()) and diff <= distill.KERNEL_CHECK_MAX,
          "distill: the fused-kernel view disagrees with the culled view")
    device_ms = profiled("one ESS fused-kernel view of the distilled field", lambda: view(True))

    # kernel E against its plain version on what the path launches: the plan of
    # view 0's first chunk through the compact field, in the serving type (bf16)
    # and in float32
    with torch.no_grad():
        pos, d_flat = ex._flat_samples(o[:DISTILL_CHUNK], d[:DISTILL_CHUNK],
                                       z_row.expand(DISTILL_CHUNK, -1))
        _, plan, src = ex.culled_plan(cfield, pos, ess["budget"], EXPERT_TILE)
        local = ex._local_coords(cfield, pos[src]).contiguous()
        dirs_slots = d_flat[src].contiguous()
    check(int(plan.overflow.sum()) == 0 and plan.valid.shape[0] == ess["budget"],
          "distill: the served chunk's plan overflows or has another length than the budget")
    on_path = {f"path_{tag}": expert_tiles_variant(f"path_{tag} (one served chunk)",
                                                   cfield.experts, local, dirs_slots, plan, dtype)
               for tag, dtype in (("bf16", torch.bfloat16), ("f32", None))}
    return counts, device_ms, on_path


class RecordingWriter:
    """A SummaryWriter's logging calls, kept in memory."""

    def __init__(self):
        self.scalars, self.images, self.meshes = [], [], []

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, float(value), step))

    def add_image(self, tag, img, step, dataformats="HWC"):
        self.images.append((tag, np.asarray(img), step, dataformats))

    def add_mesh(self, tag, vertices=None, colors=None, global_step=None):
        self.meshes.append((tag, np.asarray(vertices).shape, global_step))


def net_run(tmp: str, dataset_dir: str, name: str, config_file: str, pallas: int, extra=(),
            steps: int = NET_STEPS, fused: int = 0, writer=None):
    """One epoch of `steps` steps of BATCH rays (seed 1, no sigma noise, no
    post-training GIF, no per-epoch rerenders unless `extra` asks for them)
    of a full-width config through `cli.train.train`, then its validation
    pass."""
    from smpl_nerf_tpu_torch.cli import train as train_cli

    log_dir = os.path.join(tmp, name)
    solver = train_cli.train(
        [f"--config={config_file}", f"--dataset_dir={dataset_dir}", "--num_epochs=1",
         f"--steps_per_epoch={steps}", f"--batchsize_val={BATCH}", "--seed=1",
         "--sigma_noise_std=0", f"--use_fused_mlp={fused}", f"--use_pallas={pallas}",
         "--render_gif=0", "--number_validation_images=0", *extra], log_dir=log_dir,
        device=DEVICE, writer=writer)
    return solver, log_dir


def phase_net_variant(tmp: str, dataset_dir: str, what: str, config_file: str,
                      extra: tuple) -> dict:
    """--siren / --grid_encoding at the config's full width: NET_STEPS steps
    through the kernel path (--use_pallas=1: kernel A in the fine pass; the
    nets run their own forward) and the plain path from one seed (first
    losses within LOSS_REL), an explicit --use_fused_mlp=2 refused, ms per
    step in turns, the 2-view render through both paths (phase_render) and,
    for a grid run, through --fast 1 (--cap_fraction 1 against the full
    render) and --fast 2, each with its launch counts; one profiled
    kernel-path step and render. Returns ({path: launch counts}, {path:
    device ms by kernel})."""
    from smpl_nerf_tpu_torch.data import datasets

    val_batches = -(-VAL_VIEWS * TRAIN_RES * TRAIN_RES // BATCH)
    paths = {}
    zero_launch_counts()
    solver, _ = net_run(tmp, dataset_dir, f"{what}_kernel", config_file, 1, extra)
    counts = launch_counts()
    print(f"{what}: cli.train {os.path.basename(config_file)} {' '.join(extra)} full width, "
          f"kernel path (--use_pallas=1), {NET_STEPS} steps of {BATCH} rays + {val_batches} "
          f"validation batches: launches {counts}")
    check_counts(f"{what} training", counts, {"sample_pdf": NET_STEPS + val_batches})
    paths[f"{what}_train"] = counts
    plain_solver, _ = net_run(tmp, dataset_dir, f"{what}_plain", config_file, 0, extra)
    kernel_loss, plain_loss = solver.history["step_loss"], plain_solver.history["step_loss"]
    print(f"{what}: loss per step, kernel path: " + " ".join(f"{v:.5f}" for v in kernel_loss))
    print(f"{what}: loss per step, plain path:  " + " ".join(f"{v:.5f}" for v in plain_loss))
    for path, losses, sol in (("kernel", kernel_loss, solver), ("plain", plain_loss, plain_solver)):
        check(len(losses) == NET_STEPS and bool(np.isfinite(losses).all())
              and bool(np.isfinite(sol.history["val_loss"]).all()),
              f"{what}: non-finite loss on the {path} path")
    rel = abs(kernel_loss[0] - plain_loss[0]) / plain_loss[0]
    print(f"{what}: first-step loss kernel {kernel_loss[0]:.6f} vs plain {plain_loss[0]:.6f}: "
          f"relative difference {rel:.3e} (bound {LOSS_REL})")
    check(rel <= LOSS_REL, f"{what}: kernel path and plain path first losses disagree")
    net = solver.models["model_coarse"]
    print(f"{what}: {type(net).__name__}, {sum(p.numel() for p in net.parameters()):,} "
          f"parameters, {sum(p.numel() * p.element_size() for p in net.parameters()):,} "
          "bytes per net (float32)")
    try:
        net_run(tmp, dataset_dir, f"{what}_fused", config_file, 1, extra + ("--use_fused_mlp=2",))
    except ValueError as e:
        check("--use_fused_mlp=2" in str(e), f"{what}: the refusal does not name the flag: {e}")
        print(f"{what}: --use_fused_mlp=2 refused: {e}")
    else:
        fail(f"{what}: an explicit --use_fused_mlp=2 on a {type(net).__name__} ran")

    ms = {"plain": [], "kernel": []}
    for path in ("plain", "kernel", "kernel", "plain"):
        _, _, step = timed_run(net_run, tmp, dataset_dir, f"{what}_{path}_timed", config_file,
                               int(path == "kernel"), extra)
        ms[path].append(step)
    print(f"{what}: ms per step of {BATCH} rays (host clock, synchronised, median without "
          f"the first step; plain/kernel/kernel/plain): kernel path "
          f"{statistics.mean(ms['kernel']):.1f} {ms['kernel']}, plain path "
          f"{statistics.mean(ms['plain']):.1f} {ms['plain']}")
    data = datasets.load_dataset(os.path.join(dataset_dir, "train"), solver.args.model_type)
    batch = solver.gather(solver.device_arrays(data, solver.args.model_type), np.arange(BATCH))
    solver.train_step(batch, solver.generator)
    device_ms = {f"{what}_train": profiled(f"one kernel-path {what} training step",
                                           lambda: solver.train_step(batch, solver.generator))}

    paths[f"{what}_render"], (kernel_run, _) = phase_render(
        tmp, what, config_file, (0, 1), extra,
        {"sample_pdf": 1, "fused_mlp_v2_fwd": 0, "fused_mlp_fwd": 0, "fused_mlp_v2_bwd": 0})
    out = os.path.join(tmp, "views.npy")
    device_ms[f"{what}_render"] = profiled(f"kernel-path {what} render of {VIEWS} views",
                                           lambda: render(kernel_run, out))
    if not what.startswith("grid"):
        return paths, device_ms
    full, _ = render(kernel_run, out)
    for fast in ("1", "2"):
        zero_launch_counts()
        views, sec = render(kernel_run, out, extra=("--fast", fast))
        counts = launch_counts()
        check(views.shape == full.shape and bool(np.isfinite(views).all()),
              f"{what}: bad --fast {fast} render")
        check(counts["sample_pdf"] > 0, f"{what}: --fast {fast} launched no sample_pdf")
        check_counts(f"{what} --fast {fast}", counts, {"sample_pdf": counts["sample_pdf"]})
        paths[f"{what}_fast{fast}"] = counts
        print(f"{what}: render_path --fast {fast} on the kernel path: launches {counts}, "
              f"{1e3 * sec / VIEWS:.1f} ms per view (host clock, first call), mean|render - "
              f"full| {np.abs(views - full).mean():.4e}")
    cap1, _ = render(kernel_run, out, extra=("--fast", "1", "--cap_fraction", "1"))
    diff = float(np.abs(cap1 - full).max())
    print(f"{what}: --fast 1 --cap_fraction 1 vs the full render: max|diff| {diff:.3e} "
          f"(bound {CAP1_MAX})")
    check(diff <= CAP1_MAX, f"{what}: --fast 1 at full cap differs from the full render")
    return paths, device_ms


def phase_train_flags(tmp: str, dataset_dir: str) -> dict:
    """--check_nans 1 on finite weights (must train), then from a copy of that
    run with a NaN written into one fine-net weight (must raise naming it);
    --profile_dir (a Chrome trace that names kernel A); a run with a
    recording writer and --number_validation_images 2 (scalars, the rerender
    grid's shape, the warp cloud, vedo_data). arm_angles.txt at full width,
    2 steps each; the kernel path (--use_fused_mlp=2 --use_pallas=1) except
    the NaN runs, which keep the nets plain. Returns {path: launch counts}."""
    paths = {}
    val_batches = -(-VAL_VIEWS * TRAIN_RES * TRAIN_RES // BATCH)
    zero_launch_counts()
    sol, run_dir = net_run(tmp, dataset_dir, "nans_finite", ARM_ANGLES, 1, ("--check_nans=1",),
                           steps=2)
    paths["check_nans_train"] = launch_counts()
    check(bool(np.isfinite(sol.history["step_loss"]).all()), "check_nans: a finite run failed")
    poisoned = os.path.join(tmp, "nans_poisoned")
    shutil.copytree(run_dir, poisoned)
    sd = torch.load(os.path.join(poisoned, "model_fine.pt"), map_location="cpu")
    sd["positional_net.0.weight"][0, 0] = float("nan")
    torch.save(sd, os.path.join(poisoned, "model_fine.pt"))
    try:
        net_run(tmp, dataset_dir, "nans_raised", ARM_ANGLES, 1,
                ("--check_nans=1", f"--load_run={poisoned}"), steps=2)
    except RuntimeError as e:
        print("check_nans: " + str(e).splitlines()[0] + f" ({len(str(e).splitlines()) - 1} "
              "non-finite parameters listed)")
        check("model_fine/positional_net.0.weight:" in str(e),
              f"check_nans: the report does not name the poisoned weight: {e}")
    else:
        fail("check_nans: a NaN weight trained without raising")

    prof_dir = os.path.join(tmp, "profile")
    for attempt in range(3):      # a profiler session now and then sees no device events
        zero_launch_counts()
        net_run(tmp, dataset_dir, "profiled", ARM_ANGLES, 1, (f"--profile_dir={prof_dir}",),
                steps=2, fused=2)
        counts = launch_counts()
        trace = os.path.join(prof_dir, "train_trace.json")
        with open(trace) as fh:
            names = {e.get("name", "") for e in json.load(fh)["traceEvents"]}
        if any("sample_pdf_kernel" in n for n in names):
            break
    else:
        fail("profile: the trace names no sample_pdf_kernel in 3 runs")
    paths["profile_train"] = counts
    print(f"profile: --profile_dir trace of 2 steps + {val_batches} validation batches: "
          f"{os.path.getsize(trace):,} bytes, {len(names)} distinct event names, port kernels "
          + ", ".join(sorted({sym for _, syms in KERNEL_SYMBOLS for sym in syms
                              if any(sym in n for n in names)}))
          + f"; launches {counts} (attempt {attempt + 1})")

    writer = RecordingWriter()
    zero_launch_counts()
    _, log_dir = net_run(tmp, dataset_dir, "logged", ARM_ANGLES, 1,
                         ("--number_validation_images=2", "--mesh_epochs=0"), steps=2,
                         fused=2, writer=writer)
    counts = launch_counts()
    paths["logging_train"] = counts
    (tag, grid, step, fmt), = writer.images
    print(f"logging: scalars {[t for t, _, _ in writer.scalars]}, image {tag} {grid.shape} "
          f"{grid.dtype} at step {step}, meshes {writer.meshes}, launches {counts}")
    check(grid.shape == (2 * TRAIN_RES, 3 * TRAIN_RES, 3) and fmt == "HWC"
          and bool(np.isfinite(grid).all()) and 0.0 <= grid.min() and grid.max() <= 1.0,
          "logging: bad rerender grid")
    check([t for t, _, _ in writer.scalars] == ["loss/train", "loss/val", "perf/rays_per_sec"],
          "logging: wrong scalars")
    check(len(writer.meshes) == 1, "logging: no warp cloud at --mesh_epochs 0")
    dump = np.load(os.path.join(log_dir, "vedo_data", "epoch_0_img_0.npz"))
    check(sorted(dump.files) == ["densities", "density_samples"]
          and dump["density_samples"].shape == (dump["densities"].shape[0], 3)
          and bool(np.isfinite(dump["densities"]).all()), "logging: bad vedo_data")
    # per step A, 2 B, 2 C; per validation batch and per rerendered image (one
    # 4096-ray batch each) A, 2 B
    renders = val_batches + 2
    check_counts("logging", counts, {"sample_pdf": 2 + renders,
                                     "fused_mlp_v2_fwd": 2 * (2 + renders),
                                     "fused_mlp_v2_bwd": 4})
    return paths


def phase_baselines(tmp: str, gen_dirs: dict) -> dict:
    """Table 1's baselines on the card: nearest neighbours on the generated
    smpl_nerf set (run_baselines_torch's cli.baselines), the silhouette fit
    of one arm angle on the procedural human from a silhouette the card ray
    traces (tests/test_baselines.py's case), and the pix2pix stand-in:
    create_dataset_torch --dataset_type=pix2pix on the smpl_nerf set's
    cameras and poses, P2P_EPOCHS epochs of the U-Net (cli.pix2pix), then
    cli.evaluate_pix2pix on the val views (ground truth, the NN renders, the
    U-Net's renders). No kernel runs here. Returns {path: launch counts}."""
    from smpl_nerf_tpu_torch.baselines.silhouette_pose_fit import fit_pose_to_silhouette
    from smpl_nerf_tpu_torch.cli import baselines as baselines_cli
    from smpl_nerf_tpu_torch.cli import dataset as dataset_cli
    from smpl_nerf_tpu_torch.cli import evaluate_pix2pix, pix2pix
    from smpl_nerf_tpu_torch.core import cameras
    from smpl_nerf_tpu_torch.models import smpl as smpl_mod
    from smpl_nerf_tpu_torch.render import raytrace

    zero_launch_counts()
    nn_dir = os.path.join(tmp, "nn_baseline")
    t0 = time.perf_counter()
    renders, scores = baselines_cli.main(["--dataset_dir", gen_dirs["smpl_nerf"], "--out",
                                          nn_dir, "--device", DEVICE])
    print(f"baselines: nearest neighbours on the {GEN_VIEWS}-view {GEN_RES}^2 smpl_nerf set, "
          f"{len(renders)} val views in {time.perf_counter() - t0:.2f} s: "
          + " ".join(f"{k} {v:.5f}" for k, v in scores.items()))
    check(renders.shape == (GEN_VAL, GEN_RES, GEN_RES, 3), "baselines: bad NN renders")
    for key in ("mse", "psnr", "ssim", "rlpips"):
        check(key in scores and bool(np.isfinite(scores[key])), f"baselines: no NN {key}")

    model = smpl_mod.procedural_human(rings=3, segments=6)
    gt_pose = np.zeros(69, np.float32)
    gt_pose[41] = FIT_ANGLE
    cam = cameras.get_sphere_pose(0.0, 0.0, 2.4)
    fov = np.pi / 3
    verts = smpl_mod.smpl_forward(model, torch.zeros(10, device=DEVICE),
                                  torch.as_tensor(gt_pose, device=DEVICE))
    img = raytrace.render_scene(verts.cpu().numpy(), model.faces, cam, GEN_RES, GEN_RES, fov,
                                vertex_colors=model.vertex_colors, device=DEVICE)
    mask = (img < 250).any(-1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pose, losses = fit_pose_to_silhouette(model, mask, cam, fov, steps=FIT_STEPS, lr=0.03,
                                          free_joints=np.array([41]), device=DEVICE)
    fit_s = time.perf_counter() - t0
    print(f"baselines: silhouette fit of joint 41 ({mask.sum()} silhouette pixels, "
          f"{FIT_STEPS} Adam steps) on the card: {fit_s:.2f} s ({1e3 * fit_s / FIT_STEPS:.2f} "
          f"ms per step), loss {losses[0]:.4f} -> {losses[-1]:.4f}, angle {pose[41]:.4f} "
          f"(truth {FIT_ANGLE}, bound {FIT_TOL})")
    check(losses[-1] < losses[0] and abs(pose[41] - FIT_ANGLE) < FIT_TOL,
          "baselines: the silhouette fit did not recover the arm angle")

    p2p_dir = os.path.join(tmp, "gen_pix2pix")
    dataset_cli.main([f"--save_dir={p2p_dir}", "--dataset_type=pix2pix",
                      f"--resolution={GEN_RES}", "--camera_path=circle",
                      f"--number_steps={P2P_VIEWS}", f"--human_number_steps={P2P_VIEWS}",
                      "--train_val_ratio=0.8", "--device", DEVICE])
    p2p_out = os.path.join(tmp, "pix2pix_renders")
    result = pix2pix.main(["--dataset_dir", p2p_dir, "--epochs", str(P2P_EPOCHS), "--batch",
                           str(P2P_BATCH), "--out", p2p_out, "--device", DEVICE])
    epoch_s = statistics.median(result["epoch_seconds"][1:])
    print(f"baselines: pix2pix U-Net (bf16) {P2P_EPOCHS} epochs of batch {P2P_BATCH} on "
          f"{P2P_VIEWS - GEN_VAL} train pairs {GEN_RES}^2: L1 per epoch "
          + " ".join(f"{v:.5f}" for v in result["losses"])
          + f"; {epoch_s:.4f} s per epoch (host clock, median without the first); "
          + " ".join(f"{k} {v:.5f}" for k, v in result["scores"].items()))
    check(bool(np.isfinite(result["losses"]).all()) and result["losses"][-1] < result["losses"][0],
          "baselines: the U-Net's loss did not fall")
    check(result["renders"].shape == (GEN_VAL, GEN_RES, GEN_RES, 3)
          and bool(np.isfinite(result["renders"]).all()), "baselines: bad U-Net renders")
    gif_path = os.path.join(tmp, "comparison.gif")
    evaluated = evaluate_pix2pix.main(["--gt_dir", os.path.join(gen_dirs["smpl_nerf"], "val"),
                                       "--nerf_dir", nn_dir, "--pix2pix_dir", p2p_out,
                                       "--out", gif_path, "--device", DEVICE])
    print(f"baselines: evaluate_pix2pix_torch on the {GEN_VAL} val views: {evaluated}")
    check(abs(evaluated["smpl-nerf"]["psnr"] - scores["psnr"]) < 0.1,
          "baselines: the evaluation's NN scores disagree with the NN run's")
    check(abs(evaluated["pix2pix"]["psnr"] - result["scores"]["psnr"]) < 0.5,
          "baselines: the evaluation's U-Net scores disagree with its run's")
    check(gif_frames(gif_path) == (3 * GEN_RES, GEN_RES, GEN_VAL),
          "baselines: bad comparison GIF")
    counts = launch_counts()
    check(all(v == 0 for v in counts.values()), f"baselines: a kernel launched {counts}")
    return {"baselines": counts}


def phase_roofline() -> dict:
    """`cli.mlp_roofline.main`: part `chain` launches F, part `fusedmlp` at
    W=256 launches B, C and D. Returns the launch counts."""
    from smpl_nerf_tpu_torch.cli import mlp_roofline

    zero_launch_counts()
    chain = mlp_roofline.main(["--part", "chain", "--reps", str(ROOFLINE_REPS),
                               "--depth", str(ROOFLINE_DEPTH), "--device", DEVICE])
    fused = mlp_roofline.main(["--part", "fusedmlp", "--widths", "256",
                               "--reps", str(ROOFLINE_REPS), "--device", DEVICE])
    counts = launch_counts()
    # per width: one chain for the value check, 2 warm-up and ROOFLINE_REPS timed
    expected = len(RELU_WIDTHS) * ROOFLINE_DEPTH * (1 + 2 + ROOFLINE_REPS)
    print(f"roofline: cli.mlp_roofline.main chain + fusedmlp W=256: launches {counts} "
          f"(kernel F expected {expected})")
    check(counts["relu_matmul"] == expected,
          f"roofline: relu_matmul launched {counts['relu_matmul']} times, expected {expected}")
    check([r["impl"] for r in fused] == ["plain", "fused_v1", "fused_v2"]
          and not any("refused" in r for r in fused), "roofline: a fused kernel refused W=256")
    for r in chain + fused:
        check(r["device"] == "cuda" and r["card"], "roofline: a record lacks its card")
    for r in chain:
        bound = RELU_REL * r["max_abs_output"]
        print(f"roofline: chain W={r['width']} {r['impl']}: {r['ms']:.4f} ms, max |kernel - "
              f"library| {r['max_abs_diff_kernel_library']:.3e} (bound {bound:.3e}: one bf16 "
              f"step of the largest output, {r['max_abs_output']:.4f}), mean |output| "
              f"{r['mean_abs_output']:.5f}")
        check(r["ms"] > 0 and r["mean_abs_output"] > 0, f"roofline: chain W={r['width']} died")
        check(r["max_abs_diff_kernel_library"] <= bound,
              f"roofline: chain W={r['width']} kernel and library disagree")
    for name in ("fused_mlp_v2_fwd", "fused_mlp_v2_bwd", "fused_mlp_fwd"):
        check(counts[name] > 0, f"roofline: part fusedmlp did not launch {name}")
    return counts


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device: chip_smoke.py runs on the card only")
    if not os.path.isdir(os.path.join(REPO, "smpl_nerf_tpu_torch")):
        fail(f"no smpl_nerf_tpu_torch package beside {__file__}: run it from the checkout")
    sys.path.insert(0, REPO)
    from smpl_nerf_tpu_torch._platform import resolve_device

    device = resolve_device("cuda")
    card = phase_card()
    ptxas = phase_build()
    kernels = [phase_sample_pdf(device), phase_fused_mlp(device), phase_fused_mlp_v1(device),
               phase_fused_bwd(device), phase_expert_tiles(device), phase_relu_matmul(device),
               phase_vertex_attention(device), phase_relu_attention(device)]
    prefix_kernels = phase_fused_prefix(device)
    odd_k = phase_odd_k(device)
    for k in kernels:
        if k["name"] in odd_k:
            k["odd_k"] = odd_k[k["name"]]
    paths, device_ms = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        paths["smpl_nerf_render"], smpl_runs = phase_render(
            tmp, "smpl_nerf", ARM_ANGLES, (2, 1), (),
            {"sample_pdf": 1, "fused_mlp_v2_fwd": 2, "fused_mlp_fwd": 0, "fused_mlp_v2_bwd": 0})
        out = os.path.join(tmp, "views.npy")
        device_ms["smpl_nerf_render"] = profiled(
            f"kernel-path smpl_nerf render of {VIEWS} views", lambda: render(smpl_runs[0], out))
        culled_paths, culled_ms = phase_culled(tmp, "smpl_nerf", ARM_ANGLES, (2, 1), (),
                                               "fused_mlp_v2_fwd")
        paths.update(culled_paths)
        device_ms.update(culled_ms)
        paths["append_render"], append_runs = phase_render(
            tmp, "append_smpl_params", APPEND_CONFIG, (1, 1), ("--run_fine=1",),
            {"sample_pdf": 1, "fused_mlp_fwd": 2, "fused_mlp_v2_fwd": 0, "fused_mlp_v2_bwd": 0})
        device_ms["append_render"] = profiled(
            f"kernel-path append_smpl_params render of {VIEWS} views",
            lambda: render(append_runs[0], out))
        culled_paths, culled_ms = phase_culled(tmp, "append", APPEND_CONFIG, (1, 1),
                                               ("--run_fine=1",), "fused_mlp_fwd")
        paths.update(culled_paths)
        device_ms.update(culled_ms)
        # the same append nets on raw rows: the prefix rows of kernels B and C
        paths["append_v2_render"], append_v2_runs = phase_render(
            tmp, "append_v2", APPEND_CONFIG, (2, 1), ("--run_fine=1",),
            {"sample_pdf": 1, "fused_mlp_v2_fwd": 2, "fused_mlp_fwd": 0, "fused_mlp_v2_bwd": 0})
        device_ms["append_v2_render"] = profiled(
            f"kernel-path append_smpl_params --use_fused_mlp=2 render of {VIEWS} views",
            lambda: render(append_v2_runs[0], out))
        dataset_dir = make_dataset(tmp, smpl_runs[0])
        paths["train"], device_ms["train"], train_dir = phase_training(tmp, dataset_dir)
        paths.update(phase_parallel(tmp, dataset_dir))
        paths["inference"] = phase_inference(tmp, dataset_dir, train_dir)
        prefix_paths, prefix_ms = phase_prefix_training(tmp, dataset_dir)
        paths.update(prefix_paths)
        device_ms.update(prefix_ms)
        for what, config_file, extra in (("siren", ARM_ANGLES, ("--siren=1",)),
                                         ("grid", APPEND_CONFIG,
                                          ("--run_fine=1", "--grid_encoding=1"))):
            variant_paths, variant_ms = phase_net_variant(tmp, dataset_dir, what, config_file,
                                                          extra)
            paths.update(variant_paths)
            device_ms.update(variant_ms)
        paths.update(phase_train_flags(tmp, dataset_dir))
        smpl_paths, smpl_ms, dynamic_run = phase_smpl_family(
            tmp, dataset_dir, "dynamic", "dummy_dynamic", (-1, 1), (),
            {"fused_mlp_v2_fwd": 1, "fused_mlp_v2_bwd": 1, "vertex_attention": 1},
            {"fused_mlp_v2_fwd": 1, "vertex_attention": 1})
        paths.update(smpl_paths)
        device_ms.update(smpl_ms)
        paths["dynamic_ipb_train"] = phase_images_per_batch(tmp, dataset_dir)
        smpl_paths, smpl_ms, _ = phase_smpl_family(
            tmp, dataset_dir, "append_vertex", "append_vertex_locations_to_nerf", (1, 1),
            ("--run_fine=1",), {"sample_pdf": 1, "fused_mlp_fwd": 2},
            {"sample_pdf": 1, "fused_mlp_fwd": 2})
        paths.update(smpl_paths)
        device_ms.update(smpl_ms)
        smpl_paths, smpl_ms, _ = phase_smpl_family(
            tmp, dataset_dir, "append_vertex_v2", "append_vertex_locations_to_nerf", (2, 1),
            ("--run_fine=1",), {"sample_pdf": 1, "fused_mlp_v2_fwd": 2, "fused_mlp_v2_bwd": 2},
            {"sample_pdf": 1, "fused_mlp_v2_fwd": 2})
        paths.update(smpl_paths)
        device_ms.update(smpl_ms)
        embedder = embedder_gradient(tmp, dataset_dir)
        paths["image_wise"] = phase_image_wise(tmp, dataset_dir, dynamic_run)
        smpl_paths = [p for p in paths if p.startswith(("dynamic", "append_vertex"))]
        for name in ("sample_pdf", "fused_mlp_v2_fwd", "fused_mlp_v2_bwd", "fused_mlp_fwd"):
            check(sum(paths[p][name] for p in smpl_paths) > 0,
                  f"{name} was launched on no path of the SMPL-driven families")
        gen_dirs, paths["generate"] = phase_generate(tmp)
        paths.update(phase_smpl_warp(tmp, gen_dirs["smpl"]))
        for what, extra in (("vs", ()), ("vs_instep", ("--vertex_sphere_in_step=1",
                                                      f"--images_per_batch={SMPL_IPB}"))):
            vs_paths, vs_ms = phase_vertex_sphere(tmp, gen_dirs["smpl_nerf"], gen_dirs["view"],
                                                  what, extra)
            paths.update(vs_paths)
            device_ms.update(vs_ms)
        vs_paths = [p for p in paths if p.startswith("vs")]
        for name in ("fused_mlp_v2_fwd", "fused_mlp_v2_bwd", "fused_mlp_fwd"):
            check(sum(paths[p][name] for p in vs_paths) > 0,
                  f"{name} was launched on no vertex_sphere path")
        paths["estimator"] = phase_estimator(tmp, gen_dirs["smpl_nerf"])
        paths.update(phase_baselines(tmp, gen_dirs))
        tool_paths, tool_ms = phase_tools(tmp, dataset_dir, gen_dirs)
        paths.update(tool_paths)
        device_ms.update(tool_ms)
        paths["distill"], device_ms["distill"], on_path = phase_distill(tmp, dataset_dir)
        paths["roofline"] = phase_roofline()
    # kernel E's headline is the plan the distill path launched, in its serving type
    kernel_e = next(k for k in kernels if k["name"] == "expert_tiles")
    kernel_e["variants"].update(on_path)
    kernel_e.update({key: on_path["path_bf16"][key]
                     for key in ("max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
                                 "bound_by")})
    # the prefix rows' entries count B's and C's launches on the prefixed nets' paths
    prefix_kernels[1]["embedder_gradient"] = embedder
    kernels += prefix_kernels
    for k in kernels:
        counter = k.get("counter", k["name"])
        on = lambda path: "counter" not in k or path.startswith(PREFIX_PATHS)
        k["ptxas"] = ptxas[os.path.splitext(os.path.basename(k["source"]))[0]]
        k["launches_by_path"] = {path: counts[counter] for path, counts in paths.items()
                                 if on(path)}
        k["launches"] = sum(k["launches_by_path"].values())
        check(k["launches"] > 0, f"{k['name']} was launched on no main path")
        k["device_ms_by_path"] = {path: ms[counter] for path, ms in device_ms.items()
                                  if counter in ms and on(path)}
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
