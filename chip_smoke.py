#!/usr/bin/env python3
"""Chip smoke of tuch_tpu_torch, the PyTorch + CUDA port, on one NVIDIA card.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Drives the port's ported paths end to end and fails loudly (a non-zero
exit, no result line) if any check fails:

  1. build   the CUDA kernels from tuch_tpu_torch/csrc/, one nvcc each, in
             parallel, with each kernel's ptxas line;
  2. kernel  the attention kernel against its plain PyTorch version on the
             card, fp32 and bf16, at the serving shapes, at N on both
             sides of its tile edges (1 to 300, head dims 32 and 64) and
             at ViTPose-H's shape (HMR 2.0's backbone: N 192, C 1280, 16
             heads of 80) at B=1 and 64, and its time at ViT-S/16's B=64
             and ViTPose-H's B=1 (the EFT step's) and B=64 beside the
             plain version's, a library call's and the card's bound
             (CUDA-graph replays: device time only); attention's gradient
             through the kernel against the plain version's at the
             ViT-S/16 B=64 shape and ViTPose-H's B=1 in both dtypes, and one
             ViT-S/16 backward whose qkv weight gradients equal those with
             the plain version in the kernel's place; then the Adam kernel
             (csrc/adam.cu) at HMR 2.0's and ResNet-50's leaves in float32:
             one step equal to the plain foreach update bit for bit, its
             time (CUDA-graph replay) beside its bound, the plain update
             with its copy into the parameters and torch._fused_adam_, and
             each instantiation's ptxas line;
  3. serve   the HTTP server with the ViT-S/16 backbone at full width on the
             synthetic 6890-vertex body: a single /predict and a concurrent
             burst that fills a micro-batch bucket; the attention kernel must
             launch 12 times per device forward; then the same with
             --dtype bfloat16 (the bf16 kernel, 12 launches per forward);
  4. serve   the same with the ResNet-50 backbone, fp32 and bf16;
  5. parity  the card's fp32 vertices against the port's CPU path, same
             weights and image, and the card's bf16 vertices against the
             card's fp32 ones (within BF16_VERTEX_ATOL), for both backbones;
  6. times   B=1 forward latency and B=64 images/s for both backbones in
             both dtypes, each with a torch.profiler breakdown;
 6b. options ResNet-50 with --bn_fold and with stem_s2d (the plain stem
             here: the stock model under another flag) against the
             stock model on random BatchNorm statistics: vertices at B=8
             (TF32 off, HMR_OPTION_ATOL), --bn_fold's B=64 forward time
             (CUDA events) and device kernels beside the stock model's in
             fp32 and bf16, and one /predict through cli/serve --bn_fold.

and the SMPLify-DC slice, on the same body with every contact asset:

  7. kernel  winding numbers, the masked nearest vertex, row gather and row
             scatter-add against their plain versions on the card, at the
             slice's shapes (winding and the masked nearest vertex also on
             the posed B=64 body), and each one's time at B=64 beside its
             plain version's, its bound and a library call's (the masked
             nearest vertex also at B=4, with its registers; it, gather and
             scatter-add by CUDA-graph replay, the latter two each one
             device kernel per call, with the host µs per call of their
             wrappers and library calls at B=64 and 4); scatter-add bit for
             bit against the CPU's index_add_ also where its plan has
             edges (B=4 and 1, every q on one row, half the rows empty, Q
             below V, rows either side of a CTA edge), timed at B=64, 4
             and 1 with its plan (CTAs per item, shared memory, ptxas),
             beside zero-fill + index_add_ with torch's deterministic mode
             off and on, each said to give the CPU's bits or not;
  8. fit     the demo (demo_smplify_dc --synthetic, 4 images, 100 iterations,
             ResNet-50 SPIN init): finite outputs, a lower reprojection loss
             than the init's, and each kernel launched exactly its count per
             iteration;
  9. parity  the card against the port's CPU path at B=2: in/out flags,
             nearest vertices, the stage-2 loss and gradient, and the
             vertices after a few iterations;
 10. times   ms per fit iteration at B=4 and B=64, the demo's wall time, and
             a torch.profiler breakdown per B.

and the experimental winding routes, unwired as in the JAX package, on the
same body with the JAX defaults (clusters of 256 faces, tiles of 512
points, 16 near clusters):

 11. routes  the affine route (kernel 3) and the hierarchical route (dense
             PyTorch plus kernel 7) through their entry points at B=64, rest
             and posed, with their in/out flips at 0.99 against kernel 2 and
             exact launch counts; kernels 3 and 7 against their plain
             versions at B 1 and 8, rest and posed, and on the posed B=64
             body, with their ptxas lines; times at B=4 and 64 of
             kernels 3, 7 and 2 and of the whole hierarchical route, each
             beside its plain version's and its bound, and a torch.profiler
             breakdown of the route.

and the training step (train/module.py make_train_step: HMR forward and
backward, SMPLify-DC in the loop, fits store, the regressor loss with the
HD contact surface, one Adam step), for ResNet-50 and ViT-S/16 at 224 px
on the same body, the HMR's IEF loop started from a folding pose so the
contact losses are live:

 12. train   parity: one step at B=2 (2 fit iterations), card against the
             port's CPU path on the same weights, fits, batch and dropout
             masks: the loss and every loss_dict entry, the accept mask,
             the fits rows, opt_vertices, and the gradients (Adam's first
             moment) element by element for ViT-S/16; for ResNet-50 the
             gradients, BatchNorm statistics and parameter updates against
             the CPU step in float64 (see tests/test_torch_port_train_step);
             exact launch counts of kernels 1 (ViT), 2, 4, 5 and 6. Times:
             B=64 with TrainConfig's defaults (10 fit iterations, contact
             in the loop, hd_k 1024), a 256-row fits store: the launches of
             one step asserted, ms per step (median of 5), the split into
             its parts, a torch.profiler breakdown of one step and the
             peak memory.

and the training and evaluation entry points, run in this process with
the flags a user types:

 13. train   cli/train --synthetic --run_smplify --batch_size 64
             --num_epochs 1 --val_and_checkpoint_freq 0.5 --num_workers 8
             on the full body at 224 px (256 samples, 4 steps, validation
             and a checkpoint at steps 2 and 4), on an instrumented Trainer
             (loader wait, step_fn, validation and checkpoint times): A,
             ResNet-50, each step's launches as phase 12's, finite losses,
             a metrics line per step, 2 checkpoints and the fits files; B,
             A again; C, A resumed from its step-2 checkpoint: each part
             of B's and C's state (parameters, Adam's moments, fits)
             within RESUME_BAR of A's (0: bit for bit, cli/train runs the
             card deterministically), the loss of C's steps
             3-4 at TRAIN_LOSS_RTOL; D, ViT-S/16 with
             --compute_dtype bfloat16, 2 steps then the time-budget exit,
             kernel 1's bf16 launches counted. Each run's counts are set to
             0 before it and read after it.
 14. eval    cli/eval --synthetic --synthetic_samples 256 --batch_size 64
             on run A's last checkpoint, with and without --bn_fold (the
             reports within EVAL_BN_FOLD_MM, images/s), and 8 samples on
             the card and on the CPU (per-sample errors within VERTEX_TOL).

and EFT and the demo and rendering path, through their entry points:

 15. eft     cli/fit_eft --synthetic on the full body at 224 px with
             ResNet-50 (4 images, up to 50 Adam steps each): finite
             outputs, the npz schema, the exact launches of kernels 2, 4,
             5, 6 and 8 per step, steps and ms per image; then on one
             image the card against the port's CPU path over 3 steps on
             the same dropout masks (the loss at TRAIN_LOSS_RTOL, pose and
             betas by phase 12's rule against the CPU's float64 fit), steps
             with a loss read each against steps with none (the stop
             check's cost), and one profiled fit's device busy time and
             idle share.
 16. demo    cli/demo_tuch --synthetic on the card and on the CPU: every
             output written, vertices within VERTEX_TOL, the native C++
             library (viz/native.cpp, built with g++) taken for the crop
             and the renders; then 8 images, each one's time by part (crop,
             forward, renders, file writes), and one crop at 224 px by the
             native warp and by the numpy warp.

and the offline tools and the real-format path:

 17. smplx   cli/smplx_to_smpl's convert_folder on a shard of 64 bodies of
             the full body posed from a seed: every output pkl, each
             body's loss below half its start, ms per step and per shard,
             peak memory, one profiled 20-step fit (device busy, idle
             share); the card against the CPU after 20 steps on 4 bodies.
 18. real    cli/preprocess --synthetic (host only) onto a real-format
             asset tree of the full-topology body (6890-vertex SMPL
             pickles, geodesics, DSC tables, segments, HD regressor), then
             one cli/train --run_smplify step without --synthetic on its
             databases (ResNet-50, B=2, 2 fit iterations; kernels 2, 4, 5,
             6 and 8 launched as phase 12 counts) and cli/eval on its 3DPW
             test database, each card against CPU.

and the device mesh (parallel/), its ranks processes that share the
card over gloo (NCCL refuses two ranks on one card), with torchrun's
environment after the build: four `chip_smoke.py --rank_worker` processes
started once (RankPool) run every group's ranks in turn, each job from
what a fresh process has; the NCCL groups get fresh `--rank_job`
processes:

 19. cp      kernel 4's range entry against its plain version on the posed
             B=64 body over the cuts of cp 2 and 4 (the MIN of the ranges
             equal to the whole-axis kernel bit for bit) and its time; then
             on meshes dp x cp = 1x2, 2x2, 1x4, contact_neighbors exact and
             with candidate_k against one process (in/out flips only in
             the winding band, argmins but at ties, each rank's launches
             of kernel 2 and the range entry), SMPLify-DC with
             SMPLifyConfig(mesh) at B=64 against one process (vertices at
             VERTEX_TOL) and the ms of a body iteration at cp 1, 2, 4;
             NCCL at world size 1, and what NCCL does with 2 ranks on the
             card.
 20. train   cli/train --run_smplify (ResNet-50, B=64, 2 steps) with
             --mesh_cp 2 on 2 ranks against one process, and with
             --mesh_dp 2 against one process on the mesh's BatchNorm (a
             group of 1) (MESH_GAP, the losses at TRAIN_LOSS_RTOL, the cp
             ranks bit for bit equal, the cp route taken), and ViT-S/16
             with --mesh_dp 2 (kernel 1 launched; element by element).
             The ResNet-50 dp 2 ranks then run the BatchNorm control
             (bn_control): the backbone at B=64 in float64, dp against one
             process at the CPU test's element bars, which dp without the
             statistics sync must fail; in float32, dp and one process on
             its batch in reverse order, each against one process.
 21. eval    cli/eval --mesh_dp 2 on 72 samples (a ragged last batch)
             against one process, per image at rtol 1e-4; cli/fit_eft
             --auto_shard on 1, 2 and 4 processes, merged, against one
             process fitting the same shards (bit for bit), and images a
             second for each process count.

`python3 chip_smoke.py --trainer` runs phases 1, 6b, 12 (ResNet-50 times),
13 and 14 alone (~2.5 minutes, against the whole smoke's ~15),
`--offline` runs phases 1, 7, 17 and 18 alone (~2.5 minutes) and
`--parallel` runs phases 1 and 19-21 alone (~5 minutes); they print no
result lines. `--kernels` runs phases 1 and 2 alone and prints kernel 1's
and the Adam kernel's rows of the kernel summary (their launches null: no
phase it runs counts them on a main path). Weights and bodies are random
from fixed seeds. The last two lines of standard output are the kernel
summary and {"ok": true, "device": {...}} as JSON; the line before them is
the card's name and power limit from nvidia-smi.
"""

import argparse
import base64
import copy
import functools
import io
import json
import os
import shutil
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from types import SimpleNamespace

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and the operation
# rate of each input type (fp32 outside the tensor cores, bf16 on them).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
TF32_FLOPS = 495e12              # the fp32 attention kernel runs 3xTF32

VIT_S16 = dict(N=196, C=384, H=6)   # 224x224 / 16x16 patches
VIT_T8 = dict(N=64, C=64, H=2)      # 64x64 / 8x8 patches
ODD = dict(N=197, C=384, H=6)       # a ragged last tile of queries and keys
# HMR 2.0's backbone: a 256x192 crop / 16x16 patches, 16 heads of 80
VITPOSE_H = dict(N=192, C=1280, H=16)
# N on both sides of the kernel's tile edges (16 query rows per warp, 64 per
# block, key tiles of 32 (fp32) or 64 (bf16)), at head dims 64 and 32
EDGES = [dict(N=n, C=c, H=2) for n in (1, 15, 16, 17, 64, 196, 197, 300)
         for c in (128, 64)]
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# attention's gradient through kernel 1 against mha_reference's: the
# backward is mha_reference's recomputed, so they differ only by the
# library's rounding (relative to the largest entry); one bf16 step
GRAD_RTOL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -7}
# ViT-S/16 qkv weight gradients, kernel 1 against mha_reference in its
# place: the forward differs by <= 1e-5 per attention and the difference
# runs through 12 blocks (relative to each tensor's largest entry)
VIT_GRAD_RTOL = 1e-3
VIT_GRAD_B = 8
# card bf16 vs card fp32 vertices, same weights and image: the bar of
# tests/test_torch_port_bf16.py (BF16_VERTEX_ATOL), metres
BF16_VERTEX_ATOL = 5e-3
SERVE_BUCKET = 4
VIT_S16_DEPTH = 12

# SMPLify-DC slice
FIT_IMAGES, FIT_ITERS = 4, 100   # the demo as chip_smoke drives it
TRAIN_B = 64                     # the training batch: kernel and fit times
PLAIN_CHUNK = 16                 # the plain versions run B=64 in 4 batches
PARITY_B, PARITY_ITERS = 2, 4    # card vs CPU; the CPU side stays ~1 minute
WN_ATOL, WN_BAND = 2e-5, 1e-4    # winding: values; in/out at 0.99 outside
D2_RTOL = 1e-6                   # masked min: d2, and argmin ties
SCATTER_ATOL = 0.0               # scatter vs index_add_ on the CPU: both
                                 # add each row in ascending q
WINDING_OPS_PER_PAIR = 67        # counted in csrc/solid_angle.cuh
MASKED_OPS_ALLOWED = 9           # + 1 mask test per pair, csrc/masked_min.cu
DEV = 'cuda'                     # where the slice phases run

# winding routes (phase 11), bars stated before the first run on the card
ROUTE_NEAR = 16                  # num_near; cluster_size 256, tile_q 512
AFFINE_ATOL = 2e-5               # kernel 3 vs plain: same la2, lb2, lc2
NEAR_ATOL = 2e-5                 # kernel 7 vs plain, in winding units
REST_FLIPS = 0                   # flips of either route vs kernel 2, rest
AFFINE_OPS_PER_PAIR = 69         # counted in csrc/winding_affine.cu
FAR_OPS_PER_PAIR = 17            # (point, cluster) dipole, hier_problem

# the training step (phase 12): the bars of tests/test_torch_port_train_step*
TRAIN_PARITY_ITERS = 2           # fit iterations of the card-vs-CPU step
TRAIN_LOSS_RTOL, TRAIN_LOSS_ATOL = 1e-4, 1e-6   # atol x max(1, |loss|)
TRAIN_GRAD_RTOL, TRAIN_GRAD_ATOL = 1e-3, 1e-5   # atol x each tensor's max
VERTEX_TOL = 1e-3                # fits rows and opt_vertices
TRAIN_FITS = 256                 # rows of the B=64 fits store
TRAIN_TIMED = 5                  # timed steps after 2 warm-up and 1 counted

# ResNet-50's serving options (phase 6b): vertices of --bn_fold and
# stem_s2d against the stock model, fp32, TF32 off, metres: the bar of
# tests/test_torch_port_hmr_options.py (the JAX package's fold bar)
HMR_OPTION_ATOL = 2e-4
# the trainer (phase 13): run logs and checkpoints (gitignored)
TRAIN_LOG_DIR = os.path.join('build', 'chip_smoke_train')
# a run of A again (B) and a resume (C) against the straight run (A), per
# part: max abs relative to each tensor's largest. cli/train runs the card
# deterministically (runtime.deterministic: torch's deterministic
# algorithms, cuDNN's deterministic convolutions, kernel 6 in a fixed
# order), so B and C repeat A bit for bit: 0 in every part in all 12 runs
# of tools/determinism_settings.py's setting d on an H100 (80GB HBM3,
# 700 W). Before, B moved the parameters by 1.156 in 3 of 6 runs (a fit's
# accept decision flipped at step 2) and C's fits by up to 1.32e-4.
RESUME_BAR = {'params': 0.0, 'mu': 0.0, 'nu': 0.0, 'fits': 0.0}
EVAL_BN_FOLD_MM = 0.01           # cli/eval report, --bn_fold against not
# EFT (phase 15): cli/fit_eft --synthetic fits its 4-sample database; the
# exact launches of one fit step; the card against the CPU over 3 steps
# (the loss at the step's loss bar, pose and betas by phase 12's rule);
# steps with and without the per-step stop check
EFT_DIR = os.path.join('build', 'chip_smoke_eft')
# (kernel 8: ResNet-50 and the IEF head's 169 tensors, 91 a launch)
EFT_STEP_LAUNCHES = {'winding': 2, 'masked_min': 1, 'gather': 1,
                     'scatter_add': 1, 'adam': 2}
EFT_PARITY_STEPS = 3
EFT_AB_STEPS, EFT_AB_PAIRS = 10, 2
# demo_tuch (phase 16): outputs per image, card against CPU vertices
# (VERTEX_TOL), images for the times, crops timed per warp
DEMO_DIR = os.path.join('build', 'chip_smoke_demo')
DEMO_FILES = ('.obj', '_r60.obj', '_r300.obj', '_camera.pkl', '_img_in.png',
              '.png')
DEMO_TIMED_IMAGES = 8
CROP_TIMED = 50

# smplx_to_smpl (phase 17): cli/smplx_to_smpl's convert_folder on one
# shard of bodies of the full-topology body posed from a seed, for 1000 of
# the reference's 5000 steps (host-bound at ~11 ms a step on an H100: the
# 5000 took 54 s, and the smoke aims at half its time limit); the card
# against the CPU after a few steps on a few of them: pose and betas at
# 1e-4, the per-sample loss at rtol 1e-4 (the 20-step bars of
# tests/test_torch_port_smplx_to_smpl.py; on the CPU the fit moved 1.3e-6
# between 1 and 8 threads at this size, tools/smplx_fit_spread.py)
SMPLX_DIR = os.path.join('build', 'chip_smoke_smplx')
SMPLX_SHARD, SMPLX_STEPS, SMPLX_PROFILED_STEPS = 64, 1000, 20
SMPLX_REFERENCE_STEPS, SMPLX_AB_STEPS = 5000, 200
SMPLX_PARITY_BODIES, SMPLX_PARITY_STEPS = 4, 20
SMPLX_ATOL, SMPLX_LOSS_RTOL = 1e-4, 1e-4
# the port's own data (phase 18): cli/preprocess --synthetic's databases on
# a real-format asset tree of the full-topology body; one cli/train step
# (ResNet-50, B=2 at 224 px, 2 fit iterations: the CPU side stays ~1
# minute) and cli/eval on the 3DPW test database, card against CPU
REAL_DIR = os.path.join('build', 'chip_smoke_real')
REAL_B, REAL_ITERS, REAL_HD_POINTS = 2, 2, 1024

# torch.profiler: the runtime calls that launch a kernel (by prefix), and
# the one-call captures taken before one that lost its kernel's record
# stands
LAUNCH_CALLS = ('cudaLaunch', 'cuLaunch')
CAPTURE_TRIES = 10
# the device mesh (phases 19-21): ranks are processes sharing the card
PAR_DIR = os.path.join('build', 'chip_smoke_parallel')
PAR_TIMEOUT = 300                # s, a group of ranks
CP_MESHES = ((1, 2), (2, 2), (1, 4))
CP_K = 984                       # candidate_k, as --fast_profile sets it
CP_FIT_ITERS = 10                # SMPLify-DC iterations of each stage
CP_TIMED = 3                     # timed body iterations
MESH_TRAIN_STEPS = 2
MESH_REF = os.path.join(PAR_DIR, 'one_process_state.pt')
# ResNet-50's dp 2 run is held against one process whose BatchNorm is the
# mesh's (models/hmr._SyncBatchNorm over a group of 1): one process's own
# kernel (F.batch_norm) rounds otherwise, and ResNet-50's float32 step
# amplifies that (MESH_GAP); bn_control holds the two BatchNorms equal in
# float64
MESH_REF_SYNC = os.path.join(PAR_DIR, 'one_process_sync_state.pt')
# a mesh run's state against the one-process run's, relative L2 by part.
# ResNet-50's float32 step amplifies rounding: one process on its B=64
# batch in reverse row order moves the backbone's gradient 38.5% and
# Adam's first update 61.1% in L2 (bn_control, float32; H100 80GB HBM3,
# 700 W), as far as dp 2 does, and against one process on its own
# BatchNorm kernel dp 2's update lies 47% off. Against one process on the
# mesh's BatchNorm (MESH_REF_SYNC) it lies 14.9% off, Adam's first moment
# 2.4%, the fits' change 1.7%, the statistics' change 3.6e-4. The bars:
# Adam's first moment 0.1 and the parameter update 0.4, the CPU test's
# (tests/_torch_train_parity.JAX_GAP); the fits' change 0.1 and the
# BatchNorm statistics' change 4e-3, 5-10x those readings and below what
# the statistics move without their sync (9.0e-3 in one step,
# bn_control). That the sync is exact is held in float64 by bn_control;
# element by element only where no BatchNorm amplifies (ViT-S/16) or the
# ranks repeat one process bit for bit (cp).
MESH_GAP = {'mu': 0.1, 'params': 0.4, 'fits': 0.1, 'buffers': 4e-3}
# ViT-S/16 (no BatchNorm) element by element at the CPU test's bars:
# Adam's first moment at the gradient bar rtol 1e-3 + atol 1e-5 of each
# tensor's largest; a parameter within S lr min(2, 3 bar / |m|), what m
# known to its bar moves Adam's step (tests/_torch_train_parity.py)
MESH_GRAD_RTOL, MESH_GRAD_ATOL = 1e-3, 1e-5
# phase 20's control of ResNet-50's BatchNorm over dp (bn_control): dp 2
# against one process in float64, element by element at the bars of
# tests/test_torch_port_parallel_train.py (BN64_*: rtol, and atol of each
# tensor's largest); in float32, dp's gradient and first update no further
# from one process than BN32_FACTOR times a reversed batch order's (the
# CPU test's 'no noisier than twice') plus the gradient bar's rtol
BN64_RTOL, BN64_ATOL = 1e-9, 1e-12
BN32_FACTOR = 2.0
MESH_EVAL_N = 72                 # a batch of 64 and a ragged one of 8
MESH_EFT_STEPS = 10               # a fit's steps (phase 15 runs 50)


T0 = time.perf_counter()


def clock(phase):
    """The script's wall time as a phase starts (where the 1200 s go)."""
    print(f'[clock] phase {phase} starts at {time.perf_counter() - T0:.0f} s',
          flush=True)


def check(ok, msg):
    if not ok:
        raise RuntimeError(f'check failed: {msg}')


def card_line() -> str:
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=20, warmup=3):
    """Mean device time of fn() over iters launches, by CUDA events."""
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


def graph_ms(fn, iters=20):
    """Device time of fn() (ms): iters calls captured in one CUDA graph and
    replayed, so the host's per-call cost does not enter."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    ms = cuda_ms(graph.replay, iters=3, warmup=1) / iters
    del graph
    return ms


def mha_bound(B, N, C, H, dtype):
    """Least time (ms) for the attention of one launch on the route the
    kernel takes, the bound ('bytes' or 'operations') and the route: bf16
    on the tensor cores; fp32 in 3xTF32, three TF32 products per product."""
    hd = C // H
    nbytes = (3 * C + C) * N * B * torch.finfo(dtype).bits // 8
    flops = 4 * B * H * N * N * hd
    if dtype == torch.bfloat16:
        t_ops, route = flops / PEAK_FLOPS[dtype], 'bf16 tensor cores'
    else:
        t_ops, route = 3 * flops / TF32_FLOPS, '3xTF32 tensor cores'
    t_bytes = nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_bytes, t_ops), ('bytes' if t_bytes >= t_ops
                                       else 'operations'), route


# ---------------------------------------------------------------------------
def phase_build():
    from tuch_tpu_torch.ops import _build
    secs = _build.build()
    for name in _build.sources():
        regs = [ln.split(':', 1)[1].strip()
                for ln in _build.BUILD_LOG.get(name, '').splitlines()
                if 'registers' in ln]
        print(f'[build] {name}: {regs}', flush=True)
    print(f'[build] {len(_build.sources())} kernel source(s) built in '
          f'{secs:.2f} s', flush=True)


def phase_kernels(results):
    import torch.nn.functional as F
    from tuch_tpu_torch.ops import attention as A
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(0)
    worst = {}
    shapes = [(s, B) for s in (VIT_S16, VIT_T8, ODD, VITPOSE_H)
              for B in (1, 64)]
    shapes += [(s, 3) for s in EDGES]
    for dtype in (torch.float32, torch.bfloat16):
        for shape, B in shapes:
            N, C, H = shape['N'], shape['C'], shape['H']
            x = torch.randn(B, N, 3 * C, device=dev, generator=gen)
            x = x.to(dtype)
            got = A.mha_cuda(x, H)
            want = A.mha_reference(x, H)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            print(f'[kernel] mha {str(dtype)[6:]} B={B} N={N} C={C} '
                  f'H={H}: max_abs_err {err:.3g} (tol {TOL[dtype]})',
                  flush=True)
            check(err <= TOL[dtype] and got.shape == want.shape,
                  f'mha {dtype} B={B} N={N}: err {err}')
            hd = 'hd80' if C // H == 80 else 'hd32/64'
            worst[hd, dtype] = max(worst.get((hd, dtype), 0.0), err)
    # results: ViT-S/16's B=64 under the dtype; ViTPose-H's under
    # ('hd80', B, dtype), each with the largest error at its head dims
    timed = [(dtype, 64, VIT_S16) for dtype in (torch.float32,
                                                torch.bfloat16)]
    timed += [(('hd80', B, dtype), B, VITPOSE_H) for B in (1, 64)
              for dtype in (torch.float32, torch.bfloat16)]
    for key, B, shape in timed:
        dtype = key if isinstance(key, torch.dtype) else key[2]
        N, C, H = shape['N'], shape['C'], shape['H']
        x = torch.randn(B, N, 3 * C, device=dev, generator=gen).to(dtype)
        q, k, v = x.view(B, N, 3, H, C // H).permute(2, 0, 3, 1, 4)
        ms = graph_ms(lambda: A.mha_cuda(x, H))
        plain_ms = graph_ms(lambda: A.mha_reference(x, H))
        lib_ms = graph_ms(lambda: F.scaled_dot_product_attention(q, k, v))
        bound_ms, bound_by, route = mha_bound(B, N, C, H, dtype)
        print(f'[kernel] mha {str(dtype)[6:]} B={B} N={N} C={C} H={H}: '
              f'kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, '
              f'sdpa {lib_ms:.4f} ms, bound {bound_ms:.4f} ms '
              f'({bound_by}, {route}), {bound_ms / ms:.1%} of bound '
              f'(CUDA-graph replay, device time)', flush=True)
        hd = 'hd80' if C // H == 80 else 'hd32/64'
        results[key] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                            bound_ms=bound_ms, bound_by=bound_by,
                            max_abs_err=worst[hd, dtype])
    for dtype in (torch.float32, torch.bfloat16):
        _hold_mha_grad(64, VIT_S16['N'], VIT_S16['C'], VIT_S16['H'], dtype,
                       gen)
        _hold_mha_grad(1, VITPOSE_H['N'], VITPOSE_H['C'], VITPOSE_H['H'],
                       dtype, gen)
    _hold_vit_grad(gen)


@functools.lru_cache(maxsize=None)
def hmr_param_shapes(backbone):
    """The parameter shapes of HMR with `backbone` (ResNet-50 and the
    IEF head: 169; ViT-S/16: 158; hmr2_vith16, HMR 2.0: 500), from the
    model built on the meta device."""
    from tuch_tpu_torch.models import hmr as H
    means = (np.zeros(144), np.zeros(10), np.zeros(3))
    with torch.device('meta'):
        m = H.create_hmr(*means, backbone=backbone)
    return [tuple(p.shape) for p in m.parameters()]


def phase_adam(results):
    """The Adam kernel at each model's leaves in float32, in place: one
    step against the plain update bit for bit, then its time, the plain
    update followed by its copy into the parameters (the EFT step before
    the kernel) and torch._fused_adam_ (a yardstick the port never calls),
    by CUDA-graph replay of whole steps (device time, without the host's
    cost), beside the bytes' bound (28 B a float at HBM_BYTES_PER_S).
    The launches checked here are this one call's; the summary's come
    from phase 15's counted EFT run."""
    from tuch_tpu_torch.ops import _build
    from tuch_tpu_torch.ops import adam as OA
    gen = torch.Generator(device=DEV).manual_seed(0)
    for model in ('hmr2', 'resnet50'):
        shapes = hmr_param_shapes('hmr2_vith16' if model == 'hmr2'
                                  else model)
        p = [torch.randn(s, generator=gen, device=DEV) for s in shapes]
        g = [torch.randn(s, generator=gen, device=DEV) * 1e-2
             for s in shapes]
        m = [torch.randn(s, generator=gen, device=DEV) * 1e-3
             for s in shapes]
        v = [torch.rand(s, generator=gen, device=DEV) * 1e-6
             for s in shapes]
        hyper = dict(lr=1e-5, b1=0.9, b2=0.999, eps=1e-8,
                     c1=1 - np.float32(0.9) ** 3,
                     c2=1 - np.float32(0.999) ** 3)
        want = OA.adam_plain(p, g, m, v, **hyper)
        n0 = OA.adam_cuda.launches
        OA.adam_cuda(p, g, m, v, **hyper)
        launches = OA.adam_cuda.launches - n0
        torch.cuda.synchronize()
        same = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for got, ref in zip((p, m, v), want)
                   for a, b in zip(got, ref))
        del want
        floats = sum(t.numel() for t in p)
        plan = OA.chunk_plan([t.numel() for t in p])
        check(same and launches == len(plan),
              f'adam {model}: bit for bit {same}, launches {launches} '
              f'against the plan\'s {len(plan)}')

        def plain():
            new = OA.adam_plain(p, g, m, v, **hyper)
            torch._foreach_copy_(p, new[0])

        steps = [torch.tensor(3.0, device=DEV) for _ in p]

        def fused():
            torch._fused_adam_(p, g, m, v, [], steps, lr=1e-5, beta1=0.9,
                               beta2=0.999, weight_decay=0.0, eps=1e-8,
                               amsgrad=False, maximize=False)

        iters = 5 if model == 'hmr2' else 20
        ms = graph_ms(lambda: OA.adam_cuda(p, g, m, v, **hyper), iters)
        plain_ms = graph_ms(plain, iters)
        lib_ms = graph_ms(fused, iters)
        bound_ms = 1e3 * 28 * floats / HBM_BYTES_PER_S
        print(f'[kernel] adam {model}: {len(p)} tensors, {floats} floats, '
              f'{launches} launches a step; kernel {ms:.4f} ms, plain '
              f'{plain_ms:.4f} ms, fused_adam {lib_ms:.4f} ms, bound '
              f'{bound_ms:.4f} ms (bytes), {bound_ms / ms:.1%} of bound '
              f'(CUDA-graph replay of whole steps, device time); equal to '
              f'the plain update bit for bit', flush=True)
        results['adam', model] = dict(
            ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
            bound_by='bytes', max_abs_err=0.0)
        del p, g, m, v, steps
        torch.cuda.empty_cache()
    lines = _build.BUILD_LOG.get('adam', '').splitlines()
    for i, ln in enumerate(lines):
        if 'Compiling entry function' in ln and 'tuch_adam_kernel' in ln:
            info = [x.strip() for x in lines[i + 1:i + 5]
                    if 'registers' in x or 'spill' in x]
            print(f'[kernel] adam ptxas {ln.split()[-1]}: {info}',
                  flush=True)


def adam_rows(kernels, launches):
    """The Adam kernel's rows of the kernel summary, one a leaf set, with
    the launches of one EFT step as phase 15's run counted them at
    ResNet-50's (None at HMR 2.0's: no phase here fits with HMR 2.0, the
    benchmark's fit.hmr2_vith16.eft_b1 counts them)."""
    return [dict(name=f'adam_{model}', source='tuch_tpu_torch/csrc/adam.cu',
                 replaces='none (the JAX package runs optax.adam)',
                 launches=launches.get('adam') if model == 'resnet50'
                 else None, **kernels['adam', model])
            for model in ('hmr2', 'resnet50')]


def mha_rows(kernels, launches):
    """Kernel 1's rows of the kernel summary: ViT-S/16 at B=64 with its
    launches per serving forward, and ViTPose-H at B=1 (HMR 2.0's EFT step;
    launches None: no phase here runs HMR 2.0, the benchmark's
    fit.hmr2_vith16.eft_b1 counts them)."""
    rows = []
    for name, dt in (('mha', 'float32'), ('mha_bf16', 'bfloat16')):
        dtype = getattr(torch, dt)
        rows.append(dict(name=name, source='tuch_tpu_torch/csrc/mha.cu',
                         replaces='tuch_tpu/ops/attention_pallas.py:70',
                         launches=launches.get(f'vit_s16 {dt}'),
                         **kernels[dtype]))
        rows.append(dict(rows[-1], name=name.replace('mha', 'mha_hd80'),
                         launches=None, **kernels['hd80', 1, dtype]))
    return rows


def kernel_summary(rows):
    """The kernel summary line's object."""
    keys = ('name', 'route', 'source', 'replaces', 'launches', 'max_abs_err',
            'ms', 'plain_ms', 'bound_ms', 'bound_by', 'library_ms')
    return {'kernels': [{key: dict(row, route='cuda')[key] for key in keys}
                        for row in rows]}


def _hold_mha_grad(B, N, C, H, dtype, gen):
    """fused_mha with a gradient: one kernel 1 launch forward, and the
    backward against mha_reference's gradient on the same qkv."""
    from tuch_tpu_torch.ops import attention as A
    x = torch.randn(B, N, 3 * C, device='cuda', generator=gen).to(dtype)
    g = torch.randn(B, N, C, device='cuda', generator=gen).to(dtype)
    qkv = x.clone().requires_grad_(True)
    before = A.mha_cuda.launches
    out = A.fused_mha(qkv, H)
    out.backward(g)
    ref_x = x.clone().requires_grad_(True)
    A.mha_reference(ref_x, H).backward(g)
    torch.cuda.synchronize()
    launched = A.mha_cuda.launches - before
    scale = ref_x.grad.float().abs().max().item()
    err = (qkv.grad.float() - ref_x.grad.float()).abs().max().item()
    print(f'[kernel] mha gradient {str(dtype)[6:]} B={B} N={N} C={C} H={H}: '
          f'max abs diff to mha_reference\'s {err:.3g} (bar '
          f'{GRAD_RTOL[dtype]:.3g} x {scale:.3g}); kernel launches {launched}',
          flush=True)
    check(launched == 1 and qkv.grad.dtype == dtype
          and err <= GRAD_RTOL[dtype] * scale,
          f'mha gradient {dtype}: err {err}, launches {launched}')


def _hold_vit_grad(gen):
    """One ViT-S/16 backward at 224 through kernel 1 (12 launches), its
    qkv weight gradients against the same backward with mha_reference in
    the kernel's place."""
    from tuch_tpu_torch import assets
    from tuch_tpu_torch.models import hmr as hmr_mod
    from tuch_tpu_torch.models import vit as vit_mod
    from tuch_tpu_torch.ops import attention as A
    _, means = assets.synthetic_smpl(num_verts=170)
    hmr = hmr_mod.init_weights(hmr_mod.create_hmr(*means,
                                                  backbone='vit_s16'))
    vit = hmr.backbone.to('cuda').train()
    x = torch.randn(VIT_GRAD_B, 224, 224, 3, device='cuda', generator=gen)
    w = torch.randn(VIT_GRAD_B, vit.width, device='cuda', generator=gen)

    def qkv_grads():
        vit.zero_grad()
        (vit(x) * w).sum().backward()
        return [b.attn.qkv.weight.grad.clone() for b in vit.blocks]

    before = A.mha_cuda.launches
    got = qkv_grads()
    launched = A.mha_cuda.launches - before
    try:
        vit_mod.fused_mha = A.mha_reference
        want = qkv_grads()
    finally:
        vit_mod.fused_mha = A.fused_mha
    torch.cuda.synchronize()
    rel = max(((a - b).abs().max() / b.abs().max()).item()
              for a, b in zip(got, want))
    print(f'[kernel] ViT-S/16 backward B={VIT_GRAD_B} at 224: kernel 1 '
          f'launches {launched} (expected {VIT_S16_DEPTH}); qkv weight '
          f'gradients of {len(got)} blocks against mha_reference in its '
          f'place: worst max abs diff / max abs {rel:.3g} (bar '
          f'{VIT_GRAD_RTOL})', flush=True)
    check(launched == VIT_S16_DEPTH and rel <= VIT_GRAD_RTOL
          and all(bool(torch.isfinite(t).all()) for t in got),
          f'ViT backward: launches {launched}, rel {rel}')


def _png_b64(seed, size=(240, 320)):
    from PIL import Image
    rng = np.random.RandomState(seed)
    img = Image.fromarray(rng.randint(0, 255, size + (3,), np.uint8))
    buf = io.BytesIO()
    img.save(buf, format='PNG')
    return base64.b64encode(buf.getvalue()).decode()


def _http(url, payload=None):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data,
                                 headers={'Content-Type': 'application/json'})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _check_prediction(code, body, num_verts, what):
    check(code == 200, f'{what}: status {code} {body}')
    shapes = [np.shape(body[k]) for k in
              ('pose', 'betas', 'camera', 'cam_t', 'vertices')]
    check(shapes == [(72,), (10,), (3,), (3,), (num_verts, 3)],
          f'{what}: output shapes {shapes}')
    check(all(np.isfinite(body[k]).all() for k in
              ('pose', 'betas', 'camera', 'cam_t', 'vertices')),
          f'{what}: non-finite outputs')


def phase_serve(backbone, dtype, launches):
    """Serve a few requests; returns the warm predictor (batcher closed)."""
    from tuch_tpu_torch import constants
    from tuch_tpu_torch.cli.serve import build_server
    from tuch_tpu_torch.ops import attention as A
    tag = f'{backbone} {dtype}'
    t0 = time.perf_counter()
    httpd = build_server(SimpleNamespace(
        checkpoint=None, synthetic=True, img_res=224,
        synthetic_num_verts=None, max_batch=SERVE_BUCKET,
        batch_wait_ms=500.0, backbone=backbone, device='cuda', dtype=dtype,
        host='127.0.0.1', port=0))
    predictor = httpd.predictor
    check(predictor.num_verts == constants.SMPL_NUM_VERTS,
          f'body has {predictor.num_verts} vertices')
    check(predictor.hmr.dtype == getattr(torch, dtype),
          f'{tag}: HMR computes in {predictor.hmr.dtype}')
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f'http://127.0.0.1:{httpd.server_address[1]}'
    print(f'[serve {tag}] built and warmed {predictor._buckets} in '
          f'{time.perf_counter() - t0:.1f} s', flush=True)
    try:
        code, health = _http(url + '/healthz')
        check(code == 200 and health['backend'] == 'cuda' and health['warm'],
              f'healthz {code} {health}')
        images = [_png_b64(seed) for seed in range(SERVE_BUCKET + 1)]
        A.mha_cuda.launches = 0          # the main path starts here
        code, body = _http(url + '/predict', {'image_b64': images[0],
                                              'return_vertices': True})
        _check_prediction(code, body, predictor.num_verts, 'single request')
        replies = [None] * SERVE_BUCKET

        def hit(i):
            replies[i] = _http(url + '/predict', {
                'image_b64': images[i + 1], 'return_vertices': True})

        burst = [threading.Thread(target=hit, args=(i,))
                 for i in range(SERVE_BUCKET)]
        for t in burst:
            t.start()
        for t in burst:
            t.join(timeout=300)
        count = A.mha_cuda.launches      # ... and ends here
        for t in burst:
            check(not t.is_alive(), 'a burst request did not finish')
        for i, (code, body) in enumerate(replies):
            _check_prediction(code, body, predictor.num_verts, f'burst {i}')
        code, m = _http(url + '/metrics')
        check(code == 200 and m['requests_ok'] == SERVE_BUCKET + 1,
              f'metrics {m}')
        forwards = m['batched_forwards']
        check(m['batch_size_max'] == SERVE_BUCKET,
              f'the burst did not fill a bucket of {SERVE_BUCKET}: {m}')
        per_forward = VIT_S16_DEPTH if backbone == 'vit_s16' else 0
        print(f'[serve {tag}] {SERVE_BUCKET + 1} requests answered 200 '
              f'in {forwards} device forwards (batch sizes up to '
              f'{m["batch_size_max"]}); mha launches {count}, expected '
              f'{per_forward} per forward; p50 latency '
              f'{m["forward_latency_ms_p50"]} ms', flush=True)
        check(count == per_forward * forwards,
              f'{tag}: mha launched {count} times in {forwards} forwards')
        launches[tag] = count
        code, body = _http(url + '/predict', {'image_b64': 'not base64!'})
        check(code == 400, f'bad payload answered {code}')
    finally:
        httpd.shutdown()
        predictor.close()
        httpd.server_close()
        thread.join(timeout=30)
    check(not thread.is_alive(), 'server thread did not stop')
    return predictor


def phase_parity(backbone, card_fp32, card_bf16):
    """The card's fp32 outputs against the port's CPU path on the same
    image (tol 1e-3), and the card's bf16 ones against the card's fp32 ones
    (tol BF16_VERTEX_ATOL)."""
    from PIL import Image
    from tuch_tpu_torch.cli.serve import TuchPredictor
    cpu = TuchPredictor(synthetic=True, img_res=224, backbone=backbone,
                        device='cpu')
    with Image.open(io.BytesIO(base64.b64decode(_png_b64(7)))) as im:
        norm = cpu._crop(np.asarray(im.convert('RGB')), {})
    got = card_fp32._run_forward(norm)
    names = ('pose', 'betas', 'camera', 'cam_t', 'vertices')
    for what, a, b, tol in (
            ('card fp32 vs CPU fp32', got, cpu._run_forward(norm), 1e-3),
            ('card bf16 vs card fp32', card_bf16._run_forward(norm), got,
             BF16_VERTEX_ATOL)):
        check(all(x.dtype == np.float32 for x in a), f'{what}: not float32')
        errs = [float(np.abs(x - y).max()) for x, y in zip(a, b)]
        print(f'[parity {backbone}] {what} max abs diff: ' + ', '.join(
            f'{n} {e:.3g}' for n, e in zip(names, errs))
            + f' (vertex tol {tol})', flush=True)
        check(errs[4] <= tol, f'{backbone} {what}: vertices differ by '
              f'{errs[4]}')


def profiled(fn):
    """One call of fn under torch.profiler, after one unprofiled call:
    (host wall ms, the profile)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    return wall, prof


def device_breakdown(fn, top=6):
    """One profiled call of fn: host wall ms, device busy ms and the
    kernels with the most device time as (name, ms, calls)."""
    wall, prof = profiled(fn)
    return (wall, *kernel_rows(prof, top))


def one_call_work(fn, name):
    """The device work of one call of fn as (name, ms, calls). On an H100
    with torch 2.11 a capture now and then holds the runtime's launch call
    but no device kernel: the kernel's record is lost, not the kernel (3 of
    48 one-call captures in fresh processes, 1 of 300 in one process, with
    or without 2 ms of idle host time around the call;
    tools/profile_capture_repeat.py). Such a capture is taken again, up to
    CAPTURE_TRIES times in all; one without a launch call stands."""
    from torch.autograd import DeviceType
    for attempt in range(1, CAPTURE_TRIES + 1):
        _, prof = profiled(fn)
        _, work = kernel_rows(prof, top=6)
        launched = sum(e.count for e in prof.key_averages()
                       if e.device_type != DeviceType.CUDA
                       and e.key.startswith(LAUNCH_CALLS))
        if work or not launched or attempt == CAPTURE_TRIES:
            return work
        print(f'[kernel] {name}: capture {attempt} of one call holds '
              f'{launched} launch call(s) and no device kernel; taken again',
              flush=True)


def kernel_rows(prof, top):
    """A profile's device busy ms and its kernels with the most device time
    as (name, ms, calls); record_function spans on the device (named
    'train_step.<part>' or 'eft_step.<part>') are ranges, not kernels, and
    are left out."""
    from torch.autograd import DeviceType
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not e.key.startswith(('train_step.', 'eft_step.'))]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    rows = sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]
    return busy, [(e.key[:70], e.self_device_time_total / 1e3, e.count)
                  for e in rows]


def phase_times(tag, predictor, card):
    norm = np.random.RandomState(0).randn(1, 224, 224, 3).astype(np.float32)
    for _ in range(3):
        predictor._run_forward(norm)
    lat = []
    for _ in range(20):
        t0 = time.perf_counter()
        predictor._run_forward(norm)     # copies in and out, synchronous
        lat.append(1e3 * (time.perf_counter() - t0))
    x = torch.randn(64, 224, 224, 3, device='cuda')
    ms64 = cuda_ms(lambda: predictor.forward(x), iters=10, warmup=2)
    print(f'[times {tag}] B=1 forward {np.median(lat):.3f} ms median '
          f'of 20 (host clock, copies in and out); B=64 {ms64:.3f} ms = '
          f'{64e3 / ms64:.1f} images/s (CUDA events, input on the card); '
          f'TF32 cuDNN {torch.backends.cudnn.allow_tf32}; card: {card}',
          flush=True)
    for label, fn in (('B=1', lambda: predictor._run_forward(norm)),
                      ('B=64', lambda: predictor.forward(x))):
        wall, busy, rows = device_breakdown(fn)
        if busy <= 0:
            print(f'[profile {tag} {label}] the profiler recorded no '
                  'device time', flush=True)
            continue
        print(f'[profile {tag} {label}] host wall {wall:.3f} ms, device '
              f'busy {busy:.3f} ms, idle share {1 - busy / wall:.1%} '
              f'(torch.profiler, one forward)', flush=True)
        for name, ms, calls in rows:
            print(f'[profile {tag} {label}]   {ms:8.3f} ms '
                  f'{ms / busy:6.1%} x{calls:<4d} {name}', flush=True)


# ---------------------------------------------------------------------------
# SMPLify-DC slice
# ---------------------------------------------------------------------------

def bound(ops, nbytes):
    """Least time (ms) for `ops` fp32 operations and `nbytes` bytes on the
    card, and which of the two bounds it."""
    t_ops, t_bytes = ops / PEAK_FLOPS[torch.float32], nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ('bytes' if t_bytes >= t_ops
                                       else 'operations')


def slice_counters():
    from tuch_tpu_torch.ops import adam as OA
    from tuch_tpu_torch.ops import contact_kernels as CK
    from tuch_tpu_torch.ops import gather as G
    return {'winding': CK.winding_numbers_tris_cuda,
            'masked_min': CK.masked_min_dist_cuda,
            'gather': G.gather_rows_cuda,
            'scatter_add': G.scatter_add_rows_cuda,
            'adam': OA.adam_cuda}


def posed_verts(smpl, B, scale, seed):
    from tuch_tpu_torch.models.smpl import smpl_forward
    dev = smpl.v_template.device
    rng = np.random.RandomState(seed)
    pose = torch.as_tensor((rng.randn(B, 72) * scale).astype(np.float32),
                           device=dev)
    with torch.no_grad():
        return smpl_forward(smpl, torch.zeros(B, 10, device=dev),
                            pose[:, 3:], pose[:, :3]).vertices.contiguous()


def fit_inputs(B, num_classes, seed, dev):
    """A fitting problem at img_res 224 from numpy: init pose, betas and
    camera, keypoints in pixels with confidences, contact labels."""
    rng = np.random.RandomState(seed)
    init_pose = (rng.randn(B, 72) * 0.2).astype(np.float32)
    cam_t = np.tile(np.array([[0.0, 0.2, 40.0]], np.float32), (B, 1))
    kp = np.concatenate([rng.uniform(40, 184, (B, 49, 2)),
                         rng.uniform(0.5, 1.0, (B, 49, 1))], -1)
    contact = (rng.rand(B, num_classes) > 0.7).astype(np.float32)
    arrays = [init_pose, np.zeros((B, 10), np.float32), cam_t,
              np.full((B, 2), 112.0, np.float32), kp.astype(np.float32),
              contact]
    flags = [np.zeros(B, bool), np.ones(B, bool), rng.rand(B) > 0.5]
    return ([torch.as_tensor(a, device=dev) for a in arrays]
            + [torch.as_tensor(f, device=dev) for f in flags])


def _hold_winding(label, pts, tris):
    from tuch_tpu_torch.ops import contact as PC
    from tuch_tpu_torch.ops import contact_kernels as CK
    got = CK.winding_numbers_tris_cuda(pts, tris)
    want = torch.cat(_chunked(PC.winding_numbers, pts, tris))
    return _winding_err(label, pts, tris.shape[1], got, want)


def _winding_err(label, pts, num_faces, got, want):
    """Kernel 2's winding numbers `got` against the plain version's: the
    largest error and the in/out flips at 0.99 outside the band, at
    kernel 2's bar."""
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    band = (want - 0.99).abs() < WN_BAND
    flips = (((got <= 0.99) != (want <= 0.99)) & ~band).sum().item()
    print(f'[kernel] winding {label} {tuple(pts.shape)} x '
          f'({num_faces},) tris: max_abs_err {err:.3g} (tol '
          f'{WN_ATOL}), in/out flips outside the band {flips}, values in '
          f'the band |wn - 0.99| < {WN_BAND}: {band.sum().item()}, '
          f'interior {(want > 0.99).sum().item()}', flush=True)
    check(got.shape == want.shape and err <= WN_ATOL and flips == 0,
          f'winding {label}: err {err}, flips {flips}')
    return err


def _hold_masked_min(label, verts, mask, bits):
    from tuch_tpu_torch.ops import contact as PC
    from tuch_tpu_torch.ops import contact_kernels as CK
    d2, arg = CK.masked_min_dist_cuda(verts, mask, bits)
    parts = _chunked(lambda v: PC.masked_min_dist(v, mask), verts)
    want_d2, want_arg = (torch.cat(t) for t in zip(*parts))
    torch.cuda.synchronize()
    fin = torch.isfinite(want_d2)
    check(torch.equal(fin, torch.isfinite(d2)), f'{label}: inf rows differ')
    err = (d2 - want_d2)[fin].abs().max().item()
    rel_ok = ((d2 - want_d2).abs()[fin]
              <= D2_RTOL * want_d2[fin]).all().item()
    # another argmin only at a tie of the plain d2 within D2_RTOL
    diff = verts - torch.gather(verts, 1, arg.long()[..., None].expand(
        -1, -1, 3))
    pick = diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1] \
        + diff[..., 2] * diff[..., 2]
    differ = (arg != want_arg) & fin
    ties_ok = ((pick - want_d2).abs()[differ]
               <= D2_RTOL * want_d2[differ]).all().item()
    rows = torch.arange(verts.shape[1], device=verts.device)
    allowed = (mask[rows[None].expand_as(arg), arg.long()] > 0)[fin]
    print(f'[kernel] masked_min {label} {tuple(verts.shape)}: d2 max_abs_err '
          f'{err:.3g} (rtol {D2_RTOL}), argmin differs at '
          f'{differ.sum().item()} (ties within rtol {D2_RTOL}), every pick '
          f'allowed {bool(allowed.all())}', flush=True)
    check(rel_ok and ties_ok and bool(allowed.all()),
          f'masked_min {label}: rel {rel_ok}, ties {ties_ok}')
    return err, arg


def _hold_scatter(label, idx, V, seed):
    """Kernel 6 on randn contributions against the plain version on the
    CPU (index_add_ there adds each row in ascending q, as the kernel does:
    bit for bit, SCATTER_ATOL 0), and a second launch on the same input
    against the first (bit for bit). Returns the largest error."""
    from tuch_tpu_torch.ops import gather as G
    B = idx.shape[0]
    contrib = torch.randn(B, idx.shape[1], 3, device=idx.device,
                          generator=torch.Generator(idx.device)
                          .manual_seed(seed))
    first = G.scatter_add_rows_cuda(contrib, idx, V)
    again = G.scatter_add_rows_cuda(contrib, idx, V)
    want = G.scatter_add_rows_ref(contrib.cpu(), idx.cpu(), V)
    e = (first.cpu() - want).abs().max().item()
    repeat = torch.equal(first, again)
    print(f'[kernel] scatter_add {label} V={V} Q={idx.shape[1]}: max_abs_err '
          f'{e:.3g} against the plain version on the CPU (tol '
          f'{SCATTER_ATOL}), two launches bit for bit {repeat}', flush=True)
    check(e <= SCATTER_ATOL and repeat,
          f'scatter_add {label}: err {e}, repeat {repeat}')
    return e


def _hold_scatter_edges(idx, V):
    """_hold_scatter where kernel 6's plan has edges, from the posed B=64
    body's nearest vertices `idx`: the demo's and an EFT step's batches
    (4 and 1), every q on one row (one long chain), half the rows empty,
    Q below V (the candidate gather's shape), and every q on the two rows
    either side of the first CTA edge of the B=64 plan (two long rows, one
    ending a CTA's range and one starting the next). Returns the largest
    error."""
    from tuch_tpu_torch.ops import gather as G
    B, Q = idx.shape
    rows = -(-V // G.scatter_plan(B, V, Q))
    cases = {f'posed B={b}': idx[:b] for b in (FIT_IMAGES, 1)}
    cases.update({
        'B=1 every q on one row': torch.full_like(idx[:1], V // 2),
        f'B={FIT_IMAGES} half the rows empty': idx[:FIT_IMAGES] // 2 * 2,
        f'B={FIT_IMAGES} Q={CP_K} (the candidate gather)':
            idx[:FIT_IMAGES, :CP_K],
        f'B={B} every q either side of a CTA edge':
            torch.where(idx % 2 == 0, rows - 1, rows).int()})
    return max(_hold_scatter(label, i.contiguous(), V, seed=n)
               for n, (label, i) in enumerate(cases.items()))


def _chunked(fn, *tensors):
    """The plain version over a B=64 input in batches of PLAIN_CHUNK (its
    intermediates at B=64 would need tens of GB)."""
    B = tensors[0].shape[0]
    return [fn(*(t[i:i + PLAIN_CHUNK] for t in tensors))
            for i in range(0, B, PLAIN_CHUNK)]


def phase_slice_kernels(runtime, results):
    """Kernels 2, 4, 5, 6 against their plain versions at the slice's
    shapes, then each one's time at B=64."""
    from tuch_tpu_torch.ops import contact as PC
    from tuch_tpu_torch.ops import contact_kernels as CK
    from tuch_tpu_torch.ops import gather as G
    from tuch_tpu_torch.ops.segments import fused_problem
    smpl, contact = runtime.smpl, runtime.contact
    faces, mask, bits = contact.faces, contact.geomask, contact.geomask_bits
    V = smpl.v_template.shape[0]
    err = dict(winding=0.0, masked_min=0.0, gather=0.0, scatter_add=0.0)
    for B in (1, 8):
        bodies = {'rest': smpl.v_template[None].expand(B, -1, -1)
                  .contiguous(), 'posed': posed_verts(smpl, B, 0.3, B)}
        for name, verts in bodies.items():
            err['winding'] = max(err['winding'], _hold_winding(
                f'{name} B={B} self', verts, verts[:, faces]))
            err['winding'] = max(err['winding'], _hold_winding(
                f'{name} B={B} segments',
                *fused_problem(contact.segment_tables, verts)))
            e, arg = _hold_masked_min(f'{name} B={B}', verts, mask, bits)
            err['masked_min'] = max(err['masked_min'], e)
        idx = arg.clone()
        idx[0, :5] = -1
        if B > 1:
            idx[1, :3] = V
        got = G.gather_rows_cuda(verts, idx)
        want = G.gather_rows_ref(verts, idx)
        torch.cuda.synchronize()
        bitwise = torch.equal(got, want)
        print(f'[kernel] gather B={B} V={V} Q={V} (with -1 and V indices): '
              f'bitwise equal {bitwise}', flush=True)
        check(bitwise, f'gather {bitwise}')
        err['scatter_add'] = max(err['scatter_add'], _hold_scatter(
            f'B={B} (with -1 and V indices)', idx, V, seed=B))

    # times at the training batch
    B = TRAIN_B
    verts = posed_verts(smpl, B, 0.3, 99)
    tris = verts[:, faces]
    e, idx = _hold_masked_min(f'posed B={B}', verts, mask, bits)
    err['masked_min'] = max(err['masked_min'], e)
    err['winding'] = max(err['winding'], _hold_winding(
        f'posed B={B} self', verts, tris))
    ms = cuda_ms(lambda: CK.winding_numbers_tris_cuda(verts, tris), iters=5,
                 warmup=1)
    plain_ms = cuda_ms(lambda: _chunked(PC.winding_numbers, verts, tris),
                       iters=2, warmup=1)
    bound_ms, bound_by = bound(WINDING_OPS_PER_PAIR * B * V * tris.shape[1],
                               4 * B * (3 * V + 9 * tris.shape[1] + V))
    print(f'[kernel] winding B={B} V={V}: kernel {ms:.4f} ms, plain '
          f'{plain_ms:.4f} ms ({B // PLAIN_CHUNK} x B={PLAIN_CHUNK}), '
          f'no one-call library equivalent, bound {bound_ms:.4f} ms '
          f'({bound_by}), {bound_ms / ms:.1%} of bound', flush=True)
    results['winding'] = dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                              bound_ms=bound_ms, bound_by=bound_by,
                              max_abs_err=err['winding'])
    err['scatter_add'] = max(err['scatter_add'], _hold_scatter(
        f'posed B={B}', idx, V, seed=B), _hold_scatter_edges(idx, V))
    for b in (FIT_IMAGES, TRAIN_B):
        _time_masked_min(verts[:b].contiguous(), mask, bits, results, err)
    _time_rows(verts, idx, results, err)
    del verts, tris
    torch.cuda.empty_cache()


def ptxas_line(source, kernel):
    """The registers and spills ptxas reported for `kernel` when this
    process built csrc/<source>.cu ('not built here' otherwise)."""
    from tuch_tpu_torch.ops import _build
    lines = _build.BUILD_LOG.get(source, '').splitlines()
    at = next((i for i, ln in enumerate(lines)
               if 'Compiling entry function' in ln and kernel in ln), None)
    if at is None:
        return 'not built here'
    tail = lines[at + 1:at + 5]
    spill = next((ln.strip() for ln in tail if 'spill' in ln), '')
    regs = next((ln.split(':', 1)[1].strip() for ln in tail
                 if 'registers' in ln), '')
    return f'{regs}; {spill}'


def _time_masked_min(verts, mask, bits, results, err):
    """Kernel 4 on the main path's form (the stored bits) by CUDA-graph
    replay beside its plain version and its bound; the training batch's
    row goes into results."""
    from tuch_tpu_torch.ops import contact as PC
    from tuch_tpu_torch.ops import contact_kernels as CK
    B, V, _ = verts.shape
    allowed = int(mask.sum().item())
    ms = graph_ms(lambda: CK.masked_min_dist_cuda(verts, mask, bits),
                  iters=10)
    plain_ms = cuda_ms(lambda: _chunked(
        lambda v: PC.masked_min_dist(v, mask), verts), iters=2, warmup=1)
    bound_ms, bound_by = bound(B * (V * V + MASKED_OPS_ALLOWED * allowed),
                               V * V + 12 * B * V + 8 * B * V)
    T, R, G, TM = CK.masked_min_shape()
    chunk, splits = CK.masked_min_plan(B, V, (T, R, G, TM))
    print(f'[kernel] masked_min B={B} V={V}: kernel {ms:.4f} ms (CUDA-graph '
          f'replay, device time), plain {plain_ms:.4f} ms '
          f'({-(-B // PLAIN_CHUNK)} x B={min(B, PLAIN_CHUNK)}), no one-call '
          f'library equivalent, bound {bound_ms:.4f} ms ({bound_by}), '
          f'{bound_ms / ms:.1%} of bound; {G} bodies and {T * R} queries '
          f'per block, {splits} splits of {chunk}; ptxas '
          f'{ptxas_line("masked_min", "masked_min_kernel")}', flush=True)
    if B == TRAIN_B:
        results['masked_min'] = dict(ms=ms, plain_ms=plain_ms,
                                     library_ms=None, bound_ms=bound_ms,
                                     bound_by=bound_by,
                                     max_abs_err=err['masked_min'])


def host_us(fn, calls=1000):
    """Host µs per call of fn: the host clock over `calls` calls, then one
    synchronize. What a host-bound caller (the fit at B=4) feels."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return 1e6 * (time.perf_counter() - t0) / calls


def _with_deterministic(fn, on):
    """fn with torch's deterministic mode on or off while it runs (a CUDA
    graph captured from it keeps the kernels that mode chose)."""
    def call():
        mode = torch.are_deterministic_algorithms_enabled()
        warn = torch.is_deterministic_algorithms_warn_only_enabled()
        torch.use_deterministic_algorithms(on, warn_only=True)
        try:
            return fn()
        finally:
            torch.use_deterministic_algorithms(mode, warn_only=warn)
    return call


def _row_calls(verts, idx):
    """{name: (kernel, plain, {library call: fn}, (bound ms, bound by),
    the plain version's result on the CPU)} of kernels 5 and 6 on these
    inputs. The scatter's library calls zero their output, as kernel 6
    does, and run index_add_ with torch's deterministic mode off (atomic
    adds) and on (the form the training entry points run,
    runtime.deterministic)."""
    from tuch_tpu_torch.ops import gather as G
    B, V, _ = verts.shape
    flat = (torch.arange(B, device=verts.device)[:, None] * V
            + idx.long()).reshape(-1)
    idx_long = idx.long()[..., None].expand(-1, -1, 3)
    rows = verts.reshape(-1, 3)
    contrib = torch.randn(B, V, 3, device=verts.device)
    src = contrib.reshape(-1, 3)
    buf = torch.empty(B * V, 3, device=verts.device)

    def zero_index_add():
        buf.zero_()
        return buf.index_add_(0, flat, src)

    nbytes = 4 * B * (3 * V + V + 3 * V)
    return {
        'gather': (lambda: G.gather_rows_cuda(verts, idx),
                   lambda: G.gather_rows_ref(verts, idx),
                   {'torch.gather': lambda: torch.gather(verts, 1, idx_long),
                    'index_select': lambda: torch.index_select(rows, 0,
                                                               flat)},
                   bound(0, nbytes),
                   lambda: G.gather_rows_ref(verts.cpu(), idx.cpu())),
        'scatter_add': (lambda: G.scatter_add_rows_cuda(contrib, idx, V),
                        lambda: G.scatter_add_rows_ref(contrib, idx, V),
                        {'zero_ + index_add_': _with_deterministic(
                            zero_index_add, False),
                         'zero_ + index_add_ (deterministic mode)':
                         _with_deterministic(zero_index_add, True)},
                        bound(3 * B * V, nbytes),
                        lambda: G.scatter_add_rows_ref(contrib.cpu(),
                                                       idx.cpu(), V)),
    }


def _time_rows(verts, idx, results, err):
    """Kernels 5 and 6 at the training batch: the kernel, its plain version
    and its library calls timed by CUDA-graph replay (device time only; a
    kernel shorter than its wrapper's host time is otherwise timed by the
    host), each beside the bound, and whether each library call gives the
    CPU's bits; then the host µs per call of the wrapper and of each
    library call at B=64 and at the demo's B=4, where the device time per
    call is below the host's; then kernel 6 at B=4 and 1 (the demo's fit,
    an EFT step) with its plan. The library yardstick is the faster
    call."""
    from tuch_tpu_torch.ops import gather as G
    B, V, _ = verts.shape
    small = {b: _row_calls(verts[:b].contiguous(), idx[:b].contiguous())
             for b in (FIT_IMAGES, 1)}
    for name, (kern, plain, libs, (bound_ms, bound_by), want) in \
            _row_calls(verts, idx).items():
        ms = graph_ms(kern, iters=50)
        plain_ms = graph_ms(plain, iters=20)
        lib_ms = {k: graph_ms(f, iters=50) for k, f in libs.items()}
        want = want()
        cpu_bits = {k: torch.equal(f().reshape(want.shape).cpu(), want)
                    for k, f in libs.items()}
        host = {}
        for tag, (k4, _, libs4, _, _) in (
                (f'B={B}', (kern, plain, libs, None, None)),
                (f'B={FIT_IMAGES}', small[FIT_IMAGES][name])):
            host[f'{tag} wrapper'] = host_us(k4)
            host.update({f'{tag} {k}': host_us(f) for k, f in libs4.items()})
        print(f'[kernel] {name} B={B} V={V} Q={V}: kernel {ms:.4f} ms, plain '
              f'{plain_ms:.4f} ms, ' + ', '.join(
                  f'{k} {t:.4f} ms (the CPU\'s bits {cpu_bits[k]})'
                  for k, t in lib_ms.items())
              + f', bound {bound_ms:.4f} ms ({bound_by}), '
              f'{bound_ms / ms:.1%} of bound (CUDA-graph replays, device '
              'time); host µs per call: ' + ', '.join(
                  f'{k} {t:.2f}' for k, t in host.items()), flush=True)
        results[name] = dict(ms=ms, plain_ms=plain_ms,
                             library_ms=min(lib_ms.values()),
                             bound_ms=bound_ms, bound_by=bound_by,
                             max_abs_err=err[name])
        # one kernel per call on the device: no memset pass, nothing else
        work = one_call_work(kern, name)
        print(f'[kernel] {name}: device work of one call (torch.profiler): '
              f'{work}', flush=True)
        check(len(work) == 1 and work[0][2] == 1
              and f'{name}_rows' in work[0][0],
              f'{name}: device work of one call {work}')
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for b in (B, FIT_IMAGES, 1):
        split = G.scatter_plan(b, V, V, sms)
        b_ms = results['scatter_add']['ms'] if b == B else graph_ms(
            small[b]['scatter_add'][0], iters=50)
        b_bound, _ = bound(3 * b * V, 4 * b * (3 * V + V + 3 * V))
        print(f'[kernel] scatter_add B={b} V={V} Q={V}: kernel {b_ms:.4f} '
              f'ms (CUDA-graph replay), bound {b_bound:.4f} ms, '
              f'{b_bound / b_ms:.1%} of bound; plan: {split} CTAs of 1024 '
              f'threads per batch item ({b * split} CTAs on {sms} SMs), '
              f'{G.scatter_shared_bytes(V, V, split)} bytes of shared memory '
              f'each; ptxas {ptxas_line("gather", "scatter_add_rows_kernel")}',
              flush=True)


def route_counters():
    from tuch_tpu_torch.ops import contact_kernels as CK
    from tuch_tpu_torch.ops import winding_hier as PH
    return {'winding_affine': CK.winding_numbers_affine_cuda,
            'winding_near': PH.near_field_cuda}


def _flips(got, want):
    return ((got <= 0.99) != (want <= 0.99)).sum().item()


def phase_routes(runtime, results, launches):
    """Phase 11: the affine and hierarchical winding routes."""
    from tuch_tpu_torch.ops import contact_kernels as CK
    from tuch_tpu_torch.ops import winding_hier as PH
    smpl, faces = runtime.smpl, runtime.contact.faces
    V = smpl.v_template.shape[0]
    clusters = PH.build_winding_clusters(smpl.v_template.cpu().numpy(),
                                         faces.cpu().numpy(), device=DEV)
    K, Qp = clusters.num_clusters, clusters.vert_perm.shape[0]
    M = min(ROUTE_NEAR, K)
    check((K, Qp) == (54, 7168), f'clusters K={K} Qp={Qp}')

    # the routes' entry points at B=64, against kernel 2
    B = TRAIN_B
    bodies = {'rest': smpl.v_template[None].expand(B, -1, -1).contiguous(),
              'posed': posed_verts(smpl, B, 0.3, 99)}
    counters = route_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0                   # the routes' run starts here
    outs = {name: (CK.winding_numbers_affine(v, v, faces),
                   PH.winding_numbers_hier(v, clusters, ROUTE_NEAR))
            for name, v in bodies.items()}
    counts = {k: c.launches for k, c in counters.items()}  # ... and ends
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    expected = {k: len(bodies) for k in counters}
    check(counts == expected, f'route launches {counts} != {expected}')
    launches.update(counts)
    for name, v in bodies.items():
        exact = CK.winding_numbers_tris_cuda(v, v[:, faces])
        aff, hier = outs[name]
        fa, fh = _flips(aff, exact), _flips(hier, exact)
        print(f'[routes] {name} B={B}: interior (kernel 2) '
              f'{(exact > 0.99).sum().item()} of {B * V}; in/out flips at '
              f'0.99 vs kernel 2: affine {fa}, hierarchical {fh} (M={M} of '
              f'K={K}); max |wn - kernel 2|: affine '
              f'{(aff - exact).abs().max().item():.4g}, hierarchical '
              f'{(hier - exact).abs().max().item():.4g}', flush=True)
        if name == 'rest':
            check(fa <= REST_FLIPS and fh <= REST_FLIPS,
                  f'rest flips: affine {fa}, hierarchical {fh}')
    print(f'[routes] peak device memory over both routes at B={B}: '
          f'{peak:.3f} GiB', flush=True)
    del outs

    # kernels 3 and 7 against their plain versions, and on the posed
    # training batch, where an FMA variant of kernel 2 failed its bar
    err = {'winding_affine': 0.0, 'winding_near': 0.0}
    for B in (1, 8):
        held = {'rest': smpl.v_template[None].expand(B, -1, -1)
                .contiguous(), 'posed': posed_verts(smpl, B, 0.3, B)}
        for name, v in held.items():
            _hold_route_kernels(f'{name} B={B}', v, faces, clusters, err)
    _hold_route_kernels(f'posed B={TRAIN_B}', bodies['posed'], faces,
                        clusters, err)
    print(f'[routes] ptxas: affine_kernel '
          f'{ptxas_line("winding_affine", "affine_kernel")}; near_kernel '
          f'{ptxas_line("winding_near", "near_kernel")}', flush=True)

    # times at the demo's batch and the training batch
    for B in (FIT_IMAGES, TRAIN_B):
        verts = bodies['posed'] if B == TRAIN_B else \
            posed_verts(smpl, B, 0.3, 99)
        _time_routes(B, verts, faces, clusters, results, err)
    del bodies
    torch.cuda.empty_cache()


def _hold_route_kernels(label, v, faces, clusters, err):
    """Kernels 3 and 7 against their plain versions on one batch of bodies
    (the plain versions in batches of PLAIN_CHUNK); the largest errors go
    into err."""
    from tuch_tpu_torch.ops import contact as PC
    from tuch_tpu_torch.ops import contact_kernels as CK
    from tuch_tpu_torch.ops import winding_hier as PH
    p4 = CK.affine_points(v)
    rows = CK.affine_constant_rows(v[:, faces])
    got = CK.winding_numbers_affine_cuda(p4, rows)
    want = torch.cat(_chunked(CK.winding_numbers_affine_ref, p4,
                              rows.transpose(1, 2).contiguous()))
    prob = PH.hier_problem(v, clusters, ROUTE_NEAR)
    near = PH.near_field_cuda(prob.sel, prob.pts, prob.tris)
    near_want = torch.cat(_chunked(PH.near_field_ref, prob.sel, prob.pts,
                                   prob.tris))
    torch.cuda.synchronize()
    ea = (got - want).abs().max().item()
    en = (near - near_want).abs().max().item() * PC.INV_4PI
    flips = _flips(got, want)
    print(f'[routes] kernels {label}: affine max_abs_err {ea:.3g} (tol '
          f'{AFFINE_ATOL}), in/out flips {flips}; near field max_abs_err '
          f'{en:.3g} in winding units (tol {NEAR_ATOL})', flush=True)
    check(got.shape == want.shape and ea <= AFFINE_ATOL and flips == 0,
          f'affine {label}: {ea}, {flips}')
    check(near.shape == near_want.shape and en <= NEAR_ATOL,
          f'near field {label}: {en}')
    err['winding_affine'] = max(err['winding_affine'], ea)
    err['winding_near'] = max(err['winding_near'], en)


def _time_routes(B, verts, faces, clusters, results, err):
    """Kernels 3, 7 and 2 and the whole hierarchical route on one posed
    batch: each one's time beside its plain version's and its bound, and a
    profile of the route; the training batch's go into results."""
    from tuch_tpu_torch.ops import contact as PC
    from tuch_tpu_torch.ops import contact_kernels as CK
    from tuch_tpu_torch.ops import winding_hier as PH
    V, F = verts.shape[1], faces.shape[0]
    K, C = clusters.num_clusters, clusters.cluster_size
    Qp = clusters.vert_perm.shape[0]
    tris = verts[:, faces]
    p4, rows = CK.affine_points(verts), CK.affine_constant_rows(tris)
    tc = rows.transpose(1, 2).contiguous()
    prob = PH.hier_problem(verts, clusters, ROUTE_NEAR)
    T, M = prob.sel.shape[1:]
    near_pairs = B * Qp * M * C

    def hier_plain(v):
        pr = PH.hier_problem(v, clusters, ROUTE_NEAR)
        return PH.combine(PH.near_field_ref(pr.sel, pr.pts, pr.tris),
                          pr.far, clusters)

    def route():
        return PH.winding_numbers_hier(verts, clusters, ROUTE_NEAR)

    plans = {
        'winding_affine': (
            lambda: CK.winding_numbers_affine_cuda(p4, rows),
            lambda: _chunked(CK.winding_numbers_affine_ref, p4, tc),
            bound(AFFINE_OPS_PER_PAIR * B * V * F,
                  4 * B * (4 * V + 28 * F + V))),
        'winding_near': (
            lambda: PH.near_field_cuda(prob.sel, prob.pts, prob.tris),
            lambda: _chunked(PH.near_field_ref, prob.sel, prob.pts,
                             prob.tris),
            bound(WINDING_OPS_PER_PAIR * near_pairs,
                  4 * B * (3 * Qp + 9 * K * C + Qp + T * M))),
        'hier route': (
            route, lambda: _chunked(hier_plain, verts),
            bound(WINDING_OPS_PER_PAIR * near_pairs
                  + FAR_OPS_PER_PAIR * B * Qp * K, 4 * B * (3 * V + V))),
        'winding (kernel 2)': (
            lambda: CK.winding_numbers_tris_cuda(verts, tris),
            lambda: _chunked(PC.winding_numbers, verts, tris),
            bound(WINDING_OPS_PER_PAIR * B * V * F,
                  4 * B * (3 * V + 9 * F + V))),
    }
    chunks = f'{-(-B // PLAIN_CHUNK)} x B={min(B, PLAIN_CHUNK)}'
    for name, (kern, plain, (bound_ms, bound_by)) in plans.items():
        ms = cuda_ms(kern, iters=5, warmup=1)
        plain_ms = cuda_ms(plain, iters=2, warmup=1)
        print(f'[routes] {name} B={B} V={V}: {ms:.4f} ms, plain '
              f'{plain_ms:.4f} ms ({chunks}), no one-call library '
              f'equivalent, bound {bound_ms:.4f} ms ({bound_by}), '
              f'{bound_ms / ms:.1%} of bound', flush=True)
        if name in err and B == TRAIN_B:
            results[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                                 bound_ms=bound_ms, bound_by=bound_by,
                                 max_abs_err=err[name])
    wall, busy, rows = device_breakdown(route, top=5)
    if busy <= 0:
        print(f'[profile route B={B}] the profiler recorded no device time',
              flush=True)
        return
    print(f'[profile route B={B}] one hierarchical route: host wall '
          f'{wall:.3f} ms, device busy {busy:.3f} ms, idle share '
          f'{1 - busy / wall:.1%} (torch.profiler)', flush=True)
    for name, ms, calls in rows:
        print(f'[profile route B={B}]   {ms:8.3f} ms {ms / busy:6.1%} '
              f'x{calls:<4d} {name}', flush=True)


def phase_fit(runtime, launches):
    """The demo on the card; returns its output."""
    from tuch_tpu_torch import config as cfgmod
    from tuch_tpu_torch.cli import demo_smplify_dc as demo
    args = cfgmod.parse_config(cfgmod.SMPLifyDemoConfig, [
        '--synthetic', '--num_images', str(FIT_IMAGES),
        '--num_smplify_iters', str(FIT_ITERS), '--device', DEV])
    counters = slice_counters()
    t0 = time.perf_counter()
    for c in counters.values():
        c.launches = 0                   # the main path starts here
    out = demo.run(args, runtime=runtime)
    counts = {k: c.launches for k, c in counters.items()}  # ... and ends
    wall = time.perf_counter() - t0
    res = out.result
    for name in ('vertices', 'joints', 'pose', 'betas', 'camera_translation',
                 'reprojection_loss', 'trajectory'):
        t = getattr(res, name)
        check(bool(torch.isfinite(t).all()), f'fit: non-finite {name}')
    V = runtime.smpl.v_template.shape[0]
    check(res.vertices.shape == (FIT_IMAGES, V, 3),
          f'fit: vertices {tuple(res.vertices.shape)}')
    final = res.reprojection_loss.sum(-1).cpu().numpy()
    init = out.init_reprojection_loss.sum(-1).cpu().numpy()
    # kernel 8 once an Adam step: FIT_ITERS camera steps, FIT_ITERS body
    expected = {'winding': 2 * FIT_ITERS, 'masked_min': FIT_ITERS,
                'gather': FIT_ITERS, 'scatter_add': FIT_ITERS,
                'adam': 2 * FIT_ITERS}
    print(f'[fit] demo_smplify_dc --synthetic, {FIT_IMAGES} images x '
          f'{FIT_ITERS} iterations behind the ResNet-50 init: reprojection '
          f'loss per image {np.round(init, 1).tolist()} -> '
          f'{np.round(final, 1).tolist()}; launches {counts}, expected '
          f'{expected}; HMR init + fit {out.seconds:.3f} s, whole run '
          f'{wall:.3f} s (host clock)', flush=True)
    check(bool((final < init).all()), 'fit: reprojection loss did not drop')
    check(counts == expected, f'fit launches {counts} != {expected}')
    launches.update(counts)
    return out


def phase_fit_parity(runtime):
    """The card against the port's CPU path at full width on B=2."""
    from tuch_tpu_torch.fitting import smplify_dc as PF
    from tuch_tpu_torch.losses import smplify as PL
    from tuch_tpu_torch.models.smpl import smpl_forward
    from tuch_tpu_torch.ops import contact_kernels as CK
    t0 = time.perf_counter()
    gpu = (runtime.smpl, runtime.prior, runtime.contact)
    cpu = (copy.deepcopy(runtime.smpl).cpu(), runtime.prior.to('cpu'),
           runtime.contact.to('cpu'))
    P = runtime.contact.region_idx_a.shape[0]
    ins = {'card': fit_inputs(PARITY_B, P, 11, DEV)}
    ins['cpu'] = [t.cpu() for t in ins['card']]
    pose = ins['card'][0] * 2.5          # fold the body: interior vertices
    with torch.no_grad():
        verts = smpl_forward(runtime.smpl, ins['card'][1], pose[:, 3:],
                             pose[:, :3]).vertices
    vc = verts.cpu()
    # the half without gradient, on the same vertices
    wn_c = CK.winding_numbers_faces(vc, vc, cpu[2].faces)
    band = (wn_c - 0.99).abs() < WN_BAND
    ext_g, arg_g = PL.contact_neighbors(verts, gpu[2])
    ext_c, arg_c = PL.contact_neighbors(vc, cpu[2])
    flips = ((ext_g.cpu() != ext_c) & ~band).sum().item()
    d2_g, _ = CK.masked_min_dist(verts, gpu[2].geomask, gpu[2].geomask_bits)
    d2_c, _ = CK.masked_min_dist(vc, cpu[2].geomask)
    fin = torch.isfinite(d2_c)
    d2_ok = ((d2_g.cpu() - d2_c).abs()[fin] <= D2_RTOL * d2_c[fin]).all()
    differ = (arg_g.cpu() != arg_c) & fin
    print(f'[parity fit] B={PARITY_B} same vertices: interior (CPU) '
          f'{(~ext_c).sum().item()}, in/out flips outside the band {flips} '
          f'(in the band {band.sum().item()}); argmin differs at '
          f'{differ.sum().item()}, d2 within rtol {D2_RTOL} '
          f'{bool(d2_ok)}', flush=True)
    check(flips == 0 and bool(d2_ok), f'parity neighbours: flips {flips}')
    check(bool((((d2_g.cpu() - d2_c).abs() <= D2_RTOL * d2_c)
                 | ~differ).all()), 'parity: argmin differs beyond a tie')

    # the stage-2 loss and its gradient at the init pose, on the CPU's
    # neighbours (the half with gradient, from the parameters)
    def loss_and_grad(which):
        return body_stepper(gpu if which == 'card' else cpu, ins[which],
                            init_scale=2.5, neighbors=(ext_c, arg_c))()

    lg, gg = loss_and_grad('card')
    lc, gc = loss_and_grad('cpu')
    rel = abs(lg - lc) / abs(lc)
    # gradient: |card - CPU| <= 1e-4 |CPU| + 1e-6 max|CPU| per element, the
    # rule the CPU tests hold the port to against jax.grad; gerr is the
    # largest ratio of the two sides (<= 1 passes)
    gerr = max(((gg[k] - gc[k]).abs()
                / (1e-4 * gc[k].abs() + 1e-6 * gc[k].abs().max()))
               .max().item() for k in gg)
    print(f'[parity fit] stage-2 loss {lg:.6g} (card) vs {lc:.6g} (CPU), '
          f'rel {rel:.3g} (rtol 1e-4); gradient worst ratio to its bar '
          f'{gerr:.3g} (rtol 1e-4, atol 1e-6 of the largest)', flush=True)
    check(rel <= 1e-4 and gerr <= 1.0, f'parity loss {rel}, grad {gerr}')

    cfg = PF.SMPLifyConfig(num_iters=PARITY_ITERS, euclthres=0.02,
                           contact_loss_weight=2000.0)
    res = {w: PF.smplify_dc(*(gpu if w == 'card' else cpu), *ins[w],
                            config=cfg) for w in ('card', 'cpu')}
    verr = (res['card'].vertices.cpu() - res['cpu'].vertices).abs().max()
    print(f'[parity fit] vertices after {PARITY_ITERS} iterations of each '
          f'stage, card vs CPU: max abs diff {verr.item():.3g} (tol 1e-3); '
          f'{time.perf_counter() - t0:.1f} s', flush=True)
    check(verr.item() <= 1e-3, f'parity vertices {verr.item()}')


def body_stepper(assets, ins, init_scale=1.0, neighbors=None, mesh=None):
    """One body iteration of the fit at the reference's refresh every step:
    the neighbour refresh (or the given neighbours), the stage-2 loss's
    value and gradient, one Adam step. assets: (smpl, prior, contact);
    mesh: the contact's cp split (phase 19). Each call returns (loss,
    gradients on the CPU)."""
    from tuch_tpu_torch.fitting import smplify_dc as PF
    from tuch_tpu_torch.ops.adam import Adam, contiguous_clones
    init_pose, betas, cam_t, cc, kp, gt, ign, hdc, _ = ins
    stage = PF.contact_stage(*assets, betas, cam_t, cc, kp[..., :2],
                             kp[..., 2], gt, ign, hdc, PF.SMPLifyConfig(
                                 euclthres=0.02, contact_loss_weight=2000.0,
                                 mesh=mesh))
    pose = init_pose * init_scale
    state = contiguous_clones({'body_pose': pose[:, 3:],
                               'global_orient': pose[:, :3]})
    opt = Adam(state, 1e-2)
    dev = init_pose.device

    def step():
        nb = stage.neighbors(state) if neighbors is None else \
            tuple(t.to(dev) for t in neighbors)
        loss, grads = PF.value_and_grad(lambda q: stage.loss(q, nb), state)
        opt.step(state, grads)
        return float(loss), {k: g.cpu() for k, g in grads.items()}
    return step


def phase_fit_times(runtime, card, demo_out):
    P = runtime.contact.region_idx_a.shape[0]
    print(f'[times fit] demo (B={FIT_IMAGES}, {FIT_ITERS} iterations): HMR '
          f'init + fit {demo_out.seconds:.3f} s (host clock); card: {card}',
          flush=True)
    assets = (runtime.smpl, runtime.prior, runtime.contact)
    for B in (FIT_IMAGES, TRAIN_B):
        step = body_stepper(assets, fit_inputs(B, P, 21, DEV))
        for _ in range(2):
            step()
        n = 10
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        per_iter = 1e3 * (time.perf_counter() - t0) / n
        print(f'[times fit] B={B}: {per_iter:.3f} ms per body iteration '
              f'(neighbour refresh, loss and gradient, Adam step; host '
              f'clock, mean of {n})', flush=True)
        wall, busy, rows = device_breakdown(
            lambda: [step() for _ in range(3)], top=8)
        if busy <= 0:
            print(f'[profile fit B={B}] the profiler recorded no device time',
                  flush=True)
            continue
        print(f'[profile fit B={B}] 3 body iterations: host wall {wall:.3f} '
              f'ms, device busy {busy:.3f} ms, idle share '
              f'{1 - busy / wall:.1%} (torch.profiler)', flush=True)
        for name, ms, calls in rows:
            print(f'[profile fit B={B}]   {ms:8.3f} ms {ms / busy:6.1%} '
                  f'x{calls:<4d} {name}', flush=True)


# ---------------------------------------------------------------------------
# The training step (phase 12)
# ---------------------------------------------------------------------------

def fold_pose6d(seed=2, scale=1.5):
    """A mean pose for the IEF head that folds the body through itself, so
    the predicted bodies have interior vertices and contact and the HD
    contact loss is live: the 144 6d numbers of a random pose."""
    from tuch_tpu_torch.utils.rotations import batch_rodrigues
    aa = np.random.RandomState(seed).randn(24, 3).astype(np.float32) * scale
    rot = batch_rodrigues(torch.from_numpy(aa))
    return rot[:, :, :2].reshape(1, -1)


def train_hmr(backbone, dev):
    """HMR with seeded random weights starting its IEF loop from the
    folding pose, on `dev`."""
    from tuch_tpu_torch import runtime as rt
    hmr = rt.build_runtime(device=dev, synthetic=True, backbone=backbone).hmr
    with torch.no_grad():
        hmr.init_pose.copy_(fold_pose6d())
    return hmr


def train_batch(B, num_classes, n_fits, seed, img_res=224):
    """A training batch from numpy, as the loader gives it: images,
    keypoints in [-1, 1] with confidences, ground truth, distinct fits
    rows, and a mix of has_smpl, has_disc_contact, has_gt_kpts and flips."""
    rng = np.random.RandomState(seed)

    def flags(p):
        return (rng.rand(B) < p).astype(np.float32)

    return {
        'img': rng.randn(B, img_res, img_res, 3).astype(np.float32),
        'keypoints': np.concatenate(
            [rng.uniform(-0.8, 0.8, (B, 49, 2)),
             rng.uniform(0.0, 1.0, (B, 49, 1))], -1).astype(np.float32),
        'pose': (rng.randn(B, 72) * 0.2).astype(np.float32),
        'betas': (rng.randn(B, 10) * 0.5).astype(np.float32),
        'contact_vec': (rng.rand(B, num_classes) > 0.7).astype(np.float32),
        'pose_3d': np.concatenate(
            [rng.randn(B, 24, 3) * 0.3, rng.uniform(0, 1, (B, 24, 1))],
            -1).astype(np.float32),
        'has_smpl': flags(0.25), 'has_pgt_smpl': flags(0.1),
        'has_disc_contact': flags(0.5), 'has_gt_kpts': flags(0.7),
        'has_pose_3d': flags(0.3), 'is_flipped': flags(0.5),
        'rot_angle': (rng.uniform(-30, 30, B) * (rng.rand(B) > 0.6)
                      ).astype(np.float32),
        'fits_index': rng.permutation(n_fits)[:B].astype(np.int32),
    }


def train_counters():
    from tuch_tpu_torch.ops import attention as A
    return {'mha': A.mha_cuda, **slice_counters()}


def train_launches(backbone, iters):
    """The step's launches of each kernel with the HD contact loss: kernel
    2 twice per fit iteration (all vertices, the segments) and three times
    in the loss (adding the HD points), kernels 4 and 5 once per iteration
    and once in the loss, kernel 6 once per iteration only (with HD the
    loss's gradient reaches the vertices through the HD points, not
    through the re-gather), kernel 1 once per ViT-S/16 block (its backward
    recomputes the plain version), kernel 8 once per SMPLify-DC step (the
    camera's and the body's, iters each) and the chunk plan's launches
    over HMR's parameters."""
    from tuch_tpu_torch.ops import adam as OA
    return {'mha': VIT_S16_DEPTH if backbone == 'vit_s16' else 0,
            'winding': 2 * iters + 3, 'masked_min': iters + 1,
            'gather': iters + 1, 'scatter_add': iters,
            'adam': 2 * iters + len(OA.chunk_plan(
                [int(np.prod(s)) for s in hmr_param_shapes(backbone)]))}


def _step_tensors(state):
    """A finished step's parameters, gradients (Adam's first moment: 0.1 x
    the gradient after one step), BatchNorm statistics and fits, on the
    CPU in float64."""
    def f64(t):
        return t.detach().cpu().double()
    return dict(
        params={k: f64(p) for k, p in state.hmr.named_parameters()},
        mu={k: f64(v) for k, v in state.opt.mu.items()},
        buffers={k: f64(b) for k, b in state.hmr.named_buffers()
                 if k.endswith(('running_mean', 'running_var'))},
        fits=f64(state.fits))


def _to_double(tup):
    return type(tup)(*(t.double() if torch.is_tensor(t)
                       and t.is_floating_point() else t for t in tup))


def _train_step_on(where, backbone, runtime, hmr0, batch, fits, masks,
                   dtype=torch.float32):
    """One step of the port on `where` ('card' or 'cpu') from the given
    weights, fits and dropout masks: (tensors, metrics, outputs)."""
    from tuch_tpu_torch import config as cfgmod
    from tuch_tpu_torch.train import module as M
    dev = DEV if where == 'card' else 'cpu'
    hmr = copy.deepcopy(hmr0).to(dev)
    smpl = copy.deepcopy(runtime.smpl).to(dev)
    prior, contact = runtime.prior.to(dev), runtime.contact.to(dev)
    hd = runtime.hd.to(dev)
    if dtype == torch.float64:
        hmr, smpl = hmr.double(), smpl.double()
        hmr.dtype = dtype
        prior, hd = _to_double(prior), _to_double(hd)
        contact = contact._replace(
            segment_tables=_to_double(contact.segment_tables))
    opts = cfgmod.TrainConfig(
        backbone=backbone, batch_size=PARITY_B, run_smplify=True,
        num_smplify_iters=TRAIN_PARITY_ITERS, smplify_threshold=1e9)
    state = M.init_train_state(hmr, torch.tensor(fits, dtype=dtype,
                                                 device=dev), opts.lr)
    b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    b = {k: v.to(dtype) if v.is_floating_point() else v
         for k, v in b.items()}
    step = M.make_train_step(M.TuchAssets(smpl, prior, contact, hd), opts)
    state, metrics, outputs = step(state, b, dropout=[
        tuple(m.to(dev) for m in pair) for pair in masks])
    return (_step_tensors(state), {k: float(v) for k, v in metrics.items()},
            {k: v.detach().cpu() for k, v in outputs.items()})


def _no_noisier(card, cpu, exact, part, base=None):
    """Over all tensors of `part` at once (minus `base`): ||card - exact||
    <= 2 ||cpu - exact|| + rtol ||cpu||; returns the ratio of the two
    sides (<= 1 passes)."""
    keys = sorted(cpu[part])

    def flat(d):
        return torch.cat([(d[part][k] - (0 if base is None else base[k]))
                          .ravel() for k in keys])
    c, g, e = flat(cpu), flat(card), flat(exact)
    lhs = (g - e).norm().item()
    rhs = 2 * (c - e).norm().item() + TRAIN_GRAD_RTOL * c.norm().item()
    print(f'[parity train]   {part}: |card - float64| {lhs:.4g}, |CPU - '
          f'float64| {(c - e).norm().item():.4g}, |CPU| '
          f'{c.norm().item():.4g}', flush=True)
    return lhs / rhs


def phase_train_parity(runtime, backbone):
    """One step on the card against the port's CPU path, full body at
    224 px, B=2, same weights, fits, batch and dropout masks (drawn once
    on the CPU). ResNet-50's batch-statistics BatchNorm at random init
    amplifies float32 rounding (see tests/test_torch_port_train_step.py),
    so for it the gradients, BatchNorm statistics and parameter updates
    are held against the CPU step in float64 as tests/ hold the port to
    the JAX package: no further from it than twice the CPU's float32 is,
    plus the bar."""
    from tuch_tpu_torch.models.hmr import draw_dropout_masks
    t0 = time.perf_counter()
    P = runtime.contact.region_idx_a.shape[0]
    hmr0 = train_hmr(backbone, 'cpu')
    batch = train_batch(PARITY_B, P, 8, 31)
    fits = (np.random.RandomState(32).randn(8, 82) * 0.1).astype(np.float32)
    masks = draw_dropout_masks(PARITY_B, torch.Generator().manual_seed(33))
    counters = train_counters()
    before = {k: c.launches for k, c in counters.items()}
    card, m_card, o_card = _train_step_on('card', backbone, runtime, hmr0,
                                          batch, fits, masks)
    counts = {k: c.launches - before[k] for k, c in counters.items()}
    cpu, m_cpu, o_cpu = _train_step_on('cpu', backbone, runtime, hmr0,
                                       batch, fits, masks)
    exact = None
    if backbone == 'resnet50':
        exact, _, _ = _train_step_on('cpu', backbone, runtime, hmr0, batch,
                                     fits, masks, dtype=torch.float64)
    check(counts == train_launches(backbone, TRAIN_PARITY_ITERS),
          f'parity {backbone} launches {counts}')
    check(set(m_card) == set(m_cpu), 'parity: metric names differ')
    worst_loss = max(abs(m_card[k] - v) / (TRAIN_LOSS_RTOL * abs(v)
                                          + TRAIN_LOSS_ATOL * max(1.0, abs(v)))
                     for k, v in m_cpu.items())
    acc_c, acc_g = o_cpu['fit_accepted'], o_card['fit_accepted']
    # fits rows by the vertices they pose: a pose component that moves no
    # vertex gets Adam steps of ~lr from gradients at rounding level, so
    # its axis-angle differs between devices while the body does not
    from tuch_tpu_torch.models.smpl import smpl_forward_pose72
    smpl = copy.deepcopy(runtime.smpl).cpu().double()
    rows = torch.as_tensor(batch['fits_index']).long()
    with torch.no_grad():
        fit_v = {w: smpl_forward_pose72(smpl, t['fits'][rows, 72:],
                                        t['fits'][rows, :72]).vertices
                 for w, t in (('card', card), ('cpu', cpu))}
    errs = {'fits rows': (card['fits'] - cpu['fits']).abs().max().item(),
            'fits rows\' vertices':
                (fit_v['card'] - fit_v['cpu']).abs().max().item(),
            'opt_vertices': (o_card['opt_vertices'] - o_cpu['opt_vertices'])
                .abs().max().item()}
    print(f'[parity train {backbone}] B={PARITY_B}, {TRAIN_PARITY_ITERS} '
          f'fit iterations, contact and HD on: loss {m_card["loss"]:.6g} '
          f'(card) vs {m_cpu["loss"]:.6g} (CPU), loss_contact '
          f'{m_card["loss_contact"]:.6g} vs {m_cpu["loss_contact"]:.6g}; '
          f'worst loss entry {worst_loss:.3g} of its bar (rtol '
          f'{TRAIN_LOSS_RTOL}, atol {TRAIN_LOSS_ATOL}); accept '
          f'{acc_g.tolist()} vs {acc_c.tolist()}; max abs card - CPU: '
          + ', '.join(f'{k} {v:.3g}' for k, v in errs.items())
          + f' (vertex tol {VERTEX_TOL}); launches {counts}', flush=True)
    check(worst_loss <= 1.0, f'parity {backbone}: losses {worst_loss}')
    check(bool(torch.equal(acc_g, acc_c)), 'parity: accept masks differ')
    check(errs['fits rows\' vertices'] <= VERTEX_TOL
          and errs['opt_vertices'] <= VERTEX_TOL,
          f'parity {backbone}: {errs}')
    check(m_cpu['loss_contact'] > 0, 'parity: the contact loss is 0')
    if exact is None:
        # no BatchNorm: each gradient element by element, the CPU tests' bar
        gerr = max(((card['mu'][k] - g).abs()
                    / (TRAIN_GRAD_RTOL * g.abs()
                       + TRAIN_GRAD_ATOL * g.abs().max() + 1e-30))
                   .max().item() for k, g in cpu['mu'].items())
        print(f'[parity train {backbone}] gradients: worst ratio to the bar '
              f'{gerr:.3g} (rtol {TRAIN_GRAD_RTOL}, atol {TRAIN_GRAD_ATOL} '
              f'of each tensor\'s largest)', flush=True)
        check(gerr <= 1.0, f'parity {backbone}: gradients {gerr}')
    else:
        base = {k: p.detach().double() for k, p in hmr0.named_parameters()}
        ratios = {part: _no_noisier(card, cpu, exact, part, b)
                  for part, b in (('mu', None), ('buffers', None),
                                  ('params', base))}
        print(f'[parity train {backbone}] gradients, BatchNorm statistics, '
              f'parameter updates: ratio of |card - float64| to twice '
              f'|CPU - float64| + {TRAIN_GRAD_RTOL} |CPU| '
              f'{ {k: round(v, 3) for k, v in ratios.items()} } (<= 1)',
              flush=True)
        check(max(ratios.values()) <= 1.0, f'parity {backbone}: {ratios}')
    print(f'[parity train {backbone}] {time.perf_counter() - t0:.1f} s',
          flush=True)


def _hold_hd_winding(runtime, opts, verts, results):
    """Kernel 2 at the HD contact loss's shape, (B, hd_k) offset points
    against the body's faces, on the given predicted bodies: the points
    built as losses/regressor.contact_loss builds them, its wrapper
    against the plain version (in batches of PLAIN_CHUNK), at kernel 2's
    bar. The error joins the kernel's row."""
    from tuch_tpu_torch import config as cfgmod
    from tuch_tpu_torch.losses import regressor as RL
    from tuch_tpu_torch.losses.smplify import self_contact_terms
    from tuch_tpu_torch.ops import contact as PC
    from tuch_tpu_torch.ops import contact_kernels as CK
    contact, hd = runtime.contact, runtime.hd
    with torch.no_grad():
        ext, v2v, inc = self_contact_terms(
            verts, contact, cfgmod.euclthres,
            candidate_k=opts.contact_candidate_k)
        top_idx, sel, _ = RL.hd_candidates(hd, ext, v2v, inc, opts.hd_k)
        pts = RL.hd_offset_points(RL.hd_points(verts, hd, top_idx), verts,
                                  contact.faces, hd, top_idx)
        got = CK.winding_numbers_faces(pts, verts, contact.faces)
        want = torch.cat(_chunked(lambda p, v: PC.winding_numbers_same_tris(
            p, v, contact.faces), pts, verts))
    err = _winding_err(f'HD offset points ({sel.sum().item()} active)', pts,
                       contact.faces.shape[0], got, want)
    results['winding']['max_abs_err'] = max(
        results['winding']['max_abs_err'], err)


def step_split(prof):
    """The step's parts from one profile: per record_function span
    'train_step.<part>', its host ms and the device ms of its kernels,
    and the device ms placed by stream order. A kernel belongs to the
    span in which its runtime launch call started (the backward's
    launches come from autograd's own thread, inside the calling
    thread's span in time); a kernel with no launch call in the profile
    goes to the part of the kernel before it on the stream."""
    from torch.autograd import DeviceType
    events = prof.events()
    spans = sorted((e.time_range.start, e.time_range.end,
                    e.name[len('train_step.'):]) for e in events
                   if e.name.startswith('train_step.')
                   and e.device_type == DeviceType.CPU)
    host = {name: 0.0 for _, _, name in spans}
    dev = dict(host, other=0.0)
    for t0, t1, name in spans:
        host[name] += (t1 - t0) / 1e3

    def part_at(t):
        return next((n for t0, t1, n in spans if t0 <= t < t1), 'other')
    # runtime calls (cudaLaunchKernel, cuLaunchKernel, cudaMemcpyAsync, ...)
    # share their correlation id with the device work they start
    launches = {e.id: part_at(e.time_range.start) for e in events
                if e.device_type == DeviceType.CPU
                and e.name.startswith('cu')}
    part, by_order = 'other', 0.0
    for e in sorted((e for e in events if e.device_type == DeviceType.CUDA
                     and not e.name.startswith('train_step.')),
                    key=lambda e: e.time_range.start):
        ms = (e.time_range.end - e.time_range.start) / 1e3
        if e.id in launches:
            part = launches[e.id]
        else:
            by_order += ms
        dev[part] += ms
    return host, dev, by_order


def phase_train_times(runtime, backbone, card, results):
    """The step at full width on the card, B=64: 2 warm-up steps, one
    counted step (kernel 2 then held at the HD points' shape on its
    bodies), TRAIN_TIMED timed steps (median, host clock, synchronised)
    and one step under torch.profiler for the device time and the split
    into parts; peak memory."""
    from torch.profiler import ProfilerActivity, profile

    from tuch_tpu_torch import config as cfgmod
    from tuch_tpu_torch.train import module as M
    P = runtime.contact.region_idx_a.shape[0]
    opts = cfgmod.TrainConfig(backbone=backbone, run_smplify=True)
    batch = {k: torch.as_tensor(v, device=DEV) for k, v in train_batch(
        opts.batch_size, P, TRAIN_FITS, 41).items()}
    fits = torch.as_tensor((np.random.RandomState(42).randn(TRAIN_FITS, 82)
                            * 0.1).astype(np.float32), device=DEV)
    state = M.init_train_state(train_hmr(backbone, DEV), fits, opts.lr,
                               seed=43)
    step = M.make_train_step(M.TuchAssets(runtime.smpl, runtime.prior,
                                          runtime.contact, runtime.hd), opts)
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        state, metrics, _ = step(state, batch)
    counters = train_counters()
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0                   # the main path starts here
    old = state.fits.clone()
    state, metrics, outputs = step(state, batch)
    torch.cuda.synchronize()
    counts = {k: c.launches for k, c in counters.items()}  # ... and ends
    expected = train_launches(backbone, opts.num_smplify_iters)
    rows = batch['fits_index'].long()
    acc = outputs['fit_accepted']
    changed = (state.fits[rows] != old[rows]).any(dim=1)
    check(all(bool(torch.isfinite(v).all()) for v in metrics.values()),
          f'train {backbone}: non-finite metrics')
    check(bool((changed | ~acc).all()), 'train: an accepted row unchanged')
    check(counts == expected, f'train {backbone} launches {counts} != '
          f'{expected}')
    _hold_hd_winding(runtime, opts, outputs['pred_vertices'], results)
    del outputs
    lat = []
    for _ in range(TRAIN_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics, _ = step(state, batch)
        torch.cuda.synchronize()
        lat.append(1e3 * (time.perf_counter() - t0))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f'[times train {backbone}] B={opts.batch_size} at 224 px, '
          f'{opts.num_smplify_iters} fit iterations with contact, HD '
          f'contact loss (hd_k {opts.hd_k}), fits store of {TRAIN_FITS}: '
          f'{np.median(lat):.3f} ms per step (median of {TRAIN_TIMED}, host '
          f'clock, synchronised; all {[round(x, 3) for x in lat]}); loss '
          f'{float(metrics["loss"]):.6g}, loss_contact '
          f'{float(metrics["loss_contact"]):.6g}, accept rate '
          f'{float(metrics["smplify_accept_rate"]):.3f}; launches {counts} '
          f'(expected {expected}); peak memory {peak:.3f} GiB '
          f'(max_memory_allocated); TF32 cuDNN '
          f'{torch.backends.cudnn.allow_tf32}; card: {card}', flush=True)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _, _ = step(state, batch)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    busy, top = kernel_rows(prof, top=10)
    if busy <= 0:
        print(f'[profile train {backbone}] the profiler recorded no device '
              'time', flush=True)
        return np.median(lat)
    host, dev, by_order = step_split(prof)
    hmr_ms = dev.get('hmr_forward', 0.0) + dev.get('backward', 0.0)
    print(f'[profile train {backbone}] one step: host wall {wall:.3f} ms, '
          f'device busy {busy:.3f} ms, idle share {1 - busy / wall:.1%} '
          f'(torch.profiler; against the unprofiled median step '
          f'{1 - busy / np.median(lat):.1%}); card: {card}', flush=True)
    print(f'[profile train {backbone}] split (host ms of each part / device '
          f'ms of the kernels it launched, {sum(dev.values()):.3f} of the '
          f'busy {busy:.3f} ms attributed, {by_order:.3f} of it by stream '
          f'order): '
          + ', '.join(f'{n} {host.get(n, 0.0):.3f} / {dev[n]:.3f}'
                      for n in dev)
          + f'; HMR forward+backward {hmr_ms:.3f} ms, SMPLify-DC '
          f'{dev.get("smplify", 0.0):.3f} ms, regressor loss '
          f'{dev.get("loss", 0.0):.3f} ms of device time (the loss\'s own '
          f'backward is in the backward); card: {card}', flush=True)
    for name, ms, calls in top:
        print(f'[profile train {backbone}]   {ms:8.3f} ms {ms / busy:6.1%} '
              f'x{calls:<4d} {name}', flush=True)
    return np.median(lat)

# ---------------------------------------------------------------------------
# ResNet-50's serving options (phase 6b): --bn_fold and stem_s2d
# ---------------------------------------------------------------------------

def _randomize_bn(hmr, seed):
    """Non-trivial BatchNorm affines and statistics from a seed, in place
    (a fresh model's fold to almost nothing)."""
    from tuch_tpu_torch.models.hmr import BatchNorm2d
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in hmr.modules():
            if isinstance(mod, BatchNorm2d):
                n = mod.weight.shape
                for t, v in ((mod.weight, torch.randn(n, generator=g) * 0.3
                              + 1.0),
                             (mod.bias, torch.randn(n, generator=g) * 0.3),
                             (mod.running_mean,
                              torch.randn(n, generator=g) * 0.3),
                             (mod.running_var,
                              torch.rand(n, generator=g) * 1.8 + 0.2)):
                    t.copy_(v)
    return hmr


def kernel_count(prof):
    """Device kernels in a profile (record_function ranges left out)."""
    from torch.autograd import DeviceType
    return sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not e.key.startswith('train_step.'))


def phase_hmr_options(card):
    """ResNet-50 with --bn_fold and with stem_s2d against the stock model,
    on weights whose BatchNorm affines and statistics are random: vertices
    at B=8 with TF32 off (HMR_OPTION_ATOL; stem_s2d builds the plain stem:
    the stock model under another flag), then with the TF32 defaults
    --bn_fold's B=64 forward device time (CUDA events) and device kernels
    (torch.profiler) beside the stock model's, in fp32 and bf16 (the
    serving predictor's weights, cast once); then one /predict through
    cli/serve --bn_fold."""
    from tuch_tpu_torch import runtime as rt
    from tuch_tpu_torch.models import hmr as H
    from tuch_tpu_torch.models.smpl import smpl_forward
    base = rt.build_runtime(device=DEV, synthetic=True)
    stock_sd = _randomize_bn(base.hmr, 3).state_dict()
    means = [b.cpu() for b in (base.hmr.init_pose, base.hmr.init_shape,
                               base.hmr.init_cam)]

    def variant(fold, s2d, dtype):
        hmr = H.create_hmr(*means, dtype=dtype, stem_s2d=s2d).to(DEV)
        hmr.load_state_dict(stock_sd)
        hmr = H.folded(hmr) if fold else hmr.eval()
        return H.store_compute_weights(hmr)

    names = {(False, False): 'stock', (True, False): 'bn_fold',
             (False, True): 'stem_s2d'}
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    x8 = torch.as_tensor(np.random.RandomState(5).randn(8, 224, 224, 3)
                         .astype(np.float32), device=DEV)

    def verts(hmr):
        with torch.inference_mode():
            rotmat, betas, _ = hmr(x8)
            return smpl_forward(base.smpl, betas, rotmat[:, 1:],
                                rotmat[:, :1], pose2rot=False).vertices
    try:
        want = verts(variant(False, False, torch.float32))
        for key, name in names.items():
            if key == (False, False):
                continue
            err = float((verts(variant(*key, torch.float32)) - want)
                        .abs().max())
            print(f'[hmr options] {name} vs stock, fp32, TF32 off, B=8 at '
                  f'224 px: vertices max abs diff {err:.3g} m (bar '
                  f'{HMR_OPTION_ATOL})', flush=True)
            check(err <= HMR_OPTION_ATOL, f'{name}: vertices off by {err}')
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = tf32
    x = torch.randn(64, 224, 224, 3, device=DEV)
    for dtype in (torch.float32, torch.bfloat16):
        for key in ((False, False), (True, False)):
            name, hmr = names[key], variant(*key, dtype)

            def fwd():
                with torch.inference_mode():
                    hmr(x)
            ms = cuda_ms(fwd, iters=10, warmup=3)
            wall, prof = profiled(fwd)
            busy, _ = kernel_rows(prof, top=1)
            print(f'[times hmr options] ResNet-50 {name} '
                  f'{str(dtype)[6:]} B=64 at 224 px: {ms:.3f} ms per '
                  f'forward (CUDA events, mean of 10), {64e3 / ms:.1f} '
                  f'images/s; one profiled forward: device busy '
                  f'{busy:.3f} ms in {kernel_count(prof)} device kernels, '
                  f'host wall {wall:.3f} ms; TF32 cuDNN '
                  f'{torch.backends.cudnn.allow_tf32}; card: {card}',
                  flush=True)
            del hmr
    from tuch_tpu_torch.cli.serve import build_server
    httpd = build_server(SimpleNamespace(
        checkpoint=None, synthetic=True, img_res=224,
        synthetic_num_verts=None, max_batch=1, batch_wait_ms=2.0,
        backbone='resnet50', device=DEV, dtype='float32', host='127.0.0.1',
        port=0, bn_fold=True))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        check(httpd.predictor.hmr.bn_fold, 'serve --bn_fold: not folded')
        code, body = _http(
            f'http://127.0.0.1:{httpd.server_address[1]}/predict',
            {'image_b64': _png_b64(11), 'return_vertices': True})
        _check_prediction(code, body, httpd.predictor.num_verts,
                          'serve --bn_fold')
        print('[serve resnet50 --bn_fold] one /predict answered 200 with '
              f'{len(body["vertices"])} finite vertices', flush=True)
    finally:
        httpd.shutdown()
        httpd.predictor.close()
        httpd.server_close()
        thread.join(timeout=30)
    check(not thread.is_alive(), 'server thread did not stop')


# ---------------------------------------------------------------------------
# The trainer and eval entry points (phases 13 and 14)
# ---------------------------------------------------------------------------

def train_argv(name, *flags):
    """cli/train's flags for a run of phase 13: the synthetic mix at full
    width, B=64, one epoch of 256 samples (4 steps), validation and a
    checkpoint every half epoch, 8 loader workers."""
    return ['--synthetic', '--run_smplify', '--batch_size', str(TRAIN_B),
            '--num_epochs', '1', '--val_and_checkpoint_freq', '0.5',
            '--num_workers', '8', '--log_dir', TRAIN_LOG_DIR, '--name', name,
            *flags]


def instrument(tr, counters, stop_after=None):
    """Record one Trainer's loop through its instance attributes (the
    trainer's code is unchanged): the host time waiting on the loader and
    the arrival of each batch; per step the host ms in step_fn, CUDA
    events around it, whether the card was already idle when it returned
    (the step synchronised inside), and each kernel's launches;
    validation and checkpoint ms and bytes, with the step they followed.
    stop_after: after that many steps, the time-budget exit."""
    rec = dict(wait=[], arrive=[], step_ms=[], events=[], idle_at_return=[],
               launches=[], val=[], ckpt=[])
    epoch_iter = tr.loader.epoch_iter

    def timed_iter(state):
        it = epoch_iter(state)
        try:
            while True:
                t0 = time.perf_counter()
                try:
                    batch = next(it)
                except StopIteration:
                    rec['arrive'].append(time.perf_counter())
                    return
                t1 = time.perf_counter()
                rec['wait'].append(1e3 * (t1 - t0))
                rec['arrive'].append(t1)
                yield batch
        finally:
            it.close()

    step_fn, validate, save = tr.step_fn, tr.validate, tr._save_checkpoint

    def step(state, batch):
        before = {k: c.launches for k, c in counters.items()}
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        t0 = time.perf_counter()
        out = step_fn(state, batch)
        rec['step_ms'].append(1e3 * (time.perf_counter() - t0))
        e1.record()
        rec['idle_at_return'].append(e1.query())
        rec['events'].append((e0, e1))
        rec['launches'].append({k: c.launches - before[k]
                                for k, c in counters.items()})
        if stop_after is not None and len(rec['step_ms']) == stop_after:
            tr.endtime = 0.0
        return out

    def timed_validate(n):
        t0 = time.perf_counter()
        out = validate(n)
        rec['val'].append((len(rec['step_ms']),
                           1e3 * (time.perf_counter() - t0)))
        return out

    def timed_save(*args):
        t0 = time.perf_counter()
        save(*args)
        if not tr.is_main:         # a mesh's rank 0 alone writes
            return
        ms = 1e3 * (time.perf_counter() - t0)
        path = tr.ckpt.latest()
        nbytes = os.path.getsize(path) + sum(
            os.path.getsize(os.path.join(tr.options.checkpoint_dir, f))
            for f in os.listdir(tr.options.checkpoint_dir)
            if f.endswith('_fits.npy'))
        rec['ckpt'].append((len(rec['step_ms']), ms, nbytes, path))

    tr.loader.epoch_iter = timed_iter
    tr.step_fn, tr.validate, tr._save_checkpoint = step, timed_validate, \
        timed_save
    return rec


def iteration_ms(rec):
    """Per step, the loop's ms from its batch's arrival to the next one's
    (or the end of the epoch), less the validation and checkpoint it ran:
    step_fn, the previous step's metrics and the wait on the loader."""
    out = []
    for k in range(1, len(rec['arrive'])):
        extra = sum(ms for s, ms in rec['val'] if s == k) + sum(
            c[1] for c in rec['ckpt'] if c[0] == k)
        out.append(1e3 * (rec['arrive'][k] - rec['arrive'][k - 1]) - extra)
    return out


def train_run(name, backbone, runtime, hmr, counters, *flags,
              stop_after=None):
    """One cli/train run (build with the given runtime and a fresh HMR,
    then fit), instrumented; returns (trainer, record, launches of the
    whole run)."""
    from tuch_tpu_torch import config as cfgmod
    from tuch_tpu_torch.cli import train as train_cli
    opts = cfgmod.parse_config(cfgmod.TrainConfig, train_argv(
        name, '--backbone', backbone, *flags))
    tr = train_cli.build(opts, runtime._replace(hmr=hmr))
    rec = instrument(tr, counters, stop_after)
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0                   # this run's main path starts here
    t0 = time.perf_counter()
    tr.fit()
    torch.cuda.synchronize()
    total = {k: c.launches for k, c in counters.items()}  # ... and ends
    rec['fit_s'] = time.perf_counter() - t0
    tr.close()
    return tr, rec, total


def _train_records(tr):
    with open(os.path.join(tr.options.summary_dir, 'metrics.jsonl')) as f:
        recs = [json.loads(x) for x in f]
    return {r['step']: r for r in recs if 'train/loss' in r}, \
        [r for r in recs if any(k.startswith('val/') for k in r)]


def _state_tensors(tr):
    s = tr.state
    return {'params': dict(s.hmr.named_parameters()), 'mu': s.opt.mu,
            'nu': s.opt.nu, 'fits': {'fits': s.fits}}


def _distance(a, b):
    """Per part (params, mu, nu, fits): the max over its tensors of max
    |a - b| / max |b| (the plain max |a - b| for a zero tensor), and
    whether every tensor is equal bit for bit."""
    dist, equal = {}, True
    for part in b:
        dist[part] = 0.0
        for k, v in b[part].items():
            w = a[part][k].detach()
            v = v.detach()
            equal &= bool(torch.equal(w, v))
            scale = float(v.abs().max())
            d = float((w - v).abs().max())
            dist[part] = max(dist[part], d / scale if scale > 0 else d)
    return dist, equal


def _loss_gaps(got, want, steps):
    """The largest relative difference of two runs' logged losses over
    `steps`: of the step's loss, and of its components (with the name)."""
    total, comp, name = 0.0, 0.0, ''
    for s in steps:
        for k, w in want[s].items():
            if not k.startswith('train/loss'):
                continue
            gap = abs(got[s][k] - w) / max(abs(w), 1e-30)
            if k == 'train/loss':
                total = max(total, gap)
            elif gap >= comp:
                comp, name = gap, k[len('train/'):]
    return total, comp, name


def phase_train_loop(runtime, card, bare_ms):
    """cli/train at full width on the card, in this process, with the
    flags a user types (train_argv): runs A, B (A again: it must repeat
    A), C (A resumed from its step-2 checkpoint) with
    ResNet-50, and D (ViT-S/16, --compute_dtype bfloat16, 2 steps, then
    the time-budget exit). Each run drives the port's main path with every
    count set to 0 before it and read after it."""
    from tuch_tpu_torch import runtime as rt
    shutil.rmtree(TRAIN_LOG_DIR, ignore_errors=True)
    counters = train_counters()
    iters = 10                            # TrainConfig.num_smplify_iters

    def fresh_hmr(backbone, dtype='float32'):
        return rt.build_runtime(device=DEV, synthetic=True,
                                backbone=backbone, dtype=dtype).hmr

    per_step = train_launches('resnet50', iters)
    torch.cuda.reset_peak_memory_stats()
    A, rec_a, total_a = train_run('A', 'resnet50', runtime,
                                  fresh_hmr('resnet50'), counters)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = len(rec_a['step_ms'])
    check(steps == 4 and A.state.step == 4, f'run A took {steps} steps')
    for i, got in enumerate(rec_a['launches'], 1):
        check(got == per_step, f'run A step {i} launches {got} != '
              f'{per_step}')
    check(total_a == {k: 4 * v for k, v in per_step.items()},
          f'run A launches {total_a}')
    recs_a, vals_a = _train_records(A)
    check(sorted(recs_a) == [1, 2, 3, 4], f'metrics lines {sorted(recs_a)}')
    check(all(np.isfinite(v) for r in recs_a.values() for k, v in r.items()
              if k.startswith('train/loss')), 'run A: a non-finite loss')
    check(len(vals_a) == 2, f'run A validated {len(vals_a)} times')
    ckpts = A.ckpt.list_checkpoints()
    check(len(ckpts) == 2 and '_step2_' in ckpts[0] and '_step4_' in
          ckpts[1], f'run A checkpoints {ckpts}')
    for ds in A.fits_layout.offsets:
        check(os.path.isfile(os.path.join(A.options.checkpoint_dir,
                                          f'{ds}_fits.npy')),
              f'no {ds}_fits.npy')
    it_a = iteration_ms(rec_a)
    print(f'[train A] cli/train ResNet-50 B={TRAIN_B} at 224 px, 4 steps '
          f'(256 synthetic samples, 8 loader workers, 10 fit iterations, '
          f'HD contact loss): launches per step {rec_a["launches"][0]}, '
          f'all 4 as phase 12 counts; losses '
          f'{[round(recs_a[s]["train/loss"], 6) for s in range(1, 5)]}; '
          f'val {[[round(x, 3) for x in v.values()] for v in vals_a]} '
          f'mm; checkpoints {[os.path.basename(c) for c in ckpts]}',
          flush=True)
    print(f'[times train A] ms per trainer step (loop iteration: step_fn, '
          f'logging, loader wait; median of steps 2-4) '
          f'{np.median(it_a[1:4]):.3f} (all {[round(x, 3) for x in it_a]}) '
          f'beside phase 12\'s bare step_fn {bare_ms:.3f}; step_fn host ms '
          f'{[round(x, 3) for x in rec_a["step_ms"]]}; card idle when '
          f'step_fn returned: {rec_a["idle_at_return"]}; loader wait ms per '
          f'step {[round(x, 3) for x in rec_a["wait"]]}; validation ms '
          f'{[round(v[1], 3) for v in rec_a["val"]]} (256 samples, B=64); '
          f'checkpoint write ms {[round(c[1], 3) for c in rec_a["ckpt"]]} '
          f'of {[c[2] for c in rec_a["ckpt"]]} bytes; fit {rec_a["fit_s"]:.2f}'
          f' s; peak memory {peak:.3f} GiB (max_memory_allocated); TF32 '
          f'cuDNN {torch.backends.cudnn.allow_tf32}; card: {card}',
          flush=True)

    B, rec_b, _ = train_run('B', 'resnet50', runtime, fresh_hmr('resnet50'),
                            counters)
    C, rec_c, total_c = train_run(
        'C', 'resnet50', runtime, fresh_hmr('resnet50'), counters,
        '--resume', '--checkpoint', ckpts[0])
    check(len(rec_c['step_ms']) == 2 and C.state.step == 4,
          f'run C took {len(rec_c["step_ms"])} steps to step {C.state.step}')
    check(total_c == {k: 2 * v for k, v in per_step.items()},
          f'run C launches {total_c}')
    want = _state_tensors(A)
    parts_b, eq_b = _distance(_state_tensors(B), want)
    parts_c, eq_c = _distance(_state_tensors(C), want)
    recs_b, _ = _train_records(B)
    recs_c, _ = _train_records(C)
    # B repeats A; C must continue A: its steps' losses
    loss_b = _loss_gaps(recs_b, recs_a, (1, 2, 3, 4))
    loss_c = _loss_gaps(recs_c, recs_a, (3, 4))
    # what no noise touches: Adam's count and the dropout generator (its
    # draws do not depend on the data)
    same_count = C.state.opt.count == A.state.opt.count
    same_gen = torch.equal(C.state.generator.get_state(),
                           A.state.generator.get_state())

    def fmt(parts):
        return ', '.join(f'{k} {v:.4g}' for k, v in parts.items())
    print(f'[train B, C] parameters, fits and Adam moments, max abs '
          f'relative to each tensor\'s largest: B from A ({fmt(parts_b)}; '
          f'bit for bit: {eq_b}), C (resumed from A\'s step 2) from A '
          f'({fmt(parts_c)}; bit for bit: {eq_c}), bars ({fmt(RESUME_BAR)}); '
          f'C\'s Adam count and dropout generator equal A\'s: {same_count}, '
          f'{same_gen}; loss, largest component apart (relative): B from A '
          f'{loss_b[0]:.3g}, {loss_b[1]:.3g} ({loss_b[2]}); C\'s steps 3-4 '
          f'from A\'s {loss_c[0]:.3g} (bar {TRAIN_LOSS_RTOL}), '
          f'{loss_c[1]:.3g} ({loss_c[2]})', flush=True)
    check(loss_c[0] <= TRAIN_LOSS_RTOL,
          f'C\'s loss lies {loss_c[0]} from A\'s')
    check(same_count and same_gen,
          'C\'s Adam count or dropout generator differs from A\'s')
    for part, bar in RESUME_BAR.items():
        for tag, parts in (('B', parts_b), ('C', parts_c)):
            check(parts[part] <= bar, f'{tag}\'s {part} lie {parts[part]} '
                  f'from A\'s, over the bar {bar}')

    mha_per_forward = VIT_S16_DEPTH
    D, rec_d, total_d = train_run(
        'D', 'vit_s16', runtime, fresh_hmr('vit_s16', 'bfloat16'), counters,
        '--compute_dtype', 'bfloat16', stop_after=2)
    per_step_d = train_launches('vit_s16', iters)
    val_batches = len(D.val_ds) // TRAIN_B
    want_d = {k: 2 * v for k, v in per_step_d.items()}
    want_d['mha'] += val_batches * mha_per_forward
    recs_d, _ = _train_records(D)
    check(D.state.step == 2 and sorted(recs_d) == [1, 2],
          f'run D: {D.state.step} steps, metrics {sorted(recs_d)}')
    check(all(np.isfinite(v) for r in recs_d.values() for k, v in r.items()
              if k.startswith('train/loss')), 'run D: a non-finite loss')
    check(total_d == want_d, f'run D launches {total_d} != {want_d}')
    e0, e1 = rec_d['events'][1]
    print(f'[train D] cli/train ViT-S/16 --compute_dtype bfloat16, B='
          f'{TRAIN_B}: 2 steps, validation and a checkpoint at step 2, then '
          f'the time-budget exit; launches {total_d} (kernel 1 in bf16: '
          f'{mha_per_forward} per forward, 2 training forwards and '
          f'{val_batches} validation batches); losses '
          f'{[round(recs_d[s]["train/loss"], 6) for s in (1, 2)]}',
          flush=True)
    print(f'[times train D] bf16 step 2: step_fn host '
          f'{rec_d["step_ms"][1]:.3f} ms, CUDA events around it '
          f'{e0.elapsed_time(e1):.3f} ms, card idle at return '
          f'{rec_d["idle_at_return"][1]}; step 1 (first bf16 step of the '
          f'process) {rec_d["step_ms"][0]:.3f} ms; loader wait '
          f'{[round(x, 3) for x in rec_d["wait"]]} ms; validation '
          f'{[round(v[1], 3) for v in rec_d["val"]]} ms; checkpoint '
          f'{[round(c[1], 3) for c in rec_d["ckpt"]]} ms of '
          f'{[c[2] for c in rec_d["ckpt"]]} bytes; card: {card}', flush=True)
    launches_per = {'train step': per_step, 'eval batch (ViT-S/16)':
                    {'mha': mha_per_forward}}
    print(f'[train] kernel launches {launches_per}', flush=True)
    return ckpts[-1]


def _eval_main(argv, device=DEV):
    from tuch_tpu_torch.cli import eval as eval_cli
    return eval_cli.main(argv + ['--device', device])


def phase_eval(checkpoint, card):
    """cli/eval --synthetic on the weights of run A's last checkpoint
    (--checkpoint): 8 samples on the card and on the CPU (TF32 off), each
    sample's errors within VERTEX_TOL (and the pipeline warm); then 256
    samples at B=64 with and without --bn_fold: the reports within
    EVAL_BN_FOLD_MM, and images/s (run_evaluation's wall time: loader,
    forward, metrics)."""
    from tuch_tpu_torch.eval import evaluate as EV
    argv = ['--synthetic', '--checkpoint', checkpoint, '--log_freq', '1000',
            '--dataset', '3dpw']
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for dev in (DEV, 'cpu'):
            _eval_main(argv + ['--synthetic_samples', '8', '--batch_size',
                               '8', '--result_file', f'eval8_{dev}.npz'],
                       dev)
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = tf32
    card8, cpu8 = (np.load(os.path.join('out', f'eval8_{d}.npz'))
                   for d in (DEV, 'cpu'))
    errs = {k: float(np.abs(card8[k] - cpu8[k]).max())
            for k in ('mpjpe', 'recon_err')}
    print(f'[parity eval] 8 samples, card against CPU (TF32 off), max abs '
          f'per-sample difference (m): {errs} (bar {VERTEX_TOL})',
          flush=True)
    check(all(v <= VERTEX_TOL for v in errs.values()),
          f'eval card vs CPU {errs}')
    run_evaluation = EV.run_evaluation
    reports = {}
    for fold in (False, True):
        seconds = []

        def timed(*a, **kw):
            t0 = time.perf_counter()
            out = run_evaluation(*a, **kw)
            seconds.append(time.perf_counter() - t0)
            return out
        EV.run_evaluation = timed
        try:
            reports[fold] = _eval_main(argv + [
                '--synthetic_samples', '256', '--batch_size', str(TRAIN_B)]
                + (['--bn_fold'] if fold else []))
        finally:
            EV.run_evaluation = run_evaluation
        print(f'[times eval{" --bn_fold" if fold else ""}] cli/eval '
              f'--synthetic 256 samples at B={TRAIN_B}, ResNet-50 (run A\'s '
              f'checkpoint): {256 / seconds[0]:.1f} images/s '
              f'(run_evaluation {1e3 * seconds[0]:.3f} ms with its loader); '
              f'report {reports[fold]}; TF32 cuDNN '
              f'{torch.backends.cudnn.allow_tf32}; card: {card}', flush=True)
    for k in ('mpjpe', 'pa_mpjpe'):
        d = abs(reports[True][k] - reports[False][k])
        check(d <= EVAL_BN_FOLD_MM, f'--bn_fold moves {k} by {d} mm')


# ---------------------------------------------------------------------------
# EFT and the demo (phases 15 and 16)
# ---------------------------------------------------------------------------

def eft_sample(num_classes):
    """The first sample of cli/fit_eft --synthetic's database, as (1, ...)
    numpy arrays: image, keypoints, contact labels."""
    import tempfile
    from tuch_tpu_torch.data.dataset import TuchDataset, synthetic_db
    with tempfile.TemporaryDirectory() as d:
        db = synthetic_db(4, img_dir=d, seed=0,
                          num_contact_classes=num_classes)
        s = TuchDataset(SimpleNamespace(img_res=224, seed=0), 'dsc_df',
                        data=db, img_dir=d, use_augmentation=False,
                        num_contact_classes=num_classes).get(0)
    return [np.asarray(s[k])[None].astype(np.float32)
            for k in ('img', 'keypoints', 'contact_vec')]


def eft_fit_on(dev, runtime, sample, dtype=torch.float32, **kw):
    """make_eft_fit_fn on `dev` from runtime's ResNet-50 weights and body
    (copies; in float64 with dtype): (fit_one, start state, inputs)."""
    from tuch_tpu_torch.fitting import eft as E
    from tuch_tpu_torch.losses.eft import EFTWeights
    hmr = copy.deepcopy(runtime.hmr).to(dev)
    smpl = copy.deepcopy(runtime.smpl).to(dev)
    contact = runtime.contact.to(dev)
    if dtype == torch.float64:
        hmr, smpl = hmr.double(), smpl.double()
        hmr.dtype = dtype
        contact = contact._replace(
            segment_tables=_to_double(contact.segment_tables))
    fit = E.make_eft_fit_fn(hmr, smpl, contact, EFTWeights(), img_res=224,
                            **kw)
    start = {k: v.detach().clone() for k, v in hmr.state_dict().items()}
    ins = [torch.as_tensor(x, dtype=dtype, device=dev) for x in sample]
    return fit, start, ins


def phase_eft(runtime, card, launches):
    """cli/fit_eft --synthetic on the card (4 images, ResNet-50 at 224 px,
    the full body with every contact asset): finite outputs, the npz
    schema, the exact launches of kernels 2, 4, 5, 6 and 8 per step (kernel
    8's a step go into launches), steps and
    ms per image; then on the first image the card against the port's CPU
    path over EFT_PARITY_STEPS steps on the same dropout masks (TF32 off),
    the stop check's cost (steps with a loss read each against steps with
    none, in turns) and one profiled fit's device busy time and idle
    share."""
    from tuch_tpu_torch.cli import fit_eft
    from tuch_tpu_torch.fitting import eft as E
    from tuch_tpu_torch.models.hmr import draw_dropout_masks
    fitters = []

    class Recorded(E.EFTFitter):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            fitters.append(self)

    shutil.rmtree(EFT_DIR, ignore_errors=True)
    counters = slice_counters()
    cls, E.EFTFitter = E.EFTFitter, Recorded
    try:
        t0 = time.perf_counter()
        for c in counters.values():
            c.launches = 0                   # the main path starts here
        written = fit_eft.main(['--synthetic', '--out_dir', EFT_DIR,
                                '--device', DEV])
        counts = {k: c.launches for k, c in counters.items()}  # ... ends
        wall = time.perf_counter() - t0
    finally:
        E.EFTFitter = cls
    (fitter,), (path,) = fitters, written
    records = fitter.records
    steps = sum(r[1] for r in records)
    expected = {k: n * steps for k, n in EFT_STEP_LAUNCHES.items()}
    with np.load(path) as d:
        out = {k: d[k] for k in d.files}
    check(sorted(out) == ['betas', 'indices', 'pose'],
          f'eft npz {sorted(out)}')
    check(out['pose'].shape == (4, 72) and out['betas'].shape == (4, 10)
          and out['pose'].dtype == np.float32, 'eft npz shapes')
    check(out['indices'].tolist() == [0, 1, 2, 3], 'eft npz indices')
    check(bool(np.isfinite(out['pose']).all()
               and np.isfinite(out['betas']).all()), 'eft: non-finite fit')
    check(all(np.isfinite(r[2]) for r in records), 'eft: non-finite loss')
    per_step = [1e3 * r[3] / r[1] for r in records]
    print(f'[eft] cli/fit_eft --synthetic, {len(records)} images, ResNet-50 '
          f'at 224 px, {runtime.smpl.v_template.shape[0]} vertices: steps '
          f'{[r[1] for r in records]}, loss '
          f'{[round(r[2], 3) for r in records]}; ms per image '
          f'{[round(1e3 * r[3], 3) for r in records]}, per step '
          f'{[round(x, 3) for x in per_step]} (median '
          f'{np.median(per_step):.3f}); whole run {wall:.3f} s with its '
          f'runtime; launches {counts}, expected {expected} '
          f'({EFT_STEP_LAUNCHES} a step); card: {card}', flush=True)
    check(counts == expected, f'eft launches {counts} != {expected}')
    launches['adam'] = counts['adam'] // steps

    # the card against the CPU, same masks, TF32 off
    sample = eft_sample(len(runtime.contact_classes))
    masks = [draw_dropout_masks(1, torch.Generator().manual_seed(40 + i))
             for i in range(EFT_PARITY_STEPS)]
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    res = {}
    try:
        for tag, dev, dtype in (('card', DEV, torch.float32),
                                ('cpu', 'cpu', torch.float32),
                                ('float64', 'cpu', torch.float64)):
            fit, start, ins = eft_fit_on(dev, runtime, sample, dtype,
                                         max_steps=EFT_PARITY_STEPS)
            r = fit(start, *ins, dropout=lambda i, dev=dev: [
                tuple(m.to(dev) for m in pair) for pair in masks[i]])
            res[tag] = dict(pose=r.pose.cpu().double(),
                            betas=r.betas.cpu().double(), loss=r.loss,
                            steps=r.steps)
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = tf32
    card_r, cpu_r, exact = res['card'], res['cpu'], res['float64']
    loss_gap = abs(card_r['loss'] - cpu_r['loss']) / (
        TRAIN_LOSS_RTOL * abs(cpu_r['loss'])
        + TRAIN_LOSS_ATOL * max(1.0, abs(cpu_r['loss'])))
    ratios = {}
    for part in ('pose', 'betas'):
        c, g, e = cpu_r[part], card_r[part], exact[part]
        ratios[part] = (g - e).norm().item() / (
            2 * (c - e).norm().item() + TRAIN_GRAD_RTOL * c.norm().item())
        print(f'[parity eft]   {part}: |card - float64| '
              f'{(g - e).norm().item():.4g}, |CPU - float64| '
              f'{(c - e).norm().item():.4g}, |CPU| {c.norm().item():.4g}',
              flush=True)
    print(f'[parity eft] {EFT_PARITY_STEPS} steps on one image, ResNet-50 '
          f'at 224 px: loss {card_r["loss"]:.7g} (card) vs '
          f'{cpu_r["loss"]:.7g} (CPU) vs {exact["loss"]:.7g} (CPU float64), '
          f'{loss_gap:.3g} of its bar (rtol {TRAIN_LOSS_RTOL}); pose and '
          f'betas: ratio of |card - float64| to twice |CPU - float64| + '
          f'{TRAIN_GRAD_RTOL} |CPU| '
          f'{ {k: round(v, 3) for k, v in ratios.items()} } (<= 1)',
          flush=True)
    check(card_r['steps'] == cpu_r['steps'] == EFT_PARITY_STEPS,
          'eft parity: steps')
    check(loss_gap <= 1.0, f'eft parity: loss {loss_gap}')
    check(max(ratios.values()) <= 1.0, f'eft parity: {ratios}')

    # the stop check: the same steps reading the loss after each (from
    # step 1: min_steps -1, early_stop_loss -inf) and reading it once at
    # the end (min_steps = max_steps), in turns
    variants = {'read each step': dict(min_steps=-1,
                                       early_stop_loss=float('-inf')),
                'no read': dict(min_steps=EFT_AB_STEPS)}
    fits = {tag: eft_fit_on(DEV, runtime, sample, max_steps=EFT_AB_STEPS,
                            **kw) for tag, kw in variants.items()}
    gen = torch.Generator(device=DEV).manual_seed(0)

    def run(tag):
        fit, start, ins = fits[tag]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fit(start, *ins, generator=gen)
        torch.cuda.synchronize()
        check(r.steps == EFT_AB_STEPS, f'eft {tag}: {r.steps} steps')
        return 1e3 * (time.perf_counter() - t0) / EFT_AB_STEPS

    for tag in variants:
        run(tag)                              # warm
    ab = {tag: [] for tag in variants}
    for i in range(EFT_AB_PAIRS):
        order = list(variants) if i % 2 == 0 else list(variants)[::-1]
        for tag in order + order[::-1]:
            ab[tag].append(run(tag))
    med = {tag: float(np.median(v)) for tag, v in ab.items()}
    cost = med['read each step'] - med['no read']
    wall, prof = profiled(lambda: run('read each step'))
    busy, top = kernel_rows(prof, top=6)
    check_ms = [e.cpu_time_total / 1e3 / e.count
                for e in prof.key_averages() if e.key == 'eft_step.stop_check']
    print(f'[times eft] ms per step over {EFT_AB_STEPS} steps (median of '
          f'{2 * EFT_AB_PAIRS}): '
          + ', '.join(f'{tag} {v:.3f} ({[round(x, 3) for x in ab[tag]]})'
                      for tag, v in med.items())
          + f'; the stop check costs {cost:.3f} ms a step; profiled '
          f'({EFT_AB_STEPS} steps, reading each): host wall {wall:.3f} ms, '
          f'device busy {busy:.3f} ms ({busy / EFT_AB_STEPS:.3f} a step), '
          f'idle {100 * (1 - busy / wall):.1f}%, stop check span '
          f'{check_ms[0] if check_ms else float("nan"):.3f} ms host a call; '
          f'top kernels {[(n, round(ms, 3), c) for n, ms, c in top]}; '
          f'TF32 cuDNN {torch.backends.cudnn.allow_tf32}; card: {card}',
          flush=True)


def phase_demo(card):
    """cli/demo_tuch --synthetic on the card and on the CPU (TF32 off):
    every output written, the card's vertices within VERTEX_TOL of the
    CPU's, the native library taken for the crop and the renders; then the
    demo over DEMO_TIMED_IMAGES images on the card, each image's time by
    part, and one crop at 224 px by the native warp and by the numpy
    warp."""
    from tuch_tpu_torch.cli import demo_tuch
    from tuch_tpu_torch.data import transforms as T
    from tuch_tpu_torch.viz import native
    shutil.rmtree(DEMO_DIR, ignore_errors=True)
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    recs = {}
    try:
        for dev in (DEV, 'cpu'):
            calls = dict(native.calls)
            outdir = os.path.join(DEMO_DIR, dev)
            (recs[dev],) = demo_tuch.main(['--synthetic', '--outdir', outdir,
                                           '--device', dev])
            made = {k: native.calls[k] - calls[k] for k in calls}
            check(made == {'rasterize_mesh': 2, 'affine_warp_f32': 1},
                  f'demo {dev}: native calls {made}')
            for suffix in DEMO_FILES:
                f = os.path.join(outdir, 'synthetic_input' + suffix)
                check(os.path.isfile(f) and os.path.getsize(f) > 0,
                      f'demo {dev}: {f} missing')
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = tf32
    verts = {dev: r[1] for dev, r in recs.items()}
    err = float(np.abs(verts[DEV] - verts['cpu']).max())
    check(bool(np.isfinite(verts[DEV]).all()), 'demo: non-finite vertices')
    print(f'[demo] cli/demo_tuch --synthetic, ResNet-50 at 224 px: every '
          f'output written on the card and on the CPU; vertices card vs CPU '
          f'{err:.3g} m (bar {VERTEX_TOL}, TF32 off); native library '
          f'{native.library_path().name}', flush=True)
    check(err <= VERTEX_TOL, f'demo: vertices card vs CPU {err}')

    # times: a directory of images on the card (TF32 defaults)
    src = os.path.join(DEMO_DIR, DEV, 'synthetic_input.png')
    img_dir = os.path.join(DEMO_DIR, 'images')
    os.makedirs(img_dir)
    for i in range(DEMO_TIMED_IMAGES):
        shutil.copy(src, os.path.join(img_dir, f'img_{i:02d}.png'))
    recs = demo_tuch.main(['--synthetic', '--img', img_dir, '--outdir',
                           os.path.join(DEMO_DIR, 'timed'), '--device', DEV])
    parts = {p: [1e3 * r[3][p] for r in recs[1:]] for p in demo_tuch.PARTS}
    img = (np.random.RandomState(0).rand(480, 640, 3) * 255).astype(np.uint8)
    crop_ms = {}
    t = T.get_transform((320, 240), 2.0, (224, 224), 10.0)
    for tag, fn in (
            ('native', lambda: T.crop_image(img, (320, 240), 2.0,
                                            (224, 224), rot=10.0)),
            ('numpy', lambda: T.affine_warp_numpy(img, np.linalg.inv(t),
                                                  (224, 224)))):
        fn()
        ts = []
        for _ in range(CROP_TIMED):
            t0 = time.perf_counter()
            fn()
            ts.append(1e3 * (time.perf_counter() - t0))
        crop_ms[tag] = float(np.median(ts))
    print(f'[times demo] cli/demo_tuch over {DEMO_TIMED_IMAGES} images on '
          f'the card, ms per image (median of images 2-{DEMO_TIMED_IMAGES}, '
          f'host clock): '
          + ', '.join(f'{p} {np.median(v):.3f}' for p, v in parts.items())
          + f', total {np.median([sum(x) for x in zip(*parts.values())]):.3f}'
          f'; one crop at 224 px from 480x640 uint8 (median of '
          f'{CROP_TIMED}): native warp {crop_ms["native"]:.3f} ms, numpy '
          f'warp {crop_ms["numpy"]:.3f} ms; card: {card}', flush=True)
    shutil.rmtree(DEMO_DIR, ignore_errors=True)


# ---------------------------------------------------------------------------
# The offline tools and the real-format path (phases 17 and 18)
# ---------------------------------------------------------------------------

def write_smplx_shard(folder, smpl, n, seed):
    """`n` smplx-format pkls (cli/smplx_to_smpl's input) of bodies posed
    and shaped from a seed, on SMPL's topology: the vertices of the body,
    its global orientation, and a body pose 0.1 rad (per component) off
    the body's own, as an SMPL-X fit's differs from the SMPL pose that
    makes its vertices. Returns (folder of the pkls, targets, init poses)
    as convert_folder reads them."""
    import pickle

    from tuch_tpu_torch.cli import smplx_to_smpl as X
    from tuch_tpu_torch.models.smpl import smpl_forward_pose72
    rng = np.random.RandomState(seed)
    pose = (rng.randn(n, 72) * 0.3).astype(np.float32)
    betas = (rng.randn(n, 10) * 0.5).astype(np.float32)
    off = pose + (rng.randn(n, 72) * 0.1).astype(np.float32)
    with torch.no_grad():
        verts = smpl_forward_pose72(
            smpl, torch.as_tensor(betas, device=DEV),
            torch.as_tensor(pose, device=DEV)).vertices.cpu().numpy()
    folder = os.path.join(folder, 'smplx', 'params')
    os.makedirs(folder)
    inits = []
    for i in range(n):
        with open(os.path.join(folder, f'{i:03d}.pkl'), 'wb') as f:
            pickle.dump({'vertices': verts[i], 'body_pose': off[i, 3:66],
                         'global_orient': pose[i, :3]}, f)
        inits.append(X._init_pose_from_smplx(off[i, 3:66], pose[i, :3]))
    return folder, verts, np.stack(inits)


def phase_smplx_to_smpl(card):
    """Phase 17 (_smplx_to_smpl) with torch's deterministic algorithms off:
    cli/smplx_to_smpl leaves that mode as it finds it, and phase 13 turned
    it on for this process (runtime.deterministic), so it is off here, as a
    user of the CLI runs it, and restored after."""
    mode = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(False)
    try:
        _smplx_to_smpl(card)
    finally:
        torch.use_deterministic_algorithms(mode[0], warn_only=mode[1])
        shutil.rmtree(SMPLX_DIR, ignore_errors=True)


def _smplx_to_smpl(card):
    """cli/smplx_to_smpl's convert_folder on the card at full width: a
    shard of SMPLX_SHARD bodies of the full-topology body posed from a seed
    (write_smplx_shard), SMPLX_STEPS Adam steps: ms per shard and per step
    (host clock; the fit ends in a copy to the host), the peak memory,
    every output pkl written and each body's loss below half its start;
    one fit of SMPLX_PROFILED_STEPS steps under torch.profiler
    (device busy, idle share, top kernels); fits of SMPLX_AB_STEPS steps
    with torch's deterministic algorithms off and on, in turns (what the
    training entry points' runtime.deterministic costs an eager host-bound
    loop); then the card against the CPU after SMPLX_PARITY_STEPS steps on
    SMPLX_PARITY_BODIES bodies (TF32 off)."""
    import contextlib
    import pickle

    from tuch_tpu_torch import assets
    from tuch_tpu_torch.cli import smplx_to_smpl as X
    from tuch_tpu_torch.fitting.smplx_to_smpl import fit_smpl_to_vertices
    from tuch_tpu_torch.models.smpl import SMPL
    smpl = SMPL(assets.synthetic_smpl()[0]).to(DEV)
    shutil.rmtree(SMPLX_DIR, ignore_errors=True)
    folder, *arrays = write_smplx_shard(SMPLX_DIR, smpl, SMPLX_SHARD, 17)
    targets, inits = (torch.as_tensor(a, device=DEV) for a in arrays)
    start = fit_smpl_to_vertices(smpl, targets, init_pose=inits,
                                 num_steps=0, fit_translation=True).loss
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        outs = X.convert_folder(folder, None, smpl, num_steps=SMPLX_STEPS)
    shard_ms = 1e3 * (time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    errs = np.array([float(ln.rsplit('err ', 1)[1].rstrip(')'))
                     for ln in log.getvalue().splitlines() if 'err ' in ln])
    check(len(outs) == SMPLX_SHARD and len(errs) == SMPLX_SHARD,
          f'smplx_to_smpl wrote {len(outs)} pkls')
    for path in outs:
        with open(path, 'rb') as f:
            out = pickle.load(f)
        check('/smpl/' in path and out['pose'].shape == (72,)
              and out['betas'].shape == (10,)
              and out['pose'].dtype == np.float64
              and np.isfinite(out['pose']).all()
              and np.isfinite(out['betas']).all(), f'smplx_to_smpl {path}')
    # the fit at least halves every body's mean vertex distance
    below = errs < 0.5 * start.cpu().numpy()
    check(bool(np.isfinite(errs).all() and below.all()),
          f'smplx_to_smpl: loss not below half its start for '
          f'{int((~below).sum())} bodies')
    wall, prof = profiled(lambda: fit_smpl_to_vertices(
        smpl, targets, init_pose=inits, num_steps=SMPLX_PROFILED_STEPS,
        fit_translation=True).loss.cpu())
    busy, top = kernel_rows(prof, top=5)
    print(f'[times smplx_to_smpl] cli/smplx_to_smpl shard of {SMPLX_SHARD} '
          f'bodies x 6890 vertices, {SMPLX_STEPS} Adam steps (the '
          f'reference runs {SMPLX_REFERENCE_STEPS}): {shard_ms:.3f} ms per '
          f'shard, '
          f'{shard_ms / SMPLX_STEPS:.4f} ms per step (host clock); peak '
          f'memory {peak:.3f} GiB; loss (mean vertex distance, m) start '
          f'{float(start.mean()):.4g}, end median {np.median(errs):.4g}, '
          f'max {errs.max():.4g}; one fit of {SMPLX_PROFILED_STEPS} steps '
          f'profiled: host wall {wall:.3f} ms, device busy {busy:.3f} ms '
          f'({busy / SMPLX_PROFILED_STEPS:.4f} ms a step), idle share '
          f'{1 - busy / wall:.1%}; top kernels '
          + ', '.join(f'{n} {ms:.3f} ms x{c}' for n, ms, c in top)
          + f'; card: {card}', flush=True)

    ab = {False: [], True: []}
    for det in (False, True, True, False):
        torch.use_deterministic_algorithms(det, warn_only=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fit_smpl_to_vertices(smpl, targets, init_pose=inits,
                             num_steps=SMPLX_AB_STEPS,
                             fit_translation=True).loss.cpu()
        ab[det].append(1e3 * (time.perf_counter() - t0) / SMPLX_AB_STEPS)
    torch.use_deterministic_algorithms(False)
    print(f'[times smplx_to_smpl determinism] ms per step over '
          f'{SMPLX_AB_STEPS} steps, in turns off, on, on, off (host clock): '
          f'deterministic algorithms off {[round(x, 4) for x in ab[False]]}'
          f', on {[round(x, 4) for x in ab[True]]}; card: {card}',
          flush=True)

    n = SMPLX_PARITY_BODIES
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        got = fit_smpl_to_vertices(smpl, targets[:n], init_pose=inits[:n],
                                   num_steps=SMPLX_PARITY_STEPS,
                                   fit_translation=True)
        smpl_cpu = copy.deepcopy(smpl).cpu()
        smpl_cpu.parents = smpl.parents
        want = fit_smpl_to_vertices(smpl_cpu, targets[:n].cpu(),
                                    init_pose=inits[:n].cpu(),
                                    num_steps=SMPLX_PARITY_STEPS,
                                    fit_translation=True)
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = tf32
    d = {k: float((g.cpu() - w).abs().max())
         for k, g, w in zip(('pose', 'betas', 'loss'), got, want)}
    rel = float(((got.loss.cpu() - want.loss).abs() / want.loss).max())
    print(f'[parity smplx_to_smpl] {n} bodies, {SMPLX_PARITY_STEPS} steps, '
          f'card against CPU (TF32 off): pose {d["pose"]:.3g}, betas '
          f'{d["betas"]:.3g} (bar {SMPLX_ATOL}), loss relative {rel:.3g} '
          f'(bar {SMPLX_LOSS_RTOL})', flush=True)
    check(d['pose'] <= SMPLX_ATOL and d['betas'] <= SMPLX_ATOL
          and rel <= SMPLX_LOSS_RTOL, f'smplx_to_smpl card vs CPU {d}, {rel}')


def _write_ply(path, verts, red_ids):
    """An ascii PLY with red 255 on `red_ids` (a body segment's file)."""
    red = np.zeros(len(verts), np.uint8)
    red[np.asarray(red_ids)] = 255
    with open(path, 'w') as f:
        f.write(f'ply\nformat ascii 1.0\nelement vertex {len(verts)}\n'
                'property float x\nproperty float y\nproperty float z\n'
                'property uchar red\nproperty uchar green\n'
                'property uchar blue\nend_header\n')
        for (x, y, z), r in zip(verts, red):
            f.write(f'{x} {y} {z} {r} 0 0\n')


def real_format_tree(root):
    """The real assets' files in their reference layout for the synthetic
    full-topology body (6890 vertices, 13776 faces), written from the
    port's synthetic assets, and the port's config pointed at them: the
    SMPL pickles (neutral, male and female), the extra and H36M joint
    regressors, mean params, GMM prior, geodesics, the DSC region tables
    over the body parts that cli/preprocess --synthetic's DSC databases
    index (each part one of the body's contact regions), two body segments
    and an HD regressor of REAL_HD_POINTS face barycentres. Returns the
    ContactExtras."""
    import pickle

    from tuch_tpu_torch import assets, config as cfg
    from tuch_tpu_torch.data.preprocess import synthetic_raw as sr
    model, means = assets.synthetic_smpl()
    extras = assets.synthetic_contact()
    dirs = {k: os.path.join(root, *v.split('/')) for k, v in dict(
        smpl='models/smpl', spin='essentials/spin',
        geo='essentials/geodesics/smpl', dsc='dsc_release',
        seg='essentials/segments/smpl', hd='essentials/hd_model/smpl').items()}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    kintree = np.zeros((2, len(model.parents)), np.int64)
    kintree[0] = np.concatenate([[2 ** 32 - 1], model.parents[1:]])
    body = dict(v_template=model.v_template, shapedirs=model.shapedirs,
                posedirs=model.posedirs, J_regressor=model.J_regressor,
                weights=model.lbs_weights, kintree_table=kintree,
                f=model.faces)
    for gender, seed in (('NEUTRAL', 0), ('MALE', 1), ('FEMALE', 2)):
        v = assets.synthetic_smpl(seed=seed)[0].v_template
        with open(os.path.join(dirs['smpl'], f'SMPL_{gender}.pkl'),
                  'wb') as f:
            pickle.dump(dict(body, v_template=v), f)
    np.save(os.path.join(dirs['spin'], 'J_regressor_extra.npy'),
            model.J_regressor_extra)
    np.savez(os.path.join(dirs['spin'], 'smpl_mean_params.npz'),
             pose=means.mean_pose6d[None], shape=means.mean_shape[None],
             cam=means.mean_cam)
    gmm = assets.synthetic_gmm_prior()
    with open(os.path.join(dirs['spin'], 'gmm_08.pkl'), 'wb') as f:
        pickle.dump({'means': gmm['means'], 'covars': gmm['covs'],
                     'weights': gmm['weights']}, f)
    np.save(os.path.join(dirs['geo'], 'smpl_neutral_geodesic_dist.npy'),
            extras.geodists)
    with open(os.path.join(dirs['dsc'], 'classes.pkl'), 'wb') as f:
        pickle.dump([tuple(map(str, p)) for p in sr._bodypart_classes()], f)
    with open(os.path.join(dirs['dsc'], 'ContactSigSMPL.pkl'), 'wb') as f:
        pickle.dump({part: extras.contact_csig[f'reg{i}']
                     for i, part in enumerate(sr.BODY_PARTS)}, f)
    seg_py = 'segments = {\n'
    for name, seg in list(extras.segments.items())[:2]:
        bands = {f'band{k}': list(map(int, b))
                 for k, b in enumerate(seg['bands_verts'])}
        seg_py += f'    {name!r}: {bands!r},\n'
        _write_ply(os.path.join(dirs['seg'], f'smpl_segment_{name}.ply'),
                   model.v_template, seg['vidx'])
    with open(os.path.join(dirs['seg'], 'segm_utils.py'), 'w') as f:
        f.write(seg_py + '}\n')
    rng = np.random.RandomState(18)
    faces = rng.choice(len(model.faces), REAL_HD_POINTS, replace=False)
    hd_reg = np.zeros((REAL_HD_POINTS, len(model.v_template)), np.float32)
    hd_reg[np.arange(REAL_HD_POINTS)[:, None], model.faces[faces]] = 1 / 3
    np.save(os.path.join(dirs['hd'], 'smpl_neutral_hd_vert_regressor.npy'),
            hd_reg)
    with open(os.path.join(dirs['hd'],
                           'smpl_neutral_hd_sample_from_mesh_out.pkl'),
              'wb') as f:
        pickle.dump({'faces_vert_is_sampled_from': faces}, f)
    np.save(os.path.join(root, 'J_regressor_h36m.npy'),
            model.J_regressor[:17])
    cfg.SMPL_MODEL_DIR = dirs['smpl']
    cfg.JOINT_REGRESSOR_TRAIN_EXTRA = os.path.join(dirs['spin'],
                                                   'J_regressor_extra.npy')
    cfg.SMPL_MEAN_PARAMS = os.path.join(dirs['spin'], 'smpl_mean_params.npz')
    cfg.PRIOR_FOLDER = dirs['spin']
    cfg.GEODESICS_SMPL = os.path.join(dirs['geo'],
                                      'smpl_neutral_geodesic_dist.npy')
    cfg.DSC_ROOT, cfg.SEGMENT_DIR = dirs['dsc'], dirs['seg']
    cfg.HD_MODEL_DIR = dirs['hd']
    cfg.JOINT_REGRESSOR_H36M = os.path.join(root, 'J_regressor_h36m.npy')
    return extras


def real_databases(root):
    """cli/preprocess --synthetic's databases (plain pickles) under root,
    a random image for every sample they name (the raw trees hold
    annotations only), the 3DPW contact signature, and the port's config
    pointed at them (DATASET_FILES, IMAGE_FOLDERS, THREEDPW_CIG)."""
    from PIL import Image

    from tuch_tpu_torch import config as cfg
    from tuch_tpu_torch.cli import preprocess
    from tuch_tpu_torch.data.dataset import load_db
    out = os.path.join(root, 'dbs')
    preprocess.main(['--synthetic', '--out', out])
    rng = np.random.RandomState(18)
    for db_name, split, ds, folder, side in (
            ('dsc_df_train', 'train', 'dsc_df', 'images/df', 320),
            ('dsc_lsp_train', 'train', 'dsc_lsp', 'images/lsp', 400),
            ('dsc_lspet_train', 'train', 'dsc_lspet', 'images/lspet', 400),
            ('mtp_train', 'train', 'mtp', 'mtp/images', None),
            ('mtp_val', 'val', 'mtp', 'mtp/images', None),
            ('3dpw_test', 'test', '3dpw', '3dpw', 600)):
        path = os.path.join(out, f'{db_name}.pt')
        img_dir = os.path.join(out, 'raw', *folder.split('/'))
        db = load_db(path)
        for name in db['imgname'] if side else ():
            f = os.path.join(img_dir, str(name))
            os.makedirs(os.path.dirname(f), exist_ok=True)
            Image.fromarray((rng.rand(side, side, 3) * 255).astype(
                np.uint8)).save(f, format='PNG')
        cfg.DATASET_FILES[split][ds] = path
        cfg.IMAGE_FOLDERS[ds] = img_dir
    cig = os.path.join(root, 'csig.npy')
    np.save(cig, rng.rand(len(load_db(cfg.DATASET_FILES['test']['3dpw'])[
        'imgname']), 3, 2))
    cfg.THREEDPW_CIG = cig


def _real_train_step(dev, masks, counters):
    """One cli/train --run_smplify step without --synthetic on `dev`
    (the time-budget exit after it), on the given dropout masks: (the
    launches of each kernel in the step, the step's metrics, outputs, the
    fits after it, the trainer)."""
    from tuch_tpu_torch import config as cfgmod
    from tuch_tpu_torch.cli import train as train_cli
    opts = cfgmod.parse_config(cfgmod.TrainConfig, [
        '--ds_names', 'dsc', 'mtp', '--ds_composition', '0.6', '0.4',
        '--batch_size', str(REAL_B), '--num_epochs', '1', '--num_workers',
        '0', '--val_and_checkpoint_freq', '0', '--run_smplify',
        '--num_smplify_iters', str(REAL_ITERS), '--log_dir',
        os.path.join(REAL_DIR, 'logs'), '--name', dev, '--device', dev])
    tr = train_cli.build(opts)
    tr.renderer = None
    step_fn, seen = tr.step_fn, {}

    def step(state, batch):
        before = {k: c.launches for k, c in counters.items()}
        state, metrics, outputs = step_fn(
            state, batch, dropout=[tuple(m.to(dev) for m in pair)
                                   for pair in masks])
        if dev != 'cpu':
            torch.cuda.synchronize()
        seen.update(launches={k: c.launches - before[k]
                              for k, c in counters.items()},
                    metrics={k: float(v) for k, v in metrics.items()},
                    outputs=outputs, fits_index=batch['fits_index'])
        tr.endtime = 0.0                 # the time-budget exit after it
        return state, metrics, outputs
    tr.step_fn = step
    tr.fit()
    tr.close()
    return seen, tr.state.fits.cpu(), tr


def phase_real_format(card):
    """The port's own data on the card: cli/preprocess --synthetic (host
    only) onto a real-format asset tree of the full-topology body
    (real_format_tree, real_databases), then one cli/train --run_smplify
    step without --synthetic (ResNet-50, B=REAL_B at 224 px, REAL_ITERS
    fit iterations, the HD loss) on the card and on the CPU, on the same
    dropout masks (TF32 off): the launches of kernels 2, 4, 5, 6 and 8 on
    the card, and phase 12's bars (every metric at TRAIN_LOSS_RTOL, the accept
    mask equal, the fits rows and opt_vertices within VERTEX_TOL); then
    cli/eval on the 3DPW test database on the card and on the CPU, each
    sample's errors within VERTEX_TOL."""
    from tuch_tpu_torch import config as cfg
    from tuch_tpu_torch.models import hmr as hmr_mod
    shutil.rmtree(REAL_DIR, ignore_errors=True)
    saved = {k: copy.deepcopy(getattr(cfg, k)) for k in (
        'SMPL_MODEL_DIR', 'JOINT_REGRESSOR_TRAIN_EXTRA', 'SMPL_MEAN_PARAMS',
        'PRIOR_FOLDER', 'GEODESICS_SMPL', 'DSC_ROOT', 'SEGMENT_DIR',
        'HD_MODEL_DIR', 'JOINT_REGRESSOR_H36M', 'THREEDPW_CIG',
        'DATASET_FILES', 'IMAGE_FOLDERS')}
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        t0 = time.perf_counter()
        real_format_tree(REAL_DIR)
        real_databases(REAL_DIR)
        prep_s = time.perf_counter() - t0
        masks = hmr_mod.draw_dropout_masks(
            REAL_B, generator=torch.Generator().manual_seed(18))
        counters = train_counters()
        runs = {}
        for dev in (DEV, 'cpu'):
            t0 = time.perf_counter()
            runs[dev] = _real_train_step(dev, masks, counters)
            runs[dev] += (time.perf_counter() - t0,)
        (card_run, card_fits, card_tr, card_s), (cpu_run, cpu_fits, _,
                                                 cpu_s) = runs[DEV], \
            runs['cpu']
        per_step = train_launches('resnet50', REAL_ITERS)
        check(card_run['outputs']['opt_vertices'].shape[1] == 6890,
              'real-format step: not the full body')
        check(card_run['launches'] == per_step,
              f'real-format step launches {card_run["launches"]} != '
              f'{per_step}')
        check(all(np.isfinite(v) for v in card_run['metrics'].values()),
              f'real-format step: non-finite metrics {card_run["metrics"]}')
        # each metric's distance over its bar, rtol |w| + atol max(1, |w|)
        gaps = {k: abs(card_run['metrics'][k] - w) / (
            TRAIN_LOSS_RTOL * abs(w) + TRAIN_LOSS_ATOL * max(1.0, abs(w)))
            for k, w in cpu_run['metrics'].items()}
        rows = torch.as_tensor(np.asarray(card_run['fits_index'])).long()
        acc = {d: r['outputs']['fit_accepted'].cpu()
               for d, r in ((DEV, card_run), ('cpu', cpu_run))}
        fits_err = float((card_fits - cpu_fits).abs().max())
        vert_err = float((card_run['outputs']['opt_vertices'].cpu()
                          - cpu_run['outputs']['opt_vertices']).abs().max())
        print(f'[real format] cli/preprocess --synthetic and the '
              f'real-format tree of the full body in {prep_s:.1f} s; '
              f'cli/train --run_smplify without --synthetic, ResNet-50 '
              f'B={REAL_B} at 224 px, {REAL_ITERS} fit iterations, HD: '
              f'launches on the card {card_run["launches"]} (rows '
              f'{rows.tolist()}, accepted {acc[DEV].tolist()}); card '
              f'against CPU (TF32 off): metrics at {max(gaps.values()):.3g} '
              f'of their bar (rtol {TRAIN_LOSS_RTOL}), accept '
              f'mask equal {torch.equal(acc[DEV], acc["cpu"])}, fits '
              f'{fits_err:.3g}, opt_vertices {vert_err:.3g} m (bar '
              f'{VERTEX_TOL}); loss {card_run["metrics"]["loss"]:.6g}, '
              f'loss_contact {card_run["metrics"]["loss_contact"]:.6g}; '
              f'cli/train wall (build, load, step, checkpoint) card '
              f'{card_s:.1f} s, CPU {cpu_s:.1f} s', flush=True)
        check(max(gaps.values()) <= 1.0,
              f'real-format step metrics card vs CPU {gaps}')
        check(torch.equal(acc[DEV], acc['cpu'])
              and fits_err <= VERTEX_TOL and vert_err <= VERTEX_TOL,
              f'real-format step: accept {acc}, fits {fits_err}, '
              f'vertices {vert_err}')

        ckpt = card_tr.ckpt.latest()
        for dev in (DEV, 'cpu'):
            _eval_main(['--dataset', '3dpw', '--checkpoint', ckpt,
                        '--batch_size', '4', '--num_workers', '0',
                        '--log_freq', '1000', '--result_file',
                        f'eval_real_{dev}.npz'], dev)
        card_e, cpu_e = (np.load(os.path.join('out', f'eval_real_{d}.npz'))
                         for d in (DEV, 'cpu'))
        errs = {k: float(np.abs(card_e[k] - cpu_e[k]).max())
                for k in ('mpjpe', 'recon_err')}
        for d in (DEV, 'cpu'):
            os.remove(os.path.join('out', f'eval_real_{d}.npz'))
        check(all(np.isfinite(card_e[k]).all() for k in errs)
              and len(card_e['mpjpe']) > 0, 'real-format eval: no results')
        print(f'[real format eval] cli/eval --dataset 3dpw (the 3DPW test '
              f'database of cli/preprocess, {len(card_e["mpjpe"])} samples, '
              f'gendered bodies) on the step\'s checkpoint: card against CPU '
              f'max abs per-sample difference (m) {errs} (bar '
              f'{VERTEX_TOL}); mean mpjpe {1e3 * card_e["mpjpe"].mean():.3f}'
              f' mm', flush=True)
        check(all(v <= VERTEX_TOL for v in errs.values()),
              f'real-format eval card vs CPU {errs}')
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = tf32
        for k, v in saved.items():
            setattr(cfg, k, v)
        shutil.rmtree(REAL_DIR, ignore_errors=True)


# ---------------------------------------------------------------------------
# The device mesh (phases 19-21): ranks as processes that share the card
# ---------------------------------------------------------------------------

def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


class RankPool:
    """POOL_SIZE processes that stay up through phases 19-21 and run the
    ranks of run_ranks' groups, so that a group costs no process start,
    torch import, CUDA context or kernel load (~10-25 s each when every
    group started its own). Each is `chip_smoke.py --rank_worker`, started
    once and warmed while the parent works, and takes jobs one at a time
    from its inbox under PAR_DIR. Before each job it puts back what a fresh
    rank process had: the environment (the parent's, with the rank's
    torchrun variables), the working directory, torch's deterministic,
    cuDNN, TF32 and thread settings and the default generators' seed; after
    it, the job has ended its process group. A job that fails ends its
    worker (its log holds the traceback), and the group with it."""

    def __init__(self, size):
        self.dir = os.path.abspath(os.path.join(PAR_DIR, 'pool'))
        os.makedirs(self.dir, exist_ok=True)
        self.procs = []
        for slot in range(size):
            with open(os.path.join(self.dir, f'worker{slot}.log'), 'w') as f:
                self.procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__),
                     '--rank_worker', str(slot), '--job_dir', self.dir],
                    stdout=f, stderr=subprocess.STDOUT))

    def inbox(self, slot):
        return os.path.join(self.dir, f'worker{slot}.job')

    def submit(self, slot, spec):
        path = self.inbox(slot)
        torch.save(spec, path + '.tmp')
        os.replace(path + '.tmp', path)

    def close(self, timeout=60):
        for slot, p in enumerate(self.procs):
            if p.poll() is None:
                self.submit(slot, None)
        deadline = time.monotonic() + timeout
        for p in self.procs:
            try:
                p.wait(max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()


POOL_SIZE = 4                    # the largest group: cp 4, EFT on 4
POOL = []                        # the RankPool of phases 19-21, while up


def _rank_env(world, r, port):
    return dict(MASTER_ADDR='localhost', MASTER_PORT=str(port),
                WORLD_SIZE=str(world), RANK=str(r), LOCAL_RANK=str(r),
                LOCAL_WORLD_SIZE=str(world))


def run_ranks(job, world, args, timeout=PAR_TIMEOUT, expect_fail=False):
    """Run `job` on `world` ranks, one process each with torchrun's
    environment, all on this card, and return their results in rank order:
    on the pool's workers (RankPool) while it is up, else (and for a group
    expected to fail) in fresh `python3 chip_smoke.py --rank_job`
    processes. A rank that fails or a group that outlives `timeout` fails
    the run (every rank is killed first, the pool with it); with
    expect_fail, (returncodes, logs) instead."""
    d = os.path.abspath(os.path.join(PAR_DIR,
                                     f'{job}_{world}_{time.time_ns()}'))
    os.makedirs(d)
    torch.save(args, os.path.join(d, 'args.pt'))
    port = free_port()
    logs = [os.path.join(d, f'rank{r}.log') for r in range(world)]
    pooled = (bool(POOL) and not expect_fail and world <= POOL_SIZE
              and not job.startswith('nccl'))   # NCCL in its own process
    procs = []
    if pooled:
        pool_dir, procs = POOL[0].dir, POOL[0].procs[:world]
        for r in range(world):
            POOL[0].submit(r, dict(job=job, job_dir=d, log=logs[r],
                                   env=_rank_env(world, r, port)))
    else:
        for r in range(world):
            with open(logs[r], 'w') as log:
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), '--rank_job',
                     job, '--job_dir', d],
                    env=dict(os.environ, **_rank_env(world, r, port)),
                    stdout=log, stderr=subprocess.STDOUT))
    results = [os.path.join(d, f'rank{r}.pt') for r in range(world)]

    def running():
        if pooled:      # a worker is done with the job once it saved it
            return not all(os.path.exists(f) for f in results)
        return any(p.poll() is None for p in procs)
    deadline = time.monotonic() + timeout
    failed = None
    try:
        while running():
            bad = [r for r, p in enumerate(procs)
                   if p.poll() is not None and (pooled or p.returncode)]
            if bad and not expect_fail:
                failed = f'rank {bad[0]} exited {procs[bad[0]].returncode}'
                break
            if time.monotonic() > deadline:
                failed = f'no end within {timeout} s'
                break
            time.sleep(0.2)
    finally:
        if failed and pooled:
            for p in POOL.pop().procs:
                p.kill()
                p.wait()
        for p in [] if pooled else procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    texts = []
    for r, path in enumerate(logs):
        if not os.path.exists(path) and pooled:   # the worker's own log
            path = os.path.join(pool_dir, f'worker{r}.log')
        with open(path) as f:
            texts.append(f.read())
    if expect_fail:
        return ([p.returncode for p in procs], failed,
                [torch.load(f, weights_only=False) if os.path.exists(f)
                 else None for f in results], texts)
    if failed is None and not pooled and any(p.returncode for p in procs):
        failed = 'ranks exited ' + str([p.returncode for p in procs])
    if failed:
        for r, t in enumerate(texts):
            print(f'[{job} rank {r}] ...{t[-3000:]}', flush=True)
        raise RuntimeError(f'check failed: {job} on {world} ranks: {failed}')
    for line in texts[0].splitlines():
        if line.startswith('['):
            print(line, flush=True)
    return [torch.load(f, weights_only=False) for f in results]


def _fresh_state():
    """What a rank process has before its job: torch's settings that the
    port's entry points change, as a function that puts them back."""
    import torch.utils.deterministic as tud
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = dict(
        det=torch.are_deterministic_algorithms_enabled(),
        warn=torch.is_deterministic_algorithms_warn_only_enabled(),
        fill=tud.fill_uninitialized_memory, cudnn_det=cudnn.deterministic,
        bench=cudnn.benchmark, cudnn_tf32=cudnn.allow_tf32,
        mm_tf32=matmul.allow_tf32,
        precision=torch.get_float32_matmul_precision(),
        threads=torch.get_num_threads(), seed=torch.initial_seed(),
        env=dict(os.environ), cwd=os.getcwd())

    def restore(env=None):
        os.environ.clear()
        os.environ.update(saved['env'], **(env or {}))
        os.chdir(saved['cwd'])
        torch.use_deterministic_algorithms(saved['det'],
                                           warn_only=saved['warn'])
        tud.fill_uninitialized_memory = saved['fill']
        cudnn.deterministic, cudnn.benchmark = (saved['cudnn_det'],
                                                saved['bench'])
        cudnn.allow_tf32, matmul.allow_tf32 = (saved['cudnn_tf32'],
                                               saved['mm_tf32'])
        torch.set_float32_matmul_precision(saved['precision'])
        torch.set_num_threads(saved['threads'])
        torch.manual_seed(saved['seed'])
    return restore


def rank_worker(slot, pool_dir):
    """A RankPool worker: warm up (CUDA, the kernel libraries the parent
    built), then run the jobs of its inbox in turn, each with its output in
    the job's rank log, until it reads None."""
    import gc
    import traceback
    from tuch_tpu_torch.ops import _build
    torch.cuda.init()
    for name in _build.sources():
        _build.load(name)
    restore = _fresh_state()
    inbox = os.path.join(pool_dir, f'worker{slot}.job')
    while True:
        if not os.path.exists(inbox):
            time.sleep(0.05)
            continue
        spec = torch.load(inbox, weights_only=False)
        os.remove(inbox)
        if spec is None:
            return 0
        restore(spec['env'])
        sys.stdout.flush()
        sys.stderr.flush()
        keep = os.dup(1), os.dup(2)
        with open(spec['log'], 'w') as log:
            os.dup2(log.fileno(), 1)
            os.dup2(log.fileno(), 2)
            try:
                rank_job(spec['job'], spec['job_dir'])
            except BaseException:
                traceback.print_exc()
                sys.stdout.flush()
                sys.stderr.flush()
                os._exit(1)
            finally:
                sys.stdout.flush()
                sys.stderr.flush()
                os.dup2(keep[0], 1)
                os.dup2(keep[1], 2)
        for fd in keep:
            os.close(fd)
        gc.collect()
        torch.cuda.empty_cache()


def rank_job(job, job_dir):
    """One rank of run_ranks: start the process group from torchrun's
    environment (but for nccl2, which starts its own), run the job, save
    its result."""
    import torch.distributed as dist
    from tuch_tpu_torch.parallel import multihost
    args = torch.load(os.path.join(job_dir, 'args.pt'), weights_only=False)
    if job != 'nccl2':
        multihost.maybe_initialize_distributed(DEV)
    out = RANK_JOBS[job](args)
    rank = int(os.environ['RANK'])
    path = os.path.join(job_dir, f'rank{rank}.pt')
    torch.save(out, path + '.tmp')
    os.replace(path + '.tmp', path)
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()
    return 0


def cp_counters():
    from tuch_tpu_torch.ops import contact_kernels as CK
    return dict(slice_counters(), masked_min_range=CK.masked_min_keys_cuda)


def _cp_fit_config(mesh):
    from tuch_tpu_torch.fitting import smplify_dc as PF
    return PF.SMPLifyConfig(num_iters=CP_FIT_ITERS, euclthres=0.02,
                            contact_loss_weight=2000.0, mesh=mesh)


def _cp_fit_inputs(P, mesh=None):
    from tuch_tpu_torch.parallel.mesh import shard_rows
    ins = fit_inputs(TRAIN_B, P, 31, DEV)
    ins[0] = ins[0] * 2.5            # fold the body: interior vertices
    return [shard_rows(t, mesh).contiguous() for t in ins]


def job_contact(args):
    """Phase 19 on one rank of a (dp, cp) mesh: contact_neighbors exact
    and with candidate_k on this rank's rows of the posed B=64 body, one
    launch count each; CP_FIT_ITERS SMPLify-DC iterations with
    SMPLifyConfig(mesh); the ms of a body iteration."""
    import torch.distributed as dist
    from tuch_tpu_torch import runtime as rt
    from tuch_tpu_torch.fitting import smplify_dc as PF
    from tuch_tpu_torch.losses import smplify as PL
    from tuch_tpu_torch.parallel import contact_parallel as CPAR
    from tuch_tpu_torch.parallel import mesh as PM
    runtime = rt.build_runtime(device=DEV, synthetic=True,
                               with_contact=True)
    mesh = PM.make_mesh(dp=args['dp'], cp=args['cp'], device=DEV)
    contact = runtime.contact
    verts = PM.shard_rows(posed_verts(runtime.smpl, TRAIN_B, 0.3, 99),
                          mesh).contiguous()
    counters = cp_counters()
    out = dict(dp_rank=mesh.dp_rank, cp_rank=mesh.cp_rank, launches={})
    for route, k in (('exact', 0), ('candidate', CP_K)):
        torch.cuda.synchronize()
        for c in counters.values():
            c.launches = 0
        n0 = dict(CPAR.CP_CALLS)
        ext, arg = PL.contact_neighbors(verts, contact, candidate_k=k,
                                        mesh=mesh)
        torch.cuda.synchronize()
        out['launches'][route] = {n: c.launches for n, c in counters.items()}
        out['launches'][route]['cp_calls'] = sum(
            CPAR.CP_CALLS[n] - n0[n] for n in n0)
        out[route] = (ext.cpu(), arg.cpu())
    # the fit, on the main path's counts
    P = contact.region_idx_a.shape[0]
    ins = _cp_fit_inputs(P, mesh)
    for c in counters.values():
        c.launches = 0
    res = PF.smplify_dc(runtime.smpl, runtime.prior, contact, *ins,
                        config=_cp_fit_config(mesh))
    torch.cuda.synchronize()
    out['fit_launches'] = {n: c.launches for n, c in counters.items()}
    out['fit_vertices'] = res.vertices.cpu()
    # ms per body iteration, the ranks started together
    step = body_stepper((runtime.smpl, runtime.prior, contact),
                        fit_inputs(TRAIN_B // mesh.dp, P, 21, DEV),
                        mesh=mesh)
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(CP_TIMED):
        step()
    torch.cuda.synchronize()
    out['iter_ms'] = 1e3 * (time.perf_counter() - t0) / CP_TIMED
    return out


def job_nccl1(args):
    """NCCL at world size 1: the backend maybe_initialize_distributed
    chose, and one all_reduce."""
    import torch.distributed as dist
    t = torch.ones(4, device=DEV)
    dist.all_reduce(t)
    torch.cuda.synchronize()
    return dict(backend=dist.get_backend(), value=t.cpu())


def job_nccl2(args):
    """NCCL asked for by hand on ranks that share the card: the error."""
    import datetime
    import torch.distributed as dist
    torch.cuda.set_device(0)
    try:
        dist.init_process_group('nccl', timeout=datetime.timedelta(
            seconds=60))
        t = torch.ones(4, device=DEV)
        dist.all_reduce(t)
        torch.cuda.synchronize()
        return dict(ok=True, error='')
    except Exception as e:   # the finding is the error itself
        return dict(ok=False, error=f'{type(e).__name__}: {e}'[:600])


def mesh_train_run(name, backbone, flags, ref_path=None, ref_file=MESH_REF,
                   sync_world=False, also=None):
    """One cli/train run on this process's place in the mesh (or alone):
    build as a user's command does (phase 13's flags, B=64), 2 steps, then
    the time-budget exit; returns the record, the launches of the run, the
    state and the losses (rank 0). ref_path 'save' saves the state to
    ref_file, 'compare' measures the state's distances to ref_file's (and
    to also's, where given); sync_world runs BatchNorm's statistics over
    the world's process group (a group of 1: the mesh's BatchNorm in one
    process)."""
    from tuch_tpu_torch import config as cfgmod
    from tuch_tpu_torch.train import module as TM
    opts = cfgmod.parse_config(cfgmod.TrainConfig, train_argv(
        name, '--backbone', backbone, '--val_and_checkpoint_freq', '0',
        *flags))
    own_sync = TM.sync_batchnorm
    if sync_world:      # the step sets BatchNorm's group at each call
        import torch.distributed as dist
        TM.sync_batchnorm = lambda model, group: own_sync(
            model, dist.group.WORLD)
    try:
        return _mesh_train_run(name, opts, ref_path, ref_file, also)
    finally:            # a pooled worker runs other jobs after this one
        TM.sync_batchnorm = own_sync


def _mesh_train_run(name, opts, ref_path, ref_file, also):
    """mesh_train_run's run, from its parsed options."""
    from tuch_tpu_torch.cli import train as train_cli
    from tuch_tpu_torch.ops import attention as A
    from tuch_tpu_torch.parallel import contact_parallel as CPAR
    tr = train_cli.build(opts)
    counters = dict(cp_counters(), mha=A.mha_cuda)
    rec = instrument(tr, counters, stop_after=MESH_TRAIN_STEPS)
    inner, first = tr.step_fn, {}

    def step(state, batch):        # Adam's first moment after step 1
        out = inner(state, batch)
        first.setdefault('mu1', {k: v.clone()
                                 for k, v in out[0].opt.mu.items()})
        return out
    tr.step_fn = step
    start = {'params': {k: v.detach().clone()
                        for k, v in tr.state.hmr.named_parameters()},
             'fits': {'fits': tr.state.fits.clone()},
             'buffers': {k: v.clone()
                         for k, v in tr.state.hmr.named_buffers()}}
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    n0 = CPAR.CP_CALLS['contact_neighbors_cp']
    tr.fit()
    torch.cuda.synchronize()
    out = dict(step_ms=rec['step_ms'],
               launches={k: c.launches for k, c in counters.items()},
               cp_calls=CPAR.CP_CALLS['contact_neighbors_cp'] - n0,
               rank=0 if tr.mesh is None else tr.mesh.rank,
               cp_rank=0 if tr.mesh is None else tr.mesh.cp_rank)
    s = tr.state
    state = {'params': {k: v.detach() for k, v in s.hmr.named_parameters()},
             'mu': s.opt.mu, 'mu1': first['mu1'], 'fits': {'fits': s.fits},
             'buffers': dict(s.hmr.named_buffers())}
    if tr.is_main:
        out['losses'] = _train_records(tr)[0]
    if ref_path == 'save':
        state.update({'start_' + k: v for k, v in start.items()})
        torch.save({p: {k: v.cpu() for k, v in t.items()}
                    for p, t in state.items()}, ref_file)
    elif ref_path is not None:
        for key, path in (('vs_ref', ref_file), ('vs_also', also)):
            if path is not None:
                out[key] = _mesh_distances(state, torch.load(
                    path, map_location=DEV, weights_only=True),
                    tr.options.lr)
    import hashlib
    h = hashlib.sha256()
    for part in ('params', 'mu', 'fits'):
        for k in sorted(state[part]):
            h.update(state[part][k].detach().cpu().numpy().tobytes())
    out['sha'] = h.hexdigest()
    tr.close()
    return out


def _rel_l2(a, b, keys, base=None):
    num = den = 0.0
    for k in keys:
        w, v = a[k].double(), b[k].double()
        if base is not None:
            w, v = w - base[k].double(), v - base[k].double()
        num += float(((w - v) ** 2).sum())
        den += float((v ** 2).sum())
    return (num / den) ** 0.5 if den > 0 else num ** 0.5


def _mesh_distances(state, ref, lr):
    """A mesh run's state against the one-process run's: relative L2 of
    Adam's first moment and of what the steps changed in the parameters,
    fits and BatchNorm statistics (from the ref's start_* parts); whether
    each part is equal bit for bit; and the worst ratio of an element's
    distance to its element-by-element bar (MESH_GRAD_*), for Adam's
    first moment and the parameters."""
    out = {'mu_elem': 0.0, 'params_elem': 0.0}
    for k in ref['mu']:
        # per step (tests/_torch_train_parity.moment_bars): the gradient
        # g_t = (m_t - 0.9 m_(t-1)) / 0.1, its bar rtol |g| + atol max |g|,
        # the moment's bar carried, m_t's distance within it; the
        # parameter's bar lr min(2, 3 bar / |m_t|) + 2 ulps, summed over
        # the steps (assert_params_close)
        p = ref['params'][k].double()
        m_prev, bar, lim = 0.0, 0.0, 0.0
        for t, (m, got) in enumerate(((ref['mu1'][k], state['mu1'][k]),
                                      (ref['mu'][k], state['mu'][k]))):
            m, got = m.double(), got.double()
            g = ((m - 0.9 * m_prev) / 0.1).abs()
            bar = 0.1 * (MESH_GRAD_RTOL * g + MESH_GRAD_ATOL * float(
                g.max())) + 0.9 * bar
            out['mu_elem'] = max(out['mu_elem'], float(
                ((got - m).abs() / (bar + 1e-30)).max()))
            lim = lim + lr * torch.clamp(
                3 * bar / m.abs().clamp(min=1e-30), max=2.0) \
                + 2.4e-7 * p.abs()
            m_prev = m
        dp = (state['params'][k].detach().double() - p).abs()
        out['params_elem'] = max(out['params_elem'],
                                 float((dp / lim).max()))
    for part in ('params', 'mu', 'fits', 'buffers'):
        keys = sorted(ref[part])
        base = ref.get('start_' + part)
        out[part] = _rel_l2(state[part], ref[part], keys, base)
        out[part + '_bitwise'] = all(torch.equal(state[part][k].detach(),
                                                 ref[part][k])
                                     for k in keys)
    return out


def job_eval(args):
    """Phase 21 on one rank: cli/eval with the job's flags from its own
    directory (rank 0 writes the result file)."""
    from tuch_tpu_torch.cli import eval as eval_cli
    os.chdir(args['cwd'])
    return eval_cli.main(args['argv'])


def job_eft(args):
    """Phase 21 on one rank: cli/fit_eft --auto_shard. Each rank fits its
    shard once to warm up (its dropout stream then set back, so the timed
    fit is the CLI's), then again after a barrier; that window is
    recorded for images a second."""
    import torch.distributed as dist
    from tuch_tpu_torch.cli import fit_eft
    from tuch_tpu_torch.fitting import eft as EF
    window = {}
    fit = EF.EFTFitter.fit

    def timed(self):
        stream = self.generator.get_state()
        fit(self)                  # the warm-up (fit restores the weights)
        self.generator.set_state(stream)
        self.records = []
        torch.cuda.synchronize()
        dist.barrier()
        window['start'] = time.time()
        try:
            return fit(self)
        finally:
            torch.cuda.synchronize()
            window['end'] = time.time()
            window['records'] = self.records
    EF.EFTFitter.fit = timed
    try:
        written = fit_eft.main(args['argv'])
    finally:            # a pooled worker runs other jobs after this one
        EF.EFTFitter.fit = fit
    return dict(written=written, **window)


def bn_control(group):
    """Phase 20's control of ResNet-50's BatchNorm over the dp ranks of
    `group`, run by those ranks after their cli/train run: the backbone's
    train-mode forward and backward at full width on one global batch of
    TRAIN_B images from a seed, the gradients of sum(w * pooled features)
    (a sum over the batch, so the ranks' gradients add), in float64 and in
    float32. Against one process on the whole batch (rank 0 alone): dp
    with the statistics synced over the group, as cli/train runs it; dp
    without the sync, what a missing sync does; and, in float32, one
    process on the batch in reverse row order, what float32 rounding alone
    does (the same function, summed in another order). Returns on rank 0,
    per dtype and run: the relative L2 of the gradients, of Adam's first
    update g / (|g| + eps) and of the running statistics' change, and the
    worst element's ratio to the BN64 bars (gradients and statistics)."""
    import copy
    import torch.distributed as dist
    from tuch_tpu_torch.models.hmr import HMR, sync_batchnorm
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    torch.manual_seed(0)
    base = HMR(np.tile([1.0, 0, 0, 1, 0, 0], 24), np.zeros(10),
               np.array([0.9, 0, 0]), backbone='resnet50').train()
    gen = torch.Generator().manual_seed(5)
    img = torch.randn(TRAIN_B, 224, 224, 3, generator=gen) * 0.5
    w = torch.randn(TRAIN_B, 2048, generator=gen)
    per = TRAIN_B // world
    mine = slice(rank * per, (rank + 1) * per)

    def stats(m):
        return torch.cat([b.reshape(-1) for n, b in m.named_buffers()
                          if 'running' in n])

    def run(start, dtype, rows, sync, reverse=False):
        m = copy.deepcopy(start)
        sync_batchnorm(m, group if sync else None)
        x, ww = img[rows].to(DEV, dtype), w[rows].to(DEV, dtype)
        if reverse:
            x, ww = x.flip(0), ww.flip(0)
        x = m.maxpool(m.relu(m.bn1(m.conv1(x.permute(0, 3, 1, 2)))))
        for i in range(1, 5):
            x = getattr(m, f'layer{i}')(x)
        params = [q for n, q in m.named_parameters()
                  if n.startswith(('conv1', 'bn1', 'layer'))]
        grads = torch.autograd.grad((x.mean((2, 3)) * ww).sum(), params)
        return [g.detach() for g in grads], stats(m)

    out = {}
    for dtype in (torch.float64, torch.float32):
        start = copy.deepcopy(base).to(DEV, dtype)
        s0 = stats(start)
        runs = {}
        if rank == 0:
            runs['one'] = run(start, dtype, slice(None), False)
        for name, sync in (('dp', True), ('no_sync', False)):
            grads, st = run(start, dtype, mine, sync)
            flat = torch.cat([g.reshape(-1) for g in grads])
            dist.all_reduce(flat, group=group)
            runs[name] = (list(flat.split([g.numel() for g in grads])), st)
        if rank != 0:
            continue
        if dtype == torch.float32:
            runs['reversed'] = run(start, dtype, slice(None), False, True)
        g1, st1 = runs.pop('one')
        flat1 = torch.cat([g.reshape(-1) for g in g1]).double()
        u1 = flat1 / (flat1.abs() + 1e-8)
        for name, (g, st) in runs.items():
            flat = torch.cat([t.reshape(-1) for t in g]).double()
            elem = max(float(((a.reshape(-1) - b.reshape(-1)).abs() / (
                BN64_RTOL * b.abs().reshape(-1) + BN64_ATOL
                * b.abs().max())).max()) for a, b in zip(g, g1))
            elem = max(elem, float(((st - st1).abs() / (
                BN64_RTOL * st1.abs() + BN64_ATOL * st1.abs().max())).max()))
            out[(str(dtype).split('.')[-1], name)] = dict(
                grads=_rel_l2({0: flat}, {0: flat1}, [0]),
                update=_rel_l2({0: flat / (flat.abs() + 1e-8)}, {0: u1}, [0]),
                stats=_rel_l2({0: st}, {0: st1}, [0], {0: s0}), elem=elem)
        del start, runs
        torch.cuda.empty_cache()
    return out


def job_train(args):
    """Phase 20 on one rank, against the one-process run's saved state;
    then, where asked, bn_control over the world's ranks."""
    import torch.distributed as dist
    out = mesh_train_run(args['name'], args['backbone'], args['flags'],
                         args.get('ref'), args.get('ref_file', MESH_REF),
                         args.get('sync_world', False), args.get('also'))
    if args.get('bn_control'):
        t0 = time.perf_counter()
        out['bn_control'] = bn_control(dist.group.WORLD)
        out['bn_control_s'] = time.perf_counter() - t0
    return out


RANK_JOBS = dict(
    contact=job_contact, nccl1=job_nccl1, nccl2=job_nccl2, eval=job_eval,
    eft=job_eft, train=job_train)


def _global_rows(outs, key):
    """A per-rank output as the global batch: cp rank 0's rows of each dp
    row in dp order."""
    mine = sorted((o for o in outs if o['cp_rank'] == 0),
                  key=lambda o: o['dp_rank'])
    return torch.cat([o[key] for o in mine])


def _hold_masked_min_range(runtime, verts, results):
    """Kernel 4's range entry on the posed B=64 body over the cuts of cp 2
    and 4: each range against its plain version (d2 rtol D2_RTOL, another
    argmin only at a tie), the MIN of the ranges equal to the whole-axis
    kernel bit for bit; then its time on the first cp=2 range beside the
    plain version's and its bound."""
    from tuch_tpu_torch.ops import contact_kernels as CK
    from tuch_tpu_torch.parallel.contact_parallel import shard_range
    mask, bits = runtime.contact.geomask, runtime.contact.geomask_bits
    B, V, _ = verts.shape
    whole = CK.masked_min_dist_cuda(verts, mask, bits)
    err = 0.0
    for cp in (2, 4):
        keys = []
        for r in range(cp):
            lo, hi = shard_range(V, cp, r)
            got = CK.masked_min_keys_cuda(verts, mask, bits, lo, hi)
            want = torch.cat(_chunked(lambda v: CK.masked_min_keys_ref(
                v, mask, lo, hi), verts))
            gd, ga = CK.decode_keys(got)
            wd, wa = CK.decode_keys(want)
            fin = torch.isfinite(wd)
            check(torch.equal(fin, torch.isfinite(gd)),
                  f'masked_min_range [{lo}, {hi}): inf rows differ')
            e = (gd - wd)[fin].abs().max().item() if fin.any() else 0.0
            rel = ((gd - wd).abs()[fin] <= D2_RTOL * wd[fin]).all().item()
            diff = verts - torch.gather(verts, 1, ga.long()[..., None]
                                        .expand(-1, -1, 3))
            pick = (diff * diff).sum(-1)
            differ = (ga != wa) & fin
            ties = ((pick - wd).abs()[differ]
                    <= D2_RTOL * wd[differ]).all().item()
            check(rel and ties, f'masked_min_range [{lo}, {hi}): rel {rel}, '
                  f'ties {ties}')
            err = max(err, e)
            keys.append(got)
        d2, arg = CK.decode_keys(torch.stack(keys).amin(0))
        same = torch.equal(d2, whole[0]) and torch.equal(arg, whole[1])
        print(f'[kernel] masked_min_range posed B={B} over the cuts of cp='
              f'{cp}: d2 max_abs_err {err:.3g} against the plain keys (rtol '
              f'{D2_RTOL}, argmin ties), MIN of the ranges equal to the '
              f'whole-axis kernel bit for bit {same}', flush=True)
        check(same, f'masked_min_range cp={cp}: MIN of ranges != kernel 4')
    lo, hi = shard_range(V, 2, 0)
    ms = graph_ms(lambda: CK.masked_min_keys_cuda(verts, mask, bits, lo, hi),
                  iters=10)
    plain_ms = cuda_ms(lambda: _chunked(lambda v: CK.masked_min_keys_ref(
        v, mask, lo, hi), verts), iters=2, warmup=1)
    allowed = int(mask[:, lo:hi].sum().item())
    bound_ms, bound_by = bound(
        B * (V * (hi - lo) + MASKED_OPS_ALLOWED * allowed),
        V * (hi - lo) + 12 * B * V + 8 * B * V)
    print(f'[kernel] masked_min_range B={B} V={V} range [{lo}, {hi}): '
          f'kernel {ms:.4f} ms (CUDA-graph replay, device time), plain '
          f'{plain_ms:.4f} ms, no one-call library equivalent, bound '
          f'{bound_ms:.4f} ms ({bound_by}), {bound_ms / ms:.1%} of bound',
          flush=True)
    results['masked_min_range'] = dict(ms=ms, plain_ms=plain_ms,
                                       library_ms=None, bound_ms=bound_ms,
                                       bound_by=bound_by, max_abs_err=err)


def phase_cp_contact(runtime, card, results, launches):
    """Phase 19: contact on cp meshes of ranks sharing the card."""
    from tuch_tpu_torch.fitting import smplify_dc as PF
    from tuch_tpu_torch.losses import smplify as PL
    from tuch_tpu_torch.ops import contact_kernels as CK
    contact = runtime.contact
    verts = posed_verts(runtime.smpl, TRAIN_B, 0.3, 99)
    _hold_masked_min_range(runtime, verts, results)
    wn = CK.winding_numbers_faces(verts, verts, contact.faces).cpu()
    band = (wn - 0.99).abs() < WN_BAND
    single = {'exact': PL.contact_neighbors(verts, contact),
              'candidate': PL.contact_neighbors(verts, contact,
                                                candidate_k=CP_K)}
    single = {k: (e.cpu(), a.cpu()) for k, (e, a) in single.items()}
    P = contact.region_idx_a.shape[0]
    fit = PF.smplify_dc(runtime.smpl, runtime.prior, contact,
                        *_cp_fit_inputs(P), config=_cp_fit_config(None))
    fit_verts = fit.vertices.cpu()
    step = body_stepper((runtime.smpl, runtime.prior, contact),
                        fit_inputs(TRAIN_B, P, 21, DEV))
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(CP_TIMED):
        step()
    torch.cuda.synchronize()
    iter_ms = {(1, 1): 1e3 * (time.perf_counter() - t0) / CP_TIMED}
    segs = 1 if contact.segment_tables is not None else 0
    range_launches = 0
    for dp, cp in CP_MESHES:
        outs = run_ranks('contact', dp * cp, dict(dp=dp, cp=cp))
        for route in ('exact', 'candidate'):
            ext = _global_rows([dict(o, r=o[route][0]) for o in outs], 'r')
            arg = _global_rows([dict(o, r=o[route][1]) for o in outs], 'r')
            want_e, want_a = single[route]
            flips = ((ext != want_e) & ~band).sum().item()
            in_band = ((ext != want_e) & band).sum().item()
            differ = (arg != want_a)
            pick_ok = True
            if differ.any():
                v = verts.cpu()
                dg = v - torch.gather(v, 1, arg.long()[..., None].expand(
                    -1, -1, 3))
                dw = v - torch.gather(v, 1, want_a.long()[..., None].expand(
                    -1, -1, 3))
                pg, pw = (dg * dg).sum(-1), (dw * dw).sum(-1)
                pick_ok = bool(((pg - pw).abs()[differ]
                                <= D2_RTOL * pw[differ]).all())
            # per rank: kernel 2 once on its triangle shard (once more for
            # the segments' own test), the range entry once, kernel 4's
            # whole-axis entry never
            want_l = {'winding': 1 + segs, 'masked_min_range': 1,
                      'masked_min': 0}
            if route == 'candidate':
                want_l['gather'] = 1
            got_l = [{k: o['launches'][route][k] for k in want_l}
                     for o in outs]
            print(f'[cp] dp={dp} cp={cp} contact_neighbors {route}: in/out '
                  f'flips outside the band |wn - 0.99| < {WN_BAND} {flips}, '
                  f'inside {in_band}; argmin differs at '
                  f'{differ.sum().item()} (ties within rtol {D2_RTOL} '
                  f'{pick_ok}); launches per rank {got_l[0]} (every rank '
                  f'the same {all(g == got_l[0] for g in got_l)}), '
                  f'cp calls {outs[0]["launches"][route]["cp_calls"]}',
                  flush=True)
            check(flips == 0 and pick_ok, f'cp {dp}x{cp} {route}: flips '
                  f'{flips}, argmin beyond a tie')
            check(all(g == want_l for g in got_l),
                  f'cp {dp}x{cp} {route}: launches {got_l} != {want_l}')
            check(all(o['launches'][route]['cp_calls'] >= 1 for o in outs),
                  f'cp {dp}x{cp} {route}: no contact_parallel call')
        fv = _global_rows(outs, 'fit_vertices')
        verr = (fv - fit_verts).abs().max().item()
        fl = outs[0]['fit_launches']
        range_launches += sum(o['fit_launches']['masked_min_range']
                              for o in outs)
        iter_ms[(dp, cp)] = max(o['iter_ms'] for o in outs)
        print(f'[cp] dp={dp} cp={cp} SMPLify-DC {CP_FIT_ITERS}+'
              f'{CP_FIT_ITERS} iterations at B={TRAIN_B} with '
              f'SMPLifyConfig(mesh): vertices against one process max abs '
              f'{verr:.3g} m (bar {VERTEX_TOL}), bit for bit '
              f'{bool(verr == 0)}; rank 0 launches {fl}', flush=True)
        check(verr <= VERTEX_TOL, f'cp {dp}x{cp} fit vertices {verr}')
        check(fl['masked_min_range'] == CP_FIT_ITERS
              and fl['masked_min'] == 0,
              f'cp {dp}x{cp} fit: range entry {fl}')
    launches['masked_min_range'] = range_launches
    times = ', '.join(f'dp={d} cp={c} {ms:.3f}' for (d, c), ms in
                      iter_ms.items())
    print(f'[times cp] ms per body iteration at B={TRAIN_B} (refresh, loss '
          f'and gradient, Adam; host clock, mean of {CP_TIMED}, slowest '
          f'rank; the ranks share the card over gloo): {times}; card: '
          f'{card}', flush=True)
    # NCCL: one rank on the card, then two ranks asked to share it
    t0 = time.perf_counter()
    one, = run_ranks('nccl1', 1, {})
    check(one['backend'] == 'nccl' and bool((one['value'] == 1).all()),
          f'nccl at world size 1: {one}')
    print(f'[nccl] world size 1: backend {one["backend"]}, all_reduce ok '
          f'({time.perf_counter() - t0:.1f} s with the process start)',
          flush=True)
    codes, failed, res, texts = run_ranks('nccl2', 2, {}, timeout=120,
                                          expect_fail=True)
    found = [None if o is None else (o['ok'], o['error']) for o in res]
    tails = [t.strip().splitlines()[-1:] for t in texts]
    print(f'[nccl] two ranks on one card with NCCL: exit codes {codes} '
          f'({failed or "ended"}); per rank (all_reduce ok, error) {found}; '
          f'last log lines {tails}', flush=True)


def hold_bn_control(c, seconds, card):
    """bn_control's readings (rank 0), printed and held: dp in float64
    equal to one process at the BN64 bars, element by element, and the
    same bars failed by dp without the sync, so that they would see one;
    in float32, dp within BN32_FACTOR of what a reversed batch order does
    (plus MESH_GRAD_RTOL)."""
    for (dt, run), d in sorted(c.items()):
        print(f'[mesh train] BatchNorm control, ResNet-50 backbone B='
              f'{TRAIN_B} at 224 px, {dt}, {run} against one process: '
              f'relative L2 of the gradients {d["grads"]:.3g}, of Adam\'s '
              f'first update {d["update"]:.3g}, of the running statistics\' '
              f'change {d["stats"]:.3g}; worst element to the bars (rtol '
              f'{BN64_RTOL}, atol {BN64_ATOL} of each tensor\'s largest) '
              f'{d["elem"]:.3g}', flush=True)
    print(f'[mesh train] BatchNorm control in {seconds:.1f} s; card: {card}',
          flush=True)
    check(c[('float64', 'dp')]['elem'] <= 1,
          f'BatchNorm over dp in float64: {c[("float64", "dp")]}')
    check(c[('float64', 'no_sync')]['elem'] > 1,
          'BatchNorm control: dp without the sync passes the float64 bars')
    dp, rev = c[('float32', 'dp')], c[('float32', 'reversed')]
    check(all(dp[k] <= BN32_FACTOR * rev[k] + MESH_GRAD_RTOL
              for k in ('grads', 'update')),
          f'BatchNorm over dp in float32: {dp} against reversed {rev}')


def phase_mesh_train(card):
    """Phase 20: cli/train --run_smplify on 2-rank meshes, against one
    process: ResNet-50 with --mesh_cp 2 (against one process as a user
    runs it) and with --mesh_dp 2 (against one process on the mesh's
    BatchNorm, a group of 1, and the ranks then run bn_control), ViT-S/16
    with --mesh_dp 2."""
    for backbone, meshes in (
            ('resnet50', (['--mesh_dp', '1', '--mesh_cp', '2'],
                          ['--mesh_dp', '2'])),
            ('vit_s16', (['--mesh_dp', '2'],))):
        one = mesh_train_run(f'par_one_{backbone}', backbone, [],
                             ref_path='save')
        print(f'[mesh train] one process, {backbone} B={TRAIN_B}: ms per '
              f'step {np.round(one["step_ms"], 1).tolist()}; launches '
              f'{one["launches"]}', flush=True)
        for flags in meshes:
            tag = f'{backbone} ' + ' '.join(flags)
            dp_bn = backbone == 'resnet50' and '--mesh_cp' not in flags
            ref = dict(ref='compare')
            if dp_bn:
                one, = run_ranks('train', 1, dict(
                    name=f'par_one_sync_{backbone}', backbone=backbone,
                    flags=[], ref='save', ref_file=MESH_REF_SYNC,
                    sync_world=True))
                print(f'[mesh train] one process on the mesh\'s BatchNorm '
                      f'(a group of 1), {backbone} B={TRAIN_B}: ms per step '
                      f'{np.round(one["step_ms"], 1).tolist()}', flush=True)
                ref.update(ref_file=MESH_REF_SYNC, also=MESH_REF)
            outs = run_ranks('train', 2, dict(
                name='par_' + tag.replace(' ', ''), backbone=backbone,
                flags=flags, bn_control=dp_bn, **ref))
            main = outs[0]
            if dp_bn:
                hold_bn_control(main['bn_control'], main['bn_control_s'],
                                card)
            d = main['vs_ref']
            gaps = {s: abs(main['losses'][s]['train/loss']
                           - one['losses'][s]['train/loss'])
                    / abs(one['losses'][s]['train/loss'])
                    for s in sorted(one['losses'])}
            cp_equal = all(o['sha'] == outs[o['rank'] - o['cp_rank']]['sha']
                           for o in outs)
            print(f'[mesh train] {tag}, 2 ranks on the card: ms per step '
                  f'(rank 0) {np.round(main["step_ms"], 1).tolist()}; '
                  f'relative L2 to one process: mu {d["mu"]:.3g} (bar '
                  f'{MESH_GAP["mu"]}), parameter updates '
                  f'{d["params"]:.3g} (bar {MESH_GAP["params"]}), '
                  f'fits updates {d["fits"]:.3g} (bar {MESH_GAP["fits"]}), '
                  f'BatchNorm statistics\' change {d["buffers"]:.3g} (bar '
                  f'{MESH_GAP["buffers"]}); element by element, worst ratio '
                  f'to the bar: mu {d["mu_elem"]:.3g}, parameters '
                  f'{d["params_elem"]:.3g}; bit for bit: params '
                  f'{d["params_bitwise"]}, fits {d["fits_bitwise"]}; loss '
                  f'gap per step { {s: f"{g:.3g}" for s, g in gaps.items()} } '
                  f'(bar {TRAIN_LOSS_RTOL}); cp peers bit for bit '
                  f'{cp_equal}; contact_neighbors_cp calls '
                  f'{main["cp_calls"]}; launches {main["launches"]}; card: '
                  f'{card}', flush=True)
            if dp_bn:
                a = main['vs_also']
                print(f'[mesh train] {tag} against one process on its own '
                      f'BatchNorm kernel (float32 rounding amplified, not '
                      f'held): relative L2 mu {a["mu"]:.3g}, parameter '
                      f'updates {a["params"]:.3g}, fits updates '
                      f'{a["fits"]:.3g}, BatchNorm statistics\' change '
                      f'{a["buffers"]:.3g}', flush=True)
            for part in MESH_GAP:
                check(d[part] <= MESH_GAP[part],
                      f'mesh train {tag}: {part} {d[part]}')
            if not dp_bn:
                check(d['mu_elem'] <= 1 and d['params_elem'] <= 1,
                      f'mesh train {tag}: element by element {d}')
            if backbone == 'vit_s16':
                check(main['launches']['mha'] > 0, f'{tag}: no mha launch')
            check(all(g <= TRAIN_LOSS_RTOL for g in gaps.values()),
                  f'mesh train {tag}: loss gaps {gaps}')
            check(cp_equal, f'mesh train {tag}: cp peers differ')
            if '--mesh_cp' in flags:
                check(main['cp_calls'] > 0, f'{tag}: no cp call')
        for path in (MESH_REF, MESH_REF_SYNC):
            if os.path.exists(path):
                os.remove(path)
    shutil.rmtree(TRAIN_LOG_DIR, ignore_errors=True)


def phase_mesh_eval_eft(card):
    """Phase 21: cli/eval --mesh_dp 2, and cli/fit_eft --auto_shard on 1,
    2 and 4 processes sharing the card."""
    from tuch_tpu_torch.cli import eval as eval_cli
    from tuch_tpu_torch.cli import fit_eft
    argv = ['--synthetic', '--synthetic_samples', str(MESH_EVAL_N),
            '--batch_size', str(TRAIN_B), '--num_workers', '8',
            '--log_freq', '1000', '--result_file', 'mesh_eval.npz',
            '--device', DEV]
    cwd = os.getcwd()
    dirs = {k: os.path.abspath(os.path.join(PAR_DIR, f'eval_{k}'))
            for k in ('one', 'mesh')}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    os.chdir(dirs['one'])
    try:
        t0 = time.perf_counter()
        eval_cli.main(argv)
        one_s = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    t0 = time.perf_counter()
    run_ranks('eval', 2, dict(cwd=dirs['mesh'], argv=argv + ['--mesh_dp',
                                                             '2']))
    mesh_s = time.perf_counter() - t0
    a = np.load(os.path.join(dirs['one'], 'out', 'mesh_eval.npz'))
    b = np.load(os.path.join(dirs['mesh'], 'out', 'mesh_eval.npz'))
    err = {k: float(np.max(np.abs(b[k] - a[k]) / np.maximum(np.abs(a[k]),
                                                            1e-30)))
           for k in ('mpjpe', 'recon_err')}
    print(f'[mesh eval] cli/eval --mesh_dp 2 ({MESH_EVAL_N} samples, '
          f'batches of {TRAIN_B} and a ragged {MESH_EVAL_N % TRAIN_B}): '
          f'per-image relative difference to one process {err} (rtol 1e-4); '
          f'one process {one_s:.1f} s, 2 ranks {mesh_s:.1f} s with their '
          f'start (host clock); card: {card}', flush=True)
    check(all(e <= 1e-4 for e in err.values()) and a['mpjpe'].shape
          == (MESH_EVAL_N,), f'mesh eval: {err}')

    # EFT: each rank count's merged shards against one process fitting
    # the same shards (--sidx/--cbs) on this card
    import tempfile
    from tuch_tpu_torch import runtime as rt
    from tuch_tpu_torch.data.dataset import (TuchDataset, load_db,
                                             synthetic_db)
    from tuch_tpu_torch.fitting.eft import EFTFitter, merge_shards
    base = ['--synthetic', '--max_steps', str(MESH_EFT_STEPS), '--device',
            DEV]
    runtime = rt.build_runtime(device=DEV, synthetic=True, with_contact=True)
    P = len(runtime.contact_classes)
    rates = {}
    for world in (1, 2, 4):
        out_dir = os.path.abspath(os.path.join(PAR_DIR, f'eft_{world}'))
        outs = run_ranks('eft', world, dict(argv=base + [
            '--auto_shard', '--out_dir', out_dir]))
        shards = [w for o in outs for w in o['written']]
        merged = fit_eft.main(base + ['--out_dir', out_dir, '--merge',
                                      *shards])[0]
        n = sum(len(o['records']) for o in outs)
        start = min(o['start'] for o in outs)
        rates[world] = n / (max(o['end'] for o in outs) - start)
        # one process, the same shards in turn
        cbs = -(-4 // world)
        ref_dir = out_dir + '_ref'
        with tempfile.TemporaryDirectory() as d:
            ns = fit_eft.parse_args(base + ['--out_dir', ref_dir])
            db = synthetic_db(4, img_dir=d, seed=ns.seed,
                              num_contact_classes=P)
            ds = TuchDataset(ns, 'dsc_df', data=db, img_dir=d,
                             use_augmentation=False, num_contact_classes=P)
            ref_shards = []
            for r in range(world):
                ns.sidx, ns.cbs = r, cbs
                ref_shards.append(EFTFitter(
                    ns, 'dsc_df', ds, runtime.hmr, runtime.smpl,
                    runtime.contact, out_dir=ref_dir).fit())
            ref = merge_shards(ref_shards, ds.data,
                               os.path.join(ref_dir, 'merged.pt'))
        got, want = load_db(merged), load_db(ref)
        same = all(np.array_equal(got[k], want[k]) for k in ('pose',
                                                             'betas'))
        gap = max(float(np.abs(got[k] - want[k]).max()) for k in ('pose',
                                                                 'betas'))
        steps = [r[1] for o in outs for r in o['records']]
        print(f'[mesh eft] cli/fit_eft --auto_shard on {world} process(es) '
              f'sharing the card: {n} images in {1 / rates[world] * n:.2f} s, '
              f'{rates[world]:.3f} images/s (host clock from the ranks\' '
              f'common start, each warmed by one fit of its shard), steps '
              f'{steps}; merged fits equal one process fitting the same '
              f'shards in turn bit for bit {same} (max abs {gap:.3g})',
              flush=True)
        check(same, f'mesh eft {world}: merged fits differ by {gap}')
    print(f'[times mesh eft] images/s by processes sharing the card '
          f'{ {w: round(r, 3) for w, r in rates.items()} }; card: {card}',
          flush=True)


def parallel_phases(card, results=None, launches=None):
    """Phases 19-21 (the build first, once, before any rank starts), their
    groups of ranks on one RankPool."""
    from tuch_tpu_torch import runtime as rt
    t0 = time.perf_counter()
    os.makedirs(PAR_DIR, exist_ok=True)
    POOL.append(RankPool(POOL_SIZE))     # warms up while phase 19 starts
    try:
        fit_rt = rt.build_runtime(device=DEV, synthetic=True,
                                  with_contact=True)
        phase_cp_contact(fit_rt, card, {} if results is None else results,
                         {} if launches is None else launches)
        del fit_rt
        torch.cuda.empty_cache()
        clock('20')
        phase_mesh_train(card)
        clock('21')
        phase_mesh_eval_eft(card)
    finally:
        while POOL:
            POOL.pop().close()
    shutil.rmtree(PAR_DIR, ignore_errors=True)
    print(f'[parallel] phases 19-21 in {time.perf_counter() - t0:.1f} s',
          flush=True)


def offline_phases(card):
    """Phases 1, 7 (kernels 5 and 6 among them), 17 and 18 alone, with
    their checks; no result lines."""
    from tuch_tpu_torch import runtime as rt
    t0 = time.perf_counter()
    phase_build()
    torch.backends.cudnn.allow_tf32 = False
    fit_rt = rt.build_runtime(device=DEV, synthetic=True, with_contact=True)
    phase_slice_kernels(fit_rt, {})
    torch.backends.cudnn.allow_tf32 = True
    del fit_rt
    phase_smplx_to_smpl(card)
    phase_real_format(card)
    print(f'chip_smoke --offline: every check passed in '
          f'{time.perf_counter() - t0:.1f} s', flush=True)
    return 0


def trainer_phases(card):
    """Phases 1, 6b, 12's ResNet-50 times, 13 and 14 alone, with their
    checks; no result lines."""
    from tuch_tpu_torch import runtime as rt
    t0 = time.perf_counter()
    phase_build()
    fit_rt = rt.build_runtime(device=DEV, synthetic=True,
                              with_contact=True, with_hd=True)
    phase_hmr_options(card)
    bare = phase_train_times(fit_rt, 'resnet50', card,
                             {'winding': {'max_abs_err': 0.0}})
    checkpoint = phase_train_loop(fit_rt, card, bare)
    phase_eval(checkpoint, card)
    shutil.rmtree(TRAIN_LOG_DIR, ignore_errors=True)
    print(f'chip_smoke --trainer: every check passed in '
          f'{time.perf_counter() - t0:.1f} s', flush=True)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description='Chip smoke of tuch_tpu_torch '
                                'on one CUDA card (see the module doc).')
    p.add_argument('--trainer', action='store_true',
                   help='phases 1, 6b, 12 (ResNet-50 times), 13 and 14 '
                        'alone, with no result lines')
    p.add_argument('--offline', action='store_true',
                   help='phases 1, 7, 17 and 18 alone, with no result '
                        'lines')
    p.add_argument('--parallel', action='store_true',
                   help='phases 1 and 19-21 (the device mesh) alone, with '
                        'no result lines')
    p.add_argument('--kernels', action='store_true',
                   help='phases 1 and 2 (kernel 1) alone; prints kernel '
                        "1's rows of the kernel summary")
    p.add_argument('--rank_job', help=argparse.SUPPRESS)
    p.add_argument('--rank_worker', type=int, help=argparse.SUPPRESS)
    p.add_argument('--job_dir', help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; nothing was run', file=sys.stderr)
        return 1
    import tuch_tpu_torch  # noqa: F401  (fails outside the repository)
    if args.rank_job:              # one rank of phases 19-21 (run_ranks)
        return rank_job(args.rank_job, args.job_dir)
    if args.rank_worker is not None:   # a RankPool worker
        return rank_worker(args.rank_worker, args.job_dir)
    card = card_line()
    kinds = torch.cuda.get_device_name(0)
    print(f'[device] {kinds}; torch {torch.__version__}, CUDA '
          f'{torch.version.cuda}', flush=True)
    if args.trainer:
        return trainer_phases(card)
    if args.offline:
        return offline_phases(card)
    if args.parallel:
        t0 = time.perf_counter()
        phase_build()
        parallel_phases(card)
        print(f'chip_smoke --parallel: every check passed in '
              f'{time.perf_counter() - t0:.1f} s', flush=True)
        return 0
    if args.kernels:             # against plain versions in full fp32
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        kernels = {}
        phase_build()
        phase_kernels(kernels)
        phase_adam(kernels)
        print(card, flush=True)
        print(json.dumps(kernel_summary(mha_rows(kernels, {})
                                        + adam_rows(kernels, {}))),
              flush=True)
        return 0
    # Comparisons against plain versions and the CPU are made in full fp32:
    # cuDNN convolutions default to TF32 on this card, matmuls do not; both
    # are pinned off for phases 2-5, 7-9 and 12's parity and restored to
    # the defaults for the times of phases 6, 10 and 12 (phase 11 runs
    # neither).
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    kernels, launches = {}, {}
    phase_build()
    clock('2')
    phase_kernels(kernels)
    phase_adam(kernels)
    predictors = {f'{bb} {dt}': phase_serve(bb, dt, launches)
                  for bb in ('vit_s16', 'resnet50')
                  for dt in ('float32', 'bfloat16')}
    for bb in ('vit_s16', 'resnet50'):
        phase_parity(bb, predictors[f'{bb} float32'],
                     predictors[f'{bb} bfloat16'])

    from tuch_tpu_torch import runtime as rt
    t0 = time.perf_counter()
    fit_rt = rt.build_runtime(device=DEV, synthetic=True,
                              with_contact=True, with_hd=True)
    print(f'[fit] runtime with contact assets built in '
          f'{time.perf_counter() - t0:.1f} s (geodesic mask '
          f'{tuple(fit_rt.contact.geomask.shape)} uint8, '
          f'{len(fit_rt.contact_classes)} region pairs, '
          f'{len(fit_rt.contact.segment_tables.names)} segments)', flush=True)
    clock('7')
    phase_slice_kernels(fit_rt, kernels)
    demo_out = phase_fit(fit_rt, launches)
    phase_fit_parity(fit_rt)

    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 \
        = tf32
    clock('6')
    for tag, pred in predictors.items():
        phase_times(tag, pred, card)
    phase_hmr_options(card)
    phase_fit_times(fit_rt, card, demo_out)
    clock('11')
    phase_routes(fit_rt, kernels, launches)

    # phase 12 last, so its CPU steps run after every earlier time
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    clock('12')
    for bb in ('resnet50', 'vit_s16'):
        phase_train_parity(fit_rt, bb)
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 \
        = tf32
    bare_ms = {bb: phase_train_times(fit_rt, bb, card, kernels)
               for bb in ('resnet50', 'vit_s16')}
    # phases 13 and 14: the trainer and eval entry points
    clock('13')
    checkpoint = phase_train_loop(fit_rt, card, bare_ms['resnet50'])
    phase_eval(checkpoint, card)
    shutil.rmtree(TRAIN_LOG_DIR, ignore_errors=True)
    # phases 15 and 16: EFT, and the demo with its renders
    clock('15')
    phase_eft(fit_rt, card, launches)
    phase_demo(card)
    # phases 17 and 18: the offline tools, and the port's own databases on
    # the real-format path
    del fit_rt
    clock('17')
    phase_smplx_to_smpl(card)
    phase_real_format(card)
    # phases 19-21: the device mesh, ranks sharing the card
    clock('19')
    parallel_phases(card, kernels, launches)

    # kernel 1 in both types: fp32 serves by default, bf16 with --dtype
    rows = mha_rows(kernels, launches) + adam_rows(kernels, launches)
    for name, src, rep in (
            ('winding', 'winding.cu', 'contact_pallas.py:85'),
            ('masked_min', 'masked_min.cu', 'contact_pallas.py:404'),
            ('masked_min_range', 'masked_min.cu', 'contact_pallas.py:404'),
            ('gather', 'gather.cu', 'gather_pallas.py:61'),
            ('scatter_add', 'gather.cu', 'gather_pallas.py:84'),
            ('winding_affine', 'winding_affine.cu', 'contact_pallas.py:205'),
            ('winding_near', 'winding_near.cu', 'winding_hier.py:121')):
        rows.append(dict(name=name, source=f'tuch_tpu_torch/csrc/{src}',
                         replaces=f'tuch_tpu/ops/{rep}',
                         launches=launches[name], **kernels[name]))
    print(card, flush=True)
    print(json.dumps(kernel_summary(rows)), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kinds,
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
