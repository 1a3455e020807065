#!/usr/bin/env python3
"""Drive the PyTorch port (diffse_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass:

1. Print the card's name and power limit, then build the CUDA kernels from
   ``diffse_tpu_torch/csrc`` (nvcc, sm_90a) and print the build time.
2. Hold each GroupNorm kernel to its plain PyTorch version on the card (TF32
   off for cuDNN and matmul) at the main path's shapes, those at B=1 and
   the serving chunk program's at B=16 (``BATCH16_K1_SHAPES``, whose launch
   plans follow the batch); print errors, median
   times over CUDA events, the bound and, where one PyTorch call computes
   the same function, that call's time. For the conv, print its launch plan
   (``conv_plan``) and both bounds: float32 on the CUDA cores and 3xTF32 on
   the tensor cores, which the kernel uses and is held to. The statistics
   pass is timed alone too, beside ``torch.var_mean`` over the grouped view.
2b. The same for the fused bias + LeakyReLU kernel at [1,256,64,128],
   [16,512] and [3,7,5,6] (C=6: the scalar path) in float32 (atol = rtol =
   1e-6) and [1,256,64,128] in bfloat16 (within 1 bfloat16 ulp of the plain
   version's float32 maths rounded to bfloat16). No path of the model runs
   this kernel.
3. Forwards of the 65M NCSN++ at F=256 and T = 64, 128 and 192 (T=128 and
   T=192 are the widths ``enhance`` pads phase 4's utterances to, so every
   map size of the main path is held) with every weight redrawn from a
   seeded generator at a non-zero scale: the kernel path on the card against
   the plain path on the CPU, and the kernels' launch counts (81
   gn_silu_conv3x3, 28 groupnorm_silu per forward).
4. The main path: ``ScoreModel.enhance`` through ``bbed_pc`` (30 PC steps,
   60 forwards) on 3 synthetic utterances with the default initialisation,
   each as its captured program (one per width bucket: an eager warm-up run
   and the capture on the bucket's first call, a replay after), plus one
   ``sebridge_v2`` call with redrawn weights (eager: its noise comes from a
   callable), with the launch counts reset before and read after: 81 x 60 /
   28 x 60 per program, recorded at its capture (a replay does not pass
   through the wrappers), and the wrappers' counts over the path (each
   program's warm-up and capture, and the eager forward); from these, the
   kernel runs on the card (``card_runs``: a capture runs nothing, a replay
   runs what its capture recorded). Outputs must be
   finite and of the input's length; the ``sebridge_v2`` waveform must match
   the same call on the CPU.
5. The SNR path, the paper's single-NFE mode: ``sebridge_v3_snr`` on the 65M
   ``ncsnpp`` (redrawn weights, fixed_snr 0.17783) with a redrawn SNRNet, on
   phase 4's utterances. SNRNet's output on the card against the CPU (1e-5
   relative), the snapped t_hat equal on both (and not within float error of
   a snap boundary), the waveforms against the CPU given the same noise, and
   81/28 launches per forward, one forward per utterance. Then one
   ``sebridge_v2_snr`` call on the 65M ``ncsnpp_snr``, checked the same way.
   Each path's launch counts are reset before it and read after it.
5b. The captured programs (``capture.Program`` under
   ``ScoreModel._enhance_graph``) against the eager path on the same
   generator state, in float32: ``bbed_pc`` on phase 4's utterances and
   ``sebridge_v3_snr`` on phase 5's (redrawn weights), each waveform within
   ``GRAPH_TOL`` of max|eager| and whether they are bitwise equal, the wall
   per utterance graphed (a replay) and eager beside phase 4's and the 1-NFE
   walls of earlier runs, each bucket's first call (warm-up, capture, replay)
   and the card memory its program keeps; then ``torch.cuda.set_sync_debug_mode("error")``
   through the eager ``bbed_pc`` program and through a replay (the copy of
   the result to the host is outside), and the synchronising operations of
   a whole ``enhance`` counted in "warn" mode (the final copy is the one).
   Each model's kernel runs on the card over the phase.
5c. The samplers beside the main path's ("samplers"), on the 65M NCSN++
   with redrawn weights: the certified serving sampler ``rd_ald_logit_N20``
   (reverse_diffusion + ald, logit grid, N = 20, 40 forwards) at 128 and
   192 frames with the float32 and the bf16 trunk, each replay against the
   eager path on the same generator state (``GRAPH_TOL``, bitwise printed),
   its first call's time and the card memory it keeps; each predictor, the
   langevin corrector, each grid and the OUVE and PROPOSED_1 SDEs
   (``SAMPLER_CASES``, N = 2) on the card against the CPU with the same
   draws (``SAMPLER_TOL``); heun and the exponential predictors under
   ``set_sync_debug_mode("error")``; then ``bbed_ode`` (RK45, rtol = atol
   = 1e-5) through its three captured programs (``capture.LoopProgram``)
   against the eager path, with 1 and 4 step attempts between two host
   reads of its done flag, its nfev, attempts, status, host reads and
   synchronisations, and on the card against the CPU: the same flags (an
   accept/reject flip is reported as one) and the waveform within
   ``ODE_WAVEFORM_TOL``. Each part's kernel runs on the card.
6. The bf16 kernels (the trunk of ``NCSNpp(dtype="bf16")``): each against its
   plain version on the card at phase 2's shapes, bench.py's batch of 16 at
   64 frames among them (GroupNorm bf16 -> bf16 and bf16 -> float32; the
   statistics pass), within one bfloat16 ulp but on at most ``BF16_SHARE`` of the
   elements (``bf16_agreement``), with each conv shape's plan (the
   packed-weight ``wgmma.ss`` kernel where the plan sends it, given
   ``pack_conv_weight_bf16``'s weight as the model gives it), times, bounds
   (products over the bf16 tensor-core peak) and library times. At bench.py's
   large levels also cuDNN's bf16 conv alone on the pre-activated input: a
   yardstick for the product part only, which the port never calls.
7. The 65M ``NCSNpp(dtype="bf16", fuse_pyramid=True)`` at B=1, T=64 on the
   card, with redrawn weights and with the network's own seeded
   initialisation: the whole forward against the CPU and against the float32
   forward on the card with the same weights (the card-vs-CPU gap below
   ``BF16_GAP_RATIO`` of that bf16-vs-float32 gap), 81/28 launches per
   forward; with redrawn weights also each block, attention and Combine of
   the card's forward run again on the CPU from the card's inputs (within
   ``BF16_MODULE_ULPS``). The bf16 weight casts (``weight_casts``: the fused
   convs' packed weights, the cuDNN convs' and dense layers' bf16 copies)
   of the first forward, and none in the next.
8. bench.py's program (bench.py:147-160) from the port's modules: 16
   utterances of 64 frames, each row normalised by its max-abs, STFT,
   ``spec_fwd``, ``pad_spec``, 30 reverse_diffusion + ald steps, ``to_audio``,
   times the norm, with the bf16 trunk and with the float32 trunk on the same
   weights, captured as one program each (``capture.Program``) and replayed:
   the replay against the eager program on the same generator state (within
   ``GRAPH_TOL``, and whether bitwise equal), the capture's time and the
   card memory the program keeps beside the eager program's peak, wall per
   batch graphed and eager, device kernel time (``torch.profiler`` over a
   replay), idle share and device launches beside the eager bf16 program's
   numbers of an earlier run, and for the bf16 trunk the device time by
   kernel family (``profiling.device_breakdown``); both outputs finite, and
   their gap; 4860/1680 kernel launches per batch recorded at the capture,
   the ``wgmma.ss`` kernel's among them, and no weight cast during the
   capture or after it.

9. Training ("train"): each differentiable op (``groupnorm_silu_conv3x3_op``,
   ``groupnorm_silu_op``: the kernel forward, the plain version recomputed
   for the gradient) against the plain version under autograd on the card
   at the training shapes (level 0 with the residual, a head, the square
   deep levels; loss sum(out^2)): the forward within ``KERNEL_TOL``, every
   gradient within ``TRAIN_KERNEL_GRAD_TOL`` of its largest magnitude, the
   backward's time beside its bound and the plain backward's. Then the
   paper's 65.6M model (sebridge_v3, SNR-conditioned, weights redrawn from
   ``TRAIN_WEIGHT_SEED``, 4 x 256 frames): loss and every parameter's
   gradient through the kernel path against the plain path (every wrapper's
   plain version), both on the card, beside the gap between two plain
   float32 paths (cuDNN off against on). Then ``make_train_step``, from the
   same redrawn weights: 10 Adam steps of the paper's model on one fixed
   batch with the same draws each step (the loss must fall), 3 of bbed score
   matching and 1 of the bf16 trunk: every loss finite, every trained
   parameter given a gradient that is not all zero, 162/56 launches a
   consistency step
   (81/28 for bbed) and as many recomputes, a parameter and its EMA against
   ``ema_decay_schedule``; the median step wall after 2 warm-up steps, audio
   seconds trained per second, the peak memory, and one profiled step's
   device time by part and by kernel family with its idle share. Last, the
   training CLI (``python -m diffse_tpu_torch.cli.train``, the paper's
   flags, ``--num_eval_files 0``) on a tiny wav directory written with the
   port's wavio: one epoch of 2 steps into a checkpoint, ``--resume`` for a
   second, and ``load_score_model`` on the result.

10. Serving ("serve"): ``EnhanceService`` (``ServiceConfig`` defaults: chunk
   64, overlap 2, batch 16, flights of 16, 25 ms linger) behind the HTTP
   front (``make_server``) on the 65.6M bbed model (weights redrawn from
   seed 13, float32 trunk) with the certified sampler ``rd_ald_logit_N20``:
   8 client threads POST 2 WAVs each (0.6 to 3.0 s); every answer 200, of
   its input's length and finite; ``/healthz`` and ``/stats``; flights,
   chunk batches and their occupancy, the chunk program's capture time on
   the first flight and the card memory kept, the service's wall per flight
   and audio seconds per second, p50/p95/p99 latency, and the kernel runs
   (one capture: 81 / 28 a forward, 40 forwards a batch). Then stage 2 of
   one chunk batch under ``set_sync_debug_mode("error")``, its replay
   against the eager run on the same generator state (``GRAPH_TOL``,
   bitwise printed); packed (batch 16, utterances split across batches)
   against each utterance alone on ``sebridge`` (``PACKING_TOL``);
   ``eval_enhance_file`` over more width buckets than the model keeps
   programs (``PROGRAMS_KEPT``), with the card memory reserved after each;
   a 1-NFE ``sebridge_v3_snr`` flight (redrawn SNRNet) of one full batch of
   the service's 16 chunks on the card against the CPU with the same draws
   (``WAVEFORM_TOL``); and
   ``python -m diffse_tpu_torch.cli.serve`` (``main(block=False)``) on
   checkpoints that the port's ``CheckpointManager`` wrote, with
   ``--snr_ckpt``, answering one POST.

``python3 chip_smoke.py --phases train,forward`` runs only the phases named
(no kernel record then); the driver's run takes none.

Phases 2 and 9 run with TF32 off for cuDNN and matmul (the plain version's cuDNN
conv would otherwise be the less accurate side); phases 3 to 5 run with
torch's defaults (cuDNN allows TF32), as a user's process would: the port
keeps its own convs, matmuls and LSTM in float32.

The line before the last is a JSON object of the kernels (times in ms; the
bound is the larger of bytes over 3.35 TB/s and operations over their peak:
the conv's products in 3xTF32, three TF32 products each, over 495 TFLOP/s,
or in bf16 over 989 TFLOP/s, other float32 work over 67 TFLOP/s, the H100
SXM's peaks), the bf16 instantiations as kernels of their own (the
packed-weight ``wgmma.ss`` kernel apart from the others), each with its
kernel runs on the card on every path (``launches``, ``launches_by_path``)
and the launches recorded at capture apart; the last line is
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result, when
there is no CUDA device or any phase fails.
"""

from __future__ import annotations

import contextlib
import copy
import json
import subprocess
import sys
import time
import traceback

import numpy as np

SR = 16000
# Kernel tolerance on the card, kernel vs plain version, both float32 (TF32
# off): the sums run in another order (K up to 9*512 terms), so the JAX
# tests' float32 tolerance applies.
KERNEL_TOL = dict(atol=2e-4, rtol=2e-4)
# 65M forward, kernel path (card) vs plain path (CPU): max|diff| / max|ref|.
# Float32 through ~90 layers with different conv algorithms and sum orders.
FORWARD_TOL = 1e-4
# sebridge_v2 waveform, card vs CPU: max|diff| / max|ref|.
WAVEFORM_TOL = 1e-4

K1_SHAPES = [  # (B, H, W, Cin, Cout, skip)
    (1, 256, 64, 128, 128, False),
    (1, 256, 64, 128, 128, True),
    (1, 128, 32, 384, 128, False),
    (1, 256, 64, 128, 4, False),
]
K2_SHAPES = [  # the deep levels at T=64, then at T=192 (odd widths, the concat), then
    # the middle levels at T=128 and 192, latency-bound like the deep ones
    (1, 16, 4, 256, 256, False), (1, 8, 2, 256, 256, False), (1, 4, 1, 256, 256, False),
    (1, 16, 12, 512, 256, False), (1, 8, 6, 256, 256, True), (1, 4, 3, 256, 256, False),
    (1, 32, 16, 256, 256, False), (1, 32, 24, 256, 256, False), (1, 64, 32, 256, 256, False),
]
# bench.py's and the serving chunk program's batch of 16 at 64 frames (the
# launch plans follow the batch): the large level (with and without skip),
# the 384-channel concat, the heads, a W = 8 level and the deep levels (K
# split across blocks)
BATCH16_K1_SHAPES = [
    (16, 256, 64, 128, 128, False), (16, 256, 64, 128, 128, True), (16, 128, 32, 384, 128, False),
    (16, 256, 64, 128, 4, False), (16, 32, 8, 512, 256, False),
    (16, 16, 4, 256, 256, False), (16, 8, 2, 256, 256, False),
    (16, 4, 1, 256, 256, False), (16, 16, 4, 512, 256, False), (16, 8, 2, 256, 256, True),
    (16, 4, 1, 256, 4, False)]
BATCH16_K3_SHAPES = [(16, 256, 64, 128), (16, 16, 4, 256)]
FORWARD_FRAMES = (64, 128, 192)
K3_SHAPES = [(1, 256, 64, 128), (1, 128, 32, 256)] + BATCH16_K3_SHAPES
# the statistics pass alone: K3's shapes, the largest map (T=192) and a small one
STATS_SHAPES = [(1, 256, 64, 128), (1, 128, 32, 256), (1, 256, 192, 128),
                (1, 16, 12, 256)] + BATCH16_K3_SHAPES
K4_SHAPES = [((1, 256, 64, 128), "float32"), ((16, 512), "float32"), ((3, 7, 5, 6), "float32"),
             ((1, 256, 64, 128), "bfloat16")]
# K4, kernel vs plain version: float32 is the same few operations in the same
# order; bfloat16 may differ by one rounding of the float32 result.
K4_F32_TOL = dict(atol=1e-6, rtol=1e-6)
K4_BF16_ULPS = 1.0
UTTERANCE_SECONDS = (1.0, 1.2, 1.5)
# SNR path: the -15 dB training set's SNR as an amplitude ratio, and a bias
# on SNRNet's last layer that puts g_hat near sigmoid(-2) = 0.12, so that
# est_snr ~ 0.14 snaps inside the Karras grid (random weights alone give
# g_hat ~ 0.5 and snap every utterance to t = 1).
FIXED_SNR = 0.17783
SNRNET_FC_BIAS = -2.0
# A snap closer than this (relative) to a boundary between two grid points
# could go either way between card and CPU.
SNAP_MARGIN = 1e-4
# The H100 SXM's peaks (NVIDIA's data sheet): HBM3 and float32 outside the
# tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
TF32_FLOPS = 495e12
BF16_FLOPS = 989e12

# bf16 kernels (phase 6): phase 2's conv shapes (at W = 8 wgmma in bf16)
BF16_K1_SHAPES = K1_SHAPES + K2_SHAPES + BATCH16_K1_SHAPES
BF16_STATS_SHAPES = [(1, 256, 64, 128), (16, 256, 64, 128), (16, 16, 4, 256)]
BF16_REPORT_CONV = (16, 256, 64, 128, 128, True)   # the wgmma.ss kernel's line
BF16_REPORT_DEEP = (16, 16, 4, 512, 256, False)    # the other bf16 instantiations'
BF16_REPORT_K3 = (16, 256, 64, 128)
# bf16 kernel vs plain version, both summing in float32 in other orders: one
# bfloat16 ulp, but where a sum cancels far below its terms (there the
# terms' float32 rounding is many ulps of the result) on at most this share
# of the elements, which stay within one ulp of the largest output.
BF16_SHARE = 1e-3
# bf16 forward (phase 7), each module of the card's forward run on the CPU
# from the card's inputs: a block chains two convs, and where an input of
# the second differs by one ulp its bf16 roundings may go the other way, so
# small outputs may be several of their own ulps off; every element within
# this many ulps of the module's largest output (the worst module measured
# 2 on an H100; a wrong tap, channel or rounding point gives tens).
BF16_MODULE_ULPS = 4
# bf16 forward, card vs CPU: cuDNN's bf16 convs and the kernels sum in other
# orders than the CPU, so some bf16 roundings go the other way, and each
# grows through the depth like any other bf16 rounding: the gap stays below
# bf16's own gap from float32 (this share of it), not far below it.
BF16_GAP_RATIO = 1.0
# A replayed program vs the eager path on the same generator state:
# max|diff| / max|eager| (the same kernels in the same order give the same
# bits; this bounds what a difference may be).
GRAPH_TOL = 1e-6
# bench.py's bf16 program as the eager path ran it before enhance was
# captured (PERF.md section 5, one H100 80GB HBM3 at 700 W): wall per batch,
# device kernel time, idle share, device kernel launches.
EAGER_BF16_EARLIER = (3.839, 1.750, 0.544, 93314)
# sebridge_v3_snr per 1.0-1.5 s utterance, eager, in earlier runs (same card).
EAGER_1NFE_WALLS = (0.036, 0.044)
# Phase 5c ("samplers"). The certified serving sampler rd_ald_logit_N20
# (SAMPLER_QUALITY.json): reverse_diffusion + ald on the logit grid, N = 20,
# 40 forwards, on phase 4's 1.0 and 1.5 s utterances (128 and 192 frames).
SERVING_SAMPLER = dict(predictor="reverse_diffusion", corrector="ald", N=20,
                       timestep_type="logit")
SERVING_SECONDS = (1.0, 1.5)
# Each predictor, the langevin corrector, each grid and each SDE, the card
# against the CPU at N = 2 on the 1.0 s utterance: (sde, predictor,
# corrector, grid, N).
SAMPLER_SECONDS = 1.0
SAMPLER_CASES = [
    ("bbed", "euler_maruyama", "langevin", "linear", 2),
    ("bbed", "heun", "none", "bridge_geom", 2),
    ("bbed", "exp_euler", "ald", "logit", 2),
    ("bbed", "exp_heun", "none", "logit", 2),
    ("bbed", "none", "langevin", "bridge_geom", 2),
    ("ouve", "reverse_diffusion", "ald", "linear", 2),
    ("ouve", "exp_heun", "langevin", "linear", 2),
    ("proposed_1", "reverse_diffusion", "langevin", "logit", 2),
    ("proposed_1", "heun", "ald", "bridge_geom", 2),
]
# OUVE at its defaults; PROPOSED_1 with sigma_max != sigma_min (at its
# defaults its std is NaN: Ei(0) = -inf).
SAMPLER_SDE_KWARGS = {"bbed": dict(T_sampling=0.999, k=2.6, theta=0.52), "ouve": {},
                      "proposed_1": dict(sigma_min=1.0, sigma_max=2.6, theta=0.52)}
# the sampler waveforms, card vs CPU (max|diff|/max|ref|): a few forwards,
# each within FORWARD_TOL, as the 1-NFE branches are held
SAMPLER_TOL = 1e-4
# ... but the exponential predictors under BBED: their last step reads
# std(T_FLOOR = 1e-5), whose Ei(2(t-1) log k) - Ei(-2 log k) is ~4e4 times
# smaller than its terms (and Ei itself sums terms ~24 times its value), so
# float32 gets that std a few per cent wrong, differently wherever Ei rounds
# differently (this phase prints it on the card, on the CPU and in float64).
# The JAX package's own jitted and op-by-op enhance differ by ~1e-3 there,
# the port's CPU path and the op-by-op JAX package by ~5e-7
# (tests/test_torch_samplers.py::test_exp_heun_at_the_floor_matches_jax_op_by_op).
EXP_SAMPLER_TOL = 2e-3
# set_sync_debug_mode("error") through these (predictor, corrector, grid)
SYNC_FREE_CASES = [("heun", "none", "bridge_geom"), ("exp_euler", "none", "logit"),
                   ("exp_heun", "langevin", "logit")]
# bbed_ode at rtol = atol = 1e-5: graphed vs eager on the 1.0 s utterance
# (128 frames; ~490 evaluations at these weights). Card vs CPU on its first
# ODE_CPU_SAMPLES (64 frames) with the output layer scaled by
# ODE_CPU_OUTPUT_SCALE, so that the CPU's side (~1 s a 65M forward there)
# takes ~100 evaluations: the same accepted and rejected steps (flags equal;
# a difference is reported as an accept/reject flip), and the waveform
# within ODE_WAVEFORM_TOL: each drift evaluation differs by up to
# FORWARD_TOL, and the backward flow grows |x - y| ~1000-fold from T = 0.999
# to eps, so differences of a forward's size are held to ten times it.
ODE_SECONDS = 1.0
ODE_CPU_SAMPLES = 8000
ODE_CPU_OUTPUT_SCALE = 0.01
ODE_WAVEFORM_TOL = 1e-3
BENCH_BATCH = 16
BENCH_FRAMES = 64
BENCH_STEPS = 30
# training (phase 9): the paper's configuration (README step 3: sebridge_v3,
# SNR-conditioned, fixed_snr 0.17783, exponent compression, --sigma-max 1.0 on
# the default OUVE SDE, the 65.6M NCSN++) on the JAX command line's batch of
# 4 crops of 256 frames; the enhancement metrics are not ported
PAPER_CONFIG = dict(backbone="ncsnpp", sde="ouve", model_type="sebridge_v3",
                    snr_conditioned="true", fixed_snr=FIXED_SNR, sigma_max=1.0,
                    transform_type="exponent", num_eval_files=0)
PAPER_SDE_KWARGS = dict(sigma_max=1.0)
BBED_TRAIN_CONFIG = dict(backbone="ncsnpp", sde="bbed", model_type="bbed",
                         snr_conditioned="false", sigma_max=0.5, num_eval_files=0)
TRAIN_BATCH, TRAIN_FRAMES, TRAIN_HOP = 4, 256, 128
TRAIN_SAMPLES = (TRAIN_FRAMES - 1) * TRAIN_HOP
TRAIN_AUDIO_S = TRAIN_BATCH * TRAIN_SAMPLES / SR  # audio a step trains on
TRAIN_STEPS, TRAIN_WARMUP, BBED_STEPS = 10, 2, 3
# the full model's kernel path against its plain path on the card: redrawn
# weights, the loss within 1e-5 relative and each parameter's gradient within
# 1e-4 of its largest magnitude; printed beside the gap between two plain
# float32 paths on the card (cuDNN's convolutions, and PyTorch's own with
# cuDNN off)
TRAIN_WEIGHT_SEED = 13
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_TOL = 1e-4
# the ops' gradients, kernel forward against plain, at the training shapes:
# the JAX tests' gradient tolerance (tests/test_norm_and_pallas.py), of each
# gradient's largest magnitude
TRAIN_KERNEL_GRAD_TOL = 1e-3
# (B, H, W, Cin, Cout, skip): level 0 with the residual (and the [Cout] bias
# expanded over the batch, as the blocks' second conv), a pyramid head, the
# square deep levels (the deepest with its 512-channel concat) and a head there
TRAIN_CONV_SHAPES = [(4, 256, 256, 128, 128, True), (4, 256, 256, 128, 4, False),
                     (4, 8, 8, 256, 256, True), (4, 4, 4, 512, 256, False),
                     (4, 4, 4, 256, 4, False)]
TRAIN_GN_SHAPES = [(4, 256, 256, 128), (4, 8, 8, 256)]
# the CLI's data: crops of 2.5 s, 8 training pairs (2 batches of 4), 2 valid
CLI_SECONDS, CLI_TRAIN_FILES, CLI_VALID_FILES = 2.5, 8, 2
# phase 10 ("serve"): the service over HTTP on the 65.6M bbed model (weights
# redrawn from seed 13, float32 trunk) with the certified serving sampler
# rd_ald_logit_N20 (reverse_diffusion + ald on the logit grid, N = 20: 40
# forwards a chunk batch); 8 client threads send 2 requests each, request k
# of SERVE_SECONDS[k % 8] seconds
SERVE_SAMPLER = {"timestep_type": "logit", "N": 20}
SERVE_FORWARDS = 40
SERVE_SECONDS = (0.6, 1.0, 1.4, 1.8, 2.0, 2.2, 2.6, 3.0)
SERVE_CLIENTS, SERVE_REQUESTS_EACH = 8, 2
# the chunk batch replayed against the eager run, and run under
# set_sync_debug_mode("error"): 1.4 + 1.8 + 2.0 s, 12 chunks and 4 padding rows
SERVE_CHECK_SECONDS = (1.4, 1.8, 2.0)
# packed (batch 16, utterances split across batches) vs each utterance alone
# (a batch of its own chunks), sebridge: the rows' computation is the same,
# but the conv's launch plan (and so its sum order) follows the batch, so
# the waveforms are held as the card holds the forward to the CPU
PACKING_TOL = 1e-4
# eval_enhance_file on sebridge, one utterance in each of 6 width buckets (64
# to 384 frames): more buckets than the model keeps programs
SERVE_BUCKET_SECONDS = (0.45, 0.9, 1.4, 1.9, 2.4, 3.0)
# the 1-NFE sebridge_v3_snr flight, card vs CPU: 0.6 + 1.0 + 1.4 + 1.8 + 2.0
# s, 16 chunks, one batch of the service's 16 (the served batches' launch
# plans)
SERVE_CPU_SECONDS = (0.6, 1.0, 1.4, 1.8, 2.0)
# gn_silu_conv3x3's instantiations (ops/cuda_kernels.py CONV_CONFIGS), by id
# what the JSON line's launches count
LAUNCHES_COUNTED = ("kernel runs on the card: eager launches, and each captured program's "
                    "launches recorded at its capture times its replays")
CONV_NAMES = ("mma.sync 64x64", "mma.sync 128x8", "wgmma", "wgmma.ss")


def median_ms(torch, fn, reps=20, warmup=3):
    """Median time of one call over CUDA events (launch overhead included)."""
    for _ in range(warmup):
        fn()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in events]))


def bound(flops, nbytes):
    """The least time the card could take: ``(ms, "bytes" | "operations")``."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def conv_work(b, h, w, cin, cout, skip, act_bytes=4):
    """K1's operations and bytes: the conv's multiply-adds (the taps that
    touch the map), ~9 operations per input element (statistics, affine,
    SiLU) and 3 per output element (bias, skip, scale); x, the GroupNorm
    affine, the weights, the bias, the skip and the output, each moved once,
    the activations (x, skip, out) at ``act_bytes`` an element, the rest in
    float32. Returns (matmul flops, other flops, bytes)."""
    taps = (3 if h > 1 else 1) * (3 if w > 1 else 1)
    matmul = 2 * b * h * w * taps * cin * cout
    other = 9 * b * h * w * cin + 3 * b * h * w * cout
    nbytes = (act_bytes * (b * h * w * cin + (2 if skip else 1) * b * h * w * cout)
              + 4 * (2 * cin + taps * cin * cout + b * cout))
    return matmul, other, nbytes


def conv_bounds(b, h, w, cin, cout, skip, act_bytes=4):
    """The conv's bounds, ``{"f32": (ms, by), "tf32x3": (ms, by), "bf16":
    (ms, by)}``: all its operations in float32 on the CUDA cores, its
    products as three TF32 products each on the tensor cores (the float32
    kernel's way), or as bf16 products (the bf16 kernel's way), the rest in
    float32."""
    matmul, other, nbytes = conv_work(b, h, w, cin, cout, skip, act_bytes)
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3

    def pick(by_ops):
        return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")

    return {"f32": pick((matmul + other) / F32_FLOPS * 1e3),
            "tf32x3": pick((3 * matmul / TF32_FLOPS + other / F32_FLOPS) * 1e3),
            "bf16": pick((matmul / BF16_FLOPS + other / F32_FLOPS) * 1e3)}


def timing(torch, fn, plain, library=None):
    """Per-call and queued times of the kernel, its plain version and the
    library call."""
    from diffse_tpu_torch.utils import queued_ms

    out = {"ms": median_ms(torch, fn), "plain_ms": median_ms(torch, plain),
           "device_ms": queued_ms(fn), "plain_device_ms": queued_ms(plain),
           "library_ms": None, "library_device_ms": None}
    if library is not None:
        out["library_ms"] = median_ms(torch, library)
        out["library_device_ms"] = queued_ms(library)
    return out


def describe(t, bound_ms, bound_by):
    lib = ("" if t["library_ms"] is None else
           f" library {t['library_ms']:.4f} ms (queued {t['library_device_ms']:.4f})")
    return (f"kernel {t['ms']:.4f} ms (queued {t['device_ms']:.4f}) plain {t['plain_ms']:.4f} "
            f"ms (queued {t['plain_device_ms']:.4f}){lib} bound {bound_ms:.4f} ms ({bound_by})")


def check_kernels(torch, ck, dev):
    """Phase 2. Returns per-kernel {max_abs_err, ms, plain_ms, bound_ms,
    bound_by, library_ms, ...} at the shape the JSON line reports."""
    import torch.nn.functional as F

    rng = np.random.default_rng(0)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev)

    result = {"gn_silu_conv3x3": {"max_abs_err": 0.0}, "groupnorm_silu": {"max_abs_err": 0.0}}
    failures = []
    for b, h, w, cin, cout, with_skip in K1_SHAPES + K2_SHAPES + BATCH16_K1_SHAPES:
        x = t(rng.standard_normal((b, h, w, cin)))
        gs = t(1 + 0.1 * rng.standard_normal(cin))
        gb = t(0.1 * rng.standard_normal(cin))
        wk = t(0.05 * rng.standard_normal((3, 3, cin, cout)))
        bt = t(0.1 * rng.standard_normal((b, cout)))
        skip = t(rng.standard_normal((b, h, w, cout))) if with_skip else None
        groups = min(cin // 4, 32)
        coef = 1 / np.sqrt(2.0)
        args = (x, gs, gb, wk, bt, groups)
        kw = dict(skip=skip, skip_coef=coef)
        out = ck.groupnorm_silu_conv3x3(*args, **kw)
        ref = ck.groupnorm_silu_conv3x3_reference(*args, **kw)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        rel = err / ref.abs().max().item()
        ok = torch.allclose(out, ref, **KERNEL_TOL)
        times = timing(torch, lambda: ck.groupnorm_silu_conv3x3(*args, **kw),
                       lambda: ck.groupnorm_silu_conv3x3_reference(*args, **kw))
        bounds = conv_bounds(b, h, w, cin, cout, with_skip)
        bound_ms, bound_by = bounds["tf32x3"]
        plan = ck.conv_plan(b, h, w, cin, cout)
        bm, bn, _, instruction = ck.CONV_CONFIGS[plan.config][:4]
        name = f"gn_silu_conv3x3 {[b, h, w, cin]}->{cout}{' +skip' if with_skip else ''}"
        print(f"{name}: max_abs_err {err:.3e} rel {rel:.3e} ok {ok} | "
              f"{describe(times, bound_ms, bound_by)} [held to 3xTF32; float32 CUDA-core "
              f"bound {bounds['f32'][0]:.4f} ms ({bounds['f32'][1]})] | plan: {instruction} "
              f"3xTF32, {bm}x{bn} block, tile {plan.th}x{plan.tw}, grid {plan.grid} = "
              f"{plan.ctas} CTAs, K split {plan.splits} x {plan.units_per_split} of "
              f"{plan.units} units, {plan.smem_bytes} B shared")
        r = result["gn_silu_conv3x3"]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if (b, h, w, cin, cout, with_skip) == (1, 256, 64, 128, 128, True):
            r.update(times, bound_ms=bound_ms, bound_by=bound_by)
        if not ok:
            failures.append(name)
    for shape in K3_SHAPES:
        c = shape[-1]
        x = t(2 * rng.standard_normal(shape) + 1)
        sc = t(1 + 0.1 * rng.standard_normal(c))
        bi = t(0.1 * rng.standard_normal(c))
        groups = min(c // 4, 32)
        for apply_silu in (True, False):
            out = ck.groupnorm_silu(x, sc, bi, groups, apply_silu=apply_silu)
            ref = ck.groupnorm_silu_reference(x, sc, bi, groups, apply_silu=apply_silu)
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            rel = err / ref.abs().max().item()
            ok = torch.allclose(out, ref, **KERNEL_TOL)
            # GroupNorm alone is one PyTorch call (on the NCHW view of x)
            library = None if apply_silu else (
                lambda: F.group_norm(x.permute(0, 3, 1, 2), groups, sc, bi, eps=1e-6))
            times = timing(
                torch, lambda: ck.groupnorm_silu(x, sc, bi, groups, apply_silu=apply_silu),
                lambda: ck.groupnorm_silu_reference(x, sc, bi, groups, apply_silu=apply_silu),
                library)
            # x in, out: statistics (3), affine (2), SiLU (4) per element
            bound_ms, bound_by = bound((9 if apply_silu else 5) * x.numel(),
                                       4 * (2 * x.numel() + 2 * c))
            name = f"groupnorm_silu {list(shape)} silu={apply_silu}"
            print(f"{name}: max_abs_err {err:.3e} rel {rel:.3e} ok {ok} | "
                  f"{describe(times, bound_ms, bound_by)}")
            r = result["groupnorm_silu"]
            r["max_abs_err"] = max(r["max_abs_err"], err)
            if shape == (1, 256, 64, 128) and apply_silu:
                r.update(times, bound_ms=bound_ms, bound_by=bound_by)
            if not ok:
                failures.append(name)
    for shape in STATS_SHAPES:
        b, h, w, c = shape
        x = t(rng.standard_normal(shape))
        sc = t(1 + 0.1 * rng.standard_normal(c))
        bi = t(0.1 * rng.standard_normal(c))
        groups = min(c // 4, 32)
        out = ck.gn_stats_ab(x, sc, bi, groups)
        ref = ck.gn_stats_ab_reference(x, sc, bi, groups, 1e-6)
        torch.cuda.synchronize()
        err = max((o - r).abs().max().item() for o, r in zip(out, ref))
        ok = all(torch.allclose(o, r, **KERNEL_TOL) for o, r in zip(out, ref))
        xg = x.view(b, h * w, groups, c // groups)
        times = timing(torch, lambda: ck.gn_stats_ab(x, sc, bi, groups),
                       lambda: ck.gn_stats_ab_reference(x, sc, bi, groups, 1e-6),
                       lambda: torch.var_mean(xg, dim=(1, 3)))
        # x in, a and b out; a square and two sums per element
        bound_ms, bound_by = bound(3 * x.numel(), 4 * (x.numel() + 2 * b * c))
        parts, chunk = ck.stats_plan(b, h * w, c)
        name = f"gn_stats_ab {list(shape)}"
        print(f"{name}: max_abs_err {err:.3e} ok {ok} | {describe(times, bound_ms, bound_by)} "
              f"| plan: {parts} x {b} blocks of {chunk} positions")
        if not ok:
            failures.append(name)
    if failures:
        raise AssertionError(f"kernels disagree with their plain versions: {failures}")
    return result


def bf16_ulps(torch, out, ref):
    """max |out - ref| in units of ref's bfloat16 spacing (8 significant bits)."""
    ref32 = ref.float()
    exponent = torch.floor(torch.log2(ref32.abs().clamp_min(2.0 ** -126)))
    return ((out.float() - ref32).abs() / torch.exp2(exponent - 7)).max().item()


def check_fused_act(torch, ck, dev):
    """Phase 2b: the fused bias + LeakyReLU kernel against its plain version.
    Returns its record at [1,256,64,128] float32."""
    from diffse_tpu_torch.ops.fused_act import fused_bias_leaky_relu

    rng = np.random.default_rng(1)
    record, failures = {"max_abs_err": 0.0}, []
    for shape, dtype_name in K4_SHAPES:
        dtype = getattr(torch, dtype_name)
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, dtype)
        bias = torch.from_numpy(rng.standard_normal(shape[-1]).astype(np.float32)).to(dev, dtype)
        out = fused_bias_leaky_relu(x, bias)
        ref = ck.fused_bias_leaky_relu_reference(x, bias)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        if dtype == torch.float32:
            ok = torch.allclose(out, ref, **K4_F32_TOL)
            detail = f"max_abs_err {err:.3e} (atol = rtol = {K4_F32_TOL['atol']})"
        else:
            ulps = bf16_ulps(torch, out, ref)
            ok = ulps <= K4_BF16_ULPS
            detail = f"max_abs_err {err:.3e}, {ulps:.2f} bf16 ulp (limit {K4_BF16_ULPS})"
        ok = ok and out.dtype == dtype and out.shape == x.shape
        times = timing(torch, lambda: fused_bias_leaky_relu(x, bias),
                       lambda: ck.fused_bias_leaky_relu_reference(x, bias))
        # x in, out, bias; add, select, scale per element
        bound_ms, bound_by = bound(3 * x.numel(),
                                   x.element_size() * (2 * x.numel() + shape[-1]))
        name = f"fused_bias_leaky_relu {list(shape)} {dtype_name}"
        print(f"{name}: {detail} ok {ok} | {describe(times, bound_ms, bound_by)}")
        record["max_abs_err"] = max(record["max_abs_err"], err)
        if shape == (1, 256, 64, 128) and dtype == torch.float32:
            record.update(times, bound_ms=bound_ms, bound_by=bound_by)
        if not ok:
            failures.append(name)
    if failures:
        raise AssertionError(f"fused_bias_leaky_relu disagrees with its plain version: "
                             f"{failures}")
    return record


def bf16_agreement(torch, out, ref):
    """``(ok, share, max_abs_err)``: ``out`` within one bfloat16 ulp of
    ``ref`` but on at most ``BF16_SHARE`` of the elements (``share``), which
    stay within one ulp of ``ref``'s largest magnitude."""
    ref64, diff = ref.double(), (out.double() - ref.double()).abs()
    spacing = torch.exp2(torch.floor(torch.log2(ref64.abs().clamp_min(2.0 ** -126))) - 7)
    share = (diff > spacing).double().mean().item()
    top = torch.exp2(torch.floor(torch.log2(ref64.abs().max().clamp_min(2.0 ** -126))) - 7)
    err = diff.max().item()
    return share <= BF16_SHARE and err <= top.item(), share, err


def check_bf16_kernels(torch, ck, dev):
    """Phase 6: the bf16 instantiations against their plain versions.
    Returns their records at bench.py's shapes."""
    import torch.nn.functional as F

    from diffse_tpu_torch.utils import queued_ms

    rng = np.random.default_rng(6)

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev, dtype)

    result = {"gn_silu_conv3x3": {"max_abs_err": 0.0}, "gn_silu_conv3x3_ws": {"max_abs_err": 0.0},
              "groupnorm_silu": {"max_abs_err": 0.0}}
    failures = []
    for b, h, w, cin, cout, with_skip in BF16_K1_SHAPES:
        x = t(rng.standard_normal((b, h, w, cin)), torch.bfloat16)
        gs = t(1 + 0.1 * rng.standard_normal(cin))
        gb = t(0.1 * rng.standard_normal(cin))
        wk = t(rng.standard_normal((3, 3, cin, cout)) / np.sqrt(9 * cin))
        bt = t(0.1 * rng.standard_normal((b, cout)))
        skip = t(rng.standard_normal((b, h, w, cout)), torch.bfloat16) if with_skip else None
        groups = min(cin // 4, 32)
        args = (x, gs, gb, wk, bt, groups)
        kw = dict(skip=skip, skip_coef=1 / np.sqrt(2.0))
        packed = ck.pack_conv_weight_bf16(wk)  # as a bf16 block keeps it
        out = ck.groupnorm_silu_conv3x3(*args, **kw, w_packed=packed)
        ref = ck.groupnorm_silu_conv3x3_reference(*args, **kw)
        torch.cuda.synchronize()
        ok, share, err = bf16_agreement(torch, out, ref)
        ok = ok and out.dtype == torch.bfloat16
        times = timing(torch, lambda: ck.groupnorm_silu_conv3x3(*args, **kw, w_packed=packed),
                       lambda: ck.groupnorm_silu_conv3x3_reference(*args, **kw))
        bound_ms, bound_by = conv_bounds(b, h, w, cin, cout, with_skip, act_bytes=2)["bf16"]
        plan = ck.conv_plan(b, h, w, cin, cout, torch.bfloat16)
        bm, bn, _, instruction = ck.CONV_CONFIGS[plan.config][:4]
        name = f"gn_silu_conv3x3 bf16 {[b, h, w, cin]}->{cout}{' +skip' if with_skip else ''}"
        yardstick = ""
        if b == BENCH_BATCH and plan.config == ck.CONV_WGMMA_SS and h * w >= 64 * 16:
            # cuDNN's bf16 conv alone, on the input activated and rounded as
            # the kernel's prologue rounds it: the product part's yardstick
            a, bb = ck.gn_stats_ab(x, gs, gb, groups)
            v = x.float() * a[:, None, None, :] + bb[:, None, None, :]
            act = (v * torch.sigmoid(v)).bfloat16().permute(0, 3, 1, 2)
            wb = wk.permute(3, 2, 0, 1).bfloat16().contiguous(memory_format=torch.channels_last)
            conv = lambda: F.conv2d(act, wb, padding=1)  # noqa: E731
            cudnn_ms, cudnn_queued = median_ms(torch, conv), queued_ms(conv)
            yardstick = (f" | cuDNN bf16 conv alone on the pre-activated input (yardstick for the "
                         f"products only, not the same function): {cudnn_ms:.4f} ms (queued "
                         f"{cudnn_queued:.4f})")
        print(f"{name}: max_abs_err {err:.3e}, share beyond 1 bf16 ulp {share:.2e} (limit "
              f"{BF16_SHARE}) ok {ok} | {describe(times, bound_ms, bound_by)} | plan: "
              f"{instruction} bf16, {bm}x{bn} block, tile {plan.th}x{plan.tw}, grid {plan.grid} = "
              f"{plan.ctas} CTAs, K split {plan.splits} x {plan.units_per_split} of {plan.units} "
              f"units, {plan.smem_bytes} B shared{yardstick}")
        r = result["gn_silu_conv3x3_ws" if plan.config == ck.CONV_WGMMA_SS else "gn_silu_conv3x3"]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if (b, h, w, cin, cout, with_skip) in (BF16_REPORT_CONV, BF16_REPORT_DEEP):
            r.update(times, bound_ms=bound_ms, bound_by=bound_by,
                     plan=f"{instruction} tile {plan.th}x{plan.tw} grid {list(plan.grid)}",
                     shape=name.split(" ", 2)[2])
        if not ok:
            failures.append(name)
    if "ms" not in result["gn_silu_conv3x3_ws"]:
        failures.append(f"{BF16_REPORT_CONV} is not planned on the wgmma.ss kernel")
    for shape in K3_SHAPES:
        b, h, w, c = shape
        x = t(2 * rng.standard_normal(shape) + 1, torch.bfloat16)
        sc = t(1 + 0.1 * rng.standard_normal(c))
        bi = t(0.1 * rng.standard_normal(c))
        groups = min(c // 4, 32)
        for apply_silu, out_dtype in ((True, torch.bfloat16), (False, torch.bfloat16),
                                      (False, torch.float32)):
            kw = dict(apply_silu=apply_silu, out_dtype=out_dtype)
            out = ck.groupnorm_silu(x, sc, bi, groups, **kw)
            ref = ck.groupnorm_silu_reference(x, sc, bi, groups, **kw)
            torch.cuda.synchronize()
            if out_dtype == torch.bfloat16:
                ok, share, err = bf16_agreement(torch, out, ref)
                detail = f"share beyond 1 bf16 ulp {share:.2e} (limit {BF16_SHARE})"
            else:
                ok = torch.allclose(out, ref, **KERNEL_TOL)
                err, detail = (out - ref).abs().max().item(), f"atol = rtol = {KERNEL_TOL['atol']}"
            ok = ok and out.dtype == out_dtype
            # GroupNorm alone on bf16 is one PyTorch call (bf16 affine parameters)
            library = None if apply_silu or out_dtype != torch.bfloat16 else (
                lambda: F.group_norm(x.permute(0, 3, 1, 2), groups, sc.bfloat16(), bi.bfloat16(),
                                     eps=1e-6))
            times = timing(torch, lambda: ck.groupnorm_silu(x, sc, bi, groups, **kw),
                           lambda: ck.groupnorm_silu_reference(x, sc, bi, groups, **kw), library)
            out_bytes = 2 if out_dtype == torch.bfloat16 else 4
            bound_ms, bound_by = bound((9 if apply_silu else 5) * x.numel(),
                                       (2 + out_bytes) * x.numel() + 8 * c)
            name = (f"groupnorm_silu bf16 {list(shape)} silu={apply_silu} -> "
                    f"{str(out_dtype).split('.')[-1]}")
            print(f"{name}: max_abs_err {err:.3e}, {detail} ok {ok} | "
                  f"{describe(times, bound_ms, bound_by)}")
            r = result["groupnorm_silu"]
            r["max_abs_err"] = max(r["max_abs_err"], err)
            if shape == BF16_REPORT_K3 and apply_silu:
                r.update(times, bound_ms=bound_ms, bound_by=bound_by)
            if not ok:
                failures.append(name)
    for shape in BF16_STATS_SHAPES:
        b, h, w, c = shape
        x = t(rng.standard_normal(shape), torch.bfloat16)
        sc = t(1 + 0.1 * rng.standard_normal(c))
        bi = t(0.1 * rng.standard_normal(c))
        groups = min(c // 4, 32)
        out = ck.gn_stats_ab(x, sc, bi, groups)
        ref = ck.gn_stats_ab_reference(x, sc, bi, groups, 1e-6)
        torch.cuda.synchronize()
        err = max((o - r).abs().max().item() for o, r in zip(out, ref))
        ok = all(torch.allclose(o, r, **KERNEL_TOL) for o, r in zip(out, ref))
        xg = x.view(b, h * w, groups, c // groups)
        times = timing(torch, lambda: ck.gn_stats_ab(x, sc, bi, groups),
                       lambda: ck.gn_stats_ab_reference(x, sc, bi, groups, 1e-6),
                       lambda: torch.var_mean(xg, dim=(1, 3)))
        bound_ms, bound_by = bound(3 * x.numel(), 2 * x.numel() + 8 * b * c)
        parts, chunk = ck.stats_plan(b, h * w, c)
        name = f"gn_stats_ab bf16 {list(shape)}"
        print(f"{name}: max_abs_err {err:.3e} ok {ok} | {describe(times, bound_ms, bound_by)} "
              f"| plan: {parts} x {b} blocks of {chunk} positions")
        if not ok:
            failures.append(name)
    if failures:
        raise AssertionError(f"bf16 kernels disagree with their plain versions: {failures}")
    return result


def redraw_weights(torch, model, seed):
    """Every weight from a seeded generator at a non-zero scale (the default
    init zeroes every block's last conv and every pyramid head)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if not p.requires_grad:  # the frozen Fourier-feature W keeps its draw
                continue
            z = torch.randn(p.shape, generator=g)
            if p.ndim >= 2:
                fan_in = p.shape[0] if name.endswith(".W") else p[0].numel()
                p.copy_(z / fan_in ** 0.5)
            elif name.endswith("weight"):
                p.copy_(1 + 0.1 * z)
            else:
                p.copy_(0.1 * z)


def check_forward(torch, ck, dev):
    """Phase 3: 65M NCSN++ forwards, kernel path on the card vs plain on CPU,
    at every width the main path runs."""
    from diffse_tpu_torch.models.ncsnpp import NCSNpp

    torch.backends.cudnn.allow_tf32 = True
    print("phases 3-5 with torch's defaults: torch.backends.cudnn.allow_tf32=True, "
          "torch.backends.cuda.matmul.allow_tf32=False")
    model = NCSNpp(generator=torch.Generator().manual_seed(0))
    redraw_weights(torch, model, seed=1)
    n_params = sum(p.numel() for p in model.parameters())
    cpu_model = copy.deepcopy(model).eval()
    model = model.to(dev).eval()
    rng = np.random.default_rng(2)
    failures = []
    for frames in FORWARD_FRAMES:
        shape = (1, 2, 256, frames)
        x = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
        x = torch.from_numpy(x.astype(np.complex64))
        t = torch.tensor([0.5])
        xd, td = x.to(dev), t.to(dev)
        with torch.no_grad():
            ck.reset_launch_counts()
            out = model(xd, td)
            torch.cuda.synchronize()
            counts = dict(ck.launch_counts)
            ms = median_ms(torch, lambda: model(xd, td), reps=5, warmup=1)
            ref = cpu_model(x, t)
        err = (out.cpu() - ref).abs().max().item() / ref.abs().max().item()
        print(f"NCSN++ forward ({n_params} params, F=256 T={frames}): kernel path (card) vs "
              f"plain path (CPU) max|diff|/max|ref| {err:.3e} (tol {FORWARD_TOL}); "
              f"forward {ms:.2f} ms on the card; launches per forward {counts}")
        if not torch.isfinite(out).all():
            failures.append(f"T={frames}: output is not finite")
        if err > FORWARD_TOL:
            failures.append(f"T={frames}: deviates by {err:.3e}")
        if counts != {"gn_silu_conv3x3": 81, "groupnorm_silu": 28, "fused_bias_leaky_relu": 0}:
            failures.append(f"T={frames}: launch counts per forward {counts}, expected 81 and 28")
    if failures:
        raise AssertionError("; ".join(failures))


def synthetic_pair(rng, n):
    """Speech-like clean signal (a harmonic stack under a syllable envelope)
    and the same plus white noise."""
    t = np.arange(n) / SR
    f0 = rng.uniform(100, 220)
    harm = sum(rng.uniform(0.2, 1.0) * np.sin(2 * np.pi * f0 * k * t + rng.uniform(0, 6.3))
               for k in range(1, 6))
    env = 0.02 + np.clip(np.sin(2 * np.pi * rng.uniform(2.0, 4.0) * t), 0, None)
    clean = 0.3 * env * harm / 5
    return clean.astype(np.float32), (clean + 0.05 * rng.standard_normal(n)).astype(np.float32)


def main_path_pairs():
    """The (clean, noisy) utterances of phases 4 and 5: 1.0, 1.2 and 1.5 s."""
    rng = np.random.default_rng(3)
    return [synthetic_pair(rng, int(s * SR)) for s in UTTERANCE_SECONDS]


def cpu_noise(torch, seed):
    """A noise source drawn on the CPU, so that card and CPU get the same draws."""
    from diffse_tpu_torch.utils import randn_like

    g = torch.Generator().manual_seed(seed)
    return lambda like: randn_like(like.cpu(), g).to(like.device)


def card_runs(counts, programs):
    """A path's kernel runs on the card, from the wrappers' counts over a
    window in which every program of ``programs`` was built: less what each
    capture recorded (a capture runs nothing on the card), plus what each
    replay ran (the recorded launches, replayed). Returns ``{"runs": ...,
    "recorded": ...}``: the runs, and the launches recorded at capture."""
    recorded = {k: sum(p.launch_counts[k] for p in programs) for k in counts}
    runs = {k: n + sum(p.launch_counts[k] * (p.replays - 1) for p in programs)
            for k, n in counts.items()}
    return {"runs": runs, "recorded": recorded}


def memory_held(torch, fn):
    """Runs ``fn`` and returns its result and the card memory it left
    reserved (``memory_reserved`` after ``empty_cache``, before and after):
    for a capture, what its program keeps."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved()
    out = fn()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return out, torch.cuda.memory_reserved() - before


def run_main_path(torch, ck, dev):
    """Phase 4: enhance through bbed_pc (3 utterances) and sebridge_v2."""
    from diffse_tpu_torch.models.score_model import ScoreModel, ScoreModelConfig

    sde_kwargs = dict(T_sampling=0.999, k=2.6, theta=0.52, N=30)
    bbed = ScoreModel(ScoreModelConfig(backbone="ncsnpp", sde="bbed", model_type="bbed",
                                       snr_conditioned="false", sigma_max=0.5),
                      sde_kwargs=sde_kwargs, device=dev,
                      generator=torch.Generator().manual_seed(0))
    v2_cfg = ScoreModelConfig(backbone="ncsnpp", sde="bbed", model_type="sebridge_v2",
                              snr_conditioned="false", sigma_max=1.0)
    v2 = ScoreModel(v2_cfg, sde_kwargs=sde_kwargs, device=dev)
    # non-zero weights, so that the card-vs-CPU check below sees the network
    redraw_weights(torch, v2.backbone, seed=4)

    utterances = [noisy for _, noisy in main_path_pairs()]

    walls, outs, captured = [], [], []
    ck.reset_launch_counts()
    for i, y in enumerate(utterances):
        graphs = len(bbed._graphs)
        t0 = time.time()
        out, nfe = bbed.enhance(y[None], y[None], generator=torch.Generator(dev).manual_seed(i),
                                N=30, timeit=True)[:2]
        walls.append(time.time() - t0)
        outs.append(out)
        captured.append(len(bbed._graphs) > graphs)
    v2_out = v2.enhance(utterances[0][None], utterances[0][None], noise=cpu_noise(torch, 7))
    counts = dict(ck.launch_counts)

    for y, out, wall, new in zip(utterances, outs, walls, captured):
        print(f"bbed_pc: {len(y) / SR:.2f} s utterance, nfe {nfe}, wall {wall:.3f} s"
              f"{' (its bucket captured in this call)' if new else ' (a replay)'}, "
              f"finite {bool(np.isfinite(out).all())}, peak {np.max(np.abs(out)):.4f}")
    per_program = {"gn_silu_conv3x3": 81 * 60, "groupnorm_silu": 28 * 60,
                   "fused_bias_leaky_relu": 0}
    for key, (_, program) in bbed._graphs.items():
        print(f"bbed_pc program for {key.t_pad} frames: launches recorded at its capture "
              f"{program.launch_counts}, weight casts {program.weight_casts}")
        if program.launch_counts != per_program:
            raise AssertionError(f"program for {key.t_pad} frames recorded "
                                 f"{program.launch_counts}, expected {per_program}")
    # through the wrappers: each program's warm-up run and its capture (60
    # forwards each), and sebridge_v2's eager forward
    total_forwards = 2 * 60 * len(bbed._graphs) + 1
    programs = [program for _, program in bbed._graphs.values()]
    path = card_runs(counts, programs)
    print(f"main-path launches: {counts} over {total_forwards} forwards through the wrappers "
          f"({len(programs)} programs captured, replayed {sum(p.replays for p in programs)} "
          f"times); kernel runs on the card {path['runs']} (recorded at capture "
          f"{path['recorded']})")
    for y, out in zip(utterances + [utterances[0]], outs + [v2_out]):
        if out.shape != y.shape or not np.isfinite(out).all():
            raise AssertionError(f"bad output: shape {out.shape} vs {y.shape}")
    expected = {"gn_silu_conv3x3": 81 * total_forwards, "groupnorm_silu": 28 * total_forwards,
                "fused_bias_leaky_relu": 0}
    if counts != expected:
        raise AssertionError(f"main-path launch counts {counts}, expected {expected}")

    v2_cpu = ScoreModel(v2_cfg, sde_kwargs=sde_kwargs, device="cpu")
    v2_cpu.backbone.load_state_dict(v2.backbone.state_dict())
    ref = v2_cpu.enhance(utterances[0][None], utterances[0][None], noise=cpu_noise(torch, 7))
    err = float(np.max(np.abs(v2_out - ref)) / np.max(np.abs(ref)))
    print(f"sebridge_v2 waveform, card vs CPU plain path: max|diff|/max|ref| {err:.3e} "
          f"(tol {WAVEFORM_TOL})")
    if err > WAVEFORM_TOL:
        raise AssertionError(f"sebridge_v2 waveform deviates: {err:.3e}")
    return path, walls


def redraw_snrnet(torch, seed):
    """An SNRNet with every weight drawn from a seeded generator (kernels at
    1/sqrt(fan_in), biases small) and its output bias at SNRNET_FC_BIAS."""
    from diffse_tpu_torch.models.snrnet import SNRNet

    net = SNRNet()
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in net.parameters():
            z = torch.randn(p.shape, generator=g)
            p.copy_(z / p[0].numel() ** 0.5 if p.ndim >= 2 else 0.1 * z)
        net.fc.bias.fill_(SNRNET_FC_BIAS)
    return net.eval()


def snap_margin(est_snr):
    """Relative distance of the unsnapped time from the nearest boundary
    between two points of the Karras grid."""
    from diffse_tpu_torch.models.score_model import T_30_F32

    t_ = np.float32(est_snr) / np.float32(10 ** 0.25 * FIXED_SNR)
    boundaries = (T_30_F32[1:] + T_30_F32[:-1]) / 2
    return float(np.min(np.abs(boundaries - t_)) / t_)


def run_snr_path(torch, ck, dev):
    """Phase 5: sebridge_v3_snr on 3 utterances, then sebridge_v2_snr, each
    held to the CPU. Returns the launch counts of each path."""
    from diffse_tpu_torch.models.score_model import (
        ScoreModel,
        ScoreModelConfig,
        snap_to_karras_grid,
    )

    sde_kwargs = dict(T_sampling=0.999, k=2.6, theta=0.52, N=30)
    snrnet = redraw_snrnet(torch, seed=5)
    pairs = main_path_pairs()
    failures = []

    def model_pair(cfg, seed):
        card = ScoreModel(cfg, sde_kwargs=sde_kwargs, device=dev,
                          snr_model=copy.deepcopy(snrnet))
        redraw_weights(torch, card.backbone, seed=seed)
        cpu = ScoreModel(cfg, sde_kwargs=sde_kwargs, device="cpu",
                         snr_model=copy.deepcopy(snrnet))
        cpu.backbone.load_state_dict(card.backbone.state_dict())
        return card, cpu

    def compare(label, out, ref, length):
        err = float(np.max(np.abs(out - ref)) / np.max(np.abs(ref)))
        print(f"{label} waveform, card vs CPU plain path: max|diff|/max|ref| {err:.3e} "
              f"(tol {WAVEFORM_TOL})")
        if out.shape != (length,) or not np.isfinite(out).all():
            failures.append(f"{label}: bad output, shape {out.shape}")
        if err > WAVEFORM_TOL:
            failures.append(f"{label}: waveform deviates by {err:.3e}")

    v3_cfg = ScoreModelConfig(backbone="ncsnpp", sde="bbed", model_type="sebridge_v3",
                              snr_conditioned="true", fixed_snr=FIXED_SNR, sigma_max=1.0)
    v3, v3_cpu = model_pair(v3_cfg, seed=6)

    # SNRNet and the snap, card against CPU
    t_hats = []
    for i, (_, noisy) in enumerate(pairs):
        est = v3.estimate_snr(noisy[None])[0].item()
        est_cpu = v3_cpu.estimate_snr(noisy[None])[0].item()
        g, g_cpu = est / (1 + est), est_cpu / (1 + est_cpu)  # SNRNet's sigmoid output
        rel = abs(g - g_cpu) / abs(g_cpu)
        t_hat, t_hat_cpu = (snap_to_karras_grid(e, FIXED_SNR)[0] for e in (est, est_cpu))
        margin = snap_margin(est_cpu)
        print(f"utterance {i} ({UTTERANCE_SECONDS[i]} s): SNRNet g_hat {g:.7f} card vs "
              f"{g_cpu:.7f} CPU, rel {rel:.3e} (tol 1e-5); est_snr {est:.6f}; t_hat "
              f"{t_hat:.6f} card, {t_hat_cpu:.6f} CPU; snap margin {margin:.3e}")
        if rel > 1e-5:
            failures.append(f"utterance {i}: SNRNet deviates by {rel:.3e}")
        if margin < SNAP_MARGIN:
            failures.append(f"utterance {i}: the estimate lies within float error of a snap "
                            "boundary; pick another SNRNet seed")
        if t_hat != t_hat_cpu:
            failures.append(f"utterance {i}: t_hat {t_hat} on the card, {t_hat_cpu} on the CPU")
        t_hats.append(float(t_hat))
    spec2 = torch.randn((1, 2, 256, 192), device=dev)  # the 1.5 s utterance, padded to 16
    with torch.no_grad():
        snrnet_ms = median_ms(torch, lambda: v3.snr_model(spec2))
    print(f"SNRNet ({sum(p.numel() for p in snrnet.parameters())} params) at [1,2,256,192]: "
          f"{snrnet_ms:.4f} ms")

    # sebridge_v3_snr: one warm-up call, then the path with fresh counts
    v3.enhance(pairs[0][1][None], pairs[0][1][None], noise=cpu_noise(torch, 9))
    torch.cuda.synchronize()
    walls, outs = [], []
    ck.reset_launch_counts()
    for i, (_, noisy) in enumerate(pairs):
        t0 = time.time()
        outs.append(v3.enhance(noisy[None], noisy[None], noise=cpu_noise(torch, 10 + i)))
        walls.append(time.time() - t0)
    v3_counts = dict(ck.launch_counts)
    for i, (_, noisy) in enumerate(pairs):
        ref = v3_cpu.enhance(noisy[None], noisy[None], noise=cpu_noise(torch, 10 + i))
        print(f"sebridge_v3_snr: {UTTERANCE_SECONDS[i]} s utterance, t_hat {t_hats[i]:.6f}, "
              f"wall {walls[i]:.4f} s")
        compare(f"sebridge_v3_snr utterance {i}", outs[i], ref, len(noisy))
    expected = {"gn_silu_conv3x3": 81 * len(pairs), "groupnorm_silu": 28 * len(pairs),
                "fused_bias_leaky_relu": 0}
    print(f"sebridge_v3_snr launches: {v3_counts} over {len(pairs)} forwards")
    if v3_counts != expected:
        failures.append(f"sebridge_v3_snr launch counts {v3_counts}, expected {expected}")
    del v3, v3_cpu

    # sebridge_v2_snr on the SNR-conditioned NCSN++, with the clean reference
    v2_cfg = ScoreModelConfig(backbone="ncsnpp_snr", sde="bbed", model_type="sebridge_v2",
                              snr_conditioned="true", fixed_snr=FIXED_SNR, sigma_max=0.5)
    v2, v2_cpu = model_pair(v2_cfg, seed=7)
    n_params = sum(p.numel() for p in v2.backbone.parameters())
    clean, noisy = pairs[0]
    v2.enhance(clean[None], noisy[None], noise=cpu_noise(torch, 11))  # warm-up
    torch.cuda.synchronize()
    ck.reset_launch_counts()
    t0 = time.time()
    out = v2.enhance(clean[None], noisy[None], noise=cpu_noise(torch, 12))
    wall = time.time() - t0
    v2_counts = dict(ck.launch_counts)
    ref = v2_cpu.enhance(clean[None], noisy[None], noise=cpu_noise(torch, 12))
    print(f"sebridge_v2_snr ({n_params} params, ncsnpp_snr): {UTTERANCE_SECONDS[0]} s "
          f"utterance, wall {wall:.4f} s, launches {v2_counts}")
    compare("sebridge_v2_snr", out, ref, len(noisy))
    expected = {"gn_silu_conv3x3": 81, "groupnorm_silu": 28, "fused_bias_leaky_relu": 0}
    if v2_counts != expected:
        failures.append(f"sebridge_v2_snr launch counts {v2_counts}, expected {expected}")
    if failures:
        raise AssertionError("; ".join(failures))
    return {"sebridge_v3_snr (eager, caller's noise)": card_runs(v3_counts, []),
            "sebridge_v2_snr (eager, caller's noise)": card_runs(v2_counts, [])}


def count_syncs(torch, fn):
    """``fn()``'s synchronising CUDA operations, counted in "warn" mode."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum("called a synchronizing CUDA operation" in str(w.message) for w in caught)


def sampler_weights(torch):
    """The 65M NCSN++'s weights for phase 5c, redrawn from a seed."""
    from diffse_tpu_torch.models.ncsnpp import NCSNpp

    net = NCSNpp(generator=torch.Generator().manual_seed(0))
    redraw_weights(torch, net, seed=13)
    return net.state_dict()


def sampler_model(torch, weights, sde="bbed", device="cpu", **backbone):
    """A ``model_type="bbed"`` ScoreModel under ``sde`` with ``weights``."""
    from diffse_tpu_torch.models.score_model import ScoreModel, ScoreModelConfig

    cfg = ScoreModelConfig(backbone="ncsnpp", sde=sde, model_type="bbed", snr_conditioned="false")
    model = ScoreModel(cfg, backbone_kwargs=backbone, sde_kwargs=SAMPLER_SDE_KWARGS[sde],
                       device=device, generator=torch.Generator().manual_seed(0))
    model.backbone.load_state_dict(weights)
    return model


def check_recorded(label, program, forwards, failures):
    """A captured program's launches recorded at capture: ``forwards``
    network forwards' worth."""
    want = {"gn_silu_conv3x3": 81 * forwards, "groupnorm_silu": 28 * forwards,
            "fused_bias_leaky_relu": 0}
    if program.launch_counts != want:
        failures.append(f"{label}: launches recorded at capture {program.launch_counts}, "
                        f"expected {want}")


def report_paths(paths, failures):
    for label, path in paths.items():
        print(f"{label}: kernel runs on the card {path['runs']}, recorded at capture "
              f"{path['recorded']}")
        if not path["runs"]["gn_silu_conv3x3"] or not path["runs"]["groupnorm_silu"]:
            failures.append(f"{label}: a kernel of the path never ran: {path['runs']}")


def padded_wave(torch, y):
    """The 1-D waveform ``y`` as ``enhance`` pads it to its width bucket:
    ``(t_pad, [1, samples] CPU tensor)``."""
    import torch.nn.functional as F

    from diffse_tpu_torch.transforms import width_bucket

    t_pad, pad_samples = width_bucket(len(y), 128)
    wave = torch.from_numpy(y[None])
    wave = F.pad(wave, (0, pad_samples - len(y))) if len(y) < pad_samples else wave[:, :pad_samples]
    return t_pad, wave


def sync_free_check(torch, model, y, dev, predictor="reverse_diffusion", corrector="ald",
                    n_steps=30, timestep_type="linear"):
    """``torch.cuda.set_sync_debug_mode("error")`` through the eager
    ``bbed_pc`` device program and a replay of its captured program, on the
    1-D waveform ``y`` (padded to its bucket as ``enhance`` pads it); then the
    synchronising operations of a whole ``enhance``, each way, counted in
    "warn" mode. Returns ``(replay == eager bit for bit, {way: count})``."""
    from diffse_tpu_torch.utils import randn_like, to_device

    sampler = dict(predictor=predictor, corrector=corrector, N=n_steps,
                   timestep_type=timestep_type)
    t_pad, wave = padded_wave(torch, y)
    program = model._enhance_graph("bbed_pc", t_pad, n_steps, predictor, corrector, 1, False,
                                   {"y": wave, "snr": 0.5}, timestep_type=timestep_type)
    gen = torch.Generator(dev).manual_seed(30)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.no_grad():
            tensors = {"y": to_device(wave, dev),
                       "snr": torch.full((), 0.5, dtype=torch.float32, device=dev)}
            eager, _ = model._enhance_on_device(
                "bbed_pc", lambda like: randn_like(like, gen), n_steps, predictor, corrector, 1,
                timestep_type=timestep_type, **tensors)
            graphed, _ = program(torch.Generator(dev).manual_seed(30), y=wave, snr=0.5)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    same = torch.equal(eager, graphed)
    syncs = {}
    for way in ("graphed", "eager"):
        gen = torch.Generator(dev).manual_seed(31)
        kw = (dict(generator=gen) if way == "graphed"
              else dict(noise=lambda like: randn_like(like, gen)))
        syncs[way] = count_syncs(torch, lambda: model.enhance(y[None], y[None], **kw, **sampler))
    return same, syncs


def run_graphs(torch, ck, dev, phase4_walls):
    """Phase 5b: the captured programs against the eager path."""
    from diffse_tpu_torch.models.score_model import ScoreModel, ScoreModelConfig
    from diffse_tpu_torch.utils import randn_like

    sde_kwargs = dict(T_sampling=0.999, k=2.6, theta=0.52, N=30)
    pairs = main_path_pairs()
    failures = []

    def graphed_vs_eager(label, model, seed_base, reference):
        walls = {"graphed": [], "eager": []}
        for i, (_, y) in enumerate(pairs):
            seed = seed_base + i
            programs = len(model._graphs)
            t0 = time.perf_counter()
            _, held = memory_held(torch, lambda: model.enhance(
                y[None], y[None], generator=torch.Generator(dev).manual_seed(seed)))
            first = time.perf_counter() - t0
            if len(model._graphs) > programs:
                print(f"{label}, {UTTERANCE_SECONDS[i]} s utterance: its bucket's first call "
                      f"(eager warm-up, capture, replay) {first:.4f} s; card memory the "
                      f"program keeps {held / 2**20:.1f} MiB (memory_reserved after "
                      "empty_cache, before and after)")
            t0 = time.perf_counter()
            graphed = model.enhance(y[None], y[None],
                                    generator=torch.Generator(dev).manual_seed(seed))
            walls["graphed"].append(time.perf_counter() - t0)
            gen = torch.Generator(dev).manual_seed(seed)
            t0 = time.perf_counter()
            eager = model.enhance(y[None], y[None], noise=lambda like: randn_like(like, gen))
            walls["eager"].append(time.perf_counter() - t0)
            err = float(np.max(np.abs(graphed - eager)) / np.max(np.abs(eager)))
            bitwise = bool(np.array_equal(graphed, eager))
            print(f"{label}, {UTTERANCE_SECONDS[i]} s utterance: graphed vs eager, same generator "
                  f"state: max|diff|/max|eager| {err:.3e} (tol {GRAPH_TOL}), bitwise equal "
                  f"{bitwise}; wall graphed {walls['graphed'][-1]:.4f} s, eager "
                  f"{walls['eager'][-1]:.4f} s ({reference[i]})")
            if err > GRAPH_TOL or not np.isfinite(graphed).all() or graphed.shape != y.shape:
                failures.append(f"{label} utterance {i}: graphed deviates by {err:.3e}")
        return walls

    paths = {}
    bbed = ScoreModel(ScoreModelConfig(backbone="ncsnpp", sde="bbed", model_type="bbed",
                                       snr_conditioned="false", sigma_max=0.5),
                      sde_kwargs=sde_kwargs, device=dev,
                      generator=torch.Generator().manual_seed(0))
    ck.reset_launch_counts()
    graphed_vs_eager("bbed_pc", bbed, 20, [f"phase 4: {w:.3f} s" for w in phase4_walls]
                     or ["phase 4: not run"] * len(pairs))
    same, syncs = sync_free_check(torch, bbed, pairs[0][1], dev)
    print(f"bbed_pc under torch.cuda.set_sync_debug_mode('error'): the eager device program and "
          f"a replay ran without a synchronisation; equal bit for bit {same}. Synchronising "
          f"operations in a whole enhance ('warn' mode): {syncs} (the copy of the result to the "
          "host is one)")
    if any(n > 1 for n in syncs.values()):
        failures.append(f"enhance synchronises more than once: {syncs}")
    paths["bbed_pc (graphed and eager)"] = card_runs(
        dict(ck.launch_counts), [p for _, p in bbed._graphs.values()])
    del bbed

    v3_cfg = ScoreModelConfig(backbone="ncsnpp", sde="bbed", model_type="sebridge_v3",
                              snr_conditioned="true", fixed_snr=FIXED_SNR, sigma_max=1.0)
    v3 = ScoreModel(v3_cfg, sde_kwargs=sde_kwargs, device=dev, snr_model=redraw_snrnet(torch, 5))
    redraw_weights(torch, v3.backbone, seed=6)
    ck.reset_launch_counts()
    lo, hi = EAGER_1NFE_WALLS
    graphed_vs_eager("sebridge_v3_snr", v3, 40,
                     [f"eager {lo}-{hi} s in earlier runs"] * len(pairs))
    print(f"sebridge_v3_snr programs: {sorted(k.t_pad for k in v3._graphs)} frames, launches "
          f"recorded at capture {[p.launch_counts for _, p in v3._graphs.values()]}")
    for _, program in v3._graphs.values():
        if program.launch_counts != {"gn_silu_conv3x3": 81, "groupnorm_silu": 28,
                                     "fused_bias_leaky_relu": 0}:
            failures.append(f"sebridge_v3_snr program recorded {program.launch_counts}")
    paths["sebridge_v3_snr (graphed and eager)"] = card_runs(
        dict(ck.launch_counts), [p for _, p in v3._graphs.values()])
    report_paths(paths, failures)
    if failures:
        raise AssertionError("; ".join(failures))
    return paths


def ode_eager(torch, model, noise, wave, n_steps=30):
    """``bbed_ode`` op by op, as ``enhance`` runs it with a caller's noise,
    on the padded ``[1, samples]`` waveform: ``(waveform on the model's
    device, [done, nfev, attempts, status])``."""
    with torch.no_grad():
        carry = model._ode_start(noise, n_steps, wave.to(model.device))
        while not carry["flags"][0]:
            carry = model._ode_attempt(n_steps, carry)
        out = model._ode_finish(noise, n_steps, carry)
    return out, carry["flags"].tolist()


def std_float64(sde, t):
    """The SDE's marginal std at ``t`` in float64 (scipy's Ei for BBED and
    PROPOSED_1's closed form)."""
    import math

    import torch
    from scipy.special import expi

    if not hasattr(sde, "Tc"):  # OUVE: no Ei
        return sde._std(torch.full((1,), t, dtype=torch.float64)).item()
    if hasattr(sde, "k"):
        scale, ratio, amp = 1.0, sde.k, sde.k
    else:
        scale, ratio, amp = sde.sigma_min ** 2, sde.ratio, sde.sigma_max
    log_r = math.log(ratio)
    eis = expi(2 * (t - 1) * log_r) - expi(-2 * log_r)
    var = scale * (ratio ** (2 * t) - 1 + t) + 2 * amp ** 2 * log_r * (1 - t) * eis
    return math.sqrt(var * (1 - t) * sde.theta)


def run_samplers(torch, ck, dev):
    """Phase 5c: the samplers beside the main path's, then ``bbed_ode``.
    Returns the float32 paths' and the bf16 path's kernel runs."""
    weights = sampler_weights(torch)
    paths, bf16_paths = run_pc_samplers(torch, ck, dev, weights)
    paths.update(run_ode(torch, ck, dev, weights))
    return paths, bf16_paths


def run_pc_samplers(torch, ck, dev, weights):
    """Phase 5c, the PC samplers: rd_ald_logit_N20 graphed vs eager in
    float32 and bf16; each new name card vs CPU; the sync checks."""
    from diffse_tpu_torch.utils import randn_like

    failures, paths = [], {}
    by_seconds = dict(zip(UTTERANCE_SECONDS, [noisy for _, noisy in main_path_pairs()]))

    def model_for(sde="bbed", device=dev, **backbone):
        return sampler_model(torch, weights, sde, device, **backbone)

    # 1. rd_ald_logit_N20, the certified serving sampler, graphed vs eager
    bf16_runs = None
    for trunk, backbone in (("float32", {}), ("bf16", dict(dtype="bf16", fuse_pyramid=True))):
        model = model_for(**backbone)
        ck.reset_launch_counts()
        for seconds in SERVING_SECONDS:
            y = by_seconds[seconds][None]
            t0 = time.perf_counter()
            (out, nfe, _), held = memory_held(torch, lambda: model.enhance(
                y, y, generator=torch.Generator(dev).manual_seed(50), timeit=True,
                **SERVING_SAMPLER))
            first = time.perf_counter() - t0
            t0 = time.perf_counter()
            graphed = model.enhance(y, y, generator=torch.Generator(dev).manual_seed(51),
                                    **SERVING_SAMPLER)
            wall = time.perf_counter() - t0
            gen = torch.Generator(dev).manual_seed(51)
            t0 = time.perf_counter()
            eager = model.enhance(y, y, noise=lambda like: randn_like(like, gen),
                                  **SERVING_SAMPLER)
            eager_wall = time.perf_counter() - t0
            err = float(np.max(np.abs(graphed - eager)) / np.max(np.abs(eager)))
            bitwise = bool(np.array_equal(graphed, eager))
            print(f"rd_ald_logit_N20, {trunk} trunk, {seconds} s utterance: nfe {nfe}; first call "
                  f"(eager warm-up, capture, replay) {first:.4f} s, card memory the program keeps "
                  f"{held / 2**20:.1f} MiB; replay wall {wall:.4f} s, eager {eager_wall:.4f} s; "
                  f"graphed vs eager, same generator state: max|diff|/max|eager| {err:.3e} (tol "
                  f"{GRAPH_TOL}), bitwise equal {bitwise}; output finite "
                  f"{bool(np.isfinite(graphed).all())}, peak {np.max(np.abs(graphed)):.4f}")
            if nfe != 40 or err > GRAPH_TOL or not np.isfinite(graphed).all():
                failures.append(f"rd_ald_logit_N20 {trunk} {seconds} s: nfe {nfe}, graphed vs "
                                f"eager {err:.3e}, finite {bool(np.isfinite(graphed).all())}")
        programs = [p for _, p in model._graphs.values()]
        for program in programs:
            check_recorded(f"rd_ald_logit_N20 {trunk}", program, 40, failures)
        path = card_runs(dict(ck.launch_counts), programs)
        if trunk == "float32":
            paths["rd_ald_logit_N20 (graphed and eager)"] = path
        else:
            window = list(ck.conv_config_launches)
            runs = [w + sum(p.conv_config_launches[i] * (p.replays - 1) for p in programs)
                    for i, w in enumerate(window)]
            recorded = [sum(p.conv_config_launches[i] for p in programs)
                        for i in range(len(window))]
            bf16_runs = {"runs": {**path["runs"], **conv_launches(ck, runs)},
                         "recorded": {**path["recorded"], **conv_launches(ck, recorded)}}
        del model, programs

    # 2. each new name, the card against the CPU, eager, the same draws
    y = by_seconds[SAMPLER_SECONDS][None]
    ck.reset_launch_counts()
    for sde in sorted({case[0] for case in SAMPLER_CASES}):
        card, cpu = model_for(sde), model_for(sde, device="cpu")
        floor = torch.full((1,), 1e-5)
        std_card, std_cpu = card.sde._std(floor.to(dev)).item(), cpu.sde._std(floor).item()
        print(f"{sde}: marginal std at t = 1e-5 {std_card!r} card, {std_cpu!r} CPU (rel "
              f"{abs(std_card - std_cpu) / std_cpu:.3e}); float64 {std_float64(cpu.sde, 1e-5)!r}")
        for i, (_, predictor, corrector, grid, n) in enumerate(
                c for c in SAMPLER_CASES if c[0] == sde):
            kw = dict(predictor=predictor, corrector=corrector, N=n, timestep_type=grid,
                      timeit=True)
            t0 = time.perf_counter()
            out, nfe, _ = card.enhance(y, y, noise=cpu_noise(torch, 60 + i), **kw)
            wall = time.perf_counter() - t0
            ref, nfe_ref, _ = cpu.enhance(y, y, noise=cpu_noise(torch, 60 + i), **kw)
            err = float(np.max(np.abs(out - ref)) / np.max(np.abs(ref)))
            label = f"{sde} {predictor} + {corrector}, {grid} grid, N = {n}"
            tol = (EXP_SAMPLER_TOL if sde == "bbed" and predictor.startswith("exp_")
                   else SAMPLER_TOL)
            print(f"{label}: nfe {nfe} (CPU {nfe_ref}); card vs CPU max|diff|/max|ref| {err:.3e} "
                  f"(tol {tol}); card wall (eager) {wall:.4f} s; finite "
                  f"{bool(np.isfinite(out).all())}, peak {np.max(np.abs(out)):.4f}")
            if nfe != nfe_ref or err > tol or not np.isfinite(out).all():
                failures.append(f"{label}: card vs CPU {err:.3e}, nfe {nfe} vs {nfe_ref}")
        del card, cpu
    paths["samplers card vs CPU (eager)"] = card_runs(dict(ck.launch_counts), [])

    # 3. heun's Euler fallback and the exponential predictors' std tables:
    # no host synchronisation, eager or replayed
    model = model_for()
    ck.reset_launch_counts()
    for predictor, corrector, grid in SYNC_FREE_CASES:
        same, syncs = sync_free_check(torch, model, by_seconds[SAMPLER_SECONDS], dev,
                                      predictor, corrector, 4, grid)
        print(f"{predictor} + {corrector}, {grid} grid, N = 4, under "
              f"torch.cuda.set_sync_debug_mode('error'): the eager device program and a replay "
              f"ran without a synchronisation; equal bit for bit {same}. Synchronising "
              f"operations in a whole enhance ('warn' mode): {syncs}")
        if any(n > 1 for n in syncs.values()) or not same:
            failures.append(f"{predictor} + {corrector}: syncs {syncs}, replay == eager {same}")
    paths["samplers sync checks (graphed and eager)"] = card_runs(
        dict(ck.launch_counts), [p for _, p in model._graphs.values()])
    del model
    report_paths(paths, failures)
    if failures:
        raise AssertionError("; ".join(failures))
    return paths, {"rd_ald_logit_N20 bf16 (graphed and eager)": bf16_runs}


def run_ode(torch, ck, dev, weights):
    """Phase 5c, ``bbed_ode``: the captured steps vs eager on the card, the
    card vs the CPU, the host reads."""
    from diffse_tpu_torch.utils import randn_like

    failures, paths = [], {}
    by_seconds = dict(zip(UTTERANCE_SECONDS, [noisy for _, noisy in main_path_pairs()]))
    model = sampler_model(torch, weights, device=dev)
    y = by_seconds[ODE_SECONDS][None]
    t_pad, _ = padded_wave(torch, y[0])
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    (out, nfev, _), held = memory_held(torch, lambda: model.enhance(
        y, y, generator=torch.Generator(dev).manual_seed(70), sampler_type="ode", timeit=True))
    first = time.perf_counter() - t0
    program = next(p for k, (_, p) in model._graphs.items() if k.branch == "bbed_ode")
    t0 = time.perf_counter()
    graphed, nfev, _ = model.enhance(y, y, generator=torch.Generator(dev).manual_seed(71),
                                     sampler_type="ode", timeit=True)
    wall = time.perf_counter() - t0
    flags, reads = list(program.flags), program.reads
    gen = torch.Generator(dev).manual_seed(71)
    t0 = time.perf_counter()
    eager, nfev_eager, _ = model.enhance(y, y, noise=lambda like: randn_like(like, gen),
                                         sampler_type="ode", timeit=True)
    eager_wall = time.perf_counter() - t0
    err = float(np.max(np.abs(graphed - eager)) / np.max(np.abs(eager)))
    bitwise = bool(np.array_equal(graphed, eager))
    syncs = count_syncs(torch, lambda: model.enhance(
        y, y, generator=torch.Generator(dev).manual_seed(71), sampler_type="ode"))
    program.steps_per_read = 4
    again = model.enhance(y, y, generator=torch.Generator(dev).manual_seed(71),
                          sampler_type="ode")
    reads4, flags4 = program.reads, list(program.flags)
    program.steps_per_read = 1
    print(f"bbed_ode (rtol = atol = 1e-5), {ODE_SECONDS} s utterance ({t_pad} frames): nfev "
          f"{nfev}, attempts {flags[2]}, status {flags[3]}; first call (warm-up and capture of "
          f"three programs, then a run) {first:.4f} s, card memory they keep "
          f"{held / 2**20:.1f} MiB; graphed wall {wall:.4f} s with {reads} host reads of the "
          f"done flag ({syncs} synchronising operations in a whole enhance, the final copy "
          f"among them), eager wall {eager_wall:.4f} s (nfev {nfev_eager}); graphed vs eager, "
          f"same generator state: max|diff|/max|eager| {err:.3e} (tol {GRAPH_TOL}), bitwise "
          f"equal {bitwise}; 4 attempts a read: {reads4} reads, flags {flags4}, bitwise equal "
          f"{bool(np.array_equal(again, graphed))}; launches recorded at capture "
          f"{[p.launch_counts for p in program.programs]}")
    if (nfev != nfev_eager or err > GRAPH_TOL or flags4 != flags or not np.isfinite(graphed).all()
            or not np.array_equal(again, graphed) or syncs > reads + 1 or flags[3] != 0):
        failures.append(f"bbed_ode graphed: nfev {nfev} vs eager {nfev_eager}, deviates "
                        f"{err:.3e}, flags {flags} vs {flags4} at 4 attempts a read, syncs "
                        f"{syncs} for {reads} reads")
    for sub, forwards in zip(program.programs, (2, 6, 1)):
        check_recorded("bbed_ode", sub, forwards, failures)
    paths["bbed_ode (graphed and eager)"] = card_runs(dict(ck.launch_counts), program.programs)
    del model, program

    scaled = dict(weights)
    for name in ("output_layer.weight", "output_layer.bias"):
        scaled[name] = weights[name] * ODE_CPU_OUTPUT_SCALE
    card = sampler_model(torch, scaled, device=dev)
    cpu = sampler_model(torch, scaled)
    t_pad, wave = padded_wave(torch, y[0, :ODE_CPU_SAMPLES])
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    out, flags = ode_eager(torch, card, cpu_noise(torch, 72), wave)
    card_wall = time.perf_counter() - t0
    paths["bbed_ode card vs CPU (eager)"] = card_runs(dict(ck.launch_counts), [])
    t0 = time.perf_counter()
    ref, flags_cpu = ode_eager(torch, cpu, cpu_noise(torch, 72), wave)
    cpu_wall = time.perf_counter() - t0
    out, ref = out.cpu().numpy(), ref.numpy()
    err = float(np.max(np.abs(out - ref)) / np.max(np.abs(ref)))
    print(f"bbed_ode card vs CPU, {t_pad} frames, output layer x {ODE_CPU_OUTPUT_SCALE}, the "
          f"same draws: flags [done, nfev, attempts, status] {flags} card, {flags_cpu} CPU; "
          f"waveform max|diff|/max|ref| {err:.3e} (tol {ODE_WAVEFORM_TOL}); eager wall "
          f"{card_wall:.3f} s card, {cpu_wall:.3f} s CPU")
    if flags != flags_cpu:
        failures.append(f"bbed_ode: an accept/reject flip between card and CPU: flags {flags} "
                        f"vs {flags_cpu}")
    elif err > ODE_WAVEFORM_TOL:
        failures.append(f"bbed_ode: the card's waveform deviates from the CPU's by {err:.3e}")
    report_paths(paths, failures)
    if failures:
        raise AssertionError("; ".join(failures))
    return paths


def relative_gap(out, ref):
    """max |out - ref| / max |ref|, on the CPU."""
    out, ref = out.detach().cpu(), ref.detach().cpu()
    return ((out - ref).abs().max() / ref.abs().max()).item()


def check_bf16_forward(torch, ck, dev):
    """Phase 7: the 65M bf16 NCSN++ at B=1, T=64, card vs CPU and vs the
    float32 forward on the card. Returns the launch counts per forward."""
    from diffse_tpu_torch.models import layers
    from diffse_tpu_torch.models.ncsnpp import NCSNpp

    rng = np.random.default_rng(12)
    shape = (1, 2, 256, BENCH_FRAMES)
    x = torch.from_numpy((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
                         .astype(np.complex64))
    t = torch.tensor([0.5])
    xd, td = x.to(dev), t.to(dev)
    failures, counts = [], None
    for label, redraw in (("redrawn weights", True), ("own initialisation", False)):
        model = NCSNpp(dtype="bf16", fuse_pyramid=True, generator=torch.Generator().manual_seed(8))
        if redraw:
            redraw_weights(torch, model, seed=9)
        cpu = copy.deepcopy(model).eval()
        f32 = NCSNpp(generator=torch.Generator().manual_seed(8))
        f32.load_state_dict(model.state_dict())
        f32 = f32.to(dev).eval()
        card = model.to(dev).eval()
        records, hooks = [], []
        if redraw:  # every block, attention and Combine's inputs and output
            for i, m in enumerate(card.all_modules):
                if isinstance(m, (layers.ResnetBlockBigGANpp, layers.AttnBlockpp, layers.Combine)):
                    hooks.append(m.register_forward_hook(
                        lambda mod, args, out, i=i: records.append((i, args, out))))
        with torch.no_grad():
            ck.reset_launch_counts()
            out16 = card(xd, td)
            torch.cuda.synchronize()
            counts = dict(ck.launch_counts)
            first_casts = dict(ck.weight_casts)
            for hook in hooks:
                hook.remove()
            ck.reset_launch_counts()  # the next forward: no cast, and which kernels ran
            card(xd, td)
            torch.cuda.synchronize()
            casts, by_config = dict(ck.weight_casts), list(ck.conv_config_launches)
            if counts != dict(ck.launch_counts):
                failures.append(f"{label}: launches {dict(ck.launch_counts)} in the second forward")
            out32 = f32(xd, td)
            ref = cpu(x, t)
            ms16 = median_ms(torch, lambda: card(xd, td), reps=5, warmup=1)
            ms32 = median_ms(torch, lambda: f32(xd, td), reps=5, warmup=1)
            worst_share, worst_ulps = 0.0, 0.0  # share beyond one of its own ulps
            for i, args, out in records:
                mref = cpu.all_modules[i](*[a.cpu() if torch.is_tensor(a) else a for a in args])
                diff = (out.cpu().double() - mref.double()).abs()
                spacing = torch.exp2(torch.floor(torch.log2(
                    mref.double().abs().clamp_min(2.0 ** -126))) - 7)
                top = torch.exp2(torch.floor(torch.log2(mref.double().abs().max())) - 7)
                share, ulps = (diff > spacing).double().mean().item(), (diff.max() / top).item()
                worst_share, worst_ulps = max(worst_share, share), max(worst_ulps, ulps)
                if ulps > BF16_MODULE_ULPS or out.dtype != torch.bfloat16:
                    failures.append(f"module {i} ({type(cpu.all_modules[i]).__name__}): share "
                                    f"{share:.2e} beyond 1 ulp, {ulps:.2f} ulps at its max, "
                                    f"{out.dtype}")
        gap_cpu, gap_f32 = relative_gap(out16, ref), relative_gap(out16, out32)
        ratio, limit = gap_cpu / gap_f32, BF16_GAP_RATIO
        print(f"bf16 NCSN++ forward ({label}, F=256 T={BENCH_FRAMES}): card vs CPU "
              f"max|diff|/max|ref| {gap_cpu:.3e}; bf16 vs float32 on the card {gap_f32:.3e}; "
              f"ratio {ratio:.3f} (limit {limit:.3f}); forward {ms16:.2f} ms bf16, {ms32:.2f} ms "
              f"float32 on the card; launches per forward {counts}, by instantiation "
              f"{dict(zip(CONV_NAMES, by_config))}; bf16 weight casts: {first_casts} in the "
              f"first forward, {casts} in the next")
        if records:
            print(f"  {len(records)} modules of the card's forward run on the CPU from the card's "
                  f"inputs: worst error {worst_ulps:.2f} bf16 ulps of the module's largest "
                  f"output (limit {BF16_MODULE_ULPS}); worst share of elements beyond one of "
                  f"their own ulps {worst_share:.2e}")
        if out16.dtype != torch.complex64 or not torch.isfinite(torch.view_as_real(out16)).all():
            failures.append(f"{label}: output {out16.dtype}, not finite or not complex64")
        if ratio > limit:
            failures.append(f"{label}: card vs CPU {gap_cpu:.3e} is {ratio:.3f} of the bf16 gap")
        if counts != {"gn_silu_conv3x3": 81, "groupnorm_silu": 28, "fused_bias_leaky_relu": 0}:
            failures.append(f"{label}: launch counts per forward {counts}, expected 81 and 28")
        if any(casts.values()) or not all(first_casts.values()):
            failures.append(f"{label}: {first_casts} bf16 weight casts in the first forward, "
                            f"{casts} in the next (expected some of each kind, then none)")
        if by_config[ck.CONV_WGMMA_SS] == 0:
            failures.append(f"{label}: the wgmma.ss kernel did not run")
        del card, cpu, f32, records
    if failures:
        raise AssertionError("; ".join(failures))
    return card_runs({**counts, **conv_launches(ck, by_config)}, [])


def conv_launches(ck, by_config):
    """gn_silu_conv3x3's bf16 launches split between the wgmma.ss kernel and
    the other instantiations, from ``conv_config_launches``."""
    ws = by_config[ck.CONV_WGMMA_SS]
    return {"gn_silu_conv3x3_ws": ws, "gn_silu_conv3x3_other": sum(by_config) - ws}


def run_bf16_program(torch, ck, dev):
    """Phase 8: bench.py's batch-16 program with the bf16 and the float32
    trunk, each captured as one program and replayed. Returns the bf16
    run's launch counts."""
    from torch.profiler import ProfilerActivity, profile

    from diffse_tpu_torch.capture import Program
    from diffse_tpu_torch.models.score_model import ScoreModel, ScoreModelConfig
    from diffse_tpu_torch.profiling import device_breakdown, format_breakdown
    from diffse_tpu_torch.sampling import get_pc_sampler
    from diffse_tpu_torch.transforms import pad_spec, spec_fwd
    from diffse_tpu_torch.utils import randn_like

    cfg = ScoreModelConfig(backbone="ncsnpp", sde="bbed", model_type="bbed",
                           snr_conditioned="false", sigma_max=0.5)
    sde_kwargs = dict(T_sampling=0.999, k=2.6, theta=0.52, N=BENCH_STEPS)
    models = {name: ScoreModel(cfg, backbone_kwargs=kw, sde_kwargs=sde_kwargs, device=dev,
                               generator=torch.Generator().manual_seed(0))
              for name, kw in (("bf16", dict(dtype="bf16", fuse_pyramid=True)),
                               ("float32", {}))}
    models["float32"].backbone.load_state_dict(models["bf16"].backbone.state_dict())
    audio_len = (BENCH_FRAMES - 1) * cfg.hop_length
    y = torch.from_numpy((np.random.default_rng(0).standard_normal((BENCH_BATCH, audio_len))
                          * 0.1).astype(np.float32)).to(dev)

    @torch.no_grad()
    def program(model, gen, y, snr):
        norm = torch.max(torch.abs(y), dim=-1, keepdim=True).values
        Y = pad_spec(spec_fwd(model._stft(y / norm), model.spec_cfg)[:, None])
        sampler = get_pc_sampler("reverse_diffusion", "ald", sde=model.sde,
                                 score_fn=model.forward, Y=Y,
                                 noise=lambda like: randn_like(like, gen), eps=cfg.t_eps,
                                 snr=snr, corrector_steps=1)
        sample, _ = sampler()
        return model.to_audio(sample[:, 0]) * norm

    outs, counts, failures = {}, {}, []
    expected = {"gn_silu_conv3x3": 81 * 2 * BENCH_STEPS, "groupnorm_silu": 28 * 2 * BENCH_STEPS,
                "fused_bias_leaky_relu": 0}
    snr = torch.full((), 0.5, dtype=torch.float32, device=dev)
    for name, model in models.items():
        ck.reset_launch_counts()
        t0 = time.perf_counter()
        captured, held = memory_held(torch, lambda model=model: Program(
            lambda gen, y, snr: program(model, gen, y, snr), {"y": y, "snr": 0.5}, dev))
        capture_s = time.perf_counter() - t0
        outs[name] = captured(torch.Generator(dev).manual_seed(2), y=y, snr=0.5).clone()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        captured(torch.Generator(dev).manual_seed(3), y=y, snr=0.5)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            captured(torch.Generator(dev).manual_seed(4), y=y, snr=0.5)
            torch.cuda.synchronize()
            wall_profiled = time.perf_counter() - t0
        # through the wrappers: the warm-up run and the capture; on the card:
        # the warm-up run and the replays
        counts[name], window_by_config = dict(ck.launch_counts), list(ck.conv_config_launches)
        casts, by_config = dict(ck.weight_casts), captured.conv_config_launches
        path = card_runs(counts[name], [captured])
        breakdown = device_breakdown(prof)
        device_s, launches = breakdown["total_us"] / 1e6, breakdown["launches"]
        gen = torch.Generator(dev).manual_seed(2)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        allocated = torch.cuda.memory_allocated()
        program(model, gen, y, snr)  # a warm eager run
        torch.cuda.synchronize()
        eager_peak = torch.cuda.max_memory_allocated() - allocated
        gen = torch.Generator(dev).manual_seed(2)
        t0 = time.perf_counter()
        eager = program(model, gen, y, snr)
        torch.cuda.synchronize()
        eager_wall = time.perf_counter() - t0
        out = outs[name]
        err = relative_gap(out, eager)
        bitwise = torch.equal(out, eager)
        finite = bool(torch.isfinite(out).all())
        # device time and wall of the same (profiled) replay
        idle = (f"{1 - device_s / wall_profiled:.3f}" if device_s > 0
                else "not measured (the profiler recorded no device time)")
        wall0, device0, idle0, launches0 = EAGER_BF16_EARLIER
        print(f"bench program, {name} trunk, captured: {BENCH_BATCH} x {BENCH_FRAMES} frames, "
              f"{2 * BENCH_STEPS} forwards: capture (warm-up run + capture) {capture_s:.3f} s, "
              f"card memory the program keeps {held / 2**20:.1f} MiB (the eager program's peak "
              f"allocation {eager_peak / 2**20:.1f} MiB); "
              f"wall per batch {wall:.3f} s ({BENCH_BATCH * audio_len / SR / wall:.2f} s of audio "
              f"per s), eager {eager_wall:.3f} s; profiled replay: wall {wall_profiled:.3f} s, "
              f"device kernel time {device_s:.3f} s, idle share {idle}; {launches} device kernel "
              f"launches; graphed vs eager, same generator state: max|diff|/max|eager| {err:.3e} "
              f"(tol {GRAPH_TOL}), bitwise equal {bitwise}; wrapper launches recorded at capture "
              f"{captured.launch_counts}, conv by instantiation "
              f"{dict(zip(CONV_NAMES, by_config))}; weight casts during the capture "
              f"{captured.weight_casts}, after it {casts} (the warm-up's: "
              f"{ {k: v - captured.weight_casts[k] for k, v in casts.items()} }); output "
              f"{tuple(out.shape)} finite {finite}"
              + (f"; eager bf16 program of an earlier run (PERF.md): wall {wall0} s, device "
                 f"{device0} s, idle {idle0}, {launches0} launches" if name == "bf16" else ""))
        if name == "bf16":
            lines = [f"bench program, bf16 trunk, captured: device time by kernel family "
                     f"({device_s:.3f} s in all):"] + format_breakdown(breakdown, top=8)
            print("\n".join(lines))
        if tuple(out.shape) != (BENCH_BATCH, audio_len) or not finite:
            failures.append(f"{name}: output {tuple(out.shape)}, finite {finite}")
        if err > GRAPH_TOL:
            failures.append(f"{name}: the replay deviates from the eager program by {err:.3e}")
        if any(captured.weight_casts.values()):
            failures.append(f"{name}: weight casts during the capture {captured.weight_casts}")
        if captured.launch_counts != expected:
            failures.append(f"{name}: launch counts recorded at capture {captured.launch_counts}, "
                            f"expected {expected}")
        if counts[name] != {k: 2 * v for k, v in expected.items()}:
            failures.append(f"{name}: wrapper launches {counts[name]} over the warm-up and the "
                            "capture, expected twice the program's")
        if name == "bf16":
            runs_by_config = [w + r * (captured.replays - 1)
                              for w, r in zip(window_by_config, by_config)]
            bf16_path = {"runs": {**path["runs"], **conv_launches(ck, runs_by_config)},
                         "recorded": {**path["recorded"], **conv_launches(ck, by_config)}}
            print(f"bench program, bf16 trunk: kernel runs on the card over the warm-up and "
                  f"{captured.replays} replays {bf16_path['runs']}, recorded at capture "
                  f"{bf16_path['recorded']}")
            if by_config[ck.CONV_WGMMA_SS] == 0:
                failures.append("bf16: the wgmma.ss kernel did not run")
        del captured
    gap = relative_gap(outs["bf16"], outs["float32"])
    print(f"bench program: bf16 vs float32 trunk, same weights and noise draws: "
          f"max|diff|/max|ref| {gap:.3e}")
    if failures:
        raise AssertionError("; ".join(failures))
    return bf16_path


@contextlib.contextmanager
def plain_versions(ck):
    """Inside the block every wrapper of ``cuda_kernels`` takes its plain
    version, on the card too: the kernel path's yardstick."""
    dispatch = ck._dispatch_device
    ck._dispatch_device = lambda name, x: False
    try:
        yield
    finally:
        ck._dispatch_device = dispatch


def gradient_scale(grads, name):
    """A parameter's gradient error is measured against the gradient's
    largest magnitude; for an attention's key bias (``NIN_1.b``), whose
    gradient is zero but for rounding (the softmax is unchanged by a shift
    common to all keys), that of the key weight (``NIN_1.W``)."""
    if name.endswith("NIN_1.b"):
        name = name[:-1] + "W"
    return grads[name].abs().max().item()


def conv_backward_bounds(b, h, w, cin, cout, skip):
    """The op's backward (the recompute): the forward conv again, its dgrad
    and its wgrad, each in 3xTF32 on the tensor cores; ~21 operations per
    input element (statistics, affine and SiLU again, and their backward) and
    3 per output element in float32; bytes: x, grad_out, the weights, the
    GroupNorm parameters, the bias and the skip read once, and each of their
    gradients written once."""
    matmul, _, _ = conv_work(b, h, w, cin, cout, skip)
    other = 21 * b * h * w * cin + 3 * b * h * w * cout
    act_in, act_out = b * h * w * cin, b * h * w * cout
    nbytes = 4 * (2 * act_in + (3 if skip else 1) * act_out
                  + 2 * (9 * cin * cout + 2 * cin + cout))
    return bound_of(3 * 3 * matmul / TF32_FLOPS + other / F32_FLOPS, nbytes)


def bound_of(op_seconds, nbytes):
    """``(ms, "bytes" | "operations")`` from the operations' time and the bytes."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, op_seconds * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def check_train_kernels(torch, ck, dev):
    """Phase 9, first part: each op's forward (the kernel) and gradients
    (the recompute) against the plain version under autograd, on the card at
    the training shapes, for the loss sum(out^2) (whose gradient depends on
    the forward); the times of the op's backward beside its bound and the
    plain version's backward. Returns the rows printed, by kernel."""
    from diffse_tpu_torch.utils import queued_ms

    rng = np.random.default_rng(5)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev).requires_grad_()

    failures, rows = [], {"gn_silu_conv3x3": [], "groupnorm_silu": []}

    def compare(name, run_op, run_plain, leaves, bound_ms, bound_by):
        out_k = run_op()
        grads_k = torch.autograd.grad((out_k * out_k).sum(), leaves)
        out_p = run_plain()
        grads_p = torch.autograd.grad((out_p * out_p).sum(), leaves)
        torch.cuda.synchronize()
        err = (out_k - out_p).abs().max().item()
        ok = torch.allclose(out_k, out_p, **KERNEL_TOL)
        grad_errs = [((gk - gp).abs().max() / gp.abs().max()).item()
                     for gk, gp in zip(grads_k, grads_p)]
        ok = ok and max(grad_errs) <= TRAIN_KERNEL_GRAD_TOL
        # the backward alone, from a graph kept for the repeats
        out_k, out_p = run_op(), run_plain()
        go = (2 * out_k).detach()
        backward = {
            "ms": median_ms(torch, lambda: torch.autograd.grad(out_k, leaves, go,
                                                               retain_graph=True)),
            "device_ms": queued_ms(lambda: torch.autograd.grad(out_k, leaves, go,
                                                               retain_graph=True)),
            "plain_ms": median_ms(torch, lambda: torch.autograd.grad(out_p, leaves, go,
                                                                     retain_graph=True)),
            "plain_device_ms": queued_ms(lambda: torch.autograd.grad(out_p, leaves, go,
                                                                     retain_graph=True))}
        with torch.no_grad():
            fwd = {"ms": median_ms(torch, run_op), "device_ms": queued_ms(run_op)}
        print(f"{name}: forward max_abs_err {err:.3e}, gradients' max error of their largest "
              f"magnitude {max(grad_errs):.3e} (tol {TRAIN_KERNEL_GRAD_TOL}) ok {ok} | forward "
              f"(kernel) {fwd['ms']:.4f} ms (queued {fwd['device_ms']:.4f}) | backward "
              f"(recompute) {backward['ms']:.4f} ms (queued {backward['device_ms']:.4f}), the "
              f"plain version's backward {backward['plain_ms']:.4f} ms (queued "
              f"{backward['plain_device_ms']:.4f}), bound {bound_ms:.4f} ms ({bound_by})")
        if not ok:
            failures.append(name)
        return {"name": name, "forward": fwd, "backward": backward, "bound_ms": bound_ms,
                "bound_by": bound_by, "max_abs_err": err, "grad_err": max(grad_errs)}

    for b, h, w, cin, cout, skip in TRAIN_CONV_SHAPES:
        x = t(rng.standard_normal((b, h, w, cin)))
        gs, gb = t(1 + 0.1 * rng.standard_normal(cin)), t(0.1 * rng.standard_normal(cin))
        wk = t(rng.standard_normal((3, 3, cin, cout)) / np.sqrt(9 * cin))
        bias = t(0.1 * rng.standard_normal(cout))
        sk = t(rng.standard_normal((b, h, w, cout))) if skip else None
        groups, coef = min(cin // 4, 32), (1 / np.sqrt(2.0) if skip else 1.0)
        bt = bias[None].expand(b, cout)
        leaves = [x, gs, gb, wk, bias] + ([sk] if skip else [])
        args = (x, gs, gb, wk, bt, groups, 1e-6, sk, coef)
        bound_ms, bound_by = conv_backward_bounds(b, h, w, cin, cout, skip)
        rows["gn_silu_conv3x3"].append(compare(
            f"gn_silu_conv3x3 op {[b, h, w, cin]}->{cout}{' +skip' if skip else ''}",
            lambda: ck.groupnorm_silu_conv3x3_op(*args),
            lambda: ck.groupnorm_silu_conv3x3_reference(*args), leaves, bound_ms, bound_by))
    for shape in TRAIN_GN_SHAPES:
        c = shape[-1]
        x = t(2 * rng.standard_normal(shape) + 1)
        sc, bi = t(1 + 0.1 * rng.standard_normal(c)), t(0.1 * rng.standard_normal(c))
        groups = min(c // 4, 32)
        # backward: x and grad_out read, grad_x written, ~20 operations an
        # element (statistics, affine, SiLU again and their backward)
        bound_ms, bound_by = bound_of(20 * x.numel() / F32_FLOPS, 4 * 3 * x.numel())
        rows["groupnorm_silu"].append(compare(
            f"groupnorm_silu op {list(shape)}",
            lambda: ck.groupnorm_silu_op(x, sc, bi, groups),
            lambda: ck.groupnorm_silu_reference(x, sc, bi, groups), [x, sc, bi],
            bound_ms, bound_by))
    if failures:
        raise AssertionError(f"ops disagree with their plain versions: {failures}")
    return rows


def train_wavs(seed):
    """One fixed batch: ``TRAIN_BATCH`` synthetic (clean, noisy) crops of
    ``TRAIN_SAMPLES`` samples, as numpy arrays."""
    rng = np.random.default_rng(seed)
    pairs = [synthetic_pair(rng, TRAIN_SAMPLES) for _ in range(TRAIN_BATCH)]
    return np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])


def check_train_model(torch, ck, dev):
    """Phase 9, second part: the paper's 65.6M model (weights redrawn from
    ``TRAIN_WEIGHT_SEED``): loss and gradients through the kernel path
    against the plain path (every wrapper's plain version), both on the card,
    on the same batch and draws."""
    from diffse_tpu_torch.models.score_model import ScoreModel, ScoreModelConfig
    from diffse_tpu_torch.utils import float32_precision

    model = ScoreModel(ScoreModelConfig(**PAPER_CONFIG), sde_kwargs=PAPER_SDE_KWARGS,
                       device=dev, generator=torch.Generator().manual_seed(0))
    redraw_weights(torch, model.backbone, seed=TRAIN_WEIGHT_SEED)
    named = [(n, p) for n, p in model.backbone.named_parameters() if p.requires_grad]
    n_params = sum(p.numel() for p in model.backbone.parameters())
    batch = model.prepare_batch(train_wavs(16))
    draws = model.draw_loss_noise(batch[0], torch.Generator(dev).manual_seed(17))

    def loss_and_grads():
        model.backbone.zero_grad(set_to_none=True)
        with float32_precision(dev):
            loss = model.loss_from_draws(batch, draws)
            loss.backward()
        return loss.item(), {n: p.grad.clone() for n, p in named if p.grad is not None}

    ck.reset_launch_counts()
    loss_k, grads_k = loss_and_grads()
    counts, recomputes = dict(ck.launch_counts), dict(ck.recompute_counts)
    with plain_versions(ck):
        ck.reset_launch_counts()
        loss_p, grads_p = loss_and_grads()
        plain_counts = dict(ck.launch_counts)
        with torch.backends.cudnn.flags(enabled=False):
            loss_n, grads_n = loss_and_grads()

    def gaps(grads):
        return {n: ((grads[n] - grads_p[n]).abs().max().item() / gradient_scale(grads_p, n))
                for n in grads_p}

    rel, floor_rel = (abs(loss - loss_p) / abs(loss_p) for loss in (loss_k, loss_n))
    errs, floors = gaps(grads_k), gaps(grads_n)
    worst, worst_floor = max(errs, key=errs.get), max(floors, key=floors.get)

    def median(d):
        return float(np.median(list(d.values())))

    print(f"paper model ({n_params} params, sebridge_v3, snr_conditioned true, batch "
          f"{TRAIN_BATCH} x {TRAIN_FRAMES} frames, weights redrawn from seed "
          f"{TRAIN_WEIGHT_SEED}): loss kernel path {loss_k:.9g}, plain path {loss_p:.9g} "
          f"(cuDNN), {loss_n:.9g} (cuDNN off); kernel vs plain {rel:.3e} relative (tol "
          f"{TRAIN_LOSS_RTOL}), plain with cuDNN off vs on {floor_rel:.3e}; gradients, of "
          f"each one's largest magnitude: kernel vs plain worst {worst} {errs[worst]:.3e} "
          f"(tol {TRAIN_GRAD_TOL}), median {median(errs):.3e}, above 1e-4 "
          f"{sum(e > TRAIN_GRAD_TOL for e in errs.values())} of {len(errs)}; plain with cuDNN "
          f"off vs on worst {worst_floor} {floors[worst_floor]:.3e}, median {median(floors):.3e}, "
          f"above 1e-4 {sum(e > TRAIN_GRAD_TOL for e in floors.values())}; kernel launches "
          f"{counts}, recomputes {recomputes}; plain path launches {plain_counts}")
    failures = []
    if len(grads_k) != len(named) or len(grads_p) != len(named):
        failures.append(f"gradients for {len(grads_k)} / {len(grads_p)} of {len(named)} "
                        "parameters")
    if rel > TRAIN_LOSS_RTOL or not np.isfinite(loss_k):
        failures.append(f"loss {loss_k} vs plain {loss_p}: {rel:.3e}")
    if errs[worst] > TRAIN_GRAD_TOL:
        failures.append(f"gradient of {worst} deviates by {errs[worst]:.3e}")
    expected = {"gn_silu_conv3x3": 2 * 81, "groupnorm_silu": 2 * 28, "fused_bias_leaky_relu": 0}
    if counts != expected or any(plain_counts.values()):
        failures.append(f"launches {counts} (expected {expected}), plain path {plain_counts}")
    if failures:
        raise AssertionError("; ".join(failures))
    return card_runs(counts, [])


def run_train_steps(torch, ck, dev, label, config, sde_kwargs, backbone_kwargs, steps,
                    profile_step=False):
    """Phase 9: ``steps`` train steps (``make_train_step``: prepare_batch ->
    loss -> backward -> Adam -> EMA) of a model with its weights redrawn from
    ``TRAIN_WEIGHT_SEED`` on one fixed batch, each step with the same draws.
    (From the default initialisation, whose last convs start at 1e-10,
    Adam's first steps at lr 1e-4 overshoot and the paper model's loss is
    still above its first after 10 steps, in the JAX package as in the port;
    from live weights it falls.) Checks
    every loss finite, every parameter that requires grad given a gradient
    that is not all zero (first step), the launches of every step, and one
    parameter and its EMA against ``ema_decay_schedule``. Prints the losses,
    the median step wall after ``TRAIN_WARMUP`` steps, audio seconds trained
    per second, the peak memory and, with ``profile_step``, the device time
    of one more step by kernel family and by part. Returns the run's launch
    counts (``card_runs``), with the bf16 conv's split by instantiation."""
    from torch.profiler import ProfilerActivity, profile

    from diffse_tpu_torch.models.score_model import ScoreModel, ScoreModelConfig
    from diffse_tpu_torch.profiling import device_breakdown, format_breakdown, labelled_device_us
    from diffse_tpu_torch.train import TrainState, ema_decay_schedule, make_train_step

    model = ScoreModel(ScoreModelConfig(**config), backbone_kwargs=backbone_kwargs,
                       sde_kwargs=sde_kwargs, device=dev,
                       generator=torch.Generator().manual_seed(0))
    redraw_weights(torch, model.backbone, seed=TRAIN_WEIGHT_SEED)
    state = TrainState(model.backbone, lr=model.cfg.lr, ema_decay=model.cfg.ema_decay)
    step = make_train_step(model, preprocess=model.prepare_batch)
    wavs = train_wavs(18)
    forwards = 1 if config["model_type"] == "bbed" else 2
    expected = {"gn_silu_conv3x3": 81 * forwards, "groupnorm_silu": 28 * forwards,
                "fused_bias_leaky_relu": 0}
    named = dict((n, p) for n, p in model.backbone.named_parameters() if p.requires_grad)
    grad_max, hooks = {}, []
    for name, p in named.items():
        hooks.append(p.register_post_accumulate_grad_hook(
            lambda p, name=name: grad_max.__setitem__(name, p.grad.abs().max())))
    # the first residual block's first conv
    watch = next(i for i, n in enumerate(state.names) if n.endswith("Conv_0.weight"))
    failures, losses, walls, total, by_config = [], [], [], None, [0] * len(ck.CONV_CONFIGS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i in range(steps):
        gen = torch.Generator(dev).manual_seed(19)  # one fixed batch, the same draws
        p0, e0 = state.params[watch].detach().clone(), state.ema[watch].clone()
        ck.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, wavs, gen)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        losses.append(metrics["train_loss"].item())
        counts = dict(ck.launch_counts)
        total = counts if total is None else {k: total[k] + v for k, v in counts.items()}
        by_config = [a + b for a, b in zip(by_config, ck.conv_config_launches)]
        if counts != expected or dict(ck.recompute_counts) != {
                k: expected[k] for k in ck.recompute_counts}:
            failures.append(f"step {i + 1}: launches {counts}, recomputes "
                            f"{dict(ck.recompute_counts)}, expected {expected}")
        if i == 0:
            for h in hooks:
                h.remove()
            missing = [n for n in named if n not in grad_max]
            zero = [n for n, m in grad_max.items() if m.item() == 0]
            print(f"{label}: step 1 gave {len(grad_max)} of {len(named)} parameters that require "
                  f"grad a gradient; all-zero gradients: {zero or 'none'}")
            if missing or zero:
                failures.append(f"no gradient for {missing}, all-zero gradient for {zero}")
        d = float(ema_decay_schedule(state.ema_decay, state.step))
        expected_ema = e0 * d + state.params[watch].detach() * (1 - d)
        ema_err = ((state.ema[watch] - expected_ema).abs().max()
                   / expected_ema.abs().max()).item()
        moved = not torch.equal(state.params[watch], p0) and not torch.equal(state.ema[watch], e0)
        if ema_err > 1e-6 or not moved:
            failures.append(f"step {i + 1}: the EMA of {state.names[watch]} is {ema_err:.3e} "
                            f"off e * {d:.6f} + (1 - d) * p, moved {moved}")
    peak = torch.cuda.max_memory_allocated()
    median_wall = float(np.median(walls[TRAIN_WARMUP:] or walls))
    print(f"{label}: {steps} steps on one fixed batch of {TRAIN_BATCH} x {TRAIN_FRAMES} frames "
          f"(the same draws each step): losses {[f'{v:.6g}' for v in losses]}; step walls "
          f"{[f'{w:.3f}' for w in walls]} s, median after {TRAIN_WARMUP} warm-up steps "
          f"{median_wall:.4f} s, {TRAIN_AUDIO_S / median_wall:.2f} s of audio trained per s; "
          f"max_memory_allocated {peak / 2**30:.2f} GiB; launches per step {expected}, "
          f"conv by instantiation over the run {dict(zip(CONV_NAMES, by_config))}; the EMA of "
          f"{state.names[watch]} followed ema_decay_schedule on every step")
    if not all(np.isfinite(losses)):
        failures.append(f"losses {losses}")
    if profile_step:
        gen = torch.Generator(dev).manual_seed(19)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step(state, wavs, gen)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        breakdown = device_breakdown(prof)
        parts = labelled_device_us(prof, ("train_step: forward", "train_step: Adam + EMA",
                                          "gn_silu_conv3x3 backward (recompute)",
                                          "groupnorm_silu backward (recompute)"))
        device_s, busy_s = breakdown["total_us"] / 1e6, breakdown["busy_us"] / 1e6
        idle = (f"{1 - busy_s / wall:.3f}" if busy_s > 0
                else "not measured (the profiler recorded no device time)")
        rest = breakdown["total_us"] - sum(parts.values())
        print("\n".join(
            [f"{label}: one profiled step: wall {wall:.4f} s, device kernel time {device_s:.4f} s "
             f"(busy {busy_s:.4f} s: the union of the kernels' intervals), idle share {idle} "
             f"(1 - busy / wall), {breakdown['launches']} device kernel launches; by part: "
             + ", ".join(f"{k} {v / 1e3:.2f} ms" for k, v in parts.items())
             + f", the rest (the backward of everything else) {rest / 1e3:.2f} ms; "
             "by kernel family:"] + format_breakdown(breakdown, top=10)))
    if failures:
        raise AssertionError(f"{label}: " + "; ".join(failures))
    return {"losses": losses, "median_wall": median_wall, "peak": peak,
            "path": card_runs({**total, **conv_launches(ck, by_config)}, [])}


def write_cli_data(root, seed):
    """A tiny VBD-style directory, written with the port's wavio: train and
    valid clean/noisy pairs and valid/active_rms.txt."""
    import os

    from diffse_tpu_torch.data.wavio import write_wav

    rng = np.random.default_rng(seed)
    n = int(CLI_SECONDS * SR)
    for subset, count in (("train", CLI_TRAIN_FILES), ("valid", CLI_VALID_FILES)):
        for kind in ("clean", "noisy"):
            os.makedirs(os.path.join(root, subset, kind))
        lines = []
        for i in range(count):
            clean, noisy = synthetic_pair(rng, n)
            write_wav(os.path.join(root, subset, "clean", f"u{i:03d}.wav"), clean, SR)
            write_wav(os.path.join(root, subset, "noisy", f"u{i:03d}.wav"), noisy, SR)
            lines.append(f"u{i:03d}.wav\t{np.sqrt(np.mean(clean ** 2)):.8f}\t"
                         f"{np.sqrt(np.mean((noisy - clean) ** 2)):.8f}")
        with open(os.path.join(root, subset, "active_rms.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")


def run_train_cli(torch, dev):
    """Phase 9, last part: ``python -m diffse_tpu_torch.cli.train`` with the
    paper's flags for one epoch of 2 steps into a checkpoint, then
    ``--resume`` for a second epoch; the checkpoint read back with
    ``load_score_model``."""
    import os
    import shutil
    import tempfile
    from pathlib import Path

    from diffse_tpu_torch.train import CheckpointManager
    from diffse_tpu_torch.train.restore import load_score_model

    root = tempfile.mkdtemp(prefix="diffse_train_cli_")
    try:
        write_cli_data(os.path.join(root, "data"), seed=20)
        ckpt = os.path.join(root, "ckpt")
        args = [sys.executable, "-m", "diffse_tpu_torch.cli.train", "--modeltype", "sebridge_v3",
                "--snr_conditioned", "true", "--fixed_snr", str(FIXED_SNR), "--transform_type",
                "exponent", "--sigma-max", "1.0", "--num_eval_files", "0", "--base_dir",
                os.path.join(root, "data"), "--ckpt_dir", ckpt, "--max_steps_per_epoch", "2",
                "--num_workers", "1"]
        for extra in (["--max_epochs", "1"], ["--max_epochs", "2", "--resume"]):
            t0 = time.time()
            proc = subprocess.run(args + extra, cwd=Path(__file__).resolve().parent,
                                  capture_output=True, text=True, timeout=600)
            lines = proc.stdout.strip().splitlines()
            print(f"train CLI {' '.join(extra)}: exit {proc.returncode} in "
                  f"{time.time() - t0:.1f} s; its last lines: {lines[-3:]}")
            if proc.returncode != 0:
                raise AssertionError(f"train CLI {extra} failed:\n{proc.stderr[-3000:]}")
        mgr = CheckpointManager(ckpt)
        rows = [json.loads(line) for line in open(os.path.join(ckpt, "metrics.jsonl"))]
        train_losses = [r["train_loss"] for r in rows if "train_loss" in r]
        valid_losses = [r["valid_loss"] for r in rows if "valid_loss" in r]
        model, state = load_score_model(ckpt, device=dev)
        hparams = mgr.load_hparams()
        n_params = sum(p.numel() for p in model.backbone.parameters())
        print(f"train CLI: checkpoints {mgr.all_steps()}, restored step {state.step}, train "
              f"losses {train_losses}, valid losses {valid_losses}, model_type "
              f"{hparams['config']['model_type']}, {n_params} params")
        # only the last is kept: validation gives no pesq / si_sdr to rank by
        if (mgr.all_steps() != [1] or state.step != 4 or len(valid_losses) != 2
                or not all(np.isfinite(train_losses + valid_losses))):
            raise AssertionError(f"train CLI: checkpoints {mgr.all_steps()}, step {state.step}, "
                                 f"losses {train_losses} / {valid_losses}")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def run_training(torch, ck, dev):
    """Phase 9 ("train"). Returns the float32 and the bf16 runs' launch
    counts, by path. TF32 off for cuDNN and matmul, as in phase 2: the port
    pins float32 in its own steps, and the plain versions' gradients taken
    here must be float32 too."""
    t0 = time.time()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("phase 9: torch.backends.cudnn.allow_tf32=False, "
          "torch.backends.cuda.matmul.allow_tf32=False")
    check_train_kernels(torch, ck, dev)
    model_path = check_train_model(torch, ck, dev)
    torch.cuda.empty_cache()
    paper = run_train_steps(torch, ck, dev, "sebridge_v3 (paper), float32", PAPER_CONFIG,
                            PAPER_SDE_KWARGS, {}, TRAIN_STEPS, profile_step=True)
    if not paper["losses"][-1] < paper["losses"][0]:
        raise AssertionError(f"the paper model's loss did not fall: {paper['losses']}")
    torch.cuda.empty_cache()
    bbed = run_train_steps(torch, ck, dev, "bbed score matching, float32", BBED_TRAIN_CONFIG,
                           dict(T_sampling=0.999, k=2.6, theta=0.52), {}, BBED_STEPS)
    torch.cuda.empty_cache()
    bf16 = run_train_steps(torch, ck, dev, "sebridge_v3 (paper), bf16 trunk", PAPER_CONFIG,
                           PAPER_SDE_KWARGS, {"dtype": "bf16"}, 1)
    torch.cuda.empty_cache()
    run_train_cli(torch, dev)
    print(f"phase train: {time.time() - t0:.1f} s")
    f32 = {"training, kernel vs plain (eager)": model_path,
           "training, sebridge_v3 steps (eager)": paper["path"],
           "training, bbed steps (eager)": bbed["path"]}
    return f32, {"training, bf16 trunk step (eager)": bf16["path"]}


def serve_wavs(seconds, seed):
    """Phase 10's noisy utterances of ``seconds`` each (synthetic_pair)."""
    rng = np.random.default_rng(seed)
    return [synthetic_pair(rng, int(s * SR))[1] for s in seconds]


def http_clients(base, wavs):
    """``SERVE_CLIENTS`` threads, client c POSTing requests c, c + 8, ...
    (float32 WAV) one after another, all clients starting together. A 503
    is retried after its Retry-After, as a client of the service would.
    Returns each request's (status, output or None, latency, 503s retried)."""
    import threading
    import urllib.error
    import urllib.request

    from diffse_tpu_torch.data.wavio import parse_wav, wav_bytes

    results = [None] * len(wavs)
    bodies = [wav_bytes(w, SR, subtype="float32") for w in wavs]
    start = threading.Barrier(SERVE_CLIENTS)

    def client(c):
        start.wait(timeout=60)
        for k in range(c, len(wavs), SERVE_CLIENTS):
            t0, retried = time.perf_counter(), 0
            while True:
                req = urllib.request.Request(base + "/enhance", data=bodies[k], method="POST")
                try:
                    with urllib.request.urlopen(req, timeout=600) as r:
                        results[k] = (r.status, parse_wav(r.read())[0][0],
                                      time.perf_counter() - t0, retried)
                    break
                except urllib.error.HTTPError as e:
                    if e.code != 503 or retried == 3:
                        results[k] = (e.code, None, time.perf_counter() - t0, retried)
                        break
                    retried += 1
                    time.sleep(float(e.headers["Retry-After"]))

    threads = [threading.Thread(target=client, args=(c,)) for c in range(SERVE_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    if any(t.is_alive() for t in threads):
        raise AssertionError("serve: an HTTP client did not finish in 900 s")
    return results


def run_serving(torch, ck, dev):
    """Phase 10 ("serve"): EnhanceService behind the HTTP front on the card,
    its chunk program against the eager run, packing against each utterance
    alone, the eval programs' bound, a 1-NFE flight against the CPU, stage 2
    under set_sync_debug_mode("error"), and ``python -m
    diffse_tpu_torch.cli.serve``.
    Returns the serving paths' kernel runs."""
    import gc
    import os
    import shutil
    import tempfile
    import urllib.request

    from diffse_tpu_torch.cli import serve as serve_cli
    from diffse_tpu_torch.data.wavio import parse_wav, wav_bytes
    from diffse_tpu_torch.evaluation import inference, streaming
    from diffse_tpu_torch.models.score_model import ScoreModel, ScoreModelConfig
    from diffse_tpu_torch.models.snr_model import SNRModel
    from diffse_tpu_torch.serving import EnhanceService, ServiceConfig
    from diffse_tpu_torch.serving.http import make_server, serve_forever_in_thread
    from diffse_tpu_torch.train import CheckpointManager, TrainState
    from diffse_tpu_torch.utils import generator_noise

    t_phase = time.time()
    failures = []
    # earlier phases' models and programs are gone: give their memory back
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    weights = sampler_weights(torch)
    model = sampler_model(torch, weights, device=dev)
    fs = model.cfg.fixed_snr

    # 1. the service over HTTP, the chunk program captured by the first flight
    wavs = serve_wavs(SERVE_SECONDS * SERVE_REQUESTS_EACH, seed=40)
    svc = EnhanceService(model, config=ServiceConfig(sampler_kwargs=SERVE_SAMPLER))
    server = make_server(svc, port=0)
    thread = serve_forever_in_thread(server)
    host, port = server.server_address[:2]
    base = f"http://{host}:{port}"
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved0 = torch.cuda.memory_reserved()
    try:
        gc.collect()
        ck.reset_launch_counts()
        t0 = time.perf_counter()
        results = http_clients(base, wavs)
        wall = time.perf_counter() - t0
        counts = dict(ck.launch_counts)
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            health = json.loads(r.read())
        with urllib.request.urlopen(base + "/stats", timeout=30) as r:
            stats = json.loads(r.read())
    finally:
        server.shutdown()
        thread.join(timeout=30)
        svc.close()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    kept = torch.cuda.memory_reserved() - reserved0
    programs = [p for _, p in model._stream_programs.values()]
    statuses = [r[0] for r in results]
    good = [r[0] == 200 and r[1] is not None and r[1].shape == w.shape
            and bool(np.isfinite(r[1]).all()) for r, w in zip(results, wavs)]
    audio_s = sum(len(w) for w in wavs) / SR
    lat = stats["latency_ms"]
    print(f"serve: {len(wavs)} HTTP requests from {SERVE_CLIENTS} clients ({audio_s:.1f} s of "
          f"audio, {SERVE_SECONDS} s cycled): statuses {statuses} (503s retried after "
          f"Retry-After: {sum(r[3] for r in results)}); of its input's length and finite "
          f"{sum(good)}/{len(wavs)}; /healthz {health}")
    print(f"serve: {stats['flights']} flights, {stats['chunks']} chunks in "
          f"{stats['chunk_batches']} batches of 16 (occupancy {stats['chunk_occupancy']:.3f} "
          f"chunks per row; {stats['occupancy']:.2f} utterances a flight); the service's wall "
          f"{stats['wall_seconds']:.3f} s, {stats['wall_seconds'] / stats['flights']:.3f} s a "
          f"flight, {stats['rtf_x_realtime']:.3f} s of audio per s; clients' wall {wall:.3f} s "
          f"({audio_s / wall:.3f} s of audio per s); latency p50 {lat['p50']} ms, p95 "
          f"{lat['p95']} ms, p99 {lat['p99']} ms, max {lat['max']} ms")
    if not all(good) or len(good) != SERVE_CLIENTS * SERVE_REQUESTS_EACH:
        failures.append(f"serve: HTTP results {statuses}, good {good}")
    if health != {"status": "ok"} or stats["requests"] != len(wavs) or stats["errors"]:
        failures.append(f"serve: /healthz {health}, /stats {stats}")
    if len(programs) != 1:
        failures.append(f"serve: {len(programs)} chunk programs kept; expected one")
    program = programs[0]
    print(f"serve: the chunk program ([16, 1, 256, 64], {SERVE_FORWARDS} forwards): warm-up run "
          f"+ capture {program.capture_seconds:.3f} s on the first flight; card memory reserved "
          f"after the run, beyond that before it (the program and the engine's caches) "
          f"{kept / 2**20:.1f} MiB; replayed {program.replays} times (one per chunk batch)")
    check_recorded("serve chunk program", program, SERVE_FORWARDS, failures)
    if program.replays != stats["chunk_batches"]:
        failures.append(f"serve: {program.replays} replays for {stats['chunk_batches']} batches")
    # through the wrappers: the warm-up run and the capture; on the card the
    # warm-up run and the replays
    want = {"gn_silu_conv3x3": 81 * 2 * SERVE_FORWARDS,
            "groupnorm_silu": 28 * 2 * SERVE_FORWARDS, "fused_bias_leaky_relu": 0}
    if counts != want:
        failures.append(f"serve: wrapper launches {counts}, expected {want}")
    serve_path = card_runs(counts, programs)
    print(f"serve: kernel runs on the card {serve_path['runs']} (81 / 28 a forward, "
          f"{SERVE_FORWARDS} forwards a batch, the warm-up run and {program.replays} replays), "
          f"recorded at capture {serve_path['recorded']}")

    # 2. + 5. one chunk batch: stage 2 under set_sync_debug_mode("error"),
    # its replay against the eager run on the same generator state
    pool = streaming.pack_chunks(model, serve_wavs(SERVE_CHECK_SECONDS, seed=41), "bbed")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        samples = streaming.run_chunks(model, pool, "bbed", torch.Generator(dev).manual_seed(21),
                                       sampler_kwargs=SERVE_SAMPLER)
        enqueue_s = time.perf_counter() - t0
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    replay_s = time.perf_counter() - t0
    outs = streaming.finish_chunks(model, pool, samples)
    with torch.no_grad():
        gen = torch.Generator(dev).manual_seed(21)
        t0 = time.perf_counter()
        eager = streaming._chunk_fn(model, "bbed", fs, SERVE_SAMPLER)(generator_noise(gen),
                                                                      **pool.batch(0))
        torch.cuda.synchronize()
        eager_s = time.perf_counter() - t0
    err = relative_gap(samples, eager)
    print(f"serve: stage 2 of a {pool.chunks}-chunk batch under set_sync_debug_mode('error'): "
          f"clean, enqueued in {enqueue_s:.4f} s, done in {replay_s:.3f} s (one replay); eager "
          f"on the same generator state {eager_s:.3f} s; replay vs eager max|diff|/max|eager| "
          f"{err:.3e} (tol {GRAPH_TOL}), bitwise equal {torch.equal(samples, eager)}; waveforms "
          f"finite {all(np.isfinite(o).all() for o in outs)}")
    if err > GRAPH_TOL or not all(np.isfinite(o).all() for o in outs):
        failures.append(f"serve: replay vs eager {err:.3e}")
    del model, svc, program, programs, pool, samples, eager
    gc.collect()
    torch.cuda.empty_cache()

    # 3. packing against each utterance alone, on the deterministic sebridge
    seb = ScoreModel(ScoreModelConfig(backbone="ncsnpp", sde="bbed", model_type="sebridge",
                                      snr_conditioned="false"),
                     sde_kwargs=SAMPLER_SDE_KWARGS["bbed"], device=dev)
    seb.backbone.load_state_dict(weights)
    ys = serve_wavs(SERVE_SECONDS, seed=42)
    packed = streaming.enhance_streamed_packed(seb, ys, "sebridge", batch_size=16)
    alone = [streaming.enhance_streamed_spec(seb, y, "sebridge") for y in ys]
    gaps = [float(np.max(np.abs(p - a)) / np.max(np.abs(a))) for p, a in zip(packed, alone)]
    chunks = sum(streaming._packed_geometry(len(y), 128, 64, 2)[1] for y in ys)
    print(f"serve: sebridge packed (batch 16, {chunks} chunks, utterances split across "
          f"batches) vs each utterance alone: max|diff|/max|ref| per utterance "
          f"{['%.2e' % g for g in gaps]} (tol {PACKING_TOL})")
    if max(gaps) > PACKING_TOL:
        failures.append(f"serve: packed vs per-utterance {max(gaps):.3e}")

    # 3b. eval_enhance_file over more width buckets than the model keeps
    # programs: the least recently used program is dropped before a capture
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved0, reserved, finite = torch.cuda.memory_reserved(), [], []
    ys = serve_wavs(SERVE_BUCKET_SECONDS, seed=44)
    for y in ys:
        out = inference.eval_enhance_file(seb, y, y, "sebridge")
        torch.cuda.synchronize()
        torch.cuda.empty_cache()  # what stays reserved is what the programs keep
        reserved.append((torch.cuda.memory_reserved() - reserved0) / 2**20)
        finite.append(out.shape == y.shape and bool(np.isfinite(out).all()))
    kept_programs = len(seb._eval_programs)
    print(f"serve: eval_enhance_file (sebridge, batch 1) on {SERVE_BUCKET_SECONDS} s, one "
          f"width bucket each: {kept_programs} programs kept (PROGRAMS_KEPT "
          f"{inference.PROGRAMS_KEPT}); card memory reserved after each beyond that before "
          f"the first, MiB {['%.0f' % r for r in reserved]}; of its input's length and finite "
          f"{finite}")
    if kept_programs != inference.PROGRAMS_KEPT or not all(finite):
        failures.append(f"serve: eval programs kept {kept_programs}, outputs good {finite}")
    del seb
    gc.collect()
    torch.cuda.empty_cache()

    # 4. a 1-NFE sebridge_v3_snr flight, card against CPU, the same draws
    v3_cfg = ScoreModelConfig(backbone="ncsnpp", sde="bbed", model_type="sebridge_v3",
                              snr_conditioned="true", fixed_snr=FIXED_SNR, sigma_max=1.0)
    snrnet = redraw_snrnet(torch, seed=5)
    card = ScoreModel(v3_cfg, sde_kwargs=SAMPLER_SDE_KWARGS["bbed"], device=dev,
                      snr_model=copy.deepcopy(snrnet))
    card.backbone.load_state_dict(weights)
    cpu = ScoreModel(v3_cfg, sde_kwargs=SAMPLER_SDE_KWARGS["bbed"], device="cpu",
                     snr_model=copy.deepcopy(snrnet))
    cpu.backbone.load_state_dict(weights)
    ys = serve_wavs(SERVE_CPU_SECONDS, seed=43)
    est = [card.estimate_snr(y[None])[0].item() for y in ys]
    est_cpu = [cpu.estimate_snr(y[None])[0].item() for y in ys]
    batch = ServiceConfig().batch_size
    chunks = sum(streaming._packed_geometry(len(y), 128, 64, 2)[1] for y in ys)
    if chunks != batch:
        failures.append(f"serve: the 1-NFE flight has {chunks} chunks, not one batch of {batch}")
    kw = dict(batch_size=batch, est_snrs=est, fixed_snr=FIXED_SNR)
    ck.reset_launch_counts()
    out_card = streaming.enhance_streamed_packed(card, ys, "sebridge_v3_snr",
                                                 noise=cpu_noise(torch, 23), **kw)
    v3_counts = dict(ck.launch_counts)
    out_cpu = streaming.enhance_streamed_packed(cpu, ys, "sebridge_v3_snr",
                                                noise=cpu_noise(torch, 23), **kw)
    gaps = [float(np.max(np.abs(a - b)) / np.max(np.abs(b))) for a, b in zip(out_card, out_cpu)]
    print(f"serve: sebridge_v3_snr flight of {SERVE_CPU_SECONDS} s ({chunks} chunks, one batch "
          f"of the service's {batch}, eager with the CPU's draws): est_snr card {est}, CPU "
          f"{est_cpu}, snap margins {['%.2e' % snap_margin(e) for e in est]}; waveforms card vs CPU "
          f"{['%.2e' % g for g in gaps]} (tol {WAVEFORM_TOL}); launches {v3_counts}")
    if max(gaps) > WAVEFORM_TOL or min(snap_margin(e) for e in est) < SNAP_MARGIN:
        failures.append(f"serve: 1-NFE flight card vs CPU {max(gaps):.3e}")
    if v3_counts != {"gn_silu_conv3x3": 81, "groupnorm_silu": 28, "fused_bias_leaky_relu": 0}:
        failures.append(f"serve: 1-NFE flight launches {v3_counts}, expected one forward's")

    # 6. the CLI on checkpoints the port's CheckpointManager wrote
    root = tempfile.mkdtemp(prefix="diffse_serve_cli_")
    try:
        CheckpointManager(os.path.join(root, "score"), hparams=card.hparams).save(
            1, TrainState(card.backbone))
        snr_model = SNRModel(device=dev, dnn=copy.deepcopy(snrnet))
        CheckpointManager(os.path.join(root, "snr"), hparams=snr_model.hparams, monitors=(
            {"monitor": "snr_error", "mode": "min", "top_k": 3},)).save(
            1, TrainState(snr_model.dnn), {"snr_error": 1.0})
        del card, cpu, snr_model
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        server, svc, thread = serve_cli.main(
            ["--ckpt", os.path.join(root, "score"), "--snr_ckpt", os.path.join(root, "snr"),
             "--port", "0"], block=False)
        try:
            host, port = server.server_address[:2]
            y = ys[1]
            req = urllib.request.Request(f"http://{host}:{port}/enhance", method="POST",
                                         data=wav_bytes(y, SR, subtype="float32"))
            with urllib.request.urlopen(req, timeout=600) as r:
                status, out = r.status, parse_wav(r.read())[0][0]
            cli_s = time.perf_counter() - t0
        finally:
            server.shutdown()
            thread.join(timeout=30)
            svc.close()
        print(f"serve CLI (sebridge_v3_snr, --snr_ckpt): {svc.model_type} answered a POST of "
              f"{len(y) / SR} s with {status}, {out.shape[0]} samples, finite "
              f"{bool(np.isfinite(out).all())}, {cli_s:.1f} s from start (load + capture)")
        if status != 200 or out.shape != y.shape or not np.isfinite(out).all():
            failures.append(f"serve CLI: status {status}, shape {out.shape}")
        del svc
    finally:
        shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase serve: {time.time() - t_phase:.1f} s")
    if failures:
        raise AssertionError("; ".join(failures))
    return {"serve: HTTP flights, bbed rd_ald_logit_N20 chunk program (graphed)": serve_path,
            "serve: sebridge_v3_snr packed flight (eager, caller's noise)":
                card_runs(v3_counts, [])}


def main(argv=None) -> int:
    """Runs every phase; ``--phases a,b`` runs only those (a probe: no JSON
    lines then)."""
    argv = sys.argv[1:] if argv is None else argv
    only = None
    if argv:
        if len(argv) != 2 or argv[0] != "--phases":
            print("usage: chip_smoke.py [--phases name,name,...]", file=sys.stderr)
            return 2
        only = set(argv[1].split(","))
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch is not importable: {e}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        from diffse_tpu_torch.ops import cuda_kernels as ck
    except ImportError as e:
        print(f"chip_smoke: the port is not importable: {e}", file=sys.stderr)
        return 1

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          "torch.backends.cudnn.allow_tf32=False, torch.backends.cuda.matmul.allow_tf32=False")
    t0 = time.time()
    lib = ck.build_library()
    print(f"built {lib.name} in {time.time() - t0:.1f} s")

    ok = True
    results = {}
    for name, phase in (("kernels", lambda: check_kernels(torch, ck, dev)),
                        ("fused_act", lambda: check_fused_act(torch, ck, dev)),
                        ("forward", lambda: check_forward(torch, ck, dev)),
                        ("enhance", lambda: run_main_path(torch, ck, dev)),
                        ("snr", lambda: run_snr_path(torch, ck, dev)),
                        ("graphs", lambda: run_graphs(torch, ck, dev,
                                                      results.get("enhance", ({}, []))[1])),
                        ("samplers", lambda: run_samplers(torch, ck, dev)),
                        ("bf16_kernels", lambda: check_bf16_kernels(torch, ck, dev)),
                        ("bf16_forward", lambda: check_bf16_forward(torch, ck, dev)),
                        ("bf16_program", lambda: run_bf16_program(torch, ck, dev)),
                        ("train", lambda: run_training(torch, ck, dev)),
                        ("serve", lambda: run_serving(torch, ck, dev))):
        if only is not None and name not in only:
            continue
        t0 = time.time()
        try:
            results[name] = phase()
        except Exception:  # report every phase, then fail
            traceback.print_exc()
            print(f"phase {name}: FAILED after {time.time() - t0:.1f} s")
            ok = False
            continue
        print(f"phase {name}: ok in {time.time() - t0:.1f} s")
    if not ok:
        return 1
    if only is not None:
        print(f"phases {sorted(only)} passed (a partial run: no kernel record)")
        return 0

    # kernel runs on the card on each main path, each counted from zero: the
    # float32 paths, and the bf16 trunk's (one forward; bench.py's batch-16
    # program)
    paths = {"bbed_pc (graphed) + sebridge_v2 (eager, caller's noise)": results["enhance"][0],
             **results["snr"], **results["graphs"], **results["samplers"][0],
             **results["train"][0], **results["serve"]}
    bf16_paths = {"bf16_forward (eager)": results["bf16_forward"],
                  "bf16_bench_program (graphed)": results["bf16_program"],
                  **results["samplers"][1], **results["train"][1]}

    def launches(kernel, by=paths):
        runs = {path: counts["runs"][kernel] for path, counts in by.items()}
        recorded = {path: counts["recorded"][kernel] for path, counts in by.items()}
        return {"launches": sum(runs.values()), "launches_by_path": runs,
                "recorded_at_capture_by_path": recorded, "launches_counted": LAUNCHES_COUNTED}

    gn_source = {"route": "cuda", "source": "diffse_tpu_torch/csrc/gn_kernels.cu"}
    record = {"kernels": [
        {"name": "gn_silu_conv3x3", **gn_source,
         "replaces": "diffse_tpu/ops/pallas_kernels.py:269",
         "also_replaces": "diffse_tpu/ops/pallas_kernels.py:350",
         **launches("gn_silu_conv3x3"), **results["kernels"]["gn_silu_conv3x3"]},
        {"name": "groupnorm_silu", **gn_source,
         "replaces": "diffse_tpu/ops/pallas_kernels.py:46",
         **launches("groupnorm_silu"), **results["kernels"]["groupnorm_silu"]},
        {"name": "gn_silu_conv3x3_bf16", **gn_source,
         "replaces": "diffse_tpu/ops/pallas_kernels.py:269",
         "also_replaces": "diffse_tpu/ops/pallas_kernels.py:350",
         **launches("gn_silu_conv3x3_other", bf16_paths),
         **results["bf16_kernels"]["gn_silu_conv3x3"]},
        {"name": "gn_silu_conv3x3_bf16_wgmma_ss", **gn_source,
         "replaces": "diffse_tpu/ops/pallas_kernels.py:269",
         **launches("gn_silu_conv3x3_ws", bf16_paths),
         **results["bf16_kernels"]["gn_silu_conv3x3_ws"]},
        {"name": "groupnorm_silu_bf16", **gn_source,
         "replaces": "diffse_tpu/ops/pallas_kernels.py:46",
         **launches("groupnorm_silu", bf16_paths), **results["bf16_kernels"]["groupnorm_silu"]},
        {"name": "fused_bias_leaky_relu", "route": "cuda",
         "source": "diffse_tpu_torch/csrc/fused_act.cu",
         "replaces": "diffse_tpu/ops/pallas_kernels.py:208",
         **launches("fused_bias_leaky_relu"), **results["fused_act"]},
    ]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
