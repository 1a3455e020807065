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
   (reverse_diffusion + ald, logit grid, N = 20, 40 forwards) at 128
   frames with the float32 and the bf16 trunk, each replay against the
   eager path on the same generator state (``GRAPH_TOL``, bitwise printed),
   its first call's time and the card memory it keeps; each predictor, the
   langevin corrector, each grid and the OUVE and PROPOSED_1 SDEs
   (``SAMPLER_CASES``, N = 2, on an NCSN++ of the same depth but
   ``SAMPLER_CPU_NF`` channels wide) on the card against the CPU with the
   same draws (``SAMPLER_TOL``); heun and the exponential predictors under
   ``set_sync_debug_mode("error")``; then ``bbed_ode`` (RK45, rtol = atol
   = 1e-5, on a 0.5 s utterance) through its three captured programs
   (``capture.LoopProgram``) against the eager path, with 1 and 4 step attempts between two host
   reads of its done flag, its nfev, attempts, status, host reads and
   synchronisations, and (on the narrow NCSN++) on the card against the
   CPU: the same flags (an accept/reject flip is reported as one) and the
   waveform within ``ODE_WAVEFORM_TOL``. Each part's kernel runs on the card.
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
   same redrawn weights: ``TRAIN_STEPS`` (4) Adam steps of the paper's model on one fixed
   batch with the same draws each step (the loss must fall), 3 of bbed score
   matching and 1 of the bf16 trunk: every loss finite, every trained
   parameter given a gradient that is not all zero, 162/56 launches a
   consistency step
   (81/28 for bbed) and as many recomputes, a parameter and its EMA against
   ``ema_decay_schedule``; the median step wall after 2 warm-up steps, audio
   seconds trained per second, the peak memory, and one profiled bbed
   step's device time by part and by kernel family with its idle share. Last, the
   training CLI (``diffse_tpu_torch.cli.train.main`` in this process, the
   paper's flags, ``--num_eval_files 0``) on a tiny wav directory written
   with the port's wavio: one epoch of 2 steps into a checkpoint,
   ``--resume`` for a second, and ``load_score_model`` on the result. Each
   part's wall time is printed.

10. Serving ("serve"): ``EnhanceService`` (``ServiceConfig`` defaults: chunk
   64, overlap 2, batch 16, flights of 16, 25 ms linger) behind the HTTP
   front (``make_server``) on the 65.6M bbed model (weights redrawn from
   seed 13, float32 trunk) with the certified sampler ``rd_ald_logit_N20``:
   8 client threads POST ``SERVE_REQUESTS_EACH`` WAVs each (0.6 to 3.0 s); every answer 200, of
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

11. Evaluation ("eval"): the evaluation package on a synthetic VBD-style
   dataset written by the port's ``make_synthetic_dataset`` (a test split of
   six files of 0.8-2.5 s in the 128- and 320-frame buckets), with
   checkpoints saved by the port's ``CheckpointManager``: the 65.6M bbed
   model and the paper's sebridge_v3 SNR-conditioned ``ncsnpp`` (weights
   redrawn from seed 13, float32 trunk) and a redrawn SNRNet. Each CLI runs
   through its ``main(argv)`` in this process: ``cli.eval`` one file at a
   time (``bbed_pc``, 30 steps), then ``--eval_batch_size 4 --N 20
   --timestep_type logit`` (``rd_ald_logit_N20`` through ``batch_enhance``:
   a captured full batch and an eager tail) and with
   ``--streaming_chunk_frames 64`` (the packed engine), each writing
   ``_results.csv``, ``_avg_results.txt`` and finite wavs of their inputs'
   lengths; ``batch_enhance`` on the 1-NFE ``sebridge_v3_snr`` with CPU-drawn
   noise against ``eval_enhance_file`` file by file on the card
   (``PACKING_TOL``) and against the same call on the CPU
   (``WAVEFORM_TOL``); ``cli.deep_eval`` on the two valid2 files
   (``_results_deep.csv``, 27 finite values a file) and
   ``deep_evaluate_model`` (each file one 9-row batch, 27 finite scalars);
   the training CLI with ``--num_eval_files 2`` (the checkpoint's metadata
   carries pesq, si_sdr and estoi, ``load_score_model(monitor="pesq")`` picks
   it, the trained weights after validation equal those before it);
   ``cli.eval_snr_est``. Printed beside the card's name and power limit:
   each step's wall, files and audio seconds per second, the enhance and the
   host's scoring seconds apart, each captured program's capture time and
   the memory reserved after it, and the kernel runs of the phase
   (``launches_by_path["eval"]``).

12. SNR-estimator training ("snr_train"): the train step of SNRNet at the
   CLI's defaults (batch 4 x 256 frames, float32 pinned) on one fixed batch
   (step wall, audio s per s, peak memory); ``cli.train_snr_est`` in this
   process on a synthetic dataset written by the port's
   ``make_synthetic_dataset``, an epoch of 2 steps into a checkpoint and a
   ``--resume``d second (``snr_error`` after each); that checkpoint through
   ``cli.eval_snr_est`` and, as ``--snr_ckpt``, through ``cli.eval`` on the
   paper's 65.6M sebridge_v3 SNR-conditioned model (``sebridge_v3_snr``),
   with that path's kernel runs.

13. The exported artifact ("export", ``serving/export.py``): the paper's
   65.6M sebridge_v3 SNR-conditioned model through ``cli.export_artifact``
   with two buckets (128 and 192 frames); the 65.6M bbed model as a
   ``bbed_pc`` artifact of ``EXPORT_BBED_N`` (30) steps (start, one step
   replayed N times, finish, in one captured graph) and as a ``bbed_ode``
   artifact (start, attempt, finish under a ``LoopProgram``); in bf16,
   counted apart among the bf16 paths, the bbed model's ``bbed_pc`` and the
   paper's model's ``sebridge_v3_snr``. For each: its export, save, load
   and capture seconds and size on disk, the kernels' launches recorded
   inside each program per forward (81 / 28) and no weight cast at capture
   or over a replay, and the artifact against ``ScoreModel.enhance`` on the
   card at the same seed and ``est_snr`` (``EXPORT_TOL``, bitwise printed)
   with both walls per utterance (the ODE's nfev equal too); the card's
   ``sebridge_v3_snr`` artifact against one exported on the CPU from the
   same checkpoint, on the same draws (``WAVEFORM_TOL``); ``cli.serve
   --artifact`` answering one POST of each ``EXPORT_POST_SECONDS`` with
   ``?est_snr=`` (status 200, the loader's output). Every phase prints its
   seconds.

14. The other backbones ("backbones"), at full width: DCUNet
   (DilDCUNet-v2 at the training CLI's defaults, "bN", ``n_fft`` 512,
   redrawn weights and running statistics, its output layer scaled by
   ``DCUNET_OUTPUT_SCALE``): ``bbed_pc`` at N = 30 through its captured
   programs on 1.0 and 1.5 s utterances against the eager path (bitwise),
   card vs CPU at ``BACKBONE_CPU_N`` steps, three train steps at 4 x 256
   frames with the running statistics moving and finite, and one
   ``cli.eval`` file from its checkpoint; NCSN++ with score_sde's DDPM++
   settings (``DDPMPP``: DDPM-style blocks, no FIR, no pyramids,
   positional embedding, dropout 0.1; 57.7M parameters): ``bbed_pc``
   graphed at 1.0 s against eager with its launches per forward (75 / 4),
   a forward card vs CPU, three train steps with dropout on (38 / 41
   launches a step), and every fused-conv and ``groupnorm_silu`` call
   shape of both against the plain versions (``KERNEL_TOL``; the batch-1
   shapes timed beside their bounds). Walls, capture times and peak
   memory are printed beside the card's name and power limit.

15. Parallelism ("parallel"), the paper's 65.6M model (weights redrawn from
   ``TRAIN_WEIGHT_SEED``, float32 pinned) at the CLI's 4 x 256 frames, every
   step from the same weights, batch and generator seed: (1) in this
   process, one train step without a mesh and one on a world-size-1 NCCL
   mesh (``make_train_step(mesh=make_mesh())``): loss, reduced gradients
   and weights bitwise equal, 162 / 56 launches, and the step walls of
   both; (3) ``chain_steps`` 2 against two single steps on two batches:
   bitwise equal weights and EMA, the last loss, 324 / 112 launches; (2)
   ``PARALLEL_RANKS`` ranks spawned on the one card under gloo
   (``parallel.dryrun.launch``; NCCL refuses two ranks on one device), each
   a data-parallel step on its 2 rows of the batch of 4 and then a
   ``(1, 2)`` tensor-parallel step, held to the one-process step: the loss
   within ``PARALLEL_LOSS_RTOL``, the reduced gradients within
   ``PARALLEL_GRAD_TOL`` of their largest magnitude, the weights after
   Adam within ``PARALLEL_PARAM_ATOL`` (2 lr where the reference gradient
   is within the gradient tolerance of zero, whose sign Adam's first step
   follows); each rank's walls, peak memory, launches and the bytes it
   keeps of weights, EMA and moments against one device's.

16. Frames-parallel enhancement ("sequence", ``parallel/sequence.py``): the
   split statistics (``gn_group_sums`` + ``gn_fold_ab``) bitwise against the
   one-pass ``gn_stats_ab`` and each against its plain version, K1/K2 and
   K3 with a given affine (``ab=``) against their plain versions, at the
   sharded path's shapes (a rank's columns plus its neighbours'); then the
   paper's 65.6M NCSN++ (weights redrawn) on one 4.0 s utterance (512
   frames) over ``SEQUENCE_RANKS`` gloo ranks on the one card
   (``parallel.dryrun.launch``): ``sebridge_v2`` in float32 and in the bf16
   trunk and ``bbed_pc`` at N = ``SEQUENCE_PC_N``, each rank's whole
   waveform against the one-device ``enhance`` on the same generator seed
   (``SEQUENCE_ONE_NFE_TOL``, ``SEQUENCE_PC_TOL``; bf16 within the
   one-device bf16-vs-float32 gap), each rank's launches per forward
   (``SEQUENCE_LAUNCHES``), its walls beside the one device's (graphed,
   replayed, eager) and its peak memory.

17. The paper-reproduction path ("import"): the paper's 65.6M model (M6:
   ``sebridge_v3``, SNR-conditioned, fixed_snr 0.17783) and an SNRNet, each
   written as a reference-layout Lightning ``.ckpt`` (a ``dnn.``-prefixed
   state_dict, ``hyper_parameters``, an EMA shadow; weights and shadow
   redrawn from ``IMPORT_SEEDS``), imported by
   ``cli.convert_torch_checkpoint --ema`` (seconds, sizes on disk, and the
   score import's steps apart): the restored parameters and EMA on the card
   bitwise the checkpoint's; ``sebridge_v3_snr`` through ``enhance`` on two
   utterances of the 192-frame bucket, imported against a model loaded
   directly from the same tensors, bitwise (81 / 28 launches a forward);
   then ``cli.reproduce_tables --ckpt M6.ckpt --snr_ckpt
   snr_estimator.ckpt --eta 10 --device cuda`` on a synthetic stand-in (3
   valid and 2 valid2 files of 1.2 s): its own imports, ``cli.eval`` and
   ``cli.deep_eval`` on the card, exit code 1 with a ``PARITY FAIL``
   verdict (redrawn weights cannot match the paper: a pass would mean a
   broken harness), all 24 enforced cells printed and both CSVs complete;
   its wall split into imports, enhance (captures apart) and host scoring.

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
# 40 forwards, on phase 4's 1.0 s utterance (128 frames; phase 4 holds the
# 192-frame bucket's bbed_pc program, and phase 16's time came out of this
# phase's 192-frame runs and phase 13's bbed_pc artifact steps).
SERVING_SAMPLER = dict(predictor="reverse_diffusion", corrector="ald", N=20,
                       timestep_type="logit")
SERVING_SECONDS = (1.0,)
# Each predictor, the langevin corrector, each grid and each SDE, the card
# against the CPU at N = 2 on the 1.0 s utterance: (sde, predictor,
# corrector, grid, N). These hold the samplers' arithmetic on the card to
# the CPU's, so they run the NCSN++ at the full depth (the same 81 / 28
# kernel launches a forward) but SAMPLER_CPU_NF channels wide, with its
# weights redrawn from the same seed: the CPU's side of a 65M forward is ~1 s,
# and phase 3 holds the full width's forward to the CPU already.
SAMPLER_SECONDS = 1.0
SAMPLER_CPU_NF = 32
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
# bbed_ode at rtol = atol = 1e-5: graphed vs eager on the first ODE_SAMPLES
# of the 1.0 s utterance (64 frames; half a 128-frame forward's work, since
# PR 15 paid for phase 13's ODE artifact with it). Card vs CPU on its first
# ODE_CPU_SAMPLES (64 frames), on the SAMPLER_CPU_NF-wide NCSN++ with the
# output layer scaled by ODE_CPU_OUTPUT_SCALE, so that the CPU's side takes
# ~100 evaluations of a narrow forward: the same accepted and rejected steps (flags equal;
# a difference is reported as an accept/reject flip), and the waveform
# within ODE_WAVEFORM_TOL: each drift evaluation differs by up to
# FORWARD_TOL, and the backward flow grows |x - y| ~1000-fold from T = 0.999
# to eps, so differences of a forward's size are held to ten times it.
ODE_SECONDS = 1.0
ODE_SAMPLES = 8000
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
TRAIN_STEPS, TRAIN_WARMUP, BBED_STEPS = 4, 2, 3
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
# forwards a chunk batch); 8 client threads send SERVE_REQUESTS_EACH requests
# each (one since PR 15, which paid for phase 13's artifacts with the
# second), request k of SERVE_SECONDS[k % 8] seconds
SERVE_SAMPLER = {"timestep_type": "logit", "N": 20}
SERVE_FORWARDS = 40
SERVE_SECONDS = (0.6, 1.0, 1.4, 1.8, 2.0, 2.2, 2.6, 3.0)
SERVE_CLIENTS, SERVE_REQUESTS_EACH = 8, 1
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
# phase 11 ("eval"): the evaluation package on a synthetic VBD-style
# dataset (the port's make_synthetic_dataset): a test split of one file per
# duration, four in the 128-frame bucket and two in the 320-frame one (so
# that cli.eval --eval_batch_size 4 runs a full captured batch and an eager
# tail); train / valid / valid2 splits of EVAL_SPLIT_SECONDS files
EVAL_TEST_SECONDS = (0.8, 0.85, 0.9, 1.0, 2.3, 2.5)
EVAL_SPLIT_SECONDS = 2.0
EVAL_BATCH = 4
# cli.eval's certified sampler rd_ald_logit_N20 through batch_enhance
EVAL_LOGIT_FLAGS = ["--N", "20", "--timestep_type", "logit"]
CONV_NAMES = ("mma.sync 64x64", "mma.sync 128x8", "wgmma", "wgmma.ss")
# phase 12 ("snr_train"): the SNR estimator's training at the CLI's defaults
# (batch 4 x 256 frames = 2.04 s crops) on a synthetic dataset of 2.2 s files
SNR_TRAIN_FILES = 8  # two steps an epoch
SNR_VALID_FILES = 4
SNR_TEST_FILES = 2
SNR_SECONDS = 2.2
SNR_STEP_WARMUP = 2
SNR_STEP_REPS = 10
# phase 13 ("export"): the sebridge_v3_snr artifact's two buckets (128 and
# 192 frames), the est_snr its clients pass, the bbed_pc artifacts' steps
# (the real sampler: one step program, replayed N times in the capture),
# the bbed_ode artifact's utterance, each artifact against enhance on the
# card, the launches recorded per forward, and the POSTs through cli.serve
# --artifact
EXPORT_SECONDS = (1.0, 1.5)
EXPORT_EST_SNRS = (0.35, 0.6, 1.2, 2.5)
EXPORT_BBED_N = 30
ODE_EXPORT_SECONDS = 0.5
EXPORT_TOL = 1e-5
EXPORT_LAUNCHES = {"gn_silu_conv3x3": 81, "groupnorm_silu": 28, "fused_bias_leaky_relu": 0}
EXPORT_POST_SECONDS = (0.6, 1.0, 1.2, 1.5)


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


def sampler_weights(torch, **backbone):
    """The NCSN++'s weights for phase 5c (the 65M one unless ``backbone``
    says otherwise), redrawn from a seed."""
    from diffse_tpu_torch.models.ncsnpp import NCSNpp

    net = NCSNpp(**backbone, generator=torch.Generator().manual_seed(0))
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
    narrow = sampler_weights(torch, nf=SAMPLER_CPU_NF)

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

    # 2. each new name, the card against the CPU, eager, the same draws, on
    # the narrow NCSN++
    y = by_seconds[SAMPLER_SECONDS][None]
    ck.reset_launch_counts()
    for sde in sorted({case[0] for case in SAMPLER_CASES}):
        card, cpu = (sampler_model(torch, narrow, sde, device, nf=SAMPLER_CPU_NF)
                     for device in (dev, "cpu"))
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
            label = f"{sde} {predictor} + {corrector}, {grid} grid, N = {n}, nf {SAMPLER_CPU_NF}"
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
    y = by_seconds[ODE_SECONDS][None, :ODE_SAMPLES]
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
    print(f"bbed_ode (rtol = atol = 1e-5), {ODE_SAMPLES / SR} s utterance ({t_pad} frames): nfev "
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

    scaled = sampler_weights(torch, nf=SAMPLER_CPU_NF)
    for name in ("output_layer.weight", "output_layer.bias"):
        scaled[name] = scaled[name] * ODE_CPU_OUTPUT_SCALE
    card = sampler_model(torch, scaled, device=dev, nf=SAMPLER_CPU_NF)
    cpu = sampler_model(torch, scaled, nf=SAMPLER_CPU_NF)
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
    print(f"bbed_ode card vs CPU, {t_pad} frames, nf {SAMPLER_CPU_NF}, output layer x "
          f"{ODE_CPU_OUTPUT_SCALE}, the "
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
        # one eager run, warm since the capture's warm-up: its wall and peak
        gen = torch.Generator(dev).manual_seed(2)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        allocated = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        eager = program(model, gen, y, snr)
        torch.cuda.synchronize()
        eager_wall = time.perf_counter() - t0
        eager_peak = torch.cuda.max_memory_allocated() - allocated
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
    """Phase 9, last part: the training CLI (its ``main(argv)``, in this
    process) with the paper's flags for one epoch of 2 steps into a
    checkpoint, then ``--resume`` for a second epoch; the checkpoint read
    back with ``load_score_model``."""
    import os
    import shutil
    import tempfile

    from diffse_tpu_torch.cli.train import main as train_main
    from diffse_tpu_torch.train import CheckpointManager
    from diffse_tpu_torch.train.restore import load_score_model

    root = tempfile.mkdtemp(prefix="diffse_train_cli_")
    try:
        write_cli_data(os.path.join(root, "data"), seed=20)
        ckpt = os.path.join(root, "ckpt")
        args = ["--modeltype", "sebridge_v3", "--snr_conditioned", "true", "--fixed_snr",
                str(FIXED_SNR), "--transform_type", "exponent", "--sigma-max", "1.0",
                "--num_eval_files", "0", "--base_dir", os.path.join(root, "data"),
                "--ckpt_dir", ckpt, "--max_steps_per_epoch", "2", "--num_workers", "1"]
        for extra in (["--max_epochs", "1"], ["--max_epochs", "2", "--resume"]):
            t0 = time.time()
            state = train_main(args + extra)
            print(f"train CLI {' '.join(extra)}: step {state.step} in {time.time() - t0:.1f} s")
            del state
            torch.cuda.empty_cache()
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
    parts = {}

    def part(name, fn, *args, **kwargs):
        start = time.time()
        out = fn(*args, **kwargs)
        parts[name] = round(time.time() - start, 1)
        torch.cuda.empty_cache()
        return out

    part("ops", check_train_kernels, torch, ck, dev)
    model_path = part("kernel vs plain", check_train_model, torch, ck, dev)
    paper = part("paper steps", run_train_steps, torch, ck, dev, "sebridge_v3 (paper), float32",
                 PAPER_CONFIG, PAPER_SDE_KWARGS, {}, TRAIN_STEPS)
    if not paper["losses"][-1] < paper["losses"][0]:
        raise AssertionError(f"the paper model's loss did not fall: {paper['losses']}")
    # the profiled step: bbed's, one forward and its recompute, half the
    # paper step's kernels for the profiler to read back (since PR 15)
    bbed = part("bbed steps", run_train_steps, torch, ck, dev, "bbed score matching, float32",
                BBED_TRAIN_CONFIG, dict(T_sampling=0.999, k=2.6, theta=0.52), {}, BBED_STEPS,
                profile_step=True)
    bf16 = part("bf16 step", run_train_steps, torch, ck, dev, "sebridge_v3 (paper), bf16 trunk",
                PAPER_CONFIG, PAPER_SDE_KWARGS, {"dtype": "bf16"}, 1)
    part("CLI", run_train_cli, torch, dev)
    print(f"phase train, seconds by part: {parts}")
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


class ProgramLog:
    """Every ``capture.Program`` built inside the block: its launches
    recorded at capture, its replays (counted on, after the model drops it),
    its capture seconds and the card memory reserved right after it; the
    records feed ``card_runs`` as programs do."""

    def __init__(self, torch):
        self.torch, self.records = torch, []

    def __enter__(self):
        import types

        from diffse_tpu_torch.capture import Program

        self.cls, self.init, self.call = Program, Program.__init__, Program.__call__
        log, init, call, torch = self, Program.__init__, Program.__call__, self.torch

        def tracked_init(program, *args, **kwargs):
            init(program, *args, **kwargs)
            program.smoke_record = types.SimpleNamespace(
                launch_counts=dict(program.launch_counts), replays=0,
                conv_config_launches=list(program.conv_config_launches),
                capture_seconds=program.capture_seconds,
                reserved_after=torch.cuda.memory_reserved())
            log.records.append(program.smoke_record)

        def tracked_call(program, *args, **kwargs):
            out = call(program, *args, **kwargs)
            program.smoke_record.replays += 1
            return out

        Program.__init__, Program.__call__ = tracked_init, tracked_call
        return self

    def __exit__(self, *exc):
        self.cls.__init__, self.cls.__call__ = self.init, self.call
        return False


def eval_dataset(root):
    """The phase's dataset under ``root``, written by the port's
    ``make_synthetic_dataset``: train / valid / valid2 splits, and a test
    split of one file per ``EVAL_TEST_SECONDS`` (one call per duration, its
    one test file renamed into the split)."""
    import os
    import shutil

    from diffse_tpu_torch.data.synthetic import make_synthetic_dataset

    make_synthetic_dataset(root, num_train=4, num_valid=2, num_valid2=2, num_test=0,
                           duration_s=EVAL_SPLIT_SECONDS, seed=30, noise_type="white_amod")
    for i, seconds in enumerate(EVAL_TEST_SECONDS):
        one = make_synthetic_dataset(os.path.join(root, f"one{i}"), num_train=0, num_valid=0,
                                     num_valid2=0, num_test=1, duration_s=seconds, seed=31 + i,
                                     noise_type="white_amod")
        for kind in ("clean", "noisy"):
            os.makedirs(os.path.join(root, "test", kind), exist_ok=True)
            os.replace(os.path.join(one, "test", kind, "pte_000.wav"),
                       os.path.join(root, "test", kind, f"t{i:02d}_{seconds:.2f}s.wav"))
        shutil.rmtree(one)


def eval_checkpoints(torch, dev, root):
    """The phase's checkpoints, saved with the port's ``CheckpointManager``
    (EMA = the weights): the 65.6M bbed model and the paper's sebridge_v3
    SNR-conditioned ``ncsnpp`` (weights redrawn from seed 13, float32
    trunk), and a redrawn SNRNet. Returns their directories."""
    import os

    from diffse_tpu_torch.models.score_model import ScoreModel, ScoreModelConfig
    from diffse_tpu_torch.models.snr_model import SNRModel
    from diffse_tpu_torch.train import CheckpointManager, TrainState

    dirs = {}
    for name, config, sde_kwargs in (
            ("bbed", BBED_TRAIN_CONFIG, SAMPLER_SDE_KWARGS["bbed"]),
            ("paper", PAPER_CONFIG, PAPER_SDE_KWARGS)):
        model = ScoreModel(ScoreModelConfig(**config), sde_kwargs=sde_kwargs, device=dev,
                           generator=torch.Generator().manual_seed(0))
        redraw_weights(torch, model.backbone, seed=13)
        dirs[name] = os.path.join(root, name)
        CheckpointManager(dirs[name], hparams=model.hparams).save(
            0, TrainState(model.backbone), {})
        del model
    snr = SNRModel(device=dev, dnn=redraw_snrnet(torch, seed=12))
    dirs["snr"] = os.path.join(root, "snr")
    CheckpointManager(dirs["snr"], monitors=[{"monitor": "snr_error", "mode": "min", "top_k": 3}],
                      hparams=snr.hparams).save(0, TrainState(snr.dnn), {"snr_error": 1.0})
    return dirs


def row_noise(torch, seeds):
    """A noise source whose row ``i`` is drawn on the CPU from a generator
    seeded ``seeds[i]``: a file gets the same draw in a batch as alone."""
    from diffse_tpu_torch.utils import randn_like

    gens = [torch.Generator().manual_seed(s) for s in seeds]

    def noise(like):
        rows = [randn_like(like[:1].cpu(), g) for g in gens]
        return torch.cat(rows).to(like.device)

    return noise


def check_eval_outputs(label, out_dir, test_dir, failures):
    """cli.eval's files: ``_results.csv`` (header, one row per file),
    ``_avg_results.txt``, and each enhanced wav finite and of its input's
    length. Returns the per-file rows."""
    import csv
    import os

    from diffse_tpu_torch.data.wavio import read_wav

    names = sorted(os.listdir(os.path.join(test_dir, "noisy")))
    with open(os.path.join(out_dir, "_results.csv")) as f:
        rows = list(csv.reader(f))
    if rows[0] != ["filename", "pesq", "si_sdr", "estoi"] or [r[0] for r in rows[1:]] != names:
        failures.append(f"{label}: _results.csv has {rows[:1]} and files "
                        f"{[r[0] for r in rows[1:]]}, expected {names}")
    if not os.path.exists(os.path.join(out_dir, "_avg_results.txt")):
        failures.append(f"{label}: no _avg_results.txt")
    if not all(np.isfinite(float(r[2])) for r in rows[1:]):  # a NaN wave shows as SI-SDR
        failures.append(f"{label}: SI-SDR not finite in {rows[1:]}")
    for name in names:
        out, _ = read_wav(os.path.join(out_dir, "all", name))
        noisy, _ = read_wav(os.path.join(test_dir, "noisy", name))
        if out.shape != noisy.shape or not np.isfinite(out).all():
            failures.append(f"{label}: {name} is {out.shape} (input {noisy.shape}), finite "
                            f"{bool(np.isfinite(out).all())}")
    return rows[1:]


def run_eval(torch, ck, dev, card):
    """Phase 11 ("eval"): the evaluation package on the card, through the
    CLIs' ``main(argv)`` in this process: cli.eval per file, batched and
    packed; ``batch_enhance`` on the 1-NFE branch against the per-file path
    and the CPU; cli.deep_eval and ``deep_evaluate_model``; the training CLI
    with validation metrics; cli.eval_snr_est. ``card`` is nvidia-smi's name
    and power limit, printed beside every time. Returns the path's kernel
    runs ``{"eval": ...}``."""
    import gc
    import os
    import shutil
    import tempfile
    import types

    from diffse_tpu_torch.cli import deep_eval as deep_eval_cli
    from diffse_tpu_torch.cli import eval as eval_cli
    from diffse_tpu_torch.cli import eval_snr_est as snr_est_cli
    from diffse_tpu_torch.cli import train as train_cli
    from diffse_tpu_torch.data.wavio import read_wav
    from diffse_tpu_torch.evaluation.batch_eval import batch_enhance, iter_buckets
    from diffse_tpu_torch.evaluation.deep_inference import deep_evaluate_model
    from diffse_tpu_torch.evaluation.inference import eval_enhance_file, estimate_snrs
    from diffse_tpu_torch.train import CheckpointManager, loop
    from diffse_tpu_torch.train.restore import load_score_model, load_snr_model
    from diffse_tpu_torch.train.state import load_ema

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    failures, steps = [], {}
    root = tempfile.mkdtemp(prefix="diffse_eval_")
    try:
        t0 = time.time()
        data = os.path.join(root, "data")
        eval_dataset(data)
        ckpts = eval_checkpoints(torch, dev, os.path.join(root, "ckpt"))
        test_dir = os.path.join(data, "test")
        test_audio = sum(read_wav(os.path.join(test_dir, "noisy", f))[0].shape[-1]
                         for f in os.listdir(os.path.join(test_dir, "noisy"))) / SR
        print(f"eval setup: dataset ({len(EVAL_TEST_SECONDS)} test files, {test_audio:.2f} s of "
              f"audio) and 3 checkpoints in {time.time() - t0:.1f} s")
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        ck.reset_launch_counts()

        def report(step, wall, summary):
            steps[step] = round(wall, 3)
            files, audio = summary["files"], summary["audio_seconds"]
            print(f"{card}: eval step {step}: wall {wall:.3f} s, {files} files, {audio:.2f} s of "
                  f"audio; {files / wall:.3f} files/s, {audio / wall:.3f} audio s per s; card "
                  f"enhance (host clock around the enhance calls) "
                  f"{summary['enhance_seconds']:.3f} s, host scoring (PESQ, SI-SDR, ESTOI, wav "
                  f"write) {summary['scoring_seconds']:.3f} s; memory_reserved "
                  f"{torch.cuda.memory_reserved() / 2**20:.0f} MiB")

        def cli(step, module, args):
            start = time.time()
            summary = module.main(args)
            report(step, time.time() - start, summary)
            gc.collect()
            return summary

        with ProgramLog(torch) as programs:
            # 1. cli.eval, one file at a time through enhance (bbed_pc, 30 steps)
            out1 = os.path.join(root, "eval_per_file")
            cli("1 cli.eval per file (bbed_pc, N 30)", eval_cli,
                ["--destination_folder", out1, "--test_dir", test_dir, "--ckpt", ckpts["bbed"]])
            rows = check_eval_outputs("cli.eval per file", out1, test_dir, failures)
            print(f"cli.eval per file: rows {rows}")

            # 2. batched (rd_ald_logit_N20 through batch_enhance), then packed
            for label, extra in (("2a cli.eval batched", []),
                                 ("2b cli.eval packed", ["--streaming_chunk_frames", "64"])):
                out2 = os.path.join(root, label.split()[0])
                cli(f"{label} (rd_ald_logit_N20, batch {EVAL_BATCH})", eval_cli,
                    ["--destination_folder", out2, "--test_dir", test_dir, "--ckpt",
                     ckpts["bbed"], "--eval_batch_size", str(EVAL_BATCH), *EVAL_LOGIT_FLAGS,
                     *extra])
                rows = check_eval_outputs(label, out2, test_dir, failures)
                print(f"{label}: rows {rows}")

            # 3. batch_enhance on the 1-NFE branch, the caller's CPU draws:
            # against eval_enhance_file file by file, and against the CPU
            start = time.time()
            snr_card, snr_state = load_snr_model(ckpts["snr"], device=dev)
            load_ema(snr_state)
            model, state = load_score_model(ckpts["paper"], snr_model=snr_card.dnn, device=dev)
            load_ema(state)
            names = sorted(os.listdir(os.path.join(test_dir, "noisy")))
            xs = [read_wav(os.path.join(test_dir, "clean", n))[0][0] for n in names]
            ys = [read_wav(os.path.join(test_dir, "noisy", n))[0][0] for n in names]
            est = estimate_snrs(model, ys)
            batches = [idxs for _, idxs in iter_buckets([len(y) for y in ys], EVAL_BATCH)]

            def batch_noise(b):
                return row_noise(torch, [80 + i for i in batches[b]])

            t_batch = time.time()
            outs = batch_enhance(model, xs, ys, "sebridge_v3_snr", batch_size=EVAL_BATCH,
                                 est_snrs=est, fixed_snr=FIXED_SNR, noise=batch_noise)
            t_batch = time.time() - t_batch
            singles = [eval_enhance_file(model, x, y, "sebridge_v3_snr", est_snr=e,
                                         fixed_snr=FIXED_SNR, noise=row_noise(torch, [80 + i]))
                       for i, (x, y, e) in enumerate(zip(xs, ys, est))]
            del model, state
            snr_cpu, snr_cpu_state = load_snr_model(ckpts["snr"], device="cpu")
            load_ema(snr_cpu_state)
            cpu_model, cpu_state = load_score_model(ckpts["paper"], snr_model=snr_cpu.dnn,
                                                    device="cpu")
            load_ema(cpu_state)
            t_cpu = time.time()
            refs = batch_enhance(cpu_model, xs, ys, "sebridge_v3_snr", batch_size=EVAL_BATCH,
                                 est_snrs=est, fixed_snr=FIXED_SNR, noise=batch_noise)
            t_cpu = time.time() - t_cpu
            del cpu_model, cpu_state
            packing = max(float(np.max(np.abs(o - s)) / np.max(np.abs(s)))
                          for o, s in zip(outs, singles))
            cpu_gap = max(float(np.max(np.abs(o - r)) / np.max(np.abs(r)))
                          for o, r in zip(outs, refs))
            finite = all(np.isfinite(o).all() and o.shape == y.shape for o, y in zip(outs, ys))
            steps["3 batch_enhance sebridge_v3_snr"] = round(time.time() - start, 3)
            print(f"{card}: eval step 3, batch_enhance on sebridge_v3_snr (batch {EVAL_BATCH}, "
                  f"batches {batches}, SNRNet estimates {[round(e, 4) for e in est]}): card "
                  f"{t_batch:.3f} s, CPU {t_cpu:.3f} s; batch rows vs eval_enhance_file file "
                  f"by file on the card max|diff|/max|ref| {packing:.3e} (tol {PACKING_TOL}); "
                  f"card vs CPU {cpu_gap:.3e} (tol {WAVEFORM_TOL}); finite and of the inputs' "
                  f"lengths {finite}")
            if packing > PACKING_TOL or cpu_gap > WAVEFORM_TOL or not finite:
                failures.append(f"batch_enhance: vs per file {packing:.3e}, vs CPU "
                                f"{cpu_gap:.3e}, finite {finite}")

            # 4. the 9-SNR sweep: cli.deep_eval on the 2 valid2 files, and
            # deep_evaluate_model (each file one 9-row batch)
            out4 = os.path.join(root, "deep")
            valid2 = os.path.join(data, "valid2")
            cli("4a cli.deep_eval (sebridge_v3_snr)", deep_eval_cli,
                ["--destination_folder", out4, "--test_dir", valid2, "--ckpt", ckpts["paper"],
                 "--snr_ckpt", ckpts["snr"]])
            import csv

            with open(os.path.join(out4, "_results_deep.csv")) as f:
                table = list(csv.reader(f))
            values = [float(v) for row in table[1:] for v in row[1:]]
            print(f"cli.deep_eval: header {table[0][:4]}..., {len(table) - 1} rows of "
                  f"{len(table[0]) - 1} values")
            if (len(table) != 3 or len(table[0]) != 28 or not np.isfinite(values).all()):
                failures.append(f"cli.deep_eval: {len(table) - 1} rows of {len(table[0])} "
                                f"columns, finite {bool(np.isfinite(values).all())}")
            start = time.time()
            model, state = load_score_model(ckpts["paper"], snr_model=snr_card.dnn, device=dev)
            load_ema(state)
            split = types.SimpleNamespace(
                clean_files=[os.path.join(valid2, "clean", f)
                             for f in sorted(os.listdir(os.path.join(valid2, "clean")))],
                noisy_files=[os.path.join(valid2, "noisy", f)
                             for f in sorted(os.listdir(os.path.join(valid2, "noisy")))])
            vals = deep_evaluate_model(model, types.SimpleNamespace(valid_set_2=split), 2,
                                       model_type="sebridge_v3_snr", fixed_snr=FIXED_SNR)
            steps["4b deep_evaluate_model"] = round(time.time() - start, 3)
            print(f"{card}: eval step 4b, deep_evaluate_model on 2 valid2 files (9-row batches): "
                  f"{time.time() - start:.3f} s; 27 scalars {[round(float(v), 4) for v in vals]}")
            if len(vals) != 27 or not np.isfinite(vals).all():
                failures.append(f"deep_evaluate_model: {len(vals)} values, finite "
                                f"{bool(np.isfinite(vals).all())}")
            model.drop_programs()
            del model, state

            # 5. the training CLI with validation metrics (one epoch of 2 steps)
            trained, real_ema_weights = [], loop.ema_weights

            class checked_ema_weights:
                """loop.ema_weights, checking that the trained weights come
                back bit for bit and noting the card memory around it."""

                def __init__(self, state):
                    self.state, self.inner = state, real_ema_weights(state)

                def __enter__(self):
                    self.before = [p.detach().clone() for p in self.state.params]
                    self.reserved = torch.cuda.memory_reserved()
                    return self.inner.__enter__()

                def __exit__(self, *exc):
                    self.inner.__exit__(*exc)
                    same = all(torch.equal(p, b) for p, b in zip(self.state.params, self.before))
                    trained.append((same, self.reserved, torch.cuda.memory_reserved()))
                    return False

            loop.ema_weights = checked_ema_weights
            ckpt5 = os.path.join(root, "train")
            start = time.time()
            try:
                state = train_cli.main([
                    "--modeltype", "sebridge_v3", "--snr_conditioned", "true", "--fixed_snr",
                    str(FIXED_SNR), "--transform_type", "exponent", "--sigma-max", "1.0",
                    "--base_dir", data, "--ckpt_dir", ckpt5, "--snr_ckpt", ckpts["snr"],
                    "--num_eval_files", "2", "--batch_size", "2", "--max_epochs", "1",
                    "--max_steps_per_epoch", "2", "--num_workers", "1"])
            finally:
                loop.ema_weights = real_ema_weights
            steps["5 train CLI"] = round(time.time() - start, 3)
            meta = CheckpointManager(ckpt5)._meta
            best_model, best = load_score_model(ckpt5, monitor="pesq", device=dev)
            print(f"{card}: eval step 5, training CLI (2 steps, validation on 2 files): "
                  f"{time.time() - start:.3f} s; step {state.step}; checkpoint metadata {meta}; "
                  f"load_score_model(monitor='pesq') -> step {best.step}; trained weights after "
                  f"validation equal to before, memory_reserved before / after validation (MiB) "
                  f"{[(s, round(a / 2**20), round(b / 2**20)) for s, a, b in trained]}")
            if (state.step != 2 or not all(k in meta.get("0", {}) for k in
                                           ("pesq", "si_sdr", "estoi"))
                    or best.step != 2 or [t[0] for t in trained] != [True]):
                failures.append(f"train CLI: step {state.step}, metadata {meta}, best step "
                                f"{best.step}, trained weights kept {trained}")
            del state, best_model, best
            gc.collect()

            # 6. the SNR estimator's CLI
            start = time.time()
            out6 = os.path.join(root, "snr_est")
            err = snr_est_cli.main(["--destination_folder", out6, "--test_dir", test_dir,
                                    "--ckpt", ckpts["snr"]])
            steps["6 cli.eval_snr_est"] = round(time.time() - start, 3)
            written = open(os.path.join(out6, "_snr_est_results.txt")).read().strip()
            print(f"{card}: eval step 6, cli.eval_snr_est: {time.time() - start:.3f} s; mean abs "
                  f"SNR error {err:.4f} dB (redrawn SNRNet); {written!r}")
            if not np.isfinite(err) or not written.startswith("mean_abs_snr_error_db"):
                failures.append(f"cli.eval_snr_est: error {err}, file {written!r}")

        for i, r in enumerate(programs.records):
            print(f"{card}: eval program {i}: capture {r.capture_seconds:.3f} s, replays "
                  f"{r.replays}, memory_reserved after it {r.reserved_after / 2**20:.0f} MiB, "
                  f"launches recorded {r.launch_counts}")
        path = card_runs(dict(ck.launch_counts), programs.records)
        print(f"eval step walls (s): {steps}")
        report_paths({"eval": path}, failures)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if failures:
        raise AssertionError("; ".join(failures))
    return {"eval": path}



def run_snr_train(torch, ck, dev, card):
    """Phase 12 ("snr_train"): the SNR estimator's training on the card. The
    train step at the CLI's defaults (batch 4 x 256 frames) on one fixed
    batch: step wall, audio s per s, peak memory. Then
    ``cli.train_snr_est`` (``main(argv)`` in this process) on a synthetic
    VBD-style dataset for an epoch of 2 steps into a checkpoint and a
    resumed second; its checkpoint through ``cli.eval_snr_est`` and, as
    ``--snr_ckpt``, through ``cli.eval`` on the paper's 65.6M sebridge_v3
    SNR-conditioned model (``sebridge_v3_snr``, weights redrawn from seed
    6). Returns the kernel runs of that last part by path."""
    import gc
    import os
    import shutil
    import tempfile

    from diffse_tpu_torch.cli import eval as eval_cli
    from diffse_tpu_torch.cli import eval_snr_est as snr_est_cli
    from diffse_tpu_torch.cli import train_snr_est
    from diffse_tpu_torch.data.synthetic import make_synthetic_dataset
    from diffse_tpu_torch.models.score_model import ScoreModel, ScoreModelConfig
    from diffse_tpu_torch.models.snr_model import SNRModel, SNRModelConfig
    from diffse_tpu_torch.train import CheckpointManager, TrainState
    from diffse_tpu_torch.train.steps import make_train_step

    failures, parts = [], {}
    root = tempfile.mkdtemp(prefix="diffse_snr_train_")
    try:
        start = time.time()
        data = make_synthetic_dataset(os.path.join(root, "data"), num_train=SNR_TRAIN_FILES,
                                      num_valid=SNR_VALID_FILES, num_valid2=0,
                                      num_test=SNR_TEST_FILES, duration_s=SNR_SECONDS, seed=21)
        parts["dataset"] = round(time.time() - start, 1)

        # the step at the CLI's defaults, on one fixed batch
        start = time.time()
        cfg = SNRModelConfig()
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            model = SNRModel(cfg, device=dev)
        state = TrainState(model.dnn, lr=cfg.lr, ema_decay=cfg.ema_decay)
        step = make_train_step(model, preprocess=model.prepare_batch)
        generator = torch.Generator(dev).manual_seed(0)
        samples = (cfg.num_frames - 1) * cfg.hop_length
        pairs = [synthetic_pair(np.random.default_rng(40 + i), samples) for i in range(4)]
        batch = tuple(np.stack([p[k] for p in pairs]) for k in (0, 1))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        walls, losses = [], []
        for _ in range(SNR_STEP_WARMUP + SNR_STEP_REPS):
            t0 = time.perf_counter()
            state, metrics = step(state, batch, generator)
            losses.append(float(metrics["train_loss"]))
            walls.append(time.perf_counter() - t0)
        wall = float(np.median(walls[SNR_STEP_WARMUP:]))
        audio = 4 * samples / SR
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"{card}: SNRNet train step (batch 4 x {cfg.num_frames} frames, "
              f"{sum(p.numel() for p in model.dnn.parameters())} params, float32 pinned): median "
              f"wall {wall * 1e3:.2f} ms after {SNR_STEP_WARMUP} warm-up steps, "
              f"{audio / wall:.1f} s of audio per s, peak memory {peak:.3f} GiB; losses {losses}")
        if not np.all(np.isfinite(losses)):
            failures.append(f"SNRNet step: losses {losses}")
        parts["steps"] = round(time.time() - start, 1)
        del model, state, step
        gc.collect()

        # the CLI: an epoch of 2 steps, then --resume for a second
        ckpt = os.path.join(root, "snr_ckpt")
        args = ["--transform_type", "none", "--base_dir", data, "--ckpt_dir", ckpt,
                "--max_steps_per_epoch", "2", "--num_workers", "1"]
        for extra in (["--max_epochs", "1"], ["--max_epochs", "2", "--resume"]):
            start = time.time()
            state = train_snr_est.main(args + extra)
            parts[f"CLI {' '.join(extra)}"] = round(time.time() - start, 1)
            print(f"train_snr_est {' '.join(extra)}: step {state.step} in "
                  f"{time.time() - start:.1f} s")
        meta = json.load(open(os.path.join(ckpt, "metadata.json")))
        errors = {k: v.get("snr_error") for k, v in meta.items()}
        print(f"{card}: train_snr_est checkpoints {CheckpointManager(ckpt).all_steps()}, "
              f"snr_error (dB) after each epoch {errors}, step {state.step}")
        if state.step != 4 or not all(np.isfinite(v) for v in errors.values() if v is not None):
            failures.append(f"train_snr_est: step {state.step}, snr_error {errors}")
        del state
        gc.collect()

        start = time.time()
        test_dir = os.path.join(data, "test")
        err = snr_est_cli.main(["--destination_folder", os.path.join(root, "est"),
                                "--test_dir", test_dir, "--ckpt", ckpt])
        parts["cli.eval_snr_est"] = round(time.time() - start, 1)
        print(f"cli.eval_snr_est on the trained checkpoint: mean abs SNR error {err:.4f} dB over "
              f"{SNR_TEST_FILES} files")
        if not np.isfinite(err):
            failures.append(f"cli.eval_snr_est: {err}")

        # --snr_ckpt: the paper's 1-NFE mode estimates with the trained SNRNet
        start = time.time()
        v3 = ScoreModel(ScoreModelConfig(**PAPER_CONFIG), sde_kwargs=PAPER_SDE_KWARGS,
                        device=dev, generator=torch.Generator().manual_seed(0))
        redraw_weights(torch, v3.backbone, seed=6)
        score_dir = os.path.join(root, "paper")
        CheckpointManager(score_dir, hparams=v3.hparams).save(0, TrainState(v3.backbone), {})
        del v3
        gc.collect()
        torch.cuda.empty_cache()
        out_dir = os.path.join(root, "enhanced")
        ck.reset_launch_counts()
        with ProgramLog(torch) as programs:
            summary = eval_cli.main(["--destination_folder", out_dir, "--test_dir", test_dir,
                                     "--ckpt", score_dir, "--snr_ckpt", ckpt])
        rows = check_eval_outputs("cli.eval --snr_ckpt", out_dir, test_dir, failures)
        parts["cli.eval --snr_ckpt"] = round(time.time() - start, 1)
        print(f"{card}: cli.eval sebridge_v3_snr --snr_ckpt <trained>: {summary['files']} files, "
              f"rows {rows}")
        path = card_runs(dict(ck.launch_counts), programs.records)
        report_paths({"snr_train: cli.eval --snr_ckpt": path}, failures)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"phase snr_train, seconds by part: {parts}")
    if failures:
        raise AssertionError("; ".join(failures))
    return {"snr_train: cli.eval --snr_ckpt": path}


def artifact_size(path):
    import os

    return sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path)) / 1e6


def artifact_programs(bucket, nfe):
    """``(role, capture.Program, forwards)`` of a loaded artifact bucket: the
    one program of a whole call (``nfe`` forwards), or ``bbed_ode``'s
    start, attempt and finish."""
    if bucket.loop:
        return [(role, program, bucket.programs[role][0]["forwards"])
                for role, program in zip(("start", "attempt", "finish"), bucket.program.programs)]
    return [("call", bucket.program, nfe)]


def report_artifact(label, enhance, meta, failures, card, parts):
    """A loaded artifact's programs: each one's launches recorded per forward
    (81 / 28) and weight casts at its capture (none); its export, save, load
    and capture seconds."""
    capture = 0.0
    for b in enhance.buckets:
        for role, program, forwards in artifact_programs(b, meta["nfe"]):
            launches = {k: v / forwards for k, v in program.launch_counts.items()}
            casts = {k: v for k, v in program.weight_casts.items() if v}
            capture += program.capture_seconds
            print(f"{label}, {b.pad_samples} samples, {role} program: launches recorded per "
                  f"forward {launches}, weight casts at capture {casts or 'none'}, capture "
                  f"{program.capture_seconds:.2f} s")
            if launches != EXPORT_LAUNCHES or casts:
                failures.append(f"{label} {role}: launches per forward {launches}, casts {casts}")
    seconds = meta["seconds"]
    export_s = sum(x["export"] for x in seconds)
    save_s = sum(x["save"] for x in seconds) + meta["weights_save_seconds"]
    print(f"{card}: {label} artifact ({meta['dtype']}, buckets "
          f"{[b['t_pad_frames'] for b in meta['buckets']]} frames, nfe {meta['nfe']}): export "
          f"{export_s:.2f} s, save {save_s:.2f} s, load {meta['load_seconds']:.2f} s (capture "
          f"{capture:.2f} s of it)")
    parts[f"{label}: export + save + load"] = round(export_s + save_s + meta["load_seconds"], 1)


def compare_artifact(torch, ck, label, art_call, ref_call, failures, card, timed_ref=True):
    """``art_call()`` (a replay of the artifact's capture) against
    ``ref_call()`` (``ScoreModel.enhance`` at the same seed, whose first call
    captures its own program; with ``timed_ref`` a second call, a replay, is
    timed) within ``EXPORT_TOL``, bitwise printed, both walls, and no weight
    cast or pack over the artifact's call."""
    casts = dict(ck.weight_casts)
    t0 = time.perf_counter()
    out = art_call()
    art_wall = time.perf_counter() - t0
    cast = ck.weight_casts != casts
    if cast:
        failures.append(f"{label}: weight casts {casts} -> {ck.weight_casts} over a replay")
    t0 = time.perf_counter()
    ref = ref_call()
    ref_wall = time.perf_counter() - t0
    if timed_ref:
        t0 = time.perf_counter()
        ref = ref_call()
        ref_wall = time.perf_counter() - t0
    err = float(np.max(np.abs(out - ref)) / np.max(np.abs(ref)))
    print(f"{card}: {label} artifact vs enhance, same seed: max|diff|/max|ref| {err:.3e} (tol "
          f"{EXPORT_TOL}), bitwise equal {bool(np.array_equal(out, ref))}; wall artifact "
          f"{art_wall:.4f} s, enhance {ref_wall:.4f} s "
          f"({'a replay' if timed_ref else 'its first call, the capture included'}); weight "
          f"casts over the artifact's call: {ck.weight_casts if cast else 'none'}")
    if out.shape != ref.shape or not np.isfinite(out).all() or err > EXPORT_TOL:
        failures.append(f"{label}: shape {out.shape} vs {ref.shape}, deviates by {err:.3e}")


def bf16_window(torch, ck, records):
    """A bf16 window's kernel runs (``card_runs``) with the conv's split by
    instantiation (``conv_launches``), from the programs' records."""
    window = list(ck.conv_config_launches)
    runs = [w + sum(r.conv_config_launches[i] * (r.replays - 1) for r in records)
            for i, w in enumerate(window)]
    recorded = [sum(r.conv_config_launches[i] for r in records) for i in range(len(window))]
    path = card_runs(dict(ck.launch_counts), records)
    return {"runs": {**path["runs"], **conv_launches(ck, runs)},
            "recorded": {**path["recorded"], **conv_launches(ck, recorded)}}


def export_model(torch, dev, name):
    """Phase 13's models, every weight redrawn: the 65.6M bbed model from seed
    4 with the float32 ("bbed") or the bf16 trunk ("bbed_bf16"), and the
    paper's model from seed 6 with the bf16 trunk ("paper_bf16"; its float32
    checkpoint's weights)."""
    from diffse_tpu_torch.models.score_model import ScoreModel, ScoreModelConfig

    backbone = {"dtype": "bf16"} if name.endswith("_bf16") else {}
    if name.startswith("paper"):
        model = ScoreModel(ScoreModelConfig(**PAPER_CONFIG), backbone_kwargs=backbone,
                           sde_kwargs=PAPER_SDE_KWARGS, device=dev,
                           generator=torch.Generator().manual_seed(0))
        redraw_weights(torch, model.backbone, seed=6)
        return model
    model = ScoreModel(ScoreModelConfig(backbone="ncsnpp", sde="bbed", model_type="bbed",
                                        snr_conditioned="false", sigma_max=0.5),
                       backbone_kwargs=backbone,
                       sde_kwargs=dict(T_sampling=0.999, k=2.6, theta=0.52, N=30),
                       device=dev, generator=torch.Generator().manual_seed(0))
    redraw_weights(torch, model.backbone, seed=4)
    return model


def export_artifacts(jobs):
    """Phase 13's artifacts ``(path, model name, branch, seconds)`` of
    ``export_model``'s models, exported one after another in a process of
    its own (``bbed_pc`` at ``EXPORT_BBED_N`` steps): an export's trace and
    save are host work, ~3 s a traced forward, which runs beside the rest
    of the phase."""
    import torch

    from diffse_tpu_torch.serving.export import save_artifact

    for path, name, branch, seconds in jobs:
        model = export_model(torch, torch.device("cuda", 0), name)
        save_artifact(path, model, None, branch, int(seconds * SR), n_steps=EXPORT_BBED_N)
        del model
        torch.cuda.empty_cache()


def run_export(torch, ck, dev, card):
    """Phase 13 ("export"): the exported enhance programs. In float32: the
    paper's 65.6M sebridge_v3 SNR-conditioned model (weights redrawn from
    seed 6, saved with ``CheckpointManager``) through
    ``cli.export_artifact`` with two buckets (1.0 and 1.5 s: 128 and 192
    frames); the 65.6M bbed model (redrawn from seed 4) as a ``bbed_pc``
    artifact of ``EXPORT_BBED_N`` steps (start, one step replayed N times,
    finish, in one captured graph) and as a ``bbed_ode`` artifact (start,
    attempt, finish, a ``LoopProgram``); the card's ``sebridge_v3_snr``
    artifact against one exported on the CPU from the same checkpoint,
    given the same draws (``WAVEFORM_TOL``); ``cli.serve --artifact``
    answering a POST of each ``EXPORT_POST_SECONDS`` with ``?est_snr=``.
    In bf16, counted apart: the same bbed weights' ``bbed_pc`` artifact and
    the paper's model's ``sebridge_v3_snr``. The ``bbed_ode`` and the bf16
    artifacts are exported in two processes of their own
    (``export_artifacts``), started with the phase. Each artifact's programs
    (``report_artifact``) and its output against ``ScoreModel.enhance`` on
    the card at the same seed and ``est_snr`` (``compare_artifact``). TF32
    allowed for cuDNN (torch's default: the loader pins float32 itself).
    Returns the float32 and the bf16 kernel runs of the phase by path."""
    import gc
    import multiprocessing
    import os
    import shutil
    import tempfile
    import urllib.request

    from diffse_tpu_torch.cli import export_artifact
    from diffse_tpu_torch.cli import serve as serve_cli
    from diffse_tpu_torch.data.wavio import parse_wav, wav_bytes
    from diffse_tpu_torch.models.score_model import ScoreModel, ScoreModelConfig
    from diffse_tpu_torch.serving.export import load_artifact, save_artifact
    from diffse_tpu_torch.train import CheckpointManager, TrainState
    from diffse_tpu_torch.train.restore import load_score_model
    from diffse_tpu_torch.train.state import load_ema

    failures, parts = [], {}
    root = tempfile.mkdtemp(prefix="diffse_export_")
    pairs = main_path_pairs()
    _, noisy = pairs[0]
    # torch's default, as a user's process has it: the loader pins float32 itself
    torch.backends.cudnn.allow_tf32 = True
    print("phase 13 with torch's defaults: torch.backends.cudnn.allow_tf32=True, "
          "torch.backends.cuda.matmul.allow_tf32=False")

    def compare(label, out, ref, tol):
        err = float(np.max(np.abs(out - ref)) / np.max(np.abs(ref)))
        print(f"{label}: max|diff|/max|ref| {err:.3e} (tol {tol}), bitwise equal "
              f"{bool(np.array_equal(out, ref))}")
        if out.shape != ref.shape or not np.isfinite(out).all() or err > tol:
            failures.append(f"{label}: shape {out.shape} vs {ref.shape}, deviates by {err:.3e}")

    def pc_artifact(label, model, art):
        start = time.time()
        pc_enhance, meta = load_artifact(art)
        print(f"{label}: {artifact_size(art):.1f} MB on disk")
        report_artifact(label, pc_enhance, meta, failures, card, parts)
        compare_artifact(torch, ck, label, lambda: pc_enhance(noisy, seed=5),
                         lambda: model.enhance(noisy[None], noisy[None], N=EXPORT_BBED_N,
                                               generator=torch.Generator(dev).manual_seed(5)),
                         failures, card)
        parts[label] = round(time.time() - start, 1)

    # the exports of bbed_ode and of the bf16 artifacts, in two processes
    # beside the rest of the phase
    art_ode, art_pc16, art_v3_16 = (os.path.join(root, name)
                                    for name in ("art_ode", "art_pc_bf16", "art_v3_bf16"))
    jobs = {"bbed_ode": [(art_ode, "bbed", "bbed_ode", ODE_EXPORT_SECONDS)],
            "bf16": [(art_pc16, "bbed_bf16", "bbed_pc", EXPORT_SECONDS[0]),
                     (art_v3_16, "paper_bf16", "sebridge_v3_snr", EXPORT_SECONDS[0])]}
    exports = {key: multiprocessing.get_context("spawn").Process(target=export_artifacts,
                                                                 args=(job,))
               for key, job in jobs.items()}
    t_exports = time.time()
    for process in exports.values():
        process.start()

    def joined(key):
        exports[key].join(timeout=900)
        if exports[key].exitcode != 0:
            raise AssertionError(f"the {key} artifacts' export exited with "
                                 f"{exports[key].exitcode}")
        parts[f"{key} export + save, in its own process (started with the phase)"] = round(
            time.time() - t_exports, 1)

    try:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        ck.reset_launch_counts()
        with ProgramLog(torch) as programs:
            # the paper's 1-NFE mode, through the export CLI
            start = time.time()
            v3 = ScoreModel(ScoreModelConfig(**PAPER_CONFIG), sde_kwargs=PAPER_SDE_KWARGS,
                            device=dev, generator=torch.Generator().manual_seed(0))
            redraw_weights(torch, v3.backbone, seed=6)
            ckpt = os.path.join(root, "paper")
            CheckpointManager(ckpt, hparams=v3.hparams).save(0, TrainState(v3.backbone), {})
            del v3
            gc.collect()
            art = os.path.join(root, "art_v3")
            export_artifact.main(["--ckpt", ckpt, "--out", art, "--utt_seconds",
                                  *map(str, EXPORT_SECONDS)])
            parts["export sebridge_v3_snr (CLI, checkpoint load included)"] = round(
                time.time() - start, 1)
            enhance, meta = load_artifact(art)
            print(f"sebridge_v3_snr artifact: {artifact_size(art):.1f} MB on disk")
            report_artifact("sebridge_v3_snr float32", enhance, meta, failures, card, parts)
            model, state = load_score_model(ckpt, device=dev)
            load_ema(state)
            for i, (_, y) in enumerate(pairs):
                est = float(np.float32(EXPORT_EST_SNRS[i]))
                compare_artifact(
                    torch, ck, f"sebridge_v3_snr float32, {UTTERANCE_SECONDS[i]} s, est_snr {est}",
                    lambda: enhance(y, seed=i, est_snr=est),
                    lambda: model.enhance(y[None], y[None],
                                          generator=torch.Generator(dev).manual_seed(i),
                                          oracle=True, noise_rms=est, clean_rms=1.0),
                    failures, card)

            # the card's artifact against the CPU's, on the same draws
            start = time.time()
            cpu_model, cpu_state = load_score_model(ckpt, device="cpu")
            load_ema(cpu_state)
            art_cpu = os.path.join(root, "art_v3_cpu")
            save_artifact(art_cpu, cpu_model, None, "sebridge_v3_snr", int(EXPORT_SECONDS[0] * SR))
            cpu_enhance, cpu_meta = load_artifact(art_cpu)
            bucket = cpu_enhance.buckets[0]
            rng = np.random.default_rng(8)
            shape = (bucket.draws, *bucket.draw_shape)
            draws = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) / np.sqrt(2)
            est = float(np.float32(EXPORT_EST_SNRS[0]))
            compare("sebridge_v3_snr artifact, card vs CPU artifact (same draws)",
                    enhance(noisy, est_snr=est, draws=draws),
                    cpu_enhance(noisy, est_snr=est, draws=draws), WAVEFORM_TOL)
            parts["CPU artifact"] = round(time.time() - start, 1)
            print(f"CPU artifact: export + save {cpu_meta['seconds']}, load "
                  f"{cpu_meta['load_seconds']:.2f} s, {artifact_size(art_cpu):.1f} MB")
            del cpu_model, cpu_state, cpu_enhance, model, state
            gc.collect()

            # bbed_pc, EXPORT_BBED_N steps, and bbed_ode, float32
            bbed = export_model(torch, dev, "bbed")
            art_pc = os.path.join(root, "art_pc")
            save_artifact(art_pc, bbed, None, "bbed_pc", int(EXPORT_SECONDS[0] * SR),
                          n_steps=EXPORT_BBED_N)
            pc_artifact(f"bbed_pc N={EXPORT_BBED_N} float32", bbed, art_pc)
            start = time.time()
            joined("bbed_ode")
            ode_enhance, ode_meta = load_artifact(art_ode)
            y_ode = noisy[:int(ODE_EXPORT_SECONDS * SR)]
            nfe = []

            def ode_ref():
                out, n, _ = bbed.enhance(y_ode[None], y_ode[None], sampler_type="ode",
                                         generator=torch.Generator(dev).manual_seed(7),
                                         timeit=True)
                nfe.append(n)
                return out

            report_artifact("bbed_ode float32", ode_enhance, ode_meta, failures, card, parts)
            compare_artifact(torch, ck, "bbed_ode float32", lambda: ode_enhance(y_ode, seed=7),
                             ode_ref, failures, card, timed_ref=False)
            flags = ode_enhance.buckets[0].flags
            print(f"bbed_ode artifact: flags [done, nfev, attempts, status] {flags}, enhance's "
                  f"nfev {nfe[-1]}; {artifact_size(art_ode):.1f} MB on disk")
            if flags[1] != nfe[-1] or not flags[0]:
                failures.append(f"bbed_ode artifact: flags {flags}, enhance's nfev {nfe[-1]}")
            parts["bbed_ode float32"] = round(time.time() - start, 1)
            del bbed, ode_enhance
            gc.collect()

            # cli.serve --artifact: EXPORT_POSTS requests, one after another
            start = time.time()
            server, service, thread = serve_cli.main(["--artifact", art, "--port", "0"],
                                                     block=False)
            try:
                host, port = server.server_address[:2]
                wavs = serve_wavs(EXPORT_POST_SECONDS, seed=23)
                for k, y in enumerate(wavs):
                    est = float(np.float32(EXPORT_EST_SNRS[k % len(EXPORT_EST_SNRS)]))
                    req = urllib.request.Request(
                        f"http://{host}:{port}/enhance?est_snr={est!r}",
                        data=wav_bytes(y, SR, subtype="float32"), method="POST")
                    t0 = time.perf_counter()
                    with urllib.request.urlopen(req, timeout=300) as r:
                        status, got = r.status, parse_wav(r.read())[0][0]
                    latency = time.perf_counter() - t0
                    want = enhance(y, seed=k, est_snr=est)  # the service's request k: seed k
                    print(f"cli.serve --artifact POST {k} ({len(y) / SR:.2f} s): status {status}, "
                          f"latency {latency:.4f} s, equal to the loader's output "
                          f"{bool(np.array_equal(got, want))}")
                    if status != 200 or got.shape != y.shape or not np.isfinite(got).all():
                        failures.append(f"POST {k}: status {status}, shape {got.shape}")
                    elif not np.array_equal(got, want):
                        failures.append(f"POST {k}: differs from the loader's output")
                with urllib.request.urlopen(f"http://{host}:{port}/stats", timeout=30) as r:
                    stats = json.loads(r.read())
                print(f"cli.serve --artifact stats: {stats}")
                if stats["requests"] != len(wavs) or stats["errors"]:
                    failures.append(f"cli.serve --artifact stats {stats}")
            finally:
                server.shutdown()
                service.close()
            parts["cli.serve --artifact"] = round(time.time() - start, 1)
            del enhance
            gc.collect()
        path = card_runs(dict(ck.launch_counts), programs.records)

        # the bf16 trunk, counted apart: bbed_pc on the same bbed weights and
        # the paper's model (redrawn as its checkpoint) at 1.0 s
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        ck.reset_launch_counts()
        with ProgramLog(torch) as programs:
            joined("bf16")
            bbed16 = export_model(torch, dev, "bbed_bf16")
            pc_artifact(f"bbed_pc N={EXPORT_BBED_N} bf16", bbed16, art_pc16)
            del bbed16
            gc.collect()
            start = time.time()
            v3 = export_model(torch, dev, "paper_bf16")
            enhance16, meta16 = load_artifact(art_v3_16)
            est = float(np.float32(EXPORT_EST_SNRS[0]))
            report_artifact("sebridge_v3_snr bf16", enhance16, meta16, failures, card, parts)
            compare_artifact(torch, ck, "sebridge_v3_snr bf16",
                             lambda: enhance16(noisy, seed=3, est_snr=est),
                             lambda: v3.enhance(noisy[None], noisy[None],
                                                generator=torch.Generator(dev).manual_seed(3),
                                                oracle=True, noise_rms=est, clean_rms=1.0),
                             failures, card)
            print(f"sebridge_v3_snr bf16 artifact: {artifact_size(art_v3_16):.1f} MB on disk")
            parts["sebridge_v3_snr bf16"] = round(time.time() - start, 1)
            del v3, enhance16
            gc.collect()
        bf16_path = bf16_window(torch, ck, programs.records)
        paths = {"export: artifacts, enhance, cli.serve --artifact": path}
        bf16_paths = {"export: bf16 artifacts, enhance (graphed)": bf16_path}
        report_paths({**paths, **bf16_paths}, failures)
    finally:
        for process in exports.values():
            if process.is_alive():
                process.terminate()
            process.join(timeout=60)
        shutil.rmtree(root, ignore_errors=True)
    print(f"phase export, seconds by part: {parts}")
    if failures:
        raise AssertionError("; ".join(failures))
    return paths, bf16_paths

# Phase 14: the other backbones at full width. DCUNet (DilDCUNet-v2 at the
# training CLI's defaults; it needs n_fft 512, 257 bins) and score_sde's
# DDPM++ configuration of NCSN++ (nf 128, 57.7M parameters)
DCUNET_CLI = dict(dcunet_architecture="DilDCUNet-v2", dcunet_time_embedding="gfp",
                  dcunet_temb_layers_global=1, dcunet_temb_layers_local=1,
                  dcunet_temb_activation="silu", dcunet_time_embedding_complex=False,
                  dcunet_fix_length="pad", dcunet_mask_bound="none", dcunet_norm_type="bN",
                  dcunet_activation="leaky_relu")
DCUNET_N_FFT = 512
DDPMPP = dict(resblock_type="ddpm", fir=False, resamp_with_conv=True, progressive="none",
              progressive_input="none", embedding_type="positional", dropout=0.1)
# DCUNet's output layer scaled after the redraw: redrawn weights give outputs
# near 90, which 30 reverse steps of BBED grow past float32's range; at 0.01
# (outputs near 1) the samples stay finite
DCUNET_OUTPUT_SCALE = 0.01
BACKBONE_SECONDS = (1.0, 1.5)
BACKBONE_CPU_N = 2        # bbed_pc steps of the card-vs-CPU check (4 forwards)
BACKBONE_TRAIN_STEPS = 3
# kernel launches a forward of the DDPM++ NCSN++: two fused chains in each of
# its 37 residual blocks and the output head; the 4 attention blocks' norms.
# In training with dropout each block runs one fused chain and one
# groupnorm_silu (the dropout sits between the second SiLU and Conv_1).
DDPMPP_EVAL_LAUNCHES = {"gn_silu_conv3x3": 75, "groupnorm_silu": 4, "fused_bias_leaky_relu": 0}
DDPMPP_TRAIN_LAUNCHES = {"gn_silu_conv3x3": 38, "groupnorm_silu": 41, "fused_bias_leaky_relu": 0}


def _kernel_calls(torch, model, run):
    """The (B, H, W, Cin, Cout, skip_coef or None) of each fused-conv call and
    the (B, H, W, C) of each groupnorm_silu call a DDPM++ forward makes,
    from its blocks' input shapes (``run`` drives the forward)."""
    from diffse_tpu_torch.models import layers

    convs, norms, hooks = set(), set(), []

    def block_hook(mod, args):
        b, c, h, w = args[0].shape
        convs.add((b, h, w, c, mod.out_ch, None))
        if mod.training and mod.dropout > 0:
            norms.add((b, h, w, mod.out_ch))
        else:
            convs.add((b, h, w, mod.out_ch, mod.out_ch, mod.skip_coef))

    def attn_hook(mod, args):
        b, c, h, w = args[0].shape
        norms.add((b, h, w, c))

    def head_hook(mod, args):  # GroupNorm -> SiLU -> conv3x3 to 4 channels
        b, _, h, w = args[0].shape
        convs.add((b, h, w, mod.nf, 4, None))

    hooks.append(model.backbone.register_forward_pre_hook(head_hook))
    for m in model.backbone.modules():
        if isinstance(m, layers.ResnetBlockDDPMpp):
            hooks.append(m.register_forward_pre_hook(block_hook))
        elif isinstance(m, layers.AttnBlockpp):
            hooks.append(m.register_forward_pre_hook(attn_hook))
    try:
        run()
    finally:
        for h in hooks:
            h.remove()
    return convs, norms


def check_backbone_kernel_calls(torch, ck, dev, convs, norms):
    """Each fused-conv and groupnorm_silu call shape of the DDPM++ path (and
    the fused conv with ``skip_coef`` 1, which ``skip_rescale=False`` gives)
    held against its plain version on the card (``KERNEL_TOL``), with the
    max error, times and bound printed."""
    rng = np.random.default_rng(50)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev)

    failures, worst = [], {"gn_silu_conv3x3": 0.0, "groupnorm_silu": 0.0}
    extra = {(1, 256, 128, 128, 128, 1.0)}
    for b, h, w, cin, cout, coef in sorted(convs | extra, key=str):
        x = t(rng.standard_normal((b, h, w, cin)))
        args = (x, t(1 + 0.1 * rng.standard_normal(cin)), t(0.1 * rng.standard_normal(cin)),
                t(0.05 * rng.standard_normal((3, 3, cin, cout))),
                t(0.1 * rng.standard_normal((b, cout))), min(cin // 4, 32))
        kw = {} if coef is None else dict(skip=t(rng.standard_normal((b, h, w, cout))),
                                          skip_coef=coef)
        out = ck.groupnorm_silu_conv3x3(*args, **kw)
        ref = ck.groupnorm_silu_conv3x3_reference(*args, **kw)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        ok = torch.allclose(out, ref, **KERNEL_TOL)
        name = (f"gn_silu_conv3x3 {[b, h, w, cin]}->{cout}"
                f"{'' if coef is None else f' +skip x{coef:.4f}'}")
        timed = ""
        if b == 1:  # the enhance path's shapes are timed; training's are checked
            times = timing(torch, lambda: ck.groupnorm_silu_conv3x3(*args, **kw),
                           lambda: ck.groupnorm_silu_conv3x3_reference(*args, **kw))
            bound_ms, bound_by = conv_bounds(b, h, w, cin, cout, coef is not None)["tf32x3"]
            timed = f" | {describe(times, bound_ms, bound_by)}"
        print(f"{name}: max_abs_err {err:.3e} ok {ok}{timed}")
        worst["gn_silu_conv3x3"] = max(worst["gn_silu_conv3x3"], err)
        if not ok:
            failures.append(name)
    for b, h, w, c in sorted(norms):
        x = t(2 * rng.standard_normal((b, h, w, c)) + 1)
        args = (x, t(1 + 0.1 * rng.standard_normal(c)), t(0.1 * rng.standard_normal(c)),
                min(c // 4, 32))
        for apply_silu in (True, False):
            out = ck.groupnorm_silu(*args, apply_silu=apply_silu)
            ref = ck.groupnorm_silu_reference(*args, apply_silu=apply_silu)
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            ok = torch.allclose(out, ref, **KERNEL_TOL)
            name = f"groupnorm_silu {[b, h, w, c]} silu={apply_silu}"
            timed = ""
            if b == 1:
                times = timing(torch, lambda: ck.groupnorm_silu(*args, apply_silu=apply_silu),
                               lambda: ck.groupnorm_silu_reference(*args, apply_silu=apply_silu))
                bound_ms, bound_by = bound((9 if apply_silu else 5) * x.numel(),
                                           4 * (2 * x.numel() + 2 * c))
                timed = f" | {describe(times, bound_ms, bound_by)}"
            print(f"{name}: max_abs_err {err:.3e} ok {ok}{timed}")
            worst["groupnorm_silu"] = max(worst["groupnorm_silu"], err)
            if not ok:
                failures.append(name)
    print(f"backbones: {len(convs | extra)} fused-conv and {2 * len(norms)} groupnorm_silu call "
          f"shapes against their plain versions; max_abs_err {worst} (tol {KERNEL_TOL})")
    return failures


def _graphed_vs_eager(torch, dev, label, model, waves, seed_base, failures, card):
    """``enhance`` of each wave through its captured program against the eager
    path on the same generator state (bitwise); prints each first call
    (capture) and replay wall."""
    from diffse_tpu_torch.utils import randn_like

    for i, y in enumerate(waves):
        seed = seed_base + i
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.enhance(y[None], y[None], generator=torch.Generator(dev).manual_seed(seed))
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        graphed = model.enhance(y[None], y[None], generator=torch.Generator(dev).manual_seed(seed))
        wall = time.perf_counter() - t0
        gen = torch.Generator(dev).manual_seed(seed)
        eager = model.enhance(y[None], y[None], noise=lambda like: randn_like(like, gen))
        bitwise = bool(np.array_equal(graphed, eager))
        err = float(np.max(np.abs(graphed - eager)) / np.max(np.abs(eager)))
        print(f"{label}, {len(y) / SR:.2f} s utterance: first call (eager warm-up, capture, "
              f"replay) {first:.3f} s, replay wall {wall:.4f} s per utterance, replay equal to "
              f"eager bit for bit {bitwise} (max|diff|/max|eager| {err:.3e}), finite "
              f"{bool(np.isfinite(graphed).all())} [{card}]")
        if not bitwise or graphed.shape != y.shape or not np.isfinite(graphed).all():
            failures.append(f"{label} {len(y) / SR} s: replay vs eager bitwise {bitwise}, "
                            f"shape {graphed.shape}")


def _card_vs_cpu(torch, label, model, make_cpu, y, failures):
    """bbed_pc at ``BACKBONE_CPU_N`` steps, card against the port's CPU path,
    both on CPU-drawn noise (``WAVEFORM_TOL``)."""
    cpu = make_cpu()
    cpu.backbone.load_state_dict({k: v.cpu() for k, v in model.backbone.state_dict().items()})
    out = model.enhance(y[None], y[None], noise=cpu_noise(torch, 51), N=BACKBONE_CPU_N)
    ref = cpu.enhance(y[None], y[None], noise=cpu_noise(torch, 51), N=BACKBONE_CPU_N)
    err = float(np.max(np.abs(out - ref)) / np.max(np.abs(ref)))
    print(f"{label}: bbed_pc N={BACKBONE_CPU_N}, card vs CPU on the same draws: "
          f"max|diff|/max|ref| {err:.3e} (tol {WAVEFORM_TOL})")
    if not err <= WAVEFORM_TOL:
        failures.append(f"{label}: card vs CPU {err:.3e}")


def _train_backbone(torch, ck, dev, label, model, steps, failures, card, expected=None):
    """``steps`` train steps on one fixed batch of the CLI's 4 x 256 frames
    (the same draws each step); finite losses, launches per step. Returns
    the launch counts over the steps and the median step wall."""
    from diffse_tpu_torch.train import TrainState, make_train_step

    state = TrainState(model.backbone, lr=model.cfg.lr, ema_decay=model.cfg.ema_decay)
    step = make_train_step(model, preprocess=model.prepare_batch)
    n = (TRAIN_FRAMES - 1) * model.cfg.hop_length
    rng = np.random.default_rng(52)
    pairs = [synthetic_pair(rng, n) for _ in range(TRAIN_BATCH)]
    wavs = (np.stack([c for c, _ in pairs]), np.stack([y for _, y in pairs]))
    losses, walls, total = [], [], None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i in range(steps):
        ck.reset_launch_counts()
        t0 = time.perf_counter()
        state, metrics = step(state, wavs, torch.Generator(dev).manual_seed(53))
        losses.append(metrics["train_loss"].item())
        walls.append(time.perf_counter() - t0)
        counts = dict(ck.launch_counts)
        total = counts if total is None else {k: total[k] + v for k, v in counts.items()}
        if expected is not None and counts != expected:
            failures.append(f"{label} step {i + 1}: launches {counts}, expected {expected}")
    peak = torch.cuda.max_memory_allocated()
    print(f"{label}: {steps} train steps on one batch of {TRAIN_BATCH} x {TRAIN_FRAMES} frames: "
          f"losses {[f'{v:.6g}' for v in losses]}, step walls {[f'{w:.3f}' for w in walls]} s, "
          f"max_memory_allocated {peak / 2**30:.2f} GiB; launches per step "
          f"{counts} [{card}]")
    if not np.all(np.isfinite(losses)):
        failures.append(f"{label}: losses {losses}")
    return total


def run_backbones(torch, ck, dev, card):
    """Phase 14 ("backbones"): DCUNet and the DDPM++ NCSN++ at full width.
    DCUNet (DilDCUNet-v2 at the training CLI's defaults, "bN", n_fft 512):
    bbed_pc at N = 30 through its captured programs on 1.0 and 1.5 s
    utterances against the eager path (bitwise), card vs CPU, three train
    steps with the running statistics moving and finite, one ``cli.eval``
    file from its checkpoint. DDPM++ (score_sde's settings, dropout 0.1):
    bbed_pc graphed at 1.0 s with the kernels' launches per forward, a
    forward card vs CPU, each of its fused-conv and groupnorm_silu call
    shapes against the plain versions, three train steps with dropout on.
    Returns the kernel runs by path."""
    import os
    import shutil
    import tempfile

    from diffse_tpu_torch.cli import eval as eval_cli
    from diffse_tpu_torch.models.score_model import ScoreModel, ScoreModelConfig
    from diffse_tpu_torch.train import CheckpointManager, TrainState

    sde_kwargs = SAMPLER_SDE_KWARGS["bbed"]
    failures, paths = [], {}
    rng = np.random.default_rng(54)
    waves = [synthetic_pair(rng, int(s * SR))[1] for s in BACKBONE_SECONDS]

    # (a) DCUNet
    def dcunet(device):
        cfg = ScoreModelConfig(backbone="dcunet", sde="bbed", model_type="bbed",
                               n_fft=DCUNET_N_FFT)
        return ScoreModel(cfg, backbone_kwargs=DCUNET_CLI, sde_kwargs=sde_kwargs, device=device,
                          generator=torch.Generator().manual_seed(0))

    model = dcunet(dev)
    redraw_weights(torch, model.backbone, seed=55)
    g = torch.Generator().manual_seed(56)
    with torch.no_grad():
        for p in model.backbone.output_layer.parameters():
            p.mul_(DCUNET_OUTPUT_SCALE)
        for name, b in model.backbone.named_buffers():
            b.copy_((torch.rand(b.shape, generator=g) + 0.5) if name.endswith("var")
                    else 0.1 * torch.randn(b.shape, generator=g))
    n_params = sum(p.numel() for p in model.backbone.parameters())
    ck.reset_launch_counts()
    _graphed_vs_eager(torch, dev, f"dcunet ({n_params} params) bbed_pc N=30", model, waves, 60,
                      failures, card)
    paths["dcunet bbed_pc (graphed and eager)"] = card_runs(
        dict(ck.launch_counts), [p for _, p in model._graphs.values()])
    _card_vs_cpu(torch, "dcunet", model, lambda: dcunet("cpu"), waves[0], failures)
    model.drop_programs()
    before = {n: b.clone() for n, b in model.backbone.named_buffers()}
    ck.reset_launch_counts()
    paths["dcunet train"] = card_runs(_train_backbone(
        torch, ck, dev, "dcunet", model, BACKBONE_TRAIN_STEPS, failures, card), [])
    moved = sum(not torch.equal(before[n], b) for n, b in model.backbone.named_buffers())
    finite = all(bool(torch.isfinite(b).all()) for b in model.backbone.buffers())
    print(f"dcunet: running statistics moved in {moved} of {len(before)} buffers, finite {finite}")
    if moved != len(before) or not finite:
        failures.append(f"dcunet: statistics moved {moved}/{len(before)}, finite {finite}")
    root = tempfile.mkdtemp(prefix="diffse_backbones_")
    try:
        ckpt = os.path.join(root, "dcunet")
        CheckpointManager(ckpt, hparams=model.hparams).save(0, TrainState(model.backbone), {})
        eval_dataset_root = os.path.join(root, "data")
        from diffse_tpu_torch.data.synthetic import make_synthetic_dataset
        make_synthetic_dataset(eval_dataset_root, num_train=0, num_valid=0, num_valid2=0,
                               num_test=1, duration_s=1.2, seed=57)
        out_dir = os.path.join(root, "out")
        test_dir = os.path.join(eval_dataset_root, "test")
        t0 = time.time()
        eval_cli.main(["--destination_folder", out_dir, "--test_dir", test_dir, "--ckpt", ckpt])
        rows = check_eval_outputs("dcunet cli.eval", out_dir, test_dir, failures)
        print(f"dcunet: cli.eval of one file from its checkpoint in {time.time() - t0:.1f} s: "
              f"{rows}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    del model

    # (b) NCSN++ with score_sde's DDPM++ settings
    def ddpmpp(device):
        cfg = ScoreModelConfig(backbone="ncsnpp", sde="bbed", model_type="bbed")
        return ScoreModel(cfg, backbone_kwargs=DDPMPP, sde_kwargs=sde_kwargs, device=device,
                          generator=torch.Generator().manual_seed(0))

    model = ddpmpp(dev)
    redraw_weights(torch, model.backbone, seed=58)
    n_params = sum(p.numel() for p in model.backbone.parameters())
    y = waves[0]
    ck.reset_launch_counts()
    convs, norms = _kernel_calls(torch, model, lambda: _graphed_vs_eager(
        torch, dev, f"ddpm++ ({n_params} params) bbed_pc N=30", model, [y], 70, failures, card))
    programs = [p for _, p in model._graphs.values()]
    per_forward = {k: v // 60 for k, v in programs[0].launch_counts.items()}
    print(f"ddpm++: launches per forward in the captured program {per_forward} "
          f"(expected {DDPMPP_EVAL_LAUNCHES})")
    if per_forward != DDPMPP_EVAL_LAUNCHES:
        failures.append(f"ddpm++: launches per forward {per_forward}")
    paths["ddpm++ bbed_pc (graphed and eager)"] = card_runs(dict(ck.launch_counts), programs)
    model.drop_programs()
    shape = (1, 2, 256, 64)
    x = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    x = torch.from_numpy(x.astype(np.complex64))
    cpu = ddpmpp("cpu")
    cpu.backbone.load_state_dict({k: v.cpu() for k, v in model.backbone.state_dict().items()})
    with torch.no_grad():
        out = model.backbone(x.to(dev), torch.tensor([0.5], device=dev)).cpu()
        ref = cpu.backbone(x, torch.tensor([0.5]))
    err = (out - ref).abs().max().item() / ref.abs().max().item()
    print(f"ddpm++ forward (F=256 T=64): kernel path (card) vs plain path (CPU) "
          f"max|diff|/max|ref| {err:.3e} (tol {FORWARD_TOL})")
    if not err <= FORWARD_TOL:
        failures.append(f"ddpm++ forward card vs CPU {err:.3e}")
    del cpu
    trained = []
    train_convs, train_norms = _kernel_calls(torch, model, lambda: trained.append(_train_backbone(
        torch, ck, dev, "ddpm++ (dropout 0.1)", model, BACKBONE_TRAIN_STEPS, failures, card,
        expected=DDPMPP_TRAIN_LAUNCHES)))
    paths["ddpm++ train (dropout)"] = card_runs(trained[0], [])
    del model
    failures += check_backbone_kernel_calls(torch, ck, dev, convs | train_convs,
                                            norms | train_norms)
    for label, path in paths.items():
        print(f"{label}: kernel runs on the card {path['runs']}, recorded at capture "
              f"{path['recorded']}")
    if not paths["ddpm++ bbed_pc (graphed and eager)"]["runs"]["gn_silu_conv3x3"]:
        failures.append("ddpm++: gn_silu_conv3x3 never ran")
    if failures:
        raise AssertionError("; ".join(failures))
    return paths


# ---------------------------------------------------------------- parallel
# phase 15 ("parallel"): the paper's 65.6M model (weights redrawn from
# TRAIN_WEIGHT_SEED, float32 pinned) on the CLI's 4 x 256 frames; the
# one-process step is the reference of every multi-rank step
PARALLEL_SEED = 19            # the loss's generator
PARALLEL_RANKS = 2            # on the one card, gloo (NCCL refuses two ranks on one device)
PARALLEL_LOSS_RTOL = 1e-5
PARALLEL_GRAD_TOL = 1e-4      # of each gradient's largest magnitude, as phase 9
# Adam's first step moves each weight by lr * g / (|g| + eps), ~lr * sign(g):
# a weight whose reference gradient is within PARALLEL_GRAD_TOL of zero may
# take the other sign through another summation order, so it is held to
# 2 lr (+ PARALLEL_PARAM_ATOL for the rounding of p +- lr); every other
# weight to PARALLEL_PARAM_ATOL
PARALLEL_PARAM_ATOL = 2e-6
PARALLEL_STEPS = 2            # a rank's checked step, then a timed one
PARALLEL_TIMED = 2            # world size 1: timed steps of each, in turns
PARALLEL_LAUNCHES = {"gn_silu_conv3x3": 2 * 81, "groupnorm_silu": 2 * 28,
                     "fused_bias_leaky_relu": 0}


@contextlib.contextmanager
def deterministic_cudnn(torch):
    """cuDNN's deterministic algorithms inside the block (its default
    backward algorithms sum by atomics): what bitwise checks run under."""
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = before


def _sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _peak(torch, dev):
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def parallel_model(torch, dev, backbone_kwargs, weights):
    """The paper's model on ``dev`` with the given weights (a state_dict)."""
    from diffse_tpu_torch.models.score_model import ScoreModel, ScoreModelConfig

    model = ScoreModel(ScoreModelConfig(**PAPER_CONFIG), backbone_kwargs=backbone_kwargs,
                       sde_kwargs=PAPER_SDE_KWARGS, device=dev,
                       generator=torch.Generator().manual_seed(0))
    model.backbone.load_state_dict(weights)
    return model


def compare_step(state, ref, local=None):
    """A step's reduced gradients and updated weights against the
    one-process step's (``ref``: "grads", "params" by name, whole, on the
    CPU): the worst gradient gap of its largest magnitude, the worst weight
    gap where the reference gradient is clear of zero and where it is not,
    and how many weights moved by more than ``PARALLEL_PARAM_ATOL``.
    ``local(i, t)`` maps a whole tensor to this rank's part."""
    local = local or (lambda i, t: t)
    grad_gap, clear_gap, band_gap, moved = 0.0, 0.0, 0.0, 0
    worst = ""
    for i, (name, g) in enumerate(zip(state.names, state.last_grads)):
        ref_g = local(i, ref["grads"][name]).to(g.device)
        scale = gradient_scale(ref["grads"], name)
        gap = ((g - ref_g).abs().max().item() / scale) if scale > 0 else 0.0
        if gap > grad_gap:
            grad_gap, worst = gap, name
        diff = (state.params[i].detach() - ref["params"][name].to(g.device)).abs()
        band = ref["grads"][name].abs().to(g.device) <= PARALLEL_GRAD_TOL * scale
        clear_gap = max(clear_gap, diff[~band].max().item() if (~band).any() else 0.0)
        band_gap = max(band_gap, diff[band].max().item() if band.any() else 0.0)
        moved += int((diff > PARALLEL_PARAM_ATOL).sum())
    return {"grad_gap": grad_gap, "worst_grad": worst, "param_gap": clear_gap,
            "band_param_gap": band_gap, "params_over_atol": moved}


def state_bytes(state):
    """Bytes this rank keeps of the trained parameters (whole, the compute's)
    and of their training state: its part of the weights (what Adam
    updates), the EMA and Adam's two moments."""
    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t in ts)

    moments = [v for st in state.optimizer.state.values() for k, v in st.items()
               if k in ("exp_avg", "exp_avg_sq")]
    return {"params_whole": nbytes(state.params), "params_local": nbytes(state.local),
            "ema": nbytes(state.ema), "moments": nbytes(moments)}


def _parallel_rank(rank, workdir, backbone_kwargs, device):
    """One rank of phase 15's two: a data-parallel step on a 1-D mesh, then a
    (1, 2) tensor-parallel step, each from the reference's weights on its
    rows of the reference's batch, with the reference's draws; returns the
    checks, walls, peak memory, launches and state bytes."""
    import os

    import torch

    from diffse_tpu_torch.ops import cuda_kernels as ck
    from diffse_tpu_torch.parallel import make_2d_mesh, make_mesh, shard_batch
    from diffse_tpu_torch.train import TrainState, make_train_step

    dev = torch.device(device)
    ref = torch.load(os.path.join(workdir, "reference.pt"), weights_only=False)
    wavs = ref["wavs"]
    out = {}
    for label, make in (("dp", lambda: make_mesh(dev.type)),
                        ("tp", lambda: make_2d_mesh(1, PARALLEL_RANKS, dev.type))):
        model = parallel_model(torch, dev, backbone_kwargs, ref["weights"])
        mesh = make()
        state = TrainState(model.backbone, lr=model.cfg.lr, ema_decay=model.cfg.ema_decay,
                           mesh=mesh)
        state.keep_gradients = True
        step = make_train_step(model, preprocess=model.prepare_batch, mesh=mesh)
        rows = shard_batch(mesh, wavs)
        walls, losses, counts = [], [], None
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        for i in range(PARALLEL_STEPS):
            gen = torch.Generator(dev).manual_seed(PARALLEL_SEED)
            ck.reset_launch_counts()
            _sync(torch, dev)
            t0 = time.perf_counter()
            state, metrics = step(state, rows, gen)
            _sync(torch, dev)
            walls.append(time.perf_counter() - t0)
            losses.append(metrics["train_loss"].item())
            if i == 0:
                counts = dict(ck.launch_counts)
                checks = compare_step(state, ref, state.layout.local if state.layout else None)
                state.keep_gradients, state.last_grads = False, None
        out[label] = {"loss": losses[0], "losses": losses, "walls": walls,
                      "peak": _peak(torch, dev), "launches": counts,
                      "bytes": state_bytes(state), **checks,
                      "sharded": sum(state.layout.sharded) if state.layout else 0,
                      "rows": int(rows[0].shape[0]), "lr": model.cfg.lr}
        del model, state, step
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def run_parallel(torch, ck, dev, card, backbone_kwargs=None, backend="gloo"):
    """Phase 15 ("parallel"). Returns the launch counts by path."""
    import os
    import shutil
    import tempfile

    import torch.distributed as dist

    from diffse_tpu_torch.parallel import dryrun, make_mesh
    from diffse_tpu_torch.parallel.mesh import init_single_process
    from diffse_tpu_torch.train import TrainState, make_train_step

    backbone_kwargs = dict(backbone_kwargs or {})
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_phase = time.time()
    failures, paths = [], {}
    wavs = train_wavs(18)
    # the weights every run starts from: the paper model's, redrawn
    from diffse_tpu_torch.models.score_model import ScoreModel, ScoreModelConfig

    model = ScoreModel(ScoreModelConfig(**PAPER_CONFIG), backbone_kwargs=backbone_kwargs,
                       sde_kwargs=PAPER_SDE_KWARGS, device=dev,
                       generator=torch.Generator().manual_seed(0))
    redraw_weights(torch, model.backbone, seed=TRAIN_WEIGHT_SEED)
    weights = {k: v.detach().cpu().clone() for k, v in model.backbone.state_dict().items()}
    n_params = sum(p.numel() for p in model.backbone.parameters())
    del model

    def run(mesh, chain=1):
        m = parallel_model(torch, dev, backbone_kwargs, weights)
        state = TrainState(m.backbone, lr=m.cfg.lr, ema_decay=m.cfg.ema_decay, mesh=mesh)
        return m, state, make_train_step(m, preprocess=m.prepare_batch, mesh=mesh,
                                         chain_steps=chain)

    def timed(state, step, batch):
        gen = torch.Generator(dev).manual_seed(PARALLEL_SEED)
        ck.reset_launch_counts()
        _sync(torch, dev)
        t0 = time.perf_counter()
        state, metrics = step(state, batch, gen)
        _sync(torch, dev)
        return metrics, time.perf_counter() - t0, dict(ck.launch_counts)

    def checked(state, step, label):
        """One step from ``weights`` with cuDNN's deterministic algorithms:
        its loss, reduced gradients, weights after and launches."""
        state.keep_gradients = True
        with deterministic_cudnn(torch):
            metrics, wall, counts = timed(state, step, wavs)
        first = {"loss": metrics["train_loss"].detach().cpu(),
                 "grads": {n: g.detach().cpu().clone()
                           for n, g in zip(state.names, state.last_grads)},
                 "params": {n: p.detach().cpu().clone()
                            for n, p in zip(state.names, state.params)},
                 "launches": counts, "wall": wall}
        state.keep_gradients, state.last_grads = False, None
        if counts != PARALLEL_LAUNCHES:
            failures.append(f"{label}: launches {counts}, expected {PARALLEL_LAUNCHES}")
        return first

    def same(a, b):
        return (torch.equal(a["loss"], b["loss"])
                and all(torch.equal(a["grads"][n], b["grads"][n]) for n in a["grads"])
                and all(torch.equal(a["params"][n], b["params"][n]) for n in a["params"]))

    def gap(a, b):
        return max((a["params"][n] - b["params"][n]).abs().max().item() for n in a["params"])

    def free():
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    # 1. world size 1, in this process, NCCL on the card: bitwise the plain
    # step (both with cuDNN's deterministic algorithms: its default backward
    # algorithms sum by atomics, so two plain steps differ), then the two
    # timed in turns with torch's defaults
    t0 = time.time()
    init_single_process(dev.type)
    try:
        m, state, step = run(None)
        plain_again = checked(state, step, "one process, no mesh")
        del m, state, step
        free()
        m, state, step = run(None)
        plain = checked(state, step, "one process, no mesh")
        mesh = make_mesh(dev.type)
        m1, state1, step1 = run(mesh)
        meshed = checked(state1, step1, "world size 1 mesh")
        backend1 = dist.get_backend()
        plain_walls, mesh_walls = [], []
        for _ in range(PARALLEL_TIMED):
            plain_walls.append(timed(state, step, wavs)[1])
            mesh_walls.append(timed(state1, step1, wavs)[1])
        del m, state, step, m1, state1, step1
        free()
    finally:
        dist.destroy_process_group()
    floor_equal, equal = same(plain, plain_again), same(plain, meshed)
    plain_wall, mesh_wall = float(np.median(plain_walls)), float(np.median(mesh_walls))
    print(f"parallel 1 ({card}): the paper model ({n_params} params, sebridge_v3, "
          f"{TRAIN_BATCH} x {TRAIN_FRAMES} frames, weights redrawn from seed "
          f"{TRAIN_WEIGHT_SEED}), one train step without a mesh and on a world-size-1 "
          f"{backend1} mesh, in this process, cuDNN deterministic: loss "
          f"{float(plain['loss']):.9g} / {float(meshed['loss']):.9g}; two plain steps bitwise "
          f"equal: {floor_equal} (weights {gap(plain, plain_again):.3e} apart); the mesh step "
          f"and the plain one bitwise equal (loss, gradients, weights): {equal} (weights "
          f"{gap(plain, meshed):.3e} apart); launches {plain['launches']} / "
          f"{meshed['launches']}; checked step walls {plain['wall']:.4f} / "
          f"{meshed['wall']:.4f} s; then {PARALLEL_TIMED} steps of each in turns (torch's "
          f"defaults): without a mesh {[f'{w:.4f}' for w in plain_walls]} s, on the mesh "
          f"{[f'{w:.4f}' for w in mesh_walls]} s, medians {plain_wall:.4f} / {mesh_wall:.4f} "
          f"s, the mesh's cost {100 * (mesh_wall / plain_wall - 1):+.2f}%; "
          f"{time.time() - t0:.1f} s")
    if not floor_equal:
        failures.append("two plain steps with deterministic cuDNN differ")
    if not equal:
        failures.append("the world-size-1 mesh step is not bitwise the plain step")
    paths["parallel: world size 1 mesh step (eager)"] = card_runs(meshed["launches"], [])

    # 3. chain_steps 2 against two single steps, in this process
    t0 = time.time()
    second = train_wavs(21)
    runs = {}
    for label, chain in (("two steps", 1), ("chain_steps 2", 2)):
        m, state, step = run(None, chain)
        gen = torch.Generator(dev).manual_seed(PARALLEL_SEED)
        ck.reset_launch_counts()
        _sync(torch, dev)
        start = time.perf_counter()
        with deterministic_cudnn(torch):
            if chain == 1:
                losses = [step(state, b, gen)[1]["train_loss"].item() for b in (wavs, second)]
            else:
                stacked = tuple(np.stack([a, b]) for a, b in zip(wavs, second))
                metrics = step(state, stacked, gen)[1]
                losses = [metrics["train_loss"].item(), metrics["train_loss_mean"].item()]
        _sync(torch, dev)
        runs[label] = {"losses": losses, "wall": time.perf_counter() - start,
                       "launches": dict(ck.launch_counts), "step": state.step,
                       "params": [p.detach().cpu().clone() for p in state.params],
                       "ema": [e.cpu().clone() for e in state.ema]}
        del m, state, step
        free()
    a, b = runs["two steps"], runs["chain_steps 2"]
    chain_equal = (all(torch.equal(x, y) for x, y in zip(a["params"], b["params"]))
                   and all(torch.equal(x, y) for x, y in zip(a["ema"], b["ema"])))
    print(f"parallel 3 ({card}): chain_steps 2 against two single steps on two batches, the "
          f"same generator, cuDNN deterministic: losses {a['losses']} / last "
          f"{b['losses'][0]!r}, mean {b['losses'][1]!r}; weights and EMA bitwise equal: "
          f"{chain_equal}; steps {a['step']} / {b['step']}; walls {a['wall']:.3f} / "
          f"{b['wall']:.3f} s; launches {a['launches']} / {b['launches']}; "
          f"{time.time() - t0:.1f} s")
    expected2 = {k: 2 * v for k, v in PARALLEL_LAUNCHES.items()}
    if not chain_equal or b["step"] != 2 or b["losses"][0] != a["losses"][1]:
        failures.append("chain_steps 2 is not two single steps")
    if b["launches"] != expected2:
        failures.append(f"chain_steps 2: launches {b['launches']}, expected {expected2}")
    paths["parallel: chain_steps 2 (eager)"] = card_runs(b["launches"], [])

    # 2. two ranks on the one card, gloo, against the one-process step
    t0 = time.time()
    workdir = tempfile.mkdtemp(prefix="diffse_parallel_")
    try:
        torch.save({"weights": weights, "wavs": wavs, "grads": plain["grads"],
                    "params": plain["params"], "loss": plain["loss"]},
                   os.path.join(workdir, "reference.pt"))
        ref_grads = plain["grads"]
        one_device = 4 * sum(g.numel() * 4 for g in ref_grads.values())
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        ranks = dryrun.launch(_parallel_rank, PARALLEL_RANKS,
                              (workdir, backbone_kwargs, str(dev)), device=str(dev),
                              backend=backend, timeout=600)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    ref_loss = float(plain["loss"])
    for label, what in (("dp", f"data-parallel, a 1-D mesh of {PARALLEL_RANKS}"),
                        ("tp", f"tensor-parallel, a (1, {PARALLEL_RANKS}) mesh")):
        for r, res in enumerate(ranks):
            x = res[label]
            rel = abs(x["loss"] - ref_loss) / abs(ref_loss)
            by = x["bytes"]
            print(f"parallel 2 ({card}): {what}, {backend} rank {r} ({x['rows']} rows of "
                  f"{TRAIN_BATCH}): loss {x['loss']:.9g} vs one process {ref_loss:.9g} "
                  f"({rel:.3e} relative, tol {PARALLEL_LOSS_RTOL}); gradients worst "
                  f"{x['worst_grad']} {x['grad_gap']:.3e} of its largest magnitude (tol "
                  f"{PARALLEL_GRAD_TOL}); weights after the update: worst "
                  f"{x['param_gap']:.3e} where the reference gradient is clear of zero (tol "
                  f"{PARALLEL_PARAM_ATOL}), {x['band_param_gap']:.3e} within its band (tol "
                  f"2 lr), {x['params_over_atol']} weights over {PARALLEL_PARAM_ATOL}; step "
                  f"walls {[f'{w:.4f}' for w in x['walls']]} s (the first checked); peak "
                  f"memory {x['peak'] / 2**30:.2f} GiB; launches {x['launches']}; sharded "
                  f"parameters {x['sharded']}; bytes kept: weights whole "
                  f"{by['params_whole'] / 1e6:.1f} MB, its part {by['params_local'] / 1e6:.1f} "
                  f"MB, EMA {by['ema'] / 1e6:.1f} MB, moments {by['moments'] / 1e6:.1f} MB "
                  f"(one device: weights, EMA and moments {one_device / 1e6:.1f} MB)")
            if rel > PARALLEL_LOSS_RTOL or not np.isfinite(x["loss"]):
                failures.append(f"{label} rank {r}: loss {x['loss']} vs {ref_loss}")
            if x["grad_gap"] > PARALLEL_GRAD_TOL:
                failures.append(f"{label} rank {r}: gradient of {x['worst_grad']} "
                                f"{x['grad_gap']:.3e}")
            if (x["param_gap"] > PARALLEL_PARAM_ATOL
                    or x["band_param_gap"] > 2 * x["lr"] + PARALLEL_PARAM_ATOL):
                failures.append(f"{label} rank {r}: weights {x['param_gap']:.3e} / "
                                f"{x['band_param_gap']:.3e}")
            if x["launches"] != PARALLEL_LAUNCHES:
                failures.append(f"{label} rank {r}: launches {x['launches']}")
        if label == "tp" and not all(res["tp"]["sharded"] for res in ranks):
            failures.append("tp: no parameter sharded")
        total = {k: sum(res[label]["launches"][k] for res in ranks) for k in PARALLEL_LAUNCHES}
        paths[f"parallel: {label} step, {PARALLEL_RANKS} {backend} ranks (eager)"] = \
            card_runs(total, [])
    print(f"parallel 2: {PARALLEL_RANKS} ranks spawned and done in {time.time() - t0:.1f} s")
    print(f"phase parallel: {time.time() - t_phase:.1f} s")
    if failures:
        raise AssertionError("; ".join(failures))
    return paths


# phase 16 ("sequence"): frames-parallel enhancement (parallel/sequence.py) of
# one 4.0 s utterance (512 frames, 256 a rank at the top level) by the
# paper's 65.6M NCSN++ (weights redrawn from SEQUENCE_WEIGHT_SEED) over
# SEQUENCE_RANKS gloo ranks on the one card (NCCL refuses two ranks on one
# device), against the one-device enhance on the card on the same draws.
SEQUENCE_RANKS = 2
SEQUENCE_BACKBONE = {}        # the paper's NCSN++: its defaults
SEQUENCE_SECONDS = 4.0
SEQUENCE_WEIGHT_SEED = 31
SEQUENCE_PC_N = 3
SEQUENCE_ONE_NFE_TOL = 1e-4   # of max|ref|: float32 sums in other orders
SEQUENCE_PC_TOL = 5e-3        # of max|ref|: as tests/test_sequence_parallel.py's PC bound
# (label, model_type, sigma_max, backbone keywords, generator seed, enhance keywords)
SEQUENCE_CASES = [("sebridge_v2", "sebridge_v2", 1.0, {}, 61, {}),
                  ("sebridge_v2 bf16", "sebridge_v2", 1.0, {"dtype": "bf16"}, 61, {}),
                  ("bbed_pc", "bbed", 0.5, {}, 62, {"N": SEQUENCE_PC_N})]
# a rank's launches per forward: every K1/K2 and K3 call (81 / 28) with the
# shards' statistics, each from one group-sums pass and one fold
SEQUENCE_LAUNCHES = {"gn_silu_conv3x3": 81, "groupnorm_silu": 28, "fused_bias_leaky_relu": 0,
                     "gn_group_sums": 109, "gn_fold_ab": 109}
# the sharded path's kernel shapes on a rank at 512 frames over 2 ranks: the
# statistics of its own columns; K1/K2 on its columns and one of its
# neighbour's ([.., 257, ..]; 258 for a rank between two others); K3 with
# the shards' affine
SEQUENCE_STATS_SHAPES = [(1, 256, 256, 128), (1, 256, 256, 256), (1, 64, 64, 256),
                         (1, 4, 4, 256)]
SEQUENCE_K1_SHAPES = [(1, 256, 257, 128, 128, True), (1, 256, 257, 256, 128, True),
                      (1, 256, 258, 128, 128, True), (1, 256, 257, 128, 4, False),
                      (1, 16, 17, 256, 256, True), (1, 4, 5, 512, 256, True)]
SEQUENCE_K3_SHAPES = [(1, 256, 256, 128, True), (1, 16, 16, 256, False)]


def check_sequence_kernels(torch, ck, dev):
    """Phase 16's kernels: ``gn_fold_ab(gn_group_sums(x))`` bitwise against
    the one-pass ``gn_stats_ab`` and each against its plain version; K1/K2
    and K3 with a given affine (``ab=``) against their plain versions
    (``KERNEL_TOL`` in float32, ``bf16_agreement`` in bf16), at the sharded
    path's shapes. Returns the JSON record's rows of the two new kernels."""
    rng = np.random.default_rng(16)

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev, dtype)

    failures = []
    rows = {"gn_group_sums": {"max_abs_err": 0.0}, "gn_fold_ab": {"max_abs_err": 0.0}}
    for dtype in (torch.float32, torch.bfloat16):
        for shape in SEQUENCE_STATS_SHAPES:
            b, h, w, c = shape
            x = t(2 * rng.standard_normal(shape) + 1, dtype)
            sc, bi = t(1 + 0.1 * rng.standard_normal(c)), t(0.1 * rng.standard_normal(c))
            groups = min(c // 4, 32)
            one_pass = ck.gn_stats_ab(x, sc, bi, groups)
            sums = ck.gn_group_sums(x, groups)
            folded = ck.gn_fold_ab(sums, h * w, sc, bi, 1e-6, dtype)
            plain_sums = ck.gn_group_sums_reference(x, groups)
            plain_fold = ck.gn_fold_ab_reference(plain_sums, h * w, sc, bi, 1e-6)
            torch.cuda.synchronize()
            bitwise = all(torch.equal(p, q) for p, q in zip(one_pass, folded))
            # the sums against float64 on the host, relative to each sum's scale
            sums_err = ((sums - plain_sums).abs() / plain_sums.abs().clamp_min(1.0)).max().item()
            fold_err = max((p - q).abs().max().item() for p, q in zip(folded, plain_fold))
            name = f"gn_group_sums + gn_fold_ab {list(shape)} {str(dtype)[6:]}"
            print(f"{name}: bitwise equal to gn_stats_ab {bitwise}; sums vs plain "
                  f"{sums_err:.3e} relative; fold vs plain (the plain version's sums) "
                  f"{fold_err:.3e}")
            rows["gn_group_sums"]["max_abs_err"] = max(rows["gn_group_sums"]["max_abs_err"],
                                                       sums_err)
            rows["gn_fold_ab"]["max_abs_err"] = max(rows["gn_fold_ab"]["max_abs_err"], fold_err)
            if not bitwise or sums_err > 1e-12 or fold_err > KERNEL_TOL["atol"]:
                failures.append(name)
            if shape == SEQUENCE_STATS_SHAPES[0] and dtype == torch.float32:
                xg = x.view(b, h * w, groups, c // groups)
                times = timing(torch, lambda: ck.gn_group_sums(x, groups),
                               lambda: ck.gn_group_sums_reference(x, groups),
                               lambda: torch.var_mean(xg, dim=(1, 3)))
                # x in, the sums out; a square and two sums per element
                bound_ms, bound_by = bound(3 * x.numel(), 4 * x.numel() + 16 * b * groups)
                print(f"gn_group_sums {list(shape)}: {describe(times, bound_ms, bound_by)}")
                rows["gn_group_sums"].update(times, bound_ms=bound_ms, bound_by=bound_by)
                times = timing(torch, lambda: ck.gn_fold_ab(sums, h * w, sc, bi),
                               lambda: ck.gn_fold_ab_reference(sums, h * w, sc, bi, 1e-6))
                # the sums, scale and bias in, a and b out; ~10 operations a
                # group and 3 a channel
                bound_ms, bound_by = bound(10 * b * groups + 3 * b * c,
                                           16 * b * groups + 8 * c + 8 * b * c)
                print(f"gn_fold_ab [{b}, {groups}, 2] -> [{b}, {c}]: "
                      f"{describe(times, bound_ms, bound_by)}")
                rows["gn_fold_ab"].update(times, bound_ms=bound_ms, bound_by=bound_by)
    for dtype in (torch.float32, torch.bfloat16):
        for b, h, w, cin, cout, with_skip in SEQUENCE_K1_SHAPES:
            x = t(rng.standard_normal((b, h, w, cin)), dtype)
            gs, gb = t(1 + 0.1 * rng.standard_normal(cin)), t(0.1 * rng.standard_normal(cin))
            wk = t(rng.standard_normal((3, 3, cin, cout)) / np.sqrt(9 * cin))
            bt = t(0.1 * rng.standard_normal((b, cout)))
            skip = t(rng.standard_normal((b, h, w, cout)), dtype) if with_skip else None
            groups = min(cin // 4, 32)
            # the affine of the columns but the first: a shard's, not x's own
            ab = ck.gn_stats_ab(x[:, :, 1:].contiguous(), gs, gb, groups)
            packed = ck.pack_conv_weight_bf16(wk) if dtype == torch.bfloat16 else None
            args = (x, gs, gb, wk, bt, groups)
            kw = dict(skip=skip, skip_coef=1 / np.sqrt(2.0), ab=ab)
            out = ck.groupnorm_silu_conv3x3(*args, w_packed=packed, **kw)
            ref = ck.groupnorm_silu_conv3x3_reference(*args, **kw)
            torch.cuda.synchronize()
            if dtype == torch.float32:
                ok = torch.allclose(out, ref, **KERNEL_TOL)
                err = (out - ref).abs().max().item()
                how = f"max_abs_err {err:.3e}"
            else:
                ok, share, err = bf16_agreement(torch, out, ref)
                how = f"max_abs_err {err:.3e}, share over one ulp {share:.2e}"
            plan = ck.conv_plan(b, h, w, cin, cout, dtype)
            name = (f"gn_silu_conv3x3 ab= {[b, h, w, cin]}->{cout}{' +skip' if with_skip else ''}"
                    f" {str(dtype)[6:]}")
            line = f"{name}: {how} ok {ok} | plan {ck.CONV_CONFIGS[plan.config][3]}"
            if (b, h, w) == (1, 256, 257) and cin == cout == 128:
                times = timing(torch, lambda: ck.groupnorm_silu_conv3x3(*args, w_packed=packed,
                                                                       **kw),
                               lambda: ck.groupnorm_silu_conv3x3_reference(*args, **kw))
                bounds = conv_bounds(b, h, w, cin, cout, with_skip,
                                     2 if dtype == torch.bfloat16 else 4)
                line += " | " + describe(times, *bounds["bf16" if dtype == torch.bfloat16
                                                         else "tf32x3"])
            print(line)
            if not ok:
                failures.append(name)
        for b, h, w, c, silu in SEQUENCE_K3_SHAPES:
            x = t(2 * rng.standard_normal((b, h, w, c)) + 1, dtype)
            sc, bi = t(1 + 0.1 * rng.standard_normal(c)), t(0.1 * rng.standard_normal(c))
            groups = min(c // 4, 32)
            ab = ck.gn_stats_ab(x[:, :, 1:].contiguous(), sc, bi, groups)
            out_dtype = None if silu else torch.float32  # the attention's norm: float32 out
            out = ck.groupnorm_silu(x, sc, bi, groups, apply_silu=silu, out_dtype=out_dtype,
                                    ab=ab)
            ref = ck.groupnorm_silu_reference(x, sc, bi, groups, apply_silu=silu,
                                              out_dtype=out_dtype, ab=ab)
            torch.cuda.synchronize()
            if out.dtype == torch.float32:
                ok, err = torch.allclose(out, ref, **KERNEL_TOL), (out - ref).abs().max().item()
            else:
                ok, _, err = bf16_agreement(torch, out, ref)
            name = f"groupnorm_silu ab= {[b, h, w, c]} silu={silu} {str(dtype)[6:]}"
            print(f"{name}: max_abs_err {err:.3e} ok {ok}")
            if not ok:
                failures.append(name)
    if failures:
        raise AssertionError(f"phase 16's kernels disagree: {failures}")
    return rows


def sequence_model(torch, dev, model_type, sigma_max, backbone, weights):
    """The NCSN++ of ``backbone`` keywords in a ScoreModel of ``model_type``
    under BBED, with ``weights``."""
    from diffse_tpu_torch.models.score_model import ScoreModel, ScoreModelConfig

    cfg = ScoreModelConfig(backbone="ncsnpp", sde="bbed", model_type=model_type,
                           snr_conditioned="false", sigma_max=sigma_max)
    model = ScoreModel(cfg, backbone_kwargs=backbone, sde_kwargs=dict(
        T_sampling=0.999, k=2.6, theta=0.52, N=30), device=dev,
        generator=torch.Generator().manual_seed(0))
    model.backbone.load_state_dict(weights)
    return model


def _sequence_rank(rank, workdir, device):
    """One rank of phase 16: each case's enhance over the frames mesh of
    every rank, each 1-NFE case twice (the second timed warm), with its
    waveform, walls, launches and the programs it kept."""
    import os

    import torch

    from diffse_tpu_torch.ops import cuda_kernels as ck
    from diffse_tpu_torch.parallel import make_seq_mesh

    dev = torch.device(device)
    ref = torch.load(os.path.join(workdir, "reference.pt"), weights_only=False)
    y = ref["wave"][None]
    mesh = make_seq_mesh(device_type=dev.type)
    out = {}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    for label, model_type, sigma_max, backbone, seed, kw in SEQUENCE_CASES:
        model = sequence_model(torch, dev, model_type, sigma_max,
                               {**ref["backbone"], **backbone}, ref["weights"])
        walls = []
        for _ in range(1 if kw else 2):
            ck.reset_launch_counts()
            _sync(torch, dev)
            t0 = time.perf_counter()
            wave = model.enhance(y, y, generator=torch.Generator(dev).manual_seed(seed),
                                 seq_mesh=mesh, **kw)
            _sync(torch, dev)
            walls.append(time.perf_counter() - t0)
        out[label] = {"wave": wave, "walls": walls, "graphs": len(model._graphs),
                      "launches": {**ck.launch_counts, **ck.stats_launch_counts},
                      "by_config": list(ck.conv_config_launches)}
        del model
    out["peak"] = _peak(torch, dev)
    return out


def run_sequence(torch, ck, dev, card):
    """Phase 16 ("sequence"). Returns the float32 and the bf16 paths' kernel
    runs and the two new kernels' records."""
    import os
    import shutil
    import tempfile

    from diffse_tpu_torch.parallel import dryrun
    from diffse_tpu_torch.utils import generator_noise

    t_phase = time.time()
    rows = check_sequence_kernels(torch, ck, dev)
    print(f"sequence kernels: {time.time() - t_phase:.1f} s")
    failures, paths, bf16_paths = [], {}, {}
    _, wave = synthetic_pair(np.random.default_rng(16), int(SEQUENCE_SECONDS * SR))
    from diffse_tpu_torch.models.ncsnpp import NCSNpp

    backbone = NCSNpp(**SEQUENCE_BACKBONE, generator=torch.Generator().manual_seed(0))
    redraw_weights(torch, backbone, seed=SEQUENCE_WEIGHT_SEED)
    weights = {k: v.detach().clone() for k, v in backbone.state_dict().items()}
    n_params = sum(p.numel() for p in backbone.parameters())
    del backbone

    # one device: each case graphed (its capture, then a timed replay) and,
    # for the 1-NFE cases, eagerly (timed warm)
    t0 = time.time()
    one = {}
    for label, model_type, sigma_max, backbone_kw, seed, kw in SEQUENCE_CASES:
        model = sequence_model(torch, dev, model_type, sigma_max,
                               {**SEQUENCE_BACKBONE, **backbone_kw}, weights)
        walls = {}
        for how in ("graphed", "replay") + (() if kw else ("eager",)):
            gen = torch.Generator(dev).manual_seed(seed)
            source = {"noise": generator_noise(gen)} if how == "eager" else {"generator": gen}
            _sync(torch, dev)
            start = time.perf_counter()
            outs = model.enhance(wave[None], wave[None], **source, **kw)
            _sync(torch, dev)
            walls[how] = time.perf_counter() - start
            one.setdefault(label, outs)
        one[label + " walls"] = walls
        del model
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    print(f"sequence one device: {time.time() - t0:.1f} s")

    t0 = time.time()
    workdir = tempfile.mkdtemp(prefix="diffse_sequence_")
    try:
        torch.save({"weights": weights, "wave": wave, "backbone": SEQUENCE_BACKBONE},
                   os.path.join(workdir, "reference.pt"))
        ranks = dryrun.launch(_sequence_rank, SEQUENCE_RANKS, (workdir, str(dev)),
                              device=str(dev), backend="gloo", timeout=300)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    spawn = time.time() - t0

    def wave_gap(out, ref):
        return float(np.max(np.abs(out - ref)) / np.max(np.abs(ref)))

    f32_gap = wave_gap(one["sebridge_v2 bf16"], one["sebridge_v2"])
    for label, model_type, sigma_max, backbone_kw, seed, kw in SEQUENCE_CASES:
        ref = one[label]
        forwards = 2 * SEQUENCE_PC_N if kw else 1
        expected = {k: v * forwards for k, v in SEQUENCE_LAUNCHES.items()}
        for r, res in enumerate(ranks):
            x = res[label]
            gap = wave_gap(x["wave"], ref)
            if label == "bbed_pc":
                tol, what = SEQUENCE_PC_TOL, f"tol {SEQUENCE_PC_TOL}"
            elif "bf16" in label:
                tol = BF16_GAP_RATIO * f32_gap
                what = (f"tol {BF16_GAP_RATIO} x the one-device bf16-vs-float32 gap "
                        f"{f32_gap:.3e}")
            else:
                tol, what = SEQUENCE_ONE_NFE_TOL, f"tol {SEQUENCE_ONE_NFE_TOL}"
            launches = x["launches"]
            walls = one[label + " walls"]
            print(f"sequence ({card}): {label} on a {SEQUENCE_SECONDS} s utterance (512 frames, "
                  f"the {n_params}-parameter NCSN++, weights redrawn from seed "
                  f"{SEQUENCE_WEIGHT_SEED}), gloo rank {r} of {SEQUENCE_RANKS} against one "
                  f"device: max|diff|/max|ref| {gap:.3e} ({what}); launches on the rank "
                  f"{launches} over {forwards} forward(s), by conv instantiation "
                  f"{x['by_config']}; programs kept {x['graphs']}; walls sharded (eager) "
                  f"{[f'{w:.4f}' for w in x['walls']]} s, one device "
                  + ", ".join(f"{k} {v:.4f} s" for k, v in walls.items()))
            if not np.isfinite(x["wave"]).all() or x["wave"].shape != ref.shape or gap > tol:
                failures.append(f"{label} rank {r}: {gap:.3e}")
            if launches != expected:
                failures.append(f"{label} rank {r}: launches {launches}, expected {expected}")
            if x["graphs"]:
                failures.append(f"{label} rank {r}: a sharded call kept a program")
        total = {k: sum(res[label]["launches"][k] for res in ranks) for k in SEQUENCE_LAUNCHES}
        name = f"sequence: {label}, {SEQUENCE_RANKS} gloo ranks (eager)"
        if "bf16" in label:
            by_config = [sum(v) for v in zip(*(res[label]["by_config"] for res in ranks))]
            bf16_paths[name] = card_runs({**total, **conv_launches(ck, by_config)}, [])
        else:
            paths[name] = card_runs(total, [])
    peaks = [f"{res['peak'] / 2**30:.2f}" for res in ranks]
    print(f"sequence: {SEQUENCE_RANKS} ranks spawned and done in {spawn:.1f} s; peak memory a "
          f"rank {peaks} GiB")
    print(f"phase sequence: {time.time() - t_phase:.1f} s")
    if failures:
        raise AssertionError("; ".join(failures))
    return paths, bf16_paths, rows


# phase 17 ("import"): the paper-reproduction path. The paper's 65.6M model
# (M6: sebridge_v3, SNR-conditioned, fixed_snr 0.17783 for eta = 10) and an
# SNRNet, each written as a reference-layout Lightning .ckpt with weights and
# an EMA shadow redrawn from seeds; imported with cli.convert_torch_checkpoint
# --ema; sebridge_v3_snr on two utterances of the 192-frame bucket, imported
# against loaded directly from the same tensors; then cli.reproduce_tables on
# a synthetic stand-in (3 valid and 2 valid2 files of 1.2 s), which must fail
# parity on every run of redrawn weights with all of its 24 cells printed
IMPORT_HYPER = dict(sde="bbed", model_type="sebridge_v3", snr_conditioned="true",
                    fixed_snr=FIXED_SNR, sigma_max=1.0, k=2.6, theta=0.52, T_sampling=0.999)
IMPORT_SEEDS = {"score": 41, "score_ema": 42, "snr": 43, "snr_ema": 44}
IMPORT_SECONDS = (1.2, 1.5)
IMPORT_CELLS = ["mixture PESQ", "mixture ESTOI", "mixture SI-SDR", "M6 PESQ", "M6 ESTOI",
                "M6 SI-SDR"] + [f"{m} @ {s:+d} dB" for m in ("PESQ", "SI-SDR")
                                for s in (-5, 0, 5, 10, 15, 20, 25, 30, 35)]
IMPORT_FORWARD_LAUNCHES = {"gn_silu_conv3x3": 81, "groupnorm_silu": 28,
                           "fused_bias_leaky_relu": 0}


def reference_checkpoints(torch, root):
    """The phase's Lightning .ckpt files under ``root``: the 65.6M NCSN++
    (``dnn.``-prefixed state_dict, ``IMPORT_HYPER``, an EMA shadow redrawn
    from its own seed, without the frozen Fourier ``W``, as torch_ema keeps
    it) and an SNRNet (shadow over its whole state_dict; both LSTM biases
    drawn). Returns their paths and the tensors the EMA must restore to, by
    port name, the ``W`` live."""
    import os

    from diffse_tpu_torch.models.ncsnpp import NCSNpp

    net = NCSNpp(generator=torch.Generator().manual_seed(0))
    frozen = {name for name, p in net.named_parameters() if not p.requires_grad}

    def tensors(module):
        return {k: v.detach().contiguous().clone() for k, v in module.state_dict().items()}

    redraw_weights(torch, net, seed=IMPORT_SEEDS["score"])
    params = tensors(net)
    redraw_weights(torch, net, seed=IMPORT_SEEDS["score_ema"])
    ema = tensors(net)
    del net
    snr_params = tensors(redraw_snrnet(torch, seed=IMPORT_SEEDS["snr"]))
    snr_ema = tensors(redraw_snrnet(torch, seed=IMPORT_SEEDS["snr_ema"]))
    paths = {"score": os.path.join(root, "M6.ckpt"),
             "snr": os.path.join(root, "snr_estimator.ckpt")}
    torch.save({"state_dict": {"dnn." + k: v for k, v in params.items()},
                "hyper_parameters": IMPORT_HYPER,
                "ema": {"shadow_params": [v for k, v in ema.items() if k not in frozen]}},
               paths["score"])
    torch.save({"state_dict": {"dnn." + k: v for k, v in snr_params.items()},
                "hyper_parameters": {"transform_type": "none"},
                "ema": {"shadow_params": list(snr_ema.values())}}, paths["snr"])
    return paths, {"score": params, "score_ema": ema, "snr": snr_params, "snr_ema": snr_ema}


def check_imported(torch, label, state, params, ema, failures):
    """The restored state on the card against the checkpoint's tensors:
    parameters and EMA bit for bit (a parameter outside the EMA evaluates
    with its live value)."""
    from diffse_tpu_torch.train.state import eval_variables

    restored = state.module.state_dict()
    params_equal = sorted(restored) == sorted(params) and all(
        torch.equal(restored[k].cpu(), v) for k, v in params.items())
    variables = eval_variables(state)
    ema_equal = all(torch.equal(variables[k].cpu(), ema[k] if k in state.names else params[k])
                    for k in params)
    devices = {str(t.device) for t in state.ema}
    print(f"import: {label}: {len(state.names)} EMA tensors on {devices}, parameters bitwise "
          f"the checkpoint's {params_equal}, EMA bitwise the shadow {ema_equal}")
    if not (params_equal and ema_equal):
        failures.append(f"{label}: parameters equal {params_equal}, EMA equal {ema_equal}")


class CliSummaries:
    """Inside the block, each call of the named modules' ``main`` keeps its
    return value and wall seconds, by module (``cli.eval`` and
    ``cli.deep_eval`` return their summaries)."""

    def __init__(self, *modules):
        self.modules, self.calls = modules, []

    def __enter__(self):
        self.mains = [m.main for m in self.modules]
        for module, real in zip(self.modules, self.mains):
            def timed(argv=None, real=real, name=module.__name__.rsplit(".", 1)[-1]):
                start = time.time()
                out = real(argv)
                self.calls.append((name, time.time() - start, out))
                return out

            module.main = timed
        return self

    def __exit__(self, *exc):
        for module, real in zip(self.modules, self.mains):
            module.main = real
        return False


def check_programs(label, programs, counts, forwards, failures):
    """A captured path's launches: each program recorded one forward's
    ``IMPORT_FORWARD_LAUNCHES``, the wrappers counted its warm-up and
    capture and nothing else, and the replays ran ``forwards`` forwards."""
    per = [r.launch_counts for r in programs]
    through = {k: 2 * v * len(programs) for k, v in IMPORT_FORWARD_LAUNCHES.items()}
    replays = sum(r.replays for r in programs)
    print(f"import: {label}: {len(programs)} program(s), recorded {per}, replays {replays}, "
          f"through the wrappers {counts}")
    if (any(p != IMPORT_FORWARD_LAUNCHES for p in per) or counts != through
            or replays != forwards):
        failures.append(f"{label}: recorded {per}, wrappers {counts} (expected {through}), "
                        f"replays {replays} (expected {forwards})")


def run_import(torch, ck, dev, card):
    """Phase 17 ("import"). Returns the paths' kernel runs."""
    import contextlib
    import csv
    import gc
    import io
    import os
    import shutil
    import tempfile

    from diffse_tpu_torch.cli import convert_torch_checkpoint, reproduce_tables
    from diffse_tpu_torch.cli import deep_eval as deep_eval_cli
    from diffse_tpu_torch.cli import eval as eval_cli
    from diffse_tpu_torch.data.synthetic import make_synthetic_dataset
    from diffse_tpu_torch.models.score_model import ScoreModel, ScoreModelConfig
    from diffse_tpu_torch.models.snrnet import SNRNet
    from diffse_tpu_torch.train import CheckpointManager
    from diffse_tpu_torch.train.restore import load_score_model, load_snr_model
    from diffse_tpu_torch.train.state import load_ema

    t_phase = time.time()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    failures, paths = [], {}
    root = tempfile.mkdtemp(prefix="diffse_import_")
    try:
        t0 = time.time()
        ckpts, tensors = reference_checkpoints(torch, root)
        print(f"import: reference .ckpt files written in {time.time() - t0:.1f} s: "
              f"M6.ckpt {os.path.getsize(ckpts['score']) / 1e6:.1f} MB, snr_estimator.ckpt "
              f"{os.path.getsize(ckpts['snr']) / 1e6:.1f} MB")

        # 1. the importer, as a user runs it
        dirs, seconds = {}, {}
        for kind, flag in (("score", "score"), ("snr", "snrnet")):
            dirs[kind] = os.path.join(root, f"imported_{kind}")
            start = time.time()
            convert_torch_checkpoint.main(["--torch_ckpt", ckpts[kind], "--out_dir", dirs[kind],
                                           "--ema", "--kind", flag])
            seconds[kind] = time.time() - start
            size = os.path.getsize(os.path.join(dirs[kind], "step_0", "state.pt"))
            print(f"{card}: import {kind}: {seconds[kind]:.2f} s (torch.load, build on the "
                  f"CPU, load, save; host I/O), state.pt {size / 1e6:.1f} MB")

        # where the score import's time goes: its steps once more, apart
        start = time.time()
        ckpt = torch.load(ckpts["score"], map_location="cpu")
        t_load = time.time() - start
        start = time.time()
        model, state = convert_torch_checkpoint.import_score(ckpt, {}, True)
        t_build = time.time() - start
        start = time.time()
        CheckpointManager(os.path.join(root, "again"), hparams=model.hparams).save(0, state, {})
        t_save = time.time() - start
        print(f"{card}: import score, its steps apart: torch.load {t_load:.2f} s, the model built "
              f"on the CPU and the tensors loaded {t_build:.2f} s, the save {t_save:.2f} s "
              f"(page cache warm)")
        del ckpt, model, state
        shutil.rmtree(os.path.join(root, "again"))

        # 2. restored on the card: the EMA bitwise the shadow
        snr_model, snr_state = load_snr_model(dirs["snr"], device=dev)
        check_imported(torch, "SNRNet", snr_state, tensors["snr"], tensors["snr_ema"], failures)
        load_ema(snr_state)
        model, state = load_score_model(dirs["score"], snr_model=snr_model.dnn, device=dev)
        check_imported(torch, "NCSN++ (65.6M)", state, tensors["score"], tensors["score_ema"],
                       failures)
        load_ema(state)
        print(f"import: restored config {model.cfg.model_type}, snr_conditioned "
              f"{model.cfg.snr_conditioned}, fixed_snr {model.cfg.fixed_snr}, sde "
              f"{model.cfg.sde} {model.hparams['sde_kwargs']}")

        # 3. sebridge_v3_snr through enhance, imported against loaded directly
        rng = np.random.default_rng(17)
        utterances = [synthetic_pair(rng, int(s * SR))[1] for s in IMPORT_SECONDS]

        def enhance_all(m):
            outs, walls = [], []
            for i, y in enumerate(utterances):
                torch.cuda.synchronize()
                start = time.time()
                outs.append(m.enhance(y[None], y[None],
                                      generator=torch.Generator(dev).manual_seed(170 + i)))
                torch.cuda.synchronize()
                walls.append(time.time() - start)
            return outs, walls

        torch.cuda.synchronize()
        ck.reset_launch_counts()
        with ProgramLog(torch) as programs:
            outs, walls = enhance_all(model)
        counts = dict(ck.launch_counts)
        check_programs("sebridge_v3_snr (imported)", programs.records, counts,
                       len(utterances), failures)
        paths["import: sebridge_v3_snr, imported checkpoints (graphed)"] = card_runs(
            counts, programs.records)
        model.drop_programs()
        del model, state, snr_model, snr_state
        snr_net = SNRNet()
        snr_net.load_state_dict(tensors["snr_ema"])
        direct = ScoreModel(ScoreModelConfig(
            backbone="ncsnpp", sde="bbed", model_type="sebridge_v3", snr_conditioned="true",
            fixed_snr=FIXED_SNR, sigma_max=1.0), sde_kwargs=dict(k=2.6, theta=0.52,
                                                                 T_sampling=0.999),
            device=dev, generator=torch.Generator().manual_seed(0), snr_model=snr_net)
        direct.backbone.load_state_dict(
            {k: tensors["score_ema"][k] if p.requires_grad else tensors["score"][k]
             for k, p in direct.backbone.named_parameters()})
        refs, ref_walls = enhance_all(direct)
        direct.drop_programs()
        del direct, snr_net
        for y, out, ref, wall, ref_wall in zip(utterances, outs, refs, walls, ref_walls):
            bitwise = out.shape == ref.shape and np.array_equal(out, ref)
            print(f"{card}: import: sebridge_v3_snr on {len(y) / SR:.2f} s, imported vs loaded "
                  f"directly: bitwise equal {bitwise}, max|diff| "
                  f"{float(np.max(np.abs(out - ref))):.3e}; walls {wall:.4f} / {ref_wall:.4f} s "
                  f"(first call of a bucket: warm-up, capture, replay); finite "
                  f"{bool(np.isfinite(out).all())}")
            if not bitwise or not np.isfinite(out).all() or out.shape != y.shape:
                failures.append(f"sebridge_v3_snr on {len(y) / SR:.2f} s: bitwise {bitwise}")
        gc.collect()
        torch.cuda.empty_cache()

        # 4. cli.reproduce_tables on the two .ckpt files and a synthetic stand-in
        vbd = os.path.join(root, "vbd")
        make_synthetic_dataset(vbd, num_train=0, num_valid=3, num_valid2=2, num_test=0,
                               duration_s=1.2)
        out_dir = os.path.join(root, "tables")
        printed = io.StringIO()
        ck.reset_launch_counts()
        start = time.time()
        try:
            with ProgramLog(torch) as programs, CliSummaries(
                    convert_torch_checkpoint, eval_cli, deep_eval_cli) as clis, \
                    contextlib.redirect_stdout(printed):
                rc = reproduce_tables.main(["--vbd_dir", vbd, "--ckpt", ckpts["score"],
                                            "--snr_ckpt", ckpts["snr"], "--eta", "10",
                                            "--device", "cuda", "--out_dir", out_dir])
        finally:  # the harness's own lines (its CLIs' per-file lines left out)
            out = printed.getvalue()
            for line in out.splitlines():
                if line.startswith("[tables]") or " ours=" in line:
                    print(line)
        wall = time.time() - start
        counts = dict(ck.launch_counts)
        verdict = json.loads([line for line in out.splitlines()
                              if line.startswith("[tables] RESULT")][-1].split(" ", 2)[2])
        printed_cells = [c for c in IMPORT_CELLS if f"  {c:<28} ours=" in out]
        check_programs("reproduce_tables", programs.records, counts, 3 + 2 * 9, failures)
        paths["import: reproduce_tables, cli.eval + cli.deep_eval (graphed)"] = card_runs(
            counts, programs.records)
        with open(os.path.join(out_dir, "table1", "_results.csv")) as f:
            t1 = list(csv.reader(f))
        with open(os.path.join(out_dir, "tables23", "_results_deep.csv")) as f:
            t23 = list(csv.reader(f))
        t1_ok = (t1[0] == ["filename", "pesq", "si_sdr", "estoi"] and len(t1) == 4
                 and all(np.isfinite(float(r[2])) for r in t1[1:]))
        t23_ok = (len(t23) == 3 and len(t23[0]) == 28
                  and all(np.isfinite(float(v)) for r in t23[1:]
                          for name, v in zip(t23[0], r) if name.startswith("si_sdr")))
        phases = {name: [] for name in ("convert_torch_checkpoint", "eval", "deep_eval")}
        for name, secs, summary in clis.calls:
            phases[name].append((secs, summary))
        captures = [round(r.capture_seconds, 3) for r in programs.records]
        parts = "; ".join(
            f"{name} {secs:.2f} s" + (f" (enhance {summary['enhance_seconds']:.2f} s, host "
                                       f"scoring {summary['scoring_seconds']:.2f} s, "
                                       f"{summary['files']} files)"
                                       if isinstance(summary, dict) else "")
            for name, calls in phases.items() for secs, summary in calls)
        print(f"{card}: import: reproduce_tables rc {rc}, verdict {verdict['verdict'][:40]}..., "
              f"{len(printed_cells)} of {len(IMPORT_CELLS)} cells printed; wall {wall:.2f} s: "
              f"{parts}; captures {captures} s (inside enhance); _results.csv {len(t1) - 1} "
              f"rows complete {t1_ok}, _results_deep.csv {len(t23) - 1} rows of "
              f"{len(t23[0]) - 1} values complete {t23_ok}")
        if (rc != 1 or not verdict["verdict"].startswith("PARITY FAIL")
                or len(printed_cells) != len(IMPORT_CELLS) or not (t1_ok and t23_ok)
                or len(phases["convert_torch_checkpoint"]) != 2):
            failures.append(f"reproduce_tables: rc {rc}, verdict {verdict['verdict'][:60]}, "
                            f"cells {len(printed_cells)}, CSVs {t1_ok} / {t23_ok}, "
                            f"conversions {len(phases['convert_torch_checkpoint'])}")
        report_paths(paths, failures)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"phase import: {time.time() - t_phase:.1f} s")
    if failures:
        raise AssertionError("; ".join(failures))
    return paths


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
    card = smi.stdout.strip().splitlines()[0]
    print(card)
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
                        ("serve", lambda: run_serving(torch, ck, dev)),
                        ("eval", lambda: run_eval(torch, ck, dev, card)),
                        ("snr_train", lambda: run_snr_train(torch, ck, dev, card)),
                        ("export", lambda: run_export(torch, ck, dev, card)),
                        ("backbones", lambda: run_backbones(torch, ck, dev, card)),
                        ("parallel", lambda: run_parallel(torch, ck, dev, card)),
                        ("sequence", lambda: run_sequence(torch, ck, dev, card)),
                        ("import", lambda: run_import(torch, ck, dev, card))):
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
             **results["train"][0], **results["serve"], **results["eval"],
             **results["snr_train"], **results["export"][0], **results["backbones"],
             **results["parallel"], **results["sequence"][0], **results["import"]}
    bf16_paths = {"bf16_forward (eager)": results["bf16_forward"],
                  "bf16_bench_program (graphed)": results["bf16_program"],
                  **results["samplers"][1], **results["train"][1], **results["export"][1],
                  **results["sequence"][1]}

    def launches(kernel, by=paths):
        # the split statistics' kernels run on the frames-parallel paths only
        runs = {path: counts["runs"].get(kernel, 0) for path, counts in by.items()}
        recorded = {path: counts["recorded"].get(kernel, 0) for path, counts in by.items()}
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
        # the split statistics: one kernel each for float32 and bf16
        {"name": "gn_group_sums", **gn_source,
         "replaces": "diffse_tpu/ops/pallas_kernels.py:46",
         "also_replaces": "diffse_tpu/ops/pallas_kernels.py:269",
         **launches("gn_group_sums", {**paths, **bf16_paths}),
         **results["sequence"][2]["gn_group_sums"]},
        {"name": "gn_fold_ab", **gn_source,
         "replaces": "diffse_tpu/ops/pallas_kernels.py:46",
         "also_replaces": "diffse_tpu/ops/pallas_kernels.py:269",
         **launches("gn_fold_ab", {**paths, **bf16_paths}),
         **results["sequence"][2]["gn_fold_ab"]},
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
