#!/usr/bin/env python3
"""Drive the PyTorch port (diffse_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass:

1. Print the card's name and power limit, then build the CUDA kernels from
   ``diffse_tpu_torch/csrc`` (nvcc, sm_90a) and print the build time.
2. Hold each GroupNorm kernel to its plain PyTorch version on the card (TF32
   off for cuDNN and matmul) at the main path's shapes; print errors, median
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
   plus one ``sebridge_v2`` call with redrawn weights, with the launch counts
   reset before and read after. Outputs must be finite and of the input's
   length; the ``sebridge_v2`` waveform must match the same call on the CPU.
5. The SNR path, the paper's single-NFE mode: ``sebridge_v3_snr`` on the 65M
   ``ncsnpp`` (redrawn weights, fixed_snr 0.17783) with a redrawn SNRNet, on
   phase 4's utterances. SNRNet's output on the card against the CPU (1e-5
   relative), the snapped t_hat equal on both (and not within float error of
   a snap boundary), the waveforms against the CPU given the same noise, and
   81/28 launches per forward, one forward per utterance. Then one
   ``sebridge_v2_snr`` call on the 65M ``ncsnpp_snr``, checked the same way.
   Each path's launch counts are reset before it and read after it.
6. The bf16 kernels (the trunk of ``NCSNpp(dtype="bf16")``): each against its
   plain version on the card at phase 2's shapes and at bench.py's batch of
   16 at 64 frames (the large level with and without skip, the deep levels,
   the heads; GroupNorm bf16 -> bf16 and bf16 -> float32; the statistics
   pass), within one bfloat16 ulp but on at most ``BF16_SHARE`` of the
   elements (``bf16_agreement``), with times, bounds (products over the bf16
   tensor-core peak) and library times.
7. The 65M ``NCSNpp(dtype="bf16", fuse_pyramid=True)`` at B=1, T=64 on the
   card, with redrawn weights and with the network's own seeded
   initialisation: the whole forward against the CPU and against the float32
   forward on the card with the same weights (the card-vs-CPU gap below
   ``BF16_GAP_RATIO`` of that bf16-vs-float32 gap), 81/28 launches per
   forward; with redrawn weights also each block, attention and Combine of
   the card's forward run again on the CPU from the card's inputs (within
   ``BF16_MODULE_ULPS``).
8. bench.py's program (bench.py:147-160) from the port's modules: 16
   utterances of 64 frames, each row normalised by its max-abs, STFT,
   ``spec_fwd``, ``pad_spec``, 30 reverse_diffusion + ald steps, ``to_audio``,
   times the norm, with the bf16 trunk and with the float32 trunk on the same
   weights and noise draws: wall, device kernel time (``torch.profiler``),
   idle share and launches for each, both outputs finite, and their gap;
   4860/1680 kernel launches per batch in bf16.

Phase 2 runs with TF32 off for cuDNN and matmul (the plain version's cuDNN
conv would otherwise be the less accurate side); phases 3 to 5 run with
torch's defaults (cuDNN allows TF32), as a user's process would: the port
keeps its own convs, matmuls and LSTM in float32.

The line before the last is a JSON object of the kernels (times in ms; the
bound is the larger of bytes over 3.35 TB/s and operations over their peak:
the conv's products in 3xTF32, three TF32 products each, over 495 TFLOP/s,
or in bf16 over 989 TFLOP/s, other float32 work over 67 TFLOP/s, the H100
SXM's peaks), the bf16 instantiations as kernels of their own; the last line is
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result, when
there is no CUDA device or any phase fails.
"""

from __future__ import annotations

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
FORWARD_FRAMES = (64, 128, 192)
K3_SHAPES = [(1, 256, 64, 128), (1, 128, 32, 256)]
# the statistics pass alone: K3's shapes, the largest map (T=192) and a small one
STATS_SHAPES = [(1, 256, 64, 128), (1, 128, 32, 256), (1, 256, 192, 128), (1, 16, 12, 256)]
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

# bf16 kernels (phase 6): phase 2's conv shapes, then bench.py's batch of 16
# at 64 frames: the large level (with and without skip), the 384-channel
# concat, the heads, a W = 8 level (wgmma in bf16) and the deep levels (K
# split across blocks).
BF16_K1_SHAPES = K1_SHAPES + K2_SHAPES + [
    (16, 256, 64, 128, 128, False), (16, 256, 64, 128, 128, True), (16, 128, 32, 384, 128, False),
    (16, 256, 64, 128, 4, False), (16, 32, 8, 512, 256, False),
    (16, 16, 4, 256, 256, False), (16, 8, 2, 256, 256, False),
    (16, 4, 1, 256, 256, False), (16, 16, 4, 512, 256, False), (16, 8, 2, 256, 256, True),
    (16, 4, 1, 256, 4, False)]
BF16_K3_SHAPES = [(1, 256, 64, 128), (1, 128, 32, 256), (16, 256, 64, 128), (16, 16, 4, 256)]
BF16_STATS_SHAPES = [(1, 256, 64, 128), (16, 256, 64, 128), (16, 16, 4, 256)]
BF16_REPORT_CONV = (16, 256, 64, 128, 128, True)
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
BENCH_BATCH = 16
BENCH_FRAMES = 64
BENCH_STEPS = 30


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
    for b, h, w, cin, cout, with_skip in K1_SHAPES + K2_SHAPES:
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

    rng = np.random.default_rng(6)

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev, dtype)

    result = {"gn_silu_conv3x3": {"max_abs_err": 0.0}, "groupnorm_silu": {"max_abs_err": 0.0}}
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
        out = ck.groupnorm_silu_conv3x3(*args, **kw)
        ref = ck.groupnorm_silu_conv3x3_reference(*args, **kw)
        torch.cuda.synchronize()
        ok, share, err = bf16_agreement(torch, out, ref)
        ok = ok and out.dtype == torch.bfloat16
        times = timing(torch, lambda: ck.groupnorm_silu_conv3x3(*args, **kw),
                       lambda: ck.groupnorm_silu_conv3x3_reference(*args, **kw))
        bound_ms, bound_by = conv_bounds(b, h, w, cin, cout, with_skip, act_bytes=2)["bf16"]
        plan = ck.conv_plan(b, h, w, cin, cout, torch.bfloat16)
        bm, bn, _, instruction = ck.CONV_CONFIGS[plan.config][:4]
        name = f"gn_silu_conv3x3 bf16 {[b, h, w, cin]}->{cout}{' +skip' if with_skip else ''}"
        print(f"{name}: max_abs_err {err:.3e}, share beyond 1 bf16 ulp {share:.2e} (limit "
              f"{BF16_SHARE}) ok {ok} | {describe(times, bound_ms, bound_by)} | plan: "
              f"{instruction} bf16, {bm}x{bn} block, tile {plan.th}x{plan.tw}, grid {plan.grid} = "
              f"{plan.ctas} CTAs, K split {plan.splits} x {plan.units_per_split} of {plan.units} "
              f"units, {plan.smem_bytes} B shared")
        r = result["gn_silu_conv3x3"]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if (b, h, w, cin, cout, with_skip) == BF16_REPORT_CONV:
            r.update(times, bound_ms=bound_ms, bound_by=bound_by)
        if not ok:
            failures.append(name)
    for shape in BF16_K3_SHAPES:
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

    walls, outs = [], []
    ck.reset_launch_counts()
    for i, y in enumerate(utterances):
        t0 = time.time()
        out, nfe = bbed.enhance(y[None], y[None], generator=torch.Generator(dev).manual_seed(i),
                                N=30, timeit=True)[:2]
        walls.append(time.time() - t0)
        outs.append(out)
    v2_out = v2.enhance(utterances[0][None], utterances[0][None], noise=cpu_noise(torch, 7))
    counts = dict(ck.launch_counts)

    for y, out, wall in zip(utterances, outs, walls):
        print(f"bbed_pc: {len(y) / SR:.2f} s utterance, nfe {nfe}, wall {wall:.3f} s, "
              f"finite {bool(np.isfinite(out).all())}, peak {np.max(np.abs(out)):.4f}")
    total_forwards = 60 * len(utterances) + 1
    print(f"main-path launches: {counts} over {total_forwards} forwards")
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
    return counts, walls


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
    return {"sebridge_v3_snr": v3_counts, "sebridge_v2_snr": v2_counts}


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
            for hook in hooks:
                hook.remove()
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
              f"float32 on the card; launches per forward {counts}")
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
        del card, cpu, f32, records
    if failures:
        raise AssertionError("; ".join(failures))
    return counts


def run_bf16_program(torch, ck, dev):
    """Phase 8: bench.py's batch-16 program with the bf16 and the float32
    trunk. Returns the bf16 run's launch counts."""
    from torch.profiler import ProfilerActivity, profile

    from diffse_tpu_torch.models.score_model import ScoreModel, ScoreModelConfig
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
    def program(model, seed):
        gen = torch.Generator(dev).manual_seed(seed)
        norm = torch.max(torch.abs(y), dim=-1, keepdim=True).values
        Y = pad_spec(spec_fwd(model._stft(y / norm), model.spec_cfg)[:, None])
        sampler = get_pc_sampler("reverse_diffusion", "ald", sde=model.sde,
                                 score_fn=model.forward, Y=Y,
                                 noise=lambda like: randn_like(like, gen), eps=cfg.t_eps,
                                 snr=0.5, corrector_steps=1)
        sample, _ = sampler()
        return model.to_audio(sample[:, 0]) * norm

    outs, counts, failures = {}, {}, []
    for name, model in models.items():
        program(model, 1)  # warm-up
        torch.cuda.synchronize()
        ck.reset_launch_counts()
        t0 = time.perf_counter()
        outs[name] = program(model, 2)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts[name] = dict(ck.launch_counts)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            program(model, 2)
            torch.cuda.synchronize()
            wall_profiled = time.perf_counter() - t0
        device_us, launches = 0.0, 0
        for avg in prof.key_averages():
            if avg.device_type == torch.autograd.DeviceType.CUDA and avg.self_device_time_total > 0:
                device_us += avg.self_device_time_total
                launches += avg.count
        out = outs[name]
        finite = bool(torch.isfinite(out).all())
        idle = (f"{1 - device_us / 1e6 / wall:.3f}" if device_us > 0
                else "not measured (the profiler recorded no device time)")
        print(f"bench program, {name} trunk: {BENCH_BATCH} x {BENCH_FRAMES} frames, "
              f"{2 * BENCH_STEPS} forwards: wall {wall:.3f} s ({BENCH_BATCH * audio_len / SR / wall:.2f}"
              f" s of audio per s); profiled wall {wall_profiled:.3f} s, device kernel time "
              f"{device_us / 1e6:.3f} s, idle share {idle}; {launches} device kernel launches; "
              f"kernel wrapper launches {counts[name]}; output {tuple(out.shape)} finite {finite}")
        if tuple(out.shape) != (BENCH_BATCH, audio_len) or not finite:
            failures.append(f"{name}: output {tuple(out.shape)}, finite {finite}")
    gap = relative_gap(outs["bf16"], outs["float32"])
    print(f"bench program: bf16 vs float32 trunk, same weights and noise draws: "
          f"max|diff|/max|ref| {gap:.3e}")
    expected = {"gn_silu_conv3x3": 81 * 2 * BENCH_STEPS, "groupnorm_silu": 28 * 2 * BENCH_STEPS,
                "fused_bias_leaky_relu": 0}
    for name in models:
        if counts[name] != expected:
            failures.append(f"{name}: launch counts {counts[name]}, expected {expected}")
    if failures:
        raise AssertionError("; ".join(failures))
    return counts["bf16"]


def main() -> int:
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
                        ("bf16_kernels", lambda: check_bf16_kernels(torch, ck, dev)),
                        ("bf16_forward", lambda: check_bf16_forward(torch, ck, dev)),
                        ("bf16_program", lambda: run_bf16_program(torch, ck, dev))):
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

    # launches on each main path, each counted from zero: the float32 paths,
    # and the bf16 trunk's (one forward; bench.py's batch-16 program)
    paths = {"bbed_pc+sebridge_v2": results["enhance"][0], **results["snr"]}
    bf16_paths = {"bf16_forward": results["bf16_forward"],
                  "bf16_bench_program": results["bf16_program"]}

    def launches(kernel, by=paths):
        by_path = {path: counts[kernel] for path, counts in by.items()}
        return {"launches": sum(by_path.values()), "launches_by_path": by_path}

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
         **launches("gn_silu_conv3x3", bf16_paths), **results["bf16_kernels"]["gn_silu_conv3x3"]},
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
