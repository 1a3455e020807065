#!/usr/bin/env python3
"""Drive the PyTorch port (diffse_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass:

1. Print the card's name and power limit, then build the CUDA kernels from
   ``diffse_tpu_torch/csrc`` (nvcc, sm_90a) and print the build time.
2. Hold each kernel to its plain PyTorch version on the card (TF32 off for
   cuDNN and matmul) at the main path's shapes; print errors and median
   times over CUDA events.
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

Phase 2 runs with TF32 off for cuDNN and matmul (the plain version's cuDNN
conv would otherwise be the less accurate side); phases 3 and 4 run with
torch's defaults (cuDNN allows TF32), as a user's process would: the port
keeps its own convs and matmuls in float32.

The line before the last is a JSON object of the kernels; the last line is
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
K2_SHAPES = [  # the deep levels at T=64, then at T=192 (odd widths, the concat)
    (1, 16, 4, 256, 256, False), (1, 8, 2, 256, 256, False), (1, 4, 1, 256, 256, False),
    (1, 16, 12, 512, 256, False), (1, 8, 6, 256, 256, True), (1, 4, 3, 256, 256, False),
]
FORWARD_FRAMES = (64, 128, 192)
K3_SHAPES = [(1, 256, 64, 128), (1, 128, 32, 256)]


def median_ms(torch, fn, reps=20, warmup=3):
    """Median time of one call over CUDA events."""
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


def check_kernels(torch, ck, dev):
    """Phase 2. Returns per-kernel {max_abs_err, ms, plain_ms}."""
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
        ms = median_ms(torch, lambda: ck.groupnorm_silu_conv3x3(*args, **kw))
        plain_ms = median_ms(torch, lambda: ck.groupnorm_silu_conv3x3_reference(*args, **kw))
        name = f"gn_silu_conv3x3 {[b, h, w, cin]}->{cout}{' +skip' if with_skip else ''}"
        print(f"{name}: max_abs_err {err:.3e} rel {rel:.3e} ok {ok} | "
              f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms")
        r = result["gn_silu_conv3x3"]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if (b, h, w, cin, cout, with_skip) == (1, 256, 64, 128, 128, True):
            r["ms"], r["plain_ms"] = ms, plain_ms
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
            ms = median_ms(torch, lambda: ck.groupnorm_silu(x, sc, bi, groups, apply_silu=apply_silu))
            plain_ms = median_ms(torch, lambda: ck.groupnorm_silu_reference(
                x, sc, bi, groups, apply_silu=apply_silu))
            name = f"groupnorm_silu {list(shape)} silu={apply_silu}"
            print(f"{name}: max_abs_err {err:.3e} rel {rel:.3e} ok {ok} | "
                  f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms")
            r = result["groupnorm_silu"]
            r["max_abs_err"] = max(r["max_abs_err"], err)
            if shape == (1, 256, 64, 128) and apply_silu:
                r["ms"], r["plain_ms"] = ms, plain_ms
            if not ok:
                failures.append(name)
    if failures:
        raise AssertionError(f"kernels disagree with their plain versions: {failures}")
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
    print("phases 3-4 with torch's defaults: torch.backends.cudnn.allow_tf32=True, "
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
        if counts != {"gn_silu_conv3x3": 81, "groupnorm_silu": 28}:
            failures.append(f"T={frames}: launch counts per forward {counts}, expected 81 and 28")
    if failures:
        raise AssertionError("; ".join(failures))


def synthetic_utterance(rng, n):
    """Speech-like: a harmonic stack under a syllable envelope, plus noise."""
    t = np.arange(n) / SR
    f0 = rng.uniform(100, 220)
    harm = sum(rng.uniform(0.2, 1.0) * np.sin(2 * np.pi * f0 * k * t + rng.uniform(0, 6.3))
               for k in range(1, 6))
    env = 0.02 + np.clip(np.sin(2 * np.pi * rng.uniform(2.0, 4.0) * t), 0, None)
    clean = 0.3 * env * harm / 5
    return (clean + 0.05 * rng.standard_normal(n)).astype(np.float32)


def run_main_path(torch, ck, dev):
    """Phase 4: enhance through bbed_pc (3 utterances) and sebridge_v2."""
    from diffse_tpu_torch.models.score_model import ScoreModel, ScoreModelConfig
    from diffse_tpu_torch.utils import randn_like

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

    rng = np.random.default_rng(3)
    utterances = [synthetic_utterance(rng, int(s * SR)) for s in (1.0, 1.2, 1.5)]

    def v2_noise(seed):
        g = torch.Generator().manual_seed(seed)
        return lambda like: randn_like(like.cpu(), g).to(like.device)

    walls, outs = [], []
    ck.reset_launch_counts()
    for i, y in enumerate(utterances):
        t0 = time.time()
        out, nfe = bbed.enhance(y[None], y[None], generator=torch.Generator(dev).manual_seed(i),
                                N=30, timeit=True)[:2]
        walls.append(time.time() - t0)
        outs.append(out)
    v2_out = v2.enhance(utterances[0][None], utterances[0][None], noise=v2_noise(7))
    counts = dict(ck.launch_counts)

    for y, out, wall in zip(utterances, outs, walls):
        print(f"bbed_pc: {len(y) / SR:.2f} s utterance, nfe {nfe}, wall {wall:.3f} s, "
              f"finite {bool(np.isfinite(out).all())}, peak {np.max(np.abs(out)):.4f}")
    total_forwards = 60 * len(utterances) + 1
    print(f"main-path launches: {counts} over {total_forwards} forwards")
    for y, out in zip(utterances + [utterances[0]], outs + [v2_out]):
        if out.shape != y.shape or not np.isfinite(out).all():
            raise AssertionError(f"bad output: shape {out.shape} vs {y.shape}")
    expected = {"gn_silu_conv3x3": 81 * total_forwards, "groupnorm_silu": 28 * total_forwards}
    if counts != expected:
        raise AssertionError(f"main-path launch counts {counts}, expected {expected}")

    v2_cpu = ScoreModel(v2_cfg, sde_kwargs=sde_kwargs, device="cpu")
    v2_cpu.backbone.load_state_dict(v2.backbone.state_dict())
    ref = v2_cpu.enhance(utterances[0][None], utterances[0][None], noise=v2_noise(7))
    err = float(np.max(np.abs(v2_out - ref)) / np.max(np.abs(ref)))
    print(f"sebridge_v2 waveform, card vs CPU plain path: max|diff|/max|ref| {err:.3e} "
          f"(tol {WAVEFORM_TOL})")
    if err > WAVEFORM_TOL:
        raise AssertionError(f"sebridge_v2 waveform deviates: {err:.3e}")
    return counts, walls


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
    kernels, counts = None, None
    for name, phase in (("kernels", lambda: check_kernels(torch, ck, dev)),
                        ("forward", lambda: check_forward(torch, ck, dev)),
                        ("enhance", lambda: run_main_path(torch, ck, dev))):
        t0 = time.time()
        try:
            result = phase()
        except Exception:  # report every phase, then fail
            traceback.print_exc()
            print(f"phase {name}: FAILED after {time.time() - t0:.1f} s")
            ok = False
            continue
        print(f"phase {name}: ok in {time.time() - t0:.1f} s")
        if name == "kernels":
            kernels = result
        elif name == "enhance":
            counts = result[0]
    if not ok:
        return 1

    sources = {"route": "cuda", "source": "diffse_tpu_torch/csrc/gn_kernels.cu"}
    record = {"kernels": [
        {"name": "gn_silu_conv3x3", **sources,
         "replaces": "diffse_tpu/ops/pallas_kernels.py:269",
         "also_replaces": "diffse_tpu/ops/pallas_kernels.py:350",
         "launches": counts["gn_silu_conv3x3"], **kernels["gn_silu_conv3x3"]},
        {"name": "groupnorm_silu", **sources,
         "replaces": "diffse_tpu/ops/pallas_kernels.py:46",
         "launches": counts["groupnorm_silu"], **kernels["groupnorm_silu"]},
    ]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
