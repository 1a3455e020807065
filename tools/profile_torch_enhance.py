#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's ``bbed_pc`` enhance, on one GPU.

    python3 tools/profile_torch_enhance.py [--seconds 1.5] [--table PATH]

Runs ``diffse_tpu_torch``'s ``ScoreModel.enhance`` (65M NCSN++, default
initialisation, float32) once to warm up, then once under
``torch.profiler``, and prints:

  - the card's name and power limit;
  - wall time of the profiled enhance and the sum of device kernel time, so
    the device's idle share ``1 - kernel_time / wall``, and the number of
    device kernel launches;
  - device time grouped by kernel family (the port's CUDA kernels, cuDNN and
    other convolutions, GEMMs, FFTs, elementwise and reductions) and the top
    kernels by device time.

With ``--table``, the profiler's full table by kernel is written to PATH.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from collections import defaultdict

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from diffse_tpu_torch.models.score_model import ScoreModel, ScoreModelConfig  # noqa: E402

STEPS = 30  # PC steps, two forwards each

FAMILIES = (
    ("port: gn_silu_conv3x3", ("gn_silu_conv3x3", "conv_split_reduce_kernel")),
    ("port: groupnorm stats", ("gn_stats_ab_kernel",)),
    ("port: groupnorm apply", ("gn_apply_kernel",)),
    ("conv (cuDNN/other)", ("conv", "implicit", "winograd", "fprop", "dgrad", "xmma", "cudnn")),
    ("gemm", ("gemm", "sgemm", "cutlass", "matmul")),
    ("fft (stft/istft)", ("fft", "regular_fft", "vector_fft")),
    ("reduce", ("reduce",)),
    ("elementwise / copy", ("elementwise", "vectorized", "copy", "fill", "cat", "index")),
)


def family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "other"


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seconds", type=float, default=1.5, help="utterance length")
    parser.add_argument("--table", default=None, help="write the profiler's full table here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)

    dev = torch.device("cuda", 0)
    model = ScoreModel(ScoreModelConfig(backbone="ncsnpp", sde="bbed", model_type="bbed",
                                        sigma_max=0.5),
                       sde_kwargs=dict(T_sampling=0.999, k=2.6, theta=0.52, N=STEPS),
                       device=dev, generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    y = (0.1 * rng.standard_normal((1, int(args.seconds * 16000)))).astype(np.float32)
    model.enhance(y, y, generator=torch.Generator(dev).manual_seed(0), N=STEPS)
    t0 = time.perf_counter()
    model.enhance(y, y, generator=torch.Generator(dev).manual_seed(0), N=STEPS)
    wall_plain = time.perf_counter() - t0  # enhance returns host numpy: synchronised

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.enhance(y, y, generator=torch.Generator(dev).manual_seed(1), N=STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    # A kernel's own device time is its self device time; CPU-side ops carry
    # none of their own (their kernels are their children), so the sum over
    # all entries is the device's kernel time.
    by_name = defaultdict(float)
    launches = 0
    for avg in prof.key_averages():
        if avg.device_type == torch.autograd.DeviceType.CUDA and avg.self_device_time_total > 0:
            by_name[avg.key] += avg.self_device_time_total
            launches += avg.count
    total_us = sum(by_name.values())
    if total_us == 0:
        print("the profiler recorded no device time: breakdown not measured", file=sys.stderr)
        return 1
    fams = defaultdict(float)
    for name, us in by_name.items():
        fams[family(name)] += us
    frames = 1 + int(args.seconds * 16000) // 128
    print(f"bbed_pc, {args.seconds} s utterance ({frames} frames, padded to a multiple of 64), "
          f"{2 * STEPS} forwards: wall {wall_plain:.3f} s; profiled: wall {wall:.3f} s, device kernel time "
          f"{total_us / 1e6:.3f} s; device idle share {1 - total_us / 1e6 / wall_plain:.3f} "
          f"of the unprofiled wall; {launches} device kernel launches "
          f"({launches / (2 * STEPS):.0f} per forward, sampler included)")
    for fam, us in sorted(fams.items(), key=lambda kv: -kv[1]):
        print(f"  {fam:28s} {us / 1e3:10.2f} ms  {us / total_us:6.1%}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    for name, us in top[:12]:
        print(f"  {us / 1e3:10.2f} ms  {name[:110]}")
    if args.table:
        os.makedirs(os.path.dirname(os.path.abspath(args.table)), exist_ok=True)
        with open(args.table, "w") as f:
            f.write(card + "\n")
            f.write(prof.key_averages().table(sort_by="self_device_time_total", row_limit=60))
    return 0


if __name__ == "__main__":
    sys.exit(main())
