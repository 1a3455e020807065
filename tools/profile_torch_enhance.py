#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's ``bbed_pc`` enhance, on one GPU.

    python3 tools/profile_torch_enhance.py [--seconds 1.5] [--dtype bf16] [--table PATH]

Runs ``diffse_tpu_torch``'s ``ScoreModel.enhance`` (65M NCSN++, default
initialisation, float32 unless ``--dtype bf16``) two ways: graphed, as
``enhance`` runs on the card (its captured program, ``_enhance_graph``,
replayed), and eagerly, op by op (noise from a callable over the same
generator, which makes ``enhance`` run its steps one by one). Each is run
once to warm up (the graphed one captures there), then once under
``torch.profiler``. For each it prints:

  - wall time of an unprofiled call and of the profiled one, the sum of
    device kernel time, so the device's idle share ``1 - kernel_time /
    wall``, and the number of device kernel launches;
  - device time grouped by kernel family (``diffse_tpu_torch.profiling``:
    the port's CUDA kernels by instantiation, cuDNN and other convolutions,
    GEMMs, FFTs, random draws, reductions, elementwise) and the top kernels.

With ``--table``, the profiler's full tables by kernel are written to PATH.
The card's name and power limit come first.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from diffse_tpu_torch.models.score_model import ScoreModel, ScoreModelConfig  # noqa: E402
from diffse_tpu_torch.profiling import device_breakdown, format_breakdown  # noqa: E402
from diffse_tpu_torch.utils import randn_like  # noqa: E402

STEPS = 30  # PC steps, two forwards each


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seconds", type=float, default=1.5, help="utterance length")
    parser.add_argument("--dtype", default="float32", choices=("float32", "bf16"),
                        help="the trunk's compute dtype")
    parser.add_argument("--table", default=None, help="write the profiler's full tables here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)

    dev = torch.device("cuda", 0)
    backbone = {"dtype": "bf16"} if args.dtype == "bf16" else {}
    model = ScoreModel(ScoreModelConfig(backbone="ncsnpp", sde="bbed", model_type="bbed",
                                        sigma_max=0.5),
                       backbone_kwargs=backbone,
                       sde_kwargs=dict(T_sampling=0.999, k=2.6, theta=0.52, N=STEPS),
                       device=dev, generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    y = (0.1 * rng.standard_normal((1, int(args.seconds * 16000)))).astype(np.float32)
    frames = 1 + y.shape[-1] // 128
    tables = [card]

    def run(mode, seed):
        gen = torch.Generator(dev).manual_seed(seed)
        if mode == "graphed":
            return model.enhance(y, y, generator=gen, N=STEPS)
        return model.enhance(y, y, noise=lambda like: randn_like(like, gen), N=STEPS)

    for mode in ("graphed", "eager"):
        t0 = time.perf_counter()
        run(mode, 0)  # warm-up (the graphed program is captured here)
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        run(mode, 0)
        wall_plain = time.perf_counter() - t0  # enhance returns host numpy: synchronised
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run(mode, 1)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        breakdown = device_breakdown(prof)
        total_us, launches = breakdown["total_us"], breakdown["launches"]
        if total_us == 0:
            print("the profiler recorded no device time: breakdown not measured", file=sys.stderr)
            return 1
        print(f"bbed_pc {mode}, {args.dtype} trunk, {args.seconds} s utterance ({frames} frames, "
              f"padded to a multiple of 64), {2 * STEPS} forwards: first call {first:.3f} s; "
              f"wall {wall_plain:.3f} s; profiled: wall {wall:.3f} s, device kernel time "
              f"{total_us / 1e6:.3f} s; device idle share {1 - total_us / 1e6 / wall_plain:.3f} "
              f"of the unprofiled wall ({1 - total_us / 1e6 / wall:.3f} of the profiled one); "
              f"{launches} device kernel launches "
              f"({launches / (2 * STEPS):.0f} per forward, sampler included)")
        print("\n".join(format_breakdown(breakdown, top=12)))
        tables.append(f"{mode}:\n" + prof.key_averages().table(
            sort_by="self_device_time_total", row_limit=60))
    if args.table:
        os.makedirs(os.path.dirname(os.path.abspath(args.table)), exist_ok=True)
        with open(args.table, "w") as f:
            f.write("\n".join(tables))
    return 0


if __name__ == "__main__":
    sys.exit(main())
