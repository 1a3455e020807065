#!/usr/bin/env python3
"""Where one block of the wgmma conv kernel spends its cycles, per K chunk.

    python3 tools/trace_conv_phases.py [--shape 1 256 64 128 128]

Builds ``diffse_tpu_torch/csrc`` with ``-DDIFFSE_CONV_TRACE`` under
``build/trace/`` (the kernel library itself is not touched): block (0, 0, 0)
of ``gn_silu_conv3x3_wgmma_kernel`` then records ``clock64()`` at each phase
of its chunk loop (the source's ``CONV_TRACE`` hooks), for threads 0 and 128
(one per warpgroup). Runs ``groupnorm_silu_conv3x3`` at the shape (three
warm-up calls, then one traced) and prints per warpgroup the median cycles
per chunk and per phase:

  wait_cp     waiting for chunk i's cp.async copies
  sync_stage  the block barrier, then issuing chunk i + 1's copies
  activate    the prologue: x*a+b, SiLU, padding and split of chunk i
  sync        the block barrier before the tensor cores read the tile
  taps        the nine taps' A fragments and wgmmas (a warp stalls on
              issuing wgmma while the tensor cores' queue is full)
  wait        waiting for the tensor cores

Needs nvcc and one GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from diffse_tpu_torch.ops import cuda_kernels as ck  # noqa: E402

PHASES = ("wait_cp", "sync_stage", "activate", "sync", "taps", "wait")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--shape", type=int, nargs=5, default=[1, 256, 64, 128, 128],
                        metavar=("B", "H", "W", "CIN", "COUT"))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    out = ck.BUILD_DIR.parent / "trace"
    out.mkdir(parents=True, exist_ok=True)
    lib_path = out / "libtrace.so"
    subprocess.run([ck._nvcc(), *ck.NVCC_FLAGS, "-DDIFFSE_CONV_TRACE", "-shared", "-o",
                    str(lib_path), *map(str, ck._sources())], check=True)
    lib = ck.bind(ctypes.CDLL(str(lib_path)))
    lib.diffse_conv_trace_fetch.argtypes = [ctypes.c_void_p]
    lib.diffse_conv_trace_fetch.restype = ctypes.c_int
    ck._library = lambda: lib

    b, h, w, cin, cout = args.shape
    plan = ck.conv_plan(b, h, w, cin, cout)
    if ck.CONV_CONFIGS[plan.config][3] != "wgmma":
        print(f"{args.shape}: the plan takes mma.sync; nothing to trace", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    x = torch.randn(b, h, w, cin, device=dev)
    wk = 0.05 * torch.randn(3, 3, cin, cout, device=dev)
    gs, gb = torch.ones(cin, device=dev), torch.zeros(cin, device=dev)
    bt = torch.zeros(b, cout, device=dev)
    for _ in range(4):
        ck.groupnorm_silu_conv3x3(x, gs, gb, wk, bt, 32)
    torch.cuda.synchronize()
    buf = np.zeros((2, 64, 8), dtype=np.int64)
    if lib.diffse_conv_trace_fetch(buf.ctypes.data) != 0:
        raise RuntimeError("could not read the trace")
    chunks = min(64, -(-plan.units_per_split // 9))
    print(f"{args.shape}: plan {plan}")
    for wg in range(2):
        t = buf[wg, :chunks, :7]
        per_chunk = np.median(np.diff(t[:, 0]))
        phases = np.median(np.diff(t, axis=1), axis=0)
        print(f"warpgroup {wg}: {per_chunk:.0f} cycles per chunk; "
              + ", ".join(f"{n} {v:.0f}" for n, v in zip(PHASES, phases)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
