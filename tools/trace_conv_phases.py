#!/usr/bin/env python3
"""Where one block of a wgmma conv kernel spends its cycles, per K chunk.

    python3 tools/trace_conv_phases.py [--shape 1 256 64 128 128] [--dtype float32|bf16]
                                       [--config N]

Builds ``diffse_tpu_torch/csrc`` with ``-DDIFFSE_CONV_TRACE`` under
``build/trace/`` (the kernel library itself is not touched): block (0, 0, 0)
of ``gn_silu_conv3x3_wgmma_kernel`` or of ``gn_silu_conv3x3_ws_kernel`` (the
bf16 packed-weight kernel) then records ``clock64()`` at each phase of its
chunk loop (the source's ``CONV_TRACE`` hooks), for threads 0 and 128 (one
per warpgroup) and, in the ws kernel, 256 (the producer warpgroup). Runs
``groupnorm_silu_conv3x3`` at the shape in ``--dtype`` under ``conv_plan``'s
plan, or under ``make_conv_plan``'s for instantiation ``--config``
(``CONV_CONFIGS``' id; 2 is the wgmma kernel, 3 the ws kernel), three
warm-up calls, then one traced, and prints per warpgroup the median cycles
per chunk and per phase. The wgmma kernel:

  wait_cp     waiting for chunk i's cp.async copies
  sync_stage  the block barrier, then issuing chunk i + 1's copies
  activate    the prologue: x*a+b, SiLU, padding and split (or bf16 rounding)
  sync        the block barrier before the tensor cores read the tile
  taps        the nine taps' A fragments and wgmmas (a warp stalls on
              issuing wgmma while the tensor cores' queue is full)
  wait        waiting for the tensor cores

The ws kernel's consumer warpgroups:

  wait_tile   waiting for chunk i's activated tile
  issue       issuing the nine taps' wgmmas (a warp stalls while the tensor
              cores' queue is full)
  wait        waiting for chunk i - 1's wgmmas, then freeing its stage and tile
  activate    their share of chunk i + 1's prologue (two thirds), after
              waiting for its copies and a free tile

and its producer warpgroup (row 2):

  wait_copies waiting for chunk i's copies to land
  wait_tile   waiting for the consumers to free activated tile i % 3
  activate    its share of chunk i's prologue (a third)
  copies      waiting for a free stage, then issuing chunk i + 2's copies

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
WS_PHASES = ("wait_tile", "issue", "wait", "activate")
WS_PRODUCER_PHASES = ("wait_copies", "wait_tile", "activate", "copies")
DTYPES = {"float32": torch.float32, "bf16": torch.bfloat16}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--shape", type=int, nargs=5, default=[1, 256, 64, 128, 128],
                        metavar=("B", "H", "W", "CIN", "COUT"))
    parser.add_argument("--dtype", choices=sorted(DTYPES), default="float32")
    parser.add_argument("--config", type=int, default=None)
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
    dtype = DTYPES[args.dtype]
    plan = (ck.conv_plan(b, h, w, cin, cout, dtype) if args.config is None else
            ck.make_conv_plan(b, h, w, cin, cout, args.config, dtype=dtype))
    instruction = ck.CONV_CONFIGS[plan.config][3]
    if not instruction.startswith("wgmma"):
        print(f"{args.shape}: the plan takes {instruction}; nothing to trace", file=sys.stderr)
        return 1
    planned = ck.conv_plan
    ck.conv_plan = lambda *a: plan
    dev = torch.device("cuda", 0)
    x = torch.randn(b, h, w, cin, device=dev).to(dtype)
    wk = 0.05 * torch.randn(3, 3, cin, cout, device=dev)
    gs, gb = torch.ones(cin, device=dev), torch.zeros(cin, device=dev)
    bt = torch.zeros(b, cout, device=dev)
    packed = ck.pack_conv_weight_bf16(wk) if dtype == torch.bfloat16 else None
    for _ in range(4):
        ck.groupnorm_silu_conv3x3(x, gs, gb, wk, bt, 32, w_packed=packed)
    torch.cuda.synchronize()
    ck.conv_plan = planned
    buf = np.zeros((3, 64, 8), dtype=np.int64)
    if lib.diffse_conv_trace_fetch(buf.ctypes.data) != 0:
        raise RuntimeError("could not read the trace")
    chunks = min(64, -(-plan.units_per_split // ck.conv_taps(h, w)))
    print(f"{args.shape} {args.dtype}: plan {plan}")
    if instruction == "wgmma":
        for wg in range(2):
            t = buf[wg, :chunks, :7]
            per_chunk = np.median(np.diff(t[:, 0]))
            phases = np.median(np.diff(t, axis=1), axis=0)
            print(f"warpgroup {wg}: {per_chunk:.0f} cycles per chunk; "
                  + ", ".join(f"{n} {v:.0f}" for n, v in zip(PHASES, phases)))
        return 0
    for wg in range(2):
        t = buf[wg, :chunks, :5]
        per_chunk = np.median(np.diff(t[:, 0]))
        phases = np.median(np.diff(t, axis=1), axis=0)
        print(f"warpgroup {wg}: {per_chunk:.0f} cycles per chunk; "
              + ", ".join(f"{n} {v:.0f}" for n, v in zip(WS_PHASES, phases)))
    t = buf[2, :chunks, :5]
    phases = np.median(np.diff(t, axis=1), axis=0)
    print(f"producer warpgroup: {np.median(np.diff(t[:, 0])):.0f} cycles per chunk; "
          + ", ".join(f"{n} {v:.0f}" for n, v in zip(WS_PRODUCER_PHASES, phases)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
