#!/usr/bin/env python3
"""Time ``gn_silu_conv3x3`` under ``conv_plan``'s plan and its alternatives, on one GPU.

    python3 tools/conv_plan_sweep.py [--frames 64 128 192] [--batch 1] [--dtype float32]
                                     [--out PATH] [--stats]
    python3 tools/conv_plan_sweep.py --summary PATH

For every conv shape of one 65M NCSN++ forward (F=256; the shapes and calls
per forward of ``diffse_tpu_torch/ops/main_path_shapes.py``) at the given
widths, ``--batch`` utterances and activations of ``--dtype`` (float32, or
bf16 for the bf16 trunk; bench.py's program is ``--frames 64 --batch 16
--dtype bf16``), times queued (``utils.queued_ms``) the plan ``conv_plan``
picks and, for every instantiation that can run the shape,
``make_conv_plan``'s plans with one K split and aiming at one and two blocks
per SM; for bf16's packed-weight ``wgmma.ss`` kernel (given its weight
packed once, as the model keeps it) every tile width it tries, each at its
tallest tile and at about half that height, with those K splits. Each plan is held to the plain version first (float32: 2e-4; bf16:
one bf16 ulp of the largest output). Prints per shape the picked plan's time
and the fastest's, then the summary: per width, the conv's time per forward
under the picked plans and under the fastest, and, per instantiation, the
time per forward lost if the shapes it is fastest at took the fastest of the
others. ``--out`` writes one JSON line per timed plan (shape, plan, ms); the
summary can be printed again from such a file with ``--summary``.

``--stats`` times the GroupNorm statistics pass at [B,256,64,128] and at half
its positions, [B,256,32,128], in 16 to 128 parts: per part count, what
does not scale with the bytes read (launch, tail, the last block's fold of
the partials) is twice the half map's time less the full map's.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
from collections import defaultdict

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from diffse_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from diffse_tpu_torch.ops.main_path_shapes import CONV_SHAPES_T64, at_frames  # noqa: E402
from diffse_tpu_torch.utils import queued_ms  # noqa: E402

STATS_SHAPES = [(256, 64, 128), (256, 32, 128)]
STATS_PARTS = (16, 32, 64, 128)
DTYPES = {"float32": torch.float32, "bf16": torch.bfloat16}


def agree(out, ref) -> bool:
    """float32: the JAX tests' tolerance; bf16: one bf16 ulp of the largest
    output (8 significant bits)."""
    if out.dtype == torch.float32:
        return torch.allclose(out, ref, atol=2e-4, rtol=2e-4)
    return bool((out.float() - ref.float()).abs().max() <= 2.0 ** -7 * ref.float().abs().max())


def configs_for(h: int, w: int, cout: int, dtype=torch.float32):
    """The instantiations that can run an ``h x w`` map to ``cout``."""
    if cout <= 8:
        return [ck.CONV_MMA_HEAD]
    if ck.conv_taps(h, w) == 9:
        ws = dtype == torch.bfloat16 and w >= 8 and cout % 8 == 0 and ck._ws_tiles(1, h, w, cout)
        return [ck.CONV_MMA, ck.CONV_WGMMA] + ([ck.CONV_WGMMA_SS] if ws else [])
    return [ck.CONV_MMA]


def ws_plans(b, h, w, cin, cout):
    """The wgmma.ss kernel's plans at each tile width it tries: the tallest
    tile and one of about half its height, each with one K split and aiming
    at one and two blocks per SM."""
    plans = set()
    for th, tw, _ in ck._ws_tiles(b, h, w, cout):
        for rows in {th, max(1, th // 2)}:
            rows = -(-h // -(-h // rows))
            for fill in (0, 1, 2):
                plans.add(ck.make_conv_plan(b, h, w, cin, cout, ck.CONV_WGMMA_SS, fill,
                                            torch.bfloat16, tile=(rows, tw)))
    return plans


def describe(plan: dict) -> str:
    return (f"cfg {plan['config']} {plan['th']}x{plan['tw']} split {plan['splits']}, "
            f"{np.prod(plan['grid'])} CTAs")


def summarize(lines) -> None:
    """The summary of timed plans (the ``--out`` lines) at each width."""
    shapes = defaultdict(list)
    for line in lines:
        shapes[tuple(line["shape"])].append(line)
    by_frames = defaultdict(dict)
    for (b, h, w, cin, cout), timed in shapes.items():
        frames = 256 * w // h  # W = H * frames / 256 on every level
        calls = {s[:4]: s[4] for s in at_frames(frames, CONV_SHAPES_T64)}[(h, w, cin, cout)]
        by_frames[frames][(b, h, w, cin, cout)] = (calls, timed)
    for frames, shapes_t in sorted(by_frames.items()):
        picked = best = 0.0
        ratios = []
        lost = defaultdict(float)
        for shape, (calls, timed) in shapes_t.items():
            fastest = min(timed, key=lambda t: t["ms"])
            pick = next((t for t in timed if t["picked"]), None)
            for t in timed:
                lost[t["plan"]["config"]] += 0.0
            best += calls * fastest["ms"]
            if pick is not None:
                picked += calls * pick["ms"]
                ratios.append((round(pick["ms"] / fastest["ms"], 3), shape[1:]))
            others = [t["ms"] for t in timed if t["plan"]["config"] != fastest["plan"]["config"]]
            if others:
                lost[fastest["plan"]["config"]] += calls * (min(others) - fastest["ms"])
            else:
                lost[fastest["plan"]["config"]] = float("inf")
        ratios.sort(reverse=True)
        print(f"T={frames}: conv per forward {picked:.4f} ms under the picked plans, "
              f"{best:.4f} ms under the fastest ({picked / best:.3f}x); picked / fastest, "
              f"worst five: {ratios[:5]}")
        for cfg, ms in sorted(lost.items()):
            print(f"  T={frames}: without cfg {cfg} the forward loses {ms:.4f} ms "
                  f"({ms / best:.2%})")


def sweep_conv(frames_list, dev, batch=1, dtype=torch.float32):
    rng = np.random.default_rng(0)
    picked_plan = ck.conv_plan
    lines = []
    for frames in frames_list:
        for h, w, cin, cout, _ in at_frames(frames, CONV_SHAPES_T64):
            x = torch.from_numpy(rng.standard_normal((batch, h, w, cin), dtype=np.float32)).to(
                dev, dtype)
            gs = torch.ones(cin, device=dev)
            gb = torch.zeros(cin, device=dev)
            wk = torch.from_numpy(0.05 * rng.standard_normal((3, 3, cin, cout),
                                                             dtype=np.float32)).to(dev)
            bt = torch.zeros((batch, cout), device=dev)
            ref = ck.groupnorm_silu_conv3x3_reference(x, gs, gb, wk, bt, 32)
            pick = picked_plan(batch, h, w, cin, cout, dtype)
            configs = configs_for(h, w, cout, dtype)
            plans = {pick} | {ck.make_conv_plan(batch, h, w, cin, cout, cfg, fill, dtype)
                              for cfg in configs if cfg != ck.CONV_WGMMA_SS for fill in (0, 1, 2)}
            if ck.CONV_WGMMA_SS in configs:
                plans |= ws_plans(batch, h, w, cin, cout)
            packed = ck.pack_conv_weight_bf16(wk) if dtype == torch.bfloat16 else None
            timed = []
            for plan in plans:
                ck.conv_plan = lambda *a, _p=plan: _p
                try:
                    out = ck.groupnorm_silu_conv3x3(x, gs, gb, wk, bt, 32, w_packed=packed)
                    if not agree(out, ref):
                        raise AssertionError(f"{(h, w, cin, cout)} plan {plan} disagrees")
                    ms = queued_ms(lambda: ck.groupnorm_silu_conv3x3(x, gs, gb, wk, bt, 32,
                                                                     w_packed=packed))
                finally:
                    ck.conv_plan = picked_plan
                timed.append({"shape": [batch, h, w, cin, cout], "dtype": str(dtype),
                              "plan": dataclasses.asdict(plan), "ms": ms, "picked": plan == pick})
            fastest = min(timed, key=lambda t: t["ms"])
            mine = next(t for t in timed if t["picked"])
            print(f"[{batch},{h},{w},{cin}]->{cout} {str(dtype).split('.')[-1]}: picked "
                  f"{mine['ms']:.4f} ms "
                  f"({describe(mine['plan'])}); fastest {fastest['ms']:.4f} ms "
                  f"({describe(fastest['plan'])}) of {len(timed)}")
            lines += timed
    return lines


def sweep_stats(dev, batch=1, dtype=torch.float32) -> None:
    rng = np.random.default_rng(1)
    planned = ck.stats_plan
    times = {}
    shapes = [(batch, *s) for s in STATS_SHAPES]
    for shape in shapes:
        b, h, w, c = shape
        x = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev, dtype)
        sc, bi = torch.ones(c, device=dev), torch.zeros(c, device=dev)
        ref = ck.gn_stats_ab_reference(x, sc, bi, 32, 1e-6)
        for parts in STATS_PARTS:
            ck.stats_plan = lambda *a, _p=parts, _n=h * w: (_p, -(-_n // _p))
            try:
                out = ck.gn_stats_ab(x, sc, bi, 32)
                if not all(torch.allclose(o, r, atol=2e-4, rtol=2e-4) for o, r in zip(out, ref)):
                    raise AssertionError(f"statistics {shape} in {parts} parts disagree")
                times[(shape, parts)] = queued_ms(lambda: ck.gn_stats_ab(x, sc, bi, 32))
            finally:
                ck.stats_plan = planned
    full, half = shapes
    print(f"statistics pass ({str(dtype).split('.')[-1]}), queued ms; the plan at {list(full)}: "
          f"{planned(batch, full[1] * full[2], full[3])[0]} parts")
    for parts in STATS_PARTS:
        t_full, t_half = times[(full, parts)], times[(half, parts)]
        fixed = 2 * t_half - t_full
        print(f"  {parts} parts: {list(full)} {t_full:.4f}, {list(half)} {t_half:.4f}; "
              f"not scaling with bytes {fixed:.4f}, reading {list(full)} {t_full - fixed:.4f}")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--frames", type=int, nargs="+", default=[64, 128, 192])
    parser.add_argument("--batch", type=int, default=1)
    parser.add_argument("--dtype", choices=sorted(DTYPES), default="float32")
    parser.add_argument("--out", default=None)
    parser.add_argument("--stats", action="store_true")
    parser.add_argument("--summary", default=None, metavar="PATH")
    args = parser.parse_args()
    if args.summary:
        with open(args.summary) as f:
            summarize([json.loads(line) for line in f])
        return 0
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    dtype = DTYPES[args.dtype]
    lines = sweep_conv(args.frames, dev, args.batch, dtype)
    summarize(lines)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
    if args.stats:
        sweep_stats(dev, args.batch, dtype)
    return 0


if __name__ == "__main__":
    sys.exit(main())
