#!/usr/bin/env python3
"""Where ``gn_silu_conv3x3``'s time goes in one 65M NCSN++ forward, by level.

    python3 tools/conv_level_times.py [--frames 192] [--batch 1] [--dtype float32] [--repo DIR]

Runs one forward of the 65M NCSN++ (F=256, ``--frames`` wide, ``--batch``
utterances, seeded weights; ``--dtype bf16`` for the bf16 trunk, bench.py's
program is ``--frames 64 --batch 16 --dtype bf16``) on the card, records
every ``gn_silu_conv3x3`` call's shape and dtype, then times each
distinct call queued (50 calls back to back behind a device sleep, fresh
inputs of that shape; in bf16 with the weight packed once, as the model's
blocks keep it, where the checkout has ``pack_conv_weight_bf16``) and
prints, per level (map height), the calls, the kernel's device time per
forward and the plain version's, and the total.
``--repo`` imports the timed ``diffse_tpu_torch`` from another checkout (for
instance the parent commit unpacked under ``build/``, which ``.gitignore``
lists), so that two versions of the kernel can be timed on one card in one
call; the timing itself is this checkout's.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
from collections import Counter, defaultdict

import numpy as np
import torch


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--frames", type=int, default=192)
    parser.add_argument("--batch", type=int, default=1)
    parser.add_argument("--dtype", choices=("float32", "bf16"), default="float32")
    parser.add_argument("--repo", default=ROOT)
    args = parser.parse_args()
    sys.path.insert(0, ROOT)
    from diffse_tpu_torch.utils import queued_ms

    # import the timed package afresh, from --repo
    for name in [m for m in sys.modules if m.split(".")[0] == "diffse_tpu_torch"]:
        del sys.modules[name]
    sys.path.insert(0, os.path.abspath(args.repo))
    from diffse_tpu_torch.models import layers, ncsnpp
    from diffse_tpu_torch.ops import cuda_kernels as ck

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(f"diffse_tpu_torch from {os.path.dirname(os.path.dirname(ck.__file__))}")
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    calls = Counter()
    kernel = ck.groupnorm_silu_conv3x3

    def recording(x, gn_scale, gn_bias, w, bias_total, num_groups, eps=1e-6, skip=None,
                  skip_coef=1.0, **packed):
        calls[(*x.shape, w.shape[-1], skip is not None)] += 1
        return kernel(x, gn_scale, gn_bias, w, bias_total, num_groups, eps, skip, skip_coef,
                      **packed)

    layers.groupnorm_silu_conv3x3 = ncsnpp.groupnorm_silu_conv3x3 = recording
    trunk = {} if args.dtype == "float32" else {"dtype": args.dtype}  # a parent takes no dtype
    model = ncsnpp.NCSNpp(generator=torch.Generator().manual_seed(0), **trunk).to(dev).eval()
    dtype = torch.float32 if args.dtype == "float32" else torch.bfloat16
    x = torch.randn((args.batch, 2, 256, args.frames), dtype=torch.complex64, device=dev)
    with torch.no_grad():
        model(x, torch.full((args.batch,), 0.5, device=dev))
    torch.cuda.synchronize()
    print(f"B={args.batch} T={args.frames} {args.dtype}: {sum(calls.values())} gn_silu_conv3x3 "
          f"calls, {len(calls)} distinct shapes")

    rng = np.random.default_rng(0)
    levels = defaultdict(lambda: [0, 0.0, 0.0])
    for (b, h, w, cin, cout, with_skip), n in sorted(calls.items()):
        def t(*shape, scale=1.0):
            return torch.from_numpy(scale * rng.standard_normal(shape, dtype=np.float32)).to(dev)
        xs, gs, gb = t(b, h, w, cin).to(dtype), 1 + t(cin, scale=0.1), t(cin, scale=0.1)
        wk, bt = t(3, 3, cin, cout, scale=0.05), t(b, cout, scale=0.1)
        skip = t(b, h, w, cout).to(dtype) if with_skip else None
        kw = dict(skip=skip, skip_coef=0.5)
        packed = ({"w_packed": ck.pack_conv_weight_bf16(wk)}
                  if dtype == torch.bfloat16 and hasattr(ck, "pack_conv_weight_bf16") else {})
        ms = queued_ms(lambda: kernel(xs, gs, gb, wk, bt, 32, **kw, **packed))
        plain = queued_ms(lambda: ck.groupnorm_silu_conv3x3_reference(xs, gs, gb, wk, bt, 32, **kw))
        print(f"  [{b},{h},{w},{cin}]->{cout}{' +skip' if with_skip else ''} x{n}: "
              f"{ms:.4f} ms queued (plain {plain:.4f})")
        lv = levels[(h, w)]
        lv[0] += n
        lv[1] += n * ms
        lv[2] += n * plain
    total = sum(v[1] for v in levels.values())
    total_plain = sum(v[2] for v in levels.values())
    for (h, w), (n, ms, plain) in sorted(levels.items(), reverse=True):
        print(f"level {h}x{w}: {n} calls, kernel {ms:.3f} ms ({ms / total:.1%}), "
              f"plain {plain:.3f} ms")
    print(f"total per forward: kernel {total:.3f} ms, plain {total_plain:.3f} ms (queued sums)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
