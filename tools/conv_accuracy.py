#!/usr/bin/env python3
"""The float32 ``gn_silu_conv3x3`` kernel's error against a float64 truth,
by the length of the K range one block sums on the tensor cores.

    python3 tools/conv_accuracy.py [--timing]

For each shape (the training level 0 with its residual, a mid level with
K = 9 x 512, a deep square level and a head, batch 4): the same
GroupNorm -> SiLU -> conv3x3 in float64 on the card (the GroupNorm affine
``a, b`` from ``gn_stats_ab_reference``, as the kernel's), then the max and
mean absolute error and the mean signed error, each over max|truth|, of
cuDNN's float32 conv (the plain version, TF32 off), PyTorch's own float32
conv (cuDNN off), and the kernel under the plan rule (``conv_plan``: K split
into ranges of at most ``CONV_F32_MAX_UNITS`` units), with one range per
block where the tiles fill the card (``max_units`` unset) and with ranges
of 16 units. With ``--timing`` also each kernel plan's queued time.
Needs one CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from diffse_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from diffse_tpu_torch.utils import queued_ms  # noqa: E402

SHAPES = [(4, 256, 256, 128, 128, True), (4, 64, 64, 512, 256, False),
          (4, 8, 8, 512, 256, False), (4, 256, 256, 128, 4, False)]


def truth(x, gs, gb, w, bt, groups, skip, coef):
    a, b = ck.gn_stats_ab_reference(x, gs, gb, groups, 1e-6)
    v = x.double() * a.double()[:, None, None, :] + b.double()[:, None, None, :]
    act = (v * torch.sigmoid(v)).permute(0, 3, 1, 2)
    out = F.conv2d(act, w.double().permute(3, 2, 0, 1), padding=1).permute(0, 2, 3, 1)
    out = out + bt.double()[:, None, None, :]
    if skip is not None:
        out = (skip.double() + out) * coef
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--timing", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("conv_accuracy: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    ck.build_library()
    rng = np.random.default_rng(0)
    rule = ck.conv_plan
    for b, h, w, cin, cout, skip in SHAPES:
        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev)

        x = t(rng.standard_normal((b, h, w, cin)))
        gs, gb = t(1 + 0.1 * rng.standard_normal(cin)), t(0.1 * rng.standard_normal(cin))
        wk = t(rng.standard_normal((3, 3, cin, cout)) / np.sqrt(9 * cin))
        bt = t(0.1 * rng.standard_normal((b, cout)))
        sk = t(rng.standard_normal((b, h, w, cout))) if skip else None
        groups, coef = min(cin // 4, 32), (1 / np.sqrt(2.0) if skip else 1.0)
        ref = truth(x, gs, gb, wk, bt, groups, sk, coef)
        scale = ref.abs().max().item()

        def err(out):
            d = out.double() - ref
            return (f"max {d.abs().max().item() / scale:.2e} "
                    f"mean {d.abs().mean().item() / scale:.2e} "
                    f"signed {d.mean().item() / scale:+.2e}")

        call = (x, gs, gb, wk, bt, groups, 1e-6, sk, coef)
        rows = [f"cuDNN float32 (plain version): {err(ck.groupnorm_silu_conv3x3_reference(*call))}"]
        with torch.backends.cudnn.flags(enabled=False):
            rows.append(f"PyTorch float32, cuDNN off: "
                        f"{err(ck.groupnorm_silu_conv3x3_reference(*call))}")
        config = ck.conv_config(b, h, w, cin, cout)
        for label, plan in (
                ("the plan rule", rule(b, h, w, cin, cout)),
                ("one range where the tiles fill the card",
                 ck.make_conv_plan(b, h, w, cin, cout, config)),
                ("ranges of 16 units",
                 ck.make_conv_plan(b, h, w, cin, cout, config, max_units=16))):
            ck.conv_plan = lambda *a, plan=plan, **kw: plan
            try:
                out = ck.groupnorm_silu_conv3x3(*call)
                timing = (f", {queued_ms(lambda: ck.groupnorm_silu_conv3x3(*call)):.4f} ms queued"
                          if args.timing else "")
            finally:
                ck.conv_plan = rule
            rows.append(f"kernel, {label} ({ck.CONV_CONFIGS[plan.config][3]}, "
                        f"{plan.splits} x {plan.units_per_split} of {plan.units} units{timing}): "
                        f"{err(out)}")
        torch.cuda.synchronize()
        print(f"[{b},{h},{w},{cin}]->{cout}{' +skip' if skip else ''}:\n  " + "\n  ".join(rows),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
