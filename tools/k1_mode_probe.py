"""K1's float32-x / bf16-products mode on the card against its plain version.

Builds the kernels from ``diffse_tpu_torch/csrc``, then runs
``groupnorm_silu_conv3x3(x, ..., compute_dtype=torch.bfloat16)`` on float32
x at the output_skip heads' shapes (one utterance's levels at 64 frames,
bench.py's batch of 16) and at a few wider ones (``wgmma`` plans), each with
its own statistics and with a given affine (``ab=``, a frames shard's), and
holds each to ``groupnorm_silu_conv3x3_reference`` within chip_smoke's
``KERNEL_TOL``; then the float32 and bf16 modes at one shape each. Prints
the card, each call's plan and error, and exits 1 if any call disagrees or
was not counted in ``mixed_launch_counts``.

    python3 tools/k1_mode_probe.py
"""

import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from diffse_tpu_torch.ops import cuda_kernels as ck  # noqa: E402

TOL = dict(atol=2e-4, rtol=2e-4)  # chip_smoke.KERNEL_TOL
BF16_SHARE = 1e-3                 # chip_smoke.BF16_SHARE
# (x shape, Cout, with a residual)
CASES = [((1, 256, 64, 128), 4, True), ((1, 128, 32, 128), 4, False),
         ((1, 64, 16, 256), 4, False), ((1, 32, 8, 256), 4, False),
         ((1, 16, 4, 256), 4, False), ((1, 8, 2, 256), 4, False), ((1, 4, 1, 256), 4, False),
         ((16, 256, 64, 128), 4, False), ((2, 16, 8, 128), 4, True),
         ((1, 64, 32, 256), 256, True), ((1, 16, 4, 256), 256, False),
         ((16, 256, 64, 128), 128, True)]
OLD_MODE_CASES = [((1, 256, 64, 128), 4), ((1, 64, 32, 256), 256), ((16, 256, 64, 128), 128),
                  ((1, 16, 4, 256), 256)]


def main() -> int:
    if not torch.cuda.is_available():
        print("k1_mode_probe: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    t0 = time.time()
    ck.build_library()
    print(f"build {time.time() - t0:.1f} s", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev, dtype)

    def inputs(shape, cout, dtype=torch.float32):
        c = shape[-1]
        return (t(2 * rng.standard_normal(shape) + 0.5, dtype),
                t(1 + 0.1 * rng.standard_normal(c)), t(0.1 * rng.standard_normal(c)),
                t(rng.standard_normal((3, 3, c, cout)) / np.sqrt(9 * c)),
                t(0.1 * rng.standard_normal((shape[0], cout))), min(c // 4, 32))

    bad = []
    for shape, cout, skip in CASES:
        x, gs, gb, w, bias, groups = inputs(shape, cout)
        kw = dict(compute_dtype=torch.bfloat16)
        if skip:
            kw.update(skip=t(rng.standard_normal((*shape[:3], cout))), skip_coef=0.7071)
        plan = ck.conv_plan(*shape, cout, torch.bfloat16, torch.float32)
        for ab in (None, ck.gn_stats_ab(x, gs, gb, groups)):
            ck.reset_launch_counts()
            out = ck.groupnorm_silu_conv3x3(x, gs, gb, w, bias, groups, ab=ab, **kw)
            ref = ck.groupnorm_silu_conv3x3_reference(x, gs, gb, w, bias, groups, ab=ab, **kw)
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            ok = (out.dtype == torch.float32 and torch.allclose(out, ref, **TOL)
                  and ck.mixed_launch_counts["gn_silu_conv3x3"] == 1)
            print(f"{list(shape)}->{cout} skip={skip} ab={ab is not None}: plan "
                  f"{ck.CONV_CONFIGS[plan.config][3]}, {plan.splits} K splits; max_abs_err "
                  f"{err:.3e} ok {ok}", flush=True)
            if not ok:
                bad.append((shape, cout, skip, ab is not None))
    for dtype in (torch.float32, torch.bfloat16):
        for shape, cout in OLD_MODE_CASES:
            x, gs, gb, w, bias, groups = inputs(shape, cout, dtype)
            out = ck.groupnorm_silu_conv3x3(x, gs, gb, w, bias, groups)
            ref = ck.groupnorm_silu_conv3x3_reference(x, gs, gb, w, bias, groups)
            torch.cuda.synchronize()
            diff = (out.float() - ref.float()).abs()
            ulp = torch.exp2(torch.floor(torch.log2(ref.float().abs().clamp_min(1e-30))) - 7)
            ok = (torch.allclose(out, ref, **TOL) if dtype == torch.float32
                  else float((diff > ulp).float().mean()) <= BF16_SHARE)
            print(f"{str(dtype)[6:]} mode {list(shape)}->{cout}: max_abs_err "
                  f"{diff.max().item():.3e} ok {ok}", flush=True)
            if not ok:
                bad.append((dtype, shape, cout))
    print("disagreeing", bad)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
