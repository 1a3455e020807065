"""Device time by kernel family from a ``torch.profiler`` run on the card.

The families: ``gn_silu_conv3x3`` by instantiation (``cuda_kernels``'
``CONV_CONFIGS``), its split-K reduce, the GroupNorm statistics pass, the
GroupNorm apply pass (K3), the fused bias + LeakyReLU, then the library's:
cuDNN and other convolutions, GEMMs, FFTs (STFT, iSTFT), random draws,
reductions, elementwise and copies. Kernels inside a replayed CUDA graph
are recorded like any other.
"""

from __future__ import annotations

import re
from collections import defaultdict

import torch

# (family, substrings of the kernel's name), tried in order after the port's
# own kernels
LIBRARY_FAMILIES = (
    ("cuDNN / other conv", ("conv", "fprop", "implicit", "winograd", "dgrad", "cudnn")),
    ("gemm", ("gemm", "cutlass", "matmul", "gemv")),
    ("fft (stft/istft)", ("fft",)),
    ("random draws", ("normal", "philox", "distribution")),
    ("reduce", ("reduce",)),
    ("elementwise / copy", ("elementwise", "vectorized", "copy", "fill", "cat", "index",
                            "unrolled", "memset", "memcpy", "pad", "flip", "unfold")),
)
_MMA_CONV = re.compile(r"gn_silu_conv3x3_kernel<[^,]*,\s*(\d+),\s*(\d+)")


def kernel_family(name: str) -> str:
    """The family of a device kernel, from its (demangled) name."""
    if "gn_silu_conv3x3_ws_kernel" in name:
        return "port: gn_silu_conv3x3 wgmma.ss"
    if "gn_silu_conv3x3_wgmma_kernel" in name:
        return "port: gn_silu_conv3x3 wgmma"
    match = _MMA_CONV.search(name)
    if match:
        return f"port: gn_silu_conv3x3 mma.sync {match[1]}x{match[2]}"
    for family, key in (("port: split-K reduce", "conv_split_reduce_kernel"),
                        ("port: GroupNorm statistics", "gn_stats_ab_kernel"),
                        ("port: GroupNorm apply", "gn_apply_kernel"),
                        ("port: fused bias + LeakyReLU", "bias_lrelu")):
        if key in name:
            return family
    low = name.lower()
    for family, keys in LIBRARY_FAMILIES:
        if any(k in low for k in keys):
            return family
    return "other"


def device_breakdown(prof) -> dict:
    """The device kernels a ``torch.profiler.profile`` run recorded:
    ``{"total_us", "launches", "families": {family: [us, launches]},
    "kernels": {name: us}}``. A kernel's own device time is its self device
    time; host-side ops carry none of their own, so the sum over all
    entries is the device's kernel time."""
    families = defaultdict(lambda: [0.0, 0])
    kernels = defaultdict(float)
    for avg in prof.key_averages():
        if avg.device_type == torch.autograd.DeviceType.CUDA and avg.self_device_time_total > 0:
            kernels[avg.key] += avg.self_device_time_total
            fam = families[kernel_family(avg.key)]
            fam[0] += avg.self_device_time_total
            fam[1] += avg.count
    return {"total_us": sum(kernels.values()), "launches": sum(n for _, n in families.values()),
            "families": dict(families), "kernels": dict(kernels)}


def format_breakdown(breakdown: dict, top: int = 0) -> list:
    """Lines of text: each family's ms, share and launches, largest first,
    then the ``top`` kernels by device time."""
    total = breakdown["total_us"] or 1.0
    lines = [f"  {fam:36s} {us / 1e3:10.2f} ms {us / total:7.1%} {n:8d} launches"
             for fam, (us, n) in sorted(breakdown["families"].items(), key=lambda kv: -kv[1][0])]
    for name, us in sorted(breakdown["kernels"].items(), key=lambda kv: -kv[1])[:top]:
        lines.append(f"  {us / 1e3:10.2f} ms  {name[:110]}")
    return lines
