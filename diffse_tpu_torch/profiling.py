"""Device time by kernel family from a ``torch.profiler`` run on the card.

The families: ``gn_silu_conv3x3`` by instantiation (``cuda_kernels``'
``CONV_CONFIGS``), its split-K reduce, the GroupNorm statistics pass, the
GroupNorm apply pass (K3), the fused bias + LeakyReLU, then the library's:
the FIR resampling's grouped convolution, convolutions' backward (dgrad,
wgrad), other cuDNN convolutions, the optimizer's and the EMA's multi-tensor
kernels, GEMMs, FFTs (STFT, iSTFT), random draws, reductions, elementwise
and copies. Kernels inside a replayed CUDA graph
are recorded like any other.
"""

from __future__ import annotations

import re
from collections import defaultdict

import torch

# (family, substrings of the kernel's name), tried in order after the port's
# own kernels
LIBRARY_FAMILIES = (
    ("FIR (cuDNN grouped conv)", ("grouped_direct", "depthwise")),
    ("cuDNN dgrad / wgrad", ("dgrad", "wgrad")),
    ("cuDNN / other conv", ("conv", "fprop", "implicit", "winograd", "cudnn")),
    ("Adam / EMA (multi-tensor)", ("multi_tensor_apply",)),
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
    ``{"total_us", "busy_us", "launches", "families": {family: [us,
    launches]}, "kernels": {name: us}}``. Each device event counts once with
    its own duration; the ranges that ``record_function`` marks on the device
    timeline (user annotations) are not kernels and are left out, so the
    total is the device's kernel time. ``busy_us`` is the time at least one
    kernel ran (the union of their intervals): below the total where
    kernels overlap, as cuDNN's on its own streams do."""
    families = defaultdict(lambda: [0.0, 0])
    kernels = defaultdict(float)
    intervals = []
    for event in prof.events():
        if (event.device_type != torch.autograd.DeviceType.CUDA
                or getattr(event, "is_user_annotation", False)):
            continue
        us = event.self_device_time_total
        kernels[event.name] += us
        fam = families[kernel_family(event.name)]
        fam[0] += us
        fam[1] += 1
        intervals.append((event.time_range.start, event.time_range.end))
    busy, reach = 0.0, None
    for start, end in sorted(intervals):
        if reach is None or start > reach:
            busy += end - start
            reach = end
        elif end > reach:
            busy += end - reach
            reach = end
    return {"total_us": sum(kernels.values()), "busy_us": busy,
            "launches": sum(n for _, n in families.values()), "families": dict(families),
            "kernels": dict(kernels)}


def format_breakdown(breakdown: dict, top: int = 0) -> list:
    """Lines of text: each family's ms, share and launches, largest first,
    then the ``top`` kernels by device time."""
    total = breakdown["total_us"] or 1.0
    lines = [f"  {fam:36s} {us / 1e3:10.2f} ms {us / total:7.1%} {n:8d} launches"
             for fam, (us, n) in sorted(breakdown["families"].items(), key=lambda kv: -kv[1][0])]
    for name, us in sorted(breakdown["kernels"].items(), key=lambda kv: -kv[1])[:top]:
        lines.append(f"  {us / 1e3:10.2f} ms  {name[:110]}")
    return lines


def labelled_device_us(prof, labels) -> dict:
    """The device time of the kernels launched inside each of ``labels``
    (``torch.profiler.record_function`` ranges, e.g. the train step's parts
    and the ops' recomputes), summed over the range's calls: ``{label:
    us}``, from the host-side ranges (their kernels and their children's).
    Kernels launched by autograd's backward threads fall in the ranges
    opened there, not in one around ``backward()``."""
    out = {label: 0.0 for label in labels}
    for event in prof.events():
        if event.name in out and event.device_type == torch.autograd.DeviceType.CPU:
            out[event.name] += event.device_time_total
    return out
