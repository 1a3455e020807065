"""StyleGAN2-style FIR up/down-sampling built on upfirdn2d (NCHW).

Port of diffse_tpu/ops/fir.py (upsample_2d, downsample_2d and the naive
variants); the conv-fused variants are not on the NCSN++ path and are left
out.

``upsample_2d`` and ``downsample_2d`` build their depthwise filter once per
(kernel, gain, factor, direction, channels, dtype, device) and keep it on the
device, so that a forward neither rebuilds it on the host nor copies it to the
card (a blocking copy) on every call.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..utils import forbid_capture, to_device
from .upfirdn2d import depthwise_weight, upfirdn2d_depthwise


def setup_fir_kernel(k) -> np.ndarray:
    """Normalise a 1-D/2-D FIR kernel to sum 1 (2-D, square)."""
    k = np.asarray(k, dtype=np.float32)
    if k.ndim == 1:
        k = np.outer(k, k)
    k /= np.sum(k)
    if not (k.ndim == 2 and k.shape[0] == k.shape[1]):
        raise ValueError(f"FIR kernel must be square, got shape {k.shape}")
    return k


def naive_upsample_2d(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Nearest-neighbour upsample."""
    return x.repeat_interleave(factor, dim=2).repeat_interleave(factor, dim=3)


def naive_downsample_2d(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Box-mean downsample."""
    return F.avg_pool2d(x, factor)


# (kernel, gain, factor, up, channels, dtype, device) -> depthwise weight
_weights = {}


def _fir_weight(k, gain: float, factor: int, up: bool, x: torch.Tensor) -> torch.Tensor:
    """The depthwise weight of ``k`` for x's channels, dtype and device, made
    on the first call (a non-blocking copy) and reused."""
    if k is None:
        k = [1] * factor
    k = np.asarray(k)
    key = (k.shape, tuple(k.ravel().tolist()), gain, factor, up, x.shape[1], x.dtype, x.device)
    weight = _weights.get(key)
    if weight is None:
        forbid_capture(x.device, "a FIR filter")
        taps = setup_fir_kernel(k) * (gain * (factor ** 2) if up else gain)
        weight = to_device(depthwise_weight(torch.from_numpy(taps).to(x.dtype), x.shape[1]),
                           x.device)
        _weights[key] = weight
    return weight


def upsample_2d(x: torch.Tensor, k=None, factor: int = 2, gain: float = 1.0) -> torch.Tensor:
    """FIR upsample by ``factor``."""
    weight = _fir_weight(k, gain, factor, True, x)
    p = weight.shape[-1] - factor
    return upfirdn2d_depthwise(x, weight, up=factor, pad=((p + 1) // 2 + factor - 1, p // 2))


def downsample_2d(x: torch.Tensor, k=None, factor: int = 2, gain: float = 1.0) -> torch.Tensor:
    """FIR downsample by ``factor``."""
    weight = _fir_weight(k, gain, factor, False, x)
    p = weight.shape[-1] - factor
    return upfirdn2d_depthwise(x, weight, down=factor, pad=((p + 1) // 2, p // 2))
