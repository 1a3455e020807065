"""StyleGAN2-style FIR up/down-sampling built on upfirdn2d (NCHW).

Port of diffse_tpu/ops/fir.py (upsample_2d, downsample_2d and the naive
variants); the conv-fused variants are not on the NCSN++ path and are left
out.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .upfirdn2d import upfirdn2d


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


def upsample_2d(x: torch.Tensor, k=None, factor: int = 2, gain: float = 1.0) -> torch.Tensor:
    """FIR upsample by ``factor``."""
    if k is None:
        k = [1] * factor
    k = setup_fir_kernel(k) * (gain * (factor ** 2))
    p = k.shape[0] - factor
    return upfirdn2d(x, torch.from_numpy(k), up=factor,
                     pad=((p + 1) // 2 + factor - 1, p // 2))


def downsample_2d(x: torch.Tensor, k=None, factor: int = 2, gain: float = 1.0) -> torch.Tensor:
    """FIR downsample by ``factor``."""
    if k is None:
        k = [1] * factor
    k = setup_fir_kernel(k) * gain
    p = k.shape[0] - factor
    return upfirdn2d(x, torch.from_numpy(k), down=factor, pad=((p + 1) // 2, p // 2))
