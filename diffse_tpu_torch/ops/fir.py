"""StyleGAN2-style FIR up/down-sampling built on upfirdn2d (NCHW).

Port of diffse_tpu/ops/fir.py: ``upsample_2d``, ``downsample_2d``, the naive
variants, and the conv-fused ``upsample_conv_2d`` / ``conv_downsample_2d``
that ``FirConv2d`` runs (the transposed or strided conv through cuDNN, the
FIR through ``upfirdn2d``'s plain path).

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


def _frames_upfirdn(frames, x: torch.Tensor, weight: torch.Tensor, up: int, down: int,
                    pad: tuple) -> torch.Tensor:
    """``upfirdn2d_depthwise`` of the whole map, this rank's output columns,
    from a frames shard's columns (``parallel.sequence.FramesShard``): an
    output column reads the padded, zero-stuffed input from ``o * down -
    pad0`` on over the filter's width, so the shard takes ``pad0 // up``
    columns of the rank before and as many of the rank after as its last
    output reaches (zeros past the global edges, the map's zero padding),
    and pads or crops the stuffed width so that its outputs line up with the
    whole map's."""
    kw, w = weight.shape[-1], x.shape[-1]
    left = pad[0] // up
    right = max(0, (up - down - pad[0] + kw - 1) // up)
    xe = frames.halo(x, 3, left, right)
    pad_left = pad[0] - left * up
    pad_right = (w * up // down - 1) * down + kw - xe.shape[-1] * up - pad_left
    return upfirdn2d_depthwise(xe, weight, up=up, down=down, pad=pad,
                               pad_w=(pad_left, pad_right))


def upsample_2d(x: torch.Tensor, k=None, factor: int = 2, gain: float = 1.0,
                frames=None) -> torch.Tensor:
    """FIR upsample by ``factor``; on a frames shard (``frames``) this rank's
    columns of the whole map's upsample."""
    weight = _fir_weight(k, gain, factor, True, x)
    p = weight.shape[-1] - factor
    pad = ((p + 1) // 2 + factor - 1, p // 2)
    if frames is not None:
        return _frames_upfirdn(frames, x, weight, factor, 1, pad)
    return upfirdn2d_depthwise(x, weight, up=factor, pad=pad)


def downsample_2d(x: torch.Tensor, k=None, factor: int = 2, gain: float = 1.0,
                  frames=None) -> torch.Tensor:
    """FIR downsample by ``factor``; on a frames shard (``frames``) this
    rank's columns of the whole map's downsample."""
    weight = _fir_weight(k, gain, factor, False, x)
    p = weight.shape[-1] - factor
    pad = ((p + 1) // 2, p // 2)
    if frames is not None:
        return _frames_upfirdn(frames, x, weight, 1, factor, pad)
    return upfirdn2d_depthwise(x, weight, down=factor, pad=pad)


def upsample_conv_2d(x: torch.Tensor, w: torch.Tensor, k=None, factor: int = 2,
                     gain: float = 1.0) -> torch.Tensor:
    """Fused ``factor``x upsample + conv (the StyleGAN2 layer): the conv on
    the zero-stuffed input, with a full (kh - 1) padding, then the FIR.

    Args:
        x: ``[N, Cin, H, W]``.
        w: ``[Cout, Cin, kh, kw]`` (OIHW), square.

    The JAX package correlates ``w`` with the input dilated by ``factor``
    (``lhs_dilation``); a transposed conv of stride ``factor`` with the
    kernel flipped and its in/out axes swapped is that correlation.
    """
    kh, kw = w.shape[2], w.shape[3]
    if kh != kw:
        raise ValueError(f"upsample_conv_2d: square kernels only, got {kh}x{kw}")
    h = F.conv_transpose2d(x, torch.flip(w, (2, 3)).transpose(0, 1).to(x.dtype), stride=factor)
    weight = _fir_weight(k, gain, factor, True, h)
    p = (weight.shape[-1] - factor) - (kh - 1)
    return upfirdn2d_depthwise(h, weight, pad=((p + 1) // 2 + factor - 1, p // 2 + 1))


def conv_downsample_2d(x: torch.Tensor, w: torch.Tensor, k=None, factor: int = 2,
                       gain: float = 1.0) -> torch.Tensor:
    """Fused FIR filter + stride-``factor`` conv (VALID).

    Args:
        x: ``[N, Cin, H, W]``.
        w: ``[Cout, Cin, kh, kw]`` (OIHW), square.
    """
    kh, kw = w.shape[2], w.shape[3]
    if kh != kw:
        raise ValueError(f"conv_downsample_2d: square kernels only, got {kh}x{kw}")
    weight = _fir_weight(k, gain, factor, False, x)
    p = (weight.shape[-1] - factor) + (kh - 1)
    x = upfirdn2d_depthwise(x, weight, pad=((p + 1) // 2, p // 2))
    return F.conv2d(x, w.to(x.dtype), stride=factor)
