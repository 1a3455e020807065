"""StyleGAN2-style FIR up/down-sampling built on upfirdn2d (NCHW).

Port of diffse_tpu/ops/fir.py: ``upsample_2d``, ``downsample_2d``, the naive
variants, and the conv-fused ``upsample_conv_2d`` / ``conv_downsample_2d``
that ``FirConv2d`` runs (the transposed conv as a forward conv on the
zero-stuffed input, ``ops.convt``, or the strided conv, through cuDNN; the
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
from .convt import conv_transpose2d
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


def naive_downsample_2d(x: torch.Tensor, factor: int = 2, frames=None) -> torch.Tensor:
    """Box-mean downsample. On a frames shard (``frames``) each output column
    is the mean of ``factor`` of the shard's own columns, which holds where
    the shard's width, and so its first column, is a multiple of
    ``factor``: checked, not assumed."""
    if frames is not None and x.shape[-1] % factor:
        raise ValueError(f"a frames shard of {x.shape[-1]} columns does not downsample by "
                         f"{factor} on its own columns")
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


def _frames_resample(frames, x: torch.Tensor, run, left: int, right: int, up: int,
                     down: int) -> torch.Tensor:
    """``run`` (a resampling of a whole map by ``up / down``, alone or fused
    with a conv) of a frames shard (``parallel.sequence.FramesShard``):
    ``run`` of the shard's columns extended by ``left`` columns of the rank
    before and ``right`` of the rank after (zeros past the global edges, the
    whole map's zero padding), the extension's outputs cropped. Exact when
    each kept output reads no column past the extension (each caller's
    reach) and the extension starts on the stride's phase (``left * up`` a
    multiple of ``down``, the shard's first column a multiple of ``down``)."""
    width = x.shape[-1]
    if (left * up) % down or width % down:
        raise ValueError(f"a frames shard of {width} columns, extended by {left}, is off the "
                         f"stride {down}'s phase")
    out = run(frames.halo(x, 3, left, right))
    start = left * up // down
    return out[..., start: start + width * up // down]


def upsample_2d(x: torch.Tensor, k=None, factor: int = 2, gain: float = 1.0,
                frames=None) -> torch.Tensor:
    """FIR upsample by ``factor``; on a frames shard (``frames``) this rank's
    columns of the whole map's upsample. Its reach: output column o sums the
    zero-stuffed input's columns ``o - pad0 .. o - pad0 + nt - 1`` (``nt``
    taps), whose column m is x's column m / factor where factor divides m;
    so the shard's first output (``factor * lo``) reads x from column ``lo -
    pad0 // factor`` and its last up to ``hi - 1 + (nt - 2 - pad0) // factor
    + 1``: for [1,3,3,1] (pad0 = 2) one column each side."""
    weight = _fir_weight(k, gain, factor, True, x)
    nt = weight.shape[-1]
    p = nt - factor
    pad0 = (p + 1) // 2 + factor - 1

    def run(x):
        return upfirdn2d_depthwise(x, weight, up=factor, pad=(pad0, p // 2))

    if frames is None:
        return run(x)
    return _frames_resample(frames, x, run, pad0 // factor,
                            max(0, (nt - 2 - pad0) // factor + 1), factor, 1)


def downsample_2d(x: torch.Tensor, k=None, factor: int = 2, gain: float = 1.0,
                  frames=None) -> torch.Tensor:
    """FIR downsample by ``factor``; on a frames shard (``frames``) this
    rank's columns of the whole map's downsample. Its reach: output column o
    sums x's columns ``factor * o - pad0 .. factor * o - pad0 + nt - 1``, so
    the shard's first output (``lo / factor``) reads x from ``lo - pad0``
    (the extension rounded up to whole strides) and its last up to ``hi - 1
    + nt - factor - pad0``: for [1,3,3,1] (pad0 = 1) two columns before,
    one after."""
    weight = _fir_weight(k, gain, factor, False, x)
    nt = weight.shape[-1]
    p = nt - factor
    pad0 = (p + 1) // 2

    def run(x):
        return upfirdn2d_depthwise(x, weight, down=factor, pad=(pad0, p // 2))

    if frames is None:
        return run(x)
    return _frames_resample(frames, x, run, -(-pad0 // factor) * factor,
                            max(0, nt - factor - pad0), 1, factor)


def upsample_conv_2d(x: torch.Tensor, w: torch.Tensor, k=None, factor: int = 2,
                     gain: float = 1.0, frames=None) -> torch.Tensor:
    """Fused ``factor``x upsample + conv (the StyleGAN2 layer): the conv on
    the zero-stuffed input, with a full (kh - 1) padding, then the FIR.

    Args:
        x: ``[N, Cin, H, W]``.
        w: ``[Cout, Cin, kh, kw]`` (OIHW), square.

    The JAX package correlates ``w`` with the input dilated by ``factor``
    (``lhs_dilation``); a transposed conv of stride ``factor`` with the
    kernel flipped and its in/out axes swapped is that correlation, run as
    ``ops.convt``'s forward conv on the zero-stuffed input (cuDNN's
    transposed-conv algorithms sum by atomics, so that a captured program's
    replay would not equal its eager run).

    On a frames shard (``frames``) this rank's columns of the whole map's
    output. Its reach: output column o sums the FIR's ``nt`` taps over the
    conv's columns ``o - pad0 .. o - pad0 + nt - 1``, each of which sums
    ``kh`` columns of the dilated input back from it; the dilated input's
    column m is x's column m / factor where factor divides m. So the
    shard's first output (``factor * lo``) reads x from column ``lo - (pad0
    + kh - 1) // factor`` and its last (``factor * hi - 1``) up to ``hi - 1 +
    (nt - 2 - pad0) // factor + 1``: for [1,3,3,1] and a 3x3 kernel (pad0 =
    1) one column each side.
    """
    kh, kw = w.shape[2], w.shape[3]
    if kh != kw:
        raise ValueError(f"upsample_conv_2d: square kernels only, got {kh}x{kw}")
    nt = len(k) if k is not None else factor
    p = (nt - factor) - (kh - 1)
    pad0 = (p + 1) // 2 + factor - 1

    def run(x):
        h = conv_transpose2d(x, torch.flip(w, (2, 3)).transpose(0, 1).to(x.dtype),
                             stride=(factor, factor))
        weight = _fir_weight(k, gain, factor, True, h)
        return upfirdn2d_depthwise(h, weight, pad=(pad0, p // 2 + 1))

    if frames is None:
        return run(x)
    return _frames_resample(frames, x, run, (pad0 + kh - 1) // factor,
                            max(0, (nt - 2 - pad0) // factor + 1), factor, 1)


def conv_downsample_2d(x: torch.Tensor, w: torch.Tensor, k=None, factor: int = 2,
                       gain: float = 1.0, frames=None) -> torch.Tensor:
    """Fused FIR filter + stride-``factor`` conv (VALID).

    Args:
        x: ``[N, Cin, H, W]``.
        w: ``[Cout, Cin, kh, kw]`` (OIHW), square.

    On a frames shard (``frames``) this rank's columns of the whole map's
    output. Its reach: output column o sums ``kh`` filtered columns from
    ``factor * o``, and filtered column c sums x's columns ``c - pad0 ..
    c - pad0 + nt - 1``; so the shard's first output (``lo / factor``) reads
    x from column ``lo - pad0`` and its last (``hi / factor - 1``) up to
    ``hi - 1 + kh + nt - 1 - factor - pad0``, the extension on the left
    rounded up to whole strides: for [1,3,3,1] and a 3x3 kernel (pad0 = 2)
    two columns each side.
    """
    kh, kw = w.shape[2], w.shape[3]
    if kh != kw:
        raise ValueError(f"conv_downsample_2d: square kernels only, got {kh}x{kw}")
    nt = len(k) if k is not None else factor
    p = (nt - factor) + (kh - 1)
    pad0 = (p + 1) // 2

    def run(x):
        weight = _fir_weight(k, gain, factor, False, x)
        x = upfirdn2d_depthwise(x, weight, pad=(pad0, p // 2))
        return F.conv2d(x, w.to(x.dtype), stride=factor)

    if frames is None:
        return run(x)
    return _frames_resample(frames, x, run, -(-pad0 // factor) * factor,
                            max(0, kh + nt - 1 - factor - pad0), 1, factor)
