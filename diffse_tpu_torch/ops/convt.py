"""2-D transposed convolution with torch's output-size semantics (port of
diffse_tpu/ops/convt.py).

DCUNet's decoder blocks name the output size they need (each block matches
its encoder's input), which fixes the output padding per spatial dim:

    out = (in - 1) * stride - 2 * padding + dilation * (k - 1) + 1 + output_padding

As the JAX package computes it, the transposed conv is a forward conv: the
input zero-stuffed by the stride, padded by ``dilation * (k - 1) - padding``
before and that plus the output padding after (a negative pad crops), and
correlated with the spatially flipped kernel. On the card this runs cuDNN's
forward convolutions, which are deterministic (its transposed-conv
algorithms sum by atomics, so two runs of one program can differ), and it
takes any output padding, where torch's ``conv_transpose2d`` takes one in
``[0, max(stride, dilation))`` only.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F


def output_padding_for(in_size: Sequence[int], out_size: Sequence[int], kernel: Sequence[int],
                       stride: Sequence[int], padding: Sequence[int],
                       dilation: Sequence[int]) -> Tuple[int, ...]:
    """The output padding per spatial dim that gives ``out_size``."""
    return tuple(o - ((i - 1) * s - 2 * p + d * (k - 1) + 1)
                 for i, o, k, s, p, d in zip(in_size, out_size, kernel, stride, padding,
                                             dilation))


def conv_transpose2d(x: torch.Tensor, weight: torch.Tensor, stride=(1, 1), padding=(0, 0),
                     output_padding=(0, 0), dilation=(1, 1)) -> torch.Tensor:
    """Args:
        x: ``[B, Cin, H, W]``.
        weight: ``[Cin, Cout, kh, kw]`` (torch's ConvTranspose2d layout).
        stride, padding, output_padding, dilation: per spatial dim; the
            output padding may be negative or exceed torch's bound.

    Returns ``[B, Cout, H', W']`` with H', W' from the formula above.
    """
    kh, kw = weight.shape[2:]
    (ph, pw), (oph, opw), (dh, dw) = padding, output_padding, dilation
    lo_h, lo_w = dh * (kh - 1) - ph, dw * (kw - 1) - pw
    return stuffed_conv2d(x, weight, stride, (lo_h, lo_h + oph), (lo_w, lo_w + opw), dilation)


def stuffed_conv2d(x: torch.Tensor, weight: torch.Tensor, stride, pad_h, pad_w,
                   dilation=(1, 1)) -> torch.Tensor:
    """The transposed conv's forward conv: ``x`` zero-stuffed by ``stride``,
    padded by ``pad_h`` and ``pad_w`` (before, after; a negative pad crops),
    correlated with ``weight`` (``[Cin, Cout, kh, kw]``) flipped. A frames
    shard computes its part of the output by the same conv on its columns
    of the input and its own pads (``models/shared.py``)."""
    sh, sw = stride
    if sh > 1 or sw > 1:
        b, c, h, w = x.shape
        z = x.new_zeros((b, c, (h - 1) * sh + 1, (w - 1) * sw + 1))
        z[:, :, ::sh, ::sw] = x
        x = z
    x = F.pad(x, (pad_w[0], pad_w[1], pad_h[0], pad_h[1]))
    return F.conv2d(x, torch.flip(weight, (2, 3)).transpose(0, 1), dilation=tuple(dilation))
