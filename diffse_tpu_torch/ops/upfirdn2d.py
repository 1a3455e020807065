"""upfirdn2d: upsample (zero-stuff) -> pad -> FIR filter -> downsample.

Port of diffse_tpu/ops/upfirdn2d.py in NCHW. Torch's convolution has no
input dilation, so the input is zero-stuffed explicitly: each sample is
followed by ``up - 1`` zeros in both spatial dims, which is also why the JAX
version's right pad is ``pad1 + up - 1`` on the dilated input (those trailing
zeros are already here). Negative padding crops. The filter is a true
convolution, i.e. a correlation with the flipped kernel, run depthwise, in
x's dtype: a bfloat16 map gives a bfloat16 map, summed in float32 and rounded
once, as ``lax.conv`` on bfloat16 does (the [1,3,3,1] kernel's taps are exact
in bfloat16).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils import round_once


def upfirdn2d(x: torch.Tensor, kernel: torch.Tensor, up: int = 1, down: int = 1,
              pad: tuple[int, int] = (0, 0)) -> torch.Tensor:
    """Args:
        x: ``[N, C, H, W]``.
        kernel: ``[kh, kw]`` FIR kernel.
        pad: ``(pad0, pad1)`` for both spatial dims (negative crops).

    Returns ``[N, C, H', W']`` with ``H' = (H*up + pad0 + pad1 - kh) // down + 1``.
    """
    n, c, h, w = x.shape
    kh, kw = kernel.shape
    pad0, pad1 = pad
    if up > 1:
        z = torch.empty((n, c, h * up, w * up), dtype=x.dtype, device=x.device,
                        memory_format=torch.channels_last).zero_()
        z[:, :, ::up, ::up] = x
        x = z
    x = F.pad(x, (pad0, pad1, pad0, pad1))
    weight = torch.flip(kernel.to(x), (0, 1))[None, None].repeat(c, 1, 1, 1)
    return round_once(lambda a, k: F.conv2d(a, k, stride=down, groups=c), x, weight)
