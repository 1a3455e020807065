"""Fused bias-add + LeakyReLU (port of diffse_tpu/ops/fused_act.py).

``leaky_relu(x + bias, 0.2) * sqrt(2)``, the op surface of the reference's
fused_bias_act CUDA kernel. No path of the model calls it. On a CUDA tensor
it runs the hand-written kernel (``cuda_kernels.fused_bias_leaky_relu``,
``csrc/fused_act.cu``); on a CPU tensor that wrapper's plain PyTorch version.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import cuda_kernels


def fused_bias_leaky_relu(x: torch.Tensor, bias: Optional[torch.Tensor] = None,
                          negative_slope: float = 0.2, scale: float = math.sqrt(2.0),
                          channel_axis: int = -1) -> torch.Tensor:
    """``out = leaky_relu(x + bias) * scale``, bias broadcast on ``channel_axis``.

    The kernel takes the channels last and contiguous: any other
    ``channel_axis`` is moved last (a copy) before the call and back (a view)
    after it. The bias is cast to x's dtype, as the Pallas op does; the maths
    is float32."""
    axis = channel_axis % x.ndim
    last = axis == x.ndim - 1
    x = x.contiguous() if last else x.movedim(axis, -1).contiguous()
    if bias is not None:
        bias = bias.to(x.dtype)
    out = cuda_kernels.fused_bias_leaky_relu(x, bias, negative_slope, scale)
    return out if last else out.movedim(-1, axis)
