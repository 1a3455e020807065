"""Exponential integral Ei(x) (port of diffse_tpu/ops/expi.py).

``torch.special`` has no ``expi``. The BBED SDE's marginal std needs
Ei(2(t-1) log k) on (-2 log k, 0]; the power series

    Ei(x) = gamma + log|x| + sum_{n>=1} x^n / (n * n!)

with 40 terms is exact to float32 for |x| <= 8.
"""

from __future__ import annotations

import torch

_EULER_GAMMA = 0.5772156649015328606

_NUM_TERMS = 40


def expi(x: torch.Tensor) -> torch.Tensor:
    """Ei(x) for a float tensor (accurate for |x| <= 8), in float32 or wider."""
    x = torch.as_tensor(x)
    if not x.is_floating_point() or x.dtype in (torch.float16, torch.bfloat16):
        x = x.float()
    acc = torch.zeros_like(x)
    term = torch.ones_like(x)
    for n in range(1, _NUM_TERMS + 1):
        term = term * x / n
        acc = acc + term / n
    return _EULER_GAMMA + torch.log(torch.abs(x)) + acc
